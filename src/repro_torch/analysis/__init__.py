"""Static and runtime checkers of the port's concurrency invariants
(the port of ``repro.analysis``).

* :mod:`repro_torch.analysis.invariants`: the registry of lock classes
  and ranks, external call summaries, donation and bit-identity rules.
* :mod:`repro_torch.analysis.locklint`: the AST pass over
  ``src/repro_torch`` (and the CUDA sources of the left-fold path).
* :mod:`repro_torch.analysis.lockdep`: the opt-in runtime lock-order
  sanitizer (``REPRO_TORCH_LOCKDEP=1``).
* :mod:`repro_torch.analysis.report`: the JSON findings artifact.

CLI: ``python -m repro_torch.analysis [paths...]``: exit 0 clean,
1 violations, 2 internal error.

Standard library only: nothing here imports torch, so the linter and the
lock seams stay usable from any context.
"""
