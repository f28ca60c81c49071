"""The port's examples (``examples_torch/``) run end to end on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_quickstart_runs_on_the_cpu():
    """``examples_torch/quickstart.py --device cpu`` in a subprocess: the
    reference quickstart's steps on the port (gather, two tenants of one
    executable, one coalesced query batch, scatter back, the deprecated
    ``merge=`` keyword bitwise the spec), each checked by its own asserts."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    run = subprocess.run(
        [sys.executable, str(REPO / "examples_torch" / "quickstart.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=60)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.splitlines()
    assert lines[-1] == "OK"
    assert "1 built, 1 shared" in run.stdout
    assert "2 queries in 1 batched dispatch" in run.stdout
    assert "1 DeprecationWarning" in run.stdout
