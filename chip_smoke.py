#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel wrapper against its plain PyTorch version (bitwise, f64
and f32) on the calls of an ingest of the production configuration
``prod_3d`` (``CombinationScheme(3, 9)``: 109 grids in 25 buckets, a 511^3
fine grid, 1.07 GB in f64), which are three: the assembly of the member
grids into the flat bucket stacks (one launch; replayed also on strided
member grids), the grouped forward passes (rows 5 and 7, one launch) and
the grouped ordered scatter (row 9, two launches); then on the long-axis
stacks of ``CombinationScheme(2, 15)`` (each per-bucket wrapper, and the
assembly and the grouped kernels over the whole plan, whose largest
members walk device memory); then drives the port's main path —
``CTEngine`` on the card with two ``prod_3d`` tenants of one plan
signature (``bump`` and a second seeded function), ``CTSurrogate`` a view
on the first, one ``update``, one query coalesced over both tenants and
three query batches of 1024 points — at full size, fails if an ingest
makes more than four launches, and checks the result:

* the two tenants share one ingest executable (1 miss, 1 hit);
* the coalesced query is one eval batch and each answer is bitwise that
  tenant's one-tenant query;
* fused and unfused ingest give the same bits, and each card surplus is
  bitwise the port's CPU run;
* 16 query points match the CPU eval (rtol 1e-12) and the direct
  combination of the grids' multilinear interpolants (rtol 1e-9);
* ``refit`` through the engine onto a refined scheme on the same fine
  grid serves it on a new executable, its surplus bitwise the CPU run;
* the surplus checks again for ``fig7_4d`` = ``CombinationScheme(4, 6)``
  (coefficients of +-3, which would expose a fused multiply-add in the
  scatter) and ``fig6_2d`` = ``CombinationScheme(2, 11)`` (buckets in
  both of the reference's axis orders; every ``prod_3d`` and ``fig7_4d``
  bucket takes one order).

Then the durable store and donation, at ``prod_3d`` in f64 on
``CTEngine(device=cuda, ingest_workers=0)``, in a temporary directory
removed at the end, with the launch counts set to 0 just before the
restore and read just after it:

* durable serving: a ``DurableStore`` with ``snapshot_interval=2``;
  ``bump`` registered, then updated with ``seeded(11)`` (the snapshot at
  seq 2, 1.07 GB) and ``seeded(12)`` (one WAL entry past it); the engine
  is then left without ``close()`` (the crash) and a fresh engine on a
  fresh store restores: its surplus bitwise the never-crashed one's,
  ``RestoreInfo`` snapshot seq 2, pending 1, replayed 1, the replayed
  ingest at most four launches, each of the assembly and rows 5, 7, 9
  launched; a third engine restores with ``replay=False``, its
  ``stale_ok`` query bitwise the seq-2 surplus's, and ``replay()`` brings
  it bitwise to the never-crashed surplus;
* donation on the restored engine: a second tenant of the same plan with
  ``ExecSpec(donate=True)``, updated with grids on the card that the
  script owns: its surplus bitwise the non-donating tenant's fed the same
  values, every grid released, ``torch.cuda.memory_allocated()`` down by
  what the grids were charged (73,915 x 8 B in the allocator's 512 B
  blocks); a NaN ingest under ``check_finite=True`` raises
  ``IngestBuffersDonated`` and leaves the served surplus unchanged;
  handing the released grids in again raises ``IngestBuffersDonated``
  before any launch, and the next ingest runs;
* it prints the WAL append (median), the snapshot and its steps each
  timed alone on the same surplus (device-to-host, npz write, crc32), the
  restore split into load-and-verify and the rest (plan and adoption onto
  the card), the replay per entry, the bytes on disk, and warm-median
  ``update`` with and without donation (a record only).

Then the CT cluster (``repro_torch.runtime.cluster.CTCluster``) at
``prod_3d`` in f64: four durable hosts, each a ``CTEngine`` on the card
with its own ``DurableStore`` in a temporary directory
(``snapshot_interval=2``), ``replication=1``, seed 7, with the launch
counts set to 0 just before the phase and read just after it:

* three tenants of one signature (``bump``, ``seeded(7)``,
  ``seeded(11)``) registered through the cluster's front door, one
  cluster-routed ingest counted alone (at most four launches, of the
  assembly and rows 5, 7, 9), one more update each (a 1.07 GB snapshot
  each at engine seq 2);
* ``start()``: the hosts' schedulers and the health monitor run; an
  open-loop load of one query of 64 points every 10 ms, round robin over
  the tenants, with one update per tenant at a fifth of the load (a WAL
  entry past each snapshot); half-way, ``FaultInjector.kill`` of
  ``bump``'s primary, which the monitor detects and fails over (the
  victim's tenants re-registered from the retained host copies); at
  three quarters, ``restart_host`` of the victim on a thread of its own
  while the load goes on (restore from its store, rejoin, the WAL replay
  with stale-marked queries meanwhile);
* gates: every future resolves with a value (none hung, none failed),
  placement back to the pre-kill map, one failover and one restart,
  ``stats()`` JSON-serialisable, every kernel of the ingest launched in
  the phase, and each tenant's surplus bitwise (and its queries equal to)
  a never-failed ``CTEngine`` on the card fed its newest acked payload;
* it prints recovery_ms (kill to failover complete), the restart's
  restore, replace and replay ms, and p50 and p99 query latency before
  the kill, during the outage and after the restart, each beside the
  card's name and power limit.

Then the sharded ingest (``repro_torch.core.distributed``) at ``prod_3d``
in f64, on ``make_mesh((4,), ("slab",))`` and ``make_mesh((2, 2),
("member", "slab"))`` over the one card repeated, so every slab and
compute group shares the card and every collective is a copy within it
(no interconnect is measured), with the launch counts set to 0 just
before each ingest and read just after it:

* ``ct_transform_sharded`` 1-D fused (the assembly, rows 5+7 one
  launch, row 9 two launches a slab on its slab-local table), 1-D
  unfused and 2-D (rows 5 and 7 per group and bucket, then one row 12
  ``owner_fold`` a slab), each bitwise the single-device card surplus and
  launching what its plan says; with ``gather=False`` every slab bitwise
  its slice; every kernel call of each ingest replayed against its plain
  version, bitwise, in f64 and f32; warm ingest times beside the
  single-device one, each ingest profiled (device busy, idle share, top
  ops), each slab buffer's bytes and the peak device memory;
* a ``CTEngine`` tenant with ``ExecSpec(mesh=mesh4)`` bitwise the
  unmeshed one (surplus and a query), ``rebind`` onto the 2-D mesh
  (``"resharded"``, the surplus carried, an update through one
  ``owner_fold`` a slab) and off it (``"unsharded"``);
* at ``fig6_2d``: ``ct_transform_psum`` and ``comm_phase_sharded`` (psum
  and slab routes) within rtol 1e-12 of one device (at ``prod_3d`` the
  psum's (G, fine) stack would be 117 GB);
* at ``fig7_4d``: ``CTCluster.over_device_slices(2, devices=[cuda] *
  4)``, 1-D and ``members=2``, a tenant bitwise a fresh engine's.

Then the second path, the per-grid (de)hierarchization of
``kernels.ops`` and the iterated combination round that drives it:

* the four per-grid kernels against their plain versions in f64 and f32
  (bf16 too for the two operator kernels, against the f64 brute force):
  pole bundles of level 1 (the identity, no launch), 1 and 33 columns,
  fused tails of 2 to 10 dimensions; the pole kernels bitwise, the
  operator kernels to the reference's tolerances (f64 rtol 1e-11 / atol
  1e-12, f32 2e-5, bf16 an error below 0.15 against the brute force and
  within one bf16 ulp plus 2**-12 of the plain version, which also sums
  in f32); on input with NaNs and Infs of both signs (and a NaN line,
  forward and inverse, and a fully non-finite input) the operator
  kernels give the plain version's NaN / +Inf / -Inf masks;
* hierarchize-then-dehierarchize round trips at real size: a 511^3 f64
  grid (1.07 GB) with ``pole``, ``matmul`` and ``auto`` (= ``fused``), and
  a 16383 x 8191 f64 grid (levels (14, 13), 1.07 GB) with ``pole`` (each
  axis passed to rows 1 and 2 in place); every recorded kernel call held
  against its plain version on the same input, and each round trip back
  to its input within 1e-12 of its largest value;
* rows 1 and 2 at every shape the port gives them, each axis in place:
  the cube's bundle and its axes 1 and 2, the plane's axes 0 and 1, a
  gradient codec bundle (255, 9638) in f32 and a single pole of 16383
  points; bitwise their plain versions in f64 and f32 (row 1 with
  ``reduced_op`` both ways), one launch a call, and timed by CUDA events
  behind the sleep kernel (``events_ms``) beside the bound, the plain
  version and one ``torch.matmul`` with the dense operator along the axis
  (the ``events_by_shape`` keys of rows 1 and 2);
* ``run_iterated_heat(3, 9, rounds=2, t_steps=4)`` (the ``prod_3d``
  scheme) with ``auto`` and with ``pole``, the card against the port on
  the CPU (rtol 1e-12), with its error against the exact solution.

Then the third path, the CT scatter phase and adaptivity (rows 6 and 8,
the batched inverse kernel ``axis_pass_inv``), with the launch counts set
to 0 just before it and read just after:

* ``prod_3d`` round trip: the surrogate's surplus scattered back onto its
  109 grids (``ct_scatter_with_plan``) with the default plan and a merged
  plan (``MergeConfig()``, members below their bucket target), each
  bitwise equal to the port's CPU run of the same surplus, without a copy
  of the fine grid;
* the scatter oracle at ``fig6_2d`` and ``fig7_4d``: the scattered grids
  against ``gather_subspaces`` -> ``scatter_subspaces`` ->
  ``dehierarchize(..., "ref")`` at rtol 1e-11 / atol 1e-12, and
  ``ct_embedded`` at ``fig6_2d`` bitwise equal to the CPU run;
* adaptivity: ``AdaptiveDriver`` on ``aniso_6d`` until its error at the
  config's probe points is at most the regular scheme's, with at least 3x
  fewer points and the axes ranked by importance; then ``ct_scatter`` of
  the final general scheme, bitwise the CPU run and within rtol 1e-11 of
  the interpolant at every grid's nodes;
* fault recovery: ``CTSurrogate.drop_grid`` at ``prod_3d`` on the
  coefficient-only path and on the ``extend_plan`` fallback that
  activates a coefficient-0 grid (a missing grid raises and leaves the
  surrogate untouched), queries within rtol 1e-12 of a surrogate built
  from scratch on the reduced scheme;
* every recorded inverse kernel call held against its plain version,
  bitwise, in f64 and f32, plus one call of each row on the 511^3 cube.

Then the fourth path, the dense LM's serving steps at ``smollm_360m``'s
full width in bf16 (32 layers, d_model 960, 15 query heads over 5 KV
heads, random weights from a seed), whose attention is row 10, the
flash-attention kernel, with its launch count set to 0 just before the
prefill:

* the kernel against its plain version on the cases of the reference's
  ``tests/test_flash_attention.py`` plus head_dim 128, in f32 (CUDA
  cores) and bf16 (tensor cores), at the reference's bars (2e-5, 2e-2);
* ``prefill_step`` on 4 prompts of 2048 tokens: one launch per layer
  (32), finite logits, warm time (median of 5) and peak device memory;
  each of its 32 kernel calls replayed against the plain version in bf16
  and in f32, the max error of each printed;
* cache parity: ``prefill_step`` logits against token-by-token
  ``serve_step`` (``decode_attention``, no kernel) on 2 prompts of 64
  tokens, within three times the bf16 prefill's own distance from an f32
  prefill of the same weights;
* ``generate``: 4 requests of 128 prompt tokens plus 32 greedy new
  tokens, twice, the two runs equal; ms per step and tokens/s;
* row 10 timed on one layer's call at the prefill's shape, beside its
  plain version and ``scaled_dot_product_attention`` (K/V broadcast to
  the 15 query heads; a yardstick the port never calls), its bound the
  causal pairs' flops at the bf16 tensor-core peak against q, k, v and o
  moved once.

Then the fifth path, dense LM training at ``smollm_360m``'s full width in
bf16 (``repro_torch.launch.train.train``; random weights from a seed),
whose attention is row 10's forward with its log-sum-exp
(``flash_attention_lse``) and row 10's backward (``flash_attention_bwd``,
two hand-written launches):

* the backward against its plain version at the training shape (4 x 2048
  tokens, 15 query over 5 KV heads, head_dim 64, causal) in f32 and
  bf16 (as training calls it: in bf16 with the forward's output
  residual, D = rowsum(do * (o + o_lo))), on two ragged cases (keys not a
  multiple of the tile, ``q_offset`` > 0, full and causal) and on one whose rows TMA cannot
  describe as they are (head_dim 20: the wrapper pads the channels to
  24): each of dq, dk and dv within
  rtol 1e-4 / atol 1e-5 of it element by element and within 1e-4
  relative L2 as a whole (f32), and in bf16 within rtol 2e-2 plus an
  atol of 0.1 times the plain result's RMS, and 1e-2 relative L2 (each
  RMS printed beside its bar); the bf16 check must refuse the kernel's
  own result at the training shape with one 64 x 64 tile pair (the last
  query tile against the key tile before it) dropped or doubled in
  every (batch, head); two bf16 calls on the training shape's inputs
  bitwise equal; the log-sum-exp within 1e-4 of the plain logsumexp;
  the forward's output with it bitwise the output without it;
* a gradient check at full width, depth 2, 4 x 512 tokens: one train
  step's gradients and updated parameters with the kernels against the
  same step with row 10 routed through its plain version (autograd),
  per-leaf relative L2 within 1e-3 (f32) and 3e-2 (bf16);
* ``train`` for 6 steps of 4 x 2048 tokens (warmup 2, remat ``full``,
  a checkpoint every 2 steps into a temporary directory, a NaN injected
  at step 3), with the launch counts set to 0 just before it: every loss
  finite, the first within 1 of ln(49152), the trained model's loss on
  the last step's batch below the first loss and below that batch's loss
  before its step, and its loss on the first step's batch below the
  first loss (the stream's near-uniform labels at this vocabulary leave
  each new batch's loss near ln(49152) over 6 steps), one
  rollback to step 2 whose restored parameters are bitwise those saved
  (sha256 per leaf), and per executed step 64 forward launches with the
  log-sum-exp (the forward and the recompute) and 32 backward pairs, no
  launch without it; step time, tokens/s, peak memory, checkpoint write
  and restore times;
* ``compress_with_feedback(codec="hier")`` on one full-width step's
  gradients: one row 1 and one row 2 launch per leaf, the decode at
  truncation 0 equal to the input within the reference's invertibility
  bar (rtol 1e-4, atol 1e-5);
* rows ``10 lse`` and ``10 bwd`` timed on one layer's call at the
  training shape beside their plain versions and
  ``scaled_dot_product_attention``'s forward (recording its backward's
  state) and backward (yardsticks the port never calls); beside the
  profiler's device time, ``events_ms``: CUDA events around back-to-back
  calls queued behind a sleep kernel that holds the stream until the
  host has queued them all, so that the host's dispatch does not show.
  A profiler session for these rows that records fewer device ops than
  the calls launched lost some and is run again, as an empty one is.

Then the sixth path, the encoder-decoder and vision-language families in
bf16 (random weights from a seed), each driven with row 10's count set to
0 just before and read just after:

* ``whisper_small`` at full width and depth (12 encoder and 12 decoder
  layers, d 768, 12 heads of 64): ``prefill_step`` of 4 x 448 text
  tokens over 4 x 1500 stub frames makes 36 row-10 launches (12 encoder
  full over 1500 keys, 12 decoder causal, 12 cross-attention full, 448
  queries over 1500 keys, which are not a multiple of the key tiles);
  finite logits; the warm median of 5 and peak memory; every call
  replayed against the plain version in bf16 (2e-2 element by element
  and 1e-2 relative L2 as a whole) and f32 (2e-5), the max error and the
  relative L2 printed by kind, and the relative-L2 bar must refuse the
  cross call's plain output with the keys' 36 zero pads let through the
  mask; cache parity of 2 x 64 tokens, token-by-
  token ``serve_step`` over ``encode_for_decode``'s cross cache against
  the prefill (bar 3x the bf16 prefill's distance from f32); ``generate``
  of 4 x (16 + 64) tokens twice, equal; row 10 at the encoder's shape
  (4 x 12, 1500, 64) and the cross shape (448 x 1500) by CUDA events
  beside ``scaled_dot_product_attention`` and the flop bound; a train
  step at depth 2 + 2, 4 x 448 tokens over 1500 frames, with the kernels
  (row 10's forward with its log-sum-exp and its backward over the cross
  shape) against row 10 through its plain version, per-leaf relative L2
  within ``GRAD_TOL``, with the launches counted;
* ``llava_next_34b`` at full width cut to 4 of its 60 layers (the cut is
  printed: 60 layers are about 68 GB of bf16 weights on the 80 GB card):
  ``prefill_step`` of 2 x (576 patches + 1024 text tokens), 4 launches
  (causal, head_dim 128, 7 query heads a KV head), logits of the text
  positions (2, 1024, 65536) finite, each call within 2e-2 of the plain
  version element by element and 1e-2 in relative L2.

Then the seventh path, the moe, ssm and hybrid families in bf16 (random
weights from a seed; each model freed before the next):

* ``olmoe_1b_7b`` at full width and depth (16 layers, d 2048, 16 heads of
  128, 64 experts top-8 of d_ff 1024, 13.8 GB), ``qwen3_moe_235b_a22b`` at
  full width cut to 2 of its 94 layers (about 470 GB of bf16 weights in
  all; the cut is printed), ``xlstm_1_3b`` (48 blocks, an sLSTM every 8th,
  4 heads of 512) and ``zamba2_1_2b`` (38 Mamba2 layers, the shared
  attention+MLP block every 6) at full width and depth: ``prefill_step``
  (4 x 2048; qwen3 2 x 1024) with its row-10 launches counted (one a moe
  layer, one a shared-attention site, none in the ssm family) and every
  call held to the plain version (2e-2, and 1e-2 relative L2), the moe's
  group-size host reads counted (one a layer), finite logits, warm
  prefills with peak memory, a profiled prefill and decode step (device
  ops), a parity check at 2 x 64 (the moe against its prefill through row
  10's plain version; the ssm and hybrid token-by-token ``serve_step``
  against the prefill; bar 3x the bf16 prefill's distance from f32) and
  ``generate`` of 4 x (128 + 32) tokens (xlstm, zamba2: 4 x (32 + 32))
  twice, equal;
* ``moe_ffn_ep`` at olmoe's width, one layer, 4 x 512 tokens in f32, on a
  (1, 4) (data, model) mesh of the card repeated: within 2e-4 of ragged at
  ``capacity_factor`` 8.0;
* one train step of each family at a cut depth that holds each of its
  segment kinds (olmoe 2 layers, xlstm 8 blocks, zamba2 7 layers), 2 x
  512 tokens: in f32 and bf16 the gradients with row 10's kernels against
  those through its plain version (per-leaf relative L2 within
  ``GRAD_TOL``; the moe's passes on the first pass's recorded expert
  choices), and the bf16 gradients against the f32 gradients of the same
  weights printed as a record, within ``GRAD_TOL["bfloat16"]`` or past
  it; the step finite and moving the weights.

Then row 10 and row 10 lse in one phase at the six shapes the LM paths
give them (``FLASH_SHAPES``: the ``smollm_360m`` prefill, 4 x 15 query
over 5 KV heads, 2048, head_dim 64, causal; ``whisper_small``'s encoder,
4 x 12, 1500, full; its cross-attention, 448 queries over 1500 keys;
``llava_next_34b``'s prefill, 2 x 56 query over 8 KV heads, 1600,
head_dim 128, causal; ``olmoe_1b_7b``'s, 4 x 16 over 16, 2048, 128,
causal; ``qwen3_moe_235b_a22b``'s, 2 x 64 over 4, 1024, 128, causal), on
bf16 inputs drawn from a seed: each output
within 2e-2 and 1e-2 relative L2 of the plain version, a second call and
the call with the log-sum-exp the same bits, and each timed by CUDA
events behind the sleep kernel (``events_ms``) beside
``scaled_dot_product_attention``'s forward, plain and recording its
backward, and the flop bound (the ``events_by_shape`` keys of the two
rows).

Last, the analysis phase (``repro_torch.analysis``), at ``prod_3d`` in
f64:

* the port's linter over ``src/repro_torch`` in-process (its Python
  files and the CUDA sources of the left-fold path and of row 10's
  forward and backward): 0 findings; it
  prints the files scanned and the ``ctlint: ok`` pragmas by rule;
* the engine load uninstrumented here (launch counts set to 0 just
  before it and read just after): a started ``CTEngine`` with a
  ``DurableStore`` in a temporary directory, tenants ``bump`` and
  ``seeded(7)`` of one signature, 4 submitter threads alternating an
  ingest and a 64-point query for 5 s, then ``ENGINE_UPDATES`` timed
  ``update`` calls and one-tenant queries and a last ingest per tenant,
  whose surplus's sha256 it keeps;
* the same load again in a child process (``--lockdep-child``) started
  with ``REPRO_TORCH_LOCKDEP=1``, so every lock, the module-level ones
  too, is instrumented from import, followed by a 3-host durable
  ``CTCluster`` under 4 s of open-loop queries with ``fail_host`` of a
  primary half-way and ``restart_host`` after it; the child fails unless
  the sanitizer recorded no violation and no cycle, every edge goes up in
  rank, every future resolved, each ingest kernel launched, the
  placement came back and every final surplus's sha256 (engine and
  cluster) is the uninstrumented engine's; this script fails with it;
* it prints the recorded lock edges with their counts, the
  ``note_dispatch`` calls, and the sanitized against the uninstrumented
  ``update`` and one-tenant query medians, beside the card's name and
  power limit.

The configurations come from ``repro_torch.configs``.  The
kernel checks and timings replay the wrapper calls that the executor
itself makes in an ingest or a scatter (``record_calls``).  Each
kernel's ``ms`` is its device time from the profiler; ``plain_ms`` and
``library_ms`` (one ``torch.einsum`` with the dense per-member operators,
for the pass kernels) are device times too; a pass row's ``bound_ms``
counts each call's input read once and output written once.  Rows 5 and
7 share the ingest's one grouped forward launch: each is timed as that
launch restricted to its own passes (tail axes, axis 0), the whole
launch's time is their ``ingest_ms``, and their launches are the grouped
launch's; row 9 is the grouped scatter's two launches per ingest, its
bound each stack element and its index read once and each listed entry's
fine slot read and written once; row 12 (the 2-D owner fold) is its two
launches per 2 x 2 ingest, its bound each value a run lists and its
entry read once (not the payloads' pad) and each owner's slot, offsets
and accumulator read once and the slot written once, its ``library_ms``
one ``index_add_`` a slab over the concatenated ``ship_idx[s]`` (the
same sums in no fixed order, which the port never calls);
``wrapper_ms`` and ``plain_wrapper_ms`` are CUDA events around the Python
calls, host dispatch included.  Rows 9, 11 and 12 are timed by CUDA events
behind the sleep kernel (their ``ms`` and ``plain_ms``; the profiler's
time, which can lose launches, as ``profiler_ms``), and so is an empty
kernel of this repository (``csrc/launch_floor.cu``): its time is printed
as the launch floor beside rows 5, 7, 9, 11 and 12 and kept in their
``launch_floor_ms``.  The inverse rows are timed per
``ct_scatter`` at ``prod_3d`` and per call on the 511^3 cube (``cube_*``
keys; ``cube_events_ms`` by CUDA events behind the sleep kernel).  The
per-grid kernels are timed per call on the 511^3 f64 grid (axis 0 for the
bundle kernels, both tail axes for the fused tail; rows 1 and 2 by CUDA
events behind the sleep kernel, the others by the profiler), their
``library_ms`` being one ``torch.matmul`` with the dense operator (one
``torch.einsum`` over both tail operators for the fused tail); their
``launches`` are those of the iterated round (``pole`` for the pole
kernels, ``auto`` for the operator kernels).  Their ``bound_ms`` is the
function's own, whatever the kernel's formulation: the grid read once and
written once (the 3-term update's flops are far below it); the operator
kernels' line also carries ``dense_flop_ms``, the dense operators' flops
at the card's peak; rows 3 and 4's printed lines also give the flops of
the operator tiles their kernels multiply (only the nonzero ones).  The
fused tail launches one pass per tail axis, and its launch counts are
passes.  Each tile launch of rows 3 and 4 is followed by its non-finite
repair launch, which returns at once on finite input: their ``ms`` holds
both, their launch counts the tile launches, and ``nonfinite_ms`` is a
call's device time on a fully non-finite input (row 3 on a 511 x 4096
bundle, row 4 on a 4095 x 511 grid).  The script fails unless ``cuobjdump -sass`` finds DMMA in the f64
kernels of rows 3 and 4 (row 4's both operand roles), HGMMA (the
warpgroup products) and no HMMA in the six kernels of row 10's bf16
forward (head_dim 64 with two or three consumer warpgroups and 128 with
two, each with and without the log-sum-exp)
and in the four of its bf16 backward (dq and dk/dv, head_dim 64 and
128), and neither in row 10's four f32 forward kernels.  It prints the
bf16 forward and backward kernels' registers, spill bytes and dynamic
shared memory, and fails if ptxas reports a spill in them or a
serialized wgmma (C7515, C7512) in the forward.

A profiler session can come back with no device activity.  The script
runs a timing session that records none again, up to ``PROFILE_TRIES``
times in all, and if every try comes back empty takes that one time with
CUDA events around the calls instead (device time plus launch gaps,
printed as such).  It prints how many sessions came back empty.

The ingest is timed warm through ``engine.update`` and
``CTSurrogate.update`` (median of ``ENGINE_UPDATES``) and profiled, the
fine grid's fill reported beside the device busy time that holds it; the
script fails if an ``engine.update`` makes more than ``INGEST_DEVICE_OPS``
= 5 device ops (the fill, the assembly, the grouped forward, the scatter's
two: the wrappers' launch counts plus the fills its profile shows) or its
profile shows more kinds of op than that, or any host-to-device copy.  The assembly's row times its recorded
call against the present copy loop (its plain version); its profile may
hold nothing but ``assemble_members`` (no copy of a work table).  It
prints the card's name and power limit, the kernels'
``-Xptxas -v`` report, the timings, a ``{"kernels": [...]}`` JSON line
(fourteen rows: the ten of ``PERF.md``'s table in its order, row 10's
forward with its log-sum-exp and its backward, then the assembly and the
owner fold; row 9 also carries its slab-local time as
``slab_ms``, ``slab_plain_ms``, ``slab_wrapper_ms``, ``slab_launches``
and ``slab_bound_ms``) and, last,
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
then non-zero and no result line is printed.  Without a CUDA device, or
without the rest of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from gc import collect as gc_collect
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)
FLOP_PER_S = 67e12               # H100 SXM f64 (tensor core) and f32 peak
LONG = (2, 15)                   # long-axis stacks: (G, 32767, 1), (G, 255, 255)
QUERY_BATCH, QUERY_BATCHES, CHECK_POINTS = 1024, 3, 16
TIMING_REPS = 20
#: Device ops of one warm prod_3d ``engine.update``: the fine grid's fill,
#: the assembly, the grouped forward and the grouped scatter's two launches.
INGEST_DEVICE_OPS = 5
PROFILE_TRIES = 3                # profiler sessions before CUDA events
CUBE = (9, 9, 9)                 # 511^3 f64: the paper's 1 GB data set
PLANE = (14, 13)                 # 16383 x 8191 f64, 1.07 GB
POLE_CODEC = (255, 9638)         # f32: a 960 x 2560 gradient leaf, level 8
POLE_LONG = 14                   # a single pole of 2**14 - 1 points
LIBRARY_MAX_BYTES = 4 << 30      # torch.matmul's dense operator, at most
ITERATED = dict(rounds=2, t_steps=4)
BF16_FLOP_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
LM_ARCH = "smollm_360m"          # the dense LM, full width, bf16
PREFILL = (4, 2048)              # prompts x tokens of the timed prefill
PARITY = (2, 64)                 # prefill against token-by-token decode
SERVE = dict(requests=4, prompt=128, new_tokens=32)
PREFILL_REPS = 5
FLASH_CASES = [  # b, sq, skv, h, kv, hd, causal
    # tests/test_flash_attention.py's cases, then head_dim 128
    (2, 16, 16, 4, 2, 8, True), (1, 64, 64, 2, 2, 16, True),
    (2, 8, 24, 4, 4, 8, False), (1, 33, 33, 2, 1, 8, True),
    (1, 1, 40, 4, 2, 8, False), (1, 128, 128, 8, 8, 32, True),
    (1, 300, 300, 4, 2, 128, True), (2, 96, 130, 2, 2, 128, False)]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the reference's bars
FLASH_REL_L2 = 1e-2   # a bf16 call's output as a whole, as BWD_TOL's
TRAIN = dict(global_batch=4, seq_len=2048, steps=6, warmup_steps=2,
             checkpoint_every=2, loss_poison_step=3)   # remat: the config's
BWD_CASES = [  # b, sq, skv, h, kv, hd, causal, q_offset
    (4, 2048, 2048, 15, 5, 64, True, 0),      # the training shape
    (1, 300, 333, 4, 2, 128, False, 17), (2, 200, 333, 6, 2, 64, True, 133),
    (1, 129, 257, 3, 3, 20, True, 128)]       # rows of 120 B: padded
BWD_TOL = {  # dq, dk, dv: every element within rtol |plain| + atol +
    # atol_rms RMS(plain), and the relative L2 of the whole within rel_l2
    "float32": dict(rtol=1e-4, atol=1e-5, atol_rms=0.0, rel_l2=1e-4),
    "bfloat16": dict(rtol=2e-2, atol=0.0, atol_rms=0.1, rel_l2=1e-2)}
GRAD_CHECK = dict(num_layers=2, seq_len=512, global_batch=4)
GRAD_TOL = {"float32": 1e-3, "bfloat16": 3e-2}   # per-leaf relative L2
ENCDEC_ARCH = "whisper_small"    # encdec, full width and depth, bf16
ENCDEC_PREFILL = (4, 448)        # prompts x text tokens, over 1500 frames
ENCDEC_PARITY = (2, 64)          # prefill against token-by-token decode
ENCDEC_SERVE = dict(requests=4, prompt=16, new_tokens=64)
ENCDEC_GRAD = dict(encoder_layers=2, num_layers=2, global_batch=4,
                   seq_len=448)  # the gradient check's depth and tokens
VLM_ARCH = "llava_next_34b"      # vlm, full width, bf16, cut in depth:
VLM_LAYERS = 4                   # 60 layers are ~68 GB of bf16 weights
VLM_PREFILL = (2, 1024)          # prompts x text tokens, after 576 patches
FLASH_SHAPES = {  # row 10's timed shapes: b, sq, skv, h, kv, hd, causal
    "smollm_360m prefill": (4, 2048, 2048, 15, 5, 64, True),
    "whisper_small encoder": (4, 1500, 1500, 12, 12, 64, False),
    "whisper_small cross": (4, 448, 1500, 12, 12, 64, False),
    "llava_next_34b prefill": (2, 1600, 1600, 56, 8, 128, True),
    "olmoe_1b_7b prefill": (4, 2048, 2048, 16, 16, 128, True),
    "qwen3_moe_235b_a22b prefill": (2, 1024, 1024, 64, 4, 128, True)}
MOE_ARCH = "olmoe_1b_7b"         # moe, full width and depth, bf16
MOE_PREFILL = (4, 2048)          # prompts x tokens
MOE_CUT_ARCH = "qwen3_moe_235b_a22b"   # moe, full width, cut in depth:
MOE_CUT_LAYERS = 2               # 94 layers are ~470 GB of bf16 weights
MOE_CUT_PREFILL = (2, 1024)
EP_SHAPE = (4, 512)              # the expert-parallel check's rows x tokens
EP_TOL = 2e-4                    # f32, abs and rel (the reference's bar)
SSM_ARCH = "xlstm_1_3b"          # ssm, full width and depth, bf16
SSM_PREFILL = (4, 2048)          # the sLSTM scans the 2048 steps in turn
SSM_PROFILE_PREFILL = (4, 256)   # its profiled prefill: about 125 device
# ops a token (the sLSTM's steps), whose trace the profiler takes minutes
# to read back at 2048
HYBRID_ARCH = "zamba2_1_2b"      # hybrid, full width and depth, bf16
HYBRID_PREFILL = (4, 2048)
RECURRENT_SERVE = dict(requests=4, prompt=32, new_tokens=32)   # xlstm's
# and zamba2's generate: each token a serve_step of 40-50 ms on the host
FAMILY_TRAIN = {MOE_ARCH: 2, SSM_ARCH: 8, HYBRID_ARCH: 7}   # cut depths:
# every segment kind (an sLSTM at 8, a shared-attention site at 7)
FAMILY_TRAIN_SHAPE = (2, 512)    # the train step's rows x tokens

KERNELS = {  # the main path's wrappers -> (CUDA source, TPU kernels)
    "assemble_grouped": (
        "src/repro_torch/kernels/csrc/assemble_members.cu",
        # no TPU kernel: the reference's XLA-fused member assembly
        "src/repro/core/executor.py:907"),
    "hier_forward_grouped": (
        "src/repro_torch/kernels/csrc/axis_pass_fwd.cu",
        {"tail": "src/repro/kernels/hierarchize.py:509",      # row 5
         "axis0": "src/repro/kernels/hierarchize.py:602"}),   # row 7
    "hier_scatter_grouped": (
        "src/repro_torch/kernels/csrc/axis_pass_scatter_fwd.cu",
        "src/repro/kernels/hierarchize.py:657"),              # row 9
}
MAX_INGEST_LAUNCHES = 4          # the assembly and rows 5, 7, 9, per ingest
ENGINE_UPDATES = 7               # warm engine.update calls timed (median)
CLUSTER = dict(                  # the cluster phase's open-loop load
    load_s=12.0,                 # updates at 1/5, the kill at 1/2, restart 3/4
    after_s=3.0,                 # load kept on this long after the restart
    query_period_s=0.01, points=64,
    monitor_s=0.05,
    # lenient probe bars: a 1.07 GB snapshot, restore or replay holds the
    # host for seconds; the kill itself is detected on the first pass
    health=dict(heartbeat_timeout_s=5.0, probe_deadline_s=2.0,
                max_strikes=3))
LOCKDEP = dict(                  # the analysis phase's sanitized run
    engine_s=5.0,                # threaded load on the durable engine
    submitters=4, points=64,
    cluster_s=4.0,               # open-loop queries; fail_host at 1/2,
    hosts=3,                     # restart_host at 3/4
    query_period_s=0.01,
    window=32,                   # cluster queries in flight at most
    reps=ENGINE_UPDATES,         # timed update and one-tenant query calls
    final_k=999,                 # the payload each tenant ends on
    child_timeout_s=300)
SCATTER_KERNELS = {  # the scatter path: wrapper -> (source, TPU kernel)
    "dehier_tail_batched": (
        "src/repro_torch/kernels/csrc/axis_pass_inv.cu",
        "src/repro/kernels/hierarchize.py:494"),
    "dehier_axis0_batched": (
        "src/repro_torch/kernels/csrc/axis_pass_inv.cu",
        "src/repro/kernels/hierarchize.py:597"),
}
ROW = {"hier_pole": 1, "dehier_pole": 2, "apply_axis_matmul": 3,
       "hier_fused_tail": 4, "hier_forward_grouped:tail": 5,
       "dehier_tail_batched": 6, "hier_forward_grouped:axis0": 7,
       "dehier_axis0_batched": 8, "hier_scatter_grouped": 9,
       "flash_attention": 10, "flash_attention_lse": 10.1,
       "flash_attention_bwd": 10.2, "assemble_grouped": 11, "owner_fold": 12}
#: The per-bucket wrappers of rows 5, 7 and 9 (one-stack calls of the
#: grouped kernels), checked on the long-axis stacks: row -> wrapper.
PER_BUCKET = {"hier_forward_grouped:tail": "hier_tail_batched",
              "hier_forward_grouped:axis0": "hier_axis0_batched",
              "hier_scatter_grouped": "hier_axis0_scatter_batched"}
GRID_KERNELS = {  # the per-grid path: wrapper -> (source, TPU kernel)
    "hier_pole": (
        "src/repro_torch/kernels/csrc/pole_fwd.cu",
        "src/repro/kernels/hierarchize.py:152"),
    "dehier_pole": (
        "src/repro_torch/kernels/csrc/pole_inv.cu",
        "src/repro/kernels/hierarchize.py:206"),
    "apply_axis_matmul": (
        "src/repro_torch/kernels/csrc/axis_operator.cu",
        "src/repro/kernels/hierarchize.py:254"),
    "hier_fused_tail": (
        "src/repro_torch/kernels/csrc/fused_tail.cu",
        "src/repro/kernels/hierarchize.py:293"),
}
POLE_KERNELS = ("hier_pole", "dehier_pole")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def ptxas_kernels(log: str, kernel: str):
    """[(mangled name, registers, spill bytes stored and loaded)] of the
    kernels in an ``-Xptxas -v`` report whose name contains ``kernel``."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and kernel in name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def bump(*xs):
    """Smooth test function vanishing on the boundary of [0,1]^d."""
    out = 1.0
    for x in xs:
        out = out * 4.0 * x * (1.0 - x)
    return out * (1.0 + 0.5 * xs[0] - 0.25 * xs[-1] ** 2)


def seeded(seed: int):
    """Another smooth function vanishing on the boundary, its shape drawn
    from ``seed``: the second tenant's data."""
    import numpy as np
    a = np.random.default_rng(seed).uniform(-1.0, 1.0, 4)

    def f(*xs):
        out = 1.0
        for x in xs:
            out = out * 4.0 * x * (1.0 - x)
        return out * (a[0] + a[1] * xs[0] + a[2] * xs[-1] ** 2
                      + a[3] * xs[0] * xs[-1])
    return f


def lockdep_payloads(scheme, device):
    """The analysis phase's data: payload ``k`` of tenant ``bump`` or
    ``wave`` (``seeded(7)``), its sampled grids on ``device`` times
    ``1 + 0.01 k``."""
    from repro_torch.core.interpolation import sample_function
    base = {n: {ell: sample_function(f, ell, device=device)
                for ell, _ in scheme.grids}
            for n, f in (("bump", bump), ("wave", seeded(7)))}

    def payload(name, k):
        return {ell: g * (1.0 + 0.01 * k) for ell, g in base[name].items()}
    return payload


def surplus_sha256(t) -> str:
    """sha256 of a surplus's bytes (copied to the host)."""
    import hashlib
    a = t.detach().contiguous().cpu().numpy()
    return hashlib.sha256(memoryview(a).cast("B")).hexdigest()


def outcome(kind, f, points):
    """What became of a query or ingest future: ``None`` when it resolved
    with a value (a query's ``points`` finite values), ``"unresolved"``
    when not done within 120 s, else the failure.  Read at once, so that
    no caller keeps an ingest's 1.07 GB surplus alive through its
    future."""
    import numpy as np
    if not f.wait(120.0):
        return "unresolved"
    if f.error() is not None:
        return f"{kind}: {f.error()!r}"
    if kind == "query":
        out = f.result()
        if out.shape != (points,) or not np.isfinite(out).all():
            return f"query: {out.shape} not {points} finite"
    return None


def tally(outcomes):
    """``(unresolved, failed)`` of a load's outcomes."""
    return (sum(o == "unresolved" for o in outcomes),
            [o for o in outcomes if o not in (None, "unresolved")])


def counted_launches(run):
    """``run()`` with the kernel wrappers' counts set to 0 just before and
    read just after: ``(its value, launches of the ingest's kernels)``.
    The counts are not thread-safe; only whether each is 0 is read."""
    from repro_torch.kernels import hierarchize as H
    for w in H.WRAPPERS:
        w.launches = 0
    out = run()
    return out, {w.__name__: w.launches for w in H.WRAPPERS if w.launches}


def lockdep_engine_load(device, scheme, root) -> dict:
    """The analysis phase's engine load: a started ``CTEngine`` with a
    ``DurableStore`` under ``root``, tenants ``bump`` and ``wave`` of one
    signature, ``submitters`` threads each alternating an ingest and a
    query of ``points`` points on one tenant for ``engine_s`` seconds;
    then ``reps`` timed ``update`` calls and one-tenant queries, and a
    last ingest per tenant of payload ``final_k``.  An exception in the
    load is a failure of the run; the engine is closed on every path.
    Returns the futures' counts, the timings (ms) and each final
    surplus's sha256."""
    import numpy as np
    import torch
    from repro_torch.core.engine import CTEngine
    from repro_torch.runtime.durability import DurableStore

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    payload = lockdep_payloads(scheme, device)
    names = ("bump", "wave")
    engine = CTEngine(device=device, store=DurableStore(root, "h0"),
                      snapshot_interval=0, host_id="lockdep")
    for n in names:
        engine.register(n, scheme, payload(n, 0))
    engine.start()
    pts = np.random.default_rng(400).random((LOCKDEP["points"], scheme.dim))
    outcomes, errors = [], []
    stop_at = time.monotonic() + LOCKDEP["engine_s"]

    def submitter(i):
        name, k = names[i % len(names)], 0
        try:
            while time.monotonic() < stop_at:
                k += 1
                mine = [("ingest", engine.submit_ingest(
                            name, payload(name, 1000 * (i + 1) + k))),
                        ("query", engine.submit_query(name, pts))]
                outcomes.extend((kind, outcome(kind, f, LOCKDEP["points"]))
                                for kind, f in mine)
                del mine
        except Exception as exc:           # reported, never swallowed
            errors.append(f"submitter {i}: {exc!r}")

    threads = [threading.Thread(target=submitter, args=(i,),
                                name=f"submitter-{i}")
               for i in range(LOCKDEP["submitters"])]
    update_ms, query_ms, failed, sha = [], [], [], {}
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(LOCKDEP["engine_s"] + 240.0)
        engine.flush()
        for r in range(LOCKDEP["reps"]):
            g = payload("bump", 500 + r)
            sync()
            t0 = time.perf_counter()
            engine.update("bump", g)
            sync()
            update_ms.append((time.perf_counter() - t0) * 1e3)
        for _ in range(LOCKDEP["reps"]):
            t0 = time.perf_counter()
            out = engine.query("bump", pts)
            query_ms.append((time.perf_counter() - t0) * 1e3)
            if out.shape != (LOCKDEP["points"],) \
                    or not np.isfinite(out).all():
                failed.append("timed query: not finite")
        for n in names:
            engine.update(n, payload(n, LOCKDEP["final_k"]))
        sha = {n: surplus_sha256(engine.surplus(n)) for n in names}
    except Exception as exc:               # reported, never swallowed
        failed.append(f"load: {exc!r}")
    finally:
        engine.close()
    hung_threads = [t.name for t in threads if t.is_alive()]
    unresolved, failed_futures = tally([o for _, o in outcomes])
    failed = failed_futures + failed
    return {"futures": len(outcomes), "unresolved": unresolved,
            "failed": failed + errors + [f"hung {n}" for n in hung_threads],
            "ingests": sum(1 for kind, _ in outcomes if kind == "ingest"),
            "update_ms": update_ms, "query_ms": query_ms, "sha256": sha}


def lockdep_cluster_load(device, scheme, root) -> dict:
    """The analysis phase's cluster load: a durable ``CTCluster`` of
    ``hosts`` hosts on ``device`` (stores under ``root``, replication 1,
    seed 7), ``bump`` and ``wave`` registered with payload ``final_k``
    (host copies), ``start()``-ed, one query of ``points`` points every
    ``query_period_s`` for ``cluster_s`` seconds (longer while the faults
    run), ``fail_host`` of ``bump``'s primary half-way and
    ``restart_host`` of it at three quarters, on a thread of their own.
    At most ``window`` queries are in flight: when the window is full the
    load waits for its oldest query, so a host that pauses (a restore, a
    replay) holds the load back instead of being handed more than its
    bounded queue takes.  An exception in the load is a failure of the
    run; the cluster is stopped on every path.  Returns the futures'
    counts, the longest wait for a window slot, the failover's and the
    restart's timings, whether placement came back, and each tenant's
    final surplus's sha256."""
    import numpy as np
    from collections import deque
    from repro_torch.runtime.cluster import CTCluster
    from repro_torch.runtime.fault_tolerance import HostHealthConfig

    payload = lockdep_payloads(scheme, device)
    names = ("bump", "wave")
    cl = CTCluster(LOCKDEP["hosts"], replication=1, seed=7, device=device,
                   durability_dir=root, snapshot_interval=2,
                   monitor_interval_s=CLUSTER["monitor_s"],
                   health=HostHealthConfig(**CLUSTER["health"]))
    for n in names:
        cl.register(n, scheme, {ell: g.cpu().numpy() for ell, g in
                                payload(n, LOCKDEP["final_k"]).items()})
    before = {n: cl.owners_of(n) for n in names}
    victim = before["bump"][0]
    pts = np.random.default_rng(401).random((LOCKDEP["points"], scheme.dim))
    outcomes, errors = {}, []

    def faults():
        try:
            time.sleep(LOCKDEP["cluster_s"] / 2)
            outcomes["fail_host"] = cl.fail_host(victim, reason="analysis")
            time.sleep(LOCKDEP["cluster_s"] / 4)
            outcomes["restart_host"] = cl.restart_host(victim)
        except Exception as exc:
            errors.append(f"faults: {exc!r}")

    futs, in_flight, longest_wait_ms = [], deque(), 0.0
    fault_thread = threading.Thread(target=faults, name="faults")
    try:
        cl.start()
        t_end = time.monotonic() + LOCKDEP["cluster_s"]
        fault_thread.start()
        k = 0
        while (time.monotonic() < t_end or fault_thread.is_alive()) \
                and time.monotonic() < t_end + 240.0:
            while in_flight and in_flight[0].done():
                in_flight.popleft()
            if len(in_flight) >= LOCKDEP["window"]:
                t0 = time.monotonic()
                if not in_flight[0].wait(120.0):
                    errors.append(f"query {k - len(in_flight)} did not "
                                  f"resolve within 120 s")
                    break
                longest_wait_ms = max(longest_wait_ms,
                                      (time.monotonic() - t0) * 1e3)
                continue
            f = cl.submit_query(names[k % 2], pts)
            futs.append(("query", f))
            in_flight.append(f)
            k += 1
            time.sleep(LOCKDEP["query_period_s"])
    except Exception as exc:               # reported, never swallowed
        errors.append(f"load: {exc!r}")
    finally:
        if fault_thread.ident is not None:
            fault_thread.join(60.0)
            if fault_thread.is_alive():
                errors.append("the fault thread hung")
        cl.stop()
    unresolved, failed = tally([outcome(kind, f, LOCKDEP["points"])
                                for kind, f in futs])
    after = {n: cl.owners_of(n) for n in names}
    st = cl.stats()
    sha = {n: surplus_sha256(cl.surplus(n)) for n in names}
    return {"futures": len(futs), "unresolved": unresolved,
            "failed": failed + errors, "victim": victim,
            "outcomes": outcomes, "placement_restored": after == before,
            "longest_wait_ms": longest_wait_ms,
            "failover_ms": [f["recovery_ms"] for f in st["failovers"]],
            "restart_ms": [{k: r[k] for k in ("restore_ms", "replace_ms",
                                               "replay_ms", "total_ms")}
                           for r in st["restarts"]],
            "sha256": sha}


def lockdep_child(expect: str) -> int:
    """``chip_smoke.py --lockdep-child EXPECT``: the analysis phase's
    sanitized run at ``prod_3d`` on the card, started by the phase with
    ``REPRO_TORCH_LOCKDEP=1`` in its environment, so that every lock of
    the port, the module-level ones too, is instrumented from import.
    ``EXPECT`` is the JSON ``{tenant: sha256}`` of the parent's
    uninstrumented engine.  Prints one ``lockdep-child: {...}`` line and
    exits 1 unless the sanitizer recorded no violation and no cycle,
    every edge goes up in rank, every future resolved, each ingest
    kernel launched, and every final surplus's sha256 is the parent's."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.analysis import invariants, lockdep
    from repro_torch.configs.sparse_grid import CT_CONFIGS
    from repro_torch.core.levels import CombinationScheme

    if not (lockdep.enabled_by_env() and torch.cuda.is_available()):
        print("lockdep-child: needs REPRO_TORCH_LOCKDEP=1 and a CUDA "
              "device", file=sys.stderr)
        return 2
    want = json.loads(expect)
    cuda = torch.device("cuda")
    prod = CombinationScheme(CT_CONFIGS["prod_3d"].dim,
                             CT_CONFIGS["prod_3d"].level)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ct-lockdep-") as root:
        eng, eng_launches = counted_launches(lambda: lockdep_engine_load(
            cuda, prod, os.path.join(root, "engine")))
        clu, clu_launches = counted_launches(lambda: lockdep_cluster_load(
            cuda, prod, os.path.join(root, "cluster")))
    rep = lockdep.report()
    edges = [(e["from"], e["to"], e["count"]) for e in rep["edges"]]
    down = [e for e in edges if not invariants.LOCK_RANKS.get(e[0], 0)
            < invariants.LOCK_RANKS.get(e[1], 0)]
    problems = [f"{len(lockdep.violations())} violations"] * bool(
        lockdep.violations()) + [f"{len(rep['cycles'])} cycles"] * bool(
        rep["cycles"]) + [f"edges not up in rank {down}"] * bool(down)
    for label, r, launched in (("engine", eng, eng_launches),
                               ("cluster", clu, clu_launches)):
        if r["unresolved"] or r["failed"]:
            problems.append(f"{label}: {r['unresolved']} futures "
                            f"unresolved, failures {r['failed'][:5]}")
        missing = sorted(set(KERNELS) - set(launched))
        if missing:
            problems.append(f"{label}: {missing} not launched")
        if r["sha256"] != want:
            problems.append(f"{label}: final surpluses' sha256 {r['sha256']}"
                            f" differ from the uninstrumented {want}")
    if not clu["placement_restored"]:
        problems.append("cluster: placement not restored after the restart")
    print("lockdep-child: " + json.dumps({
        "engine": eng, "cluster": clu, "edges": edges,
        "launches": {"engine": eng_launches, "cluster": clu_launches},
        "dispatch_notes": rep["dispatch_notes"],
        "violations": lockdep.violations(), "cycles": rep["cycles"],
        "seconds": time.perf_counter() - t0, "problems": problems}))
    return 1 if problems else 0


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the port's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # The f32 checks hold full-precision products: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.sparse_grid import (CT_ADAPTIVE_CONFIGS,
                                                 CT_CONFIGS)
    from repro_torch.core import executor as E
    from repro_torch.core.combination import combined_interpolant_points
    from repro_torch.core.interpolation import (interpolate_hierarchical,
                                                sample_function)
    from repro_torch.core.levels import CombinationScheme, grid_shape
    from repro_torch.kernels import _build
    from repro_torch.kernels import hierarchize as H
    from repro_torch.checkpoint.checkpoint import _crc32
    from repro_torch.core.engine import (CTEngine, ExecSpec,
                                         IngestBuffersDonated,
                                         clear_compile_cache)
    from repro_torch.launch.serve import CTSurrogate
    from repro_torch.runtime.durability import DurableStore

    PROD, FIG7, FIG6 = ((CT_CONFIGS[n].dim, CT_CONFIGS[n].level)
                        for n in ("prod_3d", "fig7_4d", "fig6_2d"))
    card = smi()
    cuda = torch.device("cuda")
    print(f"card: {card}  ({torch.cuda.get_device_name(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda})")

    t0 = time.perf_counter()
    _build.load_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name, log in _build.PTXAS_LOG.items():
        if name in _build.CACHED:
            print(f"[{name}] already built; the ptxas report of that build:")
        for line in log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"[{name}] {line.strip()}")
    # The tensor-core products: rows 3 and 4 in f64 on DMMA (row 4's both
    # operand roles), row 10's bf16 forward and backward on the warpgroup
    # products (HGMMA) and nothing else, its f32 kernels on neither.
    for lib, instruction, kernel, count in (
            ("axis_operator", "DMMA", "axis_operator_f64_kernel", 1),
            ("fused_tail", "DMMA", "fused_tail_f64_kernel", 2),
            ("flash_attention", "HGMMA", "flash_kernel_wgmma", 6),
            ("flash_attention_bwd", "HGMMA", "_wgmma", 4)):
        code = {k: v for k, v in _build.sass(lib).items() if kernel in k}
        found = {k: v.count(instruction) for k, v in code.items()}
        if len(found) != count or not all(found.values()):
            fail(f"{lib}: expected {instruction} in each of {count} "
                 f"{kernel} kernels' SASS, found {found}")
        if instruction == "HGMMA" and any("HMMA" in v for v in code.values()):
            fail(f"{lib}: HMMA left in the {kernel} kernels' SASS")
        print(f"[{lib}] {sorted(found.values())} {instruction} instructions "
              f"in the SASS of its {count} {kernel} kernels")
    f32 = {k: ("HMMA" in v) + ("HGMMA" in v) for k, v in
           _build.sass("flash_attention").items() if "flash_kernel_f32" in k}
    if len(f32) != 4 or any(f32.values()):
        fail(f"flash_attention: the 4 f32 kernels hold tensor-core products "
             f"({f32})")
    # The bf16 kernels of row 10: registers, spills, shared memory; no
    # wgmma serialized (ptxas C7515, C7512) in the forward.
    libs = _build.load_all()
    smem = {"flash_attention": lambda hd, name: libs[
                "flash_attention"].flash_attention_smem(
                    hd, 3 if "ELi3E" in name else 2, int("Lb1E" in name)),
            "flash_attention_bwd": lambda hd, name: libs[
                "flash_attention_bwd"].flash_attention_bwd_smem(
                    hd, 0 if "bwd_dq_" in name else 1)}
    for lib, kernel in (("flash_attention", "flash_kernel_wgmma"),
                        ("flash_attention_bwd", "_wgmma")):
        for name, regs, spill in ptxas_kernels(_build.PTXAS_LOG[lib],
                                               kernel):
            hd = 128 if "ILi128E" in name else 64
            label = (f"flash_kernel_wgmma<{hd}, "
                     f"{3 if 'ELi3E' in name else 2}"
                     f"{', lse' if 'Lb1E' in name else ''}>"
                     if lib == "flash_attention" else
                     f"bwd_dq_wgmma<{hd}>" if "bwd_dq_" in name
                     else f"bwd_dkdv_wgmma<{hd}>")
            print(f"[{lib}] {label}: {regs} registers a thread at entry (the "
                  f"producer warpgroup down to 24 and the consumers up by "
                  f"setmaxnreg), {spill} spill bytes, {smem[lib](hd, name)} B "
                  f"of dynamic shared memory")
            if spill:
                fail(f"{lib}: ptxas spills {spill} bytes in {label}")
    serialized = [line.strip() for line in
                  _build.PTXAS_LOG["flash_attention"].splitlines()
                  if "wgmma.mma_async instructions are serialized" in line]
    if serialized:
        fail(f"flash_attention: ptxas serialized wgmma: {serialized}")

    bits = {torch.float64: torch.int64, torch.float32: torch.int32}

    def same(a, b) -> bool:
        a, b = a.contiguous(), b.to(a.device).contiguous()
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.view(bits[a.dtype]), b.view(bits[b.dtype]))

    def max_err(a, b) -> float:
        return float((a.double() - b.to(a.device).double()).abs().max())

    def wall_clock_ms(fn, reps=TIMING_REPS // 4) -> float:
        """Host clock around ``reps`` calls of ``fn`` ending in a
        synchronise, per call: end to end, host work included."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    sessions = {"all": 0, "empty": 0, "short": 0}
    last_report: dict = {}

    def traced(fn):
        """``fn`` once under the profiler, ending in a synchronise:
        returns its device ops and the host clock around it in us."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        sessions["all"] += 1
        sessions["empty"] += not ops
        return ops, wall_us

    def report(label, ops, wall_us, calls=1):
        """Prints, per call of ``calls``, the host clock, the device's busy
        time (the union of the device ops' intervals) and idle share, the
        device ops, the fills among them and the top ops; returns the
        host-clock ms per call."""
        spans, by_name = [], {}
        for e in ops:
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + (b - a))
        busy_us, end = 0.0, float("-inf")
        for a, b in sorted(spans):        # union of device intervals
            if b > end:
                busy_us += b - max(a, end)
                end = b
        fills = [(n, t) for k, (n, t) in by_name.items()
                 if "fill" in k.lower() or "memset" in k.lower()]
        fill_us = sum(t for _, t in fills) / calls
        wall, busy = wall_us / calls, busy_us / calls
        last_report.update(ops=len(spans) / calls, names=set(by_name))
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:7]
        print(f"profile {label}: wall {wall / 1e3:.4f} ms, device busy "
              f"{busy / 1e3:.4f} ms (idle share {1.0 - busy / wall:.4f}), "
              f"{len(spans) / calls:.1f} device ops; fills "
              f"{sum(n for n, _ in fills) / calls:.1f} ops "
              f"{fill_us / 1e3:.4f} ms (inside the busy time; busy without "
              f"them {(busy - fill_us) / 1e3:.4f} ms); top: " + "; ".join(
                  f"{k[:48]} x{n / calls:.1f} {t / calls / 1e3:.4f} ms"
                  for k, (n, t) in top) + f"  [{card}]")
        return wall / 1e3

    def profiled(label, fn):
        """``fn`` once under the profiler, ending in a synchronise (see
        ``report``).  ``fn`` may change state, so an empty session is
        reported, not run again."""
        ops, wall_us = traced(fn)
        if not ops:
            print(f"profile {label}: wall {wall_us / 1e3:.3f} ms; the "
                  f"profiler recorded no device activity  [{card}]")
            return wall_us / 1e3
        return report(label, ops, wall_us)

    def profiled_steps(label, fn, steps=5):
        """``fn`` under the profiler, one warm-up call and then ``steps`` + 1
        recorded calls, each ending in a synchronise; ``report`` per call
        over the last ``steps``.  The first recorded call is left out (a
        session can lose its first device activity), found by the
        profiler's step marks on the device timeline, which are not device
        ops themselves."""
        torch.cuda.synchronize()
        walls, events = [], []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=torch.profiler.schedule(
                         wait=0, warmup=1, active=steps + 1),
                     on_trace_ready=lambda p: events.extend(
                         p.events())) as prof:
            for _ in range(steps + 2):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e6)
                prof.step()
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        marks = sorted(e.time_range.end for e in device
                       if e.name.startswith("ProfilerStep"))
        ops = [e for e in device if not e.name.startswith("ProfilerStep")]
        sessions["all"] += 1
        sessions["empty"] += not ops
        if len(marks) != steps + 1:     # cannot tell the calls apart
            return report(f"{label}, per call (mean of {steps + 1} after a "
                          f"warm-up call; {len(marks)} step marks)", ops,
                          sum(walls[1:]), steps + 1)
        return report(f"{label}, per call (mean of {steps} after a warm-up "
                      f"and a first recorded call)",
                      [e for e in ops if e.time_range.start > marks[0]],
                      sum(walls[2:]), steps)

    err = {k: 0.0 for k in [*ROW, *KERNELS, *PER_BUCKET.values()]}
    rng = np.random.default_rng(0)

    # ------------------------------------------------------------------
    # Kernels vs their plain versions at the main path's shapes
    # ------------------------------------------------------------------
    def record_ingest(plan, grids):
        """One fused ingest through the executor's own dispatch; returns
        its wrapper calls ``(wrapper, arguments)`` in launch order."""
        with H.record_calls() as calls:
            E.ct_transform_with_plan(grids, plan, device=cuda)
        return list(calls)

    def replay(call, acc, *, plain=False, cpu=False):
        """Repeat a recorded wrapper call (or its plain version), with
        ``acc`` as the fine buffer and, if ``cpu``, CPU copies of the
        other tensors (the assembly's member grids too)."""
        wrapper, args = call
        on = (lambda v: v.cpu()) if cpu else (lambda v: v)
        args = {k: acc if k == "acc" else
                on(v) if torch.is_tensor(v) else
                [on(p) for p in v] if k == "parts" else v
                for k, v in args.items()}
        return (wrapper.plain if plain else wrapper)(**args)

    def strided(call):
        """The assembly call with every member grid given as a strided
        view (its axes reversed over a copy laid out the other way)."""
        wrapper, args = call
        parts = [p.permute(*reversed(range(p.ndim))).contiguous().permute(
            *reversed(range(p.ndim))) for p in args["parts"]]
        if all(p.is_contiguous() for p in parts):
            fail("the strided assembly check has no strided member")
        return wrapper, {**args, "parts": parts}

    def check_kernels(plan, grids, dtype, label):
        calls = record_ingest(plan, grids)
        acc_card = torch.zeros(plan.fine_size + 1, dtype=dtype, device=cuda)
        acc_cpu = torch.zeros(plan.fine_size + 1, dtype=dtype)
        counts = {}
        if calls[0][0] is H.assemble_grouped:
            calls.insert(1, strided(calls[0]))
        for call in calls:
            name = call[0].__name__
            counts[name] = counts.get(name, 0) + 1
            got = replay(call, acc_card)
            want = replay(call, acc_cpu, plain=True, cpu=True)
            if name == "hier_scatter_grouped":
                continue
            err[name] = max(err[name], max_err(got, want))
            if not same(got, want):
                fail(f"{name} differs from its plain version ({label})")
        if set(counts) != set(KERNELS):
            fail(f"the ingest made the wrapper calls {counts}, expected one "
                 f"each of {sorted(KERNELS)}")
        torch.cuda.synchronize()
        e = max_err(acc_card, acc_cpu)
        err["hier_scatter_grouped"] = max(err["hier_scatter_grouped"], e)
        if not same(acc_card, acc_cpu):
            fail(f"hier_scatter_grouped differs from its plain version "
                 f"({label}, max err {e})")
        print(f"kernel check {label}: bitwise equal to the plain versions "
              f"over {counts} wrapper calls (the assembly's second on "
              f"strided member grids)")

    def random_grids(scheme, dtype):
        return {ell: torch.from_numpy(rng.standard_normal(grid_shape(ell)))
                .to(dtype=dtype, device=cuda) for ell, _ in scheme.grids}

    prod = CombinationScheme(*PROD)
    prod_plan = E.build_plan(prod)
    for dtype in (torch.float64, torch.float32):
        check_kernels(prod_plan, random_grids(prod, dtype), dtype,
                      f"prod_3d {str(dtype)[6:]}")

    # long-axis stacks: every wrapper on every axis, compact index maps
    long_plan = E.build_plan(CombinationScheme(*LONG))
    square = (1 << ((LONG[1] + 1) // 2)) - 1
    wanted = (((1 << LONG[1]) - 1, 1), (square, square))
    stacks = [b for b in long_plan.buckets if b.shape in wanted]
    if len(stacks) != 2:
        fail(f"expected the {wanted} buckets, got "
             f"{[b.shape for b in long_plan.buckets]}")
    for b in stacks:
        for dtype in (torch.float64, torch.float32):
            g = len(b.ells)
            x = torch.from_numpy(rng.standard_normal((g,) + b.shape)).to(
                dtype=dtype, device=cuda)
            for name, got, want in [
                    ("hier_tail_batched", H.hier_tail_batched(x, b.levels),
                     H.hier_tail_batched(x.cpu(), b.levels)),
                    ("hier_axis0_batched",
                     H.hier_axis0_batched(x, [lv[0] for lv in b.levels]),
                     H.hier_axis0_batched(x.cpu(),
                                          [lv[0] for lv in b.levels]))]:
                err[name] = max(err[name], max_err(got, want))
                if not same(got, want):
                    fail(f"{name} differs on {b.shape} {dtype}")
            p = x[0].numel()
            index = torch.from_numpy(np.stack(
                [rng.permutation(2 * p)[:p] for _ in range(g)])
                .astype(np.int32))
            cs = torch.from_numpy(rng.choice([-3.0, -1.0, 1.0, 3.0], g)).to(
                dtype)
            for axis in range(len(b.shape)):
                lv = [l[axis] for l in b.levels]
                acc = torch.from_numpy(rng.standard_normal(2 * p + 1)).to(
                    dtype)
                want = H.hier_axis0_scatter_batched(x.cpu(), lv, cs, index,
                                                    acc.clone(), axis=axis)
                got = H.hier_axis0_scatter_batched(
                    x, lv, cs.to(cuda), index.to(cuda), acc.to(cuda),
                    axis=axis)
                err["hier_axis0_scatter_batched"] = max(
                    err["hier_axis0_scatter_batched"], max_err(got, want))
                if not same(got, want):
                    fail(f"scatter differs on {b.shape} axis {axis} {dtype}")
        print(f"kernel check long-axis stack {(len(b.ells),) + b.shape}: "
              f"bitwise equal in f64 and f32")
    # the grouped kernels over the whole long-axis plan: its 32767-long and
    # 255 x 255 members walk device memory; the scatter on compact maps
    long_table = E._ingest_table(long_plan)
    sc = long_table.scatter
    fine = 2 * sc.size
    maps = [np.where(b.index != long_plan.fine_size, np.stack([
        rng.permutation(fine)[:b.index.shape[1]] for _ in b.index]),
        fine).astype(np.int32) for b in long_plan.buckets]
    sc = H.scatter_table(sc.stacks, maps, fine)
    for dtype in (torch.float64, torch.float32):
        x = torch.from_numpy(rng.standard_normal(sc.size)).to(dtype)
        got = H.hier_forward_grouped(x.to(cuda), long_table.stacks)
        want = H.hier_forward_grouped(x, long_table.stacks)
        err["hier_forward_grouped"] = max(err["hier_forward_grouped"],
                                          max_err(got, want))
        if not same(got, want):
            fail(f"hier_forward_grouped differs on the long-axis plan "
                 f"({dtype})")
        cs = torch.from_numpy(rng.choice([-3.0, -1.0, 1.0, 3.0],
                                         sc.members)).to(dtype)
        acc = torch.from_numpy(rng.standard_normal(fine + 1)).to(dtype)
        got = H.hier_scatter_grouped(got, sc, cs.to(cuda), acc.to(cuda))
        want = H.hier_scatter_grouped(want, sc, cs, acc)
        err["hier_scatter_grouped"] = max(err["hier_scatter_grouped"],
                                          max_err(got, want))
        if not same(got, want):
            fail(f"hier_scatter_grouped differs on the long-axis plan "
                 f"({dtype})")
    long_grids = random_grids(CombinationScheme(*LONG), torch.float64)
    for dtype in (torch.float64, torch.float32):
        parts = [long_grids[ell].to(dtype) for b in long_plan.buckets
                 for ell in b.ells]
        call = (H.assemble_grouped, {"parts": parts, "stacks": tuple(
            (b.shape, b.perms) for b in long_plan.buckets)})
        for c in (call, strided(call)):
            got = replay(c, None)
            want = replay(c, None, plain=True, cpu=True)
            err["assemble_grouped"] = max(err["assemble_grouped"],
                                          max_err(got, want))
            if not same(got, want):
                fail(f"assemble_grouped differs on the long-axis plan "
                     f"({dtype})")
    del long_grids, parts
    biggest = max(int(np.prod(shape)) for shape, _, _ in sc.stacks)
    print(f"kernel check long-axis plan {LONG}: the assembly and the "
          f"grouped kernels over its "
          f"{len(long_plan.buckets)} buckets ({sc.size} values, members of "
          f"up to {biggest} values) bitwise equal in f64 and f32")

    # ------------------------------------------------------------------
    # The main path at full size: CTEngine on prod_3d, f64, two tenants of
    # one signature, CTSurrogate a view on the first
    # ------------------------------------------------------------------
    grids = {ell: sample_function(bump, ell, device=cuda)
             for ell, _ in prod.grids}
    wave = seeded(7)
    grids2 = {ell: sample_function(wave, ell, device=cuda)
              for ell, _ in prod.grids}
    points = [torch.from_numpy(np.random.default_rng(100 + i).random(
        (QUERY_BATCH, 3))) for i in range(QUERY_BATCHES)]
    clear_compile_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in H.WRAPPERS:
        w.launches = 0
    t0 = time.perf_counter()
    engine = CTEngine(device=cuda, ingest_workers=0)
    srv = CTSurrogate(prod, grids, engine=engine, name="bump")
    engine.register("wave", prod, grids2)
    torch.cuda.synchronize()
    construct_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with H.record_calls() as main_calls, H.count_launches() as one_ingest:
        engine.update("bump", grids)        # replayed by the timings
    torch.cuda.synchronize()
    ingest_ms = (time.perf_counter() - t0) * 1e3
    eval_before = engine.stats()["eval"]
    t0 = time.perf_counter()
    futs = {n: engine.submit_query(n, points[0].numpy())
            for n in ("bump", "wave")}
    engine.flush()
    coalesced = {n: f.result() for n, f in futs.items()}
    coalesced_ms = (time.perf_counter() - t0) * 1e3
    eval_after = engine.stats()["eval"]
    query_ms, answers = [], []
    for pts in points:
        t0 = time.perf_counter()
        answers.append(srv.query(pts.numpy()))   # returns host numpy
        torch.cuda.synchronize()
        query_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {name: getattr(H, name).launches for name in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    cache = engine.stats()["ingest_cache"]
    print(f"main path prod_3d: launches per 3 ingests (two registers, one "
          f"update) {launches}; one update "
          f"{ {k: v for k, v in one_ingest.items() if v} }; executable "
          f"cache {cache['misses']} miss, {cache['hits']} hit")
    for name, n in launches.items():
        if n == 0:
            fail(f"{name} was not launched on the main path")
    others = {w.__name__: w.launches for w in H.WRAPPERS
              if w.launches and w.__name__ not in KERNELS}
    if others or sum(launches.values()) > 3 * MAX_INGEST_LAUNCHES \
            or sum(one_ingest.values()) > MAX_INGEST_LAUNCHES:
        fail(f"the three ingests launched {launches} and {others}, one "
             f"update {one_ingest}: at most {MAX_INGEST_LAUNCHES} launches "
             f"an ingest, of {sorted(KERNELS)}")
    if (cache["misses"], cache["hits"]) != (1, 1):
        fail(f"two tenants of one signature: expected 1 miss and 1 hit, "
             f"got {cache}")
    batches = eval_after["batches"] - eval_before["batches"]
    merged_q = (eval_after["coalesced_queries"]
                - eval_before["coalesced_queries"])
    if (batches, merged_q) != (1, 1):
        fail(f"the two tenants' queries made {batches} eval batches and "
             f"{merged_q} coalesced queries, expected 1 and 1")
    for name, got in coalesced.items():
        alone = engine.query(name, points[0].numpy())
        if got.shape != (QUERY_BATCH,) or not np.array_equal(
                got.view(np.uint8), alone.view(np.uint8)):
            fail(f"{name}: the coalesced answer differs from its one-tenant "
                 f"query")
    print(f"prod_3d coalesced query over both tenants: 1 eval batch, 1 "
          f"coalesced query, each answer bitwise its one-tenant query; "
          f"{coalesced_ms:.2f} ms for the pair  [{card}]")

    surplus = srv.surplus
    if surplus.shape != grid_shape((PROD[1],) * PROD[0]) or \
            not bool(torch.isfinite(surplus).all()):
        fail(f"prod_3d surplus is not finite of the fine grid's shape")
    if not all(a.shape == (QUERY_BATCH,) and np.isfinite(a).all()
               for a in answers):
        fail("query answers are not finite of shape (1024,)")

    def check_surplus(scheme, grids, card_surplus, label):
        plan = E.build_plan(scheme)
        unfused = E.ct_transform_with_plan(grids, plan, fused=False,
                                           device=cuda)
        if not same(card_surplus, unfused):
            fail(f"{label}: fused and unfused ingest differ")
        del unfused
        cpu = E.ct_transform_with_plan({k: v.cpu() for k, v in
                                        grids.items()}, plan, device="cpu")
        if not same(cpu, card_surplus.cpu()):
            fail(f"{label}: card surplus differs from the CPU run "
                 f"(max err {max_err(card_surplus, cpu)})")
        print(f"{label}: surplus {tuple(card_surplus.shape)} bitwise equal "
              f"fused/unfused and card/CPU")
        return cpu

    check_surplus(prod, grids2, engine.surplus("wave"), "prod_3d wave")
    cpu_surplus = check_surplus(prod, grids, surplus, "prod_3d bump")
    pts = points[0][:CHECK_POINTS]
    want = interpolate_hierarchical(cpu_surplus, pts).numpy()
    got = answers[0][:CHECK_POINTS]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    direct = combined_interpolant_points(
        {k: v.cpu() for k, v in grids.items()}, prod, pts).numpy()
    np.testing.assert_allclose(got, direct, rtol=1e-9, atol=1e-12)
    print(f"prod_3d: {CHECK_POINTS} query points match the CPU eval "
          f"(max rel err {float(np.max(np.abs(got - want) / np.abs(want)))})"
          f" and the direct combination "
          f"(max abs err {float(np.max(np.abs(got - direct)))})")
    del cpu_surplus

    # refit through the engine: a refined scheme on the same fine grid
    extra = (PROD[1], 2) + (1,) * (PROD[0] - 2)
    refined = prod.as_general().with_levels([extra])
    grids3 = dict(grids2)
    grids3[extra] = sample_function(wave, extra, device=cuda)
    engine.refit("wave", refined, grids3)
    if engine.scheme("wave") != refined or engine.stats()[
            "ingest_cache"]["misses"] != 2:
        fail("refit did not serve the refined scheme on a new executable")
    check_surplus(refined, grids3, engine.surplus("wave"), "prod_3d refit")
    del grids3

    for label, config in (("fig7_4d", FIG7), ("fig6_2d", FIG6)):
        scheme = CombinationScheme(*config)
        g = {ell: sample_function(bump, ell, device=cuda)
             for ell, _ in scheme.grids}
        check_surplus(scheme, g, CTSurrogate(scheme, g, device=cuda).surplus,
                      label)

    # ------------------------------------------------------------------
    # The durable store and donation at prod_3d: journal, snapshot, crash,
    # restore and replay bitwise, then donated ingests on the restored
    # engine (counts zeroed before the restore, read after it)
    # ------------------------------------------------------------------
    def timed(fn, into):
        """``fn`` wrapped so that each call's host ms is appended."""
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                into.append((time.perf_counter() - t0) * 1e3)
        return wrapper

    def disk_bytes(root):
        return sum(os.path.getsize(os.path.join(d, f))
                   for d, _, files in os.walk(root) for f in files)

    values = sum(int(np.prod(grid_shape(ell))) for ell, _ in prod.grids)
    qpts = points[2].numpy()
    with tempfile.TemporaryDirectory(prefix="ct-store-") as root:
        append_ms, snapshot_ms, load_ms = [], [], []
        store1 = DurableStore(root, "h0")
        store1.append = timed(store1.append, append_ms)
        store1.snapshot = timed(store1.snapshot, snapshot_ms)
        e1 = CTEngine(device=cuda, ingest_workers=0, store=store1,
                      snapshot_interval=2)
        e1.register("bump", prod, grids)                     # seq 1
        e1.update("bump", {ell: sample_function(seeded(11), ell, device=cuda)
                           for ell, _ in prod.grids})        # seq 2: snapshot
        seq2_answer = e1.query("bump", qpts)
        e1.update("bump", {ell: sample_function(seeded(12), ell, device=cuda)
                           for ell, _ in prod.grids})        # seq 3: WAL only
        never_crashed = e1.surplus("bump")
        written = disk_bytes(root)
        if store1.stats()["snapshots"] != 1 or len(snapshot_ms) != 1:
            fail(f"expected one snapshot at seq 2, store stats "
                 f"{store1.stats()}")
        # the crash: e1 is left as it is, never closed
        torch.cuda.synchronize()
        for w in H.WRAPPERS:
            w.launches = 0
        store2 = DurableStore(root, "h0")
        store2.load = timed(store2.load, load_ms)
        e2 = CTEngine(device=cuda, ingest_workers=0, store=store2,
                      snapshot_interval=0)     # no snapshots past seq 2
        info = e2.restore()["bump"]
        torch.cuda.synchronize()
        replay_launches = {name: getattr(H, name).launches
                           for name in KERNELS}
        if (info.snapshot_seq, info.pending, info.replayed) != (2, 1, 1):
            fail(f"restore: expected snapshot_seq 2, pending 1, replayed 1, "
                 f"got {info}")
        if not same(e2.surplus("bump"), never_crashed):
            fail("the restored surplus differs from the never-crashed one")
        for name, n in replay_launches.items():
            if n == 0:
                fail(f"{name} was not launched by the replayed ingest")
        if sum(replay_launches.values()) > MAX_INGEST_LAUNCHES:
            fail(f"the replayed ingest launched {replay_launches}: at most "
                 f"{MAX_INGEST_LAUNCHES}")
        # restore without the replay: stale queries serve the snapshot
        e3 = CTEngine(device=cuda, ingest_workers=0)
        deferred = e3.restore(DurableStore(root, "h0"),
                              replay=False)["bump"]
        stale = e3.submit_query("bump", qpts, stale_ok=True)
        e3.flush()
        if deferred.replayed != 0 or not np.array_equal(
                stale.result().view(np.uint8), seq2_answer.view(np.uint8)):
            fail("restore(replay=False): the stale query is not bitwise the "
                 "seq-2 surplus's")
        e3.replay()
        if not same(e3.surplus("bump"), never_crashed):
            fail("replay() did not reach the never-crashed surplus")
        del e3, stale, never_crashed
        # the snapshot's steps, each timed alone on the restored surplus
        surplus = e2.surplus("bump")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = surplus.cpu().numpy()
        d2h_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        np.savez(os.path.join(root, "timing.npz"), surplus=host)
        npz_ms = (time.perf_counter() - t0) * 1e3
        os.remove(os.path.join(root, "timing.npz"))
        t0 = time.perf_counter()
        _crc32(host)
        crc_ms = (time.perf_counter() - t0) * 1e3
        del host, surplus
        print(f"durable prod_3d: restore bitwise the never-crashed engine "
              f"(snapshot seq 2, 1 WAL entry replayed, launches "
              f"{replay_launches}); restore(replay=False) served the seq-2 "
              f"surplus bitwise, replay() caught up bitwise")
        print(f"durable prod_3d times: WAL append (host copy of {values} "
              f"values, npz, write) median "
              f"{float(np.median(append_ms)):.3f} ms (runs "
              + ", ".join(f"{x:.3f}" for x in append_ms) + "); snapshot "
              f"(1.07 GB) {snapshot_ms[0]:.1f} ms, its steps alone: "
              f"device-to-host {d2h_ms:.1f} ms, npz write {npz_ms:.1f} ms, "
              f"crc32 {crc_ms:.1f} ms; restore {info.restore_s * 1e3:.1f} ms"
              f" = load and verify {load_ms[0]:.1f} ms + plan and adoption "
              f"onto the card {info.restore_s * 1e3 - load_ms[0]:.1f} ms; "
              f"replay {info.replay_s * 1e3 / info.replayed:.2f} ms per "
              f"entry; {written} B on disk  [{card}]")

        # donation: a second tenant of the same plan on the restored engine
        def owned(fn):
            return {ell: sample_function(fn, ell, device=cuda).clone()
                    for ell, _ in prod.grids}

        e2.register("donated", prod, owned(bump),
                    spec=ExecSpec(donate=True))
        kept = owned(seeded(13))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        given = owned(seeded(13))
        charged = torch.cuda.memory_allocated() - before
        before = torch.cuda.memory_allocated()
        e2.update("donated", given)
        torch.cuda.synchronize()
        dropped = before - torch.cuda.memory_allocated()
        e2.update("bump", kept)
        if not same(e2.surplus("donated"), e2.surplus("bump")):
            fail("the donated ingest differs from the non-donating one")
        if not all(H.storage_released(v) for v in given.values()):
            fail("a donated grid was not released")
        blocks = sum(-(-int(np.prod(grid_shape(ell))) * 8 // 512) * 512
                     for ell, _ in prod.grids)
        if dropped != charged or not values * 8 <= charged <= blocks:
            fail(f"donation: memory_allocated dropped by {dropped} B, the "
                 f"grids were charged {charged} B ({values} x 8 B = "
                 f"{values * 8} B, in 512 B blocks {blocks} B)")
        nan = owned(seeded(14))
        nan[next(iter(nan))].view(-1)[0] = float("nan")
        fut = e2.submit_ingest("donated", nan, check_finite=True)
        e2.flush()
        try:
            fut.result()
            fail("a NaN ingest under check_finite did not raise")
        except IngestBuffersDonated:
            pass
        if not same(e2.surplus("donated"), e2.surplus("bump")):
            fail("the NaN ingest changed the served surplus")
        with H.count_launches() as refused:
            try:
                e2.submit_ingest("donated", given)
                fail("released grids were accepted again")
            except IngestBuffersDonated:
                pass
        if any(refused.values()):
            fail(f"released grids reached a launch: {refused}")
        e2.update("donated", owned(seeded(15)))     # the context survived
        torch.cuda.synchronize()
        if not bool(torch.isfinite(e2.surplus("donated")).all()):
            fail("the ingest after the refusal is not finite")
        print(f"donation prod_3d: surplus bitwise the non-donating tenant's, "
              f"every grid released, memory_allocated dropped {dropped} B "
              f"(the grids' {values} x 8 B = {values * 8} B in the "
              f"allocator's blocks); a NaN under check_finite raised "
              f"IngestBuffersDonated, surplus unchanged; released grids "
              f"refused before any launch; the next ingest succeeded")
        sets = [owned(seeded(16 + i)) for i in range(ENGINE_UPDATES)]
        donate_ms = {"without donation": [], "with donation": []}
        for i in range(ENGINE_UPDATES):
            for label, name, g in (("without donation", "bump", kept),
                                   ("with donation", "donated", sets[i])):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e2.update(name, g)
                torch.cuda.synchronize()
                donate_ms[label].append((time.perf_counter() - t0) * 1e3)
        print("prod_3d update on the durable engine (WAL append included), "
              f"median of {ENGINE_UPDATES}: " + "; ".join(
                  f"{k} {float(np.median(v)):.3f} ms (runs "
                  + ", ".join(f"{x:.3f}" for x in v) + ")"
                  for k, v in donate_ms.items()) + f"  [{card}]")
        del e1, e2, given, kept, nan, sets

    # ------------------------------------------------------------------
    # The cluster at prod_3d: four durable hosts on the card, three tenants
    # of one signature under open-loop load, a kill half-way detected by
    # the health monitor, failover, a restart under load (counts zeroed
    # before the phase, read after it)
    # ------------------------------------------------------------------
    from repro_torch.runtime.cluster import CTCluster
    from repro_torch.runtime.fault_tolerance import HostHealthConfig

    base = {n: {ell: sample_function(f, ell, device=cuda).cpu().numpy()
                for ell, _ in prod.grids}
            for n, f in (("bump", bump), ("wave", seeded(7)),
                         ("ridge", seeded(11)))}

    def payload(name, k):
        """Submission ``k`` of tenant ``name``: host arrays, as a solver
        hands them over (the cluster retains host copies anyway)."""
        return {ell: g * (1.0 + 0.01 * k) for ell, g in base[name].items()}

    cpts = np.random.default_rng(300).random((CLUSTER["points"], 3))
    with tempfile.TemporaryDirectory(prefix="ct-cluster-") as root:
        torch.cuda.synchronize()
        for w in H.WRAPPERS:
            w.launches = 0
        t0 = time.perf_counter()
        cl = CTCluster(4, replication=1, seed=7, device=cuda,
                       durability_dir=root, snapshot_interval=2,
                       monitor_interval_s=CLUSTER["monitor_s"],
                       health=HostHealthConfig(**CLUSTER["health"]))
        for n in base:
            cl.register(n, prod, payload(n, 0))              # cluster seq 0
        register_ms = (time.perf_counter() - t0) * 1e3
        acked = {n: 0 for n in base}
        with H.count_launches() as routed:
            cl.update("bump", payload("bump", 1))             # seq 1
        routed = {k: v for k, v in routed.items() if v}
        if not 0 < sum(routed.values()) <= MAX_INGEST_LAUNCHES \
                or set(routed) - set(KERNELS):
            fail(f"a cluster-routed prod_3d ingest launched {routed}: at "
                 f"most {MAX_INGEST_LAUNCHES} launches, of {sorted(KERNELS)}")
        for n in ("wave", "ridge"):
            cl.update(n, payload(n, 1))                      # snapshot at 2
        acked = {n: 1 for n in base}
        before = {n: cl.owners_of(n) for n in base}
        victim = before["bump"][0]
        # (kind, tenant, k, phase, time the load meant to send it, future):
        # latency counts from the send time, so a submission held up by
        # the cluster's lock (a failover, a restart's rejoin) counts too
        futs = []
        marks = {}
        cl.start()
        t_start = time.monotonic()
        restarter = None
        k_query = 0
        while True:
            now = time.monotonic() - t_start
            if "updates" not in marks and now >= 0.2 * CLUSTER["load_s"]:
                marks["updates"] = now
                for n in base:                               # seq 2: WAL
                    futs.append(("ingest", n, 2, "before", time.monotonic(),
                                 cl.submit_ingest(n, payload(n, 2))))
            if "kill" not in marks and now >= 0.5 * CLUSTER["load_s"]:
                marks["kill"] = now
                cl.injector.kill(victim)
            if "kill" in marks and "failover" not in marks \
                    and victim not in cl.live_hosts():
                # live_hosts waits on the cluster lock that fail_host holds
                # until every tenant has moved
                marks["failover"] = time.monotonic() - t_start
            if "restart" not in marks and "failover" in marks \
                    and now >= 0.75 * CLUSTER["load_s"]:
                marks["restart"] = now
                restarter = threading.Thread(
                    target=cl.restart_host, args=(victim,), name="restart")
                restarter.start()
            if restarter is not None and "restarted" not in marks \
                    and not restarter.is_alive():
                marks["restarted"] = time.monotonic() - t_start
            if "restarted" in marks and now >= max(
                    CLUSTER["load_s"], marks["restarted"]
                    + CLUSTER["after_s"]):
                break
            if now > CLUSTER["load_s"] + 600:
                fail(f"cluster phase: no end to the load after {now:.0f} s "
                     f"(marks {marks})")
            phase = ("before" if "kill" not in marks else "after"
                     if "restarted" in marks else "during")
            name = list(base)[k_query % len(base)]
            futs.append(("query", name, k_query, phase, time.monotonic(),
                         cl.submit_query(name, cpts)))
            k_query += 1
            time.sleep(CLUSTER["query_period_s"])
        cl.stop()
        hung, errors = [], []
        for kind, name, k, phase, _, f in futs:
            if not f.wait(120.0):
                hung.append((kind, name, k))
            elif f.error() is not None:
                errors.append((kind, name, k, repr(f.error())))
            elif kind == "ingest":
                acked[name] = max(acked[name], k)
            elif f.result().shape != (len(cpts),) \
                    or not np.isfinite(f.result()).all():
                fail(f"cluster query {k} for {name!r}: not {len(cpts)} "
                     f"finite values")
        if hung or errors:
            fail(f"cluster phase: {len(hung)} futures hung {hung[:5]}, "
                 f"{len(errors)} resolved with an error {errors[:5]}")
        phase_launches = {name: getattr(H, name).launches
                          for name in KERNELS}
        stray = {w.__name__: w.launches for w in H.WRAPPERS
                 if w.launches and w.__name__ not in KERNELS}
        for name, n in phase_launches.items():
            if n == 0:
                fail(f"{name} was not launched in the cluster phase")
        if stray:
            fail(f"the cluster phase launched {stray}")
        after = {n: cl.owners_of(n) for n in base}
        st = cl.stats()
        json.dumps(st)
        if after != before or victim not in st["live_hosts"]:
            fail(f"placement after the restart {after} is not the pre-kill "
                 f"map {before}")
        if len(st["failovers"]) != 1 or st["failovers"][0]["host"] \
                != victim or len(st["restarts"]) != 1:
            fail(f"expected one failover of {victim} and one restart, got "
                 f"{st['failovers']} and {st['restarts']}")
        oracle = CTEngine(device=cuda, ingest_workers=0, host_id="oracle")
        for n in base:
            oracle.register(n, prod, payload(n, acked[n]))
            if not same(cl.surplus(n), oracle.surplus(n)):
                fail(f"cluster tenant {n!r}: surplus differs from the "
                     f"never-failed engine fed its newest acked payload "
                     f"(k={acked[n]})")
            if not np.array_equal(cl.query(n, cpts), oracle.query(n, cpts)):
                fail(f"cluster tenant {n!r}: queries differ from the "
                     f"never-failed engine's")
        on_disk = disk_bytes(root)
        fo, rs = st["failovers"][0], st["restarts"][0]
        lat = {p: sorted((f.done_at - sent) * 1e3
                         for kind, _, _, ph, sent, f in futs
                         if kind == "query" and ph == p)
               for p in ("before", "during", "after")}
        stale = sum(1 for kind, *_, f in futs
                    if kind == "query" and f.stale_seq is not None)
        retargeted = sum(1 for *_, f in futs if f.retargeted)
        print(f"cluster prod_3d: 4 hosts, 3 tenants (one signature), "
              f"register {register_ms:.1f} ms for the three; a routed "
              f"ingest {routed}; {len(futs)} futures ({k_query} queries of "
              f"{len(cpts)} points every {CLUSTER['query_period_s'] * 1e3:.0f}"
              f" ms, {len(futs) - k_query} updates), none dropped, "
              f"{retargeted} retargeted, {stale} stale-marked during the "
              f"replay; launches in the phase {phase_launches}; placement "
              f"restored {after}; every surplus bitwise and every query "
              f"equal to a never-failed engine fed the newest acked payloads "
              f"{acked}; {on_disk} B on disk")
        print(f"cluster prod_3d failover of {victim}: outcomes "
              f"{fo['outcomes']}, recovery_ms (kill to failover complete, "
              f"host clock) {(marks['failover'] - marks['kill']) * 1e3:.1f}"
              f", of which fail_host {fo['recovery_ms']:.1f} ms; "
              f"restart_host {rs['outcomes']}: restore "
              f"{rs['restore_ms']:.1f} ms, replace {rs['replace_ms']:.1f} "
              f"ms, replay {rs['replay_ms']:.1f} ms ({rs['replayed']} "
              f"entries), total {rs['total_ms']:.1f} ms  [{card}]")
        print("cluster prod_3d query latency (ms, from the load's send "
              "time to the engine's answer): " + "; ".join(
                  f"{p} {len(v)} queries p50 {np.percentile(v, 50):.3f} "
                  f"p99 {np.percentile(v, 99):.3f}"
                  for p, v in lat.items() if v) + f"  [{card}]")
        del cl, oracle, futs
    del base
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # The sharded ingest at prod_3d on meshes that repeat the one card:
    # 1-D fused, 1-D unfused and 2-D (member x slab), each bitwise the
    # single-device surplus (counts zeroed before each ingest, read after)
    # ------------------------------------------------------------------
    from repro_torch.core import distributed as D
    from repro_torch.core.combination import (combine_full,
                                              extract_from_full)
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels import ops as OPS

    mesh4 = make_mesh((4,), ("slab",), devices=[cuda] * 4)
    mesh22 = make_mesh((2, 2), ("member", "slab"), devices=[cuda] * 4)
    single = engine.surplus("bump")       # the single-device card surplus
    splans = {"1-D fused": E.shard_plan(prod_plan, 4),
              "1-D unfused": E.shard_plan(prod_plan, 4),
              "2-D": E.shard_plan(prod_plan, 2, n_groups=4)}
    shard_specs = {"1-D fused": (mesh4, ExecSpec()),
                   "1-D unfused": (mesh4, ExecSpec(fused=False)),
                   "2-D": (mesh22, ExecSpec(member_axis="member"))}

    def sharded_ingest(label, g, gather=True):
        mesh, spec = shard_specs[label]
        return D.ct_transform_sharded(g, prod, mesh, "slab",
                                      plan=splans[label], spec=spec,
                                      gather=gather)

    def kernel_calls(calls):
        """The recorded kernel calls, with their ``acc`` left out (a slab
        buffer each) and its size kept: ``(wrapper, args, acc numel)``."""
        return [(w, {k: v for k, v in a.items() if k != "acc"},
                 a["acc"].numel() if "acc" in a else None)
                for w, a in calls]

    def fresh(call, cpu=False):
        """Replay a ``kernel_calls`` entry on a zero buffer (the card's, or
        the CPU's with CPU copies of its tensors)."""
        w, a, n = call
        dtype = next(v.dtype for v in a.values() if torch.is_tensor(v)
                     and v.is_floating_point())
        acc = torch.zeros(n, dtype=dtype, device="cpu" if cpu else cuda)
        return replay((w, {**a, "acc": acc}), acc, plain=cpu, cpu=cpu)

    shard_times, shard_launches, shard_peak, shard_base = {}, {}, {}, {}
    slab_calls = fold_calls = None
    checked = {}
    single_ms = wall_clock_ms(
        lambda: E.ct_transform_with_plan(grids, prod_plan, device=cuda))
    for label, splan in splans.items():
        gc_collect()
        torch.cuda.synchronize()
        for w in H.WRAPPERS:
            w.launches = 0
        shard_base[label] = base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with H.record_calls() as calls, H.count_launches() as n:
            got = sharded_ingest(label, grids)
        torch.cuda.synchronize()
        shard_peak[label] = torch.cuda.max_memory_allocated() - base_mem
        made = {k: v for k, v in n.items() if v}
        shard_launches[label] = made
        want = E.plan_launch_stats(
            splan, fused=shard_specs[label][1].fused)["pallas_launches"]
        if not same(got, single):
            fail(f"the {label} sharded ingest differs from the "
                 f"single-device surplus (max err {max_err(got, single)})")
        if sum(made.values()) != want:
            fail(f"the {label} sharded ingest launched {made}, the plan "
                 f"says {want} kernel launches")
        if label == "1-D fused" and made != {
                "assemble_grouped": 1, "hier_forward_grouped": 1,
                "hier_scatter_grouped": 2 * splan.n_slabs}:
            fail(f"the 1-D fused sharded ingest launched {made}: the "
                 f"assembly 1, rows 5+7 1, row 9 two a slab")
        if label == "2-D" and made.get("owner_fold") != splan.n_slabs:
            fail(f"the 2-D sharded ingest launched {made}: one owner_fold "
                 f"a slab")
        del got
        parts = sharded_ingest(label, grids, gather=False)
        rows_per = splan.slab_rows
        flat_rows = single.shape[0]
        for s, slab in enumerate(parts.slabs):
            lo = s * rows_per
            hi = min(lo + rows_per, flat_rows)
            if slab.device.type != cuda.type or not same(
                    slab[:hi - lo], single[lo:hi]) or \
                    bool(slab[hi - lo:].any()):
                fail(f"{label}: slab {s} of gather=False is not its slice "
                     f"of the single-device surplus")
        del parts
        shard_times[label] = wall_clock_ms(lambda: sharded_ingest(label,
                                                                  grids))
        profiled_steps(f"prod_3d sharded ingest ({label})",
                       lambda: sharded_ingest(label, grids))
        # every kernel call of the ingest against its plain version, in
        # f64 and (for the slab tables and the fold) f32 too
        for dtype in (torch.float64, torch.float32):
            if dtype == torch.float64:
                rec = kernel_calls(calls)
            else:
                with H.record_calls() as calls32:
                    sharded_ingest(label, {k: v.float()
                                           for k, v in grids.items()})
                rec = kernel_calls(calls32)
            for call in rec:
                name = call[0].__name__
                if name in ("owner_fold", "hier_scatter_grouped"):
                    a, b = fresh(call), fresh(call, cpu=True)
                else:
                    a = replay((call[0], call[1]), None)
                    b = replay((call[0], call[1]), None, plain=True,
                               cpu=True)
                e = max_err(a, b)
                key = "hier_scatter_grouped" if name == \
                    "hier_scatter_grouped" else name
                err[key] = max(err.get(key, 0.0), e)
                if not same(a, b):
                    fail(f"{name} ({label}, {dtype}) differs from its plain "
                         f"version (max err {e})")
                checked[name] = checked.get(name, 0) + 1
            if dtype == torch.float64 and label == "1-D fused":
                slab_calls = [c for c in rec
                              if c[0].__name__ == "hier_scatter_grouped"]
            if dtype == torch.float64 and label == "2-D":
                fold_calls = [c for c in rec
                              if c[0].__name__ == "owner_fold"]
        del calls, calls32, rec, a, b
    slab_bytes = (splans["1-D fused"].slab_size + 1) * single.element_size()
    print(f"sharded prod_3d on one card (every slab and group on the same "
          f"device: the collectives are copies within the card, no "
          f"interconnect was measured): each surplus bitwise the "
          f"single-device one, gather=False slabs bitwise its slices; "
          f"kernel calls held bitwise against their plain versions in f64 "
          f"and f32: {checked}; launches per ingest {shard_launches}  "
          f"[{card}]")
    print(f"sharded prod_3d ingest (host clock, warm, per call): "
          f"single-device {single_ms:.3f} ms; " + "; ".join(
              f"{k} {v:.3f} ms" for k, v in shard_times.items())
          + f"; slab buffer {slab_bytes} B each (4 slabs; 2-D: 2 slabs of "
          f"{(splans['2-D'].slab_size + 1) * single.element_size()} B); "
          f"peak device memory above the resident state " + ", ".join(
              f"{k} {v} B (resident {shard_base[k]} B)"
              for k, v in shard_peak.items()) + f"  [{card}]")

    # CTEngine with a meshed tenant, rebind to the 2-D mesh and off it
    torch.cuda.synchronize()
    seng = CTEngine(device=cuda, ingest_workers=0, host_id="sharded")
    seng.register("flat", prod, grids)
    seng.register("m4", prod, grids, spec=ExecSpec(mesh=mesh4))
    spts = points[2].numpy()
    if not same(seng.surplus("m4"), single) or not np.array_equal(
            seng.query("m4", spts), seng.query("flat", spts)):
        fail("the meshed tenant's surplus or query differs from the "
             "unmeshed tenant's")
    carried = seng.surplus("m4")
    outcomes = [seng.rebind("m4", mesh=mesh22, member_axis="member")]
    if seng.surplus("m4") is not carried:
        fail("rebind did not carry the surplus")
    with H.count_launches() as n:
        seng.update("m4", grids)
    if not same(seng.surplus("m4"), single) or n["owner_fold"] != 2:
        fail(f"after rebind to the 2-D mesh the update launched "
             f"{ {k: v for k, v in n.items() if v} } or differs")
    outcomes.append(seng.rebind("m4", mesh=None, member_axis=None))
    if outcomes != ["resharded", "unsharded"] or not np.array_equal(
            seng.query("m4", spts), seng.query("flat", spts)):
        fail(f"rebind outcomes {outcomes} or the query after them differ")
    st = seng.stats()["ingest_cache"]
    print(f"sharded CTEngine prod_3d: tenant on the 4-slab mesh bitwise the "
          f"unmeshed one (surplus and a {len(spts)}-point query); rebind "
          f"{outcomes} with the surplus carried; executables {st}")
    del seng, carried

    # The psum paths and the comm phase at fig6_2d (at prod_3d the psum's
    # (G, fine) stack would be 117 GB): rtol 1e-12 against one device
    fig6 = CombinationScheme(*FIG6)
    g6 = {ell: sample_function(bump, ell, device=cuda)
          for ell, _ in fig6.grids}
    want6 = E.ct_transform(g6, fig6, device=cuda)

    def close(got, want, label):
        e = max_err(got, want)
        if not e <= 1e-12 * max(1.0, float(want.abs().max())):
            fail(f"{label}: max err {e} against the single-device result "
                 f"(rtol 1e-12)")
        return e

    psum_err = {"ct_transform_psum": close(D.ct_transform_psum(
        g6, fig6, mesh4, "slab"), want6, "ct_transform_psum")}
    h6 = {ell: OPS.hierarchize(g, "pole") for ell, g in g6.items()}
    comb6, fl6 = combine_full(h6, fig6)
    for route, kw in (("psum", {}), ("slab", {"spec": ExecSpec(n_slabs=4)})):
        out = D.comm_phase_sharded(h6, fig6, mesh4, "slab", **kw)
        psum_err[f"comm_phase_sharded ({route})"] = max(
            close(out[ell], extract_from_full(comb6, ell, fl6),
                  f"comm_phase_sharded ({route}) {ell}")
            for ell in out)
    print(f"sharded fig6_2d: psum paths within rtol 1e-12 of one device "
          f"(sums reassociated, the psum folded in rank order), max abs "
          f"err {psum_err}  [{card}]")
    del g6, want6, h6, comb6

    # Hosts over disjoint slices of the card repeated, at fig7_4d
    fig7 = CombinationScheme(*FIG7)
    g7 = {ell: sample_function(seeded(21), ell, device=cuda).cpu().numpy()
          for ell, _ in fig7.grids}
    oracle7 = CTEngine(device=cuda, ingest_workers=0)
    oracle7.register("t", fig7, g7)
    pts7 = np.random.default_rng(7).random((64, 4))
    for members in (1, 2):
        cl = CTCluster.over_device_slices(2, devices=[cuda] * 4,
                                          members=members, seed=11)
        cl.register("t", fig7, g7)
        if not same(cl.surplus("t"), oracle7.surplus("t")) or \
                not np.array_equal(cl.query("t", pts7),
                                   oracle7.query("t", pts7)):
            fail(f"over_device_slices(members={members}): tenant differs "
                 f"from a fresh engine's")
        del cl
    print("sharded fig7_4d: CTCluster.over_device_slices(2, 4 x the card), "
          "1-D and members=2, serves the tenant bitwise a fresh engine's")
    del g7, oracle7, single
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # Third path: the scatter phase and adaptivity (rows 6 and 8)
    # ------------------------------------------------------------------
    from repro_torch.core import adaptive as A
    from repro_torch.core.combination import (gather_subspaces,
                                              scatter_subspaces)
    from repro_torch.kernels import ops

    def same_grids(got, want, label):
        if set(got) != set(want):
            fail(f"{label}: scattered onto {len(got)} grids, expected "
                 f"{len(want)}")
        for ell, u in want.items():
            if not same(got[ell], u):
                fail(f"{label}: grid {ell} differs from the CPU run (max err "
                     f"{max_err(got[ell], u)})")

    inverse_calls = []      # every inverse wrapper call, replayed in (e)
    # (a) prod_3d: the served surplus scattered back, counts set to 0 first
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for w in H.WRAPPERS:
        w.launches = 0
    t0 = time.perf_counter()
    with H.record_calls() as scatter_calls:
        scattered = E.ct_scatter_with_plan(srv.surplus, srv._plan,
                                           device=cuda)
    torch.cuda.synchronize()
    scatter_first_ms = (time.perf_counter() - t0) * 1e3
    scatter_launches = {name: getattr(H, name).launches
                        for name in SCATTER_KERNELS}
    scatter_extra = torch.cuda.max_memory_allocated() - base_mem
    print(f"scatter path prod_3d: launches per ct_scatter {scatter_launches}"
          f", {len(scatter_calls)} wrapper calls; peak memory above the "
          f"served state {scatter_extra} B")
    for name, n in scatter_launches.items():
        if n == 0:
            fail(f"{name} was not launched on the scatter path")
    if scatter_extra >= srv.surplus.numel() * srv.surplus.element_size() // 2:
        fail(f"ct_scatter allocated {scatter_extra} B: the fine grid was "
             f"copied")
    inverse_calls += scatter_calls
    surplus_cpu = srv.surplus.cpu()
    same_grids(scattered, E.ct_scatter_with_plan(surplus_cpu, srv._plan,
                                                 device="cpu"),
               "prod_3d ct_scatter")
    merged_plan = E.build_plan(prod, merge=E.MergeConfig())
    if not any(len(set(b.levels)) > 1 for b in merged_plan.buckets):
        fail("the merged prod_3d plan has no member below its target")
    with H.record_calls() as calls:
        merged = E.ct_scatter_with_plan(srv.surplus, merged_plan, device=cuda)
    inverse_calls += calls
    same_grids(merged, E.ct_scatter_with_plan(surplus_cpu, merged_plan,
                                              device="cpu"),
               "prod_3d merged ct_scatter")
    for ell, u in scattered.items():
        if not torch.allclose(merged[ell], u, rtol=1e-12, atol=1e-15):
            fail(f"merged and default scatter differ on {ell}")
    if not all(bool(torch.isfinite(u).all()) and tuple(u.shape) ==
               grid_shape(ell) for ell, u in scattered.items()):
        fail("scattered grids are not finite of their grids' shapes")
    del surplus_cpu, merged
    stack = sum(b.index.size for b in srv._plan.buckets)
    print(f"prod_3d ct_scatter: {len(scattered)} grids from "
          f"{len(srv._plan.buckets)} buckets ({stack} values), default and "
          f"merged ({len(merged_plan.buckets)} buckets) plans bitwise equal "
          f"to the CPU run; first call {scatter_first_ms:.2f} ms  [{card}]")

    # (b) the scatter oracle at fig6_2d and fig7_4d, ct_embedded at fig6_2d
    for label in ("fig6_2d", "fig7_4d"):
        scheme = CT_CONFIGS[label].scheme
        g = {ell: sample_function(bump, ell, device=cuda)
             for ell, _ in scheme.grids}
        with H.record_calls() as calls:
            nodal = E.ct_scatter(E.ct_transform(g, scheme, device=cuda),
                                 scheme, device=cuda)
        inverse_calls += [c for c in calls if c[0].__name__ in SCATTER_KERNELS]
        gc = {k: v.cpu() for k, v in g.items()}
        oracle = scatter_subspaces(gather_subspaces(
            {ell: ops.hierarchize(u, "ref") for ell, u in gc.items()},
            scheme), scheme)
        worst = 0.0
        for ell, alpha in oracle.items():
            want = ops.dehierarchize(alpha, "ref")
            got = nodal[ell].cpu()
            worst = max(worst, max_err(got, want))
            if not torch.allclose(got, want, rtol=1e-11, atol=1e-12):
                fail(f"{label}: scattered grid {ell} is {max_err(got, want)} "
                     f"from the subspace oracle")
        print(f"{label}: ct_scatter onto {len(nodal)} grids within rtol "
              f"1e-11 / atol 1e-12 of the subspace oracle (max abs err "
              f"{worst})")
        if label == "fig6_2d":
            emb, coeffs, order = E.ct_embedded(g, scheme, device=cuda)
            if tuple(emb.shape) != (len(order),) + grid_shape(
                    (FIG6[1],) * FIG6[0]) or not bool(
                    torch.isfinite(emb).all()):
                fail(f"fig6_2d ct_embedded has shape {tuple(emb.shape)}")
            combined = torch.einsum("g,g...->...", coeffs, emb)
            full = E.ct_transform(g, scheme, device=cuda)
            if not torch.allclose(combined, full, rtol=1e-12, atol=1e-13):
                fail("fig6_2d: coeffs @ ct_embedded differs from the gather")
            cpu_emb, cpu_coeffs, cpu_order = E.ct_embedded(gc, scheme,
                                                           device="cpu")
            if cpu_order != order or not same(emb, cpu_emb) or \
                    not same(coeffs, cpu_coeffs):
                fail("fig6_2d: ct_embedded differs from the CPU run")
            print(f"fig6_2d ct_embedded {tuple(emb.shape)}: bitwise equal to "
                  f"the CPU run, coeffs @ embedded = the gather (max abs err "
                  f"{max_err(combined, full)})")
            del emb, cpu_emb, combined, full

    # (c) adaptivity on aniso_6d
    acfg = CT_ADAPTIVE_CONFIGS["aniso_6d"]
    target = A.make_anisotropic_target(acfg.dim, acfg.decay)
    probe = np.random.default_rng(acfg.eval_seed).random(
        (acfg.eval_points, acfg.dim))
    sample = A.nodal_sampler(target)
    regular = CombinationScheme(acfg.dim, acfg.baseline_level)
    err_regular = A.interpolation_error(E.ct_transform(
        {ell: torch.from_numpy(sample(ell)).to(cuda)
         for ell, _ in regular.grids}, regular, device=cuda), target, probe)
    drv = A.AdaptiveDriver(sample, dim=acfg.dim, config=A.AdaptiveConfig(
        max_points=acfg.max_points, max_level=acfg.max_level, device=cuda))
    step_ms = []
    while A.interpolation_error(drv.surplus, target, probe) > err_regular:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if drv.step() is None:
            fail(f"aniso_6d: AdaptiveDriver stopped ({drv.stop_reason}) "
                 f"above the regular scheme's error {err_regular}")
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    err_adaptive = A.interpolation_error(drv.surplus, target, probe)
    ratio = regular.total_points() / drv.scheme.total_points()
    maxlev = [max(ell[i] for ell in drv.scheme.index_set)
              for i in range(acfg.dim)]
    if ratio < 3.0:
        fail(f"aniso_6d: only {ratio:.2f}x fewer points than the regular "
             f"scheme")
    if maxlev != sorted(maxlev, reverse=True):
        fail(f"aniso_6d: axes not ranked by importance: {maxlev}")
    with H.record_calls() as calls:
        adaptive_nodal = E.ct_scatter(drv.surplus, drv.scheme, device=cuda)
    inverse_calls += calls
    same_grids(adaptive_nodal, E.ct_scatter(drv.surplus.cpu(), drv.scheme,
                                            device="cpu"),
               "aniso_6d ct_scatter")
    node_err = 0.0
    for ell, u in adaptive_nodal.items():     # the interpolant at the nodes
        axes = [torch.arange(1, 1 << l, dtype=torch.float64, device=cuda)
                * 2.0 ** -l for l in ell]
        nodes = torch.stack([a.reshape(-1) for a in torch.meshgrid(
            *axes, indexing="ij")], dim=1)
        want = interpolate_hierarchical(drv.surplus, nodes).reshape(u.shape)
        node_err = max(node_err, max_err(u, want))
        if not torch.allclose(u, want, rtol=1e-11, atol=1e-12):
            fail(f"aniso_6d: scattered grid {ell} is {max_err(u, want)} from "
                 f"the interpolant at its nodes")
    print(f"aniso_6d adaptive: {len(drv.history)} steps to error "
          f"{err_adaptive} <= regular {acfg.baseline_level} error "
          f"{err_regular} with {drv.scheme.total_points()} points against "
          f"{regular.total_points()} ({ratio:.2f}x fewer); per-axis max "
          f"levels {maxlev}; ct_scatter onto {len(adaptive_nodal)} grids "
          f"bitwise the CPU run, max err {node_err} against the interpolant "
          f"at the nodes; host ms per step (median "
          f"{float(np.median(step_ms)):.2f}, max {max(step_ms):.2f})  "
          f"[{card}]")
    adaptive_step_ms = profiled("aniso_6d one adaptive step", drv.step)
    if len(drv.history) == len(step_ms):
        fail(f"aniso_6d: the profiled step did not step ({drv.stop_reason})")
    del drv, adaptive_nodal

    # (d) fault recovery at prod_3d: both paths of drop_grid
    pts = points[2].numpy()
    dropped = (PROD[1],) + (1,) * (PROD[0] - 1)
    after = dict(grids)
    after[dropped] = torch.zeros_like(grids[dropped])      # stale, finite
    faulty = CTSurrogate(prod, grids, device=cuda)
    plan_before = faulty._plan
    drop_ms = {"coefficient-only": profiled(
        "prod_3d drop_grid (coefficient-only)",
        lambda: faulty.drop_grid([dropped], after))}
    reduced = prod.as_general().without_levels([dropped])
    if faulty.scheme != reduced or not all(
            a.index is b.index for a, b in zip(faulty._plan.buckets,
                                               plan_before.buckets)):
        fail("drop_grid did not take the coefficient-only path")
    fresh = CTSurrogate(reduced, {k: grids[k] for k, _ in reduced.grids},
                        device=cuda)
    np.testing.assert_allclose(faulty.query(pts), fresh.query(pts),
                               rtol=1e-12, atol=1e-15)
    del faulty, fresh
    dropped = (2, 2, PROD[1] - 2)          # activates (1, 1, PROD[1] - 3)
    activated = (1, 1, PROD[1] - 3)
    reduced = prod.as_general().without_levels([dropped])
    if set(dict(reduced.grids)) - set(dict(prod.grids)) != {activated}:
        fail(f"dropping {dropped} does not activate exactly {activated}")
    faulty = CTSurrogate(prod, grids, device=cuda)
    state = (faulty.scheme, faulty._plan, faulty.surplus)
    try:
        faulty.drop_grid([dropped], grids)
        fail(f"drop_grid without the data of {activated} did not raise")
    except ValueError as e:
        if str(activated) not in str(e):
            fail(f"drop_grid's error does not name {activated}: {e}")
    if any(a is not b for a, b in zip(state, (faulty.scheme, faulty._plan,
                                              faulty.surplus))):
        fail("a failed drop_grid changed the surrogate")
    full_grids = dict(grids)
    full_grids[activated] = sample_function(bump, activated, device=cuda)
    drop_ms["extend_plan fallback"] = profiled(
        "prod_3d drop_grid (extend_plan fallback)",
        lambda: faulty.drop_grid([dropped], full_grids))
    if faulty.scheme != reduced:
        fail("drop_grid (fallback) serves the wrong scheme")
    fresh = CTSurrogate(reduced, {k: full_grids[k] for k, _ in reduced.grids},
                        device=cuda)
    np.testing.assert_allclose(faulty.query(pts), fresh.query(pts),
                               rtol=1e-12, atol=1e-15)
    del faulty, fresh, state
    print(f"prod_3d drop_grid: coefficient-only and extend_plan fallback "
          f"(activating {activated}) both answer {len(pts)} queries within "
          f"rtol 1e-12 of a surrogate built on the reduced scheme; a "
          f"missing grid raises and changes nothing  [{card}]")

    # (e) every inverse call of (a)-(d), kernel against plain, f64 and f32
    counts = {}
    for wrapper, args in inverse_calls:
        name = wrapper.__name__
        counts[name] = counts.get(name, 0) + 1
        for dtype in (torch.float64, torch.float32):
            a = {**args, "x": args["x"].to(dtype)}
            got = wrapper(**a)
            want = wrapper.plain(**{**a, "x": a["x"].cpu()})
            err[name] = max(err[name], max_err(got, want))
            if not same(got, want):
                fail(f"{name} differs from its plain version ({dtype}, "
                     f"{tuple(a['x'].shape)})")
    print(f"inverse kernel checks: {counts} calls of (a)-(d) bitwise equal "
          f"to their plain versions in f64 and f32")

    # ------------------------------------------------------------------
    # Second path: per-grid (de)hierarchization (rows 1-4 of the table)
    # ------------------------------------------------------------------
    from repro_torch.core.iterated import run_iterated_heat
    from repro_torch.core.pde import heat_exact_factor
    from repro_torch.kernels.ref import (dehierarchize_1d_bruteforce,
                                         hierarchize_1d_bruteforce)

    op_tol = {torch.float64: (1e-11, 1e-12), torch.float32: (2e-5, 2e-5)}
    bf16_err, bf16_plain_err = {}, {}

    def bf16_ulp(t):
        """One bf16 unit in the last place of each entry of ``t`` (8
        significant bits: t = m * 2**e with 0.5 <= |m| < 1 has ulp
        2**(e - 8))."""
        return torch.exp2((torch.frexp(t.float()).exponent - 8).float())

    def hold(name, got, want, label):
        """A kernel's output against its plain version's on the same input:
        bitwise for the pole kernels, the reference's tolerances for the
        operator kernels."""
        want = want.to(got.device)
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name} ({label}): {got.dtype}{tuple(got.shape)} against "
                 f"{want.dtype}{tuple(want.shape)}")
        e = max_err(got, want) if got.numel() else 0.0
        err[name] = max(err[name], e)
        if name in POLE_KERNELS:
            ok = same(got, want)
        else:
            rtol, atol = op_tol[got.dtype]
            ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
        if not ok:
            fail(f"{name} differs from its plain version ({label}, max err "
                 f"{e})")

    def hold_calls(calls, label):
        """Replay recorded wrapper calls, kernel against plain version."""
        counts = {}
        for wrapper, args in calls:
            name = wrapper.__name__
            counts[name] = counts.get(name, 0) + 1
            hold(name, wrapper(**args), wrapper.plain(**args), label)
        return counts

    def brute(x, axes, inverse):
        """The f64 brute force (numpy) along ``axes`` of ``x``."""
        fn = dehierarchize_1d_bruteforce if inverse else \
            hierarchize_1d_bruteforce
        out = x.double().cpu().numpy()
        for axis in axes:
            out = fn(out, axis)
        return out

    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)

    def randn(shape, dtype=torch.float64):
        return torch.randn(shape, generator=gen, device=cuda,
                           dtype=torch.float64).to(dtype)

    bundle_calls = [(H.hier_pole, {"reduced_op": True}),
                    (H.hier_pole, {"reduced_op": False}),
                    (H.dehier_pole, {}),
                    (H.apply_axis_matmul, {"inverse": False}),
                    (H.apply_axis_matmul, {"inverse": True})]
    tail_shapes = [(7, 7), (31, 63, 127), (15, 7, 31, 3), (3,) * 10,
                   (7, 3, 3, 1, 3, 3, 7, 3, 3, 3)]
    for dtype in (torch.float64, torch.float32):
        with H.count_launches() as n:
            x = randn((1, 8), dtype)
            for wrapper, kw in bundle_calls:
                if wrapper(x, **kw) is not x:
                    fail(f"{wrapper.__name__}: level 1 is not the identity")
            x = randn((7, 1, 1), dtype)
            if H.hier_fused_tail(x) is not x:
                fail("hier_fused_tail: level-1 tail axes are not the identity")
        if any(n.values()):
            fail(f"the identity launched kernels: {n}")
        for level, cols in ((2, 1), (5, 33), (9, 1000)):
            x = randn(((1 << level) - 1, cols), dtype)
            for wrapper, kw in bundle_calls:
                hold(wrapper.__name__, wrapper(x, **kw),
                     wrapper.plain(x, **kw), f"({x.shape[0]}, {cols}) {dtype}")
        for shape in tail_shapes:
            x = randn(shape, dtype)
            for inverse in (False, True):
                hold("hier_fused_tail", H.hier_fused_tail(x, inverse=inverse),
                     H.hier_fused_tail.plain(x, inverse=inverse),
                     f"{shape} {dtype}")
    for inverse in (False, True):          # bf16: summed in f32
        x = randn((511, 1000), torch.bfloat16)
        cases = [("apply_axis_matmul", x,
                  H.apply_axis_matmul(x, inverse=inverse), (0,))]
        for shape in ((31, 63, 127), (15, 7, 31, 3)):
            y = randn(shape, torch.bfloat16)
            cases.append(("hier_fused_tail", y,
                          H.hier_fused_tail(y, inverse=inverse),
                          range(1, len(shape))))
        for name, x_in, got, axes in cases:
            if got.dtype != torch.bfloat16:
                fail(f"{name} bf16 returned {got.dtype}")
            e = float(np.max(np.abs(got.double().cpu().numpy()
                                    - brute(x_in, axes, inverse))))
            bf16_err[name] = max(bf16_err.get(name, 0.0), e)
            if not e < 0.15:
                fail(f"{name} bf16 is {e} from the f64 brute force")
            # Both sum in f32 and round to bf16 once: within one bf16 ulp
            # of the plain version, plus the f32 sums' order (2**-12).
            want = getattr(H, name).plain(x_in, inverse=inverse)
            diff = (got.float() - want.float()).abs()
            bf16_plain_err[name] = max(bf16_plain_err.get(name, 0.0),
                                       float(diff.max()))
            if not bool((diff <= bf16_ulp(want) + 2.0 ** -12).all()):
                fail(f"{name} bf16 is more than one bf16 ulp from its plain "
                     f"version (max err {float(diff.max())})")
    print(f"per-grid kernel checks: pole kernels bitwise, operator kernels "
          f"within the reference's tolerances in f64 and f32 (max abs err "
          f"{ {k: err[k] for k in GRID_KERNELS} }); bf16 against the f64 "
          f"brute force {bf16_err} (< 0.15), against the plain version "
          f"{bf16_plain_err} (<= 1 bf16 ulp + 2**-12)")

    # Real-size round trips through kernels.ops
    def round_trip(x, method, label, expect):
        for w in H.WRAPPERS:
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with H.record_calls() as calls:
            alpha = ops.hierarchize(x, method)
            back = ops.dehierarchize(alpha, method)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        got = {w.__name__: w.launches for w in H.WRAPPERS if w.launches}
        if set(got) != set(expect):
            fail(f"{label} {method}: launched {got}, expected {expect}")
        del alpha
        scale = float(x.abs().max())
        e = max_err(back, x)
        del back
        if not e <= 1e-12 * scale:
            fail(f"{label} {method}: round trip error {e} > 1e-12 * {scale}")
        counts = hold_calls(calls, f"{label} {method}")
        print(f"{label} {method}: hierarchize + dehierarchize "
              f"{wall:.1f} ms (first call), launches {got}, round trip max "
              f"err {e} (max |x| {scale}); each of {counts} calls held "
              f"against its plain version  [{card}]")
        return wall

    cube = randn(grid_shape(CUBE))
    rt_ms = {}
    for method, expect in (("pole", POLE_KERNELS),
                           ("matmul", ("apply_axis_matmul",)),
                           ("auto", ("apply_axis_matmul", "hier_fused_tail"))):
        round_trip(cube, method, "511^3 f64", expect)
        rt_ms[method] = wall_clock_ms(
            lambda: ops.dehierarchize(ops.hierarchize(cube, method), method))
    plane = randn(grid_shape(PLANE))
    round_trip(plane, "pole", f"{PLANE} f64", POLE_KERNELS)
    rt_ms[f"{PLANE} pole"] = wall_clock_ms(
        lambda: ops.dehierarchize(ops.hierarchize(plane, "pole"), "pole"))
    del plane

    # The iterated combination round at prod_3d, card against CPU
    it_launches, it_ms = {}, {}
    pts = np.random.default_rng(3).random((256, 3)) * 0.8 + 0.1
    u0 = np.prod(np.sin(np.pi * pts), axis=1)
    for method, mine in (("auto", ("apply_axis_matmul", "hier_fused_tail")),
                         ("pole", POLE_KERNELS)):
        for w in H.WRAPPERS:
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with H.record_calls() as calls:
            it, t_end = run_iterated_heat(*PROD, hier_method=method,
                                          device=cuda, **ITERATED)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        got = {w.__name__: w.launches for w in H.WRAPPERS if w.launches}
        if set(got) != set(mine):
            fail(f"iterated {method}: launched {got}, expected {mine}")
        it_launches.update({k: got[k] for k in mine})
        counts = hold_calls(calls, f"iterated prod_3d {method}")
        cpu_it, _ = run_iterated_heat(*PROD, hier_method=method,
                                      device="cpu", **ITERATED)
        worst = 0.0
        for ell, u in cpu_it.grids.items():
            card_u = it.grids[ell].cpu()
            if not bool(torch.isfinite(card_u).all()):
                fail(f"iterated {method}: grid {ell} is not finite")
            worst = max(worst, float(((card_u - u).abs()
                                      / u.abs().clamp_min(1e-300)).max()))
            if not torch.allclose(card_u, u, rtol=1e-12, atol=1e-15):
                fail(f"iterated {method}: grid {ell} differs from the CPU "
                     f"run (max err {max_err(card_u, u)})")
        exact = heat_exact_factor(PROD[0], 0.05, t_end) * u0
        ex_err = float(np.max(np.abs(
            it.evaluate(torch.from_numpy(pts)).cpu().numpy() - exact)))
        round_ms = wall_clock_ms(lambda: it.round(ITERATED["t_steps"]),
                                 reps=3)
        comm_ms = wall_clock_ms(it.communication_phase, reps=3)
        it_ms[method] = (round_ms, comm_ms)
        print(f"iterated prod_3d {method}: run_iterated_heat{PROD} "
              f"{ITERATED} {wall:.1f} ms (first call), one round "
              f"{round_ms:.2f} ms of which communication phase "
              f"{comm_ms:.2f} ms; launches {got}; card vs CPU max rel err "
              f"{worst} (rtol 1e-12); error against the exact solution at "
              f"256 points {ex_err}; each of {counts} calls held against its "
              f"plain version  [{card}]")
        if method == "auto":
            iterated = it

    # ------------------------------------------------------------------
    # Kernel timings: the main path's own wrapper calls (prod_3d, f64)
    # ------------------------------------------------------------------
    from repro_torch.kernels.ref import dehier_operator_matrix, operator_matrix

    def wall_ms(fn) -> float:
        """CUDA events around ``fn``: device time plus the host work the
        device waits on (Python dispatch of each call)."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMING_REPS):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / TIMING_REPS

    def events_ms(fn) -> float:
        """CUDA events around TIMING_REPS back-to-back calls of ``fn``, queued
        behind a sleep kernel that holds the stream until the host has
        queued them all: device time without the host's dispatch."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        host_s = (time.perf_counter() - t0) / 2     # a call, host and device
        torch.cuda._sleep(int(2e9 * (TIMING_REPS * host_s + 0.005)))
        start.record()
        for _ in range(TIMING_REPS):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / TIMING_REPS

    def device_ms(fn, only=None, launches=None) -> float:
        """Device time of ``fn``: the profiler's device activity (kernels,
        copies, fills) summed over TIMING_REPS calls.  With ``only`` (a
        name or a tuple of names), every device op must have one of them
        in its name.  A session that records no device activity, or with
        ``launches`` (the kernels a call launches) fewer device ops than
        the calls launched, lost some: it is run again, up to
        PROFILE_TRIES in all; if none records them all, the time is
        ``wall_ms`` (CUDA events) instead."""
        fn()

        def reps():
            for _ in range(TIMING_REPS):
                fn()

        for _ in range(PROFILE_TRIES):
            ops, _ = traced(reps)
            short = launches is not None and \
                len(ops) < launches * TIMING_REPS
            sessions["short"] += bool(ops) and short
            if ops and not short:
                break
        else:
            ms = wall_ms(fn)
            print(f"device_ms: {PROFILE_TRIES} profiler sessions recorded "
                  f"no device activity, or fewer device ops than the calls "
                  f"launched; CUDA events around the calls "
                  f"instead: {ms:.4f} ms (device time plus launch gaps"
                  + (f"; not checked that only {only} ran" if only else "")
                  + f")  [{card}]")
            return ms
        only = (only,) if isinstance(only, str) else only
        others = sorted({e.name for e in ops
                         if only and not any(o in e.name for o in only)})
        if others:
            fail(f"device ops other than {only}: {others}")
        us = sum(e.time_range.end - e.time_range.start for e in ops)
        return us / TIMING_REPS / 1e3

    tail_wrappers = (H.hier_tail_batched, H.dehier_tail_batched)

    def live_axes(wrapper, args):
        """The axes a call passes over, each of extent > 1."""
        x = args["x"]
        if wrapper in tail_wrappers:
            axes = args["axes"] or range(1, x.ndim - 1)
        else:
            axes = (args.get("axis", 0),)
        return [k for k in axes if x.shape[k + 1] > 1]

    def dense_einsum(x, levels, axes, inverse):
        """One ``torch.einsum`` computing passes along the live bucket
        ``axes`` of the (G, *shape) stack ``x`` with the dense per-member
        1-D operators (``H``, or ``H^-1`` for ``inverse``; identity on a
        member's pad rows): ``(spec, operands)``, the stack first, or None
        without a live axis."""
        matrix = dehier_operator_matrix if inverse else operator_matrix
        axes = [k for k in axes if x.shape[k + 1] > 1]
        if not axes:
            return None
        src = "z" + "abcdefghij"[:x.ndim - 1]
        out, subs, operands = list(src), [], []
        for k in axes:
            n = x.shape[k + 1]
            h = torch.zeros((x.shape[0], n, n), dtype=torch.float64)
            for g, lv in enumerate(levels):
                m = (1 << lv[k]) - 1
                h[g] = torch.eye(n, dtype=torch.float64)
                h[g, :m, :m] = torch.from_numpy(matrix(lv[k]))
            subs.append("z" + "ABCDEFGHIJ"[k] + src[k + 1])
            out[k + 1] = "ABCDEFGHIJ"[k]
            operands.append(h.to(x))
        return ",".join([src] + subs) + "->" + "".join(out), [x] + operands

    def dense_pass(wrapper, args):
        levels = (args["member_levels"] if wrapper in tail_wrappers
                  else [(l,) for l in args["levels0"]])   # axis 0 only
        return dense_einsum(args["x"], levels, live_axes(wrapper, args),
                            wrapper.__name__ in SCATTER_KERNELS)

    def library_call(calls, name):
        """The dense einsum of every call, each checked to compute the
        same function, as one callable."""
        dense = [(c, dense_pass(*c)) for c in calls]
        dense = [(c, d) for c, d in dense if d is not None]
        for c, (spec, operands) in dense:      # the same function?
            want = replay(c, acc)
            e = max_err(torch.einsum(spec, *operands), want)
            if e > 1e-12 * max(1.0, float(want.abs().max())):
                fail(f"einsum {spec} differs from {name} by {e}")
        return lambda: [torch.einsum(spec, *operands)
                        for _, (spec, operands) in dense]

    def grouped_library(x, stacks, got, name):
        """One dense einsum per stack of a grouped forward call, each
        checked against the call's output ``got``, as one callable."""
        dense = []
        sizes = [len(lv) * int(np.prod(shape)) for shape, lv, _ in stacks]
        ends = np.cumsum([0] + sizes).tolist()
        for (shape, levels, axes), a, b in zip(stacks, ends, ends[1:]):
            d = dense_einsum(x[a:b].view((len(levels),) + shape), levels,
                             axes, False)
            if d is None:
                continue
            spec, operands = d
            want = got[a:b].view(operands[0].shape)
            e = max_err(torch.einsum(spec, *operands), want)
            if e > 1e-12 * max(1.0, float(want.abs().max())):
                fail(f"einsum {spec} differs from {name} by {e}")
            dense.append(d)
        return lambda: [torch.einsum(spec, *operands)
                        for spec, operands in dense]

    def timed_row(name, source, replaces, kernel, plain, library, counted,
                  nbytes, per, calls, launches_per, only, events=False):
        """A row of the kernels line.  ``events``: ``ms`` and ``plain_ms``
        by CUDA events behind the sleep kernel, the profiler's time (whose
        sessions may lose launches; ``only`` still checks what ran) as
        ``profiler_ms``."""
        profiler_ms = device_ms(kernel, only=only)
        ms = events_ms(kernel) if events else profiler_ms
        library_ms = None if library is None else device_ms(library)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counted,
            "max_abs_err": err[name], "ms": ms,
            "plain_ms": events_ms(plain) if events else device_ms(plain),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library_ms,
            "wrapper_ms": wall_ms(kernel), "plain_wrapper_ms": wall_ms(plain)})
        r = rows[-1]
        if events:
            r["profiler_ms"] = profiler_ms
        print(f"{name}: device {ms:.4f} ms per {per} ({calls} calls, "
              f"{launches_per} launches"
              + (f"; events, the profiler {profiler_ms:.4f} ms"
                 if events else "")
              + f"), bound {r['bound_ms']:.6f} "
              f"ms ({nbytes} B at 3.35 TB/s); plain {r['plain_ms']:.4f} ms; "
              f"library (einsum) {library_ms} ms; with host dispatch: "
              f"kernel {r['wrapper_ms']:.4f} ms, plain "
              f"{r['plain_wrapper_ms']:.4f} ms  [{card}]")
        return r

    acc = torch.zeros(srv._plan.fine_size + 1, dtype=torch.float64,
                      device=cuda)
    rows = []
    # Rows 5, 7 and 9 per prod_3d ingest: the main path's grouped calls.
    # Each row's bound is the work of that row whatever implements it:
    # every stack passed along a row-5 (tail) or row-7 (axis-0) axis read
    # once and written once; for row 9 each stack element and its index
    # read once and each listed entry's slot read and written once.
    (fwd, fwd_args), = [c for c in main_calls
                        if c[0].__name__ == "hier_forward_grouped"]
    scatter_call, = [c for c in main_calls
                     if c[0].__name__ == "hier_scatter_grouped"]
    item = fwd_args["x"].element_size()
    ingest_fwd_ms = device_ms(lambda: replay((fwd, fwd_args), acc),
                              only="axis_pass")
    print(f"hier_forward_grouped: device {ingest_fwd_ms:.4f} ms per ingest "
          f"(one launch, rows 5 and 7 together, "
          f"{len(fwd_args['stacks'])} stacks)  [{card}]")
    fwd_source, fwd_replaces = KERNELS["hier_forward_grouped"]
    for kind, keep in (("tail", lambda k: k > 0), ("axis0", lambda k: k == 0)):
        name = f"hier_forward_grouped:{kind}"
        stacks = tuple((shape, lv, tuple(k for k in axes if keep(k)))
                       for shape, lv, axes in fwd_args["stacks"])
        call = (fwd, {**fwd_args, "stacks": stacks})
        got = replay(call, acc)
        err[name] = max(err[name], err["hier_forward_grouped"],
                        err[PER_BUCKET[name]])
        if not same(got, replay(call, acc, plain=True)):
            fail(f"{name} differs from its plain version")
        nbytes = sum(2 * len(lv) * int(np.prod(shape)) * item
                     for shape, lv, axes in stacks
                     if any(shape[k] > 1 for k in axes))
        r = timed_row(name, fwd_source, fwd_replaces[kind],
                      lambda: replay(call, acc),
                      lambda: replay(call, acc, plain=True),
                      grouped_library(fwd_args["x"], stacks, got, name),
                      launches["hier_forward_grouped"], nbytes, "ingest",
                      1, 1, "axis_pass_fwd")
        r["ingest_ms"] = ingest_fwd_ms
    table = scatter_call[1]["table"]
    err["hier_scatter_grouped"] = max(err["hier_scatter_grouped"],
                                      err["hier_axis0_scatter_batched"])
    row9_bytes = table.size * (item + 4) + 2 * len(table.entries) * item
    row9 = timed_row("hier_scatter_grouped", *KERNELS["hier_scatter_grouped"],
                     lambda: replay(scatter_call, acc),
                     lambda: replay(scatter_call, acc, plain=True), None,
                     launches["hier_scatter_grouped"], row9_bytes,
                     "ingest", 1, launches["hier_scatter_grouped"] // 2,
                     "scatter_", events=True)

    def on_fresh(calls, plain=False):
        """The recorded sharded calls (``kernel_calls``) replayed on zero
        buffers of their own, as one callable."""
        bufs = [torch.zeros(n, dtype=torch.float64, device=cuda)
                for _, _, n in calls]
        return lambda: [replay((w, {**a, "acc": b}), b, plain=plain)
                        for (w, a, _), b in zip(calls, bufs)]

    # Row 9 slab-local: the 1-D fused sharded ingest's calls, one a slab of
    # the 4-slab mesh, on the card repeated; the same work in all as the
    # single-device call, so the same bound
    slab_run, slab_plain = on_fresh(slab_calls), on_fresh(slab_calls, True)
    row9.update({
        "slab_ms": events_ms(slab_run),
        "slab_profiler_ms": device_ms(slab_run, only="scatter_"),
        "slab_plain_ms": events_ms(slab_plain),
        "slab_wrapper_ms": wall_ms(slab_run),
        "slab_launches": shard_launches["1-D fused"]["hier_scatter_grouped"],
        "slab_bound_ms": row9_bytes / HBM_BYTES_PER_S * 1e3,
        "slabs": len(slab_calls)})
    print(f"hier_scatter_grouped slab-local: device {row9['slab_ms']:.4f} ms "
          f"by events (the profiler {row9['slab_profiler_ms']:.4f} ms) "
          f"per sharded ingest ({len(slab_calls)} calls, one a slab, "
          f"{row9['slab_launches']} launches), bound "
          f"{row9['slab_bound_ms']:.6f} ms; plain "
          f"{row9['slab_plain_ms']:.4f} ms; with host dispatch "
          f"{row9['slab_wrapper_ms']:.4f} ms  [{card}]")
    # Row 12, the 2-D ingest's owner fold (port-only), one call a slab;
    # bound: each value a run lists and its entry read once (the payloads'
    # pad positions, which no run lists, are not read), each owner's slot,
    # offsets and accumulator read once and its slot written once
    fold_run, fold_plain = on_fresh(fold_calls), on_fresh(fold_calls, True)
    n_values = sum(a["values"].numel() for _, a, _ in fold_calls)
    n_entries = sum(len(a["table"].entries) for _, a, _ in fold_calls)
    n_owners = sum(a["table"].owners for _, a, _ in fold_calls)
    fold_bytes = n_entries * (item + 4) + n_owners * (4 + 8 + 2 * item)
    fold_profiler_ms = device_ms(fold_run, only="owner_fold")
    ms = events_ms(fold_run)
    # The library call: one index_add_ a slab over the concatenated
    # ship_idx[s] (pad positions onto the dump slot), the same per-slot
    # sums in no fixed order; timed here only, the port never calls it
    two_d = splans["2-D"]
    fold_dst = [torch.from_numpy(np.concatenate(
        [sb.ship_idx[s].reshape(-1) for sb in two_d.slab_buckets]).astype(
            np.int64)).to(cuda) for s in range(two_d.n_slabs)]
    lib_bufs = [torch.zeros(n, dtype=torch.float64, device=cuda)
                for _, _, n in fold_calls]

    def fold_library():
        for (_, a, _), idx, buf in zip(fold_calls, fold_dst, lib_bufs):
            buf.index_add_(0, idx, a["values"])

    fold_library_ms = device_ms(fold_library)
    lib_errs = []
    for (fold_w, fold_args, fold_n), fold_idx in zip(fold_calls, fold_dst):
        lib_acc = torch.zeros(fold_n, dtype=torch.float64, device=cuda)
        lib_acc.index_add_(0, fold_idx, fold_args["values"])
        fold_acc = torch.zeros_like(lib_acc)
        replay((fold_w, {**fold_args, "acc": fold_acc}), fold_acc)
        lib_errs.append(max_err(lib_acc[:-1], fold_acc[:-1]))
    fold_lib_err = max(lib_errs)
    del lib_bufs, fold_dst, lib_acc, fold_acc
    rows.append({
        "name": "owner_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/owner_fold.cu",
        # no TPU kernel: the reference's ordered `.at[dst].add` of the
        # 2-D gather, which XLA runs as one in-order scatter-add
        "replaces": "src/repro/core/distributed.py:476",
        "launches": shard_launches["2-D"]["owner_fold"],
        "max_abs_err": err.get("owner_fold", 0.0), "ms": ms,
        "profiler_ms": fold_profiler_ms,
        "plain_ms": events_ms(fold_plain),
        "bound_ms": fold_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": fold_library_ms,
        "wrapper_ms": wall_ms(fold_run), "plain_wrapper_ms": wall_ms(
            fold_plain)})
    r = rows[-1]
    print(f"owner_fold: device {ms:.4f} ms per 2-D ingest by events (the "
          f"profiler {fold_profiler_ms:.4f} ms) "
          f"({len(fold_calls)} calls, one a slab, {r['launches']} launches, "
          f"{n_entries} of {n_values} shipped values onto {n_owners} "
          f"slots, the rest pad), bound {r['bound_ms']:.6f} ms "
          f"({fold_bytes} B at 3.35 TB/s); plain {r['plain_ms']:.4f} ms; "
          f"library (index_add_ a slab, in no fixed order, never called by "
          f"the port) {fold_library_ms:.4f} ms, max abs diff "
          f"{fold_lib_err}; with host dispatch: kernel "
          f"{r['wrapper_ms']:.4f} ms, plain {r['plain_wrapper_ms']:.4f} ms"
          f"  [{card}]")
    del slab_run, slab_plain, fold_run, fold_plain
    # The assembly per prod_3d ingest: its recorded call, against the
    # present copy loop (its plain version); bound: every member value
    # read once, every stack value written once
    asm_call, = [c for c in main_calls if c[0].__name__ == "assemble_grouped"]
    asm_in = sum(p.numel() for p in asm_call[1]["parts"])
    asm_out = replay(asm_call, acc).numel()
    asm_row = timed_row("assemble_grouped", *KERNELS["assemble_grouped"],
                        lambda: replay(asm_call, acc),
                        lambda: replay(asm_call, acc, plain=True), None,
                        launches["assemble_grouped"], (asm_in + asm_out) * item,
                        "ingest", 1, 1, "assemble_members", events=True)
    # the same call with every member a strided view, read in place
    asm_strided = strided(asm_call)
    asm_row["strided_ms"] = events_ms(lambda: replay(asm_strided, acc))
    asm_row["strided_wrapper_ms"] = wall_ms(lambda: replay(asm_strided, acc))
    print(f"assemble_grouped on strided members (each read in place): "
          f"device {asm_row['strided_ms']:.4f} ms by events, with host "
          f"dispatch {asm_row['strided_wrapper_ms']:.4f} ms  [{card}]")
    # The launch floor: an empty kernel of this repository, timed as rows
    # 9, 11 and 12 are
    floor = _build.kernel("launch_floor", "empty")
    floor_ms = events_ms(lambda: H._raise_on(
        floor(torch.cuda.current_stream().cuda_stream), "launch_floor"))
    for r in rows:
        if r["name"] in ("hier_forward_grouped:tail",
                         "hier_forward_grouped:axis0", "hier_scatter_grouped",
                         "assemble_grouped", "owner_fold"):
            r["launch_floor_ms"] = floor_ms
    print(f"launch floor: an empty kernel {floor_ms:.4f} ms a launch by "
          f"events behind the sleep kernel; rows 5 and 7 (one shared "
          f"launch) {ingest_fwd_ms:.4f} ms (profiler), row 9 (two "
          f"launches) {row9['ms']:.4f}, row 11 (one) {asm_row['ms']:.4f}, "
          f"row 12 (two) {ms:.4f} ms by events  [{card}]")
    # Rows 6 and 8 per prod_3d ct_scatter: the per-bucket inverse calls
    for name, (source, replaces) in SCATTER_KERNELS.items():
        mine = [c for c in scatter_calls if c[0].__name__ == name]
        nbytes = sum(2 * args["x"].numel() * args["x"].element_size()
                     for wrapper, args in mine if live_axes(wrapper, args))
        timed_row(name, source, replaces,
                  lambda: [replay(c, acc) for c in mine],
                  lambda: [replay(c, acc, plain=True) for c in mine],
                  library_call(mine, name), scatter_launches[name], nbytes,
                  "ct_scatter", len(mine), scatter_launches[name],
                  "axis_pass")

    # Rows 6 and 8, one call each on the 511^3 f64 cube (G = 1)
    cube_calls = {
        "dehier_tail_batched": (H.dehier_tail_batched, {
            "x": cube[None], "member_levels": [CUBE], "axes": None}),
        "dehier_axis0_batched": (H.dehier_axis0_batched, {
            "x": cube[None], "levels0": [CUBE[0]]})}
    for r in rows:
        call = cube_calls.get(r["name"])
        if call is None:
            continue
        with H.count_launches() as counted:
            got = replay(call, acc)
        want = replay(call, acc, plain=True)
        cube_launches = counted[r["name"]]
        if cube_launches != len(live_axes(*call)):
            fail(f"{r['name']} made {cube_launches} launches on the cube, "
                 f"one per live axis is {len(live_axes(*call))}")
        err[r["name"]] = max(err[r["name"]], max_err(got, want))
        if not same(got, want):
            fail(f"{r['name']} differs from its plain version on the cube")
        del got, want
        library = library_call([call], r["name"])
        r["max_abs_err"] = err[r["name"]]
        r.update(cube_ms=device_ms(lambda: replay(call, acc),
                                   only="axis_pass_inv"),
                 cube_events_ms=events_ms(lambda: replay(call, acc)),
                 cube_plain_ms=device_ms(lambda: replay(call, acc,
                                                        plain=True)),
                 cube_library_ms=device_ms(library),
                 cube_bound_ms=(2 * cube.numel() * cube.element_size()
                                / HBM_BYTES_PER_S * 1e3),
                 cube_launches=cube_launches)
        print(f"{r['name']}: device {r['cube_ms']:.4f} ms per call on 511^3 "
              f"f64 (events {r['cube_events_ms']:.4f} ms; "
              f"{r['cube_launches']} launches, bitwise its plain "
              f"version), bound {r['cube_bound_ms']:.4f} ms; plain "
              f"{r['cube_plain_ms']:.4f} ms; library (einsum) "
              f"{r['cube_library_ms']:.4f} ms  [{card}]")

    # The per-grid kernels, one call each on the 511^3 f64 grid
    n0 = cube.shape[0]
    bundle = cube.reshape(n0, -1)           # axis 0 of the cube, a view
    item = cube.element_size()
    ops_f64 = {inv: H._operator(CUBE[0], inv, torch.float64, cuda)
               for inv in (False, True)}
    tail_dense_flops = 2 * sum(cube.shape[1:]) * cube.numel()
    grid_cases = {
        # name: (kernel call, plain call, library call, axes transformed,
        #        flops of the dense operators or None, kernel op)
        "hier_pole": (lambda: H.hier_pole(bundle),
                      lambda: H.hier_pole.plain(bundle),
                      lambda: torch.matmul(ops_f64[False], bundle),
                      1, None, "pole_fwd"),
        "dehier_pole": (lambda: H.dehier_pole(bundle),
                        lambda: H.dehier_pole.plain(bundle),
                        lambda: torch.matmul(ops_f64[True], bundle),
                        1, None, "pole_inv"),
        "apply_axis_matmul": (
            lambda: H.apply_axis_matmul(bundle),
            lambda: H.apply_axis_matmul.plain(bundle),
            lambda: torch.matmul(ops_f64[False], bundle),
            1, 2 * n0 * bundle.numel(),
            ("axis_operator", "repair_nonfinite")),
        "hier_fused_tail": (
            lambda: H.hier_fused_tail(cube),
            lambda: H.hier_fused_tail.plain(cube),
            lambda: torch.einsum("rjl,ij,kl->rik", cube, ops_f64[False],
                                 ops_f64[False]),
            cube.ndim - 1, tail_dense_flops,
            ("fused_tail", "repair_nonfinite")),
    }
    for name, (kernel, plain, library, axes, dense_flops,
               op) in grid_cases.items():
        with H.count_launches() as counted:
            got = kernel()
        # one launch a call; the fused tail one a tail axis
        if counted[name] != (axes if name == "hier_fused_tail" else 1):
            fail(f"{name} made {counted[name]} launches on the cube")
        lib = library().reshape(cube.shape[0], -1)
        e = max_err(got.reshape(lib.shape), lib)
        if not e <= 1e-11 * float(lib.abs().max()):   # the same function?
            fail(f"the library call differs from {name} by {e}")
        del got, lib
        # Rows 1 and 2 by CUDA events: a profiler session over their calls
        # has recorded fewer kernels than they launched (a device time
        # below the byte bound).
        timer = events_ms if name in POLE_KERNELS else device_ms
        ms = events_ms(kernel) if name in POLE_KERNELS else \
            device_ms(kernel, only=op)
        # The function's own bound, whatever the kernel's formulation: the
        # grid read once and written once, and the 3-term update (3 flops)
        # per point and axis.  The dense operators' flops are kept apart.
        flops = 3 * axes * cube.numel()
        bytes_ms = 2 * cube.numel() * item / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / FLOP_PER_S * 1e3
        source, replaces = GRID_KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": it_launches[name],
            "max_abs_err": err[name], "ms": ms,
            "plain_ms": timer(plain),
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": timer(library),
            "wrapper_ms": wall_ms(kernel), "plain_wrapper_ms": wall_ms(plain),
            "dense_flop_ms": (None if dense_flops is None
                              else dense_flops / FLOP_PER_S * 1e3)})
        r = rows[-1]
        dense = ("" if dense_flops is None else
                 f"; the dense operators' {dense_flops} flop alone "
                 f"{r['dense_flop_ms']:.4f} ms")
        if name in ("apply_axis_matmul", "hier_fused_tail"):
            # the kernels multiply only the operator's nonzero tiles
            tiles = H._operator_tiles(CUBE[0], False, torch.float64, cuda)[0]
            slab_flops = 2 * tiles.numel() * bundle.shape[1] * axes
            dense += (f", the operator's {tiles.shape[0]} nonzero tiles "
                      f"over {axes} axes {slab_flops} flop "
                      f"{slab_flops / FLOP_PER_S * 1e3:.4f} ms")
        print(f"{name}: {'events' if timer is events_ms else 'device'} "
              f"{ms:.4f} ms per call on 511^3 f64 "
              f"({counted[name]} launches), "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({2 * cube.numel() * item} B at 3.35 TB/s, {flops} flop at "
              f"67 TFLOP/s){dense}; plain {r['plain_ms']:.4f} ms; library "
              f"{r['library_ms']:.4f} ms; with host dispatch: kernel "
              f"{r['wrapper_ms']:.4f} ms, plain {r['plain_wrapper_ms']:.4f} "
              f"ms; launches in the iterated round {it_launches[name]}  "
              f"[{card}]")

    # Rows 1 and 2 at every shape the port gives them, each axis in place:
    # bitwise their plain versions in f64 and f32 (row 1 with reduced_op
    # both ways), then timed by CUDA events behind the sleep kernel beside
    # the bound (the grid read once and written once), the plain version
    # and one torch.matmul with the dense operator along the axis.
    def time_pole_row(name, label, x, axis):
        """Row 1 or 2 (``name``) on ``x`` along ``axis``: one launch, the
        library call checked against it, the ``events_by_shape`` entry."""
        wrapper = getattr(H, name)
        inverse = name == "dehier_pole"
        outer, n, inner = H._view(x.shape, axis)
        nbytes = 2 * x.numel() * x.element_size()
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = 3 * x.numel() / FLOP_PER_S * 1e3
        with H.count_launches() as counted:
            got = wrapper(x, axis=axis)
        if counted[name] != 1:
            fail(f"{name} made {counted[name]} launches on {label}")
        op_bytes = n * n * x.element_size()
        library_ms, note = None, (f"none: the dense operator takes "
                                  f"{op_bytes} B, past {LIBRARY_MAX_BYTES}")
        if op_bytes <= LIBRARY_MAX_BYTES:
            h = H._operator(n.bit_length(), inverse, x.dtype, cuda)
            if inner == 1:
                library = lambda: torch.matmul(x.reshape(outer, n), h.T)
            else:
                library = lambda: torch.matmul(h, x.reshape(outer, n, inner))
            e = max_err(library().reshape(x.shape), got)
            tol = 1e-10 if x.dtype == torch.float64 else 1e-4
            if not e <= tol * float(x.abs().max()):
                fail(f"the library call differs from {name} on {label} by "
                     f"{e}")
            library_ms, note = events_ms(library), "torch.matmul"
        del got
        entry = {
            "shape": list(x.shape), "axis": axis,
            "dtype": str(x.dtype).removeprefix("torch."),
            "view": [outer, n, inner], "launches": counted[name],
            "ms": events_ms(lambda: wrapper(x, axis=axis)),
            "plain_ms": events_ms(lambda: wrapper.plain(x, axis=axis)),
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": library_ms, "library": note}
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"{name} on {label} {tuple(x.shape)} {entry['dtype']}, axis "
              f"{axis} in place (view {outer} x {n} x {inner}): events "
              f"{entry['ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms by "
              f"{entry['bound_by']} ({nbytes} B at 3.35 TB/s), "
              f"{entry['bound_ms'] / entry['ms']:.0%} of it; plain "
              f"{entry['plain_ms']:.4f} ms; library ({note}) {lib}; "
              f"bitwise its plain version in f64 and f32"
              + ("" if inverse else " with reduced_op both ways")
              + f"  [{card}]")
        return entry

    plane = randn(grid_shape(PLANE))
    pole_shapes = {
        "cube axis 0 (bundle)": (bundle, 0),
        "cube axis 1": (cube, 1),
        "cube axis 2": (cube, 2),
        "plane axis 0": (plane, 0),
        "plane axis 1": (plane, 1),
        "codec bundle": (randn(POLE_CODEC, torch.float32), 0),
        f"level-{POLE_LONG} pole": (randn(((1 << POLE_LONG) - 1, 1)), 0),
    }
    pole_rows = {r["name"]: r for r in rows if r["name"] in POLE_KERNELS}
    for r in pole_rows.values():
        r["events_by_shape"] = {}
    for label, (x, axis) in pole_shapes.items():
        for dtype in (torch.float64, torch.float32):
            y = x.to(dtype)
            for reduced_op in (True, False):
                hold("hier_pole", H.hier_pole(y, reduced_op=reduced_op,
                                              axis=axis),
                     H.hier_pole.plain(y, reduced_op=reduced_op, axis=axis),
                     f"{label} {dtype}")
            hold("dehier_pole", H.dehier_pole(y, axis=axis),
                 H.dehier_pole.plain(y, axis=axis), f"{label} {dtype}")
            del y
        for name, r in pole_rows.items():
            r["events_by_shape"][label] = time_pole_row(name, label, x, axis)
    for name, r in pole_rows.items():
        r["max_abs_err"] = err[name]
    del plane, pole_shapes, x
    # Rows 3 and 4 on non-finite input: the plain version's (the dense
    # products') NaN / +Inf / -Inf masks, the finite rest at the operator
    # tolerances; a fully non-finite input of each, timed
    def hold_masks(name, got, want, label):
        want = want.to(got.device)
        for mask in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(mask(got), mask(want)):
                n = int((mask(got) != mask(want)).sum())
                fail(f"{name} ({label}): its {mask.__name__} mask differs "
                     f"from the plain version's in {n} places")
        fin = torch.isfinite(want)
        rtol, atol = op_tol[got.dtype]
        if not bool(((got[fin] - want[fin]).abs()
                     <= atol + rtol * want[fin].abs()).all()):
            fail(f"{name} ({label}): finite values differ")

    def spoil(x):
        """``x`` with ten +Infs, ten -Infs and ten NaNs at seeded
        places."""
        x = x.clone()
        flat = x.view(-1)
        picks = torch.from_numpy(rng.choice(flat.numel(), 30, replace=False))
        flat[picks[:10].to(cuda)] = float("inf")
        flat[picks[10:20].to(cuda)] = float("-inf")
        flat[picks[20:].to(cuda)] = float("nan")
        return x

    def all_non_finite(shape):
        return torch.from_numpy(rng.choice([np.inf, -np.inf, np.nan],
                                           shape)).to(cuda)

    nf_ms = {}
    for name, wrapper, shape, full_shape in (
            ("apply_axis_matmul", H.apply_axis_matmul, (511, 4096),
             (511, 4096)),
            ("hier_fused_tail", H.hier_fused_tail, (31, 63, 127),
             (4095, 511))):
        x = spoil(randn(shape))
        if wrapper is H.apply_axis_matmul:
            x[:, 7] = float("nan")
        else:
            x[3, 5, :] = float("nan")
        for inverse in (False, True):
            hold_masks(name, wrapper(x, inverse=inverse),
                       wrapper.plain(x, inverse=inverse),
                       f"{shape} f64 non-finite, inverse={inverse}")
        x = all_non_finite(full_shape)
        hold_masks(name, wrapper(x), wrapper.plain(x),
                   f"{full_shape} f64 all non-finite")
        nf_ms[name] = device_ms(lambda: wrapper(x))
        r = next(r for r in rows if r["name"] == name)
        r["nonfinite_ms"] = nf_ms[name]
    print(f"rows 3 and 4 on non-finite input: the plain version's NaN / "
          f"+Inf / -Inf masks (seeded Infs, NaNs and a NaN line, forward and "
          f"inverse; and a fully non-finite input); device ms on the fully "
          f"non-finite input: row 3 (511, 4096) f64 "
          f"{nf_ms['apply_axis_matmul']:.4f}, row 4 (4095, 511) f64 "
          f"{nf_ms['hier_fused_tail']:.4f}  [{card}]")
    print(f"round trips end to end (host clock; 511^3 f64 unless named): "
          + ", ".join(f"{m} {v:.2f} ms" for m, v in rt_ms.items())
          + f"; iterated prod_3d round (auto, pole): "
          + ", ".join(f"{m} {r:.2f} ms (communication {c:.2f} ms)"
                      for m, (r, c) in it_ms.items()) + f"  [{card}]")
    del cube, bundle

    # ------------------------------------------------------------------
    # Fourth path: the dense LM's serving steps at smollm_360m's full
    # width in bf16 (row 10, flash attention), random weights from a seed
    # ------------------------------------------------------------------
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import ServeConfig, generate
    from repro_torch.models import model as LM
    from repro_torch.models.transformer import init_params

    def hold_flash(got, want, label):
        """The kernel's output against its plain version's, at the
        reference kernel's bar for the type (abs and rel)."""
        tol = FLASH_TOL[str(got.dtype).removeprefix("torch.")]
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"flash_attention ({label}): {got.dtype}{tuple(got.shape)} "
                 f"against {want.dtype}{tuple(want.shape)}")
        diff = (got.float() - want.float()).abs()
        e = float(diff.max()) if diff.numel() else 0.0
        err["flash_attention"] = max(err["flash_attention"], e)
        if not bool((diff <= tol + tol * want.float().abs()).all()):
            fail(f"flash_attention differs from its plain version ({label}, "
                 f"max err {e}, bar {tol})")
        return e

    for case in FLASH_CASES:
        b, sq, skv, h, kvh, hd, causal = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (randn(s, torch.float32).to(dtype) for s in (
                (b, sq, h, hd), (b, skv, kvh, hd), (b, skv, kvh, hd)))
            hold_flash(FA.flash_attention(q, k, v, causal=causal),
                       FA.flash_attention_ref(q, k, v, causal=causal),
                       f"{case} {dtype}")
    print(f"flash_attention kernel cases: {len(FLASH_CASES)} shapes in f32 "
          f"and bf16 within the reference's bars (2e-5, 2e-2) of the plain "
          f"version; max abs err {err['flash_attention']}")

    cfg = get_config(LM_ARCH)
    model = init_params(cfg, seed=0, device=cuda)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    lm_rng = np.random.default_rng(4)
    tokens = torch.from_numpy(lm_rng.integers(0, cfg.vocab_size,
                                              PREFILL)).to(cuda)
    batch = {"tokens": tokens}
    FA.flash_attention.launches = 0
    t0 = time.perf_counter()
    with H.record_calls() as flash_calls:
        logits = LM.prefill_step(model, cfg, batch)
    torch.cuda.synchronize()
    prefill_first_ms = (time.perf_counter() - t0) * 1e3
    lm_launches = FA.flash_attention.launches
    if lm_launches != cfg.num_layers or len(flash_calls) != cfg.num_layers:
        fail(f"prefill_step launched flash_attention {lm_launches} times "
             f"({len(flash_calls)} calls), one per layer is "
             f"{cfg.num_layers}")
    if tuple(logits.shape) != PREFILL + (cfg.vocab_padded,) or \
            logits.dtype != torch.bfloat16 or \
            not bool(torch.isfinite(logits).all()):
        fail(f"prefill logits {logits.dtype}{tuple(logits.shape)} are not "
             f"finite bf16 of shape {PREFILL + (cfg.vocab_padded,)}")
    del logits
    prefill_ms = []
    resident = torch.cuda.memory_allocated()    # weights and earlier paths
    torch.cuda.reset_peak_memory_stats()
    for _ in range(PREFILL_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        LM.prefill_step(model, cfg, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    prefill_peak = torch.cuda.max_memory_allocated() - resident
    print(f"{LM_ARCH} prefill_step {PREFILL}: {lm_launches} flash_attention "
          f"launches (one per layer); first call {prefill_first_ms:.1f} ms, "
          f"warm median {float(np.median(prefill_ms)):.2f} ms "
          f"({', '.join(f'{t:.2f}' for t in prefill_ms)}); peak device "
          f"memory {prefill_peak} B above the resident state, beside "
          f"{weight_bytes} B of weights  [{card}]")
    prefill_err = {"bf16": 0.0, "f32 replay": 0.0}
    for _wrapper, args in flash_calls:       # every call of the prefill
        f32 = {**args, **{n: args[n].float() for n in "qkv"}}
        for label, a in (("bf16", args), ("f32 replay", f32)):
            prefill_err[label] = max(prefill_err[label], hold_flash(
                FA.flash_attention(**a), FA.flash_attention.plain(**a),
                f"prefill {label}"))
    flash_args = flash_calls[0][1]
    del flash_calls
    print(f"flash_attention: the prefill's {cfg.num_layers} calls within "
          f"2e-2 (bf16, on the tensor cores) and 2e-5 (f32 replay, CUDA "
          f"cores) of the plain version; max abs err {prefill_err}")

    # Cache parity at full width: prefill (the kernel) against token-by-
    # token decode (decode_attention, no kernel), both bf16.  Bar: three
    # times the bf16 prefill's own rounding error, its distance from an f32
    # prefill of the same weights; a wrong position or a stale cache entry
    # is far above it.
    ptoks = torch.from_numpy(lm_rng.integers(0, cfg.vocab_size,
                                             PARITY)).to(cuda)
    want = LM.prefill_step(model, cfg, {"tokens": ptoks}).float()
    exact = LM.prefill_step(model.float(), cfg.replace(dtype="float32"),
                            {"tokens": ptoks}).float()
    model = model.bfloat16()       # .float() converted in place
    cache = LM.init_decode_cache(cfg, PARITY[0], PARITY[1], device=cuda)
    steps = []
    for pos in range(PARITY[1]):
        lg, cache = LM.serve_step(model, cfg, cache,
                                  {"token": ptoks[:, pos:pos + 1], "pos": pos})
        steps.append(lg[:, 0].float())
    got = torch.stack(steps, dim=1)
    parity_err = float((got - want).abs().max())
    rounding = float((want - exact).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if not parity_err <= 3 * rounding:
        fail(f"decode differs from prefill by {parity_err}, above 3x the "
             f"bf16 rounding {rounding}")
    print(f"{LM_ARCH} cache parity {PARITY}: token-by-token serve_step "
          f"logits within {parity_err} of prefill_step's (bar 3 x {rounding},"
          f" the bf16 prefill's distance from f32; |logits| up to "
          f"{float(want.abs().max())}); argmax agrees on {agree:.4f} of "
          f"positions")
    del want, exact, got, cache, steps

    # Serving: generate answers a batch of requests, twice from one seed
    sc = ServeConfig(arch=LM_ARCH, smoke=False,
                     max_new_tokens=SERVE["new_tokens"])
    prompts = lm_rng.integers(0, cfg.vocab_size, (
        SERVE["requests"], SERVE["prompt"])).astype(np.int32)
    served, serve_ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served.append(generate(sc, prompts, params=model))
        serve_ms.append((time.perf_counter() - t0) * 1e3)
    toks, lps = served[0]["tokens"], served[0]["logprobs"]
    if toks.shape != (SERVE["requests"], SERVE["prompt"] + SERVE[
            "new_tokens"]) or not (toks[:, :SERVE["prompt"]] == prompts).all()\
            or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"generate returned tokens {toks.shape} that do not extend the "
             f"prompts with in-vocabulary tokens")
    if not (np.isfinite(lps).all() and (lps <= 0).all()):
        fail("generate's logprobs are not finite and <= 0")
    if not (np.array_equal(toks, served[1]["tokens"])
            and np.array_equal(lps, served[1]["logprobs"])):
        fail("two generate runs from one seed differ")
    n_steps = SERVE["prompt"] + SERVE["new_tokens"] - 1
    new_tokens = SERVE["requests"] * SERVE["new_tokens"]
    decode_cache = LM.init_decode_cache(cfg, SERVE["requests"], n_steps + 1,
                                        device=cuda)
    last = torch.from_numpy(toks[:, -1:]).to(cuda)
    decode_batch = {"token": last, "pos": n_steps}
    decode_ms = wall_clock_ms(
        lambda: LM.serve_step(model, cfg, decode_cache, decode_batch))
    print(f"{LM_ARCH} generate: {SERVE['requests']} requests of "
          f"{SERVE['prompt']} prompt tokens + {SERVE['new_tokens']} greedy "
          f"new tokens in {serve_ms[0]:.1f}, {serve_ms[1]:.1f} ms "
          f"({n_steps} serve_steps each, {serve_ms[1] / n_steps:.2f} ms a "
          f"step); {new_tokens / serve_ms[1] * 1e3:.1f} generated tokens/s, "
          f"{serve_ms[1] / SERVE['new_tokens']:.2f} ms per generated token "
          f"of a request (prompt steps included); one serve_step at position "
          f"{n_steps}: {decode_ms:.2f} ms; the two runs equal  [{card}]")

    # Row 10 at the prefill's shape: one layer's recorded call
    q, k, v = (flash_args[n] for n in "qkv")
    b, sq, h, hd = q.shape
    groups = h // k.shape[2]
    kernel = lambda: FA.flash_attention(**flash_args)
    plain = lambda: FA.flash_attention.plain(**flash_args)
    qh, kh, vh = (t.transpose(1, 2) for t in (
        q, k.repeat_interleave(groups, dim=2),
        v.repeat_interleave(groups, dim=2)))
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True)
    lib_err = max_err(library().transpose(1, 2), kernel())
    if not lib_err <= 2e-2 * max(1.0, float(q.abs().max())):
        fail(f"scaled_dot_product_attention differs from flash_attention by "
             f"{lib_err}")
    pairs = sum(min(k.shape[1], i + 1) for i in range(sq))   # causal
    flops = 4 * b * h * hd * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_FLOP_PER_S * 1e3
    ms = device_ms(kernel, only="flash_kernel", launches=1)
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:38",
        "launches": lm_launches, "max_abs_err": err["flash_attention"],
        "ms": ms, "plain_ms": device_ms(plain),
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": device_ms(library),
        "wrapper_ms": wall_ms(kernel), "plain_wrapper_ms": wall_ms(plain)})
    r = rows[-1]
    print(f"flash_attention: device {ms:.4f} ms per call at ({b}x{h}, {sq}, "
          f"{hd}) bf16 causal ({lm_launches} launches per prefill_step, "
          f"{flops / ms / 1e9:.1f} TFLOP/s), bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']} ({flops} flop at 989 TFLOP/s, {nbytes} B at 3.35 "
          f"TB/s); plain {r['plain_ms']:.4f} ms; library "
          f"(scaled_dot_product_attention, K/V broadcast to {h} heads) "
          f"{r['library_ms']:.4f} ms (max abs diff {lib_err}); with host "
          f"dispatch: kernel {r['wrapper_ms']:.4f} ms, plain "
          f"{r['plain_wrapper_ms']:.4f} ms  [{card}]")
    del q, k, v, qh, kh, vh, flash_args

    # ------------------------------------------------------------------
    # Fifth path: dense LM training at smollm_360m's full width in bf16
    # (row 10's forward with its log-sum-exp and its backward kernels),
    # random weights from a seed
    # ------------------------------------------------------------------
    import hashlib
    import math

    import repro_torch.launch.train as TR
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import steps as ST
    from repro_torch.models import attention as ATT
    from repro_torch.models.transformer import loss_fn as lm_loss
    from repro_torch.optim.compression import (compress_with_feedback,
                                               init_error_feedback)

    phase_t0 = time.perf_counter()
    tgen = torch.Generator(device=cuda)
    tgen.manual_seed(24)

    def trandn(shape, dtype):
        return torch.randn(shape, generator=tgen, device=cuda).to(dtype)

    def bar(got, want, rtol, atol):
        """max |got - want| and whether every element is within atol +
        rtol |want|."""
        diff = (got.float() - want.float()).abs()
        return float(diff.max()), bool(
            (diff <= atol + rtol * want.float().abs()).all())

    def bwd_bar(got, want, tol):
        """(max |got - want|, relative L2, RMS of want, pass) under a
        ``BWD_TOL`` entry."""
        w = want.float()
        diff = (got.float() - w).abs()
        rms = float(w.square().mean().sqrt())
        rel = float(diff.norm() / w.norm().clamp_min(1e-30))
        ok = rel <= tol["rel_l2"] and bool((diff <= tol["atol"] + tol[
            "atol_rms"] * rms + tol["rtol"] * w.abs()).all())
        return float(diff.max()), rel, rms, ok

    err["flash_attention_lse"] = err["flash_attention_bwd"] = 0.0
    bwd_args, bwd_rel, bwd_seen = None, {}, {}
    for case in BWD_CASES:
        b, sq, skv, h, kvh, hd, causal, q_offset = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (trandn(s_, dtype) for s_ in (
                (b, sq, h, hd), (b, skv, kvh, hd), (b, skv, kvh, hd),
                (b, sq, h, hd)))
            kw = dict(causal=causal, q_offset=q_offset)
            # the training call: with the bf16 output's residual
            o, lse, lo = FA.flash_attention_lse(q, k, v, **kw)
            if not torch.equal(o, FA.flash_attention(q, k, v, **kw)):
                fail(f"flash_attention_lse's output is not bitwise "
                     f"flash_attention's ({case} {dtype})")
            e, ok = bar(lse, FA.flash_attention_lse_ref(q, k, v, **kw)[1],
                        1e-4, 1e-4)
            err["flash_attention_lse"] = max(err["flash_attention_lse"], e)
            if not ok or lse.dtype != torch.float32:
                fail(f"flash_attention_lse's log-sum-exp differs from the "
                     f"plain logsumexp by {e} ({case} {dtype})")
            got = FA.flash_attention_bwd(q, k, v, o, lse, do, o_lo=lo, **kw)
            want = FA.flash_attention_bwd_ref(q, k, v, o, lse, do, o_lo=lo,
                                              **kw)
            dname = str(dtype).removeprefix("torch.")
            tol = BWD_TOL[dname]
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                e, rel, rms, ok = bwd_bar(g, w, tol)
                err["flash_attention_bwd"] = max(err["flash_attention_bwd"],
                                                 e)
                bwd_rel[dname] = max(bwd_rel.get(dname, 0.0), rel)
                if case == BWD_CASES[0]:
                    bwd_seen[dname, name] = (rms, rel, e)
                if not ok or g.dtype != w.dtype or g.shape != w.shape:
                    fail(f"flash_attention_bwd's {name} differs from its "
                         f"plain version by {e}, relative L2 {rel} (RMS "
                         f"{rms}; {case} {dtype}; bar {tol})")
            if case == BWD_CASES[0] and dtype == torch.bfloat16:
                bwd_args = dict(q=q, k=k, v=v, o=o, lse=lse, do=do, o_lo=lo,
                                **kw)
                again = FA.flash_attention_bwd(**bwd_args)
                if not all(torch.equal(a_, g_) for a_, g_ in zip(again, got)):
                    fail("flash_attention_bwd: two bf16 calls on the same "
                         "inputs differ")
                del again
                # The bar's reach: the kernels' result with one tile pair
                # (the last query tile against the key tile before it)
                # dropped or doubled in every (batch, head) must fail it.
                qt, kt = slice(sq - 64, sq), slice(sq - 128, sq - 64)
                tile_part = FA.flash_attention_bwd_ref(
                    q[:, qt], k[:, kt], v[:, kt], o[:, qt], lse[..., qt],
                    do[:, qt], causal=True, q_offset=64, o_lo=lo[:, qt])
                for sign in (-1.0, 1.0):
                    for name, g, w, span, piece in zip(
                            ("dq", "dk", "dv"), got, want, (qt, kt, kt),
                            tile_part):
                        mutated = g.clone()
                        mutated[:, span] = (mutated[:, span].float()
                                            + sign * piece.float()).to(dtype)
                        if bwd_bar(mutated, w, tol)[3]:
                            fail(f"the bf16 backward's bar passes {name} "
                                 f"with one tile pair "
                                 f"{'dropped' if sign < 0 else 'doubled'}")
                del tile_part, mutated
            del q, k, v, do, o, lse, lo, got, want
    print(f"flash_attention_bwd: {len(BWD_CASES)} cases (the training shape "
          f"{BWD_CASES[0][:6]} causal, ragged full and causal with q_offset, "
          f"head_dim 20 padded to 24) "
          f"in f32 and bf16 within {BWD_TOL} of the plain version; max abs "
          f"err {err['flash_attention_bwd']}, worst relative L2 {bwd_rel}; "
          f"at the training shape (RMS of the plain result, relative L2, max"
          f" abs err): "
          + "; ".join(f"{d} {n} {r:.4g}, {rl:.3g}, {e:.4g}"
                      for (d, n), (r, rl, e) in bwd_seen.items())
          + f"; the bf16 bar refuses one 64 x 64 tile pair dropped or "
          f"doubled in dq, dk and dv; two bf16 calls bitwise equal; the "
          f"log-sum-exp within 1e-4 of the "
          f"plain logsumexp (max abs err {err['flash_attention_lse']}), the "
          f"output with it bitwise the output without it")

    # One step at full width and depth 2: the kernels against row 10 routed
    # through its plain version (autograd through flash_attention_ref).
    def plain_attention(q, k, v, *, causal=True, q_offset=0):
        return FA.flash_attention_ref(q, k, v, causal=causal,
                                      q_offset=q_offset)

    def rel_l2(a, b) -> float:
        return float(torch.linalg.vector_norm((a.float() - b.float()))
                     / torch.linalg.vector_norm(b.float()).clamp_min(1e-30))

    grad_rel = {}
    for dtype in ("float32", "bfloat16"):
        gcfg = get_config(LM_ARCH).replace(
            num_layers=GRAD_CHECK["num_layers"], dtype=dtype)
        gbatch = SyntheticLM(DataConfig(
            vocab_size=gcfg.vocab_size, seq_len=GRAD_CHECK["seq_len"],
            global_batch=GRAD_CHECK["global_batch"], seed=1),
            device=cuda).batch(0)
        runs = []
        for attention in (ATT.flash_attention, plain_attention):
            gparams, gopt = ST.init_train_state(gcfg, seed=1, device=cuda)
            ATT.flash_attention = attention
            try:
                loss, grads = ST.loss_and_grads(gparams, gcfg, gbatch)
                ST.make_train_step(gcfg, lambda s_: torch.tensor(1e-3))(
                    gparams, gopt, gbatch)
            finally:
                ATT.flash_attention = FA.flash_attention
            runs.append((float(loss), grads,
                         {n: p.detach() for n, p in
                          gparams.named_parameters()}))
        (lk, gk, pk), (lp, gp, pp) = runs
        worst = max((rel_l2(gk[n], gp[n]), n) for n in gk)
        worst_p = max((rel_l2(pk[n], pp[n]), n) for n in pk)
        grad_rel[dtype] = (worst, worst_p, abs(lk - lp))
        if not (worst[0] <= GRAD_TOL[dtype] and worst_p[0] <= GRAD_TOL[dtype]
                and math.isfinite(lk)):
            fail(f"the {dtype} train step with row 10's kernels differs from "
                 f"the one through its plain version: worst gradient "
                 f"{worst}, worst parameter {worst_p} (per-leaf relative L2;"
                 f" bar {GRAD_TOL[dtype]}), losses {lk}, {lp}")
        del runs, gk, gp, pk, pp, gparams, gopt, grads
    print(f"{LM_ARCH} gradient check (depth {GRAD_CHECK['num_layers']}, "
          f"{GRAD_CHECK['global_batch']} x {GRAD_CHECK['seq_len']} tokens): "
          f"kernels against row 10's plain version, per-leaf relative L2 "
          + "; ".join(f"{d}: worst gradient {g[1]} {g[0]:.3e}, worst "
                      f"updated parameter {p_[1]} {p_[0]:.3e}, |loss diff| "
                      f"{dl:.3e}" for d, (g, p_, dl) in grad_rel.items())
          + f" (bars {GRAD_TOL})")

    # The main path: train() at full width, its counts set to 0 just before.
    def leaf_sha256(t) -> str:
        t = t.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return hashlib.sha256(t.numpy().tobytes()).hexdigest()

    ckpt_log = {"save": {}, "restore": {}}
    step_log = []
    real_save, real_restore = TR.save_checkpoint, TR.restore_checkpoint
    real_make_step = TR.make_train_step

    def spy_save(directory, step, tree, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_save(directory, step, tree, **kw)
        ms = (time.perf_counter() - t0) * 1e3
        ckpt_log["save"][step] = (ms, {n: leaf_sha256(t)
                                       for n, t in tree[0].items()})
        return out

    def spy_restore(directory, step, template, **kw):
        t0 = time.perf_counter()
        out = real_restore(directory, step, template, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ckpt_log["restore"][step] = (ms, {n: leaf_sha256(t)
                                          for n, t in out[0][0].items()})
        return out

    def timed_make_step(*a, **kw):
        inner = real_make_step(*a, **kw)

        def step(params, opt, batch):
            before = (FA.flash_attention.launches,
                      FA.flash_attention_lse.launches,
                      FA.flash_attention_bwd.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(params, opt, batch)
            torch.cuda.synchronize()
            step_log.append(((time.perf_counter() - t0) * 1e3, tuple(
                n - b0 for n, b0 in zip((FA.flash_attention.launches,
                                         FA.flash_attention_lse.launches,
                                         FA.flash_attention_bwd.launches),
                                        before))))
            return out
        return step

    with tempfile.TemporaryDirectory(prefix="lm-train-") as ckdir:
        free = shutil.disk_usage(ckdir).free
        tc = TR.TrainConfig(arch=LM_ARCH, smoke=False, checkpoint_dir=ckdir,
                            device="cuda", **TRAIN)
        tcfg = TR.model_config(tc)
        if not (tcfg.remat and tcfg.remat_policy == "full"):
            fail(f"{LM_ARCH}'s published config trains with remat "
                 f"{tcfg.remat} {tcfg.remat_policy!r}, not 'full'")
        TR.save_checkpoint, TR.restore_checkpoint = spy_save, spy_restore
        TR.make_train_step = timed_make_step
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        FA.flash_attention.launches = 0
        FA.flash_attention_lse.launches = 0
        FA.flash_attention_bwd.launches = 0
        t0 = time.perf_counter()
        try:
            res = TR.train(tc)
        finally:
            TR.save_checkpoint, TR.restore_checkpoint = real_save, real_restore
            TR.make_train_step = real_make_step
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = {"flash_attention": FA.flash_attention.launches,
                          "flash_attention_lse":
                              FA.flash_attention_lse.launches,
                          "flash_attention_bwd":
                              FA.flash_attention_bwd.launches}
        train_peak = torch.cuda.max_memory_allocated()
        ckpt_bytes = sum(f.stat().st_size for f in Path(ckdir).rglob("*")
                         if f.is_file())
    layers = tcfg.num_layers
    losses = [res.losses[s_] for s_ in sorted(res.losses)]
    # The stream's labels are near uniform at this vocabulary (its one
    # learnable structure, a 49152-entry permutation, is seen about 0.17
    # times a token a batch), so over 6 steps the loss of each new batch
    # stays near ln(49152) + 0.19; each step still descends on its own
    # batch.  The trained model's loss on the last step's batch and on the
    # first (what the steps learned across batches):
    stream = SyntheticLM(DataConfig(
        vocab_size=tcfg.vocab_size, seq_len=TRAIN["seq_len"],
        global_batch=TRAIN["global_batch"]), device=cuda)
    last_batch = stream.batch(sorted(res.losses)[-1])
    first_batch = stream.batch(0)
    with torch.no_grad():
        trained_loss = float(lm_loss(res.params, tcfg, last_batch))
        trained_first = float(lm_loss(res.params, tcfg, first_batch))
    step_ms = [ms for ms, _ in step_log]
    warm_ms = float(np.median(step_ms[1:])) if len(step_ms) > 1 else 0.0
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    save_ms = [v[0] for _, v in sorted(ckpt_log["save"].items())]
    restore_ms = [v[0] for _, v in sorted(ckpt_log["restore"].items())]
    print(f"{LM_ARCH} train (bf16, remat full, {TRAIN['global_batch']} x "
          f"{TRAIN['seq_len']} tokens, 6 steps, NaN at step 3): losses "
          + ", ".join(f"{s_}: {res.losses[s_]:.4f}" for s_ in
                      sorted(res.losses))
          + f"; the trained model on the last step's batch {trained_loss:.4f}"
          f", on the first step's batch {trained_first:.4f}"
          f"; rollbacks {res.rollbacks}; launches {train_launches} (per "
          f"step: {[c for _, c in step_log]}, as (no lse, lse, backward)); "
          f"step times " + ", ".join(f"{t:.1f}" for t in step_ms)
          + f" ms (warm median {warm_ms:.1f} ms, {tokens / warm_ms * 1e3:.0f}"
          f" tokens/s); train() {train_s:.1f} s; peak device memory "
          f"{train_peak} B ({train_peak - resident} B above the "
          f"{resident} B resident before it); checkpoints {ckpt_bytes} B "
          f"on disk for {len(save_ms)} saves (free before {free} B), save "
          + ", ".join(f"{t:.0f}" for t in save_ms)
          + f" ms, restore " + ", ".join(f"{t:.0f}" for t in restore_ms)
          + f" ms  [{card}]")
    if sorted(res.losses) != [0, 1, 2, 4, 5] or res.final_step != 6 \
            or res.rollbacks != 1 \
            or not any("non-finite" in e for e in res.events):
        fail(f"train: steps {sorted(res.losses)}, final {res.final_step}, "
             f"rollbacks {res.rollbacks}, events {res.events}; expected "
             f"one rollback from the poisoned step 3 to step 2")
    if not all(math.isfinite(x) for x in losses + [trained_loss,
                                                    trained_first]):
        fail(f"train: non-finite losses {res.losses}, {trained_loss}, "
             f"{trained_first}")
    # near-uniform logits over the padded vocabulary at random init
    if not abs(losses[0] - math.log(tcfg.vocab_padded)) <= 1.0:
        fail(f"train: first loss {losses[0]}, not within 1 of "
             f"ln({tcfg.vocab_padded}) = {math.log(tcfg.vocab_padded):.3f}")
    if not trained_loss < min(losses[0], losses[-1]):
        fail(f"train: the trained model's loss on the last step's batch "
             f"{trained_loss} is not below the first loss {losses[0]} and "
             f"that batch's loss before its step {losses[-1]}")
    if not trained_first < losses[0]:
        fail(f"train: the trained model's loss on the first step's batch "
             f"{trained_first} is not below its loss there before the "
             f"first step {losses[0]}")
    if list(ckpt_log["restore"]) != [2] or sorted(ckpt_log["save"]) != [2, 6]:
        fail(f"train: saves {sorted(ckpt_log['save'])}, restores "
             f"{list(ckpt_log['restore'])}")
    if ckpt_log["restore"][2][1] != ckpt_log["save"][2][1]:
        bad = [n for n, h_ in ckpt_log["save"][2][1].items()
               if ckpt_log["restore"][2][1].get(n) != h_]
        fail(f"train: the rollback restored parameters other than those "
             f"saved at step 2: {bad[:5]}")
    per_step = {(0, 2 * layers, 2 * layers)}     # no lse, lse, backward
    if len(step_log) != 6 or {c for _, c in step_log} != per_step \
            or train_launches["flash_attention_lse"] != 6 * 2 * layers \
            or train_launches["flash_attention_bwd"] != 6 * 2 * layers \
            or train_launches["flash_attention"]:
        fail(f"train: row 10's launches per step (no lse, lse, backward) "
             f"{[c for _, c in step_log]}, in all {train_launches}; "
             f"predicted {2 * layers} forwards with the log-sum-exp "
             f"(forward and recompute), {layers} backward pairs and none "
             f"without it, in each of 6 steps")
    print(f"{LM_ARCH} train: one rollback to step 2, the restored "
          f"parameters bitwise those saved (sha256 of "
          f"{len(ckpt_log['save'][2][1])} leaves); {2 * layers} lse "
          f"forwards and {layers} backward pairs in each of 6 steps  "
          f"[{card}]")
    del last_batch, first_batch, stream

    # Where a step's time goes: one more step of the trained state under
    # the profiler, and the host's synthetic batch alone.
    model_t = res.params
    data_t = SyntheticLM(DataConfig(vocab_size=tcfg.vocab_size,
                                    seq_len=TRAIN["seq_len"],
                                    global_batch=TRAIN["global_batch"]),
                         device=cuda)
    t0 = time.perf_counter()
    tbatch = data_t.batch(7)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    one_step = ST.make_train_step(tcfg, lambda s_: torch.tensor(1e-4))
    profiled(f"{LM_ARCH} train step ({TRAIN['global_batch']} x "
             f"{TRAIN['seq_len']} tokens, bf16, remat full; the host's "
             f"synthetic batch {batch_ms:.1f} ms not included)",
             lambda: one_step(model_t, res.opt_state, tbatch))

    # The gradient codec on one full-width step's gradients: rows 1 and 2.
    _, tgrads = ST.loss_and_grads(model_t, tcfg, tbatch)
    H.hier_pole.launches = H.dehier_pole.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    approx, ef = compress_with_feedback(tgrads, init_error_feedback(tgrads),
                                        codec="hier", frac=1.0)
    torch.cuda.synchronize()
    codec_ms = (time.perf_counter() - t0) * 1e3
    codec_launches = (H.hier_pole.launches, H.dehier_pole.launches)
    if codec_launches != (len(tgrads), len(tgrads)):
        fail(f"compress_with_feedback(hier) launched rows 1 and 2 "
             f"{codec_launches} times for {len(tgrads)} gradient leaves")
    codec_err = 0.0
    for n, g in tgrads.items():
        e, ok = bar(approx[n], g, 1e-4, 1e-5)
        codec_err = max(codec_err, e)
        if not ok:
            fail(f"the hier codec's decode at truncation 0 differs from "
                 f"the gradient {n} by {e} (bar rtol 1e-4, atol 1e-5)")
    print(f"{LM_ARCH} gradient codec (hier, level 8, truncation 0) on one "
          f"step's {len(tgrads)} bf16 gradient leaves "
          f"({sum(g.numel() for g in tgrads.values())} values): "
          f"{codec_launches[0]} hier_pole and {codec_launches[1]} "
          f"dehier_pole launches, decode within {codec_err} of the input "
          f"(bar rtol 1e-4, atol 1e-5), {codec_ms:.1f} ms  [{card}]")
    del approx, ef, tgrads, tbatch, res, model_t

    # Rows "10 lse" and "10 bwd" at the training shape, one layer's call.
    q, k, v, o, lse, do = (bwd_args[n] for n in ("q", "k", "v", "o", "lse",
                                                 "do"))
    b, sq, h, hd = q.shape
    groups = h // k.shape[2]
    pairs = sum(min(k.shape[1], i + 1) for i in range(sq))     # causal
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (
        q, k.repeat_interleave(groups, dim=2),
        v.repeat_interleave(groups, dim=2)))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True)
    doh = do.transpose(1, 2)

    def lib_fwd():
        return torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                   retain_graph=True)

    lib_grads = lib_bwd()
    kern_grads = FA.flash_attention_bwd(**bwd_args)
    lib_err = max_err(lib_grads[0].transpose(1, 2), kern_grads[0])
    fwd_args = {n: bwd_args[n] for n in ("q", "k", "v", "causal",
                                         "q_offset")}
    esz = q.element_size()
    lib_label = {"flash_attention_lse": "forward recording its backward",
                 "flash_attention_bwd": "backward"}
    no_lse_ms = device_ms(lambda: FA.flash_attention(**fwd_args),
                          only="flash_kernel", launches=1)
    # as training calls them: the output's residual written, then read
    for name, flop_mult, nbytes, kern, plain, lib, only, calls_launch in (
            ("flash_attention_lse", 4,
             (3 * q.numel() + k.numel() + v.numel()) * esz + lse.numel() * 4,
             lambda: FA.flash_attention_lse(**fwd_args),
             lambda: FA.flash_attention_lse.plain(**fwd_args),
             lib_fwd, "flash_kernel", 1),
            ("flash_attention_bwd", 10,
             (5 * q.numel() + 2 * k.numel() + 2 * v.numel()) * esz
             + lse.numel() * 4,
             lambda: FA.flash_attention_bwd(**bwd_args),
             lambda: FA.flash_attention_bwd.plain(**bwd_args), lib_bwd,
             ("bwd_dkdv_wgmma", "bwd_dq_wgmma"), 2)):
        flops = flop_mult * b * h * hd * pairs
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / BF16_FLOP_PER_S * 1e3
        ms = device_ms(kern, only=only, launches=calls_launch)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + (
                "flash_attention.cu" if name.endswith("lse")
                else "flash_attention_bwd.cu"),
            "replaces": "src/repro/kernels/flash_attention.py:38" if
            name.endswith("lse") else
            "src/repro/models/attention.py:42 (JAX autodiff of "
            "attention_chunked; no TPU kernel)",
            "launches": train_launches[name], "max_abs_err": err[name],
            "ms": ms, "plain_ms": device_ms(plain),
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": device_ms(lib), "events_ms": events_ms(kern),
            "library_events_ms": events_ms(lib),
            "wrapper_ms": wall_ms(kern), "plain_wrapper_ms": wall_ms(plain)})
        r = rows[-1]
        print(f"{name}: device {ms:.4f} ms per call at ({b}x{h}, {sq}, {hd})"
              f" bf16 causal ({r['launches']} launches in the 6 train steps,"
              f" {flops / ms / 1e9:.1f} TFLOP/s); CUDA events over "
              f"{TIMING_REPS} back-to-back calls {r['events_ms']:.4f} ms "
              f"(library {r['library_events_ms']:.4f}); bound "
              f"{r['bound_ms']:.4f} "
              f"ms by {r['bound_by']} ({flops} flop at 989 TFLOP/s, {nbytes} "
              f"B at 3.35 TB/s); plain {r['plain_ms']:.4f} ms; library "
              f"(scaled_dot_product_attention {lib_label[name]}"
              f", K/V broadcast to {h} heads) {r['library_ms']:.4f} ms; with "
              f"host dispatch: kernel {r['wrapper_ms']:.4f} ms, plain "
              f"{r['plain_wrapper_ms']:.4f} ms  [{card}]")
    print(f"flash_attention_bwd: SDPA's dq differs from the kernel's by "
          f"{lib_err} (bf16); row 10 without the log-sum-exp on the same "
          f"inputs {no_lse_ms:.4f} ms; training phase {time.perf_counter() - phase_t0:.1f} s  "
          f"[{card}]")
    del q, k, v, o, lse, do, qh, kh, vh, doh, lib_out, lib_grads, kern_grads
    del bwd_args, fwd_args
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # Sixth path: the encoder-decoder and vision-language families in bf16,
    # random weights from a seed: whisper_small at full width and depth
    # (row 10 full over 1500 stub frames in the encoder, causal in the
    # decoder, full cross-attention of 448 queries over 1500 keys), then
    # llava_next_34b at full width cut to VLM_LAYERS of its 60 layers
    # (causal over 576 patches and the text, head_dim 128, GQA 7:1)
    # ------------------------------------------------------------------
    from repro_torch.launch.train import stub_frontends

    phase_t0 = time.perf_counter()
    wcfg = get_config(ENCDEC_ARCH)
    wmodel = init_params(wcfg, seed=0, device=cuda)
    wgen = torch.Generator(device=cuda)
    wgen.manual_seed(26)

    def stub_audio(b):
        return (torch.randn((b, wcfg.encoder_seq, wcfg.d_model),
                            generator=wgen, device=cuda) * 0.02).to(
            torch.bfloat16)

    def attention_kind(args):
        """encoder (full, Sq = Skv), self (causal) or cross (full, Sq !=
        Skv): the three places the whisper prefill calls row 10."""
        if args["causal"]:
            return "self"
        return "encoder" if args["q"].shape[1] == args["k"].shape[1] \
            else "cross"

    torch.cuda.synchronize()
    wweight_bytes = sum(p.numel() * p.element_size()
                        for p in wmodel.parameters())
    wb, wtext = ENCDEC_PREFILL
    wbatch = {"tokens": torch.randint(0, wcfg.vocab_size, ENCDEC_PREFILL,
                                      generator=wgen, device=cuda),
              "audio_embeds": stub_audio(wb)}
    FA.flash_attention.launches = 0
    t0 = time.perf_counter()
    with H.record_calls() as wcalls:
        wlogits = LM.prefill_step(wmodel, wcfg, wbatch)
    torch.cuda.synchronize()
    wfirst_ms = (time.perf_counter() - t0) * 1e3
    wlaunches = FA.flash_attention.launches
    kinds = [attention_kind(a) for _, a in wcalls]
    want_kinds = {"encoder": wcfg.encoder_layers, "self": wcfg.num_layers,
                  "cross": wcfg.num_layers}
    if wlaunches != sum(want_kinds.values()) or len(wcalls) != wlaunches \
            or {k: kinds.count(k) for k in want_kinds} != want_kinds:
        fail(f"{ENCDEC_ARCH} prefill_step launched flash_attention "
             f"{wlaunches} times ({len(wcalls)} calls: "
             f"{ {k: kinds.count(k) for k in want_kinds} }), expected "
             f"{want_kinds}")
    if tuple(wlogits.shape) != ENCDEC_PREFILL + (wcfg.vocab_padded,) or \
            wlogits.dtype != torch.bfloat16 or \
            not bool(torch.isfinite(wlogits).all()):
        fail(f"{ENCDEC_ARCH} prefill logits {wlogits.dtype}"
             f"{tuple(wlogits.shape)} are not finite bf16 of shape "
             f"{ENCDEC_PREFILL + (wcfg.vocab_padded,)}")
    del wlogits
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wprefill_ms = []
    for _ in range(PREFILL_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        LM.prefill_step(wmodel, wcfg, wbatch)
        torch.cuda.synchronize()
        wprefill_ms.append((time.perf_counter() - t0) * 1e3)
    wpeak = torch.cuda.max_memory_allocated() - resident
    print(f"{ENCDEC_ARCH} prefill_step {wb} x {wtext} tokens over {wb} x "
          f"{wcfg.encoder_seq} stub frames ({wcfg.encoder_layers} + "
          f"{wcfg.num_layers} layers, d {wcfg.d_model}, {wcfg.num_heads} "
          f"heads of {wcfg.resolved_head_dim}): {wlaunches} flash_attention "
          f"launches ({', '.join(f'{k} {n}' for k, n in want_kinds.items())}"
          f"); first call {wfirst_ms:.1f} ms, warm median "
          f"{float(np.median(wprefill_ms)):.2f} ms ("
          f"{', '.join(f'{t:.2f}' for t in wprefill_ms)}); peak device "
          f"memory {wpeak} B above the resident state, beside "
          f"{wweight_bytes} B of weights  [{card}]")
    werr, wrel = {}, {}
    for (_w, args), kind in zip(wcalls, kinds):   # every call, both types
        f32 = {**args, **{n: args[n].float() for n in "qkv"}}
        for label, a in (("bf16", args), ("f32 replay", f32)):
            got, want = FA.flash_attention(**a), FA.flash_attention.plain(**a)
            e = hold_flash(got, want, f"{ENCDEC_ARCH} prefill {kind} {label}")
            werr[kind, label] = max(werr.get((kind, label), 0.0), e)
            if label == "bf16":   # and as a whole: a small uniform error
                rel = rel_l2(got, want)       # passes the element bar
                wrel[kind] = max(wrel.get(kind, 0.0), rel)
                if not rel <= FLASH_REL_L2:
                    fail(f"flash_attention ({ENCDEC_ARCH} prefill {kind} "
                         f"bf16) is {rel} from its plain version in relative"
                         f" L2 (bar {FLASH_REL_L2})")
            del got, want
    shape_args = {k: next(a for (_w, a), k2 in zip(wcalls, kinds) if k2 == k)
                  for k in ("encoder", "cross")}
    del wcalls
    # The whole-output bar's reach: the cross call's plain output with the
    # keys' tail padded with zeros to 1536 (whole 64- and 128-key tiles)
    # and let through the mask (the fault the ragged keys could hide) must
    # fail it.
    a = shape_args["cross"]
    pad = -a["k"].shape[1] % 64
    leaky = FA.flash_attention.plain(**{**a, **{
        n: torch.nn.functional.pad(a[n], (0, 0, 0, 0, 0, pad))
        for n in "kv"}})
    plain_c = FA.flash_attention.plain(**a).float()
    leak_rel = rel_l2(leaky, plain_c)
    tol = FLASH_TOL["bfloat16"]
    leak_elem = bool(((leaky.float() - plain_c).abs()
                      <= tol + tol * plain_c.abs()).all())
    if not leak_rel > FLASH_REL_L2:
        fail(f"the relative-L2 bar {FLASH_REL_L2} lets through the cross "
             f"call with {pad} zero keys unmasked ({leak_rel})")
    del leaky, plain_c
    print(f"flash_attention: the {ENCDEC_ARCH} prefill's {wlaunches} calls "
          f"within 2e-2 (bf16) and 2e-5 (f32 replay) of the plain version; "
          f"max abs err by kind: "
          + ", ".join(f"{k} {lb} {e:.3g}" for (k, lb), e in werr.items())
          + f"; bf16 relative L2 by kind (bar {FLASH_REL_L2}): "
          + ", ".join(f"{k} {r_:.3e}" for k, r_ in wrel.items())
          + f"; the cross call with its {pad} padded keys unmasked reads "
          f"{leak_rel:.3e}, refused (the element bar alone "
          f"{'lets it through' if leak_elem else 'refuses it too'})")

    # Cache parity: prefill against token-by-token serve_step over
    # encode_for_decode's cross cache, bf16; the bar as the dense phase's.
    pb, pt = ENCDEC_PARITY
    ptoks = torch.randint(0, wcfg.vocab_size, ENCDEC_PARITY, generator=wgen,
                          device=cuda)
    paudio = stub_audio(pb)
    pbatch = {"tokens": ptoks, "audio_embeds": paudio}
    want = LM.prefill_step(wmodel, wcfg, pbatch).float()
    exact = LM.prefill_step(wmodel.float(), wcfg.replace(dtype="float32"), {
        "tokens": ptoks, "audio_embeds": paudio.float()}).float()
    wmodel = wmodel.bfloat16()       # .float() converted in place
    cache = LM.init_decode_cache(wcfg, pb, pt, device=cuda)
    cache["cross"] = LM.encode_for_decode(wmodel, wcfg, paudio)
    steps = []
    for pos in range(pt):
        lg, cache = LM.serve_step(wmodel, wcfg, cache,
                                  {"token": ptoks[:, pos:pos + 1], "pos": pos})
        steps.append(lg[:, 0].float())
    got = torch.stack(steps, dim=1)
    wparity = float((got - want).abs().max())
    wrounding = float((want - exact).abs().max())
    wagree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if not wparity <= 3 * wrounding:
        fail(f"{ENCDEC_ARCH} decode differs from prefill by {wparity}, above "
             f"3x the bf16 rounding {wrounding}")
    print(f"{ENCDEC_ARCH} cache parity {ENCDEC_PARITY}: token-by-token "
          f"serve_step logits over encode_for_decode's cross cache within "
          f"{wparity} of prefill_step's (bar 3 x {wrounding}, the bf16 "
          f"prefill's distance from f32); argmax agrees on {wagree:.4f} of "
          f"positions")
    del want, exact, got, cache, steps, pbatch

    # generate: the stub audio drawn and encoded once, then token by token
    wsc = ServeConfig(arch=ENCDEC_ARCH, smoke=False,
                      max_new_tokens=ENCDEC_SERVE["new_tokens"])
    wprompts = lm_rng.integers(0, wcfg.vocab_size, (
        ENCDEC_SERVE["requests"], ENCDEC_SERVE["prompt"])).astype(np.int32)
    wserved, wserve_ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wserved.append(generate(wsc, wprompts, params=wmodel))
        wserve_ms.append((time.perf_counter() - t0) * 1e3)
    toks = wserved[0]["tokens"]
    if toks.shape != (ENCDEC_SERVE["requests"], ENCDEC_SERVE["prompt"]
                      + ENCDEC_SERVE["new_tokens"]) \
            or not (toks[:, :ENCDEC_SERVE["prompt"]] == wprompts).all() \
            or not ((toks >= 0) & (toks < wcfg.vocab_size)).all() \
            or not np.isfinite(wserved[0]["logprobs"]).all():
        fail(f"{ENCDEC_ARCH} generate returned tokens {toks.shape} that do "
             f"not extend the prompts with in-vocabulary tokens, or "
             f"non-finite logprobs")
    if not (np.array_equal(toks, wserved[1]["tokens"]) and np.array_equal(
            wserved[0]["logprobs"], wserved[1]["logprobs"])):
        fail(f"two {ENCDEC_ARCH} generate runs from one seed differ")
    wn_steps = ENCDEC_SERVE["prompt"] + ENCDEC_SERVE["new_tokens"] - 1
    wnew = ENCDEC_SERVE["requests"] * ENCDEC_SERVE["new_tokens"]
    print(f"{ENCDEC_ARCH} generate: {ENCDEC_SERVE['requests']} requests of "
          f"{ENCDEC_SERVE['prompt']} prompt tokens + "
          f"{ENCDEC_SERVE['new_tokens']} greedy new tokens over "
          f"{wcfg.encoder_seq} stub frames in {wserve_ms[0]:.1f}, "
          f"{wserve_ms[1]:.1f} ms (the encoder once, then {wn_steps} "
          f"serve_steps, {wserve_ms[1] / wn_steps:.2f} ms a step); "
          f"{wnew / wserve_ms[1] * 1e3:.1f} generated tokens/s; the two runs "
          f"equal  [{card}]")

    # Row 10 at the encoder's shape and the cross shape, by CUDA events,
    # beside scaled_dot_product_attention (a yardstick the port never calls)
    shape_rows = {}
    for kind, args in shape_args.items():
        q, k, v = (args[n] for n in "qkv")
        b, sq, h, hd = q.shape
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # H = KV here
        kernel = lambda: FA.flash_attention(**args)
        plain = lambda: FA.flash_attention.plain(**args)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh)
        lib_err = max_err(library().transpose(1, 2), kernel())
        if not lib_err <= 2e-2 * max(1.0, float(q.abs().max())):
            fail(f"scaled_dot_product_attention differs from flash_attention "
                 f"by {lib_err} at the {kind} shape")
        flops = 4 * b * h * hd * sq * k.shape[1]                # full
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / BF16_FLOP_PER_S * 1e3
        ms = events_ms(kernel)
        shape_rows[kind] = {
            "shape": [b * h, sq, k.shape[1], hd], "events_ms": ms,
            "plain_events_ms": events_ms(plain),
            "library_events_ms": events_ms(library),
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
        r = shape_rows[kind]
        print(f"flash_attention at the {ENCDEC_ARCH} {kind} shape ({b}x{h}, "
              f"{sq} queries over {k.shape[1]} keys, {hd}) bf16 full: CUDA "
              f"events over {TIMING_REPS} back-to-back calls {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s); bound {r['bound_ms']:.4f} "
              f"ms by {r['bound_by']} ({flops} flop at 989 TFLOP/s, {nbytes} "
              f"B at 3.35 TB/s); library (scaled_dot_product_attention) "
              f"{r['library_events_ms']:.4f} ms (max abs diff {lib_err}); "
              f"plain {r['plain_events_ms']:.4f} ms  [{card}]")
        del q, k, v, qh, kh, vh
    del shape_args

    # A train step at full width and depth 2 + 2, the kernels (row 10's
    # forward with its log-sum-exp and residual, and its backward, full over
    # the frames and 448 x 1500 across) against row 10 through its plain
    # version.  In bf16 the worst leaves are also held beside the f32
    # gradient of the same weights (plain attention), with SDPA's flash
    # attention (a yardstick the port never calls) for scale: a record.
    def sdpa_attention(q, k, v, *, causal=True, q_offset=0):
        if q_offset:
            raise ValueError("the yardstick takes q_offset 0 only")
        g = q.shape[2] // k.shape[2]
        qh, kh, vh = (t.transpose(1, 2) for t in (
            q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
        with torch.nn.attention.sdpa_kernel(
                torch.nn.attention.SDPBackend.FLASH_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal).transpose(1, 2)

    def grads_with(attention, params, c, batch):
        ATT.flash_attention = attention
        try:
            return ST.loss_and_grads(params, c, batch)
        finally:
            ATT.flash_attention = FA.flash_attention

    wgrad_rel, wgrad_launches, wgrad_f32 = {}, None, {}
    for dtype in ("float32", "bfloat16"):
        gcfg = wcfg.replace(dtype=dtype, **{k_: ENCDEC_GRAD[k_] for k_ in (
            "num_layers", "encoder_layers")})
        gbatch = SyntheticLM(DataConfig(
            vocab_size=gcfg.vocab_size, seq_len=ENCDEC_GRAD["seq_len"],
            global_batch=ENCDEC_GRAD["global_batch"], seed=1),
            device=cuda).batch(0)
        gbatch.update(stub_frontends(gcfg, ENCDEC_GRAD["global_batch"], 1, 0,
                                     cuda))
        runs = []
        for attention in (ATT.flash_attention, plain_attention):
            gparams, gopt = ST.init_train_state(gcfg, seed=1, device=cuda)
            # Adam's first step moves a zero-initialized leaf (the biases)
            # by lr times the gradient's sign alone: its gradient is held,
            # its updated value is not
            zero_init = {n for n, p_ in gparams.named_parameters()
                         if not bool(p_.any())}
            FA.flash_attention.launches = 0
            FA.flash_attention_lse.launches = 0
            FA.flash_attention_bwd.launches = 0
            loss, grads = grads_with(attention, gparams, gcfg, gbatch)
            ATT.flash_attention = attention
            try:
                ST.make_train_step(gcfg, lambda s_: torch.tensor(1e-3))(
                    gparams, gopt, gbatch)
            finally:
                ATT.flash_attention = FA.flash_attention
            if attention is ATT.flash_attention:
                wgrad_launches = (FA.flash_attention.launches,
                                  FA.flash_attention_lse.launches,
                                  FA.flash_attention_bwd.launches)
            runs.append((float(loss), grads,
                         {n: p.detach() for n, p in
                          gparams.named_parameters()}))
        calls = gcfg.encoder_layers + 2 * gcfg.num_layers
        if wgrad_launches != (0, 2 * 2 * calls, 2 * 2 * calls):
            fail(f"the {ENCDEC_ARCH} train steps launched row 10 (no lse, "
                 f"lse, backward) {wgrad_launches} times; predicted "
                 f"{(0, 4 * calls, 4 * calls)}: two passes, each {calls} "
                 f"attention calls run forward twice (remat full) and "
                 f"backward once (two launches)")
        (lk, gk, pk), (lp, gp, pp) = runs
        worst = max((rel_l2(gk[n], gp[n]), n) for n in gk)
        worst_p = max((rel_l2(pk[n], pp[n]), n) for n in pk
                      if n not in zero_init)
        wgrad_rel[dtype] = (worst, worst_p, abs(lk - lp))
        if not (worst[0] <= GRAD_TOL[dtype] and worst_p[0] <= GRAD_TOL[dtype]
                and math.isfinite(lk)):
            fail(f"the {dtype} {ENCDEC_ARCH} train step with row 10's kernels "
                 f"differs from the one through its plain version: worst "
                 f"gradient {worst}, worst parameter {worst_p} (per-leaf "
                 f"relative L2; bar {GRAD_TOL[dtype]}), losses {lk}, {lp}")
        if dtype == "bfloat16":
            tparams, _ = ST.init_train_state(gcfg, seed=1, device=cuda)
            _, gt = grads_with(plain_attention, tparams.float(),
                               gcfg.replace(dtype="float32"),
                               {**gbatch, "audio_embeds":
                                gbatch["audio_embeds"].float()})
            sparams, _ = ST.init_train_state(gcfg, seed=1, device=cuda)
            _, gs = grads_with(sdpa_attention, sparams, gcfg, gbatch)
            for n in sorted(gk, key=lambda n_: -rel_l2(gk[n_], gt[n_]))[:3]:
                wgrad_f32[n] = (rel_l2(gk[n], gt[n]), rel_l2(gp[n], gt[n]),
                                rel_l2(gs[n], gt[n]))
            del tparams, sparams, gt, gs
        del runs, gk, gp, pk, pp, gparams, gopt, grads, gbatch
    print(f"{ENCDEC_ARCH} gradient check (depth {ENCDEC_GRAD['encoder_layers']}"
          f" + {ENCDEC_GRAD['num_layers']}, {ENCDEC_GRAD['global_batch']} x "
          f"{ENCDEC_GRAD['seq_len']} tokens over {wcfg.encoder_seq} frames): "
          f"row 10 launches (no lse, lse, backward) {wgrad_launches} in two "
          f"passes; kernels against row 10's plain version, per-leaf "
          f"relative L2 (updated parameters: the {len(zero_init)} leaves "
          f"that start at zero left out, their gradients held) "
          + "; ".join(f"{d}: worst gradient {g[1]} {g[0]:.3e}, worst "
                      f"updated parameter {p_[1]} {p_[0]:.3e}, |loss diff| "
                      f"{dl:.3e}" for d, (g, p_, dl) in wgrad_rel.items())
          + f" (bars {GRAD_TOL}); the bf16 gradients farthest from the f32 "
          f"gradient of the same weights, relative L2 (kernels, plain, "
          f"SDPA's flash attention): "
          + ", ".join(f"{n} {k_:.3e}, {p_:.3e}, {s_:.3e}"
                      for n, (k_, p_, s_) in wgrad_f32.items())
          + f"  [{card}]")
    del wmodel, wbatch, paudio
    torch.cuda.empty_cache()

    # llava_next_34b at full width, cut to VLM_LAYERS of its 60 layers
    vfull = get_config(VLM_ARCH)
    vcfg = vfull.replace(num_layers=VLM_LAYERS)
    t0 = time.perf_counter()
    vmodel = init_params(vcfg, seed=0, device=cuda)
    torch.cuda.synchronize()
    vinit_s = time.perf_counter() - t0
    vweight_bytes = sum(p.numel() * p.element_size()
                        for p in vmodel.parameters())
    print(f"{VLM_ARCH} cut: depth {vfull.num_layers} -> {VLM_LAYERS} (the "
          f"published {vfull.num_layers} layers are about "
          f"{vfull.param_count() * 2 / 1e9:.1f} GB of bf16 weights on the "
          f"80 GB card, and their random init would eat the script's time); "
          f"widths as published: d {vcfg.d_model}, {vcfg.num_heads} query "
          f"over {vcfg.num_kv_heads} KV heads of {vcfg.resolved_head_dim}, "
          f"d_ff {vcfg.d_ff}, vocab {vcfg.vocab_size}; {vweight_bytes} B of "
          f"weights drawn in {vinit_s:.1f} s")
    vb, vtext = VLM_PREFILL
    vbatch = {"tokens": torch.randint(0, vcfg.vocab_size, VLM_PREFILL,
                                      generator=wgen, device=cuda),
              "patch_embeds": (torch.randn(
                  (vb, vcfg.vision_patches, vcfg.d_model), generator=wgen,
                  device=cuda) * 0.02).to(torch.bfloat16)}
    FA.flash_attention.launches = 0
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with H.record_calls() as vcalls:
        vlogits = LM.prefill_step(vmodel, vcfg, vbatch)
    torch.cuda.synchronize()
    vfirst_ms = (time.perf_counter() - t0) * 1e3
    vpeak = torch.cuda.max_memory_allocated() - resident
    vlaunches = FA.flash_attention.launches
    if vlaunches != VLM_LAYERS or len(vcalls) != VLM_LAYERS:
        fail(f"{VLM_ARCH} prefill_step launched flash_attention {vlaunches} "
             f"times ({len(vcalls)} calls), one per layer is {VLM_LAYERS}")
    if tuple(vlogits.shape) != VLM_PREFILL + (vcfg.vocab_padded,) or \
            vlogits.dtype != torch.bfloat16 or \
            not bool(torch.isfinite(vlogits).all()):
        fail(f"{VLM_ARCH} prefill logits {vlogits.dtype}"
             f"{tuple(vlogits.shape)} are not finite bf16 of shape "
             f"{VLM_PREFILL + (vcfg.vocab_padded,)} (text positions only)")
    del vlogits
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    LM.prefill_step(vmodel, vcfg, vbatch)
    torch.cuda.synchronize()
    vwarm_ms = (time.perf_counter() - t0) * 1e3
    verr = vrel = 0.0
    for _w, args in vcalls:
        if not (args["causal"] and args["q"].shape[1] == vcfg.vision_patches
                + vtext and args["q"].shape[-1] == 128
                and args["q"].shape[2] // args["k"].shape[2] == 7):
            fail(f"{VLM_ARCH}: row 10 called at q {tuple(args['q'].shape)}, "
                 f"k {tuple(args['k'].shape)}, causal {args['causal']}")
        got, want = FA.flash_attention(**args), FA.flash_attention.plain(**args)
        verr = max(verr, hold_flash(got, want, f"{VLM_ARCH} prefill"))
        rel = rel_l2(got, want)
        vrel = max(vrel, rel)
        if not rel <= FLASH_REL_L2:
            fail(f"flash_attention ({VLM_ARCH} prefill) is {rel} from its "
                 f"plain version in relative L2 (bar {FLASH_REL_L2})")
        del got, want
    del vcalls
    print(f"{VLM_ARCH} prefill_step {vb} x ({vcfg.vision_patches} patches + "
          f"{vtext} text tokens), depth {VLM_LAYERS}: {vlaunches} "
          f"flash_attention launches (one a layer, causal, head_dim 128, "
          f"{vcfg.num_heads // vcfg.num_kv_heads} query heads a KV head), "
          f"logits {VLM_PREFILL + (vcfg.vocab_padded,)} finite; each call "
          f"within 2e-2 of the plain version (max abs err {verr}) and "
          f"{FLASH_REL_L2} as a whole (relative L2 at most {vrel:.3e}); "
          f"first call "
          f"{vfirst_ms:.1f} ms, then {vwarm_ms:.1f} ms; peak device memory "
          f"{vpeak} B above the resident state; the encdec and vlm phase "
          f"{time.perf_counter() - phase_t0:.1f} s  [{card}]")
    fa_row = next(r for r in rows if r["name"] == "flash_attention")
    fa_row.update({
        "whisper_small_prefill_launches": wlaunches,
        "whisper_small_shapes": shape_rows,
        "llava_next_34b_cut_prefill_launches": vlaunches})
    for r in rows:
        if r["name"] in ("flash_attention_lse", "flash_attention_bwd"):
            r["whisper_small_grad_check_launches"] = wgrad_launches[
                1 if r["name"].endswith("lse") else 2]
    del vmodel, vbatch
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # Seventh path: the moe, ssm and hybrid families in bf16, random
    # weights from a seed: olmoe_1b_7b, xlstm_1_3b and zamba2_1_2b at full
    # width and depth, qwen3_moe_235b_a22b at full width cut in depth, the
    # expert-parallel dispatch on a (1, 4) mesh of the card repeated, and
    # one train step of each family at a cut depth that holds every kind
    # of its segments
    # ------------------------------------------------------------------
    from repro_torch.core.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models.transformer import segment_plan

    families_t0 = time.perf_counter()
    mgen = torch.Generator(device=cuda)
    mgen.manual_seed(28)
    family_log = {}

    def attention_layers(c):
        """Row-10 calls of one prefill: a moe layer's attention, or a
        hybrid's shared-attention site; the ssm family has none."""
        return sum(n for kind, n in segment_plan(c)
                   if kind in ("dense", "shared_attn"))

    def hold_calls(calls, label):
        """Every recorded row-10 call against its plain version: 2e-2 an
        element and FLASH_REL_L2 as a whole (bf16)."""
        e_max = r_max = 0.0
        for _w, args in calls:
            got = FA.flash_attention(**args)
            want = FA.flash_attention.plain(**args)
            e_max = max(e_max, hold_flash(got, want, label))
            rel = rel_l2(got, want)
            r_max = max(r_max, rel)
            if not rel <= FLASH_REL_L2:
                fail(f"flash_attention ({label}) is {rel} from its plain "
                     f"version in relative L2 (bar {FLASH_REL_L2})")
            del got, want
        return e_max, r_max

    def family_serving(arch, c, prefill, serve=None, parity=None,
                       keep_moe=False, profile_prefill=None):
        """``arch`` at config ``c``: one prefill with every row-10 call
        held, warm prefills with peak memory, a profiled prefill (at
        ``profile_prefill`` tokens if given) and decode step (device ops),
        a parity check, ``generate`` twice; returns a log (and, with
        ``keep_moe``, layer 0's expert weights)."""
        t_phase = time.perf_counter()
        t0 = time.perf_counter()
        m = init_params(c, seed=0, device=cuda)
        torch.cuda.synchronize()
        log = {"init_s": time.perf_counter() - t0,
               "weight_bytes": sum(p.numel() * p.element_size()
                                   for p in m.parameters())}
        b, s = prefill
        fbatch = {"tokens": torch.randint(0, c.vocab_size, prefill,
                                          generator=mgen, device=cuda)}
        FA.flash_attention.launches = 0
        MOE.moe_ffn.host_reads = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with H.record_calls() as calls:
            lg = LM.prefill_step(m, c, fbatch)
        torch.cuda.synchronize()
        log["first_ms"] = (time.perf_counter() - t0) * 1e3
        log["launches"] = FA.flash_attention.launches
        log["host_reads_prefill"] = MOE.moe_ffn.host_reads
        want_calls = attention_layers(c)
        if log["launches"] != want_calls or len(calls) != want_calls:
            fail(f"{arch} prefill_step launched flash_attention "
                 f"{log['launches']} times ({len(calls)} calls), expected "
                 f"{want_calls}")
        if c.is_moe and log["host_reads_prefill"] != c.num_layers:
            fail(f"{arch} prefill read the group sizes "
                 f"{log['host_reads_prefill']} times, one a layer is "
                 f"{c.num_layers}")
        if tuple(lg.shape) != prefill + (c.vocab_padded,) or \
                lg.dtype != torch.bfloat16 or \
                not bool(torch.isfinite(lg).all()):
            fail(f"{arch} prefill logits {lg.dtype}{tuple(lg.shape)} are "
                 f"not finite bf16 of shape {prefill + (c.vocab_padded,)}")
        del lg
        log["err"], log["rel"] = hold_calls(calls, f"{arch} prefill")
        log["call_shapes"] = sorted({(tuple(a["q"].shape), tuple(
            a["k"].shape), a["causal"]) for _w, a in calls})
        del calls
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        warm = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            LM.prefill_step(m, c, fbatch)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        log["prefill_ms"] = warm
        log["peak_bytes"] = torch.cuda.max_memory_allocated() - resident
        print(f"{arch} prefill_step {b} x {s} tokens (d {c.d_model}, "
              f"{c.num_layers} layers, plan "
              f"{[k for k, _ in segment_plan(c)][:4]}...): "
              f"{log['launches']} flash_attention launches, each within 2e-2"
              f" of the plain version (max abs err {log['err']:.3g}) and "
              f"{FLASH_REL_L2} as a whole (relative L2 at most "
              f"{log['rel']:.3e}) at {log['call_shapes']}; group-size host "
              f"reads {log['host_reads_prefill']}; first call "
              f"{log['first_ms']:.1f} ms, warm "
              f"{', '.join(f'{t:.2f}' for t in warm)} ms "
              f"({b * s / min(warm) * 1e3:.0f} tokens/s); peak device memory "
              f"{log['peak_bytes']} B above the resident state, beside "
              f"{log['weight_bytes']} B of weights drawn in "
              f"{log['init_s']:.1f} s  [{card}]")
        if profile_prefill is not None:
            fbatch = {"tokens": fbatch["tokens"][:profile_prefill[0],
                                                 :profile_prefill[1]]}
        profiled(f"{arch} prefill_step {profile_prefill or prefill}",
                 lambda: LM.prefill_step(m, c, fbatch))
        del fbatch
        if parity is not None:
            pb, pt = parity
            ptoks = torch.randint(0, c.vocab_size, parity, generator=mgen,
                                  device=cuda)
            want = LM.prefill_step(m, c, {"tokens": ptoks}).float()
            f32_leaves = {n_: p_.detach().clone() for n_, p_ in
                          m.named_parameters() if p_.dtype == torch.float32}
            exact = LM.prefill_step(m.float(), c.replace(dtype="float32"),
                                    {"tokens": ptoks}).float()
            m = m.bfloat16()         # .float() converted in place; the
            for n_, p_ in m.named_parameters():     # f32 leaves put back
                if n_ in f32_leaves:
                    p_.data = f32_leaves[n_]
            del f32_leaves
            if c.is_moe:   # the plain path: row 10 through its plain version
                ATT.flash_attention = plain_attention
                try:
                    got = LM.prefill_step(m, c, {"tokens": ptoks}).float()
                finally:
                    ATT.flash_attention = FA.flash_attention
                what = "prefill through row 10's plain version"
            else:          # the recurrent decode against the chunked prefill
                cache = LM.init_decode_cache(c, pb, pt, device=cuda)
                steps = []
                for pos in range(pt):
                    lg, cache = LM.serve_step(m, c, cache, {
                        "token": ptoks[:, pos:pos + 1], "pos": pos})
                    steps.append(lg[:, 0].float())
                got = torch.stack(steps, dim=1)
                del cache, steps
                what = "token-by-token serve_step"
            log["parity"] = float((got - want).abs().max())
            log["rounding"] = float((want - exact).abs().max())
            agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
            if not log["parity"] <= 3 * log["rounding"]:
                fail(f"{arch} {what} differs from prefill_step by "
                     f"{log['parity']}, above 3x the bf16 rounding "
                     f"{log['rounding']}")
            print(f"{arch} parity {parity}: {what} within {log['parity']} of "
                  f"prefill_step's logits (bar 3 x {log['rounding']}, the "
                  f"bf16 prefill's distance from f32 of the same weights); "
                  f"argmax agrees on {agree:.4f} of positions")
            del want, exact, got
        if serve is not None:
            sc = ServeConfig(arch=arch, smoke=False,
                             max_new_tokens=serve["new_tokens"])
            prompts = lm_rng.integers(0, c.vocab_size, (
                serve["requests"], serve["prompt"])).astype(np.int32)
            outs, ms_ = [], []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(generate(sc, prompts, params=m))
                ms_.append((time.perf_counter() - t0) * 1e3)
            toks = outs[0]["tokens"]
            if toks.shape != (serve["requests"], serve["prompt"] + serve[
                    "new_tokens"]) or not (toks[:, :serve["prompt"]] ==
                                           prompts).all() \
                    or not ((toks >= 0) & (toks < c.vocab_size)).all() \
                    or not np.isfinite(outs[0]["logprobs"]).all():
                fail(f"{arch} generate returned tokens {toks.shape} that do "
                     f"not extend the prompts with in-vocabulary tokens, or "
                     f"non-finite logprobs")
            if not (np.array_equal(toks, outs[1]["tokens"]) and
                    np.array_equal(outs[0]["logprobs"], outs[1]["logprobs"])):
                fail(f"two {arch} generate runs from one seed differ")
            n_steps = serve["prompt"] + serve["new_tokens"] - 1
            dcache = LM.init_decode_cache(c, serve["requests"], n_steps + 1,
                                          device=cuda)
            dbatch = {"token": torch.from_numpy(toks[:, -1:]).to(cuda),
                      "pos": n_steps}
            MOE.moe_ffn.host_reads = 0
            log["decode_ms"] = wall_clock_ms(
                lambda: LM.serve_step(m, c, dcache, dbatch))
            log["host_reads_decode"] = MOE.moe_ffn.host_reads / (
                1 + TIMING_REPS // 4)
            log["generate_ms"] = ms_
            new = serve["requests"] * serve["new_tokens"]
            print(f"{arch} generate: {serve['requests']} requests of "
                  f"{serve['prompt']} prompt tokens + {serve['new_tokens']} "
                  f"greedy new tokens in {ms_[0]:.1f}, {ms_[1]:.1f} ms "
                  f"({n_steps} serve_steps, {ms_[1] / n_steps:.2f} ms a "
                  f"step); {new / ms_[1] * 1e3:.1f} generated tokens/s; one "
                  f"serve_step at position {n_steps}: {log['decode_ms']:.2f} "
                  f"ms, {log['host_reads_decode']:.0f} group-size host reads;"
                  f" the two runs equal  [{card}]")
            profiled(f"{arch} serve_step (batch {serve['requests']})",
                     lambda: LM.serve_step(m, c, dcache, dbatch))
            del dcache
        moe_params = None
        if keep_moe:
            moe_params = {k: v.detach().float() for k, v in
                          m.blocks[0]["moe"].items()}
        del m
        torch.cuda.empty_cache()
        log["phase_s"] = time.perf_counter() - t_phase
        print(f"{arch} phase {log['phase_s']:.1f} s  [{card}]")
        return log, moe_params

    ocfg = get_config(MOE_ARCH)
    family_log[MOE_ARCH], olmoe_moe = family_serving(
        MOE_ARCH, ocfg, MOE_PREFILL, serve=SERVE, parity=PARITY,
        keep_moe=True)

    # The expert-parallel dispatch at olmoe's width, one layer: experts
    # over the model axis of a (1, 4) mesh of the card repeated, in f32
    # (the reference's boundary type), against ragged at capacity_factor
    # 8.0 (no slot drops: a row's tokens of one expert fit its capacity)
    t0 = time.perf_counter()
    ep_mesh = make_mesh((1, 4), ("data", "model"), devices=[cuda] * 4)
    eb, es = EP_SHAPE
    ex = torch.randn((eb, es, ocfg.d_model), generator=mgen, device=cuda)
    y_ep, _ = MOE.moe_ffn_ep(ex, olmoe_moe, num_experts=ocfg.num_experts,
                             k=ocfg.experts_per_token, capacity_factor=8.0,
                             mesh=ep_mesh)
    y_rg, _ = MOE.moe_ffn(ex.reshape(eb * es, -1), olmoe_moe,
                          num_experts=ocfg.num_experts,
                          k=ocfg.experts_per_token)
    y_rg = y_rg.reshape(eb, es, -1)
    ep_err = float((y_ep - y_rg).abs().max())
    ep_ok = bool(((y_ep - y_rg).abs() <= EP_TOL + EP_TOL * y_rg.abs()).all())
    if not ep_ok:
        fail(f"moe_ffn_ep on the (1, 4) mesh differs from ragged by {ep_err}"
             f" (bar {EP_TOL} abs and rel)")
    ep_ms = wall_clock_ms(lambda: MOE.moe_ffn_ep(
        ex, olmoe_moe, num_experts=ocfg.num_experts,
        k=ocfg.experts_per_token, capacity_factor=8.0, mesh=ep_mesh))
    rg_ms = wall_clock_ms(lambda: MOE.moe_ffn(
        ex.reshape(eb * es, -1), olmoe_moe, num_experts=ocfg.num_experts,
        k=ocfg.experts_per_token))
    print(f"moe_ffn_ep at {MOE_ARCH}'s width ({ocfg.num_experts} experts "
          f"top-{ocfg.experts_per_token}, d {ocfg.d_model}, expert d_ff "
          f"{ocfg.d_ff}), {eb} x {es} tokens, f32, on a (1, 4) (data, model) "
          f"mesh of the card repeated: within {ep_err:.3e} of ragged at "
          f"capacity_factor 8.0 (bar {EP_TOL} abs and rel); {ep_ms:.2f} ms "
          f"against ragged {rg_ms:.2f} ms (host clock, warm); "
          f"{time.perf_counter() - t0:.1f} s  [{card}]")
    del ex, y_ep, y_rg, olmoe_moe
    torch.cuda.empty_cache()

    qfull = get_config(MOE_CUT_ARCH)
    qcfg = qfull.replace(num_layers=MOE_CUT_LAYERS)
    print(f"{MOE_CUT_ARCH} cut: depth {qfull.num_layers} -> "
          f"{MOE_CUT_LAYERS} (the published {qfull.num_layers} layers are "
          f"about {qfull.param_count() * 2 / 1e9:.0f} GB of bf16 weights, "
          f"past the 80 GB card; {MOE_CUT_LAYERS} layers with the untied "
          f"embeddings about {qcfg.param_count() * 2 / 1e9:.1f} GB); widths "
          f"as published: d {qcfg.d_model}, {qcfg.num_heads} query over "
          f"{qcfg.num_kv_heads} KV heads of {qcfg.resolved_head_dim}, "
          f"{qcfg.num_experts} experts top-{qcfg.experts_per_token} of d_ff "
          f"{qcfg.d_ff}, vocab {qcfg.vocab_size}")
    family_log[MOE_CUT_ARCH], _ = family_serving(MOE_CUT_ARCH, qcfg,
                                                 MOE_CUT_PREFILL)
    family_log[SSM_ARCH], _ = family_serving(
        SSM_ARCH, get_config(SSM_ARCH), SSM_PREFILL, serve=RECURRENT_SERVE,
        parity=PARITY, profile_prefill=SSM_PROFILE_PREFILL)
    family_log[HYBRID_ARCH], _ = family_serving(
        HYBRID_ARCH, get_config(HYBRID_ARCH), HYBRID_PREFILL,
        serve=RECURRENT_SERVE, parity=PARITY)

    # One train step of each family at a cut depth.  As the whisper check:
    # in f32 and in bf16 the gradients with row 10's kernels against those
    # with row 10 through its plain version, per-leaf relative L2 under
    # GRAD_TOL (the ssm family calls no row 10: its two passes are the same
    # code).  Beside it, a record: the bf16 gradients against the f32
    # gradients of the same weights, within GRAD_TOL["bfloat16"] or past
    # it.  A moe's passes after the first take its expert choices (recorded
    # call by call, each pass's own router probabilities at them): a
    # near-tie that rounds the other way would move a token to another
    # expert, a different function, not a rounding of the same one.
    real_router = MOE.router_topk

    def recording_router(log):
        def router(x, w, num_experts, k):
            out = real_router(x, w, num_experts, k)
            log.append(out[1].detach().clone())
            return out
        return router

    def replaying_router(log):
        it = iter(log)

        def router(x, w, num_experts, k):
            probs = torch.softmax(x.float() @ w.float(), dim=-1)
            idx = next(it)
            weights = torch.gather(probs, 1, idx)
            weights = weights / weights.sum(-1, keepdim=True)
            ce = torch.nn.functional.one_hot(idx[:, 0], num_experts).float()
            return weights, idx, num_experts * torch.sum(
                probs.mean(0) * ce.mean(0))
        return router

    train_log = {}
    for arch, layers in FAMILY_TRAIN.items():
        t0 = time.perf_counter()
        tcfg = get_config(arch).replace(num_layers=layers)
        tbatch = SyntheticLM(DataConfig(
            vocab_size=tcfg.vocab_size, seq_len=FAMILY_TRAIN_SHAPE[1],
            global_batch=FAMILY_TRAIN_SHAPE[0], seed=1),
            device=cuda).batch(0)
        routes, grads, losses, launches = [], {}, {}, None
        for dtype in ("bfloat16", "float32"):
            dcfg = tcfg.replace(dtype=dtype)
            for route in ("kernels", "plain"):
                gparams, _ = ST.init_train_state(tcfg, seed=1, device=cuda)
                if dtype == "float32":       # the bf16 weights, widened
                    gparams = gparams.float()
                FA.flash_attention_lse.launches = 0
                FA.flash_attention_bwd.launches = 0
                MOE.router_topk = (recording_router(routes) if not routes
                                   else replaying_router(routes))
                ATT.flash_attention = (FA.flash_attention
                                       if route == "kernels"
                                       else plain_attention)
                try:
                    loss, g = ST.loss_and_grads(gparams, dcfg, tbatch)
                finally:
                    MOE.router_topk = real_router
                    ATT.flash_attention = FA.flash_attention
                if (dtype, route) == ("bfloat16", "kernels"):
                    launches = (FA.flash_attention_lse.launches,
                                FA.flash_attention_bwd.launches)
                grads[dtype, route], losses[dtype, route] = g, float(loss)
                del gparams
            gk, gp = grads[dtype, "kernels"], grads[dtype, "plain"]
            worst = max((rel_l2(gk[n], gp[n]), n) for n in gk)
            if not (worst[0] <= GRAD_TOL[dtype] and
                    math.isfinite(losses[dtype, "kernels"])):
                fail(f"{arch} (depth {layers}, {dtype}): the gradients with "
                     f"row 10's kernels differ from those through its plain "
                     f"version, worst per-leaf relative L2 {worst} (bar "
                     f"{GRAD_TOL[dtype]}), losses {losses}")
            grads[dtype, "worst"] = worst
        gb, gf = grads["bfloat16", "kernels"], grads["float32", "kernels"]
        vs_f32 = sorted(((rel_l2(gb[n], gf[n]), n) for n in gb),
                        reverse=True)
        # the step itself, bf16, with the kernels
        bparams, bopt = ST.init_train_state(tcfg, seed=1, device=cuda)
        before = {n: p.detach().clone() for n, p in
                  bparams.named_parameters()}
        _, bopt, metrics = ST.make_train_step(
            tcfg, lambda s_: torch.tensor(1e-3))(bparams, bopt, tbatch)
        moved = sum(not torch.equal(p.detach(), before[n])
                    for n, p in bparams.named_parameters())
        if int(bopt.step) != 1 or not math.isfinite(float(metrics["loss"])) \
                or moved == 0:
            fail(f"{arch} train step: step {int(bopt.step)}, loss "
                 f"{float(metrics['loss'])}, {moved} leaves moved")
        within = vs_f32[0][0] <= GRAD_TOL["bfloat16"]
        train_log[arch] = dict(
            worst={d: grads[d, "worst"] for d in ("float32", "bfloat16")},
            vs_f32=vs_f32[:3], within=within, losses=losses,
            launches=launches, leaves=len(gb), moved=moved,
            routes=len(routes), s=time.perf_counter() - t0)
        print(f"{arch} train step at depth {layers} "
              f"({[k for k, _ in segment_plan(tcfg)]}), "
              f"{FAMILY_TRAIN_SHAPE[0]} x {FAMILY_TRAIN_SHAPE[1]} tokens, "
              f"{len(gb)} leaves: kernels against row 10's plain version, "
              f"worst per-leaf relative L2 "
              + ", ".join(f"{d} {grads[d, 'worst'][1]} "
                          f"{grads[d, 'worst'][0]:.3e}"
                          for d in ("float32", "bfloat16"))
              + f" (bars {GRAD_TOL}); the bf16 gradients against the f32 "
              f"gradients of the same weights (a record): "
              + ", ".join(f"{n} {r_:.3e}" for r_, n in vs_f32[:3])
              + f", {'within' if within else 'past'} "
              f"{GRAD_TOL['bfloat16']}"
              + (f" (every pass on the first pass's {len(routes)} recorded "
                 f"expert choices)" if tcfg.is_moe else "")
              + f"; losses (bf16, f32) {losses['bfloat16', 'kernels']:.5f}, "
              f"{losses['float32', 'kernels']:.5f}; row 10 lse and backward "
              f"launches {launches} (bf16 pass); the step moved {moved} "
              f"leaves; {train_log[arch]['s']:.1f} s  [{card}]")
        del bparams, bopt, before, grads, gb, gf, routes, tbatch
        torch.cuda.empty_cache()

    fa_row = next(r for r in rows if r["name"] == "flash_attention")
    for arch, log in family_log.items():
        fa_row[f"{arch}_prefill_launches"] = log["launches"]
    for r in rows:
        if r["name"] in ("flash_attention_lse", "flash_attention_bwd"):
            for arch, tl in train_log.items():
                if tl["launches"][0]:
                    r[f"{arch}_train_check_launches"] = tl["launches"][
                        0 if r["name"].endswith("lse") else 1]
    print(f"the moe, ssm and hybrid phase {time.perf_counter() - families_t0:.1f}"
          f" s: " + ", ".join(f"{a} {l['phase_s']:.1f} s"
                              for a, l in family_log.items())
          + ", " + ", ".join(f"{a} train {t['s']:.1f} s"
                             for a, t in train_log.items()) + f"  [{card}]")

    # ------------------------------------------------------------------
    # Row 10 and 10 lse at the six shapes the LM paths give it, by CUDA
    # events in one phase beside scaled_dot_product_attention (a yardstick
    # the port never calls): seeded inputs at each shape, each call held to
    # the plain version, lse's output bitwise row 10's, two calls the same
    # bits
    # ------------------------------------------------------------------
    fgen = torch.Generator(device=cuda)
    fgen.manual_seed(27)
    by_shape = {}
    for name, (b, sq, skv, h, kvh, hd, causal) in FLASH_SHAPES.items():
        q, k, v = ((torch.randn(shape, generator=fgen, device=cuda))
                   .to(torch.bfloat16) for shape in (
            (b, sq, h, hd), (b, skv, kvh, hd), (b, skv, kvh, hd)))
        kw = dict(causal=causal)
        out = FA.flash_attention(q, k, v, **kw)
        e = hold_flash(out, FA.flash_attention.plain(q, k, v, **kw),
                       f"{name} shape")
        rel = rel_l2(out, FA.flash_attention.plain(q, k, v, **kw))
        if not rel <= FLASH_REL_L2:
            fail(f"flash_attention ({name} shape) is {rel} from its plain "
                 f"version in relative L2 (bar {FLASH_REL_L2})")
        o_lse, lse, lo = FA.flash_attention_lse(q, k, v, **kw)
        if not (torch.equal(o_lse, out) and
                torch.equal(FA.flash_attention(q, k, v, **kw), out)):
            fail(f"flash_attention ({name} shape): two calls, or the call "
                 f"with the log-sum-exp, differ in their bits")
        del o_lse, lse, lo, out
        groups = h // kvh
        qh, kh, vh = (t.transpose(1, 2) for t in (
            q, k.repeat_interleave(groups, dim=2),
            v.repeat_interleave(groups, dim=2)))
        qg, kg, vg = (t.detach().clone().requires_grad_()
                      for t in (qh, kh, vh))
        pairs = (sum(min(skv, i + 1) for i in range(sq)) if causal
                 else sq * skv)
        flops = 4 * b * h * hd * pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / BF16_FLOP_PER_S * 1e3
        r = by_shape[name] = {
            "shape": [b, sq, skv, h, kvh, hd, causal],
            "events_ms": events_ms(lambda: FA.flash_attention(q, k, v, **kw)),
            "lse_events_ms": events_ms(
                lambda: FA.flash_attention_lse(q, k, v, **kw)),
            "library_events_ms": events_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=causal)),
            "library_grad_events_ms": events_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qg, kg, vg, is_causal=causal)),
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "max_abs_err": e, "rel_l2": rel}
        print(f"row 10 at the {name} shape ({b}x{h} over {kvh} KV heads, "
              f"{sq} queries over {skv} keys, {hd}, bf16, "
              f"{'causal' if causal else 'full'}): CUDA events over "
              f"{TIMING_REPS} back-to-back calls {r['events_ms']:.4f} ms "
              f"({flops / r['events_ms'] / 1e9:.1f} TFLOP/s), with the "
              f"log-sum-exp and residual {r['lse_events_ms']:.4f}; "
              f"scaled_dot_product_attention {r['library_events_ms']:.4f}, "
              f"recording its backward {r['library_grad_events_ms']:.4f}; "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}; within "
              f"2e-2 of the plain version (max abs err {e:.3g}, relative L2 "
              f"{rel:.3e}), two calls and the lse call's output the same "
              f"bits  [{card}]")
        del q, k, v, qh, kh, vh, qg, kg, vg
    for r in rows:
        if r["name"] == "flash_attention":
            r["events_by_shape"] = {n: {
                k_: v_ for k_, v_ in x.items() if k_ != "lse_events_ms"}
                for n, x in by_shape.items()}
        elif r["name"] == "flash_attention_lse":
            r["events_by_shape"] = {n: {
                "shape": x["shape"], "events_ms": x["lse_events_ms"],
                "library_events_ms": x["library_grad_events_ms"],
                "bound_ms": x["bound_ms"], "bound_by": x["bound_by"]}
                for n, x in by_shape.items()}
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # Where the time goes: ingest, query and scatter under the profiler
    # ------------------------------------------------------------------
    update_ms = {"engine.update": [], "CTSurrogate.update": []}
    for _ in range(ENGINE_UPDATES):
        for label, fn in (("engine.update",
                           lambda: engine.update("bump", grids)),
                          ("CTSurrogate.update", lambda: srv.update(grids))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            update_ms[label].append((time.perf_counter() - t0) * 1e3)
    print("prod_3d warm ingest, median of " + str(ENGINE_UPDATES) + ": "
          + "; ".join(f"{k} {float(np.median(v)):.3f} ms (runs "
                      + ", ".join(f"{x:.3f}" for x in v) + ")"
                      for k, v in update_ms.items()) + f"  [{card}]")
    profiled_steps("prod_3d ingest (engine.update)",
                   lambda: engine.update("bump", grids))
    # The gate: an update's kernel launches by the wrappers' counts plus
    # the fine grid's fills among the profiled kinds (the profiler's
    # sessions lose ops, so it is not trusted to count them), and no copy
    # among the kinds it saw
    with H.count_launches() as made:
        engine.update("bump", grids)
    torch.cuda.synchronize()
    made = {k: v for k, v in made.items() if v}
    kinds = sorted(last_report["names"])
    copies = [n for n in kinds if "memcpy" in n.lower()]
    fills = [n for n in kinds if "fill" in n.lower()]
    ingest_ops = sum(made.values()) + len(fills)
    if ingest_ops > INGEST_DEVICE_OPS or len(kinds) > INGEST_DEVICE_OPS \
            or copies:
        fail(f"a prod_3d engine.update made {ingest_ops} device ops "
             f"(launches {made}, {len(fills)} fill), of {len(kinds)} kinds "
             f"{kinds}: at most {INGEST_DEVICE_OPS} and no copy expected")
    print(f"prod_3d engine.update: {ingest_ops} device ops a call (launches "
          f"{made} and {len(fills)} fill; at most {INGEST_DEVICE_OPS}), "
          f"{len(kinds)} kinds in its profile, no host-to-device copy: "
          f"{kinds}  [{card}]")
    profiled_steps("prod_3d ingest (CTSurrogate.update)",
                   lambda: srv.update(grids))
    pair = [points[1].numpy()] * 2

    def two_tenant_query():
        futs = [engine.submit_query(n, p) for n, p in zip(("bump", "wave"),
                                                          pair)]
        engine.flush()
        return [f.result() for f in futs]

    profiled_steps(f"prod_3d two-tenant coalesced query ({QUERY_BATCH} "
                   f"points each)", two_tenant_query)
    profiled_steps(f"prod_3d one-tenant query ({QUERY_BATCH} points)",
                   lambda: srv.query(points[1].numpy()))
    two_ms = wall_clock_ms(two_tenant_query)
    one_ms = wall_clock_ms(lambda: srv.query(points[1].numpy()))
    scatter_ms = wall_clock_ms(
        lambda: E.ct_scatter_with_plan(srv.surplus, srv._plan, device=cuda))
    profiled("prod_3d ct_scatter",
             lambda: E.ct_scatter_with_plan(srv.surplus, srv._plan,
                                            device=cuda))
    profiled("prod_3d iterated round (auto)",
             lambda: iterated.round(ITERATED["t_steps"]))
    profiled(f"{LM_ARCH} prefill_step {PREFILL}",
             lambda: LM.prefill_step(model, cfg, batch))
    profiled(f"{LM_ARCH} serve_step (batch {SERVE['requests']})",
             lambda: LM.serve_step(model, cfg, decode_cache, decode_batch))

    print(f"prod_3d CTEngine: construct (two tenants) {construct_ms:.1f} "
          f"ms, first update {ingest_ms:.2f} ms, query per batch of "
          f"{QUERY_BATCH} {', '.join(f'{q:.2f}' for q in query_ms)} ms; "
          f"warm one-tenant query {one_ms:.2f} ms, two-tenant coalesced "
          f"query {two_ms:.2f} ms; peak device memory {peak} B  [{card}]")
    print(f"scatter path: prod_3d ct_scatter {scatter_ms:.2f} ms (host clock, "
          f"warm; first call {scatter_first_ms:.2f} ms); aniso_6d adaptive "
          f"step {adaptive_step_ms:.2f} ms profiled (median unprofiled "
          f"{float(np.median(step_ms)):.2f} ms); prod_3d drop_grid "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in drop_ms.items())
          + f" profiled  [{card}]")
    print(f"profiler sessions: {sessions['all']}, of which "
          f"{sessions['empty']} recorded no device activity and "
          f"{sessions['short']} fewer device ops than the calls launched "
          f"(rows 10 lse and 10 bwd, run again)  [{card}]")

    # ------------------------------------------------------------------
    # The analysis phase: the port's linter over its tree, then the
    # engine and cluster loads at prod_3d in a child process under the
    # lock-order sanitizer, held to the same loads uninstrumented here
    # ------------------------------------------------------------------
    from repro_torch.analysis import lockdep, locklint

    if lockdep.enabled():
        fail("the analysis phase's parent must run uninstrumented (unset "
             "REPRO_TORCH_LOCKDEP)")
    t0 = time.perf_counter()
    findings, files = locklint.lint_paths([ROOT / "src" / "repro_torch"])
    if findings:
        fail("the port's linter found:\n" + "\n".join(
            f.render() for f in findings))
    print(f"analysis: linter over src/repro_torch: {len(files)} files "
          f"scanned ({sum(f.suffix != '.py' for f in files)} CUDA sources "
          f"of the left-fold path and row 10's backward), 0 findings, "
          f"pragmas by rule "
          f"{locklint.pragma_counts([ROOT / 'src' / 'repro_torch'])}, "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(prefix="ct-lockdep-") as root:
        plain, plain_launches = counted_launches(
            lambda: lockdep_engine_load(cuda, prod, root))
    if plain["unresolved"] or plain["failed"]:
        fail(f"the uninstrumented engine load: {plain['unresolved']} "
             f"futures unresolved, failures {plain['failed'][:5]}")
    if set(KERNELS) - set(plain_launches):
        fail(f"the uninstrumented engine load launched {plain_launches}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--lockdep-child",
         json.dumps(plain["sha256"])], cwd=ROOT,
        env={**os.environ, "REPRO_TORCH_LOCKDEP": "1"},
        capture_output=True, text=True, timeout=LOCKDEP["child_timeout_s"])
    child_s = time.perf_counter() - t0
    got = [line for line in child.stdout.splitlines()
           if line.startswith("lockdep-child: ")]
    if child.returncode != 0 or len(got) != 1:
        fail(f"the sanitized child exited {child.returncode}:\n"
             f"{child.stdout[-4000:]}\n{child.stderr[-4000:]}")
    san = json.loads(got[0].split(": ", 1)[1])
    eng, clu = san["engine"], san["cluster"]
    if san["violations"] or san["cycles"] or san["problems"] \
            or eng["sha256"] != plain["sha256"] \
            or clu["sha256"] != plain["sha256"]:
        fail(f"the sanitized child: {san['problems']} "
             f"{san['violations'][:5]} {san['cycles'][:5]}")
    print(f"analysis: sanitized child (REPRO_TORCH_LOCKDEP=1) at prod_3d, "
          f"{child_s:.1f} s in all (the parent holding {held} B on the "
          f"card): 0 violations, 0 cycles; lock edges "
          + ", ".join(f"{a}->{b} x{n}" for a, b, n in san["edges"])
          + f" (each up in rank); {san['dispatch_notes']} note_dispatch "
          f"calls  [{card}]")
    print(f"analysis: engine load ({LOCKDEP['submitters']} submitters, "
          f"{LOCKDEP['engine_s']:.0f} s, durable): sanitized "
          f"{eng['futures']} futures ({eng['ingests']} ingests) all "
          f"resolved, uninstrumented {plain['futures']} "
          f"({plain['ingests']} ingests); launches sanitized "
          f"{san['launches']['engine']}, uninstrumented {plain_launches}; "
          f"final surpluses' sha256 equal: "
          + ", ".join(f"{n} {h[:16]}" for n, h in plain["sha256"].items())
          + f"  [{card}]")
    print(f"analysis: cluster load ({LOCKDEP['hosts']} durable hosts, "
          f"fail_host({clu['victim']}) then restart_host): {clu['futures']} "
          f"query futures all resolved, outcomes {clu['outcomes']}, "
          f"placement restored, surpluses' sha256 equal to the "
          f"uninstrumented engine's; launches {san['launches']['cluster']};"
          f" fail_host {clu['failover_ms']} ms, restart_host "
          f"{clu['restart_ms']} ms; longest wait for one of "
          f"{LOCKDEP['window']} query slots {clu['longest_wait_ms']:.1f} ms"
          f"  [{card}]")
    print(f"analysis: median of {LOCKDEP['reps']}, sanitized against "
          f"uninstrumented: engine.update {np.median(eng['update_ms']):.3f}"
          f" ms vs {np.median(plain['update_ms']):.3f} ms; one-tenant "
          f"{LOCKDEP['points']}-point query "
          f"{np.median(eng['query_ms']):.3f} ms vs "
          f"{np.median(plain['query_ms']):.3f} ms (runs "
          f"{[round(x, 3) for x in eng['update_ms']]} vs "
          f"{[round(x, 3) for x in plain['update_ms']]}; "
          f"{[round(x, 3) for x in eng['query_ms']]} vs "
          f"{[round(x, 3) for x in plain['query_ms']]})  [{card}]")
    rows.sort(key=lambda r: ROW[r["name"]])
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--lockdep-child"] and len(sys.argv) == 3:
        sys.exit(lockdep_child(sys.argv[2]))
    sys.exit(main())
