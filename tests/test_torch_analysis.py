"""The port's static pass (``repro_torch.analysis.locklint``) on the CPU,
held to the reference's (``repro.analysis.locklint``).

* The rule corpus: one case of every test of ``tests/test_analysis.py``
  on the port's names (a violation flagged, the same site with a
  ``ctlint: ok`` pragma suppressed, a clean variant passing).
* Parity: every corpus source whose names both registries share, linted
  by both packages under the same path, gives the same ``(rule, line)``
  findings (the reference's side runs once, in a module fixture).
* Port-only cases: ``_IngestExecutable._lock`` told apart from the
  engine lock, ``index_add_``/``scatter_add_`` on a bit-critical
  function, atomic adds in a CUDA source of the left-fold path, the
  port's blocking forms (``synchronize``, ``.item()``, ``.tolist()``)
  under a lock.
* The tree: clean, every bit-critical prefix naming a function of the
  port, every ``ctlint: ok`` pragma load-bearing (stripping it alone
  re-surfaces a finding), every lock made through
  ``lockdep.make_lock``/``make_rlock`` with a registered class, the
  analysis modules importing the standard library only; the CLI's exit
  codes and its ``--json`` artifact.
"""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import locklint as ref_lint
from repro_torch.analysis import invariants as inv
from repro_torch.analysis import locklint
from repro_torch.analysis.invariants import INVARIANTS
from repro_torch.analysis.locklint import default_root, lint_paths, lint_text

SRC = Path(__file__).resolve().parents[1] / "src"
ENGINE = "core/engine.py"
CLUSTER = "runtime/cluster.py"
EXECUTOR = "core/executor.py"
DISTRIBUTED = "core/distributed.py"
DURABILITY = "runtime/durability.py"
HIERARCHIZE = "kernels/hierarchize.py"


def rules_of(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# The rule corpus: (id, source, path, expectation, rule, shared).
# expectation "flags": ``rule`` is among the findings; "clean": ``rule``
# is not (every rule when ``rule`` is None).  ``shared``: the source names
# only what both registries know, so it is also a parity case.
# ---------------------------------------------------------------------------

CORPUS = [
    # lock-order
    ("lock_order_violation_detected", """
class CTEngine:
    def bad(self):
        with _INGEST_CACHE_LOCK:
            with self._lock:
                pass
""", ENGINE, "flags", "lock-order", True),
    ("lock_order_pragma_suppresses", """
class CTEngine:
    def annotated(self):
        with _INGEST_CACHE_LOCK:
            # ctlint: ok(lock-order): corpus fixture
            with self._lock:
                pass
""", ENGINE, "clean", "lock-order", True),
    ("lock_order_correct_direction_clean", """
class CTEngine:
    def good(self):
        with self._lock:
            with _INGEST_CACHE_LOCK:
                pass
""", ENGINE, "clean", None, True),
    ("lock_order_reentrant_same_class_ok", """
class CTEngine:
    def reenter(self):
        with self._lock:
            with self._work:
                pass
""", ENGINE, "clean", None, True),
    ("lock_order_engine_under_cluster_is_legal", """
class CTCluster:
    def route(self, host):
        with self._lock:
            host.engine.submit_query("t", pts, block=False)
""", CLUSTER, "clean", None, True),
    # lock-order-call
    ("lock_order_call_transitive_detected", """
class CTEngine:
    def _leafwork(self):
        with self._lock:
            pass

    def bad(self):
        with _INGEST_CACHE_LOCK:
            self._leafwork()
""", ENGINE, "flags", "lock-order-call", True),
    ("lock_order_call_pragma_suppresses", """
class CTEngine:
    def _leafwork(self):
        with self._lock:
            pass

    def annotated(self):
        with _INGEST_CACHE_LOCK:
            # ctlint: ok(lock-order-call): corpus fixture
            self._leafwork()
""", ENGINE, "clean", "lock-order-call", True),
    ("lock_order_call_reentrant_clean", """
class CTEngine:
    def stats(self):
        with self._lock:
            return 1

    def good(self):
        with self._lock:
            return self.stats()
""", ENGINE, "clean", None, True),
    # block-under-lock (the reference's block_until_ready is the port's
    # device synchronisation)
    ("synchronize_under_lock_detected", """
class CTEngine:
    def bad(self, out):
        with self._lock:
            torch.cuda.synchronize()
""", ENGINE, "flags", "block-under-lock", False),
    ("future_result_under_lock_detected", """
class CTCluster:
    def bad(self, fut):
        with self._lock:
            return fut.result()
""", CLUSTER, "flags", "block-under-lock", True),
    ("store_append_under_engine_lock_detected", """
class CTEngine:
    def bad(self, name, grids):
        with self._work:
            self._store.append(name, 1, grids)
""", ENGINE, "flags", "block-under-lock", True),
    ("store_append_under_engine_lock_pragma", """
class CTEngine:
    def annotated(self, name, grids):
        with self._work:
            # ctlint: ok(block-under-lock): journal order = admission order
            self._store.append(name, 1, grids)
""", ENGINE, "clean", "block-under-lock", True),
    ("blocking_call_outside_lock_clean", """
class CTEngine:
    def good(self, out):
        torch.cuda.synchronize()
        with self._lock:
            self._counters["done"] += 1
""", ENGINE, "clean", None, True),
    ("os_path_join_not_a_thread_join", """
class DurableStore:
    def paths(self, name):
        with self._lock:
            return os.path.join(self.root, name)
""", DURABILITY, "clean", None, True),
    ("thread_join_under_lock_detected", """
class CTEngine:
    def bad(self, t):
        with self._lock:
            t.join()
""", ENGINE, "flags", "block-under-lock", True),
    # dispatch-under-lock
    ("dispatch_under_lock_detected", """
class CTEngine:
    def bad(self, tenant, grids):
        with self._work:
            return self._dispatch_ingest(tenant, grids)
""", ENGINE, "flags", "dispatch-under-lock", True),
    ("dispatch_outside_lock_clean", """
class CTEngine:
    def good(self, tenant, grids):
        surplus = self._dispatch_ingest(tenant, grids)
        with self._work:
            tenant.surplus = surplus
""", ENGINE, "clean", "dispatch-under-lock", True),
    ("dispatch_under_lock_pragma_suppresses", """
class CTEngine:
    def annotated(self, tenant, grids):
        with self._work:
            # ctlint: ok(dispatch-under-lock): corpus fixture
            return self._dispatch_ingest(tenant, grids)
""", ENGINE, "clean", "dispatch-under-lock", True),
    # wait-wrong-lock / notify-outside-lock + holds()
    ("wait_without_owner_detected", """
class CTEngine:
    def bad(self):
        self._space.wait(0.1)
""", ENGINE, "flags", "wait-wrong-lock", True),
    ("wait_with_holds_annotation_clean", """
class CTEngine:
    def helper(self):  # ctlint: holds(engine)
        self._space.wait(0.1)
""", ENGINE, "clean", None, True),
    ("wait_with_owner_held_clean", """
class CTEngine:
    def good(self):
        with self._work:
            self._work.wait(0.1)
""", ENGINE, "clean", None, True),
    ("notify_outside_lock_detected", """
class CTEngine:
    def bad(self):
        self._work.notify_all()
""", ENGINE, "flags", "notify-outside-lock", True),
    ("notify_outside_lock_pragma", """
class CTEngine:
    def annotated(self):
        # ctlint: ok(notify-outside-lock): corpus fixture
        self._work.notify_all()
""", ENGINE, "clean", "notify-outside-lock", True),
    # blocking-submit-under-lock
    ("blocking_submit_under_cluster_lock_detected", """
class CTCluster:
    def bad(self, host, name, grids):
        with self._lock:
            return host.engine.submit_ingest(name, grids)
""", CLUSTER, "flags", "blocking-submit-under-lock", True),
    ("submit_with_block_false_clean", """
class CTCluster:
    def good(self, host, name, grids):
        with self._lock:
            return host.engine.submit_ingest(name, grids, block=False)
""", CLUSTER, "clean", None, True),
    ("blocking_submit_pragma_suppresses", """
class CTCluster:
    def annotated(self, host, name, grids):
        with self._lock:
            # ctlint: ok(blocking-submit-under-lock): corpus fixture
            return host.engine.submit_ingest(name, grids)
""", CLUSTER, "clean", "blocking-submit-under-lock", True),
    ("submit_outside_lock_may_block", """
class CTCluster:
    def sync_path(self, host, name, grids):
        return host.engine.submit_ingest(name, grids, block=True)
""", CLUSTER, "clean", None, True),
    # donate-reuse
    ("donate_retry_without_guard_detected", """
class CTEngine:
    def _ingest_one(self, tenant, grids):
        def attempt():
            return self._dispatch_ingest(tenant, grids)
        return self._retry.run(attempt)
""", ENGINE, "flags", "donate-reuse", True),
    ("donate_retry_with_guard_clean", """
class CTEngine:
    def _ingest_one(self, tenant, grids):
        def attempt():
            if tenant.spec.donate:
                self._check_not_donated("t", grids)
            return self._dispatch_ingest(tenant, grids)
        return self._retry.run(attempt)
""", ENGINE, "clean", "donate-reuse", True),
    ("donate_loop_invariant_payload_detected", """
class CTEngine:
    def bad(self, tenant, grids, n):
        for _ in range(n):
            self._dispatch_ingest(tenant, grids)
""", ENGINE, "flags", "donate-reuse", True),
    ("donate_loop_derived_payload_clean", """
class CTEngine:
    def replay_like(self, tenant, entries):
        for e in entries:
            self._dispatch_ingest(tenant, e.grids)
""", ENGINE, "clean", "donate-reuse", True),
    ("donate_single_call_clean", """
class CTEngine:
    def register_like(self, tenant, grids):
        return self._dispatch_ingest(tenant, grids)
""", ENGINE, "clean", "donate-reuse", True),
    ("donate_pragma_suppresses", """
class CTEngine:
    def annotated(self, tenant, grids, n):
        for _ in range(n):
            # ctlint: ok(donate-reuse): corpus fixture
            self._dispatch_ingest(tenant, grids)
""", ENGINE, "clean", "donate-reuse", True),
    # bit-identity-reassoc (the reference's _gather_one_bucket is the
    # port's _gather_unfused)
    ("torch_sum_on_scatter_path_detected", """
def gather_slab_scatter_fused(parts):
    return torch.sum(parts, dim=0)
""", DISTRIBUTED, "flags", "bit-identity-reassoc", True),
    ("psum_on_scatter_path_detected", """
def _gather_unfused(buf, axis_name):
    return psum(buf, axis_name)
""", EXECUTOR, "flags", "bit-identity-reassoc", False),
    ("builtin_sum_over_specs_clean", """
def gather_slab_scatter_2d(npred):
    return list(range(sum(npred)))
""", DISTRIBUTED, "clean", "bit-identity-reassoc", True),
    ("left_fold_scatter_clean", """
def gather_slab_scatter(buf, dst, pending):
    return owner_fold(pending, dst, buf)
""", DISTRIBUTED, "clean", None, True),
    ("reassoc_off_critical_path_clean", """
def gather_full_psum(buf, axis_name):
    return psum(buf, axis_name)
""", DISTRIBUTED, "clean", None, True),
    ("bit_identity_pragma_suppresses", """
def gather_slab_scatter_fused(parts):
    # ctlint: ok(bit-identity-reassoc): corpus fixture
    return torch.sum(parts, dim=0)
""", DISTRIBUTED, "clean", "bit-identity-reassoc", True),
    # transitive blocking/dispatch through local helpers
    ("local_helper_blocking_under_lock_detected", """
class CTCluster:
    def _add_probe_tenant(self, engine):
        engine.register("probe", scheme, grids)

    def add_host(self):
        with self._lock:
            self._add_probe_tenant(engine)
""", CLUSTER, "flags", "block-under-lock", True),
    ("local_helper_dispatch_under_lock_detected", """
class CTEngine:
    def _go(self, tenant, grids):
        self._dispatch_ingest(tenant, grids)

    def f(self, tenant, grids):
        with self._lock:
            self._go(tenant, grids)
""", ENGINE, "flags", "dispatch-under-lock", True),
    ("pragmad_inner_site_does_not_propagate", """
class CTCluster:
    def _add_probe_tenant(self, engine):
        # ctlint: ok(block-under-lock): corpus fixture
        engine.register("probe", scheme, grids)

    def add_host(self):
        with self._lock:
            self._add_probe_tenant(engine)
""", CLUSTER, "clean", "block-under-lock", True),
    ("helper_called_outside_lock_clean", """
class CTCluster:
    def _add_probe_tenant(self, engine):
        engine.register("probe", scheme, grids)

    def add_host(self):
        with self._lock:
            hid = self._next_id()
        self._add_probe_tenant(engine)
""", CLUSTER, "clean", None, True),
    ("nested_closure_body_not_in_enclosing_summary", """
class CTEngine:
    def _build(self, plan):
        def run(tenant, grids):
            return self._dispatch_ingest(tenant, grids)
        return functools.partial(run)

    def f(self, plan):
        with _INGEST_CACHE_LOCK:
            fn = self._build(plan)
        return fn
""", ENGINE, "clean", None, True),
]

#: The port-only cases: what the reference's names cannot express.
PORT_CASES = [
    ("ingest_tables_lock_is_its_own_class", """
class _IngestExecutable:
    def bad(self):
        with self._lock:
            with _INGEST_CACHE_LOCK:
                pass
""", ENGINE, "flags", "lock-order"),
    ("ingest_tables_under_ingest_cache_clean", """
class _IngestExecutable:
    def good(self):
        with _INGEST_CACHE_LOCK:
            with self._lock:
                pass
""", ENGINE, "clean", None),
    ("engine_lock_under_ingest_tables_detected", """
class CTEngine:
    def bad(self, ex):
        with self._lock:
            pass

class _IngestExecutable:
    def _tables(self, engine):
        with self._lock:
            engine.stats()
""", ENGINE, "flags", "lock-order-call"),
    ("index_add_on_scatter_path_detected", """
def _gather_unfused(full, x, idx, cs):
    for m in range(len(cs)):
        full.index_add_(0, idx[m], cs[m] * x[m])
    return full
""", EXECUTOR, "flags", "bit-identity-reassoc"),
    ("scatter_add_on_scatter_path_detected", """
def hier_scatter_grouped(y, table, coeffs, acc):
    return acc.scatter_add_(0, table, coeffs * y)
""", HIERARCHIZE, "flags", "bit-identity-reassoc"),
    ("index_put_accumulate_on_scatter_path_detected", """
def owner_fold(values, table, acc):
    return acc.index_put_((table,), values, accumulate=True)
""", HIERARCHIZE, "flags", "bit-identity-reassoc"),
    ("index_add_pragma_suppresses", """
def _axis_scatter_plain(x, idx, acc):
    for m in range(x.shape[0]):
        # ctlint: ok(bit-identity-reassoc): injective map, member order
        acc.index_add_(0, idx[m], x[m])
    return acc
""", HIERARCHIZE, "clean", "bit-identity-reassoc"),
    ("index_add_off_scatter_path_clean", """
def _ingest_psum(full, idx, x):
    return full.index_add_(0, idx, x)
""", DISTRIBUTED, "clean", None),
    ("item_under_lock_detected", """
class CTEngine:
    def bad(self, t):
        with self._lock:
            return t.sum().item()
""", ENGINE, "flags", "block-under-lock"),
    ("tolist_under_lock_detected", """
class OwnerTable:
    def bad(self, t):
        with self._lock:
            return t.tolist()
""", HIERARCHIZE, "flags", "block-under-lock"),
    ("engine_synchronize_helper_under_lock_detected", """
class CTEngine:
    def bad(self):
        with self._work:
            _synchronize(self.device)
""", ENGINE, "flags", "block-under-lock"),
    ("stream_synchronize_under_plan_tables_detected", """
def _plan_table(kind, arrays, build):
    with _PLAN_TABLES_LOCK:
        torch.cuda.current_stream().synchronize()
""", EXECUTOR, "flags", "block-under-lock"),
    ("cpu_copy_under_lock_left_out", """
class CTEngine:
    def copy(self, t):
        with self._lock:
            return t.cpu().numpy()
""", ENGINE, "clean", None),
    ("sleep_under_build_lock_detected", """
def load_all():
    with _BUILD_LOCK:
        time.sleep(0.1)
""", "kernels/_build.py", "flags", "block-under-lock"),
    ("cuda_atomic_add_on_fold_path_detected", """
__global__ void fold(double* acc, const double* v, const int* slot) {
  int i = threadIdx.x;
  atomicAdd(&acc[slot[i]], v[i]);
}
""", "kernels/csrc/owner_fold.cu", "flags", "bit-identity-reassoc"),
    ("cuda_ptx_red_add_on_fold_path_detected", """
__device__ void add(double* p, double v) {
  asm volatile("red.global.add.f64 [%0], %1;" :: "l"(p), "d"(v));
}
""", "kernels/csrc/hier3.cuh", "flags", "bit-identity-reassoc"),
    ("cuda_atomic_add_in_comment_clean", """
// atomicAdd(&acc[s], v) would add in no fixed order
/* atomicAdd(&acc[s], v); */
__global__ void fold(double* acc) { acc[0] += 1.0; }
""", "kernels/csrc/axis_pass_scatter_fwd.cu", "clean", None),
    ("cuda_atomic_add_pragma_suppresses", """
__global__ void fold(unsigned* n) {
  // ctlint: ok(bit-identity-reassoc): an integer counter, order-free
  atomicAdd(n, 1u);
}
""", "kernels/csrc/assemble_members.cu", "clean", "bit-identity-reassoc"),
    ("cuda_atomic_or_clean", """
__global__ void mark(unsigned* ws, unsigned lines) {
  atomicOr(&ws[0], lines);
}
""", "kernels/csrc/owner_fold.cu", "clean", None),
    ("cuda_off_fold_path_not_scanned", """
__global__ void tile(double* acc, double v) { atomicAdd(acc, v); }
""", "kernels/csrc/operator_slab_tile.cuh", "clean", None),
    ("cuda_atomic_add_in_flash_bwd_detected", """
__global__ void fold_dq(float* dq, const float* part, int n) {
  atomicAdd(&dq[threadIdx.x], part[blockIdx.x * n + threadIdx.x]);
}
""", "kernels/csrc/flash_attention_bwd.cu", "flags",
     "bit-identity-reassoc"),
    ("cuda_ptx_red_add_in_wgmma_helpers_detected", """
__device__ void add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;" :: "l"(p), "f"(v));
}
""", "kernels/csrc/wgmma_tma.cuh", "flags", "bit-identity-reassoc"),
    ("cuda_mbarrier_and_tma_clean", """
__device__ void ring(unsigned bar, unsigned dst, unsigned long long map) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 64;"
               :: "r"(bar));
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier"
               "::complete_tx::bytes [%0], [%1, {0, 0}], [%2];"
               :: "r"(dst), "l"(map), "r"(bar));
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar));
}
""", "kernels/csrc/flash_attention_bwd.cu", "clean", None),
]


def _check(src, path, expect, rule):
    found = lint_text(src, path)
    if expect == "flags":
        assert rule in rules_of(found), (
            "expected %r in findings, got %r" % (rule, sorted(
                rules_of(found))))
    elif rule is None:
        assert not found, [f.render() for f in found]
    else:
        assert rule not in rules_of(found), \
            [f.render() for f in found if f.rule == rule]


@pytest.mark.parametrize("case", CORPUS, ids=[c[0] for c in CORPUS])
def test_rule_corpus(case):
    _, src, path, expect, rule, _ = case
    _check(src, path, expect, rule)


@pytest.mark.parametrize("case", PORT_CASES, ids=[c[0] for c in PORT_CASES])
def test_port_only_case(case):
    _, src, path, expect, rule = case
    _check(src, path, expect, rule)


# ---------------------------------------------------------------------------
# Parity with the reference's linter
# ---------------------------------------------------------------------------

SHARED = [c for c in CORPUS if c[5]]


def _pairs(findings):
    return sorted((f.rule, f.line) for f in findings)


@pytest.fixture(scope="module")
def reference_findings():
    """The reference linter's ``(rule, line)`` findings of every shared
    corpus source, once."""
    return {c[0]: _pairs(ref_lint.lint_text(c[1], c[2])) for c in SHARED}


@pytest.mark.parametrize("case", SHARED, ids=[c[0] for c in SHARED])
def test_parity_with_reference_linter(case, reference_findings):
    name, src, path = case[:3]
    assert _pairs(lint_text(src, path)) == reference_findings[name]


def test_parity_covers_every_rule(reference_findings):
    flagged = {rule for pairs in reference_findings.values()
               for rule, _ in pairs}
    assert flagged == set(INVARIANTS)


def test_classification_tells_ingest_tables_from_engine():
    classify = inv.classify_lock
    assert classify(ENGINE, "self._lock", "CTEngine") == ("engine", False)
    assert classify(ENGINE, "self._lock", "_IngestExecutable") == \
        ("ingest-tables", False)
    assert classify(ENGINE, "self._lock", None) is None
    assert classify(ENGINE, "self._work", "CTEngine") == ("engine", True)
    assert classify("kernels/_build.py", "_BUILD_LOCK") == \
        ("kernel-build", False)
    assert classify(EXECUTOR, "_PLAN_TABLES_LOCK") == ("plan-tables", False)
    # the reference's pattern list ranks the leaf as the engine lock
    from repro.analysis import invariants as ref_inv
    assert ref_inv.classify_lock(ENGINE, "self._lock") == ("engine", False)


def test_registry_ranks_and_guards():
    ranks = inv.LOCK_RANKS
    from repro.analysis import invariants as ref_inv
    for name, rank in ref_inv.LOCK_RANKS.items():
        assert ranks[name] == rank
    assert len(ranks) == 13 and set(inv.LOCK_GUARDS) == set(ranks)
    leaves = set(ranks) - set(ref_inv.LOCK_RANKS)
    assert min(ranks[c] for c in leaves) > max(ref_inv.LOCK_RANKS.values())
    assert max(ranks, key=ranks.get) == "kernel-build"
    assert set(INVARIANTS) == set(ref_inv.INVARIANTS)
    for path, _ in inv.LOCK_GUARDS.values():
        assert (SRC / "repro_torch" / path).is_file(), path


# ---------------------------------------------------------------------------
# The port's tree
# ---------------------------------------------------------------------------

def _functions(root):
    names = set()
    for f in root.rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(node.name)
    return names


def test_every_bit_critical_prefix_names_a_port_function():
    names = _functions(default_root())
    for prefix in inv.BIT_CRITICAL_FUNC_PREFIXES:
        assert any(n.startswith(prefix) for n in names), prefix
    for src in inv.BIT_CRITICAL_CUDA_SOURCES:
        assert (default_root() / src).is_file(), src
    for name in inv.DISPATCH_CALL_NAMES | inv.DONATION_GUARDS \
            | inv.DONATING_CALLS:
        assert name in names, name


def test_repo_tree_is_clean():
    findings, files = lint_paths()
    assert len(files) > 45
    assert {f.as_posix().split("repro_torch/", 1)[1] for f in files
            if f.suffix != ".py"} == set(inv.BIT_CRITICAL_CUDA_SOURCES)
    assert not findings, "\n".join(f.render() for f in findings)


def test_corpus_exercises_every_rule():
    exercised = {c[4] for c in CORPUS + PORT_CASES if c[3] == "flags"}
    assert exercised == set(INVARIANTS)


_PRAGMA = re.compile(r"(?:#|//)\s*ctlint:\s*ok\(([^)]*)\)[^\n]*")


def _pragma_sites():
    """``(file, line)`` of every pragma naming a rule (the docstrings'
    examples name none)."""
    sites = []
    for f in locklint.iter_source_files([default_root()]):
        for i, line in enumerate(f.read_text().splitlines(), start=1):
            m = _PRAGMA.search(line)
            if m and {r.strip() for r in m.group(1).split(",")} \
                    & set(INVARIANTS):
                sites.append((f.relative_to(default_root()).as_posix(), i))
    return sites


PRAGMA_SITES = _pragma_sites()


def test_pragma_sites_found():
    assert len(PRAGMA_SITES) >= 20
    assert sum(locklint.pragma_counts().values()) == len(PRAGMA_SITES)


@pytest.mark.parametrize("site", PRAGMA_SITES,
                         ids=["%s:%d" % s for s in PRAGMA_SITES])
def test_pragma_is_load_bearing(site):
    """Stripping one ``ok()`` pragma must re-surface a finding: a pragma
    that suppresses nothing is stale documentation."""
    rel, line = site
    lines = (default_root() / rel).read_text().splitlines(keepends=True)
    stripped = list(lines)
    stripped[line - 1] = _PRAGMA.sub("# stripped", lines[line - 1])
    before = lint_text("".join(lines), rel)
    after = lint_text("".join(stripped), rel)
    assert not before and len(after) > len(before), (rel, line)


def _lock_constructions(tree):
    """``threading.Lock``/``RLock`` references (called or passed as a
    factory) and ``from threading import Lock/RLock``."""
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in (
                "Lock", "RLock") and isinstance(node.value, ast.Name) \
                and node.value.id == "threading":
            bad.append(node.lineno)
        if isinstance(node, ast.ImportFrom) and node.module == "threading" \
                and {a.name for a in node.names} & {"Lock", "RLock"}:
            bad.append(node.lineno)
    return bad


def test_no_plain_locks_outside_lockdep():
    made = []
    for f in sorted(default_root().rglob("*.py")):
        rel = f.relative_to(default_root()).as_posix()
        tree = ast.parse(f.read_text())
        if rel != "analysis/lockdep.py":
            assert not _lock_constructions(tree), (rel,
                                                   _lock_constructions(tree))
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr in (
                    "make_lock", "make_rlock"):
                (arg,) = node.args
                made.append((rel, arg.value, node.func.attr))
    # every lock site of the port, each class registered and used
    assert len(made) == 13, made
    assert {cls for _, cls, _ in made} == set(inv.LOCK_RANKS)
    for rel, cls, how in made:
        assert inv.LOCK_GUARDS[cls][0] == rel, (rel, cls)
        assert (how == "make_rlock") == (cls in inv.REENTRANT_LOCKS), cls


def test_analysis_imports_only_the_standard_library():
    allowed = {"__future__", "argparse", "ast", "contextlib", "dataclasses",
               "json", "os", "pathlib", "re", "sys", "threading",
               "traceback"}
    for f in sorted((default_root() / "analysis").glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m in allowed or m.startswith(
                    "repro_torch.analysis"), (f.name, m)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})


def test_cli_exit_codes(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("def f():\n    return 1\n")
    sub = tmp_path / "core"
    sub.mkdir()
    dirty = sub / "engine.py"
    dirty.write_text(
        "class CTEngine:\n"
        "    def bad(self, t):\n"
        "        with self._lock:\n"
        "            t.item()\n")
    assert _cli(str(clean)).returncode == 0
    r = _cli(str(dirty))
    assert r.returncode == 1
    assert "block-under-lock" in r.stdout
    assert _cli(str(tmp_path / "missing.py")).returncode == 2


def test_cli_json_artifact(tmp_path):
    out = tmp_path / "analysis_findings.json"
    r = _cli("--fail-on-violation", "--json", str(out),
             str(SRC / "repro_torch"))
    assert r.returncode == 0, r.stdout + r.stderr
    payload = json.loads(out.read_text())
    assert payload["violations"] == 0 and payload["findings"] == []
    assert payload["files_scanned"] > 45
    assert set(payload["rules"]) == set(INVARIANTS)
    json.dumps(payload)
