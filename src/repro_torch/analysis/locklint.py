"""AST-based static checker for the port's registry invariants.

The reference's pass (``repro.analysis.locklint``) on the port's names.
Two passes per module:

1. **Summary pass**: for every function, collect the lock classes it
   acquires directly (``with`` items classified through
   :func:`invariants.classify_lock`, by file and enclosing class), the
   lock classes its external calls acquire
   (:func:`invariants.external_call_effects`), and the local calls it
   makes (``self.m(...)`` -> same-class method, bare ``f(...)`` ->
   module function).  A fixpoint then yields each function's
   *transitive* acquisition set, so "holding a leaf lock while calling
   something that takes the engine lock" is caught even when the engine
   lock is two calls away.

2. **Check pass**: re-walk every function with a held-lock stack
   (seeded from ``# ctlint: holds(<lock>)`` annotations for the
   ``*_locked`` helper convention) and emit findings for the rules in
   :data:`invariants.INVARIANTS`.

The left-fold kernels' bodies are CUDA in the port, so
``bit-identity-reassoc`` also scans the CUDA sources of that path, and
those of row 10's backward, whose gradient is the same bits from run to
run (:data:`invariants.BIT_CRITICAL_CUDA_SOURCES`), for atomic adds,
comments stripped.

Findings are suppressed by ``# ctlint: ok(<rule>[,<rule>...])`` (``//``
in CUDA) on the offending line or the line directly above it.

The public entry points are :func:`lint_text` (used by the rule corpus
in ``tests/test_torch_analysis.py``), :func:`lint_file` and
:func:`lint_paths` (used by the CLI).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from repro_torch.analysis import invariants as inv
from repro_torch.analysis.report import Finding

_PRAGMA_OK = re.compile(r"(?:#|//)\s*ctlint:\s*ok\(([^)]*)\)")
_PRAGMA_HOLDS = re.compile(r"#\s*ctlint:\s*holds\(([^)]*)\)")


def _unparse(node):
    try:
        return ast.unparse(node)
    except Exception:
        return "<expr>"


def _call_parts(call):
    """Split a Call into (receiver, name).

    ``host.engine.register(...)`` -> ("host.engine", "register");
    ``register(...)`` -> ("", "register"); anything else -> (expr, "").
    """
    func = call.func
    if isinstance(func, ast.Attribute):
        return _unparse(func.value), func.attr
    if isinstance(func, ast.Name):
        return "", func.id
    return _unparse(func), ""


def _names_in(node):
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _own_nodes(node):
    """Descendants of ``node`` excluding nested function/lambda bodies
    (those run later, under whatever locks hold at CALL time — they
    are summarized and checked as functions of their own)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        stack.extend(ast.iter_child_nodes(child))


class _FunctionInfo:
    """Pass-1 summary for one function."""

    def __init__(self, qualname):
        self.qualname = qualname
        self.direct_locks = set()     # classes acquired via `with`
        self.external_locks = set()   # classes acquired via ext calls
        self.local_calls = set()      # resolved local callee qualnames
        self.blocks = False           # blocking primitive / ext call
        self.dispatches = False       # device-dispatch call
        self.trans_locks = set()      # fixpoint results
        self.trans_blocks = False
        self.trans_dispatches = False


class _Module:
    def __init__(self, source, path):
        self.path = path.replace("\\", "/")
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        self.ok_pragmas = {}      # line -> set of rule ids
        self.holds_pragmas = {}   # line -> set of lock classes
        for i, line in enumerate(self.lines, start=1):
            m = _PRAGMA_OK.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",")}
                self.ok_pragmas[i] = {r for r in rules if r}
            m = _PRAGMA_HOLDS.search(line)
            if m:
                locks = {r.strip() for r in m.group(1).split(",")}
                self.holds_pragmas[i] = {r for r in locks if r}
        # Names passed as callbacks to retry wrappers (`*.run(fn)`)
        # are treated as repeatable for the donate-reuse rule.
        self.retry_wrapped = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                _, name = _call_parts(node)
                if name == "run":
                    for arg in node.args:
                        if isinstance(arg, ast.Name):
                            self.retry_wrapped.add(arg.id)

    def suppressed(self, rule, line):
        for ln in (line, line - 1):
            if rule in self.ok_pragmas.get(ln, ()):  # exact rule only
                return True
        return False

    def holds_for_def(self, func_node):
        """Lock classes declared held-on-entry for this function."""
        first_body = func_node.body[0].lineno if func_node.body else \
            func_node.lineno
        held = set()
        for ln in range(func_node.lineno, first_body + 1):
            held |= self.holds_pragmas.get(ln, set())
        return held


def _iter_functions(tree):
    """Yield (qualname, class_name, node) for every def in a module."""

    def walk(node, class_name, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, child.name,
                                prefix + child.name + ".")
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                yield prefix + child.name, class_name, child
                yield from walk(child, class_name,
                                prefix + child.name + ".")
            else:
                yield from walk(child, class_name, prefix)

    yield from walk(tree, None, "")


def _summarize(mod):
    """Pass 1: per-function summaries + transitive fixpoint."""
    infos = {}
    for qualname, class_name, node in _iter_functions(mod.tree):
        info = _FunctionInfo(qualname)
        infos[qualname] = info
        for child in _own_nodes(node):
            if isinstance(child, ast.With):
                for item in child.items:
                    got = inv.classify_lock(
                        mod.path, _unparse(item.context_expr), class_name)
                    if got is not None:
                        info.direct_locks.add(got[0])
            elif isinstance(child, ast.Call):
                receiver, name = _call_parts(child)
                acquires, blocks = inv.external_call_effects(
                    receiver, name)
                if acquires is not None:
                    info.external_locks.add(acquires)
                # A `# ctlint: ok(...)` pragma at the site means the
                # blocking/dispatch there is intentional; it must not
                # re-surface at every (transitive) caller, so pragma'd
                # sites are excluded from the summary.
                if (blocks or (name in inv.BLOCKING_CALL_NAMES
                               and not (name == "join" and child.args))) \
                        and not mod.suppressed(
                            "block-under-lock", child.lineno):
                    info.blocks = True
                if name in inv.DISPATCH_CALL_NAMES \
                        and not mod.suppressed(
                            "dispatch-under-lock", child.lineno):
                    info.dispatches = True
                if receiver == "self" and class_name is not None:
                    info.local_calls.add(
                        "%s.%s" % (class_name, name))
                elif receiver == "":
                    info.local_calls.add(name)
    # Fixpoint over local calls.
    for info in infos.values():
        info.trans_locks = set(info.direct_locks) | info.external_locks
        info.trans_blocks = info.blocks
        info.trans_dispatches = info.dispatches
    changed = True
    while changed:
        changed = False
        for info in infos.values():
            for callee in info.local_calls:
                other = infos.get(callee)
                if other is None:
                    continue
                before = (len(info.trans_locks), info.trans_blocks,
                          info.trans_dispatches)
                info.trans_locks |= other.trans_locks
                info.trans_blocks |= other.trans_blocks
                info.trans_dispatches |= other.trans_dispatches
                if (len(info.trans_locks), info.trans_blocks,
                        info.trans_dispatches) != before:
                    changed = True
    return infos


class _Checker:
    """Pass 2: walk one function body with a held-lock stack."""

    def __init__(self, mod, infos, findings):
        self.mod = mod
        self.infos = infos
        self.findings = findings

    def emit(self, rule, line, message):
        if not self.mod.suppressed(rule, line):
            self.findings.append(Finding(
                rule=rule, path=self.mod.path, line=line,
                message=message))

    def check_function(self, qualname, class_name, node):
        held = [(cls, node.lineno)
                for cls in sorted(self.mod.holds_for_def(node))]
        self.fname = qualname.rsplit(".", 1)[-1]
        self.class_name = class_name
        self.repeatable = self.fname in self.mod.retry_wrapped
        self.guard_lines = []
        self.loop_targets = []
        self._walk_body(node.body, held)

    # ---- helpers -------------------------------------------------

    def _held_classes(self, held):
        return {cls for cls, _ in held}

    def _max_held_rank(self, held):
        ranks = [inv.LOCK_RANKS[c] for c in self._held_classes(held)
                 if c in inv.LOCK_RANKS]
        return max(ranks) if ranks else None

    def _order_violation(self, new_cls, held):
        """Held lock (if any) that forbids acquiring ``new_cls``."""
        new_rank = inv.LOCK_RANKS.get(new_cls)
        if new_rank is None:
            return None
        for cls, line in held:
            if cls == new_cls:
                if new_cls in inv.REENTRANT_LOCKS:
                    continue
                return cls
            rank = inv.LOCK_RANKS.get(cls)
            if rank is not None and new_rank <= rank:
                return cls
        return None

    # ---- statement walk ------------------------------------------

    def _walk_body(self, stmts, held):
        for stmt in stmts:
            self._walk_stmt(stmt, held)

    def _walk_stmt(self, stmt, held):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # analyzed separately, with its own held set
        if isinstance(stmt, ast.With):
            pushed = 0
            for item in stmt.items:
                expr = _unparse(item.context_expr)
                got = inv.classify_lock(self.mod.path, expr,
                                        self.class_name)
                if got is None:
                    self._walk_expr(item.context_expr, held)
                    continue
                cls, _is_cond = got
                bad = self._order_violation(cls, held)
                if bad is not None:
                    self.emit(
                        "lock-order", stmt.lineno,
                        "acquiring %r (rank %s) while holding %r "
                        "(rank %s) inverts the documented order" % (
                            cls, inv.LOCK_RANKS.get(cls), bad,
                            inv.LOCK_RANKS.get(bad)))
                held.append((cls, stmt.lineno))
                pushed += 1
            self._walk_body(stmt.body, held)
            for _ in range(pushed):
                held.pop()
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._walk_expr(stmt.iter, held)
            self.loop_targets.append(_names_in(stmt.target))
            self._walk_body(stmt.body, held)
            self._walk_body(stmt.orelse, held)
            self.loop_targets.pop()
            return
        if isinstance(stmt, ast.While):
            self._walk_expr(stmt.test, held)
            self.loop_targets.append(set())
            self._walk_body(stmt.body, held)
            self._walk_body(stmt.orelse, held)
            self.loop_targets.pop()
            return
        if isinstance(stmt, ast.Try):
            self._walk_body(stmt.body, held)
            for handler in stmt.handlers:
                self._walk_body(handler.body, held)
            self._walk_body(stmt.orelse, held)
            self._walk_body(stmt.finalbody, held)
            return
        if isinstance(stmt, ast.If):
            self._walk_expr(stmt.test, held)
            self._walk_body(stmt.body, held)
            self._walk_body(stmt.orelse, held)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._walk_expr(child, held)
            elif isinstance(child, ast.stmt):
                self._walk_stmt(child, held)

    # ---- expression walk -----------------------------------------

    def _walk_expr(self, expr, held):
        if isinstance(expr, ast.Lambda):
            return  # deferred body; runs outside this lock region
        if isinstance(expr, ast.Call):
            self._check_call(expr, held)
        for child in ast.iter_child_nodes(expr):
            self._walk_expr(child, held)

    def _check_call(self, call, held):
        receiver, name = _call_parts(call)
        line = call.lineno
        held_classes = self._held_classes(held)
        if name in inv.DONATION_GUARDS:
            self.guard_lines.append(line)

        # Condition wait/notify discipline.
        got = inv.classify_lock(self.mod.path, receiver, self.class_name)
        is_cond = got is not None and got[1]
        if name in ("wait", "wait_for"):
            if is_cond:
                owner = got[0]
                if owner not in held_classes:
                    self.emit(
                        "wait-wrong-lock", line,
                        "%s.%s() without holding its owning %r "
                        "lock" % (receiver, name, owner))
                extra = held_classes - {owner}
                if extra:
                    self.emit(
                        "block-under-lock", line,
                        "waiting on %r releases only its own lock; "
                        "%s stay held" % (owner, sorted(extra)))
            elif held_classes:
                self.emit(
                    "block-under-lock", line,
                    "%s.wait() blocks while holding %s" % (
                        receiver, sorted(held_classes)))
            return
        if name in ("notify", "notify_all") and is_cond:
            owner = got[0]
            if owner not in held_classes:
                self.emit(
                    "notify-outside-lock", line,
                    "%s.%s() without holding its owning %r lock "
                    "races the waiter's predicate" % (
                        receiver, name, owner))
            return

        # Blocking submits under the cluster lock.
        if ("cluster" in held_classes
                and name in inv.CLUSTER_SUBMIT_METHODS
                and receiver.endswith("engine")):
            if not self._has_block_false(call):
                self.emit(
                    "blocking-submit-under-lock", line,
                    "%s.%s(...) under the cluster lock must pass "
                    "block=False so saturation surfaces as "
                    "EngineSaturated" % (receiver, name))
            return

        # Direct blocking / dispatch primitives.  `join` is only a
        # thread join when called with no positional args (otherwise
        # it's os.path.join / str.join).
        if name == "join" and call.args:
            return
        if held_classes and name in inv.BLOCKING_CALL_NAMES:
            self.emit(
                "block-under-lock", line,
                "blocking call %s.%s() while holding %s" % (
                    receiver or "<module>", name,
                    sorted(held_classes)))
        if held_classes and name in inv.DISPATCH_CALL_NAMES:
            self.emit(
                "dispatch-under-lock", line,
                "device dispatch %s() while holding %s" % (
                    name, sorted(held_classes)))

        # External summaries (engine/store/future methods).
        acquires, blocks = inv.external_call_effects(receiver, name)
        if acquires is not None and held:
            bad = self._order_violation(acquires, held)
            if bad is not None:
                self.emit(
                    "lock-order-call", line,
                    "%s.%s() acquires %r (rank %s) while %r "
                    "(rank %s) is held" % (
                        receiver, name, acquires,
                        inv.LOCK_RANKS.get(acquires), bad,
                        inv.LOCK_RANKS.get(bad)))
        if blocks and held_classes:
            self.emit(
                "block-under-lock", line,
                "%s.%s() can block (drain/device/disk) while "
                "holding %s" % (receiver, name,
                                sorted(held_classes)))

        # Local calls: transitive acquisitions from the summaries.
        callee = None
        if receiver == "self" and self.class_name is not None:
            callee = self.infos.get(
                "%s.%s" % (self.class_name, name))
        elif receiver == "":
            callee = self.infos.get(name)
        if callee is not None and held:
            for cls in sorted(callee.trans_locks):
                bad = self._order_violation(cls, held)
                if bad is not None:
                    self.emit(
                        "lock-order-call", line,
                        "%s() transitively acquires %r (rank %s) "
                        "while %r (rank %s) is held" % (
                            name, cls, inv.LOCK_RANKS.get(cls),
                            bad, inv.LOCK_RANKS.get(bad)))
            # Transitive blocking/dispatch: a helper that blocks or
            # dispatches (directly or through its own callees) called
            # with a lock held.  Names in the primitive sets were
            # already flagged above.
            if callee.trans_blocks \
                    and name not in inv.BLOCKING_CALL_NAMES:
                self.emit(
                    "block-under-lock", line,
                    "%s() transitively blocks (drain/device/disk) "
                    "while holding %s" % (
                        name, sorted(held_classes)))
            if callee.trans_dispatches \
                    and name not in inv.DISPATCH_CALL_NAMES:
                self.emit(
                    "dispatch-under-lock", line,
                    "%s() transitively dispatches device work while "
                    "holding %s" % (name, sorted(held_classes)))

        # Donation safety.
        if name in inv.DONATING_CALLS:
            self._check_donate(call, line)

        # Bit-identity: reassociating or unordered reductions on scatter
        # paths.  Bare builtin `sum(...)` over host-side spec/shape ints
        # is fine; the hazard is the tensor forms (torch.sum, x.sum(),
        # acc.index_add_) plus the unambiguous bare names.
        is_reassoc = (
            name in inv.FORBIDDEN_REASSOC_NAMES
            and (isinstance(call.func, ast.Attribute)
                 or name in ("psum", "segment_sum", "logsumexp")))
        if (is_reassoc
                and self.fname.startswith(
                    inv.BIT_CRITICAL_FUNC_PREFIXES)):
            self.emit(
                "bit-identity-reassoc", line,
                "%s() reassociates inside %s(), which is on the "
                "left-fold scatter path and must stay "
                "bit-identical" % (name, self.fname))

    def _has_block_false(self, call):
        for kw in call.keywords:
            if kw.arg == "block":
                v = kw.value
                return isinstance(v, ast.Constant) and v.value is False
        return False

    def _check_donate(self, call, line):
        args = call.args
        payload = args[inv.DONATED_ARG_INDEX] \
            if len(args) > inv.DONATED_ARG_INDEX else None
        in_loop = bool(self.loop_targets)
        loop_derived = False
        if in_loop and payload is not None:
            names = _names_in(payload)
            loop_derived = any(names & t for t in self.loop_targets)
        repeatable = self.repeatable or (in_loop and not loop_derived)
        if not repeatable:
            return
        guarded = any(g < line for g in self.guard_lines)
        if not guarded:
            why = ("retry-wrapped function" if self.repeatable
                   else "loop with a loop-invariant payload")
            self.emit(
                "donate-reuse", line,
                "donating dispatch in a %s without a preceding "
                "_check_not_donated()/storage_released() guard; "
                "the donated grid's storage is released by the "
                "first dispatch" % why)


def _strip_cuda_comments(source):
    """``source`` with its ``//`` and ``/* */`` comments blanked (line
    breaks kept, so lines keep their numbers); string literals, where
    inline PTX lives, are kept."""
    def blank(m):
        text = m.group(0)
        if text.startswith('"'):
            return text
        return re.sub(r"[^\n]", " ", text)
    return re.sub(r'"(?:\\.|[^"\\\n])*"|//[^\n]*|/\*.*?\*/', blank, source,
                  flags=re.S)


def _is_fold_cuda_source(path):
    return any(path.endswith(s) for s in inv.BIT_CRITICAL_CUDA_SOURCES)


def lint_cuda_text(source, path):
    """``bit-identity-reassoc`` over a CUDA source on the left-fold path
    (others are not scanned): every atomic add, in C++ or inline PTX,
    outside comments."""
    if not _is_fold_cuda_source(path):
        return []
    ok = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_OK.search(line)
        if m:
            ok[i] = {r.strip() for r in m.group(1).split(",")}
    rule = "bit-identity-reassoc"
    findings = []
    for i, line in enumerate(_strip_cuda_comments(source).splitlines(),
                             start=1):
        m = re.search(inv.CUDA_ATOMIC_ADD_PATTERN, line)
        if m is None or rule in ok.get(i, ()) or rule in ok.get(i - 1, ()):
            continue
        findings.append(Finding(
            rule=rule, path=path, line=i,
            message="%r is an atomic add in a CUDA source whose sums "
                    "run in a fixed order: the adds of one slot would run "
                    "in no fixed order" % m.group(0).strip()))
    return findings


def lint_text(source, path):
    """Lint a source string as if it lived at ``path``.

    ``path`` picks the lock-classification rules (e.g. pass
    ``core/engine.py`` to get the engine patterns); a ``.cu``/``.cuh``
    path is scanned as CUDA (:func:`lint_cuda_text`).  Returns a list of
    :class:`Finding`.
    """
    path = path.replace("\\", "/")
    if path.endswith((".cu", ".cuh")):
        return lint_cuda_text(source, path)
    mod = _Module(source, path)
    infos = _summarize(mod)
    findings = []
    checker = _Checker(mod, infos, findings)
    for qualname, class_name, node in _iter_functions(mod.tree):
        checker.check_function(qualname, class_name, node)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_file(path):
    p = Path(path)
    return lint_text(p.read_text(), p.as_posix())


def default_root():
    """The ``src/repro_torch`` package directory this module lives in."""
    return Path(__file__).resolve().parents[1]


def iter_source_files(paths):
    """The Python files under ``paths``, and the CUDA sources of the
    left-fold path among them; a file named on its own is kept."""
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            yield from sorted(
                f for f in p.rglob("*")
                if "__pycache__" not in f.parts and f.is_file()
                and (f.suffix == ".py"
                     or _is_fold_cuda_source(f.as_posix())))
        else:
            yield p


def pragma_counts(paths=None):
    """The ``ctlint: ok(...)`` pragmas in the files under ``paths``
    (default: the whole package), by rule id: a pragma naming two rules
    counts once for each (the docstrings' examples name none)."""
    counts = {}
    for f in iter_source_files(paths or [default_root()]):
        for m in _PRAGMA_OK.finditer(Path(f).read_text()):
            for rule in (r.strip() for r in m.group(1).split(",")):
                if rule in inv.INVARIANTS:
                    counts[rule] = counts.get(rule, 0) + 1
    return dict(sorted(counts.items()))


def lint_paths(paths=None):
    """Lint files/directories; defaults to the whole package."""
    if not paths:
        paths = [default_root()]
    findings = []
    files = list(iter_source_files(paths))
    for f in files:
        findings.extend(lint_file(f))
    return findings, files
