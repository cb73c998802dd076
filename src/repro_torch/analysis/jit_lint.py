"""AST lint of the port's eager CUDA code: host syncs where none may be,
and host timers that time an enqueue. Mirrors
``src/repro/analysis/jit_lint.py``, porting what each rule checks (the
reference's rules guard ``@jax.jit`` bodies; a CUDA launch returns before
the card has run it, and a host read of a card value waits for it).

* ``timer-no-sync`` (the reference's rule) — a ``time.perf_counter()``
  section whose timed span contains no device sync times the launches'
  enqueue, not the work. Syncs are recognized lexically
  (``torch.cuda.synchronize``, an event's ``synchronize`` /
  ``elapsed_time``, ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``np.asarray`` / ``np.array``, builtin ``bool`` / ``int`` / ``float``
  coercions) and *propagated through the call graph*: a call to a
  function that itself syncs (resolvable top-level functions, ``from
  repro_torch.x import name`` imports, and ``self.`` methods) satisfies
  the span, so ``core/cv.py``'s ``_sync`` helper and ``svm/sources.py``'s
  ``_block`` count, while a call through an unresolvable receiver is not
  assumed to sync.

The port has no decorator that marks the bodies which must not sync the
host (the reference's jitted bodies): they are named in ``SYNC_FREE``,
the functions whose syncs ``set_sync_debug_mode("error")`` polices on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``). Three rules hold
inside them:

* ``host-sync-cast`` (<- ``traced-host-cast``) — ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``bool`` / ``int`` / ``float``
  of a tensor, and the ``torch.linalg`` calls that check their result on
  the host (``svd``, ``solve``, ...; their ``_ex`` forms do not).
* ``host-sync-branch`` (<- ``traced-python-branch``) — Python ``if`` /
  ``while`` on a tensor's value.
* ``data-dependent-shape`` (<- ``unsized-nonzero``) — ``torch.nonzero`` /
  ``.nonzero()``, one-argument ``torch.where``, ``masked_select``,
  ``unique``, and indexing by a boolean mask: each sizes its output from
  the data, so the host waits for it.

Taint model (the reference's): parameters are tensors unless a body's
``SYNC_FREE`` entry names them host values (``self`` always is: a
ledger's fields live on the host); taint flows through assignments, and
``shape`` / ``ndim`` / ``dtype`` / ``device`` / ``is_cuda``, ``numel()``
/ ``size()`` / ``dim()`` and ``len()`` un-taint. Nested functions
inherit the enclosing taint. A mask is a comparison, ``~`` / ``&`` /
``|`` / ``^`` of masks, ``isfinite`` / ``isnan`` / ``isinf`` /
``logical_*``, a name bound to one, or a parameter whose name holds
``mask``. The syncs the port makes on purpose (ATO's ``m_cap`` and stop
flag, MIR's SVD, a chunk's done flag) are findings, baselined with their
reason in ``results/lint_baseline_torch.json``.
"""
from __future__ import annotations

import ast
import pathlib

from repro_torch.analysis.findings import Report

PACKAGE = "repro_torch"

#: the bodies that must not sync the host: (path suffix, qualname) -> the
#: parameters that are host values (numbers, flags, sizes, names)
SYNC_FREE = {
    **{(f"{PACKAGE}/core/seeding.py", name): static for name, static in (
        ("repair_equality", ("C",)),
        ("_bias", ("C",)),
        ("scale_seed_C", ("C_old", "C_new")),
        ("cold_seed", ("C",)),
        ("_lstsq_svd", ()),
        ("mir_seed", ("C",)),
        ("sir_seed", ("C", "rng_key", "fallback")),
        ("_ato_step", ("tol", "m_cap", "max_steps", "carried")),
        ("_ato_ramp", ("tol", "m_cap", "max_steps", "chunk")),
        ("_transition_masks", ("n", "device")),
        ("ato_seed", ("C", "max_steps", "tol", "chunk")),
        ("ato_seed_batch", ("Cs", "max_steps", "tol", "bucket_by_lane",
                            "chunk")),
        ("avg_seed_loo", ("C", "t")),
        ("top_seed_loo", ("C", "t")),
        ("fold_transform", ("C", "method")),
        ("scale_C_transform", ("C", "C_old")),
        ("loo_avg_transform", ("C", "t")),
        ("loo_top_transform", ("C", "t")))},
    **{(f"{PACKAGE}/svm/shrink.py", name): static for name, static in (
        ("active_set", ("C",)),
        ("seed_active_mask", ("C",)),
        ("_gap_of", ("C",)),
        ("reconstruct_f", ("source",)),
        ("_place", ("cap",)),
        ("LaneShrink.enter", ("source",)),
        ("LaneShrink.scatter", ()),
        ("LaneShrink.tighten", ("m_new",)))},
    **{(f"{PACKAGE}/svm/engine.py", name): static for name, static in (
        ("chunk_batched", ("source", "Cs", "tol", "it_caps", "n_iters",
                           "wss")),
        ("chunk_batched_sources", ("sources", "Cs", "tol", "it_caps",
                                   "n_iters", "wss")),
        ("smo_chunk", ("source", "C", "n_iters", "wss", "tol", "it_cap")),
        ("init_state", ("source", "n_iter0")),
        ("finalize", ("C", "tol")),
        ("solve", ("source", "C", "tol", "max_iter", "wss", "chunk_iters",
                   "on_chunk", "n_iter0")),
        ("solve_batched", ("source", "Cs", "tol", "max_iter", "wss",
                           "chunk_iters", "on_chunk", "n_iter0s")))},
    # the MoE's dispatch and combine: the capacity comes from shapes
    **{(f"{PACKAGE}/models/moe.py", name): static for name, static in (
        ("_route", ("cfg",)),
        ("_aux_loss", ("cfg",)),
        ("capacity", ("cfg", "n_tokens")),
        ("_dispatch", ("n_experts", "cap")),
        ("_combine", ()),
        ("moe_apply", ("cfg", "act")),
        ("_moe_scatter", ("cfg", "act")))},
    # MLA's prefill and absorbed decode (``step`` is a host int)
    (f"{PACKAGE}/models/attention.py", "mla_apply"): (
        "cfg", "step", "window", "causal"),
}

#: attribute reads that yield host values
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "itemsize",
                "streams_rows", "fused", "n_rows"}
#: method calls that yield host values without a sync
STATIC_CALLS = {"numel", "size", "dim", "element_size", "data_ptr",
                "stride", "is_contiguous", "get_device"}

#: calls that force a sync when they appear in a timed span
_SYNC_CALL_NAMES = {"bool", "int", "float"}
_SYNC_ATTR_CALLS = {"synchronize", "elapsed_time", "item", "tolist", "cpu",
                    "numpy", "asarray", "array"}
#: a tensor's methods that copy it to the host
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
#: ``torch.linalg`` calls whose result is checked on the host
_LINALG_CHECKED = {"svd", "svdvals", "solve", "inv", "cholesky", "lstsq",
                   "eig", "eigh", "eigvals", "eigvalsh", "lu", "lu_factor",
                   "pinv", "matrix_rank", "det", "slogdet", "ldl_factor"}
#: calls whose output is sized by the data
_DATA_SHAPED = {"nonzero", "masked_select", "unique", "unique_consecutive",
                "argwhere"}
#: calls that return a boolean mask
_MASK_CALLS = {"isfinite", "isnan", "isinf", "isposinf", "isneginf",
               "logical_and", "logical_or", "logical_not", "logical_xor",
               "eq", "ne", "lt", "le", "gt", "ge", "bool"}


def _call_name(node: ast.Call):
    """(kind, name, receiver) of a call target: ("name", f, None) for
    ``f(...)``, ("attr", m, <expr>) for ``<expr>.m(...)``."""
    fn = node.func
    if isinstance(fn, ast.Name):
        return "name", fn.id, None
    if isinstance(fn, ast.Attribute):
        return "attr", fn.attr, fn.value
    return "other", None, None


def _is_linalg(recv) -> bool:
    return isinstance(recv, ast.Attribute) and recv.attr == "linalg" or \
        isinstance(recv, ast.Name) and recv.id == "linalg"


class _Taint:
    """Per-body state: names bound to (potentially) card tensors, and
    those bound to boolean masks."""

    def __init__(self, tainted: set[str], masks: set[str]):
        self.names = set(tainted)
        self.masks = set(masks)

    def expr_tainted(self, node: ast.expr) -> bool:
        """True when ``node`` may be a tensor on the card."""
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return False
            return self.expr_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.expr_tainted(node.value)
        if isinstance(node, ast.Call):
            kind, name, recv = _call_name(node)
            if kind == "name" and name in ("len", "int", "float", "bool",
                                           "range", "isinstance", "str"):
                return False
            if kind == "attr" and name in STATIC_CALLS | _HOST_METHODS:
                return False
            if kind == "name" and name == "getattr" and len(node.args) >= 2:
                a = node.args[1]
                if isinstance(a, ast.Constant) and a.value in STATIC_ATTRS:
                    return False
            return any(self.expr_tainted(a) for a in node.args) or \
                any(self.expr_tainted(kw.value) for kw in node.keywords) or \
                (kind == "attr" and recv is not None
                 and self.expr_tainted(recv))
        if isinstance(node, ast.BinOp):
            return self.expr_tainted(node.left) or \
                self.expr_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.expr_tainted(node.operand)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return self.expr_tainted(node.left) or \
                any(self.expr_tainted(c) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self.expr_tainted(v) for v in node.values)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.expr_tainted(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.expr_tainted(node.body) or \
                self.expr_tainted(node.orelse)
        if isinstance(node, ast.Starred):
            return self.expr_tainted(node.value)
        return False

    def is_mask(self, node: ast.expr) -> bool:
        """True when ``node`` is (by its form) a boolean mask."""
        if isinstance(node, ast.Compare):
            return not all(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                           ast.NotIn)) for op in node.ops)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op,
                                                         ast.Invert):
            return self.is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(node.left) or self.is_mask(node.right)
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.Call):
            return _call_name(node)[1] in _MASK_CALLS
        return False

    def assign(self, target: ast.expr, tainted: bool, mask: bool) -> None:
        for node in ast.walk(target):
            if isinstance(node, ast.Name):
                for group, on in ((self.names, tainted), (self.masks, mask)):
                    if on:
                        group.add(node.id)
                    else:
                        group.discard(node.id)


def _function_params(fn: ast.FunctionDef) -> list[str]:
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return names


def _lint_sync_free(fn: ast.FunctionDef, static, path, symbol,
                    report: Report) -> None:
    """Taint-based pass over one body that must not sync the host (nested
    defs and lambdas inherit the enclosing taint; their params are tensors
    too)."""
    params = [p for p in _function_params(fn)
              if p not in set(static) | {"self", "cls"}]
    taint = _Taint(set(params), {p for p in params if "mask" in p})

    def visit_block(stmts):
        for stmt in stmts:
            visit_stmt(stmt)

    def check_expr(node: ast.expr):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                check_call(sub)
            elif isinstance(sub, ast.Subscript):
                check_index(sub)

    def check_index(sub: ast.Subscript):
        index = sub.slice
        if taint.is_mask(index) and taint.expr_tainted(index):
            report.add("data-dependent-shape", path, symbol,
                       "indexing by a boolean mask sizes its output from "
                       "the data (the host waits): use torch.where, or "
                       "index_select over indices placed on the card",
                       line=sub.lineno)

    def check_call(sub: ast.Call):
        kind, name, recv = _call_name(sub)
        if kind == "attr" and name in _HOST_METHODS and recv is not None \
                and taint.expr_tainted(recv):
            report.add("host-sync-cast", path, symbol,
                       f"`.{name}()` of a card tensor waits for the card",
                       line=sub.lineno)
        if kind == "name" and name in ("float", "int", "bool") and \
                sub.args and taint.expr_tainted(sub.args[0]):
            report.add("host-sync-cast", path, symbol,
                       f"`{name}()` of a card tensor waits for the card",
                       line=sub.lineno)
        if kind == "attr" and name in _LINALG_CHECKED and _is_linalg(recv):
            report.add("host-sync-cast", path, symbol,
                       f"`torch.linalg.{name}` checks its result on the "
                       f"host (use `{name}_ex` where there is one)",
                       line=sub.lineno)
        data_shaped = name in _DATA_SHAPED and (
            kind == "name" or recv is not None and (
                taint.expr_tainted(recv) or isinstance(recv, ast.Name)
                and recv.id == "torch"))
        one_arg_where = name == "where" and len(sub.args) == 1 \
            and not sub.keywords
        if data_shaped or one_arg_where:
            report.add("data-dependent-shape", path, symbol,
                       f"`{name}` sizes its output from the data (the host "
                       "waits for it)", line=sub.lineno)

    def visit_stmt(stmt):
        if isinstance(stmt, ast.FunctionDef):
            saved = (taint.names, taint.masks)
            taint.names = set(taint.names) | set(_function_params(stmt))
            taint.masks = set(taint.masks)
            visit_block(stmt.body)
            taint.names, taint.masks = saved
            return
        if isinstance(stmt, (ast.If, ast.While)):
            if taint.expr_tainted(stmt.test):
                report.add("host-sync-branch", path, symbol,
                           "Python control flow on a card tensor's value "
                           "waits for the card (keep the flag on the "
                           "device: torch.where)", line=stmt.lineno)
            check_expr(stmt.test)
            visit_block(stmt.body)
            visit_block(stmt.orelse)
            return
        if isinstance(stmt, ast.For):
            check_expr(stmt.iter)
            taint.assign(stmt.target, taint.expr_tainted(stmt.iter), False)
            visit_block(stmt.body)
            visit_block(stmt.orelse)
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            for t in targets:
                if not isinstance(t, ast.Name):
                    check_expr(t)
            if value is not None:
                check_expr(value)
                tainted = taint.expr_tainted(value)
                mask = taint.is_mask(value)
                for t in targets:
                    if isinstance(stmt, ast.AugAssign):
                        taint.assign(t, tainted or taint.expr_tainted(t),
                                     mask or taint.is_mask(t))
                    else:
                        taint.assign(t, tainted, mask)
            return
        if isinstance(stmt, (ast.Return, ast.Expr)):
            if stmt.value is not None:
                check_expr(stmt.value)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                check_expr(item.context_expr)
            visit_block(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            for block in (stmt.body, stmt.orelse, stmt.finalbody,
                          *(h.body for h in stmt.handlers)):
                visit_block(block)
            return
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.expr):
                check_expr(node)

    visit_block(fn.body)


# --------------------------------------------------------- timer sections

def _contains_sync(node: ast.AST, resolve) -> bool:
    """A lexical sync inside ``node``, or a call to a resolvable function
    known (transitively) to sync. ``resolve(call) -> bool``."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        kind, name, recv = _call_name(sub)
        if kind == "attr" and name in _SYNC_ATTR_CALLS:
            return True
        if kind == "name" and name in _SYNC_CALL_NAMES and sub.args:
            return True
        if resolve is not None and resolve(sub):
            return True
    return False


def _is_perf_counter(node: ast.expr) -> bool:
    return isinstance(node, ast.Call) and \
        _call_name(node)[1] == "perf_counter"


def _timer_sections(body: list[ast.stmt]):
    """Yield (var, open_stmt, span_stmts, close_stmt) for every
    ``t = time.perf_counter()`` ... ``... perf_counter() - t ...`` pair
    found in the same statement block; nested blocks are scanned
    recursively."""
    for i, stmt in enumerate(body):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                _is_perf_counter(stmt.value):
            var = stmt.targets[0].id
            for j in range(i + 1, len(body)):
                close = body[j]
                if _closes_timer(close, var):
                    yield var, stmt, body[i + 1:j], close
                    break
    for stmt in body:
        for block in _child_blocks(stmt):
            yield from _timer_sections(block)


def _closes_timer(stmt: ast.stmt, var: str) -> bool:
    """A statement that reads ``perf_counter() - var``."""
    for node in ast.walk(stmt):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub) \
                and _is_perf_counter(node.left) \
                and any(isinstance(n, ast.Name) and n.id == var
                        for n in ast.walk(node.right)):
            return True
    return False


def _child_blocks(stmt: ast.stmt):
    for field in ("body", "orelse", "finalbody"):
        block = getattr(stmt, field, None)
        if block:
            yield block
    for handler in getattr(stmt, "handlers", ()):
        yield handler.body


# ------------------------------------------------------------- call graph

class _Module:
    def __init__(self, path: pathlib.Path, rel: str):
        self.path = path
        self.rel = rel
        self.tree = ast.parse(path.read_text(), filename=str(path))
        #: {qualname: FunctionDef} — "f" top-level, "Cls.m" methods
        self.functions: dict[str, ast.FunctionDef] = {}
        #: {local name: (module, name)} for ``from repro_torch.x import
        #: name``, at any depth (the port imports lazily inside functions)
        self.imports: dict[str, tuple[str, str]] = {}
        for node in self.tree.body:
            if isinstance(node, ast.FunctionDef):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef):
                        self.functions[f"{node.name}.{item.name}"] = item
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.split(".")[0] == PACKAGE:
                for alias in node.names:
                    self.imports[alias.asname or alias.name] = \
                        (node.module, alias.name)


def _build_sync_map(modules: list[_Module]) -> dict[tuple, bool]:
    """Fixpoint: (module path, qualname) -> "this function syncs", where
    a function syncs if its body contains a lexical sync or a resolvable
    call to a syncing function."""
    syncs: dict[tuple, bool] = {(m.rel, q): False
                                for m in modules for q in m.functions}
    changed = True
    while changed:
        changed = False
        for m in modules:
            for qual, fn in m.functions.items():
                if syncs[(m.rel, qual)]:
                    continue
                resolve = _resolver(m, qual, syncs)
                if _contains_sync(fn, resolve):
                    syncs[(m.rel, qual)] = True
                    changed = True
    return syncs


def _resolver(mod: _Module, qual: str, syncs: dict):
    """``resolve(call)``: does ``call`` (inside ``qual``) reach a function
    known to sync?"""
    cls = qual.split(".")[0] if "." in qual else None

    def resolve(call: ast.Call) -> bool:
        kind, name, recv = _call_name(call)
        if kind == "name":
            if name in mod.functions:
                return syncs.get((mod.rel, name), False)
            if name in mod.imports:
                return _imported_syncs(syncs, mod.imports[name])
        elif kind == "attr" and isinstance(recv, ast.Name) and \
                recv.id == "self" and cls is not None:
            return syncs.get((mod.rel, f"{cls}.{name}"), False)
        return False
    return resolve


def _imported_syncs(syncs: dict, target: tuple[str, str]) -> bool:
    """Does ``from <module> import <name>`` resolve to a syncing
    function? Matched by qualname + module path suffix."""
    src_mod, src_name = target
    suffix = src_mod.replace(".", "/") + ".py"
    for (rel, qual), ok in syncs.items():
        if qual == src_name and rel.replace("\\", "/").endswith(suffix):
            return ok
    return False


# -------------------------------------------------------------- entry point

def lint_paths(paths, *, repo_root=None, sync_free=None) -> Report:
    """Run the four rules over ``paths`` (.py files). The timer rule's
    call-graph propagation resolves across every file in the SAME
    invocation, so lint the package set together. ``sync_free`` maps
    (path suffix, qualname) to a body's host-value parameters (default
    ``SYNC_FREE``)."""
    repo_root = pathlib.Path(repo_root) if repo_root else None
    sync_free = SYNC_FREE if sync_free is None else sync_free
    modules = []
    for p in paths:
        p = pathlib.Path(p)
        rel = str(p.relative_to(repo_root)) if repo_root and \
            p.is_relative_to(repo_root) else str(p)
        modules.append(_Module(p, rel))
    syncs = _build_sync_map(modules)
    report = Report()
    for m in modules:
        _lint_module(m, syncs, sync_free, report)
    return report


def _lint_module(mod: _Module, syncs: dict, sync_free: dict,
                 report: Report) -> None:
    where = str(mod.path).replace("\\", "/")
    for (suffix, qual), static in sync_free.items():
        if where.endswith(suffix) and qual in mod.functions:
            _lint_sync_free(mod.functions[qual], static, mod.rel, qual,
                            report)

    for qual, fn in mod.functions.items():
        resolve = _resolver(mod, qual, syncs)
        for var, open_stmt, span, close in _timer_sections(fn.body):
            if not span:
                continue
            if any(_contains_sync(s, resolve) for s in span):
                continue
            report.add("timer-no-sync", mod.rel, qual,
                       f"perf_counter section `{var}` (line "
                       f"{open_stmt.lineno}) times a span with no "
                       "device sync — it measures the launches' enqueue, "
                       "not the work (add torch.cuda.synchronize or a "
                       "host read inside the span)",
                       line=open_stmt.lineno, severity="error")
