"""Static checks on the port's hand-written launches: the Python wrappers in
``kernels/*.py`` (read with ``ast``) and the CUDA sources in
``kernels/csrc/*.cu`` / ``*.cuh`` (read as text). Needs neither ``nvcc``
nor a card. Mirrors ``src/repro/analysis/kernel_lint.py``, porting what
each rule checks from Pallas launchers to CUDA launches:

* ``device-contract`` (<- ``auto-interpret-contract``) — a wrapper that
  reaches a launch (``_build.entry`` called with ``_build.stream_ptr``;
  a query of the card passes no stream) runs its plain version (``kernels/ref.py``)
  only in a branch taken on the CPU (a ``.device.type == "cpu"`` test, or
  a helper that makes one), raises on any other device (a ``raise`` under
  a test of ``cuda``, in it or in a module function it calls), passes the entry's return code to
  ``_build.check``, and has no ``try`` whose handler reaches a plain
  version (a silent fallback from the card to the CPU code).
* ``grid-tail`` (<- ``block-divisibility``) — a grid extent that divides a
  size by a block constant (a ``dim3 grid(...)``, a ``<<<...>>>`` grid,
  ``cfg.gridDim``; in Python an assignment to a ``*grid*`` / ``*blocks*``
  name) must round up (``(n + B - 1) / B``, ``-(-n // B)``): a floor
  division drops the tail.
* ``smem-footprint`` (<- ``vmem-footprint``) — a launch whose dynamic
  shared memory can pass 48 KB (its request resolves to a constant above
  it, or to no constant) must first set ``cudaFuncAttributeMaxDynamicSharedMemorySize``
  on that kernel (earlier in the source: directly, or through a helper that sets it on its
  kernel argument), and every request that resolves to a constant (a
  launch's, an attribute's) stays within sm_90's ``SMEM_LIMIT_BYTES`` a
  block. Requests that resolve to no constant are not sized, as the
  reference skips full-array blocks.
* ``acc-dtype`` (<- ``acc-dtype-promotion``) — a kernel that takes
  ``double`` operands accumulates in ``double``: a ``float`` that is
  summed into (``+=`` / ``-=``) there is flagged (bf16 attention's f32
  online softmax takes no double, so it is not); and, the counterpart of
  ``preferred_element_type``, no port module turns on TF32
  (``allow_tf32 = True``, ``set_float32_matmul_precision("high" |
  "medium")``).
"""
from __future__ import annotations

import ast
import pathlib
import re

from repro_torch.analysis.findings import Report

#: sm_90's most shared memory a block may take (227 KB)
SMEM_LIMIT_BYTES = 232_448
#: what a launch may take without opting in
SMEM_DEFAULT_BYTES = 48 * 1024
#: names that are block constants in a grid expression: ALL_CAPS, ``kName``,
#: optionally qualified (``wg::BQ``, ``C::BQ``), or an integer literal
_BLOCK_CONST = re.compile(r"^(?:\w+::)*(?:k[A-Z]\w*|[A-Z][A-Z0-9_]*)$|^\d+$")
_SIZEOF = {"float": 4, "double": 8, "int": 4, "unsigned": 4, "bf16": 2,
           "__nv_bfloat16": 2, "long long": 8, "size_t": 8, "int2": 8,
           "char": 1, "unsigned char": 1, "bool": 1}


# ------------------------------------------------------------ Python side

def _call_name(node: ast.Call):
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _calls(node, name):
    return [s for s in ast.walk(node)
            if isinstance(s, ast.Call) and _call_name(s) == name]


def _plain_names(tree: ast.Module) -> set[str]:
    """Names bound to plain versions: imported from ``kernels.ref``."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.endswith("kernels.ref"):
            out.update(a.asname or a.name for a in node.names)
    return out


def _is_plain_call(node: ast.Call, plain: set[str]) -> bool:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id in plain or fn.id.endswith("_ref")
    return isinstance(fn, ast.Attribute) and (
        fn.attr.endswith("_ref") or isinstance(fn.value, ast.Name)
        and fn.value.id == "ref")


def _mentions(node: ast.AST, *words) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and sub.value in words:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in words:
            return True
    return False


def _cpu_tests(fn: ast.FunctionDef, helpers: set[str]):
    """``if`` statements of ``fn`` taken on the CPU: a test that compares
    with "cpu", or ``not <helper>(...)`` of a helper that returns False
    there."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        test = node.test
        if _mentions(test, "cpu"):
            yield node
        elif isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
                and isinstance(test.operand, ast.Call) and \
                _call_name(test.operand) in helpers:
            yield node


def _device_helpers(tree: ast.Module) -> set[str]:
    """Module functions that test a tensor for the CPU and raise on any
    other device but CUDA (``kernels/seeding.py::_device``)."""
    out = set()
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and _mentions(node, "cpu") \
                and _raises_off_cuda(node):
            out.add(node.name)
    return out


def _raises_off_cuda(fn: ast.FunctionDef) -> bool:
    """A ``raise`` under an ``if`` whose test reads ``cuda``."""
    for node in ast.walk(fn):
        if isinstance(node, ast.If) and _mentions(
                node.test, "cuda", "is_cuda") and \
                any(isinstance(s, ast.Raise) for b in node.body
                    for s in ast.walk(b)):
            return True
    return False


def _closure(tree: ast.Module, seed) -> dict[str, bool]:
    """{top-level function: ``seed(fn)`` holds for it or for a module
    function it calls or names (transitively)}."""
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    hold = {name: bool(seed(fn)) for name, fn in fns.items()}
    changed = True
    while changed:
        changed = False
        for name, fn in fns.items():
            if hold[name]:
                continue
            named = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
            named |= {_call_name(c) for c in ast.walk(fn)
                      if isinstance(c, ast.Call)}
            if any(hold.get(c) for c in named if c != name):
                hold[name] = changed = True
    return hold


def _lint_wrappers(tree: ast.Module, rel: str, report: Report) -> None:
    plain = _plain_names(tree)
    helpers = _device_helpers(tree)
    # a launch passes the stream; a query of the card (a plan, a build's
    # registers) calls an entry without one and is no wrapper
    reach = _closure(tree, lambda fn: _calls(fn, "entry")
                     and _calls(fn, "stream_ptr"))
    raises = _closure(tree, _raises_off_cuda)
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and _calls(fn, "entry") and \
                not _calls(fn, "check"):
            report.add("device-contract", rel, fn.name,
                       "calls _build.entry but never passes the entry's "
                       "return code to _build.check: a failed launch "
                       "would go unnoticed", line=fn.lineno)
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or not reach.get(fn.name):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Try) and any(
                    _is_plain_call(c, plain) for h in node.handlers
                    for c in ast.walk(h) if isinstance(c, ast.Call)):
                report.add("device-contract", rel, fn.name,
                           "a `try` whose handler runs a plain version: a "
                           "silent fallback from the card to the CPU code",
                           line=node.lineno)
        if fn.name.startswith("_"):
            continue      # a launch helper; its wrapper holds the contract
        tests = list(_cpu_tests(fn, helpers))
        guarded = {id(c) for t in tests for b in t.body for c in ast.walk(b)}
        plain_calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                       and _is_plain_call(c, plain)]
        if not tests or not plain_calls:
            report.add("device-contract", rel, fn.name,
                       "reaches a kernel with no branch that runs its plain "
                       "version on CPU tensors", line=fn.lineno)
        for c in plain_calls:
            if id(c) not in guarded:
                report.add("device-contract", rel, fn.name,
                           f"plain version `{ast.unparse(c.func)}` called "
                           "outside the CPU branch: it would run for a card "
                           "tensor", line=c.lineno)
        if not (raises[fn.name] or any(
                _call_name(t.test.operand) in helpers for t in tests
                if isinstance(t.test, ast.UnaryOp))):
            report.add("device-contract", rel, fn.name,
                       "no `raise` for a tensor on a device other than the "
                       "CPU or CUDA", line=fn.lineno)


def _is_ceil_floordiv(node: ast.BinOp, parent) -> bool:
    """``-(-n // B)`` (node is the inner ``-n // B``) or ``(n + B - 1) //
    B``."""
    if isinstance(node.left, ast.UnaryOp) and \
            isinstance(node.left.op, ast.USub) and \
            isinstance(parent, ast.UnaryOp) and isinstance(parent.op,
                                                           ast.USub):
        return True
    left = node.left
    if isinstance(left, ast.BinOp) and isinstance(left.op, ast.Sub) and \
            isinstance(left.right, ast.Constant) and left.right.value == 1 \
            and isinstance(left.left, ast.BinOp) and \
            isinstance(left.left.op, ast.Add):
        return ast.unparse(left.left.right) == ast.unparse(node.right)
    if isinstance(left, ast.BinOp) and isinstance(left.op, ast.Add) and \
            isinstance(left.right, ast.Constant) and \
            isinstance(node.right, ast.Constant) and \
            left.right.value == node.right.value - 1:
        return True
    return False


def _lint_py_grids(tree: ast.Module, rel: str, report: Report) -> None:
    parents = {id(c): p for p in ast.walk(tree)
               for c in ast.iter_child_nodes(p)}
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = [n.id for t in node.targets for n in ast.walk(t)
                       if isinstance(n, ast.Name)]
        elif isinstance(node, ast.keyword) and node.arg:
            targets = [node.arg]
        if not any("grid" in t.lower() or "blocks" in t.lower()
                   for t in targets):
            continue
        for sub in ast.walk(node.value):
            if isinstance(sub, ast.BinOp) and isinstance(sub.op,
                                                         ast.FloorDiv) \
                    and _BLOCK_CONST.match(ast.unparse(sub.right)) \
                    and not _is_ceil_floordiv(sub, parents.get(id(sub))):
                report.add("grid-tail", rel, _enclosing(tree, sub),
                           f"grid extent `{ast.unparse(sub)}` divides by a "
                           "block constant without rounding up: the tail "
                           "is dropped", line=sub.lineno)


def _lint_tf32(tree: ast.Module, rel: str, report: Report) -> None:
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Attribute) and t.attr == "allow_tf32"
                for t in node.targets) and \
                isinstance(node.value, ast.Constant) and node.value.value:
            report.add("acc-dtype", rel, _enclosing(tree, node),
                       "turns on TF32: float32 products would round to a "
                       "10-bit mantissa", line=node.lineno)
        if isinstance(node, ast.Call) and \
                _call_name(node) == "set_float32_matmul_precision" and \
                any(isinstance(a, ast.Constant) and a.value in ("high",
                                                                "medium")
                    for a in node.args):
            report.add("acc-dtype", rel, _enclosing(tree, node),
                       "set_float32_matmul_precision below 'highest' turns "
                       "on TF32 (or bf16) float32 products",
                       line=node.lineno)


def _enclosing(tree: ast.Module, node: ast.AST) -> str:
    """Qualname of the function containing ``node``, else ``<module>``."""
    best, span = "<module>", None
    for top in tree.body:
        items = [(top.name, top)] if isinstance(top, ast.FunctionDef) else \
            [(f"{top.name}.{i.name}", i) for i in top.body
             if isinstance(i, ast.FunctionDef)] \
            if isinstance(top, ast.ClassDef) else []
        for qual, fn in items:
            end = getattr(fn, "end_lineno", fn.lineno)
            if fn.lineno <= node.lineno <= end and \
                    (span is None or end - fn.lineno < span):
                best, span = qual, end - fn.lineno
    return best


# -------------------------------------------------------------- CUDA side

def _strip_comments(text: str) -> str:
    """Comments and string literals blanked, line numbers kept."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\])*"', blank, text,
                  flags=re.S)


def _close(text: str, i: int, open_ch: str, close_ch: str) -> int:
    """Index of the bracket closing the one at ``i``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_ch:
            depth += 1
        elif text[j] == close_ch:
            depth -= 1
            if depth == 0:
                return j
    return len(text) - 1


def _split_args(s: str) -> list[str]:
    """Top-level comma-separated arguments of ``s``."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur).strip())
    return out


def _line(text: str, i: int) -> int:
    return text.count("\n", 0, i) + 1


def _base(name: str) -> str:
    """A kernel expression's name: casts, template arguments and
    qualifiers dropped."""
    name = re.sub(r"\(\s*(?:const\s+)?void\s*\*\s*\)", "", name)
    name = re.sub(r"<[^<>]*(?:<[^<>]*>[^<>]*)*>", "", name).strip()
    return name.split("::")[-1].strip("&* ()")


def _constants(text: str) -> dict[str, str]:
    """``constexpr`` / ``const`` integer names and ``#define``s."""
    out = {}
    for m in re.finditer(r"\b(?:static\s+)?(?:constexpr|const)\s+"
                         r"(?:int|unsigned|size_t|long long)\s+(\w+)\s*=\s*"
                         r"([^;]+);", text):
        out.setdefault(m.group(1), m.group(2))
    for m in re.finditer(r"^#define\s+(\w+)\s+([^\n\\]+)$", text, re.M):
        out.setdefault(m.group(1), m.group(2))
    return out


def _resolve(expr: str, consts: dict[str, str], depth: int = 0):
    """The integer value of a C expression over literals, ``sizeof`` of a
    scalar type and the file's constants; None when it has no constant
    value."""
    e = re.sub(r"\((?:size_t|int|unsigned|long long)\)", "", expr)
    e = re.sub(r"\bsizeof\s*\(\s*([\w ]+?)\s*\)",
               lambda m: str(_SIZEOF.get(m.group(1), "x")), e)
    e = re.sub(r"(\d+)(?:ULL|LL|UL|U|L)\b", r"\1", e)
    if depth < 8:
        e = re.sub(r"\b[A-Za-z_]\w*\b",
                   lambda m: f"({consts[m.group(0)]})"
                   if m.group(0) in consts else m.group(0), e)
        if re.search(r"[A-Za-z_]", e) and e != expr:
            return _resolve(e, consts, depth + 1)
    if not re.fullmatch(r"[\d\s+\-*/()%]+", e):
        return None
    try:
        return int(eval(e.replace("/", "//"), {"__builtins__": {}}))  # noqa: S307
    except (SyntaxError, ZeroDivisionError):
        return None


def _attr_kernels(text: str) -> dict[str, int]:
    """Kernels whose dynamic shared memory limit is raised: the first
    argument of ``cudaFuncSetAttribute(..., MaxDynamic...)`` (or what an
    ``auto`` / ``void*`` alias of that name was bound to), and of calls to
    helpers that raise it on their first parameter; each with the offset
    of its first such call."""
    setters = {"cudaFuncSetAttribute": 0}
    for m in re.finditer(r"\b(\w+)\s*\(\s*(?:\w+(?:<[^>]*>)?\s+)?(\w+)\s*,"
                         r"[^;{}]*\)\s*\{", text):
        name, param = m.group(1), m.group(2)
        body = text[m.end() - 1:_close(text, m.end() - 1, "{", "}") + 1]
        if re.search(r"cudaFuncSetAttribute\s*\(\s*" + re.escape(param)
                     + r"\s*,\s*cudaFuncAttributeMaxDynamicSharedMemorySize",
                     body):
            setters[name] = 0
    aliases: dict[str, set[str]] = {}
    for m in re.finditer(r"\b(?:auto|(?:const\s+)?void\s*\*)\s+(\w+)\s*=\s*"
                         r"([^;]+);", text):
        aliases.setdefault(m.group(1), set()).add(_base(m.group(2)))
    out: dict[str, int] = {}
    for m in re.finditer(r"\b(\w+)\s*\(", text):
        if m.group(1) not in setters:
            continue
        end = _close(text, m.end() - 1, "(", ")")
        args = _split_args(text[m.end():end])
        if not args:
            continue
        if m.group(1) == "cudaFuncSetAttribute" and not any(
                "MaxDynamicSharedMemorySize" in a for a in args):
            continue
        for name in {_base(args[0])} | aliases.get(_base(args[0]), set()):
            out.setdefault(name, m.start())
    return out


def _launches(text: str):
    """(kernel, grid, smem or None, offset) of every ``<<<...>>>`` launch
    and every ``cudaLaunchKernelExC`` (its ``cfg.gridDim`` and
    ``cfg.dynamicSmemBytes`` the nearest before it)."""
    for m in re.finditer(r"<<<", text):
        end = text.index(">>>", m.end())
        args = _split_args(text[m.end():end])
        head = text[:m.start()]
        k = re.search(r"([\w:]+\s*(?:<[^;{}()]*>)?)\s*$", head)
        yield (_base(k.group(1)) if k else "?", args[0],
               args[2] if len(args) > 2 else None, m.start())
    for m in re.finditer(r"cudaLaunchKernelExC\s*\(", text):
        end = _close(text, m.end() - 1, "(", ")")
        args = _split_args(text[m.end():end])
        before = text[:m.start()]
        grid = re.findall(r"\.gridDim\s*=\s*([^;]+);", before)
        smem = re.findall(r"\.dynamicSmemBytes\s*=\s*([^;]+);", before)
        yield (_base(args[1]) if len(args) > 1 else "?",
               grid[-1] if grid else "", smem[-1] if smem else None,
               m.start())


def _grid_exprs(text: str):
    """(expression, offset) of every grid extent: ``dim3 grid(...)`` /
    ``dim3 grid = ...``, the first argument of a launch, ``.gridDim =``."""
    for m in re.finditer(r"\bdim3\s+\w*grid\w*\s*\(", text):
        end = _close(text, m.end() - 1, "(", ")")
        yield text[m.end():end], m.start()
    for m in re.finditer(r"\bdim3\s+\w*grid\w*\s*=\s*([^;]+);", text):
        yield m.group(1), m.start()
    for kernel, grid, _, at in _launches(text):
        if not re.fullmatch(r"\s*\w*grid\w*\s*", grid):
            yield grid, at


def _floor_divisions(expr: str):
    """(dividend, divisor) of every ``/`` in ``expr`` whose divisor is a
    block constant and whose dividend is not ``(... + B - 1)``."""
    for m in re.finditer(r"/\s*((?:\w+::)*\w+)", expr):
        divisor = m.group(1)
        if not _BLOCK_CONST.match(divisor):
            continue
        left = expr[:m.start()].rstrip()
        if left.endswith(")"):
            depth, j = 0, len(left) - 1
            while j >= 0:
                depth += {")": 1, "(": -1}.get(left[j], 0)
                if depth == 0:
                    break
                j -= 1
            dividend = left[j + 1:-1]
        else:
            dividend = re.search(r"[\w:.]+$", left).group(0) \
                if re.search(r"[\w:.]+$", left) else left
        flat = dividend.replace(" ", "")
        d = divisor.replace(" ", "")
        ceil = flat.endswith(f"+{d}-1") or flat.endswith(f"+({d}-1)")
        if d.isdigit():
            ceil = ceil or flat.endswith(f"+{int(d) - 1}")
        if not ceil:
            yield dividend, divisor


def _lint_cuda(path: pathlib.Path, rel: str, report: Report,
               headers: str) -> None:
    raw = path.read_text()
    text = _strip_comments(raw)
    consts = _constants(_strip_comments(headers) + "\n" + text)
    for expr, at in _grid_exprs(text):
        for dividend, divisor in _floor_divisions(expr):
            report.add("grid-tail", rel, _cuda_function(text, at),
                       f"grid extent `{expr.strip()}` divides `{dividend}` "
                       f"by the block constant `{divisor}` without rounding "
                       "up: the tail is dropped", line=_line(text, at))
    raised = _attr_kernels(text)
    for kernel, _, smem, at in _launches(text):
        if smem is None:
            continue
        value = _resolve(smem, consts)
        if value is not None and value <= SMEM_DEFAULT_BYTES:
            continue
        if raised.get(kernel, len(text)) > at:
            report.add("smem-footprint", rel, _cuda_function(text, at),
                       f"launch of `{kernel}` asks for `{smem.strip()}` "
                       "bytes of dynamic shared memory, which can pass 48 "
                       "KB, without raising its "
                       "cudaFuncAttributeMaxDynamicSharedMemorySize",
                       line=_line(text, at))
        if value is not None and value > SMEM_LIMIT_BYTES:
            report.add("smem-footprint", rel, _cuda_function(text, at),
                       f"launch of `{kernel}` asks for {value} bytes of "
                       f"shared memory, over sm_90's {SMEM_LIMIT_BYTES}",
                       line=_line(text, at))
    for m in re.finditer(r"cudaFuncSetAttribute\s*\(", text):
        end = _close(text, m.end() - 1, "(", ")")
        args = _split_args(text[m.end():end])
        if len(args) == 3 and "MaxDynamicSharedMemorySize" in args[1]:
            value = _resolve(args[2], consts)
            if value is not None and value > SMEM_LIMIT_BYTES:
                report.add("smem-footprint", rel, _cuda_function(text, m.start()),
                           f"raises `{_base(args[0])}`'s dynamic shared "
                           f"memory to {value} bytes, over sm_90's "
                           f"{SMEM_LIMIT_BYTES}", line=_line(text, m.start()))
    for m in re.finditer(r"__global__\s+(?:void\s+)?(?:__launch_bounds__"
                         r"\s*\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(", text):
        pend = _close(text, m.end() - 1, "(", ")")
        params = text[m.end():pend]
        brace = text.find("{", pend)
        if brace < 0 or ";" in text[pend:brace] or \
                not re.search(r"\bdouble\b", params):
            continue
        body = text[brace:_close(text, brace, "{", "}") + 1]
        floats = set(re.findall(r"\bfloat\s+(\w+)\s*[=;]", body))
        for name in sorted(floats):
            if re.search(r"\b" + name + r"\s*[+\-]=", body):
                report.add("acc-dtype", rel, m.group(1),
                           f"kernel `{m.group(1)}` takes double operands "
                           f"but accumulates `{name}` in float",
                           line=_line(text, m.start()))


def _cuda_function(text: str, at: int) -> str:
    """The name of the C function around offset ``at``: the last
    definition that starts before it."""
    name = "<file>"
    for m in re.finditer(r"^[A-Za-z_][\w:<>,\s\*&]*?\b(\w+)\s*\([^;{}]*\)"
                         r"\s*(?:const\s*)?\{", text[:at], re.M):
        if m.group(1) not in ("if", "for", "while", "switch", "return"):
            name = m.group(1)
    return name


# -------------------------------------------------------------- entry point

def lint_paths(paths, *, repo_root=None) -> Report:
    """Run the four rules over ``paths``: ``.py`` files (wrappers, Python
    grids, TF32) and ``.cu`` / ``.cuh`` sources (grids, shared memory,
    accumulators; a source's constants may come from the headers given
    beside it)."""
    report = Report()
    repo_root = pathlib.Path(repo_root) if repo_root else None
    paths = [pathlib.Path(p) for p in paths]
    headers = "\n".join(p.read_text() for p in paths if p.suffix == ".cuh")

    def rel(p):
        return str(p.relative_to(repo_root)) if repo_root and \
            p.is_relative_to(repo_root) else str(p)
    for p in paths:
        if p.suffix == ".py":
            tree = ast.parse(p.read_text(), filename=str(p))
            _lint_wrappers(tree, rel(p), report)
            _lint_py_grids(tree, rel(p), report)
            _lint_tf32(tree, rel(p), report)
        elif p.suffix in (".cu", ".cuh"):
            _lint_cuda(p, rel(p), report, headers)
    return report


def kernel_sources(root=None) -> list[pathlib.Path]:
    """The port's CUDA sources, ``kernels/csrc/*.cu`` and ``*.cuh``."""
    from repro_torch.analysis.imports import src_root
    csrc = (pathlib.Path(root) if root else src_root()) / "repro_torch" \
        / "kernels" / "csrc"
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
