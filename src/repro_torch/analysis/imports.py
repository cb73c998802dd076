"""Intra-package import graph of the port: the lint scope and the
scaffolding inventory. Mirrors ``src/repro/analysis/imports.py`` over
``src/repro_torch``; framework-free, as the reference's is, and the port's
own copy.

The lint passes hold the SVM port (and what it imports) to their rules and
leave the LM zoo, which nothing on the SVM paths imports, out of the
default scope. Both lists come from the import statements themselves,
collected by AST over every module under ``src/repro_torch``
(function-level imports included: ``svm/svc.py`` imports the CV drivers
lazily).
"""
from __future__ import annotations

import ast
import pathlib

PACKAGE = "repro_torch"

#: packages whose modules are the lint roots: the SVM port proper plus the
#: subsystems it consumes through injection rather than imports
#: (checkpoint managers are passed into run_plan / run_grid, the analyzers
#: run the lint itself, the study daemon is an entry point nothing
#: imports); everything transitively imported from here is "adopted" code
ROOT_PACKAGES = tuple(f"{PACKAGE}.{p}" for p in (
    "svm", "core", "kernels", "checkpoint", "analysis", "service"))


def src_root(start=__file__) -> pathlib.Path:
    """The ``src/`` directory this package was imported from."""
    return pathlib.Path(start).resolve().parents[2]


def module_name(path: pathlib.Path, root: pathlib.Path) -> str:
    rel = path.relative_to(root).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def repro_modules(root=None) -> dict[str, pathlib.Path]:
    """{module name: path} for every .py file under ``src/repro_torch``."""
    root = pathlib.Path(root) if root is not None else src_root()
    return {module_name(p, root): p
            for p in sorted((root / PACKAGE).rglob("*.py"))}


def import_graph(root=None) -> dict[str, set[str]]:
    """{module: set of port modules it imports}. ``from repro_torch.x
    import name`` edges target ``repro_torch.x`` (and
    ``repro_torch.x.name`` when that is itself a module, e.g. ``from
    repro_torch.svm import cost_model``)."""
    modules = repro_modules(root)
    graph: dict[str, set[str]] = {}
    for mod, path in modules.items():
        tree = ast.parse(path.read_text(), filename=str(path))
        deps: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                deps.update(a.name for a in node.names
                            if a.name.split(".")[0] == PACKAGE)
            elif isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.split(".")[0] == PACKAGE and node.level == 0:
                deps.add(node.module)
                for alias in node.names:
                    sub = f"{node.module}.{alias.name}"
                    if sub in modules:
                        deps.add(sub)
        graph[mod] = {d for d in deps if d in modules}
    return graph


def reachable(graph: dict[str, set[str]], roots) -> set[str]:
    """Transitive closure of ``roots`` (package names include all their
    member modules as roots)."""
    stack = [m for m in graph
             if any(m == r or m.startswith(r + ".") for r in roots)]
    seen = set(stack)
    while stack:
        for dep in graph.get(stack.pop(), ()):
            # importing a module executes every ancestor package's
            # __init__, so those count as reached too; sibling member
            # modules are reached only by their own explicit imports
            parts = dep.split(".")
            for anc in (".".join(parts[:i]) for i in range(1, len(parts) + 1)):
                if anc in graph and anc not in seen:
                    seen.add(anc)
                    stack.append(anc)
    return seen


def scaffolding_inventory(root=None) -> list[str]:
    """Modules under ``src/repro_torch`` that nothing reachable from the
    roots imports (the LM zoo), excluded from the default lint scope."""
    graph = import_graph(root)
    live = reachable(graph, ROOT_PACKAGES)
    return sorted(m for m in graph if m not in live)


def default_scope(root=None) -> list[pathlib.Path]:
    """Files the lint passes run on by default: every module reachable
    from the roots (so a module is linted the moment something there
    imports it)."""
    modules = repro_modules(root)
    live = reachable(import_graph(root), ROOT_PACKAGES)
    return [modules[m] for m in sorted(live)]
