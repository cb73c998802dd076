"""Checkpoints with crash-consistent commits.

Mirrors ``src/repro/checkpoint/manager.py``: ``namespace_path``,
``save_pytree``, ``load_pytree`` and ``CheckpointManager`` (``namespaced``,
retention per class, async ``save`` with ``wait``, ``restore``,
``restore_latest_of_class``), with the same on-disk layout, so a record
written by either package restores in the other:

* a step is written to ``step_<10 digits>.tmp/`` and renamed to
  ``step_<10 digits>/``; readers trust only directories holding a
  ``COMMIT`` marker, so a killed writer never corrupts the latest record;
* ``arrays.npz`` holds the tree's leaves as host arrays, keyed by the
  reference's flattening: dict keys sorted, list and tuple positions by
  index, the path parts joined by ``_SEP``;
* ``meta.json`` holds ``treedef`` (the text the reference's
  ``str(jax treedef)`` gives, rendered here for the dict, list and tuple
  trees the SVM path saves), ``keys``, ``extra`` and ``retain_class``.

A tree's leaves may be torch tensors (on any device), numpy arrays or
Python numbers. ``save`` copies every leaf to a fresh host array on the
caller's thread before the writer thread starts: the lane pool updates its
states in place, so a tensor handed to the writer could change under it.
Retention: ``max_to_keep`` newest steps are kept per ``retain_class``, so
frequent snapshots cannot evict the rare records a resume depends on.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading

import numpy as np
import torch

_SEP = "/"

_SAFE_PART = re.compile(r"[^A-Za-z0-9._-]")


def namespace_path(root: str, *parts: str) -> str:
    """A filesystem-safe subdirectory of ``root`` for the namespace parts
    (the daemon keys checkpoints by ``tenant / plan_id``): each part is
    sanitized to ``[A-Za-z0-9._-]``, and a part that sanitizing changed
    gets a short sha1 of the original appended, so two raw names that
    sanitize alike cannot share a directory."""
    safe = []
    for part in parts:
        part = str(part)
        if not part or set(part) <= {"."}:
            raise ValueError(f"namespace part {part!r} is empty or dots-only")
        clean = _SAFE_PART.sub("_", part)
        if clean != part:
            clean += "-" + hashlib.sha1(part.encode()).hexdigest()[:8]
        safe.append(clean)
    return os.path.join(root, *safe)


def _host(leaf) -> np.ndarray:
    """A leaf as a host array (a view of a CPU tensor's memory)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _children(tree):
    """(path part, child) pairs of a dict, list or tuple node in the
    reference's flattening order; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix=()) -> dict:
    """``{joined path: host array}`` of every leaf; None is an empty
    subtree, as in the reference."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {_SEP.join(prefix): _host(tree)}
    out = {}
    for part, child in kids:
        out.update(_flatten(child, prefix + (part,)))
    return out


def _render(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_render(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_render(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_render(v) for v in tree)
        return "(" + inner + ("," if len(tree) == 1 else "") + ")"
    return "*"


def treedef_str(tree) -> str:
    """The reference's ``str(jax.tree_util.tree_structure(tree))``."""
    return f"PyTreeDef({_render(tree)})"


def _host_tree(tree):
    """The tree with every leaf a fresh host array, never a view of the
    caller's memory (structure kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return np.array(_host(tree))


def save_pytree(path: str, tree, extra_meta: dict | None = None,
                retain_class: str = "default") -> None:
    """Atomic commit: write ``<path>.tmp``, then rename it to ``path``."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = {"treedef": treedef_str(tree), "keys": sorted(flat),
            "extra": extra_meta or {}, "retain_class": retain_class}
    with open(os.path.join(tmp, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    with open(os.path.join(tmp, "COMMIT"), "w") as fh:
        fh.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _restore_like(target, flat: dict, prefix=()):
    if target is None:
        return None
    kids = _children(target)
    if kids is None:
        arr = flat[_SEP.join(prefix)]
        if isinstance(target, torch.Tensor):
            return torch.as_tensor(arr, device=target.device).to(target.dtype)
        return arr
    vals = [_restore_like(child, flat, prefix + (part,))
            for part, child in kids]
    if isinstance(target, dict):
        return dict(zip(sorted(target), vals))
    return type(target)(vals)


def load_pytree(path: str, target=None):
    """Load a committed record: ``(flat {key: array}, extra)``, or with
    ``target`` (a tree prototype) the leaves in target's structure, a
    tensor leaf restored as a tensor of the prototype's dtype and
    device."""
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: data[k] for k in data.files}
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    if target is None:
        return flat, meta["extra"]
    return _restore_like(target, flat), meta["extra"]


class CheckpointManager:
    @classmethod
    def namespaced(cls, root: str, *parts: str,
                   max_to_keep: int = 3) -> "CheckpointManager":
        """Manager over ``namespace_path(root, *parts)``: one step space and
        retention budget per (tenant, plan)."""
        return cls(namespace_path(root, *parts), max_to_keep=max_to_keep)

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._retain_classes: dict[int, str] = {}

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.directory, name,
                                                "COMMIT")):
                steps.append(int(name[len("step_"):]))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def steps_of_class(self, retain_class: str) -> list[int]:
        """Committed steps written under one ``retain_class``."""
        return [s for s in self.all_steps()
                if self._step_class(s) == retain_class]

    def latest_step_of_class(self, retain_class: str) -> int | None:
        steps = self.steps_of_class(retain_class)
        return steps[-1] if steps else None

    def restore_latest_of_class(self, retain_class: str):
        """(step, flat tree, extra) of the newest committed record in one
        ``retain_class``, or None when the class has none."""
        step = self.latest_step_of_class(retain_class)
        if step is None:
            return None
        return self.restore(step=step)

    def save(self, step: int, tree, extra_meta: dict | None = None,
             blocking: bool = True, retain_class: str = "default") -> None:
        """Write ``tree`` at ``step``; ``max_to_keep`` newest steps are kept
        per ``retain_class``. The leaves are copied to host here, on the
        caller's thread, before any writer thread starts."""
        self.wait()
        self._retain_classes[step] = retain_class
        host_tree = _host_tree(tree)

        def _work():
            save_pytree(self._step_dir(step), host_tree, extra_meta,
                        retain_class)
            self._gc()

        if blocking:
            _work()
        else:
            self._thread = threading.Thread(target=_work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, step: int | None = None, target=None):
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        tree, extra = load_pytree(self._step_dir(step), target)
        return step, tree, extra

    def _step_class(self, step: int) -> str:
        """Retention class of a step; read from meta.json when this manager
        did not write it (resume after a restart)."""
        cls = self._retain_classes.get(step)
        if cls is None:
            try:
                with open(os.path.join(self._step_dir(step),
                                       "meta.json")) as fh:
                    cls = json.load(fh).get("retain_class", "default")
            except (OSError, json.JSONDecodeError):
                cls = "default"
            self._retain_classes[step] = cls
        return cls

    def _gc(self) -> None:
        by_class: dict[str, list[int]] = {}
        for s in self.all_steps():
            by_class.setdefault(self._step_class(s), []).append(s)
        for steps in by_class.values():
            for s in steps[: -self.max_to_keep]:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
                self._retain_classes.pop(s, None)
