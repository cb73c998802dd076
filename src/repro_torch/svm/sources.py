"""Kernel-source factories and the compute-on-demand cache of the lane
pool.

Mirrors ``src/repro/svm/sources.py``: ``is_factory``, ``KernelSpec``,
``source_nbytes``, ``budget_fits``, ``pick_victim`` and ``SourceCache``.
A ``KernelSpec`` declares a kernel source — ``(X, gamma, kind, n)`` —
without computing it and answers the cheap half of the source protocol
(``dtype``, ``device``, ``fused``, ``streams_rows``, ``nbytes``);
``materialize`` builds a ``DenseKernel`` (the RBF kernel on the card, or
the plain version on the CPU) or a ``PallasRBF`` holding only ``X[:n]``.
The cache keeps already-usable sources pinned and materializes specs under
a ``max_resident`` / ``cache_bytes`` budget, evicting the resident source
with the fewest unretired lanes first, the sticky one last, ties least
recently used. A spec is a pure function of its inputs, so a
re-materialized kernel is bitwise the one evicted. ``source_identity``
is the study service's dedup key: the reference's tuple, with numpy dtype
names and sha1 digests of the same bytes, so the same plan gets the same
pool key in either package's daemon. ``SourceCache.add_entry`` /
``remove_entry`` admit and drop entries of a live pool (the daemon's
per-plan intake).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.svm.engine import DenseKernel, PallasRBF
from repro_torch.svm.kernels import kernel_matrix


def is_factory(entry) -> bool:
    """True when a sources-dict entry declares a kernel and materializes on
    demand (``materialize()``) rather than being a usable source
    (``row()``)."""
    return callable(getattr(entry, "materialize", None)) and \
        not callable(getattr(entry, "row", None))


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """A declared-but-not-computed kernel source. ``n`` truncates to the
    first ``n`` instances, applied to ``X`` before the kernel call (the
    k-fold truncation; the two slice orders differ in final bits).
    ``kind="pallas_rbf"`` declares a row-streaming source: ``nbytes`` is
    X's bytes and ``fused`` is True without compute. ``backend`` is the
    reference's K-build choice; the port has one K build, so it is inert
    here, kept so that a wire plan round-trips to the same JSON and the
    same ``source_identity``."""
    X: Any
    gamma: float = 1.0
    kind: str = "rbf"
    backend: str = "jnp"
    n: int | None = None

    @property
    def fused(self) -> bool:
        return self.kind == "pallas_rbf"

    @property
    def streams_rows(self) -> bool:
        return self.kind == "pallas_rbf"

    @property
    def dtype(self):
        return self.X.dtype

    @property
    def device(self):
        return self.X.device

    @property
    def n_rows(self) -> int:
        return int(self.X.shape[0] if self.n is None else self.n)

    @property
    def nbytes(self) -> int:
        """n^2 kernel bytes for dense kinds, X's bytes for row-streaming
        kinds — known without computing anything."""
        item = itemsize(self.X)
        if self.kind == "pallas_rbf":
            return self.n_rows * int(self.X.shape[1]) * item
        return self.n_rows * self.n_rows * item

    def materialize(self):
        X = self.X if self.n is None else self.X[: self.n]
        if self.kind == "pallas_rbf":
            return PallasRBF(X, self.gamma)
        return DenseKernel(kernel_matrix(X, X, kind=self.kind,
                                         gamma=self.gamma))

    def to(self, device) -> "KernelSpec":
        return dataclasses.replace(self, X=self.X.to(device))


def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype (``"float64"``, ``"bool"``):
    the name the reference's identities and programs carry."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def itemsize(a) -> int:
    """Bytes per element of a tensor or an array."""
    if isinstance(a, torch.Tensor):
        return a.element_size()
    return np.dtype(a.dtype).itemsize


def host_array(a) -> np.ndarray:
    """A tensor or array as a contiguous host numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a))


def digest(a) -> str:
    """sha1 of an array's raw bytes."""
    return hashlib.sha1(host_array(a).tobytes()).hexdigest()


def source_identity(entry, y=None) -> tuple | None:
    """Content identity of a sources-dict entry: equal identities declare
    the same kernel values (and, with ``y``, the same labels), so a
    multi-tenant pool may serve both tenants from one resident kernel.
    None means "never dedup" (opaque sources). Arrays enter as sha1 digests
    of their bytes, after the spec's own ``[:n]`` truncation."""
    if isinstance(entry, KernelSpec):
        ident = ("spec", entry.kind, float(entry.gamma), entry.backend,
                 entry.n_rows, dtype_name(entry.dtype),
                 digest(entry.X[: entry.n_rows]))
    elif isinstance(entry, DenseKernel):
        K = entry.K
        ident = ("dense", dtype_name(K.dtype), int(K.shape[0]), digest(K))
    else:
        return None
    if y is not None:
        ident = ident + (digest(y),)
    return ident


def source_nbytes(src) -> int:
    """Resident bytes a source (or spec) will occupy."""
    nb = getattr(src, "nbytes", None)
    return int(nb) if nb is not None else 0


def budget_fits(count: int, nbytes: int, *, max_resident: int = 0,
                cache_bytes: int = 0) -> bool:
    """THE residency budget rule (0 = unbounded)."""
    if max_resident and count > max_resident:
        return False
    return not (cache_bytes and nbytes > cache_bytes)


def pick_victim(resident, *, sticky, distance):
    """THE eviction victim rule: ``resident`` is the managed keys in
    recency order (least recently used first). Non-sticky before sticky,
    then ascending schedule distance (fewest remaining lanes), then LRU."""
    keys = list(resident)
    return min(keys, key=lambda k: (k == sticky, distance(k),
                                    keys.index(k)))


def _block(src) -> None:
    """Wait for a materialized source's arrays (so ``kernel_time`` times
    the build, not its enqueue)."""
    dev = getattr(src, "device", None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


class SourceCache:
    """Residency manager for a pool's ``{key: source-or-spec}`` dict.

    ``get(key)`` returns a usable source, materializing a spec on demand
    after evicting (``on_evict(key)`` first, so the pool writes its packed
    batch back) until the budget admits it. ``meta(key)`` answers
    ``dtype``/``device``/``fused`` without materializing. Pinned entries
    (already-usable sources) are always resident and outside the budget.
    The fused/WSS-1 rule runs on pinned entries at construction and on
    factory products at materialization.
    """

    def __init__(self, entries: dict, *, max_resident: int = 0,
                 cache_bytes: int = 0, wss: str = "2",
                 distance: Callable[[Any], int] | None = None,
                 sticky: Callable[[], Any] | None = None,
                 on_evict: Callable[[Any], None] | None = None,
                 on_trace: Callable | None = None):
        self._entries = dict(entries)
        self.max_resident = int(max_resident)
        self.cache_bytes = int(cache_bytes)
        self.wss = wss
        self._distance = distance or (lambda key: 0)
        self._sticky = sticky or (lambda: None)
        self.on_evict = on_evict
        self.on_trace = on_trace
        self._resident: dict[Any, Any] = {}     # managed key -> source (LRU)
        self._pinned: dict[Any, Any] = {
            k: v for k, v in entries.items() if not is_factory(v)}
        self.kernel_time = 0.0
        self.materializations = 0
        self.evictions = 0
        self.peak_resident = len(self._pinned)
        self.peak_resident_bytes = self.pinned_bytes

    def resident(self, key) -> bool:
        return key in self._pinned or key in self._resident

    def pinned(self, key) -> bool:
        return key in self._pinned

    def nbytes_of(self, key) -> int:
        return source_nbytes(self.meta(key))

    @property
    def budgeted(self) -> bool:
        return bool(self.max_resident or self.cache_bytes)

    def fits(self, count: int, nbytes: int) -> bool:
        return budget_fits(count, nbytes, max_resident=self.max_resident,
                           cache_bytes=self.cache_bytes)

    def meta(self, key):
        """The resident source if there is one, else the entry itself."""
        if key in self._pinned:
            return self._pinned[key]
        return self._resident.get(key, self._entries[key])

    @property
    def resident_bytes(self) -> int:
        return sum(source_nbytes(s) for s in self._resident.values())

    @property
    def pinned_bytes(self) -> int:
        return sum(source_nbytes(s) for s in self._pinned.values())

    @property
    def stats(self) -> dict:
        return {"materializations": self.materializations,
                "evictions": self.evictions,
                "kernel_time": round(self.kernel_time, 4),
                "peak_resident": self.peak_resident,
                "peak_resident_bytes": self.peak_resident_bytes}

    def add_entry(self, key, entry) -> None:
        """Admit an entry after construction (the daemon admits plans into
        a live pool): a usable source is pinned, a factory managed."""
        if key in self._entries:
            raise ValueError(f"source {key!r} already present")
        self._entries[key] = entry
        if not is_factory(entry):
            self._pinned[key] = entry
            self.peak_resident = max(
                self.peak_resident, len(self._pinned) + len(self._resident))

    def remove_entry(self, key) -> None:
        """Drop an entry and any residency it holds (a drained study's
        sources leave the pool). Not an eviction: no ``on_evict``."""
        self._entries.pop(key, None)
        self._pinned.pop(key, None)
        self._resident.pop(key, None)

    def check_fused(self, key, src) -> None:
        if getattr(src, "fused", False) and self.wss == "2":
            raise ValueError(
                f"source {key!r} is fused and requires WSS-1 (wss='1')")

    def _evict_for(self, incoming_bytes: int) -> None:
        # the `self._resident` guard keeps a single over-budget kernel
        # admissible when there is nothing left to evict
        while self._resident and not self.fits(
                len(self._resident) + 1,
                self.resident_bytes + incoming_bytes):
            victim = pick_victim(self._resident, sticky=self._sticky(),
                                 distance=self._distance)
            if self.on_evict is not None:
                self.on_evict(victim)
            if self.on_trace is not None:
                self.on_trace("evict", victim,
                              source_nbytes(self._resident[victim]))
            del self._resident[victim]
            self.evictions += 1

    def get(self, key):
        """A usable kernel source for ``key``, materializing (and evicting
        per the budget) on demand."""
        if key in self._pinned:
            return self._pinned[key]
        src = self._resident.pop(key, None)
        if src is not None:                    # hit: refresh recency
            self._resident[key] = src
            return src
        spec = self._entries[key]
        self._evict_for(source_nbytes(spec))
        t0 = time.perf_counter()
        src = spec.materialize()
        _block(src)
        self.kernel_time += time.perf_counter() - t0
        self.materializations += 1
        self.check_fused(key, src)
        self._resident[key] = src
        if self.on_trace is not None:
            self.on_trace("materialize", key, source_nbytes(src))
        self.peak_resident = max(
            self.peak_resident, len(self._pinned) + len(self._resident))
        self.peak_resident_bytes = max(
            self.peak_resident_bytes, self.resident_bytes + self.pinned_bytes)
        return src
