"""Device-resident SMO chunks on the card: the counterparts of the
``lax.while_loop`` over ``_step`` in ``src/repro/svm/engine.py::smo_chunk``
(one lane) and ``chunk_batched_jit`` (lanes vmapped over one source).

* ``smo_chunk`` / ``smo_chunk_lanes`` — a dense K, built from
  ``csrc/smo_chunk.cu``: up to ``n_iters`` iterations for every lane in ONE
  launch. Four kernels, routes by size and lanes (``chunk_route``, the
  fastest that places the launch by a time model fitted on the card):
  ``one_block``, one block a lane with the lane's state in registers or
  shared memory (wherever ``one_block_plan`` fits it in a block: n <=
  6,144); ``multi_block``, each lane over many blocks of one cooperative
  launch, its state in their shared memory (only while every lane's state
  fits the card's shared memory at once); ``cluster``, each lane over a
  thread-block cluster holding its alpha and f in the cluster's shared
  memory (wherever ``cluster_plan`` places every lane's cluster at once:
  the wide batches); ``one_block_global``, one block a lane with the state
  in global memory, for batches that fit nowhere on chip.
  ``smo_chunk.launches`` counts all four, ``smo_chunk.route_launches``
  each.
* ``smo_chunk_sources`` — the same kernels over lanes that each carry their
  own K (b, n, n), diag and y (the shrinking scheduler's compact lanes,
  ``chunk_batched_sources_jit`` in the reference): one launch, each lane
  reading its operands at a stride; its own ``launches`` and
  ``route_launches`` count it.
* ``smo_stream_chunk`` — a row-streaming RBF source (X, no K). Three
  routes (``stream_route``, the fastest that places the lanes by a time
  model fitted on the card): ``cluster`` (``csrc/smo_stream.cu``) and
  ``persistent`` (``csrc/smo_step.cu``, its bitwise witness) each run all
  ``n_iters`` WSS-1 iterations over all lanes in ONE launch whose blocks
  own slices of rows and stop on the device when every lane is done, the
  first in thread-block clusters (``stream_cluster_plan``) with X held in
  shared memory as far as it fits; or ``pair``, up to ``n_iters``
  (``smo_select``, ``fused_smo_step``) launch pairs issued by one host
  call that stops soon after every lane is done, where neither one-launch
  plan places the lanes. ``smo_stream_chunk.launches`` counts the
  one-launch kernels, ``smo_select`` and ``fused_smo_step`` the pair
  route's launches, and ``smo_stream_chunk.route_launches`` the chunks on
  each route; ``smo_select`` also launches the selection kernel alone.
* ``smo_stream_chunk_sources`` — the streaming chunk over lanes that each
  carry their own X (b, n, d), norms and y, on the ``persistent`` and
  ``pair`` routes (the cluster route takes one X): the persistent launch
  runs each lane on its own group of blocks; the pair route's kernels read
  each lane's operands at a stride. Its own ``launches`` and
  ``route_launches`` count the chunks; the pair route's launches count on
  ``smo_select`` and ``fused_smo_step`` as above.

The caller reads the lanes' ``done`` flags only between chunks. On a CPU
tensor each wrapper runs the plain per-step loop, ``ref.smo_chunk_ref``,
lane by lane (the lanes are independent). Either way the inputs are left
untouched and the new state comes back as new tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (smo_chunk_ref, smo_chunk_sources_ref,
                                     smo_select_lanes_ref)
from repro_torch.kernels.smo_step import fused_smo_step

_P, _LL, _D, _I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double,
                   ctypes.c_int)
#: an iteration's time on each route, in us, fitted to chip_smoke.py's
#: crossover and lane sweeps on an H100 (PERF.md §6): the one-block routes
#: floor + slope x n / 1,024 (the rows a thread would handle at 1,024
#: threads), once for each lane an SM carries (ceil(b / SMs)); the
#: multi-block route floor + a slope x n / 1,024 (the K rows' round trips
#: grow with the lane) + a slope x the rows an SM carries / 1,024 (m
#: blocks a lane of ceil(n / m) rows, the b m blocks spread over the
#: SMs): spread over blocks, a lane pays two barriers across blocks a step
#: (the floor) but shares its rows out
ONE_BLOCK_US = (1.89, 1.40)
MULTI_BLOCK_US = (8.357, 0.074, 0.952)
#: the global-state one-block kernel's
GLOBAL_US = (3.28, 1.50)
#: the cluster kernel's, at the shape ``cluster_plan`` picks: floor + a
#: slope x n / 1,024 (the K rows' round trips grow with the lane) + a
#: slope x the rows an SM carries (``ClusterPlan.load``) / 1,024 + a slope
#: x the rows a thread (each thread's chain of rows; fitted to every shape
#: the sweeps time, not only the plan's)
CLUSTER_US = (3.955, 0.071, 0.277, 0.196)
ROUTES = ("one_block", "multi_block", "cluster", "one_block_global")
#: the cluster kernel's builds (rows a thread) and blocks a cluster (the
#: portable sizes)
CLUSTER_ROWS = (4, 8, 16, 32)
CLUSTER_SIZES = tuple(range(2, 9))
#: the build of the resident one-block kernel a lane of n rows takes: the
#: first (most rows, rows a thread, state in shared memory) with n <= most
#: rows; the fastest build at each n of chip_smoke.py's width sweep on an
#: H100 (PERF.md §6). A block is 32 * ceil(n / (32 rows)) threads
RESIDENT_ROWS = ((320, 1, False), (640, 2, False), (2048, 4, False),
                 (6144, 8, True))
#: the resident kernel's builds, (rows a thread, state in shared memory)
RESIDENT_BUILDS = tuple((rows, smem) for _, rows, smem in RESIDENT_ROWS)
#: the streaming chunk's routes
STREAM_ROUTES = ("pair", "persistent", "cluster")
#: those of the streaming chunk over lanes with their own X
STREAM_SOURCES_ROUTES = ("pair", "persistent")
#: the cluster route's blocks a cluster (the portable sizes) and tiles (row
#: blocks of 8 a warp: 2, tiles of 128 rows; 4, of 256)
STREAM_CLUSTER_SIZES = tuple(range(2, 9))
STREAM_TILES = (2, 4)
#: rows a block of the one-launch streaming routes aims at
STREAM_BLOCK_ROWS = 128
#: an iteration's time on the one-launch streaming routes, in us, fitted to
#: chip_smoke.py's sweep over n, d and lanes on an H100 (PERF.md §6), on
#: the features ``stream_features``: a floor, the lane blocks of 4 a thread
#: carries (nvb = ceil(b / 4)) and their square (a thread's cells, and the
#: registers they take), its row blocks of 8 (2 or 4), the launch's blocks
#: / 128 (the exchange) and the k-steps of four features / 32 (the
#: products)
STREAM_US = {"cluster": (2.508, -1.566, 1.048, 2.893, -0.512, 7.779),
             "persistent": (-2.688, 2.895, -0.026, 2.986, 1.887, 10.258)}


def resident_threads(n: int, rows: int) -> int:
    """The resident kernel's block for n rows at ``rows`` rows a thread."""
    return 32 * -(-n // (32 * rows))


def one_block_plan(n: int) -> tuple[int, int, bool] | None:
    """Where the resident one-block kernel holds a lane of n rows: ``(rows
    a thread, threads, state in shared memory)`` by ``RESIDENT_ROWS``, or
    None past its last entry (n > 6,144: 33 bytes a row of state in a
    768-thread block). Pure: the same on any card."""
    for most, rows, smem in RESIDENT_ROWS:
        if n <= most:
            return rows, resident_threads(n, rows), smem
    return None


class ClusterPlan(NamedTuple):
    """Where the cluster kernel holds a launch's lanes: blocks a cluster
    (one cluster a lane), rows a thread, threads a block, and the rows an
    SM carries when the launch's blocks spread over the card's SMs."""
    blocks: int
    rows: int
    threads: int
    load: int


def cluster_threads(n: int, m: int, rows: int) -> int:
    """The cluster kernel's block for n rows over m blocks at ``rows`` rows
    a thread."""
    return 32 * -(-(-(-n // m)) // (32 * rows))


def cluster_shape(n: int, b: int, m: int, rows: int,
                  sms: int) -> ClusterPlan:
    """The cluster kernel's launch of b lanes of n rows as clusters of m
    blocks at ``rows`` rows a thread on a card of ``sms`` SMs."""
    threads = cluster_threads(n, m, rows)
    return ClusterPlan(m, rows, threads,
                       threads * rows * -(-(b * m) // sms))


def cluster_plan(n: int, b: int, capacity: dict,
                 sms: int) -> ClusterPlan | None:
    """Where the cluster kernel holds b lanes of n rows, given
    ``capacity`` {(blocks a cluster, rows a thread): clusters the card
    runs at once} (``cluster_capacity``) and the card's ``sms``: of the
    shapes that run all b clusters at once, the one whose SMs carry the
    fewest rows (rows a block x the blocks an SM holds once the b m blocks
    spread over the SMs), then the smaller cluster, then fewer rows a
    thread (chip_smoke.py's sweeps time every placed shape beside this
    one on the card; PERF.md §6). None where no shape holds them: the
    lanes' own state (alpha, f and diag, 24 bytes a row, and the K rows in
    registers) does not fit on chip. Pure: the card enters through
    ``capacity`` and ``sms``."""
    shapes = [cluster_shape(n, b, m, rows, sms)
              for (m, rows), clusters in capacity.items() if clusters >= b]
    return min(shapes, key=lambda p: (p.load, p.blocks, p.rows),
               default=None)


def chunk_route(n: int, lanes: int, m: int, cluster: ClusterPlan | None,
                sms: int) -> str:
    """The dense chunk's route for ``lanes`` lanes of n rows on a card of
    ``sms`` SMs: the fastest by ``ONE_BLOCK_US`` (where ``one_block_plan``
    places a lane, else ``GLOBAL_US``), ``MULTI_BLOCK_US`` and
    ``CLUSTER_US``, of the routes that place the launch: ``m`` is the
    blocks a lane that ``multi_block_plan`` gives the lanes (0: their state
    does not fit the card's shared memory), ``cluster`` what
    ``cluster_plan`` gives them (None: no shape holds them). Wide batches
    load the multi-block route's SMs with many blocks of large slices;
    the cluster route's SMs carry fewer rows."""
    if one_block_plan(n) is not None:
        one, us = "one_block", ONE_BLOCK_US
    else:
        one, us = "one_block_global", GLOBAL_US
    times = {one: (us[0] + us[1] * n / 1024) * -(-lanes // sms)}
    if m >= 1:
        load = -(-n // m) * -(-(lanes * m) // sms)
        times["multi_block"] = (MULTI_BLOCK_US[0]
                                + MULTI_BLOCK_US[1] * n / 1024
                                + MULTI_BLOCK_US[2] * load / 1024)
    if cluster is not None:
        times["cluster"] = (CLUSTER_US[0] + CLUSTER_US[1] * n / 1024
                            + CLUSTER_US[2] * cluster.load / 1024
                            + CLUSTER_US[3] * cluster.rows)
    return min(times, key=times.get)


def _lane_args(dev, b, n, masks, Cs, it_caps, alphas, fs, n_iter, done,
               copy_f=True):
    """Check a chunk's per-lane tensors; C and the caps may come as host
    sequences and are moved to ``dev``. The state comes back as copies (f
    only if ``copy_f``), which the kernel then updates in place."""
    Cs = torch.as_tensor(Cs, dtype=torch.float64, device=dev).reshape(-1)
    it_caps = torch.as_tensor(it_caps, dtype=torch.int64,
                              device=dev).reshape(-1)
    for name, t, dtype, shape in (
            ("masks", masks, torch.bool, (b, n)),
            ("Cs", Cs, torch.float64, (b,)),
            ("it_caps", it_caps, torch.int64, (b,)),
            ("alphas", alphas, torch.float64, (b, n)),
            ("fs", fs, torch.float64, (b, n)),
            ("n_iter", n_iter, torch.int64, (b,)),
            ("done", done, torch.bool, (b,))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"smo chunk: {name} must be {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    copy = (lambda t: t.clone(memory_format=torch.contiguous_format))
    return (masks.contiguous(), Cs.contiguous(), it_caps.contiguous(),
            copy(alphas), copy(fs) if copy_f else fs.contiguous(),
            copy(n_iter), copy(done))


def _lanes_ref(one, masks, Cs, it_caps, alphas, fs, n_iter, done):
    """The plain loop lane by lane: ``one(mask, C, it_cap, alpha, f,
    n_iter, done)`` -> one lane's new state; stacked back into lanes."""
    Cs = torch.as_tensor(Cs, dtype=torch.float64).reshape(-1).tolist()
    caps = torch.as_tensor(it_caps).reshape(-1).tolist()
    outs = [one(masks[l], Cs[l], caps[l], alphas[l], fs[l], n_iter[l],
                done[l]) for l in range(masks.shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))


def smo_chunk_lanes(K, diag, y, masks, Cs, tol, it_caps, n_iters, wss,
                    alphas, fs, n_iter, done, _route=None, _rows=None,
                    _cluster=None):
    """Up to ``n_iters`` dense SMO iterations for each of b lanes over one
    K (n, n) float64. masks, alphas, fs (b, n); Cs, it_caps, n_iter, done
    (b,). Returns the new ``(alphas, fs, n_iter, done)``. A lane is bitwise
    the same whatever the other lanes of the launch, and on every route.
    ``_route`` (one of ``ROUTES``) overrides ``chunk_route``, ``_rows`` =
    (rows a thread, shared memory) the resident kernel's build (one of
    ``RESIDENT_BUILDS``), and ``_cluster`` = (blocks a cluster, rows a
    thread) the cluster kernel's shape, to check and time them against
    each other. A route or shape that cannot place the launch raises."""
    if wss not in ("1", "2"):
        raise ValueError(f"smo_chunk: wss must be '1' or '2', got {wss!r}")
    if K.device.type == "cpu":
        return _lanes_ref(
            lambda m, C, cap, a, f, it, dn: smo_chunk_ref(
                K, diag, y, m, C, tol, cap, n_iters, wss, a, f, it, dn),
            masks, Cs, it_caps, alphas, fs, n_iter, done)
    if K.device.type != "cuda":
        raise ValueError(f"smo_chunk: unsupported device {K.device}")
    n = K.shape[0]
    if K.dim() != 2 or K.shape[1] != n or n >= 2 ** 31:
        raise ValueError(f"smo_chunk: K must be square, got {tuple(K.shape)}")
    for name, t in (("K", K), ("diag", diag), ("y", y)):
        if t.device != K.device or t.dtype != torch.float64 \
                or t.shape[-1] != n:
            raise ValueError(f"smo_chunk: {name} must be float64 over {n} "
                             f"rows on {K.device}")
    return _dense_launch(smo_chunk, K.contiguous(), diag.contiguous(),
                         y.contiguous(), 0, 0, masks, Cs, tol, it_caps,
                         n_iters, wss, alphas, fs, n_iter, done, _route,
                         _rows, _cluster)


def smo_chunk_sources(K, diag, y, masks, Cs, tol, it_caps, n_iters, wss,
                      alphas, fs, n_iter, done, _route=None, _rows=None,
                      _cluster=None):
    """``smo_chunk_lanes`` over b lanes that each carry their own operands:
    K (b, n, n), diag and y (b, n) float64, lane l's at index l (the
    shrinking scheduler's compact lanes). One launch of the route's kernel,
    lane l reading K[l], diag[l] and y[l]; each lane is bitwise its own
    ``smo_chunk_lanes`` launch on its own operands, on every route, and the
    plain version. The route and its plans see n = the lanes' rows.
    ``_route`` / ``_rows`` / ``_cluster`` as for ``smo_chunk_lanes``; a
    launch that cannot be placed raises."""
    if wss not in ("1", "2"):
        raise ValueError(f"smo_chunk: wss must be '1' or '2', got {wss!r}")
    if K.device.type == "cpu":
        return smo_chunk_sources_ref(K, diag, y, masks, Cs, tol, it_caps,
                                     n_iters, wss, alphas, fs, n_iter, done)
    if K.device.type != "cuda":
        raise ValueError(f"smo_chunk: unsupported device {K.device}")
    b = masks.shape[0]
    if K.dim() != 3 or K.shape[0] != b or K.shape[1] != K.shape[2] \
            or K.shape[1] >= 2 ** 31:
        raise ValueError(f"smo_chunk_sources: K must be ({b}, n, n), got "
                         f"{tuple(K.shape)}")
    n = K.shape[1]
    for name, t, shape in (("K", K, (b, n, n)), ("diag", diag, (b, n)),
                           ("y", y, (b, n))):
        if t.device != K.device or t.dtype != torch.float64 \
                or tuple(t.shape) != shape:
            raise ValueError(f"smo_chunk_sources: {name} must be float64 "
                             f"{shape} on {K.device}")
    return _dense_launch(smo_chunk_sources, K.contiguous(),
                         diag.contiguous(), y.contiguous(), n * n, n, masks,
                         Cs, tol, it_caps, n_iters, wss, alphas, fs, n_iter,
                         done, _route, _rows, _cluster)


def _dense_launch(counter, K, diag, y, k_lane, v_lane, masks, Cs, tol,
                  it_caps, n_iters, wss, alphas, fs, n_iter, done, _route,
                  _rows, _cluster):
    """Place and launch the dense chunk over b lanes of n rows, lane l
    reading K + l k_lane, diag and y + l v_lane (elements; 0: shared), and
    count the launch on ``counter`` (the wrapper called)."""
    n = K.shape[-1]
    b = masks.shape[0]
    masks, Cs, it_caps, alphas, fs, n_iter, done = _lane_args(
        K.device, b, n, masks, Cs, it_caps, alphas, fs, n_iter, done)
    if _route not in (None, *ROUTES):
        raise ValueError(f"smo_chunk: route must be one of {ROUTES}, got "
                         f"{_route!r}")
    m, ws_bytes = multi_block_plan(n, b)
    sms = _sms()
    cplan = cluster_plan(n, b, cluster_capacity(n), sms)
    if _cluster is not None:
        cm, crows = _cluster
        if cluster_capacity(n).get((cm, crows), 0) < b:
            raise ValueError(f"smo_chunk: the cluster route cannot place {b}"
                             f" clusters of {cm} blocks at {crows} rows a "
                             f"thread over {n} rows on this card")
        cplan = cluster_shape(n, b, cm, crows, sms)
    path = _route or chunk_route(n, b, m, cplan, sms)
    if path == "multi_block" and m < 1:
        raise ValueError(f"smo_chunk: the multi-block route cannot place {b}"
                         f" lanes over {n} rows in this card's shared memory")
    if path == "cluster" and cplan is None:
        raise ValueError(f"smo_chunk: the cluster route cannot place {b} "
                         f"lanes over {n} rows on chip")
    if path == "one_block":
        if _rows is None:
            plan = one_block_plan(n)
        elif tuple(_rows) in RESIDENT_BUILDS:
            rows, smem = _rows
            threads = resident_threads(n, rows)
            plan = ((rows, threads, smem)
                    if threads <= resident_build(rows, smem)[0] else None)
        else:
            raise ValueError(f"smo_chunk: no resident build {_rows!r}")
        if plan is None:
            raise ValueError(f"smo_chunk: the one-block route cannot hold "
                             f"{n} rows a lane in one block"
                             + (f" at {_rows!r}" if _rows else ""))
    args = (K.data_ptr(), diag.data_ptr(), y.data_ptr(), masks.data_ptr(),
            Cs.data_ptr(), float(tol), it_caps.data_ptr(), int(n_iters),
            2 if wss == "2" else 1, alphas.data_ptr(), fs.data_ptr(),
            n_iter.data_ptr(), done.data_ptr(), n, b, int(k_lane),
            int(v_lane))
    types = (_P, _P, _P, _P, _P, _D, _P, _LL, _I, _P, _P, _P, _P, _I, _I,
             _LL, _LL)
    if path == "one_block":
        fn = _build.entry("smo_chunk", "smo_chunk_resident_f64", *types, _I,
                          _I, _P)
        err = fn(*args, plan[0], int(plan[2]), _build.stream_ptr(K))
    elif path == "cluster":
        fn = _build.entry("smo_chunk", "smo_chunk_cluster_f64", *types, _I,
                          _I, _P)
        err = fn(*args, cplan.blocks, cplan.rows, _build.stream_ptr(K))
    elif path == "one_block_global":
        fn = _build.entry("smo_chunk", "smo_chunk_f64", *types, _P)
        err = fn(*args, _build.stream_ptr(K))
    else:
        # the lanes' barrier counters start at 0 in every launch
        ws = torch.zeros(ws_bytes, dtype=torch.uint8, device=K.device)
        fn = _build.entry("smo_chunk", "smo_chunk_multi_f64", *types, _I, _P,
                          _P)
        err = fn(*args, m, ws.data_ptr(), _build.stream_ptr(K))
    _build.check(err, f"smo_chunk ({path})")
    counter.launches += 1
    counter.route_launches[path] += 1
    return alphas, fs, n_iter, done


def resident_build(rows: int, smem: bool) -> tuple[int, int, int]:
    """A build of the resident kernel, as built for the current device:
    (the most threads its block takes, registers a thread, local memory a
    thread in bytes: spills). The threads are csrc/smo_chunk.cu's
    ``Resident`` table (registers bound them); ``one_block_plan`` must
    place no wider block. Read once per device and build."""
    return _resident_build(torch.cuda.current_device(), rows, bool(smem))


@functools.lru_cache(maxsize=None)
def _resident_build(device: int, rows: int, smem: bool) -> tuple[int, int,
                                                                   int]:
    out = [ctypes.c_int(0) for _ in range(3)]
    fn = _build.entry("smo_chunk", "smo_chunk_resident_build", _I, _I, _P,
                      _P, _P)
    _build.check(fn(rows, int(smem), *map(ctypes.addressof, out)),
                 f"smo_chunk_resident_build({rows}, {smem})")
    return tuple(v.value for v in out)


def multi_block_plan(n: int, b: int) -> tuple[int, int]:
    """The multi-block route's (blocks per lane, workspace bytes) for b
    lanes over n rows on the current device: the most blocks, up to about
    256 rows a block, for which each slice fits a block's shared memory and
    all b * m blocks are resident at once (a cooperative launch); 0 blocks
    when none fits. Computed once per device, n and b."""
    return _plan(torch.cuda.current_device(), n, b)


@functools.lru_cache(maxsize=None)
def _plan(device: int, n: int, b: int) -> tuple[int, int]:
    m, ws = ctypes.c_int(0), ctypes.c_longlong(0)
    fn = _build.entry("smo_chunk", "smo_chunk_multi_plan", _I, _I, _P, _P)
    _build.check(fn(n, b, ctypes.addressof(m), ctypes.addressof(ws)),
                 "smo_chunk_multi_plan")
    return m.value, ws.value


def cluster_capacity(n: int) -> dict[tuple[int, int], int]:
    """{(blocks a cluster, rows a thread): clusters the current device runs
    at once} for the cluster kernel over n rows, every size of
    ``CLUSTER_SIZES`` and build of ``CLUSTER_ROWS`` (0 where the build
    cannot take the block), from the CUDA occupancy calculator, which
    knows how the card's GPCs hold clusters. Computed once per device and
    n."""
    return _cluster_capacity(torch.cuda.current_device(), n)


@functools.lru_cache(maxsize=None)
def _cluster_capacity(device: int, n: int) -> dict[tuple[int, int], int]:
    fn = _build.entry("smo_chunk", "smo_chunk_cluster_capacity", _I, _I, _I,
                      _P)
    out = {}
    for m in CLUSTER_SIZES:
        for rows in CLUSTER_ROWS:
            c = ctypes.c_int(0)
            _build.check(fn(n, m, rows, ctypes.addressof(c)),
                         f"smo_chunk_cluster_capacity({n}, {m}, {rows})")
            out[(m, rows)] = c.value
    return out


def cluster_build(rows: int) -> tuple[int, int, int]:
    """A build of the cluster kernel, as built for the current device: (the
    most threads its block takes, registers a thread, local memory a thread
    in bytes: spills). Read once per device and build."""
    return _cluster_build(torch.cuda.current_device(), rows)


@functools.lru_cache(maxsize=None)
def _cluster_build(device: int, rows: int) -> tuple[int, int, int]:
    out = [ctypes.c_int(0) for _ in range(3)]
    fn = _build.entry("smo_chunk", "smo_chunk_cluster_build", _I, _P, _P, _P)
    _build.check(fn(rows, *map(ctypes.addressof, out)),
                 f"smo_chunk_cluster_build({rows})")
    return tuple(v.value for v in out)


def _sms() -> int:
    """The current device's SMs."""
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count


def smo_chunk(K, diag, y, mask, C, tol, it_cap, n_iters, wss, alpha, f,
              n_iter, done, _route=None, _rows=None, _cluster=None):
    """Up to ``n_iters`` dense SMO iterations from ``(alpha, f, n_iter,
    done)`` over K (n, n) float64; returns the new ``(alpha, f, n_iter,
    done)``. ``C``, ``tol``, ``it_cap`` and ``n_iters`` are host scalars.
    On the card: the lane kernel at one lane."""
    if K.device.type == "cpu":
        return smo_chunk_ref(K, diag, y, mask, C, tol, it_cap, n_iters, wss,
                             alpha, f, n_iter, done)
    out = smo_chunk_lanes(K, diag, y, mask[None], [float(C)], tol,
                          [int(it_cap)], n_iters, wss, alpha[None], f[None],
                          n_iter.reshape(1), done.reshape(1), _route=_route,
                          _rows=_rows, _cluster=_cluster)
    return tuple(t[0] for t in out)


smo_chunk.launches = 0
smo_chunk.route_launches = dict.fromkeys(ROUTES, 0)
smo_chunk_sources.launches = 0
smo_chunk_sources.route_launches = dict.fromkeys(ROUTES, 0)


class StreamClusterPlan(NamedTuple):
    """Where the cluster route holds a launch's lanes: its blocks (all
    resident at once), blocks a cluster, rows a block, and row blocks of 8
    a warp (tiles of 64 ``rb`` rows; one tile a block)."""
    blocks: int
    cluster: int
    slice: int
    rb: int


def stream_tile_rb(slice_: int) -> int:
    """Row blocks of 8 a warp for slices of ``slice_`` rows on the one-launch
    streaming routes: 2 (tiles of 128 rows) up to 128 rows, else 4."""
    return 2 if slice_ <= 128 else 4


def stream_cluster_plan(n: int, b: int,
                        capacity: dict) -> StreamClusterPlan | None:
    """Where the cluster route holds b lanes over n rows, given
    ``capacity`` {(blocks a cluster, row blocks a warp): clusters the card
    runs at once} (``stream_cluster_capacity``): for each cluster size C,
    about ``STREAM_BLOCK_ROWS`` rows a block over as many whole clusters as
    the card holds, each block's slice one tile; of those, the smaller
    tiles, then the fewest warps with rows, then the larger clusters (the
    fewest records a lane to exchange). None past 16 lanes or where no
    cluster size places every row. Pure: the card enters through
    ``capacity``."""
    if not 1 <= b <= 16 or n < 1:
        return None
    want = -(-n // STREAM_BLOCK_ROWS)
    plans = []
    for (c, rb), clusters in capacity.items():
        if clusters < 1:
            continue
        m = min(clusters, -(-want // c)) * c
        slice_ = -(-n // m)
        if stream_tile_rb(slice_) == rb and slice_ <= 64 * rb:
            plans.append(StreamClusterPlan(m, c, slice_, rb))
    return min(plans, key=lambda p: (p.rb, -(-p.slice // (8 * p.rb)),
                                     -p.cluster), default=None)


def stream_features(b: int, rb: int, blocks: int, d: int) -> tuple:
    """The features of ``STREAM_US``'s model for b lanes on a launch of
    ``blocks`` blocks whose warps carry ``rb`` row blocks of 8, over d
    features."""
    nvb = -(-b // 4)
    return (1.0, nvb, nvb * nvb, rb, blocks / 128, -(-d // 4) / 32)


def stream_route(n: int, d: int, b: int, m: int,
                 cluster: StreamClusterPlan | None) -> str:
    """The streaming chunk's route for b lanes over n rows of d features:
    of the one-launch routes that place them (``m`` the blocks
    ``stream_plan`` gives the persistent route, 0: none; ``cluster`` what
    ``stream_cluster_plan`` gives, None: none), the fastest by
    ``STREAM_US``, else pairs."""
    shapes = {}
    if m >= 1:
        shapes["persistent"] = (stream_tile_rb(-(-n // m)), m)
    if cluster is not None:
        shapes["cluster"] = (cluster.rb, cluster.blocks)
    times = {r: sum(c * f for c, f in zip(STREAM_US[r], stream_features(
        b, rb, blocks, d))) for r, (rb, blocks) in shapes.items()}
    return min(times, key=times.get) if times else "pair"


def stream_cluster_capacity(d: int, b: int) -> dict[tuple[int, int], int]:
    """{(blocks a cluster, row blocks a warp): clusters the current device
    runs at once} for the cluster route over d features and b lanes, every
    size of ``STREAM_CLUSTER_SIZES`` and tile of ``STREAM_TILES``, each
    block with the shared memory the kernel takes (0 where it cannot hold
    a block), from the CUDA occupancy calculator. Computed once per
    device, d and b."""
    return _stream_cluster_capacity(torch.cuda.current_device(), d, b)


@functools.lru_cache(maxsize=None)
def _stream_cluster_capacity(device: int, d: int,
                             b: int) -> dict[tuple[int, int], int]:
    fn = _build.entry("smo_stream", "smo_stream_cluster_capacity", _I, _I,
                      _I, _I, _P)
    out = {}
    for c in STREAM_CLUSTER_SIZES:
        for rb in STREAM_TILES:
            k = ctypes.c_int(0)
            _build.check(fn(d, b, c, rb, ctypes.addressof(k)),
                         f"smo_stream_cluster_capacity({d}, {b}, {c}, {rb})")
            out[(c, rb)] = k.value
    return out


def stream_cluster_layout(d: int, b: int, rb: int) -> dict[str, int]:
    """How a block of the cluster route holds X on the current device for
    d features, b lanes and row blocks of 8 a warp ``rb``: its k-steps of
    four features, those resident in shared memory for the launch, the
    ring's stages that stream the others, and its dynamic shared memory in
    bytes."""
    return _stream_cluster_layout(torch.cuda.current_device(), d, b, rb)


@functools.lru_cache(maxsize=None)
def _stream_cluster_layout(device: int, d: int, b: int,
                           rb: int) -> dict[str, int]:
    out = [ctypes.c_int(0) for _ in range(3)]
    smem = ctypes.c_longlong(0)
    fn = _build.entry("smo_stream", "smo_stream_cluster_layout", _I, _I, _I,
                      _P, _P, _P, _P)
    _build.check(fn(d, b, rb, *map(ctypes.addressof, out),
                    ctypes.addressof(smem)), "smo_stream_cluster_layout")
    return {"ksteps": out[0].value, "resident": out[1].value,
            "stages": out[2].value, "smem_bytes": smem.value}


def stream_cluster_workspace(b: int, plan: StreamClusterPlan) -> int:
    """Bytes of the cluster route's workspace: the grid's barrier counter
    (16 bytes, zeroed), then two parities of a 48-byte record for each
    lane, kind (b_up, b_low) and cluster."""
    return 16 + 2 * b * 2 * (plan.blocks // plan.cluster) * 48


def stream_plan(n: int, d: int, b: int,
                groups: int = 1) -> tuple[int, int, int]:
    """The persistent route's (blocks, rows a block, workspace bytes) for b
    lanes over n rows of d features on the current device: about 128 rows
    a block, every block resident at once, the slice's state in a block's
    shared memory; 0 blocks past 16 lanes or when the state does not fit.
    ``groups`` such launches side by side (lanes with their own X: b = 1,
    a lane a group) take that many blocks each, all resident at once.
    Computed once per device, n, d, b and groups."""
    return _stream_plan(torch.cuda.current_device(), n, d, b, groups)


@functools.lru_cache(maxsize=None)
def _stream_plan(device: int, n: int, d: int, b: int,
                 groups: int) -> tuple[int, int, int]:
    m, slice_, ws = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_longlong(0)
    fn = _build.entry("smo_step", "smo_stream_plan", _I, _I, _I, _I, _P, _P,
                      _P)
    _build.check(fn(n, d, b, groups, ctypes.addressof(m),
                    ctypes.addressof(slice_), ctypes.addressof(ws)),
                 "smo_stream_plan")
    return m.value, slice_.value, ws.value


def pad_rows(X):
    """X (n, d) float64 as the persistent streaming route reads it: each row
    on a 16-byte boundary (it copies two features at a time), with a zero
    column past an odd d. X itself where it already is so (or off the
    card), else an (n, d) view of a zeroed (n, d + 1) copy. A caller that
    runs many chunks over one X makes this once and passes it on. Stacked
    lanes' X (b, n, d) pad the same way, lane by lane."""
    d = X.shape[-1]
    if X.device.type != "cuda" or (d % 2 == 0 and X.stride(-1) == 1
                                   and all(s % 2 == 0
                                           for s in X.stride()[:-1])
                                   and X.data_ptr() % 16 == 0):
        return X
    Xp = torch.zeros((*X.shape[:-1], d + d % 2), dtype=X.dtype,
                     device=X.device)
    Xp[..., :d] = X
    return Xp[..., :d]


def seq_norms(X):
    """|x|^2 of each row of X (n, d), summed in order of k with each product
    and each sum rounded on its own (the order of ``fused_smo_step``'s pair
    norms): the table from which both streaming routes' kernels take
    |x_i|^2 for K[i, j], so this loop alone fixes its rounding. A caller
    that runs many chunks over one X makes it once and passes it on.
    Stacked lanes' X (b, n, d) give (b, n)."""
    sn = torch.zeros(X.shape[:-1], dtype=X.dtype, device=X.device)
    for k in range(X.shape[-1]):
        sn = sn + X[..., k] * X[..., k]
    return sn


def _norms_arg(X, X_norms):
    """``X_norms``, checked: the card's kernels need ``seq_norms(X)``."""
    if X_norms is None or X_norms.device != X.device \
            or X_norms.dtype != torch.float64 \
            or tuple(X_norms.shape) != tuple(X.shape[:-1]):
        raise ValueError("X_norms must be seq_norms(X)")
    return X_norms.contiguous()


def smo_stream_chunk(X, sq_norms, gamma, y, masks, Cs, tol, it_caps,
                     n_iters, alphas, fs, n_iter, done, *, X_rows=None,
                     X_norms=None, _route=None):
    """Up to ``n_iters`` streaming WSS-1 SMO iterations for each of b lanes
    over one RBF source (X (n, d), sq_norms (n,), gamma; K_ii = 1), float64.
    Lane tensors as for ``smo_chunk_lanes``. Returns the new ``(alphas, fs,
    n_iter, done)``, bitwise the same on either route and whatever the
    lanes launched beside a lane.

    On the card the ``cluster`` and ``persistent`` routes run the chunk in
    one launch that ends when every lane is done; the ``pair`` route launches, per
    iteration, the selection kernel (a block per lane: the pair, K[i, j],
    delta and alpha) and ``fused_smo_step`` over all lanes, and stops
    within 128 iterations of every lane's stop (a done lane's blocks exit
    at once meanwhile); both their counts grow by the iterations it
    launched. ``X_norms`` is ``seq_norms(X)``, which both routes read and
    the card requires (the plain version on the CPU reads none); ``X_rows``
    is ``pad_rows(X)`` (the one-launch routes'), made per call when not
    given. ``_route`` overrides ``stream_route``, to check and time the
    routes against each other; a route that cannot place the lanes
    raises."""
    n, d = X.shape
    if X.device.type == "cpu":
        ones = torch.ones(n, dtype=X.dtype)
        stream = (X, sq_norms, float(gamma))
        return _lanes_ref(
            lambda m, C, cap, a, f, it, dn: smo_chunk_ref(
                None, ones, y, m, C, tol, cap, n_iters, "1", a, f, it, dn,
                stream=stream),
            masks, Cs, it_caps, alphas, fs, n_iter, done)
    if X.device.type != "cuda":
        raise ValueError(f"smo_stream_chunk: unsupported device {X.device}")
    for name, t, shape in (("X", X, (n, d)), ("sq_norms", sq_norms, (n,)),
                           ("y", y, (n,))):
        if t.device != X.device or t.dtype != torch.float64 \
                or tuple(t.shape) != shape:
            raise ValueError(f"smo_stream_chunk: {name} must be float64 "
                             f"{shape} on {X.device}")
    return _stream_launch(smo_stream_chunk, X, sq_norms, gamma, y, masks, Cs,
                          tol, it_caps, n_iters, alphas, fs, n_iter, done,
                          X_rows, X_norms, _route, per_lane=False)


def _stream_launch(counter, X, sq_norms, gamma, y, masks, Cs, tol, it_caps,
                   n_iters, alphas, fs, n_iter, done, X_rows, X_norms,
                   _route, *, per_lane: bool):
    """Place and launch the streaming chunk over b lanes of n rows: one X
    (n, d) for every lane, or (``per_lane``) lane l's own X[l] (b, n, d)
    with its norms and labels at index l, each lane then a group of its
    own on the persistent route and a stride of its own on the pair route.
    Count the chunk on ``counter`` (the wrapper called)."""
    n, d = X.shape[-2:]
    b = masks.shape[0]
    if max(n, d) >= 2 ** 31:
        raise ValueError("smo_stream_chunk: n and d must be below 2**31")
    routes = STREAM_SOURCES_ROUTES if per_lane else STREAM_ROUTES
    if _route not in (None, *routes):
        raise ValueError(f"smo_stream_chunk: route must be one of "
                         f"{routes}, got {_route!r}")
    masks, Cs, it_caps, alphas, fs, n_iter, done = _lane_args(
        X.device, b, n, masks, Cs, it_caps, alphas, fs, n_iter, done)
    sq_norms, y = sq_norms.contiguous(), y.contiguous()
    sn = _norms_arg(X, X_norms)
    # lanes a group, groups, and the element stride of the norms and labels
    lanes, groups, v_lane = (1, b, n) if per_lane else (b, 1, 0)
    m, slice_, ws_bytes = stream_plan(n, d, lanes, groups)
    cplan = None if per_lane else stream_cluster_plan(
        n, b, stream_cluster_capacity(d, b))
    path = _route or stream_route(n, d, lanes, m, cplan)
    if path == "persistent" and m < 1:
        raise ValueError(f"smo_stream_chunk: the persistent route cannot "
                         f"place {b} lanes over {'their own ' * per_lane}"
                         f"{n} x {d} on this card")
    if path == "cluster" and cplan is None:
        raise ValueError(f"smo_stream_chunk: the cluster route cannot place "
                         f"{b} lanes over {'their own ' * per_lane}{n} x {d}"
                         " on this card")
    args = (sq_norms.data_ptr(), sn.data_ptr(), y.data_ptr(),
            masks.data_ptr(), Cs.data_ptr(), float(tol), it_caps.data_ptr(),
            int(n_iters), float(gamma), alphas.data_ptr(), fs.data_ptr(),
            n_iter.data_ptr(), done.data_ptr())
    types = (_P, _P, _P, _P, _P, _D, _P, _LL, _D, _P, _P, _P, _P)
    if path in ("persistent", "cluster"):
        Xp = pad_rows(X) if X_rows is None else X_rows
        if tuple(Xp.shape) != tuple(X.shape) or Xp.stride(-1) != 1 \
                or any(st % 2 for st in Xp.stride()[:-1]) \
                or (per_lane and Xp.stride(0) < n * Xp.stride(1)) \
                or Xp.data_ptr() % 16:
            raise ValueError("smo_stream_chunk: X_rows must be pad_rows(X)")
    if path == "persistent":
        # the barrier counters start at 0 in every launch
        ws = torch.zeros(ws_bytes, dtype=torch.uint8, device=X.device)
        fn = _build.entry("smo_step", "smo_stream_persistent_f64", _P,
                          *types, _I, _I, _I, _I, _I, _I, _P, _LL, _LL, _I,
                          _P)
        err = fn(Xp.data_ptr(), *args, n, d, Xp.stride(-2), lanes, m,
                 slice_, ws.data_ptr(), Xp.stride(0) if per_lane else 0,
                 v_lane, groups, _build.stream_ptr(X))
        _build.check(err, "smo_stream_chunk (persistent)")
        if n_iters > 0:
            counter.launches += 1
    elif path == "cluster":
        ws = torch.zeros(stream_cluster_workspace(b, cplan),
                         dtype=torch.uint8, device=X.device)
        fn = _build.entry("smo_stream", "smo_stream_cluster_f64", _P, *types,
                          _I, _I, _I, _I, _I, _I, _I, _P, _P)
        err = fn(Xp.data_ptr(), *args, n, d, Xp.stride(-2), b, cplan.blocks,
                 cplan.cluster, cplan.slice, ws.data_ptr(),
                 _build.stream_ptr(X))
        _build.check(err, "smo_stream_chunk (cluster)")
        if n_iters > 0:
            counter.launches += 1
    else:
        X = X.contiguous()   # the pair route reads rows d apart
        xij = torch.empty((b, 2, d), dtype=torch.float64, device=X.device)
        delta = torch.zeros(b, dtype=torch.float64, device=X.device)
        fn = _build.entry("smo_step", "smo_stream_chunk_f64", _P, *types, _P,
                          _P, _I, _I, _I, _LL, _LL, _P, _P)
        issued = ctypes.c_longlong(0)
        err = fn(X.data_ptr(), *args, xij.data_ptr(), delta.data_ptr(), n, d,
                 b, n * d if per_lane else 0, v_lane, _build.stream_ptr(X),
                 ctypes.addressof(issued))
        smo_select.launches += issued.value
        fused_smo_step.launches += issued.value
        _build.check(err, "smo_stream_chunk (pair)")
    counter.route_launches[path] += 1
    return alphas, fs, n_iter, done


smo_stream_chunk.launches = 0
smo_stream_chunk.route_launches = dict.fromkeys(STREAM_ROUTES, 0)


def smo_stream_chunk_sources(X, sq_norms, gamma, y, masks, Cs, tol, it_caps,
                             n_iters, alphas, fs, n_iter, done, *,
                             X_rows=None, X_norms=None, _route=None):
    """``smo_stream_chunk`` over b lanes that each carry their own RBF
    operands: X (b, n, d), sq_norms and y (b, n) float64, lane l's at index
    l (the shrinking scheduler's compact lanes), one gamma. Lane tensors as
    for ``smo_stream_chunk``; returns the new ``(alphas, fs, n_iter,
    done)``, each lane bitwise its own ``smo_stream_chunk`` on its own
    operands, on either route, and the plain version.

    ``persistent``: one cooperative launch, each lane over its own group of
    blocks (``stream_plan(n, d, 1, b)``); ``pair``: per iteration the
    selection kernel (a block a lane, reading its lane's X) and
    ``fused_smo_step`` (a grid row a lane, streaming its lane's X).
    ``X_norms`` is ``seq_norms(X)`` (b, n), required on the card;
    ``X_rows`` is ``pad_rows(X)``, made per call when not given.
    ``_route`` (one of ``STREAM_SOURCES_ROUTES``) overrides
    ``stream_route``; a route that cannot place the lanes raises."""
    if X.device.type == "cpu":
        return smo_chunk_sources_ref(
            None, None, y, masks, Cs, tol, it_caps, n_iters, "1", alphas, fs,
            n_iter, done, stream=(X, sq_norms, float(gamma)))
    if X.device.type != "cuda":
        raise ValueError(f"smo_stream_chunk: unsupported device {X.device}")
    b = masks.shape[0]
    if X.dim() != 3 or X.shape[0] != b:
        raise ValueError(f"smo_stream_chunk_sources: X must be ({b}, n, d), "
                         f"got {tuple(X.shape)}")
    _, n, d = X.shape
    for name, t, shape in (("X", X, (b, n, d)),
                           ("sq_norms", sq_norms, (b, n)),
                           ("y", y, (b, n))):
        if t.device != X.device or t.dtype != torch.float64 \
                or tuple(t.shape) != shape:
            raise ValueError(f"smo_stream_chunk_sources: {name} must be "
                             f"float64 {shape} on {X.device}")
    return _stream_launch(smo_stream_chunk_sources, X, sq_norms, gamma, y,
                          masks, Cs, tol, it_caps, n_iters, alphas, fs,
                          n_iter, done, X_rows, X_norms, _route,
                          per_lane=True)


smo_stream_chunk_sources.launches = 0
smo_stream_chunk_sources.route_launches = dict.fromkeys(
    STREAM_SOURCES_ROUTES, 0)


def smo_select(X, sq_norms, gamma, y, masks, Cs, tol, it_caps, alphas, fs,
               n_iter, done, *, X_norms=None):
    """One streaming WSS-1 selection step for each of b lanes (lane tensors
    as for ``smo_stream_chunk``): the freeze test, the maximal violating
    pair, K[i, j], the clipped delta and the new (box-clipped) alpha.
    Returns new ``(alphas, n_iter, done, xij, delta)``: the pair rows (b,
    2, d) and delta (b,) that ``fused_smo_step`` takes next (zeros for a
    lane that did not step). The streaming chunk runs this kernel once per
    iteration; this wrapper launches it alone, to check and time it, and
    clips the whole of alpha, as the plain step does. ``X_norms`` is
    ``seq_norms(X)``, which the card requires (the plain version on the CPU
    reads none)."""
    if X.device.type == "cpu":
        return smo_select_lanes_ref(X, sq_norms, gamma, y, masks, Cs, tol,
                                    it_caps, alphas, fs, n_iter, done)
    if X.device.type != "cuda":
        raise ValueError(f"smo_select: unsupported device {X.device}")
    n, d = X.shape
    b = masks.shape[0]
    masks, Cs, it_caps, alphas, fs, n_iter, done = _lane_args(
        X.device, b, n, masks, Cs, it_caps, alphas, fs, n_iter, done,
        copy_f=False)
    xij = torch.zeros((b, 2, d), dtype=torch.float64, device=X.device)
    delta = torch.zeros(b, dtype=torch.float64, device=X.device)
    X, sq_norms, y = X.contiguous(), sq_norms.contiguous(), y.contiguous()
    sn = _norms_arg(X, X_norms)
    fn = _build.entry("smo_step", "smo_select_f64", _P, _P, _P, _P, _P, _P,
                      _D, _P, _D, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
    err = fn(X.data_ptr(), sq_norms.data_ptr(), sn.data_ptr(), y.data_ptr(),
             masks.data_ptr(), Cs.data_ptr(), float(tol), it_caps.data_ptr(),
             float(gamma), alphas.data_ptr(), fs.data_ptr(),
             n_iter.data_ptr(), done.data_ptr(), xij.data_ptr(),
             delta.data_ptr(), n, d, b, 1, _build.stream_ptr(X))
    _build.check(err, "smo_select")
    smo_select.launches += 1
    return alphas, n_iter, done, xij, delta


smo_select.launches = 0
