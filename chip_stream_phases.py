"""Where an iteration of the one-launch streaming chunks goes, on one
NVIDIA GPU.

    python3 chip_stream_phases.py

No ``ncu`` runs on the card's machine, so this script builds copies of
``csrc/smo_step.cu`` (the ``persistent`` route's kernel) and
``csrc/smo_stream.cu`` (the ``cluster`` route's) in a temporary directory,
never in the repository, one ``nvcc`` each, both started together. In each
copy thread 0 of three blocks (the first, the middle and the last) reads
the SM's cycle counter (``clock64``) at every step of an iteration's
chain, for the first ``ITERS`` iterations:

* ``persistent``: the grid barrier, the reduction of every block's
  candidates, the pick, the pair rows' staging, the slabs' products, the
  exps with the side warp's scalar step, the f-update, the block's
  candidate reduction (with the serial pass over the warps' slots), the
  store of the block's candidates;
* ``cluster``: the grid barrier, the reduction of the clusters' records,
  the pick (and a stopped lane's write-back), the pair rows' staging once
  a cluster (with its cluster barrier), the products over the resident
  and streamed k-steps, the exps with the scalar step, the f-update, the
  block's candidate reduction up to the cluster barrier, and the cluster
  exchange (rank 0's reduction of the cluster's records and its arrival).

It runs each at ``size_matrix_free``'s shape: adult's first 32,560 rows (d
= 123), ten cold lanes each holding out a tenth, capped at ``CAP``
iterations, a warm-up and then ``REPS`` launches, and prints the card's
name and power limit first, then one JSON object: each phase's median
cycles an iteration (over the iterations, the three blocks and the runs)
and, at the card's most SM clock (``nvidia-smi``), microseconds, beside
the iteration's whole median and each stamped launch's time an iteration
(the reads cost a little). The copies find their edits by the text of
the sources, so an edit to those lines of either kernel must be made here
too (a build that cannot find its text raises;
``tests/test_torch_chip_scripts.py`` checks it on the CPU).
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")

N, LANES, CAP, REPS = 32560, 10, 300, 3
#: iterations stamped, and counter reads an iteration
ITERS, SLOTS = 300, 10
#: the phases each read closes (read k - 1 to read k)
PHASES = {
    "persistent": ("barrier", "reduce", "pick", "pair_staging", "slabs",
                   "exps_scalar_step", "f_update", "candidate_reduction",
                   "store"),
    "cluster": ("barrier", "reduce", "pick", "pair_staging", "slabs",
                "exps_scalar_step", "f_update", "candidate_reduction",
                "cluster_exchange")}
HEAD = f"""
__device__ long long g_stream_stamps[3][{ITERS}][{SLOTS}];
__device__ __forceinline__ int stream_stamp_slot() {{
  return blockIdx.x == 0 ? 0
         : blockIdx.x == gridDim.x / 2 ? 1
         : blockIdx.x == gridDim.x - 1 ? 2 : -1;
}}
"""
#: a counter read at iteration `it` (a variable of the kernel), slot k
STAMP = ("if (threadIdx.x == 0 && {it} >= 0 && {it} < " + str(ITERS)
         + " && stream_stamp_slot() >= 0) g_stream_stamps"
         "[stream_stamp_slot()][{it}][{k}] = clock64();")
TAIL = f"""
extern "C" int stream_phase_stamps(long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_stream_stamps,
                                   sizeof(long long) * 3 * {ITERS} * {SLOTS});
}}
extern "C" int stream_phase_clear() {{
  static long long zeros[3][{ITERS}][{SLOTS}];
  return (int)cudaMemcpyToSymbol(g_stream_stamps, zeros, sizeof(zeros));
}}
"""


def _s(k: int, it: str = "t") -> str:
    return STAMP.format(it=it, k=k)


#: route -> (source, ((text, its replacement), ...)): the counter reads
EDITS = {
    "persistent": ("smo_step.cu", (
        ("#include \"smo_common.cuh\"\n",
         "#include \"smo_common.cuh\"\n" + HEAD),
        ("    lane_barrier(counter, (unsigned long long)(t + 1) * m);\n"
         "    reduce(set);\n    __syncthreads();\n",
         "    " + _s(0) + "\n"
         "    lane_barrier(counter, (unsigned long long)(t + 1) * m);\n    "
         + _s(1) + "\n    reduce(set);\n    __syncthreads();\n    "
         + _s(2) + "\n"),
        ("    if (G == 0) break;  // uniform: every block reduced the same "
         "picks\n    stage_pairs(ps, d, G, [&](int w) {",
         "    if (G == 0) break;  // uniform: every block reduced the same "
         "picks\n    " + _s(3) + "\n    stage_pairs(ps, d, G, [&](int w) {"),
        ("    cp_async_wait_all();\n    __syncthreads();\n    // row pass;",
         "    cp_async_wait_all();\n    __syncthreads();\n    " + _s(4)
         + "\n    // row pass;"),
        ("      // the cells' K, over their dot products: they need only the "
         "norms,\n",
         "      if (tile == 0) " + _s(5) + "\n"
         "      // the cells' K, over their dot products: they need only the "
         "norms,\n"),
        ("        __syncthreads();  // delta and the owners' alphas, before "
         "the f-update\n",
         "        __syncthreads();  // delta and the owners' alphas, before "
         "the f-update\n        " + _s(6) + "\n"),
        ("    clip_all = false;\n    if (t + 1 == n_iters) break;\n",
         "    " + _s(7) + "\n    clip_all = false;\n"
         "    if (t + 1 == n_iters) break;\n"),
        ("    store(set ^ 1);\n  }\n",
         "    " + _s(8) + "\n    store(set ^ 1);\n    " + _s(9) + "\n  }\n"),
    )),
    "cluster": ("smo_stream.cu", (
        ("#include \"smo_common.cuh\"\n",
         "#include \"smo_common.cuh\"\n" + HEAD),
        ("  const cg::cluster_group cluster = cg::this_cluster();\n",
         "  const cg::cluster_group cluster = cg::this_cluster();\n"
         "  long long stamp_t = -1;\n"),
        ("    grid_wait(t);\n    reduce(set);\n    cluster.sync();\n",
         "    stamp_t = t;\n    " + _s(0) + "\n    grid_wait(t);\n    "
         + _s(1) + "\n    reduce(set);\n    cluster.sync();\n    "
         + _s(2) + "\n"),
        ("    if (G == 0) break;  // uniform: every block reduced the same "
         "picks\n    const int nvb = (G + 3) / 4;\n",
         "    if (G == 0) break;  // uniform: every block reduced the same "
         "picks\n    " + _s(3) + "\n    const int nvb = (G + 3) / 4;\n"),
        ("      cluster.sync();\n    }\n\n    // the products in order of k,",
         "      cluster.sync();\n    }\n    " + _s(4)
         + "\n\n    // the products in order of k,"),
        ("    // the cells' K, over their dot products (no branches between "
         "the\n",
         "    " + _s(5) + "\n"
         "    // the cells' K, over their dot products (no branches between "
         "the\n"),
        ("    __syncthreads();  // delta and the pair's alphas, before the "
         "f-update\n",
         "    __syncthreads();  // delta and the pair's alphas, before the "
         "f-update\n    " + _s(6) + "\n"),
        ("    clip_all = false;\n    if (t + 1 == n_iters) break;\n"
         "    publish(set ^ 1, G);\n",
         "    " + _s(7) + "\n    clip_all = false;\n"
         "    if (t + 1 == n_iters) break;\n    publish(set ^ 1, G);\n    "
         + _s(9) + "\n"),
        ("    cluster.sync();\n    if (rank == 0) {\n",
         "    cluster.sync();\n    " + _s(8, "stamp_t")
         + "\n    if (rank == 0) {\n"),
    ))}


def edited(route: str) -> str:
    """The stamped copy's text of a route's source."""
    name, edits = EDITS[route]
    with open(os.path.join(CSRC, name)) as fh:
        src = fh.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: text not found once: {old!r}")
        src = src.replace(old, new)
    return src + TAIL


def build(tmp: str) -> dict:
    """{route: library} of the stamped copies, every ``nvcc`` at once."""
    from repro_torch.kernels import _build
    for name in os.listdir(CSRC):
        if name.endswith(".cuh"):
            with open(os.path.join(CSRC, name)) as fh, \
                    open(os.path.join(tmp, name), "w") as out:
                out.write(fh.read())
    procs = {}
    for route, (name, _) in EDITS.items():
        cu = os.path.join(tmp, f"{route}.cu")
        lib = os.path.join(tmp, f"lib{route}.so")
        with open(cu, "w") as fh:
            fh.write(edited(route))
        procs[route] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.flags(name[:-3]), "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for route, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {route}:\n{log}")
        libs[route] = lib
    return libs


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def phases(route: str, runs) -> dict:
    """Median cycles of each phase an iteration over the stamped runs
    (each [block][iteration][read]), and of the whole iteration."""
    names = PHASES[route]
    out = {p: [] for p in names}
    whole = []
    for run in runs:
        for blk in run:
            for it in range(ITERS):
                row = blk[it]
                if all(row[k] for k in range(SLOTS)):
                    for k, p in enumerate(names):
                        out[p].append(row[k + 1] - row[k])
                if it + 1 < ITERS and row[0] and blk[it + 1][0]:
                    whole.append(blk[it + 1][0] - row[0])
    rec = {p: median(v) for p, v in out.items()}
    rec["iteration"] = median(whole)
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_stream_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from repro_torch.data.svm_suite import make_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels import smo_chunk as sc
    _build.build_all(("smo_step", "smo_stream"))
    print(c.card_line(), flush=True)
    dev = torch.device("cuda")
    ds = make_dataset("adult", n_override=N + 1)
    X = torch.as_tensor(ds.X[:N], device=dev)
    Xp = sc.pad_rows(X)
    y = torch.as_tensor(ds.y[:N], dtype=torch.float64, device=dev)
    sq, sn = torch.sum(X * X, -1), sc.seq_norms(X)
    d = X.shape[1]
    masks, _ = c._stream_lanes(X, y, LANES, dev)
    Cs = torch.full((LANES,), ds.C, dtype=torch.float64, device=dev)
    caps = torch.full((LANES,), CAP, dtype=torch.int64, device=dev)
    m, slice_, ws_bytes = sc.stream_plan(N, d, LANES)
    cplan = sc.stream_cluster_plan(N, LANES,
                                   sc.stream_cluster_capacity(d, LANES))
    if m < 1 or cplan is None:
        raise RuntimeError(f"a route does not place the lanes: {m}, {cplan}")
    _P, _I, _D, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                       ctypes.c_longlong)
    common = [_P] * 6 + [_D, _P, _LL, _D, _P, _P, _P, _P, _I, _I, _I, _I]
    out = {"n": N, "d": d, "lanes": LANES, "cap": CAP,
           "persistent_plan": {"blocks": m, "slice": slice_},
           "cluster_plan": cplan._asdict(),
           "cluster_layout": sc.stream_cluster_layout(d, LANES, cplan.rb)}
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        for route, path in build(tmp).items():
            lib = ctypes.CDLL(path)
            stamps, clear = lib.stream_phase_stamps, lib.stream_phase_clear
            stamps.argtypes, stamps.restype = [_P], ctypes.c_int
            clear.argtypes, clear.restype = [], ctypes.c_int
            if route == "persistent":
                fn = lib.smo_stream_persistent_f64
                fn.argtypes = common + [_I, _I, _P, _LL, _LL, _I, _P]
                tail = lambda ws: (m, slice_, ws, 0, 0, 1, stream)  # noqa
                ws_n = ws_bytes
            else:
                fn = lib.smo_stream_cluster_f64
                fn.argtypes = common + [_I, _I, _I, _P, _P]
                tail = lambda ws: (cplan.blocks, cplan.cluster,  # noqa
                                   cplan.slice, ws, stream)
                ws_n = sc.stream_cluster_workspace(LANES, cplan)
            fn.restype = ctypes.c_int
            runs, us = [], []
            for rep in range(REPS + 1):
                st = (torch.zeros((LANES, N), dtype=torch.float64,
                                  device=dev), -y.repeat(LANES, 1),
                      torch.zeros(LANES, dtype=torch.int64, device=dev),
                      torch.zeros(LANES, dtype=torch.bool, device=dev))
                ws = torch.zeros(ws_n, dtype=torch.uint8, device=dev)
                if clear():
                    raise RuntimeError("stamps: clear failed")
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                err = fn(Xp.data_ptr(), sq.data_ptr(), sn.data_ptr(),
                         y.data_ptr(), masks.data_ptr(), Cs.data_ptr(), 1e-3,
                         caps.data_ptr(), CAP + 1, ds.gamma,
                         *(t.data_ptr() for t in st), N, d, Xp.stride(0),
                         LANES, *tail(ws.data_ptr()))
                end.record()
                end.synchronize()
                if err:
                    raise RuntimeError(f"{route}: CUDA error {err}")
                buf = (ctypes.c_longlong * (3 * ITERS * SLOTS))()
                if stamps(buf):
                    raise RuntimeError(f"{route}: stamps not read")
                if rep:
                    flat = list(buf)
                    runs.append([[flat[(b * ITERS + i) * SLOTS:
                                       (b * ITERS + i + 1) * SLOTS]
                                  for i in range(ITERS)] for b in range(3)])
                    us.append(1e3 * start.elapsed_time(end)
                              / max(int(st[2].max()), 1))
            out[route] = {"cycles": phases(route, runs),
                          "stamped_us_per_iter": us}
    mhz = c.sm_clock_mhz()
    for route in PHASES:
        out[route]["us"] = {p: (v / mhz if v is not None else None)
                            for p, v in out[route]["cycles"].items()}
    out["sm_clock_mhz"] = mhz
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
