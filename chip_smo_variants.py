"""Ablations of the matrix-free SMO step kernels, timed on one NVIDIA GPU.

    python3 chip_smo_variants.py

No profiler runs on the card's machine, so this script times
``csrc/smo_step.cu`` as it is beside copies with one part taken out (made
in a temporary directory, never in the repository; one ``nvcc`` each, all
started together), at the main path's shape: adult's first 32,560 rows
(d = 123) and ten lanes.

* ``as_is``: the source unchanged;
* ``no_exp``: the kernel rows' exps left out (the dot products feed the
  update as they are), in both kernels;
* ``no_pair_staging``: the fused kernel stages no pair rows (its products
  read whatever shared memory holds);
* ``no_x_loads``: no slab of X is copied into the ring, in both kernels.

For each it prints one JSON line: ptxas's registers and spills,
``fused_smo_step`` alone (its C entry over one f, in place) per launch over
a CUDA graph of 50 launches, there and at the pair route's main-path shape
(adult's first 1,000 rows, 20 lanes), and the persistent streaming chunk per
iteration (ten cold lanes capped at 300 iterations, one launch; time over
the iterations it ran). Only ``as_is`` computes the step: it must be
within 1e-12 of the plain version, or the script exits non-zero. The
copies find their edits by the text of the source, so an edit to those
lines of ``smo_step.cu`` must be made here too (a build that cannot find
its text raises).
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
#: variant -> ((text of smo_step.cu, its replacement), ...)
VARIANTS = {
    "as_is": (),
    "no_exp": (
        ("            kiv[vb] = rbf_from_dot(xr2, sn2[2 * s], acc[rb][vb][0], "
         "neg_gamma);\n            kjv[vb] =\n                rbf_from_dot("
         "xr2, sn2[2 * s + 1], acc[rb][vb][1], neg_gamma);",
         "            kiv[vb] = acc[rb][vb][0];\n"
         "            kjv[vb] = acc[rb][vb][1];"),
        ("              acc[rb][vb][0] =\n                  rbf_from_dot("
         "xr2, s_sni[s], acc[rb][vb][0], neg_gamma);\n"
         "              acc[rb][vb][1] =\n                  rbf_from_dot("
         "xr2, s_snj[s], acc[rb][vb][1], neg_gamma);",
         "              (void)xr2;"),
    ),
    "no_pair_staging": (
        ("    stage_pairs(ps, d, G, [&](int w) {\n      return xij + "
         "((size_t)2 * live[w >> 1] + (w & 1)) * d;\n    });",
         "    cp_async_commit();"),
    ),
    "no_x_loads": (
        ("          cp_async<sizeof(T) * VEC>(dst + i * kStep * XS,\n"
         "                                    src + (size_t)i * kStep * "
         "ldx);", "          (void)src;"),
    ),
}
N, LANES, CAP, REPS = 32560, 10, 300, 50
_P, _I, _D, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                   ctypes.c_longlong)


def build_all(tmp: str) -> dict:
    """One nvcc per variant, all started together; {name: (lib, ptxas)}."""
    from repro_torch.kernels import _build
    with open(os.path.join(CSRC, "smo_step.cu")) as fh:
        source = fh.read()
    procs = {}
    for name, edits in VARIANTS.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        shutil.copy(os.path.join(CSRC, "smo_common.cuh"), d)
        src = source
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: text not found: {old!r}")
            src = src.replace(old, new)
        cu = os.path.join(d, "smo_step.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        lib = os.path.join(d, "libsmo_step.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.flags("smo_step"), "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        out[name] = (lib, [ln.split(":", 1)[-1].strip()
                           for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln])
    return out


def entries(lib: str):
    so = ctypes.CDLL(lib)
    fused = so.fused_smo_step_f64
    fused.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _P]
    plan = so.smo_stream_plan
    plan.argtypes = [_I, _I, _I, _I, _P, _P, _P]
    pers = so.smo_stream_persistent_f64
    pers.argtypes = [_P, _P, _P, _P, _P, _P, _D, _P, _LL, _D, _P, _P, _P,
                     _P, _I, _I, _I, _I, _I, _I, _P, _LL, _LL, _I, _P]
    for fn in (fused, plan, pers):
        fn.restype = ctypes.c_int
    return fused, plan, pers


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def graph_ms(fn, reps: int) -> float:
    """Device time per call over a CUDA graph of ``reps`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smo_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.cv import _fold_masks
    from repro_torch.data.svm_suite import kfold_chunks, make_dataset
    from repro_torch.kernels import ref
    from repro_torch.kernels.smo_chunk import pad_rows, seq_norms
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    ds = make_dataset("adult", n_override=N + 1)
    chunks = kfold_chunks(ds.n, LANES)
    X = torch.as_tensor(ds.X[:N], device=dev)
    Xp = pad_rows(X)
    y = torch.as_tensor(ds.y[:N], dtype=torch.float64, device=dev)
    sq = torch.sum(X * X, -1)
    sn = seq_norms(X)
    d = X.shape[1]
    masks = torch.as_tensor(_fold_masks(chunks), device=dev)
    Cs = torch.full((LANES,), ds.C, dtype=torch.float64, device=dev)
    caps = torch.full((LANES,), CAP, dtype=torch.int64, device=dev)
    rng = np.random.default_rng(0)
    # (rows, lanes) -> f, pair rows, delta of the fused kernel's problem
    fused_cases = {}
    for rows, lanes in ((N, LANES), (1000, 20)):
        fused_cases[rows, lanes] = (
            torch.as_tensor(rng.normal(size=(lanes, rows)), device=dev),
            X[torch.as_tensor(rng.integers(0, rows, size=(lanes, 2)),
                              device=dev)],
            torch.full((lanes,), 0.37, dtype=torch.float64, device=dev))

    def stream():   # the current stream at the call (a graph's capture)
        return torch.cuda.current_stream().cuda_stream
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name, (lib, ptxas) in build_all(tmp).items():
            fused, plan, pers = entries(lib)
            rec = {"variant": name, "ptxas": ptxas, "card": card}
            for (rows, lanes), (f0, xij, delta) in fused_cases.items():
                f = f0.clone()

                def step():
                    check(fused(f.data_ptr(), X.data_ptr(), sq.data_ptr(),
                                xij.data_ptr(), delta.data_ptr(), None, rows,
                                d, lanes, ds.gamma, stream()), "fused")
                if name == "as_is":
                    step()
                    want = ref.fused_smo_step_ref(f0, X[:rows], xij,
                                                  sq[:rows], delta, ds.gamma)
                    err = float((f - want).abs().max())
                    rec[f"fused_max_abs_err_{rows}x{lanes}"] = err
                    ok &= err <= 1e-12
                rec[f"fused_ms_graph_{rows}x{lanes}"] = graph_ms(step, REPS)
            m, sl, ws = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_longlong(0)
            check(plan(N, d, LANES, 1, ctypes.addressof(m),
                       ctypes.addressof(sl), ctypes.addressof(ws)), "plan")
            rec["blocks"], rec["slice"] = m.value, sl.value
            times = []
            for _ in range(2):   # the first launch warms up
                st = (torch.zeros((LANES, N), dtype=torch.float64,
                                  device=dev), -y.repeat(LANES, 1),
                      torch.zeros(LANES, dtype=torch.int64, device=dev),
                      torch.zeros(LANES, dtype=torch.bool, device=dev))
                w = torch.zeros(ws.value, dtype=torch.uint8, device=dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                check(pers(Xp.data_ptr(), sq.data_ptr(), sn.data_ptr(),
                           y.data_ptr(), masks.data_ptr(), Cs.data_ptr(), 1e-3,
                           caps.data_ptr(), CAP + 1, ds.gamma,
                           *(t.data_ptr() for t in st), N, d, Xp.stride(0),
                           LANES, m.value, sl.value, w.data_ptr(), 0, 0, 1,
                           stream()),
                      "persistent")
                end.record()
                end.synchronize()
                its = max(int(st[2].max()), 1)
                times.append(1e3 * start.elapsed_time(end) / its)
            rec["persistent_us_per_iter"] = times[-1]
            rec["persistent_iterations"] = its
            print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
