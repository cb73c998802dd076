"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's three hand-written kernels from ``src/repro_torch``,
holds each against its plain PyTorch version on the card, runs the paper's
Table-1 experiment (alpha-seeded 10-fold CV, cold / ato / mir / sir, float64)
on heart (n=270) and adult (n=1000), then adult at the paper's cardinality
(n=32,560). Phases print one JSON line each, with their own seconds; a
failing phase raises and the script exits non-zero. The last lines are the
``{"kernels": [...]}`` summary and ``{"ok": true, "device": ...}``. Without
a CUDA device, or without the repository beside it, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: the JAX reference's quick Table-1 run (BENCH_table1.json, k=10, CPU):
#: iteration counts and accuracy do not depend on the hardware's speed
REFERENCE = {
    "heart": {"n": 270, "accuracy": 0.5519, "iterations": {
        "cold": 101046, "ato": 98592, "mir": 98458, "sir": 98579}},
    "adult": {"n": 1000, "accuracy": 0.885, "iterations": {
        "cold": 16263, "ato": 18674, "mir": 13055, "sir": 11315}},
}
METHODS = ("cold", "ato", "mir", "sir")
SIZE_N = 32561            # adult at the paper's cardinality (32,560 after k=10)
#: peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, and FP64 FLOP/s
#: through the tensor cores (the most the card can do in float64)
HBM_BPS = 3.35e12
FP64_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events,
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed after a warm-up replay, timed by CUDA events. No host
    work runs between the launches, so a short kernel's time is its own
    (plus the graph's gap between nodes), not the wrapper's host rate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                      # first call outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    per_source = _build.build_all()
    secs = time.perf_counter() - t0
    for name in _build.SOURCES:
        _build.load(name)
    ptxas = {}
    for name in _build.SOURCES:
        lines = [ln.split(":", 1)[-1].strip()
                 for ln in _build.ptxas_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        ptxas[name] = lines
    card = card_line()
    print(card, flush=True)
    emit({"phase": "build", "seconds": secs, "nvcc_seconds": per_source,
          "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "ptxas": ptxas})
    return secs, card


def _datasets():
    from repro_torch.data.svm_suite import kfold_chunks, make_dataset
    out = {}
    for name, n in (("heart", 270), ("adult", 1000), ("adult", SIZE_N)):
        ds = make_dataset(name, n_override=n)
        m = kfold_chunks(ds.n, 10).size
        out[(name, m)] = ds
    return out


def phase_kernels(datasets):
    """Each kernel against its plain version at the main path's shapes,
    then its time, the plain version's time, and its bound."""
    from repro_torch.kernels import ops, ref
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    info = {}

    # ---- rbf_kernel_matrix: f64 and f32, test shapes and main-path shapes
    rbf_checks = []
    shapes = [(64, 64, 16), (100, 130, 70), (257, 63, 9), (32, 512, 128)]
    cases = [(rng.normal(size=(n, d)), rng.normal(size=(m, d)), 0.37)
             for n, m, d in shapes]
    for (name, m), ds in datasets.items():
        X = ds.X[:m]
        cases.append((X, X, ds.gamma))
    for X, Z, gamma in cases:
        for dtype, atol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
            Xt = torch.as_tensor(X, dtype=dtype, device=dev)
            Zt = torch.as_tensor(Z, dtype=dtype, device=dev)
            got = ops.rbf_kernel_matrix(Xt, Zt, gamma)
            want = ref.rbf_kernel_matrix_ref(Xt, Zt, gamma)
            err = float((got - want).abs().max())
            del got, want
            rbf_checks.append({"shape": [X.shape[0], Z.shape[0], X.shape[1]],
                               "dtype": str(dtype), "max_abs_err": err})
            require(math.isfinite(err) and err <= atol,
                    f"rbf {X.shape}x{Z.shape} {dtype}: err {err} > {atol}")
    Xa = torch.as_tensor(datasets[("adult", 1000)].X, device=dev)
    tile_diff = float((ops.rbf_kernel_matrix(Xa, Xa, 0.5, _tile=64)
                       - ops.rbf_kernel_matrix(Xa, Xa, 0.5, _tile=32))
                      .abs().max())
    require(tile_diff <= 1e-12, f"rbf tile 64 vs 32 differ by {tile_diff}")
    torch.cuda.empty_cache()

    rbf_times = []
    for (name, m), ds in datasets.items():
        X = torch.as_tensor(ds.X[:m], device=dev)
        n, d = X.shape
        g = ds.gamma
        reps = 3 if n > 10_000 else 20
        ms = cuda_ms(lambda: ops.rbf_kernel_matrix(X, X, g), reps)
        plain_ms = cuda_ms(lambda: ref.rbf_kernel_matrix_ref(X, X, g), reps)

        def library():
            xn = torch.sum(X * X, -1)
            d2 = torch.addmm(xn[:, None] + xn[None, :], X, X.T, alpha=-2.0)
            return torch.exp_(d2.clamp_(min=0.0).mul_(-g))
        library_ms = cuda_ms(library, reps)
        flops, nbytes = 2.0 * n * n * d, 8.0 * (n * n + 2 * n * d + 2 * n)
        t_ops, t_bytes = flops / FP64_FLOPS, nbytes / HBM_BPS
        rbf_times.append({
            "shape": [n, n, d], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "tflops": flops / ms / 1e9})
        del X
        torch.cuda.empty_cache()
    big = rbf_times[-1]
    info["rbf_kernel_matrix"] = dict(
        big, max_abs_err=max(c["max_abs_err"] for c in rbf_checks
                             if c["dtype"] == "torch.float64"))

    # ---- smo_f_update: bitwise vs the CPU addcmul, rtol 1e-12 vs the card's
    fu = []
    for n in (243, 270, 1000, 32560):
        f, Ki, Kj = (torch.as_tensor(rng.normal(size=n), device=dev)
                     for _ in range(3))
        delta = torch.tensor(0.37123, dtype=torch.float64, device=dev)
        got = ops.smo_f_update(f, Ki, Kj, delta)
        cpu = ref.smo_f_update_ref(f.cpu(), Ki.cpu(), Kj.cpu(), delta.cpu())
        require(torch.equal(got.cpu(), cpu),
                f"smo_f_update n={n}: not bitwise equal to the CPU addcmul")
        card = ref.smo_f_update_ref(f, Ki, Kj, delta)
        torch.testing.assert_close(got, card, rtol=1e-12, atol=0)
        ms = graph_ms(lambda: ops.smo_f_update(f, Ki, Kj, delta), 200)
        plain_ms = graph_ms(lambda: ref.smo_f_update_ref(f, Ki, Kj, delta),
                            200)
        host_ms = cuda_ms(lambda: ops.smo_f_update(f, Ki, Kj, delta), 200,
                          10)
        nbytes = 8.0 * (4 * n + 1)
        fu.append({"n": n, "ms": ms, "plain_ms": plain_ms,
                   "host_ms": host_ms,
                   "bound_ms": 1e3 * nbytes / HBM_BPS, "bound_by": "bytes",
                   "elements_differing_from_card_addcmul":
                       int((got != card).sum()),
                   "max_abs_err": float((got - cpu.to(dev)).abs().max())})
    main = next(r for r in fu if r["n"] == 1000)   # adult's ATO ramp
    info["smo_f_update"] = dict(main, max_abs_err=max(r["max_abs_err"]
                                                      for r in fu))

    # ---- smo_chunk: bitwise vs the plain step engine (f-update = kernel 2),
    # cold fold 0 and SIR fold 1 of each main-path size. heart and adult
    # n=1000 run to convergence; at n=32,560 (about 32 rows per thread) both
    # stop at it_cap=300, so the plain loop stays short and the cap's freeze
    # is checked too
    chunk_checks = []
    for (name, n), ds in datasets.items():
        chunk_checks += _chunk_checks(ds, 300 if n > 10_000 else 5_000_000)
        torch.cuda.empty_cache()
    cold = chunk_checks[0]      # heart cold fold 0
    it, ops_per_elem, n = cold["n_iter"], 10.0, cold["n"]
    rows = min(2 * it, n)      # rows of K the run reads, each counted once
    nbytes = 8.0 * (rows * n + 7 * n)
    t_ops = ops_per_elem * n * it / FP64_FLOPS
    t_bytes = nbytes / HBM_BPS
    info["smo_chunk"] = dict(
        cold, max_abs_err=max(c["max_abs_err"] for c in chunk_checks),
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "rbf_checks": rbf_checks, "rbf_tile_64_vs_32_max_diff": tile_diff,
          "rbf_times": rbf_times, "smo_f_update": fu,
          "smo_chunk": chunk_checks})
    return info


def _chunk_checks(ds, it_cap: int):
    """smo_chunk against the plain step engine (its f-update through the
    smo_f_update kernel) on ``ds``'s cold fold 0 and SIR-seeded fold 1:
    alpha, f, n_iter and done must be bitwise equal. At heart's size also
    checks that ``chunk_iters=512`` equals one chunk."""
    from repro_torch.core.cv import _fold_masks, _transition_idx
    from repro_torch.core.seeding import sir_seed
    from repro_torch.data.svm_suite import kfold_chunks
    from repro_torch.kernels import ops, ref
    from repro_torch.svm import init_f, smo_solve
    dev = torch.device("cuda")
    chunks = kfold_chunks(ds.n, 10)
    n = chunks.size
    X = torch.as_tensor(ds.X[:n], device=dev)
    y = torch.as_tensor(ds.y[:n], dtype=torch.float64, device=dev)
    K = ops.rbf_kernel_matrix(X, X, ds.gamma)
    diag = torch.diagonal(K).contiguous()
    masks = torch.as_tensor(_fold_masks(chunks), device=dev)
    zero_it = torch.tensor(0, device=dev)
    no = torch.tensor(False, device=dev)
    checks = []

    def compare(label, mask, alpha0, f0):
        # n_iters = it_cap + 1: a run that reaches the cap also freezes on it
        args = (K, diag, y, mask, ds.C, 1e-3, it_cap, it_cap + 1, "2")
        t = time.perf_counter()
        plain = ref.smo_chunk_ref(*args, alpha0, f0, zero_it, no,
                                  update_f=ops.smo_f_update)
        sync()
        plain_s = time.perf_counter() - t
        got = ops.smo_chunk(*args, alpha0, f0, zero_it, no)
        err = max(float((got[k] - plain[k]).abs().max()) for k in (0, 1))
        for a, b, what in zip(got, plain, ("alpha", "f", "n_iter", "done")):
            require(torch.equal(a, b), f"smo_chunk n={n} {label}: {what} "
                                       "differs from the plain step engine")
        require(bool(got[3]), f"smo_chunk n={n} {label}: not done")
        ms = cuda_ms(lambda: ops.smo_chunk(*args, alpha0, f0, zero_it, no),
                     3)
        it = int(got[2])
        checks.append({"fold": label, "n": n, "it_cap": it_cap,
                       "n_iter": it, "ms": ms, "plain_ms": 1e3 * plain_s,
                       "us_per_iter": 1e3 * ms / it, "max_abs_err": err})

    zeros = torch.zeros(n, dtype=torch.float64, device=dev)
    compare("cold fold 0", masks[0], zeros, -y)
    prev = smo_solve(K, y, masks[0], ds.C, zeros, -y, max_iter=5_000_000)
    require(bool(prev.converged), f"smo_chunk n={n}: fold 0 not converged")
    if n < 1000:
        chun = smo_solve(K, y, masks[0], ds.C, zeros, -y, chunk_iters=512,
                         max_iter=5_000_000)
        for what in ("alpha", "f", "n_iter", "converged"):
            require(torch.equal(getattr(prev, what), getattr(chun, what)),
                    f"smo_chunk: chunk_iters=512 differs from one chunk "
                    f"({what})")
    S, R, T = _transition_idx(chunks, 0, 1, dev)
    alpha1 = sir_seed(K, y, ds.C, prev, S, R, T)
    compare("sir fold 1", masks[1], alpha1, init_f(K, y, alpha1))
    return checks


def phase_table1(build_s: float):
    """The paper's Table 1 (k=10, four methods) through ``run_cv``."""
    from repro_torch.core.cv import run_cv
    from repro_torch.data.svm_suite import make_dataset
    t0 = time.perf_counter()
    rows = []
    for name, refd in REFERENCE.items():
        ds = make_dataset(name, n_override=refd["n"])
        per_fold = {}
        for method in METHODS:
            rep = run_cv(ds, k=10, method=method)
            it = rep.total_iterations
            require(all(f.converged for f in rep.folds),
                    f"{name} {method}: a fold did not converge")
            require(all(math.isfinite(f.objective) for f in rep.folds),
                    f"{name} {method}: non-finite objective")
            per_fold[method] = [(f.acc_correct, f.acc_total)
                                for f in rep.folds]
            rows.append({
                "dataset": name, "n": rep.n, "method": method,
                "iterations": it,
                "reference_iterations": refd["iterations"][method],
                "per_fold_iterations": [f.n_iter for f in rep.folds],
                "kernel_s": rep.kernel_time, "init_s": rep.total_init_time,
                "solve_s": rep.total_solve_time,
                "us_per_iteration": 1e6 * rep.total_solve_time / max(it, 1),
                "accuracy": rep.accuracy,
                "reference_accuracy": refd["accuracy"]})
            require(round(rep.accuracy, 4) == refd["accuracy"],
                    f"{name} {method}: accuracy {rep.accuracy} != "
                    f"{refd['accuracy']}")
        require(all(per_fold[m] == per_fold["cold"] for m in METHODS),
                f"{name}: per-fold accuracies differ across methods")
    emit({"phase": "table1", "seconds": time.perf_counter() - t0,
          "kernel_build_s": build_s, "rows": rows})


def phase_size(ds, n_sir_folds: int = 2):
    """Adult at the paper's cardinality: K by the RBF kernel (checked on a
    slab of rows), cold fold 0, then SIR-seeded folds."""
    from repro_torch.core.cv import _eval_fold, _fold_masks, _transition_idx
    from repro_torch.core.seeding import sir_seed
    from repro_torch.data.svm_suite import kfold_chunks
    from repro_torch.kernels import ref
    from repro_torch.svm import init_f, kernel_matrix, smo_solve
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    chunks = kfold_chunks(ds.n, 10)
    n = chunks.size
    X = torch.as_tensor(ds.X[:n], device=dev)
    y = torch.as_tensor(ds.y[:n], dtype=torch.float64, device=dev)
    torch.cuda.reset_peak_memory_stats()
    sync()
    tk = time.perf_counter()
    K = kernel_matrix(X, X, gamma=ds.gamma)
    sync()
    kernel_s = time.perf_counter() - tk
    slab = ref.rbf_kernel_matrix_ref(X[:512], X, ds.gamma)
    slab_err = float((K[:512] - slab).abs().max())
    require(slab_err <= 1e-10, f"size: K slab err {slab_err} > 1e-10")
    del slab
    masks = torch.as_tensor(_fold_masks(chunks), device=dev)
    folds, prev = [], None
    for h in range(1 + n_sir_folds):
        ts = time.perf_counter()
        if prev is None:
            alpha0, f0 = torch.zeros(n, dtype=torch.float64, device=dev), -y
        else:
            S, R, T = _transition_idx(chunks, h - 1, h, dev)
            alpha0 = sir_seed(K, y, ds.C, prev, S, R, T)
            f0 = init_f(K, y, alpha0)
        sync()
        t1 = time.perf_counter()
        res = smo_solve(K, y, masks[h], ds.C, alpha0, f0, max_iter=5_000_000)
        it = int(res.n_iter)
        t2 = time.perf_counter()
        correct, total, obj = _eval_fold(K, y, chunks, h, res, ds.C)
        require(bool(res.converged) and math.isfinite(obj),
                f"size fold {h}: converged={bool(res.converged)} obj={obj}")
        folds.append({"fold": h, "seed": "cold" if prev is None else "sir",
                      "n_iter": it, "init_s": t1 - ts, "solve_s": t2 - t1,
                      "us_per_iter": 1e6 * (t2 - t1) / max(it, 1),
                      "accuracy": correct / total, "objective": obj})
        prev = res
    emit({"phase": "size", "seconds": time.perf_counter() - t0, "n": n,
          "d": int(X.shape[1]), "K_gb": K.numel() * 8 / 1e9,
          "kernel_s": kernel_s, "slab_max_abs_err": slab_err,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "folds": folds})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops
    # float32 products in full float32 (no TF32) in the plain versions too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    build_s, card = phase_build()
    datasets = _datasets()
    info = phase_kernels(datasets)

    # the main path: counts from 0 just before it, read just after
    ops.reset_launch_counts()
    phase_table1(build_s)
    main_counts = ops.launch_counts()
    ops.reset_launch_counts()
    phase_size(datasets[("adult", SIZE_N - 1)])
    size_counts = ops.launch_counts()
    emit({"phase": "kernel_counts", "main_path": main_counts,
          "size": size_counts})
    for name, c in main_counts.items():
        require(c > 0, f"{name} was not launched on the main path")

    sources = {"rbf_kernel_matrix": ("src/repro_torch/kernels/csrc/rbf.cu",
                                     "src/repro/kernels/rbf.py:54"),
               "smo_f_update": ("src/repro_torch/kernels/csrc/smo_update.cu",
                                "src/repro/kernels/smo_update.py:24"),
               "smo_chunk": ("src/repro_torch/kernels/csrc/smo_chunk.cu",
                             "src/repro/svm/engine.py:566")}
    kernels = []
    for name, (src, replaces) in sources.items():
        k = info[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": main_counts[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k.get("library_ms")})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "build_s": build_s, "card": card})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
