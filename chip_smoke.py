"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``src/repro_torch`` (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version on the card, and drives these paths, each with the launch counts set
to 0 just before it and read just after:

* Table 1 (alpha-seeded 10-fold CV, cold / ato / mir / sir, float64) on
  heart (n=270) and adult (n=1000) through ``run_cv`` (adult's iterations
  gated on the installed JAX reference's; the seeders' loops on the
  seeding kernels, each seed's parts timed on fold 0 -> 1 just before
  and printed beside each method's init), then adult at the paper's
  cardinality (n=32,560) over a dense K, one fold at a time and 24 folds
  at once;
* the batched cold CV through the lane pool (``run_cv_batched``: the
  matrix-free ``cold_pallas`` and the two dense schedules) on the same two
  datasets, then matrix-free at n=32,560, where no (n, n) tensor may exist;
* the Study layer: ``study_seeds`` at Table 1's sizes (each seed transform
  against its plain version and with no host sync but the counted reads;
  the ATO C row of ``benchmarks/table1_kfold.py`` through every fold
  transition, each lane of the batched ramp held to the solo ``ato_seed``;
  ``run_cv`` with a lost fold under ``best_available``; ``run_grid`` over
  a 3 x 3 (C, gamma) grid, k=5, "sir" and "ato"), ``grid_size`` (the
  grid at adult n=32,560, d=123, 45 lanes, two 8.48 GB kernels resident
  at a time; its cell at the paper's (C, gamma) equal to ``run_cv``
  there) and ``loo`` (``run_loo``: the suppl. Fig. 2 cases, heart n=270
  for 270 rounds and madelon n=600 for 120, and adult n=1000 for 20);
* active-set shrinking (``shrink``, ``shrink_size``, ``svc``): ``run_cv``
  and ``run_cv_batched`` (dense and matrix-free) at Table 1's sizes and
  at adult n=32,560, each beside the same call without shrinking (equal
  per-fold correct counts, objectives within 1e-6), compact groups of
  lanes on the per-lane chunk kernels (``smo_chunk_sources``,
  ``smo_stream_chunk_sources``: each replayed call bitwise its lanes'
  solo launches), and the ``SVC`` estimator at adult n=32,560;
* the study service (``service``) at adult n=32,560: two tenants' plans
  over one declared kernel served by a ``StudyServer`` daemon on an
  AF_UNIX socket (one K for both, each lane bitwise the in-process
  ``run_plan``), two plans refused before anything is put on the card, a
  daemon killed mid-study and restarted under another width (bitwise),
  and the cost model's ``cuda`` verdicts taken from
  ``results/cost_model_torch.json``;
* LM serving of granite-8b at full width and depth in bf16 (random weights
  from a seed): prefill of 2 x 4,096 tokens, every attention layer through
  the flash-attention kernel's wgmma route, then 4 requests served through
  the KV cache (a 16-token prompt teacher-forced, 32 greedy tokens);
  gemma3-4b likewise (prefill of 1 x 32,768 tokens, its 29 sliding-window
  layers through the kernel's window, its 5 global ones causal, all at
  head dim 256, a windowed launch under a quarter of a global one's time)
  then yi-34b (68.78 GB of weights on the card, prefill of 1 x
  2,048 tokens, 4 requests of 16 + 16 tokens, decode beside its
  weight-read bound), deepseek-v2-236b at full width cut to 8 layers
  (58.38 GB: MLA's prefill on the kernel at q/k head dim 192 and v head
  dim 128, 1 x 4,096 tokens; its absorbed decode over the latent cache;
  the sort-based MoE of 160 experts; 4 requests of 16 + 16 tokens),
  jamba-v0.1-52b at full width cut to 16 layers (52.1 GB: 14 mamba
  layers, each one launch of the selective scan kernel in a prefill of 1
  x 32,768 tokens and in each decode step through the float32 state; 2
  NoPE attention layers on the flash kernel; the MoE on every second
  layer; 4 requests of 16 + 16 tokens) and, last, xlstm-125m at full width
  and depth (12 layers: 6 mLSTM, each one launch of the mLSTM kernel in a
  prefill of 1 x 32,768 tokens and its recurrent update in decode; 6
  sLSTM, each one launch of the sLSTM recurrence kernel in the prefill
  and in each decode step through the cache; 4 requests of 16 + 16
  tokens).

Four kernels have routes, and every check and path records the one it
took (``ops.route_counts``): every float64 ``rbf_kernel_matrix`` runs on
the FP64 tensor cores (for K(X, X), the SVM paths' build, only the tiles
on and above the diagonal), checked bit for bit against the FMA kernel,
float32's route, at both its tiles; the dense ``smo_chunk`` takes, of
the routes that place a launch, the fastest by a time model fitted on the
card: one
block a lane holding the lane's state on chip (every Table-1 lane), many
blocks a lane of a cooperative launch (the size phase), a thread-block
cluster a lane holding its state in the cluster's shared memory (the wide
dense batch at n=32,544, 24 folds at once), or, for batches that fit
nowhere on chip, one block a lane with the state in global memory; the
matrix-free ``smo_stream_chunk`` runs as one launch wherever a plan places
the lanes (up to 16: in thread-block clusters, or the persistent
cooperative launch, the fastest by a time model fitted on the card), else
as a launch pair per iteration (the fused step and the selection; the
batched path's 20-fold row); bf16 ``flash_attention`` runs on wgmma + TMA at head dims 64-256 and
MLA's (192, 128), and on ``mma.sync`` below.

``smo_step.cu`` is also built with its float64 dot products on the FMA
pipes (``_build.VARIANTS``); the fused kernel of that build must give the
tensor-core build's outputs bit for bit.

``python3 chip_smoke.py --seed-split [--src DIR]`` runs only the seeding
split and Table 1's times, of the package under DIR (another checkout's
``src``), so that two trees are timed in one call; ``--compare [--src
DIR] [--flash]`` likewise the bf16 attention routes' times (with
``--flash``, those alone): the mma.sync route at head dims 32 and 16, the
wgmma route at granite's and gemma3's prefill shapes; then the 20-fold
matrix-free row's (the selection kernel's path), the seeding kernels'
times, one SIR seed of the grid at size split into its parts, Table 1's
summed init and solve times, and the grid at size and LOO phases.

``water_fill`` is also built with one bisection level a round
(``water_fill_seq``, ``_build.VARIANTS``): every call the script checks
must give that build's outputs bit for bit. ``sir_greedy`` is checked
bitwise at adult n=32,560's fold sizes (|T| = 3,256, 6,512 and 10,853),
reading K through the index sets, and prints the rows it rescanned and
the rows that took the fallback.

Phases print one JSON line each, with their own seconds; a failing phase
raises and the script exits non-zero. The last lines are the
``{"kernels": [...]}`` summary and ``{"ok": true, "device": ...}``. Without
a CUDA device, or without the repository beside it, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: the JAX reference's Table-1 run (``repro.core.cv.run_cv``, k=10, on the
#: CPU under jax 0.9.0, the installed reference; BENCH_table1.json came from
#: jax 0.4.37, whose threefry draw differed): iteration counts and accuracy
#: do not depend on the hardware's speed. Adult's counts gate the port's
#: (``tests/test_torch_chip_reference.py`` holds these to the reference);
#: heart's are printed beside the port's: the port builds its own K, whose
#: last bits heart's ill-conditioned solves (C = 2182) amplify
REFERENCE = {
    "heart": {"n": 270, "accuracy": 0.5519, "gated": False, "iterations": {
        "cold": 101197, "ato": 98039, "mir": 98297, "sir": 97639}},
    "adult": {"n": 1000, "accuracy": 0.885, "gated": True, "iterations": {
        "cold": 16263, "ato": 18674, "mir": 13055, "sir": 11357}},
}
METHODS = ("cold", "ato", "mir", "sir")
#: the reference's batched rows of the same run (``run_cv_batched``):
#: iterations; the matrix-free rows gate both datasets, the dense rows
#: adult's
REFERENCE_BATCHED = {
    "heart": {"cold_pallas": 182058, "cold_batched": 101197,
              "cold_batched_repacked": 101197},
    "adult": {"cold_pallas": 16260, "cold_batched": 16263,
              "cold_batched_repacked": 16263},
}
#: folds of the matrix-free run past the persistent route's 16 lanes
WIDE_K = 20
BATCHED = {"cold_pallas": {"source_backend": "pallas_rbf"},
           "cold_batched": {"schedule": "batched"},
           "cold_batched_repacked": {}}
#: the matrix-free size phase's bar: X, lane states and the streaming slabs
PEAK_LIMIT = 3 * 2 ** 30
SIZE_N = 32561            # adult at the paper's cardinality (32,560 after k=10)
#: its matrix-free cold CV's iterations on the card since they were first
#: run (the streaming engine is bitwise across its routes and packings)
SIZE_MATRIX_FREE_ITERATIONS = 443_772
#: peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, and FP64 FLOP/s
#: through the tensor cores (the most the card can do in float64)
HBM_BPS = 3.35e12
FP64_FLOPS = 67e12
#: the H100's L2: operands larger than this are read from HBM every pass
L2_BYTES = 50e6
#: dense bf16 FLOP/s of the tensor cores (the attention kernel's bound)
BF16_FLOPS = 989e12
#: the reference's flash-attention sweep (tests/test_kernels.py:37-40):
#: (S, D, causal, window), f32 at atol 2e-5; and its bf16 case at 0.06
FLASH_CASES = ((64, 32, True, None), (100, 32, False, None),
               (128, 64, True, 24), (96, 16, False, 40), (33, 32, True, None))
#: granite-8b's prefill attention: (B, H, KV, S, D), causal, bf16
FLASH_GRANITE = (2, 32, 8, 4096, 128)
#: gemma-7b's prefill attention at its context (B, H, KV, S, D), causal
FLASH_GEMMA = (1, 16, 16, 8192, 256)
#: granite's prefill shape at head dims 32 and 16: the bf16 mma.sync
#: route's timing
FLASH_D32 = (2, 32, 8, 4096, 32)
FLASH_D16 = (2, 32, 8, 4096, 16)
#: exp2 results a clock an SM on Hopper's SFU (MUFU.EX2; CUDA programming
#: guide, compute capability 9.0): the floor of attention at small D
SFU_EX2_PER_CLOCK = 16
#: bf16 cases beyond the reference's one: the sweep's shapes (several kv
#: tiles, ragged S, windows; D=16 and 32 on the mma.sync route, D=64 on
#: wgmma), then grouped kv heads read in place from (B, S, H, D)
#: activations with ragged S and windows at D=128 and D=256 (wgmma) and
#: at D=32 (mma.sync):
#: (B, H, KV, S, D, causal, window)
FLASH_BF16_CASES = tuple((2, 3, 3, S, D, causal, window)
                         for S, D, causal, window in FLASH_CASES) + (
    (2, 8, 2, 300, 128, True, None), (1, 4, 1, 200, 128, False, 70),
    (2, 8, 2, 1000, 128, True, 256), (1, 4, 1, 200, 256, False, 70),
    (2, 8, 2, 1000, 256, True, 256), (2, 4, 2, 256, 32, True, 48))
#: rows of the RBF kernel's tile sweep (adult's first n rows, K(X, X) and
#: K(X, copy of X) at every tensor-route tile)
RBF_SWEEP_N = (270, 1000, 2000, 4096, 4099, 8192, 16384, 32560)
#: the dense chunk's crossover sweep: rows, iterations timed on each route
CHUNK_SWEEP_N = (100, 270, 500, 1000, 2000, 4096, 6144, 8192, 16384)
CHUNK_SWEEP_ITERS = 500
#: rows of its sweep over lanes (where the plan's blocks a lane shrink)
CHUNK_LANE_SWEEP_N = (4608, 8192, 32560)
#: how much slower than the fastest route (a share of its time) the one
#: ``chunk_route`` picks at a sweep point may be: a route's time at one
#: point spreads by up to ~6% from call to call on the card (PERF.md §6)
CHUNK_ROUTE_MARGIN = 0.05
#: rounds in which a sweep point's routes are timed: each round times every
#: route once, in turn, and a route keeps its fastest round, so a slow
#: stretch of the card (a clock step, a late warm-up) falls on all routes
#: alike and not on the one that happened to be timed in it
ROUTE_ROUNDS = 5
#: and its wide points, past the multi-block plan's widest batch: rows ->
#: lanes (size_wide's 24 folds and wider at n = 32,544; 88 at 8,192)
CHUNK_WIDE_SWEEP = {32544: (24, 32, 48), 8192: (88,)}
#: rows of the resident one-block kernel's sweep over its builds (rows a
#: thread, and so the block's width): heart's n=270 and adult's n=1000
#: (Table 1's lanes, cold fold 0 to convergence), and adult's first n rows
#: (CHUNK_SWEEP_ITERS capped iterations) around them
CHUNK_WIDTH_SWEEP_N = (100, 500, 2000, 4096)
#: folds of the wide dense batch at the paper's cardinality: more lanes
#: than the multi-block plan places (22 at n = 32,560), so every chunk
#: takes the cluster route
WIDE_DENSE_K = 24
#: the streaming chunk's route sweep: adult's first n rows (d = 123) and
#: heart's 270 (d = 13), and iterations timed on each route
STREAM_SWEEP_N = (270, 1000, 4096, 32560)
STREAM_SWEEP_ITERS = 200
#: a bf16 output against the plain version in float32 on the same bf16
#: inputs, row by row: max over rows of max |o - o_f32| / max |o_f32| (a
#: row being one query's D outputs), so the bar keeps its meaning however
#: small the outputs are. The kernel rounds each output to bf16 (2**-9 of
#: the row's largest at most) and each probability before the product with
#: v (about as much again): 0.02 is five bf16 ulps of the row's largest.
#: The kernel must also come within twice the plain version's own error in
#: bf16 on the same inputs (the rule the fused SMO step is held to)
FLASH_ROW_REL = 0.02
#: granite-8b's parameters (model_params_def at full width)
GRANITE_PARAMS = 8_254_689_280
#: LM serving: prefill batch and length; served requests, prompt, new tokens
PREFILL_B, PREFILL_S = 2, 4096
SERVE_B, PROMPT, NEW_TOKENS = 4, 16, 32
#: one block's attention (its mixer) fed the same float32 input by the
#: prefill route (kernel) and the decode route (plain, through the cache),
#: row by row (``_row_rel``, a row being one position's d outputs): 2.4
#: times the largest difference measured over the 36 layers (4.2e-5)
LAYER_REL_F32 = 1e-4
#: the whole model, the prompt's forward (kernel) against the teacher-forced
#: decode (plain), at position 0, where attention has one key and so no
#: choice to amplify a rounding difference: max |diff| of the logits (up
#: to 6.6). bf16: three times the bf16-vs-f32 spread there (0.083; the
#: routes differed by 0.089); f32: ten times the difference measured (1e-5)
POS0_ATOL_BF16 = 0.25
POS0_ATOL_F32 = 1e-4

#: the Study layer's cases, as ``benchmarks/table1_kfold.py`` cuts them:
#: the ``ato_bucketed`` row's C row (multiples of the paper's C), and the
#: grid rows' multiples of the paper's C and gamma, k=5
ATO_ROW_C = (0.01, 1.0, 100.0)
GRID_C = (0.25, 1.0, 4.0)
GRID_GAMMA = (0.5, 1.0, 2.0)
GRID_K = 5
#: ``grid_size``: the ``grid_pooled_lru`` row at the paper's cardinality,
#: two of the three gamma kernels resident at once
GRID_LRU_BUDGET = 2
#: the straggler run: fold 3 is lost, the others seed from the nearest
#: completed fold
STRAGGLER_LOST = frozenset({3})
#: LOO: ``benchmarks/fig2_loo.py``'s cases (dataset, n, rounds) and
#: methods, and adult's gated case, with ATO as well
FIG2_CASES = (("heart", 270, 270), ("madelon", 600, 120))
FIG2_METHODS = ("cold", "avg", "top", "mir", "sir")
LOO_ADULT = ("adult", 1000, 20)
#: the installed JAX reference's runs of the same cases (jax 0.9.0 on the
#: CPU; ``tests/test_torch_chip_reference.py`` holds the straggler, grid
#: and adult LOO tables to it). Adult's gate the port's counts and
#: accuracy; heart's are printed beside the port's (its solves amplify the
#: last bits of the port's own K). Straggler: ``run_cv(k=10, "sir",
#: "best_available", unavailable_folds={3})``: seed_from, per-fold
#: iterations, accuracy
REFERENCE_STRAGGLER = {
    "adult": {"n": 1000, "gated": True, "accuracy": 0.885,
              "seed_from": [-1, 0, 1, 2, 2, 4, 5, 6, 7, 8],
              "per_fold": [1528, 825, 767, 1266, 821, 1295, 872, 1473, 737,
                           1254]},
    "heart": {"n": 270, "gated": False, "accuracy": 0.5519,
              "seed_from": [-1, 0, 1, 2, 2, 4, 5, 6, 7, 8],
              "per_fold": [10829, 10434, 9629, 9498, 9006, 9724, 9462, 8867,
                           9579, 10484]},
}
#: ``run_grid(GRID_C x C, GRID_GAMMA x gamma, k=5)``: per cell [C, gamma,
#: iterations, correct] with "sir", and with "ato" on the first gamma row
REFERENCE_GRID = {
    "adult": {"n": 1000, "gated": True, "sir": [
        [25.0, 0.25, 4626, 891], [100.0, 0.25, 4626, 891],
        [400.0, 0.25, 4630, 891], [25.0, 0.5, 5690, 876],
        [100.0, 0.5, 5690, 876], [400.0, 0.5, 5690, 876],
        [25.0, 1.0, 5485, 564], [100.0, 1.0, 5485, 564],
        [400.0, 1.0, 5485, 564]], "ato": [
        [25.0, 0.25, 7475, 891], [100.0, 0.25, 7549, 891],
        [400.0, 0.25, 7765, 891]]},
    "heart": {"n": 270, "gated": False, "sir": [
        [545.5, 0.1, 62960, 151], [2182.0, 0.1, 107625, 144],
        [8728.0, 0.1, 117455, 142], [545.5, 0.2, 36111, 139],
        [2182.0, 0.2, 38979, 138], [8728.0, 0.2, 39195, 138],
        [545.5, 0.4, 14151, 136], [2182.0, 0.4, 14154, 136],
        [8728.0, 0.4, 14144, 136]], "ato": [
        [545.5, 0.1, 64816, 151], [2182.0, 0.1, 107167, 144],
        [8728.0, 0.1, 119960, 142]]},
}
#: ``benchmarks/fig2_loo.py``'s cases on the reference (jax 0.9.0, CPU):
#: [base_iterations, iterations, accuracy] per method, printed beside the
#: port's (heart's K differs in the last bits, ROADMAP Queue 3)
REFERENCE_FIG2 = {
    "heart": {"cold": [12567, 3330487, 0.5148],
              "avg": [12567, 1236997, 0.5148],
              "top": [12567, 1239775, 0.5148],
              "mir": [12567, 1877020, 0.5148],
              "sir": [12567, 1877020, 0.5148]},
    "madelon": {"cold": [300, 82320, 0.0], "avg": [300, 120, 0.0],
                "top": [300, 62652, 0.0], "mir": [300, 37408, 0.0],
                "sir": [300, 37408, 0.0]},
}
#: adult's grid and LOO iterations are held to the reference's within
#: ITER_BAND (relative, each cell and each LOO method), and to the card's
#: own earlier runs exactly (CARD_GRID, CARD_LOO; NVIDIA H100 80GB HBM3):
#: the port's seeds are within their bars of the reference's but not bit
#: for bit, and a chain amplifies their last bits. Two witnesses in the
#: CPU tests show where the gaps come from: with XLA's sums in place of
#: torch's the port's SIR seeds of the grid's gamma = 0.25 row are the
#: reference's bit for bit, and from the reference's seeds the port's
#: solver takes the reference's count in every fold of that row and every
#: round of LOO's ATO chain (tests/test_torch_grid.py,
#: tests/test_torch_study.py). Widest gap seen: LOO's ATO chain, 36,330 on
#: the port's CPU path against the reference's 36,540 (0.6%). A change to
#: seeding or K arithmetic re-records the CARD_ tables from a chip run.
ITER_BAND = 0.01
CARD_GRID = {"sir": [4628, 4623, 4622, 5690, 5690, 5690, 5485, 5485, 5485],
             "ato": [7476, 7553, 7765]}
CARD_LOO = {"cold": 41048, "avg": 639, "top": 19737, "ato": 36479,
            "mir": 11776, "sir": 11776}
#: ``run_loo(adult n=1000, rounds=20)``: [base_iterations, iterations,
#: accuracy] per method
REFERENCE_LOO = {
    "cold": [2088, 41048, 0.9], "avg": [2088, 639, 0.9],
    "top": [2088, 19737, 0.9], "ato": [2088, 36540, 0.9],
    "mir": [2088, 11776, 0.9], "sir": [2088, 11776, 0.9]}


def _in_band(got: int, ref: int) -> bool:
    """Whether an iteration count is within ITER_BAND of the reference's."""
    return abs(got - ref) <= ITER_BAND * ref


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


def routes_ms(run, routes, reps: int = 3,
              rounds: int = ROUTE_ROUNDS) -> dict:
    """Device time of ``run(route)`` for each of ``routes``: ``rounds``
    rounds that each time every route by ``cuda_ms`` (``reps`` calls), one
    after another, and each route's fastest round."""
    best = {r: float("inf") for r in routes}
    for _ in range(rounds):
        for r in routes:
            best[r] = min(best[r], cuda_ms(lambda: run(r), reps))
    return best


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


def sm_clock_mhz() -> float:
    """The card's top SM clock (``nvidia-smi``'s ``clocks.max.sm``), MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


def exp_bound_ms(exps: float) -> float:
    """The least time of ``exps`` exp2s on the card's SFUs at its top
    clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * exps / (SFU_EX2_PER_CLOCK * sms * sm_clock_mhz() * 1e6)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    # every source and the witness builds this script holds kernels to
    # (the cluster streaming route's FMA build, smo_stream_fma, and the
    # refused sLSTM cluster, slstm_cluster32, are the card tests')
    names = _build.SOURCES + tuple(
        v for v in _build.VARIANTS
        if v not in ("smo_stream_fma", "slstm_cluster32"))
    per_source = _build.build_all(names)
    secs = time.perf_counter() - t0
    for name in names:
        _build.load(name)
    ptxas = {}
    for name in names:
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


def _rbf_checks(datasets, rng) -> list:
    """The RBF kernel against its plain version (f64 within 1e-10, f32
    within 1e-5) at the test shapes and the main path's, K(X, X) from one
    tensor as the SVM paths build it; and, in float64, the tensor route
    bitwise equal to the FMA kernel at both its tiles and, for K(X, X), to
    itself with a copy of X as Z (every tile computed)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rbf import FMA_TILES
    dev = torch.device("cuda")
    checks = []
    shapes = [(64, 64, 16), (100, 130, 70), (257, 63, 9), (32, 512, 128)]
    cases = [(rng.normal(size=(n, d)), rng.normal(size=(m, d)), 0.37)
             for n, m, d in shapes]
    for (name, m), ds in datasets.items():
        cases.append((ds.X[:m], None, ds.gamma))     # None: Z is X
    for X, Z, gamma in cases:
        for dtype, atol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
            Xt = torch.as_tensor(X, dtype=dtype, device=dev)
            Zt = Xt if Z is None else torch.as_tensor(Z, dtype=dtype,
                                                      device=dev)
            shape = [Xt.shape[0], Zt.shape[0], Xt.shape[1]]
            got = ops.rbf_kernel_matrix(Xt, Zt, gamma)
            want = ref.rbf_kernel_matrix_ref(Xt, Zt, gamma)
            err = float((got - want).abs().max())
            del want
            require(math.isfinite(err) and err <= atol,
                    f"rbf {shape} {dtype}: err {err} > {atol}")
            rec = {"shape": shape, "dtype": str(dtype),
                   "z_is_x": Z is None, "max_abs_err": err}
            if dtype == torch.float64:
                others = {f"fma_{t}": (Zt, {"_route": "fma", "_tile": t})
                          for t in FMA_TILES}
                if Z is None:
                    others["tensor_z_copy"] = (Xt.clone(), {})
                for label, (Zo, kw) in others.items():
                    other = ops.rbf_kernel_matrix(Xt, Zo, gamma, **kw)
                    require(torch.equal(got, other), f"rbf {shape}: the "
                            f"tensor route and {label} differ")
                    del other
                rec["bitwise_equal_to"] = sorted(others)
            checks.append(rec)
            del got
            torch.cuda.empty_cache()
    return checks


def timed(fn, n: int) -> float:
    """Device ms of one RBF build of n rows: over a CUDA graph of 20 calls
    below 10,000 rows (the kernel's time, not the wrapper's host rate), by
    CUDA events over 3 calls above."""
    return graph_ms(fn, 20) if n < 10_000 else cuda_ms(fn, 3)


def _rbf_bounds(n: int, d: int, sym: bool) -> dict:
    """The least time of an (n, n) K: its operations (for K(X, X) the
    tiles on and above the diagonal) at the FP64 tensor rate against the
    bytes (K written, X, Z and the norms read) at HBM's."""
    flops = (1.0 * n * (n + 1) if sym else 2.0 * n * n) * d
    nbytes = 8.0 * (n * n + (n * d + n) * (1 if sym else 2))
    return _bound(nbytes, flops)


def _rbf_times(datasets) -> list:
    """At each main-path shape (K(X, X) of heart 270, adult 1,000 and adult
    32,560): the tensor route with Z is X (what the paths launch), with a
    copy of X as Z (every tile), the FMA kernel, the plain version and the
    library call, each with its bound."""
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    rows = []
    for (name, m), ds in datasets.items():
        X = torch.as_tensor(ds.X[:m], device=dev)
        Xc = X.clone()
        n, d = X.shape
        g = ds.gamma
        ms = timed(lambda: ops.rbf_kernel_matrix(X, X, g), n)
        ms_distinct = timed(lambda: ops.rbf_kernel_matrix(X, Xc, g), n)
        fma_ms = timed(lambda: ops.rbf_kernel_matrix(X, X, g, _route="fma"),
                       n)
        plain_ms = timed(lambda: ref.rbf_kernel_matrix_ref(X, X, g), n)

        def library():
            xn = torch.sum(X * X, -1)
            d2 = torch.addmm(xn[:, None] + xn[None, :], X, X.T, alpha=-2.0)
            return torch.exp_(d2.clamp_(min=0.0).mul_(-g))
        library_ms = timed(library, n)
        sym, distinct = _rbf_bounds(n, d, True), _rbf_bounds(n, d, False)
        rows.append({
            "dataset": name, "shape": [n, n, d], "ms": ms,
            "ms_distinct": ms_distinct, "fma_ms": fma_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, **sym,
            "bound_ms_distinct": distinct["bound_ms"],
            "bound_by_distinct": distinct["bound_by"],
            "tflops_distinct": 2.0 * n * n * d / ms_distinct / 1e9})
        del X, Xc
        torch.cuda.empty_cache()
    return rows


def _rbf_tile_sweep(ds) -> list:
    """The tensor route at every tile, K(X, X) and K(X, copy of X), over
    adult's first n rows (RBF_SWEEP_N), beside the FMA kernel and
    ``tensor_tile``'s picks: the points its rule is fitted to."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rbf import TENSOR_TILES, tensor_tile
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    X_all = torch.as_tensor(ds.X, device=dev)
    g = ds.gamma
    rows = []
    for n in RBF_SWEEP_N:
        X = X_all[:n]
        Xc = X.clone()
        rec = {"n": n, "pick_sym": tensor_tile(n, n, True, sms),
               "pick": tensor_tile(n, n, False, sms)}
        for b in TENSOR_TILES:
            rec[f"ms_sym_{b}"] = timed(
                lambda: ops.rbf_kernel_matrix(X, X, g, _tile=b), n)
            rec[f"ms_{b}"] = timed(
                lambda: ops.rbf_kernel_matrix(X, Xc, g, _tile=b), n)
        rec["fma_ms"] = timed(
            lambda: ops.rbf_kernel_matrix(X, X, g, _route="fma"), n)
        rows.append(rec)
        del Xc
        torch.cuda.empty_cache()
    return rows


def phase_kernels(datasets):
    """Each kernel against its plain version at the main path's shapes,
    then its time, the plain version's time, and its bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.smo_chunk import (CLUSTER_ROWS, RESIDENT_BUILDS,
                                               cluster_build,
                                               cluster_capacity,
                                               cluster_shape,
                                               resident_build)
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    info = {}

    # ---- rbf_kernel_matrix: f64 and f32, test shapes and main-path shapes
    rbf_checks = _rbf_checks(datasets, rng)
    rbf_times = _rbf_times(datasets)
    rbf_sweep = _rbf_tile_sweep(datasets[("adult", SIZE_N - 1)])
    info["rbf_kernel_matrix"] = dict(
        rbf_times[-1], max_abs_err=max(c["max_abs_err"] for c in rbf_checks
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
    # each route per iteration, at its main path's largest n: one block at
    # adult n=1000 (Table 1), many blocks at n=32,560 (the size phase)
    err = max(c["max_abs_err"] for c in chunk_checks)
    for name, route in (("smo_chunk", "one_block"),
                        ("smo_chunk_multi_block", "multi_block")):
        rec = max((c for c in chunk_checks if c["fold"] == "cold fold 0"
                   and c["route"] == route), key=lambda c: c["n"])
        info[name] = dict(rec, max_abs_err=err, ms=rec["ms_per_iter"],
                          plain_ms=rec["plain_ms_per_iter"],
                          **_bound(_chunk_iter_bytes(rec["n"], rec["n_iter"]),
                                   0.0))
    # (the cluster and global-state kernels' entries are taken on the wide
    # batch's lanes, in phase_size_wide)
    big = datasets[("adult", SIZE_N - 1)]
    sweep = _chunk_crossover(big)
    widths = _chunk_width_sweep(datasets)
    lane_sweep = _chunk_lane_sweep(big)
    # each route's time model over the sweeps' one-lane points and the
    # lane sweep's, in the form of smo_chunk.ONE_BLOCK_US and its kin
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    points = {r: [] for r in ("one_block", "one_block_global",
                              "multi_block", "cluster")}
    for rec in sweep + lane_sweep:
        n, b, m = rec["n"], rec.get("b", 1), rec["blocks_per_lane"]
        for r in points:
            if f"us_per_iter_{r}" in rec:
                us = rec[f"us_per_iter_{r}"]
                if r == "multi_block":
                    x = [n / 1024, -(-n // m) * -(-(b * m) // sms) / 1024]
                elif r == "cluster":    # every shape the point times
                    for name, us in rec["cluster_shapes_us"].items():
                        c = cluster_shape(n, b, *map(int, name.split("x")),
                                          sms)
                        points[r].append(([n / 1024, c.load / 1024, c.rows],
                                          us))
                    continue
                else:   # per lane an SM carries
                    x, us = [n / 1024], us / -(-b // sms)
                points[r].append((x, us))
    fits = {r: _fit(p) for r, p in points.items() if len(p) > len(p[0][0])}
    builds = {_build_name(r, 0, s).split("x")[0]: dict(zip(
        ("threads", "regs", "local_bytes"), resident_build(r, s)))
        for r, s in RESIDENT_BUILDS}
    # the cluster kernel's builds, and the clusters the card runs at once
    # for each shape (blocks a cluster x rows a thread) at the sweeps' n
    cluster_builds = {r: dict(zip(("threads", "regs", "local_bytes"),
                                  cluster_build(r))) for r in CLUSTER_ROWS}
    capacity = {n: {f"{m}x{r}": c for (m, r), c in
                    cluster_capacity(n).items() if c}
                for n in (270, 1000, 4608, 8192, 32544, 32560)}
    seed_info, seed_checks = _seeding_kernels(datasets[("adult",
                                                        SIZE_N - 1)])
    info.update(seed_info)
    study_info = _study_kernels()
    info.update(study_info)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "seeding": seed_info, "seeding_checks": seed_checks,
          "study": study_info,
          "rbf_checks": rbf_checks, "rbf_times": rbf_times,
          "rbf_tile_sweep": rbf_sweep, "smo_f_update": fu,
          "smo_chunk": chunk_checks, "smo_chunk_crossover": sweep,
          "smo_chunk_width_sweep": widths,
          "smo_chunk_lane_sweep": lane_sweep, "smo_chunk_fits": fits,
          "smo_chunk_resident_builds": builds,
          "smo_chunk_cluster_builds": cluster_builds,
          "smo_chunk_cluster_capacity": capacity})
    return info


def _clone(x, memo=None, to=None):
    """A copy of ``x`` (on device ``to`` where given): tensors cloned,
    tuples (named ones too) copied item by item, anything else as it is.
    One ``memo`` over a call's arguments keeps its aliases: a tensor passed
    twice is copied once."""
    memo = {} if memo is None else memo
    if isinstance(x, torch.Tensor):
        if id(x) not in memo:
            memo[id(x)] = (x if to is None else x.to(to)).clone()
        return memo[id(x)]
    if isinstance(x, tuple):
        items = [_clone(v, memo, to) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _clone_call(a, kw=None, to=None):
    """Copies of a call's positional and keyword arguments (aliases kept),
    on device ``to`` where given."""
    memo = {}
    return (tuple(_clone(x, memo, to) for x in a),
            {k: _clone(v, memo, to) for k, v in (kw or {}).items()})


class _Recorder:
    """Wraps functions ``names`` of ``module`` to keep a copy of each
    call's arguments, taken before the call (some work in place):
    ``calls`` the positional ones, ``kwargs`` the keyword ones (a call's
    aliases kept)."""

    def __init__(self, module, names):
        self.module, self.calls = module, {k: [] for k in names}
        self.kwargs = {k: [] for k in names}
        self.saved = {}

    def __enter__(self):
        for name in self.calls:
            fn = self.saved[name] = getattr(self.module, name)

            def rec(*a, _fn=fn, _k=name, **kw):
                a_c, kw_c = _clone_call(a, kw)
                self.calls[_k].append(a_c)
                self.kwargs[_k].append(kw_c)
                return _fn(*a, **kw)
            setattr(self.module, name, rec)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def _record_seeding_inputs(name: str, n: int) -> dict:
    """The inputs that Table 1's seeds give each seeding kernel: ATO, MIR
    and SIR seeds of fold 0 -> 1 run with the kernels' wrappers wrapped to
    keep a copy of each call's arguments (``_Recorder``)."""
    from repro_torch.core import seeding
    ds, K, y, prev, idx = _seed_problem(name, n)
    with _Recorder(seeding, ("water_fill", "sir_greedy", "ato_system_lanes",
                             "ato_apply_lanes")) as rec:
        for method in ("ato", "mir", "sir"):
            seeding.SEEDERS[method](K, y, ds.C, prev, *idx)
    sync()
    return {"C": ds.C, "K": K, "calls": rec.calls, "kwargs": rec.kwargs}


#: the seeders' bars (``tests/test_torch_seeding.py``'s ``ATOL``), here
#: between a seed through the kernels and through the plain versions on
#: the CPU, from the same fold solution: the LU and SVD are other
#: libraries', ``water_fill``'s sums run in another order
SEED_ATOL = {"sir": lambda C: 1e-10, "mir": lambda C: 1e-10 * C,
             "ato": lambda C: 1e-12 * C}


def _seed_checks() -> list:
    """Whole ATO, MIR and SIR seeds (heart and adult, fold 0 -> 1 and 3
    -> 4) on the card against the same seeds through the plain versions on
    the CPU, within the seeders' bars."""
    from repro_torch.core import seeding
    from repro_torch.svm.engine import SMOResult
    out = []
    for name, n in (("heart", 270), ("adult", 1000)):
        for h in (1, 4):
            ds, K, y, prev, idx = _seed_problem(name, n, h)
            prev_c = SMOResult(*(t.cpu() for t in prev))
            for method in ("ato", "mir", "sir"):
                got = seeding.SEEDERS[method](K, y, ds.C, prev, *idx).cpu()
                want = seeding.SEEDERS[method](
                    K.cpu(), y.cpu(), ds.C, prev_c, *(i.cpu() for i in idx))
                err = float((got - want).abs().max())
                require(err <= SEED_ATOL[method](ds.C),
                        f"{name} fold {h} {method}: seed {err} off the "
                        "plain version")
                out.append({"dataset": name, "fold": h, "method": method,
                            "max_abs_err": err,
                            "bar": SEED_ATOL[method](ds.C)})
    return out


def _cpu(args):
    return tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)


def _leaves(x, seen=None):
    """The tensors of an argument tree (tuples, dicts), each once, in
    order."""
    seen = set() if seen is None else seen
    if isinstance(x, torch.Tensor):
        if id(x) not in seen:
            seen.add(id(x))
            yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v, seen)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v, seen)


def _apply_ms(fn, args, reps: int = 20, kw=None) -> float:
    """Mean device time of an in-place ``ato_apply_lanes`` call (kernel or
    plain) on one copy of ``args`` and ``kw`` (aliases kept), its state
    copied back from them before each call (outside the timed span; the
    copy leaves the inputs in L2, as the ramp's kernels before the call
    do), by CUDA events. The call is enqueued behind a spin kernel
    (``torch.cuda._sleep``, about a millisecond), so the host's time to
    launch it falls outside the span unless the call itself waits on the
    card (the plain version reads its Cs on the host)."""
    a, k = _clone_call(args, kw)
    pairs = list(zip(_leaves((args, kw)), _leaves((a, k))))
    times = []
    for _ in range(reps + 1):
        for src, dst in pairs:
            dst.copy_(src)
        sync()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(2_000_000)
        s.record()
        fn(*a, **k)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return sum(times[1:]) / reps


def _ato_k_entries(free) -> float:
    """K's entries that the lanes' working sets need, read once however
    many lanes share them: the union of each lane's free rows x free
    columns (padding reads nothing the result needs)."""
    free = free.to(torch.float64)
    return float(((free.t() @ free) > 0).sum())


def _ato_system_bytes(a, got) -> float:
    """Bytes that ``ato_system_lanes``' compact route must move on the call
    ``a`` (its output ``got``): K's entries on the working sets
    (``_ato_k_entries``), y, in_S and in_T once, and each lane's alpha, f,
    T_act, R_act, b_fallback and C read and its masks, nf, b, v, w, idx,
    lane, yM, lam, B and rhs[0] written once."""
    lanes, n = got.free.shape
    m_cap = a[-1]
    shared = 8.0 * (_ato_k_entries(got.free) + n) + 2.0 * n
    per_lane = (8.0 * (2 * n + 2) + 2.0 * n        # alpha, f, b_fb, C; acts
                + 2.0 * n + 8.0 * (2 * n + 4)      # masks; v, w, nf, b, lam,
                                                   # r0
                + 9.0 * m_cap + 8.0 * m_cap        # idx and lane; yM
                + 8.0 * (m_cap + 1) ** 2)          # B
    return shared + lanes * per_lane


def _ato_carried_bytes(a, got) -> float:
    """Bytes that ``ato_system_lanes``' carried route must move on the call
    ``a`` (the working set ``got``): K's entries on the working sets, each
    lane's idx and yM, nf and lam read, and its B written."""
    lanes = got.free.shape[0]
    m_cap = a[-1]
    return 8.0 * _ato_k_entries(got.free) + lanes * (
        16.0 * m_cap + 16.0 + 8.0 * (m_cap + 1) ** 2)


def _ato_apply_bytes(a) -> float:
    """Bytes that ``ato_apply_lanes``' split route must move on the call
    ``a``: y once; each lane's done flag read and eta written; and a lane
    that is not done reads g, f, alpha, v, Phi, b, C, its step and its four
    masks and writes f, T_act, R_act, done and step (a done lane stops at
    its flag)."""
    n = a[0].shape[1]
    done = a[13]
    live = float((~done).sum())
    return (8.0 * n + 9.0 * done.shape[0]
            + live * (8.0 * (6 * n + 4) + 6.0 * n + 1.0))


def _ato_fused_bytes(a, kw, nf_next) -> float:
    """Bytes that ``ato_apply_lanes``' fused route must move on the call
    ``a`` / ``kw`` (``nf_next``: each lane's free rows after it): y, in_S
    and in_T once; each lane's done flag read and eta written; and a lane
    that is not done reads g, f, alpha, v, Phi, its four masks, b, C,
    b_fallback and step, and K's diagonal on its next free rows, and
    writes f, alpha, v, w, T_act, R_act, train_now, free, idx, lane, yM,
    nf, b, lam, rhs[0], done and step."""
    n = a[0].shape[1]
    done = a[13]
    m_cap = kw["carry"].s.idx.shape[1]
    live = ~done.cpu()
    nf = torch.as_tensor(nf_next).cpu().to(torch.float64)
    return (10.0 * n + 9.0 * done.shape[0]
            + float(live.sum()) * (8.0 * (5 * n + 4) + 4.0 * n
                                   + 8.0 * (4 * n) + 4.0 * n
                                   + 17.0 * m_cap + 8.0 * 4 + 9.0)
            + 8.0 * float(nf[live].sum()))


def _bits(t):
    """A tensor's bits (float64 as int64), for bitwise comparisons."""
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _same_bits(x, y) -> bool:
    return torch.equal(_bits(x), _bits(y))


def _ato_system_check(calls, kwargs=None) -> dict:
    """``ato_system_lanes`` against its plain version on the CPU on each
    recorded call, replayed on its compact route from the recorded state:
    the exact outputs bitwise, b and r0 (sums in the block's order) within
    1e-12 of their scale. Each recorded call of the carried route (a
    ramp's steps after its first) replayed on its recorded working set
    against the compact route on the same state: every carried field, B
    and rhs[0] bit for bit. Then both routes' times on the first call (the
    carried route on the working set that compact writes there: it is the
    ramp's, as the checks show), the plain version's on the card, and
    each route's bytes bound (the carried route's is ``bound_ms``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import seeding as ks
    exact = ("train_now", "free", "nf", "v", "w", "idx", "lane", "yM", "lam",
             "B")
    err, carried = 0.0, 0
    for a, kw in zip(calls, kwargs or [{}] * len(calls)):
        got = ks.ato_system_lanes(*a)
        want = ref.ato_system_lanes_ref(*_cpu(a))
        for key in exact:
            require(torch.equal(getattr(got, key).cpu(), getattr(want, key)),
                    f"ato_system_lanes: {key} not bitwise equal to the plain "
                    "version")
        for key, g_, w_ in (("b", got.b, want.b),
                            ("r0", got.rhs[:, 0], want.rhs[:, 0])):
            e = float((g_.cpu() - w_).abs().max())
            require(e <= 1e-12 * max(1.0, float(w_.abs().max())),
                    f"ato_system_lanes: {key} off by {e}")
            err = max(err, e)
        if kw.get("_route") != "carried":
            continue
        out = _clone(kw["out"])
        ks.ato_system_lanes(*a, out=out, _route="carried")
        for key in ref.ATO_CARRIED + ("B",):
            require(_same_bits(getattr(out, key), getattr(got, key)),
                    f"ato_system_lanes: the carried route's {key} is not "
                    "the compact route's")
        require(_same_bits(out.rhs[:, 0], got.rhs[:, 0]),
                "ato_system_lanes: the carried rhs[0] is not the compact "
                "route's")
        carried += 1
    a = calls[0]
    got = ks.ato_system_lanes(*a)
    work = ks.ato_system_lanes(*a)
    # each time the least of three graphs: one graph's reading of the
    # carried route once came out 13 times the others' on the H100
    best = lambda fn: min(graph_ms(fn, 20) for _ in range(3))  # noqa: E731
    return {"lanes": a[3].shape[0], "n": a[1].shape[0], "m_cap": a[-1],
            "nf": got.nf.tolist(), "steps_checked": len(calls),
            "carried_steps_checked": carried,
            "ms": best(lambda: ks.ato_system_lanes(
                *a, out=work, _route="carried")),
            "ms_compact": best(lambda: ks.ato_system_lanes(*a)),
            "plain_ms": cuda_ms(lambda: ref.ato_system_lanes_ref(*a), 5),
            "max_abs_err": err, **_bound(_ato_carried_bytes(a, got), 0.0),
            "bound_ms_compact": _bound(_ato_system_bytes(a, got),
                                       0.0)["bound_ms"]}


def _split_update_clamp(g, f, alpha, v, Phi, y, b, Cs, *rest):
    """The parent's step tail: the split apply, then ``smo_f_update`` and
    the clamp of alpha."""
    from repro_torch.kernels import seeding as ks
    from repro_torch.kernels.smo_update import smo_f_update
    eta = ks.ato_apply_lanes(g, f, alpha, v, Phi, y, b, Cs, *rest)
    torch.clamp(smo_f_update(alpha, v, Phi, eta),
                torch.zeros_like(Cs)[:, None], Cs[:, None], out=alpha)
    return eta


def _ato_apply_check(calls, kwargs=None) -> dict:
    """``ato_apply_lanes`` on each recorded call: its split route (the
    positional arguments alone) against the plain split version on the
    CPU, every output bitwise; and each fused call (the ramp's) against
    the split route, ``smo_f_update`` and the clamp on the card (alpha, f,
    T_act, R_act, done, step, eta bit for bit) and against the plain fused
    version on the CPU (those, and every field it hands the next step but
    b and rhs[0], bitwise; b and rhs[0] within 1e-12 of their scale: sums
    in the block's order). Then the fused route's time, the split route's
    alone and with ``smo_f_update`` and the clamp (the parent's step
    tail), the plain fused version's on the card, and the bytes bounds."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import seeding as ks
    exact = ("train_now", "free", "nf", "v", "w", "idx", "lane", "yM", "lam")
    fused, first, err = 0, None, 0.0
    for a, kw in zip(calls, kwargs or [{}] * len(calls)):
        card = tuple(x.clone() if isinstance(x, torch.Tensor) else x
                     for x in a)
        cpu = _cpu(a)
        eta_c = ks.ato_apply_lanes(*card)
        eta = ref.ato_apply_lanes_ref(*cpu)
        require(torch.equal(eta_c.cpu(), eta)
                and all(torch.equal(x.cpu(), w) for x, w in zip(card, cpu)
                        if isinstance(x, torch.Tensor)),
                "ato_apply_lanes: not bitwise equal to the plain version")
        if kw.get("carry") is None:
            continue
        fa, fkw = _clone_call(a, kw)
        eta_f = ks.ato_apply_lanes(*fa, **fkw)
        sa, _ = _clone_call(a)
        eta_s = _split_update_clamp(*sa)
        require(_same_bits(eta_f, eta_s)
                and all(_same_bits(fa[i], sa[i])
                        for i in (1, 2, 11, 12, 13, 14)),
                "ato_apply_lanes: the fused route is not the split route, "
                "smo_f_update and the clamp")
        pa, pkw = _clone_call(a, kw, to="cpu")
        eta_p = ref.ato_apply_lanes_ref(*pa, **pkw)
        require(_same_bits(eta_f.cpu(), eta_p)
                and all(_same_bits(fa[i].cpu(), pa[i])
                        for i in (1, 2, 11, 12, 13, 14)),
                "ato_apply_lanes: the fused route is not the plain fused "
                "version")
        s_c, s_p = fkw["carry"].s, pkw["carry"].s
        for key in exact:
            require(_same_bits(getattr(s_c, key).cpu(), getattr(s_p, key)),
                    f"ato_apply_lanes: the fused route's next {key} is not "
                    "the plain version's")
        for g_, w_ in ((s_c.b, s_p.b), (s_c.rhs[:, 0], s_p.rhs[:, 0])):
            e = float((g_.cpu() - w_).abs().max())
            require(e <= 1e-12 * max(1.0, float(w_.abs().max())),
                    f"ato_apply_lanes: the fused route's b or r0 off by {e}")
            err = max(err, e)
        fused += 1
        if first is None:
            first = (a, kw, s_c.nf.clone())
    a = calls[0]
    out = {"lanes": a[1].shape[0], "n": a[1].shape[1],
           "steps_checked": len(calls), "fused_steps_checked": fused,
           "ms_split": _apply_ms(ks.ato_apply_lanes, a),
           "ms_split_update_clamp": _apply_ms(_split_update_clamp, a),
           "bound_ms_split": _bound(_ato_apply_bytes(a), 0.0)["bound_ms"],
           "max_abs_err": err}
    if first is None:   # no fused call recorded: the split route's row
        return {**out, "ms": out["ms_split"],
                "plain_ms": _apply_ms(ref.ato_apply_lanes_ref, a),
                **_bound(_ato_apply_bytes(a), 0.0)}
    a, kw, nf = first
    return {**out, "ms": _apply_ms(ks.ato_apply_lanes, a, kw=kw),
            "plain_ms": _apply_ms(ref.ato_apply_lanes_ref, a, kw=kw),
            **_bound(_ato_fused_bytes(a, kw, nf), 0.0)}


#: water_fill's rows at n = 32,560's shapes: the S side of a k = 10
#: transition (3,256 of T; 26,048 of S)
WATER_BIG = (3256, 26048)
#: SIR's fold counts at adult n = 32,560: |R| = |T| = 3,256, 6,512, 10,853
SIR_SIZE_K = (10, 5, 3)
#: removed rows a segment of sir_greedy's walk, timed at 6,512 (0: one)
SIR_SEGMENTS = (0, 512, 1024, 1628, 2048, 4096)


def _water_fill_big(C: float, sizes=WATER_BIG) -> list:
    """water_fill's inputs at ``sizes`` rows (seeded numpy): beta in the
    box of C, a feasible target."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    out = []
    for n_big in sizes:
        yb = np.where(rng.random(n_big) < 0.5, 1.0, -1.0)
        lo, hi = np.where(yb > 0, 0.0, -C), np.where(yb > 0, C, 0.0)
        beta = np.clip(rng.normal(size=n_big) * C / 3, lo, hi)
        out.append(tuple(torch.as_tensor(a, device=dev) for a in
                         (beta, lo, hi)) + (torch.tensor(
                             float(beta.sum()) * 0.3, device=dev),))
    return out


def _water_fill_levels_ms(small, large) -> dict:
    """water_fill's time (graph) at each forced levels a round, 1-5, and
    the witness build's, on Table 1's call and at 26,048 rows."""
    from repro_torch.kernels import seeding as ks
    out = {}
    for key, a, reps in (("small", small, 20), ("large", large, 5)):
        row = {"n": a[0].shape[0], "seq": graph_ms(
            lambda: ks.water_fill(*a, _build_name="water_fill_seq"), reps)}
        for lv in (1, 2, 3, 4, 5):
            row[str(lv)] = graph_ms(lambda: ks.water_fill(*a, _levels=lv),
                                    reps)
        out[key] = row
    return out


def _sir_plain(K, y_R, y_T, alpha_R, priority, R=None, T=None,
               fallback="random"):
    """The plain greedy pass on the card, over the gathered block."""
    from repro_torch.kernels import ref
    block = K if R is None else K[R[:, None], T]
    return ref.sir_greedy_ref(block, y_R, y_T, alpha_R, priority, fallback)


def _sir_bytes(m: int, t: int) -> float:
    """Bytes sir_greedy must move: the (m, t) entries of K it reads, y_R,
    alpha_R and R_idx, y_T, the priorities and T_idx, once each, and
    beta_T written."""
    return 8.0 * (m * t + 3 * m + 4 * t)


def _sir_check(a, fb: str) -> dict:
    """sir_greedy on ``a`` (K, y_R, y_T, alpha_R, priority[, R_idx,
    T_idx]) bitwise the plain version run on the CPU over the gathered
    block, with the rescanned and fallback rows it counted."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import seeding as ks
    K, rest, idx = a[0], a[1:5], a[5:]
    ks.reset_sir_greedy_events()
    got = ks.sir_greedy(K, *rest, fb, *idx)
    events = ks.sir_greedy_events()
    block = K.cpu() if not idx else K[idx[0][:, None], idx[1]].cpu()
    want = ref.sir_greedy_ref(block, *_cpu(rest), fb)
    m, t = block.shape
    require(torch.equal(got.cpu(), want),
            f"sir_greedy {m} x {t} {fb}: not bitwise equal to the plain "
            "version")
    return {"shape": [m, t], "fallback": fb, "indexed": bool(idx),
            "bitwise": True, **events}


def _sir_size_inputs(K, y, k: int):
    """sir_greedy's inputs at fold 0 -> 1 of k folds over adult n =
    32,560 (``K`` over its first 32,560 rows): y_R, y_T, a seeded alpha_R
    in [0, C), the reference's priorities, R_idx and T_idx."""
    from repro_torch.core.cv import _transition_idx
    from repro_torch.core.threefry import uniform
    from repro_torch.data.svm_suite import kfold_chunks
    dev = K.device
    chunks = kfold_chunks(SIZE_N, k)
    _, R, T = _transition_idx(chunks, 0, 1, dev)
    alpha = torch.as_tensor(np.random.default_rng(k).random(R.shape[0]),
                            device=dev)
    pri = torch.as_tensor(uniform(0, T.shape[0], "float64"), device=dev)
    return y[R], y[T], alpha, pri, R, T


def _sir_pass_ms(K, y_R, y_T, alpha_R, priority, R, T, reps: int = 3) -> dict:
    """The greedy pass as ``sir_seed`` takes it, by CUDA events: the
    package's own route (a package whose ``sir_greedy`` takes the index
    sets reads K through them; an older one gathers the block first), and
    the gather of the (|R|, |T|) block alone. ``refused``: the package's
    kernel does not take this |T|."""
    import inspect
    from repro_torch.kernels import seeding as ks
    rest = (y_R, y_T, alpha_R, priority)
    gather = lambda: K[R][:, T]   # noqa: E731
    out = {"gather_ms": cuda_ms(gather, reps)}
    try:
        if "R_idx" in inspect.signature(ks.sir_greedy).parameters:
            out["ms"] = cuda_ms(
                lambda: ks.sir_greedy(K, *rest, "random", R, T), reps)
            out["route"] = "indexed"
        else:
            out["ms"] = cuda_ms(lambda: ks.sir_greedy(gather(), *rest),
                                reps)
            out["route"] = "gather_kernel"
    except ValueError as e:
        out["refused"] = str(e)
    return out


def _sir_at_size(ds) -> dict:
    """sir_greedy at adult n = 32,560 (K from the RBF kernel, read through
    fold 0 -> 1's index sets at k = 10, 5 and 3): bitwise the plain
    version for both fallbacks, with the rescanned and fallback rows; its
    time (graph) and bound at each, the gather that the parent's design
    made before its kernel and the same kernel over that block (at 6,512),
    and each list length's time at 6,512."""
    from repro_torch.kernels import seeding as ks
    from repro_torch.svm import kernel_matrix
    dev = torch.device("cuda")
    X = torch.as_tensor(ds.X[:SIZE_N - 1], device=dev)
    y = torch.as_tensor(ds.y[:SIZE_N - 1], dtype=torch.float64, device=dev)
    K = kernel_matrix(X, X, gamma=ds.gamma)
    out = {"at_size_checks": []}
    for k in SIR_SIZE_K:
        a = _sir_size_inputs(K, y, k)
        m = a[4].shape[0]
        for fb in ("random", "skip"):
            out["at_size_checks"].append(_sir_check((K,) + a, fb))
        run = lambda: ks.sir_greedy(K, *a[:4], "random", *a[4:])  # noqa
        out[f"ms_{m}"] = graph_ms(run, 3)
        out[f"bound_ms_{m}"] = _bound(_sir_bytes(m, m), 0.0)["bound_ms"]
        if k == 5:
            block = K[a[4]][:, a[5]]
            out[f"gather_ms_{m}"] = cuda_ms(lambda: K[a[4]][:, a[5]], 3)
            out[f"block_ms_{m}"] = graph_ms(
                lambda: ks.sir_greedy(block, *a[:4]), 3)
            out[f"list_ms_{m}"] = {str(L): graph_ms(lambda: ks.sir_greedy(
                K, *a[:4], "random", *a[4:], _list=L), 3)
                for L in ks.SIR_LISTS}
            out[f"segment_ms_{m}"] = {}
            for seg in sorted(set(SIR_SEGMENTS + (ks.sir_segment(m),))):
                ks.reset_sir_greedy_events()
                ks.sir_greedy(K, *a[:4], "random", *a[4:], _segment=seg)
                out[f"segment_ms_{m}"][str(seg)] = {
                    "ms": graph_ms(lambda: ks.sir_greedy(
                        K, *a[:4], "random", *a[4:], _segment=seg), 3),
                    **ks.sir_greedy_events()}
            del block
    del K
    torch.cuda.empty_cache()
    return out


def _seeding_kernels(size_ds) -> dict:
    """Each seeding kernel against its plain version run on the CPU, on
    the inputs Table 1's adult fold 0 -> 1 seeds gave it (recorded), and
    ``water_fill`` and ``sir_greedy`` at n = 32,560's shapes (seeded numpy
    for ``water_fill``, adult's K through its folds' index sets for
    ``sir_greedy``, ``_sir_at_size``): bitwise for ``sir_greedy``,
    ``ato_apply_lanes`` and ``ato_system_lanes``' exact outputs (one lane:
    the solo ramp), ``water_fill`` bitwise its one-level witness build
    (``water_fill_seq``), within 1e-12 max(C, 1) of the plain version
    elementwise and its sum within n eps max(C, 1) of the clamped target.
    Then each one's time at the main path's shape (graph, or CUDA events
    for the in-place ``ato_apply_lanes``), the plain version's on the
    card, and the bytes bound (every one is bound by bytes: its
    operations, even 100 bisection steps of 4 a row, take less)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import seeding as ks
    dev = torch.device("cuda")
    rec = _record_seeding_inputs("adult", 1000)
    C, calls = rec["C"], rec["calls"]
    # heart's ramp runs all 30 steps (adult's stops after one): check
    # every one of its steps too
    heart_rec = _record_seeding_inputs("heart", 270)
    heart = heart_rec["calls"]
    out, records = {}, {}

    # water_fill: every call of the three seeds, then n = 32,560's S side;
    # each bitwise the one-level witness build
    wf = []
    big = _water_fill_big(C)
    for args in calls["water_fill"] + heart["water_fill"] + big:
        got = ks.water_fill(*args)
        want = ref.water_fill_ref(*_cpu(args))
        seq = ks.water_fill(*args, _build_name="water_fill_seq")
        n = args[0].shape[0]
        require(torch.equal(got.view(torch.int64), seq.view(torch.int64)),
                f"water_fill n={n}: not bitwise the one-level witness")
        err = float((got.cpu() - want).abs().max())
        tgt = float(torch.clamp(args[3].cpu(), args[1].cpu().sum(),
                                args[2].cpu().sum()))
        sum_err = abs(float(got.sum()) - tgt)
        box = max(float(args[1].abs().max()), float(args[2].abs().max()),
                  1.0)                                     # max(C, 1)
        require(err <= 1e-12 * box,
                f"water_fill n={n}: {err} off the plain version")
        require(sum_err <= n * 2.22e-16 * box,
                f"water_fill n={n}: sum {sum_err} off the target")
        wf.append({"n": n, "max_abs_err": err, "sum_err": sum_err,
                   "witness_bitwise": True})
    main = max(calls["water_fill"], key=lambda a: a[0].shape[0])   # S side
    n = main[0].shape[0]
    rec_wf = {"n": n, "ms": graph_ms(lambda: ks.water_fill(*main), 20),
              "plain_ms": cuda_ms(lambda: ref.water_fill_ref(
                  *main, stop_early=False), 3),
              "ms_32560_S": graph_ms(lambda: ks.water_fill(*big[1]), 5),
              "levels_ms": _water_fill_levels_ms(main, big[1]),
              "calls_checked": len(wf),
              "max_abs_err": max(r["max_abs_err"] for r in wf),
              **_bound(8.0 * (4 * n + 1), 0.0)}
    records["water_fill"] = wf
    out["water_fill"] = rec_wf

    # sir_greedy: Table 1's call (both fallbacks, K through its indices),
    # heart's, a tied 3,256 x 3,256 block, then adult n = 32,560's folds
    sg = []
    args = calls["sir_greedy"][0][:5] + calls["sir_greedy"][0][6:]
    rows = np.random.default_rng(5)
    kb = rows.random((3256, 3256))
    kb[:, 1::2] = kb[:, 0::2][:, :kb[:, 1::2].shape[1]]   # tied values
    tied = tuple(torch.as_tensor(a, device=dev) for a in (
        kb, np.where(rows.random(3256) < 0.5, 1.0, -1.0),
        np.where(rows.random(3256) < 0.5, 1.0, -1.0), rows.random(3256),
        rows.random(3256)))
    heart_sg = heart["sir_greedy"][0][:5] + heart["sir_greedy"][0][6:]
    for a, fb in ((args, "random"), (args, "skip"), (heart_sg, "random"),
                  (tied, "random"), (tied, "skip")):
        sg.append(_sir_check(a, fb))
    m, t = args[5].shape[0], args[6].shape[0]
    sir_args = args[1:5] + ("random",) + args[5:]
    records["sir_greedy"] = sg
    out["sir_greedy"] = {
        "shape": [m, t],
        "ms": graph_ms(lambda: ks.sir_greedy(args[0], *sir_args), 20),
        "plain_ms": cuda_ms(lambda: _sir_plain(*args), 3),
        "max_abs_err": 0.0, "checks": sg,
        **_bound(_sir_bytes(m, t), 0.0),
        **_sir_at_size(size_ds)}
    # ato_system_lanes / ato_apply_lanes: every ramp step of the ATO seed
    # (the solo ramp: one lane), the carried route against the compact one
    # and the fused apply against the split one on each
    kw, heart_kw = rec["kwargs"], heart_rec["kwargs"]
    out["ato_system_lanes"] = _ato_system_check(
        calls["ato_system_lanes"] + heart["ato_system_lanes"],
        kw["ato_system_lanes"] + heart_kw["ato_system_lanes"])
    out["ato_apply_lanes"] = _ato_apply_check(
        calls["ato_apply_lanes"] + heart["ato_apply_lanes"],
        kw["ato_apply_lanes"] + heart_kw["ato_apply_lanes"])
    records["seeds"] = _seed_checks()
    del rec, heart, heart_rec
    torch.cuda.empty_cache()
    return out, records


def _chunk_iter_bytes(n: int, iters: int) -> float:
    """Bytes a dense SMO chunk of ``iters`` iterations must move, per
    iteration: the K_i and K_j rows of each iteration (16 n), and once a
    chunk the lane's state, alpha, f, y and diag (8 bytes each) and the
    mask (1 byte) read, alpha and f written (49 n). The state fits on
    chip, and alpha changes at i and j only."""
    return 16.0 * n + 49.0 * n / max(iters, 1)


def _chunk_problem(ds, n, dev):
    """adult's (or ``ds``'s) first n rows as one dense lane: cold, its first
    tenth held out. Returns K, diag, y, the mask and the cold state."""
    from repro_torch.kernels import ops
    X = torch.as_tensor(ds.X[:n], device=dev)
    y = torch.as_tensor(ds.y[:n], dtype=torch.float64, device=dev)
    K = ops.rbf_kernel_matrix(X, X, ds.gamma)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    mask[:n // 10] = False           # fold 0 of 10 at this n
    state = (torch.zeros_like(y), -y, torch.tensor(0, device=dev),
             torch.tensor(False, device=dev))
    return K, torch.diagonal(K).contiguous(), y, mask, state


def _routes_here(n: int, m: int, cluster) -> tuple:
    """The dense chunk's routes that can take a launch's lanes of n rows,
    given the multi-block plan's m blocks a lane and the cluster plan."""
    from repro_torch.kernels.smo_chunk import one_block_plan
    return (("one_block",) if one_block_plan(n) is not None else ()) \
        + (("multi_block",) if m >= 1 else ()) \
        + (("cluster",) if cluster is not None else ()) \
        + ("one_block_global",)


def _plans(n: int, b: int) -> tuple:
    """The multi-block plan's blocks a lane and the cluster plan for b
    lanes of n rows on this card: what ``chunk_route`` decides from."""
    from repro_torch.kernels.smo_chunk import (_sms, cluster_capacity,
                                               cluster_plan,
                                               multi_block_plan)
    return (multi_block_plan(n, b)[0],
            cluster_plan(n, b, cluster_capacity(n), _sms()))


def _fit(points) -> list:
    """Least-squares [floor, slope, ...] of us against each feature (the
    form of ``smo_chunk.ONE_BLOCK_US`` and its kin); a point is (features,
    us)."""
    X = np.array([[1.0] + list(x) for x, _ in points])
    ys = np.array([y for _, y in points])
    return [float(c) for c in np.linalg.lstsq(X, ys, rcond=None)[0]]


def _chunk_crossover(ds):
    """The dense chunk's routes side by side on adult's first n rows, its
    first tenth held out, CHUNK_SWEEP_ITERS capped WSS-2 iterations: bitwise
    equal, each route's time per iteration (with the lane sweep, what
    ``smo_chunk.ONE_BLOCK_US`` and its kin were fitted to), the fastest,
    and the route ``chunk_route`` picks. Where it picks the
    resident one-block kernel, that kernel must be no slower than the
    global-state one it replaced."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.smo_chunk import _sms, chunk_route
    dev = torch.device("cuda")
    out = []
    for n in CHUNK_SWEEP_N:
        K, diag, y, mask, state = _chunk_problem(ds, n, dev)
        cap = CHUNK_SWEEP_ITERS
        args = (K, diag, y, mask, ds.C, 1e-3, cap, cap + 1, "2", *state)
        m, cluster = _plans(n, 1)
        routes = _routes_here(n, m, cluster)
        res = {r: ops.smo_chunk(*args, _route=r) for r in routes}
        for r in routes[1:]:
            for a, b, what in zip(res[routes[0]], res[r],
                                  ("alpha", "f", "n_iter", "done")):
                require(torch.equal(a, b), f"smo_chunk n={n}: {routes[0]} "
                                           f"and {r}'s {what} differ")
        it = int(res[routes[0]][2])
        rec = {"n": n, "n_iter": it, "blocks_per_lane": m,
               "cluster": cluster,
               "route": chunk_route(n, 1, m, cluster, _sms())}
        for r, ms in routes_ms(lambda r: ops.smo_chunk(*args, _route=r),
                               routes).items():
            rec[f"us_per_iter_{r}"] = 1e3 * ms / it
        if cluster is not None:
            rec.update(_cluster_shapes(n, 1, cluster, res["cluster"], it,
                                       lambda shape: ops.smo_chunk(
                                           *args, _route="cluster",
                                           _cluster=shape)))
        _judge_routes(rec, routes)
        if rec["route"] == "one_block":
            require(rec["us_per_iter_one_block"]
                    <= rec["us_per_iter_one_block_global"],
                    f"smo_chunk n={n}: the resident kernel is slower than "
                    "the global-state one where chunk_route picks it")
        out.append(rec)
        del K, diag, res
    return out


def _chunk_width_sweep(datasets):
    """The resident one-block kernel at each of its builds (rows a thread
    in registers or shared memory, so the block's width) that holds a
    lane: heart n=270 and adult n=1000 on their cold fold 0 to
    convergence, and adult's first n rows of CHUNK_WIDTH_SWEEP_N capped at
    CHUNK_SWEEP_ITERS. Every build bitwise equal; each one's time per
    iteration, the fastest, and the build ``one_block_plan`` picks; and
    each build's most threads, registers and spilled bytes a thread."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.smo_chunk import (RESIDENT_BUILDS,
                                               one_block_plan,
                                               resident_build,
                                               resident_threads)
    dev = torch.device("cuda")
    big = datasets[("adult", SIZE_N - 1)]
    cases = [("heart", datasets[("heart", 270)], 270, 10 ** 6),
             ("adult", datasets[("adult", 1000)], 1000, 10 ** 6)] + [
        ("adult", big, n, CHUNK_SWEEP_ITERS) for n in CHUNK_WIDTH_SWEEP_N]
    out = []
    for name, ds, n, cap in cases:
        K, diag, y, mask, state = _chunk_problem(ds, n, dev)
        args = (K, diag, y, mask, ds.C, 1e-3, cap, cap + 1, "2", *state)
        plan = one_block_plan(n)
        want = ops.smo_chunk(*args, _route="one_block")
        it = int(want[2])
        times = {}
        for rows, smem in RESIDENT_BUILDS:
            threads = resident_threads(n, rows)
            if threads > resident_build(rows, smem)[0]:
                continue
            got = ops.smo_chunk(*args, _route="one_block", _rows=(rows, smem))
            for a, b, what in zip(got, want, ("alpha", "f", "n_iter",
                                              "done")):
                require(torch.equal(a, b), f"smo_chunk n={n}: build {rows} "
                                           f"rows ({smem}) {what} differs")
            ms = cuda_ms(lambda: ops.smo_chunk(
                *args, _route="one_block", _rows=(rows, smem)), 3)
            times[_build_name(rows, threads, smem)] = 1e3 * ms / it
        out.append({"dataset": name, "n": n, "n_iter": it,
                    "us_per_iter": times,
                    "fastest": min(times, key=times.get),
                    "plan": _build_name(*plan)})
        del K, diag
    return out


def _build_name(rows: int, threads: int, smem: bool) -> str:
    """A resident build at a block: "4x256" (registers), "8sx512" (shared
    memory)."""
    return f"{rows}{'s' if smem else ''}x{threads}"


def _chunk_lane_sweep(ds):
    """The dense chunk's routes over b lanes (lane l holds out adult's
    tenth l mod 10), CHUNK_SWEEP_ITERS capped WSS-2 iterations, at each n of
    CHUNK_LANE_SWEEP_N: b = 1, 4, 16 and the widest batch the multi-block
    plan still places (its lanes' state fills the card's shared memory, so
    few blocks a lane), then one lane more, which that plan cannot place;
    and at the wide points of CHUNK_WIDE_SWEEP. Every route that places
    the launch, bitwise equal lane by lane; each one's time per iteration,
    the fastest, the plans (what ``chunk_route`` decides from), the route
    it took, and whether that was the fastest."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.smo_chunk import (_sms, chunk_route,
                                               multi_block_plan)
    dev = torch.device("cuda")
    out = []
    for n in sorted(set(CHUNK_LANE_SWEEP_N) | set(CHUNK_WIDE_SWEEP)):
        widest = 1
        while multi_block_plan(n, widest + 1)[0] >= 1:
            widest += 1
        X = torch.as_tensor(ds.X[:n], device=dev)
        y = torch.as_tensor(ds.y[:n], dtype=torch.float64, device=dev)
        K = ops.rbf_kernel_matrix(X, X, ds.gamma)
        diag = torch.diagonal(K).contiguous()
        lanes_here = set(CHUNK_WIDE_SWEEP.get(n, ()))
        if n in CHUNK_LANE_SWEEP_N:
            lanes_here |= {1, 4, 16, widest, widest + 1}
        for b in sorted(lanes_here):
            masks = torch.ones((b, n), dtype=torch.bool, device=dev)
            for l in range(b):
                masks[l, (l % 10) * (n // 10):(l % 10 + 1) * (n // 10)] = False
            cap = CHUNK_SWEEP_ITERS
            lanes = (K, diag, y, masks, [ds.C] * b, 1e-3, [cap] * b, cap + 1,
                     "2", torch.zeros((b, n), dtype=torch.float64,
                                      device=dev),
                     -y.repeat(b, 1), torch.zeros(b, dtype=torch.int64,
                                                  device=dev),
                     torch.zeros(b, dtype=torch.bool, device=dev))
            m, cluster = _plans(n, b)
            before = ops.route_counts()["smo_chunk"]
            res = {"auto": ops.smo_chunk_lanes(*lanes)}
            route = _route_taken(before, ops.route_counts()["smo_chunk"])
            want = chunk_route(n, b, m, cluster, _sms())
            require(route == want, f"smo_chunk n={n} b={b}: took {route}, "
                    f"chunk_route says {want}")
            require((m >= 1) == (b <= widest), f"smo_chunk n={n} b={b}: "
                    f"{m} blocks a lane, {widest} lanes the widest placed")
            routes = _routes_here(n, m, cluster)
            rec = {"n": n, "b": b, "blocks_per_lane": m, "cluster": cluster,
                   "route": route, "widest_multi_block": widest,
                   "sms": _sms()}
            for r in routes:
                got = ops.smo_chunk_lanes(*lanes, _route=r)
                for a, w, what in zip(got, res["auto"], ("alpha", "f",
                                                         "n_iter", "done")):
                    require(torch.equal(a, w), f"smo_chunk n={n} b={b}: {r}"
                                               f"'s {what} differ")
                require(bool(got[3].all()) and int(got[2].min()) == cap,
                        f"smo_chunk n={n} b={b}: {r} stopped short of the cap")
            for r, ms in routes_ms(lambda r: ops.smo_chunk_lanes(
                    *lanes, _route=r), routes).items():
                rec[f"us_per_iter_{r}"] = 1e3 * ms / cap
            if cluster is not None:
                rec.update(_cluster_shapes(n, b, cluster, res["auto"], cap,
                                           lambda shape: ops.smo_chunk_lanes(
                                               *lanes, _route="cluster",
                                               _cluster=shape)))
            _judge_routes(rec, routes)
            out.append(rec)
            del lanes, res, masks
        del K, diag
        torch.cuda.empty_cache()
    return out


def _judge_routes(rec: dict, routes) -> None:
    """The fastest of a sweep point's routes, whether ``chunk_route``'s
    pick (``rec["route"]``) was it, and a failure unless the pick is within
    CHUNK_ROUTE_MARGIN of it."""
    us = {r: rec[f"us_per_iter_{r}"] for r in routes}
    rec["faster"] = min(us, key=us.get)
    rec["picks_faster"] = rec["faster"] == rec["route"]
    require(us[rec["route"]] <= (1 + CHUNK_ROUTE_MARGIN) * us[rec["faster"]],
            f"smo_chunk n={rec['n']} b={rec.get('b', 1)}: chunk_route picks "
            f"{rec['route']} at {us[rec['route']]:.2f} us, {rec['faster']} "
            f"takes {us[rec['faster']]:.2f}")


def _cluster_shapes(n: int, b: int, plan, want, iters: int, run) -> dict:
    """Every cluster shape (blocks a cluster x rows a thread) of which the
    card runs b clusters of n rows at once: bitwise ``want`` (the lanes on
    ``plan``'s shape), and its time an iteration (``run(shape)`` launches
    the chunk at a shape), beside the plan's: what
    ``smo_chunk.CLUSTER_US`` is fitted to and how far the plan is from the
    fastest shape."""
    from repro_torch.kernels.smo_chunk import cluster_capacity
    us = {}
    for shape in sorted(s for s, c in cluster_capacity(n).items() if c >= b):
        for a, w, what in zip(run(shape), want, ("alpha", "f", "n_iter",
                                                 "done")):
            require(torch.equal(a, w), f"smo_chunk n={n} b={b}: cluster "
                                       f"shape {shape}'s {what} differs")
        us[f"{shape[0]}x{shape[1]}"] = 1e3 * cuda_ms(lambda: run(shape),
                                                     3) / iters
    fastest = min(us, key=us.get)
    return {"cluster_shapes_us": us, "cluster_fastest_shape": fastest,
            "cluster_plan_regret_us": (us[f"{plan.blocks}x{plan.rows}"]
                                       - us[fastest])}


def _chunk_checks(ds, it_cap: int):
    """smo_chunk against the plain step engine (its f-update through the
    smo_f_update kernel) on ``ds``'s cold fold 0 and SIR-seeded fold 1:
    alpha, f, n_iter and done must be bitwise equal, and bitwise the
    global-state one-block kernel, whose time is taken beside the route's.
    Where the route is multi-block (n=32,560) also bitwise against its own
    replay from a CUDA graph. At heart's size also checks that
    ``chunk_iters=512`` equals one chunk."""
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
        before = ops.route_counts()["smo_chunk"]
        got = ops.smo_chunk(*args, alpha0, f0, zero_it, no)
        route = _route_taken(before, ops.route_counts()["smo_chunk"])
        err = max(float((got[k] - plain[k]).abs().max()) for k in (0, 1))
        for a, b, what in zip(got, plain, ("alpha", "f", "n_iter", "done")):
            require(torch.equal(a, b), f"smo_chunk n={n} {label}: {what} "
                                       "differs from the plain step engine")
        require(bool(got[3]), f"smo_chunk n={n} {label}: not done")
        ms = cuda_ms(lambda: ops.smo_chunk(*args, alpha0, f0, zero_it, no),
                     3)
        it = int(got[2])
        rec = {"fold": label, "n": n, "it_cap": it_cap, "route": route,
               "n_iter": it, "ms": ms, "plain_ms": 1e3 * plain_s,
               "ms_per_iter": ms / it, "plain_ms_per_iter": 1e3 * plain_s / it,
               "us_per_iter": 1e3 * ms / it, "max_abs_err": err}
        # the route against the global-state one-block kernel, bitwise
        one = ops.smo_chunk(*args, alpha0, f0, zero_it, no,
                            _route="one_block_global")
        for a, b, what in zip(got, one, ("alpha", "f", "n_iter", "done")):
            require(torch.equal(a, b), f"smo_chunk n={n} {label}: {what} "
                                       "differs from the global-state kernel")
        rec["us_per_iter_one_block_global"] = 1e3 * cuda_ms(
            lambda: ops.smo_chunk(*args, alpha0, f0, zero_it, no,
                                  _route="one_block_global"), 3) / it
        if route == "multi_block":
            # and captured in a CUDA graph (C and the cap on the device)
            lanes = (K, diag, y, mask[None],
                     torch.full((1,), ds.C, dtype=torch.float64, device=dev),
                     1e-3, torch.full((1,), it_cap, device=dev), it_cap + 1,
                     "2", alpha0[None], f0[None], zero_it.reshape(1),
                     no.reshape(1))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = ops.smo_chunk_lanes(*lanes)
            graph.replay()
            sync()
            require(all(torch.equal(a[0], b) for a, b in zip(out, got)),
                    f"smo_chunk n={n} {label}: the graph's replay differs")
            del graph, out
            rec["us_per_iter_graph"] = 1e3 * graph_ms(
                lambda: ops.smo_chunk_lanes(*lanes), 3) / it
        checks.append(rec)

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


def _route_taken(before: dict, after: dict) -> str:
    """The one route whose launch count grew between two ``route_counts``
    readings of one kernel."""
    grew = [r for r in after if after[r] != before[r]]
    require(len(grew) == 1, f"expected launches on one route, got {grew}")
    return grew[0]


def phase_table1(build_s: float, split: dict | None = None):
    """The paper's Table 1 (k=10, four methods) through ``run_cv``; beside
    each seeded method's init, its seed's split on fold 0 -> 1
    (``seed_split``, measured before the counts were reset)."""
    from repro_torch.core.cv import run_cv
    from repro_torch.data.svm_suite import make_dataset
    t0 = time.perf_counter()
    rows, cold_folds = [], {}
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
            if refd["gated"]:
                require(it == refd["iterations"][method],
                        f"{name} {method}: {it} iterations, the reference "
                        f"takes {refd['iterations'][method]}")
            rows.append({
                "dataset": name, "n": rep.n, "method": method,
                "iterations": it,
                "reference_iterations": refd["iterations"][method],
                "gated": refd["gated"],
                "per_fold_iterations": [f.n_iter for f in rep.folds],
                "kernel_s": rep.kernel_time, "init_s": rep.total_init_time,
                "init_split_fold1": (split or {}).get(f"{name}/{method}"),
                "solve_s": rep.total_solve_time,
                "us_per_iteration": 1e6 * rep.total_solve_time / max(it, 1),
                "accuracy": rep.accuracy,
                "reference_accuracy": refd["accuracy"]})
            require(round(rep.accuracy, 4) == refd["accuracy"],
                    f"{name} {method}: accuracy {rep.accuracy} != "
                    f"{refd['accuracy']}")
        require(all(per_fold[m] == per_fold["cold"] for m in METHODS),
                f"{name}: per-fold accuracies differ across methods")
        cold_folds[name] = per_fold["cold"]
    emit({"phase": "table1", "seconds": time.perf_counter() - t0,
          "kernel_build_s": build_s, "rows": rows})
    return cold_folds


#: the seeding split's wrapped functions: a leaf is timed whole (its time
#: is its own, nested torch ops included), a container's torch ops are
#: timed one by one and filed by kind; names absent from a tree are skipped
SPLIT_LEAVES = ("water_fill", "uniform", "_priority", "_lstsq_svd",
                "sir_greedy", "ato_system", "ato_apply", "ato_system_lanes",
                "ato_apply_lanes", "smo_f_update")
SPLIT_CONTAINERS = ("_ato_ramp",)
#: torch functions filed under their own kind inside a container
SPLIT_KINDS = {"nonzero": "nonzero", "linalg_solve": "lu_solve",
               "solve": "lu_solve", "solve_ex": "lu_solve",
               "linalg_solve_ex": "lu_solve",
               "lu_factor_ex": "lu_solve", "lu_solve": "lu_solve",
               "__matmul__": "products", "matmul": "products",
               "mv": "products", "mm": "products"}


#: the least entries of a tensor whose index the split files as a gather
#: of K (``_SplitTimer``): a (|R|, n) slab of K or K itself, at n = 32,560
GATHER_MIN = 1 << 24


class _SplitTimer:
    """Times a seed's parts with a sync between parts (host clock).

    Wraps ``SPLIT_LEAVES`` and ``SPLIT_CONTAINERS`` in
    ``repro_torch.core.seeding`` (and ``init_f``); a ``TorchFunctionMode``
    times every torch op outside the leaves: inside a container by
    ``SPLIT_KINDS`` (else ``"<container>:ops"``), in the seeder's own body
    as ``"copy"`` (a CPU tensor moved to the card) or ``"seed:ops"``."""

    def __init__(self, seeding):
        self.seeding, self.parts, self.calls = seeding, {}, {}
        self.stack, self.saved = [], {}

    def add(self, label, dt):
        self.parts[label] = self.parts.get(label, 0.0) + dt
        self.calls.setdefault(label, []).append(dt)

    def wrap(self, name, leaf):
        fn = getattr(self.seeding, name)
        self.saved[name] = fn

        def timed(*a, **kw):
            sync()
            self.stack.append((name, leaf))
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                sync()
            finally:
                self.stack.pop()
            if leaf:
                self.add(name, time.perf_counter() - t0)
            else:
                self.add(name + ":calls", 0.0)
            return out
        setattr(self.seeding, name, timed)
        return timed

    def __enter__(self):
        from torch.overrides import TorchFunctionMode
        timer = self

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if timer.stack and timer.stack[-1][1]:
                    return func(*args, **kwargs)      # inside a leaf
                name = getattr(func, "__name__", str(func))
                if timer.stack:
                    kind = SPLIT_KINDS.get(name, "ops")
                    label = f"{timer.stack[-1][0]}:{kind}"
                elif name in ("to", "cuda", "copy_") and any(
                        isinstance(a, torch.Tensor) and a.device.type == "cpu"
                        for a in args):
                    label = "copy"
                elif name == "__getitem__" and isinstance(
                        args[0], torch.Tensor) \
                        and args[0].numel() >= GATHER_MIN:
                    label = "gather"   # rows or a block of K
                else:
                    label = "seed:ops"
                sync()
                t0 = time.perf_counter()
                out = func(*args, **kwargs)
                sync()
                timer.add(label, time.perf_counter() - t0)
                return out

        for name in SPLIT_LEAVES + SPLIT_CONTAINERS:
            if hasattr(self.seeding, name):
                self.wrap(name, name in SPLIT_LEAVES)
        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        for name, fn in self.saved.items():
            setattr(self.seeding, name, fn)


def _count_syncs(fn) -> int:
    """Host syncs that ``fn`` makes, by ``set_sync_debug_mode("warn")``."""
    import warnings
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            sync()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen)


def _seed_problem(name: str, n: int, h: int = 1, k: int = 10):
    """K, y, fold h-1's cold solution and the h-1 -> h index sets, of k
    folds."""
    from repro_torch.core.cv import _fold_masks, _transition_idx
    from repro_torch.data.svm_suite import kfold_chunks, make_dataset
    from repro_torch.svm import kernel_matrix, smo_solve
    dev = torch.device("cuda")
    ds = make_dataset(name, n_override=n)
    chunks = kfold_chunks(ds.n, k)
    m = chunks.size
    X = torch.as_tensor(ds.X[:m], device=dev)
    y = torch.as_tensor(ds.y[:m], dtype=torch.float64, device=dev)
    K = kernel_matrix(X, X, gamma=ds.gamma)
    masks = torch.as_tensor(_fold_masks(chunks), device=dev)
    prev = smo_solve(K, y, masks[h - 1], ds.C, torch.zeros_like(y), -y,
                     max_iter=5_000_000)
    return ds, K, y, prev, _transition_idx(chunks, h - 1, h, dev)


def _svd_drivers(seeding, run, reps: int = 5) -> dict:
    """MIR's SVD (of its bordered system, caught from one seed) on each
    CUDA driver: host ms after a sync, best of ``reps``."""
    seen = []
    fn = seeding._lstsq_svd
    seeding._lstsq_svd = lambda A, b: (seen.append(A), fn(A, b))[1]
    try:
        run()
    finally:
        seeding._lstsq_svd = fn
    A, out = seen[0], {"shape": list(seen[0].shape)}
    for driver in (None, "gesvd", "gesvdj", "gesvda"):
        best = math.inf
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            torch.linalg.svd(A, full_matrices=False, driver=driver)
            sync()
            best = min(best, time.perf_counter() - t0)
        out[driver or "default"] = 1e3 * best
    return out


def seed_split(cases=(("heart", 270), ("adult", 1000)),
               methods=("ato", "mir", "sir"), reps: int = 3) -> dict:
    """Each seeder on fold 0 -> 1, split into its parts: the wall time of
    the seed plus ``init_f`` (host clock after a sync, best of ``reps``),
    its host syncs, and one run with a sync between parts
    (``_SplitTimer``: ``water_fill`` each call, SIR's greedy pass and its
    draw and copy, MIR's SVD, ATO's ramp by kind of op, ``init_f``)."""
    from repro_torch.core import seeding
    from repro_torch.svm import init_f
    out = {}
    for name, n in cases:
        ds, K, y, prev, (S, R, T) = _seed_problem(name, n)
        for method in methods:
            seeder = seeding.SEEDERS[method]

            def run():
                a = seeder(K, y, ds.C, prev, S, R, T)
                return a, init_f(K, y, a)
            run()                                    # warm-up
            walls = []
            for _ in range(reps):
                sync()
                t0 = time.perf_counter()
                run()
                sync()
                walls.append(time.perf_counter() - t0)
            syncs = _count_syncs(run)
            with _SplitTimer(seeding) as timer:
                a = seeder(K, y, ds.C, prev, S, R, T)
                sync()
                t0 = time.perf_counter()
                init_f(K, y, a)
                sync()
                timer.add("init_f", time.perf_counter() - t0)
            out[f"{name}/{method}"] = {
                "wall_s": min(walls), "walls_s": walls, "syncs": syncs,
                "parts_s": timer.parts,
                "calls": {k: len(v) for k, v in timer.calls.items()},
                "water_fill_calls_s": timer.calls.get("water_fill", [])}
            if method == "mir":
                out[f"{name}/{method}"]["svd_ms"] = _svd_drivers(
                    seeding, lambda: seeder(K, y, ds.C, prev, S, R, T))
        del K
        torch.cuda.empty_cache()
    return out


def grid_seed_split(reps: int = 3) -> dict:
    """One SIR seed of ``grid_size`` (adult n = 32,560, k = GRID_K, the
    paper's (C, gamma), fold 0 -> 1 from fold 0's cold solution): its wall
    time (host clock after a sync, best of ``reps``), one run split by
    ``_SplitTimer`` into the gather of K (none where the greedy pass reads
    K through the index sets), the greedy pass, ``water_fill`` (each
    call) and the rest, and the seed's peak memory on the card above what
    was allocated before it."""
    from repro_torch.core import seeding
    ds, K, y, prev, (S, R, T) = _seed_problem("adult", SIZE_N, 1, GRID_K)

    def run():
        return seeding.sir_seed(K, y, ds.C, prev, S, R, T)
    run()                                               # warm-up
    walls = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        walls.append(time.perf_counter() - t0)
    with _SplitTimer(seeding) as timer:
        run()
    parts = timer.parts
    named = {"gather_s": parts.get("gather", 0.0),
             "greedy_s": parts.get("sir_greedy", 0.0),
             "water_fill_s": parts.get("water_fill", 0.0)}
    named["rest_s"] = sum(parts.values()) - sum(named.values())
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run()
    sync()
    peak = torch.cuda.max_memory_allocated() - base
    out = {"n": K.shape[0], "m": R.shape[0], "t": T.shape[0],
           "wall_s": min(walls), "walls_s": walls, **named,
           "parts_s": parts,
           "calls": {key: len(v) for key, v in timer.calls.items()},
           "water_fill_calls_s": timer.calls.get("water_fill", []),
           "peak_bytes": peak}
    del K, prev
    torch.cuda.empty_cache()
    return out


def phase_grid_seed_split() -> dict:
    t0 = time.perf_counter()
    rec = grid_seed_split()
    emit({"phase": "grid_seed_split", "seconds": time.perf_counter() - t0,
          **rec})
    return rec


def size_sir_init(ds, n_sir_folds: int = 2) -> list:
    """``phase_size``'s SIR seeds alone (adult at n=32,560): cold fold 0,
    then each SIR seed plus ``init_f`` timed (host clock after a sync)."""
    from repro_torch.core.cv import _fold_masks, _transition_idx
    from repro_torch.core.seeding import sir_seed
    from repro_torch.data.svm_suite import kfold_chunks
    from repro_torch.svm import init_f, kernel_matrix, smo_solve
    dev = torch.device("cuda")
    chunks = kfold_chunks(ds.n, 10)
    n = chunks.size
    X = torch.as_tensor(ds.X[:n], device=dev)
    y = torch.as_tensor(ds.y[:n], dtype=torch.float64, device=dev)
    K = kernel_matrix(X, X, gamma=ds.gamma)
    masks = torch.as_tensor(_fold_masks(chunks), device=dev)
    prev = smo_solve(K, y, masks[0], ds.C, torch.zeros_like(y), -y,
                     max_iter=5_000_000)
    inits = []
    for h in range(1, 1 + n_sir_folds):
        S, R, T = _transition_idx(chunks, h - 1, h, dev)
        sync()
        t0 = time.perf_counter()
        alpha0 = sir_seed(K, y, ds.C, prev, S, R, T)
        f0 = init_f(K, y, alpha0)
        sync()
        inits.append(time.perf_counter() - t0)
        prev = smo_solve(K, y, masks[h], ds.C, alpha0, f0,
                         max_iter=5_000_000)
    del K
    torch.cuda.empty_cache()
    return inits


def phase_seed_split(size_ds=None):
    """The seeding split (``seed_split``) and, given adult at n=32,560,
    ``phase_size``'s SIR seeds timed alone."""
    t0 = time.perf_counter()
    rec = {"phase": "seed_split", "split": seed_split()}
    if size_ds is not None:
        rec["size_sir_init_s"] = size_sir_init(size_ds)
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return rec


def phase_size(ds, n_sir_folds: int = 2):
    """Adult at the paper's cardinality: K by the RBF kernel (checked on a
    slab of rows), cold fold 0, then SIR-seeded folds, each with the route
    its chunk took and its time per iteration. Returns the folds' rows."""
    from repro_torch.core.cv import _eval_fold, _fold_masks, _transition_idx
    from repro_torch.core.seeding import sir_seed
    from repro_torch.data.svm_suite import kfold_chunks
    from repro_torch.kernels import ops, ref
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
        before = ops.route_counts()["smo_chunk"]
        res = smo_solve(K, y, masks[h], ds.C, alpha0, f0, max_iter=5_000_000)
        it = int(res.n_iter)
        t2 = time.perf_counter()
        route = _route_taken(before, ops.route_counts()["smo_chunk"])
        correct, total, obj = _eval_fold(K, y, chunks, h, res, ds.C)
        require(bool(res.converged) and math.isfinite(obj),
                f"size fold {h}: converged={bool(res.converged)} obj={obj}")
        folds.append({"fold": h, "seed": "cold" if prev is None else "sir",
                      "route": route, "n_iter": it, "correct": correct,
                      "init_s": t1 - ts,
                      "solve_s": t2 - t1,
                      "us_per_iter": 1e6 * (t2 - t1) / max(it, 1),
                      "accuracy": correct / total, "objective": obj})
        prev = res
    emit({"phase": "size", "seconds": time.perf_counter() - t0, "n": n,
          "d": int(X.shape[1]), "K_gb": K.numel() * 8 / 1e9,
          "kernel_s": kernel_s, "slab_max_abs_err": slab_err,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "folds": folds})
    return folds


def phase_size_wide(ds):
    """Dense cold CV at the paper's cardinality in WIDE_DENSE_K folds at
    once (``run_cv_batched``, the fixed-width batch): more lanes than the
    multi-block plan places, so every chunk takes the cluster route. Every
    fold converges with a finite objective, and fold 0 solved alone (one
    lane: the multi-block route) takes the same iterations and classifies
    its test rows the same. Then, on this path's shape (all WIDE_DENSE_K
    fold masks as lanes from the cold state, capped at 300 iterations, as
    ``_chunk_checks`` caps n=32,560), the cluster kernel and the
    global-state kernel, forced, every lane of each bitwise the plain step
    engine's from the same state, each timed: the kernels line's entries
    for the two; and every cluster shape the card places for those lanes,
    bitwise and timed beside the plan's. Resets the launch counts and reads them around the
    batched run itself: the checks that follow launch the chunk too.
    Returns the counts, the routes and the two entries."""
    from repro_torch.core.cv import _eval_fold, _fold_masks, run_cv_batched
    from repro_torch.data.svm_suite import kfold_chunks
    from repro_torch.kernels import ops, ref
    from repro_torch.svm import kernel_matrix, smo_solve
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    sync()
    tw = time.perf_counter()
    rep = run_cv_batched(ds, k=WIDE_DENSE_K, schedule="batched")
    wall = time.perf_counter() - tw
    counts, routes = ops.launch_counts(), ops.route_counts()
    chunk = routes["smo_chunk"]
    require(all(f.converged and math.isfinite(f.objective)
                for f in rep.folds), "size_wide: a fold did not converge")
    require(chunk["cluster"] > 0 and chunk["one_block_global"] == 0
            and chunk["multi_block"] == 0 and chunk["one_block"] == 0,
            f"size_wide: the dense chunk's routes {chunk}")
    # fold 0 alone, on the multi-block route
    dev = torch.device("cuda")
    chunks = kfold_chunks(ds.n, WIDE_DENSE_K)
    n = chunks.size
    X = torch.as_tensor(ds.X[:n], device=dev)
    y = torch.as_tensor(ds.y[:n], dtype=torch.float64, device=dev)
    K = kernel_matrix(X, X, gamma=ds.gamma)
    mask = torch.as_tensor(_fold_masks(chunks)[0], device=dev)
    res = smo_solve(K, y, mask, ds.C, torch.zeros(n, dtype=torch.float64,
                                                  device=dev), -y,
                    max_iter=5_000_000)
    correct, total, _ = _eval_fold(K, y, chunks, 0, res, ds.C)
    f0 = rep.folds[0]
    require((int(res.n_iter), correct, total)
            == (f0.n_iter, f0.acc_correct, f0.acc_total),
            f"size_wide fold 0: {f0.n_iter} iterations, {f0.acc_correct}/"
            f"{f0.acc_total} in the batch; alone {int(res.n_iter)}, "
            f"{correct}/{total}")
    # the cluster and global-state kernels at this path's shape against the
    # plain step engine (its f-update through the smo_f_update kernel),
    # lane by lane
    masks = torch.as_tensor(_fold_masks(chunks), device=dev)
    b, cap = masks.shape[0], 300
    diag = torch.diagonal(K).contiguous()
    state = (torch.zeros((b, n), dtype=torch.float64, device=dev),
             -y.repeat(b, 1), torch.zeros(b, dtype=torch.int64, device=dev),
             torch.zeros(b, dtype=torch.bool, device=dev))
    lanes = (K, diag, y, masks, [ds.C] * b, 1e-3, [cap] * b, cap + 1, "2",
             *state)
    sync()
    t = time.perf_counter()
    plain = [ref.smo_chunk_ref(K, diag, y, masks[l], ds.C, 1e-3, cap,
                               cap + 1, "2", *(v[l] for v in state),
                               update_f=ops.smo_f_update) for l in range(b)]
    sync()
    plain_s = time.perf_counter() - t
    entries = {}
    for route in ("cluster", "one_block_global"):
        got = ops.smo_chunk_lanes(*lanes, _route=route)
        sync()
        for l, want in enumerate(plain):
            for a, w, what in zip(got, want, ("alpha", "f", "n_iter",
                                              "done")):
                require(torch.equal(a[l], w), f"size_wide lane {l}: the "
                        f"{route} kernel's {what} differs from the plain "
                        "step engine")
        require(bool(got[3].all()) and int(got[2].min()) == cap,
                f"size_wide: a capped lane did not stop at its cap ({route})")
        ms = cuda_ms(lambda: ops.smo_chunk_lanes(*lanes, _route=route), 3)
        it = int(got[2].max())
        entries[route] = {
            "n": n, "lanes": b, "n_iter": it, "max_abs_err": max(
                float((got[k][l] - plain[l][k]).abs().max()) for k in (0, 1)
                for l in range(b)), "ms": ms / it,
            "plain_ms": 1e3 * plain_s / it,
            f"us_per_iter_{route}": 1e3 * ms / it,
            **_bound(b * _chunk_iter_bytes(n, it), 0.0)}
        if route == "cluster":
            cluster_out = got
        del got
    entries["cluster"]["us_per_iter_one_block_global"] = (
        entries["one_block_global"]["us_per_iter_one_block_global"])
    # every cluster shape the card places for these lanes, beside the plan's
    plan = entries["cluster"]["plan"] = _plans(n, b)[1]
    entries["cluster"].update(_cluster_shapes(
        n, b, plan, cluster_out, cap, lambda shape: ops.smo_chunk_lanes(
            *lanes, _route="cluster", _cluster=shape)))
    del K, diag, plain, lanes, state, cluster_out
    torch.cuda.empty_cache()
    lane_max = max(f.n_iter for f in rep.folds)
    emit({"phase": "size_wide", "seconds": time.perf_counter() - t0,
          "n": rep.n, "k": WIDE_DENSE_K, "method": rep.method,
          "iterations": rep.total_iterations,
          "per_fold_iterations": [f.n_iter for f in rep.folds],
          "solve_s": rep.total_solve_time, "wall_s": wall,
          "us_per_longest_lane_iteration":
              1e6 * rep.total_solve_time / max(lane_max, 1),
          "accuracy": rep.accuracy, "chunk_routes": chunk,
          "capped_checks": entries})
    return counts, routes, entries


def _bound(nbytes: float, flops: float, peak: float = FP64_FLOPS) -> dict:
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _time_fused(X, b: int, gamma: float, rng) -> dict:
    """fused_smo_step over X with b lanes of random pairs: the kernel alone
    (its C entry over one f, in place, as the chunks run it) by events and
    in a CUDA graph, the wrapper (which also copies f) both ways, the
    plain version, one library expression, its bound and FLOP floor; and
    whether the FMA-path build gives the kernel's output bitwise."""
    from repro_torch.kernels import _build, ops, ref
    n, d = X.shape
    sq = torch.sum(X * X, -1)
    xij = X[torch.as_tensor(rng.integers(0, n, size=(b, 2)), device=X.device)]
    f = torch.as_tensor(rng.normal(size=(b, n)), device=X.device)
    delta = torch.full((b,), 0.37, dtype=torch.float64, device=X.device)
    types = (*(ctypes.c_void_p,) * 6, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_double, ctypes.c_void_p)

    def alone(lib, out):
        fn = _build.entry(lib, "fused_smo_step_f64", *types)
        return lambda: _build.check(
            fn(out.data_ptr(), X.data_ptr(), sq.data_ptr(), xij.data_ptr(),
               delta.data_ptr(), None, n, d, b, float(gamma),
               _build.stream_ptr(out)), "fused_smo_step")
    f_tc, f_fma = f.clone(), f.clone()
    alone("smo_step", f_tc)()
    alone("smo_step_fma", f_fma)()
    fma_bitwise = torch.equal(f_tc, f_fma)
    kernel_alone = alone("smo_step", f.clone())
    wrapper = lambda: ops.fused_smo_step(f, X, xij, sq, delta,  # noqa: E731
                                         gamma)

    def library():
        P = xij.reshape(2 * b, d)
        d2 = torch.addmm(sq[:, None] + torch.sum(P * P, -1)[None], X, P.T,
                         alpha=-2.0)
        K2 = d2.clamp_(min=0.0).mul_(-gamma).exp_()
        return torch.addcmul(f, (K2[:, 0::2] - K2[:, 1::2]).T, delta[:, None])
    flops = 4.0 * b * n * d
    return dict(
        shape=[n, d, b], ms=graph_ms(kernel_alone, 50),
        ms_kernel=cuda_ms(kernel_alone, 50, 3), ms_wrapper=cuda_ms(wrapper,
                                                                   50, 3),
        ms_wrapper_graph=graph_ms(wrapper, 50),
        plain_ms=cuda_ms(lambda: ref.fused_smo_step_ref(f, X, xij, sq, delta,
                                                        gamma), 10),
        library_ms=cuda_ms(library, 50, 3),
        library_max_abs_diff=float((library() - wrapper()).abs().max()),
        fma_bitwise=fma_bitwise,
        # X's rows stay in the 50 MB L2 between graph launches, so the
        # FLOP floor at the FP64 tensor rate sits beside the HBM bound
        flop_floor_ms=1e3 * flops / FP64_FLOPS,
        **_bound(8.0 * (n * d + n + 2 * b * n + 2 * b * d + b), flops))


def _time_select(args) -> dict:
    """The selection kernel's time at ``args`` (``smo_select``'s), each over
    a CUDA graph of 50 calls, and its bounds. ``ms``: its C entry as the
    pair route calls it (``clip_all`` 0) from a mid-solve state (the lanes
    after 100 pair-route iterations from ``args``' cold state). Only the
    first launch sees a state the route gives (the others find alpha moved
    and f not, the same work), so beside it ``iteration_ms`` times the
    route's iteration as it runs: the selection and ``fused_smo_step``'s C
    entry, from the same state. ``ms_cold``: the cold first step
    (``clip_all`` 1, a chunk's first iteration); ``ms_wrapper``: the
    wrapper there (which also copies the state). ``bound_ms`` holds ``ms``:
    alpha, f and mask read once, y shared, the pair rows read and written,
    two alphas written a lane; ``bound_ms_cold`` the cold step's, which
    writes the whole of alpha. On the mid-solve state, where alpha lies in
    its box, the kernel must give the same bits with either clip."""
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.smo_chunk import seq_norms
    X, sq, gamma, y, masks, Cs, tol, caps, alphas, fs, n_iter, done = args
    (b, n), d = masks.shape, X.shape[1]
    sn = seq_norms(X)
    mid = ops.smo_stream_chunk(X, sq, gamma, y, masks, Cs, tol, caps, 100,
                               alphas, fs, n_iter, done, X_norms=sn,
                               _route="pair")
    fn = _build.entry("smo_step", "smo_select_f64", *(ctypes.c_void_p,) * 6,
                      ctypes.c_double, ctypes.c_void_p, ctypes.c_double,
                      *(ctypes.c_void_p,) * 6, *(ctypes.c_int,) * 4,
                      ctypes.c_void_p)
    fused = _build.entry("smo_step", "fused_smo_step_f64",
                         *(ctypes.c_void_p,) * 6, *(ctypes.c_int,) * 3,
                         ctypes.c_double, ctypes.c_void_p)
    xij = torch.zeros((b, 2, d), dtype=torch.float64, device=X.device)
    delta = torch.zeros(b, dtype=torch.float64, device=X.device)

    def launch(state, clip):
        a, f, it, dn = state
        return lambda: _build.check(fn(
            X.data_ptr(), sq.data_ptr(), sn.data_ptr(), y.data_ptr(),
            masks.data_ptr(), Cs.data_ptr(), float(tol), caps.data_ptr(),
            float(gamma), a.data_ptr(), f.data_ptr(), it.data_ptr(),
            dn.data_ptr(), xij.data_ptr(), delta.data_ptr(), n, d, b, clip,
            _build.stream_ptr(X)), "smo_select")

    def iteration(state):
        select = launch(state, 0)
        return lambda: (select(), _build.check(fused(
            state[1].data_ptr(), X.data_ptr(), sq.data_ptr(), xij.data_ptr(),
            delta.data_ptr(), state[3].data_ptr(), n, d, b, float(gamma),
            _build.stream_ptr(X)), "fused_smo_step"))
    one = [tuple(t.clone() for t in mid) for _ in range(2)]
    launch(one[0], 0)()
    launch(one[1], 1)()
    require(all(torch.equal(u, v) for u, v in zip(*one)),
            "smo_select: clip_all 0 and 1 differ on a mid-solve state")
    flops = 10.0 * b * n
    cold = _bound(8.0 * (3 * b * n + n + 4 * b * d) + b * n, flops)
    return {"ms": graph_ms(launch(tuple(t.clone() for t in mid), 0), 50),
            "iteration_ms": graph_ms(
                iteration(tuple(t.clone() for t in mid)), 50),
            "ms_cold": graph_ms(launch((alphas.clone(), fs, n_iter.clone(),
                                        done.clone()), 1), 50),
            "ms_wrapper": graph_ms(lambda: ops.smo_select(*args, X_norms=sn),
                                   50),
            "mid_iterations": int(mid[2].max()),
            **_bound(8.0 * (2 * b * n + n + 4 * b * d + 2 * b) + b * n,
                     flops),
            "bound_ms_cold": cold["bound_ms"]}


def phase_fused(datasets):
    """fused_smo_step and the WSS-1 selection kernel against their plain
    versions at the reference's ragged shapes and the main path's, at one
    lane, ten and twenty; then their times, plain times, bounds and
    yardstick, and the fused kernel against its FMA-path build."""
    from repro_torch.core.cv import _fold_masks
    from repro_torch.data.svm_suite import kfold_chunks
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.smo_chunk import seq_norms
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    cases = [(f"{n}x{d}", rng.normal(size=(n, d)), 0.5)
             for n, d in ((257, 9), (100, 130), (120, 40))]
    for (name, m), ds in datasets.items():
        cases.append((f"{name} {m}x{ds.X.shape[1]}", ds.X[:m], ds.gamma))
    # The reference's bars hold on its problem (tests/test_kernels.py::
    # _step_problem): pair rows (3, n-1), delta 0.37. In f64 the other lanes
    # take random pairs. In f32 a pair's own row cancels d2 to 0 from terms
    # of |x|^2 ~ d, which costs delta * gamma * a few ulp(2 |x|^2) in any
    # summation order (1.1e-5 at 100x130), so there every lane takes the
    # reference's pair and its own f; random f32 pairs are held instead to
    # the plain f32 version's own error against f64 (at most twice it).
    checks = []
    for label, X, gamma in cases:
        n = X.shape[0]
        X64 = torch.as_tensor(X, dtype=torch.float64, device=dev)
        for dtype, atol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            Xt = X64.to(dtype)
            sq = torch.sum(Xt * Xt, -1)
            for b in (1, 10, WIDE_K):
                pairs = rng.integers(0, n, size=(b, 2))
                pairs[0] = (3, n - 1)
                if dtype == torch.float32:
                    pairs[:] = (3, n - 1)
                xij = Xt[torch.as_tensor(pairs, device=dev)]
                f = torch.as_tensor(rng.normal(size=(b, n)), dtype=dtype,
                                    device=dev)
                delta = torch.full((b,), 0.37, dtype=dtype, device=dev)
                got = ops.fused_smo_step(f, Xt, xij, sq, delta, gamma)
                want = ref.fused_smo_step_ref(f, Xt, xij, sq, delta, gamma)
                err = float((got - want).abs().max())
                require(math.isfinite(err) and err <= atol,
                        f"fused_smo_step {label} {dtype} b={b}: err {err}")
                one = ops.fused_smo_step(f[0], Xt, xij[0], sq, 0.37, gamma)
                require(torch.equal(one, got[0]),
                        f"fused_smo_step {label} {dtype} b={b}: lane 0 "
                        "differs from the one-lane launch")
                if b == WIDE_K and dtype == torch.float64:
                    # the pair route's late launches: 17 of 20 lanes live
                    done = torch.zeros(b, dtype=torch.bool, device=dev)
                    done[-3:] = True
                    got = ops.fused_smo_step(f, Xt, xij, sq, delta, gamma,
                                             done=done)
                    want = ref.fused_smo_step_ref(f, Xt, xij, sq, delta,
                                                  gamma, done)
                    err = max(err, float((got - want).abs().max()))
                    require(err <= atol and torch.equal(got[-3:], f[-3:]),
                            f"fused_smo_step {label} b={b}, 3 lanes done: "
                            f"err {err}")
                checks.append({"shape": label, "dtype": str(dtype), "b": b,
                               "max_abs_err": err})
        # f32 with random pairs against f64 truth, beside the plain f32
        pairs = torch.as_tensor(rng.integers(0, n, size=(10, 2)), device=dev)
        f = torch.as_tensor(rng.normal(size=(10, n)), device=dev)
        delta = torch.full((10,), 0.37, dtype=torch.float64, device=dev)
        truth = ref.fused_smo_step_ref(f, X64, X64[pairs],
                                       torch.sum(X64 * X64, -1), delta, gamma)
        X32 = X64.float()
        sq32 = torch.sum(X32 * X32, -1)
        args32 = (f.float(), X32, X32[pairs], sq32, delta.float(), gamma)
        k_err = float((ops.fused_smo_step(*args32).double() - truth)
                      .abs().max())
        p_err = float((ref.fused_smo_step_ref(*args32).double() - truth)
                      .abs().max())
        require(k_err <= 2.0 * p_err + 1e-6,
                f"fused_smo_step {label} f32 random pairs: err vs f64 "
                f"{k_err}, the plain f32's {p_err}")
        checks.append({"shape": label, "dtype": "torch.float32", "b": 10,
                       "random_pairs_err_vs_f64": k_err,
                       "plain_err_vs_f64": p_err})

    # ---- times: at the main path's shape (adult n=1000 in 20 folds, the
    # pair route's 20 packed lanes) for the kernels line, and at the paper's
    # cardinality (32,560 x 123, ten lanes) beside it. The fused kernel is
    # also held bitwise, at both shapes, to its build with the float64 dot
    # products on the FMA pipes (an ordered fma chain): the witness that
    # the FP64 tensor cores round the same.
    small = datasets[("adult", 1000)]
    big = datasets[("adult", SIZE_N - 1)]
    fused = _time_fused(torch.as_tensor(small.X, device=dev), WIDE_K,
                        small.gamma, rng)
    at_big = _time_fused(torch.as_tensor(big.X[:SIZE_N - 1], device=dev), 10,
                         big.gamma, rng)
    fused["witness_fma_bitwise"] = [fused.pop("fma_bitwise"),
                                    at_big.pop("fma_bitwise")]
    require(all(fused["witness_fma_bitwise"]),
            "fused_smo_step: the FP64 tensor-core build differs from the "
            "FMA-path build")
    fused.update({f"{k}_{SIZE_N - 1}x10": v for k, v in at_big.items()})
    fused["max_abs_err"] = max(c["max_abs_err"] for c in checks
                               if c["dtype"] == "torch.float64")
    fused["max_abs_err_f32"] = max(c.get("max_abs_err", 0.0) for c in checks
                                   if c["dtype"] == "torch.float32")
    Xs = torch.as_tensor(small.X, device=dev)
    sqs = torch.sum(Xs * Xs, -1)
    xs1 = Xs[[3, 999]]
    fs1 = torch.as_tensor(rng.normal(size=1000), device=dev)
    d1 = torch.tensor([0.37], dtype=torch.float64, device=dev)
    fused["ms_graph_n1000_b1"] = graph_ms(
        lambda: ops.fused_smo_step(fs1, Xs, xs1, sqs, d1, small.gamma), 200)
    fused["plain_ms_graph_n1000_b1"] = graph_ms(
        lambda: ref.fused_smo_step_ref(fs1, Xs, xs1, sqs, d1, small.gamma),
        200)

    # ---- the selection kernel: the cold folds' first step, against its
    # plain version on the card, at each main-path size in ten folds and at
    # adult n=1000 in 20 (the pair route's lanes); timed at the latter and
    # at n=32,560
    sel_checks, select = [], None
    cases = [(name, ds, m, 10) for (name, m), ds in datasets.items()]
    cases.append(("adult", small, kfold_chunks(small.n, WIDE_K).size, WIDE_K))
    for name, ds, m, k in cases:
        chunks = kfold_chunks(ds.n, k)
        Xc = torch.as_tensor(ds.X[:m], device=dev)
        yc = torch.as_tensor(ds.y[:m], dtype=torch.float64, device=dev)
        sqc = torch.sum(Xc * Xc, -1)
        masks = torch.as_tensor(_fold_masks(chunks), device=dev)
        # C and the caps as device tensors: no host copy inside a graph
        args = (Xc, sqc, ds.gamma, yc, masks,
                torch.full((k,), ds.C, dtype=torch.float64, device=dev),
                1e-3, torch.full((k,), 10 ** 6, device=dev),
                torch.zeros((k, m), dtype=torch.float64, device=dev),
                -yc.repeat(k, 1), torch.zeros(k, dtype=torch.int64,
                                              device=dev),
                torch.zeros(k, dtype=torch.bool, device=dev))
        got = ops.smo_select(*args, X_norms=seq_norms(Xc))
        want = ref.smo_select_lanes_ref(*args)
        for i, what in ((1, "n_iter"), (2, "done"), (3, "pair rows")):
            require(torch.equal(got[i], want[i]),
                    f"smo_select {name} n={m} b={k}: {what} differ")
        err = max(float((got[i] - want[i]).abs().max()) for i in (0, 4))
        require(err <= 1e-12, f"smo_select {name} n={m} b={k}: err {err}")
        rec = {"n": m, "b": k, "max_abs_err": err}
        if m == SIZE_N - 1 or k == WIDE_K:
            rec.update(_time_select(args))
            sync()
            tp = time.perf_counter()
            ref.smo_select_lanes_ref(*args)
            sync()
            rec["plain_ms"] = 1e3 * (time.perf_counter() - tp)
        if k == WIDE_K:
            select = dict(rec)
        sel_checks.append(rec)
    big_sel = next(c for c in sel_checks if c["n"] == SIZE_N - 1)
    select.update({f"{k}_{SIZE_N - 1}x10": big_sel[k]
                   for k in ("ms", "iteration_ms", "ms_cold", "ms_wrapper",
                             "plain_ms", "bound_ms", "bound_ms_cold")})
    select["max_abs_err"] = max(c["max_abs_err"] for c in sel_checks)
    emit({"phase": "kernels_fused", "seconds": time.perf_counter() - t0,
          "fused_checks": checks, "fused_smo_step": fused,
          "smo_select": sel_checks})
    return {"fused_smo_step": fused, "smo_select": select}


def _lane_masks(ds, k: int = 10):
    from repro_torch.core.cv import _fold_masks
    from repro_torch.data.svm_suite import kfold_chunks
    chunks = kfold_chunks(ds.n, k)
    return chunks.size, _fold_masks(chunks)


def phase_lane_chunks(datasets):
    """The chunks over lanes. Dense: each of 4 cold folds through the lane
    grid is bitwise (alpha, f, n_iter, done) the one-lane launch.
    Streaming: each cold fold is bitwise the same alone, packed at width 4
    and at width 12 (10 folds + 2 pads), on its route (``stream_route``'s)
    and at width 12 on the pair route too, and within 1e-10 of the plain loop on
    the card after 200 iterations. heart and adult n=1000 run to
    convergence; n=32,560 stops at it_cap=300."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.smo_chunk import seq_norms
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    dense, stream = [], []
    for (name, _), ds in datasets.items():
        n, masks = _lane_masks(ds)
        cap = 300 if n > 10_000 else 5_000_000
        X = torch.as_tensor(ds.X[:n], device=dev)
        y = torch.as_tensor(ds.y[:n], dtype=torch.float64, device=dev)
        masks = torch.as_tensor(masks, device=dev)

        def cold(lanes):
            return (torch.zeros((lanes, n), dtype=torch.float64, device=dev),
                    -y.repeat(lanes, 1),
                    torch.zeros(lanes, dtype=torch.int64, device=dev),
                    torch.zeros(lanes, dtype=torch.bool, device=dev))

        # ---- dense lane grid vs the one-lane launch
        K = ops.rbf_kernel_matrix(X, X, ds.gamma)
        diag = torch.diagonal(K).contiguous()
        grid = (K, diag, y, masks[:4], [ds.C] * 4, 1e-3, [cap] * 4, cap + 1,
                "2", *cold(4))
        got = ops.smo_chunk_lanes(*grid)
        for l in range(4):
            one = ops.smo_chunk(K, diag, y, masks[l], ds.C, 1e-3, cap,
                                cap + 1, "2", *(t[0] for t in cold(1)))
            for a, c, what in zip(one, got, ("alpha", "f", "n_iter",
                                             "done")):
                require(torch.equal(a, c[l]), f"lane grid {name} n={n} "
                                              f"lane {l}: {what} differs")
        ms = cuda_ms(lambda: ops.smo_chunk_lanes(*grid), 3)
        it = int(got[2].max())
        dense.append({"n": n, "lanes": 4, "n_iter": got[2].tolist(),
                      "ms": ms, "us_per_iter": 1e3 * ms / it})
        del K, diag
        torch.cuda.empty_cache()

        # ---- streaming chunk: width invariance
        sq, sn = torch.sum(X * X, -1), seq_norms(X)

        def run(ids, width, it_cap=cap, route=None):
            ids = list(ids)
            st = [t[ids] for t in cold(10)]
            m, C, caps = masks[ids], [ds.C] * len(ids), [it_cap] * len(ids)
            pad = width - len(ids)
            if pad:
                st = [torch.cat([t, t[:1].expand(pad, *t.shape[1:])])
                      for t in st]
                st[3][len(ids):] = True
                m = torch.cat([m, m[:1].expand(pad, n)])
                C, caps = C + [ds.C] * pad, caps + [0] * pad
            t = time.perf_counter()
            l0 = ops.launch_counts()["fused_smo_step"]
            while True:
                st = ops.smo_stream_chunk(X, sq, ds.gamma, y, m, C, 1e-3,
                                          caps, min(4096, it_cap + 1), *st,
                                          X_norms=sn, _route=route)
                if bool(st[3].all()):
                    break
            sync()
            secs = time.perf_counter() - t
            # the pair route stops within 128 iterations of the last lane's
            # stop (the one-launch routes, on the device, at it)
            issued = ops.launch_counts()["fused_smo_step"] - l0
            require(issued <= int(st[2].max()) + 128,
                    f"stream chunk {name} n={n}: {issued} iterations "
                    f"launched for {int(st[2].max())}")
            return [u[:len(ids)] for u in st], secs, issued

        alone = [run([l], 1)[0] for l in range(10)]
        w4, _, _ = run(range(4), 4)
        w12, w12_s, _ = run(range(10), 12)
        w12_pair, w12_pair_s, w12_issued = run(range(10), 12, route="pair")
        for l in range(10):
            for packed, width in ((w4, 4), (w12, 12), (w12_pair, 12)):
                if l >= packed[0].shape[0]:
                    continue
                for a, c, what in zip(alone[l], packed, ("alpha", "f",
                                                         "n_iter", "done")):
                    require(torch.equal(a[0], c[l]),
                            f"stream chunk {name} n={n} lane {l}: {what} "
                            f"alone differs from width {width}")
        its = [int(a[2][0]) for a in alone]
        # ---- against the plain loop on the card, 200 iterations
        got200, _, _ = run([0], 1, it_cap=200)
        plain = ref.smo_chunk_ref(
            None, torch.ones(n, dtype=torch.float64, device=dev), y,
            masks[0], ds.C, 1e-3, 200, 201, "1", *(t[0] for t in cold(1)),
            stream=(X, sq, ds.gamma))
        require(int(got200[2][0]) == int(plain[2]) == 200,
                f"stream chunk {name} n={n}: capped run not at 200")
        err = max(float((got200[k][0] - plain[k]).abs().max())
                  for k in (0, 1))
        require(err <= 1e-10, f"stream chunk {name} n={n}: err {err} vs "
                              "the plain loop")
        stream.append({"n": n, "it_cap": cap, "n_iter": its,
                       "width12_s": w12_s, "width12_pair_s": w12_pair_s,
                       "width12_pair_launched": w12_issued,
                       "us_per_iter_width12": 1e6 * w12_s / max(its),
                       "us_per_iter_width12_pair":
                           1e6 * w12_pair_s / max(its),
                       "max_abs_err_vs_plain_200": err})
        del X, sq
        torch.cuda.empty_cache()
    emit({"phase": "lane_chunks", "seconds": time.perf_counter() - t0,
          "dense_lane_grid": dense, "streaming": stream})


def _stream_lanes(X, y, b, dev):
    """b cold lanes over X's n rows (a streaming source), lane l holding
    out tenth l mod 10: (masks, state)."""
    n = X.shape[0]
    masks = torch.ones((b, n), dtype=torch.bool, device=dev)
    for l in range(b):
        masks[l, (l % 10) * (n // 10):(l % 10 + 1) * (n // 10)] = False
    state = (torch.zeros((b, n), dtype=torch.float64, device=dev),
             -y.repeat(b, 1), torch.zeros(b, dtype=torch.int64, device=dev),
             torch.zeros(b, dtype=torch.bool, device=dev))
    return masks, state


def _stream_widest(n: int, d: int, route: str) -> int:
    """The most lanes (at most 16) that a one-launch streaming route places
    over n rows of d features on this card."""
    from repro_torch.kernels.smo_chunk import (stream_cluster_capacity,
                                               stream_cluster_plan,
                                               stream_plan)
    widest = 0
    for b in range(1, 17):
        placed = (stream_plan(n, d, b)[0] >= 1 if route == "persistent"
                  else stream_cluster_plan(
                      n, b, stream_cluster_capacity(d, b)) is not None)
        if placed:
            widest = b
    return widest


def phase_stream_routes(datasets):
    """The streaming chunk's three routes side by side. Checks: ten cold
    folds at heart (n=270) and adult n=1000 (to convergence) and adult
    n=32,560 (capped at 300) are bitwise equal on the cluster, persistent
    and pair routes (alpha, f, n_iter, done), each timed per longest-lane
    iteration (the routes in turn, each its best round); at n=32,560 one
    lane against the plain loop after 200 iterations. Sweep: adult's first
    n rows x lanes (1, 4, 10, the widest each one-launch plan places and one
    more), 200 capped iterations on each route that places them, bitwise:
    the route ``stream_route`` takes, required to be within
    CHUNK_ROUTE_MARGIN of the fastest (``smo_chunk.STREAM_US`` is fitted to
    this sweep)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.smo_chunk import (pad_rows, seq_norms,
                                               stream_cluster_capacity,
                                               stream_cluster_layout,
                                               stream_cluster_plan,
                                               stream_plan, stream_route)
    t0 = time.perf_counter()
    dev = torch.device("cuda")

    def placed(n, d, b):
        """The routes that place b lanes over n x d, and stream_route's."""
        m = stream_plan(n, d, b)[0]
        cplan = stream_cluster_plan(n, b, stream_cluster_capacity(d, b))
        routes = (("cluster",) * (cplan is not None)
                  + ("persistent",) * (m >= 1) + ("pair",))
        return routes, stream_route(n, d, b, m, cplan), m, cplan

    def compare(args, kw, routes, what):
        """Each route's result bitwise the first's; {route: result}."""
        outs = {r: ops.smo_stream_chunk(*args, **kw, _route=r)
                for r in routes}
        first = outs[routes[0]]
        for r in routes[1:]:
            for a, c, part in zip(first, outs[r], ("alpha", "f", "n_iter",
                                                   "done")):
                require(torch.equal(a, c), f"stream chunk {what}: the "
                        f"{r} route's {part} differs from {routes[0]}'s")
        return outs

    checks, info = [], {}
    for (name, _), ds in datasets.items():
        n, masks = _lane_masks(ds)
        cap = 300 if n > 10_000 else 5_000_000
        X = torch.as_tensor(ds.X[:n], device=dev)
        y = torch.as_tensor(ds.y[:n], dtype=torch.float64, device=dev)
        sq, sn = torch.sum(X * X, -1), seq_norms(X)
        masks = torch.as_tensor(masks, device=dev)
        d = X.shape[1]
        state = _stream_lanes(X, y, 10, dev)[1]
        args = (X, sq, ds.gamma, y, masks, [ds.C] * 10, 1e-3, [cap] * 10,
                cap + 1, *state)
        kw = {"X_rows": pad_rows(X), "X_norms": sn}
        routes, pick, m, cplan = placed(n, d, 10)
        require(routes == ("cluster", "persistent", "pair"),
                f"stream chunk {name} n={n}: routes placed {routes}")
        before = ops.route_counts()["smo_stream_chunk"]
        got = ops.smo_stream_chunk(*args, **kw)
        route = _route_taken(before, ops.route_counts()["smo_stream_chunk"])
        require(route == pick, f"stream chunk {name} n={n}: took the {route}"
                               f" route, stream_route says {pick}")
        outs = compare(args, kw, routes, f"{name} n={n}")
        for a, c in zip(got, outs[route]):
            require(torch.equal(a, c), f"stream chunk {name} n={n}: the "
                                       "default call differs")
        it = int(got[2].max())
        ms = routes_ms(lambda r: ops.smo_stream_chunk(*args, **kw, _route=r),
                       routes, reps=1, rounds=3)
        rec = {"n": n, "lanes": 10, "it_cap": cap, "n_iter": got[2].tolist(),
               "route": route, "cluster_plan": cplan._asdict(),
               "cluster_layout": stream_cluster_layout(d, 10, cplan.rb),
               "persistent_blocks": m,
               **{f"us_per_iter_{r}": 1e3 * ms[r] / it for r in routes}}
        if n > 10_000:
            one = ops.smo_stream_chunk(X, sq, ds.gamma, y, masks[:1], [ds.C],
                                       1e-3, [200], 201,
                                       *(t[:1] for t in state), X_norms=sn)
            plain = ref.smo_chunk_ref(
                None, torch.ones(n, dtype=torch.float64, device=dev), y,
                masks[0], ds.C, 1e-3, 200, 201, "1", *(t[0] for t in state),
                stream=(X, sq, ds.gamma))
            err = max(float((one[k][0] - plain[k]).abs().max())
                      for k in (0, 1))
            require(err <= 1e-10, f"stream chunk n={n}: err {err} vs the "
                                  "plain loop")
            # the plain loop for all ten lanes, per iteration
            sync()
            tp = time.perf_counter()
            for l in range(10):
                ref.smo_chunk_ref(
                    None, torch.ones(n, dtype=torch.float64, device=dev), y,
                    masks[l], ds.C, 1e-3, 10, 11, "1",
                    *(t[l] for t in state), stream=(X, sq, ds.gamma))
            sync()
            plain_ms = 1e3 * (time.perf_counter() - tp) / 10
            # per iteration: the function reads X and the lanes' state once
            # a chunk and runs 4 b n d FP64 operations an iteration; beside
            # it, X read from HBM every iteration (it stays in the L2)
            b_ = 10
            state_bytes = b_ * n * (8 * 4 + 1) + 16 * n
            bound = _bound((8.0 * n * d + state_bytes) / it,
                           4.0 * b_ * n * d)
            # the main path's route (stream_route's) and the persistent
            # witness, each timed in this call
            for key, r in (("smo_stream_chunk", route),
                           ("smo_stream_chunk_persistent", "persistent")):
                info[key] = dict(
                    shape=[n, d, b_], route=r, ms=rec[f"us_per_iter_{r}"] / 1e3,
                    plain_ms=plain_ms, max_abs_err=err, library_ms=None,
                    x_per_iter_hbm_ms=1e3 * 8.0 * n * d / HBM_BPS, **bound)
            layout = rec["cluster_layout"]
            info["smo_stream_chunk"]["cluster"] = {
                **cplan._asdict(), **layout,
                "x_resident_share": layout["resident"] / layout["ksteps"],
                "us_per_iter_by_route": {
                    r: rec[f"us_per_iter_{r}"] for r in routes}}
            rec["max_abs_err_vs_plain_200"] = err
        checks.append(rec)
        del X, sq, sn
        torch.cuda.empty_cache()

    big = datasets[("adult", SIZE_N - 1)]
    heart = next(ds for (name, _), ds in datasets.items() if name == "heart")
    sweep = []
    for src, n in [(big, n) for n in STREAM_SWEEP_N] + [(heart, heart.n)]:
        X = torch.as_tensor(src.X[:n], device=dev)
        y = torch.as_tensor(src.y[:n], dtype=torch.float64, device=dev)
        sq, sn = torch.sum(X * X, -1), seq_norms(X)
        d = X.shape[1]
        widths = {1, 4, 10}
        for r in ("persistent", "cluster"):
            w = _stream_widest(n, d, r)
            widths |= {w, w + 1} - {0}
        for b in sorted(widths):
            masks, state = _stream_lanes(X, y, b, dev)
            args = (X, sq, src.gamma, y, masks, [src.C] * b, 1e-3,
                    [STREAM_SWEEP_ITERS] * b, STREAM_SWEEP_ITERS + 1, *state)
            kw = {"X_norms": sn}
            routes, pick, m, cplan = placed(n, d, b)
            before = ops.route_counts()["smo_stream_chunk"]
            got = ops.smo_stream_chunk(*args, **kw)
            route = _route_taken(before,
                                 ops.route_counts()["smo_stream_chunk"])
            require(route == pick, f"stream chunk n={n} b={b}: took {route},"
                                   f" stream_route says {pick}")
            compare(args, kw, routes, f"n={n} b={b}")
            it = max(int(got[2].max()), 1)
            ms = routes_ms(lambda r: ops.smo_stream_chunk(*args, **kw,
                                                          _route=r), routes,
                           reps=1)
            rec = {"n": n, "d": d, "b": b, "blocks": m, "route": route,
                   "cluster_plan": cplan._asdict() if cplan else None,
                   "n_iter_max": it,
                   **{f"us_per_iter_{r}": 1e3 * ms[r] / it for r in routes}}
            _judge_stream_routes(rec, routes)
            sweep.append(rec)
        del X, sq, sn
        torch.cuda.empty_cache()
    emit({"phase": "stream_routes", "seconds": time.perf_counter() - t0,
          "checks": checks, "sweep": sweep})
    return info


def _judge_stream_routes(rec: dict, routes) -> None:
    """The fastest of a streaming sweep point's routes, whether
    ``stream_route``'s pick (``rec["route"]``) was it, and a failure unless
    the pick is within CHUNK_ROUTE_MARGIN of it."""
    us = {r: rec[f"us_per_iter_{r}"] for r in routes}
    rec["faster"] = min(us, key=us.get)
    rec["picks_faster"] = rec["faster"] == rec["route"]
    require(us[rec["route"]] <= (1 + CHUNK_ROUTE_MARGIN) * us[rec["faster"]],
            f"smo_stream_chunk n={rec['n']} d={rec['d']} b={rec['b']}: "
            f"stream_route picks "
            f"{rec['route']} at {us[rec['route']]:.2f} us, {rec['faster']} "
            f"takes {us[rec['faster']]:.2f}")


def phase_table1_batched(cold_folds):
    """Cold 10-fold CV through ``run_cv_batched`` in its three
    configurations on heart and adult: per-fold accuracy equal to Table 1's
    (and so to the reference), iterations beside the reference's (the
    matrix-free ones equal to them), and the streaming chunk's route.
    Every cold_pallas chunk takes a one-launch route (the model's pick), the
    cluster route on at least one of the two. Then adult n=1000 in 20 folds
    matrix-free: more lanes than a one-launch route places, so its chunks
    take the pair route until at most 16 folds are left; per-fold accuracy
    equal to the dense chunk's."""
    from repro_torch.core.cv import run_cv_batched
    from repro_torch.data.svm_suite import make_dataset
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    rows = []
    cluster_chunks = 0
    for name, refd in REFERENCE.items():
        ds = make_dataset(name, n_override=refd["n"])
        for method, kw in BATCHED.items():
            sync()
            before = ops.route_counts()["smo_stream_chunk"]
            tw = time.perf_counter()
            rep = run_cv_batched(ds, k=10, **kw)
            wall = time.perf_counter() - tw
            after = ops.route_counts()["smo_stream_chunk"]
            routes = {r: after[r] - before[r] for r in after}
            if method == "cold_pallas":
                require(routes["pair"] == 0
                        and routes["persistent"] + routes["cluster"] > 0,
                        f"{name} cold_pallas: stream chunk routes {routes}")
                cluster_chunks += routes["cluster"]
            if method == "cold_pallas" or refd["gated"]:
                require(rep.total_iterations
                        == REFERENCE_BATCHED[name][method],
                        f"{name} {method}: {rep.total_iterations} "
                        "iterations, not the reference's")
            require(rep.method == method, f"{rep.method} != {method}")
            require(all(f.converged for f in rep.folds)
                    and all(math.isfinite(f.objective) for f in rep.folds),
                    f"{name} {method}: a fold did not converge")
            per_fold = [(f.acc_correct, f.acc_total) for f in rep.folds]
            require(per_fold == cold_folds[name],
                    f"{name} {method}: per-fold accuracy {per_fold} != "
                    f"Table 1's {cold_folds[name]}")
            require(round(rep.accuracy, 4) == refd["accuracy"],
                    f"{name} {method}: accuracy {rep.accuracy}")
            it = rep.total_iterations
            lane_max = max(f.n_iter for f in rep.folds)
            rows.append({
                "dataset": name, "n": rep.n, "method": method,
                "iterations": it,
                "reference_iterations": REFERENCE_BATCHED[name][method],
                "per_fold_iterations": [f.n_iter for f in rep.folds],
                "kernel_s": rep.kernel_time, "solve_s": rep.total_solve_time,
                "wall_s": wall,
                "us_per_iteration": 1e6 * rep.total_solve_time / max(it, 1),
                "us_per_longest_lane_iteration":
                    1e6 * rep.total_solve_time / max(lane_max, 1),
                "accuracy": rep.accuracy, "occupancy": rep.occupancy,
                "stream_routes": routes})
    require(cluster_chunks > 0, "cold_pallas: no chunk took the cluster "
                                "route")
    ds = make_dataset("adult", n_override=REFERENCE["adult"]["n"])
    dense = run_cv_batched(ds, k=WIDE_K)
    before = ops.route_counts()["smo_stream_chunk"]
    sync()
    tw = time.perf_counter()
    rep = run_cv_batched(ds, k=WIDE_K, source_backend="pallas_rbf")
    wall = time.perf_counter() - tw
    after = ops.route_counts()["smo_stream_chunk"]
    routes = {r: after[r] - before[r] for r in after}
    require(routes["pair"] > 0, f"adult k={WIDE_K} cold_pallas: stream "
                                f"chunk routes {routes}, no pair route")
    require(all(f.converged for f in rep.folds + dense.folds),
            f"adult k={WIDE_K}: a fold did not converge")
    per_fold = [(f.acc_correct, f.acc_total) for f in rep.folds]
    require(per_fold == [(f.acc_correct, f.acc_total) for f in dense.folds],
            f"adult k={WIDE_K} cold_pallas: per-fold accuracy {per_fold} "
            "differs from the dense chunk's")
    rows.append({"dataset": "adult", "n": rep.n, "k": WIDE_K,
                 "method": rep.method, "iterations": rep.total_iterations,
                 "dense_iterations": dense.total_iterations,
                 "per_fold_iterations": [f.n_iter for f in rep.folds],
                 "solve_s": rep.total_solve_time, "wall_s": wall,
                 "accuracy": rep.accuracy, "dense_accuracy": dense.accuracy,
                 "stream_routes": routes})
    emit({"phase": "table1_batched", "seconds": time.perf_counter() - t0,
          "rows": rows})


def phase_size_matrix_free(ds, dense_accs):
    """Matrix-free 10-fold cold CV at the paper's cardinality: peak device
    memory under 3 GiB (the dense path's K alone is 8.48 GB), and the
    folds the dense path solved give its accuracy (the evaluation by
    ``rows_at`` and the streaming ``matvec`` checked at that size).
    Returns the per-fold (correct, total)."""
    from repro_torch.core.cv import run_cv_batched
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = ops.route_counts()["smo_stream_chunk"]
    rep = run_cv_batched(ds, k=10, source_backend="pallas_rbf")
    peak = torch.cuda.max_memory_allocated()
    after = ops.route_counts()["smo_stream_chunk"]
    routes = {r: after[r] - before[r] for r in after}
    require(routes["pair"] == 0 and routes["cluster"] > 0,
            f"matrix-free size: stream chunk routes {routes}")
    require(rep.total_iterations == SIZE_MATRIX_FREE_ITERATIONS,
            f"matrix-free size: {rep.total_iterations} iterations, not "
            f"{SIZE_MATRIX_FREE_ITERATIONS}")
    require(peak < PEAK_LIMIT, f"matrix-free peak {peak} B >= 3 GiB")
    require(all(f.converged for f in rep.folds)
            and all(math.isfinite(f.objective) for f in rep.folds),
            "matrix-free size: a fold did not converge")
    accs = [f.acc_correct / f.acc_total for f in rep.folds]
    require(accs[:len(dense_accs)] == dense_accs,
            f"matrix-free size: fold accuracies {accs[:len(dense_accs)]} "
            f"differ from the dense path's {dense_accs}")
    lane_max = max(f.n_iter for f in rep.folds)
    emit({"phase": "size_matrix_free", "seconds": time.perf_counter() - t0,
          "n": rep.n, "k": rep.k, "kernel_s": rep.kernel_time,
          "solve_s": rep.total_solve_time,
          "iterations": rep.total_iterations,
          "per_fold_iterations": [f.n_iter for f in rep.folds],
          "us_per_longest_lane_iteration":
              1e6 * rep.total_solve_time / max(lane_max, 1),
          "accuracy": rep.accuracy,
          "per_fold_accuracy": accs, "dense_accuracy": dense_accs,
          "peak_gb": peak / 1e9, "occupancy": rep.occupancy,
          "stream_routes": routes})
    return [(f.acc_correct, f.acc_total) for f in rep.folds]


def _row_rel(got, want) -> float:
    """max over rows (the last axis) of max |got - want| / max |want|."""
    w = want.float()
    err = (got.float() - w).abs().amax(-1)
    return float((err / w.abs().amax(-1).clamp_min(1e-30)).max())


def flash_bf16_errors(got, q, k, v, causal=True, window=None,
                      tail=None) -> dict:
    """The kernel's output ``got`` on bf16 q, k, v against the plain
    version run in float32 on the same inputs (row by row, ``_row_rel``),
    beside the plain version's own error in bf16. With ``tail``, the last
    ``tail`` queries alone against every key (the plain form at their
    offset, ``attention.sdpa``: a float32 score block over all the rows of
    a long prefill does not fit beside its model)."""
    from repro_torch.kernels import ref
    if tail is None:
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       causal=causal, window=window)
        plain = ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)
    else:
        from repro_torch.models import attention
        off = q.shape[2] - tail
        require(off > 0, f"a tail of {tail} queries of {q.shape[2]}")
        qs, ks, vs = (t.transpose(1, 2) for t in (q[:, :, off:], k, v))
        want, plain = (attention.sdpa(
            *(t.to(dtype) for t in (qs, ks, vs)), causal=causal,
            q_offset=off, window=window).transpose(1, 2)
            for dtype in (torch.float32, q.dtype))
        got = got[:, :, off:]
    return {"row_rel_err": _row_rel(got, want),
            "plain_row_rel_err": _row_rel(plain, want),
            "max_abs_err": float((got.float() - want).abs().max()),
            "max_abs_diff_bf16_plain": float(
                (got.float() - plain.float()).abs().max())}


def flash_bf16_ok(rec: dict) -> bool:
    """Within FLASH_ROW_REL and within twice the plain version's error."""
    return (math.isfinite(rec["row_rel_err"])
            and rec["row_rel_err"] <= FLASH_ROW_REL
            and rec["row_rel_err"] <= 2.0 * rec["plain_row_rel_err"])


def flash_bf16_check(q, k, v, causal=True, window=None) -> dict:
    """``flash_bf16_errors`` of one launch of the kernel, with the route it
    took; raises unless ``flash_bf16_ok`` and the route is the one
    ``route`` names for the head dim."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import route
    before = ops.route_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    took = _route_taken(before, ops.route_counts()["flash_attention"])
    rec = flash_bf16_errors(got, q, k, v, causal, window)
    require(flash_bf16_ok(rec), f"flash_attention bf16 {tuple(q.shape)} "
            f"causal={causal} window={window}: {rec}")
    require(took == route(q.dtype, q.shape[-1]),
            f"flash_attention bf16 D={q.shape[-1]} took the {took} route")
    return {"route": took, **rec}


def phase_flash():
    """flash_attention against its plain version on the card: the
    reference's sweep in f32 (atol 2e-5, the FMA route) and its bf16 case
    (0.06); the sweep's shapes and six with grouped kv heads at D=32, 128
    and 256 in bf16 (FLASH_BF16_CASES), each also within 0.06 of the plain
    version in bf16; then granite-8b's and gemma-7b's prefill shapes,
    granite's with grouped kv heads, read in place from (B, S, H, D)
    activations. Every bf16 case is held to the plain version run in
    float32 on the same bf16 inputs, row by row
    (``flash_bf16_check``). Then the kernel's time, the plain version's
    (bf16), ``F.scaled_dot_product_attention``'s on broadcast K/V (the
    yardstick, never called by the port) and the bounds (``_time_flash``),
    there, at gemma-7b's prefill shape and at granite's with head dims 32
    and 16 (the mma.sync route's own, where the exps bound it); and the
    mma.sync route's time at the first two. Every bf16 case also shows the
    route it
    took (wgmma at D >= 64, mma.sync below)."""
    from repro_torch.kernels import ops, ref
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    checks = []
    for S, D, causal, window in FLASH_CASES:
        q, k, v = (torch.as_tensor(rng.normal(size=(2, 3, S, D)),
                                   dtype=torch.float32, device=dev)
                   for _ in range(3))
        before = ops.route_counts()["flash_attention"]
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        took = _route_taken(before, ops.route_counts()["flash_attention"])
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        err = float((got - want).abs().max())
        require(math.isfinite(err) and err <= 2e-5 and took == "fma",
                f"flash_attention S={S} D={D} causal={causal} "
                f"window={window} f32: err {err} > 2e-5, or route {took}")
        checks.append({"shape": [2, 3, S, D], "causal": causal,
                       "window": window, "dtype": "float32", "route": took,
                       "max_abs_err": err})
    for B, H, KV, S, D, causal, window in ((1, 2, 2, 64, 32, True, None),) \
            + FLASH_BF16_CASES:
        q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, D)),
                                   dtype=torch.bfloat16,
                                   device=dev).transpose(1, 2)
                   for h in (H, KV, KV))
        if KV == H:            # the reference's layout: (B, H, S, D)
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        rec = flash_bf16_check(q, k, v, causal, window)
        require(rec["max_abs_diff_bf16_plain"] <= 0.06,
                f"flash_attention {(B, H, KV, S, D)} bf16: "
                f"{rec['max_abs_diff_bf16_plain']} from the plain version "
                "in bf16 > 0.06")
        checks.append({"shape": [B, H, KV, S, D], "causal": causal,
                       "window": window, "dtype": "bfloat16", **rec})

    shapes = {name: _time_flash(shape, check=True)
              for name, shape in (("granite-8b", FLASH_GRANITE),
                                  ("gemma-7b", FLASH_GEMMA),
                                  ("d32", FLASH_D32), ("d16", FLASH_D16))}
    rec = dict(shapes["granite-8b"], max_abs_err=max(
        [c["max_abs_err"] for c in checks]
        + [r["max_abs_err_vs_f32_plain"] for r in shapes.values()]),
        mma_route={name: {key: shapes[name][key] for key in (
            "shape", "ms", "library_ms", "plain_ms", "bound_ms",
            "flop_bound_ms", "exp_bound_ms", "row_rel_err")}
            for name in ("d32", "d16")})
    emit({"phase": "kernels_flash", "seconds": time.perf_counter() - t0,
          "checks": checks, "granite": rec, "gemma": shapes["gemma-7b"],
          "mma_d32": shapes["d32"], "mma_d16": shapes["d16"]})
    return rec


def _time_flash(shape, check: bool) -> dict:
    """bf16 causal attention at ``shape`` (B, H, KV, S, D), q, k, v read in
    place from (B, S, H, D) activations: the kernel's time on its route
    (and, ``check``, its ``flash_bf16_check``, the forced mma.sync route's
    time and the plain version's), ``F.scaled_dot_product_attention``'s on
    broadcast K/V (the yardstick, never called by the port), and the
    bounds: ``bound_ms`` from the bytes and the tensor cores' FLOPs, and
    beside it ``exp_bound_ms``, the floor of a design that takes every exp
    on the SFUs (one a score): a kernel that computes some of them as a
    polynomial on the FMA pipes can go below it."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import route
    dev = torch.device("cuda")
    B, H, KV, S, D = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev,
                           dtype=torch.bfloat16).transpose(1, 2)
               for h in (H, KV, KV))
    rec = {"shape": [B, H, KV, S, D], "route": route(q.dtype, D)}
    if check:
        c = flash_bf16_check(q, k, v)
        rec.update(row_rel_err=c["row_rel_err"],
                   plain_row_rel_err=c["plain_row_rel_err"],
                   max_abs_err_vs_f32_plain=c["max_abs_err"])
    torch.cuda.empty_cache()
    got = ops.flash_attention(q, k, v)
    rec["ms"] = ms = cuda_ms(lambda: ops.flash_attention(q, k, v), 20, 3)
    if check:
        rec["mma_route_ms"] = cuda_ms(
            lambda: ops.flash_attention(q, k, v, _route="mma"), 5)
        rec["plain_ms"] = cuda_ms(lambda: ref.flash_attention_ref(q, k, v),
                                  2)
    torch.cuda.empty_cache()
    qc = q.contiguous()
    kb, vb = (t.repeat_interleave(H // KV, dim=1).contiguous()
              for t in (k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qc, kb, vb, is_causal=True)
    rec["library_ms"] = cuda_ms(library, 20, 3)
    rec["library_max_abs_diff"] = float(
        (library().float() - got.float()).abs().max())
    del qc, kb, vb, got, q, k, v
    torch.cuda.empty_cache()
    pairs = S * (S + 1) // 2          # (query, visible key) pairs
    flops = 4.0 * B * H * D * pairs
    bound = _bound(2.0 * (2 * B * H * S * D + 2 * B * KV * S * D), flops,
                   BF16_FLOPS)
    rec.update(tflops=flops / ms / 1e9, flop_bound_ms=1e3 * flops / BF16_FLOPS,
               exp_bound_ms=exp_bound_ms(B * H * pairs), **bound)
    return rec


def _mixer_routes(block, x, cache_def):
    """One block's attention (its mixer, after its first norm) fed the same
    input ``x`` (B, P, d) by both routes: all P positions at once (prefill;
    through the kernel on the card) and token by token through a fresh
    cache drawn from ``cache_def`` (decode; plain attention; MLA's absorbed
    form; mamba's state), in x's dtype but for the leaves that name their
    own (mamba's float32 ``ssm``). Returns both outputs."""
    from repro_torch.models.params import init_params
    B, P = x.shape[:2]
    pos = torch.arange(P, device=x.device)[None].expand(B, P)
    h = block.ln1(x)
    pre, _ = block.mixer(h, pos)
    cache = init_params(cache_def, torch.Generator(device=x.device), x.dtype,
                        x.device)
    dec = torch.cat([block.mixer(h[:, t:t + 1], pos[:, t:t + 1], cache=cache,
                                 step=t)[0] for t in range(P)], 1)
    return pre, dec


def _profile(fn) -> dict:
    """``fn()`` under ``torch.profiler`` (CPU and CUDA activity): the
    device time summed over its kernels and the eight kernels with the
    most of it. (The profiler's own host cost makes its wall time no
    measure of the unprofiled run's; the caller divides by that instead.)"""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "launches": sum(e.count for e in kernels),
            "top": [{"name": e.key[:80], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in kernels[:8]]}


def phase_serve_lm(flash_ms: float):
    """granite-8b at full width and depth in bf16 on the card, weights
    drawn from a seeded generator. The main path, with the launch counts
    set to 0 just before it and read just after: prefill of PREFILL_B x
    PREFILL_S tokens twice (each attention layer one flash_attention
    launch), then SERVE_B requests through the KV cache: PROMPT tokens
    teacher-forced, NEW_TOKENS greedy.

    Then the checks, whose launches are counted apart. (1) Every prefill
    layer's attention on the main path's own bf16 q, k, v, against the
    plain version in float32 on them (``flash_bf16_errors``, FLASH_ROW_REL
    and twice the bf16 plain version's error). (2) Layer by layer, each
    block's attention fed the same input (the forward's hidden state at its
    depth) by the prefill route (kernel) and the decode route (plain,
    through the cache): in float32 the two must agree within LAYER_REL_F32,
    row by row; in bf16 the kernel route must come within twice the plain
    route's error, both against the float32 plain route. (3) The whole
    model: the prompt's forward (kernel attention) against the
    teacher-forced decode (plain), reported position by position in bf16
    and with the same weights in float32, and gated at position 0 only
    (POS0_ATOL_*): under the reference's init attention is one-hot, and
    where it has a choice of keys the model amplifies a rounding
    difference from layer to layer until, after 36 layers, two float32
    routes disagree at the scale of the logits themselves.
    Returns the main path's launch counts and route counts; every prefill
    launch must take the wgmma route."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.inputs import concrete_batch
    from repro_torch.models.layers import embed
    from repro_torch.models.transformer import (count_params, decode_step,
                                                init_cache, init_model)
    from repro_torch.serving import prefill_logits
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("granite-8b")
    require(cfg.n_layers == 36 and cfg.d_model == 4096,
            "serve_lm: not granite-8b's full width and depth")
    model = init_model(cfg, seed=0, dtype=torch.bfloat16)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == count_params(cfg) == GRANITE_PARAMS,
            f"serve_lm: {n_params} parameters, want {GRANITE_PARAMS}")
    tokens = concrete_batch(cfg, PREFILL_B, PREFILL_S, seed=0)["tokens"]
    prompt = concrete_batch(cfg, SERVE_B, PROMPT, seed=1)["tokens"]

    # ---- the main path: counts from 0 just before it, read just after
    ops.reset_launch_counts()
    main = _lm_main_path(model, cfg, tokens, prompt, NEW_TOKENS, prefills=2)
    main_counts = ops.launch_counts()
    main_routes = ops.route_counts()
    main_windows = ops.window_counts()
    # ---- end of the main path
    require(main_routes["flash_attention"] == {
        "fma": 0, "mma": 0, "wgmma": 2 * cfg.n_layers}
        and main_windows == {"windowed": 0, "global": 2 * cfg.n_layers},
        f"serve_lm: the prefills' attention took routes "
        f"{main_routes['flash_attention']} ({main_windows}), want wgmma and "
        "global for all 72")
    prefill_s, decode_ms = main["prefill_s"], main["decode_ms_per_step"]
    serve_peak = torch.cuda.max_memory_allocated()
    ops.reset_launch_counts()

    # where the time goes: one prefill, and 8 decode steps, under the
    # profiler; busy share = their device time over the unprofiled times
    prof_prefill = _profile(lambda: prefill_logits(model,
                                                   {"tokens": tokens}))
    prof_prefill["device_busy_share"] = prof_prefill["device_ms"] / (
        1e3 * prefill_s)
    cache = init_cache(cfg, SERVE_B, 8, torch.bfloat16)

    def steps():
        for t in range(8):
            decode_step(model, cache, {"tokens": prompt[:, t:t + 1],
                                       "step": t})
    prof_decode = _profile(steps)
    prof_decode["device_busy_share"] = prof_decode["device_ms"] / (
        8 * decode_ms)
    del cache

    # (1) every prefill layer's attention on the main path's own inputs
    attn = _checked_prefill(model, tokens, {
        "flash_attention": flash_bf16_errors})["flash_attention"]
    torch.cuda.empty_cache()

    # (2) layer by layer: the same input through both routes, bf16 and f32
    pos = torch.arange(PROMPT, device=prompt.device)[None].expand(SERVE_B,
                                                                 PROMPT)
    with torch.inference_mode():
        x = embed(model.embed, prompt)
        layers = []
        for i, block in enumerate(model.layers):
            layers.append({"layer": i, **_layer_routes(block, x, cfg, i)})
            x = block(x, pos)[0]
    worst_f32 = max(r["f32"] for r in layers)
    bf16_ok = all(r["bf16_kernel_route"] <= 2.0 * r["bf16_plain_route"]
                  for r in layers)

    # (3) the whole model: the prompt's forward (kernel attention) against
    # the teacher-forced decode (plain), position by position
    def by_position(a, b):
        return (a.float() - b.float()).abs().amax(dim=(0, 2)).tolist()
    full, dec = _forward_checked(model, prompt), main["prompt_logits"]
    pos_bf16 = by_position(full, dec)
    rec = {"phase": "serve_lm", "arch": cfg.name, "n_params": n_params,
           "dtype": "bfloat16", "init_s": init_s,
           "prefill_shape": [PREFILL_B, PREFILL_S],
           **{key: v for key, v in main.items() if key != "prompt_logits"},
           "flash_share_of_prefill_est": cfg.n_layers * flash_ms / 1e3
           / prefill_s,
           "serve_batch": SERVE_B, "prompt": PROMPT,
           "new_tokens": NEW_TOKENS, "serve_peak_gb": serve_peak / 1e9,
           "main_path_launches": main_counts,
           "main_path_routes": main_routes,
           "profile_prefill": prof_prefill, "profile_decode_8_steps":
               prof_decode,
           "prefill_attention_row_rel_max": max(r["row_rel_err"]
                                                for r in attn),
           "prefill_attention_plain_row_rel_min": min(
               r["plain_row_rel_err"] for r in attn),
           "prefill_attention": attn,
           "layer_rel_max_f32": worst_f32, "layers": layers,
           "logits_by_position_max_abs_diff": pos_bf16,
           "logits_last_position_same_argmax": int(
               (full[:, -1].float().argmax(-1)
                == dec[:, -1].float().argmax(-1)).sum()),
           "logits_max_abs": float(dec.float().abs().max())}

    # the same weights in float32, the whole model once more
    model.float()
    cache = init_cache(cfg, SERVE_B, PROMPT, torch.float32)
    dec32 = []
    for t in range(PROMPT):
        last32, cache = decode_step(model, cache, {
            "tokens": prompt[:, t:t + 1], "step": t})
        dec32.append(last32[:, 0])
    full32, dec32 = _forward_checked(model, prompt), torch.stack(dec32, 1)
    pos_f32 = by_position(full32, dec32)
    rec["logits_f32_by_position_max_abs_diff"] = pos_f32
    rec["logits_bf16_vs_f32_by_position"] = by_position(full, full32)
    rec["check_launches"] = ops.launch_counts()
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    require(len(attn) == cfg.n_layers and all(map(flash_bf16_ok, attn)),
            "serve_lm: a prefill layer's attention is off its plain "
            "version in float32 by more than FLASH_ROW_REL or twice the "
            "bf16 plain version's error")
    require(math.isfinite(worst_f32) and worst_f32 <= LAYER_REL_F32,
            f"serve_lm: a layer's two attention routes differ by "
            f"{worst_f32} (f32) > {LAYER_REL_F32}")
    require(bf16_ok, "serve_lm: a layer's bf16 kernel route is off the "
            "float32 route by more than twice the bf16 plain route")
    require(pos_bf16[0] <= POS0_ATOL_BF16 and pos_f32[0] <= POS0_ATOL_F32,
            f"serve_lm: the prompt's forward and decode logits differ at "
            f"position 0 by {pos_bf16[0]} (bf16) / {pos_f32[0]} (f32)")
    del model, cache
    torch.cuda.empty_cache()
    return main_counts, main_routes


#: gemma3-4b's and yi-34b's parameters (model_params_def at full width)
GEMMA3_PARAMS = 3_879_907_840
YI_PARAMS = 34_388_917_248
#: gemma3's prefill (``prefill_32k``'s length, one sequence) and the rows
#: of each global layer checked against plain attention: an f32 score
#: block over all 32,768 rows would be 34 GB
GEMMA3_PREFILL_B, GEMMA3_PREFILL_S = 1, 32768
GEMMA3_TAIL = 2048
#: its prefill attention (B, H, KV, S, D), bf16, and its local layers'
#: window
FLASH_GEMMA3 = (1, 8, 4, 32768, 256)
GEMMA3_WINDOW = 1024
#: the local layer fed both routes at this length: decode steps past the
#: window (1,024) mask keys on the plain route
GEMMA3_ROUTES_S = 2560
#: gemma3's local layer through both routes in float32, row by row: under
#: the reference's init (wq's fan-in is its head axis) the scores' std is
#: ~320, so the two routes' projections (2,560 rows at once against one)
#: round a score apart by ~3e-4, and where two of 1,024 keys nearly tie
#: (many rows at this length) that moves the row's output by as much;
#: granite's LAYER_REL_F32 holds 16 positions
GEMMA3_LAYER_REL_F32 = 1e-3
#: the same layer's prefill route without its window, against with it: the
#: window must change the rows past 1,024 (the decode route's mask bites)
WINDOW_BITES_MIN = 0.1
#: a windowed launch's device time over a global one's at gemma3's prefill:
#: the band is 1/16 of the causal triangle there, so a kernel that skips
#: the tiles outside it comes in well under this
WINDOW_SHARE_MAX = 0.25
#: yi-34b's prefill; its requests' prompt and new tokens
YI_PREFILL_B, YI_PREFILL_S = 1, 2048
YI_PROMPT, YI_NEW_TOKENS = 16, 16
#: the most device memory that may be allocated before a served model's
#: weights are drawn (yi's 68.78 GB, deepseek's 58.38 and jamba's 52.1 of
#: the card's 80; ``_serve_guard``)
SERVE_FREE_BEFORE = 2 ** 30
#: deepseek-v2-236b at full width, cut to DEEPSEEK_LAYERS layers (1 dense +
#: 7 MLA + MoE; its 60 are 471 GB in bf16, more than the card's 80): the
#: parameters of that config (``tests/test_torch_lm.py`` holds the constant
#: to the reference's count)
DEEPSEEK_LAYERS = 8
DEEPSEEK_PARAMS = 29_191_377_920
#: its prefill; its requests' prompt and new tokens
DEEPSEEK_PREFILL_B, DEEPSEEK_PREFILL_S = 1, 4096
DEEPSEEK_PROMPT, DEEPSEEK_NEW_TOKENS = 16, 16
#: MLA's prefill attention (B, H, KV, S, DQK, DV), bf16, causal
FLASH_MLA = (1, 128, 128, 4096, 192, 128)
#: heads of an MLA prefill layer held to the plain version in float32 at a
#: time: all 128 at once would be a 8.6 GB score block beside the weights
MLA_CHECK_HEADS = 16
#: one MoE layer in bf16 against its weights alone in float32 on the same
#: bf16 input, row by row over the tokens whose experts and kept slots
#: agree: the reference's own gap on the CPU at SMOKE size (512 tokens,
#: seeds 0-2) is 0.0157-0.0161 (bf16's rounding of the expert GEMMs and
#: their gate); 2.5 times that
DEEPSEEK_MOE_ROW_REL = 0.04
#: ... and at least this share of the tokens must agree, so that the check
#: has rows to hold (the reference's router flips 0-1 of 512 tokens at
#: SMOKE size; at 160 experts and bf16 logits more may flip: recorded)
DEEPSEEK_MOE_AGREE_MIN = 0.5
#: one MLA layer's absorbed decode against its prefill form over the same
#: cache rows, float32, row by row: the reference's own gap on the CPU at
#: SMOKE size is 2.1e-6-3.0e-6 (seeds 0-2); full width sums over 80 times
#: as many terms (kv_lora_rank 512, d 5120), ~9 times the rounding
DEEPSEEK_MLA_REL_F32 = 1e-4
#: the (4, 1) forward (one key: the kernel returns v) against decode step 0
#: of the 4 requests (the absorbed form), bf16, max |diff| over the logits'
#: largest magnitude: the reference's own gap on the CPU at SMOKE size is
#: 0.0 (and the port's there too); on the card the two forms take v from
#: one product and the absorbed context from 128 per-head ones, whose bf16
#: roundings may differ by an ulp (2^-8); five such ulps of the scale
DEEPSEEK_POS0_REL = 0.02
#: the whole model at position 0 in float32 against float32's own error:
#: ten times granite's measured difference (1e-5 at logits up to 6.6), a
#: unit of the logits' scale (gemma3's tied table gives logits in the
#: hundreds)
POS0_REL_F32 = 1.5e-5


#: jamba-v0.1-52b at full width, cut to JAMBA_LAYERS layers (two of its
#: period-8 blocks: 2 NoPE GQA + 14 mamba layers, 8 with the MoE; its 32
#: are 103.1 GB in bf16, more than the card's 80): the parameters of that
#: config (``tests/test_torch_ssm.py`` holds the constant to the
#: reference's count)
JAMBA_LAYERS = 16
JAMBA_PARAMS = 26_053_595_136
#: its prefill (``prefill_32k``'s length, one sequence: Jamba's users send
#: long prompts); its requests' prompt and new tokens
JAMBA_PREFILL_B, JAMBA_PREFILL_S = 1, 32768
JAMBA_PROMPT, JAMBA_NEW_TOKENS = 16, 16
#: the selective scan at the main path's prefill (B, S, Din, St), bf16,
#: and at its decode step (the 4 requests, one token)
SCAN_PREFILL = (1, 32768, 8192, 16)
SCAN_DECODE = (4, 1, 8192, 16)
#: positions of a prefill layer's scan held to the plain version (its
#: first and, from the kernel's state there, its last): a float32 (B, S,
#: Din) tensor over all 32,768 would be 1.07 GB a copy, and the plain
#: loop a launch chain of 6 a step
JAMBA_CHECK_S = 2048
#: query heads of an attention layer held to the plain version at a time
#: (two kv heads), over its last JAMBA_CHECK_S queries: all 32 at once
#: against 32,768 keys would be a 8.6 GB float32 score block beside the
#: weights
JAMBA_CHECK_HEADS = 8
#: the plain version's timed length at the prefill's width
SCAN_PLAIN_S = 2048
#: the kernel against the plain version on the same float32 inputs, row by
#: row (``_row_rel``; the state h_out likewise): the two sum over the 16
#: states in other orders and the kernel's exp is the SFU's (a few ulps
#: of each factor of the state's products)
SCAN_F32_REL = 1e-5
#: a bf16 scan against the plain version run in float32 on the same bf16
#: inputs, row by row: the reference's own bf16-against-f32 gap on the CPU
#: at SMOKE size is 0.0058-0.0069 (seeds 3-5; the rounding of dt * u to
#: bf16 and of y; ``tests/test_torch_ssm.py``); three times that. The
#: kernel must also come within twice the bf16 plain version's own error
JAMBA_SCAN_ROW_REL = 0.02
#: one mamba layer fed the same float32 input by the prefill form (one
#: launch over the prompt) and by decode step by step through its cache,
#: its weights alone in float32, row by row: the reference's own gap on
#: the CPU at SMOKE size is 3.3e-6-5.8e-6 (seeds 0-2); full width sums
#: its projections over 64 times as many terms
JAMBA_LAYER_REL_F32 = 1e-4
#: the (4, 1) forward against decode step 0 of the 4 requests, bf16, max
#: |diff| over the logits' largest magnitude: the reference's own gap at
#: SMOKE size is 0.0 (seeds 0-2: the same arithmetic on the same 4
#: tokens, the MoE's capacity set by them in both); DEEPSEEK_POS0_REL's bar
JAMBA_POS0_REL = 0.02


def attention_layers(cfg) -> int:
    """The layers of ``cfg``'s plan whose mixer is attention (GQA or MLA):
    one flash_attention launch each in a prefill."""
    from repro_torch.models.transformer import _layer_specs
    return sum(s.mixer in ("attn", "mla") for s in _layer_specs(cfg))


def mamba_layers(cfg) -> int:
    """The layers of ``cfg``'s plan whose mixer is mamba: one
    selective_scan launch each in a prefill and in a decode step."""
    from repro_torch.models.transformer import _layer_specs
    return sum(s.mixer == "mamba" for s in _layer_specs(cfg))


def mlstm_layers(cfg) -> int:
    """The layers of ``cfg``'s plan whose mixer is mLSTM: one mlstm_parallel
    launch each in a prefill, none in a decode step (the recurrent update
    is torch ops)."""
    from repro_torch.models.transformer import _layer_specs
    return sum(s.mixer == "mlstm" for s in _layer_specs(cfg))


def slstm_layers(cfg) -> int:
    """The layers of ``cfg``'s plan whose mixer is sLSTM: one slstm_scan
    launch each in a prefill and in a decode step."""
    from repro_torch.models.transformer import _layer_specs
    return sum(s.mixer == "slstm" for s in _layer_specs(cfg))


#: the kernels a prefill and a decode step of an LM launch a fixed number
#: of times, by the plan's layers: {name: (launches a prefill, a step)}
def lm_launches(cfg) -> dict:
    n_mamba, n_slstm = mamba_layers(cfg), slstm_layers(cfg)
    return {"flash_attention": (attention_layers(cfg), 0),
            "selective_scan": (n_mamba, n_mamba),
            "mlstm_parallel": (mlstm_layers(cfg), 0),
            "slstm_scan": (n_slstm, n_slstm)}


def _lm_main_path(model, cfg, tokens, prompt, new_tokens: int,
                  prefills: int) -> dict:
    """The LM serving path of ``model``: ``prefills`` prefills of
    ``tokens`` (each attention layer one flash_attention launch, each
    mamba layer one selective_scan launch, each mLSTM layer one
    mlstm_parallel launch, each sLSTM layer one slstm_scan launch, checked
    per call), then ``prompt``'s requests served through the cache, the
    prompt teacher-forced and ``new_tokens`` greedy (each mamba and sLSTM
    layer one launch of its kernel a step, no other of those kernels,
    checked over the steps). Returns the times, each prefill's windowed
    and global launches, the prompt's logits from the cache and the
    generated tokens."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import decode_step, init_cache
    from repro_torch.serving import build_serve_step, prefill_logits
    want = lm_launches(cfg)
    prefill_s, kinds = [], []
    for _ in range(prefills):
        before = ops.launch_counts()
        windows = ops.window_counts()
        sync()
        tp = time.perf_counter()
        logits = prefill_logits(model, {"tokens": tokens})
        sync()
        prefill_s.append(time.perf_counter() - tp)
        after = ops.launch_counts()
        launched = {name: after[name] - before[name] for name in want}
        kinds.append({key: n - windows[key]
                      for key, n in ops.window_counts().items()})
        require(launched == {name: n for name, (n, _) in want.items()},
                f"{cfg.name}: {launched} launches in one prefill, want "
                f"{want} (a prefill, a decode step)")
        require(bool(torch.isfinite(logits).all())
                and tuple(logits.shape) == (tokens.shape[0], 1,
                                            cfg.vocab_size),
                f"{cfg.name}: prefill logits {tuple(logits.shape)}, or "
                "not finite")
    prefill_peak = torch.cuda.max_memory_allocated()
    B, P = prompt.shape
    cache = init_cache(cfg, B, P + new_tokens, torch.bfloat16)
    serve = build_serve_step(cfg)
    before = ops.launch_counts()
    sync()
    tp = time.perf_counter()
    prompt_logits = []
    for t in range(P):
        last, cache = decode_step(model, cache, {
            "tokens": prompt[:, t:t + 1], "step": t})
        prompt_logits.append(last[:, 0])
    sync()
    prompt_s = time.perf_counter() - tp
    tok = torch.argmax(last[:, -1].float(), dim=-1)
    out, step_s = [tok], []
    for t in range(P, P + new_tokens - 1):
        ts = time.perf_counter()
        tok, cache = serve(model, cache, {"tokens": tok[:, None], "step": t})
        sync()
        step_s.append(time.perf_counter() - ts)
        out.append(tok)
    decode_steps = P + new_tokens - 1
    after = ops.launch_counts()
    stepped = {name: after[name] - before[name] for name in want}
    require(stepped == {name: decode_steps * n
                        for name, (_, n) in want.items()},
            f"{cfg.name}: {stepped} launches over {decode_steps} decode "
            f"steps, want {want} (a prefill, a decode step)")
    generated = torch.stack(out, 1)
    require(tuple(generated.shape) == (B, new_tokens)
            and int(generated.min()) >= 0
            and int(generated.max()) < cfg.vocab_size,
            f"{cfg.name}: generated tokens {tuple(generated.shape)}")
    steady = step_s[2:]
    decode_ms = 1e3 * sum(steady) / len(steady)
    return {"prefill_s_each": prefill_s, "prefill_s": prefill_s[-1],
            "prefill_launches_by_kind": kinds,
            "prefill_tokens_per_s": tokens.numel() / prefill_s[-1],
            "prefill_peak_gb": prefill_peak / 1e9,
            "prompt_s": prompt_s, "decode_ms_per_step": decode_ms,
            "decode_ms_per_step_min": 1e3 * min(steady),
            "decode_tokens_per_s": B / (decode_ms / 1e3),
            "decode_steps": decode_steps,
            "first_tokens": generated[0].tolist(),
            "prompt_logits": torch.stack(prompt_logits, 1)}


def _checked_prefill(model, tokens, checks: dict) -> dict:
    """One prefill of ``tokens`` with every launch of each kernel that
    ``checks`` names ({ops name: check}) also passed, its output first and
    then its arguments, to that kernel's check; returns {ops name: the
    checks' records, in launch order}."""
    from repro_torch.kernels import ops
    from repro_torch.serving import prefill_logits
    kernels = {name: getattr(ops, name) for name in checks}
    recs = {name: [] for name in checks}

    def checked(name):
        def launch(*args, **kwargs):
            got = kernels[name](*args, **kwargs)
            recs[name].append(checks[name](got, *args, **kwargs))
            return got
        return launch
    for name in checks:
        setattr(ops, name, checked(name))
    try:
        prefill_logits(model, {"tokens": tokens})
    finally:
        for name, kernel in kernels.items():
            setattr(ops, name, kernel)
    sync()
    torch.cuda.empty_cache()
    return recs


def _forward_checked(model, tokens):
    """The forward's logits over ``tokens`` by the prefill route: each
    attention layer one flash_attention launch, the logits finite."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import forward
    before = ops.launch_counts()["flash_attention"]
    logits, _ = forward(model, {"tokens": tokens})
    launched = ops.launch_counts()["flash_attention"] - before
    want = attention_layers(model.cfg)
    require(launched == want and bool(torch.isfinite(logits).all()),
            f"{launched} flash_attention launches in the forward, want "
            f"{want}; or its logits are not finite")
    return logits


def _pos0_routes(model, prompt, prompt_logits):
    """The prompt's forward (kernel attention) against its teacher-forced
    decode through the cache (plain): max |diff| of the logits at position
    0, where attention has one key; and the forward's logits."""
    full = _forward_checked(model, prompt)
    return float((full[:, 0].float() - prompt_logits[:, 0].float())
                 .abs().max()), full


def _layer_routes(block, x, cfg, layer: int) -> dict:
    """Layer ``layer`` of ``cfg``'s plan (``block``, or its attention
    alone) fed ``x`` by the prefill route (the kernel) and the decode route
    (plain, through the layer's own cache for x's B and P rows) in bf16
    and, with the block's weights in float32, in float32
    (``_mixer_routes``)."""
    import copy
    from repro_torch.models.transformer import _layer_cache_def, _layer_specs
    cache_def = _layer_cache_def(_layer_specs(cfg)[layer], cfg, *x.shape[:2])
    with torch.inference_mode():
        pre, dec = _mixer_routes(block, x, cache_def)
        block32 = copy.deepcopy(block).float()
        pre32, dec32 = _mixer_routes(block32, x.float(), cache_def)
        del block32
    return {"f32": _row_rel(pre32, dec32),
            "bf16_kernel_route": _row_rel(pre, dec32),
            "bf16_plain_route": _row_rel(dec, dec32)}


def _layer_routes_ok(rec: dict, f32_bar: float = LAYER_REL_F32) -> bool:
    return (math.isfinite(rec["f32"]) and rec["f32"] <= f32_bar
            and rec["bf16_kernel_route"] <= 2.0 * rec["bf16_plain_route"])


def _window_band(S: int, W: int, device):
    """The (S, S) boolean mask of ``causal=True, window=W``."""
    s = torch.arange(S, device=device)
    return (s[None, :] <= s[:, None]) & (s[None, :] > s[:, None] - W)


def _gemma3_flash_inputs():
    """Seeded bf16 q, k, v at FLASH_GEMMA3 as (B, S, h, D) activations, and
    their (B, h, S, D) views, which the kernel reads in place."""
    dev = torch.device("cuda")
    B, H, KV, S, D = FLASH_GEMMA3
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev,
                           dtype=torch.bfloat16) for h in (H, KV, KV))
    return (q, k, v), tuple(t.transpose(1, 2) for t in (q, k, v))


def _gemma3_flash_ms(qt, kt, vt) -> dict:
    """The kernel's device time (CUDA events) at gemma3-4b's prefill shape:
    a local layer's windowed launch and a global layer's."""
    from repro_torch.kernels import ops
    return {name: cuda_ms(lambda: ops.flash_attention(
        qt, kt, vt, causal=True, window=window), 10, 2)
        for name, window in (("windowed", GEMMA3_WINDOW), ("global", None))}


def _gemma3_flash_rows() -> dict:
    """flash_attention at gemma3-4b's prefill shapes (FLASH_GEMMA3) bf16,
    read in place from (B, S, H, D) activations: its windowed launch (a
    local layer's, W = GEMMA3_WINDOW) and its global one, each timed by
    CUDA events (the gate: windowed under WINDOW_SHARE_MAX of global) and
    under the profiler (one launch), beside the plain form
    of the same function (``sdpa_local_chunked_plain``;
    ``sdpa_q_chunked_plain``, 2,048 queries a chunk), the bounds, and
    ``F.scaled_dot_product_attention`` on broadcast K/V (with the band as
    an explicit mask for the windowed row; never called by the port)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    dev = torch.device("cuda")
    B, H, KV, S, D = FLASH_GEMMA3
    W = GEMMA3_WINDOW
    (q, k, v), (qt, kt, vt) = _gemma3_flash_inputs()
    ms = _gemma3_flash_ms(qt, kt, vt)
    rows = {}
    for name, window in (("windowed", W), ("global", None)):
        rec = {"shape": [B, H, KV, S, D], "window": window}

        def launch():
            return ops.flash_attention(qt, kt, vt, causal=True,
                                       window=window)
        got = launch()
        rec["ms"] = ms[name]
        # the profiler's device time of one launch (none where its trace
        # shows no device event: it has come back empty on that card late
        # in a long process; the gate reads the CUDA events)
        prof = _profile(launch)
        rec["profiler_device_ms"] = prof["device_ms"] or None
        rec["profiler_kernels"] = prof["top"][:2]
        if window is None:
            rec["plain_ms"] = cuda_ms(lambda: attention.sdpa_q_chunked_plain(
                q, k, v, causal=True, q_chunk=GEMMA3_TAIL), 1)
            pairs = S * (S + 1) // 2
        else:
            rec["plain_ms"] = cuda_ms(
                lambda: attention.sdpa_local_chunked_plain(q, k, v,
                                                           window=W), 1)
            pairs = W * (W + 1) // 2 + (S - W) * W
        torch.cuda.empty_cache()
        qc = qt.contiguous()
        kb, vb = (t.repeat_interleave(H // KV, dim=1).contiguous()
                  for t in (kt, vt))
        band = None if window is None else _window_band(S, W, dev)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qc, kb, vb, attn_mask=band, is_causal=band is None)
        rec["library_ms"] = cuda_ms(library, 5, 1)
        rec["library_max_abs_diff"] = float(
            (library().float() - got.float()).abs().max())
        del qc, kb, vb, band, got
        torch.cuda.empty_cache()
        flops = 4.0 * B * H * D * pairs
        rec.update(pairs=pairs, tflops=flops / rec["ms"] / 1e9,
                   **_bound(2.0 * (2 * B * H * S * D + 2 * B * KV * S * D),
                            flops, BF16_FLOPS))
        rows[name] = rec
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    share = rows["windowed"]["ms"] / rows["global"]["ms"]
    rows["windowed_over_global"] = share
    rows["windowed_over_global_pairs"] = (rows["windowed"]["pairs"]
                                          / rows["global"]["pairs"])
    require(share < WINDOW_SHARE_MAX,
            f"serve_gemma3: a windowed launch takes {share:.3f} of a global "
            f"one's device time, want under {WINDOW_SHARE_MAX}: the kernel "
            "does not skip the tiles outside the band")
    return rows


def phase_serve_gemma3():
    """gemma3-4b at full width and depth in bf16 on the card, weights drawn
    from a seeded generator: 29 local layers (window 1,024) and 5 global
    ones, head dim 256 over 8 heads and 4 kv heads. The main path, with the
    launch counts set to 0 just before it and read just after: prefill of
    1 x 32,768 tokens twice (a local layer's attention is
    ``sdpa_local_chunked``, a global one's ``sdpa``: one flash_attention
    launch each, all on the wgmma route), then SERVE_B requests through the
    KV cache, PROMPT tokens teacher-forced and NEW_TOKENS greedy.

    Then the checks, whose launches are counted apart. (1) Each prefill
    layer's attention on its own bf16 q, k, v against the plain form in
    float32 on them, row by row (FLASH_ROW_REL, and twice the bf16 plain
    form's error): a local layer against ``sdpa_local_chunked_plain``, a
    global one on its last GEMMA3_TAIL query rows against ``sdpa`` with
    ``q_offset``. (2) The first local layer fed the same input (the
    embedded GEMMA3_ROUTES_S tokens) by the prefill route (the kernel's
    window) and the decode route (plain, through the cache, where the
    window masks keys from step 1,024 on): float32 within LAYER_REL_F32,
    bf16 within twice the plain route's error. (3) The prompt's forward
    against its teacher-forced decode at position 0: bf16 within three
    times the bf16-vs-float32 spread there (granite's rule, measured in
    this run), float32 within POS0_REL_F32 of the logits' scale.
    Then flash_attention at the prefill's shapes (``_gemma3_flash_rows``):
    a windowed launch must take under WINDOW_SHARE_MAX of a global one.
    Returns the main path's launch and route counts and those rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.inputs import concrete_batch
    from repro_torch.models import attention
    from repro_torch.models.layers import embed
    from repro_torch.models.transformer import (count_params, decode_step,
                                                init_cache, init_model)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("gemma3-4b")
    require(cfg.n_layers == 34 and cfg.d_model == 2560
            and (GEMMA3_PREFILL_B, cfg.n_heads, cfg.n_kv_heads,
                 GEMMA3_PREFILL_S, cfg.head_dim_) == FLASH_GEMMA3
            and cfg.window_pattern[0] == GEMMA3_WINDOW,
            "serve_gemma3: not gemma3-4b's full width and depth")
    model = init_model(cfg, seed=0, dtype=torch.bfloat16)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == count_params(cfg) == GEMMA3_PARAMS,
            f"serve_gemma3: {n_params} parameters, want {GEMMA3_PARAMS}")
    windows = [blk.mixer.window for blk in model.layers]
    n_local = sum(w is not None for w in windows)
    tokens = concrete_batch(cfg, GEMMA3_PREFILL_B, GEMMA3_PREFILL_S,
                            seed=0)["tokens"]
    prompt = concrete_batch(cfg, SERVE_B, PROMPT, seed=1)["tokens"]

    # ---- the main path: counts from 0 just before it, read just after
    ops.reset_launch_counts()
    main = _lm_main_path(model, cfg, tokens, prompt, NEW_TOKENS, prefills=2)
    main_counts = ops.launch_counts()
    main_routes = ops.route_counts()
    main_windows = ops.window_counts()
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()
    require(n_local == 29 and main_routes["flash_attention"] == {
        "fma": 0, "mma": 0, "wgmma": 2 * cfg.n_layers},
        f"serve_gemma3: {n_local} local layers; the prefills' attention took "
        f"routes {main_routes['flash_attention']}, want wgmma for all 68")
    per_prefill = {"windowed": n_local, "global": cfg.n_layers - n_local}
    require(main["prefill_launches_by_kind"] == [per_prefill] * 2
            and main_windows == {key: 2 * n for key, n in per_prefill.items()},
            f"serve_gemma3: the prefills made "
            f"{main['prefill_launches_by_kind']} launches, want 29 windowed "
            "and 5 global each")
    ops.reset_launch_counts()

    # (1) every prefill layer's attention on its own inputs
    def check(got, q, k, v, causal, window):
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        out = got.transpose(1, 2)
        if window is not None:
            want = attention.sdpa_local_chunked_plain(
                qs.float(), ks.float(), vs.float(), window=window)
            plain = attention.sdpa_local_chunked_plain(qs, ks, vs,
                                                       window=window)
        else:
            off = qs.shape[1] - GEMMA3_TAIL
            want = attention.sdpa(qs[:, off:].float(), ks.float(),
                                  vs.float(), causal=True, q_offset=off)
            plain = attention.sdpa(qs[:, off:], ks, vs, causal=True,
                                   q_offset=off)
            out = out[:, off:]
        return {"window": window, "causal": causal,
                "row_rel_err": _row_rel(out, want),
                "plain_row_rel_err": _row_rel(plain, want),
                "max_abs_err": float((out.float() - want).abs().max())}
    attn = _checked_prefill(model, tokens,
                            {"flash_attention": check})["flash_attention"]
    torch.cuda.empty_cache()

    # (2) the first local layer through both routes, past the window
    layer = windows.index(cfg.window_pattern[0])
    routes_tokens = concrete_batch(cfg, 1, GEMMA3_ROUTES_S,
                                   seed=2)["tokens"]
    with torch.inference_mode():
        x = embed(model.embed, routes_tokens)
    block = model.layers[layer]
    local = _layer_routes(block, x, cfg, layer)
    local["layer"] = layer
    with torch.inference_mode():
        h = block.ln1(x)
        pos = torch.arange(GEMMA3_ROUTES_S, device=x.device)[None]
        banded, _ = block.mixer(h, pos)
        unbanded, _ = attention.gqa_apply(block.mixer, h, pos, cfg,
                                          window=None)
    local["no_window_row_rel"] = _row_rel(unbanded, banded)
    del x, h, banded, unbanded
    torch.cuda.empty_cache()

    # (3) position 0 through both routes, bf16 then float32
    pos0_bf16, full16 = _pos0_routes(model, prompt, main["prompt_logits"])
    logits_max = float(main["prompt_logits"].float().abs().max())
    model.float()
    cache = init_cache(cfg, SERVE_B, PROMPT, torch.float32)
    first32, cache = decode_step(model, cache, {"tokens": prompt[:, :1],
                                                "step": 0})
    full32 = _forward_checked(model, prompt)
    pos0_f32 = float((full32[:, 0] - first32[:, 0]).abs().max())
    bf16_spread = float((full16[:, 0].float() - full32[:, 0]).abs().max())
    del model, cache, full16, full32, first32
    torch.cuda.empty_cache()
    flash_rows = _gemma3_flash_rows()
    rec = {"phase": "serve_gemma3", "arch": cfg.name, "n_params": n_params,
           "dtype": "bfloat16", "init_s": init_s,
           "prefill_shape": [GEMMA3_PREFILL_B, GEMMA3_PREFILL_S],
           "local_layers": n_local, "window": cfg.window_pattern[0],
           **{key: v for key, v in main.items() if key != "prompt_logits"},
           "peak_gb": peak / 1e9, "serve_batch": SERVE_B, "prompt": PROMPT,
           "new_tokens": NEW_TOKENS, "main_path_launches": main_counts,
           "main_path_routes": main_routes,
           "main_path_windows": main_windows,
           "prefill_attention_row_rel_max": max(r["row_rel_err"]
                                                for r in attn),
           "prefill_attention": attn, "local_layer_routes": local,
           "logits_max_abs": logits_max,
           "pos0_max_abs_diff_bf16": pos0_bf16,
           "pos0_bf16_vs_f32_spread": bf16_spread,
           "pos0_max_abs_diff_f32": pos0_f32, "flash": flash_rows,
           "check_launches": ops.launch_counts(),
           "seconds": time.perf_counter() - t0}
    emit(rec)
    require(len(attn) == cfg.n_layers,
            f"serve_gemma3: {len(attn)} launches checked, want "
            f"{cfg.n_layers}")
    require(all(map(flash_bf16_ok, attn)),
            "serve_gemma3: a prefill layer's attention is off its plain form "
            "in float32 by more than FLASH_ROW_REL or twice the bf16 plain "
            "form's error")
    require(_layer_routes_ok(local, GEMMA3_LAYER_REL_F32)
            and local["no_window_row_rel"] > WINDOW_BITES_MIN,
            f"serve_gemma3: the local layer's two routes differ, or its "
            f"window does not bite: {local}")
    require(pos0_bf16 <= 3.0 * bf16_spread
            and pos0_f32 <= POS0_REL_F32 * max(1.0, logits_max),
            f"serve_gemma3: the prompt's forward and decode logits differ at "
            f"position 0 by {pos0_bf16} (bf16; 3 x spread {bf16_spread}) / "
            f"{pos0_f32} (f32)")
    return main_counts, main_routes, flash_rows


def _cuda_tensors_gb() -> list:
    """The largest CUDA tensors still referenced, by size (a diagnosis
    when memory that should be free is not)."""
    import gc
    found = []
    for obj in gc.get_objects():
        try:
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                found.append((obj.numel() * obj.element_size() / 1e9,
                              tuple(obj.shape), str(obj.dtype)))
        except Exception:  # noqa: BLE001 -- objects that refuse inspection
            continue
    return sorted(found, reverse=True)[:8]


def _serve_guard(phase: str) -> int:
    """Frees what the earlier phases left and raises unless under
    SERVE_FREE_BEFORE is still allocated; returns the bytes allocated."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    if before >= SERVE_FREE_BEFORE:
        raise AssertionError(
            f"{phase}: {before / 1e9:.3f} GB allocated before init, want "
            f"under {SERVE_FREE_BEFORE / 1e9:.3f}: {_cuda_tensors_gb()}")
    return before


def _serve_model(phase: str, cfg, n_params: int, prefill_shape,
                 prompt_len: int, warm_up: bool = True):
    """``cfg``'s model in bf16, its weights drawn from seed 0 (its count
    required equal to ``count_params`` and ``n_params``), the prefill's
    tokens (``prefill_shape``, seed 0) and SERVE_B requests of
    ``prompt_len`` tokens (seed 1); with ``warm_up``, one prefill before
    the counted path, so that its time is a warm one (the first call's
    GEMM plans and allocations: deepseek's 0.70 s against ~0.2). The peak
    memory counts from here. Returns the model, the tokens, the prompt and
    the phase's record so far."""
    import gc
    from repro_torch.launch.inputs import concrete_batch
    from repro_torch.models.transformer import (count_params, forward,
                                                init_model)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, dtype=torch.bfloat16)
    sync()
    init_s = time.perf_counter() - t0
    got = sum(p.numel() for p in model.parameters())
    require(got == count_params(cfg) == n_params,
            f"{phase}: {got} parameters, want {n_params}")
    tokens = concrete_batch(cfg, *prefill_shape, seed=0)["tokens"]
    prompt = concrete_batch(cfg, SERVE_B, prompt_len, seed=1)["tokens"]
    if warm_up:
        with torch.inference_mode():
            forward(model, {"tokens": tokens}, mode="prefill")
        sync()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    return model, tokens, prompt, {
        "phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
        "n_params": got, "weight_gb": weight_bytes / 1e9, "dtype": "bfloat16",
        "init_s": init_s, "prefill_shape": list(prefill_shape),
        "serve_batch": SERVE_B, "prompt": prompt_len}


def _serve_main(phase: str, model, cfg, tokens, prompt, new_tokens: int,
                step_bytes: float):
    """The served model's main path (``_lm_main_path``, one prefill), with
    the launch counts set to 0 just before it and read just after (each
    kernel's launches a prefill and a decode step checked there): every
    attention launch on the wgmma route and global, every mlstm_parallel
    launch on wgmma and every slstm_scan launch on cluster. Decode is
    reported beside the step's read of ``step_bytes`` at HBM_BPS. Returns
    the prompt's logits through the cache and the record's fields."""
    from repro_torch.kernels import ops
    # ---- the main path: counts from 0 just before it, read just after
    ops.reset_launch_counts()
    main = _lm_main_path(model, cfg, tokens, prompt, new_tokens, prefills=1)
    counts = ops.launch_counts()
    routes = ops.route_counts()
    windows = ops.window_counts()
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()
    n_attn = attention_layers(cfg)
    require(routes["flash_attention"] == {"fma": 0, "mma": 0, "wgmma": n_attn}
            and windows == {"windowed": 0, "global": n_attn},
            f"{phase}: the prefill's attention took routes "
            f"{routes['flash_attention']} ({windows}), want wgmma and global "
            f"for all {n_attn}")
    # _lm_main_path checked every kernel's launches a prefill and a decode
    # step; here, that xLSTM's took the main path's routes
    require(routes["mlstm_parallel"] == {
                "wgmma": counts["mlstm_parallel"], "mma": 0, "fma": 0}
            and routes["slstm_scan"]["block"] == 0,
            f"{phase}: mlstm_parallel took routes {routes['mlstm_parallel']} "
            f"and slstm_scan {routes['slstm_scan']} on the main path, want "
            "wgmma and cluster only")
    ops.reset_launch_counts()
    bound_ms = 1e3 * step_bytes / HBM_BPS
    prompt_logits = main.pop("prompt_logits")
    return prompt_logits, {
        **main, "new_tokens": new_tokens,
        "decode_step_bytes_gb": step_bytes / 1e9,
        "decode_step_bound_ms": bound_ms,
        "decode_over_bound": main["decode_ms_per_step"] / bound_ms,
        "peak_gb": peak / 1e9, "main_path_launches": counts,
        "main_path_routes": routes, "main_path_windows": windows,
        "logits_max_abs": float(prompt_logits.float().abs().max())}


def _serve_done(rec: dict, t0: float) -> None:
    """Emits the phase's record with the checks' peak memory and launches
    and its seconds."""
    from repro_torch.kernels import ops
    emit({**rec,
          "peak_gb_with_checks": torch.cuda.max_memory_allocated() / 1e9,
          "check_launches": ops.launch_counts(),
          "seconds": time.perf_counter() - t0})


def _serve_free() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_yi():
    """yi-34b at full width and depth in bf16 on the card (68.78 GB of
    weights, the largest dense config that one card holds whole), weights
    drawn from a seeded generator, after every other phase has released its
    tensors (``_serve_guard``). The main path (``_serve_main``): prefill of
    1 x 2,048 tokens (60 flash_attention launches at head dim 128, all on
    the wgmma route), then SERVE_B requests of YI_PROMPT tokens
    teacher-forced and YI_NEW_TOKENS greedy. A float32 copy of the weights
    (137.6 GB) cannot exist, so the checks are: (1) every prefill layer's
    attention on its own bf16 q, k, v against the plain version in float32
    on them (FLASH_ROW_REL, twice the bf16 plain version's error); (2) the
    first and last layers' attention fed the same input by both routes,
    each layer's weights alone in float32 (``_layer_routes``); (3) the
    prompt's forward against its teacher-forced decode at position 0 in
    bf16 (POS0_ATOL_BF16). Decode is reported beside the step's
    weight-read bound."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import embed
    t0 = time.perf_counter()
    before = _serve_guard("serve_yi")
    cfg = get_config("yi-34b")
    require(cfg.n_layers == 60 and cfg.d_model == 7168,
            "serve_yi: not yi-34b's full width and depth")
    model, tokens, prompt, rec = _serve_model(
        "serve_yi", cfg, YI_PARAMS, (YI_PREFILL_B, YI_PREFILL_S), YI_PROMPT,
        warm_up=False)
    prompt_logits, main = _serve_main("serve_yi", model, cfg, tokens, prompt,
                                      YI_NEW_TOKENS, rec["weight_gb"] * 1e9)

    # (1) every prefill layer's attention on its own inputs
    attn = _checked_prefill(model, tokens, {
        "flash_attention": flash_bf16_errors})["flash_attention"]

    # (2) the first and last layers through both routes, on the prompt's
    # hidden states at their depth
    pos = torch.arange(YI_PROMPT, device=prompt.device)[None].expand(
        SERVE_B, YI_PROMPT)
    layers = []
    with torch.inference_mode():
        x = embed(model.embed, prompt)
        for i, block in enumerate(model.layers):
            if i in (0, cfg.n_layers - 1):
                layers.append({"layer": i,
                               **_layer_routes(block, x, cfg, i)})
            x = block(x, pos)[0]
    del x

    # (3) position 0 through both routes, bf16
    pos0_bf16, _ = _pos0_routes(model, prompt, prompt_logits)
    rec.update(main, allocated_before_gb=before / 1e9,
               prefill_attention_row_rel_max=max(r["row_rel_err"]
                                                 for r in attn),
               prefill_attention_plain_row_rel_min=min(
                   r["plain_row_rel_err"] for r in attn),
               layers=layers, pos0_max_abs_diff_bf16=pos0_bf16)
    _serve_done(rec, t0)
    require(len(attn) == cfg.n_layers and all(map(flash_bf16_ok, attn)),
            "serve_yi: a prefill layer's attention is off its plain version "
            "in float32 by more than FLASH_ROW_REL or twice the bf16 plain "
            "version's error")
    require(all(map(_layer_routes_ok, layers)),
            f"serve_yi: a layer's two attention routes differ: {layers}")
    require(pos0_bf16 <= POS0_ATOL_BF16,
            f"serve_yi: the prompt's forward and decode logits differ at "
            f"position 0 by {pos0_bf16} (bf16) > {POS0_ATOL_BF16}")
    del model
    _serve_free()
    return main["main_path_launches"], main["main_path_routes"]


def _flash_errors_by_heads(got, q, k, v, causal=True, window=None,
                           heads: int = MLA_CHECK_HEADS, tail=None) -> dict:
    """``flash_bf16_errors`` taken ``heads`` query heads (with their kv
    heads) at a time, over the last ``tail`` queries where given: each of
    its numbers is a maximum over rows, so the maxima over the chunks are
    the whole tensors' numbers."""
    G = q.shape[1] // k.shape[1]
    require(heads % G == 0, f"{heads} heads a chunk, {G} a kv head")
    recs = [flash_bf16_errors(got[:, h:h + heads], q[:, h:h + heads],
                              k[:, h // G:(h + heads) // G],
                              v[:, h // G:(h + heads) // G], causal, window,
                              tail)
            for h in range(0, q.shape[1], heads)]
    torch.cuda.empty_cache()
    return {key: max(r[key] for r in recs) for key in recs[0]}


def _sdpa_backends(q, k, v) -> dict:
    """``F.scaled_dot_product_attention`` (causal) on q, k, v, each of its
    backends alone: its time, or the reasons it refused (the warnings it
    gave, less PyTorch's source locations)."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            out[name] = "not in this torch"
            continue
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                with sdpa_kernel([backend]):
                    out[name] = {"ms": cuda_ms(
                        lambda: torch.nn.functional.scaled_dot_product_attention(
                            q, k, v, is_causal=True), 5, 1)}
            except RuntimeError as err:
                why = [str(w.message).split(" (Triggered internally")[0]
                       for w in caught] or [str(err).splitlines()[0]]
                out[name] = "refused: " + "; ".join(why)[:600]
        torch.cuda.empty_cache()
    return out


def _mla_flash_rows() -> dict:
    """flash_attention at MLA's prefill shape (FLASH_MLA: q and k 192 wide,
    v 128, causal, read in place from (B, S, H, D) activations): its
    route (wgmma), its rows against the plain version in float32
    (``_flash_errors_by_heads``), its time beside the plain version's
    (bf16), ``F.scaled_dot_product_attention``'s (the default dispatch and
    each backend alone, or why it refused the unequal head dims) and the
    bounds: 2 (DQK + DV) FLOPs a visible (query, key) pair and head against
    q, k, v and o once."""
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    B, H, KV, S, D, Dv = FLASH_MLA
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q, k, v = (torch.randn((B, S, h, d), generator=gen, device=dev,
                           dtype=torch.bfloat16).transpose(1, 2)
               for h, d in ((H, D), (KV, D), (KV, Dv)))
    before = ops.route_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v)
    took = _route_taken(before, ops.route_counts()["flash_attention"])
    rec = {"shape": list(FLASH_MLA), "causal": True, "route": took,
           **_flash_errors_by_heads(got, q, k, v)}
    require(took == "wgmma" and flash_bf16_ok(rec),
            f"flash_attention at MLA's shape: route {took}, {rec}")
    rec["ms"] = ms = cuda_ms(lambda: ops.flash_attention(q, k, v), 20, 3)
    del got
    torch.cuda.empty_cache()
    rec["plain_ms"] = cuda_ms(lambda: ref.flash_attention_ref(q, k, v), 2)
    torch.cuda.empty_cache()
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    rec["sdpa_backends"] = _sdpa_backends(qc, kc, vc)
    try:
        rec["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qc, kc, vc, is_causal=True), 20, 3)
    except RuntimeError as err:
        rec["library_ms"] = None
        rec["library_refused"] = str(err).splitlines()[0][:300]
    del q, k, v, qc, kc, vc
    torch.cuda.empty_cache()
    pairs = S * (S + 1) // 2          # (query, visible key) pairs
    flops = 2.0 * B * H * (D + Dv) * pairs
    nbytes = 2.0 * (B * H * S * D + B * KV * S * (D + Dv) + B * H * S * Dv)
    rec.update(tflops=flops / ms / 1e9,
               flop_bound_ms=1e3 * flops / BF16_FLOPS,
               byte_bound_ms=1e3 * nbytes / HBM_BPS,
               exp_bound_ms=exp_bound_ms(B * H * pairs),
               **_bound(nbytes, flops, BF16_FLOPS))
    return rec


def _f32_tree(module) -> dict:
    """A ParamModule's parameters as a nested dict of float32 copies."""
    tree = {name: _f32_tree(m) for name, m in module.named_children()}
    tree.update({name: p.float()
                 for name, p in module.named_parameters(recurse=False)})
    return tree


def _kept_experts(e, n_experts: int, cap: int):
    """Each token's experts with the ones whose slot dropped as -1,
    sorted: (N, k)."""
    from repro_torch.models import moe
    order, _, _, _, keep = moe._dispatch(e, n_experts, cap)
    kept = torch.empty_like(keep)
    kept[order] = keep
    return torch.sort(torch.where(kept.reshape(e.shape), e, -1), 1).values


def _moe_layer_check(model, cfg, tokens) -> dict:
    """Layer 1's MoE (the first) on the prefill's hidden states at its
    depth, in bf16 and with its weights alone in float32 on the same bf16
    input: how many tokens' top-k expert sets differ, how many slots
    drop in each, and the output row by row over the tokens whose experts
    and kept slots agree (DEEPSEEK_MOE_ROW_REL)."""
    from repro_torch.models import moe
    from repro_torch.models.layers import embed
    blk = model.layers[1]
    require(hasattr(blk, "moe"), "serve_deepseek: layer 1 has no MoE")
    with torch.inference_mode():
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x = model.layers[0](embed(model.embed, tokens), pos)[0]
        x = x + blk.mixer(blk.ln1(x), pos)[0]
        h = blk.ln2(x)
        del x
        y16, aux16 = blk.moe(h)
        p32 = _f32_tree(blk.moe)
        y32, aux32 = moe.moe_apply(p32, h.float(), cfg, act=cfg.act)
        N = B * S
        cap = moe.capacity(cfg, N)
        _, e16, _ = moe._route(blk.moe, h.reshape(N, -1), cfg)
        _, e32, _ = moe._route(p32, h.float().reshape(N, -1), cfg)
        del p32
        same_experts = (torch.sort(e16, 1).values
                        == torch.sort(e32, 1).values).all(1)
        k16 = _kept_experts(e16, cfg.n_experts, cap)
        k32 = _kept_experts(e32, cfg.n_experts, cap)
        agree = same_experts & (k16 == k32).all(1)
        n_agree = int(agree.sum())
        rec = {"tokens": N, "capacity": cap,
               "tokens_whose_experts_differ": int((~same_experts).sum()),
               "tokens_agreeing": n_agree,
               "dropped_slots_bf16": int((k16 < 0).sum()),
               "dropped_slots_f32": int((k32 < 0).sum()),
               "row_rel_agreeing": _row_rel(y16.reshape(N, -1)[agree],
                                            y32.reshape(N, -1)[agree])
               if n_agree else float("nan"),
               "row_rel_all": _row_rel(y16.reshape(N, -1),
                                       y32.reshape(N, -1)),
               "aux_bf16": float(aux16), "aux_f32": float(aux32)}
    torch.cuda.empty_cache()
    return rec


def _attention_only(block):
    """A module of the block's first norm and mixer alone (what
    ``_layer_routes`` copies to float32; an MoE block's experts stay
    out)."""
    att = torch.nn.Module()
    att.ln1, att.mixer = block.ln1, block.mixer
    return att


def phase_serve_deepseek():
    """deepseek-v2-236b at full width in bf16 on the card, cut to
    DEEPSEEK_LAYERS layers (1 dense + 7 MLA + MoE, 58.38 GB: its 60 layers
    are 471 GB), weights drawn from a seeded generator, after every other
    phase has released its tensors (``_serve_guard``). First, before the
    weights, flash_attention at MLA's prefill shape (``_mla_flash_rows``:
    times beside the bounds, the plain version and SDPA). A warm-up
    prefill, then the main path (``_serve_main``): prefill of 1 x 4,096
    tokens (8 flash_attention launches at (192, 128), all on the wgmma
    route, all global), then SERVE_B requests of DEEPSEEK_PROMPT tokens
    teacher-forced through the latent cache (MLA's absorbed decode) and
    DEEPSEEK_NEW_TOKENS greedy. A float32 copy of the model (117 GB)
    cannot exist, so the checks are: (1) every prefill layer's attention
    on its own bf16 q, k, v against the plain version in float32
    (FLASH_ROW_REL, twice the bf16 plain version's error); (2) one MoE
    layer in bf16 against its weights alone in float32 on the same input
    (``_moe_layer_check``); (3) the prompt's first token through the
    forward ((4, 1): the MoE's capacity is set by the same 4 tokens)
    against decode step 0, bf16 (DEEPSEEK_POS0_REL of the logits' scale);
    (4) the last layer's attention fed the prompt's hidden states by the
    prefill form and by the absorbed decode step by step over the same
    cache rows, its weights alone in float32 (DEEPSEEK_MLA_REL_F32; bf16
    recorded). Decode beside the step's weight-read bound."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import embed
    from repro_torch.models.transformer import forward
    t0 = time.perf_counter()
    before = _serve_guard("serve_deepseek")
    flash_rec = _mla_flash_rows()
    full = get_config("deepseek-v2-236b")
    cfg = full.replace(n_layers=DEEPSEEK_LAYERS)
    require(full.n_layers == 60 and cfg.d_model == 5120
            and cfg.n_experts == 160 and cfg.top_k == 6
            and (DEEPSEEK_PREFILL_B, cfg.n_heads, cfg.n_heads,
                 DEEPSEEK_PREFILL_S, cfg.qk_nope_dim + cfg.qk_rope_dim,
                 cfg.v_head_dim) == FLASH_MLA,
            "serve_deepseek: not deepseek-v2-236b's full width")
    model, tokens, prompt, rec = _serve_model(
        "serve_deepseek", cfg, DEEPSEEK_PARAMS,
        (DEEPSEEK_PREFILL_B, DEEPSEEK_PREFILL_S), DEEPSEEK_PROMPT)
    prompt_logits, main = _serve_main(
        "serve_deepseek", model, cfg, tokens, prompt, DEEPSEEK_NEW_TOKENS,
        rec["weight_gb"] * 1e9)

    # (1) every prefill layer's attention on its own inputs, at (192, 128)
    attn = _checked_prefill(model, tokens, {
        "flash_attention": lambda got, q, k, v, causal=True, window=None: {
            "dims": [q.shape[-1], v.shape[-1]],
            **_flash_errors_by_heads(got, q, k, v, causal, window)}
    })["flash_attention"]

    # (2) the first MoE layer, bf16 against its weights in float32
    moe_rec = _moe_layer_check(model, cfg, tokens)

    # (3) the prompt's first token: a (4, 1) forward against decode step 0
    with torch.inference_mode():
        fwd, _ = forward(model, {"tokens": prompt[:, :1]})
    dec0 = prompt_logits[:, 0].float()
    pos0_rel = float((fwd[:, 0].float() - dec0).abs().max()
                     / dec0.abs().max())

    # (4) the last layer's attention by both forms on the prompt's hidden
    # states at its depth
    last = cfg.n_layers - 1
    pos = torch.arange(DEEPSEEK_PROMPT, device=prompt.device)[None].expand(
        SERVE_B, DEEPSEEK_PROMPT)
    with torch.inference_mode():
        x = embed(model.embed, prompt)
        for block in model.layers[:last]:
            x = block(x, pos)[0]
        mla = _layer_routes(_attention_only(model.layers[last]), x, cfg,
                            last)
    del x
    rec.update(main, n_layers_published=full.n_layers,
               allocated_before_gb=before / 1e9,
               prefill_attention_row_rel_max=max(r["row_rel_err"]
                                                 for r in attn),
               prefill_attention_plain_row_rel_min=min(
                   r["plain_row_rel_err"] for r in attn),
               moe_layer=moe_rec, mla_layer={"layer": last, **mla},
               pos0_rel_diff_bf16=pos0_rel, mla_flash=flash_rec)
    _serve_done(rec, t0)
    require(len(attn) == cfg.n_layers and all(map(flash_bf16_ok, attn))
            and all(r["dims"] == [192, 128] for r in attn),
            "serve_deepseek: a prefill layer's attention is off its plain "
            "version in float32 by more than FLASH_ROW_REL or twice the bf16 "
            "plain version's error, or not at (192, 128)")
    require(moe_rec["tokens_agreeing"] >= DEEPSEEK_MOE_AGREE_MIN * moe_rec[
        "tokens"] and moe_rec["row_rel_agreeing"] <= DEEPSEEK_MOE_ROW_REL,
            f"serve_deepseek: the MoE layer in bf16 is off its float32 "
            f"weights: {moe_rec}")
    require(math.isfinite(pos0_rel) and pos0_rel <= DEEPSEEK_POS0_REL,
            f"serve_deepseek: the (4, 1) forward and decode step 0 differ "
            f"by {pos0_rel} of the logits' scale > {DEEPSEEK_POS0_REL}")
    require(math.isfinite(mla["f32"]) and mla["f32"] <= DEEPSEEK_MLA_REL_F32,
            f"serve_deepseek: the MLA layer's absorbed decode is off its "
            f"prefill form in float32: {mla}")
    del model
    _serve_free()
    return main["main_path_launches"], main["main_path_routes"], flash_rec


def _scan_inputs(B: int, S: int, Din: int, St: int, dtype, seed: int,
                 state: bool = False):
    """Seeded inputs of the selective scan on the card: u ~ N(0, 1), dt =
    softplus(N(0, 1)) (as the model's), A = -exp(1 + N(0, 1) / 2) (around
    the init's -e), B and C ~ N(0, 1); with ``state``, h0 ~ N(0, 1)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    u = draw(B, S, Din).to(dtype)
    dt = torch.nn.functional.softplus(draw(B, S, Din)).to(dtype)
    A = -torch.exp(1.0 + 0.5 * draw(Din, St))
    Bp, Cp = draw(B, S, St).to(dtype), draw(B, S, St).to(dtype)
    return u, dt, A, Bp, Cp, (draw(B, Din, St) if state else None)


def _row_rels(got, want):
    """Each row's max |got - want| / max |want| (a row: the last axis)."""
    w = want.float()
    err = (got.float() - w).abs().amax(-1)
    return (err / w.abs().amax(-1).clamp_min(1e-30)).flatten()


#: a row's allowance beside twice the bf16 plain version's error on it:
#: one bf16 ulp of the row's largest element is at most 2^-7 of it, so a
#: kernel that rounds one element of a row apart from the plain version
#: moves the row's error by up to that
BF16_ROW_ULP = 2.0 ** -7


def _bf16_errors(got, want, plain) -> dict:
    """A bf16 kernel's output against the plain version in float32 on the
    same inputs, row by row (the largest and the median row, and the
    share of rows off by more than twice the plain version's error on the
    same row plus BF16_ROW_ULP), beside the plain version's own error in
    bf16."""
    mine, own = _row_rels(got, want), _row_rels(plain, want)
    return {"row_rel_err": float(mine.max()),
            "rows_over_plain": float(
                (mine > 2.0 * own + BF16_ROW_ULP).float().mean()),
            "plain_row_rel_err": float(own.max()),
            "median_row_rel_err": float(mine.median()),
            "plain_median_row_rel_err": float(own.median()),
            "max_abs_diff_bf16_plain": float(
                (got.float() - plain.float()).abs().max())}


def _bf16_ok(rec: dict, bar: float, measure: str = "row_rel_err") -> bool:
    """``rec[measure]`` within ``bar``, and the largest row's error within
    twice the bf16 plain version's."""
    return (math.isfinite(rec["row_rel_err"]) and rec[measure] <= bar
            and rec["row_rel_err"] <= 2.0 * rec["plain_row_rel_err"])


def _scan_bf16_errors(got, u, dt, A, Bp, Cp, h0=None) -> dict:
    """A bf16 scan's output ``got`` against the plain version run in
    float32 on the same inputs (``_bf16_errors``), as
    ``flash_bf16_errors`` holds attention."""
    from repro_torch.kernels import ref
    want, _ = ref.selective_scan_ref(u.float(), dt.float(), A, Bp.float(),
                                     Cp.float(), h0)
    plain, _ = ref.selective_scan_ref(u, dt, A, Bp, Cp, h0)
    return _bf16_errors(got, want, plain)


def _scan_bf16_ok(rec: dict) -> bool:
    return _bf16_ok(rec, JAMBA_SCAN_ROW_REL)


#: the scan's checks before the weights: (B, S, Din, with a state): a
#: ragged S (1,000: not a multiple of the kernel's 64-step rounds) and a
#: ragged Din (200: the last block's channels masked), the decode step
#: from a nonzero state (S = 1, B = 4, the prefill's width) and a
#: 4,096-step run at the prefill's width
SCAN_CASES = ((2, 1000, 512, False), (4, 777, 200, True),
              (4, 1, 8192, True), (1, 4096, 8192, False))


def _scan_rows() -> dict:
    """selective_scan against its plain version on the card, float32 and
    bf16 (SCAN_CASES: the float32 outputs and final states within
    SCAN_F32_REL row by row; bf16 by ``_scan_bf16_ok``, the state within
    SCAN_F32_REL of the plain version's on the same bf16 inputs), then its
    time at the main path's prefill (SCAN_PREFILL) and decode
    (SCAN_DECODE) shapes beside the bound (the exps on the SFU; the bytes
    of u, dt and y), and the plain version's at SCAN_PLAIN_S steps."""
    from repro_torch.kernels import ops, ref
    checks, f32_err = [], 0.0
    for i, (B, S, Din, state) in enumerate(SCAN_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            u, dt, A, Bp, Cp, h0 = _scan_inputs(B, S, Din, 16, dtype, i,
                                                state)
            h_out = torch.empty((B, Din, 16), device="cuda")
            before = ops.launch_counts()["selective_scan"]
            got = ops.selective_scan(u, dt, A, Bp, Cp, h0, h_out)
            require(ops.launch_counts()["selective_scan"] == before + 1,
                    "selective_scan did not launch its kernel")
            want, h_want = ref.selective_scan_ref(u, dt, A, Bp, Cp, h0)
            rec = {"shape": [B, S, Din, 16], "h0": state,
                   "dtype": str(dtype).replace("torch.", ""),
                   "state_row_rel": _row_rel(h_out, h_want)}
            if dtype == torch.float32:
                rec["row_rel"] = _row_rel(got, want)
                rec["max_abs_err"] = float((got - want).abs().max())
                f32_err = max(f32_err, rec["max_abs_err"])
                ok = rec["row_rel"] <= SCAN_F32_REL
            else:
                rec.update(_scan_bf16_errors(got, u, dt, A, Bp, Cp, h0))
                ok = _scan_bf16_ok(rec)
            checks.append(rec)
            require(ok and rec["state_row_rel"] <= SCAN_F32_REL,
                    f"selective_scan against its plain version: {rec}")
            del u, dt, A, Bp, Cp, h0, h_out, got, want, h_want
    torch.cuda.empty_cache()
    # the main path's shapes: its prefill (bf16 and float32) and decode
    B, S, Din, St = SCAN_PREFILL
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        u, dt, A, Bp, Cp, _ = _scan_inputs(B, S, Din, St, dtype, 10)
        name = str(dtype).replace("torch.", "")
        times[f"ms_{name}"] = cuda_ms(
            lambda: ops.selective_scan(u, dt, A, Bp, Cp), 10, 2)
        if dtype == torch.bfloat16:
            # the first SCAN_PLAIN_S steps, the plain version in bf16 and
            # float32 (the kernel's rows there against it)
            head = [t[:, :SCAN_PLAIN_S] for t in (u, dt, Bp, Cp)]
            got = ops.selective_scan(u, dt, A, Bp, Cp)[:, :SCAN_PLAIN_S]
            plain, _ = ref.selective_scan_ref(head[0], head[1], A, head[2],
                                              head[3])
            times["prefill_head"] = {
                "steps": SCAN_PLAIN_S,
                "max_abs_diff_bf16_plain": float(
                    (got.float() - plain.float()).abs().max()),
                **_scan_bf16_errors(got, head[0], head[1], A, head[2],
                                    head[3])}
            require(_scan_bf16_ok(times["prefill_head"]),
                    f"selective_scan at the prefill's shape: {times}")
            times["plain_ms"] = cuda_ms(lambda: ref.selective_scan_ref(
                head[0], head[1], A, head[2], head[3]), 2, 1)
            del head, got, plain
        del u, dt, A, Bp, Cp
        torch.cuda.empty_cache()
    Bd, Sd, Dd, Std = SCAN_DECODE
    u, dt, A, Bp, Cp, h = _scan_inputs(Bd, Sd, Dd, Std, torch.bfloat16, 11,
                                       True)
    times["decode_ms"] = cuda_ms(
        lambda: ops.selective_scan(u, dt, A, Bp, Cp, h, h), 200, 5)
    times["decode_graph_ms"] = graph_ms(
        lambda: ops.selective_scan(u, dt, A, Bp, Cp, h, h), 200)
    exps = B * S * Din * St
    nbytes = 2.0 * 3 * B * S * Din + 2.0 * 2 * B * S * St + 4.0 * Din * St
    exp_ms = exp_bound_ms(exps)
    byte_ms = 1e3 * nbytes / HBM_BPS
    dec_bytes = 2.0 * 3 * Bd * Dd + 2.0 * 2 * Bd * Std + 4.0 * Dd * Std \
        + 2 * 4.0 * Bd * Dd * Std
    dec_exp_ms = exp_bound_ms(Bd * Sd * Dd * Std)
    dec_byte_ms = 1e3 * dec_bytes / HBM_BPS
    return {"shape": list(SCAN_PREFILL), "checks": checks,
            "max_abs_err": f32_err, "ms": times["ms_bfloat16"],
            "plain_ms": times["plain_ms"], "plain_steps": SCAN_PLAIN_S,
            "bound_ms": max(exp_ms, byte_ms),
            "bound_by": "operations" if exp_ms >= byte_ms else "bytes",
            "exp_bound_ms": exp_ms, "byte_bound_ms": byte_ms,
            "library_ms": None, **times,
            "decode_shape": list(SCAN_DECODE),
            "decode_bound_ms": max(dec_exp_ms, dec_byte_ms),
            "decode_bound_by": "operations" if dec_exp_ms >= dec_byte_ms
            else "bytes"}


def _scan_head_tail_errors(got, u, dt, A, Bp, Cp, h0=None, h_out=None,
                           W: int = JAMBA_CHECK_S) -> dict:
    """A prefill scan's output ``got`` on its own bf16 inputs
    (``_scan_bf16_errors``): its first W positions against the plain
    version from zero; and its last W against the plain version started
    from the kernel's state after the first S - W positions (one more
    launch, ``h_out``), where a drift that shows only late would show."""
    from repro_torch.kernels.selective_scan import selective_scan
    S = u.shape[1]
    head = _scan_bf16_errors(got[:, :W], u[:, :W], dt[:, :W], A, Bp[:, :W],
                             Cp[:, :W])
    h = torch.empty((u.shape[0], u.shape[2], A.shape[1]), device=u.device)
    selective_scan(*(t[:, :S - W].contiguous() for t in (u, dt)), A,
                   *(t[:, :S - W].contiguous() for t in (Bp, Cp)), h_out=h)
    tail = _scan_bf16_errors(got[:, S - W:], u[:, S - W:], dt[:, S - W:], A,
                             Bp[:, S - W:], Cp[:, S - W:], h)
    return {"head": head, "tail": tail}


def phase_serve_jamba():
    """jamba-v0.1-52b at full width in bf16 on the card, cut to
    JAMBA_LAYERS layers (two period-8 blocks: 2 NoPE GQA + 14 mamba
    layers, 8 MoE; 52.1 GB: its 32 layers are 103.1 GB), weights drawn
    from a seeded generator, after every other phase has released its
    tensors (``_serve_guard``). First, before the weights, selective_scan
    against its plain version and timed (``_scan_rows``). A warm-up
    prefill, then the main path (``_serve_main``): prefill of 1 x 32,768
    tokens (2 flash_attention launches, wgmma and global, and 14
    selective_scan launches), then SERVE_B requests of JAMBA_PROMPT tokens
    teacher-forced through the cache and JAMBA_NEW_TOKENS greedy (14
    selective_scan launches a step). A float32 copy of the model cannot
    exist beside it, so the checks are: (1) one prefill with every kernel
    launch held on its own bf16 inputs (``_checked_prefill``): each
    attention layer's last JAMBA_CHECK_S queries against all 32,768 keys
    (FLASH_ROW_REL, twice the bf16 plain version's error), each mamba
    layer's scan at its first and last JAMBA_CHECK_S positions
    (``_scan_head_tail_errors``; JAMBA_SCAN_ROW_REL and twice the bf16
    plain version's error); (2) the first mamba layer fed the prompt's
    embeddings by the prefill form and by decode step by step through its
    cache, its weights alone in float32 (JAMBA_LAYER_REL_F32; bf16
    recorded); (3) the prompt's first token through the forward ((4, 1))
    against decode step 0, bf16 (JAMBA_POS0_REL of the logits' scale); (4)
    the main path's tokens in range and logits finite (``_lm_main_path``).
    Decode beside the step's weight-read bound (every weight but the
    embedding table, of which a step reads 4 rows)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import embed
    from repro_torch.models.transformer import _layer_specs, forward
    t0 = time.perf_counter()
    before = _serve_guard("serve_jamba")
    scan_rec = _scan_rows()
    full = get_config("jamba-v0.1-52b")
    cfg = full.replace(n_layers=JAMBA_LAYERS)
    Din = cfg.mamba_expand * cfg.d_model
    n_attn, n_mamba = attention_layers(cfg), mamba_layers(cfg)
    require(full.n_layers == 32 and cfg.d_model == 4096
            and cfg.n_experts == 16 and cfg.rope_kind == "none"
            and (JAMBA_PREFILL_B, JAMBA_PREFILL_S, Din,
                 cfg.mamba_d_state) == SCAN_PREFILL
            and (n_attn, n_mamba) == (2, 14),
            "serve_jamba: not jamba-v0.1-52b's full width")
    model, tokens, prompt, rec = _serve_model(
        "serve_jamba", cfg, JAMBA_PARAMS, (JAMBA_PREFILL_B, JAMBA_PREFILL_S),
        JAMBA_PROMPT)
    table = model.embed.table
    prompt_logits, main = _serve_main(
        "serve_jamba", model, cfg, tokens, prompt, JAMBA_NEW_TOKENS,
        rec["weight_gb"] * 1e9 - table.numel() * table.element_size())

    # (1) every prefill layer's attention and scan on its own inputs
    checked = _checked_prefill(model, tokens, {
        "flash_attention": lambda got, q, k, v, causal=True, window=None:
            _flash_errors_by_heads(got, q, k, v, causal, window,
                                   JAMBA_CHECK_HEADS, JAMBA_CHECK_S),
        "selective_scan": _scan_head_tail_errors})
    attn, scans = checked["flash_attention"], checked["selective_scan"]

    # (2) the first mamba layer by both forms on the prompt's embeddings
    first = next(i for i, spec in enumerate(_layer_specs(cfg))
                 if spec.mixer == "mamba")
    with torch.inference_mode():
        x = embed(model.embed, prompt)
        layer = _layer_routes(_attention_only(model.layers[first]), x, cfg,
                              first)
    del x

    # (3) the prompt's first token: a (4, 1) forward against decode step 0
    with torch.inference_mode():
        fwd, _ = forward(model, {"tokens": prompt[:, :1]})
    dec0 = prompt_logits[:, 0].float()
    pos0_rel = float((fwd[:, 0].float() - dec0).abs().max()
                     / dec0.abs().max())
    rec.update(main, n_layers_published=full.n_layers,
               attention_layers=n_attn, mamba_layers=n_mamba,
               allocated_before_gb=before / 1e9,
               prefill_attention_tail=JAMBA_CHECK_S,
               prefill_attention=attn,
               prefill_scan_head_row_rel_max=max(
                   r["head"]["row_rel_err"] for r in scans),
               prefill_scan_tail_row_rel_max=max(
                   r["tail"]["row_rel_err"] for r in scans),
               prefill_scan_plain_row_rel_min=min(
                   min(r["head"]["plain_row_rel_err"],
                       r["tail"]["plain_row_rel_err"]) for r in scans),
               prefill_scans=scans, mamba_layer={"layer": first, **layer},
               pos0_rel_diff_bf16=pos0_rel, scan=scan_rec)
    _serve_done(rec, t0)
    require(len(attn) == n_attn and all(map(flash_bf16_ok, attn)),
            "serve_jamba: a prefill layer's attention, over its last "
            "JAMBA_CHECK_S queries, is off its plain version in float32 by "
            "more than FLASH_ROW_REL or twice the bf16 plain version's error")
    require(len(scans) == n_mamba
            and all(_scan_bf16_ok(r[k]) for r in scans
                    for k in ("head", "tail")),
            "serve_jamba: a prefill layer's scan is off its plain version "
            "in float32 by more than JAMBA_SCAN_ROW_REL or twice the bf16 "
            "plain version's error, at its head or its tail")
    require(math.isfinite(layer["f32"])
            and layer["f32"] <= JAMBA_LAYER_REL_F32,
            f"serve_jamba: the mamba layer's decode is off its prefill form "
            f"in float32: {layer}")
    require(math.isfinite(pos0_rel) and pos0_rel <= JAMBA_POS0_REL,
            f"serve_jamba: the (4, 1) forward and decode step 0 differ by "
            f"{pos0_rel} of the logits' scale > {JAMBA_POS0_REL}")
    del model
    _serve_free()
    return main["main_path_launches"], main["main_path_routes"], scan_rec


#: xlstm-125m at its full width and depth ([mlstm, slstm] x 6, d 768, 4
#: heads, mLSTM head dim 384, vocab 50,304, tied): the reference's count
#: (``tests/test_torch_xlstm.py`` holds the constant to it)
XLSTM_PARAMS = 123_656_496
#: its prefill (``prefill_32k``'s length, one sequence: xLSTM's users send
#: long prompts, its states are fixed-size); its requests' prompt and new
#: tokens
XLSTM_PREFILL_B, XLSTM_PREFILL_S = 1, 32768
XLSTM_PROMPT, XLSTM_NEW_TOKENS = 16, 16
#: the kernels at the main path's prefill: mlstm_parallel (B, S, H, dh) and
#: slstm_scan (B, S, D), bf16, and slstm_scan's decode step (the 4
#: requests, one token)
MLSTM_PREFILL = (1, 32768, 4, 384)
SLSTM_PREFILL = (1, 32768, 768)
SLSTM_DECODE = (4, 1, 768)
#: rows (mLSTM) and positions (sLSTM) of a prefill layer held to the plain
#: version, at its head and its tail: the plain mLSTM form materialises
#: (rows, keys, H) float32 tensors (1.07 GB each at 2,048 x 32,768 x 4),
#: the plain sLSTM loop is ~15 launches a step
XLSTM_CHECK_S = 2048
#: the kernels against the plain version on the same float32 inputs, row
#: by row: the sums run in other orders
XLSTM_F32_REL = 1e-5
#: a bf16 slstm_scan against the plain version run in float32 on the same
#: bf16 inputs, row by row: the plain version's own bf16-against-f32 gap at
#: SMOKE size on the model's inputs is 0.0079-0.0089 (seeds 0-2,
#: ``tests/test_torch_xlstm.py``; the rounding of r, z, o and h to bf16 a
#: step); three times that. The kernel must also come within twice the
#: bf16 plain version's own error
SLSTM_ROW_REL = 0.03
#: mlstm_parallel's bf16 rows against the plain version in float32, every
#: row held (``_mlstm_ok``). On the model's inputs the plain version's own
#: largest row error is 0.13-0.20 at SMOKE size and up to 6.2 at full
#: width (rows whose |sum_j sw| cancels: the reference rounds sw and num
#: to bf16, then divides by that small den), so no absolute bar holds the
#: largest row there; instead every row is held to twice the bf16 plain
#: version's error on that same row plus BF16_ROW_ULP (on the card no row
#: of any check went beyond it, on the model's inputs or the seeded ones);
#: the median row, 0.0043-0.0053 at both widths, within
#: MLSTM_MEDIAN_ROW_REL (about three times), and the largest within twice
#: the plain version's largest. On the seeded inputs (``_mlstm_inputs``:
#: scores ~ N(0, 1), no such cancellation) the plain version's largest row
#: is 0.0108-0.0176 at both widths, so there the largest row is held to
#: MLSTM_ROW_REL too
MLSTM_MEDIAN_ROW_REL = 0.015
MLSTM_ROW_REL = 0.04
#: one xLSTM layer fed the same float32 input by the prefill form (the
#: kernel) and by decode step by step through its cache, its weights alone
#: in float32, row by row, by mixer: the reference's own gap on the CPU at
#: full width is 7.7e-5-2.3e-4 (mLSTM: the parallel form's den sums S
#: terms that cancel, the recurrent one carries n) and 9.0e-7-1.1e-6
#: (sLSTM) (seeds 0-2, 16 tokens of 4 requests); about twice the largest
XLSTM_LAYER_REL_F32 = {"mlstm": 5e-4, "slstm": 1e-5}
#: the (4, 1) forward against decode step 0 of the 4 requests, with the
#: whole model in float32 (0.49 GB), max |diff| over the logits' largest
#: magnitude: the reference's own gap at full width on the CPU is
#: 3.9e-6-6.6e-5 (seeds 0-2); about twice the largest. The bf16 model,
#: on the main path's kernels, within XLSTM_POS0_REL: the reference's own
#: gap at full width in bf16 is 0.0124-0.0324 (seeds 0-2); about twice
#: the largest. ``tests/test_torch_xlstm.py`` holds both bars to the gaps
XLSTM_POS0_REL_F32 = 1.5e-4
XLSTM_POS0_REL = 0.07
#: the kernels' checks before the weights: mlstm_parallel (B, S, H, dh)
#: and slstm_scan (B, S, D, from a carry): tails past the 64- and 16-row
#: tiles, B > 1, both widths, and the decode step; mlstm_parallel's bf16
#: cases at dh = 384 on its chosen route (wgmma) and the forced mma route
MLSTM_CASES = ((2, 100, 2, 64), (3, 1000, 4, 384), (1, 777, 4, 384))
SLSTM_CASES = ((2, 300, 64, False), (3, 257, 768, True), (4, 1, 768, True))
#: the previous design of slstm_scan's cluster route (8 blocks, rz in shared
#: memory, a cluster barrier a step), us a step at SLSTM_PREFILL, as
#: ``chip_slstm_phases.py`` timed its copy beside the redesigned route on
#: an H100 (80GB HBM3, 700 W) in four runs: 3.503-3.530, median 3.507
SLSTM_PARENT_US_PER_STEP = 3.5070


def _mlstm_inputs(B: int, S: int, H: int, dh: int, dtype, seed: int):
    """Seeded mlstm_parallel inputs on the card, as the model makes them:
    q, k, v ~ N(0, 1); logi ~ N(0, 0.1^2) (the input gate's 0.02 init, zero
    bias); logf = log_sigmoid(1 + N(0, 0.1^2)) (its ones bias)."""
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    q, k, v = (draw(B, S, H, dh).to(dtype) for _ in range(3))
    return q, k, v, 0.1 * draw(B, S, H), ref.log_sigmoid_ref(
        1.0 + 0.1 * draw(B, S, H))


def _slstm_inputs(B: int, S: int, D: int, dtype, seed: int,
                  carry: bool = False):
    """Seeded slstm_scan inputs on the card, as the model makes them: the
    four gate inputs as views of one (B, S, 4 D) projection ~ N(0, 1) (gi
    and gf at the init's 0.02 scale times sqrt(D)), rz ~ N(0, 0.02^2), bf
    ones; with ``carry`` a nonzero (c, n, h, m)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    g = draw(B, S, 4 * D)
    g[..., D:3 * D] *= 0.02 * D ** 0.5
    gates = g.to(dtype).split(D, dim=-1)
    rz = (0.02 * draw(D, D)).to(dtype)
    bf = torch.ones(D, device="cuda", dtype=dtype)
    c0 = (draw(B, D), draw(B, D).abs() + 1.0, (0.5 * draw(B, D)).to(dtype),
          0.1 * draw(B, D)) if carry else None
    return (*gates, rz, bf, c0)


def _slstm_carry(B: int, D: int, dtype):
    return tuple(torch.empty((B, D), device="cuda",
                             dtype=dtype if k == 2 else torch.float32)
                 for k in range(4))


def _mlstm_ok(rec: dict, row_bar: float = math.inf) -> bool:
    """A bf16 mlstm_parallel record (``_bf16_errors``) held row by row:
    no row off by more than twice the bf16 plain version's error on the
    same row plus BF16_ROW_ULP, its median row within
    MLSTM_MEDIAN_ROW_REL, and its largest within twice the plain
    version's largest and within ``row_bar``."""
    return (_bf16_ok(rec, MLSTM_MEDIAN_ROW_REL, "median_row_rel_err")
            and rec["rows_over_plain"] == 0.0
            and rec["row_rel_err"] <= row_bar)


def _mlstm_rows_errors(got, q, k, v, logi, logf, rows) -> dict:
    """Rows ``rows`` of a bf16 mlstm_parallel output against the plain
    version there, in float32 and in bf16 on the same inputs."""
    from repro_torch.kernels import ref
    a, b = rows
    want = ref.mlstm_parallel_ref(q.float(), k.float(), v.float(), logi,
                                  logf, rows)
    plain = ref.mlstm_parallel_ref(q, k, v, logi, logf, rows)
    rec = _bf16_errors(got[:, a:b], want, plain)
    del want, plain
    torch.cuda.empty_cache()
    return rec


def _mlstm_head_tail_errors(got, q, k, v, logi, logf,
                            W: int = XLSTM_CHECK_S) -> dict:
    """A prefill layer's mlstm_parallel on its own bf16 inputs: its first
    and its last W query rows (the latter against all S keys)."""
    S = q.shape[1]
    return {"head": _mlstm_rows_errors(got, q, k, v, logi, logf, (0, W)),
            "tail": _mlstm_rows_errors(got, q, k, v, logi, logf, (S - W, S))}


def kernel_ptxas(log: str, word: str) -> list:
    """The ``ptxas -v`` lines (registers, spills, stack) of the kernels
    whose mangled names hold ``word`` in an ``nvcc -Xptxas -v`` log."""
    out, on = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            on = word in ln
        if on and ("registers" in ln or "spill" in ln):
            out.append(ln.split(":", 1)[-1].strip())
    return out


def _slstm_routes_bitwise(got, out, args, carry) -> bool:
    """slstm_scan's output ``got`` and final carry ``out`` bit for bit those
    of its block route on the same inputs ``args`` (gz .. bf) from
    ``carry``."""
    from repro_torch.kernels import ops
    want_out = _slstm_carry(got.shape[0], got.shape[2], got.dtype)
    want = ops.slstm_scan(*args, carry, want_out, _route="block")
    return bool(torch.equal(got, want)) and all(
        torch.equal(a, b) for a, b in zip(out, want_out))


def _slstm_errors(got, gz, gi, gf, go, rz, bf, carry=None) -> dict:
    """A bf16 slstm_scan's output ``got`` against the plain loop in float32
    and in bf16 on the same inputs, from ``carry``."""
    from repro_torch.kernels import ref
    c32 = None if carry is None else (carry[0], carry[1], carry[2].float(),
                                      carry[3])
    want, _ = ref.slstm_scan_ref(*(t.float() for t in (gz, gi, gf, go, rz,
                                                        bf)), c32)
    plain, _ = ref.slstm_scan_ref(gz, gi, gf, go, rz, bf, carry)
    return _bf16_errors(got, want, plain)


def _slstm_head_tail_errors(got, gz, gi, gf, go, rz, bf, carry=None,
                            carry_out=None, W: int = XLSTM_CHECK_S) -> dict:
    """A prefill layer's slstm_scan on its own bf16 inputs
    (``_slstm_errors``): its first W positions from zero, and its last W
    from the kernel's own carry after the first S - W positions (one more
    launch), where a drift that shows only late would show."""
    from repro_torch.kernels.slstm import slstm_scan
    S = gz.shape[1]
    gates = (gz, gi, gf, go)
    head = _slstm_errors(got[:, :W], *(g[:, :W] for g in gates), rz, bf)
    c = _slstm_carry(gz.shape[0], gz.shape[2], gz.dtype)
    slstm_scan(*(g[:, :S - W] for g in gates), rz, bf, carry_out=c)
    tail = _slstm_errors(got[:, S - W:], *(g[:, S - W:] for g in gates), rz,
                         bf, c)
    return {"head": head, "tail": tail}


def _xlstm_kernel_rows() -> dict:
    """mlstm_parallel and slstm_scan against their plain versions on the
    card, float32 and bf16 (MLSTM_CASES, SLSTM_CASES; float32 within
    XLSTM_F32_REL row by row, bf16 by ``_mlstm_ok`` with MLSTM_ROW_REL
    and ``_bf16_ok``; mlstm_parallel's bf16 cases at dh = 384 on its
    wgmma route and the forced mma route, both also timed and checked at
    the prefill's shape;
    slstm_scan's cluster route, every bf16 launch at D = 768, bit for bit
    its block route, outputs and carry), then timed at the main
    path's prefill shapes beside their bounds and their plain versions
    (mLSTM's over the last XLSTM_CHECK_S rows, against all keys; sLSTM's
    over its first XLSTM_CHECK_S steps), sLSTM's decode step too, and
    each kernel's head and tail rows at the prefill's shape held like the
    main path's layers; beside sLSTM's time, its cluster route's serial
    chain alone (the ``slstm_chain`` build: the wait for h, the dot, the
    shuffles and the hand-over of h a step, no gate math), the floor of
    that design, the cluster kernel's ``ptxas -v`` lines, and the parent
    design's recorded step (SLSTM_PARENT_US_PER_STEP)."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.mlstm import route as mlstm_route
    m_checks, s_checks, m_err, s_err = [], [], 0.0, 0.0
    for i, (B, S, H, dh) in enumerate(MLSTM_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            args = _mlstm_inputs(B, S, H, dh, dtype, 20 + i)
            took = mlstm_route(dtype, dh)
            for forced in (None, "mma") if took == "wgmma" else (None,):
                before = ops.route_counts()["mlstm_parallel"]
                got = ops.mlstm_parallel(*args, _route=forced)
                require(ops.route_counts()["mlstm_parallel"][forced or took]
                        == before[forced or took] + 1,
                        "mlstm_parallel did not launch its kernel")
                rec = {"shape": [B, S, H, dh], "route": forced or took,
                       "dtype": str(dtype).replace("torch.", "")}
                if dtype == torch.float32:
                    want = ref.mlstm_parallel_ref(*args)
                    rec["row_rel"] = _row_rel(got, want)
                    rec["max_abs_err"] = float((got - want).abs().max())
                    m_err = max(m_err, rec["max_abs_err"])
                    ok = rec["row_rel"] <= XLSTM_F32_REL
                else:
                    rec.update(_mlstm_rows_errors(got, *args, (0, S)))
                    ok = _mlstm_ok(rec, MLSTM_ROW_REL)
                m_checks.append(rec)
                require(ok, f"mlstm_parallel against its plain version: "
                        f"{rec}")
    for i, (B, S, D, carry) in enumerate(SLSTM_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            *args, c0 = _slstm_inputs(B, S, D, dtype, 30 + i, carry)
            out = _slstm_carry(B, D, dtype)
            before = ops.launch_counts()["slstm_scan"]
            got = ops.slstm_scan(*args, c0, out)
            require(ops.launch_counts()["slstm_scan"] == before + 1,
                    "slstm_scan did not launch its kernel")
            rec = {"shape": [B, S, D], "carry": carry,
                   "dtype": str(dtype).replace("torch.", "")}
            if dtype == torch.float32:
                want, last = ref.slstm_scan_ref(*args, c0)
                rec["row_rel"] = _row_rel(got, want)
                rec["carry_row_rel"] = max(_row_rel(a, b)
                                           for a, b in zip(out, last))
                rec["max_abs_err"] = float((got - want).abs().max())
                s_err = max(s_err, rec["max_abs_err"])
                ok = max(rec["row_rel"], rec["carry_row_rel"]) \
                    <= XLSTM_F32_REL
            else:
                rec.update(_slstm_errors(got, *args, c0))
                ok = _bf16_ok(rec, SLSTM_ROW_REL)
                if D == 768:
                    rec["cluster_bitwise_block"] = _slstm_routes_bitwise(
                        got, out, args, c0)
                    ok = ok and rec["cluster_bitwise_block"]
            s_checks.append(rec)
            require(ok, f"slstm_scan against its plain version: {rec}")
    torch.cuda.empty_cache()

    # mlstm_parallel at the prefill's shape: its route (wgmma) and the
    # forced mma route, each timed and checked at its head and tail rows
    B, S, H, dh = MLSTM_PREFILL
    W = XLSTM_CHECK_S
    args = _mlstm_inputs(B, S, H, dh, torch.bfloat16, 40)
    m_ms = cuda_ms(lambda: ops.mlstm_parallel(*args), 5, 1)
    m_mma_ms = cuda_ms(lambda: ops.mlstm_parallel(*args, _route="mma"), 3,
                       1)
    got = ops.mlstm_parallel(*args)
    m_rows = _mlstm_head_tail_errors(got, *args)
    got = ops.mlstm_parallel(*args, _route="mma")
    m_mma_rows = _mlstm_head_tail_errors(got, *args)
    require(all(_mlstm_ok(r, MLSTM_ROW_REL) for r in (
        *m_rows.values(), *m_mma_rows.values())),
            f"mlstm_parallel at the prefill's shape: wgmma {m_rows}, mma "
            f"{m_mma_rows}")
    m_plain_ms = cuda_ms(lambda: ref.mlstm_parallel_ref(
        *args, rows=(S - W, S)), 1, 0)
    args32 = [t.float() for t in args[:3]] + list(args[3:])
    m_f32_ms = cuda_ms(lambda: ops.mlstm_parallel(*args32), 1, 1)
    del args, args32, got
    torch.cuda.empty_cache()
    pairs = B * H * S * (S + 1) / 2
    flops = 4.0 * dh * pairs
    nbytes = 2.0 * 4 * B * S * H * dh + 4.0 * 2 * B * S * H
    m_flop_ms, m_byte_ms = 1e3 * flops / BF16_FLOPS, 1e3 * nbytes / HBM_BPS
    m_rec = {"shape": list(MLSTM_PREFILL), "checks": m_checks,
             "max_abs_err": m_err, "route": mlstm_route(torch.bfloat16, dh),
             "ms": m_ms, "ms_float32": m_f32_ms,
             "tflops": flops / m_ms / 1e9, "mma_ms": m_mma_ms,
             "mma_tflops": flops / m_mma_ms / 1e9,
             "wgmma_ptxas": kernel_ptxas(_build.ptxas_log("mlstm"),
                                         "mlstm_wgmma_kernel"),
             "plain_ms": m_plain_ms,
             "plain_rows": [S - W, S],
             "bound_ms": max(m_flop_ms, m_byte_ms),
             "bound_by": "operations" if m_flop_ms >= m_byte_ms
             else "bytes", "flop_bound_ms": m_flop_ms,
             "byte_bound_ms": m_byte_ms, "exp_bound_ms": exp_bound_ms(pairs),
             "library_ms": None, "prefill_rows": m_rows,
             "mma_prefill_rows": m_mma_rows}

    # slstm_scan at the prefill's shape and its decode step
    B, S, D = SLSTM_PREFILL
    *args, _ = _slstm_inputs(B, S, D, torch.bfloat16, 41)
    s_ms = cuda_ms(lambda: ops.slstm_scan(*args), 3, 1)
    s_block_ms = cuda_ms(lambda: ops.slstm_scan(*args, _route="block"), 1, 0)
    s_chain_ms = cuda_ms(lambda: ops.slstm_scan(
        *args, _build_name="slstm_chain"), 3, 1)
    out = _slstm_carry(B, D, torch.bfloat16)
    got = ops.slstm_scan(*args, carry_out=out)
    s_bitwise = _slstm_routes_bitwise(got, out, args, None)
    s_rows = _slstm_head_tail_errors(got, *args)
    require(s_bitwise and all(_bf16_ok(r, SLSTM_ROW_REL)
                              for r in s_rows.values()),
            f"slstm_scan at the prefill's shape: {s_rows}, cluster route "
            f"bitwise its block route: {s_bitwise}")
    head = [g[:, :W] for g in args[:4]] + list(args[4:])
    s_plain_ms = cuda_ms(lambda: ref.slstm_scan_ref(*head), 1, 1)
    del args, head, got
    Bd, Sd, Dd = SLSTM_DECODE
    *dargs, c0 = _slstm_inputs(Bd, Sd, Dd, torch.bfloat16, 42, True)
    dec_ms = cuda_ms(lambda: ops.slstm_scan(*dargs, c0, c0), 200, 5)
    dec_graph_ms = graph_ms(lambda: ops.slstm_scan(*dargs, c0, c0), 200)
    torch.cuda.empty_cache()
    nbytes = 2.0 * 5 * B * S * D + 2.0 * (D * D + D)
    flops = 2.0 * B * S * D * D
    s_flop_ms, s_byte_ms = 1e3 * flops / BF16_FLOPS, 1e3 * nbytes / HBM_BPS
    dec_bytes = 2.0 * 5 * Bd * Dd + 2.0 * (Dd * Dd + Dd) + 2 * 14.0 * Bd * Dd
    s_rec = {"shape": list(SLSTM_PREFILL), "checks": s_checks,
             "max_abs_err": s_err, "ms": s_ms, "us_per_step": 1e3 * s_ms / S,
             "block_ms": s_block_ms, "cluster_bitwise_block": s_bitwise,
             "chain_floor_ms": s_chain_ms,
             "chain_floor_us_per_step": 1e3 * s_chain_ms / S,
             "parent_us_per_step_recorded": SLSTM_PARENT_US_PER_STEP,
             "cluster_ptxas": kernel_ptxas(_build.ptxas_log("slstm"),
                                           "slstm_cluster_kernel"),
             "plain_ms": s_plain_ms, "plain_steps": W,
             "bound_ms": max(s_flop_ms, s_byte_ms),
             "bound_by": "operations" if s_flop_ms >= s_byte_ms
             else "bytes", "flop_bound_ms": s_flop_ms,
             "byte_bound_ms": s_byte_ms, "library_ms": None,
             "prefill_rows": s_rows, "decode_shape": list(SLSTM_DECODE),
             "decode_ms": dec_ms, "decode_graph_ms": dec_graph_ms,
             "decode_bound_ms": 1e3 * dec_bytes / HBM_BPS,
             "decode_bound_by": "bytes"}
    return {"mlstm_parallel": m_rec, "slstm_scan": s_rec}


def phase_serve_xlstm():
    """xlstm-125m at its full width and depth in bf16 on the card (12
    layers, [mlstm, slstm] x 6, 0.247 GB), weights drawn from a seeded
    generator, after every other phase has released its tensors
    (``_serve_guard``). First, before the weights, mlstm_parallel and
    slstm_scan against their plain versions and timed
    (``_xlstm_kernel_rows``). A warm-up prefill, then the main path
    (``_serve_main``): prefill of 1 x 32,768 tokens (6 mlstm_parallel
    launches on the wgmma route, 6 slstm_scan launches), then SERVE_B
    requests of XLSTM_PROMPT tokens teacher-forced through the caches and
    XLSTM_NEW_TOKENS greedy (6 slstm_scan launches a step, no
    mlstm_parallel: mLSTM decodes by its recurrent update). The checks:
    (1) one prefill with every kernel launch held on its own bf16 inputs
    (``_checked_prefill``): each mLSTM layer's first and last
    XLSTM_CHECK_S query rows, every row held (``_mlstm_ok``: none beyond
    twice the bf16 plain version's error on the same row plus
    BF16_ROW_ULP), each sLSTM layer's first and last
    XLSTM_CHECK_S positions, the last from the kernel's own carry
    (SLSTM_ROW_REL and twice the bf16 plain version's error); (2) the
    first mLSTM and the first sLSTM layer fed the prompt's embeddings by
    the prefill form and by decode step by step through its cache, its
    weights alone in float32 (XLSTM_LAYER_REL_F32; bf16 recorded); (3)
    the prompt's first
    token through the forward ((4, 1)) against decode step 0, the bf16
    model on the main path's kernels (XLSTM_POS0_REL of the logits'
    scale) and the whole model in float32 (XLSTM_POS0_REL_F32); (4) the
    main path's tokens in range and logits finite (``_lm_main_path``).
    Decode beside the step's weight-read bound: every weight, the tied
    table included (the logits read all of it)."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models.layers import embed
    from repro_torch.models.transformer import (_layer_specs, decode_step,
                                                forward, init_cache)
    t0 = time.perf_counter()
    before = _serve_guard("serve_xlstm")
    kernel_recs = _xlstm_kernel_rows()
    cfg = get_config("xlstm-125m")
    n_mlstm, n_slstm = mlstm_layers(cfg), slstm_layers(cfg)
    dh = 2 * cfg.d_model // cfg.n_heads
    require(cfg.n_layers == 12 and cfg.d_model == 768
            and (n_mlstm, n_slstm) == (6, 6)
            and (XLSTM_PREFILL_B, XLSTM_PREFILL_S, cfg.n_heads, dh)
            == MLSTM_PREFILL
            and (XLSTM_PREFILL_B, XLSTM_PREFILL_S, cfg.d_model)
            == SLSTM_PREFILL, "serve_xlstm: not xlstm-125m's full width")
    model, tokens, prompt, rec = _serve_model(
        "serve_xlstm", cfg, XLSTM_PARAMS,
        (XLSTM_PREFILL_B, XLSTM_PREFILL_S), XLSTM_PROMPT)
    prompt_logits, main = _serve_main(
        "serve_xlstm", model, cfg, tokens, prompt, XLSTM_NEW_TOKENS,
        rec["weight_gb"] * 1e9)

    # (1) every prefill layer's kernel on its own inputs
    checked = _checked_prefill(model, tokens, {
        "mlstm_parallel": _mlstm_head_tail_errors,
        "slstm_scan": _slstm_head_tail_errors})
    mrows, srows = checked["mlstm_parallel"], checked["slstm_scan"]

    # (2) the first mLSTM and sLSTM layers by both forms on the prompt's
    # embeddings
    specs = _layer_specs(cfg)
    layers = {}
    with torch.inference_mode():
        x = embed(model.embed, prompt)
        for kind in ("mlstm", "slstm"):
            i = next(i for i, s in enumerate(specs) if s.mixer == kind)
            layers[kind] = {"layer": i, **_layer_routes(
                _attention_only(model.layers[i]), x, cfg, i)}
    del x

    # (3) the prompt's first token: a (4, 1) forward against decode step 0,
    # the bf16 model and a float32 copy
    with torch.inference_mode():
        fwd, _ = forward(model, {"tokens": prompt[:, :1]})
    dec0 = prompt_logits[:, 0].float()
    pos0_bf16 = float((fwd[:, 0].float() - dec0).abs().max()
                      / dec0.abs().max())
    model32 = copy.deepcopy(model).float()
    with torch.inference_mode():
        fwd, _ = forward(model32, {"tokens": prompt[:, :1]})
        cache = init_cache(cfg, SERVE_B, 1, torch.float32)
        dec0, _ = decode_step(model32, cache, {"tokens": prompt[:, :1],
                                               "step": 0})
    pos0_rel = float((fwd[:, 0] - dec0[:, 0]).abs().max()
                     / dec0[:, 0].abs().max())
    del model32, cache, fwd, dec0

    def worst(recs, key):
        return max(r[part][key] for r in recs for part in ("head", "tail"))
    rec.update(main, mlstm_layers=n_mlstm, slstm_layers=n_slstm,
               allocated_before_gb=before / 1e9,
               prefill_check_rows=XLSTM_CHECK_S,
               prefill_mlstm_row_rel_max=worst(mrows, "row_rel_err"),
               prefill_mlstm_plain_row_rel_max=worst(mrows,
                                                     "plain_row_rel_err"),
               prefill_mlstm_median_row_rel_max=worst(
                   mrows, "median_row_rel_err"),
               prefill_mlstm_rows_over_plain_max=worst(mrows,
                                                       "rows_over_plain"),
               prefill_slstm_row_rel_max=worst(srows, "row_rel_err"),
               prefill_slstm_plain_row_rel_max=worst(srows,
                                                     "plain_row_rel_err"),
               prefill_mlstm=mrows, prefill_slstm=srows, layers=layers,
               pos0_rel_diff_f32=pos0_rel, pos0_rel_diff_bf16=pos0_bf16,
               kernels=kernel_recs)
    _serve_done(rec, t0)
    require(len(mrows) == n_mlstm
            and all(_mlstm_ok(r[k]) for r in mrows
                    for k in ("head", "tail")),
            "serve_xlstm: a prefill layer's mlstm_parallel is off its plain "
            "version in float32, at its head or its tail: a row beyond twice "
            "the bf16 plain version's error on the row plus BF16_ROW_ULP, "
            "its median row beyond MLSTM_MEDIAN_ROW_REL or its largest "
            "beyond twice the plain version's")
    require(len(srows) == n_slstm
            and all(_bf16_ok(r[k], SLSTM_ROW_REL) for r in srows
                    for k in ("head", "tail")),
            "serve_xlstm: a prefill layer's slstm_scan is off its plain "
            "version in float32 by more than SLSTM_ROW_REL or twice the "
            "bf16 plain version's error, at its head or its tail")
    for kind, layer in layers.items():
        require(math.isfinite(layer["f32"])
                and layer["f32"] <= XLSTM_LAYER_REL_F32[kind],
                f"serve_xlstm: the {kind} layer's decode is off its prefill "
                f"form in float32: {layer}")
    require(math.isfinite(pos0_bf16) and pos0_bf16 <= XLSTM_POS0_REL,
            f"serve_xlstm: the bf16 (4, 1) forward and decode step 0 differ "
            f"by {pos0_bf16} of the logits' scale > {XLSTM_POS0_REL}")
    require(math.isfinite(pos0_rel) and pos0_rel <= XLSTM_POS0_REL_F32,
            f"serve_xlstm: the float32 (4, 1) forward and decode step 0 "
            f"differ by {pos0_rel} of the logits' scale > "
            f"{XLSTM_POS0_REL_F32}")
    del model
    _serve_free()
    return main["main_path_launches"], main["main_path_routes"], kernel_recs


# --------------------------------------------------------------------------
# the Study layer: seed transforms, the batched ATO ramp, stragglers, the
# grid and LOO
# --------------------------------------------------------------------------

def _ato_row_problem(name: str, n: int, k: int = 10):
    """The ATO C row (``ATO_ROW_C`` x C) of ``benchmarks/table1_kfold.py``:
    K, y, the fold masks and chunks, and fold 0 solved cold at the three
    C values by ``smo_solve_batched``."""
    from repro_torch.core.cv import _fold_masks
    from repro_torch.data.svm_suite import kfold_chunks, make_dataset
    from repro_torch.svm import kernel_matrix, smo_solve_batched
    dev = torch.device("cuda")
    ds = make_dataset(name, n_override=n)
    chunks = kfold_chunks(ds.n, k)
    m = chunks.size
    X = torch.as_tensor(ds.X[:m], device=dev)
    y = torch.as_tensor(ds.y[:m], dtype=torch.float64, device=dev)
    K = kernel_matrix(X, X, gamma=ds.gamma)
    masks = torch.as_tensor(_fold_masks(chunks), device=dev)
    Cs = [c * ds.C for c in ATO_ROW_C]
    L = len(Cs)
    prev = smo_solve_batched(K, y, masks[0].repeat(L, 1), Cs,
                             torch.zeros((L, m), dtype=torch.float64,
                                         device=dev), -y.repeat(L, 1))
    return ds, K, y, masks, chunks, Cs, prev


def _study_kernels() -> dict:
    """The Study slice's kernels against their plain versions run on the
    CPU, on the inputs that the main paths give them (recorded): the
    batched ATO ramp's ``ato_system_lanes`` and ``ato_apply_lanes`` over
    the ATO C row at fold 0 -> 1 (adult n=1000; heart n=270, whose ramps
    run all 30 steps), the carried route against the compact one and the
    fused apply against the split one with ``smo_f_update`` and the clamp
    on every step, each lane also bitwise what a one-lane launch on its
    slice gives it (both routes of each); the LOO spills (``_loo_spills``).
    Then each one's time at adult's shape, the plain version's on the
    card, and the bytes bound (each is bound by its chain of block
    reductions or, for the walk, by its dependent steps, far above both
    floors). The ramp kernels' readings are returned under ``<name>_row``, and ``smo_f_update``'s at
    the row's shape (it is off the ramp now): their entries in the
    ``kernels`` line are Table 1's one-lane calls."""
    from repro_torch.core import seeding
    from repro_torch.core.cv import _transition_idx
    from repro_torch.kernels import ref
    from repro_torch.kernels import seeding as ks
    from repro_torch.kernels import smo_update as ku
    names = ("ato_system_lanes", "ato_apply_lanes")
    calls = {k: [] for k in names}
    kwargs = {k: [] for k in names}
    for name, n in (("adult", 1000), ("heart", 270)):
        ds, K, y, masks, chunks, Cs, prev = _ato_row_problem(name, n)
        idx = _transition_idx(chunks, 0, 1, torch.device("cuda"))
        with _Recorder(seeding, names) as rec:
            seeding.ato_seed_batch(K, y, Cs, prev, *idx, bucket_by_lane=False)
        for key in names:
            calls[key] += rec.calls[key]
            kwargs[key] += rec.kwargs[key]
        del K
    out = {"ato_system_lanes_row": _ato_system_check(
               calls["ato_system_lanes"], kwargs["ato_system_lanes"]),
           "ato_apply_lanes_row": _ato_apply_check(
               calls["ato_apply_lanes"], kwargs["ato_apply_lanes"])}
    lanes_of = lambda t, sl: type(t)(*(x[sl] for x in t))  # noqa: E731
    for a, kw in zip(calls["ato_system_lanes"], kwargs["ato_system_lanes"]):
        got = ks.ato_system_lanes(*a)
        K_, y_, Cs_, alpha, f, bfb, in_S, in_T, T_act, R_act, m_cap = a
        carried = kw.get("_route") == "carried"
        row = _clone(kw["out"]) if carried else None
        if carried:
            ks.ato_system_lanes(*a, out=row, _route="carried")
        for lane in range(alpha.shape[0]):
            sl = slice(lane, lane + 1)
            one = (K_, y_, Cs_[sl], alpha[sl], f[sl], bfb[sl], in_S, in_T,
                   T_act[sl], R_act[sl], m_cap)
            solo = ks.ato_system_lanes(*one)
            require(all(torch.equal(getattr(solo, key)[0], getattr(got, key)[
                lane]) for key in solo._fields[:-1])   # rhs[1:]: the caller's
                and torch.equal(solo.rhs[0, 0], got.rhs[lane, 0]),
                "ato_system_lanes: a lane differs from a one-lane launch")
            if carried:
                work = lanes_of(_clone(kw["out"]), sl)
                ks.ato_system_lanes(*one, out=work, _route="carried")
                require(_same_bits(work.B[0], row.B[lane]),
                        "ato_system_lanes: a lane's carried B differs from "
                        "a one-lane launch's")
    for a, kw in zip(calls["ato_apply_lanes"], kwargs["ato_apply_lanes"]):
        card, solo = _clone_call(a)[0], _clone_call(a)[0]
        eta_c = ks.ato_apply_lanes(*card)
        g, f, al, v, Phi, y_, b, Cs_, tol, tn, fr, Ta, Ra, dn, st, ms = solo
        for lane in range(f.shape[0]):
            sl = slice(lane, lane + 1)
            e1 = ks.ato_apply_lanes(g[sl], f[sl], al[sl], v[sl], Phi[sl], y_,
                                    b[sl], Cs_[sl], tol, tn[sl], fr[sl],
                                    Ta[sl], Ra[sl], dn[sl], st[sl], ms)
            require(torch.equal(e1[0], eta_c[lane]),
                    "ato_apply_lanes: a lane's eta differs from a one-lane "
                    "launch's")
        require(all(torch.equal(x, w) for x, w in zip(solo, card)
                    if isinstance(x, torch.Tensor)),
                "ato_apply_lanes: a lane differs from a one-lane launch")
        if kw.get("carry") is None:
            continue
        (ra, rkw), (oa, okw) = _clone_call(a, kw), _clone_call(a, kw)
        eta_r = ks.ato_apply_lanes(*ra, **rkw)
        g, f, al, v, Phi, y_, b, Cs_, tol, tn, fr, Ta, Ra, dn, st, ms = oa
        c = okw["carry"]
        for lane in range(f.shape[0]):
            sl = slice(lane, lane + 1)
            s1 = lanes_of(c.s, sl)
            e1 = ks.ato_apply_lanes(g[sl], f[sl], al[sl], s1.v, Phi[sl], y_,
                                    s1.b, Cs_[sl], tol, s1.train_now,
                                    s1.free, Ta[sl], Ra[sl], dn[sl], st[sl],
                                    ms, carry=c._replace(
                                        b_fallback=c.b_fallback[sl], s=s1))
            require(_same_bits(e1[0], eta_r[lane]),
                    "ato_apply_lanes: a lane's fused eta differs from a "
                    "one-lane launch's")
        require(all(_same_bits(x, w) for x, w in zip(oa, ra)
                    if isinstance(x, torch.Tensor))
                and all(_same_bits(x, w) for x, w in zip(c.s, rkw["carry"].s)
                        if x is not c.s.rhs),
                "ato_apply_lanes: a lane's fused step differs from a "
                "one-lane launch's")
    # smo_f_update at the row's shape (it is off the ramp now: checked and
    # timed beside it)
    a = calls["ato_apply_lanes"][0]
    L, n = a[1].shape
    args = (a[2], a[3], a[4], torch.full((L,), 0.37, dtype=torch.float64,
                                         device=a[2].device))
    got = ku.smo_f_update(*args)
    require(torch.equal(got.cpu(), ref.smo_f_update_ref(
        *_cpu(args[:3]), args[3].cpu()[:, None])),
        "smo_f_update: rows not bitwise equal to the CPU addcmul")
    rows = torch.stack([ku.smo_f_update(*(x[r] for x in args))
                        for r in range(L)])
    require(torch.equal(got, rows),
            "smo_f_update: a row differs from its one-row launch")
    out["smo_f_update_row"] = {
        "lanes": L, "n": n, "calls_checked": 1,
        "ms": graph_ms(lambda: ku.smo_f_update(*args), 200),
        "plain_ms": graph_ms(lambda: ref.smo_f_update_ref(
            *args[:3], args[3][:, None]), 200),
        "max_abs_err": 0.0, **_bound(8.0 * (4 * L * n + L), 0.0)}
    torch.cuda.empty_cache()

    out.update(_loo_spills())
    torch.cuda.empty_cache()
    return out


#: the LOO seeds whose spills ``_loo_spills`` records: rows of the full
#: solution of each of ``phase_loo``'s cases
LOO_SPILL_ROWS = (("heart", 270, tuple(range(0, 270, 9))),
                  ("madelon", 600, (0, 299, 599)),
                  ("adult", 1000, (0, 499, 999)))


def _parent_avg(y, alpha, C, t):
    """avg_seed_loo's device work before the fused route: the prologue's
    ops (``ref.loo_start_ref`` on the card), then the split kernel."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import seeding as ks
    beta, resid, lo, hi, free0 = ref.loo_start_ref(y, alpha, C, t)
    return ks.avg_spill(beta, lo, hi, free0, resid), lo, hi


def _parent_top(K, y, alpha, C, t):
    """top_seed_loo's device work before the fused route: the prologue's
    ops, the order (clone, fill, negation and a stable argsort:
    ``ref.loo_order_ref``), then the split kernel."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import seeding as ks
    beta, resid, lo, hi, _ = ref.loo_start_ref(y, alpha, C, t)
    return ks.top_spill(ref.loo_order_ref(K[:, t], t), beta, lo, hi,
                        resid), lo, hi


def _parent_seed(spill):
    """A whole LOO seeder as the parent ran it: ``spill``'s device work,
    water_fill with its target filled on the card, and the y product."""
    from repro_torch.kernels import seeding as ks

    def seed(K, y, C, alpha, t):
        beta, lo, hi = spill(K, y, alpha, C, t)
        zero = torch.full((), 0.0, dtype=torch.float64, device=y.device)
        return y * ks.water_fill(beta, lo, hi, zero)
    return seed


def _loo_spills() -> dict:
    """The LOO seeders' spills on the inputs ``phase_loo``'s seeds give
    them (recorded at ``LOO_SPILL_ROWS``): each fused call against the
    split route on the plain prologue (AVG bit for bit, TOP equal) and the
    plain version on the CPU (AVG within 1e-12 max(C, 1), TOP equal), its
    lo and hi bit for bit the plain prologue's. Then, in graphs, at adult
    n = 1,000: each route's kernel, the parent's device work between alpha
    and water_fill's input, the plain version, and each whole seeder
    beside the parent's seeder; and TOP's fused route at every recorded
    adult and madelon row and heart's first."""
    from repro_torch.core import seeding
    from repro_torch.kernels import ref
    from repro_torch.kernels import seeding as ks
    names = ("avg_spill_loo", "top_spill_loo")
    calls = {k: [] for k in names}
    main = {}
    for name, n, ts in LOO_SPILL_ROWS:
        ds, K, y, prev = _seed_problem_full(name, n)
        with _Recorder(seeding, names) as rec:
            for t in ts:
                seeding.avg_seed_loo(K, y, ds.C, prev.alpha, t)
                seeding.top_seed_loo(K, y, ds.C, prev.alpha, t)
        for key in names:
            calls[key] += [(name, a) for a in rec.calls[key]]
        main[name] = (K, y, ds.C, prev.alpha)
    avg_err = 0.0
    for name, a in calls["avg_spill_loo"]:
        got = ks.avg_spill_loo(*a)
        split = _parent_avg(*a)
        want = ref.avg_spill_loo_ref(*_cpu(a))
        require(_same_bits(got[0], split[0]),
                f"avg_spill {name} t={a[3]}: fused not bitwise the split "
                "kernel")
        require(all(_same_bits(g.cpu(), w) for g, w in zip(got[1:],
                                                            want[1:])),
                f"avg_spill {name} t={a[3]}: lo / hi not the plain "
                "prologue's")
        e = float((got[0].cpu() - want[0]).abs().max())
        require(e <= 1e-12 * max(a[2], 1.0),
                f"avg_spill {name} t={a[3]}: {e} off the plain version")
        avg_err = max(avg_err, e)
    for name, a in calls["top_spill_loo"]:
        want = ref.top_spill_loo_ref(*_cpu(a))
        got = ks.top_spill_loo(*a)
        require(torch.equal(got[0].cpu(), want[0])
                and all(_same_bits(g.cpu(), w)
                        for g, w in zip(got[1:], want[1:])),
                f"top_spill {name} t={a[4]}: not the plain version")
        require(torch.equal(_parent_top(*a)[0].cpu(), want[0]),
                f"top_spill {name} t={a[4]}: split not the plain version")
    K, y, C, alpha = main["adult"]
    n = y.shape[0]
    t = LOO_SPILL_ROWS[-1][2][0]
    pro = ref.loo_start_ref(y, alpha, C, t)
    order = ref.loo_order_ref(K[:, t], t)
    out = {}
    out["avg_spill"] = {
        "n": n, "t": t, "calls_checked": len(calls["avg_spill_loo"]),
        "ms": graph_ms(lambda: ks.avg_spill_loo(y, alpha, C, t), 20),
        "split_ms": graph_ms(lambda: ks.avg_spill(pro[0], pro[2], pro[3],
                                                  pro[4], pro[1]), 20),
        "parent_ms": graph_ms(lambda: _parent_avg(y, alpha, C, t), 20),
        "plain_ms": graph_ms(lambda: ref.avg_spill_loo_ref(y, alpha, C, t),
                             20),
        "seed_ms": graph_ms(lambda: seeding.avg_seed_loo(K, y, C, alpha, t),
                            20),
        "seed_parent_ms": graph_ms(lambda: _parent_seed(
            lambda K_, *a: _parent_avg(*a))(K, y, C, alpha, t), 20),
        "max_abs_err": avg_err, **_bound(40.0 * n + 16.0, 0.0),
        "split_bound_ms": _bound(33.0 * n + 8.0, 0.0)["bound_ms"]}
    rows_ms = {}
    for name, _, ts in LOO_SPILL_ROWS:
        K_, y_, C_, a_ = main[name]
        for t_ in (ts if name != "heart" else ts[:1]):
            rows_ms[f"{name}_{t_}"] = graph_ms(
                lambda: ks.top_spill_loo(K_, y_, a_, C_, t_), 20)
    out["top_spill"] = {
        "n": n, "t": t, "calls_checked": len(calls["top_spill_loo"]),
        "ms": graph_ms(lambda: ks.top_spill_loo(K, y, alpha, C, t), 20),
        "rows_ms": rows_ms,
        "split_ms": graph_ms(lambda: ks.top_spill(order, pro[0], pro[2],
                                                  pro[3], pro[1]), 20),
        "order_split_ms": graph_ms(lambda: ks.top_spill(
            ref.loo_order_ref(K[:, t], t), pro[0], pro[2], pro[3], pro[1]),
            20),
        "parent_ms": graph_ms(lambda: _parent_top(K, y, alpha, C, t), 20),
        "plain_ms": cuda_ms(lambda: ref.top_spill_loo_ref(K, y, alpha, C, t),
                            1),
        "seed_ms": graph_ms(lambda: seeding.top_seed_loo(K, y, C, alpha, t),
                            20),
        "seed_parent_ms": graph_ms(lambda: _parent_seed(_parent_top)(
            K, y, C, alpha, t), 20),
        "max_abs_err": 0.0, **_bound(48.0 * n + 16.0, 0.0),
        "split_bound_ms": _bound(40.0 * n + 8.0, 0.0)["bound_ms"]}
    return out


def _seed_problem_full(name: str, n: int):
    """LOO's start: the dataset cut to n, its K and y, and the full-data
    SVM (every row in the training set)."""
    from repro_torch.data.svm_suite import make_dataset
    from repro_torch.svm import kernel_matrix, smo_solve
    dev = torch.device("cuda")
    ds = make_dataset(name, n_override=n)
    X = torch.as_tensor(ds.X, device=dev)
    y = torch.as_tensor(ds.y, dtype=torch.float64, device=dev)
    K = kernel_matrix(X, X, gamma=ds.gamma)
    full = smo_solve(K, y, torch.ones(n, dtype=torch.bool, device=dev), ds.C,
                     torch.zeros_like(y), -y, max_iter=5_000_000)
    return ds, K, y, full


def _no_other_sync(fn) -> dict:
    """``fn()`` under ``set_sync_debug_mode("error")`` after a warm-up call:
    any host sync raises but the seeders' counted reads; returns them."""
    from repro_torch.core import seeding
    fn()
    sync()
    seeding.HOST_SYNCS.update(dict.fromkeys(seeding.HOST_SYNCS, 0))
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync()
    return dict(seeding.HOST_SYNCS)


def _transform_checks() -> list:
    """Each transform on the card against its plain version on the CPU,
    from the same solution (heart and adult, fold 0 at its C, and the full
    SVM for LOO): scale_C (C x 0.25 and x 4) and the LOO seeds within
    1e-12 max(C, 1), fold (SIR) within its bar; and with no host sync."""
    from repro_torch.core import seeding
    from repro_torch.svm.engine import SMOResult
    out = []
    for name, n in (("heart", 270), ("adult", 1000)):
        ds, K, y, prev, idx = _seed_problem(name, n)
        prev_c = SMOResult(*(t.cpu() for t in prev))
        # fold 0's training rows: all but its test chunk, T of 0 -> 1
        mask = torch.ones_like(y, dtype=torch.bool).index_fill_(0, idx[2],
                                                                False)
        cases = [("scale_C", dict(C_old=ds.C, train_mask=mask), s * ds.C,
                  lambda C: 1e-12 * max(C, 1.0)) for s in (0.25, 4.0)]
        cases.append(("fold", dict(method="sir", S_idx=idx[0],
                                   R_idx=idx[1], T_idx=idx[2]), ds.C,
                      SEED_ATOL["sir"]))
        _, K_f, y_f, full = _seed_problem_full(name, n)
        full_c = SMOResult(*(t.cpu() for t in full))
        for tr, params, C, bar in cases:
            fn = seeding.TRANSFORMS[tr]
            got = fn(K, y, C, prev, **params).cpu()
            want = fn(K.cpu(), y.cpu(), C, prev_c,
                      **{k: v.cpu() if isinstance(v, torch.Tensor) else v
                         for k, v in params.items()})
            err = float((got - want).abs().max())
            require(err <= bar(C), f"{name} {tr}: {err} off the plain "
                                   "version")
            out.append({"dataset": name, "transform": tr, "C": C,
                        "max_abs_err": err, "bar": bar(C)})
        for tr in ("loo_avg", "loo_top"):
            fn = seeding.TRANSFORMS[tr]
            err = 0.0
            for t in (0, n // 2, n - 1):
                got = fn(K_f, y_f, ds.C, full, t=t).cpu()
                want = fn(K_f.cpu(), y_f.cpu(), ds.C, full_c, t=t)
                err = max(err, float((got - want).abs().max()))
            require(err <= 1e-12 * max(ds.C, 1.0),
                    f"{name} {tr}: {err} off the plain version")
            out.append({"dataset": name, "transform": tr, "C": ds.C,
                        "max_abs_err": err, "bar": 1e-12 * max(ds.C, 1.0)})
        if name == "adult":   # no host sync but the counted reads
            syncs = {
                "scale_C": _no_other_sync(lambda: seeding.TRANSFORMS[
                    "scale_C"](K, y, 4 * ds.C, prev, C_old=ds.C,
                               train_mask=mask)),
                "loo_avg": _no_other_sync(lambda: seeding.TRANSFORMS[
                    "loo_avg"](K_f, y_f, ds.C, full, t=7)),
                "loo_top": _no_other_sync(lambda: seeding.TRANSFORMS[
                    "loo_top"](K_f, y_f, ds.C, full, t=7))}
            for tr, s in syncs.items():
                require(s == dict.fromkeys(s, 0),
                        f"{tr}: counted host reads {s}")
            out.append({"dataset": name, "host_syncs": syncs})
        del K, K_f
        torch.cuda.empty_cache()
    return out


def _ato_rows() -> list:
    """The ATO C row (``ATO_ROW_C`` x C) through every fold transition of
    heart and adult, k=10, bucketed by lane and padded to the widest lane:
    each lane within the ATO bar (1e-12 C) of the solo ``ato_seed`` on that
    lane, and the row's one host read of the free counts; the ramps timed
    (host clock after a sync), the chain advanced on the bucketed seeds by
    ``smo_solve_batched``."""
    from repro_torch.core import seeding
    from repro_torch.core.cv import _transition_idx
    from repro_torch.svm import init_f, smo_solve_batched
    from repro_torch.svm.engine import SMOResult
    rows = []
    for name, n in (("heart", 270), ("adult", 1000)):
        ds, K, y, masks, chunks, Cs, prev = _ato_row_problem(name, n)
        L, dev = len(Cs), K.device
        iters = int(prev.n_iter.sum())
        ramp = {"bucketed": 0.0, "padded": 0.0}
        err, syncs = 0.0, {}
        for h in range(1, chunks.shape[0]):
            S, R, T = _transition_idx(chunks, h - 1, h, dev)
            seeds = {}
            for key, flag in (("bucketed", True), ("padded", False)):
                seeding.HOST_SYNCS.update(
                    dict.fromkeys(seeding.HOST_SYNCS, 0))
                sync()
                t0 = time.perf_counter()
                seeds[key] = seeding.ato_seed_batch(K, y, Cs, prev, S, R, T,
                                                    bucket_by_lane=flag)
                sync()
                ramp[key] += time.perf_counter() - t0
                syncs[key] = dict(seeding.HOST_SYNCS)
                require(syncs[key]["ato_m_cap"] == 1,
                        f"{name} ATO row: {syncs[key]} host reads")
            for lane, C in enumerate(Cs):
                solo = seeding.ato_seed(K, y, C, SMOResult(
                    *(t[lane] for t in prev)), S, R, T)
                for key in seeds:
                    e = float((seeds[key][lane] - solo).abs().max())
                    require(e <= 1e-12 * C,
                            f"{name} ATO row h={h} C={C} {key}: {e} off the "
                            "solo ato_seed")
                    err = max(err, e / C)
            a0 = seeds["bucketed"]
            f0 = torch.stack([init_f(K, y, a0[lane]) for lane in range(L)])
            prev = smo_solve_batched(K, y, masks[h].repeat(L, 1), Cs, a0,
                                     f0)
            require(bool(prev.converged.all()),
                    f"{name} ATO row fold {h}: a lane did not converge")
            iters += int(prev.n_iter.sum())
        rows.append({"dataset": name, "n": int(y.shape[0]), "Cs": Cs,
                     "iterations": iters, "init_s_bucketed": ramp["bucketed"],
                     "init_s_padded": ramp["padded"],
                     "max_err_over_C_vs_solo": err,
                     "host_syncs_last": syncs})
        del K
        torch.cuda.empty_cache()
    return rows


def _ato_batch_syncs() -> dict:
    """``ato_seed_batch`` on adult's C row under sync debug "error": only
    the counted reads (the free counts once, the flags once a chunk)."""
    from repro_torch.core import seeding
    from repro_torch.core.cv import _transition_idx
    ds, K, y, masks, chunks, Cs, prev = _ato_row_problem("adult", 1000)
    idx = _transition_idx(chunks, 0, 1, K.device)
    s = _no_other_sync(lambda: seeding.ato_seed_batch(K, y, Cs, prev, *idx))
    require(s["ato_m_cap"] == 1 and s["ato_flag"] >= 1 and s["mir_svd"] == 0,
            f"ato_seed_batch: host reads {s}")
    return s


def phase_study_seeds():
    """The Study layer at Table 1's sizes (heart n=270, adult n=1000):
    each transform against its plain version, the ATO C row against the
    solo seeds, the straggler run (``run_cv`` best_available, fold 3
    lost) and the (C, gamma) grid (``run_grid``, k=5, "sir", and "ato" on
    the first gamma row). Adult's straggler counts and its cells' correct
    counts are gated on the reference's, its cells' iterations on the
    reference's within ``ITER_BAND`` and on the card's (``CARD_GRID``)
    exactly; heart's are printed beside the reference's."""
    from repro_torch.core.cv import run_cv
    from repro_torch.core.grid import run_grid
    from repro_torch.data.svm_suite import make_dataset
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    transforms = _transform_checks()
    ato_rows = _ato_rows()
    ato_syncs = _ato_batch_syncs()
    straggler, failed = [], []
    for name, want in REFERENCE_STRAGGLER.items():
        ds = make_dataset(name, n_override=want["n"])
        rep = run_cv(ds, k=10, method="sir",
                     straggler_policy="best_available",
                     unavailable_folds=STRAGGLER_LOST)
        got = {"seed_from": [f.seed_from for f in rep.folds],
               "per_fold": [f.n_iter for f in rep.folds],
               "accuracy": round(rep.accuracy, 4)}
        require(all(f.converged for f in rep.folds),
                f"{name} straggler: a fold did not converge")
        require(got["seed_from"] == want["seed_from"],
                f"{name} straggler: seed_from {got['seed_from']}")
        if want["gated"] and got != {k: want[k] for k in got}:
            failed.append(f"{name} straggler: {got}, the reference's {want}")
        straggler.append({"dataset": name, **got,
                          "iterations": rep.total_iterations,
                          "reference": want,
                          "init_s": rep.total_init_time,
                          "solve_s": rep.total_solve_time})
    grid = []
    for name, want in REFERENCE_GRID.items():
        ds = make_dataset(name, n_override=want["n"])
        Cs = [c * ds.C for c in GRID_C]
        gammas = [g * ds.gamma for g in GRID_GAMMA]
        for method, gs in (("sir", gammas), ("ato", gammas[:1])):
            before = ops.route_counts()["smo_chunk"]
            rep = run_grid(ds, Cs, gs, k=GRID_K, method=method)
            after = ops.route_counts()["smo_chunk"]
            cells = [[c.C, c.gamma, c.iterations, c.acc_correct]
                     for c in rep.cells]
            require(all(c.converged for c in rep.cells),
                    f"{name} grid {method}: a cell did not converge")
            if want["gated"] and (
                    [c[:2] + c[3:] for c in cells]
                    != [c[:2] + c[3:] for c in want[method]]
                    or not all(_in_band(c[2], w[2])
                               for c, w in zip(cells, want[method]))
                    or [c[2] for c in cells] != CARD_GRID[method]):
                failed.append(f"{name} grid {method}: {cells}; the "
                              f"reference's {want[method]} (iterations "
                              f"within {ITER_BAND:.0%}), the card's "
                              f"iterations {CARD_GRID[method]}")
            grid.append({"dataset": name, "method": method, "cells": cells,
                         "reference": want[method],
                         "kernel_s": rep.kernel_time,
                         "seed_s": rep.seed_time,
                         "solve_s": rep.solve_time,
                         "occupancy": rep.occupancy,
                         "chunk_routes": {r: after[r] - before[r]
                                          for r in after}})
    emit({"phase": "study_seeds", "seconds": time.perf_counter() - t0,
          "transforms": transforms, "ato_rows": ato_rows,
          "ato_seed_batch_host_syncs": ato_syncs, "straggler": straggler,
          "grid": grid})
    require(not failed, "; ".join(failed))


def phase_grid_size(ds):
    """The (C, gamma) grid at the paper's cardinality: adult n=32,560,
    d=123, k=5, Cs = C x GRID_C, gammas = gamma x GRID_GAMMA, "sir",
    cross-gamma pool with GRID_LRU_BUDGET kernels (8.48 GB each) resident:
    every cell converges, cell (C, gamma) equals ``run_cv`` there, and at
    most two kernels were resident at once."""
    from repro_torch.core.cv import run_cv
    from repro_torch.core.grid import run_grid
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    Cs = [c * ds.C for c in GRID_C]
    gammas = [g * ds.gamma for g in GRID_GAMMA]
    torch.cuda.empty_cache()
    before = ops.route_counts()["smo_chunk"]
    tw = time.perf_counter()
    rep = run_grid(ds, Cs, gammas, k=GRID_K, method="sir",
                   pool="cross_gamma", max_resident=GRID_LRU_BUDGET)
    wall = time.perf_counter() - tw
    after = ops.route_counts()["smo_chunk"]
    n = rep.n
    k_bytes = n * n * 8
    require(all(c.converged for c in rep.cells),
            "grid_size: a cell did not converge")
    require(rep.resident["peak_resident"] == GRID_LRU_BUDGET
            and rep.resident["peak_resident_bytes"]
            <= GRID_LRU_BUDGET * k_bytes,
            f"grid_size: residency {rep.resident}")
    torch.cuda.empty_cache()
    tc = time.perf_counter()
    cv = run_cv(ds, k=GRID_K, method="sir")
    cv_wall = time.perf_counter() - tc
    cell = next(c for c in rep.cells
                if c.C == float(ds.C) and c.gamma == float(ds.gamma))
    require(cell.iterations == cv.total_iterations
            and cell.acc_correct == sum(f.acc_correct for f in cv.folds),
            f"grid_size: cell ({ds.C}, {ds.gamma}) {cell.iterations} "
            f"iterations {cell.acc_correct} correct, run_cv "
            f"{cv.total_iterations} / "
            f"{sum(f.acc_correct for f in cv.folds)}")
    emit({"phase": "grid_size", "seconds": time.perf_counter() - t0,
          "n": n, "d": int(ds.X.shape[1]), "k": GRID_K, "lanes":
          len(rep.cells) * GRID_K, "K_gb": k_bytes / 1e9, "wall_s": wall,
          "cells": [{"C": c.C, "gamma": c.gamma, "iterations": c.iterations,
                     "accuracy": c.accuracy, "seed_s": c.seed_s,
                     "solve_s": c.solve_s} for c in rep.cells],
          "kernel_s": rep.kernel_time, "seed_s": rep.seed_time,
          "solve_s": rep.solve_time, "resident": rep.resident,
          "occupancy": rep.occupancy,
          "chunk_routes": {r: after[r] - before[r] for r in after},
          "run_cv": {"iterations": cv.total_iterations,
                     "per_fold": [f.n_iter for f in cv.folds],
                     "accuracy": cv.accuracy, "wall_s": cv_wall}})


def phase_loo():
    """Leave-one-out CV (paper suppl. Fig. 2) through ``run_loo``: the
    Fig. 2 cases (heart n=270, 270 rounds; madelon n=600, 120 rounds) with
    cold, avg, top, mir and sir, beside the reference's counts, and adult
    n=1000, 20 rounds, with ato as well: its base iterations and accuracy
    gated on ``REFERENCE_LOO``, its iterations on the reference's within
    ``ITER_BAND`` and on ``CARD_LOO`` exactly. Every round converges."""
    from repro_torch.core.cv import run_loo
    from repro_torch.data.svm_suite import make_dataset
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    rows, failed = [], []
    cases = [(c, FIG2_METHODS, REFERENCE_FIG2.get(c[0], {}), False)
             for c in FIG2_CASES]
    cases.append((LOO_ADULT, FIG2_METHODS + ("ato",), REFERENCE_LOO, True))
    for (name, n, rounds), methods, refs, gated in cases:
        ds = make_dataset(name, n_override=n)
        for method in methods:
            before = ops.route_counts()["smo_chunk"]
            sync()
            tw = time.perf_counter()
            got = run_loo(ds, method=method, rounds=rounds)
            wall = time.perf_counter() - tw
            after = ops.route_counts()["smo_chunk"]
            require(got["converged"],
                    f"LOO {name} {method}: a round did not converge")
            want = refs.get(method)
            mine = [got["base_iterations"], got["iterations"],
                    got["accuracy"]]
            if gated and (mine[::2] != want[::2]
                          or not _in_band(mine[1], want[1])
                          or mine[1] != CARD_LOO[method]):
                failed.append(f"LOO {name} {method}: {mine}; the "
                              f"reference's {want} (iterations within "
                              f"{ITER_BAND:.0%}), the card's iterations "
                              f"{CARD_LOO[method]}")
            rows.append({"dataset": name, "n": n, "rounds": rounds,
                         "method": method, "base_iterations": mine[0],
                         "iterations": mine[1], "accuracy": mine[2],
                         "reference": want, "gated": gated, "wall_s": wall,
                         "chunk_routes": {r: after[r] - before[r]
                                          for r in after}})
        torch.cuda.empty_cache()
    emit({"phase": "loo", "seconds": time.perf_counter() - t0,
          "rows": rows})
    require(not failed, "; ".join(failed))


#: the shrink phase's heuristic period and compact quantum at Table 1's
#: sizes (every case compacts at least once), and the size phases'
SHRINK_EVERY, SHRINK_QUANTUM = 128, 32
SHRINK_SIZE_EVERY = 1024
#: the matrix-free size run's compact quantum: coarse, so that lanes share
#: cap buckets and run as groups on the per-lane kernels
SHRINK_SIZE_QUANTUM = 2048
#: per-lane calls of each kernel and lane size the shrink phase keeps to
#: check and time
SHRINK_RECORD = 2


class _LaneCalls:
    """Wraps ``repro_torch.svm.engine``'s per-lane chunk wrappers (those
    ``chunk_batched_sources`` calls) to keep a copy of the arguments of the
    first ``keep`` calls of each over more than one lane at each lane size
    (taken before the call, kept in host memory: the runs' device peaks
    stay theirs; ``replay`` moves a call back to the card)."""

    NAMES = ("smo_chunk_sources", "smo_stream_chunk_sources")

    def __init__(self, keep: int):
        from repro_torch.svm import engine
        self.engine, self.keep = engine, keep
        self.calls = {k: [] for k in self.NAMES}
        self.saved = {}

    def __enter__(self):
        for name in self.NAMES:
            fn = self.saved[name] = getattr(self.engine, name)

            def rec(*a, _fn=fn, _k=name, **kw):
                kept = sum(c[0][0].shape[1] == a[0].shape[1]
                           for c in self.calls[_k])
                if kept < self.keep and a[0].shape[0] > 1:
                    self.calls[_k].append(_clone_call(a, kw, to="cpu"))
                return _fn(*a, **kw)
            setattr(self.engine, name, rec)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.engine, name, fn)

    def replay(self, name: str):
        """The kept calls of ``name``, on the card."""
        return [_clone_call(a, kw, to="cuda") for a, kw in self.calls[name]]


def _lane_iters(before, after) -> int:
    """The most iterations a lane of a chunk took."""
    return max(int((after - before).max()), 1)


def _live_iters(before, after) -> list[int]:
    """The iterations each lane of a chunk took, lanes that took none
    (pad lanes, done at entry) left out: the work the chunk did."""
    return [i for i in (after - before).tolist() if i > 0]


def _check_dense_sources(a, kw) -> dict:
    """A recorded ``smo_chunk_sources`` call, replayed: each lane bitwise
    its own ``smo_chunk_lanes`` launch over its own K and the plain step
    engine (its f-update through the ``smo_f_update`` kernel); the call
    timed per iteration of its longest lane, the plain loop beside it."""
    from repro_torch.kernels import ops, ref
    (K, diag, y, masks, Cs, tol, caps, n_iters, wss, *state) = a
    b, cap = masks.shape
    before = ops.route_counts()["smo_chunk_sources"]
    got = ops.smo_chunk_sources(*_clone(a), **kw)
    route = _route_taken(before, ops.route_counts()["smo_chunk_sources"])
    sync()
    tp = time.perf_counter()
    plain = ref.smo_chunk_sources_ref(*_clone(a), update_f=ops.smo_f_update)
    sync()
    plain_s = time.perf_counter() - tp
    Cl = torch.as_tensor(Cs).reshape(-1).tolist()
    cl = torch.as_tensor(caps).reshape(-1).tolist()
    for l in range(b):
        solo = ops.smo_chunk_lanes(K[l], diag[l], y[l], masks[l:l + 1],
                                   [Cl[l]], tol, [cl[l]], n_iters, wss,
                                   *(t[l:l + 1].clone() for t in state))
        for g, s_, p_, what in zip(got, solo, plain,
                                   ("alpha", "f", "n_iter", "done")):
            require(torch.equal(g[l], s_[0]) and torch.equal(g[l], p_[l]),
                    f"smo_chunk_sources lane {l} ({route}): {what} differs "
                    "from its solo launch or the plain step engine")
    it = _lane_iters(state[2], got[2])
    # the wrapper copies the state it updates, so the inputs serve every
    # timed call as they are
    ms = cuda_ms(lambda: ops.smo_chunk_sources(*a, **kw), 3)
    # the work done: each live lane's own iterations, its K_i and K_j rows
    # an iteration and its state once, per iteration of the longest lane
    lane_its = _live_iters(state[2], got[2])
    work = sum(i * _chunk_iter_bytes(cap, i) for i in lane_its)
    return {"lanes": b, "live_lanes": len(lane_its), "cap": cap,
            "route": route, "iterations": it, "lane_iterations": lane_its,
            "ms": ms / it, "plain_ms": 1e3 * plain_s / it,
            "max_abs_err": 0.0, "library_ms": None,
            **_bound(work / it, 0.0)}


def _check_stream_sources(a, kw) -> dict:
    """A recorded ``smo_stream_chunk_sources`` call, replayed: each lane
    bitwise its own ``smo_stream_chunk`` over its own X on both routes,
    and within 1e-10 of the plain loop after up to 200 iterations (its
    products are a matmul, not the kernels' ordered fma); timed per
    iteration of its longest lane, the plain loop beside it."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.smo_chunk import pad_rows
    (X, sq, gamma, y, masks, Cs, tol, caps, n_iters, *state) = a
    b, cap, d = X.shape
    kw = dict(kw, X_rows=pad_rows(X))   # a copy keeps no padded rows
    before = ops.route_counts()["smo_stream_chunk_sources"]
    got = ops.smo_stream_chunk_sources(*_clone(a), **kw)
    route = _route_taken(before,
                         ops.route_counts()["smo_stream_chunk_sources"])
    Cl = torch.as_tensor(Cs).reshape(-1).tolist()
    cl = torch.as_tensor(caps).reshape(-1).tolist()
    for l in range(b):
        for r in ("pair", "persistent", "cluster"):
            solo = ops.smo_stream_chunk(
                X[l], sq[l], gamma, y[l], masks[l:l + 1], [Cl[l]], tol,
                [cl[l]], n_iters, *(t[l:l + 1].clone() for t in state),
                X_norms=kw["X_norms"][l], _route=r)
            for g, s_, what in zip(got, solo, ("alpha", "f", "n_iter",
                                               "done")):
                require(torch.equal(g[l], s_[0]),
                        f"smo_stream_chunk_sources lane {l} ({route}): "
                        f"{what} differs from its solo {r} launch")
    short = min(int(n_iters), 200)
    cut = ops.smo_stream_chunk_sources(*_clone(a[:8]), short,
                                       *_clone(state), **kw)
    sync()
    tp = time.perf_counter()
    plain = ref.smo_chunk_sources_ref(None, None, y, masks, Cs, tol, caps,
                                      short, "1", *_clone(state),
                                      stream=(X, sq, gamma))
    sync()
    plain_s = time.perf_counter() - tp
    err = max(float((cut[k] - plain[k]).abs().max()) for k in (0, 1))
    require(err <= 1e-10, f"smo_stream_chunk_sources: {err} from the plain "
                          "loop")
    it = _lane_iters(state[2], got[2])
    # the wrapper copies the state it updates, so the inputs serve every
    # timed call as they are
    ms = cuda_ms(lambda: ops.smo_stream_chunk_sources(*a, **kw), 3)
    # the work done: each live lane's own iterations, 4 cap d FP64
    # operations each (both kernel rows); its state, labels and norms
    # once; its X once where the live lanes' X fit in the L2 together,
    # else at every iteration it takes; per iteration of the longest lane
    lane_its = _live_iters(state[2], got[2])
    x_lane = 8.0 * cap * d
    x_bytes = sum(lane_its) * x_lane if len(lane_its) * x_lane > L2_BYTES \
        else len(lane_its) * x_lane
    state_bytes = len(lane_its) * cap * (8 * 4 + 1 + 8 * 3)
    return {"lanes": b, "live_lanes": len(lane_its), "cap": cap, "d": d,
            "route": route, "iterations": it, "lane_iterations": lane_its,
            "ms": ms / it,
            "plain_ms": 1e3 * plain_s / _lane_iters(state[2], plain[2]),
            "max_abs_err": err, "library_ms": None,
            "x_from_hbm_every_iteration": len(lane_its) * x_lane > L2_BYTES,
            **_bound((x_bytes + state_bytes) / it,
                     sum(lane_its) * 4.0 * cap * d / it)}


def _shrink_gates(tag: str, base, shr) -> dict:
    """A shrinking run against the same call without shrinking: every fold
    converged (its full-set gap within tol), the same per-fold correct
    counts, the objective within 1e-6 relative, a lane compacted; the
    shrink lifecycle's host reads one at each lane's chunk end and the
    others at boundaries only."""
    from repro_torch.svm import shrink
    occ = shr.occupancy
    require(all(f.converged for f in shr.folds),
            f"{tag}: a shrunk fold did not converge")
    got = [(f.acc_correct, f.acc_total) for f in shr.folds]
    want = [(f.acc_correct, f.acc_total) for f in base.folds]
    require(got == want, f"{tag}: per-fold correct {got}, unshrunk {want}")
    rel = max(abs(a.objective - b.objective) / abs(b.objective)
              for a, b in zip(shr.folds, base.folds))
    require(rel <= 1e-6, f"{tag}: objective {rel} relative from unshrunk")
    chunks = occ.get("shrink_lane_chunks", 0)
    require(chunks > 0 and occ["mean_active_frac"] < 1.0,
            f"{tag}: no lane compacted ({occ})")
    syncs = dict(shrink.HOST_SYNCS)
    require(syncs["chunk_end"] == chunks
            and syncs["gap"] + syncs["active"]
            <= 3 * chunks + 2 * len(shr.folds),
            f"{tag}: host reads {syncs} for {chunks} lane chunks")
    return {"iterations": shr.total_iterations,
            "unshrunk_iterations": base.total_iterations,
            "per_fold_iterations": [f.n_iter for f in shr.folds],
            "solve_s": shr.total_solve_time,
            "unshrunk_solve_s": base.total_solve_time,
            "init_s": shr.total_init_time,
            "mean_active_frac": occ["mean_active_frac"],
            "shrink_lane_chunks": chunks, "programs": occ["programs"],
            "objective_rel": rel, "host_reads": syncs,
            "accuracy": shr.accuracy}


def _gather_no_sync() -> dict:
    """A lane's compaction round trip (``enter``, ``scatter``,
    ``tighten``) on the card under ``set_sync_debug_mode("error")``: the
    gathers and scatters make no host sync."""
    from repro_torch.data.svm_suite import make_dataset
    from repro_torch.svm import kernel_matrix, shrink
    from repro_torch.svm.engine import DenseKernel, init_state, solve
    ds = make_dataset("adult", n_override=1000)
    dev = torch.device("cuda")
    X = torch.as_tensor(ds.X, device=dev)
    y = torch.as_tensor(ds.y, dtype=torch.float64, device=dev)
    src = DenseKernel(kernel_matrix(X, X, gamma=ds.gamma))
    mask = torch.ones(1000, dtype=torch.bool, device=dev)
    mask[:100] = False      # a fold's test rows never are active
    done = solve(src, y, mask, ds.C, torch.zeros_like(y), -y)
    state = init_state(src, y, mask, done.alpha, done.f)
    active, _ = shrink.active_set(state.alpha, state.f, y, mask, ds.C)
    ls = shrink.LaneShrink(1000, every=128, quantum=32)
    require(ls.mark(active, int(active.sum())),
            "shrink: the solved lane does not compact")
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ls.enter(src, y, state)
        full = ls.scatter(state)
        ls.tighten(ls.cmask.clone(), ls.m)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync()
    require(torch.equal(full.alpha, state.alpha)
            and torch.equal(full.f, state.f),
            "shrink: a compaction round trip changed the state")
    return {"cap": ls.cap, "active": ls.m}


def phase_shrink() -> dict:
    """Active-set shrinking at Table 1's sizes (heart n=270, adult n=1000,
    k=10, ``SHRINK_EVERY`` / ``SHRINK_QUANTUM``): ``run_cv`` cold and sir,
    then ``run_cv_batched`` dense and matrix-free (``pallas_rbf``), each
    beside the same call without shrinking (``_shrink_gates``); compact
    groups of more than one lane run the per-lane kernels, whose first
    calls are replayed (``_check_dense_sources`` /
    ``_check_stream_sources``). Returns the kernels line's entries, and
    the launch counts and routes read before the replays."""
    from repro_torch.core.cv import run_cv, run_cv_batched
    from repro_torch.data.svm_suite import make_dataset
    from repro_torch.kernels import ops
    from repro_torch.svm import shrink
    t0 = time.perf_counter()
    kw = dict(shrink_every=SHRINK_EVERY, shrink_quantum=SHRINK_QUANTUM)
    rows = []
    rec = _LaneCalls(SHRINK_RECORD)
    for name, refd in REFERENCE.items():
        ds = make_dataset(name, n_override=refd["n"])
        for method in ("cold", "sir"):
            base = run_cv(ds, k=10, method=method)
            shrink.HOST_SYNCS.update(dict.fromkeys(shrink.HOST_SYNCS, 0))
            shr = run_cv(ds, k=10, method=method, **kw)
            rows.append({"dataset": name, "call": "run_cv",
                         "method": method,
                         **_shrink_gates(f"shrink {name} {method}", base,
                                         shr)})
        for backend in ("dense", "pallas_rbf"):
            base = run_cv_batched(ds, k=10, source_backend=backend)
            shrink.HOST_SYNCS.update(dict.fromkeys(shrink.HOST_SYNCS, 0))
            with rec:
                shr = run_cv_batched(ds, k=10, source_backend=backend, **kw)
            rows.append({"dataset": name, "call": "run_cv_batched",
                         "method": backend,
                         **_shrink_gates(f"shrink {name} {backend}", base,
                                         shr)})
    for name in rec.NAMES:
        require(rec.calls[name], f"shrink: no compact group of more than "
                                 f"one lane reached {name}")
    counts, routes = ops.launch_counts(), ops.route_counts()
    checks = {
        "smo_chunk_sources": [_check_dense_sources(*c)
                              for c in rec.replay("smo_chunk_sources")],
        "smo_stream_chunk_sources": [
            _check_stream_sources(*c)
            for c in rec.replay("smo_stream_chunk_sources")]}
    no_sync = _gather_no_sync()
    emit({"phase": "shrink", "seconds": time.perf_counter() - t0,
          "shrink_every": SHRINK_EVERY, "shrink_quantum": SHRINK_QUANTUM,
          "rows": rows, "per_lane_checks": checks,
          "gather_no_sync": no_sync})
    # the kernels line: the widest recorded call of each
    return ({name: max(calls, key=lambda c: (c["lanes"], c["cap"]))
             for name, calls in checks.items()}, counts, routes)


def phase_shrink_size(ds, size_folds, mf_folds) -> dict:
    """Shrinking at the paper's cardinality (adult n=32,560, d=123,
    ``SHRINK_SIZE_EVERY``): (a) ``run_cv(k=10, method="sir")`` over the
    dense K, one lane at a time, beside the same run without shrinking:
    the same per-fold correct counts (``size``'s folds printed beside
    them) and peak memory under 2 x K's bytes (K and a lane's compact K);
    (b)
    matrix-free ``run_cv_batched`` of ten lanes beside
    ``size_matrix_free``'s unshrunk counts, peak under 3 GiB; its first
    per-lane call replayed and timed (``_check_stream_sources``). Returns
    the streaming entry at this size, and the launch counts and routes
    read before the replay."""
    from repro_torch.core.cv import run_cv, run_cv_batched
    from repro_torch.kernels import ops
    from repro_torch.svm import shrink
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    base = run_cv(ds, k=10, method="sir")
    k_bytes = base.n * base.n * 8
    # a finished run holds no K: reference counting alone frees it
    held = torch.cuda.memory_allocated()
    require(held < k_bytes, f"shrink_size: {held} B still allocated after "
                            f"the unshrunk run, K's {k_bytes}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shrink.HOST_SYNCS.update(dict.fromkeys(shrink.HOST_SYNCS, 0))
    shr = run_cv(ds, k=10, method="sir", shrink_every=SHRINK_SIZE_EVERY)
    peak = torch.cuda.max_memory_allocated()
    dense = _shrink_gates("shrink_size dense", base, shr)
    require(peak < 2 * k_bytes,
            f"shrink_size dense: peak {peak} B >= 2 x K's {k_bytes}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shrink.HOST_SYNCS.update(dict.fromkeys(shrink.HOST_SYNCS, 0))
    rec = _LaneCalls(1)
    with rec:
        mf = run_cv_batched(ds, k=10, source_backend="pallas_rbf",
                            shrink_every=SHRINK_SIZE_EVERY,
                            shrink_quantum=SHRINK_SIZE_QUANTUM)
    mf_peak = torch.cuda.max_memory_allocated()
    require(mf_peak < PEAK_LIMIT, f"shrink_size matrix-free: peak {mf_peak}"
                                  " B >= 3 GiB")
    mf_got = [(f.acc_correct, f.acc_total) for f in mf.folds]
    require(mf_got == mf_folds, f"shrink_size matrix-free: folds {mf_got}, "
                                f"size_matrix_free's {mf_folds}")
    require(all(f.converged for f in mf.folds)
            and mf.occupancy.get("shrink_lane_chunks", 0) > 0,
            "shrink_size matrix-free: a fold did not converge or no lane "
            "compacted")
    mf_syncs = dict(shrink.HOST_SYNCS)
    counts, routes = ops.launch_counts(), ops.route_counts()
    # the widest call kept at this size (one a lane size), on the card
    calls = rec.calls["smo_stream_chunk_sources"]
    entry = _check_stream_sources(*_clone_call(*max(
        calls, key=lambda c: (c[0][0].shape[0], c[0][0].shape[1])),
        to="cuda")) if calls else None
    rec.calls.clear()
    lane_max = max(f.n_iter for f in mf.folds)
    emit({"phase": "shrink_size", "seconds": time.perf_counter() - t0,
          "n": shr.n, "shrink_every": SHRINK_SIZE_EVERY,
          "matrix_free_quantum": SHRINK_SIZE_QUANTUM,
          "size_folds_correct": [f["correct"] for f in size_folds],
          "dense": {**dense, "peak_gb": peak / 1e9, "K_gb": k_bytes / 1e9,
                    "us_per_iteration":
                        1e6 * shr.total_solve_time
                        / max(shr.total_iterations, 1),
                    "unshrunk_us_per_iteration":
                        1e6 * base.total_solve_time
                        / max(base.total_iterations, 1)},
          "matrix_free": {
              "iterations": mf.total_iterations,
              "unshrunk_iterations": SIZE_MATRIX_FREE_ITERATIONS,
              "per_fold_iterations": [f.n_iter for f in mf.folds],
              "solve_s": mf.total_solve_time,
              "us_per_longest_lane_iteration":
                  1e6 * mf.total_solve_time / max(lane_max, 1),
              "mean_active_frac": mf.occupancy["mean_active_frac"],
              "shrink_lane_chunks": mf.occupancy["shrink_lane_chunks"],
              "host_reads": mf_syncs, "peak_gb": mf_peak / 1e9,
              "accuracy": mf.accuracy, "per_lane_call": entry}})
    return entry, counts, routes


def phase_svc(ds, size_folds, cold_folds) -> dict:
    """The ``SVC`` estimator: fit on adult n=32,560 without fold 0's rows,
    scored on fold 0 (the correct count of ``size``'s fold 0, and its
    iterations beside it); the same fit with ``SHRINK_SIZE_EVERY``
    predicting the same; ``cross_validate(k=10, method="sir")`` at adult
    n=1000 with Table 1's per-fold counts."""
    from repro_torch.data.svm_suite import kfold_chunks, make_dataset
    from repro_torch.svm import SVC
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    chunks = kfold_chunks(ds.n, 10)
    n = chunks.size
    test = np.sort(chunks[0])
    train = np.setdiff1d(np.arange(n), test)
    X, y = ds.X[:n], ds.y[:n]
    tf = time.perf_counter()
    svc = SVC(C=ds.C, gamma=ds.gamma).fit(X[train], y[train])
    sync()
    fit_s = time.perf_counter() - tf
    pred = svc.predict(X[test])
    correct = int((pred == y[test]).sum())
    f0 = size_folds[0]
    require(svc.converged_, "svc: the fit did not converge")
    require(correct == f0["correct"],
            f"svc: {correct} correct on fold 0, size's fold 0 {f0['correct']}")
    svc_s = SVC(C=ds.C, gamma=ds.gamma,
                shrink_every=SHRINK_SIZE_EVERY).fit(X[train], y[train])
    require(svc_s.converged_ and np.array_equal(svc_s.predict(X[test]), pred),
            "svc: the shrinking fit predicts otherwise")
    small = make_dataset("adult", n_override=REFERENCE["adult"]["n"])
    cv = SVC(C=small.C, gamma=small.gamma).cross_validate(
        small.X, small.y, k=10, method="sir")
    per_fold = [(f.acc_correct, f.acc_total) for f in cv.folds]
    require(per_fold == cold_folds["adult"],
            f"svc cross_validate: {per_fold}, Table 1's {cold_folds['adult']}")
    emit({"phase": "svc", "seconds": time.perf_counter() - t0,
          "n_train": int(train.size), "n_test": int(test.size),
          "n_iter": svc.n_iter_, "size_fold0_n_iter": f0["n_iter"],
          "shrink_n_iter": svc_s.n_iter_, "correct": correct,
          "fit_s": fit_s, "cross_validate_iterations": cv.total_iterations})


#: the service phase: tenant b's cold folds run at this multiple of the
#: paper's C; the daemons' chunk; the refusing daemons' budgets (a 4 GB
#: cache below one 8.48 GB K, and two Ks plus half the pinned K of
#: SERVICE_PIN_N rows, 1.28 MB, beside which the schedule co-holds both)
SERVICE_C_SCALE = 4.0
SERVICE_CHUNK = 4096
SERVICE_SMALL_CACHE = 4 * 10 ** 9
SERVICE_PIN_N = 400
#: the served part's peak allocated memory, in Ks
SERVICE_PEAK_KS = 1.5


def _service_plans(ds, Plan, KernelSpec):
    """Tenant a: ``size``'s chain (fold 0 cold, folds 1-2 SIR, ``after``
    edges); tenant b: folds 3-4 cold at ``SERVICE_C_SCALE`` x C. Both over
    the same declared kernel, host arrays (the wire's)."""
    from repro_torch.core.cv import _fold_masks, _transition_idx
    from repro_torch.data.svm_suite import kfold_chunks
    chunks = kfold_chunks(ds.n, 10)
    n = chunks.size
    X = torch.as_tensor(ds.X[:n], dtype=torch.float64)
    y = torch.as_tensor(ds.y[:n], dtype=torch.float64)
    masks = torch.as_tensor(_fold_masks(chunks))

    def plan(folds, C, sir):
        p = Plan(sources={"adult": KernelSpec(X=X, gamma=ds.gamma, n=n)},
                 y=y, chunk_iters=SERVICE_CHUNK)
        prev = None
        for h in folds:
            common = dict(train_mask=masks[h], C=C, after=prev)
            if prev is None or not sir:
                p.lane(h, alpha0=torch.zeros_like(y), f0=-y, **common)
            else:
                S, R, T = _transition_idx(chunks, prev, h)
                p.lane(h, dep=prev, transform="fold", params=dict(
                    method="sir", S_idx=S, R_idx=R, T_idx=T), **common)
            p.evaluate(h, chunks[h])
            prev = h
        return p

    return (plan((0, 1, 2), ds.C, True),
            plan((3, 4), SERVICE_C_SCALE * ds.C, False), X, y, masks, chunks)


def _bitwise(want: dict, got: dict) -> bool:
    return set(want) == set(got) and all(
        torch.equal(want[k].alpha.cpu(), got[k].alpha.cpu())
        and torch.equal(want[k].f.cpu(), got[k].f.cpu())
        and int(want[k].n_iter) == int(got[k].n_iter) for k in want)


def _serve(service):
    """A ``StudyServer`` over ``service`` on a fresh AF_UNIX socket under
    /tmp, its accept loop on a thread: (server, thread)."""
    import uuid
    from repro_torch.service import StudyServer
    sock = f"/tmp/study-{uuid.uuid4().hex[:8]}.sock"
    server = StudyServer(sock, service)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    for _ in range(400):
        if os.path.exists(sock):
            return server, thread
        time.sleep(0.05)
    raise RuntimeError(f"the study daemon did not bind {sock}")


def _stop(server, thread) -> None:
    from repro_torch.service import StudyClient
    with StudyClient(server.socket_path, "operator") as cli:
        cli.shutdown()
    thread.join(timeout=120)
    require(not thread.is_alive(), "the study daemon did not drain")


def phase_service(ds, size_folds):
    """The study service at adult n=32,560 (d=123, k=10, Table 2's C and
    gamma), one process: ``StudyServer`` daemons on AF_UNIX sockets under
    /tmp and ``StudyClient`` tenants.

    * two tenants, one kernel: tenant a's chain and tenant b's folds
      (``_service_plans``) submitted at once; each served lane bitwise the
      in-process ``run_plan`` of its plan on the card, one dedup hit, one
      ``rbf_kernel_matrix`` launch over the served part (each solo run
      launches one), the served part's peak allocated memory under
      ``SERVICE_PEAK_KS`` Ks, both tenants served;
    * two refusals over the wire before anything is put on the card: a
      4 GB cache (``cache-infeasible``), and two gammas' Ks beside a
      pinned K, each fitting, the schedule co-holding both
      (``cache-infeasible-time``); the RBF kernel's count and the
      allocated memory unchanged;
    * kill and restart: a service stepped through chunks with snapshot
      ticks until a lane retires, abandoned without a drain; a second one
      of another width takes the same (tenant, plan_id): the retired lanes
      enter solved, every lane bitwise the solo run;
    * the cost model's ``cuda`` verdicts are the file's, and a pool built
      with ``max_width=None, shrink_every="auto"`` takes them.

    Returns (record, counts, routes) of the served part."""
    import gc
    import shutil
    import tempfile
    from repro_torch.analysis import plan_check
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as manager_mod
    from repro_torch.core import study as study_mod
    from repro_torch.kernels import ops
    from repro_torch.service import (PlanRejectedByServer, StudyClient,
                                     StudyService)
    from repro_torch.svm import (DenseKernel, KernelSpec, LanePool, PallasRBF,
                                 cost_model)
    from repro_torch.svm.kernels import kernel_matrix
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    plan_a, plan_b, X, y, masks, chunks = _service_plans(
        ds, study_mod.Plan, KernelSpec)
    n = int(y.shape[0])
    K_bytes = n * n * 8
    rec = {"phase": "service", "n": n, "d": int(X.shape[1]),
           "K_gb": K_bytes / 1e9}

    # in-process runs of the same plans on the card
    solo, solo_s, solo_rbf = {}, {}, {}
    for t, plan in (("a", plan_a), ("b", plan_b)):
        before = ops.launch_counts()["rbf_kernel_matrix"]
        sync()
        ts = time.perf_counter()
        solo[t] = study_mod.run_plan(plan)
        sync()
        solo_s[t] = time.perf_counter() - ts
        solo_rbf[t] = ops.launch_counts()["rbf_kernel_matrix"] - before
        torch.cuda.empty_cache()
    require(solo_rbf == {"a": 1, "b": 1},
            f"service: the solo runs launched the RBF kernel {solo_rbf}")
    rec["solo_s"], rec["solo_rbf_launches"] = solo_s, solo_rbf
    rec["n_iter"] = {t: {str(k): st.n_iter for k, st in r.stats.items()}
                     for t, r in solo.items()}
    rec["size_n_iter"] = [f["n_iter"] for f in size_folds]

    # admission's host cost: parse + check_plan with the simulator's
    # bounds, on the host plan (what the daemon runs before any kernel)
    wire_a = json.loads(json.dumps(study_mod.plan_to_dict(plan_a)))
    ta = time.perf_counter()
    parsed = study_mod.plan_from_dict(wire_a, device="cuda")
    pa = plan_check.check_plan(parsed, simulate="bounds")
    rec["admission_host_s"] = time.perf_counter() - ta
    rec["admission_programs"] = pa.program_count

    # two tenants, one kernel, served over the socket
    service = StudyService(chunk_iters=SERVICE_CHUNK, max_width=0)
    server, thread = _serve(service)
    served, errors = {}, []

    def tenant(t, plan):
        try:
            with StudyClient(server.socket_path, t) as cli:
                served[t] = cli.submit("p", plan)
        except Exception as e:          # re-raised on the main thread
            errors.append(e)

    sync()
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    ts = time.perf_counter()
    # the service thread waits on a gate until both submissions are queued
    # behind it, a's first: it then admits both before its first step, so
    # b meets a's kernel in flight whatever the clients' encoding takes
    gate = threading.Event()
    service.enqueue(lambda: gate.wait(300))
    clients = [threading.Thread(target=tenant, args=(t, plan))
               for t, plan in (("a", plan_a), ("b", plan_b))]
    for queued, c in enumerate(clients, 1):
        c.start()
        while service._cmds.qsize() < queued and c.is_alive():
            time.sleep(0.005)
    gate.set()
    for c in clients:
        c.join()
    sync()
    rec["served_s"] = time.perf_counter() - ts
    counts, routes = ops.launch_counts(), ops.route_counts()
    peak = torch.cuda.max_memory_allocated() - base_alloc
    with StudyClient(server.socket_path, "operator") as cli:
        status = cli.status()
    _stop(server, thread)
    if errors:
        raise errors[0]
    rec["peak_gb"] = peak / 1e9
    rec["dedup_hits"] = {t: served[t].dedup_hits for t in served}
    rec["sources_admitted"] = {t: served[t].sources_admitted for t in served}
    rec["tenant_served"] = {t: served[t].tenant_stats["served"]
                            for t in served}
    rec["status_tenants"] = sorted(status["tenants"])
    require(counts["rbf_kernel_matrix"] == 1,
            f"service: {counts['rbf_kernel_matrix']} RBF launches for two "
            "tenants on one kernel")
    require(rec["dedup_hits"] == {"a": 0, "b": 1}
            and rec["sources_admitted"] == {"a": 1, "b": 0},
            f"service: dedup hits {rec['dedup_hits']}")
    require(peak < SERVICE_PEAK_KS * K_bytes,
            f"service: peak {peak / 1e9:.2f} GB over the served part")
    for t in ("a", "b"):
        require(_bitwise(solo[t].results, served[t].results),
                f"service: tenant {t}'s served lanes are not its run_plan's")
        require(served[t].evals == solo[t].evals,
                f"service: tenant {t}'s counts {served[t].evals}, in-process "
                f"{solo[t].evals}")
        require(rec["tenant_served"][t] > 0 and t in status["tenants"],
                f"service: tenant {t} was not served")
    rec["correct"] = {t: {str(k): v[0] for k, v in served[t].evals.items()}
                      for t in served}

    # where the served wall goes: the wire images' encode and decode, and
    # the same two submissions in process (the caller the service
    # thread), admission, the pool's steps and the finishing evaluations
    # timed apart
    te = time.perf_counter()
    text = json.dumps(study_mod.plan_to_dict(plan_a))
    td = time.perf_counter()
    json.loads(text)
    split = {"encode_a_s": td - te, "decode_a_s": time.perf_counter() - td,
             "wire_a_mb": len(text) / 1e6, "admit_s": 0.0, "steps_s": 0.0,
             "finish_s": 0.0, "steps": 0}
    wire_b = json.loads(json.dumps(study_mod.plan_to_dict(plan_b)))
    inproc = StudyService(chunk_iters=SERVICE_CHUNK, max_width=0)
    sync()
    ts = time.perf_counter()
    for t, wire in (("a", wire_a), ("b", wire_b)):
        inproc.submit(t, "p", wire, lambda msg: None)
    sync()
    split["admit_s"] = time.perf_counter() - ts
    while inproc._studies:
        t1 = time.perf_counter()
        inproc.pool.step()
        sync()
        t2 = time.perf_counter()
        inproc._finish_ready()
        sync()
        split["steps_s"] += t2 - t1
        split["finish_s"] += time.perf_counter() - t2
        split["steps"] += 1
    split["total_s"] = time.perf_counter() - ts
    rec["served_split"] = split
    del inproc
    torch.cuda.empty_cache()

    # refusals over the wire, before anything is put on the card
    Xp = X[:SERVICE_PIN_N]
    pinned_plan = study_mod.Plan(
        sources={"pin": DenseKernel(kernel_matrix(Xp, Xp, gamma=ds.gamma)),
                 **{g: KernelSpec(X=X, gamma=g * ds.gamma, n=n)
                    for g in (0.5, 2.0)}},
        y={"pin": y[:SERVICE_PIN_N], 0.5: y, 2.0: y},
        chunk_iters=SERVICE_CHUNK)
    for key in pinned_plan.sources:
        rows = pinned_plan.y[key].shape[0]
        pinned_plan.lane((key, 0), source=key, train_mask=masks[0][:rows],
                         C=ds.C, alpha0=torch.zeros(rows,
                                                    dtype=torch.float64),
                         f0=-pinned_plan.y[key])
    torch.cuda.empty_cache()
    sync()
    rbf0 = ops.launch_counts()["rbf_kernel_matrix"]
    alloc0 = torch.cuda.memory_allocated()
    refusals = {}
    for name, budget, plan, rule in (
            ("cache_4gb", SERVICE_SMALL_CACHE, plan_a, "cache-infeasible"),
            ("co_held", 2 * K_bytes + SERVICE_PIN_N ** 2 * 4, pinned_plan,
             "cache-infeasible-time")):
        server, thread = _serve(StudyService(chunk_iters=SERVICE_CHUNK,
                                             max_width=0,
                                             cache_bytes=budget))
        try:
            with StudyClient(server.socket_path, "c") as cli:
                cli.submit(name, plan)
            refused = None
        except PlanRejectedByServer as e:
            refused = e
        _stop(server, thread)
        require(refused is not None, f"service: {name} was admitted")
        rules = sorted({f["rule"] for f in refused.findings
                        if f["severity"] == "error"})
        require(rules == [rule] and refused.analysis is not None,
                f"service: {name} refused with {rules}")
        refusals[name] = {"cache_bytes": budget, "rules": rules,
                          "peak_managed_bytes":
                          refused.analysis["peak_managed_bytes"],
                          "sim_min_peak_bytes":
                          refused.analysis["sim"]["min"]
                          ["peak_resident_bytes"]
                          if refused.analysis["sim"] else None}
    sync()
    require(ops.launch_counts()["rbf_kernel_matrix"] == rbf0
            and torch.cuda.memory_allocated() == alloc0,
            "service: a refused plan put something on the card")
    rec["refusals"] = refusals

    # kill and restart under another width
    root = tempfile.mkdtemp(prefix="study-ckpt-", dir="/tmp")
    saves = {"records": 0, "bytes": 0, "host_syncs": 0, "seconds": 0.0}
    real_save = manager_mod.CheckpointManager.save

    def counted(self, step, tree, *args, **kwargs):
        saves["records"] += 1
        saves["host_syncs"] += sum(
            1 for v in tree.values()
            if isinstance(v, torch.Tensor) and v.device.type == "cuda")
        saves["bytes"] += sum(v.numel() * v.element_size()
                              for v in tree.values())
        tw = time.perf_counter()
        out = real_save(self, step, tree, *args, **kwargs)
        saves["seconds"] += time.perf_counter() - tw
        return out

    manager_mod.CheckpointManager.save = counted
    try:
        first = StudyService(chunk_iters=SERVICE_CHUNK, max_width=0,
                             checkpoint_root=root)
        ev1 = []
        first.submit("a", "p", wire_a, ev1.append)
        ts = time.perf_counter()
        while not [m for m in ev1 if m["type"] == "result"]:
            require(first.pool.step(), "service: the first daemon idled")
            first._snapshot_tick()
        for _ in range(2):
            first.pool.step()
            first._snapshot_tick()
        snap_s = time.perf_counter() - ts
        require(first._studies, "service: the study ended before the kill")
        del first                       # killed: no drain
        # the lanes its newest snapshot holds retired
        _, tree, extra = CheckpointManager.namespaced(
            root, "a", "p").restore_latest_of_class("study")
        retired = {study_mod._freeze(lid)[1] for lid, done in
                   zip(extra["lane_ids"], tree["done"]) if done}
        gc.collect()
        torch.cuda.empty_cache()
        second = StudyService(chunk_iters=SERVICE_CHUNK, max_width=1,
                              checkpoint_root=root)
        ev2 = []
        second.submit("a", "p", wire_a, ev2.append)
        while second._studies:
            second.pool.step()
            second._snapshot_tick()
            second._finish_ready()
    finally:
        manager_mod.CheckpointManager.save = real_save
    (adm,) = [m for m in ev2 if m["type"] == "admitted"]
    (done,) = [m for m in ev2 if m["type"] == "done"]
    resumed = {study_mod._from_wire(m["lane"]):
               study_mod.result_from_dict(m["result"])
               for m in ev2 if m["type"] == "result"}
    require(adm["restored"] == len(retired) > 0
            and {study_mod._freeze(x) for x in done["restored"]} == retired,
            f"service: restored {adm['restored']}, retired {retired}")
    require(_bitwise(solo["a"].results, resumed),
            "service: the restarted study is not the solo run's")
    rec["restart"] = {"retired_before_kill": sorted(retired),
                      "restored": adm["restored"], "first_s": snap_s,
                      "widths": [0, 1]}
    rec["snapshots"] = saves
    del second
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # the cost model's cuda verdicts are the file's, and a pool takes them
    with open(os.path.join(ROOT, "results", "cost_model_torch.json")) as fh:
        model = json.load(fh)
    verdicts = {}
    Xs = X[:64].cuda()
    for kind in ("dense", "pallas_rbf"):
        entry = model["entries"]["cuda"][kind]
        source = (DenseKernel(kernel_matrix(Xs, Xs, gamma=ds.gamma))
                  if kind == "dense" else PallasRBF(Xs, ds.gamma))
        pool = LanePool({"s": source}, y[:64].cuda(),
                        wss="1" if kind == "pallas_rbf" else "2",
                        max_width=None, shrink_every="auto")
        got = {"max_width": cost_model.pick_max_width("cuda", (kind,)),
               "shrink": cost_model.pick_shrink("cuda", (kind,)),
               "pool_max_width": pool.max_width,
               "pool_shrink": bool(pool.shrink_every)}
        require(got["max_width"] == got["pool_max_width"]
                == entry["max_width"] and got["shrink"] == got["pool_shrink"]
                == entry["shrink"],
                f"service: the {kind} verdicts {got}, the file's {entry}")
        verdicts[kind] = got
    rec["cost_model"] = verdicts
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return rec, counts, routes


def split_main(argv) -> int:
    """``--seed-split [--src DIR]``: only the seeding split (and
    ``phase_size``'s SIR seeds), then Table 1's init and solve times
    (``run_cv``, k=10), of the package under DIR (default this checkout's
    ``src``): the same measurement on another tree, in one call."""
    if "--src" in argv:
        sys.path.insert(0, os.path.abspath(argv[argv.index("--src") + 1]))
    from repro_torch.data.svm_suite import make_dataset
    from repro_torch.kernels import _build
    import repro_torch
    _build.build_all()
    print(card_line(), flush=True)
    emit({"phase": "seed_split_tree", "package": repro_torch.__file__})
    phase_seed_split(make_dataset("adult", n_override=SIZE_N))
    emit({"phase": "table1_times", "rows": _table1_times()})
    return 0


def _size_wide_times(reps: int = 2) -> list:
    """``size_wide``'s batched run (``WIDE_DENSE_K`` dense folds at adult
    n=32,560 on the cluster chunk), ``reps`` times: iterations, solve s
    and us per longest-lane iteration."""
    from repro_torch.core.cv import run_cv_batched
    from repro_torch.data.svm_suite import make_dataset
    ds = make_dataset("adult", n_override=SIZE_N)
    rows = []
    for _ in range(reps):
        torch.cuda.empty_cache()
        rep = run_cv_batched(ds, k=WIDE_DENSE_K, schedule="batched")
        lane_max = max(f.n_iter for f in rep.folds)
        rows.append({"iterations": rep.total_iterations,
                     "solve_s": rep.total_solve_time,
                     "us_per_longest_lane_iteration":
                         1e6 * rep.total_solve_time / max(lane_max, 1)})
    return rows


def _table1_times() -> list:
    """Table 1 through ``run_cv`` (k=10, the four methods, heart and
    adult): iterations, summed init and solve seconds, accuracy."""
    from repro_torch.core.cv import run_cv
    from repro_torch.data.svm_suite import make_dataset
    rows = []
    for name, refd in REFERENCE.items():
        ds = make_dataset(name, n_override=refd["n"])
        for method in METHODS:
            rep = run_cv(ds, k=10, method=method)
            rows.append({"dataset": name, "method": method,
                         "iterations": rep.total_iterations,
                         "init_s": rep.total_init_time,
                         "solve_s": rep.total_solve_time,
                         "accuracy": rep.accuracy})
    return rows


def _compare_seeding() -> dict:
    """The seeding kernels this tree runs, on inputs that do not depend on
    the tree: ``water_fill`` at 800 and 26,048 rows (seeded numpy, graph),
    and SIR's greedy pass as ``sir_seed`` takes it (``_sir_pass_ms``) at
    adult n = 1,000's Table 1 fold (100 x 100) and n = 32,560's k = 10, 5
    and 3 folds."""
    from repro_torch.kernels import seeding as ks
    from repro_torch.svm import kernel_matrix
    from repro_torch.data.svm_suite import make_dataset
    out = {"water_fill": {}}
    for a in _water_fill_big(1.0, (800, 26048)):
        out["water_fill"][str(a[0].shape[0])] = graph_ms(
            lambda: ks.water_fill(*a), 20)
    ds, K, y, _, (S, R, T) = _seed_problem("adult", 1000)
    pri = torch.as_tensor(np.random.default_rng(1).random(T.shape[0]),
                          device=K.device)
    alpha = torch.ones(R.shape[0], dtype=torch.float64, device=K.device)
    out["sir_greedy"] = {"100": _sir_pass_ms(K, y[R], y[T], alpha, pri, R,
                                             T, 20)}
    ds = make_dataset("adult", n_override=SIZE_N)
    dev = torch.device("cuda")
    X = torch.as_tensor(ds.X[:SIZE_N - 1], device=dev)
    y = torch.as_tensor(ds.y[:SIZE_N - 1], dtype=torch.float64, device=dev)
    K = kernel_matrix(X, X, gamma=ds.gamma)
    for k in SIR_SIZE_K:
        a = _sir_size_inputs(K, y, k)
        out["sir_greedy"][str(a[4].shape[0])] = _sir_pass_ms(K, *a)
    del K
    torch.cuda.empty_cache()
    return out


def compare_main(argv) -> int:
    """``--compare [--src DIR]``: times of the package under DIR (default
    this checkout's ``src``), so that two trees are timed in one call, in
    turns: the bf16 mma.sync route at FLASH_D32 and FLASH_D16 and the
    wgmma route at FLASH_GRANITE beside SDPA's and the bounds
    (``_time_flash``), and at gemma3's prefill windowed and global
    (``_gemma3_flash_ms``), and the 20-fold matrix-free row
    (adult n=1000, the selection kernel's main path), three times:
    iterations, solve s and us per longest-lane iteration; the seeding
    kernels (``_compare_seeding``) and one SIR seed of the grid at size
    split into its parts (``grid_seed_split``); then Table 1's iterations
    and summed init and solve seconds (``_table1_times``), ``size_wide``'s
    batched run (``_size_wide_times``), the Study
    layer at Table 1's sizes (``phase_study_seeds``), the grid at size
    (``phase_grid_size``) and LOO (``phase_loo``), each gated as in the
    full run (``chip_select_split.py --src DIR`` times the selection
    kernel itself). With ``--flash``, the attention times alone."""
    if "--src" in argv:
        sys.path.insert(0, os.path.abspath(argv[argv.index("--src") + 1]))
    from repro_torch.core.cv import run_cv_batched
    from repro_torch.data.svm_suite import make_dataset
    from repro_torch.kernels import _build
    import repro_torch
    _build.build_all()
    print(card_line(), flush=True)
    emit({"phase": "compare_tree", "package": repro_torch.__file__})
    emit({"phase": "compare_flash", **{
        name: _time_flash(shape, check=False)
        for name, shape in (("d32", FLASH_D32), ("d16", FLASH_D16),
                            ("granite", FLASH_GRANITE))},
        "gemma3": _gemma3_flash_ms(*_gemma3_flash_inputs()[1])})
    if "--flash" in argv:
        return 0
    ds = make_dataset("adult", n_override=REFERENCE["adult"]["n"])
    rows = []
    for _ in range(3):
        sync()
        rep = run_cv_batched(ds, k=WIDE_K, source_backend="pallas_rbf")
        lane_max = max(f.n_iter for f in rep.folds)
        rows.append({"iterations": rep.total_iterations,
                     "solve_s": rep.total_solve_time,
                     "us_per_longest_lane_iteration":
                         1e6 * rep.total_solve_time / max(lane_max, 1),
                     "accuracy": rep.accuracy})
    emit({"phase": "compare_wide_k", "k": WIDE_K, "rows": rows})
    emit({"phase": "compare_seeding", **_compare_seeding()})
    phase_grid_seed_split()
    rows = _table1_times()
    emit({"phase": "compare_table1", "rows": rows, "init_s": sum(
        r["init_s"] for r in rows), "solve_s": sum(r["solve_s"]
                                                   for r in rows)})
    emit({"phase": "compare_size_wide", "rows": _size_wide_times()})
    phase_study_seeds()
    phase_grid_size(make_dataset("adult", n_override=SIZE_N))
    phase_loo()
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--seed-split" in sys.argv:
        return split_main(sys.argv)
    if "--compare" in sys.argv:
        return compare_main(sys.argv)
    from repro_torch.kernels import ops
    from repro_torch.kernels import seeding as ks
    # float32 products in full float32 (no TF32) in the plain versions too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    build_s, card = phase_build()
    datasets = _datasets()
    info = phase_kernels(datasets)
    info.update(phase_fused(datasets))
    info["flash_attention"] = phase_flash()
    phase_lane_chunks(datasets)
    info.update(phase_stream_routes(datasets))

    split = phase_seed_split(datasets[("adult", SIZE_N - 1)])["split"]

    # each path: counts from 0 just before it, read just after
    counts, routes, sir_events, top_walks = {}, {}, {}, {}
    ops.reset_launch_counts()
    ks.reset_sir_greedy_events()
    cold_folds = phase_table1(build_s, split)
    counts["table1"], routes["table1"] = (ops.launch_counts(),
                                          ops.route_counts())
    sir_events["table1"] = ks.sir_greedy_events()
    ops.reset_launch_counts()
    phase_table1_batched(cold_folds)
    counts["table1_batched"], routes["table1_batched"] = (
        ops.launch_counts(), ops.route_counts())
    ops.reset_launch_counts()
    size_folds = phase_size(datasets[("adult", SIZE_N - 1)])
    dense_accs = [f["accuracy"] for f in size_folds]
    counts["size"], routes["size"] = ops.launch_counts(), ops.route_counts()
    counts["size_wide"], routes["size_wide"], wide = phase_size_wide(
        datasets[("adult", SIZE_N - 1)])
    info["smo_chunk_cluster"] = wide["cluster"]
    info["smo_chunk_one_block_global"] = wide["one_block_global"]
    ops.reset_launch_counts()
    mf_folds = phase_size_matrix_free(datasets[("adult", SIZE_N - 1)],
                                      dense_accs)
    counts["size_matrix_free"], routes["size_matrix_free"] = (
        ops.launch_counts(), ops.route_counts())
    # active-set shrinking: Table 1's sizes, the paper's cardinality, and
    # the SVC estimator (its per-lane kernels' replays launch after each
    # path's counts are read)
    ops.reset_launch_counts()
    shrink_info, counts["shrink"], routes["shrink"] = phase_shrink()
    ops.reset_launch_counts()
    size_entry, counts["shrink_size"], routes["shrink_size"] = \
        phase_shrink_size(datasets[("adult", SIZE_N - 1)], size_folds,
                          mf_folds)
    ops.reset_launch_counts()
    phase_svc(datasets[("adult", SIZE_N - 1)], size_folds, cold_folds)
    counts["svc"], routes["svc"] = ops.launch_counts(), ops.route_counts()
    info.update(shrink_info)
    info["smo_stream_chunk_sources"]["at_32560"] = size_entry
    for path, run in (
            ("study_seeds", phase_study_seeds),
            ("grid_size",
             lambda: phase_grid_size(datasets[("adult", SIZE_N - 1)])),
            ("loo", phase_loo)):
        ops.reset_launch_counts()
        ks.reset_sir_greedy_events()
        ks.reset_top_spill_walks()
        run()
        counts[path], routes[path] = ops.launch_counts(), ops.route_counts()
        sir_events[path] = ks.sir_greedy_events()
        top_walks[path] = ks.top_spill_walks()
    # the study service at size: the phase reads the counts around its
    # served part itself (its solo runs and checks launch the kernels too)
    service_rec, counts["service"], routes["service"] = phase_service(
        datasets[("adult", SIZE_N - 1)], size_folds)
    # one SIR seed of the grid at size, split into its parts (outside the
    # counted paths)
    info["grid_seed_split"] = phase_grid_seed_split()
    # the serving path resets and reads the counts around its main path
    # itself: its checks that follow launch the kernel too
    counts["serve_lm"], routes["serve_lm"] = phase_serve_lm(
        info["flash_attention"]["ms"])
    # gemma3-4b's sliding-window layers on the kernel; then yi-34b, whose
    # 68.78 GB of weights need every other phase's tensors gone
    counts["serve_gemma3"], routes["serve_gemma3"], gemma3_flash = \
        phase_serve_gemma3()
    counts["serve_yi"], routes["serve_yi"] = phase_serve_yi()
    # deepseek-v2-236b (58.38 GB at 8 layers): MLA's prefill on the kernel
    # at (192, 128), its absorbed decode and the MoE
    counts["serve_deepseek"], routes["serve_deepseek"], mla_flash = \
        phase_serve_deepseek()
    # jamba-v0.1-52b (52.1 GB at 16 layers): mamba's selective scan on its
    # kernel, two NoPE attention layers on flash_attention, the MoE
    counts["serve_jamba"], routes["serve_jamba"], info["selective_scan"] = \
        phase_serve_jamba()
    # xlstm-125m (0.25 GB, full depth): mLSTM's parallel form and the sLSTM
    # recurrence on their kernels
    counts["serve_xlstm"], routes["serve_xlstm"], xlstm_kernels = \
        phase_serve_xlstm()
    info.update(xlstm_kernels)
    emit({"phase": "kernel_counts", **counts})
    emit({"phase": "sir_greedy_events", **sir_events})
    emit({"phase": "top_spill_walks", **top_walks})
    emit({"phase": "route_counts", **routes})
    for name in ("rbf_kernel_matrix", "smo_chunk", "water_fill",
                 "sir_greedy", "ato_system_lanes", "ato_apply_lanes"):
        require(counts["table1"][name] > 0,
                f"{name} was not launched on the Table-1 path")
    # the Study paths: the batched ATO ramp's kernels on the ATO C row,
    # the spills on LOO, and the seeds and chunks on the grid at size
    for name in ("ato_system_lanes", "ato_apply_lanes", "water_fill",
                 "sir_greedy", "smo_chunk", "rbf_kernel_matrix"):
        require(counts["study_seeds"][name] > 0,
                f"{name} was not launched on the study_seeds path")
    # ATO's ramp: its first step compact, the others carried, every apply
    # fused (alpha updated in it: no smo_f_update or clamp launch)
    ato_steps = {}
    for path in ("table1", "study_seeds", "loo"):
        sysr = routes[path]["ato_system_lanes"]
        appr = routes[path]["ato_apply_lanes"]
        steps = counts[path]["ato_apply_lanes"]
        require(appr == {"split": 0, "fused": steps}
                and sysr["compact"] + sysr["carried"] == steps
                and counts[path]["smo_f_update"] == 0,
                f"{path}: ATO's ramp took {sysr} / {appr} and "
                f"{counts[path]['smo_f_update']} smo_f_update launches")
        ato_steps[path] = {
            "steps": steps, "ramps": sysr["compact"],
            "launches_per_step": {
                name: counts[path][name] / max(steps, 1)
                for name in ("ato_system_lanes", "ato_apply_lanes",
                             "smo_f_update")},
            "ato_system_lanes": sysr, "ato_apply_lanes": appr}
    require(ato_steps["table1"]["ato_system_lanes"]["carried"] > 0,
            "table1: no ramp step took the carried route")
    emit({"phase": "ato_step_launches", **ato_steps})
    for name in ("avg_spill", "top_spill", "water_fill", "sir_greedy",
                 "ato_system_lanes", "smo_chunk"):
        require(counts["loo"][name] > 0,
                f"{name} was not launched on the LOO path")
    # every AVG and TOP seed of LOO takes its spill's fused route (the
    # seeder's prologue, order and spill in one launch), every TOP walk
    # counted
    for name in ("avg_spill", "top_spill"):
        require(routes["loo"][name] == {"fused": counts["loo"][name],
                                        "split": 0},
                f"loo: {name}'s routes {routes['loo'][name]}")
    require(top_walks["loo"]["seeds"] == counts["loo"]["top_spill"],
            f"loo: {top_walks['loo']['seeds']} TOP walks counted for "
            f"{counts['loo']['top_spill']} seeds")
    for name in ("rbf_kernel_matrix", "sir_greedy", "water_fill",
                 "smo_chunk"):
        require(counts["grid_size"][name] > 0,
                f"{name} was not launched on the grid_size path")
    # the daemon's served part: one K for two tenants, the SIR seeds and
    # the dense chunk (many blocks a lane at n = 32,560)
    for name in ("rbf_kernel_matrix", "sir_greedy", "water_fill",
                 "smo_chunk"):
        require(counts["service"][name] > 0,
                f"{name} was not launched on the service path")
    require(counts["service"]["rbf_kernel_matrix"] == 1,
            f"service: {counts['service']['rbf_kernel_matrix']} RBF "
            "launches on the served part")
    # every dense chunk of Table 1 and its batched rows (heart and adult
    # n=1000) takes the resident one-block kernel; n=32,560 spreads one
    # lane over many blocks of a cooperative launch, and the wide batch
    # there (checked in phase_size_wide) each lane over a cluster
    for path in ("table1", "table1_batched"):
        chunk = routes[path]["smo_chunk"]
        require(chunk["one_block"] > 0 and chunk["multi_block"] == 0
                and chunk["cluster"] == 0
                and chunk["one_block_global"] == 0,
                f"{path}: the dense chunk's routes {chunk}")
    chunk = routes["size"]["smo_chunk"]
    require(chunk["multi_block"] > 0 and chunk["one_block"] == 0
            and chunk["cluster"] == 0 and chunk["one_block_global"] == 0,
            f"size: the dense chunk's routes {chunk}")
    # the batched path's ten folds take a one-launch streaming chunk (the
    # cluster route on some), its twenty folds the pair route (fused step +
    # selection) while more than 16 are live; the matrix-free size path
    # the cluster route, and never the pair route
    for name in ("rbf_kernel_matrix", "smo_chunk", "fused_smo_step",
                 "smo_select", "smo_stream_chunk"):
        require(counts["table1_batched"][name] > 0,
                f"{name} was not launched on the batched path")
    require(routes["table1_batched"]["smo_stream_chunk"]["pair"] > 0
            and routes["table1_batched"]["smo_stream_chunk"]["cluster"] > 0,
            "the batched path did not take the pair and cluster streaming "
            "routes")
    require(counts["size_matrix_free"]["smo_stream_chunk"] > 0
            and routes["size_matrix_free"]["smo_stream_chunk"]["pair"] == 0
            and routes["size_matrix_free"]["smo_stream_chunk"]["cluster"] > 0,
            "the matrix-free size path did not run the cluster chunk "
            "without pairs")
    require(counts["size_matrix_free"]["rbf_kernel_matrix"] == 0,
            "the matrix-free path built a kernel matrix")
    # every float64 K of the dense paths is built on the FP64 tensor cores
    for path in ("table1", "table1_batched", "size", "size_wide"):
        rbf = routes[path]["rbf_kernel_matrix"]
        require(rbf["fma"] == 0
                and rbf["tensor"] == counts[path]["rbf_kernel_matrix"] > 0,
                f"{path}: the RBF kernel's routes {rbf}")
    # two prefills, one launch per layer (also checked per call)
    require(counts["serve_lm"]["flash_attention"] == 2 * 36,
            "flash_attention was not launched once per prefill layer on the "
            "serving path")
    for path, want in (("serve_gemma3", 2 * 34), ("serve_yi", 60),
                       ("serve_deepseek", DEEPSEEK_LAYERS),
                       ("serve_jamba", 2)):
        require(counts[path]["flash_attention"] == want,
                f"flash_attention was launched {counts[path]['flash_attention']}"
                f" times on {path}, want one per prefill layer ({want})")

    # shrinking: compact groups of more than one lane on the per-lane
    # kernels, dense and streaming, at Table 1's sizes; SVC's fit and
    # scoring on the RBF kernel and the dense chunk
    for name in ("smo_chunk_sources", "smo_stream_chunk_sources"):
        require(counts["shrink"][name] > 0,
                f"{name} was not launched on the shrink path")
    for name in ("rbf_kernel_matrix", "smo_chunk", "sir_greedy"):
        require(counts["svc"][name] > 0,
                f"{name} was not launched on the svc path")
    csrc = "src/repro_torch/kernels/csrc/"
    # kernel -> (source, the TPU kernel or loop it replaces, its path)
    sources = {"rbf_kernel_matrix": (csrc + "rbf.cu",
                                     "src/repro/kernels/rbf.py:54",
                                     "size"),
               "smo_f_update": (csrc + "smo_update.cu",
                                "src/repro/kernels/smo_update.py:24",
                                "table1"),
               "smo_chunk": (csrc + "smo_chunk.cu",
                             "src/repro/svm/engine.py:566", "table1"),
               "smo_chunk_multi_block": (csrc + "smo_chunk.cu",
                                         "src/repro/svm/engine.py:566",
                                         "size"),
               "smo_chunk_cluster": (csrc + "smo_chunk.cu",
                                     "src/repro/svm/engine.py:566",
                                     "size_wide"),
               "smo_chunk_one_block_global": (csrc + "smo_chunk.cu",
                                              "src/repro/svm/engine.py:566",
                                              "size_wide"),
               "fused_smo_step": (csrc + "smo_step.cu",
                                  "src/repro/kernels/smo_step.py:67",
                                  "table1_batched"),
               "smo_select": (csrc + "smo_step.cu",
                              "src/repro/svm/engine.py:519",
                              "table1_batched"),
               "smo_stream_chunk": (csrc + ("smo_stream.cu" if info[
                   "smo_stream_chunk"]["route"] == "cluster"
                   else "smo_step.cu"), "src/repro/svm/engine.py:566",
                                    "size_matrix_free"),
               # the persistent streaming chunk, the cluster route's
               # bitwise witness (off the main path)
               "smo_stream_chunk_persistent": (csrc + "smo_step.cu",
                                               "src/repro/svm/engine.py:566",
                                               "size_matrix_free"),
               "smo_chunk_sources": (csrc + "smo_chunk.cu",
                                     "src/repro/svm/engine.py:647",
                                     "shrink"),
               "smo_stream_chunk_sources": (csrc + "smo_step.cu",
                                            "src/repro/svm/engine.py:647",
                                            "shrink"),
               "flash_attention": (csrc + "flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:71",
                                   "serve_lm"),
               "water_fill": (csrc + "seeding.cu",
                              "src/repro/core/seeding.py:61", "table1"),
               "sir_greedy": (csrc + "seeding.cu",
                              "src/repro/core/seeding.py:225", "table1"),
               "ato_system_lanes": (csrc + "seeding.cu",
                                    "src/repro/core/seeding.py:361",
                                    "table1"),
               "ato_apply_lanes": (csrc + "seeding.cu",
                                   "src/repro/core/seeding.py:361",
                                   "table1"),
               "avg_spill": (csrc + "seeding.cu",
                             "src/repro/core/seeding.py:548", "loo"),
               "top_spill": (csrc + "seeding.cu",
                             "src/repro/core/seeding.py:573", "loo"),
               "selective_scan": (csrc + "selective_scan.cu",
                                  "src/repro/models/ssm.py:103",
                                  "serve_jamba"),
               "mlstm_parallel": (csrc + "mlstm.cu",
                                  "src/repro/models/xlstm.py:53",
                                  "serve_xlstm"),
               "slstm_scan": (csrc + "slstm.cu",
                              "src/repro/models/xlstm.py:138",
                              "serve_xlstm")}
    # the dense chunk's four routes are four kernels, each counted on its
    # own path (the global-state one is on none now: its count there is
    # 0); flash_attention's routes are listed beside its launches
    launches = {name: counts[path].get(name) for name, (_, _, path)
                in sources.items()}
    # the RBF kernel's time is K(X, X) at n = 32,560: the builds of that
    # size are size's and size_wide's (Table 1's are at n <= 1,000)
    launches["rbf_kernel_matrix"] = sum(
        counts[path]["rbf_kernel_matrix"] for path in ("size", "size_wide"))
    launches["smo_chunk"] = routes["table1"]["smo_chunk"]["one_block"]
    launches["smo_chunk_multi_block"] = (
        routes["size"]["smo_chunk"]["multi_block"])
    launches["smo_chunk_cluster"] = routes["size_wide"]["smo_chunk"]["cluster"]
    launches["smo_chunk_one_block_global"] = (
        routes["size_wide"]["smo_chunk"]["one_block_global"])
    launches["smo_stream_chunk_persistent"] = (
        routes["size_matrix_free"]["smo_stream_chunk"]["persistent"])
    # the per-lane chunks run on every shrinking path
    for name in ("smo_chunk_sources", "smo_stream_chunk_sources"):
        launches[name] = sum(counts[p][name]
                             for p in ("shrink", "shrink_size", "svc"))
    kernels = []
    for name, (src, replaces, path) in sources.items():
        k = info[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k.get("library_ms")})
        if name in ("flash_attention", "smo_stream_chunk"):
            kernels[-1]["routes"] = routes[path][name]
        if name.startswith("smo_stream_chunk") and "_sources" not in name:
            kernels[-1].update({key: k[key] for key in ("route", "cluster")
                                if key in k})
        if name == "flash_attention":
            kernels[-1]["mma_route"] = k["mma_route"]
            kernels[-1]["launches_by_path"] = {
                p: counts[p][name] for p in ("serve_lm", "serve_gemma3",
                                             "serve_yi", "serve_deepseek",
                                             "serve_jamba")}
            kernels[-1]["routes_by_path"] = {
                p: routes[p][name] for p in ("serve_gemma3", "serve_yi",
                                             "serve_deepseek",
                                             "serve_jamba")}
            kernels[-1]["gemma3"] = gemma3_flash
            # MLA's pair, (192, 128), on serve_deepseek
            kernels[-1]["mla"] = {
                "dims": [FLASH_MLA[4], FLASH_MLA[5]],
                "launches": counts["serve_deepseek"][name],
                **{key: mla_flash[key] for key in (
                    "shape", "route", "ms", "plain_ms", "bound_ms",
                    "bound_by", "flop_bound_ms", "byte_bound_ms",
                    "exp_bound_ms", "library_ms", "sdpa_backends",
                    "row_rel_err", "max_abs_err")}}
        if name == "smo_select":
            kernels[-1].update({key: k[key] for key in (
                "iteration_ms", "ms_cold", "ms_wrapper", "bound_ms_cold")})
        # the scan: its shape, the other dtype's time, its decode step
        if name == "selective_scan":
            kernels[-1].update({key: k[key] for key in (
                "ms_float32", "plain_steps", "exp_bound_ms",
                "byte_bound_ms", "decode_shape", "decode_ms",
                "decode_graph_ms", "decode_bound_ms", "decode_bound_by")})
        # xLSTM's kernels: their routes on the main path, the bounds beside
        # them, sLSTM's time a step and its decode step
        if name == "mlstm_parallel":
            kernels[-1].update({key: k[key] for key in (
                "ms_float32", "tflops", "mma_ms", "mma_tflops",
                "wgmma_ptxas", "plain_rows", "flop_bound_ms",
                "byte_bound_ms", "exp_bound_ms")},
                routes=routes[path][name])
        if name == "slstm_scan":
            kernels[-1].update({key: k[key] for key in (
                "us_per_step", "block_ms", "cluster_bitwise_block",
                "chain_floor_ms", "chain_floor_us_per_step", "cluster_ptxas",
                "plain_steps", "flop_bound_ms",
                "byte_bound_ms", "decode_shape", "decode_ms",
                "decode_graph_ms", "decode_bound_ms", "decode_bound_by")},
                routes=routes[path][name])
        if name == "rbf_kernel_matrix":
            kernels[-1].update(
                {key: k[key] for key in ("ms_distinct", "bound_ms_distinct",
                                         "fma_ms")},
                launches_table1=counts["table1"][name],
                routes={p: routes[p][name] for p in ("size", "size_wide")})
        # beside the main path's shape: the paper's cardinality, the
        # floors that X held in the L2 leaves, and the dense chunk's rows
        # and the global-state kernel's time there
        kernels[-1].update({key: v for key, v in k.items()
                            if key.endswith(f"_{SIZE_N - 1}x10")
                            or key in ("shape", "flop_floor_ms",
                                       "x_per_iter_hbm_ms")})
        # the spills: their routes and times beside the fused route's (the
        # split kernel, the parent's device work, the whole seeders), and
        # TOP's walks on LOO
        if name in ("avg_spill", "top_spill"):
            kernels[-1].update({key: v for key, v in k.items()
                                if key not in kernels[-1]},
                               routes=routes[path][name])
        if name == "top_spill":
            kernels[-1]["walks_loo"] = top_walks["loo"]
        if name in ("water_fill", "sir_greedy", "ato_system_lanes",
                    "ato_apply_lanes"):
            kernels[-1].update({key: k[key] for key in k if key in (
                "n", "m_cap", "nf", "lanes", "ms_32560", "ms_32560_S",
                "steps_checked", "calls_checked", "levels_ms",
                "carried_steps_checked", "fused_steps_checked")
                or key.startswith(("ms_", "bound_ms_", "gather_ms_",
                                   "block_ms_", "list_ms_", "segment_ms_"))})
        # the seeding kernels that run on every seeded path: their
        # launches on each
        if name in ("water_fill", "sir_greedy"):
            kernels[-1]["launches_by_path"] = {
                p: counts[p][name] for p in ("table1", "size", "grid_size",
                                             "study_seeds", "loo",
                                             "service")}
        # the study service's served part: its launches of each kernel
        if name in counts["service"]:
            kernels[-1]["launches_service"] = counts["service"][name]
        if name.startswith("smo_chunk") and "_sources" not in name:
            kernels[-1]["routes_service"] = routes["service"]["smo_chunk"]
        if name == "sir_greedy":
            kernels[-1]["events_by_path"] = sir_events
        # ATO's ramp kernels and its alpha update also run the batched
        # ramp over the ATO C row (reference: _ato_seed_batch_jit): that
        # path's launches and the kernels' readings on its 3-lane calls
        if name in ("ato_system_lanes", "ato_apply_lanes", "smo_f_update"):
            kernels[-1].update(
                also_replaces="src/repro/core/seeding.py:435",
                launches_study_seeds=counts["study_seeds"][name],
                launches_loo=counts["loo"][name],
                row=info[name + "_row"])
        if name in ("ato_system_lanes", "ato_apply_lanes"):
            kernels[-1]["routes"] = {p: routes[p][name] for p in (
                "table1", "study_seeds", "loo")}
        if name in ("smo_chunk_sources", "smo_stream_chunk_sources"):
            kernels[-1].update(
                lanes=k["lanes"], cap=k["cap"], call_route=k["route"],
                routes={p: routes[p][name]
                        for p in ("shrink", "shrink_size", "svc")},
                **({"at_32560": k["at_32560"]} if "at_32560" in k else {}))
        elif name.startswith("smo_chunk"):
            kernels[-1].update(n=k["n"], lanes=k.get("lanes", 1),
                               us_per_iter_one_block_global=k[
                                   "us_per_iter_one_block_global"])
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "build_s": build_s, "card": card})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
