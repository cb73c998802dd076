"""Where the WSS-1 selection kernel's time goes, on one NVIDIA GPU.

    python3 chip_select_split.py [--src DIR]

No profiler runs on the card's machine, so this script builds copies of
``csrc/smo_step.cu`` from the package under DIR (the directory that holds
``repro_torch``; default this checkout's ``src``), in a temporary
directory, never in the repository, one ``nvcc`` each, started together:

* ``timed``: the source unchanged but for one more C entry that launches
  the selection with either clip (``clip_all`` 1 on a chunk's first
  iteration, 0 on the others, as the pair route calls it);
* ``phases``: the same with ``clock64`` reads by each block's thread 0
  around the selection's phases (the scan of the rows, the reduction to
  the pair, the pair rows' copy, the serial chains, ``exp`` and the
  scalar step, the clip pass), into a device array read back after one
  launch.

Two shapes, the main path's and the paper's cardinality: adult's first
1,000 rows in 20 folds (the 20-fold matrix-free row's pair route) and its
first 32,560 rows in 10 folds. At each, three states: mid-solve (the
lanes after 100 pair-route iterations, ``clip_all`` 0, as the route calls
the kernel), and the cold first step (``clip_all`` 1, and 0 beside it).
For each it prints one JSON line: ptxas's registers and spills, the
kernel's time per launch over a CUDA graph of 50 launches, the pair
route's iteration (selection and ``fused_smo_step``) over a graph, and
each phase's mean cycles over the lanes of 20 launches, with the card's
name, power limit and clocks. The copies find their edits by the text of
the source, for the selection's design that the source holds (the
earlier one, a block-wide reduction of two barriers with the pair rows
through global memory, or the single-barrier one): an edit to those
lines must be made here too (a build that cannot find
its text raises). The mid-solve states come from the package's own
``smo_stream_chunk``, so parent and change start from the same bits.
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
_HEAD = ('#include "smo_common.cuh"\n',
         "__device__ long long g_split[1024 * 8];\n"
         "#define SPLIT_MARK(p) \\\n"
         "  if (threadIdx.x == 0) g_split[blockIdx.x * 8 + (p)] = clock64();\n"
         '#include "smo_common.cuh"\n')
_READ = ('\nextern "C" int split_read(long long* h, int count) {\n'
         "  return (int)cudaMemcpyFromSymbol(h, g_split,\n"
         "                                   count * sizeof(long long));\n}\n")
#: design -> (the text that tells it, the C entry appended to both builds,
#: the phases' names (mark p - 1 to mark p), the phase marks' edits of
#: (file, text, replacement))
DESIGNS = {
    "two_barriers": (
        "  __shared__ Scratch s;\n  const int lane = blockIdx.x;",
        'extern "C" int split_select_f64(\n'
        "    const double* X, const double* xn, const double* sn,\n"
        "    const double* y, const unsigned char* masks, const double* Cs,\n"
        "    double tol, const long long* it_caps, double gamma,\n"
        "    double* alphas, const double* fs, long long* n_iter,\n"
        "    unsigned char* done, double* xij, double* delta, int n, int d,\n"
        "    int b, int clip_all, cudaStream_t stream) {\n"
        "  (void)sn;\n"
        "  launch_select(X, xn, y, masks, Cs, tol, it_caps, gamma, alphas,"
        " fs,\n                n_iter, done, xij, delta, n, d, b, clip_all,"
        " stream);\n"
        "  return (int)cudaGetLastError();\n}\n",
        ("scan", "reduce", "pair_copy", "norm_chain", "cross_chain",
         "exp_step", "clip"),
        (("smo_step.cu",
          "  if (done_flags[lane]) return;  // uniform over the block\n",
          "  if (done_flags[lane]) return;  // uniform over the block\n"
          "  SPLIT_MARK(0);\n"),
         ("smo_common.cuh",
          "  block_reduce(s, vu, iu, vl, il, fl, true);\n  i = s.r_i0;",
          "  SPLIT_MARK(1);\n"
          "  block_reduce(s, vu, iu, vl, il, fl, true);\n  i = s.r_i0;"),
         ("smo_step.cu",
          "  double* pair = xij + (size_t)lane * 2 * d;  // x_i then x_j\n",
          "  SPLIT_MARK(2);\n"
          "  double* pair = xij + (size_t)lane * 2 * d;  // x_i then x_j\n"),
         ("smo_step.cu",
          "    const double sn = seq_norm(pair, d);\n",
          "    SPLIT_MARK(3);\n    const double sn = seq_norm(pair, d);\n"
          "    SPLIT_MARK(4);\n"),
         ("smo_step.cu",
          "    double d2 = xn[j] + sn - 2.0 * cross;\n",
          "    SPLIT_MARK(5);\n    double d2 = xn[j] + sn - 2.0 * cross;\n"),
         ("smo_step.cu",
          "    n_iter[lane] = it + 1;\n  }\n  if (clip_all) {",
          "    n_iter[lane] = it + 1;\n    SPLIT_MARK(6);\n  }\n"
          "  if (clip_all) {"),
         ("smo_step.cu",
          "    for (int k = tid; k < n; k += nt) alpha[k] = clip(alpha[k], "
          "C);\n  }\n}",
          "    for (int k = tid; k < n; k += nt) alpha[k] = clip(alpha[k], "
          "C);\n  }\n  SPLIT_MARK(7);\n}"))),
    "one_barrier": (
        "struct SelSlot {",
        'extern "C" int split_select_f64(\n'
        "    const double* X, const double* xn, const double* sn,\n"
        "    const double* y, const unsigned char* masks, const double* Cs,\n"
        "    double tol, const long long* it_caps, double gamma,\n"
        "    double* alphas, const double* fs, long long* n_iter,\n"
        "    unsigned char* done, double* xij, double* delta, int n, int d,\n"
        "    int b, int clip_all, cudaStream_t stream) {\n"
        "  return smo_select_f64(X, xn, sn, y, masks, Cs, tol, it_caps, "
        "gamma,\n                        alphas, fs, n_iter, done, xij, "
        "delta, n, d, b,\n                        clip_all, stream);\n}\n",
        ("scan", "reduce", "pair_copy", "cross_chain", "exp_step",
         "clip"),
        (("smo_step.cu",
          "  if (done_flags[lane]) return;  // uniform over the block\n",
          "  if (done_flags[lane]) return;  // uniform over the block\n"
          "  SPLIT_MARK(0);\n"),
         ("smo_step.cu",
          "  // the warp's winners, to its slots\n",
          "  SPLIT_MARK(1);\n  // the warp's winners, to its slots\n"),
         ("smo_step.cu",
          "  if (warp == 0) {  // the pair rows, then the chain\n",
          "  SPLIT_MARK(2);\n"
          "  if (warp == 0) {  // the pair rows, then the chain\n"),
         ("smo_step.cu",
          "      double cross = 0.0;\n",
          "      SPLIT_MARK(3);\n      double cross = 0.0;\n"),
         ("smo_step.cu",
          "      double d2 = xnj + sni - 2.0 * cross;\n",
          "      SPLIT_MARK(4);\n      double d2 = xnj + sni - 2.0 * cross;\n"),
         ("smo_step.cu",
          "      n_iter[lane] = it + 1;\n",
          "      n_iter[lane] = it + 1;\n      SPLIT_MARK(5);\n"),
         ("smo_step.cu",
          "  // end of the selection\n",
          "  SPLIT_MARK(6);\n  // end of the selection\n"))),
}
SHAPES = ((1000, 20), (32560, 10))
REPS, SPLIT_REPS, WARM_ITERS = 50, 20, 100
_P, _I, _D, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                   ctypes.c_longlong)


def design(source: str) -> str:
    for name, (tell, *_) in DESIGNS.items():
        if tell in source:
            return name
    raise RuntimeError("chip_select_split: no known selection design in "
                       "smo_step.cu")


def build_all(tmp: str, src_dir: str):
    """The two builds of the package under ``src_dir``, one nvcc each,
    started together: ({name: (lib, ptxas)}, design)."""
    from repro_torch.kernels import _build
    csrc = os.path.join(src_dir, "repro_torch", "kernels", "csrc")
    texts = {}
    for f in ("smo_step.cu", "smo_common.cuh"):
        with open(os.path.join(csrc, f)) as fh:
            texts[f] = fh.read()
    which = design(texts["smo_step.cu"])
    _, entry, _, marks = DESIGNS[which]
    procs = {}
    for name in ("timed", "phases"):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        src = dict(texts)
        edits = [("smo_step.cu", *_HEAD)]
        if name == "phases":
            edits += list(marks)
        for f, old, new in edits:
            if old not in src[f]:
                raise RuntimeError(f"{name}: text not found in {f}: {old!r}")
            src[f] = src[f].replace(old, new)
        src["smo_step.cu"] += "\n" + entry + _READ
        for f, text in src.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        lib = os.path.join(d, "libsmo_step.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.flags("smo_step"), "-o", lib,
             os.path.join(d, "smo_step.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on build {name}:\n{log}")
        out[name] = (lib, select_ptxas(log))
    return out, which


def select_ptxas(log: str) -> list:
    """ptxas's register and spill lines of the selection kernel."""
    lines, inside = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            inside = "select" in ln
        elif inside and ("registers" in ln or "spill" in ln):
            lines.append(ln.split(":", 1)[-1].strip())
    return lines


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


def problem(n: int, k: int):
    """adult's first n rows in k folds on the card: the source, the lane
    tensors, the cold state and the state after WARM_ITERS pair-route
    iterations (the package's own ``smo_stream_chunk``)."""
    from repro_torch.core.cv import _fold_masks
    from repro_torch.data.svm_suite import kfold_chunks, make_dataset
    from repro_torch.kernels import ops
    try:
        from repro_torch.kernels.smo_chunk import seq_norms
    except ImportError:   # a package from before the norm table
        seq_norms = None
    dev = torch.device("cuda")
    ds = make_dataset("adult", n_override=n if n == 1000 else n + 1)
    chunks = kfold_chunks(ds.n, k)
    m = chunks.size
    X = torch.as_tensor(ds.X[:m], device=dev).contiguous()
    y = torch.as_tensor(ds.y[:m], dtype=torch.float64, device=dev)
    sq = torch.sum(X * X, -1)
    # the earlier design reads no table: its C entry takes one and ignores it
    sn = seq_norms(X) if seq_norms else torch.zeros_like(sq)
    table = {"X_norms": sn} if seq_norms else {}
    masks = torch.as_tensor(_fold_masks(chunks), device=dev).contiguous()
    Cs = torch.full((k,), ds.C, dtype=torch.float64, device=dev)
    caps = torch.full((k,), 10 ** 9, dtype=torch.int64, device=dev)
    cold = (torch.zeros((k, m), dtype=torch.float64, device=dev),
            -y.repeat(k, 1), torch.zeros(k, dtype=torch.int64, device=dev),
            torch.zeros(k, dtype=torch.bool, device=dev))
    mid = ops.smo_stream_chunk(X, sq, ds.gamma, y, masks, Cs, 1e-3, caps,
                               WARM_ITERS, *cold, _route="pair", **table)
    torch.cuda.synchronize()
    return dict(X=X, y=y, sq=sq, sn=sn, masks=masks, Cs=Cs, caps=caps,
                gamma=ds.gamma, n=m, d=X.shape[1], b=k,
                states={"mid": tuple(t.clone() for t in mid),
                        "cold": cold},
                mid_iterations=int(mid[2].max()),
                mid_live=int((~mid[3]).sum()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_select_split: no CUDA device", file=sys.stderr)
        return 1
    src_dir = os.path.abspath(sys.argv[sys.argv.index("--src") + 1]) \
        if "--src" in sys.argv else os.path.join(ROOT, "src")
    sys.path.insert(0, src_dir)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    mhz = float(card.split(",")[-1].split()[0])
    with tempfile.TemporaryDirectory() as tmp:
        builds, which = build_all(tmp, src_dir)
        libs = {}
        for name, (lib, _) in builds.items():
            so = ctypes.CDLL(lib)
            sel = so.split_select_f64
            sel.argtypes = [_P, _P, _P, _P, _P, _P, _D, _P, _D, _P, _P, _P,
                            _P, _P, _P, _I, _I, _I, _I, _P]
            fused = so.fused_smo_step_f64
            fused.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _P]
            read = so.split_read
            read.argtypes = [_P, _I]
            for fn in (sel, fused, read):
                fn.restype = ctypes.c_int
            libs[name] = (sel, fused, read)
        for n, k in SHAPES:
            pb = problem(n, k)
            dev = pb["X"].device
            xij = torch.zeros((k, 2, pb["d"]), dtype=torch.float64,
                              device=dev)
            delta = torch.zeros(k, dtype=torch.float64, device=dev)
            rec = {"design": which, "src": src_dir, "card": card,
                   "shape": [pb["n"], pb["d"], k],
                   "mid_iterations": pb["mid_iterations"],
                   "mid_live_lanes": pb["mid_live"],
                   "ptxas": {b: p for b, (_, p) in builds.items()}}
            for state, clip in (("mid", 0), ("cold", 1), ("cold", 0)):
                tag = f"{state}_clip{clip}"
                for name, (sel, fused, read) in libs.items():
                    st = tuple(t.clone() for t in pb["states"][state])

                    def select():
                        err = sel(pb["X"].data_ptr(), pb["sq"].data_ptr(),
                                  pb["sn"].data_ptr(), pb["y"].data_ptr(),
                                  pb["masks"].data_ptr(),
                                  pb["Cs"].data_ptr(), 1e-3,
                                  pb["caps"].data_ptr(), pb["gamma"],
                                  st[0].data_ptr(), st[1].data_ptr(),
                                  st[2].data_ptr(), st[3].data_ptr(),
                                  xij.data_ptr(), delta.data_ptr(), pb["n"],
                                  pb["d"], k, clip,
                                  torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"select: CUDA error {err}")

                    def iteration():
                        select()
                        err = fused(st[1].data_ptr(), pb["X"].data_ptr(),
                                    pb["sq"].data_ptr(), xij.data_ptr(),
                                    delta.data_ptr(), st[3].data_ptr(),
                                    pb["n"], pb["d"], k, pb["gamma"],
                                    torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"fused: CUDA error {err}")
                    if name == "timed":
                        rec[f"select_ms_{tag}"] = graph_ms(select, REPS)
                        st = tuple(t.clone() for t in pb["states"][state])
                        if state == "mid":
                            rec[f"iteration_ms_{tag}"] = graph_ms(iteration,
                                                                  REPS)
                        continue
                    marks = (ctypes.c_longlong * (k * 8))()
                    sums = [0.0] * 8
                    count = 0
                    for _ in range(SPLIT_REPS):
                        st = tuple(t.clone() for t in pb["states"][state])
                        torch.cuda.synchronize()
                        ctypes.memset(marks, 0, ctypes.sizeof(marks))
                        select()
                        torch.cuda.synchronize()
                        if read(ctypes.addressof(marks), k * 8):
                            raise RuntimeError("split_read failed")
                        for lane in range(k):
                            if bool(st[3][lane]) and int(st[2][lane]) == int(
                                    pb["states"][state][2][lane]):
                                continue   # arrived done: no marks
                            t = marks[lane * 8:lane * 8 + 8]
                            for p in range(1, 8):
                                sums[p] += t[p] - t[0] if t[p] else 0.0
                            count += 1
                    names = DESIGNS[which][2]
                    total = {p: sums[p + 1] / max(count, 1)
                             for p in range(len(names))}
                    phases, prev = {}, 0.0
                    for p, pname in enumerate(names):
                        phases[pname] = total[p] - prev
                        prev = total[p]
                    rec[f"phase_cycles_{tag}"] = phases
                    rec[f"phase_total_cycles_{tag}"] = prev
                    rec[f"phase_total_us_{tag}"] = prev / mhz
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
