"""Where the tensor-core RBF kernel's time goes, on one NVIDIA GPU.

    python3 chip_rbf_variants.py

No profiler runs on the card's machine, so this script builds
``csrc/rbf.cu`` as it is beside copies with one change each (made in a
temporary directory, never in the repository; one ``nvcc`` each, all
started together) and times the tensor route at the main path's shape:
adult's first 32,560 rows (d = 123, rows padded to 124 as the wrapper pads
them), K(X, X) and K(X, a copy of X), tile 128.

* ``as_is``: the source unchanged;
* ``no_exp``: the epilogue stores d2 where K has exp(-gamma d2);
* ``no_store``: the epilogue computes K and stores none of it;
* ``phases``: the source unchanged but for ``clock64`` reads around the
  phases of the tile loop, summed over each block's warps: the wait for a
  slab and the block's barrier, the next slab's copies (``issue``), the
  products, the epilogue up to the stores of the mirror tile, and the rest
  (the mirror tile's stores).

For each it prints one JSON line: ptxas's registers and spills, the time
of each shape (CUDA events over 5 launches after one) and, for ``phases``,
each phase's share of the warps' time. Only ``as_is`` is checked: bitwise
equal to the FMA kernel, or the script exits non-zero. The copies find
their edits by the text of the source, so an edit to those lines of
``rbf.cu`` must be made here too (a build that cannot find its text
raises).
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
_STORE = ("                                           bool vec, bool has1) "
          "{\n")
_PHASES = ("wait", "issue", "products", "epilogue", "mirror")
#: variant -> ((text of rbf.cu, its replacement), ...)
VARIANTS = {
    "as_is": (),
    "no_exp": (
        ("rbf_value<double>(\n                xr, nz[fn * 8 + e], "
         "acc[fm][fn][h][e], neg_gamma)",
         "(xr + nz[fn * 8 + e] - 2.0 * acc[fm][fn][h][e])"),),
    "no_store": ((_STORE, _STORE + "  if (v0 != -1.0) return;\n"),),
    "phases": (
        ("namespace {\n\nconstexpr int kSlab",
         "__device__ unsigned long long g_phase[8];\n"
         "namespace {\n\nconstexpr int kSlab"),
        ("  const int nslabs = (d + kSlab - 1) / kSlab;\n",
         "  const int nslabs = (d + kSlab - 1) / kSlab;\n"
         "  unsigned long long ph[6] = {clock64()}, tc = 0;\n"),
        ("    cp_async_wait<kStages - 2>();\n    __syncthreads();  // this "
         "slab landed; the last slab's stage is free\n    issue();\n",
         "    tc = clock64();\n    cp_async_wait<kStages - 2>();\n"
         "    __syncthreads();\n    ph[1] += clock64() - tc; tc = clock64();"
         "\n    issue();\n    ph[2] += clock64() - tc; tc = clock64();\n"),
        ("    if (++ks < nslabs) continue;",
         "    ph[3] += clock64() - tc; tc = clock64();\n"
         "    if (++ks < nslabs) continue;"),
        ("    if (!sym || i == j) continue;  // uniform over the block",
         "    ph[4] += clock64() - tc; tc = clock64();\n"
         "    if (!sym || i == j) continue;"),
        ("  cp_async_wait_all();\n",
         "  cp_async_wait_all();\n  if (lane == 0) {\n"
         "    atomicAdd(&g_phase[0], clock64() - ph[0]);\n"
         "    for (int q = 1; q < 5; ++q) atomicAdd(&g_phase[q], ph[q]);\n"
         "  }\n"),
    ),
}
_READ = ('extern "C" void rbf_phases(unsigned long long* h) {\n'
         "  cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase));\n"
         "  unsigned long long z[8] = {};\n"
         "  cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n}\n")
N, D, TILE, REPS = 32560, 123, 128, 5
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build_all(tmp: str) -> dict:
    """One nvcc per variant, all started together; {name: (lib, ptxas)}."""
    from repro_torch.kernels import _build
    with open(os.path.join(CSRC, "rbf.cu")) as fh:
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
        if name == "phases":
            src += _READ
        cu = os.path.join(d, "rbf.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        lib = os.path.join(d, "librbf.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.flags("rbf"), "-o", lib, cu],
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_rbf_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.data.svm_suite import make_dataset
    from repro_torch.kernels import ops
    from repro_torch.kernels.smo_chunk import pad_rows
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    ds = make_dataset("adult", n_override=N + 1)
    X = torch.as_tensor(ds.X[:N], device=dev)
    Xp = pad_rows(X)
    shapes = {"z_is_x": (Xp, 1), "z_copy": (Xp.clone(), 0)}
    xn = torch.sum(X * X, -1)
    out = torch.empty((N, N), dtype=torch.float64, device=dev)
    want = ops.rbf_kernel_matrix(X, X, ds.gamma, _route="fma")
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name, (lib, ptxas) in build_all(tmp).items():
            so = ctypes.CDLL(lib)
            fn = so.rbf_kernel_matrix_tc_f64
            fn.argtypes = [_P, _P, _LL, _LL, _P, _P, _P, _I, _I, _I,
                           ctypes.c_double, _I, _I, _P]
            fn.restype = ctypes.c_int
            rec = {"variant": name, "ptxas": ptxas, "card": card}
            for shape, (Z, sym) in shapes.items():
                def launch():
                    err = fn(Xp.data_ptr(), Z.data_ptr(), Xp.stride(0),
                             Z.stride(0), xn.data_ptr(), xn.data_ptr(),
                             out.data_ptr(), N, N, D, ds.gamma, TILE, sym,
                             torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                launch()
                torch.cuda.synchronize()
                if name == "as_is":
                    same = bool(torch.equal(out, want))
                    rec[f"bitwise_{shape}"] = same
                    ok &= same
                phases = (ctypes.c_ulonglong * 8)()
                if name == "phases":
                    so.rbf_phases(ctypes.cast(phases, _P))   # reset
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    launch()
                end.record()
                end.synchronize()
                rec[f"ms_{shape}"] = start.elapsed_time(end) / REPS
                if name == "phases":
                    so.rbf_phases(ctypes.cast(phases, _P))
                    total = phases[0]
                    shares = {p: phases[q + 1] / total
                              for q, p in enumerate(_PHASES[:4])}
                    shares["mirror"] = 1.0 - sum(shares.values())
                    rec[f"phase_share_{shape}"] = shares
            print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
