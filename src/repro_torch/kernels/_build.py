"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` becomes its own shared library, compiled by ``nvcc``
for ``sm_90a`` at first use into ``_build/`` beside this file (a directory
that ``.gitignore`` lists), from the sources in the repository only. The
library's file name carries a digest of its sources and flags, so an edited
source is rebuilt and a stale library is never loaded. ``build_all``
starts one ``nvcc`` per source, all at once.

A variant (``VARIANTS``) is another build of one source with a macro
set: ``smo_step_fma`` keeps ``csrc/smo_step.cu``'s float64 dot products on
the FMA pipes, the witness that ``chip_smoke.py`` holds bitwise equal to
the FP64 tensor-core build the port runs, and ``smo_stream_fma`` does the
same for ``csrc/smo_stream.cu`` (held equal by the card tests); ``water_fill_seq`` builds
``csrc/seeding.cu`` with one bisection level a round, the sequential loop
that the multi-level ``water_fill`` must equal bit for bit;
``slstm_chain`` keeps only the serial chain of ``csrc/slstm.cu``'s
cluster route (no gate loads, no step math), whose time is that design's
floor a step; ``slstm_cluster32`` builds that route at 32 blocks a
cluster, which no card places, so that the card tests see its launch
refused.

Flags are per source (``flags``). The SVM sources keep ``-fmad=false``,
which keeps ``nvcc`` from contracting any expression into an FMA behind
the code's back: they spell out the one FMA the reference rounds as one
(the f-update) and round everything else op by op, as the plain PyTorch
versions do, which their bitwise parity needs. ``slstm.cu`` keeps it too:
it writes the reference's two FMAs as ``fmaf`` and its dot product as an
``fmaf`` chain, and no other contraction. ``flash_attention.cu``,
``selective_scan.cu`` and ``mlstm.cu`` are held to tolerances, not bits
(their sums run in other orders than the reference's), and are built
without it. Nothing links
``libcuda``: the sources that build tensor maps reach
``cuTensorMapEncodeTiled`` through the CUDA runtime's entry-point query
(``csrc/hopper.cuh``). A library's digest covers every ``csrc/*.cuh``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("rbf", "smo_update", "smo_chunk", "smo_step", "smo_stream",
           "seeding", "flash_attention", "selective_scan", "mlstm", "slstm")
#: the sources whose results are held bitwise to the plain versions
BITWISE_SOURCES = ("rbf", "smo_update", "smo_chunk", "smo_step",
                   "smo_stream", "seeding")
#: the sources built with -fmad=false: the bitwise ones, and the sLSTM
#: recurrence, which spells out the two FMAs the reference contracts and
#: rounds everything else op by op, as the plain version does
NO_FMAD_SOURCES = BITWISE_SOURCES + ("slstm",)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


#: variant -> (its source, the flags it adds)
VARIANTS = {"smo_step_fma": ("smo_step", ("-DSMO_STEP_TENSOR_F64=0",)),
            "smo_stream_fma": ("smo_stream", ("-DSMO_STEP_TENSOR_F64=0",)),
            "water_fill_seq": ("seeding", ("-DWATER_FILL_LEVELS=1",)),
            "slstm_chain": ("slstm", ("-DSLSTM_CHAIN_ONLY=1",)),
            "slstm_cluster32": ("slstm", ("-DSLSTM_CLUSTER_BLOCKS=32",))}


def source(name: str) -> Path:
    """The ``.cu`` file that a source or variant builds from."""
    return CSRC / f"{VARIANTS.get(name, (name,))[0]}.cu"


def flags(name: str) -> tuple[str, ...]:
    """``nvcc`` flags of a source or variant."""
    src, extra = VARIANTS.get(name, (name, ()))
    return FLAGS + (("-fmad=false",) if src in NO_FMAD_SOURCES else ()) \
        + extra

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    """Where a source's or variant's library lives, keyed by the digest of
    its sources and flags."""
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [source(name)]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def ptxas_log(name: str) -> str:
    """``nvcc -Xptxas -v`` output (registers, spills) of the last build."""
    p = lib_path(name).with_suffix(".ptxas.txt")
    return p.read_text() if p.exists() else ""


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every missing library in parallel; returns {name: seconds}
    for those built. Raises with the compiler's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not lib_path(n).exists()]
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *flags(name), "-o", tmp, str(source(name))]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    secs, errors = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {name} "
                          f"(csrc/{source(name).name}):\n{out}")
            continue
        final = lib_path(name)
        final.with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, final)   # atomic: concurrent builders never see half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of a source or variant, built first if needed
    (every source at once)."""
    lib = _LIBS.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build_all(SOURCES if name in SOURCES else (name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, *argtypes):
    """The C function ``symbol`` of a source or variant, typed: pointers and
    the stream as ``c_void_p`` (an untyped int would be cut to 32 bits).
    Looked up and typed once, then served from a cache."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (its ``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a C pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream
