"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` becomes its own shared library, compiled by ``nvcc``
for ``sm_90a`` at first use into ``_build/`` beside this file (a directory
that ``.gitignore`` lists), from the sources in the repository only. The
library's file name carries a digest of its sources and flags, so an edited
source is rebuilt and a stale library is never loaded. ``build_all``
starts one ``nvcc`` per source, all at once.

``-fmad=false`` keeps ``nvcc`` from contracting any expression into an FMA
behind the code's back: the kernels spell out the one FMA the reference
rounds as one (the f-update) and round everything else op by op, as the
plain PyTorch versions do.
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
SOURCES = ("rbf", "smo_update", "smo_chunk")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    """Where ``csrc/<name>.cu``'s library lives, keyed by source digest."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
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
        cmd = [nvcc(), *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    secs, errors = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on csrc/{name}.cu:\n{out}")
            continue
        final = lib_path(name)
        final.with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, final)   # atomic: concurrent builders never see half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build_all(SOURCES)
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, *argtypes):
    """The C function ``symbol`` of ``csrc/<name>.cu``, typed: pointers and
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
