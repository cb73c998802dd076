"""Ablations of mamba's selective scan kernel, timed on one NVIDIA GPU.

    python3 chip_scan_variants.py

No profiler that splits a kernel runs on the card's machine, so this
script times ``csrc/selective_scan.cu`` as it is beside copies with one
part changed (made in a temporary directory, never in the repository; one
``nvcc`` each, all started together), at the main path's prefill shape,
(B, S, Din, St) = (1, 32,768, 8,192, 16) in bf16:

* ``as_is``: the source unchanged;
* ``no_exp``: dA is dt * A itself (no exp);
* ``no_fold``: no reduce-scatter over a channel's lanes (each lane stores
  its own first partial sum);
* ``no_loads``: no copies after the first round's (every round computes
  on whatever the raw buffers hold);
* ``channels_16``: blocks of 16 channels (64 threads) in place of 32;
* ``unroll_1`` and ``unroll_4``: a whole round's groups unrolled 1 and 4
  deep in place of 2;
* ``lanes_8``: a channel's 16 states over 8 lanes of 2 (twice the
  threads; its sum over the states rounds in another order).

For each it prints one JSON line: ptxas's registers and spills, the
count of each instruction class the MIO queue and the SFU serve in its
bf16 kernel's SASS (``cuobjdump -sass``: MUFU, LDS, STS, SHFL, BAR), and
the kernel's time by CUDA events (the mean of 10 launches after 3) at the
prefill's shape and at the same work split over 16 batch rows, (16,
2,048, 8,192, 16): 16 times the threads, so what a build does with the
occupancy the prefill's one row leaves unused shows there. Then
``as_is`` alone is timed at (B, S) = (2, 16,384), (4, 8,192) and (8,
4,096). With ``--sass DIR`` each build's bf16 kernel's SASS is written
to DIR/<variant>.sass. Only
``as_is``, ``channels_*`` and ``steps_64`` compute the scan (the same
operations on each (channel, state) in the same order): each must give
the wrapper's output bit for bit, or the script exits non-zero. The copies
find their edits by the text of the source, so an edit to those lines of
``selective_scan.cu`` must be made here too (a build that cannot find its
text raises; ``tests/test_torch_chip_scripts.py`` checks it on the CPU).
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
sys.path.insert(0, os.path.join(ROOT, "src"))

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
_CHANNELS = "constexpr int kChannels = 32; "
_UNROLL = "#pragma unroll 2\n"
#: variant -> ((text of selective_scan.cu, its replacement), ...)
VARIANTS = {
    "as_is": (),
    "no_exp": (("      const float dA = exp2_ftz(dd.x * a[k] * kLog2e);",
                "      const float dA = dd.x * a[k] * kLog2e;"),),
    "no_fold": (("  fold_all<kLanes / 2>(p, q);\n", ""),),
    "no_loads": (("    if (r + 1 < rounds)\n      fetch(", "    if (false)\n"
                  "      fetch("),),
    "channels_16": ((_CHANNELS, "constexpr int kChannels = 16; "),),
    **{f"unroll_{n}": ((_UNROLL, f"#pragma unroll {n}\n"),) for n in (1, 4)},
    "lanes_8": (("constexpr int kLanes = 4; ", "constexpr int kLanes = 8; "),),
}
#: the variants that compute the scan (the others change its arithmetic)
EXACT = ("as_is", "channels_16", "unroll_1", "unroll_4")
SHAPE = (1, 32768, 8192, 16)
#: (B, S) splits of the prefill's work that ``as_is`` is timed at too
SPLITS = ((2, 16384), (4, 8192), (8, 4096))
#: the prefill's work over 16 rows, where the grid fills every block slot
WIDE = (16, 2048, 8192, 16)
#: SASS opcodes counted in each build's bf16 kernel
OPCODES = ("MUFU", "LDS", "STS", "SHFL", "BAR", "FFMA", "FMUL")
_P, _I = ctypes.c_void_p, ctypes.c_int


def edited(name: str) -> str:
    """selective_scan.cu with ``name``'s edits, each found exactly once."""
    with open(os.path.join(CSRC, "selective_scan.cu")) as fh:
        text = fh.read()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: edit text found {text.count(old)} "
                               "times in selective_scan.cu")
        text = text.replace(old, new)
    return text


def build_all(tmp: str) -> dict:
    """One nvcc per variant, all started together; {name: (lib, ptxas)}."""
    from repro_torch.kernels import _build
    procs = {}
    for name in VARIANTS:
        src = os.path.join(tmp, f"{name}.cu")
        with open(src, "w") as fh:
            fh.write(edited(name))
        lib = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.flags("selective_scan"), "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        out[name] = (lib, [ln.split(":", 1)[-1].strip()
                           for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln])
    return out


def sass_counts(lib: str, dump: str | None = None) -> dict:
    """{opcode: count} over the bf16 kernel's SASS (written to ``dump``
    when given), or the reason there is none (``cuobjdump`` sits beside
    ``nvcc``)."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    try:
        out = subprocess.run([tool, "-sass", lib], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as err:
        return {"error": str(err)}
    body, on = [], False
    for line in out.splitlines():
        if "Function :" in line:
            on = "nv_bfloat16" in line
        elif on:
            body.append(line)
    if dump is not None:
        with open(dump, "w") as fh:
            fh.write("\n".join(body))
    ops = [ln.split("*/", 1)[-1].strip().split(" ")[0].split(".")[0]
           for ln in body if "/*" in ln and "*/" in ln]
    ops = [o.lstrip("@!P0123456789 ") for o in ops]
    return {op: sum(o == op for o in ops) for op in OPCODES}


def inputs(B: int, S: int, Din: int, St: int, seed: int = 0):
    """Seeded bf16 inputs of the scan on the card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    u = draw(B, S, Din).bfloat16()
    dt = torch.nn.functional.softplus(draw(B, S, Din)).bfloat16()
    A = -torch.exp(1.0 + 0.5 * draw(Din, St))
    return u, dt, A, draw(B, S, St).bfloat16(), draw(B, S, St).bfloat16()


def events_ms(run, reps: int = 10, warmup: int = 3) -> float:
    """Mean device time of ``run()`` by CUDA events."""
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_scan_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    sass_dir = sys.argv[sys.argv.index("--sass") + 1] \
        if "--sass" in sys.argv else None
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
    B, S, Din, St = SHAPE
    shapes = {"prefill": SHAPE, "wide": WIDE}
    args = {k: inputs(*shape) for k, shape in shapes.items()}
    want = {k: ops.selective_scan(*a) for k, a in args.items()}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name, (lib, ptxas) in build_all(tmp).items():
            fn = ctypes.CDLL(lib).selective_scan_bf16
            fn.argtypes = [_P] * 8 + [_I, _I, _I, _P]
            fn.restype = ctypes.c_int
            rec = {"variant": name, "ptxas": ptxas,
                   "sass": sass_counts(lib, sass_dir and os.path.join(
                       sass_dir, f"{name}.sass")), "card": card}
            for k, (u, dt, A, Bp, Cp) in args.items():
                y = torch.empty_like(u)
                shape = shapes[k]

                def run():
                    err = fn(u.data_ptr(), dt.data_ptr(), A.data_ptr(),
                             Bp.data_ptr(), Cp.data_ptr(), None, None,
                             y.data_ptr(), shape[0], shape[1], shape[2],
                             _build.stream_ptr(u))
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                rec[f"ms_{k}"] = events_ms(run)
                rec[f"shape_{k}"] = list(shape)
                if name in EXACT:
                    rec[f"bitwise_{k}"] = bool(torch.equal(y, want[k]))
                    ok = ok and rec[f"bitwise_{k}"]
            print(json.dumps(rec), flush=True)
    del args, want
    for Bs, Ss in SPLITS:
        split = inputs(Bs, Ss, Din, St, 1)
        print(json.dumps({"variant": "as_is", "shape": [Bs, Ss, Din, St],
                          "ms": events_ms(
                              lambda: ops.selective_scan(*split)),
                          "card": card}), flush=True)
        del split
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
