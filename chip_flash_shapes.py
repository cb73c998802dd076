"""The bf16 mma.sync attention route's block shape, timed on one NVIDIA GPU.

    python3 chip_flash_shapes.py [--parent DIR]

Builds ``csrc/flash_attention.cu`` as it is beside copies whose D <= 32
shape (``mma_route::Cfg``: warps a block, 16-row m-tiles a warp, keys a
kv tile, K/V ring stages, blocks an SM the registers are bounded for) is
edited by text, in a temporary
directory, never in the repository, one ``nvcc`` each, started together;
with ``--parent DIR``, also the attention source of the package under DIR
(another checkout's ``src``). Each build's ``flash_attention_bf16``
entry then runs causal attention at granite's prefill shape with head dims
32 and 16 (``chip_smoke.FLASH_D32`` / ``FLASH_D16``), q, k, v read in place
from (B, S, H, D) activations, in ROUNDS rounds that time every build in
turn (CUDA events over REPS launches after one), each build keeping its
fastest round, beside ``F.scaled_dot_product_attention`` on the same
inputs, the wgmma route (head dim 64) over the heads zero-padded to 64
(its time only), and the exp bound (``chip_smoke.exp_bound_ms``). Each
build's
output must stay within ``chip_smoke.flash_bf16_ok``'s bars. Prints one
JSON line with ptxas's registers and spills and the times, with the card's
name and power limit. The copies find their edits by the text of the
source (a build that cannot find its text raises).
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
sys.path.insert(0, ROOT)

CU = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                  "flash_attention.cu")
#: mma_route::Cfg's lines: name -> (its text, its expression)
_CFG = {
    "nw": ("  static constexpr int NW = ", "D <= 32 ? 4 : 8;"),
    "mt": ("  static constexpr int MT = ", "D <= 32 ? 2 : 1;"),
    "bk": ("  static constexpr int BK = ", "D <= 32 ? 128 : 64;"),
    "st": ("  static constexpr int STAGES = ", "D == 256 ? 2 : 3;"),
    "mb": ("  static constexpr int MIN_BLOCKS = ", "D <= 64 ? 2 : 1;"),
}


def at_small_d(**shape) -> tuple:
    """The edits that give head dims 16 and 32 ``shape`` (warps ``nw``,
    m-tiles a warp ``mt``, keys a tile ``bk``, stages ``st``, blocks an SM
    ``mb``) and leave the other head dims as the source has them."""
    return tuple((head + expr, f"{head}D <= 32 ? {shape[key]} : "
                  f"({expr[:-1]});")
                 for key, (head, expr) in _CFG.items() if key in shape)


#: build -> its edits; the source's own shape at D <= 32 is nw 4, mt 2,
#: bk 128, st 3, mb 2
SHAPES = {
    "nw4_mt2_bk128_st3_mb2": (),
    "nw4_mt2_bk128_st4_mb2": at_small_d(st=4),
    "nw4_mt2_bk64_st3_mb3": at_small_d(bk=64, mb=3),
    "nw8_mt1_bk128_st3_mb2": at_small_d(nw=8, mt=1),
    "nw8_mt1_bk128_st2_mb2": at_small_d(nw=8, mt=1, st=2),
    "nw8_mt1_bk64_st3_mb2": at_small_d(nw=8, mt=1, bk=64),
    "nw8_mt2_bk128_st3_mb1": at_small_d(nw=8, mb=1),
}
ROUNDS, REPS = 3, 10
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_all(tmp: str) -> dict:
    """One nvcc per build, all started together; {name: (lib, ptxas,
    whether its entries take (DQK, DV))}."""
    from repro_torch.kernels import _build
    with open(CU) as fh:
        source = fh.read()
    srcs = {}
    for name, edits in SHAPES.items():
        src = source
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: text not found: {old!r}")
            src = src.replace(old, new)
        srcs[name] = src
    if "--parent" in sys.argv:
        parent = os.path.join(os.path.abspath(
            sys.argv[sys.argv.index("--parent") + 1]), "repro_torch",
            "kernels", "csrc", "flash_attention.cu")
        with open(parent) as fh:
            srcs["parent"] = fh.read()
    csrc = os.path.dirname(CU)
    for header in os.listdir(csrc):   # the headers the copies include
        if header.endswith(".cuh"):
            with open(os.path.join(csrc, header)) as fh, \
                    open(os.path.join(tmp, header), "w") as out:
                out.write(fh.read())
    procs = {}
    for name, src in srcs.items():
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        lib = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.flags("flash_attention"), "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on build {name}:\n{log}")
        lines, cur = [], ""
        for ln in log.splitlines():
            if "Compiling entry function" in ln or "Function properties" \
                    in ln:
                cur = ln
            elif ("registers" in ln or "spill" in ln) and "mma" in cur \
                    and ("ILi32E" in cur or "ILi16E" in cur):
                lines.append(("D32 " if "ILi32E" in cur else "D16 ")
                             + ln.split(":", 1)[-1].strip())
        # the C entry takes v's head dim after q's where the source is
        # built for (DQK, DV) pairs; a parent's may not
        out[name] = (lib, lines, "int Dv" in srcs[name])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_flash_shapes: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import ops
    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    rec = {"card": card, "sm_clock_max_mhz": cs.sm_clock_mhz(),
           "rounds": ROUNDS, "reps": REPS}
    with tempfile.TemporaryDirectory() as tmp:
        builds = build_all(tmp)
        fns, pairs = {}, {}
        for name, (lib, ptxas, pairs[name]) in builds.items():
            fn = ctypes.CDLL(lib).flash_attention_bf16
            fn.argtypes = [_P, _P, _P, _P, *[_I] * (7 if pairs[name] else 6),
                           _P, _I, _I, _P]
            fn.restype = ctypes.c_int
            fns[name] = fn
            rec[f"ptxas_{name}"] = ptxas
        for label, (B, H, KV, S, D) in (("d32", cs.FLASH_D32),
                                         ("d16", cs.FLASH_D16)):
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev,
                                   dtype=torch.bfloat16).transpose(1, 2)
                       for h in (H, KV, KV))
            out = torch.empty_like(q)
            strides = (ctypes.c_longlong * 12)(
                *(s for t in (q, k, v, out) for s in t.stride()[:3]))

            def run(fn, name):
                dims = (D, D) if pairs[name] else (D,)
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), B, H, KV, S, S, *dims,
                         ctypes.addressof(strides), 1, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            for name, fn in fns.items():
                run(fn, name)
                r = cs.flash_bf16_errors(out, q, k, v)
                rec[f"ok_{label}_{name}"] = cs.flash_bf16_ok(r)
                rec[f"row_rel_err_{label}_{name}"] = r["row_rel_err"]
                torch.cuda.empty_cache()
            qc = q.contiguous()
            kb, vb = (t.repeat_interleave(H // KV, dim=1).contiguous()
                      for t in (k, v))
            runs = {name: (lambda fn=fn, name=name: run(fn, name))
                    for name, fn in fns.items()}
            runs["sdpa"] = lambda: \
                torch.nn.functional.scaled_dot_product_attention(
                    qc, kb, vb, is_causal=True)
            # the wgmma route (head dim 64) over the heads zero-padded to
            # 64: the time of the same scores through wgmma, for scale
            # (its softmax scale is 64's, so only its time is kept)
            q64, k64, v64 = (torch.nn.functional.pad(
                t.transpose(1, 2), (0, 64 - D)).transpose(1, 2)
                for t in (q, k, v))
            runs["wgmma_padded_to_64"] = lambda: ops.flash_attention(
                q64, k64, v64, _route="wgmma")
            best = cs.routes_ms(lambda r: runs[r](), tuple(runs), REPS,
                                ROUNDS)
            rec[f"ms_{label}"] = best
            rec[f"exp_bound_ms_{label}"] = cs.exp_bound_ms(
                B * H * S * (S + 1) // 2)
            del q, k, v, out, qc, kb, vb, q64, k64, v64
            torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)
    ok = all(v for key, v in rec.items() if key.startswith("ok_"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
