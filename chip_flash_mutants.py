"""Mutation check of the bf16 flash-attention gates, on one NVIDIA GPU.

    python3 chip_flash_mutants.py

Builds the kernel from ``src/repro_torch`` as it is and from copies (in a
temporary directory, never in the repository) with one fault each, on
each bf16 route: ``l`` or the accumulator not rescaled when the running
max moves, the window's edge off by one, the softmax scale 1% off. The
wgmma route (head dims 64, 128, 256 and MLA's (192, 128)) and the mma.sync
route (16, 32) get the four faults each. Each build runs the bf16 cases of ``chip_smoke.py``
(the reference's, FLASH_BF16_CASES, and granite-8b's prefill shape at
head dims 128, 32 and 16: the mma.sync route's kv tiles are 128 keys, so
the sweep's short rows see one tile, and its rescaling faults show on the
long ones; and MLA's pair, q and k 192 wide and v 128, at 1,000 rows) and
holds them to the gate ``chip_smoke.py`` uses (``flash_bf16_ok``: row by
row against the plain version in float32) and to the absolute bars it
used before (0.06 from the plain version in bf16; 0.02 from the float32
one at granite's shape). Prints one JSON line per build and exits
non-zero unless the kernel as it is passes every case and every fault
fails at least one.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
CU = os.path.join("repro_torch", "kernels", "csrc", "flash_attention.cu")
#: fault -> (text of the kernel, its replacement). The wgmma route's texts
#: are its own; the mma.sync route's may be shared with the float32
#: kernel, which the bf16 cases never run.
MUTANTS = {
    "wgmma_l_not_rescaled": ("l_part[i] = alpha[i] * l_part[i] + psum;",
                             "l_part[i] = l_part[i] + psum;"),
    "wgmma_acc_not_rescaled": ("o_acc[4 * j + 2 * i] *= alpha[i];\n"
                               "          o_acc[4 * j + 2 * i + 1] *= "
                               "alpha[i];",
                               "o_acc[4 * j + 2 * i] *= 1.0f;\n"
                               "          o_acc[4 * j + 2 * i + 1] *= 1.0f;"),
    "wgmma_window_off_by_one": ("kpos + window > qpos",
                                "kpos + window >= qpos"),
    "wgmma_scale_1pct": ("1.4426950408889634f / sqrtf((float)DQK)",
                         "1.01f * 1.4426950408889634f / sqrtf((float)DQK)"),
    "mma_l_not_rescaled": ("l[mt][i] = alpha * l[mt][i] + sum;",
                           "l[mt][i] = l[mt][i] + sum;"),
    "mma_acc_not_rescaled": ("acc[mt][j][2 * i] *= alpha;\n"
                             "        acc[mt][j][2 * i + 1] *= alpha;",
                             "acc[mt][j][2 * i] *= 1.0f;\n"
                             "        acc[mt][j][2 * i + 1] *= 1.0f;"),
    "mma_window_off_by_one": ("kpos > qpos - window", "kpos >= qpos - window"),
    "mma_scale_1pct": ("1.0f / sqrtf((float)D)", "1.01f / sqrtf((float)D)"),
}

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import route
assert ops.__file__.startswith(sys.argv[1]), ops.__file__
sys.path.insert(0, sys.argv[2])
import chip_smoke as cs
rng = np.random.default_rng(2)
rows = []
for B, H, KV, S, D, causal, window, *dv in (((1, 2, 2, 64, 32, True, None),)
        + cs.FLASH_BF16_CASES + tuple((*shape, True, None) for shape in (
            cs.FLASH_GRANITE, cs.FLASH_D32, cs.FLASH_D16))
        + ((1, 8, 8, 1000, 192, True, None, 128),)):
    Dv = dv[0] if dv else D
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, d)),
                               dtype=torch.bfloat16, device="cuda"
                               ).transpose(1, 2)
               for h, d in ((H, D), (KV, D), (KV, Dv)))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    r = cs.flash_bf16_errors(got, q, k, v, causal, window)
    old = (r["max_abs_err"] <= 0.02 if S == cs.FLASH_GRANITE[3]
           else r["max_abs_diff_bf16_plain"] <= 0.06)
    del got, q, k, v
    torch.cuda.empty_cache()
    rows.append({"case": [B, H, KV, S, D, causal, window, Dv],
                 "route": route(torch.bfloat16, D, Dv),
                 "gate_passes": cs.flash_bf16_ok(r),
                 "old_bars_pass": old, **r})
print(json.dumps(rows))
"""


BUILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import _build
_build.build_all(("flash_attention",))
"""


def run(src: str) -> list:
    out = subprocess.run([sys.executable, "-c", CHILD, src, ROOT],
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_mutants: no CUDA device", file=sys.stderr)
        return 1
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        builds = [("none", None), *MUTANTS.items()]
        for name, edit in builds:
            src = os.path.join(tmp, name)
            shutil.copytree(os.path.join(ROOT, "src"), src,
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            if edit is not None:
                path = os.path.join(src, CU)
                with open(path) as f:
                    text = f.read()
                if edit[0] not in text:
                    raise RuntimeError(f"{name}: {edit[0]!r} not in {CU}")
                with open(path, "w") as f:
                    f.write(text.replace(*edit))
        # every copy's kernel compiled at once, then checked one by one
        procs = [subprocess.Popen([sys.executable, "-c", BUILD,
                                   os.path.join(tmp, name)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for name, _ in builds]
        for (name, _), proc in zip(builds, procs):
            log, _ = proc.communicate(timeout=600)
            if proc.returncode:
                raise RuntimeError(f"{name}: build failed:\n{log[-3000:]}")
        for name, edit in builds:
            rows = run(os.path.join(tmp, name))
            caught = not all(r["gate_passes"] for r in rows)
            ok &= caught if edit is not None else not caught
            print(json.dumps({"build": name, "gate_fails_on": sum(
                not r["gate_passes"] for r in rows), "old_bars_fail_on": sum(
                not r["old_bars_pass"] for r in rows), "cases": rows}),
                flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
