"""Mutation check of the bf16 flash-attention gates, on one NVIDIA GPU.

    python3 chip_flash_mutants.py

Builds the kernel from ``src/repro_torch`` as it is and from copies (in a
temporary directory, never in the repository) with one fault each:
``l`` or the accumulator not rescaled when the running max moves, the
window's edge off by one, the softmax scale 1% off. Each build runs the
bf16 cases of ``chip_smoke.py`` (the reference's, FLASH_BF16_CASES and
granite-8b's prefill shape) and holds them to the gate ``chip_smoke.py``
uses (``flash_bf16_ok``: row by row against the plain version in float32)
and to the absolute bars it used before (0.06 from the plain version in
bf16; 0.02 from the float32 one at granite's shape). Prints one JSON line
per build and exits non-zero unless the kernel as it is passes every case
and every fault fails at least one.
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
#: fault -> (text of the kernel, its replacement); the bf16 cases run only
#: the mma.sync kernel, so a text shared with the float32 one may change too
MUTANTS = {
    "l_not_rescaled": ("l[i] = alpha * l[i] + sum;", "l[i] = l[i] + sum;"),
    "acc_not_rescaled": ("acc[j][2 * i] *= alpha;\n"
                         "        acc[j][2 * i + 1] *= alpha;",
                         "acc[j][2 * i] *= 1.0f;\n"
                         "        acc[j][2 * i + 1] *= 1.0f;"),
    "window_off_by_one": ("kpos > qpos - window", "kpos >= qpos - window"),
    "scale_1pct": ("1.0f / sqrtf((float)D)", "1.01f / sqrtf((float)D)"),
}

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import ops
assert ops.__file__.startswith(sys.argv[1]), ops.__file__
sys.path.insert(0, sys.argv[2])
import chip_smoke as cs
rng = np.random.default_rng(2)
rows = []
for B, H, KV, S, D, causal, window in (((1, 2, 2, 64, 32, True, None),)
        + cs.FLASH_BF16_CASES + ((*cs.FLASH_GRANITE, True, None),)):
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, D)),
                               dtype=torch.bfloat16, device="cuda"
                               ).transpose(1, 2) for h in (H, KV, KV))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    r = cs.flash_bf16_errors(got, q, k, v, causal, window)
    old = (r["max_abs_err"] <= 0.02 if S == cs.FLASH_GRANITE[3]
           else r["max_abs_diff_bf16_plain"] <= 0.06)
    rows.append({"case": [B, H, KV, S, D, causal, window],
                 "gate_passes": cs.flash_bf16_ok(r),
                 "old_bars_pass": old, **r})
print(json.dumps(rows))
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
        for name, edit in [("none", None), *MUTANTS.items()]:
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
            rows = run(src)
            caught = not all(r["gate_passes"] for r in rows)
            ok &= caught if edit is not None else not caught
            print(json.dumps({"build": name, "gate_fails_on": sum(
                not r["gate_passes"] for r in rows), "old_bars_fail_on": sum(
                not r["old_bars_pass"] for r in rows), "cases": rows}),
                flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
