"""``chip_ato_phases.py`` builds a copy of ``csrc/seeding.cu`` with
counter reads put in by text: each of its edits must still find its text
exactly once in the source, or the script's build would raise on the
card. Held here on the CPU, so that an edit to those lines of the fused
apply kernel that is not mirrored in the script fails at once."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "seeding.cu"


def _phases():
    spec = importlib.util.spec_from_file_location(
        "chip_ato_phases", ROOT / "chip_ato_phases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EDITS = _phases().EDITS


@pytest.mark.parametrize("k", range(len(EDITS)))
def test_ato_phases_edit_finds_its_text_once(k):
    old, new = EDITS[k]
    assert SOURCE.read_text().count(old) == 1
    assert old != new


def test_ato_phases_stamps_every_phase():
    """One counter read a phase boundary (entry, the six phases' ends),
    each index once, and the kernel source edited in the fused apply."""
    mod = _phases()
    stamps = [new for _, new in mod.EDITS[1:]]
    for i in range(len(mod.PHASES) + 1):
        assert sum(mod.STAMP.format(i) in s for s in stamps) == 1, i
    src = SOURCE.read_text()
    body = src[src.index("ato_apply_fused_kernel("):
               src.index("// avg_spill:")]
    assert all(old in body for old, _ in mod.EDITS[1:])
