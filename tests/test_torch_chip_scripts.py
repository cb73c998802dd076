"""``chip_ato_phases.py`` and ``chip_spill_phases.py`` build copies of
``csrc/seeding.cu``, and ``chip_smo_variants.py`` and
``chip_select_split.py`` copies of ``csrc/smo_step.cu``, with counter reads
or ablations put in by text: each of their edits must still find its text
exactly once in the source, or the script's build would raise on the card.
Held here on the CPU, so that an edit to those lines of a kernel that is
not mirrored in the script fails at once."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "seeding.cu"


def _phases(name="chip_ato_phases"):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EDITS = _phases().EDITS
SPILL_EDITS = _phases("chip_spill_phases").EDITS


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


@pytest.mark.parametrize("k", range(len(SPILL_EDITS)))
def test_spill_phases_edit_finds_its_text_once(k):
    old, new = SPILL_EDITS[k]
    assert SOURCE.read_text().count(old) == 1
    assert old != new


def test_spill_phases_stamps_the_fused_avg_spill():
    """Every counter slot read once a call (the rounds' reads by their
    index expression), and the edits inside the fused AVG kernel."""
    mod = _phases("chip_spill_phases")
    stamps = "".join(new for _, new in mod.EDITS[1:])
    fixed = [i for i in range(3) if mod.STAMP.format(i) in stamps]
    assert fixed == [0, 1, 2]
    assert mod.STAMP.format("3 + 2 * rd") in stamps
    assert mod.STAMP.format("4 + 2 * rd") in stamps
    assert mod.SLOTS == 5 + 2 * (mod.ROUNDS - 1)
    src = SOURCE.read_text()
    assert f"constexpr int kAvgRounds = {mod.ROUNDS};" in src
    body = src[src.index("avg_spill_fused_kernel(const double*"):
               src.index("// top_spill, route fused:")]
    assert all(old in body for old, _ in mod.EDITS[1:])


@pytest.mark.parametrize("name", sorted(_phases("chip_spill_phases").MUTANTS))
def test_spill_phases_ablation_finds_its_text_once(name):
    """Each ablation's edit finds its text once, in the fused AVG kernel's
    rounds, on the stamped copy's text."""
    mod = _phases("chip_spill_phases")
    src = SOURCE.read_text()
    for old, new in mod.EDITS:
        src = src.replace(old, new)
    old, new = mod.MUTANTS[name]
    assert src.count(old) == 1 and old != new
    body = src[src.index("avg_spill_fused_kernel(const double*"):
               src.index("// top_spill, route fused:")]
    assert old in body


# ``chip_smo_variants.py`` and ``chip_select_split.py`` edit copies of
# ``csrc/smo_step.cu`` by text too: each edit of the design the source
# holds must find its text exactly once (the per-lane strides of the
# streaming kernels sit beside those lines, not in them).
STEP = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
SMO_VARIANTS = _phases("chip_smo_variants").VARIANTS
SELECT = _phases("chip_select_split")


@pytest.mark.parametrize("name", sorted(SMO_VARIANTS))
def test_smo_variants_edits_find_their_text_once(name):
    src = (STEP / "smo_step.cu").read_text()
    for old, new in SMO_VARIANTS[name]:
        assert src.count(old) == 1 and old != new


def test_select_split_edits_find_their_text_once():
    texts = {f: (STEP / f).read_text()
             for f in ("smo_step.cu", "smo_common.cuh")}
    which = SELECT.design(texts["smo_step.cu"])
    assert which == "one_barrier"
    _, entry, _, marks = SELECT.DESIGNS[which]
    assert texts["smo_step.cu"].count(SELECT._HEAD[0]) == 1
    for f, old, new in marks:
        assert texts[f].count(old) == 1 and old != new
    # the entry the timed build appends calls the C entry as it stands
    assert "extern \"C\" int smo_select_f64(const double* X" in \
        texts["smo_step.cu"]


# ``chip_scan_variants.py`` edits copies of ``csrc/selective_scan.cu`` by
# text: each edit must find its text exactly once, and the copies that
# compute the scan change only its block shape or an unroll depth.
SCAN_VARIANTS = _phases("chip_scan_variants")


@pytest.mark.parametrize("name", sorted(SCAN_VARIANTS.VARIANTS))
def test_scan_variants_edits_find_their_text_once(name):
    src = (STEP / "selective_scan.cu").read_text()
    for old, new in SCAN_VARIANTS.VARIANTS[name]:
        assert src.count(old) == 1 and old != new
    assert SCAN_VARIANTS.edited(name) != src or name == "as_is"
    if name in SCAN_VARIANTS.EXACT and name != "as_is":
        assert all(old.startswith(("constexpr int k", "#pragma unroll"))
                   for old, _ in SCAN_VARIANTS.VARIANTS[name])


# ``chip_stream_phases.py`` stamps copies of ``csrc/smo_step.cu`` (the
# persistent streaming chunk) and ``csrc/smo_stream.cu`` (the cluster
# route) by text: each edit must find its
# text exactly once, inside the kernel it times, and every phase of each
# kernel's chain is closed by one counter read.
STREAM_PHASES = _phases("chip_stream_phases")


@pytest.mark.parametrize("route", sorted(STREAM_PHASES.EDITS))
def test_stream_phases_edits_find_their_text_once(route):
    name, edits = STREAM_PHASES.EDITS[route]
    src = (STEP / name).read_text()
    for old, new in edits:
        assert src.count(old) == 1 and old != new
    kernel = {"persistent": "smo_stream_kernel(const double*",
              "cluster": "smo_stream_cluster_kernel("}[route]
    body = src[src.index(kernel):]
    assert all(old in body for old, _ in edits[2 if route == "cluster"
                                               else 1:])
    text = STREAM_PHASES.edited(route)
    for k in range(STREAM_PHASES.SLOTS):
        reads = sum(text.count(STREAM_PHASES._s(k, it))
                    for it in ("t", "stamp_t"))
        assert reads == 1, (route, k)
    assert len(STREAM_PHASES.PHASES[route]) == STREAM_PHASES.SLOTS - 1


# ``chip_slstm_phases.py`` stamps copies of ``csrc/slstm.cu``: the source
# as it stands (``new``) and the parent design's cluster route spliced in
# its place (``parent``). Each edit must find its text exactly once in its
# design's text, inside the cluster kernel it times, and every phase of
# the step is closed by one counter read.
SLSTM_PHASES = _phases("chip_slstm_phases")


@pytest.mark.parametrize("base", sorted(SLSTM_PHASES.EDITS))
def test_slstm_phases_edits_find_their_text_once(base):
    src = SLSTM_PHASES.design_text(base)
    edits = SLSTM_PHASES.EDITS[base]
    for old, new in edits:
        assert src.count(old) == 1 and old != new
    body = src[src.index("slstm_cluster_kernel(const bf16*"):
               src.index(SLSTM_PHASES.ROUTE_END)]
    assert all(old in body for old, _ in edits[1:])


@pytest.mark.parametrize("base", sorted(SLSTM_PHASES.EDITS))
def test_slstm_phases_stamps_every_phase(base):
    text = SLSTM_PHASES.edited(base)
    for k in range(SLSTM_PHASES.SLOTS):
        assert text.count(SLSTM_PHASES._s(k)) == 1, (base, k)
    assert len(SLSTM_PHASES.PHASES[base]) == SLSTM_PHASES.SLOTS - 1
    assert text.endswith(SLSTM_PHASES.TAIL)


def test_slstm_phases_parent_splice_keeps_the_rest():
    """The parent's copy differs from the source only in the cluster
    route's namespace: the block route, the step and the C entries are
    the source's, and the parent's route is whole."""
    src = (STEP / "slstm.cu").read_text()
    parent = SLSTM_PHASES.design_text("parent")
    begin, end = SLSTM_PHASES.ROUTE_BEGIN, SLSTM_PHASES.ROUTE_END
    assert SLSTM_PHASES.PARENT_ROUTE.startswith(begin)
    assert SLSTM_PHASES.PARENT_ROUTE.endswith(end)
    assert parent.count(begin) == 1 and parent.count(end) == 1
    assert SLSTM_PHASES.PARENT_ROUTE in parent
    assert src[:src.index(begin)] == parent[:parent.index(begin)]
    assert src[src.index(end):] == parent[parent.index(end):]
    assert "cluster.sync();\n  }\n" in SLSTM_PHASES.PARENT_ROUTE
    assert "expect_bytes" in src and "expect_bytes" not in parent


@pytest.mark.parametrize("design", sorted(SLSTM_PHASES.DESIGNS))
def test_slstm_phases_designs_set_the_sources_macros(design):
    """Each design's flags set macros the source defines a default for,
    and to another value than that default."""
    base, flags = SLSTM_PHASES.DESIGNS[design]
    assert base in SLSTM_PHASES.EDITS
    src = (STEP / "slstm.cu").read_text()
    for flag in flags:
        name, value = flag[2:].split("=")
        assert f"#ifndef {name}\n#define {name} " in src
        assert f"#define {name} {value}\n" not in src


# ``chip_mlstm_phases.py`` stamps copies of ``csrc/mlstm.cu``: both bf16
# kernels, the mma route (the parent) and the wgmma route. Each edit must
# find its text exactly once, inside the kernel it times; every phase of
# each role's tile, and of its prologue and epilogue, is closed by one
# counter read; and each design's build edits the wgmma route's text.
MLSTM_PHASES = _phases("chip_mlstm_phases")


@pytest.mark.parametrize("k", range(len(MLSTM_PHASES.EDITS)))
def test_mlstm_phases_edit_finds_its_text_once(k):
    old, new = MLSTM_PHASES.EDITS[k]
    src = (STEP / "mlstm.cu").read_text()
    assert src.count(old) == 1 and old != new
    if k == 0:
        return
    mma = src[src.index("mlstm_mma_kernel(const bf16*"):
              src.index("}  // namespace mma_route")]
    wg = src[src.index("mlstm_wgmma_kernel(const __grid_constant__"):
             src.index("}  // namespace wg_route")]
    assert (old in mma) != (old in wg)


@pytest.mark.parametrize("kernel", sorted(MLSTM_PHASES.PHASES))
def test_mlstm_phases_stamps_every_phase(kernel):
    text = MLSTM_PHASES.edited()
    assert text.endswith(MLSTM_PHASES.TAIL)
    roles = MLSTM_PHASES.PHASES[kernel]
    for r, (role, names) in enumerate(roles.items()):
        tid = MLSTM_PHASES.ROLE_THREAD[kernel][role]
        assert len(names) + 1 <= MLSTM_PHASES.SLOTS
        for k in range(len(names) + 1):
            assert text.count(MLSTM_PHASES._s(r, k, tid)) == 1, (role, k)
        reads = {k for ab in MLSTM_PHASES.PROLOGUE[kernel][role].values()
                 for k in ab}
        assert max(reads) < MLSTM_PHASES.PRO
        for k in reads:
            assert text.count(MLSTM_PHASES._p(r, k, tid)) == 1, (role, k)


@pytest.mark.parametrize("design", sorted(MLSTM_PHASES.DESIGNS))
def test_mlstm_phases_design_edits_find_their_text_once(design):
    """Each design's build edits the wgmma route only, each edit finding
    its text exactly once in turn; its kernel is one the script stamps,
    and its copy takes every counter read."""
    build, kernel = MLSTM_PHASES.DESIGNS[design]
    assert kernel in MLSTM_PHASES.PHASES
    src = (STEP / "mlstm.cu").read_text()
    text = src
    for old, new in MLSTM_PHASES.BUILDS[build]:
        assert text.count(old) == 1 and old != new
        text = text.replace(old, new)
    assert text == MLSTM_PHASES.design_text(build)
    assert (text != src) == bool(MLSTM_PHASES.BUILDS[build])
    start = "namespace wg_route {"
    assert text[:text.index(start)] + text[text.index("namespace fma_route"):] \
        == src[:src.index(start)] + src[src.index("namespace fma_route"):]
    stamped = MLSTM_PHASES.edited(text)
    for r, tid in enumerate(MLSTM_PHASES.ROLE_THREAD[kernel].values()):
        for k in range(len(list(MLSTM_PHASES.PHASES[kernel].values())[r])
                       + 1):
            assert stamped.count(MLSTM_PHASES._s(r, k, tid)) == 1
