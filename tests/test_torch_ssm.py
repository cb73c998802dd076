"""Mamba (Jamba's mixer) in the port against the JAX reference, on the CPU,
at SMOKE size (d_model 64: Din 128, St 16, Cv 4, dt_rank 4) in float32:
the selective scan's plain version against the reference's chunked scan
(``_ssm_chunk`` under ``lax.scan``, chunks of 256 steps, the padding to a
multiple of 256), ``mamba_apply``'s prefill and decode (the cache's
``conv`` and ``ssm`` and their dtypes), NoPE's ``apply_rope``, the
per-leaf ``ParamDef.dtype``, softplus, and the bars ``chip_smoke.py``'s
``serve_jamba`` holds the card to, each beside the reference's own gap.
The same numpy inputs and weights go through ``repro.models`` and
``repro_torch.models``; the whole model (``pair`` in ``test_torch_lm.py``)
covers forward, prefill, decode with caches and greedy tokens.

Tolerances: 1e-5 a unit of the output's scale (``_close``). The reference
composes each chunk of 256 steps by an associative scan (a tree) and the
plain version takes the steps in a loop; the sum over the 16 states runs
in each framework's dot order; measured gaps are ~1e-7 of the scale.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.launch.inputs import concrete_batch as ref_concrete_batch
from repro.models import layers as ref_layers
from repro.models import ssm as ref_ssm
from repro.models import transformer as RT
from repro.models.params import ParamDef as RefParamDef
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels.ref import selective_scan_ref
from repro_torch.models import layers, ssm
from repro_torch.models import transformer as PT
from repro_torch.models.params import ParamDef, count_from_defs, init_params

RNG = np.random.default_rng(29)
ARCH = "jamba-v0.1-52b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=1e-5):
    """atol ``rel`` x max(1, max |want|)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=rel * max(1.0, np.abs(want).max()))


def _row_rel(got, want) -> float:
    """max over rows (the last axis) of max |got - want| / max |want|, as
    ``chip_smoke._row_rel``."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    err = np.abs(got - want).max(-1)
    return float((err / np.maximum(np.abs(want).max(-1), 1e-30)).max())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    return chip


def _cfgs():
    return ref_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)


def _mamba_params(cfg, seed=0):
    """The reference's init of one mamba layer (f32), as numpy."""
    return jax.tree.map(np.asarray, ref_init_params(
        ref_ssm.mamba_def(cfg), jax.random.PRNGKey(seed), jnp.float32))


def _scan_inputs(S, Bsz=2, Din=128, St=16, seed=0):
    """u, dt (> 0, as softplus gives), A (< 0) and B, C, float32, from a
    numpy seed; A spread as -exp(A_log) for A_log around 1."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(Bsz, S, Din)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(Bsz, S, Din)))).astype(np.float32)
    A = -np.exp(1.0 + 0.5 * rng.normal(size=(Din, St))).astype(np.float32)
    Bp, Cp = (rng.normal(size=(Bsz, S, St)).astype(np.float32)
              for _ in range(2))
    return u, dt, A, Bp, Cp


def _reference_scan(u, dt, A, Bp, Cp):
    """The reference's prefill scan and C contraction
    (``ssm.mamba_apply``'s lines, ``_ssm_chunk`` under ``lax.scan``): dA,
    dBx, the padding to a multiple of 256 with dA = 1, dBx = 0, then
    ``einsum("bsen,bsn->bse")`` in float32, rounded to u's dtype."""
    u, dt, A, Bp, Cp = (jnp.asarray(a) for a in (u, dt, A, Bp, Cp))
    Bsz, S, Din = u.shape
    St = A.shape[-1]
    chunk = ref_ssm._CHUNK
    dA = jnp.exp(dt.astype(jnp.float32)[..., None] * A)
    dBx = (dt * u).astype(jnp.float32)[..., None] \
        * Bp.astype(jnp.float32)[:, :, None, :]
    pad = (-S) % chunk
    dA = jnp.pad(dA, ((0, 0), (0, pad), (0, 0), (0, 0)), constant_values=1.0)
    dBx = jnp.pad(dBx, ((0, 0), (0, pad), (0, 0), (0, 0)))
    Sp = S + pad
    dA_c = dA.reshape(Bsz, Sp // chunk, chunk, Din, St).transpose(1, 2, 0, 3,
                                                                  4)
    dBx_c = dBx.reshape(Bsz, Sp // chunk, chunk, Din, St).transpose(1, 2, 0,
                                                                    3, 4)
    h0 = jnp.zeros((Bsz, Din, St), jnp.float32)
    hlast, hs = jax.lax.scan(ref_ssm._ssm_chunk, h0, (dA_c, dBx_c))
    h = hs.transpose(2, 0, 1, 3, 4).reshape(Bsz, Sp, Din, St)[:, :S]
    y = jnp.einsum("bsen,bsn->bse", h, Cp.astype(jnp.float32))
    return np.asarray(y.astype(u.dtype)), np.asarray(h[:, -1])


# -------------------------------------------------------------- the scan ----

@pytest.mark.parametrize("S", [1, 100, 300], ids=["one", "ragged",
                                                  "past_a_chunk"])
def test_scan_plain_matches_reference_scan(S):
    """The plain version's loop against the reference's chunked scan: S = 1,
    a ragged 100 (padded to 256 there, masked nowhere here) and 300, past
    one chunk (the carry crosses a chunk boundary); y and the last state,
    1e-5 of their scale."""
    u, dt, A, Bp, Cp = _scan_inputs(S)
    want_y, want_h = _reference_scan(u, dt, A, Bp, Cp)
    y, h = selective_scan_ref(*(_t(a) for a in (u, dt, A, Bp, Cp)))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _close(y.numpy(), want_y)
    _close(h.numpy(), want_h)


def test_scan_from_a_state_is_the_reference_decode_step():
    """S = 1 from a state: the reference's decode line ``h = ssm * dA +
    dBx`` (one FMA in XLA-CPU, ``addcmul`` here) and its C contraction;
    the wrapper writes the state into ``h_out`` in place on the CPU too,
    where ``h_out`` is ``h0``."""
    u, dt, A, Bp, Cp = _scan_inputs(1, seed=1)
    h0 = RNG.normal(size=(2, 128, 16)).astype(np.float32)
    dA = np.exp(dt[:, 0, :, None] * A)
    want_h = h0 * dA + (dt * u)[:, 0, :, None] * Bp[:, 0, None, :]
    want_y = np.einsum("ben,bn->be", want_h, Cp[:, 0])[:, None]
    state = _t(h0)
    y = ops.selective_scan(*(_t(a) for a in (u, dt, A, Bp, Cp)), h0=state,
                           h_out=state)
    _close(y.numpy(), want_y)
    _close(state.numpy(), want_h)


def test_scan_rounds_dt_u_before_widening():
    """In bf16, ``dt * u`` is rounded to bf16 before it is widened (the
    reference's ``(dt * xc).astype(f32)``): the plain version's last state
    is the reference's within 1e-5 of its scale, where skipping that one
    rounding moves it by over 1e-4; y is bf16, the state float32."""
    u, dt, A, Bp, Cp = _scan_inputs(40, seed=2)
    b16 = [jnp.asarray(a, jnp.bfloat16) for a in (u, dt, Bp, Cp)]
    want_y, want_h = _reference_scan(b16[0], b16[1], A, b16[2], b16[3])
    t16 = [_t(np.asarray(a, np.float32)).to(torch.bfloat16) for a in b16]
    y, h = selective_scan_ref(t16[0], t16[1], _t(A), t16[2], t16[3])
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _close(h.numpy(), want_h)
    skip = selective_scan_ref(*(t.float() for t in t16[:2]), _t(A),
                              *(t.float() for t in t16[2:]))[1]
    assert np.abs(skip.numpy() - want_h).max() > 1e-4 * np.abs(want_h).max()


# ----------------------------------------------------------- mamba_apply ----

@pytest.mark.parametrize("S", [1, 100, 300], ids=["one", "ragged",
                                                  "past_a_chunk"])
def test_mamba_apply_prefill_matches_reference(S):
    """The whole mixer's prefill (in_proj, the causal conv, the selective
    parameters, the scan, the skip and the gate, out_proj) at S = 1, a
    ragged 100 and 300 past one chunk; no state is returned, as the
    reference returns none."""
    rcfg, cfg = _cfgs()
    p = _mamba_params(rcfg)
    x = RNG.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    want, want_cache = ref_ssm.mamba_apply(p, jnp.asarray(x), rcfg)
    got, cache = ssm.mamba_apply({k: _t(v) for k, v in p.items()}, _t(x),
                                 cfg)
    assert cache is None and want_cache is None
    assert got.shape == (2, S, cfg.d_model)
    _close(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_decode_matches_reference(dtype):
    """Four decode steps from a cache holding a nonzero conv window and
    state, the cache advanced in place: ``conv`` in the cache's dtype,
    ``ssm`` float32 in either (the reference's ``mamba_cache_def``), the
    window the last Cv - 1 steps' in_proj inputs. float32: each step's
    output and the cache after it against the reference's ``new_cache``,
    1e-5 of the scale. bf16 rounds at other places in the two frameworks
    (XLA-CPU runs a chain of bf16 elementwise ops in float32), so there the
    dtypes and the window are held, the values in float32 here and against
    the plain version on the card."""
    rcfg, cfg = _cfgs()
    dt_np = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    dt_t = getattr(torch, dtype)
    p = jax.tree.map(lambda a: jnp.asarray(a, dt_np), _mamba_params(rcfg, 1))
    pt = {k: _t(np.asarray(v, np.float32)).to(dt_t) for k, v in p.items()}
    Din = cfg.mamba_expand * cfg.d_model
    conv = RNG.normal(size=(2, cfg.mamba_d_conv - 1, Din)).astype(np.float32)
    state = RNG.normal(size=(2, Din, cfg.mamba_d_state)).astype(np.float32)
    rcache = {"conv": jnp.asarray(conv, dt_np), "ssm": jnp.asarray(state)}
    cache = {"conv": _t(conv).to(dt_t), "ssm": _t(state)}
    window = list(cache["conv"].clone().unbind(1))
    for t in range(4):
        x = RNG.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, rcache = ref_ssm.mamba_apply(p, jnp.asarray(x, dt_np), rcfg,
                                           cache=rcache)
        ssm_before, conv_before = cache["ssm"], cache["conv"]
        got, cache = ssm.mamba_apply(pt, _t(x).to(dt_t), cfg, cache=cache)
        assert cache["ssm"] is ssm_before and cache["conv"] is conv_before
        assert got.dtype == dt_t and cache["conv"].dtype == dt_t
        assert cache["ssm"].dtype == torch.float32
        assert rcache["conv"].dtype == dt_np
        assert rcache["ssm"].dtype == jnp.float32
        window.append((_t(x).to(dt_t) @ pt["in_proj"])[:, 0, :Din])
        assert torch.equal(cache["conv"], torch.stack(window[-3:], 1))
        if dtype == "float32":
            _close(got.numpy(), want)
            _close(cache["conv"].numpy(), rcache["conv"])
            _close(cache["ssm"].numpy(), rcache["ssm"])


def test_decode_matches_forward():
    """The reference's ``test_decode_matches_forward`` (its bar 2e-2, its
    capacity factor 8 so that no MoE slot drops: the forward's capacity
    competition is the intended difference) on the port alone, SMOKE
    Jamba in float32: teacher-forced decode through the mamba and
    attention caches reproduces the full forward's logits within 1e-4."""
    cfg = get_config(ARCH, smoke=True).replace(capacity_factor=8.0)
    model = PT.init_model(cfg, seed=5, dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(RNG.integers(0, cfg.vocab_size, size=(2, 10)))
    full, _ = PT.forward(model, {"tokens": tokens})
    cache = PT.init_cache(cfg, 2, 12, torch.float32, device="cpu")
    for t in range(10):
        lg, cache = PT.decode_step(model, cache, {
            "tokens": tokens[:, t:t + 1], "step": t})
        torch.testing.assert_close(lg[:, 0], full[:, t], rtol=0, atol=1e-4)


# ------------------------------------------------------- pieces of layers ---

def test_apply_rope_none_returns_x():
    """Jamba's attention is NoPE: ``rope_kind="none"`` (or no positions)
    returns x itself, as the reference's; M-RoPE still raises."""
    _, cfg = _cfgs()
    x = _t(RNG.normal(size=(2, 5, 4, 16)).astype(np.float32))
    pos = torch.arange(5)[None].expand(2, 5)
    assert layers.apply_rope(x, pos, cfg) is x
    assert layers.apply_rope(x, None, get_config("granite-8b",
                                                 smoke=True)) is x
    want = ref_layers.apply_rope(jnp.asarray(x.numpy()), jnp.asarray(pos),
                                 ref_get_config(ARCH, smoke=True))
    np.testing.assert_array_equal(x.numpy(), np.asarray(want))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layers.apply_rope(x, pos, cfg.replace(rope_kind="mrope"))


def test_softplus_agrees_with_jax():
    """``F.softplus`` switches to x above 20 and ``jax.nn.softplus`` is
    ``logaddexp(x, 0)``: they agree within an ulp in float32 and in bf16
    (their log1p and exp round apart), and bitwise past the switch, where
    log1p(exp(-x)) is under half an ulp of x and both give x."""
    x = np.concatenate([np.linspace(-30, 30, 601),
                        RNG.normal(size=400) * 8]).astype(np.float32)
    for jdt, tdt, rtol in ((jnp.float32, torch.float32, 2.0 ** -22),
                           (jnp.bfloat16, torch.bfloat16, 2.0 ** -7)):
        want = np.asarray(jax.nn.softplus(jnp.asarray(x, jdt)), np.float32)
        got = F.softplus(_t(x).to(tdt)).float().numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
        assert np.array_equal(got[x > 20], x[x > 20].astype(
            np.asarray(jnp.asarray(x, jdt)).dtype).astype(np.float32))


def test_param_def_dtype_and_init_params():
    """A leaf's ``dtype`` overrides the tree's in ``init_params`` (zeros,
    ones and normal draws alike), as the reference's; the count is
    unchanged, and the field mirrors the reference's ``ParamDef``."""
    defs = {"w": ParamDef((4, 8), ("a", "b")),
            "s": ParamDef((2, 8, 3), ("b", "h", "s"), init="zeros",
                          dtype="float32"),
            "n": ParamDef((8,), ("h",), init="normal", scale=0.1,
                          dtype="float32"),
            "o": ParamDef((3,), ("s",), init="ones")}
    p = init_params(defs, torch.Generator().manual_seed(1), torch.bfloat16,
                    "cpu")
    assert {k: v.dtype for k, v in p.items()} == {
        "w": torch.bfloat16, "s": torch.float32, "n": torch.float32,
        "o": torch.bfloat16}
    assert torch.equal(p["s"], torch.zeros(2, 8, 3))
    assert count_from_defs(defs) == 32 + 48 + 8 + 3
    assert RefParamDef((1,), ("a",), dtype="float32").dtype == \
        ParamDef((1,), ("a",), dtype="float32").dtype
    _, cfg = _cfgs()
    cache = PT.init_cache(cfg, 2, 6, torch.bfloat16, device="cpu")
    kinds = [(k, v.dtype) for layer in cache["layers"]
             for k, v in layer.items()]
    assert ("ssm", torch.float32) in kinds and ("conv", torch.bfloat16) \
        in kinds and ("k", torch.bfloat16) in kinds
    assert not any(k == "ssm" and d != torch.float32 for k, d in kinds)


def test_cache_from_reference_keeps_the_float32_state():
    """The reference's bf16 cache (``init_cache``: ``conv`` bf16, ``ssm``
    float32 by its ``ParamDef.dtype``) converts to the port's with the
    same dtypes and values, its layers in the plan's order (a scanned pair
    twice, then single layers at SMOKE size); the port's ``init_cache``
    gives the same tree."""
    rcfg, cfg = _cfgs()
    ref = RT.init_cache(rcfg, 2, 6, jnp.bfloat16)
    ref = jax.tree.map(lambda a: a + jnp.ones_like(a) * 0.5, ref)
    got = cache_from_reference(jax.tree.map(np.asarray, ref), cfg,
                               device="cpu", dtype=torch.bfloat16)
    want = PT.init_cache(cfg, 2, 6, torch.bfloat16, device="cpu")
    assert [sorted(layer) for layer in got["layers"]] == \
        [sorted(layer) for layer in want["layers"]]
    for layer, empty in zip(got["layers"], want["layers"], strict=True):
        for key, t in layer.items():
            assert t.dtype == empty[key].dtype and t.shape == \
                empty[key].shape
            assert t.dtype == (torch.float32 if key == "ssm"
                               else torch.bfloat16)
            assert bool((t.float() == 0.5).all())


# ------------------------------------------------------ the chip's model ----

def test_jamba_at_16_layers_is_chip_smokes_model():
    """``chip_smoke.py``'s ``serve_jamba`` serves jamba-v0.1-52b at full
    width cut to 16 layers (two period-8 blocks: 2 attention + 14 mamba
    layers, 8 of them with the MoE): its constants are the reference's
    count of that config, and its launch counts the plan's."""
    chip = _chip_smoke()
    cfg = ref_get_config(ARCH).replace(n_layers=chip.JAMBA_LAYERS)
    want = RT.count_params(cfg)
    assert chip.JAMBA_LAYERS == 16
    assert chip.JAMBA_PARAMS == want == 26_053_595_136 == PT.count_params(
        get_config(ARCH).replace(n_layers=chip.JAMBA_LAYERS))
    specs = PT._layer_specs(cfg)
    assert [s.mixer for s in specs].count("attn") == 2
    assert [s.mixer for s in specs].count("mamba") == 14
    assert [s.mlp for s in specs].count("moe") == 8
    assert chip.attention_layers(cfg) == 2 and chip.mamba_layers(cfg) == 14


def _scan_gap(S=64, seed=3):
    """The reference's own scan in bf16 (its rounding of dt * u and of y)
    against the same in float32 on the same bf16 values, row by row."""
    u, dt, A, Bp, Cp = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                        for a in _scan_inputs(S, seed=seed))
    A = _scan_inputs(S, seed=seed)[2]
    y32, _ = _reference_scan(u, dt, A, Bp, Cp)
    y16, _ = _reference_scan(*(jnp.asarray(a, jnp.bfloat16) for a in (u, dt)),
                             A, *(jnp.asarray(a, jnp.bfloat16)
                                  for a in (Bp, Cp)))
    return _row_rel(np.asarray(y16, np.float32), y32)


def test_chip_bars_hold_the_references_own_gaps():
    """Each bar of ``serve_jamba``'s checks beside the reference's own gap
    at SMOKE size on the CPU: (1) the scan in bf16 against float32 on the
    same inputs (the bf16 rounding of dt * u and of y); (2) one mamba
    layer's prefill form against its decode step by step, float32; (3)
    SMOKE Jamba's (4, 1) forward against decode step 0 in bf16, a fraction
    of the logits' scale. Each bar is at least twice the reference's
    gap."""
    chip = _chip_smoke()
    scan = _scan_gap()
    assert 0 < scan and 2 * scan <= chip.JAMBA_SCAN_ROW_REL, scan
    rcfg, _ = _cfgs()
    p = _mamba_params(rcfg, 2)
    x = jnp.asarray(RNG.normal(size=(4, 16, rcfg.d_model)), jnp.float32)
    pre, _ = ref_ssm.mamba_apply(p, x, rcfg)
    Din = rcfg.mamba_expand * rcfg.d_model
    cache = {"conv": jnp.zeros((4, rcfg.mamba_d_conv - 1, Din)),
             "ssm": jnp.zeros((4, Din, rcfg.mamba_d_state))}
    steps = []
    for t in range(16):
        o, cache = ref_ssm.mamba_apply(p, x[:, t:t + 1], rcfg, cache=cache)
        steps.append(o)
    layer = _row_rel(np.concatenate(steps, 1), pre)
    assert 2 * layer <= chip.JAMBA_LAYER_REL_F32, layer
    params = ref_init_params(RT.model_params_def(rcfg), jax.random.PRNGKey(0),
                             jnp.bfloat16)
    tokens = ref_concrete_batch(rcfg, 4, 1, seed=1)["tokens"]
    fwd, _ = RT.forward(params, {"tokens": tokens}, rcfg)
    dec, _ = RT.decode_step(params, RT.init_cache(rcfg, 4, 4, jnp.bfloat16),
                            {"tokens": tokens,
                             "step": jnp.asarray(0, jnp.int32)}, rcfg)
    dec = np.asarray(dec, np.float32)
    pos0 = float(np.abs(np.asarray(fwd, np.float32) - dec).max()
                 / np.abs(dec).max())
    assert 2 * pos0 <= chip.JAMBA_POS0_REL, pos0
    print({"scan_bf16_row_rel": scan, "layer_f32_row_rel": layer,
           "pos0_bf16_rel": pos0})


def test_mamba_and_the_scan_lint_clean(tmp_path):
    """``jit_lint.SYNC_FREE`` names ``mamba_apply`` and the scan's wrapper
    (the LM zoo lies outside the lint's default scope, so they are linted
    here by path): both are clean, and so are the wrapper and the CUDA
    source under ``kernel_lint``'s four rules; a host read put into
    ``mamba_apply`` is caught."""
    from repro_torch.analysis import jit_lint, kernel_lint
    src = Path(__file__).resolve().parents[1] / "src"
    model = src / "repro_torch" / "models" / "ssm.py"
    wrapper = src / "repro_torch" / "kernels" / "selective_scan.py"
    source = src / "repro_torch" / "kernels" / "csrc" / "selective_scan.cu"
    assert ("repro_torch/models/ssm.py", "mamba_apply") in jit_lint.SYNC_FREE
    assert ("repro_torch/kernels/selective_scan.py",
            "selective_scan") in jit_lint.SYNC_FREE
    assert len(jit_lint.lint_paths([model, wrapper])) == 0
    assert len(kernel_lint.lint_paths([wrapper, source])) == 0
    bad = tmp_path / "repro_torch" / "models" / "ssm.py"
    bad.parent.mkdir(parents=True)
    text = model.read_text()
    line = '    y = y + xc * params["D"]\n'
    assert text.count(line) == 1
    bad.write_text(text.replace(line, line + "    float(y.max())\n"))
    rpt = jit_lint.lint_paths([bad])
    assert "host-sync-cast" in rpt.render() and "mamba_apply" in rpt.render()
