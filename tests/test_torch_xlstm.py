"""xLSTM (mLSTM and sLSTM blocks) in the port against the JAX reference, on
the CPU, at SMOKE size (4 layers, d_model 64, 2 heads: mLSTM's head dim
64) unless a test says otherwise: the two mixers' prefill and decode, the
port's prefill form against its decode form, the whole model's forward
and decode through ``convert``, the kernels' plain versions
(``ref.slstm_scan_ref``, ``ref.mlstm_parallel_ref``) against the
reference's lines, the config and its count, ``chip_smoke.py``'s
``serve_xlstm`` constants and bars beside the reference's own gaps, and
the lint of the new bodies. The same numpy inputs and weights go through
``repro.models`` and ``repro_torch.models``.

Tolerances, a unit of the output's scale (``_close``): float32 within
2e-5, mLSTM's within 1e-4: the sums run in other orders (h @ rz, the (S,
S) products, the cumsum of logf), and mLSTM's den (a sum of terms of both
signs) amplifies them: at S = 64 the reference's own float32 output sits
up to 5.3e-5 of the scale from the same form in float64 (seeds 0-7), the
port's 3.1e-5 from the reference's. bf16 within 0.02: the two frameworks
round bf16 elementwise chains at other places (XLA-CPU runs some in
float32), measured at 0.004-0.006.
"""
import importlib.util
import math
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.inputs import concrete_batch as ref_concrete_batch
from repro.models import transformer as RT
from repro.models import xlstm as ref_xlstm
from repro.models.params import ParamDef as RefParamDef
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.convert import (cache_from_reference,
                                  model_params_from_reference)
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as PT
from repro_torch.models import xlstm

RNG = np.random.default_rng(30)
ARCH = "xlstm-125m"
#: mixer -> (its reference apply, its port apply, their param and cache defs)
MIXERS = {
    "mlstm": (ref_xlstm.mlstm_apply, xlstm.mlstm_apply, ref_xlstm.mlstm_def,
              ref_xlstm.mlstm_cache_def),
    "slstm": (ref_xlstm.slstm_apply, xlstm.slstm_apply, ref_xlstm.slstm_def,
              ref_xlstm.slstm_cache_def)}
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.02)}
#: mLSTM's float32 bar (see the module docstring)
MLSTM_F32_REL = 1e-4


def _rel(mixer, dtype):
    """The bar of ``mixer``'s outputs in ``dtype``."""
    rel = DTYPES[dtype][2]
    return MLSTM_F32_REL if mixer == "mlstm" and dtype == "float32" else rel


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=2e-5):
    """atol ``rel`` x max(1, max |want|)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=rel * max(1.0, np.abs(want).max()))


def _rows(got, want):
    """Each row's max |got - want| / max |want| (a row: the last axis)."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    err = np.abs(got - want).max(-1)
    return (err / np.maximum(np.abs(want).max(-1), 1e-30)).ravel()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    return chip


def _cfgs(smoke=True):
    return ref_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)


def _params(mixer, cfg, seed=0, dtype="float32"):
    """The reference's init of one layer of ``mixer`` (float32, cast to
    ``dtype``): (jax tree, torch tree)."""
    jdt, tdt, _ = DTYPES[dtype]
    p = jax.tree.map(np.asarray, ref_init_params(
        MIXERS[mixer][2](cfg), jax.random.PRNGKey(seed), jnp.float32))
    pj = {k: jnp.asarray(v, jdt) for k, v in p.items()}
    return pj, {k: _t(np.asarray(v, np.float32)).to(tdt)
                for k, v in pj.items()}


def _zeros(defs, dtype, xp):
    """A zeroed cache of ``defs`` (the reference's ParamDefs), in ``dtype``
    but for the leaves that name their own; jax (xp=jnp) or torch."""
    def leaf(d):
        if xp is jnp:
            return jnp.zeros(d.shape, d.dtype or dtype)
        return torch.zeros(d.shape, dtype=getattr(torch, d.dtype)
                           if d.dtype else dtype)
    return {k: leaf(d) for k, d in defs.items()}


# ------------------------------------------------------------- configs ----

def test_config_and_count_are_the_references():
    """``get_config("xlstm-125m")`` serves the reference's config (full and
    SMOKE), and the port's parameter count is the reference's: 123,656,496
    at full width (no layer cut), 230,856 at SMOKE size."""
    for smoke, count in ((False, 123_656_496), (True, 230_856)):
        rcfg, cfg = _cfgs(smoke)
        assert cfg.name == ARCH and cfg.block_kinds == ("mlstm", "slstm")
        assert cfg.tie_embeddings and cfg.d_ff == 0
        assert PT.count_params(cfg) == RT.count_params(rcfg) == count
    specs = PT._layer_specs(get_config(ARCH))
    assert [s.mixer for s in specs] == ["mlstm", "slstm"] * 6
    assert {s.mlp for s in specs} == {"none"}


def test_a_mixer_only_block_has_no_mlp():
    """``mlp="none"``: the layer's tree has ``ln1`` and ``mixer`` alone, as
    the reference's ``_layer_def``, and the block is ``x + mixer(ln1(x))``
    (the mixer's cache back, no aux loss)."""
    _, cfg = _cfgs()
    model = PT.init_model(cfg, seed=1, dtype=torch.float32, device="cpu")
    block = model.layers[0]
    assert not hasattr(block, "ln2") and not hasattr(block, "mlp")
    assert sorted(PT.model_params_def(cfg)["layers"][1]) == ["ln1",
                                                             "mixer"]
    x = torch.randn(2, 5, cfg.d_model)
    y, cache, aux = block(x, None)
    mix, _ = block.mixer(block.ln1(x), None)
    assert cache is None and aux is None and torch.equal(y, x + mix)


def test_slstm_module_builds_its_gate_weight_once():
    """The ``SLSTM`` mixer holds wz, wi, wf, wo as the column blocks of
    one (D, 4 D) buffer ``w4`` (built once, not a parameter of its own):
    its parameters and state dict are the reference's tree, their count
    unchanged, and its output is ``slstm_apply``'s on the same weights as
    a plain dict."""
    _, cfg = _cfgs()
    D = cfg.d_model
    params = PT.init_params(PT.model_params_def(cfg),
                            torch.Generator().manual_seed(3), torch.float32,
                            torch.device("cpu"))
    tree = {k: v.clone() for k, v in params["layers"][1]["mixer"].items()}
    model = PT.Transformer(cfg, params)
    mixer = model.layers[1].mixer
    assert isinstance(mixer, PT.SLSTM)
    assert tuple(mixer.w4.shape) == (D, 4 * D)
    for i, k in enumerate(xlstm.SLSTM_GATES):
        assert mixer[k].data_ptr() == mixer.w4[:, i * D:].data_ptr()
        assert torch.equal(mixer[k], tree[k])
    assert sorted(dict(mixer.named_parameters())) == sorted(tree)
    assert sorted(mixer.state_dict()) == sorted(tree)
    assert sum(p.numel() for p in model.parameters()) == 230_856
    x = torch.randn((2, 5, D), generator=torch.Generator().manual_seed(4))
    got, _ = mixer(x)
    want, _ = xlstm.slstm_apply(tree, x, cfg)
    assert torch.equal(got, want)


@pytest.mark.parametrize("write", ["load_state_dict", "in_place"])
def test_slstm_gate_weight_follows_its_parameters_after_to(write):
    """After ``.to(torch.float64)`` the gate parameters are new tensors;
    a gate then written (through ``load_state_dict`` or in place) reaches
    the mixer's GEMM: its output equals ``slstm_apply`` over its
    parameters with ``w4=None`` (built from them), and two calls with no
    write between them read one prebuilt weight."""
    _, cfg = _cfgs()
    D = cfg.d_model
    params = PT.init_params(PT.model_params_def(cfg),
                            torch.Generator().manual_seed(5), torch.float32,
                            torch.device("cpu"))
    mixer = PT.Transformer(cfg, params).layers[1].mixer.to(torch.float64)
    x = torch.randn((2, 5, D), generator=torch.Generator().manual_seed(6),
                    dtype=torch.float64)
    mixer(x)
    new_wi = torch.randn((D, D), generator=torch.Generator().manual_seed(7),
                         dtype=torch.float64)
    if write == "load_state_dict":
        mixer.load_state_dict({**mixer.state_dict(), "wi": new_wi})
    else:
        with torch.no_grad():
            mixer.wi.copy_(new_wi)
    assert torch.equal(mixer.wi, new_wi)
    tree = dict(mixer.named_parameters())
    got, _ = mixer(x)
    want, _ = xlstm.slstm_apply(tree, x, cfg, w4=None)
    assert got.dtype == torch.float64 and torch.equal(got, want)
    assert torch.equal(mixer.w4[:, D:2 * D], new_wi)
    assert mixer.w4 is mixer.w4


# -------------------------------------------------------- the mixers -------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 5, 64])
@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_prefill_matches_reference(mixer, S, dtype):
    """The mixer's prefill (its projections, then the (S, S) form or the
    recurrence through ``ops``' plain versions) against the reference's,
    the same weights and input: float32 within 2e-5 of the scale (mLSTM
    1e-4), bf16 within 0.02; no state is returned, as the reference
    returns none."""
    rcfg, cfg = _cfgs()
    jdt, tdt, _ = DTYPES[dtype]
    rel = _rel(mixer, dtype)
    pj, pt = _params(mixer, rcfg, seed=S, dtype=dtype)
    x = jnp.asarray(RNG.normal(size=(2, S, cfg.d_model)), jdt)
    want, want_cache = MIXERS[mixer][0](pj, x, rcfg)
    got, cache = MIXERS[mixer][1](pt, _t(np.asarray(x, np.float32)).to(tdt),
                                  cfg)
    assert cache is None and want_cache is None
    assert got.dtype == tdt and got.shape == (2, S, cfg.d_model)
    _close(got.float().numpy(), want, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_decode_matches_reference(mixer, dtype):
    """Five decode steps from a nonzero cache, advanced in place: each
    step's output and every leaf of the cache (mLSTM's C, n, m; sLSTM's c,
    n, h, m) against the reference's ``new_cache``; the states float32 in
    either dtype, sLSTM's h in the cache's."""
    rcfg, cfg = _cfgs()
    jdt, tdt, _ = DTYPES[dtype]
    rel = _rel(mixer, dtype)
    pj, pt = _params(mixer, rcfg, seed=7, dtype=dtype)
    defs = MIXERS[mixer][3](rcfg, 2)
    rcache, cache = {}, {}
    for key, d in defs.items():
        a = RNG.normal(size=d.shape).astype(np.float32)
        if key == "n" and mixer == "slstm":
            a = np.abs(a) + 1.0
        rcache[key] = jnp.asarray(a, d.dtype or jdt)
        cache[key] = _t(np.asarray(rcache[key], np.float32)).to(
            getattr(torch, d.dtype) if d.dtype else tdt)
    leaves = dict(cache)
    for _ in range(5):
        x = jnp.asarray(RNG.normal(size=(2, 1, cfg.d_model)), jdt)
        want, rcache = MIXERS[mixer][0](pj, x, rcfg, cache=rcache)
        got, cache = MIXERS[mixer][1](
            pt, _t(np.asarray(x, np.float32)).to(tdt), cfg, cache=cache)
        assert all(cache[k] is leaves[k] for k in leaves)
        assert got.dtype == tdt
        _close(got.float().numpy(), want, rel)
        for key, d in defs.items():
            assert cache[key].dtype == (torch.float32 if d.dtype else tdt)
            _close(cache[key].float().numpy(), rcache[key], rel)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_prefill_form_matches_decode_form(mixer):
    """The port alone, float32: 16 tokens of 4 requests through the prefill
    form (one launch over them) and through decode step by step from a
    zeroed cache agree within 1e-4 row by row (the reference's own gap at
    SMOKE size: up to 2.1e-5 for mLSTM, 3.2e-7 for sLSTM)."""
    rcfg, cfg = _cfgs()
    _, pt = _params(mixer, rcfg, seed=11)
    x = torch.randn(4, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(11))
    pre, _ = MIXERS[mixer][1](pt, x, cfg)
    cache = _zeros(MIXERS[mixer][3](rcfg, 4), torch.float32, torch)
    dec = torch.cat([MIXERS[mixer][1](pt, x[:, t:t + 1], cfg, cache=cache)[0]
                     for t in range(16)], 1)
    assert _rows(dec, pre).max() <= 1e-4


# -------------------------------------------------- the plain versions -----

def _jax_parallel(q, k, v, logi, logf):
    """The reference's prefill branch (``src/repro/models/xlstm.py:53-66``)
    from its q, k, v and gates, line for line."""
    S, dh = q.shape[1], q.shape[-1]
    scale = 1.0 / jnp.sqrt(dh)
    F = jnp.cumsum(logf, axis=1)
    Dm = F[:, :, None, :] - F[:, None, :, :] + logi[:, None, :, :]
    causal = jnp.tril(jnp.ones((S, S), bool))
    Dm = jnp.where(causal[None, :, :, None], Dm, -jnp.inf)
    m = jnp.max(Dm, axis=2, keepdims=True)
    w = jnp.exp(Dm - m)
    scores = jnp.einsum("bshk,bthk->bsth", q, k) * scale
    sw = scores.astype(jnp.float32) * w
    num = jnp.einsum("bsth,bthk->bshk", sw.astype(q.dtype), v)
    den = jnp.maximum(jnp.abs(jnp.sum(sw, axis=2)), jnp.exp(-m[:, :, 0, :]))
    return num / den[..., None].astype(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_parallel_plain_is_the_reference_form(dtype):
    """``mlstm_parallel_ref`` against the reference's lines on the same q,
    k, v, logi and logf (S = 70, 2 heads, dh 64): float32 within 2e-5 of
    the scale, bf16 within 0.02 (the scale rounded to bf16, 0.125 at dh =
    64, as the reference's weakly typed float32 meets bf16 scores); a
    range of query rows is those rows of the whole form."""
    jdt, tdt, rel = DTYPES[dtype]
    q, k, v = (jnp.asarray(RNG.normal(size=(2, 70, 2, 64)), jdt)
               for _ in range(3))
    logi = jnp.asarray(0.1 * RNG.normal(size=(2, 70, 2)), jnp.float32)
    logf = jax.nn.log_sigmoid(jnp.asarray(
        1.0 + 0.1 * RNG.normal(size=(2, 70, 2)), jnp.float32))
    want = _jax_parallel(q, k, v, logi, logf)
    args = [_t(np.asarray(a, np.float32)).to(tdt) for a in (q, k, v)] + [
        _t(np.asarray(a)) for a in (logi, logf)]
    got = ref.mlstm_parallel_ref(*args)
    assert got.dtype == tdt
    _close(got.float().numpy(), want, rel)
    rows = ref.mlstm_parallel_ref(*args, rows=(40, 70))
    np.testing.assert_allclose(rows.float().numpy(),
                               got[:, 40:].float().numpy(), rtol=0,
                               atol=1e-6 * float(got.float().abs().max()))
    assert ops.mlstm_parallel(*args).equal(got)


def test_mlstm_scale_is_the_references():
    """1/sqrt(dh) as the reference's prefill applies it: rounded to bf16
    (0.05102539 at dh = 384; the bf16 product of the score and that scale
    is the reference's bit for bit), float32 as it is."""
    assert ref.mlstm_scale(384, torch.bfloat16) == 0.051025390625
    assert ref.mlstm_scale(384, torch.float32) == float(
        np.float32(1.0) / np.sqrt(np.float32(384)))
    x = jnp.asarray(RNG.normal(size=1000) * 30, jnp.bfloat16)
    want = np.asarray(x * (1.0 / jnp.sqrt(384)), np.float32)
    got = (_t(np.asarray(x, np.float32)).to(torch.bfloat16)
           * ref.mlstm_scale(384, torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_slstm_step_plain_is_the_reference_step():
    """``slstm_step_ref`` against the reference's ``_slstm_step`` with the
    four input weights the identity (so each gate's input is x itself),
    float32, from a nonzero carry, 12 steps under ``lax.scan``: hs and the
    final carry within 2e-5 of their scale; through the wrapper, the carry
    written into ``carry_out`` (the same tensors as ``carry``: decode's
    in-place form) on the CPU too."""
    D = 64
    eye = jnp.eye(D, dtype=jnp.float32)
    rz = jnp.asarray(0.02 * RNG.normal(size=(D, D)), jnp.float32)
    bf = jnp.ones((D,), jnp.float32)
    params = {"wz": eye, "wi": eye, "wf": eye, "wo": eye, "rz": rz,
              "bf": bf}
    xs = jnp.asarray(RNG.normal(size=(12, 3, D)), jnp.float32)
    carry = (jnp.asarray(RNG.normal(size=(3, D)), jnp.float32),
             jnp.asarray(np.abs(RNG.normal(size=(3, D))) + 1, jnp.float32),
             jnp.asarray(RNG.normal(size=(3, D)), jnp.float32),
             jnp.asarray(0.1 * RNG.normal(size=(3, D)), jnp.float32))
    last, hs = jax.lax.scan(
        lambda c, x: ref_xlstm._slstm_step(params, c, x), carry, xs)
    g = _t(np.asarray(xs)).transpose(0, 1)
    state = tuple(_t(np.asarray(a)) for a in carry)
    got = ops.slstm_scan(g, g, g, g, _t(np.asarray(rz)), _t(np.asarray(bf)),
                         state, state)
    _close(got.numpy(), np.asarray(hs).transpose(1, 0, 2))
    for a, b in zip(state, last, strict=True):
        _close(a.numpy(), b)


def test_xla_contracts_the_slstm_state_updates():
    """The reference's ``fp * c + ip * z`` is one FMA on XLA-CPU
    (``fma(fp, c, ip * z)``, the rounding ``slstm.cu`` and the plain
    version's ``addcmul`` write), not two rounded products and a sum."""
    fp, c, ip, z = (RNG.normal(size=20000).astype(np.float32)
                    for _ in range(4))
    got = np.asarray(jax.jit(lambda a, b, e, f: a * b + e * f)(fp, c, ip, z))
    fma = (fp.astype(np.float64) * c + (ip * z)).astype(np.float32)
    sep = (fp * c) + (ip * z)
    assert np.array_equal(got, fma) and not np.array_equal(got, sep)
    plain = torch.addcmul(_t(ip * z), _t(fp), _t(c)).numpy()
    assert np.array_equal(plain, fma)


# ----------------------------------------------------------- the model -----

@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port model from those params) at
    SMOKE size in float32."""
    rcfg, cfg = _cfgs()
    params = ref_init_params(RT.model_params_def(rcfg),
                             jax.random.PRNGKey(0), jnp.float32)
    model = PT.Transformer(cfg, model_params_from_reference(
        jax.tree.map(np.asarray, params), cfg, device="cpu"))
    return rcfg, params, model


def test_model_forward_and_decode_match_reference(pair):
    """The whole SMOKE model from the reference's parameters (``convert``
    walks its one scanned stage, (mlstm, slstm) x 2, layer by layer):
    ``forward``'s logits at every position, then six teacher-forced
    ``decode_step``s through the caches (``cache_from_reference``: the
    states float32), each step's logits, under the LM tests' bar (1e-4 of
    the logits' scale); the caches after them likewise."""
    rcfg, params, model = pair
    batch = ref_concrete_batch(rcfg, 2, 32)
    want, _ = RT.forward(params, batch, rcfg)
    got, _ = PT.forward(model, {"tokens": _t(batch["tokens"])})
    _close(got.numpy(), want, 1e-4)
    tokens = np.asarray(batch["tokens"])
    rcache = RT.init_cache(rcfg, 2, 8, jnp.float32)
    cache = cache_from_reference(jax.tree.map(np.asarray, rcache), rcfg,
                                 device="cpu")
    step = jax.jit(partial(RT.decode_step, cfg=rcfg))
    for t in range(6):
        want, rcache = step(params, rcache, {
            "tokens": jnp.asarray(tokens[:, t:t + 1]),
            "step": jnp.asarray(t, jnp.int32)})
        got, cache = PT.decode_step(model, cache, {
            "tokens": _t(tokens[:, t:t + 1]), "step": t})
        _close(got.numpy(), want, 1e-4)
    want_cache = cache_from_reference(jax.tree.map(np.asarray, rcache),
                                      rcfg, device="cpu")
    for a, b in zip(cache["layers"], want_cache["layers"], strict=True):
        assert a.keys() == b.keys()
        for key in a:
            _close(a[key].numpy(), b[key].numpy(), 1e-4)


def test_cache_from_reference_keeps_the_float32_states():
    """The reference's bf16 cache (mLSTM's C, n, m and sLSTM's c, n, m
    float32 by their ``ParamDef.dtype``, sLSTM's h bf16) converts to the
    port's with the same dtypes and values, in the plan's order; the
    port's ``init_cache`` gives the same tree."""
    rcfg, cfg = _cfgs()
    rc = RT.init_cache(rcfg, 2, 6, jnp.bfloat16)
    rc = jax.tree.map(lambda a: a + jnp.ones_like(a) * 0.5, rc)
    got = cache_from_reference(jax.tree.map(np.asarray, rc), cfg,
                               device="cpu", dtype=torch.bfloat16)
    want = PT.init_cache(cfg, 2, 6, torch.bfloat16, device="cpu")
    assert [sorted(layer) for layer in got["layers"]] == [
        ["C", "m", "n"], ["c", "h", "m", "n"]] * 2
    for layer, empty in zip(got["layers"], want["layers"], strict=True):
        assert sorted(layer) == sorted(empty)
        for key, t in layer.items():
            assert t.dtype == empty[key].dtype and t.shape == \
                empty[key].shape
            assert t.dtype == (torch.bfloat16 if key == "h"
                               else torch.float32)
            assert bool((t.float() == 0.5).all())


def test_kernels_count_nothing_on_the_cpu(pair):
    """On CPU tensors the wrappers run their plain versions and count no
    launch: a prefill and a decode step of the SMOKE model leave both
    counts where they were."""
    _, _, model = pair
    before = ops.launch_counts()
    tokens = torch.zeros((2, 3), dtype=torch.int64)
    PT.forward(model, {"tokens": tokens}, mode="prefill")
    cache = PT.init_cache(model.cfg, 2, 4, torch.float32, device="cpu")
    PT.decode_step(model, cache, {"tokens": tokens[:, :1], "step": 0})
    after = ops.launch_counts()
    assert after["mlstm_parallel"] == before["mlstm_parallel"]
    assert after["slstm_scan"] == before["slstm_scan"]


# ------------------------------------------------------ the chip's model ---

def test_chip_smokes_model_is_xlstm_125m():
    """``serve_xlstm`` serves xlstm-125m whole: its count is the
    reference's, its kernels' prefill shapes are the config's, and its
    launches a prefill and a decode step are the plan's (6 mLSTM, 6
    sLSTM)."""
    chip = _chip_smoke()
    rcfg, cfg = _cfgs(False)
    assert chip.XLSTM_PARAMS == RT.count_params(rcfg) == 123_656_496
    dh = 2 * cfg.d_model // cfg.n_heads
    assert chip.MLSTM_PREFILL == (chip.XLSTM_PREFILL_B,
                                  chip.XLSTM_PREFILL_S, cfg.n_heads, dh)
    assert chip.SLSTM_PREFILL == (chip.XLSTM_PREFILL_B,
                                  chip.XLSTM_PREFILL_S, cfg.d_model)
    assert chip.lm_launches(cfg) == {
        "flash_attention": (0, 0), "selective_scan": (0, 0),
        "mlstm_parallel": (6, 0), "slstm_scan": (6, 6)}


def _kernel_inputs(cfg, seed, S=256):
    """The bf16 inputs of both kernels in one layer of each mixer under
    the reference's init, at S tokens of one request: caught from the
    port's prefill on the CPU."""
    rcfg = ref_get_config(ARCH, smoke=cfg.d_model == 64)
    caught = {}
    kernels = {name: getattr(ops, name) for name in ("mlstm_parallel",
                                                     "slstm_scan")}

    def catch(name):
        def run(*args, **kw):
            caught[name] = args
            return kernels[name](*args, **kw)
        return run
    x = torch.randn((1, S, cfg.d_model), generator=torch.Generator()
                    .manual_seed(seed)).to(torch.bfloat16)
    try:
        for name, mixer in (("mlstm_parallel", "mlstm"),
                            ("slstm_scan", "slstm")):
            setattr(ops, name, catch(name))
            _, pt = _params(mixer, rcfg, seed, "bfloat16")
            MIXERS[mixer][1](pt, x, cfg)
    finally:
        for name, kernel in kernels.items():
            setattr(ops, name, kernel)
    return caught


def _seeded_mlstm_inputs(B, S, H, dh, seed):
    """bf16 mlstm_parallel inputs drawn as ``chip_smoke._mlstm_inputs``
    draws them on the card (q, k, v ~ N(0, 1); logi ~ N(0, 0.1^2); logf =
    log_sigmoid(1 + N(0, 0.1^2))), here from a CPU generator."""
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen)
    q, k, v = (draw(B, S, H, dh).to(torch.bfloat16) for _ in range(3))
    return q, k, v, 0.1 * draw(B, S, H), ref.log_sigmoid_ref(
        1.0 + 0.1 * draw(B, S, H))


def test_chip_bars_hold_the_plain_versions_own_gaps():
    """``serve_xlstm``'s bars for the kernels in bf16, beside the plain
    versions' own bf16-against-f32 gaps on the same bf16 inputs (the
    model's, at SMOKE size, seeds 0-2): the sLSTM scan's largest row
    (SLSTM_ROW_REL at least twice it) and mLSTM's median row
    (MLSTM_MEDIAN_ROW_REL at least twice it). mLSTM's largest row on the
    model's inputs, where the den cancels, lies beyond MLSTM_ROW_REL (so
    there each row is held to the plain version's own on that row); on
    the seeded inputs of the kernel checks, at both head dims, twice it
    lies within MLSTM_ROW_REL."""
    chip = _chip_smoke()
    _, cfg = _cfgs()
    for seed in range(3):
        caught = _kernel_inputs(cfg, seed)
        q, k, v, li, lf = caught["mlstm_parallel"]
        h32 = ref.mlstm_parallel_ref(q.float(), k.float(), v.float(), li, lf)
        rows = _rows(ref.mlstm_parallel_ref(q, k, v, li, lf).float(), h32)
        assert 2 * np.median(rows) <= chip.MLSTM_MEDIAN_ROW_REL, rows
        assert rows.max() > chip.MLSTM_ROW_REL, rows.max()
        for H, dh in ((2, 64), (4, 384)):
            q, k, v, li, lf = _seeded_mlstm_inputs(1, 256, H, dh, seed)
            h32 = ref.mlstm_parallel_ref(q.float(), k.float(), v.float(), li,
                                         lf)
            own = _rows(ref.mlstm_parallel_ref(q, k, v, li, lf).float(), h32)
            assert 2 * own.max() <= chip.MLSTM_ROW_REL, (dh, own.max())
        args = caught["slstm_scan"]
        hs32, _ = ref.slstm_scan_ref(*(t.float() for t in args))
        hs16, _ = ref.slstm_scan_ref(*args)
        gap = _rows(hs16.float(), hs32).max()
        assert 0 < gap and 2 * gap <= chip.SLSTM_ROW_REL, gap


def _faults(h):
    """Faults of a (B, S, H, dh) mlstm_parallel output on a subset of its
    rows: rows 8-15 of every 16 (a warp's second half of its m16 tile)
    taking the row 8 before's output or 5% off (a den off), the first
    head taking the second's, and one 64-row tile taking the row before's
    output."""
    S = h.shape[1]
    rb = torch.arange(S) % 16 >= 8
    out = {}
    out["half_rows_wrong_row"] = h.clone()
    out["half_rows_wrong_row"][:, rb] = h[:, torch.arange(S)[rb] - 8]
    out["half_rows_den"] = h.clone()
    out["half_rows_den"][:, rb] = (h[:, rb].float() * 1.05).to(h.dtype)
    out["one_head"] = h.clone()
    out["one_head"][:, :, 0] = h[:, :, 1]
    out["one_tile"] = h.clone()
    out["one_tile"][:, 64:128] = h[:, 63:127]
    return out


def test_chip_mlstm_bars_catch_a_fault_on_a_subset_of_rows():
    """``serve_xlstm``'s mLSTM check (``_mlstm_ok`` on ``_bf16_errors``)
    passes the bf16 plain version itself and fails each fault of
    ``_faults`` on a part of the rows: on the model's inputs at SMOKE
    size (where the den cancels in some rows, and only the row-by-row bar
    holds) and on the kernel checks' seeded inputs at full head dim (with
    MLSTM_ROW_REL), seeds 0-1."""
    chip = _chip_smoke()
    _, cfg = _cfgs()
    for seed in range(2):
        for model_inputs in (True, False):
            args = (_kernel_inputs(cfg, seed)["mlstm_parallel"]
                    if model_inputs else _seeded_mlstm_inputs(1, 256, 4,
                                                              384, seed))
            q, k, v, li, lf = args
            want = ref.mlstm_parallel_ref(q.float(), k.float(), v.float(),
                                          li, lf)
            plain = ref.mlstm_parallel_ref(*args)
            bar = math.inf if model_inputs else chip.MLSTM_ROW_REL

            def ok(got):
                return chip._mlstm_ok(chip._bf16_errors(got, want, plain),
                                      bar)
            assert ok(plain)
            for name, bad in _faults(plain).items():
                assert not ok(bad), (seed, model_inputs, name)


def test_chip_layer_and_position_bars_hold_the_references_own_gaps():
    """``serve_xlstm``'s float32 bars beside the reference's own gaps at
    full width (seed 0, 4 requests): one mLSTM and one sLSTM layer's
    prefill form against its decode step by step over 16 tokens
    (XLSTM_LAYER_REL_F32 by mixer, at least twice the gap), and the whole
    model's (4, 1) forward against decode step 0 (XLSTM_POS0_REL_F32, at
    least twice the gap)."""
    chip = _chip_smoke()
    rcfg, _ = _cfgs(False)
    rng = np.random.default_rng(0)
    for mixer, (apply, _, defs, cache_defs) in MIXERS.items():
        p = ref_init_params(defs(rcfg), jax.random.PRNGKey(0), jnp.float32)
        x = jnp.asarray(rng.normal(size=(4, 16, rcfg.d_model)), jnp.float32)
        pre, _ = apply(p, x, rcfg)
        cache = _zeros(cache_defs(rcfg, 4), jnp.float32, jnp)
        steps = []
        for t in range(16):
            o, cache = apply(p, x[:, t:t + 1], rcfg, cache=cache)
            steps.append(o)
        gap = _rows(np.concatenate(steps, 1), pre).max()
        assert 2 * gap <= chip.XLSTM_LAYER_REL_F32[mixer], (mixer, gap)
    params = ref_init_params(RT.model_params_def(rcfg),
                             jax.random.PRNGKey(0), jnp.float32)
    tokens = ref_concrete_batch(rcfg, 4, 1, seed=1)["tokens"]
    fwd, _ = RT.forward(params, {"tokens": tokens}, rcfg)
    dec, _ = RT.decode_step(params, RT.init_cache(rcfg, 4, 1, jnp.float32),
                            {"tokens": tokens,
                             "step": jnp.asarray(0, jnp.int32)}, rcfg)
    dec = np.asarray(dec)
    pos0 = float(np.abs(np.asarray(fwd) - dec).max() / np.abs(dec).max())
    assert 0 < pos0 and 2 * pos0 <= chip.XLSTM_POS0_REL_F32, pos0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chip_bf16_position_bar_holds_the_references_own_gap(seed):
    """``serve_xlstm``'s bf16 bar on the (4, 1) forward against decode step
    0 (XLSTM_POS0_REL, max |diff| over the logits' largest magnitude) is
    at least twice the reference's own gap at full width in bf16 (its
    float32 init cast to bf16, 4 requests)."""
    chip = _chip_smoke()
    rcfg, _ = _cfgs(False)
    params = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16),
        ref_init_params(RT.model_params_def(rcfg), jax.random.PRNGKey(seed),
                        jnp.float32))
    tokens = ref_concrete_batch(rcfg, 4, 1, seed=1 + seed)["tokens"]
    fwd, _ = RT.forward(params, {"tokens": tokens}, rcfg)
    dec, _ = RT.decode_step(params, RT.init_cache(rcfg, 4, 1, jnp.bfloat16),
                            {"tokens": tokens,
                             "step": jnp.asarray(0, jnp.int32)}, rcfg)
    fwd, dec = (np.asarray(a, np.float32) for a in (fwd, dec))
    pos0 = float(np.abs(fwd - dec).max() / np.abs(dec).max())
    assert 0 < pos0 and 2 * pos0 <= chip.XLSTM_POS0_REL, pos0


# ------------------------------------------------------------ the lint -----

def test_xlstm_and_its_kernels_lint_clean(tmp_path):
    """``jit_lint.SYNC_FREE`` names ``mlstm_apply``, ``slstm_apply`` and the
    two kernels' wrappers (the LM zoo lies outside the lint's default
    scope, so the model is linted here by path): all are clean, and so are
    the wrappers and the CUDA sources under ``kernel_lint``'s rules; a
    host read put into ``slstm_apply`` is caught."""
    from repro_torch.analysis import jit_lint, kernel_lint
    src = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    model = src / "models" / "xlstm.py"
    wrappers = [src / "kernels" / "mlstm.py", src / "kernels" / "slstm.py"]
    sources = [src / "kernels" / "csrc" / "mlstm.cu",
               src / "kernels" / "csrc" / "slstm.cu"]
    for body in (("repro_torch/models/xlstm.py", "mlstm_apply"),
                 ("repro_torch/models/xlstm.py", "slstm_apply"),
                 ("repro_torch/kernels/mlstm.py", "mlstm_parallel"),
                 ("repro_torch/kernels/slstm.py", "slstm_scan")):
        assert body in jit_lint.SYNC_FREE
    assert len(jit_lint.lint_paths([model, *wrappers])) == 0
    assert len(kernel_lint.lint_paths([*wrappers, *sources])) == 0
    bad = tmp_path / "repro_torch" / "models" / "xlstm.py"
    bad.parent.mkdir(parents=True)
    text = model.read_text()
    line = "    gz, gi, gf, go = (x @ w4).split(D, dim=-1)\n"
    assert text.count(line) == 1
    bad.write_text(text.replace(line, line + "    float(gz.max())\n"))
    rpt = jit_lint.lint_paths([bad])
    assert "host-sync-cast" in rpt.render() and "slstm_apply" in rpt.render()


def test_param_defs_mirror_the_references():
    """Both mixers' parameter and cache definitions are the reference's:
    shapes, axes, inits, scales and per-leaf dtypes."""
    rcfg, cfg = _cfgs(False)
    for ref_def, def_ in ((ref_xlstm.mlstm_def, xlstm.mlstm_def),
                          (ref_xlstm.slstm_def, xlstm.slstm_def)):
        assert ref_def(rcfg).keys() == def_(cfg).keys()
        for key, d in def_(cfg).items():
            assert d.__dict__ == ref_def(rcfg)[key].__dict__
    for ref_def, def_ in ((ref_xlstm.mlstm_cache_def, xlstm.mlstm_cache_def),
                          (ref_xlstm.slstm_cache_def, xlstm.slstm_cache_def)):
        for key, d in def_(cfg, 3).items():
            assert d.__dict__ == ref_def(rcfg, 3)[key].__dict__
    assert RefParamDef.__dataclass_fields__.keys() == \
        xlstm.ParamDef.__dataclass_fields__.keys()
