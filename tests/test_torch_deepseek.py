"""DeepSeek's layers in the port against the JAX reference, on the CPU, at
SMOKE size in float32: multi-head latent attention (MLA: its prefill over
materialised per-head k and v, its absorbed decode against the latent
cache) and the sort-based MoE (the routers, the dispatch and its dropped
slots, the combine, the aux loss). The same numpy inputs and weights go
through ``repro.models`` and ``repro_torch.models``.

Tolerances: layer outputs f32 atol 1e-5 a unit of their scale (``_close``:
under the reference's init MLA's outputs reach ~10 at SMOKE size, and the
two frameworks' products round apart in the last bits; measured gaps are
2-3e-6 of the scale); the routers' expert indices, the sorted
slot order, the kept / dropped slots and their buffer rows equal; the
combine bitwise the reference's ``.at[tok].add`` on the same expert
outputs; the aux loss atol 1e-6. The whole models (``pair`` in
``test_torch_lm.py``) cover forward, prefill, decode and greedy tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import moe as ref_moe
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import route
from repro_torch.models import attention, moe

RNG = np.random.default_rng(28)


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(defs, seed):
    """The reference's init of ``defs`` (f32), as numpy and as tensors."""
    p = jax.tree.map(np.asarray, ref_init_params(
        defs, jax.random.PRNGKey(seed), jnp.float32))
    return p, jax.tree.map(_t, p)


def _close(got, want):
    """f32 atol 1e-5 x max(1, max |want|)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def _cfg(arch="deepseek-v2-236b", **kw):
    return ref_get_config(arch, smoke=True).replace(**kw), \
        get_config(arch, smoke=True).replace(**kw)


# ------------------------------------------------------- flash at 192/128 ----

@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_at_192_128_matches_reference_sdpa(causal):
    """The plain version (what the wrapper runs on CPU tensors) with q and
    k at head dim 192 and v at 128, MLA's prefill pair: the scale is
    1/sqrt(192), the output 128 wide; against the reference's ``sdpa``
    (which reshapes by v's head dim), f32 atol 1e-5."""
    q, k = (RNG.normal(size=(2, 40, 3, 192)).astype(np.float32)
            for _ in range(2))
    v = RNG.normal(size=(2, 40, 3, 128)).astype(np.float32)
    got = ops.flash_attention(*(_t(a).transpose(1, 2) for a in (q, k, v)),
                              causal=causal).transpose(1, 2)
    want = ref_attn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal)
    assert got.shape == (2, 40, 3, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype,D,Dv,want", [
    (torch.bfloat16, 192, 128, "wgmma"), (torch.float32, 192, 128, "fma"),
    (torch.bfloat16, 24, 16, None), (torch.float32, 24, 16, None),
    (torch.bfloat16, 128, 192, None), (torch.bfloat16, 192, 192, None),
    (torch.float16, 128, 128, None)])
def test_flash_route_of_a_pair(dtype, D, Dv, want):
    """The routes built for (q/k head dim, v head dim): MLA's (192, 128) on
    wgmma (bf16) and FMA (f32); SMOKE's (24, 16) and any other unequal pair
    on none, so ``sdpa`` keeps them on the einsum form."""
    assert route(dtype, D, Dv) == want


# -------------------------------------------------------------------- MLA ----

def _mla_case(q_lora: bool, seed: int):
    rcfg, pcfg = _cfg(**({} if q_lora else {"q_lora_rank": None}))
    p_np, p_t = _params(ref_attn.mla_def(rcfg), seed)
    return rcfg, pcfg, p_np, p_t


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "w_q"])
def test_mla_prefill_matches_reference(q_lora):
    """MLA's prefill (per-head k_nope and v from the latent, the rope key
    broadcast across heads, ``sdpa`` at (24, 16)), with the q projection
    through the low-rank q (v2 and v3) or direct; ``_close``."""
    rcfg, pcfg, p_np, p_t = _mla_case(q_lora, 1)
    assert ("w_uq" in p_np) == q_lora
    x = RNG.normal(size=(2, 20, rcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20)[None], (2, 20))
    want, _ = ref_attn.mla_apply(p_np, jnp.asarray(x), jnp.asarray(pos),
                                 rcfg)
    got, cache = attention.mla_apply(p_t, _t(x), _t(pos), pcfg)
    assert cache is None and got.shape == (2, 20, rcfg.d_model)
    _close(got.numpy(), want)


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "w_q"])
def test_mla_absorbed_decode_matches_reference(q_lora):
    """Six one-token steps of the absorbed decode: each step's output and
    the latent and rope-key caches (written in place at ``step``) against
    the reference's, ``_close``."""
    rcfg, pcfg, p_np, p_t = _mla_case(q_lora, 2)
    B, Smax = 2, 8
    x = RNG.normal(size=(B, 6, rcfg.d_model)).astype(np.float32)
    ref_cache = jax.tree.map(jnp.asarray, {
        "c": np.zeros((B, Smax, rcfg.kv_lora_rank), np.float32),
        "kr": np.zeros((B, Smax, rcfg.qk_rope_dim), np.float32)})
    cache = {k: torch.zeros(v.shape) for k, v in ref_cache.items()}
    for t in range(6):
        pos = np.full((B, 1), t)
        want, ref_cache = ref_attn.mla_apply(
            p_np, jnp.asarray(x[:, t:t + 1]), jnp.asarray(pos), rcfg,
            cache=ref_cache, step=t)
        got, cache = attention.mla_apply(p_t, _t(x[:, t:t + 1]), _t(pos),
                                         pcfg, cache=cache, step=t)
        _close(got.numpy(), want)
        for key in ("c", "kr"):
            _close(cache[key].numpy(), ref_cache[key])
    with pytest.raises(ValueError, match="outside"):
        attention.mla_apply(p_t, _t(x[:, :1]), _t(pos), pcfg, cache=cache,
                            step=Smax)


def test_mla_absorbed_decode_is_its_prefill():
    """The port alone: token-by-token absorbed decode through the latent
    cache reproduces the prefill form's outputs (w_uk and w_uv folded in
    the other order), ``_close``."""
    _, pcfg, _, p_t = _mla_case(True, 3)
    x = _t(RNG.normal(size=(2, 7, pcfg.d_model)).astype(np.float32))
    pos = torch.arange(7)[None].expand(2, 7)
    full, _ = attention.mla_apply(p_t, x, pos, pcfg)
    cache = {"c": torch.zeros(2, 7, pcfg.kv_lora_rank),
             "kr": torch.zeros(2, 7, pcfg.qk_rope_dim)}
    steps = [attention.mla_apply(p_t, x[:, t:t + 1], pos[:, t:t + 1], pcfg,
                                 cache=cache, step=t)[0] for t in range(7)]
    _close(torch.cat(steps, 1).numpy(), full.numpy())


# -------------------------------------------------------------------- MoE ----

@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"],
                         ids=["softmax", "sigmoid"])
def test_route_matches_reference(arch):
    """The softmax (v2) and sigmoid (v3) routers on 64 tokens: the same
    expert indices in the same order, weights and float32 logits within
    1e-6."""
    rcfg, pcfg = _cfg(arch)
    assert pcfg.router_kind == ("sigmoid" if "v3" in arch else "softmax")
    p_np, p_t = _params(ref_moe.experts_def(rcfg), 4)
    x2 = RNG.normal(size=(64, rcfg.d_model)).astype(np.float32)
    w_ref, e_ref, l_ref = ref_moe._route(p_np, jnp.asarray(x2), rcfg)
    w, e, logits = moe._route(p_t, _t(x2), pcfg)
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_ref))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=1e-6)
    np.testing.assert_allclose(logits.numpy(), np.asarray(l_ref), atol=1e-6)
    assert w.dtype == logits.dtype == torch.float32


def _ref_slots(e, E, k, cap):
    """The reference's dispatch (``_moe_scatter``'s lines) on ``e``:
    (order, sorted experts, tokens, buffer rows, kept)."""
    N = e.shape[0]
    e_flat = jnp.asarray(e).reshape(-1)
    order = jnp.argsort(e_flat)
    sorted_e = e_flat[order]
    start = jnp.searchsorted(sorted_e, jnp.arange(E))
    pos = jnp.arange(N * k) - start[sorted_e]
    keep = pos < cap
    return order, sorted_e, order // k, jnp.where(keep, pos, cap), keep


@pytest.mark.parametrize("arch,cf", [
    ("deepseek-v2-236b", 1.25), ("deepseek-v2-236b", 0.3),
    ("deepseek-v3-671b", 1.25), ("deepseek-v3-671b", 0.3)],
    ids=["v2", "v2_drops", "v3", "v3_drops"])
def test_moe_scatter_matches_reference(arch, cf):
    """``_moe_scatter`` on (2, 24) tokens: the slot order, each slot's
    buffer row and which slots drop equal the reference's (a capacity
    factor of 0.3 drops many: cap = int(0.3 * 48 * 2 / 8 + 1) = 4 of the
    12 an even spread needs), the output within ``_close`` and the aux
    loss within 1e-6."""
    rcfg, pcfg = _cfg(arch, capacity_factor=cf)
    p_np, p_t = _params(ref_moe.experts_def(rcfg), 5)
    x = RNG.normal(size=(2, 24, rcfg.d_model)).astype(np.float32)
    want, want_aux = ref_moe._moe_scatter(p_np, jnp.asarray(x), rcfg)
    got, aux = moe.moe_apply(p_t, _t(x), pcfg, act=pcfg.act)
    _close(got.numpy(), want)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6)
    # the slots: from the same expert indices, both dispatches agree
    N, k, E = 48, rcfg.top_k, rcfg.n_experts
    cap = moe.capacity(pcfg, N)
    assert cap == int(cf * N * k / E + 1)
    _, e, _ = moe._route(p_t, _t(x.reshape(N, -1)), pcfg)
    mine = moe._dispatch(e, E, cap)
    for a, b in zip(mine, _ref_slots(e.numpy(), E, k, cap), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if cf < 1:
        assert int((~mine[4]).sum()) >= N * k - E * cap


def test_aux_loss_matches_reference():
    rcfg, pcfg = _cfg()
    logits = RNG.normal(size=(40, rcfg.n_experts)).astype(np.float32) * 3
    e = np.argsort(-logits, 1)[:, :rcfg.top_k]
    want = ref_moe._aux_loss(jnp.asarray(logits), jnp.asarray(e), rcfg)
    got = moe._aux_loss(_t(logits), _t(e), pcfg)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


@pytest.mark.parametrize("N,k,E", [(37, 2, 8), (64, 6, 16), (50, 8, 12)])
def test_combine_is_the_references_scatter_add(N, k, E):
    """The combine sums each token's k contributions in its slots' sorted
    order from zero: bitwise the reference's ``.at[tok].add`` (eager and
    jitted) on the same expert outputs, values spread over six decades so
    that another order rounds otherwise (the top-k order does here, at
    k > 2)."""
    logits = RNG.normal(size=(N, E))
    e = np.argsort(-logits, 1)[:, :k]
    w = RNG.random((N, k)).astype(np.float32)
    cap = int(1.25 * N * k / E + 1) // 2        # some slots drop
    out = (RNG.normal(size=(E, cap + 1, 8))
           * 10.0 ** RNG.integers(-3, 3, size=(E, cap + 1, 8))
           ).astype(np.float32)
    order, se, tok, pos_c, keep = moe._dispatch(_t(e), E, cap)
    got = moe._combine(_t(out), _t(w), order, se, pos_c, keep).numpy()

    def ref(e, w, out):
        order, sorted_e, tok_, pos_c_, keep_ = _ref_slots(e, E, k, cap)
        contrib = out[sorted_e, pos_c_] * jnp.where(
            keep_, w.reshape(-1)[order], 0.0)[:, None]
        return jnp.zeros((N, out.shape[-1]), out.dtype).at[tok_].add(contrib)
    want = ref(e, jnp.asarray(w), jnp.asarray(out))
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, np.asarray(jax.jit(
        lambda w, o: ref(e, w, o))(jnp.asarray(w), jnp.asarray(out))))
    # the top-k order (each token's slots as the router ranked them)
    contrib = out[se.numpy(), pos_c.numpy()] * np.where(
        keep.numpy(), w.reshape(-1)[order.numpy()], 0)[:, None]
    rank = np.empty(N * k, np.int64)
    rank[order.numpy()] = np.arange(N * k)
    by_topk = np.zeros((N, 8), np.float32)
    for j in range(k):
        by_topk = by_topk + contrib[rank.reshape(N, k)[:, j]]
    # from zero, two terms sum the same either way; more may not
    assert np.array_equal(by_topk, got) == (k == 2)
