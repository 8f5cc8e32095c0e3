"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``).

The same router and expert weights (the reference's ``moe_params``,
carried as numpy) and numpy inputs go through both.  Routing indices and
the dispatch's slot / token tables are integers and must be equal; the
reference's tables are recomputed here with its own jnp expressions
(``moe.py:69-110``), which it does not expose.  Outputs: max abs <= 1e-5
in float32 (the experts' three products sum in another order) and
<= 2e-2 times the largest |y| in bfloat16 (the dense family's bf16
bound), at capacity factor 8 (nothing dropped) and 0.5 (drops, which must
be the same tokens).
"""

import dataclasses
import functools
import zlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import moe as JM, transformer as JT
from repro.models import layers as JL
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import moe as TM, transformer as TT
from repro_torch.models import layers as TL

ARCHS = ["mixtral-8x7b", "arctic-480b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _cfgs(arch, capacity_factor=None, **kw):
    j, t = (get(arch, smoke=True).with_overrides(**kw)
            for get in (jget_config, tget_config))
    if capacity_factor is not None:
        j = j.with_overrides(moe=dataclasses.replace(
            j.moe, capacity_factor=capacity_factor))
        t = t.with_overrides(moe=dataclasses.replace(
            t.moe, capacity_factor=capacity_factor))
    return j, t


@functools.lru_cache(maxsize=None)
def _params(arch):
    cfg = jget_config(arch, smoke=True)
    return jax.tree.map(np.asarray, JM.moe_params(cfg, jax.random.PRNGKey(3)))


def _inputs(arch, dtype, B=3, S=24):
    cfg = jget_config(arch, smoke=True)
    x = _rng("x", arch, B, S).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    return (jnp.asarray(x, jd), torch.from_numpy(x).to(td),
            _params(arch), convert.lm_params_from_numpy(_params(arch)))


def _reference_tables(cfg, p, x):
    """The reference's routing and slot tables, by its own expressions."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, K = B * S, m.num_experts, m.top_k
    C = JM.capacity(cfg, T)
    xf = x.reshape(T, d)
    logits = xf.astype(jnp.float32) @ jnp.asarray(p["router"], jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, K)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    flat_e = top_e.reshape(T * K)
    flat_t = jnp.repeat(jnp.arange(T, dtype=jnp.int32), K)
    flat_w = top_p.reshape(T * K).astype(x.dtype)
    order = jnp.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = jnp.zeros((E,), jnp.int32).at[flat_e].add(1)
    offsets = jnp.cumsum(counts) - counts
    pos_in_e = jnp.arange(T * K, dtype=jnp.int32) - offsets[se]
    keep = pos_in_e < C
    slot = jnp.where(keep, se * C + pos_in_e, E * C)
    tok = jnp.full((E * C + 1,), T, jnp.int32).at[slot].set(
        jnp.where(keep, st, T))[:E * C]
    w = jnp.zeros((E * C + 1,), x.dtype).at[slot].set(
        jnp.where(keep, sw, 0))[:E * C]
    return (np.asarray(probs), np.asarray(top_p), np.asarray(top_e),
            np.asarray(tok), np.asarray(w, np.float32), int((~keep).sum()))


def _f(t):
    return t.detach().to(torch.float32).numpy() if isinstance(
        t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_slot_tables_equal_the_reference(arch, cf, dtype):
    jcfg, tcfg = _cfgs(arch, cf)
    jx, tx, jp, tp = _inputs(arch, dtype)
    probs, top_p, top_e, tok, w, dropped = _reference_tables(jcfg, jp, jx)
    T = tx.shape[0] * tx.shape[1]
    tprobs, ttop_p, ttop_e = TM.route(tcfg, tp, tx.reshape(T, -1))
    np.testing.assert_array_equal(ttop_e.numpy(), top_e)
    np.testing.assert_allclose(tprobs.numpy(), probs, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ttop_p.numpy(), top_p, rtol=1e-6, atol=1e-7)
    C = TM.capacity(tcfg, T)
    assert C == JM.capacity(jcfg, T)
    ttok, tw, tdropped = TM.dispatch(tcfg, ttop_p, ttop_e, C, tx.dtype)
    np.testing.assert_array_equal(ttok.numpy(), tok)
    np.testing.assert_allclose(_f(tw), w, rtol=1e-6, atol=0)
    assert int(tdropped) == dropped
    assert (dropped > 0) == (cf < 1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_the_reference(arch, cf, dtype):
    jcfg, tcfg = _cfgs(arch, cf)
    jx, tx, jp, tp = _inputs(arch, dtype)
    want, want_aux = JM.moe_forward(jcfg, jax.tree.map(jnp.asarray, jp), jx)
    got, aux = TM.moe_forward(tcfg, tp, tx)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    want = np.asarray(want, np.float32)
    bound = TOL[dtype] * (1.0 if dtype == "float32"
                          else float(np.abs(want).max()))
    assert float(np.abs(_f(got) - want).max()) <= bound
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_fallback_matches_the_reference_and_the_sparse_path(arch,
                                                                  dtype):
    """The oracle against the reference's oracle, and the sparse path at
    a capacity that drops nothing against the port's oracle."""
    jcfg, tcfg = _cfgs(arch, 8.0)
    jx, tx, jp, tp = _inputs(arch, dtype)
    want, _ = JM.moe_forward_dense_fallback(
        jcfg, jax.tree.map(jnp.asarray, jp), jx)
    dense, zero = TM.moe_forward_dense_fallback(tcfg, tp, tx)
    assert float(zero) == 0.0
    want = np.asarray(want, np.float32)
    bound = TOL[dtype] * (1.0 if dtype == "float32"
                          else float(np.abs(want).max()))
    assert float(np.abs(_f(dense) - want).max()) <= bound
    sparse, _ = TM.moe_forward(tcfg, tp, tx)
    assert float((_f(sparse) - _f(dense)).__abs__().max()) <= bound


def test_top_k_ties_resolve_to_the_lower_expert_as_in_the_reference():
    """A zero router makes every expert's probability equal: both packages
    pick experts 0 and 1 for every token, and route the same drops."""
    jcfg, tcfg = _cfgs("arctic-480b", 0.5)
    jx, tx, jp, tp = _inputs("arctic-480b", "float32")
    jp = dict(jp, router=np.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    _, _, top_e, tok, _, _ = _reference_tables(jcfg, jp, jx)
    T = tx.shape[0] * tx.shape[1]
    _, ttop_p, ttop_e = TM.route(tcfg, tp, tx.reshape(T, -1))
    assert (ttop_e.numpy() == [0, 1]).all() and (top_e == [0, 1]).all()
    ttok, _, _ = TM.dispatch(tcfg, ttop_p, ttop_e, TM.capacity(tcfg, T),
                             tx.dtype)
    np.testing.assert_array_equal(ttok.numpy(), tok)


def test_aux_loss_matches_the_reference_under_skewed_routing():
    """The switch-style load-balancing loss, on tokens that share a
    direction the router favours a few experts along (so the loss is far
    from ``router_aux_weight``, its value under uniform routing)."""
    jcfg, tcfg = _cfgs("arctic-480b")
    rng = _rng("skew")
    x = (rng.normal(size=(3, 24, jcfg.d_model))
         + 3.0 * rng.normal(size=jcfg.d_model)).astype(np.float32)
    router = rng.normal(size=(jcfg.d_model, jcfg.moe.num_experts)).astype(
        np.float32)
    jp = dict(jax.tree.map(jnp.asarray, _params("arctic-480b")),
              router=jnp.asarray(router))
    tp = dict(convert.lm_params_from_numpy(_params("arctic-480b")),
              router=torch.from_numpy(router))
    _, want = JM.moe_forward(jcfg, jp, jnp.asarray(x))
    _, got = TM.moe_forward(tcfg, tp, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(got) > 2.0 * tcfg.moe.router_aux_weight


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_arctic_block_adds_the_dense_residual_mlp(dtype):
    """A whole ``moe:full`` block of arctic (attention, MoE and the dense
    residual MLP beside it) against the reference's ``block_forward``;
    without the residual MLP's term the output would differ."""
    jcfg, tcfg = _cfgs("arctic-480b", dtype=dtype)
    assert tcfg.moe.dense_residual
    jp = jax.tree.map(np.asarray, JT.block_params(
        jcfg, "moe:full", jax.random.PRNGKey(5)))
    tp = convert.lm_params_from_numpy(jp)
    x = _rng("block", dtype).normal(size=(2, 16, jcfg.d_model)).astype(
        np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want, _, _ = jax.jit(lambda p, x: JT.block_forward(
        jcfg, "moe:full", p, x, JL.rope_freqs(jcfg), None))(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(x, jd))
    tx = torch.from_numpy(x).to(td)
    got, _ = TT.block_forward(tcfg, "moe:full", tp, tx,
                              TL.rope_freqs(tcfg), None)
    want = np.asarray(want, np.float32)
    bound = (1e-4 if dtype == "float32"
             else 2e-2 * float(np.abs(want).max()))
    assert float(np.abs(_f(got) - want).max()) <= bound
    h = TL.apply_norm(tcfg, tp["ln2"], tx + TL.attn_forward(
        tcfg, tp["attn"], TL.apply_norm(tcfg, tp["ln1"], tx),
        TL.rope_freqs(tcfg), window=None)[0])
    mlp = _f(TL.mlp_forward(tcfg, tp["mlp"], h))
    assert float(np.abs(mlp).max()) > 10 * bound
