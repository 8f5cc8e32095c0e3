"""The port's chunked recurrences (Mamba2 SSD in ``repro_torch.models.ssm``,
RWKV6 WKV in ``repro_torch.models.rwkv``) against the reference's and
against their sequential oracles.

Inputs are numpy draws from seeded generators, as in the reference's
``tests/test_recurrences.py``, and every comparison uses its bound:
``assert_allclose(rtol=1e-4, atol=1e-4)`` in float32.  The whole layers
(``mamba_forward``, ``rwkv_time_mix``, ``rwkv_channel_mix``) run the smoke
configs' widths with the reference's parameters, prefill and then
decode steps through the state.
"""

import functools
import zlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import rwkv as JR, ssm as JS
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import rwkv as TR, ssm as TS

TOL = dict(rtol=1e-4, atol=1e-4)


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _close(got, want):
    np.testing.assert_allclose(
        got.detach().to(torch.float32).numpy()
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float32),
        np.asarray(want, np.float32), **TOL)


def _ssd_inputs(B, C, H, N, P, seed=0):
    rng = _rng("ssd", B, C, H, N, P, seed)
    f = np.float32
    return (rng.normal(size=(B, C, H, P)).astype(f),
            rng.normal(size=(B, C, N)).astype(f),
            rng.normal(size=(B, C, N)).astype(f),
            rng.uniform(0.01, 0.5, size=(B, C, H)).astype(f),
            -rng.uniform(0.01, 1.5, size=(B, C, H)).astype(f),
            (rng.normal(size=(B, H, N, P)) * 0.1).astype(f))


def _wkv_inputs(B, C, H, D, seed=0):
    rng = _rng("wkv", B, C, H, D, seed)
    f = np.float32
    return (rng.normal(size=(B, C, H, D)).astype(f),
            rng.normal(size=(B, C, H, D)).astype(f),
            rng.normal(size=(B, C, H, D)).astype(f),
            -rng.uniform(0.01, 2.0, size=(B, C, H, D)).astype(f),
            (rng.normal(size=(H, D)) * 0.1).astype(f),
            (rng.normal(size=(B, H, D, D)) * 0.1).astype(f))


# --------------------------------------------------------------------------
# one chunk
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 24, 3, 8, 4), (1, 16, 2, 16, 8)])
def test_ssd_chunk_matches_the_reference_and_the_sequential_oracle(shape):
    j, t = _both(*_ssd_inputs(*shape))
    y, s = TS._ssd_chunk(*t)
    jy, js = JS._ssd_chunk(*j)
    _close(y, jy)
    _close(s, js)
    sy, ss = TS.ssd_sequential(*t)
    jsy, jss = JS.ssd_sequential(*j)
    _close(sy, jsy)
    _close(ss, jss)
    _close(y, sy)
    _close(s, ss)


def test_ssd_chunk_with_a_bfloat16_score_buffer_matches_the_reference():
    j, t = _both(*_ssd_inputs(2, 24, 3, 8, 4, seed=1))
    y, s = TS._ssd_chunk(*t, score_dtype=torch.bfloat16)
    jy, js = JS._ssd_chunk(*j, score_dtype=jnp.bfloat16)
    assert y.dtype == torch.float32
    _close(y, jy)
    _close(s, js)


@pytest.mark.parametrize("shape", [(2, 16, 3, 8), (1, 12, 2, 16)])
def test_wkv_chunk_matches_the_reference_and_the_sequential_oracle(shape):
    j, t = _both(*_wkv_inputs(*shape))
    y, s = TR._wkv_chunk(*t)
    jy, js = JR._wkv_chunk(*j)
    _close(y, jy)
    _close(s, js)
    sy, ss = TR.wkv_sequential(*t)
    jsy, jss = JR.wkv_sequential(*j)
    _close(sy, jsy)
    _close(ss, jss)
    _close(y, sy)
    _close(s, ss)


# --------------------------------------------------------------------------
# chunking invariance
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_wkv_scan_is_invariant_to_the_chunk_length(chunk):
    """Chunks of 4, 8 or 16 (the state carried across) == one chunk of
    16 == the sequential oracle."""
    _, (r, k, v, lw, u, s0) = _both(*_wkv_inputs(1, 16, 2, 8, seed=2))
    lw = lw * 0.5
    y_full, s_full = TR._wkv_chunk(r, k, v, lw, u, s0)
    y, s = TR._wkv_scan(r, k, v, lw, u, s0, chunk)
    _close(y, y_full)
    _close(s, s_full)
    y_seq, s_seq = TR.wkv_sequential(r, k, v, lw, u, s0)
    _close(y, y_seq)
    _close(s, s_seq)


@pytest.mark.parametrize("chunk", [4, 8, 24, 7])
def test_ssd_scan_is_invariant_to_the_chunk_length(chunk):
    """Chunks of 4, 8 or 24 == the sequential oracle; 7 does not divide
    24, so the scan takes one chunk over the whole sequence, as the
    reference's ``S % C != 0`` branch does."""
    _, (xh, Bm, Cm, dt, la, s0) = _both(*_ssd_inputs(2, 24, 3, 8, 4,
                                                     seed=3))
    y, s = TS._ssd_scan(xh, Bm, Cm, dt, la, s0, chunk, torch.float32)
    y_seq, s_seq = TS.ssd_sequential(xh, Bm, Cm, dt, la, s0)
    _close(y, y_seq)
    _close(s, s_seq)


# --------------------------------------------------------------------------
# whole layers with the reference's parameters
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _layer_params(kind):
    if kind == "mamba":
        cfg = jget_config("zamba2-2.7b", smoke=True)
        p = JS.mamba_params(cfg, jax.random.PRNGKey(7))
    elif kind == "time_mix":
        cfg = jget_config("rwkv6-3b", smoke=True)
        p = JR.rwkv_time_mix_params(cfg, jax.random.PRNGKey(8))
    else:
        cfg = jget_config("rwkv6-3b", smoke=True)
        p = JR.rwkv_channel_mix_params(cfg, jax.random.PRNGKey(9))
    return jax.tree.map(np.asarray, p)


def _state(kind, cfg, B):
    if kind == "mamba":
        nh = cfg.n_ssm_heads
        return {"ssm": np.zeros((B, nh, cfg.ssm_state, cfg.d_inner // nh),
                                np.float32),
                "conv": np.zeros((B, cfg.conv_width - 1,
                                  cfg.d_inner + 2 * cfg.ssm_state),
                                 np.float32)}
    d = cfg.d_model
    if kind == "time_mix":
        Dh = d // cfg.num_heads
        return {"wkv": np.zeros((B, cfg.num_heads, Dh, Dh), np.float32),
                "shift": np.zeros((B, d), np.float32)}
    return {"shift": np.zeros((B, d), np.float32)}


LAYERS = {"mamba": ("zamba2-2.7b", JS.mamba_forward, TS.mamba_forward),
          "time_mix": ("rwkv6-3b", JR.rwkv_time_mix, TR.rwkv_time_mix),
          "channel_mix": ("rwkv6-3b", JR.rwkv_channel_mix,
                          TR.rwkv_channel_mix)}


@pytest.mark.parametrize("S", [24, 20])
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_layer_prefill_then_decode_matches_the_reference(kind, S):
    """Prefill of S tokens (24: chunks of 8; 20: one chunk over all of
    it) with a zero state, then four decode steps through the state, in
    float32: outputs and states within the reference's bound."""
    arch, jfn, tfn = LAYERS[kind]
    jcfg = jget_config(arch, smoke=True).with_overrides(dtype="float32")
    tcfg = tget_config(arch, smoke=True).with_overrides(dtype="float32")
    jp = jax.tree.map(jnp.asarray, _layer_params(kind))
    tp = convert.lm_params_from_numpy(_layer_params(kind))
    B, steps = 2, 4
    x = _rng("layer", kind, S).normal(
        size=(B, S + steps, jcfg.d_model)).astype(np.float32)
    st = _state(kind, jcfg, B)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    jy, jst = jfn(jcfg, jp, jnp.asarray(x[:, :S]), jst)
    ty, tst = tfn(tcfg, tp, torch.from_numpy(x[:, :S]), tst)
    _close(ty, jy)
    for i in range(S, S + steps):
        jy, jst = jfn(jcfg, jp, jnp.asarray(x[:, i:i + 1]), jst)
        ty, tst = tfn(tcfg, tp, torch.from_numpy(x[:, i:i + 1]), tst)
        _close(ty, jy)
    assert sorted(tst) == sorted(jst)
    for name in tst:
        _close(tst[name], jst[name])
    # without a state the prefill returns none and the same output
    ty0, none = tfn(tcfg, tp, torch.from_numpy(x[:, :S]), None)
    assert none is None
    jy0, _ = jfn(jcfg, jp, jnp.asarray(x[:, :S]), None)
    _close(ty0, jy0)


def test_causal_conv_carries_its_state_as_the_reference():
    rng = _rng("conv")
    x = rng.normal(size=(2, 9, 5)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    st = rng.normal(size=(2, 3, 5)).astype(np.float32)
    (jx, jw, jb, jst), (tx, tw, tb, tst) = _both(x, w, b, st)
    for state in ((None, None), (jst, tst)):
        jy, jnew = JS._causal_conv(jx, jw, jb, state[0])
        ty, tnew = TS._causal_conv(tx, tw, tb, state[1])
        _close(ty, jy)
        if state[0] is None:
            assert tnew is None and jnew is None
        else:
            _close(tnew, jnew)


def test_decays_and_token_shift_match_the_reference():
    """The clamped log-decays (LOG_DECAY_MIN) and the token shift that
    seeds position 0 from the previous step."""
    cfg = jget_config("rwkv6-3b", smoke=True)
    p = dict(_layer_params("time_mix"))
    rng = _rng("decays")
    xw = (rng.normal(size=(2, 6, cfg.d_model)) * 30).astype(np.float32)
    p["w0"] = rng.normal(size=cfg.d_model).astype(np.float32) * 4
    got = TR._decays(convert.lm_params_from_numpy(p), torch.from_numpy(xw))
    want = JR._decays(jax.tree.map(jnp.asarray, p), jnp.asarray(xw))
    _close(got, want)
    assert float(got.min()) >= TR.LOG_DECAY_MIN == JR.LOG_DECAY_MIN
    assert float(got.max()) <= -1e-4
    last = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
    for seed in (None, last):
        jl = None if seed is None else jnp.asarray(seed)
        tl = None if seed is None else torch.from_numpy(seed)
        _close(TR._token_shift(torch.from_numpy(xw), tl),
               JR._token_shift(jnp.asarray(xw), jl))
