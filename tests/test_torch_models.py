"""The port's LM stack (dense family) against the reference's.

Inputs and parameters are made with numpy (the parameters by the
reference's ``init_params`` and carried across with
``convert.lm_params_from_numpy``), so both packages compute with the same
weights.  Layers (norms, RoPE, the four attention cores) are compared
one by one; the whole model per dense smoke config through ``prefill``
and six ``decode_step``s, with ``use_flash_kernel`` off and on (the
reference's dispatch ignores the flag, so both runs are held to the same
logits): max abs <= 1e-4 in float32, and in bfloat16 max abs <= 2e-2
times the largest |logit| (bfloat16 keeps 8 significant bits, and the
two frameworks round their activations at different places; the
untied-head configs have logits near 3).  The serve loop gives the
reference loop's tokens.
"""

import functools
import zlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import layers as JL, lm as jlm
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL, lm as tlm, transformer as TT

ARCHS = ["qwen2-1.5b", "qwen1.5-0.5b", "stablelm-3b", "gemma2-27b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BATCH, PROMPT, MAX_LEN, DECODE_STEPS = 2, 32, 40, 6


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _pair(a, dtype="float32"):
    """The same numpy array as a jax array and a torch tensor."""
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a)).to(td)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match(dtype):
    rng = _rng("norms", dtype)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    scale = rng.normal(size=48).astype(np.float32)
    bias = rng.normal(size=48).astype(np.float32)
    jx, tx = _pair(x, dtype)
    got = TL.rms_norm(tx, torch.from_numpy(scale), 1e-5)
    want = JL.rms_norm(jx, jnp.asarray(scale), 1e-5)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    got = TL.layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                        1e-5)
    want = JL.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("fraction", [1.0, 0.25])
def test_rope_matches(fraction):
    cfg = jget_config("stablelm-3b", smoke=True).with_overrides(
        rope_fraction=fraction, head_dim=32)
    tcfg = tget_config("stablelm-3b", smoke=True).with_overrides(
        rope_fraction=fraction, head_dim=32)
    jf, tf = JL.rope_freqs(cfg), TL.rope_freqs(tcfg)
    np.testing.assert_allclose(_np(tf), _np(jf), rtol=1e-6)
    rng = _rng("rope", fraction)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 7))
    jx, tx = _pair(x)
    got = TL.apply_rope(tx, torch.from_numpy(pos), tf)
    want = JL.apply_rope(jx, jnp.asarray(pos), jf)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    rot = int(32 * fraction)
    np.testing.assert_array_equal(_np(got)[..., rot:], x[..., rot:])


# (core, kwargs, sq, sk)
CORES = [
    ("attn_direct", dict(causal=True, window=None, softcap=None), 24, 40),
    ("attn_direct", dict(causal=False, window=7, softcap=30.0), 20, 20),
    ("attn_rect", dict(causal=True, window=None, softcap=None, chunk=16),
     48, 64),
    ("attn_rect", dict(causal=True, window=20, softcap=50.0, chunk=16),
     64, 64),
    ("attn_tri", dict(causal=True, softcap=None, chunk=16), 32, 64),
    ("attn_tri", dict(causal=True, softcap=30.0, chunk=16), 64, 64),
    ("attn_banded", dict(window=20, softcap=None, chunk=16), 64, 64),
    ("attn_banded", dict(window=9, softcap=50.0, chunk=16), 48, 80),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CORES,
                         ids=lambda c: f"{c[0]}-{c[2]}x{c[3]}-"
                                       f"{c[1].get('softcap')}")
def test_attention_cores_match(case, dtype):
    name, kw, sq, sk = case
    rng = _rng("core", name, sq, sk, repr(kw), dtype)
    q, k, v = (rng.normal(size=(2, 3, n, 16)).astype(np.float32)
               for n in (sq, sk, sk))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    extra = dict(scale=0.25, q_offset=sk - sq)
    got = getattr(TL, name)(tq, tk, tv, **kw, **extra)
    want = getattr(JL, name)(jq, jk, jv, **kw, **extra)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("impl", ["auto", "direct", "rect", "tri", "banded"])
def test_dispatch_with_flash_equals_every_plain_path(impl):
    """``use_flash`` computes what each plain core computes."""
    rng = _rng("dispatch", impl)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 64, 16))
                                .astype(np.float32)) for _ in range(3))
    window = 20 if impl == "banded" else None
    kw = dict(causal=True, window=window, softcap=30.0, impl=impl, chunk=16)
    plain = TL.attention(q, k, v, **kw)
    flash = TL.attention(q, k, v, **kw, use_flash=True)
    np.testing.assert_allclose(flash.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# whole model: prefill + decode
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_run(arch: str, dtype: str):
    """The reference's params (numpy), prompt, and prefill + greedy
    decode logits; decode feeds the reference's own argmax tokens."""
    cfg = jget_config(arch, smoke=True).with_overrides(dtype=dtype)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tokens = _rng("prompt", arch).integers(0, cfg.vocab_size,
                                           size=(BATCH, PROMPT))
    cache = jlm.init_cache(cfg, BATCH, MAX_LEN)
    jp = jax.jit(lambda p, b, c: jlm.prefill(cfg, p, b, c))
    jd = jax.jit(lambda p, t, c: jlm.decode_step(cfg, p, t, c))
    logits, cache = jp(params, {"tokens": jnp.asarray(tokens, jnp.int32)},
                       cache)
    steps = [np.asarray(logits, np.float32)]
    fed = []
    for _ in range(DECODE_STEPS):
        cur = jnp.argmax(logits, -1)
        fed.append(np.asarray(cur))
        logits, cache = jd(params, cur, cache)
        steps.append(np.asarray(logits, np.float32))
    return (jax.tree.map(np.asarray, params), tokens, fed, steps)


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch, dtype, flash):
    params_np, tokens, fed, want = _reference_run(arch, dtype)
    cfg = tget_config(arch, smoke=True).with_overrides(
        dtype=dtype, use_flash_kernel=flash)
    params = convert.lm_params_from_numpy(params_np, "cpu")
    cache = tlm.init_cache(cfg, BATCH, MAX_LEN, "cpu")
    logits, cache = tlm.prefill(cfg, params,
                                {"tokens": torch.from_numpy(tokens)}, cache)
    got = [_np(logits)]
    for cur in fed:
        logits, cache = tlm.decode_step(cfg, params,
                                        torch.from_numpy(cur.copy()), cache)
        got.append(_np(logits))
    assert cache["pos"] == PROMPT + DECODE_STEPS
    for step, (g, w) in enumerate(zip(got, want)):
        err = float(np.abs(g - w).max())
        bound = TOL[dtype] * (1.0 if dtype == "float32"
                              else float(np.abs(w).max()))
        assert err <= bound, f"step {step}: max abs {err} > {bound}"


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_flash_prefill_reads_the_kv_heads_in_place(flash, monkeypatch):
    """With the flash kernel a GQA prefill hands it k / v with the model's
    KV heads and makes no broadcast copy; the plain paths broadcast them."""
    cfg = tget_config("qwen2-1.5b", smoke=True).with_overrides(
        dtype="float32", use_flash_kernel=flash)
    assert cfg.q_per_kv > 1
    copies, kv_heads = [], []
    real_copy, real_flash = TL._broadcast_kv, TL.ops.flash_attention

    def copy(k, group):
        copies.append(group)
        return real_copy(k, group)

    def flash_call(q, k, v, **kw):
        kv_heads.append(k.shape[1])
        return real_flash(q, k, v, **kw)

    monkeypatch.setattr(TL, "_broadcast_kv", copy)
    monkeypatch.setattr(TL.ops, "flash_attention", flash_call)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = tlm.init_cache(cfg, BATCH, MAX_LEN, "cpu")
    tokens = torch.from_numpy(_rng("in place").integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT)))
    logits, _ = tlm.prefill(cfg, params, {"tokens": tokens}, cache)
    assert bool(torch.isfinite(logits).all())
    if flash:
        assert copies == []
        assert kv_heads == [cfg.num_kv_heads] * cfg.num_layers
    else:
        assert copies == [cfg.q_per_kv] * (2 * cfg.num_layers)
        assert kv_heads == []


def test_params_layout_and_counts_match_the_reference():
    for arch in ARCHS:
        jcfg, tcfg = jget_config(arch, smoke=True), tget_config(arch,
                                                                smoke=True)
        gen = torch.Generator().manual_seed(0)
        ours = convert.lm_params_to_numpy(tlm.init_params(tcfg, gen, "cpu"))
        theirs = jax.eval_shape(lambda k: jlm.init_params(jcfg, k),
                                jax.random.PRNGKey(0))
        assert jax.tree_util.tree_structure(ours) == \
            jax.tree_util.tree_structure(theirs)
        for a, b in zip(jax.tree_util.tree_leaves(ours),
                        jax.tree_util.tree_leaves(theirs)):
            assert a.shape == b.shape and a.dtype == b.dtype
        assert tlm.count_params(tcfg) == jlm.count_params(jcfg)
        full_t, full_j = tget_config(arch), jget_config(arch)
        assert tlm.count_params(full_t) == jlm.count_params(full_j)
        from repro.models.config import num_params as jnum
        from repro_torch.models.config import num_params as tnum
        assert tnum(full_t) == jnum(full_j)
    p = tlm.init_params(tget_config("qwen2-1.5b", smoke=True),
                        torch.Generator().manual_seed(0), "cpu")
    back = convert.lm_params_from_numpy(convert.lm_params_to_numpy(p))
    for a, b in zip(jax.tree_util.tree_leaves(p),
                    jax.tree_util.tree_leaves(back)):
        assert torch.equal(a, b)


def test_unknown_archs_families_and_kinds_raise():
    """As in the reference: an arch, a family or a block kind it does not
    know is a ``ValueError``; so is a cache for the encoder's blocks,
    which have none."""
    with pytest.raises(ValueError, match="unknown arch"):
        tget_config("whisper-large")
    cfg = tget_config("qwen2-1.5b", smoke=True)
    with pytest.raises(ValueError, match="unknown family"):
        TT.group_layout(cfg.with_overrides(family="diffusion"))
    for kind in ("gru", "cross_attn"):
        with pytest.raises(ValueError, match="unknown block kind"):
            TT.block_params(cfg, kind, None, "cpu")
        with pytest.raises(ValueError, match="unknown block kind"):
            TT.block_forward(cfg, kind, {}, torch.zeros(1, 2, cfg.d_model),
                             TL.rope_freqs(cfg), None)
    for kind in ("enc_attn", "cross_attn"):
        with pytest.raises(ValueError, match="no cache"):
            TT.init_block_cache(cfg, kind, 1, 8, torch.float32, "cpu")


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _reference_serve(cfg, params, reqs, batch_slots, max_len):
    """The loop of the reference's ``launch/serve.py::main`` on the
    reference's jitted prefill / decode_step."""
    jit_decode = jax.jit(lambda p, t, c: jlm.decode_step(cfg, p, t, c))
    jit_prefill = jax.jit(lambda p, b, c: jlm.prefill(cfg, p, b, c))
    B = batch_slots
    while reqs:
        active, reqs = reqs[:B], reqs[B:]
        plen = tserve._pow2_at_least(max(len(r.prompt) for r in active))
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(active):
            toks[i, plen - len(r.prompt):] = r.prompt
        cache = jlm.init_cache(cfg, B, max_len)
        logits, cache = jit_prefill(params, {"tokens": jnp.asarray(toks)},
                                    cache)
        cur = jnp.argmax(logits, -1)
        for r, t in zip(active, np.asarray(cur)):
            r.out.append(int(t))
        for _ in range(active[0].max_new - 1):
            logits, cache = jit_decode(params, cur, cache)
            cur = jnp.argmax(logits, -1)
            for i, r in enumerate(active):
                if len(r.out) < r.max_new:
                    r.out.append(int(np.asarray(cur)[i]))


def test_serve_requests_gives_the_reference_loops_tokens():
    jcfg = jget_config("qwen2-1.5b", smoke=True).with_overrides(
        dtype="float32")
    tcfg = tget_config("qwen2-1.5b", smoke=True).with_overrides(
        dtype="float32", use_flash_kernel=True)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    theirs = tserve.cli_requests(tcfg, 6, 5)
    ours = tserve.cli_requests(tcfg, 6, 5)
    assert [len(r.prompt) for r in ours] == [len(r.prompt) for r in theirs]
    _reference_serve(jcfg, params, theirs, batch_slots=4, max_len=64)
    stats = {}
    done = tserve.serve_requests(
        tcfg, convert.lm_params_from_numpy(jax.tree.map(np.asarray, params)),
        ours, batch_slots=4, max_len=64, device="cpu", stats=stats)
    assert [r.rid for r in done] == list(range(6))
    assert [r.out for r in done] == [r.out for r in theirs]
    assert all(len(r.out) == 5 for r in done)
    assert stats["prefill_len"] == [16, 16] and len(stats["decode_s"]) == 8


def test_serve_entry_point_needs_a_card_unless_told_otherwise(monkeypatch,
                                                              capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tget_config("qwen2-1.5b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve_requests(cfg, {}, tserve.cli_requests(cfg, 1, 2),
                              batch_slots=1, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "qwen2-1.5b", "--smoke"])
    tserve.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                 "--num-requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.startswith("served 3 requests, 9 tokens")
