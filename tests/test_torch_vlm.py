"""The port's VLM family (internvl2-1b) against the reference's.

Parameters are made by the reference's ``init_params`` and carried
across with ``convert.lm_params_from_numpy``; prompts and the stub patch
embeddings (N(0, 1) x 0.02, as ``tests/test_models.py::_batch`` draws
them) come from numpy generators.  The patches go ahead of the prompt,
so a prefill fills ``num_patches + S`` cache positions.  ``prefill``
plus six ``decode_step``s and the uncached ``forward`` trunk are held to
the reference's with ``use_flash_kernel`` off and on, within
``tests/test_torch_families.py``'s tolerances: max abs <= 1e-4 in
float32; in bfloat16 the port's distance from the reference's float32
output at most 1.2 times the reference's own bfloat16 distance from it
plus 2e-2 of the largest |value|.  Cached decode agrees with the
uncached forward (the reference's ``test_smoke_decode_consistency``),
the serve loop gives the reference loop's tokens on the reference CLI's
zero patches, and a prefill sends each layer through the flash wrapper
once with its 2 KV heads un-broadcast (decode steps none).
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
from repro.models import lm as jlm
from repro.models.config import num_params as jnum
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL, lm as tlm
from repro_torch.models.config import num_params as tnum

ARCH = "internvl2-1b"
PARAMS_PUBLISHED = 493_780_992        # the reference's count_params
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BF16_NOISE = 1.2
BATCH, PROMPT, MAX_LEN, DECODE_STEPS = 2, 32, 40, 6
FLASH_CASES = [(dtype, flash) for dtype in ("float32", "bfloat16")
               for flash in (False, True)]
FLASH_IDS = [f"{d}-{'flash' if f else 'plain'}" for d, f in FLASH_CASES]


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _jcfg(dtype="float32"):
    return jget_config(ARCH, smoke=True).with_overrides(dtype=dtype)


def _tcfg(dtype="float32", flash=False):
    return tget_config(ARCH, smoke=True).with_overrides(
        dtype=dtype, use_flash_kernel=flash)


def _cache_len(cfg, max_len=MAX_LEN):
    return max_len + cfg.num_patches


@functools.lru_cache(maxsize=None)
def _reference_params():
    return jax.tree.map(np.asarray,
                        jlm.init_params(_jcfg(), jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _inputs(seq=PROMPT):
    cfg = _jcfg()
    rng = _rng("inputs", ARCH, seq)
    tokens = rng.integers(0, cfg.vocab_size, size=(BATCH, seq))
    patches = (rng.normal(size=(BATCH, cfg.num_patches, cfg.d_model))
               * 0.02).astype(np.float32)
    return tokens, patches


def _jbatch(tokens, patches):
    return {"tokens": jnp.asarray(tokens, jnp.int32),
            "patches": jnp.asarray(patches)}


def _tbatch(tokens, patches):
    return {"tokens": torch.from_numpy(np.asarray(tokens)),
            "patches": torch.from_numpy(patches)}


def _check(got, want, exact, dtype, what):
    """float32: max abs <= 1e-4; bfloat16: the port no farther from the
    reference's float32 result ``exact`` than BF16_NOISE times the
    reference's bfloat16 result ``want``, plus 2e-2 of its largest
    |value|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if dtype == "float32":
        err = float(np.abs(got - want).max())
        assert err <= TOL[dtype], f"{what}: max abs {err}"
        return
    exact = _np(exact)
    top = float(np.abs(want).max())
    ours = float(np.abs(got - exact).max())
    theirs = float(np.abs(want - exact).max())
    assert ours <= BF16_NOISE * theirs + TOL[dtype] * top, \
        f"{what}: {ours} from the float32 result (the reference's: {theirs})"


# --------------------------------------------------------------------------
# the reference's runs
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_fns(dtype):
    cfg = _jcfg(dtype)
    return (cfg, jax.jit(lambda p, b, c: jlm.prefill(cfg, p, b, c)),
            jax.jit(lambda p, t, c: jlm.decode_step(cfg, p, t, c)))


def _reference_logits(dtype, fed):
    """The reference's prefill + decode logits, decode fed ``fed`` (or,
    with ``fed`` None, its own argmax tokens); returns (fed, logits)."""
    cfg, jp, jd = _reference_fns(dtype)
    params = _reference_params()
    cache = jlm.init_cache(cfg, BATCH, _cache_len(cfg))
    logits, cache = jp(params, _jbatch(*_inputs()), cache)
    steps, own = [np.asarray(logits, np.float32)], []
    for i in range(DECODE_STEPS):
        cur = jnp.argmax(logits, -1) if fed is None else jnp.asarray(fed[i])
        own.append(np.asarray(cur))
        logits, cache = jd(params, cur, cache)
        steps.append(np.asarray(logits, np.float32))
    return own, steps


@functools.lru_cache(maxsize=None)
def _reference_run(dtype):
    """(fed decode tokens, logits, float32 logits on the same tokens)."""
    fed, want = _reference_logits(dtype, None)
    exact = want if dtype == "float32" else _reference_logits("float32",
                                                              fed)[1]
    return fed, want, exact


@functools.lru_cache(maxsize=None)
def _reference_hidden(dtype):
    cfg = _jcfg(dtype)
    h, _, _ = jax.jit(lambda p, b: jlm.forward(cfg, p, b))(
        _reference_params(), _jbatch(*_inputs()))
    return np.asarray(h, np.float32)


# --------------------------------------------------------------------------
# stages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype, flash", FLASH_CASES, ids=FLASH_IDS)
def test_prefill_and_decode_match_the_reference(dtype, flash):
    fed, want, exact = _reference_run(dtype)
    cfg = _tcfg(dtype, flash)
    params = convert.lm_params_from_numpy(_reference_params())
    cache = tlm.init_cache(cfg, BATCH, _cache_len(cfg), "cpu")
    logits, cache = tlm.prefill(cfg, params, _tbatch(*_inputs()), cache)
    assert cache["pos"] == cfg.num_patches + PROMPT
    got = [logits]
    for cur in fed:
        logits, cache = tlm.decode_step(cfg, params,
                                        torch.from_numpy(cur.copy()), cache)
        got.append(logits)
    assert cache["pos"] == cfg.num_patches + PROMPT + DECODE_STEPS
    for step, (g, w, e) in enumerate(zip(got, want, exact)):
        _check(g, w, e, dtype, f"step {step}")


@pytest.mark.parametrize("dtype, flash", FLASH_CASES, ids=FLASH_IDS)
def test_uncached_forward_matches_the_reference(dtype, flash):
    """The trunk without a cache over patches + tokens: one hidden row per
    patch ahead of the prompt's."""
    cfg = _tcfg(dtype, flash)
    h, cache, _ = tlm.forward(cfg,
                           convert.lm_params_from_numpy(_reference_params()),
                           _tbatch(*_inputs()))
    assert cache is None
    assert tuple(h.shape) == (BATCH, cfg.num_patches + PROMPT, cfg.d_model)
    _check(h, _reference_hidden(dtype), _reference_hidden("float32"), dtype,
           "hidden")


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_cached_decode_agrees_with_the_uncached_forward(flash):
    """The reference's ``test_smoke_decode_consistency``, in the port:
    prefill the patches and 6 tokens, decode the next 6, each step's
    logits within 2e-2 of the uncached forward's at that position."""
    cfg = _tcfg(flash=flash)
    params = convert.lm_params_from_numpy(_reference_params())
    tokens, patches = _inputs(12)
    h, _, _ = tlm.forward(cfg, params, _tbatch(tokens, patches))
    full = tlm.logits_for(cfg, params, h)[:, cfg.num_patches:]
    cache = tlm.init_cache(cfg, BATCH, 32, "cpu")
    lg, cache = tlm.prefill(cfg, params, _tbatch(tokens[:, :6], patches),
                            cache)
    errs = [float((lg - full[:, 5]).abs().max())]
    for t in range(6, 12):
        lg, cache = tlm.decode_step(cfg, params,
                                    torch.from_numpy(tokens[:, t]), cache)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 2e-2, errs


def test_flash_launches_per_prefill_and_none_per_decode_step(monkeypatch):
    """A prefill launches flash once a layer (2 in the smoke config, 24 at
    internvl2-1b's depth), causal over patches + prompt, its 2 KV heads
    read in place; a decode step stays plain."""
    cfg = _tcfg(flash=True)
    calls = []
    real = TL.ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], q.shape[2], k.shape[1], kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(TL.ops, "flash_attention", counted)
    params = convert.lm_params_from_numpy(_reference_params())
    cache = tlm.init_cache(cfg, BATCH, _cache_len(cfg), "cpu")
    logits, cache = tlm.prefill(cfg, params, _tbatch(*_inputs()), cache)
    assert calls == [(cfg.num_heads, cfg.num_patches + PROMPT,
                      cfg.num_kv_heads, True)] * cfg.num_layers
    assert len(calls) == 2 and cfg.num_kv_heads < cfg.num_heads
    calls.clear()
    for _ in range(3):
        logits, cache = tlm.decode_step(cfg, params, logits.argmax(-1), cache)
    assert calls == []
    assert bool(torch.isfinite(logits).all())


# --------------------------------------------------------------------------
# layout, counts, convert
# --------------------------------------------------------------------------

def test_cache_layout_matches_the_reference():
    tcfg, jcfg = _tcfg(), _jcfg()
    tcache = tlm.init_cache(tcfg, 3, _cache_len(tcfg, 24), "cpu")
    jcache = jlm.init_cache(jcfg, 3, _cache_len(jcfg, 24))
    assert len(tcache["slots"]) == len(jcache["slots"]) == 1
    for ts, js in zip(tcache["slots"], jcache["slots"]):
        assert sorted(ts) == sorted(js) == ["k", "v"]
        for name in ts:
            assert tuple(ts[name].shape) == js[name].shape, name
            assert str(ts[name].dtype).split(".")[-1] == str(js[name].dtype)


def test_param_counts_of_the_full_config_match_the_reference():
    tcfg, jcfg = tget_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tlm.count_params(tcfg) == jlm.count_params(jcfg) \
        == PARAMS_PUBLISHED
    assert tlm.active_params(tcfg) == jlm.active_params(jcfg)
    assert tnum(tcfg) == jnum(jcfg)


def test_params_layout_and_convert_round_trip():
    """The port's tree has the reference's structure, shapes and dtypes
    (tied embeddings: no ``head``; QKV biases), and ``convert`` carries it
    to numpy and back bit for bit."""
    tcfg, jcfg = _tcfg(), _jcfg()
    params = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert "head" not in params and "bq" in params["blocks"][0]["attn"]
    ours = convert.lm_params_to_numpy(params)
    theirs = jax.eval_shape(lambda k: jlm.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(ours) == \
        jax.tree_util.tree_structure(theirs)
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(theirs)):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = convert.lm_params_from_numpy(ours)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ref = _reference_params()
    got = convert.lm_params_to_numpy(convert.lm_params_from_numpy(ref))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _reference_serve(cfg, params, reqs, batch_slots, max_len):
    """The loop of the reference's ``launch/serve.py::main`` (zero patches,
    a cache of ``max_len + num_patches``) on the reference's jitted
    prefill / decode_step."""
    jit_decode = jax.jit(lambda p, t, c: jlm.decode_step(cfg, p, t, c))
    jit_prefill = jax.jit(lambda p, b, c: jlm.prefill(cfg, p, b, c))
    B = batch_slots
    while reqs:
        active, reqs = reqs[:B], reqs[B:]
        plen = tserve._pow2_at_least(max(len(r.prompt) for r in active))
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(active):
            toks[i, plen - len(r.prompt):] = r.prompt
        patches = jnp.zeros((B, cfg.num_patches, cfg.d_model),
                            jnp.dtype(cfg.dtype))
        cache = jlm.init_cache(cfg, B, _cache_len(cfg, max_len))
        logits, cache = jit_prefill(
            params, {"tokens": jnp.asarray(toks), "patches": patches}, cache)
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
    tcfg = _tcfg(flash=True)
    theirs = tserve.cli_requests(tcfg, 6, 5)
    ours = tserve.cli_requests(tcfg, 6, 5)
    _reference_serve(_jcfg(), _reference_params(), theirs, batch_slots=4,
                     max_len=64)
    done = tserve.serve_requests(
        tcfg, convert.lm_params_from_numpy(_reference_params()), ours,
        batch_slots=4, max_len=64, device="cpu")
    assert [r.rid for r in done] == list(range(6))
    assert [r.out for r in done] == [r.out for r in theirs]


def test_serve_cli_serves_internvl2(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("served 8 requests, 128 tokens")
