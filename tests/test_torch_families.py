"""The port's decoder-only families (moe, hybrid, rwkv) against the
reference's, whole model.

Parameters are made by the reference's ``init_params`` and carried
across with ``convert.lm_params_from_numpy``; prompts come from numpy
generators.  Each family's smoke config runs ``prefill`` and six
``decode_step``s with ``use_flash_kernel`` off and on (the reference's
dispatch ignores the flag, so both runs are held to the same logits),
within the dense family's ``TOL`` (``tests/test_torch_models.py``): max
abs <= 1e-4 in float32; in bfloat16 the port's distance from the
reference's float32 logits is at most 1.2 times the reference's own
bfloat16 distance from them plus 2e-2 of the largest |logit|, and the
families that meet it (``BF16_AT_TOL``) are also held to 2e-2 of the
largest |logit| from the reference's bfloat16 logits (``_reference_run``
says why).  The serve loop gives the reference loop's tokens, and the
CLI serves every family.
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
from repro.launch.specs import model_cfg_for as jmodel_cfg_for
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import serve as tserve
from repro_torch.launch.specs import model_cfg_for as tmodel_cfg_for
from repro_torch.models import lm as tlm

ARCHS = ["mixtral-8x7b", "arctic-480b", "zamba2-2.7b", "rwkv6-3b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BATCH, PROMPT, MAX_LEN, DECODE_STEPS = 2, 32, 40, 6
# bfloat16: the port's distance from the reference's float32 logits, as a
# multiple of the reference's own bfloat16 distance from them
BF16_NOISE = 1.2
# the families whose bfloat16 logits lie within TOL of the reference's
BF16_AT_TOL = ("mixtral-8x7b",)


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _reference_params(arch: str):
    cfg = jget_config(arch, smoke=True)
    return jax.tree.map(np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _reference_fns(arch: str, dtype: str):
    cfg = jget_config(arch, smoke=True).with_overrides(dtype=dtype)
    return (cfg, jax.jit(lambda p, b, c: jlm.prefill(cfg, p, b, c)),
            jax.jit(lambda p, t, c: jlm.decode_step(cfg, p, t, c)))


def _reference_logits(arch: str, dtype: str, tokens, fed):
    """The reference's prefill + decode logits, decode fed ``fed``
    (or, with ``fed`` None, its own argmax tokens); returns (fed, logits)."""
    cfg, jp, jd = _reference_fns(arch, dtype)
    params = _reference_params(arch)
    cache = jlm.init_cache(cfg, BATCH, MAX_LEN)
    logits, cache = jp(params, {"tokens": jnp.asarray(tokens, jnp.int32)},
                       cache)
    steps, own = [np.asarray(logits, np.float32)], []
    for i in range(DECODE_STEPS):
        cur = jnp.argmax(logits, -1) if fed is None else jnp.asarray(fed[i])
        own.append(np.asarray(cur))
        logits, cache = jd(params, cur, cache)
        steps.append(np.asarray(logits, np.float32))
    return own, steps


@functools.lru_cache(maxsize=None)
def _reference_run(arch: str, dtype: str):
    """The reference's prompt, its fed decode tokens (its own argmax), its
    logits, and, in bfloat16, its float32 logits on the same tokens.

    Three of these families' smoke configs amplify bfloat16 rounding more
    than the dense ones: the reference's bfloat16 logits lie up to 7.3 %
    of the largest |logit| from its float32 logits (mixtral 1.2 %, arctic
    7.3 %, whose top-2 routing flips near ties of its router
    probabilities, zamba2 5.1 %, rwkv6 3.1 %), so a port that rounds at
    other places (XLA computes fused elementwise chains in float32,
    PyTorch rounds after each op) cannot be held to 2 % of them.  It is
    held instead to the float32 function: no more than ``BF16_NOISE``
    times as far from it as the reference's bfloat16 run, plus ``TOL``."""
    tokens = _rng("prompt", arch).integers(
        0, jget_config(arch, smoke=True).vocab_size, size=(BATCH, PROMPT))
    fed, want = _reference_logits(arch, dtype, tokens, None)
    exact = None
    if dtype == "bfloat16":
        _, exact = _reference_logits(arch, "float32", tokens, fed)
    return tokens, fed, want, exact


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch, dtype, flash):
    tokens, fed, want, exact = _reference_run(arch, dtype)
    cfg = tget_config(arch, smoke=True).with_overrides(
        dtype=dtype, use_flash_kernel=flash)
    params = convert.lm_params_from_numpy(_reference_params(arch), "cpu")
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
        if dtype == "float32":
            assert err <= TOL[dtype], f"step {step}: max abs {err}"
            continue
        top = float(np.abs(w).max())
        if arch in BF16_AT_TOL:
            assert err <= TOL[dtype] * top, \
                f"step {step}: max abs {err} > {TOL[dtype]} of {top}"
        e = exact[step]
        ours, theirs = float(np.abs(g - e).max()), float(np.abs(w - e).max())
        bound = BF16_NOISE * theirs + TOL[dtype] * top
        assert ours <= bound, (f"step {step}: {ours} from the float32 logits "
                               f"(the reference's bfloat16: {theirs})")


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_launches_once_per_attention_application(arch, monkeypatch):
    """A prefill sends each attention application of the stack through the
    flash wrapper (every moe layer, every shared-block application of the
    hybrid), and none for rwkv, whose ``attn_kind`` is "none"."""
    from repro_torch.models import layers as TL
    cfg = tget_config(arch, smoke=True).with_overrides(
        dtype="float32", use_flash_kernel=True)
    calls = []
    real = TL.ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append(k.shape[1])
        return real(q, k, v, **kw)

    monkeypatch.setattr(TL.ops, "flash_attention", counted)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = tlm.init_cache(cfg, BATCH, MAX_LEN, "cpu")
    tokens = torch.from_numpy(_rng("launches", arch).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT)))
    logits, _ = tlm.prefill(cfg, params, {"tokens": tokens}, cache)
    assert bool(torch.isfinite(logits).all())
    want = {"moe": cfg.num_layers,
            "hybrid": cfg.num_layers // cfg.shared_attn_every,
            "rwkv": 0}[cfg.family]
    assert calls == [cfg.num_kv_heads] * want


def test_swa_ring_cache_is_window_bounded():
    cfg = tget_config("mixtral-8x7b", smoke=True)
    cache = tlm.init_cache(cfg, 2, 64, "cpu")      # window=16 -> ring of 16
    k = cache["slots"][0]["k"]
    assert k.shape[3] == cfg.window
    want = jlm.init_cache(jget_config("mixtral-8x7b", smoke=True), 2, 64)
    assert tuple(k.shape) == want["slots"][0]["k"].shape


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_matches_the_reference(arch):
    tcache = tlm.init_cache(tget_config(arch, smoke=True), 3, 24, "cpu")
    jcache = jlm.init_cache(jget_config(arch, smoke=True), 3, 24)
    assert len(tcache["slots"]) == len(jcache["slots"])
    for ts, js in zip(tcache["slots"], jcache["slots"]):
        assert sorted(ts) == sorted(js)
        for name in ts:
            assert tuple(ts[name].shape) == js[name].shape, name
            assert str(ts[name].dtype).split(".")[-1] == str(js[name].dtype)


def test_param_counts_of_the_full_configs_match_the_reference():
    for arch in ARCHS:
        tcfg, jcfg = tmodel_cfg_for(arch), jmodel_cfg_for(arch)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tlm.count_params(tcfg) == jlm.count_params(jcfg)
        assert tlm.active_params(tcfg) == jlm.active_params(jcfg)
        from repro.models.config import num_params as jnum
        from repro_torch.models.config import num_params as tnum
        assert tnum(tcfg) == jnum(jcfg)
    assert tmodel_cfg_for("arctic-480b").param_dtype == "bfloat16"
    assert tmodel_cfg_for("arctic-480b", smoke=True).param_dtype == "float32"


@pytest.mark.parametrize("arch", ARCHS)
def test_params_layout_and_convert_round_trip(arch):
    """The port's tree has the reference's structure, shapes and dtypes,
    and ``convert`` carries it to numpy and back bit for bit: the expert
    stacks, the shared block, the rwkv ``mu`` stacks, and bfloat16
    leaves (arctic's ``param_dtype``)."""
    for dtype in ("float32", "bfloat16"):
        jcfg = jget_config(arch, smoke=True).with_overrides(param_dtype=dtype)
        tcfg = tget_config(arch, smoke=True).with_overrides(param_dtype=dtype)
        gen = torch.Generator().manual_seed(0)
        params = tlm.init_params(tcfg, gen, "cpu")
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
        # a reference tree (numpy's bfloat16 included) carried across
        ref = jax.tree.map(np.asarray,
                           jlm.init_params(jcfg, jax.random.PRNGKey(1)))
        got = convert.lm_params_to_numpy(convert.lm_params_from_numpy(ref))
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_requests_gives_the_reference_loops_tokens(arch):
    jcfg = jget_config(arch, smoke=True).with_overrides(dtype="float32")
    tcfg = tget_config(arch, smoke=True).with_overrides(
        dtype="float32", use_flash_kernel=True)
    params = _reference_params(arch)
    theirs = tserve.cli_requests(tcfg, 6, 5)
    ours = tserve.cli_requests(tcfg, 6, 5)
    _reference_serve(jcfg, params, theirs, batch_slots=4, max_len=64)
    done = tserve.serve_requests(
        tcfg, convert.lm_params_from_numpy(params), ours, batch_slots=4,
        max_len=64, device="cpu")
    assert [r.rid for r in done] == list(range(6))
    assert [r.out for r in done] == [r.out for r in theirs]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_every_family(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("served 8 requests, 128 tokens")
