"""The port's training path against the reference's, on the CPU.

``repro_torch.models.lm.loss_fn``, ``repro_torch.train`` (optim, step,
compress, checkpoint), ``repro_torch.data.tokens``,
``repro_torch.configs.shapes`` and ``repro_torch.launch.{specs,train}``
run beside their ``repro`` twins on the same seeded numpy inputs, the
parameters made by the reference's ``init_params`` and carried across
with ``convert``.  Tolerances:

* loss and metrics within 1e-5 relative; every gradient leaf within 1e-4
  of that leaf's largest |g| (float32 activations); in bfloat16 the loss
  within 3e-2 relative and every leaf no farther from the reference's
  float32 gradient than 1.2 times the reference's own bfloat16 gradient
  is, plus 3e-2 of its largest |g|; the families whose bfloat16
  gradients lie within 3e-2 of the reference's (``BF16_AT_TOL``) are
  also held to that (the hybrid and rwkv smoke configs amplify bfloat16
  rounding: the reference's own bfloat16 gradients lie 26 % and 81 % of
  a leaf's largest |g| from its float32 ones, as ``test_torch_families``
  finds for their logits);
* params and optimizer state after each of 3 train steps within 1e-5 of
  each leaf's largest |value| (lion: a sign taken of a value near 0 may
  flip between the packages, so its flips are counted and bounded);
* int8 codes, token arrays and checkpoint leaves equal.
"""

import contextlib
import functools
import io
import os
import shutil
import zlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro import train as jtrain
from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.data.tokens import TokenPipeline as JPipeline
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.train import checkpoint as jckpt
from repro.train import compress as jcompress
from repro_torch import convert
from repro_torch import train as ttrain
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import shapes as tshapes
from repro_torch.data.tokens import TokenPipeline as TPipeline
from repro_torch.kernels import ops
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import compress as tcompress
from repro_torch.train.tree import flatten, unflatten

ARCH = {"dense": "qwen2-1.5b", "moe": "mixtral-8x7b", "hybrid": "zamba2-2.7b",
        "rwkv": "rwkv6-3b", "encdec": "whisper-small", "vlm": "internvl2-1b"}
# the loss case ids: every family, and the dense one with a loss mask
CASES = list(ARCH) + ["dense-masked"]
# 64 positions: two CE chunks of the smoke configs' ce_chunk 32
BATCH, SEQ = 2, 64
LOSS_RTOL = 1e-5
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# bfloat16: the port's distance from the reference's float32 gradients,
# as a multiple of the reference's own bfloat16 distance from them
BF16_NOISE = 1.2
BF16_AT_TOL = ("dense", "dense-masked", "moe", "encdec", "vlm")
STATE_TOL = 1e-5


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


@functools.lru_cache(maxsize=None)
def _reference_params(arch: str):
    cfg = jget_config(arch, smoke=True)
    return jax.tree.map(np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(0)))


def _batch(case: str, batch=BATCH, seq=SEQ) -> dict:
    """Seeded numpy inputs: tokens [B, S+1], the stub frames / patches
    (N(0, 1); patches x 0.02), a loss mask for "dense-masked"."""
    arch = ARCH[case.split("-")[0]]
    cfg = jget_config(arch, smoke=True)
    rng = _rng("batch", case, batch, seq)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(batch, seq + 1)
                                  ).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(batch, cfg.enc_seq, cfg.d_model)
                                   ).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = (rng.normal(size=(batch, cfg.num_patches,
                                           cfg.d_model)) * 0.02
                          ).astype(np.float32)
    if case.endswith("masked"):
        out["loss_mask"] = (rng.random((batch, seq)) < 0.7).astype(np.float32)
    return out


def _tbatch(b: dict, dtype: str = "float32") -> dict:
    act = torch.float32 if dtype == "float32" else torch.bfloat16
    return {k: torch.from_numpy(v).to(act if k in ("frames", "patches")
                                      else torch.from_numpy(v).dtype)
            for k, v in b.items()}


def _jbatch(b: dict, dtype: str = "float32") -> dict:
    act = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return {k: jnp.asarray(v, act if k in ("frames", "patches") else None)
            for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(case: str, dtype: str):
    arch = ARCH[case.split("-")[0]]
    cfg = jget_config(arch, smoke=True).with_overrides(dtype=dtype)
    f = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(cfg, p, b),
                                   has_aux=True))
    (loss, metrics), grads = f(jax.tree.map(jnp.asarray,
                                            _reference_params(arch)),
                               _jbatch(_batch(case), dtype))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            [np.asarray(g, np.float32) for g in jax.tree_util.tree_leaves(grads)])


def _port_loss_and_grads(case: str, dtype: str):
    arch = ARCH[case.split("-")[0]]
    cfg = tget_config(arch, smoke=True).with_overrides(dtype=dtype)
    params = convert.lm_params_from_numpy(_reference_params(arch))
    leaves, structure = flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = tlm.loss_fn(cfg, unflatten(structure, leaves),
                                _tbatch(_batch(case), dtype))
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            [g.to(torch.float32).numpy() for g in grads])


# --------------------------------------------------------------------------
# loss_fn and its gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_loss_and_every_gradient_leaf_match_the_reference(case, dtype):
    want_loss, want_m, want_g = _reference_loss_and_grads(case, dtype)
    got_loss, got_m, got_g = _port_loss_and_grads(case, dtype)
    rtol = LOSS_RTOL if dtype == "float32" else GRAD_TOL[dtype]
    assert abs(got_loss - want_loss) <= rtol * abs(want_loss)
    assert set(got_m) == {"ce", "aux", "tokens"} == set(want_m)
    for k in ("ce", "aux"):
        assert abs(got_m[k] - want_m[k]) <= rtol * abs(want_m[k]) + 1e-7, k
    assert got_m["tokens"] == want_m["tokens"]
    if case == "moe":
        assert got_m["aux"] > 0
    else:
        assert got_m["aux"] == 0.0
    if case == "dense-masked":
        assert got_m["tokens"] < BATCH * SEQ
    assert len(got_g) == len(want_g)
    exact = _reference_loss_and_grads(case, "float32")[2]
    for i, (g, w, x) in enumerate(zip(got_g, want_g, exact)):
        assert g.shape == w.shape, i
        tol = GRAD_TOL[dtype]
        if dtype == "bfloat16":
            own = float(np.abs(w - x).max())
            assert float(np.abs(g - x).max()) <= \
                BF16_NOISE * own + tol * float(np.abs(x).max()), (case, i)
            if case not in BF16_AT_TOL:
                continue
        assert float(np.abs(g - w).max()) <= \
            tol * float(np.abs(w).max()), (case, i)


def test_loss_never_takes_the_whole_logit_tensor(monkeypatch):
    """The head runs once a CE chunk (two chunks of 32 at S = 64), on a
    chunk's positions only; without grad no chunk is checkpointed."""
    cfg = tget_config("qwen2-1.5b", smoke=True)
    params = convert.lm_params_from_numpy(_reference_params("qwen2-1.5b"))
    seen = []
    real = tlm.logits_for

    def spy(c, p, h):
        seen.append(h.shape[1])
        return real(c, p, h)

    monkeypatch.setattr(tlm, "logits_for", spy)
    with torch.no_grad():
        tlm.loss_fn(cfg, params, _tbatch(_batch("dense")))
    assert seen == [32, 32]


def test_remat_checkpoints_each_group_only_while_recording_grad(
        monkeypatch):
    """``cfg.remat`` runs each group under ``torch.utils.checkpoint`` when
    a gradient is being recorded, and never in serving: not without
    grad, not when no tensor requires one, not with remat off."""
    from repro_torch.models import transformer as TT
    calls = []
    real = TT.checkpoint

    def spy(fn, *args, **kw):
        calls.append(1)
        return real(fn, *args, **kw)

    monkeypatch.setattr(TT, "checkpoint", spy)
    cfg = tget_config("qwen2-1.5b", smoke=True)
    params = convert.lm_params_from_numpy(_reference_params("qwen2-1.5b"))
    batch = _tbatch(_batch("dense"))
    want, _ = tlm.loss_fn(cfg, params, batch)
    with torch.no_grad():
        tlm.loss_fn(cfg, params, batch)
    assert calls == []
    for p in flatten(params)[0]:
        p.requires_grad_(True)
    got, _ = tlm.loss_fn(cfg, params, batch)
    assert len(calls) == TT.num_groups(cfg) == 2
    assert float(got) == float(want)
    tlm.loss_fn(cfg.with_overrides(remat=False), params, batch)
    assert len(calls) == 2


def test_forward_returns_the_summed_moe_aux():
    """``forward`` carries the aux loss: zero for a dense model, the sum
    over the MoE layers (equal to the reference's) for mixtral."""
    for arch, positive in (("qwen2-1.5b", False), ("mixtral-8x7b", True)):
        cfg = tget_config(arch, smoke=True).with_overrides(dtype="float32")
        jcfg = jget_config(arch, smoke=True).with_overrides(dtype="float32")
        toks = _batch("moe" if positive else "dense")["tokens"][:, :-1]
        params = _reference_params(arch)
        _, cache, aux = tlm.forward(
            cfg, convert.lm_params_from_numpy(params),
            {"tokens": torch.from_numpy(toks)})
        _, _, want = jax.jit(lambda p, b: jlm.forward(jcfg, p, b))(
            jax.tree.map(jnp.asarray, params), {"tokens": jnp.asarray(toks)})
        assert cache is None
        assert aux.dtype == torch.float32
        assert abs(float(aux) - float(want)) <= 1e-6
        assert (float(aux) > 0) == positive


def test_flash_attention_refuses_grad():
    """The flash kernel has no backward: under grad with q / k / v that
    require grad the wrapper raises (on either device; the CPU here), a
    loss with ``use_flash_kernel`` raises, and serving (no grad) is
    untouched."""
    rng = _rng("flash")
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 8, 16)).astype(
        np.float32)) for _ in range(3))
    want = ops.flash_attention(q, k, v)
    q.requires_grad_(True)
    with pytest.raises(ValueError, match="use_flash_kernel=False"):
        ops.flash_attention(q, k, v)
    with torch.no_grad():
        torch.testing.assert_close(ops.flash_attention(q, k, v), want,
                                   rtol=0, atol=0)
    cfg = tget_config("qwen2-1.5b", smoke=True).with_overrides(
        use_flash_kernel=True)
    params = convert.lm_params_from_numpy(_reference_params("qwen2-1.5b"))
    for p in flatten(params)[0]:
        p.requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        tlm.loss_fn(cfg, params, _tbatch(_batch("dense")))


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

# no q / k / v bias: a key bias's gradient is 0 in exact arithmetic (the
# softmax ignores a constant added to a row's logits), so its computed
# gradient is rounding noise, which adam and adafactor normalise to
# steps of about lr in either sign; stablelm's smoke config has none
STEP_ARCH = "stablelm-3b"
STEP_LR = (1e-2, 1, 10)            # warmup_cosine(peak, warmup, total)


def _state_leaves(state, pkg):
    """(top-level key, leaf) of every leaf of a train state, in the
    reference's leaf order."""
    if pkg == "ref":
        return [(k, np.asarray(l)) for k in sorted(state)
                for l in jax.tree_util.tree_leaves(state[k])]
    return [(k, convert.lm_params_to_numpy(l)) for k in sorted(state)
            for l in flatten(state[k])[0]]


@functools.lru_cache(maxsize=None)
def _reference_steps(opt_name: str, mb: int, steps: int, compress: bool):
    cfg = jget_config(STEP_ARCH, smoke=True).with_overrides(
        dtype="float32", remat=False)
    tcfg = jtrain.TrainCfg(optimizer=opt_name, microbatches=mb,
                           compress_grads=compress)
    opt = jtrain.get_optimizer(opt_name)
    step = jax.jit(jtrain.make_train_step(
        cfg, tcfg, opt, jtrain.warmup_cosine(*STEP_LR)))
    state = jtrain.init_state(cfg, tcfg, opt, jax.tree.map(
        jnp.asarray, _reference_params(STEP_ARCH)))
    pipe = JPipeline(cfg.vocab_size, 16, 4, seed=5)
    out = []
    for _ in range(steps):
        state, m = step(state, {"tokens": jnp.asarray(
            pipe.next_batch()["tokens"])})
        out.append((_state_leaves(state, "ref"),
                    {k: float(v) for k, v in m.items()}))
    return out


def _port_steps(opt_name: str, mb: int, steps: int, compress: bool):
    cfg = tget_config(STEP_ARCH, smoke=True).with_overrides(
        dtype="float32", remat=False)
    tcfg = ttrain.TrainCfg(optimizer=opt_name, microbatches=mb,
                           compress_grads=compress)
    opt = ttrain.get_optimizer(opt_name)
    step = ttrain.make_train_step(cfg, tcfg, opt,
                                  ttrain.warmup_cosine(*STEP_LR))
    state = ttrain.init_state(cfg, tcfg, opt, convert.lm_params_from_numpy(
        _reference_params(STEP_ARCH)))
    pipe = TPipeline(cfg.vocab_size, 16, 4, seed=5)
    out = []
    for _ in range(steps):
        state, m = step(state, {"tokens": torch.from_numpy(
            pipe.next_batch()["tokens"])})
        out.append((_state_leaves(state, "port"),
                    {k: float(v) for k, v in m.items()}))
    return out


def _sign_flips(got, want, lr):
    """Elements of a lion update whose sign differs: their params sit
    about 2 lr apart."""
    return int(np.sum(np.abs(got - want) > 0.5 * lr))


def _check_steps(opt_name: str, compress: bool, steps: int):
    """The port's ``steps`` train steps against the reference's: metrics
    and the whole state tree (in the reference's leaf order) after each,
    every element within 1e-5 of its leaf's largest |value|, but for the
    flips counted and bounded to 1 in 10^3 elements of the state (see
    the two tests below).  An error-feedback residual is at most half a
    code step, 1 / 254 of its gradient's scale, and is held to 1e-5 of
    that scale."""
    want = _reference_steps(opt_name, 1, steps, compress)
    got = _port_steps(opt_name, 1, steps, compress)
    flipping = compress or opt_name == "lion"
    for k, ((gl, gm), (wl, wm)) in enumerate(zip(got, want)):
        assert set(gm) == set(wm) == {"ce", "aux", "tokens", "loss",
                                      "grad_norm", "lr"}
        for name in gm:
            assert abs(gm[name] - wm[name]) <= \
                STATE_TOL * abs(wm[name]) + 1e-7, (k, name)
        assert [t for t, _ in gl] == [t for t, _ in wl]
        flips = total = 0
        for i, ((top, g), (_, w)) in enumerate(zip(gl, wl)):
            assert g.shape == w.shape and g.dtype == w.dtype, (k, i)
            if w.dtype.kind != "f":
                np.testing.assert_array_equal(g, w)
                continue
            scale = float(np.abs(w).max()) * (2 * 127 if top == "ef" else 1)
            bad = np.abs(g - w) > STATE_TOL * scale + 1e-12
            flips += int(bad.sum())
            total += w.size
            if not flipping:
                assert not bad.any(), (opt_name, k, i,
                                       float(np.abs(g - w).max()), scale)
        assert flips <= 1e-3 * total, (k, flips, total)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "lion"])
def test_three_train_steps_match_the_reference(opt_name):
    """3 steps of each optimizer.  Lion's sign of ``b1 m + (1 - b1) g``
    near 0 may flip between the packages (the gradients agree to about
    1e-6, not bit for bit): its flips, and what they move in the steps
    after them, are counted."""
    _check_steps(opt_name, False, 3)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "lion"])
def test_compressed_train_steps_match_the_reference(opt_name):
    """2 steps with int8 error feedback (the learning rate of the first
    is 0, so the second moves the params).  An int8 code may round the
    other way at a half step (the gradients agree to about 1e-6): those
    flips, and what they move in the rest of the step, are counted.
    Once a code has flipped, the factored moments and relative clipping
    of adafactor spread the difference over whole rows, so more steps
    are not held."""
    _check_steps(opt_name, True, 2)


def test_arctic_bfloat16_adafactor_steps_match_the_reference():
    """arctic's own training setup on its smoke config: bfloat16 params
    (``ARCH_TRAIN``'s ``param_dtype``), adafactor, the MoE beside the
    dense residual MLP.  Activations in float32, so the gradients agree
    to about 1e-5 and the bfloat16 rounding of each new param can be
    compared: over 2 steps the params equal the reference's but for at
    most 1 in 10^3 elements (a rounding the float32 noise moved across a
    tie, or a small element where the update dominates), each within one
    bfloat16 ulp of its leaf's largest |value|.  The slots hold means of g^2;
    the MoE's gradients agree to 1e-4 of a leaf's largest |g| (the loss
    test's bound), so each slot is held to 2e-4 of its leaf's largest
    value."""
    SLOT_TOL = 2 * GRAD_TOL["float32"]
    arch = "arctic-480b"
    over = dict(param_dtype="bfloat16", dtype="float32", remat=False)
    jcfg = jget_config(arch, smoke=True).with_overrides(**over)
    tcfg = tget_config(arch, smoke=True).with_overrides(**over)
    host = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(0)))
    assert {str(l.dtype) for l in jax.tree_util.tree_leaves(host)} >= \
        {"bfloat16"}
    lr = jtrain.warmup_cosine(*STEP_LR), ttrain.warmup_cosine(*STEP_LR)
    jopt, topt = jtrain.get_optimizer("adafactor"), \
        ttrain.get_optimizer("adafactor")
    jstep = jax.jit(jtrain.make_train_step(jcfg, jtrain.TrainCfg(), jopt,
                                           lr[0]))
    tstep = ttrain.make_train_step(tcfg, ttrain.TrainCfg(), topt, lr[1])
    jstate = jtrain.init_state(jcfg, jtrain.TrainCfg(), jopt,
                               jax.tree.map(jnp.asarray, host))
    tstate = ttrain.init_state(tcfg, ttrain.TrainCfg(), topt,
                               convert.lm_params_from_numpy(host))
    pipe = JPipeline(jcfg.vocab_size, 16, 2, seed=8)
    for k in range(2):
        toks = pipe.next_batch()["tokens"]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks)})
        assert float(tm["aux"]) > 0
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            STATE_TOL * float(jm["loss"])
        off = total = 0
        for (top, g), (_, w) in zip(_state_leaves(tstate, "port"),
                                    _state_leaves(jstate, "ref")):
            assert g.dtype == w.dtype, (k, top)
            if top == "params" and str(w.dtype) == "bfloat16":
                gf, wf = g.astype(np.float32), w.astype(np.float32)
                assert np.all(np.abs(gf - wf)
                              <= 2.0 ** -7 * np.abs(wf).max()), (k, top)
                off += int(np.sum(gf != wf))
                total += w.size
            elif w.dtype.kind == "f":
                assert float(np.abs(g - w).max()) <= \
                    SLOT_TOL * float(np.abs(w).max()) + 1e-12, (k, top)
            else:
                np.testing.assert_array_equal(g, w)
        assert total > 0 and off <= 1e-3 * total, (k, off, total)


def test_two_microbatches_match_the_reference_and_one():
    """Microbatches 2 against the reference's 2 (state within 1e-5), and
    against the port's 1 on the same global batch (the reference's
    ``test_microbatch_accumulation_matches_full_batch`` bounds: loss
    within 1e-3, params within rtol 1e-3 + atol 1e-5)."""
    want = _reference_steps("adamw", 2, 1, False)[0]
    two = _port_steps("adamw", 2, 1, False)[0]
    one = _port_steps("adamw", 1, 1, False)[0]
    for (_, g), (_, w) in zip(two[0], want[0]):
        if w.dtype.kind == "f":
            assert float(np.abs(g - w).max()) <= \
                STATE_TOL * float(np.abs(w).max()) + 1e-12
        else:
            np.testing.assert_array_equal(g, w)
    assert abs(two[1]["loss"] - want[1]["loss"]) <= STATE_TOL * want[1]["loss"]
    assert abs(two[1]["loss"] - one[1]["loss"]) < 1e-3
    assert two[1]["tokens"] == one[1]["tokens"] / 2     # the last microbatch
    for (_, a), (_, b) in zip(one[0], two[0]):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)


def test_clip_and_schedule_match_the_reference():
    rng = _rng("clip")
    tree = {"a": rng.normal(size=(4, 8)).astype(np.float32) * 30,
            "b": (rng.normal(size=(5,)).astype(np.float32),
                  rng.normal(size=(2, 3)).astype(np.float32))}
    jc, jn = jtrain.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    tc, tn = ttrain.clip_by_global_norm(
        convert.lm_params_from_numpy(tree), 1.0)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    assert float(ttrain.global_norm(tc)) == pytest.approx(1.0, abs=1e-5)
    for g, w in zip(flatten(tc)[0], jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    small, n = ttrain.clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    assert float(n) == pytest.approx(0.2) and float(small["a"][0]) == \
        pytest.approx(0.1)
    jlr = jtrain.warmup_cosine(1.0, 10, 100, final_frac=0.1)
    tlr = ttrain.warmup_cosine(1.0, 10, 100, final_frac=0.1)
    for s in (0, 5, 10, 55, 100, 150):
        assert float(tlr(torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(float(jlr(jnp.int32(s))), rel=1e-6, abs=1e-7)
        assert float(tlr(s)) == float(tlr(torch.tensor(s)))
    assert float(tlr(0)) == 0.0
    assert float(tlr(10)) == pytest.approx(1.0)
    assert float(tlr(100)) == pytest.approx(0.1)


def test_quantize_and_error_feedback_codes_equal_the_reference():
    """int8 codes (halves round to even in both), scales, dequantized
    grads and residuals over 3 rounds of error feedback."""
    x = np.array([2.5, -3.5, 0.5, -0.5, 1.5, 127.0, -126.5, 3.2],
                 np.float32)                       # scale 1: exact halves
    jq, js = jcompress.quantize(jnp.asarray(x))
    tq, ts = tcompress.quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js) == 1.0
    np.testing.assert_array_equal(tq.numpy()[:5], [2, -4, 0, 0, 2])
    rng = _rng("ef")
    shapes = {"w": (16, 8), "b": (8,)}
    jres = jcompress.ef_init({k: jnp.zeros(s) for k, s in shapes.items()})
    tres = tcompress.ef_init({k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(3):
        g = {k: (rng.normal(size=s) * 3).astype(np.float32)
             for k, s in shapes.items()}
        jdeq, jres = jcompress.ef_compress_tree(
            jax.tree.map(jnp.asarray, g), jres)
        tdeq, tres = tcompress.ef_compress_tree(
            convert.lm_params_from_numpy(g), tres)
        for k in shapes:
            np.testing.assert_array_equal(tdeq[k].numpy(),
                                          np.asarray(jdeq[k]))
            np.testing.assert_array_equal(tres[k].numpy(),
                                          np.asarray(jres[k]))
            np.testing.assert_array_equal(
                tcompress.quantize(torch.from_numpy(g[k]))[0].numpy(),
                np.asarray(jcompress.quantize(jnp.asarray(g[k]))[0]))
    err = np.abs(tcompress.dequantize(tq, ts).numpy() - x).max()
    assert err <= 0.5


# --------------------------------------------------------------------------
# data, shapes, specs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab_size=1024, seq_len=16, batch_size=4, seed=3),
    dict(vocab_size=151_936, seq_len=33, batch_size=2, seed=0),
    dict(vocab_size=100, seq_len=8, batch_size=3, seed=7, host_id=1,
         num_hosts=2, latent_k=12)], ids=["small", "qwen2-vocab", "host1"])
def test_token_pipeline_equals_the_reference_at_every_cursor(kw):
    j, t = JPipeline(**kw), TPipeline(**kw)
    for _ in range(4):
        a, b = j.next_batch()["tokens"], t.next_batch()["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert t.state() == j.state()
    args = (kw["vocab_size"], kw["seq_len"], kw["batch_size"])
    j2 = JPipeline.from_state(*args, j.state())
    t2 = TPipeline.from_state(*args, t.state())
    for _ in range(2):
        np.testing.assert_array_equal(t2.next_batch()["tokens"],
                                      j2.next_batch()["tokens"])


def test_shapes_and_specs_equal_the_reference():
    assert {k: vars(v) for k, v in tshapes.SHAPES.items()} == \
        {k: vars(v) for k, v in jshapes.SHAPES.items()}
    assert vars(tshapes.get_shape("train_4k")) == \
        {"name": "train_4k", "kind": "train", "seq_len": 4096,
         "global_batch": 256}
    from repro_torch.configs import get_shape
    assert get_shape is tshapes.get_shape
    for arch in ("qwen2-1.5b", "mixtral-8x7b", "arctic-480b", "gemma2-27b",
                 "whisper-small", "internvl2-1b"):
        assert vars(tspecs.train_cfg_for(arch)) == \
            vars(jspecs.train_cfg_for(arch))
        for smoke in (True, False):
            assert tspecs.model_cfg_for(arch, smoke=smoke).param_dtype == \
                jspecs.model_cfg_for(arch, smoke=smoke).param_dtype
        cfg = jget_config(arch, smoke=True)
        want = jspecs._batch_struct(cfg, "train", 16, 2)
        got = tspecs.batch_struct(tget_config(arch, smoke=True), "train",
                                  16, 2)
        assert {k: (tuple(s.shape), str(np.dtype(s.dtype)))
                for k, s in want.items()} == \
            {k: (shape, str(dt).replace("torch.", ""))
             for k, (shape, dt) in got.items()}
        b = tspecs.train_batch(tget_config(arch, smoke=True),
                               np.zeros((2, 17), np.int32), "cpu")
        assert {k: tuple(v.shape) for k, v in b.items()} == \
            {k: s for k, (s, _) in got.items()}


# --------------------------------------------------------------------------
# checkpoints across the packages
# --------------------------------------------------------------------------

def _reference_state(opt_name: str, compress: bool = False):
    cfg = jget_config(STEP_ARCH, smoke=True)
    tcfg = jtrain.TrainCfg(optimizer=opt_name, compress_grads=compress)
    opt = jtrain.get_optimizer(opt_name)
    state = jtrain.init_state(cfg, tcfg, opt, jax.tree.map(
        jnp.asarray, _reference_params(STEP_ARCH)))
    # nonzero optimizer slots and step, so every leaf is told apart
    rng = _rng("state", opt_name, compress)
    return jax.tree.map(
        lambda l: jnp.asarray(rng.normal(size=l.shape).astype(np.float32),
                              l.dtype) if jnp.issubdtype(l.dtype, jnp.floating)
        else l + 3, state)


@pytest.mark.parametrize("opt_name, compress", [
    ("adamw", True), ("adafactor", False), ("lion", False)])
def test_checkpoints_restore_across_the_packages_bit_for_bit(
        opt_name, compress, tmp_path):
    """A state saved by ``repro.train.checkpoint.save`` restores into the
    port's template (every leaf equal, dtype kept, ``extra`` back), and a
    state saved by the port restores into the reference's."""
    jstate = _reference_state(opt_name, compress)
    host = jax.tree.map(np.asarray, jstate)
    tstate = convert.train_state_from_numpy(host)
    template = convert.train_state_from_numpy(
        jax.tree.map(np.zeros_like, host))
    jckpt.save(str(tmp_path / "ref"), 7, jstate, extra={"cursor": 7})
    got, extra = tckpt.restore(str(tmp_path / "ref"), template, device="cpu")
    assert extra == {"cursor": 7}
    want = jax.tree_util.tree_leaves(jstate)
    assert len(flatten(got)[0]) == len(want)
    for g, w in zip(flatten(got)[0], want):
        assert g.dtype == convert.lm_params_from_numpy(np.asarray(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert set(got) == {"params", "opt", "step"} | (
        {"ef"} if compress else set())
    tckpt.save(str(tmp_path / "port"), 9, tstate, extra={"cursor": 9})
    back, extra = jckpt.restore(str(tmp_path / "port"),
                                jax.tree.map(jnp.zeros_like, jstate))
    assert extra == {"cursor": 9}
    for g, w in zip(jax.tree_util.tree_leaves(back), want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for a, b in zip(jax.tree_util.tree_leaves(
            convert.train_state_to_numpy(tstate)),
            jax.tree_util.tree_leaves(host)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_async_gc_and_partial_write(tmp_path):
    """The reference's ``test_checkpoint_roundtrip_and_gc`` and
    ``test_checkpoint_atomicity_partial_write_ignored`` on the port; the
    default restore device is the card, so the CPU is asked for."""
    state = convert.train_state_from_numpy(jax.tree.map(
        np.asarray, _reference_state("adamw")))
    d = str(tmp_path)
    tckpt.save(d, 5, state, extra={"cursor": 7})
    t = tckpt.save_async(d, 9, state, extra={"cursor": 11})
    t.join(timeout=60)
    assert not t.is_alive()
    assert tckpt.latest_step(d) == 9
    restored, extra = tckpt.restore(d, state, device="cpu")
    assert extra == {"cursor": 11}
    for a, b in zip(flatten(state)[0], flatten(restored)[0]):
        assert torch.equal(a, b)
    restored5, _ = tckpt.restore(d, state, step=5, device="cpu")
    assert int(restored5["step"]) == int(state["step"])
    tckpt.gc_checkpoints(d, keep=1)
    assert tckpt.latest_step(d) == 9
    assert not os.path.exists(os.path.join(d, "step_000000005"))
    os.makedirs(os.path.join(d, "step_000000011.tmp", "arrays"))
    assert tckpt.latest_step(d) == 9
    tckpt.gc_checkpoints(d, keep=1)
    assert os.path.exists(os.path.join(d, "step_000000009"))
    restored, _ = tckpt.restore(d, state, device="cpu")
    assert int(restored["step"]) == int(state["step"])
    with pytest.raises(ValueError, match="leaf count"):
        tckpt.restore(d, {"x": state["step"]}, device="cpu")
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), state, device="cpu")


def test_bfloat16_leaves_round_trip_bit_for_bit(tmp_path):
    """arctic's bfloat16 params: a port checkpoint restores its bits, and
    so does the reference's (``np.save`` writes bfloat16 as 2-byte
    voids)."""
    bits = np.array([0x3F80, 0xC2F7, 0x0001, 0x7F7F], np.uint16)
    t = {"w": torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)}
    tckpt.save(str(tmp_path / "p"), 1, t)
    got, _ = tckpt.restore(str(tmp_path / "p"), t, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), t["w"].view(torch.int16))
    jckpt.save(str(tmp_path / "r"), 1, {"w": jnp.asarray(
        convert.lm_params_to_numpy(t)["w"])})
    got, _ = tckpt.restore(str(tmp_path / "r"), t, device="cpu")
    assert torch.equal(got["w"].view(torch.int16), t["w"].view(torch.int16))


# --------------------------------------------------------------------------
# the launch.train CLI
# --------------------------------------------------------------------------

def _cli(*argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tlaunch.main(list(argv))
    return out.getvalue()


CLI = ("--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--seq-len",
       "16", "--batch", "2", "--ckpt-every", "2", "--log-every", "2")


def test_train_cli_runs_and_resumes_to_the_uninterrupted_state(tmp_path):
    """``--smoke --device cpu`` for 6 steps (checkpoints at 2, 4 and 6);
    then ``--resume`` from a copy holding only its step-4 checkpoint: the
    step-6 checkpoint equals the uninterrupted run's, the data cursor
    restored from the manifest."""
    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    out = _cli(*CLI, "--steps", "6", "--ckpt-dir", whole)
    assert "step     6  loss" in out and "done: 6 steps" in out
    assert tckpt.latest_step(whole) == 6
    os.makedirs(parts)
    shutil.copytree(os.path.join(whole, "step_000000004"),
                    os.path.join(parts, "step_000000004"))
    with open(os.path.join(parts, "LATEST"), "w") as f:
        f.write("step_000000004")
    _, extra = tckpt.restore(parts, _cli_template(), device="cpu")
    assert extra == {"pipeline": {"cursor": 4, "seed": 0, "host_id": 0,
                                  "num_hosts": 1}}
    out = _cli(*CLI, "--steps", "6", "--ckpt-dir", parts, "--resume")
    assert "resumed from step 4" in out and "done: 2 steps" in out
    assert tckpt.latest_step(parts) == 6
    for i in range(len(os.listdir(os.path.join(whole, "step_000000006",
                                               "arrays")))):
        a, b = (np.load(os.path.join(d, "step_000000006", "arrays",
                                     f"{i}.npy")) for d in (whole, parts))
        np.testing.assert_array_equal(a, b)
    assert os.path.exists(os.path.join(parts, "heartbeat_00000"))


def _cli_template():
    """The smoke CLI's train state (its checkpoint template)."""
    cfg = tspecs.model_cfg_for("qwen2-1.5b", smoke=True)
    tcfg = tspecs.train_cfg_for("qwen2-1.5b")
    opt = ttrain.get_optimizer(tcfg.optimizer)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return ttrain.init_state(cfg, tcfg, opt, params)


def test_train_cli_raises_without_a_card_and_on_a_mesh(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "1",
                      "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="model-axis"):
        tlaunch.main([*CLI, "--steps", "1", "--model-axis", "2",
                      "--ckpt-dir", str(tmp_path)])
    tckpt.save(str(tmp_path), 1, {"x": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tckpt.restore(str(tmp_path), {"x": torch.zeros(1)})
