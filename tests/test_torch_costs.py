"""The port's cost accountant (``repro_torch.launch.{costs,roofline,dryrun}``
and ``specs.build_cell``) on the CPU.

* Twins of ``tests/test_hlo_costs.py``'s seven cases on hand-counted
  programs: an eager loop dispatches every iteration, so a loop and its
  unrolled copy count alike and nested loops multiply.
* The reference as the yardstick: the dot FLOPs of each family's smoke
  prefill and decode (and of qwen2's and mixtral's train step), counted on
  the port's fake run of ``build_cell`` with the plain attention path,
  equal the dot FLOPs of the reference's own ``prefill`` / ``decode_step``
  / ``make_train_step`` compiled without shardings (``hlo_costs``'
  ``_dot_flops`` summed over ``parse_hlo`` / ``_exec_counts``) within 1 %,
  and ``FlopCounterMode``'s total exactly.  The train step is held at
  ``remat=False`` on both sides plus a hand count of what only the port
  recomputes: its CE chunks run under ``torch.utils.checkpoint`` (2·T·d·V
  again), where the reference's CE scan keeps its logits.  With remat on,
  the two remat policies differ (the reference's
  ``dots_with_no_batch_dims_saveable`` keeps the weight products; the
  port's checkpoint recomputes a whole group and stops after the last
  tensor the backward needs), which qwen2's hand count pins.
* Real CPU tensors and ``build_cell``'s fake tensors count alike; the
  CUDA kernels' operators count their formula on fake ``"cuda"`` tensors
  and launch nothing; the dry-run CLI.
"""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import train as jtrain
from repro.configs import get_config as jget_config
from repro.launch import hlo_costs
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro_torch.configs import ShapeCfg
from repro_torch.kernels import ops
from repro_torch.launch import costs, dryrun, roofline, specs
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.train import (get_optimizer, init_state, make_train_step,
                               warmup_cosine)

FAMILIES = ["qwen2-1.5b", "mixtral-8x7b", "zamba2-2.7b", "rwkv6-3b",
            "whisper-small", "internvl2-1b"]
BATCH, SEQ = 2, 16


# --------------------------------------------------------------------------
# twins of tests/test_hlo_costs.py
# --------------------------------------------------------------------------

def _xw(n=128):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(n, n, generator=g), torch.randn(n, n, generator=g))


def test_loop_matches_unroll():
    def f_loop(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x

    def f_unroll(x, w):
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        return torch.tanh(x @ w)

    a_l = costs.analyze(f_loop, *_xw())
    a_u = costs.analyze(f_unroll, *_xw())
    dot_flops = 10 * 2 * 128 ** 3
    assert abs(a_l["flops"] - dot_flops) / dot_flops < 0.05
    assert abs(a_u["flops"] - dot_flops) / dot_flops < 0.05
    assert 0.5 < a_l["bytes"] / a_u["bytes"] < 2.0


def test_nested_loops_multiply():
    def f(x, w):
        for _ in range(4):
            for _ in range(5):
                x = torch.tanh(x @ w)
        return x

    a = costs.analyze(f, *_xw())
    dot_flops = 20 * 2 * 128 ** 3
    assert abs(a["flops"] - dot_flops) / dot_flops < 0.05


def test_indexed_row_bytes_not_amplified():
    """Reading one [4096] row a step from a [64, 4096] stack (by a tensor
    index, the counterpart of ``dynamic_index_in_dim``) costs about 64
    rows in all, not 64 x the whole stack."""
    def f(stack):
        c = torch.zeros(4096)
        for i in range(64):
            c = c + stack[torch.tensor([i])][0]
        return c

    a = costs.analyze(f, torch.ones(64, 4096))
    stack_bytes = 64 * 4096 * 4
    assert a["bytes"] < 8 * stack_bytes
    assert a["ops"]["aten.index"]["calls"] == 64


def test_shape_bytes():
    assert roofline.shape_bytes((8, 128), torch.bfloat16) == 8 * 128 * 2
    assert roofline.shape_bytes((4,), torch.float32) == 16
    assert roofline.shape_bytes((16,), torch.bool) == 16
    assert roofline.shape_bytes((2, 2), torch.int64) == 32


def test_collective_bytes_on_synthetic_records():
    c = roofline.collective_bytes([("all-reduce", 4096, 4),
                                   ("all-gather", 16384, 4),
                                   ("collective-permute", 4096, 2)])
    assert c["all-reduce"] == 2 * 0.75 * 4096
    assert c["all-gather"] == 0.75 * 16384
    assert c["collective-permute"] == 4096
    assert c["total"] == 2 * 0.75 * 4096 + 0.75 * 16384 + 4096


def test_roofline_terms_dominance():
    r = roofline.roofline_terms(989e12, 0.0, 0.0)   # 1 s of bf16 compute
    assert r["dominant"] == "compute"
    assert r["compute_fraction"] == 1.0
    r = roofline.roofline_terms(989e10, 3.35e12, 0.0)
    assert r["dominant"] == "memory"
    assert r["bound"] == 1.0
    r = roofline.roofline_terms(0.0, 0.0, 450e9)
    assert r["dominant"] == "collective"
    # each class at its own peak: 67 TFLOP of float32 on the CUDA cores
    # take 1 s, the same operations on the bf16 tensor cores 1 / 14.76 s
    r = roofline.roofline_terms({"f32": 67e12, "bf16": 989e12}, 0.0, 0.0)
    assert r["t_compute"] == pytest.approx(2.0)


def test_accountant_sees_every_op_of_a_small_program():
    def f(x):
        for _ in range(3):
            x = x * 2.0
        return x.t().contiguous().view(-1)

    a = costs.analyze(f, torch.ones(8, 4))
    assert a["ops"]["aten.mul"]["calls"] == 3
    assert a["ops"]["aten.clone"]["calls"] == 1          # the contiguous copy
    assert not any(k in a["ops"] for k in ("aten.t", "aten.view"))
    assert a["flops"] == 3 * 32 + 32
    assert a["bytes"] == 4 * (3 * 2 * 32 + 2 * 32)
    assert a["coll_bytes"] == 0.0
    assert all(a[f"coll_{k}"] == 0.0 for k in roofline.COLLECTIVES)


def test_products_outside_flop_counter_count_as_dots():
    """``mv`` and the CPU's fused attention op are products too, though
    ``FlopCounterMode`` does not count them."""
    w, x = torch.ones(64, 32), torch.ones(32)
    a = costs.analyze(torch.mv, w, x)
    assert a["dot_flops"] == 2 * 64 * 32 and a["torch_flop_counter"] == 0
    q = torch.ones(2, 3, 40, 16)
    k, v = torch.ones(2, 3, 24, 16), torch.ones(2, 3, 24, 8)
    a = costs.analyze(torch.nn.functional.scaled_dot_product_attention,
                      q, k, v)
    assert a["dot_flops"] == 2 * 2 * 3 * 40 * 24 * (16 + 8)


def test_in_place_and_gather_bytes_count_what_they_touch():
    dst = torch.zeros(100, 8)
    src = torch.ones(10, 8)
    idx = torch.arange(10)
    a = costs.analyze(lambda: dst[:10].copy_(src))
    assert a["bytes"] == 2 * 10 * 8 * 4                 # src read, dst written
    a = costs.analyze(lambda: dst.index_add_(0, idx, src))
    # the source and index read, the touched rows read and written
    assert a["bytes"] == 10 * 8 * 4 + 10 * 8 + 2 * 10 * 8 * 4
    a = costs.analyze(lambda: dst.add_(1.0))
    assert a["bytes"] == 2 * 100 * 8 * 4
    a = costs.analyze(lambda: dst[idx])
    assert a["bytes"] == 2 * 10 * 8 * 4 + 10 * 8
    big = torch.ones(4, 1, 16).expand(4, 32, 16)
    a = costs.analyze(lambda: big + 1.0)
    assert a["bytes"] == 4 * 16 * 4 + 4 * 32 * 16 * 4   # the base read once


# --------------------------------------------------------------------------
# the reference as the yardstick
# --------------------------------------------------------------------------

def _reference_dots(arch, kind, overrides):
    """Dot FLOPs of the reference's own cell program, compiled with no
    shardings, summed as ``hlo_costs.analyze`` sums them."""
    cfg = jget_config(arch, smoke=True).with_overrides(**overrides)
    params = jax.eval_shape(lambda k: jlm.init_params(cfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    if kind == "train":
        tcfg = jspecs.train_cfg_for(arch)
        opt = jtrain.get_optimizer(tcfg.optimizer)
        fn = jtrain.make_train_step(cfg, tcfg, opt, jtrain.warmup_cosine(
            tcfg.peak_lr, tcfg.warmup_steps, tcfg.total_steps))
        args = (jax.eval_shape(lambda p: jtrain.init_state(cfg, tcfg, opt, p),
                               params),
                jspecs._batch_struct(cfg, "train", SEQ, BATCH))
    else:
        max_len = SEQ + (cfg.num_patches if cfg.family == "vlm" else 0)
        cache = jax.eval_shape(lambda: jlm.init_cache(cfg, BATCH, max_len))
        if kind == "prefill":
            def fn(p, b, c):
                return jlm.prefill(cfg, p, b, c)
            args = (params, jspecs._batch_struct(cfg, "prefill", SEQ, BATCH),
                    cache)
        else:
            def fn(p, t, c):
                return jlm.decode_step(cfg, p, t, c)
            args = (params, jax.ShapeDtypeStruct((BATCH,), jnp.int32), cache)
    comps = hlo_costs.parse_hlo(jax.jit(fn).lower(*args).compile().as_text())
    counts = hlo_costs._exec_counts(comps)
    total = 0.0
    for name, comp in comps.items():
        symbols = comp.symbol_shapes()
        total += counts.get(name, 0.0) * sum(
            hlo_costs._dot_flops(op, symbols) for op in comp.ops
            if op.kind == "dot")
    return total


def _port_count(arch, kind, overrides):
    fn, args, _ = specs.build_cell(arch, ShapeCfg("test", kind, SEQ, BATCH),
                                   device="cpu", overrides=overrides,
                                   smoke=True)
    return dryrun.count_cell(fn, args)[1]


def _ce_recompute(cfg):
    """The CE head's product once more: the port checkpoints each CE
    chunk under grad, the reference's CE scan keeps its logits."""
    return 2.0 * BATCH * SEQ * cfg.d_model * cfg.vocab_size


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_serving_dot_flops_equal_the_references(arch, kind):
    c = _port_count(arch, kind, {})
    want = _reference_dots(arch, kind, {})
    assert abs(c["dot_flops"] - want) <= 0.01 * want, (c["dot_flops"], want)
    assert c["dot_flops"] == c["torch_flop_counter"]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x7b"])
def test_train_dot_flops_equal_the_references_without_remat(arch):
    ov = {"remat": False}
    c = _port_count(arch, "train", ov)
    want = _reference_dots(arch, "train", ov) + _ce_recompute(
        specs.model_cfg_for(arch, smoke=True))
    assert abs(c["dot_flops"] - want) <= 0.01 * want, (c["dot_flops"], want)
    assert c["dot_flops"] == c["torch_flop_counter"]


def test_train_dot_flops_with_remat_by_hand():
    """qwen2 with remat (the default): the port also recomputes every
    weight product of a group (2·T·weights; the reference keeps them),
    except the group's last (``w_down``), after which checkpoint's
    recomputation stops."""
    cfg = specs.model_cfg_for("qwen2-1.5b", smoke=True)
    c = _port_count("qwen2-1.5b", "train", {})
    d, H, KV, Dh, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    T = BATCH * SEQ
    layer = d * H * Dh + 2 * d * KV * Dh + H * Dh * d + 3 * d * ff
    extra = 2.0 * T * cfg.num_layers * (layer - d * ff)
    want = _reference_dots("qwen2-1.5b", "train", {}) + extra \
        + _ce_recompute(cfg)
    assert abs(c["dot_flops"] - want) <= 0.01 * want, (c["dot_flops"], want)
    assert c["dot_flops"] == c["torch_flop_counter"]


# --------------------------------------------------------------------------
# real against fake, the kernels' operators, the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [
    ("qwen2-1.5b", "prefill"), ("qwen2-1.5b", "decode"),
    ("qwen2-1.5b", "train"), ("mixtral-8x7b", "train")])
def test_real_and_fake_runs_count_alike(arch, kind):
    """The accountant over a real CPU run and over ``build_cell``'s fake
    run of the same program: equal FLOPs (by class) and bytes."""
    cfg = specs.model_cfg_for(arch, smoke=True)
    fake = _port_count(arch, kind, {})
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    if kind == "train":
        tcfg = specs.train_cfg_for(arch)
        opt = get_optimizer(tcfg.optimizer)
        step = make_train_step(cfg, tcfg, opt, warmup_cosine(
            tcfg.peak_lr, tcfg.warmup_steps, tcfg.total_steps))
        state = init_state(cfg, tcfg, opt, params)
        batch = specs.train_batch(cfg, rng.integers(
            0, cfg.vocab_size, size=(BATCH, SEQ + 1)), "cpu")
        real = costs.analyze(step, state, batch)
    else:
        cache = init_cache(cfg, BATCH, SEQ, "cpu")
        if kind == "prefill":
            toks = rng.integers(0, cfg.vocab_size, size=(BATCH, SEQ))
            real = costs.analyze(prefill, cfg, params, {
                "tokens": torch.from_numpy(toks).to(torch.int32)}, cache)
        else:
            toks = rng.integers(0, cfg.vocab_size, size=(BATCH,))
            real = costs.analyze(decode_step, cfg, params,
                                 torch.from_numpy(toks).to(torch.int32), cache)
    for key in ("flops", "flops_by_class", "bytes", "dot_flops"):
        assert real[key] == fake[key], (key, real[key], fake[key])


def _live_pairs_brute(Sq, Sk, causal, window):
    qpos = np.arange(Sq)[:, None] + Sk - Sq
    kpos = np.arange(Sk)[None, :]
    live = np.ones((Sq, Sk), bool)
    if causal:
        live &= kpos <= qpos
    if window:
        live &= qpos - kpos < window
    return int(live.sum())


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (64, 64, True, None), (64, 64, True, 16), (48, 80, False, None),
    (80, 48, False, None), (24, 100, True, 40)])
def test_flash_operator_on_fake_cuda_tensors(Sq, Sk, causal, window):
    B, H, KV, D = 2, 4, 2, 64
    before = dict(ops.LAUNCHES)
    assert ops.live_pairs(Sq, Sk, causal, window) == \
        _live_pairs_brute(Sq, Sk, causal, window)
    with FakeTensorMode():
        q = torch.empty(B, H, Sq, D, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(B, KV, Sk, D, dtype=torch.bfloat16, device="cuda")
        out, c = costs.measure(ops.flash_attention, q, k, k, causal=causal,
                               window=window)
        assert out.shape == q.shape and out.dtype == q.dtype
        assert out.device.type == "cuda"
        with pytest.raises(ValueError, match="no backward"):
            ops.flash_attention(q.requires_grad_(True), k, k)
    pairs = _live_pairs_brute(Sq, Sk, causal, window)
    assert c["flops"] == c["kernel_flops"] == 4 * D * B * H * pairs
    assert c["flops_by_class"]["bf16"] == c["flops"]
    # q, k, v read once (k / v at their 2 heads), the output written once
    assert c["bytes"] == 2 * (2 * B * H * Sq * D + 2 * B * KV * Sk * D)
    assert c["ops"] == {"repro_torch.flash_attention": {
        "calls": 1, "flops": c["flops"], "bytes": c["bytes"]}}
    assert ops.LAUNCHES == before


def test_distance_operators_on_fake_cuda_tensors():
    B, M, N, d = 3, 5, 7, 3
    before = dict(ops.LAUNCHES)
    with FakeTensorMode():
        a = torch.empty(B, M, d, device="cuda")
        b = torch.empty(B, N, d, device="cuda")
        vb = torch.empty(B, N, dtype=torch.bool, device="cuda")
        va = torch.empty(B, M, dtype=torch.bool, device="cuda")
        a1 = torch.empty(M, d, device="cuda")
        b1 = torch.empty(N, d, device="cuda")

        def calls():
            return (ops.eps_count_batch(a, b, 1.0, vb, va, stop_at=3),
                    ops.row_min_batch(a, b, vb), ops.row_min2_batch(a, b, vb),
                    ops.eps_count_band_batch(a, b, 1.0, 2.0, vb),
                    ops.eps_count(a1, b1, 1.0), ops.row_min(a1, b1))

        outs, c = costs.measure(calls)
    assert [o.dtype for o in (outs[0], *outs[1], *outs[2], *outs[3])] == [
        torch.int32, torch.float32, torch.int32, torch.float32,
        torch.float32, torch.int32, torch.int32, torch.int32]
    assert outs[0].shape == (B, M) and outs[4].shape == (M,)
    slot = 3 * d * B * M * N
    for name in ("eps_count_batch", "row_min_batch", "row_min2_batch",
                 "eps_count_band_batch"):
        rec = c["ops"][f"repro_torch.{name}"]
        assert rec["calls"] == 1 and rec["flops"] == slot, name
    for name in ("eps_count", "row_min"):
        assert c["ops"][f"repro_torch.{name}"]["flops"] == 3 * d * M * N
    assert c["flops_by_class"]["f32"] >= c["kernel_flops"] == \
        4 * slot + 2 * 3 * d * M * N
    # a and b float32, the masks a byte an element, one int32 output
    assert c["ops"]["repro_torch.eps_count_batch"]["bytes"] == \
        4 * B * M * d + 4 * B * N * d + B * N + B * M + 4 * B * M
    assert ops.LAUNCHES == before


def test_dryrun_cli_decode_32k_on_the_cpu(tmp_path):
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                        "--device", "cpu", "--out", str(out)]) == 0
    (rec,) = json.loads(out.read_text())
    for key in ("arch", "shape", "mesh", "kind", "status", "chips",
                "lower_s", "compile_s", "flops_per_chip", "bytes_per_chip",
                "collective_bytes_per_chip", "torch_flop_counter", "memory",
                "roofline"):
        assert key in rec, key
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    assert rec["mesh"] == "1" and rec["chips"] == 1
    assert rec["collective_bytes_per_chip"] == {}
    assert set(rec["memory"]) == {"argument_size", "output_size",
                                  "temp_size", "generated_code_size"}
    assert set(rec["roofline"]) == {"t_compute", "t_memory", "t_collective",
                                    "dominant", "bound", "compute_fraction"}
    # a decode step reads the whole 32k-deep cache of 128 sequences
    cfg = specs.model_cfg_for("qwen2-1.5b")
    cache = 2 * cfg.num_layers * 128 * cfg.num_kv_heads * 32768 \
        * cfg.head_dim * 2
    assert rec["memory"]["argument_size"] > cache
    assert rec["bytes_per_chip"] > cache
    assert rec["roofline"]["dominant"] == "memory"


def test_dryrun_skips_long_500k_for_full_attention():
    rec = dryrun.run_cell("qwen2-1.5b", "long_500k", device="cpu")
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]


@pytest.mark.parametrize("flags", [["--mesh", "multi"], ["--mesh", "both"],
                                   ["--seq-parallel"], ["--moe-alltoall"],
                                   ["--cluster"]])
def test_dryrun_refuses_several_cards(flags, tmp_path, capsys):
    """The mesh flags count one rank of the production meshes over a
    fake process group (records ``mesh`` 16x16 / 2x16x16, collectives
    counted); ``--cluster`` counts rank 1 of the cluster step on 16x16
    (``--arch`` / ``--shape`` play no part in it)."""
    out = tmp_path / "d.json"
    rc = dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                      "--device", "cpu", "--out", str(out), *flags])
    assert rc == 0
    recs = json.loads(out.read_text())
    if flags == ["--cluster"]:
        (r,) = recs
        assert r["status"] == "ok" and r["kind"] == "cluster"
        assert r["mesh"] == "16x16" and r["chips"] == 256
        assert r["attempts"][-1] == []
        coll = r["collective_bytes_per_chip"]
        assert coll["collective-permute"] == r["sent"]["exchange"] > 0
        assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
        assert "grit-cluster-step x 16x16 bound=" in capsys.readouterr().out
        return
    want = {"multi": ["2x16x16"], "both": ["16x16", "2x16x16"]}.get(
        flags[-1], ["16x16"])
    assert [r["mesh"] for r in recs] == want
    for r in recs:
        assert r["status"] == "ok" and r["chips"] in (256, 512)
        assert r["collective_bytes_per_chip"]["all-gather"] > 0
        assert r["param_bytes_per_rank"] < r["memory"]["argument_size"]


def test_dryrun_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        specs.build_cell("qwen2-1.5b", "decode_32k")
