"""The port's sharding policy (``repro_torch.launch.sharding``,
``repro_torch.launch.mesh``, ``repro_torch.models.sharding_ctx``) against
the reference's, spec for spec.

Pure spec logic first: the twins of ``tests/test_sharding.py``'s policy
cases, then every arch's param / state / cache / batch / activation
specs equal to the reference's leaf for leaf on the reference's stand-in
meshes (SINGLE 16 x 16, MULTI 2 x 16 x 16) and a 2 x 2, with the
expert-parallel, sequence-parallel and all-to-all levers.  The reference
builds its ``NamedSharding`` s over a device-free ``AbstractMesh`` of
the same shape.  Last, ``placements`` and ``constrain`` on a 4-rank
``DeviceMesh`` over a fake process group in this process (destroyed
after each case).
"""

import types

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import list_archs, SHAPES
from repro.launch import sharding as rshd
from repro.models import init_cache as rinit_cache
from repro.models import init_params as rinit_params
from repro.train import TrainCfg as RTrainCfg
from repro.train import get_optimizer as rget_optimizer
from repro.train import init_state as rinit_state

from repro_torch.launch import sharding as tshd
from repro_torch.launch.mesh import axis_size, batch_axes
from repro_torch.launch.specs import model_cfg_for
from repro_torch.models import init_cache as tinit_cache
from repro_torch.models import init_params as tinit_params
from repro_torch.models import sharding_ctx
from repro_torch.train import TrainCfg as TTrainCfg
from repro_torch.train import get_optimizer as tget_optimizer
from repro_torch.train import init_state as tinit_state


class FakeMesh(types.SimpleNamespace):
    """Just axis_names + shape -- enough for the spec builders."""


SINGLE = FakeMesh(axis_names=("data", "model"),
                  shape={"data": 16, "model": 16})
MULTI = FakeMesh(axis_names=("pod", "data", "model"),
                 shape={"pod": 2, "data": 16, "model": 16})
TWO = FakeMesh(axis_names=("data", "model"), shape={"data": 2, "model": 2})
MESHES = {"single": SINGLE, "multi": MULTI, "2x2": TWO}


def _abstract(mesh):
    return AbstractMesh(tuple(mesh.shape[a] for a in mesh.axis_names),
                        mesh.axis_names)


def _ref_cfg(arch):
    from repro.launch.specs import model_cfg_for as rmodel_cfg_for
    return rmodel_cfg_for(arch)


def _ref_keyed(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), l) for p, l in flat]


def _ref_param_shapes(arch):
    cfg = _ref_cfg(arch)
    return cfg, jax.eval_shape(lambda k: rinit_params(cfg, k),
                               jax.ShapeDtypeStruct((2,), jnp.uint32))


# ----------------------------------------------------------------------
# twins of tests/test_sharding.py
# ----------------------------------------------------------------------

def test_attention_weights_fsdp_x_tp():
    cfg = model_cfg_for("qwen2-1.5b")
    spec = tshd.param_pspec(cfg, SINGLE, "['blocks'][0]['attn']['wq']", 3,
                            (28, 1536, 1536))
    assert spec == (None, "data", "model")
    spec = tshd.param_pspec(cfg, SINGLE, "['blocks'][0]['attn']['wo']", 3,
                            (28, 1536, 1536))
    assert spec == (None, "model", "data")


def test_embed_vocab_sharded():
    cfg = model_cfg_for("gemma2-27b")
    assert tshd.param_pspec(cfg, SINGLE, "['embed']", 2,
                            (256000, 4608)) == ("model", "data")


def test_indivisible_dims_stay_replicated():
    cfg = model_cfg_for("qwen2-1.5b")
    assert tshd.param_pspec(cfg, SINGLE, "['blocks'][0]['attn']['wq']", 2,
                            (10, 1536)) == (None, "model")


def test_arctic_experts_sharded_over_model():
    cfg = model_cfg_for("arctic-480b")          # 128 experts >= 16
    spec = tshd.param_pspec(cfg, SINGLE, "['blocks'][0]['moe']['w_gate']",
                            4, (35, 128, 7168, 4864))
    assert spec == (None, "model", "data", None)


def test_mixtral_experts_tp_within_expert():
    cfg = model_cfg_for("mixtral-8x7b")         # 8 experts < 16
    spec = tshd.param_pspec(cfg, SINGLE, "['blocks'][0]['moe']['w_gate']",
                            4, (32, 8, 4096, 14336))
    assert spec == (None, None, "data", "model")


def test_norm_scales_replicated():
    cfg = model_cfg_for("qwen2-1.5b")
    assert tshd.param_pspec(cfg, SINGLE, "['blocks'][0]['ln1']['scale']", 2,
                            (28, 1536)) == (None, None)


def test_batch_spec_divisibility():
    assert tshd._batch_spec(SINGLE, 256) == ("data",)
    assert tshd._batch_spec(MULTI, 256) == ("pod", "data")
    assert tshd._batch_spec(MULTI, 2) == ("pod",)
    assert tshd._batch_spec(SINGLE, 1) == ()
    assert tshd._batch_spec(MULTI, 32) == ("pod", "data")
    for mesh in MESHES.values():
        for gb in (1, 2, 4, 32, 128, 256):
            assert tshd._batch_spec(mesh, gb) == \
                rshd._batch_spec(_abstract(mesh), gb)


def test_every_arch_has_lowerable_spec_table():
    """Param specs are constructible for every arch's full config (meta
    params: nothing allocated), of the leaf's rank, and every sharded
    dim divides."""
    for arch in list_archs():
        cfg = model_cfg_for(arch)
        leaves, _ = tshd.keyed_leaves(tinit_params(cfg, None, "meta"))
        for path, leaf in leaves:
            spec = tshd.param_pspec(cfg, SINGLE, path, leaf.ndim,
                                    tuple(leaf.shape))
            assert len(spec) == leaf.ndim
            for dim, ax in zip(leaf.shape, spec):
                if ax is not None:
                    assert dim % SINGLE.shape[ax] == 0, (arch, path)


def test_mesh_helpers_match_the_reference():
    from repro.launch.mesh import axis_size as raxis_size
    from repro.launch.mesh import batch_axes as rbatch_axes
    for mesh in MESHES.values():
        am = _abstract(mesh)
        assert batch_axes(mesh) == rbatch_axes(am)
        for a in ("pod", "data", "model", "nope"):
            assert axis_size(mesh, a) == raxis_size(am, a)


# ----------------------------------------------------------------------
# every arch, leaf for leaf
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_reference(arch):
    """Same keystr paths in the same order, and the same spec per leaf,
    on every mesh with expert parallelism off and on; ``param_shardings``
    carries the same specs."""
    rcfg, shapes = _ref_param_shapes(arch)
    tcfg = model_cfg_for(arch)
    meta = tinit_params(tcfg, None, "meta")
    tleaves, _ = tshd.keyed_leaves(meta)
    rleaves = _ref_keyed(shapes)
    assert [p for p, _ in tleaves] == [p for p, _ in rleaves]
    for name, mesh in MESHES.items():
        for ep in (False, True):
            tsh = tshd.param_shardings(tcfg, mesh, meta, moe_ep=ep)
            tflat, _ = tshd.keyed_leaves(tsh)
            for (path, leaf), (_, sh) in zip(rleaves, tflat):
                ref = rshd.param_pspec(rcfg, mesh, path, len(leaf.shape),
                                       leaf.shape, moe_ep=ep)
                assert sh.spec == tuple(ref), (name, ep, path)
                assert sh.mesh is mesh


@pytest.mark.parametrize("arch", list_archs())
def test_activation_specs_equal_reference(arch):
    rcfg, tcfg = _ref_cfg(arch), model_cfg_for(arch)
    for name, mesh in MESHES.items():
        for sp in (False, True):
            for a2a in (False, True):
                ref = rshd.activation_specs(rcfg, _abstract(mesh),
                                            seq_parallel=sp,
                                            moe_alltoall=a2a)
                got = tshd.activation_specs(tcfg, mesh, seq_parallel=sp,
                                            moe_alltoall=a2a)
                assert sorted(got) == sorted(ref), (name, sp, a2a)
                for tag in ref:
                    assert got[tag].spec == tuple(ref[tag].spec), \
                        (name, sp, a2a, tag)


@pytest.mark.parametrize("arch", list_archs())
def test_cache_and_batch_specs_equal_reference(arch):
    """Cache specs at every decode / prefill shape's (batch, length),
    batch specs at every shape's batch, on every mesh."""
    rcfg, tcfg = _ref_cfg(arch), model_cfg_for(arch)
    cases = sorted({(s.global_batch, s.seq_len) for s in SHAPES.values()
                    if s.kind != "train"} | {(2, 64), (1, 4096)})
    for B, S in cases:
        if rcfg.family == "vlm":
            S += rcfg.num_patches
        rc = jax.eval_shape(lambda: rinit_cache(rcfg, B, S))
        tc = tinit_cache(tcfg, B, S, "meta")
        rleaves = _ref_keyed(rc)
        tleaves, _ = tshd.keyed_leaves(tshd.cache_shardings(tcfg, SINGLE,
                                                            tc))
        assert len(rleaves) == len(tleaves)
        for name, mesh in MESHES.items():
            ref = _ref_keyed(rshd.cache_shardings(rcfg, _abstract(mesh), rc))
            got, _ = tshd.keyed_leaves(tshd.cache_shardings(tcfg, mesh, tc))
            for (rp, rs), (tp, ts) in zip(ref, got):
                assert rp == tp
                assert ts.spec == tuple(rs.spec), (name, B, S, rp)
    from repro.launch.specs import _batch_struct
    from repro_torch.launch.specs import batch_struct
    for s in SHAPES.values():
        rb = _batch_struct(rcfg, s.kind, s.seq_len, s.global_batch)
        tb = {k: torch.empty(shp, dtype=dt, device="meta") for k, (shp, dt)
              in batch_struct(tcfg, s.kind, s.seq_len,
                              s.global_batch).items()}
        for name, mesh in MESHES.items():
            ref = dict(_ref_keyed(rshd.batch_shardings(rcfg,
                                                       _abstract(mesh), rb)))
            got, _ = tshd.keyed_leaves(tshd.batch_shardings(tcfg, mesh, tb))
            assert sorted(p for p, _ in got) == sorted(ref)
            for p, sh in got:
                assert sh.spec == tuple(ref[p].spec), (name, s.name, p)


@pytest.mark.parametrize("arch", list_archs())
def test_state_specs_equal_reference(arch):
    """Train-state specs for adamw, adafactor and lion (and the
    error-feedback residuals), with expert parallelism off and on."""
    rcfg, shapes = _ref_param_shapes(arch)
    tcfg = model_cfg_for(arch)
    meta = tinit_params(tcfg, None, "meta")
    for opt_name in ("adamw", "adafactor", "lion"):
        ropt, topt = rget_optimizer(opt_name), tget_optimizer(opt_name)
        rt, tt = RTrainCfg(compress_grads=True), \
            TTrainCfg(compress_grads=True)
        rstate = jax.eval_shape(lambda p: rinit_state(rcfg, rt, ropt, p),
                                shapes)
        tstate = tinit_state(tcfg, tt, topt, meta)
        rleaves = _ref_keyed(rstate)
        for name, mesh in MESHES.items():
            for ep in (False, True):
                am = _abstract(mesh)
                ref = _ref_keyed(rshd.state_shardings(
                    rcfg, am, rstate,
                    rshd.param_shardings(rcfg, am, shapes, moe_ep=ep),
                    moe_ep=ep))
                got, _ = tshd.keyed_leaves(tshd.state_shardings(
                    tcfg, mesh, tstate, moe_ep=ep))
                assert [p for p, _ in got] == [p for p, _ in rleaves]
                for (rp, rs), (tp, ts) in zip(ref, got):
                    assert ts.spec == tuple(rs.spec), (opt_name, name, ep,
                                                       rp)


# ----------------------------------------------------------------------
# placements and constrain on a DeviceMesh (fake process group)
# ----------------------------------------------------------------------

@pytest.fixture
def fake_mesh():
    from repro_torch.launch.mesh import fake_world, make_mesh
    with fake_world(4):
        yield make_mesh((2, 2), ("data", "model"), "cpu")


@pytest.mark.parametrize("walk", ["flatten", "unflatten", "flatten_up_to",
                                  "tree_map", "keyed_leaves", "place_tree"])
def test_a_dropped_tree_frees_its_tensors_at_once(walk, fake_mesh):
    """No walk over a tree keeps its leaves in a reference cycle: with the
    cyclic collector off, a tree the caller drops is freed at once (a
    self-calling closure held every leaf it collected, so on the card a
    rank's whole params stayed allocated after ``place_tree`` until the
    collector ran)."""
    import gc
    import weakref
    from repro_torch.train import tree as T
    cfg = model_cfg_for("qwen2-1.5b", smoke=True)
    sh = tshd.param_shardings(cfg, fake_mesh, tinit_params(cfg, None, "meta"))
    # torch keeps the frame of a process's first distribute_tensor call
    tshd.place_tree(tinit_params(cfg, torch.Generator().manual_seed(1),
                                 "cpu"), sh)
    gc.disable()
    try:
        params = tinit_params(cfg, torch.Generator().manual_seed(0), "cpu")
        refs = [weakref.ref(t) for t in T.flatten(params)[0]]
        leaves, structure = T.flatten(params)
        out = {"flatten": lambda: T.flatten(params),
               "unflatten": lambda: T.unflatten(structure, leaves),
               "flatten_up_to": lambda: T.flatten_up_to(structure, params),
               "tree_map": lambda: T.tree_map(torch.neg, params),
               "keyed_leaves": lambda: tshd.keyed_leaves(params),
               "place_tree": lambda: tshd.place_tree(params, sh)}[walk]()
        del params, leaves, out
        assert sum(r() is not None for r in refs) == 0
    finally:
        gc.enable()


def test_placements_on_a_4_rank_mesh(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard
    m = fake_mesh
    assert tshd.placements(m, (None, "data", "model")) == (Shard(1),
                                                          Shard(2))
    assert tshd.placements(m, ("model", "data")) == (Shard(1), Shard(0))
    assert tshd.placements(m, ()) == (Replicate(), Replicate())
    assert tshd.placements(m, ("model", None)) == (Replicate(), Shard(0))
    assert tshd.placements(m, (("data", "model"), None)) == (Shard(0),
                                                             Shard(0))
    with pytest.raises(ValueError, match="mesh order"):
        tshd.placements(m, (("model", "data"),))
    # rank 0 holds the first of four data-major row blocks
    from repro_torch.launch.sharding import NamedSharding, place_tree
    t = place_tree({"x": torch.arange(32.).reshape(8, 4)},
              {"x": NamedSharding(m, (("data", "model"), None))})["x"]
    assert torch.equal(t.to_local(), torch.arange(8.).reshape(2, 4))
    assert tshd.local_numel((8, 4), (("data", "model"), None), m) == 8
    assert axis_size(m, "data") == 2 and batch_axes(m) == ("data",)


def test_constrain_is_the_identity_without_a_policy(fake_mesh):
    x = torch.randn(4, 3)
    sharding_ctx.set_policy(None)
    for tag in ("btd", "res", "btv", "moe_ecd"):
        assert sharding_ctx.constrain(x, tag) is x
    specs = tshd.activation_specs(model_cfg_for("qwen2-1.5b"), fake_mesh)
    with sharding_ctx.policy(specs):
        # a plain tensor has nothing to move
        assert sharding_ctx.constrain(x, "res") is x
        from torch.distributed.tensor import Replicate, Shard, \
            distribute_tensor
        d = distribute_tensor(torch.randn(4, 2, 3), fake_mesh,
                              [Replicate(), Replicate()],
                              src_data_rank=None)
        r = sharding_ctx.constrain(d, "btd")
        assert r.placements == (Shard(0), Replicate())
        assert sharding_ctx.constrain(d, "no-such-tag") is d
    assert sharding_ctx.get_policy() == {}
