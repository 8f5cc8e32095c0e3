"""The port's mesh paths, one process per rank.

Four ranks of a gloo process group on the CPU (``spawn`` start method,
a ``FileStore`` under ``tmp_path``, so no port is taken; the spawn kills
its ranks and fails after its own time limit) run, in one spawn:

* (a) ``distributed_fit`` / ``cluster(engine="distributed")`` with
  ``mesh=`` a 2 x 2 ``DeviceMesh`` on three scenarios, held raw to the
  in-process 4-shard loop (``n_shards=4, device="cpu"``) and to the
  reference's ``shard_map`` fit on a 4-device host mesh (a subprocess
  with ``--xla_force_host_platform_device_count=4``, as
  ``tests/test_torch_dist.py`` runs it); every rank returns the same
  result, and a tiny-caps fit retries the same trail on every rank;
* (b) ``moe_forward_shardmap`` / ``moe_forward_shardmap_ep`` at the
  reference's four mesh checks (``tests/test_distributed.py``), held to
  ``moe_forward_dense_fallback`` and to the reference's ``shard_map``
  output at 1e-4, and ``moe_forward``'s dispatch to them;
* (c) the FSDP train step on 2 x 2 against the single-process step on
  the reference's data-parallel parity case, and ``launch.train
  --model-axis 2``;
* (d) in this process, the dry run's mesh modes over a fake group.

The same inputs reach both packages from numpy seeds.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESH_SCENARIOS = ("cross-slab-2d", "cross-slab-3d", "blobs-2d")
FIELDS = ("labels", "core", "point_grid", "shard_of", "cut_coords")
MOE_CASES = ((4, (2, 2), "moe_forward_shardmap"),    # experts over model
             (2, (1, 4), "moe_forward_shardmap"),    # virtual experts
             (4, (2, 2), "moe_forward_shardmap_ep"),  # expert-parallel a2a
             (8, (2, 2), "moe_forward_shardmap_ep"))
CLI = ("--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--seq-len",
       "16", "--batch", "8", "--steps", "2", "--ckpt-every", "2",
       "--log-every", "1")
SPAWN_TIMEOUT = 400


# --------------------------------------------------------------------------
# inputs, the same on every rank and in the reference
# --------------------------------------------------------------------------

def _moe_inputs(E):
    """Router, expert weights and x [4, 8, 32] for the reference's MoE
    mesh check config (d 32, ff 64, top-2, capacity factor 16)."""
    rng = np.random.default_rng(100 + E)
    d, ff = 32, 64
    p = {"router": rng.normal(0, 0.2, (d, E)),
         "w_gate": rng.normal(0, d ** -0.5, (E, d, ff)),
         "w_up": rng.normal(0, d ** -0.5, (E, d, ff)),
         "w_down": rng.normal(0, ff ** -0.5, (E, ff, d))}
    x = rng.normal(size=(4, 8, d))
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


def _moe_cfg(E):
    from repro_torch.models.config import LMConfig, MoECfg
    return LMConfig(name="t", family="moe", num_layers=1, d_model=32,
                    num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
                    vocab_size=64, dtype="float32",
                    moe=MoECfg(num_experts=E, top_k=2, d_ff=64,
                               capacity_factor=16.0))


def _tiny_caps():
    from repro_torch.core.device_dbscan import GritCaps
    from repro_torch.dist import ClusterCaps
    return ClusterCaps(grit=GritCaps(grid_cap=8, frontier_cap=8, k_cap=4,
                                     c_cap=16, m_cap=8, pair_cap=16,
                                     grid_block=8, pair_block=16),
                       halo_cap=4)


def _train_case():
    """The reference's data-parallel parity case: qwen1.5-0.5b smoke,
    float32, remat off, adamw without weight decay, lr 1e-3, one
    TokenPipeline batch [8, 17]."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.specs import model_cfg_for
    from repro_torch.models import init_params
    from repro_torch.train import TrainCfg, get_optimizer
    cfg = model_cfg_for("qwen1.5-0.5b", smoke=True).with_overrides(
        dtype="float32", remat=False)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pipe = TokenPipeline(cfg.vocab_size, 16, 8, seed=0)
    batch = {"tokens": torch.as_tensor(
        pipe.next_batch()["tokens"]).to(torch.int32)}
    return cfg, TrainCfg(), get_optimizer("adamw", weight_decay=0.0), \
        params, batch


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _rank_work(rank, world, dev, ckpt_dir):
    """Everything one rank runs; returns its results."""
    torch.set_num_threads(2)
    from repro_torch.data.scenarios import get_scenario
    from repro_torch.dist import ClusterCaps, census_halo_cap, \
        distributed_fit
    from repro_torch.engine import cluster, estimate_shard_caps
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import moe as M
    from repro_torch.models import sharding_ctx
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.tree import flatten

    mesh = make_host_mesh(2, "cpu")
    out = {"coord": list(mesh.get_coordinate())}
    # a ("data", "model")-sharded dim is data-major
    t = shd.place_tree({"x": torch.arange(32.).reshape(8, 4)},
                  {"x": shd.NamedSharding(mesh, (("data", "model"), None))})
    out["rows"] = t["x"].to_local().numpy()

    # (a) the fit
    for name in MESH_SCENARIOS:
        sc = get_scenario(name)
        pts = sc.points()
        caps = ClusterCaps(grit=estimate_shard_caps(pts, sc.eps, sc.min_pts,
                                                    4),
                           halo_cap=census_halo_cap(pts, sc.eps, 4))
        r = distributed_fit(pts, sc.eps, sc.min_pts, caps=caps, mesh=mesh,
                            device=dev)
        out[name] = {f: getattr(r, f) for f in FIELDS}
        out[name]["report"] = r.report.as_vector().numpy()
        res = cluster(pts, sc.eps, sc.min_pts, engine="distributed",
                      mesh=mesh, device=dev)
        out[name]["engine"] = (res.labels, res.stats["n_shards"],
                               res.overflow)
    sc = get_scenario("cross-slab-2d")
    res = cluster(sc.points(), sc.eps, sc.min_pts, engine="distributed",
                  mesh=mesh, device=dev, caps=_tiny_caps())
    out["tiny"] = (res.labels, res.core,
                   [(a["overflow"], a["caps"]) for a in res.attempts])

    # (b) the MoE variants, and moe_forward's dispatch
    out["moe"] = []
    for E, shape, fn in MOE_CASES:
        m = make_mesh(shape, ("data", "model"), "cpu")
        p, x = _moe_inputs(E)
        p = {k: torch.from_numpy(v) for k, v in p.items()}
        nd = shape[0]
        r = m.get_local_rank("data")
        xb = torch.from_numpy(x)[r * 4 // nd:(r + 1) * 4 // nd]
        y, aux = getattr(M, fn)(_moe_cfg(E), p, xb, m, ("data",), "model")
        sharding_ctx.set_shardmap_moe((m, ("data",), "model"))
        try:
            y2, aux2 = M.moe_forward(_moe_cfg(E), p, xb)
        finally:
            sharding_ctx.set_shardmap_moe(None)
        out["moe"].append((y.numpy(), float(aux), y2.numpy(), float(aux2)))

    # (c) the FSDP step, then the CLI
    cfg, tcfg, opt, params, batch = _train_case()
    step = make_train_step(cfg, tcfg, opt, lambda s: 1e-3, mesh=mesh)
    state = init_state(cfg, tcfg, opt, params)
    state = shd.place_tree(state, shd.state_shardings(cfg, mesh, state))
    placed = shd.place_tree(batch, shd.batch_shardings(cfg, mesh, batch))
    local = [l.to_local().shape for l in flatten(state["params"])[0]]
    state, metrics = step(state, placed)
    out["train"] = (float(metrics["loss"]), int(state["step"]),
                    [l.numpy() for l in flatten(
                        shd.gather_tree(state["params"]))[0]], local)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tlaunch.main([*CLI, "--model-axis", "2", "--ckpt-dir", ckpt_dir])
    out["cli"] = buf.getvalue()
    return out


_REF_SNIPPET = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.data.scenarios import get_scenario
from repro.dist import ClusterCaps, census_halo_cap, distributed_fit
from repro.engine import estimate_shard_caps
from repro.models.config import LMConfig, MoECfg
from repro.models import moe as M

assert jax.device_count() == 4, jax.device_count()
out = {}
mesh = jax.make_mesh((4,), ("shard",))
for name in sys.argv[2].split(","):
    sc = get_scenario(name)
    pts = sc.points()
    caps = ClusterCaps(grit=estimate_shard_caps(pts, sc.eps, sc.min_pts, 4),
                       halo_cap=census_halo_cap(pts, sc.eps, 4))
    r = distributed_fit(pts, sc.eps, sc.min_pts, mesh, caps=caps)
    for f in ("labels", "core", "point_grid", "shard_of", "cut_coords"):
        out[name + "." + f] = np.asarray(getattr(r, f))
    out[name + ".report"] = np.asarray(r.report.as_vector())
inp = np.load(sys.argv[3])
for i, (E, shape, fn) in enumerate(%r):
    cfg = LMConfig(name="t", family="moe", num_layers=1, d_model=32,
                   num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
                   vocab_size=64, dtype="float32",
                   moe=MoECfg(num_experts=E, top_k=2, d_ff=64,
                              capacity_factor=16.0))
    m = jax.make_mesh(shape, ("data", "model"))
    p = {k: jnp.asarray(inp[f"{i}.{k}"])
         for k in ("router", "w_gate", "w_up", "w_down")}
    x = jnp.asarray(inp[f"{i}.x"])
    f = getattr(M, fn)
    y, aux = jax.jit(lambda p, x: f(cfg, p, x, m, ("data",), "model"))(p, x)
    out[f"moe.{i}.y"] = np.asarray(y)
    out[f"moe.{i}.aux"] = np.asarray(aux)
np.savez(sys.argv[1], **out)
""" % (MOE_CASES,)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess and the four ranks, run side by side."""
    from repro_torch.launch.mesh import spawn_ranks
    tmp = tmp_path_factory.mktemp("mesh")
    inp = tmp / "moe_in.npz"
    arrays = {}
    for i, (E, _, _) in enumerate(MOE_CASES):
        p, x = _moe_inputs(E)
        arrays.update({f"{i}.{k}": v for k, v in p.items()})
        arrays[f"{i}.x"] = x
    np.savez(inp, **arrays)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC
    ref_out = tmp / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REF_SNIPPET), str(ref_out),
         ",".join(MESH_SCENARIOS), str(inp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = spawn_ranks(_rank_work, 4, device="cpu",
                            args=(str(tmp / "ckpt_mesh"),),
                            timeout=SPAWN_TIMEOUT, workdir=str(tmp))
        _, err = proc.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return ranks, np.load(ref_out), tmp


# --------------------------------------------------------------------------
# (a) the fit
# --------------------------------------------------------------------------

def test_ranks_are_the_mesh_in_row_major_order(runs):
    ranks, _, _ = runs
    assert [r["coord"] for r in ranks] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(
            r["rows"], np.arange(32.).reshape(8, 4)[2 * i:2 * i + 2])


@pytest.mark.parametrize("name", MESH_SCENARIOS)
def test_mesh_fit_equals_the_shard_loop_raw(runs, name):
    """Every rank's result equals the in-process 4-shard loop's, raw,
    and so every rank returns the same result."""
    from repro_torch.data.scenarios import get_scenario
    from repro_torch.dist import ClusterCaps, census_halo_cap, \
        distributed_fit
    from repro_torch.engine import estimate_shard_caps
    ranks, _, _ = runs
    sc = get_scenario(name)
    pts = sc.points()
    caps = ClusterCaps(grit=estimate_shard_caps(pts, sc.eps, sc.min_pts, 4),
                       halo_cap=census_halo_cap(pts, sc.eps, 4))
    loop = distributed_fit(pts, sc.eps, sc.min_pts, caps=caps, n_shards=4,
                           device="cpu")
    for r in ranks:
        for f in FIELDS:
            np.testing.assert_array_equal(r[name][f], getattr(loop, f),
                                          err_msg=f)
            assert r[name][f].dtype == getattr(loop, f).dtype
        np.testing.assert_array_equal(r[name]["report"],
                                      loop.report.as_vector().numpy())
    assert len(np.unique(loop.shard_of)) == 4


@pytest.mark.parametrize("name", MESH_SCENARIOS)
def test_mesh_fit_equals_reference_on_a_4_device_mesh(runs, name):
    ranks, ref, _ = runs
    for r in ranks:
        for f in FIELDS:
            np.testing.assert_array_equal(ref[f"{name}.{f}"], r[name][f],
                                          err_msg=f)
        np.testing.assert_array_equal(ref[f"{name}.report"],
                                      r[name]["report"])
    if name.startswith("cross-slab"):
        r = ranks[0][name]
        assert len(set(r["labels"][r["core"]].tolist())) == 1


@pytest.mark.parametrize("name", MESH_SCENARIOS)
def test_distributed_engine_on_a_mesh_equals_the_loop(runs, name):
    from repro_torch.data.scenarios import get_scenario
    from repro_torch.engine import cluster
    ranks, _, _ = runs
    sc = get_scenario(name)
    loop = cluster(sc.points(), sc.eps, sc.min_pts, engine="distributed",
                   n_shards=4, device="cpu")
    for r in ranks:
        labels, n_shards, overflow = r[name]["engine"]
        np.testing.assert_array_equal(labels, loop.labels)
        assert n_shards == 4 and overflow == ()


def test_tiny_caps_retry_in_lockstep(runs):
    """Every rank grows the caps on the same all-reduced report, so the
    retry trail is the same on every rank and equals the loop's."""
    from repro_torch.data.scenarios import get_scenario
    from repro_torch.engine import cluster
    ranks, _, _ = runs
    sc = get_scenario("cross-slab-2d")
    loop = cluster(sc.points(), sc.eps, sc.min_pts, engine="distributed",
                   n_shards=4, device="cpu", caps=_tiny_caps())
    trail = [(a["overflow"], a["caps"]) for a in loop.attempts]
    assert len(trail) > 1 and trail[-1][0] == ()
    for r in ranks:
        labels, core, got = r["tiny"]
        assert got == trail
        np.testing.assert_array_equal(labels, loop.labels)
        np.testing.assert_array_equal(core, loop.core)


# --------------------------------------------------------------------------
# (b) the MoE variants
# --------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(MOE_CASES)),
                         ids=[f"{fn}-E{E}-{s[0]}x{s[1]}"
                              for E, s, fn in MOE_CASES])
def test_shardmap_moe_matches_dense_and_reference(runs, i):
    """The batch blocks of the data ranks, stacked, equal the dense
    oracle and the reference's shard_map output at 1e-4; the model
    ranks of a block agree bit for bit, the aux loss is the same on
    every rank, and ``moe_forward`` under ``set_shardmap_moe`` gives
    the variant the reference's dispatch picks."""
    from repro_torch.models import moe as M
    ranks, ref, _ = runs
    E, shape, fn = MOE_CASES[i]
    p, x = _moe_inputs(E)
    y_dense, _ = M.moe_forward_dense_fallback(
        _moe_cfg(E), {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x))
    n_model = shape[1]
    blocks = [ranks[r]["moe"][i][0] for r in range(0, 4, n_model)]
    y = np.concatenate(blocks)
    assert np.abs(y - y_dense.numpy()).max() < 1e-4
    assert np.abs(y - ref[f"moe.{i}.y"]).max() < 1e-4
    for r in range(4):
        got, aux, y2, aux2 = ranks[r]["moe"][i]
        np.testing.assert_array_equal(got, blocks[r // n_model])
        assert aux == ranks[0]["moe"][i][1]
        assert abs(aux - float(ref[f"moe.{i}.aux"])) < 1e-6
        # the reference dispatches E % n_data == 0 (n_data > 1) to _ep
        ep = shape[0] > 1 and E % shape[0] == 0
        if ep == (fn == "moe_forward_shardmap_ep"):
            np.testing.assert_array_equal(y2, got)
            assert aux2 == aux


# --------------------------------------------------------------------------
# (c) training on the mesh
# --------------------------------------------------------------------------

def test_mesh_train_step_matches_single_process(runs):
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.tree import flatten
    ranks, _, _ = runs
    cfg, tcfg, opt, params, batch = _train_case()
    step = make_train_step(cfg, tcfg, opt, lambda s: 1e-3)
    state, metrics = step(init_state(cfg, tcfg, opt, params), batch)
    ref = [l.numpy() for l in flatten(state["params"])[0]]
    for r in ranks:
        loss, steps, got, _ = r["train"]
        assert abs(loss - float(metrics["loss"])) < 1e-4
        assert steps == 1
        for a, b in zip(ref, got):
            np.testing.assert_allclose(b, a, rtol=2e-4, atol=1e-5)


def test_mesh_train_state_is_fsdp_x_tp_sharded(runs):
    """Each rank holds its shard of every param, as param_pspec lays it
    out on the 2 x 2 mesh."""
    import types

    from repro_torch.launch import sharding as shd
    ranks, _, _ = runs
    cfg, _, _, params, _ = _train_case()
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 2, "model": 2})
    leaves, _ = shd.keyed_leaves(params)
    want = []
    for path, leaf in leaves:
        spec = shd.param_pspec(cfg, mesh, path, leaf.ndim, tuple(leaf.shape))
        want.append(shd.local_numel(tuple(leaf.shape), spec, mesh))
    assert sum(want) < sum(l.numel() for _, l in leaves)
    for r in ranks:
        assert [int(np.prod(s)) for s in r["train"][3]] == want


def test_train_cli_on_a_2x2_mesh(runs, tmp_path):
    """``launch.train --model-axis 2`` on four ranks: rank 0 logs each
    step, its loss equals the single-process CLI's (bfloat16 smoke
    config) to 1e-2, and its checkpoint -- written from whole tensors --
    resumes in a single process."""
    from repro_torch.launch import train as tlaunch
    ranks, _, tmp = runs
    assert [bool(r["cli"]) for r in ranks] == [True, False, False, False]

    def losses(text):
        return [float(line.split()[3]) for line in text.splitlines()
                if line.startswith("step")]

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tlaunch.main([*CLI, "--ckpt-dir", str(tmp_path)])
    mesh_l, one_l = losses(ranks[0]["cli"]), losses(buf.getvalue())
    assert len(mesh_l) == len(one_l) == 2
    np.testing.assert_allclose(mesh_l, one_l, rtol=1e-2)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tlaunch.main([*("3" if a == "2" and CLI[i - 1] == "--steps" else a
                        for i, a in enumerate(CLI)),
                      "--resume", "--ckpt-dir", str(tmp / "ckpt_mesh")])
    assert "resumed from step 2" in buf.getvalue()
    assert "done: 1 steps" in buf.getvalue()


# --------------------------------------------------------------------------
# (d) the dry run's mesh modes
# --------------------------------------------------------------------------

def _param_bytes(arch, mesh, moe_ep):
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.specs import model_cfg_for
    from repro_torch.models import init_params
    cfg = model_cfg_for(arch)
    leaves, _ = shd.keyed_leaves(init_params(cfg, None, "meta"))
    return sum(shd.local_numel(tuple(l.shape), shd.param_pspec(
        cfg, mesh, p, l.ndim, tuple(l.shape), moe_ep=moe_ep), mesh)
        * l.element_size() for p, l in leaves)


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen2-1.5b", "--shape", "train_4k", "--mesh", "both"],
    ["--arch", "mixtral-8x7b", "--shape", "decode_32k", "--moe-alltoall"],
], ids=["qwen2-train-both", "mixtral-moe-alltoall"])
def test_dryrun_mesh_records(argv, tmp_path):
    import types
    out = tmp_path / "d.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
         "--device", "cpu", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = json.loads(out.read_text())
    want = ["16x16", "2x16x16"] if "both" in argv else ["16x16"]
    assert [r["mesh"] for r in recs] == want
    meshes = {"16x16": types.SimpleNamespace(
        axis_names=("data", "model"), shape={"data": 16, "model": 16}),
        "2x16x16": types.SimpleNamespace(
            axis_names=("pod", "data", "model"),
            shape={"pod": 2, "data": 16, "model": 16})}
    for r in recs:
        assert r["status"] == "ok"
        assert r["chips"] == (512 if r["mesh"] == "2x16x16" else 256)
        assert r["roofline"]["t_collective"] > 0
        assert r["param_bytes_per_rank"] == _param_bytes(
            argv[1], meshes[r["mesh"]], "--moe-alltoall" in argv)
        assert r["memory"]["argument_size"] >= r["param_bytes_per_rank"]


@pytest.mark.parametrize("make", ["make_mesh", "make_production_mesh",
                                  "make_host_mesh"])
def test_mesh_constructors_default_to_the_card_and_raise_without_one(
        make, monkeypatch):
    """``device=None`` is the card, as at every entry point: without one
    each constructor raises the port's error; with
    ``torch.cuda.is_available`` patched true it lays a ``"cuda"`` mesh
    (``DeviceMesh`` recorded, not built: no process group starts)."""
    import torch.distributed as dist
    import torch.distributed.device_mesh as dm
    from repro_torch.launch import mesh as M
    world = {"make_mesh": 4, "make_production_mesh": 256,
             "make_host_mesh": 4}[make]
    call = {"make_mesh": lambda **kw: M.make_mesh((2, 2), ("data", "model"),
                                                  **kw),
            "make_production_mesh": lambda **kw: M.make_production_mesh(**kw),
            "make_host_mesh": lambda **kw: M.make_host_mesh(2, **kw)}[make]
    made = []
    monkeypatch.setattr(dm, "DeviceMesh",
                        lambda kind, ranks, mesh_dim_names: made.append(
                            (kind, tuple(ranks.shape), mesh_dim_names)))
    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        assert made == []
    call(device="cpu")
    assert made[-1][0] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    call()
    assert made[-1][0] == "cuda"
    assert made[-1][1] == {4: (2, 2), 256: (16, 16)}[world]
    assert made[-1][2] == ("data", "model")
