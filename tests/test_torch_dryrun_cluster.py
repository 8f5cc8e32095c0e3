"""The port's cluster dry run (``repro_torch.launch.dryrun --cluster``)
and the last public names of the reference, on the CPU.

* Parity: at the reference's static caps (``halo_cap`` 128) the port's
  counted rank-1 step moves, per chip, the ``collective-permute`` and
  ``all-gather`` bytes of the reference's compiled program
  (``repro.launch.dryrun --cluster``, run in a fresh process with 512
  host devices), on both production meshes, and its ``all-reduce``
  bytes too: the port ships the seven report flags as uint8, one byte a
  flag, as the reference ships bool.
* The record's own checks at the caps sized for its shard: the counted
  permute equals ``dist.comm.SENT["exchange"]``, an end rank counts half
  an inner rank's, the overflow trail ends clean, the halo ships live
  rows on both sides, the shard's core points equal ``core_flags``'.
* The CLI, and the contracts the count relies on: what the fake process
  group leaves in a receive and a gather, the accountant's count of
  ``c10d::send``, and the LM mesh records' collective bytes, pinned.
* ``configs.list_archs``, ``kernels.ref.min_dist`` and the
  ``core.distributed`` shim against the reference's.
"""

import importlib
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import list_archs as jlist_archs
from repro.kernels import ref as jref
from repro_torch.core.validate import core_flags
from repro_torch.dist import comm
from repro_torch.launch import costs, dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
MESHES = {"16x16": False, "2x16x16": True}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's two cluster records (16x16, 2x16x16)."""
    out = tmp_path_factory.mktemp("ref") / "cluster.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--cluster",
         "--mesh", "both", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {r["mesh"]: r for r in json.loads(out.read_text())}


@pytest.fixture(scope="module")
def cli_records(tmp_path_factory):
    """``--cluster --mesh both --device cpu``: its exit code, records and
    standard output."""
    import contextlib
    import io
    out = tmp_path_factory.mktemp("cli") / "cluster.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dryrun.main(["--cluster", "--mesh", "both", "--device", "cpu",
                          "--out", str(out)])
    return rc, json.loads(out.read_text()), buf.getvalue()


# --------------------------------------------------------------------------
# parity with the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
def test_collectives_equal_the_reference_at_its_caps(mesh, reference):
    want = reference[mesh]
    got = dryrun.run_cluster_cell(MESHES[mesh], device="cpu",
                                  caps=dryrun.reference_cluster_caps())
    for key in ("arch", "shape", "mesh", "kind", "chips"):
        assert got[key] == want[key], key
    assert got["caps"]["halo_cap"] == 128
    g, w = got["collective_bytes_per_chip"], want["collective_bytes_per_chip"]
    assert g["collective-permute"] == w["collective-permute"] == 4096
    assert g["all-gather"] == w["all-gather"]
    assert g["all-reduce"] == w["all-reduce"]
    assert g["bytes"] == sum(v for k, v in g.items() if k != "bytes")
    assert w["bytes"] == pytest.approx(
        sum(v for k, v in w.items() if k != "bytes"))
    # the reference's static caps overflow on this shard: the count is
    # of one run at those shapes, and says so
    assert got["status"] == "overflow" and len(got["attempts"]) == 1
    assert "halo" in got["attempts"][0]


# --------------------------------------------------------------------------
# the record's own checks
# --------------------------------------------------------------------------

def test_cli_writes_both_meshes(cli_records):
    rc, recs, text = cli_records
    assert rc == 0
    assert [(r["mesh"], r["chips"]) for r in recs] == [("16x16", 256),
                                                        ("2x16x16", 512)]
    for r in recs:
        assert r["status"] == "ok" and r["kind"] == "cluster"
        assert r["arch"] == "grit-cluster-step" and r["shape"] == "n4096xd3"
        assert r["attempts"][-1] == []
        coll = r["collective_bytes_per_chip"]
        for kind in ("collective-permute", "all-gather", "all-reduce"):
            assert coll[kind] > 0, kind
        assert r["roofline"]["t_collective"] > 0
        assert f"[ok     ] grit-cluster-step x {r['mesh']} bound=" in text
    # the 512-rank gather moves twice the bytes: one more block a rank
    assert recs[1]["collective_bytes_per_chip"]["all-gather"] == \
        pytest.approx(recs[0]["collective_bytes_per_chip"]["all-gather"]
                      * 511 / 255)


def test_record_counts_what_the_step_sent(cli_records):
    _, recs, _ = cli_records
    for r in recs:
        coll, sent = r["collective_bytes_per_chip"], r["sent"]
        assert coll["collective-permute"] == sent["exchange"]
        # both halos (H rows of d float32) and both label blocks (H int32)
        H, d = r["caps"]["halo_cap"], r["data"]["d"]
        assert sent["exchange"] == 2 * (H * d * 4 + H * 4)
        # the edge list [2H, 2] int32 and its flags [2H] uint8, gathered
        k = r["chips"]
        assert coll["all-gather"] == (k - 1) * (2 * H * 2 * 4 + 2 * H)
        assert sent["any"] == 7
        assert r["halo_live"]["lo"] > 0 and r["halo_live"]["hi"] > 0
        assert max(r["halo_live"].values()) <= H
        assert r["ghosts"] == "padding"
        assert r["fake_group"] == {"recv": "fill", "all_gather": "own"}
        assert r["rank"] == 1 and r["data"]["seed"] == 0
        for key in ("flops_by_class", "kernel_flops", "torch_flop_counter",
                    "memory", "lower_s", "compile_s"):
            assert key in r, key
        assert r["memory"]["argument_size"] == 4096 * (3 * 4 + 1)


def test_shard_core_points_equal_the_brute_count(cli_records):
    _, recs, _ = cli_records
    host = dryrun.cluster_shard_points(4096, 3, 1, 0)
    assert (host[:, 0] >= dryrun.DOMAIN).all()
    assert (host[:, 0] < 2 * dryrun.DOMAIN).all()
    want = int(core_flags(host.astype(np.float32), 3000.0, 10).sum())
    assert want > 0
    for r in recs:
        assert r["core_points"] == want


def test_an_end_rank_counts_half_the_permute(cli_records):
    _, recs, _ = cli_records
    inner = recs[0]
    caps = dict(inner["caps"])
    halo = caps.pop("halo_cap")
    from repro_torch.core.device_dbscan import GritCaps
    from repro_torch.dist import ClusterCaps
    end = dryrun.run_cluster_cell(
        False, device="cpu", rank=0,
        caps=ClusterCaps(grit=GritCaps(**caps), halo_cap=halo))
    assert end["status"] == "ok"
    ce, ci = (end["collective_bytes_per_chip"],
              inner["collective_bytes_per_chip"])
    assert 2 * ce["collective-permute"] == ci["collective-permute"]
    assert ce["collective-permute"] == end["sent"]["exchange"]
    assert ce["all-gather"] == ci["all-gather"]
    assert end["halo_live"]["lo"] == 0 and end["halo_live"]["hi"] > 0


def test_the_cell_leaves_the_sent_counts_as_they_were():
    before = {"exchange": 11, "gather": 22, "any": 33}
    comm.SENT.update(before)
    try:
        rec = dryrun.run_cluster_cell(False, device="cpu",
                                      caps=dryrun.reference_cluster_caps())
        assert comm.SENT == before
        assert rec["sent"]["exchange"] == 4096
    finally:
        comm.SENT.update(dict.fromkeys(comm.SENT, 0))


def test_cli_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--cluster", "--mesh", "both"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_cluster_cell(False)


def test_cli_refuses_one_device():
    with pytest.raises(SystemExit):
        dryrun.main(["--cluster", "--mesh", "one", "--device", "cpu"])


# --------------------------------------------------------------------------
# the contracts the count relies on
# --------------------------------------------------------------------------

def test_fake_group_leaves_receives_and_replicates_gathers():
    """What the fake process group hands back on the CPU: a receive
    leaves its buffer as it was, an all-gather holds the rank's own
    tensor in every slot.  The dry run does not rely on either (its comm
    sets both), but a torch that changes them should be seen."""
    assert dryrun.fake_group_delivers("cpu") == {"recv": "fill",
                                                 "all_gather": "own"}


def test_dry_run_comm_delivers_padding_and_its_own_block():
    with fake_world(256, rank=5):
        mesh = make_production_mesh(device="cpu")
        c = dryrun._fake_group_comm(mesh, "cpu")
        assert (c.me, c.n_shards, c.stage_host) == (5, 256, False)
        right = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        (gl,), (gr,) = c.neighbour_exchange([right], [right + 10], 1e15)
        assert (gl == 1e15).all() and (gr == 1e15).all()
        mine = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        got = c.shard_concat([mine])
        assert got.shape == (512, 2)
        assert (got.view(256, 2, 2) == mine).all()
        flags = c.shard_concat([torch.tensor([True, False])])
        assert flags.dtype == torch.bool
        assert flags.view(256, 2)[:, 0].all() and not flags[1::2].any()


def test_accountant_counts_sends_as_permute():
    """``c10d::send`` counts its bytes once as ``collective-permute``; a
    receive moves no wire bytes."""
    with fake_world(4, rank=1):
        a = torch.zeros(5, 3)
        b = torch.zeros(7, dtype=torch.int32)
        got_a, got_b = torch.empty_like(a), torch.empty_like(b)

        def exchange():
            for work in dist.batch_isend_irecv(
                    [dist.P2POp(dist.isend, a, 2),
                     dist.P2POp(dist.irecv, got_a, 2),
                     dist.P2POp(dist.isend, b, 0),
                     dist.P2POp(dist.irecv, got_b, 0)]):
                work.wait()

        c = costs.analyze(exchange)
    assert c["coll_collective-permute"] == 5 * 3 * 4 + 7 * 4
    assert c["coll_bytes"] == c["coll_collective-permute"]
    assert c["ops"]["c10d.send"]["calls"] == 2
    assert c["ops"]["c10d.recv_"]["calls"] == 2


# the LM mesh records' collective bytes per chip (they send nothing point
# to point), since the steps compute tensor-parallel on the model axis:
# the params are gathered over 'data' only and keep their 'model' slices
# where the compute splits (qwen2's 12 heads do not split 16 ways, so its
# attention weights are still gathered over 'model'), the MLP / attention
# outputs and the vocab-parallel embedding are summed over 'model', and
# the last-position logits gathered; the sequence-sharded caches stay in
# their shards: a decode step's attention sums its row max, its sum of
# exp and its P V over 'model', and mixtral, whose 32 heads split 16
# ways, gathers its q heads first
LM_MESH = {
    ("qwen2-1.5b", "decode_32k", False): {
        "bytes": 948531840.0, "all-reduce": 3957120.0,
        "all-gather": 944574720.0},
    ("mixtral-8x7b", "decode_32k", True): {
        "bytes": 181089462000.0, "all-reduce": 15974640.0,
        "all-gather": 181073487360.0},
}
# the same records when every step gathered its sequence-sharded cache
GATHERED_CACHE = {
    ("qwen2-1.5b", "decode_32k", False): {
        "all-reduce": 1336320.0, "all-gather": 7991005440.0},
    ("mixtral-8x7b", "decode_32k", True): {
        "all-reduce": 7987440.0, "all-gather": 185098053120.0},
}


@pytest.mark.parametrize("cell", list(LM_MESH), ids=lambda c: c[0])
def test_lm_mesh_records_keep_their_collective_bytes(cell):
    arch, shape, a2a = cell
    rec = dryrun.run_cell(arch, shape, device="cpu", multi_pod=False,
                          moe_alltoall=a2a)
    assert rec["collective_bytes_per_chip"] == LM_MESH[cell]


@pytest.mark.parametrize("cell", list(LM_MESH), ids=lambda c: c[0])
def test_cache_gather_bytes_left_the_decode(cell):
    """The pins' all-gather drop is the cache's gathered bytes, from its
    leaves' shapes at the accountant's wire factor (every layer's k and v
    gathered over 'model' from a rank's batch rows), less the q heads'
    gather where they split; the all-reduce rise is the combine's three
    float32 sums a layer, [B, H, 1] twice and [B, H, 1, Dh]."""
    from repro_torch.configs import get_shape
    from repro_torch.launch.roofline import wire_bytes
    from repro_torch.launch.specs import model_cfg_for
    from repro_torch.models.tensor_parallel import ModelAxis, attn_heads
    arch, shape, _ = cell
    cfg = model_cfg_for(arch)
    sc = get_shape(shape)
    M, n_data = 16, 16
    B = sc.global_batch // n_data
    S_c = min(sc.seq_len, cfg.window) if cfg.attn_kind == "swa" else \
        sc.seq_len
    act = 2                                       # bfloat16
    L, H, KV, Dh = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    assert KV % M and S_c % M == 0                # sequence-sharded
    cache = L * 2 * wire_bytes("all-gather", B * KV * S_c * Dh * act, M)
    q = 0.0
    if attn_heads(cfg, ModelAxis(None, M, 0)) is not None:
        q = L * wire_bytes("all-gather", B * H * Dh * act, M)
    combine = L * wire_bytes("all-reduce", 4 * (2 * B * H + B * H * Dh), M)
    old, new = GATHERED_CACHE[cell], LM_MESH[cell]
    assert old["all-gather"] - new["all-gather"] == cache - q
    assert new["all-reduce"] - old["all-reduce"] == combine


# --------------------------------------------------------------------------
# the last public names
# --------------------------------------------------------------------------

def test_list_archs_equals_the_reference():
    from repro_torch import configs
    assert configs.list_archs() == jlist_archs()
    assert configs.list_archs() is not configs.ARCHS


@pytest.mark.parametrize("masked", ["some", "none", "all"])
def test_min_dist_equals_the_reference(masked):
    from repro_torch.kernels import ref
    rng = np.random.default_rng({"some": 0, "none": 1, "all": 2}[masked])
    a = rng.normal(size=(37, 3)).astype(np.float32) * 10
    b = rng.normal(size=(53, 3)).astype(np.float32) * 10
    va, vb = rng.random(37) < 0.6, rng.random(53) < 0.6
    if masked == "none":
        va[:], vb[:] = True, True
    if masked == "all":
        vb[:] = False
    want = float(jref.min_dist(a, va, b, vb))
    got = ref.min_dist(torch.from_numpy(a), torch.from_numpy(va),
                       torch.from_numpy(b), torch.from_numpy(vb))
    assert got.shape == () and got.dtype == torch.float32
    if masked == "all":
        assert want == float(got) == float("inf")
    else:
        assert float(got) == pytest.approx(want, rel=1e-4, abs=1e-3)


def test_core_distributed_shim_warns():
    sys.modules.pop("repro_torch.core.distributed", None)
    with pytest.warns(DeprecationWarning, match=r"repro_torch\.dist"):
        shim = importlib.import_module("repro_torch.core.distributed")
    import repro_torch.dist as tdist
    for name in shim.__all__:
        assert getattr(shim, name) is getattr(tdist, name), name
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jshim = importlib.import_module("repro.core.distributed")
    assert shim.__all__ == jshim.__all__
