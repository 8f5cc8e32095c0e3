"""The port's examples (``examples/torch_*.py``) run in-process on the CPU
at their smallest presets, held to the JAX package where the outcome is
deterministic:

* ``torch_quickstart.py``: every registered engine's cluster and noise
  counts equal ``repro.engine.cluster``'s on the same points (the host
  engines against their namesakes, the device engines against the
  reference's brute, whose counts every exact engine shares), and the
  float64 brute check's counts equal the reference oracle's;
* ``torch_embedding_clustering.py``: with the reference's params carried
  across (``convert.lm_params_from_numpy``), the same token sequences,
  pooled embeddings within 1e-4 relative and the same number of clusters;
  on its own seeded params the four sources recovered;
* ``torch_serve_batch.py``: the smoke CLI's traffic served;
* ``torch_train_lm.py``: ``--quick --steps 3`` (the reference's loss
  assertion needs one step after the warmup step's lr of 0) with its
  restore check, then ``--resume`` from its checkpoint to step 5.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_counts_equal_the_reference(capsys):
    import repro.engine as jengine
    from repro.core.validate import contested_border_mask
    from repro.data.seed_spreader import seed_spreader as jspreader
    from repro_torch.data.seed_spreader import seed_spreader

    got = _example("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "all equivalent." in out and out.rstrip().endswith("done.")
    pts = jspreader(4000, 3, variant="varden", restarts=6, seed=0)
    np.testing.assert_array_equal(
        seed_spreader(4000, 3, variant="varden", restarts=6, seed=0), pts)
    assert set(got["engines"]) == set(jengine.available_engines())
    ref = {}
    for name in got["engines"]:
        ref_name = name if name in ("brute", "grit", "grit-ldf") else "brute"
        if ref_name not in ref:
            r = jengine.cluster(pts, 3500.0, 10, engine=ref_name)
            ref[ref_name] = r
        assert got["engines"][name] == (ref[ref_name].n_clusters,
                                        ref[ref_name].noise_count), name
    b = ref["brute"]
    assert got["brute_check"] == dict(
        cores=int(b.core.sum()), clusters=b.n_clusters,
        contested=int(contested_border_mask(pts, 3500.0, b.core,
                                            b.labels).sum()),
        noise=b.noise_count)
    assert got["sharded"] == 4


def test_embedding_twin_holds_to_the_reference():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.data.tokens import TokenPipeline
    from repro.engine import cluster as jcluster
    from repro.models import forward, init_params
    from repro_torch.convert import lm_params_from_numpy

    ex = _example("torch_embedding_clustering")
    cfg, _ = ex.model("cpu")
    tokens, labels_true = ex.sources(cfg)
    jcfg = get_config("qwen2-1.5b", smoke=True).with_overrides(
        dtype="float32")
    want_tokens = np.concatenate([
        TokenPipeline(jcfg.vocab_size, 63, 60, seed=1000 + 7 * s,
                      latent_k=24).next_batch()["tokens"] for s in range(4)])
    np.testing.assert_array_equal(tokens, want_tokens)
    np.testing.assert_array_equal(labels_true, np.repeat(np.arange(4), 60))

    jparams = init_params(jcfg, jax.random.PRNGKey(0))
    emb_fn = jax.jit(lambda p, t: forward(jcfg, p, {"tokens": t})[0].mean(1))
    want = np.concatenate([np.asarray(emb_fn(jparams,
                                             jnp.asarray(tokens[i:i + 32])))
                           for i in range(0, len(tokens), 32)]
                          ).astype(np.float64)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    got = ex.embed(cfg, params, tokens, "cpu")
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    eps, r = ex.sweep(ex.project(got), "cpu")
    # the reference example's sweep on its own embeddings
    proj = ex.project(want)
    best = None
    for e in (3000.0, 5000.0, 8000.0, 12000.0, 18000.0):
        rt = jcluster(proj, e, 8, engine="grit")
        score = (rt.n_clusters, -rt.noise_count)
        if rt.noise_count <= 0.25 * len(proj) and \
                (best is None or score > best[0]):
            best = (score, e, rt)
    assert best is not None
    assert r.n_clusters == best[2].n_clusters


def test_embedding_twin_recovers_the_sources(capsys):
    got = _example("torch_embedding_clustering").main(["--device", "cpu"])
    assert got["recovered"] == 4 and got["clusters"] >= 4
    assert got["purity"] > 0.8
    assert "sources recovered as distinct clusters: 4 of 4" in \
        capsys.readouterr().out


def test_serve_batch_twin_serves_the_smoke_traffic(capsys):
    _example("torch_serve_batch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    # the reference CLI's traffic: 8 requests x 16 new tokens
    assert "served 8 requests, 128 tokens" in out
    assert out.count("  req ") == 3


def test_train_lm_twin_trains_checkpoints_and_resumes(tmp_path, capsys):
    ex = _example("torch_train_lm")
    ck = str(tmp_path / "ckpt")
    first = ex.main(["--quick", "--steps", "3", "--device", "cpu",
                     "--ckpt-dir", ck])
    assert (first["ran"], first["step"], first["resumed"]) == (3, 3, None)
    assert first["restored_equal"]
    second = ex.main(["--quick", "--steps", "5", "--resume", "--device",
                      "cpu", "--ckpt-dir", ck])
    assert (second["ran"], second["step"], second["resumed"]) == (2, 5, 3)
    assert "resumed at step 3" in capsys.readouterr().out
    assert second["losses"][-1] < first["losses"][0]


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_embedding_clustering",
                                  "torch_serve_batch", "torch_train_lm"])
def test_default_device_is_the_card(name, monkeypatch):
    """Without ``--device`` each twin asks for the card, and raises
    where there is none."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex = _example(name)
    argv = ["--quick"] if name == "torch_train_lm" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main(argv)
