"""The paper's "very large database" setting inside an LM stack, through
the PyTorch/CUDA port: cluster sequence embeddings with exact GriT-DBSCAN.

    PYTHONPATH=src python examples/torch_embedding_clustering.py [--device cpu]

The twin of ``examples/embedding_clustering.py`` through ``repro_torch``
only.  Pipeline (DESIGN.md §4): an LM from the zoo (qwen2-1.5b at its
smoke config, params from a seeded CPU ``torch.Generator``, the same
on every device) embeds token sequences (mean-pooled final hidden states) -> PCA to low-d (the
paper's own PAM4D preprocessing: Remark 3 restricts the method to low
dimensions) -> GriT-DBSCAN groups them.  Sequences are drawn from k
distinct Markov sources; the discovered clusters should recover the
sources.  Without ``--device`` it runs on the CUDA device and raises
when there is none.
"""

import argparse

import numpy as np
import torch

K_SOURCES, PER_SOURCE, SEQ = 4, 60, 64


def model(device):
    """qwen2-1.5b's smoke config in float32, params drawn from a seeded
    CPU generator (the same draws on every device) and moved to
    ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train.tree import tree_map

    cfg = get_config("qwen2-1.5b", smoke=True).with_overrides(
        dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, tree_map(lambda t: t.to(device), params)


def sources(cfg):
    """``K_SOURCES`` x ``PER_SOURCE`` token sequences and their source."""
    from repro_torch.data.tokens import TokenPipeline

    # each source walks a Markov chain over its own (near-disjoint)
    # 24-token slice of the vocab -> separable sequence embeddings
    seqs, labels_true = [], []
    for s in range(K_SOURCES):
        pipe = TokenPipeline(cfg.vocab_size, SEQ - 1, PER_SOURCE,
                             seed=1000 + 7 * s, latent_k=24)
        seqs.append(pipe.next_batch()["tokens"])
        labels_true += [s] * PER_SOURCE
    return np.concatenate(seqs), np.asarray(labels_true)


@torch.no_grad()
def embed(cfg, params, tokens, device) -> np.ndarray:
    """Mean-pooled final hidden states, float64 on the host."""
    from repro_torch.models import forward

    embs = []
    for i in range(0, len(tokens), 32):
        t = torch.as_tensor(tokens[i:i + 32], device=device)
        embs.append(forward(cfg, params, {"tokens": t})[0].mean(1).cpu()
                    .numpy())
    return np.concatenate(embs).astype(np.float64)


def project(embs, d_low=3) -> np.ndarray:
    """PCA to ``d_low`` dims, scaled to the paper's [0, 1e5] domain."""
    x = embs - embs.mean(0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    proj = x @ vt[:d_low].T
    return (proj - proj.min(0)) / (proj.max(0) - proj.min(0) + 1e-12) * 1e5


def sweep(proj, device, min_pts=8):
    """(eps, result) of the eps sweep: the most clusters (then the least
    noise) among the runs with at most a quarter of the points noise."""
    from repro_torch.engine import cluster

    best = None
    for eps in (3000.0, 5000.0, 8000.0, 12000.0, 18000.0):
        r_try = cluster(proj, eps, min_pts, engine="grit", device=device)
        score = (r_try.n_clusters, -r_try.noise_count)
        if r_try.noise_count <= 0.25 * len(proj) and \
                (best is None or score > best[0]):
            best = (score, eps, r_try)
    assert best is not None, "no eps produced a low-noise clustering"
    return best[1], best[2]


def main(argv=None):
    from repro_torch.engine import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg, params = model(dev)

    # --- build sequences from k distinct sources -------------------------
    tokens, labels_true = sources(cfg)

    # --- embed: mean-pooled final hidden state ----------------------------
    print(f"embedding {len(tokens)} sequences with {cfg.name} on {dev}...")
    embs = embed(cfg, params, tokens, dev)

    # --- PCA to low-d (paper Remark 3: method is for low-d data) ----------
    proj = project(embs)

    # --- exact GriT-DBSCAN (simple eps sweep, classic DBSCAN practice) ----
    eps, r = sweep(proj, dev)
    found = r.n_clusters
    print(f"GriT-DBSCAN (eps={eps:.0f}): {found} clusters, "
          f"{int((r.labels < 0).sum())} noise points, "
          f"kappa_max={r.stats.get('merge_max_iters', 0)}")

    # --- cluster purity vs the true sources --------------------------------
    purity = 0
    for c in range(found):
        members = labels_true[r.labels == c]
        if len(members):
            purity += np.bincount(members).max()
    purity /= max((r.labels >= 0).sum(), 1)
    print(f"cluster purity vs true sources: {purity:.3f}")
    # each source's majority cluster, over its clustered sequences
    recovered = {int(np.bincount(r.labels[(labels_true == s)
                                          & (r.labels >= 0)]).argmax())
                 for s in range(K_SOURCES)
                 if ((labels_true == s) & (r.labels >= 0)).any()}
    print(f"sources recovered as distinct clusters: {len(recovered)} of "
          f"{K_SOURCES}")
    assert found >= 2, "expected to discover cluster structure"
    assert purity > 0.8, f"purity too low: {purity}"
    assert len(recovered) == K_SOURCES, "the sources were not recovered"
    print("done.")
    return dict(device=str(dev), eps=eps, clusters=found,
                noise=int((r.labels < 0).sum()), purity=float(purity),
                recovered=len(recovered))


if __name__ == "__main__":
    main()
