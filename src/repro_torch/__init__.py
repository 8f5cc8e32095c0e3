"""GriT-DBSCAN on PyTorch + CUDA: the port of ``repro`` (the JAX package).

    from repro_torch.engine import cluster
    result = cluster(points, eps=3000.0, min_pts=10)

Runs on the CUDA device unless the caller passes ``device="cpu"``.
"""
