"""serve: online clustering traffic against a fitted ``GritIndex``.

    from repro_torch.serve import ClusterServer
    srv = ClusterServer(index, slots=8)     # device=None: the CUDA device
    rid = srv.submit(query_points)          # ragged request
    done = srv.step()                       # one batched predict step
    print(srv.summary())

See ``repro_torch.serve.driver`` for the continuous-batching loop and
``python -m repro_torch.serve.driver --smoke --device cpu`` for a
miniature server run.
"""

from .driver import ClusterRequest, ClusterServer

__all__ = ["ClusterRequest", "ClusterServer"]
