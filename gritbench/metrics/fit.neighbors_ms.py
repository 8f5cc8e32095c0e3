"""Grid tree (``core/grid_tree.py``): milliseconds of the neighbour
stage of one fit, ``sync.STAGES["neighbors"]`` with ``sync.TIMING`` on
(summed over the fit's attempts)."""


def read(ctx):
    v = ctx.get("stages_s", {}).get("neighbors")
    return None if v is None else v * 1e3
