"""Merging (``core/merging.py``): milliseconds of the merge stage of one
fit, ``sync.STAGES["merge"]`` with ``sync.TIMING`` on (summed over the
fit's attempts)."""


def read(ctx):
    v = ctx.get("stages_s", {}).get("merge")
    return None if v is None else v * 1e3
