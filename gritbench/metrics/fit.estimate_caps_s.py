"""Adaptive caps (``engine/adaptive.py``): one ``estimate_caps`` call on
the cell's points, timed alone by the host clock (the host part of every
fit that is given no caps)."""


def read(ctx):
    return ctx.get("estimate_caps_s")
