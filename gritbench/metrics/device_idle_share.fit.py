"""Device: the share of the traced window in which no operation ran on
the card (``torch.profiler``), in a fit cell."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("window_s"):
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
