"""Host syncs (``core/sync.py``): counted device-to-host reads per fit,
``sync.READS["count"]`` set to 0 before each fit of the window, mean."""


def read(ctx):
    fits = ctx.get("fits")
    if not fits:
        return None
    return sum(f["host_reads"] for f in fits) / len(fits)
