"""Adaptive caps (``engine/adaptive.py``): attempts per fit, the mean of
``len(result.attempts)`` over the window's fits."""


def read(ctx):
    fits = ctx.get("fits")
    if not fits:
        return None
    return sum(f["attempts"] for f in fits) / len(fits)
