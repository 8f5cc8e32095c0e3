"""Kernels (``kernels/csrc/pairwise.cu``): the batched distance kernels'
share of their roofline over one fit, in %: the least time the inputs of
every ``eps_count_batch`` / ``row_min_batch`` call need
(``gritbench/roofline.py``) over the device time of the kernels named
``dist_kernel`` in that fit's profiler trace."""


def read(ctx):
    dev, bound = ctx.get("dist_kernel_s"), ctx.get("dist_bound_s")
    if not dev or not bound:
        return None
    return 100.0 * bound / dev
