"""Kernels (`ops/csrc/reconstruct.cu`): the launches' least time at each
request's pedestrians (`roofline.reconstruct_bound_ms`) over the kernel's
device time, in %."""
from etbench.layers import kernel_share_pct
from etbench.roofline import reconstruct_bound_ms


def read(ctx):
    return kernel_share_pct(ctx, "reconstruct_kernel",
                            lambda w: reconstruct_bound_ms(w["peds"], w["moving"]))
