"""Kernels (`ops/csrc/recon_metrics.cu`): the launches' least time over the
block's slots (`roofline.recon_metrics_bound_ms`) over the kernel's device
time, in %."""
from etbench.layers import kernel_share_pct
from etbench.roofline import recon_metrics_bound_ms


def read(ctx):
    return kernel_share_pct(ctx, "recon_metrics_kernel",
                            lambda w: recon_metrics_bound_ms(w["slots"], w["moving"]))
