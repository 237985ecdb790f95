"""The window's spiking GEMMs' least time (dense-equivalent work at the
bf16 peak or bytes at HBM rate) over the device time of the Phi GEMM
kernels, %."""
from phibench.stats import roofline

KERNELS = ["phi_fused_kernel", "phi_fused_stream_kernel", "matcher_kernel",
           "l1_gather_kernel", "l2_spmm_kernel"]


def read(run):
    return roofline(run, KERNELS)
