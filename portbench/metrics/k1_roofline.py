"""K1, `csrc/admm_delta.cu` (`ops.admm_delta`): the least time of the
profiled batches' ADMM iterations at 4mn + 2m^2 + 8mn/8 operations each
over the device time of K1's launches (device trace)."""
from portbench import roofline
from portbench.readers import roofline_share

KERNELS = ("delta_cluster_kernel",)


def read(record):
    return roofline_share(record, KERNELS, roofline.lp_delta_flops)
