"""Batch LP: `abip_tpu_torch.parallel.batched.solve_lp_batch`, one call a
batch, with the configuration's "batch" options (the delta engine: K1
chunks between f64 anchors and checks)."""
from portbench.entries.common import answers, stacked as stage  # noqa: F401


def prepare(config, traffic, device):
    from abip_tpu_torch.parallel.batched import solve_lp_batch

    opts = config["options"]["batch"]
    return lambda args: solve_lp_batch(*args, device=device, **opts)
