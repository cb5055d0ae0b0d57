"""Batch conic: `abip_tpu_torch.parallel.batched_qcp.solve_qcp_batch`, one
call a batch, with the configuration's "batch" options (sprint2: the
ladder K2 in phase 1, the delta endgame K3)."""
from portbench.entries.common import answers, stacked as stage  # noqa: F401


def prepare(config, traffic, device):
    from abip_tpu_torch import ConeSpec
    from abip_tpu_torch.parallel.batched_qcp import solve_qcp_batch

    cones = ConeSpec(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in config["cones"].items()})
    opts = config["options"]["batch"]
    return lambda args: solve_qcp_batch(*args, cones=cones, device=device,
                                        **opts)
