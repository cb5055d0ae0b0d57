"""One LP at a time: `abip_tpu_torch.solve_lp` on the dense A, the host
LP loop, with the configuration's "single" options."""
from portbench.entries.common import one as stage, solutions as answers  # noqa: F401


def prepare(config, traffic, device):
    from abip_tpu_torch import solve_lp

    opts = config["options"]["single"]
    return lambda args: [solve_lp(*args, device=device, **opts)]
