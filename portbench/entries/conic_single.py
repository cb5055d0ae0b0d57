"""One conic program at a time: `abip_tpu_torch.solve_qcp`, the host conic
loop, with the configuration's "single" options over the conic
defaults."""
from portbench.entries.common import one as stage, solutions as answers  # noqa: F401


def prepare(config, traffic, device):
    from abip_tpu_torch import ConeSpec, solve_qcp

    cones = ConeSpec(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in config["cones"].items()})
    opts = config["options"]["single"]
    return lambda args: [solve_qcp(*args, cones, device=device, **opts)]
