"""One LASSO at a time: `abip_tpu_torch.problems.solve_lasso`, the
`abip_ml` front door, with the configuration's "single" options (the
matrix-free form: the host conic loop with its Schur PCG).  The answers
are the conic solution's, in the units of the embedding the generator
gives."""
from portbench.entries.common import solutions as answers  # noqa: F401


def stage(insts):
    (d,) = insts
    return d["X"], d["y"], d["lam"]


def prepare(config, traffic, device):
    from abip_tpu_torch.problems import solve_lasso

    opts = config["options"]["single"]
    return lambda args: [solve_lasso(*args, device=device, **opts)[2]]
