"""What the entries share: how instances are handed to the program and
how its answers are read back.  An entry module gives `prepare(config,
traffic, device)`, the call the window times, `stage(instances)`, the
host-side arguments of one call (made before the clock starts), and
`answers(result)`, the numpy `x`, `y`, `s`, `status` and `admm_iters` of
each instance (read after the clock stops)."""
import numpy as np


def stacked(insts):
    """(A, b, c) stacked over the batch, numpy f64 on the host: the
    program moves them to the card inside the timed call."""
    return tuple(np.stack([d[k] for d in insts]) for k in ("A", "b", "c"))


def one(insts):
    (d,) = insts
    return d["A"], d["b"], d["c"]


def answers(res):
    """A batch result's tensors, as numpy."""
    return {k: getattr(res, k).detach().cpu().numpy()
            for k in ("x", "y", "s", "status", "admm_iters")}


def solutions(sols):
    """A list of host solutions (numpy fields), stacked."""
    return {k: np.stack([np.asarray(getattr(s, k)) for s in sols])
            for k in ("x", "y", "s", "status", "admm_iters")}
