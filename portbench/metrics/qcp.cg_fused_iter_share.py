"""Layer `qcp` (the host conic loop): percent of the profiled solves'
Schur PCG iterations (the `cg_iters` noted on the `qcp.solve` roots, the
setup's solve included) run through the LASSO operator's two kernels,
F1 and F2 (the `fused_iters` noted on `qcp.cg_block` spans).  They run
only on a card: a CPU run reads 0.  A program without them
(`abip_tpu_torch.ops.lasso_pcg`) records none, and the metric is left
out."""
from portbench.spans import named, trees

CARD_ONLY = True


def read(record):
    try:
        from abip_tpu_torch.ops import lasso_pcg  # noqa: F401
    except ImportError:
        return None
    ts = trees(record, "qcp")
    if ts is None or any("cg_iters" not in t[0].attrs for t in ts):
        return None
    iters = sum(t[0].attrs["cg_iters"] for t in ts)
    if not iters:
        return None
    fused = sum(s.attrs.get("fused_iters", 0) for t in ts
                for s in named(t, "qcp.cg_block"))
    return 100.0 * fused / iters
