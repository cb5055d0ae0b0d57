"""Layer `parallel.batched`: ADMM iterations of every lane over the
window's synchronized calls (program counter `admm_iters`)."""
from portbench.readers import admm_per_s as read  # noqa: F401
