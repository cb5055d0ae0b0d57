"""Layer `qcp` (the host conic loop): ADMM iterations over the window's
solves (program counter `admm_iters`)."""
from portbench.readers import admm_per_s as read  # noqa: F401
