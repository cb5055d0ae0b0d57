"""Layer `qcp` (the host conic loop): mean ADMM iterations of a solve
(program counter `admm_iters`)."""
from portbench.readers import admm_per_instance as read  # noqa: F401
