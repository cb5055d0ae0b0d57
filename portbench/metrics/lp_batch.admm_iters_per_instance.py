"""Layer `parallel.batched`: mean ADMM iterations of a lane
(program counter `admm_iters`)."""
from portbench.readers import admm_per_instance as read  # noqa: F401
