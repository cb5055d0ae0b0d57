"""Runtime utilities: logging, phase timing, profiling, device timing."""
from .logging import IterationLog, PhaseTimers, solver_banner
from .profiling import annotate, trace_solve

__all__ = ["IterationLog", "PhaseTimers", "solver_banner", "annotate",
           "trace_solve"]
