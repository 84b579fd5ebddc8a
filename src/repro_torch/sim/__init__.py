"""Monte-Carlo trace simulation: trace, uniform sources, sims, metrics and
the runner."""
from .draws import Philox
from .metrics import SimResult, aggregate, net_utility
from .runner import RunOutput, jobspecs_of, run_all, run_strategy
from .strategies import SimParams
from .trace import JobSet, build_jobset, generate

__all__ = [
    "JobSet", "Philox", "RunOutput", "SimParams", "SimResult", "aggregate",
    "build_jobset", "generate", "jobspecs_of", "net_utility", "run_all",
    "run_strategy",
]
