"""Strategy IR: one StrategySpec per strategy, looked up through the
registry (`register` / `get` / `names` / `index_of`)."""
from .spec import (FORMS, KINDS, StrategySpec, cost_of_spec, get, index_of,
                   job_pocd, names, pocd_of_spec, register, solve_jobs,
                   utility_of)
# Registration order defines index_of() and must equal the reference's:
# baselines, the Chronos trio, hedge, adaptive, the competitive pair.
from . import baselines as _baselines      # noqa: F401
from . import chronos as _chronos          # noqa: F401
from . import hedge as _hedge              # noqa: F401
from . import adaptive as _adaptive        # noqa: F401
from . import competitive as _competitive  # noqa: F401

__all__ = [
    "FORMS", "KINDS", "StrategySpec", "cost_of_spec", "get", "index_of",
    "job_pocd", "names", "pocd_of_spec", "register", "solve_jobs",
    "utility_of",
]
