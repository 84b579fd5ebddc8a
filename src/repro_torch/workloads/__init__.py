"""Trace-driven heterogeneous workloads on tensors; counterpart of
`repro.workloads`.

* `generators`: job-class mixtures and arrival processes (Poisson, batch
  Poisson, diurnal NHPP, cyclic MMPP), drawn through a workload source;
* `traces`: the columnar `WorkloadTrace`, its `.npz` files, `synthesize`
  and the paper-trace calibration statistics;
* `registry`: the named scenarios, resolvable to JobSets.

    from repro_torch.workloads import make_jobset
    jobs = make_jobset("multi-tenant-sla", n_jobs=300, device="cuda")
"""
from .generators import (ARRIVAL_PROCESSES, JobClass, batch_poisson_arrivals,
                         diurnal_arrivals, hill_estimator, mmpp_arrivals,
                         poisson_arrivals, sample_arrivals, sample_classes,
                         sample_pareto_params, sample_task_counts)
from .registry import (SCENARIOS, Scenario, get_scenario, list_scenarios,
                       make_jobset, make_trace, register)
from .traces import (PAPER_TRACE_STATS, TRACE_COLUMNS, WorkloadTrace,
                     load_trace, save_trace, summarize, synthesize, to_jobset)

__all__ = [
    "ARRIVAL_PROCESSES", "JobClass", "PAPER_TRACE_STATS", "SCENARIOS",
    "Scenario", "TRACE_COLUMNS", "WorkloadTrace", "batch_poisson_arrivals",
    "diurnal_arrivals", "get_scenario", "hill_estimator", "list_scenarios",
    "load_trace", "make_jobset", "make_trace", "mmpp_arrivals",
    "poisson_arrivals", "register", "sample_arrivals", "sample_classes",
    "sample_pareto_params", "sample_task_counts", "save_trace", "summarize",
    "synthesize", "to_jobset",
]
