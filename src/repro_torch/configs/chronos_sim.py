"""The paper's own experiment configurations (Section VII), as data;
counterpart of `repro.configs.chronos_sim`.

These are the paper's testbed and trace settings beside the ten
assigned model architectures; nothing in the package reads them.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class TestbedConfig:
    """Sec VII.A: 40-node EC2 testbed, 100 jobs x 10 tasks."""
    n_jobs: int = 100
    tasks_per_job: int = 10
    beta: float = 2.0                  # measured on their testbed
    deadlines: tuple = (100.0, 150.0)  # sec (Sort/TeraSort vs others)
    tau_est: float = 40.0
    tau_kill: float = 80.0
    theta: float = 1e-4
    workloads: tuple = ("Sort", "TeraSort", "SecondarySort", "WordCount")


@dataclass(frozen=True)
class TraceConfig:
    """Sec VII.B: 30h Google-trace simulation, 2700 jobs / ~1M tasks."""
    n_jobs: int = 2700
    total_tasks: int = 1_000_000
    hours: float = 30.0
    beta_range: tuple = (1.1, 2.0)
    deadline_ratio: float = 2.0        # D = 2 x mean task time (Fig 4)
    theta_sweep: tuple = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3)
    tau_est_frac_best: float = 0.3     # Table I finding
