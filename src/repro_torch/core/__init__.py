"""LLMSched core: the paper's primary contribution (numpy only).

Copies of the JAX package's ``repro.core`` modules, which import no JAX;
the port keeps its own so that it imports nothing of ``repro``.

- :mod:`repro_torch.core.dag`         -- DAG model (regular/LLM/dynamic stages, SIV-A)
- :mod:`repro_torch.core.bayesnet`    -- discrete Bayesian network profiler (SIV-B)
- :mod:`repro_torch.core.calibration` -- batching-aware duration calibration (Eq. 2; measured l(b) only)
- :mod:`repro_torch.core.entropy`     -- entropy/MI uncertainty quantification (SIV-C)
- :mod:`repro_torch.core.profiler`    -- per-application profiles (BN + discretizers)
- :mod:`repro_torch.core.scheduler`   -- Algorithm 1 (uncertainty-aware eps-greedy)
- :mod:`repro_torch.core.cascade`     -- quality gates + cascade escalation model
- :mod:`repro_torch.core.baselines`   -- FCFS / Fair / SJF / SRTF / Argus / Carbyne / Decima
"""

from .dag import (
    SLO,
    SLO_TIERS,
    ApplicationTemplate,
    Job,
    Stage,
    StageTemplate,
    StageType,
    Task,
    TaskState,
    make_job,
)
from .bayesnet import BayesNet, Discretizer, Factor, fit_discretizer
from .calibration import LatencyProfile, measured_profile, roofline_profile
from .entropy import (
    binary_entropy,
    conditional_mutual_information,
    dynamic_stage_entropy,
    entropy,
    uncertainty_reduction,
)
from .cascade import (
    DeterministicGate,
    QualityGate,
    cascade_cost,
    fleet_ranks,
    stage_difficulty,
)
from .metrics import RunMetrics
from .profiler import AppProfile, JobTrace, ProfileStore
from .scheduler import (
    ClusterView,
    Decision,
    LLMSched,
    Scheduler,
    TaskKey,
    task_key,
)
from .baselines import FCFS, SJF, SRTF, Argus, Carbyne, Decima, Fair, make_baselines

__all__ = [
    "SLO", "SLO_TIERS",
    "ApplicationTemplate", "Job", "Stage", "StageTemplate", "StageType",
    "Task", "TaskState", "make_job",
    "BayesNet", "Discretizer", "Factor", "fit_discretizer",
    "LatencyProfile", "measured_profile", "roofline_profile",
    "binary_entropy", "conditional_mutual_information",
    "dynamic_stage_entropy", "entropy", "uncertainty_reduction",
    "AppProfile", "JobTrace", "ProfileStore", "RunMetrics",
    "DeterministicGate", "QualityGate", "cascade_cost", "fleet_ranks",
    "stage_difficulty",
    "ClusterView", "Decision", "LLMSched", "Scheduler",
    "TaskKey", "task_key",
    "FCFS", "SJF", "SRTF", "Argus", "Carbyne", "Decima", "Fair",
    "make_baselines",
]
