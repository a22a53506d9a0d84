"""EcoSched core in PyTorch: the single-node decision path.

Twin of ``repro.core`` for the modules ported so far.

Phase I:  perfmodel (ProfiledPerfModel / OraclePerfModel), calibration
Phase II: score (Eq. 1) + actions (pure-Python reference) + engine
          (vectorized batch scorer) + ecosched (the policy; its
          ``engine="torch"`` reduces on the CUDA kernels)
Substrate: placement, events, faults, simulator (event-driven energy
accounting), baselines, metrics; carry (plain-data constructors).
"""
from repro_torch.core.baselines import (
    Marble,
    NonElasticPolicy,
    SequentialMax,
    SequentialOptimal,
)
from repro_torch.core.carry import profiles_from_arrays, specs_from_arrays
from repro_torch.core.ecosched import EcoSched
from repro_torch.core.engine import (
    DecisionCache,
    PlacementOracle,
    ScoredBatch,
    enumerate_scored,
)
from repro_torch.core.events import ElasticConfig, EventLoop, EventQueue
from repro_torch.core.faults import FaultConfig, FaultInjector
from repro_torch.core.metrics import (
    edp_saving,
    elastic_summary,
    energy_saving,
    makespan_improvement,
    perf_loss,
    summarize,
)
from repro_torch.core.perfmodel import (
    DomainInterferenceModel,
    OraclePerfModel,
    ProfiledPerfModel,
)
from repro_torch.core.placement import PlacementState, domains_of_units
from repro_torch.core.simulator import Node, NodeSim, simulate
from repro_torch.core.types import (
    JobProfile,
    JobSpec,
    Launch,
    ModeEstimate,
    NodeView,
    ScheduleResult,
)

__all__ = [
    "DecisionCache",
    "DomainInterferenceModel",
    "EcoSched",
    "ElasticConfig",
    "EventLoop",
    "EventQueue",
    "FaultConfig",
    "FaultInjector",
    "JobProfile",
    "JobSpec",
    "Launch",
    "Marble",
    "ModeEstimate",
    "Node",
    "NodeSim",
    "NodeView",
    "NonElasticPolicy",
    "OraclePerfModel",
    "PlacementOracle",
    "PlacementState",
    "ProfiledPerfModel",
    "ScheduleResult",
    "ScoredBatch",
    "SequentialMax",
    "SequentialOptimal",
    "domains_of_units",
    "edp_saving",
    "elastic_summary",
    "energy_saving",
    "enumerate_scored",
    "makespan_improvement",
    "perf_loss",
    "profiles_from_arrays",
    "simulate",
    "specs_from_arrays",
    "summarize",
]
