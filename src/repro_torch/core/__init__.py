"""EcoSched core in PyTorch: the single-node decision path and the fleet.

Twin of ``repro.core``.

Phase I:  perfmodel (ProfiledPerfModel / RooflinePerfModel /
          OraclePerfModel), calibration,
          forecast (RefinedPerfModel posteriors, ForecastPlane)
Phase II: score (Eq. 1) + actions (pure-Python reference) + engine
          (vectorized batch scorer) + ecosched (the policy; its
          ``engine="torch"`` reduces on the CUDA kernels)
Substrate: placement, events, faults, simulator (event-driven energy
accounting), cluster (dispatchers, fleet index, ``Cluster``/``ClusterRun``
with cross-node kernel staging), arrivals, baselines, oracle, metrics;
carry (plain-data constructors).
Control plane: journal (append-only JSONL, the reference's format) and
service (``SchedulerService``: lifecycle state machine, admission,
journaled crash recovery, the unix-socket daemon behind ``repro_torch.cli``).
"""
from repro_torch.core.arrivals import (
    Arrival,
    ArrivalRateEWMA,
    bursty_stream,
    from_datacenter_csv,
    load_trace,
    poisson_stream,
    save_trace,
)
from repro_torch.core.baselines import (
    Marble,
    NonElasticPolicy,
    SequentialMax,
    SequentialOptimal,
)
from repro_torch.core.carry import (
    arrivals_from_tuples,
    profiles_from_arrays,
    specs_from_arrays,
)
from repro_torch.core.cluster import (
    Cluster,
    ClusterRun,
    ClusterState,
    EnergyAwareDispatcher,
    FleetIndex,
    HierarchicalDispatcher,
    LeastLoadedDispatcher,
    NodeSpec,
    PredictiveDispatcher,
    RoundRobinDispatcher,
)
from repro_torch.core.ecosched import EcoSched
from repro_torch.core.engine import (
    DecisionCache,
    PlacementOracle,
    ScoredBatch,
    enumerate_scored,
)
from repro_torch.core.events import ElasticConfig, EventLoop, EventQueue
from repro_torch.core.faults import FaultConfig, FaultInjector
from repro_torch.core.forecast import ForecastConfig, ForecastPlane, RefinedPerfModel
from repro_torch.core.journal import Journal, JournalError
from repro_torch.core.metrics import (
    edp_saving,
    elastic_summary,
    energy_saving,
    makespan_improvement,
    perf_loss,
    summarize,
)
from repro_torch.core.oracle import OracleSolver, cluster_oracle_bound
from repro_torch.core.perfmodel import (
    DomainInterferenceModel,
    OraclePerfModel,
    ProfiledPerfModel,
    RooflinePerfModel,
)
from repro_torch.core.placement import PlacementState, domains_of_units
from repro_torch.core.service import (
    AdmissionConfig,
    AdmissionGate,
    ClusterBackend,
    IllegalTransition,
    JobInfo,
    RecoveryError,
    SchedulerService,
    serve,
)
from repro_torch.core.simulator import Node, NodeSim, simulate
from repro_torch.core.types import (
    ClusterResult,
    JobProfile,
    JobSpec,
    Launch,
    ModeEstimate,
    NodeView,
    ScheduleResult,
)

__all__ = [
    "AdmissionConfig",
    "AdmissionGate",
    "Arrival",
    "ArrivalRateEWMA",
    "Cluster",
    "ClusterBackend",
    "ClusterResult",
    "ClusterRun",
    "ClusterState",
    "DecisionCache",
    "DomainInterferenceModel",
    "EcoSched",
    "ElasticConfig",
    "EnergyAwareDispatcher",
    "EventLoop",
    "EventQueue",
    "FaultConfig",
    "FaultInjector",
    "FleetIndex",
    "ForecastConfig",
    "ForecastPlane",
    "HierarchicalDispatcher",
    "IllegalTransition",
    "JobInfo",
    "JobProfile",
    "JobSpec",
    "Journal",
    "JournalError",
    "Launch",
    "LeastLoadedDispatcher",
    "Marble",
    "ModeEstimate",
    "Node",
    "NodeSim",
    "NodeSpec",
    "NodeView",
    "NonElasticPolicy",
    "OraclePerfModel",
    "OracleSolver",
    "PlacementOracle",
    "PlacementState",
    "PredictiveDispatcher",
    "ProfiledPerfModel",
    "RecoveryError",
    "RefinedPerfModel",
    "RooflinePerfModel",
    "RoundRobinDispatcher",
    "ScheduleResult",
    "SchedulerService",
    "ScoredBatch",
    "SequentialMax",
    "SequentialOptimal",
    "arrivals_from_tuples",
    "bursty_stream",
    "cluster_oracle_bound",
    "domains_of_units",
    "edp_saving",
    "elastic_summary",
    "energy_saving",
    "enumerate_scored",
    "from_datacenter_csv",
    "load_trace",
    "makespan_improvement",
    "perf_loss",
    "poisson_stream",
    "profiles_from_arrays",
    "save_trace",
    "serve",
    "simulate",
    "specs_from_arrays",
    "summarize",
]
