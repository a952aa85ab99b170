from repro_torch.cluster.network import (
    BandwidthModel, Link, LinkStateMixin, LinkTopology, make_topology,
)
from repro_torch.cluster.server import DVFS_TIERS, ServerSpec, ServerState
from repro_torch.cluster.simulator import ClusterView, Outcome, SimResult, Simulator
from repro_torch.cluster.testbed import paper_testbed, tpu_testbed
from repro_torch.cluster.workload import (
    N_CLASSES, ServiceRequest, classify, generate_workload,
)

__all__ = [
    "BandwidthModel", "ClusterView", "DVFS_TIERS", "Link", "LinkStateMixin",
    "LinkTopology", "N_CLASSES", "Outcome", "ServerSpec",
    "ServerState", "ServiceRequest", "SimResult", "Simulator",
    "classify", "generate_workload", "make_topology", "paper_testbed",
    "tpu_testbed",
]
