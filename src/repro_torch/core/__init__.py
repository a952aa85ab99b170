"""The paper's primary contribution: CS-UCB scheduling with edge-cloud
collaboration (PerLLM, Alg. 1), the compared baselines, and the unified
`SchedulingPolicy` API both runtimes drive."""
from repro_torch.core.api import (
    Allocation, ClusterView, Decision, NOMINAL, RunningTask,
    SchedulingPolicy, available_policies, drive_slot, ensure_policy,
    make_policy, register_policy,
)
from repro_torch.core.bandit import CSUCB, CSUCBParams
from repro_torch.core.runtime import (
    Arrival, BandwidthChange, Deferred, Event, EventLoop, InferDone,
    InferStart, KVPressureScenario, Preempt, Reject, Runtime, Scenario,
    TxDone, available_scenarios, make_scenario, register_scenario,
)
from repro_torch.core.baselines import AGOD, FineInfer, RewardlessGuidance, make_baselines
from repro_torch.core.constraints import ConstraintSlacks, evaluate_constraints
from repro_torch.core.scheduler import PerLLMScheduler

__all__ = [
    "AGOD", "Allocation", "Arrival", "BandwidthChange", "CSUCB",
    "CSUCBParams", "ClusterView", "ConstraintSlacks", "Decision", "Deferred",
    "Event", "EventLoop", "FineInfer", "InferDone", "InferStart",
    "KVPressureScenario", "NOMINAL", "PerLLMScheduler",
    "Preempt", "Reject",
    "RewardlessGuidance", "Runtime", "RunningTask", "Scenario",
    "SchedulingPolicy", "TxDone",
    "available_policies", "available_scenarios", "drive_slot",
    "ensure_policy", "evaluate_constraints", "make_baselines", "make_policy",
    "make_scenario", "register_policy", "register_scenario",
]
