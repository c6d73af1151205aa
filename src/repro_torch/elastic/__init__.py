"""Elastic resource runtime on the card (a torch port of
``repro.elastic``): online pool resize (the capacity write, the shrink
drain, the lane resize), feedback autoscaling, multi-tenant budget
arbitration, shard health and failover, and scenario-driven elasticity
timelines (DESIGN.md §8, §11, §14)."""

from repro_torch.elastic.controller import (Autoscaler, AutoscalerConfig,
                                            Decision, HealthConfig,
                                            HealthMonitor, TenantArbiter,
                                            TenantArbiterConfig, TenantWindow,
                                            WindowMetrics)
from repro_torch.elastic.resize import (ResizeReport, enforce_budget,
                                        fail_wipe_shard, resize_lanes,
                                        resize_memory, rewarm_shard,
                                        set_capacity, set_tenant_budgets)
from repro_torch.elastic.scenario import ScenarioResult, run_scenario

__all__ = [
    "Autoscaler", "AutoscalerConfig", "Decision", "WindowMetrics",
    "HealthConfig", "HealthMonitor",
    "TenantArbiter", "TenantArbiterConfig", "TenantWindow",
    "ResizeReport", "enforce_budget", "resize_lanes", "resize_memory",
    "fail_wipe_shard", "rewarm_shard",
    "set_capacity", "set_tenant_budgets",
    "ScenarioResult", "run_scenario",
]
