"""The elastic runtime's resize and failover primitives on the card (a
torch port of part of ``repro.elastic``).  The controllers
(``Autoscaler``, ``HealthMonitor``, ``TenantArbiter``), the scenario
driver and the drains are ROADMAP Queue 1 item 14; ``resize_memory``,
``enforce_budget`` and ``resize_lanes`` raise ``NotImplementedError``
until then."""

from repro_torch.elastic.resize import (ResizeReport, enforce_budget,
                                        fail_wipe_shard, resize_lanes,
                                        resize_memory, rewarm_shard,
                                        set_capacity, set_tenant_budgets)

__all__ = ["ResizeReport", "enforce_budget", "resize_lanes", "resize_memory",
           "fail_wipe_shard", "rewarm_shard", "set_capacity",
           "set_tenant_budgets"]
