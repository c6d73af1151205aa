"""The disaggregated-memory runtime on one card: the sharded pool, its
router and the ``Cluster`` membership handle (a torch port of
``repro.dm``)."""

from repro_torch.dm.cluster import (Cluster, mark_failed, replica_map,
                                    with_capacity, with_lanes,
                                    with_tenant_budgets)
from repro_torch.dm.sharded_cache import (DMCache, Membership, dm_access,
                                          dm_execute, dm_make,
                                          dm_set_capacity,
                                          identity_membership)

__all__ = ["Cluster", "DMCache", "Membership", "identity_membership",
           "dm_execute", "mark_failed", "replica_map", "with_capacity",
           "with_lanes", "with_tenant_budgets",
           # deprecated shims (warn, then the same bodies)
           "dm_make", "dm_access", "dm_set_capacity"]
