"""Ditto core on PyTorch: the client-centric caching framework and the
distributed adaptive caching (paper §4), as functions on tensors.

The execution surface is :func:`repro_torch.core.execute`, as in the
JAX package's ``repro.core``; ``run_trace`` / ``run_trace_grouped``
remain as deprecated shims.
"""

from repro_torch.core.cache import (AccessResult, TraceResult, access,
                                    access_group, make_cache, run_trace)
from repro_torch.core.execute import Cache, ExecResult, make
from repro_torch.core.execute import execute as execute  # noqa: PLC0414
from repro_torch.core.priority import ALL_ALGORITHMS, REGISTRY, loc_of
from repro_torch.core.types import (CacheConfig, CacheState, ClientState,
                                    ExecConfig, OpStats, byte_hit_ratio,
                                    hit_ratio, init_cache, init_clients,
                                    init_stats, merge_exec_config,
                                    split_tenant_budgets, stats_delta,
                                    stats_sum)

__all__ = [
    "AccessResult", "TraceResult", "access", "access_group", "make_cache",
    "run_trace", "Cache", "ExecResult", "execute", "make",
    "ALL_ALGORITHMS", "REGISTRY", "loc_of",
    "CacheConfig", "CacheState", "ClientState", "ExecConfig", "OpStats",
    "byte_hit_ratio", "hit_ratio", "merge_exec_config", "init_cache",
    "init_clients", "init_stats", "split_tenant_budgets", "stats_delta",
    "stats_sum",
]
