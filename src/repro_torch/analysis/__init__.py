"""dittolint for the port: static analysis and the invariant sanitizer,
as the JAX package's ``repro.analysis``.  Three passes guard the cache
hot path:

  1. ``astlint``  -- AST rules over ``src/repro_torch`` (DL0xx): device
     values in Python branches and host syncs in the step, PRNG key
     reuse, sorts in hot-path modules, f64 in the step, plain versions
     called past the kernels' dispatch, mutable defaults, deprecated
     entry points, imports of JAX in the port.
  2. ``audit``    -- an audit of the FX graphs (``make_fx``) of the real
     entry points (GX0xx): wide dtypes, conversion churn, host syncs,
     dead outputs, step-graph re-captures; on the CPU or over CUDA
     tensors on the card.
  3. ``sanitize`` -- runtime invariant checks (SAN001-SAN005) behind
     ``CacheConfig.sanitize=True`` and the static ``GroupPlan`` conflict
     checker (SAN006).

CLI: ``python -m repro_torch.analysis`` (the modes of
``scripts/dittolint.py``).  Every rule has an id and a per-line escape:
``# dittolint: disable=RULE``.
"""

from repro_torch.analysis import astlint, audit, sanitize

__all__ = ["astlint", "audit", "sanitize", "all_rules"]


def all_rules() -> dict:
    """The full rule catalog: id -> one-line description."""
    cat = {}
    cat.update(astlint.RULES)
    cat.update(audit.RULES)
    cat.update(sanitize.RULES)
    return cat
