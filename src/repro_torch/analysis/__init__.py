"""Invariant checks for the port: the runtime sanitizer (SAN001-SAN005)
behind ``CacheConfig.sanitize=True`` and the static ``GroupPlan``
conflict checker (SAN006), as the JAX package's ``repro.analysis``
pass 3.  The JAX package's passes 1 and 2 (``astlint``,
``jaxpr_audit``) are JAX tooling and have no counterpart here yet."""

from repro_torch.analysis import sanitize

__all__ = ["sanitize"]
