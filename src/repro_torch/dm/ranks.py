"""A DM pool spread over the ranks of a ``torch.distributed`` group: the
counterpart of the JAX package's ``pool`` mesh axis
(``repro/dm/sharded_cache.py``'s ``AXIS`` and ``_mesh``).

The pool's S memory shards are split into R equal blocks, rank r holding
shards ``[r*S/R, (r+1)*S/R)`` as the leading axis of its tensors, in the
one-card layout (``dm/sharded_cache.py``).  Every rank calls the same
entry points with the same global inputs (SPMD, as every device of the
JAX mesh runs the same program) and gets the same global outputs.

:class:`Pool` names the group and the rank's block, and runs the few
collectives the DM layer needs, each written so that its result does
not depend on R:

* :meth:`Pool.exchange`: ``all_to_all_single``, dim 0 split in R equal
  chunks, chunk r to rank r (the request exchange and its return);
* :meth:`Pool.gather_ranks` / :meth:`Pool.gather_shards`: an
  ``all_gather`` in rank order, which is shard order;
* :meth:`Pool.any_`, :meth:`Pool.sum_` (integers only) and
  :meth:`Pool.broadcast`.

Floats are never all-reduced: a reduction's order is the backend's
(NCCL's ring is not XLA's shard order), so every float sum across shards
is a :meth:`Pool.gather_shards` followed by the one-card path's own sum
in shard order (``core/cache.py``'s ``_seqsum``), and R = 1, 2, 4 give
the one-card bits.

The caller names the backend by the group it passes: ``nccl``, one card
a rank, or ``gloo`` (several ranks on one card, or the CPU).  Gloo takes
CUDA tensors for every collective here (probed with torch 2.11 on an
H100: it stages them through the host itself, ~1.5 ms a call between
two ranks on one card), so no buffer is staged here.  Nothing here
swaps one backend for another.

A process that holds the whole pool (the one-card path) has the local
pool, :func:`local_pool`: one rank, no group, every collective the
identity, so the DM layer runs one code path for both.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BACKENDS = ("nccl", "gloo")


class Pool(NamedTuple):
    """This rank's view of a pool spread over ``group``."""

    group: object          # the torch.distributed process group; None:
    #                        the whole pool here, collectives identities
    n_ranks: int
    rank: int
    n_shards: int          # S, the whole pool's
    backend: str           # "nccl", "gloo", or "local" (no group)

    @property
    def n_local(self) -> int:
        """Shards a rank holds."""
        return self.n_shards // self.n_ranks

    @property
    def lo(self) -> int:
        """This rank's first shard."""
        return self.rank * self.n_local

    @property
    def hi(self) -> int:
        """One past this rank's last shard."""
        return self.lo + self.n_local

    def owner(self, k: int) -> int:
        """The rank that holds shard k."""
        return k // self.n_local

    def block(self, tree):
        """This rank's block of a one-card ``DMCache`` (every leaf's
        leading axis is S times its per-shard rows): a rank's cluster
        from a one-card one, or the one-card slice a rank equals."""
        S = self.n_shards
        return type(tree)(*[type(part)(*[
            x[self.lo * (x.shape[0] // S):self.hi * (x.shape[0] // S)]
            for x in part]) for part in tree])

    def layout(self) -> tuple:
        """What a captured step or a warm key depends on."""
        return (self.n_shards, self.n_ranks, self.rank, self.backend)

    # The collectives.  Bool tensors travel as uint8.

    def exchange(self, send: torch.Tensor) -> torch.Tensor:
        """``all_to_all_single``: ``send`` [R*k, ...] in R chunks of k
        rows, chunk r to rank r; returns [R*k, ...], chunk r from rank
        r."""
        if self.group is None:
            return send
        import torch.distributed as dist
        x = _wire(send)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return _unwire(out, send.dtype)

    def gather_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order: [R, *x.shape]."""
        if self.group is None:
            return x[None]
        import torch.distributed as dist
        w = _wire(x).reshape(-1)
        out = torch.empty((self.n_ranks * w.numel(),), dtype=w.dtype,
                          device=w.device)
        dist.all_gather_into_tensor(out, w, group=self.group)
        return _unwire(out.reshape((self.n_ranks,) + tuple(x.shape)),
                       x.dtype)

    def gather_shards(self, x: torch.Tensor) -> torch.Tensor:
        """A per-shard tensor [S_local, ...] gathered into [S, ...] in
        shard order."""
        return self.gather_ranks(x).reshape((self.n_shards,)
                                            + tuple(x.shape[1:]))

    def any_(self, flag: torch.Tensor) -> torch.Tensor:
        """A 0-d bool true on any rank, on every rank."""
        if self.group is None:
            return flag.reshape(()).bool()
        import torch.distributed as dist
        x = flag.to(torch.int64).reshape(())
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x > 0

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum over ranks of an integer tensor (exact in
        any order)."""
        if x.is_floating_point():
            raise TypeError("Pool.sum_ adds integers only: gather floats "
                            "and sum them in shard order")
        if self.group is None:
            return x.to(torch.int64)
        import torch.distributed as dist
        out = x.to(torch.int64).clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank (a copy, no arithmetic)."""
        if self.group is None:
            return x
        import torch.distributed as dist
        out = _wire(x).clone()
        dist.broadcast(out, dist.get_global_rank(self.group, src),
                       group=self.group)
        return _unwire(out, x.dtype)


def _wire(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _unwire(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.bool() if dtype == torch.bool else x


def local_pool(n_shards: int) -> Pool:
    """The pool of ``n_shards`` shards all held by this process."""
    return Pool(None, 1, 0, n_shards, "local")


def or_local(pool, n_shards: int) -> Pool:
    """``pool``, or the local pool of ``n_shards`` shards if None."""
    return local_pool(n_shards) if pool is None else pool


def make_pool(group, n_shards: int, device: torch.device) -> Pool:
    """The pool of ``n_shards`` shards over ``group``'s ranks, this
    process one of them (None: the local pool).  R must divide S; an
    ``nccl`` group needs the card."""
    if group is None:
        return local_pool(n_shards)
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("Cluster.make(group=): torch.distributed is not "
                           "initialized")
    backend = str(dist.get_backend(group))
    if backend not in BACKENDS:
        raise ValueError(f"Cluster.make(group=): backend {backend!r}; the "
                         f"pool runs over {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("Cluster.make(group=): an nccl group needs "
                         "device='cuda'")
    n_ranks, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_shards % n_ranks:
        raise ValueError(f"Cluster.make(group=): {n_ranks} ranks do not "
                         f"divide {n_shards} shards")
    return Pool(group, n_ranks, rank, n_shards, backend)
