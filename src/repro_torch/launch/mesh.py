"""Production meshes, as in ``repro/launch/mesh.py``, as
``torch.distributed`` ``DeviceMesh``es.

Single pod: 256 devices as (data=16, model=16).  Multi-pod: 2 pods = 512
devices as (pod=2, data=16, model=16): ``pod`` acts as an outer
data-parallel axis; the model/TP axis never leaves a pod.

The production and host meshes run over the ``fake`` process group
(``torch.testing._internal.distributed.fake_pg``): one process is rank 0
of N, every collective returns at once without moving data, and the
tensors are rank 0's shards, usually fake ones (``FakeTensorMode``):
the counterpart of JAX's ``--xla_force_host_platform_device_count``
placeholders, for the dry run and the tests.  :func:`make_card_mesh` is
a real one-rank mesh on one card (NCCL over an in-process ``HashStore``:
no network).

Each maker (re)initialises the default process group as it needs it,
and :func:`teardown` destroys it; nothing here runs at import time, so
importing this module touches no device state.
"""

from __future__ import annotations

import math

import torch.distributed as dist

SINGLE = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))


def _group(backend: str, world: int, store_fn) -> None:
    """Make the default process group ``backend`` of ``world`` ranks, this
    process rank 0, unless it already is."""
    if dist.is_initialized():
        if (dist.get_backend() == backend
                and dist.get_world_size() == world):
            return
        dist.destroy_process_group()
    dist.init_process_group(backend, store=store_fn(), rank=0,
                            world_size=world)


def _fake_mesh(shape, names, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    _group("fake", math.prod(shape), FakeStore)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """The (data=16, model=16) or (pod=2, data=16, model=16) mesh over
    fake ranks, on ``device_type`` ("cpu", or "cuda" for fake CUDA
    tensors on a card)."""
    shape, names = MULTI if multi_pod else SINGLE
    return _fake_mesh(shape, names, device_type)


def make_host_mesh(model: int = 1, data: int = 1, device_type: str = "cpu"):
    """A small (data, model) mesh over fake ranks, for tests and
    examples."""
    return _fake_mesh((data, model), ("data", "model"), device_type)


def make_card_mesh(device_index: int = 0):
    """A real (data=1, model=1) mesh over one card: rank 0 of a one-rank
    NCCL group whose store lives in this process."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(device_index)
    _group("nccl", 1, dist.HashStore)
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))


def teardown() -> None:
    """Destroy the default process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
