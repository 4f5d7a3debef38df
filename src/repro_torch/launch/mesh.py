"""Mesh factories, the counterpart of ``repro.launch.mesh``.

Functions, not module constants: importing this module touches no
process-group state (the reference's rule, so a test sees one device while
the dry run sees 512 placeholder ranks).

The dry run's placeholder devices are the ranks of a *fake* process group
(the ``"fake"`` c10d backend): one process plays rank 0 of a world of 256
or 512, every collective returns a buffer of the right shape without
moving data, and ``torch.distributed.tensor`` places and redistributes
``DTensor``s on a ``DeviceMesh`` over it as it would on the real world.
:func:`init_fake_world` sets that world up (and tears down a world of
another size first); :func:`make_production_mesh` builds the reference's
meshes on it.  The backend is registered by
``torch.testing._internal.distributed.fake_pg`` only, which
:func:`init_fake_world` imports.
"""
from __future__ import annotations

import torch.distributed as dist

__all__ = ["POD1", "POD2", "init_fake_world", "make_host_mesh",
           "make_production_mesh", "shutdown_world"]

POD1 = ((16, 16), ("data", "model"))
POD2 = ((2, 16, 16), ("pod", "data", "model"))


def _register_fake():
    """Make ``init_process_group("fake")`` known to c10d (importing the
    module registers the backend)."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401


def shutdown_world():
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def init_fake_world(world_size: int, rank: int = 0):
    """Make the default process group a fake world of ``world_size`` ranks
    in which this process is ``rank``; a world of another size or backend
    is destroyed first."""
    _register_fake()
    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=world_size)


def make_production_mesh(multi_pod: bool = False, device: str = "cuda"):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks), on a
    fake world of that size (:func:`init_fake_world`)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = POD2 if multi_pod else POD1
    n = 1
    for s in shape:
        n *= s
    init_fake_world(n)
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_host_mesh(device: str = "cuda"):
    """``(n_cards, 1)`` over ('data', 'model') on the default process group,
    which the caller has initialised with one rank per card (on the CPU,
    ``n_cards`` is the world's size)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    return init_device_mesh(device, (n, 1), mesh_dim_names=("data", "model"))
