"""Process groups and the (dp, tp) device mesh (port of
``lqer_tpu/parallel/mesh.py``).

One ``torch.distributed.device_mesh.DeviceMesh`` with the dimensions
``("dp", "tp")`` over the ranks of the default process group: tp the inner
dimension (consecutive ranks, one host's devices), dp the outer one, as the
JAX package reshapes its device list. The caller initialises the default
group (:func:`initialize_multihost`) and names its backend: NCCL by default
on the card, ``gloo`` where the caller asks for it (the CPU, or several
ranks on one card). Every group is created with a timeout, so a rank that
never arrives fails the others instead of hanging them.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)
DEFAULT_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def mesh_shape_for(n_devices: int, tp: int | None = None) -> tuple[int, int]:
    """(dp, tp) shape. Default: all devices in tp (single-host serving)."""
    if tp is None:
        tp = n_devices
    assert n_devices % tp == 0, (n_devices, tp)
    return (n_devices // tp, tp)


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         backend: str | None = None,
                         device_type: str = "cuda",
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT
                         ) -> None:
    """Join this process to the default group
    (``torch.distributed.init_process_group`` over
    ``tcp://<coordinator_address>``). Arguments left None come from the
    environment: ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``. ``backend`` None is ``DEFAULT_BACKENDS[device_type]`` (NCCL
    on the card)."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    dist.init_process_group(
        backend=backend or DEFAULT_BACKENDS[device_type],
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=timeout)


def make_mesh(n_devices: int | None = None, tp: int | None = None,
              device_type: str = "cuda",
              timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """A ``DeviceMesh`` ``("dp", "tp")`` over the default group's ranks:
    rank ``d * tp + t`` at ``(d, t)``. ``n_devices`` (default the world
    size) must be the world size; ``tp`` defaults to all of it. The dp and
    tp groups are created here with ``timeout`` and the default group's
    backend."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: "
                         "start as many ranks as the mesh holds")
    dp, tp_ = mesh_shape_for(n, tp)
    grid = torch.arange(n).reshape(dp, tp_)
    dp_group, _ = dist.new_subgroups_by_enumeration(
        grid.T.tolist(), timeout=timeout)
    tp_group, _ = dist.new_subgroups_by_enumeration(
        grid.tolist(), timeout=timeout)
    return DeviceMesh.from_group([dp_group, tp_group], device_type,
                                 mesh=grid, mesh_dim_names=("dp", "tp"))


def tp_over_ici_mesh(tp_per_host: int | None = None,
                     device_type: str = "cuda"):
    """tp over one host's ranks (``LOCAL_WORLD_SIZE``, set by launchers such
    as torchrun; the world size without it), dp across hosts: ranks are
    numbered host by host, so the mesh's inner dimension stays on one
    host."""
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    return make_mesh(tp=tp_per_host or n_local, device_type=device_type)


def axis_size(mesh, name: str) -> int:
    """The mesh's size along dimension ``name``."""
    return mesh.size(mesh.mesh_dim_names.index(name))


__all__ = ["DEFAULT_TIMEOUT", "axis_size", "initialize_multihost",
           "make_mesh", "mesh_shape_for", "tp_over_ici_mesh"]
