"""Several processes as one mesh (port of ``mixlab_tpu/parallel/distributed.py``).

The JAX package's multi-controller recipe runs the same ``shard_map``
program over a global mesh that spans processes.  The port does the same
in ``torch.distributed``'s idiom:

  * every process runs the same program;
  * ``bring_up(coordinator, num_processes, process_id)`` joins the default
    process group over ``tcp://`` (or, with no address, from ``torchrun``'s
    environment) and returns the global mesh: this process's devices (by
    default its share of the host's cards, ``default_devices``),
    joined by the group, its shards global shards ``rank * len(mesh)``
    onwards;
  * the stems step over that mesh takes each process's own shards
    (``make_args`` gives them), and its mixdown ``psum`` ends in an
    ``all_reduce`` over the group;
  * ``host_local_to_global`` gathers each process's rows into the whole
    array, ``global_to_host_local`` takes this process's rows of one.

The backend is the caller's or follows the mesh's devices: ``nccl`` for
cards, ``gloo`` for the CPU.  Two processes that share one card pass
``backend="gloo"`` (NCCL refuses two ranks on one card); nothing is ever
swapped for another backend when a call fails.

Fleet serving (many independent sessions across processes) needs no
collective: ``fleet_owner`` places sessions on processes, and each runs its
sessions on its local mesh.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from mixlab_tpu_torch.device import resolve_device
from mixlab_tpu_torch.parallel import Mesh, all_gather, make_mesh


def default_devices(world: int, n_cards: int, env=os.environ) -> List[str]:
    """This process's mesh entries when the caller names none: the host's
    ``n_cards`` visible cards split evenly over its processes, local rank
    ``LOCAL_RANK`` of ``LOCAL_WORLD_SIZE`` (as ``torchrun`` sets them) taking
    a contiguous run; every card for a group of one process.  Any other
    default could put several ranks on one card, so it raises: name the
    devices."""
    if "LOCAL_RANK" in env:
        local_rank = int(env["LOCAL_RANK"])
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        per = n_cards // local_world
        if per == 0:
            raise ValueError(f"{local_world} processes on this host and {n_cards} cards: "
                             "name each process's devices")
        return [f"cuda:{i}" for i in range(local_rank * per, (local_rank + 1) * per)]
    if world > 1:
        raise ValueError("without LOCAL_RANK the cards of a process of a group of "
                         f"{world} are unknown: name its devices")
    return [f"cuda:{i}" for i in range(n_cards)]


def bring_up(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
             process_id: Optional[int] = None, axis: str = "stems",
             devices: Optional[Sequence] = None, backend: Optional[str] = None) -> Mesh:
    """Join the process group and return the global mesh.

    ``coordinator_address`` is ``host:port`` of process 0's rendezvous;
    None takes ``torchrun``'s environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  ``devices``: this
    process's mesh entries (default: ``default_devices``, checked before
    the group is joined).  ``backend``: default ``nccl`` when they are
    cards, else ``gloo``."""
    import torch.distributed as dist

    if devices is None:
        resolve_device("cuda")
        world = num_processes if coordinator_address is not None \
            else int(os.environ.get("WORLD_SIZE", "1"))
        devices = default_devices(world, torch.cuda.device_count())
    local = make_mesh(axis=axis, devices=devices)
    if backend is None:
        backend = "nccl" if all(d.type == "cuda" for d in local) else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    if backend == "nccl":
        torch.cuda.set_device(local[0])
    return global_mesh(axis, local.devices)


def global_mesh(axis: str = "stems", devices: Optional[Sequence] = None) -> Mesh:
    """This process's devices joined by the default process group: every
    process must hold as many mesh entries."""
    import torch.distributed as dist

    local = make_mesh(axis=axis, devices=devices)
    world, rank = dist.get_world_size(), dist.get_rank()
    counts = [None] * world
    dist.all_gather_object(counts, len(local))
    if len(set(counts)) != 1:
        raise ValueError(f"the processes hold {counts} mesh entries: a global mesh needs "
                         "as many in each")
    return Mesh(local.devices, axis, dist.group.WORLD, rank, world)


def host_local_to_global(x, mesh: Mesh):
    """Each process's ``x`` (its rows along the mesh axis, numpy or tensor)
    -> the whole array, every process's rows in rank order."""
    if mesh.group is None:
        return x
    if isinstance(x, torch.Tensor):
        return all_gather(x, mesh)
    return all_gather(torch.from_numpy(np.ascontiguousarray(x)), mesh).numpy()


def global_to_host_local(x, mesh: Mesh):
    """This process's rows of a whole array along the mesh axis."""
    n = x.shape[0] // mesh.world
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def fleet_owner(session_id: int, num_processes: int) -> int:
    """Static session -> process assignment for fleet serving (no
    collectives: each session's engine lives wholly on one process's
    devices)."""
    return session_id % num_processes


def distributed_stems_step(ws, cfg, block, mesh: Mesh, monitor_key: str, n_stems=None):
    """The stems step of ``parallel/stems.py``, unchanged, over a (possibly
    multi-process) mesh: one step for the local and the joined mesh."""
    from mixlab_tpu_torch.parallel.stems import stem_parallel_step

    return stem_parallel_step(ws, cfg, block, monitor_key, n_stems=n_stems, mesh=mesh)
