"""Batched execution of one patch over a leading instance axis, sharded over
a mesh of devices (port of ``mixlab_tpu/parallel/``): the fleet
(``fleet.py``), stems (``stems.py``) and the multi-process bring-up
(``distributed.py``).

The JAX package runs one program over a ``jax.sharding.Mesh`` with
``shard_map``.  The port's ``Mesh`` is the sequence of ``torch.device``s
this process drives, one shard each, in order.  Each shard runs the patch's
batched program (``engine.compiler.batched_program``) on its own device:
the region program where the block qualifies, else the regular one, as the
JAX package's ``compile_patch`` chooses; launches are asynchronous, so
distinct cards overlap.  The same device may appear more than once: a mesh
of 8 CPU entries is the port's counterpart of the JAX tests' 8 virtual CPU
devices, and 2 or 4 entries on one card run the sharded paths there.

An optional ``torch.distributed`` process group joins the meshes of several
processes into one (``distributed.bring_up``): this process's shards are
then global shards ``rank * len(mesh)`` onwards, and a ``psum`` adds the
shards in order onto the first shard's device, then ``all_reduce``s over the
group.  A group whose backend is ``gloo`` exchanges host copies of card
tensors (two processes that share one card use ``gloo``: NCCL refuses two
ranks on one card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from mixlab_tpu_torch.device import resolve_device
from mixlab_tpu_torch.engine.compiler import CompiledPatch, batched_program, compile_patch


def _indexed(name) -> torch.device:
    """A device by name, a card with its index (``"cuda"`` -> the current
    card), through ``resolve_device``."""
    dev = resolve_device(str(name))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """This process's devices, one shard each, along the named ``axis``;
    ``group`` (a ``torch.distributed`` process group, or None) joins the
    meshes of ``world`` processes, this one at ``rank``."""

    devices: Tuple[torch.device, ...]
    axis: str = "stems"
    group: Any = None
    rank: int = 0
    world: int = 1

    def __len__(self) -> int:
        return len(self.devices)

    def __getitem__(self, i) -> torch.device:
        return self.devices[i]

    def __iter__(self):
        return iter(self.devices)

    @property
    def size(self) -> int:
        """The shards of the whole mesh, over every process of the group."""
        return len(self.devices) * self.world

    def bounds(self, n: int) -> List[Tuple[int, int]]:
        """The rows ``[lo, hi)`` of a leading axis of ``n`` rows that each of
        this process's shards holds: contiguous, as ``P(axis)`` splits."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} shards")
        per, first = n // self.size, self.rank * len(self.devices)
        return [((first + i) * per, (first + i + 1) * per) for i in range(len(self.devices))]


def make_mesh(n_devices: Optional[int] = None, axis: str = "stems",
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``n_devices`` entries.  ``devices`` (names or
    ``torch.device``s, repeated in turn when ``n_devices`` is larger) or by
    default every visible card.  A device that does not exist raises
    through ``device.resolve_device``, as does the default without a card."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if n_devices is not None and n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked for, {len(devices)} cards visible")
    devs = [_indexed(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if n_devices is not None:
        devs = [devs[i % len(devs)] for i in range(n_devices)]
    return Mesh(tuple(devs), axis)


def as_mesh(device="cuda", mesh=None, axis: str = "stems") -> Mesh:
    """The mesh of a call: ``mesh`` (a ``Mesh`` or a sequence of devices),
    else the one-entry mesh of ``device``."""
    if isinstance(mesh, Mesh):
        return mesh
    return make_mesh(axis=axis, devices=[device] if mesh is None else list(mesh))


def shard_programs(ws, cfg, block, mesh: Mesh, n: int, mega: Optional[bool] = None):
    """``ws``'s patch compiled once a distinct device of ``mesh`` (the
    program ``compile_patch`` chooses by ``mega``), its batched program, and
    the rows ``[lo, hi)`` of ``n`` that each of this process's shards holds:
    -> ``(patches, programs, bounds)``, the first two keyed by device."""
    patches: Dict[torch.device, CompiledPatch] = {}
    for dev in mesh:
        if dev not in patches:
            patches[dev] = compile_patch(ws, cfg, block, dev, mega)
    programs = {dev: batched_program(p) for dev, p in patches.items()}
    return patches, programs, mesh.bounds(n)


def _is_gloo(mesh: Mesh) -> bool:
    import torch.distributed as dist

    return dist.get_backend(mesh.group) == "gloo"


def all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the processes of ``mesh``'s group, in place."""
    import torch.distributed as dist

    if x.is_cuda and _is_gloo(mesh):
        buf = x.cpu()
        dist.all_reduce(buf, group=mesh.group)
        x.copy_(buf)
    else:
        dist.all_reduce(x, group=mesh.group)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every process's ``x`` (one shape), concatenated in rank order along
    the leading axis, on ``x``'s device."""
    import torch.distributed as dist

    src = x.cpu() if x.is_cuda and _is_gloo(mesh) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(x.device)


def psum(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The cross-shard sum: this process's shards' ``parts`` added in shard
    order onto the first one's device, then summed over the group."""
    total = parts[0]
    for x in parts[1:]:
        total = total + x.to(total.device)
    if mesh.group is not None:
        total = all_reduce(total.clone() if len(parts) == 1 else total, mesh)
    return total


def gather_rows(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Shards' rows concatenated in shard order on ``device`` (one shard:
    its tensor as it is)."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([x.to(device) for x in parts])
