"""Stems over a mesh of devices (port of ``mixlab_tpu/parallel/stems.py``).

N copies of a patch ("stems", e.g. config 3's 16 stereo stems) are split
into contiguous shards, one a mesh entry (``parallel.Mesh``).  Each shard
runs the patch's block program mapped over its stems on its own device
(``engine.compiler.batched_program``: the region program where the block
qualifies, as the JAX stems' ``compile_patch``, else the regular one; each
kernel launches once a block a shard), and the cross-stem mixdown, a
``psum`` over the mesh in the JAX package, is the masked sum over each
shard's stems, then the sum over the shards (``parallel.psum``).  The stems are padded up to a multiple of
the mesh size; the pad stems run and add exact zeros, their mask built from
the shard's position, so ``n_stems`` need not divide anything.

``StemsPatch`` is a ``CompiledPatch``-shaped lowering of a workspace to N
stems, usable as the live engine's ``Engine(patch_compiler=
StemsPatch.compiler(mesh, n))``: its state stays on its shards between
blocks (each module's state a tuple of the shards' stacked states), and
every tap leaf is the mixdown, with the single patch's shape, on the first
shard's device.  ``row_sharded_blend`` splits planes by rows over the mesh
and blends each shard's rows with the crossfade kernel on its device.

Every call takes ``mesh=`` (a ``Mesh`` or a sequence of devices) or, as a
one-entry mesh, ``device=``.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from mixlab_tpu_torch.convert import tree_map
from mixlab_tpu_torch.engine.compiler import upload_all
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.engine.graph import Workspace
from mixlab_tpu_torch.parallel import (
    Mesh,
    all_gather,
    as_mesh,
    gather_rows,
    psum,
    shard_programs,
)
from mixlab_tpu_torch.video.blend import crossfade_picture


def stack_for_stems(tree: Any, n_stems: int) -> Any:
    """Tile a per-stem tree along a new leading stem axis (broadcast views:
    tensors expanded, numpy arrays ``broadcast_to``)."""
    def tile(x):
        if isinstance(x, torch.Tensor):
            return x.expand(n_stems, *x.shape)
        x = np.asarray(x)
        return np.broadcast_to(x[None], (n_stems,) + x.shape)

    return tree_map(tile, tree)


def _padded(n_stems: int, n_shards: int) -> int:
    return -(-n_stems // n_shards) * n_shards


def _mixdown(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The masked sum over the stem axis (pad stems add exact zeros)."""
    return (x * mask.reshape((-1,) + (1,) * (x.dim() - 1))).sum(dim=0)


class _Shards:
    """One workspace's program on each of this process's shards: the patch
    compiled once a distinct device, each shard's stem rows and its pad
    mask (global stem index < ``n_stems``)."""

    def __init__(self, ws: Workspace, cfg: EngineConfig, block: BlockSpec, mesh: Mesh,
                 n_stems):
        self.mesh = mesh
        self.n_stems = mesh.size if n_stems is None else n_stems
        self.n_padded = _padded(self.n_stems, mesh.size)
        self.patches, self.programs, self.bounds = shard_programs(ws, cfg, block, mesh,
                                                                  self.n_padded)
        self.patch = self.patches[mesh[0]]
        self.masks = [(torch.arange(lo, hi, device=dev) < self.n_stems).to(torch.float32)
                      for dev, (lo, hi) in zip(mesh, self.bounds)]

    def per_shard(self, tree) -> List[Any]:
        """A single-stem tree tiled over each shard's stems, on its device
        (numpy leaves stay on the host)."""
        out = []
        for dev, (lo, hi) in zip(self.mesh, self.bounds):
            t = tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, tree)
            out.append(stack_for_stems(t, hi - lo))
        return out

    def run(self, aux, host_aux, state):
        """Each shard's batched block, launched in shard order; ->
        ``(states, taps)``, one entry a shard."""
        outs = [self.programs[dev](a, upload_all(h, dev), s)
                for dev, a, h, s in zip(self.mesh, aux, host_aux, state)]
        return [o[0] for o in outs], [o[1] for o in outs]


def stem_parallel_step(ws: Workspace, cfg: EngineConfig, block: BlockSpec, monitor_key: str,
                       n_stems=None, device="cuda", mesh=None, axis: str = "stems"):
    """The sharded step over ``n_stems`` stems (default: one a shard of the
    whole mesh).

    Returns ``(fn, make_args, patch)`` where ``fn(aux, host_aux, state,
    mask) -> (state', master [T, spt, 2])``: the monitor tap ``monitor_key``
    summed over the stems where ``mask`` is 1, over every shard of the mesh
    (and every process of its group), on the first shard's device.  Each
    argument is a list with one entry a shard of this process;
    ``make_args(t0)`` gives those of the block at ``t0`` (``host_aux`` as
    host numpy) over ``ceil(n_stems / mesh.size) * mesh.size`` stems, the
    pads masked out."""
    shards = _Shards(ws, cfg, block, as_mesh(device, mesh, axis), n_stems)
    patch = shards.patch

    def fn(aux, host_aux, state, mask):
        states, taps = shards.run(aux, host_aux, state)
        master = []
        for c in range(2):  # the stereo tap is channel-major (L, R)
            master.append(psum([_mixdown(t[monitor_key]["audio"][c], m)
                                for t, m in zip(taps, mask)], shards.mesh))
        return states, torch.stack(master, dim=-1)

    def make_args(t0: int = 0):
        return (shards.per_shard(patch.prepare_aux(ws)),
                shards.per_shard(patch.host_aux(t0)),
                shards.per_shard(patch.init_state(ws)),
                list(shards.masks))

    return fn, make_args, patch


class StemsPatch:
    """A ``CompiledPatch``-shaped lowering of one workspace to ``n_stems``
    stems over ``mesh`` (``prepare_aux`` / ``init_state`` / ``host_aux`` /
    ``run`` / ``order`` / ``structural_fingerprint``).  Each module's aux and
    state is a tuple of the shards' stacked trees, each on its shard's
    device; every tap leaf is the mixdown over the stems.  External feeds
    are shared by the stems, so the mixdown of N copies of one ingest is N x
    the feed."""

    def __init__(self, ws: Workspace, cfg: EngineConfig, block: BlockSpec, mesh,
                 n_stems=None, axis: str = "stems"):
        self.cfg = cfg
        self.block = block
        self._shards = _Shards(ws, cfg, block, as_mesh(mesh=mesh, axis=axis), n_stems)
        self.mesh = self._shards.mesh
        self._patch = self._shards.patch
        self.n_stems = self._shards.n_stems
        self.n_padded = self._shards.n_padded
        self.order = self._patch.order
        self.structural_fingerprint = (self._patch.structural_fingerprint,
                                       ("stems", self.n_stems, self.mesh.size, self.mesh.axis))

    @classmethod
    def compiler(cls, mesh=None, n_stems=None, axis: str = "stems"):
        """An ``Engine`` ``patch_compiler``: ``(ws, cfg, block, device) ->
        StemsPatch`` over ``mesh`` (None: the engine's device alone)."""
        return lambda ws, cfg, block, device: cls(
            ws, cfg, block, [device] if mesh is None else mesh, n_stems, axis)

    def serves(self, ws: Workspace) -> bool:
        return self._patch.serves(ws)

    def refresh_params(self, ws: Workspace) -> None:
        for patch in self._shards.patches.values():
            patch.refresh_params(ws)

    def _by_module(self, tree):
        """A single-stem tree keyed by module -> each module's tuple of the
        shards' stacked trees."""
        shards = self._shards.per_shard(tree)
        return {k: tuple(s[k] for s in shards) for k in tree}

    def prepare_aux(self, ws: Workspace):
        return self._by_module(self._patch.prepare_aux(ws))

    def init_state(self, ws: Workspace):
        return self._by_module(self._patch.init_state(ws))

    def host_aux(self, t0: int, ext_feeds=None):
        return self._patch.host_aux(t0, ext_feeds)

    def run(self, aux, host_aux, state):
        n = len(self.mesh)
        split = lambda tree: [{k: v[i] for k, v in tree.items()} for i in range(n)]
        states, taps = self._shards.run(
            split(aux), self._shards.per_shard(host_aux), split(state))
        masks, mesh = self._shards.masks, self.mesh
        mixed = tree_map(lambda *xs: psum([_mixdown(x, m) for x, m in zip(xs, masks)], mesh),
                         *taps)
        return {k: tuple(s[k] for s in states) for k in state}, mixed


def row_sharded_blend(mesh=None, device="cuda", axis: str = "stems"):
    """The crossfade over planes split by rows over ``mesh``:
    ``apply(a, b, fade)`` pads [H, W] u8 planes (numpy or tensors, any
    height) with zero rows up to a multiple of the mesh size, blends each
    shard's rows on its device (the crossfade kernel on a card, its twin on
    the CPU), gathers the rows on the first shard's device (and over the
    processes of the mesh's group) and slices the padding off."""
    m = as_mesh(device, mesh, axis)

    def apply(a, b, fade):
        a, b = (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
                for v in (a, b))
        h = a.shape[0]
        h_pad = _padded(h, m.size)
        if h_pad != h:
            a, b = (torch.cat([v, v.new_zeros((h_pad - h,) + tuple(v.shape[1:]))])
                    for v in (a, b))
        parts = [crossfade_picture({"y": a[lo:hi].to(dev).contiguous()},
                                   {"y": b[lo:hi].to(dev).contiguous()}, int(fade))["y"]
                 for dev, (lo, hi) in zip(m, m.bounds(h_pad))]
        out = gather_rows(parts, m[0])
        if m.group is not None:
            out = all_gather(out, m)
        return out[:h]

    return apply
