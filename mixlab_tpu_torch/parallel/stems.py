"""Stems on one card (port of ``mixlab_tpu/parallel/stems.py``).

N copies of a patch ("stems", e.g. config 3's 16 stereo stems) run as the
patch's regular block program mapped over a leading stem axis
(``engine.compiler.batched_program``: each kernel launches once a block for
all stems), and the cross-stem mixdown, a ``psum`` over the device mesh in
the JAX package, is a masked sum over the stem axis.  Pad stems keep their
meaning: with ``pad_to`` the stem axis is padded up to a multiple of it (as
the JAX package pads to its device count), the pad stems run and add exact
zeros, so ``n_stems`` need not be a multiple of anything.

``StemsPatch`` is a ``CompiledPatch``-shaped lowering of a workspace to N
stems, usable as the live engine's ``Engine(patch_compiler=
StemsPatch.compiler(n))``: every tap leaf is the masked mixdown, with the
single patch's shape.  ``row_sharded_blend`` blends whole planes with the
crossfade kernel (one card has no rows to shard).

A mesh, or more than one device, raises naming ROADMAP.md queue 1,
Multi-device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mixlab_tpu_torch.convert import tree_map
from mixlab_tpu_torch.device import resolve_device
from mixlab_tpu_torch.engine.compiler import batched_program, compile_patch, upload_all
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.engine.graph import Workspace
from mixlab_tpu_torch.parallel import one_device
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


def _padded(n_stems: int, pad_to: int) -> int:
    return -(-n_stems // pad_to) * pad_to


def _stem_mask(n_stems: int, n_padded: int, device) -> torch.Tensor:
    return (torch.arange(n_padded, device=device) < n_stems).to(torch.float32)


def _mixdown(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The masked sum over the stem axis (pad stems add exact zeros)."""
    return (x * mask.reshape((-1,) + (1,) * (x.dim() - 1))).sum(dim=0)


def stem_parallel_step(ws: Workspace, cfg: EngineConfig, block: BlockSpec, monitor_key: str,
                       n_stems: int = 1, device="cuda", mesh=None, pad_to: int = 1):
    """The batched step over ``n_stems`` stems on one device.

    Returns ``(fn, make_args, patch)`` where ``fn(aux, host_aux, state,
    mask) -> (state', master [T, spt, 2])``: the monitor tap ``monitor_key``
    summed over the stems where ``mask`` is 1; ``make_args(t0)`` gives the
    stacked arguments of the block at ``t0`` (``host_aux`` as host numpy)
    over ``ceil(n_stems / pad_to) * pad_to`` stems, the pads masked out."""
    dev = resolve_device(str(one_device(device, mesh)))
    patch = compile_patch(ws, cfg, block, dev, mega=False)
    program = batched_program(patch)
    n_padded = _padded(n_stems, pad_to)

    def fn(aux, host_aux, state, mask):
        st, taps = program(aux, upload_all(host_aux, dev), state)
        l, r = taps[monitor_key]["audio"]
        return st, torch.stack([_mixdown(l, mask), _mixdown(r, mask)], dim=-1)

    def make_args(t0: int = 0):
        return (stack_for_stems(patch.prepare_aux(ws), n_padded),
                stack_for_stems(patch.host_aux(t0), n_padded),
                stack_for_stems(patch.init_state(ws), n_padded),
                _stem_mask(n_stems, n_padded, dev))

    return fn, make_args, patch


class StemsPatch:
    """A ``CompiledPatch``-shaped lowering of one workspace to ``n_stems``
    stems on one device (``prepare_aux`` / ``init_state`` / ``host_aux`` /
    ``run`` / ``order`` / ``structural_fingerprint``).  Every tap leaf is the
    masked mixdown over the stems; external feeds are shared by the stems,
    so the mixdown of N copies of one ingest is N x the feed."""

    def __init__(self, ws: Workspace, cfg: EngineConfig, block: BlockSpec, device,
                 n_stems: int = 1, pad_to: int = 1, mesh=None):
        self.cfg = cfg
        self.block = block
        self.device = resolve_device(str(one_device(device, mesh)))
        self._patch = compile_patch(ws, cfg, block, self.device, mega=False)
        self._program = batched_program(self._patch)
        self.n_stems = n_stems
        self.n_padded = _padded(n_stems, pad_to)
        self._mask = _stem_mask(n_stems, self.n_padded, self.device)
        self.order = self._patch.order
        self.structural_fingerprint = (self._patch.structural_fingerprint,
                                       ("stems", n_stems, self.n_padded))

    @classmethod
    def compiler(cls, n_stems: int = 1, pad_to: int = 1, mesh=None):
        """An ``Engine`` ``patch_compiler``: ``(ws, cfg, block, device) ->
        StemsPatch``."""
        return lambda ws, cfg, block, device: cls(ws, cfg, block, device, n_stems, pad_to,
                                                  mesh)

    def prepare_aux(self, ws: Workspace):
        return stack_for_stems(self._patch.prepare_aux(ws), self.n_padded)

    def init_state(self, ws: Workspace):
        return stack_for_stems(self._patch.init_state(ws), self.n_padded)

    def host_aux(self, t0: int, ext_feeds=None):
        return stack_for_stems(self._patch.host_aux(t0, ext_feeds), self.n_padded)

    def run(self, aux, host_aux, state):
        st, taps = self._program(aux, upload_all(host_aux, self.device), state)
        return st, tree_map(lambda x: _mixdown(x, self._mask), taps)


def row_sharded_blend(device="cuda", mesh=None):
    """A crossfade of whole u8 planes on one device: ``apply(a, b, fade)``
    blends [H, W] planes (numpy or tensors, any height) with the crossfade
    kernel on a card, its twin on the CPU, and returns a tensor."""
    dev = resolve_device(str(one_device(device, mesh)))

    def apply(a, b, fade):
        a, b = (torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                .to(dev).contiguous() for v in (a, b))
        return crossfade_picture({"y": a}, {"y": b}, int(fade))["y"]

    return apply
