"""Offline render of many blocks (port of ``mixlab_tpu/engine/scan_render.py``).

The JAX package moves the block loop onto the device with ``lax.scan``.
PyTorch has no such construct that the port needs: the loop is a host loop
over blocks, the compiled patch program its body, DSP state its carry.
Each block's taps stay on the device and are stacked on a leading
``[n_blocks]`` axis at the end, in the same shapes as the JAX package's
scanned taps (a stereo tap is an ``(L, R)`` pair of ``[n_blocks, T, spt]``
tensors).
"""

from __future__ import annotations

from typing import Optional

import torch

from mixlab_tpu_torch.device import resolve_device
from mixlab_tpu_torch.engine.compiler import CompiledPatch, compile_patch
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.engine.graph import Workspace


def _stack(per_block):
    """List (over blocks) of identical tap pytrees -> one pytree of tensors
    stacked on a new leading axis."""
    first = per_block[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in per_block]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([b[i] for b in per_block]) for i in range(len(first)))
    return torch.stack(per_block)


def scan_blocks(patch: CompiledPatch, aux, state, t0: int, n_blocks: int):
    """Run ``n_blocks`` consecutive blocks from absolute sample ``t0``;
    returns ``(state, taps)`` with taps stacked over blocks."""
    spb = patch.block.n_samples(patch.cfg)
    per_block = []
    for i in range(n_blocks):
        state, taps = patch.run(aux, patch.host_aux(t0 + i * spb), state)
        per_block.append(taps)
    return state, _stack(per_block)


def render_scanned(
    ws: Workspace,
    n_ticks: int,
    cfg: EngineConfig = EngineConfig(),
    block_ticks: int = 60,
    t0: int = 0,
    device: Optional[torch.device] = None,
):
    """Offline render on ``device`` (the card unless the CPU is asked for by
    name); returns ``(patch, (state, taps))`` with taps carrying a leading
    ``[n_blocks]`` axis."""
    device = resolve_device("cuda") if device is None else device
    if n_ticks <= 0 or n_ticks % block_ticks != 0:
        raise ValueError(f"n_ticks {n_ticks} must be a positive multiple of "
                         f"block_ticks {block_ticks}")
    patch = compile_patch(ws, cfg, BlockSpec(block_ticks), device)
    aux = patch.prepare_aux(ws)
    state0 = patch.init_state(ws)
    return patch, scan_blocks(patch, aux, state0, t0, n_ticks // block_ticks)
