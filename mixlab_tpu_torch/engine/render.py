"""Per-block offline renderer (port of ``mixlab_tpu/engine/render.py``).

Renders a workspace graph for N ticks block by block, carrying DSP state
and collecting taps (monitor audio) on the host as numpy; host feeds
(StreamInput / MediaSource PCM) come from ``ext_feeds_fn`` a block.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from mixlab_tpu_torch.device import resolve_device
from mixlab_tpu_torch.dsp.base import interleave_tap
from mixlab_tpu_torch.engine.compiler import compile_patch
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.engine.graph import Workspace
from mixlab_tpu_torch.spans import span


@dataclass
class RenderResult:
    ticks: int
    # mid key -> tap name -> np.ndarray concatenated over blocks
    taps: Dict[str, Dict[str, np.ndarray]] = field(default_factory=dict)

    def tap(self, mid, name: str) -> Optional[np.ndarray]:
        k = str(mid.value) if hasattr(mid, "value") else str(mid)
        return self.taps.get(k, {}).get(name)

    def monitor_audio(self, mid) -> Optional[np.ndarray]:
        """Monitor tap as [samples, 2] f32."""
        a = self.tap(mid, "audio")
        if a is None:
            return None
        return a.reshape(-1, a.shape[-1])


def render(
    ws: Workspace,
    n_ticks: int,
    cfg: EngineConfig = EngineConfig(),
    block_ticks: int = 60,
    t0: int = 0,
    ext_feeds_fn=None,
    collect: bool = True,
    device: Optional[torch.device] = None,
) -> RenderResult:
    """Render ``n_ticks`` ticks offline on ``device`` (the card unless the
    CPU is asked for by name); a short tail block renders with its own block
    size.

    ``ext_feeds_fn(t0, block) -> ext_feeds`` optionally supplies host audio
    (numpy, keyed by module id key, then feed name) for StreamInput /
    MediaSource modules per block; ``CompiledPatch.run`` uploads it."""
    device = resolve_device("cuda") if device is None else device
    block = BlockSpec(min(block_ticks, n_ticks))
    with span("render.compile"):
        patch = compile_patch(ws, cfg, block, device)
    with span("render.prepare"):
        aux = patch.prepare_aux(ws)
        state = patch.init_state(ws)

    collected: Dict[str, Dict[str, List[np.ndarray]]] = {}
    done = 0
    t = t0
    while done < n_ticks:
        todo = min(block.n_ticks, n_ticks - done)
        if todo != block.n_ticks:
            block = BlockSpec(todo)
            with span("render.compile"):
                patch = compile_patch(ws, cfg, block, device)
        ext = ext_feeds_fn(t, block) if ext_feeds_fn else None
        state, taps = patch.run(aux, patch.host_aux(t, ext), state)
        if collect:
            with span("render.collect"):  # the host waits for the block here
                for k, tp in taps.items():
                    dest = collected.setdefault(k, {})
                    for name, arr in tp.items():
                        if isinstance(arr, tuple):  # channel-major stereo pair
                            arr = interleave_tap(arr)
                        else:
                            arr = arr.cpu().numpy()
                        dest.setdefault(name, []).append(arr)
        done += todo
        t += todo * cfg.samples_per_tick

    result = RenderResult(ticks=n_ticks)
    with span("render.concat"):
        for k, tp in collected.items():
            result.taps[k] = {
                name: np.concatenate(chunks, axis=0) if chunks[0].ndim > 0
                else np.stack(chunks)
                for name, chunks in tp.items()
            }
    return result
