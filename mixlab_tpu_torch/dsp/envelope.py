"""ADSR envelope module (port of ``mixlab_tpu/dsp/envelope.py``).

Reference: ``src/module/envelope.rs`` — a per-sample gate state machine
(Initial / TriggerOn{on} / TriggerOff{off, off_amplitude}) driven by exact
comparisons ``input == 1.0`` / ``input == 0.0``, with piecewise-linear
attack/decay/sustain/release.

A batch (the block under ``torch.func.vmap``: a fleet's or the stems'
sessions) goes through ``envelope_block_cuda`` at any length, whose batching
rule makes one ``envelope_block_batched`` launch for every block of the
batch.  An unbatched block does from ``PALLAS_THRESHOLD`` samples on (the
JAX package's gate for one block, ``envelope.py:51,93``); a smaller
(realtime-sized) one runs the plain flat formulation directly.  On a CPU
tensor both routes run the plain twin.  The spans ``envelope.kernel`` and
``envelope.twin`` say which route a block took.
"""

from __future__ import annotations

import torch

from mixlab_tpu_torch import kernels
from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.protocol import EnvelopeParams, LineType
from mixlab_tpu_torch.dsp.base import ModuleDef, expect_mono
from mixlab_tpu_torch.dsp.envelope_cuda import (
    POS_FLOOR,
    envelope_block_cuda,
    envelope_block_torch,
)
from mixlab_tpu_torch.spans import span

# an unbatched block's gate, the JAX package's: offline-sized blocks take the
# kernel (a batch always does)
PALLAS_THRESHOLD = 32_768


class EnvelopeDef(ModuleDef):
    kind = "Envelope"

    def terminals(self, params: EnvelopeParams):
        return [LineType.MONO.unlabeled()], [LineType.MONO.unlabeled()]

    def init_state(self, params, cfg: EngineConfig, device):
        return {
            "mode_on": torch.tensor(False, device=device),
            "on_pos": torch.tensor(POS_FLOOR, dtype=torch.int32, device=device),
            "off_pos": torch.tensor(POS_FLOOR, dtype=torch.int32, device=device),
            "off_amp": torch.tensor(0.0, dtype=torch.float32, device=device),
        }

    def prepare(self, params: EnvelopeParams, cfg: EngineConfig, device):
        return {
            k: torch.tensor(getattr(params, k), dtype=torch.float32, device=device)
            for k in ("attack_ms", "decay_ms", "sustain_amplitude", "release_ms")
        }

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        S = block.n_samples(cfg)
        x = expect_mono(inputs[0], S, device)
        ms_per_sample = 1000.0 / cfg.sample_rate
        if S >= PALLAS_THRESHOLD or kernels.is_batched(x, *state.values(), *aux.values()):
            with span("envelope.kernel"):
                out, new_state = envelope_block_cuda(
                    x.contiguous(), state, aux, ms_per_sample)
        else:
            with span("envelope.twin"):
                out, new_state = envelope_block_torch(x, state, aux, ms_per_sample)
        return new_state, [out], {}
