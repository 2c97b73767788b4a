"""ADSR envelope module (port of ``mixlab_tpu/dsp/envelope.py``).

Reference: ``src/module/envelope.rs`` — a per-sample gate state machine
(Initial / TriggerOn{on} / TriggerOff{off, off_amplitude}) driven by exact
comparisons ``input == 1.0`` / ``input == 0.0``, with piecewise-linear
attack/decay/sustain/release.

Blocks of at least ``PALLAS_THRESHOLD`` samples (the JAX package's gate,
``envelope.py:51,93``) go through ``envelope_block_cuda`` — the hand-written
kernel on a CUDA tensor, its plain twin on a CPU tensor.  Smaller
(realtime-sized) blocks run the plain flat formulation directly.
"""

from __future__ import annotations

import torch

from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.protocol import EnvelopeParams, LineType
from mixlab_tpu_torch.dsp.base import ModuleDef, expect_mono
from mixlab_tpu_torch.dsp.envelope_cuda import (
    POS_FLOOR,
    envelope_block_cuda,
    envelope_block_torch,
)

# same gate as the JAX package: offline-sized blocks take the kernel
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
        if S >= PALLAS_THRESHOLD:
            out, new_state = envelope_block_cuda(
                x.contiguous(), state, aux, ms_per_sample)
        else:
            out, new_state = envelope_block_torch(x, state, aux, ms_per_sample)
        return new_state, [out], {}
