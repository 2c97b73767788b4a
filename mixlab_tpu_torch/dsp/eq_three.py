"""3-band EQ ("EqThree") (port of ``mixlab_tpu/dsp/eq_three.py``).

Reference: ``src/module/eq_three.rs`` — two 4-pole cascades of identical
one-pole low-passes at 420 Hz / 2700 Hz (``LowPass::pump``,
eq_three.rs:117-124), a 3-sample delay line, and per-band linear gains:

    lo   = LP_lo^4(x)
    hi   = x[i-3] - LP_hi^4(x)
    mid  = x[i-3] - (hi + lo)
    out  = lo*g_lo + mid*g_mid + hi*g_hi

Each stage ``y_i = (1-f)·y_{i-1} + f·x_i (+ VSA on stage 0)`` is a
first-order linear recurrence.  Blocks of at least ``PALLAS_THRESHOLD``
samples go through ``eq_cuda.eq_cascade_cuda`` (the hand-written kernel on a
CUDA tensor, its plain twin on a CPU tensor); smaller blocks run the plain
math, ``eq_cuda.eq_cascade_torch``, on either device: chunked Toeplitz
products plus a carry scan over the chunks, as the JAX package's plain path
(``_linrec_blocked``) computes them.  State: 8 poles ``[4, 2]`` (stage, band)
and the 3-sample delay history.  Products stay IEEE f32 (the JAX package
uses ``Precision.HIGHEST``); they raise while the process asks for TF32
on the card or bf16 on the CPU (``precision.require_ieee_f32``).

Inside the region program (``mega_spec``, the counterpart of
``eq_three.py:208-227`` and ``eq_pallas.make_mega_emit``) the whole module
is one ``OP_EQ``: delay, cascades and band mix over the part, with the
poles and the delay history as the part's state scalars and exits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.protocol import EqThreeParams, LineType
from mixlab_tpu_torch.dsp.base import OP_EQ, MegaSpec, ModuleDef, expect_mono
from mixlab_tpu_torch.dsp.eq_cuda import (
    PALLAS_THRESHOLD,
    eq_cascade_cuda,
    eq_cascade_torch,
    kernel_tables,
)

FREQ_LO = 420.0  # eq_three.rs:8
FREQ_HI = 2700.0  # eq_three.rs:9
VSA = 1.0 / 4294967295.0  # denormal fix (eq_three.rs:11); kept for parity


def _filter_coeff(freq: float, sample_rate: int) -> float:
    # eq_three.rs:113-115
    return 2.0 * math.sin(math.pi * freq / sample_rate)


class EqThreeDef(ModuleDef):
    kind = "EqThree"

    def terminals(self, params: EqThreeParams):
        return [LineType.MONO.unlabeled()], [LineType.MONO.unlabeled()]

    def init_state(self, params, cfg: EngineConfig, device):
        return {
            # poles[k][filter] for k in 0..4, filter 0 = lo, 1 = hi
            "poles": torch.zeros((4, 2), dtype=torch.float32, device=device),
            "hist": torch.zeros((3,), dtype=torch.float32, device=device),
        }

    def prepare(self, params: EqThreeParams, cfg: EngineConfig, device):
        gains = [params.gain_lo.to_linear(), params.gain_mid.to_linear(),
                 params.gain_hi.to_linear()]
        return {"gains": torch.tensor(gains, dtype=torch.float32, device=device)}

    def run_block(self, params, aux, host_aux, state, inputs, cfg, block, device):
        S = block.n_samples(cfg)
        x = expect_mono(inputs[0], S, device).contiguous()
        f_lo = _filter_coeff(FREQ_LO, cfg.sample_rate)
        f_hi = _filter_coeff(FREQ_HI, cfg.sample_rate)

        # 3-sample delay line (eq_three.rs:71-79)
        hx = torch.cat([state["hist"], x])
        xd = hx[:S]
        new_hist = hx[-3:].clone()  # not a view pinning the whole block

        run = eq_cascade_cuda if S >= PALLAS_THRESHOLD else eq_cascade_torch
        out, poles_out = run(x, xd, state["poles"], aux["gains"], f_lo, f_hi, VSA)
        return {"poles": poles_out, "hist": new_hist}, [out], {}

    def mega_spec(self, params, cfg, block, connected):
        f_lo = _filter_coeff(FREQ_LO, cfg.sample_rate)
        f_hi = _filter_coeff(FREQ_HI, cfg.sample_rate)
        tables = np.concatenate([kernel_tables(f_lo, f_hi),
                                 np.array([f_lo, f_hi, VSA], np.float32)])

        def emit(ctx, ins):
            x = ctx.expect_mono(ins[0])
            agg = ctx.plan.new_slot()  # the kernel's CTA aggregates
            out = ctx.op(OP_EQ, x, agg, ctx.sf[0], ctx.pf[0],
                         ctx.plan.const(tables), ctx.ef[0], cfg.sample_rate)
            return [out], {}

        # state scalars and exits: 8 poles (stage-major), then the 3
        # delay-history samples (oldest first)
        return MegaSpec(
            emit=emit,
            declare={"taps": [], "exit_f": 11, "exit_i": 0},
            param_scalars=lambda aux, h: ([aux["gains"]], []),
            state_scalars=lambda st: ([st["poles"].reshape(-1), st["hist"]], []),
            unpack=lambda f, i, old: {"poles": f[:8].reshape(4, 2), "hist": f[8:11]},
        )
