"""ADSR envelope over a block: the CUDA kernel's wrapper and its plain twin.

``envelope_block_cuda`` replaces the TPU kernel
``mixlab_tpu/dsp/envelope_pallas.py:envelope_block_pallas`` (same contract:
``(x [S], state, params, ms_per_sample) -> (out [S], new_state)``).  The
kernel is ``csrc/envelope.cu``: one block of 1024 threads, one lane of
``ceil(S/1024)`` samples per thread, an in-order warp-shuffle scan composing
the lanes' symbolic records.  It is latency-bound on one SM (~2 x 44
dependent steps at S = 44,100 plus the scan); see the source's header note.

``envelope_block_torch`` is the plain PyTorch twin: the flat formulation of
``mixlab_tpu/dsp/envelope.py`` (running maxima over edge positions and a
gather for the captured release amplitude).  The wrapper uses it only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.

State (dict of 0-d tensors): ``mode_on`` bool, ``on_pos`` / ``off_pos``
int32 sample offsets relative to the block start (clamped at
``POS_FLOOR``), ``off_amp`` f32.  Params: ``attack_ms``, ``decay_ms``,
``sustain_amplitude``, ``release_ms`` f32 0-d tensors.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from mixlab_tpu_torch import kernels

POS_FLOOR = -(2**30)
_SENTINEL = -(2**31) + 1
# longest block one launch takes; longer blocks split into sequential
# launches carrying the state exactly (as envelope_pallas.py does), which
# bounds a launch's dependent chain at 2 * 512 steps per thread
MAX_KERNEL_S = 512 * 1024

_PARAMS = ("attack_ms", "decay_ms", "sustain_amplitude", "release_ms")


def _amp_on(ms_since_on, params):
    """Amplitude in TriggerOn state (envelope.rs:37-51)."""
    attack = params["attack_ms"]
    decay = params["decay_ms"]
    sustain = params["sustain_amplitude"]
    attack_amp = ms_since_on / attack
    decay_amp = 1.0 - torch.clamp((ms_since_on - attack) / decay, 0.0, 1.0)
    sustain_amp = sustain + (1.0 - sustain) * decay_amp
    return torch.where(ms_since_on < attack, attack_amp, sustain_amp)


def _last_index(mask: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Index of the last True at or before each position, -1 if none."""
    return torch.cummax(torch.where(mask, idx, -1), dim=0).values


def envelope_block_torch(
    x: torch.Tensor, state: Dict[str, torch.Tensor], params, ms_per_sample: float
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain PyTorch envelope over ``x`` [S] (the flat path of
    ``mixlab_tpu/dsp/envelope.py:107-165``)."""
    S = x.shape[0]
    idx = torch.arange(S, dtype=torch.int32, device=x.device)
    u_set = x == 1.0
    u_rst = x == 0.0

    # mode: last gate event wins (set/reset flip-flop)
    last_ev = _last_index(u_set | u_rst, idx)
    mode_after = torch.where(
        last_ev >= 0, u_set[last_ev.clamp(min=0).long()], state["mode_on"]
    )
    mode_before = torch.cat([state["mode_on"].reshape(1), mode_after[:-1]])

    rising = u_set & ~mode_before
    falling = u_rst & mode_before

    on_scan = torch.cummax(torch.where(rising, idx, _SENTINEL), dim=0).values
    on_pos = torch.maximum(on_scan, state["on_pos"])
    ms_on = (idx - on_pos).to(torch.float32) * ms_per_sample
    cand = _amp_on(ms_on, params)

    # off_amplitude: the ON amplitude captured at the last falling edge
    last_off = _last_index(falling, idx)
    in_block_off = last_off >= 0
    off_pos = torch.where(in_block_off, last_off, state["off_pos"])
    off_amp = torch.where(
        in_block_off, cand[last_off.clamp(min=0).long()], state["off_amp"]
    )

    ms_off = (idx - off_pos).to(torch.float32) * ms_per_sample
    release_amp = 1.0 - torch.clamp(ms_off / params["release_ms"], 0.0, 1.0)
    out = torch.where(mode_after, cand, off_amp * release_amp)

    new_state = {
        "mode_on": mode_after[-1],
        "on_pos": torch.clamp(on_pos[-1] - S, min=POS_FLOOR),
        "off_pos": torch.clamp(off_pos[-1] - S, min=POS_FLOOR),
        "off_amp": off_amp[-1],
    }
    return out, new_state


def _check_scalar(t, dtype, index, name):
    if not (isinstance(t, torch.Tensor) and t.dtype == dtype and t.is_cuda
            and t.get_device() == index and t.numel() == 1):
        raise ValueError(
            f"envelope {name}: expected a one-element {dtype} tensor on "
            f"{torch.device('cuda', index)}, got {getattr(t, 'dtype', type(t))} on "
            f"{getattr(t, 'device', None)}")


def _launch(x, index, state, params, ms_per_sample):
    dev = x.device
    S = x.shape[0]
    out = torch.empty_like(x)
    new_state = {
        "mode_on": torch.empty((), dtype=torch.bool, device=dev),
        "on_pos": torch.empty((), dtype=torch.int32, device=dev),
        "off_pos": torch.empty((), dtype=torch.int32, device=dev),
        "off_amp": torch.empty((), dtype=torch.float32, device=dev),
    }
    kernels.launch(
        "mixlab_envelope_block", "envelope kernel launch", index,
        x.data_ptr(), out.data_ptr(), S,
        *(params[k].data_ptr() for k in _PARAMS), float(ms_per_sample),
        state["mode_on"].data_ptr(), state["on_pos"].data_ptr(),
        state["off_pos"].data_ptr(), state["off_amp"].data_ptr(),
        new_state["mode_on"].data_ptr(), new_state["on_pos"].data_ptr(),
        new_state["off_pos"].data_ptr(), new_state["off_amp"].data_ptr(),
    )
    envelope_block_cuda.launches += 1
    return out, new_state


def envelope_block_cuda(
    x: torch.Tensor, state: Dict[str, torch.Tensor], params, ms_per_sample: float
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Envelope over ``x`` [S]: the CUDA kernel for a CUDA tensor, the plain
    twin for a CPU tensor.  Blocks over ``MAX_KERNEL_S`` run as sequential
    launches with the state carried on the device."""
    if x.is_cpu:
        return envelope_block_torch(x, state, params, ms_per_sample)
    index = kernels.cuda_index(x, "envelope")
    if not (x.dim() == 1 and x.dtype is torch.float32 and x.is_contiguous()
            and 0 < x.shape[0] < 2**30):
        raise ValueError(
            "envelope: x must be a contiguous 1-D float32 tensor of 1..2**30 "
            f"samples, got {tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")
    _check_scalar(state["mode_on"], torch.bool, index, "mode_on")
    _check_scalar(state["on_pos"], torch.int32, index, "on_pos")
    _check_scalar(state["off_pos"], torch.int32, index, "off_pos")
    _check_scalar(state["off_amp"], torch.float32, index, "off_amp")
    for k in _PARAMS:
        _check_scalar(params[k], torch.float32, index, k)

    S = x.shape[0]
    if S <= MAX_KERNEL_S:
        return _launch(x, index, state, params, ms_per_sample)
    n_parts = -(-S // MAX_KERNEL_S)
    part = -(-S // n_parts)
    outs = []
    for i in range(n_parts):
        o, state = _launch(x[i * part : min((i + 1) * part, S)], index, state, params,
                           ms_per_sample)
        outs.append(o)
    return torch.cat(outs), state


envelope_block_cuda.launches = 0
