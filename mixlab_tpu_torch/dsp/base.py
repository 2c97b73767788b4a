"""Module definition interface for the PyTorch DSP layer.

Port of ``mixlab_tpu/dsp/base.py``.  Every module is a plain function over a
block of ticks,

    run_block(params, aux, host_aux, state, inputs, cfg, block, device)
        -> (state', outputs, taps)

run eagerly, one module after another, by the graph compiler
(:mod:`mixlab_tpu_torch.engine.compiler`).

Data conventions (device tensors, no autograd):
  * mono buffer:   f32 ``[S]``                (S = block samples)
  * stereo buffer: TUPLE ``(L, R)`` of two f32 ``[S]`` mono tensors
  * ``aux``:       dict of tensors on ``device`` made by ``prepare`` per edit
  * ``host_aux``:  dict of numpy arrays made by ``host_prepare`` per block
                   (float64 phase bases etc.); the compiler uploads it to
                   ``device`` before ``run_block`` sees it
  * state:         dict of tensors on ``device``, carried across blocks

Stereo stays the channel-major pair of the JAX package: channel routing
(panner, splitter, an oscillator's L == R) is tuple plumbing with no device
work, and stereo taps cross to the host as ``[2, ...]`` channel-major data.

The whole-graph region program (:mod:`mixlab_tpu_torch.engine.region_graph`)
runs part of a graph as ONE kernel launch per part.  A module takes part in
it through a :class:`MegaSpec` (the counterpart of the JAX package's
``MegaSpec`` / ``EmitCtx``, ``mixlab_tpu/dsp/base.py:62-151``).  Where the
JAX emit produces traced values inside a Pallas kernel, the port's emit
appends ops to a :class:`RegionPlan`: a flat op list over buffer slots.  The
same plan is executed by the CUDA kernel (``csrc/region.cu``) and by its
plain twin (``engine/region_cuda.py:region_part_torch``), so the CPU tests
check the plan as well as the math.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.protocol import Terminal

Pytree = Any

# ---------------------------------------------------------------------------
# the region plan: op codes (the kernel's ``enum Op``, csrc/region.cu)
# ---------------------------------------------------------------------------
#
# Every op is ``[code, length, args...]`` in one int32 stream.  Slot ids name
# [S_part] buffers: the first ``n_operands`` are the part's operands (f32,
# or i16 for StreamInput), the rest f32 scratch.  ``p`` ids index the f32
# parameter row (the param scalars, then the plan's constants), ``sf`` the
# state row and ``ef`` the exit row.  Elementwise ops round as the JAX emit
# does, in its order.
OP_SYNC = 0      # []                          grid-wide barrier
OP_FILL = 1      # [dst, p]                    dst = 0 + pf[p]
OP_AMP = 2       # [dst, src, p_amp]           dst = src * amp
OP_AMP_MOD = 3   # [dst, src, mod, p_amp, p_md]
#                  dst = src * (((1 - md) + md * mod) * amp)
OP_MIX = 4       # [dst, n, src_0.., p_0..]    dst = ((0 + w0*s0) + w1*s1) + ...
OP_I16 = 5       # [dst, src]                  dst = f32(src_i16) * 2^-15
OP_TAP = 6       # [tap, src]                  taps[tap] = src
OP_PEAK = 7      # [stap, l, r]                stap[stap] = max(max|l|, max|r|)
OP_EQ = 8        # [dst, x, agg, sf, p_gains, p_tab, ef, sample_rate]
#                  EqThree over the part: the 3-sample delay from
#                  sf[sf+8..sf+10], both 4-pole cascades from the poles
#                  sf[sf..sf+7] (stage-major), the band mix with gains
#                  pf[p_gains..+2]; exits ef[ef..ef+7] = the poles at the
#                  part's last sample, ef[ef+8..ef+10] = its last 3 inputs.
#                  agg is a scratch slot (the CTAs' aggregate states);
#                  pf[p_tab..] holds ``eq_cuda.kernel_tables`` then f_lo,
#                  f_hi, vsa.  The kernel's EQ holds a grid barrier of its
#                  own, after which it reads the 3 samples before its tile.
OP_NAMES = ("SYNC", "FILL", "AMP", "AMP_MOD", "MIX", "I16", "TAP", "PEAK", "EQ")


class RegionPlan:
    """A region's op list over buffer slots, built by the modules' ``emit``.

    ``n_operands`` slots are the operands; ``new_slot`` hands out f32 scratch
    slots after them.  The ``n_pf`` param scalars come first in the
    parameter row; ``const`` appends constants after them."""

    def __init__(self, n_operands: int, n_pf: int, n_ef: int):
        self.words: List[int] = []
        self.n_operands = n_operands
        self.n_slots = n_operands
        self.n_pf = n_pf
        self.n_ef = n_ef
        self.consts: List[np.ndarray] = []
        self.n_consts = 0
        self.n_taps = 0
        self.n_stap = 0
        self._zero: Optional[int] = None
        self._synced = False

    def new_slot(self) -> int:
        self.n_slots += 1
        return self.n_slots - 1

    def add(self, code: int, *args: int) -> None:
        # the barriers are the plan's business, not the modules': the kernel
        # zeroes the scalar taps before its first barrier (an EQ's own
        # barrier counts; every other op reads only its CTA's samples)
        if code == OP_PEAK and not self._synced:
            self.add(OP_SYNC)
        self._synced |= code in (OP_SYNC, OP_EQ)
        self.words += [code, 2 + len(args), *(int(a) for a in args)]

    def const(self, values) -> int:
        """Append f32 constants; returns the parameter index of the first."""
        arr = np.asarray(values, np.float32).reshape(-1)
        ix = self.n_pf + self.n_consts
        self.consts.append(arr)
        self.n_consts += arr.size
        return ix

    def zero_slot(self) -> int:
        """One shared all-zeros slot (what an unconnected input reads)."""
        if self._zero is None:
            self._zero = self.new_slot()
            self.add(OP_FILL, self._zero, self.const([0.0]))
        return self._zero

    def const_row(self) -> np.ndarray:
        if not self.consts:
            return np.zeros(0, np.float32)
        return np.concatenate(self.consts)

    def meta(self) -> List[int]:
        """The plan's sizes as ints (``from_words`` rebuilds the plan from
        them and its words, without its constants)."""
        return [self.n_operands, self.n_slots, self.n_pf, self.n_ef, self.n_taps, self.n_stap,
                self.n_consts]

    @classmethod
    def from_words(cls, words: Sequence[int], meta: Sequence[int]) -> "RegionPlan":
        n_operands, n_slots, n_pf, n_ef, n_taps, n_stap, n_consts = meta
        plan = cls(n_operands, n_pf, n_ef)
        plan.words = list(words)
        plan.n_slots, plan.n_taps, plan.n_stap, plan.n_consts = n_slots, n_taps, n_stap, n_consts
        return plan

    def ops(self):
        """Yields ``(code, args)`` in order."""
        pc = 0
        while pc < len(self.words):
            code, n = self.words[pc], self.words[pc + 1]
            yield code, self.words[pc + 2:pc + n]
            pc += n


@dataclass
class Peak:
    """A scalar tap: ``max(max |l|, max |r|)`` over the block (scalar taps
    combine across parts with max; NaN wins, as ``jnp.max`` gives it)."""

    l: int
    r: int


class EmitCtx:
    """Per-module view of the plan handed to :meth:`MegaSpec.emit`.

    ``pf`` / ``sf`` / ``ef`` are the absolute indices of the module's param
    scalars, state scalars and exits; ``operands`` maps the module's operand
    names to slots; ``used`` says per output terminal whether anything reads
    it."""

    def __init__(self, plan: RegionPlan, cfg: EngineConfig, block: BlockSpec,
                 pf: List[int], sf: List[int], ef: List[int],
                 operands: Dict[str, int], used: Tuple[bool, ...]):
        self.plan = plan
        self.cfg = cfg
        self.block = block
        self.pf = pf
        self.sf = sf
        self.ef = ef
        self.operands = operands
        self.used = used

    def zeros(self) -> int:
        return self.plan.zero_slot()

    def expect_mono(self, x: Optional[int]) -> int:
        return self.zeros() if x is None else x

    def expect_stereo(self, x: Optional[Tuple[int, int]]) -> Tuple[int, int]:
        if x is None:
            z = self.zeros()
            return (z, z)
        return x

    def op(self, code: int, *args: int) -> int:
        """Append ``code`` writing a new slot (its first argument); returns
        that slot."""
        dst = self.plan.new_slot()
        self.plan.add(code, dst, *args)
        return dst


@dataclass
class MegaSpec:
    """How one module takes part in the whole-graph region program.

    Fields:
      emit(ctx, ins) -> (outs, taps)
          Appends the module's ops to ``ctx.plan``.  ``ins[i]`` is a slot,
          an ``(L, R)`` pair of slots, or None (unconnected: zero semantics
          via ``ctx.expect_*``).  ``outs`` mirrors ``run_block``'s outputs
          with slots; ``taps`` maps declared tap names to a pair of slots,
          a slot, or a :class:`Peak` (scalar tap).
      declare: {"taps": [(name, chans)], "exit_f": n, "exit_i": n}
          ``chans`` 2 = stereo pair, 1 = mono, 0 = scalar.  LAYOUT LAW: the
          module's exits are its state scalars, element for element — part
          N's exit row is part N+1's state row.
      param_scalars(aux, host_aux) -> (f32 items, i32 items)
          Part-invariant scalars (0-d or 1-d tensors, flattened in order).
      state_scalars(state) -> (f32 items, i32 items)
          The carried state flattened (layout == exits).
      operands(aux, host_aux) -> {name: [S] tensor}
          Per-sample arrays the region reads (external feeds).  Any dtype.
      unpack(f_exits, i_exits, old_state) -> new state
          The last part's exits -> the module's state.
      tap_post(taps) -> taps
          Fix-up after the taps are reassembled to ``[T, spt]`` (the output
          device's peak -> its clip bool).
    """

    emit: Callable
    declare: Dict[str, Any] = field(
        default_factory=lambda: {"taps": [], "exit_f": 0, "exit_i": 0}
    )
    param_scalars: Callable = lambda aux, host_aux: ([], [])
    state_scalars: Callable = lambda state: ([], [])
    operands: Callable = lambda aux, host_aux: {}
    unpack: Callable = lambda f, i, old: old
    tap_post: Optional[Callable] = None


class ModuleDef:
    """One module kind. Stateless singleton; all data flows through args."""

    kind: str = "?"

    # -- structure ---------------------------------------------------------
    def terminals(self, params) -> Tuple[List[Terminal], List[Terminal]]:
        """(inputs, outputs), mirroring ModuleT::inputs/outputs."""
        raise NotImplementedError

    # -- device state ------------------------------------------------------
    def init_state(self, params, cfg: EngineConfig, device: torch.device) -> Pytree:
        """Initial carried DSP state (or None)."""
        return None

    def carry_state(self, old_state: Pytree, params, cfg: EngineConfig) -> Pytree:
        """State carried across an edit that rebuilds the program.  Default:
        keep (eq_three keeps its filter poles on a gain change,
        eq_three.rs:53-56).  Modules that reset on edit override this."""
        return old_state

    # -- param lowering ----------------------------------------------------
    def structural_key(self, params) -> Any:
        """Hashable fingerprint of the params' structural parts (what shapes
        the program: waveform, channel count).  An edit that keeps it only
        swaps ``aux``; a fleet's instances must share it."""
        return None

    def prepare(self, params, cfg: EngineConfig, device: torch.device) -> Pytree:
        """Device tensors derived from params (recomputed per edit)."""
        return None

    def host_prepare(
        self, params, t0: int, block: BlockSpec, cfg: EngineConfig
    ) -> Optional[Dict[str, np.ndarray]]:
        """Cheap per-block host computation (numpy), e.g. float64 phase
        bases.  ``t0`` is the absolute sample index of the block start."""
        return None

    def host_columns(self, params_list) -> Optional[Dict[str, np.ndarray]]:
        """The per-instance numbers ``host_prepare`` reads, as float64
        columns [N] of N instances' params, or None.  A fleet keeps them and
        writes a row on an edit."""
        return None

    def host_prepare_columns(
        self, columns: Dict[str, np.ndarray], t0: int, block: BlockSpec, cfg: EngineConfig
    ) -> Dict[str, np.ndarray]:
        """``host_prepare`` of every instance of ``columns`` at once, each
        array stacked [N, ...]; defined where ``host_columns`` is."""
        raise NotImplementedError

    # -- compute -----------------------------------------------------------
    def run_block(
        self,
        params: Any,
        aux: Pytree,
        host_aux: Pytree,
        state: Pytree,
        inputs: Sequence[Optional[Any]],
        cfg: EngineConfig,
        block: BlockSpec,
        device: torch.device,
    ) -> Tuple[Pytree, List[Optional[Any]], Dict[str, Any]]:
        """Block kernel.  ``inputs[i]`` is None iff input i is unconnected
        (or a cycle back-edge): ``expect_mono`` / ``expect_stereo`` below
        give it the reference's zero-buffer semantics."""
        raise NotImplementedError

    def mega_spec(
        self, params, cfg: EngineConfig, block: BlockSpec,
        connected: Sequence[bool],
    ) -> Optional[MegaSpec]:
        """How this module runs inside the region program, or None if it
        can only run through ``run_block`` (a region reaching it then keeps
        the regular program).  ``connected[i]`` says whether input i is
        wired."""
        return None


# ---------------------------------------------------------------------------
# input helpers mirroring InputRef::expect_* zero-fill semantics
# ---------------------------------------------------------------------------


def expect_mono(x: Optional[torch.Tensor], S: int, device: torch.device) -> torch.Tensor:
    if x is None:
        return torch.zeros((S,), dtype=torch.float32, device=device)
    return x


def expect_stereo(
    x: Optional[Tuple[torch.Tensor, torch.Tensor]], S: int, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stereo input with zero-fill semantics.  An unconnected input reads
    ONE zeros tensor aliased to both channels (the reference's shared static
    zero buffer, io.rs:8-9).  Consumers never write to their inputs."""
    if x is None:
        z = torch.zeros((S,), dtype=torch.float32, device=device)
        return (z, z)
    return x


def interleave_tap(pair) -> np.ndarray:
    """Host-side: a channel-major stereo tap — an ``(L, R)`` pair of
    ``[..., spt]`` tensors or arrays — to interleaved ``[..., 2]`` numpy."""
    l, r = pair
    return np.stack([_to_numpy(l), _to_numpy(r)], axis=-1)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
