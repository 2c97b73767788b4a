"""Graph compiler: workspace patch -> one block program
(port of ``mixlab_tpu/engine/compiler.py``).

The patch is frozen once per render into a ``CompiledPatch`` whose
``run(aux, host_aux, state)`` renders one block.  PyTorch runs eagerly, so
there is no jit and nothing to recompile: a param edit only swaps ``aux``.

Reference semantics preserved:
  * run order = terminal-module DFS (engine.rs:408-457)
  * disconnected inputs read zeros (io.rs:8-9) — lowered to None
  * cycle back-edges read zeros (engine.rs:478-483): a back-edge's producer
    comes later in the run order, so its buffer is absent and the input is
    None exactly like a disconnected one
  * absolute sample clock t = tick * samples_per_tick (engine.rs:490): t0
    is an exact Python int on the host and reaches the device only through
    per-module ``host_prepare`` arrays

Two programs, as in the JAX package: the regular one calls every module's
``run_block`` in run order; the region program
(:mod:`mixlab_tpu_torch.engine.region_graph`) runs the EqThree and
everything downstream of it as one kernel launch per part.  ``mega=None``
takes the region program where the graph and block qualify, ``mega=True``
requires it (``ValueError`` otherwise), ``mega=False`` keeps the regular one.

``batched_program`` maps the chosen program over a leading instance axis
(the fleet's sessions, the stems) with ``torch.func.vmap``, as the JAX fleet
runs ``jax.vmap(patch._fn)``: the region program's part launches, and the
regular program's EqThree and Envelope kernels, launch once a block for all
instances through their custom ops' batching rules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mixlab_tpu_torch.dsp.registry import get_def
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.engine.graph import ModuleEntry, Workspace
from mixlab_tpu_torch.protocol import InputId, LineType, ModuleId, OutputId
from mixlab_tpu_torch.spans import span


def _mid_key(mid: ModuleId) -> str:
    return str(mid.value)


def _host_tensor(v) -> torch.Tensor:
    """A numpy array as a CPU tensor; a read-only one (a broadcast view)
    copied, as torch tensors are writable."""
    a = np.ascontiguousarray(v)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def upload(host_aux: Optional[Dict[str, np.ndarray]], device: torch.device):
    """A module's numpy ``host_aux`` dict -> tensors on ``device``."""
    if host_aux is None:
        return None
    return {k: _host_tensor(v).to(device) for k, v in host_aux.items()}


@dataclass
class CompiledPatch:
    """A frozen block program for one workspace snapshot on one device."""

    cfg: EngineConfig
    block: BlockSpec
    device: torch.device
    order: List[ModuleId]
    structural_fingerprint: Any  # equal for workspaces one program serves
    entries: Dict[ModuleId, ModuleEntry]
    connections: Dict[InputId, OutputId]
    _fn: Callable  # (aux, host_aux on the device, state) -> (state, taps)
    _ext_specs: Dict[str, Dict[str, Tuple[tuple, Any]]]
    _mega: bool  # the region program was chosen

    # -- per-edit / per-block data ----------------------------------------

    def prepare_aux(self, ws: Workspace) -> Dict[str, Any]:
        return {
            _mid_key(mid): get_def(ws.modules[mid].params.kind).prepare(
                ws.modules[mid].params.params, self.cfg, self.device)
            for mid in self.order
        }

    def init_state(self, ws: Workspace) -> Dict[str, Any]:
        return {
            _mid_key(mid): get_def(ws.modules[mid].params.kind).init_state(
                ws.modules[mid].params.params, self.cfg, self.device)
            for mid in self.order
        }

    def host_aux(
        self, t0: int, ext_feeds: Optional[Dict[str, Dict[str, np.ndarray]]] = None
    ) -> Dict[str, Optional[Dict[str, np.ndarray]]]:
        """Per-block host-prepared numpy arrays for the block starting at
        absolute sample ``t0``, keyed by module id key.  ``ext_feeds``
        carries host-originated audio (StreamInput / MediaSource PCM) keyed
        by module id key; missing feeds are zero-filled."""
        out = {}
        with span("patch.host_aux"):
            for mid, e in self.entries.items():
                k = _mid_key(mid)
                h = get_def(e.params.kind).host_prepare(
                    e.params.params, t0, self.block, self.cfg) or {}
                feeds = (ext_feeds or {}).get(k, {})
                for name, (shape, dtype) in self._ext_specs.get(k, {}).items():
                    arr = feeds.get(name)
                    h = {**h, name: np.zeros(shape, dtype) if arr is None else arr}
                out[k] = h or None
        return out

    def serves(self, ws: Workspace) -> bool:
        """Whether this program runs ``ws`` as it stands: the same
        structural fingerprint, so an edit from the compiled workspace to
        ``ws`` changed continuous params only."""
        order = ws.run_order()
        return self.structural_fingerprint == structural_fingerprint(
            order, {m: ws.modules[m] for m in order}, ws.connections)

    def refresh_params(self, ws: Workspace) -> None:
        """Take ``ws``'s params (a param-only edit, ``serves(ws)``) into
        the frozen entries, in place: ``host_aux`` (an oscillator's phase
        bases) and the regular program read them from there."""
        for mid, e in self.entries.items():
            self.entries[mid] = ModuleEntry(ws.modules[mid].params, e.inputs, e.outputs)

    # -- the program ------------------------------------------------------

    def run(self, aux, host_aux, state):
        """Render one block: ``(aux, host_aux (numpy), state) -> (state',
        taps)``; taps map module id key -> tap name -> tensor(s)."""
        with span("patch.upload"):
            dev_aux = upload_all(host_aux, self.device)
        with span("patch.dispatch"):
            return self._fn(aux, dev_aux, state)


def run_modules(mids, entries, connections, aux, dev_aux, state, cfg, block, device):
    """``run_block`` of each module of ``mids`` in order; an input reads the
    buffer an earlier module of ``mids`` wrote, else None (unconnected, or
    a cycle's back-edge: zeros).  ``dev_aux`` is ``host_aux`` uploaded.
    Returns ``(buffers, new_state, taps)``."""
    buffers: Dict[OutputId, Any] = {}
    new_state = {}
    taps = {}
    for mid in mids:
        entry = entries[mid]
        k = _mid_key(mid)
        ins: List[Optional[Any]] = []
        for i, term in enumerate(entry.inputs):
            if term.line_type == LineType.VIDEO:
                ins.append(None)  # video flows through the host video engine
                continue
            out_id = connections.get(InputId(mid, i))
            ins.append(buffers.get(out_id) if out_id is not None else None)
        with span("module.", entry.params.kind):
            st, outs, tp = get_def(entry.params.kind).run_block(
                entry.params.params, aux[k], dev_aux[k], state[k], ins, cfg, block, device)
        new_state[k] = st
        if tp:
            taps[k] = tp
        for i, buf in enumerate(outs):
            if buf is not None:
                buffers[OutputId(mid, i)] = buf
    return buffers, new_state, taps


def _regular_program(order, entries, connections, cfg, block, device):
    def program(aux, dev_aux, state):
        _, new_state, taps = run_modules(order, entries, connections, aux, dev_aux,
                                         state, cfg, block, device)
        return new_state, taps

    return program


def upload_all(host_aux, device: torch.device):
    """A block's numpy ``host_aux`` (a dict per module key, or None; stacked
    [n, ...] leaves for a batched program) -> tensors on ``device``: one
    transfer a leaf."""
    return {k: upload(h, device) for k, h in host_aux.items()}


def batched_program(patch: CompiledPatch) -> Callable:
    """The block program of ``patch`` (the region program where it was
    chosen, else the regular one) over a leading instance axis: ``(aux,
    dev_host_aux, state) -> (state', taps)`` with every tensor leaf stacked
    [n, ...] and ``dev_host_aux`` already on the device (``upload_all``).
    ``None`` leaves (modules without state, aux or host arrays) stay out of
    the mapped arguments and are put back inside."""
    from mixlab_tpu_torch.convert import tree_leaves, tree_unflatten

    fn = patch._fn

    def program(aux, dev_aux, state):
        args = (aux, dev_aux, state)
        structure = []

        def one(*leaves):
            new_state, taps = fn(*tree_unflatten(args, leaves))
            structure.append((new_state, taps))
            return tuple(tree_leaves((new_state, taps)))

        outs = torch.func.vmap(one)(*tree_leaves(args))
        return tree_unflatten(structure[0], outs)

    return program


def structural_fingerprint(order, entries, connections):
    """What a program is built from apart from continuous params: module
    kinds and structural keys, terminal types and connections (the JAX
    package's fingerprint)."""
    return tuple(
        (mid.value, e.params.kind, get_def(e.params.kind).structural_key(e.params.params),
         tuple(t.line_type for t in e.inputs), tuple(t.line_type for t in e.outputs))
        for mid, e in ((m, entries[m]) for m in order)
    ) + tuple(sorted((i.module_id.value, i.index, o.module_id.value, o.index)
                     for i, o in connections.items()))


def compile_patch(
    ws: Workspace,
    cfg: EngineConfig,
    block: BlockSpec,
    device: torch.device,
    mega: Optional[bool] = None,
) -> CompiledPatch:
    order = ws.run_order()
    # freeze structure (entries are copied: a later edit of ws does not
    # change this program)
    entries = {
        mid: ModuleEntry(ws.modules[mid].params, list(ws.modules[mid].inputs),
                         list(ws.modules[mid].outputs))
        for mid in order
    }
    connections = dict(ws.connections)
    ext_specs = {}
    for mid, e in entries.items():
        d = get_def(e.params.kind)
        if hasattr(d, "ext_spec"):
            spec = d.ext_spec(e.params.params, cfg, block)
            if spec:
                ext_specs[_mid_key(mid)] = spec

    fn = None
    if mega is not False:
        from mixlab_tpu_torch.engine.region_graph import build_mega_program

        fn = build_mega_program(ws, cfg, block, device)
        if fn is None and mega is True:
            raise ValueError("region program requested but the graph / block "
                             "does not qualify")
    return CompiledPatch(
        cfg=cfg,
        block=block,
        device=device,
        order=order,
        structural_fingerprint=structural_fingerprint(order, entries, connections),
        entries=entries,
        connections=connections,
        _fn=fn or _regular_program(order, entries, connections, cfg, block, device),
        _ext_specs=ext_specs,
        _mega=fn is not None,
    )
