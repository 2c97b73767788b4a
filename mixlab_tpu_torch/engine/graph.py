"""Workspace graph: modules, connections, type-checked patching
(port of ``mixlab_tpu/engine/graph.py``, bound to the port's registry).

The JAX package's ``Workspace`` cannot be imported without jax (its module
imports the JAX DSP registry), so the port carries its own with the same
semantics: the edits the engine's client ops make (create, connect,
disconnect, update_params, delete_module) and the snapshot / restore around
each op, ``connect`` enforcing line-type equality (workspace.rs:97-114),
persistence mirrors ``persist::Workspace`` (persist.rs:9-21) and the files
are interchangeable with the JAX package's, and run order is the reference's
terminal-module DFS (engine.rs:400-457) computed once per render.  A
back-edge input of a cycle reads a buffer not produced yet in this block,
which the compiler lowers to zeros (engine.rs:478-483).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from mixlab_tpu_torch.protocol import (
    Indication,
    InputId,
    LineType,
    ModuleId,
    ModuleParams,
    OutputId,
    Terminal,
    WindowGeometry,
    wire,
)
from mixlab_tpu_torch.dsp.registry import get_def


class ConnectError(Exception):
    pass


class NoInput(ConnectError):
    pass


class NoOutput(ConnectError):
    pass


class TypeMismatch(ConnectError):
    pass


@dataclass
class ModuleEntry:
    params: ModuleParams
    inputs: List[Terminal]
    outputs: List[Terminal]


@dataclass
class Workspace:
    module_seq: int = 0
    modules: Dict[ModuleId, ModuleEntry] = field(default_factory=dict)
    geometry: Dict[ModuleId, WindowGeometry] = field(default_factory=dict)
    connections: Dict[InputId, OutputId] = field(default_factory=dict)
    indications: Dict[ModuleId, Indication] = field(default_factory=dict)

    # -- editing ----------------------------------------------------------

    def create_module(
        self, params: ModuleParams, geometry: WindowGeometry = WindowGeometry()
    ) -> ModuleId:
        self.module_seq += 1
        mid = ModuleId(self.module_seq)
        ins, outs = get_def(params.kind).terminals(params.params)
        self.modules[mid] = ModuleEntry(params, list(ins), list(outs))
        self.geometry[mid] = geometry
        self.indications[mid] = Indication(params.kind, None)
        return mid

    def snapshot(self) -> "Workspace":
        """Structural copy for transactional op application: the engine
        takes one before a client op and restores it if the op fails.
        ``ModuleEntry.params`` objects are replaced, never mutated, so a
        shallow copy per entry suffices."""
        return Workspace(
            module_seq=self.module_seq,
            modules={
                mid: ModuleEntry(e.params, list(e.inputs), list(e.outputs))
                for mid, e in self.modules.items()
            },
            geometry=dict(self.geometry),
            connections=dict(self.connections),
            indications=dict(self.indications),
        )

    def restore(self, snap: "Workspace") -> None:
        """Adopt a snapshot's state in place (rollback of a failed op)."""
        self.module_seq = snap.module_seq
        self.modules = snap.modules
        self.geometry = snap.geometry
        self.connections = snap.connections
        self.indications = snap.indications

    def update_params(self, mid: ModuleId, params: ModuleParams) -> bool:
        """Replace a module's params and rebuild its terminals; connections
        into inputs that no longer exist are dropped (e.g. a mixer's channel
        count reduced).  False if the module does not exist."""
        entry = self.modules.get(mid)
        if entry is None:
            return False
        if params.kind != entry.params.kind:
            raise ValueError("module params kind mismatch")
        ins, outs = get_def(params.kind).terminals(params.params)
        entry.params = params
        entry.inputs = list(ins)
        entry.outputs = list(outs)
        for input_id in list(self.connections):
            if input_id.module_id == mid and input_id.index >= len(entry.inputs):
                del self.connections[input_id]
        return True

    def delete_module(self, mid: ModuleId) -> List[InputId]:
        """Delete a module and every connection into or out of it; returns
        the deleted connections' input ids (engine.rs:324-358)."""
        deleted = [
            input_id
            for input_id, output_id in self.connections.items()
            if input_id.module_id == mid or output_id.module_id == mid
        ]
        for input_id in deleted:
            del self.connections[input_id]
        self.modules.pop(mid, None)
        self.geometry.pop(mid, None)
        self.indications.pop(mid, None)
        return deleted

    def terminal_type(self, tid) -> Optional[LineType]:
        if not isinstance(tid, (InputId, OutputId)):
            return None
        entry = self.modules.get(tid.module_id)
        if entry is None:
            return None
        terms = entry.inputs if isinstance(tid, InputId) else entry.outputs
        return terms[tid.index].line_type if tid.index < len(terms) else None

    def connect(self, input_id: InputId, output_id: OutputId) -> Optional[OutputId]:
        """Type-checked connect; returns the replaced connection if any
        (workspace.rs:97-114)."""
        in_ty = self.terminal_type(input_id)
        if in_ty is None:
            raise NoInput(str(input_id))
        out_ty = self.terminal_type(output_id)
        if out_ty is None:
            raise NoOutput(str(output_id))
        if in_ty != out_ty:
            raise TypeMismatch(f"{in_ty} != {out_ty}")
        prev = self.connections.get(input_id)
        self.connections[input_id] = output_id
        return prev

    def disconnect(self, input_id: InputId) -> Optional[OutputId]:
        return self.connections.pop(input_id, None)

    # -- scheduling -------------------------------------------------------

    def run_order(self) -> List[ModuleId]:
        """Terminal-module DFS topo order (engine.rs:400-457), visiting
        terminals and inputs in sorted id order (deterministic)."""
        consumed = {out.module_id for out in self.connections.values()}
        terminals = sorted(
            (mid for mid in self.modules if mid not in consumed),
            key=lambda m: m.value,
        )
        order: List[ModuleId] = []
        seen = set()

        def traverse(mid: ModuleId):
            if mid in seen:
                return
            seen.add(mid)
            entry = self.modules[mid]
            for i in range(len(entry.inputs)):
                out = self.connections.get(InputId(mid, i))
                if out is not None and out.module_id in self.modules:
                    traverse(out.module_id)
            order.append(mid)

        for mid in terminals:
            traverse(mid)
        return order

    # -- persistence (persist.rs:9-21) ------------------------------------

    def to_persist(self) -> dict:
        return {
            "module_seq": self.module_seq,
            "modules": {
                str(mid.value): {
                    "params": wire.encode(entry.params),
                    "geometry": wire.encode(self.geometry.get(mid, WindowGeometry())),
                    "inputs": [
                        (
                            [out.module_id.value, out.index]
                            if (out := self.connections.get(InputId(mid, i)))
                            else None
                        )
                        for i in range(len(entry.inputs))
                    ],
                }
                for mid, entry in self.modules.items()
            },
        }

    @staticmethod
    def from_persist(save: dict) -> "Workspace":
        ws = Workspace(module_seq=save.get("module_seq", 0))
        # create modules first, then connect (workspace.rs:22-56)
        for mid_str, saved in save.get("modules", {}).items():
            mid = ModuleId(int(mid_str))
            params = wire.decode_module_params(saved["params"])
            ins, outs = get_def(params.kind).terminals(params.params)
            ws.modules[mid] = ModuleEntry(params, list(ins), list(outs))
            ws.geometry[mid] = wire._decode_typed(saved["geometry"], WindowGeometry)
            ws.indications[mid] = Indication(params.kind, None)
        for mid_str, saved in save.get("modules", {}).items():
            mid = ModuleId(int(mid_str))
            for i, out in enumerate(saved.get("inputs", [])):
                if out is not None:
                    try:
                        ws.connect(InputId(mid, i), OutputId(ModuleId(out[0]), out[1]))
                    except ConnectError:
                        pass  # ignore, matching workspace.rs:47-50
        return ws
