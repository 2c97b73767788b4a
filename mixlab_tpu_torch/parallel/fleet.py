"""Fleet: N independent sessions of one patch as one batched block program,
split over a mesh of devices (port of ``mixlab_tpu/parallel/fleet.py``).

A ``Fleet`` runs N instances of one compiled patch — the same graph
structure, each instance with its own params (aux), DSP state and host
arrays — as the patch's block program mapped over a leading instance axis
(``engine.compiler.batched_program``): the region program where the block
qualifies (e.g. 16 ticks at 48 kHz: one region launch a part a shard), as
the JAX fleet runs ``jax.vmap`` of its chosen program, else the regular
one.  The instances are split into contiguous shards, one a mesh entry
(``parallel.Mesh``), as the JAX package's ``P(axis)`` splits them; each
shard's program runs on its own device, so one call renders a block for
every session and each kernel on the path (the region's, or the EqThree's;
the Envelope's at offline block sizes) launches once a block a shard.  The
region program keeps the regular program's state and tap structure, so
edits, resets and checkpoints are the same on both.  The taps come back in
instance order on the first shard's device.

A param edit of one instance writes its row of the stacked aux, which is
kept in host memory as numpy (as the JAX package keeps it) and shipped to
the instance's own shard once a leaf at the next block after an edit;
nothing is rebuilt.  The host arrays of a block (oscillator phase bases)
are computed for all instances in one vectorized pass where the module
defines ``host_columns``: the fleet keeps those per-instance columns (the
oscillators' frequencies), built once and written a row an edit.  Other
modules' arrays are broadcast where every instance has the same params, and
looped otherwise.

``build`` takes ``mesh=`` (a ``Mesh`` or a sequence of devices) or, as a
one-entry mesh, ``device=``.  A fleet's sessions stay in one process
(``distributed.fleet_owner`` places sessions on processes), so a mesh
joined to a process group is refused.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from mixlab_tpu_torch.convert import stack, to_numpy, to_torch, tree_leaves, tree_map
from mixlab_tpu_torch.device import resolve_device
from mixlab_tpu_torch.dsp.base import ModuleDef
from mixlab_tpu_torch.dsp.registry import get_def
from mixlab_tpu_torch.engine.compiler import CompiledPatch, compile_patch, upload_all
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.engine.graph import Workspace
from mixlab_tpu_torch.parallel import as_mesh, gather_rows, shard_programs
from mixlab_tpu_torch.spans import span

_CPU = torch.device("cpu")


def _key(mid) -> str:
    return str(mid.value)


def _rows(tree, shard):
    """A shard's rows of a stacked tree (views)."""
    return tree_map(lambda x: x[shard.lo:shard.hi], tree)


def host_aux_row(patch: CompiledPatch, ws: Workspace) -> Dict[str, Any]:
    """One instance's aux (``prepare`` of each module of ``patch`` with
    ``ws``'s params) as host numpy."""
    return to_numpy({
        _key(mid): get_def(ws.modules[mid].params.kind).prepare(
            ws.modules[mid].params.params, patch.cfg, _CPU)
        for mid in patch.order})


def host_state_row(patch: CompiledPatch, ws: Workspace) -> Dict[str, Any]:
    """One instance's initial DSP state as host numpy."""
    return to_numpy({
        _key(mid): get_def(ws.modules[mid].params.kind).init_state(
            ws.modules[mid].params.params, patch.cfg, _CPU)
        for mid in patch.order})


def instance_params(patch: CompiledPatch) -> Dict[str, Any]:
    """Module key -> the raw params ``patch`` was compiled with."""
    return {_key(mid): e.params.params for mid, e in patch.entries.items()}


def reset_rows(state, init, rows) -> None:
    """Set rows ``rows`` of every stacked state leaf to the single-instance
    ``init`` leaf, in place: a few rows in one multi-tensor copy, many with
    one indexed copy a leaf."""
    pairs = list(zip(tree_leaves(state), tree_leaves(init)))
    if not rows or not pairs:
        return
    if len(rows) * len(pairs) <= 256:
        torch._foreach_copy_([s[r] for s, _ in pairs for r in rows],
                             [i for _, i in pairs for _ in rows])
        return
    idx = torch.tensor(rows, device=pairs[0][0].device)
    for s, i in pairs:
        s.index_copy_(0, idx, i.expand(len(rows), *i.shape))


@dataclass
class Shard:
    """One mesh entry of a fleet: its device, its instances' rows
    ``[lo, hi)``, the patch compiled for its device and its batched
    program."""

    device: torch.device
    lo: int
    hi: int
    patch: CompiledPatch
    fn: Callable


@dataclass
class Fleet:
    """N instances of one patch, batched on the leading axis, one stacked
    tree a shard."""

    cfg: EngineConfig
    block: BlockSpec
    n: int
    patch: CompiledPatch  # the first shard's
    shards: List[Shard]
    aux: Any  # stacked [n, ...] host numpy
    state: List[Any]  # a shard's stacked [hi - lo, ...] tensors on its device
    _params: List[Dict[str, Any]] = field(default_factory=list)  # per instance
    tap_transform: Optional[Callable] = None
    _dev_aux: List[Any] = field(default_factory=list)  # a shard's aux, None after an edit
    # module key -> its host columns (``ModuleDef.host_columns``), [n] each
    _columns: Dict[str, Dict[str, np.ndarray]] = field(default_factory=dict)
    _column_stats: Dict[str, int] = field(
        default_factory=lambda: {"builds": 0, "row_writes": 0})

    def __post_init__(self):
        self._build_columns()

    @property
    def device(self) -> torch.device:
        return self.patch.device

    @classmethod
    def build(
        cls,
        ws: Workspace,
        n: int,
        cfg: EngineConfig = EngineConfig(),
        block: BlockSpec = BlockSpec(1),
        per_instance_params: Optional[List[Workspace]] = None,
        device="cuda",
        mesh=None,
        axis: str = "fleet",
        tap_transform: Optional[Callable] = None,
        mega: Optional[bool] = None,
    ) -> "Fleet":
        """One program a device, n stacked instances split over ``mesh``
        (``n`` a multiple of its size), or on ``device`` alone.

        ``per_instance_params``: n workspaces of the SAME structural
        fingerprint with their own continuous params.  ``tap_transform``: a
        device-side pass over each shard's stacked taps (e.g. f32 -> i16
        PCM).  ``mega``: the program choice of ``compile_patch`` (None: the
        region program where the block qualifies)."""
        m = as_mesh(device, mesh, axis)
        if m.group is not None:
            raise ValueError("a fleet runs in one process: place sessions on processes "
                             "with distributed.fleet_owner, and give each a local mesh")
        patches, programs, bounds = shard_programs(ws, cfg, block, m, n, mega)
        patch = patches[m[0]]
        if per_instance_params is None:
            # identical instances share ONE params view (host_aux then
            # computes once and broadcasts)
            params = [instance_params(patch)] * n
            sources = [ws] * n
        else:
            if len(per_instance_params) != n:
                raise ValueError(f"{len(per_instance_params)} instance workspaces for n={n}")
            # params views: their programs never run, so no region is built
            views = [compile_patch(w, cfg, block, m[0], mega=False) for w in per_instance_params]
            if {v.structural_fingerprint for v in views} != {patch.structural_fingerprint}:
                raise ValueError("fleet instances must share the structural fingerprint")
            params = [instance_params(v) for v in views]
            sources = per_instance_params
        shards = [Shard(d, lo, hi, patches[d], programs[d]) for d, (lo, hi) in zip(m, bounds)]
        # the rows built on the host, each shard's stacked state leaf
        # uploaded once
        aux = stack([host_aux_row(patch, w) for w in sources])
        rows = stack([host_state_row(patch, w) for w in sources])
        state = [to_torch(_rows(rows, sh), sh.device) for sh in shards]
        return cls(cfg=cfg, block=block, n=n, patch=patch, shards=shards, aux=aux,
                   state=state, _params=params, tap_transform=tap_transform,
                   _dev_aux=[None] * len(shards))

    def shard_of(self, index: int) -> int:
        """The shard that holds instance ``index``."""
        return next(i for i, sh in enumerate(self.shards) if sh.lo <= index < sh.hi)

    # -- per-instance edits (no rebuild) ---------------------------------------

    def update_instance_aux(self, index: int, ws: Workspace):
        """Swap one instance's continuous params: host-memory writes, shipped
        to its shard by the next block.  A structural change raises
        ``ValueError``."""
        view = compile_patch(ws, self.cfg, self.block, self.device, mega=False)
        if view.structural_fingerprint != self.patch.structural_fingerprint:
            raise ValueError("instance edit changed the structural fingerprint")
        self.set_instance_row(index, host_aux_row(self.patch, ws), instance_params(view))

    def set_instance_row(self, index: int, row, params: Dict[str, Any]):
        """Write a prepared aux row (``host_aux_row``) and its params view."""
        def put(stacked, leaf):
            stacked[index] = leaf

        tree_map(put, self.aux, row)
        self._params[index] = params
        for k, d in self._column_modules():
            for name, v in d.host_columns([params[k]]).items():
                self._columns[k][name][index] = v[0]
        self._column_stats["row_writes"] += 1
        self._dev_aux[self.shard_of(index)] = None

    def aux_changed(self):
        """The host aux was written: the next block ships it to every
        shard."""
        self._dev_aux = [None] * len(self.shards)

    def init_state(self, ws: Workspace) -> List[Any]:
        """``ws``'s initial DSP state, single-instance, on each shard's
        device."""
        return [sh.patch.init_state(ws) for sh in self.shards]

    def reset_rows(self, state: List[Any], init: List[Any], rows) -> None:
        """Rows ``rows`` (instance indices) of ``state`` (one stacked tree a
        shard) set to ``init`` (``init_state``), in place, on each row's
        shard."""
        for sh, st, i in zip(self.shards, state, init):
            reset_rows(st, i, [r - sh.lo for r in rows if sh.lo <= r < sh.hi])

    def reset_instance_state(self, index: int, ws: Workspace):
        """Reset one instance's DSP state to init (session join / leave): one
        multi-tensor write on its shard's device."""
        s = self.shard_of(index)
        sh = self.shards[s]
        reset_rows(self.state[s], sh.patch.init_state(ws), [index - sh.lo])

    # -- host columns ----------------------------------------------------------

    def _column_modules(self):
        """``(key, def)`` of each module that has host columns."""
        for mid in self.patch.order:
            d = get_def(self.patch.entries[mid].params.kind)
            if type(d).host_columns is not ModuleDef.host_columns:
                yield _key(mid), d

    def _build_columns(self):
        """Every module's host columns from all instances' params."""
        with span("fleet.columns"):
            self._columns = {k: d.host_columns([p[k] for p in self._params])
                             for k, d in self._column_modules()}
        self._column_stats["builds"] += 1

    def host_column_stats(self) -> Dict[str, int]:
        """How often the host columns were built whole and written a row."""
        return dict(self._column_stats)

    # -- execution -----------------------------------------------------------

    def _module_host(self, mid, params, t0, feeds=None):
        """One module's host arrays for one instance, with its external feeds
        (zeros where a feed is missing)."""
        k = _key(mid)
        d = get_def(self.patch.entries[mid].params.kind)
        h = d.host_prepare(params[k], t0, self.block, self.cfg) or {}
        for name, (shape, dtype) in (self.patch._ext_specs.get(k) or {}).items():
            arr = (feeds or {}).get(k, {}).get(name)
            h = {**h, name: np.zeros(shape, dtype) if arr is None else arr}
        return h or None

    def host_aux(self, t0: int, ext_feeds_per_instance=None):
        """The block's host arrays, stacked [n, ...] in host memory.  Per
        module: ``host_prepare_columns`` of its host columns where it has
        them, one compute broadcast where all instances share their params,
        else a loop over the instances."""
        if ext_feeds_per_instance:
            return stack([
                {_key(mid): self._module_host(mid, self._params[i], t0,
                                              ext_feeds_per_instance.get(i))
                 for mid in self.patch.order}
                for i in range(self.n)])
        out: Dict[str, Any] = {}
        for mid in self.patch.order:
            k = _key(mid)
            kind = self.patch.entries[mid].params.kind
            d = get_def(kind)
            with span("fleet.host.", kind):
                if k in self._columns:
                    h = d.host_prepare_columns(self._columns[k], t0, self.block, self.cfg)
                elif type(d).host_prepare is ModuleDef.host_prepare:  # no host arrays
                    h = {}
                else:
                    h = self._batched_host(d, [p[k] for p in self._params], t0)
                for name, (shape, dtype) in (self.patch._ext_specs.get(k) or {}).items():
                    h[name] = np.zeros((self.n,) + tuple(shape), dtype)
            out[k] = h or None
        return out

    def _batched_host(self, d, plist, t0):
        """One module's host arrays for all instances without host columns
        (``host_aux``)."""
        if all(p is plist[0] for p in plist[1:]):
            h1 = d.host_prepare(plist[0], t0, self.block, self.cfg) or {}
            return {name: np.broadcast_to(np.asarray(v), (self.n,) + np.shape(v))
                    for name, v in h1.items()}
        pp = [d.host_prepare(p, t0, self.block, self.cfg) or {} for p in plist]
        return {name: np.stack([np.asarray(x[name]) for x in pp]) for name in pp[0]}

    def device_aux(self, s: int):
        """Shard ``s``'s rows of the stacked aux on its device (uploaded
        after an edit)."""
        if self._dev_aux[s] is None:
            sh = self.shards[s]
            self._dev_aux[s] = to_torch(_rows(self.aux, sh), sh.device)
        return self._dev_aux[s]

    def step(self, host_aux, state):
        """``(state', taps)`` of one block from the stacked host arrays:
        each shard's program launched in shard order, the taps gathered in
        instance order on the first shard's device."""
        new_state, taps = [], []
        for s, (sh, st) in enumerate(zip(self.shards, state)):
            with span("fleet.upload"):
                args = self.device_aux(s), upload_all(_rows(host_aux, sh), sh.device)
            with span("fleet.dispatch"):
                st, tp = sh.fn(*args, st)
            new_state.append(st)
            taps.append(tp)
        with span("fleet.gather"):
            if self.tap_transform is not None:
                taps = [self.tap_transform(tp) for tp in taps]
            return new_state, tree_map(lambda *xs: gather_rows(xs, self.device), *taps)

    def run_block(self, t0: int, ext_feeds_per_instance=None):
        """One batched block for the whole fleet; returns the stacked taps."""
        self.state, taps = self.step(self.host_aux(t0, ext_feeds_per_instance), self.state)
        return taps
