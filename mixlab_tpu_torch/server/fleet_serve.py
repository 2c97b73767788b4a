"""Fleet serving: N live sessions through one batched block program a block
(port of ``mixlab_tpu/server/fleet_serve.py``).

One process, one loop thread, one ``parallel/fleet.py`` program over the
fleet's slots, serving N real sessions:

  * WebSocket clients connect on ``/fleet``; each is given a slot and its
    own ``WorkspaceState``;
  * a session's param edits arrive as ordinary ``WorkspaceMessage`` ops and
    are applied without a rebuild (``Fleet.update_instance_aux``), with the
    single-session server's optimistic Sync echo (server.rs:259-270);
    structural edits are rejected (the fleet serves one graph structure);
  * each session's Monitor taps are converted to i16 PCM on the device
    (``_i16_taps``: clipped to [-1, 1], scaled by 32767 and truncated toward
    zero, as JAX's ``astype(int16)``) and fanned out to its socket as framed
    PCM blocks.

A join or a leave is host work: the slot's aux row goes back to the
template's, and the next block resets the slot's DSP state inside the step
(``Fleet.reset_rows`` on the slots of the reset mask).  The loop issues one block
ahead: a block's taps are copied to pinned host memory with
``non_blocking=True`` behind a CUDA event and fanned out one block later, so
the copy overlaps the next block's work.  The loop measures itself as the
realtime engine does (absolute deadlines, ``EngineStat``), so ``/status``
gives the served sessions' schedule health.

Left out, as in the port's engine: the JAX package's tunnel machinery (the
probed device worker, lost-op re-dispatch); device work runs on the fleet's
own loop thread.
"""

from __future__ import annotations

import asyncio
import json
import logging
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from mixlab_tpu_torch import protocol as p
from mixlab_tpu_torch.convert import to_numpy, tree_leaves, tree_map
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.engine.graph import Workspace
from mixlab_tpu_torch.engine.timing import EngineStat
from mixlab_tpu_torch.parallel.fleet import Fleet, instance_params
from mixlab_tpu_torch.protocol import wire
from mixlab_tpu_torch.server import ws as ws_mod
from mixlab_tpu_torch.server.http import Request, read_request, response
from mixlab_tpu_torch.server.monitor import frame_packet
from mixlab_tpu_torch.spans import span

log = logging.getLogger(__name__)


def _i16_taps(taps):
    """f32 [-1, 1] -> i16 PCM on every tap leaf, on the taps' device (the
    reference's PCM wire format, src/source.rs:63; half the bytes to
    fetch)."""
    return tree_map(lambda x: (torch.clamp(x, -1.0, 1.0) * 32767.0).to(torch.int16), taps)


class _Slot:
    """One occupied fleet slot = one live session."""

    def __init__(self, index: int, ws: Workspace):
        self.index = index
        self.ws = ws
        self.joined_sample = 0  # set at join; gates in-flight fan-out
        self.monitors: List[object] = []  # _MonitorSub
        # sync/error echoes: a queue for direct-drive callers and the
        # registered asyncio bridges of the session's socket
        self.events: "queue.Queue" = queue.Queue(maxsize=64)
        self.event_subs: List[object] = []


class _MonitorSub:
    """Bridges the loop thread to one session's asyncio socket: the loop
    thread hands packets over with ``call_soon_threadsafe``, the socket task
    awaits them.  Bounded, dropping on lag: a slow viewer loses blocks and
    never stalls the fleet (monitor.rs:164-176)."""

    DEPTH = 8

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self.loop = loop
        self.q: asyncio.Queue = asyncio.Queue(maxsize=self.DEPTH)
        self.dropped = 0

    def push_threadsafe(self, pkt):
        self.loop.call_soon_threadsafe(self._push, pkt)

    def _push(self, pkt):
        try:
            self.q.put_nowait(pkt)
        except asyncio.QueueFull:
            self.dropped += 1


def _start_fetch(taps):
    """Start the taps' copy to the host: on a card into pinned host memory
    with ``non_blocking=True`` and an event recorded behind it; returns
    ``(host taps, event or None)``."""
    if not any(x.is_cuda for x in tree_leaves(taps)):
        return taps, None

    def copy(x):
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        return h

    host = tree_map(copy, taps)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _finish_fetch(fetch):
    host, event = fetch
    if event is not None:
        with span("fleet.fetch_wait"):
            event.synchronize()
    return to_numpy(host)


class FleetEngine:
    """The serving loop over a ``parallel/fleet.py`` Fleet of ``capacity``
    slots.  Joins, leaves and edits arrive through a bounded command queue
    and are applied between blocks (engine.rs:193-214)."""

    def __init__(
        self,
        template: Workspace,
        capacity: int,
        cfg: EngineConfig = EngineConfig(sample_rate=48_000),
        block_ticks: int = 15,
        device="cuda",
    ):
        self.cfg = cfg
        self.block = BlockSpec(block_ticks)
        self.capacity = capacity
        self.template = template
        self.fleet = Fleet.build(template, capacity, cfg, self.block, device=device,
                                 tap_transform=_i16_taps)
        self._init = self.fleet.init_state(template)
        self._reset_mask = np.ones(capacity, dtype=bool)  # the first block inits
        # issue-ahead, depth 1: a block's tap copy overlaps the next block
        self._inflight: List = []
        # the template's aux row and params: a vacated slot goes back to them
        self._template_row = tree_map(lambda x: x[0].copy(), self.fleet.aux)
        self._template_params = instance_params(self.fleet.patch)
        self.slots: List[Optional[_Slot]] = [None] * capacity
        self._free = list(range(capacity - 1, -1, -1))  # pop() -> slot 0 first
        self._cmd: "queue.Queue" = queue.Queue(maxsize=max(256, capacity * 4))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stat = EngineStat(tick_rate=cfg.ticks_per_second)
        self.tick = 0
        self._run_t0 = None
        self._lock = threading.Lock()  # slots / occupancy views
        self._tap_keys = [str(mid.value) for mid, e in template.modules.items()
                          if e.params.kind == "Monitor"]
        self._warm()

    # -- lifecycle -----------------------------------------------------------

    def _step(self, host_aux, state, reset_mask):
        """One block: the slots of ``reset_mask`` back to their initial state
        (in place), then the batched program; taps as i16."""
        with span("fleet.reset"):
            self.fleet.reset_rows(state, self._init, np.flatnonzero(reset_mask).tolist())
        return self.fleet.step(host_aux, state)

    def _warm(self):
        """The first block on a copy of the state (kernels built and loaded);
        the reset mask stays all True, so the first served block starts every
        slot from its initial state."""
        state = tree_map(torch.clone, self.fleet.state)
        _, taps = self._step(self.fleet.host_aux(0), state, self._reset_mask)
        _finish_fetch(_start_fetch(taps))

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True, name="fleet-engine")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10.0)

    # -- session API (any thread) -----------------------------------------------

    def join(self, timeout: float = 10.0) -> Optional[_Slot]:
        done: "queue.Queue" = queue.Queue(maxsize=1)
        self._cmd.put(("join", done), timeout=timeout)
        return done.get(timeout=timeout)

    def leave(self, slot: _Slot):
        try:
            self._cmd.put(("leave", slot), timeout=5.0)
        except queue.Full:
            pass

    def update(self, slot: _Slot, msg: p.WorkspaceMessage):
        """Queue one client op; Sync (and the op's outcome) is echoed on
        ``slot.events``."""
        self._cmd.put(("op", slot, msg), timeout=5.0)

    def add_monitor(self, slot: _Slot, sub: _MonitorSub):
        self._cmd.put(("monitor+", slot, sub), timeout=5.0)

    def remove_monitor(self, slot: _Slot, sub: _MonitorSub):
        try:
            self._cmd.put(("monitor-", slot, sub), timeout=5.0)
        except queue.Full:
            pass

    def add_events(self, slot: _Slot, sub: _MonitorSub):
        self._cmd.put(("events+", slot, sub), timeout=5.0)

    def remove_events(self, slot: _Slot, sub: _MonitorSub):
        try:
            self._cmd.put(("events-", slot, sub), timeout=5.0)
        except queue.Full:
            pass

    def status(self) -> dict:
        with self._lock:
            occupied = sum(1 for s in self.slots if s is not None)
        stat = self._stat
        mean = 0.0
        if self._run_t0 and self.tick:
            mean = self.tick / (time.monotonic() - self._run_t0)
        return {
            "capacity": self.capacity,
            "occupied": occupied,
            "tick": self.tick,
            "block_ticks": self.block.n_ticks,
            "achieved_tick_rate": round(mean, 2),
            "on_schedule_fraction": round(stat.realtime_fraction_total, 4),
            "max_late_ms": round(stat.total_max_late_s * 1e3, 2)
            if stat.total_max_late_s > -1e8
            else None,
        }

    # -- loop thread -------------------------------------------------------------

    def _run(self):
        start = time.monotonic()
        self._run_t0 = start
        tps = self.cfg.ticks_per_second
        n = self.block.n_ticks
        while not self._stop.is_set():
            scheduled_end = start + (self.tick + n) / tps
            behind = time.monotonic() - scheduled_end
            if behind > 1.0:
                # re-anchor rather than burst (Engine._run discipline)
                start += behind
                scheduled_end += behind
            self._stat.record_tick(scheduled_end, self._block_once)
            # drain commands, then sleep to the absolute deadline
            while True:
                try:
                    timeout = scheduled_end - time.monotonic()
                    cmd = self._cmd.get_nowait() if timeout <= 0 else self._cmd.get(
                        timeout=timeout)
                except queue.Empty:
                    break
                try:
                    self._process_cmd(cmd)
                except Exception:
                    log.exception("fleet command failed; loop continues")

    def _block_once(self):
        t0 = self.tick * self.cfg.samples_per_tick
        mask = self._reset_mask.copy()  # resets consumed by THIS block
        self.fleet.state, taps = self._step(self.fleet.host_aux(t0), self.fleet.state, mask)
        self._reset_mask &= ~mask  # later joins' bits survive
        with span("fleet.fetch_start"):
            self._inflight.append((t0, _start_fetch(taps)))
        if len(self._inflight) > 1:  # the pipeline is full: the previous block's taps
            t0_prev, fetch = self._inflight.pop(0)
            host = _finish_fetch(fetch)
            with span("fleet.fan_out"):
                self._fan_out(t0_prev, host)
        self.tick += self.block.n_ticks

    def _fan_out(self, t0: int, taps):
        """One framed PCM packet per occupied slot per monitor."""
        S = self.block.n_samples(self.cfg)
        for slot in self.slots:
            if slot is None or not slot.monitors:
                continue
            if t0 < slot.joined_sample:
                # a block issued before this session joined belongs to the
                # slot's previous occupant: never deliver it
                continue
            for key in self._tap_keys:
                tp = taps.get(key)
                if tp is None:
                    continue
                l, r = tp["audio"]
                pcm = np.empty((S, 2), dtype=np.int16)
                pcm[:, 0] = l[slot.index].reshape(-1)
                pcm[:, 1] = r[slot.index].reshape(-1)
                pkt = frame_packet(
                    {"t": "pcm", "t0": t0, "rate": self.cfg.sample_rate, "channels": 2},
                    pcm.tobytes(),
                )
                for sub in list(slot.monitors):
                    sub.push_threadsafe(pkt)

    def _process_cmd(self, cmd):
        kind = cmd[0]
        if kind == "join":
            done = cmd[1]
            with self._lock:
                if not self._free:
                    done.put(None)
                    return
                index = self._free.pop()
                slot = _Slot(index, self.template.snapshot())
                slot.joined_sample = self.tick * self.cfg.samples_per_tick
                self.slots[index] = slot
            # host work only: the slot's aux row already is the template's,
            # and the next block resets its DSP state
            self._reset_mask[index] = True
            done.put(slot)
        elif kind == "leave":
            slot = cmd[1]
            with self._lock:
                if self.slots[slot.index] is slot:
                    self.slots[slot.index] = None
                    self._free.append(slot.index)
            slot.monitors.clear()
            # back to the template's params (host aux write); the next block
            # resets the slot's state
            self.fleet.set_instance_row(slot.index, self._template_row, self._template_params)
            self._reset_mask[slot.index] = True
        elif kind == "op":
            _, slot, msg = cmd
            self._apply_op(slot, msg)
        elif kind == "monitor+":
            cmd[1].monitors.append(cmd[2])
        elif kind == "monitor-":
            if cmd[2] in cmd[1].monitors:
                cmd[1].monitors.remove(cmd[2])
        elif kind == "events+":
            cmd[1].event_subs.append(cmd[2])
        elif kind == "events-":
            if cmd[2] in cmd[1].event_subs:
                cmd[1].event_subs.remove(cmd[2])

    def _apply_op(self, slot: _Slot, msg: p.WorkspaceMessage):
        """Param edits only; structural ops are rejected typed (the fleet
        tier's scope).  Sync is always echoed so the client's optimistic UI
        un-gates (frontend/src/session.rs:93-108); a rejected op also echoes
        an error event."""
        op = msg.op
        err = None
        if isinstance(op, p.UpdateModuleParams):
            entry = slot.ws.modules.get(op.module_id)
            if entry is None:
                err = "no such module"
            else:
                before = entry.params
                slot.ws.update_params(op.module_id, op.params)
                try:
                    self.fleet.update_instance_aux(slot.index, slot.ws)
                except ValueError as e:
                    # structural change (e.g. waveform): roll back
                    slot.ws.update_params(op.module_id, before)
                    err = str(e)
        elif isinstance(op, p.UpdateWindowGeometry):
            if op.module_id in slot.ws.geometry:
                slot.ws.geometry[op.module_id] = op.geometry
        else:
            err = ("structural edits need a dedicated engine; the fleet tier "
                   "serves one shared graph structure")
        self._post_event(slot, ("sync", msg.sequence))
        if err is not None:
            self._post_event(slot, ("error", msg.sequence, err))

    @staticmethod
    def _post_event(slot: _Slot, ev):
        try:
            slot.events.put_nowait(ev)
        except queue.Full:
            pass
        for sub in list(slot.event_subs):
            sub.push_threadsafe(ev)


# ---------------------------------------------------------------------------
# websocket server
# ---------------------------------------------------------------------------


class FleetServeApp:
    """Asyncio server for a FleetEngine.

    Routes:
      * ``GET /fleet``  — websocket: join (Joined + WorkspaceState), then
        WorkspaceMessage ops in / Sync + framed i16 PCM monitor blocks out
      * ``GET /status`` — JSON occupancy and schedule health
    """

    def __init__(self, engine: FleetEngine):
        self.engine = engine
        self._server: Optional[asyncio.AbstractServer] = None

    async def serve(self, bind: str = "127.0.0.1", port: int = 0) -> int:
        # backlog sized for a full-fleet connect storm
        self._server = await asyncio.start_server(self._handle, bind, port, backlog=4096)
        return self._server.sockets[0].getsockname()[1]

    async def shutdown(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader, writer):
        try:
            req = await read_request(reader)
            if req is None:
                return
            if req.path == "/status" and req.method == "GET":
                body = json.dumps(self.engine.status()).encode()
                writer.write(response(200, "OK", body, content_type="application/json"))
                await writer.drain()
            elif req.path.startswith("/fleet") and req.method == "GET":
                await self._handle_fleet_ws(req, reader, writer)
            else:
                writer.write(response(404, "Not Found", b""))
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _handle_fleet_ws(self, req: Request, reader, writer):
        key = req.header("sec-websocket-key")
        if (req.header("upgrade") or "").lower() != "websocket" or not key:
            writer.write(response(400, "Bad Request", b"websocket required"))
            await writer.drain()
            return
        # no permessage-deflate: the stream is mostly i16 PCM
        writer.write(ws_mod.handshake_response(key))
        await writer.drain()
        sock = ws_mod.WebSocket(reader, writer)

        loop = asyncio.get_running_loop()
        slot = await loop.run_in_executor(None, self.engine.join, 30.0)
        if slot is None:
            await sock.send_text(json.dumps({"t": "Full"}))
            await sock.close()
            return
        sub = _MonitorSub(loop)
        esub = _MonitorSub(loop)
        self.engine.add_monitor(slot, sub)
        self.engine.add_events(slot, esub)
        state = _dump_state(slot.ws)
        await sock.send_text(json.dumps({"t": "Joined", "slot": slot.index,
                                         "capacity": self.engine.capacity}))
        await sock.send_text(wire.server_message("WorkspaceState", state))

        stop = asyncio.Event()

        async def pump_monitor():
            while not stop.is_set():
                try:
                    pkt = await asyncio.wait_for(sub.q.get(), timeout=0.25)
                except asyncio.TimeoutError:
                    continue
                try:
                    await sock.send_binary(pkt)
                except (ConnectionError, asyncio.IncompleteReadError):
                    break
            stop.set()

        async def pump_events():
            while not stop.is_set():
                try:
                    ev = await asyncio.wait_for(esub.q.get(), timeout=0.25)
                except asyncio.TimeoutError:
                    continue
                try:
                    if ev[0] == "sync":
                        await sock.send_text(json.dumps({"t": "Sync", "sequence": ev[1]}))
                    elif ev[0] == "error":
                        await sock.send_text(json.dumps({"t": "Error", "sequence": ev[1],
                                                         "message": ev[2]}))
                except (ConnectionError, asyncio.IncompleteReadError):
                    break
            stop.set()

        pumps = [asyncio.create_task(pump_monitor()), asyncio.create_task(pump_events())]
        try:
            while True:
                msg = await sock.recv()
                if msg is None:
                    break
                _, payload = msg
                try:
                    kind, body = wire.parse_envelope(payload)
                    wsmsg = (wire.decode(body, p.WorkspaceMessage)
                             if kind == "Workspace" else None)
                except (ValueError, json.JSONDecodeError):
                    continue  # strict decode: hostile payloads are skipped
                if wsmsg is not None:
                    await loop.run_in_executor(None, self.engine.update, slot, wsmsg)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            stop.set()
            for t in pumps:
                t.cancel()
            self.engine.remove_monitor(slot, sub)
            self.engine.remove_events(slot, esub)
            self.engine.leave(slot)
            await sock.close()


def _dump_state(ws: Workspace) -> p.WorkspaceState:
    state = p.WorkspaceState()
    for mid, entry in ws.modules.items():
        state.modules.append((mid, entry.params))
        state.inputs.append((mid, list(entry.inputs)))
        state.outputs.append((mid, list(entry.outputs)))
    for mid, geom in ws.geometry.items():
        state.geometry.append((mid, geom))
    for mid, ind in ws.indications.items():
        state.indications.append((mid, ind))
    for i, o in ws.connections.items():
        state.connections.append((i, o))
    return state
