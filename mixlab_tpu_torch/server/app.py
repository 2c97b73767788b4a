"""HTTP/WebSocket server + session sync loop (the port's copy of
``mixlab_tpu/server/app.py``).

Rebuild of ``src/server.rs``: a single TCP port serves
  * ``GET /``                  — the web UI shell
  * ``GET /session``           — the workspace WebSocket (wire.py protocol)
  * ``GET /_monitor/<uuid>``   — monitor segment stream
  * ``POST /_upload/<name>``   — media upload into the project library
plus Icecast SOURCE and RTMP on the same port via listen disambiguation
(``src/listen.rs``; ``src/server.rs:134-158``).

Session loop semantics (server.rs:197-342):
  * on connect: engine.connect_session -> send WorkspaceState dump;
  * client WorkspaceMessages -> engine.update (Busy errors are dropped —
    the client will retry via its optimistic model);
  * engine events -> ServerUpdates to everyone, Sync echoes only to the
    owning session (server.rs:259-270);
  * lagged clients are force-disconnected (server.rs:251-254) — the engine
    broadcast pushes a None sentinel when a session queue overflows;
  * performance info and media library updates stream to every session.

An Icecast SOURCE or RTMP connection, told apart by the first bytes
(``io_host/listen.py``), goes to the port's listeners
(``io_host/icecast.py``, ``io_host/rtmp/server.py``).  One difference from
the JAX package: the RTMP listener is given the engine's device, to which it
uploads the pictures it decodes.
"""

from __future__ import annotations

import asyncio
import json
import logging
import queue as queue_mod
import threading
from pathlib import Path
from typing import Optional

from mixlab_tpu_torch import protocol as p
from mixlab_tpu_torch.engine.engine import Busy, Engine, SyncEvent, UpdateEvent
from mixlab_tpu_torch.engine.project import ProjectHandle
from mixlab_tpu_torch.io_host import listen
from mixlab_tpu_torch.io_host.listen import PeekStreamReader, Protocol
from mixlab_tpu_torch.io_host.rtmp import server as rtmp_server
from mixlab_tpu_torch.protocol import wire
from mixlab_tpu_torch.server import monitor as monitor_mod
from mixlab_tpu_torch.server import ws as ws_mod
from mixlab_tpu_torch.server.http import HttpError, Request, read_request, response

INDEX_HTML = (Path(__file__).parent / "static" / "index.html")

log = logging.getLogger(__name__)


class Server:
    def __init__(self, project: ProjectHandle):
        self.project = project
        self.engine: Engine = project.engine
        self.rtmp_stats = rtmp_server.IngestStats()  # over this server's publishers

    # -- connection dispatch ----------------------------------------------

    async def handle_connection(
        self, proto: Protocol, reader: PeekStreamReader, writer: asyncio.StreamWriter
    ):
        if proto == Protocol.HTTP:
            await self.handle_http(reader, writer)
        elif proto == Protocol.ICECAST:
            from mixlab_tpu_torch.io_host import icecast

            await icecast.accept(reader, writer)
        elif proto == Protocol.RTMP:
            await rtmp_server.accept(reader, writer, self.engine.device, self.rtmp_stats)

    async def handle_http(self, reader, writer):
        """Persistent-connection request loop (HTTP/1.1 keep-alive); a
        WebSocket upgrade hands the connection over and ends the loop."""
        while True:
            try:
                req = await read_request(reader)
            except HttpError:
                writer.write(response(400, "Bad Request"))
                return
            if req is None:
                return
            keep = await self._handle_request(req, reader, writer)
            try:
                await writer.drain()
            except ConnectionError:
                return
            if not keep:
                return

    MAX_DISCARD_BODY = 1 << 20  # drain unread bodies up to 1 MiB, else close
    MAX_RESTORE_BODY = 64 << 20  # checkpoint blobs (DSP state) cap

    def _fleet_authorized(self, req) -> bool:
        """Fleet admin routes (/_checkpoint, /_restore) honour the shared
        fleet secret when one is configured (MIXLAB_FLEET_TOKEN, propagated
        to workers by the host agent); constant-time compare."""
        import hmac
        import os

        token = os.environ.get("MIXLAB_FLEET_TOKEN", "")
        if not token:
            return True
        auth = req.header("authorization", "")
        return hmac.compare_digest(auth, f"Bearer {token}")

    async def _handle_request(self, req, reader, writer) -> bool:
        """Dispatch one request; -> True to keep the connection open."""
        from mixlab_tpu_torch.server.http import wants_keep_alive

        keep = wants_keep_alive(req)
        # routes that read their own body manage connection framing
        reads_own_body = (
            (req.path.startswith("/_upload/") and req.method == "POST")
            or (req.path == "/_restore" and req.method == "POST")
            or (req.path in ("/session",) and req.method == "GET")
            or (req.path.startswith("/_monitor/") and req.method == "GET")
        )
        if not reads_own_body:
            length = int(req.header("content-length", "0") or 0)
            if length > self.MAX_DISCARD_BODY:
                writer.write(response(413, "Payload Too Large"))
                return False
            if length:
                # drain so the next keep-alive request parses cleanly
                await reader.readexactly(length)
        if req.path == "/" and req.method == "GET":
            body = INDEX_HTML.read_bytes() if INDEX_HTML.exists() else b"mixlab-tpu"
            writer.write(response(200, "OK", body, "text/html; charset=utf-8",
                                  keep_alive=keep))
        elif req.path.startswith("/static/") and req.method == "GET":
            name = req.path[len("/static/") :]
            target = (INDEX_HTML.parent / name).resolve()
            if target.is_file() and target.parent == INDEX_HTML.parent.resolve():
                ctype = {
                    ".js": "text/javascript",
                    ".css": "text/css",
                    ".html": "text/html; charset=utf-8",
                }.get(target.suffix, "application/octet-stream")
                writer.write(response(200, "OK", target.read_bytes(), ctype,
                                      keep_alive=keep))
            else:
                writer.write(response(404, "Not Found", b"not found",
                                      keep_alive=keep))
        elif req.path == "/session" and req.method == "GET":
            await self.handle_session_ws(req, reader, writer)
            return False
        elif req.path.startswith("/_monitor/") and req.method == "GET":
            await self.handle_monitor_ws(req, reader, writer)
            return False
        elif req.path.startswith("/_upload/") and req.method == "POST":
            # upload replies Connection: close (body framing is simplest)
            await self.handle_upload(req, reader, writer)
            return False
        elif req.path == "/_metrics" and req.method == "GET":
            writer.write(response(200, "OK", self._metrics_text(),
                                  "text/plain; version=0.0.4",
                                  keep_alive=keep))
        elif req.path == "/_checkpoint" and req.method == "GET":
            # live-migration support (server/fleet.py): runtime DSP-state
            # snapshot, taken on the engine thread
            from mixlab_tpu_torch.server.fleet import encode_checkpoint

            if not self._fleet_authorized(req):
                writer.write(response(401, "Unauthorized", b"bad token",
                                      keep_alive=keep))
                return keep
            loop = asyncio.get_running_loop()
            try:
                ckpt = await loop.run_in_executor(
                    None, self.engine.checkpoint_sync
                )
                writer.write(response(200, "OK", encode_checkpoint(ckpt),
                                      "application/octet-stream",
                                      keep_alive=keep))
            except Exception:
                writer.write(response(503, "Service Unavailable",
                                      b"checkpoint failed", keep_alive=keep))
        elif req.path == "/_restore" and req.method == "POST":
            from mixlab_tpu_torch.server.fleet import decode_checkpoint

            if not self._fleet_authorized(req):
                writer.write(response(401, "Unauthorized", b"bad token"))
                return False
            length = int(req.header("content-length", "0"))
            if length > self.MAX_RESTORE_BODY:
                # checkpoints are small (DSP state arrays); an unbounded
                # readexactly would let a client exhaust memory
                writer.write(response(413, "Payload Too Large"))
                return False
            body = await reader.readexactly(length) if length else b""
            loop = asyncio.get_running_loop()
            try:
                ok = await loop.run_in_executor(
                    None, self.engine.restore_sync, decode_checkpoint(body)
                )
            except Exception:
                ok = False
            if ok:
                writer.write(response(200, "OK", b"restored",
                                      keep_alive=keep))
            else:
                # state tree mismatch: the initial patch hasn't compiled
                # yet, or the checkpoint is from another workspace shape
                writer.write(response(409, "Conflict", b"state mismatch",
                                      keep_alive=keep))
        else:
            writer.write(response(404, "Not Found", b"not found",
                                  keep_alive=keep))
        return keep

    def _metrics_text(self) -> bytes:
        """Prometheus-style operational metrics (production-deployment
        extension; fleet controllers and dashboards scrape this)."""
        eng = self.engine
        lines = []

        def metric(name, value, help_=None, kind="gauge"):
            if help_:
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name} {value}")

        metric("mixlab_engine_tick", eng.tick,
               "Engine tick counter", "counter")
        metric("mixlab_sessions_connected", eng.session_count(),
               "Connected live sessions (op-log subscribers)")
        metric("mixlab_engine_modules", len(eng.ws.modules),
               "Modules in the workspace")
        metric("mixlab_engine_connections", len(eng.ws.connections),
               "Connections in the workspace")
        metric("mixlab_monitor_pipelines", len(eng._monitor_pipelines),
               "Live monitor codec pipelines")
        info = eng.performance_info()
        if info is not None:
            metric("mixlab_engine_realtime", int(info.realtime),
                   "1 when the engine meets its tick deadlines")
            metric("mixlab_engine_tick_rate", info.tick_rate,
                   "Target ticks per second")
            metric("mixlab_engine_tick_budget_us", info.tick_budget.us,
                   "Tick budget in microseconds")
            for account, m in info.accounts:
                label = account.kind
                if account.module_id is not None:
                    label += f"_{account.module_id.value}"
                metric(f'mixlab_engine_account_us{{account="{label}"}}',
                       m.last.us)
        return ("\n".join(lines) + "\n").encode()

    # -- websocket helpers -------------------------------------------------

    async def _upgrade(self, req: Request, reader, writer) -> Optional[ws_mod.WebSocket]:
        key = req.header("sec-websocket-key")
        if req.header("upgrade", "").lower() != "websocket" or not key:
            writer.write(response(400, "Bad Request", b"websocket required"))
            return None
        # permessage-deflate when the client offers it (RFC 7692)
        ext = ws_mod.negotiate_deflate(req.header("sec-websocket-extensions"))
        ext_header, server_wbits = ext if ext else (None, 15)
        writer.write(ws_mod.handshake_response(key, ext_header))
        await writer.drain()
        return ws_mod.WebSocket(reader, writer, deflate=ext is not None,
                                server_wbits=server_wbits)

    # -- /session ----------------------------------------------------------

    async def handle_session_ws(self, req, reader, writer):
        sock = await self._upgrade(req, reader, writer)
        if sock is None:
            return
        loop = asyncio.get_running_loop()
        session_id, state, events = await loop.run_in_executor(
            None, self.engine.connect_session
        )
        await sock.send_text(wire.server_message("WorkspaceState", state))

        lib = self.project.base.media_library()
        await sock.send_text(wire.server_message("MediaLibrary", lib))

        stop = asyncio.Event()

        async def pump_events():
            while not stop.is_set():
                ev = await loop.run_in_executor(None, _queue_get, events, 0.25)
                if ev is _TIMEOUT:
                    continue
                if ev is None:  # lag sentinel: force disconnect
                    break
                try:
                    if isinstance(ev, UpdateEvent):
                        await sock.send_text(
                            wire.server_message("Update", ev.update)
                        )
                    elif isinstance(ev, SyncEvent):
                        # Sync only to the owning session (server.rs:259-270)
                        if ev.clock.session_id == session_id:
                            await sock.send_text(
                                wire.server_message("Sync", ev.clock.sequence)
                            )
                except ConnectionError:
                    break
            stop.set()

        async def pump_perf():
            last = None
            while not stop.is_set():
                await asyncio.sleep(0.5)
                info = self.engine.performance_info()
                if info is not None and info is not last:
                    last = info
                    try:
                        await sock.send_text(
                            wire.server_message("Performance", info)
                        )
                    except ConnectionError:
                        break
            stop.set()

        pumps = [asyncio.create_task(pump_events()), asyncio.create_task(pump_perf())]
        try:
            while True:
                msg = await sock.recv()
                if msg is None:
                    break
                _, payload = msg
                try:
                    kind, body = wire.parse_envelope(payload)
                    # strict decode INSIDE the guard: hostile bodies raise
                    # WireDecodeError (a ValueError) and are skipped; they
                    # must never reach the engine thread (wire.py decode
                    # contract) nor kill this session task
                    wsmsg = (wire.decode(body, p.WorkspaceMessage)
                             if kind == "Workspace" else None)
                except (ValueError, json.JSONDecodeError):
                    continue
                if wsmsg is not None:
                    # the engine cmd queue is bounded (8, engine.rs:74); the
                    # engine drains it every tick, so retry briefly instead
                    # of dropping the op (the reference kills the session on
                    # Busy, server.rs — a harsher policy)
                    for _ in range(100):
                        try:
                            self.engine.update(session_id, wsmsg)
                            break
                        except Busy:
                            await asyncio.sleep(0.02)
        finally:
            stop.set()
            for t in pumps:
                t.cancel()
            self.engine._log.unsubscribe(events)
            await sock.close()

    # -- /_monitor/<uuid> --------------------------------------------------

    async def handle_monitor_ws(self, req, reader, writer):
        socket_id = req.path.rsplit("/", 1)[-1]
        bc = monitor_mod.get_socket(socket_id)
        if bc is None:
            writer.write(response(404, "Not Found", b"no such monitor"))
            return
        sock = await self._upgrade(req, reader, writer)
        if sock is None:
            return
        loop = asyncio.get_running_loop()
        sub = bc.subscribe()
        # watch for client close/EOF: without this a viewer that navigates
        # away during a segment stall would keep this handler alive forever
        # (sends don't fail until buffers fill)
        gone = asyncio.ensure_future(self._drain_client(sock))
        try:
            # codec construction is deferred to the pipeline thread
            # (server/monitor.py); wait for the REAL init packet so the
            # first frame a subscriber sees is never the provisional one
            ready = getattr(bc, "ready", None)
            if ready is not None:
                await loop.run_in_executor(None, ready.wait, 15)
            await sock.send_binary(bc.init_packet)
            while True:
                pkt = await loop.run_in_executor(None, _queue_get, sub, 0.25)
                if pkt is _TIMEOUT:
                    if sock.closed or gone.done():
                        break
                    continue
                await sock.send_binary(pkt)
        except ConnectionError:
            pass
        finally:
            gone.cancel()
            bc.unsubscribe(sub)
            await sock.close()

    @staticmethod
    async def _drain_client(sock):
        """Consume (and discard) client frames until close/EOF; the recv
        loop also answers pings. Monitor clients send nothing meaningful."""
        try:
            while await sock.recv() is not None:
                pass
        except (ConnectionError, asyncio.IncompleteReadError):
            pass

    # -- /_upload/<filename> -----------------------------------------------

    async def handle_upload(self, req, reader, writer):
        """Stream the body straight into chunked blob storage — constant
        memory for arbitrarily large media (server.rs:297-342 streams through
        WriteStream the same way)."""
        filename = req.path[len("/_upload/") :]
        length = int(req.header("content-length", "0"))
        kind = req.header("content-type", "application/octet-stream")
        loop = asyncio.get_running_loop()
        ws = await loop.run_in_executor(None, self.project.base.create_stream)
        remaining = length
        while remaining > 0:
            chunk = await reader.read(min(remaining, 1 << 20))
            if not chunk:
                break
            await loop.run_in_executor(None, ws.write, chunk)
            remaining -= len(chunk)
        stream_id = await loop.run_in_executor(None, ws.finalize)
        await loop.run_in_executor(
            None, self.project.base.insert_media, filename, kind, stream_id
        )
        self.project.notify_media.set()
        writer.write(response(200, "OK"))


_TIMEOUT = object()


def _queue_get(q: "queue_mod.Queue", timeout: float):
    try:
        return q.get(timeout=timeout)
    except queue_mod.Empty:
        return _TIMEOUT


async def run_server(project: ProjectHandle, host: str = "127.0.0.1", port: int = 8000):
    server = Server(project)
    project.engine.start()
    tcp = await listen.start(host, port, server.handle_connection)
    return tcp, server
