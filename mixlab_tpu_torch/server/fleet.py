"""Fleet controller: spawn / route / migrate workspaces across hosts (port of
``mixlab_tpu/server/fleet.py``).

Many workspaces served by a fleet of machines, each workspace an ordinary
``python -m mixlab_tpu_torch`` server process bound to its own port.  Three
roles, all speaking the port's own HTTP stack:

  * **worker** — the normal server (``server/app.py``), with ``GET
    /_checkpoint`` (runtime DSP-state snapshot, taken on the engine thread)
    and ``POST /_restore`` (adopt a snapshot) for live migration.
  * **HostAgent** — one per machine: spawns/stops worker processes on its
    device (``--device``, ``cuda`` by default; ``POST /spawn/<key>``,
    ``POST /stop/<key>``), reports them (``GET /health``, with each
    worker's connected sessions from its ``/_metrics``), packages a
    workspace for migration (``GET /export/<key>`` = checkpoint + project
    file bytes; ``POST /import/<key>`` = the reverse) and, with a respawn
    interval, brings a crashed worker back (the watchdog).
  * **FleetController** — agents register and heartbeat; ``POST
    /workspaces/<key>`` places a workspace on the live agent with the
    fewest connected sessions, then the fewest workspaces; ``GET
    /route/<key>`` resolves a workspace to its worker URL (respawning it if
    its process died); ``POST /migrate/<key>`` moves a running workspace to
    another host: checkpoint + project file travel over HTTP, the target
    worker resumes from the same tick, and routing flips.

The checkpoint blob (``encode_checkpoint``, the npz of ``tick``, ``n`` and
the DSP state leaves ``s0..s{n-1}``), the export blob and every route are
the JAX package's, byte for byte, so a workspace exported by either
package's agent imports into the other's.  A shared-secret token
(``check_token``) gates every admin route; ``FleetTls`` pins one cert/key
pair as the control plane's trust root (mutual TLS).

    python -m mixlab_tpu_torch.server.fleet controller --listen 127.0.0.1:8100
    python -m mixlab_tpu_torch.server.fleet agent --controller http://127.0.0.1:8100 \
        --host-id h1 --data /srv/mixlab/h1 --device cuda:0
"""

from __future__ import annotations

import asyncio
import hmac
import io
import json
import logging
import os
import signal
import socket
import ssl as ssl_mod
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from mixlab_tpu_torch.server.http import HttpError, read_request, response

log = logging.getLogger(__name__)

HEARTBEAT_TTL = 6.0  # an agent is live if it heartbeat within this window

MAX_JSON_BODY = 1 << 20  # control messages (register/heartbeat/migrate)
MAX_IMPORT_BODY = 1 << 30  # migration blobs carry whole project files


def check_token(req, token: Optional[str]) -> bool:
    """Shared-secret gate on every admin route, constant-time compare.
    No token configured = open (loopback/dev); production fleets set one."""
    if not token:
        return True
    auth = req.header("authorization", "")
    return hmac.compare_digest(auth, f"Bearer {token}")


class FleetTls:
    """TLS material for the fleet control plane: one cert/key pair per
    fleet, pinned as the trust root on every peer —
    controller and agents serve TLS and verify each other against the
    pinned CA (hostname checks are off: the pin IS the identity, suiting
    cross-datacenter fleets without a name-issuing CA).  Worker admin
    traffic stays on loopback HTTP behind the agent.  Combine with the
    shared-secret token: TLS authenticates the channel, the token the
    caller."""

    def __init__(self, certfile: str, keyfile: str,
                 cafile: Optional[str] = None):
        self.certfile = certfile
        self.keyfile = keyfile
        self.cafile = cafile or certfile  # self-signed pin by default

    def server_ctx(self) -> ssl_mod.SSLContext:
        ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.certfile, self.keyfile)
        # mutual TLS: clients must present a cert under the pinned CA too
        # (the fleet shares one cert/key pair), so a reachable port alone
        # is not enough to speak to the control plane
        ctx.load_verify_locations(self.cafile)
        ctx.verify_mode = ssl_mod.CERT_REQUIRED
        return ctx

    def client_ctx(self) -> ssl_mod.SSLContext:
        ctx = ssl_mod.create_default_context(cafile=self.cafile)
        ctx.check_hostname = False  # pinned CA, not public PKI
        ctx.verify_mode = ssl_mod.CERT_REQUIRED
        ctx.load_cert_chain(self.certfile, self.keyfile)  # our side of mTLS
        return ctx


# ---------------------------------------------------------------------------
# checkpoint blob codec (engine.checkpoint() <-> bytes)
# ---------------------------------------------------------------------------


def encode_checkpoint(ckpt: dict) -> bytes:
    arrays = {f"s{i}": np.asarray(a) for i, a in enumerate(ckpt["dsp_state"])}
    bio = io.BytesIO()
    np.savez(bio, tick=np.int64(ckpt.get("tick", 0)),
             n=np.int64(len(arrays)), **arrays)
    return bio.getvalue()


def decode_checkpoint(blob: bytes) -> dict:
    z = np.load(io.BytesIO(blob), allow_pickle=False)
    n = int(z["n"])
    return {
        "tick": int(z["tick"]),
        "dsp_state": [z[f"s{i}"] for i in range(n)],
    }


# ---------------------------------------------------------------------------
# tiny asyncio HTTP client (loopback/DCN control plane)
# ---------------------------------------------------------------------------


async def http_call(url: str, method: str = "GET", body: bytes = b"",
                    timeout: float = 30.0, token: Optional[str] = None,
                    ssl_ctx: Optional[ssl_mod.SSLContext] = None
                    ) -> Tuple[int, bytes]:
    """Minimal HTTP/1.1 request; returns (status, body).  https:// URLs use
    ssl_ctx (a FleetTls pinned client context) or default system trust;
    ssl_ctx is ignored for plain http:// (loopback worker traffic)."""
    scheme, sep, rest = url.partition("://")
    assert sep and scheme in ("http", "https"), url
    hostport, _, path = rest.partition("/")
    host, _, port = hostport.partition(":")
    tls = (ssl_ctx or ssl_mod.create_default_context()) \
        if scheme == "https" else None
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, int(port or (443 if tls else 80)),
                                ssl=tls), timeout)
    try:
        auth = f"Authorization: Bearer {token}\r\n" if token else ""
        head = (f"{method} /{path} HTTP/1.1\r\nHost: {hostport}\r\n{auth}"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n")
        writer.write(head.encode() + body)
        await writer.drain()
        raw = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout)
        status = int(raw.split(b"\r\n")[0].split(b" ")[1])
        length = 0
        for line in raw.split(b"\r\n")[1:]:
            if line.lower().startswith(b"content-length"):
                length = int(line.split(b":")[1])
        payload = (await asyncio.wait_for(reader.readexactly(length), timeout)
                   if length else b"")
        return status, payload
    finally:
        writer.close()


def free_port(bind: str = "127.0.0.1") -> int:
    s = socket.socket()
    s.bind((bind, 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# host agent
# ---------------------------------------------------------------------------


class HostAgent:
    """Per-machine process manager for workspace servers."""

    def __init__(self, host_id: str, data_dir: Path, bind: str = "127.0.0.1",
                 python: str = sys.executable, spawn_timeout: float = 300.0,
                 respawn_interval: Optional[float] = None,
                 token: Optional[str] = None,
                 tls: Optional[FleetTls] = None,
                 device: str = "cuda"):
        self.token = token
        self.tls = tls
        self._client_ssl = tls.client_ctx() if tls else None
        self.host_id = host_id
        self.device = device  # the workers' --device
        self.data_dir = Path(data_dir)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.bind = bind
        self.python = python
        self.spawn_timeout = spawn_timeout
        self.respawn_interval = respawn_interval  # None = no watchdog
        self.procs: Dict[str, dict] = {}  # key -> {proc, port, url}
        self._watchdog_task = None
        self._spawn_lock = asyncio.Lock()

    # -- process management --------------------------------------------------

    @staticmethod
    def _safe_key(key: str) -> str:
        """Workspace keys are identifiers, not paths: reject anything that
        would traverse or alias (two keys must never share files)."""
        if not key or len(key) > 128 or not all(
            c.isalnum() or c in "-_." for c in key
        ) or key.startswith("."):
            raise ValueError(f"invalid workspace key: {key!r}")
        return key

    def _workspace_path(self, key: str) -> Path:
        return self.data_dir / f"{self._safe_key(key)}.mixlab"

    async def spawn(self, key: str) -> dict:
        key = self._safe_key(key)
        # serialize spawns: the watchdog and a concurrent route respawn
        # must not both start workers for the same key
        async with self._spawn_lock:
            ent = self.procs.get(key)
            if ent and ent["proc"].poll() is None:
                return {"url": ent["url"], "already": True}
            port = free_port(self.bind)
            logfile = open(self.data_dir / f"{key}.log", "ab")
            env = dict(os.environ)
            if self.token:
                # workers gate /_checkpoint and /_restore on the same secret
                env["MIXLAB_FLEET_TOKEN"] = self.token
            try:
                proc = subprocess.Popen(
                    [self.python, "-m", "mixlab_tpu_torch",
                     "--listen", f"{self.bind}:{port}",
                     "--device", self.device,
                     str(self._workspace_path(key))],
                    stdout=logfile, stderr=subprocess.STDOUT,
                    cwd=str(Path(__file__).resolve().parents[2]),
                    env=env,
                )
            finally:
                logfile.close()  # the child owns its inherited fd
            url = f"http://{self.bind}:{port}"
            deadline = time.monotonic() + self.spawn_timeout
            while time.monotonic() < deadline:
                if proc.poll() is not None:
                    raise RuntimeError(f"worker for {key} died on startup")
                try:
                    status, _ = await http_call(url + "/", timeout=2.0)
                    if status == 200:
                        break
                except (OSError, asyncio.TimeoutError,
                        asyncio.IncompleteReadError):
                    pass
                await asyncio.sleep(0.25)
            else:
                proc.terminate()
                raise RuntimeError(f"worker for {key} never became ready")
            self.procs[key] = {"proc": proc, "port": port, "url": url}
            return {"url": url, "already": False}

    async def stop(self, key: str) -> bool:
        ent = self.procs.pop(key, None)
        if not ent:
            return False
        proc = ent["proc"]
        proc.terminate()
        try:
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, proc.wait, 10)
            except subprocess.TimeoutExpired:
                pass
        finally:
            # unconditional: graceful shutdown can stall on a wedged engine
            # dispatch (or this coroutine can be cancelled mid-wait) — the
            # worker must never outlive its agent entry
            if proc.poll() is None:
                proc.kill()
                try:
                    proc.wait(5)
                except subprocess.TimeoutExpired:
                    log.error("worker %s (pid %s) survived SIGKILL?!",
                              key, proc.pid)
        return True

    def health(self) -> dict:
        return {
            "host_id": self.host_id,
            "workspaces": {
                key: {"url": ent["url"],
                      "alive": ent["proc"].poll() is None}
                for key, ent in self.procs.items()
            },
            "load": sum(1 for e in self.procs.values()
                        if e["proc"].poll() is None),
        }

    async def _worker_sessions(self, url: str) -> int:
        """Connected-session count scraped from a worker's /_metrics;
        0 when the worker is unreachable or mid-boot (placement then
        falls back to workspace count alone)."""
        try:
            status, body = await http_call(url + "/_metrics", timeout=3.0)
        except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError):
            return 0
        if status != 200:
            return 0
        for line in body.decode("utf-8", "replace").splitlines():
            if line.startswith("mixlab_sessions_connected"):
                try:
                    return int(float(line.split()[1]))
                except (IndexError, ValueError):
                    return 0
        return 0

    async def health_full(self) -> dict:
        """health() plus live-session counts: placement weighs connected
        sessions ahead of raw workspace count."""
        h = self.health()
        live = [(key, ent) for key, ent in h["workspaces"].items()
                if ent["alive"]]
        counts = await asyncio.gather(
            *[self._worker_sessions(ent["url"]) for _, ent in live]
        )
        for (key, ent), n in zip(live, counts):
            ent["sessions"] = n
        h["sessions"] = int(sum(counts))
        return h

    # -- migration ------------------------------------------------------------

    async def export(self, key: str) -> bytes:
        """Checkpoint the live worker, stop it, and package
        {runtime checkpoint, project file} for transfer."""
        ent = self.procs.get(key)
        ckpt = b""
        if ent and ent["proc"].poll() is None:
            try:
                status, ckpt = await http_call(ent["url"] + "/_checkpoint",
                                               token=self.token)
                if status != 200:
                    ckpt = b""
            except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError):
                ckpt = b""
        await self.stop(key)
        path = self._workspace_path(key)
        file_bytes = path.read_bytes() if path.exists() else b""
        header = json.dumps({"ckpt_len": len(ckpt),
                             "file_len": len(file_bytes)}).encode()
        return header + b"\n" + ckpt + file_bytes

    async def import_(self, key: str, blob: bytes) -> dict:
        header, _, rest = blob.partition(b"\n")
        meta = json.loads(header)
        ckpt = rest[: meta["ckpt_len"]]
        file_bytes = rest[meta["ckpt_len"]: meta["ckpt_len"] + meta["file_len"]]
        self._workspace_path(key).write_bytes(file_bytes)
        result = await self.spawn(key)
        if ckpt:
            # the worker compiles its initial patch shortly after boot;
            # retry until the state tree matches (or give up: the project
            # file alone still carries the full workspace)
            for _ in range(20):
                try:
                    status, _ = await http_call(
                        result["url"] + "/_restore", "POST", ckpt,
                        token=self.token)
                    if status == 200:
                        result["restored"] = True
                        break
                except (OSError, asyncio.TimeoutError,
                        asyncio.IncompleteReadError):
                    pass
                await asyncio.sleep(0.25)
            else:
                result["restored"] = False
        return result

    # -- HTTP service ----------------------------------------------------------

    async def handle(self, reader, writer):
        try:
            await self._handle(reader, writer)
        finally:
            writer.close()  # else the server's wait_closed() waits on it

    async def _handle(self, reader, writer):
        try:
            req = await read_request(reader)
        except HttpError:
            writer.write(response(400, "Bad Request"))
            return
        if req is None:
            return
        if not check_token(req, self.token):
            writer.write(response(401, "Unauthorized", b"bad token"))
            try:
                await writer.drain()
            except ConnectionError:
                pass
            return
        try:
            if req.path == "/health" and req.method == "GET":
                writer.write(_json_response(await self.health_full()))
            elif req.path.startswith("/spawn/") and req.method == "POST":
                writer.write(_json_response(await self.spawn(req.path[7:])))
            elif req.path.startswith("/stop/") and req.method == "POST":
                writer.write(_json_response(
                    {"stopped": await self.stop(req.path[6:])}))
            elif req.path.startswith("/export/") and req.method == "GET":
                blob = await self.export(req.path[8:])
                writer.write(response(200, "OK", blob,
                                      "application/octet-stream"))
            elif req.path.startswith("/import/") and req.method == "POST":
                body = await _read_body(req, reader, MAX_IMPORT_BODY)
                writer.write(_json_response(
                    await self.import_(req.path[8:], body)))
            else:
                writer.write(response(404, "Not Found"))
        except BodyTooLarge:
            writer.write(response(413, "Payload Too Large"))
        except ValueError as e:  # bad workspace key etc.
            writer.write(response(400, "Bad Request", str(e).encode()))
        except Exception as e:  # report, don't kill the agent
            log.exception("agent %s: %s %s failed", self.host_id,
                          req.method, req.path)
            writer.write(response(500, "Internal Server Error",
                                  str(e).encode()))
        try:
            await writer.drain()
        except ConnectionError:
            pass

    async def serve(self, port: int = 0):
        server = await asyncio.start_server(
            self.handle, self.bind, port,
            ssl=self.tls.server_ctx() if self.tls else None)
        self.url = "%s://%s:%d" % ("https" if self.tls else "http", self.bind,
                                   server.sockets[0].getsockname()[1])
        if self.respawn_interval:
            self._watchdog_task = asyncio.ensure_future(self._watchdog())
        return server

    async def _watchdog(self):
        """Respawn-on-crash policy: any assigned workspace whose worker
        died comes back up without waiting for a route request."""
        while True:
            await asyncio.sleep(self.respawn_interval)
            for key, ent in list(self.procs.items()):
                if ent["proc"].poll() is None:
                    continue
                log.warning("agent %s: worker %s died (rc=%s), respawning",
                            self.host_id, key, ent["proc"].returncode)
                try:
                    await self.spawn(key)
                except Exception:
                    log.exception("agent %s: respawn of %s failed",
                                  self.host_id, key)

    async def shutdown(self):
        if self._watchdog_task:
            self._watchdog_task.cancel()
            self._watchdog_task = None
        for key in list(self.procs):
            await self.stop(key)


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------


class FleetController:
    def __init__(self, bind: str = "127.0.0.1", token: Optional[str] = None,
                 tls: Optional[FleetTls] = None):
        self.bind = bind
        self.token = token
        self.tls = tls
        self._client_ssl = tls.client_ctx() if tls else None
        self.agents: Dict[str, dict] = {}  # host_id -> {url, last_seen}
        self.assignments: Dict[str, str] = {}  # workspace key -> host_id
        self._place_lock = asyncio.Lock()  # serialize placement decisions

    # -- registry --------------------------------------------------------------

    def register(self, host_id: str, url: str):
        self.agents[host_id] = {"url": url, "last_seen": time.monotonic()}

    def heartbeat(self, host_id: str):
        if host_id in self.agents:
            self.agents[host_id]["last_seen"] = time.monotonic()

    def live_agents(self) -> Dict[str, dict]:
        now = time.monotonic()
        return {h: a for h, a in self.agents.items()
                if now - a["last_seen"] < HEARTBEAT_TTL}

    async def _agent_health(self, host_id: str) -> Optional[dict]:
        agent = self.agents.get(host_id)
        if not agent:
            return None
        try:
            status, body = await http_call(agent["url"] + "/health",
                                           timeout=5.0, token=self.token,
                                           ssl_ctx=self._client_ssl)
            return json.loads(body) if status == 200 else None
        except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError):
            return None

    # -- placement / routing -----------------------------------------------------

    async def place(self, key: str) -> dict:
        """Assign a workspace to the least-loaded live agent and spawn it.

        The whole decide-and-spawn is under a lock: two concurrent placements
        of the same key would otherwise both pass the assignment check during
        the awaited health/spawn calls and leak a duplicate worker on the
        losing host."""
        if key in self.assignments:
            return await self.route(key)
        async with self._place_lock:
            if key in self.assignments:  # lost the race: already placed
                return await self.route(key)
            live = self.live_agents()
            if not live:
                raise RuntimeError("no live agents")
            loads = {}
            for host_id in live:
                h = await self._agent_health(host_id)
                # connected sessions first (the actual serving load), then
                # workspace count as the tiebreak
                loads[host_id] = (
                    (h.get("sessions", 0), h["load"]) if h
                    else (1 << 30, 1 << 30)
                )
            host_id = min(sorted(loads), key=lambda h: loads[h])
            result = await self._spawn_on(host_id, key)
            self.assignments[key] = host_id
        return {"host": host_id, **result}

    async def _spawn_on(self, host_id: str, key: str) -> dict:
        # worker boot includes the first block on its device (kernels built
        # on a fresh host) — the call must outlive the agent's spawn_timeout
        status, body = await http_call(
            self.agents[host_id]["url"] + f"/spawn/{key}", "POST",
            timeout=330.0, token=self.token, ssl_ctx=self._client_ssl)
        if status != 200:
            raise RuntimeError(f"spawn on {host_id} failed: {body!r}")
        return json.loads(body)

    async def route(self, key: str) -> dict:
        """Resolve a workspace to its worker URL; respawn a dead worker on
        its assigned host (failure recovery)."""
        host_id = self.assignments.get(key)
        if host_id is None:
            raise KeyError(key)
        health = await self._agent_health(host_id)
        if health is None:
            raise RuntimeError(f"agent {host_id} unreachable")
        info = health["workspaces"].get(key)
        if info and info["alive"]:
            return {"host": host_id, "url": info["url"]}
        # worker died (or agent restarted): respawn in place
        result = await self._spawn_on(host_id, key)
        return {"host": host_id, "url": result["url"], "respawned": True}

    async def migrate(self, key: str, to_host: str) -> dict:
        """Live-migrate: export (checkpoint + project file) from the source
        agent, import on the target, flip routing."""
        src = self.assignments.get(key)
        if src is None:
            raise KeyError(key)
        if to_host not in self.agents:
            raise KeyError(to_host)
        if to_host == src:
            return await self.route(key)
        status, blob = await http_call(
            self.agents[src]["url"] + f"/export/{key}", timeout=330.0,
            token=self.token, ssl_ctx=self._client_ssl)
        if status != 200:
            raise RuntimeError(f"export from {src} failed")
        status, body = await http_call(
            self.agents[to_host]["url"] + f"/import/{key}", "POST", blob,
            timeout=330.0, token=self.token, ssl_ctx=self._client_ssl)
        if status != 200:
            raise RuntimeError(f"import on {to_host} failed: {body!r}")
        self.assignments[key] = to_host
        return {"host": to_host, **json.loads(body)}

    def fleet_status(self) -> dict:
        now = time.monotonic()
        return {
            "agents": {
                h: {"url": a["url"],
                    "live": now - a["last_seen"] < HEARTBEAT_TTL}
                for h, a in self.agents.items()
            },
            "assignments": dict(self.assignments),
        }

    # -- HTTP service --------------------------------------------------------

    async def handle(self, reader, writer):
        try:
            await self._handle(reader, writer)
        finally:
            writer.close()  # else the server's wait_closed() waits on it

    async def _handle(self, reader, writer):
        try:
            req = await read_request(reader)
        except HttpError:
            writer.write(response(400, "Bad Request"))
            return
        if req is None:
            return
        if not check_token(req, self.token):
            writer.write(response(401, "Unauthorized", b"bad token"))
            try:
                await writer.drain()
            except ConnectionError:
                pass
            return
        try:
            if req.path == "/register" and req.method == "POST":
                body = json.loads(await _read_body(req, reader))
                self.register(body["host_id"], body["url"])
                writer.write(_json_response({"ok": True}))
            elif req.path == "/heartbeat" and req.method == "POST":
                body = json.loads(await _read_body(req, reader))
                self.heartbeat(body["host_id"])
                writer.write(_json_response({"ok": True}))
            elif req.path == "/fleet" and req.method == "GET":
                writer.write(_json_response(self.fleet_status()))
            elif req.path.startswith("/workspaces/") and req.method == "POST":
                writer.write(_json_response(await self.place(req.path[12:])))
            elif req.path.startswith("/route/") and req.method == "GET":
                writer.write(_json_response(await self.route(req.path[7:])))
            elif req.path.startswith("/migrate/") and req.method == "POST":
                body = json.loads(await _read_body(req, reader))
                writer.write(_json_response(
                    await self.migrate(req.path[9:], body["to"])))
            else:
                writer.write(response(404, "Not Found"))
        except BodyTooLarge:
            writer.write(response(413, "Payload Too Large"))
        except KeyError as e:
            writer.write(response(404, "Not Found", str(e).encode()))
        except Exception as e:
            log.exception("controller: %s %s failed", req.method, req.path)
            writer.write(response(500, "Internal Server Error",
                                  str(e).encode()))
        try:
            await writer.drain()
        except ConnectionError:
            pass

    async def serve(self, port: int = 0):
        server = await asyncio.start_server(
            self.handle, self.bind, port,
            ssl=self.tls.server_ctx() if self.tls else None)
        self.url = "%s://%s:%d" % ("https" if self.tls else "http", self.bind,
                                   server.sockets[0].getsockname()[1])
        return server


# ---------------------------------------------------------------------------


def _json_response(obj) -> bytes:
    return response(200, "OK", json.dumps(obj).encode(), "application/json")


class BodyTooLarge(Exception):
    pass


async def _read_body(req, reader, limit: int = MAX_JSON_BODY) -> bytes:
    length = int(req.header("content-length", "0"))
    if length > limit:
        raise BodyTooLarge(f"{length} > {limit}")
    return await reader.readexactly(length) if length else b""


def main(argv=None):
    """CLI: ``python -m mixlab_tpu_torch.server.fleet controller --listen ...``
    or ``... agent --controller URL --host-id H --data DIR [--listen ...]
    [--device cuda|cuda:N|cpu]``."""
    import argparse

    parser = argparse.ArgumentParser(prog="mixlab_tpu_torch.server.fleet")
    sub = parser.add_subparsers(dest="role", required=True)
    c = sub.add_parser("controller")
    c.add_argument("--listen", default="127.0.0.1:8100")
    c.add_argument("--token", default=os.environ.get("MIXLAB_FLEET_TOKEN"))
    a = sub.add_parser("agent")
    a.add_argument("--controller", required=True)
    a.add_argument("--host-id", required=True)
    a.add_argument("--data", required=True)
    a.add_argument("--listen", default="127.0.0.1:0")
    a.add_argument("--device", default="cuda",
                   help="the workers' engine device: cuda (the default), cuda:N or cpu")
    a.add_argument("--token", default=os.environ.get("MIXLAB_FLEET_TOKEN"))
    for sp in (c, a):
        sp.add_argument("--tls-cert", default=os.environ.get("MIXLAB_FLEET_TLS_CERT"))
        sp.add_argument("--tls-key", default=os.environ.get("MIXLAB_FLEET_TLS_KEY"))
        sp.add_argument("--tls-ca", default=os.environ.get("MIXLAB_FLEET_TLS_CA"))
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    tls = (FleetTls(args.tls_cert, args.tls_key, args.tls_ca)
           if args.tls_cert and args.tls_key else None)

    async def run_controller():
        host, _, port = args.listen.rpartition(":")
        ctl = FleetController(bind=host or "127.0.0.1", token=args.token,
                              tls=tls)
        server = await ctl.serve(int(port))
        log.info("fleet controller on %s", ctl.url)
        async with server:
            await server.serve_forever()

    async def run_agent():
        host, _, port = args.listen.rpartition(":")
        agent = HostAgent(args.host_id, Path(args.data),
                          bind=host or "127.0.0.1", respawn_interval=5.0,
                          token=args.token, tls=tls, device=args.device)
        server = await agent.serve(int(port))
        log.info("host agent %s on %s", args.host_id, agent.url)
        await http_call(args.controller + "/register", "POST",
                        json.dumps({"host_id": args.host_id,
                                    "url": agent.url}).encode(),
                        token=args.token,
                        ssl_ctx=agent._client_ssl)
        try:
            async with server:
                while True:
                    await asyncio.sleep(HEARTBEAT_TTL / 3)
                    try:
                        await http_call(args.controller + "/heartbeat", "POST",
                                        json.dumps({"host_id": args.host_id}).encode(),
                                        token=args.token,
                                        ssl_ctx=agent._client_ssl)
                    except (OSError, asyncio.TimeoutError):
                        log.warning("controller unreachable")
        finally:
            # a worker never outlives its agent
            await agent.shutdown()

    async def run():
        # SIGTERM / SIGINT end the role's task, so the agent stops its
        # workers before the process exits
        task = asyncio.current_task()
        for sig in (signal.SIGTERM, signal.SIGINT):
            asyncio.get_running_loop().add_signal_handler(sig, task.cancel)
        try:
            await (run_controller() if args.role == "controller" else run_agent())
        except asyncio.CancelledError:
            log.info("%s stopped", args.role)

    asyncio.run(run())


if __name__ == "__main__":
    main()
