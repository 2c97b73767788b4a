"""The port's fleet controller and host agents (``mixlab_tpu_torch/server/
fleet.py``) with real CPU worker processes (``python -m mixlab_tpu_torch
--device cpu``) over real sockets: the cases of
``tests/test_fleet_controller.py`` through the port, and a workspace
migrated across packages: running in a JAX worker under the JAX package's
agent, exported, imported into a port agent's worker, which resumes at the
JAX worker's tick from its DSP state."""

import asyncio
import json

import numpy as np
import pytest

from mixlab_tpu_torch import protocol as p
from mixlab_tpu_torch.protocol import wire
from mixlab_tpu_torch.server.fleet import (
    FleetController,
    FleetTls,
    HostAgent,
    check_token,
    decode_checkpoint,
    encode_checkpoint,
    http_call,
)
from test_fleet_controller import _make_cert
from test_server import mask_frame, ws_connect, ws_recv

STATE_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_torch_flagship.py


def cpu_agent(host_id, data_dir, **kw):
    return HostAgent(host_id, data_dir, device="cpu", **kw)


async def _edit(url: str, msgs) -> None:
    """Send client ops over the worker's session socket, each awaited to
    its Sync echo (so the edit is persisted)."""
    port = int(url.rsplit(":", 1)[1])
    reader, writer = await ws_connect("127.0.0.1", port, "/session")
    try:
        await asyncio.wait_for(ws_recv(reader), 60)  # WorkspaceState
        await asyncio.wait_for(ws_recv(reader), 60)  # MediaLibrary
        for seq, op in enumerate(msgs, 1):
            env = json.dumps({"v": 1, "kind": "Workspace",
                              "m": wire.encode(p.WorkspaceMessage(seq, op))})
            writer.write(mask_frame(1, env.encode()))
            await writer.drain()
            for _ in range(8):
                _, payload = await asyncio.wait_for(ws_recv(reader), 60)
                if wire.parse_envelope(payload)[0] == "Sync":
                    break
    finally:
        writer.close()


def _oscillator():
    return p.CreateModule(p.ModuleParams("Oscillator", p.OscillatorParams(440.0, p.Waveform.SINE)),
                          p.WindowGeometry())


def test_checkpoint_blob_roundtrip():
    ckpt = {"tick": 1234,
            "dsp_state": [np.arange(8, dtype=np.float32), np.ones((2, 3), dtype=np.int32)]}
    back = decode_checkpoint(encode_checkpoint(ckpt))
    assert back["tick"] == 1234
    assert len(back["dsp_state"]) == 2
    for g, w in zip(back["dsp_state"], ckpt["dsp_state"]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_fleet_spawn_route_migrate_recover(tmp_path):
    async def go():
        ctl = FleetController()
        servers = [await ctl.serve()]
        agents = []
        for host_id in ("host-a", "host-b"):
            agent = cpu_agent(host_id, tmp_path / host_id)
            servers.append(await agent.serve())
            agents.append(agent)
            await http_call(ctl.url + "/register", "POST", json.dumps(
                {"host_id": host_id, "url": agent.url}).encode())

        async def beat():
            while True:
                for a in agents:
                    await http_call(ctl.url + "/heartbeat", "POST",
                                    json.dumps({"host_id": a.host_id}).encode())
                await asyncio.sleep(1.0)

        hb = asyncio.ensure_future(beat())
        try:
            # placement balances load across live agents
            status, body = await http_call(ctl.url + "/workspaces/alpha", "POST", timeout=90.0)
            assert status == 200, body
            alpha = json.loads(body)
            status, body = await http_call(ctl.url + "/workspaces/beta", "POST", timeout=90.0)
            assert status == 200, body
            beta = json.loads(body)
            assert {alpha["host"], beta["host"]} == {"host-a", "host-b"}
            fleet = json.loads((await http_call(ctl.url + "/fleet"))[1])
            assert fleet["assignments"] == {"alpha": alpha["host"], "beta": beta["host"]}
            assert all(a["live"] for a in fleet["agents"].values())

            # routing resolves to a serving worker
            status, body = await http_call(ctl.url + "/route/alpha")
            assert status == 200
            route = json.loads(body)
            status, page = await http_call(route["url"] + "/")
            assert status == 200 and b"mixlab" in page
            assert (await http_call(ctl.url + "/route/nope"))[0] == 404

            # a session on alpha creates an oscillator; the engine ticks on
            await _edit(route["url"], [_oscillator()])
            await asyncio.sleep(2.0)
            status, ckpt_blob = await http_call(route["url"] + "/_checkpoint")
            assert status == 200
            ckpt = decode_checkpoint(ckpt_blob)
            assert ckpt["tick"] > 0

            # live migration to the other host: the target resumes from
            # the checkpoint's tick, not from zero
            other = "host-b" if alpha["host"] == "host-a" else "host-a"
            status, body = await http_call(ctl.url + "/migrate/alpha", "POST",
                                           json.dumps({"to": other}).encode(), timeout=90.0)
            assert status == 200, body
            moved = json.loads(body)
            assert moved["host"] == other and moved.get("restored") is True
            status, ck2 = await http_call(moved["url"] + "/_checkpoint")
            assert status == 200 and decode_checkpoint(ck2)["tick"] >= ckpt["tick"]
            route2 = json.loads((await http_call(ctl.url + "/route/alpha"))[1])
            assert route2["host"] == other and route2["url"] != route["url"]

            # the migrated worker carries the workspace
            reader, writer = await ws_connect(
                "127.0.0.1", int(route2["url"].rsplit(":", 1)[1]), "/session")
            _, payload = await asyncio.wait_for(ws_recv(reader), 60)
            kind, state = wire.parse_envelope(payload)
            writer.close()
            assert kind == "WorkspaceState"
            assert "Oscillator" in [params["kind"] for _, params in state["modules"]]

            # failure recovery: kill beta's worker, route respawns it
            beta_agent = next(a for a in agents if a.host_id == beta["host"])
            beta_proc = beta_agent.procs["beta"]["proc"]
            beta_proc.kill()
            beta_proc.wait(10)
            status, body = await http_call(ctl.url + "/route/beta", timeout=90.0)
            assert status == 200
            recovered = json.loads(body)
            assert recovered.get("respawned")
            assert (await http_call(recovered["url"] + "/"))[0] == 200
        finally:
            hb.cancel()
            for agent in agents:
                await agent.shutdown()
            for server in servers:
                server.close()
        assert all(a.procs == {} for a in agents)

    asyncio.run(asyncio.wait_for(go(), 240))


def test_agent_watchdog_respawns_crashed_worker(tmp_path):
    async def go():
        agent = cpu_agent("wd", tmp_path / "wd", respawn_interval=0.3)
        server = await agent.serve()
        try:
            await agent.spawn("w")
            proc = agent.procs["w"]["proc"]
            proc.kill()
            proc.wait(10)
            deadline = asyncio.get_running_loop().time() + 90
            while asyncio.get_running_loop().time() < deadline:
                info = agent.health()["workspaces"].get("w")
                if info and info["alive"] and agent.procs["w"]["proc"] is not proc:
                    break
                await asyncio.sleep(0.25)
            else:
                raise AssertionError("watchdog never respawned the worker")
            assert (await http_call(agent.procs["w"]["url"] + "/"))[0] == 200
        finally:
            await agent.shutdown()
            server.close()

    asyncio.run(asyncio.wait_for(go(), 180))


def test_agent_rejects_path_traversal_keys(tmp_path):
    async def go():
        agent = cpu_agent("sec", tmp_path / "sec")
        server = await agent.serve()
        for bad in ("../../etc/pwn", "a/b", "", ".hidden", "x" * 200):
            try:
                status, _ = await http_call(agent.url + f"/spawn/{bad}", "POST", timeout=10.0)
            except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError):
                continue  # unroutable path forms are fine too
            assert status in (400, 404), (bad, status)
        assert agent.procs == {}
        assert sorted(x.name for x in (tmp_path / "sec").iterdir()) == []
        await agent.shutdown()
        server.close()

    asyncio.run(asyncio.wait_for(go(), 60))


def test_fleet_auth_rejects_unauthenticated(tmp_path):
    class Req:
        def __init__(self, auth):
            self.auth = auth

        def header(self, name, default=""):
            return self.auth if name == "authorization" and self.auth else default

    assert check_token(Req(None), None) and check_token(Req("Bearer s"), "s")
    assert not check_token(Req("Bearer t"), "s") and not check_token(Req(None), "s")

    async def go():
        ctl = FleetController(token="s3cret")
        ctl_server = await ctl.serve()
        agent = cpu_agent("host-x", tmp_path / "x", token="s3cret")
        agent_server = await agent.serve()
        try:
            for url, method, body in [
                (ctl.url + "/fleet", "GET", b""),
                (ctl.url + "/register", "POST", b"{}"),
                (ctl.url + "/workspaces/w1", "POST", b""),
                (agent.url + "/health", "GET", b""),
                (agent.url + "/spawn/w1", "POST", b""),
                (agent.url + "/export/w1", "GET", b""),
            ]:
                status, _ = await http_call(url, method, body)
                assert status == 401, url
            assert (await http_call(agent.url + "/health", token="wrong"))[0] == 401
            status, body = await http_call(agent.url + "/health", token="s3cret")
            assert status == 200 and json.loads(body)["host_id"] == "host-x"
            status, _ = await http_call(ctl.url + "/register", "POST", json.dumps(
                {"host_id": "host-x", "url": agent.url}).encode(), token="s3cret")
            assert status == 200
        finally:
            ctl_server.close()
            agent_server.close()
            await agent.shutdown()

    asyncio.run(asyncio.wait_for(go(), 60))


def test_fleet_body_caps(tmp_path):
    async def go():
        ctl = FleetController()
        ctl_server = await ctl.serve()
        try:
            big = b"x" * (2 << 20)  # 2 MiB > MAX_JSON_BODY
            assert (await http_call(ctl.url + "/register", "POST", big))[0] == 413
            assert (await http_call(ctl.url + "/heartbeat", "POST", big))[0] == 413
        finally:
            ctl_server.close()

    asyncio.run(asyncio.wait_for(go(), 60))


def test_concurrent_place_single_assignment():
    async def go():
        ctl = FleetController()
        spawns = []

        async def fake_health(host_id):
            await asyncio.sleep(0.05)  # widen the race window
            return {"load": 0, "workspaces": {
                k: {"url": "http://x", "alive": True} for k in ctl.assignments}}

        async def fake_spawn(host_id, key):
            await asyncio.sleep(0.05)
            spawns.append((host_id, key))
            return {"url": "http://x"}

        ctl._agent_health = fake_health
        ctl._spawn_on = fake_spawn
        ctl.register("host-a", "http://a")
        r1, r2 = await asyncio.gather(ctl.place("w1"), ctl.place("w1"))
        assert spawns == [("host-a", "w1")]
        assert ctl.assignments == {"w1": "host-a"}
        assert r1["host"] == r2["host"] == "host-a"

    asyncio.run(go())


def test_place_prefers_fewer_sessions_over_workspace_count():
    async def go():
        ctl = FleetController()
        health = {"host-a": {"load": 1, "sessions": 7, "workspaces": {}},
                  "host-b": {"load": 3, "sessions": 0, "workspaces": {}}}
        spawns = []

        async def fake_health(host_id):
            return health[host_id]

        async def fake_spawn(host_id, key):
            spawns.append(host_id)
            return {"url": "http://x"}

        ctl._agent_health = fake_health
        ctl._spawn_on = fake_spawn
        ctl.register("host-a", "http://a")
        ctl.register("host-b", "http://b")
        await ctl.place("w1")
        assert spawns == ["host-b"]
        health["host-a"] = {"load": 0, "workspaces": {}}  # no session count: 0
        await ctl.place("w2")
        assert spawns == ["host-b", "host-a"]

    asyncio.run(go())


def test_agent_health_full_scrapes_worker_sessions(tmp_path):
    async def go():
        agent = cpu_agent("h", tmp_path)

        async def serve_metrics(reader, writer):
            await reader.readuntil(b"\r\n\r\n")
            body = b"mixlab_engine_tick 5\nmixlab_sessions_connected 3\n"
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n\r\n%s" % (len(body), body))
            await writer.drain()
            writer.close()

        srv = await asyncio.start_server(serve_metrics, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]

        class FakeProc:
            def poll(self):
                return None

        agent.procs["w1"] = {"proc": FakeProc(), "port": port,
                             "url": f"http://127.0.0.1:{port}"}
        agent.procs["w2"] = {"proc": FakeProc(), "port": 1, "url": "http://127.0.0.1:1"}
        h = await agent.health_full()
        assert h["sessions"] == 3
        assert h["workspaces"]["w1"]["sessions"] == 3
        assert h["workspaces"]["w2"]["sessions"] == 0
        srv.close()
        await srv.wait_closed()

    asyncio.run(asyncio.wait_for(go(), 60))


def test_fleet_tls_pinned_control_plane(tmp_path):
    import ssl

    cert, key = _make_cert(tmp_path, "fleet")
    other_cert, other_key = _make_cert(tmp_path, "other")
    tls = FleetTls(cert, key)

    async def go():
        ctl = FleetController(token="s3cret", tls=tls)
        ctl_server = await ctl.serve()
        agent = cpu_agent("host-t", tmp_path / "t", token="s3cret", tls=tls)
        agent_server = await agent.serve()
        assert ctl.url.startswith("https://") and agent.url.startswith("https://")
        ctx = tls.client_ctx()
        try:
            with pytest.raises((ssl.SSLError, ConnectionError, asyncio.IncompleteReadError,
                                asyncio.TimeoutError)):
                await http_call("http" + ctl.url[len("https"):] + "/fleet", token="s3cret",
                                timeout=3.0)
            wrong = FleetTls(other_cert, other_key).client_ctx()
            with pytest.raises(ssl.SSLError):
                await http_call(ctl.url + "/fleet", token="s3cret", ssl_ctx=wrong, timeout=3.0)
            anon = ssl.create_default_context(cafile=cert)
            anon.check_hostname = False
            with pytest.raises((ssl.SSLError, ConnectionError, asyncio.IncompleteReadError,
                                asyncio.TimeoutError)):
                await http_call(ctl.url + "/fleet", token="s3cret", ssl_ctx=anon, timeout=3.0)
            status, _ = await http_call(ctl.url + "/register", "POST", json.dumps(
                {"host_id": "host-t", "url": agent.url}).encode(), token="s3cret", ssl_ctx=ctx)
            assert status == 200
            assert (await http_call(ctl.url + "/fleet", ssl_ctx=ctx))[0] == 401
            status, body = await http_call(ctl.url + "/workspaces/wtls", "POST",
                                           token="s3cret", ssl_ctx=ctx, timeout=120.0)
            assert status == 200
            placed = json.loads(body)
            assert placed["host"] == "host-t" and placed["url"].startswith("http://")
            assert (await http_call(placed["url"] + "/_metrics", timeout=10.0))[0] == 200
        finally:
            ctl_server.close()
            agent_server.close()
            await agent.shutdown()

    asyncio.run(asyncio.wait_for(go(), 180))


def test_workspace_migrates_from_a_jax_worker_to_a_port_worker(tmp_path):
    """A JAX worker under the JAX package's agent runs an oscillator into an
    EqThree (whose filter poles are DSP state); its export blob imports into
    a port agent's CPU worker, which adopts the checkpoint.  The port
    worker's own checkpoint a moment later equals the JAX checkpoint
    continued on the CPU by a port engine from the same tick, to the tick."""
    from mixlab_tpu.server.fleet import HostAgent as JaxHostAgent
    from mixlab_tpu_torch.engine.engine import Engine
    from mixlab_tpu_torch.engine.graph import Workspace
    from mixlab_tpu_torch.engine.project import ProjectBase

    async def go():
        jax_agent = JaxHostAgent("host-j", tmp_path / "j")
        port_agent = cpu_agent("host-t", tmp_path / "t")
        servers = [await jax_agent.serve(), await port_agent.serve()]
        try:
            worker = await jax_agent.spawn("mig")
            await _edit(worker["url"], [
                _oscillator(),
                p.CreateModule(p.ModuleParams("EqThree", p.EqThreeParams(
                    p.Decibel(4.0), p.Decibel(-2.0), p.Decibel(3.0))), p.WindowGeometry()),
                p.CreateConnection(p.InputId(p.ModuleId(2), 0), p.OutputId(p.ModuleId(1), 0))])
            # the JAX engine compiles the edited program off its thread and
            # adopts it when ready: wait for the EqThree's state
            deadline = asyncio.get_running_loop().time() + 90
            while not decode_checkpoint((await http_call(
                    worker["url"] + "/_checkpoint", timeout=30.0))[1])["dsp_state"]:
                assert asyncio.get_running_loop().time() < deadline, "never adopted"
                await asyncio.sleep(0.5)
            status, blob = await http_call(jax_agent.url + "/export/mig", timeout=60.0)
            assert status == 200 and "mig" not in jax_agent.procs
            header, _, rest = blob.partition(b"\n")
            ckpt = decode_checkpoint(rest[:json.loads(header)["ckpt_len"]])
            assert ckpt["tick"] > 0 and ckpt["dsp_state"]
            status, body = await http_call(port_agent.url + "/import/mig", "POST", blob,
                                           timeout=90.0)
            assert status == 200, body
            moved = json.loads(body)
            assert moved["restored"] is True
            status, ck2 = await http_call(moved["url"] + "/_checkpoint", timeout=30.0)
            assert status == 200
            return ckpt, decode_checkpoint(ck2)
        finally:
            await jax_agent.shutdown()
            await port_agent.shutdown()
            for s in servers:
                s.close()

    ckpt, now = asyncio.run(asyncio.wait_for(go(), 240))
    assert now["tick"] >= ckpt["tick"]
    with ProjectBase(tmp_path / "t" / "mig.mixlab") as base:
        ws = Workspace.from_persist(base.read_workspace())
    assert sorted(e.params.kind for e in ws.modules.values()) == ["EqThree", "Oscillator"]
    ref = Engine(workspace=ws, device="cpu")
    assert ref.restore_dsp_state(ckpt) and ref.tick == ckpt["tick"]
    while ref.tick < now["tick"]:
        ref.tick_once()
    got = ref.checkpoint()["dsp_state"]
    assert len(got) == len(now["dsp_state"])
    for g, w in zip(got, now["dsp_state"]):
        np.testing.assert_allclose(g, w, **STATE_TOL)
    assert any(np.abs(w).max() > 0 for w in now["dsp_state"])


def test_cli_runs_controller_and_agent(tmp_path):
    """``python -m mixlab_tpu_torch.server.fleet controller`` and ``agent
    --device cpu``: the agent registers, a workspace is placed on it and
    served; SIGTERM ends the agent with exit 0 and its worker with it, then
    the controller."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctl_url = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "mixlab_tpu_torch.server.fleet"]
    env = {k: v for k, v in os.environ.items() if k != "MIXLAB_FLEET_TOKEN"}
    # each role in a process group of its own: a role killed at the end
    # takes any worker it left with it
    procs = [subprocess.Popen(cmd + ["controller", "--listen", f"127.0.0.1:{port}"], cwd=root,
                              env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                              start_new_session=True)]

    async def go():
        deadline = asyncio.get_running_loop().time() + 60
        while True:  # the controller listens, then the agent registers
            try:
                status, body = await http_call(ctl_url + "/fleet", timeout=5.0)
                if len(procs) == 1:
                    procs.append(subprocess.Popen(
                        cmd + ["agent", "--controller", ctl_url, "--host-id", "cli",
                               "--data", str(tmp_path / "cli"), "--device", "cpu"],
                        cwd=root, env=env, stdout=subprocess.DEVNULL,
                        stderr=subprocess.PIPE, start_new_session=True))
                elif json.loads(body)["agents"].get("cli", {}).get("live"):
                    break
            except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError):
                pass
            assert asyncio.get_running_loop().time() < deadline, "no live agent"
            await asyncio.sleep(0.2)
        status, body = await http_call(ctl_url + "/workspaces/w", "POST", timeout=90.0)
        assert status == 200, body
        placed = json.loads(body)
        assert placed["host"] == "cli"
        assert (await http_call(placed["url"] + "/"))[0] == 200
        return placed["url"]

    try:
        worker = asyncio.run(asyncio.wait_for(go(), 120))
        for proc in reversed(procs):
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(30) == 0, proc.stderr.read().decode()[-2000:]

        async def gone():
            with pytest.raises((OSError, asyncio.TimeoutError, asyncio.IncompleteReadError)):
                await http_call(worker + "/", timeout=5.0)

        asyncio.run(gone())
    finally:
        for proc in procs:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait(10)
