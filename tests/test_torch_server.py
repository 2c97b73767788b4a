"""The port's served session against the JAX package's, on the CPU.

Both packages' ``run_server`` run in one event loop on ephemeral ports (the
port's engine with ``device="cpu"``) and get the same scripted session over
real localhost sockets.  Wire messages are compared decoded, ids aside (a
Monitor's socket id is a fresh uuid in each server); the static assets
byte for byte.  Each server is closed by the test module that started it.

The JAX side runs its pure codec tier with its numpy CAVLC encoder and its
numpy WebSocket unmask (``mixlab_tpu.native._load`` patched to ``None``):
these tests must not start a build of the JAX package's native library,
which its own tests build at first use (ROADMAP.md section 3).
"""

import asyncio
import json
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mixlab_tpu import protocol as jp
from mixlab_tpu.engine.config import EngineConfig as JaxEngineConfig
from mixlab_tpu.engine.project import ProjectBase as JaxProjectBase
from mixlab_tpu.engine.project import open_or_create as jax_open_or_create
from mixlab_tpu.protocol import wire as jwire
from mixlab_tpu.server.app import run_server as jax_run_server
from mixlab_tpu_torch import protocol as tp
from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.engine.project import open_or_create
from mixlab_tpu_torch.protocol import wire as twire
from mixlab_tpu_torch.server import ws as ws_mod
from mixlab_tpu_torch.server.app import run_server
from tests.loophelp import drain_and_close
from tests.test_server import mask_frame, ws_connect, ws_recv

ROOT = Path(__file__).resolve().parents[1]
STATIC = ("index.html", "app.js", "app.css", "session_core.js")
UUID = re.compile(r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$")


def session_ops(p):
    """The scripted session, in either package's protocol: an Oscillator and
    a Monitor, connected, edited and torn down again."""
    geo = p.WindowGeometry()
    osc, mon = p.ModuleId(1), p.ModuleId(2)
    return [
        p.CreateModule(p.ModuleParams("Oscillator", p.OscillatorParams(440.0, p.Waveform.SINE)),
                       geo),
        p.CreateModule(p.ModuleParams("Monitor", None), geo),
        p.CreateConnection(p.InputId(mon, 0), p.OutputId(osc, 0)),
        p.UpdateModuleParams(osc, p.ModuleParams("Oscillator",
                                                 p.OscillatorParams(220.0, p.Waveform.SQUARE))),
        p.UpdateWindowGeometry(osc, p.WindowGeometry(p.Coords(40, 30), 2)),
        p.CreateModule(p.ModuleParams("Amplifier", p.AmplifierParams(0.5, 0.0)), geo),
        p.CreateConnection(p.InputId(p.ModuleId(3), 0), p.OutputId(osc, 0)),
        p.DeleteConnection(p.InputId(mon, 0)),
        p.CreateConnection(p.InputId(mon, 0), p.OutputId(p.ModuleId(3), 0)),
        p.DeleteModule(p.ModuleId(3)),
    ]


def ids_aside(body):
    """``body`` with every uuid string (a Monitor's socket id) replaced."""
    if isinstance(body, dict):
        return {k: ids_aside(v) for k, v in body.items()}
    if isinstance(body, (list, tuple)):
        return [ids_aside(v) for v in body]
    if isinstance(body, str) and UUID.match(body):
        return "<socket id>"
    return body


async def recv_msg(reader, timeout=15.0):
    _, payload = await asyncio.wait_for(ws_recv(reader), timeout)
    return jwire.parse_envelope(payload)


async def send_op(writer, wire, seq, op, p):
    env = json.dumps({"v": 1, "kind": "Workspace",
                      "m": wire.encode(p.WorkspaceMessage(seq, op))})
    writer.write(mask_frame(ws_mod.OP_TEXT, env.encode()))
    await writer.drain()


async def http(port, request: bytes) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(request)
    await writer.drain()
    data = await asyncio.wait_for(reader.read(-1), 30)
    writer.close()
    return data


def split_response(data: bytes):
    head, _, body = data.partition(b"\r\n\r\n")
    return head.split(b"\r\n")[0], body


async def run_session(port, p, wire):
    """Connect, play ``session_ops``, and return the messages: the first
    session's state and library, the Updates and Syncs in order
    (Performance reports aside), and a second session's state."""
    reader, writer = await ws_connect("127.0.0.1", port, "/session")
    first = [await recv_msg(reader), await recv_msg(reader)]
    got = []
    for seq, op in enumerate(session_ops(p), 1):
        await send_op(writer, wire, seq, op, p)
        while True:
            kind, body = await recv_msg(reader)
            if kind == "Performance":
                continue
            if kind == "Update" and body["t"] == "SUUpdateModuleIndication":
                continue  # tick-driven (Plotter/OutputDevice), not op-driven
            got.append((kind, body))
            if kind == "Sync":
                assert body == seq, (kind, body)
                break
    writer.close()
    reader2, writer2 = await ws_connect("127.0.0.1", port, "/session")
    second = await recv_msg(reader2)
    writer2.close()
    return first, got, second


class Served:
    def __init__(self, project, tcp):
        self.project = project
        self.tcp = tcp
        self.port = tcp.sockets[0].getsockname()[1]

    def close(self):
        self.project.engine.stop()
        self.tcp.close()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Both servers on the CPU in one loop, after the scripted session;
    yields (loop, {"jax": Served, "torch": Served}, session messages)."""
    from mixlab_tpu_torch import native

    # the port's host C++ (the WebSocket unmask on the server's loop, the
    # frame encoder) built before the session's timed reads: in a fresh
    # checkout the first load builds it, under a lock other test files share
    native.available()
    tmp = tmp_path_factory.mktemp("served")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MIXLAB_CODEC_TIER", "pure")
        mp.setattr("mixlab_tpu.native._load", lambda: None)
        from mixlab_tpu.av import h264cavlc_fast

        mp.setattr(h264cavlc_fast, "make_cavlc_encoder", h264cavlc_fast.FastCavlcIntraEncoder)
        loop = asyncio.new_event_loop()

        async def setup():
            jproj = jax_open_or_create(tmp / "jax.mixlab", JaxEngineConfig(sample_rate=44_100))
            tproj = open_or_create(tmp / "torch.mixlab", EngineConfig(sample_rate=44_100),
                                   device="cpu")
            jtcp, _ = await jax_run_server(jproj, "127.0.0.1", 0)
            ttcp, _ = await run_server(tproj, "127.0.0.1", 0)
            return {"jax": Served(jproj, jtcp), "torch": Served(tproj, ttcp)}

        servers = loop.run_until_complete(setup())
        try:
            msgs = {name: loop.run_until_complete(run_session(
                s.port, jp if name == "jax" else tp, jwire if name == "jax" else twire))
                for name, s in servers.items()}
            yield loop, servers, msgs
        finally:
            for s in servers.values():
                s.close()
            drain_and_close(loop)
            for s in servers.values():
                s.project.close()


def test_session_messages_match_jax(both):
    _, _, msgs = both
    (j_first, j_got, j_second), (t_first, t_got, t_second) = msgs["jax"], msgs["torch"]
    assert [k for k, _ in t_first] == ["WorkspaceState", "MediaLibrary"]
    assert t_first == j_first
    assert ids_aside(t_got) == ids_aside(j_got)
    assert [k for k, _ in t_got].count("Sync") == len(session_ops(tp))
    assert t_second[0] == "WorkspaceState"
    assert ids_aside(t_second[1]) == ids_aside(j_second[1])


def test_monitor_indication_carries_the_socket_id(both):
    """The Monitor's CreateModule update carries its codec thread's socket
    id, which the server serves at /_monitor/<id>."""
    loop, servers, msgs = both
    _, got, _ = msgs["torch"]
    create = [b for k, b in got
              if k == "Update" and b["t"] == "SUCreateModule"
              and b["params"]["kind"] == "Monitor"]
    assert len(create) == 1
    socket_id = create[0]["indication"]["value"]["socket_id"]
    assert UUID.match(socket_id)
    eng = servers["torch"].project.engine
    pipeline = eng._monitor_pipelines[tp.ModuleId(2)]
    assert pipeline.socket_id == socket_id and pipeline.is_alive()

    async def subscribe():
        reader, writer = await ws_connect("127.0.0.1", servers["torch"].port,
                                          f"/_monitor/{socket_id}")
        _, init = await asyncio.wait_for(ws_recv(reader), 30)
        header, _, seg = init.partition(b"\n")
        assert json.loads(header)["mode"] == "fmp4" and seg[4:8] == b"ftyp"
        while True:  # a subscriber may see the init packet again, as in the JAX server
            _, pkt = await asyncio.wait_for(ws_recv(reader), 30)
            header, _, seg = pkt.partition(b"\n")
            if json.loads(header)["t"] != "init":
                break
        assert json.loads(header) == {"t": "segment"}
        assert seg[4:8] == b"moof" and b"mdat" in seg
        writer.close()
        data = await http(servers["torch"].port,
                          b"GET /_monitor/no-such-id HTTP/1.1\r\nHost: x\r\n\r\n")
        assert split_response(data)[0].endswith(b"404 Not Found")

    loop.run_until_complete(subscribe())


@pytest.mark.parametrize("name", STATIC)
def test_static_assets_are_byte_identical(both, name):
    loop, servers, _ = both
    assert (ROOT / "mixlab_tpu_torch/server/static" / name).read_bytes() == \
        (ROOT / "mixlab_tpu/server/static" / name).read_bytes()
    path = "/" if name == "index.html" else f"/static/{name}"
    req = f"GET {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n".encode()
    got = {k: loop.run_until_complete(http(s.port, req)) for k, s in servers.items()}
    assert split_response(got["torch"])[0] == b"HTTP/1.1 200 OK"
    assert got["torch"] == got["jax"]
    assert split_response(got["torch"])[1] == (ROOT / "mixlab_tpu/server/static" /
                                               name).read_bytes()


def test_metrics_carry_the_jax_metric_names(both):
    loop, servers, _ = both
    req = b"GET /_metrics HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"

    def names(data):
        status, body = split_response(data)
        assert status == b"HTTP/1.1 200 OK"
        return {line.split(" ")[0].split("{")[0] for line in body.decode().splitlines()
                if line and not line.startswith("#")}

    got = {k: names(loop.run_until_complete(http(s.port, req))) for k, s in servers.items()}
    assert got["torch"] == got["jax"]
    assert {"mixlab_engine_tick", "mixlab_monitor_pipelines",
            "mixlab_engine_realtime"} <= got["torch"]


def test_checkpoint_restores_across_engines(both):
    """A /_checkpoint of either server restores into the other (/_restore
    200); the JAX engine compiles its program asynchronously, so its first
    restores may answer 409 until the program of the final workspace is in."""
    loop, servers, _ = both

    async def go():
        blobs = {}
        for name, s in servers.items():
            status, body = split_response(await http(
                s.port, b"GET /_checkpoint HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"))
            assert status == b"HTTP/1.1 200 OK", (name, status)
            blobs[name] = body
        for src, dst in (("jax", "torch"), ("torch", "jax")):
            deadline = time.monotonic() + 30
            while True:
                blob = blobs[src]
                status, _ = split_response(await http(
                    servers[dst].port,
                    b"POST /_restore HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
                    + f"Content-Length: {len(blob)}\r\n\r\n".encode() + blob))
                if status == b"HTTP/1.1 200 OK" or time.monotonic() > deadline:
                    break
                await asyncio.sleep(0.5)
            assert status == b"HTTP/1.1 200 OK", (src, dst, status)

    loop.run_until_complete(go())


def test_upload_is_read_back_by_the_jax_project_base(both, tmp_path):
    loop, servers, _ = both
    data = bytes(range(256)) * 9000  # 2.2 MiB: three blobs of the 1 MiB chunking
    served = servers["torch"]

    async def go():
        status, _ = split_response(await http(
            served.port,
            b"POST /_upload/clip.bin HTTP/1.1\r\nHost: x\r\nContent-Type: video/mp4\r\n"
            + f"Content-Length: {len(data)}\r\n\r\n".encode() + data))
        assert status == b"HTTP/1.1 200 OK"

    loop.run_until_complete(go())
    assert served.project.notify_media.is_set()
    base = JaxProjectBase(served.project.base.path)
    try:
        (item,) = base.media_library().items
        assert (item.name, item.kind, item.size) == ("clip.bin", "video/mp4", len(data))
        stream = base.open_media(item.id)
        stream.seek(1 << 20)
        assert stream.read(10) == data[1 << 20:(1 << 20) + 10]
        stream.seek(0)
        assert stream.read() == data
    finally:
        base.close()


@pytest.mark.parametrize("first_bytes", [b"SOURCE /live ICE/1.0\r\n\r\n", b"\x03" + bytes(1536)],
                         ids=["icecast", "rtmp"])
def test_ingest_first_bytes_are_refused(both, first_bytes):
    """The first bytes of an Icecast SOURCE or an RTMP handshake, told apart
    by the sniffer, reach the port's listeners (until they were ported the
    connection was closed at once), which refuse a mountpoint nobody
    listens on: the SOURCE gets 403 Forbidden; the handshake is answered
    (S0, S1, S2) and a publisher is refused with NetStream.Publish.BadName."""
    from mixlab_tpu_torch.io_host.rtmp import client as rtmp_client

    loop, servers, _ = both
    port = servers["torch"].port

    async def go():
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(first_bytes)
        await writer.drain()
        if first_bytes.startswith(b"SOURCE"):
            data = await asyncio.wait_for(reader.read(-1), 10)  # closed by the server
        else:
            s012 = await asyncio.wait_for(reader.readexactly(1 + 2 * 1536), 10)
            writer.write(s012[1:1537])  # C2 echoes S1
            writer.write_eof()
            data = s012[:1] + await asyncio.wait_for(reader.read(-1), 10)
        writer.close()
        return data

    data = loop.run_until_complete(go())
    if first_bytes.startswith(b"SOURCE"):
        assert data.startswith(b"HTTP/1.1 403 Forbidden") and data.endswith(b"unavailable")
    else:
        assert data == b"\x03"
        with pytest.raises(Exception):
            loop.run_until_complete(rtmp_client.start("127.0.0.1", port, "nosuch", "key"))


def test_ingest_reaches_stream_inputs_through_run_server(tmp_path, monkeypatch):
    """Behind the port's ``run_server`` (what ``python -m mixlab_tpu_torch``
    runs), an RTMP publisher and an Icecast SOURCE reach their StreamInputs:
    the engine's feeds get the decoded pictures as tensors on the engine's
    device (the CPU here), equal to the port's decoder's, and the PCM."""
    from mixlab_tpu_torch.av.h264dec import PureH264Decoder
    from mixlab_tpu_torch.engine import engine as engine_mod
    from mixlab_tpu_torch.io_host.rtmp import client as rtmp_client
    from mixlab_tpu_torch.io_host.wav import write_wav
    from tests.test_torch_rtmp_icecast import _aac_tags, _x264_tags
    from tests import torch_h264_streams as streams

    from mixlab_tpu_torch import native

    assert native.available()  # built before the timed waits below
    monkeypatch.setenv("MIXLAB_CODEC_TIER", "pure")
    seen = {"video": [], "pcm": {}}

    class RecordingFeed(engine_mod.StreamInputFeed):
        def fill_tick(self, t, n):
            pcm, video = super().fill_tick(t, n)
            seen["pcm"].setdefault(id(self), []).append(pcm)
            if video is not None:
                seen["video"].append(video)
            return pcm, video

    monkeypatch.setattr(engine_mod, "StreamInputFeed", RecordingFeed)
    proj = open_or_create(tmp_path / "ingest.mixlab", EngineConfig(sample_rate=44_100),
                          device="cpu")
    loop = asyncio.new_event_loop()
    tcp = None
    try:
        tcp, _ = loop.run_until_complete(run_server(proj, "127.0.0.1", 0))
        port = tcp.sockets[0].getsockname()[1]
        eng = proj.engine
        sid, _, _ = eng.connect_session()
        for seq, (proto, mount) in enumerate(((tp.StreamProtocol.RTMP, "cam"),
                                              (tp.StreamProtocol.ICECAST, "radio")), 1):
            eng.update(sid, tp.WorkspaceMessage(seq, tp.CreateModule(tp.ModuleParams(
                "StreamInput", tp.StreamInputParams(mountpoint=mount, protocol=proto)),
                tp.WindowGeometry())))
        deadline = time.monotonic() + 10
        while len(eng._stream_feeds) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        vtags, dcr, units = _x264_tags(streams.load("cavlc_p"))
        atags, _, _ = _aac_tags(0.5)
        t = np.arange(4410) / 44_100
        tone = (np.sin(2 * np.pi * 500 * t) * 20000).astype(np.int16)
        write_wav(tmp_path / "in.wav", 44_100, np.stack([tone, tone], -1))

        async def publish():
            client = await rtmp_client.start("127.0.0.1", port, "cam", "key")
            for kind, ms, body in sorted(vtags + atags, key=lambda x: x[1]):
                (client.publish_audio if kind == "audio" else client.publish_video)(ms, body)
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"SOURCE /radio HTTP/1.0\r\nContent-Type: audio/wav\r\n\r\n"
                         + (tmp_path / "in.wav").read_bytes())
            await writer.drain()
            assert b"200 OK" in await reader.read(64)
            for _ in range(3000):
                pcm = [np.concatenate(v) for v in seen["pcm"].values()]
                if len(seen["video"]) >= 3 and len(pcm) == 2 and all(
                        np.abs(x).max() > 10_000 for x in pcm):
                    break
                await asyncio.sleep(0.01)
            writer.close()
            await client.close()

        loop.run_until_complete(publish())
    finally:
        proj.engine.stop()
        if tcp is not None:
            tcp.close()
        drain_and_close(loop)
        proj.close()
    dec = PureH264Decoder(dcr)
    want = [dec.decode(u) for u in units]
    want = [f[-1][1:] for f in want if f]
    assert len(seen["video"]) >= 3
    for frame in seen["video"][:3]:
        got = [frame.picture.planes[k] for k in "yuv"]
        assert all(isinstance(g, torch.Tensor) and g.device.type == "cpu" for g in got)
        assert any(all(np.array_equal(g.numpy(), w) for g, w in zip(got, ws)) for ws in want)
    assert len(seen["pcm"]) == 2
    assert all(np.abs(np.concatenate(v)).max() > 10_000 for v in seen["pcm"].values())


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_entry_point_serves_and_exits_on_sigterm(tmp_path):
    """``python -m mixlab_tpu_torch --device cpu`` serves the port's index,
    takes one op, exits 0 on SIGTERM and leaves a workspace that the JAX
    package's ``open_or_create`` reads (tests/test_server.py:403)."""
    ws_path = tmp_path / "term.mixlab"
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mixlab_tpu_torch", "--device", "cpu", "--listen",
         f"127.0.0.1:{port}", str(ws_path)],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 60
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.time() < deadline, "no listener after 60 s"
                time.sleep(0.1)

        async def drive():
            data = await http(port, b"GET / HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
            status, body = split_response(data)
            assert status == b"HTTP/1.1 200 OK"
            assert body == (ROOT / "mixlab_tpu_torch/server/static/index.html").read_bytes()
            reader, writer = await ws_connect("127.0.0.1", port, "/session")
            await recv_msg(reader)
            await recv_msg(reader)
            await send_op(writer, twire, 1, session_ops(tp)[0], tp)
            while (await recv_msg(reader))[0] != "Sync":
                pass
            writer.close()

        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(drive())
        finally:
            drain_and_close(loop)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(30)
        assert rc == 0, proc.stderr.read().decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    proj = jax_open_or_create(ws_path, JaxEngineConfig(sample_rate=44_100))
    try:
        kinds = [e.params.kind for e in proj.engine.ws.modules.values()]
        assert kinds == ["Oscillator"]
    finally:
        proj.engine.stop()
        proj.close()


def test_entry_point_defaults_to_cuda(tmp_path):
    """Without ``--device`` the server asks for the card, and without one it
    raises before it opens or creates the project."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mixlab_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--listen", "127.0.0.1:0", str(tmp_path / "p.mixlab")])
    assert not (tmp_path / "p.mixlab").exists()
