"""Fleet serving in the port (``mixlab_tpu_torch/server/fleet_serve.py``) on
the CPU: the five cases of ``tests/test_fleet_serve.py`` against the port's
``FleetEngine`` (join and edit isolation with every slot exactly equal to a
dedicated render, leave and reset, a full fleet, structural ops rejected
with rollback, the WebSocket route end to end with several clients), and one
scripted session sent to both packages' ``FleetServeApp`` in one event loop:
the text frames and the PCM frames' headers byte-equal, the i16 PCM within
1 LSB."""

import asyncio
import json
import queue
import time

import numpy as np
import pytest
import torch

from mixlab_tpu import protocol as jp
from mixlab_tpu.engine.config import EngineConfig as JaxEngineConfig
from mixlab_tpu.server.fleet_serve import FleetEngine as JaxFleetEngine
from mixlab_tpu.server.fleet_serve import FleetServeApp as JaxFleetServeApp
from mixlab_tpu_torch import protocol as p
from mixlab_tpu_torch.engine.compiler import compile_patch
from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.engine.graph import Workspace
from mixlab_tpu_torch.protocol import InputId, OutputId
from mixlab_tpu_torch.server.fleet_serve import FleetEngine, FleetServeApp
from tests.test_fleet_serve import small_template as jax_small_template
from tests.test_server import mask_frame, ws_connect, ws_recv

CPU = torch.device("cpu")
CFG = EngineConfig(sample_rate=48_000)
BLOCK_TICKS = 3


def small_template():
    """osc -> amp -> monitor (tests/test_fleet_serve.py's template)."""
    ws = Workspace()
    o = ws.create_module(p.ModuleParams("Oscillator", p.OscillatorParams(440.0, p.Waveform.SINE)))
    a = ws.create_module(p.ModuleParams("Amplifier", p.AmplifierParams(amplitude=0.5)))
    m = ws.create_module(p.ModuleParams("Monitor", None))
    ws.connect(InputId(a, 0), OutputId(o, 1))
    ws.connect(InputId(m, 1), OutputId(a, 0))
    return ws, o, a, m


class FakeSub:
    """Collects monitor packets synchronously (direct drive)."""

    def __init__(self):
        self.packets = []

    def push_threadsafe(self, pkt):
        self.packets.append(pkt)


def make_engine(capacity=4):
    ws, o, a, m = small_template()
    return FleetEngine(ws, capacity, CFG, block_ticks=BLOCK_TICKS, device="cpu"), (ws, o, a, m)


def join(eng):
    done = queue.Queue(maxsize=1)
    eng._process_cmd(("join", done))
    return done.get_nowait()


def edit_freq(eng, slot, osc_mid, freq, seq=1):
    msg = p.WorkspaceMessage(seq, p.UpdateModuleParams(
        osc_mid, p.ModuleParams("Oscillator", p.OscillatorParams(freq, p.Waveform.SINE))))
    eng._process_cmd(("op", slot, msg))


def pcm_of(sub, idx=-1):
    header, payload = sub.packets[idx].split(b"\n", 1)
    return json.loads(header), np.frombuffer(payload, dtype=np.int16).reshape(-1, 2)


def single_render(ws, t0=0, n_blocks=1):
    """A dedicated single-patch render of the same workspace, as i16."""
    patch = compile_patch(ws, CFG, BlockSpec(BLOCK_TICKS), CPU)
    state = patch.init_state(ws)
    out = []
    for b in range(n_blocks):
        t = t0 + b * BLOCK_TICKS * CFG.samples_per_tick
        state, taps = patch.run(patch.prepare_aux(ws), patch.host_aux(t), state)
        (key,) = taps.keys()
        pcm = np.stack([(torch.clamp(c.reshape(-1), -1, 1) * 32767.0).to(torch.int16).numpy()
                        for c in taps[key]["audio"]], axis=1)
        out.append(pcm)
    return np.concatenate(out)


def _ws880():
    ws, o, _, _ = small_template()
    ws.update_params(o, p.ModuleParams("Oscillator", p.OscillatorParams(880.0, p.Waveform.SINE)))
    return ws


def test_join_edit_isolation_and_exactness():
    eng, (tmpl, o, a, m) = make_engine()
    s0, s1 = join(eng), join(eng)
    assert s0.index == 0 and s1.index == 1
    edit_freq(eng, s0, o, 880.0)
    assert s0.events.get_nowait() == ("sync", 1)
    sub0, sub1 = FakeSub(), FakeSub()
    s0.monitors.append(sub0)
    s1.monitors.append(sub1)
    for _ in range(3):  # issue-ahead: N + 1 blocks deliver N packets
        eng._block_once()
    pcm0 = np.concatenate([pcm_of(sub0, i)[1] for i in range(2)])
    pcm1 = np.concatenate([pcm_of(sub1, i)[1] for i in range(2)])
    assert not np.array_equal(pcm0, pcm1)  # the edit isolated to s0
    assert np.array_equal(pcm0, single_render(_ws880(), n_blocks=2))
    assert np.array_equal(pcm1, single_render(tmpl, n_blocks=2))


def test_leave_frees_slot_and_resets_state():
    eng, (tmpl, o, a, m) = make_engine(capacity=2)
    s0 = join(eng)
    edit_freq(eng, s0, o, 660.0)
    s0.monitors.append(FakeSub())
    eng._block_once()
    eng._process_cmd(("leave", s0))
    s0b = join(eng)  # the freed slot, with template params and fresh state
    assert s0b.index == 0
    sub2 = FakeSub()
    s0b.monitors.append(sub2)
    t0_before = eng.tick * CFG.samples_per_tick
    eng._block_once()
    eng._block_once()
    # the previous occupant's in-flight block never reaches the new session
    assert np.array_equal(pcm_of(sub2, 0)[1], single_render(tmpl, t0=t0_before))


def test_capacity_exhaustion_returns_none():
    eng, _ = make_engine(capacity=2)
    assert join(eng) is not None and join(eng) is not None
    assert join(eng) is None


def test_structural_ops_rejected_with_rollback():
    eng, (tmpl, o, a, m) = make_engine(capacity=1)
    s = join(eng)
    eng._process_cmd(("op", s, p.WorkspaceMessage(5, p.CreateModule(
        p.ModuleParams("Oscillator", p.OscillatorParams(100.0, p.Waveform.SINE)),
        p.WindowGeometry()))))
    assert s.events.get_nowait() == ("sync", 5)
    ev = s.events.get_nowait()
    assert ev[0] == "error" and "structural" in ev[2]
    eng._process_cmd(("op", s, p.WorkspaceMessage(6, p.UpdateModuleParams(
        o, p.ModuleParams("Oscillator", p.OscillatorParams(440.0, p.Waveform.SQUARE))))))
    assert s.events.get_nowait() == ("sync", 6)
    assert s.events.get_nowait()[0] == "error"
    assert s.ws.modules[o].params.params.waveform == p.Waveform.SINE
    sub = FakeSub()
    s.monitors.append(sub)
    eng._block_once()
    eng._block_once()
    assert sub.packets


def _edit_frame(osc_value: int, freq: float, seq: int = 1) -> bytes:
    op = {"t": "WorkspaceMessage", "sequence": seq,
          "op": {"t": "UpdateModuleParams", "module_id": osc_value,
                 "params": {"kind": "Oscillator",
                            "params": {"t": "OscillatorParams", "freq": freq,
                                       "waveform": "sine"}}}}
    return mask_frame(1, json.dumps({"v": 1, "kind": "Workspace", "m": op}).encode())


def test_ws_end_to_end_multiple_sessions():
    """Real sockets: three clients join, one edits, all stream framed i16
    PCM; Sync echoes; the edited session's audio is the edit's render."""
    eng, (tmpl, o, a, m) = make_engine(capacity=4)
    eng.start()
    app = FleetServeApp(eng)

    all_joined, n_joined = asyncio.Event(), [0]

    async def client(port, freq=None):
        reader, writer = await ws_connect("127.0.0.1", port, "/fleet")
        joined = json.loads((await asyncio.wait_for(ws_recv(reader), 5))[1])
        assert joined["t"] == "Joined"
        env = json.loads((await asyncio.wait_for(ws_recv(reader), 5))[1])
        assert env["kind"] == "WorkspaceState"
        n_joined[0] += 1
        if n_joined[0] == 3:
            all_joined.set()
        if freq is not None:
            writer.write(_edit_frame(o.value, freq))
            await writer.drain()
        # 3 packets once every client has joined, so the streams overlap; the
        # editor's last 2 after its Sync (the block in flight at the edit
        # predates it)
        pcms, after_sync, synced = [], 0, freq is None
        deadline = time.monotonic() + 15
        while ((len(pcms) < 3 or not synced or (freq and after_sync < 2))
               and time.monotonic() < deadline):
            opc, payload = await asyncio.wait_for(ws_recv(reader), 10)
            if opc == 1:
                msg = json.loads(payload)
                if msg.get("t") == "Sync":
                    assert msg["sequence"] == 1
                    synced = True
                assert msg.get("t") != "Error", msg
            elif opc == 2:
                header, body = payload.split(b"\n", 1)
                h = json.loads(header)
                assert h["t"] == "pcm" and h["rate"] == CFG.sample_rate
                if all_joined.is_set():
                    pcms.append((h["t0"], np.frombuffer(body, np.int16).reshape(-1, 2)))
                    after_sync += synced
        assert synced and len(pcms) >= 3 and (not freq or after_sync >= 2)
        writer.close()
        return joined["slot"], pcms

    async def go():
        port = await app.serve()
        res = await asyncio.gather(client(port), client(port, freq=880.0), client(port))
        await app.shutdown()
        return res

    try:
        (sa, pa), (sb, pb), (sc, pc) = asyncio.run(go())
    finally:
        eng.stop()
    assert len({sa, sb, sc}) == 3
    common = sorted({t for t, _ in pa} & {t for t, _ in pb} & {t for t, _ in pc})
    assert common, "no overlapping blocks across sessions"
    get = lambda pcms: next(x for t, x in pcms if t == common[-1])
    assert np.array_equal(get(pa), get(pc)) and np.any(get(pa) != 0)
    # the osc's phase is host-derived, so a fresh render at t0 is exact
    t0b, pcm_b = pb[-1]
    assert np.array_equal(pcm_b, single_render(_ws880(), t0=t0b))


def test_scripted_session_matches_jax_fleet_serve_app():
    """One scripted session to each package's FleetServeApp in one event
    loop, the engines stepped in lockstep by the test: join, one edit, five
    blocks.  Text frames and PCM headers byte-equal; PCM within 1 LSB."""
    ws_j, o_j, _, _ = jax_small_template()
    engines = [JaxFleetEngine(ws_j, 2, JaxEngineConfig(sample_rate=48_000),
                              block_ticks=BLOCK_TICKS), make_engine(capacity=2)[0]]
    apps = [JaxFleetServeApp(engines[0]), FleetServeApp(engines[1])]
    n_blocks = 5

    def drain(eng):
        while True:
            try:
                eng._process_cmd(eng._cmd.get_nowait())
            except queue.Empty:
                return

    async def session(port, inbox):
        reader, writer = await ws_connect("127.0.0.1", port, "/fleet")
        texts = [(await asyncio.wait_for(ws_recv(reader), 10))[1] for _ in range(2)]
        inbox.put_nowait("joined")
        writer.write(_edit_frame(o_j.value, 880.0))
        await writer.drain()
        binary = []
        while len(binary) < n_blocks - 1 or len(texts) < 3:
            opc, payload = await asyncio.wait_for(ws_recv(reader), 10)
            (texts if opc == 1 else binary).append(payload)
            if opc == 1:
                inbox.put_nowait("synced")
        writer.close()
        return texts, binary

    async def go():
        ports = [await app.serve() for app in apps]
        inboxes = [asyncio.Queue(), asyncio.Queue()]
        tasks = [asyncio.create_task(session(port, q)) for port, q in zip(ports, inboxes)]
        for want in ("joined", "synced"):
            for q in inboxes:
                while True:
                    for eng in engines:
                        drain(eng)
                    try:
                        assert await asyncio.wait_for(q.get(), 0.02) == want
                        break
                    except asyncio.TimeoutError:
                        continue
        for _ in range(n_blocks):
            for eng in engines:
                drain(eng)
                eng._block_once()
            await asyncio.sleep(0.01)
        results = await asyncio.gather(*tasks)
        for app in apps:
            await app.shutdown()
        return results

    (texts_j, bin_j), (texts_t, bin_t) = asyncio.run(go())
    assert texts_t == texts_j
    assert json.loads(texts_t[2]) == {"t": "Sync", "sequence": 1}
    assert len(bin_t) == len(bin_j) == n_blocks - 1
    for got, want in zip(bin_t, bin_j):
        hg, pg = got.split(b"\n", 1)
        hw, pw = want.split(b"\n", 1)
        assert hg == hw
        diff = np.abs(np.frombuffer(pg, np.int16).astype(np.int32)
                      - np.frombuffer(pw, np.int16).astype(np.int32))
        assert diff.max() <= 1 and np.any(np.frombuffer(pg, np.int16) != 0)
