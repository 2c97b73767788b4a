"""Several processes as one mesh (``mixlab_tpu_torch/parallel/distributed.py``)
against the JAX package's single-process mesh (``tests/test_distributed.py``).

Two processes join a ``gloo`` group through ``bring_up`` (over ``tcp://``,
or from ``torchrun``'s environment variables), each with a 4-entry CPU
mesh: one 8-shard global mesh.  Each runs its own 4 shards of the
flagship's 8 stems, and the master (each process's shards
summed, then ``all_reduce``d) must equal the JAX ``stem_parallel_step`` on
its 8-device virtual CPU mesh, checksum within 1e-3 relative
(``tests/test_distributed.py:99-104``).  The workers import no JAX."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
WAIT_S = 120

WORKER = r"""
import json, os, sys
sys.path.insert(0, sys.argv[4])
pid, port, out_path, init = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[5]
import numpy as np
import torch
torch.set_num_threads(2)

from mixlab_tpu_torch.engine.config import BlockSpec, EngineConfig
from mixlab_tpu_torch.flagship import build_16_module_graph
from mixlab_tpu_torch.parallel.distributed import (
    bring_up, distributed_stems_step, fleet_owner, global_to_host_local,
    host_local_to_global)

if init == "tcp":
    mesh = bring_up(f"127.0.0.1:{port}", 2, pid, devices=["cpu"] * 4)
else:  # started as torchrun starts a process: the group's variables set
    mesh = bring_up(devices=["cpu"] * 4)
assert (len(mesh), mesh.size, mesh.rank, mesh.world) == (4, 8, pid, 2)
ws, mon = build_16_module_graph()
fn, make_args, _ = distributed_stems_step(ws, EngineConfig(sample_rate=48_000), BlockSpec(4),
                                          mesh, str(mon.value))
aux, host_aux, state, mask = make_args()
st, master = fn(aux, host_aux, state, mask)
master = master.numpy()
# this process's pad mask rows, gathered over the group: the 8 stems, in order
local_mask = torch.cat(mask)
whole_mask = host_local_to_global(local_mask, mesh)
assert whole_mask.tolist() == [1.0] * 8
assert torch.equal(global_to_host_local(whole_mask, mesh), local_mask)
sessions = [s for s in range(10) if fleet_owner(s, mesh.world) == pid]
if pid == 0:
    open(out_path, "w").write(json.dumps({
        "rms": float(np.sqrt((master.astype("float64") ** 2).mean())),
        "checksum": float(master.astype("float64").sum()),
        "shape": list(master.shape), "sessions": sessions}))
torch.distributed.destroy_process_group()
print(f"[p{pid}] done", flush=True)
"""


def _free_port():
    """A loopback port that rank 0's store can bind and no other process
    is handed meanwhile.  A port merely bound and closed goes back to the
    pool at once: under a loaded suite another test's server took it
    before rank 0 (still importing torch) bound it, and rank 0 died with
    EADDRINUSE while rank 1 waited.  Here one connection is made to the
    port and its accepted end closed first, which leaves the port in
    TIME_WAIT: the kernel hands it to no ``bind(0)`` or ``connect()`` for
    a minute, while the store, which binds with SO_REUSEADDR, may take it."""
    import socket

    with socket.socket() as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        addr = srv.getsockname()
        with socket.create_connection(addr) as cli:
            conn, _ = srv.accept()
            conn.close()  # the accepted end closes first: TIME_WAIT on addr
    return addr[1]


def _join(procs, timeout):
    """Each process's output once all have ended.  A process that fails
    ends the others at once (its peer would wait on the group for ever),
    so the failing worker's own log is what the test reports."""
    import threading
    import time

    logs = [""] * len(procs)

    def read(i):
        logs[i] = procs[i].stdout.read()

    readers = [threading.Thread(target=read, args=(i,), daemon=True) for i in range(len(procs))]
    for r in readers:
        r.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(10)
        for r in readers:
            r.join(10)
    return logs


@pytest.fixture(scope="module")
def jax_master():
    """The JAX package's single process on its 8-device virtual mesh."""
    import bench
    from mixlab_tpu.engine.config import BlockSpec, EngineConfig
    from mixlab_tpu.parallel.stems import make_mesh, stem_parallel_step

    ws, mon = bench.build_16_module_graph()
    fn, make_args, _ = stem_parallel_step(ws, EngineConfig(sample_rate=48_000), BlockSpec(4),
                                          make_mesh(8), str(mon.value))
    return np.asarray(fn(*make_args())[1])


@pytest.mark.parametrize("init", ["tcp", "env"])
def test_two_process_global_mesh_matches_single_process(tmp_path, jax_master, init):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    out = tmp_path / "out.json"
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}

    def group_env(pid):
        if init == "tcp":
            return env
        return {**env, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                "WORLD_SIZE": "2", "RANK": str(pid)}

    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), str(port), str(out), str(ROOT), init],
        env=group_env(pid), cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
        for pid in (0, 1)]
    logs = _join(procs, WAIT_S)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    got = json.loads(out.read_text())
    assert got["sessions"] == [0, 2, 4, 6, 8]
    assert got["shape"] == list(jax_master.shape)
    want = float(jax_master.astype(np.float64).sum())
    assert abs(got["checksum"] - want) < 1e-3 * max(1.0, abs(want))
    assert got["rms"] > 0.01  # actual audio, not zeros


@pytest.mark.parametrize("env,world,want", [
    ({"LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "4"}, 8, ["cuda:2"]),
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, 4, ["cuda:2", "cuda:3"]),
    ({"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}, 2, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ({}, 1, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ({"LOCAL_RANK": "5", "LOCAL_WORLD_SIZE": "8"}, 8, None),
    ({}, 2, None),
])
def test_default_devices_split_the_host_cards(env, world, want):
    """With no devices named, a process takes its contiguous share of its
    host's 4 cards by ``LOCAL_RANK`` of ``LOCAL_WORLD_SIZE`` (all of them
    alone); a default that would put two ranks on one card raises."""
    from mixlab_tpu_torch.parallel.distributed import default_devices

    if want is None:
        with pytest.raises(ValueError, match="name"):
            default_devices(world, 4, env)
    else:
        assert default_devices(world, 4, env) == want


@pytest.mark.parametrize("cards", [0, 1])
def test_bring_up_default_devices_refused_before_joining(monkeypatch, cards):
    """``bring_up`` from torchrun's environment with no devices named: with
    no card it raises through ``resolve_device``; with one card and a group
    of two that gives no ``LOCAL_RANK`` it refuses the shared default.  Both
    before any group is joined (no rendezvous is waited on)."""
    import torch
    import torch.distributed as dist

    from mixlab_tpu_torch.parallel import distributed

    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(RuntimeError if cards == 0 else ValueError):
        distributed.bring_up()
    assert not dist.is_initialized()
