"""Fleet scale-out demo of the PyTorch port: controller + two host agents on
this machine, three workspaces placed least-loaded, one live-migrated
between hosts.

    python examples/torch_fleet_demo.py [--device cuda|cpu]

Every worker is a real ``python -m mixlab_tpu_torch --device <device>``
server process (on the card unless ``--device cpu``); migration moves the
project file AND the engine's runtime DSP checkpoint, so the target resumes
from the same tick.  The demo of ``examples/fleet_demo.py``, over
``mixlab_tpu_torch.server.fleet``."""

from __future__ import annotations

import argparse
import asyncio
import json
import shutil
import sys
import tempfile
from pathlib import Path

# runnable as a script from anywhere: put the repo root on the path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mixlab_tpu_torch.server.fleet import FleetController, HostAgent, http_call  # noqa: E402


async def demo(device: str, data: Path):
    ctl = FleetController()
    servers = [await ctl.serve()]
    agents = []
    for host_id in ("host-a", "host-b"):
        agent = HostAgent(host_id, data / host_id, respawn_interval=5.0, device=device)
        servers.append(await agent.serve())
        agents.append(agent)
        await http_call(ctl.url + "/register", "POST", json.dumps(
            {"host_id": host_id, "url": agent.url}).encode())
    print(f"controller {ctl.url}; agents "
          + ", ".join(f"{a.host_id}={a.url}" for a in agents) + f"; workers on {device}")

    async def beat():
        while True:
            for a in agents:
                await http_call(ctl.url + "/heartbeat", "POST", json.dumps(
                    {"host_id": a.host_id}).encode())
            await asyncio.sleep(1.0)

    hb = asyncio.ensure_future(beat())
    try:
        for key in ("drums", "vocals", "master"):
            _, body = await http_call(ctl.url + f"/workspaces/{key}", "POST",
                                      timeout=360.0)
            placed = json.loads(body)
            print(f"placed {key!r} on {placed['host']} -> {placed['url']}")

        _, body = await http_call(ctl.url + "/fleet")
        print("fleet:", json.dumps(json.loads(body), indent=2))

        _, body = await http_call(ctl.url + "/route/drums")
        src = json.loads(body)
        dst = "host-b" if src["host"] == "host-a" else "host-a"
        print(f"migrating 'drums' {src['host']} -> {dst} ...")
        _, body = await http_call(ctl.url + "/migrate/drums", "POST",
                                  json.dumps({"to": dst}).encode(), timeout=360.0)
        moved = json.loads(body)
        print(f"migrated: now on {moved['host']} at {moved['url']} "
              f"(runtime state restored: {moved.get('restored')})")
    finally:
        hb.cancel()
        for agent in agents:
            await agent.shutdown()
        for server in servers:
            server.close()
    print("done")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="the workers' device")
    args = parser.parse_args(argv)
    data = Path(tempfile.mkdtemp(prefix="fleet-demo-"))
    try:
        asyncio.run(demo(args.device, data))
    finally:
        shutil.rmtree(data, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
