"""The PyTorch port imports neither jax nor the JAX package, picks devices
explicitly and raises where a kernel cannot run."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mixlab_tpu_torch import kernels
from mixlab_tpu_torch.dsp.base import OP_TAP, RegionPlan
from mixlab_tpu_torch.device import resolve_device
from mixlab_tpu_torch.dsp.envelope_cuda import envelope_block_batched, envelope_block_cuda
from mixlab_tpu_torch.dsp.eq_cuda import eq_cascade_batched, eq_cascade_cuda
from mixlab_tpu_torch.dsp.registry import get_def
from mixlab_tpu_torch.engine.region_cuda import region_part_batched, region_part_cuda
from mixlab_tpu_torch.tools.profile_env_eq import passthrough_cuda
from mixlab_tpu_torch.video.blend import crossfade_cuda, crossfade_picture
from mixlab_tpu_torch.video.resize_cuda import resize_picture_polyphase, resize_plane_polyphase

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "mixlab_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
import mixlab_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mixlab_tpu_torch.__path__,
                                               "mixlab_tpu_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.append("tests")
import torch_support  # the helpers the port's tests share import neither
names.append("tests.torch_support")
import chip_smoke  # nor does the chip script
import importlib.util
examples = {}
for example in ("torch_synth_patch", "torch_fleet_demo"):  # nor do the port's examples
    spec = importlib.util.spec_from_file_location(example, f"examples/{example}.py")
    examples[example] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(examples[example])
    names.append(f"examples.{example}")
ws, _ = examples["torch_synth_patch"].build_patch()
assert len(ws.modules) == 11
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("\n".join(names))
"""


def test_port_imports_with_jax_and_the_jax_package_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 50  # every module of the four slices
    assert "tests.torch_support" in names
    # the port's own copies of the host code it once took from mixlab_tpu
    assert {f"mixlab_tpu_torch.{m}" for m in (
        "protocol", "protocol.wire", "engine.config", "io_host.wav", "av.flacenc",
        "engine.region_graph", "engine.region_cuda")} <= names
    # the realtime engine and its video path
    assert {f"mixlab_tpu_torch.{m}" for m in (
        "engine.engine", "engine.feeds", "engine.timing", "io_host.source",
        "io_host.audio_out", "io_host.alsa_out", "utils.mtime", "dsp.video_mixer",
        "video.frame", "video.colorspace", "video.pattern", "video.scale", "video.blend",
        "video.engine")} <= names
    # the video scale family and the profiling tool
    assert {f"mixlab_tpu_torch.{m}" for m in (
        "video.resize_cuda", "video.fused", "video.scale_host", "tools",
        "tools.profile_env_eq")} <= names
    # the served session: the entry point, the server, the codecs, the
    # host C++ loader and the protocol sniffer
    assert {f"mixlab_tpu_torch.{m}" for m in (
        "__main__", "server", "server.app", "server.http", "server.ws", "server.monitor",
        "server.fleet", "av.aac", "av.aac_tables", "av.aacenc", "av.avc", "av.sps",
        "av.h264enc", "av.h264cavlc", "av.h264cavlc_fast", "av.mp4", "av.encode_stream",
        "av.codecs", "native", "io_host.listen", "engine.project")} <= names
    # the batched paths: the fleet, fleet serving, stems and the resampler
    assert {f"mixlab_tpu_torch.{m}" for m in (
        "parallel", "parallel.fleet", "parallel.stems", "server.fleet_serve",
        "dsp.resampler")} <= names
    # media playback: the decode thread, its readers and decoders, the
    # throttles and the AAC codec process
    assert {f"mixlab_tpu_torch.{m}" for m in (
        "engine.media_player", "io_host.throttle", "av.y4m", "av.jpeg", "av.flacdec",
        "av.ogg", "av.vorbis", "av.mp4read", "av.aacdec", "av.h264mc", "av.cabac_tables",
        "av.h264cabac", "av.h264dec_fast", "av.h264dec", "av.aac_worker")} <= names
    # live ingest and broadcast: the FLV and MP3 layers, the RTMP stack, the
    # Icecast listener, the StreamOutput controller and the AAC decode process
    assert {f"mixlab_tpu_torch.{m}" for m in (
        "av.flv", "av.mp3", "av.codec_process", "av.aacdec_worker", "io_host.icecast",
        "io_host.rtmp", "io_host.rtmp.amf0", "io_host.rtmp.chunk", "io_host.rtmp.handshake",
        "io_host.rtmp.server", "io_host.rtmp.client", "io_host.rtmp.ffmpeg_decode",
        "server.stream_output")} <= names
    # scale-out: the mesh, several processes as one mesh, the fleet
    # controller with its host agents
    assert {f"mixlab_tpu_torch.{m}" for m in (
        "parallel", "parallel.distributed", "server.fleet")} <= names
    # the last modules: the live engine's edit path, the rest of the host
    # C++ and the libavcodec shim
    assert {f"mixlab_tpu_torch.{m}" for m in (
        "engine.engine", "engine.compiler", "kernels", "native", "native.avshim")} <= names
    # the entry examples, beside the JAX package's
    assert {"examples.torch_synth_patch", "examples.torch_fleet_demo"} <= names


_CONCURRENT_BUILD = r"""
import sys
from pathlib import Path
from mixlab_tpu_torch import native

native.BUILD_DIR = Path(sys.argv[1])
print(native.build())
assert native.available()
lib = native._load()
for name in ("ws_unmask", "h264_encode_frame", "h264_parse_slice", "h264_dc_recon",
             "h264_decode_islice", "h264_decode_islice_cabac", "h264_decode_inter",
             "scale_plane_banded", "ring_create", "ring_push", "ring_pop", "pcm_f32_to_i16",
             "pcm_i16_to_f32", "crossfade_u8"):
    getattr(lib, name)
"""

_CONCURRENT_SHIM_BUILD = r"""
import sys
from pathlib import Path
from mixlab_tpu_torch.native import avshim

avshim.BUILD_DIR = Path(sys.argv[1])
print(avshim.build())
assert avshim.available(), avshim.unavailable_reason()
assert avshim.have_decoder("h264") and avshim.have_encoder("aac")
"""


def test_native_build_is_atomic_under_concurrent_first_use(tmp_path):
    """Six processes start the host C++ build at once into an empty folder:
    one library results, every process loads it with every entry point
    (the encoder and, since the media slice, the H.264 decoders, which make
    the build several times longer), and no temporary file is left
    behind."""
    procs = [subprocess.Popen([sys.executable, "-c", _CONCURRENT_BUILD, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    (path,) = paths
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(
        [Path(path).name, Path(path).with_suffix(".lock").name])


def test_avshim_build_is_atomic_under_concurrent_first_use(tmp_path):
    """As the host C++: six processes build the libavcodec shim at once into
    an empty folder, one library results and every process loads it."""
    from mixlab_tpu_torch.native import avshim

    if not avshim.available():
        pytest.skip(f"libavcodec shim unavailable: {avshim.unavailable_reason()}")
    procs = [subprocess.Popen([sys.executable, "-c", _CONCURRENT_SHIM_BUILD, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    (path,) = paths
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(
        [Path(path).name, Path(path).with_suffix(".lock").name])


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")


def test_unported_kind_names_its_roadmap_item(monkeypatch):
    """Every kind of the JAX package is ported (the video mixer last); a kind
    listed in ``NOT_PORTED`` would raise naming its ROADMAP.md item."""
    from mixlab_tpu import protocol as jp
    from mixlab_tpu_torch.dsp import registry

    assert registry.NOT_PORTED == {}
    assert set(registry.all_kinds()) == set(jp.ModuleParams.KINDS)
    assert get_def("VideoMixer").kind == "VideoMixer"
    monkeypatch.setitem(registry.NOT_PORTED, "Vocoder", "queue 9 item 9")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 9 item 9"):
        get_def("Vocoder")
    with pytest.raises(KeyError):
        get_def("NoSuchKind")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("NVCC", str(tmp_path / "missing-nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()


@pytest.mark.parametrize("wrapper", ["envelope", "eq", "region", "crossfade", "resize",
                                     "passthrough", "envelope_batched", "eq_batched",
                                     "region_batched"])
def test_wrappers_refuse_other_devices(wrapper):
    """Only CPU tensors take the plain twin; any other device launches the
    kernel or raises — here a meta tensor must raise, not fall back."""
    x = torch.empty(4096, device="meta")
    if wrapper == "envelope":
        state = {"mode_on": torch.tensor(False), "on_pos": torch.tensor(0),
                 "off_pos": torch.tensor(0), "off_amp": torch.tensor(0.0)}
        with pytest.raises(ValueError, match="unsupported device"):
            envelope_block_cuda(x, state, {}, 1.0)
    elif wrapper == "eq":
        with pytest.raises(ValueError, match="unsupported device"):
            eq_cascade_cuda(x, x, torch.zeros(4, 2), torch.ones(3), 0.1, 0.2, 0.0)
    elif wrapper == "envelope_batched":
        xb = torch.empty((2, 4096), device="meta")
        state = {"mode_on": torch.zeros(2, dtype=torch.bool),
                 "on_pos": torch.zeros(2, dtype=torch.int32),
                 "off_pos": torch.zeros(2, dtype=torch.int32), "off_amp": torch.zeros(2)}
        with pytest.raises(ValueError, match="unsupported device"):
            envelope_block_batched(xb, state, {}, 1.0)
    elif wrapper == "eq_batched":
        xb = torch.empty((2, 4096), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            eq_cascade_batched(xb, xb, torch.zeros(2, 4, 2), torch.ones(2, 3), 0.1, 0.2, 0.0)
    elif wrapper == "resize":
        y = torch.empty((48, 64), dtype=torch.uint8, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            resize_picture_polyphase([y, y], [(72, 96), (48, 96)])
        with pytest.raises(ValueError, match="unsupported device"):
            resize_plane_polyphase(y, 72, 96)
    elif wrapper == "passthrough":
        with pytest.raises(ValueError, match="unsupported device"):
            passthrough_cuda(x)
    elif wrapper == "crossfade":
        y = torch.empty((4, 4), dtype=torch.uint8, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            crossfade_cuda([y], [y], 128)
        with pytest.raises(ValueError, match="unsupported device"):
            crossfade_picture({"y": y}, {"y": y}, 128)
    else:
        plan = RegionPlan(n_operands=1, n_pf=0, n_ef=0)
        plan.add(OP_TAP, 0, 0)
        plan.n_taps = 1
        empty = torch.empty(0, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            if wrapper == "region":
                region_part_cuda(plan, [x], empty, empty, 4096)
            else:
                region_part_batched(plan, [torch.empty((2, 4096), device="meta")],
                                    torch.empty((2, 0), device="meta"),
                                    torch.empty((2, 0), device="meta"), 4096, empty, 2)


def test_kernel_library_name_tracks_sources():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert {p.name for p in kernels.sources()} == {"crossfade.cu", "envelope.cu",
                                                   "eq_cascade.cu", "region.cu", "resize.cu",
                                                   "passthrough.cu"}
    assert set(kernels._SIGNATURES) == {
        "mixlab_envelope_block", "mixlab_eq_cascade", "mixlab_region_part",
        "mixlab_crossfade", "mixlab_resize_picture", "mixlab_passthrough"}
    assert set(kernels._QUERIES) == {"mixlab_envelope_resident_tiles",
                                     "mixlab_eq_resident_tiles",
                                     "mixlab_eq_rows_resident",
                                     "mixlab_region_resident_tiles",
                                     "mixlab_envelope_rows_resident",
                                     "mixlab_region_rows_resident"}
    # every C entry point is defined in a source
    text = "".join(src.read_text() for src in kernels.sources())
    for name in {**kernels._SIGNATURES, **kernels._QUERIES}:
        assert f"int {name}(" in text, name
    # nothing in the flags may trade IEEE f32 for speed
    assert not any("fast_math" in f or "fast-math" in f for f in kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_convert_roundtrip_types():
    from mixlab_tpu_torch.convert import to_numpy, to_torch

    tree = {"7": {"mode_on": np.bool_(True), "on_pos": np.int64(-5),
                  "off_amp": np.float64(0.25), "poles": np.zeros((4, 2))},
            "9": None}
    t = to_torch(tree, torch.device("cpu"))
    assert t["7"]["mode_on"].dtype == torch.bool
    assert t["7"]["on_pos"].dtype == torch.int32
    assert t["7"]["off_amp"].dtype == torch.float32
    assert t["7"]["poles"].shape == (4, 2) and t["9"] is None
    back = to_numpy(t)
    assert back["7"]["on_pos"] == -5 and bool(back["7"]["mode_on"])
