"""The port's own copies of the JAX package's host code: the protocol and its
wire encoding (byte-identical both ways, so ``.mixlab`` files and wire
messages are interchangeable), the engine config, the WAV writer, the f32 ->
i16 conversion and the FLAC encoder."""

import dataclasses

import numpy as np
import pytest

from mixlab_tpu import protocol as jp
from mixlab_tpu.av.flacenc import FlacEncoder as JaxFlacEncoder
from mixlab_tpu.engine import config as jax_config
from mixlab_tpu.io_host.wav import write_wav as jax_write_wav
from mixlab_tpu.native import pcm_f32_to_i16 as jax_pcm_f32_to_i16
from mixlab_tpu.protocol import wire as jax_wire
from mixlab_tpu_torch import protocol as tp
from mixlab_tpu_torch.av.flacenc import FlacEncoder
from mixlab_tpu_torch.engine import config as port_config
from mixlab_tpu_torch.io_host.wav import pcm_f32_to_i16, write_wav
from mixlab_tpu_torch.protocol import wire as port_wire


def _messages():
    """One JAX-package value of each wire shape: every module kind's
    params, workspace ops, server updates, indications, performance info."""
    mid, geo = jp.ModuleId(7), jp.WindowGeometry(jp.Coords(3, -4), 2)
    mixer = jp.MixerParams((jp.MixerChannelParams(jp.Decibel(-6.0), 0.5, True),
                            jp.MixerChannelParams()))
    params = [
        jp.ModuleParams("Amplifier", jp.AmplifierParams(0.5, 0.3)),
        jp.ModuleParams("Envelope", jp.EnvelopeParams(1.0, 2.0, 0.5, 3.0)),
        jp.ModuleParams("EqThree", jp.EqThreeParams(jp.Decibel(4.0), jp.Decibel(-2.0),
                                                    jp.Decibel(3.0))),
        jp.ModuleParams("FmSine", jp.FmSineParams(440.0, 880.0)),
        jp.ModuleParams("MediaSource", jp.MediaSourceParams(jp.MediaId(3))),
        jp.ModuleParams("Mixer", mixer),
        jp.ModuleParams("Monitor", None),
        jp.ModuleParams("Oscillator", jp.OscillatorParams(330.0, jp.Waveform.SAW)),
        jp.ModuleParams("OutputDevice", jp.OutputDeviceParams("hw:0", 0, 1)),
        jp.ModuleParams("Plotter", None),
        jp.ModuleParams("StereoPanner", None),
        jp.ModuleParams("StereoSplitter", None),
        jp.ModuleParams("StreamInput", jp.StreamInputParams(jp.StreamProtocol.RTMP, "live")),
        jp.ModuleParams("StreamOutput", jp.StreamOutputParams(2, 2, 0, "rtmp://x", "k")),
        jp.ModuleParams("Trigger", jp.GateState.CLOSED),
        jp.ModuleParams("VideoMixer", jp.VideoMixerParams(1, 2, 0.25)),
    ]
    ops = [jp.WorkspaceMessage(1, jp.CreateModule(pm, geo)) for pm in params] + [
        jp.WorkspaceMessage(2, jp.UpdateModuleParams(mid, params[0])),
        jp.WorkspaceMessage(3, jp.UpdateWindowGeometry(mid, geo)),
        jp.WorkspaceMessage(4, jp.DeleteModule(mid)),
        jp.WorkspaceMessage(5, jp.CreateConnection(jp.InputId(mid, 1), jp.OutputId(jp.ModuleId(2), 0))),
        jp.WorkspaceMessage(6, jp.DeleteConnection(jp.InputId(mid, 0))),
    ]
    updates = [
        jp.SUCreateModule(mid, params[5], geo, jp.Indication("Mixer"),
                          (jp.LineType.STEREO.labeled("In"),), (jp.LineType.MONO.labeled("Out"),)),
        jp.SUUpdateModuleIndication(mid, jp.Indication(
            "OutputDevice", jp.OutputDeviceIndication(
                jp.TemporalWarningStatus.ACTIVE, None, "hw:0", (("hw:0", 2),)))),
        jp.SUUpdateModuleIndication(mid, jp.Indication(
            "StreamOutput", jp.StreamOutputIndication(jp.StreamOutputLiveStatus.LIVE, True))),
        jp.SUUpdateModuleIndication(mid, jp.Indication(
            "Plotter", jp.PlotterIndication(((0.5, -0.25), (1.0,))))),
        jp.SUDeleteConnection(jp.InputId(mid, 0)),
        jp.PerformanceInfo(True, None, 60, jp.Microseconds(16_666), [
            (jp.PerformanceAccount("engine"), jp.PerformanceMetric(jp.Microseconds(5))),
            (jp.PerformanceAccount("module", mid), jp.PerformanceMetric(jp.Microseconds(9)))],
            0.5),
        jp.MediaLibrary([jp.MediaItem(jp.MediaId(1), "a.wav", "audio/wav", 10)]),
    ]
    return ops + updates


MESSAGES = _messages()


@pytest.mark.parametrize("i", range(len(MESSAGES)),
                         ids=[f"{i}-{type(getattr(m, 'op', m)).__name__}"
                              for i, m in enumerate(MESSAGES)])
def test_wire_is_byte_identical_both_ways(i):
    msg = MESSAGES[i]
    text = jax_wire.dumps(msg)
    mine = port_wire.loads(text)
    assert type(mine).__module__.startswith("mixlab_tpu_torch.protocol")
    assert port_wire.dumps(mine) == text
    back = jax_wire.loads(port_wire.dumps(mine))
    assert back == msg


def test_protocol_names_match():
    """Every public name of the JAX package's protocol has its copy, and the
    params registry lists the same kinds."""
    names = {n for n in dir(jp) if not n.startswith("_") and n[0].isupper()}
    assert names <= set(dir(tp))
    assert set(tp.ModuleParams.KINDS) == set(jp.ModuleParams.KINDS)
    for kind, cls in jp.ModuleParams.KINDS.items():
        assert tp.ModuleParams.KINDS[kind].__name__ == cls.__name__


@pytest.mark.parametrize("cls", ["EngineConfig", "BlockSpec"])
def test_config_copies_match(cls):
    mine, theirs = getattr(port_config, cls), getattr(jax_config, cls)
    assert [(f.name, f.default) for f in dataclasses.fields(mine)] == \
        [(f.name, f.default) for f in dataclasses.fields(theirs)]
    for rate in (44_100, 48_000, 96_000):
        c_m, c_t = port_config.EngineConfig(sample_rate=rate), jax_config.EngineConfig(sample_rate=rate)
        assert c_m.samples_per_tick == c_t.samples_per_tick
        for ticks in (1, 3, 60, 64):
            assert (port_config.BlockSpec(ticks).n_samples(c_m)
                    == jax_config.BlockSpec(ticks).n_samples(c_t))


def _pcm(seed, n=5000):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    x[:8, 0] = [1.0, -1.0, 0.99999994, -0.99999994, 1.5, -1.5, 0.0, -0.0]
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pcm_f32_to_i16_matches_native(seed):
    """Clip, scale by 32767 in f32, truncate: the native conversion of the
    JAX package bit for bit."""
    x = _pcm(seed)
    assert np.array_equal(pcm_f32_to_i16(x), jax_pcm_f32_to_i16(x))


@pytest.mark.parametrize("rate", [44_100, 48_000])
def test_wav_files_are_byte_identical(tmp_path, rate):
    x = _pcm(rate)
    write_wav(tmp_path / "a.wav", rate, x)
    jax_write_wav(tmp_path / "b.wav", rate, x)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


@pytest.mark.parametrize("block", [1024, 4096])
def test_flac_frames_are_byte_identical(block):
    pcm = pcm_f32_to_i16(_pcm(block, n=3 * block + 17))
    mine, theirs = FlacEncoder(48_000, 2, block_size=block), JaxFlacEncoder(48_000, 2, block_size=block)
    assert mine.stream_header() == theirs.stream_header()
    for i in range(0, len(pcm), block):
        assert mine.encode_frame(pcm[i:i + block]) == theirs.encode_frame(pcm[i:i + block])
