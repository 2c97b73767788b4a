"""mixlab_tpu_torch — the PyTorch / CUDA port of :mod:`mixlab_tpu`.

The JAX package stays the reference; this package re-implements the
offline render path and the realtime engine tick with its video mixer for
one NVIDIA H100 (``sm_90a``) and keeps the JAX package's module names and
public signatures so each counterpart is easy to find.  It imports
``torch`` and ``numpy`` and nothing of ``mixlab_tpu`` or jax: the host code
it needs (``protocol``, ``engine/config.py``, the mountpoint registry, the
audio backends, the WAV writer, the FLAC encoder) is its own copy, with a
wire format identical to the JAX package's.

Package map:
  device.py       resolve_device: explicit cuda / cpu, no silent fallback
  convert.py      JAX-package aux / state pytrees and engine checkpoints
                  <-> the port's tensors
  flagship.py     the 16-module flagship graph, built without bench.py
  render_cli.py   ``python -m mixlab_tpu_torch.render_cli p.mixlab out.wav``
  protocol/       module ids, params, wire encoding (copy of the JAX package's)
  dsp/            module defs; envelope_cuda / eq_cuda wrap the CUDA kernels
  engine/         workspace graph, compiler, region program (region_graph,
                  region_cuda), render loops, project files, config, the
                  realtime Engine with its feeds and timing
  video/          frames, colorspace, patterns, scale, the crossfade (blend,
                  wrapping its CUDA kernel) and the video mixer tick
  io_host/, av/   mountpoint registry, audio-out backends, WAV writer, FLAC
                  encoder
  utils/          exact rational media time
  csrc/           the hand-written CUDA C++ kernels (built at first use)
  kernels.py      builds csrc/ with nvcc into _build/ and loads it (ctypes)
"""

__version__ = "0.3.0"
