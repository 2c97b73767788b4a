// ADSR envelope over one block: one CUDA thread block, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mixlab_tpu/dsp/envelope_pallas.py
// (envelope_block_pallas / _env_body), which evaluates the reference's
// per-sample gate state machine (src/module/envelope.rs:34-117) as
//   phase A  - every lane walks its chunk of C samples twice, once per
//              possible entry mode, building a symbolic transfer record;
//   combine  - an in-order scan composes the lane records;
//   phase B  - every lane, now knowing its entry state, emits its samples.
//
// Layout: K = 1024 lanes = the 1024 threads of one block; lane k owns the
// samples [k*C, k*C + C), C = ceil(S / K) (44 at S = 44,100).  Samples past S
// read the pad value 0.5, which is neither a gate-on (1.0) nor a gate-off
// (0.0) and so leaves every machine unchanged.
//
// What bounds it on the card: latency, not bandwidth or FLOPs.  A block of
// 44,100 samples is 176 KB of input; the work is ~2*C dependent steps per
// lane plus a log-depth scan, all on ONE SM, so the kernel costs a few tens
// of microseconds whatever the card's throughput.  The design keeps the
// dependent chain short rather than spreading the work: both machines'
// 8-field records live in registers (launch bounds cap them at 64 per
// thread so 1024 threads fit one SM), the lane composition is a warp-shuffle
// scan (5 rounds) plus one scan over the 32 warp totals in shared memory,
// and x is read straight from global memory (a lane's C consecutive samples
// share cache lines, so phase B re-reads hit L1/L2).  Several envelopes per
// launch, or an envelope fused into its consumers, would use more SMs; that
// is later work.
//
// Semantics kept from the reference and the TPU kernel:
//   * exact `== 1.0f` (rising) and `== 0.0f` (falling) gate tests;
//   * positions are int32 sample offsets relative to the block start; the
//     int subtraction happens before the f32 conversion;
//   * exits are rebased by -S and clamped at POS_FLOOR;
//   * amp_on follows envelope.rs:37-51 including division by zero
//     (attack_ms == 0) and NaN propagation through the clip (no fast math).

#include <cuda_runtime.h>
#include <stdint.h>

#include "on_device.cuh"

namespace {

constexpr int kLanes = 1024;
constexpr int kWarps = kLanes / 32;
constexpr int kPosFloor = -(1 << 30);

// off_amp record kinds (envelope_chunked.py / envelope_pallas.py)
constexpr int kConc = 0;   // off_amp is a concrete value
constexpr int kEntry = 1;  // off_amp = entry.off_amp
constexpr int kOn = 2;     // off_amp = amp_on(ampp - entry.on)

// One entry machine's symbolic record.  *_sym == 1 means "still the entry
// state's value"; otherwise *_pos is concrete.
struct Rec {
  int mode, on_sym, on_pos, off_sym, off_pos, ampk;
  float ampv;
  int ampp;
};

struct Pair {
  Rec m[2];  // m[e] = the lane's record when it is entered in mode e
};

struct Params {
  float attack, decay, sustain, release, msps;
};

__device__ __forceinline__ float clip01(float v) {
  // jnp.clip semantics: NaN passes through
  return v > 1.0f ? 1.0f : (v < 0.0f ? 0.0f : v);
}

__device__ __forceinline__ float amp_on(float ms, const Params& p) {
  float attack_amp = ms / p.attack;
  float decay_amp = 1.0f - clip01((ms - p.attack) / p.decay);
  float sustain_amp = p.sustain + (1.0f - p.sustain) * decay_amp;
  return ms < p.attack ? attack_amp : sustain_amp;
}

__device__ __forceinline__ int sub_wrap(int a, int b) {
  // int32 subtraction with two's-complement wrap, as jnp int32 arithmetic
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ float amp_on_at(int pos, int on, const Params& p) {
  return amp_on(static_cast<float>(sub_wrap(pos, on)) * p.msps, p);
}

__device__ __forceinline__ Pair identity_pair() {
  Pair r;
  for (int e = 0; e < 2; ++e) {
    r.m[e].mode = e;
    r.m[e].on_sym = 1;
    r.m[e].on_pos = 0;
    r.m[e].off_sym = 1;
    r.m[e].off_pos = 0;
    r.m[e].ampk = kEntry;
    r.m[e].ampv = 0.0f;
    r.m[e].ampp = 0;
  }
  return r;
}

// g's entry symbols resolved against f's exit (envelope_pallas.substitute)
__device__ __forceinline__ Rec substitute(const Rec& g, const Rec& f, const Params& p) {
  Rec o;
  o.mode = g.mode;
  o.on_sym = g.on_sym ? f.on_sym : 0;
  o.on_pos = g.on_sym ? f.on_pos : g.on_pos;
  o.off_sym = g.off_sym ? f.off_sym : 0;
  o.off_pos = g.off_sym ? f.off_pos : g.off_pos;
  if (g.ampk == kConc) {
    o.ampk = kConc;
    o.ampv = g.ampv;
    o.ampp = g.ampp;
  } else if (g.ampk == kEntry) {
    o.ampk = f.ampk;
    o.ampv = f.ampv;
    o.ampp = f.ampp;
  } else if (f.on_sym == 0) {  // kOn against a concrete rising edge
    o.ampk = kConc;
    o.ampv = amp_on_at(g.ampp, f.on_pos, p);
    o.ampp = g.ampp;
  } else {
    o.ampk = kOn;
    o.ampv = 0.0f;
    o.ampp = g.ampp;
  }
  return o;
}

// (g after f) for both entry modes; f covers the earlier lanes.  The
// composition is associative but not commutative: callers keep lane order.
__device__ __forceinline__ Pair compose(const Pair& f, const Pair& g, const Params& p) {
  Pair r;
  for (int e = 0; e < 2; ++e) {
    const Rec& fe = f.m[e];
    const Rec& gs = fe.mode ? g.m[1] : g.m[0];
    r.m[e] = substitute(gs, fe, p);
  }
  return r;
}

__device__ __forceinline__ Rec shfl_up_rec(const Rec& r, int delta) {
  const unsigned full = 0xffffffffu;
  Rec o;
  o.mode = __shfl_up_sync(full, r.mode, delta);
  o.on_sym = __shfl_up_sync(full, r.on_sym, delta);
  o.on_pos = __shfl_up_sync(full, r.on_pos, delta);
  o.off_sym = __shfl_up_sync(full, r.off_sym, delta);
  o.off_pos = __shfl_up_sync(full, r.off_pos, delta);
  o.ampk = __shfl_up_sync(full, r.ampk, delta);
  o.ampv = __shfl_up_sync(full, r.ampv, delta);
  o.ampp = __shfl_up_sync(full, r.ampp, delta);
  return o;
}

__device__ __forceinline__ Pair shfl_up_pair(const Pair& r, int delta) {
  Pair o;
  o.m[0] = shfl_up_rec(r.m[0], delta);
  o.m[1] = shfl_up_rec(r.m[1], delta);
  return o;
}

// inclusive in-order scan across the 32 lanes of a warp
__device__ __forceinline__ Pair warp_scan(Pair v, int lane, const Params& p) {
  for (int d = 1; d < 32; d <<= 1) {
    Pair up = shfl_up_pair(v, d);
    if (lane >= d) v = compose(up, v, p);
  }
  return v;
}

struct Entry {
  int mode, on, off;
  float amp;
};

// the concrete exit state of a lane prefix entered with state E
__device__ __forceinline__ Entry apply_entry(const Pair& pre, const Entry& E, const Params& p) {
  const Rec& s = E.mode ? pre.m[1] : pre.m[0];
  Entry o;
  o.mode = s.mode;
  o.on = s.on_sym ? E.on : s.on_pos;
  o.off = s.off_sym ? E.off : s.off_pos;
  o.amp = s.ampk == kConc ? s.ampv
        : (s.ampk == kEntry ? E.amp : amp_on_at(s.ampp, E.on, p));
  return o;
}

__global__ void __launch_bounds__(kLanes)
envelope_kernel(const float* __restrict__ x, float* __restrict__ out, int S, int C,
                const float* __restrict__ attack, const float* __restrict__ decay,
                const float* __restrict__ sustain, const float* __restrict__ release,
                float msps,
                const uint8_t* __restrict__ mode_in, const int* __restrict__ on_in,
                const int* __restrict__ off_in, const float* __restrict__ amp_in,
                uint8_t* __restrict__ mode_out, int* __restrict__ on_out,
                int* __restrict__ off_out, float* __restrict__ amp_out) {
  __shared__ Pair warp_tot[kWarps];
  __shared__ Entry exits[kLanes];

  const int k = threadIdx.x;
  const int lane = k & 31;
  const int warp = k >> 5;
  const Params p{*attack, *decay, *sustain, *release, msps};
  const int base = k * C;

  // ---- phase A: both entry machines, symbolically ------------------------
  Pair rec = identity_pair();
  for (int c = 0; c < C; ++c) {
    const int t = base + c;
    const float xc = t < S ? x[t] : 0.5f;
    for (int e = 0; e < 2; ++e) {
      Rec& r = rec.m[e];
      const bool rising = r.mode == 0 && xc == 1.0f;
      const bool falling = r.mode == 1 && xc == 0.0f;
      if (falling) {
        if (r.on_sym == 0) {
          r.ampk = kConc;
          r.ampv = amp_on_at(t, r.on_pos, p);
        } else {
          r.ampk = kOn;
          r.ampp = t;
        }
        r.mode = 0;
        r.off_sym = 0;
        r.off_pos = t;
      } else if (rising) {
        r.mode = 1;
        r.on_sym = 0;
        r.on_pos = t;
      }
    }
  }

  // ---- combine: in-order scan over the lanes ------------------------------
  Pair pre = warp_scan(rec, lane, p);
  if (lane == 31) warp_tot[warp] = pre;
  __syncthreads();
  if (warp == 0) {
    Pair w = warp_scan(warp_tot[lane], lane, p);
    warp_tot[lane] = w;  // inclusive prefix over warps 0..lane
  }
  __syncthreads();
  if (warp > 0) pre = compose(warp_tot[warp - 1], pre, p);

  // entry of lane k = exit of lane k-1; lane 0 enters with the block state
  const Entry E0{static_cast<int>(*mode_in != 0), *on_in, *off_in, *amp_in};
  exits[k] = apply_entry(pre, E0, p);
  __syncthreads();
  Entry st = k == 0 ? E0 : exits[k - 1];

  if (k == kLanes - 1) {
    const Entry& ex = exits[kLanes - 1];
    *mode_out = static_cast<uint8_t>(ex.mode != 0);
    *on_out = max(ex.on - S, kPosFloor);
    *off_out = max(ex.off - S, kPosFloor);
    *amp_out = ex.amp;
  }

  // ---- phase B: concrete outputs -----------------------------------------
  for (int c = 0; c < C; ++c) {
    const int t = base + c;
    if (t >= S) break;  // only pads remain in this lane
    const float xc = x[t];
    const bool rising = st.mode == 0 && xc == 1.0f;
    const bool falling = st.mode == 1 && xc == 0.0f;
    if (falling) {
      st.amp = amp_on_at(t, st.on, p);
      st.mode = 0;
      st.off = t;
    } else if (rising) {
      st.mode = 1;
      st.on = t;
    }
    float y;
    if (st.mode == 1) {
      y = amp_on_at(t, st.on, p);
    } else {
      const float ms_off = static_cast<float>(sub_wrap(t, st.off)) * p.msps;
      y = st.amp * (1.0f - clip01(ms_off / p.release));
    }
    out[t] = y;
  }
}

}  // namespace

extern "C" {

// One envelope block of S samples (1 <= S).  All pointers are device
// pointers; the state and params are 0-d tensors; the launch goes to card
// `device`.  Returns cudaGetLastError() after the launch (0 = cudaSuccess).
int mixlab_envelope_block(const float* x, float* out, int S,
                          const float* attack, const float* decay,
                          const float* sustain, const float* release, float msps,
                          const uint8_t* mode_in, const int* on_in, const int* off_in,
                          const float* amp_in, uint8_t* mode_out, int* on_out,
                          int* off_out, float* amp_out, int device, void* stream) {
  OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  const int C = (S + kLanes - 1) / kLanes;
  envelope_kernel<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, S, C, attack, decay, sustain, release, msps, mode_in, on_in, off_in,
      amp_in, mode_out, on_out, off_out, amp_out);
  return static_cast<int>(cudaGetLastError());
}

const char* mixlab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
