// ADSR envelope over one block, spread over the card's SMs: one cooperative
// launch of G CTAs, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mixlab_tpu/dsp/envelope_pallas.py
// (envelope_block_pallas / _env_body), which evaluates the reference's
// per-sample gate state machine (src/module/envelope.rs:34-117) as
//   phase A  - every lane walks its chunk of C samples twice, once per
//              possible entry mode, building a symbolic transfer record;
//   combine  - an in-order scan composes the lane records;
//   phase B  - every lane, now knowing its entry state, emits its samples.
//
// Layout: a tile of T = 256 * C consecutive samples per CTA, G = ceil(S / T)
// CTAs; thread k of a CTA owns the tile's samples [k*C, k*C + C).  C is 2
// (T = 512: G = 87 at S = 44,100, 94 at 48,000) while the G tiles fit on
// the card at once, else the shortest lane that fits (at most 16; the
// wrapper's tile_plan).  Samples past S read the pad value 0.5, which is
// neither a gate-on (1.0) nor a gate-off (0.0) and so leaves every machine
// unchanged.
//
// What bounds it on the card: latency, not bytes (a 44,100-sample block is
// 353 KB in and out, 0.105 us at 3.35 TB/s) or operations.  Before, one CTA
// of 1,024 threads walked 2 x 44 dependent global loads per thread on one
// of 132 SMs (76 us per launch).  Now every CTA
//   * stages its tile once, coalesced, in shared memory (lane k's samples
//     at k*(C|1): an odd stride, so a warp's lanes hit distinct banks), and
//     walks phase A and B there, 2 x C steps per thread;
//   * composes its lane records by a warp-shuffle scan and a scan of the 8
//     warp totals, and publishes the tile's aggregate record to a global
//     scratch [G] that the wrapper allocates;
//   * after one grid-wide barrier (the launch is cooperative, so all G
//     CTAs are resident) scans the aggregates of the tiles before it, in
//     tile order, to get its entry state;
//   * writes its outputs into shared memory and stores the tile coalesced.
// What remains is the launch, one grid barrier and two block scans of the
// 16-word record pair.  No register cap: 256 threads a CTA leave each
// thread up to 255 registers, so the record pair and its shuffled copy stay
// in registers (ptxas reports the spill bytes in the build log).
//
// Over a batch (what jax.vmap(envelope_block_pallas) computes: B blocks of
// S samples, each with its own state and params, read from [B] arrays), ONE
// launch in one of two forms (envelope_cuda.batch_plan): the cooperative
// grid above with gridDim.y = B where the B x G tiles fit on the card at
// once, else one CTA a block (envelope_seq_kernel) that walks its block in
// tiles of 256 * C samples, running phase A, the block scan and phase B on
// each and carrying the exit state from tile to tile: no grid barrier, any
// B.  Batched, the kernel moves 8 bytes a sample (x in, out written) and
// is bandwidth-bound at large B.
//
// Exactness: composition is associative, and every f32 written is computed
// from concrete int positions by the same expressions (the library is built
// with -fmad=false), so regrouping the scan by tiles changes no output bit.
//
// Semantics kept from the reference and the TPU kernel:
//   * exact `== 1.0f` (rising) and `== 0.0f` (falling) gate tests;
//   * positions are int32 sample offsets relative to the block start; the
//     int subtraction happens before the f32 conversion;
//   * exits are rebased by -S and clamped at POS_FLOOR;
//   * amp_on follows envelope.rs:37-51 including division by zero
//     (attack_ms == 0) and NaN propagation through the clip (no fast math).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "on_device.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLane = 16;           // samples per thread (tile 4,096)
constexpr int kMaxTiles = kThreads;    // one tile aggregate per thread of the tile scan
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

struct __align__(16) Pair {
  Rec m[2];  // m[e] = the lane's record when it is entered in mode e
};
static_assert(sizeof(Pair) == 64, "the wrapper's tile scratch holds 16 words a tile");

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
#pragma unroll
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

// m[1] if `second`, else m[0], field by field: a select of the record's
// address would put the pair in local memory
__device__ __forceinline__ Rec pick_rec(const Pair& r, int second) {
  const Rec& a = r.m[0];
  const Rec& b = r.m[1];
  return Rec{second ? b.mode : a.mode,       second ? b.on_sym : a.on_sym,
             second ? b.on_pos : a.on_pos,   second ? b.off_sym : a.off_sym,
             second ? b.off_pos : a.off_pos, second ? b.ampk : a.ampk,
             second ? b.ampv : a.ampv,       second ? b.ampp : a.ampp};
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
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const Rec& fe = f.m[e];
    r.m[e] = substitute(pick_rec(g, fe.mode), fe, p);
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

// a record written by another CTA before the grid barrier: four 16-byte
// loads through L2 (never a line this SM's L1 may hold)
__device__ __forceinline__ Rec rec_from(int4 a, int4 b) {
  return Rec{a.x, a.y, a.z, a.w, b.x, b.y, __int_as_float(b.z), b.w};
}

__device__ __forceinline__ Pair load_pair_cg(const Pair* src) {
  const int4* v = reinterpret_cast<const int4*>(src);
  Pair r;
  r.m[0] = rec_from(__ldcg(v), __ldcg(v + 1));
  r.m[1] = rec_from(__ldcg(v + 2), __ldcg(v + 3));
  return r;
}

// inclusive in-order scan across the first kWidth lanes of a warp
template <int kWidth>
__device__ __forceinline__ Pair warp_scan(Pair v, int lane, const Params& p) {
#pragma unroll
  for (int d = 1; d < kWidth; d <<= 1) {
    Pair up = shfl_up_pair(v, d);
    if (lane >= d) v = compose(up, v, p);
  }
  return v;
}

// inclusive in-order scan across the CTA's threads; every thread calls it
__device__ __forceinline__ Pair block_scan(Pair v, Pair* warp_tot, const Params& p) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_scan<32>(v, lane, p);
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const Pair w = warp_scan<kWarps>(warp_tot[lane % kWarps], lane, p);
    if (lane < kWarps) warp_tot[lane] = w;  // inclusive prefix over warps 0..lane
  }
  __syncthreads();
  if (warp > 0) v = compose(warp_tot[warp - 1], v, p);
  __syncthreads();  // warp_tot is free for the next scan
  return v;
}

struct Entry {
  int mode, on, off;
  float amp;
};

// the concrete exit state of a lane prefix entered with state E
__device__ __forceinline__ Entry apply_entry(const Pair& pre, const Entry& E, const Params& p) {
  const Rec s = pick_rec(pre, E.mode);
  Entry o;
  o.mode = s.mode;
  o.on = s.on_sym ? E.on : s.on_pos;
  o.off = s.off_sym ? E.off : s.off_pos;
  o.amp = s.ampk == kConc ? s.ampv
        : (s.ampk == kEntry ? E.amp : amp_on_at(s.ampp, E.on, p));
  return o;
}

// Phase A over a lane's C staged samples (block positions base..): both
// entry machines' symbolic records
__device__ __forceinline__ Pair phase_a(const float* mine, int base, int C, const Params& p) {
  Pair rec = identity_pair();
  for (int c = 0; c < C; ++c) {
    const int t = base + c;
    const float xc = mine[c];
#pragma unroll
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
  return rec;
}

// Phase B: the lane's outputs from its entry state st, in place of its
// staged inputs; stops at sample S (only pads remain past it)
__device__ __forceinline__ void phase_b(float* mine, int base, int C, int S, Entry st,
                                        const Params& p) {
  for (int c = 0; c < C; ++c) {
    const int t = base + c;
    if (t >= S) break;
    const float xc = mine[c];
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
    mine[c] = y;
  }
}

__global__ void __launch_bounds__(kThreads)
envelope_kernel(const float* __restrict__ x, float* __restrict__ out, int S, int C,
                Pair* __restrict__ tiles,
                const float* __restrict__ attack, const float* __restrict__ decay,
                const float* __restrict__ sustain, const float* __restrict__ release,
                float msps,
                const uint8_t* __restrict__ mode_in, const int* __restrict__ on_in,
                const int* __restrict__ off_in, const float* __restrict__ amp_in,
                uint8_t* __restrict__ mode_out, int* __restrict__ on_out,
                int* __restrict__ off_out, float* __restrict__ amp_out) {
  extern __shared__ float xs[];  // [kThreads][C | 1]: lane k's samples at k * (C | 1)
  __shared__ Pair warp_tot[kWarps];
  __shared__ Entry exits[kThreads];
  __shared__ Entry tile_entry;

  const int k = threadIdx.x;
  const int stride = C | 1;
  const int T = kThreads * C;
  const int tile0 = blockIdx.x * T;
  // block blockIdx.y of the batch: its samples, tiles, params and state
  const size_t seq = blockIdx.y;
  x += seq * S, out += seq * S, tiles += seq * gridDim.x;
  const Params p{attack[seq], decay[seq], sustain[seq], release[seq], msps};
  const Entry E0{static_cast<int>(mode_in[seq] != 0), on_in[seq], off_in[seq], amp_in[seq]};

  // ---- stage the tile, coalesced ------------------------------------------
  for (int j = k; j < T; j += kThreads) {
    const int t = tile0 + j;
    xs[(j / C) * stride + j % C] = t < S ? __ldg(x + t) : 0.5f;
  }
  __syncthreads();
  float* mine = xs + k * stride;
  const int base = tile0 + k * C;

  // ---- phase A: both entry machines, symbolically ------------------------
  const Pair rec = phase_a(mine, base, C, p);

  // ---- combine: lanes within the tile, then the tiles before it ----------
  const Pair pre = block_scan(rec, warp_tot, p);
  if (k == kThreads - 1) tiles[blockIdx.x] = pre;  // the tile's aggregate
  cg::this_grid().sync();

  if (blockIdx.x == 0) {
    if (k == 0) tile_entry = E0;
  } else {  // uniform over the CTA: every thread takes the scan's barriers
    const Pair v = block_scan(
        k < static_cast<int>(blockIdx.x) ? load_pair_cg(tiles + k) : identity_pair(), warp_tot, p);
    if (k == static_cast<int>(blockIdx.x) - 1) tile_entry = apply_entry(v, E0, p);
  }
  __syncthreads();
  exits[k] = apply_entry(pre, tile_entry, p);
  __syncthreads();
  Entry st = k == 0 ? tile_entry : exits[k - 1];

  if (blockIdx.x == gridDim.x - 1 && k == kThreads - 1) {
    const Entry& ex = exits[kThreads - 1];  // lanes past S only read pads
    mode_out[seq] = static_cast<uint8_t>(ex.mode != 0);
    on_out[seq] = max(ex.on - S, kPosFloor);
    off_out[seq] = max(ex.off - S, kPosFloor);
    amp_out[seq] = ex.amp;
  }

  // ---- phase B: concrete outputs, in place of the lane's inputs ----------
  phase_b(mine, base, C, S, st, p);
  __syncthreads();
  for (int j = k; j < T; j += kThreads) {
    const int t = tile0 + j;
    if (t < S) out[t] = xs[(j / C) * stride + j % C];
  }
}

// One block of the batch a CTA (blockIdx.x), walked in tiles of 256 * C
// samples with the exit state carried from tile to tile in `carry`.
__global__ void __launch_bounds__(kThreads)
envelope_seq_kernel(const float* __restrict__ x, float* __restrict__ out, int S, int C,
                    const float* __restrict__ attack, const float* __restrict__ decay,
                    const float* __restrict__ sustain, const float* __restrict__ release,
                    float msps,
                    const uint8_t* __restrict__ mode_in, const int* __restrict__ on_in,
                    const int* __restrict__ off_in, const float* __restrict__ amp_in,
                    uint8_t* __restrict__ mode_out, int* __restrict__ on_out,
                    int* __restrict__ off_out, float* __restrict__ amp_out) {
  extern __shared__ float xs[];
  __shared__ Pair warp_tot[kWarps];
  __shared__ Entry exits[kThreads];
  __shared__ Entry carry;

  const int k = threadIdx.x;
  const int stride = C | 1;
  const int T = kThreads * C;
  const size_t seq = blockIdx.x;
  x += seq * S, out += seq * S;
  const Params p{attack[seq], decay[seq], sustain[seq], release[seq], msps};
  if (k == 0) {
    carry = Entry{static_cast<int>(mode_in[seq] != 0), on_in[seq], off_in[seq], amp_in[seq]};
  }
  float* mine = xs + k * stride;

  for (int tile0 = 0; tile0 < S; tile0 += T) {
    for (int j = k; j < T; j += kThreads) {
      const int t = tile0 + j;
      xs[(j / C) * stride + j % C] = t < S ? __ldg(x + t) : 0.5f;
    }
    __syncthreads();
    const int base = tile0 + k * C;

    // phase A: both entry machines, symbolically
    const Pair rec = phase_a(mine, base, C, p);

    // the lanes' prefixes within the tile, entered with the carried state
    const Pair pre = block_scan(rec, warp_tot, p);
    exits[k] = apply_entry(pre, carry, p);
    __syncthreads();
    Entry st = k == 0 ? carry : exits[k - 1];

    // phase B: concrete outputs, in place of the lane's inputs
    phase_b(mine, base, C, S, st, p);
    __syncthreads();  // every thread has read carry and written its outputs
    if (k == 0) carry = exits[kThreads - 1];  // lanes past S only read pads
    for (int j = k; j < T; j += kThreads) {
      const int t = tile0 + j;
      if (t < S) out[t] = xs[(j / C) * stride + j % C];
    }
    __syncthreads();  // xs, exits and carry are free for the next tile
  }
  if (k == 0) {
    mode_out[seq] = static_cast<uint8_t>(carry.mode != 0);
    on_out[seq] = max(carry.on - S, kPosFloor);
    off_out[seq] = max(carry.off - S, kPosFloor);
    amp_out[seq] = carry.amp;
  }
}

size_t shared_bytes(int C) { return static_cast<size_t>(kThreads) * (C | 1) * sizeof(float); }

}  // namespace

extern "C" {

// CTAs of the envelope kernel that one card holds at once at the longest
// lane, into *resident; the wrapper sizes its tiles by it.  Returns a
// cudaError_t (0 = cudaSuccess).
int mixlab_envelope_resident_tiles(int device, int* resident) {
  int n_sm = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    OnDevice on(device);
    err = on.error();
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, envelope_kernel, kThreads,
                                                          shared_bytes(kMaxLane));
    }
  }
  *resident = per_sm * n_sm;
  return static_cast<int>(err);
}

// The envelope over `batch` blocks of S samples (1 <= S): x, out
// [batch][S]; the params attack..release and the state in and out are
// [batch] arrays (bool state as one byte).  With seq == 0 a cooperative grid
// of `tiles` x `batch` CTAs of 256 * C samples (1 <= C <= 16,
// 1 <= tiles <= 256, the last tile of a block holding sample S-1; the tile
// scratch holds `tiles` x `batch` records of 64 bytes); with seq == 1 one
// CTA a block walking tiles of 256 * C samples, `tiles` and the scratch
// unused.  All pointers are device pointers; the launch goes to card
// `device`.  Returns the launch's cudaError_t (0 = cudaSuccess); a
// cooperative grid larger than the card holds at once is refused by the
// launch.
int mixlab_envelope_block(const float* x, float* out, int S, int batch, int seq, int C,
                          int tiles, void* scratch, const float* attack, const float* decay,
                          const float* sustain, const float* release, float msps,
                          const uint8_t* mode_in, const int* on_in, const int* off_in,
                          const float* amp_in, uint8_t* mode_out, int* on_out,
                          int* off_out, float* amp_out, int device, void* stream) {
  if (S < 1 || batch < 1 || C < 1 || C > kMaxLane ||
      (!seq && (tiles < 1 || tiles > kMaxTiles || batch > 65535 ||
                static_cast<long long>(tiles) * kThreads * C < S ||
                static_cast<long long>(tiles - 1) * kThreads * C >= S))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (seq) {
    envelope_seq_kernel<<<batch, kThreads, shared_bytes(C), st>>>(
        x, out, S, C, attack, decay, sustain, release, msps, mode_in, on_in, off_in, amp_in,
        mode_out, on_out, off_out, amp_out);
    return static_cast<int>(cudaGetLastError());
  }
  Pair* tile_recs = static_cast<Pair*>(scratch);
  void* args[] = {&x, &out, &S, &C, &tile_recs, &attack, &decay, &sustain, &release, &msps,
                  &mode_in, &on_in, &off_in, &amp_in, &mode_out, &on_out, &off_out, &amp_out};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(envelope_kernel), dim3(tiles, batch), dim3(kThreads), args,
      shared_bytes(C), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* mixlab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
