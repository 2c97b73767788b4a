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
// launch in one of three forms (envelope_cuda.batch_plan): the cooperative
// grid above with gridDim.y = B where the B x G tiles fit on the card at
// once; else the rows forms of csrc/rows.cuh, tiles of 256 * C samples (C 16
// or 32) staged by cp.async a tile ahead, phase A, the block scan and phase B
// on each: one CTA a block carrying the exit state from tile to tile
// (envelope_rows_kernel), or, where that leaves most of the card idle (a few
// long blocks), the decoupled look-back (envelope_lookback_kernel), whose
// tiles fold the aggregates of the tiles before them onto the nearest
// inclusive state, concretely (apply_rec), as phase B does lane by lane.
// Batched, the kernel moves 8 bytes a sample (x in, out written); at the
// fleet's shapes it reaches about a third of that bound (PERF.md §6,
// the bring-up table): phase A runs two machines a sample, phase B divides two or
// three times a sample in IEEE f32, and every tile pays two block scans of
// the 16-word record pair, so the issue slots, not the bytes, hold it.

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
#include "rows.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLane = 16;           // samples per thread (tile 4,096)
// the batched rows forms: samples a thread at most (tile 8,192), and CTAs an
// SM asked of the compiler (64 registers a thread; the rows sweep in
// PERF.md §6)
constexpr int kMaxRowsLane = 32;
constexpr int kRowsMinBlocks = 4;
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

// the concrete exit state of a span whose record for E's mode is s, entered
// with state E
__device__ __forceinline__ Entry apply_rec(const Rec& s, const Entry& E, const Params& p) {
  Entry o;
  o.mode = s.mode;
  o.on = s.on_sym ? E.on : s.on_pos;
  o.off = s.off_sym ? E.off : s.off_pos;
  o.amp = s.ampk == kConc ? s.ampv
        : (s.ampk == kEntry ? E.amp : amp_on_at(s.ampp, E.on, p));
  return o;
}

// the concrete exit state of a lane prefix entered with state E
__device__ __forceinline__ Entry apply_entry(const Pair& pre, const Entry& E, const Params& p) {
  return apply_rec(pick_rec(pre, E.mode), E, p);
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

// ---- the batched rows forms (csrc/rows.cuh) --------------------------------
// A tile is 256 * C samples (C = 2^lg); its aggregate is the tile's lane
// records composed, its carry the concrete state before it.

struct RowsArgs {
  const float* x;
  float* out;
  int S, lg, tiles, batch;
  const float *attack, *decay, *sustain, *release;
  float msps;
  const uint8_t* mode_in;
  const int *on_in, *off_in;
  const float* amp_in;
  uint8_t* mode_out;
  int *on_out, *off_out;
  float* amp_out;
  unsigned* tickets;  // the look-back form's header (rows::kHeader), then its status array
};

// one tile's record in the look-back form's status array
struct __align__(16) Status {
  Pair agg;       // the tile's lane records composed (both entry modes)
  Entry incl;     // the state after the tile (at rows::kInclusive)
  unsigned flag;  // rows::tag(launch number, state)
  unsigned pad[3];
};
static_assert(sizeof(Status) == 96, "envelope_cuda.STATUS_BYTES");

__device__ __forceinline__ Params row_params(const RowsArgs& a, int row) {
  return Params{a.attack[row], a.decay[row], a.sustain[row], a.release[row], a.msps};
}

__device__ __forceinline__ Entry row_state(const RowsArgs& a, int row) {
  return Entry{static_cast<int>(a.mode_in[row] != 0), a.on_in[row], a.off_in[row], a.amp_in[row]};
}

__device__ __forceinline__ void write_state(const RowsArgs& a, int row, const Entry& ex) {
  a.mode_out[row] = static_cast<uint8_t>(ex.mode != 0);
  a.on_out[row] = max(ex.on - a.S, kPosFloor);
  a.off_out[row] = max(ex.off - a.S, kPosFloor);
  a.amp_out[row] = ex.amp;
}

// Copy the tile at tile0 of a row into xs at the lanes' odd stride, one
// cp.async of 4 bytes a sample (coalesced reads), the pad past S stored
// directly; one commit group.
__device__ __forceinline__ void stage_rows(float* xs, const float* x, int tile0, int S, int lg) {
  const int T = kThreads << lg, mask = (1 << lg) - 1, stride = (1 << lg) | 1;
  for (int j = threadIdx.x; j < T; j += kThreads) {
    float* d = xs + (j >> lg) * stride + (j & mask);
    if (tile0 + j < S) {
      rows::cp_async4(d, x + tile0 + j);
    } else {
      *d = 0.5f;
    }
  }
  rows::cp_async_commit();
}

// The staged tile's outputs from its entry state (shared: written before a
// barrier the caller took) and the lanes' prefixes, stored coalesced;
// exits[kThreads - 1] is then the state after the tile.
__device__ __forceinline__ void finish_tile(float* xs, const Pair& pre, const Entry& entry,
                                            Entry* exits, int tile0, int lg, const Params& p,
                                            int S, float* out) {
  const int k = threadIdx.x, C = 1 << lg, stride = C | 1;
  exits[k] = apply_entry(pre, entry, p);
  __syncthreads();
  const Entry st = k == 0 ? entry : exits[k - 1];
  phase_b(xs + k * stride, tile0 + k * C, C, S, st, p);
  __syncthreads();
  const int T = kThreads << lg;
  for (int j = k; j < T; j += kThreads) {
    if (tile0 + j < S) out[tile0 + j] = xs[(j >> lg) * stride + (j & (C - 1))];
  }
}

// One CTA a block (blockIdx.x): its tiles in order, the carry in shared
// memory, the next tile staged while this one runs.
__global__ void __launch_bounds__(kThreads, kRowsMinBlocks) envelope_rows_kernel(RowsArgs a) {
  extern __shared__ float xs[];  // two staged tiles
  __shared__ Pair warp_tot[kWarps];
  __shared__ Entry exits[kThreads];
  __shared__ Entry carry[2];  // the state before the tile, by its parity

  const int k = threadIdx.x, S = a.S, lg = a.lg, row = blockIdx.x;
  const int T = kThreads << lg, buf = kThreads * ((1 << lg) | 1);
  const float* x = a.x + static_cast<size_t>(row) * S;
  float* out = a.out + static_cast<size_t>(row) * S;
  const Params p = row_params(a, row);
  if (k == 0) carry[0] = row_state(a, row);
  stage_rows(xs, x, 0, S, lg);
  for (int t = 0; t < a.tiles; ++t) {
    float* cur = xs + (t & 1) * buf;
    if (t + 1 < a.tiles) {
      stage_rows(xs + ((t + 1) & 1) * buf, x, (t + 1) * T, S, lg);
    } else {
      rows::cp_async_commit();
    }
    rows::cp_async_wait<1>();
    __syncthreads();
    const Pair pre = block_scan(phase_a(cur + k * ((1 << lg) | 1), t * T + (k << lg), 1 << lg, p),
                                warp_tot, p);
    finish_tile(cur, pre, carry[t & 1], exits, t * T, lg, p, S, out);
    if (k == kThreads - 1) {  // lanes past S only read pads
      carry[(t + 1) & 1] = exits[kThreads - 1];
      if (t == a.tiles - 1) write_state(a, row, exits[kThreads - 1]);
    }
    __syncthreads();  // cur and exits are free again
  }
}

// The entry state of tile `tile` of a row (warp 0; every lane returns it):
// the nearest earlier tile with its inclusive state (before tile 0: the
// row's state E0), then the aggregates of the tiles after it, in order.
__device__ __forceinline__ Entry look_back(const Status* srow, int tile, const Entry& E0,
                                           unsigned seq, const Params& p) {
  const int lane = threadIdx.x & 31;
  const int idx = tile - 32 + lane;  // lane 31: the tile before
  const unsigned fa = rows::tag(seq, rows::kAggregate), fp = rows::tag(seq, rows::kInclusive);
  int pl = 0;
  for (;;) {
    const unsigned f = idx < 0 ? fp : rows::load_relaxed(&srow[idx].flag);
    const unsigned pm = __ballot_sync(0xffffffffu, f == fp);
    const unsigned rm = __ballot_sync(0xffffffffu, f == fp || f == fa);
    if (pm) {
      pl = 31 - __clz(pm);
      const unsigned after = pl == 31 ? 0u : 0xffffffffu << (pl + 1);
      if ((rm & after) == after) break;
    }
    __nanosleep(64);
  }
  __threadfence();  // the records read below were written before their flags
  Entry e = E0;
  if (lane == pl && idx >= 0) {
    const int4 v = __ldcg(reinterpret_cast<const int4*>(&srow[idx].incl));
    e = Entry{v.x, v.y, v.z, __int_as_float(v.w)};
  }
  e.mode = __shfl_sync(0xffffffffu, e.mode, pl);
  e.on = __shfl_sync(0xffffffffu, e.on, pl);
  e.off = __shfl_sync(0xffffffffu, e.off, pl);
  e.amp = __shfl_sync(0xffffffffu, e.amp, pl);
  const Pair v = lane > pl ? load_pair_cg(&srow[idx].agg) : identity_pair();
  for (int j = pl + 1; j < 32; ++j) {
    const Rec mine = pick_rec(v, e.mode);  // e is the same in every lane
    Rec r;
    r.mode = __shfl_sync(0xffffffffu, mine.mode, j);
    r.on_sym = __shfl_sync(0xffffffffu, mine.on_sym, j);
    r.on_pos = __shfl_sync(0xffffffffu, mine.on_pos, j);
    r.off_sym = __shfl_sync(0xffffffffu, mine.off_sym, j);
    r.off_pos = __shfl_sync(0xffffffffu, mine.off_pos, j);
    r.ampk = __shfl_sync(0xffffffffu, mine.ampk, j);
    r.ampv = __shfl_sync(0xffffffffu, mine.ampv, j);
    r.ampp = __shfl_sync(0xffffffffu, mine.ampp, j);
    e = apply_rec(r, e, p);
  }
  return e;
}

// The look-back form: as many CTAs as the card holds, each taking tiles by
// ticket (row-major) and staging its next ticket's tile while it runs this
// one.
__global__ void __launch_bounds__(kThreads, kRowsMinBlocks)
envelope_lookback_kernel(RowsArgs a) {
  extern __shared__ float xs[];
  __shared__ Pair warp_tot[kWarps];
  __shared__ Entry exits[kThreads];
  __shared__ Entry tile_entry;
  __shared__ Pair agg;
  __shared__ unsigned ticket[2], launch;

  const int k = threadIdx.x, S = a.S, lg = a.lg, T = kThreads << lg;
  const int buf = kThreads * ((1 << lg) | 1);
  const unsigned total = static_cast<unsigned>(a.batch) * static_cast<unsigned>(a.tiles);
  Status* status = reinterpret_cast<Status*>(a.tickets + rows::kHeader);
  auto stage_ticket = [&](unsigned t, float* dst) {
    if (t < total) {
      const int row = static_cast<int>(t / a.tiles), tile = static_cast<int>(t % a.tiles);
      stage_rows(dst, a.x + static_cast<size_t>(row) * S, tile * T, S, lg);
    } else {
      rows::cp_async_commit();
    }
  };
  if (k == 0) {
    launch = rows::launch_number(a.tickets);
    ticket[0] = rows::take_ticket(a.tickets);
  }
  __syncthreads();
  const unsigned seq = launch;
  stage_ticket(ticket[0], xs);
  for (int i = 0;; ++i) {
    const unsigned t = ticket[i & 1];
    if (t >= total) break;
    if (k == 0) ticket[(i + 1) & 1] = rows::take_ticket(a.tickets);
    __syncthreads();
    stage_ticket(ticket[(i + 1) & 1], xs + ((i + 1) & 1) * buf);
    rows::cp_async_wait<1>();
    __syncthreads();
    const int row = static_cast<int>(t / a.tiles), tile = static_cast<int>(t % a.tiles);
    const Params p = row_params(a, row);
    float* cur = xs + (i & 1) * buf;
    const Pair rec = phase_a(cur + k * ((1 << lg) | 1), tile * T + (k << lg), 1 << lg, p);
    const Pair pre = block_scan(rec, warp_tot, p);
    Status* st = status + t;
    if (k == kThreads - 1) {  // the aggregate first: later tiles need it, not the state
      agg = pre;
      st->agg = pre;
      rows::store_release(&st->flag, rows::tag(seq, rows::kAggregate));
    }
    __syncthreads();
    if (k < 32) {
      const Entry e = look_back(status + static_cast<size_t>(row) * a.tiles, tile,
                                row_state(a, row), seq, p);
      if (k == 0) {
        tile_entry = e;
        st->incl = apply_entry(agg, e, p);
        rows::store_release(&st->flag, rows::tag(seq, rows::kInclusive));
      }
    }
    __syncthreads();
    finish_tile(cur, pre, tile_entry, exits, tile * T, lg, p, S,
                a.out + static_cast<size_t>(row) * S);
    if (tile == a.tiles - 1 && k == kThreads - 1) write_state(a, row, exits[kThreads - 1]);
    __syncthreads();  // cur, exits, agg and tile_entry are free again
  }
  if (k == 0) rows::leave(a.tickets, seq);
}

size_t rows_shared_bytes(int lg) {
  return 2 * static_cast<size_t>(kThreads) * ((1 << lg) | 1) * sizeof(float);
}

size_t shared_bytes(int C) { return static_cast<size_t>(kThreads) * (C | 1) * sizeof(float); }

// the rows forms' dynamic shared memory past 48 KB (the longest lane), once
// a card (the card current in the caller)
cudaError_t allow_rows(int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const int bytes = static_cast<int>(rows_shared_bytes(5));
  static_assert(kMaxRowsLane == 1 << 5, "rows_shared_bytes of the longest lane");
  cudaError_t err = cudaFuncSetAttribute(envelope_rows_kernel, attr, bytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(envelope_lookback_kernel, attr, bytes);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

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

// CTAs of a batched rows form (form 1: one CTA a block; form 2: the
// look-back) at lanes of 2^lg samples that one card holds at once, into
// *resident.
int mixlab_envelope_rows_resident(int form, int lg, int device, int* resident) {
  *resident = 0;
  if (lg < 0 || (1 << lg) > kMaxRowsLane || (form != 1 && form != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OnDevice on(device);
  cudaError_t err = on.error();
  if (err == cudaSuccess) err = allow_rows(device);
  int n_sm = 0, per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, form == 1 ? envelope_rows_kernel : envelope_lookback_kernel, kThreads,
        rows_shared_bytes(lg));
  }
  *resident = per_sm * n_sm;
  return static_cast<int>(err);
}

// The envelope over `batch` blocks of S samples (1 <= S): x, out
// [batch][S]; the params attack..release and the state in and out are
// [batch] arrays (bool state as one byte).  `form` 0: a cooperative grid of
// `tiles` x `batch` CTAs of 256 * C samples (1 <= C <= 16, 1 <= tiles <=
// 256, the last tile of a block holding sample S-1; `scratch` holds `tiles`
// x `batch` records of 64 bytes).  Form 1: one CTA a block, `tiles` tiles of
// 256 * C samples a block (C a power of two up to 32), the next one staged.
// Form 2: the look-back over `ctas` CTAs, `tiles` tiles of 256 * C samples a
// block; `scratch` holds the header of csrc/rows.cuh (16 bytes, the
// launch's number among them) and `batch` x `tiles` status records of 96
// bytes, zeroed once when the wrapper made it and never by a launch.  All
// pointers are device pointers; the launch
// goes to card `device`.  Returns the launch's cudaError_t (0 =
// cudaSuccess); a cooperative grid larger than the card holds at once is
// refused by the launch.
int mixlab_envelope_block(const float* x, float* out, int S, int batch, int form, int C,
                          int tiles, int ctas, void* scratch, const float* attack,
                          const float* decay, const float* sustain, const float* release,
                          float msps, const uint8_t* mode_in, const int* on_in,
                          const int* off_in, const float* amp_in, uint8_t* mode_out,
                          int* on_out, int* off_out, float* amp_out, int device, void* stream) {
  int lg = 0;
  while ((1 << lg) < C) ++lg;
  const bool rows_form = form == 1 || form == 2;
  if (S < 1 || batch < 1 || C < 1 || C > (rows_form ? kMaxRowsLane : kMaxLane) || form < 0 ||
      form > 2 ||
      (form == 0 && (tiles < 1 || tiles > kMaxTiles || batch > 65535 ||
                     static_cast<long long>(tiles) * kThreads * C < S ||
                     static_cast<long long>(tiles - 1) * kThreads * C >= S)) ||
      (rows_form && ((1 << lg) != C ||
                     tiles != (S + (kThreads << lg) - 1) / (kThreads << lg) ||
                     static_cast<long long>(batch) * tiles > 0x7fffffffLL)) ||
      (form == 2 && (ctas < 1 || scratch == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_form) {
    const cudaError_t err = allow_rows(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const RowsArgs a{x, out, S, lg, tiles, batch, attack, decay, sustain, release, msps,
                     mode_in, on_in, off_in, amp_in, mode_out, on_out, off_out, amp_out,
                     static_cast<unsigned*>(scratch)};
    if (form == 1) {
      envelope_rows_kernel<<<batch, kThreads, rows_shared_bytes(lg), st>>>(a);
    } else {
      envelope_lookback_kernel<<<ctas, kThreads, rows_shared_bytes(lg), st>>>(a);
    }
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
