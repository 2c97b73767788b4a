// EqThree's two 4-stage one-pole cascades and band mix over one block: one
// cooperative launch, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mixlab_tpu/dsp/eq_pallas.py (eq_cascade_pallas /
// _eq_body), which solves each stage as 128-sample Toeplitz products with a
// carry over the chunk ends, one stage after the other.
//
// What bounds it on the card: latency.  A 44,100-sample block moves 529 KB
// (x and xd in, out written; 0.16 us at 3.35 TB/s) and the recurrence is
// ~1.46 MFLOP (0.02 us at 67 TFLOP/s f32); what costs time is the chain of
// dependencies through the block.  Before, each of the four stages needed
// its own carry across the whole block (five launches, a serial walk over
// the chunk ends in every CTA, 36.4 us).  Now the four stages are one
// linear system with a 4-value state per band, so one carry serves them all
// (csrc/eq_scan.cuh): G CTAs of T threads, each thread a run of L samples
// (T = 128 and L = 4 by the eq scan's sweep in PERF.md §6: G = 87 at
// S = 44,100; a longer run when the CTAs would not fit on the card at once,
// eq_cuda.scan_plan), both inputs staged once with 16-byte loads, pass 1 in
// registers, a block scan, the CTAs' aggregates to a scratch [G][8], one
// grid barrier, warp 0 folding the aggregates before its CTA, pass 2, the
// output stored with 16-byte stores.  What remains is the launch, the
// barrier and the two short scans.
//
// Over a batch (what jax.vmap(eq_cascade_pallas) computes: the fleet's N
// sessions, config 3's stems x channels), B independent blocks of S samples,
// each with its own poles and gains, go in ONE launch, in one of two forms
// (eq_cuda.batch_plan):
//   * the cooperative grid above with gridDim.y = B, where B x G CTAs fit on
//     the card at once (config 3: 32 blocks of 96,000 samples);
//   * otherwise one CTA a row (eq_rows_kernel, csrc/rows.cuh): as many CTAs
//     as the card holds, each walking its rows in turn in tiles of 128 x 16
//     samples (the eq's rows sweeps in PERF.md §6), copying its next
//     tile's x and xd into
//     shared memory with 16-byte cp.async while it computes on this one; the
//     table and thread maps loaded once a CTA; the carry in registers,
//     carry' = A^n carry + the tile's aggregate, folded by every thread
//     alike, so no thread folds it alone between barriers.  A tile's scan
//     takes one barrier (each warp scans the warp totals itself), and each
//     thread keeps its run in registers from pass 1 to pass 2 and stores its
//     outputs from them.
// Batched, the work is bandwidth-bound: 12 bytes a sample (x, xd in, out
// written) against ~20 FLOP a sample, e.g. 147.5 MB at B = 1,024 x 12,000,
// 44 us at 3.35 TB/s.  One CTA a row reaches 0.59-0.62 / 0.69-0.71 of that
// at 1,024 / 8,192 x 12,000 (in turns with the grid, PERF.md §6); the grid 0.45
// at 32 x 96,000.  A decoupled look-back over the card's CTAs (a few long
// rows' tiles taken by ticket) was built and measured slower than the grid
// at the stems' shapes (PERF.md §6); no path sends long rows past the grid,
// so one CTA a row takes them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "eq_scan.cuh"
#include "on_device.cuh"
#include "rows.cuh"

namespace {

namespace cg = cooperative_groups;

template <bool kBatch>
__global__ void __launch_bounds__(eq_scan::kMaxThreads)
eq_cascade_kernel(const float* __restrict__ x, const float* __restrict__ xd, int S, int lg,
                  const float* __restrict__ poles0, const float* __restrict__ gains,
                  const float* __restrict__ tables, float f_lo, float f_hi, float vsa,
                  float* __restrict__ agg, float* __restrict__ out,
                  float* __restrict__ poles_out) {
  extern __shared__ float tile[];  // x, then xd, each at the staged positions
  __shared__ eq_scan::Shared sh;
  float* xs = tile;
  float* xds = tile + (static_cast<int>(blockDim.x) << lg) + blockDim.x;
  const int tile0 = blockIdx.x * (static_cast<int>(blockDim.x) << lg);
  if (kBatch) {  // block blockIdx.y of the batch: its samples, poles, gains, aggregates
    const size_t seq = blockIdx.y;
    x += seq * S, xd += seq * S, out += seq * S;
    poles0 += 8 * seq, poles_out += 8 * seq, gains += 3 * seq;
    agg += 8 * seq * gridDim.x;
  }

  eq_scan::load_table(tables, sh);
  eq_scan::stage<false>(x, S, tile0, lg, xs);
  eq_scan::stage<false>(xd, S, tile0, lg, xds);
  __syncthreads();
  const eq_scan::Coeffs c{{sh.tab[eq_scan::kA], sh.tab[eq_scan::kA + 1]}, {f_lo, f_hi}, vsa};
  const eq_scan::Entry en = eq_scan::scan_up(xs, lg, c, sh, agg);
  cg::this_grid().sync();
  eq_scan::scan_down(xs, xds, S, tile0, lg, c, gains, sh, agg, poles0, en, poles_out, nullptr);
  __syncthreads();
  eq_scan::unstage(xs, S, tile0, lg, out);
}

// ---- the batched rows form (csrc/rows.cuh) ---------------------------------
// A tile is kRowsThreads threads of L = 2^kRowsLg samples (128 x 16, by
// the eq's rows sweeps in PERF.md §6, which built the other tiles by
// changing these two lines); x and xd are staged at a stride of L + 4 floats a run,
// so each run starts 16-byte aligned (cp.async of 16 bytes, float4 reads)
// and a quarter-warp's float4 reads hit distinct banks for L >= 8.

constexpr int kRowsThreads = 128;
constexpr int kRowsLg = 4;

// floats of the two staged buffers of x and xd (this tile and the next; a
// third lost in the eq's rows sweeps, PERF.md §6)
__host__ __device__ constexpr int log2i(int v) { return v > 1 ? 1 + log2i(v / 2) : 0; }

constexpr size_t kRowsFloats = 4 * static_cast<size_t>(kRowsThreads) * ((1 << kRowsLg) + 4);

struct RowsArgs {
  const float* x;
  const float* xd;
  int S, tiles, batch;
  const float *poles0, *gains, *tables;
  float f_lo, f_hi, vsa;
  float* out;
  float* poles_out;
};

// Tile samples [tile0, tile0 + (blockDim.x << kLg)) of a row into dst at the
// rows stride: 16-byte cp.async (L2 only) where the row is 16-byte aligned
// and the 4 samples lie before S, else 4-byte ones; zeros past S.  The
// caller commits the group.
template <int kLg>
__device__ __forceinline__ void stage_rows(const float* src, int S, int tile0, float* dst) {
  const int n4 = (static_cast<int>(blockDim.x) << kLg) >> 2;
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int q = threadIdx.x; q < n4; q += blockDim.x) {
    const int j = q * 4, s = tile0 + j;
    float* d = dst + j + ((j >> kLg) << 2);
    if (vec && s + 3 < S) {
      rows::cp_async16(d, src + s);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (s + e < S) {
          rows::cp_async4(d + e, src + s + e);
        } else {
          d[e] = 0.0f;
        }
      }
    }
  }
}

// What a thread computes of a tile before its entry is known: its run in
// registers, its entry state from zero state at the tile's start, and the
// tile's aggregate (its zero-state result).  Every thread of the CTA calls
// it; one barrier: each warp scans the warp totals itself, in the order
// eq_scan::scan_up does, so every warp gets the same bits.
template <int kLg>
struct TileScan {
  float x[1 << kLg];
  eq_scan::State E, agg;
};

template <int kLg>
__device__ __forceinline__ void tile_scan(TileScan<kLg>& ts, const float* xs,
                                          const eq_scan::Coeffs& c, const eq_scan::Shared& sh,
                                          float (*warp)[8], const eq_scan::Maps& maps) {
  constexpr int L = 1 << kLg;
  const int i = threadIdx.x, lane = i & 31, w = i >> 5;
  const int W = blockDim.x >> 5;
  const float* tab = sh.tab;
  const float4* mine = reinterpret_cast<const float4*>(xs + i * (L + 4));
#pragma unroll
  for (int q = 0; q < L / 4; ++q) {
    const float4 v4 = mine[q];
    ts.x[4 * q] = v4.x, ts.x[4 * q + 1] = v4.y, ts.x[4 * q + 2] = v4.z, ts.x[4 * q + 3] = v4.w;
  }
  eq_scan::State v = eq_scan::zero_state();
#pragma unroll
  for (int j = 0; j < L; ++j) eq_scan::step(v, ts.x[j], c);
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const eq_scan::State up = eq_scan::shfl_up(v, 1 << r);
    if (lane >= (1 << r)) eq_scan::absorb(v, up, tab, kLg + r);
  }
  eq_scan::State e = eq_scan::shfl_up(v, 1);  // exclusive: the earlier lanes of the warp
  if (lane == 0) e = eq_scan::zero_state();
  if (lane == 31) eq_scan::store_state(warp[w], v);
  __syncthreads();
  eq_scan::State t = lane < W ? eq_scan::load_state(warp[lane]) : eq_scan::zero_state();
  for (int r = 0; (1 << r) < W; ++r) {
    const eq_scan::State up = eq_scan::shfl_up(t, 1 << r);
    if (lane >= (1 << r)) eq_scan::absorb(t, up, tab, kLg + 5 + r);
  }
  eq_scan::State ew, agg;
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ew.y[b][k] = __shfl_sync(0xffffffffu, t.y[b][k], w > 0 ? w - 1 : 0);
      agg.y[b][k] = __shfl_sync(0xffffffffu, t.y[b][k], W - 1);
    }
  if (w == 0) ew = eq_scan::zero_state();
  ts.E = eq_scan::affine(maps.lane, ew, e);
  ts.agg = agg;
}

// Pass 2 of the tile at tile0 of a row from the thread's true entry state
// s: the band mix of its run (xds the staged delayed input) stored from
// registers, 16 bytes at a time where the row is 16-byte aligned, and, where
// the thread holds sample S-1, the row's poles.
template <int kLg>
__device__ __forceinline__ void tile_down(const TileScan<kLg>& ts, const float* xds,
                                          eq_scan::State s, const eq_scan::Coeffs& c,
                                          float g0, float g1, float g2, int S, int tile0,
                                          float* out, float* poles_out) {
  constexpr int L = 1 << kLg;
  const int base = tile0 + (static_cast<int>(threadIdx.x) << kLg);
  const float4* md = reinterpret_cast<const float4*>(xds + threadIdx.x * (L + 4));
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
  for (int q = 0; q < L / 4; ++q) {
    const float4 d4 = md[q];
    const float d[4] = {d4.x, d4.y, d4.z, d4.w};
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      eq_scan::step(s, ts.x[4 * q + e], c);
      const float lo = s.y[0][3], hi = s.y[1][3];
      o[e] = lo * g0 + (hi - lo) * g1 + (d[e] - hi) * g2;
      if (base + 4 * q + e == S - 1) eq_scan::store_poles(poles_out, s);
    }
    const int t = base + 4 * q;
    if (vec && t + 3 < S) {
      *reinterpret_cast<float4*>(out + t) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (t + e < S) out[t + e] = o[e];
      }
    }
  }
}

// One CTA a row: CTA c walks rows c, c + gridDim.x, ... (as many CTAs as
// the card holds, at most one a row), each row's tiles in order with the
// carry in registers; the next tile, across a row's end too, is staged while
// this one runs, and the table and thread maps are loaded once a CTA.
__global__ void __launch_bounds__(kRowsThreads) eq_rows_kernel(RowsArgs a) {
  constexpr int kLg = kRowsLg;
  constexpr int buf = kRowsThreads * ((1 << kLg) + 4);  // one array of a buffer
  constexpr int n = kRowsThreads << kLg;
  constexpr int ltile = kLg + log2i(kRowsThreads);  // log2 of a tile's samples
  extern __shared__ float4 smem4[];
  __shared__ eq_scan::Shared sh;
  float* smem = reinterpret_cast<float*>(smem4);
  // the CTA's work: tile j % tiles of its row j / tiles
  const int rows_here = (a.batch - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int items = rows_here * a.tiles;
  auto row_of = [&](int j) {
    return static_cast<size_t>(blockIdx.x) + static_cast<size_t>(j / a.tiles) * gridDim.x;
  };
  auto stage = [&](int j) {  // tile j into its buffer, if there is one; one commit group
    if (j < items) {
      const size_t row = row_of(j);
      const int tile0 = (j % a.tiles) * n;
      float* dst = smem + (j & 1) * 2 * buf;
      stage_rows<kLg>(a.x + row * a.S, a.S, tile0, dst);
      stage_rows<kLg>(a.xd + row * a.S, a.S, tile0, dst + buf);
    }
    rows::cp_async_commit();
  };
  stage(0);
  eq_scan::load_table(a.tables, sh);
  __syncthreads();
  const eq_scan::Maps maps = eq_scan::thread_maps(sh.tab, kLg);
  const eq_scan::Coeffs c{{sh.tab[eq_scan::kA], sh.tab[eq_scan::kA + 1]}, {a.f_lo, a.f_hi},
                          a.vsa};
  eq_scan::State carry;
  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
  for (int j = 0; j < items; ++j) {
    const size_t row = row_of(j);
    const int t = j % a.tiles;
    if (t == 0) {  // a row's start: its poles and gains
      carry = eq_scan::load_poles(a.poles0 + 8 * row);
      g0 = __ldg(a.gains + 3 * row), g1 = __ldg(a.gains + 3 * row + 1);
      g2 = __ldg(a.gains + 3 * row + 2);
    }
    float* cur = smem + (j & 1) * 2 * buf;
    rows::cp_async_wait<0>();
    __syncthreads();  // this tile is staged; every thread is done with the other buffer
    stage(j + 1);
    TileScan<kLg> ts;
    tile_scan<kLg>(ts, cur, c, sh, sh.warp, maps);
    const eq_scan::State s = eq_scan::affine(maps.thread, carry, ts.E);
    eq_scan::absorb(ts.agg, carry, sh.tab, ltile);  // the next tile's entry
    carry = ts.agg;
    tile_down<kLg>(ts, cur + buf, s, c, g0, g1, g2, a.S, t * n, a.out + row * a.S,
                   a.poles_out + 8 * row);
  }
}

size_t shared_bytes(int threads, int run) {
  return eq_scan::tile_floats(threads, run) * sizeof(float);
}

// the largest tile may exceed the 48 KB a launch gets without asking
cudaError_t allow_shared(int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  const int bytes = static_cast<int>(shared_bytes(eq_scan::kMaxThreads, eq_scan::kMaxRun));
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(eq_cascade_kernel<false>, attr, bytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(eq_cascade_kernel<true>, attr, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(eq_rows_kernel, attr, static_cast<int>(kRowsFloats * sizeof(float)));
  }
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

extern "C" {

// CTAs of `threads` threads of the eq kernel that one card holds at once at
// the longest run, into *resident; the wrapper sizes its grid by it.
// Returns a cudaError_t (0 = cudaSuccess).
int mixlab_eq_resident_tiles(int threads, int device, int* resident) {
  *resident = 0;
  if (!pow2(threads) || threads < 32 || threads > eq_scan::kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OnDevice on(device);
  cudaError_t err = on.error();
  int n_sm = 0, per_sm = 0;
  if (err == cudaSuccess) err = allow_shared(device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  }
  // the fewer of the single and the batched grid's CTAs a card holds
  int batched = 0;
  const size_t bytes = shared_bytes(threads, eq_scan::kMaxRun);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, eq_cascade_kernel<false>,
                                                        threads, bytes);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&batched, eq_cascade_kernel<true>,
                                                        threads, bytes);
  }
  *resident = (per_sm < batched ? per_sm : batched) * n_sm;
  return static_cast<int>(err);
}

// CTAs of the batched rows form (one CTA a row) that one card holds at once,
// into *resident.  Returns a cudaError_t (0 = cudaSuccess).
int mixlab_eq_rows_resident(int device, int* resident) {
  *resident = 0;
  OnDevice on(device);
  cudaError_t err = on.error();
  if (err == cudaSuccess) err = allow_shared(device);
  int n_sm = 0, per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, eq_rows_kernel, kRowsThreads,
                                                        kRowsFloats * sizeof(float));
  }
  *resident = per_sm * n_sm;
  return static_cast<int>(err);
}

// EqThree over `batch` blocks of S samples: x, xd [batch][S] (xd = the
// 3-sample-delayed input), poles0 [batch][4][2] (stage-major, band-minor),
// gains [batch][3] and tables [eq_scan::kTable] (eq_cuda.kernel_tables) are
// device pointers; out [batch][S] and poles_out [batch][4][2] are written.
// `form` 0: a cooperative grid of `tiles` x `batch` CTAs of `threads`
// threads, each a run of `run` samples (powers of two; run <= 32,
// 32 <= threads <= 512; every CTA of a block but the last full, the last
// holding sample S-1; `scratch` holds 8 floats a CTA, 16-byte aligned).
// Form 1: one CTA a block, `ctas` CTAs (at most `batch`; CTA c takes blocks
// c, c + ctas, ...), `tiles` tiles of kRowsThreads x 2^kRowsLg samples a
// block (`threads` and `run` must name that tile), the next one staged;
// `scratch` unread.  The launch goes to card `device`.  Returns the
// launch's cudaError_t (0 = cudaSuccess); a cooperative grid larger than
// the card holds at once is refused by the launch.
int mixlab_eq_cascade(const float* x, const float* xd, int S, int batch, int form,
                      const float* poles0, const float* gains, const float* tables, float f_lo,
                      float f_hi, float vsa, int run, int threads, int tiles, int ctas,
                      float* scratch, float* out, float* poles_out, int device, void* stream) {
  const long long tile = static_cast<long long>(threads) * run;
  bool bad = S < 1 || batch < 1 || !pow2(run) || !pow2(threads) || threads < 32 ||
             (reinterpret_cast<uintptr_t>(scratch) & 15) != 0 || form < 0 || form > 1;
  if (form == 0) {
    bad = bad || run > eq_scan::kMaxRun || threads > eq_scan::kMaxThreads || tiles < 1 ||
          batch > 65535 || tiles * tile < S || (tiles - 1) * tile >= S;
  } else {
    bad = bad || threads != kRowsThreads || run != (1 << kRowsLg) ||
          tiles != (S + tile - 1) / tile || static_cast<long long>(batch) * tiles > 0x7fffffffLL ||
          ctas < 1 || ctas > batch;
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  cudaError_t err = allow_shared(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 1) {
    const RowsArgs a{x, xd, S, tiles, batch, poles0, gains, tables, f_lo, f_hi, vsa,
                     out, poles_out};
    eq_rows_kernel<<<ctas, kRowsThreads, kRowsFloats * sizeof(float), st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  int lg = 0;
  while ((1 << lg) < run) ++lg;
  void* args[] = {&x, &xd, &S, &lg, &poles0, &gains, &tables, &f_lo, &f_hi, &vsa,
                  &scratch, &out, &poles_out};
  // one block: the kernel without the batch offsets, as before the batch axis
  const void* kernel = batch > 1 ? reinterpret_cast<const void*>(eq_cascade_kernel<true>)
                                 : reinterpret_cast<const void*>(eq_cascade_kernel<false>);
  err = cudaLaunchCooperativeKernel(kernel, dim3(tiles, batch), dim3(threads), args,
                                    shared_bytes(threads, run), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
