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
// (T = 128 and L = 4 by the sweep in chip_smoke.py phase 7: G = 87 at
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
//   * otherwise one CTA a block (eq_cascade_seq_kernel): the CTA walks its
//     block in tiles of T*L samples, runs pass 1, the block scan and pass 2
//     on each, and carries the entry state from tile to tile in shared
//     memory (carry' = A^(T*L) carry + the tile's aggregate): no grid
//     barrier, no cooperative launch, any B (the fleet: 1,024-8,192 blocks
//     of 12,000 samples).
// Batched, the work is bandwidth-bound: 12 bytes a sample (x, xd in, out
// written) against ~20 FLOP a sample, e.g. 147.5 MB at B = 1,024 x 12,000,
// 44 us at 3.35 TB/s.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "eq_scan.cuh"
#include "on_device.cuh"

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

// One block of the batch a CTA (blockIdx.x), walked in tiles of
// blockDim.x << lg samples with the entry state carried in sh.entry.
__global__ void __launch_bounds__(eq_scan::kMaxThreads)
eq_cascade_seq_kernel(const float* __restrict__ x, const float* __restrict__ xd, int S,
                      int lg, const float* __restrict__ poles0,
                      const float* __restrict__ gains, const float* __restrict__ tables,
                      float f_lo, float f_hi, float vsa, float* __restrict__ agg,
                      float* __restrict__ out, float* __restrict__ poles_out) {
  extern __shared__ float tile[];
  __shared__ eq_scan::Shared sh;
  float* xs = tile;
  float* xds = tile + (static_cast<int>(blockDim.x) << lg) + blockDim.x;
  const size_t seq = blockIdx.x;
  x += seq * S, xd += seq * S, out += seq * S;
  poles0 += 8 * seq, poles_out += 8 * seq, gains += 3 * seq;
  const int ltile = lg + __ffs(blockDim.x) - 1;  // log2 of the tile's samples
  const int W = blockDim.x >> 5;

  eq_scan::load_table(tables, sh);
  if (threadIdx.x == 0) eq_scan::store_state(sh.entry, eq_scan::load_poles(poles0));
  for (int tile0 = 0; tile0 < S; tile0 += 1 << ltile) {
    eq_scan::stage<false>(x, S, tile0, lg, xs);
    eq_scan::stage<false>(xd, S, tile0, lg, xds);
    __syncthreads();
    const eq_scan::Coeffs c{{sh.tab[eq_scan::kA], sh.tab[eq_scan::kA + 1]}, {f_lo, f_hi}, vsa};
    const eq_scan::Entry en = eq_scan::scan_up(xs, lg, c, sh, agg);  // agg unread
    eq_scan::run_down(xs, xds, S, tile0, lg, c, gains,
                      eq_scan::affine(en.M, eq_scan::load_state(sh.entry), en.E), poles_out);
    __syncthreads();  // every thread has read sh.entry and written its outputs
    if (threadIdx.x == 0) {  // the next tile's entry: A^(T*L) carry + this tile's aggregate
      eq_scan::State a = eq_scan::load_state(sh.warp[W - 1]);
      eq_scan::absorb(a, eq_scan::load_state(sh.entry), sh.tab, ltile);
      eq_scan::store_state(sh.entry, a);
    }
    eq_scan::unstage(xs, S, tile0, lg, out);
    __syncthreads();  // xs, sh.warp and sh.entry are free for the next tile
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
  if (err == cudaSuccess) err = cudaFuncSetAttribute(eq_cascade_seq_kernel, attr, bytes);
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

// EqThree over `batch` blocks of S samples: x, xd [batch][S] (xd = the
// 3-sample-delayed input), poles0 [batch][4][2] (stage-major, band-minor),
// gains [batch][3] and tables [eq_scan::kTable] (eq_cuda.kernel_tables) are
// device pointers; out [batch][S] and poles_out [batch][4][2] are written.
// Threads of `threads`, each a run of `run` samples (powers of two,
// run <= 32, 32 <= threads <= 512).  With seq == 0 a cooperative grid of
// `tiles` x `batch` CTAs (every CTA of a block but the last full, the last
// holding sample S-1; `scratch` holds 8 floats a CTA, 16-byte aligned);
// with seq == 1 one CTA a block, `tiles` unused and `scratch` 8 floats a
// block (written, never read).  The launch
// goes to card `device`.  Returns the launch's cudaError_t (0 =
// cudaSuccess); a cooperative grid larger than the card holds at once is
// refused by the launch.
int mixlab_eq_cascade(const float* x, const float* xd, int S, int batch, int seq,
                      const float* poles0, const float* gains, const float* tables, float f_lo,
                      float f_hi, float vsa, int run, int threads, int tiles, float* scratch,
                      float* out, float* poles_out, int device, void* stream) {
  const long long tile = static_cast<long long>(threads) * run;
  if (S < 1 || batch < 1 || !pow2(run) || run > eq_scan::kMaxRun || !pow2(threads) ||
      threads < 32 || threads > eq_scan::kMaxThreads ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0 ||
      (!seq && (tiles < 1 || batch > 65535 || tiles * tile < S || (tiles - 1) * tile >= S))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  cudaError_t err = allow_shared(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int lg = 0;
  while ((1 << lg) < run) ++lg;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (seq) {
    eq_cascade_seq_kernel<<<batch, threads, shared_bytes(threads, run), st>>>(
        x, xd, S, lg, poles0, gains, tables, f_lo, f_hi, vsa, scratch, out, poles_out);
    return static_cast<int>(cudaGetLastError());
  }
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
