// The whole-graph region of a patch (EqThree, everything downstream of it
// and the producers it absorbs) as ONE cooperative launch per part,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel built by mixlab_tpu/engine/pallas_graph.py:377
// (build_mega_program / _make_kernel, one pl.pallas_call per part of at most
// 192Ki samples).  Where the TPU kernel is traced per graph, this kernel is
// fixed: it walks a plan, the flat op list the region's modules emitted
// (mixlab_tpu_torch/dsp/base.py, OP_*), over slots, i.e. [S] buffers of the
// part whose device pointers arrive in a table.  No source is generated per
// graph, so nothing is built beyond this file and its header.
//
// Layout: G CTAs of 128 threads; CTA c owns the contiguous chunks
// [c*L, c*L + L) of 128 samples (L = eq_cuda.scan_plan's run, a power of
// two: L = 4 and G = 94 at the 48 kHz flagship block, S = 48,000).  In an
// elementwise op (FILL, AMP, AMP_MOD, MIX, I16, TAP) thread i handles
// sample i of each of its CTA's chunks, up to kBatch chunks at a time with
// every load issued before the first store, so an op costs one memory
// latency, not L; each op rounds as the JAX emit does, in its order (the
// library is built with -fmad=false, so a*b + c stays two roundings unless
// the source says fmaf).  PEAK is a block reduction of the bit patterns of
// |l|, |r| (for non-negative floats the unsigned order is the float order,
// and a NaN is above +inf, so it wins as jnp.max lets it) and one atomicMax
// per CTA; the scalar taps are zeroed by CTA 0 before the plan's first
// barrier.  SYNC is a grid-wide barrier (cooperative_groups::this_grid()
// .sync(); the launch is cooperative and G at most what the card holds at
// once, by the occupancy query).
//
// EQ (EqThree, src/module/eq_three.rs:117-124; the TPU body is
// mixlab_tpu/dsp/eq_pallas.py:_eq_body) runs the core csrc/eq_scan.cuh over
// the CTA's tile, which is exactly its chunks (128 threads, runs of L
// samples): x staged from the CTA's own chunks, pass 1, the block scan, the
// aggregate to the op's scratch slot, ONE grid barrier, then the delayed
// input xd = x[t-3] (across the tile's first edge from the previous CTA's
// chunks, which that barrier makes visible, and from the state's history
// before the part), pass 2, and the band mix stored back over the CTA's
// chunks.  Every op reads and writes only its CTA's chunks but the EQ's
// 3-sample halo, so no op needs a barrier to read the one before it (the
// plan emits no SYNC for an EQ; its own barrier counts as the plan's first).
// Exits: the poles at the part's last sample, then its last 3 inputs.
//
// What bounds it on the card: at the 48 kHz flagship block the function
// moves 1,538,264 B (six crossing operands in, one stereo tap out), 0.46 us
// at 3.35 TB/s; its arithmetic (the recurrence's ~1.6 MFLOP, the
// elementwise ops) is far below that.  What costs time is latency: the
// launch, the grid barrier, one memory round trip per op, the EQ's two
// passes of L dependent samples and its scans.  Before, the EQ solved each
// stage as 128-sample Toeplitz products with a grid barrier and a redundant
// scan of every chunk end in every CTA after each of its four stages
// (51.4 us per launch on an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py);
// the scan form needs one carry for all four stages.
//
// Over a batch (what jax.vmap of the TPU kernel computes: the fleet's
// sessions, the stems), B rows of one part, each with its own operands,
// parameter and state scalars, taps and exits, go in ONE launch, in one of
// two forms (region_cuda.batch_plan), as the batched eq kernel's
// (csrc/eq_cascade.cu):
//   * the cooperative grid above with gridDim.y = B, where B x G CTAs fit on
//     the card at once (a few stems at long blocks); each row's scratch
//     slots are global [B][S] buffers;
//   * otherwise one CTA a row (region_seq_kernel): the CTA walks its row in
//     tiles of 128 x L samples and runs the whole plan over each tile.  Its
//     scratch slots are tile buffers in shared memory; each EQ op carries its
//     poles and its 3-sample history (xd) from tile to tile in the row's exits,
//     which after the last tile are the part's exits; PEAK is a running max
//     of the row's own taps (one CTA: no atomics); SYNC is a no-op (the plan
//     emits it only so that PEAK follows the zeroing of the scalar taps).
//     No grid barrier, no cooperative launch, any B (the fleet: 1,024-8,192
//     rows of 12,800 samples).
// Row b of a slot is at its address + b x its row stride; the stride is 0
// for an operand that every row shares, which is never expanded to [B][S].
// The plan's constants are one row for all.  A single block (B = 1, its
// constants right after its param scalars) takes the cooperative kernel
// without the row offsets (Block), as before the batch axis.  Batched, the work is bound by bytes: the
// flagship's plan moves ~32 B a sample (six operands in, a stereo tap out),
// 3.36 GB at 8,192 rows of 12,800 (1.0 ms at 3.35 TB/s); one CTA a row
// takes a tile of 512 samples a step with one memory round trip an op, at
// 0.2 of that bound (chip_smoke.py phase 20).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "eq_scan.cuh"
#include "on_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 128;       // samples per chunk = threads per CTA
constexpr int kMaxChunks = 4096;  // region_cuda.MAX_CHUNKS
constexpr int kBatch = 8;         // chunks a thread loads before it stores
// dynamic shared memory the one-CTA-a-row form asks for at most (a Hopper
// CTA may have 227 KB; region_cuda.SEQ_SHARED)
constexpr size_t kSeqShared = 200 * 1024;

// op codes: mixlab_tpu_torch/dsp/base.py OP_*
enum Op : int {
  kSync = 0, kFill = 1, kAmp = 2, kAmpMod = 3, kMix = 4,
  kI16 = 5, kTap = 6, kPeak = 7, kEq = 8,
};

// the EQ's table constant: eq_cuda.kernel_tables, then f_lo, f_hi, vsa
constexpr int kF = eq_scan::kTable;
constexpr int kVsa = eq_scan::kTable + 2;

struct Part {
  const int* ops;
  int n_words;
  const long long* slots;  // [n_slots][2]: device address, row stride in bytes
  int n_operands;          // slots past these are scratch
  const float* pf;         // param scalars, row b at pf + b * pf_stride
  long long pf_stride;
  int n_pf;
  const float* consts;     // the plan's constants: parameter index n_pf onwards
  const float* sf;         // state scalars (layout == exits), row b at sf + b * sf_stride
  long long sf_stride;
  float* taps;             // [B][n_taps][S]
  int n_taps;
  float* stap;             // [B][n_stap]
  int n_stap;
  float* ef;               // exits [B][n_ef]
  int n_ef;
  int S;
  int K;                   // S / 128
  int lg;                  // log2 of the chunks a CTA takes at a time (the EQ's run)
};

// What a CTA sees of its row b.  In the one-CTA-a-row form the scratch
// slots are tile buffers of tile_n samples in shared memory (`local`),
// addressed, as every slot, by the part's sample index.
struct Row {
  const Part& p;
  long long b;
  const float* pf;
  const float* sf;
  float* taps;
  unsigned* stap;  // the scalar taps' bit patterns (|x| >= 0: the float order)
  float* ef;
  float* local;
  int tile_n, tile0;

  __device__ Row(const Part& part, int row, float* loc = nullptr, int n = 0, int t0 = 0)
      : p(part), b(row), pf(part.pf + row * part.pf_stride), sf(part.sf + row * part.sf_stride),
        taps(part.taps + static_cast<long long>(row) * part.n_taps * part.S),
        stap(reinterpret_cast<unsigned*>(part.stap) + static_cast<long long>(row) * part.n_stap),
        ef(part.ef + static_cast<long long>(row) * part.n_ef), local(loc), tile_n(n),
        tile0(t0) {}

  // slot s as a pointer whose element t is the part's sample t
  __device__ __forceinline__ float* slot(int s) const {
    if (local != nullptr && s >= p.n_operands) return local + (s - p.n_operands) * tile_n - tile0;
    return reinterpret_cast<float*>(p.slots[2 * s] + b * p.slots[2 * s + 1]);
  }
  // parameter index i: the row's param scalar, or the plan's constant
  __device__ __forceinline__ const float* par(int i) const {
    return i < p.n_pf ? pf + i : p.consts + (i - p.n_pf);
  }
};

// What a CTA of a single block sees (B = 1, the plan's constants right
// after the param scalars in one row, as before the batch axis): each slot
// at its address, parameter i at pf[i].
struct Block {
  const Part& p;
  const float* sf;
  float* taps;
  unsigned* stap;
  float* ef;

  __device__ Block(const Part& part, int)
      : p(part), sf(part.sf), taps(part.taps), stap(reinterpret_cast<unsigned*>(part.stap)),
        ef(part.ef) {}

  __device__ __forceinline__ float* slot(int s) const {
    return reinterpret_cast<float*>(p.slots[2 * s]);
  }
  __device__ __forceinline__ const float* par(int i) const { return p.pf + i; }
};

// the chunks an op covers: [k0, k0 + n)
struct Chunks {
  int k0, n;
};

// a = [dst, x, agg, sf, p_gains, p_tab, ef, sample_rate]; `tile` is the
// dynamic shared memory (eq_scan::tile_floats(128, L) floats).  The
// cooperative form: CTA blockIdx.x of the row's grid.
template <class R>
__device__ void eq_op(const R& r, const int* a, cg::grid_group& grid, float* tile) {
  __shared__ eq_scan::Shared sh;
  float* out = r.slot(a[0]);
  const float* x = r.slot(a[1]);
  float* agg = r.slot(a[2]);
  const float* sf = r.sf + a[3];
  const float* tab = r.par(a[5]);
  float* ef = r.ef + a[6];
  const int S = r.p.S, lg = r.p.lg;
  const int n = kChunk << lg;  // the tile's samples
  const int tile0 = blockIdx.x * n;
  float* xs = tile;
  float* xds = tile + n + kChunk;

  eq_scan::load_table(tab, sh);
  __syncthreads();  // the ops before wrote x thread by thread
  eq_scan::stage<true>(x, S, tile0, lg, xs);
  __syncthreads();
  const eq_scan::Coeffs c{{sh.tab[eq_scan::kA], sh.tab[eq_scan::kA + 1]},
                          {__ldg(tab + kF), __ldg(tab + kF + 1)}, __ldg(tab + kVsa)};
  const eq_scan::Entry en = eq_scan::scan_up(xs, lg, c, sh, agg);
  grid.sync();
  // the delayed input (eq_three.rs:71-79): the previous chunks' last 3
  // samples across the tile's first edge, the state's history before the
  // part; scan_down's barrier orders these writes before pass 2 reads them
  for (int j = threadIdx.x; j < n; j += kChunk) {
    const int t = tile0 + j;
    xds[eq_scan::pos(j, lg)] =
        j >= 3 ? xs[eq_scan::pos(j - 3, lg)] : (t >= 3 ? __ldcg(x + t - 3) : sf[8 + t]);
  }
  eq_scan::scan_down(xs, xds, S, tile0, lg, c, r.par(a[4]), sh, agg, sf, en, ef, ef + 8);
  __syncthreads();
  eq_scan::unstage(xs, S, tile0, lg, out);
  __syncthreads();  // the next ops read `out` thread by thread
}

// Tile samples [tile0, tile0 + 128 << lg) of src into dst at the staged
// positions, 0 from `end` on: plain loads, as src may be a tile buffer in
// shared memory.
__device__ __forceinline__ void stage_plain(const float* src, int end, int tile0, int lg,
                                            float* dst) {
  const int n4 = (kChunk << lg) >> 2;
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int q = threadIdx.x; q < n4; q += kChunk) {
    const int j = q * 4, s = tile0 + j;
    float v[4];
    if (vec && s + 3 < end) {
      const float4 w = *reinterpret_cast<const float4*>(src + s);
      v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = s + e < end ? src[s + e] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[eq_scan::pos(j + e, lg)] = v[e];
  }
}

// The EQ over one tile of the one-CTA-a-row form.  The poles and the 3
// inputs before the tile come from the state before the part (the first
// tile) or from the exits, where the tile before left them; this tile
// leaves its own there, so after the row's last tile the exits are the
// part's.
__device__ void eq_op_seq(const Row& r, const int* a, float* tile) {
  __shared__ eq_scan::Shared sh;
  float* out = r.slot(a[0]);
  const float* x = r.slot(a[1]);
  const float* tab = r.par(a[5]);
  float* ef = r.ef + a[6];
  const int lg = r.p.lg, tile0 = r.tile0;
  const int n = kChunk << lg;
  const int end = min(tile0 + n, r.p.S);
  const float* carry = tile0 == 0 ? r.sf + a[3] : ef;
  float* xs = tile;
  float* xds = tile + n + kChunk;

  eq_scan::load_table(tab, sh);
  __syncthreads();  // the ops before wrote x thread by thread
  stage_plain(x, end, tile0, lg, xs);
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kChunk) {
    xds[eq_scan::pos(j, lg)] = j >= 3 ? xs[eq_scan::pos(j - 3, lg)] : carry[8 + j];
  }
  const eq_scan::Coeffs c{{sh.tab[eq_scan::kA], sh.tab[eq_scan::kA + 1]},
                          {__ldg(tab + kF), __ldg(tab + kF + 1)}, __ldg(tab + kVsa)};
  // its barriers order the xds writes before pass 2 reads them
  const eq_scan::Entry en = eq_scan::scan_up(xs, lg, c, sh, nullptr);
  const eq_scan::State s = eq_scan::affine(en.M, eq_scan::load_poles(carry), en.E);
  __syncthreads();  // every thread has read the carry before the exits change
  if (threadIdx.x < 3) ef[8 + threadIdx.x] = x[end - 3 + threadIdx.x];
  eq_scan::run_down(xs, xds, end, tile0, lg, c, r.par(a[4]), s, ef);
  __syncthreads();
  eq_scan::unstage(xs, end, tile0, lg, out);
  __syncthreads();  // the next ops read `out` thread by thread
}

// max(|l|, |r|) over the chunks as bit patterns (for non-negative floats the
// unsigned order is the float order, and a NaN is above +inf, so it wins as
// jnp.max lets it), into the row's scalar tap: atomically where several
// CTAs share the row, else by thread 0, the only one that touches it.
template <bool kAtomic, class R>
__device__ void peak_op(const R& row, const int* a, Chunks ch) {
  __shared__ unsigned warp_max[kChunk / 32];
  const float* l = row.slot(a[1]);
  const float* r = row.slot(a[2]);
  unsigned m = 0u;
  for (int u0 = 0; u0 < ch.n; u0 += kBatch) {
    float lv[kBatch], rv[kBatch];
    const int t0 = (ch.k0 + u0) * kChunk + threadIdx.x;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u0 + u < ch.n) {
        lv[u] = l[t0 + u * kChunk];
        rv[u] = r[t0 + u * kChunk];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u0 + u < ch.n) {
        m = max(m, __float_as_uint(fabsf(lv[u])));
        m = max(m, __float_as_uint(fabsf(rv[u])));
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kChunk / 32; ++w) m = max(m, warp_max[w]);
    if (kAtomic) {
      atomicMax(row.stap + a[0], m);
    } else {
      row.stap[a[0]] = max(row.stap[a[0]], m);
    }
  }
  __syncthreads();  // warp_max is free again
}

// One elementwise op over this thread's samples of the chunks, kBatch
// chunks at a time: every load of a batch before its first store.
template <class R>
__device__ void elementwise_op(const R& r, int code, const int* a, Chunks ch) {
  for (int u0 = 0; u0 < ch.n; u0 += kBatch) {
    const int t0 = (ch.k0 + u0) * kChunk + threadIdx.x;
    const int m = min(kBatch, ch.n - u0);
    float v[kBatch];
    switch (code) {
      case kFill: {
        float* dst = r.slot(a[0]);
        const float val = 0.0f + *r.par(a[1]);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) dst[t0 + u * kChunk] = val;
        }
        break;
      }
      case kAmp: {
        const float* src = r.slot(a[1]);
        float* dst = r.slot(a[0]);
        const float amp = *r.par(a[2]);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) v[u] = src[t0 + u * kChunk];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) dst[t0 + u * kChunk] = v[u] * amp;
        }
        break;
      }
      case kAmpMod: {
        const float* src = r.slot(a[1]);
        const float* mod = r.slot(a[2]);
        float* dst = r.slot(a[0]);
        const float amp = *r.par(a[3]), md = *r.par(a[4]);
        float mv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) {
            v[u] = src[t0 + u * kChunk];
            mv[u] = mod[t0 + u * kChunk];
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) {
            const float scale = ((1.0f - md) + md * mv[u]) * amp;
            dst[t0 + u * kChunk] = v[u] * scale;
          }
        }
        break;
      }
      case kMix: {
        const int n = a[1];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) v[u] = 0.0f;
        for (int j = 0; j < n; ++j) {
          const float* src = r.slot(a[2 + j]);
          const float w = *r.par(a[2 + n + j]);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (u < m) v[u] = v[u] + w * src[t0 + u * kChunk];
          }
        }
        float* dst = r.slot(a[0]);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) dst[t0 + u * kChunk] = v[u];
        }
        break;
      }
      case kI16: {
        const int16_t* src = reinterpret_cast<const int16_t*>(r.slot(a[1]));
        float* dst = r.slot(a[0]);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) v[u] = static_cast<float>(src[t0 + u * kChunk]) * (1.0f / 32768.0f);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) dst[t0 + u * kChunk] = v[u];
        }
        break;
      }
      case kTap: {
        const float* src = r.slot(a[1]);
        float* dst = r.taps + static_cast<size_t>(a[0]) * r.p.S;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) v[u] = src[t0 + u * kChunk];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) dst[t0 + u * kChunk] = v[u];
        }
        break;
      }
      default:
        break;
    }
  }
}

// The cooperative form: CTA (blockIdx.x, blockIdx.y) owns chunks
// [x * L, x * L + L) of row y; R is Block for a single block, else Row.
template <class R>
__global__ void __launch_bounds__(kChunk) region_kernel(Part p) {
  extern __shared__ float4 smem[];  // the EQ's staged tile
  float* tile = reinterpret_cast<float*>(smem);
  cg::grid_group grid = cg::this_grid();
  const R r(p, blockIdx.y);
  const int k0 = blockIdx.x << p.lg;
  const Chunks ch{k0, max(0, min(1 << p.lg, p.K - k0))};
  if (blockIdx.x == 0) {
    for (int j = threadIdx.x; j < p.n_stap; j += kChunk) r.stap[j] = 0u;
  }
  for (int pc = 0; pc < p.n_words;) {
    const int code = p.ops[pc];
    const int len = p.ops[pc + 1];
    const int* a = p.ops + pc + 2;
    pc += len;
    if (code == kSync) {
      grid.sync();
    } else if (code == kEq) {
      eq_op(r, a, grid, tile);
    } else if (code == kPeak) {
      peak_op<true, R>(r, a, ch);
    } else {
      elementwise_op(r, code, a, ch);
    }
  }
}

// The one-CTA-a-row form: CTA blockIdx.x walks row blockIdx.x in tiles of
// L chunks and runs the whole plan over each.
__global__ void __launch_bounds__(kChunk) region_seq_kernel(Part p) {
  extern __shared__ float4 smem[];  // the EQ's staged tile, then the scratch slots' tiles
  float* tile = reinterpret_cast<float*>(smem);
  const int n = kChunk << p.lg;
  float* local = tile + eq_scan::tile_floats(kChunk, 1 << p.lg);
  if (threadIdx.x == 0) {
    const Row r(p, blockIdx.x);
    for (int j = 0; j < p.n_stap; ++j) r.stap[j] = 0u;
  }
  for (int tile0 = 0; tile0 < p.S; tile0 += n) {
    const Row r(p, blockIdx.x, local, n, tile0);
    const Chunks ch{tile0 / kChunk, min(1 << p.lg, p.K - tile0 / kChunk)};
    for (int pc = 0; pc < p.n_words;) {
      const int code = p.ops[pc];
      const int len = p.ops[pc + 1];
      const int* a = p.ops + pc + 2;
      pc += len;
      if (code == kSync) {
        continue;  // one CTA holds the row
      } else if (code == kEq) {
        eq_op_seq(r, a, tile);
      } else if (code == kPeak) {
        peak_op<false, Row>(r, a, ch);
      } else {
        elementwise_op(r, code, a, ch);
      }
    }
  }
}

size_t shared_bytes(int run) { return eq_scan::tile_floats(kChunk, run) * sizeof(float); }

size_t seq_shared_bytes(int run, int n_scratch) {
  return (eq_scan::tile_floats(kChunk, run) + static_cast<size_t>(n_scratch) * kChunk * run) *
         sizeof(float);
}

cudaError_t allow_shared(int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const int bytes = static_cast<int>(shared_bytes(eq_scan::kMaxRun));
  cudaError_t err = cudaFuncSetAttribute(region_kernel<Block>, attr, bytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(region_kernel<Row>, attr, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(region_seq_kernel, attr, static_cast<int>(kSeqShared));
  }
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

}  // namespace

extern "C" {

// CTAs of the region kernel's cooperative form that one card holds at once
// at the longest run, into *resident; the wrapper sizes its grid by it.
// Returns a cudaError_t (0 = cudaSuccess).
int mixlab_region_resident_tiles(int device, int* resident) {
  *resident = 0;
  OnDevice on(device);
  cudaError_t err = on.error();
  int n_sm = 0, per_sm = 0;
  if (err == cudaSuccess) err = allow_shared(device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  }
  // the fewer of the single and the batched grid's CTAs a card holds
  int batched = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, region_kernel<Block>, kChunk,
                                                        shared_bytes(eq_scan::kMaxRun));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&batched, region_kernel<Row>, kChunk,
                                                        shared_bytes(eq_scan::kMaxRun));
  }
  *resident = (per_sm < batched ? per_sm : batched) * n_sm;
  return static_cast<int>(err);
}

// `batch` rows of one part of S samples (a positive multiple of 128, at most
// kMaxChunks chunks).  Every pointer is a device pointer: ops [n_words]
// int32 (the plan); slots [n_slots][2] int64, each slot's address and row
// stride in bytes (row b of the slot at address + b * stride; S elements a
// row; the operands first, n_operands of them; with seq == 0 the scratch
// slots are [batch][S] f32 buffers, the EQ's scratch slot 16-byte aligned,
// with seq == 1 unread); pf (row b at pf + b * pf_stride floats, n_pf
// param scalars), consts (the plan's constants), sf (row b at sf + b *
// sf_stride floats); taps [batch][n_taps][S], stap [batch][n_stap] and ef
// [batch][n_ef] are written.  With seq == 0 a cooperative grid of `tiles`
// x `batch` CTAs of `run` chunks each (a power of two, at most
// eq_scan::kMaxRun; every CTA of a row but the last full, the last holding
// the last chunk); with seq == 1 one CTA a row in tiles of `run` chunks,
// `tiles` unused.  The launch goes to card `device`.  Returns the launch's
// cudaError_t (0 = cudaSuccess); a cooperative grid larger than the card
// holds at once is refused by the launch.
int mixlab_region_part(const int* ops, int n_words, const long long* slots, int n_operands,
                       int n_slots, const float* pf, long long pf_stride, int n_pf,
                       const float* consts, const float* sf, long long sf_stride, float* taps,
                       int n_taps, float* stap, int n_stap, float* ef, int n_ef, int S, int batch,
                       int seq, int run, int tiles, int device, void* stream_ptr) {
  const int K = S / kChunk;
  bool bad = S <= 0 || S % kChunk != 0 || K > kMaxChunks || run < 1 ||
             run > eq_scan::kMaxRun || (run & (run - 1)) != 0 || batch < 1 ||
             n_operands < 0 || n_slots < n_operands;
  if (!seq) {
    bad = bad || batch > 65535 || tiles < 1 || tiles * run < K || (tiles - 1) * run >= K;
  } else {
    bad = bad || seq_shared_bytes(run, n_slots - n_operands) > kSeqShared;
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  cudaError_t err = allow_shared(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int lg = 0;
  while ((1 << lg) < run) ++lg;
  Part p{ops, n_words, slots, n_operands, pf, pf_stride, n_pf, consts, sf, sf_stride,
         taps, n_taps, stap, n_stap, ef, n_ef, S, K, lg};
  const cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  if (seq) {
    region_seq_kernel<<<batch, kChunk, seq_shared_bytes(run, n_slots - n_operands), st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&p};
  // one block whose constants follow its param scalars: the kernel without
  // the row offsets, as before the batch axis
  const void* kernel = batch == 1 && consts == pf + n_pf
                           ? reinterpret_cast<const void*>(region_kernel<Block>)
                           : reinterpret_cast<const void*>(region_kernel<Row>);
  err = cudaLaunchCooperativeKernel(kernel, dim3(tiles, batch), dim3(kChunk), args,
                                    shared_bytes(run), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
