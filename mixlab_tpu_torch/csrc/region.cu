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
  const long long* slots;  // device pointer per slot
  const float* pf;         // param scalars, then the plan's constants
  const float* sf;         // state scalars (layout == exits)
  float* taps;             // [n_taps][S]
  float* stap;             // [n_stap]
  int n_stap;
  float* ef;               // exits
  int S;
  int K;                   // S / 128
  int lg;                  // log2 of the chunks a CTA owns (the EQ's run)
};

__device__ __forceinline__ float* slot(const Part& p, int s) {
  return reinterpret_cast<float*>(p.slots[s]);
}

// a = [dst, x, agg, sf, p_gains, p_tab, ef, sample_rate]; `tile` is the
// dynamic shared memory (eq_scan::tile_floats(128, L) floats)
__device__ void eq_op(const Part& p, const int* a, cg::grid_group& grid, float* tile) {
  __shared__ eq_scan::Shared sh;
  float* out = slot(p, a[0]);
  const float* x = slot(p, a[1]);
  float* agg = slot(p, a[2]);
  const float* sf = p.sf + a[3];
  const float* tab = p.pf + a[5];
  float* ef = p.ef + a[6];
  const int S = p.S, lg = p.lg;
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
  eq_scan::scan_down(xs, xds, S, tile0, lg, c, p.pf + a[4], sh, agg, sf, en, ef, ef + 8);
  __syncthreads();
  eq_scan::unstage(xs, S, tile0, lg, out);
  __syncthreads();  // the next ops read `out` thread by thread
}

// the chunks of this CTA: [k0, k0 + n)
struct Chunks {
  int k0, n;
};

__device__ __forceinline__ Chunks my_chunks(const Part& p) {
  const int k0 = blockIdx.x << p.lg;
  return Chunks{k0, max(0, min(1 << p.lg, p.K - k0))};
}

__device__ void peak_op(const Part& p, const int* a) {
  __shared__ unsigned warp_max[kChunk / 32];
  const float* l = slot(p, a[1]);
  const float* r = slot(p, a[2]);
  const Chunks ch = my_chunks(p);
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
    atomicMax(reinterpret_cast<unsigned*>(p.stap) + a[0], m);
  }
  __syncthreads();  // warp_max is free again
}

// One elementwise op over this thread's samples of the CTA's chunks,
// kBatch chunks at a time: every load of a batch before its first store.
__device__ void elementwise_op(const Part& p, int code, const int* a) {
  const Chunks ch = my_chunks(p);
  for (int u0 = 0; u0 < ch.n; u0 += kBatch) {
    const int t0 = (ch.k0 + u0) * kChunk + threadIdx.x;
    const int m = min(kBatch, ch.n - u0);
    float v[kBatch];
    switch (code) {
      case kFill: {
        const float val = 0.0f + p.pf[a[1]];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) slot(p, a[0])[t0 + u * kChunk] = val;
        }
        break;
      }
      case kAmp: {
        const float* src = slot(p, a[1]);
        const float amp = p.pf[a[2]];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) v[u] = src[t0 + u * kChunk];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) slot(p, a[0])[t0 + u * kChunk] = v[u] * amp;
        }
        break;
      }
      case kAmpMod: {
        const float* src = slot(p, a[1]);
        const float* mod = slot(p, a[2]);
        const float amp = p.pf[a[3]], md = p.pf[a[4]];
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
            slot(p, a[0])[t0 + u * kChunk] = v[u] * scale;
          }
        }
        break;
      }
      case kMix: {
        const int n = a[1];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) v[u] = 0.0f;
        for (int j = 0; j < n; ++j) {
          const float* src = slot(p, a[2 + j]);
          const float w = p.pf[a[2 + n + j]];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (u < m) v[u] = v[u] + w * src[t0 + u * kChunk];
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) slot(p, a[0])[t0 + u * kChunk] = v[u];
        }
        break;
      }
      case kI16: {
        const int16_t* src = reinterpret_cast<const int16_t*>(p.slots[a[1]]);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) v[u] = static_cast<float>(src[t0 + u * kChunk]) * (1.0f / 32768.0f);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) slot(p, a[0])[t0 + u * kChunk] = v[u];
        }
        break;
      }
      case kTap: {
        const float* src = slot(p, a[1]);
        float* dst = p.taps + static_cast<size_t>(a[0]) * p.S;
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

__global__ void __launch_bounds__(kChunk) region_kernel(Part p) {
  extern __shared__ float tile[];  // the EQ's staged tile
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0) {
    for (int j = threadIdx.x; j < p.n_stap; j += kChunk) p.stap[j] = 0.0f;
  }
  for (int pc = 0; pc < p.n_words;) {
    const int code = p.ops[pc];
    const int len = p.ops[pc + 1];
    const int* a = p.ops + pc + 2;
    pc += len;
    if (code == kSync) {
      grid.sync();
    } else if (code == kEq) {
      eq_op(p, a, grid, tile);
    } else if (code == kPeak) {
      peak_op(p, a);
    } else {
      elementwise_op(p, code, a);
    }
  }
}

size_t shared_bytes(int run) { return eq_scan::tile_floats(kChunk, run) * sizeof(float); }

cudaError_t allow_shared(int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(region_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(shared_bytes(eq_scan::kMaxRun)));
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

}  // namespace

extern "C" {

// CTAs of the region kernel that one card holds at once at the longest run,
// into *resident; the wrapper sizes its grid by it.  Returns a cudaError_t
// (0 = cudaSuccess).
int mixlab_region_resident_tiles(int device, int* resident) {
  *resident = 0;
  OnDevice on(device);
  cudaError_t err = on.error();
  int n_sm = 0, per_sm = 0;
  if (err == cudaSuccess) err = allow_shared(device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, region_kernel, kChunk,
                                                        shared_bytes(eq_scan::kMaxRun));
  }
  *resident = per_sm * n_sm;
  return static_cast<int>(err);
}

// One part of S samples (a positive multiple of 128, at most kMaxChunks
// chunks) in `tiles` CTAs of `run` chunks each (a power of two, at most
// eq_scan::kMaxRun; every CTA but the last full, the last holding the last
// chunk).  Every pointer is a device pointer: ops [n_words] int32 (the
// plan), slots [n_slots] int64 (one buffer of S elements each, the EQ's
// scratch slot 16-byte aligned), pf, sf, taps [n_taps][S], stap [n_stap],
// ef [n_ef].  The launch goes to card `device`.  Returns the launch's
// cudaError_t (0 = cudaSuccess).
int mixlab_region_part(const int* ops, int n_words, const long long* slots, const float* pf,
                       const float* sf, float* taps, float* stap, int n_stap, float* ef,
                       int S, int run, int tiles, int device, void* stream_ptr) {
  const int K = S / kChunk;
  if (S <= 0 || S % kChunk != 0 || K > kMaxChunks || run < 1 || run > eq_scan::kMaxRun ||
      (run & (run - 1)) != 0 || tiles < 1 || tiles * run < K || (tiles - 1) * run >= K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  cudaError_t err = allow_shared(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int lg = 0;
  while ((1 << lg) < run) ++lg;
  Part p{ops, n_words, slots, pf, sf, taps, stap, n_stap, ef, S, K, lg};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(region_kernel), dim3(tiles),
                                    dim3(kChunk), args, shared_bytes(run),
                                    static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
