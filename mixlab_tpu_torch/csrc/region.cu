// The whole-graph region of a patch (EqThree, everything downstream of it
// and the producers it absorbs) as ONE cooperative launch per part,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel built by mixlab_tpu/engine/pallas_graph.py
// (build_mega_program / _make_kernel, one pl.pallas_call per part of at most
// 192Ki samples).  Where the TPU kernel is traced per graph, this kernel is
// fixed: it walks a plan, the flat op list the region's modules emitted
// (mixlab_tpu_torch/dsp/base.py, OP_*), over slots, i.e. [S] buffers of the
// part whose device pointers arrive in a table.  No source is generated per
// graph, so nothing is built beyond this file.
//
// Layout: a CTA of 128 threads owns 128-sample chunks (chunk k belongs to
// CTA k % gridDim.x) and thread c owns sample k*128 + c of each chunk it
// visits.  Every elementwise op (FILL, AMP, AMP_MOD, MIX, I16, TAP) is then
// thread-local and runs with no barrier; each rounds as the JAX emit does,
// in its order (the library is built with -fmad=false, so a*b + c stays
// two roundings unless the source says fmaf).  PEAK is a block reduction of
// the bit patterns of |l|, |r| (for non-negative floats the unsigned order
// is the float order, and a NaN is above +inf, so it wins as jnp.max lets
// it) and one atomicMax per CTA; the scalar taps are zeroed by CTA 0 before
// the plan's first barrier.  SYNC is a grid-wide barrier
// (cooperative_groups::this_grid().sync(); the launch is cooperative and
// the grid sized by the occupancy query, so every CTA is resident).
//
// EQ (EqThree, src/module/eq_three.rs:117-124; the TPU body is
// mixlab_tpu/dsp/eq_pallas.py:_eq_body): per stage and band the one-pole
// recurrence y_i = a*y_{i-1} + b_i runs in 128-sample chunks as in
// csrc/eq_cascade.cu,
//   Z[k, i]  = sum_{j <= i} a^(i-j) * B[k, j]     (Toeplitz, f32 FMAs)
//   yend[k]  = a^128 * yend[k-1] + Z[k, 127]       (yend[-1] = the pole)
//   Y[k, i]  = Z[k, i] + a^(i+1) * yend[k-1],      B' = f * Y,
// then the band mix out = g_lo*lo + g_mid*(hi_lp - lo) + g_hi*(xd - hi_lp)
// with xd the input delayed by 3 samples (the first 3 from the state).  Its
// exits are the poles at the part's last sample and the last 3 inputs.  The
// plan puts a SYNC before each EQ (the delay reads the previous chunk); each
// stage ends with a grid-wide barrier after which every CTA scans the
// chunk-end values Z[k, 127] itself (a per-thread chain over ceil(K/128)
// chunks and a warp-shuffle scan of the segment maps (A, B): y -> A*y + B),
// so yend for every chunk sits in its shared memory without another
// barrier.  Z stays in place in one scratch slot per band.
//
// What bounds it on the card: at the 48 kHz flagship block (S = 48,000,
// 375 chunks) the function moves ~1.54 MB (six crossing operands in, one
// stereo tap out), 0.46 us at 3.35 TB/s, and its arithmetic is far below
// that; the Toeplitz form multiplies the eq's work by 64 (~49.5 MFLOP,
// still only ~0.74 us at 67 TFLOP/s f32).  The time goes to latency: four
// dependent stages, each a 128-step dependent FMA chain per thread, a
// grid-wide barrier and the redundant chunk-end scan, over a few hundred
// CTAs that each own one chunk (0.166 ms per launch on an NVIDIA H100
// 80GB HBM3 at 700 W, chip_smoke.py).  The design keeps every intermediate
// in L2-resident scratch and the whole region in one launch; spreading the
// Toeplitz chain over more threads per chunk is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "on_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 128;       // samples per chunk = threads per CTA
constexpr int kMaxChunks = 4096;  // region_cuda.MAX_CHUNKS

// op codes: mixlab_tpu_torch/dsp/base.py OP_*
enum Op : int {
  kSync = 0, kFill = 1, kAmp = 2, kAmpMod = 3, kMix = 4,
  kI16 = 5, kTap = 6, kPeak = 7, kEq = 8,
};

// eq table layout (floats, eq_cuda.kernel_tables + 3): tcol[2][128] = a_b^d,
// rowp[2][128] = a_b^(i+1), aC[2] = a_b^128, then f_lo, f_hi, vsa
constexpr int kTcol = 0;
constexpr int kRowp = 2 * kChunk;
constexpr int kAc = 4 * kChunk;
constexpr int kF = 4 * kChunk + 2;
constexpr int kVsa = 4 * kChunk + 4;

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
};

__device__ __forceinline__ float* slot(const Part& p, int s) {
  return reinterpret_cast<float*>(p.slots[s]);
}

// yend[k] for k < K of one band: the state at the end of each chunk, from
// the chunk-end zero-state values zl (written by every CTA before the last
// barrier, so read past L1) and the pole; every CTA computes all of them.
__device__ void carry_scan(const float* zl, int K, float aC, float pole, float* yend) {
  __shared__ float warp_a[kChunk / 32], warp_b[kChunk / 32];
  const int c = threadIdx.x, lane = c & 31, warp = c >> 5;
  const int per = (K + kChunk - 1) / kChunk;
  const int k0 = min(c * per, K), k1 = min(k0 + per, K);
  // this thread's chunks as one map y -> A*y + B
  float A = 1.0f, B = 0.0f;
  for (int k = k0; k < k1; ++k) {
    B = fmaf(aC, B, __ldcg(zl + k));
    A *= aC;
  }
  // inclusive scan over the warp; (earlier, later) composes to
  // (A_l * A_e, A_l * B_e + B_l)
  for (int off = 1; off < 32; off <<= 1) {
    const float Au = __shfl_up_sync(0xffffffffu, A, off);
    const float Bu = __shfl_up_sync(0xffffffffu, B, off);
    if (lane >= off) {
      B = fmaf(A, Bu, B);
      A *= Au;
    }
  }
  if (lane == 31) {
    warp_a[warp] = A;
    warp_b[warp] = B;
  }
  __syncthreads();
  float PA = 1.0f, PB = 0.0f;  // the earlier warps
  for (int w = 0; w < warp; ++w) {
    PB = fmaf(warp_a[w], PB, warp_b[w]);
    PA *= warp_a[w];
  }
  // exclusive: the earlier lanes of this warp after the earlier warps
  float Ae = __shfl_up_sync(0xffffffffu, A, 1);
  float Be = __shfl_up_sync(0xffffffffu, B, 1);
  if (lane == 0) {
    Ae = 1.0f;
    Be = 0.0f;
  }
  float y = fmaf(Ae * PA, pole, fmaf(Ae, PB, Be));  // y at the end of chunk k0-1
  for (int k = k0; k < k1; ++k) {
    y = fmaf(aC, y, __ldcg(zl + k));
    yend[k] = y;
  }
  __syncthreads();  // yend complete, warp_a / warp_b free
}

// a = [dst, x, z_lo, z_hi, zl, sf, p_gains, p_tab, ef, sample_rate]
__device__ void eq_op(const Part& p, const int* a, cg::grid_group& grid, float* yend) {
  __shared__ float tcol[2][kChunk];
  __shared__ float drive[kChunk];
  float* out = slot(p, a[0]);
  const float* x = slot(p, a[1]);
  float* Z[2] = {slot(p, a[2]), slot(p, a[3])};
  float* zl = slot(p, a[4]);
  const float* sf = p.sf + a[5];
  const float* g = p.pf + a[6];
  const float* tab = p.pf + a[7];
  float* ef = p.ef + a[8];
  const int c = threadIdx.x, S = p.S, K = p.K;

  tcol[0][c] = tab[kTcol + c];
  tcol[1][c] = tab[kTcol + kChunk + c];
  const float rowp[2] = {tab[kRowp + c], tab[kRowp + kChunk + c]};
  const float aC[2] = {tab[kAc], tab[kAc + 1]};
  const float f[2] = {tab[kF], tab[kF + 1]};
  const float vsa = tab[kVsa];
  __syncthreads();

  for (int s = 0; s < 4; ++s) {
    // the chunk-end values alternate between two halves of zl: a CTA may
    // start stage s+1 while another still scans stage s's values, and the
    // barrier that ends stage s+1 comes before stage s+2 reuses this half
    float* zs = zl + (s & 1) * 2 * K;
    for (int k = blockIdx.x; k < K; k += gridDim.x) {
      const int t = k * kChunk + c;
      for (int b = 0; b < 2; ++b) {
        float d;
        if (s == 0) {
          d = x[t] * f[b] + vsa;
        } else {  // finish stage s-1 at this sample, drive stage s
          const float yp = k == 0 ? sf[(s - 1) * 2 + b] : yend[b * K + k - 1];
          const float y = Z[b][t] + rowp[b] * yp;
          if (t == S - 1) ef[(s - 1) * 2 + b] = y;
          d = y * f[b];
        }
        drive[c] = d;
        __syncthreads();
        float z = 0.0f;
        for (int j = 0; j <= c; ++j) z = fmaf(tcol[b][c - j], drive[j], z);
        Z[b][t] = z;
        if (c == kChunk - 1) zs[b * K + k] = z;
        __syncthreads();  // drive is rewritten next
      }
    }
    grid.sync();
    for (int b = 0; b < 2; ++b) carry_scan(zs + b * K, K, aC[b], sf[s * 2 + b], yend + b * K);
  }

  // finish stage 4 and mix the bands
  for (int k = blockIdx.x; k < K; k += gridDim.x) {
    const int t = k * kChunk + c;
    float y[2];
    for (int b = 0; b < 2; ++b) {
      const float yp = k == 0 ? sf[6 + b] : yend[b * K + k - 1];
      y[b] = Z[b][t] + rowp[b] * yp;
      if (t == S - 1) ef[6 + b] = y[b];
    }
    const float xd = t >= 3 ? __ldcg(x + t - 3) : sf[8 + t];  // eq_three.rs:71-79
    out[t] = y[0] * g[0] + (y[1] - y[0]) * g[1] + (xd - y[1]) * g[2];
    if (t >= S - 3) ef[8 + t - (S - 3)] = x[t];
  }
}

__device__ void peak_op(const Part& p, const int* a) {
  __shared__ unsigned warp_max[kChunk / 32];
  const float* l = slot(p, a[1]);
  const float* r = slot(p, a[2]);
  unsigned m = 0u;
  for (int k = blockIdx.x; k < p.K; k += gridDim.x) {
    const int t = k * kChunk + threadIdx.x;
    m = max(m, __float_as_uint(fabsf(l[t])));
    m = max(m, __float_as_uint(fabsf(r[t])));
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

__global__ void __launch_bounds__(kChunk) region_kernel(Part p) {
  extern __shared__ float yend[];  // [2][K]
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
      continue;
    }
    if (code == kEq) {
      eq_op(p, a, grid, yend);
      continue;
    }
    if (code == kPeak) {
      peak_op(p, a);
      continue;
    }
    for (int k = blockIdx.x; k < p.K; k += gridDim.x) {
      const int t = k * kChunk + threadIdx.x;
      switch (code) {
        case kFill:
          slot(p, a[0])[t] = 0.0f + p.pf[a[1]];
          break;
        case kAmp:
          slot(p, a[0])[t] = slot(p, a[1])[t] * p.pf[a[2]];
          break;
        case kAmpMod: {
          const float amp = p.pf[a[3]], md = p.pf[a[4]];
          const float scale = ((1.0f - md) + md * slot(p, a[2])[t]) * amp;
          slot(p, a[0])[t] = slot(p, a[1])[t] * scale;
          break;
        }
        case kMix: {
          const int n = a[1];
          float acc = 0.0f;
          for (int j = 0; j < n; ++j) acc = acc + p.pf[a[2 + n + j]] * slot(p, a[2 + j])[t];
          slot(p, a[0])[t] = acc;
          break;
        }
        case kI16:
          slot(p, a[0])[t] =
              static_cast<float>(reinterpret_cast<const int16_t*>(p.slots[a[1]])[t]) *
              (1.0f / 32768.0f);
          break;
        case kTap:
          p.taps[static_cast<size_t>(a[0]) * p.S + t] = slot(p, a[1])[t];
          break;
        default:
          break;
      }
    }
  }
}

}  // namespace

extern "C" {

// One part of S samples (a positive multiple of 128, at most kMaxChunks
// chunks).  Every pointer is a device pointer: ops [n_words] int32 (the
// plan), slots [n_slots] int64 (one buffer of S elements each), pf, sf,
// taps [n_taps][S], stap [n_stap], ef [n_ef].  The launch goes to card
// `device`.  Returns the launch's cudaError_t (0 = cudaSuccess).
int mixlab_region_part(const int* ops, int n_words, const long long* slots, const float* pf,
                       const float* sf, float* taps, float* stap, int n_stap, float* ef,
                       int S, int device, void* stream_ptr) {
  if (S <= 0 || S % kChunk != 0 || S / kChunk > kMaxChunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  Part p{ops, n_words, slots, pf, sf, taps, stap, n_stap, ef, S, S / kChunk};
  const size_t smem = 2 * static_cast<size_t>(p.K) * sizeof(float);
  int n_sm = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, region_kernel, kChunk, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int grid = min(p.K, per_sm * n_sm);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(region_kernel), dim3(grid),
                                    dim3(kChunk), args, smem,
                                    static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
