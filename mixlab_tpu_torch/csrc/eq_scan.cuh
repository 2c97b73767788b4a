// EqThree's two 4-stage one-pole cascades and band mix over one block, as a
// scan over runs of samples: the core that csrc/eq_cascade.cu and the EQ op
// of csrc/region.cu share, hand-written for Hopper (sm_90a).
//
// It computes what mixlab_tpu/dsp/eq_pallas.py:_eq_body computes.  Per band
// b (420 Hz "lo", 2700 Hz "hi") with a = 1 - f, each sample runs the
// reference's four stages (src/module/eq_three.rs:117-124)
//   y_0 = a*y_0 + (x*f + vsa),  y_s = a*y_s + f*y_{s-1}   (s = 1..3, in order)
// so a band is one linear time-invariant system with a 4-value state.  Over
// a span of n samples its state maps as y -> A^n y + v, where A is the 4x4
// lower-triangular Toeplitz matrix A[i][j] = a*f^(i-j) (kept as its first
// column: products of such matrices are such matrices) and v is the span's
// response from zero state.  So the whole cascade needs one carry per block:
//   pass 1 - each thread runs its run of L consecutive samples from zero
//            state, both bands, all stages, in registers: v (8 floats);
//   scan   - the runs compose as (earlier u, later v) -> A^(L*m) u + v, m
//            the later span's runs: a warp-shuffle scan, a scan of the warp
//            totals, the CTA's aggregate to a scratch; after ONE grid barrier
//            warp 0 folds the aggregates of the CTAs before its own into the
//            CTA's true entry state;
//   pass 2 - each thread reruns its L samples from its true entry state,
//            writes the band mix lo*g_lo + (hi_lp - lo)*g_mid + (xd - hi_lp)*g_hi
//            and, where it holds sample S-1, the 8 poles.
// Every power the scan needs is A^(L*2^r) or a product of such: the table
// holds A^(2^k) for k < kPowers, computed in float64 on the host
// (eq_cuda.kernel_tables), and L and the CTA size are powers of two.  The
// work is O(S) (pass 1, pass 2, log-depth scans); the products stay IEEE f32
// on the FMA units with each multiply and add rounded on its own (the
// library is built with -fmad=false; the reference asks for
// Precision.HIGHEST, and no product here is large enough for tensor cores).
//
// Layout: a CTA of T threads owns a tile of T*L consecutive samples; thread
// k's run is the tile's samples [k*L, k*L + L), staged in shared memory at
// k*(L+1) (an odd stride: a warp's lanes read distinct banks), as
// csrc/envelope.cu stages its tiles, here from 16-byte global loads.  Samples
// past S read 0 and write nothing.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace eq_scan {

// table layout (floats; eq_cuda.TABLE_*): a_b at kA + b, then the first
// column of A_b^(2^k) at kPow + (2*k + b)*4 for k < kPowers
constexpr int kA = 0;
constexpr int kPow = 4;
constexpr int kPowers = 32;
constexpr int kTable = kPow + kPowers * 2 * 4;
constexpr int kMaxRun = 32;       // eq_cuda.MAX_RUN
constexpr int kMaxThreads = 512;  // the most threads a CTA of the scan
constexpr int kMaxWarps = kMaxThreads / 32;

// shared-memory floats of the staged tile (x and xd) for T threads of run L
__host__ __device__ constexpr size_t tile_floats(int threads, int run) {
  return 2 * static_cast<size_t>(threads) * (run + 1);
}

struct State {
  float y[2][4];  // [band][stage]
};

struct Shared {  // the core's static shared memory
  float tab[kTable];
  float warp[kMaxWarps][8];
  float entry[8];
};

__device__ __forceinline__ State zero_state() {
  State s;
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) s.y[b][i] = 0.0f;
  return s;
}

__device__ __forceinline__ State load_state(const float* p) {
  State s;
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) s.y[b][i] = p[b * 4 + i];
  return s;
}

__device__ __forceinline__ void store_state(float* p, const State& s) {
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[b * 4 + i] = s.y[b][i];
}

// poles [4][2], stage-major, as a state
__device__ __forceinline__ State load_poles(const float* p) {
  State s;
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) s.y[b][i] = p[i * 2 + b];
  return s;
}

// o = C y, C lower-triangular Toeplitz with first column c; row i sums
// c[i]*y[0] + c[i-1]*y[1] + ... + c[0]*y[i] left to right
__device__ __forceinline__ void mv(const float* c, const float* y, float* o) {
  o[0] = c[0] * y[0];
  o[1] = c[1] * y[0] + c[0] * y[1];
  o[2] = c[2] * y[0] + c[1] * y[1] + c[0] * y[2];
  o[3] = c[3] * y[0] + c[2] * y[1] + c[1] * y[2] + c[0] * y[3];
}

__device__ __forceinline__ const float* power(const float* tab, int k, int b) {
  return tab + kPow + (2 * k + b) * 4;
}

// v += A^(2^k) u: an earlier span's state u carried through a later span of
// 2^k samples whose zero-state result is v
__device__ __forceinline__ void absorb(State& v, const State& u, const float* tab, int k) {
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    float o[4];
    mv(power(tab, k, b), u.y[b], o);
#pragma unroll
    for (int i = 0; i < 4; ++i) v.y[b][i] = o[i] + v.y[b][i];
  }
}

// M <- A^(2^(k0+k)) M for each set bit k < bits of n, in increasing k
__device__ __forceinline__ void apply_bits(State& M, int n, const float* tab, int k0, int bits) {
  for (int k = 0; k < bits; ++k) {
    if ((n >> k) & 1) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float o[4];
        mv(power(tab, k0 + k, b), M.y[b], o);
#pragma unroll
        for (int i = 0; i < 4; ++i) M.y[b][i] = o[i];
      }
    }
  }
}

// y = M s + e per band (M a power column pair)
__device__ __forceinline__ State affine(const State& M, const State& s, const State& e) {
  State o;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    float t[4];
    mv(M.y[b], s.y[b], t);
#pragma unroll
    for (int i = 0; i < 4; ++i) o.y[b][i] = t[i] + e.y[b][i];
  }
  return o;
}

__device__ __forceinline__ State shfl_up(const State& v, int d) {
  State o;
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) o.y[b][i] = __shfl_up_sync(0xffffffffu, v.y[b][i], d);
  return o;
}

struct Coeffs {
  float a[2], f[2], vsa;
};

// one sample of both cascades
__device__ __forceinline__ void step(State& s, float x, const Coeffs& c) {
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    float d = x * c.f[b] + c.vsa;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s.y[b][i] = c.a[b] * s.y[b][i] + d;
      d = c.f[b] * s.y[b][i];
    }
  }
}

// the staged position of tile sample j for runs of 2^lg
__device__ __forceinline__ int pos(int j, int lg) { return j + (j >> lg); }

// Tile samples [tile0, tile0 + blockDim.x << lg) of src into dst at the
// staged positions; past S reads 0.  16-byte loads when src is 16-byte
// aligned (tile0 is a multiple of 4); through L2 only (kL2) when the data
// was written earlier in the same launch.
template <bool kL2>
__device__ __forceinline__ void stage(const float* src, int S, int tile0, int lg, float* dst) {
  const int n4 = (static_cast<int>(blockDim.x) << lg) >> 2;
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
#pragma unroll 2
  for (int q = threadIdx.x; q < n4; q += blockDim.x) {
    const int j = q * 4, s = tile0 + j;
    float v[4];
    if (vec && s + 3 < S) {
      const float4* p = reinterpret_cast<const float4*>(src + s);
      const float4 w = kL2 ? __ldcg(p) : __ldg(p);
      v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = s + e < S ? (kL2 ? __ldcg(src + s + e) : __ldg(src + s + e)) : 0.0f;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[pos(j + e, lg)] = v[e];
  }
}

// the staged tile back to dst [tile0, min(tile0 + blockDim.x << lg, S))
__device__ __forceinline__ void unstage(const float* src, int S, int tile0, int lg, float* dst) {
  const int n4 = (static_cast<int>(blockDim.x) << lg) >> 2;
  const bool vec = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  for (int q = threadIdx.x; q < n4; q += blockDim.x) {
    const int j = q * 4, s = tile0 + j;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = src[pos(j + e, lg)];
    if (vec && s + 3 < S) {
      *reinterpret_cast<float4*>(dst + s) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (s + e < S) dst[s + e] = v[e];
      }
    }
  }
}

// the table into shared memory and the coefficients out of it; every thread
// calls it, and a __syncthreads must follow before sh.tab is read
__device__ __forceinline__ void load_table(const float* tab, Shared& sh) {
  for (int j = threadIdx.x; j < kTable; j += blockDim.x) sh.tab[j] = __ldg(tab + j);
}

// What a thread keeps across the grid barrier
struct Entry {
  State E;  // its entry state from zero state at the CTA's start
  State M;  // A^(L * threadIdx.x), the map of the CTA's start to its entry
};

// Before the grid barrier; every thread of the CTA calls it.  Pass 1 over
// the thread's run (xs staged, lg = log2 L), the CTA's scan, the CTA's
// aggregate to agg[blockIdx.x] (8 floats, 16-byte aligned) unless agg is
// null (a CTA that carries its own entry state reads no aggregate).
// The maps scan_up builds from the table, which hold for every tile of a
// launch: A^(L * lane) and A^(L * threadIdx.x)
struct Maps {
  State lane, thread;
};

__device__ __forceinline__ Maps thread_maps(const float* tab, int lg) {
  const int i = threadIdx.x, W = blockDim.x >> 5;
  Maps m;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    m.lane.y[b][0] = 1.0f;
    m.lane.y[b][1] = m.lane.y[b][2] = m.lane.y[b][3] = 0.0f;
  }
  apply_bits(m.lane, i & 31, tab, lg, 5);
  m.thread = m.lane;
  apply_bits(m.thread, i >> 5, tab, lg + 5, __ffs(W) - 1);
  return m;
}

// With `maps` (thread_maps of the table in sh.tab), scan_up takes them
// instead of building them (the batched rows forms of csrc/region.cu).
template <bool kMaps = false>
__device__ __forceinline__ Entry scan_up(const float* xs, int lg, const Coeffs& c,
                                         Shared& sh, float* agg, const Maps* maps = nullptr) {
  const int i = threadIdx.x, lane = i & 31, w = i >> 5;
  const int W = blockDim.x >> 5;
  const int L = 1 << lg;
  const float* tab = sh.tab;
  const float* mine = xs + pos(i << lg, lg);

  State v = zero_state();
  for (int j = 0; j < L; ++j) step(v, mine[j], c);

  // inclusive scan over the warp's runs
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const State up = shfl_up(v, 1 << r);
    if (lane >= (1 << r)) absorb(v, up, tab, lg + r);
  }
  State e = shfl_up(v, 1);  // exclusive: the earlier lanes of the warp
  if (lane == 0) e = zero_state();
  if (lane == 31) store_state(sh.warp[w], v);
  __syncthreads();
  if (w == 0) {  // inclusive scan over the warp totals
    State t = lane < W ? load_state(sh.warp[lane]) : zero_state();
    for (int r = 0; (1 << r) < W; ++r) {
      const State up = shfl_up(t, 1 << r);
      if (lane >= (1 << r)) absorb(t, up, tab, lg + 5 + r);
    }
    if (lane < W) store_state(sh.warp[lane], t);
    if (agg != nullptr && lane == W - 1) {
      float4* p = reinterpret_cast<float4*>(agg + 8 * blockIdx.x);
      p[0] = make_float4(t.y[0][0], t.y[0][1], t.y[0][2], t.y[0][3]);
      p[1] = make_float4(t.y[1][0], t.y[1][1], t.y[1][2], t.y[1][3]);
    }
  }
  __syncthreads();
  const State ew = w > 0 ? load_state(sh.warp[w - 1]) : zero_state();

  Entry out;
  if constexpr (kMaps) {
    out.E = affine(maps->lane, ew, e);
    out.M = maps->thread;
    return out;
  }
  State M;  // A^(L * lane), then A^(L * i)
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    M.y[b][0] = 1.0f;
    M.y[b][1] = M.y[b][2] = M.y[b][3] = 0.0f;
  }
  apply_bits(M, lane, tab, lg, 5);
  out.E = affine(M, ew, e);
  apply_bits(M, w, tab, lg + 5, __ffs(W) - 1);
  out.M = M;
  return out;
}

// After the grid barrier; every thread of the CTA calls it.  Warp 0 folds
// the aggregates of the CTAs before this one (written before the barrier,
// read through L2) into the CTA's entry state, the block's poles0 [4][2]
// before the first; each thread then reruns its run from its entry, writes
// the band mix over xs (xds the staged delayed input) and, where it holds
// sample S-1, the poles [4][2] to poles_out and, if hist_out, the last 3
// inputs to hist_out.
__device__ __forceinline__ void scan_down(float* xs, const float* xds, int S, int tile0, int lg,
                                          const Coeffs& c, const float* gains, Shared& sh,
                                          const float* agg, const float* poles0,
                                          const Entry& en, float* poles_out, float* hist_out) {
  const int i = threadIdx.x, lane = i & 31;
  const int L = 1 << lg;
  const int ltile = lg + __ffs(blockDim.x) - 1;  // log2 of the tile's samples
  const float* tab = sh.tab;
  if (i < 32) {
    // the elements -1 (the block's poles), 0 .. cta-1 (the aggregates):
    // q = 2^lq a lane, the last lane ending at the CTA, so every lane
    // after another covers q whole tiles
    const int cta = blockIdx.x;
    int lq = 0;
    while ((32 << lq) < cta + 1) ++lq;
    const int q = 1 << lq;
    const int start = cta - (32 - lane) * q;
    State y = start <= -1 && start + q > -1 ? load_poles(poles0) : zero_state();
    for (int t = max(start, 0); t < start + q; ++t) {
      const float4* p = reinterpret_cast<const float4*>(agg + 8 * t);
      const float4 lo = __ldcg(p), hi = __ldcg(p + 1);
      State a;
      a.y[0][0] = lo.x, a.y[0][1] = lo.y, a.y[0][2] = lo.z, a.y[0][3] = lo.w;
      a.y[1][0] = hi.x, a.y[1][1] = hi.y, a.y[1][2] = hi.z, a.y[1][3] = hi.w;
      absorb(a, y, tab, ltile);
      y = a;
    }
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const State up = shfl_up(y, 1 << r);
      if (lane >= (1 << r)) absorb(y, up, tab, ltile + lq + r);
    }
    if (lane == 31) store_state(sh.entry, y);
  }
  __syncthreads();
  State s = affine(en.M, load_state(sh.entry), en.E);

  const float g0 = __ldg(gains), g1 = __ldg(gains + 1), g2 = __ldg(gains + 2);
  float* mine = xs + pos(i << lg, lg);
  const float* mine_d = xds + pos(i << lg, lg);
  const int base = tile0 + (i << lg);
  for (int j = 0; j < L; ++j) {
    const int t = base + j;
    if (t >= S) break;
    const float x = mine[j];
    step(s, x, c);
    const float lo = s.y[0][3], hi = s.y[1][3];
    mine[j] = lo * g0 + (hi - lo) * g1 + (mine_d[j] - hi) * g2;
    if (hist_out && t >= S - 3) hist_out[t - (S - 3)] = x;
    if (t == S - 1) {
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int k = 0; k < 4; ++k) poles_out[k * 2 + b] = s.y[b][k];
    }
  }
}

// Pass 2 of a tile whose entry state s the CTA was handed (csrc/region.cu's
// batched forms): scan_down's rerun, band mix and, unless poles_out is null,
// the poles at sample S-1, from s.
__device__ __forceinline__ void run_down(float* xs, const float* xds, int S, int tile0, int lg,
                                         const Coeffs& c, const float* gains, State s,
                                         float* poles_out) {
  const int L = 1 << lg;
  const float g0 = __ldg(gains), g1 = __ldg(gains + 1), g2 = __ldg(gains + 2);
  float* mine = xs + pos(threadIdx.x << lg, lg);
  const float* mine_d = xds + pos(threadIdx.x << lg, lg);
  const int base = tile0 + (threadIdx.x << lg);
  for (int j = 0; j < L; ++j) {
    const int t = base + j;
    if (t >= S) break;
    step(s, mine[j], c);
    const float lo = s.y[0][3], hi = s.y[1][3];
    mine[j] = lo * g0 + (hi - lo) * g1 + (mine_d[j] - hi) * g2;
    if (poles_out != nullptr && t == S - 1) {
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int k = 0; k < 4; ++k) poles_out[k * 2 + b] = s.y[b][k];
    }
  }
}

// poles [4][2] (stage-major) from a state
__device__ __forceinline__ void store_poles(float* p, const State& s) {
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i * 2 + b] = s.y[b][i];
}

}  // namespace eq_scan
