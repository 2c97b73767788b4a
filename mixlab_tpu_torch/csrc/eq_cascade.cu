// EqThree's two 4-stage one-pole cascades and band mix, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mixlab_tpu/dsp/eq_pallas.py (eq_cascade_pallas /
// _eq_body).  Per stage and band (420 Hz "lo", 2700 Hz "hi") the reference
// recurrence y_i = a*y_{i-1} + b_i (src/module/eq_three.rs:117-124) is solved
// in 128-sample chunks:
//   Z[k, i]  = sum_{j <= i} T[i - j] * B[k, j]     (zero-state chunk response,
//                                                   T[d] = a^d, f32 FMAs)
//   yend[k]  = aC * yend[k-1] + Z[k, 127]          (chunk-end carry, aC = a^128,
//                                                   yend[-1] = the stage's pole)
//   Y[k, i]  = Z[k, i] + a^(i+1) * yend[k-1]
//   B'       = f * Y                               (next stage's drive)
// and after stage 4 the bands mix: out = g_lo*lo + g_mid*(hi_lp - lo)
// + g_hi*(xd - hi_lp).  The exported poles are Y at sample S-1, not at the
// padded end.  The tables are the JAX package's (computed in f64, stored f32).
//
// What bounds it on the card: the Toeplitz products are the work, 128*S/2
// multiply-adds per stage and band (~23 MFLOP per stage at S = 44,100); the
// traffic is ~2 reads and writes of the block per stage, a few MB that stay
// in L2.  Neither is near the card's limits; what costs time is the chain of
// dependencies: every stage needs the carry across all chunks before it can
// start the next stage.  The design splits there: five launches on one
// stream (stage 1, stages 2-4 each fused with the previous stage's carry, and
// the mix fused with stage 4's carry), each spread over ceil(K/CPB) x 2
// blocks of 128 threads so all SMs work on the products.  Each block redoes
// the short carry chain for the chunks before its own (one thread, <= K
// FMAs from shared memory) rather than waiting on the others.  Products stay
// in IEEE f32 on the FMA units (the reference asks for Precision.HIGHEST;
// TF32 tensor cores would keep ~3 digits).  Intermediates go to a scratch
// buffer the caller allocates.

#include <cuda_runtime.h>

#include "on_device.cuh"

namespace {

constexpr int kChunk = 128;        // samples per chunk = threads per block
constexpr int kMaxChunks = 3072;   // 384 Ki samples per launch (split above)

// device table layout (floats): tcol[2][128] = a_b^d (d = i - j),
// rowp[2][128] = a_b^(i+1), aC[2] = a_b^128
constexpr int kTcol = 0;
constexpr int kRowp = 2 * kChunk;
constexpr int kAc = 4 * kChunk;

struct Scratch {
  float* z;      // [2 bands][K * 128]
  float* zlast;  // [2 bands][K]
};

// y at the end of chunk `upto - 1` (the pole if upto == 0), for one band;
// every thread of the block gets it
__device__ float carry_into(const float* zlast, int upto, float aC, float pole,
                           float* zl_smem) {
  __shared__ float y_sh;
  for (int j = threadIdx.x; j < upto; j += kChunk) zl_smem[j] = zlast[j];
  __syncthreads();
  if (threadIdx.x == 0) {
    float y = pole;
#pragma unroll 8
    for (int j = 0; j < upto; ++j) y = fmaf(aC, y, zl_smem[j]);
    y_sh = y;
  }
  __syncthreads();
  const float y = y_sh;
  __syncthreads();  // zl_smem and y_sh may be reused after this
  return y;
}

// Stage s (0..3) of band blockIdx.y over chunks [blockIdx.x*cpb, +cpb).
// s == 0 drives from x; s > 0 first finishes stage s-1 (carry, Y, pole) and
// drives from f * Y.
__global__ void __launch_bounds__(kChunk)
eq_stage_kernel(const float* __restrict__ x, int S, int K, int cpb, int s,
                Scratch in, Scratch out, const float* __restrict__ poles0,
                float* __restrict__ poles_out, const float* __restrict__ tables,
                float f_lo, float f_hi, float vsa) {
  __shared__ float tcol[kChunk];
  __shared__ float B[kChunk];
  __shared__ float zl[kMaxChunks];

  const int b = blockIdx.y;
  const int i = threadIdx.x;
  const int k0 = blockIdx.x * cpb;
  const int k1 = min(k0 + cpb, K);
  const float f = b ? f_hi : f_lo;
  const float aC = tables[kAc + b];
  const float rowp = tables[kRowp + b * kChunk + i];
  tcol[i] = tables[kTcol + b * kChunk + i];
  __syncthreads();

  float yprev = 0.0f;
  if (s > 0) yprev = carry_into(in.zlast + b * K, k0, aC, poles0[(s - 1) * 2 + b], zl);

  for (int k = k0; k < k1; ++k) {
    const int t = k * kChunk + i;
    if (s == 0) {
      B[i] = (t < S ? x[t] : 0.0f) * f + vsa;
    } else {
      const float y = in.z[b * K * kChunk + t] + rowp * yprev;
      if (t == S - 1) poles_out[(s - 1) * 2 + b] = y;
      B[i] = y * f;
      yprev = fmaf(aC, yprev, in.zlast[b * K + k]);  // carry into chunk k+1
    }
    __syncthreads();
    float z = 0.0f;
    for (int j = 0; j <= i; ++j) z = fmaf(tcol[i - j], B[j], z);
    out.z[b * K * kChunk + t] = z;
    if (i == kChunk - 1) out.zlast[b * K + k] = z;
    __syncthreads();  // B is rewritten for the next chunk
  }
}

// Finishes stage 4 for both bands (carry, Y, poles) and mixes the bands.
__global__ void __launch_bounds__(kChunk)
eq_mix_kernel(const float* __restrict__ xd, float* __restrict__ y_out, int S, int K,
              int cpb, Scratch in, const float* __restrict__ poles0,
              float* __restrict__ poles_out, const float* __restrict__ gains,
              const float* __restrict__ tables) {
  __shared__ float zl[kMaxChunks];
  const int i = threadIdx.x;
  const int k0 = blockIdx.x * cpb;
  const int k1 = min(k0 + cpb, K);
  float yp[2], rowp[2], aC[2];
  for (int b = 0; b < 2; ++b) {
    aC[b] = tables[kAc + b];
    rowp[b] = tables[kRowp + b * kChunk + i];
    yp[b] = carry_into(in.zlast + b * K, k0, aC[b], poles0[3 * 2 + b], zl);
  }
  const float g_lo = gains[0], g_mid = gains[1], g_hi = gains[2];
  for (int k = k0; k < k1; ++k) {
    const int t = k * kChunk + i;
    float y[2];
    for (int b = 0; b < 2; ++b) {
      y[b] = in.z[b * K * kChunk + t] + rowp[b] * yp[b];
      if (t == S - 1) poles_out[3 * 2 + b] = y[b];
      yp[b] = fmaf(aC[b], yp[b], in.zlast[b * K + k]);
    }
    if (t < S) {
      const float lo = y[0], hi_lp = y[1];
      y_out[t] = lo * g_lo + (hi_lp - lo) * g_mid + (xd[t] - hi_lp) * g_hi;
    }
  }
}

}  // namespace

extern "C" {

// One EqThree block: x, xd [S] (xd = the 3-sample-delayed input), poles0
// [4][2] (stage-major, band-minor), gains [3] and tables [4*128 + 2] (see
// kTcol/kRowp/kAc) are device pointers; out [S] and poles_out [4][2] are
// written.  `scratch` is a device buffer of 2 * 2 * (K*128 + K) floats,
// K = ceil(S / 128) <= 3072.  The launches go to card `device`.  Returns
// cudaGetLastError() after the launches (0 = cudaSuccess).
int mixlab_eq_cascade(const float* x, const float* xd, int S, const float* poles0,
                      const float* gains, const float* tables, float f_lo, float f_hi,
                      float vsa, float* scratch, float* out, float* poles_out,
                      int device, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int K = (S + kChunk - 1) / kChunk;
  if (S < 1 || K > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  const size_t slot = 2 * (static_cast<size_t>(K) * kChunk + K);
  Scratch buf[2];
  for (int q = 0; q < 2; ++q) {
    buf[q].z = scratch + q * slot;
    buf[q].zlast = buf[q].z + 2 * static_cast<size_t>(K) * kChunk;
  }
  // ~1 block per SM and band on a 132-SM card
  const int cpb = (K + 127) / 128;
  const int nblk = (K + cpb - 1) / cpb;
  for (int s = 0; s < 4; ++s) {
    eq_stage_kernel<<<dim3(nblk, 2), kChunk, 0, stream>>>(
        x, S, K, cpb, s, buf[(s + 1) & 1], buf[s & 1], poles0, poles_out, tables,
        f_lo, f_hi, vsa);
  }
  eq_mix_kernel<<<nblk, kChunk, 0, stream>>>(xd, out, S, K, cpb, buf[1], poles0,
                                             poles_out, gains, tables);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
