// Polyphase Mitchell-bicubic resize of a picture's planes, both axes in one
// launch, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mixlab_tpu/video/resize_pallas.py (_axis0_kernel /
// _resize_axis0), which resize_plane_pallas calls once per resized axis.
// For a ratio n_out/n_in = L/M along an axis (L <= 16 phases, J <= 12 taps;
// mixlab_tpu_torch/video/resize_cuda.py:_phase_plan), output o = q*L + p
// along that axis is
//   sum over the phase's nonzero taps j, ascending, of
//     w[p][j] * x[clamp(q*M + base[p] + j, 0, n_in - 1)]
// (the clamp is the TPU kernel's edge padding).  The sum is f32 in tap
// order: the first term a plain product, each later one fmaf(w, x, acc),
// which is how XLA's CPU backend evaluates the TPU kernel in interpret mode
// (it contracts acc + w*x into one FMA); the library is built with
// -fmad=false, so only the fmaf written here fuses.  A plane resized on both
// axes takes the row pass (f32 sums rounded to bf16, as
// __float2bfloat16_rn) and then the column pass over those values; the last
// pass of a plane rounds its sum to bf16, then half to even (as rintf,
// torch.round and jnp.round) and clamps to [0, 255] into u8.  No tensor
// cores: a wgmma would change the order and the rounding of the sums.
//
// What bounds it on the card: bytes.  The function reads the u8 planes and
// writes the u8 planes: a 720p -> 1080p yuv420p picture is 1,382,400 B in
// and 3,110,400 B out, 4,492,800 B or 1.34 us at 3.35 TB/s; config 5's
// 540p -> 1080p frame 3,888,000 B or 1.16 us.  Its ~5-9 multiply-adds per
// output are far below the card's rate; what the design spends is
// instructions and latency.  Design:
//   * one launch per picture: a single grid over the 32 x 128 output tiles
//     of up to three planes (a plane whose size does not change is left to
//     the wrapper, which clones it); a plane with one resized axis runs only
//     that axis's pass.  The planes' sizes and bases come by value
//     (__grid_constant__), so a block issues its loads at once;
//   * one CTA per output tile, both passes in it, nothing between them in
//     device memory: the u8 input window the tile needs (rows
//     [start(r0), start(r_last) + J) by 16-aligned columns
//     [start(c0) & ~15, ...), indices clamped at the plane's edges) is staged
//     into shared memory by 16-byte cp.async where a chunk lies inside the
//     plane, then widened once to bf16 (exact for u8); the row pass reads
//     four neighbouring values per tap as one 8-byte word and writes the
//     bf16-rounded sums of two output rows side by side as f32 pairs; the
//     column pass, a thread per output column, reads both rows of a pair
//     per tap as one 8-byte word; the outputs gather in a shared tile that
//     leaves in 16-byte stores (bytes at a ragged edge).  Halo columns are
//     computed by both neighbouring CTAs, the same way, so the result does
//     not depend on which CTA ran;
//   * no divide per output: the wrapper uploads, once per geometry, a table
//     per plane (per axis the bases, nonzero-tap counts, tap offsets and
//     weights of every phase; _picture_table in the wrapper), which each CTA
//     copies into shared memory beside a per-tile table of each output row's
//     and column's phase and window offset (one divide per table entry); a
//     thread holds its phase's taps in registers while it sums;
//   * no conversion instructions (16 results per clock on an SM, against
//     128 f32 multiply-adds):
//     bytes become f32 by a byte permute and a subtraction, sums become bf16
//     and bytes by integer rounding and a 1.5 * 2^23 offset, all exact.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "on_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;
constexpr int kTileCols = 128;  // kThreads / kTileCols threads share a column in the column pass
constexpr int kMaxPhases = 16;
constexpr int kMaxTaps = 12;
constexpr int kMaxPlanes = 3;

// header words of a plane's table (resize_cuda.py:_picture_table)
enum { kH, kW, kOH, kOW, kMode, kTilesX, kRowL, kRowM, kRowJ, kColL, kColM, kColJ, kHeader = 16 };
enum { kResizeRows = 1, kResizeCols = 2 };

struct AxisTaps {
  int count[kMaxPhases];                // nonzero taps of each phase
  int offset[kMaxPhases * kMaxTaps];    // their tap index j, ascending, 48 bytes per phase
  float weight[kMaxPhases * kMaxTaps];  // their weight
};

struct Axis {
  int base[kMaxPhases];
  AxisTaps taps;
};

struct PlaneTable {
  int head[kHeader];
  Axis rows;
  Axis cols;
};

constexpr int kPlaneWords = sizeof(PlaneTable) / 4;
static_assert(kPlaneWords == kHeader + 2 * (2 * kMaxPhases + 2 * kMaxPhases * kMaxTaps),
              "the table layout is resize_cuda.py's");

// What a block needs before its first load, by value: each plane's header
// and bases (the rest of the table is read from device memory while the
// window is staged).
struct PlaneHead {
  int head[kHeader];
  int rbase[kMaxPhases];
  int cbase[kMaxPhases];
};

struct Picture {
  const uint8_t* in[kMaxPlanes];
  uint8_t* out[kMaxPlanes];
  const int* table;  // planes x kPlaneWords, device memory
  int tile_1, tile_2;  // the first blocks of planes 1 and 2
  PlaneHead plane[kMaxPlanes];
};

struct Shared {
  AxisTaps rows, cols;  // the phases the plane uses
  int rstart[kTileRows];  // window row of each output row's first tap
  int rphase[kTileRows];
  int cstart[kTileCols];  // window column of each output column's first tap
  int cphase[kTileCols];
  uint8_t out[kTileRows * kTileCols];  // the tile's outputs, written out 16 bytes at a time
};
static_assert(sizeof(Shared) % 16 == 0, "the window after it stays 16-byte aligned");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Conversions without the conversion instructions, each exact:
// byte K of v as f32: 2^23 + b as a bit pattern, less 2^23
template <int K>
__device__ __forceinline__ float byte_f(uint32_t v) {
  return __uint_as_float(__byte_perm(v, 0x4Bu, 0x4550u | K)) - 8388608.0f;
}

// the bf16 nearest a (ties to even), as f32: __float2bfloat16_rn for every
// finite a
__device__ __forceinline__ float bf16_round(float a) {
  const uint32_t u = __float_as_uint(a);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// the last pass's epilogue: f32 sum -> bf16 -> round half to even -> [0, 255].
// Adding 1.5 * 2^23 (ulp 1) rounds the bf16 value half to even, as rintf,
// and leaves 0x4B400000 + the integer in the bits; the clamp is on those.
__device__ __forceinline__ uint8_t to_u8(float acc) {
  const int bits = __float_as_int(bf16_round(acc) + 12582912.0f);
  return static_cast<uint8_t>(min(max(bits, 0x4B400000), 0x4B400000 + 255));
}

// the two bf16 of a 32-bit word as f32, the lower-addressed first
__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// first window index of output o's taps: (o / L) * M + base[o % L]
__device__ __forceinline__ int tap_start(int o, int L, int M, const int* base) {
  const int q = o / L;
  return q * M + base[o - q * L];
}

// A phase's nonzero taps in registers: weights w, offsets off (in units of
// the element read: the row pass's table holds them scaled to window rows),
// n of them (n <= kTaps).  Every sum is over the taps in ascending order: a
// plain product, then fmaf.
template <int kTaps>
struct Taps {
  float w[kTaps];
  int off[kTaps];
  int n;

  __device__ __forceinline__ Taps(const AxisTaps& ax, int p) {
    n = ax.count[p];
    const float4* wp = reinterpret_cast<const float4*>(ax.weight + p * kMaxTaps);
    const int4* op = reinterpret_cast<const int4*>(ax.offset + p * kMaxTaps);
#pragma unroll
    for (int i = 0; i < kTaps; i += 4) {
      const float4 v = wp[i / 4];
      const int4 o = op[i / 4];
      w[i] = v.x;
      off[i] = o.x;
      if (i + 1 < kTaps) {
        w[i + 1] = v.y;
        off[i + 1] = o.y;
      }
      if (i + 2 < kTaps) {
        w[i + 2] = v.z;
        off[i + 2] = o.z;
      }
      if (i + 3 < kTaps) {
        w[i + 3] = v.w;
        off[i + 3] = o.w;
      }
    }
  }

  // four neighbouring bf16 values per tap, read as one 8-byte word
  __device__ __forceinline__ void sum4(const uint2* p, float (&a)[4]) const {
    uint2 v = p[off[0]];
    a[0] = w[0] * lo_bf16(v.x);
    a[1] = w[0] * hi_bf16(v.x);
    a[2] = w[0] * lo_bf16(v.y);
    a[3] = w[0] * hi_bf16(v.y);
#pragma unroll
    for (int i = 1; i < kTaps; ++i) {
      if (i < n) {
        v = p[off[i]];
        a[0] = fmaf(w[i], lo_bf16(v.x), a[0]);
        a[1] = fmaf(w[i], hi_bf16(v.x), a[1]);
        a[2] = fmaf(w[i], lo_bf16(v.y), a[2]);
        a[3] = fmaf(w[i], hi_bf16(v.y), a[3]);
      }
    }
  }

  // two rows' values per tap (a row pair of the intermediate)
  __device__ __forceinline__ float2 sum2(const float2* p) const {
    float2 v = p[off[0]];
    float2 acc = make_float2(w[0] * v.x, w[0] * v.y);
#pragma unroll
    for (int i = 1; i < kTaps; ++i) {
      if (i < n) {
        v = p[off[i]];
        acc.x = fmaf(w[i], v.x, acc.x);
        acc.y = fmaf(w[i], v.y, acc.y);
      }
    }
    return acc;
  }
};

// Copies the counts, offsets (times `scale`) and weights of an axis's first
// L phases from its table in device memory into `ax`.
__device__ __forceinline__ void copy_taps(AxisTaps& ax, const Axis& axis, int L, int scale) {
  const AxisTaps& from = axis.taps;
  for (int k = threadIdx.x; k < L; k += kThreads) ax.count[k] = from.count[k];
  for (int k = threadIdx.x; k < L * kMaxTaps; k += kThreads) {
    ax.offset[k] = from.offset[k] * scale;
    ax.weight[k] = from.weight[k];
  }
}

// Shared memory after the tables: the staged u8 window [nr][nc]; for a
// row pass the same window as bf16 [nr][nc] (u8 values are exact in
// bf16); for a column pass the f32 row pairs [pairs][nc] it reads (the
// row pass's bf16-rounded sums, or the window's rows when only the columns
// change), rows 2m and 2m + 1 side by side.
template <bool kRows, bool kCols, int kTaps>
__device__ void resize_tile(Shared& sh, uint8_t* win8, const uint8_t* __restrict__ in,
                            uint8_t* __restrict__ out, const PlaneHead& ph,
                            const int* __restrict__ tab, int tile) {
  const int* hd = ph.head;
  const int H = hd[kH], W = hd[kW], OH = hd[kOH], OW = hd[kOW];
  const int tiles_x = hd[kTilesX];
  const int rL = hd[kRowL], rM = hd[kRowM], rJ = hd[kRowJ];
  const int cL = hd[kColL], cM = hd[kColM], cJ = hd[kColJ];
  const int* rbase = ph.rbase;
  const int* cbase = ph.cbase;
  const int ty = tile / tiles_x;
  const int tx = tile - ty * tiles_x;
  const int r0 = ty * kTileRows, c0 = tx * kTileCols;
  const int th = min(kTileRows, OH - r0), tw = min(kTileCols, OW - c0);
  const int pairs = (th + 1) >> 1;

  // the input window: rows [rlo, rlo + nr), columns [cs, cs + nc), nc % 16 == 0
  int rlo = r0, nr = th, cs = c0, nc = (tw + 15) & ~15;
  if (kRows) {
    rlo = tap_start(r0, rL, rM, rbase);
    nr = tap_start(r0 + th - 1, rL, rM, rbase) + rJ - rlo;
  }
  if (kCols) {
    cs = tap_start(c0, cL, cM, cbase) & ~15;
    nc = (tap_start(c0 + tw - 1, cL, cM, cbase) + cJ - cs + 15) & ~15;
  }
  uint2* wbf = reinterpret_cast<uint2*>(win8 + nr * nc);  // 4 bf16 per element, [nr][nc / 4]
  float2* inter = reinterpret_cast<float2*>(win8 + (kRows ? 3 : 1) * nr * nc);

  // stage it: 16 bytes per step, cp.async where the chunk lies inside the
  // plane (both 16-byte aligned), the edge-clamped bytes otherwise
  const bool vec_in = ((reinterpret_cast<uintptr_t>(in) | static_cast<uintptr_t>(W)) & 15) == 0;
  const int chunks = nc >> 4;
  for (int k = threadIdx.x; k < nr * chunks; k += kThreads) {
    const int r = k / chunks;
    const int c = (k - r * chunks) << 4;
    const uint8_t* src = in + static_cast<size_t>(min(max(rlo + r, 0), H - 1)) * W;
    uint8_t* dst = win8 + r * nc + c;
    const int gc = cs + c;
    if (vec_in && gc >= 0 && gc + 16 <= W) {
      cp_async16(dst, src + gc);
    } else {
      for (int i = 0; i < 16; ++i) dst[i] = src[min(max(gc + i, 0), W - 1)];
    }
  }
  // the taps of the phases the plane uses (the row offsets scaled to
  // 8-byte elements of bf16 window rows) and the tile's per-row and
  // per-column tap starts
  const PlaneTable& table = *reinterpret_cast<const PlaneTable*>(tab);
  if (kRows) copy_taps(sh.rows, table.rows, rL, nc >> 2);
  if (kCols) copy_taps(sh.cols, table.cols, cL, 1);
  if (kRows) {
    for (int t = threadIdx.x; t < th; t += kThreads) {
      const int o = r0 + t;
      const int q = o / rL;
      sh.rphase[t] = o - q * rL;
      sh.rstart[t] = q * rM + rbase[o - q * rL] - rlo;
    }
  }
  if (kCols) {
    for (int c = threadIdx.x; c < tw; c += kThreads) {
      const int o = c0 + c;
      const int q = o / cL;
      sh.cphase[c] = o - q * cL;
      sh.cstart[c] = q * cM + cbase[o - q * cL] - cs;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (kRows) {
    // the window as bf16, four values per 8 bytes
    for (int k = threadIdx.x; k < (nr * nc) >> 2; k += kThreads) {
      const uint32_t v = reinterpret_cast<const uint32_t*>(win8)[k];
      wbf[k] = make_uint2(
          (__float_as_uint(byte_f<0>(v)) >> 16) | (__float_as_uint(byte_f<1>(v)) & 0xffff0000u),
          (__float_as_uint(byte_f<2>(v)) >> 16) | (__float_as_uint(byte_f<3>(v)) & 0xffff0000u));
    }
  } else {
    // the columns alone: the window's rows, paired, are what the column pass reads
    for (int m = warp; m < pairs; m += kWarps) {
      const uint8_t* a = win8 + 2 * m * nc;
      const uint8_t* b = win8 + min(2 * m + 1, th - 1) * nc;
      for (int k = lane; k < nc; k += 32) {
        inter[m * nc + k] = make_float2(__uint_as_float(0x4B000000u | a[k]) - 8388608.0f,
                                        __uint_as_float(0x4B000000u | b[k]) - 8388608.0f);
      }
    }
  }
  __syncthreads();

  if (kRows) {
    // row pass: a thread per pair of output rows and four window columns,
    // each row's taps in registers while it is summed; with a column pass
    // only the columns it reads
    int g0 = 0, g1 = (tw + 3) >> 2;
    if (kCols) {
      g0 = sh.cstart[0] >> 2;
      g1 = (sh.cstart[tw - 1] + cJ + 3) >> 2;
    }
    const int groups = g1 - g0;
    for (int k = threadIdx.x; k < pairs * groups; k += kThreads) {
      const int m = k / groups;
      const int g = g0 + k - m * groups;
      const int ta = 2 * m, tb = min(2 * m + 1, th - 1);
      float a[4], b[4];
      {
        const Taps<kTaps> taps(sh.rows, sh.rphase[ta]);
        taps.sum4(wbf + sh.rstart[ta] * (nc >> 2) + g, a);
      }
      {
        const Taps<kTaps> taps(sh.rows, sh.rphase[tb]);
        taps.sum4(wbf + sh.rstart[tb] * (nc >> 2) + g, b);
      }
      if (kCols) {
        float4* dst = reinterpret_cast<float4*>(inter + m * nc + 4 * g);
        dst[0] = make_float4(bf16_round(a[0]), bf16_round(b[0]), bf16_round(a[1]),
                             bf16_round(b[1]));
        dst[1] = make_float4(bf16_round(a[2]), bf16_round(b[2]), bf16_round(a[3]),
                             bf16_round(b[3]));
      } else {
        *reinterpret_cast<uchar4*>(sh.out + ta * kTileCols + 4 * g) =
            make_uchar4(to_u8(a[0]), to_u8(a[1]), to_u8(a[2]), to_u8(a[3]));
        *reinterpret_cast<uchar4*>(sh.out + tb * kTileCols + 4 * g) =
            make_uchar4(to_u8(b[0]), to_u8(b[1]), to_u8(b[2]), to_u8(b[3]));
      }
    }
  }

  if (kCols) {
    if (kRows) __syncthreads();
    // column pass: a thread per output column (its phase's taps in
    // registers), a row pair per step
    const int c = threadIdx.x & (kTileCols - 1);
    if (c < tw) {
      const Taps<kTaps> taps(sh.cols, sh.cphase[c]);
      const float2* col = inter + sh.cstart[c];
      for (int m = threadIdx.x / kTileCols; m < pairs; m += kThreads / kTileCols) {
        const float2 acc = taps.sum2(col + m * nc);
        sh.out[2 * m * kTileCols + c] = to_u8(acc.x);
        if (2 * m + 1 < th) sh.out[(2 * m + 1) * kTileCols + c] = to_u8(acc.y);
      }
    }
  }
  __syncthreads();

  // write the tile out: 16 bytes per step where the plane allows it
  const bool vec_out = ((reinterpret_cast<uintptr_t>(out) | static_cast<uintptr_t>(OW)) & 15) == 0;
  for (int k = threadIdx.x; k < th * (kTileCols / 16); k += kThreads) {
    const int t = k / (kTileCols / 16);
    const int c = (k % (kTileCols / 16)) * 16;
    if (c >= tw) continue;
    uint8_t* dst = out + static_cast<size_t>(r0 + t) * OW + c0 + c;
    const uint8_t* src = sh.out + t * kTileCols + c;
    if (vec_out && c + 16 <= tw) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < 16 && c + i < tw; ++i) dst[i] = src[i];
    }
  }
}

template <int kTaps>
__device__ __forceinline__ void resize_tile_by_mode(Shared& sh, uint8_t* window, const uint8_t* in,
                                                    uint8_t* out, const PlaneHead& ph,
                                                    const int* tab, int tile) {
  const int mode = ph.head[kMode];
  if (mode == (kResizeRows | kResizeCols)) {
    resize_tile<true, true, kTaps>(sh, window, in, out, ph, tab, tile);
  } else if (mode == kResizeRows) {
    resize_tile<true, false, kTaps>(sh, window, in, out, ph, tab, tile);
  } else {
    resize_tile<false, true, kTaps>(sh, window, in, out, ph, tab, tile);
  }
}

// Block b resizes tile b - tile_q of plane q.
// 6 blocks of 256 threads on each SM (at most 40 registers a thread, none
// spilled): the 782 tiles of a 720p -> 1080p yuv420p picture in one wave.
__global__ void __launch_bounds__(kThreads, 6)
    resize_picture_kernel(const __grid_constant__ Picture pic) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  uint8_t* window = smem + sizeof(Shared);
  const int b = blockIdx.x;
  const int q = b >= pic.tile_2 ? 2 : (b >= pic.tile_1 ? 1 : 0);
  const int tile = b - (q == 2 ? pic.tile_2 : (q == 1 ? pic.tile_1 : 0));
  const PlaneHead& ph = pic.plane[q];
  const int* tab = pic.table + q * kPlaneWords;
  // the taps held in registers: 5 cover every upscale (J <= 5), 12 the rest
  if (max(ph.head[kRowJ], ph.head[kColJ]) <= 5) {
    resize_tile_by_mode<5>(sh, window, pic.in[q], pic.out[q], ph, tab, tile);
  } else {
    resize_tile_by_mode<kMaxTaps>(sh, window, pic.in[q], pic.out[q], ph, tab, tile);
  }
}

}  // namespace

extern "C" {

// Resize `planes` (1..3) u8 planes of a picture in one launch on card
// `device`: plane q reads x_q and writes out_q (contiguous, device
// pointers) as its table describes: `table` holds planes x kPlaneWords
// int32 words on the device, `host_table` the same words in host memory
// (resize_cuda.py:_picture_table).  `tiles` blocks in all; planes 1 and 2
// start at blocks tile_1 and tile_2.  `window_bytes` is the most shared
// memory a tile's window and intermediate take; the kernel adds its tables.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess); invalid
// arguments return cudaErrorInvalidValue and launch nothing.
int mixlab_resize_picture(const void* x0, void* out0, const void* x1, void* out1,
                          const void* x2, void* out2, int planes, const void* host_table,
                          const void* table, int tiles, int tile_1, int tile_2,
                          int window_bytes, int device, void* stream_ptr) {
  const void* xs[kMaxPlanes] = {x0, x1, x2};
  void* outs[kMaxPlanes] = {out0, out1, out2};
  if (planes < 1 || planes > kMaxPlanes || !table || !host_table || tiles < 1 ||
      window_bytes < 0 || tile_1 < 0 || tile_2 < tile_1 || tile_2 > tiles ||
      (planes < 2 && tile_1 != tiles) || (planes < 3 && tile_2 != tiles) || device < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Picture pic = {};
  const int* host = static_cast<const int*>(host_table);
  for (int q = 0; q < planes; ++q) {
    if (!xs[q] || !outs[q]) return static_cast<int>(cudaErrorInvalidValue);
    pic.in[q] = static_cast<const uint8_t*>(xs[q]);
    pic.out[q] = static_cast<uint8_t*>(outs[q]);
    const int* words = host + q * kPlaneWords;
    for (int k = 0; k < kHeader; ++k) pic.plane[q].head[k] = words[k];
    for (int k = 0; k < kMaxPhases; ++k) {
      pic.plane[q].rbase[k] = words[offsetof(PlaneTable, rows) / 4 + k];
      pic.plane[q].cbase[k] = words[offsetof(PlaneTable, cols) / 4 + k];
    }
  }
  pic.table = static_cast<const int*>(table);
  pic.tile_1 = tile_1;
  pic.tile_2 = tile_2;
  OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  // above 48 KB a block's dynamic shared memory must be allowed first: to
  // the card's most, the same value from every call and thread, so no call
  // lowers what another's launch needs
  const long long bytes = static_cast<long long>(sizeof(Shared)) + window_bytes;
  if (bytes > 48 * 1024) {
    int most = 0;
    cudaError_t err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess && bytes > most) err = cudaErrorInvalidValue;
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(resize_picture_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  resize_picture_kernel<<<tiles, kThreads, static_cast<size_t>(bytes),
                          static_cast<cudaStream_t>(stream_ptr)>>>(pic);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
