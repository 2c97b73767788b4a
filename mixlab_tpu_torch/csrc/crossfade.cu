// The video mixer's crossfade, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mixlab_tpu/video/blend.py (_blend_kernel /
// crossfade_pallas).  Per pixel of every plane of a picture, the reference's
// u8-load / u16-math / truncating division (src/module/video_mixer.rs:210-235)
//   out = (a*f + b*(255 - f)) / 255
// computed exactly as ((a*f + b*(255 - f)) * 32897) >> 23 in 32-bit unsigned
// arithmetic: the sum is at most 255*255 = 65025, and x*32897 >> 23 == x/255
// for 0 <= x <= 65535 (tests/test_video.py:26-29); 65025 * 32897 < 2^32.
//
// What bounds it on the card: bytes.  A 1080p YUV420 picture is 3,110,400 B;
// the blend reads two pictures and writes one, 9,331,200 B, 2.79 us at
// 3.35 TB/s, against ~6 integer operations per byte.  So the design is plain
// streaming: one launch for all planes of the picture (up to three (a, b, out,
// n) triples passed by value), each thread moving 16 bytes per plane per step
// as one uint4 load of a, one of b and one uint4 store, a grid-stride loop
// over enough blocks to cover every SM, no shared memory.  A plane whose
// pointers are not all 16-byte aligned, and the last n % 16 bytes of a plane,
// go through a scalar loop.  The TPU kernel's [rows, 1024] VMEM tiling and
// its padding copy have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "on_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident blocks on each of 132 SMs
constexpr int kMaxPlanes = 3;

struct Plane {
  const uint8_t* a;
  const uint8_t* b;
  uint8_t* out;
  int n;
  int vec;  // 1: all three pointers 16-byte aligned, use uint4 accesses
};

struct Planes {
  Plane p[kMaxPlanes];
  int count;
};

__device__ __forceinline__ uint32_t blend(uint32_t a, uint32_t b, uint32_t f, uint32_t g) {
  return ((a * f + b * g) * 32897u) >> 23;
}

// four packed bytes of a and b -> four packed blended bytes
__device__ __forceinline__ uint32_t blend4(uint32_t a, uint32_t b, uint32_t f, uint32_t g) {
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < 32; k += 8) {
    r |= blend((a >> k) & 0xffu, (b >> k) & 0xffu, f, g) << k;
  }
  return r;
}

__global__ void __launch_bounds__(kThreads) crossfade_kernel(Planes planes, uint32_t f) {
  const uint32_t g = 255u - f;
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  for (int q = 0; q < planes.count; ++q) {
    const Plane pl = planes.p[q];
    int done = 0;
    if (pl.vec) {
      const int nv = pl.n / 16;
      const uint4* a4 = reinterpret_cast<const uint4*>(pl.a);
      const uint4* b4 = reinterpret_cast<const uint4*>(pl.b);
      uint4* o4 = reinterpret_cast<uint4*>(pl.out);
      for (int i = tid; i < nv; i += stride) {
        const uint4 va = a4[i];
        const uint4 vb = b4[i];
        uint4 vo;
        vo.x = blend4(va.x, vb.x, f, g);
        vo.y = blend4(va.y, vb.y, f, g);
        vo.z = blend4(va.z, vb.z, f, g);
        vo.w = blend4(va.w, vb.w, f, g);
        o4[i] = vo;
      }
      done = nv * 16;
    }
    for (int i = done + tid; i < pl.n; i += stride) {
      pl.out[i] = static_cast<uint8_t>(blend(pl.a[i], pl.b[i], f, g));
    }
  }
}

}  // namespace

extern "C" {

// Blend `count` (1..3) planes of u8 pixels in one launch: out_q = blend(a_q,
// b_q) over n_q bytes each, with 0 <= fade <= 255.  All pointers are device
// pointers; the planes are contiguous; the launch goes to card `device`.
// Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); invalid arguments return cudaErrorInvalidValue
// and launch nothing.
int mixlab_crossfade(const void* a0, const void* b0, void* o0, int n0,
                     const void* a1, const void* b1, void* o1, int n1,
                     const void* a2, const void* b2, void* o2, int n2,
                     int count, int fade, int device, void* stream_ptr) {
  if (count < 1 || count > kMaxPlanes || fade < 0 || fade > 255) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  const void* as[kMaxPlanes] = {a0, a1, a2};
  const void* bs[kMaxPlanes] = {b0, b1, b2};
  void* os[kMaxPlanes] = {o0, o1, o2};
  const int ns[kMaxPlanes] = {n0, n1, n2};
  Planes planes;
  planes.count = count;
  int most_vectors = 1;
  for (int q = 0; q < kMaxPlanes; ++q) {
    Plane& pl = planes.p[q];
    const bool used = q < count;
    if (used && (ns[q] < 0 || (ns[q] > 0 && (!as[q] || !bs[q] || !os[q])))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    pl.a = static_cast<const uint8_t*>(used ? as[q] : nullptr);
    pl.b = static_cast<const uint8_t*>(used ? bs[q] : nullptr);
    pl.out = static_cast<uint8_t*>(used ? os[q] : nullptr);
    pl.n = used ? ns[q] : 0;
    const uintptr_t bits = reinterpret_cast<uintptr_t>(pl.a) |
                           reinterpret_cast<uintptr_t>(pl.b) |
                           reinterpret_cast<uintptr_t>(pl.out);
    pl.vec = (bits % 16 == 0) ? 1 : 0;
    const int units = pl.vec ? pl.n / 16 + pl.n % 16 : pl.n;
    if (units > most_vectors) most_vectors = units;
  }
  int blocks = (most_vectors + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  crossfade_kernel<<<blocks, kThreads, 0, stream>>>(planes, static_cast<uint32_t>(fade));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
