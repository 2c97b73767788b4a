// The video mixer's crossfade as a cold-stream kernel, hand-written for
// Hopper (sm_90a).
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
// 3.35 TB/s, against ~6 integer operations per byte.  The realtime tick
// finds the pictures cold (they came from the host since the last tick), so
// what counts is the bytes in flight: by Little's law ~2 MB at 3.35 TB/s.
// The design:
//   * one flat index space over the picture's 16-byte vectors, every plane
//     whose three pointers are 16-byte aligned, in plane order: the host
//     prefix-sums the planes' vector counts and passes them by value with
//     the pointers, so a thread never walks the planes in sequence;
//   * each thread takes kUnroll = 2 vectors, a CTA's width apart (a warp's
//     accesses stay contiguous), and issues all 2 * kUnroll read-once loads
//     (ld.global.cs, evict-first) before it blends any, then stores with
//     st.global.cs: 256 threads x 4 loads x 16 B = 16 KB in flight per CTA,
//     380 CTAs at 1080p, all resident at once on 132 SMs, so the whole
//     picture's 6.2 MB of loads is in flight in one wave (four and eight
//     vectors a thread, fewer and fuller CTAs, were slower when cold);
//   * the grid is sized from the total vector count, so every CTA but the
//     last does the same work;
//   * the ragged bytes (n % 16 of each vectorised plane, and every byte of
//     a plane whose pointers are not 16-byte aligned) form their own short
//     range at the end of the index space, one byte per thread.
// No shared memory and no TMA: nothing is reused.  The TPU kernel's
// [rows, 1024] VMEM tiling and its padding copy have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "on_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // vectors per thread
constexpr int kVectorsPerBlock = kThreads * kUnroll;
constexpr int kMaxPlanes = 3;

// The picture by value: per plane its pointers, the end of its vectors in
// the flat vector range and of its bytes in the ragged range (inclusive
// prefix sums), and its first ragged byte.
struct Picture {
  const uint8_t* a[kMaxPlanes];
  const uint8_t* b[kMaxPlanes];
  uint8_t* out[kMaxPlanes];
  int vec_end[kMaxPlanes];
  int rag_end[kMaxPlanes];
  int rag_first[kMaxPlanes];
  int vec_blocks;  // CTAs of the vector range; the rest take the ragged bytes
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

// field q of a by-value array, chosen by selects (a dynamic index would
// copy the parameter block to local memory)
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[kMaxPlanes], int q) {
  return q == 0 ? v[0] : (q == 1 ? v[1] : v[2]);
}

// the plane of flat index i in a range whose planes end at `ends`, and i's
// offset inside it
__device__ __forceinline__ int plane_of(const int (&ends)[kMaxPlanes], int i, int* local) {
  const int q = (i >= ends[0]) + (i >= ends[1]);
  *local = i - (q == 0 ? 0 : (q == 1 ? ends[0] : ends[1]));
  return q;
}

__global__ void __launch_bounds__(kThreads) crossfade_kernel(Picture pic, uint32_t f) {
  const uint32_t g = 255u - f;
  if (static_cast<int>(blockIdx.x) >= pic.vec_blocks) {  // the ragged range
    const int i = (blockIdx.x - pic.vec_blocks) * kThreads + threadIdx.x;
    if (i >= pic.rag_end[kMaxPlanes - 1]) return;
    int local;
    const int q = plane_of(pic.rag_end, i, &local);
    const int at = pick(pic.rag_first, q) + local;
    pick(pic.out, q)[at] =
        static_cast<uint8_t>(blend(pick(pic.a, q)[at], pick(pic.b, q)[at], f, g));
    return;
  }
  const int n = pic.vec_end[kMaxPlanes - 1];
  const int first = blockIdx.x * kVectorsPerBlock + threadIdx.x;
  uint4 va[kUnroll], vb[kUnroll];
  uint4* dst[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {  // every load first
    const int i = first + u * kThreads;
    dst[u] = nullptr;
    if (i < n) {
      int local;
      const int q = plane_of(pic.vec_end, i, &local);
      va[u] = __ldcs(reinterpret_cast<const uint4*>(pick(pic.a, q)) + local);
      vb[u] = __ldcs(reinterpret_cast<const uint4*>(pick(pic.b, q)) + local);
      dst[u] = reinterpret_cast<uint4*>(pick(pic.out, q)) + local;
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (dst[u] != nullptr) {
      uint4 vo;
      vo.x = blend4(va[u].x, vb[u].x, f, g);
      vo.y = blend4(va[u].y, vb[u].y, f, g);
      vo.z = blend4(va[u].z, vb[u].z, f, g);
      vo.w = blend4(va[u].w, vb[u].w, f, g);
      __stcs(dst[u], vo);
    }
  }
}

}  // namespace

extern "C" {

// Blend `count` (1..3) planes of u8 pixels in one launch: out_q = blend(a_q,
// b_q) over n_q bytes each, with 0 <= fade <= 255.  All pointers are device
// pointers; the planes are contiguous; the launch goes to card `device`.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess); invalid
// arguments (or more than 2^31 - 1 bytes in the ragged range) return
// cudaErrorInvalidValue and launch nothing.
int mixlab_crossfade(const void* a0, const void* b0, void* o0, int n0,
                     const void* a1, const void* b1, void* o1, int n1,
                     const void* a2, const void* b2, void* o2, int n2,
                     int count, int fade, int device, void* stream_ptr) {
  if (count < 1 || count > kMaxPlanes || fade < 0 || fade > 255) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* as[kMaxPlanes] = {a0, a1, a2};
  const void* bs[kMaxPlanes] = {b0, b1, b2};
  void* os[kMaxPlanes] = {o0, o1, o2};
  const int ns[kMaxPlanes] = {n0, n1, n2};
  Picture pic;
  long long vec = 0, rag = 0;
  for (int q = 0; q < kMaxPlanes; ++q) {
    const bool used = q < count;
    if (used && (ns[q] < 0 || (ns[q] > 0 && (!as[q] || !bs[q] || !os[q])))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int n = used ? ns[q] : 0;
    pic.a[q] = static_cast<const uint8_t*>(used ? as[q] : nullptr);
    pic.b[q] = static_cast<const uint8_t*>(used ? bs[q] : nullptr);
    pic.out[q] = static_cast<uint8_t*>(used ? os[q] : nullptr);
    const uintptr_t bits = reinterpret_cast<uintptr_t>(pic.a[q]) |
                           reinterpret_cast<uintptr_t>(pic.b[q]) |
                           reinterpret_cast<uintptr_t>(pic.out[q]);
    const int nv = bits % 16 == 0 ? n / 16 : 0;
    vec += nv;
    rag += n - 16 * nv;
    pic.vec_end[q] = static_cast<int>(vec);
    pic.rag_first[q] = 16 * nv;
    if (rag > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    pic.rag_end[q] = static_cast<int>(rag);
  }
  pic.vec_blocks = static_cast<int>((vec + kVectorsPerBlock - 1) / kVectorsPerBlock);
  // at least one CTA, so that every call launches (empty planes blend nothing)
  const long long need = pic.vec_blocks + (rag + kThreads - 1) / kThreads;
  const unsigned blocks = need > 0 ? static_cast<unsigned>(need) : 1u;
  OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  crossfade_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream_ptr)>>>(pic, static_cast<uint32_t>(fade));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
