// Polyphase Mitchell-bicubic resize along one axis of a plane, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel mixlab_tpu/video/resize_pallas.py (_axis0_kernel /
// _resize_axis0).  For a ratio n_out/n_in = L/M (L <= 16 phases, J <= 12
// taps; mixlab_tpu_torch/video/resize_cuda.py:_phase_plan), output
// o = q*L + p along the resized axis is
//   sum over taps j ascending, zero weights skipped, of
//     w[p][j] * x[clamp(q*M + base[p] + j, 0, n_in - 1)]
// (the clamp is the TPU kernel's edge padding).  The sum is f32 in tap
// order: the first term a plain product, each later one fmaf(w, x, acc),
// which is how XLA's CPU backend evaluates the TPU kernel in interpret mode
// (it contracts acc + w*x into one FMA); the library is built with
// -fmad=false, so only the fmaf written here fuses.  The pass's result is
// rounded to bf16 (__float2bfloat16_rn); the last pass of a plane then
// widens it, rounds half to even (rintf, as torch.round and jnp.round) and
// clamps to [0, 255] into u8.  A plane resized on both axes takes two
// launches: rows u8 -> bf16, then columns bf16 -> u8, read along the rows
// (no transpose).
//
// What bounds it on the card: bytes.  The function reads the u8 plane and
// writes the u8 plane: a 720p -> 1080p yuv420p picture is 1,382,400 B in and
// 3,110,400 B out, 4,492,800 B or 1.34 us at 3.35 TB/s; config 5's 540p ->
// 1080p frame 3,888,000 B or 1.16 us.  Its ~5-9 multiply-adds per output are
// far below the card's rate.  The bf16 intermediate between the passes is
// this design's own cost, not the function's.  Design, simple first: one
// thread per output element, consecutive threads on consecutive elements of
// a row (coalesced stores; the row pass's loads are coalesced too, the
// column pass's neighbouring threads read neighbouring inputs), the [L, J]
// weights and L bases staged from a small device table into shared memory
// at block start (a table passed by value and indexed by a phase known only
// at run time would be copied to each thread's local memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPhases = 16;
constexpr int kMaxTaps = 12;

__device__ __forceinline__ float load(const uint8_t* x, int i) {
  return static_cast<float>(x[i]);
}

__device__ __forceinline__ float load(const __nv_bfloat16* x, int i) {
  return __bfloat162float(x[i]);
}

__device__ __forceinline__ void store(__nv_bfloat16* out, int i, float acc) {
  out[i] = __float2bfloat16_rn(acc);
}

__device__ __forceinline__ void store(uint8_t* out, int i, float acc) {
  float v = rintf(__bfloat162float(__float2bfloat16_rn(acc)));
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  out[i] = static_cast<uint8_t>(v);
}

// x is [rows, cols] row-major.  Axis 0 resizes the rows (n_in = rows): out
// is [n_out, cols].  Axis 1 resizes the columns (n_in = cols): out is
// [rows, n_out].
template <typename In, typename Out, int Axis>
__global__ void __launch_bounds__(kThreads)
resize_kernel(const In* __restrict__ x, Out* __restrict__ out, int rows, int cols,
              int n_out, int L, int M, int J, const float* __restrict__ w_table,
              const int* __restrict__ base_table) {
  __shared__ float w[kMaxPhases * kMaxTaps];
  __shared__ int base[kMaxPhases];
  for (int k = threadIdx.x; k < L * J; k += blockDim.x) w[k] = w_table[k];
  for (int k = threadIdx.x; k < L; k += blockDim.x) base[k] = base_table[k];
  __syncthreads();

  const int n_in = Axis == 0 ? rows : cols;
  const int width = Axis == 0 ? cols : n_out;  // output row length
  const int total = (Axis == 0 ? n_out : rows) * width;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int r = i / width;
  const int c = i - r * width;
  const int o = Axis == 0 ? r : c;  // position along the resized axis
  const int q = o / L;
  const int p = o - q * L;
  const int first = q * M + base[p];
  const float* wp = w + p * J;
  float acc = 0.0f;
  bool started = false;
  for (int j = 0; j < J; ++j) {
    const float wj = wp[j];
    if (wj == 0.0f) continue;
    const int s = min(max(first + j, 0), n_in - 1);
    const float v = Axis == 0 ? load(x, s * cols + c) : load(x, r * cols + s);
    acc = started ? fmaf(wj, v, acc) : wj * v;
    started = true;
  }
  store(out, i, acc);
}

template <typename In, typename Out>
int launch(const void* x, void* out, int rows, int cols, int n_out, int axis, int L,
           int M, int J, const float* w, const int* bases, cudaStream_t stream) {
  const long long total = static_cast<long long>(axis == 0 ? n_out : rows) *
                          (axis == 0 ? cols : n_out);
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  const In* xi = static_cast<const In*>(x);
  Out* o = static_cast<Out*>(out);
  if (axis == 0) {
    resize_kernel<In, Out, 0><<<blocks, kThreads, 0, stream>>>(xi, o, rows, cols, n_out, L,
                                                                 M, J, w, bases);
  } else {
    resize_kernel<In, Out, 1><<<blocks, kThreads, 0, stream>>>(xi, o, rows, cols, n_out, L,
                                                                 M, J, w, bases);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Resize axis `axis` (0: rows, 1: columns) of the contiguous [rows, cols]
// plane x (u8 if in_u8, else bf16) to n_out, writing out (u8 if out_u8, else
// bf16): [n_out, cols] or [rows, n_out].  w is the [L, J] f32 weight table,
// bases the L int32 bases, all device pointers.  Returns cudaGetLastError()
// after the launch (0 = cudaSuccess); invalid arguments return
// cudaErrorInvalidValue and launch nothing.
int mixlab_resize_axis(const void* x, void* out, int rows, int cols, int n_out, int axis,
                       int in_u8, int out_u8, int L, int M, int J, const void* w,
                       const void* bases, void* stream_ptr) {
  const long long total = static_cast<long long>(axis == 0 ? n_out : rows) *
                          (axis == 0 ? cols : n_out);
  if (!x || !out || !w || !bases || rows < 1 || cols < 1 || n_out < 1 ||
      (axis != 0 && axis != 1) || L < 1 || L > kMaxPhases || M < 1 || J < 1 ||
      J > kMaxTaps || total >= (1LL << 31) ||
      static_cast<long long>(rows) * cols >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* wt = static_cast<const float*>(w);
  const int* bt = static_cast<const int*>(bases);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (in_u8) {
    return out_u8 ? launch<uint8_t, uint8_t>(x, out, rows, cols, n_out, axis, L, M, J, wt, bt,
                                             stream)
                  : launch<uint8_t, __nv_bfloat16>(x, out, rows, cols, n_out, axis, L, M, J,
                                                   wt, bt, stream);
  }
  return out_u8 ? launch<__nv_bfloat16, uint8_t>(x, out, rows, cols, n_out, axis, L, M, J, wt,
                                                 bt, stream)
                : launch<__nv_bfloat16, __nv_bfloat16>(x, out, rows, cols, n_out, axis, L, M,
                                                       J, wt, bt, stream);
}

}  // extern "C"
