// What the batched rows forms of csrc/envelope.cu, csrc/eq_cascade.cu and
// csrc/region.cu share (hand-written for Hopper, sm_90a): a batched launch
// walks each row (a block of the batch) in tiles, and each CTA copies its
// next tile into shared memory with cp.async while it computes on the
// current one (two buffers).  Two forms, by the wrappers' batch_plan (the
// eq's has only the first):
//   * one CTA a row, the carry in the CTA, where the rows alone fill the
//     card;
//   * where they do not, a single-pass decoupled look-back: a grid of as
//     many CTAs as the card holds at once takes tiles by an atomic ticket in
//     row-major order (a CTA only ever waits on tiles that CTAs already
//     running hold), and every tile publishes its aggregate, then its
//     inclusive carry, in a status array in global memory that the wrapper
//     keeps per kernel, card and stream, zeroed once when it is made.
// The launch's number lives on the device, in the status array's header
// (kHeader words): [0] the launches that ended on it, [1] the ticket
// counter, [2] the CTAs of the running launch that ended.  Thread 0 of every
// CTA reads the number first (launch_number: one more than the launches
// that ended), and every status word a launch writes is tagged with it, so
// the array needs no clearing between launches.  The CTA that ends a launch
// (leave: the last of gridDim.x) clears the counters and advances the
// number; no CTA of the launch can read the new number, since each has read
// its own before it leaves, and the next launch on the stream runs after
// this one.  So a launch captured into a CUDA graph counts on at every
// replay, two host threads on one stream never share a number, and a launch
// that was refused never advances it.  Tags are number * 4 + state: they
// wrap after 2^30 launches on one array.  A call stays one device launch.
// Waiting tiles poll with relaxed loads and fence once they see the flags
// they need.
// A thread block cluster a row (the carry through distributed shared
// memory, rounds of tiles dealt out among the cluster's CTAs) was built
// and measured beside the look-back, and was slower at every shape that
// splits a row (PERF.md §6).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rows {

// status states, tagged: seq * 4 + state
constexpr unsigned kAggregate = 1;
constexpr unsigned kInclusive = 2;

__device__ __forceinline__ unsigned tag(unsigned seq, unsigned state) { return seq * 4u + state; }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest `kPending` complete (this thread's copies)
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// the status array's header: the launches ended, the ticket counter, the
// CTAs of the running launch that ended, a pad (16 bytes)
constexpr int kHeader = 4;

// This launch's number on the status array (thread 0 of every CTA, first)
__device__ __forceinline__ unsigned launch_number(const unsigned* hdr) {
  return load_relaxed(hdr) + 1u;
}

// The next ticket of this launch (thread 0 calls it)
__device__ __forceinline__ unsigned take_ticket(unsigned* hdr) { return atomicAdd(hdr + 1, 1u); }

// Thread 0 of every CTA, once it took a ticket past the launch's tiles: the
// CTA that ends the launch clears the counters and advances the number for
// the next launch on the stream.
__device__ __forceinline__ void leave(unsigned* hdr, unsigned seq) {
  if (atomicAdd(hdr + 2, 1u) == gridDim.x - 1) {
    hdr[1] = 0u;
    hdr[2] = 0u;
    store_release(hdr, seq);
  }
}

}  // namespace rows
