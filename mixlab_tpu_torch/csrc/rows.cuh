// What the batched rows forms of csrc/envelope.cu and csrc/region.cu share
// (hand-written for Hopper, sm_90a): a batched launch walks each row (a
// block of the batch) in tiles, and each CTA copies its next tile into
// shared memory with cp.async while it computes on the current one (two
// buffers).  Two forms, by the wrappers' batch_plan:
//   * one CTA a row, the carry in shared memory, where the rows alone fill
//     the card;
//   * where they do not, a single-pass decoupled look-back: a grid of as
//     many CTAs as the card holds at once takes tiles by an atomic ticket in
//     row-major order (a CTA only ever waits on tiles that CTAs already
//     running hold), and every tile publishes its aggregate, then its
//     inclusive carry, in a status array in global memory that the wrapper
//     keeps per kernel, card and stream.  Each status word is tagged with
//     the launch's sequence number (`seq`), so the array needs no clearing
//     between launches; the ticket counter of launch seq is
//     tickets[seq & 1], and every launch clears tickets[(seq + 1) & 1] for
//     the next one (launches on one stream run in order).  A call stays
//     one device launch.  Waiting tiles poll with relaxed loads and fence
//     once they see the flags they need.
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

// The next ticket of launch `seq` (thread 0 calls it); the first caller of a
// launch also clears the counter the next launch on this stream takes.
__device__ __forceinline__ unsigned take_ticket(unsigned* tickets, unsigned seq) {
  tickets[(seq + 1) & 1] = 0u;
  return atomicAdd(tickets + (seq & 1), 1u);
}

}  // namespace rows
