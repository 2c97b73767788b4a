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
// (51.4 us per launch on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6,
// the bring-up table);
// the scan form needs one carry for all four stages.
//
// Over a batch (what jax.vmap of the TPU kernel computes: the fleet's
// sessions, the stems), B rows of one part, each with its own operands,
// parameter and state scalars, taps and exits, go in ONE launch, in one of
// three forms (region_cuda.batch_plan):
//   * the cooperative grid above with gridDim.y = B, where B x G CTAs fit on
//     the card at once (a few stems at long blocks); each row's scratch
//     slots are global [B][S] buffers;
//   * otherwise the rows forms of csrc/rows.cuh: tiles of 128 x L samples
//     (L = 8: 1,024), the plan run over each tile on shared memory (its
//     operands staged by cp.async a tile ahead, its scratch slots tiles,
//     its taps out as float4 stores); one CTA a row (region_rows_kernel)
//     carries each EQ op's poles and 3-sample history from tile to tile in
//     shared memory, or, where that leaves most of the card idle (a few
//     long rows), the decoupled look-back (region_lookback_kernel) passes
//     them on through a status array: each tile publishes its EQ's
//     zero-state response and last inputs, folds those of the tiles before
//     it onto the nearest inclusive poles, and publishes its own exit
//     poles (A^n y + E) before its pass 2.  PEAK is one atomicMax a tile on
//     the row's bit pattern, after the row's first tile zeroed it.
// Row b of a slot is at its address + b x its row stride; the stride is 0
// for an operand that every row shares, which is never expanded to [B][S].
// The plan's constants are one row for all.  A single block (B = 1, its
// constants right after its param scalars) takes the cooperative kernel
// without the row offsets (Block), as before the batch axis.  Batched, the
// function moves ~32 B a sample (six operands in, a stereo tap out), 3.36
// GB at 8,192 rows of 12,800 (1.0 ms at 3.35 TB/s); the rows forms reach
// about a quarter of that (PERF.md §6, the bring-up table): the plan's
// interpreter (its words and params read an op at a time, the EQ's two
// passes and scans between barriers) at two CTAs of 128 threads an SM,
// not the bytes, holds them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "eq_scan.cuh"
#include "on_device.cuh"
#include "rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 128;       // samples per chunk = threads per CTA
constexpr int kMaxChunks = 4096;  // region_cuda.MAX_CHUNKS
constexpr int kBatch = 8;         // chunks a thread loads before it stores
// dynamic shared memory the batched rows forms ask for at most (a Hopper CTA
// may have 227 KB; region_cuda.ROWS_SHARED)
constexpr size_t kRowsShared = 200 * 1024;

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
  const long long* slots;  // [n_slots][2]: device address, row stride in bytes
  int n_operands;          // slots past these are scratch
  const float* pf;         // param scalars, row b at pf + b * pf_stride
  long long pf_stride;
  int n_pf;
  const float* consts;     // the plan's constants: parameter index n_pf onwards
  const float* sf;         // state scalars (layout == exits), row b at sf + b * sf_stride
  long long sf_stride;
  float* taps;             // [B][n_taps][S]
  int n_taps;
  float* stap;             // [B][n_stap]
  int n_stap;
  float* ef;               // exits [B][n_ef]
  int n_ef;
  int S;
  int K;                   // S / 128
  int lg;                  // log2 of the chunks a CTA takes at a time (the EQ's run)
};

// What a CTA of the cooperative grid sees of its row b.
struct Row {
  const Part& p;
  long long b;
  const float* pf;
  const float* sf;
  float* taps;
  unsigned* stap;  // the scalar taps' bit patterns (|x| >= 0: the float order)
  float* ef;

  __device__ Row(const Part& part, int row)
      : p(part), b(row), pf(part.pf + row * part.pf_stride), sf(part.sf + row * part.sf_stride),
        taps(part.taps + static_cast<long long>(row) * part.n_taps * part.S),
        stap(reinterpret_cast<unsigned*>(part.stap) + static_cast<long long>(row) * part.n_stap),
        ef(part.ef + static_cast<long long>(row) * part.n_ef) {}

  // slot s as a pointer whose element t is the part's sample t
  __device__ __forceinline__ float* slot(int s) const {
    return reinterpret_cast<float*>(p.slots[2 * s] + b * p.slots[2 * s + 1]);
  }
  __device__ __forceinline__ const int16_t* slot16(int s) const {
    return reinterpret_cast<const int16_t*>(slot(s));
  }
  // parameter index i: the row's param scalar, or the plan's constant
  __device__ __forceinline__ const float* par(int i) const {
    return i < p.n_pf ? pf + i : p.consts + (i - p.n_pf);
  }
};

// What a CTA of a single block sees (B = 1, the plan's constants right
// after the param scalars in one row, as before the batch axis): each slot
// at its address, parameter i at pf[i].
struct Block {
  const Part& p;
  const float* sf;
  float* taps;
  unsigned* stap;
  float* ef;

  __device__ Block(const Part& part, int)
      : p(part), sf(part.sf), taps(part.taps), stap(reinterpret_cast<unsigned*>(part.stap)),
        ef(part.ef) {}

  __device__ __forceinline__ float* slot(int s) const {
    return reinterpret_cast<float*>(p.slots[2 * s]);
  }
  __device__ __forceinline__ const int16_t* slot16(int s) const {
    return reinterpret_cast<const int16_t*>(slot(s));
  }
  __device__ __forceinline__ const float* par(int i) const { return p.pf + i; }
};

// the chunks an op covers: [k0, k0 + n)
struct Chunks {
  int k0, n;
};

// a = [dst, x, agg, sf, p_gains, p_tab, ef, sample_rate]; `tile` is the
// dynamic shared memory (eq_scan::tile_floats(128, L) floats).  The
// cooperative form: CTA blockIdx.x of the row's grid.
template <class R>
__device__ void eq_op(const R& r, const int* a, cg::grid_group& grid, float* tile) {
  __shared__ eq_scan::Shared sh;
  float* out = r.slot(a[0]);
  const float* x = r.slot(a[1]);
  float* agg = r.slot(a[2]);
  const float* sf = r.sf + a[3];
  const float* tab = r.par(a[5]);
  float* ef = r.ef + a[6];
  const int S = r.p.S, lg = r.p.lg;
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
  eq_scan::scan_down(xs, xds, S, tile0, lg, c, r.par(a[4]), sh, agg, sf, en, ef, ef + 8);
  __syncthreads();
  eq_scan::unstage(xs, S, tile0, lg, out);
  __syncthreads();  // the next ops read `out` thread by thread
}

// Tile samples [tile0, tile0 + 128 << lg) of src into dst at the staged
// positions, 0 from `end` on: plain loads, as src may be a tile buffer in
// shared memory.
__device__ __forceinline__ void stage_plain(const float* src, int end, int tile0, int lg,
                                            float* dst) {
  const int n4 = (kChunk << lg) >> 2;
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int q = threadIdx.x; q < n4; q += kChunk) {
    const int j = q * 4, s = tile0 + j;
    float v[4];
    if (vec && s + 3 < end) {
      const float4 w = *reinterpret_cast<const float4*>(src + s);
      v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = s + e < end ? src[s + e] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[eq_scan::pos(j + e, lg)] = v[e];
  }
}

// max(|l|, |r|) over the chunks as bit patterns (for non-negative floats the
// unsigned order is the float order, and a NaN is above +inf, so it wins as
// jnp.max lets it), into the row's scalar tap: atomically where several
// CTAs share the row, else by thread 0, the only one that touches it.
template <bool kAtomic, class R>
__device__ void peak_op(const R& row, const int* a, Chunks ch) {
  __shared__ unsigned warp_max[kChunk / 32];
  const float* l = row.slot(a[1]);
  const float* r = row.slot(a[2]);
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
    if (kAtomic) {
      atomicMax(row.stap + a[0], m);
    } else {
      row.stap[a[0]] = max(row.stap[a[0]], m);
    }
  }
  __syncthreads();  // warp_max is free again
}

// One elementwise op over this thread's samples of the chunks, kBatch
// chunks at a time: every load of a batch before its first store.
template <class R>
__device__ void elementwise_op(const R& r, int code, const int* a, Chunks ch) {
  for (int u0 = 0; u0 < ch.n; u0 += kBatch) {
    const int t0 = (ch.k0 + u0) * kChunk + threadIdx.x;
    const int m = min(kBatch, ch.n - u0);
    float v[kBatch];
    switch (code) {
      case kFill: {
        float* dst = r.slot(a[0]);
        const float val = 0.0f + *r.par(a[1]);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) dst[t0 + u * kChunk] = val;
        }
        break;
      }
      case kAmp: {
        const float* src = r.slot(a[1]);
        float* dst = r.slot(a[0]);
        const float amp = *r.par(a[2]);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) v[u] = src[t0 + u * kChunk];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) dst[t0 + u * kChunk] = v[u] * amp;
        }
        break;
      }
      case kAmpMod: {
        const float* src = r.slot(a[1]);
        const float* mod = r.slot(a[2]);
        float* dst = r.slot(a[0]);
        const float amp = *r.par(a[3]), md = *r.par(a[4]);
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
            dst[t0 + u * kChunk] = v[u] * scale;
          }
        }
        break;
      }
      case kMix: {
        const int n = a[1];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) v[u] = 0.0f;
        for (int j = 0; j < n; ++j) {
          const float* src = r.slot(a[2 + j]);
          const float w = *r.par(a[2 + n + j]);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (u < m) v[u] = v[u] + w * src[t0 + u * kChunk];
          }
        }
        float* dst = r.slot(a[0]);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) dst[t0 + u * kChunk] = v[u];
        }
        break;
      }
      case kI16: {
        const int16_t* src = r.slot16(a[1]);
        float* dst = r.slot(a[0]);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) v[u] = static_cast<float>(src[t0 + u * kChunk]) * (1.0f / 32768.0f);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u < m) dst[t0 + u * kChunk] = v[u];
        }
        break;
      }
      case kTap: {
        const float* src = r.slot(a[1]);
        float* dst = r.taps + static_cast<size_t>(a[0]) * r.p.S;
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

// The cooperative form: CTA (blockIdx.x, blockIdx.y) owns chunks
// [x * L, x * L + L) of row y; R is Block for a single block, else Row.
template <class R>
__global__ void __launch_bounds__(kChunk) region_kernel(Part p) {
  extern __shared__ float4 smem[];  // the EQ's staged tile
  float* tile = reinterpret_cast<float*>(smem);
  cg::grid_group grid = cg::this_grid();
  const R r(p, blockIdx.y);
  const int k0 = blockIdx.x << p.lg;
  const Chunks ch{k0, max(0, min(1 << p.lg, p.K - k0))};
  if (blockIdx.x == 0) {
    for (int j = threadIdx.x; j < p.n_stap; j += kChunk) r.stap[j] = 0u;
  }
  for (int pc = 0; pc < p.n_words;) {
    const int code = p.ops[pc];
    const int len = p.ops[pc + 1];
    const int* a = p.ops + pc + 2;
    pc += len;
    if (code == kSync) {
      grid.sync();
    } else if (code == kEq) {
      eq_op(r, a, grid, tile);
    } else if (code == kPeak) {
      peak_op<true, R>(r, a, ch);
    } else {
      elementwise_op(r, code, a, ch);
    }
  }
}

// ---- the batched rows forms (csrc/rows.cuh) --------------------------------
// A tile is 128 << lg samples; every operand tile the plan reads is copied
// into shared memory ahead (cp.async), the scratch slots are tiles in shared
// memory, every op reads shared memory and the taps go out as float4 stores.
// The carry of each EQ op is its poles and its last 3 inputs, laid out as
// its state row (sf: poles [4][2], then the 3 inputs); an EQ op's aggregate
// is its tile's response from zero state (eq_scan's affine entry E; the map
// is A^(128 << lg), from the table).

constexpr int kCarry = 12;   // floats of an EQ op's carry
constexpr int kRecord = 32;  // floats of a look-back status record (128 bytes)

struct RowsExtra {
  int tiles;      // tiles a row
  int batch;
  int n_eq;       // EQ ops in the plan
  int n_scratch;  // the plan's scratch slots (past its operands)
  unsigned i16;   // operand slots read as i16 (bit s)
  unsigned* tickets;  // look-back: the header (rows::kHeader), a flag a row, the records
  unsigned seq;       // look-back: the launch's number, read on the device
};

// What a CTA of a batched rows form sees of its row's tile: operand slots
// in this tile's staged buffer, scratch slots in their tiles, both
// addressed by the part's sample index.
struct TileRow {
  const Part& p;
  long long b;
  const float* pf;
  const float* sf;
  float* taps;
  unsigned* stap;
  float* ef;
  float* staged;
  float* local;
  int n, tile0;

  __device__ TileRow(const Part& part, int row, float* stg, float* loc, int tile_n, int t0)
      : p(part), b(row), pf(part.pf + row * part.pf_stride), sf(part.sf + row * part.sf_stride),
        taps(part.taps + static_cast<long long>(row) * part.n_taps * part.S),
        stap(reinterpret_cast<unsigned*>(part.stap) + static_cast<long long>(row) * part.n_stap),
        ef(part.ef + static_cast<long long>(row) * part.n_ef), staged(stg), local(loc),
        n(tile_n), tile0(t0) {}

  __device__ __forceinline__ float* base(int s) const {
    return s < p.n_operands ? staged + s * n : local + (s - p.n_operands) * n;
  }
  __device__ __forceinline__ float* slot(int s) const { return base(s) - tile0; }
  __device__ __forceinline__ const int16_t* slot16(int s) const {
    return reinterpret_cast<const int16_t*>(base(s)) - tile0;
  }
  __device__ __forceinline__ const float* par(int i) const {
    return i < p.n_pf ? pf + i : p.consts + (i - p.n_pf);
  }
};

// Copy samples [tile0, tile0 + m) of every operand of row `row` into its
// tile of dst (n floats a slot; an i16 operand fills half of it): 16-byte
// cp.async where the row is 16-byte aligned, else 4-byte ones, else plain
// loads; one commit group.
__device__ __forceinline__ void stage_operands(const Part& p, const RowsExtra& e, long long row,
                                               int tile0, int m, float* dst, int n) {
  for (int s = 0; s < p.n_operands; ++s) {
    const int esz = ((e.i16 >> s) & 1) ? 2 : 4;
    const char* src = reinterpret_cast<const char*>(p.slots[2 * s] + row * p.slots[2 * s + 1]) +
                      static_cast<long long>(tile0) * esz;
    char* d = reinterpret_cast<char*>(dst + s * n);
    const int bytes = m * esz;
    const uintptr_t at = reinterpret_cast<uintptr_t>(src);
    if ((at & 15) == 0) {
      for (int q = threadIdx.x * 16; q < bytes; q += kChunk * 16) rows::cp_async16(d + q, src + q);
    } else if ((at & 3) == 0) {
      for (int q = threadIdx.x * 4; q < bytes; q += kChunk * 4) rows::cp_async4(d + q, src + q);
    } else {
      for (int q = threadIdx.x * 2; q < bytes; q += kChunk * 2) {
        *reinterpret_cast<int16_t*>(d + q) = *reinterpret_cast<const int16_t*>(src + q);
      }
    }
  }
  rows::cp_async_commit();
}

// TAP: the slot's tile out to the row's taps as float4 stores, after a
// barrier where an op since the last one wrote thread by thread (a plan
// writes each slot once a tile, so no later op of the tile overwrites
// what the stores read)
__device__ __forceinline__ void tap_rows(const TileRow& r, const int* a, int m, bool synced) {
  if (!synced) __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(r.base(a[1]));
  float4* dst = reinterpret_cast<float4*>(r.taps + static_cast<size_t>(a[0]) * r.p.S + r.tile0);
  for (int q = threadIdx.x; q < m / 4; q += kChunk) dst[q] = src[q];
}

// What an EQ op of a batched rows form keeps in shared memory and registers
struct EqRows {
  eq_scan::Shared& sh;
  const float*& tab_in_sh;  // whose table sh.tab holds
  eq_scan::Maps& maps;      // its thread_maps
  float* tile;              // the staged x and xd
  float* carry;             // [2][n_eq][kCarry] (one CTA a row), by tile parity
  float* entry;             // [kCarry]: the tile's entry poles and its 3 inputs before
};

// The EQ over tile t of a row in a batched rows form.  kLookback: the
// tile's entry from the look-back over the row's status records of this
// EQ op (qi); else from the CTA's own carry, which pass 2 leaves for the
// next tile (q: the tile's parity).
template <bool kLookback>
__device__ __forceinline__ void eq_op_rows(const TileRow& r, const int* a, int qi,
                                           const RowsExtra& e, const EqRows& w, int q, int t) {
  const int lg = r.p.lg, n = kChunk << lg, tile0 = r.tile0, S = r.p.S;
  const int end = min(tile0 + n, S);
  const bool last = t == e.tiles - 1;
  const int k = threadIdx.x;
  float* out = r.slot(a[0]);
  const float* x = r.slot(a[1]);
  const float* tab = r.par(a[5]);
  float* ef = r.ef + a[6];
  float* xs = w.tile;
  float* xds = w.tile + n + kChunk;
  float* next = w.carry + ((q ^ 1) * e.n_eq + qi) * kCarry;
  __syncthreads();  // the ops before wrote x thread by thread; sh.tab is free
  if (w.tab_in_sh != tab) {  // once a CTA unless the plan has several EQ ops
    eq_scan::load_table(tab, w.sh);
    __syncthreads();
    w.maps = eq_scan::thread_maps(w.sh.tab, lg);
    if (k == 0) w.tab_in_sh = tab;
  }
  const eq_scan::Coeffs cf{{w.sh.tab[eq_scan::kA], w.sh.tab[eq_scan::kA + 1]},
                           {__ldg(tab + kF), __ldg(tab + kF + 1)}, __ldg(tab + kVsa)};
  stage_plain(x, end, tile0, lg, xs);
  __syncthreads();
  // sh.warp[3]: the tile's aggregate
  const eq_scan::Entry en = eq_scan::scan_up<true>(xs, lg, cf, w.sh, nullptr, &w.maps);
  if (!kLookback) {
    if (k < kCarry) w.entry[k] = w.carry[(q * e.n_eq + qi) * kCarry + k];
  } else {
    float* status =
        reinterpret_cast<float*>(e.tickets + rows::kHeader + ((e.batch + 3) & ~3));
    const long long row0 = r.b * e.tiles;  // the row's first record index
    auto rec = [&](int tile) { return status + ((row0 + tile) * e.n_eq + qi) * kRecord; };
    float* mine = rec(t);
    unsigned* flag = reinterpret_cast<unsigned*>(mine + kRecord - 1);
    const int ltile = lg + 7;  // log2 of the tile's samples
    if (k == 0) {  // the aggregate and the tile's last 3 inputs, then the flag
#pragma unroll
      for (int i = 0; i < 8; ++i) mine[i] = w.sh.warp[3][i];
      for (int i = 0; i < 3; ++i) mine[8 + i] = x[end - 3 + i];
      rows::store_release(flag, rows::tag(e.seq, rows::kAggregate));
    }
    if (k < 32) {
      const unsigned fa = rows::tag(e.seq, rows::kAggregate);
      const unsigned fp = rows::tag(e.seq, rows::kInclusive);
      const int idx = t - 32 + k;  // lane 31: the tile before
      int pl = 0;
      for (;;) {
        const unsigned* at = reinterpret_cast<const unsigned*>(rec(idx) + kRecord - 1);
        const unsigned f = idx < 0 ? fp : rows::load_relaxed(at);
        const unsigned pm = __ballot_sync(0xffffffffu, f == fp);
        const unsigned rm = __ballot_sync(0xffffffffu, f == fp || f == fa);
        if (pm) {
          pl = 31 - __clz(pm);
          const unsigned after = pl == 31 ? 0u : 0xffffffffu << (pl + 1);
          if ((rm & after) == after) break;
        }
        __nanosleep(64);
      }
      __threadfence();  // the records read below were written before their flags
      // from the nearest inclusive state (before tile 0: the state row), the
      // aggregates after it in order: y <- A^n y + E
      eq_scan::State y = eq_scan::zero_state(), v = eq_scan::zero_state();
      if (k == pl) {
        const float* src = idx < 0 ? r.sf + a[3] : rec(idx) + 16;
#pragma unroll
        for (int i = 0; i < 8; ++i) v.y[i & 1][i >> 1] = __ldcg(src + i);  // poles [4][2]
      } else if (k > pl) {
#pragma unroll
        for (int i = 0; i < 8; ++i) v.y[i >> 2][i & 3] = __ldcg(rec(idx) + i);
      }
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int i = 0; i < 4; ++i) y.y[b][i] = __shfl_sync(0xffffffffu, v.y[b][i], pl);
      for (int j = pl + 1; j < 32; ++j) {
        eq_scan::State ej;
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int i = 0; i < 4; ++i) ej.y[b][i] = __shfl_sync(0xffffffffu, v.y[b][i], j);
        eq_scan::absorb(ej, y, w.sh.tab, ltile);
        y = ej;
      }
      if (k == 0) {
        eq_scan::store_poles(w.entry, y);
        for (int i = 0; i < 3; ++i) {
          w.entry[8 + i] = t == 0 ? r.sf[a[3] + 8 + i] : __ldcg(rec(t - 1) + 8 + i);
        }
        // this tile's exit, A^n y + E: later tiles need not wait for pass 2
        eq_scan::State ex;
#pragma unroll
        for (int i = 0; i < 8; ++i) ex.y[i >> 2][i & 3] = w.sh.warp[3][i];
        eq_scan::absorb(ex, y, w.sh.tab, ltile);
        eq_scan::store_poles(mine + 16, ex);
        rows::store_release(flag, rows::tag(e.seq, rows::kInclusive));
      }
    }
  }
  __syncthreads();  // the entry is written
  for (int j = k; j < n; j += kChunk) {
    xds[eq_scan::pos(j, lg)] = j >= 3 ? xs[eq_scan::pos(j - 3, lg)] : w.entry[8 + j];
  }
  __syncthreads();
  const eq_scan::State s = eq_scan::affine(en.M, eq_scan::load_poles(w.entry), en.E);
  // the poles at the tile's last sample: the part's exits, or (one CTA a
  // row) the next tile's carry
  eq_scan::run_down(xs, xds, end, tile0, lg, cf, r.par(a[4]), s,
                    last ? ef : (kLookback ? nullptr : next));
  if (k < 3) {
    if (last) {
      ef[8 + k] = x[S - 3 + k];
    } else if (!kLookback) {
      next[8 + k] = x[end - 3 + k];
    }
  }
  __syncthreads();
  eq_scan::unstage(xs, end, tile0, lg, out);
  __syncthreads();  // the next ops read `out` thread by thread
}

// The plan over one tile of a batched rows form
template <bool kLookback>
__device__ __forceinline__ void run_plan(const Part& p, const RowsExtra& e, const TileRow& r,
                                         const EqRows& w, int q, int t) {
  const int k0 = r.tile0 / kChunk;
  const Chunks ch{k0, min(1 << p.lg, p.K - k0)};
  int qi = 0;
  bool synced = true;  // no op has written thread by thread since the last barrier
  for (int pc = 0; pc < p.n_words;) {
    const int code = p.ops[pc];
    const int len = p.ops[pc + 1];
    const int* a = p.ops + pc + 2;
    pc += len;
    if (code == kSync) {
      continue;  // the scalar taps were zeroed before any PEAK
    } else if (code == kEq) {
      eq_op_rows<kLookback>(r, a, qi++, e, w, q, t);
      synced = true;
    } else if (code == kPeak) {
      peak_op<true, TileRow>(r, a, ch);
      synced = true;
    } else if (code == kTap) {
      tap_rows(r, a, ch.n * kChunk, synced);
      synced = true;
    } else {
      elementwise_op(r, code, a, ch);
      synced = false;
    }
  }
}

// shared memory of the rows forms in floats: two staged buffers of the
// operands, the scratch tiles, the EQ's staged tile, then the EQ carries
// and the entry
__host__ __device__ constexpr size_t rows_floats(int run, int n_operands, int n_scratch,
                                                 int n_eq) {
  return static_cast<size_t>(2 * n_operands + n_scratch) * kChunk * run +
         eq_scan::tile_floats(kChunk, run) + static_cast<size_t>(2 * n_eq + 1) * kCarry;
}

struct RowsSmem {
  float* stage;  // [2][n_operands][n]
  float* local;
  float* tile;
  float* carry;
  float* entry;
};

__device__ __forceinline__ RowsSmem rows_smem(float* smem, const Part& p, const RowsExtra& e) {
  const int n = kChunk << p.lg;
  RowsSmem m;
  m.stage = smem;
  m.local = m.stage + 2 * p.n_operands * n;
  m.tile = m.local + e.n_scratch * n;
  m.carry = m.tile + eq_scan::tile_floats(kChunk, 1 << p.lg);
  m.entry = m.carry + 2 * e.n_eq * kCarry;
  return m;
}

// One CTA a row (blockIdx.x): its tiles in order, every EQ op's carry in
// shared memory, the next tile's operands staged while this one runs.
__global__ void __launch_bounds__(kChunk) region_rows_kernel(Part p, RowsExtra e) {
  extern __shared__ float4 smem4[];
  __shared__ eq_scan::Shared sh;
  __shared__ const float* tab_in_sh;
  eq_scan::Maps maps;
  const int row = blockIdx.x, n = kChunk << p.lg, k = threadIdx.x;
  const RowsSmem m = rows_smem(reinterpret_cast<float*>(smem4), p, e);
  const EqRows w{sh, tab_in_sh, maps, m.tile, m.carry, m.entry};
  if (k == 0) {
    tab_in_sh = nullptr;
    unsigned* stap = reinterpret_cast<unsigned*>(p.stap) + static_cast<long long>(row) * p.n_stap;
    for (int j = 0; j < p.n_stap; ++j) stap[j] = 0u;
    // every EQ op's carry starts as its state row
    const float* sf = p.sf + row * p.sf_stride;
    int qi = 0;
    for (int pc = 0; pc < p.n_words; pc += p.ops[pc + 1]) {
      if (p.ops[pc] != kEq) continue;
      for (int i = 0; i < 11; ++i) m.carry[qi * kCarry + i] = sf[p.ops[pc + 2 + 3] + i];
      ++qi;
    }
  }
  const int buf = p.n_operands * n;
  stage_operands(p, e, row, 0, min(n, p.S), m.stage, n);
  for (int t = 0; t < e.tiles; ++t) {
    if (t + 1 < e.tiles) {
      stage_operands(p, e, row, (t + 1) * n, min(n, p.S - (t + 1) * n),
                     m.stage + ((t + 1) & 1) * buf, n);
    } else {
      rows::cp_async_commit();
    }
    rows::cp_async_wait<1>();
    __syncthreads();
    const TileRow tr(p, row, m.stage + (t & 1) * buf, m.local, n, t * n);
    run_plan<false>(p, e, tr, w, t & 1, t);
    __syncthreads();  // the tiles are free again
  }
}

// The look-back form: as many CTAs as the card holds, each taking tiles by
// ticket (row-major) and staging its next ticket's operands while it runs
// this one.
__global__ void __launch_bounds__(kChunk) region_lookback_kernel(Part p, RowsExtra e) {
  extern __shared__ float4 smem4[];
  __shared__ eq_scan::Shared sh;
  __shared__ const float* tab_in_sh;
  __shared__ unsigned ticket[2], launch;
  eq_scan::Maps maps;
  const int n = kChunk << p.lg, k = threadIdx.x;
  const RowsSmem m = rows_smem(reinterpret_cast<float*>(smem4), p, e);
  const EqRows w{sh, tab_in_sh, maps, m.tile, m.carry, m.entry};
  const unsigned total = static_cast<unsigned>(e.batch) * static_cast<unsigned>(e.tiles);
  unsigned* rowflag = e.tickets + rows::kHeader;
  const int buf = p.n_operands * n;
  auto stage = [&](unsigned t, float* dst) {
    if (t < total) {
      const int row = static_cast<int>(t / e.tiles), tile = static_cast<int>(t % e.tiles);
      stage_operands(p, e, row, tile * n, min(n, p.S - tile * n), dst, n);
    } else {
      rows::cp_async_commit();
    }
  };
  if (k == 0) {
    tab_in_sh = nullptr;
    launch = rows::launch_number(e.tickets);
    ticket[0] = rows::take_ticket(e.tickets);
  }
  __syncthreads();
  e.seq = launch;
  stage(ticket[0], m.stage);
  for (int i = 0;; ++i) {
    const unsigned t = ticket[i & 1];
    if (t >= total) break;
    if (k == 0) ticket[(i + 1) & 1] = rows::take_ticket(e.tickets);
    __syncthreads();
    stage(ticket[(i + 1) & 1], m.stage + ((i + 1) & 1) * buf);
    rows::cp_async_wait<1>();
    const int row = static_cast<int>(t / e.tiles), tile = static_cast<int>(t % e.tiles);
    if (p.n_stap > 0 && k == 0) {  // tile 0 zeroes the row's scalar taps before any PEAK
      if (tile == 0) {
        unsigned* stap = reinterpret_cast<unsigned*>(p.stap) + row * p.n_stap;
        for (int j = 0; j < p.n_stap; ++j) stap[j] = 0u;
        rows::store_release(rowflag + row, e.seq);
      } else {
        while (rows::load_relaxed(rowflag + row) != e.seq) __nanosleep(64);
        __threadfence();
      }
    }
    __syncthreads();
    const TileRow tr(p, row, m.stage + (i & 1) * buf, m.local, n, tile * n);
    run_plan<true>(p, e, tr, w, 0, tile);
    __syncthreads();  // the tiles are free again
  }
  if (k == 0) rows::leave(e.tickets, e.seq);
}

size_t shared_bytes(int run) { return eq_scan::tile_floats(kChunk, run) * sizeof(float); }

cudaError_t allow_shared(int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const int bytes = static_cast<int>(shared_bytes(eq_scan::kMaxRun));
  cudaError_t err = cudaFuncSetAttribute(region_kernel<Block>, attr, bytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(region_kernel<Row>, attr, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(region_rows_kernel, attr, static_cast<int>(kRowsShared));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(region_lookback_kernel, attr, static_cast<int>(kRowsShared));
  }
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

}  // namespace

extern "C" {

// CTAs of the region kernel's cooperative form that one card holds at once
// at the longest run, into *resident; the wrapper sizes its grid by it.
// Returns a cudaError_t (0 = cudaSuccess).
int mixlab_region_resident_tiles(int device, int* resident) {
  *resident = 0;
  OnDevice on(device);
  cudaError_t err = on.error();
  int n_sm = 0, per_sm = 0;
  if (err == cudaSuccess) err = allow_shared(device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  }
  // the fewer of the single and the batched grid's CTAs a card holds
  int batched = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, region_kernel<Block>, kChunk,
                                                        shared_bytes(eq_scan::kMaxRun));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&batched, region_kernel<Row>, kChunk,
                                                        shared_bytes(eq_scan::kMaxRun));
  }
  *resident = (per_sm < batched ? per_sm : batched) * n_sm;
  return static_cast<int>(err);
}

// CTAs of a batched rows form (form 1: one CTA a row; form 2: the
// look-back) for a plan of n_operands operands, n_scratch scratch slots and
// n_eq EQ ops in tiles of `run` chunks, that one card holds at once, into
// *resident (0 where the tiles do not fit a CTA's shared memory).
int mixlab_region_rows_resident(int form, int run, int n_operands, int n_scratch, int n_eq,
                                int device, int* resident) {
  *resident = 0;
  if ((form != 1 && form != 2) || run < 1 || run > eq_scan::kMaxRun || n_operands < 0 ||
      n_scratch < 0 || n_eq < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = rows_floats(run, n_operands, n_scratch, n_eq) * sizeof(float);
  if (smem > kRowsShared) return 0;
  OnDevice on(device);
  cudaError_t err = on.error();
  if (err == cudaSuccess) err = allow_shared(device);
  int n_sm = 0, per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, form == 1 ? region_rows_kernel : region_lookback_kernel, kChunk, smem);
  }
  *resident = per_sm * n_sm;
  return static_cast<int>(err);
}

// `batch` rows of one part of S samples (a positive multiple of 128, at most
// kMaxChunks chunks).  Every pointer is a device pointer: ops [n_words]
// int32 (the plan); slots [n_slots][2] int64, each slot's address and row
// stride in bytes (row b of the slot at address + b * stride; S elements a
// row; the operands first, n_operands of them; with form 0 the scratch
// slots are [batch][S] f32 buffers, the EQ's scratch slot 16-byte aligned,
// else unread); pf (row b at pf + b * pf_stride floats, n_pf param
// scalars), consts (the plan's constants), sf (row b at sf + b * sf_stride
// floats); taps [batch][n_taps][S], stap [batch][n_stap] and ef [batch]
// [n_ef] are written.  Form 0: a cooperative grid of `tiles` x `batch` CTAs
// of `run` chunks each (a power of two, at most eq_scan::kMaxRun; every CTA
// of a row but the last full, the last holding the last chunk).  Form 1:
// one CTA a row, `tiles` tiles of `run` chunks a row, the next one staged.
// Form 2: the look-back over `ctas` CTAs, `tiles` tiles of `run` chunks a
// row; `scratch` holds the header of csrc/rows.cuh (16 bytes, the launch's
// number among them), a flag a row (rounded up to 4), then batch x tiles x
// n_eq records of 128 bytes, zeroed once when the wrapper made it and never
// by a launch.  Forms 1 and 2 read
// operand slot s as i16 where bit s of i16_mask is set (the plan's I16
// sources; at most 32 operands) and the plan has n_eq EQ ops.  The launch
// goes to card `device`.  Returns the launch's cudaError_t (0 =
// cudaSuccess); a cooperative grid larger than the card holds at once is
// refused by the launch.
int mixlab_region_part(const int* ops, int n_words, const long long* slots, int n_operands,
                       int n_slots, const float* pf, long long pf_stride, int n_pf,
                       const float* consts, const float* sf, long long sf_stride, float* taps,
                       int n_taps, float* stap, int n_stap, float* ef, int n_ef, int S, int batch,
                       int form, int run, int tiles, int ctas, int n_eq, unsigned i16_mask,
                       void* scratch, int device, void* stream_ptr) {
  const int K = S / kChunk;
  const bool rows_form = form == 1 || form == 2;
  bool bad = S <= 0 || S % kChunk != 0 || K > kMaxChunks || run < 1 ||
             run > eq_scan::kMaxRun || (run & (run - 1)) != 0 || batch < 1 ||
             n_operands < 0 || n_slots < n_operands || form < 0 || form > 2;
  if (form == 0) {
    bad = bad || batch > 65535 || tiles < 1 || tiles * run < K || (tiles - 1) * run >= K;
  } else {
    bad = bad || tiles != (K + run - 1) / run || n_eq < 0 || n_operands > 32 ||
          rows_floats(run, n_operands, n_slots - n_operands, n_eq) * sizeof(float) > kRowsShared ||
          static_cast<long long>(batch) * tiles > 0x7fffffffLL ||
          (form == 2 && (ctas < 1 || scratch == nullptr));
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  OnDevice on(device);
  if (on.error() != cudaSuccess) return static_cast<int>(on.error());
  cudaError_t err = allow_shared(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int lg = 0;
  while ((1 << lg) < run) ++lg;
  Part p{ops, n_words, slots, n_operands, pf, pf_stride, n_pf, consts, sf, sf_stride,
         taps, n_taps, stap, n_stap, ef, n_ef, S, K, lg};
  const cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  if (rows_form) {
    const RowsExtra e{tiles, batch, n_eq, n_slots - n_operands, i16_mask,
                      static_cast<unsigned*>(scratch), 0u};
    const size_t smem = rows_floats(run, n_operands, n_slots - n_operands, n_eq) * sizeof(float);
    if (form == 1) {
      region_rows_kernel<<<batch, kChunk, smem, st>>>(p, e);
    } else {
      region_lookback_kernel<<<ctas, kChunk, smem, st>>>(p, e);
    }
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&p};
  // one block whose constants follow its param scalars: the kernel without
  // the row offsets, as before the batch axis
  const void* kernel = batch == 1 && consts == pf + n_pf
                           ? reinterpret_cast<const void*>(region_kernel<Block>)
                           : reinterpret_cast<const void*>(region_kernel<Row>);
  err = cudaLaunchCooperativeKernel(kernel, dim3(tiles, batch), dim3(kChunk), args,
                                    shared_bytes(run), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
