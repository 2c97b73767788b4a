// The host C++ of the port's served path and media playback (the port's
// copy of mixlab_tpu/native/mixlab_native.cpp, exposed via ctypes, see
// __init__.py):
//
//   * lock-free SPSC byte ring buffer — the ingest fabric, equivalent of the
//     reference's `ringbuf` SPSC rings (src/source.rs:97-98, 65536 slots);
//   * PCM sample conversion f32<->i16 (clamp+scale semantics of
//     video/encode.rs:186-199 and stream_input.rs:167-173);
//   * u8 crossfade with exact (a*f + b*(255-f))/255 semantics
//     (video_mixer.rs:210-235), a host reference of the crossfade kernel;
//   * WebSocket XOR unmasking (RFC 6455 §5.3) — per-byte in Python, word-wide
//     here (server/ws.py);
//   * the H.264 CAVLC Intra_16x16 frame encoder, the monitor's fastest
//     zero-dependency video tier (av/h264cavlc_fast.py);
//   * the H.264 decoders: the CAVLC intra pass-1 parse and DC reconstruction
//     (av/h264dec_fast.py), the full intra slice decoders (CAVLC and CABAC)
//     and the P/B slice decoder (av/h264dec.py, av/h264cabac.py).  One
//     difference from the JAX package's copy: Bits::ue() takes up to 31
//     leading zeros, as the Python tier's reader does.
//
// Host code, not a device kernel.
// Build: g++ -O3 -march=native -shared -fPIC -o libmixlab_native.so mixlab_native.cpp

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC ring buffer (byte-oriented, power-of-two capacity)
// ---------------------------------------------------------------------------

struct SpscRing {
    uint8_t* data;
    uint64_t capacity;  // power of two
    std::atomic<uint64_t> head;  // written by producer
    std::atomic<uint64_t> tail;  // written by consumer
};

SpscRing* ring_create(uint64_t capacity_pow2) {
    if (capacity_pow2 == 0 || (capacity_pow2 & (capacity_pow2 - 1)) != 0) {
        return nullptr;
    }
    auto* r = new SpscRing();
    r->data = static_cast<uint8_t*>(std::malloc(capacity_pow2));
    if (!r->data) { delete r; return nullptr; }
    r->capacity = capacity_pow2;
    r->head.store(0, std::memory_order_relaxed);
    r->tail.store(0, std::memory_order_relaxed);
    return r;
}

void ring_destroy(SpscRing* r) {
    if (r) { std::free(r->data); delete r; }
}

uint64_t ring_size(const SpscRing* r) {
    return r->head.load(std::memory_order_acquire) -
           r->tail.load(std::memory_order_acquire);
}

uint64_t ring_capacity(const SpscRing* r) { return r->capacity; }

// returns bytes written (0 if insufficient space: all-or-nothing)
uint64_t ring_push(SpscRing* r, const uint8_t* src, uint64_t n) {
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    if (r->capacity - (head - tail) < n) return 0;
    uint64_t mask = r->capacity - 1;
    uint64_t off = head & mask;
    uint64_t first = off + n <= r->capacity ? n : r->capacity - off;
    std::memcpy(r->data + off, src, first);
    if (first < n) std::memcpy(r->data, src + first, n - first);
    r->head.store(head + n, std::memory_order_release);
    return n;
}

// returns bytes read (<= n)
uint64_t ring_pop(SpscRing* r, uint8_t* dst, uint64_t n) {
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    uint64_t head = r->head.load(std::memory_order_acquire);
    uint64_t avail = head - tail;
    if (n > avail) n = avail;
    if (n == 0) return 0;
    uint64_t mask = r->capacity - 1;
    uint64_t off = tail & mask;
    uint64_t first = off + n <= r->capacity ? n : r->capacity - off;
    std::memcpy(dst, r->data + off, first);
    if (first < n) std::memcpy(dst + first, r->data, n - first);
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

// ---------------------------------------------------------------------------
// PCM conversion
// ---------------------------------------------------------------------------

void pcm_f32_to_i16(const float* src, int16_t* dst, uint64_t n) {
    for (uint64_t i = 0; i < n; i++) {
        float s = src[i];
        if (s > 1.0f) s = 1.0f;
        if (s < -1.0f) s = -1.0f;
        dst[i] = static_cast<int16_t>(s * 32767.0f);
    }
}

void pcm_i16_to_f32(const int16_t* src, float* dst, uint64_t n) {
    const float k = 1.0f / 32768.0f;
    for (uint64_t i = 0; i < n; i++) dst[i] = src[i] * k;
}

// ---------------------------------------------------------------------------
// crossfade: out = (a*fade + b*(255-fade)) / 255, truncating
// ---------------------------------------------------------------------------

void crossfade_u8(const uint8_t* a, const uint8_t* b, uint8_t* out,
                  uint64_t n, uint8_t fade) {
    uint32_t fa = fade, fb = 255 - fade;
    for (uint64_t i = 0; i < n; i++) {
        uint32_t acc = a[i] * fa + b[i] * fb;
        out[i] = static_cast<uint8_t>((acc * 32897u) >> 23);
    }
}

// ---------------------------------------------------------------------------
// WebSocket unmask (RFC 6455 §5.3): payload[i] ^= mask[i % 4]
// ---------------------------------------------------------------------------

void ws_unmask(uint8_t* payload, uint64_t n, const uint8_t mask[4]) {
    uint64_t m8;
    uint8_t m[8] = {mask[0], mask[1], mask[2], mask[3],
                    mask[0], mask[1], mask[2], mask[3]};
    std::memcpy(&m8, m, 8);
    uint64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t w;
        std::memcpy(&w, payload + i, 8);
        w ^= m8;
        std::memcpy(payload + i, &w, 8);
    }
    for (; i < n; i++) payload[i] ^= mask[i & 3];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// H.264 CAVLC Intra_16x16 ENCODER (native twin of av/h264cavlc.py)
//
// The pure encoder's entropy coding + wavefront reconstruction are the serial
// parts that cap the zero-dep monitor tier's frame rate (the numpy batch
// encoder in av/h264cavlc_fast.py spends its time in argsort/bit packing).
// This is a statement-for-statement C++ port of the scalar oracle
// CavlcIntraEncoder (av/h264cavlc.py:285-521, spec 8.3/8.5/9.2): same
// per-MB raster walk, same DC prediction, transform/quant/dequant integer
// math, CAVLC writer, and reconstruction.  Byte-identical output is asserted
// against BOTH Python encoders in tests/test_h264cavlc_fast.py.  The VLC
// tables are passed in from Python (packed by av/h264cavlc_fast.py) so
// h264cavlc.py stays the single source of truth — the same discipline as the
// decoder's packed-table parse above.
// Reference scope: codec/src/avc/encode.rs (the reference links x264 FFI).
// ---------------------------------------------------------------------------

namespace h264enc {

// packed int16 table layout (offsets in elements); order matches
// _pack_encoder_tables in av/h264cavlc_fast.py
constexpr int kCtBits = 0;            // [4][68]
constexpr int kCtLen = 272;           // [4][68]
constexpr int kCdcBits = 544;         // [20]
constexpr int kCdcLen = 564;          // [20]
constexpr int kTzBits = 584;          // [16][16]
constexpr int kTzLen = 840;           // [16][16]
constexpr int kCtzBits = 1096;        // [3][4]
constexpr int kCtzLen = 1108;         // [3][4]
constexpr int kRunBits = 1120;        // [7][16]
constexpr int kRunLen = 1232;         // [7][16]
constexpr int kTablesTotal = 1344;

struct BitWriter {
    uint8_t* out;
    int64_t cap;
    int64_t n;       // bytes written
    uint64_t acc;    // pending bits (LSB-aligned, like the Python acc)
    int nbits;
    bool overflow;

    inline void u(uint64_t value, int k) {
        if (k == 0) return;
        acc = (acc << k) | (value & ((k >= 64 ? ~0ull : (1ull << k) - 1)));
        nbits += k;
        while (nbits >= 8) {
            nbits -= 8;
            if (n >= cap) { overflow = true; return; }
            out[n++] = static_cast<uint8_t>((acc >> nbits) & 0xFF);
        }
        acc &= (1ull << nbits) - 1;
    }

    inline void ue(int64_t value) {
        uint64_t v = static_cast<uint64_t>(value) + 1;
        int nb = 64 - __builtin_clzll(v);
        u(0, nb - 1);
        u(v, nb);
    }

    inline void se(int64_t value) {
        ue(value > 0 ? 2 * value - 1 : -2 * value);
    }
};

// zigzag scan of a 4x4 block (row-major flat indices)
constexpr int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                             9, 12, 13, 10, 7, 11, 14, 15};
// quant/dequant position-class constants per qp%6 (h264cavlc.py:120-125)
constexpr int64_t kMfA[6] = {13107, 11916, 10082, 9362, 8192, 7282};
constexpr int64_t kMfB[6] = {5243, 4660, 4194, 3647, 3355, 2893};
constexpr int64_t kMfC[6] = {8066, 7490, 6554, 5825, 5243, 4559};
constexpr int64_t kVA[6] = {10, 11, 13, 14, 16, 18};
constexpr int64_t kVB[6] = {16, 18, 20, 23, 25, 29};
constexpr int64_t kVC[6] = {13, 14, 16, 18, 20, 23};
// position class of each 4x4 slot: 0 -> A, 1 -> B, 2 -> C
constexpr int kPosCls[16] = {0, 2, 0, 2, 2, 1, 2, 1,
                             0, 2, 0, 2, 2, 1, 2, 1};

inline int64_t mf_at(int rem, int i) {
    int c = kPosCls[i];
    return c == 0 ? kMfA[rem] : c == 1 ? kMfB[rem] : kMfC[rem];
}
inline int64_t v_at(int rem, int i) {
    int c = kPosCls[i];
    return c == 0 ? kVA[rem] : c == 1 ? kVB[rem] : kVC[rem];
}

// forward core transform W = Cf X Cf^T on one 4x4 (row-major int64)
static void forward4x4(const int64_t* x, int64_t* w) {
    int64_t t[16];
    for (int j = 0; j < 4; j++) {  // rows: t = Cf X
        const int64_t a = x[0 * 4 + j], b = x[1 * 4 + j];
        const int64_t c = x[2 * 4 + j], d = x[3 * 4 + j];
        t[0 * 4 + j] = a + b + c + d;
        t[1 * 4 + j] = 2 * a + b - c - 2 * d;
        t[2 * 4 + j] = a - b - c + d;
        t[3 * 4 + j] = a - 2 * b + 2 * c - d;
    }
    for (int i = 0; i < 4; i++) {  // cols: w = t Cf^T
        const int64_t a = t[i * 4 + 0], b = t[i * 4 + 1];
        const int64_t c = t[i * 4 + 2], d = t[i * 4 + 3];
        w[i * 4 + 0] = a + b + c + d;
        w[i * 4 + 1] = 2 * a + b - c - 2 * d;
        w[i * 4 + 2] = a - b - c + d;
        w[i * 4 + 3] = a - 2 * b + 2 * c - d;
    }
}

// spec 8.5.12.2 inverse core transform, residual BEFORE (x+32)>>6.
// Pass order matters: the spec does each ROW first (e/f) then columns
// (g/h); the >>1 floors make the order observable, and libavcodec
// (rows-first) is the conformance reference (see h264cavlc.idct4x4).
static void idct4x4(const int64_t* d, int64_t* r) {
    int64_t f[16];
    for (int i = 0; i < 4; i++) {
        const int64_t d0 = d[i * 4 + 0], d1 = d[i * 4 + 1];
        const int64_t d2 = d[i * 4 + 2], d3 = d[i * 4 + 3];
        const int64_t e0 = d0 + d2, e1 = d0 - d2;
        const int64_t e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
        f[i * 4 + 0] = e0 + e3;
        f[i * 4 + 1] = e1 + e2;
        f[i * 4 + 2] = e1 - e2;
        f[i * 4 + 3] = e0 - e3;
    }
    for (int j = 0; j < 4; j++) {
        const int64_t f0 = f[0 * 4 + j], f1 = f[1 * 4 + j];
        const int64_t f2 = f[2 * 4 + j], f3 = f[3 * 4 + j];
        const int64_t g0 = f0 + f2, g1 = f0 - f2;
        const int64_t g2 = (f1 >> 1) - f3, g3 = f1 + (f3 >> 1);
        r[0 * 4 + j] = g0 + g3;
        r[1 * 4 + j] = g1 + g2;
        r[2 * 4 + j] = g1 - g2;
        r[3 * 4 + j] = g0 - g3;
    }
}

inline int64_t quant1(int64_t w, int64_t mf, int64_t f, int qbits) {
    int64_t a = w < 0 ? -w : w;
    int64_t q = (a * mf + f) >> qbits;
    return w < 0 ? -q : w > 0 ? q : 0;
}

// 2x2 Hadamard in place: out = H2 m H2
inline void hadamard2(const int64_t m[4], int64_t o[4]) {
    o[0] = m[0] + m[1] + m[2] + m[3];
    o[1] = m[0] - m[1] + m[2] - m[3];
    o[2] = m[0] + m[1] - m[2] - m[3];
    o[3] = m[0] - m[1] - m[2] + m[3];
}

// 4x4 Hadamard: o = H4 m H4 (H4 symmetric +-1 matrix, h264cavlc.py:133)
static void hadamard4(const int64_t* m, int64_t* o) {
    int64_t t[16];
    for (int j = 0; j < 4; j++) {
        const int64_t a = m[0 * 4 + j], b = m[1 * 4 + j];
        const int64_t c = m[2 * 4 + j], d = m[3 * 4 + j];
        t[0 * 4 + j] = a + b + c + d;
        t[1 * 4 + j] = a + b - c - d;
        t[2 * 4 + j] = a - b - c + d;
        t[3 * 4 + j] = a - b + c - d;
    }
    for (int i = 0; i < 4; i++) {
        const int64_t a = t[i * 4 + 0], b = t[i * 4 + 1];
        const int64_t c = t[i * 4 + 2], d = t[i * 4 + 3];
        o[i * 4 + 0] = a + b + c + d;
        o[i * 4 + 1] = a + b - c - d;
        o[i * 4 + 2] = a - b - c + d;
        o[i * 4 + 3] = a - b + c - d;
    }
}

// luma4x4BlkIdx -> (bx, by) (h264cavlc._BLK_POS)
constexpr int kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
constexpr int kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};

// CAVLC residual block writer (write_cavlc_block, h264cavlc.py:204-277).
// coeffs: scan order, length max_coeff.  Returns TotalCoeff.
static int write_block(BitWriter& w, const int64_t* coeffs, int nC,
                       int max_coeff, const int16_t* tb) {
    int nz[16];
    int total = 0;
    for (int i = 0; i < max_coeff; i++) {
        if (coeffs[i] != 0) nz[total++] = i;
    }
    int t1s = 0;
    bool t1_neg[3];
    for (int k = total - 1; k >= 0 && t1s < 3; k--) {
        int64_t c = coeffs[nz[k]];
        if (c == 1 || c == -1) {
            t1_neg[t1s++] = c < 0;
        } else {
            break;
        }
    }

    const int idx = 4 * total + t1s;
    if (nC == -1) {
        w.u(static_cast<uint64_t>(tb[kCdcBits + idx]), tb[kCdcLen + idx]);
    } else {
        const int cls = nC < 2 ? 0 : nC < 4 ? 1 : nC < 8 ? 2 : 3;
        w.u(static_cast<uint64_t>(tb[kCtBits + cls * 68 + idx]),
            tb[kCtLen + cls * 68 + idx]);
    }
    if (total == 0) return 0;

    for (int i = 0; i < t1s; i++) w.u(t1_neg[i] ? 1 : 0, 1);

    int suffix_len = (total > 10 && t1s < 3) ? 1 : 0;
    bool first = true;
    for (int k = total - 1 - t1s; k >= 0; k--) {
        const int64_t lev = coeffs[nz[k]];
        const int64_t alev = lev < 0 ? -lev : lev;
        int64_t level_code = (alev - 1) * 2 + (lev > 0 ? 0 : 1);
        if (first && t1s < 3) level_code -= 2;
        first = false;
        if (suffix_len == 0) {
            if (level_code < 14) {
                w.u(1, static_cast<int>(level_code) + 1);
            } else if (level_code < 30) {
                w.u(1, 15);
                w.u(static_cast<uint64_t>(level_code - 14), 4);
            } else {
                w.u(1, 16);
                w.u(static_cast<uint64_t>(level_code - 30), 12);
            }
        } else {
            if ((level_code >> suffix_len) < 14) {
                w.u(1, static_cast<int>(level_code >> suffix_len) + 1);
                w.u(static_cast<uint64_t>(level_code) &
                        ((1ull << suffix_len) - 1),
                    suffix_len);
            } else if (level_code < (static_cast<int64_t>(15) << suffix_len)) {
                w.u(1, 15);
                w.u(static_cast<uint64_t>(
                        level_code - (static_cast<int64_t>(14) << suffix_len)),
                    suffix_len);
            } else {
                w.u(1, 16);
                w.u(static_cast<uint64_t>(
                        level_code - (static_cast<int64_t>(15) << suffix_len)),
                    12);
            }
        }
        if (suffix_len == 0) suffix_len = 1;
        if (alev > (static_cast<int64_t>(3) << (suffix_len - 1)) &&
            suffix_len < 6) {
            suffix_len++;
        }
    }

    if (total < max_coeff) {
        const int tz = nz[total - 1] + 1 - total;
        if (max_coeff == 4) {
            w.u(static_cast<uint64_t>(tb[kCtzBits + (total - 1) * 4 + tz]),
                tb[kCtzLen + (total - 1) * 4 + tz]);
        } else {
            w.u(static_cast<uint64_t>(tb[kTzBits + (total - 1) * 16 + tz]),
                tb[kTzLen + (total - 1) * 16 + tz]);
        }
        int zeros_left = tz;
        for (int k = total - 1; k > 0; k--) {
            if (zeros_left <= 0) break;
            const int run = nz[k] - nz[k - 1] - 1;
            const int tab = (zeros_left < 7 ? zeros_left : 7) - 1;
            w.u(static_cast<uint64_t>(tb[kRunBits + tab * 16 + run]),
                tb[kRunLen + tab * 16 + run]);
            zeros_left -= run;
        }
    }
    return total;
}

// nC from left/above neighbor 4x4 nnz counts (9.2.1; h264cavlc.py:344-367).
// nnz grid is global [mbh*grid, mbw*grid], -1 never stored (raster order
// guarantees neighbors are final); out-of-frame handled by bounds checks.
inline int nc_of(const int16_t* nnz, int gw, int tx, int ty) {
    const bool has_l = tx > 0, has_a = ty > 0;
    if (has_l && has_a) {
        return (nnz[ty * gw + tx - 1] + nnz[(ty - 1) * gw + tx] + 1) >> 1;
    }
    if (has_l) return nnz[ty * gw + tx - 1];
    if (has_a) return nnz[(ty - 1) * gw + tx];
    return 0;
}

}  // namespace h264enc

extern "C" {

// Encode one full Intra_16x16 CAVLC frame: the slice RBSP from the supplied
// (already-written) slice header through rbsp_trailing.  Planes are the
// MB-padded uint8 luma [mbh*16, mbw*16] and chroma [mbh*8, mbw*8]; recon_*
// receive the decoder-exact reconstruction.  hdr carries the slice header
// produced by the Python BitWriter: hdr_nbytes whole bytes + hdr_acc the
// pending sub-byte bits (hdr_nbits of them, LSB-aligned).  tables: packed
// int16 VLC tables (see layout constants).  Returns total RBSP bytes, or
// -1 if out_cap is too small.
int64_t h264_encode_frame(const uint8_t* py, const uint8_t* pu,
                          const uint8_t* pv, int64_t mbw, int64_t mbh,
                          int64_t qp, int64_t qpc, const uint8_t* hdr,
                          int64_t hdr_nbytes, uint64_t hdr_acc,
                          int64_t hdr_nbits, const int16_t* tables,
                          uint8_t* out, int64_t out_cap, uint8_t* recon_y,
                          uint8_t* recon_u, uint8_t* recon_v) {
    using namespace h264enc;

    BitWriter w{out, out_cap, 0, 0, 0, false};
    if (hdr_nbytes > out_cap) return -1;
    std::memcpy(out, hdr, static_cast<size_t>(hdr_nbytes));
    w.n = hdr_nbytes;
    w.acc = hdr_acc;
    w.nbits = static_cast<int>(hdr_nbits);

    const int64_t W16 = mbw * 16, W8 = mbw * 8;
    const int qp6 = static_cast<int>(qp / 6), rem = static_cast<int>(qp % 6);
    const int qbits = 15 + qp6;
    const int64_t f = (static_cast<int64_t>(1) << qbits) / 3;
    const int cqp6 = static_cast<int>(qpc / 6), crem = static_cast<int>(qpc % 6);
    const int cqbits = 15 + cqp6;
    const int64_t cf = (static_cast<int64_t>(1) << cqbits) / 3;

    std::vector<int16_t> nnz_y(static_cast<size_t>(mbh * 4) * (mbw * 4), 0);
    std::vector<int16_t> nnz_u(static_cast<size_t>(mbh * 2) * (mbw * 2), 0);
    std::vector<int16_t> nnz_v(static_cast<size_t>(mbh * 2) * (mbw * 2), 0);
    const int gw4 = static_cast<int>(mbw * 4), gw2 = static_cast<int>(mbw * 2);

    // zero recon (matches np.zeros_like init; only the prediction reads of
    // not-yet-written cells would see it, and raster order prevents those)
    std::memset(recon_y, 0, static_cast<size_t>(mbh * 16) * W16);
    std::memset(recon_u, 0, static_cast<size_t>(mbh * 8) * W8);
    std::memset(recon_v, 0, static_cast<size_t>(mbh * 8) * W8);

    int64_t ZA[16][16];   // per-block quantized AC (row-major 4x4)
    int64_t Wt[16][16];   // forward transforms
    int64_t scan[16];

    for (int64_t my = 0; my < mbh; my++) {
        for (int64_t mx = 0; mx < mbw; mx++) {
            const int64_t y0 = my * 16, x0 = mx * 16;
            const bool ht = my > 0, hl = mx > 0;

            // ---- luma DC prediction (8.3.3 DC mode) ----
            int64_t pred;
            if (ht || hl) {
                int64_t ts = 0, ls = 0;
                if (ht)
                    for (int x = 0; x < 16; x++)
                        ts += recon_y[(y0 - 1) * W16 + x0 + x];
                if (hl)
                    for (int y = 0; y < 16; y++)
                        ls += recon_y[(y0 + y) * W16 + x0 - 1];
                pred = (ht && hl) ? (ts + ls + 16) >> 5
                                  : (ht ? (ts + 8) >> 4 : (ls + 8) >> 4);
            } else {
                pred = 128;
            }

            // ---- forward transform + AC quant, 16 blocks in _BLK_POS order
            int64_t dc_raster[16];
            bool any_luma_ac = false;
            for (int i = 0; i < 16; i++) {
                const int bx = kBlkX[i], by = kBlkY[i];
                int64_t blk[16];
                for (int yy = 0; yy < 4; yy++)
                    for (int xx = 0; xx < 4; xx++)
                        blk[yy * 4 + xx] =
                            static_cast<int64_t>(
                                py[(y0 + 4 * by + yy) * W16 + x0 + 4 * bx +
                                   xx]) -
                            pred;
                forward4x4(blk, Wt[i]);
                dc_raster[by * 4 + bx] = Wt[i][0];
                for (int k = 0; k < 16; k++) {
                    int64_t q = quant1(Wt[i][k], mf_at(rem, k), f, qbits);
                    if (k == 0) q = 0;
                    ZA[i][k] = q;
                    any_luma_ac |= (q != 0);
                }
            }
            const int cbp_luma = any_luma_ac ? 15 : 0;

            // ---- luma DC quant (8.5.10): YD = (H4 D H4) >> 1 ----
            int64_t YD[16], ZD[16], FD[16], dcY[16];
            hadamard4(dc_raster, YD);
            for (int k = 0; k < 16; k++) {
                const int64_t y = YD[k] >> 1;
                const int64_t a = y < 0 ? -y : y;
                const int64_t q = (a * kMfA[rem] + 2 * f) >> (qbits + 1);
                ZD[k] = y < 0 ? -q : y > 0 ? q : 0;
            }
            hadamard4(ZD, FD);
            if (qp >= 12) {
                for (int k = 0; k < 16; k++)
                    dcY[k] = (FD[k] * kVA[rem])
                             * (static_cast<int64_t>(1) << (qp6 - 2));
            } else {
                for (int k = 0; k < 16; k++)
                    dcY[k] = (FD[k] * kVA[rem] +
                              (static_cast<int64_t>(1) << (1 - qp6))) >>
                             (2 - qp6);
            }

            // ---- chroma: transform + quant, both components ----
            const int64_t cy0 = my * 8, cx0 = mx * 8;
            int64_t cpred[2][4];      // per-quadrant DC prediction (sy, sx)
            int64_t CZD[2][4];        // quantized 2x2 DC (raster)
            int64_t CZA[2][4][16];    // quantized AC per 4x4 block
            int64_t CWt[2][4][16];
            bool any_cdc = false, any_cac = false;
            for (int comp = 0; comp < 2; comp++) {
                const uint8_t* plane = comp == 0 ? pu : pv;
                const uint8_t* rec = comp == 0 ? recon_u : recon_v;
                // 8.3.4 DC mode per 4x4 quadrant
                for (int qd = 0; qd < 4; qd++) {
                    const int sy = 4 * (qd / 2), sx = 4 * (qd % 2);
                    int64_t ts = 0, ls = 0;
                    if (ht)
                        for (int x = 0; x < 4; x++)
                            ts += rec[(cy0 - 1) * W8 + cx0 + sx + x];
                    if (hl)
                        for (int y = 0; y < 4; y++)
                            ls += rec[(cy0 + sy + y) * W8 + cx0 - 1];
                    int64_t v;
                    const bool corner = (sx == 0 && sy == 0) ||
                                        (sx == 4 && sy == 4);
                    if (corner && ht && hl) {
                        v = (ts + ls + 4) >> 3;
                    } else if (sx == 4 && sy == 0) {
                        v = ht ? (ts + 2) >> 2 : hl ? (ls + 2) >> 2 : 128;
                    } else if (sx == 0 && sy == 4) {
                        v = hl ? (ls + 2) >> 2 : ht ? (ts + 2) >> 2 : 128;
                    } else {
                        v = (ht && hl) ? (ts + ls + 4) >> 3
                            : ht       ? (ts + 2) >> 2
                            : hl       ? (ls + 2) >> 2
                                       : 128;
                    }
                    cpred[comp][qd] = v;
                }
                int64_t cdc[4];
                for (int qd = 0; qd < 4; qd++) {
                    const int sy = 4 * (qd / 2), sx = 4 * (qd % 2);
                    int64_t blk[16];
                    for (int yy = 0; yy < 4; yy++)
                        for (int xx = 0; xx < 4; xx++)
                            blk[yy * 4 + xx] =
                                static_cast<int64_t>(
                                    plane[(cy0 + sy + yy) * W8 + cx0 + sx +
                                          xx]) -
                                cpred[comp][qd];
                    forward4x4(blk, CWt[comp][qd]);
                    cdc[qd] = CWt[comp][qd][0];
                    for (int k = 0; k < 16; k++) {
                        int64_t q =
                            quant1(CWt[comp][qd][k], mf_at(crem, k), cf,
                                   cqbits);
                        if (k == 0) q = 0;
                        CZA[comp][qd][k] = q;
                        any_cac |= (q != 0);
                    }
                }
                int64_t CYD[4];
                hadamard2(cdc, CYD);
                for (int k = 0; k < 4; k++) {
                    const int64_t a = CYD[k] < 0 ? -CYD[k] : CYD[k];
                    const int64_t q = (a * kMfA[crem] + 2 * cf) >> (cqbits + 1);
                    CZD[comp][k] = CYD[k] < 0 ? -q : CYD[k] > 0 ? q : 0;
                    any_cdc |= (CZD[comp][k] != 0);
                }
            }
            const int cbp_chroma = any_cac ? 2 : any_cdc ? 1 : 0;

            // ---- macroblock header ----
            w.ue(1 + 2 + 4 * cbp_chroma + 12 * (cbp_luma ? 1 : 0));
            w.ue(0);  // intra_chroma_pred_mode: DC
            w.se(0);  // mb_qp_delta

            // ---- luma DC block (zigzag of the raster DC grid) ----
            for (int k = 0; k < 16; k++) scan[k] = ZD[kZigzag[k]];
            int nC = nc_of(nnz_y.data(), gw4, static_cast<int>(mx * 4),
                           static_cast<int>(my * 4));
            write_block(w, scan, nC, 16, tables);

            // per-4x4 nnz visible to later blocks of the same MB (9.2.1)
            for (int ty = 0; ty < 4; ty++)
                for (int tx = 0; tx < 4; tx++)
                    nnz_y[(my * 4 + ty) * gw4 + mx * 4 + tx] = 0;
            if (cbp_luma) {
                for (int i = 0; i < 16; i++) {
                    const int bx = kBlkX[i], by = kBlkY[i];
                    for (int k = 0; k < 15; k++)
                        scan[k] = ZA[i][kZigzag[k + 1]];
                    nC = nc_of(nnz_y.data(), gw4,
                               static_cast<int>(mx * 4) + bx,
                               static_cast<int>(my * 4) + by);
                    const int tc = write_block(w, scan, nC, 15, tables);
                    nnz_y[(my * 4 + by) * gw4 + mx * 4 + bx] =
                        static_cast<int16_t>(tc);
                }
            }

            if (cbp_chroma) {
                for (int comp = 0; comp < 2; comp++)
                    write_block(w, CZD[comp], -1, 4, tables);
            }
            for (int comp = 0; comp < 2; comp++) {
                int16_t* nnz_c = (comp == 0 ? nnz_u : nnz_v).data();
                for (int ty = 0; ty < 2; ty++)
                    for (int tx = 0; tx < 2; tx++)
                        nnz_c[(my * 2 + ty) * gw2 + mx * 2 + tx] = 0;
                if (cbp_chroma == 2) {
                    for (int i = 0; i < 4; i++) {
                        for (int k = 0; k < 15; k++)
                            scan[k] = CZA[comp][i][kZigzag[k + 1]];
                        nC = nc_of(nnz_c, gw2, static_cast<int>(mx * 2) + i % 2,
                                   static_cast<int>(my * 2) + i / 2);
                        const int tc = write_block(w, scan, nC, 15, tables);
                        nnz_c[(my * 2 + i / 2) * gw2 + mx * 2 + i % 2] =
                            static_cast<int16_t>(tc);
                    }
                }
            }
            if (w.overflow) return -1;

            // ---- reconstruction (decoder-exact; spec 8.5) ----
            for (int i = 0; i < 16; i++) {
                const int bx = kBlkX[i], by = kBlkY[i];
                int64_t DQ[16], res[16];
                for (int k = 0; k < 16; k++)
                    DQ[k] = (ZA[i][k] * v_at(rem, k))
                            * (static_cast<int64_t>(1) << qp6);
                DQ[0] = dcY[by * 4 + bx];
                idct4x4(DQ, res);
                for (int yy = 0; yy < 4; yy++)
                    for (int xx = 0; xx < 4; xx++) {
                        const int64_t v =
                            ((res[yy * 4 + xx] + 32) >> 6) + pred;
                        recon_y[(y0 + 4 * by + yy) * W16 + x0 + 4 * bx + xx] =
                            static_cast<uint8_t>(v < 0 ? 0
                                                 : v > 255 ? 255
                                                           : v);
                    }
            }
            for (int comp = 0; comp < 2; comp++) {
                uint8_t* rec = comp == 0 ? recon_u : recon_v;
                int64_t CF2[4];
                hadamard2(CZD[comp], CF2);
                int64_t dcC[4];
                // 8.5.11 in the V-table convention: >> 1, not >> 5
                for (int k = 0; k < 4; k++)
                    dcC[k] = (CF2[k] * kVA[crem] *
                              (static_cast<int64_t>(1) << cqp6)) >>
                             1;
                for (int qd = 0; qd < 4; qd++) {
                    const int sy = 4 * (qd / 2), sx = 4 * (qd % 2);
                    int64_t DQ[16], res[16];
                    for (int k = 0; k < 16; k++) {
                        const int64_t z =
                            cbp_chroma == 2 ? CZA[comp][qd][k] : 0;
                        DQ[k] = (z * v_at(crem, k))
                                * (static_cast<int64_t>(1) << cqp6);
                    }
                    DQ[0] = dcC[qd];
                    idct4x4(DQ, res);
                    for (int yy = 0; yy < 4; yy++)
                        for (int xx = 0; xx < 4; xx++) {
                            const int64_t v = ((res[yy * 4 + xx] + 32) >> 6) +
                                              cpred[comp][qd];
                            rec[(cy0 + sy + yy) * W8 + cx0 + sx + xx] =
                                static_cast<uint8_t>(v < 0 ? 0
                                                     : v > 255 ? 255
                                                               : v);
                        }
                }
            }
        }
    }

    // rbsp_trailing: stop bit + zero-align
    w.u(1, 1);
    if (w.nbits) w.u(0, 8 - w.nbits);
    if (w.overflow) return -1;
    return w.n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// H.264 CAVLC slice parse (pass 1 of av/h264dec_fast.py)
//
// The fast pure decoder's entropy decode is inherently serial (every prefix
// code's length depends on the previous symbol), so it cannot vectorize; this
// is its C++ twin, bit-identical by construction: the SAME flattened 64Ki
// lookup tables are passed in from Python (packed by av/h264dec_fast.py), and
// the control flow mirrors _read_block_fast / the MB loop statement for
// statement.  Python keeps the slice-header parse and all batched transform
// math (pass 2); this fills the same preallocated coefficient arrays.
// Reference scope as in av/h264dec.py (the reference delegates H.264 decode
// to FFI'd libavcodec entirely: src/rtmp/mod.rs:260-338).
// ---------------------------------------------------------------------------

#include <vector>

namespace h264 {

// packed table layout (each entry: 65536 value bytes + 65536 length bytes):
// coeff_token classes 0-3, chroma-DC token, total_zeros 1-15,
// chroma-DC total_zeros 1-3, run_before 1-7  => 30 tables
constexpr int kCT0 = 0, kCDC = 4, kTZ0 = 5, kCTZ0 = 20, kRUN0 = 23;
constexpr size_t kTabStride = 2u * 65536u;

struct ParseErr {
    int64_t code;
    int64_t detail;
};

inline const uint8_t* tab_val(const uint8_t* t, int i) {
    return t + static_cast<size_t>(i) * kTabStride;
}
inline const uint8_t* tab_len(const uint8_t* t, int i) {
    return t + static_cast<size_t>(i) * kTabStride + 65536;
}

inline int clz16(uint32_t w) {
    return w ? __builtin_clz(w) - 16 : 16;
}

struct Bits {
    const uint8_t* d;  // padded with >= 8 zero bytes past nbits
    int64_t nbits;
    int64_t pos;

    // bits pos..pos+15, zero-padded past the end (same as the Python
    // window array); reading past the stream is a typed error
    inline uint32_t peek16() const {
        if (pos > nbits) throw ParseErr{-8, 0};
        int64_t b = pos >> 3;
        uint32_t v = (static_cast<uint32_t>(d[b]) << 16) |
                     (static_cast<uint32_t>(d[b + 1]) << 8) | d[b + 2];
        return (v >> (8 - (pos & 7))) & 0xFFFF;
    }

    inline int64_t read(int k) {
        int64_t v = peek16() >> (16 - k);
        pos += k;
        return v;
    }

    inline int64_t ue() {
        uint32_t w = peek16();
        int lz = clz16(w);
        if (lz > 15) {
            // 16 to 31 leading zeros (codeNum 65,535 and up, e.g. an mvd of
            // -32,768), as the Python tier accepts: count the zeros in the
            // next window, then read the suffix in two parts
            pos += 16;
            int more = clz16(peek16());
            lz = 16 + more;
            if (lz > 31) throw ParseErr{-7, 0};
            pos += more + 1;
            int64_t hi = read(lz - 16);
            int64_t lo = read(16);
            return (static_cast<int64_t>(1) << lz) - 1 + ((hi << 16) | lo);
        }
        int length = 2 * lz + 1;
        if (length <= 16) {
            pos += length;
            return (w >> (16 - length)) - 1;
        }
        pos += lz + 1;
        return (static_cast<int64_t>(1) << lz) - 1 + read(lz);
    }

    inline int64_t se() {
        int64_t k = ue();
        return (k % 2) ? (k + 1) / 2 : -(k / 2);
    }
};

// mirrors _read_block_fast (h264dec_fast.py): scan-order coeffs into out
// (length max_coeff, pre-zeroed), returns TotalCoeff
static int read_block(Bits& r, int nC, int max_coeff, int64_t* out,
                      const uint8_t* tables) {
    const uint8_t *val_t, *len_t;
    if (nC == -1) {
        val_t = tab_val(tables, kCDC);
        len_t = tab_len(tables, kCDC);
    } else {
        int cls = nC < 2 ? 0 : nC < 4 ? 1 : nC < 8 ? 2 : 3;
        val_t = tab_val(tables, kCT0 + cls);
        len_t = tab_len(tables, kCT0 + cls);
    }
    uint32_t w = r.peek16();
    int k = len_t[w];
    if (k == 0) throw ParseErr{-1, 0};
    int idx = val_t[w];
    r.pos += k;
    int total = idx >> 2;
    int t1s = idx & 3;
    if (total == 0) return 0;

    int64_t levels[16];
    int nl = 0;
    for (int i = 0; i < t1s; i++) {
        levels[nl++] = (r.peek16() >> 15) ? -1 : 1;
        r.pos += 1;
    }

    int suffix_len = (total > 10 && t1s < 3) ? 1 : 0;
    bool first = true;
    for (int i = 0; i < total - t1s; i++) {
        int prefix = clz16(r.peek16());
        if (prefix > 15) throw ParseErr{-2, 0};
        r.pos += prefix + 1;
        int64_t level_code;
        if (suffix_len == 0) {
            if (prefix < 14) {
                level_code = prefix;
            } else if (prefix == 14) {
                level_code = 14 + (r.peek16() >> 12);
                r.pos += 4;
            } else {
                level_code = 30 + (r.peek16() >> 4);
                r.pos += 12;
            }
        } else {
            if (prefix < 14) {
                level_code = (static_cast<int64_t>(prefix) << suffix_len) +
                             (r.peek16() >> (16 - suffix_len));
                r.pos += suffix_len;
            } else if (prefix == 14) {
                level_code = (static_cast<int64_t>(14) << suffix_len) +
                             (r.peek16() >> (16 - suffix_len));
                r.pos += suffix_len;
            } else {
                level_code = (static_cast<int64_t>(15) << suffix_len) +
                             (r.peek16() >> 4);
                r.pos += 12;
            }
        }
        if (first && t1s < 3) level_code += 2;
        first = false;
        int64_t lev = (level_code >> 1) + 1;
        if (level_code & 1) lev = -lev;
        levels[nl++] = lev;
        if (suffix_len == 0) suffix_len = 1;
        if ((lev > 0 ? lev : -lev) >
                (static_cast<int64_t>(3) << (suffix_len - 1)) &&
            suffix_len < 6) {
            suffix_len++;
        }
    }

    int tz = 0;
    if (total < max_coeff) {
        int ti = (max_coeff == 4) ? kCTZ0 + total - 1 : kTZ0 + total - 1;
        uint32_t w2 = r.peek16();
        int k2 = tab_len(tables, ti)[w2];
        if (k2 == 0) throw ParseErr{-1, 0};
        tz = tab_val(tables, ti)[w2];
        r.pos += k2;
    }

    int p = total - 1 + tz;
    if (p >= max_coeff) throw ParseErr{-1, 0};
    int zeros_left = tz;
    out[p] = levels[0];
    for (int k2 = total - 1; k2 > 0; k2--) {
        int run = 0;
        if (zeros_left > 0) {
            int ti = kRUN0 + (zeros_left < 7 ? zeros_left : 7) - 1;
            uint32_t w3 = r.peek16();
            int kk = tab_len(tables, ti)[w3];
            if (kk == 0) throw ParseErr{-1, 0};
            run = tab_val(tables, ti)[w3];
            r.pos += kk;
        }
        p = p - run - 1;
        if (p < 0) throw ParseErr{-1, 0};  // corrupt run_before codes
        out[p] = levels[total - k2];
        zeros_left -= run;
    }
    return total;
}

struct NnzGrid {
    std::vector<int16_t> v;  // -1 = unknown (frame edge / not yet decoded)
    int w;
    NnzGrid(int h_, int w_) : v(static_cast<size_t>(h_) * w_, -1), w(w_) {}
    inline int16_t& at(int y, int x) { return v[static_cast<size_t>(y) * w + x]; }
    inline int16_t cat(int y, int x) const {
        return v[static_cast<size_t>(y) * w + x];
    }
};

static int nc_of(NnzGrid& nnz, int mx, int my, int bx, int by, int grid) {
    int tx = mx * grid + bx, ty = my * grid + by;
    int nA = tx > 0 ? nnz.at(ty, tx - 1) : -1;
    int nB = ty > 0 ? nnz.at(ty - 1, tx) : -1;
    if (nA >= 0 && nB >= 0) return (nA + nB + 1) >> 1;
    if (nA >= 0) return nA;
    if (nB >= 0) return nB;
    return 0;
}

// 4x4 block order inside a macroblock (h264cavlc._BLK_POS)
constexpr int kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
constexpr int kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};

}  // namespace h264

extern "C" {

// Parse all macroblocks of one I-slice.  data: unescaped RBSP padded with
// >= 8 zero bytes (n_bytes excludes padding); start_pos: bit position after
// the slice header; qp_init: slice qp after the header.  Output arrays are
// preallocated, zeroed by the caller: kinds [N] u8 (0 I16 / 1 I_PCM),
// qps [N] i64, l_dc [N,16], l_ac [N,16,15], c_dc [N,2,4], c_ac [N,2,4,15]
// (all i64, scan order), pcm [N,384] u8.  out_state: {end_pos, mb_addr,
// err_detail}.  Returns 0 or a negative error code (see _NATIVE_ERRORS in
// av/h264dec_fast.py).
int64_t h264_parse_slice(const uint8_t* data, int64_t n_bytes,
                         int64_t start_pos, int64_t first_mb, int64_t mbw,
                         int64_t mbh, int64_t qp_init, const uint8_t* tables,
                         uint8_t* kinds, int64_t* qps, int64_t* l_dc,
                         int64_t* l_ac, int64_t* c_dc, int64_t* c_ac,
                         uint8_t* pcm, int64_t* out_state) {
    using h264::Bits;
    using h264::NnzGrid;
    using h264::ParseErr;

    Bits r{data, n_bytes * 8, start_pos};
    // rbsp_stop_one_bit: position of the last set bit in the stream
    int64_t stop = -1;
    for (int64_t b = n_bytes - 1; b >= 0; b--) {
        if (data[b]) {
            stop = b * 8 + (7 - __builtin_ctz(data[b]));
            break;
        }
    }

    const int64_t n_total = mbw * mbh;
    NnzGrid nnz_y(mbh * 4, mbw * 4);
    NnzGrid nnz_u(mbh * 2, mbw * 2);
    NnzGrid nnz_v(mbh * 2, mbw * 2);

    int64_t qp = qp_init;
    int64_t mb_addr = first_mb;
    try {
        while (mb_addr < n_total && r.pos < stop) {
            const int64_t i = mb_addr - first_mb;
            const int mx = static_cast<int>(mb_addr % mbw);
            const int my = static_cast<int>(mb_addr / mbw);
            int64_t mb_type = r.ue();
            if (mb_type == 25) {  // I_PCM
                r.pos = (r.pos + 7) & ~static_cast<int64_t>(7);
                int64_t at = r.pos >> 3;
                if (at + 384 > n_bytes) throw ParseErr{-3, 0};
                std::memcpy(pcm + i * 384, data + at, 384);
                r.pos += 384 * 8;
                kinds[i] = 1;
                for (int ty = my * 4; ty < my * 4 + 4; ty++)
                    for (int tx = mx * 4; tx < mx * 4 + 4; tx++)
                        nnz_y.at(ty, tx) = 16;
                for (int ty = my * 2; ty < my * 2 + 2; ty++)
                    for (int tx = mx * 2; tx < mx * 2 + 2; tx++) {
                        nnz_u.at(ty, tx) = 16;
                        nnz_v.at(ty, tx) = 16;
                    }
                // the mb_qp_delta chain is NOT reset by I_PCM (verified
                // against libavcodec; see h264dec._decode_mb)
                mb_addr++;
                continue;
            }
            if (mb_type < 1 || mb_type > 24) throw ParseErr{-4, mb_type};
            int64_t code = mb_type - 1;
            int pred_mode = static_cast<int>(code % 4);
            int cbp_chroma = static_cast<int>((code / 4) % 3);
            int cbp_luma = code >= 12 ? 15 : 0;
            if (pred_mode != 2) throw ParseErr{-5, pred_mode};
            if (r.ue() != 0) throw ParseErr{-6, 0};
            // mb_qp_delta chains mod 52 (spec 7.4.5)
            qp = ((qp + r.se()) % 52 + 52) % 52;
            qps[i] = qp;

            // luma DC
            int nC = h264::nc_of(nnz_y, mx, my, 0, 0, 4);
            h264::read_block(r, nC, 16, l_dc + i * 16, tables);

            // luma AC
            if (cbp_luma) {
                for (int bi = 0; bi < 16; bi++) {
                    int bx = h264::kBlkX[bi], by = h264::kBlkY[bi];
                    nC = h264::nc_of(nnz_y, mx, my, bx, by, 4);
                    int t = h264::read_block(r, nC, 15,
                                             l_ac + (i * 16 + bi) * 15, tables);
                    nnz_y.at(my * 4 + by, mx * 4 + bx) =
                        static_cast<int16_t>(t);
                }
            } else {
                for (int ty = my * 4; ty < my * 4 + 4; ty++)
                    for (int tx = mx * 4; tx < mx * 4 + 4; tx++)
                        nnz_y.at(ty, tx) = 0;
            }

            // chroma DC
            if (cbp_chroma) {
                h264::read_block(r, -1, 4, c_dc + (i * 2 + 0) * 4, tables);
                h264::read_block(r, -1, 4, c_dc + (i * 2 + 1) * 4, tables);
            }
            // chroma AC
            for (int comp = 0; comp < 2; comp++) {
                NnzGrid& nnz_c = comp == 0 ? nnz_u : nnz_v;
                if (cbp_chroma == 2) {
                    for (int bi = 0; bi < 4; bi++) {
                        int bx = bi % 2, by = bi / 2;
                        nC = h264::nc_of(nnz_c, mx, my, bx, by, 2);
                        int t = h264::read_block(
                            r, nC, 15, c_ac + ((i * 2 + comp) * 4 + bi) * 15,
                            tables);
                        nnz_c.at(my * 2 + by, mx * 2 + bx) =
                            static_cast<int16_t>(t);
                    }
                } else {
                    for (int ty = my * 2; ty < my * 2 + 2; ty++)
                        for (int tx = mx * 2; tx < mx * 2 + 2; tx++)
                            nnz_c.at(ty, tx) = 0;
                }
            }
            mb_addr++;
        }
    } catch (const ParseErr& e) {
        out_state[0] = r.pos;
        out_state[1] = mb_addr;
        out_state[2] = e.detail;
        return e.code;
    }
    out_state[0] = r.pos;
    out_state[1] = mb_addr;
    out_state[2] = 0;
    return 0;
}

}  // extern "C"

extern "C" {

// DC-prediction reconstruction (pass 2b of av/h264dec_fast.py), sequential
// raster order — mirrors the scalar oracle's _dc_pred16/_dc_pred_chroma
// (av/h264dec.py:288-330) exactly.  mb_y: [N,16,16] i64 residuals
// (already (idct+32)>>6), mb_c: [N,2,8,8] i64, kinds: [N] u8 (1 = I_PCM,
// raw samples in pcm [N,384]).  ry/ru/rv are the decoder's full planes
// ([mbh*16, mbw*16] / [mbh*8, mbw*8] i64); neighbor predictions read
// previously-written plane content, so slices with first_mb != 0 work
// against whatever the planes already hold (same as the scalar path).
void h264_dc_recon(const int64_t* mb_y, const int64_t* mb_c,
                   const uint8_t* kinds, const uint8_t* pcm, int64_t N,
                   int64_t first_mb, int64_t mbw, int64_t mbh, int64_t* ry,
                   int64_t* ru, int64_t* rv) {
    (void)mbh;
    const int64_t W = mbw * 16, CW = mbw * 8;
    for (int64_t i = 0; i < N; i++) {
        const int64_t addr = first_mb + i;
        const int64_t mx = addr % mbw, my = addr / mbw;
        const int64_t y0 = my * 16, x0 = mx * 16;
        const int64_t cy0 = my * 8, cx0 = mx * 8;
        if (kinds[i]) {
            const uint8_t* p = pcm + i * 384;
            for (int y = 0; y < 16; y++)
                for (int x = 0; x < 16; x++)
                    ry[(y0 + y) * W + x0 + x] = p[y * 16 + x];
            for (int y = 0; y < 8; y++)
                for (int x = 0; x < 8; x++) {
                    ru[(cy0 + y) * CW + cx0 + x] = p[256 + y * 8 + x];
                    rv[(cy0 + y) * CW + cx0 + x] = p[256 + 64 + y * 8 + x];
                }
            continue;
        }
        const bool ht = my > 0, hl = mx > 0;

        // luma (spec 8.3.3 DC mode)
        int64_t pred;
        if (ht || hl) {
            int64_t ts = 0, ls = 0;
            if (ht)
                for (int x = 0; x < 16; x++) ts += ry[(y0 - 1) * W + x0 + x];
            if (hl)
                for (int y = 0; y < 16; y++) ls += ry[(y0 + y) * W + x0 - 1];
            pred = (ht && hl) ? (ts + ls + 16) >> 5
                              : (ht ? (ts + 8) >> 4 : (ls + 8) >> 4);
        } else {
            pred = 128;
        }
        const int64_t* mb = mb_y + i * 256;
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++) {
                int64_t v = mb[y * 16 + x] + pred;
                ry[(y0 + y) * W + x0 + x] = v < 0 ? 0 : v > 255 ? 255 : v;
            }

        // chroma per 4x4 quadrant (spec 8.3.4 / _dc_pred_chroma)
        for (int comp = 0; comp < 2; comp++) {
            int64_t* plane = comp == 0 ? ru : rv;
            const int64_t* mbc = mb_c + (i * 2 + comp) * 64;
            for (int sy = 0; sy < 8; sy += 4)
                for (int sx = 0; sx < 8; sx += 4) {
                    int64_t ts = 0, ls = 0;
                    if (ht)
                        for (int x = 0; x < 4; x++)
                            ts += plane[(cy0 - 1) * CW + cx0 + sx + x];
                    if (hl)
                        for (int y = 0; y < 4; y++)
                            ls += plane[(cy0 + sy + y) * CW + cx0 - 1];
                    int64_t v;
                    const bool corner = (sx == 0 && sy == 0) ||
                                        (sx == 4 && sy == 4);
                    if (corner && ht && hl) {
                        v = (ts + ls + 4) >> 3;
                    } else if (sx == 4 && sy == 0) {
                        v = ht ? (ts + 2) >> 2 : hl ? (ls + 2) >> 2 : 128;
                    } else if (sx == 0 && sy == 4) {
                        v = hl ? (ls + 2) >> 2 : ht ? (ts + 2) >> 2 : 128;
                    } else {
                        v = (ht && hl) ? (ts + ls + 4) >> 3
                            : ht       ? (ts + 2) >> 2
                            : hl       ? (ls + 2) >> 2
                                       : 128;
                    }
                    for (int y = 0; y < 4; y++)
                        for (int x = 0; x < 4; x++) {
                            int64_t o = mbc[(sy + y) * 8 + sx + x] + v;
                            plane[(cy0 + sy + y) * CW + cx0 + sx + x] =
                                o < 0 ? 0 : o > 255 ? 255 : o;
                        }
                }
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// FULL baseline-intra H.264 slice decoder (native twin of av/h264dec.py
// _SliceDecoder): I_4x4 with all nine prediction modes, Intra_16x16
// V/H/DC/Plane, chroma DC/H/V/Plane, chained mb_qp_delta, I_PCM, and the
// spec 8.7 in-loop deblocking filter.  Statement-for-statement port of the
// Python scalar oracle so third-party x264 streams (RTMP ingest,
// rtmp/mod.rs:260-338 in the reference) decode at native speed in the
// zero-dependency tier; bit-exactness vs BOTH the scalar oracle and
// libavcodec is asserted by tests/test_h264dec_intra_full.py.
// Python keeps NAL/SPS/PPS/slice-header parsing; this decodes the
// macroblock layer + deblocking into caller-provided uint8 planes.
// ---------------------------------------------------------------------------

namespace h264full {

using h264::Bits;
using h264::NnzGrid;
using h264::ParseErr;
using h264::kBlkX;
using h264::kBlkY;
using h264enc::idct4x4;
using h264enc::kVA;
using h264enc::kZigzag;
using h264enc::v_at;

// Table 9-4 (ChromaArrayType=1), intra column: codeNum -> coded_block_pattern
constexpr int kCbpIntra[48] = {
    47, 31, 15, 0,  23, 27, 29, 30, 7,  11, 13, 14, 39, 43, 45, 46,
    16, 3,  5,  10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1,  2,  4,
    8,  17, 18, 20, 24, 6,  9,  22, 25, 32, 33, 34, 36, 40, 38, 41};

// Table 9-4, inter column (twin of h264dec._CBP_INTER)
constexpr int kCbpInter[48] = {
    0,  16, 1,  2,  4,  8,  32, 3,  5,  10, 12, 15, 47, 7,  11, 13,
    14, 6,  9,  31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41};

// P partition shapes by mb_type (Table 7-13): {px, py, w, h}
constexpr int kPParts[3][2][4] = {
    {{0, 0, 16, 16}, {0, 0, 0, 0}},
    {{0, 0, 16, 8}, {0, 8, 16, 8}},
    {{0, 0, 8, 16}, {8, 0, 8, 16}}};
constexpr int kPPartN[3] = {1, 2, 2};
// sub-partition shapes by sub_mb_type (Table 7-17): {sx, sy, w, h}
constexpr int kPSub[4][4][4] = {
    {{0, 0, 8, 8}, {0}, {0}, {0}},
    {{0, 0, 8, 4}, {0, 4, 8, 4}, {0}, {0}},
    {{0, 0, 4, 8}, {4, 0, 4, 8}, {0}, {0}},
    {{0, 0, 4, 4}, {4, 0, 4, 4}, {0, 4, 4, 4}, {4, 4, 4, 4}}};
constexpr int kPSubN[4] = {1, 2, 2, 4};

// MV-prediction directional hints (8.4.1.3)
enum MvpHint { kHintNone = 0, kHint16x8Top, kHint16x8Bot,
               kHint8x16Left, kHint8x16Right };

inline int64_t median3(int64_t a, int64_t b, int64_t c) {
    const int64_t mn = a < b ? (a < c ? a : c) : (b < c ? b : c);
    const int64_t mx = a > b ? (a > c ? a : c) : (b > c ? b : c);
    return a + b + c - mn - mx;
}

// Table 8-15 (offset 0): QPc for qPi >= 30
constexpr int kQpc30[22] = {29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36,
                            36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};

inline int qpc_of(int qp, int off) {
    int q = qp + off;
    q = q < 0 ? 0 : q > 51 ? 51 : q;
    return q < 30 ? q : kQpc30[q - 30];
}

// deblocking tables (Table 8-16/8-17); see h264dec.py _ALPHA/_BETA/_TC0
constexpr int kAlpha[52] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,   0,   0,   0,   0,   0,
    4,  4,  5,  6,  7,  8,  9,  10, 12, 13, 15,  17,  20,  22,  25,  28,
    32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182,
    203, 226, 255, 255};
constexpr int kBeta[52] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
    2,  2,  2,  3,  3,  3,  3,  4,  4,  4,  6,  6,  7,  7,  8,  8,
    9,  9,  10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16,
    17, 17, 18, 18};
constexpr int kTc0[52][3] = {
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 1},
    {0, 0, 1}, {0, 0, 1}, {0, 0, 1}, {0, 1, 1}, {0, 1, 1}, {1, 1, 1},
    {1, 1, 1}, {1, 1, 1}, {1, 1, 1}, {1, 1, 2}, {1, 1, 2}, {1, 1, 2},
    {1, 1, 2}, {1, 2, 3}, {1, 2, 3}, {2, 2, 3}, {2, 2, 4}, {2, 3, 4},
    {2, 3, 4}, {3, 3, 5}, {3, 4, 6}, {3, 4, 6}, {4, 5, 7}, {4, 5, 8},
    {4, 6, 9}, {5, 7, 10}, {6, 8, 11}, {6, 8, 13}, {7, 10, 14},
    {8, 11, 16}, {9, 12, 18}, {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};

// decode-order index of the 4x4 block at position (bx, by) — inverse of
// (kBlkX, kBlkY), for top-right availability (h264dec._tr_avail)
constexpr int kZOf[4][4] = {  // [by][bx]
    {0, 1, 4, 5}, {2, 3, 6, 7}, {8, 9, 12, 13}, {10, 11, 14, 15}};

inline int clip255(int64_t v) { return v < 0 ? 0 : v > 255 ? 255 : (int)v; }
inline int64_t clip3(int64_t lo, int64_t hi, int64_t v) {
    return v < lo ? lo : v > hi ? hi : v;
}

struct Dec {
    int mbw, mbh;
    uint8_t *ry, *ru, *rv;  // [mbh*16, mbw*16], [mbh*8, mbw*8] x2
    int yw, cw;             // plane widths
    NnzGrid nnz_y, nnz_u, nnz_v;
    std::vector<int8_t> i4m;    // [mbh*4][mbw*4] intra4x4 mode map, -1 unset
    std::vector<int8_t> qpmap;  // [mbh][mbw]
    int qp_prev;
    int qp_off_u, qp_off_v;
    const uint8_t* tables;

    // ---- inter state (P + B slices; twin of h264dec.py) ------------------
    bool is_p = false;   // any inter slice (P or B)
    bool is_b = false;
    bool direct_spatial = true;
    bool implicit_wp = false;
    int64_t cur_poc = 0;
    int num_ref_active[2] = {1, 1};
    int n_ref_slots = 0;
    const uint8_t *refs_y = nullptr, *refs_u = nullptr, *refs_v = nullptr;
    // per list: entry -> plane slot / picture identity / POC
    const int64_t* ref_slot_l[2] = {nullptr, nullptr};
    const int64_t* ref_pid_l[2] = {nullptr, nullptr};
    const int64_t* ref_poc_l[2] = {nullptr, nullptr};
    // co-located motion of RefPicList1[0] (B direct modes)
    bool col_valid = false, col_intra = false;
    int64_t col_poc = 0;
    const int16_t* col_mv = nullptr;   // [n4][2][2]
    const int8_t* col_ridx = nullptr;  // [n4][2]
    const int64_t* col_rpid = nullptr; // [n4][2]
    const int64_t* col_rpoc = nullptr; // [n4][2]
    bool has_wp = false;
    const int64_t* wp = nullptr;  // log_y, log_c, 6 per l0 entry, then l1
    std::vector<int32_t> mvf;     // [4h*4w][2 lists][2] quarter-pel field
    std::vector<int8_t> ridx;     // [4h*4w][2] list index, -1 intra/unused
    std::vector<int32_t> rpid;    // [4h*4w][2] stored-picture id (bS)
    std::vector<int32_t> rpoc;    // [4h*4w][2] referenced-picture POC
    std::vector<uint8_t> dec4;    // [4h*4w] partition decoded (6.4.9)
    std::vector<uint8_t> rknown;  // [4h*4w][2] ref known pre-MV (CABAC)
    std::vector<uint8_t> direct4; // [4h*4w] direct-inferred cell (CABAC)
    std::vector<uint8_t> mbintra; // [h*w], 1 = intra (I slices: all)

    Dec(int w, int h, uint8_t* y, uint8_t* u, uint8_t* v, int offu, int offv,
        const uint8_t* tab)
        : mbw(w), mbh(h), ry(y), ru(u), rv(v), yw(w * 16), cw(w * 8),
          nnz_y(h * 4, w * 4), nnz_u(h * 2, w * 2), nnz_v(h * 2, w * 2),
          i4m((size_t)h * 4 * w * 4, -1), qpmap((size_t)h * w, 0),
          qp_prev(26), qp_off_u(offu), qp_off_v(offv), tables(tab) {}

    void init_inter(const int n_active[2], int n_slots, const uint8_t* rys,
                    const uint8_t* rus, const uint8_t* rvs,
                    const int64_t* slots0, const int64_t* pids0,
                    const int64_t* pocs0, const int64_t* slots1,
                    const int64_t* pids1, const int64_t* pocs1,
                    bool wp_on, const int64_t* wp_tab) {
        is_p = true;
        num_ref_active[0] = n_active[0];
        num_ref_active[1] = n_active[1];
        n_ref_slots = n_slots;
        refs_y = rys;
        refs_u = rus;
        refs_v = rvs;
        ref_slot_l[0] = slots0;
        ref_pid_l[0] = pids0;
        ref_poc_l[0] = pocs0;
        ref_slot_l[1] = slots1;
        ref_pid_l[1] = pids1;
        ref_poc_l[1] = pocs1;
        has_wp = wp_on;
        wp = wp_tab;
        const size_t n4 = (size_t)mbw * 4 * mbh * 4;
        mvf.assign(n4 * 4, 0);
        ridx.assign(n4 * 2, -1);
        rpid.assign(n4 * 2, -1);
        rpoc.assign(n4 * 2, 0);
        dec4.assign(n4, 0);
        rknown.assign(n4 * 2, 0);
        direct4.assign(n4, 0);
        mbintra.assign((size_t)mbw * mbh, 1);
    }

    inline int8_t& i4mode(int gy, int gx) { return i4m[(size_t)gy * mbw * 4 + gx]; }
    inline size_t c4(int gy, int gx) const { return (size_t)gy * mbw * 4 + gx; }

    // ---- motion vector prediction (spec 8.4.1.3) -----------------------

    // refIdx of cell for list lx: -2 location unavailable/undecoded,
    // -1 intra or list unused
    inline void nbinfo(int cx, int cy, int lx, int* ref, int* vx,
                       int* vy) const {
        if (cx < 0 || cy < 0 || cx >= mbw * 4 || cy >= mbh * 4 ||
            !dec4[c4(cy, cx)]) {
            *ref = -2; *vx = 0; *vy = 0;
            return;
        }
        const int rr = ridx[c4(cy, cx) * 2 + lx];
        if (rr < 0) { *ref = -1; *vx = 0; *vy = 0; return; }
        *ref = rr;
        *vx = mvf[(c4(cy, cx) * 2 + lx) * 2];
        *vy = mvf[(c4(cy, cx) * 2 + lx) * 2 + 1];
    }

    void mvp(int gx, int gy, int w4, int h4, int ref, int hint,
             int* ox, int* oy, int lx = 0) const {
        int ar, ax, ay, br, bx, by, cr, cx, cy;
        nbinfo(gx - 1, gy, lx, &ar, &ax, &ay);
        nbinfo(gx, gy - 1, lx, &br, &bx, &by);
        nbinfo(gx + w4, gy - 1, lx, &cr, &cx, &cy);
        if (cr == -2) nbinfo(gx - 1, gy - 1, lx, &cr, &cx, &cy);  // D subst
        if (hint == kHint16x8Top && br == ref) { *ox = bx; *oy = by; return; }
        if ((hint == kHint16x8Bot || hint == kHint8x16Left) && ar == ref) {
            *ox = ax; *oy = ay; return;
        }
        if (hint == kHint8x16Right && cr == ref) { *ox = cx; *oy = cy; return; }
        const int na = ar == ref, nb = br == ref, nc = cr == ref;
        if (na + nb + nc == 1) {
            if (na) { *ox = ax; *oy = ay; }
            else if (nb) { *ox = bx; *oy = by; }
            else { *ox = cx; *oy = cy; }
            return;
        }
        if (br == -2 && cr == -2 && ar != -2) { *ox = ax; *oy = ay; return; }
        *ox = (int)median3(ax, bx, cx);
        *oy = (int)median3(ay, by, cy);
    }

    void set_part(int mx, int my, int px, int py, int w, int h, int ref,
                  int vx, int vy, int lx = 0) {
        const int gx = mx * 4 + px / 4, gy = my * 4 + py / 4;
        const int32_t pid = (int32_t)ref_pid_l[lx][ref];
        const int32_t poc = (int32_t)ref_poc_l[lx][ref];
        for (int ty = gy; ty < gy + h / 4; ty++)
            for (int tx = gx; tx < gx + w / 4; tx++) {
                mvf[(c4(ty, tx) * 2 + lx) * 2] = vx;
                mvf[(c4(ty, tx) * 2 + lx) * 2 + 1] = vy;
                ridx[c4(ty, tx) * 2 + lx] = (int8_t)ref;
                rpid[c4(ty, tx) * 2 + lx] = pid;
                rpoc[c4(ty, tx) * 2 + lx] = poc;
                dec4[c4(ty, tx)] = 1;
            }
    }

    // implicit bipred weights from POC distances (8.4.2.3.1, logWD 5)
    void implicit_weights(int r0, int r1, int64_t* w0, int64_t* w1) const {
        const int64_t poc0 = ref_poc_l[0][r0], poc1 = ref_poc_l[1][r1];
        int64_t td = clip3(-128, 127, poc1 - poc0);
        if (td == 0) { *w0 = 32; *w1 = 32; return; }
        const int64_t tb = clip3(-128, 127, cur_poc - poc0);
        const int64_t num = 16384 + (td < 0 ? -td : td) / 2;
        const int64_t tx = td > 0 ? num / td : -(num / -td);
        const int64_t dsf = clip3(-1024, 1023, (tb * tx + 32) >> 6);
        if ((dsf >> 2) < -64 || (dsf >> 2) > 128) { *w0 = 32; *w1 = 32; return; }
        *w1 = dsf >> 2;
        *w0 = 64 - *w1;
    }

    void mark_inter(int mx, int my) {
        mbintra[(size_t)my * mbw + mx] = 0;
        for (int ty = my * 4; ty < my * 4 + 4; ty++)
            for (int tx = mx * 4; tx < mx * 4 + 4; tx++)
                i4mode(ty, tx) = 2;  // DC to I_4x4 mode prediction (8.3.1.1)
    }

    // ---- fractional-sample MC (spec 8.4.2.2; twin of av/h264mc.py) ----

    const uint8_t* plane_of(int ref, int comp, int lx = 0) const {
        const int64_t slot = ref_slot_l[lx][ref];
        if (slot < 0 || slot >= n_ref_slots) throw ParseErr{-32, ref};
        const size_t ysz = (size_t)mbw * 16 * mbh * 16;
        const size_t csz = (size_t)mbw * 8 * mbh * 8;
        if (comp == 0) return refs_y + (size_t)slot * ysz;
        return (comp == 1 ? refs_u : refs_v) + (size_t)slot * csz;
    }

    void luma_mc(const uint8_t* pl, int x, int y, int w, int h, int vx,
                 int vy, int64_t* out) const {
        const int W = yw, H = mbh * 16;
        const int xi = x + (vx >> 2), yi = y + (vy >> 2);
        const int xf = vx & 3, yf = vy & 3;
        if (xf == 0 && yf == 0) {
            for (int yy = 0; yy < h; yy++) {
                int sy = yi + yy; sy = sy < 0 ? 0 : sy >= H ? H - 1 : sy;
                for (int xx = 0; xx < w; xx++) {
                    int sx = xi + xx; sx = sx < 0 ? 0 : sx >= W ? W - 1 : sx;
                    out[yy * w + xx] = pl[(size_t)sy * W + sx];
                }
            }
            return;
        }
        // padded full-sample region (h+5) x (w+5), edge clamped
        const int pw = w + 5, ph = h + 5;
        int64_t pad[21 * 21];
        for (int yy = 0; yy < ph; yy++) {
            int sy = yi - 2 + yy; sy = sy < 0 ? 0 : sy >= H ? H - 1 : sy;
            for (int xx = 0; xx < pw; xx++) {
                int sx = xi - 2 + xx; sx = sx < 0 ? 0 : sx >= W ? W - 1 : sx;
                pad[yy * pw + xx] = pl[(size_t)sy * W + sx];
            }
        }
        auto tap = [](const int64_t* p, int stride) -> int64_t {
            return p[0] - 5 * p[stride] + 20 * p[2 * stride] +
                   20 * p[3 * stride] - 5 * p[4 * stride] + p[5 * stride];
        };
        if (yf == 0) {  // horizontal half b + quarter averages
            for (int yy = 0; yy < h; yy++)
                for (int xx = 0; xx < w; xx++) {
                    const int64_t braw = tap(&pad[(yy + 2) * pw + xx], 1);
                    const int64_t b = clip255((braw + 16) >> 5);
                    if (xf == 2) { out[yy * w + xx] = b; continue; }
                    const int64_t o = pad[(yy + 2) * pw + xx + (xf == 1 ? 2 : 3)];
                    out[yy * w + xx] = (o + b + 1) >> 1;
                }
            return;
        }
        if (xf == 0) {  // vertical half h + quarter averages
            for (int yy = 0; yy < h; yy++)
                for (int xx = 0; xx < w; xx++) {
                    const int64_t vraw = tap(&pad[yy * pw + xx + 2], pw);
                    const int64_t hh = clip255((vraw + 16) >> 5);
                    if (yf == 2) { out[yy * w + xx] = hh; continue; }
                    const int64_t o = pad[(yy + (yf == 1 ? 2 : 3)) * pw + xx + 2];
                    out[yy * w + xx] = (o + hh + 1) >> 1;
                }
            return;
        }
        if (xf == 2) {  // j column, plus f/q vertical quarters
            int64_t braw[21 * 16];  // (h+5) x w raw horizontal sums
            for (int yy = 0; yy < ph; yy++)
                for (int xx = 0; xx < w; xx++)
                    braw[yy * w + xx] = tap(&pad[yy * pw + xx], 1);
            for (int yy = 0; yy < h; yy++)
                for (int xx = 0; xx < w; xx++) {
                    const int64_t jraw = tap(&braw[yy * w + xx], w);
                    const int64_t j = clip255((jraw + 512) >> 10);
                    if (yf == 2) { out[yy * w + xx] = j; continue; }
                    const int row = yf == 1 ? 2 : 3;
                    const int64_t b =
                        clip255((braw[(yy + row) * w + xx] + 16) >> 5);
                    out[yy * w + xx] = (b + j + 1) >> 1;
                }
            return;
        }
        if (yf == 2) {  // i/k: horizontal quarters of j
            int64_t vraw[16 * 21];  // h x (w+5) raw vertical sums
            for (int yy = 0; yy < h; yy++)
                for (int xx = 0; xx < pw; xx++)
                    vraw[yy * pw + xx] = tap(&pad[yy * pw + xx], pw);
            for (int yy = 0; yy < h; yy++)
                for (int xx = 0; xx < w; xx++) {
                    const int64_t jraw = tap(&vraw[yy * pw + xx], 1);
                    const int64_t j = clip255((jraw + 512) >> 10);
                    const int col = xf == 1 ? 2 : 3;
                    const int64_t hv =
                        clip255((vraw[yy * pw + xx + col] + 16) >> 5);
                    out[yy * w + xx] = (hv + j + 1) >> 1;
                }
            return;
        }
        // corner quarters e/g/p/r: nearest half-sample average
        const int row = yf == 1 ? 2 : 3, col = xf == 1 ? 2 : 3;
        for (int yy = 0; yy < h; yy++)
            for (int xx = 0; xx < w; xx++) {
                const int64_t b =
                    clip255((tap(&pad[(yy + row) * pw + xx], 1) + 16) >> 5);
                const int64_t hv =
                    clip255((tap(&pad[yy * pw + xx + col], pw) + 16) >> 5);
                out[yy * w + xx] = (b + hv + 1) >> 1;
            }
    }

    void chroma_mc(const uint8_t* pl, int x, int y, int w, int h, int vx,
                   int vy, int64_t* out) const {
        const int W = cw, H = mbh * 8;
        const int xi = x + (vx >> 3), yi = y + (vy >> 3);
        const int xf = vx & 7, yf = vy & 7;
        int64_t pad[9 * 9];
        for (int yy = 0; yy <= h; yy++) {
            int sy = yi + yy; sy = sy < 0 ? 0 : sy >= H ? H - 1 : sy;
            for (int xx = 0; xx <= w; xx++) {
                int sx = xi + xx; sx = sx < 0 ? 0 : sx >= W ? W - 1 : sx;
                pad[yy * (w + 1) + xx] = pl[(size_t)sy * W + sx];
            }
        }
        for (int yy = 0; yy < h; yy++)
            for (int xx = 0; xx < w; xx++) {
                const int64_t a = pad[yy * (w + 1) + xx];
                const int64_t b = pad[yy * (w + 1) + xx + 1];
                const int64_t c = pad[(yy + 1) * (w + 1) + xx];
                const int64_t d = pad[(yy + 1) * (w + 1) + xx + 1];
                out[yy * w + xx] =
                    ((8 - xf) * (8 - yf) * a + xf * (8 - yf) * b +
                     (8 - xf) * yf * c + xf * yf * d + 32) >> 6;
            }
    }

    static void wp_apply(int64_t* blk, int n, int64_t w, int64_t o,
                         int64_t log_wd) {
        if (log_wd >= 1) {
            const int64_t r = (int64_t)1 << (log_wd - 1);
            for (int i = 0; i < n; i++)
                blk[i] = clip255(((blk[i] * w + r) >> log_wd) + o);
        } else {
            for (int i = 0; i < n; i++) blk[i] = clip255(blk[i] * w + o);
        }
    }

    // refs[lx] -1 = list unused; single-list parts leave the other zeroed
    struct Part { int px, py, w, h; int refs[2]; int vx[2], vy[2]; };

    static Part part1(int px, int py, int w, int h, int ref, int vx, int vy,
                      int lx = 0) {
        Part p{px, py, w, h, {-1, -1}, {0, 0}, {0, 0}};
        p.refs[lx] = ref;
        p.vx[lx] = vx;
        p.vy[lx] = vy;
        return p;
    }

    // explicit-WP table entry for (lx, ref): l0 entries then l1 entries
    const int64_t* wp_entry(int lx, int ref) const {
        return wp + 2 + 6 * (lx == 0 ? ref : num_ref_active[0] + ref);
    }

    void mc_one(int lx, int ref, int x, int y, int w, int h, int vx, int vy,
                int64_t* by_, int64_t* bu, int64_t* bv) const {
        luma_mc(plane_of(ref, 0, lx), x, y, w, h, vx, vy, by_);
        chroma_mc(plane_of(ref, 1, lx), x / 2, y / 2, w / 2, h / 2, vx, vy,
                  bu);
        chroma_mc(plane_of(ref, 2, lx), x / 2, y / 2, w / 2, h / 2, vx, vy,
                  bv);
    }

    void inter_pred_mb(int mx, int my, const Part* parts, int np,
                       int64_t* py_, int64_t* pu, int64_t* pv) const {
        const int y0 = my * 16, x0 = mx * 16;
        int64_t by_[256], bu[64], bv[64];
        int64_t by1[256], bu1[64], bv1[64];
        for (int p = 0; p < np; p++) {
            const Part& pt = parts[p];
            const bool bi = pt.refs[0] >= 0 && pt.refs[1] >= 0;
            const int lx = pt.refs[0] >= 0 ? 0 : 1;
            mc_one(lx, pt.refs[lx], x0 + pt.px, y0 + pt.py, pt.w, pt.h,
                   pt.vx[lx], pt.vy[lx], by_, bu, bv);
            if (bi) {
                mc_one(1, pt.refs[1], x0 + pt.px, y0 + pt.py, pt.w, pt.h,
                       pt.vx[1], pt.vy[1], by1, bu1, bv1);
                const int ny = pt.w * pt.h, nc = ny / 4;
                if (has_wp) {  // explicit bipred (8.4.2.3.2)
                    const int64_t log_y = wp[0], log_c = wp[1];
                    const int64_t* e0 = wp_entry(0, pt.refs[0]);
                    const int64_t* e1 = wp_entry(1, pt.refs[1]);
                    auto wbi = [](int64_t* a, const int64_t* b, int n,
                                  int64_t w0, int64_t w1, int64_t o0,
                                  int64_t o1, int64_t lg) {
                        const int64_t r = (int64_t)1 << lg;
                        const int64_t oo = (o0 + o1 + 1) >> 1;
                        for (int i = 0; i < n; i++)
                            a[i] = clip255(((a[i] * w0 + b[i] * w1 + r) >>
                                            (lg + 1)) + oo);
                    };
                    wbi(by_, by1, ny, e0[0], e1[0], e0[1], e1[1], log_y);
                    wbi(bu, bu1, nc, e0[2], e1[2], e0[3], e1[3], log_c);
                    wbi(bv, bv1, nc, e0[4], e1[4], e0[5], e1[5], log_c);
                } else if (implicit_wp) {
                    int64_t w0, w1;
                    implicit_weights(pt.refs[0], pt.refs[1], &w0, &w1);
                    for (int i = 0; i < ny; i++)
                        by_[i] = clip255((by_[i] * w0 + by1[i] * w1 + 32) >> 6);
                    for (int i = 0; i < nc; i++) {
                        bu[i] = clip255((bu[i] * w0 + bu1[i] * w1 + 32) >> 6);
                        bv[i] = clip255((bv[i] * w0 + bv1[i] * w1 + 32) >> 6);
                    }
                } else {  // default average
                    for (int i = 0; i < ny; i++) by_[i] = (by_[i] + by1[i] + 1) >> 1;
                    for (int i = 0; i < nc; i++) {
                        bu[i] = (bu[i] + bu1[i] + 1) >> 1;
                        bv[i] = (bv[i] + bv1[i] + 1) >> 1;
                    }
                }
            } else if (has_wp) {
                const int64_t log_y = wp[0], log_c = wp[1];
                const int64_t* e = wp_entry(lx, pt.refs[lx]);
                wp_apply(by_, pt.w * pt.h, e[0], e[1], log_y);
                wp_apply(bu, pt.w * pt.h / 4, e[2], e[3], log_c);
                wp_apply(bv, pt.w * pt.h / 4, e[4], e[5], log_c);
            }
            for (int yy = 0; yy < pt.h; yy++)
                for (int xx = 0; xx < pt.w; xx++)
                    py_[(pt.py + yy) * 16 + pt.px + xx] = by_[yy * pt.w + xx];
            for (int yy = 0; yy < pt.h / 2; yy++)
                for (int xx = 0; xx < pt.w / 2; xx++) {
                    pu[(pt.py / 2 + yy) * 8 + pt.px / 2 + xx] =
                        bu[yy * (pt.w / 2) + xx];
                    pv[(pt.py / 2 + yy) * 8 + pt.px / 2 + xx] =
                        bv[yy * (pt.w / 2) + xx];
                }
        }
    }

    void p_skip_mb(int mx, int my) {
        mark_inter(mx, my);
        const int gx = mx * 4, gy = my * 4;
        int ar, ax, ay, br, bx, by;
        nbinfo(gx - 1, gy, 0, &ar, &ax, &ay);
        nbinfo(gx, gy - 1, 0, &br, &bx, &by);
        int vx = 0, vy = 0;
        if (!(ar == -2 || br == -2 || (ar == 0 && ax == 0 && ay == 0) ||
              (br == 0 && bx == 0 && by == 0)))
            mvp(gx, gy, 4, 4, 0, kHintNone, &vx, &vy);
        if (num_ref_active[0] < 1 || ref_slot_l[0][0] < 0)
            throw ParseErr{-32, 0};
        set_part(mx, my, 0, 0, 16, 16, 0, vx, vy);
        int64_t py_[256], pu[64], pv[64];
        const Part pt = part1(0, 0, 16, 16, 0, vx, vy);
        inter_pred_mb(mx, my, &pt, 1, py_, pu, pv);
        const int y0 = my * 16, x0 = mx * 16, cy0 = my * 8, cx0 = mx * 8;
        for (int yy = 0; yy < 16; yy++)
            for (int xx = 0; xx < 16; xx++)
                ry[(size_t)(y0 + yy) * yw + x0 + xx] =
                    (uint8_t)py_[yy * 16 + xx];
        for (int yy = 0; yy < 8; yy++)
            for (int xx = 0; xx < 8; xx++) {
                ru[(size_t)(cy0 + yy) * cw + cx0 + xx] = (uint8_t)pu[yy * 8 + xx];
                rv[(size_t)(cy0 + yy) * cw + cx0 + xx] = (uint8_t)pv[yy * 8 + xx];
            }
        for (int ty = gy; ty < gy + 4; ty++)
            for (int tx = gx; tx < gx + 4; tx++) nnz_y.at(ty, tx) = 0;
        for (int ty = my * 2; ty < my * 2 + 2; ty++)
            for (int tx = mx * 2; tx < mx * 2 + 2; tx++) {
                nnz_u.at(ty, tx) = 0;
                nnz_v.at(ty, tx) = 0;
            }
        qpmap[(size_t)my * mbw + mx] = (int8_t)qp_prev;  // QPy unchanged
    }

    void recon_inter(int mx, int my, int qp, int64_t z[16][16],
                     int64_t czd[2][4], int64_t cza[2][4][16],
                     const int64_t* pred_y, const int64_t* pred_u,
                     const int64_t* pred_v) {
        const int y0 = my * 16, x0 = mx * 16;
        for (int i = 0; i < 16; i++) {
            const int bx = kBlkX[i], by = kBlkY[i];
            int64_t dq[16], res[16];
            dequant(z[i], qp, dq);
            idct4x4(dq, res);
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    const int64_t o = ((res[y * 4 + x] + 32) >> 6) +
                                      pred_y[(4 * by + y) * 16 + 4 * bx + x];
                    ry[(size_t)(y0 + 4 * by + y) * yw + x0 + 4 * bx + x] =
                        (uint8_t)clip255(o);
                }
        }
        recon_chroma(mx, my, qp, 0, czd, cza, pred_u, pred_v);
    }

    // CAVLC P macroblock (spec 7.3.5; twin of h264dec._decode_mb_p)
    int read_ref_idx(Bits& r, int lx = 0) {
        int idx;
        if (num_ref_active[lx] == 1) idx = 0;
        else if (num_ref_active[lx] == 2) idx = 1 - (int)r.read(1);  // te
        else idx = (int)r.ue();
        if (idx >= num_ref_active[lx] || ref_slot_l[lx][idx] < 0)
            throw ParseErr{-32, idx};
        return idx;
    }

    void decode_mb_p(Bits& r, int mx, int my, int64_t mb_type) {
        mark_inter(mx, my);
        Part parts[16];
        int np = 0;
        if (mb_type <= 2) {
            const int n = kPPartN[mb_type];
            int refs[2], dx[2], dy[2];
            for (int p = 0; p < n; p++) refs[p] = read_ref_idx(r);
            for (int p = 0; p < n; p++) {
                dx[p] = (int)r.se();
                dy[p] = (int)r.se();
            }
            for (int p = 0; p < n; p++) {
                const int* sh = kPParts[mb_type][p];
                const int gx = mx * 4 + sh[0] / 4, gy = my * 4 + sh[1] / 4;
                int hint = kHintNone;
                if (mb_type == 1) hint = p == 0 ? kHint16x8Top : kHint16x8Bot;
                if (mb_type == 2) hint = p == 0 ? kHint8x16Left : kHint8x16Right;
                int px_x, px_y;
                mvp(gx, gy, sh[2] / 4, sh[3] / 4, refs[p], hint, &px_x, &px_y);
                const int vx = px_x + dx[p], vy = px_y + dy[p];
                set_part(mx, my, sh[0], sh[1], sh[2], sh[3], refs[p], vx, vy);
                parts[np++] = part1(sh[0], sh[1], sh[2], sh[3], refs[p], vx, vy);
            }
        } else {  // P_8x8 (3) / P_8x8ref0 (4)
            if (mb_type > 4) throw ParseErr{-4, mb_type};
            int subs[4], refs[4] = {0, 0, 0, 0};
            for (int b = 0; b < 4; b++) {
                const int64_t st = r.ue();
                if (st > 3) throw ParseErr{-33, st};
                subs[b] = (int)st;
            }
            if (mb_type == 3)
                for (int b = 0; b < 4; b++) refs[b] = read_ref_idx(r);
            else if (ref_slot_l[0][0] < 0)
                throw ParseErr{-32, 0};
            int dx[4][4], dy[4][4];
            for (int b = 0; b < 4; b++)
                for (int s = 0; s < kPSubN[subs[b]]; s++) {
                    dx[b][s] = (int)r.se();
                    dy[b][s] = (int)r.se();
                }
            for (int b = 0; b < 4; b++) {
                const int bx0 = (b % 2) * 8, by0 = (b / 2) * 8;
                for (int s = 0; s < kPSubN[subs[b]]; s++) {
                    const int* sh = kPSub[subs[b]][s];
                    const int px = bx0 + sh[0], py = by0 + sh[1];
                    const int gx = mx * 4 + px / 4, gy = my * 4 + py / 4;
                    int px_x, px_y;
                    mvp(gx, gy, sh[2] / 4, sh[3] / 4, refs[b], kHintNone,
                        &px_x, &px_y);
                    const int vx = px_x + dx[b][s], vy = px_y + dy[b][s];
                    set_part(mx, my, px, py, sh[2], sh[3], refs[b], vx, vy);
                    parts[np++] = part1(px, py, sh[2], sh[3], refs[b], vx, vy);
                }
            }
        }
        int64_t pred_y[256], pred_u[64], pred_v[64];
        inter_pred_mb(mx, my, parts, np, pred_y, pred_u, pred_v);

        const int64_t cbp_code = r.ue();
        if (cbp_code >= 48) throw ParseErr{-10, cbp_code};
        const int cbp = kCbpInter[cbp_code];
        const int cbp_luma = cbp & 15, cbp_chroma = cbp >> 4;
        int qp;
        if (cbp) {
            qp = (int)(((qp_prev + r.se()) % 52 + 52) % 52);
            qp_prev = qp;
        } else {
            qp = qp_prev;
        }
        qpmap[(size_t)my * mbw + mx] = (int8_t)qp;

        const int gy0 = my * 4, gx0 = mx * 4;
        for (int ty = gy0; ty < gy0 + 4; ty++)
            for (int tx = gx0; tx < gx0 + 4; tx++) nnz_y.at(ty, tx) = 0;
        int64_t z[16][16];
        for (int i = 0; i < 16; i++)
            for (int k = 0; k < 16; k++) z[i][k] = 0;
        for (int i = 0; i < 16; i++) {
            if (!((cbp_luma >> (i >> 2)) & 1)) continue;
            const int bx = kBlkX[i], by = kBlkY[i];
            const int nC = h264::nc_of(nnz_y, mx, my, bx, by, 4);
            int64_t scan[16] = {0};
            const int tot = h264::read_block(r, nC, 16, scan, tables);
            for (int k = 0; k < 16; k++) z[i][kZigzag[k]] = scan[k];
            nnz_y.at(gy0 + by, gx0 + bx) = (int16_t)tot;
        }
        int64_t czd[2][4], cza[2][4][16];
        read_chroma(r, mx, my, cbp_chroma, czd, cza);
        recon_inter(mx, my, qp, z, czd, cza, pred_y, pred_u, pred_v);
    }

    // ---- B macroblocks (spec 7.3.5, 8.4.1.2; twin of h264dec.py) -------

    // B mb_type 1..21 (Table 7-14): {shape key, mask0, mask1};
    // mask 1 = list0, 2 = list1, 3 = bi
    // (indexed by mb_type - 1)
    static constexpr int kBModes[21][3] = {
        {0, 1, 0}, {0, 2, 0}, {0, 3, 0},
        {1, 1, 1}, {2, 1, 1}, {1, 2, 2}, {2, 2, 2},
        {1, 1, 2}, {2, 1, 2}, {1, 2, 1}, {2, 2, 1},
        {1, 1, 3}, {2, 1, 3}, {1, 2, 3}, {2, 2, 3},
        {1, 3, 1}, {2, 3, 1}, {1, 3, 2}, {2, 3, 2},
        {1, 3, 3}, {2, 3, 3}};
    // B sub_mb_type 1..12 (Table 7-18): {shape key into kPSub, mask}
    static constexpr int kBSub[12][2] = {
        {0, 1}, {0, 2}, {0, 3}, {1, 1}, {2, 1}, {1, 2}, {2, 2},
        {1, 3}, {2, 3}, {3, 1}, {3, 2}, {3, 3}};

    // co-located 4x4 cell of RefPicList1[0]: refIdxCol -1 when intra
    inline void col_cell(int ccy, int ccx, int* clx, int* cref, int* cmx,
                         int* cmy) const {
        if (col_intra) { *clx = 0; *cref = -1; *cmx = 0; *cmy = 0; return; }
        const size_t c = (size_t)ccy * mbw * 4 + ccx;
        int rr = col_ridx[c * 2], lx = 0;
        if (rr < 0) { rr = col_ridx[c * 2 + 1]; lx = 1; }
        *clx = lx;
        *cref = rr;
        if (rr < 0) { *cmx = 0; *cmy = 0; return; }
        *cmx = col_mv[(c * 2 + lx) * 2];
        *cmy = col_mv[(c * 2 + lx) * 2 + 1];
    }

    // MB-level spatial direct refs + MV predictors (8.4.1.2.2)
    void direct_refs_spatial(int gx0, int gy0, int* r0, int* r1,
                             int mvps[2][2], bool* zero_pred) const {
        int refs[2];
        for (int lx = 0; lx < 2; lx++) {
            int ar, ax, ay, br, bx, by, cr, cx, cy;
            nbinfo(gx0 - 1, gy0, lx, &ar, &ax, &ay);
            nbinfo(gx0, gy0 - 1, lx, &br, &bx, &by);
            nbinfo(gx0 + 4, gy0 - 1, lx, &cr, &cx, &cy);
            if (cr == -2) nbinfo(gx0 - 1, gy0 - 1, lx, &cr, &cx, &cy);
            int mn = -1;
            for (int v : {ar, br, cr})
                if (v >= 0 && (mn < 0 || v < mn)) mn = v;
            refs[lx] = mn;
        }
        *r0 = refs[0];
        *r1 = refs[1];
        if (refs[0] < 0 && refs[1] < 0) {
            *r0 = *r1 = 0;
            mvps[0][0] = mvps[0][1] = mvps[1][0] = mvps[1][1] = 0;
            *zero_pred = true;
            return;
        }
        *zero_pred = false;
        for (int lx = 0; lx < 2; lx++) {
            if (refs[lx] >= 0) {
                if (refs[lx] >= num_ref_active[lx] ||
                    ref_slot_l[lx][refs[lx]] < 0)
                    throw ParseErr{-32, refs[lx]};
                mvp(gx0, gy0, 4, 4, refs[lx], kHintNone, &mvps[lx][0],
                    &mvps[lx][1], lx);
            } else {
                mvps[lx][0] = mvps[lx][1] = 0;
            }
        }
    }

    // direct motion for the 8x8 blocks in `blocks` (8.4.1.2,
    // direct_8x8_inference): fills parts and sets the motion state
    int direct_parts(int mx, int my, const int* blocks, int nb, Part* out) {
        if (!col_valid) throw ParseErr{-40, 0};
        const int gx0 = mx * 4, gy0 = my * 4;
        int np = 0;
        if (direct_spatial) {
            int r0, r1, mvps[2][2];
            bool zero_pred;
            direct_refs_spatial(gx0, gy0, &r0, &r1, mvps, &zero_pred);
            for (int bi = 0; bi < nb; bi++) {
                const int b8 = blocks[bi];
                const int bx0 = (b8 & 1) * 8, by0 = (b8 >> 1) * 8;
                const int ccx = gx0 + 3 * (b8 & 1), ccy = gy0 + 3 * (b8 >> 1);
                bool colzero = false;
                if (!zero_pred) {
                    int clx, cref, cmx, cmy;
                    col_cell(ccy, ccx, &clx, &cref, &cmx, &cmy);
                    if (cref == 0)
                        colzero = cmx >= -1 && cmx <= 1 && cmy >= -1 &&
                                  cmy <= 1;
                }
                Part p{bx0, by0, 8, 8, {r0, r1}, {0, 0}, {0, 0}};
                for (int lx = 0; lx < 2; lx++) {
                    const int ref = lx == 0 ? r0 : r1;
                    if (ref < 0) continue;
                    if (!(zero_pred || (ref == 0 && colzero))) {
                        p.vx[lx] = mvps[lx][0];
                        p.vy[lx] = mvps[lx][1];
                    }
                    set_part(mx, my, bx0, by0, 8, 8, ref, p.vx[lx],
                             p.vy[lx], lx);
                }
                for (int ty = gy0 + by0 / 4; ty < gy0 + by0 / 4 + 2; ty++)
                    for (int tx = gx0 + bx0 / 4; tx < gx0 + bx0 / 4 + 2; tx++)
                        direct4[c4(ty, tx)] = 1;
                out[np++] = p;
            }
            return np;
        }
        // temporal direct (8.4.1.2.3)
        for (int bi = 0; bi < nb; bi++) {
            const int b8 = blocks[bi];
            const int bx0 = (b8 & 1) * 8, by0 = (b8 >> 1) * 8;
            const int ccx = gx0 + 3 * (b8 & 1), ccy = gy0 + 3 * (b8 >> 1);
            int clx, cref, cmx, cmy;
            col_cell(ccy, ccx, &clx, &cref, &cmx, &cmy);
            int r0 = 0, v0x = 0, v0y = 0, v1x = 0, v1y = 0;
            if (cref >= 0) {
                const size_t c = (size_t)ccy * mbw * 4 + ccx;
                const int64_t colpid = col_rpid[c * 2 + clx];
                const int64_t colpoc = col_rpoc[c * 2 + clx];
                r0 = -1;
                for (int i = 0; i < num_ref_active[0]; i++)
                    if (ref_slot_l[0][i] >= 0 && ref_pid_l[0][i] == colpid) {
                        r0 = i;
                        break;
                    }
                if (r0 < 0) throw ParseErr{-41, 0};
                const int64_t td = clip3(-128, 127, col_poc - colpoc);
                if (td == 0) {
                    v0x = cmx; v0y = cmy;
                } else {
                    const int64_t tb = clip3(-128, 127, cur_poc - colpoc);
                    const int64_t num = 16384 + (td < 0 ? -td : td) / 2;
                    const int64_t tx = td > 0 ? num / td : -(num / -td);
                    const int64_t dsf = clip3(-1024, 1023, (tb * tx + 32) >> 6);
                    v0x = (int)((dsf * cmx + 128) >> 8);
                    v0y = (int)((dsf * cmy + 128) >> 8);
                    v1x = v0x - cmx;
                    v1y = v0y - cmy;
                }
            }
            if (ref_slot_l[0][r0] < 0 || ref_slot_l[1][0] < 0)
                throw ParseErr{-32, r0};
            set_part(mx, my, bx0, by0, 8, 8, r0, v0x, v0y, 0);
            set_part(mx, my, bx0, by0, 8, 8, 0, v1x, v1y, 1);
            for (int ty = gy0 + by0 / 4; ty < gy0 + by0 / 4 + 2; ty++)
                for (int tx = gx0 + bx0 / 4; tx < gx0 + bx0 / 4 + 2; tx++)
                    direct4[c4(ty, tx)] = 1;
            out[np++] = Part{bx0, by0, 8, 8, {r0, 0},
                             {v0x, v1x}, {v0y, v1y}};
        }
        return np;
    }

    void store_planes_mb(int mx, int my, const int64_t* py_,
                         const int64_t* pu, const int64_t* pv) {
        const int y0 = my * 16, x0 = mx * 16, cy0 = my * 8, cx0 = mx * 8;
        for (int yy = 0; yy < 16; yy++)
            for (int xx = 0; xx < 16; xx++)
                ry[(size_t)(y0 + yy) * yw + x0 + xx] =
                    (uint8_t)py_[yy * 16 + xx];
        for (int yy = 0; yy < 8; yy++)
            for (int xx = 0; xx < 8; xx++) {
                ru[(size_t)(cy0 + yy) * cw + cx0 + xx] =
                    (uint8_t)pu[yy * 8 + xx];
                rv[(size_t)(cy0 + yy) * cw + cx0 + xx] =
                    (uint8_t)pv[yy * 8 + xx];
            }
    }

    void b_skip_mb(int mx, int my) {
        mark_inter(mx, my);
        static constexpr int kAll[4] = {0, 1, 2, 3};
        Part parts[4];
        const int np = direct_parts(mx, my, kAll, 4, parts);
        int64_t py_[256], pu[64], pv[64];
        inter_pred_mb(mx, my, parts, np, py_, pu, pv);
        store_planes_mb(mx, my, py_, pu, pv);
        for (int ty = my * 4; ty < my * 4 + 4; ty++)
            for (int tx = mx * 4; tx < mx * 4 + 4; tx++)
                nnz_y.at(ty, tx) = 0;
        for (int ty = my * 2; ty < my * 2 + 2; ty++)
            for (int tx = mx * 2; tx < mx * 2 + 2; tx++) {
                nnz_u.at(ty, tx) = 0;
                nnz_v.at(ty, tx) = 0;
            }
        qpmap[(size_t)my * mbw + mx] = (int8_t)qp_prev;
    }

    // shared CAVLC inter residual + recon tail (P and B)
    void finish_inter_cavlc(Bits& r, int mx, int my, const int64_t* pred_y,
                            const int64_t* pred_u, const int64_t* pred_v) {
        const int64_t cbp_code = r.ue();
        if (cbp_code >= 48) throw ParseErr{-10, cbp_code};
        const int cbp = kCbpInter[cbp_code];
        const int cbp_luma = cbp & 15, cbp_chroma = cbp >> 4;
        int qp;
        if (cbp) {
            qp = (int)(((qp_prev + r.se()) % 52 + 52) % 52);
            qp_prev = qp;
        } else {
            qp = qp_prev;
        }
        qpmap[(size_t)my * mbw + mx] = (int8_t)qp;

        const int gy0 = my * 4, gx0 = mx * 4;
        for (int ty = gy0; ty < gy0 + 4; ty++)
            for (int tx = gx0; tx < gx0 + 4; tx++) nnz_y.at(ty, tx) = 0;
        int64_t z[16][16];
        for (int i = 0; i < 16; i++)
            for (int k = 0; k < 16; k++) z[i][k] = 0;
        for (int i = 0; i < 16; i++) {
            if (!((cbp_luma >> (i >> 2)) & 1)) continue;
            const int bx = kBlkX[i], by = kBlkY[i];
            const int nC = h264::nc_of(nnz_y, mx, my, bx, by, 4);
            int64_t scan[16] = {0};
            const int tot = h264::read_block(r, nC, 16, scan, tables);
            for (int k = 0; k < 16; k++) z[i][kZigzag[k]] = scan[k];
            nnz_y.at(gy0 + by, gx0 + bx) = (int16_t)tot;
        }
        int64_t czd[2][4], cza[2][4][16];
        read_chroma(r, mx, my, cbp_chroma, czd, cza);
        recon_inter(mx, my, qp, z, czd, cza, pred_y, pred_u, pred_v);
    }

    // CAVLC B macroblock (mb_type 0..22 already read by the caller)
    void decode_mb_b(Bits& r, int mx, int my, int64_t mb_type) {
        mark_inter(mx, my);
        Part parts[16];
        int np = 0;
        if (mb_type == 0) {  // B_Direct_16x16
            static constexpr int kAll[4] = {0, 1, 2, 3};
            np = direct_parts(mx, my, kAll, 4, parts);
        } else if (mb_type != 22) {
            const int* bm = kBModes[mb_type - 1];
            const int shape = bm[0];
            const int n = kPPartN[shape];
            int refs[2][2] = {{-1, -1}, {-1, -1}};  // [part][lx]
            for (int lx = 0; lx < 2; lx++)
                for (int p = 0; p < n; p++)
                    if (bm[1 + p] & (1 << lx))
                        refs[p][lx] = read_ref_idx(r, lx);
            Part ps[2];
            for (int p = 0; p < n; p++) {
                const int* sh = kPParts[shape][p];
                ps[p] = Part{sh[0], sh[1], sh[2], sh[3], {-1, -1},
                             {0, 0}, {0, 0}};
            }
            for (int lx = 0; lx < 2; lx++)
                for (int p = 0; p < n; p++) {
                    if (!(bm[1 + p] & (1 << lx))) continue;
                    const int* sh = kPParts[shape][p];
                    const int gx = mx * 4 + sh[0] / 4,
                              gy = my * 4 + sh[1] / 4;
                    const int dx = (int)r.se(), dy = (int)r.se();
                    int hint = kHintNone;
                    if (shape == 1)
                        hint = p == 0 ? kHint16x8Top : kHint16x8Bot;
                    if (shape == 2)
                        hint = p == 0 ? kHint8x16Left : kHint8x16Right;
                    int px_x, px_y;
                    mvp(gx, gy, sh[2] / 4, sh[3] / 4, refs[p][lx], hint,
                        &px_x, &px_y, lx);
                    ps[p].refs[lx] = refs[p][lx];
                    ps[p].vx[lx] = px_x + dx;
                    ps[p].vy[lx] = px_y + dy;
                    set_part(mx, my, sh[0], sh[1], sh[2], sh[3],
                             refs[p][lx], px_x + dx, px_y + dy, lx);
                }
            for (int p = 0; p < n; p++) parts[np++] = ps[p];
        } else {  // B_8x8
            int subs[4];
            for (int b = 0; b < 4; b++) {
                const int64_t st = r.ue();
                if (st > 12) throw ParseErr{-33, st};
                subs[b] = (int)st;
            }
            int dblocks[4], ndb = 0;
            for (int b = 0; b < 4; b++)
                if (subs[b] == 0) dblocks[ndb++] = b;
            Part dparts[4];
            int ndp = 0;
            if (ndb) ndp = direct_parts(mx, my, dblocks, ndb, dparts);
            (void)ndp;
            int refs[4][2];
            for (int b = 0; b < 4; b++) refs[b][0] = refs[b][1] = -1;
            for (int lx = 0; lx < 2; lx++)
                for (int b = 0; b < 4; b++) {
                    if (subs[b] == 0) continue;
                    if (kBSub[subs[b] - 1][1] & (1 << lx))
                        refs[b][lx] = read_ref_idx(r, lx);
                }
            // per-(b8, sub, lx) motion, filled in parse order
            int smv[4][4][2][2];
            bool shas[4][4][2];
            for (int b = 0; b < 4; b++)
                for (int s = 0; s < 4; s++)
                    shas[b][s][0] = shas[b][s][1] = false;
            for (int lx = 0; lx < 2; lx++)
                for (int b = 0; b < 4; b++) {
                    if (subs[b] == 0) continue;
                    const int shape = kBSub[subs[b] - 1][0];
                    if (!(kBSub[subs[b] - 1][1] & (1 << lx))) continue;
                    const int bx0 = (b % 2) * 8, by0 = (b / 2) * 8;
                    for (int s = 0; s < kPSubN[shape]; s++) {
                        const int* sh = kPSub[shape][s];
                        const int px = bx0 + sh[0], py = by0 + sh[1];
                        const int gx = mx * 4 + px / 4,
                                  gy = my * 4 + py / 4;
                        const int dx = (int)r.se(), dy = (int)r.se();
                        int px_x, px_y;
                        mvp(gx, gy, sh[2] / 4, sh[3] / 4, refs[b][lx],
                            kHintNone, &px_x, &px_y, lx);
                        smv[b][s][lx][0] = px_x + dx;
                        smv[b][s][lx][1] = px_y + dy;
                        shas[b][s][lx] = true;
                        set_part(mx, my, px, py, sh[2], sh[3], refs[b][lx],
                                 px_x + dx, px_y + dy, lx);
                    }
                }
            int di = 0;
            for (int b = 0; b < 4; b++) {
                if (subs[b] == 0) {
                    parts[np++] = dparts[di++];
                    continue;
                }
                const int shape = kBSub[subs[b] - 1][0];
                const int bx0 = (b % 2) * 8, by0 = (b / 2) * 8;
                for (int s = 0; s < kPSubN[shape]; s++) {
                    const int* sh = kPSub[shape][s];
                    Part p{bx0 + sh[0], by0 + sh[1], sh[2], sh[3],
                           {-1, -1}, {0, 0}, {0, 0}};
                    for (int lx = 0; lx < 2; lx++)
                        if (shas[b][s][lx]) {
                            p.refs[lx] = refs[b][lx];
                            p.vx[lx] = smv[b][s][lx][0];
                            p.vy[lx] = smv[b][s][lx][1];
                        }
                    parts[np++] = p;
                }
            }
        }
        int64_t pred_y[256], pred_u[64], pred_v[64];
        inter_pred_mb(mx, my, parts, np, pred_y, pred_u, pred_v);
        finish_inter_cavlc(r, mx, my, pred_y, pred_u, pred_v);
    }

    // export the per-4x4 motion for DPB storage (B direct on later pics)
    void export_motion(int16_t* mv_out, int8_t* ridx_out, int64_t* rpid_out,
                       int64_t* rpoc_out) const {
        const size_t n4 = (size_t)mbw * 4 * mbh * 4;
        if (mv_out)
            for (size_t i = 0; i < n4 * 4; i++)
                mv_out[i] = (int16_t)mvf[i];
        if (ridx_out)
            for (size_t i = 0; i < n4 * 2; i++) ridx_out[i] = ridx[i];
        if (rpid_out)
            for (size_t i = 0; i < n4 * 2; i++) rpid_out[i] = rpid[i];
        if (rpoc_out)
            for (size_t i = 0; i < n4 * 2; i++) rpoc_out[i] = rpoc[i];
    }

    // ---- deblocking with derived bS (spec 8.7.2.1) ---------------------

    inline bool mv_far(size_t pc, int plx, size_t qc, int qlx) const {
        const int dvx = mvf[(pc * 2 + plx) * 2] - mvf[(qc * 2 + qlx) * 2];
        const int dvy =
            mvf[(pc * 2 + plx) * 2 + 1] - mvf[(qc * 2 + qlx) * 2 + 1];
        return dvx >= 4 || dvx <= -4 || dvy >= 4 || dvy <= -4;
    }

    int bs_of(int pgx, int pgy, int qgx, int qgy, bool any_intra,
              bool mb_edge) const {
        if (any_intra) return mb_edge ? 4 : 3;
        if (nnz_y.cat(pgy, pgx) || nnz_y.cat(qgy, qgx)) return 2;
        const size_t pc = c4(pgy, pgx), qc = c4(qgy, qgx);
        // 8.7.2.1: the USED reference pictures compare as a set; with the
        // same two pictures the MV check may match either correspondence
        int pu[2], qu[2], npu = 0, nqu = 0;
        for (int lx = 0; lx < 2; lx++) {
            if (ridx[pc * 2 + lx] >= 0) pu[npu++] = lx;
            if (ridx[qc * 2 + lx] >= 0) qu[nqu++] = lx;
        }
        if (npu != nqu) return 1;
        if (npu == 1) {
            if (rpid[pc * 2 + pu[0]] != rpid[qc * 2 + qu[0]]) return 1;
            return mv_far(pc, pu[0], qc, qu[0]) ? 1 : 0;
        }
        const int32_t pp0 = rpid[pc * 2], pp1 = rpid[pc * 2 + 1];
        const int32_t qp0 = rpid[qc * 2], qp1 = rpid[qc * 2 + 1];
        const bool straight_pid = pp0 == qp0 && pp1 == qp1;
        const bool cross_pid = pp0 == qp1 && pp1 == qp0;
        if (!straight_pid && !cross_pid) return 1;
        const bool straight_far =
            mv_far(pc, 0, qc, 0) || mv_far(pc, 1, qc, 1);
        if (pp0 != pp1) {  // two distinct pictures
            if (straight_pid) return straight_far ? 1 : 0;
            return (mv_far(pc, 0, qc, 1) || mv_far(pc, 1, qc, 0)) ? 1 : 0;
        }
        // same picture in both lists: bS 0 if EITHER correspondence near
        const bool cross_far = mv_far(pc, 0, qc, 1) || mv_far(pc, 1, qc, 0);
        return (straight_far && cross_far) ? 1 : 0;
    }

    void deblock_general(int off_a, int off_b) {
        for (int my = 0; my < mbh; my++)
            for (int mx = 0; mx < mbw; mx++) {
                const int qq = qpmap[(size_t)my * mbw + mx];
                const bool intra_q = mbintra[(size_t)my * mbw + mx];
                const int y0 = my * 16, x0 = mx * 16;
                const int cy0 = my * 8, cx0 = mx * 8;
                for (int vi = 1; vi >= 0; vi--) {
                    const bool vertical = vi == 1;
                    for (int xr = 0; xr <= 12; xr += 4) {
                        int pmx = mx, pmy = my;
                        if (xr == 0) {
                            if ((vertical ? mx : my) == 0) continue;
                            if (vertical) pmx = mx - 1; else pmy = my - 1;
                        }
                        const int qp_p = qpmap[(size_t)pmy * mbw + pmx];
                        const bool any_intra =
                            intra_q || mbintra[(size_t)pmy * mbw + pmx];
                        const int qav = (qp_p + qq + 1) >> 1;
                        const int ia = (int)clip3(0, 51, qav + off_a);
                        const int ib = (int)clip3(0, 51, qav + off_b);
                        for (int seg = 0; seg < 4; seg++) {
                            int qgx, qgy, pgx, pgy;
                            if (vertical) {
                                qgx = mx * 4 + xr / 4; qgy = my * 4 + seg;
                                pgx = qgx - 1; pgy = qgy;
                            } else {
                                qgx = mx * 4 + seg; qgy = my * 4 + xr / 4;
                                pgx = qgx; pgy = qgy - 1;
                            }
                            const int bs = bs_of(pgx, pgy, qgx, qgy,
                                                 any_intra, xr == 0);
                            if (bs == 0) continue;
                            if (vertical)
                                edge_filter(ry, yw, y0 + 4 * seg, x0 + xr, 4,
                                            true, bs, ia, ib, false);
                            else
                                edge_filter(ry, yw, y0 + xr, x0 + 4 * seg, 4,
                                            false, bs, ia, ib, false);
                            if (xr == 0 || xr == 8) {
                                for (int comp = 0; comp < 2; comp++) {
                                    uint8_t* plane = comp == 0 ? ru : rv;
                                    const int off =
                                        comp == 0 ? qp_off_u : qp_off_v;
                                    const int cq = (qpc_of(qp_p, off) +
                                                    qpc_of(qq, off) + 1) >> 1;
                                    const int cia =
                                        (int)clip3(0, 51, cq + off_a);
                                    const int cib =
                                        (int)clip3(0, 51, cq + off_b);
                                    if (vertical)
                                        edge_filter(plane, cw, cy0 + 2 * seg,
                                                    cx0 + xr / 2, 2, true,
                                                    bs, cia, cib, true);
                                    else
                                        edge_filter(plane, cw, cy0 + xr / 2,
                                                    cx0 + 2 * seg, 2, false,
                                                    bs, cia, cib, true);
                                }
                            }
                        }
                    }
                }
            }
    }

    // ---- residual helpers ------------------------------------------------

    // read one CAVLC block and place it in FREQUENCY order (row-major 4x4)
    // via the zigzag; max_coeff 16 (full) or 15 (AC, DC slot untouched)
    int read_freq_block(Bits& r, int nC, int max_coeff, int64_t* freq16) {
        int64_t scan[16] = {0};
        int total = h264::read_block(r, nC, max_coeff, scan, tables);
        const int base = max_coeff == 15 ? 1 : 0;
        for (int k = 0; k < max_coeff; k++)
            freq16[kZigzag[base + k]] = scan[k];
        return total;
    }

    static void dequant(const int64_t* z, int qp, int64_t* d) {
        const int q6 = qp / 6, rem = qp % 6;
        for (int i = 0; i < 16; i++) d[i] = (z[i] * v_at(rem, i)) << q6;
    }

    // ---- intra prediction (spec 8.3) --------------------------------------

    int dc_pred16(int y0, int x0, bool ht, bool hl) {
        int64_t ts = 0, ls = 0;
        if (ht) for (int x = 0; x < 16; x++) ts += ry[(y0 - 1) * yw + x0 + x];
        if (hl) for (int y = 0; y < 16; y++) ls += ry[(y0 + y) * yw + x0 - 1];
        if (ht && hl) return (int)((ts + ls + 16) >> 5);
        if (ht) return (int)((ts + 8) >> 4);
        if (hl) return (int)((ls + 8) >> 4);
        return 128;
    }

    // pred16 -> pred[256] row-major
    void pred16(int mode, int y0, int x0, bool ht, bool hl, int64_t* pred) {
        if (mode == 2) {
            const int v = dc_pred16(y0, x0, ht, hl);
            for (int i = 0; i < 256; i++) pred[i] = v;
            return;
        }
        if (mode == 0) {  // Vertical
            if (!ht) throw ParseErr{-11, 0};
            for (int y = 0; y < 16; y++)
                for (int x = 0; x < 16; x++)
                    pred[y * 16 + x] = ry[(y0 - 1) * yw + x0 + x];
            return;
        }
        if (mode == 1) {  // Horizontal
            if (!hl) throw ParseErr{-11, 1};
            for (int y = 0; y < 16; y++)
                for (int x = 0; x < 16; x++)
                    pred[y * 16 + x] = ry[(y0 + y) * yw + x0 - 1];
            return;
        }
        // mode 3: Plane
        if (!(ht && hl)) throw ParseErr{-11, 3};
        int64_t t[17], lf[17];
        for (int i = 0; i < 17; i++) {
            t[i] = ry[(y0 - 1) * yw + x0 - 1 + i];
            lf[i] = ry[(y0 - 1 + i) * yw + x0 - 1];
        }
        int64_t hsum = 0, vsum = 0;
        for (int x = 0; x < 8; x++) hsum += (x + 1) * (t[9 + x] - t[7 - x]);
        for (int y = 0; y < 8; y++) vsum += (y + 1) * (lf[9 + y] - lf[7 - y]);
        const int64_t a = 16 * (lf[16] + t[16]);
        const int64_t b = (5 * hsum + 32) >> 6;
        const int64_t c = (5 * vsum + 32) >> 6;
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++)
                pred[y * 16 + x] =
                    clip255((a + b * (x - 7) + c * (y - 7) + 16) >> 5);
    }

    // chroma prediction -> pred[64] row-major (8x8)
    void predc(uint8_t* plane, int mode, int cy0, int cx0, bool ht, bool hl,
               int64_t* pred) {
        if (mode == 0) {  // DC per 4x4 quadrant (spec 8.3.4.1)
            for (int sy = 0; sy <= 4; sy += 4)
                for (int sx = 0; sx <= 4; sx += 4) {
                    int64_t ts = 0, ls = 0;
                    if (ht)
                        for (int x = 0; x < 4; x++)
                            ts += plane[(cy0 - 1) * cw + cx0 + sx + x];
                    if (hl)
                        for (int y = 0; y < 4; y++)
                            ls += plane[(cy0 + sy + y) * cw + cx0 - 1];
                    int64_t v;
                    const bool corner =
                        (sx == 0 && sy == 0) || (sx == 4 && sy == 4);
                    if (corner && ht && hl) v = (ts + ls + 4) >> 3;
                    else if (sx == 4 && sy == 0)
                        v = ht ? (ts + 2) >> 2 : hl ? (ls + 2) >> 2 : 128;
                    else if (sx == 0 && sy == 4)
                        v = hl ? (ls + 2) >> 2 : ht ? (ts + 2) >> 2 : 128;
                    else
                        v = (ht && hl) ? (ts + ls + 4) >> 3
                            : ht       ? (ts + 2) >> 2
                            : hl       ? (ls + 2) >> 2
                                       : 128;
                    for (int y = 0; y < 4; y++)
                        for (int x = 0; x < 4; x++)
                            pred[(sy + y) * 8 + sx + x] = v;
                }
            return;
        }
        if (mode == 1) {  // Horizontal
            if (!hl) throw ParseErr{-11, 11};
            for (int y = 0; y < 8; y++)
                for (int x = 0; x < 8; x++)
                    pred[y * 8 + x] = plane[(cy0 + y) * cw + cx0 - 1];
            return;
        }
        if (mode == 2) {  // Vertical
            if (!ht) throw ParseErr{-11, 12};
            for (int y = 0; y < 8; y++)
                for (int x = 0; x < 8; x++)
                    pred[y * 8 + x] = plane[(cy0 - 1) * cw + cx0 + x];
            return;
        }
        // mode 3: Plane
        if (!(ht && hl)) throw ParseErr{-11, 13};
        int64_t t[9], lf[9];
        for (int i = 0; i < 9; i++) {
            t[i] = plane[(cy0 - 1) * cw + cx0 - 1 + i];
            lf[i] = plane[(cy0 - 1 + i) * cw + cx0 - 1];
        }
        int64_t hsum = 0, vsum = 0;
        for (int x = 0; x < 4; x++) hsum += (x + 1) * (t[5 + x] - t[3 - x]);
        for (int y = 0; y < 4; y++) vsum += (y + 1) * (lf[5 + y] - lf[3 - y]);
        const int64_t a = 16 * (lf[8] + t[8]);
        const int64_t b = (17 * hsum + 16) >> 5;
        const int64_t c = (17 * vsum + 16) >> 5;
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++)
                pred[y * 8 + x] =
                    clip255((a + b * (x - 3) + c * (y - 3) + 16) >> 5);
    }

    // Intra_4x4 prediction (spec 8.3.1.2); mirrors h264dec._pred4x4
    void pred4x4(int yb, int xb, int mode, bool ht, bool hl, bool htr,
                 int64_t* pred) {
        int64_t t[8], left[4];
        int64_t corner = 0;
        if (ht) {
            for (int i = 0; i < 4; i++) t[i] = ry[(yb - 1) * yw + xb + i];
            if (htr)
                for (int i = 0; i < 4; i++)
                    t[4 + i] = ry[(yb - 1) * yw + xb + 4 + i];
            else
                for (int i = 0; i < 4; i++) t[4 + i] = t[3];
        }
        if (hl)
            for (int i = 0; i < 4; i++) left[i] = ry[(yb + i) * yw + xb - 1];
        if (ht && hl) corner = ry[(yb - 1) * yw + xb - 1];

        switch (mode) {
        case 2: {  // DC
            int64_t v;
            if (ht && hl) {
                int64_t s = 0;
                for (int i = 0; i < 4; i++) s += t[i] + left[i];
                v = (s + 4) >> 3;
            } else if (ht) {
                v = (t[0] + t[1] + t[2] + t[3] + 2) >> 2;
            } else if (hl) {
                v = (left[0] + left[1] + left[2] + left[3] + 2) >> 2;
            } else {
                v = 128;
            }
            for (int i = 0; i < 16; i++) pred[i] = v;
            return;
        }
        case 0:  // Vertical
            if (!ht) throw ParseErr{-11, 20};
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) pred[y * 4 + x] = t[x];
            return;
        case 1:  // Horizontal
            if (!hl) throw ParseErr{-11, 21};
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) pred[y * 4 + x] = left[y];
            return;
        case 3:  // Diagonal-Down-Left
            if (!ht) throw ParseErr{-11, 23};
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    if (x == 3 && y == 3)
                        pred[y * 4 + x] = (t[6] + 3 * t[7] + 2) >> 2;
                    else {
                        const int i = x + y;
                        pred[y * 4 + x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2;
                    }
                }
            return;
        case 7:  // Vertical-Left
            if (!ht) throw ParseErr{-11, 27};
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    const int i = x + (y >> 1);
                    if (y % 2 == 0)
                        pred[y * 4 + x] = (t[i] + t[i + 1] + 1) >> 1;
                    else
                        pred[y * 4 + x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2;
                }
            return;
        case 8:  // Horizontal-Up
            if (!hl) throw ParseErr{-11, 28};
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    const int z = x + 2 * y;
                    if (z == 0 || z == 2 || z == 4) {
                        const int i = y + (x >> 1);
                        pred[y * 4 + x] = (left[i] + left[i + 1] + 1) >> 1;
                    } else if (z == 1 || z == 3) {
                        const int i = y + (x >> 1);
                        pred[y * 4 + x] =
                            (left[i] + 2 * left[i + 1] + left[i + 2] + 2) >> 2;
                    } else if (z == 5) {
                        pred[y * 4 + x] = (left[2] + 3 * left[3] + 2) >> 2;
                    } else {
                        pred[y * 4 + x] = left[3];
                    }
                }
            return;
        default:
            break;
        }
        if (!(ht && hl)) throw ParseErr{-11, 30 + mode};
        switch (mode) {
        case 4:  // Diagonal-Down-Right
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    if (x > y) {
                        const int d = x - y;
                        pred[y * 4 + x] =
                            d >= 2 ? (t[d - 2] + 2 * t[d - 1] + t[d] + 2) >> 2
                                   : (corner + 2 * t[0] + t[1] + 2) >> 2;
                    } else if (x < y) {
                        const int d = y - x;
                        pred[y * 4 + x] =
                            d >= 2 ? (left[d - 2] + 2 * left[d - 1] + left[d] + 2) >> 2
                                   : (corner + 2 * left[0] + left[1] + 2) >> 2;
                    } else {
                        pred[y * 4 + x] = (t[0] + 2 * corner + left[0] + 2) >> 2;
                    }
                }
            return;
        case 5:  // Vertical-Right
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    const int z = 2 * x - y;
                    const int i = x - (y >> 1);
                    if (z >= 0 && z % 2 == 0) {
                        const int64_t a = i - 1 < 0 ? corner : t[i - 1];
                        pred[y * 4 + x] = (a + t[i] + 1) >> 1;
                    } else if (z >= 1 && z % 2 == 1) {
                        const int64_t a = i - 2 < 0 ? corner : t[i - 2];
                        const int64_t b = i - 1 < 0 ? corner : t[i - 1];
                        pred[y * 4 + x] = (a + 2 * b + t[i] + 2) >> 2;
                    } else if (z == -1) {
                        pred[y * 4 + x] = (left[0] + 2 * corner + t[0] + 2) >> 2;
                    } else {  // z == -2, -3
                        const int64_t c = y - 3 < 0 ? corner : left[y - 3];
                        pred[y * 4 + x] = (left[y - 1] + 2 * left[y - 2] + c + 2) >> 2;
                    }
                }
            return;
        case 6:  // Horizontal-Down
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    const int z = 2 * y - x;
                    const int i = y - (x >> 1);
                    if (z >= 0 && z % 2 == 0) {
                        const int64_t a = i - 1 < 0 ? corner : left[i - 1];
                        pred[y * 4 + x] = (a + left[i] + 1) >> 1;
                    } else if (z >= 1 && z % 2 == 1) {
                        const int64_t a = i - 2 < 0 ? corner : left[i - 2];
                        const int64_t b = i - 1 < 0 ? corner : left[i - 1];
                        pred[y * 4 + x] = (a + 2 * b + left[i] + 2) >> 2;
                    } else if (z == -1) {
                        pred[y * 4 + x] = (left[0] + 2 * corner + t[0] + 2) >> 2;
                    } else {  // z == -2, -3
                        const int64_t c = x - 3 < 0 ? corner : t[x - 3];
                        pred[y * 4 + x] = (t[x - 1] + 2 * t[x - 2] + c + 2) >> 2;
                    }
                }
            return;
        default:
            throw ParseErr{-11, 40 + mode};
        }
    }

    // top-right availability for 4x4 block (bx, by) of MB (mx, my)
    bool tr_avail(int mx, int my, int bx, int by) {
        const int gx = mx * 4 + bx, gy = my * 4 + by;
        if (gy == 0 || gx + 1 >= mbw * 4) return false;
        const int nx = gx + 1, ny = gy - 1;
        const int nmx = nx / 4, nmy = ny / 4;
        if (nmy < my || (nmy == my && nmx < mx)) return true;
        if (nmy == my && nmx == mx)
            return kZOf[ny % 4][nx % 4] < kZOf[by][bx];
        return false;
    }

    // ---- shared chroma residual + reconstruction --------------------------

    void read_chroma(Bits& r, int mx, int my, int cbp_chroma,
                     int64_t czd[2][4], int64_t cza[2][4][16]) {
        for (int c = 0; c < 2; c++) {
            for (int i = 0; i < 4; i++) czd[c][i] = 0;
            for (int i = 0; i < 4; i++)
                for (int k = 0; k < 16; k++) cza[c][i][k] = 0;
        }
        if (cbp_chroma) {
            for (int comp = 0; comp < 2; comp++) {
                int64_t scan[4] = {0};
                h264::read_block(r, -1, 4, scan, tables);
                for (int i = 0; i < 4; i++) czd[comp][i] = scan[i];
            }
        }
        for (int comp = 0; comp < 2; comp++) {
            NnzGrid& nnz_c = comp == 0 ? nnz_u : nnz_v;
            for (int ty = my * 2; ty < my * 2 + 2; ty++)
                for (int tx = mx * 2; tx < mx * 2 + 2; tx++)
                    nnz_c.at(ty, tx) = 0;
            if (cbp_chroma == 2) {
                for (int i = 0; i < 4; i++) {
                    const int bx = i % 2, by = i / 2;
                    const int nC = h264::nc_of(nnz_c, mx, my, bx, by, 2);
                    int64_t scan[15] = {0};
                    int tot =
                        h264::read_block(r, nC, 15, scan, tables);
                    for (int k = 0; k < 15; k++)
                        cza[comp][i][kZigzag[1 + k]] = scan[k];
                    nnz_c.at(my * 2 + by, mx * 2 + bx) =
                        static_cast<int16_t>(tot);
                }
            }
        }
    }

    void recon_chroma(int mx, int my, int qp, int chroma_mode,
                      int64_t czd[2][4], int64_t cza[2][4][16],
                      const int64_t* cpred_u = nullptr,
                      const int64_t* cpred_v = nullptr) {
        const int cy0 = my * 8, cx0 = mx * 8;
        const bool ht = my > 0, hl = mx > 0;
        for (int comp = 0; comp < 2; comp++) {
            uint8_t* plane = comp == 0 ? ru : rv;
            const int qpc = qpc_of(qp, comp == 0 ? qp_off_u : qp_off_v);
            const int cq6 = qpc / 6, crem = qpc % 6;
            int64_t pred[64];
            const int64_t* cp = comp == 0 ? cpred_u : cpred_v;
            if (cp != nullptr)  // inter MB: MC prediction (8.4.2)
                for (int i = 0; i < 64; i++) pred[i] = cp[i];
            else
                predc(plane, chroma_mode, cy0, cx0, ht, hl, pred);
            // CF2 = H2 CZD H2 on the 2x2 (row-major czd: [0 1; 2 3])
            const int64_t a = czd[comp][0], b = czd[comp][1];
            const int64_t c = czd[comp][2], d = czd[comp][3];
            int64_t cf2[4] = {a + b + c + d, a - b + c - d,
                              a + b - c - d, a - b - c + d};
            int64_t dcc[4];
            for (int i = 0; i < 4; i++)
                dcc[i] = ((cf2[i] * kVA[crem]) << cq6) >> 1;
            for (int i = 0; i < 4; i++) {
                int64_t dq[16], res[16];
                dequant(cza[comp][i], qpc, dq);
                dq[0] = dcc[i];
                idct4x4(dq, res);
                const int sy = 4 * (i / 2), sx = 4 * (i % 2);
                for (int y = 0; y < 4; y++)
                    for (int x = 0; x < 4; x++) {
                        const int64_t o =
                            ((res[y * 4 + x] + 32) >> 6) + pred[(sy + y) * 8 + sx + x];
                        plane[(cy0 + sy + y) * cw + cx0 + sx + x] =
                            static_cast<uint8_t>(clip255(o));
                    }
            }
        }
    }

    // ---- macroblocks -------------------------------------------------------

    void decode_mb_i16(Bits& r, int mx, int my, int64_t mb_type) {
        const int64_t code = mb_type - 1;
        const int pred_mode = static_cast<int>(code % 4);
        const int cbp_chroma = static_cast<int>((code / 4) % 3);
        const int cbp_luma = code >= 12 ? 15 : 0;
        const int64_t chroma_mode = r.ue();
        if (chroma_mode > 3) throw ParseErr{-9, chroma_mode};
        const int64_t delta = r.se();
        const int qp = static_cast<int>(((qp_prev + delta) % 52 + 52) % 52);
        qp_prev = qp;
        qpmap[(size_t)my * mbw + mx] = static_cast<int8_t>(qp);
        for (int ty = my * 4; ty < my * 4 + 4; ty++)
            for (int tx = mx * 4; tx < mx * 4 + 4; tx++) i4mode(ty, tx) = 2;

        // luma DC
        int nC = h264::nc_of(nnz_y, mx, my, 0, 0, 4);
        int64_t zd[16] = {0};
        read_freq_block(r, nC, 16, zd);

        // luma AC
        int64_t za[16][16];
        for (int i = 0; i < 16; i++)
            for (int k = 0; k < 16; k++) za[i][k] = 0;
        if (cbp_luma) {
            for (int i = 0; i < 16; i++) {
                const int bx = kBlkX[i], by = kBlkY[i];
                nC = h264::nc_of(nnz_y, mx, my, bx, by, 4);
                int64_t scan[15] = {0};
                const int tot = h264::read_block(r, nC, 15, scan, tables);
                for (int k = 0; k < 15; k++)
                    za[i][kZigzag[1 + k]] = scan[k];
                nnz_y.at(my * 4 + by, mx * 4 + bx) = static_cast<int16_t>(tot);
            }
        } else {
            for (int ty = my * 4; ty < my * 4 + 4; ty++)
                for (int tx = mx * 4; tx < mx * 4 + 4; tx++)
                    nnz_y.at(ty, tx) = 0;
        }
        int64_t czd[2][4], cza[2][4][16];
        read_chroma(r, mx, my, cbp_chroma, czd, cza);
        recon_i16(mx, my, pred_mode, qp, zd, za,
                  static_cast<int>(chroma_mode), czd, cza);
    }

    // Intra_16x16 reconstruction from frequency-order coefficient arrays
    // (entropy-coder agnostic: shared by the CAVLC parse above and the
    // CABAC tier below; twin of h264dec._recon_i16_mb)
    void recon_i16(int mx, int my, int pred_mode, int qp,
                   const int64_t zd[16], int64_t za[16][16], int chroma_mode,
                   int64_t czd[2][4], int64_t cza[2][4][16]) {
        const int y0 = my * 16, x0 = mx * 16;
        const bool ht = my > 0, hl = mx > 0;
        const int q6 = qp / 6, rem = qp % 6;
        // FD = H4 ZD H4 (H4 symmetric)
        static const int h4[4][4] = {
            {1, 1, 1, 1}, {1, 1, -1, -1}, {1, -1, -1, 1}, {1, -1, 1, -1}};
        int64_t tmp[16], fd[16];
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 4; j++) {
                int64_t s = 0;
                for (int k = 0; k < 4; k++) s += h4[i][k] * zd[k * 4 + j];
                tmp[i * 4 + j] = s;
            }
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 4; j++) {
                int64_t s = 0;
                for (int k = 0; k < 4; k++) s += tmp[i * 4 + k] * h4[k][j];
                fd[i * 4 + j] = s;
            }
        int64_t dcy[16];
        if (qp >= 12) {
            for (int i = 0; i < 16; i++)
                dcy[i] = (fd[i] * kVA[rem]) << (q6 - 2);
        } else {
            const int64_t f = (int64_t)1 << (1 - q6);
            for (int i = 0; i < 16; i++)
                dcy[i] = (fd[i] * kVA[rem] + f) >> (2 - q6);
        }
        int64_t pred[256];
        pred16(pred_mode, y0, x0, ht, hl, pred);
        for (int i = 0; i < 16; i++) {
            const int bx = kBlkX[i], by = kBlkY[i];
            int64_t dq[16], res[16];
            dequant(za[i], qp, dq);
            dq[0] = dcy[by * 4 + bx];
            idct4x4(dq, res);
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    const int64_t o = ((res[y * 4 + x] + 32) >> 6) +
                                      pred[(4 * by + y) * 16 + 4 * bx + x];
                    ry[(y0 + 4 * by + y) * yw + x0 + 4 * bx + x] =
                        static_cast<uint8_t>(clip255(o));
                }
        }
        recon_chroma(mx, my, qp, chroma_mode, czd, cza);
    }

    void decode_mb_i4(Bits& r, int mx, int my) {
        const int gy0 = my * 4, gx0 = mx * 4;
        int modes[16];
        for (int i = 0; i < 16; i++) {
            const int bx = kBlkX[i], by = kBlkY[i];
            const int gx = gx0 + bx, gy = gy0 + by;
            const int ma = gx > 0 ? i4mode(gy, gx - 1) : -1;
            const int mb_ = gy > 0 ? i4mode(gy - 1, gx) : -1;
            const int pm = (ma < 0 || mb_ < 0) ? 2 : (ma < mb_ ? ma : mb_);
            int mode;
            if (r.read(1)) {
                mode = pm;
            } else {
                const int rem = static_cast<int>(r.read(3));
                mode = rem < pm ? rem : rem + 1;
            }
            i4mode(gy, gx) = static_cast<int8_t>(mode);
            modes[i] = mode;
        }
        const int64_t chroma_mode = r.ue();
        if (chroma_mode > 3) throw ParseErr{-9, chroma_mode};
        const int64_t cbp_code = r.ue();
        if (cbp_code >= 48) throw ParseErr{-10, cbp_code};
        const int cbp = kCbpIntra[cbp_code];
        const int cbp_luma = cbp & 15, cbp_chroma = cbp >> 4;
        int qp;
        if (cbp) {
            qp = static_cast<int>(((qp_prev + r.se()) % 52 + 52) % 52);
            qp_prev = qp;
        } else {
            qp = qp_prev;
        }
        qpmap[(size_t)my * mbw + mx] = static_cast<int8_t>(qp);

        // residual: 16 luma blocks (full 16-coeff), then chroma
        for (int ty = gy0; ty < gy0 + 4; ty++)
            for (int tx = gx0; tx < gx0 + 4; tx++) nnz_y.at(ty, tx) = 0;
        int64_t z[16][16];
        for (int i = 0; i < 16; i++)
            for (int k = 0; k < 16; k++) z[i][k] = 0;
        for (int i = 0; i < 16; i++) {
            if (!((cbp_luma >> (i >> 2)) & 1)) continue;
            const int bx = kBlkX[i], by = kBlkY[i];
            const int nC = h264::nc_of(nnz_y, mx, my, bx, by, 4);
            int64_t scan[16] = {0};
            const int tot = h264::read_block(r, nC, 16, scan, tables);
            for (int k = 0; k < 16; k++) z[i][kZigzag[k]] = scan[k];
            nnz_y.at(gy0 + by, gx0 + bx) = static_cast<int16_t>(tot);
        }
        int64_t czd[2][4], cza[2][4][16];
        read_chroma(r, mx, my, cbp_chroma, czd, cza);
        recon_i4(mx, my, modes, qp, z, static_cast<int>(chroma_mode), czd,
                 cza);
    }

    // I_4x4 reconstruction: Z-order, each block predicts from live recon
    // (entropy-coder agnostic; twin of h264dec._recon_i4_mb)
    void recon_i4(int mx, int my, const int modes[16], int qp,
                  int64_t z[16][16], int chroma_mode, int64_t czd[2][4],
                  int64_t cza[2][4][16]) {
        const int gy0 = my * 4, gx0 = mx * 4;
        for (int i = 0; i < 16; i++) {
            const int bx = kBlkX[i], by = kBlkY[i];
            const int yb = my * 16 + 4 * by, xb = mx * 16 + 4 * bx;
            int64_t dq[16], res[16], pred[16];
            dequant(z[i], qp, dq);
            idct4x4(dq, res);
            pred4x4(yb, xb, modes[i], (gy0 + by) > 0, (gx0 + bx) > 0,
                    tr_avail(mx, my, bx, by), pred);
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++) {
                    const int64_t o =
                        ((res[y * 4 + x] + 32) >> 6) + pred[y * 4 + x];
                    ry[(yb + y) * yw + xb + x] =
                        static_cast<uint8_t>(clip255(o));
                }
        }
        recon_chroma(mx, my, qp, chroma_mode, czd, cza);
    }

    void decode_mb_ipcm(Bits& r, int mx, int my, const uint8_t* data,
                        int64_t n_bytes) {
        r.pos = (r.pos + 7) & ~static_cast<int64_t>(7);
        int64_t at = r.pos >> 3;
        if (at + 384 > n_bytes) throw ParseErr{-3, 0};
        const uint8_t* p = data + at;
        const int y0 = my * 16, x0 = mx * 16;
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++)
                ry[(y0 + y) * yw + x0 + x] = *p++;
        const int cy0 = my * 8, cx0 = mx * 8;
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) ru[(cy0 + y) * cw + cx0 + x] = *p++;
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) rv[(cy0 + y) * cw + cx0 + x] = *p++;
        r.pos += 384 * 8;
        for (int ty = my * 4; ty < my * 4 + 4; ty++)
            for (int tx = mx * 4; tx < mx * 4 + 4; tx++) {
                nnz_y.at(ty, tx) = 16;
                i4mode(ty, tx) = 2;
            }
        for (int ty = my * 2; ty < my * 2 + 2; ty++)
            for (int tx = mx * 2; tx < mx * 2 + 2; tx++) {
                nnz_u.at(ty, tx) = 16;
                nnz_v.at(ty, tx) = 16;
            }
        // deblocking qPp of I_PCM is 0; the qp chain is NOT reset
        qpmap[(size_t)my * mbw + mx] = 0;
    }

    // ---- deblocking (spec 8.7; mirrors h264dec._deblock/_edge_filter) -----

    void edge_filter(uint8_t* plane, int stride, int y0, int x0, int n,
                     bool vertical, int bS, int idx_a, int idx_b,
                     bool chroma) {
        const int alpha = kAlpha[idx_a];
        const int beta = kBeta[idx_b];
        if (alpha == 0) return;
        for (int i = 0; i < n; i++) {
            uint8_t* base = vertical ? plane + (y0 + i) * stride + x0
                                     : plane + y0 * stride + x0 + i;
            const int step = vertical ? 1 : stride;
            auto G = [&](int k) -> int { return base[k * step]; };
            auto S = [&](int k, int v) { base[k * step] = (uint8_t)v; };
            const int p0 = G(-1), p1 = G(-2), q0 = G(0), q1 = G(1);
            const bool fm = (p0 - q0 < alpha && q0 - p0 < alpha) &&
                            (p1 - p0 < beta && p0 - p1 < beta) &&
                            (q1 - q0 < beta && q0 - q1 < beta);
            if (!fm) continue;
            if (bS == 4) {  // strong filter (8.7.2.4)
                if (chroma) {
                    S(-1, (2 * p1 + p0 + q1 + 2) >> 2);
                    S(0, (2 * q1 + q0 + p1 + 2) >> 2);
                    continue;
                }
                const int p2 = G(-3), q2 = G(2), p3 = G(-4), q3 = G(3);
                const bool ap = (p2 - p0 < beta && p0 - p2 < beta);
                const bool aq = (q2 - q0 < beta && q0 - q2 < beta);
                const bool small =
                    (p0 - q0 < (alpha >> 2) + 2 && q0 - p0 < (alpha >> 2) + 2);
                if (small && ap) {
                    S(-1, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
                    S(-2, (p2 + p1 + p0 + q0 + 2) >> 2);
                    S(-3, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
                } else {
                    S(-1, (2 * p1 + p0 + q1 + 2) >> 2);
                }
                if (small && aq) {
                    S(0, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3);
                    S(1, (q2 + q1 + q0 + p0 + 2) >> 2);
                    S(2, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
                } else {
                    S(0, (2 * q1 + q0 + p1 + 2) >> 2);
                }
                continue;
            }
            // normal filter (8.7.2.3)
            const int tc0 = kTc0[idx_a][bS - 1];
            if (chroma) {
                const int tc = tc0 + 1;
                const int delta = (int)clip3(
                    -tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
                S(-1, clip255(p0 + delta));
                S(0, clip255(q0 - delta));
                continue;
            }
            const int p2 = G(-3), q2 = G(2);
            const bool ap = (p2 - p0 < beta && p0 - p2 < beta);
            const bool aq = (q2 - q0 < beta && q0 - q2 < beta);
            const int tc = tc0 + (ap ? 1 : 0) + (aq ? 1 : 0);
            const int delta = (int)clip3(
                -tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
            S(-1, clip255(p0 + delta));
            S(0, clip255(q0 - delta));
            if (ap) {
                const int dp1 = (int)clip3(
                    -tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1);
                S(-2, p1 + dp1);
            }
            if (aq) {
                const int dq1 = (int)clip3(
                    -tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1);
                S(1, q1 + dq1);
            }
        }
    }

    void deblock(int off_a, int off_b) {
        for (int my = 0; my < mbh; my++)
            for (int mx = 0; mx < mbw; mx++) {
                const int qq = qpmap[(size_t)my * mbw + mx];
                const int y0 = my * 16, x0 = mx * 16;
                const int cy0 = my * 8, cx0 = mx * 8;
                for (int vi = 1; vi >= 0; vi--) {
                    const bool vertical = vi == 1;
                    for (int xr = 0; xr <= 12; xr += 4) {
                        int bs, qp_p;
                        if (xr == 0) {
                            if ((vertical ? mx : my) == 0) continue;
                            bs = 4;
                            qp_p = vertical ? qpmap[(size_t)my * mbw + mx - 1]
                                            : qpmap[(size_t)(my - 1) * mbw + mx];
                        } else {
                            bs = 3;
                            qp_p = qq;
                        }
                        const int qav = (qp_p + qq + 1) >> 1;
                        const int ia = (int)clip3(0, 51, qav + off_a);
                        const int ib = (int)clip3(0, 51, qav + off_b);
                        if (vertical)
                            edge_filter(ry, yw, y0, x0 + xr, 16, true, bs, ia,
                                        ib, false);
                        else
                            edge_filter(ry, yw, y0 + xr, x0, 16, false, bs,
                                        ia, ib, false);
                        if (xr == 0 || xr == 8) {
                            for (int comp = 0; comp < 2; comp++) {
                                uint8_t* plane = comp == 0 ? ru : rv;
                                const int off =
                                    comp == 0 ? qp_off_u : qp_off_v;
                                const int cq = (qpc_of(qp_p, off) +
                                                qpc_of(qq, off) + 1) >> 1;
                                const int cia = (int)clip3(0, 51, cq + off_a);
                                const int cib = (int)clip3(0, 51, cq + off_b);
                                if (vertical)
                                    edge_filter(plane, cw, cy0, cx0 + xr / 2,
                                                8, true, bs, cia, cib, true);
                                else
                                    edge_filter(plane, cw, cy0 + xr / 2, cx0,
                                                8, false, bs, cia, cib, true);
                            }
                        }
                    }
                }
            }
    }
};

}  // namespace h264full

// ---------------------------------------------------------------------------
// H.264 CABAC intra entropy decoder — native twin of av/h264cabac.py.
//
// Replaces ONLY the entropy layer (context-modelled binary arithmetic
// coding, spec 9.3) and feeds the SAME reconstruction methods as the CAVLC
// tier above (h264full::Dec::recon_i16/recon_i4/decode_mb_ipcm), so recon
// correctness is shared with the CAVLC differential suite.  Normative
// tables (context init I column, rangeTabLPS, transIdx) are passed in from
// Python (packed by av/h264cabac.py) so cabac_tables.py stays the single
// source of truth.  Bit-exact vs libavcodec AND the Python tier on real
// x264 CABAC streams (tests/test_h264dec_cabac.py).
// ---------------------------------------------------------------------------

namespace h264cabac {

using h264::Bits;
using h264::ParseErr;
using h264full::Dec;

// significant/last + coeff_abs_level ctx offsets per ctxBlockCat (frame)
constexpr int kSigOff[5] = {0, 15, 29, 44, 47};
constexpr int kLevOff[5] = {0, 10, 20, 30, 39};

// table blob layout (av/h264cabac.py _TABLES_PACKED):
//   [0:2048)      INIT_I (m, n) int8 pairs, ctxIdx 0..1023
//   [2048:8192)   INIT_PB[3] — cabac_init_idc 0..2 columns
//   [8192:8448)   LPS_RANGE[64][4]
//   [8448:8512)   TRANS_LPS[64]
//   [8512:8576)   TRANS_MPS[64]
constexpr int64_t kCabacBlobSize = 8576;

// Binary arithmetic decoding engine (spec 9.3.3.2); bits are consumed one
// at a time so Bits::pos is the precise arithmetic consumption point
// (which the I_PCM byte realignment relies on).
struct Engine {
    const uint8_t* lps;   // rangeTabLPS[64][4]
    const uint8_t* tlps;  // transIdxLPS[64]
    const uint8_t* tmps;  // transIdxMPS[64]
    uint8_t state[1024];
    uint8_t mps[1024];
    Bits* r = nullptr;
    int64_t range = 0, offset = 0;

    // table: 0 = I column, 1..3 = cabac_init_idc 0..2 of the P/B columns
    Engine(const uint8_t* blob, int qp, int table = 0)
        : lps(blob + 8192), tlps(blob + 8448), tmps(blob + 8512) {
        // context variable init (spec 9.3.1.1) — once per slice; a
        // reinit() after I_PCM restarts only the arithmetic part
        const int8_t* init =
            reinterpret_cast<const int8_t*>(blob + 2048 * table);
        qp = qp < 0 ? 0 : qp > 51 ? 51 : qp;
        for (int i = 0; i < 1024; i++) {
            int pre = ((init[2 * i] * qp) >> 4) + init[2 * i + 1];
            pre = pre < 1 ? 1 : pre > 126 ? 126 : pre;
            if (pre <= 63) {
                state[i] = static_cast<uint8_t>(63 - pre);
                mps[i] = 0;
            } else {
                state[i] = static_cast<uint8_t>(pre - 64);
                mps[i] = 1;
            }
        }
    }

    void reinit(Bits& rd) {  // spec 9.3.1.2
        r = &rd;
        range = 510;
        offset = rd.read(9);
        if (offset >= 510) throw ParseErr{-20, offset};
    }

    inline int decision(int ctx) {
        const int s = state[ctx];
        const int64_t l = lps[s * 4 + ((range >> 6) & 3)];
        range -= l;
        int bit;
        if (offset >= range) {
            bit = 1 - mps[ctx];
            offset -= range;
            range = l;
            if (s == 0) mps[ctx] = 1 - mps[ctx];
            state[ctx] = tlps[s];
        } else {
            bit = mps[ctx];
            state[ctx] = tmps[s];
        }
        while (range < 256) {
            range <<= 1;
            offset = (offset << 1) | r->read(1);
        }
        return bit;
    }

    inline int bypass() {
        offset = (offset << 1) | r->read(1);
        if (offset >= range) {
            offset -= range;
            return 1;
        }
        return 0;
    }

    inline int terminate() {
        range -= 2;
        if (offset >= range) return 1;
        while (range < 256) {
            range <<= 1;
            offset = (offset << 1) | r->read(1);
        }
        return 0;
    }
};

// I-slice CABAC syntax decode (spec 9.3.2/9.3.3.1) over the shared recon.
struct CDec {
    Dec& d;
    Engine eng;
    int mbw, mbh;
    // neighbor state for context derivation (9.3.3.1.1)
    std::vector<uint8_t> inxn, is16, pcm, cmode;  // [mbh*mbw]
    std::vector<int> cbp;                         // luma | chroma << 4
    std::vector<uint8_t> fldc;                    // cbf luma DC (I16)
    std::vector<uint8_t> fl;                      // cbf luma 4x4 [4h][4w]
    std::vector<uint8_t> fcdc;                    // cbf chroma DC [2][h][w]
    std::vector<uint8_t> fc;                      // cbf chroma AC [2][2h][2w]
    std::vector<uint8_t> skip;                    // mb_skip_flag [h][w]
    std::vector<int32_t> absmvd;                  // |mvd| [4h*4w][2][2]
    std::vector<uint8_t> b_direct;                // B_Skip/B_Direct_16x16
    bool prev_qp_nz = false;

    CDec(Dec& dd, const uint8_t* blob, int qp, int table = 0)
        : d(dd), eng(blob, qp, table), mbw(dd.mbw), mbh(dd.mbh),
          inxn((size_t)mbw * mbh, 0), is16((size_t)mbw * mbh, 0),
          pcm((size_t)mbw * mbh, 0), cmode((size_t)mbw * mbh, 0),
          cbp((size_t)mbw * mbh, 0), fldc((size_t)mbw * mbh, 0),
          fl((size_t)mbw * 4 * mbh * 4, 0),
          fcdc(2 * (size_t)mbw * mbh, 0),
          fc(2 * (size_t)mbw * 2 * mbh * 2, 0),
          skip((size_t)mbw * mbh, 0),
          absmvd(4 * (size_t)mbw * 4 * mbh * 4, 0),
          b_direct((size_t)mbw * mbh, 0) {}

    inline size_t mi(int my, int mx) const { return (size_t)my * mbw + mx; }

    // ---- coded_block_flag ctxIdxInc (9.3.3.1.1.9) -------------------------
    // unavailable neighbor counts 1 only when the CURRENT MB is intra

    int cbf_inc_luma_dc(int mx, int my) const {
        auto cond = [&](int nx, int ny) -> int {
            if (nx < 0 || ny < 0) return 1;  // unavailable, current intra
            if (pcm[mi(ny, nx)]) return 1;
            if (!is16[mi(ny, nx)]) return 0;  // no luma DC block in mbAddrN
            return fldc[mi(ny, nx)];
        };
        return cond(mx - 1, my) + 2 * cond(mx, my - 1);
    }

    int cbf_inc_luma4(int gx, int gy, bool cur_intra = true) const {
        auto cond = [&](int nx, int ny) -> int {
            if (nx < 0 || ny < 0) return cur_intra ? 1 : 0;
            if (pcm[mi(ny >> 2, nx >> 2)]) return 1;
            return fl[(size_t)ny * mbw * 4 + nx];
        };
        return cond(gx - 1, gy) + 2 * cond(gx, gy - 1);
    }

    int cbf_inc_chroma_dc(int mx, int my, int comp,
                          bool cur_intra = true) const {
        auto cond = [&](int nx, int ny) -> int {
            if (nx < 0 || ny < 0) return cur_intra ? 1 : 0;
            if (pcm[mi(ny, nx)]) return 1;
            return fcdc[(size_t)comp * mbw * mbh + mi(ny, nx)];
        };
        return cond(mx - 1, my) + 2 * cond(mx, my - 1);
    }

    int cbf_inc_chroma_ac(int gx, int gy, int comp,
                          bool cur_intra = true) const {
        auto cond = [&](int nx, int ny) -> int {
            if (nx < 0 || ny < 0) return cur_intra ? 1 : 0;
            if (pcm[mi(ny >> 1, nx >> 1)]) return 1;
            return fc[((size_t)comp * mbh * 2 + ny) * mbw * 2 + nx];
        };
        return cond(gx - 1, gy) + 2 * cond(gx, gy - 1);
    }

    // ---- residual block (9.3.2.3 / 9.3.3.1.3) ------------------------------

    // One transform block: coded_block_flag, significance map, then
    // levels+signs in reverse scan order.  Fills coeffs[] (scan order,
    // caller-zeroed) and returns 1, or returns 0 when cbf == 0.
    int residual(int cat, int inc, int n_coeff, int64_t* coeffs) {
        if (!eng.decision(85 + 4 * cat + inc)) return 0;
        const int sig = 105 + kSigOff[cat], last = 166 + kSigOff[cat];
        bool s[16] = {false};
        bool found = false;
        for (int i = 0; i < n_coeff - 1; i++) {
            if (eng.decision(sig + i)) {
                s[i] = true;
                if (eng.decision(last + i)) {
                    found = true;
                    break;
                }
            }
        }
        if (!found) s[n_coeff - 1] = true;
        const int lev = 227 + kLevOff[cat];
        int neq1 = 0, ngt1 = 0;
        for (int pos = n_coeff - 1; pos >= 0; pos--) {
            if (!s[pos]) continue;
            const int c0 = ngt1 ? 0 : (neq1 >= 4 ? 4 : neq1 + 1);
            int64_t level;
            if (!eng.decision(lev + c0)) {
                level = 1;
            } else {
                const int cr = lev + 5 + (ngt1 > 4 ? 4 : ngt1);
                int k = 1;
                while (k < 14 && eng.decision(cr)) k++;
                if (k < 14) {
                    level = k + 1;
                } else {
                    int e = 0;  // UEG0 suffix (bypass)
                    while (eng.bypass())
                        if (++e > 30) throw ParseErr{-21, 0};
                    int64_t val = 0;
                    for (int j = 0; j < e; j++)
                        val = (val << 1) | eng.bypass();
                    level = 15 + ((int64_t)1 << e) - 1 + val;
                }
            }
            if (level == 1) neq1++; else ngt1++;
            coeffs[pos] = eng.bypass() ? -level : level;
        }
        return 1;
    }

    // ---- syntax elements ----------------------------------------------------

    int read_chroma_mode(int mx, int my) {
        const bool ca = mx > 0 && !pcm[mi(my, mx - 1)] && cmode[mi(my, mx - 1)];
        const bool cb = my > 0 && !pcm[mi(my - 1, mx)] && cmode[mi(my - 1, mx)];
        int mode = 0;
        if (eng.decision(64 + ca + cb)) {
            mode = 1;
            while (mode < 3 && eng.decision(67)) mode++;
        }
        cmode[mi(my, mx)] = static_cast<uint8_t>(mode);
        return mode;
    }

    int read_qp_delta(int mx, int my) {
        int k = 0;
        if (eng.decision(60 + (prev_qp_nz ? 1 : 0))) {
            k = 1;
            if (eng.decision(62)) {
                k = 2;
                while (k < 88 && eng.decision(63)) k++;
                if (k >= 88) throw ParseErr{-24, 0};
            }
        }
        const int delta = (k & 1) ? (k + 1) / 2 : -(k / 2);
        prev_qp_nz = delta != 0;
        const int qp = ((d.qp_prev + delta) % 52 + 52) % 52;
        d.qp_prev = qp;
        d.qpmap[mi(my, mx)] = static_cast<int8_t>(qp);
        return qp;
    }

    // coded_block_pattern: FL(15) luma prefix + TU(2) chroma suffix
    // (9.3.2.6, ctx 9.3.3.1.1.4)
    void read_cbp(int mx, int my, int* out_luma, int* out_chroma) {
        int luma = 0;
        for (int b = 0; b < 4; b++) {
            bool ca, cb;
            if (b & 1) {
                ca = ((luma >> (b - 1)) & 1) == 0;
            } else if (mx > 0) {
                ca = !pcm[mi(my, mx - 1)] &&
                     ((cbp[mi(my, mx - 1)] >> (b + 1)) & 1) == 0;
            } else {
                ca = false;
            }
            if (b & 2) {
                cb = ((luma >> (b - 2)) & 1) == 0;
            } else if (my > 0) {
                cb = !pcm[mi(my - 1, mx)] &&
                     ((cbp[mi(my - 1, mx)] >> (b + 2)) & 1) == 0;
            } else {
                cb = false;
            }
            if (eng.decision(73 + ca + 2 * cb)) luma |= 1 << b;
        }
        int chroma = 0;
        bool ca = mx > 0 && (pcm[mi(my, mx - 1)] ||
                             (cbp[mi(my, mx - 1)] >> 4) != 0);
        bool cb = my > 0 && (pcm[mi(my - 1, mx)] ||
                             (cbp[mi(my - 1, mx)] >> 4) != 0);
        if (eng.decision(77 + ca + 2 * cb)) {
            ca = mx > 0 && (pcm[mi(my, mx - 1)] ||
                            (cbp[mi(my, mx - 1)] >> 4) == 2);
            cb = my > 0 && (pcm[mi(my - 1, mx)] ||
                            (cbp[mi(my - 1, mx)] >> 4) == 2);
            chroma = eng.decision(81 + ca + 2 * cb) ? 2 : 1;
        }
        *out_luma = luma;
        *out_chroma = chroma;
    }

    void read_chroma_cabac(int mx, int my, int cbp_chroma,
                           int64_t czd[2][4], int64_t cza[2][4][16],
                           bool cur_intra = true) {
        for (int c = 0; c < 2; c++) {
            for (int i = 0; i < 4; i++) czd[c][i] = 0;
            for (int i = 0; i < 4; i++)
                for (int k = 0; k < 16; k++) cza[c][i][k] = 0;
        }
        if (cbp_chroma) {
            for (int comp = 0; comp < 2; comp++) {
                int64_t dc[4] = {0};
                if (residual(3, cbf_inc_chroma_dc(mx, my, comp, cur_intra),
                             4, dc)) {
                    fcdc[(size_t)comp * mbw * mbh + mi(my, mx)] = 1;
                    for (int i = 0; i < 4; i++) czd[comp][i] = dc[i];
                }
            }
        }
        if (cbp_chroma == 2) {
            for (int comp = 0; comp < 2; comp++) {
                for (int i = 0; i < 4; i++) {
                    const int gx = mx * 2 + i % 2, gy = my * 2 + i / 2;
                    int64_t scan[15] = {0};
                    if (!residual(4,
                                  cbf_inc_chroma_ac(gx, gy, comp, cur_intra),
                                  15, scan))
                        continue;
                    fc[((size_t)comp * mbh * 2 + gy) * mbw * 2 + gx] = 1;
                    for (int k = 0; k < 15; k++)
                        cza[comp][i][h264enc::kZigzag[1 + k]] = scan[k];
                }
            }
        }
    }

    // ---- macroblock layer ---------------------------------------------------

    void decode_mb(Bits& r, int mx, int my) {
        // mb_type (I slices): ctxIdxOffset 3, binarization 9.3.2.5
        const bool ca = mx > 0 && !inxn[mi(my, mx - 1)];
        const bool cb = my > 0 && !inxn[mi(my - 1, mx)];
        if (eng.decision(3 + ca + cb) == 0) {
            mb_i4(mx, my);
            return;
        }
        if (eng.terminate()) {  // binIdx 1: I_PCM
            mb_pcm(r, mx, my);
            return;
        }
        const int cbp_luma = eng.decision(6) ? 15 : 0;
        int cbp_chroma = 0;
        if (eng.decision(7)) cbp_chroma = eng.decision(8) ? 2 : 1;
        const int pred_mode = (eng.decision(9) << 1) | eng.decision(10);
        finish_i16(mx, my, cbp_luma, cbp_chroma, pred_mode);
    }

    void finish_i16(int mx, int my, int cbp_luma, int cbp_chroma,
                    int pred_mode) {
        const int chroma_mode = read_chroma_mode(mx, my);
        const int qp = read_qp_delta(mx, my);
        is16[mi(my, mx)] = 1;
        cbp[mi(my, mx)] = cbp_luma | (cbp_chroma << 4);
        for (int ty = my * 4; ty < my * 4 + 4; ty++)
            for (int tx = mx * 4; tx < mx * 4 + 4; tx++)
                d.i4mode(ty, tx) = 2;

        // luma DC (cat 0) — always parsed for Intra_16x16
        int64_t dc_scan[16] = {0};
        int64_t zd[16] = {0};
        if (residual(0, cbf_inc_luma_dc(mx, my), 16, dc_scan)) {
            fldc[mi(my, mx)] = 1;
            for (int i = 0; i < 16; i++)
                zd[h264enc::kZigzag[i]] = dc_scan[i];
        }

        int64_t za[16][16];
        for (int i = 0; i < 16; i++)
            for (int k = 0; k < 16; k++) za[i][k] = 0;
        if (cbp_luma) {
            for (int i = 0; i < 16; i++) {
                const int bx = h264::kBlkX[i], by = h264::kBlkY[i];
                const int gx = mx * 4 + bx, gy = my * 4 + by;
                int64_t scan[15] = {0};
                if (!residual(1, cbf_inc_luma4(gx, gy), 15, scan)) continue;
                fl[(size_t)gy * mbw * 4 + gx] = 1;
                for (int k = 0; k < 15; k++)
                    za[i][h264enc::kZigzag[1 + k]] = scan[k];
            }
        }
        int64_t czd[2][4], cza[2][4][16];
        read_chroma_cabac(mx, my, cbp_chroma, czd, cza);
        d.recon_i16(mx, my, pred_mode, qp, zd, za, chroma_mode, czd, cza);
    }

    // ---- P macroblock layer (spec 7.3.5, 9.3.3.1) -------------------------

    int read_skip_flag(int mx, int my, int base = 11) {
        const bool ca = mx > 0 && !skip[mi(my, mx - 1)];
        const bool cb = my > 0 && !skip[mi(my - 1, mx)];
        return eng.decision(base + ca + cb);
    }

    // ref_idx_l0: unary ctx 54-59; cells of earlier same-MB partitions
    // are visible through Dec::rknown before their MVs decode
    int read_ref_idx(int gx, int gy, int lx = 0) {
        if (d.num_ref_active[lx] == 1) return 0;
        auto nref = [&](int cx, int cy) -> int {
            if (cx < 0 || cy < 0 || cx >= mbw * 4 || cy >= mbh * 4)
                return -2;
            if (d.direct4[d.c4(cy, cx)]) return 0;  // 9.3.3.1.1.6
            if (d.rknown[d.c4(cy, cx) * 2 + lx] || d.dec4[d.c4(cy, cx)])
                return d.ridx[d.c4(cy, cx) * 2 + lx];
            return -2;
        };
        const int inc = (nref(gx - 1, gy) > 0) + 2 * (nref(gx, gy - 1) > 0);
        int idx = 0;
        if (eng.decision(54 + inc)) {
            idx = 1;
            while (idx < 32 && eng.decision(idx == 1 ? 58 : 59)) idx++;
            if (idx >= 32) throw ParseErr{-34, 0};
        }
        if (idx >= d.num_ref_active[lx] || d.ref_slot_l[lx][idx] < 0)
            throw ParseErr{-32, idx};
        return idx;
    }

    void note_ref(int gx, int gy, int w4, int h4, int ref, int lx = 0) {
        for (int ty = gy; ty < gy + h4; ty++)
            for (int tx = gx; tx < gx + w4; tx++) {
                d.ridx[d.c4(ty, tx) * 2 + lx] = (int8_t)ref;
                d.rknown[d.c4(ty, tx) * 2 + lx] = 1;
            }
    }

    // mvd_l0: UEG3 — TU prefix ctx-coded to 9, EG3 bypass suffix + sign
    int read_mvd(int gx, int gy, int comp, int lx = 0) {
        const int base = comp == 0 ? 40 : 47;
        auto amvd = [&](int cx, int cy) -> int {
            if (cx < 0 || cy < 0 || cx >= mbw * 4 || cy >= mbh * 4 ||
                !d.dec4[d.c4(cy, cx)])
                return 0;
            return absmvd[(d.c4(cy, cx) * 2 + lx) * 2 + comp];
        };
        const int e = amvd(gx - 1, gy) + amvd(gx, gy - 1);
        const int inc = e < 3 ? 0 : (e > 32 ? 2 : 1);
        if (!eng.decision(base + inc)) return 0;
        int64_t val = 1;
        int ctx = 3;
        while (val < 9 && eng.decision(base + ctx)) {
            if (ctx < 6) ctx++;
            val++;
        }
        if (val >= 9) {  // EG3 escape suffix in bypass
            int k = 3;
            while (eng.bypass()) {
                val += (int64_t)1 << k;
                k++;
                if (k > 24) throw ParseErr{-35, 0};
            }
            while (k) {
                k--;
                val += (int64_t)eng.bypass() << k;
            }
        }
        return eng.bypass() ? (int)-val : (int)val;
    }

    void note_absmvd(int gx, int gy, int w4, int h4, int dx, int dy,
                     int lx = 0) {
        for (int ty = gy; ty < gy + h4; ty++)
            for (int tx = gx; tx < gx + w4; tx++) {
                absmvd[(d.c4(ty, tx) * 2 + lx) * 2] = dx < 0 ? -dx : dx;
                absmvd[(d.c4(ty, tx) * 2 + lx) * 2 + 1] = dy < 0 ? -dy : dy;
            }
    }

    // intra mb_type suffix inside a P (base 17) or B (base 32) slice
    void intra_in_inter(Bits& r, int mx, int my, int base) {
        for (int ty = my * 4; ty < my * 4 + 4; ty++)
            for (int tx = mx * 4; tx < mx * 4 + 4; tx++)
                d.dec4[d.c4(ty, tx)] = 1;
        if (eng.decision(base) == 0) {
            mb_i4(mx, my);
            return;
        }
        if (eng.terminate()) {
            mb_pcm(r, mx, my);
            return;
        }
        const int cbp_luma = eng.decision(base + 1) ? 15 : 0;
        int cbp_chroma = 0;
        if (eng.decision(base + 2))
            cbp_chroma = eng.decision(base + 2) ? 2 : 1;
        const int pred_mode =
            (eng.decision(base + 3) << 1) | eng.decision(base + 3);
        finish_i16(mx, my, cbp_luma, cbp_chroma, pred_mode);
    }

    void decode_mb_p(Bits& r, int mx, int my) {
        using Part = Dec::Part;
        // mb_type, P prefix (ctx 14-17, binarization 9.3.2.5)
        if (eng.decision(14)) {
            intra_in_inter(r, mx, my, 17);
            return;
        }
        int64_t mb_type;
        if (eng.decision(15) == 0)
            mb_type = 3 * eng.decision(16);  // P_L0_16x16 / P_8x8
        else
            mb_type = 2 - eng.decision(17);  // P_L0_L0_8x16 / _16x8
        d.mark_inter(mx, my);
        Part parts[16];
        int np = 0;
        if (mb_type <= 2) {
            const int n = h264full::kPPartN[mb_type];
            int refs[2];
            for (int p = 0; p < n; p++) {
                const int* sh = h264full::kPParts[mb_type][p];
                const int gx = mx * 4 + sh[0] / 4, gy = my * 4 + sh[1] / 4;
                refs[p] = read_ref_idx(gx, gy);
                note_ref(gx, gy, sh[2] / 4, sh[3] / 4, refs[p]);
            }
            for (int p = 0; p < n; p++) {
                const int* sh = h264full::kPParts[mb_type][p];
                const int gx = mx * 4 + sh[0] / 4, gy = my * 4 + sh[1] / 4;
                const int dx = read_mvd(gx, gy, 0);
                const int dy = read_mvd(gx, gy, 1);
                int hint = h264full::kHintNone;
                if (mb_type == 1)
                    hint = p == 0 ? h264full::kHint16x8Top
                                  : h264full::kHint16x8Bot;
                if (mb_type == 2)
                    hint = p == 0 ? h264full::kHint8x16Left
                                  : h264full::kHint8x16Right;
                int px_x, px_y;
                d.mvp(gx, gy, sh[2] / 4, sh[3] / 4, refs[p], hint,
                      &px_x, &px_y);
                const int vx = px_x + dx, vy = px_y + dy;
                d.set_part(mx, my, sh[0], sh[1], sh[2], sh[3], refs[p], vx,
                           vy);
                note_absmvd(gx, gy, sh[2] / 4, sh[3] / 4, dx, dy);
                parts[np++] =
                    Dec::part1(sh[0], sh[1], sh[2], sh[3], refs[p], vx, vy);
            }
        } else {  // P_8x8 (CABAC has no P_8x8ref0, Table 9-34)
            int subs[4], refs[4];
            for (int b = 0; b < 4; b++) {
                // sub_mb_type binarization (Table 9-38, ctx 21-23)
                if (eng.decision(21)) subs[b] = 0;          // 8x8
                else if (!eng.decision(22)) subs[b] = 1;    // 8x4
                else if (eng.decision(23)) subs[b] = 2;     // 4x8
                else subs[b] = 3;                           // 4x4
            }
            for (int b = 0; b < 4; b++) {
                const int bx0 = (b % 2) * 8, by0 = (b / 2) * 8;
                const int gx = mx * 4 + bx0 / 4, gy = my * 4 + by0 / 4;
                refs[b] = read_ref_idx(gx, gy);
                note_ref(gx, gy, 2, 2, refs[b]);
            }
            for (int b = 0; b < 4; b++) {
                const int bx0 = (b % 2) * 8, by0 = (b / 2) * 8;
                for (int s = 0; s < h264full::kPSubN[subs[b]]; s++) {
                    const int* sh = h264full::kPSub[subs[b]][s];
                    const int px = bx0 + sh[0], py = by0 + sh[1];
                    const int gx = mx * 4 + px / 4, gy = my * 4 + py / 4;
                    const int dx = read_mvd(gx, gy, 0);
                    const int dy = read_mvd(gx, gy, 1);
                    int px_x, px_y;
                    d.mvp(gx, gy, sh[2] / 4, sh[3] / 4, refs[b],
                          h264full::kHintNone, &px_x, &px_y);
                    const int vx = px_x + dx, vy = px_y + dy;
                    d.set_part(mx, my, px, py, sh[2], sh[3], refs[b], vx,
                               vy);
                    note_absmvd(gx, gy, sh[2] / 4, sh[3] / 4, dx, dy);
                    parts[np++] =
                        Dec::part1(px, py, sh[2], sh[3], refs[b], vx, vy);
                }
            }
        }
        int64_t pred_y[256], pred_u[64], pred_v[64];
        d.inter_pred_mb(mx, my, parts, np, pred_y, pred_u, pred_v);
        finish_inter(mx, my, pred_y, pred_u, pred_v);
    }

    // shared CABAC inter residual + recon tail (P and B)
    void finish_inter(int mx, int my, const int64_t* pred_y,
                      const int64_t* pred_u, const int64_t* pred_v) {
        int cbp_luma, cbp_chroma;
        read_cbp(mx, my, &cbp_luma, &cbp_chroma);
        cbp[mi(my, mx)] = cbp_luma | (cbp_chroma << 4);
        int qp;
        if (cbp_luma || cbp_chroma) {
            qp = read_qp_delta(mx, my);
        } else {
            qp = d.qp_prev;
            d.qpmap[mi(my, mx)] = (int8_t)qp;
            prev_qp_nz = false;
        }

        const int gy0 = my * 4, gx0 = mx * 4;
        for (int ty = gy0; ty < gy0 + 4; ty++)
            for (int tx = gx0; tx < gx0 + 4; tx++) d.nnz_y.at(ty, tx) = 0;
        int64_t z[16][16];
        for (int i = 0; i < 16; i++)
            for (int k = 0; k < 16; k++) z[i][k] = 0;
        for (int i = 0; i < 16; i++) {
            if (!((cbp_luma >> (i >> 2)) & 1)) continue;
            const int bx = h264::kBlkX[i], by = h264::kBlkY[i];
            const int gx = gx0 + bx, gy = gy0 + by;
            int64_t scan[16] = {0};
            if (!residual(2, cbf_inc_luma4(gx, gy, false), 16, scan))
                continue;
            fl[(size_t)gy * mbw * 4 + gx] = 1;
            int tot = 0;
            for (int k = 0; k < 16; k++) {
                z[i][h264enc::kZigzag[k]] = scan[k];
                if (scan[k]) tot++;
            }
            d.nnz_y.at(gy, gx) = (int16_t)tot;  // deblock bS
        }
        int64_t czd[2][4], cza[2][4][16];
        read_chroma_cabac(mx, my, cbp_chroma, czd, cza, false);
        d.recon_inter(mx, my, qp, z, czd, cza, pred_y, pred_u, pred_v);
    }

    // ---- B macroblock layer (9.3.2.5 / 9.3.3.1; twin of h264cabac) -----

    // mb_type for B (Table 9-37, ctx 27-32): 0..22, or 23 = intra suffix
    int read_b_mb_type(int mx, int my) {
        const bool ca = mx > 0 && !b_direct[mi(my, mx - 1)];
        const bool cb = my > 0 && !b_direct[mi(my - 1, mx)];
        // unavailable neighbors count 0 (raster decode: left/top of the
        // first row/column are outside the picture)
        const bool ca_ok = mx > 0 && ca, cb_ok = my > 0 && cb;
        if (!eng.decision(27 + ca_ok + cb_ok)) return 0;
        if (!eng.decision(30)) return 1 + eng.decision(32);
        int bits = (eng.decision(31) << 3) | (eng.decision(32) << 2) |
                   (eng.decision(32) << 1) | eng.decision(32);
        if (bits < 8) return bits + 3;
        if (bits == 13) return 23;
        if (bits == 14) return 11;
        if (bits == 15) return 22;
        bits = (bits << 1) | eng.decision(32);
        return bits - 4;
    }

    // sub_mb_type for B (Table 9-38, ctx 36-39)
    int read_b_sub_type() {
        if (!eng.decision(36)) return 0;  // B_Direct_8x8
        if (!eng.decision(37)) return 1 + eng.decision(39);
        int t = 3;
        if (eng.decision(38)) {
            if (eng.decision(39)) return 11 + eng.decision(39);
            t += 4;
        }
        t += 2 * eng.decision(39);
        t += eng.decision(39);
        return t;
    }

    void decode_mb_b(Bits& r, int mx, int my) {
        using Part = Dec::Part;
        const int mb_type = read_b_mb_type(mx, my);
        if (mb_type == 0) b_direct[mi(my, mx)] = 1;
        if (mb_type == 23) {  // intra suffix, ctx base 32
            intra_in_inter(r, mx, my, 32);
            return;
        }
        d.mark_inter(mx, my);
        Part parts[16];
        int np = 0;
        if (mb_type == 0) {
            static constexpr int kAll[4] = {0, 1, 2, 3};
            np = d.direct_parts(mx, my, kAll, 4, parts);
        } else if (mb_type != 22) {
            const int* bm = Dec::kBModes[mb_type - 1];
            const int shape = bm[0];
            const int n = kPPartN2(shape);
            int refs[2][2] = {{-1, -1}, {-1, -1}};
            for (int lx = 0; lx < 2; lx++)
                for (int p = 0; p < n; p++)
                    if (bm[1 + p] & (1 << lx)) {
                        const int* sh = h264full::kPParts[shape][p];
                        const int gx = mx * 4 + sh[0] / 4,
                                  gy = my * 4 + sh[1] / 4;
                        refs[p][lx] = read_ref_idx(gx, gy, lx);
                        note_ref(gx, gy, sh[2] / 4, sh[3] / 4, refs[p][lx],
                                 lx);
                    }
            Part ps[2];
            for (int p = 0; p < n; p++) {
                const int* sh = h264full::kPParts[shape][p];
                ps[p] = Part{sh[0], sh[1], sh[2], sh[3], {-1, -1},
                             {0, 0}, {0, 0}};
            }
            for (int lx = 0; lx < 2; lx++)
                for (int p = 0; p < n; p++) {
                    if (!(bm[1 + p] & (1 << lx))) continue;
                    const int* sh = h264full::kPParts[shape][p];
                    const int gx = mx * 4 + sh[0] / 4,
                              gy = my * 4 + sh[1] / 4;
                    const int dx = read_mvd(gx, gy, 0, lx);
                    const int dy = read_mvd(gx, gy, 1, lx);
                    int hint = h264full::kHintNone;
                    if (shape == 1)
                        hint = p == 0 ? h264full::kHint16x8Top
                                      : h264full::kHint16x8Bot;
                    if (shape == 2)
                        hint = p == 0 ? h264full::kHint8x16Left
                                      : h264full::kHint8x16Right;
                    int px_x, px_y;
                    d.mvp(gx, gy, sh[2] / 4, sh[3] / 4, refs[p][lx], hint,
                          &px_x, &px_y, lx);
                    ps[p].refs[lx] = refs[p][lx];
                    ps[p].vx[lx] = px_x + dx;
                    ps[p].vy[lx] = px_y + dy;
                    d.set_part(mx, my, sh[0], sh[1], sh[2], sh[3],
                               refs[p][lx], px_x + dx, px_y + dy, lx);
                    note_absmvd(gx, gy, sh[2] / 4, sh[3] / 4, dx, dy, lx);
                }
            for (int p = 0; p < n; p++) parts[np++] = ps[p];
        } else {  // B_8x8
            int subs[4];
            for (int b = 0; b < 4; b++) subs[b] = read_b_sub_type();
            int dblocks[4], ndb = 0;
            for (int b = 0; b < 4; b++)
                if (subs[b] == 0) dblocks[ndb++] = b;
            Part dparts[4];
            if (ndb) d.direct_parts(mx, my, dblocks, ndb, dparts);
            int refs[4][2];
            for (int b = 0; b < 4; b++) refs[b][0] = refs[b][1] = -1;
            for (int lx = 0; lx < 2; lx++)
                for (int b = 0; b < 4; b++) {
                    if (subs[b] == 0) continue;
                    if (Dec::kBSub[subs[b] - 1][1] & (1 << lx)) {
                        const int bx0 = (b % 2) * 8, by0 = (b / 2) * 8;
                        const int gx = mx * 4 + bx0 / 4,
                                  gy = my * 4 + by0 / 4;
                        refs[b][lx] = read_ref_idx(gx, gy, lx);
                        note_ref(gx, gy, 2, 2, refs[b][lx], lx);
                    }
                }
            int smv[4][4][2][2];
            bool shas[4][4][2];
            for (int b = 0; b < 4; b++)
                for (int sI = 0; sI < 4; sI++)
                    shas[b][sI][0] = shas[b][sI][1] = false;
            for (int lx = 0; lx < 2; lx++)
                for (int b = 0; b < 4; b++) {
                    if (subs[b] == 0) continue;
                    const int shape = Dec::kBSub[subs[b] - 1][0];
                    if (!(Dec::kBSub[subs[b] - 1][1] & (1 << lx))) continue;
                    const int bx0 = (b % 2) * 8, by0 = (b / 2) * 8;
                    for (int sI = 0; sI < h264full::kPSubN[shape]; sI++) {
                        const int* sh = h264full::kPSub[shape][sI];
                        const int px = bx0 + sh[0], py = by0 + sh[1];
                        const int gx = mx * 4 + px / 4,
                                  gy = my * 4 + py / 4;
                        const int dx = read_mvd(gx, gy, 0, lx);
                        const int dy = read_mvd(gx, gy, 1, lx);
                        int px_x, px_y;
                        d.mvp(gx, gy, sh[2] / 4, sh[3] / 4, refs[b][lx],
                              h264full::kHintNone, &px_x, &px_y, lx);
                        smv[b][sI][lx][0] = px_x + dx;
                        smv[b][sI][lx][1] = px_y + dy;
                        shas[b][sI][lx] = true;
                        d.set_part(mx, my, px, py, sh[2], sh[3],
                                   refs[b][lx], px_x + dx, px_y + dy, lx);
                        note_absmvd(gx, gy, sh[2] / 4, sh[3] / 4, dx, dy,
                                    lx);
                    }
                }
            int di = 0;
            for (int b = 0; b < 4; b++) {
                if (subs[b] == 0) {
                    parts[np++] = dparts[di++];
                    continue;
                }
                const int shape = Dec::kBSub[subs[b] - 1][0];
                const int bx0 = (b % 2) * 8, by0 = (b / 2) * 8;
                for (int sI = 0; sI < h264full::kPSubN[shape]; sI++) {
                    const int* sh = h264full::kPSub[shape][sI];
                    Part pp{bx0 + sh[0], by0 + sh[1], sh[2], sh[3],
                            {-1, -1}, {0, 0}, {0, 0}};
                    for (int lx = 0; lx < 2; lx++)
                        if (shas[b][sI][lx]) {
                            pp.refs[lx] = refs[b][lx];
                            pp.vx[lx] = smv[b][sI][lx][0];
                            pp.vy[lx] = smv[b][sI][lx][1];
                        }
                    parts[np++] = pp;
                }
            }
        }
        int64_t pred_y[256], pred_u[64], pred_v[64];
        d.inter_pred_mb(mx, my, parts, np, pred_y, pred_u, pred_v);
        finish_inter(mx, my, pred_y, pred_u, pred_v);
    }

    static int kPPartN2(int shape) { return h264full::kPPartN[shape]; }

    void mb_i4(int mx, int my) {
        inxn[mi(my, mx)] = 1;
        // (transform_size_8x8_flag would precede the modes; the PPS parse
        // rejects transform_8x8 streams with a typed error)
        const int gy0 = my * 4, gx0 = mx * 4;
        int modes[16];
        for (int i = 0; i < 16; i++) {
            const int bx = h264::kBlkX[i], by = h264::kBlkY[i];
            const int gx = gx0 + bx, gy = gy0 + by;
            const int ma = gx > 0 ? d.i4mode(gy, gx - 1) : -1;
            const int mb_ = gy > 0 ? d.i4mode(gy - 1, gx) : -1;
            const int pm = (ma < 0 || mb_ < 0) ? 2 : (ma < mb_ ? ma : mb_);
            int mode;
            if (eng.decision(68)) {  // prev_intra4x4_pred_mode_flag
                mode = pm;
            } else {
                // rem_intra4x4_pred_mode: FL cMax 7, binIdx 0 = LSB
                const int rem = eng.decision(69) | (eng.decision(69) << 1) |
                                (eng.decision(69) << 2);
                mode = rem < pm ? rem : rem + 1;
            }
            d.i4mode(gy, gx) = static_cast<int8_t>(mode);
            modes[i] = mode;
        }
        const int chroma_mode = read_chroma_mode(mx, my);
        int cbp_luma, cbp_chroma;
        read_cbp(mx, my, &cbp_luma, &cbp_chroma);
        cbp[mi(my, mx)] = cbp_luma | (cbp_chroma << 4);
        int qp;
        if (cbp_luma || cbp_chroma) {
            qp = read_qp_delta(mx, my);
        } else {
            qp = d.qp_prev;
            d.qpmap[mi(my, mx)] = static_cast<int8_t>(qp);
            prev_qp_nz = false;
        }

        int64_t z[16][16];
        for (int i = 0; i < 16; i++)
            for (int k = 0; k < 16; k++) z[i][k] = 0;
        for (int i = 0; i < 16; i++) {
            if (!((cbp_luma >> (i >> 2)) & 1)) continue;
            const int bx = h264::kBlkX[i], by = h264::kBlkY[i];
            const int gx = gx0 + bx, gy = gy0 + by;
            int64_t scan[16] = {0};
            if (!residual(2, cbf_inc_luma4(gx, gy), 16, scan)) continue;
            fl[(size_t)gy * mbw * 4 + gx] = 1;
            for (int k = 0; k < 16; k++)
                z[i][h264enc::kZigzag[k]] = scan[k];
        }
        int64_t czd[2][4], cza[2][4][16];
        read_chroma_cabac(mx, my, cbp_chroma, czd, cza);
        d.recon_i4(mx, my, modes, qp, z, chroma_mode, czd, cza);
    }

    void mb_pcm(Bits& r, int mx, int my) {
        // raw samples start at the next byte boundary after the exact
        // arithmetic consumption point; engine re-inits after (9.3.1.2)
        d.decode_mb_ipcm(r, mx, my, pcm_data, pcm_nbytes);
        pcm[mi(my, mx)] = 1;
        cbp[mi(my, mx)] = 15 | (2 << 4);  // inferred (7.4.5)
        fldc[mi(my, mx)] = 1;
        for (int ty = my * 4; ty < my * 4 + 4; ty++)
            for (int tx = mx * 4; tx < mx * 4 + 4; tx++)
                fl[(size_t)ty * mbw * 4 + tx] = 1;
        for (int comp = 0; comp < 2; comp++) {
            fcdc[(size_t)comp * mbw * mbh + mi(my, mx)] = 1;
            for (int ty = my * 2; ty < my * 2 + 2; ty++)
                for (int tx = mx * 2; tx < mx * 2 + 2; tx++)
                    fc[((size_t)comp * mbh * 2 + ty) * mbw * 2 + tx] = 1;
        }
        prev_qp_nz = false;
        eng.reinit(r);
    }

    const uint8_t* pcm_data = nullptr;
    int64_t pcm_nbytes = 0;
};

}  // namespace h264cabac

extern "C" {

// Decode the macroblock layer + deblocking of one full baseline-intra
// I-slice.  data: unescaped RBSP padded with >= 8 zero bytes; start_pos:
// bit position after the slice header; slice_qp: qp after the header;
// disable_idc/off_a/off_b: deblocking slice-header fields (idc 1 = off).
// ry/ru/rv: caller-zeroed uint8 planes [mbh*16,mbw*16] / [mbh*8,mbw*8].
// out_state: {end_pos, mb_addr, err_detail}.  Returns 0 or a negative
// error code (see _NATIVE_FULL_ERRORS in av/h264dec_fast.py).
int64_t h264_decode_islice(const uint8_t* data, int64_t n_bytes,
                           int64_t start_pos, int64_t mbw, int64_t mbh,
                           int64_t slice_qp, int64_t chroma_qp_off,
                           int64_t chroma_qp_off2, int64_t disable_idc,
                           int64_t off_a, int64_t off_b,
                           const uint8_t* tables, uint8_t* ry, uint8_t* ru,
                           uint8_t* rv, int64_t* out_state) {
    using h264::Bits;
    using h264::ParseErr;

    Bits r{data, n_bytes * 8, start_pos};
    int64_t stop = -1;
    for (int64_t b = n_bytes - 1; b >= 0; b--) {
        if (data[b]) {
            stop = b * 8 + (7 - __builtin_ctz(data[b]));
            break;
        }
    }

    h264full::Dec dec(static_cast<int>(mbw), static_cast<int>(mbh), ry, ru,
                      rv, static_cast<int>(chroma_qp_off),
                      static_cast<int>(chroma_qp_off2), tables);
    dec.qp_prev = static_cast<int>(slice_qp);

    const int64_t n_total = mbw * mbh;
    int64_t mb_addr = 0;
    try {
        while (mb_addr < n_total && r.pos < stop) {
            const int mx = static_cast<int>(mb_addr % mbw);
            const int my = static_cast<int>(mb_addr / mbw);
            const int64_t mb_type = r.ue();
            if (mb_type == 25) {
                dec.decode_mb_ipcm(r, mx, my, data, n_bytes);
            } else if (mb_type == 0) {
                dec.decode_mb_i4(r, mx, my);
            } else if (mb_type >= 1 && mb_type <= 24) {
                dec.decode_mb_i16(r, mx, my, mb_type);
            } else {
                throw ParseErr{-4, mb_type};
            }
            mb_addr++;
        }
        if (mb_addr == n_total && disable_idc != 1)
            dec.deblock(static_cast<int>(off_a), static_cast<int>(off_b));
    } catch (const ParseErr& e) {
        out_state[0] = r.pos;
        out_state[1] = mb_addr;
        out_state[2] = e.detail;
        return e.code;
    }
    out_state[0] = r.pos;
    out_state[1] = mb_addr;
    out_state[2] = 0;
    return 0;
}

// Decode one full intra CABAC I-slice (macroblock layer + deblocking).
// data/start_pos/planes as in h264_decode_islice; start_pos must be the
// bit position right after the slice header (BEFORE cabac_alignment);
// cabac_tables: the 2432-byte blob packed by av/h264cabac.py.  Bit-exact
// vs libavcodec and the Python tier (tests/test_h264dec_cabac.py).
int64_t h264_decode_islice_cabac(
    const uint8_t* data, int64_t n_bytes, int64_t start_pos, int64_t mbw,
    int64_t mbh, int64_t slice_qp, int64_t chroma_qp_off,
    int64_t chroma_qp_off2, int64_t disable_idc, int64_t off_a,
    int64_t off_b, const uint8_t* cabac_tables, uint8_t* ry, uint8_t* ru,
    uint8_t* rv, int64_t* out_state) {
    using h264::Bits;
    using h264::ParseErr;

    Bits r{data, n_bytes * 8, start_pos};
    h264full::Dec dec(static_cast<int>(mbw), static_cast<int>(mbh), ry, ru,
                      rv, static_cast<int>(chroma_qp_off),
                      static_cast<int>(chroma_qp_off2), nullptr);
    dec.qp_prev = static_cast<int>(slice_qp);

    const int64_t n_total = mbw * mbh;
    int64_t mb_addr = 0;
    try {
        // cabac_alignment_one_bit (7.3.3)
        while (r.pos & 7)
            if (!r.read(1)) throw ParseErr{-25, r.pos};
        h264cabac::CDec c(dec, cabac_tables, static_cast<int>(slice_qp));
        c.pcm_data = data;
        c.pcm_nbytes = n_bytes;
        c.eng.reinit(r);
        for (;;) {
            if (mb_addr >= n_total) throw ParseErr{-22, mb_addr};
            const int mx = static_cast<int>(mb_addr % mbw);
            const int my = static_cast<int>(mb_addr / mbw);
            c.decode_mb(r, mx, my);
            mb_addr++;
            if (c.eng.terminate()) break;  // end_of_slice_flag
        }
        if (mb_addr != n_total) throw ParseErr{-23, mb_addr};
        if (disable_idc != 1)
            dec.deblock(static_cast<int>(off_a), static_cast<int>(off_b));
    } catch (const ParseErr& e) {
        out_state[0] = r.pos;
        out_state[1] = mb_addr;
        out_state[2] = e.detail;
        return e.code;
    }
    out_state[0] = r.pos;
    out_state[1] = mb_addr;
    out_state[2] = 0;
    return 0;
}

// Decode the macroblock layer + deblocking of one P slice, CAVLC or
// CABAC (twin of h264dec._decode_mb_p / h264cabac P support).
// data: unescaped RBSP padded with >= 8 zero bytes; start_pos: bit
// position after the slice header (CABAC: BEFORE cabac_alignment).
// refs_y/u/v: n_ref_slots stacked FULL planes; ref_slot/ref_pid map each
// of the num_ref_active list0 entries to a slot (-1 = missing) and its
// stored-picture id.  wp: {log_wd_y, log_wd_c, then wy,oy,wu,ou,wv,ov per
// list entry} when has_wp.  cabac_blob: the 8576-byte table blob
// (ignored for CAVLC; cavlc_tables ignored for CABAC).
int64_t h264_decode_inter(
    const uint8_t* data, int64_t n_bytes, int64_t start_pos,
    const int64_t* cfg,  // see kCfg* indices below
    const uint8_t* refs_y, const uint8_t* refs_u, const uint8_t* refs_v,
    const int64_t* ref_slot0, const int64_t* ref_pid0,
    const int64_t* ref_poc0, const int64_t* ref_slot1,
    const int64_t* ref_pid1, const int64_t* ref_poc1,
    const int16_t* col_mv, const int8_t* col_ridx, const int64_t* col_rpid,
    const int64_t* col_rpoc, int64_t has_wp, const int64_t* wp,
    const uint8_t* cavlc_tables, const uint8_t* cabac_blob, uint8_t* ry,
    uint8_t* ru, uint8_t* rv, int16_t* mv_out, int8_t* ridx_out,
    int64_t* rpid_out, int64_t* rpoc_out, int64_t* out_state) {
    using h264::Bits;
    using h264::ParseErr;

    // cfg layout (shared with native/__init__.py h264_decode_inter)
    const int64_t mbw = cfg[0], mbh = cfg[1], slice_qp = cfg[2];
    const int64_t chroma_qp_off = cfg[3], chroma_qp_off2 = cfg[4];
    const int64_t disable_idc = cfg[5], off_a = cfg[6], off_b = cfg[7];
    const int64_t is_cabac = cfg[8], cabac_init_idc = cfg[9];
    const int64_t slice_type = cfg[10];  // 0 = P, 1 = B
    const int64_t direct_spatial = cfg[11], implicit_wp = cfg[12];
    const int64_t cur_poc = cfg[13];
    const int n_active[2] = {static_cast<int>(cfg[14]),
                             static_cast<int>(cfg[15])};
    const int64_t n_ref_slots = cfg[16];
    const int64_t col_valid = cfg[17], col_intra = cfg[18];
    const int64_t col_poc = cfg[19];
    const bool is_b = slice_type == 1;

    Bits r{data, n_bytes * 8, start_pos};
    h264full::Dec dec(static_cast<int>(mbw), static_cast<int>(mbh), ry, ru,
                      rv, static_cast<int>(chroma_qp_off),
                      static_cast<int>(chroma_qp_off2), cavlc_tables);
    dec.qp_prev = static_cast<int>(slice_qp);
    dec.init_inter(n_active, static_cast<int>(n_ref_slots), refs_y, refs_u,
                   refs_v, ref_slot0, ref_pid0, ref_poc0, ref_slot1,
                   ref_pid1, ref_poc1, has_wp != 0, wp);
    dec.is_b = is_b;
    dec.direct_spatial = direct_spatial != 0;
    dec.implicit_wp = implicit_wp != 0;
    dec.cur_poc = cur_poc;
    dec.col_valid = col_valid != 0;
    dec.col_intra = col_intra != 0;
    dec.col_poc = col_poc;
    dec.col_mv = col_mv;
    dec.col_ridx = col_ridx;
    dec.col_rpid = col_rpid;
    dec.col_rpoc = col_rpoc;

    const int64_t n_total = mbw * mbh;
    int64_t mb_addr = 0;
    try {
        if (is_cabac) {
            while (r.pos & 7)
                if (!r.read(1)) throw ParseErr{-25, r.pos};
            h264cabac::CDec c(dec, cabac_blob, static_cast<int>(slice_qp),
                              1 + static_cast<int>(cabac_init_idc));
            c.pcm_data = data;
            c.pcm_nbytes = n_bytes;
            c.eng.reinit(r);
            for (;;) {
                if (mb_addr >= n_total) throw ParseErr{-22, mb_addr};
                const int mx = static_cast<int>(mb_addr % mbw);
                const int my = static_cast<int>(mb_addr / mbw);
                if (c.read_skip_flag(mx, my, is_b ? 24 : 11)) {
                    if (is_b) {
                        dec.b_skip_mb(mx, my);
                        c.b_direct[c.mi(my, mx)] = 1;
                    } else {
                        dec.p_skip_mb(mx, my);
                    }
                    c.skip[c.mi(my, mx)] = 1;
                    c.prev_qp_nz = false;
                } else if (is_b) {
                    c.decode_mb_b(r, mx, my);
                } else {
                    c.decode_mb_p(r, mx, my);
                }
                mb_addr++;
                if (c.eng.terminate()) break;  // end_of_slice_flag
            }
            if (mb_addr != n_total) throw ParseErr{-23, mb_addr};
        } else {
            int64_t stop = -1;
            for (int64_t b = n_bytes - 1; b >= 0; b--) {
                if (data[b]) {
                    stop = b * 8 + (7 - __builtin_ctz(data[b]));
                    break;
                }
            }
            while (mb_addr < n_total && r.pos < stop) {
                const int64_t skip_run = r.ue();
                if (mb_addr + skip_run > n_total)
                    throw ParseErr{-36, skip_run};
                for (int64_t sk = 0; sk < skip_run; sk++) {
                    const int mx = static_cast<int>(mb_addr % mbw);
                    const int my = static_cast<int>(mb_addr / mbw);
                    if (is_b) dec.b_skip_mb(mx, my);
                    else dec.p_skip_mb(mx, my);
                    mb_addr++;
                }
                if (mb_addr < n_total && r.pos < stop) {
                    const int mx = static_cast<int>(mb_addr % mbw);
                    const int my = static_cast<int>(mb_addr / mbw);
                    const int64_t mb_type = r.ue();
                    const int64_t intra_at = is_b ? 23 : 5;
                    if (mb_type >= intra_at) {  // intra MB in P/B
                        for (int ty = my * 4; ty < my * 4 + 4; ty++)
                            for (int tx = mx * 4; tx < mx * 4 + 4; tx++)
                                dec.dec4[dec.c4(ty, tx)] = 1;
                        const int64_t it = mb_type - intra_at;
                        if (it == 25) dec.decode_mb_ipcm(r, mx, my, data,
                                                         n_bytes);
                        else if (it == 0) dec.decode_mb_i4(r, mx, my);
                        else if (it <= 24) dec.decode_mb_i16(r, mx, my, it);
                        else throw ParseErr{-4, mb_type};
                    } else if (is_b) {
                        dec.decode_mb_b(r, mx, my, mb_type);
                    } else {
                        dec.decode_mb_p(r, mx, my, mb_type);
                    }
                    mb_addr++;
                }
            }
            if (mb_addr != n_total) throw ParseErr{-23, mb_addr};
        }
        if (disable_idc != 1)
            dec.deblock_general(static_cast<int>(off_a),
                                static_cast<int>(off_b));
        dec.export_motion(mv_out, ridx_out, rpid_out, rpoc_out);
    } catch (const ParseErr& e) {
        out_state[0] = r.pos;
        out_state[1] = mb_addr;
        out_state[2] = e.detail;
        return e.code;
    }
    out_state[0] = r.pos;
    out_state[1] = mb_addr;
    out_state[2] = 0;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Banded separable bicubic resize (the port's copy of scale_plane_banded
// in mixlab_tpu/native/mixlab_native.cpp).
//
// The dense resize matrix of video/scale.py is ~99% zeros, which a host CPU
// pays for.  The publish tier (server/stream_output.py) scales each
// picture to 1120x700 on the host, so this twin applies the SAME resize
// weights (packed banded by Python from resize_matrix — scale.py stays the
// single source of truth) as two banded passes with an f32 intermediate:
// ~K MACs per output sample instead of n_in.
// ---------------------------------------------------------------------------

extern "C" {

// dst[out_h, out_w] u8 <- src[in_h, in_w] u8.
// yidx/yw: [out_h, yk] source-row indices (pre-clamped) and weights;
// xidx/xw: [out_w, xk] source-col indices and weights.
void scale_plane_banded(const uint8_t* src, int64_t in_h, int64_t in_w,
                        uint8_t* dst, int64_t out_h, int64_t out_w,
                        const int32_t* yidx, const float* yw, int64_t yk,
                        const int32_t* xidx, const float* xw, int64_t xk,
                        float* tmp /* [in_w] scratch, caller-allocated */) {
    for (int64_t o = 0; o < out_h; ++o) {
        // vertical pass for this output row -> tmp[in_w]
        {
            const int32_t* idx = yidx + o * yk;
            const float* w = yw + o * yk;
            const uint8_t* r0 = src + (int64_t)idx[0] * in_w;
            float w0 = w[0];
            for (int64_t x = 0; x < in_w; ++x) tmp[x] = w0 * r0[x];
            for (int64_t k = 1; k < yk; ++k) {
                const uint8_t* rk = src + (int64_t)idx[k] * in_w;
                float wk = w[k];
                if (wk == 0.0f) continue;
                for (int64_t x = 0; x < in_w; ++x) tmp[x] += wk * rk[x];
            }
        }
        // horizontal pass -> dst row (round-half-away, clamp to u8)
        uint8_t* out = dst + o * out_w;
        for (int64_t x = 0; x < out_w; ++x) {
            const int32_t* idx = xidx + x * xk;
            const float* w = xw + x * xk;
            float acc = 0.0f;
            for (int64_t k = 0; k < xk; ++k) acc += w[k] * tmp[idx[k]];
            int v = (int)(acc + 0.5f);
            out[x] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
    }
}

}  // extern "C"
