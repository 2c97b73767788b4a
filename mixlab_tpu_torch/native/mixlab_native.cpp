// The host C++ of the port's served path (the port's copy of two parts of
// mixlab_tpu/native/mixlab_native.cpp, exposed via ctypes, see __init__.py):
//
//   * WebSocket XOR unmasking (RFC 6455 §5.3) — per-byte in Python, word-wide
//     here (server/ws.py);
//   * the H.264 CAVLC Intra_16x16 frame encoder, the monitor's fastest
//     zero-dependency video tier (av/h264cavlc_fast.py).
//
// Host code, not a device kernel.
// Build: g++ -O3 -march=native -shared -fPIC -o libmixlab_native.so mixlab_native.cpp

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

extern "C" {

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
