// decoders — the image decoders of the port on the host: a copy of the JAX
// package's native/sirilio.cpp decode_ljpeg (lossless JPEG, SOF3: CR2 and
// DNG), decode_nikon (Nikon-compressed NEF, compression 34713) and
// decode_panasonic (the RW2 bitstream of dcraw's pana_bits), and
// png_unfilter (the five PNG row filters, undone in place).
//
// Built at first use by siril_tpu_torch/native/__init__.py with
//   g++ -O3 -fopenmp -shared -fPIC -std=c++17 decoders.cpp
// into siril_tpu_torch/_build/ and bound through ctypes.  Each entry point
// returns 0, or a negative code when the stream does not decode.

#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

// ===========================================================================
// Lossless JPEG (ITU-T.81 process 14, SOF3) decoder — the DNG/raw tile
// codec (reference reaches it through libraw; this is an original
// implementation of the published spec: Huffman difference categories,
// predictors P1..P7, point transform, restart markers, FF00 stuffing).
// ===========================================================================

namespace ljpeg {

struct BitReader {
    const uint8_t* d;
    int64_t n, pos;
    uint32_t acc;
    int bits;
    BitReader(const uint8_t* d_, int64_t n_)
        : d(d_), n(n_), pos(0), acc(0), bits(0) {}
    int get1() {
        if (bits == 0) {
            uint8_t b = 0xFF;
            if (pos < n) {
                b = d[pos++];
                if (b == 0xFF) {
                    if (pos < n && d[pos] == 0x00) pos++;  // stuffed FF
                    // a real marker mid-scan: feed 1-bits (decoder will
                    // finish the current row; callers bound by size)
                }
            }
            acc = b;
            bits = 8;
        }
        bits--;
        return (acc >> bits) & 1;
    }
    int get(int nb) {
        int v = 0;
        for (int i = 0; i < nb; i++) v = (v << 1) | get1();
        return v;
    }
    void restart_align() {       // skip to just after the next RSTn
        acc = 0; bits = 0;
        while (pos + 1 < n) {
            if (d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7) {
                pos += 2;
                return;
            }
            pos++;
        }
    }
};

struct Huff {
    int mincode[17], maxcode[17], valptr[17];
    uint8_t vals[256];
    bool ok = false;
    void build(const uint8_t* counts, const uint8_t* symbols, int total) {
        for (int i = 0; i < total && i < 256; i++) vals[i] = symbols[i];
        int code = 0, k = 0;
        for (int l = 1; l <= 16; l++) {
            valptr[l] = k;
            mincode[l] = code;
            k += counts[l - 1];
            code += counts[l - 1];
            maxcode[l] = counts[l - 1] ? code - 1 : -1;
            code <<= 1;
        }
        ok = true;
    }
    int decode(BitReader& br) const {
        int code = 0;
        for (int l = 1; l <= 16; l++) {
            code = (code << 1) | br.get1();
            if (maxcode[l] >= 0 && code <= maxcode[l])
                return vals[valptr[l] + code - mincode[l]];
        }
        return -1;
    }
};

static inline int extend(int v, int t) {
    if (t == 0) return 0;
    if (t == 16) return 32768;               // ssss=16: no extra bits
    return (v < (1 << (t - 1))) ? v - (1 << t) + 1 : v;
}

}  // namespace ljpeg

// Decode a lossless JPEG stream.  out: row-major interleaved
// (height × width·ncomp) uint16.  Returns 0 on success, negative error.
extern "C" int decode_ljpeg(const uint8_t* buf, int64_t len,
                            uint16_t* out, int64_t out_cap,
                            int32_t* out_w, int32_t* out_h,
                            int32_t* out_ncomp) {
    using namespace ljpeg;
    if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return -1;
    int64_t p = 2;
    int precision = 0, width = 0, height = 0, ncomp = 0;
    int comp_tbl[4] = {0, 0, 0, 0};
    int predictor = 1, pt = 0, restart = 0;
    ljpeg::Huff tables[4];
    int64_t scan_start = -1;

    while (p + 4 <= len) {
        if (buf[p] != 0xFF) { p++; continue; }
        uint8_t m = buf[p + 1];
        p += 2;
        if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
        if (p + 2 > len) return -2;
        int seglen = (buf[p] << 8) | buf[p + 1];
        if (m == 0xC3) {                      // SOF3
            precision = buf[p + 2];
            height = (buf[p + 3] << 8) | buf[p + 4];
            width = (buf[p + 5] << 8) | buf[p + 6];
            ncomp = buf[p + 7];
            if (ncomp < 1 || ncomp > 4) return -3;
        } else if (m == 0xC4) {               // DHT
            int64_t q = p + 2;
            while (q + 17 <= p + seglen) {
                int th = buf[q] & 0x0F;
                const uint8_t* counts = buf + q + 1;
                int total = 0;
                for (int i = 0; i < 16; i++) total += counts[i];
                if (th < 4 && total <= 256)
                    tables[th].build(counts, buf + q + 17, total);
                q += 17 + total;
            }
        } else if (m == 0xDD) {               // DRI
            restart = (buf[p + 2] << 8) | buf[p + 3];
        } else if (m == 0xDA) {               // SOS
            int ns = buf[p + 2];
            int64_t q = p + 3;
            for (int i = 0; i < ns && i < 4; i++) {
                comp_tbl[i] = (buf[q + 1] >> 4) & 0x0F;
                q += 2;
            }
            predictor = buf[q];
            pt = buf[q + 2] & 0x0F;
            scan_start = p + seglen;
            break;
        }
        p += seglen;
    }
    if (scan_start < 0 || width <= 0 || height <= 0 || precision < 2)
        return -4;
    int64_t rowlen = (int64_t)width * ncomp;
    if ((int64_t)height * rowlen > out_cap) return -5;
    *out_w = width; *out_h = height; *out_ncomp = ncomp;

    ljpeg::BitReader br(buf + scan_start, len - scan_start);
    std::vector<int> prev_row(rowlen, 0), cur_row(rowlen, 0);
    const int default_pred = 1 << (precision - pt - 1);
    bool fresh = true;           // scan start or just after a restart
    int64_t mcu = 0;
    for (int y = 0; y < height; y++) {
        bool row_fresh = (y == 0);
        for (int x = 0; x < width; x++) {
            for (int c = 0; c < ncomp; c++) {
                const ljpeg::Huff& H = tables[comp_tbl[c]];
                if (!H.ok) return -6;
                int t = H.decode(br);
                if (t < 0) return -7;
                int diff = extend(t == 16 ? 0 : br.get(t), t);
                int64_t i = (int64_t)x * ncomp + c;
                int pred;
                if (fresh)
                    pred = default_pred;
                else if (x == 0)
                    pred = prev_row[i];
                else if (row_fresh)
                    pred = cur_row[i - ncomp];
                else {
                    int ra = cur_row[i - ncomp];
                    int rb = prev_row[i];
                    int rc = prev_row[i - ncomp];
                    switch (predictor) {
                        case 1: pred = ra; break;
                        case 2: pred = rb; break;
                        case 3: pred = rc; break;
                        case 4: pred = ra + rb - rc; break;
                        case 5: pred = ra + ((rb - rc) >> 1); break;
                        case 6: pred = rb + ((ra - rc) >> 1); break;
                        case 7: pred = (ra + rb) >> 1; break;
                        default: pred = ra; break;
                    }
                }
                int v = (pred + diff) & 0xFFFF;
                cur_row[i] = v;
                out[(int64_t)y * rowlen + i] = (uint16_t)(v << pt);
            }
            fresh = false;
            mcu++;
            if (restart && (mcu % restart) == 0
                && !(y == height - 1 && x == width - 1)) {
                br.restart_align();
                fresh = true;            // predictor restarts from default
            }
        }
        std::swap(prev_row, cur_row);
    }
    return 0;
}

// ===========================================================================
// Nikon-compressed NEF (compression 34713) — Huffman-coded row-predictor
// deltas with a linearization curve (reference reaches this through
// libraw; original implementation of the format: fixed per-mode Huffman
// tables, two-predictor recurrence, optional tree switch at `split`).
// The curve lookup happens in Python (vectorized); this decodes the
// pre-curve 14-bit values.
// ===========================================================================

namespace nikon {

// Fixed NEF Huffman tables (format constants): 16 code-length counts
// followed by leaf values; leaf = (shl << 4) | len.
static const uint8_t TREES[6][32] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,            // 12-bit lossy
     5, 4, 3, 6, 2, 7, 1, 0, 8, 9, 11, 10, 12},
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,            // 12-bit lossy after split
     0x39, 0x5a, 0x38, 0x27, 0x16, 5, 4, 3, 2, 1, 0, 11, 12, 12},
    {0, 1, 4, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0,            // 12-bit lossless
     5, 4, 6, 3, 7, 2, 8, 1, 9, 0, 10, 11, 12},
    {0, 1, 4, 3, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,            // 14-bit lossy
     5, 6, 4, 7, 8, 3, 9, 2, 1, 0, 10, 11, 12, 13, 14},
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0,            // 14-bit lossy after split
     8, 0x5c, 0x4b, 0x3a, 0x29, 7, 6, 5, 4, 3, 2, 1, 0, 13, 14},
    {0, 1, 4, 2, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0,            // 14-bit lossless
     7, 6, 8, 5, 9, 4, 10, 3, 11, 12, 2, 0, 1, 13, 14}};

struct Bits {                     // MSB-first, no marker stuffing
    const uint8_t* d;
    int64_t n, pos;
    uint32_t acc;
    int bits;
    Bits(const uint8_t* d_, int64_t n_)
        : d(d_), n(n_), pos(0), acc(0), bits(0) {}
    int get1() {
        if (bits == 0) {
            acc = pos < n ? d[pos++] : 0;
            bits = 8;
        }
        bits--;
        return (acc >> bits) & 1;
    }
    int get(int nb) {
        int v = 0;
        for (int i = 0; i < nb; i++) v = (v << 1) | get1();
        return v;
    }
};

}  // namespace nikon

// Decode a Nikon-compressed raw strip into pre-curve values.
// vpred_in: 4 initial vertical predictors (row0col0,row0col1,row1col0,
// row1col1); split: row where the tree switches to tree_id+1 (0 = never).
extern "C" int decode_nikon(const uint8_t* buf, int64_t len,
                            int32_t width, int32_t height,
                            int32_t tree_id, const uint16_t* vpred_in,
                            int32_t split, uint16_t* out) {
    using namespace nikon;
    if (tree_id < 0 || tree_id > 5 || width <= 0 || height <= 0)
        return -1;
    ljpeg::Huff huff[2];
    huff[0].build(TREES[tree_id], TREES[tree_id] + 16, 16);
    if (split > 0) {
        if (tree_id + 1 > 5) return -1;
        huff[1].build(TREES[tree_id + 1], TREES[tree_id + 1] + 16, 16);
    }
    const ljpeg::Huff* H = &huff[0];
    Bits br(buf, len);
    uint16_t vpred[2][2] = {{vpred_in[0], vpred_in[1]},
                            {vpred_in[2], vpred_in[3]}};
    for (int32_t row = 0; row < height; row++) {
        if (split > 0 && row == split) H = &huff[1];
        uint16_t hpred[2] = {0, 0};
        for (int32_t col = 0; col < width; col++) {
            int leaf;
            {   // canonical-huffman decode (reuses ljpeg::Huff layout)
                int code = 0, l;
                leaf = -1;
                for (l = 1; l <= 16; l++) {
                    code = (code << 1) | br.get1();
                    if (H->maxcode[l] >= 0 && code <= H->maxcode[l]) {
                        leaf = H->vals[H->valptr[l] + code - H->mincode[l]];
                        break;
                    }
                }
                if (leaf < 0) return -2;
            }
            int lenb = leaf & 15;
            int shl = leaf >> 4;
            int diff = ((br.get(lenb - shl) << 1) + 1) << shl >> 1;
            if (lenb > 0 && (diff & (1 << (lenb - 1))) == 0)
                diff -= (1 << lenb) - (shl ? 0 : 1);
            if (col < 2)
                hpred[col] = vpred[row & 1][col] =
                    (uint16_t)(vpred[row & 1][col] + diff);
            else
                hpred[col & 1] = (uint16_t)(hpred[col & 1] + diff);
            int16_t v = (int16_t)hpred[col & 1];
            int clipped = v < 0 ? 0 : (v > 0x3fff ? 0x3fff : v);
            out[(int64_t)row * width + col] = (uint16_t)clipped;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Panasonic RW2 v4 bitstream (dcraw panasonic_load_raw / pana_bits
// semantics — the documented 12-bit sliced predictor format; the
// reference reads RW2 through libraw, image_formats_libraries.c)
// ---------------------------------------------------------------------------

namespace pana {

struct Bits {
    const uint8_t* data;
    int64_t len, pos;
    int load_flags;
    // 0x4002: byte = vbits>>3 ^ 0x3ff0 reaches 0x3fff at every 16 KB
    // block boundary and the 16-bit read there touches buf[0x4000];
    // the pad bytes stay zero (matching the Python oracle)
    uint8_t buf[0x4002];
    int vbits;

    Bits(const uint8_t* d, int64_t l, int lf)
        : data(d), len(l), pos(0), load_flags(lf), vbits(0) {
        buf[0x4000] = buf[0x4001] = 0;
    }

    void fill(uint8_t* dst, int64_t n) {
        for (int64_t i = 0; i < n; i++)
            dst[i] = pos < len ? data[pos++] : 0;
    }

    unsigned get(int nbits) {
        if (!vbits) {
            fill(buf + load_flags, 0x4000 - load_flags);
            fill(buf, load_flags);
        }
        vbits = (vbits - nbits) & 0x1ffff;
        int byte = (vbits >> 3) ^ 0x3ff0;
        return ((buf[byte] | (buf[byte + 1] << 8)) >> (vbits & 7))
               & ~((-1) << nbits);
    }
};

}  // namespace pana

extern "C" int decode_panasonic(const uint8_t* buf, int64_t len,
                                int32_t width, int32_t height,
                                int32_t load_flags, uint16_t* out) {
    pana::Bits bits(buf, len, load_flags);
    int pred[2], nonz[2], sh = 0;
    for (int32_t row = 0; row < height; row++) {
        for (int32_t col = 0; col < width; col++) {
            int i = col % 14;
            if (i == 0) pred[0] = pred[1] = nonz[0] = nonz[1] = 0;
            if (i % 3 == 2) sh = 4 >> (3 - (int)bits.get(2));
            if (nonz[i & 1]) {
                int j = (int)bits.get(8);
                if (j) {
                    if ((pred[i & 1] -= 0x80 << sh) < 0 || sh == 4)
                        pred[i & 1] &= ~((-1) << sh);
                    pred[i & 1] += j << sh;
                }
            } else if ((nonz[i & 1] = (int)bits.get(8)) != 0 || i > 11) {
                pred[i & 1] = nonz[i & 1] << 4 | (int)bits.get(4);
            }
            out[(int64_t)row * width + col] = (uint16_t)pred[col & 1];
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// PNG row filters (PNG specification, section 9): each of the `height` rows
// of `data` is one filter-type byte and `rowbytes` filtered bytes; the rows
// are written unfiltered to `out` (height x rowbytes).  `bpp` is the bytes
// of one pixel (at least 1).  Returns 0, or -1 on an unknown filter type.
// ---------------------------------------------------------------------------

extern "C" int png_unfilter(const uint8_t* data, int64_t height,
                            int64_t rowbytes, int32_t bpp, uint8_t* out) {
    for (int64_t y = 0; y < height; y++) {
        const uint8_t* src = data + y * (rowbytes + 1);
        const int type = src[0];
        src++;
        uint8_t* cur = out + y * rowbytes;
        const uint8_t* up = y > 0 ? out + (y - 1) * rowbytes : nullptr;
        for (int64_t i = 0; i < rowbytes; i++) {
            const int a = i >= bpp ? cur[i - bpp] : 0;
            const int b = up ? up[i] : 0;
            const int c = (up && i >= bpp) ? up[i - bpp] : 0;
            int pred;
            switch (type) {
                case 0: pred = 0; break;
                case 1: pred = a; break;
                case 2: pred = b; break;
                case 3: pred = (a + b) >> 1; break;
                case 4: {
                    const int p = a + b - c;
                    const int pa = p > a ? p - a : a - p;
                    const int pb = p > b ? p - b : b - p;
                    const int pc = p > c ? p - c : c - p;
                    pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    break;
                }
                default: return -1;
            }
            cur[i] = (uint8_t)(src[i] + pred);
        }
    }
    return 0;
}
