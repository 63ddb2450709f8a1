// rice — the RICE_1 tile coder of FITS tiled image compression, on the
// host: a trimmed copy of the JAX package's native/sirilio.cpp (BitWriter,
// BitReader, rice_encode_tile, rice_decode_tile, rice_encode_tiles_i16,
// rice_decode_tiles_i16), OpenMP-parallel over row tiles.
//
// Built at first use by siril_tpu_torch/native/__init__.py with
//   g++ -O3 -fopenmp -shared -fPIC rice.cpp
// into siril_tpu_torch/_build/ and bound through ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct BitWriter {
    uint8_t* out;
    int64_t cap, len;
    uint64_t acc;
    int nbits;
    BitWriter(uint8_t* o, int64_t c) : out(o), cap(c), len(0), acc(0), nbits(0) {}
    inline void put(uint64_t v, int n) {
        acc = (acc << n) | (v & ((1ULL << n) - 1));
        nbits += n;
        while (nbits >= 8) {
            nbits -= 8;
            if (len < cap) out[len] = (uint8_t)(acc >> nbits);
            len++;
        }
        acc &= (1ULL << nbits) - 1;
    }
    inline void unary(int64_t zeros) {
        while (zeros >= 31) { put(0, 31); zeros -= 31; }
        put(1, (int)zeros + 1);
    }
    int64_t flush() {
        if (nbits) {
            if (len < cap) out[len] = (uint8_t)(acc << (8 - nbits));
            len++;
            acc = 0; nbits = 0;
        }
        return len;
    }
};

struct BitReader {
    const uint8_t* in;
    int64_t len, pos;
    uint64_t acc;
    int nbits;
    BitReader(const uint8_t* i, int64_t l) : in(i), len(l), pos(0), acc(0), nbits(0) {}
    inline uint64_t get(int n) {
        while (nbits < n) {
            uint8_t b = pos < len ? in[pos] : 0;
            pos++;
            acc = (acc << 8) | b;
            nbits += 8;
        }
        nbits -= n;
        uint64_t v = (acc >> nbits) & ((1ULL << n) - 1);
        acc &= (1ULL << nbits) - 1;
        return v;
    }
    inline int64_t unary() {
        int64_t n = 0;
        while (get(1) == 0) n++;
        return n;
    }
};

inline void fs_params(int bytepix, int* fsbits, int* fsmax) {
    if (bytepix == 1) { *fsbits = 3; *fsmax = 6; }
    else if (bytepix == 2) { *fsbits = 4; *fsmax = 14; }
    else { *fsbits = 5; *fsmax = 25; }
}

} // namespace

extern "C" {

// Encode one tile of npix values (given as int64) with block size 32.
// dst must have capacity cap bytes; returns encoded length (may exceed
// cap — caller must retry with a larger buffer; never writes past cap).
int64_t rice_encode_tile(const int64_t* a, int64_t npix, int bytepix,
                         uint8_t* dst, int64_t cap) {
    if (npix <= 0) return 0;
    int fsbits, fsmax;
    fs_params(bytepix, &fsbits, &fsmax);
    const int bbits = bytepix * 8;
    const int64_t half = 1LL << (bbits - 1);
    const int64_t full = 1LL << bbits;
    BitWriter w(dst, cap);
    w.put((uint64_t)a[0] & (full - 1), bbits);
    const int NB = 32;
    for (int64_t start = 1; start < npix; start += NB) {
        int64_t end = start + NB < npix ? start + NB : npix;
        int n = (int)(end - start);
        uint64_t u[32];
        uint64_t sum = 0;
        for (int j = 0; j < n; j++) {
            int64_t d = a[start + j] - a[start + j - 1];
            d = ((d + half) % full + full) % full - half;   // wrap to bbits
            uint64_t m = d < 0 ? ~((uint64_t)d << 1) : ((uint64_t)d << 1);
            m &= (uint64_t)(full - 1);
            u[j] = m;
            sum += m;
        }
        if (sum == 0) { w.put(0, fsbits); continue; }
        double dpsum = ((double)sum - (n / 2) - 1) / n;
        uint64_t psum = dpsum > 0 ? ((uint64_t)dpsum) >> 1 : 0;
        int fs = 0;
        while (psum > 0) { psum >>= 1; fs++; }
        if (fs >= fsmax) {
            w.put((uint64_t)fsmax + 1, fsbits);
            for (int j = 0; j < n; j++) w.put(u[j], bbits);
        } else {
            w.put((uint64_t)fs + 1, fsbits);
            for (int j = 0; j < n; j++) {
                w.unary((int64_t)(u[j] >> fs));
                if (fs) w.put(u[j], fs);
            }
        }
    }
    return w.flush();
}

// Decode npix values into out (int64).
void rice_decode_tile(const uint8_t* src, int64_t nbytes, int64_t npix,
                      int bytepix, int64_t* out) {
    if (npix <= 0) return;
    int fsbits, fsmax;
    fs_params(bytepix, &fsbits, &fsmax);
    const int bbits = bytepix * 8;
    const int64_t half = 1LL << (bbits - 1);
    const int64_t full = 1LL << bbits;
    BitReader r(src, nbytes);
    int64_t last = (int64_t)r.get(bbits);
    if (last >= half) last -= full;
    out[0] = last;
    int64_t i = 1;
    const int NB = 32;
    while (i < npix) {
        int n = (int)(npix - i < NB ? npix - i : NB);
        uint64_t code = r.get(fsbits);
        for (int j = 0; j < n; j++) {
            uint64_t m;
            if (code == 0) m = 0;
            else if (code == (uint64_t)fsmax + 1) m = r.get(bbits);
            else {
                int fs = (int)code - 1;
                uint64_t top = (uint64_t)r.unary();
                m = (top << fs) | (fs ? r.get(fs) : 0);
            }
            int64_t d = (m & 1) ? ~(int64_t)(m >> 1) : (int64_t)(m >> 1);
            last = ((last + d + half) % full + full) % full - half;
            out[i + j] = last;
        }
        i += n;
    }
}

// Batch: encode `ntiles` row tiles of `tile_pix` i16 values each.
// offsets/lengths are outputs; heap receives concatenated streams.
// Returns total heap bytes, or -1 if heap_cap insufficient.
int64_t rice_encode_tiles_i16(const int16_t* data, int64_t ntiles,
                              int64_t tile_pix, uint8_t* heap,
                              int64_t heap_cap, int64_t* offsets,
                              int64_t* lengths) {
    // worst case per tile: bbits+fsbits per pixel / 8 + slack
    int64_t worst = tile_pix * 3 + 64;
    // encode in parallel into per-tile scratch, then compact
    std::vector<std::vector<uint8_t>>* scratch =
        new std::vector<std::vector<uint8_t>>(ntiles);
#pragma omp parallel for schedule(static)
    for (int64_t t = 0; t < ntiles; t++) {
        std::vector<int64_t> vals(tile_pix);
        for (int64_t k = 0; k < tile_pix; k++)
            vals[k] = data[t * tile_pix + k];
        (*scratch)[t].resize(worst);
        int64_t n = rice_encode_tile(vals.data(), tile_pix, 2,
                                     (*scratch)[t].data(), worst);
        (*scratch)[t].resize(n <= worst ? n : 0);
        lengths[t] = n <= worst ? n : 0;
    }
    int64_t off = 0;
    for (int64_t t = 0; t < ntiles; t++) {
        offsets[t] = off;
        if (off + lengths[t] > heap_cap) { delete scratch; return -1; }
        memcpy(heap + off, (*scratch)[t].data(), lengths[t]);
        off += lengths[t];
    }
    delete scratch;
    return off;
}

// Batch decode of i16 row tiles back into an int16 buffer.
void rice_decode_tiles_i16(const uint8_t* heap, const int64_t* offsets,
                           const int64_t* lengths, int64_t ntiles,
                           int64_t tile_pix, int16_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t t = 0; t < ntiles; t++) {
        std::vector<int64_t> vals(tile_pix);
        rice_decode_tile(heap + offsets[t], lengths[t], tile_pix, 2,
                         vals.data());
        for (int64_t k = 0; k < tile_pix; k++)
            out[t * tile_pix + k] = (int16_t)vals[k];
    }
}

} // extern "C"
