// Native PNG decoder for the data-loader hot path.
//
// The offline augmentation pipeline writes 8-bit RGB non-interlaced PNGs,
// and AugMoNuSegDataset decodes thousands of them per epoch: the per-sample
// decode is the host side of the aug training path.  This implements exactly that profile: 8-bit, color type 2 (RGB),
// non-interlaced, zlib-compressed (the only thing our pipeline produces).
// png_decode_gray8 reads the same profile with color type 0 (8-bit gray),
// as the evaluator writes its masks and uncertainty maps (io/png.py).
// Anything else returns an error, which the Python binding raises.
//
// GIL note: ctypes releases the GIL for the call, so the existing threaded
// DataLoader gets true parallel decode for free.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libpngdec.so png_decode.cpp -lz

#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

constexpr unsigned char kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

inline uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return uint8_t(a);
    if (pb <= pc) return uint8_t(b);
    return uint8_t(c);
}

// error codes
enum {
    OK = 0,
    E_SIGNATURE = -1,
    E_TRUNCATED = -2,
    E_UNSUPPORTED = -3,  // bit depth / color type / interlace we don't do
    E_INFLATE = -4,
    E_FILTER = -5,
    E_BUFSIZE = -6,
};

struct Header {
    uint32_t width = 0, height = 0;
    int bit_depth = 0, color_type = 0, interlace = 0;
};

int parse_header(const uint8_t* data, int64_t len, Header* h) {
    if (len < 33 || std::memcmp(data, kSig, 8) != 0) return E_SIGNATURE;
    // first chunk must be IHDR
    if (be32(data + 8) != 13 || std::memcmp(data + 12, "IHDR", 4) != 0)
        return E_SIGNATURE;
    const uint8_t* p = data + 16;
    h->width = be32(p);
    h->height = be32(p + 4);
    h->bit_depth = p[8];
    h->color_type = p[9];
    h->interlace = p[12];
    return OK;
}

}  // namespace

extern "C" {

// Peek dimensions/format without decoding.  Returns 0 on success.
int png_info(const uint8_t* data, int64_t len, int64_t* height,
             int64_t* width, int* color_type, int* bit_depth) {
    Header h;
    int rc = parse_header(data, len, &h);
    if (rc != OK) return rc;
    *height = h.height;
    *width = h.width;
    *color_type = h.color_type;
    *bit_depth = h.bit_depth;
    return OK;
}

}  // extern "C"

namespace {

// Decode an 8-bit non-interlaced PNG of color type 2 (bpp 3) or 0 (bpp 1)
// into out (H*W*bpp bytes, row-major).
int decode8(const uint8_t* data, int64_t len, uint8_t* out, int64_t out_cap,
            int color_type, int bpp) try {
    Header h;
    int rc = parse_header(data, len, &h);
    if (rc != OK) return rc;
    if (h.bit_depth != 8 || h.color_type != color_type || h.interlace != 0)
        return E_UNSUPPORTED;
    // sanity-cap untrusted header dimensions: a corrupt IHDR must fail
    // cleanly, never allocate unboundedly
    if (h.width == 0 || h.height == 0 ||
        h.width > 1u << 16 || h.height > 1u << 16)
        return E_UNSUPPORTED;
    const int64_t W = h.width, H = h.height;
    const int64_t stride = W * bpp;
    if (out_cap < H * stride) return E_BUFSIZE;

    // gather the zlib stream from all IDAT chunks
    std::vector<uint8_t> idat;
    idat.reserve(size_t(len));
    const uint8_t* p = data + 8;
    const uint8_t* end = data + len;
    while (p + 12 <= end) {
        uint32_t clen = be32(p);
        if (p + 12 + clen > end) return E_TRUNCATED;
        if (std::memcmp(p + 4, "IDAT", 4) == 0)
            idat.insert(idat.end(), p + 8, p + 8 + clen);
        else if (std::memcmp(p + 4, "IEND", 4) == 0)
            break;
        p += 12 + clen;
    }
    if (idat.empty()) return E_TRUNCATED;

    // inflate to H rows of (1 filter byte + stride)
    std::vector<uint8_t> raw(size_t(H) * (stride + 1));
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return E_INFLATE;
    zs.next_in = idat.data();
    zs.avail_in = uInt(idat.size());
    zs.next_out = raw.data();
    zs.avail_out = uInt(raw.size());
    int zrc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (zrc != Z_STREAM_END || zs.avail_out != 0) return E_INFLATE;

    // un-filter rows (PNG filter types 0..4), bpp bytes per pixel
    for (int64_t y = 0; y < H; ++y) {
        const uint8_t* src = raw.data() + size_t(y) * (stride + 1);
        uint8_t filter = src[0];
        const uint8_t* cur = src + 1;
        uint8_t* dst = out + y * stride;
        const uint8_t* up = y > 0 ? out + (y - 1) * stride : nullptr;
        switch (filter) {
            case 0:  // None
                std::memcpy(dst, cur, size_t(stride));
                break;
            case 1:  // Sub
                for (int64_t x = 0; x < stride; ++x)
                    dst[x] = uint8_t(cur[x] + (x >= bpp ? dst[x - bpp] : 0));
                break;
            case 2:  // Up
                for (int64_t x = 0; x < stride; ++x)
                    dst[x] = uint8_t(cur[x] + (up ? up[x] : 0));
                break;
            case 3:  // Average
                for (int64_t x = 0; x < stride; ++x) {
                    int a = x >= bpp ? dst[x - bpp] : 0;
                    int b = up ? up[x] : 0;
                    dst[x] = uint8_t(cur[x] + ((a + b) >> 1));
                }
                break;
            case 4:  // Paeth
                for (int64_t x = 0; x < stride; ++x) {
                    int a = x >= bpp ? dst[x - bpp] : 0;
                    int b = up ? up[x] : 0;
                    int c = (up && x >= bpp) ? up[x - bpp] : 0;
                    dst[x] = uint8_t(cur[x] + paeth(a, b, c));
                }
                break;
            default:
                return E_FILTER;
        }
    }
    return OK;
} catch (...) {
    // never let a C++ exception (e.g. bad_alloc) cross the ctypes FFI
    // boundary — that is undefined behavior and would abort the process
    return E_INFLATE;
}

}  // namespace

extern "C" {

// Decode an 8-bit RGB non-interlaced PNG into out (H*W*3 bytes, row-major).
// Returns 0 on success, a negative error code otherwise.
int png_decode_rgb8(const uint8_t* data, int64_t len, uint8_t* out, int64_t out_cap) {
    return decode8(data, len, out, out_cap, 2, 3);
}

// Decode an 8-bit gray non-interlaced PNG into out (H*W bytes, row-major).
int png_decode_gray8(const uint8_t* data, int64_t len, uint8_t* out, int64_t out_cap) {
    return decode8(data, len, out, out_cap, 0, 1);
}

}  // extern "C"
