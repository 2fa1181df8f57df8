// BMP decoder of the Herlev data loader (a copy of the JAX package's
// native/bmp_decode.cpp).
//
// The Herlev dataset is folder-per-class RGB BMPs, decoded per sample every
// epoch on the host.  This implements the profile those files use: 'BM'
// classic header, BITMAPINFOHEADER (or larger), 24- or 32-bit BI_RGB
// (uncompressed), bottom-up or top-down row order, rows padded to 4 bytes.
// Anything else (palette, RLE, 16-bit, OS/2 core headers) returns an error,
// and the Python binding raises naming the file: there is no other decoder.
//
// ctypes releases the GIL for the call, so the threaded DataLoader decodes
// in parallel.
//
// Build (ugpg_tpu_torch/native/__init__.py does it at first use):
//   g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off -o libbmp_decode.so bmp_decode.cpp

#include <cstdint>
#include <cstring>

namespace {

enum {
    OK = 0,
    E_SIGNATURE = -1,
    E_TRUNCATED = -2,
    E_UNSUPPORTED = -3,
    E_BUFSIZE = -6,
};

inline uint16_t le16(const uint8_t* p) {
    return uint16_t(p[0] | (p[1] << 8));
}
inline uint32_t le32(const uint8_t* p) {
    return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
           (uint32_t(p[3]) << 24);
}

struct Header {
    int64_t width = 0, height = 0;  // height sign = row order
    int bitcount = 0;
    uint32_t compression = 0;
    uint32_t data_off = 0;
};

int parse(const uint8_t* d, int64_t len, Header* h) {
    if (len < 54 || d[0] != 'B' || d[1] != 'M') return E_SIGNATURE;
    h->data_off = le32(d + 10);
    uint32_t hdr_size = le32(d + 14);
    if (hdr_size < 40) return E_UNSUPPORTED;  // OS/2 core header
    h->width = int32_t(le32(d + 18));
    h->height = int32_t(le32(d + 22));
    if (le16(d + 26) != 1) return E_UNSUPPORTED;  // planes
    h->bitcount = le16(d + 28);
    h->compression = le32(d + 30);
    return OK;
}

int check_profile(const Header& h) {
    int64_t aw = h.width, ah = h.height < 0 ? -h.height : h.height;
    if (aw <= 0 || ah <= 0 || aw > 1 << 16 || ah > 1 << 16)
        return E_UNSUPPORTED;
    if (aw * ah > int64_t(1) << 26) return E_UNSUPPORTED;  // bomb guard
    if (h.bitcount != 24 && h.bitcount != 32) return E_UNSUPPORTED;
    // BI_RGB only; BI_BITFIELDS (3) on 32-bit is usually BGRA too but the
    // masks would need honoring
    if (h.compression != 0) return E_UNSUPPORTED;
    return OK;
}

}  // namespace

extern "C" {

// Factory ABI: (data, len, *h, *w, *a, *b) with a=bitcount, b=compression.
int bmp_info(const uint8_t* data, int64_t len, int64_t* height,
             int64_t* width, int* bitcount, int* compression) {
    Header h;
    int rc = parse(data, len, &h);
    if (rc != OK) return rc;
    rc = check_profile(h);
    if (rc != OK) return rc;
    *height = h.height < 0 ? -h.height : h.height;
    *width = h.width;
    *bitcount = h.bitcount;
    *compression = int(h.compression);
    return OK;
}

// Decode into out as H*W*3 RGB8 (BGR(A) -> RGB, row order normalized).
int bmp_decode_rgb8(const uint8_t* data, int64_t len, uint8_t* out,
                    int64_t out_cap) try {
    Header h;
    int rc = parse(data, len, &h);
    if (rc != OK) return rc;
    rc = check_profile(h);
    if (rc != OK) return rc;

    const bool top_down = h.height < 0;
    const int64_t W = h.width, H = top_down ? -h.height : h.height;
    if (out_cap < H * W * 3) return E_BUFSIZE;

    const int bpp = h.bitcount / 8;
    const int64_t src_stride = ((W * bpp + 3) / 4) * 4;  // 4-byte row pad
    if (h.data_off > len || int64_t(h.data_off) + src_stride * H > len)
        return E_TRUNCATED;

    for (int64_t y = 0; y < H; ++y) {
        const int64_t src_row = top_down ? y : H - 1 - y;
        const uint8_t* src = data + h.data_off + src_row * src_stride;
        uint8_t* dst = out + y * W * 3;
        for (int64_t x = 0; x < W; ++x) {
            dst[x * 3 + 0] = src[x * bpp + 2];  // R
            dst[x * 3 + 1] = src[x * bpp + 1];  // G
            dst[x * 3 + 2] = src[x * bpp + 0];  // B (alpha dropped at bpp=4)
        }
    }
    return OK;
} catch (...) {
    return E_UNSUPPORTED;  // never let a C++ exception cross the FFI
}

}  // extern "C"
