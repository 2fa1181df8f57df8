// Native TIFF decoder for the whole-slide data-loader hot path.
//
// MoNuSeg slides are 1000x1000 8-bit RGB TIFFs (ref:
// MoNuSegImprove/monuseg_dataset.py:192-215 reads them with PIL), and the
// native-resolution eval/fine-tune path decodes every slide per epoch on
// the host.  This implements the profile those files (and everything our
// own pipeline produces) actually use: classic TIFF (II or MM byte order),
// first IFD, strip-based chunky layout, 8 bits per sample, 1/3/4 samples
// per pixel (gray / RGB / RGBA -> alpha dropped, like PIL convert("RGB")),
// compression None (1), LZW (5, TIFF variant with EarlyChange and optional
// horizontal Predictor 2), Deflate (8 / 32946), or PackBits (32773).
// Anything else returns an error, which the Python binding raises.
//
// GIL note: ctypes releases the GIL for the call, so the threaded
// DataLoader gets true parallel decode for free.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libtiffdec.so tiff_decode.cpp -lz

#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

enum {
    OK = 0,
    E_SIGNATURE = -1,
    E_TRUNCATED = -2,
    E_UNSUPPORTED = -3,
    E_DECOMPRESS = -4,
    E_BUFSIZE = -6,
};

struct Reader {
    const uint8_t* data;
    int64_t len;
    bool be;  // big-endian (MM)

    bool in_bounds(int64_t off, int64_t n) const {
        return off >= 0 && n >= 0 && off + n <= len;
    }
    uint16_t u16(int64_t off) const {
        const uint8_t* p = data + off;
        return be ? uint16_t((p[0] << 8) | p[1]) : uint16_t((p[1] << 8) | p[0]);
    }
    uint32_t u32(int64_t off) const {
        const uint8_t* p = data + off;
        return be ? (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                        (uint32_t(p[2]) << 8) | p[3]
                  : (uint32_t(p[3]) << 24) | (uint32_t(p[2]) << 16) |
                        (uint32_t(p[1]) << 8) | p[0];
    }
};

// TIFF tags we care about.
enum {
    T_WIDTH = 256,
    T_HEIGHT = 257,
    T_BITS = 258,
    T_COMPRESSION = 259,
    T_PHOTOMETRIC = 262,
    T_STRIP_OFFSETS = 273,
    T_SPP = 277,
    T_ROWS_PER_STRIP = 278,
    T_STRIP_COUNTS = 279,
    T_PLANAR = 284,
    T_PREDICTOR = 317,
    T_TILE_WIDTH = 322,
};

struct Entry {
    uint16_t type = 0;
    uint32_t count = 0;
    int64_t value_off = 0;  // offset of the value field (inline or indirect)
};

struct Info {
    uint32_t width = 0, height = 0;
    uint16_t bits = 0, spp = 1, compression = 1, photometric = 2;
    uint16_t planar = 1, predictor = 1;
    uint32_t rows_per_strip = 0xFFFFFFFFu;
    Entry strip_offsets, strip_counts;
    bool tiled = false;
};

int type_size(uint16_t type) {
    switch (type) {
        case 1: return 1;   // BYTE
        case 3: return 2;   // SHORT
        case 4: return 4;   // LONG
        default: return 0;  // anything else we don't read
    }
}

// Read element i of an entry as an unsigned integer.
bool entry_get(const Reader& r, const Entry& e, uint32_t i, uint32_t* out) {
    int sz = type_size(e.type);
    if (sz == 0 || i >= e.count) return false;
    int64_t off = e.value_off + int64_t(i) * sz;
    if (!r.in_bounds(off, sz)) return false;
    if (sz == 1) *out = r.data[off];
    else if (sz == 2) *out = r.u16(off);
    else *out = r.u32(off);
    return true;
}

int parse(const Reader& r, Info* info) {
    if (r.len < 8) return E_SIGNATURE;
    uint16_t magic = r.u16(2);
    if (magic != 42) return E_SIGNATURE;  // 43 = BigTIFF: unsupported
    int64_t ifd = r.u32(4);
    if (!r.in_bounds(ifd, 2)) return E_TRUNCATED;
    uint16_t n = r.u16(ifd);
    if (!r.in_bounds(ifd + 2, int64_t(n) * 12 + 4)) return E_TRUNCATED;

    for (uint16_t i = 0; i < n; ++i) {
        int64_t eoff = ifd + 2 + int64_t(i) * 12;
        uint16_t tag = r.u16(eoff);
        Entry e;
        e.type = r.u16(eoff + 2);
        e.count = r.u32(eoff + 4);
        int sz = type_size(e.type);
        int64_t vbytes = int64_t(sz) * e.count;
        e.value_off = (sz > 0 && vbytes <= 4) ? eoff + 8 : int64_t(r.u32(eoff + 8));

        uint32_t v0 = 0;
        bool have0 = entry_get(r, e, 0, &v0);
        switch (tag) {
            case T_WIDTH: if (have0) info->width = v0; break;
            case T_HEIGHT: if (have0) info->height = v0; break;
            case T_BITS: if (have0) info->bits = uint16_t(v0); break;
            case T_COMPRESSION: if (have0) info->compression = uint16_t(v0); break;
            case T_PHOTOMETRIC: if (have0) info->photometric = uint16_t(v0); break;
            case T_STRIP_OFFSETS: info->strip_offsets = e; break;
            case T_SPP: if (have0) info->spp = uint16_t(v0); break;
            case T_ROWS_PER_STRIP: if (have0) info->rows_per_strip = v0; break;
            case T_STRIP_COUNTS: info->strip_counts = e; break;
            case T_PLANAR: if (have0) info->planar = uint16_t(v0); break;
            case T_PREDICTOR: if (have0) info->predictor = uint16_t(v0); break;
            case T_TILE_WIDTH: info->tiled = true; break;
            default: break;
        }
    }
    return OK;
}

int check_profile(const Info& f) {
    if (f.width == 0 || f.height == 0 ||
        f.width > 1u << 16 || f.height > 1u << 16)
        return E_UNSUPPORTED;
    // decompression-bomb guard: a ~200-byte file can claim 65536x65536
    // dims; cap total pixels (64 MPix ~ 192 MB RGB) BEFORE any caller
    // allocates an output buffer; real slides (MoNuSeg: 1 MPix) are far
    // below this.
    if (int64_t(f.width) * f.height > int64_t(1) << 26)
        return E_UNSUPPORTED;
    if (f.tiled || f.planar != 1 || f.bits != 8) return E_UNSUPPORTED;
    if (f.spp != 1 && f.spp != 3 && f.spp != 4) return E_UNSUPPORTED;
    if (f.spp == 1) {
        if (f.photometric > 1) return E_UNSUPPORTED;  // 0/1 = grayscale
    } else if (f.photometric != 2) {
        return E_UNSUPPORTED;  // RGB only (no palette / YCbCr / CMYK)
    }
    if (f.compression != 1 && f.compression != 5 && f.compression != 8 &&
        f.compression != 32946 && f.compression != 32773)
        return E_UNSUPPORTED;
    if (f.predictor != 1 && f.predictor != 2) return E_UNSUPPORTED;
    if (f.strip_offsets.count == 0 || type_size(f.strip_offsets.type) == 0)
        return E_TRUNCATED;
    return OK;
}

// TIFF-variant LZW: MSB-first code packing, ClearCode 256, EOI 257, first
// dynamic code 258, code width bumps one entry EARLY (EarlyChange = 1).
//
// Fast formulation: every table entry's string has already been written to
// the output, so an entry is just an (offset, length) span into dst —
// emission is a span copy (byte-wise forward when it self-overlaps, the
// LZ77 KwKwK case), with no per-code chain walking.  Emissions are
// contiguous, so the entry created for (prev + first(cur)) is exactly the
// span [prev_pos, prev_pos + len(prev) + 1).
int lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
               int64_t* written) {
    std::vector<int64_t> off(4096);
    std::vector<int32_t> len(4096);
    for (int i = 0; i < 256; ++i) len[i] = 1;  // literals: no span needed

    int next = 258, width = 9;
    int64_t bitpos = 0, out = 0;
    int prev_code = -1;
    int64_t prev_pos = 0;

    auto read_code = [&]() -> int {
        if ((bitpos + width) > n * 8) return 257;  // implicit EOI at end
        int64_t byte = bitpos >> 3;
        int shift = int(bitpos & 7);
        uint32_t window = uint32_t(src[byte]) << 16;
        if (byte + 1 < n) window |= uint32_t(src[byte + 1]) << 8;
        if (byte + 2 < n) window |= uint32_t(src[byte + 2]);
        bitpos += width;
        return int((window >> (24 - width - shift)) & ((1u << width) - 1));
    };

    for (;;) {
        int code = read_code();
        if (code == 257) break;  // EOI
        if (code == 256) {       // Clear
            next = 258;
            width = 9;
            prev_code = -1;
            continue;
        }
        if (code > next || code >= 4096) return E_DECOMPRESS;
        if (prev_code < 0) {
            if (code >= 256) return E_DECOMPRESS;  // first code: literal only
            if (out >= cap) break;  // strip may hold more than needed
            dst[out] = uint8_t(code);
            prev_code = code;
            prev_pos = out++;
            continue;
        }
        // create entry next = prev string + first char of current string;
        // its bytes are [prev_pos, out + 1) — out is where cur emits now
        if (next < 4096) {
            off[next] = prev_pos;
            len[next] = len[prev_code] + 1;
            ++next;
        }
        int64_t cur_len = len[code];
        if (out + cur_len > cap) {  // clipped tail: emit what fits, stop
            cur_len = cap - out;
            if (cur_len <= 0) break;
            if (code < 256) dst[out] = uint8_t(code);
            else for (int64_t i = 0; i < cur_len; ++i)
                dst[out + i] = dst[off[code] + i];
            out += cur_len;
            break;
        }
        int64_t p = out;
        if (code < 256) {
            dst[out++] = uint8_t(code);
        } else {
            const int64_t s = off[code];
            if (s + cur_len > p) {  // self-overlapping (KwKwK chains)
                for (int64_t i = 0; i < cur_len; ++i) dst[p + i] = dst[s + i];
            } else {
                std::memcpy(dst + p, dst + s, size_t(cur_len));
            }
            out += cur_len;
        }
        prev_code = code;
        prev_pos = p;
        // EarlyChange: bump width when the NEXT code would not fit
        if (next == 511 && width == 9) width = 10;
        else if (next == 1023 && width == 10) width = 11;
        else if (next == 2047 && width == 11) width = 12;
    }
    *written = out;
    return OK;
}

int packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                    int64_t* written) {
    int64_t i = 0, out = 0;
    while (i < n && out < cap) {
        int8_t h = int8_t(src[i++]);
        if (h >= 0) {
            int64_t cnt = int64_t(h) + 1;
            if (i + cnt > n) return E_TRUNCATED;
            if (out + cnt > cap) cnt = cap - out;
            std::memcpy(dst + out, src + i, size_t(cnt));
            i += int64_t(h) + 1;
            out += cnt;
        } else if (h != -128) {
            int64_t cnt = 1 - int64_t(h);
            if (i >= n) return E_TRUNCATED;
            if (out + cnt > cap) cnt = cap - out;
            std::memset(dst + out, src[i++], size_t(cnt));
            out += cnt;
        }
    }
    *written = out;
    return OK;
}

int zlib_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                int64_t* written) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return E_DECOMPRESS;
    zs.next_in = const_cast<uint8_t*>(src);
    zs.avail_in = uInt(n);
    zs.next_out = dst;
    zs.avail_out = uInt(cap);
    int rc = inflate(&zs, Z_FINISH);
    int64_t out = int64_t(cap) - zs.avail_out;
    inflateEnd(&zs);
    if (rc != Z_STREAM_END && rc != Z_OK && rc != Z_BUF_ERROR)
        return E_DECOMPRESS;
    *written = out;
    return OK;
}

}  // namespace

extern "C" {

// Peek dimensions/format without decoding.  Returns 0 when the file is in
// the supported profile (so the caller can size its buffer and trust that
// decode will not bail on format grounds).
int tiff_info(const uint8_t* data, int64_t len, int64_t* height,
              int64_t* width, int* samples_per_pixel, int* compression) {
    if (len < 4) return E_SIGNATURE;
    Reader r{data, len, false};
    if (data[0] == 'M' && data[1] == 'M') r.be = true;
    else if (!(data[0] == 'I' && data[1] == 'I')) return E_SIGNATURE;

    Info f;
    int rc = parse(r, &f);
    if (rc != OK) return rc;
    rc = check_profile(f);
    if (rc != OK) return rc;
    *height = f.height;
    *width = f.width;
    *samples_per_pixel = f.spp;
    *compression = f.compression;
    return OK;
}

// Decode into out as H*W*3 RGB8 (gray replicated, RGBA alpha dropped).
int tiff_decode_rgb8(const uint8_t* data, int64_t len, uint8_t* out,
                     int64_t out_cap) try {
    if (len < 4) return E_SIGNATURE;
    Reader r{data, len, false};
    if (data[0] == 'M' && data[1] == 'M') r.be = true;
    else if (!(data[0] == 'I' && data[1] == 'I')) return E_SIGNATURE;

    Info f;
    int rc = parse(r, &f);
    if (rc != OK) return rc;
    rc = check_profile(f);
    if (rc != OK) return rc;

    const int64_t W = f.width, H = f.height, spp = f.spp;
    if (out_cap < H * W * 3) return E_BUFSIZE;
    const int64_t row_bytes = W * spp;
    const uint32_t rps = f.rows_per_strip ? f.rows_per_strip : 1;
    const int64_t n_strips =
        (int64_t(H) + rps - 1) / rps;
    if (f.strip_offsets.count < uint32_t(n_strips)) return E_TRUNCATED;

    // validate every strip's offset/count against the file BEFORE any
    // large allocation: a corrupt header must fail cleanly, not OOM
    const size_t ns = size_t(n_strips);
    std::vector<uint32_t> offs(ns), cnts(ns);
    for (int64_t s = 0; s < n_strips; ++s) {
        int64_t rows = (s == n_strips - 1) ? H - s * int64_t(rps) : rps;
        int64_t want = rows * row_bytes;
        if (want <= 0 || want > (int64_t(1) << 31)) return E_UNSUPPORTED;
        uint32_t off = 0, cnt = 0;
        if (!entry_get(r, f.strip_offsets, uint32_t(s), &off))
            return E_TRUNCATED;
        if (f.strip_counts.count > uint32_t(s))
            entry_get(r, f.strip_counts, uint32_t(s), &cnt);
        else if (f.compression == 1)
            cnt = uint32_t(want);  // uncompressed: derivable
        else
            return E_TRUNCATED;
        if (!r.in_bounds(off, cnt)) return E_TRUNCATED;
        offs[size_t(s)] = off;
        cnts[size_t(s)] = cnt;
    }

    // RGB strips decode straight into out (row_bytes == W*3 == out pitch,
    // photometric 2 enforced) — no intermediate buffer, no conversion
    // pass; gray/RGBA go through a sample buffer and convert below
    const bool direct = (spp == 3);
    std::vector<uint8_t> samples;
    if (!direct) samples.resize(size_t(H) * row_bytes);
    uint8_t* const base = direct ? out : samples.data();

    for (int64_t s = 0; s < n_strips; ++s) {
        int64_t rows = (s == n_strips - 1) ? H - s * int64_t(rps) : rps;
        int64_t want = rows * row_bytes;
        const uint32_t off = offs[size_t(s)], cnt = cnts[size_t(s)];
        uint8_t* dst = base + size_t(s) * rps * row_bytes;
        int64_t got = 0;
        switch (f.compression) {
            case 1:
                if (cnt < want) return E_TRUNCATED;
                std::memcpy(dst, r.data + off, size_t(want));
                got = want;
                break;
            case 5:
                rc = lzw_decode(r.data + off, cnt, dst, want, &got);
                break;
            case 8:
            case 32946:
                rc = zlib_decode(r.data + off, cnt, dst, want, &got);
                break;
            case 32773:
                rc = packbits_decode(r.data + off, cnt, dst, want, &got);
                break;
        }
        if (rc != OK) return rc;
        if (got < want) return E_TRUNCATED;

        if (f.predictor == 2) {  // horizontal differencing per row
            for (int64_t y = 0; y < rows; ++y) {
                uint8_t* row = dst + y * row_bytes;
                for (int64_t x = spp; x < row_bytes; ++x)
                    row[x] = uint8_t(row[x] + row[x - spp]);
            }
        }
    }

    if (direct) return OK;  // RGB already in out

    // samples -> RGB8 (gray replicated / inverted, RGBA alpha dropped)
    const bool invert = (spp == 1 && f.photometric == 0);  // WhiteIsZero
    for (int64_t i = 0; i < H * W; ++i) {
        const uint8_t* px = samples.data() + i * spp;
        uint8_t* o = out + i * 3;
        if (spp == 1) {
            uint8_t v = invert ? uint8_t(255 - px[0]) : px[0];
            o[0] = o[1] = o[2] = v;
        } else {
            o[0] = px[0];
            o[1] = px[1];
            o[2] = px[2];  // spp==4: alpha dropped
        }
    }
    return OK;
} catch (...) {
    // never let a C++ exception (e.g. bad_alloc) cross the ctypes FFI
    // boundary — that is undefined behavior and would abort the process
    return E_DECOMPRESS;
}

}  // extern "C"
