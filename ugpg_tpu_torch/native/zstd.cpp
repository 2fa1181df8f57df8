// zstd frames (RFC 8878) through the system's libzstd, and CRC-32C
// (Castagnoli) for the OCDBT files of orbax checkpoints.
//
// The library is linked by its soname, libzstd.so.1: Ubuntu's dpkg depends
// on it, so every machine of the port has it, but not every one has its
// development header.  The few entry points used here are zstd's stable
// API, declared below as zstd.h declares them; the error code is
// ZSTD_ErrorCode, an enum, passed as an int.

#include <cstddef>
#include <cstdint>

extern "C" {
size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src, size_t srcSize,
                     int compressionLevel);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src, size_t compressedSize);
size_t ZSTD_compressBound(size_t srcSize);
unsigned long long ZSTD_getFrameContentSize(const void* src, size_t srcSize);
unsigned ZSTD_isError(size_t code);
int ZSTD_getErrorCode(size_t functionResult);
unsigned ZSTD_versionNumber(void);
}

namespace {

constexpr int kDstSizeTooSmall = 70;  // ZSTD_error_dstSize_tooSmall
constexpr unsigned long long kContentSizeUnknown = 0ULL - 1;
constexpr unsigned long long kContentSizeError = 0ULL - 2;

// CRC-32C, reflected polynomial 0x82F63B78, eight bytes a step
// (tables filled when the library loads)
uint32_t g_crc_table[8][256];

struct CrcTables {
  CrcTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      g_crc_table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int t = 1; t < 8; ++t)
        g_crc_table[t][i] =
            (g_crc_table[t - 1][i] >> 8) ^ g_crc_table[0][g_crc_table[t - 1][i] & 0xff];
  }
} g_crc_tables;

}  // namespace

extern "C" {

// libzstd's version as ZSTD_versionNumber gives it (10505 for 1.5.5)
int zstd_version() { return static_cast<int>(ZSTD_versionNumber()); }

// worst-case size of one frame of n bytes
int64_t zstd_compress_bound(int64_t n) {
  return n < 0 ? -1 : static_cast<int64_t>(ZSTD_compressBound(static_cast<size_t>(n)));
}

// one frame of src at level into dst; -> its size, or -1
int64_t zstd_compress(uint8_t* dst, int64_t cap, const uint8_t* src, int64_t n, int level) {
  if (cap < 0 || n < 0) return -1;
  size_t r = ZSTD_compress(dst, static_cast<size_t>(cap), src, static_cast<size_t>(n), level);
  return ZSTD_isError(r) ? -1 : static_cast<int64_t>(r);
}

// the first frame's declared content size; -1 if the frame does not
// declare it, -2 if src does not start with a frame
int64_t zstd_content_size(const uint8_t* src, int64_t n) {
  if (n < 0) return -2;
  unsigned long long r = ZSTD_getFrameContentSize(src, static_cast<size_t>(n));
  if (r == kContentSizeUnknown) return -1;
  if (r == kContentSizeError || r > static_cast<unsigned long long>(INT64_MAX)) return -2;
  return static_cast<int64_t>(r);
}

// every frame of src into dst; *written gets the decoded size.  0 on
// success, 1 if dst is too small (retry larger), -1 on corrupt input
int zstd_decompress(uint8_t* dst, int64_t cap, const uint8_t* src, int64_t n,
                    int64_t* written) {
  if (cap < 0 || n < 0) return -1;
  size_t r = ZSTD_decompress(dst, static_cast<size_t>(cap), src, static_cast<size_t>(n));
  if (ZSTD_isError(r)) return ZSTD_getErrorCode(r) == kDstSizeTooSmall ? 1 : -1;
  *written = static_cast<int64_t>(r);
  return 0;
}

// CRC-32C of n bytes, continuing from crc (0 to start)
uint32_t crc32c(const uint8_t* p, int64_t n, uint32_t crc) {
  uint32_t c = ~crc;
  while (n >= 8) {
    uint32_t lo = c ^ (uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
                       uint32_t(p[3]) << 24);
    c = g_crc_table[7][lo & 0xff] ^ g_crc_table[6][(lo >> 8) & 0xff] ^
        g_crc_table[5][(lo >> 16) & 0xff] ^ g_crc_table[4][lo >> 24] ^ g_crc_table[3][p[4]] ^
        g_crc_table[2][p[5]] ^ g_crc_table[1][p[6]] ^ g_crc_table[0][p[7]];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) c = (c >> 8) ^ g_crc_table[0][(c ^ *p++) & 0xff];
  return ~c;
}

}  // extern "C"
