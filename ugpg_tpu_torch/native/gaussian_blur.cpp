// Pillow's ImageFilter.GaussianBlur on 8-bit RGB, bit for bit (Pillow
// 12.1.0, libImaging/BoxBlur.c): three passes of an extended box blur along
// the rows, then three along the columns, each pass rounding to uint8.  The
// box radius comes from the Gaussian's sigma as Pillow derives it
// (_gaussian_blur_radius, in Pillow's mix of float and double), and the box
// weights are 24-bit fixed point, the fractional end taps weighted fw.
//
// The offline MoNuSeg augmentation (cli/augment_monuseg.py::_blur) calls
// it; the JAX package calls PIL there.  Built with -ffp-contract=off so
// that no multiply and add fuse where Pillow rounds twice.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

float gaussian_blur_radius(float radius, int passes) {
    float sigma2, L, l, a;
    sigma2 = radius * radius / passes;
    L = std::sqrt(12.0 * sigma2 + 1.0);
    l = std::floor((L - 1.0) / 2.0);
    a = (2 * l + 1) * (l * (l + 1) - 3 * sigma2);
    a /= 6 * (sigma2 - (l + 1) * (l + 1));
    return l + a;
}

// One line of `n` pixels of 3 channels, `stride` bytes from one pixel to
// the next, blurred into `out` (same layout): ImagingLineBoxBlur32.
void line_box_blur(const uint8_t* in, uint8_t* out, int64_t n, int64_t stride, int radius,
                   int64_t edge_a, int64_t edge_b, uint32_t ww, uint32_t fw) {
    const int64_t last = n - 1;
    for (int c = 0; c < 3; ++c) {
        auto px = [&](int64_t x) -> uint32_t { return in[x * stride + c]; };
        uint32_t acc = px(0) * (uint32_t)(radius + 1);
        for (int64_t x = 0; x < edge_a - 1; ++x) acc += px(x);
        acc += px(last) * (uint32_t)(radius - edge_a + 1);
        auto step = [&](int64_t x, int64_t sub, int64_t add, int64_t left, int64_t right) {
            acc += px(add) - px(sub);
            uint32_t bulk = acc * ww + (px(left) + px(right)) * fw;
            out[x * stride + c] = (uint8_t)((bulk + (1u << 23)) >> 24);
        };
        int64_t x = 0;
        if (edge_a <= edge_b) {
            for (; x < edge_a; ++x) step(x, 0, x + radius, 0, x + radius + 1);
            for (; x < edge_b; ++x) step(x, x - radius - 1, x + radius, x - radius - 1,
                                         x + radius + 1);
            for (; x <= last; ++x) step(x, x - radius - 1, last, x - radius - 1, last);
        } else {
            for (; x < edge_b; ++x) step(x, 0, x + radius, 0, x + radius + 1);
            for (; x < edge_a; ++x) step(x, 0, last, 0, last);
            for (; x <= last; ++x) step(x, x - radius - 1, last, x - radius - 1, last);
        }
    }
}

// ImagingHorizontalBoxBlur along `lines` lines of `n` pixels each; a line
// starts `line_stride` bytes after the previous one.
void box_blur_pass(const uint8_t* in, uint8_t* out, int64_t lines, int64_t n,
                   int64_t line_stride, int64_t px_stride, float float_radius) {
    int radius = (int)float_radius;
    uint32_t ww = (uint32_t)((uint32_t)(1 << 24) / (float_radius * 2 + 1));
    uint32_t fw = ((1 << 24) - (radius * 2 + 1) * ww) / 2;
    int64_t edge_a = radius + 1 < n ? radius + 1 : n;
    int64_t edge_b = n - radius - 1 > 0 ? n - radius - 1 : 0;
    for (int64_t y = 0; y < lines; ++y)
        line_box_blur(in + y * line_stride, out + y * line_stride, n, px_stride, radius,
                      edge_a, edge_b, ww, fw);
}

}  // namespace

extern "C" {

// (h, w, 3) uint8 `in` -> `out` (may not alias `in`); returns 0, or -1 on a
// bad argument.
int gaussian_blur_rgb8(const uint8_t* in, uint8_t* out, int64_t h, int64_t w, float radius_x,
                       float radius_y, int passes) {
    if (h < 1 || w < 1 || passes < 1 || !(radius_x >= 0) || !(radius_y >= 0)) return -1;
    const int64_t size = h * w * 3;
    std::memcpy(out, in, size);
    std::vector<uint8_t> tmp(size);
    const float rx = gaussian_blur_radius(radius_x, passes);
    const float ry = gaussian_blur_radius(radius_y, passes);
    if (rx != 0) {
        for (int i = 0; i < passes; ++i) {
            box_blur_pass(out, tmp.data(), h, w, w * 3, 3, rx);
            std::memcpy(out, tmp.data(), size);
        }
    }
    if (ry != 0) {
        for (int i = 0; i < passes; ++i) {
            box_blur_pass(out, tmp.data(), w, h, 3, w * 3, ry);
            std::memcpy(out, tmp.data(), size);
        }
    }
    return 0;
}

}  // extern "C"
