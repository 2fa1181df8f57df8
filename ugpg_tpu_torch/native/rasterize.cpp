// Native polygon rasterizers for the MoNuSeg annotation -> mask path.
//
// Two fills, each over all polygons of an image in one call:
//
// * rasterize_polygons_pil: Pillow's filled polygon, bit for bit —
//   ImageDraw.polygon(xy, fill=1) with no outline on an "L" image (Pillow's
//   libImaging/Draw.c: vertices cast to int (toward zero), an edge
//   list that merges runs of collinear horizontal edges, a float32 scanline
//   over rows ymin..ymax with its corner rules, spans
//   [round-half-up(x0), round-half-down(x1)], horizontal edges drawn as
//   lines).  This is the fill the reference's masks come from.
// * rasterize_polygons / rasterize_batch: the even-odd scanline below,
//   which differs from Pillow on boundary rows and columns.
//
// The reference rasterizes XML polygon annotations with PIL's filled-polygon
// routine per image (ref: MoNuSegImprove/monuseg_dataset.py:97-135) — a
// Python-level loop over ~700 nuclei per 1000x1000 tile.  This is the
// framework's native equivalent: an even-odd scanline fill over all polygons
// of an image in one call, plus an OpenMP-free thread-pooled batch API for
// offline patch extraction.  Exposed through a C ABI consumed via ctypes
// (ugpg_tpu_torch/native/__init__.py); the even-odd fill matches the numpy
// backend of ugpg_tpu_torch/data/rasterize.py exactly (span = [ceil(x0), floor(x1)] at
// integer scanlines, even-odd rule).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off -o librasterize.so rasterize.cpp -lpthread

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Fill one polygon (n vertices, xy interleaved) into mask (h x w), value 1.
void fill_polygon(const double* xy, int64_t n, uint8_t* mask, int64_t h,
                  int64_t w) {
  if (n < 3) return;
  double ymin = xy[1], ymax = xy[1];
  for (int64_t i = 1; i < n; ++i) {
    ymin = std::min(ymin, xy[2 * i + 1]);
    ymax = std::max(ymax, xy[2 * i + 1]);
  }
  int64_t y0 = std::max<int64_t>(static_cast<int64_t>(std::floor(ymin)), 0);
  int64_t y1 = std::min<int64_t>(static_cast<int64_t>(std::ceil(ymax)), h - 1);

  std::vector<double> xs;
  xs.reserve(16);
  for (int64_t y = y0; y <= y1; ++y) {
    const double yc = static_cast<double>(y);
    xs.clear();
    for (int64_t i = 0; i < n; ++i) {
      const double xa = xy[2 * i], ya = xy[2 * i + 1];
      const int64_t j = (i + 1) % n;
      const double xb = xy[2 * j], yb = xy[2 * j + 1];
      if ((ya <= yc && yc < yb) || (yb <= yc && yc < ya)) {
        const double t = (yc - ya) / (yb - ya);
        xs.push_back(xa + t * (xb - xa));
      }
    }
    std::sort(xs.begin(), xs.end());
    for (size_t k = 0; k + 1 < xs.size(); k += 2) {
      int64_t a = std::max<int64_t>(
          static_cast<int64_t>(std::ceil(xs[k])), 0);
      int64_t b = std::min<int64_t>(
          static_cast<int64_t>(std::floor(xs[k + 1])), w - 1);
      if (b >= a) std::memset(mask + y * w + a, 1, static_cast<size_t>(b - a + 1));
    }
  }
}

// ---------------------------------------------------------------------------
// Pillow's polygon fill.  Everything below keeps Pillow's types: int vertex
// coordinates, a float32 slope and float32 scanline intersections, so that
// every rounding happens where Pillow's does (build with -ffp-contract=off:
// a fused multiply-add would round once where Pillow rounds twice).

struct Edge {
  int d;
  int x0, y0;
  int xmin, ymin, xmax, ymax;
  float dx;
};

// Pillow's ROUND_UP and ROUND_DOWN on a float: half away from zero and half
// toward zero, computed in float for f >= 0 and in double for f < 0, as
// Pillow's build of those macros does.
inline int round_up(float f) {
  return f >= 0.0f ? static_cast<int>(std::floor(f + 0.5f))
                   : -static_cast<int>(std::floor(static_cast<double>(std::fabs(f)) + 0.5));
}

inline int round_down(float f) {
  return f >= 0.0f ? static_cast<int>(std::ceil(f - 0.5f))
                   : -static_cast<int>(std::ceil(static_cast<double>(std::fabs(f)) - 0.5));
}

void add_edge(Edge* e, int x0, int y0, int x1, int y1) {
  if (x0 <= x1) {
    e->xmin = x0, e->xmax = x1;
  } else {
    e->xmin = x1, e->xmax = x0;
  }
  if (y0 <= y1) {
    e->ymin = y0, e->ymax = y1;
  } else {
    e->ymin = y1, e->ymax = y0;
  }
  if (y0 == y1) {
    e->d = 0;
    e->dx = 0.0f;
  } else {
    e->dx = static_cast<float>(x1 - x0) / static_cast<float>(y1 - y0);
    e->d = y0 == e->ymin ? 1 : -1;
  }
  e->x0 = x0;
  e->y0 = y0;
}

inline void hline(uint8_t* mask, int64_t h, int64_t w, int x0, int y0, int x1) {
  if (y0 < 0 || y0 >= h) return;
  if (x0 < 0) {
    x0 = 0;
  } else if (x0 >= w) {
    return;
  }
  if (x1 < 0) return;
  if (x1 >= w) x1 = static_cast<int>(w - 1);
  if (x0 <= x1) std::memset(mask + y0 * w + x0, 1, static_cast<size_t>(x1 - x0 + 1));
}

inline float edge_x(const Edge* e, int y) {
  return static_cast<float>(y - e->y0) * e->dx + static_cast<float>(e->x0);
}

// Pillow's polygon_generic for an 8-bit image with no alpha.
void polygon_generic(uint8_t* mask, int64_t h, int64_t w, int n, Edge* e,
                     std::vector<Edge*>& edge_table, std::vector<float>& xx) {
  if (n <= 0) return;
  edge_table.assign(static_cast<size_t>(n), nullptr);
  int edge_count = 0;
  int ymin = static_cast<int>(h - 1);
  int ymax = 0;
  for (int i = 0; i < n; ++i) {
    if (ymin > e[i].ymin) ymin = e[i].ymin;
    if (ymax < e[i].ymax) ymax = e[i].ymax;
    if (e[i].ymin == e[i].ymax) {
      hline(mask, h, w, e[i].xmin, e[i].ymin, e[i].xmax);
      continue;
    }
    edge_table[edge_count++] = e + i;
  }
  if (ymin < 0) ymin = 0;
  if (ymax > h) ymax = static_cast<int>(h);
  xx.assign(static_cast<size_t>(edge_count) * 2, 0.0f);
  for (; ymin <= ymax; ++ymin) {
    int j = 0;
    for (int i = 0; i < edge_count; ++i) {
      Edge* current = edge_table[i];
      if (ymin >= current->ymin && ymin <= current->ymax) {
        xx[j++] = edge_x(current, ymin);
        if (ymin == current->ymax && ymin < ymax) {
          // needed to draw consistent polygons
          xx[j] = xx[j - 1];
          j++;
        } else if (i > 0 && current->dx != 0 &&
                   (ymin == current->ymin || ymin == current->ymax)) {
          // connect discontiguous corners: where this edge meets an earlier
          // one at this row, both with a slope, pull this intersection to
          // one pixel past both edges' points on the adjacent row, when it
          // lies more than a pixel beyond both of them
          const int adjacent_y = ymin == current->ymax ? ymin - 1 : ymin + 1;
          const float x = xx[j - 1];
          for (int k = 0; k < i; ++k) {
            const Edge* other = edge_table[k];
            if ((ymin != other->ymin && ymin != other->ymax) || other->dx == 0) continue;
            if (std::roundf(x) != std::roundf(edge_x(other, ymin))) continue;
            if (adjacent_y < other->ymin || adjacent_y > other->ymax) continue;
            const float adjacent = edge_x(current, adjacent_y);
            const float adjacent_other = edge_x(other, adjacent_y);
            if (x > adjacent + 1.0f && x > adjacent_other + 1.0f) {
              xx[j - 1] = std::roundf(static_cast<float>(
                  std::fmax(static_cast<double>(adjacent_other), static_cast<double>(adjacent)))) + 1.0f;
            } else if (adjacent - 1.0f > x && adjacent_other - 1.0f > x) {
              xx[j - 1] = std::roundf(static_cast<float>(
                  std::fmin(static_cast<double>(adjacent_other), static_cast<double>(adjacent)))) - 1.0f;
            }
            break;
          }
        }
      }
    }
    std::sort(xx.begin(), xx.begin() + j);
    for (int i = 1; i < j; i += 2) {
      const int x_start = round_up(xx[i - 1]);
      const int x_end = round_down(xx[i]);
      if (x_end < x_start) continue;
      hline(mask, h, w, x_start, ymin, x_end);
    }
  }
}

// Pillow's ImagingDrawPolygon with fill: the edge list, then the scanline.
void fill_polygon_pil(const double* xy_in, int64_t count, uint8_t* mask, int64_t h,
                      int64_t w, std::vector<int>& xy, std::vector<Edge>& e,
                      std::vector<Edge*>& edge_table, std::vector<float>& xx) {
  if (count <= 0) return;
  xy.resize(static_cast<size_t>(2 * count));
  for (int64_t i = 0; i < 2 * count; ++i) xy[i] = static_cast<int>(xy_in[i]);  // C's cast: toward zero
  e.assign(static_cast<size_t>(count), Edge{});
  int n = 0;
  int64_t i = 0;
  for (; i < count - 1; ++i) {
    const int x0 = xy[i * 2], y0 = xy[i * 2 + 1];
    const int x1 = xy[i * 2 + 2], y1 = xy[i * 2 + 3];
    if (y0 == y1 && i != 0 && y0 == xy[i * 2 - 1]) {
      // a horizontal edge right after another horizontal edge
      Edge* last = &e[n - 1];
      if (x1 > x0 && x0 > xy[i * 2 - 2]) {  // both increasing in x
        last->xmax = x1;
        continue;
      } else if (x1 < x0 && x0 < xy[i * 2 - 2]) {  // both decreasing in x
        last->xmin = x1;
        continue;
      }
    }
    add_edge(&e[n++], x0, y0, x1, y1);
  }
  if (xy[i * 2] != xy[0] || xy[i * 2 + 1] != xy[1]) {
    add_edge(&e[n++], xy[i * 2], xy[i * 2 + 1], xy[0], xy[1]);
  }
  polygon_generic(mask, h, w, n, e.data(), edge_table, xx);
}

}  // namespace

extern "C" {

// Pillow's fill of n_polys polygons, in order, into one zeroed (h, w) mask;
// vertices and offsets as for rasterize_polygons.
void rasterize_polygons_pil(const double* vertices, const int64_t* offsets,
                            int64_t n_polys, uint8_t* mask, int64_t h, int64_t w) {
  std::memset(mask, 0, static_cast<size_t>(h * w));
  std::vector<int> xy;
  std::vector<Edge> e;
  std::vector<Edge*> edge_table;
  std::vector<float> xx;
  for (int64_t p = 0; p < n_polys; ++p) {
    const int64_t start = offsets[p];
    fill_polygon_pil(vertices + 2 * start, offsets[p + 1] - start, mask, h, w, xy, e,
                     edge_table, xx);
  }
}

// Rasterize n_polys polygons into one (h, w) uint8 mask.
//   vertices:  xy-interleaved doubles, concatenated over polygons
//   offsets:   n_polys+1 prefix offsets into `vertices` (in vertex units)
void rasterize_polygons(const double* vertices, const int64_t* offsets,
                        int64_t n_polys, uint8_t* mask, int64_t h, int64_t w) {
  std::memset(mask, 0, static_cast<size_t>(h * w));
  for (int64_t p = 0; p < n_polys; ++p) {
    const int64_t start = offsets[p];
    const int64_t count = offsets[p + 1] - start;
    fill_polygon(vertices + 2 * start, count, mask, h, w);
  }
}

// Rasterize a batch of images in parallel: image i owns polygons
// [image_offsets[i], image_offsets[i+1]) and writes masks + i*h*w.
void rasterize_batch(const double* vertices, const int64_t* poly_offsets,
                     const int64_t* image_offsets, int64_t n_images,
                     uint8_t* masks, int64_t h, int64_t w, int64_t n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  std::vector<std::thread> pool;
  std::vector<int64_t> next(1, 0);
  auto worker = [&](int64_t tid) {
    for (int64_t img = tid; img < n_images; img += n_threads) {
      uint8_t* mask = masks + img * h * w;
      std::memset(mask, 0, static_cast<size_t>(h * w));
      for (int64_t p = image_offsets[img]; p < image_offsets[img + 1]; ++p) {
        const int64_t start = poly_offsets[p];
        const int64_t count = poly_offsets[p + 1] - start;
        fill_polygon(vertices + 2 * start, count, mask, h, w);
      }
    }
  };
  for (int64_t t = 1; t < n_threads; ++t) pool.emplace_back(worker, t);
  worker(0);
  for (auto& th : pool) th.join();
}

}  // extern "C"
