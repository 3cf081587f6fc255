// Anti-aliased polygon rasterizer for sprite-environment rendering.
//
// The sprite envs' rasterizer (the port's copy of ocrl_tpu/native/rasterizer.cpp;
// the JAX package renders with the same code, itself a replacement for
// spriteworld's PILRenderer).  Rendering is the bottleneck of dataset
// collection (1M images for the pretraining set) AND of RL rollouts (one
// render per env step, ~50-200 host envs per PPO iteration), so the hot
// downsample loop is tuned: uint8 id canvas (4x less memory traffic than the
// original int32), and a uniform-block fast path — at aa=10 a 64x64 frame is
// 410k supersamples of which ~85% sit in uniform background/interior blocks
// that resolve with one memcmp-style scan instead of 100 per-sample
// accumulations.
//
// Build: g++ -O3 -shared -fPIC, at first use (ocrl_tpu_torch/native/__init__.py)
// ABI: plain C, consumed via ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Scanline-fill polygons (painter's order) into an id canvas:
// 0 = background, i+1 = polygon i.
template <typename IdT>
void fill_ids(IdT* canvas, int SW, int SH, const double* poly_xy,
              const int* poly_sizes, int n_polys) {
  const double* xy = poly_xy;
  std::vector<double> xs;
  xs.reserve(16);
  for (int p = 0; p < n_polys; ++p) {
    const int n = poly_sizes[p];
    double ymin = 1e30, ymax = -1e30;
    for (int i = 0; i < n; ++i) {
      ymin = std::min(ymin, xy[2 * i + 1]);
      ymax = std::max(ymax, xy[2 * i + 1]);
    }
    int row0 = std::max(0, static_cast<int>(ymin));
    int row1 = std::min(SH - 1, static_cast<int>(ymax) + 1);
    for (int row = row0; row <= row1; ++row) {
      const double yc = row + 0.5;
      xs.clear();
      for (int i = 0; i < n; ++i) {
        const double x0 = xy[2 * i], y0 = xy[2 * i + 1];
        const int j = (i + 1) % n;
        const double x1 = xy[2 * j], y1 = xy[2 * j + 1];
        if ((y0 <= yc && y1 > yc) || (y1 <= yc && y0 > yc)) {
          xs.push_back(x0 + (yc - y0) / (y1 - y0) * (x1 - x0));
        }
      }
      std::sort(xs.begin(), xs.end());
      for (size_t s = 0; s + 1 < xs.size(); s += 2) {
        int xa = std::max(0, static_cast<int>(xs[s] + 0.5));
        int xb = std::min(SW, static_cast<int>(xs[s + 1] + 0.5));
        if (xb > xa) {
          IdT* rowptr = canvas + static_cast<size_t>(row) * SW;
          std::fill(rowptr + xa, rowptr + xb, static_cast<IdT>(p + 1));
        }
      }
    }
    xy += 2 * n;
  }
}

template <typename IdT>
void downsample(const IdT* canvas, uint8_t* out, int W, int H, int aa,
                const uint8_t* colors, int n_polys, const uint8_t* bg) {
  const int SW = W * aa;
  const int area = aa * aa;
  // id -> color lookup with background in slot 0 (per-pixel bg handled in
  // the accumulation path; the fast path uses it only when bg is flat black
  // or the block id is non-zero)
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      const IdT* block = canvas + (static_cast<size_t>(y) * aa) * SW + x * aa;
      // uniform-block fast path
      const IdT first = block[0];
      bool uniform = true;
      for (int sy = 0; sy < aa && uniform; ++sy) {
        const IdT* rowptr = block + static_cast<size_t>(sy) * SW;
        for (int sx = 0; sx < aa; ++sx) {
          if (rowptr[sx] != first) {
            uniform = false;
            break;
          }
        }
      }
      uint8_t* o = out + (static_cast<size_t>(y) * W + x) * 3;
      if (uniform) {
        if (first == 0) {
          if (bg != nullptr) {
            const uint8_t* b = bg + (static_cast<size_t>(y) * W + x) * 3;
            o[0] = b[0];
            o[1] = b[1];
            o[2] = b[2];
          } else {
            o[0] = o[1] = o[2] = 0;
          }
        } else {
          const uint8_t* c = colors + (first - 1) * 3;
          o[0] = c[0];
          o[1] = c[1];
          o[2] = c[2];
        }
        continue;
      }
      // mixed block: count samples per id, then blend counts x colors
      uint32_t cnt[256];
      std::memset(cnt, 0, sizeof(uint32_t) * (n_polys + 1));
      for (int sy = 0; sy < aa; ++sy) {
        const IdT* rowptr = block + static_cast<size_t>(sy) * SW;
        for (int sx = 0; sx < aa; ++sx) {
          ++cnt[rowptr[sx]];
        }
      }
      uint32_t acc[3] = {0, 0, 0};
      if (cnt[0] != 0) {
        if (bg != nullptr) {
          const uint8_t* b = bg + (static_cast<size_t>(y) * W + x) * 3;
          acc[0] += cnt[0] * b[0];
          acc[1] += cnt[0] * b[1];
          acc[2] += cnt[0] * b[2];
        }
      }
      for (int id = 1; id <= n_polys; ++id) {
        if (cnt[id] != 0) {
          const uint8_t* c = colors + (id - 1) * 3;
          acc[0] += cnt[id] * c[0];
          acc[1] += cnt[id] * c[1];
          acc[2] += cnt[id] * c[2];
        }
      }
      o[0] = static_cast<uint8_t>(acc[0] / area);
      o[1] = static_cast<uint8_t>(acc[1] / area);
      o[2] = static_cast<uint8_t>(acc[2] / area);
    }
  }
}

}  // namespace

extern "C" {

// Renders n_polys filled polygons (painter's order) onto an RGB canvas.
//   out:        H*W*3 uint8, row-major, written fully
//   bg:         H*W*3 uint8 background or nullptr (black)
//   poly_xy:    concatenated vertices (x, y) in PIXEL coords of the
//               SUPERSAMPLED canvas (W*aa x H*aa)
//   poly_sizes: vertex count per polygon
//   colors:     n_polys * 3 uint8
void render_polygons(uint8_t* out, int W, int H, int aa,
                     const double* poly_xy, const int* poly_sizes,
                     const uint8_t* colors, int n_polys,
                     const uint8_t* bg) {
  const int SW = W * aa, SH = H * aa;
  if (n_polys <= 254) {
    // thread-local scratch: skip the per-call allocation, memset is cheap
    // on the uint8 canvas
    thread_local std::vector<uint8_t> canvas8;
    canvas8.assign(static_cast<size_t>(SW) * SH, 0);
    fill_ids(canvas8.data(), SW, SH, poly_xy, poly_sizes, n_polys);
    downsample(canvas8.data(), out, W, H, aa, colors, n_polys, bg);
  } else {
    std::vector<int32_t> canvas32(static_cast<size_t>(SW) * SH, 0);
    fill_ids(canvas32.data(), SW, SH, poly_xy, poly_sizes, n_polys);
    // int32 path reuses the same blend logic via a widened counter table
    const int area = aa * aa;
    for (int y = 0; y < H; ++y) {
      for (int x = 0; x < W; ++x) {
        uint32_t acc[3] = {0, 0, 0};
        for (int sy = 0; sy < aa; ++sy) {
          const int32_t* rowptr =
              canvas32.data() + (static_cast<size_t>(y) * aa + sy) * SW + x * aa;
          for (int sx = 0; sx < aa; ++sx) {
            const int32_t id = rowptr[sx];
            if (id == 0) {
              if (bg != nullptr) {
                const uint8_t* b = bg + (static_cast<size_t>(y) * W + x) * 3;
                acc[0] += b[0];
                acc[1] += b[1];
                acc[2] += b[2];
              }
            } else {
              const uint8_t* c = colors + (id - 1) * 3;
              acc[0] += c[0];
              acc[1] += c[1];
              acc[2] += c[2];
            }
          }
        }
        uint8_t* o = out + (static_cast<size_t>(y) * W + x) * 3;
        o[0] = static_cast<uint8_t>(acc[0] / area);
        o[1] = static_cast<uint8_t>(acc[1] / area);
        o[2] = static_cast<uint8_t>(acc[2] / area);
      }
    }
  }
}

}  // extern "C"
