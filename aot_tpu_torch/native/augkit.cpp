// augkit: native CPU kernels for the static-image augmentation pipeline.
//
// The reference framework leans on torch's C++ DataLoader machinery plus
// PIL/torchvision C ops for its CPU-side augmentation (reference:
// dataloaders/image_transforms.py, train_datasets.py:177-229). This is the
// TPU build's native equivalent: the per-frame chain
//     affine-warp -> color jitter -> resized-crop
// collapses into ONE inverse bilinear warp (the affine and crop maps are
// composed into a single 2x3 matrix host-side) followed by single-pass
// pixel ops at OUTPUT resolution, instead of three full-resolution PIL
// resamplings plus six PIL mode conversions per frame.
//
// Pure C++17, no Python.h: loaded via ctypes (aot_tpu/native/__init__.py).
// All images are uint8 HxWxC row-major.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// warp_affine_u8: dst(y, x) = src(M @ (x+.5, y+.5) - .5), bilinear or
// nearest, constant fill outside. M is the 2x3 INVERSE map (output->input),
// PIL Image.transform convention (coefficients act on pixel-corner
// coordinates, i.e. x+0.5).
// ---------------------------------------------------------------------------
static inline void bilinear_px(const uint8_t* src, int sh, int sw, int ch,
                               float sx, float sy, const uint8_t* fill,
                               uint8_t* px) {
  const int x0 = (int)std::floor(sx), y0 = (int)std::floor(sy);
  if (x0 < -1 || y0 < -1 || x0 >= sw || y0 >= sh) {
    std::memcpy(px, fill, ch);
    return;
  }
  const float fx = sx - x0, fy = sy - y0;
  const int x1 = x0 + 1, y1 = y0 + 1;
  const float w00 = (1 - fx) * (1 - fy), w01 = fx * (1 - fy);
  const float w10 = (1 - fx) * fy, w11 = fx * fy;
  for (int c = 0; c < ch; ++c) {
    // taps off the edge read the fill value (PIL constant-fill border)
    const float v00 = (x0 >= 0 && y0 >= 0)
        ? src[((size_t)y0 * sw + x0) * ch + c] : fill[c];
    const float v01 = (x1 < sw && y0 >= 0)
        ? src[((size_t)y0 * sw + x1) * ch + c] : fill[c];
    const float v10 = (x0 >= 0 && y1 < sh)
        ? src[((size_t)y1 * sw + x0) * ch + c] : fill[c];
    const float v11 = (x1 < sw && y1 < sh)
        ? src[((size_t)y1 * sw + x1) * ch + c] : fill[c];
    const float v = w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11;
    px[c] = (uint8_t)std::min(255.0f, std::max(0.0f, v + 0.5f));
  }
}

void warp_affine_u8(const uint8_t* src, int sh, int sw, int ch,
                    const double* m, uint8_t* dst, int dh, int dw,
                    const uint8_t* fill, int bilinear) {
  const float m0 = (float)m[0], m3 = (float)m[3];
  for (int y = 0; y < dh; ++y) {
    const double yy = y + 0.5;
    // per-row constants of the affine map (sampling offset -0.5 folded in)
    const float bx = (float)(m[1] * yy + m[2] - 0.5);
    const float by = (float)(m[4] * yy + m[5] - 0.5);
    uint8_t* row = dst + (size_t)y * dw * ch;
    if (bilinear) {
      // The source position is linear in x, so the span of x whose 2x2
      // tap window lies strictly inside the image is one interval
      // [x_in0, x_in1): border-checked loops outside, a branch-free
      // tight loop inside (the overwhelmingly common case).
      int x_in0 = dw, x_in1 = 0;
      {
        // require 0 <= floor(s) and floor(s)+1 <= dim-1  =>  s in [0, dim-1];
        // shrink by 1e-3 so float rounding can never push a tap off the
        // image (edge pixels fall to the border-checked loops instead)
        float lo_x = 1e-3f, hi_x = (float)(sw - 1) - 1e-3f;
        float lo_y = 1e-3f, hi_y = (float)(sh - 1) - 1e-3f;
        double a0 = -1e30, b0 = 1e30;  // interval in xx = x+0.5
        auto clipi = [&](double coef, double off, double lo, double hi) {
          if (coef > 1e-12) {
            a0 = std::max(a0, (lo - off) / coef);
            b0 = std::min(b0, (hi - off) / coef);
          } else if (coef < -1e-12) {
            a0 = std::max(a0, (hi - off) / coef);
            b0 = std::min(b0, (lo - off) / coef);
          } else if (off < lo || off > hi) {
            b0 = a0 - 1;  // empty
          }
        };
        clipi(m0, bx, lo_x, hi_x);
        clipi(m3, by, lo_y, hi_y);
        if (b0 >= a0) {
          x_in0 = std::max(0, (int)std::ceil(a0 - 0.5 + 1e-6));
          x_in1 = std::min(dw, (int)std::floor(b0 - 0.5 - 1e-6) + 1);
        }
        if (x_in1 < x_in0) { x_in0 = dw; x_in1 = dw; }
      }
      for (int x = 0; x < std::min(x_in0, dw); ++x) {
        const float xx = x + 0.5f;
        bilinear_px(src, sh, sw, ch, m0 * xx + bx, m3 * xx + by, fill,
                    row + (size_t)x * ch);
      }
      if (ch == 3) {
        for (int x = x_in0; x < x_in1; ++x) {
          const float xx = x + 0.5f;
          const float sx = m0 * xx + bx, sy = m3 * xx + by;
          const int x0 = (int)sx, y0 = (int)sy;  // inside => non-negative
          const float fx = sx - x0, fy = sy - y0;
          const float w00 = (1 - fx) * (1 - fy), w01 = fx * (1 - fy);
          const float w10 = (1 - fx) * fy, w11 = fx * fy;
          const uint8_t* p00 = src + ((size_t)y0 * sw + x0) * 3;
          const uint8_t* p10 = p00 + (size_t)sw * 3;
          uint8_t* px = row + (size_t)x * 3;
          px[0] = (uint8_t)(w00 * p00[0] + w01 * p00[3] + w10 * p10[0] +
                            w11 * p10[3] + 0.5f);
          px[1] = (uint8_t)(w00 * p00[1] + w01 * p00[4] + w10 * p10[1] +
                            w11 * p10[4] + 0.5f);
          px[2] = (uint8_t)(w00 * p00[2] + w01 * p00[5] + w10 * p10[2] +
                            w11 * p10[5] + 0.5f);
        }
      } else {
        for (int x = x_in0; x < x_in1; ++x) {
          const float xx = x + 0.5f;
          const float sx = m0 * xx + bx, sy = m3 * xx + by;
          const int x0 = (int)sx, y0 = (int)sy;
          const float fx = sx - x0, fy = sy - y0;
          const float w00 = (1 - fx) * (1 - fy), w01 = fx * (1 - fy);
          const float w10 = (1 - fx) * fy, w11 = fx * fy;
          for (int c = 0; c < ch; ++c) {
            const uint8_t* p00 = src + ((size_t)y0 * sw + x0) * ch + c;
            const uint8_t* p10 = p00 + (size_t)sw * ch;
            row[(size_t)x * ch + c] = (uint8_t)(
                w00 * p00[0] + w01 * p00[ch] + w10 * p10[0] +
                w11 * p10[ch] + 0.5f);
          }
        }
      }
      for (int x = std::max(x_in1, x_in0); x < dw; ++x) {
        const float xx = x + 0.5f;
        bilinear_px(src, sh, sw, ch, m0 * xx + bx, m3 * xx + by, fill,
                    row + (size_t)x * ch);
      }
    } else {  // nearest
      for (int x = 0; x < dw; ++x) {
        const float xx = x + 0.5f;
        const float sx = m0 * xx + bx, sy = m3 * xx + by;
        uint8_t* px = row + (size_t)x * ch;
        const int xn = (int)std::floor(sx + 0.5f),
                  yn = (int)std::floor(sy + 0.5f);
        if (xn < 0 || yn < 0 || xn >= sw || yn >= sh) {
          std::memcpy(px, fill, ch);
        } else {
          std::memcpy(px, src + ((size_t)yn * sw + xn) * ch, ch);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Color ops. All single-pass in-place on HxWx3 uint8, mirroring
// PIL.ImageEnhance semantics: out = degenerate*(1-f) + img*f, rounded,
// clipped. Luma uses PIL convert("L") ITU-R 601-2 integer coefficients
// L = (R*299 + G*587 + B*114) / 1000.
// ---------------------------------------------------------------------------
static inline uint8_t clip_u8(double v) {
  return (uint8_t)std::min(255.0, std::max(0.0, v + 0.5));
}

static inline int luma_l(const uint8_t* p) {
  return (p[0] * 299 + p[1] * 587 + p[2] * 114) / 1000;
}

void brightness_u8(uint8_t* img, int64_t n_px, double f) {
  // blend with black: a pure scale -> 256-entry LUT
  uint8_t lut[256];
  for (int i = 0; i < 256; ++i) lut[i] = clip_u8(i * f);
  uint8_t* end = img + n_px * 3;
  for (uint8_t* p = img; p < end; ++p) *p = lut[*p];
}

// PIL Contrast: degenerate = solid gray at round(mean of L channel)
void contrast_u8(uint8_t* img, int64_t n_px, double f) {
  int64_t sum = 0;
  for (int64_t i = 0; i < n_px; ++i) sum += luma_l(img + i * 3);
  const int mean = (int)((double)sum / n_px + 0.5);
  uint8_t lut[256];
  for (int i = 0; i < 256; ++i) lut[i] = clip_u8(mean + (i - mean) * f);
  uint8_t* end = img + n_px * 3;
  for (uint8_t* p = img; p < end; ++p) *p = lut[*p];
}

// PIL Color (saturation): degenerate = per-pixel grayscale L
void saturation_u8(uint8_t* img, int64_t n_px, double f) {
  for (int64_t i = 0; i < n_px; ++i) {
    uint8_t* p = img + i * 3;
    const int l = luma_l(p);
    p[0] = clip_u8(l + (p[0] - l) * f);
    p[1] = clip_u8(l + (p[1] - l) * f);
    p[2] = clip_u8(l + (p[2] - l) * f);
  }
}

// Hue rotation through PIL's uint8 HSV space: convert with PIL's exact
// integer-friendly formulas (libImaging/Convert.c rgb2hsv/hsv2rgb), add
// shift mod 256 to H, convert back.
void hue_u8(uint8_t* img, int64_t n_px, int shift) {
  if (shift == 0) return;
  for (int64_t i = 0; i < n_px; ++i) {
    uint8_t* p = img + i * 3;
    const int r = p[0], g = p[1], b = p[2];
    const int maxc = std::max(r, std::max(g, b));
    const int minc = std::min(r, std::min(g, b));
    int h;
    const int v = maxc;
    int s;
    if (maxc == minc) {
      h = 0;
      s = 0;
    } else {
      // PIL Convert.c rgb2hsv_row: float ratios, TRUNCATED to uint8
      const float rcr = 1.0f / (maxc - minc);
      s = (int)(255.0f * ((float)(maxc - minc) / maxc));
      float hh;
      const float rc = (maxc - r) * rcr, gc = (maxc - g) * rcr,
                  bc = (maxc - b) * rcr;
      if (r == maxc) hh = bc - gc;
      else if (g == maxc) hh = 2.0f + rc - bc;
      else hh = 4.0f + gc - rc;
      hh *= (1.0f / 6.0f);
      if (hh < 0) hh += 1.0f;
      if (hh >= 1.0f) hh -= 1.0f;
      h = (int)(hh * 255.0f);
    }
    h = (h + shift) & 255;
    // hsv2rgb (PIL): h in 0..255 maps to 0..360 degrees
    if (s == 0) {
      p[0] = p[1] = p[2] = (uint8_t)v;
      continue;
    }
    const float dh = h * (6.0f / 255.0f);
    int ih = (int)dh;
    const float fr = dh - ih;
    const float vs = v * (1.0f / 255.0f);
    const int pp = (int)(vs * (255 - s) + 0.5f);
    const int qq = (int)(vs * (255 - s * fr) + 0.5f);
    const int tt = (int)(vs * (255 - s * (1.0f - fr)) + 0.5f);
    ih = ih % 6;
    switch (ih) {
      case 0: p[0] = v;  p[1] = tt; p[2] = pp; break;
      case 1: p[0] = qq; p[1] = v;  p[2] = pp; break;
      case 2: p[0] = pp; p[1] = v;  p[2] = tt; break;
      case 3: p[0] = pp; p[1] = qq; p[2] = v;  break;
      case 4: p[0] = tt; p[1] = pp; p[2] = v;  break;
      default: p[0] = v; p[1] = pp; p[2] = qq; break;
    }
  }
}

// grayscale: img.convert("L").convert("RGB")
void grayscale_u8(uint8_t* img, int64_t n_px) {
  for (int64_t i = 0; i < n_px; ++i) {
    uint8_t* p = img + i * 3;
    const uint8_t l = (uint8_t)luma_l(p);
    p[0] = p[1] = p[2] = l;
  }
}

// ---------------------------------------------------------------------------
// relabel_u8: out[px] = new_id where mask[px] == obj_list[new_id-1], else 0
// (the hot inner loop of to_onehot_relabel; one pass via a 256-entry LUT).
// ---------------------------------------------------------------------------
void relabel_u8(const uint8_t* mask, int64_t n_px, const uint8_t* obj_list,
                int n_obj, uint8_t* out) {
  uint8_t lut[256];
  std::memset(lut, 0, sizeof(lut));
  for (int k = 0; k < n_obj; ++k) lut[obj_list[k]] = (uint8_t)(k + 1);
  for (int64_t i = 0; i < n_px; ++i) out[i] = lut[mask[i]];
}

}  // extern "C"
