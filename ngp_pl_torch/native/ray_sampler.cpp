// Host-side data path of the port: batch sampling, image ingest and the
// PNG row unfilter (no card code here; the CUDA kernels are in ../csrc).
//
// A copy of ngp_pl_tpu/native/ray_sampler.cpp, kept apart because the port
// imports nothing of the JAX package.  Its functions are the same code, so
// for the same seed, store and machine they give the same batches; that
// includes `parallel_for`'s chunking, whose boundaries (and so the draws of
// a batch of 16,384 rays or more) follow hardware_concurrency().  The
// reference feeds training from 16 DataLoader worker processes (reference
// train.py:141-152, datasets/base.py:24-35); here one call draws a batch.
// `ngp_png_unfilter` is the port's own: PNG's Average and Paeth filters
// depend on the byte just decoded, so they run here rather than in numpy.
// So are the OpenEXR PIZ decoder's two bit-serial stages,
// `ngp_piz_huf_decode` (OpenEXR's ImfHuf.cpp) and `ngp_piz_wav2_decode`
// (ImfWav.cpp), and the DWA decoder's per-block loop, `ngp_dwa_dct_decode`
// (ImfDwaCompressor.cpp); the rest of both is numpy in datasets/exr.py.
//
// Exposed through a plain C ABI and loaded with ctypes; all buffers are
// caller-allocated numpy arrays.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// splitmix64 -> xoshiro256** seeding, one independent stream per thread.
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    uint64_t x = seed;
    for (int i = 0; i < 4; i++) {
      x += 0x9e3779b97f4a7c15ull;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
      s[i] = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3]; s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // unbiased bounded draw (Lemire)
  uint32_t bounded(uint32_t n) {
    uint64_t m = (uint64_t)(uint32_t)next() * n;
    uint32_t lo = (uint32_t)m;
    if (lo < n) {
      uint32_t thresh = (uint32_t)(-(int32_t)n) % n;
      while (lo < thresh) {
        m = (uint64_t)(uint32_t)next() * n;
        lo = (uint32_t)m;
      }
    }
    return (uint32_t)(m >> 32);
  }
};

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? (int)n : 4;
}

template <typename F>
void parallel_for(int64_t n, F body, int max_threads = 0) {
  int nt = hw_threads();
  if (max_threads > 0 && max_threads < nt) nt = max_threads;
  if (n < (1 << 14) || nt <= 1) {  // small: not worth spawning
    body(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=] { body(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

// OpenEXR DWAA/DWAB helpers (ImfDwaCompressor.cpp, ImfDwaCompressorSimd.h):
// half <-> float as Imath's half does it (to half: round to nearest, ties
// to even; past HALF_MAX to infinity), and the inverse 8x8 DCT with the
// first pass over the rows that can hold a coefficient (the others are
// zero).
float half_to_float(uint16_t h) {
  uint32_t s = (uint32_t)(h & 0x8000) << 16, e = (h >> 10) & 0x1f,
           m = h & 0x3ff, bits;
  if (e == 0 && m == 0) {
    bits = s;
  } else if (e == 0) {
    e = 127 - 15 + 1;
    while (!(m & 0x400)) {
      m <<= 1;
      e--;
    }
    bits = s | (e << 23) | ((m & 0x3ff) << 13);
  } else if (e == 31) {
    bits = s | 0x7f800000 | (m << 13);
  } else {
    bits = s | ((e + 127 - 15) << 23) | (m << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

uint16_t float_to_half(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  const uint32_t s = (x >> 16) & 0x8000;
  int32_t e = (int32_t)((x >> 23) & 0xff) - (127 - 15);
  uint32_t m = x & 0x7fffff;
  if (e <= 0) {
    if (e < -10) return (uint16_t)s;
    m |= 0x800000;
    const int t = 14 - e;
    const uint32_t a = (1u << (t - 1)) - 1, b = (m >> t) & 1;
    return (uint16_t)(s | ((m + a + b) >> t));
  }
  if (e == 0xff - (127 - 15)) {
    if (m == 0) return (uint16_t)(s | 0x7c00);
    m >>= 13;
    return (uint16_t)(s | 0x7c00 | m | (m == 0));
  }
  m = m + 0xfff + ((m >> 13) & 1);
  if (m & 0x800000) {
    m = 0;
    e += 1;
  }
  if (e > 30) return (uint16_t)(s | 0x7c00);
  return (uint16_t)(s | (e << 10) | (m >> 13));
}

// dctInverse8x8_sse2<zeroedRows>, its float operations in its order: the
// order OpenEXR runs on x86-64 (SSE2 is always there), where it decodes
// bit for bit as OpenEXR 2.3 does (the scalar path, with constants from
// cosf and its sums in another order, misses some values by a rounding).
// Rows as a product: the even outputs' sum of X0, X2, X4, X6 times the
// columns of M1, the odd ones' of X1, X3, X5, X7 times M2, each summed
// left to right; out[k] = even + odd, out[7 - k] = even - odd.  Columns
// through the factored form, the odd sums in pairs.
void dct_inverse_8x8(float* data, int zeroed_rows) {
  const float a = 3.535536e-01f, b = 4.903927e-01f, c = 4.619398e-01f,
              d = 4.157349e-01f, e = 2.777855e-01f, f = 1.913422e-01f,
              g = 9.754573e-02f;
  const float m1[4][4] = {{a, c, a, f}, {a, f, -a, -c}, {a, -f, -a, c},
                          {a, -c, a, -f}};
  const float m2[4][4] = {{b, d, e, g}, {d, -g, -b, -e}, {e, -b, g, d},
                          {g, -e, d, -b}};
  for (int row = 0; row < 8 - zeroed_rows; ++row) {
    float* r = data + row * 8;
    float even[4], odd[4];
    for (int k = 0; k < 4; ++k) {
      even[k] = r[0] * m1[k][0] + r[2] * m1[k][1] + r[4] * m1[k][2] +
                r[6] * m1[k][3];
      odd[k] = r[1] * m2[k][0] + r[3] * m2[k][1] + r[5] * m2[k][2] +
               r[7] * m2[k][3];
    }
    for (int k = 0; k < 4; ++k) {
      r[k] = even[k] + odd[k];
      r[7 - k] = even[k] - odd[k];
    }
  }
  float alpha[4], beta[4], theta[4], gamma[4];
  for (int col = 0; col < 8; ++col) {
    float in[8];
    for (int i = 0; i < 8; ++i) in[i] = data[8 * i + col];
    alpha[0] = c * in[2];
    alpha[1] = f * in[2];
    alpha[2] = c * in[6];
    alpha[3] = f * in[6];
    beta[0] = (b * in[1] + d * in[3]) + (e * in[5] + g * in[7]);
    beta[1] = (d * in[1] - g * in[3]) - (b * in[5] + e * in[7]);
    beta[2] = (e * in[1] - b * in[3]) + (g * in[5] + d * in[7]);
    beta[3] = (g * in[1] - e * in[3]) + (d * in[5] - b * in[7]);
    theta[0] = a * (in[0] + in[4]);
    theta[3] = a * (in[0] - in[4]);
    theta[1] = alpha[0] + alpha[3];
    theta[2] = alpha[1] - alpha[2];
    gamma[0] = theta[0] + theta[1];
    gamma[1] = theta[3] + theta[2];
    gamma[2] = theta[3] - theta[2];
    gamma[3] = theta[0] - theta[1];
    data[col] = gamma[0] + beta[0];
    data[8 + col] = gamma[1] + beta[1];
    data[16 + col] = gamma[2] + beta[2];
    data[24 + col] = gamma[3] + beta[3];
    data[32 + col] = gamma[3] - beta[3];
    data[40 + col] = gamma[2] - beta[2];
    data[48 + col] = gamma[1] - beta[1];
    data[56 + col] = gamma[0] - beta[0];
  }
}

}  // namespace

extern "C" {

// Sample a training batch: draw (img, pix) index pairs and gather their ray
// payloads out of `rays` (n_img, n_pix, channels) float32.
//   strategy: 0 = all_images (independent image draw per ray),
//             1 = same_image (one image for the whole batch)
//             (reference datasets/base.py:25-30)
// Outputs: img_idxs/pix_idxs (batch,) int32, rgb (batch, 3) float32,
//          exposure (batch, 1) float32 (written only if channels >= 4 and
//          exposure != nullptr).
void ngp_sample_batch_f32(const float* rays, int64_t n_img, int64_t n_pix,
                          int64_t channels, int64_t batch, int strategy,
                          uint64_t seed, int32_t* img_idxs, int32_t* pix_idxs,
                          float* rgb, float* exposure) {
  uint32_t fixed_img = 0;
  if (strategy == 1) {
    Rng r(seed ^ 0x517cc1b727220a95ull);
    fixed_img = r.bounded((uint32_t)n_img);
  }
  parallel_for(batch, [&](int64_t lo, int64_t hi) {
    Rng r(seed + (uint64_t)lo * 0x2545f4914f6cdd1dull + 1);
    for (int64_t i = lo; i < hi; i++) {
      uint32_t im = (strategy == 1) ? fixed_img : r.bounded((uint32_t)n_img);
      uint32_t px = r.bounded((uint32_t)n_pix);
      img_idxs[i] = (int32_t)im;
      pix_idxs[i] = (int32_t)px;
      const float* src = rays + ((int64_t)im * n_pix + px) * channels;
      rgb[i * 3 + 0] = src[0];
      rgb[i * 3 + 1] = src[1];
      rgb[i * 3 + 2] = src[2];
      if (channels >= 4 && exposure) exposure[i] = src[3];
    }
  });
}

// Same sampling, but the ray store stays uint8 (4x less host RAM than the
// reference's float32 preload); conversion to [0,1] float happens here.
void ngp_sample_batch_u8(const uint8_t* rays, int64_t n_img, int64_t n_pix,
                         int64_t channels, int64_t batch, int strategy,
                         uint64_t seed, int32_t* img_idxs, int32_t* pix_idxs,
                         float* rgb) {
  const float inv = 1.0f / 255.0f;
  uint32_t fixed_img = 0;
  if (strategy == 1) {
    Rng r(seed ^ 0x517cc1b727220a95ull);
    fixed_img = r.bounded((uint32_t)n_img);
  }
  parallel_for(batch, [&](int64_t lo, int64_t hi) {
    Rng r(seed + (uint64_t)lo * 0x2545f4914f6cdd1dull + 1);
    for (int64_t i = lo; i < hi; i++) {
      uint32_t im = (strategy == 1) ? fixed_img : r.bounded((uint32_t)n_img);
      uint32_t px = r.bounded((uint32_t)n_pix);
      img_idxs[i] = (int32_t)im;
      pix_idxs[i] = (int32_t)px;
      const uint8_t* src = rays + ((int64_t)im * n_pix + px) * channels;
      rgb[i * 3 + 0] = src[0] * inv;
      rgb[i * 3 + 1] = src[1] * inv;
      rgb[i * 3 + 2] = src[2] * inv;
    }
  });
}

// Image ingest: uint8 RGB(A) -> float32 RGB with alpha handling
// (reference datasets/color_utils.py:19-27).
//   mode 0: blend over white  rgb*a + (1-a)
//   mode 1: premultiply       rgb*a
//   mode 2: plain             rgb
void ngp_u8_to_rays(const uint8_t* img, int64_t n_pix, int64_t channels,
                    int mode, float* out) {
  const float inv = 1.0f / 255.0f;
  parallel_for(n_pix, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      const uint8_t* p = img + i * channels;
      float r = p[0] * inv, g = p[1] * inv, b = p[2] * inv;
      if (channels >= 4 && mode != 2) {
        float a = p[3] * inv;
        if (mode == 0) {
          r = r * a + (1.0f - a);
          g = g * a + (1.0f - a);
          b = b * a + (1.0f - a);
        } else {
          r *= a; g *= a; b *= a;
        }
      }
      out[i * 3 + 0] = r;
      out[i * 3 + 1] = g;
      out[i * 3 + 2] = b;
    }
  });
}

// Box-filter downsample by integer factor (host-side preprocessing used when
// --downsample shrinks training images; reference uses cv2.resize AREA).
void ngp_downsample_box(const float* img, int64_t h, int64_t w, int64_t c,
                        int64_t factor, float* out) {
  int64_t oh = h / factor, ow = w / factor;
  float norm = 1.0f / (float)(factor * factor);
  parallel_for(oh, [&](int64_t lo, int64_t hi) {
    for (int64_t oy = lo; oy < hi; oy++) {
      for (int64_t ox = 0; ox < ow; ox++) {
        for (int64_t ch = 0; ch < c; ch++) {
          float acc = 0.0f;
          for (int64_t dy = 0; dy < factor; dy++) {
            const float* row = img + ((oy * factor + dy) * w) * c + ch;
            for (int64_t dx = 0; dx < factor; dx++)
              acc += row[(ox * factor + dx) * c];
          }
          out[(oy * ow + ox) * c + ch] = acc * norm;
        }
      }
    }
  });
}

// Reverse PNG's per-row filters (PNG spec, section 9) in place of a
// Python loop: `raw` holds h rows of 1 filter byte + row_bytes bytes, as
// zlib inflates IDAT; `out` receives h * row_bytes bytes.  bpp is the bytes
// per complete pixel (1-8).  Returns -1 on success, else the index of the
// first row whose filter byte is not 0-4.
int64_t ngp_png_unfilter(const uint8_t* raw, int64_t h, int64_t row_bytes,
                         int64_t bpp, uint8_t* out) {
  for (int64_t y = 0; y < h; y++) {
    const uint8_t* in = raw + y * (row_bytes + 1);
    const uint8_t ft = in[0];
    in += 1;
    uint8_t* cur = out + y * row_bytes;
    const uint8_t* up = y ? cur - row_bytes : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(cur, in, (size_t)row_bytes);
        break;
      case 1:
        for (int64_t i = 0; i < row_bytes; i++)
          cur[i] = (uint8_t)(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < row_bytes; i++)
          cur[i] = (uint8_t)(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
          cur[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (i >= bpp && up) ? up[i - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p,
              pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(in[i] + pred);
        }
        break;
      default:
        return y;
    }
  }
  return -1;
}

// OpenEXR PIZ, stage 1: the Huffman code of ImfHuf.cpp's hufUncompress.
// `in` (n_in bytes) is a 20-byte header (u32 LE: im, iM, table length,
// nBits, 0), the code lengths of symbols im..iM packed as 6-bit fields MSB
// first (59-62: runs of 2-5 zero lengths; 63 + 8 bits: runs of 6-261),
// then nBits of data MSB first.  Codes are canonical: of the lengths 58
// down to 1, each length's codes follow the next length's, in symbol order
// within a length.  Symbol iM is the run code: 8 bits follow, the count of
// further copies of the symbol before it.  Writes n_out u16 values; returns
// 0, or a negative code: -1 the input ends early, -2 a bad table, -3 a
// code no symbol has, -4 more symbols than n_out, -5 fewer, -6 a run with
// nothing before it.
int64_t ngp_piz_huf_decode(const uint8_t* in, int64_t n_in, uint16_t* out,
                           int64_t n_out) {
  constexpr int64_t kEncSize = (1 << 16) + 1;
  constexpr int kShortZeroRun = 59, kLongZeroRun = 63;
  constexpr int kShortestLongRun = 2 + kLongZeroRun - kShortZeroRun;
  constexpr int kMaxLen = 58;
  if (n_in == 0) return n_out == 0 ? 0 : -5;
  if (n_in < 20) return -1;
  auto u32 = [&](int at) {
    return (uint32_t)in[at] | (uint32_t)in[at + 1] << 8 |
           (uint32_t)in[at + 2] << 16 | (uint32_t)in[at + 3] << 24;
  };
  const int64_t im = u32(0), iM = u32(4), n_bits = u32(12);
  if (im >= kEncSize || iM >= kEncSize || im > iM) return -2;
  // the packed table (hufUnpackEncTable)
  std::vector<uint8_t> len(kEncSize, 0);
  const uint8_t* p = in + 20;
  const uint8_t* end = in + n_in;
  uint64_t c = 0;
  int lc = 0;
  auto bits = [&](int n, int64_t& v) {
    while (lc < n) {
      if (p >= end) return false;
      c = (c << 8) | *p++;
      lc += 8;
    }
    lc -= n;
    v = (int64_t)((c >> lc) & ((1ull << n) - 1));
    return true;
  };
  for (int64_t i = im; i <= iM; i++) {
    int64_t l;
    if (!bits(6, l)) return -1;
    int64_t zerun = 0;
    if (l == kLongZeroRun) {
      int64_t z;
      if (!bits(8, z)) return -1;
      zerun = z + kShortestLongRun;
    } else if (l >= kShortZeroRun) {
      zerun = l - kShortZeroRun + 2;
    } else {
      len[i] = (uint8_t)l;
      continue;
    }
    if (i + zerun > iM + 1) return -2;
    i += zerun - 1;
  }
  // canonical codes (hufCanonicalCodeTable): first code and symbols by length
  int64_t count[kMaxLen + 1] = {0}, first[kMaxLen + 1] = {0};
  for (int64_t i = 0; i < kEncSize; i++) count[len[i]]++;
  int64_t code = 0;
  for (int l = kMaxLen; l > 0; --l) {
    int64_t next = (code + count[l]) >> 1;
    first[l] = code;
    code = next;
  }
  int64_t start[kMaxLen + 2] = {0};
  for (int l = 1; l <= kMaxLen; l++) start[l + 1] = start[l] + count[l];
  std::vector<int32_t> sym(start[kMaxLen + 1]);
  int64_t fill[kMaxLen + 1];
  for (int l = 1; l <= kMaxLen; l++) fill[l] = start[l];
  for (int64_t i = 0; i < kEncSize; i++)
    if (len[i]) sym[fill[len[i]]++] = (int32_t)i;
  // the data: from the byte after the table's last
  const uint8_t* data = p;
  if (n_bits > 8 * (end - data)) return -1;
  int64_t pos = 0, o = 0;
  auto bit = [&]() { int64_t b = (data[pos >> 3] >> (7 - (pos & 7))) & 1; pos++; return b; };
  while (pos < n_bits) {
    int64_t v = 0, s = -1;
    for (int l = 1; l <= kMaxLen && pos < n_bits; l++) {
      v = (v << 1) | bit();
      if (count[l] && v >= first[l] && v - first[l] < count[l]) {
        s = sym[start[l] + v - first[l]];
        break;
      }
    }
    if (s < 0) return -3;
    if (s == iM) {
      if (pos + 8 > n_bits) return -1;
      int64_t cs = 0;
      for (int k = 0; k < 8; k++) cs = (cs << 1) | bit();
      if (o == 0) return -6;
      if (o + cs > n_out) return -4;
      const uint16_t last = out[o - 1];
      for (int64_t k = 0; k < cs; k++) out[o++] = last;
    } else {
      if (o >= n_out) return -4;
      out[o++] = (uint16_t)s;
    }
  }
  return o == n_out ? 0 : -5;
}

// OpenEXR PIZ, stage 2: ImfWav.cpp's wav2Decode, the inverse 2-D Haar
// wavelet in place on n = nx * ny u16 values at `in`, x stride ox and y
// stride oy (in values); the 14-bit transform when mx < 1 << 14, else the
// 16-bit modular one.
void ngp_piz_wav2_decode(uint16_t* in, int32_t nx, int32_t ox, int32_t ny,
                         int32_t oy, uint16_t mx) {
  const bool w14 = mx < (1 << 14);
  auto dec14 = [](uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
    int16_t ls = (int16_t)l, hs = (int16_t)h;
    int hi = hs;
    int ai = ls + (hi & 1) + (hi >> 1);
    a = (uint16_t)(int16_t)ai;
    b = (uint16_t)(int16_t)(ai - hi);
  };
  auto dec16 = [](uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
    constexpr int kOffset = 1 << 15, kMask = (1 << 16) - 1;
    int m = l, d = h;
    int bb = (m - (d >> 1)) & kMask;
    int aa = (d + bb - kOffset) & kMask;
    b = (uint16_t)bb;
    a = (uint16_t)aa;
  };
  auto dec = [&](uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
    if (w14) dec14(l, h, a, b); else dec16(l, h, a, b);
  };
  const int n = nx > ny ? ny : nx;
  int p = 1;
  while (p <= n) p <<= 1;
  p >>= 1;
  int p2 = p;
  p >>= 1;
  while (p >= 1) {
    uint16_t* py = in;
    uint16_t* ey = in + (int64_t)oy * (ny - p2);
    const int64_t oy1 = (int64_t)oy * p, oy2 = (int64_t)oy * p2;
    const int64_t ox1 = (int64_t)ox * p, ox2 = (int64_t)ox * p2;
    uint16_t i00, i01, i10, i11;
    for (; py <= ey; py += oy2) {
      uint16_t* px = py;
      uint16_t* ex = py + (int64_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        uint16_t* p10 = px + oy1;
        uint16_t* p11 = p10 + ox1;
        dec(*px, *p10, i00, i10);
        dec(*p01, *p11, i01, i11);
        dec(i00, i01, *px, *p01);
        dec(i10, i11, *p10, *p11);
      }
      if (nx & p) {
        uint16_t* p10 = px + oy1;
        dec(*px, *p10, i00, *p10);
        *px = i00;
      }
    }
    if (ny & p) {
      uint16_t* px = py;
      uint16_t* ex = py + (int64_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        dec(*px, *p01, i00, *p01);
        *px = i00;
      }
    }
    p2 = p;
    p >>= 1;
  }
}

// OpenEXR DWAA/DWAB: the LOSSY_DCT channels of one block, one channel
// (n_comp 1) or an R, G, B set (3), as ImfDwaCompressor.cpp's
// LossyDctDecoder::execute does with its SSE2 inverse DCT.  Blocks of 8x8, rows of
// blocks first; `dc` holds each component's plane of DC values (half bits)
// one after the other, `ac` (n_ac u16) the AC values of every block in
// turn, each component's in turn within a block, in zigzag order:
// 0xff00 ends a block, 0xff00 | n skips n zeros, anything else is the next
// coefficient.  A block whose AC is all zeros is its DC value times
// 3.535536e-01f twice; any other goes through the inverse DCT.  A set then
// goes from Y'CbCr to R'G'B' (csc709Inverse).  Writes each component's
// height x width nonlinear half bits to `out`, the edge blocks cut back;
// returns the AC values taken, or -1 when they run out.
int64_t ngp_dwa_dct_decode(const uint16_t* ac, int64_t n_ac,
                           const uint16_t* dc, int32_t n_comp, int32_t width,
                           int32_t height, uint16_t* out) {
  static const int kFromZig[64] = {
      0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
      3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
      10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
      21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};
  const int nbx = (width + 7) / 8, nby = (height + 7) / 8;
  const int64_t plane = (int64_t)width * height;
  int64_t at = 0;
  float data[3][64];
  uint16_t zig[64];
  for (int by = 0; by < nby; ++by) {
    for (int bx = 0; bx < nbx; ++bx) {
      for (int comp = 0; comp < n_comp; ++comp) {
        std::memset(zig, 0, sizeof zig);
        zig[0] = dc[(int64_t)comp * nbx * nby + (int64_t)by * nbx + bx];
        int last = 0, k = 1;
        while (k < 64) {
          if (at >= n_ac) return -1;
          const uint16_t v = ac[at++];
          if (v == 0xff00) {
            k = 64;
          } else if ((v >> 8) == 0xff) {
            k += v & 0xff;
          } else {
            last = k;
            zig[k++] = v;
          }
        }
        float* blk = data[comp];
        if (last == 0) {
          const float val = half_to_float(zig[0]) * 3.535536e-01f *
                            3.535536e-01f;
          for (int i = 0; i < 64; ++i) blk[i] = val;
          continue;
        }
        for (int i = 0; i < 64; ++i) blk[i] = half_to_float(zig[kFromZig[i]]);
        const int zeroed = last < 2 ? 7 : last < 3 ? 6 : last < 9 ? 5
                         : last < 10 ? 4 : last < 20 ? 3 : last < 21 ? 2
                         : last < 35 ? 1 : 0;
        dct_inverse_8x8(blk, zeroed);
      }
      if (n_comp == 3) {
        for (int i = 0; i < 64; ++i) {
          const float y = data[0][i], cb = data[1][i], cr = data[2][i];
          data[0][i] = y + 1.5747f * cr;
          data[1][i] = y - 0.1873f * cb - 0.4682f * cr;
          data[2][i] = y + 1.8556f * cb;
        }
      }
      const int nx = std::min(8, width - 8 * bx);
      const int ny = std::min(8, height - 8 * by);
      for (int comp = 0; comp < n_comp; ++comp) {
        uint16_t* o = out + comp * plane + (int64_t)(8 * by) * width + 8 * bx;
        for (int y = 0; y < ny; ++y)
          for (int x = 0; x < nx; ++x)
            o[(int64_t)y * width + x] = float_to_half(data[comp][8 * y + x]);
      }
    }
  }
  return at;
}

int ngp_native_version() { return 1; }

}  // extern "C"
