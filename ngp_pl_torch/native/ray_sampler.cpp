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
// (ImfWav.cpp); the rest of PIZ is numpy in datasets/exr.py.
//
// Exposed through a plain C ABI and loaded with ctypes; all buffers are
// caller-allocated numpy arrays.

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

int ngp_native_version() { return 1; }

}  // extern "C"
