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

int ngp_native_version() { return 1; }

}  // extern "C"
