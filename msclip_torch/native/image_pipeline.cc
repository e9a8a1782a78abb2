// Native image pipeline: JPEG decode -> PIL-compatible bicubic resample ->
// crop -> ImageNet normalize, multithreaded over a batch.
//
// The host side of msclip_torch's JPEG-fed paths (MSCLIP_NATIVE_DECODE=1):
// the reference does this work in torchvision/PIL Python workers
// (reference tools/zero_shot.py:202-217); here it is C++, so the loader
// threads only move pointers while the card consumes batches. A copy of
// msclip_tpu/native/image_pipeline.cc whose code computes the same bytes;
// msclip_torch/native/__init__.py builds it with g++ against libjpeg (the
// system's, or the libjpeg-62 that Pillow ships) and drives it through
// ctypes.
//
// Resampling follows PIL's algorithm (separable convolution, bicubic
// a=-0.5, support scaled by the downscale factor for antialiasing,
// horizontal-then-vertical uint8 passes) so outputs track the parity
// transform within JPEG-decoder rounding.
//
// C API (ctypes-friendly), returns 0 on success:
//   ip_decode_eval  : one JPEG -> [size, size, 3] float32 (short-side
//                     resize + center crop + normalize)
//   ip_decode_eval_u8 : one JPEG -> [size, size, 3] uint8 (resize + crop)
//   ip_decode_train : one JPEG -> RandomResizedCrop(size) + optional hflip
//   ip_decode_eval_batch(_u8) : N JPEGs with an internal thread pool
// Each takes a last argument dct_scale (decode at a reduced IDCT scale).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode a JPEG byte buffer to an RGB uint8 HWC image.
//
// min_short_side > 0 enables DCT-scaled decode: libjpeg's IDCT produces
// output at scale_num/8 (scale_num in 1..8) nearly for free, so we decode
// at the smallest scale whose short side still covers the resize target —
// PIL's Image.draft() trick at n/8 granularity (draft only offers
// power-of-two scales). Typically 3-4x cheaper than full decode for large
// photos. NOT bit-identical with full decode + bicubic: the downstream
// resample then starts from the IDCT-scaled image (exactly what a
// PIL-draft pipeline sees); see the parity stance in data/datasets.py.
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* out,
                 int* w, int* h, int min_short_side = 0) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  bool gray = cinfo.jpeg_color_space == JCS_GRAYSCALE;
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
  if (min_short_side > 0) {
    unsigned int short_side =
        std::min(cinfo.image_width, cinfo.image_height);
    unsigned int num = 8;
    // scaled output dim = ceil(dim * num / 8); take the smallest num
    // that keeps the short side >= the target
    while (num > 1 && (short_side * (num - 1) + 7) / 8 >=
                          static_cast<unsigned int>(min_short_side))
      --num;
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  int nc = cinfo.output_components;
  std::vector<uint8_t> row(static_cast<size_t>(*w) * nc);
  out->resize(static_cast<size_t>(*w) * *h * 3);
  for (int y = 0; y < *h; ++y) {
    JSAMPROW rp = row.data();
    jpeg_read_scanlines(&cinfo, &rp, 1);
    uint8_t* dst = out->data() + static_cast<size_t>(y) * *w * 3;
    if (nc == 3) {
      std::memcpy(dst, row.data(), static_cast<size_t>(*w) * 3);
    } else {  // grayscale -> RGB replicate
      for (int x = 0; x < *w; ++x) {
        dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = row[x];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// PIL bicubic filter (a = -0.5), support 2.
inline double bicubic(double x) {
  constexpr double a = -0.5;
  if (x < 0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Coeffs {
  std::vector<int> xmin, xlen;
  std::vector<double> k;  // [out, kmax]
  int kmax = 0;
};

// PIL ImagingPrecomputeCoeffs over an input window [in0, in1), clamped to
// the FULL image extent [0, bound) — PIL's resize(box=...) samples outside
// the box (up to the filter support) when the box does not touch the image
// edge; clamping to the box instead of the image was both a parity
// deviation and, in the vertical pass, an out-of-bounds read of the
// intermediate buffer (the round-1 "flaky" native test was this UB).
Coeffs precompute(int in0, int in1, int bound, int out_size) {
  Coeffs c;
  const double support0 = 2.0;
  double scale = static_cast<double>(in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = support0 * filterscale;
  c.kmax = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.xmin.resize(out_size);
  c.xlen.resize(out_size);
  c.k.assign(static_cast<size_t>(out_size) * c.kmax, 0.0);
  double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; ++xx) {
    double center = in0 + (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > bound) xmax = bound;
    xmax -= xmin;
    double* kk = &c.k[static_cast<size_t>(xx) * c.kmax];
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double w = bicubic((x + xmin - center + 0.5) * ss);
      kk[x] = w;
      ww += w;
    }
    if (ww != 0.0)
      for (int x = 0; x < xmax; ++x) kk[x] /= ww;
    c.xmin[xx] = xmin;
    c.xlen[xx] = xmax;
  }
  return c;
}

inline uint8_t clip8(double v) {
  long r = std::lround(v);
  if (r < 0) return 0;
  if (r > 255) return 255;
  return static_cast<uint8_t>(r);
}

// Separable resample of an RGB window (box [bx0,by0,bx1,by1)) of src to
// [out_w, out_h], PIL-style: horizontal pass then vertical pass, clipping
// to uint8 between passes.
std::vector<uint8_t> resample(const uint8_t* src, int sw, int sh, int bx0,
                              int by0, int bx1, int by1, int out_w,
                              int out_h) {
  Coeffs ch = precompute(bx0, bx1, sw, out_w);
  Coeffs cv = precompute(by0, by1, sh, out_h);
  // The vertical filter support may extend past the box (clamped to the
  // image); the horizontal pass must cover exactly the row range the
  // vertical pass will read (PIL ImagingResampleInner's ybox bounds).
  int row_first = sh, row_last = 0;
  for (int yy = 0; yy < out_h; ++yy) {
    row_first = std::min(row_first, cv.xmin[yy]);
    row_last = std::max(row_last, cv.xmin[yy] + cv.xlen[yy]);
  }
  // horizontal: rows [row_first, row_last) -> width out_w
  int mid_h = row_last - row_first;
  std::vector<uint8_t> mid(static_cast<size_t>(out_w) * mid_h * 3);
  for (int y = 0; y < mid_h; ++y) {
    const uint8_t* srow = src + (static_cast<size_t>(y + row_first) * sw) * 3;
    uint8_t* drow = mid.data() + static_cast<size_t>(y) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      const double* kk = &ch.k[static_cast<size_t>(xx) * ch.kmax];
      int xmin = ch.xmin[xx], xlen = ch.xlen[xx];
      double s0 = 0, s1 = 0, s2 = 0;
      for (int x = 0; x < xlen; ++x) {
        const uint8_t* p = srow + static_cast<size_t>(xmin + x) * 3;
        s0 += p[0] * kk[x];
        s1 += p[1] * kk[x];
        s2 += p[2] * kk[x];
      }
      drow[3 * xx] = clip8(s0);
      drow[3 * xx + 1] = clip8(s1);
      drow[3 * xx + 2] = clip8(s2);
    }
  }
  // vertical: tap-outer row-streaming accumulation (contiguous access)
  std::vector<uint8_t> out(static_cast<size_t>(out_w) * out_h * 3);
  std::vector<float> acc(static_cast<size_t>(out_w) * 3);
  for (int yy = 0; yy < out_h; ++yy) {
    const double* kk = &cv.k[static_cast<size_t>(yy) * cv.kmax];
    int ymin = cv.xmin[yy] - row_first, ylen = cv.xlen[yy];
    std::fill(acc.begin(), acc.end(), 0.0f);
    for (int y = 0; y < ylen; ++y) {
      const float w = static_cast<float>(kk[y]);
      const uint8_t* srow =
          mid.data() + static_cast<size_t>(ymin + y) * out_w * 3;
      for (int xx = 0; xx < out_w * 3; ++xx) acc[xx] += srow[xx] * w;
    }
    uint8_t* drow = out.data() + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w * 3; ++xx) drow[xx] = clip8(acc[xx]);
  }
  return out;
}

void normalize_out(const uint8_t* rgb, int size, const float* mean,
                   const float* stdv, float* out) {
  float inv[3] = {1.0f / stdv[0], 1.0f / stdv[1], 1.0f / stdv[2]};
  size_t n = static_cast<size_t>(size) * size;
  for (size_t i = 0; i < n; ++i)
    for (int ch = 0; ch < 3; ++ch)
      out[3 * i + ch] =
          (rgb[3 * i + ch] * (1.0f / 255.0f) - mean[ch]) * inv[ch];
}

// splitmix64 for reproducible per-sample augmentation draws
inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

inline double uniform01(uint64_t* s) {
  return (splitmix64(s) >> 11) * (1.0 / 9007199254740992.0);
}

// Decode + resize-short-side + center-crop to a uint8 [size, size, 3]
// buffer — the stage shared by the fp32 path (which then normalizes
// host-side) and the uint8-boundary path (which ships the crop to the
// device and normalizes in-graph; 4x smaller host->device payload).
int decode_eval_crop_u8(const uint8_t* data, size_t len, int size,
                        uint8_t* out, int dct_scale) {
  std::vector<uint8_t> img;
  int w, h;
  if (!decode_jpeg(data, len, &img, &w, &h, dct_scale ? size : 0)) return 1;
  // torchvision Resize(size): short side -> size; the long side
  // TRUNCATES (int(size * long / short)) — torchvision 0.7 semantics,
  // must match pil_eval_transform exactly.
  int nw, nh;
  if (w <= h) {
    nw = size;
    nh = static_cast<int>(static_cast<double>(size) * h / w);
  } else {
    nh = size;
    nw = static_cast<int>(static_cast<double>(size) * w / h);
  }
  std::vector<uint8_t> resized = resample(img.data(), w, h, 0, 0, w, h,
                                          nw, nh);
  // CenterCrop. Python round() / torchvision round half to EVEN: for an
  // odd margin (offset = *.5) Python int(round(58.5)) == 58, while
  // std::lround's half-away-from-zero gave 59 — a one-pixel crop shift
  // against pil_eval_transform on every aspect ratio whose post-resize
  // margin is odd. std::rint under the default FE_TONEAREST mode is
  // half-to-even, matching Python exactly.
  int left = static_cast<int>(std::rint((nw - size) / 2.0));
  int top = static_cast<int>(std::rint((nh - size) / 2.0));
  for (int y = 0; y < size; ++y)
    std::memcpy(out + static_cast<size_t>(y) * size * 3,
                resized.data() +
                    (static_cast<size_t>(y + top) * nw + left) * 3,
                static_cast<size_t>(size) * 3);
  return 0;
}

int decode_eval_impl(const uint8_t* data, size_t len, int size,
                     const float* mean, const float* stdv, float* out,
                     int dct_scale) {
  std::vector<uint8_t> crop(static_cast<size_t>(size) * size * 3);
  if (decode_eval_crop_u8(data, len, size, crop.data(), dct_scale))
    return 1;
  normalize_out(crop.data(), size, mean, stdv, out);
  return 0;
}

// Shared batch thread pool: work-steals indices [0, n) across up to
// n_threads threads, records per-item rc into status, returns the
// failure count. Both batch entry points differ only in the per-item
// decode they run.
template <typename PerItem>
static int run_decode_pool(int n, int n_threads, int32_t* status,
                           PerItem per_item) {
  std::atomic<int> next(0), failures(0);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = per_item(i);
      status[i] = rc;
      if (rc) failures.fetch_add(1);
    }
  };
  int nt = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // namespace

extern "C" {

int ip_decode_eval(const uint8_t* data, size_t len, int size,
                   const float* mean, const float* stdv, float* out,
                   int dct_scale) {
  return decode_eval_impl(data, len, size, mean, stdv, out, dct_scale);
}

// uint8-boundary variant: JPEG -> uint8 [size, size, 3] center crop (no
// normalize — that runs on the card, data/transforms.normalize_uint8).
// Same resize/crop semantics as ip_decode_eval; the payload crossing the
// host->device link is 4x smaller than fp32.
int ip_decode_eval_u8(const uint8_t* data, size_t len, int size,
                      uint8_t* out, int dct_scale) {
  return decode_eval_crop_u8(data, len, size, out, dct_scale);
}

// torchvision RandomResizedCrop(size, scale=(smin,smax), ratio=(rmin,rmax))
// + horizontal flip with probability hflip_p; bicubic resample of the crop
// window directly (PIL resize(box=...) semantics).
int ip_decode_train(const uint8_t* data, size_t len, int size, double smin,
                    double smax, double rmin, double rmax, double hflip_p,
                    uint64_t seed, const float* mean, const float* stdv,
                    float* out, int dct_scale) {
  std::vector<uint8_t> img;
  int w, h;
  // dct_scale for training decodes at >= 2x the crop target so the
  // random crop window (drawn in the scaled coordinates) still has
  // headroom to upsample from; exactness of the seeded draw sequence is
  // preserved, the window geometry shifts with the scaled dims.
  if (!decode_jpeg(data, len, &img, &w, &h, dct_scale ? 2 * size : 0))
    return 1;
  uint64_t rs = seed ? seed : 0x2545F4914F6CDD1DULL;
  double area = static_cast<double>(w) * h;
  int cx = 0, cy = 0, cw = w, chh = h;
  bool found = false;
  const double log_rmin = std::log(rmin), log_rmax = std::log(rmax);
  for (int attempt = 0; attempt < 10; ++attempt) {
    double target = area * (smin + (smax - smin) * uniform01(&rs));
    double ratio = std::exp(log_rmin + (log_rmax - log_rmin) * uniform01(&rs));
    int tw = static_cast<int>(std::lround(std::sqrt(target * ratio)));
    int th = static_cast<int>(std::lround(std::sqrt(target / ratio)));
    if (tw > 0 && th > 0 && tw <= w && th <= h) {
      cx = static_cast<int>(uniform01(&rs) * (w - tw + 1));
      cy = static_cast<int>(uniform01(&rs) * (h - th + 1));
      cw = tw;
      chh = th;
      found = true;
      break;
    }
  }
  if (!found) {  // torchvision fallback: center crop at in-range ratio
    double in_ratio = static_cast<double>(w) / h;
    if (in_ratio < rmin) {
      cw = w;
      chh = static_cast<int>(std::lround(cw / rmin));
    } else if (in_ratio > rmax) {
      chh = h;
      cw = static_cast<int>(std::lround(chh * rmax));
    } else {
      cw = w;
      chh = h;
    }
    cx = (w - cw) / 2;
    cy = (h - chh) / 2;
  }
  std::vector<uint8_t> resized = resample(img.data(), w, h, cx, cy, cx + cw,
                                          cy + chh, size, size);
  if (uniform01(&rs) < hflip_p) {
    for (int y = 0; y < size; ++y) {
      uint8_t* row = resized.data() + static_cast<size_t>(y) * size * 3;
      for (int x = 0; x < size / 2; ++x)
        for (int ch = 0; ch < 3; ++ch)
          std::swap(row[3 * x + ch], row[3 * (size - 1 - x) + ch]);
    }
  }
  normalize_out(resized.data(), size, mean, stdv, out);
  return 0;
}

// Batched eval decode with an internal thread pool. jpegs: concatenated
// buffers; offsets[i]..offsets[i+1] delimit sample i (offsets has n+1
// entries). out: [n, size, size, 3]. status[i]: 0 ok, 1 decode failure
// (caller re-decodes those via the PIL fallback). Returns count of
// failures.
int ip_decode_eval_batch(const uint8_t* jpegs, const uint64_t* offsets,
                         int n, int size, const float* mean,
                         const float* stdv, int n_threads, float* out,
                         int32_t* status, int dct_scale) {
  return run_decode_pool(n, n_threads, status, [&](int i) {
    return decode_eval_impl(
        jpegs + offsets[i], static_cast<size_t>(offsets[i + 1] - offsets[i]),
        size, mean, stdv, out + static_cast<size_t>(i) * size * size * 3,
        dct_scale);
  });
}

// Batched uint8-boundary decode (thread pool, same contract as
// ip_decode_eval_batch but emitting uint8 crops).
int ip_decode_eval_batch_u8(const uint8_t* jpegs, const uint64_t* offsets,
                            int n, int size, int n_threads, uint8_t* out,
                            int32_t* status, int dct_scale) {
  return run_decode_pool(n, n_threads, status, [&](int i) {
    return decode_eval_crop_u8(
        jpegs + offsets[i], static_cast<size_t>(offsets[i + 1] - offsets[i]),
        size, out + static_cast<size_t>(i) * size * size * 3, dct_scale);
  });
}

}  // extern "C"
