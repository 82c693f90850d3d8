// A float32 2-D convolution summed in XLA:CPU's order.
//
// XLA:CPU runs a float32 convolution (HLO `convolution`, NHWC x HWIO) as
// Eigen's tensor contraction of the image patches, k = (kh, kw, cin) in
// that order, on its thread pool: the contraction dimension is cut into
// blocks of `kc`; inside a block each output accumulates one fused
// multiply-add per k, from zero, in k order; the blocks' partial sums are
// added to the output in block order.  This computes exactly that, so its
// bits equal XLA's (tools/cpu_parity_probe.py det).  Padding taps are
// skipped: a zero product leaves a sum unchanged.
//
//   x   [n, h, w, cin]      float32, NHWC
//   wt  [kh, kw, cin, cout] float32, HWIO
//   out [n, oh, ow, cout]   float32, NHWC
//
// Also a float32 dot [m, k] x [k, n] summed in one of XLA:CPU's orders
// (``models.common._xla_dot_order``): the k terms in blocks of `block`, each
// block's whole groups of `lanes` terms dealt to `lanes` partial sums (term
// i to partial i mod lanes), each partial a fused multiply-add chain from
// zero, the partials added pairwise, the terms that fill no group summed in
// one more chain and added to that, the blocks' sums added in order.  Rows
// run on `threads`
// threads; each row's order is fixed, so the bits do not depend on them.
//
// Also XLA:CPU's float32 rsqrt: the hardware estimate (`rsqrtps`) refined
// by two Newton steps, each `y + (-0.5 * y) * (x * y * y - 1)` with its
// multiply-adds fused as LLVM contracts them; zeros, subnormals, negative
// and infinite inputs keep the estimate.
#include <immintrin.h>

#include <algorithm>
#include <cmath>
#include <thread>
#include <vector>

namespace {

constexpr int kTile = 8;  // output pixels that share each weight row's load

void conv_rows(const float* x, const float* wt, float* out, int h, int w, int cin,
               int kh, int kw, int cout, int sh, int sw, int pt, int pl, int oh, int ow,
               int kc, long p0, long p1) {
  const int K = kh * kw * cin;
  std::vector<float> acc(static_cast<size_t>(kTile) * cout);
  const float* xr[kTile];
  for (long t0 = p0; t0 < p1; t0 += kTile) {
    const int np = static_cast<int>(std::min<long>(kTile, p1 - t0));
    std::fill(acc.begin(), acc.end(), 0.0f);
    bool first = true;
    int k = 0;
    int block_end = std::min(kc, K);
    for (int i = 0; i < kh; ++i) {
      for (int j = 0; j < kw; ++j) {
        for (int q = 0; q < np; ++q) {
          const long p = t0 + q;
          const long img = p / (static_cast<long>(oh) * ow);
          const int iy = static_cast<int>((p / ow) % oh) * sh + i - pt;
          const int ix = static_cast<int>(p % ow) * sw + j - pl;
          xr[q] = (iy >= 0 && iy < h && ix >= 0 && ix < w)
                      ? x + ((img * h + iy) * static_cast<long>(w) + ix) * cin
                      : nullptr;
        }
        for (int c = 0; c < cin; ++c, ++k) {
          const float* wr = wt + static_cast<long>(k) * cout;
          for (int q = 0; q < np; ++q) {
            if (xr[q] == nullptr) continue;
            const float v = xr[q][c];
            float* a = acc.data() + static_cast<size_t>(q) * cout;
            for (int co = 0; co < cout; ++co) a[co] = std::fma(v, wr[co], a[co]);
          }
          if (k + 1 == block_end) {
            for (int q = 0; q < np; ++q) {
              float* o = out + (t0 + q) * cout;
              const float* a = acc.data() + static_cast<size_t>(q) * cout;
              for (int co = 0; co < cout; ++co) o[co] = first ? a[co] : o[co] + a[co];
            }
            std::fill(acc.begin(), acc.end(), 0.0f);
            first = false;
            block_end = std::min(block_end + kc, K);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int rt_conv_xla(const float* x, const float* wt, float* out, int n, int h,
                           int w, int cin, int kh, int kw, int cout, int sh, int sw,
                           int pt, int pl, int oh, int ow, int kc, int threads) {
  if (n <= 0 || kc <= 0 || oh <= 0 || ow <= 0) return 1;
  const long pixels = static_cast<long>(n) * oh * ow;
  const int t = std::max(1, std::min<int>(threads, static_cast<int>(pixels)));
  std::vector<std::thread> pool;
  const long step = (pixels + t - 1) / t;
  for (int i = 0; i < t; ++i) {
    const long p0 = i * step, p1 = std::min(pixels, p0 + step);
    if (p0 >= p1) break;
    pool.emplace_back(conv_rows, x, wt, out, h, w, cin, kh, kw, cout, sh, sw, pt, pl, oh,
                      ow, kc, p0, p1);
  }
  for (auto& th : pool) th.join();
  return 0;
}

namespace {

void dot_rows(const float* a, const float* w, float* out, int k, int n, int lanes,
              int block, long r0, long r1) {
  std::vector<float> part(static_cast<size_t>(lanes) * n);
  for (long r = r0; r < r1; ++r) {
    const float* ar = a + r * k;
    float* o = out + r * n;
    for (int b0 = 0; b0 < k; b0 += block) {
      std::fill(part.begin(), part.end(), 0.0f);
      const int b1 = std::min(k, b0 + block);
      // the lanes take whole groups of ``lanes`` terms
      const int lanes_end = b0 + (b1 - b0) / lanes * lanes;
      for (int i = b0; i < lanes_end; ++i) {
        float* acc = part.data() + static_cast<size_t>((i - b0) % lanes) * n;
        const float v = ar[i];
        const float* wr = w + static_cast<long>(i) * n;
        for (int j = 0; j < n; ++j) acc[j] = std::fma(v, wr[j], acc[j]);
      }
      for (int width = 1; width < lanes; width *= 2) {  // pairwise
        for (int l = 0; l + width < lanes; l += 2 * width) {
          float* x = part.data() + static_cast<size_t>(l) * n;
          const float* y = x + static_cast<size_t>(width) * n;
          for (int j = 0; j < n; ++j) x[j] += y[j];
        }
      }
      if (lanes_end < b1) {  // the terms left over: one chain (in lane 1's
        float* tail = part.data() + n;  // spent slot), then one add
        std::fill(tail, tail + n, 0.0f);
        for (int i = lanes_end; i < b1; ++i) {
          const float v = ar[i];
          const float* wr = w + static_cast<long>(i) * n;
          for (int j = 0; j < n; ++j) tail[j] = std::fma(v, wr[j], tail[j]);
        }
        for (int j = 0; j < n; ++j) part[j] += tail[j];
      }
      for (int j = 0; j < n; ++j) o[j] = b0 == 0 ? part[j] : o[j] + part[j];
    }
  }
}

}  // namespace

extern "C" int rt_dot_xla(const float* a, const float* w, float* out, int m, int k, int n,
                          int lanes, int block, int threads) {
  if (m <= 0 || k <= 0 || n <= 0 || lanes <= 0 || block <= 0) return 1;
  const int t = std::max(1, std::min(threads, m));
  std::vector<std::thread> pool;
  const long step = (static_cast<long>(m) + t - 1) / t;
  for (int i = 0; i < t; ++i) {
    const long r0 = i * step, r1 = std::min<long>(m, r0 + step);
    if (r0 >= r1) break;
    pool.emplace_back(dot_rows, a, w, out, k, n, lanes, block, r0, r1);
  }
  for (auto& th : pool) th.join();
  return 0;
}

extern "C" void rt_rsqrt_xla(const float* x, float* out, int n) {
  for (int i = 0; i < n; ++i) {
    const float v = x[i];
    const float y = _mm_cvtss_f32(_mm_rsqrt_ps(_mm_set1_ps(v)));
    if (!(std::isnormal(v) && v > 0.0f)) {
      out[i] = std::isnan(v) ? std::nanf("") : y;
      continue;
    }
    const float y1 = std::fma(y * -0.5f, std::fma(v * y, y, -1.0f), y);
    out[i] = std::fma(y1 * -0.5f, std::fma(v * y1, y1, -1.0f), y1);
  }
}
