// Native DB detection postprocess.
//
// C++ counterpart of retto_tpu/ops/{contours,raster,det_postprocess}.py and
// retto_tpu/geometry.py's min_area_rect/unclip — the slot the reference
// fills with native code (clipper-sys C++ polygon offset + imageproc's
// contour tracing, det_processor.rs:223-252, :293).  Semantics must match
// the NumPy implementation bit-for-bit (tests compare both backends on the
// same inputs); every rounding rule below mirrors the Python path.
//
// Build: g++ -O3 -shared -fPIC -o libretto_post.so postprocess.cpp
// API: one fused entry point, rt_det_postprocess (see bottom).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct P {
  double x, y;
};

// ---------------------------------------------------------------- hull //
// Andrew monotone chain matching geometry.convex_hull: lexicographic sort
// by (x, y), dedup, cross<=0 popping; returns lower+upper ring.
std::vector<P> convex_hull(std::vector<P> pts) {
  std::sort(pts.begin(), pts.end(), [](const P& a, const P& b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  pts.erase(std::unique(pts.begin(), pts.end(),
                        [](const P& a, const P& b) {
                          return a.x == b.x && a.y == b.y;
                        }),
            pts.end());
  size_t n = pts.size();
  if (n <= 2) return pts;
  auto cross = [](const P& o, const P& a, const P& b) {
    return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
  };
  std::vector<P> hull;
  for (const P& p : pts) {  // lower
    while (hull.size() >= 2 &&
           cross(hull[hull.size() - 2], hull.back(), p) <= 0)
      hull.pop_back();
    hull.push_back(p);
  }
  size_t lower = hull.size() + 1;
  for (auto it = pts.rbegin(); it != pts.rend(); ++it) {  // upper
    while (hull.size() >= lower &&
           cross(hull[hull.size() - 2], hull.back(), *it) <= 0)
      hull.pop_back();
    hull.push_back(*it);
  }
  hull.pop_back();
  return hull;
}

// order 4 corners clockwise from top-left (geometry.order_clockwise_tl:
// stable sort by x; of the two leftmost the upper is TL).
void order_clockwise_tl(P box[4]) {
  int idx[4] = {0, 1, 2, 3};
  std::stable_sort(idx, idx + 4,
                   [&](int a, int b) { return box[a].x < box[b].x; });
  P l0 = box[idx[0]], l1 = box[idx[1]], r0 = box[idx[2]], r1 = box[idx[3]];
  P tl = (l0.y <= l1.y) ? l0 : l1;
  P bl = (l0.y <= l1.y) ? l1 : l0;
  P tr = (r0.y <= r1.y) ? r0 : r1;
  P br = (r0.y <= r1.y) ? r1 : r0;
  box[0] = tl; box[1] = tr; box[2] = br; box[3] = bl;
}

// rotating calipers min-area rect (geometry.min_area_rect); returns corners
// clockwise-from-TL.  sside (min of top/bottom edge lengths — the
// reference's quirk, det_processor.rs:182-185) is computed by the caller
// after rounding.
bool min_area_rect(const std::vector<P>& points, P out[4]) {
  std::vector<P> hull = convex_hull(points);
  size_t n = hull.size();
  if (n == 0) return false;
  if (n == 1) {
    out[0] = out[1] = out[2] = out[3] = hull[0];
    return true;
  }
  if (n == 2) {
    out[0] = hull[0]; out[1] = hull[1]; out[2] = hull[1]; out[3] = hull[0];
    order_clockwise_tl(out);
    return true;
  }
  // unique angles mod pi/2 (matches np.unique on the angle array)
  std::vector<double> angles;
  for (size_t i = 0; i < n; i++) {
    P e{hull[(i + 1) % n].x - hull[i].x, hull[(i + 1) % n].y - hull[i].y};
    double a = std::fmod(std::atan2(e.y, e.x), M_PI / 2.0);
    if (a < 0) a += M_PI / 2.0;
    angles.push_back(a);
  }
  std::sort(angles.begin(), angles.end());
  angles.erase(std::unique(angles.begin(), angles.end()), angles.end());
  double best_area = 1e300;
  P best[4] = {};
  for (double a : angles) {
    double c = std::cos(a), s = std::sin(a);
    double mnx = 1e300, mny = 1e300, mxx = -1e300, mxy = -1e300;
    for (const P& p : hull) {
      double px = p.x * c + p.y * s;     // rot = [[c, s], [-s, c]]
      double py = -p.x * s + p.y * c;
      mnx = std::min(mnx, px); mxx = std::max(mxx, px);
      mny = std::min(mny, py); mxy = std::max(mxy, py);
    }
    double area = (mxx - mnx) * (mxy - mny);
    if (area < best_area) {
      best_area = area;
      P corners[4] = {{mnx, mny}, {mxx, mny}, {mxx, mxy}, {mnx, mxy}};
      for (int k = 0; k < 4; k++) {  // rotate back: corners @ rot
        best[k].x = corners[k].x * c - corners[k].y * s;
        best[k].y = corners[k].x * s + corners[k].y * c;
      }
    }
  }
  // float32 round-trip to match the numpy path's float32 box dtype
  for (int k = 0; k < 4; k++) {
    best[k].x = (double)(float)best[k].x;
    best[k].y = (double)(float)best[k].y;
  }
  order_clockwise_tl(best);
  for (int k = 0; k < 4; k++) out[k] = best[k];
  return true;
}

double polygon_area(const std::vector<P>& poly) {
  double s = 0;
  size_t n = poly.size();
  for (size_t i = 0; i < n; i++) {
    const P& a = poly[i];
    const P& b = poly[(i + 1) % n];
    s += a.x * b.y - a.y * b.x;
  }
  return std::fabs(s) / 2.0;
}

double polygon_perimeter(const std::vector<P>& poly) {
  double s = 0;
  size_t n = poly.size();
  for (size_t i = 0; i < n; i++) {
    const P& a = poly[i];
    const P& b = poly[(i + 1) % n];
    s += std::hypot(b.x - a.x, b.y - a.y);
  }
  return s;
}

// round-join outward offset (geometry.unclip); arc step 15 deg; output
// coordinates rounded to integers (clipper scale-1.0 parity).
std::vector<P> unclip(const P box[4], double ratio) {
  std::vector<P> poly(box, box + 4);
  double area = polygon_area(poly);
  double per = polygon_perimeter(poly);
  if (per <= 0) return poly;
  double dist = area * ratio / per;
  // ensure clockwise in image coords (positive shoelace)
  double signed_area = 0;
  for (size_t i = 0; i < 4; i++) {
    const P& a = poly[i];
    const P& b = poly[(i + 1) % 4];
    signed_area += a.x * b.y - a.y * b.x;
  }
  if (signed_area < 0) std::reverse(poly.begin(), poly.end());

  auto outward_normal = [](const P& a, const P& b) -> P {
    double dx = b.x - a.x, dy = b.y - a.y;
    double n = std::hypot(dx, dy);
    if (n == 0) return {0, 0};
    return {dy / n, -dx / n};
  };
  const double step = 15.0 * M_PI / 180.0;
  std::vector<P> out;
  for (size_t i = 0; i < 4; i++) {
    const P& prev = poly[(i + 3) % 4];
    const P& cur = poly[i];
    const P& nxt = poly[(i + 1) % 4];
    P nin = outward_normal(prev, cur);
    P nout = outward_normal(cur, nxt);
    double a0 = std::atan2(nin.y, nin.x);
    double a1 = std::atan2(nout.y, nout.x);
    double sweep = std::fmod(a1 - a0, 2 * M_PI);
    if (sweep < 0) sweep += 2 * M_PI;
    if (sweep > M_PI) {
      out.push_back({cur.x + dist * nin.x, cur.y + dist * nin.y});
      out.push_back({cur.x + dist * nout.x, cur.y + dist * nout.y});
      continue;
    }
    int steps = std::max(1, (int)std::ceil(sweep / step));
    for (int k = 0; k <= steps; k++) {
      double ang = a0 + sweep * ((double)k / steps);
      out.push_back({cur.x + dist * std::cos(ang), cur.y + dist * std::sin(ang)});
    }
  }
  for (P& p : out) {
    // np.round == ties-to-even on the float32 value
    p.x = std::nearbyint((double)(float)p.x);
    p.y = std::nearbyint((double)(float)p.y);
  }
  return out;
}

// mean prob inside quad (ops.raster.box_score_fast): clamp bbox, inclusive
// convex fill in either orientation.
float box_score(const float* pred, int h, int w, const P quad[4]) {
  double minx = 1e300, maxx = -1e300, miny = 1e300, maxy = -1e300;
  for (int k = 0; k < 4; k++) {
    minx = std::min(minx, quad[k].x); maxx = std::max(maxx, quad[k].x);
    miny = std::min(miny, quad[k].y); maxy = std::max(maxy, quad[k].y);
  }
  int x0 = (int)std::clamp(std::floor(minx), 0.0, (double)w - 1);
  int x1 = (int)std::clamp(std::ceil(maxx), 0.0, (double)w - 1);
  int y0 = (int)std::clamp(std::floor(miny), 0.0, (double)h - 1);
  int y1 = (int)std::clamp(std::ceil(maxy), 0.0, (double)h - 1);
  double sum = 0;
  long cnt = 0;
  for (int y = y0; y <= y1; y++) {
    for (int x = x0; x <= x1; x++) {
      bool neg = true, pos = true;
      for (int k = 0; k < 4; k++) {
        const P& a = quad[k];
        const P& b = quad[(k + 1) % 4];
        double cr = (b.x - a.x) * (y - a.y) - (b.y - a.y) * (x - a.x);
        neg &= cr <= 0;
        pos &= cr >= 0;
      }
      if (neg || pos) {
        sum += pred[y * w + x];
        cnt++;
      }
    }
  }
  return cnt ? (float)(sum / cnt) : 0.0f;
}

// connected components (8-conn fg) raster order, collecting boundary
// pixels (fg with a 4-neighbor bg/edge); then hole rings (4-conn bg
// regions not touching the border) — mirrors ops.contours.
struct Contours {
  std::vector<std::vector<P>> sets;
};

void find_contours(const uint8_t* mask, int h, int w, Contours& out) {
  // visited flags are u8 (labels were only ever tested non-zero), and the
  // raster scan skips 8 empty mask bytes per step — text masks are sparse,
  // and this pass is on the single-core host's critical path
  std::vector<uint8_t> label(h * w, 0);
  std::vector<int32_t> stack;
  auto at = [&](int y, int x) { return y * w + x; };
  // fg components, 8-connectivity
  std::vector<std::vector<P>> comps;
  size_t n_fg = 0;
  for (int y = 0; y < h; y++) {
    const uint8_t* mrow = mask + (size_t)y * w;
    int x = 0;
    while (x < w) {
      if (x + 8 <= w) {
        uint64_t mword;
        std::memcpy(&mword, mrow + x, 8);
        if (mword == 0) {
          x += 8;
          continue;
        }
      }
      if (!mrow[x] || label[at(y, x)]) {
        x++;
        continue;
      }
      comps.emplace_back();
      stack.push_back(at(y, x));
      label[at(y, x)] = 1;
      n_fg++;
      while (!stack.empty()) {
        int idx = stack.back();
        stack.pop_back();
        int cy = idx / w, cx = idx % w;
        bool boundary = cy == 0 || cy == h - 1 || cx == 0 || cx == w - 1 ||
                        !mask[at(cy - 1, cx)] || !mask[at(cy + 1, cx)] ||
                        !mask[at(cy, cx - 1)] || !mask[at(cy, cx + 1)];
        if (boundary) comps.back().push_back({(double)cx, (double)cy});
        for (int dy = -1; dy <= 1; dy++) {
          for (int dx = -1; dx <= 1; dx++) {
            int ny = cy + dy, nx = cx + dx;
            if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
            if (mask[at(ny, nx)] && !label[at(ny, nx)]) {
              label[at(ny, nx)] = 1;
              n_fg++;
              stack.push_back(at(ny, nx));
            }
          }
        }
      }
      x++;
    }
  }
  for (auto& c : comps) out.sets.push_back(std::move(c));
  // hole rings: bg 4-conn regions not touching the border.  One flood from
  // the border classifies all outside bg; anything left is hole pixels
  // (usually none — the flood is the only full-image bg pass).
  std::vector<uint8_t> outside(h * w, 0);
  const int d4[4][2] = {{-1, 0}, {1, 0}, {0, -1}, {0, 1}};
  size_t n_outside = 0;
  // scanline flood: seeds are whole horizontal bg runs, pushed once
  std::vector<std::pair<int, std::pair<int, int>>> runs;  // (y, [x0, x1))
  auto push_run = [&](int y, int x0, int x1) {
    // extend to the full bg run containing [x0, x1)
    while (x0 > 0 && !mask[at(y, x0 - 1)] && !outside[at(y, x0 - 1)]) x0--;
    while (x1 < w && !mask[at(y, x1)] && !outside[at(y, x1)]) x1++;
    bool any = false;
    for (int x = x0; x < x1; x++) {
      if (!outside[at(y, x)]) { outside[at(y, x)] = 1; n_outside++; any = true; }
    }
    if (any) runs.push_back({y, {x0, x1}});
  };
  for (int x = 0; x < w; x++) {
    if (!mask[at(0, x)] && !outside[at(0, x)]) push_run(0, x, x + 1);
    if (!mask[at(h - 1, x)] && !outside[at(h - 1, x)]) push_run(h - 1, x, x + 1);
  }
  for (int y = 0; y < h; y++) {
    if (!mask[at(y, 0)] && !outside[at(y, 0)]) push_run(y, 0, 1);
    if (!mask[at(y, w - 1)] && !outside[at(y, w - 1)]) push_run(y, w - 1, w);
  }
  while (!runs.empty()) {
    auto [y, xr] = runs.back();
    runs.pop_back();
    for (int ny : {y - 1, y + 1}) {
      if (ny < 0 || ny >= h) continue;
      int x = xr.first;
      while (x < xr.second) {
        if (!mask[at(ny, x)] && !outside[at(ny, x)]) {
          int x0 = x;
          while (x < w && !mask[at(ny, x)] && !outside[at(ny, x)]) x++;
          push_run(ny, x0, x);
        } else {
          x++;
        }
      }
    }
  }
  // hole pixels = everything neither fg nor outside; usually none, and
  // then the whole third pass is skipped
  if (n_fg + n_outside == (size_t)h * (size_t)w) return;
  std::vector<uint8_t> blabel(h * w, 0);
  for (int y = 1; y < h - 1; y++) {
    for (int x = 1; x < w - 1; x++) {
      if (mask[at(y, x)] || outside[at(y, x)] || blabel[at(y, x)]) continue;
      std::vector<int32_t> pix;
      stack.push_back(at(y, x));
      blabel[at(y, x)] = 1;
      while (!stack.empty()) {
        int idx = stack.back();
        stack.pop_back();
        pix.push_back(idx);
        int cy = idx / w, cx = idx % w;
        for (auto& d : d4) {
          int ny = cy + d[0], nx = cx + d[1];
          if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
          if (!mask[at(ny, nx)] && !blabel[at(ny, nx)] && !outside[at(ny, nx)]) {
            blabel[at(ny, nx)] = 1;
            stack.push_back(at(ny, nx));
          }
        }
      }
      // ring = fg pixels 8-adjacent to the hole
      std::vector<uint8_t> seen(h * w, 0);
      std::vector<P> ring;
      for (int idx : pix) {
        int cy = idx / w, cx = idx % w;
        for (int dy = -1; dy <= 1; dy++) {
          for (int dx = -1; dx <= 1; dx++) {
            int ny = cy + dy, nx = cx + dx;
            if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
            if (mask[at(ny, nx)] && !seen[at(ny, nx)]) {
              seen[at(ny, nx)] = 1;
              ring.push_back({(double)nx, (double)ny});
            }
          }
        }
      }
      if (!ring.empty()) {
        // match numpy np.nonzero raster order
        std::sort(ring.begin(), ring.end(), [](const P& a, const P& b) {
          return a.y < b.y || (a.y == b.y && a.x < b.x);
        });
        out.sets.push_back(std::move(ring));
      }
    }
  }
}

// fn(k) for every k in [0, n) on up to `threads` threads, the caller's
// among them; each thread takes the next k from a shared counter, so a
// page that ends early (a colour page's probe) frees its thread for the
// next one.
template <class F>
void parallel_for(int n, int threads, F fn) {
  const int t = std::max(1, std::min(threads, n));
  if (t == 1) {
    for (int k = 0; k < n; k++) fn(k);
    return;
  }
  std::atomic<int> next{0};
  auto work = [&] {
    for (int k; (k = next.fetch_add(1)) < n;) fn(k);
  };
  std::vector<std::thread> pool;
  pool.reserve(t - 1);
  for (int i = 1; i < t; i++) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Split API, first half: contours -> integer min-area rects -> sside
// filter.  Returns candidate count; quads into out_boxes (max_boxes*8).
int rt_det_candidates(const uint8_t* mask, int h, int w,
                      int min_mini_box_size, int max_candidates,
                      float* out_boxes, int max_boxes) {
  Contours cont;
  find_contours(mask, h, w, cont);
  size_t ncand = cont.sets.size();
  if (max_candidates > 0 && ncand > (size_t)max_candidates)
    ncand = max_candidates;
  int n = 0;
  for (size_t ci = 0; ci < ncand && n < max_boxes; ci++) {
    P box[4];
    if (!min_area_rect(cont.sets[ci], box)) continue;
    for (int k = 0; k < 4; k++) {
      box[k].x = std::nearbyint((double)(float)box[k].x);
      box[k].y = std::nearbyint((double)(float)box[k].y);
    }
    double side1 = std::hypot(box[0].x - box[1].x, box[0].y - box[1].y);
    double side2 = std::hypot(box[3].x - box[2].x, box[3].y - box[2].y);
    if (std::min(side1, side2) < (double)min_mini_box_size) continue;
    for (int k = 0; k < 4; k++) {
      out_boxes[n * 8 + k * 2] = (float)box[k].x;
      out_boxes[n * 8 + k * 2 + 1] = (float)box[k].y;
    }
    n++;
  }
  return n;
}

// Split API, second half: score filter -> unclip -> re-rect -> rescale ->
// size filter -> reading-order sort.  cand_boxes/cand_scores: M candidates.
int rt_det_finalize(const float* cand_boxes, const float* cand_scores, int m,
                    double box_thresh, double unclip_ratio,
                    int min_mini_box_size, int bitmap_h, int bitmap_w,
                    int dest_h, int dest_w, float* out_boxes,
                    float* out_scores, int max_boxes) {
  struct Cand {
    P box[4];
    float score;
    double cx, cy;
  };
  std::vector<Cand> cands;
  for (int ci = 0; ci < m; ci++) {
    if (cand_scores[ci] < box_thresh) continue;
    P box[4];
    for (int k = 0; k < 4; k++)
      box[k] = {cand_boxes[ci * 8 + k * 2], cand_boxes[ci * 8 + k * 2 + 1]};
    std::vector<P> grown = unclip(box, unclip_ratio);
    P box2[4];
    if (!min_area_rect(grown, box2)) continue;
    double s1 = std::hypot(box2[0].x - box2[1].x, box2[0].y - box2[1].y);
    double s2 = std::hypot(box2[3].x - box2[2].x, box2[3].y - box2[2].y);
    if (std::min(s1, s2) < (double)(min_mini_box_size + 2)) continue;
    P box3[4];
    double invx = (double)dest_w / bitmap_w, invy = (double)dest_h / bitmap_h;
    for (int k = 0; k < 4; k++) {
      double xx = std::nearbyint((double)(float)box2[k].x * invx);
      double yy = std::nearbyint((double)(float)box2[k].y * invy);
      box3[k].x = (double)(float)std::clamp(xx, 0.0, (double)dest_w - 1);
      box3[k].y = (double)(float)std::clamp(yy, 0.0, (double)dest_h - 1);
    }
    double bh = std::hypot(box3[0].x - box3[3].x, box3[0].y - box3[3].y);
    double bw = std::hypot(box3[0].x - box3[1].x, box3[0].y - box3[1].y);
    if (bh <= 3.0 || bw <= 3.0) continue;
    Cand c;
    std::memcpy(c.box, box3, sizeof(box3));
    c.score = cand_scores[ci];
    c.cx = (box3[0].x + box3[2].x) / 2.0;
    c.cy = (box3[0].y + box3[2].y) / 2.0;
    cands.push_back(c);
  }
  std::vector<int> idx(cands.size());
  for (size_t i = 0; i < idx.size(); i++) idx[i] = (int)i;
  std::stable_sort(idx.begin(), idx.end(), [&](int a, int b) {
    return (float)cands[a].cy < (float)cands[b].cy;
  });
  int n = (int)idx.size();
  for (int i = 0; i < n - 1; i++) {
    for (int j = i; j >= 0; j--) {
      int a = idx[j], b = idx[j + 1];
      if (std::fabs((float)cands[b].cy - (float)cands[a].cy) < 10.0f &&
          (float)cands[b].cx < (float)cands[a].cx) {
        std::swap(idx[j], idx[j + 1]);
      } else {
        break;
      }
    }
  }
  int out_n = std::min(n, max_boxes);
  for (int i = 0; i < out_n; i++) {
    const Cand& c = cands[idx[i]];
    for (int k = 0; k < 4; k++) {
      out_boxes[i * 8 + k * 2] = (float)c.box[k].x;
      out_boxes[i * 8 + k * 2 + 1] = (float)c.box[k].y;
    }
    out_scores[i] = c.score;
  }
  return out_n;
}

// Fused det postprocess.  Inputs: pred [h*w] f32 prob map, mask [h*w] u8,
// dest_h/dest_w rescale target, thresholds.  Outputs: boxes (max_boxes*8
// floats, clockwise-from-TL), scores (max_boxes).  Returns box count.
int rt_det_postprocess(const float* pred, const uint8_t* mask, int h, int w,
                       double box_thresh, double unclip_ratio,
                       int min_mini_box_size, int max_candidates,
                       int dest_h, int dest_w, float* out_boxes,
                       float* out_scores, int max_boxes) {
  Contours cont;
  find_contours(mask, h, w, cont);
  size_t ncand = cont.sets.size();
  if (max_candidates > 0 && ncand > (size_t)max_candidates)
    ncand = max_candidates;

  struct Cand {
    P box[4];
    float score;
    double cx, cy;
  };
  std::vector<Cand> cands;
  for (size_t ci = 0; ci < ncand; ci++) {
    P box[4];
    if (!min_area_rect(cont.sets[ci], box)) continue;
    // quantize like the reference's integer-typed first mini box
    for (int k = 0; k < 4; k++) {
      box[k].x = std::nearbyint((double)(float)box[k].x);
      box[k].y = std::nearbyint((double)(float)box[k].y);
    }
    double side1 = std::hypot(box[0].x - box[1].x, box[0].y - box[1].y);
    double side2 = std::hypot(box[3].x - box[2].x, box[3].y - box[2].y);
    if (std::min(side1, side2) < (double)min_mini_box_size) continue;
    float score = box_score(pred, h, w, box);
    if (score < box_thresh) continue;
    std::vector<P> grown = unclip(box, unclip_ratio);
    P box2[4];
    if (!min_area_rect(grown, box2)) continue;
    double s1 = std::hypot(box2[0].x - box2[1].x, box2[0].y - box2[1].y);
    double s2 = std::hypot(box2[3].x - box2[2].x, box2[3].y - box2[2].y);
    if (std::min(s1, s2) < (double)(min_mini_box_size + 2)) continue;
    // scale_and_clip (points.rs:179-194 via geometry.scale_and_clip:
    // float64 scale, np.round ties-to-even, clamp)
    P box3[4];
    double invx = (double)dest_w / w, invy = (double)dest_h / h;
    for (int k = 0; k < 4; k++) {
      double xx = std::nearbyint((double)(float)box2[k].x * invx);
      double yy = std::nearbyint((double)(float)box2[k].y * invy);
      box3[k].x = (double)(float)std::clamp(xx, 0.0, (double)dest_w - 1);
      box3[k].y = (double)(float)std::clamp(yy, 0.0, (double)dest_h - 1);
    }
    double bh = std::hypot(box3[0].x - box3[3].x, box3[0].y - box3[3].y);
    double bw = std::hypot(box3[0].x - box3[1].x, box3[0].y - box3[1].y);
    if (bh <= 3.0 || bw <= 3.0) continue;
    Cand c;
    std::memcpy(c.box, box3, sizeof(box3));
    c.score = score;
    c.cx = (box3[0].x + box3[2].x) / 2.0;
    c.cy = (box3[0].y + box3[2].y) / 2.0;
    cands.push_back(c);
  }

  // reading-order sort: stable by center y, then adjacent left-right swaps
  // within 10 px rows (geometry.sort_boxes_reading_order)
  std::vector<int> idx(cands.size());
  for (size_t i = 0; i < idx.size(); i++) idx[i] = (int)i;
  std::stable_sort(idx.begin(), idx.end(), [&](int a, int b) {
    return (float)cands[a].cy < (float)cands[b].cy;
  });
  int n = (int)idx.size();
  for (int i = 0; i < n - 1; i++) {
    for (int j = i; j >= 0; j--) {
      int a = idx[j], b = idx[j + 1];
      if (std::fabs((float)cands[b].cy - (float)cands[a].cy) < 10.0f &&
          (float)cands[b].cx < (float)cands[a].cx) {
        std::swap(idx[j], idx[j + 1]);
      } else {
        break;
      }
    }
  }

  int out_n = std::min(n, max_boxes);
  for (int i = 0; i < out_n; i++) {
    const Cand& c = cands[idx[i]];
    for (int k = 0; k < 4; k++) {
      out_boxes[i * 8 + k * 2] = (float)c.box[k].x;
      out_boxes[i * 8 + k * 2 + 1] = (float)c.box[k].y;
    }
    out_scores[i] = c.score;
  }
  return out_n;
}


// Batched candidates over a whole det chunk, reading the device's packed
// 1-bit masks directly: ONE GIL-released call per chunk instead of
// per-image unpack + call round trips (the host has a single core; every
// Python<->C bounce during the pipeline's hot phase is throughput).
// packed: [b, ph, pw] u8.  row_packed != 0 -> [H/8, W] layout (Pallas
// kernel, bit r of packed[g][x] is row 8g+r, MSB first); otherwise
// [H, ceil(W/8)] with bits along x.  hs/ws give each image's valid mask
// size.  Boxes go to out_boxes[k * max_boxes_per_img * 8 ...]; counts to
// out_counts[k].
int rt_det_candidates_batch(const uint8_t* packed, int b, int ph, int pw,
                            int row_packed, const int32_t* hs,
                            const int32_t* ws, int min_mini_box_size,
                            int max_candidates, float* out_boxes,
                            int32_t* out_counts, int max_boxes_per_img) {
  std::vector<uint8_t> buf;
  for (int k = 0; k < b; k++) {
    int h = hs[k], w = ws[k];
    buf.assign((size_t)h * w, 0);
    const uint8_t* src0 = packed + (size_t)k * ph * pw;
    if (row_packed) {
      for (int y = 0; y < h; y++) {
        const uint8_t* src = src0 + (size_t)(y >> 3) * pw;
        uint8_t bit = (uint8_t)(1u << (7 - (y & 7)));
        uint8_t* dst = buf.data() + (size_t)y * w;
        for (int x = 0; x < w; x++) dst[x] = (src[x] & bit) ? 1 : 0;
      }
    } else {
      for (int y = 0; y < h; y++) {
        const uint8_t* src = src0 + (size_t)y * pw;
        uint8_t* dst = buf.data() + (size_t)y * w;
        for (int x = 0; x < w; x++)
          dst[x] = (uint8_t)((src[x >> 3] >> (7 - (x & 7))) & 1);
      }
    }
    out_counts[k] = rt_det_candidates(
        buf.data(), h, w, min_mini_box_size, max_candidates,
        out_boxes + (size_t)k * max_boxes_per_img * 8, max_boxes_per_img);
  }
  return 0;
}


// Whole det-chunk postprocess in ONE GIL-released call (round-3 host-floor
// work, VERDICT r2 item 3): unpack packed 1-bit masks -> contours ->
// integer min-area rects (sside filter at mask scale) -> scale quads by
// ``stride`` to det coords -> score on the 4x4-mean-pooled u8 prob map
// (the bilinear 16x64-grid mean of device_pipeline._score_candidates) ->
// finalize (threshold/unclip/re-rect/rescale/sort, rt_det_finalize
// semantics).  Replaces three per-image Python loops on the single-core
// host with one native pass per chunk.
//
// packed: [b, ph, pw] u8 (layout per row_packed, see
// rt_det_candidates_batch).  prob4: [b, p4h, p4w] u8, det/4 grid.
// mhs/mws: valid mask sizes (det/stride).  rhs/rws: det-res bitmap sizes.
// ahs/aws: dest (session) sizes.  Boxes out in session coords.
int rt_det_chunk(const uint8_t* packed, int b, int ph, int pw, int row_packed,
                 const uint8_t* prob4, int p4h, int p4w,
                 const int32_t* mhs, const int32_t* mws, int stride,
                 const int32_t* rhs, const int32_t* rws,
                 const int32_t* ahs, const int32_t* aws,
                 int min_sside, int max_candidates, double box_thresh,
                 double unclip_ratio, int min_mini_box_size,
                 float* out_boxes, float* out_scores, int32_t* out_counts,
                 int max_boxes_per_img) {
  std::vector<uint8_t> buf;
  std::vector<float> cands(max_boxes_per_img * 8);
  std::vector<float> scores(max_boxes_per_img);
  for (int k = 0; k < b; k++) {
    int h = mhs[k], w = mws[k];
    buf.assign((size_t)h * w, 0);
    const uint8_t* src0 = packed + (size_t)k * ph * pw;
    if (row_packed) {
      for (int y = 0; y < h; y++) {
        const uint8_t* src = src0 + (size_t)(y >> 3) * pw;
        uint8_t bit = (uint8_t)(1u << (7 - (y & 7)));
        uint8_t* dst = buf.data() + (size_t)y * w;
        for (int x = 0; x < w; x++) dst[x] = (src[x] & bit) ? 1 : 0;
      }
    } else {
      for (int y = 0; y < h; y++) {
        const uint8_t* src = src0 + (size_t)y * pw;
        uint8_t* dst = buf.data() + (size_t)y * w;
        for (int x = 0; x < w; x++)
          dst[x] = (uint8_t)((src[x >> 3] >> (7 - (x & 7))) & 1);
      }
    }
    int n = rt_det_candidates(buf.data(), h, w, min_sside, max_candidates,
                              cands.data(), max_boxes_per_img);
    // scale quads to det coords
    if (stride > 1)
      for (int i = 0; i < n * 8; i++) cands[i] *= (float)stride;
    // score each candidate on the pooled prob map: 16x64 bilinear grid
    // over the quad (exact mirror of _score_candidates; f32 ops, double
    // accumulation, mean/255)
    const uint8_t* pm = prob4 + (size_t)k * p4h * p4w;
    for (int i = 0; i < n; i++) {
      float qx[4], qy[4];
      for (int c = 0; c < 4; c++) {
        qx[c] = cands[i * 8 + c * 2] / 4.0f - 0.375f;
        qy[c] = cands[i * 8 + c * 2 + 1] / 4.0f - 0.375f;
      }
      double acc = 0.0;
      for (int vi = 0; vi < 16; vi++) {
        float vv = ((float)vi + 0.5f) / 16.0f;
        for (int ui = 0; ui < 64; ui++) {
          float uu = ((float)ui + 0.5f) / 64.0f;
          float w00 = (1.0f - uu) * (1.0f - vv);
          float w10 = uu * (1.0f - vv);
          float w11 = uu * vv;
          float w01 = (1.0f - uu) * vv;
          float gx = w00 * qx[0] + w10 * qx[1] + w11 * qx[2] + w01 * qx[3];
          float gy = w00 * qy[0] + w10 * qy[1] + w11 * qy[2] + w01 * qy[3];
          float x = std::clamp(gx, 0.0f, (float)p4w - 1.001f);
          float y = std::clamp(gy, 0.0f, (float)p4h - 1.001f);
          int x0 = (int)std::floor(x);
          int y0 = (int)std::floor(y);
          float fx = x - (float)x0;
          float fy = y - (float)y0;
          const uint8_t* r0 = pm + (size_t)y0 * p4w + x0;
          const uint8_t* r1 = r0 + p4w;
          acc += (float)r0[0] * (1.0f - fx) * (1.0f - fy) +
                 (float)r0[1] * fx * (1.0f - fy) +
                 (float)r1[0] * (1.0f - fx) * fy + (float)r1[1] * fx * fy;
        }
      }
      scores[i] = (float)(acc / 1024.0) / 255.0f;
    }
    out_counts[k] = rt_det_finalize(
        cands.data(), scores.data(), n, box_thresh, unclip_ratio,
        min_mini_box_size, rhs[k], rws[k], ahs[k], aws[k],
        out_boxes + (size_t)k * max_boxes_per_img * 8,
        out_scores + (size_t)k * max_boxes_per_img, max_boxes_per_img);
  }
  return 0;
}


// One-pass grayscale test for an interleaved RGB u8 image (R==G==B for
// every pixel).  The numpy equivalent costs two full-image comparison
// passes under the GIL; this is the per-image transfer-format probe of the
// DevicePipeline (rt_gray_batch, DevicePipeline._decode_one's fallback).
// Blocks of 4096 pixels OR their channel differences in a loop without
// branches (it vectorizes) and stop at the first block that differs.
int rt_is_gray(const uint8_t* rgb, int64_t n_px) {
  for (int64_t i0 = 0; i0 < n_px; i0 += 4096) {
    const uint8_t* p = rgb + i0 * 3;
    const int64_t m = std::min<int64_t>(4096, n_px - i0) * 3;
    uint8_t d = 0;
    for (int64_t i = 0; i < m; i += 3)
      d |= (uint8_t)((p[i] ^ p[i + 1]) | (p[i + 1] ^ p[i + 2]));
    if (d) return 0;
  }
  return 1;
}

// Fused edge-replicate pad + planar YUV 4:2:0 pack, one pass over the
// interleaved RGB image (the host->device transfer codec,
// image/yuv.py).  Replaces PIL convert("L") + BOX resize + YCbCr convert
// + np.pad (four passes + copies) in DevicePipeline._decode_one on the
// single-core host.  Y matches PIL convert("L") bit-exactly
// ((19595 R + 38470 G + 7471 B + 0x8000) >> 16); chroma is the JFIF
// box-downsample + BT.601 full-range matrix, within +-1 of the PIL chain
// (parity-tested, tests/test_native.py).
// rgb: [h, w, 3]; y_out: [hp, wp]; uv_out: [hp/2, wp/2, 2]; hp/wp even,
// >= h/w; rows/cols beyond the valid extent replicate the edge pixel.
int rt_pack_yuv420(const uint8_t* rgb, int h, int w, int hp, int wp,
                   uint8_t* y_out, uint8_t* uv_out) {
  if (hp % 2 || wp % 2) return -1;
  int wp2 = wp / 2;
  std::vector<int32_t> rsum(wp2), gsum(wp2), bsum(wp2);
  for (int yy = 0; yy < hp; yy += 2) {
    for (int dy = 0; dy < 2; dy++) {
      int sy = std::min(yy + dy, h - 1);
      const uint8_t* row = rgb + (size_t)sy * w * 3;
      uint8_t* yrow = y_out + (size_t)(yy + dy) * wp;
      if (dy == 0) {
        std::fill(rsum.begin(), rsum.end(), 0);
        std::fill(gsum.begin(), gsum.end(), 0);
        std::fill(bsum.begin(), bsum.end(), 0);
      }
      for (int x = 0; x < wp; x++) {
        int sx = std::min(x, w - 1);
        const uint8_t* p = row + (size_t)sx * 3;
        int r = p[0], g = p[1], b = p[2];
        yrow[x] = (uint8_t)((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16);
        rsum[x >> 1] += r;
        gsum[x >> 1] += g;
        bsum[x >> 1] += b;
      }
    }
    uint8_t* uvrow = uv_out + (size_t)(yy / 2) * wp2 * 2;
    for (int cx = 0; cx < wp2; cx++) {
      // BOX mean with round-half-up, then JFIF chroma
      double r = (rsum[cx] + 2) >> 2, g = (gsum[cx] + 2) >> 2,
             b = (bsum[cx] + 2) >> 2;
      double cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0;
      double cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0;
      uvrow[cx * 2] = (uint8_t)std::clamp((int)std::lround(cb), 0, 255);
      uvrow[cx * 2 + 1] = (uint8_t)std::clamp((int)std::lround(cr), 0, 255);
    }
  }
  return 0;
}


// Fused edge-replicate pad + channel-0 extract for truly-grayscale inputs
// (1 B/px lossless transfer).  rgb: [h, w, 3]; out: [hp, wp].  Each valid
// row is copied in a loop without clamps (it vectorizes), its padding is
// one memset, and the padding rows copy the last valid row.
int rt_pack_gray(const uint8_t* rgb, int h, int w, int hp, int wp,
                 uint8_t* out) {
  const int vh = std::min(h, hp), vw = std::min(w, wp);
  for (int yy = 0; yy < vh; yy++) {
    const uint8_t* row = rgb + (size_t)yy * w * 3;
    uint8_t* orow = out + (size_t)yy * wp;
    for (int x = 0; x < vw; x++) orow[x] = row[(size_t)x * 3];
    std::memset(orow + vw, orow[vw - 1], wp - vw);
  }
  for (int yy = vh; yy < hp; yy++)
    std::memcpy(out + (size_t)yy * wp, out + (size_t)(vh - 1) * wp, wp);
  return 0;
}

// rt_pack_yuv420 + rt_is_gray fused into ONE read of the source image
// (the decode hot path previously scanned the image twice: a full-image
// grayness probe, then the pack).  Packs Y + UV unconditionally while
// OR-accumulating per-pixel channel differences; returns 1 if the image
// is truly grayscale — in which case y_out IS the lossless gray plane
// (for R==G==B, BT.601 luma (19595+38470+7471)v = 65536 v, so
// (65536 v + 0x8000) >> 16 == v bit-exactly) and uv_out can be discarded
// — else 0 (send y_out + uv_out as YUV 4:2:0).  -1 on odd hp/wp.
int rt_pack_auto(const uint8_t* rgb, int h, int w, int hp, int wp,
                 uint8_t* y_out, uint8_t* uv_out) {
  if (hp % 2 || wp % 2) return -1;
  int wp2 = wp / 2;
  std::vector<int32_t> rsum(wp2), gsum(wp2), bsum(wp2);
  uint8_t diff = 0;
  // valid rows, in 2-row blocks: probe each block's grayness with a pure
  // XOR sweep (no clamps — vectorizes; the data stays in cache for the
  // pack sweep that follows), then take the cheap channel-0 path for gray
  // blocks and the luma+chroma path only where color actually exists
  for (int yy = 0; yy < h; yy += 2) {
    int rows = std::min(2, h - yy);
    uint8_t bdiff = 0;
    for (int dy = 0; dy < rows; dy++) {
      const uint8_t* row = rgb + (size_t)(yy + dy) * w * 3;
      uint8_t d = 0;
      for (int x = 0; x < w; x++) {
        const uint8_t* p = row + (size_t)x * 3;
        d |= (uint8_t)((p[0] ^ p[1]) | (p[1] ^ p[2]));
      }
      bdiff |= d;
    }
    diff |= bdiff;
    uint8_t* uvrow = uv_out + (size_t)(yy / 2) * wp2 * 2;
    if (bdiff == 0) {
      // gray block: Y is bit-exactly channel 0 (BT.601 weights sum to
      // 65536) and chroma is exactly 128 — skip the luma math entirely
      for (int dy = 0; dy < rows; dy++) {
        const uint8_t* row = rgb + (size_t)(yy + dy) * w * 3;
        uint8_t* yrow = y_out + (size_t)(yy + dy) * wp;
        for (int x = 0; x < w; x++) yrow[x] = row[(size_t)x * 3];
        std::memset(yrow + w, yrow[w - 1], wp - w);
      }
      std::memset(uvrow, 128, (size_t)wp2 * 2);
    } else {
      std::fill(rsum.begin(), rsum.end(), 0);
      std::fill(gsum.begin(), gsum.end(), 0);
      std::fill(bsum.begin(), bsum.end(), 0);
      for (int dy = 0; dy < 2; dy++) {
        int sy = std::min(yy + dy, h - 1);
        const uint8_t* row = rgb + (size_t)sy * w * 3;
        uint8_t* yrow = y_out + (size_t)(yy + dy) * wp;
        for (int x = 0; x < w; x++) {
          const uint8_t* p = row + (size_t)x * 3;
          int r = p[0], g = p[1], b = p[2];
          yrow[x] =
              (uint8_t)((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16);
          rsum[x >> 1] += r;
          gsum[x >> 1] += g;
          bsum[x >> 1] += b;
        }
        // right edge replicates the last valid pixel
        int r = row[(size_t)(w - 1) * 3], g = row[(size_t)(w - 1) * 3 + 1],
            b = row[(size_t)(w - 1) * 3 + 2];
        std::memset(yrow + w, yrow[w - 1], wp - w);
        for (int x = w; x < wp; x++) {
          rsum[x >> 1] += r;
          gsum[x >> 1] += g;
          bsum[x >> 1] += b;
        }
      }
      for (int cx = 0; cx < wp2; cx++) {
        double r = (rsum[cx] + 2) >> 2, g = (gsum[cx] + 2) >> 2,
               b = (bsum[cx] + 2) >> 2;
        double cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0;
        double cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0;
        uvrow[cx * 2] = (uint8_t)std::clamp((int)std::lround(cb), 0, 255);
        uvrow[cx * 2 + 1] = (uint8_t)std::clamp((int)std::lround(cr), 0, 255);
      }
    }
  }
  // rows beyond the valid extent replicate row h-1: copy the already-
  // computed output rows instead of recomputing them (row h may already
  // hold the color-branch's clamped write — identical bytes either way)
  for (int yy = h; yy < hp; yy++)
    std::memcpy(y_out + (size_t)yy * wp, y_out + (size_t)(h - 1) * wp, wp);
  // padded chroma blocks are (row h-1, row h-1).  For odd h the last
  // valid block already clamped to exactly that pair; for even h compute
  // the replicated-row chroma once, then copy it down
  int cy0 = (h + 1) / 2;
  if (cy0 < hp / 2 && h % 2 == 0) {
    const uint8_t* row = rgb + (size_t)(h - 1) * w * 3;
    uint8_t* uvrow = uv_out + (size_t)cy0 * wp2 * 2;
    uint8_t d = 0;
    for (int x = 0; x < w; x++) {
      const uint8_t* p = row + (size_t)x * 3;
      d |= (uint8_t)((p[0] ^ p[1]) | (p[1] ^ p[2]));
    }
    if (d == 0) {
      std::memset(uvrow, 128, (size_t)wp2 * 2);
    } else {
      for (int cx = 0; cx < wp2; cx++) {
        int x0 = std::min(cx * 2, w - 1), x1 = std::min(cx * 2 + 1, w - 1);
        const uint8_t *p0 = row + (size_t)x0 * 3, *p1 = row + (size_t)x1 * 3;
        double r = ((p0[0] + p1[0]) * 2 + 2) >> 2,
               g = ((p0[1] + p1[1]) * 2 + 2) >> 2,
               b = ((p0[2] + p1[2]) * 2 + 2) >> 2;
        double cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0;
        double cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0;
        uvrow[cx * 2] = (uint8_t)std::clamp((int)std::lround(cb), 0, 255);
        uvrow[cx * 2 + 1] = (uint8_t)std::clamp((int)std::lround(cr), 0, 255);
      }
    }
    cy0++;
  }
  for (int cy = cy0; cy < hp / 2; cy++)
    std::memcpy(uv_out + (size_t)cy * wp2 * 2,
                uv_out + (size_t)(cy0 - 1) * wp2 * 2, (size_t)wp2 * 2);
  return diff == 0 ? 1 : 0;
}

// The transfer-format probe of a whole call: out[k] = rt_is_gray(rgbs[k],
// n_px[k]), the answer rt_pack_auto's return code gives, for n pages on up
// to `threads` threads, in one call (DevicePipeline._prepare).
int rt_gray_batch(const uint8_t* const* rgbs, const int64_t* n_px, int n,
                  int threads, int32_t* out) {
  parallel_for(n, threads, [&](int k) { out[k] = rt_is_gray(rgbs[k], n_px[k]); });
  return 0;
}

// A det chunk's stacked upload planes in one call, page k into row k, on up
// to `threads` threads (DevicePipeline._upload_and_det).  rgbs[k]: [hs[k],
// ws[k], 3], all within [hp, wp]; y_out: [nb, hp, wp]; uv_out: [nb, hp/2,
// wp/2, 2] when yuv, else unused.  A gray chunk writes rt_pack_gray's
// plane, which for R == G == B is rt_pack_auto's Y byte for byte; a colour
// chunk writes rt_pack_auto's Y and UV.  Rows n..nb-1 are zero.  -1 on odd
// hp/wp.
int rt_pack_chunk(const uint8_t* const* rgbs, const int32_t* hs,
                  const int32_t* ws, int n, int nb, int hp, int wp, int yuv,
                  int threads, uint8_t* y_out, uint8_t* uv_out) {
  if (hp % 2 || wp % 2) return -1;
  const size_t ysz = (size_t)hp * wp, uvsz = yuv ? ysz / 2 : 0;
  parallel_for(n, threads, [&](int k) {
    if (yuv)
      rt_pack_auto(rgbs[k], hs[k], ws[k], hp, wp, y_out + k * ysz,
                   uv_out + k * uvsz);
    else
      rt_pack_gray(rgbs[k], hs[k], ws[k], hp, wp, y_out + k * ysz);
  });
  std::memset(y_out + n * ysz, 0, (nb - n) * ysz);
  if (yuv) std::memset(uv_out + n * uvsz, 0, (nb - n) * uvsz);
  return 0;
}

}  // extern "C"
