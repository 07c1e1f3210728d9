// First-party host geometry library for db_text_minimal_tpu.
//
// TPU-native replacement for the third-party C++ geometry stack the reference
// leans on (SURVEY.md §2b):
//   - Clipper via pyclipper: polygon offsetting with round joins
//     (reference: src/data_loaders.py:119-122 shrink, src/db_transforms.py:19-21
//      dilate, src/postprocess.py:150-156 unclip)
//   - GEOS via shapely: area/length, intersection/union area, validity
//     (reference: src/iou.py:14-26, src/deteval.py:25-36, src/data_loaders.py:86)
//   - OpenCV: findContours (Suzuki-Abe + CHAIN_APPROX_SIMPLE), approxPolyDP
//     (Douglas-Peucker), minAreaRect (rotating calipers), fillPoly (scanline),
//     perspective warp (reference: src/postprocess.py:67-198, src/test_ocr.py:174-175)
//   - the per-edge distance field of draw_thresh_map
//     (reference: src/db_transforms.py:41-82) — the CPU hot spot of label
//     generation (SURVEY.md §3.1).
//
// Flat C ABI, bound from Python via ctypes (no pybind11 in the image).
// Polygons are passed as flat double arrays [x0,y0,x1,y1,...].

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

inline double cross(const Pt &o, const Pt &a, const Pt &b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

double signed_area(const std::vector<Pt> &p) {
  double a = 0.0;
  const size_t n = p.size();
  for (size_t i = 0; i < n; ++i) {
    const Pt &u = p[i];
    const Pt &v = p[(i + 1) % n];
    a += u.x * v.y - v.x * u.y;
  }
  return 0.5 * a;
}

double perimeter(const std::vector<Pt> &p) {
  double l = 0.0;
  const size_t n = p.size();
  for (size_t i = 0; i < n; ++i) {
    const Pt &u = p[i];
    const Pt &v = p[(i + 1) % n];
    l += std::hypot(v.x - u.x, v.y - u.y);
  }
  return l;
}

std::vector<Pt> to_pts(const double *xy, int n) {
  std::vector<Pt> p(n);
  for (int i = 0; i < n; ++i) p[i] = {xy[2 * i], xy[2 * i + 1]};
  return p;
}

// ---------------------------------------------------------------------------
// Segment intersection
// ---------------------------------------------------------------------------

// Proper + improper intersection of segments ab and cd. Returns number of
// intersection points written to out (0, 1; collinear overlap reports 1 at
// the midpoint of the overlap which suffices for is_simple checks).
int seg_intersect(Pt a, Pt b, Pt c, Pt d, Pt *out) {
  const double d1 = cross(c, d, a);
  const double d2 = cross(c, d, b);
  const double d3 = cross(a, b, c);
  const double d4 = cross(a, b, d);
  if (((d1 > 0 && d2 < 0) || (d1 < 0 && d2 > 0)) &&
      ((d3 > 0 && d4 < 0) || (d3 < 0 && d4 > 0))) {
    const double t = d1 / (d1 - d2);
    out[0] = {a.x + t * (b.x - a.x), a.y + t * (b.y - a.y)};
    return 1;
  }
  auto on_seg = [](Pt p, Pt q, Pt r) {
    return std::min(p.x, r.x) - 1e-12 <= q.x && q.x <= std::max(p.x, r.x) + 1e-12 &&
           std::min(p.y, r.y) - 1e-12 <= q.y && q.y <= std::max(p.y, r.y) + 1e-12;
  };
  if (d1 == 0 && on_seg(c, a, d)) { out[0] = a; return 1; }
  if (d2 == 0 && on_seg(c, b, d)) { out[0] = b; return 1; }
  if (d3 == 0 && on_seg(a, c, b)) { out[0] = c; return 1; }
  if (d4 == 0 && on_seg(a, d, b)) { out[0] = d; return 1; }
  return 0;
}

bool polygon_is_simple_impl(const std::vector<Pt> &p) {
  const int n = (int)p.size();
  if (n < 3) return false;
  Pt tmp;
  for (int i = 0; i < n; ++i) {
    for (int j = i + 1; j < n; ++j) {
      // skip adjacent edges (sharing a vertex)
      if (j == i || (j + 1) % n == i || (i + 1) % n == j) continue;
      if (seg_intersect(p[i], p[(i + 1) % n], p[j], p[(j + 1) % n], &tmp))
        return false;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// Convex hull + min-area rect (rotating calipers) — cv2.minAreaRect equiv.
// ---------------------------------------------------------------------------

std::vector<Pt> convex_hull_impl(std::vector<Pt> pts) {
  std::sort(pts.begin(), pts.end(), [](const Pt &a, const Pt &b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  pts.erase(std::unique(pts.begin(), pts.end(), [](const Pt &a, const Pt &b) {
              return a.x == b.x && a.y == b.y;
            }),
            pts.end());
  const int n = (int)pts.size();
  if (n < 3) return pts;
  std::vector<Pt> hull(2 * n);
  int k = 0;
  for (int i = 0; i < n; ++i) {
    while (k >= 2 && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
    hull[k++] = pts[i];
  }
  const int lower = k + 1;
  for (int i = n - 2; i >= 0; --i) {
    while (k >= lower && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
    hull[k++] = pts[i];
  }
  hull.resize(k - 1);
  return hull;  // counter-clockwise in a y-up frame
}

// Returns 4 rect corners + (w, h) of the minimum-area enclosing rectangle.
void min_area_rect_impl(const std::vector<Pt> &pts, Pt corners[4], double *w,
                        double *h) {
  std::vector<Pt> hull = convex_hull_impl(pts);
  const int n = (int)hull.size();
  if (n == 0) {
    for (int i = 0; i < 4; ++i) corners[i] = {0, 0};
    *w = *h = 0;
    return;
  }
  if (n == 1) {
    for (int i = 0; i < 4; ++i) corners[i] = hull[0];
    *w = *h = 0;
    return;
  }
  double best = 1e300;
  for (int i = 0; i < n; ++i) {
    const Pt &a = hull[i];
    const Pt &b = hull[(i + 1) % n];
    double ex = b.x - a.x, ey = b.y - a.y;
    const double len = std::hypot(ex, ey);
    if (len < 1e-12) continue;
    ex /= len;
    ey /= len;
    // project all hull points onto edge dir (u) and normal (v)
    double umin = 1e300, umax = -1e300, vmin = 1e300, vmax = -1e300;
    for (const Pt &p : hull) {
      const double u = (p.x - a.x) * ex + (p.y - a.y) * ey;
      const double v = -(p.x - a.x) * ey + (p.y - a.y) * ex;
      umin = std::min(umin, u); umax = std::max(umax, u);
      vmin = std::min(vmin, v); vmax = std::max(vmax, v);
    }
    const double area = (umax - umin) * (vmax - vmin);
    if (area < best) {
      best = area;
      *w = umax - umin;
      *h = vmax - vmin;
      // corners in edge frame: (umin,vmin) (umax,vmin) (umax,vmax) (umin,vmax)
      const double cs[4][2] = {{umin, vmin}, {umax, vmin}, {umax, vmax}, {umin, vmax}};
      for (int c = 0; c < 4; ++c) {
        corners[c] = {a.x + cs[c][0] * ex - cs[c][1] * ey,
                      a.y + cs[c][0] * ey + cs[c][1] * ex};
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Douglas-Peucker (cv2.approxPolyDP equivalent for closed curves)
// ---------------------------------------------------------------------------

double point_seg_dist(const Pt &p, const Pt &a, const Pt &b) {
  const double dx = b.x - a.x, dy = b.y - a.y;
  const double len2 = dx * dx + dy * dy;
  if (len2 < 1e-24) return std::hypot(p.x - a.x, p.y - a.y);
  double t = ((p.x - a.x) * dx + (p.y - a.y) * dy) / len2;
  t = std::max(0.0, std::min(1.0, t));
  return std::hypot(p.x - (a.x + t * dx), p.y - (a.y + t * dy));
}

void dp_recurse(const std::vector<Pt> &pts, int lo, int hi, double eps,
                std::vector<char> &keep) {
  if (hi <= lo + 1) return;
  double dmax = -1.0;
  int imax = lo;
  for (int i = lo + 1; i < hi; ++i) {
    const double d = point_seg_dist(pts[i], pts[lo], pts[hi]);
    if (d > dmax) { dmax = d; imax = i; }
  }
  if (dmax > eps) {
    keep[imax] = 1;
    dp_recurse(pts, lo, imax, eps, keep);
    dp_recurse(pts, imax, hi, eps, keep);
  }
}

std::vector<Pt> approx_poly_dp_closed(const std::vector<Pt> &pts, double eps) {
  const int n = (int)pts.size();
  if (n < 3) return pts;
  // split the closed curve at the two mutually farthest-ish anchor points
  // (index 0 and the point farthest from it), run DP on both open halves.
  int far_i = 0;
  double far_d = -1.0;
  for (int i = 1; i < n; ++i) {
    const double d = std::hypot(pts[i].x - pts[0].x, pts[i].y - pts[0].y);
    if (d > far_d) { far_d = d; far_i = i; }
  }
  std::vector<Pt> rolled(n + 1);
  for (int i = 0; i <= n; ++i) rolled[i] = pts[i % n];
  std::vector<char> keep(n + 1, 0);
  keep[0] = keep[far_i] = keep[n] = 1;
  dp_recurse(rolled, 0, far_i, eps, keep);
  dp_recurse(rolled, far_i, n, eps, keep);
  std::vector<Pt> out;
  for (int i = 0; i < n; ++i)
    if (keep[i]) out.push_back(rolled[i]);
  return out;
}

// ---------------------------------------------------------------------------
// Polygon intersection area via triangulation + convex clipping.
// Correct for simple polygons (the GEOS capability used by iou.py/deteval.py).
// ---------------------------------------------------------------------------

bool point_in_triangle(const Pt &p, const Pt &a, const Pt &b, const Pt &c) {
  const double d1 = cross(a, b, p);
  const double d2 = cross(b, c, p);
  const double d3 = cross(c, a, p);
  const bool has_neg = (d1 < -1e-12) || (d2 < -1e-12) || (d3 < -1e-12);
  const bool has_pos = (d1 > 1e-12) || (d2 > 1e-12) || (d3 > 1e-12);
  return !(has_neg && has_pos);
}

// Ear-clipping triangulation of a simple polygon (any orientation).
struct Tri { Pt a, b, c; };

std::vector<Tri> ear_clip(std::vector<Pt> poly) {
  std::vector<Tri> tris;
  if (poly.size() < 3) return tris;
  if (signed_area(poly) < 0) std::reverse(poly.begin(), poly.end());
  int guard = 0;
  const int max_guard = (int)poly.size() * (int)poly.size() * 4 + 64;
  while (poly.size() > 3 && guard++ < max_guard) {
    const int n = (int)poly.size();
    bool clipped = false;
    for (int i = 0; i < n; ++i) {
      const Pt &prev = poly[(i + n - 1) % n];
      const Pt &cur = poly[i];
      const Pt &next = poly[(i + 1) % n];
      if (cross(prev, cur, next) <= 1e-12) continue;  // reflex or degenerate
      bool ear = true;
      for (int j = 0; j < n; ++j) {
        if (j == i || j == (i + n - 1) % n || j == (i + 1) % n) continue;
        if (point_in_triangle(poly[j], prev, cur, next)) { ear = false; break; }
      }
      if (!ear) continue;
      tris.push_back({prev, cur, next});
      poly.erase(poly.begin() + i);
      clipped = true;
      break;
    }
    if (!clipped) {
      // degenerate input (collinear runs / slight self-touch): drop the most
      // degenerate vertex and retry.
      int worst = 0;
      double wval = 1e300;
      const int n2 = (int)poly.size();
      for (int i = 0; i < n2; ++i) {
        const double c = std::fabs(cross(poly[(i + n2 - 1) % n2], poly[i],
                                         poly[(i + 1) % n2]));
        if (c < wval) { wval = c; worst = i; }
      }
      poly.erase(poly.begin() + worst);
      if (poly.size() < 3) break;
    }
  }
  if (poly.size() == 3) tris.push_back({poly[0], poly[1], poly[2]});
  return tris;
}

// Sutherland-Hodgman clip of convex subject by convex clip (both CCW).
std::vector<Pt> clip_convex(const std::vector<Pt> &subject,
                            const std::vector<Pt> &clip) {
  std::vector<Pt> out = subject;
  const int m = (int)clip.size();
  for (int i = 0; i < m && !out.empty(); ++i) {
    const Pt &ca = clip[i];
    const Pt &cb = clip[(i + 1) % m];
    std::vector<Pt> input;
    input.swap(out);
    const int k = (int)input.size();
    for (int j = 0; j < k; ++j) {
      const Pt &p = input[j];
      const Pt &q = input[(j + 1) % k];
      const double dp_ = cross(ca, cb, p);
      const double dq = cross(ca, cb, q);
      if (dp_ >= -1e-12) {
        out.push_back(p);
        if (dq < -1e-12) {
          const double t = dp_ / (dp_ - dq);
          out.push_back({p.x + t * (q.x - p.x), p.y + t * (q.y - p.y)});
        }
      } else if (dq >= -1e-12) {
        const double t = dp_ / (dp_ - dq);
        out.push_back({p.x + t * (q.x - p.x), p.y + t * (q.y - p.y)});
      }
    }
  }
  return out;
}

double intersection_area_impl(const std::vector<Pt> &a,
                              const std::vector<Pt> &b) {
  if (a.size() < 3 || b.size() < 3) return 0.0;
  std::vector<Tri> ta = ear_clip(a);
  std::vector<Tri> tb = ear_clip(b);
  double total = 0.0;
  for (const Tri &x : ta) {
    std::vector<Pt> sx = {x.a, x.b, x.c};
    for (const Tri &y : tb) {
      std::vector<Pt> sy = {y.a, y.b, y.c};
      std::vector<Pt> inter = clip_convex(sx, sy);
      if (inter.size() >= 3) total += std::fabs(signed_area(inter));
    }
  }
  return total;
}

// ---------------------------------------------------------------------------
// Polygon offsetting (Clipper / pyclipper JT_ROUND + ET_CLOSEDPOLYGON equiv.)
// ---------------------------------------------------------------------------
//
// Build the raw offset outline with round joins (arc tolerance 0.25 like
// Clipper1's default), then resolve self-intersections by loop splitting and
// keep loops whose orientation matches the expected output orientation.
// For shrink offsets that collapse the polygon, no loop survives and the
// result is empty — matching pyclipper Execute() returning [].

void resolve_loops(std::vector<Pt> path, std::vector<std::vector<Pt>> &out,
                   int depth) {
  const int n = (int)path.size();
  if (n < 3 || depth > 64) {
    if (n >= 3) out.push_back(std::move(path));
    return;
  }
  for (int i = 0; i < n; ++i) {
    for (int j = i + 1; j < n; ++j) {
      if (j == i || (j + 1) % n == i || (i + 1) % n == j) continue;
      Pt x;
      if (seg_intersect(path[i], path[(i + 1) % n], path[j], path[(j + 1) % n],
                        &x)) {
        // split into loop [x, i+1..j, x] and remainder [x, j+1..i, x]
        std::vector<Pt> loop, rest;
        loop.push_back(x);
        for (int k = i + 1; k <= j; ++k) loop.push_back(path[k]);
        rest.push_back(x);
        for (int k = (j + 1) % n; k != (i + 1) % n; k = (k + 1) % n)
          rest.push_back(path[k]);
        resolve_loops(std::move(loop), out, depth + 1);
        resolve_loops(std::move(rest), out, depth + 1);
        return;
      }
    }
  }
  out.push_back(std::move(path));
}

std::vector<std::vector<Pt>> offset_polygon_impl(std::vector<Pt> poly,
                                                 double delta,
                                                 double arc_tol) {
  std::vector<std::vector<Pt>> result;
  if (poly.size() < 3) return result;
  // normalize to CCW (positive area); Clipper's positive delta always expands
  const double area0 = signed_area(poly);
  if (area0 == 0.0) return result;
  if (area0 < 0) std::reverse(poly.begin(), poly.end());
  if (std::fabs(delta) < 1e-9) { result.push_back(poly); return result; }

  const int n = (int)poly.size();
  // per-vertex outward normals of adjacent edges (CCW polygon in a y-down
  // image frame has outward normal = right-hand normal of edge direction;
  // we work frame-agnostically: "outward" = the side consistent with
  // expansion for delta>0, determined by orientation).
  std::vector<Pt> norm(n);  // edge i: poly[i] -> poly[i+1]
  for (int i = 0; i < n; ++i) {
    const Pt &a = poly[i];
    const Pt &b = poly[(i + 1) % n];
    double dx = b.x - a.x, dy = b.y - a.y;
    const double len = std::hypot(dx, dy);
    if (len < 1e-12) { norm[i] = {0, 0}; continue; }
    // For a CCW polygon (positive signed area), the outward normal of edge
    // (dx,dy) is (dy,-dx)/len in a y-up frame.
    norm[i] = {dy / len, -dx / len};
  }

  // round-join step count (Clipper1: steps = pi / acos(1 - arc_tol/|delta|))
  double at = std::max(arc_tol, 1e-3);
  if (at > std::fabs(delta)) at = std::fabs(delta);
  const double steps_per_pi =
      M_PI / std::acos(std::max(-1.0, std::min(1.0, 1.0 - at / std::fabs(delta))));

  std::vector<Pt> raw;
  raw.reserve(n * 4);
  for (int i = 0; i < n; ++i) {
    const Pt &p = poly[i];
    const Pt &n_prev = norm[(i + n - 1) % n];
    const Pt &n_next = norm[i];
    if (n_prev.x == 0 && n_prev.y == 0 && n_next.x == 0 && n_next.y == 0)
      continue;
    // Turn of the normal from n_prev to n_next: sin_a > 0 is a CCW turn
    // (convex vertex of a CCW polygon). A round join arc is required when
    // the offset side is on the convex side: dilation at convex vertices,
    // shrink at reflex vertices — i.e. when sin_a * delta > 0.
    const double sin_a = n_prev.x * n_next.y - n_prev.y * n_next.x;
    if (sin_a * delta > 1e-12) {
      // round join: arc from n_prev to n_next around p at radius |delta|
      double a1 = std::atan2(n_prev.y, n_prev.x);
      double a2 = std::atan2(n_next.y, n_next.x);
      if (delta > 0) {
        if (a2 < a1) a2 += 2 * M_PI;   // CCW sweep (convex, dilate)
      } else {
        if (a2 > a1) a2 -= 2 * M_PI;   // CW sweep (reflex, shrink)
      }
      const double sweep = a2 - a1;
      int steps = (int)std::ceil(std::fabs(sweep) / M_PI * steps_per_pi);
      steps = std::max(steps, 1);
      for (int s = 0; s <= steps; ++s) {
        const double a = a1 + sweep * s / steps;
        raw.push_back({p.x + std::cos(a) * delta, p.y + std::sin(a) * delta});
      }
    } else {
      // offset edges cross behind the vertex; emit both endpoints,
      // loop-splitting cleans the overlap.
      raw.push_back({p.x + n_prev.x * delta, p.y + n_prev.y * delta});
      raw.push_back({p.x + n_next.x * delta, p.y + n_next.y * delta});
    }
  }
  if (raw.size() < 3) return result;

  std::vector<std::vector<Pt>> loops;
  resolve_loops(std::move(raw), loops, 0);

  // Keep loops oriented like the expanded/shrunk boundary (CCW, positive
  // area) with non-trivial area; collapsed regions come out inverted.
  const double min_area = 1e-3;
  for (auto &loop : loops) {
    if (loop.size() < 3) continue;
    const double a = signed_area(loop);
    if (a > min_area) result.push_back(std::move(loop));
  }
  // For shrink, also require the loop to lie inside the source polygon —
  // guards against artifacts from loop splitting.
  if (delta < 0 && result.size() > 1) {
    std::sort(result.begin(), result.end(),
              [](const std::vector<Pt> &x, const std::vector<Pt> &y) {
                return signed_area(x) > signed_area(y);
              });
  }
  return result;
}

// ---------------------------------------------------------------------------
// Contour tracing: Suzuki-Abe border following with CHAIN_APPROX_SIMPLE
// (cv2.findContours(..., RETR_LIST, CHAIN_APPROX_SIMPLE) equivalent,
//  reference src/postprocess.py:67-68,116-117)
// ---------------------------------------------------------------------------

// 8-connectivity neighborhood in CLOCKWISE order for image coordinates
// (y grows downward): E, SE, S, SW, W, NW, N, NE.
const int NB8[8][2] = {{1, 0},  {1, 1},   {0, 1},  {-1, 1},
                       {-1, 0}, {-1, -1}, {0, -1}, {1, -1}};

struct IPt { int x, y; };

// Suzuki-Abe border following (Appendix I of Suzuki & Abe 1985), tracing one
// border starting at (sx, sy) with initial examined pixel (ex, ey).
// Marks pixels in `img` with ±nbd. Returns the border point sequence.
std::vector<IPt> trace_border(std::vector<int32_t> &img, int h, int w, int sx,
                              int sy, int ex, int ey, int32_t nbd) {
  auto val = [&](int x, int y) -> int32_t {
    if (x < 0 || x >= w || y < 0 || y >= h) return 0;
    return img[y * w + x];
  };
  auto set = [&](int x, int y, int32_t v) { img[y * w + x] = v; };
  auto dir_of = [&](int cx, int cy, int nx, int ny) {
    for (int i = 0; i < 8; ++i)
      if (cx + NB8[i][0] == nx && cy + NB8[i][1] == ny) return i;
    return 0;
  };

  std::vector<IPt> contour;
  // Step 3.1: clockwise search from (ex, ey) around (sx, sy)
  int d0 = dir_of(sx, sy, ex, ey);
  int i1 = -1;
  for (int k = 0; k < 8; ++k) {
    const int d = (d0 + k) % 8;  // clockwise
    if (val(sx + NB8[d][0], sy + NB8[d][1]) != 0) { i1 = d; break; }
  }
  if (i1 < 0) {  // isolated pixel
    set(sx, sy, -nbd);
    contour.push_back({sx, sy});
    return contour;
  }
  const int x1 = sx + NB8[i1][0], y1 = sy + NB8[i1][1];
  // Step 3.2
  int x2 = x1, y2 = y1;    // previously found border pixel
  int x3 = sx, y3 = sy;    // current border pixel
  const size_t max_iter = (size_t)4 * h * w + 16;
  size_t iter = 0;
  while (iter++ < max_iter) {
    // Step 3.3: counter-clockwise search around (x3, y3) starting from the
    // position NEXT (counter-clockwise) to (x2, y2).
    const int dprev = dir_of(x3, y3, x2, y2);
    int i4 = -1;
    bool examined_east_zero = false;
    for (int k = 1; k <= 8; ++k) {
      const int d = (dprev + 8 - k) % 8;  // counter-clockwise
      const int nx = x3 + NB8[d][0], ny = y3 + NB8[d][1];
      if (val(nx, ny) != 0) { i4 = d; break; }
      if (d == 0) examined_east_zero = true;  // east neighbor examined, zero
    }
    // Step 3.4: mark current pixel
    if (examined_east_zero) {
      set(x3, y3, -nbd);
    } else if (val(x3, y3) == 1) {
      set(x3, y3, nbd);
    }
    contour.push_back({x3, y3});
    if (i4 < 0) break;  // defensive; cannot happen (x2 is nonzero)
    const int x4 = x3 + NB8[i4][0], y4 = y3 + NB8[i4][1];
    // Step 3.5: termination — back at start and next is the first pixel
    if (x4 == sx && y4 == sy && x3 == x1 && y3 == y1) break;
    x2 = x3; y2 = y3;
    x3 = x4; y3 = y4;
  }
  return contour;
}

// CHAIN_APPROX_SIMPLE: drop interior points of straight (8-dir) runs.
std::vector<IPt> compress_chain(const std::vector<IPt> &c) {
  const int n = (int)c.size();
  if (n <= 2) return c;
  std::vector<IPt> out;
  for (int i = 0; i < n; ++i) {
    const IPt &prev = c[(i + n - 1) % n];
    const IPt &cur = c[i];
    const IPt &next = c[(i + 1) % n];
    const int d1x = cur.x - prev.x, d1y = cur.y - prev.y;
    const int d2x = next.x - cur.x, d2y = next.y - cur.y;
    if (d1x == d2x && d1y == d2y) continue;  // same direction → interior
    out.push_back(cur);
  }
  if (out.empty()) out.push_back(c[0]);
  return out;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

double geo_polygon_area(const double *xy, int n) {
  return std::fabs(signed_area(to_pts(xy, n)));
}

double geo_polygon_signed_area(const double *xy, int n) {
  return signed_area(to_pts(xy, n));
}

double geo_polygon_perimeter(const double *xy, int n) {
  return perimeter(to_pts(xy, n));
}

int geo_polygon_is_simple(const double *xy, int n) {
  return polygon_is_simple_impl(to_pts(xy, n)) ? 1 : 0;
}

double geo_intersection_area(const double *axy, int na, const double *bxy,
                             int nb) {
  return intersection_area_impl(to_pts(axy, na), to_pts(bxy, nb));
}

int geo_convex_hull(const double *xy, int n, double *out_xy, int max_out) {
  std::vector<Pt> hull = convex_hull_impl(to_pts(xy, n));
  const int m = std::min((int)hull.size(), max_out);
  for (int i = 0; i < m; ++i) {
    out_xy[2 * i] = hull[i].x;
    out_xy[2 * i + 1] = hull[i].y;
  }
  return m;
}

// out8: 4 corner points; out2: (w, h)
void geo_min_area_rect(const double *xy, int n, double *out8, double *out2) {
  Pt corners[4];
  double w, h;
  min_area_rect_impl(to_pts(xy, n), corners, &w, &h);
  for (int i = 0; i < 4; ++i) {
    out8[2 * i] = corners[i].x;
    out8[2 * i + 1] = corners[i].y;
  }
  out2[0] = w;
  out2[1] = h;
}

int geo_approx_poly_dp(const double *xy, int n, double eps, double *out_xy,
                       int max_out) {
  std::vector<Pt> out = approx_poly_dp_closed(to_pts(xy, n), eps);
  const int m = std::min((int)out.size(), max_out);
  for (int i = 0; i < m; ++i) {
    out_xy[2 * i] = out[i].x;
    out_xy[2 * i + 1] = out[i].y;
  }
  return m;
}

// Offset a closed polygon by delta (>0 dilate, <0 shrink) with round joins.
// Returns the number of output polygons; sizes in out_sizes, concatenated
// points in out_xy.
int geo_offset_polygon(const double *xy, int n, double delta, double arc_tol,
                       double *out_xy, int *out_sizes, int max_pts,
                       int max_polys) {
  std::vector<std::vector<Pt>> polys =
      offset_polygon_impl(to_pts(xy, n), delta, arc_tol);
  int np = 0, used = 0;
  for (const auto &p : polys) {
    if (np >= max_polys) break;
    if (used + (int)p.size() > max_pts) break;
    for (const Pt &q : p) {
      out_xy[2 * used] = q.x;
      out_xy[2 * used + 1] = q.y;
      ++used;
    }
    out_sizes[np++] = (int)p.size();
  }
  return np;
}

// Binary image contour extraction (Suzuki-Abe, all borders, SIMPLE chain
// compression). img: uint8 HxW (nonzero = foreground). Returns contour count;
// point counts in out_sizes, concatenated (x, y) int points in out_pts.
int geo_find_contours(const uint8_t *img, int h, int w, int *out_pts,
                      int *out_sizes, int max_pts, int max_contours) {
  std::vector<int32_t> lab((size_t)h * w);
  for (int i = 0; i < h * w; ++i) lab[i] = img[i] ? 1 : 0;
  auto at = [&](int x, int y) -> int32_t & { return lab[y * w + x]; };

  int ncont = 0, used = 0;
  int32_t nbd = 1;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const int32_t v = at(x, y);
      if (v == 0) continue;
      bool outer = false, hole = false;
      if (v == 1 && (x == 0 || at(x - 1, y) == 0)) outer = true;
      else if (v >= 1 && (x == w - 1 || at(x + 1, y) == 0)) hole = true;
      if (!outer && !hole) continue;
      ++nbd;
      // initial examined pixel: west for outer borders, east for holes
      const int ex = outer ? x - 1 : x + 1;
      std::vector<IPt> contour =
          trace_border(lab, h, w, x, y, ex, y, nbd);
      std::vector<IPt> simple = compress_chain(contour);
      if (ncont < max_contours && used + (int)simple.size() <= max_pts) {
        for (const IPt &p : simple) {
          out_pts[2 * used] = p.x;
          out_pts[2 * used + 1] = p.y;
          ++used;
        }
        out_sizes[ncont++] = (int)simple.size();
      }
    }
  }
  return ncont;
}

// Scanline polygon fill on a float32 image: set pixels inside (even-odd,
// boundary-inclusive like cv2.fillPoly) to value.
void geo_fill_poly(float *img, int h, int w, const double *xy, int n,
                   float value) {
  if (n < 3) return;
  std::vector<Pt> p = to_pts(xy, n);
  double ymin = 1e300, ymax = -1e300;
  for (const Pt &q : p) { ymin = std::min(ymin, q.y); ymax = std::max(ymax, q.y); }
  const int y0 = std::max(0, (int)std::floor(ymin));
  const int y1 = std::min(h - 1, (int)std::ceil(ymax));
  std::vector<double> xs;
  for (int y = y0; y <= y1; ++y) {
    xs.clear();
    const double fy = (double)y;
    for (int i = 0; i < n; ++i) {
      const Pt &a = p[i];
      const Pt &b = p[(i + 1) % n];
      if ((a.y <= fy && b.y > fy) || (b.y <= fy && a.y > fy)) {
        const double t = (fy - a.y) / (b.y - a.y);
        xs.push_back(a.x + t * (b.x - a.x));
      }
    }
    std::sort(xs.begin(), xs.end());
    for (size_t i = 0; i + 1 < xs.size(); i += 2) {
      int xa = (int)std::ceil(xs[i] - 0.5);
      int xb = (int)std::floor(xs[i + 1] + 0.5);
      xa = std::max(xa, 0);
      xb = std::min(xb, w - 1);
      for (int x = xa; x <= xb; ++x) img[y * w + x] = value;
    }
  }
  // boundary-inclusive: rasterize edges (Bresenham on rounded coords)
  for (int i = 0; i < n; ++i) {
    int x0i = (int)std::lround(p[i].x), y0i = (int)std::lround(p[i].y);
    int x1i = (int)std::lround(p[(i + 1) % n].x),
        y1i = (int)std::lround(p[(i + 1) % n].y);
    int dx = std::abs(x1i - x0i), dy = -std::abs(y1i - y0i);
    int sx = x0i < x1i ? 1 : -1, sy = y0i < y1i ? 1 : -1;
    int err = dx + dy;
    while (true) {
      if (x0i >= 0 && x0i < w && y0i >= 0 && y0i < h)
        img[y0i * w + x0i] = value;
      if (x0i == x1i && y0i == y1i) break;
      const int e2 = 2 * err;
      if (e2 >= dy) { err += dy; x0i += sx; }
      if (e2 <= dx) { err += dx; y0i += sy; }
    }
  }
}

// The per-pixel distance field of draw_thresh_map
// (reference src/db_transforms.py:41-82): for every pixel of an
// (height x width) window, distance to polygon edge (i -> i+1) using the
// reference's law-of-cosines formula, normalized by `norm` and clipped to
// [0, 1]; the output is min over edges.
void geo_border_distance_field(const double *xy, int n, int height, int width,
                               double norm, float *out) {
  std::vector<Pt> p = to_pts(xy, n);
  for (int y = 0; y < height; ++y) {
    for (int x = 0; x < width; ++x) out[y * width + x] = 1.0f;
  }
  for (int i = 0; i < n; ++i) {
    const Pt &a = p[i];
    const Pt &b = p[(i + 1) % n];
    const double sq_ab =
        (a.x - b.x) * (a.x - b.x) + (a.y - b.y) * (a.y - b.y);
    for (int y = 0; y < height; ++y) {
      for (int x = 0; x < width; ++x) {
        const double sq1 =
            (x - a.x) * (x - a.x) + (y - a.y) * (y - a.y);
        const double sq2 =
            (x - b.x) * (x - b.x) + (y - b.y) * (y - b.y);
        double result;
        const double denom = 2.0 * std::sqrt(sq1 * sq2);
        double cosin = denom > 0 ? (sq_ab - sq1 - sq2) / denom : -1.0;
        if (cosin < 0) {
          result = std::sqrt(std::min(sq1, sq2));
        } else {
          double sq_sin = 1 - cosin * cosin;
          if (std::isnan(sq_sin) || sq_sin < 0) sq_sin = 0;
          result = sq_ab > 0 ? std::sqrt(sq1 * sq2 * sq_sin / sq_ab)
                             : std::sqrt(std::min(sq1, sq2));
        }
        double d = norm > 0 ? result / norm : 1.0;
        d = std::max(0.0, std::min(1.0, d));
        float &o = out[y * width + x];
        if ((float)d < o) o = (float)d;
      }
    }
  }
}

// Solve the 3x3 homography mapping src[i] -> dst[i] (4 point pairs);
// cv2.getPerspectiveTransform equivalent. out9 row-major.
int geo_perspective_transform(const double *src8, const double *dst8,
                              double *out9) {
  // Build 8x8 linear system A h = b with h = (h0..h7), h8 = 1
  double A[8][9];
  for (int i = 0; i < 4; ++i) {
    const double x = src8[2 * i], y = src8[2 * i + 1];
    const double u = dst8[2 * i], v = dst8[2 * i + 1];
    double r0[9] = {x, y, 1, 0, 0, 0, -u * x, -u * y, u};
    double r1[9] = {0, 0, 0, x, y, 1, -v * x, -v * y, v};
    std::memcpy(A[2 * i], r0, sizeof(r0));
    std::memcpy(A[2 * i + 1], r1, sizeof(r1));
  }
  // Gaussian elimination with partial pivoting
  for (int col = 0; col < 8; ++col) {
    int piv = col;
    for (int r = col + 1; r < 8; ++r)
      if (std::fabs(A[r][col]) > std::fabs(A[piv][col])) piv = r;
    if (std::fabs(A[piv][col]) < 1e-12) return 0;
    if (piv != col)
      for (int c = 0; c < 9; ++c) std::swap(A[piv][c], A[col][c]);
    for (int r = 0; r < 8; ++r) {
      if (r == col) continue;
      const double f = A[r][col] / A[col][col];
      for (int c = col; c < 9; ++c) A[r][c] -= f * A[col][c];
    }
  }
  for (int i = 0; i < 8; ++i) out9[i] = A[i][8] / A[i][i];
  out9[8] = 1.0;
  return 1;
}

// Bilinear perspective warp: src HxWx3 uint8 -> dst oh x ow x 3 uint8 using
// homography M (dst->src is computed internally from the forward M).
void geo_warp_perspective(const uint8_t *src, int h, int w, int channels,
                          const double *m9, uint8_t *dst, int oh, int ow) {
  // invert the 3x3 homography
  const double *m = m9;
  const double det =
      m[0] * (m[4] * m[8] - m[5] * m[7]) - m[1] * (m[3] * m[8] - m[5] * m[6]) +
      m[2] * (m[3] * m[7] - m[4] * m[6]);
  if (std::fabs(det) < 1e-15) return;
  double inv[9] = {
      (m[4] * m[8] - m[5] * m[7]) / det, (m[2] * m[7] - m[1] * m[8]) / det,
      (m[1] * m[5] - m[2] * m[4]) / det, (m[5] * m[6] - m[3] * m[8]) / det,
      (m[0] * m[8] - m[2] * m[6]) / det, (m[2] * m[3] - m[0] * m[5]) / det,
      (m[3] * m[7] - m[4] * m[6]) / det, (m[1] * m[6] - m[0] * m[7]) / det,
      (m[0] * m[4] - m[1] * m[3]) / det};
  for (int y = 0; y < oh; ++y) {
    for (int x = 0; x < ow; ++x) {
      const double denom = inv[6] * x + inv[7] * y + inv[8];
      if (std::fabs(denom) < 1e-12) continue;
      const double sx = (inv[0] * x + inv[1] * y + inv[2]) / denom;
      const double sy = (inv[3] * x + inv[4] * y + inv[5]) / denom;
      const int x0 = (int)std::floor(sx), y0 = (int)std::floor(sy);
      const double fx = sx - x0, fy = sy - y0;
      for (int c = 0; c < channels; ++c) {
        double acc = 0.0;
        for (int dy = 0; dy <= 1; ++dy) {
          for (int dx = 0; dx <= 1; ++dx) {
            const int xx = x0 + dx, yy = y0 + dy;
            double v = 0.0;
            if (xx >= 0 && xx < w && yy >= 0 && yy < h)
              v = src[(yy * w + xx) * channels + c];
            const double wgt = (dx ? fx : 1 - fx) * (dy ? fy : 1 - fy);
            acc += v * wgt;
          }
        }
        dst[(y * ow + x) * channels + c] =
            (uint8_t)std::max(0.0, std::min(255.0, std::lround(acc) * 1.0));
      }
    }
  }
}

}  // extern "C"
