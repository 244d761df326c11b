// Rotated-polygon IoU for the DOTA-devkit-compatible evaluator.
//
// TPU-native rebuild of the reference's only native component: the external
// DOTA_devkit `polyiou` C++/SWIG extension (reference README.md:23-30, used at
// metrics/dota_eval.py:37-47). Exposed as a plain C ABI for ctypes instead of
// SWIG. Convex polygon intersection via Sutherland-Hodgman clipping.
//
// Build: g++ -O2 -shared -fPIC -o libpolyiou.so polyiou.cpp

#include <cmath>
#include <cstddef>

namespace {

struct Pt {
  double x, y;
};

inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

double polygon_area(const Pt* pts, int n) {
  double area = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& p = pts[i];
    const Pt& q = pts[(i + 1) % n];
    area += p.x * q.y - q.x * p.y;
  }
  return 0.5 * std::fabs(area);
}

double polygon_signed_area(const Pt* pts, int n) {
  double area = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& p = pts[i];
    const Pt& q = pts[(i + 1) % n];
    area += p.x * q.y - q.x * p.y;
  }
  return 0.5 * area;
}

// Clip polygon `in` (n vertices) against the half-plane on the inner side of
// edge (e0, e1) of a polygon with orientation `orient`. Returns new count.
int clip_halfplane(const Pt* in, int n, Pt e0, Pt e1, double orient, Pt* out) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    Pt cur = in[i];
    Pt prev = in[(i + n - 1) % n];
    double c_cur = cross(e0, e1, cur) * orient;
    double c_prev = cross(e0, e1, prev) * orient;
    bool in_cur = c_cur >= -1e-12;
    bool in_prev = c_prev >= -1e-12;
    if (in_cur != in_prev) {
      double denom = c_prev - c_cur;  // same sign basis, no extra orient
      if (std::fabs(denom) > 1e-300) {
        double t = c_prev / denom;
        Pt inter{prev.x + t * (cur.x - prev.x), prev.y + t * (cur.y - prev.y)};
        out[m++] = inter;
      }
    }
    if (in_cur) out[m++] = cur;
  }
  return m;
}

// Intersection area of two convex polygons (np, nq vertices, any winding).
double convex_intersection_area(const Pt* p, int np, const Pt* q, int nq) {
  // buffer: each clip adds at most 1 vertex
  Pt buf_a[64], buf_b[64];
  Pt* cur = buf_a;
  Pt* nxt = buf_b;
  int n = np;
  for (int i = 0; i < np; ++i) cur[i] = p[i];

  double orient = polygon_signed_area(q, nq) >= 0 ? 1.0 : -1.0;
  for (int e = 0; e < nq && n > 0; ++e) {
    int m = clip_halfplane(cur, n, q[e], q[(e + 1) % nq], orient, nxt);
    Pt* tmp = cur;
    cur = nxt;
    nxt = tmp;
    n = m;
  }
  if (n < 3) return 0.0;
  return polygon_area(cur, n);
}

// p, q: 8 doubles each (x1 y1 x2 y2 x3 y3 x4 y4)
double quad_iou(const double* p, const double* q) {
  Pt pp[4], qq[4];
  for (int i = 0; i < 4; ++i) {
    pp[i] = Pt{p[2 * i], p[2 * i + 1]};
    qq[i] = Pt{q[2 * i], q[2 * i + 1]};
  }
  double inter = convex_intersection_area(pp, 4, qq, 4);
  double uni = polygon_area(pp, 4) + polygon_area(qq, 4) - inter;
  if (uni <= 0.0) return 0.0;
  return inter / uni;
}

}  // namespace

extern "C" {

// One det polygon (8 doubles) vs n gt polygons (n x 8), writes n IoUs.
void poly_iou_batch(const double* det, const double* gts, int n, double* out) {
  for (int i = 0; i < n; ++i) {
    out[i] = quad_iou(det, gts + 8 * i);
  }
}

// Full pairwise: n dets x m gts, row-major (n, m).
void poly_iou_matrix(const double* dets, int n, const double* gts, int m,
                     double* out) {
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < m; ++j) {
      out[i * m + j] = quad_iou(dets + 8 * i, gts + 8 * j);
    }
  }
}

}  // extern "C"
