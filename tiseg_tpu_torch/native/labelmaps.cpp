// Host C++ label maps of the MoNuSeg UNet recipe's train pipeline (port of
// the part of tiseg_tpu/native/labelmaps.cpp that UNetLabelMake and
// fix_instance reach). Built by g++ at first use and called through ctypes
// by tiseg_tpu_torch/native/__init__.py; ctypes releases the interpreter
// lock for the length of each call, so the loader's threads run these in
// parallel. The numpy routes they replace stay as their plain versions
// (datasets/ops/label_maps.py, datasets/utils/instance.py).
//
// Exact re-implementations of:
// - fix_instance (datasets/utils/instance.py:fix_instance_plain): per
//   original id, drop 4-conn fragments < min_size, split into 8-conn
//   components, renumber contiguously (per-id raster order, ids ascending).
// - remove_1px_boundary (UNetLabelMake._remove_1px_boundary_plain):
//   diamond(1) erosion per instance id.
// - unet_weight_map (UNetLabelMake._get_weight_map_plain): UNet eq.(2)
//   border weights from running nearest/second-nearest instance EDT
//   distances, each instance's exact Felzenszwalb EDT evaluated on its
//   padded bbox.
// - instance_bboxes (datasets/ops/label_maps.py:instance_boxes): tight
//   per-id boxes in one image pass.
// - all_centerpoints (datasets/utils/center.py:calculate_centerpoint for
//   every id), dlm_point_maps (DirectionLabelMake.calculate_point_map_plain),
//   ddm_weight (DirectionLabelMake.calculate_weight_map_plain) and bound_map
//   (BoundLabelMake._bound_map_plain): the label maps of the CUNet and CDNet
//   recipes.
// - hv_map (HVLabelMake._hv_map_plain): HoVer-Net's horizontal and
//   vertical maps.
// - dist_cdt_map (DistanceLabelMake._dist_map_plain): DIST's per-instance
//   chessboard distance map.
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

struct UF {
  std::vector<int32_t> p;
  explicit UF(size_t n) : p(n) { for (size_t i = 0; i < n; ++i) p[i] = (int32_t)i; }
  int32_t find(int32_t x) { while (p[x] != x) { p[x] = p[p[x]]; x = p[x]; } return x; }
  void unite(int32_t a, int32_t b) { a = find(a); b = find(b); if (a != b) p[std::max(a,b)] = std::min(a,b); }
};

// 1-D squared EDT with the parabola sites restricted to [a, b] (queries
// still span [0, n)). Exact when every site outside [a, b] carries a
// sentinel value so large its parabola never touches the lower envelope
// over [0, n) — then the envelope (and each query's winning site, ties
// included: identical insertion order and intersection arithmetic) is the
// same as the full-range build, at a fraction of the division-heavy
// envelope cost.
void edt1d_band(const double* f, int n, int a, int b, double* d, int* v, double* z) {
  int k = 0;
  v[0] = a;
  z[0] = -std::numeric_limits<double>::infinity();
  z[1] = std::numeric_limits<double>::infinity();
  for (int q = a + 1; q <= b; ++q) {
    double s;
    while (true) {
      s = ((f[q] + q * (double)q) - (f[v[k]] + v[k] * (double)v[k])) / (2.0 * q - 2.0 * v[k]);
      if (s <= z[k]) { --k; } else break;
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = std::numeric_limits<double>::infinity();
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    double dq = q - (double)v[k];
    d[q] = dq * dq + f[v[k]];
  }
}

// 1-D squared Euclidean distance transform (Felzenszwalb & Huttenlocher).
void edt1d(const double* f, int n, double* d, int* v, double* z) {
  int k = 0;
  v[0] = 0;
  z[0] = -std::numeric_limits<double>::infinity();
  z[1] = std::numeric_limits<double>::infinity();
  for (int q = 1; q < n; ++q) {
    double s;
    while (true) {
      s = ((f[q] + q * (double)q) - (f[v[k]] + v[k] * (double)v[k])) / (2.0 * q - 2.0 * v[k]);
      if (s <= z[k]) { --k; } else break;
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = std::numeric_limits<double>::infinity();
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    double dq = q - (double)v[k];
    d[q] = dq * dq + f[v[k]];
  }
}


// per-id tight bboxes (ids outside [1, n_ids] ignored)
void id_bboxes(const int32_t* inst, int H, int W, int32_t n_ids,
               std::vector<int>& y0, std::vector<int>& y1,
               std::vector<int>& x0, std::vector<int>& x1) {
  y0.assign(n_ids + 1, H); y1.assign(n_ids + 1, -1);
  x0.assign(n_ids + 1, W); x1.assign(n_ids + 1, -1);
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) {
      int32_t v = inst[y * W + x];
      if (v > 0 && v <= n_ids) {
        y0[v] = std::min(y0[v], y); y1[v] = std::max(y1[v], y);
        x0[v] = std::min(x0[v], x); x1[v] = std::max(x1[v], x);
      }
    }
}

// FCOS-style centerness centers for ALL ids in one call (twin of the
// datasets/utils/center.py binary search, identical arithmetic; global
// coords shift rint by an integer so results match the per-crop search
// exactly).
//
// Bisection fast path: the reference search runs 24 iterations from
// [0, 1e6], but every iteration whose midpoint lies provably outside the
// instance's bbox takes the "outside" branch (the probe position's
// dominant-axis offset is >= 0.70710678*mid - 0.5, and the id check fails
// anywhere outside the instance). Those leading iterations only halve
// ``hi`` (an exact double operation), so they are replayed analytically
// and the probing loop starts at the first midpoint that could possibly
// hit the instance — bit-identical results, ~3x fewer probes.
void centerpoints_impl(const int32_t* inst, int H, int W, int32_t n_ids,
                       const int* y0, const int* y1, const int* x0, const int* x1,
                       int32_t* out_yx) {
  static const double SIN[8] = {
      std::sin(0.0),        std::sin(M_PI / 4),     std::sin(M_PI / 2),     std::sin(3 * M_PI / 4),
      std::sin(M_PI),       std::sin(5 * M_PI / 4), std::sin(3 * M_PI / 2), std::sin(7 * M_PI / 4)};
  static const double COS[8] = {
      std::cos(0.0),        std::cos(M_PI / 4),     std::cos(M_PI / 2),     std::cos(3 * M_PI / 4),
      std::cos(M_PI),       std::cos(5 * M_PI / 4), std::cos(3 * M_PI / 2), std::cos(7 * M_PI / 4)};
  std::vector<double> best(n_ids + 1, -1.0);
  std::vector<long> best_idx(n_ids + 1, (long)H * W + 1);
  // per-id conservative probe-distance threshold: beyond T the probe is
  // outside the bbox for every direction (dominant-axis displacement
  // mid/sqrt(2) - 0.5 exceeds the bbox extent; +1.0 covers rint slack)
  std::vector<double> T(n_ids + 1, 0.0);
  for (int32_t id = 1; id <= n_ids; ++id) {
    if (y1[id] < 0) continue;
    const double ext = (double)std::max(y1[id] - y0[id], x1[id] - x0[id]);
    T[id] = (ext + 1.0) * 1.4142135624 + 1.0;
  }
  for (int32_t id = 0; id <= n_ids; ++id) { out_yx[2 * id] = -1; out_yx[2 * id + 1] = -1; }

  // exact bisection of one pixel (identical arithmetic to the original
  // raster loop, incl. the analytic replay of provably-false probes)
  auto eval_pixel = [&](int i, int j, int32_t id) -> double {
    const double t = T[id];
    double maxd = 0.0, mind = 1e7;
    for (int k = 0; k < 8; ++k) {
      double lo = 0.0, hi = 1e6;
      int it = 0;
      while (it < 24 && 0.5 * hi > t) { hi *= 0.5; ++it; }
      for (; it < 24; ++it) {
        const double mid = 0.5 * (lo + hi);
        const long py = std::lrint(i + SIN[k] * mid);
        const long px = std::lrint(j + COS[k] * mid);
        if (py >= 0 && py < H && px >= 0 && px < W && inst[py * W + px] == id)
          lo = mid;
        else
          hi = mid;
      }
      if (hi > maxd) maxd = hi;
      if (lo < mind) mind = lo;
    }
    return mind / maxd;
  };

  // Candidate pruning per id (bit-identical argmax): a SOUND upper bound
  // on a pixel's centerness skips pixels that provably cannot beat the
  // best so far. For an axis ray, the bisection's final lo is <= the
  // distance to the FARTHEST same-id pixel along that row/col direction
  // + 0.5 (rint slack), and its final hi is >= the CONTIGUOUS same-id run
  // - 0.5 (probes inside the run cannot fail). So
  //   centerness = min_8(lo) / max_8(hi)
  //             <= (min_axis F + 0.5) / max(max_axis R - 0.5, eps).
  // The max-UB pixel is evaluated first (usually the true center), then a
  // raster scan keeps exact first-in-raster tie semantics via (c, idx).
  std::vector<int> crop, F_l, F_r, F_u, F_d, R_l, R_r, R_u, R_d;
  std::vector<double> ub;
  for (int32_t id = 1; id <= n_ids; ++id) {
    if (y1[id] < 0) continue;
    const int ys = y0[id], xs = x0[id];
    const int h = y1[id] - ys + 1, w = x1[id] - xs + 1;
    const size_t m = (size_t)h * w;
    auto scan = [&](std::vector<int>& F, std::vector<int>& R, int dy, int dx) {
      F.assign(m, -1); R.assign(m, -1);
      // iterate so that the neighbour in (dy,dx) is already done
      const int yb = dy > 0 ? h - 1 : 0, ye = dy > 0 ? -1 : h, ystep = dy > 0 ? -1 : 1;
      const int xb = dx > 0 ? w - 1 : 0, xe = dx > 0 ? -1 : w, xstep = dx > 0 ? -1 : 1;
      for (int y = yb; y != ye; y += ystep)
        for (int x = xb; x != xe; x += xstep) {
          const bool in = inst[(y + ys) * W + (x + xs)] == id;
          const int ny = y + dy, nx = x + dx;
          const bool nb_ok = ny >= 0 && ny < h && nx >= 0 && nx < w;
          const int nF = nb_ok ? F[(size_t)ny * w + nx] : -1;
          const int nR = nb_ok ? R[(size_t)ny * w + nx] : -1;
          // F: offset of the farthest id pixel in this direction (from here)
          F[(size_t)y * w + x] = nF >= 0 ? nF + 1 : (in ? 0 : -1);
          // R: contiguous id run length in this direction (valid on id px)
          R[(size_t)y * w + x] = in ? (nR >= 0 ? nR + 1 : 0) : -1;
        }
      // F must be "farthest id at-or-after": fix non-id gaps feeding F
      // (handled above: nF>=0 propagates through gaps; on id px with no
      // farther id, F=0 = itself)
    };
    scan(F_r, R_r, 0, 1);
    scan(F_l, R_l, 0, -1);
    scan(F_d, R_d, 1, 0);
    scan(F_u, R_u, -1, 0);
    ub.assign(m, -1.0);
    double ub_max = -1.0;
    long seed = -1;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const size_t q = (size_t)y * w + x;
        if (inst[(y + ys) * W + (x + xs)] != id) continue;
        const int Fm = std::min(std::min(F_l[q], F_r[q]), std::min(F_u[q], F_d[q]));
        const int Rm = std::max(std::max(R_l[q], R_r[q]), std::max(R_u[q], R_d[q]));
        const double u = ((double)Fm + 0.5) / std::max((double)Rm - 0.5, 1e-9);
        ub[q] = u * (1.0 + 1e-12) + 1e-12;  // absorb fp rounding of the bound
        if (ub[q] > ub_max) { ub_max = ub[q]; seed = q; }
      }
    if (seed >= 0) {  // evaluate the most promising pixel first
      const int sy = (int)(seed / w), sx = (int)(seed % w);
      const double c = eval_pixel(sy + ys, sx + xs, id);
      best[id] = c;
      best_idx[id] = (long)(sy + ys) * W + (sx + xs);
      out_yx[2 * id] = sy + ys;
      out_yx[2 * id + 1] = sx + xs;
    }
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const size_t q = (size_t)y * w + x;
        if (ub[q] < best[id]) continue;  // cannot beat (nor tie) the best
        if (inst[(y + ys) * W + (x + xs)] != id) continue;
        const long gidx = (long)(y + ys) * W + (x + xs);
        if (gidx == best_idx[id]) continue;  // the seed, already exact
        const double c = eval_pixel(y + ys, x + xs, id);
        if (c > best[id] || (c == best[id] && gidx < best_idx[id])) {
          best[id] = c;
          best_idx[id] = gidx;
          out_yx[2 * id] = y + ys;
          out_yx[2 * id + 1] = x + xs;
        }
      }
  }
}

}  // namespace

extern "C" {

// --------------------------------------------------------------------------
int32_t fix_instance(const int32_t* inst, int H, int W, int min_size, int32_t* out) {
  const int n = H * W;
  UF uf((size_t)n);
  // pass 1: 4-conn unions within equal ids (for the fragment size filter)
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) {
      int i = y * W + x;
      int32_t v = inst[i];
      if (!v) continue;
      if (x + 1 < W && inst[i + 1] == v) uf.unite(i, i + 1);
      if (y + 1 < H && inst[i + W] == v) uf.unite(i, i + W);
    }
  std::vector<int32_t> size(n, 0);
  for (int i = 0; i < n; ++i)
    if (inst[i]) ++size[uf.find(i)];
  std::vector<uint8_t> keep(n, 0);
  for (int i = 0; i < n; ++i)
    if (inst[i] && size[uf.find(i)] >= min_size) keep[i] = 1;
  // pass 2: 8-conn unions within equal ids over kept pixels
  UF uf8((size_t)n);
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) {
      int i = y * W + x;
      if (!keep[i]) continue;
      int32_t v = inst[i];
      if (x + 1 < W && keep[i + 1] && inst[i + 1] == v) uf8.unite(i, i + 1);
      if (y + 1 < H) {
        if (keep[i + W] && inst[i + W] == v) uf8.unite(i, i + W);
        if (x > 0 && keep[i + W - 1] && inst[i + W - 1] == v) uf8.unite(i, i + W - 1);
        if (x + 1 < W && keep[i + W + 1] && inst[i + W + 1] == v) uf8.unite(i, i + W + 1);
      }
    }
  // renumber: ascending original id, then per-id component discovery order
  // (raster within the id) — matches the numpy loop's numbering scheme.
  std::vector<std::pair<int64_t, int32_t>> roots;  // (id<<32 | first_idx, root)
  std::vector<int32_t> newid(n, 0);
  for (int i = 0; i < n; ++i)
    if (keep[i]) {
      int32_t r = uf8.find(i);
      if (!newid[r]) { newid[r] = -1; roots.push_back({((int64_t)inst[i] << 32) | (uint32_t)i, r}); }
    }
  std::sort(roots.begin(), roots.end());
  for (size_t k = 0; k < roots.size(); ++k) newid[roots[k].second] = (int32_t)(k + 1);
  for (int i = 0; i < n; ++i) out[i] = keep[i] ? newid[uf8.find(i)] : 0;
  return (int32_t)roots.size();
}

// --------------------------------------------------------------------------
void remove_1px_boundary(const int32_t* inst, int H, int W, int32_t* out) {
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) {
      int i = y * W + x;
      int32_t v = inst[i];
      // diamond(1) erosion per id; skimage erosion pads HIGH, so
      // out-of-image neighbors never erode an edge pixel
      out[i] = (v &&
                (y == 0 || inst[i - W] == v) && (y + 1 == H || inst[i + W] == v) &&
                (x == 0 || inst[i - 1] == v) && (x + 1 == W || inst[i + 1] == v)) ? v : 0;
    }
}

// --------------------------------------------------------------------------
// UNet eq.(2) weight map over a DENSE-labeled map (ids 1..n_ids).
void unet_weight_map(const int32_t* ann, int H, int W, int32_t n_ids, int trunc,
                     float w0, float sigma, double* out) {
  const double BIG = 1e9;
  const int n = H * W;
  if (n_ids <= 1) { std::memset(out, 0, sizeof(double) * n); return; }
  // near1/near2 hold SQUARED distances until the final pass (sentinel BIG^2)
  std::vector<double> near1(n, BIG * BIG), near2(n, BIG * BIG);
  std::vector<int> y0, y1, x0, x1;
  id_bboxes(ann, H, W, n_ids, y0, y1, x0, x1);
  std::vector<double> dcol, drow, zbuf;
  std::vector<int> vbuf, dv;
  for (int32_t id = 1; id <= n_ids; ++id) {
    if (y1[id] < 0) continue;
    int ys = std::max(y0[id] - trunc, 0), ye = std::min(y1[id] + trunc + 1, H);
    int xs = std::max(x0[id] - trunc, 0), xe = std::min(x1[id] + trunc + 1, W);
    int h = ye - ys, w = xe - xs;
    // columns outside the instance's x-range hold no instance pixel: their
    // vertical distance is the BIG^2 sentinel without scanning
    const int fx0 = x0[id] - xs, fx1 = x1[id] - xs;
    const int bw = fx1 - fx0 + 1;  // only instance columns ever hold sites
    // binary column stage: two integer scans give the exact squared
    // vertical distance to the instance per column — the same integers the
    // general parabola pass (edt1d on 0 / BIG^2) produces, at a fraction of
    // the cost (no divisions)
    dcol.assign((size_t)h * bw, BIG * BIG);
    dv.assign((size_t)h * bw, 1 << 28);
    for (int x = 0; x < bw; ++x) {
      int last = -(1 << 28);
      for (int y = 0; y < h; ++y) {
        if (ann[(y + ys) * W + (x + fx0 + xs)] == id) last = y;
        dv[(size_t)y * bw + x] = y - last;
      }
      int next = 1 << 28;
      for (int y = h - 1; y >= 0; --y) {
        if (ann[(y + ys) * W + (x + fx0 + xs)] == id) next = y;
        dv[(size_t)y * bw + x] = std::min(dv[(size_t)y * bw + x], next - y);
      }
      for (int y = 0; y < h; ++y) {
        const size_t i = (size_t)y * bw + x;
        if (dv[i] < h) dcol[i] = (double)dv[i] * dv[i];
      }
    }
    int m = std::max(h, w);
    drow.resize(m); vbuf.resize(m); zbuf.resize(m + 1);
    std::vector<double> row(w), dr(w);
    for (int y = 0; y < h; ++y) {          // then rows: parabola sites only
      for (int x = fx0; x <= fx1; ++x) row[x] = dcol[(size_t)y * bw + (x - fx0)];
      edt1d_band(row.data(), w, fx0, fx1, dr.data(), vbuf.data(), zbuf.data());
      // merge on SQUARED distances: IEEE sqrt is monotone, so the
      // (near1, near2) selection is value-identical to merging on the
      // rooted distances (ties included — see the equal-root analysis in
      // docs/ROUND4.md); the sqrt moves out of this O(n_ids * box) loop
      // to one pass over the image below.
      double* n1 = &near1[(size_t)(y + ys) * W + xs];
      double* n2 = &near2[(size_t)(y + ys) * W + xs];
      for (int x = 0; x < w; ++x) {  // branchless two-smallest update (SIMD-able)
        const double d2 = dr[x];
        const double v1 = n1[x];
        n2[x] = std::min(n2[x], std::max(v1, d2));
        n1[x] = std::min(v1, d2);
      }
    }
  }
  double inv = 1.0 / (2.0 * sigma * sigma);
  double cap = 4.0 * trunc;
  const double BIG2 = BIG * BIG;
  // glibc exp() takes a ~300ns accuracy path for near-underflow arguments
  // (the common far-from-instances case, arg = -cap^2*inv); any w0*exp(arg)
  // below half the min f32 subnormal casts to exactly 0.f — short-circuit
  // (bit-identical to the computed-then-cast value).
  const double acut = std::log(1e-46 / (std::abs((double)w0) + 1e-300));
  for (int i = 0; i < n; ++i) {
    if (ann[i] > 0) { out[i] = 0.0; continue; }
    double pix = (near2[i] >= BIG2) ? BIG
                                    : (std::sqrt(near1[i]) + std::sqrt(near2[i]));
    pix = std::min(pix, cap);
    const double a = -pix * pix * inv;
    out[i] = (a < acut) ? 0.0 : (w0 * std::exp(a));
  }
}


// (n_ids+1, 4) rows (y0, y1, x0, x1) per id, y1 = -1 where absent — the
// one-pass twin of ops/label_maps.py instance_boxes' unique+find_objects.
void instance_bboxes(const int32_t* inst, int H, int W, int32_t n_ids, int32_t* out) {
  std::vector<int> y0, y1, x0, x1;
  id_bboxes(inst, H, W, n_ids, y0, y1, x0, x1);
  for (int32_t id = 0; id <= n_ids; ++id) {
    out[4 * id] = y0[id];
    out[4 * id + 1] = y1[id];
    out[4 * id + 2] = x0[id];
    out[4 * id + 3] = x1[id];
  }
}

void all_centerpoints(const int32_t* inst, int H, int W, int32_t n_ids, int32_t* out_yx) {
  std::vector<int> y0, y1, x0, x1;
  id_bboxes(inst, H, W, n_ids, y0, y1, x0, x1);
  centerpoints_impl(inst, H, W, n_ids, y0.data(), y1.data(), x0.data(), x1.data(), out_yx);
}

// --------------------------------------------------------------------------
// DirectionLabelMake per-instance point/distance/gradient stage in one call
// (twin of DirectionLabelMake.calculate_point_map_plain, reference
// direction_map.py:60-118): per id on its 6px-padded bbox crop,
//  - to_center: d = (1 - r/(rmax+1e-7)) on instance px, r = exact
//    euclidean distance to the centerness center (scipy EDT to a single
//    point is the analytic hypot — bit-identical);
//  - else: d = edt/(dmax+1e-7), edt = exact EDT of the crop mask
//    (Felzenszwalb, same integers => same sqrt);
//  - gradient = ksize x ksize Sobel-style cross-correlation of the
//    f32-cast d with zero padding at crop borders (crop pad 6 >= the 5px
//    halo, so only image-edge-clamped crops ever see the zero border,
//    exactly like the python path), written on instance px only.
// dist/grad results are float32; centers are the all_centerpoints ones.
void dlm_point_maps(const int32_t* inst, int H, int W, int32_t n_ids, int ksize,
                    int to_center, float* dist_out, float* grad_out, int32_t* centers_yx) {
  const int n = H * W;
  std::memset(dist_out, 0, sizeof(float) * n);
  std::memset(grad_out, 0, sizeof(float) * 2 * n);
  std::vector<int> y0, y1, x0, x1;
  id_bboxes(inst, H, W, n_ids, y0, y1, x0, x1);
  centerpoints_impl(inst, H, W, n_ids, y0.data(), y1.data(), x0.data(), x1.data(), centers_yx);

  // Sobel-style kernel, f32 like datasets/utils/gradient.py sobel_kernels
  const int c = (ksize - 1) / 2;
  std::vector<float> ky((size_t)ksize * ksize, 0.f), kx((size_t)ksize * ksize, 0.f);
  for (int j = 0; j < ksize; ++j)
    for (int i = 0; i < ksize; ++i) {
      if (i == c && j == c) continue;
      const int j_ = j - c, i_ = i - c;
      const float denom = (float)(i_ * i_ + j_ * j_);
      kx[(size_t)j * ksize + i] = (float)i_ / denom;
      ky[(size_t)j * ksize + i] = (float)j_ / denom;
    }

  std::vector<double> d;
  std::vector<float> df;
  std::vector<double> f, col, dc, row, dr, zbuf;
  std::vector<int> vbuf;
  std::vector<double> gyb, gxb;
  std::vector<int> rx0, rx1;
  const int PAD = 6;
  for (int32_t id = 1; id <= n_ids; ++id) {
    if (y1[id] < 0) continue;
    const int ys = std::max(y0[id] - PAD, 0), ye = std::min(y1[id] + PAD + 1, H);
    const int xs = std::max(x0[id] - PAD, 0), xe = std::min(x1[id] + PAD + 1, W);
    const int h = ye - ys, w = xe - xs;
    d.assign((size_t)h * w, 0.0);
    if (to_center) {
      const int cy = centers_yx[2 * id] - ys, cx = centers_yx[2 * id + 1] - xs;
      double rmax = 0.0;
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
          if (inst[(y + ys) * W + (x + xs)] == id) {
            const double dy = y - cy, dx = x - cx;
            const double r = std::sqrt(dy * dy + dx * dx);
            d[(size_t)y * w + x] = r;
            if (r > rmax) rmax = r;
          }
      const double den = rmax + 1e-7;  // true division, like the python path
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          const size_t i = (size_t)y * w + x;
          d[i] = (inst[(y + ys) * W + (x + xs)] == id) ? 1.0 - d[i] / den : 0.0;
        }
    } else {
      // exact EDT of the crop mask (distance to nearest non-instance px)
      f.assign((size_t)h * w, 0.0);
      bool any_bg = false;
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          const bool in = inst[(y + ys) * W + (x + xs)] == id;
          f[(size_t)y * w + x] = in ? 1e18 : 0.0;
          any_bg |= !in;
        }
      if (!any_bg) {
        // scipy's feature transform leaves the out-of-bounds sentinel
        // (-1, 0) when the crop has no background px, so its "distance"
        // is hypot(y+1, x) — replicated bit-for-bit (exact integer sqrt)
        double dmax = 0.0;
        for (int y = 0; y < h; ++y)
          for (int x = 0; x < w; ++x) {
            const double r = std::sqrt((double)((y + 1) * (y + 1) + x * x));
            d[(size_t)y * w + x] = r;
            if (r > dmax) dmax = r;
          }
        const double den = dmax + 1e-7;
        for (size_t i = 0; i < d.size(); ++i) d[i] /= den;
      } else {
        const int m2 = std::max(h, w);
        col.resize(h); dc.resize(h); row.resize(w); dr.resize(w);
        vbuf.resize(m2); zbuf.resize(m2 + 1);
        for (int x = 0; x < w; ++x) {
          for (int y = 0; y < h; ++y) col[y] = f[(size_t)y * w + x];
          edt1d(col.data(), h, dc.data(), vbuf.data(), zbuf.data());
          for (int y = 0; y < h; ++y) d[(size_t)y * w + x] = dc[y];
        }
        double dmax = 0.0;
        for (int y = 0; y < h; ++y) {
          for (int x = 0; x < w; ++x) row[x] = d[(size_t)y * w + x];
          edt1d(row.data(), w, dr.data(), vbuf.data(), zbuf.data());
          for (int x = 0; x < w; ++x) {
            const size_t i = (size_t)y * w + x;
            d[i] = (inst[(y + ys) * W + (x + xs)] == id) ? std::sqrt(dr[x]) : 0.0;
            if (d[i] > dmax) dmax = d[i];
          }
        }
        const double den = dmax + 1e-7;  // true division, like the python path
        for (size_t i = 0; i < d.size(); ++i) d[i] /= den;
      }
    }
    // dist write (python: float32 view += float64 crop)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        if (inst[(y + ys) * W + (x + xs)] == id)
          dist_out[(y + ys) * W + (x + xs)] = (float)d[(size_t)y * w + x];
    // gradient on the f32-cast crop, zero-padded at crop borders.
    // Span-restricted tap-OUTER accumulation: per crop row only the
    // [rx0, rx1] instance-pixel span accumulates (contiguous inner loop —
    // auto-vectorizable); per-pixel tap set, tap order (j, i ascending,
    // center tap included) and double arithmetic are IDENTICAL to the
    // per-pixel loop this replaces, so results are bit-equal.
    df.resize((size_t)h * w);
    for (size_t i = 0; i < df.size(); ++i) df[i] = (float)d[i];
    gyb.assign((size_t)h * w, 0.0);
    gxb.assign((size_t)h * w, 0.0);
    rx0.assign(h, w);
    rx1.assign(h, -1);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        if (inst[(y + ys) * W + (x + xs)] == id) {
          if (x < rx0[y]) rx0[y] = x;
          if (x > rx1[y]) rx1[y] = x;
        }
    for (int j = 0; j < ksize; ++j)
      for (int i = 0; i < ksize; ++i) {
        const double kyv = ky[(size_t)j * ksize + i];
        const double kxv = kx[(size_t)j * ksize + i];
        const int dy = j - c, dx = i - c;
        const int ylo = std::max(0, -dy), yhi = std::min(h, h - dy);
        for (int y = ylo; y < yhi; ++y) {
          if (rx1[y] < 0) continue;
          const int a = std::max(rx0[y], -dx), b = std::min(rx1[y], w - 1 - dx);
          if (a > b) continue;
          const float* src = &df[(size_t)(y + dy) * w];  // x + dx stays in [0, w)
          double* gyr = &gyb[(size_t)y * w];
          double* gxr = &gxb[(size_t)y * w];
          for (int x = a; x <= b; ++x) {
            const double v = (double)src[x + dx];
            gyr[x] += kyv * v;
            gxr[x] += kxv * v;
          }
        }
      }
    for (int y = 0; y < h; ++y)
      for (int x = rx0[y]; x <= rx1[y]; ++x)
        if (inst[(y + ys) * W + (x + xs)] == id) {
          grad_out[2 * ((y + ys) * W + (x + xs))] = (float)gyb[(size_t)y * w + x];
          grad_out[2 * ((y + ys) * W + (x + xs)) + 1] = (float)gxb[(size_t)y * w + x];
        }
  }
}

// --------------------------------------------------------------------------
// DirectionLabelMake DDM-based loss weight map in one call (twin of
// DirectionLabelMake.calculate_weight_map_plain + datasets/utils/direction.py
// generate_direction_differential_map class-map path): ddm via the
// 1-round(cos) table over the 8 toroidal (np.roll) neighbors, bg-zeroed,
// min/max-normalized, times (10 - dist), cross-dilated (grey max, in-image
// — scipy reflect == skimage low-pad for the cross at borders), then
// float32 * 2 + 1.
void ddm_weight(const int32_t* dir_map, const float* dist_map, int H, int W,
                int C, const int32_t* vecs, float* out) {
  std::vector<double> tab((size_t)C * C);
  for (int a = 0; a < C; ++a)
    for (int b = 0; b < C; ++b) {
      const double ay = vecs[2 * a], ax = vecs[2 * a + 1];
      const double by = vecs[2 * b], bx = vecs[2 * b + 1];
      const double na = std::sqrt(ay * ay + ax * ax), nb = std::sqrt(by * by + bx * bx);
      const double cos = (ay * by + ax * bx) / (na * nb + 1e-6);
      tab[(size_t)a * C + b] = 1.0 - std::nearbyint(cos);  // numpy round = ties-to-even
    }
  const int n = H * W;
  std::vector<double> ddm(n, 0.0);
  static const int SH[8][2] = {{1, 0}, {1, 1}, {0, 1}, {-1, 1}, {-1, 0}, {-1, -1}, {0, -1}, {1, -1}};
  double mx = -1e300, mn = 1e300;
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) {
      const int i = y * W + x;
      const int32_t a = dir_map[i];
      double v = 0.0;
      if (a != 0) {
        for (int k = 0; k < 8; ++k) {
          // np.roll(dm, (sv, sh)) at (y, x) reads dm[(y-sv) % H, (x-sh) % W]
          const int yy = (y - SH[k][0] + H) % H;
          const int xx = (x - SH[k][1] + W) % W;
          v = std::max(v, tab[(size_t)a * C + dir_map[yy * W + xx]]);
        }
      }
      ddm[i] = v;
      mx = std::max(mx, v); mn = std::min(mn, v);
    }
  if (mx != 0.0) {
    const double inv = 1.0 / (mx - mn);
    for (int i = 0; i < n; ++i) ddm[i] = (ddm[i] - mn) * inv;
  }
  // weight = ddm * (10 - dist) (f64), cross grey-dilation, f32 * 2 + 1
  std::vector<double> wgt(n);
  for (int i = 0; i < n; ++i) wgt[i] = ddm[i] * (double)(10.f - dist_map[i]);
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) {
      double v = wgt[y * W + x];
      if (y > 0) v = std::max(v, wgt[(y - 1) * W + x]);
      if (y + 1 < H) v = std::max(v, wgt[(y + 1) * W + x]);
      if (x > 0) v = std::max(v, wgt[y * W + x - 1]);
      if (x + 1 < W) v = std::max(v, wgt[y * W + x + 1]);
      out[y * W + x] = (float)v * 2.f + 1.f;
    }
}
// --------------------------------------------------------------------------
// Boundary class via L1 (diamond) morphology: bound = dilation(mask, r0)
// AND NOT erosion(mask, r1), per instance id, written as edge pixels (twin
// of BoundLabelMake._bound_map_plain).
void bound_map(const int32_t* inst, int H, int W, int r0, int r1, uint8_t* bound) {
  std::memset(bound, 0, (size_t)H * W);
  int32_t maxid = 0;
  const int n = H * W;
  for (int i = 0; i < n; ++i) maxid = std::max(maxid, inst[i]);
  if (maxid <= 0) return;
  std::vector<int> y0, y1, x0, x1;
  id_bboxes(inst, H, W, maxid, y0, y1, x0, x1);
  int pad = std::max(r0, r1) + 1;
  std::vector<int32_t> din, dout;
  for (int32_t id = 1; id <= maxid; ++id) {
    if (y1[id] < 0) continue;
    int ys = std::max(y0[id] - pad, 0), ye = std::min(y1[id] + pad + 1, H);
    int xs = std::max(x0[id] - pad, 0), xe = std::min(x1[id] + pad + 1, W);
    int h = ye - ys, w = xe - xs;
    const int INF = h + w + 4;
    din.assign((size_t)h * w, INF);   // L1 distance to mask
    dout.assign((size_t)h * w, INF);  // L1 distance to complement (skimage
                                      // binary_erosion pads HIGH: outside
                                      // the image is NOT complement)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        bool in = inst[(y + ys) * W + (x + xs)] == id;
        size_t i = (size_t)y * w + x;
        if (in) din[i] = 0; else dout[i] = 0;
      }
    auto l1pass = [&](std::vector<int32_t>& d) {
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          size_t i = (size_t)y * w + x;
          if (y > 0) d[i] = std::min(d[i], d[i - w] + 1);
          if (x > 0) d[i] = std::min(d[i], d[i - 1] + 1);
        }
      for (int y = h - 1; y >= 0; --y)
        for (int x = w - 1; x >= 0; --x) {
          size_t i = (size_t)y * w + x;
          if (y + 1 < h) d[i] = std::min(d[i], d[i + w] + 1);
          if (x + 1 < w) d[i] = std::min(d[i], d[i + 1] + 1);
        }
    };
    l1pass(din);
    l1pass(dout);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        size_t i = (size_t)y * w + x;
        if (din[i] <= r0 && dout[i] <= r1) bound[(y + ys) * W + (x + xs)] = 1;
      }
  }
}

// --------------------------------------------------------------------------
// HoVer-Net's horizontal/vertical map (twin of HVLabelMake._hv_map_plain):
// per instance on its padded, clamped box, the integer center of mass
// rounded as int(com + 0.5), the 1-based coordinates minus it, zero outside
// the instance, each sign divided by its extreme in float32, written
// interleaved as (x, y) pairs. Boxes under 2 px in either direction are
// skipped. ``boxes`` is nb x 5 int32 rows: id, y0, y1, x0, x1 (stops
// exclusive).
void hv_map(const int32_t* inst, int H, int W, int nb, const int32_t* boxes, float* xy_out) {
  std::memset(xy_out, 0, sizeof(float) * 2 * (size_t)H * W);
  for (int b = 0; b < nb; ++b) {
    const int32_t id = boxes[5 * b];
    const int y0 = boxes[5 * b + 1], y1 = boxes[5 * b + 2];
    const int x0 = boxes[5 * b + 3], x1 = boxes[5 * b + 4];
    const int h = y1 - y0, w = x1 - x0;
    if (h < 2 || w < 2) continue;
    long sy = 0, sx = 0, mass = 0;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        if (inst[(size_t)(y + y0) * W + (x + x0)] == id) { sy += y; sx += x; ++mass; }
    if (!mass) continue;
    const int cy = (int)((double)sy / mass + 0.5);  // int(com + 0.5) with com >= 0
    const int cx = (int)((double)sx / mass + 0.5);
    int nx = 0, px = 0, ny = 0, py = 0;  // the extremes of each sign over the instance
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        if (inst[(size_t)(y + y0) * W + (x + x0)] == id) {
          const int vx = x + 1 - cx, vy = y + 1 - cy;
          nx = std::min(nx, vx); px = std::max(px, vx);
          ny = std::min(ny, vy); py = std::max(py, vy);
        }
    const float fnx = (float)(-nx), fpx = (float)px, fny = (float)(-ny), fpy = (float)py;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const size_t gi = (size_t)(y + y0) * W + (x + x0);
        if (inst[gi] != id) continue;
        const int vx = x + 1 - cx, vy = y + 1 - cy;
        float ox = (float)vx, oy = (float)vy;
        if (vx < 0) ox = ox / fnx; else if (vx > 0) ox = ox / fpx;
        if (vy < 0) oy = oy / fny; else if (vy > 0) oy = oy / fpy;
        xy_out[2 * gi] = ox;
        xy_out[2 * gi + 1] = oy;
      }
  }
}

// --------------------------------------------------------------------------
// DIST's chessboard distance map (twin of DistanceLabelMake._dist_map_plain):
// per instance on its padded, clamped box, the exact L-inf distance of each
// instance pixel to the nearest other pixel of the box (two 8-neighbour
// chamfer passes), divided by the box's maximum in float32 when
// ``inst_norm``. Edge cases of scipy's distance_transform_cdt kept: a box
// with no other pixel gives -1 everywhere (written when not normalized,
// skipped when normalized); boxes under 2 px in either direction are
// skipped. ``boxes`` as hv_map's.
void dist_cdt_map(const int32_t* inst, int H, int W, int nb, const int32_t* boxes, int inst_norm, float* out) {
  std::memset(out, 0, sizeof(float) * (size_t)H * W);
  std::vector<int32_t> d;
  for (int b = 0; b < nb; ++b) {
    const int32_t id = boxes[5 * b];
    const int y0 = boxes[5 * b + 1], y1 = boxes[5 * b + 2];
    const int x0 = boxes[5 * b + 3], x1 = boxes[5 * b + 4];
    const int h = y1 - y0, w = x1 - x0;
    if (h < 2 || w < 2) continue;
    const int32_t inf = h + w + 4;
    d.assign((size_t)h * w, inf);
    bool any_bg = false;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        if (inst[(size_t)(y + y0) * W + (x + x0)] != id) {
          d[(size_t)y * w + x] = 0;
          any_bg = true;
        }
    if (!any_bg) {
      if (!inst_norm)
        for (int y = 0; y < h; ++y)
          for (int x = 0; x < w; ++x) out[(size_t)(y + y0) * W + (x + x0)] = -1.f;
      continue;
    }
    for (int y = 0; y < h; ++y)  // forward pass: left, up-left, up, up-right
      for (int x = 0; x < w; ++x) {
        int32_t& v = d[(size_t)y * w + x];
        if (x > 0) v = std::min(v, d[(size_t)y * w + x - 1] + 1);
        if (y > 0) {
          v = std::min(v, d[(size_t)(y - 1) * w + x] + 1);
          if (x > 0) v = std::min(v, d[(size_t)(y - 1) * w + x - 1] + 1);
          if (x + 1 < w) v = std::min(v, d[(size_t)(y - 1) * w + x + 1] + 1);
        }
      }
    int32_t mx = 0;
    for (int y = h - 1; y >= 0; --y)  // backward pass: right, down-right, down, down-left
      for (int x = w - 1; x >= 0; --x) {
        int32_t& v = d[(size_t)y * w + x];
        if (x + 1 < w) v = std::min(v, d[(size_t)y * w + x + 1] + 1);
        if (y + 1 < h) {
          v = std::min(v, d[(size_t)(y + 1) * w + x] + 1);
          if (x > 0) v = std::min(v, d[(size_t)(y + 1) * w + x - 1] + 1);
          if (x + 1 < w) v = std::min(v, d[(size_t)(y + 1) * w + x + 1] + 1);
        }
        mx = std::max(mx, v);
      }
    if (inst_norm && mx <= 0) continue;
    const float fmx = (float)mx;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const size_t gi = (size_t)(y + y0) * W + (x + x0);
        if (inst[gi] == id) out[gi] = inst_norm ? (float)d[(size_t)y * w + x] / fmx : (float)d[(size_t)y * w + x];
      }
  }
}

}  // extern "C"
