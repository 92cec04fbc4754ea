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

}  // extern "C"
