// RLE mask operations for COCO-style evaluation — C++ implementation.
//
// Behavioral equivalent of the reference's pycocotools C core
// (the DeepFashion2 API's common/maskApi.c), reimplemented from
// the documented RLE format: masks are run-length encoded in Fortran
// (column-major) order, counts alternating background/foreground, and
// serialized with the COCO variable-length char coding (6 bits per char,
// delta-coded from the second pair onward).
//
// Exposed as a C ABI for ctypes (kgdet_tpu_torch/native/__init__.py). The
// port's own copy of kgdet_tpu/native/maskops.cpp, the same code.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

using std::size_t;

extern "C" {

// ---------------------------------------------------------------- encode
// mask: h*w bytes, column-major (F order). out_counts: caller buffer of
// capacity h*w+1 uint32. Returns number of counts written.
int rle_encode(const uint8_t* mask, int h, int w, uint32_t* out_counts) {
  int n = h * w;
  int m = 0;
  uint8_t prev = 0;
  uint32_t run = 0;
  for (int i = 0; i < n; i++) {
    uint8_t v = mask[i] ? 1 : 0;
    if (v != prev) {
      out_counts[m++] = run;
      run = 0;
      prev = v;
    }
    run++;
  }
  out_counts[m++] = run;
  return m;
}

// counts -> mask (h*w bytes, column-major). Returns 0 on success.
int rle_decode(const uint32_t* counts, int m, int h, int w, uint8_t* out) {
  long long pos = 0;
  uint8_t v = 0;
  long long n = (long long)h * w;
  for (int i = 0; i < m; i++) {
    for (uint32_t j = 0; j < counts[i]; j++) {
      if (pos >= n) return 1;
      out[pos++] = v;
    }
    v = !v;
  }
  return pos == n ? 0 : 1;
}

// total foreground area of an RLE.
uint64_t rle_area(const uint32_t* counts, int m) {
  uint64_t a = 0;
  for (int i = 1; i < m; i += 2) a += counts[i];
  return a;
}

// tight bbox [x, y, w, h] of an RLE mask.
void rle_to_bbox(const uint32_t* counts, int m, int h, int w_, double* bb) {
  if (h == 0 || w_ == 0 || m == 0) { bb[0] = bb[1] = bb[2] = bb[3] = 0; return; }
  long long pos = 0;
  int xmin = w_, xmax = -1, ymin = h, ymax = -1;
  for (int i = 0; i < m; i++) {
    long long c = counts[i];
    if (i & 1) {  // foreground run [pos, pos+c)
      long long start = pos, end = pos + c - 1;
      int xs = (int)(start / h), xe = (int)(end / h);
      xmin = std::min(xmin, xs);
      xmax = std::max(xmax, xe);
      if (xs == xe) {
        ymin = std::min(ymin, (int)(start % h));
        ymax = std::max(ymax, (int)(end % h));
      } else {
        ymin = 0;
        ymax = h - 1;
      }
    }
    pos += c;
  }
  if (xmax < 0) { bb[0] = bb[1] = bb[2] = bb[3] = 0; return; }
  bb[0] = xmin; bb[1] = ymin; bb[2] = xmax - xmin + 1; bb[3] = ymax - ymin + 1;
}

// Merge two RLEs over the same canvas: op 0 = union, 1 = intersection.
// Returns the number of counts written to out (capacity h*w+1).
int rle_merge(const uint32_t* a, int ma, const uint32_t* b, int mb,
              int op, uint32_t* out) {
  // walk both run lists in lockstep
  long long ia = 0, ib = 0;       // index into counts
  long long ra = ia < ma ? a[0] : 0, rb = ib < mb ? b[0] : 0;
  uint8_t va = 0, vb = 0;
  int m = 0;
  uint8_t vprev = 0;
  long long run = 0;
  while (ia < ma || ib < mb) {
    while (ra == 0 && ia + 1 < ma) { ia++; ra = a[ia]; va = !va; }
    while (rb == 0 && ib + 1 < mb) { ib++; rb = b[ib]; vb = !vb; }
    long long step = std::min(ra > 0 ? ra : (long long)1 << 60,
                              rb > 0 ? rb : (long long)1 << 60);
    if (step >= ((long long)1 << 59)) break;
    uint8_t v = op == 0 ? (va | vb) : (va & vb);
    if (v != vprev) { out[m++] = (uint32_t)run; run = 0; vprev = v; }
    run += step;
    ra -= step;
    rb -= step;
  }
  out[m++] = (uint32_t)run;
  return m;
}

// IoU between two RLEs; if iscrowd, denominator is area(a) only (IoF).
double rle_iou(const uint32_t* a, int ma, const uint32_t* b, int mb,
               int iscrowd, int h, int w) {
  std::vector<uint32_t> inter((size_t)h * w + 1);
  int mi = rle_merge(a, ma, b, mb, 1, inter.data());
  double ai = (double)rle_area(inter.data(), mi);
  double aa = (double)rle_area(a, ma);
  double ab = (double)rle_area(b, mb);
  double u = iscrowd ? aa : (aa + ab - ai);
  return u > 0 ? ai / u : 0.0;
}

// COCO char coding: counts -> string. out capacity >= 6*m+1. Returns length.
int rle_to_string(const uint32_t* counts, int m, char* out) {
  int p = 0;
  for (int i = 0; i < m; i++) {
    long long x = (long long)counts[i];
    if (i > 2) x -= (long long)counts[i - 2];   // delta coding
    bool more = true;
    while (more) {
      int c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? x != -1 : x != 0;
      if (more) c |= 0x20;
      out[p++] = (char)(c + 48);
    }
  }
  out[p] = 0;
  return p;
}

// COCO char coding: string -> counts (capacity: strlen). Returns m.
int rle_from_string(const char* s, int slen, uint32_t* counts) {
  int m = 0, p = 0;
  while (p < slen) {
    long long x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      int c = s[p] - 48;
      x |= (long long)(c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      p++;
      k++;
      if (!more && (c & 0x10)) x |= -1LL << (5 * k);
    }
    if (m > 2) x += (long long)counts[m - 2];
    counts[m++] = (uint32_t)x;
  }
  return m;
}

// Rasterize a polygon (xy pairs, image coords) to an RLE, following the
// COCO frPoly protocol (reference maskApi.c:161-201): the boundary is
// rounded onto a 5x-upsampled integer grid, walked densely with an
// integer line stepper, and every column-boundary crossing is downsampled
// back to a pixel position; sorted crossing positions delta-coded with
// parity merging give the column-major RLE directly. This reproduces the
// reference's polygon->mask pixels exactly (a pixel-center even-odd fill
// differs at boundaries, shifting segm/kpt eval numbers).
int poly_to_rle(const double* xy, int n_pts, int h, int w, uint32_t* out) {
  const double scale = 5.0;
  const int k = n_pts;
  if (k < 3 || h <= 0 || w <= 0) {
    out[0] = (uint32_t)((long long)h * w);
    return 1;
  }
  std::vector<int> x(k + 1), y(k + 1);
  for (int j = 0; j < k; j++) x[j] = (int)(scale * xy[2 * j] + .5);
  for (int j = 0; j < k; j++) y[j] = (int)(scale * xy[2 * j + 1] + .5);
  x[k] = x[0];
  y[k] = y[0];

  // dense boundary walk on the upsampled grid (direction-normalized so
  // both orientations of an edge produce identical point sequences)
  std::vector<int> u, v;
  for (int j = 0; j < k; j++) {
    int xs = x[j], xe = x[j + 1], ys = y[j], ye = y[j + 1];
    int dx = std::abs(xe - xs), dy = std::abs(ys - ye);
    bool flip = (dx >= dy && xs > xe) || (dx < dy && ys > ye);
    if (flip) { std::swap(xs, xe); std::swap(ys, ye); }
    if (dx >= dy) {
      double s = dx ? (double)(ye - ys) / dx : 0.0;
      for (int d = 0; d <= dx; d++) {
        int t = flip ? dx - d : d;
        u.push_back(t + xs);
        v.push_back((int)(ys + s * t + .5));
      }
    } else {
      double s = (double)(xe - xs) / dy;
      for (int d = 0; d <= dy; d++) {
        int t = flip ? dy - d : d;
        v.push_back(t + ys);
        u.push_back((int)(xs + s * t + .5));
      }
    }
  }

  // column-boundary crossings, downsampled to pixel coordinates
  std::vector<uint32_t> a;
  const int m = (int)u.size();
  for (int j = 1; j < m; j++) {
    if (u[j] == u[j - 1]) continue;
    double xd = (double)(u[j] < u[j - 1] ? u[j] : u[j] - 1);
    xd = (xd + .5) / scale - .5;
    if (std::floor(xd) != xd || xd < 0 || xd > w - 1) continue;
    double yd = (double)(v[j] < v[j - 1] ? v[j] : v[j - 1]);
    yd = (yd + .5) / scale - .5;
    if (yd < 0) yd = 0; else if (yd > h) yd = h;
    yd = std::ceil(yd);
    a.push_back((uint32_t)((int)xd * h + (int)yd));
  }
  a.push_back((uint32_t)((long long)h * w));
  std::sort(a.begin(), a.end());

  // delta-code sorted positions; a zero delta = double crossing, which
  // cancels (parity) and folds into the previous count
  uint32_t p = 0;
  for (size_t j = 0; j < a.size(); j++) { uint32_t t = a[j]; a[j] -= p; p = t; }
  int mo = 0;
  size_t j = 0;
  out[mo++] = a[j++];
  while (j < a.size()) {
    if (a[j] > 0) {
      out[mo++] = a[j++];
    } else {
      j++;
      if (j < a.size()) out[mo - 1] += a[j++];
    }
  }
  return mo;
}

}  // extern "C"
