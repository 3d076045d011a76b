// Structured-swath interpolation weights.
//
// Satellite L2 swaths are logically structured (scanline x ground-pixel)
// grids; the reference triangulates them with qhull as if they were
// scattered points (reference oisatgmi/interpolator.py:151).  This native
// builder exploits the known connectivity: each quad of adjacent pixels is
// split into two triangles, targets are located through a uniform spatial
// hash of quad bounding boxes, and barycentric weights are emitted in the
// same sparse (idx[3], w[3]) format as the Delaunay path.  It also returns
// the nearest-pixel distance needed for the reference's "too far" mask.
//
// Built as a plain C ABI shared object (ctypes loads it; no pybind11 in
// this environment).  Compile: g++ -O3 -march=native -shared -fPIC.
//
// The port's copy of native/swath_weights.cpp (unchanged code); it is built
// by oisat_tpu_torch/native.py into oisat_tpu_torch/_build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Hash {
  double x0, y0, inv_cx, inv_cy;
  int nbx, nby;
  std::vector<int32_t> start;  // CSR over bins
  std::vector<int32_t> items;  // quad ids
};

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// lon/lat: (ny, nx) pixel centers (row-major).  tx/ty: (nt,) targets.
// max_dist: distances are exact up to this bound; beyond it the search
// stops early and reports a value > max_dist (callers only use distances
// to apply the far-mask cutoff, so exactness past it is wasted work — a
// target a whole domain away from the swath would otherwise ring-scan
// O((dist/pitch)^2) bins).
// dist_mode: 0 -> dist is the exact nearest-pixel distance (up to
// max_dist) and nn its pixel id, matching scipy cKDTree.query with a
// lowest-id tie break.  1 -> dist is only guaranteed on the
// <=/> max_dist SIDE of the cutoff (the scan stops at the FIRST pixel
// within max_dist); nn is unspecified.  The linear-interpolation caller
// consumes dist solely as the boolean far mask `dist > cutoff`, so mode
// 1 preserves its output exactly while skipping the argmin scan — for an
// on-swath target the very first bin usually terminates it.
// Outputs: idx (nt,3) int32 flat pixel ids; w (nt,3); dist (nt,) nearest
// pixel distance (Euclidean in degrees, matching the reference's cKDTree
// query metric, exact while <= max_dist and dist_mode=0); nn (nt,) flat
// id of that nearest pixel (the native nearest-neighbour interpolation
// mode); ok (nt,) 1 if inside some swath triangle.  Returns 0 on success.
// need_tri: 0 skips the point-in-triangle pass AND the quad spatial hash
// entirely (nearest-neighbour interpolation modes use only dist/nn).
int build_structured_weights(const double* lon, const double* lat, int ny,
                             int nx, const double* tx, const double* ty,
                             int nt, double max_dist, int need_tri,
                             int dist_mode,
                             int32_t* idx, double* w,
                             double* dist, int32_t* nn, uint8_t* ok) {
  if (ny < 2 || nx < 2 || nt <= 0) return 1;
  const int nquad_y = ny - 1, nquad_x = nx - 1;
  const int64_t nquads = int64_t(nquad_y) * nquad_x;
  const int64_t npix = int64_t(ny) * nx;

  // ---- swath bounds + typical quad size for the bin pitch ----------------
  double xmin = 1e300, xmax = -1e300, ymin = 1e300, ymax = -1e300;
  for (int64_t i = 0; i < int64_t(ny) * nx; ++i) {
    const double X = lon[i], Y = lat[i];
    if (!std::isfinite(X) || !std::isfinite(Y)) return 2;
    xmin = std::min(xmin, X); xmax = std::max(xmax, X);
    ymin = std::min(ymin, Y); ymax = std::max(ymax, Y);
  }
  const double span_x = std::max(xmax - xmin, 1e-12);
  const double span_y = std::max(ymax - ymin, 1e-12);
  // aim for ~1 quad per bin on average, capped for memory.  Clamp in
  // double BEFORE the int conversion: a degenerate span (constant-lat
  // swath floored at 1e-12) makes the ratio overflow int, which is UB.
  int nbx = clampi(int(std::min(std::sqrt(double(nquads) * span_x / span_y),
                                4096.0)) + 1, 1, 4096);
  int nby = clampi(int(std::min(double(nquads) / std::max(nbx, 1), 4096.0)) + 1,
                   1, 4096);

  Hash h;
  h.x0 = xmin; h.y0 = ymin;
  h.nbx = nbx; h.nby = nby;
  h.inv_cx = nbx / span_x;
  h.inv_cy = nby / span_y;

  auto bin_of = [&](double X, double Y) {
    int bx = clampi(int((X - h.x0) * h.inv_cx), 0, nbx - 1);
    int by = clampi(int((Y - h.y0) * h.inv_cy), 0, nby - 1);
    return by * nbx + bx;
  };

  // ---- pixel spatial hash (CSR): every pixel lands in exactly one bin.
  // The nearest-pixel scan walks this instead of quad corners — the old
  // corner walk tested each interior pixel up to 4x (once per adjacent
  // quad) and could not reach a pixel whose every adjacent quad was an
  // antimeridian-crossing skip; hashing pixels directly fixes both.
  const int nbins = nbx * nby;
  std::vector<int32_t> pix_start(nbins + 1, 0);
  std::vector<int32_t> pix_items(npix);
  {
    std::vector<int32_t> pcount(nbins + 1, 0);
    for (int64_t p = 0; p < npix; ++p) pcount[bin_of(lon[p], lat[p]) + 1]++;
    for (int b = 0; b < nbins; ++b) pcount[b + 1] += pcount[b];
    pix_start = pcount;
    std::vector<int32_t> cur(pcount.begin(), pcount.end() - 1);
    // pixels inserted in ascending flat id: within-bin order stays sorted,
    // which the lowest-id tie break below relies on
    for (int64_t p = 0; p < npix; ++p)
      pix_items[cur[bin_of(lon[p], lat[p])]++] = int32_t(p);
  }

  // ---- quad hash (tri pass only): each quad registers in every bin its
  // bbox overlaps ----
  std::vector<int32_t> counts(nbins + 1, 0);
  std::vector<int32_t> items;
  auto quad_bins = [&](int64_t q, auto&& fn) {
    const int qy = int(q / nquad_x), qx = int(q % nquad_x);
    const int64_t p00 = int64_t(qy) * nx + qx;
    const int64_t p01 = p00 + 1, p10 = p00 + nx, p11 = p10 + 1;
    const double qxmin = std::min(std::min(lon[p00], lon[p01]), std::min(lon[p10], lon[p11]));
    const double qxmax = std::max(std::max(lon[p00], lon[p01]), std::max(lon[p10], lon[p11]));
    const double qymin = std::min(std::min(lat[p00], lat[p01]), std::min(lat[p10], lat[p11]));
    const double qymax = std::max(std::max(lat[p00], lat[p01]), std::max(lat[p10], lat[p11]));
    // antimeridian-crossing quads span ~360 deg of unwrapped lon: their
    // sliver triangles OVERLAP the real swath elsewhere (unlike a Delaunay
    // partition, where the local simplex always wins) and would blend
    // pixels from the opposite side of the orbit; they also register in
    // every lon bin of their lat band, blowing up the CSR.  Skip them —
    // their pixels stay reachable through the adjacent non-wrapped quads.
    if (qxmax - qxmin > 180.0) return;
    const int bx0 = clampi(int((qxmin - h.x0) * h.inv_cx), 0, nbx - 1);
    const int bx1 = clampi(int((qxmax - h.x0) * h.inv_cx), 0, nbx - 1);
    const int by0 = clampi(int((qymin - h.y0) * h.inv_cy), 0, nby - 1);
    const int by1 = clampi(int((qymax - h.y0) * h.inv_cy), 0, nby - 1);
    for (int by = by0; by <= by1; ++by)
      for (int bx = bx0; bx <= bx1; ++bx) fn(by * nbx + bx);
  };
  if (need_tri) {
    for (int64_t q = 0; q < nquads; ++q)
      quad_bins(q, [&](int b) { counts[b + 1]++; });
    for (int b = 0; b < nbins; ++b) counts[b + 1] += counts[b];
    items.resize(counts[nbins]);
    std::vector<int32_t> cursor(counts.begin(), counts.end() - 1);
    for (int64_t q = 0; q < nquads; ++q)
      quad_bins(q, [&](int b) { items[cursor[b]++] = int32_t(q); });
  }

  // ---- per-target: point-in-triangle over hashed quads -------------------
  const double eps = 1e-12;
  for (int t = 0; t < nt; ++t) {
    const double X = tx[t], Y = ty[t];
    ok[t] = 0;
    idx[3 * t] = idx[3 * t + 1] = idx[3 * t + 2] = 0;
    w[3 * t] = w[3 * t + 1] = w[3 * t + 2] = 0.0;
    dist[t] = 1e300;
    nn[t] = 0;
    // a non-finite target would hit double->int UB in bin_of and force a
    // full ring scan (every NaN comparison is false)
    if (!std::isfinite(X) || !std::isfinite(Y)) continue;
    // O(1) far rejection: a target more than max_dist outside the swath
    // bounding box cannot have any pixel within the cutoff (nor lie in a
    // triangle) — without this, every far-off-domain target walks
    // O((max_dist/pitch)^2) empty bins before the ring bound trips.
    // dist stays 1e300 (> max_dist), the documented "some value past the
    // cutoff"; no-op when max_dist is inf.
    if (X < xmin - max_dist || X > xmax + max_dist ||
        Y < ymin - max_dist || Y > ymax + max_dist) {
      dist[t] = 1e300;
      continue;
    }
    const int b = bin_of(X, Y);
    const int bx = b % nbx, by = b / nbx;
    for (int dby = -1; dby <= 1 && need_tri && !ok[t]; ++dby) {
      for (int dbx = -1; dbx <= 1 && !ok[t]; ++dbx) {
        const int nbx_i = bx + dbx, nby_i = by + dby;
        if (nbx_i < 0 || nbx_i >= nbx || nby_i < 0 || nby_i >= nby) continue;
        const int bb = nby_i * nbx + nbx_i;
        for (int32_t k = counts[bb]; k < counts[bb + 1] && !ok[t]; ++k) {
          const int32_t q = items[k];
          const int qy = q / nquad_x, qx = q % nquad_x;
          const int64_t p00 = int64_t(qy) * nx + qx;
          const int64_t p01 = p00 + 1, p10 = p00 + nx, p11 = p10 + 1;
          // two triangles: (p00, p10, p11) and (p00, p11, p01)
          const int64_t tris[2][3] = {{p00, p10, p11}, {p00, p11, p01}};
          for (int tr = 0; tr < 2; ++tr) {
            const double x1 = lon[tris[tr][0]], y1 = lat[tris[tr][0]];
            const double x2 = lon[tris[tr][1]], y2 = lat[tris[tr][1]];
            const double x3 = lon[tris[tr][2]], y3 = lat[tris[tr][2]];
            const double det = (y2 - y3) * (x1 - x3) + (x3 - x2) * (y1 - y3);
            if (std::fabs(det) < 1e-300) continue;  // degenerate
            const double l1 = ((y2 - y3) * (X - x3) + (x3 - x2) * (Y - y3)) / det;
            const double l2 = ((y3 - y1) * (X - x3) + (x1 - x3) * (Y - y3)) / det;
            const double l3 = 1.0 - l1 - l2;
            if (l1 >= -eps && l2 >= -eps && l3 >= -eps) {
              idx[3 * t] = int32_t(tris[tr][0]);
              idx[3 * t + 1] = int32_t(tris[tr][1]);
              idx[3 * t + 2] = int32_t(tris[tr][2]);
              w[3 * t] = l1; w[3 * t + 1] = l2; w[3 * t + 2] = l3;
              ok[t] = 1;
              break;
            }
          }
        }
      }
    }
    // nearest-pixel search: expanding ring scan over the pixel hash.
    // Ties go to the lowest flat pixel id, matching scipy cKDTree.query
    // (within-bin items are id-sorted; across bins the d2 < best /
    // d2 == best && id < best_id comparison settles it).
    double best = 1e300;
    int64_t best_id = 0;
    const double cell_w = 1.0 / h.inv_cx, cell_h = 1.0 / h.inv_cy;
    const double min_pitch = std::min(cell_w, cell_h);
    const double cut2 = max_dist < 1e150 ? max_dist * max_dist : 1e300;
    const int max_ring = nbx + nby;
    bool settled = false;  // dist_mode 1: found any pixel within cutoff
    for (int ring = 0; ring <= max_ring && !settled; ++ring) {
      // every bin in ring r (Chebyshev shell) is at least (r-1)*min_pitch
      // away from the target; once that exceeds the best distance found
      // (or the caller's cutoff), no useful ring remains.
      const double bound = std::min(std::sqrt(best), max_dist);
      if (double(ring - 1) * min_pitch > bound) break;
      const int bx0 = bx - ring, bx1 = bx + ring, by0 = by - ring, by1 = by + ring;
      for (int iby = by0; iby <= by1 && !settled; ++iby) {
        if (iby < 0 || iby >= nby) continue;
        for (int ibx = bx0; ibx <= bx1 && !settled; ++ibx) {
          if (ibx < 0 || ibx >= nbx) continue;
          // ring shell only
          if (ring > 0 && ibx != bx0 && ibx != bx1 && iby != by0 && iby != by1) continue;
          const int bb = iby * nbx + ibx;
          for (int32_t k = pix_start[bb]; k < pix_start[bb + 1]; ++k) {
            const int32_t p = pix_items[k];
            const double dx = lon[p] - X, dy = lat[p] - Y;
            const double d2 = dx * dx + dy * dy;
            if (d2 < best || (d2 == best && p < best_id)) {
              best = d2;
              best_id = p;
              if (dist_mode == 1 && d2 <= cut2) { settled = true; break; }
            }
          }
        }
      }
    }
    dist[t] = std::sqrt(best);
    nn[t] = int32_t(best_id);
  }
  return 0;
}

}  // extern "C"
