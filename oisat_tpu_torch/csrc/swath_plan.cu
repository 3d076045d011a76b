// Structured-swath regrid plans built on the card, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package (and the port's CPU path) builds a
// swath's pixel -> grid SparsePlan on one host core, in
// csrc/swath_weights.cpp (build_structured_weights), and copies the plan to
// the device.  For an OMI orbit against the 0.25 deg fine grid that plan
// covers 1,037,519 targets, ~51 MB of idx / w / mask copied per orbit,
// though the swath reaches ~6% of them.  This library builds the same plan
// in device memory from the swath's coordinates alone, bitwise equal to
// plan_to_torch(build_plan_structured(...)):
//
//   method 1 (need_tri): idx (T, 3) int64, w (T, 3) float64, mask (T,) =
//     (dist > max_dist) | ~inside, the first swath triangle that holds the
//     target and its barycentric weights;
//   methods 2 / 4: idx (T, 1) = the nearest pixel, w = 1.0, mask = dist >
//     max_dist.
//
// What bounds it on the H100: the plan it writes, T x 49 bytes (51 MB at
// the OMI shape), plus what it reads: the targets' coordinates, T x 16
// bytes, the swath's and the hashes (~21 us at 3.35 TB/s in all).  Most targets lie outside the swath's box widened by the
// cutoff and only write their zeros; those near the swath walk a few bins.
//
// Design (the host builder's algorithm, step for step):
//  * The host keeps the O(pixels) pass that decides whether there is a plan
//    (swath_plan_bins, below): the non-finite reject, the swath's box and
//    bin grid (x0, y0, nbx, nby, 1 / pitch) in the C++'s double operations,
//    and the number of (quad, bin) entries the quad hash holds, so the
//    caller allocates every buffer and the launch never waits.  The bin and
//    quad-box helpers are the same code on both sides.
//  * Both hashes are CSR over the bins: count (atomics), one exclusive scan
//    per hash (one block each), fill (atomics), then each bin's ids sorted
//    ascending by one thread.  The C++ inserts ids in ascending order; the
//    per-target pass takes the first triangle that holds a target and the
//    ring scan breaks distance ties by the lowest id, so the order inside a
//    bin decides the plan on shared edges and must be the same.
//  * One thread per target runs the C++'s loop body in its order: the O(1)
//    box reject, the 3 x 3-bin point-in-triangle pass over the quad hash
//    ((p00, p10, p11) then (p00, p11, p01), the same eps), and the ring
//    scan over the pixel hash with its bound and need_tri.  With need_tri
//    the ring scan runs in the host builder's dist_mode 1, which the
//    linear mode always takes: dist is read only as the far mask, so the
//    scan stops at the first pixel within the cutoff.
//  * Rounding: every double operation of the barycentric weights, the
//    distances and the bins is an _rn intrinsic, so nvcc contracts nothing
//    into an FMA and each rounds as the host's g++ -O3 build does (SSE2, no
//    contraction).  A double -> int conversion follows x86's cvttsd2si
//    (INT_MIN outside int's range) and min / max follow std::min /
//    std::max, so even out-of-range bins clamp as on the host.
//  * Nothing is reduced across threads in floating point, so the plan is
//    the same on every run; the atomics only order ids that are sorted
//    afterwards.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;       // blockDim of the per-item kernels
constexpr int kScanThreads = 1024;  // blockDim of the scan
constexpr unsigned kFullMask = 0xffffffffu;

struct Bins {
  double x0, y0, inv_cx, inv_cy;
  int nbx, nby;
};

// One CSR hash over the bins.  start has nbins + 1 entries: bin b's counts
// are added at start[b + 1] and scanned in place; cursor[b] is the fill's
// next slot of bin b; items holds cap ids.
struct Csr {
  int* start;
  int* cursor;
  int* items;
  long long cap;
};

// The swath: (ny, nx) pixel centres, row-major.
struct Swath {
  const double* lon;
  const double* lat;
  int ny, nx;
};

__host__ __device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// double -> int as x86's cvttsd2si: truncation, INT_MIN outside int's range
// and for NaN (the host build's int(...) of an out-of-range value)
__host__ __device__ __forceinline__ int host_int(double v) {
  return (v > -2147483649.0 && v < 2147483648.0) ? static_cast<int>(v) : INT_MIN;
}

// std::min / std::max of two doubles
__host__ __device__ __forceinline__ double std_min(double a, double b) { return b < a ? b : a; }
__host__ __device__ __forceinline__ double std_max(double a, double b) { return a < b ? b : a; }

// a - b and a * b rounded alone: on the device never contracted into an FMA
__host__ __device__ __forceinline__ double sub_rn(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dsub_rn(a, b);
#else
  return a - b;
#endif
}

__host__ __device__ __forceinline__ double mul_rn(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}

__host__ __device__ __forceinline__ int bin_x(const Bins& g, double x) {
  return clampi(host_int(mul_rn(sub_rn(x, g.x0), g.inv_cx)), 0, g.nbx - 1);
}

__host__ __device__ __forceinline__ int bin_y(const Bins& g, double y) {
  return clampi(host_int(mul_rn(sub_rn(y, g.y0), g.inv_cy)), 0, g.nby - 1);
}

// The bins b = {bx0, bx1, by0, by1} that the bounding box of the quad with
// first pixel p00 overlaps, or false for a quad spanning more than 180 deg
// of longitude (an antimeridian crossing, which the host builder skips).
__host__ __device__ __forceinline__ bool quad_bins(const Swath& s, const Bins& g, long long p00,
                                                   int* b) {
  const long long p01 = p00 + 1, p10 = p00 + s.nx, p11 = p10 + 1;
  const double xlo = std_min(std_min(s.lon[p00], s.lon[p01]), std_min(s.lon[p10], s.lon[p11]));
  const double xhi = std_max(std_max(s.lon[p00], s.lon[p01]), std_max(s.lon[p10], s.lon[p11]));
  const double ylo = std_min(std_min(s.lat[p00], s.lat[p01]), std_min(s.lat[p10], s.lat[p11]));
  const double yhi = std_max(std_max(s.lat[p00], s.lat[p01]), std_max(s.lat[p10], s.lat[p11]));
  if (sub_rn(xhi, xlo) > 180.0) return false;
  b[0] = bin_x(g, xlo);
  b[1] = bin_x(g, xhi);
  b[2] = bin_y(g, ylo);
  b[3] = bin_y(g, yhi);
  return true;
}

// Adds id to bin b: a count (kFill false) or a slot of the fill.
template <bool kFill>
__device__ __forceinline__ void put(const Csr& c, int b, int id) {
  if (kFill) {
    const int pos = atomicAdd(&c.cursor[b], 1);
    if (pos < c.cap) c.items[pos] = id;
  } else {
    atomicAdd(&c.start[b + 1], 1);
  }
}

// Item i < npix is pixel i, registered in its bin; item i < nquads (when
// the quad hash is built) is quad i, registered in every bin its bounding
// box overlaps (quad_bins).
template <bool kFill>
__global__ void __launch_bounds__(kThreads)
hash_items(Swath s, Bins g, Csr pix, Csr quad, long long npix, long long nquads) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < npix) put<kFill>(pix, bin_y(g, s.lat[i]) * g.nbx + bin_x(g, s.lon[i]), static_cast<int>(i));
  if (i >= nquads) return;
  const int nqx = s.nx - 1;
  int b[4];
  if (!quad_bins(s, g, (i / nqx) * s.nx + i % nqx, b)) return;
  for (int by = b[2]; by <= b[3]; ++by)
    for (int bx = b[0]; bx <= b[1]; ++bx) put<kFill>(quad, by * g.nbx + bx, static_cast<int>(i));
}

// Block 0 scans the pixel hash's counts in place, block 1 the quad hash's,
// and each sets its cursors to the bins' starts.
__global__ void __launch_bounds__(kScanThreads) scan_starts(Csr pix, Csr quad, int nbins) {
  const Csr c = blockIdx.x == 0 ? pix : quad;
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int tile_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = nbins + 1;
  int carry = 0;
  for (int base = 0; base < n; base += kScanThreads) {
    const int i = base + threadIdx.x;
    int v = i < n ? c.start[i] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFullMask, v, o);
      if (lane >= o) v += t;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFullMask, w, o);
        if (lane >= o) w += t;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    v += carry + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (i < n) c.start[i] = v;
    if (i < nbins) c.cursor[i] = v;
    if (threadIdx.x == kScanThreads - 1) tile_total = v;
    __syncthreads();
    carry = tile_total;
    __syncthreads();
  }
}

// a[0, n) ascending: Shell sort on Ciura's gaps, insertion sort at the
// last; a bin holds a few ids, a degenerate swath's bins many.
__device__ void sort_ids(int* a, int n) {
  constexpr int kGaps[] = {44842, 19930, 8858, 3937, 1750, 701, 301, 132, 57, 23, 10, 4, 1};
  for (int gap : kGaps) {
    for (int i = gap; i < n; ++i) {
      const int v = a[i];
      int j = i;
      for (; j >= gap && a[j - gap] > v; j -= gap) a[j] = a[j - gap];
      a[j] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sort_bins(Csr pix, Csr quad, int nbins, int need_tri) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= nbins) return;
  sort_ids(pix.items + pix.start[b], pix.start[b + 1] - pix.start[b]);
  if (need_tri) sort_ids(quad.items + quad.start[b], quad.start[b + 1] - quad.start[b]);
}

// The targets: (x[t], y[t]).
struct Targets {
  const double* x;
  const double* y;
  long long nt;
};

struct Box {
  double xmin, xmax, ymin, ymax, max_dist;
};

// Barycentric weights of (X, Y) in the triangle of pixels a, b, c, as the
// C++ computes them; false where the triangle is degenerate or misses it.
__device__ __forceinline__ bool in_triangle(const Swath& s, long long a, long long b,
                                            long long c, double X, double Y, double* l) {
  constexpr double kEps = 1e-12;
  const double x1 = s.lon[a], y1 = s.lat[a];
  const double x2 = s.lon[b], y2 = s.lat[b];
  const double x3 = s.lon[c], y3 = s.lat[c];
  const double y23 = __dsub_rn(y2, y3), x32 = __dsub_rn(x3, x2);
  const double x13 = __dsub_rn(x1, x3), y13 = __dsub_rn(y1, y3);
  const double det = __dadd_rn(__dmul_rn(y23, x13), __dmul_rn(x32, y13));
  if (fabs(det) < 1e-300) return false;
  const double xx3 = __dsub_rn(X, x3), yy3 = __dsub_rn(Y, y3);
  const double l1 = __ddiv_rn(__dadd_rn(__dmul_rn(y23, xx3), __dmul_rn(x32, yy3)), det);
  const double l2 = __ddiv_rn(
      __dadd_rn(__dmul_rn(__dsub_rn(y3, y1), xx3), __dmul_rn(x13, yy3)), det);
  const double l3 = __dsub_rn(__dsub_rn(1.0, l1), l2);
  if (!(l1 >= -kEps && l2 >= -kEps && l3 >= -kEps)) return false;
  l[0] = l1;
  l[1] = l2;
  l[2] = l3;
  return true;
}

__global__ void __launch_bounds__(kThreads)
locate_targets(Swath s, Bins g, Csr pix, Csr quad, Targets tg, Box box, int need_tri,
               long long* __restrict__ idx, double* __restrict__ w, bool* __restrict__ mask) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= tg.nt) return;
  const double X = tg.x[t];
  const double Y = tg.y[t];
  const double md = box.max_dist;
  bool ok = false;
  long long tri[3] = {0, 0, 0};
  double l[3] = {0.0, 0.0, 0.0};
  double dist = 1e300;
  long long best_id = 0;
  // a non-finite target, or one farther than max_dist outside the swath's
  // box, keeps dist 1e300 and no triangle
  if (isfinite(X) && isfinite(Y) && !(X < __dsub_rn(box.xmin, md) || X > __dadd_rn(box.xmax, md) ||
                                      Y < __dsub_rn(box.ymin, md) || Y > __dadd_rn(box.ymax, md))) {
    const int bx = bin_x(g, X), by = bin_y(g, Y);
    const int nqx = s.nx - 1;
    for (int dby = -1; dby <= 1 && need_tri && !ok; ++dby) {
      for (int dbx = -1; dbx <= 1 && !ok; ++dbx) {
        const int ix = bx + dbx, iy = by + dby;
        if (ix < 0 || ix >= g.nbx || iy < 0 || iy >= g.nby) continue;
        const int bb = iy * g.nbx + ix;
        for (int k = quad.start[bb]; k < quad.start[bb + 1] && !ok; ++k) {
          const int q = quad.items[k];
          const long long p00 = static_cast<long long>(q / nqx) * s.nx + q % nqx;
          const long long p01 = p00 + 1, p10 = p00 + s.nx, p11 = p10 + 1;
          if (in_triangle(s, p00, p10, p11, X, Y, l)) {
            tri[0] = p00; tri[1] = p10; tri[2] = p11;
            ok = true;
          } else if (in_triangle(s, p00, p11, p01, X, Y, l)) {
            tri[0] = p00; tri[1] = p11; tri[2] = p01;
            ok = true;
          }
        }
      }
    }
    // nearest pixel: rings of bins around the target's, each bin's pixels
    // in ascending id, ties to the lowest id
    double best = 1e300;
    const double min_pitch = std_min(__ddiv_rn(1.0, g.inv_cx), __ddiv_rn(1.0, g.inv_cy));
    const double cut2 = md < 1e150 ? __dmul_rn(md, md) : 1e300;
    const int max_ring = g.nbx + g.nby;
    bool settled = false;  // need_tri: a pixel within the cutoff was found
    for (int ring = 0; ring <= max_ring && !settled; ++ring) {
      const double bound = std_min(__dsqrt_rn(best), md);
      if (__dmul_rn(static_cast<double>(ring - 1), min_pitch) > bound) break;
      const int bx0 = bx - ring, bx1 = bx + ring, by0 = by - ring, by1 = by + ring;
      for (int iby = by0; iby <= by1 && !settled; ++iby) {
        if (iby < 0 || iby >= g.nby) continue;
        // the shell only: a row strictly inside the ring has its two ends
        const int step = (ring > 0 && iby != by0 && iby != by1) ? bx1 - bx0 : 1;
        for (int ibx = bx0; ibx <= bx1 && !settled; ibx += step) {
          if (ibx < 0 || ibx >= g.nbx) continue;
          const int bb = iby * g.nbx + ibx;
          for (int k = pix.start[bb]; k < pix.start[bb + 1]; ++k) {
            const int p = pix.items[k];
            const double dx = __dsub_rn(s.lon[p], X), dy = __dsub_rn(s.lat[p], Y);
            const double d2 = __dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy));
            if (d2 < best || (d2 == best && p < best_id)) {
              best = d2;
              best_id = p;
              if (need_tri && d2 <= cut2) {
                settled = true;
                break;
              }
            }
          }
        }
      }
    }
    dist = __dsqrt_rn(best);
  }
  const bool far = dist > md;
  if (need_tri) {
    for (int k = 0; k < 3; ++k) {
      idx[3 * t + k] = tri[k];
      w[3 * t + k] = l[k];
    }
    mask[t] = far || !ok;
  } else {
    idx[t] = best_id;
    w[t] = 1.0;
    mask[t] = far;
  }
}

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Host: the bin grid of the (ny, nx) swath lon / lat (host pointers) as
// build_structured_weights computes it, box = {xmin, xmax, ymin, ymax,
// inv_cx, inv_cy} and nb = {nbx, nby}, and with need_tri the number of
// (quad, bin) entries of its quad hash.  Returns 2 for a non-finite
// coordinate, as the host builder does (no plan), else 0.
int swath_plan_bins(const double* lon, const double* lat, int ny, int nx, int need_tri,
                    double* box, int* nb, long long* quad_items) {
  const long long npix = static_cast<long long>(ny) * nx;
  const double nquads = static_cast<double>(static_cast<long long>(ny - 1) * (nx - 1));
  double xmin = 1e300, xmax = -1e300, ymin = 1e300, ymax = -1e300;
  for (long long i = 0; i < npix; ++i) {
    const double X = lon[i], Y = lat[i];
    if (!std::isfinite(X) || !std::isfinite(Y)) return 2;
    xmin = std_min(xmin, X);
    xmax = std_max(xmax, X);
    ymin = std_min(ymin, Y);
    ymax = std_max(ymax, Y);
  }
  const double span_x = std_max(xmax - xmin, 1e-12);
  const double span_y = std_max(ymax - ymin, 1e-12);
  const int nbx = clampi(host_int(std_min(std::sqrt(nquads * span_x / span_y), 4096.0)) + 1, 1,
                         4096);
  const int nby = clampi(host_int(std_min(nquads / nbx, 4096.0)) + 1, 1, 4096);
  const Bins g{xmin, ymin, nbx / span_x, nby / span_y, nbx, nby};
  long long entries = 0;
  if (need_tri) {
    const Swath s{lon, lat, ny, nx};
    int b[4];
    for (int qy = 0; qy < ny - 1; ++qy)
      for (int qx = 0; qx < nx - 1; ++qx)
        if (quad_bins(s, g, static_cast<long long>(qy) * nx + qx, b))
          entries += static_cast<long long>(b[1] - b[0] + 1) * (b[3] - b[2] + 1);
  }
  const double out[6] = {xmin, xmax, ymin, ymax, g.inv_cx, g.inv_cy};
  for (int k = 0; k < 6; ++k) box[k] = out[k];
  nb[0] = nbx;
  nb[1] = nby;
  *quad_items = entries;
  return 0;
}

// int32 words of the workspace for nbins bins, npix pixels and quad_items
// (quad, bin) entries: both hashes' starts, cursors and items.
long long swath_plan_workspace(int nbins, long long npix, long long quad_items) {
  return 4LL * nbins + 2 + npix + quad_items;
}

// Builds the plan of the (ny, nx) swath at coords = [lon (ny*nx), lat
// (ny*nx)] for the nt targets at targets = [x (nt), y (nt)]; outputs idx
// (nt, k) int64, w (nt, k) double and mask (nt,) bool, k = 3 with need_tri
// (method 1) and 1 without (methods 2 and 4).  box, nb and quad_items are swath_plan_bins's (host pointers);
// work holds swath_plan_workspace(...) int32 words.  The other pointers
// are device pointers; stream is a cudaStream_t.  Nothing is synchronised.
// Returns the launches' cudaError_t (0 on success).
int swath_plan_f64(const void* coords, int ny, int nx, const void* targets, long long nt,
                   const double* box, const int* nb, long long quad_items, double max_dist,
                   int need_tri, void* work, void* idx, void* w, void* mask, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long npix = static_cast<long long>(ny) * nx;
  const long long nquads = need_tri ? static_cast<long long>(ny - 1) * (nx - 1) : 0;
  const int nbins = nb[0] * nb[1];
  int* base = static_cast<int*>(work);
  Csr pix{base, base + 2 * (nbins + 1), base + 4 * nbins + 2, npix};
  Csr quad{base + nbins + 1, base + 3 * nbins + 2, base + 4 * nbins + 2 + npix, quad_items};
  const double* c = static_cast<const double*>(coords);
  const Swath s{c, c + npix, ny, nx};
  const Bins g{box[0], box[2], box[4], box[5], nb[0], nb[1]};

  cudaError_t err = cudaMemsetAsync(base, 0, sizeof(int) * 2 * (nbins + 1), st);
  if (err != cudaSuccess) return err;
  const long long nitems = npix > nquads ? npix : nquads;
  hash_items<false><<<blocks_for(nitems), kThreads, 0, st>>>(s, g, pix, quad, npix, nquads);
  scan_starts<<<need_tri ? 2 : 1, kScanThreads, 0, st>>>(pix, quad, nbins);
  hash_items<true><<<blocks_for(nitems), kThreads, 0, st>>>(s, g, pix, quad, npix, nquads);
  sort_bins<<<blocks_for(nbins), kThreads, 0, st>>>(pix, quad, nbins, need_tri);
  const double* t = static_cast<const double*>(targets);
  const Targets tg{t, t + nt, nt};
  const Box bx{box[0], box[1], box[2], box[3], max_dist};
  locate_targets<<<blocks_for(nt), kThreads, 0, st>>>(
      s, g, pix, quad, tg, bx, need_tri, static_cast<long long*>(idx),
      static_cast<double*>(w), static_cast<bool*>(mask));
  return cudaGetLastError();
}

const char* swath_plan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
