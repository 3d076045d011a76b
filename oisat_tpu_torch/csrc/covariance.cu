// Dense distance-decay background-error covariance B for the full-covariance
// OI, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel oisat_tpu/ops/kernels/covariance.py::_cov_kernel
// (launched by _build through build_covariance; its callers are oi_full_dense
// and oi_full_dense_scan in oisat_tpu/ops/oi_full.py).  For every pair of
// cells i, j < N it writes
//
//     hav    = sin^2((lat_i - lat_j)/2) + cos lat_i cos lat_j sin^2((lon_i - lon_j)/2)
//     B[i,j] = sigma_i sigma_j exp(-(2R)^2 clip(hav, 0, 1) / (2 L^2))
//
// (the chordal distance d^2 = (2R)^2 hav, so no asin), row-major float32,
// from latitude / longitude in radians and the background std sigma, all
// float32 (N,).  The caller passes c_d2 = float32(4 R^2) and
// two_l2 = float32(2 L^2), the constants the JAX kernel folds into float32.
//
// What bounds it on the H100: the N^2 x 4 bytes it writes.  At N = 6,144
// that is 151 MB, 45 us at 3.35 TB/s, against ~19 float32 operations per
// element (each sin and exp counted once): 37.7M x 19 / 67 TFLOP/s = 11 us.
// An accurate sinf is a few tens of instructions, though, so computing every
// element (~100 instructions each) was bound by instruction issue, at about
// a third of the byte bound.  B is symmetric, so this kernel computes each
// pair once, which halves that work and brings it to about half the byte
// bound (H100: 49% at N = 5,643, 51% at 6,144, 55% at 10,240).  Computing
// still sets the time at even N: with its stores removed the kernel takes
// as long, while the stores alone run at the rate of a plain fill.  At odd
// N the rows are misaligned, and the stores alone take as long as the
// kernel.  Each element's two sinf calls and its division each carry a
// range check and a slow-path branch; running their fast paths
// branch-free was ~5% faster, not enough to keep a copy of sinf's code.
//
// Design:
//  * Only the tiles on and above the diagonal are computed: T(T+1)/2 blocks
//    for T = ceil(N / 64), the linear block index mapped to (row tile,
//    column tile).  A block of 32 x 8 threads computes one 64 x 64 tile;
//    thread (tx, ty) computes columns tx and tx + 32 of rows ty, ty + 8, ...,
//    ty + 56 and stores each value at once, so a warp writes 128 contiguous
//    bytes of one row.  An off-diagonal block also puts every value into a
//    shared-memory tile padded to 65 columns, and after one barrier writes
//    the mirror tile from it, again a row at a time: the padding keeps both
//    the transposed reads and the writes free of bank conflicts.  A diagonal
//    block computes its whole tile and writes it once.
//  * The mirror is bitwise what the plain version computes for (j, i): the
//    differences lat_j - lat_i and 0.5 x (...) are exact negatives of those
//    for (i, j), sinf is odd (the smoke and the tests hold B bitwise
//    symmetric on the card), only the squares of the sines are used, and
//    cos_i cos_j and sigma_i sigma_j commute under IEEE multiplication.
//  * The tile's 64 rows and 64 columns (lat, lon, sigma and cos lat) are
//    staged in shared memory once per block; each cos lat is computed once
//    per block instead of once per element.
//  * Accurate sinf / expf, no fast math: far pairs reach exponent arguments
//    of ~900, where __expf loses relative accuracy.  Products and sums use
//    the _rn intrinsics so nvcc does not contract them into FMAs, and the
//    operations follow the JAX kernel's order, so the kernel rounds as the
//    plain PyTorch version does on the card, operation by operation.  The
//    angle-difference identity (per-row and per-column half-angle tables in
//    place of the per-element sinf) would change B's rounding, and with it
//    the float32 scan's knee, so it is not used.
//  * The ragged edge is masked: N need not be a multiple of the tile, and
//    nothing is padded (the TPU kernel required N % tile == 0 and the
//    caller padded to 128 lanes with sigma = 0 cells; both were TPU layout
//    constraints).  B stays an unpadded row-major (N, N) tensor, since eigh
//    and the scan's GEMMs read it as it is; its rows are not 16-byte aligned
//    at odd N, which rules out a TMA store.  There is no reduction, so the
//    result is bitwise repeatable.
//  * Not here: the matrix-free path's on-the-fly B V tiles (csrc/b_matmat.cu)
//    and the exact branch's float64 G (built in place in its N x N buffer).
//
// The same tile walk builds the dense scan's float64 whitened correlation
// (correlation_f64, the kernel symmetric_upper<Whitened>): for unit vectors
// u_i (N, 3) and s_i = sigma_b,i / sigma_o,i, all float64,
//
//     C[i,j] = (s_i s_j) exp(max(kappa (clip(u_i . u_j, -1, 1) - 1), -60))
//
// with kappa = (R / L)^2, so that kappa (u.u - 1) = -d^2 / (2 L^2) for the
// chordal distance d.  This is C = D^-1 B D^-1 of the float64 scan
// (oi_full_dense_scan_f64 in oisat_tpu_torch/ops/oi_full.py), in one pass
// and one N x N buffer; the plain version is the same formula as torch
// operations (covariance.correlation_plain).  It replaces the JAX scan's
// pallas_call of B at float32 on that path: at a monthly sigma_b/sigma_o of
// ~100 only a float64 C gives the reference's knee.  The dot product is
// x x' + y y' + z z' with two FMAs in that order, and the scaling s_i s_j
// is one product: both commute, so C is bitwise symmetric on the diagonal
// tiles too, which compute both halves.  C agrees with the plain version
// (a cuBLAS GEMM of K = 3, whose order is its own, and (G s_i) s_j) to a
// few ulps.  What bounds it on the H100: the N^2 x 8 bytes it writes, 255
// MB at N = 5,643, 76 us at 3.35 TB/s, against ~10 float64 operations
// (exp counted once) for each of the N^2 / 2 computed elements: 4.7 us at
// 34 TFLOP/s.  Shared memory: the 64 x 65 float64 mirror tile, 33 KB, and
// the staged cells, 4 KB.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                  // output tile edge
constexpr int kThreadsX = 32;              // blockDim.x
constexpr int kThreadsY = 8;               // blockDim.y
constexpr long long kMaxTiles = 65535;     // keeps T(T+1)/2 blocks within one int

// clip(a, 0, 1) that keeps NaN, as jnp.clip and torch.clamp do
__device__ __forceinline__ float clip01(float a) {
  return a < 0.f ? 0.f : (a > 1.f ? 1.f : a);
}

// B[i, j] of the float32 covariance, in the JAX kernel's order of operations
struct Covariance {
  using Value = float;
  struct Cell {
    float lat, lon, sig, cos;
  };
  const float* lat;
  const float* lon;
  const float* sigma;
  float c_d2, two_l2;

  __device__ __forceinline__ Cell stage(long long i, long long n) const {
    const bool in = i < n;
    const float la = in ? lat[i] : 0.f;
    return Cell{la, in ? lon[i] : 0.f, in ? sigma[i] : 0.f, cosf(la)};
  }

  __device__ __forceinline__ float operator()(const Cell& a, const Cell& b) const {
    const float sdlat = sinf(__fmul_rn(0.5f, __fsub_rn(a.lat, b.lat)));
    const float sdlon = sinf(__fmul_rn(0.5f, __fsub_rn(a.lon, b.lon)));
    // sdlat^2 + ((cos_i cos_j) sdlon) sdlon
    const float cross = __fmul_rn(__fmul_rn(__fmul_rn(a.cos, b.cos), sdlon), sdlon);
    const float hav = clip01(__fadd_rn(__fmul_rn(sdlat, sdlat), cross));
    const float decay = expf(__fdiv_rn(-__fmul_rn(c_d2, hav), two_l2));
    return __fmul_rn(__fmul_rn(a.sig, b.sig), decay);
  }
};

// C[i, j] of the float64 whitened correlation: the plain version's
// operations after the dot product (clip, - 1, x kappa, the -60 floor,
// exp), then x (s_i s_j), symmetric in i and j; each clip keeps NaN
struct Whitened {
  using Value = double;
  struct Cell {
    double x, y, z, s;
  };
  const double* u3;
  const double* s;
  double kappa;

  __device__ __forceinline__ Cell stage(long long i, long long n) const {
    if (i >= n) return Cell{0.0, 0.0, 0.0, 0.0};
    return Cell{u3[3 * i], u3[3 * i + 1], u3[3 * i + 2], s[i]};
  }

  __device__ __forceinline__ double operator()(const Cell& a, const Cell& b) const {
    double g = __fma_rn(a.z, b.z, __fma_rn(a.y, b.y, __dmul_rn(a.x, b.x)));
    g = g < -1.0 ? -1.0 : (g > 1.0 ? 1.0 : g);
    double e = __dmul_rn(__dsub_rn(g, 1.0), kappa);
    e = e < -60.0 ? -60.0 : e;
    return __dmul_rn(__dmul_rn(a.s, b.s), exp(e));
  }
};

// One 64 x 64 tile on or above the diagonal of the symmetric (n, n) matrix
// op(cell i, cell j), and its mirror below.
template <class Op>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
symmetric_upper(const Op op, long long n, typename Op::Value* __restrict__ out) {
  using Cell = typename Op::Cell;
  using Value = typename Op::Value;
  __shared__ Cell rows[kTile], cols[kTile];
  __shared__ Value mirror[kTile][kTile + 1];

  // block b -> (bi, bj), bi <= bj: b = bj (bj + 1) / 2 + bi
  const long long b = blockIdx.x;
  long long bj = static_cast<long long>((sqrt(8.0 * static_cast<double>(b) + 1.0) - 1.0) * 0.5);
  while (bj * (bj + 1) / 2 > b) --bj;
  while ((bj + 1) * (bj + 2) / 2 <= b) ++bj;
  const long long bi = b - bj * (bj + 1) / 2;
  const bool diagonal = bi == bj;
  const long long row0 = bi * kTile;
  const long long col0 = bj * kTile;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int t = ty * kThreadsX + tx;
  if (t < kTile) {
    rows[t] = op.stage(row0 + t, n);
  } else if (t < 2 * kTile) {
    cols[t - kTile] = op.stage(col0 + t - kTile, n);
  }
  __syncthreads();

  // rows ty, ty + 8, ... of the tile: each value stored at once, and into
  // the shared mirror tile unless the tile is on the diagonal
  const Cell c0 = cols[tx];
  const Cell c1 = cols[tx + kThreadsX];
  const long long j0 = col0 + tx;
  const long long j1 = j0 + kThreadsX;
#pragma unroll 2
  for (int r = ty; r < kTile; r += kThreadsY) {
    const Cell a = rows[r];
    const long long i = row0 + r;
    const Value v0 = op(a, c0);
    const Value v1 = op(a, c1);
    if (i < n) {
      if (j0 < n) out[i * n + j0] = v0;
      if (j1 < n) out[i * n + j1] = v1;
    }
    if (!diagonal) {
      mirror[r][tx] = v0;
      mirror[r][tx + kThreadsX] = v1;
    }
  }
  if (diagonal) return;
  __syncthreads();

  // the mirror tile: row col0 + r takes column r of the computed tile
  const long long i0 = row0 + tx;
  const long long i1 = i0 + kThreadsX;
  for (int r = ty; r < kTile; r += kThreadsY) {
    const long long j = col0 + r;
    if (j >= n) break;
    if (i0 < n) out[j * n + i0] = mirror[tx][r];
    if (i1 < n) out[j * n + i1] = mirror[tx + kThreadsX][r];
  }
}

template <class Op>
int launch(const Op& op, long long n, void* out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > kMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles * (tiles + 1) / 2));
  const dim3 block(kThreadsX, kThreadsY);
  symmetric_upper<Op><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      op, n, static_cast<typename Op::Value*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// lat, lon (radians), sigma: (n,) float32; out: (n, n) float32, row-major.
// All device pointers; stream is a cudaStream_t.  Returns the launch's
// cudaError_t (0 on success; n == 0 launches nothing).
int covariance_f32(const void* lat, const void* lon, const void* sigma,
                   long long n, float c_d2, float two_l2, void* out,
                   void* stream) {
  const Covariance op{static_cast<const float*>(lat), static_cast<const float*>(lon),
                      static_cast<const float*>(sigma), c_d2, two_l2};
  return launch(op, n, out, stream);
}

// u3: (n, 3) float64 unit vectors, row-major; s: (n,) float64; out: (n, n)
// float64, row-major.  Device pointers and a cudaStream_t as above.
int correlation_f64(const void* u3, const void* s, long long n, double kappa,
                    void* out, void* stream) {
  const Whitened op{static_cast<const double*>(u3), static_cast<const double*>(s), kappa};
  return launch(op, n, out, stream);
}

// Largest n one launch takes (T(T+1)/2 blocks must fit the grid).
long long covariance_max_n() { return kMaxTiles * kTile; }

const char* covariance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
