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
// An accurate sinf is a few tens of instructions, though, so this first
// version is bound by instruction issue (~100 per element) at about a third
// of the byte bound on the H100; the speed work listed below attacks that.
//
// Design:
//  * One block of 32 x 8 threads writes one 32 x 32 output tile; thread
//    (tx, ty) writes column tx of rows ty, ty + 8, ty + 16, ty + 24, so a
//    warp stores 32 neighbouring floats of one row (128 coalesced bytes).
//  * The tile's 32 rows and 32 columns (lat, lon, sigma and cos lat) are
//    staged in shared memory once per block; each cos lat is computed once
//    per block instead of once per element.
//  * Accurate sinf / expf, no fast math: far pairs reach exponent arguments
//    of ~900, where __expf loses relative accuracy.  Products and sums use
//    the _rn intrinsics so nvcc does not contract them into FMAs, and the
//    operations follow the JAX kernel's order, so the kernel rounds as the
//    plain PyTorch version does on the card, operation by operation.
//  * The ragged edge is masked: N need not be a multiple of the tile, and
//    nothing is padded (the TPU kernel required N % tile == 0 and the
//    caller padded to 128 lanes with sigma = 0 cells; both were TPU layout
//    constraints).  There is no reduction, so the result is bitwise
//    repeatable.
//  * Not here: the matrix-free path's on-the-fly B V tiles (_b_matmat in
//    oisat_tpu/ops/oi_full.py) and the host LAPACK opt-out of the exact
//    tail; neither is ported yet, so this kernel only ever builds the dense
//    B of the dense branch.
//  * Later speed work, not done here: B is symmetric, so writing the upper
//    triangle and mirroring halves the sin/exp work; sin((a - b)/2) =
//    sin(a/2)cos(b/2) - cos(a/2)sin(b/2) from per-row and per-column
//    half-angle tables removes both per-element sinf calls.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                  // output tile edge
constexpr int kRowsStep = 8;               // blockDim.y
constexpr int kMaxGridY = 65535;           // gridDim.y limit

// clip(a, 0, 1) that keeps NaN, as jnp.clip and torch.clamp do
__device__ __forceinline__ float clip01(float a) {
  return a < 0.f ? 0.f : (a > 1.f ? 1.f : a);
}

__global__ void __launch_bounds__(kTile * kRowsStep)
covariance_tile(const float* __restrict__ lat, const float* __restrict__ lon,
                const float* __restrict__ sigma, long long n, float c_d2,
                float two_l2, float* __restrict__ out) {
  __shared__ float r_lat[kTile], r_lon[kTile], r_sig[kTile], r_cos[kTile];
  __shared__ float c_lat[kTile], c_lon[kTile], c_sig[kTile], c_cos[kTile];

  const long long row0 = static_cast<long long>(blockIdx.y) * kTile;
  const long long col0 = static_cast<long long>(blockIdx.x) * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int t = ty * kTile + tx;

  if (t < kTile) {  // warp 0 stages the tile's rows
    const long long i = row0 + t;
    const bool in = i < n;
    const float la = in ? lat[i] : 0.f;
    r_lat[t] = la;
    r_lon[t] = in ? lon[i] : 0.f;
    r_sig[t] = in ? sigma[i] : 0.f;
    r_cos[t] = cosf(la);
  } else if (t < 2 * kTile) {  // warp 1 stages its columns
    const int c = t - kTile;
    const long long j = col0 + c;
    const bool in = j < n;
    const float la = in ? lat[j] : 0.f;
    c_lat[c] = la;
    c_lon[c] = in ? lon[j] : 0.f;
    c_sig[c] = in ? sigma[j] : 0.f;
    c_cos[c] = cosf(la);
  }
  __syncthreads();

  const long long j = col0 + tx;
  if (j >= n) return;
  const float lat_j = c_lat[tx];
  const float lon_j = c_lon[tx];
  const float sig_j = c_sig[tx];
  const float cos_j = c_cos[tx];
#pragma unroll
  for (int k = 0; k < kTile / kRowsStep; ++k) {
    const int r = ty + k * kRowsStep;
    const long long i = row0 + r;
    if (i >= n) break;
    const float sdlat = sinf(__fmul_rn(0.5f, __fsub_rn(r_lat[r], lat_j)));
    const float sdlon = sinf(__fmul_rn(0.5f, __fsub_rn(r_lon[r], lon_j)));
    // sdlat^2 + ((cos_i cos_j) sdlon) sdlon, in the JAX kernel's order
    const float cross = __fmul_rn(__fmul_rn(__fmul_rn(r_cos[r], cos_j), sdlon), sdlon);
    const float hav = clip01(__fadd_rn(__fmul_rn(sdlat, sdlat), cross));
    const float decay = expf(__fdiv_rn(-__fmul_rn(c_d2, hav), two_l2));
    out[i * n + j] = __fmul_rn(__fmul_rn(r_sig[r], sig_j), decay);
  }
}

}  // namespace

extern "C" {

// lat, lon (radians), sigma: (n,) float32; out: (n, n) float32, row-major.
// All device pointers; stream is a cudaStream_t.  Returns the launch's
// cudaError_t (0 on success; n == 0 launches nothing).
int covariance_f32(const void* lat, const void* lon, const void* sigma,
                   long long n, float c_d2, float two_l2, void* out,
                   void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(tiles));
  const dim3 block(kTile, kRowsStep);
  covariance_tile<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lat), static_cast<const float*>(lon),
      static_cast<const float*>(sigma), n, c_d2, two_l2,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Largest n one launch takes (the grid's y extent).
long long covariance_max_n() { return static_cast<long long>(kMaxGridY) * kTile; }

const char* covariance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
