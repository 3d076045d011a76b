// The matrix-free B.V sweep of the full-covariance OI, for Hopper (sm_90a).
//
// Replaces oisat_tpu/ops/oi_full.py::_b_matmat, which is not a Pallas kernel:
// the JAX package leaves it to XLA as one jitted computation (a lax.map
// over row blocks, each generating the (chunks, block, block) kernel tile
// and contracting it with a chunk-leading batched dot).  Its torch twin,
// b_matmat_plain in ops/kernels/b_matmat.py, does the same with ~8
// elementwise passes over each tile in device memory and a bmm.  For unit
// vectors u3 (n, 3), dv = sigma_b[:, None] * v (n, k) and a range [c0, c1)
// of block-wide column chunks it writes, row-major float32,
//
//     P = sum over c in [c0, c1), in chunk order, of C[:, chunk c] @ dv[chunk c]
//     C_ij = exp(-0.5 kappa |u_i - u_j|^2)
//
// The caller multiplies by sigma_b afterwards and adds the mesh positions'
// partials.
//
// Numerics (the plain version's, element by element):
//  * C_ij = expf(((dx^2 + dy^2) + dz^2) * nhk) with dx = x_i - x_j ...,
//    nhk = float32(-0.5 kappa): the explicit differences, not the Gram form
//    (oi_full.py's _b_matmat docstring: at kappa ~ 450 the Gram form's
//    absolute error makes B indefinite).  The _rn intrinsics keep nvcc from
//    contracting a product and a sum into an FMA, and the library is built
//    without fast math, so each C_ij rounds as torch's ops do on the card.
//  * Each chunk's partial is accumulated in float32 over at most block
//    terms (in runs of at most 128 columns, each summed on its own before
//    it joins the chunk's sum), and the partials are added in chunk order,
//    as the plain version's bmm over chunks and sum: one running sum over
//    all n would raise CG's residual floor (the JAX docstring measured
//    9.1e-7 -> 3.4e-5).  No atomics: every output element is added in one fixed
//    order, so a sweep repeats bitwise.
//
// What bounds it on the H100: operations.  10 n^2 elementwise operations
// for C (3 sub, 3 mul, 2 add, 1 scale, 1 exp; the exp on the SFU) and
// 2 n^2 k for the contraction, over 67 TFLOP/s float32: 0.62 + 0.12 k ms at
// n = 64,512.  The bytes (u3, sigma_b, v, the output: a few MB) are far
// below.  The plain version is bound instead by the (n / block, block,
// block) tiles it writes and reads back ~8 times per row block; this kernel
// keeps C out of device memory: every element is built once per sweep in
// registers and used where it was built.
//
// Design, one block per tile of rows walking all of its column chunks in
// order (two launch shapes of one sweep, picked by k):
//  * k <= 32 (the PCG's k = 1, SLQ and Lanczos at 16, the small probe
//    widths): sweep_narrow<KT>, KT the next power of two >= k (columns past
//    k read as 0).  128 threads, 32 rows: a warp's lanes are the 32 rows,
//    and warp w takes every 4th column of each chunk from the w-th, so a
//    warp reads one column of u3 and dv at a time (a broadcast from shared
//    memory: with 4 columns per warp the 128-bit reads of dv bound the
//    kernel at K >= 8).  Each 128-column slab of u3 and dv is staged in
//    shared memory; a thread builds C_ij in registers and FMAs it into its
//    KT accumulators at once.  At the end of a chunk the 4 warps' partials
//    of a row meet in shared memory and are added in one fixed order, then
//    to the running total.
//  * k > 32 (SLQ with 64 probes, the wide probe chunks, the 2,048-wide
//    Nystrom sketch): sweep_wide<TM>, TM = 32 rows (16 at block 2,048).
//    256 threads build the TM x block tile of C for the chunk once into
//    shared memory (128 KB at TM x block = 32,768), then contract it
//    against dv 128 columns at a time, staging 128 x 128 slabs of dv in
//    shared memory (64 KB), each read into registers while the slab before
//    it is contracted.  A thread keeps TM / 8 rows x 4 columns of the
//    output: a warp's lanes are 8 rows x 4 column groups, so each 128-bit
//    read of C or dv serves a warp in one pass of the shared memory (the
//    C tile's rows padded by 4 floats), and the FMAs, not the reads, set
//    the pace.  The chunk's partial is added to the output in device
//    memory, where only this thread reads and writes it.  k must be a
//    multiple of 4 (the wrapper pads dv with zero columns).
//  * No tensor cores (TF32 would round C and dv; 3xTF32 and wgmma are later
//    work), no TMA: a right and simple kernel first.

#include <cuda_runtime.h>

namespace {

constexpr int kNarrowThreads = 128;
constexpr int kLanesPerRow = 4;                               // column slices (warps) of a row
constexpr int kNarrowRows = kNarrowThreads / kLanesPerRow;    // 32 rows a block
constexpr int kSlab = 128;                                    // staged columns; block % kSlab == 0
constexpr int kWideThreads = 256;
constexpr int kWideCols = 128;                                // dv columns per contraction pass
constexpr int kWideTile = 32768;                              // TM x block floats of C (128 KB)

// C_ij in the plain version's order of operations, never contracted
__device__ __forceinline__ float kernel_elem(float xi, float yi, float zi, float xj, float yj,
                                             float zj, float nhk) {
  const float dx = __fsub_rn(xi, xj);
  const float dy = __fsub_rn(yi, yj);
  const float dz = __fsub_rn(zi, zj);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return expf(__fmul_rn(d2, nhk));
}

template <int KT>
__global__ void __launch_bounds__(kNarrowThreads)
sweep_narrow(const float* __restrict__ u3, const float* __restrict__ dv, long long n, int k,
             int block, long long c0, long long c1, float nhk, float* __restrict__ out) {
  // the partials' rows padded to KT + 1 floats, so that the 32 rows a warp
  // writes at once fall in distinct banks
  constexpr int kStride = KT;
  constexpr int kRed = KT + 1;
  __shared__ float4 us[kSlab];
  __shared__ __align__(16) float ds[kSlab * kStride];
  __shared__ float red[kLanesPerRow * kNarrowRows * kRed];

  const int t = threadIdx.x;
  const int row = t % kNarrowRows;   // a warp's 32 lanes are 32 rows ...
  const int s = t / kNarrowRows;     // ... and read one column at a time (a broadcast)
  const long long i = blockIdx.x * static_cast<long long>(kNarrowRows) + row;
  const float xi = u3[3 * i], yi = u3[3 * i + 1], zi = u3[3 * i + 2];

  float tot[KT];
#pragma unroll
  for (int q = 0; q < KT; ++q) tot[q] = 0.f;

  for (long long c = c0; c < c1; ++c) {
    float acc[KT];
#pragma unroll
    for (int q = 0; q < KT; ++q) acc[q] = 0.f;
    for (int slab = 0; slab < block; slab += kSlab) {
      const long long j0 = c * block + slab;
      __syncthreads();  // the previous slab and the partials are consumed
      if (t < kSlab) {
        const float* p = u3 + 3 * (j0 + t);
        us[t] = make_float4(p[0], p[1], p[2], 0.f);
      }
      for (int e = t; e < kSlab * KT; e += kNarrowThreads) {
        const int jj = e / KT, q = e % KT;
        ds[jj * kStride + q] = q < k ? dv[(j0 + jj) * k + q] : 0.f;
      }
      __syncthreads();
      // the warp's 32 columns of the slab summed on their own, then added
      // to the chunk's sum: shorter running sums than one over the chunk
      float sacc[KT];
#pragma unroll
      for (int q = 0; q < KT; ++q) sacc[q] = 0.f;
#pragma unroll 4
      for (int jj = s; jj < kSlab; jj += kLanesPerRow) {
        const float4 u = us[jj];
        const float cij = kernel_elem(xi, yi, zi, u.x, u.y, u.z, nhk);
        const float* d = ds + jj * kStride;
        if constexpr (KT < 4) {
#pragma unroll
          for (int q = 0; q < KT; ++q) sacc[q] = fmaf(cij, d[q], sacc[q]);
        } else {
#pragma unroll
          for (int q = 0; q < KT; q += 4) {
            const float4 d4 = *reinterpret_cast<const float4*>(d + q);
            sacc[q] = fmaf(cij, d4.x, sacc[q]);
            sacc[q + 1] = fmaf(cij, d4.y, sacc[q + 1]);
            sacc[q + 2] = fmaf(cij, d4.z, sacc[q + 2]);
            sacc[q + 3] = fmaf(cij, d4.w, sacc[q + 3]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < KT; ++q) acc[q] = __fadd_rn(acc[q], sacc[q]);
    }
    // the chunk's partial: the 4 warps' sums of the row added as
    // (w0 + w1) + (w2 + w3) by each of the 4 threads of the row (all hold
    // the same bits), then added to the total
#pragma unroll
    for (int q = 0; q < KT; ++q) red[(s * kNarrowRows + row) * kRed + q] = acc[q];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < KT; ++q) {
      const float* r = red + row * kRed + q;
      constexpr int w = kNarrowRows * kRed;  // one warp's partials
      const float part = __fadd_rn(__fadd_rn(r[0], r[w]), __fadd_rn(r[2 * w], r[3 * w]));
      tot[q] = __fadd_rn(tot[q], part);
    }
  }
#pragma unroll
  for (int q = 0; q < KT; ++q) {
    if (q % kLanesPerRow == s && q < k) out[i * k + q] = tot[q];
  }
}

constexpr int kQuads = kWideCols / 4;                      // float4s in a staged row of dv
constexpr int kSlabRowsPerPass = kWideThreads / kQuads;     // dv rows staged per pass
constexpr int kAhead = kSlab / kSlabRowsPerPass;            // float4s a thread stages

// rows j0 .. j0 + kSlab of dv, columns k0 .. k0 + kWideCols (0 past k), as
// this thread's share of the staged slab
__device__ __forceinline__ void load_slab(const float* __restrict__ dv, long long j0, int k,
                                          int k0, int t, float4 (&ahead)[kAhead]) {
  const int q = 4 * (t % kQuads);
#pragma unroll
  for (int m = 0; m < kAhead; ++m) {
    const long long j = j0 + t / kQuads + m * kSlabRowsPerPass;
    ahead[m] = k0 + q < k ? __ldg(reinterpret_cast<const float4*>(dv + j * k + k0 + q))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int TM>
__global__ void __launch_bounds__(kWideThreads)
sweep_wide(const float* __restrict__ u3, const float* __restrict__ dv, long long n, int k,
           int block, long long c0, long long c1, float nhk, float* __restrict__ out) {
  constexpr int kRowsPerThread = TM / 8;
  extern __shared__ __align__(16) float smem[];
  // TM x block: the chunk's tile of C, rows padded by 4 floats so that the
  // 8 rows a warp reads at once fall in distinct banks
  const int ldc = block + 4;
  float* cs = smem;
  float* ds = smem + TM * ldc;  // kSlab x kWideCols: a slab of dv
  __shared__ float4 rows[TM];

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  // a thread's outputs: rows g, g + 8, ... of the tile, 4 columns
  const int g = lane / 4;
  const int col = 16 * warp + 4 * (lane % 4);
  const long long r0 = blockIdx.x * static_cast<long long>(TM);
  if (t < TM) {
    const float* p = u3 + 3 * (r0 + t);
    rows[t] = make_float4(p[0], p[1], p[2], 0.f);
  }

  for (long long c = c0; c < c1; ++c) {
    const long long j0 = c * block;
    __syncthreads();  // rows staged / the previous chunk's tile consumed
    for (int jj = t; jj < block; jj += kWideThreads) {
      const float* p = u3 + 3 * (j0 + jj);
      const float xj = p[0], yj = p[1], zj = p[2];
#pragma unroll 4
      for (int r = 0; r < TM; ++r) {
        const float4 u = rows[r];
        cs[r * ldc + jj] = kernel_elem(u.x, u.y, u.z, xj, yj, zj, nhk);
      }
    }
    for (int k0 = 0; k0 < k; k0 += kWideCols) {
      const int q0 = k0 + col;
      const bool live = q0 < k;  // k % 4 == 0: a thread's 4 columns are all in or all out
      float4 acc[kRowsPerThread];
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
      // the slab of dv is read into registers one slab ahead, so that its
      // loads are in flight while the previous slab is contracted
      float4 ahead[kAhead];
      load_slab(dv, j0, k, k0, t, ahead);
      // each kSlab columns summed on their own, then added to the chunk's sum
      for (int slab = 0; slab < block; slab += kSlab) {
        __syncthreads();  // C built / the previous slab of dv consumed
#pragma unroll
        for (int m = 0; m < kAhead; ++m)
          *reinterpret_cast<float4*>(ds + (t / kQuads + m * kSlabRowsPerPass) * kWideCols +
                                     4 * (t % kQuads)) = ahead[m];
        __syncthreads();
        if (slab + kSlab < block) load_slab(dv, j0 + slab + kSlab, k, k0, t, ahead);
        if (!live) continue;
        float4 sacc[kRowsPerThread];
#pragma unroll
        for (int a = 0; a < kRowsPerThread; ++a) sacc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
        for (int jj = 0; jj < kSlab; jj += 4) {
          float4 d[4];
#pragma unroll
          for (int b = 0; b < 4; ++b)
            d[b] = *reinterpret_cast<const float4*>(ds + (jj + b) * kWideCols + col);
#pragma unroll
          for (int a = 0; a < kRowsPerThread; ++a) {
            const float4 cr =
                *reinterpret_cast<const float4*>(cs + (g + 8 * a) * ldc + slab + jj);
            const float cb[4] = {cr.x, cr.y, cr.z, cr.w};
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              sacc[a].x = fmaf(cb[b], d[b].x, sacc[a].x);
              sacc[a].y = fmaf(cb[b], d[b].y, sacc[a].y);
              sacc[a].z = fmaf(cb[b], d[b].z, sacc[a].z);
              sacc[a].w = fmaf(cb[b], d[b].w, sacc[a].w);
            }
          }
        }
#pragma unroll
        for (int a = 0; a < kRowsPerThread; ++a)
          acc[a] = make_float4(__fadd_rn(acc[a].x, sacc[a].x), __fadd_rn(acc[a].y, sacc[a].y),
                               __fadd_rn(acc[a].z, sacc[a].z), __fadd_rn(acc[a].w, sacc[a].w));
      }
      if (!live) continue;
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a) {
        float4* o = reinterpret_cast<float4*>(out + (r0 + g + 8 * a) * k + q0);
        if (c == c0) {
          *o = acc[a];
        } else {
          const float4 prev = *o;
          *o = make_float4(__fadd_rn(prev.x, acc[a].x), __fadd_rn(prev.y, acc[a].y),
                           __fadd_rn(prev.z, acc[a].z), __fadd_rn(prev.w, acc[a].w));
        }
      }
    }
  }
}

template <int KT>
cudaError_t launch_narrow(const float* u3, const float* dv, long long n, int k, int block,
                          long long c0, long long c1, float nhk, float* out,
                          cudaStream_t stream) {
  sweep_narrow<KT><<<static_cast<unsigned>(n / kNarrowRows), kNarrowThreads, 0, stream>>>(
      u3, dv, n, k, block, c0, c1, nhk, out);
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_wide(const float* u3, const float* dv, long long n, int k, int block,
                        long long c0, long long c1, float nhk, float* out,
                        cudaStream_t stream) {
  const int bytes = (TM * (block + 4) + kSlab * kWideCols) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(sweep_wide<TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  sweep_wide<TM><<<static_cast<unsigned>(n / TM), kWideThreads, bytes, stream>>>(
      u3, dv, n, k, block, c0, c1, nhk, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// u3: (n, 3), dv: (n, k), out: (n, k), all float32 row-major device
// pointers; stream a cudaStream_t.  n % block == 0, block % 128 == 0,
// block <= 2048, 0 <= c0 < c1 <= n / block; k > 32 needs k % 4 == 0.
// Returns the launch's cudaError_t (0 on success).
int b_matmat_f32(const void* u3, const void* dv, long long n, int k, int block, long long c0,
                 long long c1, float nhk, void* out, void* stream) {
  if (n <= 0 || k <= 0 || block <= 0 || block % kSlab || n % block || block > 2048 ||
      c0 < 0 || c1 <= c0 || c1 > n / block || (k > 32 && k % 4) ||
      n / kNarrowRows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* u = static_cast<const float*>(u3);
  const float* d = static_cast<const float*>(dv);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k == 1) err = launch_narrow<1>(u, d, n, k, block, c0, c1, nhk, o, st);
  else if (k == 2) err = launch_narrow<2>(u, d, n, k, block, c0, c1, nhk, o, st);
  else if (k <= 4) err = launch_narrow<4>(u, d, n, k, block, c0, c1, nhk, o, st);
  else if (k <= 8) err = launch_narrow<8>(u, d, n, k, block, c0, c1, nhk, o, st);
  else if (k <= 16) err = launch_narrow<16>(u, d, n, k, block, c0, c1, nhk, o, st);
  else if (k <= 32) err = launch_narrow<32>(u, d, n, k, block, c0, c1, nhk, o, st);
  else if (block * 32 <= kWideTile) err = launch_wide<32>(u, d, n, k, block, c0, c1, nhk, o, st);
  else err = launch_wide<16>(u, d, n, k, block, c0, c1, nhk, o, st);
  return static_cast<int>(err);
}

const char* b_matmat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
