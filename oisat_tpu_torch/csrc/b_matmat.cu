// The matrix-free B.V sweep of the full-covariance OI, for Hopper (sm_90a).
//
// Replaces oisat_tpu/ops/oi_full.py::_b_matmat, which is not a Pallas kernel:
// the JAX package leaves it to XLA as one jitted computation (a lax.map
// over row blocks, each generating the (chunks, block, block) kernel tile
// and contracting it with a chunk-leading batched dot at HIGHEST
// precision).  Its torch twin, b_matmat_plain in ops/kernels/b_matmat.py,
// does the same with ~8 elementwise passes over each tile in device memory
// and a bmm.  For unit vectors u3 (n, 3), dv = sigma_b[:, None] * v (n, k)
// and a range [c0, c1) of block-wide column chunks it writes, row-major
// float32,
//
//     P = sum over c in [c0, c1), in chunk order, of C[:, chunk c] @ dv[chunk c]
//     C_ij = exp(-0.5 kappa |u_i - u_j|^2)
//
// The caller multiplies by sigma_b afterwards and adds the mesh positions'
// partials.
//
// Numerics, both shapes:
//  * C_ij = expf(((dx^2 + dy^2) + dz^2) * nhk) with dx = x_i - x_j ...,
//    nhk = float32(-0.5 kappa): the explicit differences, not the Gram form
//    (oi_full.py's _b_matmat docstring: at kappa ~ 450 the Gram form's
//    absolute error makes B indefinite).  The _rn intrinsics keep nvcc from
//    contracting a product and a sum into an FMA, and the library is built
//    without fast math, so each C_ij rounds as torch's ops do on the card.
//  * Each chunk's partial is accumulated in float32 in runs of at most 128
//    columns, each summed from zero before it joins the chunk's sum, and the
//    partials are added in chunk order, as the plain version's bmm over
//    chunks and sum: one running sum over all n would raise CG's residual
//    floor (the JAX docstring measured 9.1e-7 -> 3.4e-5).  No atomics:
//    every output element is added in one fixed order, so a sweep repeats
//    bitwise.
//
// Two launch shapes, picked by k:
//  * k <= 32 (the PCG's k = 1, SLQ and Lanczos at 16, the small probe
//    widths): sweep_narrow<KT>, KT the next power of two >= k (columns past
//    k read as 0).  Bound by the build of C: 10 n^2 operations (3 sub,
//    3 mul, 2 add, 1 scale, 1 exp) at 67 TFLOP/s, 0.62 ms at n = 64,512,
//    each element used at once for KT FMAs.  128 threads, 32 rows: a warp's
//    lanes are the 32 rows, and warp w takes every 4th column of each chunk
//    from the w-th, so a warp reads one column of u3 and dv at a time (a
//    broadcast from shared memory: with 4 columns per warp the 128-bit reads
//    of dv bound the kernel at K >= 8).  Each 128-column slab of u3 and dv
//    is staged in shared memory; a thread builds C_ij in registers and FMAs
//    it into its KT accumulators at once.  At the end of a chunk the 4
//    warps' partials of a row meet in shared memory and are added in one
//    fixed order, then to the running total.
//  * k > 32 (SLQ with 64 probes, the wide probe chunks, the 2,048-wide
//    Nystrom sketch): sweep_tc, the contraction on the tensor cores with
//    the six-product bf16 split, the TPU's HIGHEST precision rebuilt from
//    bf16 passes.  Each float32 x of C and of dv is split exactly into
//    three bf16 pieces (split3 below; its plain twin is split_bf16x3 in
//    ops/kernels/b_matmat.py): x0 = bf16_rn(x), x1 = bf16_rn(x - x0),
//    x2 = bf16_rn(x - x0 - x1), each difference exact in float32, so that
//    x0 + x1 + x2 == x.  The six products of weight >= 2^-16,
//    c0 d0 + (c2 d0 + c1 d0 + c1 d1 + c0 d1 + c0 d2), are each exact in the
//    tensor cores' float32 accumulation; c0 d0 goes to one accumulator and
//    the five smaller products to another, so the large sum takes one
//    accumulation a 16-column step and the small one cannot round it; each
//    run is hi + lo.  (One accumulator for all six came 1.1-5x further
//    from float64 than the plain engine on an H100: the tensor cores'
//    accumulation truncates, and each mma.sync adds to the large sum.)
//    With one-hot dv (d0 = 1, d1 = d2 = 0) a run is c0 + (c2 + c1) = C_ij
//    exactly: C is checked bitwise as in the narrow shape.  bf16's
//    smallest subnormal is 2^-133, so a float32 C below 2^-110 (subnormal
//    C: pairs ~4,000 km apart at L = 300 km) would lose bits in the split;
//    the kernel splits 2^24 C, whose pieces are all normal bf16, and
//    multiplies each run by 2^-24 before it is added in (exact: the
//    product of a float32 with a power of two).  dv is split
//    as it is: parts of it below 2^-133 are dropped.
//
// What bounds the wide shape on the H100: operations.  The build of C
// (10 n^2 at 67 TFLOP/s on the CUDA cores) and the float32-accurate
// contraction at the card's fastest float32-accurate rate, 6 x 2 n^2 k
// bf16 products at 989 TFLOP/s (the same as 3xTF32 at 495): 0.62 +
// 0.0505 k ms at n = 64,512, 104 ms at k = 2,048 (utils/roofline.py's
// b_matmat_bound counts the same work for both shapes).  The bytes (u3,
// sigma_b, v, the output) are far below.  The design, sweep_tc:
//  * a block is 8 warps over a 128-row x 128-column output tile; a warp
//    owns 16 rows x 128 columns (16 m16n8k16 tiles, two accumulators
//    each: 128 registers), so C is built once per 128 output columns and
//    never touches shared memory: a thread builds its 8 elements of the
//    warp's 16 x 16 A tile for each 16-column step straight into
//    mma.sync's A-fragment layout (rows g, g + 8; columns 2t, 2t + 1,
//    2t + 8, 2t + 9), scales, splits and packs them;
//  * the products go one after the other across all 16 n8 tiles, dv's
//    pieces one at a time (products<>), so that consecutive mma.sync on
//    one accumulator are 16 apart; a block whose 128 columns are all
//    live runs a copy of the loop without the per-tile test;
//  * dv's pieces come from a pre-pass (split_pieces) into the caller's
//    scratch, (3, rows of [c0, c1), k) bf16 row-major, and stream through
//    a three-deep cp.async ring in shared memory, 64 rows x 128 columns x
//    3 pieces a stage (rows padded to 272 bytes, so that ldmatrix.trans
//    reads the B fragments without bank conflicts), with u3's rows of the
//    stage; 128 rows a block read each staged row of dv 4x less often
//    than 32-row tiles would (0.4 TB from L2 at n = 64,512, k = 2,048);
//  * a run ends every 2 stages: hi + lo is unscaled and added to the
//    chunk's partial, which waits in shared memory (64 KB, each thread's
//    own slots); at a chunk's end the thread adds it to out in device
//    memory, which only it reads and writes; blocks of one column slab run
//    together, so the slab of dv they stream stays in L2.
//  k must be a multiple of 16 (the wrapper pads dv with zero columns);
//  column tiles past k are skipped.  On an H100 SXM at 700 W, mma.sync
//  peaks at ~635 TFLOP/s of bf16 (64% of the dense rate; 161 ms for the
//  products at n = 64,512, k = 2,048); in this design mma.sync alone (A
//  and B constant, no loads) took 220 ms, and loads, ldmatrix and the
//  build of C, which 8 warps an SM do not hide, take it to ~300 ms.
//  wgmma (asynchronous, so the build overlaps it), TMA and warp
//  specialisation are the way past it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kNarrowThreads = 128;
constexpr int kLanesPerRow = 4;                               // column slices (warps) of a row
constexpr int kNarrowRows = kNarrowThreads / kLanesPerRow;    // 32 rows a block
constexpr int kSlab = 128;                                    // staged columns; block % kSlab == 0


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

constexpr int kTcThreads = 256;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcRows = 16 * kTcWarps;                  // 128 output rows: one m16 tile a warp
constexpr int kTcCols = 128;                            // output columns of a block: 16 n8 tiles
constexpr int kTcTiles = kTcCols / 8;
constexpr int kTcGranule = 16;                          // k > 32: a multiple of it (n8 tile pairs)
constexpr int kTcStep = 64;                             // columns of C (rows of dv) a stage
constexpr int kTcStages = 3;                            // depth of the cp.async ring
constexpr int kTcRun = 128;                             // columns summed from zero
constexpr int kTcPitch = 2 * kTcCols + 16;              // bytes of a staged row of a piece
constexpr int kTcPieceBytes = kTcStep * kTcPitch;
constexpr int kTcStageBytes = 3 * kTcPieceBytes + kTcStep * 16;  // + u3 rows as float4
constexpr int kTcSmem = kTcStages * kTcStageBytes + kTcRows * kTcCols * 4;  // + chunk partials
constexpr float kCScale = 16777216.0f;                  // 2^24: C's pieces are normal bf16
constexpr float kCUnscale = 5.9604644775390625e-08f;    // 2^-24
static_assert(kTcRun % kTcStep == 0 && kSlab % kTcRun == 0, "a run never straddles a chunk");

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// the three bf16 pieces of a and b, packed as (a's piece, b's piece) in the
// low and high halves: x0 = bf16_rn(x), x1 = bf16_rn(x - x0),
// x2 = bf16_rn(x - x0 - x1); the differences are exact in float32
__device__ __forceinline__ void split3(float a, float b, uint32_t& p0, uint32_t& p1,
                                       uint32_t& p2) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(a, b);
  const float ra = __fsub_rn(a, __low2float(h0)), rb = __fsub_rn(b, __high2float(h0));
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(ra, rb);
  const float sa = __fsub_rn(ra, __low2float(h1)), sb = __fsub_rn(rb, __high2float(h1));
  p0 = bf16x2_bits(h0);
  p1 = bf16x2_bits(h1);
  p2 = bf16x2_bits(__floats2bfloat162_rn(sa, sb));
}

// dv's pieces: count elements (count % 4 == 0) into three planes of count
__global__ void split_pieces(const float* __restrict__ dv, long long count,
                             __nv_bfloat16* __restrict__ pieces) {
  const long long stride = 4LL * gridDim.x * blockDim.x;
  for (long long e = 4LL * (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x);
       e < count; e += stride) {
    const float4 x = *reinterpret_cast<const float4*>(dv + e);
    uint2 p0, p1, p2;
    split3(x.x, x.y, p0.x, p1.x, p2.x);
    split3(x.z, x.w, p0.y, p1.y, p2.y);
    *reinterpret_cast<uint2*>(pieces + e) = p0;
    *reinterpret_cast<uint2*>(pieces + count + e) = p1;
    *reinterpret_cast<uint2*>(pieces + 2 * count + e) = p2;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// four 8 x 8 bf16 matrices, transposed: B fragments of two n8 tiles
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a thread's share of every stage: rows t / 16 + 16 q (q < 4) of the three
// pieces at its 16-byte segment t % 16, and (t < 3 kTcStep) one float of
// u3's rows of the stage
struct StageCopy {
  const __nv_bfloat16* src;  // its first row of the split range's first stage
  const float* u3;           // its float of u3 in the first stage
  long long plane;           // elements of one piece
  int rows16;                // elements of 16 rows of a piece
  uint32_t dst, dst_u3;      // their places in ring buffer 0
  bool live;                 // its segment holds columns below k
};

__device__ __forceinline__ void load_stage(const StageCopy& c, int step, int buf, int k,
                                           int t) {
  const uint32_t dst = c.dst + buf * kTcStageBytes;
  if (c.live) {
    const __nv_bfloat16* src = c.src + static_cast<long long>(step) * kTcStep * k;
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < kTcStep / 16; ++q)
        cp_async16(dst + p * kTcPieceBytes + q * 16 * kTcPitch, src + p * c.plane + q * c.rows16);
  }
  if (t < 3 * kTcStep) cp_async4(c.dst_u3 + buf * kTcStageBytes, c.u3 + 3 * kTcStep * step);
}

// B fragments of one of dv's pieces for the live n8 tiles (kFull: all 16;
// else the first pairs pairs)
template <bool kFull>
__device__ __forceinline__ void load_b(uint32_t (&b)[kTcTiles / 2][4], const unsigned char* bs,
                                       int pairs) {
#pragma unroll
  for (int h = 0; h < kTcTiles / 2; ++h)
    if (kFull || h < pairs) ldmatrix_x4_trans(smem_addr(bs + 32 * h), b[h]);
}

// acc[x] += a * b[x] for every live n8 tile x
template <bool kFull>
__device__ __forceinline__ void across(float (&acc)[kTcTiles][4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[kTcTiles / 2][4], int pairs) {
#pragma unroll
  for (int x = 0; x < kTcTiles; ++x)
    if (kFull || x / 2 < pairs)
      mma_bf16(acc[x], a, b[x / 2][2 * (x % 2)], b[x / 2][2 * (x % 2) + 1]);
}

// the 16-column step's products, dv's pieces one at a time across the
// live tiles: hi += c0 d0, then lo += c2 d0, c1 d0, c1 d1, c0 d1, c0 d2,
// every tile in that order, so that consecutive mma.sync on one
// accumulator are a row of tiles apart
template <bool kFull>
__device__ __forceinline__ void products(float (&hi)[kTcTiles][4], float (&lo)[kTcTiles][4],
                                         const uint32_t (&a)[3][4], const unsigned char* bs,
                                         int pairs) {
  uint32_t b[kTcTiles / 2][4];
  load_b<kFull>(b, bs, pairs);
  across<kFull>(hi, a[0], b, pairs);
  across<kFull>(lo, a[2], b, pairs);
  across<kFull>(lo, a[1], b, pairs);
  load_b<kFull>(b, bs + kTcPieceBytes, pairs);
  across<kFull>(lo, a[1], b, pairs);
  across<kFull>(lo, a[0], b, pairs);
  load_b<kFull>(b, bs + 2 * kTcPieceBytes, pairs);
  across<kFull>(lo, a[0], b, pairs);
}

// one block's 128 x 128 output tile; kFull: every n8 tile of it is live
template <bool kFull>
__device__ __forceinline__ void sweep_tile(const float* __restrict__ u3,
                                           const __nv_bfloat16* __restrict__ pieces, int k,
                                           int block, long long c0, long long c1, float nhk,
                                           float* __restrict__ out, unsigned char* smem,
                                           int live) {
  float4* parts = reinterpret_cast<float4*>(smem + kTcStages * kTcStageBytes);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  // this thread's rows of A and of the output: i and i + 8
  const long long i = blockIdx.x * static_cast<long long>(kTcRows) + 16 * warp + g;
  const float xa = u3[3 * i], ya = u3[3 * i + 1], za = u3[3 * i + 2];
  const float xb = u3[3 * i + 24], yb = u3[3 * i + 25], zb = u3[3 * i + 26];
  const int q0 = blockIdx.y * kTcCols;
  const int pairs = live / 16;  // live n8 tile pairs
  const long long jbeg = c0 * block;
  const long long plane = (c1 - c0) * block * k;
  const int steps = static_cast<int>((c1 - c0) * block / kTcStep);
  const int run_steps = kTcRun / kTcStep, chunk_steps = block / kTcStep;
  // ldmatrix: lane L gives row L % 8 of matrix L / 8 (k rows 0-7 / 8-15 of
  // the step's n8 tile, then of the next tile)
  const int ld_off = ((lane >> 3 & 1) * 8 + (lane & 7)) * kTcPitch + (lane >> 4) * 16;

  float hi[kTcTiles][4], lo[kTcTiles][4];
#pragma unroll
  for (int nt = 0; nt < kTcTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) hi[nt][e] = lo[nt][e] = 0.f;

  const uint32_t sbase = smem_addr(smem);
  const StageCopy copy{pieces + static_cast<long long>(t / 16) * k + q0 + 8 * (t % 16),
                       u3 + 3 * jbeg + t, plane, 16 * k,
                       sbase + (t / 16) * kTcPitch + 16 * (t % 16),
                       sbase + 3 * kTcPieceBytes + 16 * (t / 3) + 4 * (t % 3),
                       8 * (t % 16) < live};
  load_stage(copy, 0, 0, k, t);
  cp_async_commit();
  if (steps > 1) load_stage(copy, 1, 1, k, t);
  cp_async_commit();

  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all_but_one();
    __syncthreads();  // stage s has landed; stage s - 1 is consumed
    if (s + 2 < steps) load_stage(copy, s + 2, (s + 2) % kTcStages, k, t);
    cp_async_commit();
    const unsigned char* st = smem + s % kTcStages * kTcStageBytes;
    const float4* us = reinterpret_cast<const float4*>(st + 3 * kTcPieceBytes);
#pragma unroll
    for (int ks = 0; ks < kTcStep / 16; ++ks) {
      // A: C of rows i, i + 8 against columns 2t, 2t + 1, 2t + 8, 2t + 9
      // of the 16-column step, scaled by 2^24 and split
      uint32_t a[3][4];
      {
        const int j = 16 * ks + 2 * tq;
        const float4 u0 = us[j], u1 = us[j + 1], u8 = us[j + 8], u9 = us[j + 9];
        float c[8];
        c[0] = __fmul_rn(kernel_elem(xa, ya, za, u0.x, u0.y, u0.z, nhk), kCScale);
        c[1] = __fmul_rn(kernel_elem(xa, ya, za, u1.x, u1.y, u1.z, nhk), kCScale);
        c[2] = __fmul_rn(kernel_elem(xa, ya, za, u8.x, u8.y, u8.z, nhk), kCScale);
        c[3] = __fmul_rn(kernel_elem(xa, ya, za, u9.x, u9.y, u9.z, nhk), kCScale);
        c[4] = __fmul_rn(kernel_elem(xb, yb, zb, u0.x, u0.y, u0.z, nhk), kCScale);
        c[5] = __fmul_rn(kernel_elem(xb, yb, zb, u1.x, u1.y, u1.z, nhk), kCScale);
        c[6] = __fmul_rn(kernel_elem(xb, yb, zb, u8.x, u8.y, u8.z, nhk), kCScale);
        c[7] = __fmul_rn(kernel_elem(xb, yb, zb, u9.x, u9.y, u9.z, nhk), kCScale);
        split3(c[0], c[1], a[0][0], a[1][0], a[2][0]);  // row i, columns 2t, 2t + 1
        split3(c[4], c[5], a[0][1], a[1][1], a[2][1]);  // row i + 8
        split3(c[2], c[3], a[0][2], a[1][2], a[2][2]);  // row i, columns 2t + 8, 2t + 9
        split3(c[6], c[7], a[0][3], a[1][3], a[2][3]);  // row i + 8
      }
      products<kFull>(hi, lo, a, st + 16 * ks * kTcPitch + ld_off, pairs);
    }
    if ((s + 1) % run_steps) continue;
    // a run ends: hi + lo, unscaled, joins the chunk's partial; at the
    // chunk's end the partial joins out, in chunk order
    const bool first = (s + 1 - run_steps) % chunk_steps == 0;
    const bool last = (s + 1) % chunk_steps == 0;
    const bool first_chunk = s < chunk_steps;
#pragma unroll
    for (int nt = 0; nt < kTcTiles; ++nt) {
      if (!kFull && nt / 2 >= pairs) continue;
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r[e] = __fmul_rn(__fadd_rn(hi[nt][e], lo[nt][e]), kCUnscale);
        hi[nt][e] = lo[nt][e] = 0.f;
      }
      float4* slot = parts + (warp * kTcTiles + nt) * 32 + lane;
      if (!first) {
        const float4 p = *slot;
        r[0] = __fadd_rn(p.x, r[0]);
        r[1] = __fadd_rn(p.y, r[1]);
        r[2] = __fadd_rn(p.z, r[2]);
        r[3] = __fadd_rn(p.w, r[3]);
      }
      if (!last) {
        *slot = make_float4(r[0], r[1], r[2], r[3]);
        continue;
      }
      // d0, d1: row i, columns 2t, 2t + 1 of the tile; d2, d3: row i + 8
      float2* o0 = reinterpret_cast<float2*>(out + i * k + q0 + 8 * nt + 2 * tq);
      float2* o1 = reinterpret_cast<float2*>(out + (i + 8) * k + q0 + 8 * nt + 2 * tq);
      if (first_chunk) {
        *o0 = make_float2(r[0], r[1]);
        *o1 = make_float2(r[2], r[3]);
      } else {
        const float2 p0 = *o0, p1 = *o1;
        *o0 = make_float2(__fadd_rn(p0.x, r[0]), __fadd_rn(p0.y, r[1]));
        *o1 = make_float2(__fadd_rn(p1.x, r[2]), __fadd_rn(p1.y, r[3]));
      }
    }
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
sweep_tc(const float* __restrict__ u3, const __nv_bfloat16* __restrict__ pieces, int k,
         int block, long long c0, long long c1, float nhk, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int live = min(kTcCols, k - static_cast<int>(blockIdx.y) * kTcCols);
  if (live == kTcCols)
    sweep_tile<true>(u3, pieces, k, block, c0, c1, nhk, out, smem, live);
  else
    sweep_tile<false>(u3, pieces, k, block, c0, c1, nhk, out, smem, live);
}

template <int KT>
cudaError_t launch_narrow(const float* u3, const float* dv, long long n, int k, int block,
                          long long c0, long long c1, float nhk, float* out,
                          cudaStream_t stream) {
  sweep_narrow<KT><<<static_cast<unsigned>(n / kNarrowRows), kNarrowThreads, 0, stream>>>(
      u3, dv, n, k, block, c0, c1, nhk, out);
  return cudaGetLastError();
}

cudaError_t launch_tc(const float* u3, const float* dv, long long n, int k, int block,
                      long long c0, long long c1, float nhk, float* out, cudaStream_t stream,
                      __nv_bfloat16* pieces) {
  const long long count = (c1 - c0) * block * k;
  const long long quads = count / 4;
  const unsigned split_blocks =
      static_cast<unsigned>(quads < 4096LL * 256 ? (quads + 255) / 256 : 4096);
  split_pieces<<<split_blocks, 256, 0, stream>>>(dv + c0 * block * k, count, pieces);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sweep_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n / kTcRows),
                  static_cast<unsigned>((k + kTcCols - 1) / kTcCols));
  sweep_tc<<<grid, kTcThreads, kTcSmem, stream>>>(u3, pieces, k, block, c0, c1, nhk, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// u3: (n, 3), dv: (n, k), out: (n, k), all float32 row-major device
// pointers; stream a cudaStream_t.  n % block == 0, block % 128 == 0,
// block <= 2048, 0 <= c0 < c1 <= n / block.  k > 32 needs k % 16 == 0 and
// scratch: device memory for 3 (c1 - c0) block k bf16 (dv's split pieces;
// unused, may be null, at k <= 32).  Returns the first failing launch's
// cudaError_t (0 on success).
int b_matmat_f32(const void* u3, const void* dv, long long n, int k, int block, long long c0,
                 long long c1, float nhk, void* out, void* stream, void* scratch) {
  if (n <= 0 || k <= 0 || block <= 0 || block % kSlab || n % block || block > 2048 ||
      c0 < 0 || c1 <= c0 || c1 > n / block || (k > 32 && (k % kTcGranule || !scratch)) ||
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
  else err = launch_tc(u, d, n, k, block, c0, c1, nhk, o, st,
                       static_cast<__nv_bfloat16*>(scratch));
  return static_cast<int>(err);
}

const char* b_matmat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
