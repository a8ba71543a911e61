// K4: the TimeSformer trunk's linears, fp32, on the tensor cores: the
//     forward pass y = x Wᵀ + b, the input gradient dx = dy W and the weight
//     gradient dW = dyᵀ x, db = Σ_rows dy, of a row-major x [M][K] and a
//     weight W [N][K].
//
// Replaces no TPU kernel: the JAX package leaves its matrix products to XLA,
// and the port left the trunk's to cuBLAS. It was added because cuBLAS runs
// an fp32 product with TF32 off (the configuration's precision) on the CUDA
// cores: the trunk's linears there reach ~52 TFLOP/s, under the card's 67
// TFLOP/s fp32 FMA rate, and took ~660 of a ~930 ms train step.
//
// Arithmetic: three error-compensated TF32 products, as K1-K3. Each operand
// v is split into hi = tf32(v) and lo = tf32(v - hi) (cvt.rna), and a_lo*b_hi,
// a_hi*b_lo, a_hi*b_hi go in that order into fp32 accumulators (the dropped
// lo*lo term is ~2^-22 relative). Each 32-deep K tile's products go into a
// fresh accumulator, which the running sum takes with a plain fp32 add: the
// tensor cores align and truncate as they accumulate, an error that grows
// with the accumulator's magnitude (3e-5 of the largest entry at K = 4,608
// through one accumulator, against 6e-7 with fresh ones, as K3 measured). No
// one-product path exists.
//
// What bounds it on an H100: operations. The step's products are 0.14-0.87
// TFLOP a launch over 47,040 rows against 145-578 MB of operands; at 3xTF32
// the tensor cores give 165 TFLOP/s of fp32 work, so a launch is 0.9-5.3 ms
// of operations and 0.1-0.3 ms of bytes.
//
// What the design does about it:
//  - Forward and input gradient are one kernel, out[m][n] = Σ_k A[m][k]
//    B[n][k] (+ bias[n]), with both operands K-major, the only layout a TF32
//    wgmma reads from shared memory: A = x and B = W for the forward, A = dy
//    and B = Wᵀ for the input gradient. The weight is split once a call, by a
//    small kernel, into hi and lo arrays (transposed for the input
//    gradient); an activation is never copied: its tile is split in
//    registers.
//  - Warp-specialised and persistent: one block of 288 threads an SM walks
//    the 128 x 128 output tiles. A producer warp keeps a ring of four stages
//    full with TMA copies (the A tile and the weight's hi and lo tiles, 128
//    rows of 32 floats each, 128-byte swizzled, zero-filled past the edges);
//    two consumer warpgroups, 64 rows each, wait on a stage's mbarrier, load
//    their A fragments (ldmatrix) and split them, run twelve m64n128k8 TF32
//    wgmmas on the stage (B through descriptors), release the stage to the
//    producer and add the products into their running sums. The next tile's
//    copies run during a tile's epilogue (bias and stores from registers).
//  - The weight gradient reduces over the M rows, and neither operand is
//    K-major there, so it is its own kernel, warp-specialised as well: TMA
//    brings dy's and x's tiles as they lie in memory; a transformer
//    warpgroup splits x's tile and transposes it into swizzled hi and lo
//    tiles (never an activation in global memory) while two consumer
//    warpgroups run the previous stage's wgmmas, dy's fragments split in
//    their registers. M runs to 47,280 while the output has as few as 36
//    tiles, so M is split over blocks; each split writes its partial sums
//    (and its rows' part of db, summed 32 rows at a time) and a second
//    kernel adds them in split order: no float atomics, so a run repeats
//    bit for bit.

#include <cuda.h>  // CUtensorMap and its enums (the encoder is found at run time)
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int BK = 32;  // K depth of a stage: 128 bytes of fp32, the swizzle's span

// ---------------------------------------------------------------------------
// mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// a box of a 2D tensor map into shared memory; its bytes complete `bar`'s
// transaction count. c0 runs along the contiguous dimension.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---------------------------------------------------------------------------
// Forward and input gradient: out[m][n] = Σ_k A[m][k] B[n][k] (+ bias[n]).

constexpr int GM = 128, GN = 128, STAGES = 4;
constexpr int CONSUMERS = 256, GEMM_THREADS = CONSUMERS + 32;  // two warpgroups, a producer warp
constexpr int A_BYTES = GM * BK * 4, B_BYTES = GN * BK * 4;
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;  // A, B hi, B lo
constexpr size_t GEMM_SMEM = 1024 + (size_t)STAGES * STAGE_BYTES;

struct GemmArgs {
  float* out;         // [M][ncol]
  const float* bias;  // [ncol] or null
  int M, ncol, K;
};

__global__ void __launch_bounds__(GEMM_THREADS, 1)
    linear_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_bhi,
                       const __grid_constant__ CUtensorMap tm_blo, const GemmArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);  // swizzled tiles: 1024-aligned

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                  // the producer's arrival, plus the bytes
      mbar_init(&empty[s], CONSUMERS / 32);    // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int ntn = cdiv(args.ncol, GN);
  const int ntiles = cdiv(args.M, GM) * ntn;
  const int KT = cdiv(args.K, BK);

  if (warp == CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = (tile / ntn) * GM, n0 = (tile % ntn) * GN;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // the first round passes at once
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          const uint32_t s = base + stage * STAGE_BYTES;
          tma_load_2d(s, &tm_a, &full[stage], kt * BK, m0);
          tma_load_2d(s + A_BYTES, &tm_bhi, &full[stage], kt * BK, n0);
          tma_load_2d(s + A_BYTES + B_BYTES, &tm_blo, &full[stage], kt * BK, n0);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // a consumer: warpgroup wg takes rows [64 wg, 64 wg + 64) of each tile
  float* __restrict__ const out = args.out;
  const float* __restrict__ const bias = args.bias;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = (warp >> 2) * 64 + (warp & 3) * 16;  // this warp's 16 rows
  const int li = lane & 7, lm = (lane >> 3) & 1, lh = lane >> 4;
  // the row this lane addresses for ldmatrix (its low three bits are li)
  const uint32_t arow = (uint32_t)(wrow + li + 8 * lm) * 128;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = (tile / ntn) * GM, n0 = (tile % ntn) * GN;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(&full[stage], phase);
      const uint32_t sa = base + stage * STAGE_BYTES;
      uint32_t ahi[BK / 8][4], alo[BK / 8][4];
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        uint32_t r[4];
        // 16-byte chunk 2 ks + lh of the row, where the swizzle put it
        ldsm4(r, sa + arow + ((uint32_t)((2 * ks + lh) ^ li) << 4));
#pragma unroll
        for (int q = 0; q < 4; ++q) split(__uint_as_float(r[q]), ahi[ks][q], alo[ks][q]);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) keep(part[i]);
      wg_fence();
      const uint32_t bh = sa + A_BYTES, bl = sa + A_BYTES + B_BYTES;
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        wgmma_n128(part, alo[ks], sw128_desc(bh + ks * 32), ks > 0);
        wgmma_n128(part, ahi[ks], sw128_desc(bl + ks * 32), 1);
        wgmma_n128(part, ahi[ks], sw128_desc(bh + ks * 32), 1);
      }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) { keep(ahi[ks][q]); keep(alo[ks][q]); }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the stage
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        keep(part[i]);
        acc[i] += part[i];
      }
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }

    // the epilogue: every bias pair of this thread's columns loaded first
    // (into the registers `part` no longer needs), then the stores: loads
    // issued between the stores would each wait out a round trip
    float2 bv[GN / 8];
#pragma unroll
    for (int j = 0; j < GN / 8; ++j) {
      const int n = n0 + j * 8 + 2 * t4;
      bv[j] = bias != nullptr && n < args.ncol
                  ? __ldg(reinterpret_cast<const float2*>(bias + n))
                  : make_float2(0.f, 0.f);
    }
    const int m = m0 + wrow + g;
    float* const yrow = out + (size_t)m * args.ncol;
#pragma unroll
    for (int j = 0; j < GN / 8; ++j) {
      const int n = n0 + j * 8 + 2 * t4;
      if (n >= args.ncol) continue;
      if (m < args.M)
        *reinterpret_cast<float2*>(yrow + n) =
            make_float2(acc[4 * j] + bv[j].x, acc[4 * j + 1] + bv[j].y);
      if (m + 8 < args.M)
        *reinterpret_cast<float2*>(yrow + 8 * (size_t)args.ncol + n) =
            make_float2(acc[4 * j + 2] + bv[j].x, acc[4 * j + 3] + bv[j].y);
    }
  }
}

// w [rows][cols] into hi and lo arrays of the same layout
__global__ void linear_prep_weight(const float* __restrict__ w, float* __restrict__ hi,
                                   float* __restrict__ lo, size_t total) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const float v = w[e];
    const float h = __uint_as_float(tf32_rna(v));
    hi[e] = h;
    lo[e] = __uint_as_float(tf32_rna(v - h));
  }
}

// w [rows][cols] into hi and lo arrays [cols][rows], 32 x 32 tiles through
// shared memory (both sides coalesced); blocks of 32 x 8 threads
__global__ void linear_prep_weight_t(const float* __restrict__ w, float* __restrict__ hi,
                                     float* __restrict__ lo, int rows, int cols) {
  __shared__ float t[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int j = ty; j < 32; j += 8) {
    const int r = r0 + j, c = c0 + tx;
    if (r < rows && c < cols) t[j][tx] = w[(size_t)r * cols + c];
  }
  __syncthreads();
  for (int j = ty; j < 32; j += 8) {
    const int c = c0 + j, r = r0 + tx;
    if (c < cols && r < rows) {
      const float v = t[tx][j];
      const float h = __uint_as_float(tf32_rna(v));
      hi[(size_t)c * rows + r] = h;
      lo[(size_t)c * rows + r] = __uint_as_float(tf32_rna(v - h));
    }
  }
}

// ---------------------------------------------------------------------------
// Weight gradient: ws[split][n][k] = Σ over this split's rows m of
// dy[m][n] x[m][k], and wsb[split][n] = Σ over the same rows of dy[m][n].
//
// The output tile is 128 rows of dW (n) by 128 columns (k), the depth 32
// rows of m a stage. Three warpgroups: two consumers (64 rows of the tile
// each) and a transformer. The transformer's first thread keeps a ring of
// four staging buffers full with TMA copies: dy's tile as four 128-byte
// swizzled boxes of 32 x 32 (so that the consumers' fragment loads meet few
// bank conflicts) and x's tile [32 m][128 k] as it lies. The transformer
// splits x's tile and transposes it into hi and lo tiles in the swizzled
// K-major layout a wgmma descriptor reads, into a ring of two, and, in the
// blocks of the first column of tiles, sums dy's columns for db. The
// consumers load dy's fragments from the staging buffer and split them in
// registers, release the staging buffer, and run twelve m64n128k8 wgmmas on
// the converted tile: the conversion of stage j + 1 runs beside the
// products of stage j.

constexpr int W_LOAD = 4, W_CONV = 2;          // staging and conversion rings
constexpr int W_DY = GM * BK * 4;              // dy's tile: 4 boxes [32 m][32 n], 4 KB each
constexpr int W_X = GN * BK * 4;               // x's tile [32 m][128 k]
constexpr int W_STAGE = W_DY + W_X;
constexpr int W_TILE = GN * BK * 4;            // one converted tile [128 k][32 m], swizzled
constexpr int WGRAD_THREADS = 384;             // two consumer warpgroups, a transformer
constexpr size_t WGRAD_SMEM = 1024 + (size_t)W_LOAD * W_STAGE + (size_t)W_CONV * 2 * W_TILE;

struct WgradArgs {
  float* ws;   // [splits][N][K]
  float* wsb;  // [splits][N], or null: no bias gradient
  int M, N, K;
  int kt_split;  // 32-row stages a split
};

__global__ void __launch_bounds__(WGRAD_THREADS, 1)
    linear_wgrad_kernel(const __grid_constant__ CUtensorMap tm_dy,
                        const __grid_constant__ CUtensorMap tm_x, const WgradArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[W_LOAD], empty[W_LOAD], cfull[W_CONV], cempty[W_CONV];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* const gbase = smem_raw + pad;  // staging ring, then conversion ring
  const uint32_t base = raw + pad, cbase = base + W_LOAD * W_STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < W_LOAD; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 + CONSUMERS / 32);  // every transformer thread, each consumer warp
    }
    for (int c = 0; c < W_CONV; ++c) {
      mbar_init(&cfull[c], 128);
      mbar_init(&cempty[c], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n0 = blockIdx.y * GM, k0 = blockIdx.x * GN;
  const int KT = cdiv(args.M, BK);
  const int kt0 = blockIdx.z * args.kt_split;
  const int nkt = imax(0, imin(KT, kt0 + args.kt_split) - kt0);

  if (warp >= CONSUMERS / 32) {  // the transformer
    const int t = tid - CONSUMERS;
    auto issue = [&](int j) {  // stage j's copies, once its buffer is free
      const int s = j % W_LOAD;
      mbar_wait(&empty[s], ((j / W_LOAD) & 1) ^ 1);
      mbar_expect_tx(&full[s], W_STAGE);
      const uint32_t st = base + s * W_STAGE;
      const int row = (kt0 + j) * BK;
      for (int b = 0; b < GM / 32; ++b)
        tma_load_2d(st + b * 4096, &tm_dy, &full[s], n0 + 32 * b, row);
      tma_load_2d(st + W_DY, &tm_x, &full[s], k0, row);
    };
    if (t == 0)
      for (int j = 0; j < imin(W_LOAD - 1, nkt); ++j) issue(j);
    const bool bias_rows = args.wsb != nullptr && blockIdx.x == 0;
    float bacc = 0.f;
    for (int j = 0; j < nkt; ++j) {
      const int s = j % W_LOAD, c = j % W_CONV;
      mbar_wait(&full[s], (j / W_LOAD) & 1);
      mbar_wait(&cempty[c], ((j / W_CONV) & 1) ^ 1);
      const float* xs = reinterpret_cast<const float*>(gbase + s * W_STAGE + W_DY);
      unsigned char* hi = gbase + W_LOAD * W_STAGE + c * 2 * W_TILE;
      unsigned char* lo = hi + W_TILE;
      // 128 columns k by 8 groups of 4 rows m, 8 a thread; a warp takes 32
      // neighbouring columns (conflict-free reads, 16-byte writes)
#pragma unroll
      for (int i = 0; i < GN * (BK / 4) / 128; ++i) {
        const int id = t + i * 128, k = id % GN, k4 = id / GN;
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(xs[(4 * k4 + e) * GN + k], h[e], l[e]);
        const int off = k * 128 + ((k4 ^ (k & 7)) << 4);
        *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
      }
      if (bias_rows) {  // db: column t of dy's tile over the stage's 32 rows, then the sum
        const unsigned char* col = gbase + s * W_STAGE + (t >> 5) * 4096 + (t & 3) * 4;
        const int ch = (t & 31) >> 2;
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < BK; ++r)
          sum += *reinterpret_cast<const float*>(col + r * 128 + ((ch ^ (r & 7)) << 4));
        bacc += sum;
      }
      fence_async_shared();  // the converted tiles, seen by the wgmma's reads
      mbar_arrive(&cfull[c]);
      mbar_arrive(&empty[s]);  // done with the staging buffer (x, and dy for db)
      if (t == 0 && j + W_LOAD - 1 < nkt) issue(j + W_LOAD - 1);
    }
    if (bias_rows && n0 + t < args.N) args.wsb[(size_t)blockIdx.z * args.N + n0 + t] = bacc;
    return;
  }

  // a consumer: rows [wm, wm + 16) of the tile for this warp, all 128 columns
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 2) * 64 + (warp & 3) * 16;
  // dy's element (row n, depth m) of a stage: box n / 32, row m, 16-byte chunk
  // ((n % 32) / 4) ^ (m % 8), float n % 4; this lane's rows are wm + g and
  // wm + g + 8 (the same box, chunks c0 and c0 + 2), its depths 8 ks + t4
  // and 8 ks + t4 + 4 (m % 8 = t4 and t4 + 4)
  const int nr = wm + g, c0 = (nr & 31) >> 2;
  const int aoff = (nr >> 5) * 4096 + (nr & 3) * 4 + t4 * 128;
  const int o00 = aoff + ((c0 ^ t4) << 4), o10 = aoff + (((c0 + 2) ^ t4) << 4);
  const int o01 = aoff + 4 * 128 + ((c0 ^ (t4 + 4)) << 4);
  const int o11 = aoff + 4 * 128 + (((c0 + 2) ^ (t4 + 4)) << 4);
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int j = 0; j < nkt; ++j) {
    const int s = j % W_LOAD, c = j % W_CONV;
    mbar_wait(&full[s], (j / W_LOAD) & 1);
    const unsigned char* st = gbase + s * W_STAGE;
    uint32_t ahi[BK / 8][4], alo[BK / 8][4];
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const unsigned char* p = st + ks * 8 * 128;
      split(*reinterpret_cast<const float*>(p + o00), ahi[ks][0], alo[ks][0]);
      split(*reinterpret_cast<const float*>(p + o10), ahi[ks][1], alo[ks][1]);
      split(*reinterpret_cast<const float*>(p + o01), ahi[ks][2], alo[ks][2]);
      split(*reinterpret_cast<const float*>(p + o11), ahi[ks][3], alo[ks][3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with dy's tile
    mbar_wait(&cfull[c], (j / W_CONV) & 1);
#pragma unroll
    for (int i = 0; i < 64; ++i) keep(part[i]);
    wg_fence();
    const uint32_t bh = cbase + c * 2 * W_TILE, bl = bh + W_TILE;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      wgmma_n128(part, alo[ks], sw128_desc(bh + ks * 32), ks > 0);
      wgmma_n128(part, ahi[ks], sw128_desc(bl + ks * 32), 1);
      wgmma_n128(part, ahi[ks], sw128_desc(bh + ks * 32), 1);
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) { keep(ahi[ks][q]); keep(alo[ks][q]); }
    __syncwarp();
    if (lane == 0) mbar_arrive(&cempty[c]);  // this warp is done with the converted tile
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      keep(part[i]);
      acc[i] += part[i];
    }
  }

  float* out = args.ws + (size_t)blockIdx.z * args.N * args.K;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + wm + h * 8 + g;
    if (n >= args.N) continue;
#pragma unroll
    for (int j = 0; j < GN / 8; ++j) {
      const int k = k0 + j * 8 + 2 * t4;
      if (k < args.K)
        *reinterpret_cast<float2*>(out + (size_t)n * args.K + k) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// dw = Σ over splits, in split order, of ws[split]; db the same of wsb
__global__ void linear_wgrad_reduce(const float* __restrict__ ws, const float* __restrict__ wsb,
                                    float* __restrict__ dw, float* __restrict__ db, int splits,
                                    int N, int K) {
  const size_t plane = (size_t)N * K;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < plane;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = ws[e];
    for (int sp = 1; sp < splits; ++sp) s += ws[sp * plane + e];
    dw[e] = s;
  }
  if (db != nullptr)
    for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < N; n += gridDim.x * blockDim.x) {
      float s = wsb[n];
      for (int sp = 1; sp < splits; ++sp) s += wsb[(size_t)sp * N + n];
      db[n] = s;
    }
}

// ---------------------------------------------------------------------------
// Host side (the per-device facts are wgmma_tf32.cuh's).

// cuTensorMapEncodeTiled, looked up at run time (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int encoder(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return (int)cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return 0;
}

// a row-major fp32 matrix [rows][cols] read in boxes of `box_cols` x
// `box_rows`, zero past its edges; `swizzle`: 128-byte swizzled (a box row
// of 128 bytes), else as it lies
int tile_map(CUtensorMap* map, const float* p, int rows, int cols, int box_cols, int box_rows,
             bool swizzle) {
  EncodeTiled encode = nullptr;
  const int rc = encoder(&encode);
  if (rc) return rc;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims,
                            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// out [M][ncol] = a [M][K] · b [ncol][K]ᵀ (+ bias), b given as its hi and lo parts
int run_gemm(const float* a, const float* bhi, const float* blo, const float* bias, float* out,
             int M, int ncol, int K, cudaStream_t stream) {
  int dev = 0, sms = 0;
  int rc = device_info(&dev, &sms);
  if (rc) return rc;
  static bool done[MAX_DEV];
  static int per_sm[MAX_DEV];
  rc = configure(linear_gemm_kernel, dev, GEMM_SMEM, GEMM_THREADS, done, per_sm);
  if (rc) return rc;
  CUtensorMap ma, mh, ml;
  if ((rc = tile_map(&ma, a, M, K, BK, GM, true)) ||
      (rc = tile_map(&mh, bhi, ncol, K, BK, GN, true)) ||
      (rc = tile_map(&ml, blo, ncol, K, BK, GN, true)))
    return rc;
  GemmArgs args;
  args.out = out;
  args.bias = bias;
  args.M = M;
  args.ncol = ncol;
  args.K = K;
  const long tiles = (long)cdiv(M, GM) * cdiv(ncol, GN);
  const long slots = (long)sms * (per_sm[dev] > 0 ? per_sm[dev] : 1);
  const int grid = (int)(tiles < slots ? tiles : slots);
  linear_gemm_kernel<<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(ma, mh, ml, args);
  return (int)cudaGetLastError();
}

int prep(const float* w, float* wbuf, int N, int K, bool transpose, cudaStream_t stream) {
  int dev = 0, sms = 0;
  const int rc = device_info(&dev, &sms);
  if (rc) return rc;
  const size_t total = (size_t)N * K;
  if (transpose) {
    const dim3 grid(cdiv(K, 32), cdiv(N, 32));
    linear_prep_weight_t<<<grid, dim3(32, 8), 0, stream>>>(w, wbuf, wbuf + total, N, K);
  } else {
    const int blocks = (int)imin((int)((total + 255) / 256), 8 * sms);
    linear_prep_weight<<<blocks, 256, 0, stream>>>(w, wbuf, wbuf + total, total);
  }
  return (int)cudaGetLastError();
}

bool bad_geometry(int M, int N, int K) {
  if (M <= 0 || N <= 0 || K <= 0 || N % BK || K % BK) return true;
  const long big = 0x7fffffffL;  // rows and TMA coordinates are int
  return (long)M * K > big || (long)M * N > big || (long)N * K > big;
}

// Weight gradient: the split count for a problem.
struct WgradPlan {
  int splits, kt_split;
};

int plan_wgrad(int M, int N, int K, WgradPlan* plan) {
  int dev = 0, sms = 0;
  int rc = device_info(&dev, &sms);
  if (rc) return rc;
  static bool done[MAX_DEV];
  static int per_sm[MAX_DEV];
  rc = configure(linear_wgrad_kernel, dev, WGRAD_SMEM, WGRAD_THREADS, done, per_sm);
  if (rc) return rc;
  const int KT = cdiv(M, BK);
  const long slots = (long)sms * (per_sm[dev] > 0 ? per_sm[dev] : 1);
  const long tiles = (long)cdiv(N, GM) * cdiv(K, GN);
  // cost in units of one block's stage: waves of blocks times their stages,
  // plus the partial sums' write and read (a stage of a block moves
  // (GM + GN) * BK floats in; a split's partial plane moves 2 * N * K floats
  // over the whole card, at roughly the L2's rate per SM)
  const double plane = 2.0 * N * K / ((double)(GM + GN) * BK * slots);
  int best = 1;
  double best_cost = 1e300;
  const int smax = KT < 256 ? KT : 256;
  for (int s = 1; s <= smax; ++s) {
    const int kts = cdiv(KT, s);
    if (cdiv(KT, kts) != s) continue;  // every split gets work
    const double waves = (double)((tiles * s + slots - 1) / slots);
    const double cost = waves * kts + plane * s;
    if (cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  plan->splits = best;
  plan->kt_split = cdiv(KT, best);
  return 0;
}

}  // namespace

// All tensors fp32, contiguous, 16-byte aligned, on the current device:
// x [M][K], w [N][K], bias [N] (or null), y and dy [M][N]; N and K are
// multiples of 32. `wbuf` holds 2*N*K floats of scratch (the weight's hi
// and lo parts). Each returns a cudaError_t (0 on success): a geometry the
// kernels do not take is cudaErrorInvalidValue, checked before anything is
// launched.

extern "C" int linear_fwd_launch(const void* x, const void* w, const void* bias, void* y,
                                 void* wbuf, int M, int N, int K, void* stream) {
  if (bad_geometry(M, N, K)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* hi = static_cast<float*>(wbuf);
  int rc = prep(static_cast<const float*>(w), hi, N, K, false, s);
  if (rc) return rc;
  return run_gemm(static_cast<const float*>(x), hi, hi + (size_t)N * K,
                  static_cast<const float*>(bias), static_cast<float*>(y), M, N, K, s);
}

// dy [M][N] -> dx [M][K]
extern "C" int linear_dgrad_launch(const void* dy, const void* w, void* dx, void* wbuf, int M,
                                   int N, int K, void* stream) {
  if (bad_geometry(M, N, K)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* hi = static_cast<float*>(wbuf);  // Wᵀ [K][N]
  int rc = prep(static_cast<const float*>(w), hi, N, K, true, s);
  if (rc) return rc;
  return run_gemm(static_cast<const float*>(dy), hi, hi + (size_t)N * K, nullptr,
                  static_cast<float*>(dx), M, K, N, s);
}

// The floats of scratch linear_wgrad_launch needs for this geometry (its
// split count times N*K + N), or a negative cudaError_t.
extern "C" long linear_wgrad_workspace(int M, int N, int K) {
  if (bad_geometry(M, N, K)) return -(long)cudaErrorInvalidValue;
  WgradPlan plan;
  const int rc = plan_wgrad(M, N, K, &plan);
  if (rc) return -(long)rc;
  return (long)plan.splits * ((long)N * K + N);
}

// x [M][K], dy [M][N] -> dw [N][K] and, where db is not null, db [N]; `ws`
// holds linear_wgrad_workspace(...) floats.
extern "C" int linear_wgrad_launch(const void* x, const void* dy, void* dw, void* db, void* ws,
                                   int M, int N, int K, void* stream) {
  if (bad_geometry(M, N, K)) return (int)cudaErrorInvalidValue;
  WgradPlan plan;
  int rc = plan_wgrad(M, N, K, &plan);
  if (rc) return rc;
  CUtensorMap mdy, mx;
  if ((rc = tile_map(&mdy, static_cast<const float*>(dy), M, N, 32, BK, true)) ||
      (rc = tile_map(&mx, static_cast<const float*>(x), M, K, GN, BK, false)))
    return rc;
  WgradArgs a;
  a.ws = static_cast<float*>(ws);
  a.wsb = db != nullptr ? a.ws + (size_t)plan.splits * N * K : nullptr;
  a.M = M; a.N = N; a.K = K;
  a.kt_split = plan.kt_split;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(cdiv(K, GN), cdiv(N, GM), plan.splits);
  linear_wgrad_kernel<<<grid, WGRAD_THREADS, WGRAD_SMEM, s>>>(mdy, mx, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  rc = device_info(&dev, &sms);
  if (rc) return rc;
  const long total = (long)N * K;
  const int blocks = (int)(total / 256 + 1 < 8L * sms ? total / 256 + 1 : 8L * sms);
  linear_wgrad_reduce<<<blocks, 256, 0, s>>>(a.ws, a.wsb, static_cast<float*>(dw),
                                             static_cast<float*>(db), plan.splits, N, K);
  return (int)cudaGetLastError();
}
