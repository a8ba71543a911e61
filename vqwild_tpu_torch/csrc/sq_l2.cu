// K1: exact pairwise squared L2 distances in fp32, [Q,D] x [G,D] -> [Q,G],
//     out = max(|q|^2 + |g|^2 - 2 q.g, 0).
//
// Replaces: vqwild_tpu/ops/pallas_kernels.py pairwise_sq_l2_pallas (kernel
// body _sq_l2_kernel), the exact-L2 scorer behind ops/distance.score_matrix.
// The Pallas kernel runs the cross term on the TPU's matrix unit at
// Precision.HIGHEST, a multi-pass product with fp32 accuracy, and takes both
// norms in the same body; this does the same on Hopper's.
//
// What bounds it on an H100: bytes. At the serving shape (Q <= 16 queries,
// G = 7,670 .. 100,000 gallery rows, D = 512) the kernel must read the
// gallery once, G*D*4 bytes (205 MB at G = 100k, 0.061 ms at 3.35 TB/s).
// The product is 2*Q*G*D flops; as three TF32 tensor-core passes that is
// 4.9 GFLOP at G = 100k, 0.010 ms at the 495 TFLOP/s peak and about 0.021 ms
// at the rate mma.sync reaches, a third of the byte time. A gallery of 7,670
// rows (15.7 MB) sits in the 50 MB L2 between calls; there the kernel's
// time is its launch, two trips to memory per warp and the product, not
// the bandwidth (PERF.md has the measurements).
//
// What the design does about it:
//  - The cross term is mma.sync m16n8k8 TF32 in inline PTX. The 16 queries
//    of a serving bucket are the M of one tile (fewer leave zero rows, more
//    go to grid.y), gallery rows are the N columns, D is the K loop.
//  - fp32 accuracy from TF32: x = hi + lo with hi = tf32(x), lo =
//    tf32(x - hi), and q_lo*g_hi + q_hi*g_lo + q_hi*g_hi go into one fp32
//    accumulator (lo*lo, ~2^-22 relative, is dropped). One TF32 pass alone
//    keeps three digits and reorders ranks near ties, so it is not offered.
//  - The gallery goes from device memory straight into the B operand
//    registers: no shared memory, no barrier in the K loop. In the B
//    fragment lane l holds column l/4 at k = l%4 and l%4 + 4. A dot product
//    may walk K in any order as long as A and B agree, so lane l loads one
//    float4 of gallery row l/4 at k0 + 4*(l%4): a quad reads 64 contiguous
//    bytes, every fetched sector is used whole, and the four values feed two
//    k-steps (.x,.y then .z,.w). A warp's loads do not depend on its mma's:
//    it keeps PF = 2 chunks of 16 K values in flight (eight 16-byte loads a
//    lane) and sends the two chunks' loads of one row back to back, so that
//    a row's whole 128-byte line is asked for at once.
//  - The queries take the same K permutation: slot (k-step s, k = t + 4j) of
//    the A fragment holds q[row][k0 + 4t + 2s + j], so a lane's a0..a3 of two
//    k-steps are one float4 of query row l/4 and one of row l/4 + 8. They are
//    read through L1 beside the gallery loads and split in registers, and
//    |q|^2 is summed in fp32 from the unsplit values in the same place; each
//    split feeds 12 mma. The other variant, the queries staged once per
//    block in shared memory, split and in fragment order (64 KB at D = 512,
//    D in stages of 512), was built and timed too: it saves a third of the
//    ALU work per chunk but puts a load -> split -> store -> barrier chain in
//    front of every block's first mma. It was 3% faster at G = 100,000 and
//    14% slower at G = 7,670, the serving shape, so this one was kept; it
//    also needs no shared memory and no barrier outside the split-K sum.
//  - |g|^2 in the same pass, in fp32, from the unsplit registers: four FMAs a
//    float4, two shuffles over the quad at the end, two more to fetch the
//    norms of the two columns a lane's accumulators belong to.
//  - One warp owns 32 gallery rows (four n8 tiles, 16 accumulators a lane).
//    A block is 8 warps. When the gallery is too small to fill the card,
//    S = 2, 4 or 8 warps of a block share the same 32 rows and take a 1/S
//    slice of D each; the partial sums and norms meet in shared memory (a
//    named barrier per row group) and are added in the order of the slices.
//    S depends on the call's shape only, and a row's arithmetic does not
//    depend on where the row stands: rows past the end load row G-1 (a
//    clamped address) and are dropped at the store. Two equal gallery rows
//    therefore score bit-identically, tail tile included, which the stable
//    top-k sort relies on.
//  - D % 4 != 0, or a pointer that is not 16-byte aligned, takes guarded
//    scalar loads into the same registers (template flag); K past D is zero
//    in both operands.
//  - wgmma and TMA are not used. M is 16 and wgmma takes 64 rows, so three
//    quarters of each product would be zeros, and its B operand must pass
//    through shared memory, which this design exists to avoid. A ring of TMA
//    tiles feeds a kernel bound by its product; this one is bound by the
//    gallery read, and plain 16-byte loads keep that read in flight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int QB = 16;   // queries per block: M of the mma tile
constexpr int NT = 4;    // n8 tiles per warp
constexpr int RW = 8 * NT;  // gallery rows per warp
constexpr int KC = 16;   // K values per chunk: one float4 a lane, two k8 steps
constexpr int PF = 2;    // chunks of loads in flight ahead of the mma's
constexpr int RED = 4 * NT + NT + 2;  // floats a lane hands over in the split-K sum:
                                      // 16 accumulators, 4 row norms, 2 query norms
constexpr int MIN_BLOCKS = 2;     // blocks per SM the register budget allows
constexpr int WARPS_PER_SM = 16;  // the launcher splits K until the grid has these

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return __uint_as_float(u);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const float4& a, float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)), "r"(__float_as_uint(a.z)),
        "r"(__float_as_uint(a.w)), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// Four values of row p at k .. k+3, zero where `on` is false or k + i >= d.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int k, int d, bool on) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (VEC) {
    if (on && k < d) v = __ldg(reinterpret_cast<const float4*>(p + k));
  } else {
    if (on && k < d) v.x = __ldg(p + k);
    if (on && k + 1 < d) v.y = __ldg(p + k + 1);
    if (on && k + 2 < d) v.z = __ldg(p + k + 2);
    if (on && k + 3 < d) v.w = __ldg(p + k + 3);
  }
  return v;
}

// One chunk of 16 K values for the warp's four n8 tiles: the norms, the
// hi/lo split of both operands and 24 mma. ra and rb are this lane's four
// values of query rows gq and gq + 8.
__device__ __forceinline__ void mma_chunk(float (&acc)[NT][4], float (&g2)[NT], float& qa2,
                                          float& qb2, const float4 (&v)[NT], const float4& ra,
                                          const float4& rb) {
  qa2 = fmaf(ra.x, ra.x, qa2);
  qa2 = fmaf(ra.y, ra.y, qa2);
  qa2 = fmaf(ra.z, ra.z, qa2);
  qa2 = fmaf(ra.w, ra.w, qa2);
  qb2 = fmaf(rb.x, rb.x, qb2);
  qb2 = fmaf(rb.y, rb.y, qb2);
  qb2 = fmaf(rb.z, rb.z, qb2);
  qb2 = fmaf(rb.w, rb.w, qb2);
  // a0 = (gq, t), a1 = (gq + 8, t), a2 = (gq, t + 4), a3 = (gq + 8, t + 4)
  const float4 ah0 = make_float4(tf32_rna(ra.x), tf32_rna(rb.x), tf32_rna(ra.y), tf32_rna(rb.y));
  const float4 ah1 = make_float4(tf32_rna(ra.z), tf32_rna(rb.z), tf32_rna(ra.w), tf32_rna(rb.w));
  const float4 al0 = make_float4(tf32_rna(ra.x - ah0.x), tf32_rna(rb.x - ah0.y),
                                 tf32_rna(ra.y - ah0.z), tf32_rna(rb.y - ah0.w));
  const float4 al1 = make_float4(tf32_rna(ra.z - ah1.x), tf32_rna(rb.z - ah1.y),
                                 tf32_rna(ra.w - ah1.z), tf32_rna(rb.w - ah1.w));
  float4 bh[NT], bl[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    g2[j] = fmaf(v[j].x, v[j].x, g2[j]);
    g2[j] = fmaf(v[j].y, v[j].y, g2[j]);
    g2[j] = fmaf(v[j].z, v[j].z, g2[j]);
    g2[j] = fmaf(v[j].w, v[j].w, g2[j]);
    bh[j] = make_float4(tf32_rna(v[j].x), tf32_rna(v[j].y), tf32_rna(v[j].z), tf32_rna(v[j].w));
    bl[j] = make_float4(tf32_rna(v[j].x - bh[j].x), tf32_rna(v[j].y - bh[j].y),
                        tf32_rna(v[j].z - bh[j].z), tf32_rna(v[j].w - bh[j].w));
  }
  // the small terms first, then hi*hi, into the same accumulator
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], al0, bh[j].x, bh[j].y);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah0, bl[j].x, bl[j].y);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah0, bh[j].x, bh[j].y);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], al1, bh[j].z, bh[j].w);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah1, bl[j].z, bl[j].w);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah1, bh[j].z, bh[j].w);
}

// Two neighbouring distances of one query row; `pair` says that p is 8-byte
// aligned for every even column.
__device__ __forceinline__ void store2(float* p, int col, int ng, bool pair, float a, float b) {
  if (pair && col + 1 < ng) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (col < ng) p[0] = a;
    if (col + 1 < ng) p[1] = b;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
sq_l2_kernel(const float* __restrict__ q, const float* __restrict__ g, float* __restrict__ out,
             int nq, int ng, int d, int S, int pair) {
  extern __shared__ __align__(16) float red[];  // [warp][RED][lane], when S > 1

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;  // the fragment's group and thread-in-group
  const int s = warp % S;                  // this warp's slice of D
  const int row0 = (blockIdx.x * (WARPS / S) + warp / S) * RW;
  const int q0 = blockIdx.y * QB;
  if (row0 >= ng) return;  // whole groups of S warps leave together

  const float* gp[NT];  // this lane's place in its row of each n8 tile
#pragma unroll
  for (int j = 0; j < NT; ++j)
    gp[j] = g + (size_t)imin(row0 + 8 * j + gq, ng - 1) * d + 4 * t;
  const float* qa = q + (size_t)(q0 + gq) * d + 4 * t;  // fragment rows gq and gq + 8
  const float* qb = qa + (size_t)8 * d;
  const bool qa_on = q0 + gq < nq, qb_on = q0 + gq + 8 < nq;

  float acc[NT][4];
  float g2[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    g2[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float qa2 = 0.f, qb2 = 0.f;

  const int nc = (d + KC - 1) / KC;  // chunks of D
  const int cps = (nc + S - 1) / S;  // chunks per slice
  const int cb = imin(nc, s * cps), ce = imin(nc, cb + cps);
  const int dt = d - 4 * t;

  float4 buf[PF][NT], bqa[PF], bqb[PF];
#pragma unroll
  for (int i = 0; i < PF; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) buf[i][j] = load4<VEC>(gp[j], (cb + i) * KC, dt, cb + i < ce);
    bqa[i] = load4<VEC>(qa, (cb + i) * KC, dt, qa_on && cb + i < ce);
    bqb[i] = load4<VEC>(qb, (cb + i) * KC, dt, qb_on && cb + i < ce);
  }
  for (int c = cb; c < ce; c += PF) {
#pragma unroll
    for (int i = 0; i < PF; ++i)
      if (c + i < ce) mma_chunk(acc, g2, qa2, qb2, buf[i], bqa[i], bqb[i]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < PF; ++i)
        buf[i][j] = load4<VEC>(gp[j], (c + i + PF) * KC, dt, c + i + PF < ce);
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      bqa[i] = load4<VEC>(qa, (c + i + PF) * KC, dt, qa_on && c + i + PF < ce);
      bqb[i] = load4<VEC>(qb, (c + i + PF) * KC, dt, qb_on && c + i + PF < ce);
    }
  }

  // the quad's four partial norms of query rows gq and gq + 8
  qa2 += __shfl_xor_sync(0xffffffffu, qa2, 1);
  qa2 += __shfl_xor_sync(0xffffffffu, qa2, 2);
  qb2 += __shfl_xor_sync(0xffffffffu, qb2, 1);
  qb2 += __shfl_xor_sync(0xffffffffu, qb2, 2);
  if (S > 1) {
    // the S warps of a row group meet at their own named barrier
    const int grp = warp / S, bar = 1 + grp;
    if (s > 0) {  // hand the slice's partial sums to the warp of slice 0
      float* r = red + warp * RED * 32 + lane;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) r[(4 * j + e) * 32] = acc[j][e];
        r[(4 * NT + j) * 32] = g2[j];
      }
      r[(5 * NT) * 32] = qa2;
      r[(5 * NT + 1) * 32] = qb2;
      __threadfence_block();
      asm volatile("bar.arrive %0, %1;" ::"r"(bar), "r"(32 * S) : "memory");
      return;
    }
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(32 * S) : "memory");
    for (int sp = 1; sp < S; ++sp) {  // slices in their order
      const float* r = red + (warp + sp) * RED * 32 + lane;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += r[(4 * j + e) * 32];
        g2[j] += r[(4 * NT + j) * 32];
      }
      qa2 += r[(5 * NT) * 32];
      qb2 += r[(5 * NT + 1) * 32];
    }
  }
  const float q2a = qa2, q2b = qb2;
  float* oa = out + (size_t)(q0 + gq) * ng;
  float* ob = oa + (size_t)8 * ng;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    // the quad's four partial norms of row 8j + gq, the same sum in each lane
    g2[j] += __shfl_xor_sync(0xffffffffu, g2[j], 1);
    g2[j] += __shfl_xor_sync(0xffffffffu, g2[j], 2);
    // the accumulators hold columns 2t and 2t + 1 of the tile
    const float n0 = __shfl_sync(0xffffffffu, g2[j], 8 * t);
    const float n1 = __shfl_sync(0xffffffffu, g2[j], 8 * t + 4);
    const int col = row0 + 8 * j + 2 * t;
    if (qa_on)
      store2(oa + col, col, ng, pair, fmaxf(q2a + n0 - 2.f * acc[j][0], 0.f),
             fmaxf(q2a + n1 - 2.f * acc[j][1], 0.f));
    if (qb_on)
      store2(ob + col, col, ng, pair, fmaxf(q2b + n0 - 2.f * acc[j][2], 0.f),
             fmaxf(q2b + n1 - 2.f * acc[j][3], 0.f));
  }
}

struct Plan {
  int S, gx, gy, smem;
};

// S doubles while the grid has fewer than WARPS_PER_SM warps a SM and a
// slice stays at least 32 wide. The split-K sum's shared memory (22 KB at
// most) needs no opt-in.
cudaError_t make_plan(int nq, int ng, int d, Plan* p) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nc = (d + KC - 1) / KC;
  const long groups = (long)((ng + RW - 1) / RW) * ((nq + QB - 1) / QB);
  int S = 1;
  while (S < WARPS && nc >= 4 * S && groups * S < (long)WARPS_PER_SM * sms) S *= 2;
  p->S = S;
  p->gx = ((ng + RW - 1) / RW + WARPS / S - 1) / (WARPS / S);
  p->gy = (nq + QB - 1) / QB;
  p->smem = S > 1 ? WARPS * RED * 32 * 4 : 0;
  return cudaSuccess;
}

}  // namespace

// What sq_l2_launch picks for this shape on the current device:
// plan = {S, grid.x, grid.y, threads per block, dynamic shared memory bytes}.
extern "C" int sq_l2_plan(int nq, int ng, int d, int* plan) {
  if (nq <= 0 || ng <= 0 || d < 0) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = make_plan(nq, ng, d, &p);
  if (err != cudaSuccess) return (int)err;
  plan[0] = p.S;
  plan[1] = p.gx;
  plan[2] = p.gy;
  plan[3] = THREADS;
  plan[4] = p.smem;
  return 0;
}

// q [nq,d], g [ng,d] fp32 row-major contiguous; out [nq,ng] fp32. Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sq_l2_launch(const void* q, const void* g, void* out, int nq,
                            int ng, int d, void* stream) {
  if (nq <= 0 || ng <= 0 || d < 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(nq, ng, d, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.gy > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && (uintptr_t)g % 16 == 0 && (uintptr_t)q % 16 == 0;
  const int pair = ng % 2 == 0 && (uintptr_t)out % 8 == 0;
  auto kernel = vec ? sq_l2_kernel<true> : sq_l2_kernel<false>;
  kernel<<<dim3(p.gx, p.gy), THREADS, p.smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(g), static_cast<float*>(out), nq,
      ng, d, p.S, pair);
  return (int)cudaGetLastError();
}
