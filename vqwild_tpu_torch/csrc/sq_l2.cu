// K1: exact pairwise squared L2 distances in fp32, [Q,D] x [G,D] -> [Q,G],
//     out = max(|q|^2 + |g|^2 - 2 q.g, 0).
//
// Replaces: vqwild_tpu/ops/pallas_kernels.py pairwise_sq_l2_pallas (kernel
// body _sq_l2_kernel), the exact-L2 scorer behind ops/distance.score_matrix.
//
// What bounds it on an H100: bytes. At the serving shape (Q <= 16 queries,
// G = 7,670 .. 100,000 gallery rows, D = 512) the kernel must read the
// gallery once, G*D*4 bytes (205 MB at G = 100k, ~61 us at 3.35 TB/s),
// against 2*Q*G*D flops (1.6 GFLOP, ~25 us at the 67 TFLOP/s fp32 rate).
// The contract is fp32 at HIGHEST precision: the tensor cores take no fp32
// operand and TF32 keeps ~3 decimal digits, so the cross term is fp32 FMA.
//
// What the design does about it: every gallery byte is read from device
// memory once per block of 16 queries, with coalesced 16-byte loads, and
// the row norm is taken in the same pass. One block of 128 threads owns 128
// gallery rows (one per thread) and one block of up to 16 queries (grid.y
// walks the query blocks when Q > 16). D is streamed in chunks of 32: the
// block stages its 128x32 gallery tile (eight threads per 128-byte row
// segment) and the 16x32 query tile in shared memory; each thread then
// keeps 16 dot products and its row norm in registers and reads each query
// float4 as a broadcast. Ragged Q, G and D edges are masked here (zero
// filled tiles, guarded stores) instead of padding to 128 as the TPU did.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TG = 128;     // gallery rows per block, one per thread
constexpr int QB = 16;      // queries per block
constexpr int DK = 32;      // width of one D chunk
constexpr int GS = DK + 4;  // padded tile row: conflict-free float4 reads

__global__ void __launch_bounds__(TG)
sq_l2_kernel(const float* __restrict__ q, const float* __restrict__ g,
             float* __restrict__ out, int nq, int ng, int d, int vec4) {
  __shared__ __align__(16) float gs[TG * GS];
  __shared__ __align__(16) float qs[QB * DK];
  __shared__ float q2s[QB];

  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * TG;
  const int q0 = blockIdx.y * QB;

  float acc[QB];
#pragma unroll
  for (int i = 0; i < QB; ++i) acc[i] = 0.f;
  float g2 = 0.f;
  float q2 = 0.f;  // threads tid < QB: norm of query q0 + tid

  for (int k0 = 0; k0 < d; k0 += DK) {
    if (vec4) {
#pragma unroll
      for (int i = 0; i < DK / 4; ++i) {
        const int f = tid + i * TG;
        const int r = f / (DK / 4);
        const int c = (f % (DK / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g0 + r < ng && k0 + c < d)
          v = __ldg(reinterpret_cast<const float4*>(g + (size_t)(g0 + r) * d + k0 + c));
        *reinterpret_cast<float4*>(gs + r * GS + c) = v;
      }
    } else {
      for (int i = 0; i < DK; ++i) {
        const int f = tid + i * TG;
        const int r = f / DK;
        const int c = f % DK;
        float v = 0.f;
        if (g0 + r < ng && k0 + c < d) v = __ldg(g + (size_t)(g0 + r) * d + k0 + c);
        gs[r * GS + c] = v;
      }
    }
    for (int f = tid; f < QB * DK; f += TG) {
      const int r = f / DK;
      const int c = f % DK;
      float v = 0.f;
      if (q0 + r < nq && k0 + c < d) v = __ldg(q + (size_t)(q0 + r) * d + k0 + c);
      qs[f] = v;
    }
    __syncthreads();

    if (tid < QB) {
      for (int c = 0; c < DK; ++c) q2 = fmaf(qs[tid * DK + c], qs[tid * DK + c], q2);
    }
#pragma unroll
    for (int c = 0; c < DK; c += 4) {
      const float4 gv = *reinterpret_cast<const float4*>(gs + tid * GS + c);
      g2 = fmaf(gv.x, gv.x, g2);
      g2 = fmaf(gv.y, gv.y, g2);
      g2 = fmaf(gv.z, gv.z, g2);
      g2 = fmaf(gv.w, gv.w, g2);
#pragma unroll
      for (int i = 0; i < QB; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + i * DK + c);
        acc[i] = fmaf(gv.x, qv.x, acc[i]);
        acc[i] = fmaf(gv.y, qv.y, acc[i]);
        acc[i] = fmaf(gv.z, qv.z, acc[i]);
        acc[i] = fmaf(gv.w, qv.w, acc[i]);
      }
    }
    __syncthreads();
  }

  if (tid < QB) q2s[tid] = q2;
  __syncthreads();
  const int row = g0 + tid;
  if (row < ng) {
#pragma unroll
    for (int i = 0; i < QB; ++i) {
      if (q0 + i < nq)
        out[(size_t)(q0 + i) * ng + row] = fmaxf(q2s[i] + g2 - 2.f * acc[i], 0.f);
    }
  }
}

}  // namespace

// q [nq,d], g [ng,d] fp32 row-major contiguous; out [nq,ng] fp32. Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sq_l2_launch(const void* q, const void* g, void* out, int nq,
                            int ng, int d, void* stream) {
  if (nq <= 0 || ng <= 0 || d < 0) return (int)cudaErrorInvalidValue;
  const int vec4 = (d % 4 == 0) && ((uintptr_t)g % 16 == 0);
  const dim3 grid((ng + TG - 1) / TG, (nq + QB - 1) / QB);
  sq_l2_kernel<<<grid, TG, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(g),
      static_cast<float*>(out), nq, ng, d, vec4);
  return (int)cudaGetLastError();
}
