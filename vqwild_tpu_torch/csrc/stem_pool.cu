// K2: the folded yuv-s2d stem block in one pass.
//     x [N,H,W,C] NHWC, w [16C,64] ((i,j,c) rows: the HWIO [4,4,C,64] stem
//     kernel reshaped), b [64]  ->  out [N,H/2,W/2,64] NHWC:
//     4x4/1 conv with pad ((2,1),(2,1)), + bias, ReLU, 3x3/2 maxpool with
//     pad 1 and a -inf border. fp32 or bf16 in and out; the conv
//     accumulates and pools in fp32 and casts once, at the write.
//
// Replaces: vqwild_tpu/ops/pallas_kernels.py stem_s2d_pool_pallas (kernel
// body _stem_pool_kernel), the fused stem of models/fold.py's
// ResNet18F2FInfer(stem_mode="yuv_s2d").
//
// What bounds it on an H100: in fp32, operations. At the serving batch
// (N = 30 clips x 32 frames = 960, H = W = 56, C = 6) the conv is
// 2*N*H*W*16C*64 = 37 GFLOP of fp32 FMA (~0.55 ms at 67 TFLOP/s); the
// bytes it must move are the 72 MB input and the 193 MB pooled output
// (~79 us at 3.35 TB/s). Unfused, the [N,56,56,64] pre-pool activation
// would add 771 MB of writes and 771 MB of reads.
//
// What the design does about it: the pre-pool activation never leaves the
// SM, and each conv output is computed once per tile (the 3x3/2 pool's
// one-row halo costs 1/8 extra). One block owns one frame and TP = 4
// pooled rows, i.e. 2*TP+1 = 9 conv rows. It stages the 12 input rows
// those need (zero-padded to W+3 columns) and the weights in shared memory
// as fp32. Each thread owns one column and 8 output channels and keeps all
// 9 conv rows x 8 channels in registers: per (tap, channel) it reads two
// float4 of weights and nine inputs for 72 FMAs. Bias, ReLU and the row
// max happen in registers; only the row-pooled [TP,W,64] tile goes to
// shared memory, and the column max is taken from there while writing the
// output with coalesced stores. Because ReLU makes every candidate >= 0, a
// conv position outside the frame is read as 0, which is what the -inf
// border gives once the center position (always inside) is in the max.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TP = 4;           // pooled rows per block
constexpr int CR = 2 * TP + 1;  // conv rows per block
constexpr int OC = 64;          // output channels
constexpr int CG = 8;           // output channels per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ inline int xs_floats(int W, int C) {
  return (((CR + 3) * (W + 3) * C) + 3) & ~3;  // keeps the next array 16-byte aligned
}

template <typename T>
__global__ void stem_pool_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                 const T* __restrict__ b, T* __restrict__ out,
                                 int H, int W, int C) {
  extern __shared__ __align__(16) float smem[];
  const int PH = H / 2, PW = W / 2;
  const int K = 16 * C;
  const int XW = W + 3;
  float* ws = smem;                   // [K][OC]
  float* xs = ws + K * OC;            // [CR+3][W+3][C], zero padded
  float* rp = xs + xs_floats(W, C);   // [TP][W][OC], row-pooled

  const int n = blockIdx.x;
  const int ph0 = blockIdx.y * TP;
  const int r0 = 2 * ph0 - 1;  // first conv row of this tile
  const int tid = threadIdx.x;

  for (int i = tid; i < K * OC; i += blockDim.x) ws[i] = to_f(w[i]);
  const T* xn = x + (size_t)n * H * W * C;
  const int nxs = (CR + 3) * XW * C;
  for (int i = tid; i < nxs; i += blockDim.x) {
    const int c = i % C;
    const int rest = i / C;
    const int ic = rest % XW;
    const int ir = rest / XW;
    const int gr = r0 - 2 + ir;
    const int gc = ic - 2;
    float v = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W) v = to_f(xn[((size_t)gr * W + gc) * C + c]);
    xs[i] = v;
  }
  __syncthreads();

  const int grp = tid % CG;  // channels grp*CG .. grp*CG+CG-1
  float bias[CG];
#pragma unroll
  for (int q = 0; q < CG; ++q) bias[q] = to_f(b[grp * CG + q]);

  for (int col = tid / CG; col < W; col += blockDim.x / CG) {
    float acc[CR][CG];
#pragma unroll
    for (int r = 0; r < CR; ++r)
#pragma unroll
      for (int q = 0; q < CG; ++q) acc[r][q] = 0.f;

    for (int i = 0; i < 4; ++i) {
      for (int j = 0; j < 4; ++j) {
        for (int c = 0; c < C; ++c) {
          const float* wk = ws + ((i * 4 + j) * C + c) * OC + grp * CG;
          const float4 w0 = *reinterpret_cast<const float4*>(wk);
          const float4 w1 = *reinterpret_cast<const float4*>(wk + 4);
          const float* xp = xs + (i * XW + col + j) * C + c;
#pragma unroll
          for (int r = 0; r < CR; ++r) {
            const float xv = xp[r * XW * C];
            acc[r][0] = fmaf(xv, w0.x, acc[r][0]);
            acc[r][1] = fmaf(xv, w0.y, acc[r][1]);
            acc[r][2] = fmaf(xv, w0.z, acc[r][2]);
            acc[r][3] = fmaf(xv, w0.w, acc[r][3]);
            acc[r][4] = fmaf(xv, w1.x, acc[r][4]);
            acc[r][5] = fmaf(xv, w1.y, acc[r][5]);
            acc[r][6] = fmaf(xv, w1.z, acc[r][6]);
            acc[r][7] = fmaf(xv, w1.w, acc[r][7]);
          }
        }
      }
    }

    // bias + ReLU + 3-row max; pooled row p covers conv rows 2p..2p+2 of the tile
#pragma unroll
    for (int p = 0; p < TP; ++p) {
      float m[CG];
#pragma unroll
      for (int q = 0; q < CG; ++q) m[q] = 0.f;  // ReLU floor
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
        const int gr = r0 + 2 * p + dr;
        if (gr >= 0 && gr < H) {
#pragma unroll
          for (int q = 0; q < CG; ++q) m[q] = fmaxf(m[q], acc[2 * p + dr][q] + bias[q]);
        }
      }
      float* dst = rp + (p * W + col) * OC + grp * CG;
      *reinterpret_cast<float4*>(dst) = make_float4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(m[4], m[5], m[6], m[7]);
    }
  }
  __syncthreads();

  // 3-column max and the one write of the output tile
  const int np = min(TP, PH - ph0);
  for (int i = tid; i < np * PW * OC; i += blockDim.x) {
    const int o = i % OC;
    const int rest = i / OC;
    const int pw = rest % PW;
    const int p = rest / PW;
    const float* row = rp + p * W * OC;
    float m = row[(2 * pw) * OC + o];
    if (2 * pw - 1 >= 0) m = fmaxf(m, row[(2 * pw - 1) * OC + o]);
    if (2 * pw + 1 < W) m = fmaxf(m, row[(2 * pw + 1) * OC + o]);
    out[(((size_t)n * PH + ph0 + p) * PW + pw) * OC + o] = from_f<T>(m);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* out, int N, int H,
           int W, int C, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)16 * C * OC + xs_floats(W, C) + (size_t)TP * W * OC);
  cudaError_t err = cudaFuncSetAttribute(
      stem_pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int cols = W < 64 ? W : 64;
  const int threads = ((cols * CG + 31) / 32) * 32;
  const dim3 grid(N, (H / 2 + TP - 1) / TP);
  stem_pool_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(out), H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N,H,W,C], w [16C,64], b [64], out [N,H/2,W/2,64], all contiguous and of
// one dtype: dtype 0 = fp32, 1 = bf16. H and W even. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int stem_s2d_pool_launch(const void* x, const void* w, const void* b,
                                    void* out, int N, int H, int W, int C,
                                    int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w, b, out, N, H, W, C, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, b, out, N, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
