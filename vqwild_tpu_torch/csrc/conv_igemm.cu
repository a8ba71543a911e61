// K3: the trunk's block convolutions, fp32, on the tensor cores: one
//     implicit-GEMM kernel family for the forward pass, the input gradient
//     and the weight gradient of a bias-free 2D conv over NHWC activations
//     (square R x R kernel, stride 1 or 2, symmetric zero padding).
//
// Replaces no TPU kernel: the JAX package leaves convolutions to XLA, and
// the port left them to cuDNN. It was added because cuDNN runs an fp32
// conv with TF32 off (the configuration's precision) on the CUDA cores:
// the trunk's block convs there reach ~30 TFLOP/s, under the card's 67
// TFLOP/s fp32 FMA rate, and took ~75-80 of a ~107 ms train step.
//
// Arithmetic: three error-compensated TF32 passes, as K1 and K2. Each
// operand v is split into hi = tf32(v) and lo = tf32(v - hi) (cvt.rna),
// and a_lo*b_hi, a_hi*b_lo, a_hi*b_hi go in that order into fp32
// accumulators (the dropped lo*lo term is ~2^-22 relative). No one-pass
// path exists.
//
// The three passes as GEMMs (rows M, columns N, depth K):
//  - forward:  M = N*P*Q output pixels, N = Cout, K = R*S*Cin; A is the
//    input gathered by tap (padding and stride predicated in the gather,
//    no im2col in device memory), B the weight as [Cout][R*S*Cin].
//  - input gradient: the same kernel over dy with the weight rotated by
//    180 degrees and its channels swapped ([Cin][R*S*Cout]). At stride 2
//    the output splits into its four (row, column) parity classes, each a
//    stride-1 problem over its own taps; a class with no tap (the 1x1/2
//    downsample's odd positions) is written as zeros. No zero-inserted dy.
//  - weight gradient: M = Cout, N = R*S*Cin, K = N*P*Q pixels; A is dy read
//    row by row, B the input gathered by tap. K runs to 752,640 in layer1,
//    so it is split over blocks; each split writes its own partial sums,
//    and a second kernel adds them in split order into the [Cout][Cin][R][S]
//    gradient: no float atomics, so a run repeats bit for bit.
//
// What bounds it on an H100: operations. A 3x3 block conv of the train
// step is 27-72 GFLOP a pass against 10-100 MB of operands; at 3xTF32 the
// tensor cores give 165 TFLOP/s of fp32 work, so a pass is 0.2-0.45 ms of
// operations and 0.01-0.05 ms of bytes. mma.sync reaches ~285 of the 495
// TF32 TFLOP/s on this card, and a first mma.sync version of this kernel
// ~28% of the 3xTF32 bound; wgmma is the way to the rest.
//
// What the design does about it:
//  - wgmma m64nNk8 TF32 (N = 128 or 64), two warpgroups a block. A comes
//    from registers: a warp loads its m16 slice of the staged A tile
//    (ldmatrix, or 32-bit loads from an M-major tile) and splits it there.
//    B comes from shared memory through a descriptor, as hi and lo tiles
//    in the 128-byte-swizzled K-major layout: the weights are split once a
//    call, by a small kernel, into hi and lo arrays in the order the
//    forward and input-gradient kernels copy; the weight gradient's B (the
//    gathered input, N-major as it arrives) is split and transposed into
//    that layout by the block, a stage at a time.
//  - The tensor cores add a product into an fp32 accumulator with their own
//    alignment and truncation, not round to nearest, an error that grows
//    with the accumulator's magnitude (3e-5 of the largest entry at K =
//    4,608 when one accumulator runs through the whole K). So each 32-deep
//    stage's products go into a fresh accumulator, which the running sum
//    takes with a plain fp32 add: the error is then that of fp32 (3e-7 to
//    9e-7 against float64, as cuDNN's fp32 reads).
//  - A 3-stage cp.async pipeline of 32-deep K tiles: 16-byte copies,
//    zero-filled where the gather falls in the padding or past the edge.
//    The staged A tiles are padded (K-major rows of 36 floats, M-major rows
//    of BM + 8) so that a warp's fragment loads hit 32 distinct banks.
//  - No integer division in the loop: a thread decodes its gather rows
//    once and moves them on a stage at a time (the weight gradient's two
//    divisions a row a stage had cost it a quarter of its time).
//  - Tile shape and split count are chosen from the shapes: 128 x 128 where
//    the output columns (forward, input gradient) or output channels
//    (weight gradient) come in 128s, 256 x 64 or 64 x 128 for 64 of them;
//    the weight gradient's split count from a cost model over the card's
//    SM count and the kernel's occupancy (waves of blocks against the
//    partial sums' traffic).

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int BK = 32;  // K depth of a pipeline stage
constexpr int STAGES = 3;
constexpr int MAX_TAPS = 9;  // up to 3 x 3
constexpr int MAX_SUB = 4;   // parity classes of a stride-2 input gradient

// 16 bytes from global to shared memory, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = smem_u32(dst);
  const int nbytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(nbytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Forward and input gradient: out[m, n] = sum_k A[m, k] B[n, k] with
// m = (image, i, j) over an M grid, k = (tap, channel), A[m, (t, c)] =
// x[image, i*xs + dh[t], j*xs + dw[t], c] (zero outside), and out written at
// y[image, i*ys + yoh, j*ys + yow, n].

struct Sub {
  const float* b_hi;  // [ncol][T*kc], the weight's tf32 high part
  const float* b_lo;  // the low part
  int T;              // taps
  int mh, mw;         // M grid of an image
  int yoh, yow;       // output offset
  int dh[MAX_TAPS], dw[MAX_TAPS];  // input offset of each tap
  int tap[MAX_TAPS];               // r*R + s of each tap, for the weight's prep
};

struct FpropArgs {
  const float* x;  // [nimg, ih, iw, kc]
  float* y;        // [nimg, yh, yw, ncol]
  int nimg, ih, iw, kc;
  int yh, yw, ncol;
  int xs, ys;
  int nsub;
  Sub sub[MAX_SUB];
};

// The kernel: two warpgroups, each MW m64 tiles of rows, against BN columns.

template <int BN, int MW>
struct FpropCfg {
  static constexpr int BM = 128 * MW, THREADS = 256;  // MW m64 tiles a warpgroup
  static constexpr int LDA = BK + 4;
  static constexpr int A_STAGE = BM * LDA;        // floats
  static constexpr int B_BYTES = BN * BK * 4;     // one swizzled tile
  static constexpr int A_CH = BM * (BK / 4) / THREADS;
  static constexpr int B_CH = BN * (BK / 4) / THREADS;
  static constexpr size_t SMEM = 1024 + STAGES * (2 * (size_t)B_BYTES + A_STAGE * 4);
};

template <int BN, int MW>
__global__ void __launch_bounds__(256, 1) fprop_kernel(const FpropArgs args) {
  using C = FpropCfg<BN, MW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* base = smem_raw + pad;
  unsigned char* sBh = base;
  unsigned char* sBl = base + STAGES * C::B_BYTES;
  float* sA = reinterpret_cast<float*>(base + 2 * STAGES * C::B_BYTES);
  const uint32_t sBh_s = raw + pad, sBl_s = raw + pad + STAGES * C::B_BYTES;
  __shared__ int s_dh[MAX_TAPS], s_dw[MAX_TAPS];

  const float* b_hi = nullptr;
  const float* b_lo = nullptr;
  int T = 0, mh = 1, mw = 1, yoh = 0, yow = 0;
#pragma unroll
  for (int i = 0; i < MAX_SUB; ++i)
    if (i == (int)blockIdx.z) {
      const Sub& s = args.sub[i];
      b_hi = s.b_hi; b_lo = s.b_lo; T = s.T; mh = s.mh; mw = s.mw; yoh = s.yoh; yow = s.yow;
      if (threadIdx.x < MAX_TAPS) {
#pragma unroll
        for (int t = 0; t < MAX_TAPS; ++t)
          if (t == (int)threadIdx.x) { s_dh[t] = s.dh[t]; s_dw[t] = s.dw[t]; }
      }
    }
  const int mhw = mh * mw;
  const int M = args.nimg * mhw;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * BN;
  if (m0 >= M) return;
  __syncthreads();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // this warp's 16 rows of each of its warpgroup's MW m64 tiles
  const int wrow = (warp >> 2) * 64 * MW + (warp & 3) * 16;
  const int kc = args.kc, IH = args.ih, IW = args.iw;
  const int kcb = kc / BK;
  const int KT = T * kcb;
  const int Ktot = T * kc;
  const float* __restrict__ x = args.x;

  const int cc = tid & 7;
  const float* a_base[C::A_CH];  // this thread's 16 bytes of the row's pixel, tap (0, 0)
  int a_ih[C::A_CH], a_iw[C::A_CH];
#pragma unroll
  for (int i = 0; i < C::A_CH; ++i) {
    const int m = m0 + (tid >> 3) + i * (C::THREADS / 8);
    if (m < M) {
      const int img = m / mhw, rem = m - img * mhw, oi = rem / mw, oj = rem - oi * mw;
      a_ih[i] = oi * args.xs;
      a_iw[i] = oj * args.xs;
      a_base[i] = x + ((size_t)img * IH * IW + a_ih[i] * IW + a_iw[i]) * kc + cc * 4;
    } else {
      a_base[i] = x;
      a_ih[i] = -(1 << 28);
      a_iw[i] = 0;
    }
  }
  size_t b_off[C::B_CH];
  bool b_ok[C::B_CH];
  uint32_t b_dst[C::B_CH];  // byte offset in a swizzled tile
#pragma unroll
  for (int i = 0; i < C::B_CH; ++i) {
    const int r = (tid >> 3) + i * (C::THREADS / 8);
    const int n = n0 + r;
    b_ok[i] = n < args.ncol;
    b_off[i] = b_ok[i] ? (size_t)n * Ktot + cc * 4 : 0;
    b_dst[i] = r * 128 + ((cc ^ (r & 7)) << 4);
  }

  // the tap and channel block of the next stage to load (stages load in order)
  int ld_tap = 0, ld_cb = 0;
  auto load_stage = [&](int stage, int kt) {
    const int dh = s_dh[ld_tap], dw = s_dw[ld_tap];
    const int toff = (dh * IW + dw) * kc + ld_cb * BK;
    if (++ld_cb == kcb) { ld_cb = 0; ++ld_tap; }
    float* dA = sA + stage * C::A_STAGE;
#pragma unroll
    for (int i = 0; i < C::A_CH; ++i) {
      const int ih = a_ih[i] + dh, iw = a_iw[i] + dw;
      const bool ok = (unsigned)ih < (unsigned)IH && (unsigned)iw < (unsigned)IW;
      cp_async16(dA + ((tid >> 3) + i * (C::THREADS / 8)) * C::LDA + cc * 4,
                 ok ? a_base[i] + toff : x, ok);
    }
    const size_t koff = (size_t)kt * BK;
#pragma unroll
    for (int i = 0; i < C::B_CH; ++i) {
      const size_t off = b_off[i] + koff;
      cp_async16(reinterpret_cast<float*>(sBh + stage * C::B_BYTES + b_dst[i]),
                 b_ok[i] ? b_hi + off : b_hi, b_ok[i]);
      cp_async16(reinterpret_cast<float*>(sBl + stage * C::B_BYTES + b_dst[i]),
                 b_ok[i] ? b_lo + off : b_lo, b_ok[i]);
    }
  };

  float acc[MW][BN / 2], part[MW][BN / 2];
#pragma unroll
  for (int w = 0; w < MW; ++w)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[w][i] = part[w][i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  const int li = lane & 7, lm = (lane >> 3) & 1, lh = lane >> 4;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    fence_async_shared();  // the copies, seen by the wgmma's reads
    __syncthreads();  // stage kt landed for all; stage kt-1 is free again
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk);
    cp_async_commit();

    const int stage = kt % STAGES;
    const float* a = sA + stage * C::A_STAGE + (wrow + li + 8 * lm) * C::LDA + 4 * lh;
    uint32_t ahi[MW][BK / 8][4], alo[MW][BK / 8][4];
#pragma unroll
    for (int w = 0; w < MW; ++w)
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        uint32_t r[4];
        ldsm4(r, smem_u32(a + w * 64 * C::LDA + ks * 8));
#pragma unroll
        for (int q = 0; q < 4; ++q) split(__uint_as_float(r[q]), ahi[w][ks][q], alo[w][ks][q]);
      }
#pragma unroll
    for (int w = 0; w < MW; ++w)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) keep(part[w][i]);
    wg_fence();
    const uint32_t bh = sBh_s + stage * C::B_BYTES, bl = sBl_s + stage * C::B_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
      for (int w = 0; w < MW; ++w) {
        wgmma_t<BN>(part[w], alo[w][ks], sw128_desc(bh + ks * 32), ks > 0);
        wgmma_t<BN>(part[w], ahi[w][ks], sw128_desc(bl + ks * 32), 1);
        wgmma_t<BN>(part[w], ahi[w][ks], sw128_desc(bh + ks * 32), 1);
      }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int w = 0; w < MW; ++w) {
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) { keep(ahi[w][ks][q]); keep(alo[w][ks][q]); }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        keep(part[w][i]);
        acc[w][i] += part[w][i];
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int w = 0; w < MW; ++w)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wrow + w * 64 + h * 8 + g;
      if (m >= M) continue;
      const int img = m / mhw, rem = m - img * mhw, oi = rem / mw, oj = rem - oi * mw;
      float* yrow = args.y + (((size_t)img * args.yh + oi * args.ys + yoh) * args.yw +
                              oj * args.ys + yow) * args.ncol;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + j * 8 + 2 * t4;
        if (n < args.ncol)
          *reinterpret_cast<float2*>(yrow + n) =
              make_float2(acc[w][4 * j + 2 * h], acc[w][4 * j + 2 * h + 1]);
      }
    }
}

// The weight of every sub-problem into its [ncol][T*kc] hi and lo arrays:
// B[col][t*kc + k] = w[o][i][tap t] with (o, i) = (col, k) for the forward
// and (k, col) for the input gradient; w is [Cout][Cin][R*R].
__global__ void prep_weights(FpropArgs args, const float* __restrict__ w, int cin, int rr,
                             int trans) {
  const Sub* sp = nullptr;
#pragma unroll
  for (int i = 0; i < MAX_SUB; ++i)
    if (i == (int)blockIdx.y) sp = &args.sub[i];
  // (a pointer into the parameters: read through generic loads, once per thread)
  const int T = sp->T, kc = args.kc, ncol = args.ncol;
  const int total = ncol * T * kc;
  float* hi = const_cast<float*>(sp->b_hi);
  float* lo = const_cast<float*>(sp->b_lo);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += gridDim.x * blockDim.x) {
    const int col = e / (T * kc), rem = e - col * (T * kc), t = rem / kc, k = rem - t * kc;
    const int o = trans ? k : col, i = trans ? col : k;
    const float v = w[((size_t)o * cin + i) * rr + sp->tap[t]];
    const float h = __uint_as_float(tf32_rna(v));
    hi[e] = h;
    lo[e] = __uint_as_float(tf32_rna(v - h));
  }
}

// ---------------------------------------------------------------------------
// Weight gradient: ws[split][m][n] = sum over this split's pixels k of
// dy[k, m] * x[image, p*stride - pad + r, q*stride - pad + s, c] with
// n = (r*R + s)*Cin + c.

struct WgradArgs {
  const float* x;   // [nimg, H, W, cin]
  const float* dy;  // [nimg, P, Q, cout]
  float* ws;        // [splits][cout][R*R*cin]
  int nimg, H, W, cin, P, Q, cout, R, stride, pad;
  int kt_split;  // K tiles a split
};

// The kernel: two warpgroups, each a 64 x TN tile (WM of them down the
// output channels, 2/WM across the taps' columns). A (dy) in registers from
// its M-major staged tile; B (the gathered input) staged as it arrives,
// N-major, then split and transposed by the block into hi and lo tiles in
// the swizzled K-major layout a wgmma descriptor reads. The 64-channel tile
// (WM = 1) fits in 128 registers a thread, so two blocks share an SM and
// one's products run while the other copies, converts and adds.

template <int BM, int BN, int WM>
struct WgradCfg {
  static constexpr int THREADS = 256, WN = 2 / WM, TN = BN / WN;
  static constexpr int LDA = BM + 8;  // dy staging [BK][BM + 8]: conflict-free fragments
  static constexpr int A_STAGE = BK * LDA, B_STAGE = BK * BN;  // floats
  static constexpr int CONV_BYTES = BN * BK * 4;                // one swizzled tile
  static constexpr int A_CPR = BM / 4, B_CPR = BN / 4;          // 16-byte copies a row
  static constexpr int A_RPP = THREADS / A_CPR, B_RPP = THREADS / B_CPR;
  static constexpr int A_CH = BK / A_RPP, B_CH = BK / B_RPP;
  static constexpr int CONV_ITEMS = BN * (BK / 4) / THREADS;  // 4-deep columns a thread
  static constexpr size_t SMEM =
      1024 + 2 * (size_t)CONV_BYTES + sizeof(float) * STAGES * (size_t)(A_STAGE + B_STAGE);
  static_assert(BM == 64 * WM && (WM == 1 || WM == 2) && TN % 8 == 0, "warpgroup tiles");
  static_assert(THREADS % A_CPR == 0 && THREADS % B_CPR == 0, "a thread keeps its column");
  static_assert(A_CH * A_RPP == BK && B_CH * B_RPP == BK, "copies");
  static_assert(CONV_ITEMS * THREADS == BN * (BK / 4), "conversion");
};

template <int BM, int BN, int WM>
__global__ void __launch_bounds__(256, WM == 1 ? 2 : 1) wgrad_kernel(const WgradArgs args) {
  using C = WgradCfg<BM, BN, WM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* base = smem_raw + pad;
  unsigned char* cHi = base;
  unsigned char* cLo = base + C::CONV_BYTES;
  float* sB = reinterpret_cast<float*>(base + 2 * C::CONV_BYTES);
  float* sA = sB + STAGES * C::B_STAGE;
  const uint32_t cHi_s = raw + pad, cLo_s = raw + pad + C::CONV_BYTES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;
  const int wm = (WM == 2 ? wg : 0) * 64 + (warp & 3) * 16;  // this warp's 16 rows
  const int wn = (WM == 2 ? 0 : wg) * C::TN;                 // its warpgroup's columns
  const int M = args.cout, N = args.R * args.R * args.cin;
  const int PQ = args.P * args.Q, K = args.nimg * PQ;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = cdiv(K, BK);
  const int kt0 = blockIdx.z * args.kt_split;
  const int nkt = imax(0, imin(KT, kt0 + args.kt_split) - kt0);
  const float* __restrict__ x = args.x;
  const float* __restrict__ dy = args.dy;

  const int a_col = m0 + (tid % C::A_CPR) * 4;
  const bool a_colok = a_col < M;
  const int b_n = n0 + (tid % C::B_CPR) * 4;
  const bool b_colok = b_n < N;
  int b_dh = 0, b_dw = 0, b_c = 0;
  if (b_colok) {
    const int tap = b_n / args.cin;
    b_c = b_n - tap * args.cin;
    b_dh = tap / args.R - args.pad;
    b_dw = tap % args.R - args.pad;
  }

  // the (image, p, q) of each pixel row this thread gathers, for the next
  // stage to load: decoded once, then moved on BK pixels a stage (stages
  // load in order)
  int r_img[C::B_CH], r_p[C::B_CH], r_q[C::B_CH];
#pragma unroll
  for (int i = 0; i < C::B_CH; ++i) {
    const int k = kt0 * BK + tid / C::B_CPR + i * C::B_RPP;
    r_img[i] = k / PQ;
    const int rem = k - r_img[i] * PQ;
    r_p[i] = rem / args.Q;
    r_q[i] = rem - r_p[i] * args.Q;
  }
  const int step_img = BK / PQ, step_p = (BK % PQ) / args.Q, step_q = (BK % PQ) % args.Q;

  auto load_stage = [&](int stage, int kt) {
    float* dA = sA + stage * C::A_STAGE;
    float* dB = sB + stage * C::B_STAGE;
#pragma unroll
    for (int i = 0; i < C::A_CH; ++i) {
      const int row = tid / C::A_CPR + i * C::A_RPP;
      const int k = kt * BK + row;
      const bool ok = a_colok && k < K;
      cp_async16(dA + row * C::LDA + (tid % C::A_CPR) * 4,
                 ok ? dy + (size_t)k * M + a_col : dy, ok);
    }
#pragma unroll
    for (int i = 0; i < C::B_CH; ++i) {
      const int ih = r_p[i] * args.stride + b_dh, iw = r_q[i] * args.stride + b_dw;
      const bool ok = b_colok && r_img[i] < args.nimg && (unsigned)ih < (unsigned)args.H &&
                      (unsigned)iw < (unsigned)args.W;
      const float* src =
          ok ? x + (((size_t)r_img[i] * args.H + ih) * args.W + iw) * args.cin + b_c : x;
      cp_async16(dB + (tid / C::B_CPR + i * C::B_RPP) * BN + (tid % C::B_CPR) * 4, src, ok);
      // the same row of the next stage, BK pixels on
      r_q[i] += step_q;
      r_p[i] += step_p;
      if (r_q[i] >= args.Q) { r_q[i] -= args.Q; ++r_p[i]; }
      r_img[i] += step_img;
      if (r_p[i] >= args.P) { r_p[i] -= args.P; ++r_img[i]; }
    }
  };

  float acc[C::TN / 2], part[C::TN / 2];
#pragma unroll
  for (int i = 0; i < C::TN / 2; ++i) acc[i] = part[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) load_stage(s, kt0 + s);
    cp_async_commit();
  }
  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `it` landed for all; the last products are done
    const int stage = it % STAGES;

    // B: split and transpose into the swizzled K-major hi and lo tiles; a
    // thread takes 4 depths of one column at a time
    const float* b = sB + stage * C::B_STAGE;
#pragma unroll
    for (int i = 0; i < C::CONV_ITEMS; ++i) {
      const int id = tid + i * C::THREADS, n = id % BN, k4 = id / BN;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(b[(4 * k4 + e) * BN + n], hi[e], lo[e]);
      const int off = n * 128 + ((k4 ^ (n & 7)) << 4);
      *reinterpret_cast<uint4*>(cHi + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(cLo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    // A: this warp's fragments of dy, split
    const float* a = sA + stage * C::A_STAGE + t4 * C::LDA + wm + g;
    uint32_t ahi[BK / 8][4], alo[BK / 8][4];
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const float* p = a + ks * 8 * C::LDA;
      split(p[0], ahi[ks][0], alo[ks][0]);
      split(p[8], ahi[ks][1], alo[ks][1]);
      split(p[4 * C::LDA], ahi[ks][2], alo[ks][2]);
      split(p[4 * C::LDA + 8], ahi[ks][3], alo[ks][3]);
    }
    fence_async_shared();  // the transposed tiles, seen by the wgmma's reads
    __syncthreads();
#pragma unroll
    for (int i = 0; i < C::TN / 2; ++i) keep(part[i]);
    wg_fence();
    const uint32_t bh = cHi_s + wn * 128, bl = cLo_s + wn * 128;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      wgmma_t<C::TN>(part, alo[ks], sw128_desc(bh + ks * 32), ks > 0);
      wgmma_t<C::TN>(part, ahi[ks], sw128_desc(bl + ks * 32), 1);
      wgmma_t<C::TN>(part, ahi[ks], sw128_desc(bh + ks * 32), 1);
    }
    wg_commit();
    const int nk = it + STAGES - 1;
    if (nk < nkt) load_stage(nk % STAGES, kt0 + nk);
    cp_async_commit();
    wg_wait0();
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) { keep(ahi[ks][q]); keep(alo[ks][q]); }
#pragma unroll
    for (int i = 0; i < C::TN / 2; ++i) {
      keep(part[i]);
      acc[i] += part[i];
    }
  }
  cp_async_wait<0>();

  float* out = args.ws + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wm + h * 8 + g;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < C::TN / 8; ++j) {
      const int n = n0 + wn + j * 8 + 2 * t4;
      if (n < N)
        *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// dw[o][c][tap] = sum over splits, in split order, of ws[split][o][tap*cin + c]
__global__ void wgrad_reduce(const float* __restrict__ ws, float* __restrict__ dw, int splits,
                             int cout, int cin, int rr) {
  const int N = rr * cin;
  const size_t total = (size_t)cout * N, plane = total;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = ws[e];
    for (int sp = 1; sp < splits; ++sp) s += ws[sp * plane + e];
    const int o = (int)(e / N), n = (int)(e - (size_t)o * N), tap = n / cin, c = n - tap * cin;
    dw[((size_t)o * cin + c) * rr + tap] = s;
  }
}

// ---------------------------------------------------------------------------
// Host side (the per-device facts are wgmma_tf32.cuh's).

template <int BN, int MW>
int launch_fprop(const FpropArgs& a, int mmax, cudaStream_t stream, int dev) {
  using C = FpropCfg<BN, MW>;
  static bool done[MAX_DEV];
  static int per_sm[MAX_DEV];
  int rc = configure(fprop_kernel<BN, MW>, dev, C::SMEM, C::THREADS, done, per_sm);
  if (rc) return rc;
  const dim3 grid(cdiv(a.ncol, BN), cdiv(mmax, C::BM), a.nsub);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  fprop_kernel<BN, MW><<<grid, C::THREADS, C::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// Forward (trans = 0) or input gradient (trans = 1), weight prep included.
int run_fprop(FpropArgs& a, const float* w, float* wbuf, int cin, int rr, int trans,
              cudaStream_t stream) {
  int dev = 0, sms = 0;
  int rc = device_info(&dev, &sms);
  if (rc) return rc;
  float* at = wbuf;
  int mmax = 0, maxel = 0;
  for (int i = 0; i < a.nsub; ++i) {
    Sub& s = a.sub[i];
    const int el = a.ncol * s.T * a.kc;
    s.b_hi = at;
    s.b_lo = at + el;
    at += 2 * el;
    if (el > maxel) maxel = el;
    if (a.nimg * s.mh * s.mw > mmax) mmax = a.nimg * s.mh * s.mw;
  }
  if (maxel > 0) {
    const dim3 grid(imin(cdiv(maxel, 256), 4 * sms), a.nsub);
    prep_weights<<<grid, 256, 0, stream>>>(a, w, cin, rr, trans);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.ncol % 128 == 0) return launch_fprop<128, 1>(a, mmax, stream, dev);
  return launch_fprop<64, 2>(a, mmax, stream, dev);
}

bool bad_geometry(int N, int H, int W, int C, int K, int R, int stride, int pad) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || K <= 0 || R <= 0 || R * R > MAX_TAPS) return true;
  if (C % BK || K % BK || (stride != 1 && stride != 2) || pad < 0 || pad >= R) return true;
  const int P = (H + 2 * pad - R) / stride + 1, Q = (W + 2 * pad - R) / stride + 1;
  if (P <= 0 || Q <= 0) return true;
  // the kernels index in int
  const long big = 0x7fffffffL;
  return (long)N * H * W * C > big || (long)N * P * Q * K > big || (long)N * P * Q > big;
}

// Weight gradient: the tile shape and split count for a problem.
struct WgradPlan {
  int bm, bn, splits, kt_split;
};

template <int BM, int BN, int WM>
int wgrad_per_sm(int dev, int* per_sm_out) {
  using C = WgradCfg<BM, BN, WM>;
  static bool done[MAX_DEV];
  static int per_sm[MAX_DEV];
  int rc = configure(wgrad_kernel<BM, BN, WM>, dev, C::SMEM, C::THREADS, done, per_sm);
  *per_sm_out = per_sm[dev];
  return rc;
}

int plan_wgrad(int N, int H, int W, int C, int K, int R, int stride, int pad, WgradPlan* plan,
               int* dev_out) {
  int dev = 0, sms = 0;
  int rc = device_info(&dev, &sms);
  if (rc) return rc;
  const int P = (H + 2 * pad - R) / stride + 1, Q = (W + 2 * pad - R) / stride + 1;
  const int M = K, Ncol = R * R * C, KT = cdiv(N * P * Q, BK);
  const bool big = M % 128 == 0;  // else 64 output channels: one warpgroup tile down, two across
  plan->bm = big ? 128 : 64;
  plan->bn = 128;
  int per_sm = 0;
  rc = big ? wgrad_per_sm<128, 128, 2>(dev, &per_sm) : wgrad_per_sm<64, 128, 1>(dev, &per_sm);
  if (rc) return rc;
  const long slots = (long)sms * (per_sm > 0 ? per_sm : 1);
  const long tiles = (long)cdiv(M, plan->bm) * cdiv(Ncol, plan->bn);
  // cost in units of one block's K tile: waves of blocks times their K
  // tiles, plus the partial sums' write and read (a K tile of a block moves
  // (BM + BN) * BK floats in; a split's partial plane moves 2 * M * Ncol
  // floats over the whole card, at roughly the L2's rate per SM)
  const double plane = 2.0 * M * Ncol / ((double)(plan->bm + plan->bn) * BK * slots);
  int best = 1;
  double best_cost = 1e300;
  const int smax = KT < 256 ? KT : 256;
  for (int s = 1; s <= smax; ++s) {
    const int kts = cdiv(KT, s);
    const int used = cdiv(KT, kts);  // splits that get work
    if (used != s) continue;
    const double waves = (double)((tiles * s + slots - 1) / slots);
    const double cost = waves * kts + plane * s;
    if (cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  plan->splits = best;
  plan->kt_split = cdiv(KT, best);
  *dev_out = dev;
  return 0;
}

}  // namespace

// All tensors fp32, contiguous, 16-byte aligned, on the current device;
// x [N,H,W,C] NHWC, w [K][C][R][R] (the weight's OIHW storage), y and dy
// [N,P,Q,K] NHWC with P = (H + 2*pad - R)/stride + 1 (Q alike). C and K are
// multiples of 32, R*R <= 9, stride 1 or 2, 0 <= pad < R. `wbuf` holds
// 2*K*C*R*R floats of scratch (the weight's hi and lo parts). Each returns
// a cudaError_t (0 on success): a geometry the kernels do not take is
// cudaErrorInvalidValue, checked before anything is launched.

extern "C" int conv_fwd_launch(const void* x, const void* w, void* y, void* wbuf, int N, int H,
                               int W, int C, int K, int R, int stride, int pad, void* stream) {
  if (bad_geometry(N, H, W, C, K, R, stride, pad)) return (int)cudaErrorInvalidValue;
  FpropArgs a = {};
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.nimg = N; a.ih = H; a.iw = W; a.kc = C;
  a.yh = (H + 2 * pad - R) / stride + 1;
  a.yw = (W + 2 * pad - R) / stride + 1;
  a.ncol = K;
  a.xs = stride; a.ys = 1;
  a.nsub = 1;
  Sub& s = a.sub[0];
  s.T = R * R; s.mh = a.yh; s.mw = a.yw; s.yoh = 0; s.yow = 0;
  for (int r = 0; r < R; ++r)
    for (int c = 0; c < R; ++c) {
      const int t = r * R + c;
      s.dh[t] = r - pad; s.dw[t] = c - pad; s.tap[t] = t;
    }
  return run_fprop(a, static_cast<const float*>(w), static_cast<float*>(wbuf), C, R * R, 0,
                   (cudaStream_t)stream);
}

// dy [N,P,Q,K] -> dx [N,H,W,C]
extern "C" int conv_dgrad_launch(const void* dy, const void* w, void* dx, void* wbuf, int N,
                                 int H, int W, int C, int K, int R, int stride, int pad,
                                 void* stream) {
  if (bad_geometry(N, H, W, C, K, R, stride, pad)) return (int)cudaErrorInvalidValue;
  FpropArgs a = {};
  a.x = static_cast<const float*>(dy);
  a.y = static_cast<float*>(dx);
  a.nimg = N;
  a.ih = (H + 2 * pad - R) / stride + 1;
  a.iw = (W + 2 * pad - R) / stride + 1;
  a.kc = K;
  a.yh = H; a.yw = W; a.ncol = C;
  a.xs = 1; a.ys = stride;
  // one sub-problem per parity class of the output: rows h = stride*i + ph
  // take the taps r with ph + pad - r divisible by the stride, from dy row
  // i + (ph + pad - r)/stride
  a.nsub = 0;
  for (int ph = 0; ph < stride; ++ph)
    for (int pw = 0; pw < stride; ++pw) {
      Sub& s = a.sub[a.nsub];
      s.mh = (H - ph + stride - 1) / stride;
      s.mw = (W - pw + stride - 1) / stride;
      if (s.mh <= 0 || s.mw <= 0) continue;
      s.yoh = ph; s.yow = pw; s.T = 0;
      for (int r = 0; r < R; ++r)
        for (int c = 0; c < R; ++c) {
          const int eh = ph + pad - r, ew = pw + pad - c;
          if (eh % stride || ew % stride) continue;  // C++ remainder: 0 for -2 % 2
          s.dh[s.T] = eh / stride; s.dw[s.T] = ew / stride; s.tap[s.T] = r * R + c;
          ++s.T;
        }
      ++a.nsub;
    }
  return run_fprop(a, static_cast<const float*>(w), static_cast<float*>(wbuf), C, R * R, 1,
                   (cudaStream_t)stream);
}

// The floats of scratch conv_wgrad_launch needs for this geometry (its
// split count times K*R*R*C), or a negative cudaError_t.
extern "C" long conv_wgrad_workspace(int N, int H, int W, int C, int K, int R, int stride,
                                     int pad) {
  if (bad_geometry(N, H, W, C, K, R, stride, pad)) return -(long)cudaErrorInvalidValue;
  WgradPlan plan;
  int dev = 0;
  const int rc = plan_wgrad(N, H, W, C, K, R, stride, pad, &plan, &dev);
  if (rc) return -(long)rc;
  return (long)plan.splits * K * R * R * C;
}

// x [N,H,W,C], dy [N,P,Q,K] -> dw [K][C][R][R]; `ws` holds
// conv_wgrad_workspace(...) floats.
extern "C" int conv_wgrad_launch(const void* x, const void* dy, void* dw, void* ws, int N, int H,
                                 int W, int C, int K, int R, int stride, int pad, void* stream) {
  if (bad_geometry(N, H, W, C, K, R, stride, pad)) return (int)cudaErrorInvalidValue;
  WgradPlan plan;
  int dev = 0;
  int rc = plan_wgrad(N, H, W, C, K, R, stride, pad, &plan, &dev);
  if (rc) return rc;
  WgradArgs a;
  a.x = static_cast<const float*>(x);
  a.dy = static_cast<const float*>(dy);
  a.ws = static_cast<float*>(ws);
  a.nimg = N; a.H = H; a.W = W; a.cin = C; a.cout = K; a.R = R;
  a.stride = stride; a.pad = pad;
  a.P = (H + 2 * pad - R) / stride + 1;
  a.Q = (W + 2 * pad - R) / stride + 1;
  a.kt_split = plan.kt_split;
  cudaStream_t s = (cudaStream_t)stream;
  const int Ncol = R * R * C;
  const dim3 grid(cdiv(Ncol, plan.bn), cdiv(K, plan.bm), plan.splits);
  if (plan.bm == 128) {
    using Cf = WgradCfg<128, 128, 2>;
    wgrad_kernel<128, 128, 2><<<grid, Cf::THREADS, Cf::SMEM, s>>>(a);
  } else {
    using Cf = WgradCfg<64, 128, 1>;
    wgrad_kernel<64, 128, 1><<<grid, Cf::THREADS, Cf::SMEM, s>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long total = (long)K * Ncol;
  int dsms = 0;
  rc = device_info(&dev, &dsms);
  if (rc) return rc;
  const int blocks = (int)(total / 256 + 1 < 8L * dsms ? total / 256 + 1 : 8L * dsms);
  wgrad_reduce<<<blocks, 256, 0, s>>>(a.ws, static_cast<float*>(dw), plan.splits, K, C, R * R);
  return (int)cudaGetLastError();
}
