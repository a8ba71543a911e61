// K2: the folded yuv-s2d stem block in one pass, on the tensor cores.
//     x [N,H,W,C] NHWC, w [16C,64] ((i,j,c) rows: the HWIO [4,4,C,64] stem
//     kernel reshaped), b [64]  ->  out [N,H/2,W/2,64] NHWC:
//     4x4/1 conv with pad ((2,1),(2,1)), + bias, ReLU, 3x3/2 maxpool with
//     pad 1 and a -inf border. fp32 or bf16 in and out; the conv
//     accumulates and pools in fp32 and casts once, at the write.
//
// Replaces: vqwild_tpu/ops/pallas_kernels.py stem_s2d_pool_pallas (kernel
// body _stem_pool_kernel), the fused stem of models/fold.py's
// ResNet18F2FInfer(stem_mode="yuv_s2d"). The Pallas kernel is im2col + one
// matrix product on the TPU's matrix unit; this is the same product,
// [H*W, 16C] x [16C, 64] per frame, on Hopper's.
//
// What bounds it on an H100: operations. At the serving batch (N = 30 clips
// x 32 frames = 960, H = W = 56, C = 6) the product is 37 GFLOP. bf16 takes
// one tensor-core pass (0.037 ms at 989 TFLOP/s, under the 0.040 ms that the
// 24 MB input and the 96 MB output need at 3.35 TB/s). fp32 takes three
// TF32 passes, 111 GFLOP (0.224 ms at 495 TFLOP/s), which is still less
// than the 0.552 ms the same product needs on the fp32 FMA pipe. Unfused,
// the [N,56,56,64] pre-pool activation would add 771 MB of writes and
// 771 MB of reads. What this kernel reaches is set by mma.sync, which
// runs at about half the tensor cores' peak rate on this card: the fp32
// mma phase alone takes ~0.55 ms at the serving batch, the rest of the
// kernel ~0.2 ms on top (PERF.md has the measurements).
//
// What the design does about it:
//  - Implicit GEMM with mma.sync (m16n8k8 TF32, m16n8k16 bf16), written in
//    inline PTX. wgmma and TMA are not used: with K = 96 and N = 64 the cost
//    is feeding A from an im2col view of a 6-channel, 24-byte pixel, which
//    neither a wgmma shared-memory descriptor nor a TMA box expresses without
//    a materialised im2col buffer.
//  - fp32 keeps fp32 accuracy: x = hi + lo with hi = tf32(x), lo =
//    tf32(x - hi), and a_lo*b_hi + a_hi*b_lo + a_hi*b_hi go into the same
//    fp32 accumulators (the lo*lo term, ~2^-22 relative, is dropped).
//    Weights are split once when staged, inputs when a fragment is loaded.
//  - A comes straight from the staged input tile [rows][XW][Cp] (Cp = C
//    rounded up to even, the pad channel zero): the K index (i, j, c) of a
//    conv pixel sits at base(pixel) + i*XW*Cp + j*Cp + c, so a lane computes
//    the bases of its fragment rows once per warp pass and adds a K offset
//    from a small table. Conv pixels are indexed flat over the tile, so an
//    m16 tile may run across a row end.
//  - One persistent block per SM loops over (frame, 4 pooled rows, <= 28
//    pooled columns) work items. B is staged once per block, in fragment
//    order (one conflict-free 16-byte load gives a lane its registers for a
//    k-step and one or two n8 tiles). A warp holds 4 m16 tiles x 64 channels
//    (128 accumulators), so a B load serves 12 (fp32) or 8 (bf16) mma.
//  - The next item's input rows arrive by cp.async (16, 8 or 4 bytes a
//    copy, whatever the frame's alignment allows; zero-filled outside the
//    frame) while this one computes.
//  - Epilogue in fp32: bias and ReLU on the accumulators, the conv tile
//    [pixels][64] to shared memory (XOR-swizzled by 8-channel group, so the
//    fragment stores do not conflict), then the 3x3/2 max from there and
//    one cast at coalesced 16-byte stores. A tile holds only conv positions
//    inside the frame; since ReLU makes every candidate >= 0 and the centre
//    is always inside, leaving the outside ones out equals the -inf border.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OC = 64;              // output channels
constexpr int TP = 4;               // pooled rows per work item
constexpr int TQ_MAX = 28;          // pooled columns per work item, at most
constexpr int MT = 4;               // m16 tiles per warp pass
constexpr int WM = 16 * MT;         // conv pixels per warp pass
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

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

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Shared-memory layout, computed alike by the launcher and the kernel.
struct Layout {
  int Cp, Kp;        // channels padded to even, K = 16*Cp
  int XW;            // columns of the staged input tile
  int xs_elems;      // elements of one input buffer
  size_t cs_off, bs_off, xs_off, koff_off, bias_off, total;  // bytes
};

template <typename T>
__host__ __device__ inline Layout make_layout(int H, int W, int C, int TQ) {
  Layout L;
  L.Cp = (C + 1) & ~1;
  L.Kp = 16 * L.Cp;
  const int CRm = imin(2 * TP + 1, H), CCm = imin(2 * TQ + 1, W);
  L.XW = CCm + 3;
  while ((L.XW * L.Cp * sizeof(T)) % 16) ++L.XW;  // rows keep 16-byte alignment
  L.xs_elems = ((CRm + 3) * L.XW * L.Cp + 7) & ~7;
  size_t o = 0;
  L.cs_off = o;   o += (size_t)CRm * CCm * OC * sizeof(float);         // conv tile
  L.bs_off = o;   o += (size_t)L.Kp * OC * (sizeof(T) == 4 ? 8 : 2);   // B fragments
  L.xs_off = o;   o += 2 * (size_t)L.xs_elems * sizeof(T);             // two input tiles
  L.koff_off = o; o += (size_t)L.Kp * sizeof(int);
  L.bias_off = o; o += OC * sizeof(float);
  L.total = o;
  return L;
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// BYTES (4, 8 or 16) from global to shared memory, or BYTES of zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int nbytes = valid ? BYTES : 0;  // what is not read is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d), "l"(src), "n"(BYTES),
               "r"(nbytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One weight, K row kk (in the padded (i, j, c) order) and channel n, to its
// place in the fragment-ordered B. fp32, per (k8 step s, n8 tile jn, lane):
// {b0 hi, b1 hi, b0 lo, b1 lo} with b0 = B[8s + t][8jn + g], b1 = B[8s + t + 4][..].
// bf16, per (k16 step s, pair of n8 tiles, lane): {b0, b1} of the even tile,
// {b0, b1} of the odd one, b0 = B[16s + 2t, +1][8jn + g], b1 = B[16s + 2t + 8, +9][..].
__device__ __forceinline__ void stage_b(float* bs, int kk, int n, float v) {
  const int s = kk >> 3, kr = kk & 7, which = kr >> 2, lane = (n & 7) * 4 + (kr & 3);
  float* dst = bs + (((s * 8 + (n >> 3)) * 32 + lane) << 2);
  const float hi = __uint_as_float(tf32_rna(v));
  dst[which] = hi;
  dst[2 + which] = __uint_as_float(tf32_rna(v - hi));
}
__device__ __forceinline__ void stage_b(__nv_bfloat16* bs, int kk, int n, float v) {
  const int s = kk >> 4, kr = kk & 15, which = kr >> 3, lane = (n & 7) * 4 + ((kr & 7) >> 1);
  const int jn = n >> 3;
  const int word = (((s * 4 + (jn >> 1)) * 32 + lane) << 2) + (jn & 1) * 2 + which;
  bs[word * 2 + (kr & 1)] = __float2bfloat16(v);
}

// The conv tile of one work item: conv rows r0..r0+CR-1 and columns
// c0..c0+CC-1 of frame n, all inside the frame, for pooled rows ph0.. and
// pooled columns pw0..
struct Item {
  int n, ph0, pw0, r0, c0, CR, CC;
};

__device__ __forceinline__ Item decode(int it, int H, int W, int TQ, int nty, int ntx) {
  Item I;
  const int rest = it / ntx;
  I.n = rest / nty;
  I.ph0 = (rest - I.n * nty) * TP;
  I.pw0 = (it - rest * ntx) * TQ;
  I.r0 = imax(2 * I.ph0 - 1, 0);
  I.c0 = imax(2 * I.pw0 - 1, 0);
  I.CR = imin(2 * (I.ph0 + TP) - 1, H - 1) - I.r0 + 1;
  I.CC = imin(2 * (I.pw0 + TQ) - 1, W - 1) - I.c0 + 1;
  return I;
}

// One tile row as a run of BYTES-wide cp.async copies: elements [0, n) of
// xrow to dst, zeros where !row_ok or outside [lo, hi). BYTES divides the
// byte offsets of lo, hi, xrow and dst.
template <int BYTES, typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* xrow, const T* any, bool row_ok, int lo,
                                         int hi, int n, int lane) {
  constexpr int EPC = BYTES / sizeof(T);  // elements per copy
  for (int e = lane * EPC; e < n; e += 32 * EPC) {
    const bool ok = row_ok && e >= lo && e < hi;
    cp_async<BYTES>(dst + e, ok ? (const void*)(xrow + e) : (const void*)any, ok);
  }
}

// Input rows r0-2 .. r0+CR and columns c0-2 .. c0+CC of frame n into
// xs[row][XW][Cp], zero outside the frame. `gran` is the widest cp.async
// (16, 8 or 4 bytes) that the frame's and the tiles' alignment allow, or 0
// for plain loads (odd C, or x not 4-byte aligned).
template <typename T>
__device__ __forceinline__ void stage_input(T* xs, const T* __restrict__ x, const Item& I, int H,
                                            int W, int C, const Layout& L, int gran, int warp,
                                            int lane) {
  const int rowstride = L.XW * L.Cp;
  const int gc0 = I.c0 - 2;
  for (int ir = warp; ir < I.CR + 3; ir += WARPS) {
    const int gr = I.r0 - 2 + ir;
    const bool row_ok = gr >= 0 && gr < H;
    const T* xrow = x + (((long)I.n * H + gr) * W + gc0) * C;  // read only where inside
    T* dst = xs + ir * rowstride;
    if (gran) {
      const int lo = imax(0, -gc0) * C, hi = (W - gc0) * C;
      // the last copy may run past the tile's last column, into the row's padding
      const int n = (I.CC + 3) * C;
      if (gran == 16) copy_row<16>(dst, xrow, x, row_ok, lo, hi, n, lane);
      else if (gran == 8) copy_row<8>(dst, xrow, x, row_ok, lo, hi, n, lane);
      else copy_row<4>(dst, xrow, x, row_ok, lo, hi, n, lane);
    } else {
      for (int e = lane; e < (I.CC + 3) * L.Cp; e += 32) {
        const int col = e / L.Cp, c = e - col * L.Cp, gc = gc0 + col;
        const bool ok = row_ok && gc >= 0 && gc < W && c < C;
        dst[e] = ok ? xrow[col * C + c] : from_f<T>(0.f);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    stem_pool_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                     T* __restrict__ out, int N, int H, int W, int C, int TQ) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout<T>(H, W, C, TQ);
  float* cs = reinterpret_cast<float*>(smem + L.cs_off);  // [CR*CC][64], swizzled
  T* bs = reinterpret_cast<T*>(smem + L.bs_off);
  T* xs = reinterpret_cast<T*>(smem + L.xs_off);
  int* koff = reinterpret_cast<int*>(smem + L.koff_off);
  float* bias = reinterpret_cast<float*>(smem + L.bias_off);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int PH = H / 2, PW = W / 2;
  const int nty = (PH + TP - 1) / TP, ntx = (PW + TQ - 1) / TQ;
  const int items = N * nty * ntx;  // the launcher checked that it fits
  const int Cp = L.Cp, Kp = L.Kp, rowstride = L.XW * Cp;
  int gran = 0;
  if (C % 2 == 0) {
    // what every copy's ends are multiples of: x, a frame row, and the tile's
    // first column (2 columns left of the frame, or an odd number into it)
    const size_t ends = reinterpret_cast<uintptr_t>(x) | ((size_t)W * C * sizeof(T)) |
                        ((size_t)(ntx > 1 ? 1 : 2) * C * sizeof(T));
    gran = ends % 16 == 0 ? 16 : ends % 8 == 0 ? 8 : ends % 4 == 0 ? 4 : 0;
  }

  int it = blockIdx.x;
  Item next = decode(it, H, W, TQ, nty, ntx);
  if (it < items) stage_input(xs, x, next, H, W, C, L, gran, warp, lane);
  cp_async_commit();

  // weights, K offsets and bias, once per block
  for (int idx = tid; idx < Kp * OC; idx += THREADS) {
    const int kk = idx / OC, n = idx % OC;
    const int i = kk / (4 * Cp), rem = kk - i * 4 * Cp, j = rem / Cp, c = rem - j * Cp;
    const float v = c < C ? to_f(w[((i * 4 + j) * C + c) * OC + n]) : 0.f;
    stage_b(bs, kk, n, v);
  }
  for (int kk = tid; kk < Kp; kk += THREADS) {
    const int i = kk / (4 * Cp);
    koff[kk] = i * rowstride + (kk - i * 4 * Cp);
  }
  if (tid < OC) bias[tid] = to_f(b[tid]);

  for (int buf = 0; it < items; it += gridDim.x, buf ^= 1) {
    const Item I = next;
    const T* xc = xs + buf * L.xs_elems;
    if (it + gridDim.x < items) {
      next = decode(it + gridDim.x, H, W, TQ, nty, ntx);
      stage_input(xs + (buf ^ 1) * L.xs_elems, x, next, H, W, C, L, gran, warp, lane);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this item's rows have landed; the next one's may be in flight
    __syncthreads();     // also: the previous item's pool pass is done with cs

    const int P = I.CR * I.CC;
    for (int m0 = warp * WM; m0 < P; m0 += WARPS * WM) {
      // element offsets of this lane's fragment rows (pixels m0+16mt+g, +8)
      int base[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = imin(m0 + mt * 16 + h * 8 + g, P - 1);
          const int r = m / I.CC;
          base[mt][h] = (r * L.XW + (m - r * I.CC)) * Cp;
        }
      float acc[MT][8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;

      if constexpr (sizeof(T) == 4) {
        const float4* bs4 = reinterpret_cast<const float4*>(bs);
        for (int s = 0; s < Kp / 8; ++s) {
          const int o0 = koff[8 * s + t], o1 = koff[8 * s + t + 4];
          uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const float av[4] = {xc[base[mt][0] + o0], xc[base[mt][1] + o0],
                                 xc[base[mt][0] + o1], xc[base[mt][1] + o1]};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              ahi[mt][q] = tf32_rna(av[q]);
              alo[mt][q] = tf32_rna(av[q] - __uint_as_float(ahi[mt][q]));
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 bv = bs4[(s * 8 + j) * 32 + lane];
            const uint32_t bh0 = __float_as_uint(bv.x), bh1 = __float_as_uint(bv.y);
            const uint32_t bl0 = __float_as_uint(bv.z), bl1 = __float_as_uint(bv.w);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_tf32(acc[mt][j], alo[mt], bh0, bh1);
              mma_tf32(acc[mt][j], ahi[mt], bl0, bl1);
              mma_tf32(acc[mt][j], ahi[mt], bh0, bh1);
            }
          }
        }
      } else {
        const uint4* bs4 = reinterpret_cast<const uint4*>(bs);
        for (int s = 0; s < Kp / 16; ++s) {
          const int o0 = koff[16 * s + 2 * t], o1 = koff[16 * s + 2 * t + 8];
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            a[mt][0] = *reinterpret_cast<const uint32_t*>(xc + base[mt][0] + o0);
            a[mt][1] = *reinterpret_cast<const uint32_t*>(xc + base[mt][1] + o0);
            a[mt][2] = *reinterpret_cast<const uint32_t*>(xc + base[mt][0] + o1);
            a[mt][3] = *reinterpret_cast<const uint32_t*>(xc + base[mt][1] + o1);
          }
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            const uint4 bv = bs4[(s * 4 + jp) * 32 + lane];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[mt][2 * jp], a[mt], bv.x, bv.y);
              mma_bf16(acc[mt][2 * jp + 1], a[mt], bv.z, bv.w);
            }
          }
        }
      }

      // bias + ReLU, conv tile to shared memory: lane (g, t) holds channels
      // 8j+2t, 8j+2t+1 of pixels g and g+8 of each m16 tile
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bi = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + mt * 16 + h * 8 + g;  // m & 7 == g: m0 + 16mt + 8h is a multiple of 8
            if (m < P)
              *reinterpret_cast<float2*>(cs + (size_t)m * OC + ((j ^ g) << 3) + 2 * t) =
                  make_float2(fmaxf(acc[mt][j][2 * h] + bi.x, 0.f),
                              fmaxf(acc[mt][j][2 * h + 1] + bi.y, 0.f));
          }
      }
    }
    __syncthreads();

    // 3x3/2 max over the conv tile and the one write of the output tile;
    // a thread takes the 16 bytes of output channels CPT*u .. CPT*u+CPT-1
    constexpr int CPT = 16 / sizeof(T);
    constexpr int TPP = OC / CPT;  // threads per pooled pixel
    const int np = imin(TP, PH - I.ph0), nq = imin(TQ, PW - I.pw0);
    const int u = tid % TPP;
    const int grp = (CPT * u) >> 3, in_grp = (CPT * u) & 7;
    for (int pq = tid / TPP; pq < np * nq; pq += THREADS / TPP) {
      const int ph = I.ph0 + pq / nq, pw = I.pw0 + pq % nq;
      // the window's rows and columns, clamped to the frame: a position
      // taken twice does not change the max
      const int lr[3] = {imax(2 * ph - 1, 0) - I.r0, 2 * ph - I.r0,
                         imin(2 * ph + 1, H - 1) - I.r0};
      const int lc[3] = {imax(2 * pw - 1, 0) - I.c0, 2 * pw - I.c0,
                         imin(2 * pw + 1, W - 1) - I.c0};
      float mx[CPT];
#pragma unroll
      for (int q = 0; q < CPT; ++q) mx[q] = 0.f;  // ReLU floor
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int m = lr[a] * I.CC + lc[c];
          const float* src = cs + (size_t)m * OC + ((grp ^ (m & 7)) << 3) + in_grp;
#pragma unroll
          for (int q = 0; q < CPT; q += 4) {
            const float4 v = *reinterpret_cast<const float4*>(src + q);
            mx[q] = fmaxf(mx[q], v.x);
            mx[q + 1] = fmaxf(mx[q + 1], v.y);
            mx[q + 2] = fmaxf(mx[q + 2], v.z);
            mx[q + 3] = fmaxf(mx[q + 3], v.w);
          }
        }
      T* dst = out + ((((size_t)I.n * PH + ph) * PW + pw) * OC + CPT * u);
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(mx[0], mx[1], mx[2], mx[3]);
      } else {
        __nv_bfloat162 h[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(mx[2 * q], mx[2 * q + 1]);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
      }
    }
  }
  cp_async_wait<0>();
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* out, int N, int H, int W, int C,
           cudaStream_t stream) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // the widest column tile whose conv tile fits beside the weights
  const int PH = H / 2, PW = W / 2;
  int TQ = imin(PW, TQ_MAX);
  while (TQ > 1 && make_layout<T>(H, W, C, TQ).total > (size_t)smem_max) TQ = (TQ + 1) / 2;
  const size_t smem = make_layout<T>(H, W, C, TQ).total;
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(stem_pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long items = (long)N * ((PH + TP - 1) / TP) * ((PW + TQ - 1) / TQ);
  if (items + sms > 0x7fffffffL) return (int)cudaErrorInvalidValue;  // the kernel counts in int
  const int grid = (int)(items < sms ? items : sms);
  stem_pool_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(out), N, H, W, C, TQ);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N,H,W,C], w [16C,64], b [64], out [N,H/2,W/2,64], all contiguous and of
// one dtype: dtype 0 = fp32, 1 = bf16. H and W even, out 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int stem_s2d_pool_launch(const void* x, const void* w, const void* b,
                                    void* out, int N, int H, int W, int C,
                                    int dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || H % 2 || W % 2 ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w, b, out, N, H, W, C, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, b, out, N, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
