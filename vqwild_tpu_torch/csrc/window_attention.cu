// K6: windowed multi-head self-attention with a relative-position bias and a
//     shifted window's mask, fp32 on the tensor cores, forward and backward,
//     for the Video Swin trunk (models/swin3d.py). Each (clip b, window w,
//     head h) is one sequence of N <= 392 tokens with head_dim 32:
//       o_i = Σ_j P_ij v_j,  P_i = softmax_j(scale · q_i·k_j + bias_ij),
//       bias_ij = table[index[i][j]][h] + (regions[w][i] != regions[w][j] ? -100 : 0)
//     (rel and mask added first, then the scaled score, as the trunk's
//     WindowAttention3D.bias and SDPA do). q, k, v, o and their gradients
//     are [B][N][nW·heads·32] as the trunk's qkv products write them and its
//     proj reads them: each token's row holds every window's heads side by
//     side, so (w, h) is a 32-float column slice at (w·heads + h)·32. The
//     backward also gives the table's gradient [T][heads], summed over the
//     clips, the windows and every (i, j) of each offset.
//
// Replaces no TPU kernel: the JAX package has no Swin. It replaces
// F.scaled_dot_product_attention with a materialised float attn_mask (the
// memory-efficient CUTLASS kernel, whose backward writes the mask's gradient
// at full size, [clips][nW·heads][N][N], 2.9 GB a stage-1 block) and
// autograd's reduction of that gradient onto the table.
//
// What bounds it on an H100: operations. A (clip, window, head) pair does
// 2·N²·32 FLOP a product, 2 products forward and 5 backward: 68.8 MFLOP on
// ~0.4 MB at N = 392 (171 FLOP a byte, against the 49 at which 165 TFLOP/s
// of 3xTF32 work and 3.35 TB/s meet). A train step of the cell (9 clips of
// 32 x 224²) runs 35,712 pairs through each pass: 2.46 TFLOP, 14.9 ms at
// 165 TFLOP/s.
//
// Arithmetic: three error-compensated TF32 products, as K3/K4: each operand
// v is split into hi = tf32(v) and lo = tf32(v - hi) (cvt.rna), and
// a_lo·b_hi, a_hi·b_lo, a_hi·b_hi go into fp32 accumulators; every 32-deep
// slice of a reduction goes into a fresh accumulator that the running sum
// then takes with a plain fp32 add. No one-product path exists. The softmax
// is fp32, 2^x by ex2.approx with log2(e) folded into the scale and the bias
// (it flushes results under 2^-126 to 0: weights under e^-87 of their row's
// largest, where the shift's mask puts e^-100); the forward keeps the row's
// base-2 log-sum-exp and the backward recomputes P from it.
//
// What the design does about it:
//  - mma.sync m16n8k8 TF32 (FlashAttention-2's shape), not wgmma: at
//    head_dim 32 every product is one 32-deep slice (q kᵀ, dO vᵀ) or a sum
//    over 64-token chunks in two slices (P v, dS k, Pᵀ dO, dSᵀ q); wgmma
//    would need K-major shared-memory tiles of P, dS and their transposes,
//    one more trip through shared memory each, while mma.sync takes the
//    score tile straight from its accumulator: the A fragment's columns (t,
//    t+4) are read as tokens (2t, 2t+1) of the C fragment. B fragments come
//    by ldmatrix.x4 (hi and lo words in one instruction) from [token][feature]
//    tiles for q kᵀ-type products and from transposed [feature][token] tiles,
//    tokens permuted within each 8 to match, for P v-type products; rows
//    padded to 36 and 68 words, so both hit 32 banks.
//  - Blocks of 4 warps, each warp 16 rows; a block 64 rows of one pair.
//    392 = 24.5 · 16: the last warp tile of a pair is half full (2% of the
//    rows wasted, not the 12.5% of a 64-row tile), and warps past N skip
//    the products. Chunks of 64 along the other side: 392 = 6 · 64 + 8,
//    and the last chunk runs only its live 8-column tiles (one of eight).
//  - Grids are sized for stage 3, 18 of the 24 calls and 58% of the
//    operations: 8,064 forward and dkv blocks a call (7 row tiles x 128
//    pairs x 9 clips; 3 and 2 blocks an SM), 896 dq blocks (the clips are
//    its loop: 3.4 waves at 2 an SM). Stage 4's 64 pairs give dq 448 blocks,
//    1.7 waves; its two calls are 3% of a step's operations.
//  - The bias is never materialised. index[i][j] = index[i][0] +
//    (index[0][j] - index[0][0]) (the relative index is a difference of
//    coordinates), so a row keeps index[i][0] in a register and a column
//    offset comes from shared memory; the head's 2,535 table entries and the
//    window's region ids sit in shared memory. A score element costs an
//    integer add, a shared load, a compare and two FMAs on the CUDA cores.
//  - Forward (window_attention_fwd): each 64-key chunk of k and v arrives by
//    cp.async one chunk ahead, into a raw fp32 buffer that the block splits
//    into its hi and lo tiles, and FlashAttention's online softmax runs over
//    the chunks.
//  - Backward in two product kernels, so that no sum crosses blocks:
//    window_attention_dq owns 64 query rows of one (window, head) for up to
//    9 clips: for each key chunk and each clip it recomputes S and dP, forms
//    dS, adds dS·k into that clip's dQ in shared memory (each thread owns
//    its entries) and adds dS into a register tile over the clips, which it
//    then writes as the bias gradient of (w, h) summed over the clips: one
//    [nW·heads][N][N] buffer a call. It also writes D_i = dO_i·o_i. Its
//    q and dO fragments load one iteration ahead.
//    window_attention_dkv owns 64 keys of one pair and walks the query
//    chunks (q and dO by cp.async one chunk ahead), dK and dV in registers
//    (FlashAttention-2's backward without its atomic dQ). Seven products a
//    pair backward instead of five: the price of no atomics and of keeping
//    dQ off device memory.
//  - window_attention_bias_sum adds the [nW·heads][N][N] buffer over the
//    windows, and window_attention_bias_table gathers each table entry's
//    (i, j) pairs through the inverse of the column offsets. Every sum runs
//    in one fixed order and nothing uses atomics: a backward repeats bit
//    for bit.
//  - Measured (H100, a Swin-B step's 24 calls): 155 ms against 14.9 ms of
//    least time. The tensor pipe idles while a warp forms its softmax,
//    splits its operands and waits at a chunk's barriers; FlashAttention-3's
//    warpgroup ping-pong on wgmma is the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int HD = 32;         // head_dim
constexpr int TILE = 64;       // a block's rows; a chunk's columns
constexpr int THREADS = 128;   // 4 warps of 16 rows
constexpr int LDS = 36;        // shared tile row stride in words (conflict-free fragments)
constexpr int TILE_WORDS = TILE * LDS;
constexpr int LDT = 68;        // a transposed tile's row stride in words (64 tokens + 4)
constexpr int TT_WORDS = HD * LDT;
constexpr int MAX_LEN = 392;   // an 8x7x7 window
constexpr int MAX_PAD = 448;   // MAX_LEN rounded up to TILE
constexpr int MAX_TABLE = 2560;
constexpr int GROUP = 9;       // clips a dq block carries
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK = -100.f;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;      // backward: the forward's output
  const float* dout;   // backward: dO
  float* out;          // forward: o
  float* lse;          // [B][P][N] base-2 log-sum-exp of each row
  float* dsum;         // [B][P][N] D_i = dO_i·o_i
  float* dq;
  float* dk;
  float* dv;
  float* gpart;        // [groups][P][N][N] the bias gradient summed over a group's clips
  float* dtable;       // [T][heads]
  const float* table;  // [heads][T] (the table transposed)
  const int64_t* index;
  const int* regions;  // [nW][N] or null
  long index_ld;
  int B, N, P, heads, T;
  float scale, scale_log2;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b in 3xTF32: a_lo·b_hi, a_hi·b_lo, a_hi·b_hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// the same with b given in fp32, split here
__device__ __forceinline__ void mma3f(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma3(d, ah, al, h0, h1, l0, l1);
}

// A fragment of a score tile's 8 columns ks taken from its C fragment: the
// A columns (t, t+4) stand for the C columns (2t, 2t+1)
__device__ __forceinline__ void a_of_c(const float (&c)[4], uint32_t (&h)[4], uint32_t (&l)[4]) {
  split(c[0], h[0], l[0]);
  split(c[2], h[1], l[1]);
  split(c[1], h[2], l[2]);
  split(c[3], h[3], l[3]);
}

// rows [0, rows) of a pair's slice (row stride ld) into a shared fp32 tile,
// zero past rows
__device__ __forceinline__ void stage_f32(uint32_t* dst, const float* src, long ld, int rows) {
  for (int e = threadIdx.x; e < TILE * 8; e += THREADS) {
    const int r = e >> 3, c = (e & 7) * 4;
    *reinterpret_cast<float4*>(dst + r * LDS + c) =
        r < rows ? ld4(src + (size_t)r * ld + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// a token's column in a transposed tile: within each 8, the tokens (2t,
// 2t+1) go to (t, t+4), where ldmatrix hands a thread a B fragment's two
// rows (the A fragment's columns t, t+4 read from the C fragment's 2t, 2t+1)
__device__ __forceinline__ int perm8(int k) {
  return (k & ~7) | ((k & 7) >> 1) | ((k & 1) << 2);
}

// 2^x on the special-function unit
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// rows [0, rows) of a pair's slice into a raw fp32 [TILE][HD] buffer by
// cp.async, zero past rows (committed by the caller)
__device__ __forceinline__ void fetch(uint32_t* raw, const float* src, long ld, int rows) {
  for (int e = threadIdx.x; e < TILE * 8; e += THREADS) {
    const int r = e >> 3, c = (e & 7) * 4;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(raw + r * HD + c)),
                 "l"(src + (size_t)(r < rows ? r : 0) * ld + c), "r"(r < rows ? 16 : 0)
                 : "memory");
  }
}

// a raw buffer (each thread the entries it fetched) split into hi and lo
// words, into a [token][feature] tile (hi non-null) and a transposed
// [feature][perm8(token)] tile (thi non-null)
__device__ __forceinline__ void split_raw(const uint32_t* raw, uint32_t* hi, uint32_t* lo,
                                          uint32_t* thi, uint32_t* tlo) {
  for (int e = threadIdx.x; e < TILE * 8; e += THREADS) {
    const int r = e >> 3, c = (e & 7) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + r * HD + c);
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    if (hi != nullptr) {
      *reinterpret_cast<uint4*>(hi + r * LDS + c) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + r * LDS + c) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    if (thi != nullptr) {
      const int pr = perm8(r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        thi[(c + i) * LDT + pr] = h[i];
        tlo[(c + i) * LDT + pr] = l[i];
      }
    }
  }
}

// rows ra, rb of a pair's slice as a 16 x 32 A fragment's fp32 words, zero
// past N (split later by split_a)
__device__ __forceinline__ void load_raw(const float* base, long ld, int ra, int rb, int N, int t,
                                         float (&x)[16]) {
  const bool va = ra < N, vb = rb < N;
  const float* pa = base + (size_t)(va ? ra : 0) * ld + t;
  const float* pb = base + (size_t)(vb ? rb : 0) * ld + t;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    x[4 * kk] = va ? __ldg(pa + 8 * kk) : 0.f;
    x[4 * kk + 1] = vb ? __ldg(pb + 8 * kk) : 0.f;
    x[4 * kk + 2] = va ? __ldg(pa + 8 * kk + 4) : 0.f;
    x[4 * kk + 3] = vb ? __ldg(pb + 8 * kk + 4) : 0.f;
  }
}

__device__ __forceinline__ void split_a(const float (&x)[16], uint32_t (&h)[4][4],
                                        uint32_t (&l)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) split(x[4 * kk + e], h[kk][e], l[kk][e]);
}

__device__ __forceinline__ void load_a(const float* base, long ld, int ra, int rb, int N, int t,
                                       uint32_t (&h)[4][4], uint32_t (&l)[4][4]) {
  float x[16];
  load_raw(base, ld, ra, rb, N, t, x);
  split_a(x, h, l);
}

// A lane's ldmatrix address (bytes) into a pair of hi / lo tiles of row
// stride ld words: lanes 0-15 the hi tile, 16-31 the lo tile; rows lane % 8,
// columns +4 for lanes 8-15 and 24-31. The four registers then hold B
// fragment words (b0, b1) of hi and of lo.
__device__ __forceinline__ uint32_t frag_base(const uint32_t* hi, const uint32_t* lo, int ld) {
  const int lane = threadIdx.x & 31;
  return smem_u32((lane < 16 ? hi : lo) + (lane & 7) * ld + ((lane >> 3) & 1) * 4);
}

// The head's table, and each token's index offset and region id of the
// window, into shared memory. off[j] = index[j][0] (rows) or index[0][j] -
// index[0][0] (columns), so that index[i][j] = row(i) + col(j); past N a
// row takes row 0's offset and a column 0, so that a sum stays in the table.
__device__ __forceinline__ void stage_bias(const Args& a, int h, int w, bool rows, float* tab,
                                           int* off, int* reg) {
  for (int i = threadIdx.x; i < a.T; i += THREADS) tab[i] = a.table[(size_t)h * a.T + i];
  const int64_t i00 = a.index[0];
  const int npad = cdiv(a.N, TILE) * TILE;
  for (int j = threadIdx.x; j < npad; j += THREADS) {
    const bool live = j < a.N;
    off[j] = rows ? (int)(live ? a.index[(size_t)j * a.index_ld] : i00)
                  : (live ? (int)(a.index[j] - i00) : 0);
    reg[j] = (live && a.regions != nullptr) ? a.regions[(size_t)w * a.N + j] : 0;
  }
}

// the base-2 logit of a score s with the bias of index idx and regions ri, rj
__device__ __forceinline__ float logit2(const Args& a, const float* tab, float s, int idx, int ri,
                                        int rj) {
  float bias = tab[idx];
  if (ri != rj) bias += MASK;
  return fmaf(s, a.scale_log2, bias * LOG2E);
}

constexpr int RAW_WORDS = TILE * HD;  // a raw fp32 chunk
constexpr size_t FWD_SMEM =
    (2 * TILE_WORDS + 2 * TT_WORDS + 2 * RAW_WORDS + MAX_TABLE + 2 * MAX_PAD) * 4;

// ---------------------------------------------------------------------------
// Forward: grid (query tiles, P, B)

__global__ void __launch_bounds__(THREADS, 3) window_attention_fwd(const Args a) {
  extern __shared__ __align__(16) uint32_t sm[];
  uint32_t *khi = sm, *klo = khi + TILE_WORDS, *vhi = klo + TILE_WORDS, *vlo = vhi + TT_WORDS;
  uint32_t *rk = vlo + TT_WORDS, *rv = rk + RAW_WORDS;
  float* tab = reinterpret_cast<float*>(rv + RAW_WORDS);
  int* cols = reinterpret_cast<int*>(tab + MAX_TABLE);
  int* creg = cols + MAX_PAD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int N = a.N, p = blockIdx.y, b = blockIdx.z, h = p % a.heads, w = p / a.heads;
  const long ld = (long)a.P * HD;
  const size_t base = (size_t)b * N * ld + (size_t)p * HD;
  fetch(rk, a.k + base, ld, imin(TILE, N));
  fetch(rv, a.v + base, ld, imin(TILE, N));
  cp_commit();
  stage_bias(a, h, w, false, tab, cols, creg);

  const int r0 = blockIdx.x * TILE + warp * 16, ra = r0 + g, rb = ra + 8;
  const bool live = r0 < N;
  int rowi[2], rowg[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = e ? rb : ra;
    rowi[e] = (int)a.index[(size_t)(r < N ? r : 0) * a.index_ld];
    rowg[e] = (a.regions != nullptr && r < N) ? a.regions[(size_t)w * N + r] : 0;
  }
  uint32_t qh[4][4], ql[4][4];
  load_a(a.q + base, ld, ra, rb, N, t, qh, ql);
  const uint32_t kb = frag_base(khi, klo, LDS), vb = frag_base(vhi, vlo, LDT);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[4][4];
#pragma unroll
  for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n8][e] = 0.f;

  for (int c0 = 0; c0 < N; c0 += TILE) {
    const int kr = imin(TILE, N - c0), live_nt = cdiv(kr, 8);
    cp_wait0();
    __syncthreads();
    split_raw(rk, khi, klo, nullptr, nullptr);
    split_raw(rv, nullptr, nullptr, vhi, vlo);
    __syncthreads();
    if (c0 + TILE < N) {  // the next chunk comes in while this one is used
      const int next = imin(TILE, N - c0 - TILE);
      fetch(rk, a.k + base + (size_t)(c0 + TILE) * ld, ld, next);
      fetch(rv, a.v + base + (size_t)(c0 + TILE) * ld, ld, next);
      cp_commit();
    }
    if (!live) continue;
    float s[8][4];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      if (nt >= live_nt) continue;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bk[4];
        ldsm4(bk, kb + (nt * 8 * LDS + kk * 8) * 4);
        mma3(s[nt], qh[kk], ql[kk], bk[0], bk[1], bk[2], bk[3]);
      }
      const int j = c0 + nt * 8 + 2 * t;
      const int2 cj = *reinterpret_cast<const int2*>(cols + j);
      const int2 gj = *reinterpret_cast<const int2*>(creg + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, jj = j + (e & 1);
        const float x = jj < N ? logit2(a, tab, s[nt][e], rowi[r] + ((e & 1) ? cj.y : cj.x),
                                         rowg[r], (e & 1) ? gj.y : gj.x)
                               : -INFINITY;
        s[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n8][e] *= corr[e >> 1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = nt < live_nt ? ex2(s[nt][e] - m[e >> 1]) : 0.f;
        s[nt][e] = pe;
        l[e >> 1] += pe;
      }
    // acc += P v, in two 32-key slices
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      if (sl * 4 >= live_nt) continue;
      float tmp[4][4];
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[n8][e] = 0.f;
#pragma unroll
      for (int ks = sl * 4; ks < sl * 4 + 4; ++ks) {
        if (ks >= live_nt) continue;
        uint32_t ph[4], pl[4];
        a_of_c(s[ks], ph, pl);
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) {
          uint32_t bv[4];
          ldsm4(bv, vb + (n8 * 8 * LDT + ks * 8) * 4);
          mma3(tmp[n8], ph, pl, bv[0], bv[1], bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n8][e] += tmp[n8][e];
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? rb : ra;
    if (row >= N) continue;
    const float inv = 1.f / l[r];
    float* dst = a.out + base + (size_t)row * ld + 2 * t;
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8)
      *reinterpret_cast<float2*>(dst + n8 * 8) =
          make_float2(acc[n8][2 * r] * inv, acc[n8][2 * r + 1] * inv);
    if (t == 0) a.lse[((size_t)b * a.P + p) * N + row] = m[r] + log2f(l[r]);
  }
}

// ---------------------------------------------------------------------------
// Backward, dQ, D and the bias gradient summed over a group of clips:
// grid (query tiles, P, clip groups)

constexpr size_t DQ_SMEM =
    ((size_t)GROUP * TILE * HD + 2 * TILE_WORDS + 2 * GROUP * TILE + MAX_TABLE + 2 * MAX_PAD) * 4;

__global__ void __launch_bounds__(THREADS, 2) window_attention_dq(const Args a) {
  extern __shared__ __align__(16) uint32_t sm[];
  float* dqs = reinterpret_cast<float*>(sm);            // [GROUP][4 warps][16][32 lanes]
  uint32_t* kf = sm + GROUP * TILE * HD;                 // fp32 k chunk
  uint32_t* vf = kf + TILE_WORDS;                        // fp32 v chunk
  float* lse_s = reinterpret_cast<float*>(vf + TILE_WORDS);  // [GROUP][TILE]
  float* d_s = lse_s + GROUP * TILE;
  float* tab = d_s + GROUP * TILE;
  int* cols = reinterpret_cast<int*>(tab + MAX_TABLE);
  int* creg = cols + MAX_PAD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int N = a.N, P = a.P, p = blockIdx.y, h = p % a.heads, w = p / a.heads;
  const int b0 = blockIdx.z * GROUP, nb = imin(GROUP, a.B - b0), q0 = blockIdx.x * TILE;
  const long ld = (long)P * HD;
  stage_bias(a, h, w, false, tab, cols, creg);
  for (int e = tid; e < GROUP * TILE; e += THREADS) {
    const int bb = e / TILE, i = q0 + e % TILE;
    float dsum = 0.f, l = INFINITY;
    if (bb < nb && i < N) {
      const size_t off = ((size_t)(b0 + bb) * N + i) * ld + (size_t)p * HD;
#pragma unroll
      for (int c = 0; c < HD; c += 4) {
        const float4 x = ld4(a.dout + off + c), y = ld4(a.o + off + c);
        dsum = fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, dsum))));
      }
      const size_t row = ((size_t)(b0 + bb) * P + p) * N + i;
      l = a.lse[row];
      a.dsum[row] = dsum;
    }
    d_s[e] = dsum;
    lse_s[e] = l;
  }
  for (int e = tid; e < GROUP * TILE * HD; e += THREADS) dqs[e] = 0.f;

  const int r0 = q0 + warp * 16, ra = r0 + g, rb = ra + 8;
  const bool live = r0 < N;
  int rowi[2], rowg[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = e ? rb : ra;
    rowi[e] = (int)a.index[(size_t)(r < N ? r : 0) * a.index_ld];
    rowg[e] = (a.regions != nullptr && r < N) ? a.regions[(size_t)w * N + r] : 0;
  }
  const float* kfl = reinterpret_cast<const float*>(kf);
  // ldmatrix over an fp32 tile: lane L reads row L % 8 at column (L / 16) * 8
  // + ((L / 8) & 1) * 4: two 8-feature steps of b0, b1 a call
  const uint32_t kfb = smem_u32(kf + (lane & 7) * LDS + (lane >> 4) * 8 + ((lane >> 3) & 1) * 4);
  const uint32_t vfb = smem_u32(vf + (lane & 7) * LDS + (lane >> 4) * 8 + ((lane >> 3) & 1) * 4);

  // the q and dO fragments of the clip an iteration uses, loaded one
  // iteration ahead
  float qraw[16], graw[16];
  if (live) {
    const size_t base0 = (size_t)b0 * N * ld + (size_t)p * HD;
    load_raw(a.q + base0, ld, ra, rb, N, t, qraw);
    load_raw(a.dout + base0, ld, ra, rb, N, t, graw);
  }
  for (int c0 = 0; c0 < N; c0 += TILE) {
    const int kr = imin(TILE, N - c0), live_nt = cdiv(kr, 8);
    float gb[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) gb[nt][e] = 0.f;
    for (int bb = 0; bb < nb; ++bb) {
      const size_t base = (size_t)(b0 + bb) * N * ld + (size_t)p * HD;
      __syncthreads();
      stage_f32(kf, a.k + base + (size_t)c0 * ld, ld, kr);
      stage_f32(vf, a.v + base + (size_t)c0 * ld, ld, kr);
      __syncthreads();
      if (!live) continue;
      const bool more = bb + 1 < nb || c0 + TILE < N;
      const size_t nbase = (size_t)(b0 + (bb + 1 < nb ? bb + 1 : 0)) * N * ld + (size_t)p * HD;
      float s[8][4], dp[8][4];
      {
        uint32_t xh[4][4], xl[4][4];
        split_a(qraw, xh, xl);
        if (more) load_raw(a.q + nbase, ld, ra, rb, N, t, qraw);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
          if (nt >= live_nt) continue;
#pragma unroll
          for (int kp = 0; kp < 2; ++kp) {
            uint32_t bk[4];
            ldsm4(bk, kfb + (nt * 8 * LDS + kp * 16) * 4);
            mma3f(s[nt], xh[2 * kp], xl[2 * kp], __uint_as_float(bk[0]), __uint_as_float(bk[1]));
            mma3f(s[nt], xh[2 * kp + 1], xl[2 * kp + 1], __uint_as_float(bk[2]),
                  __uint_as_float(bk[3]));
          }
        }
        split_a(graw, xh, xl);
        if (more) load_raw(a.dout + nbase, ld, ra, rb, N, t, graw);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[nt][e] = 0.f;
          if (nt >= live_nt) continue;
#pragma unroll
          for (int kp = 0; kp < 2; ++kp) {
            uint32_t bv[4];
            ldsm4(bv, vfb + (nt * 8 * LDS + kp * 16) * 4);
            mma3f(dp[nt], xh[2 * kp], xl[2 * kp], __uint_as_float(bv[0]),
                  __uint_as_float(bv[1]));
            mma3f(dp[nt], xh[2 * kp + 1], xl[2 * kp + 1], __uint_as_float(bv[2]),
                  __uint_as_float(bv[3]));
          }
        }
      }
      const float* lr = lse_s + bb * TILE + warp * 16 + g;
      const float* dr = d_s + bb * TILE + warp * 16 + g;
      const float lse_r[2] = {lr[0], lr[8]}, d_r[2] = {dr[0], dr[8]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= live_nt) continue;
        const int j = c0 + nt * 8 + 2 * t;
        const int2 cj = *reinterpret_cast<const int2*>(cols + j);
        const int2 gj = *reinterpret_cast<const int2*>(creg + j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, jj = j + (e & 1);
          float pe = 0.f;
          if (jj < N)
            pe = ex2(logit2(a, tab, s[nt][e], rowi[r] + ((e & 1) ? cj.y : cj.x), rowg[r],
                              (e & 1) ? gj.y : gj.x) -
                       lse_r[r]);
          const float ds = pe * (dp[nt][e] - d_r[r]);
          s[nt][e] = ds;
          gb[nt][e] += ds;
        }
      }
      // this clip's dQ += dS k, in two 32-key slices
      float* dqw = dqs + ((size_t)bb * 4 + warp) * 16 * 32 + lane;
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        if (sl * 4 >= live_nt) continue;
        float tmp[4][4];
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
          for (int e = 0; e < 4; ++e) tmp[n8][e] = 0.f;
#pragma unroll
        for (int ks = sl * 4; ks < sl * 4 + 4; ++ks) {
          if (ks >= live_nt) continue;
          uint32_t ah[4], al[4];
          a_of_c(s[ks], ah, al);
#pragma unroll
          for (int n8 = 0; n8 < 4; ++n8) {
            const int o = (ks * 8 + 2 * t) * LDS + n8 * 8 + g;
            mma3f(tmp[n8], ah, al, kfl[o], kfl[o + LDS]);
          }
        }
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
          for (int e = 0; e < 4; ++e) dqw[(n8 * 4 + e) * 32] += tmp[n8][e];
      }
    }
    if (!live) continue;
    float* gp = a.gpart + ((size_t)blockIdx.z * P + p) * N * N;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = c0 + nt * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e >> 1) ? rb : ra, jj = j + (e & 1);
        if (row < N && jj < N) gp[(size_t)row * N + jj] = gb[nt][e];
      }
    }
  }
  if (!live) return;
  for (int bb = 0; bb < nb; ++bb) {
    const float* dqw = dqs + ((size_t)bb * 4 + warp) * 16 * 32 + lane;
    float* dst = a.dq + (size_t)(b0 + bb) * N * ld + (size_t)p * HD + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? rb : ra;
      if (row >= N) continue;
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
        *reinterpret_cast<float2*>(dst + (size_t)row * ld + n8 * 8) =
            make_float2(a.scale * dqw[(n8 * 4 + 2 * r) * 32],
                        a.scale * dqw[(n8 * 4 + 2 * r + 1) * 32]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dK and dV: grid (key tiles, P, B). A warp's 16 keys are the M
// rows of Sᵀ = k qᵀ and dPᵀ = v dOᵀ.

constexpr size_t DKV_SMEM =
    (4 * TILE_WORDS + 4 * TT_WORDS + 2 * RAW_WORDS + 2 * TILE + MAX_TABLE + 2 * MAX_PAD) * 4;

__global__ void __launch_bounds__(THREADS, 2) window_attention_dkv(const Args a) {
  extern __shared__ __align__(16) uint32_t sm[];
  uint32_t *qhi = sm, *qlo = qhi + TILE_WORDS, *ghi = qlo + TILE_WORDS, *glo = ghi + TILE_WORDS;
  uint32_t *qthi = glo + TILE_WORDS, *qtlo = qthi + TT_WORDS, *gthi = qtlo + TT_WORDS,
           *gtlo = gthi + TT_WORDS;
  uint32_t *rq = gtlo + TT_WORDS, *rg = rq + RAW_WORDS;
  float* lse_s = reinterpret_cast<float*>(rg + RAW_WORDS);
  float* d_s = lse_s + TILE;
  float* tab = d_s + TILE;
  int* rows = reinterpret_cast<int*>(tab + MAX_TABLE);
  int* rreg = rows + MAX_PAD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int N = a.N, p = blockIdx.y, b = blockIdx.z, h = p % a.heads, w = p / a.heads;
  const long ld = (long)a.P * HD;
  const size_t base = (size_t)b * N * ld + (size_t)p * HD;
  const size_t lrow = ((size_t)b * a.P + p) * N;
  fetch(rq, a.q + base, ld, imin(TILE, N));
  fetch(rg, a.dout + base, ld, imin(TILE, N));
  cp_commit();
  stage_bias(a, h, w, true, tab, rows, rreg);

  const int k0 = blockIdx.x * TILE + warp * 16, ka = k0 + g, kb = ka + 8;
  const bool live = k0 < N;
  const int64_t i00 = a.index[0];
  int coli[2], colg[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = e ? kb : ka;
    coli[e] = j < N ? (int)(a.index[j] - i00) : 0;
    colg[e] = (a.regions != nullptr && j < N) ? a.regions[(size_t)w * N + j] : 0;
  }
  uint32_t kh[4][4], kl[4][4], vh[4][4], vl[4][4];
  load_a(a.k + base, ld, ka, kb, N, t, kh, kl);
  load_a(a.v + base, ld, ka, kb, N, t, vh, vl);
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n8][e] = dv[n8][e] = 0.f;
  const uint32_t qb = frag_base(qhi, qlo, LDS), gb = frag_base(ghi, glo, LDS);
  const uint32_t qtb = frag_base(qthi, qtlo, LDT), gtb = frag_base(gthi, gtlo, LDT);

  for (int c0 = 0; c0 < N; c0 += TILE) {
    const int qr = imin(TILE, N - c0), live_nt = cdiv(qr, 8);
    cp_wait0();
    __syncthreads();
    split_raw(rq, qhi, qlo, qthi, qtlo);
    split_raw(rg, ghi, glo, gthi, gtlo);
    if (threadIdx.x < TILE) {
      const int i = c0 + threadIdx.x;
      lse_s[threadIdx.x] = i < N ? a.lse[lrow + i] : INFINITY;
      d_s[threadIdx.x] = i < N ? a.dsum[lrow + i] : 0.f;
    }
    __syncthreads();
    if (c0 + TILE < N) {  // the next chunk comes in while this one is used
      const int next = imin(TILE, N - c0 - TILE);
      fetch(rq, a.q + base + (size_t)(c0 + TILE) * ld, ld, next);
      fetch(rg, a.dout + base + (size_t)(c0 + TILE) * ld, ld, next);
      cp_commit();
    }
    if (!live) continue;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      if (nt >= live_nt) continue;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bq[4], bg[4];
        ldsm4(bq, qb + (nt * 8 * LDS + kk * 8) * 4);
        ldsm4(bg, gb + (nt * 8 * LDS + kk * 8) * 4);
        mma3(s[nt], kh[kk], kl[kk], bq[0], bq[1], bq[2], bq[3]);
        mma3(dp[nt], vh[kk], vl[kk], bg[0], bg[1], bg[2], bg[3]);
      }
      const int i = c0 + nt * 8 + 2 * t;  // the C fragment's query columns i, i + 1
      const int2 ri = *reinterpret_cast<const int2*>(rows + i);
      const int2 gi = *reinterpret_cast<const int2*>(rreg + i);
      const float2 li = *reinterpret_cast<const float2*>(lse_s + i - c0);
      const float2 di = *reinterpret_cast<const float2*>(d_s + i - c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, odd = e & 1;
        float pe = 0.f;
        if (i + odd < N)
          pe = ex2(logit2(a, tab, s[nt][e], (odd ? ri.y : ri.x) + coli[r], odd ? gi.y : gi.x,
                            colg[r]) -
                     (odd ? li.y : li.x));
        s[nt][e] = pe;
        dp[nt][e] = pe * (dp[nt][e] - (odd ? di.y : di.x));
      }
    }
    // dV += Pᵀ dO and dK += dSᵀ q, in two 32-query slices
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      if (sl * 4 >= live_nt) continue;
      float tv[4][4], tk[4][4];
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) tv[n8][e] = tk[n8][e] = 0.f;
#pragma unroll
      for (int ks = sl * 4; ks < sl * 4 + 4; ++ks) {
        if (ks >= live_nt) continue;
        uint32_t ph[4], pl[4], dh[4], dl[4];
        a_of_c(s[ks], ph, pl);
        a_of_c(dp[ks], dh, dl);
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8) {
          uint32_t bg[4], bq[4];
          ldsm4(bg, gtb + (n8 * 8 * LDT + ks * 8) * 4);
          ldsm4(bq, qtb + (n8 * 8 * LDT + ks * 8) * 4);
          mma3(tv[n8], ph, pl, bg[0], bg[1], bg[2], bg[3]);
          mma3(tk[n8], dh, dl, bq[0], bq[1], bq[2], bq[3]);
        }
      }
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv[n8][e] += tv[n8][e];
          dk[n8][e] += tk[n8][e];
        }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? kb : ka;
    if (key >= N) continue;
    const size_t off = base + (size_t)key * ld + 2 * t;
#pragma unroll
    for (int n8 = 0; n8 < 4; ++n8) {
      *reinterpret_cast<float2*>(a.dk + off + n8 * 8) =
          make_float2(a.scale * dk[n8][2 * r], a.scale * dk[n8][2 * r + 1]);
      *reinterpret_cast<float2*>(a.dv + off + n8 * 8) = make_float2(dv[n8][2 * r], dv[n8][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The table's gradient. bias_sum: gpart[0][h][i][j] = Σ_groups Σ_w
// gpart[g][w·heads + h][i][j], in place (each thread reads its own outputs'
// inputs before it writes). bias_table: dtable[t][h] = Σ_i gsum[h][i][j(t,i)]
// over the i whose column index(0, j) - index(0, 0) = t - index(i, 0) exists.

__global__ void __launch_bounds__(256) window_attention_bias_sum(const Args a, int groups) {
  const size_t nn = (size_t)a.N * a.N, total = (size_t)a.heads * nn;
  const int windows = a.P / a.heads;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t h = e / nn, ij = e % nn;
    float sum = 0.f;
    for (int gi = 0; gi < groups; ++gi)
      for (int w = 0; w < windows; ++w)
        sum += a.gpart[(((size_t)gi * a.P) + (size_t)w * a.heads + h) * nn + ij];
    a.gpart[e] = sum;
  }
}

__global__ void __launch_bounds__(128) window_attention_bias_table(const Args a) {
  __shared__ int rows[MAX_LEN];
  __shared__ int inv[2 * MAX_TABLE];  // column offset + T -> its column j, or -1
  const int N = a.N, T = a.T, h = blockIdx.y;
  for (int c = threadIdx.x; c < 2 * T; c += blockDim.x) inv[c] = -1;
  __syncthreads();
  const int64_t i00 = a.index[0];
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    rows[j] = (int)a.index[(size_t)j * a.index_ld];
    inv[(int)(a.index[j] - i00) + T] = j;
  }
  __syncthreads();
  const int tt = blockIdx.x * blockDim.x + threadIdx.x;
  if (tt >= T) return;
  const float* gs = a.gpart + (size_t)h * N * N;
  float sum = 0.f;
  for (int i = 0; i < N; ++i) {
    const int c = tt - rows[i] + T;
    if (c < 0 || c >= 2 * T) continue;
    const int j = inv[c];
    if (j >= 0) sum += gs[(size_t)i * N + j];
  }
  a.dtable[(size_t)tt * a.heads + h] = sum;
}

// ---------------------------------------------------------------------------
// Host side

bool g_fwd_done[MAX_DEV], g_dq_done[MAX_DEV], g_dkv_done[MAX_DEV];
int g_fwd_per_sm[MAX_DEV], g_dq_per_sm[MAX_DEV], g_dkv_per_sm[MAX_DEV];

int plan(Args& a, int B, int N, int P, int heads, int T, float scale) {
  if (B < 1 || B > 65535 || N < 1 || N > MAX_LEN || heads < 1 || P < heads || P % heads ||
      P > 65535 || T < 1 || T > MAX_TABLE)
    return (int)cudaErrorInvalidValue;
  a.B = B;
  a.N = N;
  a.P = P;
  a.heads = heads;
  a.T = T;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  return 0;
}

}  // namespace

// q, k, v [B][N][P·32], table [heads][T], index [N][N] (row stride
// index_ld), regions [P/heads][N] or null -> out [B][N][P·32], lse [B][P][N]
extern "C" int window_attention_fwd_launch(const void* q, const void* k, const void* v,
                                           const void* table, const void* index, long index_ld,
                                           const void* regions, void* out, void* lse, int B,
                                           int N, int P, int heads, int T, float scale,
                                           void* stream) {
  Args a = {};
  int rc = plan(a, B, N, P, heads, T, scale);
  if (rc) return rc;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.table = static_cast<const float*>(table);
  a.index = static_cast<const int64_t*>(index);
  a.index_ld = index_ld;
  a.regions = static_cast<const int*>(regions);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  int dev, sms;
  if ((rc = device_info(&dev, &sms))) return rc;
  if ((rc = configure(window_attention_fwd, dev, FWD_SMEM, THREADS, g_fwd_done, g_fwd_per_sm)))
    return rc;
  window_attention_fwd<<<dim3(cdiv(N, TILE), P, B), THREADS, FWD_SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Floats of scratch the backward needs: D [B][P][N] and the bias gradient
// [ceil(B / 9)][P][N][N].
extern "C" long window_attention_bwd_scratch(int B, int N, int P) {
  return (long)B * P * N + (long)cdiv(B, GROUP) * P * N * N;
}

// q, k, v, out, dout [B][N][P·32], lse [B][P][N] -> dq, dk, dv [B][N][P·32],
// dtable [T][heads]; scratch as window_attention_bwd_scratch says
extern "C" int window_attention_bwd_launch(const void* q, const void* k, const void* v,
                                           const void* out, const void* dout, const void* lse,
                                           const void* table, const void* index, long index_ld,
                                           const void* regions, void* scratch, void* dq,
                                           void* dk, void* dv, void* dtable, int B, int N, int P,
                                           int heads, int T, float scale, void* stream) {
  Args a = {};
  int rc = plan(a, B, N, P, heads, T, scale);
  if (rc) return rc;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(out);
  a.dout = static_cast<const float*>(dout);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.table = static_cast<const float*>(table);
  a.index = static_cast<const int64_t*>(index);
  a.index_ld = index_ld;
  a.regions = static_cast<const int*>(regions);
  a.dsum = static_cast<float*>(scratch);
  a.gpart = a.dsum + (size_t)B * P * N;
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dtable = static_cast<float*>(dtable);
  int dev, sms;
  if ((rc = device_info(&dev, &sms))) return rc;
  if ((rc = configure(window_attention_dq, dev, DQ_SMEM, THREADS, g_dq_done, g_dq_per_sm)))
    return rc;
  if ((rc = configure(window_attention_dkv, dev, DKV_SMEM, THREADS, g_dkv_done, g_dkv_per_sm)))
    return rc;
  const cudaStream_t s = (cudaStream_t)stream;
  const int groups = cdiv(B, GROUP), tiles = cdiv(N, TILE);
  window_attention_dq<<<dim3(tiles, P, groups), THREADS, DQ_SMEM, s>>>(a);
  if ((rc = (int)cudaGetLastError())) return rc;
  window_attention_dkv<<<dim3(tiles, P, B), THREADS, DKV_SMEM, s>>>(a);
  if ((rc = (int)cudaGetLastError())) return rc;
  const long total = (long)heads * N * N;
  window_attention_bias_sum<<<(int)imin((int)((total + 255) / 256), 8 * sms), 256, 0, s>>>(a, groups);
  if ((rc = (int)cudaGetLastError())) return rc;
  window_attention_bias_table<<<dim3(cdiv(T, 128), heads), 128, 0, s>>>(a);
  return (int)cudaGetLastError();
}
