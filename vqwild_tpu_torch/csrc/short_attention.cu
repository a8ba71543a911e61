// K5: multi-head self-attention over short sequences, fp32, forward and
//     backward, on the packed output of the qkv linear: qkv [n][L][3·D] with
//     each row's features in (3, heads, head_dim) order, D = heads·head_dim.
//     Forward: o[s][i][h] = Σ_j P_ij v_j with P_i = softmax_j(scale · q_i·k_j),
//     written as o [n][L][D]. Backward: from qkv and dO [n][L][D], one packed
//     dqkv [n][L][3·D]: dV_j = Σ_i P_ij dO_i, dP_ij = dO_i·v_j,
//     D_i = Σ_j P_ij dP_ij, dS_ij = P_ij (dP_ij − D_i),
//     dQ_i = scale Σ_j dS_ij k_j, dK_j = scale Σ_i dS_ij q_i.
//
// Replaces no TPU kernel: the JAX package has no TimeSformer. It was added
// for the TimeSformer trunk's temporal attention (L = 8 frames, 12 heads of
// 64, 5,880 sequences a train step's call), which PyTorch's memory-efficient
// kernel ran in 64 x 64 tiles with 8 of 64 rows and columns at work, and
// whose qkv gradient autograd assembled from three zero-filled full-size
// buffers (one per select of q, k and v) and two adds.
//
// What bounds it on an H100: bytes. A (sequence, head) pair reads 3·L·hd
// floats and does 4·L²·hd FLOP forward (2 FLOP a byte at L = 8), 10·L²·hd
// backward: the CUDA cores' 67 TFLOP/s over 3.35 TB/s is 20 FLOP a byte, so
// every shape it takes (L <= 16) is bound by its bytes: forward qkv in and o
// out, 0.173 ms a call at the trunk's shape; backward qkv and dO in, dqkv
// out, 0.302 ms. The softmax is recomputed in the backward (L <= 16: a few
// FLOP a byte), so nothing but qkv is kept between the passes.
//
// What the design does about it:
//  - A warp owns one sequence and 32 / G heads, G = the power of two at or
//    above head_dim / 4: lane c of a head's group of G lanes holds features
//    [4c, 4c + 4) of that head's rows in registers. A warp's load of one row
//    (one float4 a lane) is 16 · 32 contiguous bytes at head_dim 64: four
//    whole 128-byte lines, 16-byte loads; its stores of o and dqkv are the
//    same whole lines. Every row segment a warp touches starts on a 256-byte
//    boundary at head_dim 64 (rows are 9,216 bytes, heads 256).
//  - The warp loads its sequence's q, k, v (and dO) rows up front, all
//    independent loads: 24 (forward) or 32 (backward) 16-byte loads a lane,
//    12-16 KB a warp in flight. Blocks are two warps and hold no shared
//    memory, so a warp's block retires when it ends and the next starts at
//    once: the 8-16 warps resident on an SM are at different phases, and
//    some always have their loads in flight (at 3.35 TB/s and ~1 us of
//    latency the card needs ~25 KB in flight an SM). No shared-memory ring
//    is needed: registers are the staging buffer.
//  - Each dot product q_i·k_j (dO_i·v_j) is 4 fp32 FMAs a lane and a
//    butterfly of log2(G) shuffles over the group, after which every lane of
//    the group holds the same sums bit for bit (a + b = b + a). So the
//    softmax, D_i and dS are computed in every lane from the same values,
//    and each lane then forms its own features of o, dQ, dK and dV with
//    FMAs: no shared memory, no barrier, and the only cross-lane traffic is
//    L² · log2(G) shuffles of a row block (2 L² · log2(G) backward).
//  - exact fp32: FMAs on the CUDA cores (no tensor core: at 2-3 FLOP a byte
//    they would buy nothing), the softmax's exponent by exp2f of
//    (s - max) · scale · log2(e), a 1/sum, every pass in one order, no
//    atomics: a run repeats bit for bit.
//  - L is a runtime value up to LM, the template's row count (8 or 16):
//    rows past L are zeros and are masked out of the softmax. LM = 8 holds
//    everything in registers (forward 120 a thread, backward 234, no
//    spill). LM = 16 holds twice as many: its backward spills to local
//    memory (8 KB a thread by ptxas) and is slower, but it is right, and it
//    runs only for 9 <= L <= 16, which no cell times.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 2;  // warps (tasks) a block
constexpr int MAX_LEN = 16;
constexpr int MAX_HEAD_DIM = 128;
constexpr float LOG2E = 1.4426950408889634f;

struct Shape {
  long tasks;   // n · groups
  int groups;   // head groups a sequence: ceil(heads / (32 / G))
  int L, heads, hd, G;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}
__device__ __forceinline__ void axpy4(float4& y, float a, float4 x) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}
__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// Sum each entry of a over the lane's group of G lanes (a butterfly); every
// lane of the group ends with the same sums.
template <int N>
__device__ __forceinline__ void group_sum(float (&a)[N], int G) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < G) {
#pragma unroll
      for (int j = 0; j < N; ++j) a[j] += __shfl_xor_sync(0xffffffffu, a[j], off);
    }
  }
}

// p[j] = exp(scale · (s[j] − max)) over j < L (0 past L); returns 1 / Σ p.
template <int LM>
__device__ __forceinline__ float softmax_rows(float (&s)[LM], float (&p)[LM], int L,
                                              float scale_log2) {
  float m = s[0];
#pragma unroll
  for (int j = 1; j < LM; ++j)
    if (j < L) m = fmaxf(m, s[j]);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < LM; ++j) {
    p[j] = j < L ? exp2f((s[j] - m) * scale_log2) : 0.f;
    sum += p[j];
  }
  return 1.f / sum;
}

// Where a lane's features lie: its sequence's first row, its head and chunk
// offset, and whether it holds a real head's real features.
struct Lane {
  size_t seq;  // float offset of the sequence's first qkv row
  size_t out;  // float offset of its first o / dO row, with the lane's columns
  int col;     // h · hd + 4c
  bool on;
};

__device__ __forceinline__ Lane lane_of(const Shape& sh, long task) {
  const int lane = threadIdx.x & 31;
  const long s = task / sh.groups;
  const int hg = (int)(task % sh.groups);
  const int h = hg * (32 / sh.G) + lane / sh.G;
  const int c = lane & (sh.G - 1);
  const int D = sh.heads * sh.hd;
  Lane r;
  r.on = h < sh.heads && 4 * c < sh.hd;
  r.col = r.on ? h * sh.hd + 4 * c : 0;
  r.seq = (size_t)s * sh.L * 3 * D;
  r.out = (size_t)s * sh.L * D + r.col;
  return r;
}

template <int LM>
__global__ void __launch_bounds__(WARPS * 32, LM == 8 ? 8 : 4)
    short_attention_fwd(const float* __restrict__ qkv, float* __restrict__ out, Shape sh,
                        float scale_log2) {
  const long task = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (task >= sh.tasks) return;  // the whole warp: task is the warp's
  const Lane ln = lane_of(sh, task);
  const int L = sh.L, D = sh.heads * sh.hd;
  const float* row = qkv + ln.seq + ln.col;
  float4 q[LM], k[LM], v[LM];
#pragma unroll
  for (int j = 0; j < LM; ++j) {
    const bool live = ln.on && j < L;
    const float* r = row + (size_t)j * 3 * D;
    q[j] = live ? ld4(r) : zero4();
    k[j] = live ? ld4(r + D) : zero4();
    v[j] = live ? ld4(r + 2 * D) : zero4();
  }
#pragma unroll
  for (int i = 0; i < LM; ++i) {
    if (i >= L) break;
    float s[LM], p[LM];
#pragma unroll
    for (int j = 0; j < LM; ++j) s[j] = dot4(q[i], k[j]);
    group_sum(s, sh.G);
    const float inv = softmax_rows(s, p, L, scale_log2);
    float4 o = zero4();
#pragma unroll
    for (int j = 0; j < LM; ++j) axpy4(o, p[j], v[j]);
    if (ln.on) st4(out + ln.out + (size_t)i * D, make_float4(o.x * inv, o.y * inv, o.z * inv,
                                                            o.w * inv));
  }
}

template <int LM>
__global__ void __launch_bounds__(WARPS * 32, LM == 8 ? 4 : 2)
    short_attention_bwd(const float* __restrict__ qkv, const float* __restrict__ dout,
                        float* __restrict__ dqkv, Shape sh, float scale, float scale_log2) {
  const long task = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (task >= sh.tasks) return;
  const Lane ln = lane_of(sh, task);
  const int L = sh.L, D = sh.heads * sh.hd;
  const float* row = qkv + ln.seq + ln.col;
  float4 q[LM], k[LM], v[LM], g[LM];
#pragma unroll
  for (int j = 0; j < LM; ++j) {
    const bool live = ln.on && j < L;
    const float* r = row + (size_t)j * 3 * D;
    q[j] = live ? ld4(r) : zero4();
    k[j] = live ? ld4(r + D) : zero4();
    v[j] = live ? ld4(r + 2 * D) : zero4();
    g[j] = live ? ld4(dout + ln.out + (size_t)j * D) : zero4();
  }
  float4 dk[LM], dv[LM];
#pragma unroll
  for (int j = 0; j < LM; ++j) dk[j] = dv[j] = zero4();
  float* drow = dqkv + ln.seq + ln.col;
#pragma unroll
  for (int i = 0; i < LM; ++i) {
    if (i >= L) break;
    float s[LM], dp[LM], p[LM];
#pragma unroll
    for (int j = 0; j < LM; ++j) {
      s[j] = dot4(q[i], k[j]);
      dp[j] = dot4(g[i], v[j]);
    }
    group_sum(s, sh.G);
    group_sum(dp, sh.G);
    const float inv = softmax_rows(s, p, L, scale_log2);
    float di = 0.f;
#pragma unroll
    for (int j = 0; j < LM; ++j) {
      p[j] *= inv;  // P_ij
      di = fmaf(p[j], dp[j], di);
    }
    float4 dq = zero4();
#pragma unroll
    for (int j = 0; j < LM; ++j) {
      const float ds = p[j] * (dp[j] - di) * scale;  // scale · dS_ij
      axpy4(dq, ds, k[j]);
      axpy4(dk[j], ds, q[i]);
      axpy4(dv[j], p[j], g[i]);
    }
    if (ln.on) st4(drow + (size_t)i * 3 * D, dq);
  }
#pragma unroll
  for (int j = 0; j < LM; ++j) {
    if (j >= L) break;
    if (ln.on) {
      st4(drow + (size_t)j * 3 * D + D, dk[j]);
      st4(drow + (size_t)j * 3 * D + 2 * D, dv[j]);
    }
  }
}

// The shape of a call, or a cudaError_t if the kernels do not take it.
int plan(int n, int L, int heads, int hd, Shape* sh) {
  if (n < 1 || L < 1 || L > MAX_LEN || heads < 1 || hd < 4 || hd > MAX_HEAD_DIM || hd % 4)
    return (int)cudaErrorInvalidValue;
  int G = 1;
  while (G < hd / 4) G *= 2;
  sh->G = G;
  sh->groups = (heads + 32 / G - 1) / (32 / G);
  sh->tasks = (long)n * sh->groups;
  sh->L = L;
  sh->heads = heads;
  sh->hd = hd;
  if ((sh->tasks + WARPS - 1) / WARPS >= (1L << 31)) return (int)cudaErrorInvalidValue;
  return 0;
}

dim3 grid_of(const Shape& sh) { return dim3((unsigned)((sh.tasks + WARPS - 1) / WARPS)); }

}  // namespace

// qkv [n][L][3·heads·hd] -> out [n][L][heads·hd]
extern "C" int short_attention_fwd_launch(const void* qkv, void* out, int n, int L, int heads,
                                          int hd, float scale, void* stream) {
  Shape sh;
  const int rc = plan(n, L, heads, hd, &sh);
  if (rc) return rc;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* in = static_cast<const float*>(qkv);
  float* o = static_cast<float*>(out);
  if (L <= 8)
    short_attention_fwd<8><<<grid_of(sh), WARPS * 32, 0, s>>>(in, o, sh, scale * LOG2E);
  else
    short_attention_fwd<16><<<grid_of(sh), WARPS * 32, 0, s>>>(in, o, sh, scale * LOG2E);
  return (int)cudaGetLastError();
}

// qkv [n][L][3·heads·hd], dout [n][L][heads·hd] -> dqkv [n][L][3·heads·hd]
extern "C" int short_attention_bwd_launch(const void* qkv, const void* dout, void* dqkv, int n,
                                          int L, int heads, int hd, float scale, void* stream) {
  Shape sh;
  const int rc = plan(n, L, heads, hd, &sh);
  if (rc) return rc;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* in = static_cast<const float*>(qkv);
  const float* g = static_cast<const float*>(dout);
  float* d = static_cast<float*>(dqkv);
  if (L <= 8)
    short_attention_bwd<8><<<grid_of(sh), WARPS * 32, 0, s>>>(in, g, d, sh, scale, scale * LOG2E);
  else
    short_attention_bwd<16><<<grid_of(sh), WARPS * 32, 0, s>>>(in, g, d, sh, scale,
                                                                scale * LOG2E);
  return (int)cudaGetLastError();
}
