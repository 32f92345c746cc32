// Noisy-linear forward and backward, hand-written for Hopper (sm_90a).
//
// Replaces rainbow_tpu/models/noisy.py::noisy_linear (noisy.py:57-94), which
// XLA fuses for the JAX package, and with the dueling-head kernel it does the
// forward work of the deleted Pallas kernel fused_dueling_head
// (rainbow_tpu/ops/pallas_kernels.py:173 before commit a426b6e).
//
//   y = x @ mu_w^T + ((x * eps_in) @ sigma_w^T) * eps_out
//       + mu_b + sigma_b * eps_out                       [then ReLU if asked]
//
// eps is absent (mu only), shared ((in,), (out,)) or per row ((B, in),
// (B, out)). The (out, in) perturbed weight mu + sigma * eps is never formed:
// two accumulators, one for mu and one for sigma, are fed by the same x tile
// and its eps_in-scaled copy. bf16 inputs are rounded as the JAX package
// casts them (weights, eps and biases to bf16; x * eps_in rounded) and
// accumulated in fp32; y is rounded once, at the store.
//
// The backward (noisy_linear_bwd, further down) gives, with g the incoming
// gradient masked by y > 0 when the layer has a ReLU:
//
//   dx    = g @ mu_w + ((g * eps_out) @ sigma_w) * eps_in
//   dmu_w = g^T x            dsigma_w = (g * eps_out)^T (x * eps_in)
//   dmu_b = sum_B g          dsigma_b = sum_B g * eps_out
//
// It replaces the backward that XLA derives from noisy.py:57-94 for the JAX
// package (jax.grad in agent.py:206), which the deleted Pallas kernel's
// custom VJP (pallas_kernels.py:126-158 before a426b6e) left to XLA too.
// bf16 x and g are rounded where the JAX package rounds (the eps-scaled
// copies, each product's output); the weight grads are stored as float32.
//
// What bounds them on the H100, and the design.
//
// Forward, small batch (the learner's B = 32 with shared eps, evaluation at
// B = 10, the 250-row validation chunks). At fc_h_* (3136 -> 512) the call
// reads both weights, 12.8 MB: about 4 us at 3.35 TB/s, against 0.2 GFLOP
// (3 us at 67 TFLOP/s fp32). Bound by bytes, and only if the weights stream
// from every SM at once: one block per 64-output tile would give 8 blocks
// for 132 SMs. So the input dimension is split into S chunks (split-K): a
// block owns a 16- or 32-row by 64-output tile and one chunk of at most 256
// inputs, and the launch plan (kernels/noisy_linear.py) picks S so that
// tiles x S fill at least one wave (fc_h, B = 32: 8 tiles x 17 chunks of
// 192). A block stages its x chunk and the eps_in-scaled copy once, and
// streams its mu_w and sigma_w slab through a 4-stage shared-memory ring
// filled by cp.async, three stages ahead of the one it computes on. Each
// block writes its two partial sums (mu and sigma) to a scratch tensor the
// wrapper allocates for the call, S x B x OUT floats a plane; a second
// kernel adds the S partials in the order s = 0 .. S-1 and applies the
// epilogue (mu_b + sigma_b * eps_out, eps_out on the sigma sum, the ReLU,
// the store in x's dtype). No float atomics: every launch gives the same
// bits.
//
// Forward, large batch (the actor's B = 1024, the round's 8192-row target
// forward). 4 * 1024 * 3136 * 512 = 6.6 GFLOP of fp32 FMA on the CUDA cores
// (TF32 is off on the main path): 0.1 ms, against 13 us of bytes. Bound by
// operations. A block owns a 128 x 128 tile; each thread an 8 x 8 tile of
// outputs in each accumulator, split in four 4 x 4 quarters so that the
// 16-byte shared-memory reads of a warp fall on distinct banks. Tiles of x,
// eps_in and both weights come in with 16-byte loads (8-byte for bf16 x)
// into registers while the block computes on the shared-memory stage
// before; they are rounded and eps_in-scaled as they are written to the
// other stage (two stages, one barrier a step). Where the tiles alone leave
// SMs idle (B = 1024: 32 tiles) the inputs are split as above, into as many
// chunks as whole waves allow (4).
//
// Rows whose length is not a multiple of 4, or pointers that are not
// 16-byte aligned, take the same paths with scalar loads (4-byte copies).
//
// Backward at the learner's shapes (B = 32, fc_h_*, shared eps): it reads
// mu_w and sigma_w for dx and writes dmu_w and dsigma_w, 4 * 6.4 MB =
// 25.7 MB (7.7 us at 3.35 TB/s), against 8 * 32 * 3136 * 512 = 0.41 GFLOP
// (6 us at 67 TFLOP/s): bound by bytes. One launch holds two kinds of
// block, and each weight-sized array is moved once. The dx blocks come
// first (the low block indices, so the longer work starts first): a dx block
// owns a 32-row by 64-input tile and one chunk of the outputs (the plan
// splits OUT so that the dx blocks alone fill a wave: 49 tiles x 3 chunks
// at fc_h), reading the mu_w and sigma_w rows of its chunk with 16-byte
// loads; a second kernel adds the S partials in order and rounds after the
// sum: dx = rnd(sum mu) + rnd(rnd(sum sigma) * eps_in). A weight block owns
// a 64 x 64 tile of dmu_w and dsigma_w and walks the batch 16 rows at a
// time, loading g and x with their eps-scaled copies into shared memory;
// it stores its grads with float4 stores, and the blocks of the first input
// tile also sum the bias grads. With eps_mode 0 dsigma is not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// Rounds a float32 value to the compute type's precision.
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The first n (at most 4; none if n <= 0) of four consecutive values, as
// float, the rest zero: one 16-byte load (8-byte for bf16) when vec and all
// four are wanted, else scalar loads.
__device__ __forceinline__ float4 load4(const float* p, int n, bool vec) {
  if (vec && n >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < n ? p[j] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int n,
                                        bool vec) {
  if (vec && n >= 4) {
    // bf16 -> fp32 is exact: the bf16 bits are the float's upper half.
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < n ? __bfloat162float(p[j]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float get(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// g masked by y > 0 when relu (the backward's mask), four at a time.
template <typename T>
__device__ __forceinline__ float4 load_g4(const T* g, const T* y, size_t i,
                                          int n, bool vec, int relu) {
  float4 v = load4(g + i, n, vec);
  if (relu) {
    const float4 m = load4(y + i, n, vec);
    v.x = m.x > 0.f ? v.x : 0.f;
    v.y = m.y > 0.f ? v.y : 0.f;
    v.z = m.z > 0.f ? v.z : 0.f;
    v.w = m.w > 0.f ? v.w : 0.f;
  }
  return v;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ------------------------------------------------------------ forward ----

// y[m, n] from the two full sums.
template <typename T, int EPS>
__device__ __forceinline__ void finish_y(float mu, float sig, int m, int n,
                                         const float* __restrict__ b_mu,
                                         const float* __restrict__ b_sig,
                                         const float* __restrict__ eps_out,
                                         T* __restrict__ y, int OUT,
                                         int relu) {
  float v = mu + rnd<T>(b_mu[n]);
  if constexpr (EPS != 0) {
    const float eo =
        rnd<T>(EPS == 1 ? eps_out[n] : eps_out[(size_t)m * OUT + n]);
    v += sig * eo + rnd<T>(b_sig[n]) * eo;
  }
  if (relu) v = fmaxf(v, 0.f);
  store(y + (size_t)m * OUT + n, v);
}

// A thread's two outputs (mu, sigma) at (m, n): into y, or, with part, into
// the partial sums of chunk blockIdx.z.
template <typename T, int EPS>
__device__ __forceinline__ void put_y(float mu, float sig, int m, int n,
                                      float* __restrict__ part,
                                      const float* __restrict__ b_mu,
                                      const float* __restrict__ b_sig,
                                      const float* __restrict__ eps_out,
                                      T* __restrict__ y, int B, int OUT,
                                      int relu) {
  if (part) {
    const size_t o = ((size_t)blockIdx.z * B + m) * OUT + n;
    part[o] = mu;
    if constexpr (EPS != 0) part[(size_t)gridDim.z * B * OUT + o] = sig;
  } else {
    finish_y<T, EPS>(mu, sig, m, n, b_mu, b_sig, eps_out, y, OUT, relu);
  }
}

// Small batch. A block owns BM (16 or 32) rows x SBN outputs x one chunk of
// at most CHUNK_MAX inputs. It stages its x chunk and the eps_in-scaled copy
// once, row-major, while the first NST - 1 stages of its mu_w and sigma_w
// slab are already on their way through a ring of NST shared-memory stages
// filled by cp.async (16 bytes a copy; 4 where rows are not 16-byte
// aligned), NST - 1 stages ahead of the stage it computes on. A thread owns
// rows ty + 16 i and outputs tx + 16 j: its reads of a padded weight row
// (SWP floats) fall on distinct banks, and those of an x row are shared by
// half a warp.
constexpr int SBN = 64;
constexpr int SBK = 16;           // inputs per ring stage
constexpr int SWP = SBK + 4;      // a weight row in the ring, padded
constexpr int NST = 4;            // ring stages
constexpr int CHUNK_MAX = 256;    // the most inputs a small-path block stages

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// Asynchronous copies into shared memory; the bytes past `bytes` (all, for
// 0) are written as zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dynamic shared memory of the small path for `steps` ring stages of x.
template <int EPS, int BM>
constexpr size_t small_smem(int steps) {
  return sizeof(float) * (EPS ? 2 : 1) *
         ((size_t)BM * (steps * SBK + 4) + (size_t)NST * SBN * SWP);
}

template <typename T, int EPS, int BM>
__global__ void __launch_bounds__(THREADS) noisy_linear_fwd_small(
    const T* __restrict__ x, const float* __restrict__ w_mu,
    const float* __restrict__ w_sig, const float* __restrict__ b_mu,
    const float* __restrict__ b_sig, const float* __restrict__ eps_in,
    const float* __restrict__ eps_out, T* __restrict__ y,
    float* __restrict__ part, int B, int IN, int OUT, int relu, int chunk,
    int vec) {
  constexpr int TM = BM / 16;
  constexpr int PL = EPS ? 2 : 1;  // planes: mu, and sigma
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * SBN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * chunk;
  const int len = min(IN, k_begin + chunk) - k_begin;
  const int steps = (len + SBK - 1) / SBK;
  const int xw = steps * SBK + 4;               // a staged x row, padded
  float* xs = smem;                             // [BM][xw]: x, then rnd(x * eps_in)
  float* ring = smem + PL * BM * xw;            // [NST][PL][SBN][SWP]

  // Stage s of the ring gets inputs k_begin + t * SBK ..: each copy is four
  // of one row of a weight.
  constexpr int WG = SBK / 4;                   // copies in a row
  constexpr int WL = SBN * WG / THREADS;        // copies a thread
  static_assert(SBN * WG % THREADS == 0, "whole copies a thread");
  auto load_w = [&](int s, int t) {
#pragma unroll
    for (int l = 0; l < WL; ++l) {
      const int f = tid + l * THREADS, wr = f / WG, wq = (f % WG) * 4;
      const int n_w = n0 + wr, k = t * SBK + wq;
      const int cnt = n_w < OUT ? min(4, len - k) : 0;
      const size_t off = cnt > 0 ? (size_t)n_w * IN + k_begin + k : 0;
#pragma unroll
      for (int p = 0; p < PL; ++p) {
        const float* w = p ? w_sig : w_mu;
        float* dst = ring + ((s * PL + p) * SBN + wr) * SWP + wq;
        if (vec) {
          cp_async16(dst, w + off, cnt > 0 ? 16 : 0);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            cp_async4(dst + j, w + off + (j < cnt ? j : 0), j < cnt ? 4 : 0);
        }
      }
    }
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < steps) load_w(s, s);
    cp_async_commit();
  }

  // The x chunk, zero past its end and past B, and its eps_in-scaled copy:
  // every load in flight before the first store.
  constexpr int XL = BM * CHUNK_MAX / 4 / THREADS;
  const int g_row = steps * SBK / 4;
  float4 v[XL], e[XL];
#pragma unroll
  for (int l = 0; l < XL; ++l) {
    const int f = tid + l * THREADS, r = f / g_row, k = (f % g_row) * 4;
    const int m = m0 + r;
    const int cnt = (f < BM * g_row && m < B) ? min(4, len - k) : 0;
    const size_t off = (size_t)m * IN + k_begin + k;
    v[l] = load4(x + off, cnt, vec);
    if constexpr (EPS == 1) e[l] = load4(eps_in + k_begin + k, cnt, vec);
    if constexpr (EPS == 2) e[l] = load4(eps_in + off, cnt, vec);
  }
#pragma unroll
  for (int l = 0; l < XL; ++l) {
    const int f = tid + l * THREADS, r = f / g_row, k = (f % g_row) * 4;
    if (f >= BM * g_row) break;
    *reinterpret_cast<float4*>(xs + r * xw + k) = v[l];
    if constexpr (EPS != 0)
      *reinterpret_cast<float4*>(xs + (BM + r) * xw + k) = make_float4(
          rnd<T>(v[l].x * rnd<T>(e[l].x)), rnd<T>(v[l].y * rnd<T>(e[l].y)),
          rnd<T>(v[l].z * rnd<T>(e[l].z)), rnd<T>(v[l].w * rnd<T>(e[l].w)));
  }

  float acc[PL][TM][4];
#pragma unroll
  for (int p = 0; p < PL; ++p)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[p][i][j] = 0.f;

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // stage t (and at t = 0 the x chunk) is in; the slot
                      // computed on at t - 1 is free
    if (t + NST - 1 < steps) load_w((t + NST - 1) % NST, t + NST - 1);
    cp_async_commit();
    const int st = t % NST;
#pragma unroll
    for (int p = 0; p < PL; ++p) {
      const float* wt = ring + (st * PL + p) * SBN * SWP;
      const float* xt = xs + p * BM * xw + t * SBK;
#pragma unroll
      for (int kq = 0; kq < SBK; kq += 4) {
        float a[TM][4], w[4][4];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 v =
              *reinterpret_cast<const float4*>(xt + (ty + 16 * i) * xw + kq);
          a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(wt + (tx + 16 * j) * SWP + kq);
          w[j][0] = rnd<T>(v.x); w[j][1] = rnd<T>(v.y);
          w[j][2] = rnd<T>(v.z); w[j][3] = rnd<T>(v.w);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[p][i][j] = fmaf(a[i][q], w[j][q], acc[p][i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < OUT)
        put_y<T, EPS>(acc[0][i][j], acc[PL - 1][i][j], m, n, part, b_mu,
                      b_sig, eps_out, y, B, OUT, relu);
    }
  }
}

// Large batch. A block owns an LBM x LBN tile; each thread an 8 x 8 tile of
// outputs in each accumulator, in four 4 x 4 quarters (rows 4 ty .. and
// 64 + 4 ty .., outputs likewise from tx), so that the 16-byte reads of a
// warp fall on distinct banks. Tiles of x, eps_in and both weights come in
// with 16-byte loads (8-byte for bf16 x) into registers while the block
// computes on the shared-memory stage before; they are rounded, eps_in-
// scaled and transposed k-major as they are written to the other stage.
constexpr int LBM = 128, LBN = 128, LBK = 8;

// A thread's 8 values of one k-row of a shared tile: 4 at 4 t .., 4 at
// 64 + 4 t ...
__device__ __forceinline__ void frag8(float (&v)[8], const float* row, int t) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * t);
  const float4 b = *reinterpret_cast<const float4*>(row + 64 + 4 * t);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ int frag8_row(int i, int t) {
  return i < 4 ? 4 * t + i : 64 + 4 * t + (i - 4);
}

template <typename T, int EPS>
__global__ void __launch_bounds__(THREADS) noisy_linear_fwd_large(
    const T* __restrict__ x, const float* __restrict__ w_mu,
    const float* __restrict__ w_sig, const float* __restrict__ b_mu,
    const float* __restrict__ b_sig, const float* __restrict__ eps_in,
    const float* __restrict__ eps_out, T* __restrict__ y,
    float* __restrict__ part, int B, int IN, int OUT, int relu, int chunk,
    int vec) {
  constexpr int SK = EPS ? LBK : 1;  // the sigma stages' depth
  constexpr int G = LBK / 4;         // four-wide groups in a tile row
  static_assert(LBM * G == THREADS && LBN * G == THREADS,
                "one load group a thread");
  __shared__ __align__(16) float xs[2][LBK][LBM];   // x, k-major
  __shared__ __align__(16) float xes[2][SK][LBM];   // rnd(x * eps_in)
  __shared__ __align__(16) float wms[2][LBK][LBN];  // mu_w, k-major
  __shared__ __align__(16) float wss[2][SK][LBN];   // sigma_w

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * LBN, m0 = blockIdx.y * LBM;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(IN, k_begin + chunk);
  const int lr = tid / G, lk = (tid % G) * 4;  // this thread's load group

  float4 rx, re, rw, rs;  // the next stage, in flight
  auto fetch = [&](int k0) {
    const int k = k0 + lk, m = m0 + lr, o = n0 + lr;
    const int nx = m < B ? min(4, k_end - k) : 0;
    const int nw = o < OUT ? min(4, k_end - k) : 0;
    rx = load4(x + (size_t)m * IN + k, nx, vec);
    if constexpr (EPS == 1) re = load4(eps_in + k, nx, vec);
    if constexpr (EPS == 2) re = load4(eps_in + (size_t)m * IN + k, nx, vec);
    rw = load4(w_mu + (size_t)o * IN + k, nw, vec);
    if constexpr (EPS != 0) rs = load4(w_sig + (size_t)o * IN + k, nw, vec);
  };
  auto stash = [&](int st) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = get(rx, j);
      xs[st][lk + j][lr] = v;
      wms[st][lk + j][lr] = rnd<T>(get(rw, j));
      if constexpr (EPS != 0) {
        xes[st][lk + j][lr] = rnd<T>(v * rnd<T>(get(re, j)));
        wss[st][lk + j][lr] = rnd<T>(get(rs, j));
      }
    }
  };

  float acc_mu[8][8];
  float acc_sig[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_mu[i][j] = acc_sig[i][j] = 0.f;

  const int steps = (k_end - k_begin + LBK - 1) / LBK;
  fetch(k_begin);
  stash(0);
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const int st = t & 1;
    const bool more = t + 1 < steps;
    if (more) fetch(k_begin + (t + 1) * LBK);
#pragma unroll
    for (int kk = 0; kk < LBK; ++kk) {
      float a[8], b[8];
      frag8(a, xs[st][kk], ty);
      frag8(b, wms[st][kk], tx);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc_mu[i][j] = fmaf(a[i], b[j], acc_mu[i][j]);
      if constexpr (EPS != 0) {
        frag8(a, xes[st][kk], ty);
        frag8(b, wss[st][kk], tx);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc_sig[i][j] = fmaf(a[i], b[j], acc_sig[i][j]);
      }
    }
    if (more) stash(st ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + frag8_row(i, ty);
    if (m >= B) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + frag8_row(j, tx);
      if (n < OUT)
        put_y<T, EPS>(acc_mu[i][j], acc_sig[i][j], m, n, part, b_mu, b_sig,
                      eps_out, y, B, OUT, relu);
    }
  }
}

// Adds the S partial sums of each output in the order s = 0 .. S-1 and
// applies the epilogue.
template <typename T, int EPS>
__global__ void __launch_bounds__(THREADS) noisy_linear_fwd_reduce(
    const float* __restrict__ part, int S, const float* __restrict__ b_mu,
    const float* __restrict__ b_sig, const float* __restrict__ eps_out,
    T* __restrict__ y, int B, int OUT, int relu) {
  const size_t total = (size_t)B * OUT;
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  float mu = 0.f, sig = 0.f;
  for (int s = 0; s < S; ++s) {
    mu += part[s * total + i];
    if constexpr (EPS != 0) sig += part[(S + s) * total + i];
  }
  finish_y<T, EPS>(mu, sig, (int)(i / OUT), (int)(i % OUT), b_mu, b_sig,
                   eps_out, y, OUT, relu);
}

struct FwdArgs {
  const void* x;
  const float *w_mu, *w_sig, *b_mu, *b_sig, *eps_in, *eps_out;
  void* y;
  float* part;
  int B, IN, OUT, relu, chunk, splits, vec;
  cudaStream_t stream;
};

// The main kernel for the batch tile (16 or 32 rows: small path; 128:
// large), then, with a split, the reduce.
template <typename T, int EPS>
cudaError_t launch_fwd(int tile, const FwdArgs& a) {
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  float* part = a.splits > 1 ? a.part : nullptr;
  if (tile == LBM) {
    const dim3 grid((a.OUT + LBN - 1) / LBN, (a.B + LBM - 1) / LBM,
                    a.splits);
    noisy_linear_fwd_large<T, EPS><<<grid, THREADS, 0, a.stream>>>(
        x, a.w_mu, a.w_sig, a.b_mu, a.b_sig, a.eps_in, a.eps_out, y, part,
        a.B, a.IN, a.OUT, a.relu, a.chunk, a.vec);
  } else if (tile == 16 || tile == 32) {
    if (a.chunk > CHUNK_MAX) return cudaErrorInvalidValue;
    auto kernel = tile == 16 ? noisy_linear_fwd_small<T, EPS, 16>
                             : noisy_linear_fwd_small<T, EPS, 32>;
    // Above 48 KB a block's shared memory must be asked for: once, as the
    // call costs the host far more than a launch.
    static const cudaError_t set16 = cudaFuncSetAttribute(
        noisy_linear_fwd_small<T, EPS, 16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)small_smem<EPS, 16>(CHUNK_MAX / SBK));
    static const cudaError_t set32 = cudaFuncSetAttribute(
        noisy_linear_fwd_small<T, EPS, 32>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)small_smem<EPS, 32>(CHUNK_MAX / SBK));
    if (set16 != cudaSuccess) return set16;
    if (set32 != cudaSuccess) return set32;
    const int steps = (min(a.chunk, a.IN) + SBK - 1) / SBK;
    const size_t bytes = tile == 16 ? small_smem<EPS, 16>(steps)
                                    : small_smem<EPS, 32>(steps);
    const dim3 grid((a.OUT + SBN - 1) / SBN, (a.B + tile - 1) / tile,
                    a.splits);
    kernel<<<grid, THREADS, bytes, a.stream>>>(
        x, a.w_mu, a.w_sig, a.b_mu, a.b_sig, a.eps_in, a.eps_out, y, part,
        a.B, a.IN, a.OUT, a.relu, a.chunk, a.vec);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !part) return err;
  const size_t total = (size_t)a.B * a.OUT;
  noisy_linear_fwd_reduce<T, EPS>
      <<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, a.stream>>>(
          part, a.splits, a.b_mu, a.b_sig, a.eps_out, y, a.B, a.OUT, a.relu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_eps(int eps_mode, int tile, const FwdArgs& a) {
  switch (eps_mode) {
    case 0: return launch_fwd<T, 0>(tile, a);
    case 1: return launch_fwd<T, 1>(tile, a);
    default: return launch_fwd<T, 2>(tile, a);
  }
}

// ----------------------------------------------------------- backward ----

constexpr int WT = 64;  // weight blocks: 64 outputs x 64 inputs; dx tiles'
                        // inputs
constexpr int BB = 16;  // batch rows per step of a weight block
constexpr int XM = 32;  // dx tiles' batch rows
constexpr int BO = 16;  // outputs per step of a dx block

struct BwdArgs {
  const void *x, *g, *y;
  const float *w_mu, *w_sig, *eps_in, *eps_out;
  void* dx;
  float *dw_mu, *dw_sig, *db_mu, *db_sig, *part;
  int B, IN, OUT, relu, chunk, splits, vec_in, vec_out;
  cudaStream_t stream;
};

// dx[b, k] from the two full sums, rounded after the sum.
template <typename T, int EPS>
__device__ __forceinline__ void finish_dx(float mu, float sig, int b, int k,
                                          const float* __restrict__ eps_in,
                                          T* __restrict__ dx, int IN) {
  float v = rnd<T>(mu);
  if constexpr (EPS != 0) {
    const float ei = rnd<T>(EPS == 1 ? eps_in[k] : eps_in[(size_t)b * IN + k]);
    v = v + rnd<T>(rnd<T>(sig) * ei);
  }
  store(dx + (size_t)b * IN + k, v);
}

// One XM x WT tile (rows m0.., inputs k0..) of dx over the outputs of chunk
// s, or its partial sums when the outputs are split.
template <typename T, int EPS>
__device__ void input_grad_tile(float* sm, const BwdArgs& a, int m0, int k0,
                                int s) {
  float (*gs)[BO][XM] = reinterpret_cast<float (*)[BO][XM]>(sm);
  float (*ges)[BO][XM] = gs + 2;
  float (*wms)[BO][WT] = reinterpret_cast<float (*)[BO][WT]>(sm + 4 * BO * XM);
  float (*wss)[BO][WT] = wms + 2;
  const T* g = static_cast<const T*>(a.g);
  const T* y = static_cast<const T*>(a.y);
  const int B = a.B, IN = a.IN, OUT = a.OUT;
  const int o_begin = s * a.chunk, o_end = min(OUT, o_begin + a.chunk);
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // inputs tx * 4 ..
  const int ty = tid / 16;  // rows ty and ty + 16
  // g loads (tid < 128): four outputs of one batch row; weight loads: four
  // inputs of one output.
  const int gr = tid / 4, gc = (tid % 4) * 4;
  const int wr = tid / 16, wc = (tid % 16) * 4;
  const bool gl = tid < XM * BO / 4;

  float4 rg, re, rw, rs;
  auto fetch = [&](int o0) {
    if (gl) {
      const int b = m0 + gr, o = o0 + gc;
      const int n = b < B ? min(4, o_end - o) : 0;
      const size_t i = (size_t)b * OUT + o;
      rg = load_g4(g, y, i, n, a.vec_out, a.relu);
      if constexpr (EPS == 1) re = load4(a.eps_out + o, n, a.vec_out);
      if constexpr (EPS == 2) re = load4(a.eps_out + i, n, a.vec_out);
    }
    const int o = o0 + wr, k = k0 + wc;
    const int n = o < o_end ? min(4, IN - k) : 0;
    rw = load4(a.w_mu + (size_t)o * IN + k, n, a.vec_in);
    if constexpr (EPS != 0) rs = load4(a.w_sig + (size_t)o * IN + k, n, a.vec_in);
  };
  auto stash = [&](int st) {
    if (gl) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = get(rg, j);
        gs[st][gc + j][gr] = v;
        if constexpr (EPS != 0)
          ges[st][gc + j][gr] = rnd<T>(v * rnd<T>(get(re, j)));
      }
    }
    *reinterpret_cast<float4*>(&wms[st][wr][wc]) = make_float4(
        rnd<T>(rw.x), rnd<T>(rw.y), rnd<T>(rw.z), rnd<T>(rw.w));
    if constexpr (EPS != 0)
      *reinterpret_cast<float4*>(&wss[st][wr][wc]) = make_float4(
          rnd<T>(rs.x), rnd<T>(rs.y), rnd<T>(rs.z), rnd<T>(rs.w));
  };

  float acc_mu[2][4], acc_sig[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_mu[i][j] = acc_sig[i][j] = 0.f;

  const int steps = (o_end - o_begin + BO - 1) / BO;
  fetch(o_begin);
  stash(0);
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const int st = t & 1;
    const bool more = t + 1 < steps;
    if (more) fetch(o_begin + (t + 1) * BO);
#pragma unroll
    for (int oo = 0; oo < BO; ++oo) {
      const float av[2] = {gs[st][oo][ty], gs[st][oo][ty + 16]};
      const float4 c = *reinterpret_cast<const float4*>(&wms[st][oo][tx * 4]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc_mu[i][j] = fmaf(av[i], get(c, j), acc_mu[i][j]);
      if constexpr (EPS != 0) {
        const float ae[2] = {ges[st][oo][ty], ges[st][oo][ty + 16]};
        const float4 ce =
            *reinterpret_cast<const float4*>(&wss[st][oo][tx * 4]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc_sig[i][j] = fmaf(ae[i], get(ce, j), acc_sig[i][j]);
      }
    }
    if (more) stash(st ^ 1);
    __syncthreads();
  }

  T* dx = static_cast<T*>(a.dx);
  const size_t plane = (size_t)a.splits * B * IN;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int b = m0 + ty + 16 * i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k >= IN) continue;
      if (a.splits > 1) {
        const size_t o = ((size_t)s * B + b) * IN + k;
        a.part[o] = acc_mu[i][j];
        if constexpr (EPS != 0) a.part[plane + o] = acc_sig[i][j];
      } else {
        finish_dx<T, EPS>(acc_mu[i][j], acc_sig[i][j], b, k, a.eps_in, dx,
                          IN);
      }
    }
  }
}

// One WT x WT tile (outputs n0.., inputs k0..) of dmu_w and dsigma_w; the
// blocks with k0 == 0 also write dmu_b and dsigma_b for their outputs.
template <typename T, int EPS>
__device__ void weight_grad_tile(float* sm, const BwdArgs& a, int n0,
                                 int k0) {
  float (*gs)[BB][WT] = reinterpret_cast<float (*)[BB][WT]>(sm);
  float (*ges)[BB][WT] = gs + 2;
  float (*xs)[BB][WT] = gs + 4;
  float (*xes)[BB][WT] = gs + 6;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  const T* y = static_cast<const T*>(a.y);
  const int B = a.B, IN = a.IN, OUT = a.OUT;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // inputs tx * 4 ..
  const int ty = tid / 16;  // outputs ty * 4 ..
  const int lb = tid / 16;  // load row (batch)
  const int lc = (tid % 16) * 4;
  const bool bias = k0 == 0;

  float4 rg, reo, rx, rei;
  auto fetch = [&](int b0) {
    const int b = b0 + lb, n = n0 + lc, k = k0 + lc;
    const int nn = b < B ? min(4, OUT - n) : 0;
    const int nk = b < B ? min(4, IN - k) : 0;
    const size_t gi = (size_t)b * OUT + n, xi = (size_t)b * IN + k;
    rg = load_g4(g, y, gi, nn, a.vec_out, a.relu);
    rx = load4(x + xi, nk, a.vec_in);
    if constexpr (EPS == 1) {
      reo = load4(a.eps_out + n, nn, a.vec_out);
      rei = load4(a.eps_in + k, nk, a.vec_in);
    }
    if constexpr (EPS == 2) {
      reo = load4(a.eps_out + gi, nn, a.vec_out);
      rei = load4(a.eps_in + xi, nk, a.vec_in);
    }
  };
  auto stash = [&](int st) {
    *reinterpret_cast<float4*>(&gs[st][lb][lc]) = rg;
    *reinterpret_cast<float4*>(&xs[st][lb][lc]) = rx;
    if constexpr (EPS != 0) {
      float ge[4], xe[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ge[j] = rnd<T>(get(rg, j) * rnd<T>(get(reo, j)));
        xe[j] = rnd<T>(get(rx, j) * rnd<T>(get(rei, j)));
      }
      *reinterpret_cast<float4*>(&ges[st][lb][lc]) =
          make_float4(ge[0], ge[1], ge[2], ge[3]);
      *reinterpret_cast<float4*>(&xes[st][lb][lc]) =
          make_float4(xe[0], xe[1], xe[2], xe[3]);
    }
  };

  float acc_mu[4][4], acc_sig[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_mu[i][j] = acc_sig[i][j] = 0.f;
  float bsum_mu = 0.f, bsum_sig = 0.f;

  const int steps = (B + BB - 1) / BB;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const int st = t & 1;
    const bool more = t + 1 < steps;
    if (more) fetch((t + 1) * BB);
#pragma unroll
    for (int bb = 0; bb < BB; ++bb) {
      const float4 av = *reinterpret_cast<const float4*>(&gs[st][bb][ty * 4]);
      const float4 cv = *reinterpret_cast<const float4*>(&xs[st][bb][tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc_mu[i][j] = fmaf(get(av, i), get(cv, j), acc_mu[i][j]);
      if constexpr (EPS != 0) {
        const float4 ae =
            *reinterpret_cast<const float4*>(&ges[st][bb][ty * 4]);
        const float4 ce =
            *reinterpret_cast<const float4*>(&xes[st][bb][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc_sig[i][j] = fmaf(get(ae, i), get(ce, j), acc_sig[i][j]);
      }
    }
    if (bias && tid < WT) {
#pragma unroll
      for (int bb = 0; bb < BB; ++bb) {
        bsum_mu += gs[st][bb][tid];
        if constexpr (EPS != 0) bsum_sig += ges[st][bb][tid];
      }
    }
    if (more) stash(st ^ 1);
    __syncthreads();
  }

  const int k = k0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= OUT || k >= IN) continue;
    const size_t o = (size_t)n * IN + k;
    if (a.vec_in && k + 4 <= IN) {
      *reinterpret_cast<float4*>(a.dw_mu + o) =
          make_float4(rnd<T>(acc_mu[i][0]), rnd<T>(acc_mu[i][1]),
                      rnd<T>(acc_mu[i][2]), rnd<T>(acc_mu[i][3]));
      if constexpr (EPS != 0)
        *reinterpret_cast<float4*>(a.dw_sig + o) =
            make_float4(rnd<T>(acc_sig[i][0]), rnd<T>(acc_sig[i][1]),
                        rnd<T>(acc_sig[i][2]), rnd<T>(acc_sig[i][3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k + j >= IN) break;
        a.dw_mu[o + j] = rnd<T>(acc_mu[i][j]);
        if constexpr (EPS != 0) a.dw_sig[o + j] = rnd<T>(acc_sig[i][j]);
      }
    }
  }
  if (bias && tid < WT && n0 + tid < OUT) {
    a.db_mu[n0 + tid] = rnd<T>(bsum_mu);
    if constexpr (EPS != 0) a.db_sig[n0 + tid] = rnd<T>(bsum_sig);
  }
}

// Blocks [0, n_xblocks) are dx blocks (chunk-major), the rest weight blocks.
template <typename T, int EPS>
__global__ void __launch_bounds__(THREADS)
    noisy_linear_bwd_kernel(const BwdArgs a, int n_xblocks) {
  __shared__ __align__(16) float sm[8 * BB * WT];  // 32 KB; dx uses 24
  const int k_tiles = (a.IN + WT - 1) / WT;
  int blk = blockIdx.x;
  if (blk < n_xblocks) {
    const int x_tiles = ((a.B + XM - 1) / XM) * k_tiles;
    const int s = blk / x_tiles;
    blk %= x_tiles;
    input_grad_tile<T, EPS>(sm, a, (blk / k_tiles) * XM, (blk % k_tiles) * WT,
                            s);
  } else {
    blk -= n_xblocks;
    weight_grad_tile<T, EPS>(sm, a, (blk / k_tiles) * WT,
                             (blk % k_tiles) * WT);
  }
}

// Adds the S partial sums of each dx element in the order s = 0 .. S-1,
// then rounds.
template <typename T, int EPS>
__global__ void __launch_bounds__(THREADS) noisy_linear_dx_reduce(
    const float* __restrict__ part, int S, const float* __restrict__ eps_in,
    T* __restrict__ dx, int B, int IN) {
  const size_t total = (size_t)B * IN;
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  float mu = 0.f, sig = 0.f;
  for (int s = 0; s < S; ++s) {
    mu += part[s * total + i];
    if constexpr (EPS != 0) sig += part[(S + s) * total + i];
  }
  finish_dx<T, EPS>(mu, sig, (int)(i / IN), (int)(i % IN), eps_in, dx, IN);
}

template <typename T, int EPS>
cudaError_t launch_bwd(const BwdArgs& a) {
  const int k_tiles = (a.IN + WT - 1) / WT;
  const int n_xblocks = ((a.B + XM - 1) / XM) * k_tiles * a.splits;
  const int n_wblocks = ((a.OUT + WT - 1) / WT) * k_tiles;
  noisy_linear_bwd_kernel<T, EPS>
      <<<n_xblocks + n_wblocks, THREADS, 0, a.stream>>>(a, n_xblocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const size_t total = (size_t)a.B * a.IN;
  noisy_linear_dx_reduce<T, EPS>
      <<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, a.stream>>>(
          a.part, a.splits, a.eps_in, static_cast<T*>(a.dx), a.B, a.IN);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_eps(int eps_mode, const BwdArgs& a) {
  switch (eps_mode) {
    case 0: return launch_bwd<T, 0>(a);
    case 1: return launch_bwd<T, 1>(a);
    default: return launch_bwd<T, 2>(a);
  }
}

// A split of n reduction elements into `splits` chunks of `chunk`: every
// chunk non-empty, the partials' scratch given when there is more than one.
bool valid_split(int n, int chunk, int splits, const float* scratch) {
  return n > 0 && chunk > 0 && splits > 0 && (long)chunk * splits >= n &&
         (long)chunk * (splits - 1) < n && (splits == 1 || scratch);
}

}  // namespace

// x and y are float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1); all other
// tensors float32. The launch plan (kernels/noisy_linear.py::fwd_plan):
// tile is the block tile's batch rows (16 or 32: small batch; 128: large),
// the inputs are split into `splits` chunks of `chunk`, and with more than
// one the partial sums go to `scratch` ((eps_mode ? 2 : 1) * splits * B *
// OUT floats). Returns cudaGetLastError() after the launches.
extern "C" int noisy_linear_fwd(const void* x, int x_bf16, const float* w_mu,
                                const float* w_sig, const float* b_mu,
                                const float* b_sig, const float* eps_in,
                                const float* eps_out, int eps_mode, void* y,
                                int B, int IN, int OUT, int relu,
                                void* stream, int tile, int chunk,
                                int splits, float* scratch) {
  if (B <= 0 || OUT <= 0 || !valid_split(IN, chunk, splits, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const int unit = x_bf16 ? 8 : 16;  // bytes of four x values
  const bool vec = IN % 4 == 0 && chunk % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) % unit) == 0 &&
                   aligned16(w_mu) && aligned16(w_sig) &&
                   (eps_mode == 0 || aligned16(eps_in));
  FwdArgs a{x, w_mu, w_sig, b_mu, b_sig, eps_in, eps_out, y, scratch,
            B, IN, OUT, relu, chunk, splits, vec,
            static_cast<cudaStream_t>(stream)};
  const cudaError_t err =
      x_bf16 ? launch_fwd_eps<__nv_bfloat16>(eps_mode, tile, a)
             : launch_fwd_eps<float>(eps_mode, tile, a);
  return static_cast<int>(err);
}

// Backward. x, g (the gradient into y), y (the forward's output, read only
// when relu = 1) and dx are float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1);
// the weights, eps and the four parameter grads float32. The plan
// (kernels/noisy_linear.py::bwd_plan) splits dx's reduction over the
// outputs into `splits` chunks of `chunk`, the partials in `scratch`
// ((eps_mode ? 2 : 1) * splits * B * IN floats). With eps_mode 0 dsigma_w
// and dsigma_b are not written. Returns cudaGetLastError().
extern "C" int noisy_linear_bwd(const void* x, const void* g, const void* y,
                                int x_bf16, const float* w_mu,
                                const float* w_sig, const float* eps_in,
                                const float* eps_out, int eps_mode, void* dx,
                                float* dw_mu, float* dw_sig, float* db_mu,
                                float* db_sig, int B, int IN, int OUT,
                                int relu, void* stream, int chunk, int splits,
                                float* scratch) {
  if (B <= 0 || IN <= 0 || !valid_split(OUT, chunk, splits, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const int unit = x_bf16 ? 8 : 16;
  auto fits = [unit](const void* p) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) % unit) == 0;
  };
  const bool vec_in = IN % 4 == 0 && fits(x) && aligned16(w_mu) &&
                      aligned16(w_sig) && aligned16(dw_mu) &&
                      aligned16(dw_sig) &&
                      (eps_mode == 0 || aligned16(eps_in));
  const bool vec_out = OUT % 4 == 0 && chunk % 4 == 0 && fits(g) && fits(y) &&
                       (eps_mode == 0 || aligned16(eps_out));
  BwdArgs a{x, g, relu ? y : nullptr, w_mu, w_sig, eps_in, eps_out, dx,
            dw_mu, dw_sig, db_mu, db_sig, scratch, B, IN, OUT, relu, chunk,
            splits, vec_in, vec_out, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = x_bf16 ? launch_bwd_eps<__nv_bfloat16>(eps_mode, a)
                                 : launch_bwd_eps<float>(eps_mode, a);
  return static_cast<int>(err);
}
