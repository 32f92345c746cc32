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
// float32 runs on the CUDA cores (TF32 is off on the main path); bf16 runs
// on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32 accumulators,
// the section "bf16 on the tensor cores" below), as the JAX package's bf16
// products run on a TPU's matrix unit.
//
// What bounds the float32 kernels on the H100, and their design.
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
// eps_in and both weights come in with 16-byte loads into registers while
// the block computes on the shared-memory stage before; they are eps_in-
// scaled as they are written to the other stage (two stages, one barrier a step). Where the tiles alone leave
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
//
// A float32 backward with no or shared eps at a large batch is two
// operation-bound products: it has a path of its own
// (noisy_linear_bwd_large, the section "float32 backward, large batch"),
// which the plan takes from BWD_LARGE_ROWS batch rows up.

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

// The first n (at most 4; none if n <= 0) of four consecutive floats, the
// rest zero: one 16-byte load when vec and all four are wanted, else scalar
// loads.
__device__ __forceinline__ float4 load4(const float* p, int n, bool vec) {
  if (vec && n >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < n ? p[j] : 0.f;
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
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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
// with 16-byte loads into registers while the block computes on the
// shared-memory stage before; they are eps_in-scaled and transposed k-major
// as they are written to the other stage.
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

// The reduce of a split forward's partials (a.part) into y.
template <typename T, int EPS>
cudaError_t launch_fwd_reduce(const FwdArgs& a) {
  const size_t total = (size_t)a.B * a.OUT;
  noisy_linear_fwd_reduce<T, EPS>
      <<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, a.stream>>>(
          a.part, a.splits, a.b_mu, a.b_sig, a.eps_out, static_cast<T*>(a.y),
          a.B, a.OUT, a.relu);
  return cudaGetLastError();
}

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
  return launch_fwd_reduce<T, EPS>(a);
}

cudaError_t launch_fwd_fp32(int eps_mode, int tile, const FwdArgs& a) {
  switch (eps_mode) {
    case 0: return launch_fwd<float, 0>(tile, a);
    case 1: return launch_fwd<float, 1>(tile, a);
    default: return launch_fwd<float, 2>(tile, a);
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

// The reduce of a split backward's dx partials (a.part) into dx.
template <typename T, int EPS>
cudaError_t launch_dx_reduce(const BwdArgs& a) {
  const size_t total = (size_t)a.B * a.IN;
  noisy_linear_dx_reduce<T, EPS>
      <<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, a.stream>>>(
          a.part, a.splits, a.eps_in, static_cast<T*>(a.dx), a.B, a.IN);
  return cudaGetLastError();
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
  return launch_dx_reduce<T, EPS>(a);
}

cudaError_t launch_bwd_fp32(int eps_mode, const BwdArgs& a) {
  switch (eps_mode) {
    case 0: return launch_bwd<float, 0>(a);
    case 1: return launch_bwd<float, 1>(a);
    default: return launch_bwd<float, 2>(a);
  }
}

// ===================== float32 backward, large batch, no or shared eps ====
//
// With shared noise the perturbation sigma_w * (eps_out eps_in^T) is a
// rank-one scaling, so the backward is two products, not four; with g
// masked by y > 0:
//
//   dx    = g @ W_eff,  W_eff = mu_w + sigma_w * (eps_out eps_in^T)
//   dmu_w = g^T x       dsigma_w = dmu_w * (eps_out eps_in^T)
//   dmu_b = sum_B g     dsigma_b = eps_out * dmu_b
//
// (without eps, W_eff = mu_w and the sigma grads are not written). These
// are the gradients above; only the order of the float32 roundings
// differs. It replaces no TPU kernel: it is a second path of the backward
// above (XLA's derived backward of rainbow_tpu/models/noisy.py:57-94), for
// the float32 learner at large batches.
//
// Bound. At the learner's fc_h with a large batch (B = 1024, 3136 -> 512)
// that is 4 * B * IN * OUT = 6.6 GFLOP of FFMA on the CUDA cores (TF32
// stays off): 0.098 ms at 67 TFLOP/s, against 13 MB of inputs and grads
// (4 us at 3.35 TB/s). Bound by operations.
//
// Design. One launch of 128 x 128 output tiles of two kinds: weight
// tiles (outputs x inputs of dmu_w, reduced over the batch) and dx tiles
// (rows x inputs, reduced over the outputs), the kind with the longer
// reduction first; at fc_h, B = 1024, 100 weight tiles of K 1,024, then
// 200 dx tiles of K 512. A tile whose inputs end within its first half
// (3136 = 24.5 tiles) computes that half alone, which evens the SMs'
// shares out (96 stages of 16 steps each where 128 would be the longest).
// A thread owns an 8 x 8 register tile in four 4 x 4 quarters, as in
// noisy_linear_fwd_large, so that a warp's 16-byte shared-memory reads
// fall on distinct banks; two such reads feed 64 FFMA, so shared memory
// and the FMA pipes run near par (on the H100 about 55 % of the FP32 peak
// where the work divides evenly). Each stage's 16 steps are summed into a fresh
// partial, added to the total: blocked sums, whose rounding over a batch
// of 1,024 stays near that of the plain version's products (a single chain
// of fmaf rounds about 3x worse, and dsigma_w, scaled from dmu_w, would
// carry it), for 64 more registers, so a block has an SM to itself.
// Operands are staged k-major, rows padded to GP floats, in a ring of
// three stages. x comes by cp.async, two stages ahead. Operands that
// change on their way in come through registers one stage ahead: 16-byte
// loads issued before the stage before is computed, transformed and
// stored after it, so their latency hides behind it: g masked by y > 0;
// in dx tiles g transposed (a dx tile reduces over g's columns) and W_eff
// formed in float32 from the mu_w and sigma_w rows, eps_in (held in
// registers) and eps_out, so W_eff is never written to device memory.
// Rows or pointers that do not allow 16-byte accesses take 4-byte ones.
// dsigma_w and the bias grads are formed in the epilogue.
//
// The plan (kernels/noisy_linear.py::bwd_plan) takes this path for float32
// with no or shared noise from BWD_LARGE_ROWS batch rows up. Where the
// tiles alone would leave SMs idle it splits the longer reduction (the
// weight tiles' batch or the dx tiles' outputs) into chunks; each chunk
// writes its partial sums to the call's scratch and
// noisy_linear_bwd_large_reduce adds them in chunk order and applies the
// epilogue. No float atomics: every launch gives the same bits.
constexpr int GT = 128;      // a tile's edge
constexpr int GK = 16;       // reduction steps a stage
constexpr int GP = GT + 4;   // a staged row, padded: a warp's transposed
                             // stores of g fall on two banks at most
constexpr int GS = GK * GP;  // floats of one staged operand
constexpr int GOPS = 2;      // staged operands: g and x (weight tiles), g
                             // and W_eff (dx tiles)
constexpr int GST = 3;       // stages in the ring
constexpr int LARGE_SMEM = (int)sizeof(float) * GST * GOPS * GS;

struct BwdLargeArgs {
  const float *x, *g, *y, *w_mu, *w_sig, *eps_in, *eps_out;
  float *dx, *dw_mu, *dw_sig, *db_mu, *db_sig, *part;
  int B, IN, OUT, relu, chunk, splits, w_chunk, w_splits, vec_in, vec_out;
  cudaStream_t stream;
};

// The scratch: with the batch split, w_splits planes of OUT x IN weight
// partials and then w_splits rows of OUT bias partials, rounded up to a
// multiple of 4 floats; then, with the outputs split, splits planes of B x
// IN dx partials.
__host__ __device__ inline size_t w_part_floats(const BwdLargeArgs& a) {
  if (a.w_splits == 1) return 0;
  const size_t n = (size_t)a.w_splits * ((size_t)a.OUT * a.IN + a.OUT);
  return (n + 3) / 4 * 4;
}

constexpr int GL = GK * GT / 4 / THREADS;  // 16-byte groups a thread stages

// Rows r0 .. r0 + GK (those below r_end) by columns c0 .. c0 + GT (those
// below c_end) of a row-major matrix with rows of ld floats, into a staged
// operand by cp.async, zeros elsewhere. Copy l of thread t is group f = t +
// l * THREADS: row f / 32, columns 4 (f % 32) ..
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int ld, int r0, int r_end, int c0,
                                           int c_end, int vec) {
#pragma unroll
  for (int l = 0; l < GL; ++l) {
    const int f = threadIdx.x + l * THREADS;
    const int r = f / (GT / 4), c = (f % (GT / 4)) * 4;
    const int cnt = r0 + r < r_end ? max(0, min(4, c_end - c0 - c)) : 0;
    const float* p = src + (cnt > 0 ? (size_t)(r0 + r) * ld + c0 + c : 0);
    float* d = dst + r * GP + c;
    if (vec) {
      cp_async16(d, p, 4 * cnt);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async4(d + j, p + (j < cnt ? j : 0), j < cnt ? 4 : 0);
    }
  }
}

// Loads this thread's groups of a stage (rows r0 .. r0 + GK below r_end,
// columns c0 .. c0 + GT below c_end, of a row-major matrix with rows of ld
// floats), group l at row (t + l * THREADS) / 32, columns 4 (t % 32) ..;
// zeros past the ends.
__device__ __forceinline__ void fetch_rows(float4 (&v)[GL], const float* src,
                                           int ld, int r0, int r_end, int c0,
                                           int c_end, int vec) {
#pragma unroll
  for (int l = 0; l < GL; ++l) {
    const int f = threadIdx.x + l * THREADS;
    const int r = r0 + f / (GT / 4), c = c0 + (f % (GT / 4)) * 4;
    const int cnt = r < r_end ? min(4, c_end - c) : 0;
    v[l] = load4(src + (cnt > 0 ? (size_t)r * ld + c : 0), cnt, vec);
  }
}

// g masked by y > 0, in place: the values are loaded a stage ahead and
// masked only as they are stored, so the loads are waited for then.
__device__ __forceinline__ void mask4(float4& g, const float4& y) {
  g.x = y.x > 0.f ? g.x : 0.f;
  g.y = y.y > 0.f ? g.y : 0.f;
  g.z = y.z > 0.f ? g.z : 0.f;
  g.w = y.w > 0.f ? g.w : 0.f;
}

// Stores fetched groups into a staged operand, at their own places.
__device__ __forceinline__ void stash_rows(float* dst, const float4 (&v)[GL]) {
#pragma unroll
  for (int l = 0; l < GL; ++l) {
    const int f = threadIdx.x + l * THREADS;
    *reinterpret_cast<float4*>(dst + (f / (GT / 4)) * GP + (f % (GT / 4)) * 4) =
        v[l];
  }
}

// acc += the stage's A^T B, summed in a partial of its own first: A and B
// staged k-major, a thread's rows from ty and columns from tx (frag8).
// With NB = 1 only the columns 4 tx .. of each thread, the tile's first
// half, are computed: a tile whose second half lies past the inputs' end
// (3136 = 24.5 tiles) takes half the time of a whole one.
template <int NB>
__device__ __forceinline__ void fma_stage(float (&acc)[8][8], const float* a_st,
                                          const float* b_st, int tx, int ty) {
  float part[8][4 * NB];
#pragma unroll
  for (int kk = 0; kk < GK; ++kk) {
    float a[8], b[8];
    frag8(a, a_st + kk * GP, ty);
    if constexpr (NB == 2) {
      frag8(b, b_st + kk * GP, tx);
    } else {
      const float4 v = *reinterpret_cast<const float4*>(b_st + kk * GP +
                                                        4 * tx);
      b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NB; ++j)
        part[i][j] = kk ? fmaf(a[i], b[j], part[i][j]) : a[i] * b[j];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NB; ++j) acc[i][j] += part[i][j];
}

// Four consecutive values of a row at column k (those below n) into p:
// one 16-byte store when vec and all four are in.
__device__ __forceinline__ void put4(float* p, int k, int n, const float* v,
                                     int vec) {
  if (vec && k + 4 <= n) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k + j < n) p[j] = v[j];
  }
}

// The 128 x 128 tile (outputs n0.., inputs k0..) of dmu_w and dsigma_w
// over the batch rows of chunk s; the tiles with k0 == 0 also sum the bias
// grads of their outputs. Staged per stage: g (masked by y > 0 in
// registers, one stage ahead) and x (by cp.async, two stages ahead).
template <int EPS, int NB>
__device__ void large_weight_tile(float* sm, const BwdLargeArgs& a, int n0,
                                  int k0, int s) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b_begin = s * a.w_chunk, b_end = min(a.B, b_begin + a.w_chunk);
  const int steps = (b_end - b_begin + GK - 1) / GK;
  const bool bias = k0 == 0;
  auto issue = [&](int t) {  // stage t's x, if any; a group either way
    if (t < steps)
      stage_rows(sm + (t % GST) * GOPS * GS + GS, a.x, a.IN,
                 b_begin + t * GK, b_end, k0, a.IN, a.vec_in);
    cp_async_commit();
  };
  float4 rg[GL], ry[GL];
  auto fetch = [&](int t) {
    fetch_rows(rg, a.g, a.OUT, b_begin + t * GK, b_end, n0, a.OUT,
               a.vec_out);
    if (a.relu)
      fetch_rows(ry, a.y, a.OUT, b_begin + t * GK, b_end, n0, a.OUT,
                 a.vec_out);
  };
  auto stash = [&](int t) {  // the fetched g, masked, into slot t % GST
    if (a.relu) {
#pragma unroll
      for (int l = 0; l < GL; ++l) mask4(rg[l], ry[l]);
    }
    stash_rows(sm + (t % GST) * GOPS * GS, rg);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;

  for (int t = 0; t < GST - 1; ++t) issue(t);
  fetch(0);
  stash(0);
  for (int t = 0; t < steps; ++t) {
    float* st = sm + (t % GST) * GOPS * GS;
    cp_async_wait<GST - 2>();
    __syncthreads();  // stage t is in; stage t - 1 is done with
    issue(t + GST - 1);
    const bool more = t + 1 < steps;
    if (more) fetch(t + 1);
    fma_stage<NB>(acc, st, st + GS, tx, ty);
    if (bias && tid < GT) {
#pragma unroll
      for (int kk = 0; kk < GK; ++kk) bsum += st[kk * GP + tid];
    }
    if (more) stash(t + 1);
  }

  const bool split = a.w_splits > 1;
  float4 ei[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = k0 + 64 * h + 4 * tx;
    ei[h] = EPS && !split ? load4(a.eps_in + k, min(4, a.IN - k), a.vec_in)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = n0 + frag8_row(i, ty);
    if (n >= a.OUT) continue;
    const float eo = EPS && !split ? a.eps_out[n] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 64 * h + 4 * tx;
      if (k >= a.IN) continue;
      const float* v = &acc[i][4 * h];
      if (split) {
        put4(a.part + ((size_t)s * a.OUT + n) * a.IN + k, k, a.IN, v,
             a.vec_in);
        continue;
      }
      const size_t o = (size_t)n * a.IN + k;
      put4(a.dw_mu + o, k, a.IN, v, a.vec_in);
      if constexpr (EPS != 0) {
        const float sg[4] = {v[0] * (eo * ei[h].x), v[1] * (eo * ei[h].y),
                             v[2] * (eo * ei[h].z), v[3] * (eo * ei[h].w)};
        put4(a.dw_sig + o, k, a.IN, sg, a.vec_in);
      }
    }
  }
  if (bias && tid < GT && n0 + tid < a.OUT) {
    const int n = n0 + tid;
    if (split) {
      a.part[(size_t)a.w_splits * a.OUT * a.IN + (size_t)s * a.OUT + n] =
          bsum;
    } else {
      a.db_mu[n] = bsum;
      if constexpr (EPS != 0) a.db_sig[n] = a.eps_out[n] * bsum;
    }
  }
}

// The 128 x 128 tile (rows m0.., inputs k0..) of dx over the outputs of
// chunk s. Staged per stage, both through registers one stage ahead: g,
// masked by y > 0 and stored transposed, and W_eff, formed from the mu_w
// and sigma_w rows as they are stored.
template <int EPS, int NB>
__device__ void large_input_tile(float* sm, const BwdLargeArgs& a, int m0,
                                 int k0, int s) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int o_begin = s * a.chunk, o_end = min(a.OUT, o_begin + a.chunk);
  const int steps = (o_end - o_begin + GK - 1) / GK;
  // eps_in at this thread's columns of fetch_rows (the same for every
  // group of a thread: THREADS is a multiple of GT / 4).
  const int kc = k0 + (tid % (GT / 4)) * 4;
  const float4 ei = EPS ? load4(a.eps_in + kc, min(4, a.IN - kc), a.vec_in)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  // This thread's g: rows gr and gr + 64 of the tile, outputs gc .. gc + 3
  // of a stage, loaded as rows and stored transposed.
  constexpr int GQ = GK / 4;
  const int gr = tid / GQ, gc = (tid % GQ) * 4;
  static_assert(THREADS / GQ * 2 == GT, "two g loads a thread");
  float4 rg[2], ry[2], rw[GL], rs[GL];
  float eo[GL];
  auto fetch = [&](int t) {  // stage t's g, mu_w and sigma_w, eps_out
    const int r0 = o_begin + t * GK;
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int m = m0 + gr + 64 * l;
      const int cnt = m < a.B ? min(4, o_end - r0 - gc) : 0;
      const size_t o = (size_t)(m < a.B ? m : 0) * a.OUT + r0 + gc;
      rg[l] = load4(a.g + o, cnt, a.vec_out);
      if (a.relu) ry[l] = load4(a.y + o, cnt, a.vec_out);
    }
    fetch_rows(rw, a.w_mu, a.IN, r0, o_end, k0, a.IN, a.vec_in);
    if constexpr (EPS != 0) {
      fetch_rows(rs, a.w_sig, a.IN, r0, o_end, k0, a.IN, a.vec_in);
#pragma unroll
      for (int l = 0; l < GL; ++l) {
        const int n = r0 + (tid + l * THREADS) / (GT / 4);
        eo[l] = n < o_end ? __ldg(a.eps_out + n) : 0.f;
      }
    }
  };
  auto stash = [&](int t) {  // the fetched stage into slot t % GST
    float* st = sm + (t % GST) * GOPS * GS;
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (a.relu) mask4(rg[l], ry[l]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        st[(gc + j) * GP + gr + 64 * l] = get(rg[l], j);
    }
    if constexpr (EPS != 0) {
#pragma unroll
      for (int l = 0; l < GL; ++l) {
        rw[l].x = fmaf(rs[l].x, eo[l] * ei.x, rw[l].x);
        rw[l].y = fmaf(rs[l].y, eo[l] * ei.y, rw[l].y);
        rw[l].z = fmaf(rs[l].z, eo[l] * ei.z, rw[l].z);
        rw[l].w = fmaf(rs[l].w, eo[l] * ei.w, rw[l].w);
      }
    }
    stash_rows(st + GS, rw);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  for (int t = 0; t < steps; ++t) {
    __syncthreads();  // stage t is in; stage t - 1 is done with
    const bool more = t + 1 < steps;
    if (more) fetch(t + 1);
    fma_stage<NB>(acc, sm + (t % GST) * GOPS * GS,
                  sm + (t % GST) * GOPS * GS + GS, tx, ty);
    if (more) stash(t + 1);
  }

  float* out = a.splits > 1
                   ? a.part + w_part_floats(a) + (size_t)s * a.B * a.IN
                   : a.dx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + frag8_row(i, ty);
    if (m >= a.B) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 64 * h + 4 * tx;
      if (k < a.IN)
        put4(out + (size_t)m * a.IN + k, k, a.IN, &acc[i][4 * h], a.vec_in);
    }
  }
}

// The weight tiles' blocks and the dx tiles' (each kind chunk-major), the
// kind whose chunks are the longer first: the weight tiles from block 0
// when w_first, else from block n_xblocks. A tile whose inputs end before
// its second half computes its first half alone.
template <int EPS>
__global__ void __launch_bounds__(THREADS, 1)
    noisy_linear_bwd_large(const BwdLargeArgs a, int n_wblocks,
                           int n_xblocks, int w_first) {
  extern __shared__ __align__(16) float lsm[];
  const int k_tiles = (a.IN + GT - 1) / GT;
  int blk = blockIdx.x;
  if (w_first ? blk < n_wblocks : blk >= n_xblocks) {
    if (!w_first) blk -= n_xblocks;
    const int w_tiles = ((a.OUT + GT - 1) / GT) * k_tiles;
    const int s = blk / w_tiles;
    blk %= w_tiles;
    const int n0 = (blk / k_tiles) * GT, k0 = (blk % k_tiles) * GT;
    if (k0 + GT / 2 >= a.IN)
      large_weight_tile<EPS, 1>(lsm, a, n0, k0, s);
    else
      large_weight_tile<EPS, 2>(lsm, a, n0, k0, s);
  } else {
    if (w_first) blk -= n_wblocks;
    const int x_tiles = ((a.B + GT - 1) / GT) * k_tiles;
    const int s = blk / x_tiles;
    blk %= x_tiles;
    const int m0 = (blk / k_tiles) * GT, k0 = (blk % k_tiles) * GT;
    if (k0 + GT / 2 >= a.IN)
      large_input_tile<EPS, 1>(lsm, a, m0, k0, s);
    else
      large_input_tile<EPS, 2>(lsm, a, m0, k0, s);
  }
}

// Adds the partial sums of a split call in chunk order, s = 0 .. S-1, and
// applies the epilogue: the weight grads and the bias grads when the batch
// was split, then dx when the outputs were.
template <int EPS>
__global__ void __launch_bounds__(THREADS)
    noisy_linear_bwd_large_reduce(const BwdLargeArgs a) {
  size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const bool w_split = a.w_splits > 1;
  const size_t nw = w_split ? (size_t)a.OUT * a.IN : 0;
  const size_t nb = w_split ? (size_t)a.OUT : 0;
  const size_t nx = a.splits > 1 ? (size_t)a.B * a.IN : 0;
  if (i < nw) {
    float v = 0.f;
    for (int s = 0; s < a.w_splits; ++s) v += a.part[s * nw + i];
    a.dw_mu[i] = v;
    if constexpr (EPS != 0)
      a.dw_sig[i] = v * (a.eps_out[i / a.IN] * a.eps_in[i % a.IN]);
    return;
  }
  i -= nw;
  if (i < nb) {
    const float* pb = a.part + a.w_splits * nw;
    float v = 0.f;
    for (int s = 0; s < a.w_splits; ++s) v += pb[s * nb + i];
    a.db_mu[i] = v;
    if constexpr (EPS != 0) a.db_sig[i] = a.eps_out[i] * v;
    return;
  }
  i -= nb;
  if (i < nx) {
    const float* px = a.part + w_part_floats(a);
    float v = 0.f;
    for (int s = 0; s < a.splits; ++s) v += px[s * nx + i];
    a.dx[i] = v;
  }
}

template <int EPS>
cudaError_t launch_bwd_large(const BwdLargeArgs& a) {
  // Above 48 KB a block's shared memory must be asked for: once.
  static const cudaError_t set = cudaFuncSetAttribute(
      noisy_linear_bwd_large<EPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, LARGE_SMEM);
  if (set != cudaSuccess) return set;
  const int k_tiles = (a.IN + GT - 1) / GT;
  const int n_wblocks = ((a.OUT + GT - 1) / GT) * k_tiles * a.w_splits;
  const int n_xblocks = ((a.B + GT - 1) / GT) * k_tiles * a.splits;
  const int w_first = a.w_chunk >= a.chunk;
  noisy_linear_bwd_large<EPS>
      <<<n_wblocks + n_xblocks, THREADS, LARGE_SMEM, a.stream>>>(
          a, n_wblocks, n_xblocks, w_first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || (a.splits == 1 && a.w_splits == 1)) return err;
  size_t total = a.splits > 1 ? (size_t)a.B * a.IN : 0;
  if (a.w_splits > 1) total += (size_t)a.OUT * a.IN + a.OUT;
  noisy_linear_bwd_large_reduce<EPS>
      <<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0,
         a.stream>>>(a);
  return cudaGetLastError();
}

// ============================================== bf16 on the tensor cores ====
//
// Every bf16 call runs here, at every shape: the products on the tensor
// cores (mma.sync.m16n8k16, bf16 operands, fp32 accumulators), fragments
// loaded with ldmatrix from bf16 tiles in shared memory. The operands and
// the rounding are those of the CUDA-core design above, so only the order
// of the sums differs: the float32 master weights are rounded to bf16 on
// their way into shared memory; x is bf16 already; x * eps_in is formed as
// rnd(x * rnd(eps_in)) as it is staged (g * eps_out likewise in the
// backward); the epilogues do finish_y's and finish_dx's arithmetic.
//
// Why mma.sync and not wgmma: every operand passes through registers to be
// rounded or eps-scaled (the weights are float32, eps is per row at the
// actor's and the round's batches), so TMA, which copies bytes verbatim,
// cannot feed wgmma here; and the learner's small-batch launches are bound
// by bytes, where wgmma buys nothing.
//
// One pipeline serves every kernel (pipeline() below): a ring of NRAW raw
// stages in shared memory, filled by cp.async (16-byte copies; 4-byte copies
// or plain loads where a row is not 16-byte aligned; zeros past every edge),
// NRAW - 2 stages ahead of the stage being converted; the conversion of
// stage t + 1 into one of two bf16 tiles (rounding, eps scaling, the ReLU
// mask) follows the issue of stage t's MMAs, one barrier a stage. Tile rows
// are padded (48 or 144 bytes), so the eight 16-byte rows an ldmatrix
// reads fall on distinct banks.
//
// Forward (yT = W xT): the output features fill the MMA's 16-row M and the
// batch rows its 8-wide N, so tiles stay full at B = 8, 10, 16 and 32. Half
// the warps accumulate the mu product (A = mu_w, B = x), half the sigma
// product (A = sigma_w, B = rnd(x * eps_in)); both sums go through shared
// memory to an epilogue that reads eps_out and writes y (or the partials)
// a row of outputs at a time. Small batch (the plan's tile 16 or 32): a block owns 64 outputs
// x 16 or 32 rows x one chunk of the inputs (split-K, so that the weight
// stream comes from every SM; the partials are added in order by
// noisy_linear_fwd_reduce). Large batch (tile 128: the actor's 1024 rows,
// the round's 8192): 128 x 128 block tiles, a 64 x 64 warp tile in each
// accumulator, a six-stage ring (216 KB of shared memory with per-row eps).
// At B = 8192, 52.6 GFLOP against 190 MB: bound by bytes at the bf16 peak
// (57 us); the operations alone would take 0.79 ms on the CUDA cores.
// Measured, a stage's MMAs, copies and conversion run one after another
// there (tests/ka_stage_probe.py), and the copies stream 28 KB a stage from
// L2: the large path is about 8x its bound.
//
// Backward: one launch with two kinds of block, as above. A dx block owns 64
// inputs x 32 rows and one chunk of the outputs: dxT = mu_wT gT (+ sigma_wT
// (g * eps_out)T), A = the weight tile through ldmatrix.trans, the inputs on
// M, the batch on N, 16 outputs a stage; the ordered noisy_linear_dx_reduce
// adds the chunks. A weight block owns a 64 x 64 tile: dmu_w = gT x and
// dsigma_w = (g * eps_out)T (x * eps_in), K = the batch 16 rows a stage
// (zero-padded), both operands through ldmatrix.trans; each product's
// output is rounded to bf16 and stored as float32, and the blocks of the
// first input tile sum the bias grads.

using bf16 = __nv_bfloat16;

constexpr int MK = 16;      // the MMA's k: reduction elements a stage
constexpr int TP = MK + 8;  // a bf16 tile row of MK, padded to 48 bytes
constexpr int DP = 64 + 8;  // a bf16 tile row of 64, padded to 144 bytes

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// The two bf16 values of a word, as floats (exact).
__device__ __forceinline__ float lo_bf16(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// ldmatrix: four (or two) 8 x 8 bf16 matrices, lanes 8i .. 8i + 7 giving
// the row addresses of matrix i; .trans delivers each transposed.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16; d 16 x 8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four floats (the first n; none if n <= 0) from base + off into shared
// dst, zeros after them: one 16-byte copy when vec, else 4-byte copies.
__device__ __forceinline__ void copy4f(float* dst, const float* base,
                                       size_t off, int n, bool vec) {
  n = max(0, min(4, n));
  const float* src = base + (n > 0 ? off : 0);
  if (vec) {
    cp_async16(dst, src, 4 * n);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    cp_async4(dst + j, src + (j < n ? j : 0), j < n ? 4 : 0);
}
// Eight bf16 values likewise: one 16-byte copy when vec, else plain loads
// and stores (the barrier that ends the stage makes them visible).
__device__ __forceinline__ void copy8h(bf16* dst, const bf16* base,
                                       size_t off, int n, bool vec) {
  n = max(0, min(8, n));
  if (vec) {
    cp_async16(dst, base + (n > 0 ? off : 0), 2 * n);
    return;
  }
  const unsigned short* src =
      reinterpret_cast<const unsigned short*>(base) + (n > 0 ? off : 0);
  unsigned short* d = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
  for (int j = 0; j < 8; ++j) d[j] = j < n ? src[j] : 0;
}

// f(j) for j = threadIdx.x, + THREADS, .. below N.
template <int N, typename F>
__device__ __forceinline__ void for_threads(F f) {
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int j = threadIdx.x + i * THREADS;
    if (N % THREADS == 0 || j < N) f(j);
  }
}

// Runs `steps` stages through a ring of NRAW raw stages (stage s in slot
// s % NRAW) and two bf16 tiles (stage s in tile s & 1): load(s) starts stage
// s's copies; convert(s) turns landed stage s into its tile; compute(s)
// works on converted stage s. After stage t's MMAs are issued, stage
// t + NRAW - 1's copies start and stage t + 1 is converted while the tensor
// cores work: one barrier a stage. Ends with every copy landed and a
// barrier, so the caller may reuse the shared memory.
template <int NRAW, typename Load, typename Convert, typename Compute>
__device__ __forceinline__ void pipeline(int steps, Load load, Convert convert,
                                         Compute compute) {
  static_assert(NRAW >= 3, "a stage in flight beyond the next");
#pragma unroll
  for (int s = 0; s < NRAW - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  cp_async_wait<NRAW - 2>();
  __syncthreads();
  convert(0);
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<NRAW - 3>();
    __syncthreads();  // stage t + 1 is in; tile t & 1 is converted; raw
                      // slot t - 1 and tile (t + 1) & 1 are free
    compute(t);
    if (t + NRAW - 1 < steps) load(t + NRAW - 1);
    cp_async_commit();
    if (t + 1 < steps) convert(t + 1);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Four values of rnd(x * rnd(eps_in)), group f of a [rows][MK] stage: x
// from xr ([rows][TP] bf16), eps_in from er ([rows][MK], or [MK] shared),
// into xe ([rows][TP] bf16).
template <int EPS>
__device__ __forceinline__ void scale_x4(bf16* xe, const bf16* xr,
                                         const float* er, int f) {
  const int row = f / (MK / 4), q = (f % (MK / 4)) * 4;
  const uint2 u = *reinterpret_cast<const uint2*>(xr + row * TP + q);
  const float4 e =
      *reinterpret_cast<const float4*>(er + (EPS == 2 ? row * MK : 0) + q);
  *reinterpret_cast<uint2*>(xe + row * TP + q) = make_uint2(
      pack_bf16(lo_bf16(u.x) * rnd<bf16>(e.x), hi_bf16(u.x) * rnd<bf16>(e.y)),
      pack_bf16(lo_bf16(u.y) * rnd<bf16>(e.z), hi_bf16(u.y) * rnd<bf16>(e.w)));
}

// A warp's sums into ot ([PL][TB][TO + 4] floats): acc[i][j][c] is output
// wo + 16 i + lane / 4 (+ 8 for c >= 2), row wb + 8 j + 2 (lane % 4) (+ 1
// for odd c), of plane p. The padding puts a store's 32 lanes on distinct
// banks.
template <int TO, int TB, int MT, int NT>
__device__ __forceinline__ void store_sums(float* ot,
                                           const float (&acc)[MT][NT][4],
                                           int p, int wo, int wb, int lane) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ot[(p * TB + wb + j * 8 + 2 * (lane % 4) + c % 2) * (TO + 4) + wo +
           i * 16 + lane / 4 + (c / 2) * 8] = acc[i][j][c];
}

// The epilogue of a forward block from its two sums in shared memory (ot,
// [PL][TB][TO + 4] floats), by its first NTH threads: a thread owns an
// output column and walks the rows, EG rows' eps_out loads in flight, so
// eps_out is read and y (or the partials of chunk blockIdx.z, with part)
// written a row of outputs at a time. finish_y's arithmetic.
template <int EPS, int TO, int TB, int NTH>
__device__ __forceinline__ void fwd_epilogue(
    const float* ot, int tid, int n0, int m0, const float* __restrict__ b_mu,
    const float* __restrict__ b_sig, const float* __restrict__ eps_out,
    bf16* __restrict__ y, float* __restrict__ part, int B, int OUT,
    int relu) {
  constexpr int OP = TO + 4;
  constexpr int RS = NTH / TO, ROWS = TB / RS, EG = ROWS < 8 ? ROWS : 8;
  static_assert(NTH % TO == 0 && TB % RS == 0 && ROWS % EG == 0,
                "whole row groups");
  const int nc = tid % TO, n = n0 + nc;
  if (n >= OUT) return;
  const float bm = rnd<bf16>(b_mu[n]), bs = EPS ? rnd<bf16>(b_sig[n]) : 0.f;
  const float e1 = EPS == 1 ? rnd<bf16>(eps_out[n]) : 0.f;
  for (int r0 = tid / TO; r0 < TB; r0 += RS * EG) {
    float eo[EG];
#pragma unroll
    for (int k = 0; k < EG; ++k) {
      const int m = m0 + r0 + k * RS;
      eo[k] = EPS == 2 && !part && m < B ? eps_out[(size_t)m * OUT + n] : e1;
    }
#pragma unroll
    for (int k = 0; k < EG; ++k) {
      const int r = r0 + k * RS, m = m0 + r;
      if (m >= B) break;
      const float mu = ot[r * OP + nc];
      const float sig = EPS ? ot[(TB + r) * OP + nc] : 0.f;
      if (part) {
        const size_t o = ((size_t)blockIdx.z * B + m) * OUT + n;
        part[o] = mu;
        if (EPS) part[(size_t)gridDim.z * B * OUT + o] = sig;
      } else {
        float v = mu + bm;
        if (EPS) {
          const float e = EPS == 2 ? rnd<bf16>(eo[k]) : e1;
          v += sig * e + bs * e;
        }
        if (relu) v = fmaxf(v, 0.f);
        y[(size_t)m * OUT + n] = __float2bfloat16(v);
      }
    }
  }
}

// A warp's MT x NT fragments of one k16 stage: A = weights [outputs][TP]
// (outputs on M), B = x or its eps-scaled copy [rows][TP] (rows on N), both
// k-contiguous, so ldmatrix without .trans; B two n8 tiles at a time.
template <int MT, int NT>
__device__ __forceinline__ void mma_stage(float (&acc)[MT][NT][4],
                                          const bf16* at, const bf16* bt,
                                          int lane) {
  uint32_t af[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    ldsm4(af[i], at + (i * 16 + lane % 16) * TP + (lane / 16) * 8);
  if constexpr (NT == 1) {
    uint32_t b2[2];
    ldsm2(b2, bt + (lane % 8) * TP + ((lane / 8) % 2) * 8);
#pragma unroll
    for (int i = 0; i < MT; ++i) mma_bf16(acc[i][0], af[i], b2[0], b2[1]);
  } else {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b4[4];
      ldsm4(b4, bt + (j * 8 + (lane / 16) * 8 + lane % 8) * TP +
                    ((lane / 8) % 2) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(acc[i][j], af[i], b4[0], b4[1]);
        mma_bf16(acc[i][j + 1], af[i], b4[2], b4[3]);
      }
    }
  }
}

// The forward's shared memory (bytes) for TO outputs x TB rows a block.
template <int EPS, int TO, int TB>
struct FwdMma {
  static constexpr int PL = EPS ? 2 : 1;               // mu, and sigma
  static constexpr int NRAW = TO == 128 ? 6 : 4;
  static constexpr int W = TO * MK * 4;                // a weight plane, fp32
  static constexpr int E = EPS == 2 ? TB * MK * 4 : EPS == 1 ? MK * 4 : 0;
  static constexpr int X = TB * TP * 2;                // x, bf16, padded
  static constexpr int RAW = PL * W + E + X;
  // bf16 weights [PL][TO][TP], then rnd(x * eps_in) [TB][TP]
  static constexpr int TILE = (PL * TO + (EPS ? TB : 0)) * TP * 2;
  static constexpr int SUMS = PL * TB * (TO + 4) * 4;  // the epilogue's
  static constexpr int SMEM = NRAW * RAW + 2 * TILE > SUMS
                                  ? NRAW * RAW + 2 * TILE : SUMS;
};

// A block owns TO outputs x TB batch rows x one chunk of the inputs; its 8
// warps split as PL planes x WMO (along the outputs) x the rest (along the
// batch). Small path: 64 outputs x 16 or 32 rows, a 4-stage ring; large
// path: 128 x 128, a 6-stage ring (216 KB with per-row eps), a 64 x 64
// warp tile in each accumulator.
template <int EPS, int TO, int TB, int WMO>
__global__ void __launch_bounds__(THREADS) noisy_linear_fwd_mma(
    const bf16* __restrict__ x, const float* __restrict__ w_mu,
    const float* __restrict__ w_sig, const float* __restrict__ b_mu,
    const float* __restrict__ b_sig, const float* __restrict__ eps_in,
    const float* __restrict__ eps_out, bf16* __restrict__ y,
    float* __restrict__ part, int B, int IN, int OUT, int relu, int chunk,
    int vec) {
  using L = FwdMma<EPS, TO, TB>;
  constexpr int PL = L::PL;
  constexpr int WPP = 8 / PL;              // warps a plane
  constexpr int WTO = TO / WMO;            // a warp's outputs
  constexpr int WTB = TB / (WPP / WMO);    // and batch rows
  constexpr int MT = WTO / 16, NT = WTB / 8;
  constexpr int NW = PL * TO * MK / 4;     // four-weight groups a stage
  static_assert(THREADS == 256 && WPP % WMO == 0 && WTO % 16 == 0 &&
                    WTB % 8 == 0 && (NT == 1 || NT % 2 == 0),
                "warp tiles of whole fragments");
  extern __shared__ __align__(16) unsigned char dsm[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int p = EPS ? warp / WPP : 0, wi = warp % WPP;
  const int wo = (wi % WMO) * WTO, wb = (wi / WMO) * WTB;
  const int n0 = blockIdx.x * TO, m0 = blockIdx.y * TB;
  const int k_begin = blockIdx.z * chunk;
  const int len = min(IN, k_begin + chunk) - k_begin;

  // A raw stage: weights [PL][TO][MK] fp32, eps_in ([TB][MK] or [MK]) fp32,
  // x [TB][TP] bf16.
  auto raw = [&](int s) { return dsm + (s % L::NRAW) * L::RAW; };
  auto raw_x = [&](int s) {
    return reinterpret_cast<bf16*>(raw(s) + PL * L::W + L::E);
  };
  auto tile = [&](int s) {
    return reinterpret_cast<bf16*>(dsm + L::NRAW * L::RAW + (s & 1) * L::TILE);
  };

  auto load = [&](int s) {
    unsigned char* r = raw(s);
    const int kl = len - s * MK;  // inputs left from this stage
    const size_t kg = (size_t)k_begin + s * MK;
    for_threads<NW>([&](int f) {
      const int row = f / (MK / 4), q = (f % (MK / 4)) * 4;  // row of PL*TO
      const int o = n0 + row % TO;
      copy4f(reinterpret_cast<float*>(r) + row * MK + q,
             row < TO ? w_mu : w_sig, (size_t)o * IN + kg + q,
             o < OUT ? kl - q : 0, vec);
    });
    float* er = reinterpret_cast<float*>(r + PL * L::W);
    if constexpr (EPS == 2)
      for_threads<TB * MK / 4>([&](int f) {
        const int row = f / (MK / 4), q = (f % (MK / 4)) * 4, m = m0 + row;
        copy4f(er + row * MK + q, eps_in, (size_t)m * IN + kg + q,
               m < B ? kl - q : 0, vec);
      });
    if constexpr (EPS == 1)
      if (tid < MK / 4) copy4f(er + tid * 4, eps_in, kg + tid * 4,
                               kl - tid * 4, vec);
    bf16* xr = raw_x(s);
    for_threads<TB * MK / 8>([&](int f) {
      const int row = f / (MK / 8), q = (f % (MK / 8)) * 8, m = m0 + row;
      copy8h(xr + row * TP + q, x, (size_t)m * IN + kg + q,
             m < B ? kl - q : 0, vec);
    });
  };

  auto convert = [&](int s) {
    const unsigned char* r = raw(s);
    bf16* t = tile(s);
    for_threads<NW>([&](int f) {
      const int row = f / (MK / 4), q = (f % (MK / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(r) + row * MK + q);
      *reinterpret_cast<uint2*>(t + row * TP + q) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    });
    if constexpr (EPS != 0)
      for_threads<TB * MK / 4>([&](int f) {
        scale_x4<EPS>(t + PL * TO * TP, raw_x(s),
                 reinterpret_cast<const float*>(r + PL * L::W), f);
      });
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  auto compute = [&](int s) {
    const bf16* t = tile(s);
    mma_stage(acc, t + (p * TO + wo) * TP,
              (p ? t + PL * TO * TP : raw_x(s)) + wb * TP, lane);
  };

  pipeline<L::NRAW>((len + MK - 1) / MK, load, convert, compute);

  float* ot = reinterpret_cast<float*>(dsm);
  store_sums<TO, TB>(ot, acc, p, wo, wb, lane);
  __syncthreads();
  fwd_epilogue<EPS, TO, TB, THREADS>(ot, tid, n0, m0, b_mu, b_sig, eps_out,
                                     y, part, B, OUT, relu);
}

template <int EPS, int TO, int TB, int WMO>
cudaError_t launch_fwd_mma(const FwdArgs& a) {
  using L = FwdMma<EPS, TO, TB>;
  auto kernel = noisy_linear_fwd_mma<EPS, TO, TB, WMO>;
  static const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (set != cudaSuccess) return set;
  float* part = a.splits > 1 ? a.part : nullptr;
  const dim3 grid((a.OUT + TO - 1) / TO, (a.B + TB - 1) / TB, a.splits);
  kernel<<<grid, THREADS, L::SMEM, a.stream>>>(
      static_cast<const bf16*>(a.x), a.w_mu, a.w_sig, a.b_mu, a.b_sig,
      a.eps_in, a.eps_out, static_cast<bf16*>(a.y), part, a.B, a.IN, a.OUT,
      a.relu, a.chunk, a.vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !part) return err;
  return launch_fwd_reduce<bf16, EPS>(a);
}

// The bf16 forward for the plan's batch tile: 16 or 32 rows (small path:
// 64 outputs a block, a warp 16 outputs), 128 (large: 128 x 128).
template <int EPS>
cudaError_t launch_fwd_bf16(int tile, const FwdArgs& a) {
  switch (tile) {
    case 16: return launch_fwd_mma<EPS, 64, 16, 4>(a);
    case 32: return launch_fwd_mma<EPS, 64, 32, 4>(a);
    case 128: return launch_fwd_mma<EPS, 128, 128, 2>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The backward's shared memory (bytes): the larger of its two blocks'.
template <int EPS>
struct BwdMma {
  static constexpr int PL = EPS ? 2 : 1;
  // dx blocks: WT inputs x XM rows, MK outputs a stage. Raw: weights
  // [PL][MK][WT] fp32, g and y [XM][MK] bf16, eps_out ([XM][MK] or [MK]).
  static constexpr int DX_NRAW = 4;
  static constexpr int DX_W = MK * WT * 4;
  static constexpr int DX_G = XM * MK * 2;
  static constexpr int DX_E = EPS == 2 ? XM * MK * 4 : EPS == 1 ? MK * 4 : 0;
  static constexpr int DX_RAW = PL * DX_W + 2 * DX_G + DX_E;
  // bf16 weights [PL][MK][DP], then g masked and g * eps_out [PL][XM][TP]
  static constexpr int DX_TILE = PL * (MK * DP + XM * TP) * 2;
  static constexpr int DX_SMEM = DX_NRAW * DX_RAW + 2 * DX_TILE;
  // weight blocks: WT outputs x WT inputs, MK rows a stage. Raw: g, y, x
  // [MK][WT] bf16, eps_out and eps_in ([MK][WT] or [WT]) fp32.
  static constexpr int WG_NRAW = 3;
  static constexpr int WG_G = MK * WT * 2;
  static constexpr int WG_E = EPS == 2 ? MK * WT * 4 : EPS == 1 ? WT * 4 : 0;
  static constexpr int WG_RAW = 3 * WG_G + 2 * WG_E;
  // bf16 [PL][MK][DP] of g masked (and g * eps_out), then of x (x * eps_in)
  static constexpr int WG_TILE = 2 * PL * MK * DP * 2;
  static constexpr int WG_SMEM = WG_NRAW * WG_RAW + 2 * WG_TILE;
  static constexpr int SMEM = DX_SMEM > WG_SMEM ? DX_SMEM : WG_SMEM;
};

// g masked by y > 0 (when y is given), four bf16 values of raw rows.
__device__ __forceinline__ void masked_g4(float (&v)[4], const bf16* g,
                                          const bf16* y) {
  const uint2 u = *reinterpret_cast<const uint2*>(g);
  v[0] = lo_bf16(u.x); v[1] = hi_bf16(u.x);
  v[2] = lo_bf16(u.y); v[3] = hi_bf16(u.y);
  if (y) {
    const uint2 m = *reinterpret_cast<const uint2*>(y);
    const float mv[4] = {lo_bf16(m.x), hi_bf16(m.x), lo_bf16(m.y),
                         hi_bf16(m.y)};
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = mv[j] > 0.f ? v[j] : 0.f;
  }
}
// rnd(v * rnd(e)) of four values, packed.
__device__ __forceinline__ uint2 scaled4(const float (&v)[4], float4 e) {
  return make_uint2(pack_bf16(v[0] * rnd<bf16>(e.x), v[1] * rnd<bf16>(e.y)),
                    pack_bf16(v[2] * rnd<bf16>(e.z), v[3] * rnd<bf16>(e.w)));
}
__device__ __forceinline__ uint2 pack4(const float (&v)[4]) {
  return make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// One WT-input x XM-row tile (inputs k0.., rows m0..) of dx over the
// outputs of chunk s, or its partial sums when the outputs are split.
// Warps: PL planes x 4 (16 inputs each) x the rest (along the rows).
template <int EPS>
__device__ void input_grad_mma(unsigned char* sm, const BwdArgs& a, int m0,
                               int k0, int s) {
  using L = BwdMma<EPS>;
  constexpr int PL = L::PL, WPP = 8 / PL;
  constexpr int WTB = XM / (WPP / 4), NT = WTB / 8;
  const bf16* g = static_cast<const bf16*>(a.g);
  const bf16* y = static_cast<const bf16*>(a.y);
  const int B = a.B, IN = a.IN, OUT = a.OUT;
  const int o_begin = s * a.chunk, o_end = min(OUT, o_begin + a.chunk);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int p = EPS ? warp / WPP : 0, wi = warp % WPP;
  const int wk = (wi % 4) * 16, wb = (wi / 4) * WTB;

  auto raw = [&](int s) { return sm + (s % L::DX_NRAW) * L::DX_RAW; };
  auto tile = [&](int s) {
    return reinterpret_cast<bf16*>(sm + L::DX_NRAW * L::DX_RAW +
                                   (s & 1) * L::DX_TILE);
  };
  auto load = [&](int t) {
    unsigned char* r = raw(t);
    const int o0 = o_begin + t * MK;
    for_threads<PL * MK * WT / 4>([&](int f) {
      const int row = f / (WT / 4), q = (f % (WT / 4)) * 4;  // of PL*MK
      const int o = o0 + row % MK, k = k0 + q;
      copy4f(reinterpret_cast<float*>(r) + row * WT + q,
             row < MK ? a.w_mu : a.w_sig, (size_t)o * IN + k,
             o < o_end ? IN - k : 0, a.vec_in);
    });
    bf16* gr = reinterpret_cast<bf16*>(r + PL * L::DX_W);
    for_threads<XM * MK / 8>([&](int f) {
      const int row = f / (MK / 8), q = (f % (MK / 8)) * 8, b = m0 + row;
      const size_t i = (size_t)b * OUT + o0 + q;
      const int n = b < B ? o_end - o0 - q : 0;
      copy8h(gr + row * MK + q, g, i, n, a.vec_out);
      if (y) copy8h(gr + XM * MK + row * MK + q, y, i, n, a.vec_out);
    });
    float* er = reinterpret_cast<float*>(r + PL * L::DX_W + 2 * L::DX_G);
    if constexpr (EPS == 2)
      for_threads<XM * MK / 4>([&](int f) {
        const int row = f / (MK / 4), q = (f % (MK / 4)) * 4, b = m0 + row;
        copy4f(er + row * MK + q, a.eps_out, (size_t)b * OUT + o0 + q,
               b < B ? o_end - o0 - q : 0, a.vec_out);
      });
    if constexpr (EPS == 1)
      if (tid < MK / 4) copy4f(er + tid * 4, a.eps_out, o0 + tid * 4,
                               o_end - o0 - tid * 4, a.vec_out);
  };
  auto convert = [&](int st) {
    const unsigned char* r = raw(st);
    bf16* t = tile(st);
    for_threads<PL * MK * WT / 4>([&](int f) {
      const int row = f / (WT / 4), q = (f % (WT / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(r) + row * WT + q);
      *reinterpret_cast<uint2*>(t + row * DP + q) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    });
    const bf16* gr = reinterpret_cast<const bf16*>(r + PL * L::DX_W);
    const float* er =
        reinterpret_cast<const float*>(r + PL * L::DX_W + 2 * L::DX_G);
    bf16* gt = t + PL * MK * DP;
    for_threads<XM * MK / 4>([&](int f) {
      const int row = f / (MK / 4), q = (f % (MK / 4)) * 4;
      float v[4];
      masked_g4(v, gr + row * MK + q, y ? gr + XM * MK + row * MK + q
                                        : nullptr);
      *reinterpret_cast<uint2*>(gt + row * TP + q) = pack4(v);
      if constexpr (EPS != 0)
        *reinterpret_cast<uint2*>(gt + (XM + row) * TP + q) = scaled4(
            v, *reinterpret_cast<const float4*>(
                   er + (EPS == 2 ? row * MK : 0) + q));
    });
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  // A = the weight tile [outputs][inputs] transposed (inputs on M), B = g
  // or g * eps_out [rows][outputs] (rows on N).
  auto compute = [&](int st) {
    const bf16* t = tile(st);
    const bf16* wt = t + p * MK * DP + wk;
    const bf16* gt = t + PL * MK * DP + (p * XM + wb) * TP;
    uint32_t af[4];
    ldsm4t(af, wt + ((lane / 16) * 8 + lane % 8) * DP + ((lane / 8) % 2) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t r4[4];
      ldsm4(r4, gt + (j * 8 + (lane / 16) * 8 + lane % 8) * TP +
                    ((lane / 8) % 2) * 8);
      mma_bf16(acc[j], af, r4[0], r4[1]);
      mma_bf16(acc[j + 1], af, r4[2], r4[3]);
    }
  };

  pipeline<L::DX_NRAW>((o_end - o_begin + MK - 1) / MK, load, convert,
                       compute);

  // acc[j][c] is input k0 + wk + lane / 4 (+ 8 for c >= 2), row
  // m0 + wb + 8 j + 2 (lane % 4) (+ 1 for odd c).
  float* xch = reinterpret_cast<float*>(sm);  // [WPP][NT][4][32]
  if (EPS != 0 && a.splits == 1) {
    if (p == 1)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          xch[((wi * NT + j) * 4 + c) * 32 + lane] = acc[j][c];
    __syncthreads();
    if (p == 1) return;
  }
  bf16* dx = static_cast<bf16*>(a.dx);
  const size_t plane = (size_t)a.splits * B * IN;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + wk + lane / 4 + (c / 2) * 8;
      const int b = m0 + wb + j * 8 + 2 * (lane % 4) + c % 2;
      if (k >= IN || b >= B) continue;
      if (a.splits > 1) {
        a.part[p * plane + ((size_t)s * B + b) * IN + k] = acc[j][c];
      } else {
        const float sig = EPS ? xch[((wi * NT + j) * 4 + c) * 32 + lane] : 0.f;
        finish_dx<bf16, EPS>(acc[j][c], sig, b, k, a.eps_in, dx, IN);
      }
    }
}

// One WT x WT tile (outputs n0.., inputs k0..) of dmu_w and dsigma_w; the
// blocks with k0 == 0 also write dmu_b and dsigma_b for their outputs.
// Warps: PL planes x 2 (32 outputs each) x the rest (along the inputs).
template <int EPS>
__device__ void weight_grad_mma(unsigned char* sm, const BwdArgs& a, int n0,
                                int k0) {
  using L = BwdMma<EPS>;
  constexpr int PL = L::PL, WPP = 8 / PL;
  constexpr int WTK = WT / (WPP / 2), NT = WTK / 8, MT = 2;
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* g = static_cast<const bf16*>(a.g);
  const bf16* y = static_cast<const bf16*>(a.y);
  const int B = a.B, IN = a.IN, OUT = a.OUT;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int p = EPS ? warp / WPP : 0, wi = warp % WPP;
  const int wo = (wi % 2) * 32, wk = (wi / 2) * WTK;
  const bool bias = k0 == 0;

  auto raw = [&](int s) { return sm + (s % L::WG_NRAW) * L::WG_RAW; };
  auto tile = [&](int s) {
    return reinterpret_cast<bf16*>(sm + L::WG_NRAW * L::WG_RAW +
                                   (s & 1) * L::WG_TILE);
  };
  // Raw: g [MK][WT], y, x (bf16), then eps_out, eps_in.
  auto load = [&](int t) {
    unsigned char* r = raw(t);
    bf16* hr = reinterpret_cast<bf16*>(r);
    const int b0 = t * MK;
    for_threads<MK * WT / 8>([&](int f) {
      const int row = f / (WT / 8), q = (f % (WT / 8)) * 8, b = b0 + row;
      const size_t gi = (size_t)b * OUT + n0 + q;
      const int ng = b < B ? OUT - n0 - q : 0;
      copy8h(hr + row * WT + q, g, gi, ng, a.vec_out);
      if (y) copy8h(hr + MK * WT + row * WT + q, y, gi, ng, a.vec_out);
      copy8h(hr + 2 * MK * WT + row * WT + q, x, (size_t)b * IN + k0 + q,
             b < B ? IN - k0 - q : 0, a.vec_in);
    });
    float* eo = reinterpret_cast<float*>(r + 3 * L::WG_G);
    float* ei = reinterpret_cast<float*>(r + 3 * L::WG_G + L::WG_E);
    if constexpr (EPS == 2)
      for_threads<MK * WT / 4>([&](int f) {
        const int row = f / (WT / 4), q = (f % (WT / 4)) * 4, b = b0 + row;
        copy4f(eo + row * WT + q, a.eps_out, (size_t)b * OUT + n0 + q,
               b < B ? OUT - n0 - q : 0, a.vec_out);
        copy4f(ei + row * WT + q, a.eps_in, (size_t)b * IN + k0 + q,
               b < B ? IN - k0 - q : 0, a.vec_in);
      });
    if constexpr (EPS == 1)
      if (tid < WT / 4) {
        copy4f(eo + tid * 4, a.eps_out, n0 + tid * 4, OUT - n0 - tid * 4,
               a.vec_out);
        copy4f(ei + tid * 4, a.eps_in, k0 + tid * 4, IN - k0 - tid * 4,
               a.vec_in);
      }
  };
  auto convert = [&](int st) {
    const unsigned char* r = raw(st);
    const bf16* hr = reinterpret_cast<const bf16*>(r);
    const float* eo = reinterpret_cast<const float*>(r + 3 * L::WG_G);
    const float* ei = reinterpret_cast<const float*>(r + 3 * L::WG_G +
                                                     L::WG_E);
    bf16* t = tile(st);  // [PL][MK][DP] of g, then of x
    for_threads<MK * WT / 4>([&](int f) {
      const int row = f / (WT / 4), q = (f % (WT / 4)) * 4;
      const int e = EPS == 2 ? row * WT + q : q;
      float v[4];
      masked_g4(v, hr + row * WT + q, y ? hr + (MK + row) * WT + q : nullptr);
      *reinterpret_cast<uint2*>(t + row * DP + q) = pack4(v);
      const uint2 u = *reinterpret_cast<const uint2*>(hr + (2 * MK + row) *
                                                      WT + q);
      *reinterpret_cast<uint2*>(t + (PL * MK + row) * DP + q) = u;
      if constexpr (EPS != 0) {
        *reinterpret_cast<uint2*>(t + (MK + row) * DP + q) =
            scaled4(v, *reinterpret_cast<const float4*>(eo + e));
        const float xv[4] = {lo_bf16(u.x), hi_bf16(u.x), lo_bf16(u.y),
                             hi_bf16(u.y)};
        *reinterpret_cast<uint2*>(t + (3 * MK + row) * DP + q) =
            scaled4(xv, *reinterpret_cast<const float4*>(ei + e));
      }
    });
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  float bsum_mu = 0.f, bsum_sig = 0.f;
  // A = g (or g * eps_out) [rows][outputs] transposed (outputs on M), B = x
  // (or x * eps_in) [rows][inputs] (inputs on N): both through .trans.
  auto compute = [&](int st) {
    const bf16* t = tile(st);
    const bf16* at = t + p * MK * DP + wo;
    const bf16* bt = t + (PL + p) * MK * DP + wk;
    uint32_t af[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      ldsm4t(af[i], at + ((lane / 16) * 8 + lane % 8) * DP + i * 16 +
                        ((lane / 8) % 2) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t r4[4];
      ldsm4t(r4, bt + (((lane / 8) % 2) * 8 + lane % 8) * DP +
                     (j + lane / 16) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(acc[i][j], af[i], r4[0], r4[1]);
        mma_bf16(acc[i][j + 1], af[i], r4[2], r4[3]);
      }
    }
    if (bias && tid < WT) {
#pragma unroll
      for (int bb = 0; bb < MK; ++bb) {
        bsum_mu += __bfloat162float(t[bb * DP + tid]);
        if constexpr (EPS != 0)
          bsum_sig += __bfloat162float(t[(MK + bb) * DP + tid]);
      }
    }
  };

  pipeline<L::WG_NRAW>((B + MK - 1) / MK, load, convert, compute);

  // acc[i][j][c] is output n0 + wo + 16 i + lane / 4 (+ 8 for c >= 2),
  // input k0 + wk + 8 j + 2 (lane % 4) (+ 1 for odd c).
  float* dw = p ? a.dw_sig : a.dw_mu;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = n0 + wo + i * 16 + lane / 4 + h * 8;
        const int k = k0 + wk + j * 8 + 2 * (lane % 4);
        if (o >= OUT || k >= IN) continue;
        const float v0 = rnd<bf16>(acc[i][j][2 * h]);
        const float v1 = rnd<bf16>(acc[i][j][2 * h + 1]);
        float* d = dw + (size_t)o * IN + k;
        if (a.vec_in && k + 1 < IN) {
          *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
        } else {
          d[0] = v0;
          if (k + 1 < IN) d[1] = v1;
        }
      }
  if (bias && tid < WT && n0 + tid < OUT) {
    a.db_mu[n0 + tid] = rnd<bf16>(bsum_mu);
    if constexpr (EPS != 0) a.db_sig[n0 + tid] = rnd<bf16>(bsum_sig);
  }
}

// Blocks [0, n_xblocks) are dx blocks (chunk-major), the rest weight blocks.
template <int EPS>
__global__ void __launch_bounds__(THREADS)
    noisy_linear_bwd_mma(const BwdArgs a, int n_xblocks) {
  extern __shared__ __align__(16) unsigned char dsm[];
  const int k_tiles = (a.IN + WT - 1) / WT;
  int blk = blockIdx.x;
  if (blk < n_xblocks) {
    const int x_tiles = ((a.B + XM - 1) / XM) * k_tiles;
    const int s = blk / x_tiles;
    blk %= x_tiles;
    input_grad_mma<EPS>(dsm, a, (blk / k_tiles) * XM, (blk % k_tiles) * WT, s);
  } else {
    blk -= n_xblocks;
    weight_grad_mma<EPS>(dsm, a, (blk / k_tiles) * WT, (blk % k_tiles) * WT);
  }
}

template <int EPS>
cudaError_t launch_bwd_bf16(const BwdArgs& a) {
  constexpr int bytes = BwdMma<EPS>::SMEM;
  static const cudaError_t set = cudaFuncSetAttribute(
      noisy_linear_bwd_mma<EPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (set != cudaSuccess) return set;
  const int k_tiles = (a.IN + WT - 1) / WT;
  const int n_xblocks = ((a.B + XM - 1) / XM) * k_tiles * a.splits;
  const int n_wblocks = ((a.OUT + WT - 1) / WT) * k_tiles;
  noisy_linear_bwd_mma<EPS>
      <<<n_xblocks + n_wblocks, THREADS, bytes, a.stream>>>(a, n_xblocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return launch_dx_reduce<bf16, EPS>(a);
}

cudaError_t launch_fwd_mma_eps(int eps_mode, int tile, const FwdArgs& a) {
  switch (eps_mode) {
    case 0: return launch_fwd_bf16<0>(tile, a);
    case 1: return launch_fwd_bf16<1>(tile, a);
    default: return launch_fwd_bf16<2>(tile, a);
  }
}

cudaError_t launch_bwd_mma_eps(int eps_mode, const BwdArgs& a) {
  switch (eps_mode) {
    case 0: return launch_bwd_bf16<0>(a);
    case 1: return launch_bwd_bf16<1>(a);
    default: return launch_bwd_bf16<2>(a);
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
  const bool w16 = aligned16(w_mu) && aligned16(w_sig) &&
                   (eps_mode == 0 || aligned16(eps_in));
  // 16-byte copies: four float32 x values, or eight bf16 (the tensor-core
  // path copies x whole rows of 16-byte groups).
  const bool vec = x_bf16 ? IN % 8 == 0 && chunk % 8 == 0 && aligned16(x) &&
                                w16
                          : IN % 4 == 0 && chunk % 4 == 0 && aligned16(x) &&
                                w16;
  FwdArgs a{x, w_mu, w_sig, b_mu, b_sig, eps_in, eps_out, y, scratch,
            B, IN, OUT, relu, chunk, splits, vec,
            static_cast<cudaStream_t>(stream)};
  const cudaError_t err = x_bf16 ? launch_fwd_mma_eps(eps_mode, tile, a)
                                 : launch_fwd_fp32(eps_mode, tile, a);
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
  auto fits = [](const void* p) { return p == nullptr || aligned16(p); };
  // float32: rows of four-value groups; bf16: rows of eight-value groups.
  const int group = x_bf16 ? 8 : 4;
  const bool vec_in = IN % group == 0 && fits(x) && aligned16(w_mu) &&
                      aligned16(w_sig) && aligned16(dw_mu) &&
                      aligned16(dw_sig) &&
                      (eps_mode == 0 || aligned16(eps_in));
  const bool vec_out = OUT % group == 0 && chunk % group == 0 && fits(g) &&
                       fits(y) && (eps_mode == 0 || aligned16(eps_out));
  BwdArgs a{x, g, relu ? y : nullptr, w_mu, w_sig, eps_in, eps_out, dx,
            dw_mu, dw_sig, db_mu, db_sig, scratch, B, IN, OUT, relu, chunk,
            splits, vec_in, vec_out, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = x_bf16 ? launch_bwd_mma_eps(eps_mode, a)
                                 : launch_bwd_fp32(eps_mode, a);
  return static_cast<int>(err);
}

// Backward of a float32 layer with no (eps_mode 0) or shared (1) noise on
// the large-batch path: x (B, IN), g, y (B, OUT; y read only when relu = 1)
// and dx float32, as noisy_linear_bwd. The plan
// (kernels/noisy_linear.py::bwd_plan, path "large") splits the dx tiles'
// reduction over the outputs into `splits` chunks of `chunk` and the weight
// tiles' reduction over the batch into `w_splits` chunks of `w_chunk`; with
// either above one the partial sums go to `scratch` (w_part_floats floats
// for the weights, then splits * B * IN for dx). With eps_mode 0 dsigma_w
// and dsigma_b are not written. Returns cudaGetLastError().
extern "C" int noisy_linear_bwd_large(
    const float* x, const float* g, const float* y, const float* w_mu,
    const float* w_sig, const float* eps_in, const float* eps_out,
    int eps_mode, float* dx, float* dw_mu, float* dw_sig, float* db_mu,
    float* db_sig, int B, int IN, int OUT, int relu, void* stream, int chunk,
    int splits, int w_chunk, int w_splits, float* scratch) {
  if (IN <= 0 || (eps_mode != 0 && eps_mode != 1) ||
      !valid_split(OUT, chunk, splits, scratch) ||
      !valid_split(B, w_chunk, w_splits, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_in = IN % 4 == 0 && aligned16(x) && aligned16(dx) &&
                      aligned16(w_mu) && aligned16(w_sig) &&
                      aligned16(dw_mu) && aligned16(dw_sig) &&
                      (eps_mode == 0 || aligned16(eps_in));
  const bool vec_out =
      OUT % 4 == 0 && aligned16(g) && (!relu || aligned16(y));
  BwdLargeArgs a{x, g, relu ? y : nullptr, w_mu, w_sig, eps_in, eps_out,
                 dx, dw_mu, dw_sig, db_mu, db_sig, scratch, B, IN, OUT,
                 relu, chunk, splits, w_chunk, w_splits, vec_in, vec_out,
                 static_cast<cudaStream_t>(stream)};
  const cudaError_t err = eps_mode ? launch_bwd_large<1>(a)
                                   : launch_bwd_large<0>(a);
  return static_cast<int>(err);
}
