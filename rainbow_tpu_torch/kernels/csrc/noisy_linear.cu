// Noisy-linear forward, hand-written for Hopper (sm_90a).
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
// (B, out)). The (out, in) perturbed weight mu + sigma * eps is never formed.
//
// Bound on the H100 at the actor's shapes (B = 1024, fc_h_* 3136 -> 512, eps
// per row): 2 GEMMs = 4 * 1024 * 3136 * 512 = 6.6 GFLOP in fp32 on the CUDA
// cores (67 TFLOP/s: 0.1 ms), against about 43 MB moved (x, both weights,
// eps_in, eps_out, y: 13 us at 3.35 TB/s). So it is bound by operations.
// The design reads each x tile and each weight tile from device memory once
// per block into shared memory and runs both products from there: one
// accumulator for mu, one for sigma, fed by the same x tile (and its
// eps_in-scaled copy, scaled as it is loaded). Each thread owns a 4 x 4 tile
// of outputs in both accumulators. The mu-only variant has no sigma
// accumulator. bf16 inputs are rounded as the JAX package casts them
// (weights, eps and biases to bf16) and accumulated in fp32.
// Simple and right first: no tensor cores, wgmma or TMA yet.
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
// Bound on the H100 at the learner's shapes (B = 32, fc_h_* 3136 -> 512,
// shared eps): it reads mu_w and sigma_w for dx and writes dmu_w and
// dsigma_w, 4 * 6.4 MB = 25.7 MB (7.7 us at 3.35 TB/s), against 8 * 32 *
// 3136 * 512 = 0.41 GFLOP (6 us at 67 TFLOP/s): bound by bytes. So the
// design moves each weight-sized array once: one launch with two kinds of
// block. A weight block owns a 64 x 64 tile of dmu_w and dsigma_w, the
// mirror image of the forward: it walks the batch 16 rows at a time,
// loads g and x once into shared memory with their eps-scaled copies, and
// feeds two accumulators from them; the blocks of the first input tile
// also sum the bias grads. An input block owns a 64 x 64 tile of dx and
// walks the outputs, reading mu_w and sigma_w tiles once each. The
// perturbed weight is never formed. bf16 x and g are rounded where the JAX
// package rounds (eps-scaled copies, each product's output); the weight
// grads are stored as float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // batch rows per block
constexpr int BN = 64;       // output features per block
constexpr int BK = 16;       // reduction depth per shared-memory tile
constexpr int TM = 4;        // rows per thread
constexpr int TN = 4;        // output features per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

// EPS: 0 = mu only, 1 = shared eps, 2 = per-row eps.
template <typename T, int EPS>
__global__ void __launch_bounds__(THREADS) noisy_linear_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w_mu,
    const float* __restrict__ w_sig, const float* __restrict__ b_mu,
    const float* __restrict__ b_sig, const float* __restrict__ eps_in,
    const float* __restrict__ eps_out, T* __restrict__ y, int B, int IN,
    int OUT, int relu) {
  __shared__ __align__(16) float xs[BK][BM];   // x tile, k-major
  __shared__ __align__(16) float xes[BK][BM];  // (x * eps_in) tile
  __shared__ __align__(16) float wms[BK][BN];  // mu_w tile
  __shared__ __align__(16) float wss[BK][BN];  // sigma_w tile

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  // Tile loads: each thread reads 4 consecutive k of one row of x and of
  // one row of each weight.
  const int lr = tid / 4;
  const int lk = (tid % 4) * 4;
  const int lm = m0 + lr;
  const int ln = n0 + lr;

  float acc_mu[TM][TN];
  float acc_sig[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc_mu[i][j] = acc_sig[i][j] = 0.f;

  for (int k0 = 0; k0 < IN; k0 += BK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + lk + j;
      const bool kin = k < IN;
      const float xv = (lm < B && kin) ? to_f(x[(size_t)lm * IN + k]) : 0.f;
      xs[lk + j][lr] = xv;
      wms[lk + j][lr] =
          (ln < OUT && kin) ? rnd<T>(w_mu[(size_t)ln * IN + k]) : 0.f;
      if (EPS) {
        float e = 0.f;
        if (kin) {
          if (EPS == 1) e = eps_in[k];
          else if (lm < B) e = eps_in[(size_t)lm * IN + k];
        }
        xes[lk + j][lr] = rnd<T>(xv * rnd<T>(e));
        wss[lk + j][lr] =
            (ln < OUT && kin) ? rnd<T>(w_sig[(size_t)ln * IN + k]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&wms[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc_mu[i][j] = fmaf(av[i], bv[j], acc_mu[i][j]);
      if (EPS) {
        const float4 ae = *reinterpret_cast<const float4*>(&xes[kk][ty * TM]);
        const float4 bs = *reinterpret_cast<const float4*>(&wss[kk][tx * TN]);
        const float aev[TM] = {ae.x, ae.y, ae.z, ae.w};
        const float bsv[TN] = {bs.x, bs.y, bs.z, bs.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc_sig[i][j] = fmaf(aev[i], bsv[j], acc_sig[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= OUT) continue;
      float v = acc_mu[i][j] + rnd<T>(b_mu[n]);
      if (EPS) {
        const float eo =
            rnd<T>(EPS == 1 ? eps_out[n] : eps_out[(size_t)m * OUT + n]);
        v += acc_sig[i][j] * eo + rnd<T>(b_sig[n]) * eo;
      }
      if (relu) v = fmaxf(v, 0.f);
      store(y + (size_t)m * OUT + n, v);
    }
  }
}

template <typename T>
void launch(const void* x, const float* w_mu, const float* w_sig,
            const float* b_mu, const float* b_sig, const float* eps_in,
            const float* eps_out, int eps_mode, void* y, int B, int IN,
            int OUT, int relu, cudaStream_t stream) {
  const dim3 grid((OUT + BN - 1) / BN, (B + BM - 1) / BM);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (eps_mode) {
    case 0:
      noisy_linear_fwd_kernel<T, 0><<<grid, THREADS, 0, stream>>>(
          xt, w_mu, w_sig, b_mu, b_sig, eps_in, eps_out, yt, B, IN, OUT, relu);
      break;
    case 1:
      noisy_linear_fwd_kernel<T, 1><<<grid, THREADS, 0, stream>>>(
          xt, w_mu, w_sig, b_mu, b_sig, eps_in, eps_out, yt, B, IN, OUT, relu);
      break;
    default:
      noisy_linear_fwd_kernel<T, 2><<<grid, THREADS, 0, stream>>>(
          xt, w_mu, w_sig, b_mu, b_sig, eps_in, eps_out, yt, B, IN, OUT, relu);
  }
}

// ----------------------------------------------------------- backward ----

constexpr int BB = 16;  // batch rows per step of a weight block

__device__ __forceinline__ float masked_g(const float* g, const float* y,
                                          size_t i, int relu) {
  return (relu && !(y[i] > 0.f)) ? 0.f : g[i];
}
__device__ __forceinline__ float masked_g(const __nv_bfloat16* g,
                                          const __nv_bfloat16* y, size_t i,
                                          int relu) {
  return (relu && !(__bfloat162float(y[i]) > 0.f)) ? 0.f
                                                    : __bfloat162float(g[i]);
}

// One 64 x 64 tile (outputs n0.., inputs k0..) of dmu_w and dsigma_w; the
// blocks with k0 == 0 also write dmu_b and dsigma_b for their outputs.
template <typename T, int EPS>
__device__ void weight_grad_tile(float (*sm)[BB][64], const T* __restrict__ x,
                                 const T* __restrict__ g,
                                 const T* __restrict__ y,
                                 const float* __restrict__ eps_in,
                                 const float* __restrict__ eps_out,
                                 float* __restrict__ dw_mu,
                                 float* __restrict__ dw_sig,
                                 float* __restrict__ db_mu,
                                 float* __restrict__ db_sig, int B, int IN,
                                 int OUT, int relu, int n0, int k0) {
  float (*gs)[64] = sm[0];   // g tile, batch-major
  float (*ges)[64] = sm[1];  // (g * eps_out) tile
  float (*xs)[64] = sm[2];   // x tile
  float (*xes)[64] = sm[3];  // (x * eps_in) tile
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // 4 inputs each
  const int ty = tid / 16;   // 4 outputs each
  const int lb = tid / 16;   // load row (batch)
  const int lc = (tid % 16) * 4;
  const bool bias = k0 == 0;

  float acc_mu[TM][TN];
  float acc_sig[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc_mu[i][j] = acc_sig[i][j] = 0.f;
  float bsum_mu = 0.f, bsum_sig = 0.f;

  for (int b0 = 0; b0 < B; b0 += BB) {
    const int b = b0 + lb;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + lc + j;
      const int k = k0 + lc + j;
      float gv = 0.f, xv = 0.f;
      if (b < B && n < OUT) gv = masked_g(g, y, (size_t)b * OUT + n, relu);
      if (b < B && k < IN) xv = to_f(x[(size_t)b * IN + k]);
      gs[lb][lc + j] = gv;
      xs[lb][lc + j] = xv;
      if (EPS) {
        float eo = 0.f, ei = 0.f;
        if (b < B && n < OUT)
          eo = EPS == 1 ? eps_out[n] : eps_out[(size_t)b * OUT + n];
        if (b < B && k < IN)
          ei = EPS == 1 ? eps_in[k] : eps_in[(size_t)b * IN + k];
        ges[lb][lc + j] = rnd<T>(gv * rnd<T>(eo));
        xes[lb][lc + j] = rnd<T>(xv * rnd<T>(ei));
      }
    }
    __syncthreads();
#pragma unroll
    for (int bb = 0; bb < BB; ++bb) {
      const float4 a = *reinterpret_cast<const float4*>(&gs[bb][ty * TM]);
      const float4 c = *reinterpret_cast<const float4*>(&xs[bb][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float cv[TN] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc_mu[i][j] = fmaf(av[i], cv[j], acc_mu[i][j]);
      if (EPS) {
        const float4 ae = *reinterpret_cast<const float4*>(&ges[bb][ty * TM]);
        const float4 ce = *reinterpret_cast<const float4*>(&xes[bb][tx * TN]);
        const float aev[TM] = {ae.x, ae.y, ae.z, ae.w};
        const float cev[TN] = {ce.x, ce.y, ce.z, ce.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc_sig[i][j] = fmaf(aev[i], cev[j], acc_sig[i][j]);
      }
    }
    if (bias && tid < 64) {
#pragma unroll
      for (int bb = 0; bb < BB; ++bb) {
        bsum_mu += gs[bb][tid];
        if (EPS) bsum_sig += ges[bb][tid];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int n = n0 + ty * TM + i;
    if (n >= OUT) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = k0 + tx * TN + j;
      if (k >= IN) continue;
      dw_mu[(size_t)n * IN + k] = rnd<T>(acc_mu[i][j]);
      if (EPS) dw_sig[(size_t)n * IN + k] = rnd<T>(acc_sig[i][j]);
    }
  }
  if (bias && tid < 64 && n0 + tid < OUT) {
    db_mu[n0 + tid] = rnd<T>(bsum_mu);
    if (EPS) db_sig[n0 + tid] = rnd<T>(bsum_sig);
  }
}

// One 64 x 64 tile (batch rows m0.., inputs k0..) of dx.
template <typename T, int EPS>
__device__ void input_grad_tile(float (*sm)[BB][64], const T* __restrict__ g,
                                const T* __restrict__ y,
                                const float* __restrict__ w_mu,
                                const float* __restrict__ w_sig,
                                const float* __restrict__ eps_in,
                                const float* __restrict__ eps_out,
                                T* __restrict__ dx, int B, int IN, int OUT,
                                int relu, int m0, int k0) {
  float (*gs)[64] = sm[0];   // g tile, output-major: gs[o][b]
  float (*ges)[64] = sm[1];  // (g * eps_out) tile
  float (*wms)[64] = sm[2];  // mu_w tile: wms[o][k]
  float (*wss)[64] = sm[3];  // sigma_w tile
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // 4 inputs each
  const int ty = tid / 16;   // 4 batch rows each
  // g loads: each thread reads 4 consecutive outputs of one batch row.
  const int gr = tid / 4;
  const int go = (tid % 4) * 4;
  // weight loads: each thread reads 4 consecutive inputs of one output.
  const int wr = tid / 16;
  const int wc = (tid % 16) * 4;

  float acc_mu[TM][TN];
  float acc_sig[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc_mu[i][j] = acc_sig[i][j] = 0.f;

  for (int o0 = 0; o0 < OUT; o0 += BB) {
    const int b = m0 + gr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + go + j;
      float gv = 0.f;
      if (b < B && o < OUT) gv = masked_g(g, y, (size_t)b * OUT + o, relu);
      gs[go + j][gr] = gv;
      if (EPS) {
        float eo = 0.f;
        if (b < B && o < OUT)
          eo = EPS == 1 ? eps_out[o] : eps_out[(size_t)b * OUT + o];
        ges[go + j][gr] = rnd<T>(gv * rnd<T>(eo));
      }
      const int k = k0 + wc + j;
      const int ow = o0 + wr;
      const bool in = ow < OUT && k < IN;
      wms[wr][wc + j] = in ? rnd<T>(w_mu[(size_t)ow * IN + k]) : 0.f;
      if (EPS) wss[wr][wc + j] = in ? rnd<T>(w_sig[(size_t)ow * IN + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int oo = 0; oo < BB; ++oo) {
      const float4 a = *reinterpret_cast<const float4*>(&gs[oo][ty * TM]);
      const float4 c = *reinterpret_cast<const float4*>(&wms[oo][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float cv[TN] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc_mu[i][j] = fmaf(av[i], cv[j], acc_mu[i][j]);
      if (EPS) {
        const float4 ae = *reinterpret_cast<const float4*>(&ges[oo][ty * TM]);
        const float4 ce = *reinterpret_cast<const float4*>(&wss[oo][tx * TN]);
        const float aev[TM] = {ae.x, ae.y, ae.z, ae.w};
        const float cev[TN] = {ce.x, ce.y, ce.z, ce.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc_sig[i][j] = fmaf(aev[i], cev[j], acc_sig[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = m0 + ty * TM + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = k0 + tx * TN + j;
      if (k >= IN) continue;
      float v = rnd<T>(acc_mu[i][j]);
      if (EPS) {
        const float ei =
            rnd<T>(EPS == 1 ? eps_in[k] : eps_in[(size_t)b * IN + k]);
        v = v + rnd<T>(rnd<T>(acc_sig[i][j]) * ei);
      }
      store(dx + (size_t)b * IN + k, v);
    }
  }
}

// Blocks [0, n_wblocks) are weight blocks, the rest input blocks.
template <typename T, int EPS>
__global__ void __launch_bounds__(THREADS) noisy_linear_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ y,
    const float* __restrict__ w_mu, const float* __restrict__ w_sig,
    const float* __restrict__ eps_in, const float* __restrict__ eps_out,
    T* __restrict__ dx, float* __restrict__ dw_mu, float* __restrict__ dw_sig,
    float* __restrict__ db_mu, float* __restrict__ db_sig, int B, int IN,
    int OUT, int relu, int n_wblocks) {
  __shared__ __align__(16) float sm[4][BB][64];
  const int k_tiles = (IN + 63) / 64;
  int blk = blockIdx.x;
  if (blk < n_wblocks) {
    weight_grad_tile<T, EPS>(sm, x, g, y, eps_in, eps_out, dw_mu, dw_sig,
                             db_mu, db_sig, B, IN, OUT, relu,
                             (blk / k_tiles) * 64, (blk % k_tiles) * 64);
  } else {
    blk -= n_wblocks;
    input_grad_tile<T, EPS>(sm, g, y, w_mu, w_sig, eps_in, eps_out, dx, B,
                            IN, OUT, relu, (blk / k_tiles) * 64,
                            (blk % k_tiles) * 64);
  }
}

template <typename T>
void launch_bwd(const void* x, const void* g, const void* y,
                const float* w_mu, const float* w_sig, const float* eps_in,
                const float* eps_out, int eps_mode, void* dx, float* dw_mu,
                float* dw_sig, float* db_mu, float* db_sig, int B, int IN,
                int OUT, int relu, cudaStream_t stream) {
  const int k_tiles = (IN + 63) / 64;
  const int n_wblocks = ((OUT + 63) / 64) * k_tiles;
  const int n_xblocks = ((B + 63) / 64) * k_tiles;
  const dim3 grid(n_wblocks + n_xblocks);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* yt = static_cast<const T*>(y);
  T* dxt = static_cast<T*>(dx);
  switch (eps_mode) {
    case 0:
      noisy_linear_bwd_kernel<T, 0><<<grid, THREADS, 0, stream>>>(
          xt, gt, yt, w_mu, w_sig, eps_in, eps_out, dxt, dw_mu, dw_sig, db_mu,
          db_sig, B, IN, OUT, relu, n_wblocks);
      break;
    case 1:
      noisy_linear_bwd_kernel<T, 1><<<grid, THREADS, 0, stream>>>(
          xt, gt, yt, w_mu, w_sig, eps_in, eps_out, dxt, dw_mu, dw_sig, db_mu,
          db_sig, B, IN, OUT, relu, n_wblocks);
      break;
    default:
      noisy_linear_bwd_kernel<T, 2><<<grid, THREADS, 0, stream>>>(
          xt, gt, yt, w_mu, w_sig, eps_in, eps_out, dxt, dw_mu, dw_sig, db_mu,
          db_sig, B, IN, OUT, relu, n_wblocks);
  }
}

}  // namespace

// x and y are float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1); all other
// tensors float32. Returns cudaGetLastError() after the launch.
extern "C" int noisy_linear_fwd(const void* x, int x_bf16, const float* w_mu,
                                const float* w_sig, const float* b_mu,
                                const float* b_sig, const float* eps_in,
                                const float* eps_out, int eps_mode, void* y,
                                int B, int IN, int OUT, int relu,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    launch<__nv_bfloat16>(x, w_mu, w_sig, b_mu, b_sig, eps_in, eps_out,
                          eps_mode, y, B, IN, OUT, relu, s);
  else
    launch<float>(x, w_mu, w_sig, b_mu, b_sig, eps_in, eps_out, eps_mode, y,
                  B, IN, OUT, relu, s);
  return static_cast<int>(cudaGetLastError());
}

// Backward. x, g (the gradient into y), y (the forward's output, read only
// when relu = 1) and dx are float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1);
// the weights, eps and the four parameter grads float32. With eps_mode 0
// dsigma_w and dsigma_b are not written. Returns cudaGetLastError().
extern "C" int noisy_linear_bwd(const void* x, const void* g, const void* y,
                                int x_bf16, const float* w_mu,
                                const float* w_sig, const float* eps_in,
                                const float* eps_out, int eps_mode, void* dx,
                                float* dw_mu, float* dw_sig, float* db_mu,
                                float* db_sig, int B, int IN, int OUT,
                                int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    launch_bwd<__nv_bfloat16>(x, g, y, w_mu, w_sig, eps_in, eps_out,
                              eps_mode, dx, dw_mu, dw_sig, db_mu, db_sig, B,
                              IN, OUT, relu, s);
  else
    launch_bwd<float>(x, g, y, w_mu, w_sig, eps_in, eps_out, eps_mode, dx,
                      dw_mu, dw_sig, db_mu, db_sig, B, IN, OUT, relu, s);
  return static_cast<int>(cudaGetLastError());
}
