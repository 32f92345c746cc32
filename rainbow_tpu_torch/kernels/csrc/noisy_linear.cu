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
