// Global-norm clip + Adam over every parameter tensor in one call,
// hand-written for Hopper (sm_90a).
//
// Replaces rainbow_tpu/agent.py::make_optimizer / apply_grads
// (agent.py:43-58, 212-221), optax.chain(clip_by_global_norm(10),
// adam(lr, eps=1.5e-4, mu_dtype)) applied per leaf, which XLA fuses for the
// JAX package. Per element, in float32, in optax 0.2.6's order:
//
//   norm = sqrt(sum over all tensors of g^2)
//   g    = norm < max_norm ? g : (g / norm) * max_norm
//   mu   = (1 - b1) * g + b1 * mu       (b1 * mu in bf16 when mu is bf16)
//   nu   = (1 - b2) * g * g + b2 * nu   (always float32)
//   t    = count + 1
//   u    = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
//   p    = p + (-lr) * u
//
// mu_hat comes from the float32 mu before mu is rounded to bf16 for
// storage. With a bf16 mu, optax's b1 * mu is a bf16 product whose factor
// b1 is itself rounded to bf16 (0.8984375), and the kernel does the same.
//
// Bound on the H100 for the canonical net (6,868,842 float32 parameters in
// 22 tensors, pong): the update reads p, g, mu, nu and writes p, mu, nu,
// and the norm reads g once more: 8 * 27.5 MB = 220 MB with a float32 mu
// (66 us at 3.35 TB/s), 192 MB (57 us) with a bf16 mu; a few FLOP per
// byte, so bound by bytes. The design makes two passes over the tensors,
// which are described by a pointer table passed by value as a kernel
// argument (a multi-tensor launch, no flat copy of the grads). Pass 1: each
// block sums g^2 over its 4096-element chunk of one tensor into its own
// partial, and block 0 advances Adam's count. Pass 2: every block first
// reduces all partials in one fixed order (so every block, and every run,
// gets the same norm bits: no float atomics), then updates its chunk. One
// wrapper call issues both launches on one stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_TENSORS 32

struct AdamTable {
  float* p[MAX_TENSORS];
  const float* g[MAX_TENSORS];
  void* mu[MAX_TENSORS];
  float* nu[MAX_TENSORS];
  long long n[MAX_TENSORS];
  int block_start[MAX_TENSORS + 1];  // first chunk of each tensor; [count] = total
  int count;
};

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr int CHUNK = THREADS * PER_THREAD;  // elements per block

// The block's tensor and the chunk's first element.
__device__ __forceinline__ void locate(const AdamTable& t, int blk, int* k,
                                      long long* start) {
  int i = 0;
  while (i + 1 < t.count && t.block_start[i + 1] <= blk) ++i;
  *k = i;
  *start = (long long)(blk - t.block_start[i]) * CHUNK;
}

// Sum over the block in a fixed order; the result is valid in every thread.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) s += warp_sums[w];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(THREADS)
    sumsq_kernel(const AdamTable t, float* __restrict__ partials,
                 int* __restrict__ count) {
  int k;
  long long start;
  locate(t, blockIdx.x, &k, &start);
  const float* g = t.g[k];
  const long long end = min(start + (long long)CHUNK, t.n[k]);
  float s = 0.f;
  for (long long i = start + threadIdx.x; i < end; i += THREADS) {
    const float v = g[i];
    s = fmaf(v, v, s);
  }
  s = block_sum(s);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    // optax's safe_increment: the count saturates at INT32_MAX. Pass 2,
    // the next launch on the stream, reads the new count.
    if (blockIdx.x == 0 && *count < 0x7fffffff) *count += 1;
  }
}

template <bool MU_BF16>
__global__ void __launch_bounds__(THREADS)
    adam_kernel(const AdamTable t, const float* __restrict__ partials,
                int n_partials, const int* __restrict__ count, float lr,
                float b1, float b2, float one_m_b1, float one_m_b2,
                float eps, float max_norm) {
  float s = 0.f;
  for (int i = threadIdx.x; i < n_partials; i += THREADS) s += partials[i];
  const float norm = sqrtf(block_sum(s));
  const bool clip = !(norm < max_norm);
  const float step = (float)*count;
  const float bc1 = 1.f - powf(b1, step);
  const float bc2 = 1.f - powf(b2, step);
  const float b1_bf16 = __bfloat162float(__float2bfloat16(b1));
  const float neg_lr = -lr;

  int k;
  long long start;
  locate(t, blockIdx.x, &k, &start);
  const long long end = min(start + (long long)CHUNK, t.n[k]);
  float* p = t.p[k];
  const float* g = t.g[k];
  float* nu = t.nu[k];
  for (long long i = start + threadIdx.x; i < end; i += THREADS) {
    float gi = g[i];
    if (clip) gi = (gi / norm) * max_norm;
    float mu_new;
    if (MU_BF16) {
      __nv_bfloat16* mu = static_cast<__nv_bfloat16*>(t.mu[k]);
      const float decayed =
          __bfloat162float(__float2bfloat16(b1_bf16 * __bfloat162float(mu[i])));
      mu_new = __fadd_rn(__fmul_rn(one_m_b1, gi), decayed);
      mu[i] = __float2bfloat16(mu_new);
    } else {
      float* mu = static_cast<float*>(t.mu[k]);
      mu_new = __fadd_rn(__fmul_rn(one_m_b1, gi), __fmul_rn(b1, mu[i]));
      mu[i] = mu_new;
    }
    const float nu_new = __fadd_rn(__fmul_rn(one_m_b2, __fmul_rn(gi, gi)),
                                   __fmul_rn(b2, nu[i]));
    nu[i] = nu_new;
    const float mu_hat = mu_new / bc1;
    const float nu_hat = nu_new / bc2;
    const float u = mu_hat / (sqrtf(nu_hat) + eps);
    p[i] = __fadd_rn(p[i], __fmul_rn(neg_lr, u));
  }
}

}  // namespace

extern "C" int adam_max_tensors() { return MAX_TENSORS; }
extern "C" int adam_chunk() { return CHUNK; }

// One clip + Adam step over the tensors of *table (host memory; copied into
// the kernels' arguments). partials is float32 scratch with one entry per
// chunk (table->block_start[table->count]); count is Adam's int32 step
// counter on the device, advanced by one. one_m_b1 and one_m_b2 are
// 1 - b1 and 1 - b2 worked out in double and rounded to float, as optax's
// Python constants are. Returns cudaGetLastError().
extern "C" int adam_clip_step(const AdamTable* table, float* partials,
                              int* count, int mu_bf16, float lr, float b1,
                              float b2, float one_m_b1, float one_m_b2,
                              float eps, float max_norm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = table->block_start[table->count];
  sumsq_kernel<<<blocks, THREADS, 0, s>>>(*table, partials, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mu_bf16)
    adam_kernel<true><<<blocks, THREADS, 0, s>>>(*table, partials, blocks,
                                                 count, lr, b1, b2,
                                                 one_m_b1, one_m_b2, eps,
                                                 max_norm);
  else
    adam_kernel<false><<<blocks, THREADS, 0, s>>>(*table, partials, blocks,
                                                  count, lr, b1, b2,
                                                  one_m_b1, one_m_b2, eps,
                                                  max_norm);
  return static_cast<int>(cudaGetLastError());
}
