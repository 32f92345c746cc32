// The noisy layers' factored noise draws, hand-written for Hopper (sm_90a):
// eps = sign(n) * sqrt(|n|) of standard-normal n, for every tensor of one
// draw in one launch.
//
// Replaces rainbow_tpu/models/noisy.py::_scale_noise (noisy.py:49-54) and
// rainbow_tpu/models/dqn.py::draw_noise (dqn.py:86-103), which XLA fuses
// into jax.random.normal's threefry stream for the JAX package. The bits
// differ from JAX's (threefry cannot be reproduced here); the distribution
// is the same, and the draw is a pure function of (seed, offset, shapes),
// so models/noisy.py::philox_noise_plain reproduces it on the CPU.
//
// The stream (the same in philox_noise_plain):
//
//   key      = (seed mod 2^32, seed div 2^32 mod 2^32)
//   offset   = the stream's position in 32-bit words, a multiple of 4
//   tensor k = the k-th of the draw's tensors, n_k elements, row-major;
//              it takes the Philox counters c = base_k .. base_k + m_k - 1,
//              m_k = ceil(n_k / 4), base_0 = offset / 4,
//              base_{k+1} = base_k + m_k (disjoint ranges); the draw
//              advances the offset by 4 * sum m_k words
//   counter  c -> ctr = (c mod 2^32, c div 2^32, 0, 0),
//              (w0, w1, w2, w3) = Philox4x32-10(ctr, key)
//   elements 4j .. 4j+3 of tensor k, j = c - base_k (those below n_k):
//              (z0, z1) = BoxMuller(w0, w1), (z2, z3) = BoxMuller(w2, w3)
//   BoxMuller(a, b), in float64:
//              u1 = (a + 1) * 2^-32 in (0, 1], u2 = b * 2^-32 in [0, 1),
//              r = sqrt(-2 ln u1), t = 2 pi u2, (r cos t, r sin t)
//   eps      = sign(z) * sqrt(|z|) in float64, rounded once to float32
//
// Philox4x32-10 is Random123's (Salmon et al., SC'11): ten rounds of
// (hi, lo) = mulhilo32(M, c) with M0 = 0xD2511F53, M1 = 0xCD9E8D57, the key
// bumped by (0x9E3779B9, 0xBB67AE85) between rounds.
//
// Bound on the H100, at the learner round's target draw (8192 rows of 8,677
// floats, 71.1 M elements, pong): the kernel reads nothing and writes 284 MB
// (0.085 ms at 3.35 TB/s); Philox is ~25 integer operations per element and
// Box-Muller a few float64 operations per element (~0.04 ms together), so
// the draw is bound by bytes. The design: one thread per counter, all in
// registers, one 16-byte store of its four floats (scalar stores at a
// ragged tail). Box-Muller runs in float64 because a float32 u1 rounds to 1
// for the top 2^-24 of draws, where r = sqrt(-2 ln u1) would collapse to 0;
// float64 keeps the kernel within one float32 rounding of the CPU's plain
// version. The tensors are described by a pointer table passed by value (as
// csrc/adam.cu does), so a draw of eight or sixteen tensors is one launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_TENSORS 16

struct NoiseTable {
  float* out[MAX_TENSORS];
  long long n[MAX_TENSORS];
  long long base[MAX_TENSORS];               // first Philox counter
  long long thread_start[MAX_TENSORS + 1];   // first thread; [count] = total
  int count;
};

namespace {

constexpr int THREADS = 256;
constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float scaled(double z) {
  return static_cast<float>(copysign(sqrt(fabs(z)), z));
}

__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float* e0,
                                           float* e1) {
  const double u1 = (static_cast<double>(a) + 1.0) * 0x1p-32;
  const double u2 = static_cast<double>(b) * 0x1p-32;
  const double r = sqrt(-2.0 * log(u1));
  double s, c;
  sincos(6.283185307179586 * u2, &s, &c);
  *e0 = scaled(r * c);
  *e1 = scaled(r * s);
}

__global__ void __launch_bounds__(THREADS)
    noise_kernel(const NoiseTable t, uint32_t k0, uint32_t k1) {
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  if (tid >= t.thread_start[t.count]) return;
  int k = 0;
  while (k + 1 < t.count && t.thread_start[k + 1] <= tid) ++k;
  const long long j = tid - t.thread_start[k];
  const unsigned long long c =
      static_cast<unsigned long long>(t.base[k]) + static_cast<unsigned long long>(j);
  const uint4 w = philox4x32_10(
      make_uint4(static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32), 0u,
                 0u),
      k0, k1);
  float4 v;
  box_muller(w.x, w.y, &v.x, &v.y);
  box_muller(w.z, w.w, &v.z, &v.w);
  float* out = t.out[k] + 4 * j;
  const long long left = t.n[k] - 4 * j;
  if (left >= 4) {
    *reinterpret_cast<float4*>(out) = v;  // the wrapper checks alignment
  } else {
    out[0] = v.x;
    if (left > 1) out[1] = v.y;
    if (left > 2) out[2] = v.z;
  }
}

}  // namespace

extern "C" int noise_max_tensors() { return MAX_TENSORS; }

// One draw into the tensors of *table (host memory, copied into the
// kernel's arguments): out[k] holds n[k] float32, 16-byte aligned; base[k]
// and thread_start[] as the stream above. seed is the stream's 64-bit seed.
// One launch on stream. Returns cudaGetLastError().
extern "C" int scaled_noise(const NoiseTable* table,
                            unsigned long long seed, void* stream) {
  const long long threads = table->thread_start[table->count];
  if (threads == 0) return 0;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  noise_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      *table, static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
  return static_cast<int>(cudaGetLastError());
}
