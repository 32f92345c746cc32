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
//   BoxMuller(a, b), in float64 in the plain version:
//              u1 = (a + 1) * 2^-32 in (0, 1], u2 = b * 2^-32 in [0, 1),
//              r = sqrt(-2 ln u1), t = 2 pi u2, (r cos t, r sin t)
//   eps      = sign(z) * sqrt(|z|) in float64, rounded once to float32
//
// Philox4x32-10 is Random123's (Salmon et al., SC'11): ten rounds of
// (hi, lo) = mulhilo32(M, c) with M0 = 0xD2511F53, M1 = 0xCD9E8D57, the key
// bumped by (0x9E3779B9, 0xBB67AE85) between rounds.
//
// The output is one float32 buffer per draw (kernels/noise.py::noise_layout):
// tensor k starts at float 4 * (base_k - base_0), so counter c writes
// buffer[4 (c - base_0) .. + 3] with one 16-byte store, and a tensor whose
// length is not a multiple of 4 leaves its last counter's spare values in
// the gap before the next tensor. One thread per counter; no table, no
// ragged tail.
//
// Bound on the H100, at the learner round's draw (8192 target rows and 256
// online draws of 8,677 floats: 73.3 M elements, pong): the kernel reads
// nothing and writes 293 MB (0.0875 ms at 3.35 TB/s). Philox with the
// store alone takes 0.090 ms there (CUDA graphs, H100 80GB HBM3, 700 W);
// Box-Muller and the transform in float64 (a double log, sincos and two
// sqrt a pair, at 64 FP64 lanes an SM and no double path in the
// special-function unit) took 0.36 ms on the same store, and the kernel's
// first version, which also walked a pointer table, 0.38 ms. Here they run
// in float32 (0.245 ms) and stay within 1e-5 of the float64 plain version,
// with the same signs, on every pair of words:
//
// - The radius. u1 = (a + 1) 2^-32 does not fit a float32: near u1 = 1 a
//   rounded u1 would cut -ln u1, and so r, off, and eps = sqrt|z| turns an
//   absolute error d of -ln u1 into about d^(1/4). So u1 is written as
//   2^(n-32) (1 + x) with n = 32 for a >= 2^31, else the bit length of
//   a + 1, and x = -d 2^-n in [-1/2, 0] from the exact integer d = 2^n - 1
//   - a: ln u1 = log1pf(x) + (n - 32) ln 2, accurate relative to itself
//   everywhere, in one call (no divergent branch between logf and log1pf).
// - The angle. t = 2 pi b 2^-32 = (pi/2) (q + f 2^-30), with the quadrant q
//   = b >> 30 and f = b mod 2^30. A sine or cosine near 0 must likewise be
//   accurate relative to itself: sin and cos of (pi/2) f 2^-30 come from
//   sincospif of the smaller of f and 2^30 - f (exact integers) times
//   2^-31, and are swapped when it is 2^30 - f. The quadrant then swaps
//   and negates them exactly (sign bits).
// - The quadrant boundaries (b = 2^30, 2^31, 3 2^30). There the float64
//   t = fl(q pi / 2) is not q pi / 2, and cos or sin of it is not 0:
//   6.12e-17, 1.22e-16 and -1.84e-16. Those values, with their signs, are
//   taken here in place of the exact zero.
//
// log1pf and sincospif are CUDA's accurate functions (1 ulp), sqrtf is IEEE
// (no --use_fast_math, no __logf): r, z and eps come out within a few
// float32 ulps of the float64 values (2.4e-7 at most on 10^6 random pairs
// and the edge words, on an H100). What is left is bound by instruction
// issue, not bytes: about 380 instructions run a counter (Philox about 80,
// each Box-Muller about 130: log1pf, sincospif and its reduction, three
// IEEE sqrtf with their range checks).

#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float scaled(float z) {
  return copysignf(sqrtf(fabsf(z)), z);
}

// ln u1 for u1 = (a + 1) 2^-32, as one log1pf (see the header).
__device__ __forceinline__ float log_u1(uint32_t a) {
  const int n = a >= 0x80000000u ? 32 : 32 - __clz(a + 1u);
  const uint32_t d = (0xFFFFFFFFu >> (32 - n)) - a;
  const float x = -static_cast<float>(d) * __int_as_float((127 - n) << 23);
  return fmaf(static_cast<float>(n - 32), 0.693147182f, log1pf(x));
}

// BoxMuller(a, b) and the transform, in float32 (see the header).
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float* e0,
                                           float* e1) {
  const float r = sqrtf(-2.f * log_u1(a));
  const uint32_t q = b >> 30, f = b & 0x3FFFFFFFu;
  const bool low = f <= 0x20000000u;  // (pi/2) f 2^-30 <= pi/4
  float s, c;
  sincospif(static_cast<float>(low ? f : 0x40000000u - f) * 0x1p-31f, &s,
            &c);
  float sin_f = low ? s : c;
  const float cos_f = low ? c : s;
  // At f = 0, -sin_f stands for cos fl(pi/2) (q = 1) and sin fl(pi)
  // (q = 2), sin_f for cos fl(3 pi/2) (q = 3), in float64.
  if (f == 0 && q)
    sin_f = q == 1 ? -6.123234e-17f : q == 2 ? -1.2246469e-16f
                                             : -1.8369701e-16f;
  // (cos t, sin t) = (cos_f, sin_f) turned by q quarter turns.
  const bool odd = q & 1u;
  const uint32_t neg_c = ((q ^ (q >> 1)) & 1u) << 31, neg_s = (q >> 1) << 31;
  const float ct =
      __uint_as_float(__float_as_uint(odd ? sin_f : cos_f) ^ neg_c);
  const float st =
      __uint_as_float(__float_as_uint(odd ? cos_f : sin_f) ^ neg_s);
  *e0 = scaled(r * ct);
  *e1 = scaled(r * st);
}

__global__ void __launch_bounds__(THREADS)
    noise_kernel(float4* __restrict__ out, long long counters,
                 unsigned long long base, uint32_t k0, uint32_t k1) {
  const long long j = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (j >= counters) return;
  const unsigned long long c = base + static_cast<unsigned long long>(j);
  const uint4 w = philox4x32_10(
      make_uint4(static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32), 0u,
                 0u),
      k0, k1);
  float4 v;
  box_muller(w.x, w.y, &v.x, &v.y);
  box_muller(w.z, w.w, &v.z, &v.w);
  out[j] = v;
}

__global__ void __launch_bounds__(THREADS)
    box_muller_kernel(const long long* __restrict__ words,
                      float* __restrict__ out, long long pairs) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i >= pairs) return;
  box_muller(static_cast<uint32_t>(words[2 * i]),
             static_cast<uint32_t>(words[2 * i + 1]), &out[2 * i],
             &out[2 * i + 1]);
}

unsigned grid(long long threads) {
  return static_cast<unsigned>((threads + THREADS - 1) / THREADS);
}

}  // namespace

// One draw of `counters` Philox counters from `base` on: counter base + j
// writes out[4 j .. 4 j + 3] (out: 4 * counters float32, 16-byte aligned).
// seed is the stream's 64-bit seed. One launch on stream. Returns
// cudaGetLastError().
extern "C" int scaled_noise(float* out, long long counters,
                            unsigned long long base, unsigned long long seed,
                            void* stream) {
  if (counters <= 0) return 0;
  noise_kernel<<<grid(counters), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(out), counters, base,
      static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
  return static_cast<int>(cudaGetLastError());
}

// The kernel's BoxMuller and transform alone, on given words: words holds
// `pairs` pairs (a, b) as int64 in [0, 2^32); out[2 i], out[2 i + 1] get
// the eps of pair i. For holding the float32 arithmetic against the plain
// version on chosen words. One launch on stream. Returns
// cudaGetLastError().
extern "C" int noise_box_muller(const long long* words, float* out,
                                long long pairs, void* stream) {
  if (pairs <= 0) return 0;
  box_muller_kernel<<<grid(pairs), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(words, out, pairs);
  return static_cast<int>(cudaGetLastError());
}
