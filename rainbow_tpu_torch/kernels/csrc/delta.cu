// The observations of a delta upload rebuilt on the card, hand-written for
// Hopper (sm_90a): each env's newest frame-stack plane with the env's
// changed pixels written over it.
//
// Replaces rainbow_tpu/train.py::_apply_delta (train.py:176-195), which XLA
// runs for the JAX package as a segment expansion of the per-env counts
// (env_id = repeat(arange(N), counts)) and one sorted-unique scatter into
// the flat (N * 84 * 84) uint8 copy of stack[..., -1]. Here, for N envs,
// a plane of P = 84 * 84 pixels and a history of H frames:
//
//   obs[e, p]              = stack[e, p, H - 1]          for every pixel
//   obs[e, pos[j]]         = val[j]   for j in [start_e, start_e + counts[e])
//                                     and j < kp,
//   start_e                = counts[0] + ... + counts[e - 1]
//
// Entries past sum(counts) (the padding of a bucketed upload) fall in no
// env's segment and are dropped; a position >= P is dropped too (the engine
// never emits one; JAX's flat scatter would land it in the next env's
// plane).
//
// Bound on the H100 at 1024 envs: the function reads the newest plane
// (7.2 MB), 4 bytes per env of counts and 3 bytes per entry, and writes
// 7.2 MB: about 4.5 us at 3.35 TB/s, bound by bytes (no arithmetic to
// speak of). The design: one launch, one block per env. The block first
// sums counts[0..e) itself (at most N loads from L2 per block, a block-wide
// reduction: no separate scan launch), then copies its plane out of the
// stack, for H = 4 as 16-byte loads of four pixels' stacks that keep the
// top byte of each 32-bit word, then, after a barrier, writes its own
// segment. Within an env the positions are ordered and unique, so no two
// threads write one byte, and no block touches another env's plane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ long long block_sum(long long v) {
  __shared__ long long warp_sums[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  long long s = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) s += warp_sums[w];
  return s;
}

__global__ void __launch_bounds__(THREADS)
    delta_kernel(const uint8_t* __restrict__ stack,
                 const int* __restrict__ counts,
                 const uint16_t* __restrict__ pos,
                 const uint8_t* __restrict__ val, int plane, int history,
                 long long kp, uint8_t* __restrict__ obs) {
  const int e = blockIdx.x;
  long long s = 0;
  for (int i = threadIdx.x; i < e; i += THREADS) s += counts[i];
  const long long start = block_sum(s);
  const long long end = min(start + static_cast<long long>(counts[e]), kp);

  const uint8_t* src = stack + static_cast<size_t>(e) * plane * history;
  uint8_t* dst = obs + static_cast<size_t>(e) * plane;
  if (history == 4) {  // a pixel's stack is one 32-bit word, newest on top
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint32_t* d4 = reinterpret_cast<uint32_t*>(dst);
    for (int i = threadIdx.x; i < plane / 4; i += THREADS) {
      const uint4 v = s4[i];
      d4[i] = (v.x >> 24) | ((v.y >> 24) << 8) | ((v.z >> 24) << 16) |
              (v.w & 0xff000000u);
    }
  } else {
    for (int p = threadIdx.x; p < plane; p += THREADS)
      dst[p] = src[static_cast<size_t>(p) * history + history - 1];
  }
  __syncthreads();
  for (long long j = start + threadIdx.x; j < end; j += THREADS) {
    const int p = pos[j];
    if (p < plane) dst[p] = val[j];
  }
}

}  // namespace

// obs (n_envs, plane) uint8 from stack (n_envs, plane, history) uint8,
// counts (n_envs,) int32, pos (kp,) uint16, val (kp,) uint8; for history 4
// the stack is 16-byte aligned and plane a multiple of 4 (the wrapper
// checks). One launch on stream. Returns cudaGetLastError().
extern "C" int apply_delta(const uint8_t* stack, const int* counts,
                           const uint16_t* pos, const uint8_t* val,
                           int n_envs, int plane, int history, long long kp,
                           uint8_t* obs, void* stream) {
  if (n_envs == 0) return 0;
  delta_kernel<<<n_envs, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      stack, counts, pos, val, plane, history, kp, obs);
  return static_cast<int>(cudaGetLastError());
}
