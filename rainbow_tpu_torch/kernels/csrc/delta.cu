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
//   obs[e, pos[j]]         = val[j]   for j in [offsets[e], offsets[e + 1])
//                                     and j < kp,
//
// offsets (N + 1,) the exclusive sums of the counts with offsets[0] = 0,
// built on the host beside the counts (train.py::delta_offsets). Entries
// past offsets[N] (the padding of a bucketed upload) fall in no env's
// segment and are dropped; a position >= P is dropped too (the engine never
// emits one; JAX's flat scatter would land it in the next env's plane).
//
// Bound on the H100 at 1024 envs: the function needs the newest plane
// (7.2 MB), 4 bytes per env of offsets and 3 bytes per entry, and writes
// 7.2 MB: about 4.4 us at 3.35 TB/s. But the stack is (N, P, H) uint8 with
// the history interleaved, so every 32-byte sector that holds newest-plane
// bytes holds the other H - 1 frames too: any kernel moves the whole
// 28.9 MB stack in from device memory (the Trainer's path leaves it there),
// a sector floor of 36.1 MB, 10.8 us. So the design is a copy at the rate
// of device memory, with no dependent round trip ahead of it: one launch
// of ceil(P / CHUNK) blocks per env, each over CHUNK pixels of its plane,
// few registers a thread, so that a whole 2048-thread SM holds eight
// blocks and each thread's VEC 16-byte loads are in flight together (for
// H = 4 a vector is four pixels' stacks, of which the top byte of each
// 32-bit word is kept). A block reads its env's two offsets and its
// threads' first entries with the plane's loads, before it stores
// anything; it writes its chunk, then, after a barrier, the entries of its
// env's segment whose positions fall in its chunk. Within an env the
// positions are unique, so no two threads write one byte, and no block
// touches another's chunk.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 2;                      // 16-byte loads a thread
constexpr int CHUNK = THREADS * VEC * 4;    // pixels a block: 2048

__device__ __forceinline__ uint32_t newest_of_4(uint4 v) {
  return (v.x >> 24) | ((v.y >> 24) << 8) | ((v.z >> 24) << 16) |
         (v.w & 0xff000000u);
}

__global__ void __launch_bounds__(THREADS)
    delta_kernel(const uint8_t* __restrict__ stack,
                 const int* __restrict__ offsets,
                 const uint16_t* __restrict__ pos,
                 const uint8_t* __restrict__ val, int plane, int history,
                 int chunks, long long kp, uint8_t* __restrict__ obs) {
  const int e = blockIdx.x / chunks;
  const int lo = (blockIdx.x % chunks) * CHUNK;  // this block's pixels
  const int hi = min(lo + CHUNK, plane);
  const long long start = offsets[e];
  const long long end = min(static_cast<long long>(offsets[e + 1]), kp);
  // The thread's first entry, loaded with the plane.
  const long long j0 = start + threadIdx.x;
  int p0 = plane;  // none
  uint8_t v0 = 0;
  if (j0 < end) {
    p0 = pos[j0];
    v0 = val[j0];
  }

  const uint8_t* src = stack + static_cast<size_t>(e) * plane * history;
  uint8_t* dst = obs + static_cast<size_t>(e) * plane;
  if (history == 4) {  // a pixel's stack is one 32-bit word, newest on top
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint32_t* d4 = reinterpret_cast<uint32_t*>(dst);
    uint4 v[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int i = lo / 4 + k * THREADS + threadIdx.x;
      if (i < hi / 4) v[k] = s4[i];
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int i = lo / 4 + k * THREADS + threadIdx.x;
      if (i < hi / 4) d4[i] = newest_of_4(v[k]);
    }
  } else {
    for (int p = lo + threadIdx.x; p < hi; p += THREADS)
      dst[p] = src[static_cast<size_t>(p) * history + history - 1];
  }
  __syncthreads();
  if (p0 >= lo && p0 < hi) dst[p0] = v0;
  for (long long j = j0 + THREADS; j < end; j += THREADS) {
    const int p = pos[j];
    if (p >= lo && p < hi) dst[p] = val[j];
  }
}

}  // namespace

// obs (n_envs, plane) uint8 from stack (n_envs, plane, history) uint8,
// offsets (n_envs + 1,) int32 with offsets[0] = 0 and nondecreasing, pos
// (kp,) uint16, val (kp,) uint8; for history 4 the stack is 16-byte aligned
// and plane a multiple of 4 (the wrapper checks). One launch of
// n_envs * ceil(plane / CHUNK) blocks on stream. Returns a CUDA error code.
extern "C" int apply_delta(const uint8_t* stack, const int* offsets,
                           const uint16_t* pos, const uint8_t* val,
                           int n_envs, int plane, int history, long long kp,
                           uint8_t* obs, void* stream) {
  if (n_envs == 0) return 0;
  const int chunks = (plane + CHUNK - 1) / CHUNK;
  if (plane < 1 || static_cast<long long>(n_envs) * chunks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<<<n_envs * chunks, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      stack, offsets, pos, val, plane, history, chunks, kp, obs);
  return static_cast<int>(cudaGetLastError());
}
