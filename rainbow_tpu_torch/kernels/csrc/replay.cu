// The prioritized replay's sampler and write-back, hand-written for Hopper
// (sm_90a): K5 stratified_sample, K6 gather_window, K7 write_priorities.
//
// Replaces what XLA fuses for the JAX package's batched learner round
// (rainbow_tpu/train.py::_learner_round_batched_impl, train.py:377-417):
//   K5  rainbow_tpu/replay/prioritized.py::_stratified_find,
//       _valid_time_mask and _masked_flat_priorities (prioritized.py:102-142,
//       212-215): the write-head mask, the sum-tree levels and the
//       stratified descent of every draw of the round;
//   K6  prioritized.py::_gather_unnormalised, _blank_masks and the
//       sample_many reshape + per-batch normalisation (prioritized.py:145-209,
//       264-277): the uint8 frame windows with episode blanking, the n-step
//       returns, nonterminals, actions and IS weights of every batch;
//   K7  prioritized.py::update_priorities (prioritized.py:285-295): the
//       loss^omega scatter and the monotone max priority.
// Their plain versions are rainbow_tpu_torch/replay/prioritized.py's
// stratified_sample_plain, gather_window_plain and update_priorities_plain.
//
// Bounds on the H100 at the canonical round (1024 envs x 976 columns =
// 999,424 leaves, padded to L = 2^20; 8192 draws = 256 batches x 32;
// history 4 + n-step 3 = a window of 7 frames of 7056 bytes):
//   K5 reads the priorities once (4 MB): 1.2 us at 3.35 TB/s. Its levels
//      (8 MB) stay in the 50 MB L2 between its launches.
//   K6 reads and writes 8192 x 7 frames: 2 x 405 MB, 0.24 ms. Bound by bytes.
//   K7 moves about 130 KB: bound by launch latency.
//
// Bit-exactness with the plain versions. K5 builds every tree node as
// left + right of its two children, in the tree's own pairing (float addition
// is commutative, so the pair's order does not matter, but no other
// reassociation is allowed), divides the total by B in IEEE division (this
// file must not be built with --use_fast_math) and descends with the same
// `value > left` test and subtraction, so its indices, leaf values and total
// are the plain version's bits. K6 copies frames, actions and nonterminals
// bit for bit; its returns and IS weights agree to about 1e-6 relative
// (pow and the gamma-weighted sum run in another order). K7 computes
// loss^omega as torch.pow does for the same exponent (a square root at
// omega = 0.5), so the written priorities and the max are the same bits.
//
// Design.
//   K5: three launches. (1) Each block masks an aligned chunk of 2048 leaves
//       (the write head read on the device) and reduces it pairwise in
//       shared memory, writing every level inside the chunk. (2) One block
//       builds the levels above the chunks (at most 2048 chunk tops, so
//       L <= 2^22). (3) One thread per draw descends from the root. The
//       tree is a heap: node k's children are 2k and 2k+1, leaves at L + i.
//   K6: two launches. (1) One block per batch: its threads take the batch's
//       rows, find each row's window and episode-blanking mask from
//       `timesteps == 0`, write the row's scalar fields and unnormalised IS
//       weight, reduce the batch max in shared memory and normalise. (2) One
//       warp per frame of the window copies 7056 bytes as 441 16-byte
//       vectors, or writes zeros where the frame is blanked. The frame copy
//       is split by frame, not by batch: a block per batch would leave 32
//       blocks on 132 SMs for the throughput preset (32 batches of 256).
//       Draw j goes to batch j % nb, row j / nb (prioritized.py:270-273).
//   K7: one block of 1024 threads walks the draws in draw order. Stratified
//       draws are nondecreasing in draw order, so a leaf drawn more than once
//       is drawn by a run of consecutive draws: only the last draw of each
//       run writes, so the winner is deterministic. The max of all the new
//       priorities is reduced in the block, without atomics, and combined
//       with the old max in the same launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 2048;        // leaves per block of the first K5 pass
constexpr int TREE_THREADS = 1024; // CHUNK / 2: one node per thread per level
constexpr int MAX_TOPS = 2048;     // chunk tops the single second-pass block takes
constexpr int FIELD_THREADS = 128;
constexpr int COPY_WARPS = 8;
constexpr int WRITE_THREADS = 1024;

__device__ __forceinline__ int wrap(long long a, int c) {
  long long r = a % c;
  return static_cast<int>(r < 0 ? r + c : r);
}

// torch.pow(tensor, scalar) takes these exponents by their own operations.
__device__ __forceinline__ float pow_scalar(float x, float e) {
  if (e == 0.f) return 1.f;
  if (e == 1.f) return x;
  if (e == 0.5f) return sqrtf(x);
  if (e == 2.f) return x * x;
  if (e == -0.5f) return rsqrtf(x);
  if (e == -1.f) return 1.f / x;
  if (e == -2.f) return 1.f / (x * x);
  return powf(x, e);
}

// ---------------------------------------------------------------- K5 -----

__global__ void __launch_bounds__(TREE_THREADS) tree_chunks_kernel(
    const float* __restrict__ prio, const int32_t* __restrict__ index, int C,
    int n, int L, int S, int history, int n_step, float* __restrict__ tree) {
  __shared__ float s[CHUNK];
  const int head = *index;
  const int base = blockIdx.x * S;
  for (int k = threadIdx.x; k < S; k += blockDim.x) {
    const int i = base + k;
    float v = 0.f;
    if (i < n) {
      const int pos = i % C;
      const int ahead = wrap(static_cast<long long>(head) - pos, C);
      const int behind = wrap(static_cast<long long>(pos) - head, C);
      if (ahead > n_step && behind >= history) v = prio[i];
    }
    s[k] = v;
    tree[L + i] = v;
  }
  __syncthreads();
  int M = L / 2;  // first node of the level being built
  for (int width = S / 2; width >= 1; width /= 2, M /= 2) {
    const int k = threadIdx.x;
    float v = 0.f;
    if (k < width) v = __fadd_rn(s[2 * k], s[2 * k + 1]);
    __syncthreads();
    if (k < width) {
      s[k] = v;
      tree[M + blockIdx.x * width + k] = v;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(TREE_THREADS) tree_top_kernel(
    float* __restrict__ tree, int M0) {
  __shared__ float s[MAX_TOPS];
  for (int k = threadIdx.x; k < M0; k += blockDim.x) s[k] = tree[M0 + k];
  __syncthreads();
  int M = M0 / 2;
  for (int width = M0 / 2; width >= 1; width /= 2, M /= 2) {
    const int k = threadIdx.x;
    float v = 0.f;
    if (k < width) v = __fadd_rn(s[2 * k], s[2 * k + 1]);
    __syncthreads();
    if (k < width) {
      s[k] = v;
      tree[M + k] = v;
    }
    __syncthreads();
  }
}

__global__ void descend_kernel(const float* __restrict__ tree,
                               const float* __restrict__ u, int B, int L,
                               int n, int64_t* __restrict__ idx_out,
                               float* __restrict__ p_out,
                               float* __restrict__ total_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const float total = tree[1];
  if (j == 0) *total_out = total;
  if (j >= B) return;
  const float seg = __fdiv_rn(total, static_cast<float>(B));
  float v = __fmul_rn(__fadd_rn(static_cast<float>(j), u[j]), seg);
  int node = 1;
  while (node < L) {
    const float left = tree[2 * node];
    if (v > left) {
      node = 2 * node + 1;
      v = __fsub_rn(v, left);
    } else {
      node = 2 * node;
    }
  }
  int leaf = node - L;
  if (leaf > n - 1) leaf = n - 1;
  idx_out[j] = leaf;
  p_out[j] = tree[L + leaf];
}

// ---------------------------------------------------------------- K6 -----

__global__ void __launch_bounds__(FIELD_THREADS) gather_fields_kernel(
    const int64_t* __restrict__ idx, const float* __restrict__ p,
    const float* __restrict__ total_ptr, const int32_t* __restrict__ actions,
    const float* __restrict__ rewards, const int32_t* __restrict__ timesteps,
    const uint8_t* __restrict__ nonterminal, const int32_t* __restrict__ index,
    const uint8_t* __restrict__ full, int E, int C, int history, int n_step,
    float discount, float beta, int nb, int bs, int64_t* __restrict__ o_idx,
    int32_t* __restrict__ o_actions, float* __restrict__ o_returns,
    float* __restrict__ o_nonterminals, float* __restrict__ o_weights,
    float* __restrict__ o_wmax, uint64_t* __restrict__ o_blank) {
  __shared__ float s_max[FIELD_THREADS];
  const int k = blockIdx.x;  // batch
  const int w = history + n_step;
  const float total = *total_ptr;
  const long long stored =
      static_cast<long long>(*full ? C : *index) * static_cast<long long>(E);
  const float stored_f = static_cast<float>(stored);
  float local_max = 0.f;
  for (int r = threadIdx.x; r < bs; r += blockDim.x) {
    const int j = r * nb + k;  // draw j -> batch j % nb, row j / nb
    const long long q = static_cast<long long>(k) * bs + r;
    const long long flat = idx[j];
    const int e = static_cast<int>(flat / C);
    const int i = static_cast<int>(flat % C);
    const size_t row = static_cast<size_t>(e) * C;
    uint64_t firsts = 0;
    for (int t = 0; t < w; ++t) {
      const int col = wrap(static_cast<long long>(i) + t - history + 1, C);
      if (timesteps[row + col] == 0) firsts |= 1ull << t;
    }
    // prioritized.py::_blank_masks: frames before an episode start, then
    // frames after a terminal.
    uint64_t blank = 0;
    for (int t = history - 2; t >= 0; --t)
      if (((blank | firsts) >> (t + 1)) & 1ull) blank |= 1ull << t;
    for (int t = history; t < w; ++t)
      if (((blank >> (t - 1)) | (firsts >> t)) & 1ull) blank |= 1ull << t;
    float ret = 0.f;
    for (int s = 0; s < n_step; ++s) {
      const int t = history - 1 + s;
      if ((blank >> t) & 1ull) continue;
      const int col = wrap(static_cast<long long>(i) + s, C);
      ret = fmaf(powf(discount, static_cast<float>(s)), rewards[row + col],
                 ret);
    }
    const int t_last = w - 1;
    const int col_last = wrap(static_cast<long long>(i) + n_step, C);
    const bool nt =
        nonterminal[row + col_last] != 0 && !((blank >> t_last) & 1ull);
    const float pj = p[j];
    const float probs = __fdiv_rn(pj, fmaxf(total, 1e-12f));
    float wt = pow_scalar(__fmul_rn(stored_f, probs), -beta);
    if (!(pj > 0.f && total > 0.f)) wt = 0.f;
    o_idx[q] = flat;
    o_actions[q] = actions[row + i];
    o_returns[q] = ret;
    o_nonterminals[q] = nt ? 1.f : 0.f;
    o_weights[q] = wt;
    o_blank[q] = blank;
    local_max = fmaxf(local_max, wt);
  }
  s_max[threadIdx.x] = local_max;
  __syncthreads();
  for (int h = blockDim.x / 2; h >= 1; h /= 2) {
    if (threadIdx.x < h)
      s_max[threadIdx.x] = fmaxf(s_max[threadIdx.x], s_max[threadIdx.x + h]);
    __syncthreads();
  }
  const float wmax = fmaxf(s_max[0], 1e-12f);
  for (int r = threadIdx.x; r < bs; r += blockDim.x) {
    const long long q = static_cast<long long>(k) * bs + r;
    o_weights[q] = __fdiv_rn(o_weights[q], wmax);
  }
  if (threadIdx.x == 0) o_wmax[k] = wmax;
}

__global__ void __launch_bounds__(COPY_WARPS * 32) gather_frames_kernel(
    const uint8_t* __restrict__ frames, const int64_t* __restrict__ o_idx,
    const uint64_t* __restrict__ o_blank, int C, int P, int history, int w,
    long long count, int vec, uint8_t* __restrict__ window) {
  const int lane = threadIdx.x & 31;
  const long long f =
      static_cast<long long>(blockIdx.x) * COPY_WARPS + (threadIdx.x >> 5);
  if (f >= count) return;
  const long long q = f / w;
  const int t = static_cast<int>(f % w);
  const long long flat = o_idx[q];
  const long long e = flat / C;
  const int i = static_cast<int>(flat % C);
  const int col = wrap(static_cast<long long>(i) + t - history + 1, C);
  const uint8_t* src = frames + (e * C + col) * static_cast<long long>(P);
  uint8_t* dst = window + f * static_cast<long long>(P);
  const bool blanked = (o_blank[q] >> t) & 1ull;
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int v = lane; v < P / 16; v += 32) d4[v] = blanked ? zero : s4[v];
  } else {
    for (int b = lane; b < P; b += 32) dst[b] = blanked ? 0 : src[b];
  }
}

// ---------------------------------------------------------------- K7 -----

__global__ void __launch_bounds__(WRITE_THREADS) write_priorities_kernel(
    const int64_t* __restrict__ idxs, const float* __restrict__ losses, int nb,
    int bs, float omega, float* __restrict__ prio,
    float* __restrict__ max_priority) {
  __shared__ float s_max[WRITE_THREADS];
  const long long B = static_cast<long long>(nb) * bs;
  float local_max = 0.f;
  for (long long j = threadIdx.x; j < B; j += blockDim.x) {
    const long long q = (j % nb) * bs + j / nb;  // element [j % nb, j / nb]
    const long long leaf = idxs[q];
    const float p = pow_scalar(losses[q], omega);
    local_max = fmaxf(local_max, p);
    if (j + 1 < B) {
      const long long qn = ((j + 1) % nb) * bs + (j + 1) / nb;
      if (idxs[qn] == leaf) continue;  // a later draw of the run writes
    }
    prio[leaf] = p;
  }
  s_max[threadIdx.x] = local_max;
  __syncthreads();
  for (int h = blockDim.x / 2; h >= 1; h /= 2) {
    if (threadIdx.x < h)
      s_max[threadIdx.x] = fmaxf(s_max[threadIdx.x], s_max[threadIdx.x + h]);
    __syncthreads();
  }
  if (threadIdx.x == 0) *max_priority = fmaxf(*max_priority, s_max[0]);
}

}  // namespace

// K5. priorities (E*C,) float32, index int32 0-d, u (B,) float32 in [0, 1);
// tree (2L,) float32 scratch with L the power of two >= E*C; outputs idx (B,)
// int64, p (B,) float32, total 0-d float32. Returns a CUDA error code.
extern "C" int stratified_sample(const void* priorities, const void* index,
                                 int E, int C, int history, int n_step,
                                 const void* u, int B, int L, void* tree,
                                 void* idx, void* p, void* total,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = E * C;
  const int S = L < CHUNK ? L : CHUNK;
  const int chunks = L / S;
  if (chunks > MAX_TOPS || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  float* t = static_cast<float*>(tree);
  tree_chunks_kernel<<<chunks, TREE_THREADS, 0, s>>>(
      static_cast<const float*>(priorities),
      static_cast<const int32_t*>(index), C, n, L, S, history, n_step, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunks > 1) {
    tree_top_kernel<<<1, TREE_THREADS, 0, s>>>(t, chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  descend_kernel<<<(B + 255) / 256, 256, 0, s>>>(
      t, static_cast<const float*>(u), B, L, n, static_cast<int64_t*>(idx),
      static_cast<float*>(p), static_cast<float*>(total));
  return static_cast<int>(cudaGetLastError());
}

// K6. The ring's fields (E, C[, P]) and the draws (idx, p in draw order,
// total); outputs in (nb, bs) order: o_idx int64, o_actions int32, o_returns,
// o_nonterminals, o_weights (normalised per batch) float32, o_wmax (nb,)
// float32, o_blank (nb*bs,) uint64 scratch, window (nb, bs, w, P) uint8.
// history + n_step <= 64. Returns a CUDA error code.
extern "C" int gather_window(
    const void* frames, const void* actions, const void* rewards,
    const void* timesteps, const void* nonterminal, const void* index,
    const void* full, int E, int C, int P, const void* idx, const void* p,
    const void* total, int history, int n_step, float discount, float beta,
    int nb, int bs, void* o_idx, void* o_actions, void* o_returns,
    void* o_nonterminals, void* o_weights, void* o_wmax, void* o_blank,
    void* window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = history + n_step;
  if (w > 64 || nb < 1 || bs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  gather_fields_kernel<<<nb, FIELD_THREADS, 0, s>>>(
      static_cast<const int64_t*>(idx), static_cast<const float*>(p),
      static_cast<const float*>(total), static_cast<const int32_t*>(actions),
      static_cast<const float*>(rewards),
      static_cast<const int32_t*>(timesteps),
      static_cast<const uint8_t*>(nonterminal),
      static_cast<const int32_t*>(index), static_cast<const uint8_t*>(full), E,
      C, history, n_step, discount, beta, nb, bs,
      static_cast<int64_t*>(o_idx), static_cast<int32_t*>(o_actions),
      static_cast<float*>(o_returns), static_cast<float*>(o_nonterminals),
      static_cast<float*>(o_weights), static_cast<float*>(o_wmax),
      static_cast<uint64_t*>(o_blank));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long count = static_cast<long long>(nb) * bs * w;
  const int vec = (P % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(frames) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(window) % 16 == 0)
                      ? 1
                      : 0;
  const long long blocks = (count + COPY_WARPS - 1) / COPY_WARPS;
  gather_frames_kernel<<<static_cast<unsigned>(blocks), COPY_WARPS * 32, 0,
                         s>>>(
      static_cast<const uint8_t*>(frames), static_cast<const int64_t*>(o_idx),
      static_cast<const uint64_t*>(o_blank), C, P, history, w, count, vec,
      static_cast<uint8_t*>(window));
  return static_cast<int>(cudaGetLastError());
}

// K7. idxs and losses (nb, bs) in batch order (element [k, r] is draw
// r * nb + k); priorities (E*C,) and max_priority 0-d float32, in place.
// Returns a CUDA error code.
extern "C" int write_priorities(const void* idxs, const void* losses, int nb,
                                int bs, float omega, void* priorities,
                                void* max_priority, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb < 1 || bs < 1) return static_cast<int>(cudaErrorInvalidValue);
  write_priorities_kernel<<<1, WRITE_THREADS, 0, s>>>(
      static_cast<const int64_t*>(idxs), static_cast<const float*>(losses), nb,
      bs, omega, static_cast<float*>(priorities),
      static_cast<float*>(max_priority));
  return static_cast<int>(cudaGetLastError());
}
