// Replay append + frame-stack advance, hand-written for Hopper (sm_90a).
//
// Replaces what XLA fuses inside rainbow_tpu/train.py::_update_core
// (train.py:63-72) for the JAX package:
//   - the packed-reset scatter of actor_step_packed (train.py:135-136):
//     reset rows whose index is N are padding and dropped;
//   - rainbow_tpu/replay/prioritized.py::append (prioritized.py:73-95):
//     column `index` of every env's ring gets the pre-step newest frame, the
//     action, the reward clipped to +-reward_clip, timesteps = t,
//     nonterminal = !done, priority = max_priority; t advances (0 on done),
//     then index and full advance;
//   - rainbow_tpu/ops/preprocess.py::update_framestack
//     (preprocess.py:30-39), per reset kind.
// Without a replay (frames == nullptr) it only advances the stack, as the
// evaluator needs (rainbow_tpu/evaluate.py:71-80).
//
// Bound on the H100 at the actor's shapes (N = 1024 envs, 84 x 84, H = 4):
// it does no arithmetic to speak of and moves the stack in and out
// (2 x 28.9 MB), the observations (7.2 MB), the reset rows and one replay
// column (7.2 MB): about 72 MB, 21 us at 3.35 TB/s. So it is bound by bytes.
// The design touches each byte once: one block per env, and with H = 4 a
// pixel's whole history is one 32-bit word, so each reset kind is a
// shift-and-insert on that word (byte h of the word is stack[..., h]):
//   kind 0: (w >> 8)  | obs << 24
//   kind 1: (w >> 16) | obs << 16 | reset << 24
//   kind 2:  reset << 24
// The newest byte (w >> 24) goes to the replay before the word is
// rewritten, and every word is read before it is written by the same
// thread, so the update is in place. Other history lengths take a byte loop.
//
// Every block reads the pre-append `index`, so no block of the same launch
// may write it: a second, one-thread launch on the same stream advances
// index and full after every block of the first has finished.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) append_framestack_kernel(
    uint8_t* __restrict__ stack, const uint8_t* __restrict__ obs,
    const uint8_t* __restrict__ reset_packed,
    const int32_t* __restrict__ reset_idx, int K,
    const uint8_t* __restrict__ kinds, int P, int H,
    uint8_t* __restrict__ frames, int32_t* __restrict__ r_actions,
    float* __restrict__ r_rewards, int32_t* __restrict__ r_timesteps,
    uint8_t* __restrict__ r_nonterminal, float* __restrict__ r_priorities,
    const int32_t* __restrict__ r_index, int32_t* __restrict__ r_t,
    const float* __restrict__ r_max_priority, int C,
    const int64_t* __restrict__ actions, const float* __restrict__ rewards,
    const uint8_t* __restrict__ dones, float reward_clip) {
  const int e = blockIdx.x;
  __shared__ int s_row;
  __shared__ int s_col;
  if (threadIdx.x == 0) {
    s_row = -1;
    s_col = frames ? *r_index : 0;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    if (reset_idx[k] == e) s_row = k;
  __syncthreads();

  const int kind = kinds[e];
  const uint8_t* rs = s_row >= 0 ? reset_packed + (size_t)s_row * P : nullptr;
  const uint8_t* ob = obs + (size_t)e * P;
  uint8_t* fr = frames ? frames + ((size_t)e * C + s_col) * P : nullptr;

  if (H == 4) {
    uint32_t* st = reinterpret_cast<uint32_t*>(stack) + (size_t)e * P;
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const uint32_t w = st[p];
      const uint32_t o = ob[p];
      const uint32_t r = rs ? rs[p] : 0u;
      if (fr) fr[p] = static_cast<uint8_t>(w >> 24);
      st[p] = kind == 0   ? (w >> 8) | (o << 24)
              : kind == 1 ? (w >> 16) | (o << 16) | (r << 24)
                          : (r << 24);
    }
  } else {
    uint8_t* st = stack + (size_t)e * P * H;
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      uint8_t* s = st + (size_t)p * H;
      const uint8_t o = ob[p];
      const uint8_t r = rs ? rs[p] : 0;
      if (fr) fr[p] = s[H - 1];
      if (kind == 0) {
        for (int h = 0; h < H - 1; ++h) s[h] = s[h + 1];
        s[H - 1] = o;
      } else if (kind == 1) {
        for (int h = 0; h < H - 2; ++h) s[h] = s[h + 2];
        s[H - 2] = o;
        s[H - 1] = r;
      } else {
        for (int h = 0; h < H - 1; ++h) s[h] = 0;
        s[H - 1] = r;
      }
    }
  }

  if (!frames || threadIdx.x != 0) return;
  float rw = rewards[e];
  if (reward_clip > 0.f) rw = fminf(fmaxf(rw, -reward_clip), reward_clip);
  const bool done = dones[e] != 0;
  const size_t c = (size_t)e * C + s_col;
  r_actions[c] = static_cast<int32_t>(actions[e]);
  r_rewards[c] = rw;
  r_timesteps[c] = r_t[e];
  r_nonterminal[c] = done ? 0 : 1;
  r_priorities[c] = *r_max_priority;
  r_t[e] = done ? 0 : r_t[e] + 1;
}

__global__ void advance_head_kernel(int32_t* r_index, uint8_t* r_full,
                                    int C) {
  const int next = (*r_index + 1) % C;
  *r_index = next;
  if (next == 0) *r_full = 1;
}

}  // namespace

// Pointers of the replay (frames .. r_max_priority) and of the transition
// (actions, rewards, dones) are null for the frame-stack-only mode.
// Returns cudaGetLastError() after the launches.
extern "C" int append_framestack(
    void* stack, const void* obs, const void* reset_packed,
    const void* reset_idx, int K, const void* kinds, int N, int P, int H,
    void* frames, void* r_actions, void* r_rewards, void* r_timesteps,
    void* r_nonterminal, void* r_priorities, void* r_index, void* r_full,
    void* r_t, const void* r_max_priority, int C, const void* actions,
    const void* rewards, const void* dones, float reward_clip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  append_framestack_kernel<<<N, THREADS, 0, s>>>(
      static_cast<uint8_t*>(stack), static_cast<const uint8_t*>(obs),
      static_cast<const uint8_t*>(reset_packed),
      static_cast<const int32_t*>(reset_idx), K,
      static_cast<const uint8_t*>(kinds), P, H, static_cast<uint8_t*>(frames),
      static_cast<int32_t*>(r_actions), static_cast<float*>(r_rewards),
      static_cast<int32_t*>(r_timesteps), static_cast<uint8_t*>(r_nonterminal),
      static_cast<float*>(r_priorities), static_cast<const int32_t*>(r_index),
      static_cast<int32_t*>(r_t),
      static_cast<const float*>(r_max_priority), C,
      static_cast<const int64_t*>(actions), static_cast<const float*>(rewards),
      static_cast<const uint8_t*>(dones), reward_clip);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !frames) return static_cast<int>(err);
  advance_head_kernel<<<1, 1, 0, s>>>(static_cast<int32_t*>(r_index),
                                      static_cast<uint8_t*>(r_full), C);
  return static_cast<int>(cudaGetLastError());
}
