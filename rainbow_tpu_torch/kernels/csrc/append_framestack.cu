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
// At the evaluator's N = 10 it moves 0.7 MB and is bound by one launch.
//
// Design: one launch per append, and every access coalesced.
//   - With H = 4 and P % 4 == 0 (the vector path) a pixel's whole history
//     is one 32-bit word, and each reset kind is a shift-and-insert on that
//     word (byte h of the word is stack[..., h]):
//       kind 0: (w >> 8)  | obs << 24
//       kind 1: (w >> 16) | obs << 16 | reset << 24
//       kind 2:  reset << 24
//     The newest byte (w >> 24) goes to the replay before the word is
//     rewritten.
//   - The grid is flat over the N * P / 4 quads (4 pixels: 16 bytes of the
//     stack, 4 of obs, of a reset row and of the ring column); a quad lies in
//     one env since P % 4 == 0. Each thread takes 4 quads, lane-interleaved,
//     so each warp-wide access is contiguous: 512 bytes of the stack, 128 of
//     the others, in and out. A thread issues its stack and obs loads before
//     it looks up reset rows. At N = 10 the 17,640 quads make 35 blocks of
//     128, at N = 1024 3,528.
//   - The reset row of env e is found by binary search: reset_idx must be
//     sorted ascending, its entries below N distinct, padded with N
//     (train.py::pack_resets gives flatnonzero(kinds) padded with N, and
//     actor_step passes arange(N)). Kind-0 envs need no reset row and skip
//     the search.
//   - Env e's scalar fields (action, clipped reward, timestep, nonterminal,
//     priority, t) are written by the thread of its first quad.
//   - Thread 0 of every block reads the pre-append `index`, then (after a
//     fence) takes a ticket: an atomicAdd on an int32 the wrapper keeps per
//     stream. The block that takes the last one advances index and full at
//     its end and sets the ticket back to 0 for the next launch: every block
//     has read the head by then. Appends on one stream run one at a time,
//     and appends on two streams hold two tickets. The frame-stack-only
//     mode does not touch the ticket.
//   - Any other H or P takes a byte loop, one thread per 16 pixels of an env.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int QUADS = 4;   // 4-pixel quads a thread on the vector path
constexpr int CHUNK = 16;  // pixels a thread on the byte path

// The row of env e in reset_idx (sorted ascending, distinct below N), or
// -1.
__device__ __forceinline__ int reset_row(const int32_t* __restrict__ idx,
                                         int K, int e) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (idx[mid] < e) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < K && idx[lo] == e ? lo : -1;
}

__device__ __forceinline__ uint32_t advance(uint32_t w, uint32_t o,
                                            uint32_t r, int kind) {
  return kind == 0   ? (w >> 8) | (o << 24)
         : kind == 1 ? (w >> 16) | (o << 16) | (r << 24)
                     : (r << 24);
}

struct Ring {  // the replay's fields; frames == nullptr: no replay
  uint8_t* frames;
  int32_t* actions;
  float* rewards;
  int32_t* timesteps;
  uint8_t* nonterminal;
  float* priorities;
  int32_t* index;
  uint8_t* full;
  int32_t* t;
  const float* max_priority;
  int C;
  const int64_t* in_actions;
  const float* in_rewards;
  const uint8_t* in_dones;
  float reward_clip;
};

// Env e's transition into column col of its ring, and its episode step.
__device__ __forceinline__ void append_fields(const Ring& r, int e, int col) {
  float rw = r.in_rewards[e];
  if (r.reward_clip > 0.f)
    rw = fminf(fmaxf(rw, -r.reward_clip), r.reward_clip);
  const bool done = r.in_dones[e] != 0;
  const size_t c = static_cast<size_t>(e) * r.C + col;
  r.actions[c] = static_cast<int32_t>(r.in_actions[e]);
  r.rewards[c] = rw;
  r.timesteps[c] = r.t[e];
  r.nonterminal[c] = done ? 0 : 1;
  r.priorities[c] = *r.max_priority;
  r.t[e] = done ? 0 : r.t[e] + 1;
}

__global__ void __launch_bounds__(THREADS) append_framestack_kernel(
    uint8_t* __restrict__ stack, const uint8_t* __restrict__ obs,
    const uint8_t* __restrict__ reset_packed,
    const int32_t* __restrict__ reset_idx, int K,
    const uint8_t* __restrict__ kinds, int N, int P, int H, int vec,
    Ring ring, unsigned* ticket) {
  __shared__ int s_col;
  unsigned my_ticket = 0;
  if (threadIdx.x == 0) {
    s_col = 0;
    if (ring.frames) {
      s_col = *ring.index;
      __threadfence();  // the head is read before this block's ticket
      my_ticket = atomicAdd(ticket, 1u);
    }
  }
  __syncthreads();
  const int col = s_col;

  if (vec) {
    const unsigned Q = static_cast<unsigned>(P) / 4;  // quads an env
    const unsigned total = static_cast<unsigned>(N) * Q;
    const unsigned lane = threadIdx.x & 31;
    const unsigned base =
        (blockIdx.x * THREADS + (threadIdx.x & ~31u)) * QUADS + lane;
    uint4* st = reinterpret_cast<uint4*>(stack);
    const uint32_t* ob = reinterpret_cast<const uint32_t*>(obs);
    const uint32_t* rs = reinterpret_cast<const uint32_t*>(reset_packed);
    uint32_t* fr = reinterpret_cast<uint32_t*>(ring.frames);
    uint4 w4[QUADS];
    uint32_t o4[QUADS];
#pragma unroll
    for (int i = 0; i < QUADS; ++i) {
      const unsigned q = base + 32u * i;
      if (q < total) {
        w4[i] = st[q];
        o4[i] = ob[q];
      }
    }
    int last_e = -1, row = -1, kind = 0;
#pragma unroll
    for (int i = 0; i < QUADS; ++i) {
      const unsigned q = base + 32u * i;
      if (q >= total) break;
      const int e = static_cast<int>(q / Q);
      const unsigned pq = q - static_cast<unsigned>(e) * Q;
      if (e != last_e) {
        last_e = e;
        kind = kinds[e];
        row = kind != 0 ? reset_row(reset_idx, K, e) : -1;
      }
      const uint32_t r4 =
          row >= 0 ? rs[static_cast<size_t>(row) * Q + pq] : 0u;
      uint32_t w[4] = {w4[i].x, w4[i].y, w4[i].z, w4[i].w};
      uint32_t newest = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        newest |= (w[b] >> 24) << (8 * b);
        w[b] = advance(w[b], (o4[i] >> (8 * b)) & 0xffu,
                       (r4 >> (8 * b)) & 0xffu, kind);
      }
      st[q] = make_uint4(w[0], w[1], w[2], w[3]);
      if (fr) {
        fr[(static_cast<size_t>(e) * ring.C + col) * Q + pq] = newest;
        if (pq == 0) append_fields(ring, e, col);
      }
    }
  } else {
    const int chunks = (P + CHUNK - 1) / CHUNK;
    const long long g = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
    if (g < static_cast<long long>(N) * chunks) {
      const int e = static_cast<int>(g / chunks);
      const int q = static_cast<int>(g - static_cast<long long>(e) * chunks);
      const int kind = kinds[e];
      const int row = kind != 0 ? reset_row(reset_idx, K, e) : -1;
      const size_t p0 = static_cast<size_t>(q) * CHUNK;
      const int end = P - static_cast<int>(p0) < CHUNK
                          ? P - static_cast<int>(p0)
                          : CHUNK;
      const uint8_t* ob = obs + static_cast<size_t>(e) * P + p0;
      const uint8_t* rs = row >= 0
                              ? reset_packed + static_cast<size_t>(row) * P + p0
                              : nullptr;
      uint8_t* fr =
          ring.frames
              ? ring.frames + (static_cast<size_t>(e) * ring.C + col) * P + p0
              : nullptr;
      uint8_t* st = stack + (static_cast<size_t>(e) * P + p0) * H;
      for (int k = 0; k < end; ++k) {
        uint8_t* s = st + static_cast<size_t>(k) * H;
        const uint8_t ov = ob[k];
        const uint8_t rv = rs ? rs[k] : 0;
        if (fr) fr[k] = s[H - 1];
        if (kind == 0) {
          for (int h = 0; h < H - 1; ++h) s[h] = s[h + 1];
          s[H - 1] = ov;
        } else if (kind == 1) {
          for (int h = 0; h < H - 2; ++h) s[h] = s[h + 2];
          s[H - 2] = ov;
          s[H - 1] = rv;
        } else {
          for (int h = 0; h < H - 1; ++h) s[h] = 0;
          s[H - 1] = rv;
        }
      }
      if (fr && q == 0) append_fields(ring, e, col);
    }
  }

  // The block with the last ticket advances the write head: every block
  // has read it before taking a ticket.
  if (threadIdx.x == 0 && ring.frames && my_ticket == gridDim.x - 1) {
    const int next = (col + 1) % ring.C;
    *ring.index = next;
    if (next == 0) *ring.full = 1;
    *ticket = 0u;
  }
}

}  // namespace

// Pointers of the replay (frames .. r_max_priority), of the transition
// (actions, rewards, dones) and the ticket are null for the
// frame-stack-only mode. The plan (kernels/append_framestack.py::
// launch_plan): vec selects the vector path (H = 4, P % 4 == 0, a 16-byte
// aligned stack, 4-byte aligned obs, reset rows and frames: the wrapper
// checks), blocks is the grid. The plan is checked, not recomputed: one
// that does not cover the items exactly is refused. One launch; returns
// cudaGetLastError() after it.
extern "C" int append_framestack(
    void* stack, const void* obs, const void* reset_packed,
    const void* reset_idx, int K, const void* kinds, int N, int P, int H,
    int vec, int blocks, void* frames, void* r_actions, void* r_rewards,
    void* r_timesteps, void* r_nonterminal, void* r_priorities,
    void* r_index, void* r_full, void* r_t, const void* r_max_priority,
    int C, const void* actions, const void* rewards, const void* dones,
    float reward_clip, void* ticket, void* stream) {
  if (N < 1 || P < 1 || (vec && (H != 4 || P % 4 != 0)) ||
      (frames && (C < 1 || !ticket)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items =
      vec ? static_cast<long long>(N) * (P / 4)
          : static_cast<long long>(N) * ((P + CHUNK - 1) / CHUNK);
  const long long per_block = vec ? THREADS * QUADS : THREADS;
  if (items >= (1ll << 31) || blocks < 1 ||
      static_cast<long long>(blocks) * per_block < items ||
      static_cast<long long>(blocks - 1) * per_block >= items)
    return static_cast<int>(cudaErrorInvalidValue);
  Ring ring{static_cast<uint8_t*>(frames),
            static_cast<int32_t*>(r_actions),
            static_cast<float*>(r_rewards),
            static_cast<int32_t*>(r_timesteps),
            static_cast<uint8_t*>(r_nonterminal),
            static_cast<float*>(r_priorities),
            static_cast<int32_t*>(r_index),
            static_cast<uint8_t*>(r_full),
            static_cast<int32_t*>(r_t),
            static_cast<const float*>(r_max_priority),
            C,
            static_cast<const int64_t*>(actions),
            static_cast<const float*>(rewards),
            static_cast<const uint8_t*>(dones),
            reward_clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  append_framestack_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<uint8_t*>(stack), static_cast<const uint8_t*>(obs),
      static_cast<const uint8_t*>(reset_packed),
      static_cast<const int32_t*>(reset_idx), K,
      static_cast<const uint8_t*>(kinds), N, P, H, vec, ring,
      static_cast<unsigned*>(ticket));
  return static_cast<int>(cudaGetLastError());
}
