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
//   K5 reads the priorities once (4 MB): 1.2 us at 3.35 TB/s, below the
//      floor of its two launches (about 2.5 us each).
//   K6 writes 8192 x 7 frames (405 MB) and reads each distinct frame the
//      round's windows show unblanked once (about 302 MB for 42,742 frames
//      in a random ring), with a few scalars a draw: 0.21 ms. At the
//      data-efficient round (16 x 6,250 columns, 16 batches x 32 draws, n-step
//      20: a window of 24 frames) it writes 512 x 24 frames (86.7 MB) and
//      reads about 29 MB of distinct unblanked frames: 0.035 ms. Bound by
//      bytes; chip_smoke.py counts the frames of each run's own draws.
//   K7 moves about 130 KB at the round (0.04 us): bound by launch latency
//      and one dependent round trip.
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
// omega = 0.5), so the written priorities and the max are the same bits;
// a NaN priority makes the max NaN, as torch.maximum and jnp.maximum do.
//
// Design.
//   K5: two launches, and one where the tree has at most 32 leaves. The
//       tree over the L = 2^D masked leaves is stored only every fifth level:
//       heights 5, 10, 15 and 20 below D (for L = 2^20: 32,768 + 1,024 + 32
//       floats, in a scratch the wrapper keeps per stream), never the leaves.
//       A warp sums 32 values with __shfl_xor_sync at offsets 1, 2, 4, 8 and
//       16: after offset 2^s every lane holds the sum of its aligned block of
//       2^(s+1) lanes, which is exactly the tree's node over them.
//       (1) The build: a thread loads 4 leaves (one float4) and applies the
//       write head's mask in 32-bit arithmetic; 8 lanes sum a height-5
//       node, and a block of
//       256 threads its 1024 leaves' 32 height-5 nodes and one height-10
//       node. The last block to finish (a ticket, after __threadfence) sums
//       heights 15 and 20 from 10 and 15.
//       (2) The descent: one warp per draw. From the root it loads the 2^r
//       nodes of the highest stored level (r = D - 5 * stored, 1 to 5), then
//       from the node it reached the 32 nodes five levels down, down to the
//       32 leaves, read from the priorities through the same mask: one
//       coalesced 128-byte load a step, 4 in place of 20 dependent loads at
//       D = 20. Each step rebuilds the four levels in between by the same
//       shuffles and descends them with broadcasts of the left sums. The
//       first step's sum is the total.
//   K6: one launch of two kinds of block, 8 warps each. (1) Blocks 0 ..
//       nb-1, one a batch, a warp a row: lane t loads the timestep of the
//       window's frame t (and t + 32), a ballot gives the row's episode
//       starts and so its blanking mask; the lanes load the n rewards at
//       once and every lane sums the n-step return in the order s = 0 ..
//       n-1 from shuffles, with the fmaf and powf a loop in one thread
//       would use; lane 0 writes the row's scalar fields and unnormalised
//       IS weight; the block reduces the batch max in shared memory and
//       normalises. (2) The other blocks copy: one warp a frame of the
//       window derives its row's window column and blanking mask itself
//       (a load of idx, one of timesteps a lane, a ballot), so the copy
//       waits for no field block, and copies 7056 bytes as 441 16-byte
//       vectors, 4 loads a lane in flight before their stores, or writes
//       zeros where the frame is blanked. The frame copy is split by frame,
//       not by batch: a block per batch would leave 32 blocks on 132 SMs
//       for the throughput preset (32 batches of 256). Draw j goes to
//       batch j % nb, row j / nb (prioritized.py:270-273).
//   K7: a grid over the draws, one thread a draw, WRITE_THREADS a block.
//       Thread q takes element q of the (nb, bs) batch-order inputs, so a
//       warp's loads of idxs and losses are contiguous, and derives its
//       draw j = r * nb + k from q = k * bs + r. Stratified draws are
//       nondecreasing in draw order, so a leaf drawn more than once is
//       drawn by a run of consecutive draws: only the last draw of each
//       run writes (the next draw's leaf, read from global memory, differs),
//       so the winner is deterministic, also where a run straddles two
//       blocks. The max is order-free and exact: each priority's bits as an
//       int32 (max_word: on values >= +0 int order is float order, a NaN
//       becomes 0x7fc00000, above +inf, and -0.0 a negative int), a warp
//       and a block reduction of int max, then one atomicMax a block into
//       max_priority's word, in the same launch; max_priority's old value
//       is read with the draws' loads, so the atomic, which returns
//       nothing, is the block's last step.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BUILD_THREADS = 256;   // 4 leaves a thread: 1024 a block
constexpr int DESCEND_WARPS = 8;     // draws a block of the descent
constexpr int MAX_DEPTH = 22;        // L <= 2^22 (replay.py::MAX_LEAVES)
constexpr int MAX_STORED = 4;        // heights 5, 10, 15, 20
constexpr int TOP_NODES = 16;        // height-15 nodes a warp of the build's
                                     // last block sums: 8 x 16 = 2^22 >> 15
constexpr unsigned FULL = 0xffffffffu;
constexpr int GATHER_WARPS = 8;     // K6: warps a block, of either kind
constexpr int COPY_UNROLL = 4;      // K6: 16-byte loads a lane in flight
constexpr int WRITE_THREADS = 256;  // K7: one draw a thread
constexpr int NAN_WORD = 0x7fc00000;  // the positive quiet NaN

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

// The stored levels of a tree over L = 2^D leaves: heights 5, 10, ... below
// D, level k (height 5k) at off[k - 1] in the scratch. The wrapper's plan
// (kernels/replay.py::tree_plan) gives D, stored and off.
struct Tree {
  int L, D, stored;
  int off[MAX_STORED];
};

// Whether ring position pos is sampleable: its (-history+1 .. +n_step)
// window does not cross the write head (prioritized.py::_valid_time_mask),
// in 32-bit arithmetic (pos and head lie in [0, C)).
__device__ __forceinline__ bool valid_pos(int pos, int head, int C,
                                          int history, int n_step) {
  int ahead = head - pos;
  if (ahead < 0) ahead += C;
  int behind = pos - head;
  if (behind < 0) behind += C;
  return ahead > n_step && behind >= history;
}

// Leaf i of the masked priorities: 0 past the n stored leaves and where
// the position is not sampleable.
__device__ __forceinline__ float masked_leaf(const float* __restrict__ prio,
                                             int i, int n, int C, int head,
                                             int history, int n_step) {
  if (i >= n) return 0.f;
  return valid_pos(i % C, head, C, history, n_step) ? prio[i] : 0.f;
}

// The 32 lanes' values summed in the tree's pairing: lv[s] is the sum of the
// lane's aligned block of 2^s lanes, lv[5] the warp's total.
__device__ __forceinline__ void warp_levels(float v, float (&lv)[6]) {
  lv[0] = v;
#pragma unroll
  for (int s = 0; s < 5; ++s)
    lv[s + 1] = __fadd_rn(lv[s], __shfl_xor_sync(FULL, lv[s], 1 << s));
}

__device__ __forceinline__ float warp_sum(float v) {
  float lv[6];
  warp_levels(v, lv);
  return lv[5];
}

__global__ void __launch_bounds__(BUILD_THREADS) tree_build_kernel(
    const float* __restrict__ prio, const int32_t* __restrict__ index, int C,
    int n, int history, int n_step, Tree tr, float* __restrict__ levels,
    unsigned* ticket) {
  constexpr int WARPS = BUILD_THREADS / 32;
  __shared__ float s_nodes[32];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int head = *index;
  const int t = blockIdx.x * BUILD_THREADS + threadIdx.x;
  const int i0 = 4 * t;  // this thread's four leaves: a node of height 2
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  if (i0 < n) {
    if (i0 + 3 < n) {  // the wrapper checks prio is 16-byte aligned
      const float4 v = reinterpret_cast<const float4*>(prio)[t];
      l[0] = v.x;
      l[1] = v.y;
      l[2] = v.z;
      l[3] = v.w;
    } else {
      for (int k = 0; k < 4 && i0 + k < n; ++k) l[k] = prio[i0 + k];
    }
    int pos = i0 % C;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!valid_pos(pos, head, C, history, n_step)) l[k] = 0.f;
      if (++pos == C) pos = 0;
    }
  }
  float h5 = __fadd_rn(__fadd_rn(l[0], l[1]), __fadd_rn(l[2], l[3]));
#pragma unroll
  for (int s = 1; s < 8; s <<= 1)  // heights 3, 4, 5 over 8 lanes
    h5 = __fadd_rn(h5, __shfl_xor_sync(FULL, h5, s));
  const int node = t >> 3;
  if ((lane & 7) == 0 && node < (tr.L >> 5)) levels[tr.off[0] + node] = h5;
  if (tr.stored < 2) return;
  // L >= 2^11: every block holds 1024 leaves, and its height-10 node.
  if ((lane & 7) == 0) s_nodes[threadIdx.x >> 3] = h5;
  __syncthreads();
  if (warp == 0) {
    const float h10 = warp_sum(s_nodes[lane]);
    if (lane == 0) levels[tr.off[1] + blockIdx.x] = h10;
  }
  if (tr.stored < 3) return;
  if (threadIdx.x == 0) {
    __threadfence();  // this block's height-10 node before its ticket
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // The last block: heights 15 and 20, each node from 32 nodes of the level
  // below (read past L1, which may not hold the other blocks' writes). A
  // warp loads all of its nodes' children before it sums any: one round
  // trip a level, not one a node.
  for (int k = 2; k < tr.stored; ++k) {
    const int count = tr.L >> (5 * (k + 1));  // at most WARPS * TOP_NODES
    const float* src = levels + tr.off[k - 1];
    float v[TOP_NODES];
#pragma unroll
    for (int r = 0; r < TOP_NODES; ++r) {
      const int nd = warp + r * WARPS;
      v[r] = nd < count ? __ldcg(src + nd * 32 + lane) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < TOP_NODES; ++r) {
      const int nd = warp + r * WARPS;
      if (nd >= count) break;  // nd grows with r: the whole warp leaves
      const float sum = warp_sum(v[r]);
      if (lane == 0) levels[tr.off[k] + nd] = sum;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

__global__ void __launch_bounds__(DESCEND_WARPS * 32) descend_kernel(
    const float* __restrict__ prio, const int32_t* __restrict__ index, int C,
    int n, int history, int n_step, Tree tr,
    const float* __restrict__ levels, const float* __restrict__ u, int B,
    int64_t* __restrict__ idx_out, float* __restrict__ p_out,
    float* __restrict__ total_out) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * DESCEND_WARPS + (threadIdx.x >> 5);
  if (j >= B) return;  // the whole warp: j is the warp's draw
  const int head = *index;
  float v = 0.f, total = 0.f, leaf_p = 0.f;
  int node = 0;  // the node reached, numbered within its height
  for (int s = tr.stored; s >= 0; --s) {  // its children at height 5s
    const int k = s == tr.stored ? tr.D - 5 * tr.stored : 5;
    const int width = 1 << k;
    const int child = node * width + lane;
    float x = 0.f;
    if (lane < width)
      x = s > 0 ? levels[tr.off[s - 1] + child]
                : masked_leaf(prio, child, n, C, head, history, n_step);
    float lv[6];
    warp_levels(x, lv);
    if (s == tr.stored) {
      float sum = lv[0];
#pragma unroll
      for (int t = 1; t <= 5; ++t)
        if (t == k) sum = lv[t];
      total = __shfl_sync(FULL, sum, 0);
      const float seg = __fdiv_rn(total, static_cast<float>(B));
      v = __fmul_rn(__fadd_rn(static_cast<float>(j), u[j]), seg);
    }
    int base = 0;
#pragma unroll
    for (int t = 4; t >= 0; --t) {
      if (t < k) {
        const float left = __shfl_sync(FULL, lv[t], base);
        if (v > left) {
          base += 1 << t;
          v = __fsub_rn(v, left);
        }
      }
    }
    node = node * width + base;
    if (s == 0) leaf_p = __shfl_sync(FULL, lv[0], base);
  }
  if (lane != 0) return;
  if (node > n - 1) {  // the total's overshoot lands in the padding
    node = n - 1;
    leaf_p = masked_leaf(prio, node, n, C, head, history, n_step);
  }
  idx_out[j] = node;
  p_out[j] = leaf_p;
  if (j == 0) *total_out = total;
}

// ---------------------------------------------------------------- K6 -----

// The episode-blanking mask of a row's window (prioritized.py::_blank_masks)
// from its `timesteps == 0` bits: frames before an episode start, then
// frames after a terminal. Warp-uniform.
__device__ __forceinline__ uint64_t blank_mask(uint64_t firsts, int history,
                                               int w) {
  uint64_t blank = 0;
  for (int t = history - 2; t >= 0; --t)
    if (((blank | firsts) >> (t + 1)) & 1ull) blank |= 1ull << t;
  for (int t = history; t < w; ++t)
    if (((blank >> (t - 1)) | (firsts >> t)) & 1ull) blank |= 1ull << t;
  return blank;
}

// The blanking mask of the window of ring position i in the row at `row`,
// by the whole warp: lane t loads the timestep of frame t (and t + 32), a
// ballot gathers `timesteps == 0`.
__device__ __forceinline__ uint64_t window_blank(
    const int32_t* __restrict__ timesteps, size_t row, int i, int C,
    int history, int w, int lane) {
  uint64_t firsts = 0;
  for (int half = 0; half < w; half += 32) {
    const int t = half + lane;
    bool first = false;
    if (t < w) {
      const int col = wrap(static_cast<long long>(i) + t - history + 1, C);
      first = timesteps[row + col] == 0;
    }
    firsts |= static_cast<uint64_t>(__ballot_sync(FULL, first)) << half;
  }
  return blank_mask(firsts, history, w);
}

// Block k < nb of the launch: batch k's scalar fields, one warp a row (rows
// warp, warp + GATHER_WARPS, ...). The n-step return is summed by every
// lane in the order s = 0 .. n-1 from shuffles of the lanes' rewards and
// discount powers, with the same fmaf and powf as a loop over s in one
// thread; the batch max of the IS weights goes through shared memory, then
// the block normalises its rows.
__device__ void gather_fields(
    const int64_t* __restrict__ idx, const float* __restrict__ p,
    const float* __restrict__ total_ptr, const int32_t* __restrict__ actions,
    const float* __restrict__ rewards, const int32_t* __restrict__ timesteps,
    const uint8_t* __restrict__ nonterminal, const int32_t* __restrict__ index,
    const uint8_t* __restrict__ full, int E, int C, int history, int n_step,
    float discount, float beta, int nb, int bs, int k,
    int64_t* __restrict__ o_idx, int32_t* __restrict__ o_actions,
    float* __restrict__ o_returns, float* __restrict__ o_nonterminals,
    float* __restrict__ o_weights, float* __restrict__ o_wmax) {
  __shared__ float s_max[GATHER_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = history + n_step;
  const float total = *total_ptr;
  const long long stored =
      static_cast<long long>(*full ? C : *index) * static_cast<long long>(E);
  const float stored_f = static_cast<float>(stored);
  float local_max = 0.f;
  for (int r = warp; r < bs; r += GATHER_WARPS) {
    const int j = r * nb + k;  // draw j -> batch j % nb, row j / nb
    const long long q = static_cast<long long>(k) * bs + r;
    const long long flat = idx[j];
    const float pj = p[j];
    const int e = static_cast<int>(flat / C);
    const int i = static_cast<int>(flat % C);
    const size_t row = static_cast<size_t>(e) * C;
    const int col_last = wrap(static_cast<long long>(i) + n_step, C);
    int32_t action = 0;
    uint8_t nt_stored = 0;
    if (lane == 0) {
      action = actions[row + i];
      nt_stored = nonterminal[row + col_last];
    }
    const uint64_t blank = window_blank(timesteps, row, i, C, history, w,
                                        lane);
    float ret = 0.f;
    for (int half = 0; half < n_step; half += 32) {
      const int s_lane = half + lane;
      float rw = 0.f, pw = 0.f;
      if (s_lane < n_step) {
        rw = rewards[row + wrap(static_cast<long long>(i) + s_lane, C)];
        pw = powf(discount, static_cast<float>(s_lane));
      }
      const int steps = min(32, n_step - half);
      for (int s = 0; s < steps; ++s) {
        const float r_s = __shfl_sync(FULL, rw, s);
        const float p_s = __shfl_sync(FULL, pw, s);
        if (!((blank >> (history - 1 + half + s)) & 1ull))
          ret = fmaf(p_s, r_s, ret);
      }
    }
    if (lane == 0) {
      const bool nt = nt_stored != 0 && !((blank >> (w - 1)) & 1ull);
      const float probs = __fdiv_rn(pj, fmaxf(total, 1e-12f));
      float wt = pow_scalar(__fmul_rn(stored_f, probs), -beta);
      if (!(pj > 0.f && total > 0.f)) wt = 0.f;
      o_idx[q] = flat;
      o_actions[q] = action;
      o_returns[q] = ret;
      o_nonterminals[q] = nt ? 1.f : 0.f;
      o_weights[q] = wt;
      local_max = fmaxf(local_max, wt);
    }
  }
  if (lane == 0) s_max[warp] = local_max;
  __syncthreads();  // also makes the rows' o_weights visible to the block
  float m = s_max[0];
#pragma unroll
  for (int v = 1; v < GATHER_WARPS; ++v) m = fmaxf(m, s_max[v]);
  const float wmax = fmaxf(m, 1e-12f);
  for (int r = threadIdx.x; r < bs; r += blockDim.x) {
    const long long q = static_cast<long long>(k) * bs + r;
    o_weights[q] = __fdiv_rn(o_weights[q], wmax);
  }
  if (threadIdx.x == 0) o_wmax[k] = wmax;
}

// Warp f of the copy blocks: frame t = f % w of output row q = f / w. It
// finds the row's draw, window column and blanking bit itself (one load of
// idx, one of the window's timesteps a lane and a ballot), so it needs
// nothing from the field blocks, then copies the frame's P bytes or writes
// zeros where it is blanked: 16-byte vectors, COPY_UNROLL loads a lane in
// flight before their stores.
__device__ void gather_frame(const uint8_t* __restrict__ frames,
                             const int64_t* __restrict__ idx,
                             const int32_t* __restrict__ timesteps, int C,
                             int P, int history, int w, int nb, int bs,
                             long long f, bool vec,
                             uint8_t* __restrict__ window) {
  const int lane = threadIdx.x & 31;
  const long long q = f / w;
  const int t = static_cast<int>(f % w);
  const int k = static_cast<int>(q / bs);
  const int r = static_cast<int>(q % bs);
  const long long flat = idx[static_cast<long long>(r) * nb + k];
  const int e = static_cast<int>(flat / C);
  const int i = static_cast<int>(flat % C);
  const size_t row = static_cast<size_t>(e) * C;
  const bool blanked =
      (window_blank(timesteps, row, i, C, history, w, lane) >> t) & 1ull;
  const int col = wrap(static_cast<long long>(i) + t - history + 1, C);
  const uint8_t* src = frames + (row + col) * static_cast<size_t>(P);
  uint8_t* dst = window + f * static_cast<long long>(P);
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const int n16 = P / 16;
    for (int base = 0; base < n16; base += 32 * COPY_UNROLL) {
      uint4 v[COPY_UNROLL];
#pragma unroll
      for (int u = 0; u < COPY_UNROLL; ++u) {
        const int x = base + u * 32 + lane;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (!blanked && x < n16) v[u] = s4[x];
      }
#pragma unroll
      for (int u = 0; u < COPY_UNROLL; ++u) {
        const int x = base + u * 32 + lane;
        if (x < n16) d4[x] = v[u];
      }
    }
  } else {
    for (int b = lane; b < P; b += 32) dst[b] = blanked ? 0 : src[b];
  }
}

// One launch: field blocks 0 .. nb-1 first, then copy blocks of GATHER_WARPS
// frame warps each.
__global__ void __launch_bounds__(GATHER_WARPS * 32) gather_window_kernel(
    const uint8_t* __restrict__ frames, const int64_t* __restrict__ idx,
    const float* __restrict__ p, const float* __restrict__ total_ptr,
    const int32_t* __restrict__ actions, const float* __restrict__ rewards,
    const int32_t* __restrict__ timesteps,
    const uint8_t* __restrict__ nonterminal, const int32_t* __restrict__ index,
    const uint8_t* __restrict__ full, int E, int C, int P, int history,
    int n_step, float discount, float beta, int nb, int bs, long long frames_n,
    int vec, int64_t* __restrict__ o_idx, int32_t* __restrict__ o_actions,
    float* __restrict__ o_returns, float* __restrict__ o_nonterminals,
    float* __restrict__ o_weights, float* __restrict__ o_wmax,
    uint8_t* __restrict__ window) {
  if (static_cast<int>(blockIdx.x) < nb) {
    gather_fields(idx, p, total_ptr, actions, rewards, timesteps, nonterminal,
                  index, full, E, C, history, n_step, discount, beta, nb, bs,
                  blockIdx.x, o_idx, o_actions, o_returns, o_nonterminals,
                  o_weights, o_wmax);
    return;
  }
  const long long f =
      static_cast<long long>(blockIdx.x - nb) * GATHER_WARPS +
      (threadIdx.x >> 5);
  if (f >= frames_n) return;  // the whole warp
  gather_frame(frames, idx, timesteps, C, P, history, history + n_step, nb,
               bs, f, vec != 0, window);
}

// ---------------------------------------------------------------- K7 -----

// A priority's word for the max: its bits as an int32, any NaN as NAN_WORD.
__device__ __forceinline__ int max_word(float x) {
  return isnan(x) ? NAN_WORD : __float_as_int(x);
}

__global__ void __launch_bounds__(WRITE_THREADS) write_priorities_kernel(
    const int64_t* __restrict__ idxs, const float* __restrict__ losses, int nb,
    int bs, float omega, float* __restrict__ prio, float* max_priority) {
  __shared__ int s_max[WRITE_THREADS / 32];
  int* const target = reinterpret_cast<int*>(max_priority);
  // The old max, read with the draws' loads: no round trip of its own.
  const int old = threadIdx.x == 0 ? *reinterpret_cast<volatile int*>(target)
                                   : 0;
  const int B = nb * bs;  // the entry checks it fits
  const int q = blockIdx.x * WRITE_THREADS + threadIdx.x;
  int word = INT_MIN;  // below every priority's word
  if (q < B) {
    const int j = (q % bs) * nb + q / bs;  // element [q / bs, q % bs]
    const int jn = j + 1;
    const int64_t leaf = idxs[q];
    const int64_t next = jn < B ? idxs[(jn % nb) * bs + jn / nb] : -1;
    const float p = pow_scalar(losses[q], omega);
    word = max_word(p);
    if (next != leaf) prio[leaf] = p;  // else a later draw of the run writes
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    word = max(word, __shfl_xor_sync(FULL, word, o));
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = word;
  __syncthreads();
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int w = 1; w < WRITE_THREADS / 32; ++w) word = max(word, s_max[w]);
  // An old NaN of either sign stays NaN: a negative one is a negative int
  // that atomicMax would drop, so a block that reads one raises its word to
  // NAN_WORD. Until the first atomic lands every block reads the old value,
  // so the block that lands it writes NAN_WORD, which none can lower.
  if (isnan(__int_as_float(old))) word = NAN_WORD;
  atomicMax(target, word);
}

}  // namespace

// K5. priorities (E*C,) float32, 16-byte aligned, index int32 0-d, u (B,)
// float32 in [0, 1). The plan (kernels/replay.py::tree_plan): D = log2 of
// the least power of two L >= E*C, at most 22; stored = the count of stored
// heights (5, 10, ... below D); off[k] the offset of height 5(k + 1) in
// levels, a float32 scratch of sum over those heights h of L >> h. The plan
// is checked, not recomputed: a plan that disagrees with E*C is refused.
// ticket an int32 0 between launches; outputs idx (B,) int64, p (B,)
// float32, total 0-d float32. Returns a CUDA error code.
extern "C" int stratified_sample(const void* priorities, const void* index,
                                 int E, int C, int history, int n_step,
                                 const void* u, int B, int D, int stored,
                                 const int* off, void* levels, void* ticket,
                                 void* idx, void* p, void* total,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = E * C;
  if (B < 1 || n < 1 || D < 0 || D > MAX_DEPTH ||
      (1 << D) < n || (D > 0 && (1 << (D - 1)) >= n) ||
      stored != (D > 0 ? (D - 1) / 5 : 0) ||
      reinterpret_cast<uintptr_t>(priorities) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Tree tr{};
  tr.L = 1 << D;
  tr.D = D;
  tr.stored = stored;
  for (int k = 0, expect = 0; k < stored; ++k) {
    if (off[k] != expect) return static_cast<int>(cudaErrorInvalidValue);
    tr.off[k] = off[k];
    expect += tr.L >> (5 * (k + 1));
  }
  const float* pr = static_cast<const float*>(priorities);
  const int32_t* head = static_cast<const int32_t*>(index);
  float* lv = static_cast<float*>(levels);
  if (tr.stored > 0) {
    const int leaves_a_block = 4 * BUILD_THREADS;
    const int blocks = tr.L > leaves_a_block ? tr.L / leaves_a_block : 1;
    tree_build_kernel<<<blocks, BUILD_THREADS, 0, s>>>(
        pr, head, C, n, history, n_step, tr, lv,
        static_cast<unsigned*>(ticket));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  descend_kernel<<<(B + DESCEND_WARPS - 1) / DESCEND_WARPS,
                   DESCEND_WARPS * 32, 0, s>>>(
      pr, head, C, n, history, n_step, tr, lv, static_cast<const float*>(u),
      B, static_cast<int64_t*>(idx), static_cast<float*>(p),
      static_cast<float*>(total));
  return static_cast<int>(cudaGetLastError());
}

// K6. The ring's fields (E, C[, P]) and the draws (idx, p in draw order,
// total); outputs in (nb, bs) order: o_idx int64, o_actions int32, o_returns,
// o_nonterminals, o_weights (normalised per batch) float32, o_wmax (nb,)
// float32, window (nb, bs, w, P) uint8. history + n_step <= 64. blocks is
// the wrapper's plan (kernels/replay.py::gather_plan): nb field blocks and
// one copy warp a window frame, GATHER_WARPS a block; a plan that does not
// match is refused. Returns a CUDA error code.
extern "C" int gather_window(
    const void* frames, const void* actions, const void* rewards,
    const void* timesteps, const void* nonterminal, const void* index,
    const void* full, int E, int C, int P, const void* idx, const void* p,
    const void* total, int history, int n_step, float discount, float beta,
    int nb, int bs, int blocks, void* o_idx, void* o_actions, void* o_returns,
    void* o_nonterminals, void* o_weights, void* o_wmax, void* window,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = history + n_step;
  if (w > 64 || nb < 1 || bs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long frames_n = static_cast<long long>(nb) * bs * w;
  if (blocks != nb + (frames_n + GATHER_WARPS - 1) / GATHER_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (P % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(frames) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(window) % 16 == 0)
                      ? 1
                      : 0;
  gather_window_kernel<<<blocks, GATHER_WARPS * 32, 0, s>>>(
      static_cast<const uint8_t*>(frames), static_cast<const int64_t*>(idx),
      static_cast<const float*>(p), static_cast<const float*>(total),
      static_cast<const int32_t*>(actions), static_cast<const float*>(rewards),
      static_cast<const int32_t*>(timesteps),
      static_cast<const uint8_t*>(nonterminal),
      static_cast<const int32_t*>(index), static_cast<const uint8_t*>(full), E,
      C, P, history, n_step, discount, beta, nb, bs, frames_n, vec,
      static_cast<int64_t*>(o_idx), static_cast<int32_t*>(o_actions),
      static_cast<float*>(o_returns), static_cast<float*>(o_nonterminals),
      static_cast<float*>(o_weights), static_cast<float*>(o_wmax),
      static_cast<uint8_t*>(window));
  return static_cast<int>(cudaGetLastError());
}

// K7. idxs and losses (nb, bs) in batch order (element [k, r] is draw
// r * nb + k); priorities (E*C,) and max_priority 0-d float32, in place.
// blocks is the wrapper's plan (kernels/replay.py::write_blocks): one
// thread a draw, WRITE_THREADS a block; a plan that does not cover the
// nb * bs draws exactly is refused. Returns a CUDA error code.
extern "C" int write_priorities(const void* idxs, const void* losses, int nb,
                                int bs, float omega, int blocks,
                                void* priorities, void* max_priority,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long b = static_cast<long long>(nb) * bs;
  if (nb < 1 || bs < 1 || b > INT_MAX ||
      blocks != (b + WRITE_THREADS - 1) / WRITE_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  write_priorities_kernel<<<blocks, WRITE_THREADS, 0, s>>>(
      static_cast<const int64_t*>(idxs), static_cast<const float*>(losses), nb,
      bs, omega, static_cast<float*>(priorities),
      static_cast<float*>(max_priority));
  return static_cast<int>(cudaGetLastError());
}
