// The dueling C51 head's per-row kernels, hand-written for Hopper (sm_90a):
// the epilogue after the last noisy layers (KB), and the learner's C51
// target (K4 c51_target) and loss with its gradient (K4 head_loss).
//
// Both start from the same per-row work, which XLA fuses for the JAX
// package at rainbow_tpu/models/dqn.py:148-154: the dueling combine in the
// streams' dtype T (float32 or bfloat16), then a float32 softmax over the
// atoms. With rne(x) rounding to T (round to nearest even), per atom j:
//
//   mean_j = rne((sum_k a_kj) * (1/A))      (PyTorch's CUDA mean: the fp32
//   q_kj   = rne(rne(v_j + a_kj) - mean_j)   sum times the fp32 1/A)
//   e_kj   = exp(q_kj - max_j q_kj),   s_k = sum_j e_kj
//
// KB (dueling_head) then forms, per action, p_kj = e_kj / s_k and q_k =
// sum_j z_j p_kj (rainbow_tpu/agent.py:99-102, 122-123), the greedy action
// (the first maximum) and its value, and writes, when asked, the
// distribution p or the log-probabilities (q_kj - max) - log s_k. Together
// with the noisy-linear kernel it does the forward work of the deleted
// Pallas kernel rainbow_tpu/ops/pallas_kernels.py::fused_dueling_head.
//
// head_loss takes each row's taken action a_r, the projected target m_r
// and the IS weight w_r (rainbow_tpu/agent.py:126-134, ops/c51.py:57-59):
//
//   log p_rj = (q_rj - max_j q_rj) - log s_r   (at the taken action)
//   loss_r = -sum_j m_rj * log p_rj
//   loss   = (sum_r w_r * loss_r) * (1/B)    (rows summed in row order)
//   g_rj   = (w_r * (1/B)) * (expf(log p_rj) * sum_j m_rj - m_rj)
//   dv_rj  = rne(g_rj),   da_rkj = rne(g_rj * ([k == a_r] - 1/A))
//
// the gradient of the scalar loss into both streams; with the noisy-linear
// backward this is the backward work of fused_dueling_head.
//
// c51_target takes each row's target distribution at the double-Q action
// a*_r (rainbow_tpu/agent.py:198-199) and projects it onto the support
// (rainbow_tpu/ops/c51.py:28-54), in the JAX package's op order and dense
// triangular form:
//
//   Tz_i = R_r + (nt_r * gamma^n) * z_i,  clipped to [V_min, V_max]
//   b_i  = (Tz_i - V_min) / dz            (IEEE division)
//   m_rj = sum_i p_i * clamp(1 - |b_i - j|, 0, 1)
//
// An integer b_i puts all of p_i on atom b_i, with no l == u fix-up. Each
// lane first computes p_i and b_i of its own source atoms; then, over the
// source atoms in order, the owning lane broadcasts (p_i, b_i) with
// __shfl_sync and every lane adds to its target atoms, so each m_rj is
// summed in atom order, with the same bits on every launch and no atomics.
// At the learner's B = 32 (A = 6, 51 atoms) it reads 6.7 KB of the (B, A,
// 51) distribution and writes 6.5 KB: bound by the launch.
//
// Layout: one warp per row, lanes strided over the atoms, each lane holding
// NPL = ceil(atoms / 32) of them in registers (atoms <= MAX_ATOMS = 128);
// reductions over the atoms are xor butterflies (__shfl_xor_sync), which
// leave the same bits in every lane.
//
// Bound on the H100: KB moves 4 (B * atoms * (1 + A) + B * A + B) + 8 B
// bytes (T = float32), plus 4 B A atoms when it writes the distribution,
// against about 10 operations per stream value. At the learner's B = 32 and
// the act's B = 1024 (A = 6, 51 atoms) that is 46 KB and 1.5 MB: bound by
// the launch and one row's chain of dependent steps. The round's target at
// B = 8192 with the probabilities moves 21.7 MB, 6.5 us at 3.35 TB/s:
// bound by bytes. The design shortens the row's chain: the lanes load
// GROUP = 6 actions' values at once (the whole row at A <= 6, read once,
// its mean taken from registers), the six actions go through the max and
// the sums together, exp is the MUFU's __expf and p takes one rounded
// reciprocal per action, and s and sum_j z_j e_j share one butterfly (so q
// is (sum_j z_j e_j) / s). Blocks hold 4 rows. The distribution is written
// by the lanes in atom order (coalesced stores). Each of these was
// slower in probes on the H100, which were not kept: the row copied to
// shared memory with 16-byte loads first (at B = 8192), expf and IEEE
// division (at every B), three actions at a time, blocks of 8 rows.
// __expf's error grows with |x|: at B = 8192 (A = 6 and 18, 51 atoms, fp32
// and bf16 streams) KB's probabilities differ from the plain version's
// (expf, IEEE division) by at most 4.8e-7 on an H100, against the 1e-6
// that chip_smoke.py holds them to.
//
// head_loss at B = 32 moves 46 KB. It keeps expf and logf, as PyTorch
// computes the plain version, so that its gradients round to bf16 as that
// version's do. One launch of a thread-block cluster of up to 8 blocks of
// 4 rows, on as many SMs (rows past the cluster's 32 warps loop), which
// in a probe beat one block of 32 warps on one SM. Each warp writes its
// w * loss into block 0's shared memory over the cluster (distributed
// shared memory), and after the cluster's barrier one thread of block 0
// adds them in row order, so the scalar has the same bits on every launch
// with no atomics and no second launch. A block may touch another's shared
// memory only once every block of the cluster has started: each thread
// arrives at the cluster's barrier on entry and waits on it just before
// its first remote store, so the wait overlaps the first row's work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_ATOMS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr int HEAD_WARPS = 4;    // rows per block of KB
constexpr int LOSS_WARPS = 4;    // rows per block of head_loss
constexpr int LOSS_BLOCKS = 8;   // blocks (SMs) of its cluster, the most
                                 // a portable cluster holds
constexpr int GROUP = 6;         // actions whose reductions overlap in KB
constexpr int TARGET_WARPS = 4;  // rows per block of c51_target

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f(float x) { return x; }
template <> __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a float32 to T and back.
template <typename T> __device__ __forceinline__ float rne(float x) {
  return to_f<T>(from_f<T>(x));
}

template <int G>
__device__ __forceinline__ void warp_max(float (&x)[G]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
      x[g] = fmaxf(x[g], __shfl_xor_sync(FULL, x[g], o));
}

template <int G>
__device__ __forceinline__ void warp_sum(float (&x)[G]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int g = 0; g < G; ++g) x[g] += __shfl_xor_sync(FULL, x[g], o);
}

// The dueling mean of this lane's atoms over the row's A actions, summed in
// action order, and the values of action `take` (unused when out of range).
template <typename T, int NPL>
__device__ __forceinline__ void dueling_mean(const T* a_row, int n_act,
                                             int atoms, int lane, int take,
                                             float (&mean)[NPL],
                                             float (&taken)[NPL]) {
  float sum[NPL];
#pragma unroll
  for (int c = 0; c < NPL; ++c) sum[c] = taken[c] = 0.f;
#pragma unroll 6
  for (int k = 0; k < n_act; ++k) {
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const int j = lane + 32 * c;
      const float x = j < atoms ? to_f<T>(a_row[k * atoms + j]) : 0.f;
      sum[c] += x;
      taken[c] = k == take ? x : taken[c];
    }
  }
  const float inv_a = 1.f / n_act;
#pragma unroll
  for (int c = 0; c < NPL; ++c) mean[c] = rne<T>(sum[c] * inv_a);
}

// The combine and the float32 softmax of G actions at once. In: q holds the
// actions' a values; out: q the combined logits (-inf past the atoms), mx
// their maxima, e = exp(q - mx) (0 past the atoms) and s this lane's part
// of the sums of e, which the caller reduces over the warp (with whatever
// else it sums, so that the butterflies overlap). FAST takes exp from the
// MUFU's __expf (a few ulps) in place of expf.
template <typename T, int NPL, int G, bool FAST>
__device__ __forceinline__ void combine_softmax(const float (&v)[NPL],
                                                const float (&mean)[NPL],
                                                int lane, int atoms,
                                                float (&q)[G][NPL],
                                                float (&mx)[G],
                                                float (&e)[G][NPL],
                                                float (&s)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mx[g] = -INFINITY;
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const bool in = lane + 32 * c < atoms;
      q[g][c] = in ? rne<T>(rne<T>(v[c] + q[g][c]) - mean[c]) : -INFINITY;
      mx[g] = fmaxf(mx[g], q[g][c]);
    }
  }
  warp_max<G>(mx);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    s[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const float x = q[g][c] - mx[g];
      e[g][c] = lane + 32 * c < atoms ? (FAST ? __expf(x) : expf(x)) : 0.f;
      s[g] += e[g][c];
    }
  }
}

// This lane's values of actions k0 .. k0 + G - 1 of a row (0 past it).
template <typename T, int NPL, int G>
__device__ __forceinline__ void load_group(const T* a_row, int k0, int n_act,
                                           int atoms, int lane,
                                           float (&q)[G][NPL]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const int j = lane + 32 * c;
      q[g][c] = k0 + g < n_act && j < atoms
                    ? to_f<T>(a_row[(k0 + g) * atoms + j]) : 0.f;
    }
}

template <typename T, int NPL>
__global__ void __launch_bounds__(HEAD_WARPS * 32)
    dueling_head_kernel(const T* __restrict__ v, const T* __restrict__ a,
                        const float* __restrict__ z, float* __restrict__ dist,
                        int dist_mode, float* __restrict__ q_out,
                        long long* __restrict__ act_out,
                        float* __restrict__ maxq_out, int b, int n_act,
                        int atoms) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * HEAD_WARPS + warp;
  if (row >= b) return;  // whole warps only; no block barrier follows
  const T* ar = a + static_cast<size_t>(row) * n_act * atoms;
  float vv[NPL], zz[NPL], q[GROUP][NPL], mean[NPL];
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    const int j = lane + 32 * c;
    vv[c] = j < atoms ? to_f<T>(v[static_cast<size_t>(row) * atoms + j])
                      : 0.f;
    zz[c] = j < atoms ? z[j] : 0.f;
  }
  load_group<T, NPL, GROUP>(ar, 0, n_act, atoms, lane, q);
  if (n_act <= GROUP) {  // the whole row is in registers: its mean from them
    const float inv_a = 1.f / n_act;
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
        if (g < n_act) sum += q[g][c];
      mean[c] = rne<T>(sum * inv_a);
    }
  } else {
    float unused[NPL];
    dueling_mean<T, NPL>(ar, n_act, atoms, lane, -1, mean, unused);
  }

  float best = -INFINITY;
  int best_k = 0;
  for (int k0 = 0; k0 < n_act; k0 += GROUP) {
    if (k0) load_group<T, NPL, GROUP>(ar, k0, n_act, atoms, lane, q);
    float mx[GROUP], e[GROUP][NPL], s[GROUP], red[2 * GROUP];
    combine_softmax<T, NPL, GROUP, true>(vv, mean, lane, atoms, q, mx, e, s);
    // red[g] = s_g and red[G + g] = sum_j z_j e_gj, in one butterfly; then
    // q_g = (sum_j z_j e_gj) / s_g.
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      red[g] = s[g];
      red[GROUP + g] = 0.f;
#pragma unroll
      for (int c = 0; c < NPL; ++c) red[GROUP + g] += e[g][c] * zz[c];
    }
    warp_sum<2 * GROUP>(red);
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const int k = k0 + g;
      if (k >= n_act) break;
      const float r = __frcp_rn(red[g]);
      const float qa = red[GROUP + g] * r;
      if (dist_mode) {
        float* out = dist + (static_cast<size_t>(row) * n_act + k) * atoms;
        const float log_s = logf(red[g]);
#pragma unroll
        for (int c = 0; c < NPL; ++c) {
          const int j = lane + 32 * c;
          if (j < atoms)
            out[j] =
                dist_mode == 1 ? e[g][c] * r : (q[g][c] - mx[g]) - log_s;
        }
      }
      if (lane == 0) q_out[static_cast<size_t>(row) * n_act + k] = qa;
      if (k == 0 || qa > best) {  // the first maximum wins
        best = qa;
        best_k = k;
      }
    }
  }
  if (lane == 0) {
    act_out[row] = best_k;
    maxq_out[row] = best;
  }
}

// One row of the loss: writes the row's loss, dv and da, and returns
// w * loss (in every lane).
template <typename T, int NPL>
__device__ __forceinline__ float loss_row(
    const T* __restrict__ v, const T* __restrict__ a,
    const void* __restrict__ actions, int act64, const float* __restrict__ m,
    const float* __restrict__ w, float* __restrict__ losses,
    T* __restrict__ dv, T* __restrict__ da, int row, int b, int n_act,
    int atoms, int lane) {
  const float inv_a = 1.f / n_act, inv_b = 1.f / b;
  const int act =
      act64 ? static_cast<int>(static_cast<const long long*>(actions)[row])
            : static_cast<const int*>(actions)[row];
  const float wr = w[row];
  const size_t vo = static_cast<size_t>(row) * atoms;
  float vv[NPL], mm[NPL], red[2] = {0.f, 0.f};  // s, sum_j m_j
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    const int j = lane + 32 * c;
    vv[c] = j < atoms ? to_f<T>(v[vo + j]) : 0.f;
    mm[c] = j < atoms ? m[vo + j] : 0.f;
    red[1] += mm[c];
  }
  float mean[NPL], q[1][NPL], mx[1], e[1][NPL], s[1];
  dueling_mean<T, NPL>(a + static_cast<size_t>(row) * n_act * atoms, n_act,
                       atoms, lane, act, mean, q[0]);
  combine_softmax<T, NPL, 1, false>(vv, mean, lane, atoms, q, mx, e, s);
  red[0] = s[0];
  warp_sum<2>(red);
  // log p as PyTorch's log_softmax forms it, and p = expf(log p) as the
  // plain version takes it.
  const float log_s = logf(red[0]);
  float l[1] = {0.f};
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    q[0][c] = (q[0][c] - mx[0]) - log_s;
    if (lane + 32 * c < atoms) l[0] += mm[c] * q[0][c];
  }
  warp_sum<1>(l);
  const float lr = -l[0];
  if (lane == 0) losses[row] = lr;
  const float scale = wr * inv_b;
  T* dar = da + static_cast<size_t>(row) * n_act * atoms;
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    const int j = lane + 32 * c;
    if (j >= atoms) continue;
    const float g = scale * (expf(q[0][c]) * red[1] - mm[c]);
    dv[vo + j] = from_f<T>(g);
    for (int k = 0; k < n_act; ++k)
      dar[k * atoms + j] = from_f<T>(g * ((k == act ? 1.f : 0.f) - inv_a));
  }
  return wr * lr;
}

// The loss over a cluster of up to LOSS_BLOCKS blocks of LOSS_WARPS rows,
// on as many SMs, one warp per row (rows past the cluster's warps loop):
// each warp writes its w * loss into block 0's shared memory (once the
// cluster's first barrier says every block has started), and after the
// cluster's barrier one thread of block 0 adds them in row order.
template <typename T, int NPL>
__global__ void __launch_bounds__(LOSS_WARPS * 32)
    head_loss_kernel(const T* __restrict__ v, const T* __restrict__ a,
                     const void* __restrict__ actions, int act64,
                     const float* __restrict__ m, const float* __restrict__ w,
                     float* __restrict__ losses, float* __restrict__ loss,
                     T* __restrict__ dv, T* __restrict__ da, int b, int n_act,
                     int atoms) {
  __shared__ float wloss[LOSS_BLOCKS * LOSS_WARPS];
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int per_pass = static_cast<int>(cluster.num_blocks()) * LOSS_WARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = rank * LOSS_WARPS + warp;
  float* slots = cluster.map_shared_rank(wloss, 0);
  float total = 0.f;
  for (int r0 = 0; r0 < b; r0 += per_pass) {
    const int row = r0 + slot;
    const float wl = row < b ? loss_row<T, NPL>(v, a, actions, act64, m, w,
                                                losses, dv, da, row, b, n_act,
                                                atoms, lane)
                             : 0.f;
    if (r0 == 0) asm volatile("barrier.cluster.wait;" ::: "memory");
    if (lane == 0) slots[slot] = wl;
    cluster.sync();
    if (rank == 0 && threadIdx.x == 0)
      for (int i = 0; i < per_pass && r0 + i < b; ++i) total += wloss[i];
    if (r0 + per_pass < b) cluster.sync();  // block 0 has read the slots
  }
  if (rank == 0 && threadIdx.x == 0) *loss = total * (1.f / b);
}

// One row of K4's target per warp (see the header).
template <int NPL>
__global__ void __launch_bounds__(TARGET_WARPS * 32)
    c51_target_kernel(const float* __restrict__ pns,
                      const void* __restrict__ a_star, int act64,
                      const float* __restrict__ ret,
                      const float* __restrict__ nt,
                      const float* __restrict__ z, float* __restrict__ m,
                      int b, int n_act, int atoms, float gamma_n, float v_min,
                      float v_max, float delta_z) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * TARGET_WARPS + warp;
  if (row >= b) return;  // whole warps only; no block barrier follows
  const int act =
      act64 ? static_cast<int>(static_cast<const long long*>(a_star)[row])
            : static_cast<const int*>(a_star)[row];
  const float* p = pns + (static_cast<size_t>(row) * n_act + act) * atoms;
  const float r = ret[row], scale = nt[row] * gamma_n;
  float pi[NPL], bi[NPL], mj[NPL];
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    const int i = lane + 32 * c;
    mj[c] = 0.f;
    pi[c] = i < atoms ? p[i] : 0.f;
    const float tz = i < atoms ? fminf(fmaxf(r + scale * z[i], v_min), v_max)
                               : v_min;
    bi[c] = __fdiv_rn(tz - v_min, delta_z);
  }
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    const int n = min(32, atoms - 32 * c);
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const float ps = __shfl_sync(FULL, pi[c], s);
      const float bs = __shfl_sync(FULL, bi[c], s);
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        const float j = static_cast<float>(lane + 32 * t);
        mj[t] += ps * fminf(fmaxf(1.f - fabsf(bs - j), 0.f), 1.f);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    const int j = lane + 32 * c;
    if (j < atoms) m[static_cast<size_t>(row) * atoms + j] = mj[c];
  }
}

template <int NPL>
cudaError_t launch_target(const float* pns, const void* a_star, int act64,
                          const float* ret, const float* nt, const float* z,
                          float* m, int b, int n_act, int atoms, float gamma_n,
                          float v_min, float v_max, float delta_z,
                          cudaStream_t stream) {
  c51_target_kernel<NPL><<<(b + TARGET_WARPS - 1) / TARGET_WARPS,
                           TARGET_WARPS * 32, 0, stream>>>(
      pns, a_star, act64, ret, nt, z, m, b, n_act, atoms, gamma_n, v_min,
      v_max, delta_z);
  return cudaGetLastError();
}

template <typename T, int NPL>
cudaError_t launch_head(const void* v, const void* a, const float* z,
                        float* dist, int dist_mode, float* q, long long* act,
                        float* max_q, int b, int n_act, int atoms,
                        cudaStream_t stream) {
  dueling_head_kernel<T, NPL><<<(b + HEAD_WARPS - 1) / HEAD_WARPS,
                                HEAD_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(a), z, dist, dist_mode, q,
      act, max_q, b, n_act, atoms);
  return cudaGetLastError();
}

template <typename T, int NPL>
cudaError_t launch_loss(const void* v, const void* a, const void* actions,
                        int act64, const float* m, const float* w,
                        float* losses, float* loss, void* dv, void* da, int b,
                        int n_act, int atoms, cudaStream_t stream) {
  const int blocks = min(LOSS_BLOCKS, (b + LOSS_WARPS - 1) / LOSS_WARPS);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(LOSS_WARPS * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, head_loss_kernel<T, NPL>, static_cast<const T*>(v),
      static_cast<const T*>(a), actions, act64, m, w, losses, loss,
      static_cast<T*>(dv), static_cast<T*>(da), b, n_act, atoms);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ceil(atoms / 32) as a template argument.
template <typename T, template <typename, int> class F, typename... Args>
cudaError_t by_npl(int atoms, Args... args) {
  switch ((atoms + 31) / 32) {
    case 1: return F<T, 1>::run(args...);
    case 2: return F<T, 2>::run(args...);
    case 3: return F<T, 3>::run(args...);
    case 4: return F<T, 4>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int NPL> struct HeadF {
  template <typename... Args> static cudaError_t run(Args... args) {
    return launch_head<T, NPL>(args...);
  }
};
template <typename T, int NPL> struct TargetF {
  template <typename... Args> static cudaError_t run(Args... args) {
    return launch_target<NPL>(args...);
  }
};
template <typename T, int NPL> struct LossF {
  template <typename... Args> static cudaError_t run(Args... args) {
    return launch_loss<T, NPL>(args...);
  }
};

}  // namespace

// KB. v (b, atoms) and a (b, n_act * atoms) float32 (bf16 = 0) or bfloat16
// (bf16 = 1); z (atoms,) float32; dist (b, n_act, atoms) float32, written
// when dist_mode is 1 (probabilities) or 2 (log-probabilities); q (b, n_act)
// float32, act (b,) int64, max_q (b,) float32. 1 <= atoms <= 128 and
// b >= 1 (else cudaErrorInvalidValue). One launch on stream. Returns
// cudaGetLastError().
extern "C" int dueling_head(const void* v, const void* a, int bf16,
                            const float* z, float* dist, int dist_mode,
                            float* q, long long* act, float* max_q, int b,
                            int n_act, int atoms, void* stream) {
  if (atoms < 1 || atoms > MAX_ATOMS || b < 1 || n_act < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? by_npl<__nv_bfloat16, HeadF>(atoms, v, a, z, dist, dist_mode, q,
                                          act, max_q, b, n_act, atoms, s)
           : by_npl<float, HeadF>(atoms, v, a, z, dist, dist_mode, q, act,
                                  max_q, b, n_act, atoms, s);
  return static_cast<int>(err);
}

// K4's loss. v (b, atoms) and a (b, n_act * atoms) float32 (bf16 = 0) or
// bfloat16 (bf16 = 1), as are dv and da; actions (b,) int64 (act64 = 1) or
// int32; m (b, atoms) and w (b,) float32; losses (b,) and loss () float32.
// 1 <= atoms <= 128, b >= 1. One launch of one cluster on stream. Returns
// the launch's error, else cudaGetLastError().
extern "C" int head_loss(const void* v, const void* a, int bf16,
                         const void* actions, int act64, const float* m,
                         const float* w, float* losses, float* loss, void* dv,
                         void* da, int b, int n_act, int atoms, void* stream) {
  if (atoms < 1 || atoms > MAX_ATOMS || b < 1 || n_act < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? by_npl<__nv_bfloat16, LossF>(atoms, v, a, actions, act64, m, w,
                                          losses, loss, dv, da, b, n_act,
                                          atoms, s)
           : by_npl<float, LossF>(atoms, v, a, actions, act64, m, w, losses,
                                  loss, dv, da, b, n_act, atoms, s);
  return static_cast<int>(err);
}

// K4's target. pns (b, n_act, atoms), ret (b,), nt (b,) and z (atoms,)
// float32; a_star (b,) int64 (act64 = 1) or int32, each in [0, n_act); m
// (b, atoms) float32. 1 <= atoms <= 128, b >= 1. One launch on stream.
// Returns cudaGetLastError().
extern "C" int c51_target(const float* pns, const void* a_star, int act64,
                          const float* ret, const float* nt, const float* z,
                          float* m, int b, int n_act, int atoms,
                          float gamma_n, float v_min, float v_max,
                          float delta_z, void* stream) {
  if (atoms < 1 || atoms > MAX_ATOMS || b < 1 || n_act < 1)
    return cudaErrorInvalidValue;
  return static_cast<int>(by_npl<float, TargetF>(
      atoms, pns, a_star, act64, ret, nt, z, m, b, n_act, atoms, gamma_n,
      v_min, v_max, delta_z, static_cast<cudaStream_t>(stream)));
}
