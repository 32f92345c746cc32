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
// 22 tensors, 27.5 MB a tensor kind, pong): the step must read p, g, mu and
// nu once and write p, mu and nu once: 7 x 27.5 MB = 192 MB with a float32
// mu (57.4 us at 3.35 TB/s), 165 MB (49.2 us) with a bf16 mu; the
// data-efficient net (828,842 parameters) 23.2 MB (6.93 us). A few FLOP per
// byte, so bound by bytes. These are the bounds chip_smoke.py reports. A
// design in two passes that reads g again from device memory moves one
// tensor kind more: 220 MB (65.6 us) with a float32 mu, 192 MB (57.4 us)
// with a bf16 mu, 26.5 MB (7.92 us) for the data-efficient net.
//
// Design. The tensors are described by a pointer table passed by value as
// a kernel argument (a multi-tensor launch, no flat copy of the grads),
// with the wrapper's plan (kernels/adam.py::adam_plan), which the entry
// checks. The table holds up to MAX_TENSORS = 64 tensors, so that one call
// takes the whole of the largest net, the IMPALA ResNet x4 (46 tensors),
// under one global norm; at 3,152 bytes it stays inside the 4 KB of kernel
// arguments. A call reads only the first `count` entries, so the bits of a
// call do not depend on the table's size. Two launches on one stream:
//   Pass 1 (sumsq_kernel): each block sums g^2 over its 4096-element chunk
//   of one tensor, thread t its elements t + 256 i (i = 0..15) in that
//   order with fmaf, then a fixed warp and block reduction, into its own
//   partial. Every thread issues its 16 loads before the first fmaf.
//   Where g takes at most a third of the L2 (the plan's keep_g: the
//   data-efficient net's 3.3 MB, not the canonical net's 27.5 MB), the
//   loads ask L2 to keep g's lines (evict_last), which pass 2 reads again:
//   measured faster there, and slower at the canonical net. The
//   last block to finish (a ticket after __threadfence; it resets the
//   ticket, which the wrapper keeps per stream) sums the partials once in
//   a fixed order, 8 loads a thread in flight, writes the norm and
//   advances Adam's count.
//   Pass 2 (update_kernel): a block a chunk of 1024 elements of one tensor,
//   four consecutive elements a thread: one 16-byte access of p, g and nu
//   and 8 or 16 bytes of mu where the array's pointer is aligned (the
//   plan's per-tensor vec mask; four scalar accesses where it is not, as
//   for a gradient view at an odd offset of one flat buffer), streamed past
//   L2's keep (evict-first). It is launched as a programmatic dependent of
//   pass 1, whose blocks let it start at once: its blocks issue their loads
//   while pass 1 ends and wait for it (griddepcontrol.wait) only to read
//   the norm and the count. The blocks walk the chunks in reverse, so the
//   first ones read the lines of g that pass 1 read last.
// The element-to-thread map of pass 1, its fmaf order, the block reduction
// and the partials' order are those of the first design of this kernel
// (where every block of pass 2 summed all partials itself), so the norm,
// and with it every element of p, mu, nu and count, has the same bits. No
// float atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_TENSORS 64

// Bits of AdamTable::vec: which arrays of a tensor are aligned for access
// four elements at a time (16 bytes; 8 for a bf16 mu).
#define VEC_P 1
#define VEC_G 2
#define VEC_MU 4
#define VEC_NU 8

struct AdamTable {
  float* p[MAX_TENSORS];
  const float* g[MAX_TENSORS];
  void* mu[MAX_TENSORS];
  float* nu[MAX_TENSORS];
  long long n[MAX_TENSORS];
  int sum_start[MAX_TENSORS + 1];     // pass 1's first chunk of each tensor
  int update_start[MAX_TENSORS + 1];  // pass 2's; [count] = the totals
  unsigned char vec[MAX_TENSORS];
  int count;
};

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;               // pass 1
constexpr int CHUNK = THREADS * PER_THREAD;  // pass 1's elements a block
constexpr int UPDATE_CHUNK = 4 * THREADS;    // pass 2's
constexpr int PARTIALS_IN_FLIGHT = 8;        // the last block's loads

// The tensor of chunk blk under the first-chunk table start (the last i
// with start[i] <= blk, by bisection), and the chunk's index within it.
__device__ __forceinline__ int locate(const int* start, int count, int blk,
                                      int* within) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= blk)
      lo = mid;
    else
      hi = mid - 1;
  }
  *within = blk - start[lo];
  return lo;
}

// A load of g that asks L2 to keep the line (evict_last).
__device__ __forceinline__ float load_keep(const float* a) {
  unsigned long long policy;
  float v;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  asm volatile("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(v)
               : "l"(a), "l"(policy));
  return v;
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

// scratch[0 .. chunks) holds pass 1's partials, scratch[chunks] the norm.
__global__ void __launch_bounds__(THREADS)
    sumsq_kernel(const AdamTable t, float* __restrict__ scratch,
                 unsigned* __restrict__ ticket, int* __restrict__ count,
                 bool keep_g) {
  __shared__ bool s_last;
  // Pass 2 may start now: it reads nothing of this launch before its
  // griddepcontrol.wait, which waits for the whole of it.
  asm volatile("griddepcontrol.launch_dependents;");
  int within;
  const int k = locate(t.sum_start, t.count, blockIdx.x, &within);
  const float* g = t.g[k];
  const long long first = (long long)within * CHUNK + threadIdx.x;
  const long long left = t.n[k] - first;  // > i * THREADS for element i
  float v[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const float* at = g + first + i * THREADS;
    v[i] = (long long)i * THREADS < left ? (keep_g ? load_keep(at) : *at)
                                         : 0.f;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i)
    if ((long long)i * THREADS < left) s = fmaf(v[i], v[i], s);
  s = block_sum(s);
  const int chunks = gridDim.x;
  if (threadIdx.x == 0) {
    scratch[blockIdx.x] = s;
    __threadfence();  // the partial before the ticket
    s_last = atomicAdd(ticket, 1u) == (unsigned)chunks - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // The last block: every partial once, thread t those at t + 256 i added
  // in that order, read past L1, then the same block reduction.
  float a = 0.f;
  for (int base = threadIdx.x; base < chunks;
       base += PARTIALS_IN_FLIGHT * THREADS) {
    float part[PARTIALS_IN_FLIGHT];
#pragma unroll
    for (int i = 0; i < PARTIALS_IN_FLIGHT; ++i) {
      const int at = base + i * THREADS;
      part[i] = at < chunks ? __ldcg(scratch + at) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PARTIALS_IN_FLIGHT; ++i)
      if (base + i * THREADS < chunks) a += part[i];
  }
  const float norm = sqrtf(block_sum(a));
  if (threadIdx.x == 0) {
    scratch[chunks] = norm;
    // optax's safe_increment: the count saturates at INT32_MAX. Pass 2
    // reads the new count after its wait.
    if (*count < 0x7fffffff) *count += 1;
    *ticket = 0u;
  }
}

struct Step {
  float norm, max_norm, bc1, bc2, b1, b2, one_m_b1, one_m_b2, b1_bf16,
      neg_lr, eps;
  bool clip;
};

// One element's update, in the order of the comment at the top. mu_in is
// the stored mu as float32 (exact for a bf16 mu); returns the new float32
// mu, which the caller stores (rounded to bf16 when mu is bf16).
template <bool MU_BF16>
__device__ __forceinline__ float adam_element(const Step& st, float gi,
                                              float mu_in, float* p,
                                              float* nu) {
  if (st.clip) gi = (gi / st.norm) * st.max_norm;
  float mu_new;
  if (MU_BF16) {
    const float decayed =
        __bfloat162float(__float2bfloat16(st.b1_bf16 * mu_in));
    mu_new = __fadd_rn(__fmul_rn(st.one_m_b1, gi), decayed);
  } else {
    mu_new = __fadd_rn(__fmul_rn(st.one_m_b1, gi), __fmul_rn(st.b1, mu_in));
  }
  const float nu_new = __fadd_rn(__fmul_rn(st.one_m_b2, __fmul_rn(gi, gi)),
                                 __fmul_rn(st.b2, *nu));
  *nu = nu_new;
  const float mu_hat = mu_new / st.bc1;
  const float nu_hat = nu_new / st.bc2;
  const float u = mu_hat / (sqrtf(nu_hat) + st.eps);
  *p = __fadd_rn(*p, __fmul_rn(st.neg_lr, u));
  return mu_new;
}

// Four float32 elements from a + e: one 16-byte access where vec (read
// once: evict-first), else `valid` (1 to 4) scalar ones.
__device__ __forceinline__ float4 load4(const float* a, long long e, bool vec,
                                        int valid) {
  if (vec && valid == 4) return __ldcs(reinterpret_cast<const float4*>(a + e));
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  r.x = a[e];
  if (valid > 1) r.y = a[e + 1];
  if (valid > 2) r.z = a[e + 2];
  if (valid > 3) r.w = a[e + 3];
  return r;
}

__device__ __forceinline__ void store4(float* a, long long e, bool vec,
                                       int valid, float4 v) {
  if (vec && valid == 4) {
    __stcs(reinterpret_cast<float4*>(a + e), v);
    return;
  }
  a[e] = v.x;
  if (valid > 1) a[e + 1] = v.y;
  if (valid > 2) a[e + 2] = v.z;
  if (valid > 3) a[e + 3] = v.w;
}

// mu as float32, from float32 or bf16 storage (8 bytes a vector). A bf16
// value is the top half of its float32: __bfloat162float is that shift.
template <bool MU_BF16>
__device__ __forceinline__ float4 load_mu(const void* mu, long long e,
                                          bool vec, int valid) {
  if (!MU_BF16) return load4(static_cast<const float*>(mu), e, vec, valid);
  const __nv_bfloat16* m = static_cast<const __nv_bfloat16*>(mu);
  if (vec && valid == 4) {
    const uint2 u = __ldcs(reinterpret_cast<const uint2*>(m + e));
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  r.x = __bfloat162float(m[e]);
  if (valid > 1) r.y = __bfloat162float(m[e + 1]);
  if (valid > 2) r.z = __bfloat162float(m[e + 2]);
  if (valid > 3) r.w = __bfloat162float(m[e + 3]);
  return r;
}

template <bool MU_BF16>
__device__ __forceinline__ void store_mu(void* mu, long long e, bool vec,
                                         int valid, float4 v) {
  if (!MU_BF16) {
    store4(static_cast<float*>(mu), e, vec, valid, v);
    return;
  }
  __nv_bfloat16* m = static_cast<__nv_bfloat16*>(mu);
  const __nv_bfloat16 h0 = __float2bfloat16(v.x), h1 = __float2bfloat16(v.y),
                      h2 = __float2bfloat16(v.z), h3 = __float2bfloat16(v.w);
  if (vec && valid == 4) {
    uint2 u;
    u.x = static_cast<unsigned>(__bfloat16_as_ushort(h0)) |
          static_cast<unsigned>(__bfloat16_as_ushort(h1)) << 16;
    u.y = static_cast<unsigned>(__bfloat16_as_ushort(h2)) |
          static_cast<unsigned>(__bfloat16_as_ushort(h3)) << 16;
    __stcs(reinterpret_cast<uint2*>(m + e), u);
    return;
  }
  m[e] = h0;
  if (valid > 1) m[e + 1] = h1;
  if (valid > 2) m[e + 2] = h2;
  if (valid > 3) m[e + 3] = h3;
}

template <bool MU_BF16>
__global__ void __launch_bounds__(THREADS)
    update_kernel(const AdamTable t, const float* __restrict__ norm_ptr,
                  const int* __restrict__ count, float lr, float b1,
                  float b2, float one_m_b1, float one_m_b2, float eps,
                  float max_norm) {
  // Reverse order: the first blocks take the chunks pass 1 read last.
  int within;
  const int k = locate(t.update_start, t.count,
                       (int)gridDim.x - 1 - (int)blockIdx.x, &within);
  const unsigned mask = t.vec[k];
  const long long e = (long long)within * UPDATE_CHUNK + 4 * threadIdx.x;
  const int valid = (int)min(t.n[k] - e, 4LL);
  float4 vp, vg, vm, vn;
  if (valid > 0) {
    vp = load4(t.p[k], e, mask & VEC_P, valid);
    vg = load4(t.g[k], e, mask & VEC_G, valid);
    vm = load_mu<MU_BF16>(t.mu[k], e, mask & VEC_MU, valid);
    vn = load4(t.nu[k], e, mask & VEC_NU, valid);
  }
  // Pass 1 is complete and its writes visible past this point.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (valid <= 0) return;
  Step st;
  st.norm = *norm_ptr;
  st.max_norm = max_norm;
  st.clip = !(st.norm < max_norm);
  const float step = (float)*count;
  st.bc1 = 1.f - powf(b1, step);
  st.bc2 = 1.f - powf(b2, step);
  st.b1 = b1;
  st.b2 = b2;
  st.one_m_b1 = one_m_b1;
  st.one_m_b2 = one_m_b2;
  st.b1_bf16 = __bfloat162float(__float2bfloat16(b1));
  st.neg_lr = -lr;
  st.eps = eps;
  float4 m;
  m.x = adam_element<MU_BF16>(st, vg.x, vm.x, &vp.x, &vn.x);
  m.y = adam_element<MU_BF16>(st, vg.y, vm.y, &vp.y, &vn.y);
  m.z = adam_element<MU_BF16>(st, vg.z, vm.z, &vp.z, &vn.z);
  m.w = adam_element<MU_BF16>(st, vg.w, vm.w, &vp.w, &vn.w);
  store4(t.p[k], e, mask & VEC_P, valid, vp);
  store_mu<MU_BF16>(t.mu[k], e, mask & VEC_MU, valid, m);
  store4(t.nu[k], e, mask & VEC_NU, valid, vn);
}

// Pass 2 as a programmatic dependent launch of pass 1.
template <bool MU_BF16>
cudaError_t launch_update(int blocks, cudaStream_t s, const AdamTable& t,
                          const float* norm, const int* count, float lr,
                          float b1, float b2, float one_m_b1, float one_m_b2,
                          float eps, float max_norm) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, update_kernel<MU_BF16>, t, norm, count, lr,
                            b1, b2, one_m_b1, one_m_b2, eps, max_norm);
}

// The plan agrees with the tensors: each first-chunk table counts whole
// chunks of every tensor, and a vec bit is set only on an aligned pointer.
bool plan_ok(const AdamTable& t, bool mu_bf16) {
  if (t.count < 1 || t.count > MAX_TENSORS || t.sum_start[0] != 0 ||
      t.update_start[0] != 0)
    return false;
  const uintptr_t mu_align = mu_bf16 ? 8 : 16;
  if (t.sum_start[t.count] < 1) return false;  // no element at all
  for (int i = 0; i < t.count; ++i) {
    if (t.n[i] < 0 ||
        t.sum_start[i + 1] - t.sum_start[i] != (t.n[i] + CHUNK - 1) / CHUNK ||
        t.update_start[i + 1] - t.update_start[i] !=
            (t.n[i] + UPDATE_CHUNK - 1) / UPDATE_CHUNK)
      return false;
    const unsigned m = t.vec[i];
    if (m > 15 ||
        ((m & VEC_P) && reinterpret_cast<uintptr_t>(t.p[i]) % 16) ||
        ((m & VEC_G) && reinterpret_cast<uintptr_t>(t.g[i]) % 16) ||
        ((m & VEC_MU) && reinterpret_cast<uintptr_t>(t.mu[i]) % mu_align) ||
        ((m & VEC_NU) && reinterpret_cast<uintptr_t>(t.nu[i]) % 16))
      return false;
  }
  return true;
}

}  // namespace

extern "C" int adam_max_tensors() { return MAX_TENSORS; }
extern "C" int adam_chunk() { return CHUNK; }
extern "C" int adam_update_chunk() { return UPDATE_CHUNK; }
extern "C" int adam_threads() { return THREADS; }

// One clip + Adam step over the tensors of *table (host memory; copied into
// the kernels' arguments) under the wrapper's plan (kernels/adam.py::
// adam_plan: the table's sum_start, update_start and vec), which is
// checked: a plan that disagrees with the tensors is refused with
// cudaErrorInvalidValue before any launch. scratch is float32 with one
// entry per pass-1 chunk (table->sum_start[table->count]) and one for the
// norm; ticket an int32 0 between calls, which the call leaves 0 (calls on
// one stream run one at a time); keep_g asks L2 to keep g's lines between
// the passes (the plan sets it where g fits a third of L2); count is Adam's int32 step counter on the
// device, advanced by one. one_m_b1 and one_m_b2 are 1 - b1 and 1 - b2
// worked out in double and rounded to float, as optax's Python constants
// are. Returns a CUDA error code.
extern "C" int adam_clip_step(const AdamTable* table, float* scratch,
                              unsigned* ticket, int* count, int mu_bf16,
                              int keep_g, float lr, float b1, float b2, float one_m_b1,
                              float one_m_b2, float eps, float max_norm,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AdamTable& t = *table;
  if (!plan_ok(t, mu_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = t.sum_start[t.count];
  sumsq_kernel<<<chunks, THREADS, 0, s>>>(t, scratch, ticket, count,
                                          keep_g != 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = t.update_start[t.count];
  const float* norm = scratch + chunks;
  err = mu_bf16 ? launch_update<true>(blocks, s, t, norm, count, lr, b1, b2,
                                      one_m_b1, one_m_b2, eps, max_norm)
                : launch_update<false>(blocks, s, t, norm, count, lr, b1, b2,
                                       one_m_b1, one_m_b2, eps, max_norm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
