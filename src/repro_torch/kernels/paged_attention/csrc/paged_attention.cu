// Single-query decode attention over a paged KV pool, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention` (`_kernel`) of
// src/repro/kernels/paged_attention/paged_attention.py.
//
// q (B, H, D); k_pages/v_pages (P, page, Hk, D); page_table (B, MP) int32;
// lengths (B,) int32; o (B, H, D). float32 or bfloat16, contiguous. Row b
// attends to positions [0, lengths[b]) of the pages page_table[b, 0..].
//
// Design. The TPU version put the page table in scalar-prefetch memory so
// the pipeline's DMA could chase it, and walked a row's pages in order in
// one grid column carrying (m, l, acc) in VMEM. Hopper has no scalar
// prefetch and runs blocks in parallel: one block owns a (kv head, batch
// row, page), reads page_table[b, ip] itself, and processes the G = H / Hk
// query heads that share the kv head together, so each K/V byte is read
// once. Pages at or past lengths[b] write an empty partial and exit; the
// last live page is masked inside (length == 1 reads one position). In a
// block, one warp per token computes the G scores (lanes split D, warp
// shuffles reduce), one warp per head takes the page's max and sum in
// float32, and every thread folds the page's probabilities into the
// accumulators of its (head, d) pairs. A second kernel combines the pages'
// partial (m, l, acc) per (row, head) with the usual rescaling; the
// partials live in a float32 scratch the wrapper allocates.
//
// Bound on the H100: decode attention reads every live K/V byte once for
// 4*G*D operations per position, ~2 operations per byte in bf16, so it is
// bound by memory bytes (B=8, C=1024, Hk=8, D=128 bf16: 33.5 MB a layer at
// full context, ~10 us at 3.35 TB/s). Splitting by page puts
// B*Hk*pages blocks in flight instead of B*Hk, which is what memory-level
// parallelism needs here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_DL = 8;              // D <= 32*MAX_DL
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// partial record per (b, kv head, page, head): acc[D], m, l
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode(const T* __restrict__ q, const T* __restrict__ kp,
             const T* __restrict__ vp, const int* __restrict__ page_table,
             const int* __restrict__ lengths, float* __restrict__ part,
             int H, int Hk, int D, int page, int MP, float scale) {
  const int G = H / Hk;
  extern __shared__ float smem[];
  float* sq = smem;                    // G x D
  float* ss = sq + G * D;              // G x page: scores, then probs

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int ip = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int live = min(page, lengths[b] - ip * page);
  float* pb = part + (((long)b * Hk + hk) * MP + ip) * G * (D + 2);
  if (live <= 0) {                     // no position of this page is live
    for (int i = tid; i < G * (D + 2); i += THREADS)
      pb[i] = (i % (D + 2) == D) ? NEG : 0.f;
    return;
  }

  const T* qb = q + ((long)b * H + (long)hk * G) * D;
  for (int i = tid; i < G * D; i += THREADS) sq[i] = to_f(qb[i]);
  __syncthreads();

  const long tok_stride = (long)Hk * D;
  const long phys = page_table[(long)b * MP + ip];
  const T* kpg = kp + phys * page * tok_stride + (long)hk * D;
  const T* vpg = vp + phys * page * tok_stride + (long)hk * D;

  // scores: one warp per token, lanes split D
  for (int j = warp; j < live; j += NWARPS) {
    const T* kr = kpg + j * tok_stride;
    float kreg[MAX_DL];
#pragma unroll
    for (int i = 0; i < MAX_DL; ++i) {
      const int d = lane + 32 * i;
      kreg[i] = d < D ? to_f(kr[d]) : 0.f;
    }
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_DL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) dot += sq[g * D + d] * kreg[i];
      }
      dot = warp_sum(dot);
      if (lane == 0) ss[g * page + j] = dot * scale;
    }
  }
  __syncthreads();

  // the page's max and sum: one warp per head
  for (int g = warp; g < G; g += NWARPS) {
    float mx = NEG;
    for (int j = lane; j < live; j += 32) mx = fmaxf(mx, ss[g * page + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < live; j += 32) {
      const float p = expf(ss[g * page + j] - mx);
      ss[g * page + j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      pb[g * (D + 2) + D] = mx;
      pb[g * (D + 2) + D + 1] = sum;
    }
  }
  __syncthreads();

  // p @ V for this thread's (head, d) pairs
  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    const float* pr = ss + g * page;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int j = 0;
    for (; j + 4 <= live; j += 4) {
      a0 += pr[j] * to_f(vpg[j * tok_stride + d]);
      a1 += pr[j + 1] * to_f(vpg[(j + 1) * tok_stride + d]);
      a2 += pr[j + 2] * to_f(vpg[(j + 2) * tok_stride + d]);
      a3 += pr[j + 3] * to_f(vpg[(j + 3) * tok_stride + d]);
    }
    for (; j < live; ++j) a0 += pr[j] * to_f(vpg[j * tok_stride + d]);
    pb[g * (D + 2) + d] = (a0 + a1) + (a2 + a3);
  }
}

// o[b, hk*G + g, :] from the MP page partials of (b, hk)
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_combine(const float* __restrict__ part, T* __restrict__ o, int H,
              int Hk, int D, int MP) {
  const int G = H / Hk;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const float* pb = part + ((long)b * Hk + hk) * MP * G * (D + 2);
  T* ob = o + ((long)b * H + (long)hk * G) * D;
  for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float M = NEG;
    for (int ip = 0; ip < MP; ++ip)
      M = fmaxf(M, pb[(ip * G + g) * (D + 2) + D]);
    float num = 0.f, den = 0.f;
    for (int ip = 0; ip < MP; ++ip) {
      const float* r = pb + (ip * G + g) * (D + 2);
      const float w = expf(r[D] - M);
      num += w * r[d];
      den += w * r[D + 1];
    }
    store(&ob[idx], num / fmaxf(den, 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* page_table, const int* lengths, float* part,
                   void* o, int B, int H, int Hk, int D, int page, int MP,
                   float scale, cudaStream_t stream) {
  const int G = H / Hk;
  const size_t bytes = sizeof(float) * ((size_t)G * D + (size_t)G * page);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  paged_decode<T><<<dim3(Hk, B, MP), THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), page_table, lengths, part, H, Hk, D, page,
      MP, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine<T><<<dim3(Hk, B), THREADS, 0, stream>>>(
      part, static_cast<T*>(o), H, Hk, D, MP);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ``part`` is float32 scratch of
// B*Hk*MP*(H/Hk)*(D+2) values. Returns the launches' cudaError_t.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* lengths, void* part,
                                      void* o, int B, int H, int Hk, int D,
                                      int page, int MP, float scale,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % Hk != 0 || D > 32 * MAX_DL || MP > 65535)
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* ln = static_cast<const int*>(lengths);
  float* pp = static_cast<float*>(part);
  if (dtype == 0)
    return (int)launch<float>(q, k_pages, v_pages, pt, ln, pp, o, B, H, Hk,
                              D, page, MP, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k_pages, v_pages, pt, ln, pp, o, B,
                                      H, Hk, D, page, MP, scale, s);
  return (int)cudaErrorInvalidValue;
}
