// Single-query decode attention over a paged KV pool, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention` (`_kernel`) of
// src/repro/kernels/paged_attention/paged_attention.py.
//
// q (B, H, D); k_pages/v_pages (P, page, Hk, D); page_table (B, MP) int32;
// lengths (B,) int32; o (B, H, D). float32 or bfloat16, contiguous, K/V
// 16-byte aligned; D in {32, 64, 128, 160, 256}. Row b attends to
// positions [0, lengths[b]) of the pages page_table[b, 0..].
//
// Bound on the H100: decode reads every live K/V byte once for 4*G*D
// operations per position, about 2 operations per byte in bf16, so it is
// bound by memory bytes (B=8, Hk=8, D=128, lengths 1..1024: 15.4 MB of live
// K/V, 4.6 us at 3.35 TB/s). What matters is wide loads, enough of them in
// flight, and a short critical path per tile once they land.
//
// Design.
// - Grid (split, kv head, row). A split is `pps` consecutive entries of the
//   row's page table; the host plans pps and the split count from static
//   shapes only (ops.py::plan), since lengths live on the device. A block
//   whose first position is at or past lengths[b] exits at once and writes
//   nothing the merge reads (the merge counts a row's live splits itself).
//   The block copies its split's page-table entries to shared memory once.
// - K and V tiles of TT positions (64 for rows of 256 bytes) go global ->
//   shared through cp.async, 16 bytes a thread (a 256-byte bf16 row of one
//   kv head is 16 neighbouring threads), into a ring of two tiles: the
//   next tile is in flight while one is used. Each row resolves its own page,
//   so a tile may span pages of any size. cp.async rather than TMA: a tile
//   gathers rows from pages the table scatters, which per-thread addresses
//   express directly, and a TMA descriptor encoded on the host per call
//   would add to a wrapper that is already most of the call's time.
//   Positions past the split are zero-filled (src-size 0), so a masked V
//   row is 0, never garbage. Row r's 16-byte word c is stored at word
//   c ^ (r & SWZ), so a warp reading one word of 32 rows hits distinct
//   banks.
// - The G = H / Hk query heads of the kv head share the block: q is read
//   once, pre-scaled, into shared memory, and every staged K/V byte is read
//   from shared memory by all G heads.
// - One online softmax (running max m, sum l, float32) across the block's
//   tiles, in three barrier-separated steps a tile: scores (a thread a
//   position and its share of the heads, the whole dot product over D with
//   four independent partial sums), the tile's max and sum (a warp a head), and
//   P.V (a thread owns VEC consecutive d columns of one head and a share of
//   the positions, reads V rows as 16-byte words, and keeps its sums in
//   registers). D is a template parameter, so every loop has a fixed trip
//   count and unrolls.
// - One split: the block writes o. More: float32 partials (acc; m, l) and a
//   merge kernel that folds the live splits by log-sum-exp in split order,
//   so two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int STAGES = 2;              // tiles in the ring
constexpr int MAX_OWN = 4;             // (head, 16-byte column) owners a thread
constexpr int MAX_PPS = 64;            // page-table entries of a split
constexpr float NEG = -1e30f;

template <typename T, int D>
struct Cfg {
  static constexpr int VEC = 16 / sizeof(T);        // elements a word
  static constexpr int NC = D / VEC;                // words a row
  static constexpr int ROWB = D * (int)sizeof(T);
  static constexpr int TT = ROWB <= 256 ? 64 : ROWB <= 512 ? 32 : 16;
  static constexpr int GL = THREADS / TT;           // head lanes in scores
  static constexpr int SWZ = NC % 8 == 0 ? 7 : NC % 4 == 0 ? 3
                           : NC % 2 == 0 ? 1 : 0;
  static constexpr int RING = STAGES * TT * D * (int)sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// positions are shared among token_groups(owners) thread groups when the
// (head, word) owners are fewer than the threads
__host__ __device__ inline int token_groups(int owners) {
  return owners >= THREADS ? 1 : THREADS / owners;
}

struct Smem {                          // byte offsets of the dynamic smem
  int k, v, red, q, p, stat, pt, total;
  __host__ __device__ Smem(int G, int D, int ring, int TT, int VEC) {
    const int owners = G * (D / VEC);
    const int red_bytes = token_groups(owners) * owners * VEC * 4;
    k = 0;
    v = ring;
    red = 0;                           // reuses the ring once it is drained
    q = ((2 * ring > red_bytes ? 2 * ring : red_bytes) + 15) & ~15;
    p = q + G * D * 4;
    stat = p + G * TT * 4;
    pt = stat + 3 * G * 4;
    total = pt + MAX_PPS * 4;
  }
};

template <typename T, int D>
Smem smem_of(int G) {
  using C = Cfg<T, D>;
  return Smem(G, D, C::RING, C::TT, C::VEC);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_split(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp,
                   const int* __restrict__ page_table,
                   const int* __restrict__ lengths, T* __restrict__ o,
                   float* __restrict__ part, int H, int Hk, int page, int MP,
                   int pps, int n_split, float scale) {
  using C = Cfg<T, D>;
  constexpr int VEC = C::VEC, NC = C::NC, TT = C::TT, SWZ = C::SWZ;
  const int G = H / Hk;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = Smem(G, D, C::RING, TT, VEC);
  T* ks = reinterpret_cast<T*>(smem + L.k);       // [STAGES][TT][D]
  T* vs = reinterpret_cast<T*>(smem + L.v);
  float* qs = reinterpret_cast<float*>(smem + L.q);   // [G][D], scaled
  float* ps = reinterpret_cast<float*>(smem + L.p);   // [G][TT]
  float* m_s = reinterpret_cast<float*>(smem + L.stat);
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* pt_s = reinterpret_cast<int*>(smem + L.pt);

  // the row's length, the split's page-table entries and q are loaded
  // together, before the test for a dead split, so their latencies overlap
  const int len = lengths[b];
  const int first_page = split * pps;
  const int* ptb = page_table + (long)b * MP + first_page;
  const int pte = tid < pps && first_page + tid < MP ? ptb[tid] : 0;
  const T* qb = q + ((long)b * H + (long)hk * G) * D;
  for (int i = tid; i < G * D; i += THREADS) qs[i] = to_f(qb[i]) * scale;
  const int lo = first_page * page;
  const int hi = min(min(len, MP * page), lo + pps * page);
  T* ob = o + ((long)b * H + (long)hk * G) * D;
  if (lo >= hi) {                      // no live position in this split
    if (n_split == 1)                  // (only when len <= 0) o = 0
      for (int i = tid; i < G * D; i += THREADS) store(&ob[i], 0.f);
    return;
  }
  if (tid < pps) pt_s[tid] = pte;
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int ntiles = (hi - lo + TT - 1) / TT;
  const long tok_stride = (long)Hk * D;
  const long head_off = (long)hk * D;
  // this thread's copies: word cw of rows r0 + k * RSTEP (threads past
  // RSTEP whole rows copy nothing)
  constexpr int RSTEP = THREADS / NC;
  constexpr int NCOPY = (TT + RSTEP - 1) / RSTEP;
  const int cw = tid % NC, r0 = tid < RSTEP * NC ? tid / NC : TT;
  const int pshift = (page & (page - 1)) ? -1 : __ffs(page) - 1;

  auto issue = [&](int t) {
    if (t < ntiles) {
      const int start = lo + t * TT;
      T* kd = ks + (t % STAGES) * TT * D;
      T* vd = vs + (t % STAGES) * TT * D;
#pragma unroll
      for (int k = 0; k < NCOPY; ++k) {
        const int r = r0 + k * RSTEP;
        if (r < TT) {
          const int pos = start + r;
          const bool ok = pos < hi;
          long off = 0;
          if (ok) {
            const int pi = pshift >= 0 ? pos >> pshift : pos / page;
            off = ((long)pt_s[pi - first_page] * page + (pos - pi * page))
                  * tok_stride + head_off + cw * VEC;
          }
          const int dw = r * D + (cw ^ (r & SWZ)) * VEC;
          cp_async16(kd + dw, kp + off, ok);
          cp_async16(vd + dw, vp + off, ok);
        }
      }
    }
    cp_commit();                       // an empty group keeps the count
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // score mapping: row sr, heads sg0 + GL * k
  const int sr = tid % TT, sg0 = tid / TT;
  const int n_sh = sg0 < G ? (G - sg0 + C::GL - 1) / C::GL : 0;
  // P.V mapping: owner (g, c) and token group
  const int owners = G * NC;
  const int TS = token_groups(owners);
  const int tsub = owners >= THREADS ? 0 : tid / owners;
  const bool pv_live = tsub < TS;
  const int n_own = (owners + THREADS - 1) / THREADS;
  float acc[MAX_OWN][VEC];
#pragma unroll
  for (int k = 0; k < MAX_OWN; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();                   // tile t landed; tile t-1 is done
    issue(t + STAGES - 1);
    const int start = lo + t * TT;
    const int nr = min(TT, hi - start);
    const T* kt = ks + (t % STAGES) * TT * D;
    const T* vt = vs + (t % STAGES) * TT * D;

    // ---- scores s[g][r] = q_g . k_r (q pre-scaled), whole rows a thread
    {
      const T* kr = kt + sr * D;
      for (int k = 0; k < n_sh; ++k) {
        const int g = sg0 + k * C::GL;
        const float* qg = qs + g * D;
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float kv[VEC];
          unpack(*reinterpret_cast<const uint4*>(
                     kr + (c ^ (sr & SWZ)) * VEC), kv, T());
          const float4* qv = reinterpret_cast<const float4*>(qg + c * VEC);
#pragma unroll
          for (int e4 = 0; e4 < VEC / 4; ++e4) {
            const float4 w = qv[e4];
            dot[0] = fmaf(w.x, kv[4 * e4], dot[0]);
            dot[1] = fmaf(w.y, kv[4 * e4 + 1], dot[1]);
            dot[2] = fmaf(w.z, kv[4 * e4 + 2], dot[2]);
            dot[3] = fmaf(w.w, kv[4 * e4 + 3], dot[3]);
          }
        }
        ps[g * TT + sr] = (dot[0] + dot[1]) + (dot[2] + dot[3]);
      }
    }
    __syncthreads();

    // ---- online softmax, one warp a head
    for (int g = warp; g < G; g += NWARPS) {
      constexpr int PL = (TT + 31) / 32;   // positions a lane
      float s[PL];
      float mx = NEG;
#pragma unroll
      for (int u = 0; u < PL; ++u) {
        const int r = lane + 32 * u;
        s[u] = r < nr ? ps[g * TT + r] : NEG;
        mx = fmaxf(mx, s[u]);
      }
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < PL; ++u) {
        const int r = lane + 32 * u;
        const float p = r < nr ? expf(s[u] - m_new) : 0.f;
        if (r < TT) ps[g * TT + r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        a_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // ---- acc = alpha acc + P V over this thread's positions (rows past
    // the live ones have p = 0 and zero-filled V)
    if (pv_live) {
#pragma unroll
      for (int k = 0; k < MAX_OWN; ++k) {
        if (k >= n_own) break;
        const int ow = owners >= THREADS ? tid + k * THREADS : tid % owners;
        if (ow >= owners) break;
        const int g = ow / NC, c = ow - g * NC;
        const float a = a_s[g];
        float x0[VEC], x1[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          x0[e] = acc[k][e] * a;
          x1[e] = 0.f;
        }
        const float* pg = ps + g * TT;
#pragma unroll 4
        for (int r = tsub; r < TT; r += 2 * TS) {
          float v0[VEC], v1[VEC];
          const int r1 = r + TS;
          unpack(*reinterpret_cast<const uint4*>(
                     vt + r * D + (c ^ (r & SWZ)) * VEC), v0, T());
          const float p0 = pg[r];
          float p1 = 0.f;
          if (r1 < TT) {
            unpack(*reinterpret_cast<const uint4*>(
                       vt + r1 * D + (c ^ (r1 & SWZ)) * VEC), v1, T());
            p1 = pg[r1];
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) v1[e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            x0[e] = fmaf(p0, v0[e], x0[e]);
            x1[e] = fmaf(p1, v1[e], x1[e]);
          }
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[k][e] = x0[e] + x1[e];
      }
    }
  }
  cp_wait<0>();
  __syncthreads();                     // the ring is free for the reduction

  if (pv_live) {
#pragma unroll
    for (int k = 0; k < MAX_OWN; ++k) {
      if (k >= n_own) break;
      const int ow = owners >= THREADS ? tid + k * THREADS : tid % owners;
      if (ow >= owners) break;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        red[(tsub * owners + ow) * VEC + e] = acc[k][e];
    }
  }
  __syncthreads();

  // partials: acc (B, Hk, n_split, G, D), then (m, l) (B, Hk, n_split, G, 2)
  const long rec = ((long)b * Hk + hk) * n_split + split;
  float* pa = part + rec * G * D;
  float* pml = part + (long)gridDim.z * Hk * n_split * G * D + rec * G * 2;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    const int ow = g * NC + d / VEC, e = d % VEC;
    float v = 0.f;
    for (int ts = 0; ts < TS; ++ts) v += red[(ts * owners + ow) * VEC + e];
    if (n_split == 1)
      store(&ob[i], v / l_s[g]);
    else
      pa[i] = v;
  }
  if (n_split > 1)
    for (int g = tid; g < G; g += THREADS) {
      pml[2 * g] = m_s[g];
      pml[2 * g + 1] = l_s[g];
    }
}

// o[b, hk*G + g, :] from the live splits' partials of (b, hk), folded in
// split order by an online log-sum-exp; a row with no live position gets 0.
// A thread owns 4 consecutive columns of one head.
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_merge(const float* __restrict__ part, const int* __restrict__ lengths,
            T* __restrict__ o, int B, int H, int Hk, int D, int page, int MP,
            int pps, int n_split) {
  const int G = H / Hk;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int live = min(lengths[b], MP * page);
  const int split_tok = pps * page;
  const int n_live = live > 0 ? min(n_split, (live + split_tok - 1)
                                                 / split_tok) : 0;
  const long rec0 = ((long)b * Hk + hk) * n_split;
  const float* pa = part + rec0 * G * D;
  const float* pml = part + (long)B * Hk * n_split * G * D + rec0 * G * 2;
  T* ob = o + ((long)b * H + (long)hk * G) * D;
  for (int i = threadIdx.x; i < G * D / 4; i += THREADS) {
    const int g = (4 * i) / D;
    float M = NEG, den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < n_live; ++s) {
      const float2 ml =
          *reinterpret_cast<const float2*>(pml + ((long)s * G + g) * 2);
      const float4 a = *reinterpret_cast<const float4*>(
          pa + (long)s * G * D + 4 * i);
      const float m_new = fmaxf(M, ml.x);
      const float r = expf(M - m_new), w = expf(ml.x - m_new);
      num.x = fmaf(w, a.x, num.x * r);
      num.y = fmaf(w, a.y, num.y * r);
      num.z = fmaf(w, a.z, num.z * r);
      num.w = fmaf(w, a.w, num.w * r);
      den = fmaf(w, ml.y, den * r);
      M = m_new;
    }
    const float inv = n_live ? 1.f / den : 0.f;
    store(&ob[4 * i], num.x * inv);
    store(&ob[4 * i + 1], num.y * inv);
    store(&ob[4 * i + 2], num.z * inv);
    store(&ob[4 * i + 3], num.w * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* page_table, const int* lengths, float* part,
                   void* o, int B, int H, int Hk, int page, int MP, int pps,
                   int n_split, float scale, cudaStream_t stream) {
  const size_t bytes = smem_of<T, D>(H / Hk).total;
  static int set_bytes[64] = {};       // set once a device and size
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || (int)bytes > set_bytes[dev]) {
    err = cudaFuncSetAttribute(paged_decode_split<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) set_bytes[dev] = (int)bytes;
  }
  paged_decode_split<T, D><<<dim3(n_split, Hk, B), THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), page_table, lengths, static_cast<T*>(o),
      part, H, Hk, page, MP, pps, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  paged_merge<T><<<dim3(Hk, B), THREADS, 0, stream>>>(
      part, lengths, static_cast<T*>(o), B, H, Hk, D, page, MP, pps,
      n_split);
  return cudaGetLastError();
}

template <typename T, int D>
bool fits(int G) {
  using C = Cfg<T, D>;
  return G * C::NC <= MAX_OWN * THREADS
      && smem_of<T, D>(G).total <= 227 * 1024;
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const int* pt,
             const int* ln, float* part, void* o, int B, int H, int Hk,
             int D, int page, int MP, int pps, int n_split, float scale,
             cudaStream_t s) {
  const int G = H / Hk;
#define PAGED_CASE(DD)                                                    \
  case DD:                                                                \
    if (!fits<T, DD>(G)) break;                                           \
    return (int)launch<T, DD>(q, kp, vp, pt, ln, part, o, B, H, Hk, page, \
                              MP, pps, n_split, scale, s);
  switch (D) {
    PAGED_CASE(32)
    PAGED_CASE(64)
    PAGED_CASE(128)
    PAGED_CASE(160)
    PAGED_CASE(256)
  }
#undef PAGED_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The plan (ops.py::plan): splits of
// ``pps`` pages (at most 64), ``n_split`` of them; ``part`` is float32
// scratch of B*Hk*n_split*(H/Hk)*(D+2) values, unused (may be null) when
// n_split is 1. Returns the launches' cudaError_t.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* lengths, void* part,
                                      void* o, int B, int H, int Hk, int D,
                                      int page, int MP, int pps, int n_split,
                                      float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hk <= 0 || H % Hk != 0 || page <= 0 || pps <= 0 || pps > MAX_PPS
      || n_split <= 0 || (long)(n_split - 1) * pps >= MP
      || (long)n_split * pps < MP || n_split > 65535 || Hk > 65535
      || B > 65535 || (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_table);
  const int* ln = static_cast<const int*>(lengths);
  float* pp = static_cast<float*>(part);
  if (dtype == 0)
    return dispatch<float>(q, k_pages, v_pages, pt, ln, pp, o, B, H, Hk, D,
                           page, MP, pps, n_split, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k_pages, v_pages, pt, ln, pp, o, B, H,
                                   Hk, D, page, MP, pps, n_split, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Registers, local-memory (spill) bytes and the dynamic shared memory of
// the split kernel at head_dim 128 for (dtype, G), as the CUDA runtime
// reports them.
extern "C" int paged_attention_attrs(int dtype, int G, int* regs, int* local,
                                     int* smem) {
  cudaFuncAttributes a;
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncGetAttributes(&a, paged_decode_split<float, 128>);
    *smem = smem_of<float, 128>(G).total;
  } else {
    err = cudaFuncGetAttributes(&a, paged_decode_split<__nv_bfloat16, 128>);
    *smem = smem_of<__nv_bfloat16, 128>(G).total;
  }
  *regs = a.numRegs;
  *local = (int)a.localSizeBytes;
  return (int)err;
}
