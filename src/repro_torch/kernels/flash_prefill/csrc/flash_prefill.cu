// Causal GQA flash attention for prefill, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_prefill/
// flash_prefill.py: `flash_prefill` (`_kernel`, static q_offset) and
// `flash_prefill_dyn` (`_dyn_kernel`, q_offset known only at run time).
// Here q_offset is always a launch argument, so one kernel serves both.
//
// Layout is the model's: q/o (B, Sq, H, D), k/v (B, T, Hk, D), contiguous,
// float32 or bfloat16; query row i sits at absolute position q_offset + i,
// kv row j at j. Query head h reads kv head h / (H / Hk) (GQA); no K/V is
// duplicated in memory. The softmax is float32 throughout; output is in q's
// dtype. A block walks its kv tiles from the sliding-window bound to the
// causal bound, carrying the online-softmax state in registers (the TPU
// carried it across a sequential grid axis in VMEM).
//
// Routes, chosen by shape in `dispatch` (never as a fallback on failure):
//   bfloat16, D in {64, 128}, H / Hk <= 64: `flash_fwd_wgmma` (+ the
//     `flash_fwd_merge` pass when the kv walk is split) — the serving path;
//   bfloat16, D in {32, 160} (or H / Hk > 64): `flash_fwd_mma`, mma.sync
//     m16n8k16 tiles, one block per (b, query head, 64-row query tile);
//   float32 (the CPU-parity sizes): `flash_fwd`, CUDA-core FMAs.
//
// What bounds it. At the engine's chunk shapes (<= 1024 cached positions,
// 256-token chunks, qwen3-1.7b's 16/8 heads of 128) the work is ~4*Sq*T*H*D
// operations against (2*Sq*H + 2*T*Hk)*D*2 bytes: at a 256-token chunk at
// offset 512, 1.6 us of HBM time (5.2 MB) against 1.4 us of bf16 tensor-
// core time (1.3 GFLOP), so bytes set the card's floor; in practice the
// latency of a few dependent tile loads and the launch itself dominate.
//
// `flash_fwd_wgmma`, and what it does about what held `flash_fwd_mma` back:
//  1. Loads overlap compute: one producer warp keeps 2-stage rings of K
//     and of V tiles (64 kv rows, in 64-column halves of 128 bytes,
//     128-byte swizzled) in flight with TMA (cp.async.bulk.tensor, 4-d
//     tensor maps over the model layout), completing on `mbarrier`s with
//     expect_tx; the consumer warpgroup frees K(t) as soon as S(t) is done
//     and V(t) after P(t) V(t), each on its own "empty" barrier. Q is
//     loaded once. Out-of-range rows arrive zero-filled and are masked.
//  2. The grid fills the card: a block owns (b, kv head, query tile, kv
//     split). When (b, kv head, query tile) alone gives fewer blocks than
//     the two an SM holds, the kv walk of each tile is split (split-KV)
//     and each split writes a float32 partial (o, m, l) to scratch that
//     `flash_fwd_merge` combines by log-sum-exp (a split that sees no live
//     key for a row has m = -1e30, l = 0 and weight 0). The plan (query
//     tile, splits) is made by `plan` in ops.py and passed in. A second
//     small launch merged faster than the last split of each tile did
//     after an atomic ticket.
//  3. GQA reads each K/V tile once per kv head: the 64 rows of a tile are
//     the G = H / Hk query heads x 64 / G query positions that share one kv
//     head (row r = position r / G, head r % G, as a TMA box over (D, H,
//     Sq) lands them).
//  4. Both products run on wgmma: S = Q K^T as m64n64k16 with Q and K in
//     shared memory (K-major, the natural B operand); O += P V as
//     m64n64k16 per 64-column half of D with P from registers (the S
//     accumulator repacked as the A fragment) and V in shared memory with
//     the transpose-B bit (V is MN-major). P stays ~16 bits as a bf16 hi +
//     lo pair (two P V products), as close as bf16 inputs allow to the
//     float32 P V of the TPU kernel.
//  5. Only tiles that cross the causal diagonal, the window edge or the end
//     of the cache compare per element; inner tiles skip the mask.
//  6. The host side: the C entry encodes three tensor maps per call
//     through cuTensorMapEncodeTiled, fetched once with
//     cudaGetDriverEntryPointByVersion (no -lcuda), and sets the shared-
//     memory attribute once per device; ops.py sets the ctypes signature
//     once when the library loads, caches the plan and keeps the scratch.
// Each block is 5 warps (consumer warpgroup + producer warp), 81 KB of
// shared memory at D = 128, two blocks per SM; a tile's S, softmax and
// P V run in series inside the warpgroup, the other block fills the gaps.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;                 // query rows per block
constexpr int BK = 32;                 // kv rows per tile
constexpr int THREADS = 128;
constexpr int TPR = THREADS / BQ;      // threads per query row
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int Hk, int Sq,
          int Tk, int q_offset, int window, float scale) {
  static_assert(D % TPR == 0, "head_dim must be a multiple of 4");
  constexpr int DP = D + 1;            // padded smem row stride
  constexpr int NACC = D / TPR;        // accumulators per thread
  constexpr int NC = BK / TPR;         // scores per thread per tile
  extern __shared__ float smem[];
  float* sq = smem;                    // BQ x DP
  float* sk = sq + BQ * DP;            // BK x DP
  float* sv = sk + BK * DP;            // BK x D
  float* sp = sv + BK * D;             // BQ x (BK + 1) probabilities

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;

  const long q_stride = (long)H * D;   // between sequence positions
  const long kv_stride = (long)Hk * D;
  const T* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const T* kb = k + (long)b * Tk * kv_stride + (long)hk * D;
  const T* vb = v + (long)b * Tk * kv_stride + (long)hk * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    sq[r * DP + d] = (q0 + r < Sq) ? to_f(qb[(q0 + r) * q_stride + d]) : 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = min(Tk, q_offset + q_last + 1);           // causal
  int kv_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;

  const bool row_ok = q0 + row < Sq;
  const int qpos = q_offset + q0 + row;
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
  float m_i = NEG, l_i = 0.f;

  for (int kt = kv_begin; kt < kv_end; kt += BK) {
    __syncthreads();                   // previous tile fully consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (kt + r < Tk) {
        const long off = (kt + r) * kv_stride + d;
        kx = to_f(kb[off]);
        vx = to_f(vb[off]);
      }
      sk[r * DP + d] = kx;
      sv[r * D + d] = vx;
    }
    __syncthreads();

    float s[NC];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = sub + TPR * j;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot += sq[row * DP + d] * sk[c * DP + d];
      dot *= scale;
      const int kpos = kt + c;
      const bool ok = row_ok && kpos < Tk && kpos <= qpos &&
                      (window <= 0 || kpos > qpos - window);
      s[j] = ok ? dot : NEG;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float p = s[j] > 0.5f * NEG ? expf(s[j] - m_new) : 0.f;
      sp[row * (BK + 1) + sub + TPR * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = alpha * l_i + psum;
    m_i = m_new;
    __syncwarp();                      // a row's 4 threads share one warp
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = sp[row * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NACC; ++j) acc[j] += p * sv[c * D + sub + TPR * j];
    }
  }

  if (row_ok) {
    const float l = fmaxf(l_i, 1e-30f);
    T* ob = o + ((long)b * Sq + q0 + row) * q_stride + (long)h * D;
#pragma unroll
    for (int j = 0; j < NACC; ++j) store(&ob[sub + TPR * j], acc[j] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hk, int Sq, int Tk, int q_offset,
                   int window, float scale, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hk, Sq, Tk, q_offset,
      window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------- bf16: tensor cores

constexpr int MWARPS = 4;
constexpr int MBQ = 16 * MWARPS;       // query rows per block
constexpr int MBK = 64;                // kv rows per tile
constexpr int MTHREADS = 32 * MWARPS;

template <int D>
constexpr int mma_smem_bytes() {
  return (int)sizeof(__nv_bfloat16) * (MBQ + 2 * MBK) * (D + 8);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16 pair of (x, y) rounded to nearest; the rounding residues go to lx, ly
__device__ __forceinline__ uint32_t split_bf16(float x, float y, float& lx,
                                               float& ly) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  lx = x - __low2float(v);
  ly = y - __high2float(v);
  return *reinterpret_cast<uint32_t*>(&v);
}

// B fragments of an m16n8k16 product whose B (k x n) is stored row-major
// as rows k (kv positions) of n-contiguous values: ldmatrix .trans
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1,
                                              const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(a));
}

template <int D>
__global__ void __launch_bounds__(MTHREADS)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int H, int Hk, int Sq, int Tk,
              int q_offset, int window, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DS = D + 8;            // padded smem row (bf16)
  constexpr int KSTEPS = D / 16;
  constexpr int NT = MBK / 8;          // score n-tiles per kv tile
  constexpr int DT = D / 8;            // output n-tiles
  constexpr int VEC = 8;               // bf16 per 16-byte access
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + MBQ * DS;
  __nv_bfloat16* Vs = Ks + MBK * DS;

  const int q0 = blockIdx.x * MBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;             // fragment row group
  const int t4 = lane & 3;             // thread in group
  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hk * D;
  const __nv_bfloat16* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const __nv_bfloat16* kb = k + (long)b * Tk * kv_stride + (long)hk * D;
  const __nv_bfloat16* vb = v + (long)b * Tk * kv_stride + (long)hk * D;

  for (int i = tid; i < MBQ * (D / VEC); i += MTHREADS) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq)
      x = *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_stride + c);
    *reinterpret_cast<uint4*>(Qs + r * DS + c) = x;
  }
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* p = Qs + (wr + g) * DS + kk * 16 + t4 * 2;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * DS);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * DS + 8);
  }

  const int qpos0 = q_offset + q0 + wr + g;     // rows g and g + 8
  const int q_last = min(q0 + MBQ, Sq) - 1;
  const int kv_end = min(Tk, q_offset + q_last + 1);
  int kv_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  kv_begin = (kv_begin / MBK) * MBK;

  float oacc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_r[2] = {NEG, NEG};
  float l_r[2] = {0.f, 0.f};

  for (int kt = kv_begin; kt < kv_end; kt += MBK) {
    __syncthreads();                   // previous tile fully consumed
    for (int i = tid; i < MBK * (D / VEC); i += MTHREADS) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (kt + r < Tk) {
        const long off = (kt + r) * kv_stride + c;
        kx = *reinterpret_cast<const uint4*>(kb + off);
        vx = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * DS + c) = kx;
      *reinterpret_cast<uint4*>(Vs + r * DS + c) = vx;
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* p = Ks + (j * 8 + g) * DS + kk * 16 + t4 * 2;
        mma16816(s[j], qf[kk], ld32(p), ld32(p + 8));
      }
    }
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kt + j * 8 + t4 * 2 + (e & 1);
        const int qp = qpos0 + 8 * (e >> 1);
        const bool ok = kpos < Tk && kpos <= qp &&
                        (window <= 0 || kpos > qp - window);
        s[j][e] = ok ? s[j][e] * scale : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x > 0.5f * NEG ? expf(x - m_r[e >> 1]) : 0.f;
        s[j][e] = p;
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l_r[r] = alpha[r] * l_r[r] + psum[r];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < MBK / 16; ++kc) {
      // P as a bf16 pair hi + lo: the P V product keeps ~16 bits of each
      // probability, as close to the float32 reference as bf16 inputs allow
      const float* p0 = s[2 * kc];
      const float* p1 = s[2 * kc + 1];
      float lo[8];
      const uint32_t hi[4] = {split_bf16(p0[0], p0[1], lo[0], lo[1]),
                              split_bf16(p0[2], p0[3], lo[2], lo[3]),
                              split_bf16(p1[0], p1[1], lo[4], lo[5]),
                              split_bf16(p1[2], p1[3], lo[6], lo[7])};
      const uint32_t lw[4] = {pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]),
                              pack_bf16(lo[4], lo[5]), pack_bf16(lo[6], lo[7])};
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, Vs + (kc * 16 + (lane & 15)) * DS + n * 8);
        mma16816(oacc[n], hi, b0, b1);
        mma16816(oacc[n], lw, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row < Sq) {
      const float l = fmaxf(l_r[r], 1e-30f);
      __nv_bfloat16* ob = o + ((long)b * Sq + row) * q_stride + (long)h * D;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<uint32_t*>(ob + n * 8 + t4 * 2) =
            pack_bf16(oacc[n][2 * r] / l, oacc[n][2 * r + 1] / l);
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int Hk, int Sq, int Tk, int q_offset,
                       int window, float scale, cudaStream_t stream) {
  const int bytes = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + MBQ - 1) / MBQ, H, B);
  flash_fwd_mma<D><<<grid, MTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, Hk, Sq, Tk, q_offset, window, scale);
  return cudaGetLastError();
}

// ------------------------------------------- bf16: TMA ring + wgmma route

constexpr int WT = 64;                 // rows of a query tile and a kv tile
constexpr int WSTAGES = 2;             // K/V ring depth
constexpr int WTHREADS = 160;          // consumer warpgroup + producer warp
constexpr int MAX_SPLIT = 8;           // kv splits of one query tile
constexpr int HALF_BYTES = WT * 64 * 2;  // 64 rows x 64 bf16 (128 B swizzle)

template <int D>
constexpr int wgmma_smem_bytes() {
  // 1 KB to align the tiles to the swizzle pattern, Q, the K and V rings,
  // 4 * WSTAGES + 1 barriers
  return 1024 + (D / 64) * HALF_BYTES * (1 + 2 * WSTAGES) + 8 * 16;
}

struct WParams {
  __nv_bfloat16* o;
  float* part;                         // split partials: o, then (m, l)
  int H, Hk, G, Sq, Tk, q_offset, window, qp, n_qt, n_split;
  float scale_log2;                    // softmax scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one TMA box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* m,
                                          uint32_t bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: rows of
// 128 B, 8-row groups 1024 B apart (SBO); LBO is the stride between
// 64-column blocks of an MN-major operand (unused when N = 64)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads of async-written registers
// across the wgmma wait
template <int N>
__device__ __forceinline__ void reg_fence(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) . B (16 x 64, smem,
// K-major: B^T rows contiguous in k)
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, smem, MN-major:
// rows of B contiguous in n; the transpose-B bit)
__device__ __forceinline__ void wgmma_rs_tb(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// kv tiles [t0, t1) of query tile qt, split `split` of n_split (the same
// arithmetic as ops.py: kv_tile_range, split_range)
__device__ __forceinline__ void kv_split(const WParams& p, int qt, int split,
                                         int& t0, int& t1) {
  const int q0 = qt * p.qp;
  const int q_last = min(q0 + p.qp, p.Sq) - 1;
  const int kv_end = min(p.Tk, p.q_offset + q_last + 1);
  const int kv_begin =
      p.window > 0 ? max(0, p.q_offset + q0 - p.window + 1) : 0;
  const int a = kv_begin / WT;
  const int n = max(0, (kv_end + WT - 1) / WT - a);
  t0 = a + n * split / p.n_split;
  t1 = a + n * (split + 1) / p.n_split;
}

template <int D>
__global__ void __launch_bounds__(WTHREADS, 2)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const WParams p) {
  static_assert(D == 64 || D == 128, "wgmma route takes head_dim 64, 128");
  static_assert(WSTAGES <= 4, "barrier space");
  constexpr int NH = D / 64;           // 64-column halves of a row
  constexpr int TILE = NH * HALF_BYTES;  // bytes of a Q, K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sK = sQ + TILE;       // K ring, then V ring
  const uint32_t sV = sK + WSTAGES * TILE;
  const uint32_t bar = sV + WSTAGES * TILE;
  // K and V have rings of their own: K(t) frees when S(t) is done, V(t)
  // when P(t) V(t) is
  auto full_k = [&](int s) { return bar + 8 * s; };
  auto full_v = [&](int s) { return bar + 8 * (WSTAGES + s); };
  auto empty_k = [&](int s) { return bar + 8 * (2 * WSTAGES + s); };
  auto empty_v = [&](int s) { return bar + 8 * (3 * WSTAGES + s); };
  const uint32_t qbar = bar + 8 * 4 * WSTAGES;

  const int qt = p.n_qt - 1 - blockIdx.x;  // longest kv walks first
  const int hk = blockIdx.y;
  const int b = blockIdx.z / p.n_split;
  const int split = blockIdx.z % p.n_split;
  const int q0 = qt * p.qp;
  int t0, t1;
  kv_split(p, qt, split, t0, t1);
  const int n = t1 - t0;               // kv tiles of this block
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  if (tid == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 128);
      mbar_init(empty_v(s), 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {                     // producer: one thread issues TMA
    if ((tid & 31) == 0 && n > 0) {
      mbar_expect_tx(qbar, NH * 128 * p.G * p.qp);
#pragma unroll
      for (int h = 0; h < NH; ++h)
        tma_load4(sQ + h * HALF_BYTES, &tq, qbar, h * 64, hk * p.G, q0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % WSTAGES;
        const uint32_t par = ((i / WSTAGES) & 1) ^ 1;
        const int row = (t0 + i) * WT;
        mbar_wait(empty_k(s), par);
        mbar_expect_tx(full_k(s), TILE);
#pragma unroll
        for (int h = 0; h < NH; ++h)
          tma_load4(sK + s * TILE + h * HALF_BYTES, &tk, full_k(s), h * 64,
                    hk, row, b);
        mbar_wait(empty_v(s), par);
        mbar_expect_tx(full_v(s), TILE);
#pragma unroll
        for (int h = 0; h < NH; ++h)
          tma_load4(sV + s * TILE + h * HALF_BYTES, &tv, full_v(s), h * 64,
                    hk, row, b);
      }
    }
    return;
  }

  // consumer warpgroup: thread holds rows r0 and r0 + 8 of the tile
  const int lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;
  int qpos[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    qpos[rr] = p.q_offset + q0 + (r0 + 8 * rr) / p.G;
  const int qmin = p.q_offset + q0;
  const int qmax = p.q_offset + min(q0 + p.qp, p.Sq) - 1;
  const int kv_lim = min(p.Tk, qmin + 1);  // tiles below need no causal mask

  float oacc[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[h][i] = 0.f;
  float m_r[2] = {NEG, NEG};
  float l_r[2] = {0.f, 0.f};
  float sacc[32];                      // S(i)
  uint32_t hi[4][4], lo[4][4];         // P(i), read by the in-flight P V

  // One tile at a time: S(i), softmax, P(i) V(i), each waited for before
  // the next starts (a second block on the SM fills the gaps). Overlapping
  // S(i + 1) with the softmax of S(i) through `wgmma.wait_group 1` made
  // ptxas serialise every wgmma of the loop (C7514) and ran slower.
  if (n > 0) mbar_wait(qbar, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % WSTAGES;
    const uint32_t par = (i / WSTAGES) & 1;
    mbar_wait(full_k(s), par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // S(i) = Q K(i)^T
      const uint32_t off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
      wgmma_ss(sacc, sw128_desc(sQ + off, 16),
               sw128_desc(sK + s * TILE + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence<32>(sacc);
    mbar_arrive(empty_k(s));

    const int kt = (t0 + i) * WT;
    const bool inner = kt + WT <= kv_lim &&
                       (p.window <= 0 || kt > qmax - p.window);
    float mx[2] = {NEG, NEG};
    if (inner) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        sacc[e] *= p.scale_log2;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sacc[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int rr = (e >> 1) & 1;
        const int kpos = kt + (e >> 2) * 8 + t4 * 2 + (e & 1);
        const bool ok = kpos < p.Tk && kpos <= qpos[rr] &&
                        (p.window <= 0 || kpos > qpos[rr] - p.window);
        sacc[e] = ok ? sacc[e] * p.scale_log2 : NEG;
        mx[rr] = fmaxf(mx[rr], sacc[e]);
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m_r[rr], mx[rr]);
      alpha[rr] = exp2f(m_r[rr] - m_new);
      m_r[rr] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int rr = (e >> 1) & 1;
      const float pr = sacc[e] > 0.5f * NEG ? exp2f(sacc[e] - m_r[rr]) : 0.f;
      sacc[e] = pr;
      psum[rr] += pr;
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      psum[rr] += __shfl_xor_sync(0xffffffffu, psum[rr], 1);
      psum[rr] += __shfl_xor_sync(0xffffffffu, psum[rr], 2);
      l_r[rr] = alpha[rr] * l_r[rr] + psum[rr];
    }
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int e = 0; e < 32; ++e) oacc[h][e] *= alpha[(e >> 1) & 1];
    // P as the A fragments of four k16 steps, a bf16 hi + lo pair each:
    // accumulator n8 blocks 2kc, 2kc+1 are exactly k-step kc's fragment
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* x = sacc + 8 * kc + 4 * (j >> 1) + 2 * (j & 1);
        float l0, l1;
        hi[kc][j] = split_bf16(x[0], x[1], l0, l1);
        lo[kc][j] = pack_bf16(l0, l1);
      }
    }
    mbar_wait(full_v(s), par);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const uint64_t dv = sw128_desc(
            sV + s * TILE + h * HALF_BYTES + kc * 16 * 128, HALF_BYTES);
        wgmma_rs_tb(oacc[h], hi[kc], dv);
        wgmma_rs_tb(oacc[h], lo[kc], dv);
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int h = 0; h < NH; ++h) reg_fence<32>(oacc[h]);
    reg_fence<16>(&hi[0][0]);
    reg_fence<16>(&lo[0][0]);
    mbar_arrive(empty_v(s));
  }

  // epilogue: rows past Sq or past G x qp are never stored; with a split
  // walk the unnormalised (o, m, l) go to scratch for flash_fwd_merge
  const int nblk = gridDim.x * gridDim.y * (gridDim.z / p.n_split);
  const int blk = (b * p.Hk + hk) * p.n_qt + qt;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    const int pos = q0 + r / p.G;
    if (r >= p.G * p.qp || pos >= p.Sq) continue;
    if (p.n_split == 1) {
      const float inv = 1.f / fmaxf(l_r[rr], 1e-30f);
      __nv_bfloat16* ob =
          p.o + (((long)b * p.Sq + pos) * p.H + hk * p.G + r % p.G) * D;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(ob + h * 64 + j * 8 + t4 * 2) =
              pack_bf16(oacc[h][4 * j + 2 * rr] * inv,
                        oacc[h][4 * j + 2 * rr + 1] * inv);
    } else {
      const long row = ((long)split * nblk + blk) * WT + r;
      float* po = p.part + row * D;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(po + h * 64 + j * 8 + t4 * 2) =
              make_float2(oacc[h][4 * j + 2 * rr],
                          oacc[h][4 * j + 2 * rr + 1]);
      if (t4 == 0) {
        float2* pml = reinterpret_cast<float2*>(
            p.part + (long)p.n_split * nblk * WT * D);
        pml[row] = make_float2(m_r[rr], l_r[rr]);
      }
    }
  }
}

// combines the n_split partials (o, m, l) of each row by log-sum-exp (m in
// log2 units), in split order; a split with no live key for a row
// (m = -1e30) weighs 0. A thread merges 4 columns of one row.
template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_merge(const float* __restrict__ part, __nv_bfloat16* __restrict__ o,
                const WParams p, int nblk) {
  constexpr int TPR = D / 4;           // threads per row
  const int row = blockIdx.x * (128 / TPR) + threadIdx.x / TPR;
  const int c = (threadIdx.x % TPR) * 4;
  const int blk = row / WT, r = row % WT;
  const int qt = blk % p.n_qt;
  const int hk = (blk / p.n_qt) % p.Hk;
  const int b = blk / (p.n_qt * p.Hk);
  const int pos = qt * p.qp + r / p.G;
  if (row >= nblk * WT || r >= p.G * p.qp || pos >= p.Sq) return;
  const long stride = (long)nblk * WT;  // rows between two splits
  const float2* ml =
      reinterpret_cast<const float2*>(part + p.n_split * stride * D) + row;
  float2 x[MAX_SPLIT];                 // all loads issued before any use
  float4 y[MAX_SPLIT];
#pragma unroll
  for (int s = 0; s < MAX_SPLIT; ++s) {
    if (s < p.n_split) {
      x[s] = ml[s * stride];
      y[s] = *reinterpret_cast<const float4*>(part + (s * stride + row) * D
                                              + c);
    }
  }
  float mmax = NEG;
#pragma unroll
  for (int s = 0; s < MAX_SPLIT; ++s)
    if (s < p.n_split) mmax = fmaxf(mmax, x[s].x);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int s = 0; s < MAX_SPLIT; ++s) {
    if (s < p.n_split) {
      const float w = x[s].x > 0.5f * NEG ? exp2f(x[s].x - mmax) : 0.f;
      l += w * x[s].y;
      acc.x += w * y[s].x;
      acc.y += w * y[s].y;
      acc.z += w * y[s].z;
      acc.w += w * y[s].w;
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  *reinterpret_cast<uint2*>(
      o + (((long)b * p.Sq + pos) * p.H + hk * p.G + r % p.G) * D + c) =
      make_uint2(pack_bf16(acc.x * inv, acc.y * inv),
                 pack_bf16(acc.z * inv, acc.w * inv));
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once through the runtime
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                         12000, cudaEnableDefault,
                                         &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// 4-d map over a (B, S, heads, D) bf16 tensor, innermost first; a box is
// 64 columns (128 B, swizzled) x box_h heads x box_s positions x 1 batch
bool make_map(EncodeTiledFn enc, CUtensorMap* m, const void* ptr, int B,
              int S, int heads, int D, int box_h, int box_s) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_h, (cuuint32_t)box_s, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* part, int B, int H, int Hk, int Sq,
                         int Tk, int q_offset, int window, float scale,
                         int qp, int n_split, cudaStream_t stream) {
  const int G = H / Hk;
  if (qp < 1 || qp * G > WT || n_split < 1 || n_split > MAX_SPLIT ||
      (n_split > 1 && !part))
    return cudaErrorInvalidValue;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map(enc, &mq, q, B, Sq, H, D, G, qp) ||
      !make_map(enc, &mk, k, B, Tk, Hk, D, 1, WT) ||
      !make_map(enc, &mv, v, B, Tk, Hk, D, 1, WT))
    return cudaErrorInvalidValue;
  static unsigned attr_done = 0;       // bit per device: attribute set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int bytes = wgmma_smem_bytes<D>();
  if (dev >= 32 || !(attr_done >> dev & 1u)) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    if (dev < 32) attr_done |= 1u << dev;
  }
  WParams p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.part = part;
  p.H = H; p.Hk = Hk; p.G = G; p.Sq = Sq; p.Tk = Tk;
  p.q_offset = q_offset; p.window = window; p.qp = qp;
  p.n_qt = (Sq + qp - 1) / qp; p.n_split = n_split;
  p.scale_log2 = scale * 1.4426950408889634f;
  dim3 grid(p.n_qt, Hk, B * n_split);
  flash_fwd_wgmma<D><<<grid, WTHREADS, bytes, stream>>>(mq, mk, mv, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const int nblk = p.n_qt * Hk * B;
  flash_fwd_merge<D><<<nblk * WT / (128 / (D / 4)), 128, 0, stream>>>(
      part, p.o, p, nblk);
  return cudaGetLastError();
}

// the route is a switch on shape: bf16 at head_dim 64 or 128 with G <= 64
// query heads per kv head takes the wgmma kernel, other bf16 head dims the
// mma.sync one, float32 the CUDA-core one
cudaError_t dispatch(int D, int dtype, const void* q, const void* k,
                     const void* v, void* o, float* part, int B, int H,
                     int Hk, int Sq, int Tk, int q_offset, int window,
                     float scale, int qp, int n_split, cudaStream_t s) {
  const bool wg = dtype == 1 && H / Hk <= WT;
#define FLASH_SIMT(DD) \
  launch<float, DD>(q, k, v, o, B, H, Hk, Sq, Tk, q_offset, window, scale, s)
#define FLASH_MMA(DD) \
  launch_mma<DD>(q, k, v, o, B, H, Hk, Sq, Tk, q_offset, window, scale, s)
#define FLASH_WGMMA(DD)                                                 \
  launch_wgmma<DD>(q, k, v, o, part, B, H, Hk, Sq, Tk, q_offset, window, \
                   scale, qp, n_split, s)
  switch (D) {
    case 32: return dtype == 1 ? FLASH_MMA(32) : FLASH_SIMT(32);
    case 64:
      return dtype != 1 ? FLASH_SIMT(64) : wg ? FLASH_WGMMA(64) : FLASH_MMA(64);
    case 128:
      return dtype != 1 ? FLASH_SIMT(128)
                        : wg ? FLASH_WGMMA(128) : FLASH_MMA(128);
    case 160: return dtype == 1 ? FLASH_MMA(160) : FLASH_SIMT(160);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_SIMT
#undef FLASH_MMA
#undef FLASH_WGMMA
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no sliding window.
// qp (query positions per tile) and n_split (kv splits) come from ops.py's
// plan and are read by the wgmma route only; with n_split > 1 part is its
// float32 scratch of n_split * B * Hk * ceil(Sq / qp) * 64 * (D + 2)
// values (null otherwise). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* o, void* part,
                                    int B, int H, int Hk, int Sq, int Tk,
                                    int D, int q_offset, int window,
                                    float scale, int dtype, int qp,
                                    int n_split, void* stream) {
  if (H % Hk != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(D, dtype, q, k, v, o, static_cast<float*>(part), B,
                       H, Hk, Sq, Tk, q_offset, window, scale, qp, n_split,
                       static_cast<cudaStream_t>(stream));
}

// Registers, local-memory (spill) bytes and dynamic shared memory of the
// wgmma kernel at head_dim D, as the runtime reports them. Returns the
// cudaError_t (0 on success).
extern "C" int flash_prefill_wgmma_attrs(int D, int* regs, int* local_bytes,
                                         int* smem_bytes) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64) {
    err = cudaFuncGetAttributes(&a, flash_fwd_wgmma<64>);
    *smem_bytes = wgmma_smem_bytes<64>();
  } else if (D == 128) {
    err = cudaFuncGetAttributes(&a, flash_fwd_wgmma<128>);
    *smem_bytes = wgmma_smem_bytes<128>();
  }
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
