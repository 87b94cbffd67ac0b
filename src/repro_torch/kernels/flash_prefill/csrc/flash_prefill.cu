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
// duplicated in memory.
//
// Design. The TPU grid walked the kv blocks in order on one core and carried
// the online-softmax state in VMEM scratch. Blocks on Hopper run in parallel
// in no order, so one block owns a (b, h, query tile) and a loop inside it
// walks the kv tiles, keeping (m, l, acc) in registers. The loop starts at
// the sliding-window bound and stops at the causal bound instead of
// skipping dead blocks. The softmax is float32 throughout; output is in q's
// dtype.
//
// bfloat16 (the serving path): `flash_fwd_mma`, 4 warps per 64-row query
// tile, 16 rows per warp, 64-row kv tiles staged in padded shared memory.
// S = Q K^T and O += P V run on the tensor cores as mma.sync m16n8k16 (bf16
// in, f32 accumulate); the S accumulator fragments are repacked in registers
// as the A operand of P V, P split into a bf16 hi + lo pair so it keeps ~16
// bits (two P V products instead of one), and V's B fragments come from
// ldmatrix.trans. float32 (the CPU-parity sizes): `flash_fwd`, 32-row tiles,
// four threads per query row doing CUDA-core FMAs from shared memory.
//
// Bound on the H100: at long S the work is 4*S^2/2*D*H operations against
// ~(S*H*D + 2*S*Hk*D + S*H*D) elements moved, so prefill is compute-bound;
// at the engine's chunk shapes (<= 1024 positions) bytes and launch latency
// dominate. mma.sync reaches only part of the wgmma rate and the tiles are
// loaded without an async pipeline; TMA + wgmma is the later step.
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

cudaError_t dispatch(int D, int dtype, const void* q, const void* k,
                     const void* v, void* o, int B, int H, int Hk, int Sq,
                     int Tk, int q_offset, int window, float scale,
                     cudaStream_t s) {
#define FLASH_CASE(DD)                                                      \
  case DD:                                                                  \
    return dtype == 1 ? launch_mma<DD>(q, k, v, o, B, H, Hk, Sq, Tk,        \
                                       q_offset, window, scale, s)          \
                      : launch<float, DD>(q, k, v, o, B, H, Hk, Sq, Tk,     \
                                          q_offset, window, scale, s);
  switch (D) {
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(160)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no sliding window.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int Hk, int Sq, int Tk, int D,
                                    int q_offset, int window, float scale,
                                    int dtype, void* stream) {
  if (H % Hk != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(D, dtype, q, k, v, o, B, H, Hk, Sq, Tk, q_offset,
                       window, scale, static_cast<cudaStream_t>(stream));
}
