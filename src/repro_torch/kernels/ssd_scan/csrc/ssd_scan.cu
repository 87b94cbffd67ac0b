// Mamba-2 SSD chunked scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan` (`_kernel`) of
// src/repro/kernels/ssd_scan/ssd_scan.py.
//
// Model layout, float32, contiguous: x (B, S, H, P) already scaled by dt;
// la (B, S, H) log decay; Bm, Cm (B, S, H, N) per head; h0 (B, H, P, N) or
// null (zeros); outputs y (B, S, H, P) and h_final (B, H, P, N). S is a
// multiple of the chunk Q. Per (b, h) the chunks run in order; in chunk c,
// with cum the in-chunk prefix sum of la and state the (P, N) state before
// the chunk:
//   y_i    = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) x_j
//            + exp(cum_i) (C_i . state[p, :])
//   state <- exp(cum_last) state + sum_q exp(cum_last - cum_q) x_q (outer) B_q
// The decay is formed only where j <= i, so exp never sees a positive
// exponent (exp(+big) * 0 would be NaN).
//
// Design. The TPU kernel ran one grid step per (b, h, chunk), with the
// chunk axis sequential and the state in VMEM scratch. Here one block owns
// a (b, h, 16-column tile of P): y[:, p] and state[p, :] read only column p
// of x, so the P columns split across blocks, and each block recomputes the
// small Q x Q matrix C.B^T itself. That gives B*H*ceil(P/16) blocks (128 at
// batch 1 for mamba2-370m: H=32, P=64) instead of B*H = 32 on 132 SMs. A
// block walks its chunks in order with its 16 x N slice of the state in
// registers. Per chunk it stages B and C transposed (row stride Q+1, odd,
// so column walks hit distinct banks), x's 16 columns and the decayed
// C.B^T in shared memory: at Q = N = 128 that is 213 KB, one block per SM.
// C.B^T uses 8 x 8 register tiles whose rows and columns are strided by
// 16, so the loads of a warp are broadcasts or consecutive words, and the
// tiles above the diagonal are skipped at compile time.
//
// Bound on the H100: all float32 on the CUDA cores (a TF32 tensor-core
// path would break the 2e-4 float32 tolerance). At one 256-token chunk of
// full-width mamba2-370m (H=32, P=64, N=128, Q=128) the scan must move
// ~15 MB (~4.5 us at 3.35 TB/s) and do ~0.5 GFLOP of float32 work (~8 us
// at 67 TFLOP/s), so it is bound by operations. Recomputing C.B^T in each
// of the P/16 blocks of a head adds work the bound does not count.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PT = 16;           // p columns of a block
constexpr int MT = 8;            // register tile: 8 rows x 8 columns, stride 16
constexpr int MAXQ = 16 * MT;    // chunk length the tiles cover
constexpr int NK = 4;            // state columns of a thread: lane + 32k
constexpr int MAXN = 32 * NK;    // d_state the state registers cover

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// shared-memory layout, in floats
struct Layout {
  int qs, ms, bst, cst, m, xs, stt, cum, tail, wsum, total;
  __host__ __device__ Layout(int Q, int N) {
    qs = Q + 1;                  // row stride of B^T and C^T
    ms = Q + 4;                  // row stride of M (float4 rows)
    bst = 0;
    cst = bst + N * qs;
    m = round4(cst + N * qs);
    xs = m + Q * ms;
    stt = xs + Q * PT;           // state^T: [n][p], row stride PT + 1
    cum = stt + N * (PT + 1);
    tail = cum + Q;
    wsum = tail + Q;
    total = wsum + 4;
  }
};

__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ la,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ hT, int S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(Q, N);
  float* BsT = smem + L.bst;
  float* CsT = smem + L.cst;
  float* M = smem + L.m;
  float* xs = smem + L.xs;
  float* stT = smem + L.stt;
  float* cum = smem + L.cum;
  float* tail = smem + L.tail;
  float* wsum = smem + L.wsum;
  const int qs = L.qs, ms = L.ms;

  const int p0 = blockIdx.x * PT;
  const int np = min(PT, P - p0);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // row (b, s, h) of the (B, S, H, .) tensors
  auto row = [&](int s) { return ((size_t)b * S + s) * H + h; };

  // state[p0 + sp + a][lane + 32k], a < 2, in registers for the whole scan
  const int sp = warp * 2;
  float st[2][NK];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int n = lane + 32 * k;
      const bool ok = h0 != nullptr && sp + a < np && n < N;
      st[a][k] = ok ? h0[(((size_t)b * H + h) * P + p0 + sp + a) * N + n]
                    : 0.f;
      if (n < N) stT[n * (PT + 1) + sp + a] = st[a][k];
    }

  // C.B^T tile of this thread: rows ti + 16r, columns tj + 16c
  const int ti = tid >> 4, tj = tid & 15;
  // y of this thread: column yp, rows yg + 16r
  const int yp = tid & 15, yg = tid >> 4;

  for (int s0 = 0; s0 < S; s0 += Q) {
    // ---- stage the chunk
    for (int idx = tid; idx < Q * N; idx += THREADS) {
      const int q = idx / N, n = idx - q * N;
      const size_t g = row(s0 + q) * N + n;
      BsT[n * qs + q] = Bm[g];
      CsT[n * qs + q] = Cm[g];
    }
    for (int idx = tid; idx < Q * PT; idx += THREADS) {
      const int q = idx / PT, pt = idx - q * PT;
      xs[idx] = pt < np ? x[row(s0 + q) * P + p0 + pt] : 0.f;
    }
    // ---- cum: inclusive prefix sum of la over the chunk (warp scans)
    float v = 0.f;
    if (warp * 32 < Q) {
      v = tid < Q ? la[row(s0 + tid)] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) wsum[warp] = v;
    }
    __syncthreads();
    if (tid < Q) {
      for (int w = 0; w < warp; ++w) v += wsum[w];
      cum[tid] = v;
    }
    __syncthreads();
    if (tid < Q) tail[tid] = expf(cum[Q - 1] - cum[tid]);

    // ---- M = (C.B^T) * exp(cum_i - cum_j) for j <= i, else 0
    {
      float acc[MT][MT];
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int c = 0; c < MT; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[MT], bv[MT];
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const int i = ti + 16 * r;
          cv[r] = i < Q ? CsT[n * qs + i] : 0.f;
          const int j = tj + 16 * r;
          bv[r] = j < Q ? BsT[n * qs + j] : 0.f;
        }
        // column tile c > r lies wholly above the diagonal: skipped
#pragma unroll
        for (int r = 0; r < MT; ++r)
#pragma unroll
          for (int c = 0; c <= r; ++c)
            acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const int i = ti + 16 * r;
        if (i >= Q) continue;
#pragma unroll
        for (int c = 0; c < MT; ++c) {
          const int j = tj + 16 * c;
          if (j >= Q) continue;
          float val = 0.f;
          if (c <= r && j <= i) val = acc[r][c] * expf(cum[i] - cum[j]);
          M[i * ms + j] = val;
        }
      }
    }
    __syncthreads();

    // ---- y = M x + exp(cum) (C . state^T), from the state before the chunk
    {
      float yin[MT], yst[MT];
#pragma unroll
      for (int r = 0; r < MT; ++r) yin[r] = yst[r] = 0.f;
      for (int j = 0; j < Q; j += 4) {
        const float x0 = xs[(j + 0) * PT + yp], x1 = xs[(j + 1) * PT + yp];
        const float x2 = xs[(j + 2) * PT + yp], x3 = xs[(j + 3) * PT + yp];
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const int i = yg + 16 * r;
          if (i < Q) {
            const float4 m = *reinterpret_cast<const float4*>(&M[i * ms + j]);
            yin[r] = fmaf(m.x, x0, yin[r]);
            yin[r] = fmaf(m.y, x1, yin[r]);
            yin[r] = fmaf(m.z, x2, yin[r]);
            yin[r] = fmaf(m.w, x3, yin[r]);
          }
        }
      }
      for (int n = 0; n < N; ++n) {
        const float sv = stT[n * (PT + 1) + yp];
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const int i = yg + 16 * r;
          if (i < Q) yst[r] = fmaf(CsT[n * qs + i], sv, yst[r]);
        }
      }
      if (yp < np) {
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const int i = yg + 16 * r;
          if (i < Q)
            y[row(s0 + i) * P + p0 + yp] = yin[r] + expf(cum[i]) * yst[r];
        }
      }
    }

    // ---- state <- exp(cum_last) state + sum_q tail_q x_q (outer) B_q
    {
      const float decay = expf(cum[Q - 1]);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int k = 0; k < NK; ++k) st[a][k] *= decay;
      for (int q = 0; q < Q; ++q) {
        const float w = tail[q];
        const float xa = xs[q * PT + sp] * w, xb = xs[q * PT + sp + 1] * w;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int n = lane + 32 * k;
          const float bv = n < N ? BsT[n * qs + q] : 0.f;
          st[0][k] = fmaf(xa, bv, st[0][k]);
          st[1][k] = fmaf(xb, bv, st[1][k]);
        }
      }
    }
    __syncthreads();            // every read of this chunk's tiles is done
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int n = lane + 32 * k;
        if (n < N) stT[n * (PT + 1) + sp + a] = st[a][k];
      }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int n = lane + 32 * k;
      if (sp + a < np && n < N)
        hT[(((size_t)b * H + h) * P + p0 + sp + a) * N + n] = st[a][k];
    }
}

}  // namespace

// h0 may be null (a zero initial state). Returns the launch's cudaError_t.
extern "C" int ssd_scan_launch(const void* x, const void* la, const void* Bm,
                               const void* Cm, const void* h0, void* y,
                               void* hT, int B, int S, int H, int P, int N,
                               int Q, void* stream) {
  if (Q <= 0 || Q > MAXQ || Q % 4 || N <= 0 || N > MAXN || S % Q ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * (size_t)Layout(Q, N).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + PT - 1) / PT, H, B);
  ssd_scan_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(la),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hT), S, H, P, N, Q);
  return (int)cudaGetLastError();
}
