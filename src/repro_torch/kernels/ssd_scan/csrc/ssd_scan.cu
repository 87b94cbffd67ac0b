// Mamba-2 SSD chunked scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan` (`_kernel`) of
// src/repro/kernels/ssd_scan/ssd_scan.py.
//
// Model layout, float32, contiguous: x (B, S, H, P) already scaled by dt;
// la (B, S, H) log decay; Bm, Cm (B, S, G, N) with G dividing H, head h
// reading group h / (H / G) (G = H is the per-head form); h0 (B, H, P, N)
// or null (zeros); outputs y (B, S, H, P) and h_final (B, H, P, N). S is a
// multiple of the chunk Q. In chunk c of (b, h), with cum the in-chunk
// prefix sum of la and state the (P, N) state entering the chunk:
//   y_i    = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) x_j
//            + exp(cum_i) (C_i . state[p, :])
//   state <- exp(cum_last) state + sum_q exp(cum_last - cum_q) x_q (outer) B_q
// The decay is formed only where j <= i, so exp never sees a positive
// exponent (exp(+big) * 0 would be NaN).
//
// Design: the SSD decomposition (the port's ssd_chunked in models/ssm.py
// in plain torch), in three launches on the stream.
//  1. ssd_cb, grid (32 x 32 tile pairs on or below the diagonal, chunk,
//     b * G): C.B^T of each (b, group, chunk), once, into a float32
//     scratch (stored transposed, [j][i]). The decay depends on the head
//     (through la), so what heads share is C.B^T itself.
//  2. ssd_chunk, grid (2 x 32-column P tiles, chunk, b * H): the
//     chunk-parallel work. The first half of grid.x computes the
//     intra-chunk y = (C.B^T o decay) x of its P tile, the decay applied as
//     the operand is loaded; the second half the chunk's own state term
//     sum_q exp(cum_last - cum_q) x_q (outer) B_q, into a float32 scratch
//     (b, chunk, h, P, N). Both stage the whole chunk by cp.async (16
//     bytes a thread), one group per tile of 32 source positions, all
//     issued at the start; the cum scan runs while they land, and each tile
//     is used as soon as it has. The state-term block of the first P tile
//     hands the chunk's cum to phase 3.
//  3. ssd_state, grid (16-column P tiles, H, B): the short sequential pass.
//     Its (16, N) state slice lives in shared memory; per chunk it adds
//     exp(cum_i) C_i . state to y (C staged by cp.async in 32-column tiles
//     through a 3-stage ring that runs across chunks), then steps the
//     state with the chunk's decay and its state term from phase 2, and
//     finally writes h_final.
// Each phase's tiles leave room for two blocks an SM.
//
// Every product runs on the tensor cores as mma.sync m16n8k8 TF32 with
// the 3xTF32 split (a = a_hi + a_lo, b likewise; a_lo b_hi + a_hi b_lo +
// a_hi b_hi, float32 accumulators), which keeps float32 accuracy (the
// checks hold the kernel to 2e-4 against the sequential recurrence). The
// CUDA-core form of these loops was bound by shared-memory bandwidth: a
// register tile small enough to keep two blocks an SM does under two FMAs
// per float it loads. Tiles are padded so every fragment load of a warp
// hits 32 distinct banks.
//
// Bound on the H100: at one 256-token chunk of full-width mamba2-370m
// (H=32, P=64, N=128, Q=128, G=1) the scan must move 6.6 MB (2.0 us at
// 3.35 TB/s) and do 340 MFLOP: 5.1 us at the 67 TFLOP/s float32 CUDA-core
// peak, 2.1 us at a third of the 495 TFLOP/s TF32 tensor-core peak (three
// products per multiply-add).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int JT = 32;           // positions of a staged tile (phases 1-2)
constexpr int PT2 = 32;          // p columns of a phase-2 block
constexpr int PT3 = 16;          // p columns of a phase-3 block
constexpr int NT3 = 32;          // state columns of a phase-3 C tile
constexpr int MAXQ = 128;        // chunk length the tiles cover
constexpr int MAXN = 128;        // d_state the tiles cover
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}
__device__ __forceinline__ void mma(float* d, const unsigned* a,
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// A fragment of m16n8k8: a[0] (row g, col t), a[1] (g+8, t), a[2] (g, t+4),
// a[3] (g+8, t+4), split into hi and lo
struct FragA {
  unsigned hi[4], lo[4];
  __device__ __forceinline__ void set(const float* v) {
#pragma unroll
    for (int r = 0; r < 4; ++r) split(v[r], hi[r], lo[r]);
  }
};
// d += A B for the B fragment (k t, col g) = b0, (k t+4, col g) = b1
__device__ __forceinline__ void mma3(float* d, const FragA& a, float b0,
                                     float b1) {
  unsigned bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, a.lo, bh0, bh1);
  mma(d, a.hi, bl0, bl1);
  mma(d, a.hi, bh0, bh1);
}

// cum[q] = la[0] + ... + la[q] over a chunk held in shared memory (Q <=
// 128, positions past Q hold 0), scaled by log2(e) so exp(cum_i - cum_j)
// is exp2(cl_i - cl_j); the first four warps scan, the caller syncs after
__device__ __forceinline__ void scan_chunk(const float* la_s, float* cl,
                                           float* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float v = 0.f;
  if (warp < 4) {
    v = la_s[tid];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float w = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += w;
    }
    if (lane == 31) wsum[warp] = v;
  }
  __syncthreads();
  if (warp < 4) {
    for (int w = 0; w < warp; ++w) v += wsum[w];
    cl[tid] = v * LOG2E;
  }
}

// ---------------------------------------------------------------- phase 1
constexpr int SN1 = MAXN + 4;            // row stride: 4g + t distinct banks
constexpr int CB_SMEM = sizeof(float) * 2 * JT * SN1;

// cbt[(b*G + g)*nc + c][j][i] = C_i . B_j for the 32 x 32 tile pair
// (i-tile it >= j-tile jt); tiles above the diagonal are never written
// nor read. Warp w owns the 16 x 8 output tile (i 16 (w & 1), j 8 (w >> 1)).
__global__ void __launch_bounds__(THREADS)
ssd_cb(const float* __restrict__ Bm, const float* __restrict__ Cm,
       float* __restrict__ cbt, int S, int G, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;              // [32 i][SN1]
  float* Bs = smem + JT * SN1;   // [32 j][SN1]
  int pair = blockIdx.x, it = 0;
  while (pair > it) pair -= ++it;
  const int jt = pair;
  const int c = blockIdx.y, bg = blockIdx.z;
  const int b = bg / G, g = bg - b * G;
  const int nc = S / Q;
  const int i0 = it * JT, j0 = jt * JT, s0 = c * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int u = 0; u < 2 * JT * (MAXN / 4) / THREADS; ++u) {
    const int idx = tid + u * THREADS;
    const int which = idx >> 10, r = (idx >> 5) & 31, k = idx & 31;
    const int q = (which ? j0 : i0) + r;
    const bool ok = q < Q && 4 * k < N;
    const float* src = (which ? Bm : Cm)
        + (ok ? (((long)b * S + s0 + q) * G + g) * N + 4 * k : 0);
    cp_async16((which ? Bs : Cs) + r * SN1 + 4 * k, src, ok);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (warp & 1), n0 = 8 * (warp >> 1);
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < N; k0 += 8) {
    FragA a;
    const float v[4] = {Cs[(m0 + gq) * SN1 + k0 + tq],
                        Cs[(m0 + gq + 8) * SN1 + k0 + tq],
                        Cs[(m0 + gq) * SN1 + k0 + tq + 4],
                        Cs[(m0 + gq + 8) * SN1 + k0 + tq + 4]};
    a.set(v);
    mma3(d, a, Bs[(n0 + gq) * SN1 + k0 + tq],
         Bs[(n0 + gq) * SN1 + k0 + tq + 4]);
  }
  float* out = cbt + ((long)bg * nc + c) * Q * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + m0 + gq + 8 * (r >> 1), j = j0 + n0 + 2 * tq + (r & 1);
    if (i < Q && j < Q) out[j * Q + i] = d[r];
  }
}

// ---------------------------------------------------------------- phase 2
// The whole chunk staged, in floats: [MAXQ][SA] C.B^T rows (y blocks) or B
// rows (state-term blocks), then [MAXQ][SX] x columns. Both strides are 8
// mod 32, so a fragment load (rows t, columns g) hits distinct banks.
// Columns past Q or N are zero-filled or never read.
constexpr int SA = MAXQ + 8;
constexpr int SX = PT2 + 8;
constexpr int ST2_X = MAXQ * SA;
constexpr int ST2 = ST2_X + MAXQ * SX;
constexpr int CHUNK_SMEM = sizeof(float) * (ST2 + 3 * MAXQ + 8);
constexpr int NJMAX = MAXQ / JT;         // j-tiles of a chunk

__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk(const float* __restrict__ x, const float* __restrict__ la,
          const float* __restrict__ Bm, const float* __restrict__ cbt,
          float* __restrict__ y, float* __restrict__ local,
          float* __restrict__ cl_out, int S, int H, int G, int P, int N,
          int Q) {
  extern __shared__ __align__(16) float smem[];
  float* la_s = smem + ST2;
  float* cl = la_s + MAXQ;       // cum * log2(e)
  float* tail = cl + MAXQ;       // exp(cum_last - cum_q), 0 past Q
  float* wsum = tail + MAXQ;
  const int npt = (P + PT2 - 1) / PT2;
  const bool ypart = blockIdx.x < npt;
  const int p0 = (ypart ? blockIdx.x : blockIdx.x - npt) * PT2;
  const int c = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / H, h = bh - b * H;
  const int g = h / (H / G);
  const int nc = S / Q, s0 = c * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cb = cbt + (((long)b * G + g) * nc + c) * Q * Q;
  const int NJ = (Q + JT - 1) / JT;
  const int rowlen = ypart ? Q : N;   // floats of a staged C.B^T / B row

  // j-tile t: its 32 C.B^T or B rows and x rows
  auto issue = [&](int t) {
    const int j0 = t * JT;
#pragma unroll
    for (int u = 0; u < JT * 32 / THREADS; ++u) {     // 32 words a row
      const int idx = tid + u * THREADS;
      const int r = j0 + (idx >> 5), k = idx & 31;
      const bool ok = r < Q && 4 * k < rowlen;
      const float* src = !ok ? cb
          : ypart ? cb + (long)r * Q + 4 * k
                  : Bm + (((long)b * S + s0 + r) * G + g) * N + 4 * k;
      cp_async16(smem + r * SA + 4 * k, src, ok);
    }
    {                                                 // 8 words a row
      const int r = j0 + (tid >> 3), k = tid & 7;
      const bool ok = r < Q && p0 + 4 * k < P;
      cp_async16(smem + ST2_X + r * SX + 4 * k,
                 ok ? x + (((long)b * S + s0 + r) * H + h) * P + p0 + 4 * k
                    : x, ok);
    }
  };

  // la of the chunk (stride H), then every j-tile, one group each; the
  // scan runs while the tiles land
  if (tid < MAXQ) {
    const bool ok = tid < Q;
    cp_async4(la_s + tid, la + (ok ? ((long)b * S + s0 + tid) * H + h : 0),
              ok);
  }
  cp_commit();
#pragma unroll
  for (int t = 0; t < NJMAX; ++t) {
    if (t < NJ) issue(t);
    cp_commit();
  }
  cp_wait<NJMAX>();
  __syncthreads();
  scan_chunk(la_s, cl, wsum);
  __syncthreads();
  if (tid < MAXQ) tail[tid] = tid < Q ? exp2f(cl[Q - 1] - cl[tid]) : 0.f;
  if (!ypart && p0 == 0 && tid < Q)
    cl_out[(((long)b * nc + c) * H + h) * Q + tid] = cl[tid];

  const int gq = lane >> 2, tq = lane & 3;
  // y: warp w owns rows 16w..16w+15 and the 4 column tiles of P;
  // state term: rows p 16 (w & 1).., columns n 32 (w >> 1).. (4 tiles)
  const int m0 = ypart ? 16 * warp : 16 * (warp & 1);
  const int nb = ypart ? 0 : 32 * (warp >> 1);
  float d[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) d[n][r] = 0.f;
  // the y rows' log2 cum (for the decay) are fixed for the thread
  const int i_a = m0 + gq, i_b = m0 + gq + 8;

#pragma unroll
  for (int t = 0; t < NJMAX; ++t) {
    if (t >= NJ) break;
    switch (NJMAX - 1 - t) {     // tile t landed (later tiles may not have)
      case 3: cp_wait<3>(); break;
      case 2: cp_wait<2>(); break;
      case 1: cp_wait<1>(); break;
      default: cp_wait<0>(); break;
    }
    __syncthreads();
    const int j0 = t * JT;
    if (ypart) {
      if (m0 + 15 < j0) continue;        // rows all above this tile: 0
      const float cl_a = cl[i_a], cl_b = cl[i_b];
#pragma unroll
      for (int k0 = 0; k0 < JT; k0 += 8) {
        const int ja = j0 + k0 + tq, jb = ja + 4;
        if (m0 + 15 < j0 + k0) break;
        const float cja = cl[ja], cjb = cl[jb];
        // A[i][j] = CB[i][j] exp2(cl_i - cl_j) where j <= i < Q, else 0
        const float v[4] = {
            (ja <= i_a && i_a < Q) ? smem[ja * SA + i_a]
                                       * exp2f(cl_a - cja) : 0.f,
            (ja <= i_b && i_b < Q) ? smem[ja * SA + i_b]
                                       * exp2f(cl_b - cja) : 0.f,
            (jb <= i_a && i_a < Q) ? smem[jb * SA + i_a]
                                       * exp2f(cl_a - cjb) : 0.f,
            (jb <= i_b && i_b < Q) ? smem[jb * SA + i_b]
                                       * exp2f(cl_b - cjb) : 0.f};
        FragA a;
        a.set(v);
        const float* xs = smem + ST2_X;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma3(d[n], a, xs[ja * SX + 8 * n + gq], xs[jb * SX + 8 * n + gq]);
      }
    } else {
      const float* xs = smem + ST2_X;
#pragma unroll
      for (int k0 = 0; k0 < JT; k0 += 8) {
        const int ja = j0 + k0 + tq, jb = ja + 4;
        const float wa = tail[ja], wb = tail[jb];
        // A[p][j] = tail_j x[j][p]
        const float v[4] = {xs[ja * SX + m0 + gq] * wa,
                            xs[ja * SX + m0 + gq + 8] * wa,
                            xs[jb * SX + m0 + gq] * wb,
                            xs[jb * SX + m0 + gq + 8] * wb};
        FragA a;
        a.set(v);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int nc0 = nb + 8 * n;
          if (nc0 < N)
            mma3(d[n], a, smem[ja * SA + nc0 + gq], smem[jb * SA + nc0 + gq]);
        }
      }
    }
  }

  if (ypart) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = m0 + gq + 8 * (r >> 1);
        const int p = p0 + 8 * n + 2 * tq + (r & 1);
        if (i < Q && p < P)
          y[(((long)b * S + s0 + i) * H + h) * P + p] = d[n][r];
      }
  } else {
    float* lb = local + (((long)b * nc + c) * H + h) * P * N;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int nn = nb + 8 * n + 2 * tq;
      if (nn >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = p0 + m0 + gq + 8 * half;
        if (p < P)
          *reinterpret_cast<float2*>(lb + (long)p * N + nn) =
              make_float2(d[n][2 * half], d[n][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- phase 3
constexpr int SS = MAXN + 4;             // state row stride (4 mod 32)
constexpr int CS = NT3 + 4;              // C tile row stride (4 mod 32)
constexpr int ST3_CS = PT3 * SS;         // after the (PT3, N) state
constexpr int ST3_CUM = ST3_CS + 3 * MAXQ * CS;
constexpr int STATE_SMEM = sizeof(float) * (ST3_CUM + 3 * MAXQ);

// Warp w owns y rows 16w..16w+15 of the chunk and both 8-column tiles of
// its 16 p. C goes through a 3-stage ring of NT3-column tiles that runs
// across chunks; a chunk's log2 cum comes with its first tile, in a buffer
// by chunk % 3.
__global__ void __launch_bounds__(THREADS, 2)
ssd_state(const float* __restrict__ Cm, const float* __restrict__ local,
          const float* __restrict__ cl_in, const float* __restrict__ h0,
          float* __restrict__ y, float* __restrict__ hT, int S, int H,
          int G, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;
  float* cl3 = smem + ST3_CUM;               // [3][MAXQ], by chunk % 3
  const int p0 = blockIdx.x * PT3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int nc = S / Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int NNT = (N + NT3 - 1) / NT3;
  const int T = nc * NNT;

  auto issue = [&](int t) {
    if (t < T) {
      const int c = t / NNT, nt = t - c * NNT, n0 = nt * NT3;
      float* cs = smem + ST3_CS + (t % 3) * MAXQ * CS;
#pragma unroll
      for (int u = 0; u < MAXQ * (NT3 / 4) / THREADS; ++u) {
        const int idx = tid + u * THREADS;
        const int i = idx >> 3, k = idx & 7;
        const bool ok = i < Q && n0 + 4 * k < N;
        cp_async16(cs + i * CS + 4 * k,
                   ok ? Cm + (((long)b * S + c * Q + i) * G + g) * N + n0
                            + 4 * k : Cm, ok);
      }
      if (nt == 0 && tid < MAXQ / 4) {
        const bool ok = 4 * tid < Q;
        cp_async16(cl3 + (c % 3) * MAXQ + 4 * tid,
                   ok ? cl_in + (((long)b * nc + c) * H + h) * Q + 4 * tid
                      : cl_in, ok);
      }
    }
    cp_commit();
  };

  // the entering state: h0 rows (or zeros) land with tile 0
#pragma unroll
  for (int u = 0; u < PT3 * (MAXN / 4) / THREADS; ++u) {
    const int idx = tid + u * THREADS;
    const int p = idx >> 5, k = idx & 31;
    const bool ok = h0 != nullptr && p0 + p < P && 4 * k < N;
    cp_async16(st + p * SS + 4 * k,
               ok ? h0 + (((long)b * H + h) * P + p0 + p) * N + 4 * k
                  : (h0 ? h0 : Cm), ok);
  }
  issue(0);
  issue(1);

  constexpr int NL = PT3 * MAXN / THREADS;   // state entries a thread steps
  const int m0 = 16 * warp;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    // this chunk's y rows (phase 2's intra-chunk part) and state term,
    // fetched ahead of their use
    float yv[2][4], lv[NL];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = m0 + gq + 8 * (r >> 1);
        const int p = p0 + 8 * n + 2 * tq + (r & 1);
        yv[n][r] = (i < Q && p < P)
            ? y[(((long)b * S + s0 + i) * H + h) * P + p] : 0.f;
      }
    const float* lc = local + (((long)b * nc + c) * H + h) * P * N;
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      const int idx = tid + u * THREADS;
      const int p = idx >> 7, n = idx & 127;
      lv[u] = (p0 + p < P && n < N) ? lc[(long)(p0 + p) * N + n] : 0.f;
    }

    float d[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) d[n][r] = 0.f;
    for (int nt = 0; nt < NNT; ++nt) {
      const int t = c * NNT + nt;
      cp_wait<1>();
      __syncthreads();           // tile t landed; tile t-1 is done
      issue(t + 2);
      const float* cs = smem + ST3_CS + (t % 3) * MAXQ * CS;
      const float* sv = st + nt * NT3;
      if (m0 >= Q) continue;
#pragma unroll
      for (int k0 = 0; k0 < NT3; k0 += 8) {
        const float v[4] = {cs[(m0 + gq) * CS + k0 + tq],
                            cs[(m0 + gq + 8) * CS + k0 + tq],
                            cs[(m0 + gq) * CS + k0 + tq + 4],
                            cs[(m0 + gq + 8) * CS + k0 + tq + 4]};
        FragA a;
        a.set(v);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma3(d[n], a, sv[(8 * n + gq) * SS + k0 + tq],
               sv[(8 * n + gq) * SS + k0 + tq + 4]);
      }
    }
    const float* cl = cl3 + (c % 3) * MAXQ;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = m0 + gq + 8 * (r >> 1);
        const int p = p0 + 8 * n + 2 * tq + (r & 1);
        if (i < Q && p < P)
          y[(((long)b * S + s0 + i) * H + h) * P + p] =
              fmaf(exp2f(cl[i]), d[n][r], yv[n][r]);
      }
    __syncthreads();             // every read of the entering state is done
    const float decay = exp2f(cl[Q - 1]);
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      const int idx = tid + u * THREADS;
      const int p = idx >> 7, n = idx & 127;
      st[p * SS + n] = fmaf(decay, st[p * SS + n], lv[u]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < NL; ++u) {
    const int idx = tid + u * THREADS;
    const int p = idx >> 7, n = idx & 127;
    if (p0 + p < P && n < N)
      hT[(((long)b * H + h) * P + p0 + p) * N + n] = st[p * SS + n];
  }
}

// the phases' dynamic shared-memory limits, set once a device
cudaError_t set_smem_once() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((err = cudaFuncSetAttribute(ssd_cb, a, CB_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_chunk, a, CHUNK_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_state, a, STATE_SMEM)) != cudaSuccess)
    return err;
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

}  // namespace

// h0 may be null (a zero initial state). ``scratch`` holds float32 values:
// the C.B^T of B*G*(S/Q) chunks (Q*Q each), then the chunks' state terms
// (B*(S/Q)*H*P*N), then each (row, chunk, head)'s log2 cum (Q). P, N and Q
// are multiples of 8; Q <= 128, N <= 128. Returns the first failing
// launch's cudaError_t.
extern "C" int ssd_scan_launch(const void* x, const void* la, const void* Bm,
                               const void* Cm, const void* h0, void* y,
                               void* hT, void* scratch, int B, int S, int H,
                               int G, int P, int N, int Q, void* stream) {
  if (Q <= 0 || Q > MAXQ || Q % 8 || N <= 0 || N > MAXN || N % 8 ||
      P <= 0 || P % 8 || S % Q || G <= 0 || H % G || B > 65535 ||
      (long)B * H > 65535 || (long)B * G > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = S / Q;
  float* cbt = static_cast<float*>(scratch);
  float* local = cbt + (long)B * G * nc * Q * Q;
  float* cl = local + (long)B * nc * H * P * N;
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  cudaError_t err = set_smem_once();
  if (err != cudaSuccess) return (int)err;
  const int T = (Q + JT - 1) / JT;
  ssd_cb<<<dim3(T * (T + 1) / 2, nc, B * G), THREADS, CB_SMEM, s>>>(
      bf, cf, cbt, S, G, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_chunk<<<dim3(2 * ((P + PT2 - 1) / PT2), nc, B * H), THREADS,
              CHUNK_SMEM, s>>>(static_cast<const float*>(x),
                               static_cast<const float*>(la), bf, cbt, yf,
                               local, cl, S, H, G, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_state<<<dim3((P + PT3 - 1) / PT3, H, B), THREADS, STATE_SMEM, s>>>(
      cf, local, cl, static_cast<const float*>(h0), yf,
      static_cast<float*>(hT), S, H, G, P, N, Q);
  return (int)cudaGetLastError();
}

// Registers, local-memory (spill) bytes, dynamic shared memory and the
// resident blocks an SM holds, of phase ``which`` (0 C.B^T, 1 chunk, 2
// state), as the CUDA runtime reports them.
extern "C" int ssd_scan_attrs(int which, int* regs, int* local, int* smem,
                              int* blocks_per_sm) {
  cudaFuncAttributes a;
  const void* fn = which == 0 ? (const void*)ssd_cb
                 : which == 1 ? (const void*)ssd_chunk
                              : (const void*)ssd_state;
  const int bytes = which == 0 ? CB_SMEM
                  : which == 1 ? CHUNK_SMEM : STATE_SMEM;
  cudaError_t err = set_smem_once();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                        THREADS, bytes);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local = (int)a.localSizeBytes;
  *smem = bytes;
  return 0;
}
