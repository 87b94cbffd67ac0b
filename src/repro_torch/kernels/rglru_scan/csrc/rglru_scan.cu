// RG-LRU diagonal linear recurrence (Griffin / RecurrentGemma), hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rglru_scan` (`_kernel`) of
// src/repro/kernels/rglru_scan/rglru_scan.py.
//
// log_a, gated (B, S, W) float32, contiguous; h0 (B, W) or null (zeros);
// outputs h (B, S, W) and h_final (B, W):
//   h_t = exp(log_a_t) * h_{t-1} + gated_t
//
// Design. The TPU kernel tiled W into 128-lane blocks on a parallel grid
// axis and walked S in VMEM-sized blocks (bs, bw) on a sequential one,
// carrying h in scratch; it asserted that S and W divide by the tiles. The
// recurrence is elementwise in W, so here one thread owns one (b, w)
// channel and walks S in order with h in a register: f32 expf and one FMA
// a step. Loads are coalesced across w. The steps are taken in batches of
// U: the loads of batch k+1 are issued before batch k's FMAs, since they
// do not depend on h, so each thread keeps 2*U loads in flight. Any S and
// any W are taken (the last batch and the last block are masked).
//
// Bound on the H100: each input element is read once and each output
// written once for ~2 operations, so it is bound by memory bytes: at
// (1, 256, 4096) that is 12.6 MB, ~3.8 us at 3.35 TB/s. With one thread a
// channel, batch 1 and W = 4096 put 64 blocks of 64 threads on 132 SMs,
// so what bounds this first version is the latency of each thread's
// dependent batches, not the bandwidth.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int U = 16;            // steps a batch

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ la, const float* __restrict__ g,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ hT, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const size_t base = (size_t)b * S * W + w;
  float hv = h0 != nullptr ? h0[(size_t)b * W + w] : 0.f;

  float a_cur[U], g_cur[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    a_cur[u] = u < S ? la[base + (size_t)u * W] : 0.f;
    g_cur[u] = u < S ? g[base + (size_t)u * W] : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += U) {
    float a_nxt[U], g_nxt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + U + u;
      a_nxt[u] = t < S ? la[base + (size_t)t * W] : 0.f;
      g_nxt[u] = t < S ? g[base + (size_t)t * W] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < S) {
        hv = fmaf(expf(a_cur[u]), hv, g_cur[u]);
        h[base + (size_t)t * W] = hv;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      a_cur[u] = a_nxt[u];
      g_cur[u] = g_nxt[u];
    }
  }
  hT[(size_t)b * W + w] = hv;
}

}  // namespace

// h0 may be null (a zero initial state). Returns the launch's cudaError_t.
extern "C" int rglru_scan_launch(const void* log_a, const void* gated,
                                 const void* h0, void* h, void* hT, int B,
                                 int S, int W, void* stream) {
  if (B <= 0 || B > 65535 || S < 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(gated),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(hT), S, W);
  return (int)cudaGetLastError();
}
