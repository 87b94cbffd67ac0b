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
// Bound on the H100: each input element is read once and each output
// written once for ~2 operations, so the scan is bound by memory bytes: at
// one 256-token chunk of recurrentgemma-9b (1, 256, 4096) that is 12.6 MB,
// 3.8 us at 3.35 TB/s. What keeps a kernel from it is the bytes it has in
// flight and the SMs it uses, not the recurrence: the dependent chain of
// 256 FMAs is well under a microsecond. The TPU kernel tiled W into
// 128-lane blocks on a parallel grid axis and walked S in VMEM-sized
// blocks on a sequential one, carrying h in scratch; on this card that
// shape (a thread a channel walking all of S) puts batch 1 on 64 blocks.
//
// Two routes, chosen on shape by ops.py::plan:
//
// rglru_cluster (W a multiple of 32; the model's widths). A block owns
// (b, a 32-channel tile = one 128-byte row a step, a segment of `seg`
// steps). The `cluster` blocks that split one (b, tile)'s steps form one
// thread block cluster (grid.x), so batch 1 at width 4096 runs 128 tiles x
// 4 segments = 512 blocks, about four an SM. S is walked in `rounds` of
// cluster * seg steps. A segment is cut into WARPS runs of `run` steps,
// one a warp.
//  1. Staging: at block start each warp starts the 16-byte cp.async copies
//     of its run's log_a and gated rows into shared memory, so the whole
//     segment (16 KB at 64 steps) is requested at once; about 8 MB across
//     the card. With more than one round, the next round's rows are copied
//     into a second stage while this round is computed.
//  2. Phase 1: lane c of warp q walks run q of channel c from h = 0 as soon
//     as the warp's own rows have landed, keeping the local state and the
//     run's decay A_t = exp(log_a_1) ... exp(log_a_t) in place of the
//     inputs: one expf, one multiply and one FMA a step, and only the FMA
//     chain is serial. A run's aggregate is its end state e and its decay
//     A; after one block barrier warp 0 folds the runs into the segment's
//     aggregate.
//  3. Phase 2, the carry: after a cluster barrier, every warp reads the
//     aggregates (A_j, e_j) of the segments j < k from the peers' shared
//     memory (distributed shared memory) and composes them in fixed order
//     from the state entering the round: carry = A_j carry + e_j, then the
//     runs before its own. No global scratch, no atomics, no look-back: the
//     result does not depend on which block finishes first, so two calls
//     give the same bits. Folding the segments j >= k too gives the next
//     round's state.
//  4. Phase 3: h_t = local_t + A_t carry_run for every step and channel of
//     the warp's run, with no dependent chain; each row leaves as one
//     128-byte store. The step S - 1 also goes to h_final.
// Each input byte is read from device memory once and each output byte
// written once.
//
// rglru_channel (any other W): the first port's kernel. One thread owns
// one (b, w) channel and walks S in order with h in a register, in batches
// of U steps whose loads are started a batch ahead.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 32;             // channels of a cluster-route block
constexpr int WARPS = 4;             // runs of a segment, one a warp
constexpr int THREADS = WARPS * 32;
constexpr int SEG_MAX = 64;          // steps a block stages a round
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int CH_THREADS = 64;       // rglru_channel's block
constexpr int U = 16;                // rglru_channel's steps a batch

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// grid (cluster, W / TILE, B), cluster dims (cluster, 1, 1); dynamic
// shared memory: stages x {log_a, gated} x seg x TILE floats. Warp q
// stages, walks and writes run q of the segment alone; the block meets
// once a round to share the runs' aggregates, and the cluster once to
// share the segments'.
__global__ void __launch_bounds__(THREADS)
rglru_cluster(const float* __restrict__ la, const float* __restrict__ g,
              const float* __restrict__ h0, float* __restrict__ h,
              float* __restrict__ hT, int S, int W, int seg, int run,
              int rounds) {
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int k = (int)cluster.block_rank();
  const int col = blockIdx.y * TILE;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // the segment's and the runs' aggregates, by round parity: a warp may
  // write round r + 1's while another still reads round r's
  __shared__ float aggA[2][TILE], agge[2][TILE];
  __shared__ float runA[2][WARPS][TILE], rune[2][WARPS][TILE];
  __shared__ __align__(16) float cin[WARPS][TILE];  // each run's carry
  const int stride = seg * TILE;                   // floats an input
  const long rowb = (long)b * S;

  // steps [a0, a1) of round r's segment are this warp's run
  auto run_of = [&](int r, int& t0, int& a0, int& a1) {
    t0 = (r * K + k) * seg;
    const int n = max(0, min(seg, S - t0));
    a0 = min(n, warp * run);
    a1 = min(n, a0 + run);
  };
  // cp.async of the warp's run of round r into stage st: 8 16-byte words
  // a row and input
  auto stage_in = [&](int r, int st) {
    int t0, a0, a1;
    run_of(r, t0, a0, a1);
    float* ls = smem + st * 2 * stride;
    for (int c = a0 * 8 + lane; c < a1 * 8; c += 32) {
      const int row = c >> 3, w4 = (c & 7) * 4;
      const long off = (rowb + t0 + row) * W + col + w4;
      cp_async16(ls + row * TILE + w4, la + off);
      cp_async16(ls + stride + row * TILE + w4, g + off);
    }
    cp_commit();
  };

  // the state entering the round, channel `lane` (the same in every warp)
  float carry = h0 != nullptr ? h0[(long)b * W + col + lane] : 0.f;
  const int two = rounds > 1;
  stage_in(0, 0);
  for (int r = 0; r < rounds; ++r) {
    const int st = r & two;
    if (r + 1 < rounds) {
      __syncwarp();                        // round r - 1 done with its stage
      stage_in(r + 1, (r + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();
    float* ls = smem + st * 2 * stride;    // log_a, then the decay
    float* gs = ls + stride;               // gated, then the local state
    int t0, a0, a1;
    run_of(r, t0, a0, a1);

    // phase 1: the run of channel `lane`, from h = 0
    float A = 1.f, e = 0.f;
#pragma unroll 4
    for (int t = a0; t < a1; ++t) {
      const float a = expf(ls[t * TILE + lane]);
      A *= a;
      e = fmaf(a, e, gs[t * TILE + lane]);
      ls[t * TILE + lane] = A;
      gs[t * TILE + lane] = e;
    }
    const int p = r & 1;
    runA[p][warp][lane] = A;
    rune[p][warp][lane] = e;
    __syncthreads();
    if (warp == 0) {                       // the segment's aggregate
      float sA = 1.f, se = 0.f;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) {
        se = fmaf(runA[p][q][lane], se, rune[p][q][lane]);
        sA *= runA[p][q][lane];
      }
      aggA[p][lane] = sA;
      agge[p][lane] = se;
    }
    if (K > 1) cluster.sync(); else __syncthreads();

    // phase 2, in every warp: compose the segments in order from the
    // round's state, then the runs before this warp's
    const int jn = r + 1 < rounds ? K : k;   // the last round needs j < k
    float Aj[MAX_CLUSTER], ej[MAX_CLUSTER];
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j) {
      if (j < jn) {
        Aj[j] = cluster.map_shared_rank(&aggA[p][0], j)[lane];
        ej[j] = cluster.map_shared_rank(&agge[p][0], j)[lane];
      }
    }
    // the last round's peer reads are done: arrive now, wait before exit
    if (K > 1 && r + 1 == rounds)
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    float c = carry, mine = c;
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j) {
      if (j == k) mine = c;
      if (j < jn) c = fmaf(Aj[j], c, ej[j]);
    }
    carry = c;                             // the next round's state
#pragma unroll
    for (int q = 0; q < WARPS - 1; ++q)
      if (q < warp) mine = fmaf(runA[p][q][lane], mine, rune[p][q][lane]);
    cin[warp][lane] = mine;
    __syncwarp();

    // phase 3: the warp's rows, 8 lanes a row and 4 channels a lane; one
    // 128-byte store a row
    const int c4 = (lane & 7) * 4;
    const float4 ci = *reinterpret_cast<const float4*>(&cin[warp][c4]);
    for (int t = a0 + (lane >> 3); t < a1; t += 4) {
      const float4 d = *reinterpret_cast<const float4*>(ls + t * TILE + c4);
      const float4 loc = *reinterpret_cast<const float4*>(gs + t * TILE + c4);
      float4 o;
      o.x = fmaf(d.x, ci.x, loc.x);
      o.y = fmaf(d.y, ci.y, loc.y);
      o.z = fmaf(d.z, ci.z, loc.z);
      o.w = fmaf(d.w, ci.w, loc.w);
      const int tg = t0 + t;
      *reinterpret_cast<float4*>(h + (rowb + tg) * W + col + c4) = o;
      if (tg == S - 1)
        *reinterpret_cast<float4*>(hT + (long)b * W + col + c4) = o;
    }
  }
  if (K > 1)
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(CH_THREADS)
rglru_channel(const float* __restrict__ la, const float* __restrict__ g,
              const float* __restrict__ h0, float* __restrict__ h,
              float* __restrict__ hT, int S, int W) {
  const int w = blockIdx.x * CH_THREADS + threadIdx.x;
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

int cluster_smem(int seg, int rounds) {
  return (rounds > 1 ? 2 : 1) * 2 * seg * TILE * (int)sizeof(float);
}

// rglru_cluster over grid (cluster, tiles, B) in clusters of `cluster`
// blocks; the config points at `attr`, which the caller keeps
cudaLaunchConfig_t cluster_config(int cluster, int tiles, int B, int seg,
                                  int rounds, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, tiles, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = cluster_smem(seg, rounds);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// route 0: rglru_channel (cluster, seg, run and rounds unused); route 1:
// rglru_cluster, whose log_a and gated rows must be 16-byte aligned, W a
// multiple of 32, seg <= 64 split into at most 4 runs of `run` steps,
// cluster <= 8 and rounds * cluster * seg >= S (ops.py::plan). h0 may be
// null (a zero initial state). Returns the launch's cudaError_t.
extern "C" int rglru_scan_launch(const void* log_a, const void* gated,
                                 const void* h0, void* h, void* hT, int B,
                                 int S, int W, int route, int cluster,
                                 int seg, int run, int rounds, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* g = static_cast<const float*>(gated);
  const float* hz = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(h);
  float* hf = static_cast<float*>(hT);
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  if (route == 0) {
    const dim3 grid((W + CH_THREADS - 1) / CH_THREADS, B);
    rglru_channel<<<grid, CH_THREADS, 0, s>>>(la, g, hz, ho, hf, S, W);
    return (int)cudaGetLastError();
  }
  if (route != 1 || W % TILE || W / TILE > 65535 || cluster < 1 ||
      cluster > MAX_CLUSTER || seg < 1 || seg > SEG_MAX || run < 1 ||
      run * WARPS < seg || rounds < 1 || (long)rounds * cluster * seg < S)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, W / TILE, B, seg, rounds, s, &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, rglru_cluster, la, g, hz, ho,
                                       hf, S, W, seg, run, rounds);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Registers, local-memory (spill) bytes, shared memory (dynamic and
// static) and the resident blocks an SM holds, of route ``route`` at a
// plan's seg and rounds; for the cluster route also the clusters of
// ``cluster`` blocks the card can hold at once (0 for the channel route).
extern "C" int rglru_scan_attrs(int route, int cluster, int seg, int rounds,
                                int* regs, int* local, int* smem,
                                int* blocks_per_sm, int* max_clusters) {
  const void* fn = route == 1 ? (const void*)rglru_cluster
                              : (const void*)rglru_channel;
  const int threads = route == 1 ? THREADS : CH_THREADS;
  const int bytes = route == 1 ? cluster_smem(seg, rounds) : 0;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                        threads, bytes);
  *max_clusters = 0;
  if (err == cudaSuccess && route == 1) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(cluster, 128, 1, seg, rounds, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(max_clusters, rglru_cluster, &cfg);
  }
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local = (int)a.localSizeBytes;
  *smem = bytes + (int)a.sharedSizeBytes;
  return 0;
}
