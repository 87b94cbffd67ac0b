// CRC-32 of a contiguous buffer's bytes, hand-written for Hopper (sm_90a):
// zlib's crc32 (reflected polynomial 0xEDB88320, register preset to
// 0xFFFFFFFF and inverted at the end), chained from a previous CRC.
//
// Replaces no TPU kernel: the JAX package checksums a migration payload
// with zlib on the host, as the port did. On the H100 that host pass (a
// copy to host bytes, then zlib at about 1.3 GB/s, at export and again at
// import) was 93-97% of every KV migration; this kernel checksums the
// payload where it already lies, on the card.
//
// Bound on the H100: one read of every byte and a handful of table lookups
// a byte, so bytes / 3.35 TB/s: 0.16 ms for a 0.52 GB payload, 0.56 ms for
// 1.87 GB. The register of a CRC is a serial chain, so the buffer is cut
// into pieces whose CRCs are computed apart and combined, using
//   R(c, D) = shift(c, |D|) ^ R(0, D),  shift(c, d) = c * x^(8d) mod P
// where R is the register after the bytes D and P the polynomial. Every
// shift by a fixed distance is held as four byte tables (one lookup per
// byte of the register), built by ref.py::tables and passed in `tables`.
//
// crc32_blocks. The first n16 bytes (n rounded down to 16) are
// front-padded with zeros to whole blocks of 256 KB (leading zeros leave
// R(0, .) unchanged; the padding is a multiple of 16, so every 16-byte load
// stays aligned and is either all data or all padding, which is not read).
// A block is 16 tiles of 16 KB; in each tile thread t takes the 64-byte
// unit at 64 t (four 16-byte loads, the next tile's issued before this
// one's are folded) and folds it into its register through the
// slicing-by-16 tables in shared memory, after carrying the register over
// the 16 KB - 64 bytes of the other threads' units (the loop's operator).
// A tree over the block then carries each thread's register to the block's
// end: five levels of shuffles within each warp, three over the warps,
// level j shifting the left half by 64 * 2^j bytes. One 32-bit CRC a block
// is written. The register the CRC starts from (the preset, chained from
// `prev`) is folded into the first four bytes of the data where they are
// loaded: R(c, D) = R(0, D with c xored into its first four bytes).
//
// crc32_combine (one block). Thread t folds a run of `per` block CRCs (a
// power of two, zeros in front), a tree over the threads carries them to
// the end, and thread 0 takes the last n % 16 bytes one at a time and
// inverts the register.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // a block's threads
constexpr int UNIT = 64;              // bytes a thread folds per tile
constexpr int ITERS = 16;             // tiles a block
constexpr int TILE = THREADS * UNIT;  // 16 KB
constexpr long long BLOCK_BYTES = (long long)TILE * ITERS;  // 256 KB
constexpr int LOG_BLOCK = 18;
constexpr int LOG_UNIT = 6;
constexpr int COMBINE_THREADS = 256;
constexpr int SLICE = 16;             // slicing tables T_0 .. T_15
constexpr int LOOP_OP = SLICE;        // shift by TILE - UNIT
constexpr int POW2 = SLICE + 4;       // shift by 2^k bytes: POW2 + 4k
constexpr int SMEM_TABLES = SLICE + 4;

static_assert(BLOCK_BYTES == (1LL << LOG_BLOCK), "block is 2^LOG_BLOCK");
static_assert(UNIT == (1 << LOG_UNIT), "unit is 2^LOG_UNIT");

// the shift held by the four byte tables at `op`
__device__ __forceinline__ uint32_t apply_op(const uint32_t* op, uint32_t c) {
  return op[c & 0xff] ^ op[256 + ((c >> 8) & 0xff)] ^
         op[512 + ((c >> 16) & 0xff)] ^ op[768 + (c >> 24)];
}

__device__ __forceinline__ uint32_t apply_global(const uint32_t* op,
                                                 uint32_t c) {
  return __ldg(op + (c & 0xff)) ^ __ldg(op + 256 + ((c >> 8) & 0xff)) ^
         __ldg(op + 512 + ((c >> 16) & 0xff)) ^ __ldg(op + 768 + (c >> 24));
}

__device__ __forceinline__ uint32_t pow2_op(const uint32_t* tables, int k,
                                            uint32_t c) {
  return apply_global(tables + (POW2 + 4 * k) * 256, c);
}

#define T_(k, v) T[(k) * 256 + (v)]

// slicing-by-16: the register after the 16 bytes `w` (little-endian words)
// from the register `c`; byte i goes through T_(15 - i)
__device__ __forceinline__ uint32_t fold16(const uint32_t* T, uint32_t c,
                                           uint4 w) {
  const uint32_t x = w.x ^ c;
  return T_(15, x & 0xff) ^ T_(14, (x >> 8) & 0xff) ^
         T_(13, (x >> 16) & 0xff) ^ T_(12, x >> 24) ^
         T_(11, w.y & 0xff) ^ T_(10, (w.y >> 8) & 0xff) ^
         T_(9, (w.y >> 16) & 0xff) ^ T_(8, w.y >> 24) ^
         T_(7, w.z & 0xff) ^ T_(6, (w.z >> 8) & 0xff) ^
         T_(5, (w.z >> 16) & 0xff) ^ T_(4, w.z >> 24) ^
         T_(3, w.w & 0xff) ^ T_(2, (w.w >> 8) & 0xff) ^
         T_(1, (w.w >> 16) & 0xff) ^ T_(0, w.w >> 24);
}

// thread t's unit of tile i: four 16-byte loads, zeros for the padding,
// the start register `init` xored into the data's first word
__device__ __forceinline__ void load_unit(const uint8_t* __restrict__ data,
                                          long long off, uint32_t init,
                                          uint4 (&w)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long o = off + 16 * q;
    w[q] = o >= 0 ? __ldg(reinterpret_cast<const uint4*>(data + o))
                  : make_uint4(0u, 0u, 0u, 0u);
    if (o == 0) w[q].x ^= init;
  }
}

__global__ void __launch_bounds__(THREADS)
crc32_blocks(const uint8_t* __restrict__ data, long long pad, uint32_t init,
             const uint32_t* __restrict__ tables,
             uint32_t* __restrict__ block_crc) {
  __shared__ __align__(16) uint32_t T[SMEM_TABLES * 256];
  __shared__ uint32_t warp_crc[THREADS / 32];
  {
    const uint4* src = reinterpret_cast<const uint4*>(tables);
    uint4* dst = reinterpret_cast<uint4*>(T);
    for (int i = threadIdx.x; i < SMEM_TABLES * 64; i += THREADS)
      dst[i] = __ldg(src + i);
  }
  const int t = threadIdx.x;
  // the real offset of this thread's unit in tile 0 (negative: padding)
  const long long base =
      (long long)blockIdx.x * BLOCK_BYTES + (long long)t * UNIT - pad;
  uint4 cur[4], nxt[4];
  load_unit(data, base, init, cur);
  __syncthreads();
  const uint32_t* loop_op = T + LOOP_OP * 256;
  uint32_t acc = 0;
#pragma unroll 1
  for (int i = 0; i < ITERS; ++i) {
    if (i + 1 < ITERS)
      load_unit(data, base + (long long)(i + 1) * TILE, init, nxt);
    uint32_t c = apply_op(loop_op, acc);
    c = fold16(T, c, cur[0]);
    c = fold16(T, c, cur[1]);
    c = fold16(T, c, cur[2]);
    c = fold16(T, c, cur[3]);
    acc = c;
#pragma unroll
    for (int q = 0; q < 4; ++q) cur[q] = nxt[q];
  }
  // carry each register to the block's end: at level j the left half of
  // every group of 2^(j+1) threads shifts by the right half's 64 * 2^j bytes
  const int lane = t & 31;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const uint32_t other = __shfl_xor_sync(0xffffffffu, acc, 1 << j);
    const bool left = !(lane & (1 << j));
    acc = pow2_op(tables, LOG_UNIT + j, left ? acc : other) ^
          (left ? other : acc);
  }
  if (lane == 0) warp_crc[t >> 5] = acc;
  __syncthreads();
  if (t < 32) {
    acc = lane < THREADS / 32 ? warp_crc[lane] : 0u;
#pragma unroll
    for (int j = 5; j < 8; ++j) {
      const uint32_t other = __shfl_xor_sync(0xffffffffu, acc, 1 << (j - 5));
      const bool left = !(lane & (1 << (j - 5)));
      acc = pow2_op(tables, LOG_UNIT + j, left ? acc : other) ^
            (left ? other : acc);
    }
    if (lane == 0) block_crc[blockIdx.x] = acc;
  }
}

__global__ void __launch_bounds__(COMBINE_THREADS)
crc32_combine(const uint32_t* __restrict__ block_crc, int nb,
              const uint8_t* __restrict__ tail, int n_tail, uint32_t init,
              const uint32_t* __restrict__ tables,
              uint32_t* __restrict__ out) {
  __shared__ uint32_t part[COMBINE_THREADS];
  const int t = threadIdx.x;
  int lg = 0;
  while ((COMBINE_THREADS << lg) < nb) ++lg;
  const int per = 1 << lg;
  const int front = per * COMBINE_THREADS - nb;
  uint32_t acc = 0;
  for (int k = 0; k < per; ++k) {
    const int v = t * per + k - front;
    acc = pow2_op(tables, LOG_BLOCK, acc) ^ (v >= 0 ? block_crc[v] : 0u);
  }
  part[t] = acc;
  __syncthreads();
  for (int s = 1, lv = LOG_BLOCK + lg; s < COMBINE_THREADS; s <<= 1, ++lv) {
    if ((t & (2 * s - 1)) == 0)
      part[t] = pow2_op(tables, lv, part[t]) ^ part[t + s];
    __syncthreads();
  }
  if (t == 0) {
    uint32_t c = nb > 0 ? part[0] : init;
    for (int i = 0; i < n_tail; ++i)
      c = (c >> 8) ^ __ldg(tables + ((c ^ tail[i]) & 0xff));
    *out = ~c;
  }
}

}  // namespace

// data: n bytes on the card, 16-byte aligned; tables: ref.py::tables()
// (16-byte aligned); scratch: at least nb + 1 words, nb = ceil(n16 / 256
// KB); the CRC lands in scratch[nb]. Both kernels on `stream`; returns the
// launch's cudaError_t.
extern "C" int crc32_launch(const void* data, long long n, const void* tables,
                            void* scratch, unsigned int prev, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  const uint32_t* tb = static_cast<const uint32_t*>(tables);
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  if (n < 0 || (reinterpret_cast<uintptr_t>(data) & 15) ||
      (reinterpret_cast<uintptr_t>(tables) & 15))
    return (int)cudaErrorInvalidValue;
  const long long n16 = n & ~15LL;
  const long long nb = (n16 + BLOCK_BYTES - 1) / BLOCK_BYTES;
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const uint32_t init = ~prev;           // zlib's preset, chained
  if (nb > 0) {
    crc32_blocks<<<(unsigned)nb, THREADS, 0, s>>>(d, nb * BLOCK_BYTES - n16,
                                                  init, tb, sc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  crc32_combine<<<1, COMBINE_THREADS, 0, s>>>(sc, (int)nb, d + n16,
                                              (int)(n - n16), init, tb,
                                              sc + nb);
  return (int)cudaGetLastError();
}

// registers, local-memory (spill) bytes, static shared memory and resident
// blocks per SM of crc32_blocks
extern "C" int crc32_attrs(int* regs, int* local, int* smem,
                           int* blocks_per_sm) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, crc32_blocks);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                        crc32_blocks,
                                                        THREADS, 0);
  *regs = a.numRegs;
  *local = (int)a.localSizeBytes;
  *smem = (int)a.sharedSizeBytes;
  return (int)err;
}
