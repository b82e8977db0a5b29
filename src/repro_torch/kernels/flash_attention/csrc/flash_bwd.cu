// Flash-attention backward for NVIDIA Hopper (sm_90a), written by hand.
//
// The gradient of the forward in flash_fwd.cu.  The JAX package has no
// backward kernel: it trains through ``chunked_attention``
// (src/repro/models/layers.py:94), the XLA twin of the TPU Pallas kernel
// src/repro/kernels/flash_attention/kernel.py::_flash_fwd_kernel, and XLA
// derives the gradient.  This is that gradient, from the flash-attention
// formulas (Dao 2022, algorithm 2), on the card:
//
//   P  = exp(S * scale - lse)          S = Q K^T, lse from the forward
//   dV = P^T dO
//   dP = dO V^T
//   dS = P * (dP - Delta)              Delta = rowsum(dO * O)
//   dQ = scale * dS K,  dK = scale * dS^T Q
//
// on the mask of the forward: key j is seen by query row i of batch row b
// iff j < kv_len and, when causal, j <= q_offset(b) + i.  GQA: dK and dV of
// a kv head sum the contributions of the query heads of its group.
//
// Bound.  A causal call does 5 products per visible (query, key) pair
// (S, dP, dV, dK, dQ), 2.5x the forward's operations: at (B 4, T 4096, H
// 32, D 64) 0.6950 ms at the bf16 peak (989 TFLOP/s), at (B 4, T 4096, H
// 28, Hkv 4, D 128) 1.2163 ms; the bytes (q, k, v, o, dO, lse read once,
// dq, dk, dv written once) take a tenth of that.  Operations bound it.
//
// Every sum runs in a fixed order: equal inputs give equal outputs bit for
// bit (the trainer's restart check relies on it).  Three paths, which the
// caller names (kernel.py's ``bwd_plan``):
//
//   wgmma (bfloat16, D 32, 64, 128): ``flash_bwd_wgmma``, the Hopper
//      design, one pass.  Each tile is (128 keys, one query head, b), so
//      a GQA group's heads run in parallel, not in a loop.  A block has
//      two consumer warpgroups (64 keys each) and a producer warpgroup:
//      its warp 0 takes tiles and issues the TMA loads, one lane of each
//      of its warps 1 .. DQ_STAGES adds dQ to device memory; setmaxnreg
//      gives the consumers 240 registers and the producer 24, in one
//      if/else on the warpgroup.  The producer feeds K and V of a tile,
//      then per query tile of 64 rows Q, dO (TMA, 128-byte swizzle, or
//      64-byte at D 32; D 128 is two boxes of 64) and that tile's lse *
//      log2(e) and Delta (bulk copies of a padded array,
//      ``flash_bwd_stats``) into a ring of 3 stages (2 at D 128), each
//      guarded by a full and an empty mbarrier, so the next query tiles
//      load while this one computes.  A consumer warpgroup runs all five
//      products as wgmma: S^T = K Q^T and dP^T = V dO^T (operands from
//      shared memory), P^T and dS^T in registers, which is the A-operand
//      layout of dV += P^T dO and dK += dS^T Q (A from registers, dO and
//      Q read transposed).  dS^T also goes to shared memory (128-byte
//      swizzle, fence.proxy.async, a barrier of the warpgroup), and the
//      warpgroup's share of dQ, dS K over its 64 keys, is a wgmma with
//      both operands transposed, in flight with dV and dK.  Warpgroup 0
//      writes its share to a dQ buffer in shared memory, warpgroup 1 adds
//      its own to it (one order), and a reducer lane adds the buffer to
//      an fp32 accumulator in device memory with a bulk reduce-add.  So S
//      and dP are computed once: 5 products per pair, not the 7 of two
//      passes.  ``flash_bwd_dq_convert`` then scales the accumulator and
//      writes dq in bf16.  Three launches: statistics, main, conversion.
//      Determinism: each (query tile, head-dim box) has a counter, and
//      the key tiles that visit a query tile add to it from the last down
//      (``tile_work``): key tile n adds when the counter reads n_last - n
//      and then sets it one higher.  GQA: the heads of a group sum dK and
//      dV in fp32 in head order under a counter per (key tile, consumer
//      warpgroup); the last head writes bf16.  No atomic whose order can
//      vary touches a result.
//      Schedule: a persistent grid of at most one block an SM, whose
//      producers take tiles in index order from a counter (``take_tile``)
//      head by head, the key tiles of a head together (their dQ adds then
//      meet in L2) and its last key tile first (so the tile that adds
//      before another was taken before it).  A tile only ever waits on a
//      tile taken before it, on a block that runs: no deadlock, whatever
//      the number of SMs free.
//   mma (bfloat16, D 160): ``flash_bwd_dkdv_mma`` and ``flash_bwd_dq_mma``,
//      mma.sync.m16n8k16 in 4 warps, a tile copied by cp.async at a time,
//      S and dP computed in both.  D 160 stays here: the dK and dV
//      accumulators of 64 keys alone take 160 registers a thread of a
//      warpgroup, which leaves too few for S, dP and dQ under 240.
//   cuda_core (float32): ``flash_bwd_dkdv`` and ``flash_bwd_dq``, fp32
//      FMAs (the tensor cores' only fp32 product is TF32, which would
//      break the 2e-5 bar), 256 threads as 16 x 16, each tile staged in
//      shared memory at an odd pitch (D + 1).
//
// The five causes that held the first (mma) design back, and the answers
// of the wgmma path: (1) one tile in flight: a TMA ring of 2-3 stages fed
// by a producer warp; (2) mma.sync: wgmma; (3) S and dP computed twice:
// one pass with dQ summed through device memory in a fixed order; (4) a
// serial loop over a GQA group in the longest blocks: a tile per query
// head, taken from a counter by a persistent grid; (5) 32-row query tiles
// at D 128: 64.  What bounds it now: the dQ adds (an fp32 box of 64 rows
// a (key tile, query tile) pair, as much traffic as FlashAttention's
// atomics) and the exponentials and the hand-offs between the roles
// (PERF.md has the readings).
//
// q, k, v, o, dO, dq, dk, dv are strided (B, S, H, D) or (B, H, S, D) views
// with stride 1 in D.  The TMA descriptors are encoded on the host per call
// (cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint: no
// libcuda at link time) and passed as __grid_constant__ parameters, so a
// CUDA graph replays them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_bwd.so flash_bwd.cu
// Bound with ctypes (see ../kernel.py).  The launcher allocates nothing
// (the caller passes the scratch), launches on the stream it is given and
// returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;               // query rows and keys per tile
constexpr int kThreads = 256;           // 16 x 16
constexpr int kPP = kTile + 16;         // pitch of the P and dS tiles

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                     // (B, Hq, Sq) from the forward
  float* delta;                         // (B, Hq, Sq), wgmma (B, Hq, sq_pad)
  float* lse2;                          // wgmma: (B, Hq, sq_pad) lse * log2(e)
  void* dq;
  void* dk;
  void* dv;
  float* dq_accum;                      // wgmma: fp32 dQ sums
  float* dkv_accum;                     // wgmma, GQA: fp32 dK, dV sums
  int* dq_sems;                         // wgmma: counters, zeroed
  int* kv_sems;
  int* tile_counter;                    // wgmma: the next tile to take
  const int* q_offsets;                 // (B,) per-row offsets, or null
  // element strides (b, s, h) of q, k, v, o, dO, dq, dk, dv, in that order
  long long st[8][3];
  int B, sq, sk, hq, hkv, d;
  int sq_pad;                           // rows of delta and lse2 a head
  int kv_len, q_offset, causal;
  float scale;
};

enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

__device__ __forceinline__ long long offset(const BwdParams& p, int t, int b,
                                            int s, int h) {
  return b * p.st[t][0] + s * p.st[t][1] + h * p.st[t][2];
}

// Dynamic shared memory, floats: four fp32 tiles of [kTile][D + 1], then
// P and dS [kTile][kPP], then lse and Delta [kTile] each.
template <int D>
__host__ __device__ constexpr size_t smem_floats() {
  return 4 * (size_t)kTile * (D + 1) + 2 * (size_t)kTile * kPP + 2 * kTile;
}

// kTile rows of tensor ``t`` (head h of batch row b) from row ``r0`` into an
// fp32 tile of pitch D + 1; rows at or past ``rows`` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const BwdParams& p,
                                          const void* src, int t, int b,
                                          int h, int r0, int rows) {
  const T* base = static_cast<const T*>(src);
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D, row = r0 + r;
    dst[r * (D + 1) + c] =
        row < rows ? to_f(base[offset(p, t, b, row, h) + c]) : 0.f;
  }
}

// The 4 x 4 scores of this thread (rows ty + 16a, keys tx + 16c) and the
// same for dO V^T: two 64 x 64 products over D from shared memory.
template <int D>
__device__ __forceinline__ void scores(const float* q_s, const float* k_s,
                                       const float* do_s, const float* v_s,
                                       int tx, int ty, float (&s)[4][4],
                                       float (&dp)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], ka[4], oa[4], va[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = q_s[(ty + 16 * a) * (D + 1) + d];
      oa[a] = do_s[(ty + 16 * a) * (D + 1) + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ka[c] = k_s[(tx + 16 * c) * (D + 1) + d];
      va[c] = v_s[(tx + 16 * c) * (D + 1) + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qa[a], ka[c], s[a][c]);
        dp[a][c] = fmaf(oa[a], va[c], dp[a][c]);
      }
  }
}

// P and dS of this thread's 4 x 4 cells into p_s (unless null) and ds_s:
// rows q0 + ty + 16a, keys k0 + tx + 16c.
__device__ __forceinline__ void p_and_ds(const BwdParams& p, int q_off, int q0,
                                         int k0, int tx, int ty,
                                         const float (&s)[4][4],
                                         const float (&dp)[4][4],
                                         const float* lse_s,
                                         const float* delta_s, float* p_s,
                                         float* ds_s) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, row = q0 + r;
    const int lim = p.causal ? min(p.kv_len, q_off + row + 1) : p.kv_len;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = k0 + tx + 16 * c;
      const bool valid = row < p.sq && key < lim;
      const float pr = valid ? expf(s[a][c] * p.scale - lse_s[r]) : 0.f;
      if (p_s) p_s[r * kPP + tx + 16 * c] = pr;
      ds_s[r * kPP + tx + 16 * c] = pr * (dp[a][c] - delta_s[r]);
    }
  }
}

// Delta = rowsum(dO * O), fp32; one warp a row of (b, h, i).
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(const BwdParams p) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)p.B * p.hq * p.sq) return;
  const int i = row % p.sq;
  const int h = (row / p.sq) % p.hq;
  const int b = row / ((long long)p.sq * p.hq);
  const T* O = static_cast<const T*>(p.o) + offset(p, kO, b, i, h);
  const T* dO = static_cast<const T*>(p.dout) + offset(p, kDO, b, i, h);
  float acc = 0.f;
  for (int c = lane; c < p.d; c += 32) acc = fmaf(to_f(dO[c]), to_f(O[c]), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) p.delta[row] = acc;
}

template <typename T>
cudaError_t launch_delta(const BwdParams& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.hq * p.sq;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > 0x7fffffffLL || p.hq > 65535 || p.B > 65535)
    return cudaErrorInvalidValue;
  flash_bwd_delta<T><<<(unsigned)delta_blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// Query rows [q0, q0 + 64) of head h: Q, dO, lse and Delta into shared memory.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const BwdParams& p, int b, int h,
                                          int q0, float* q_s, float* do_s,
                                          float* lse_s, float* delta_s) {
  load_tile<T, D>(q_s, p, p.q, kQ, b, h, q0, p.sq);
  load_tile<T, D>(do_s, p, p.dout, kDO, b, h, q0, p.sq);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int row = q0 + r;
    const long long at = ((long long)b * p.hq + h) * p.sq + row;
    // a row that sees no key has lse -inf and no valid cell: read as 0
    const float l = row < p.sq ? p.lse[at] : 0.f;
    lse_s[r] = isinf(l) ? 0.f : l;
    delta_s[r] = row < p.sq ? p.delta[at] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(const BwdParams p) {
  constexpr int M = D / 16;                    // head dims per thread
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.hq / p.hkv;
  const int q_off = p.q_offsets ? p.q_offsets[b] : p.q_offset;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * (D + 1);
  float* k_s = do_s + kTile * (D + 1);
  float* v_s = k_s + kTile * (D + 1);
  float* p_s = v_s + kTile * (D + 1);
  float* ds_s = p_s + kTile * kPP;
  float* lse_s = ds_s + kTile * kPP;
  float* delta_s = lse_s + kTile;

  load_tile<T, D>(k_s, p, p.k, kK, b, hk, k0, p.sk);
  load_tile<T, D>(v_s, p, p.v, kV, b, hk, k0, p.sk);

  float dk[4][M], dv[4][M];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int m = 0; m < M; ++m) dk[a][m] = dv[a][m] = 0.f;

  // Query tiles whose rows can see a key of this tile: row i sees key k0
  // iff k0 <= q_off + i, so the first is the one holding row k0 - q_off.
  const int first = p.causal ? max(0, k0 - q_off) / kTile : 0;
  const int n_qt = k0 < p.kv_len ? (p.sq + kTile - 1) / kTile : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qt = first; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();                         // the last tile is consumed
      load_rows<T, D>(p, b, h, q0, q_s, do_s, lse_s, delta_s);
      __syncthreads();
      float s[4][4], dp[4][4];
      scores<D>(q_s, k_s, do_s, v_s, tx, ty, s, dp);
      p_and_ds(p, q_off, q0, k0, tx, ty, s, dp, lse_s, delta_s, p_s, ds_s);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's 64 rows
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {
        float pa[4], sa[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = p_s[r * kPP + ty + 16 * a];
          sa[a] = ds_s[r * kPP + ty + 16 * a];
        }
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float o = do_s[r * (D + 1) + tx + 16 * m];
          const float q = q_s[r * (D + 1) + tx + 16 * m];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            dv[a][m] = fmaf(pa[a], o, dv[a][m]);
            dk[a][m] = fmaf(sa[a], q, dk[a][m]);
          }
        }
      }
    }
  }

  T* DK = static_cast<T*>(p.dk);
  T* DV = static_cast<T*>(p.dv);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= p.sk) continue;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      DK[offset(p, kDK, b, key, hk) + tx + 16 * m] = from_f<T>(dk[a][m] * p.scale);
      DV[offset(p, kDV, b, key, hk) + tx + 16 * m] = from_f<T>(dv[a][m]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(const BwdParams p) {
  constexpr int M = D / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int q_off = p.q_offsets ? p.q_offsets[b] : p.q_offset;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * (D + 1);
  float* k_s = do_s + kTile * (D + 1);
  float* v_s = k_s + kTile * (D + 1);
  float* ds_s = v_s + kTile * (D + 1) + kTile * kPP;
  float* lse_s = ds_s + kTile * kPP;
  float* delta_s = lse_s + kTile;

  load_rows<T, D>(p, b, h, q0, q_s, do_s, lse_s, delta_s);

  float dq[4][M];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int m = 0; m < M; ++m) dq[a][m] = 0.f;

  // Keys the block's rows can see.
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, q_off + min(q0 + kTile, p.sq));
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();                           // the last tile is consumed
    load_tile<T, D>(k_s, p, p.k, kK, b, hk, k0, p.sk);
    load_tile<T, D>(v_s, p, p.v, kV, b, hk, k0, p.sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(q_s, k_s, do_s, v_s, tx, ty, s, dp);
    p_and_ds(p, q_off, q0, k0, tx, ty, s, dp, lse_s, delta_s, nullptr, ds_s);
    __syncthreads();
    // dQ += dS K over the tile's 64 keys
#pragma unroll 2
    for (int c = 0; c < kTile; ++c) {
      float sa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = ds_s[(ty + 16 * a) * kPP + c];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float kk = k_s[c * (D + 1) + tx + 16 * m];
#pragma unroll
        for (int a = 0; a < 4; ++a) dq[a][m] = fmaf(sa[a], kk, dq[a][m]);
      }
    }
  }

  T* DQ = static_cast<T*>(p.dq);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= p.sq) continue;
#pragma unroll
    for (int m = 0; m < M; ++m)
      DQ[offset(p, kDQ, b, row, h) + tx + 16 * m] = from_f<T>(dq[a][m] * p.scale);
  }
}

template <typename T, int D>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = launch_delta<T>(p, stream);
  if (e != cudaSuccess) return e;
  const dim3 kv_grid((p.sk + kTile - 1) / kTile, p.hkv, p.B);
  flash_bwd_dkdv<T, D><<<kv_grid, kThreads, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 q_grid((p.sq + kTile - 1) / kTile, p.hq, p.B);
  flash_bwd_dq<T, D><<<q_grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}


// ---- the mma path (bf16, D 160): mma.sync, as the forward's prefill --------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory row pitch of a bf16 tile: the row plus 16 bytes, so that
// ldmatrix and the 16-byte copies of eight neighbouring rows fall in
// distinct banks.
template <int D> __host__ __device__ constexpr int mpitch() { return D + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// 16 bytes global -> shared; ``src_bytes`` 0 zero-fills without reading.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}
// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ``rows`` rows of bf16 tensor ``t`` (head h of batch row b) from row
// ``r0`` into a tile of pitch mpitch<D>(), 16 bytes a copy; rows at or past
// ``limit`` are zero-filled and not read.
template <int D>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const BwdParams& p, const void* src,
                                          int t, int b, int h, int r0,
                                          int rows, int limit) {
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(src);
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < rows * CH; c += kMmaThreads) {
    const int r = c / CH, ch = c % CH, row = r0 + r;
    const bool in = row < limit;
    cp_async16(dst + r * mpitch<D>() + ch * 8,
               base + offset(p, t, b, in ? row : 0, h) + ch * 8, in ? 16 : 0);
  }
}

// A fragments of rows [row0, row0 + 16) x cols [16 kk, 16 kk + 16) of a tile
// (the m16n8k16 A layout), and B fragments of two n-blocks: rows [row0,
// row0 + 16) of the tile as n, cols [16 kk, +16) as k (``b_rows``), or, with
// ``trans``, rows as k and cols [16 nd, +16) as n.
template <int D>
__device__ __forceinline__ void a_frag(uint32_t (&r)[4],
                                       const __nv_bfloat16* tile, int row0,
                                       int kk, int lane) {
  ldmatrix_x4(r, tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * mpitch<D>() +
                     kk * 16 + (lane >> 4) * 8);
}
template <int D>
__device__ __forceinline__ void b_rows(uint32_t (&r)[4],
                                       const __nv_bfloat16* tile, int row0,
                                       int kk, int lane) {
  ldmatrix_x4(r, tile + (row0 + (lane & 7) + (lane >> 4) * 8) * mpitch<D>() +
                     kk * 16 + ((lane >> 3) & 1) * 8);
}
template <int D>
__device__ __forceinline__ void b_trans(uint32_t (&r)[4],
                                        const __nv_bfloat16* tile, int row0,
                                        int nd, int lane) {
  ldmatrix_x4_trans(r, tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  mpitch<D>() + nd * 16 + (lane >> 4) * 8);
}

// Accumulator n-blocks 2 kc and 2 kc + 1 (16 x 16) as an A fragment.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[N][4],
                                         int kc) {
  a[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// Dynamic shared memory of the tensor-core dK/dV kernel: K and V tiles of
// kTile keys, Q and dO tiles of BQ rows (bf16), then lse * log2(e) and
// Delta of the BQ rows (fp32).
template <int D, int BQ>
__host__ __device__ constexpr size_t mma_dkdv_smem() {
  return (size_t)(2 * kTile + 2 * BQ) * mpitch<D>() * 2 + 2 * BQ * sizeof(float);
}

// One block per (key tile of 64, kv head, b); warp w owns keys 16 w ..
// 16 w + 15 of the tile.  Per query tile of BQ rows it takes S^T = K Q^T
// and dP^T = V dO^T (16 keys x BQ queries a warp) on the tensor cores,
// P^T and dS^T in registers (the accumulator layout is the A layout of the
// next products once rounded to bf16, as the forward's P), then dV += P^T
// dO and dK += dS^T Q.
template <int D, int BQ>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkdv_mma(const BwdParams p) {
  using T = __nv_bfloat16;
  constexpr int P = mpitch<D>();
  constexpr int NB = BQ / 8;                   // n-blocks of S^T
  constexpr int ND = D / 8;                    // n-blocks of dK, dV
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.hq / p.hkv;
  const int q_off = p.q_offsets ? p.q_offsets[b] : p.q_offset;
  const float sl2 = p.scale * kLog2e;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + kTile * P;
  T* q_s = v_s + kTile * P;
  T* do_s = q_s + BQ * P;
  float* lse_s = reinterpret_cast<float*>(do_s + BQ * P);
  float* delta_s = lse_s + BQ;

  copy_rows<D>(k_s, p, p.k, kK, b, hk, k0, kTile, p.sk);
  copy_rows<D>(v_s, p, p.v, kV, b, hk, k0, kTile, p.sk);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  const int wk0 = k0 + warp * 16;              // this warp's first key
  const int first = p.causal ? max(0, k0 - q_off) / BQ : 0;
  const int n_qt = k0 < p.kv_len ? (p.sq + BQ - 1) / BQ : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    for (int qt = first; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();                         // the last tile is consumed
      copy_rows<D>(q_s, p, p.q, kQ, b, h, q0, BQ, p.sq);
      copy_rows<D>(do_s, p, p.dout, kDO, b, h, q0, BQ, p.sq);
      for (int r = tid; r < BQ; r += kMmaThreads) {
        const int row = q0 + r;
        const long long at = ((long long)b * p.hq + h) * p.sq + row;
        const float l = row < p.sq ? p.lse[at] : 0.f;
        lse_s[r] = isinf(l) ? 0.f : l * kLog2e;
        delta_s[r] = row < p.sq ? p.delta[at] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();
      // this warp's keys all past the tile's last row: nothing to add
      const int last_row = min(q0 + BQ, p.sq) - 1;
      if (wk0 >= p.kv_len || (p.causal && wk0 > q_off + last_row)) continue;

      float st[NB][4], dpt[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        a_frag<D>(ka, k_s, warp * 16, kk, lane);
        a_frag<D>(va, v_s, warp * 16, kk, lane);
#pragma unroll
        for (int nb = 0; nb < BQ / 16; ++nb) {
          uint32_t qb[4], ob[4];
          b_rows<D>(qb, q_s, nb * 16, kk, lane);
          mma_bf16(st[2 * nb], ka, qb[0], qb[1]);
          mma_bf16(st[2 * nb + 1], ka, qb[2], qb[3]);
          b_rows<D>(ob, do_s, nb * 16, kk, lane);
          mma_bf16(dpt[2 * nb], va, ob[0], ob[1]);
          mma_bf16(dpt[2 * nb + 1], va, ob[2], ob[3]);
        }
      }
      // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - Delta), on the mask
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = wk0 + g + (i >> 1) * 8;
          const int qi = n * 8 + tig * 2 + (i & 1), row = q0 + qi;
          const bool valid = row < p.sq && key < p.kv_len &&
                             (!p.causal || key <= q_off + row);
          const float pr = valid ? ex2_ftz(fmaf(st[n][i], sl2, -lse_s[qi])) : 0.f;
          st[n][i] = pr;
          dpt[n][i] = pr * (dpt[n][i] - delta_s[qi]);
        }
      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        uint32_t pa[4], sa[4];
        acc_to_a<NB>(pa, st, kc);
        acc_to_a<NB>(sa, dpt, kc);
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t ob[4], qb[4];
          b_trans<D>(ob, do_s, kc * 16, nd, lane);
          mma_bf16(dv[2 * nd], pa, ob[0], ob[1]);
          mma_bf16(dv[2 * nd + 1], pa, ob[2], ob[3]);
          b_trans<D>(qb, q_s, kc * 16, nd, lane);
          mma_bf16(dk[2 * nd], sa, qb[0], qb[1]);
          mma_bf16(dk[2 * nd + 1], sa, qb[2], qb[3]);
        }
      }
    }
  }
  cp_async_wait_all();                         // no copy outlives the block

  T* DK = static_cast<T*>(p.dk);
  T* DV = static_cast<T*>(p.dv);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = wk0 + g + hh * 8;
    if (key >= p.sk) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + tig * 2;
      *reinterpret_cast<__nv_bfloat162*>(DK + offset(p, kDK, b, key, hk) + c) =
          __floats2bfloat162_rn(dk[n][2 * hh] * p.scale, dk[n][2 * hh + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(DV + offset(p, kDV, b, key, hk) + c) =
          __floats2bfloat162_rn(dv[n][2 * hh], dv[n][2 * hh + 1]);
    }
  }
}

// Dynamic shared memory of the tensor-core dQ kernel: Q, dO, K and V tiles
// of 64 rows (bf16).
template <int D>
__host__ __device__ constexpr size_t mma_dq_smem() {
  return (size_t)4 * kTile * mpitch<D>() * 2;
}

// One block per (query tile of 64, query head, b), the last tile first;
// warp w owns rows 16 w .. 16 w + 15.  Per key tile: S = Q K^T and dP =
// dO V^T on the tensor cores, P and dS in registers, dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_mma(const BwdParams p) {
  using T = __nv_bfloat16;
  constexpr int ND = D / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int q_off = p.q_offsets ? p.q_offsets[b] : p.q_offset;
  const float sl2 = p.scale * kLog2e;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + kTile * mpitch<D>();
  T* k_s = do_s + kTile * mpitch<D>();
  T* v_s = k_s + kTile * mpitch<D>();

  copy_rows<D>(q_s, p, p.q, kQ, b, h, q0, kTile, p.sq);
  copy_rows<D>(do_s, p, p.dout, kDO, b, h, q0, kTile, p.sq);

  const int w0 = q0 + warp * 16;               // this warp's first row
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = w0 + g + hh * 8;
    const long long at = ((long long)b * p.hq + h) * p.sq + row;
    const float l = row < p.sq ? p.lse[at] : 0.f;
    lse2[hh] = isinf(l) ? 0.f : l * kLog2e;
    dl[hh] = row < p.sq ? p.delta[at] : 0.f;
  }
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, q_off + min(q0 + kTile, p.sq));
  const bool active = w0 < p.sq;
  const int warp_end = p.causal ? min(p.kv_len, q_off + min(w0 + 16, p.sq)) : p.kv_len;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();                           // the last tile is consumed
    copy_rows<D>(k_s, p, p.k, kK, b, hk, k0, kTile, p.sk);
    copy_rows<D>(v_s, p, p.v, kV, b, hk, k0, kTile, p.sk);
    cp_async_wait_all();                       // (Q and dO too, the first time)
    __syncthreads();
    if (!active || k0 >= warp_end) continue;   // warp-uniform
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      a_frag<D>(qa, q_s, warp * 16, kk, lane);
      a_frag<D>(oa, do_s, warp * 16, kk, lane);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t kb[4], vb[4];
        b_rows<D>(kb, k_s, nb * 16, kk, lane);
        mma_bf16(s[2 * nb], qa, kb[0], kb[1]);
        mma_bf16(s[2 * nb + 1], qa, kb[2], kb[3]);
        b_rows<D>(vb, v_s, nb * 16, kk, lane);
        mma_bf16(dp[2 * nb], oa, vb[0], vb[1]);
        mma_bf16(dp[2 * nb + 1], oa, vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hh = i >> 1, row = w0 + g + hh * 8;
        const int key = k0 + n * 8 + tig * 2 + (i & 1);
        const bool valid = row < p.sq && key < p.kv_len &&
                           (!p.causal || key <= q_off + row);
        const float pr = valid ? ex2_ftz(fmaf(s[n][i], sl2, -lse2[hh])) : 0.f;
        dp[n][i] = pr * (dp[n][i] - dl[hh]);
      }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t sa[4];
      acc_to_a<8>(sa, dp, kc);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t kb[4];
        b_trans<D>(kb, k_s, kc * 16, nd, lane);
        mma_bf16(dq[2 * nd], sa, kb[0], kb[1]);
        mma_bf16(dq[2 * nd + 1], sa, kb[2], kb[3]);
      }
    }
  }

  cp_async_wait_all();                         // no copy outlives the block
  if (!active) return;
  T* DQ = static_cast<T*>(p.dq);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = w0 + g + hh * 8;
    if (row >= p.sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(DQ + offset(p, kDQ, b, row, h) + n * 8 + tig * 2) =
          __floats2bfloat162_rn(dq[n][2 * hh] * p.scale, dq[n][2 * hh + 1] * p.scale);
  }
}

template <int D, int BQ>
cudaError_t launch_mma(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t kv_smem = mma_dkdv_smem<D, BQ>();
  constexpr size_t q_smem = mma_dq_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_mma<D, BQ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kv_smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dq_mma<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  if (e != cudaSuccess) return e;
  e = launch_delta<__nv_bfloat16>(p, stream);
  if (e != cudaSuccess) return e;
  const dim3 kv_grid((p.sk + kTile - 1) / kTile, p.hkv, p.B);
  flash_bwd_dkdv_mma<D, BQ><<<kv_grid, kMmaThreads, kv_smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 q_grid((p.sq + kTile - 1) / kTile, p.hq, p.B);
  flash_bwd_dq_mma<D><<<q_grid, kMmaThreads, q_smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_mma_d(const BwdParams& p, cudaStream_t stream) {
  // D 160 only (the wgmma path takes the others); a dK/dV query tile is
  // 32 rows (the accumulators of dK and dV take 2 D / 4 registers a lane).
  if (p.d != 160) return cudaErrorInvalidValue;
  return launch_mma<160, 32>(p, stream);
}

// ---- the wgmma path (bf16, D 32, 64, 128): Hopper's TMA, mbarriers, wgmma --

constexpr int kBK = 128;                // keys a tile, 64 a consumer warpgroup
constexpr int kBQ = 64;                 // query rows a ring stage
constexpr int kHopperThreads = 384;     // consumers: warpgroups 0, 1; producer 2
constexpr int kTileRing = 4;            // tiles taken ahead by the producer

// The layout of a tile in shared memory, per head dim.  A row of a TMA box
// is BOXW elements (128 bytes, or 64 at D 32) under the swizzle of its
// width; D 128 is two boxes side by side.  Offsets in bytes from a base
// aligned to 1024.
template <int D> struct Geo {
  static constexpr int BOXW = D < 64 ? D : 64;
  static constexpr int ROWB = 2 * BOXW;            // bytes of a box row
  static constexpr int NBOX = D / BOXW;
  static constexpr int KPB = BOXW / 16;            // k-steps of 16 in a box
  static constexpr uint32_t SWZ = ROWB == 128 ? 1 : 2;   // wgmma: 128B, 64B
  static constexpr int STAGES = D >= 128 ? 2 : 3;
  // dQ share buffers, one reducer lane each (the producer warpgroup's
  // warps 1 .. DQ_STAGES; a third buffer and lane at D 32 and 64 measured
  // no faster)
  static constexpr int DQ_STAGES = 2;
  static constexpr int KV_BOX = kBK * ROWB;
  static constexpr int Q_BOX = kBQ * ROWB;
  static constexpr int KV_TILE = NBOX * KV_BOX;
  static constexpr int Q_TILE = NBOX * Q_BOX;
  static constexpr int STAGE = 2 * Q_TILE;         // Q, then dO
  static constexpr int DS_BUF = kBK * kBQ * 2;     // dS^T, [kBK][kBQ] bf16
  static constexpr int DQ_BOX = kBQ * BOXW;        // floats of a dQ share box
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = KV_TILE;
  static constexpr int OFF_Q = 2 * KV_TILE;
  static constexpr int OFF_DS = OFF_Q + STAGES * STAGE;
  static constexpr int OFF_DQ = OFF_DS + 2 * DS_BUF;
  static constexpr int OFF_STATS = OFF_DQ + DQ_STAGES * NBOX * DQ_BOX * 4;
  static constexpr int OFF_TILES = OFF_STATS + STAGES * 2 * kBQ * 4;
  static constexpr int OFF_BAR = OFF_TILES + 4 * kTileRing;
  // kv full, kv empty, q full [STAGES], q empty [STAGES], dq full,
  // dq empty and dq half [DQ_STAGES] each, tile full and tile empty
  // [kTileRing] each
  static constexpr int N_BAR = 2 + 2 * STAGES + 3 * DQ_STAGES + 2 * kTileRing;
  static constexpr int SMEM = OFF_BAR + 8 * N_BAR + 1024;   // + alignment
  static_assert(SMEM <= 232448, "more shared memory than a block has");
  static constexpr int Q_FULL = 2, Q_EMPTY = 2 + STAGES;
  static constexpr int DQ_FULL = 2 + 2 * STAGES, DQ_EMPTY = DQ_FULL + DQ_STAGES;
  static constexpr int DQ_HALF = DQ_EMPTY + DQ_STAGES;
  static constexpr int TILE_FULL = DQ_HALF + DQ_STAGES;
  static constexpr int TILE_EMPTY = TILE_FULL + kTileRing;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the phase of parity ``parity`` of ``bar`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// A box of a 4-d tensor map at coordinates (c0 innermost .. c3) into
// shared memory; completion is counted on ``bar``.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
// ``bytes`` (a multiple of 16) contiguous bytes into shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// dst[i] += src[i] for ``bytes`` / 4 floats, performed in L2.
__device__ __forceinline__ void bulk_reduce_add(float* dst, const void* src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32"
      " [%0], [%1], %2;\n" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}
// ``bytes`` (a multiple of 16) from shared memory to dst.
__device__ __forceinline__ void bulk_store(float* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until the committed bulk copies have read their sources.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Waits until the committed bulk copies have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Orders this thread's generic-proxy accesses with the async proxy's
// (TMA, bulk copies, wgmma's shared-memory operands): of all state spaces,
// or of shared memory only.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* ptr) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(ptr)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* ptr, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(ptr), "r"(v)
               : "memory");
}
__device__ __forceinline__ void st_shared32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
template <int R> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
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
// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the point where it is called.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, swizzle (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swz << 62);
}
// K-major (the contraction dim contiguous in a box row): 8-row groups
// 8 rows apart; a k-step of 16 advances the start by 32 bytes in a box.
template <class G> __device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return make_desc(addr, 16, 8 * G::ROWB, G::SWZ);
}
// MN-major (the contraction dim along the box rows): groups of 8 rows 8
// rows apart, boxes (of BOXW along M or N) ``lbo`` bytes apart.
template <class G>
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, uint32_t lbo) {
  return make_desc(addr, lbo, 8 * G::ROWB, G::SWZ);
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TB));
}

// d (64 x N fp32, the warpgroup's accumulator layout) (+)= A B over k16;
// TA / TB: the operand is MN-major (read transposed).
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (N == 32) wgmma_ss_n32<TA, TB>(d, a, b, accumulate);
  else wgmma_ss_n64<TA, TB>(d, a, b, accumulate);
}
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  if constexpr (N == 32) wgmma_rs_n32<TB>(d, a, b, accumulate);
  else if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, b, accumulate);
  else wgmma_rs_n128<TB>(d, a, b, accumulate);
}

// The tile t of a call: key tile n of query head h of batch row b, its kv
// head, offset, and the query tiles [m0, m1) that see one of its keys.
// Tiles run head by head (the key tiles of a head run at once, so their
// dQ adds meet in L2), the last key tile of a head first.  Key tile n
// visits query tile m iff n kBK < kv_len and, when causal, n kBK <= q_off
// + (m + 1) kBQ - 1: monotone in n, so the key tiles that add to a query
// tile are 0 .. n_last(m) (``last_key_tile``), and they add in the order
// n_last(m), ..., 0: each after the tile taken just before it.
struct TileWork {
  int n, h, b, hk, q_off, m0, m1;
};
__device__ __forceinline__ TileWork tile_work(const BwdParams& p, int t) {
  TileWork w;
  const int n_kt = (p.sk + kBK - 1) / kBK, hb = t / n_kt;
  w.n = n_kt - 1 - t % n_kt;
  w.b = hb / p.hq;
  w.h = hb % p.hq;
  w.hk = w.h / (p.hq / p.hkv);
  w.q_off = p.q_offsets ? p.q_offsets[w.b] : p.q_offset;
  const int k0 = w.n * kBK;
  w.m1 = k0 < p.kv_len ? (p.sq + kBQ - 1) / kBQ : 0;
  w.m0 = p.causal ? min(max(0, k0 - w.q_off) / kBQ, w.m1) : 0;
  return w;
}

// n_last(m): the last key tile that visits query tile m (of a tile's head
// and batch row, whose key tile visits m).
__device__ __forceinline__ int last_key_tile(const BwdParams& p,
                                             const TileWork& w, int m) {
  const int lim = p.causal ? min(p.kv_len, w.q_off + (m + 1) * kBQ) : p.kv_len;
  return (lim - 1) / kBK;
}

// The tiles of a block: its producer takes the next tile of the call from
// a counter in device memory and passes it through a ring in shared
// memory to the consumers and reducers (a tile index past the last ends
// them).  Tiles start in the order of their index, each on a block that
// runs; a tile waits only on tiles taken before it (the next key tile of
// its head; the previous head of its GQA group), and a block works its
// tiles in the order it took them.  So the lowest unfinished tile can
// always go on and no block waits on a block that cannot run.
__device__ __forceinline__ int take_tile(uint64_t* bars, const int* tiles,
                                         int full, int empty, int jt) {
  const int slot = jt % kTileRing;
  mbar_wait(&bars[full + slot], (jt / kTileRing) & 1);
  const int t = *reinterpret_cast<const volatile int*>(tiles + slot);
  mbar_arrive(&bars[empty + slot]);
  return t;
}

// Producer warp: K and V of each tile, then Q, dO, lse2 and Delta of each
// query tile it visits into the ring.
template <int D>
__device__ __forceinline__ void bwd_producer(const CUtensorMap* tm_q,
                                             const CUtensorMap* tm_k,
                                             const CUtensorMap* tm_v,
                                             const CUtensorMap* tm_do,
                                             const BwdParams& p,
                                             unsigned char* sm, uint64_t* bars,
                                             int n_tiles) {
  using G = Geo<D>;
  int* tiles = reinterpret_cast<int*>(sm + G::OFF_TILES);
  int it = 0;
  for (int jt = 0;; ++jt) {
    const int slot = jt % kTileRing;
    mbar_wait(&bars[G::TILE_EMPTY + slot], ((jt / kTileRing) & 1) ^ 1);
    const int t = atomicAdd(p.tile_counter, 1);
    *reinterpret_cast<volatile int*>(tiles + slot) = t;
    mbar_arrive(&bars[G::TILE_FULL + slot]);
    if (t >= n_tiles) break;
    const TileWork w = tile_work(p, t);
    mbar_wait(&bars[1], (jt & 1) ^ 1);
    mbar_expect_tx(&bars[0], 2 * G::KV_TILE);
#pragma unroll
    for (int c = 0; c < G::NBOX; ++c) {
      tma_load(sm + G::OFF_K + c * G::KV_BOX, tm_k, &bars[0], c * G::BOXW,
               w.n * kBK, w.hk, w.b);
      tma_load(sm + G::OFF_V + c * G::KV_BOX, tm_v, &bars[0], c * G::BOXW,
               w.n * kBK, w.hk, w.b);
    }
    const long long row0 = ((long long)w.b * p.hq + w.h) * p.sq_pad;
    for (int m = w.m0; m < w.m1; ++m, ++it) {
      const int s = it % G::STAGES;
      mbar_wait(&bars[G::Q_EMPTY + s], ((it / G::STAGES) & 1) ^ 1);
      uint64_t* full = &bars[G::Q_FULL + s];
      mbar_expect_tx(full, G::STAGE + 2 * kBQ * 4);
      unsigned char* st = sm + G::OFF_Q + s * G::STAGE;
#pragma unroll
      for (int c = 0; c < G::NBOX; ++c) {
        tma_load(st + c * G::Q_BOX, tm_q, full, c * G::BOXW, m * kBQ, w.h, w.b);
        tma_load(st + G::Q_TILE + c * G::Q_BOX, tm_do, full, c * G::BOXW,
                 m * kBQ, w.h, w.b);
      }
      float* stats = reinterpret_cast<float*>(sm + G::OFF_STATS) + s * 2 * kBQ;
      bulk_load(stats, p.lse2 + row0 + m * kBQ, kBQ * 4, full);
      bulk_load(stats + kBQ, p.delta + row0 + m * kBQ, kBQ * 4, full);
    }
  }
}

// Reducer lane of dQ buffer ``buf`` (one lane a buffer, so DQ_STAGES adds
// are in flight): adds the dQ shares of the iterations that use that
// buffer to the fp32 accumulator, in the order n_last(m), ..., 0 of the key
// tiles (the first writes it: it is not zeroed): box c of query tile m
// waits until its counter reads n_last(m) - n, and is set one higher once
// the add has completed.  The buffer goes back to
// the consumers as soon as the add has read it.
template <int D>
__device__ __forceinline__ void bwd_reducer(const BwdParams& p,
                                            unsigned char* sm, uint64_t* bars,
                                            int n_tiles, int buf) {
  using G = Geo<D>;
  const int* tiles = reinterpret_cast<const int*>(sm + G::OFF_TILES);
  const int mq = (p.sq + kBQ - 1) / kBQ;
  int it = 0;
  for (int jt = 0;; ++jt) {
    const int t = take_tile(bars, tiles, G::TILE_FULL, G::TILE_EMPTY, jt);
    if (t >= n_tiles) break;
    const TileWork w = tile_work(p, t);
    const long long head0 = ((long long)w.b * p.hq + w.h) * mq;
    for (int m = w.m0; m < w.m1; ++m, ++it) {
      if (it % G::DQ_STAGES != buf) continue;
      const int turn = last_key_tile(p, w, m) - w.n;
      int* sems = p.dq_sems + (head0 + m) * G::NBOX;
      if (turn > 0) {                           // the tiles before are in
#pragma unroll
        for (int c = 0; c < G::NBOX; ++c)
          while (ld_acquire(sems + c) != turn) {
          }
        fence_proxy_async();
      }
      mbar_wait(&bars[G::DQ_FULL + buf], (it / G::DQ_STAGES) & 1);
#pragma unroll
      for (int c = 0; c < G::NBOX; ++c) {       // the first writes, the rest add
        float* dst = p.dq_accum + ((head0 + m) * G::NBOX + c) * G::DQ_BOX;
        const void* src = sm + G::OFF_DQ + (buf * G::NBOX + c) * G::DQ_BOX * 4;
        if (turn == 0) bulk_store(dst, src, G::DQ_BOX * 4);
        else bulk_reduce_add(dst, src, G::DQ_BOX * 4);
      }
      bulk_commit();
      bulk_wait_read();
      mbar_arrive(&bars[G::DQ_EMPTY + buf]);
      bulk_wait();
      fence_proxy_async();
      __threadfence();
#pragma unroll
      for (int c = 0; c < G::NBOX; ++c) st_release(sems + c, turn + 1);
    }
  }
}

// Consumer warpgroup ``wg``: keys 64 wg .. 64 wg + 63 of each tile.
template <int D>
__device__ __forceinline__ void bwd_consumer(const BwdParams& p,
                                             unsigned char* sm, uint64_t* bars,
                                             int n_tiles, int wg) {
  using G = Geo<D>;
  constexpr int NA = D / 2;                     // registers of dK (and dV)
  const int tid = threadIdx.x & 127, wi = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float sl2 = p.scale * kLog2e;
  const int n_kt = (p.sk + kBK - 1) / kBK;
  const uint32_t k_base = smem_addr(sm + G::OFF_K);
  const uint32_t v_base = smem_addr(sm + G::OFF_V);
  const float* stats0 = reinterpret_cast<const float*>(sm + G::OFF_STATS);
  // this thread's dS^T rows (keys of the tile): ra and ra + 8
  const int ra = wg * 64 + 16 * wi + g;
  const int* tiles = reinterpret_cast<const int*>(sm + G::OFF_TILES);
  int it = 0;
  for (int jt = 0;; ++jt) {
    const int t = take_tile(bars, tiles, G::TILE_FULL, G::TILE_EMPTY, jt);
    if (t >= n_tiles) break;
    const TileWork w = tile_work(p, t);
    float dk[NA], dv[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.f;
    const int key_a = w.n * kBK + ra;           // and key_a + 8
    mbar_wait(&bars[0], jt & 1);
    for (int m = w.m0; m < w.m1; ++m, ++it) {
      const int s = it % G::STAGES;
      mbar_wait(&bars[G::Q_FULL + s], (it / G::STAGES) & 1);
      const uint32_t q_s = smem_addr(sm + G::OFF_Q + s * G::STAGE);
      const uint32_t do_s = q_s + G::Q_TILE;
      const float* lse_s = stats0 + s * 2 * kBQ;
      const float* dl_s = lse_s + kBQ;

      // S^T = K Q^T, dP^T = V dO^T: 64 keys x 64 query rows
      float sacc[32], pacc[32];
      fence_regs(sacc);
      fence_regs(pacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t koff = (kk / G::KPB) * G::KV_BOX + wg * 64 * G::ROWB +
                              (kk % G::KPB) * 32;
        const uint32_t qoff = (kk / G::KPB) * G::Q_BOX + (kk % G::KPB) * 32;
        wgmma_ss<64, 0, 0>(sacc, kmajor<G>(k_base + koff), kmajor<G>(q_s + qoff), kk);
        wgmma_ss<64, 0, 0>(pacc, kmajor<G>(v_base + koff), kmajor<G>(do_s + qoff), kk);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sacc);
      fence_regs(pacc);

      // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - Delta) on the mask;
      // element 4 j + e: key key_a + 8 (e >> 1), row m kBQ + 8 j + 2 t4 + (e & 1).
      // A tile whose keys every row sees takes the loop without the mask.
      const int k_hi = w.n * kBK + kBK - 1;
      if (k_hi < p.kv_len && m * kBQ + kBQ <= p.sq &&
          (!p.causal || k_hi <= w.q_off + m * kBQ)) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
          const float2 dl = *reinterpret_cast<const float2*>(dl_s + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pr = ex2_ftz(fmaf(sacc[4 * j + e], sl2, (e & 1) ? -l2.y : -l2.x));
            sacc[4 * j + e] = pr;
            pacc[4 * j + e] = pr * (pacc[4 * j + e] - ((e & 1) ? dl.y : dl.x));
          }
        }
      } else {
        // key <= q_off + row as key - q_off <= row; rows past Sq and keys
        // past kv_len see nothing
        const int kq = p.causal ? key_a - w.q_off : -(1 << 30);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
          const float2 dl = *reinterpret_cast<const float2*>(dl_s + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = m * kBQ + 8 * j + 2 * t4 + (e & 1);
            const int dk8 = 8 * (e >> 1);
            const bool valid = row < p.sq && key_a + dk8 < p.kv_len && kq + dk8 <= row;
            const float pr = valid ? ex2_ftz(fmaf(sacc[4 * j + e], sl2,
                                                  (e & 1) ? -l2.y : -l2.x))
                                   : 0.f;
            sacc[4 * j + e] = pr;
            pacc[4 * j + e] = pr * (pacc[4 * j + e] - ((e & 1) ? dl.y : dl.x));
          }
        }
      }
      // A fragments of k-step kc (query rows 16 kc .. 16 kc + 15)
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kc][r] = pack_bf16(sacc[8 * kc + 2 * r], sacc[8 * kc + 2 * r + 1]);
          sa[kc][r] = pack_bf16(pacc[8 * kc + 2 * r], pacc[8 * kc + 2 * r + 1]);
        }
      // dS^T into shared memory, [key][query row] under the 128-byte
      // swizzle: 16-byte chunk q / 8 of row r at chunk (q / 8) ^ (r % 8)
      const uint32_t ds_s = smem_addr(sm + G::OFF_DS + (it & 1) * G::DS_BUF);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = ra + 8 * (r & 1), chunk = 2 * kc + (r >> 1);
          st_shared32(ds_s + row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * t4, sa[kc][r]);
        }

      fence_proxy_async_shared();               // dS^T, before wgmma reads it
      named_sync(2 + wg, 128);                  // the warpgroup's rows stored

      // dV += P^T dO, dK += dS^T Q (A from registers, dO and Q MN-major),
      // and dQ's share of this warpgroup's keys, box by box: dS (64 rows x
      // 64 keys, dS^T read transposed) times K (read transposed), box 0
      // in flight with dV and dK
      const uint32_t ds_a = ds_s + wg * 64 * 128;
      const uint32_t k_rows = k_base + wg * 64 * G::ROWB;
      const int buf = it % G::DQ_STAGES;
      float2* dq_buf = reinterpret_cast<float2*>(sm + G::OFF_DQ) +
                       buf * G::NBOX * (G::DQ_BOX / 2);
#pragma unroll
      for (int c = 0; c < G::NBOX; ++c) {
        float dq[G::BOXW / 2];
        fence_regs(dq);
        if (c == 0) {
          fence_regs(dk);
          fence_regs(dv);
        }
        wgmma_fence();
        if (c == 0) {
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
            const uint32_t off = kc * 16 * G::ROWB;
            wgmma_rs<D, 1>(dv, pa[kc], mnmajor<G>(do_s + off, G::Q_BOX), 1);
            wgmma_rs<D, 1>(dk, sa[kc], mnmajor<G>(q_s + off, G::Q_BOX), 1);
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<G::BOXW, 1, 1>(
              dq, make_desc(ds_a + kk * 16 * 128, 16, 1024, 1),
              mnmajor<G>(k_rows + c * G::KV_BOX + kk * 16 * G::ROWB, G::KV_BOX), kk);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dq);
        if (c == 0) {
          fence_regs(dk);
          fence_regs(dv);
          fence_regs(pa);
          fence_regs(sa);
          mbar_arrive(&bars[G::Q_EMPTY + s]);   // Q, dO, lse2, Delta read
          // warpgroup 0 writes its share once the reducer has taken the
          // buffer's last one; warpgroup 1 adds its own once 0's is there
          if (wg == 0) mbar_wait(&bars[G::DQ_EMPTY + buf], ((it / G::DQ_STAGES) & 1) ^ 1);
          else mbar_wait(&bars[G::DQ_HALF + buf], (it / G::DQ_STAGES) & 1);
        }
        // fragment-major: float2 k of thread tid at k * 128 + tid
        float2* dst = dq_buf + c * (G::DQ_BOX / 2);
#pragma unroll
        for (int k = 0; k < G::BOXW / 4; ++k) {
          float2 v = make_float2(dq[2 * k], dq[2 * k + 1]);
          if (wg == 1) {
            const float2 a = dst[k * 128 + tid];
            v = make_float2(a.x + v.x, a.y + v.y);
          }
          dst[k * 128 + tid] = v;
        }
      }
      if (wg == 0) {
        mbar_arrive(&bars[G::DQ_HALF + buf]);
      } else {
        fence_proxy_async_shared();             // before the bulk add reads it
        mbar_arrive(&bars[G::DQ_FULL + buf]);
      }
    }
    mbar_arrive(&bars[1]);                      // K and V read

    // dK and dV of keys key_a + 8 (k & 1), dims 8 (k >> 1) + 2 t4 + {0, 1}
    using T = __nv_bfloat16;
    T* DK = static_cast<T*>(p.dk);
    T* DV = static_cast<T*>(p.dv);
    const int group = p.hq / p.hkv, gi = w.h % group;
    const long long r = ((long long)w.b * p.hkv + w.hk) * n_kt + w.n;
    float2* acc = reinterpret_cast<float2*>(p.dkv_accum) + (r * 2 + wg) * (long long)NA * 128;
    int* sem = p.kv_sems + r * 2 + wg;
    if (group > 1 && gi > 0) {                  // the heads before this one
      if (tid == 0)
        while (ld_acquire(sem) != gi) {
        }
      named_sync(2 + wg, 128);
    }
#pragma unroll
    for (int k = 0; k < D / 4; ++k) {
      float2 a = make_float2(dk[2 * k], dk[2 * k + 1]);
      float2 v = make_float2(dv[2 * k], dv[2 * k + 1]);
      float2* pk = acc + k * 128 + tid;
      float2* pv = acc + (D / 4 + k) * 128 + tid;
      if (group > 1 && gi > 0) {
        const float2 x = __ldcg(pk), y = __ldcg(pv);
        a = make_float2(x.x + a.x, x.y + a.y);
        v = make_float2(y.x + v.x, y.y + v.y);
      }
      if (gi == group - 1) {
        const int key = key_a + 8 * (k & 1), col = 8 * (k >> 1) + 2 * t4;
        if (key < p.sk) {
          *reinterpret_cast<__nv_bfloat162*>(DK + offset(p, kDK, w.b, key, w.hk) + col) =
              __floats2bfloat162_rn(a.x * p.scale, a.y * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(DV + offset(p, kDV, w.b, key, w.hk) + col) =
              __floats2bfloat162_rn(v.x, v.y);
        }
      } else {
        __stcg(pk, a);
        __stcg(pv, v);
      }
    }
    if (gi < group - 1) {                       // the next head may go on
      __threadfence();
      named_sync(2 + wg, 128);
      if (tid == 0) st_release(sem, gi + 1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_bwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const BwdParams p) {
  using G = Geo<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + G::OFF_BAR);
  const int n_tiles = ((p.sk + kBK - 1) / kBK) * p.B * p.hq;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 256);
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&bars[G::Q_FULL + s], 1);
      mbar_init(&bars[G::Q_EMPTY + s], 256);
    }
    for (int i = 0; i < G::DQ_STAGES; ++i) {
      mbar_init(&bars[G::DQ_FULL + i], 128);
      mbar_init(&bars[G::DQ_EMPTY + i], 1);
      mbar_init(&bars[G::DQ_HALF + i], 128);
    }
    for (int i = 0; i < kTileRing; ++i) {
      mbar_init(&bars[G::TILE_FULL + i], 1);
      mbar_init(&bars[G::TILE_EMPTY + i], 256 + G::DQ_STAGES);   // all readers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<24>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    if (warp == 0 && lane == 0)
      bwd_producer<D>(&tm_q, &tm_k, &tm_v, &tm_do, p, sm, bars, n_tiles);
    else if (warp <= G::DQ_STAGES && lane == 0)
      bwd_reducer<D>(p, sm, bars, n_tiles, warp - 1);
  } else {
    setmaxnreg_inc<240>();
    bwd_consumer<D>(p, sm, bars, n_tiles, wg);
  }
}

// dq = scale * the fp32 accumulator in bf16: a block a box of kBQ rows x
// BOXW dims, read in its fragment-major order (coalesced), turned into rows
// in shared memory, written 16 bytes a thread (whole rows a few lanes).
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dq_convert(const BwdParams p) {
  using G = Geo<D>;
  constexpr int PITCH = G::BOXW + 4;            // floats: rows in distinct banks
  __shared__ __align__(16) float rows_s[kBQ * PITCH];
  const int mq = (p.sq + kBQ - 1) / kBQ;
  const long long box = blockIdx.x;
  const int c = box % G::NBOX;
  const int m = (box / G::NBOX) % mq;
  const long long bh = box / ((long long)G::NBOX * mq);
  const int h = bh % p.hq, b = bh / p.hq;
  const float2* acc = reinterpret_cast<const float2*>(p.dq_accum) + box * (G::DQ_BOX / 2);
  // float2 f = k * 128 + tid of the consumer thread tid: row 16 (tid >> 5)
  // + (tid & 31) / 4 + 8 (k & 1), dims 8 (k >> 1) + 2 (tid & 3)
  for (int f = threadIdx.x; f < G::DQ_BOX / 2; f += 256) {
    const int tid = f & 127, k = f >> 7, lane = tid & 31;
    const int r = 16 * (tid >> 5) + (lane >> 2) + 8 * (k & 1);
    const int col = 8 * (k >> 1) + 2 * (lane & 3);
    // no key at all (kv_len 0): no tile wrote the box, and dq is 0
    *reinterpret_cast<float2*>(rows_s + r * PITCH + col) =
        p.kv_len > 0 ? acc[f] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  constexpr int CHUNKS = G::BOXW / 8;           // 16 bytes of bf16 a chunk
  __nv_bfloat16* DQ = static_cast<__nv_bfloat16*>(p.dq);
  for (int q = threadIdx.x; q < kBQ * CHUNKS; q += 256) {
    const int r = q / CHUNKS, ch = q % CHUNKS, row = m * kBQ + r;
    if (row >= p.sq) continue;
    const float* src = rows_s + r * PITCH + 8 * ch;
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = pack_bf16(src[2 * k] * p.scale, src[2 * k + 1] * p.scale);
    *reinterpret_cast<uint4*>(DQ + offset(p, kDQ, b, row, h) + c * G::BOXW + 8 * ch) = out;
  }
}

// The wgmma path's per-row statistics, sq_pad rows a head: Delta =
// rowsum(dO * O) and the forward's lse times log2(e) (0 where a row sees
// no key), both 0 past Sq.  D / 8 neighbouring lanes take a row, 16 bytes
// each (O and dO rows are 16-byte aligned on this path), so a warp reads
// whole rows.
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_stats(const BwdParams p) {
  constexpr int LPR = D / 8;                    // lanes a row
  const long long row = ((long long)blockIdx.x * 256 + threadIdx.x) / LPR;
  const int part = threadIdx.x % LPR;
  const long long rows = (long long)p.B * p.hq * p.sq_pad;
  const int i = row % p.sq_pad;
  const long long bh = row / p.sq_pad;
  const int h = bh % p.hq, b = bh / p.hq;
  float acc = 0.f;
  if (row < rows && i < p.sq) {
    const uint4 x = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.o) + offset(p, kO, b, i, h))[part];
    const uint4 y = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.dout) + offset(p, kDO, b, i, h))[part];
    const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 u = __bfloat1622float2(xa[k]), v = __bfloat1622float2(ya[k]);
      acc = fmaf(v.x, u.x, acc);
      acc = fmaf(v.y, u.y, acc);
    }
  }
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (row < rows && part == 0) {
    const float l = i < p.sq ? p.lse[bh * p.sq + i] : 0.f;
    p.delta[row] = acc;
    p.lse2[row] = isinf(l) ? 0.f : l * kLog2e;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links no libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-d map (D, S, H, B) of a bf16 tensor with element strides st (b, s,
// h), boxes of (boxw, rows, 1, 1) under the swizzle of a boxw row.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
              const long long* st, int S, int H, int B, int D, int boxw,
              int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)boxw, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             boxw * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const BwdParams& p, int sms, cudaStream_t stream) {
  using G = Geo<D>;
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(enc, &tq, p.q, p.st[kQ], p.sq, p.hq, p.B, D, G::BOXW, kBQ) ||
      !make_map(enc, &tdo, p.dout, p.st[kDO], p.sq, p.hq, p.B, D, G::BOXW, kBQ) ||
      !make_map(enc, &tk, p.k, p.st[kK], p.sk, p.hkv, p.B, D, G::BOXW, kBK) ||
      !make_map(enc, &tv, p.v, p.st[kV], p.sk, p.hkv, p.B, D, G::BOXW, kBK))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  const long long stat_blocks = ((long long)p.B * p.hq * p.sq_pad * (D / 8) + 255) / 256;
  if (stat_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_stats<D><<<(unsigned)stat_blocks, 256, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n_tiles = (long long)((p.sk + kBK - 1) / kBK) * p.B * p.hq;
  if (n_tiles > 0x7fffffffLL || sms < 1) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(n_tiles < sms ? n_tiles : sms);
  if (grid > 0)
    flash_bwd_wgmma<D><<<grid, kHopperThreads, G::SMEM, stream>>>(tq, tk, tv, tdo, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long boxes = (long long)p.B * p.hq * (p.sq_pad / kBQ) * G::NBOX;
  if (boxes > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dq_convert<D><<<(unsigned)boxes, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_wgmma_d(const BwdParams& p, int sms, cudaStream_t stream) {
  switch (p.d) {
    case 32: return launch_wgmma<32>(p, sms, stream);
    case 64: return launch_wgmma<64>(p, sms, stream);
    case 128: return launch_wgmma<128>(p, sms, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_f32_d(const BwdParams& p, cudaStream_t stream) {
  switch (p.d) {
    case 32: return launch<float, 32>(p, stream);
    case 64: return launch<float, 64>(p, stream);
    case 128: return launch<float, 128>(p, stream);
    case 160: return launch<float, 160>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// path: 0 = cuda_core (float32), 1 = mma (bfloat16, D 160), 2 = wgmma
// (bfloat16, D 32, 64, 128); q, k, v, o, dO and the three outputs share
// the dtype.  strides: 24 element strides, the (b, s, h) strides of q, k,
// v, o, dO, dq, dk, dv in that order; the d stride is 1 (the tensor-core
// paths also read q, k, v and dO rows 16 bytes at a time).  lse: the
// forward's (B, Hq, Sq) log-sum-exp.  stats: B Hq Sq floats of scratch
// (Delta), or on the wgmma path 2 B Hq sq_pad (lse * log2(e), then Delta;
// sq_pad = Sq rounded up to 64).  wgmma path only: dq_accum, B Hq sq_pad
// D floats; sems, B Hq (sq_pad / 64) (D / 64, at least 1) ints for dQ,
// then B Hkv ceil(Sk / 128) 2 for dK and dV, then the tile counter, all
// zero; dkv_accum, B
// Hkv ceil(Sk / 128) 256 D floats where Hq > Hkv, else null; sms: the
// most blocks to run at once (one an SM).  q_offsets: null, or B ints on
// the device.  Returns a cudaError_t.
int flash_bwd(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* stats, void* dq,
              void* dk, void* dv, float* dq_accum, float* dkv_accum,
              int* sems, int path, int B, int Hq, int Hkv, int Sq, int Sk,
              int D, const long long* strides, int kv_len, int q_offset,
              const int* q_offsets, int causal, float scale, int sms,
              void* stream) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = lse;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.q_offsets = q_offsets;
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) p.st[t][j] = strides[3 * t + j];
  p.B = B; p.sq = Sq; p.sk = Sk; p.hq = Hq; p.hkv = Hkv; p.d = D;
  p.kv_len = kv_len; p.q_offset = q_offset; p.causal = causal;
  p.scale = scale;
  p.sq_pad = (Sq + kBQ - 1) / kBQ * kBQ;
  p.delta = stats;
  p.lse2 = nullptr;
  p.dq_accum = dq_accum;
  p.dkv_accum = dkv_accum;
  p.dq_sems = sems;
  p.kv_sems = nullptr;
  p.tile_counter = nullptr;
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 0) return (int)launch_f32_d(p, st);
  if (path == 1) return (int)launch_mma_d(p, st);
  if (path != 2) return (int)cudaErrorInvalidValue;
  const long long heads = (long long)B * Hq, rows = heads * p.sq_pad;
  p.lse2 = stats;
  p.delta = stats + rows;
  p.kv_sems = sems + heads * (p.sq_pad / kBQ) * (D < 64 ? 1 : D / 64);
  p.tile_counter = p.kv_sems + (long long)B * Hkv * ((Sk + kBK - 1) / kBK) * 2;
  if (Hq > Hkv && !dkv_accum) return (int)cudaErrorInvalidValue;
  return (int)launch_wgmma_d(p, sms, st);
}

// The wgmma path's tiles at head dim D into out[0..7]: keys a tile, query
// rows a stage, box width, boxes, ring stages, dQ share stages, threads a
// block, dynamic shared memory bytes.  Returns 0, or cudaErrorInvalidValue
// for a head dim the path does not take.
int flash_bwd_geometry(int D, int* out) {
  int smem, stages, dq_stages;
  switch (D) {
    case 32: smem = Geo<32>::SMEM; stages = Geo<32>::STAGES; dq_stages = Geo<32>::DQ_STAGES; break;
    case 64: smem = Geo<64>::SMEM; stages = Geo<64>::STAGES; dq_stages = Geo<64>::DQ_STAGES; break;
    case 128: smem = Geo<128>::SMEM; stages = Geo<128>::STAGES; dq_stages = Geo<128>::DQ_STAGES; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int boxw = D < 64 ? D : 64;
  const int vals[8] = {kBK, kBQ, boxw, D / boxw, stages, dq_stages,
                       kHopperThreads, smem};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
