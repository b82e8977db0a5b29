// Flash-attention backward for NVIDIA Hopper (sm_90a), written by hand.
//
// The gradient of the forward in flash_fwd.cu.  The JAX package has no
// backward kernel: it trains through ``chunked_attention``
// (src/repro/models/layers.py), the XLA twin of the TPU Pallas kernel
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
// Three kernels, launched in order on the caller's stream by one C entry:
//   1. ``flash_bwd_delta``: Delta = rowsum(dO * O) in fp32, a warp a row;
//   2. a dK/dV kernel: one block per (key tile of 64, kv head, b); it
//      holds its K and V tile in shared memory and loops over the group's
//      query heads and over the query tiles that see its keys, recomputing
//      P and dS per (query tile, key tile) and accumulating dK and dV in
//      registers; it writes dK and dV once;
//   3. a dQ kernel: one block per (query tile of 64, query head, b); it
//      loops over the key tiles its rows see and accumulates dQ in
//      registers, recomputing P and dS.
// No block adds into another's output and every sum runs in a fixed
// order: no atomics, so the result is the same bit for bit from run to
// run (the restart check of the trainer relies on it).
//
// Two paths for kernels 2 and 3, chosen by dtype:
//
//   bfloat16: ``flash_bwd_dkdv_mma`` and ``flash_bwd_dq_mma``, on the
//      tensor cores (mma.sync.m16n8k16, bf16 operands, fp32 accumulators),
//      4 warps a block.  Bound: operations; a causal (B 4, T 4096, H 32,
//      D 64) call needs ~2.5x the forward's FLOPs (~0.70 ms at the bf16
//      peak).  In the dK/dV kernel a warp owns 16 keys and computes S^T =
//      K Q^T and dP^T = V dO^T, so P^T and dS^T come out of the products
//      in the layout of the A operand of the next ones (dV += P^T dO, dK
//      += dS^T Q), rounded to bf16 in registers as the forward's P is; a
//      query tile is 64 rows (32 at D 128 and 160, where the dK and dV
//      accumulators take 2 D / 4 registers a lane).  The dQ kernel is the
//      forward's shape: a warp owns 16 query rows, S = Q K^T and dP =
//      dO V^T, then dQ += dS K.  Tiles are copied by cp.async (16 bytes,
//      rows past the end zero-filled) into rows padded by 16 bytes, and
//      read by ldmatrix (.trans for the B operands of dV, dK and dQ).
//      Both kernels recompute S and dP; one tile is in flight at a time.
//   float32: CUDA cores, fp32 FMAs, as the float32 forward (the tensor
//      cores' only fp32 product is TF32, which would break the 2e-5 bar):
//      ``flash_bwd_dkdv`` and ``flash_bwd_dq``, 256 threads as 16
//      x 16, each tile staged in shared memory.  For S and dP a thread owns rows ty +
//      16a and keys tx + 16c (a, c < 4) of the 64 x 64 tile; for the
//      accumulators it owns 4 keys (dkdv) or rows (dq), ty + 16a, by D /
//      16 head dims tx + 16m.  The tiles are padded to an odd pitch
//      (D + 1), so a column of 16 rows falls in 16 banks; P and dS to a
//      pitch of 80.  Its inner products are limited by shared-memory loads
//      (8 loads for 16 FMAs).  D 160 uses 206 KB of shared memory a block.
//
// q, k, v, o, dO, dq, dk, dv are strided (B, S, H, D) or (B, H, S, D) views
// with stride 1 in D.  wgmma with TMA-fed tiles, a ring of tiles in
// flight, and one pass for dQ as well (a deterministic reduction, not
// atomics) are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_bwd.so flash_bwd.cu
// Bound with ctypes (see ../kernel.py).  The launcher allocates nothing,
// launches on the stream it is given and returns cudaGetLastError().

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
  float* delta;                         // (B, Hq, Sq) scratch
  void* dq;
  void* dk;
  void* dv;
  const int* q_offsets;                 // (B,) per-row offsets, or null
  // element strides (b, s, h) of q, k, v, o, dO, dq, dk, dv, in that order
  long long st[8][3];
  int B, sq, sk, hq, hkv, d;
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
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
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


// ---- the tensor-core path (bf16): mma.sync, as the forward's prefill -------

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
  // 64 query rows a dK/dV tile where its registers allow; 32 at D 128
  // and 160 (the accumulators of dK and dV take 2 D / 4 registers a lane).
  switch (p.d) {
    case 32: return launch_mma<32, 64>(p, stream);
    case 64: return launch_mma<64, 64>(p, stream);
    case 128: return launch_mma<128, 32>(p, stream);
    case 160: return launch_mma<160, 32>(p, stream);
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

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); q, k, v,
// o, dO and the three outputs share it.  strides: 24 element strides,
// the (b, s, h) strides of q, k, v, o, dO, dq, dk, dv in that order; the d
// stride is 1 (the tensor-core path also reads q, k, v and dO rows 16
// bytes at a time).  lse: the forward's (B, Hq, Sq) log-sum-exp; delta:
// B * Hq * Sq floats of scratch.  q_offsets: null, or B ints on the
// device.  Returns a cudaError_t.
int flash_bwd(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, int dtype, int B, int Hq, int Hkv, int Sq,
              int Sk, int D, const long long* strides, int kv_len,
              int q_offset, const int* q_offsets, int causal, float scale,
              void* stream) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.q_offsets = q_offsets;
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) p.st[t][j] = strides[3 * t + j];
  p.B = B; p.sq = Sq; p.sk = Sk; p.hq = Hq; p.hkv = Hkv; p.d = D;
  p.kv_len = kv_len; p.q_offset = q_offset; p.causal = causal;
  p.scale = scale;
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32_d(p, st);
  if (dtype == 1) return (int)launch_mma_d(p, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
