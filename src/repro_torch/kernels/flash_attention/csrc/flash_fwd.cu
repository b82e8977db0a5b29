// Flash-attention forward for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the TPU Pallas kernel
//   src/repro/kernels/flash_attention/kernel.py::_flash_fwd_kernel
// (called through ``flash_attention``).  It computes the same function:
// online softmax with fp32 running max, sum and accumulator; QK^T and PV
// on operands of the input type with fp32 accumulation, P rounded to v's
// type before PV; GQA/MQA through kv head ``h / (Hq / Hkv)``; a ``kv_len``
// mask for padded caches; rows that see no key give 0.  One runtime
// argument is added for the model path: the query offset, the absolute
// position of query row 0, so that the causal test is
// ``k_pos <= q_offset + q_row`` (0 gives the TPU kernel exactly).  It is
// one ``q_offset`` for every batch row, or, where ``q_offsets`` is not
// null, ``q_offsets[b]`` for row b (the JAX model's M-RoPE attention masks
// with each row's first temporal position id, which may differ by row); a
// block reads its row's offset once.  q, k, v and o are strided
// (B, S, H, D) or (B, H, S, D) views, read in place.  Head dims: 32, 64,
// 128 and 160 (stablelm-12b); 160 is no power of two, and every loop
// over D steps in 8 or 16 elements, which divide it.  For training, the
// two prefill paths also write each query row's log-sum-exp of its scaled
// scores (``lse``, fp32, -inf where the row sees no key) when the caller
// passes one; the backward (flash_bwd.cu) recomputes P from it.  Serving
// passes null and nothing else changes.
//
// Three paths.  The wrapper (../kernel.py, ``plan``) picks one by a plain
// rule on dtype and shape and passes it in ``path``; none is a fallback:
//
//   1. bfloat16, Sq >= 2: ``flash_fwd_prefill_mma``, on the tensor cores.
//      Bound: a long causal prefill by operations (989 TFLOP/s bf16), a
//      short one by launch and the K/V bytes.  mma.sync reaches the tensor
//      cores only through registers fed by ldmatrix from shared memory, so
//      what limits it is issue and shared-memory traffic per product.
//      Design:
//        * one block of 4 warps per (b, hq, tile of query rows); a warp
//          owns MT m-tiles of 16 rows: MT = 2 (128 rows a block) for
//          D <= 64 and Sq > 64, so that each K and V fragment read from
//          shared memory feeds two products; else MT = 1 (64 rows), which
//          keeps a D 128 or D 160 warp's accumulators in registers (D 160:
//          105 KB of shared memory a block, two blocks an SM);
//        * S = Q K^T and O += P V as mma.sync.m16n8k16 with bf16 operands
//          and fp32 accumulators; fragments come from shared memory
//          through ldmatrix (.trans for V); Q is loaded once per block and
//          kept in registers as A fragments;
//        * the online softmax runs on the accumulator fragments; the scale
//          folds into one FFMA before ex2.approx.ftz; row max and sum
//          reduce over the quad of lanes that share a row;
//        * P is rounded to bf16 in registers and used as the A operand of
//          PV directly (the TPU kernel's ``p.astype(v.dtype)``);
//        * K/V tiles of 64 keys stream through a 2-stage ring filled by
//          cp.async.cg (16 bytes a copy; keys past the block's last
//          visible key are zero-filled, never read); rows are padded by
//          16 bytes, so ldmatrix and the copies are free of bank
//          conflicts;
//        * the key loop stops at the block's last visible key, and a warp
//          skips tiles past its own; only tiles that cross a row's limit
//          (the diagonal, kv_len, Sk) are masked element by element, to
//          -inf, so that ex2 gives 0 with no second test; query rows
//          past Sq are zero-filled in place, never padded;
//        * grid (B * Hq, query tiles), the last query tile first: the
//          longest causal tiles start in the first wave;
//        * at most 255 registers a thread, so that two blocks share an SM.
//   2. Sq == 1, float32 and bfloat16: ``flash_fwd_decode_split``
//      (flash-decoding).  Bound: the bytes of K and V (3.35 TB/s).
//        * grid (splits, Hkv x head chunks, B); a block takes up to R = 8
//          query heads of one kv head's group, so K and V are read once
//          per group; its key range is one of ``splits`` equal runs of
//          whole 64-key tiles of ``kv_len``;
//        * 4 warps, 16 keys each per tile, two lanes per key (each half
//          of D); tiles stream through a 3-stage cp.async ring, so two
//          tiles are in flight while one is used.  float32 at D 160 takes
//          a 2-stage ring: three stages of (K, V) x 64 keys x pitch 164 x
//          4 bytes are 251,904 bytes, past the 232,448 a block may have;
//          two are 167,936 (``decode_stages``);
//        * the warps' softmax states are merged in shared memory; with
//          one split the block writes the output (no scratch, no second
//          launch), otherwise it writes (max, sum, fp32 accumulator) to
//          the wrapper's scratch and ``flash_fwd_decode_merge`` combines
//          the splits of each (b, hq).  A split that sees no key carries
//          max -1e30 and sum 0 and drops out of the merge;
//        * the split count comes from the wrapper (B * Hkv, kv_len and
//          the card's SM count: at least two waves, each split at least
//          one ring of keys).  The kernel allocates nothing, so a call
//          can be captured in a CUDA graph.
//   3. float32, Sq >= 2: ``flash_fwd_fp32``, the CUDA-core kernel of the
//      first port, unchanged in what it computes.  The tensor cores have
//      no fp32 product but TF32, which would break the 2e-5 float32 bar
//      of tests/test_kernels.py; float32 is the type of the parity checks,
//      not of serving.  One block per (b, hq, tile of 4 warps x R rows),
//      one key per lane, fp32 FMAs, tiles staged with 16-byte loads.
//
// wgmma, TMA and warp specialisation are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_fwd.so flash_fwd.cu
// Bound with ctypes (see ../kernel.py).  The launcher allocates nothing,
// launches on the stream it is given and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;     // as NEG_INF in the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* scratch;                       // decode partials (splits > 1)
  const int* q_offsets;                 // (B,) per-row offsets, or null
  float* lse;                           // (B, Hq, Sq) row log-sum-exp, or null
  long long q_sb, q_ss, q_sh;           // element strides of (b, s, h)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int sq, hq, hkv;
  int kv_len, q_offset, causal;
  int nq, ns;                           // fp32 path: row groups x key splits
  int splits, split_len;                // decode path
  float scale;
};

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

// p rounded to T and back: the TPU kernel's ``p.astype(v.dtype)``.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Eight consecutive elements of a 16-byte aligned shared-memory row.
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory row pitch in elements: the row plus 16 bytes, so that the
// 16-byte row accesses of eight neighbouring rows fall in distinct banks.
template <typename T, int D>
__host__ __device__ constexpr int pitch() { return D + 16 / (int)sizeof(T); }

// ---- asynchronous copies, ldmatrix and mma.sync (PTX) ----------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; ``src_bytes`` 0 zero-fills without reading.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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
// 2^x on the SFU; a result below 2^-126 is flushed to 0, far below the
// bf16 rounding that P takes before PV.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// Two floats as a bf16 pair, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- path 3: float32, Sq >= 2 (the first port's CUDA-core kernel) -------------

constexpr int kF32Warps = 4;
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kF32BK = 32;              // keys per warp sub-tile: one per lane

// Layout of the dynamic shared memory, in bytes, shared by host and device:
//   q_s   [BQ][D] f32      the block's query rows
//   p_s   [kF32Warps][R][kF32BK] f32   each warp's P tile
//   st_s  [kF32Warps][R][2] f32     per-warp (max, sum) for the split merge
//   acc_s [kF32Warps][R][D] f32     per-warp accumulators (only when NS > 1)
//   k_s, v_s [NS * kF32BK][pitch] T  the staged KV tile
template <typename T, int D, int R>
__host__ __device__ constexpr size_t smem_floats(int nq, int ns) {
  return (size_t)nq * R * D + (size_t)kF32Warps * R * kF32BK + (size_t)kF32Warps * R * 2 +
         (ns > 1 ? (size_t)kF32Warps * R * D : 0);
}
template <typename T, int D, int R>
__host__ __device__ constexpr size_t smem_bytes(int nq, int ns) {
  return smem_floats<T, D, R>(nq, ns) * sizeof(float) +
         2 * (size_t)ns * kF32BK * pitch<T, D>() * sizeof(T);
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_fp32(const Params p) {
  constexpr int DPL = D / 32;                  // output dims per lane
  constexpr int CH = 16 / (int)sizeof(T);      // elements per 16-byte chunk
  constexpr int ROW_CHUNKS = D / CH;
  constexpr int PITCH = pitch<T, D>();

  const int nq = p.nq, ns = p.ns;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp / ns, s = warp % ns;
  const int bq = nq * R;
  const int q0 = blockIdx.x * bq;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (p.hq / p.hkv);
  const int q_offset = p.q_offsets ? p.q_offsets[b] : p.q_offset;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + (size_t)bq * D;
  float* st_s = p_s + kF32Warps * R * kF32BK;
  float* acc_s = st_s + kF32Warps * R * 2;
  T* k_s = reinterpret_cast<T*>(reinterpret_cast<float*>(smem) +
                                smem_floats<T, D, R>(nq, ns));
  T* v_s = k_s + (size_t)ns * kF32BK * PITCH;

  const T* Q = static_cast<const T*>(p.q);
  const T* K = static_cast<const T*>(p.k);
  const T* V = static_cast<const T*>(p.v);
  T* O = static_cast<T*>(p.o);

  for (int i = threadIdx.x; i < bq * D; i += kF32Threads) {
    const int r = i / D, d = i % D, qr = q0 + r;
    q_s[i] = qr < p.sq ? to_f(Q[b * p.q_sb + qr * p.q_ss + hq * p.q_sh + d]) : 0.f;
  }

  // Keys this block needs at all.
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, q_offset + min(q0 + bq, p.sq));

  // This warp's rows and the key limit of each.
  int lim[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qr = q0 + g * R + r;
    lim[r] = p.causal ? min(p.kv_len, q_offset + qr + 1) : p.kv_len;
  }

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;                       // this lane's share of the row sum
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  float* p_w = p_s + warp * R * kF32BK;
  const int step = ns * kF32BK;
  for (int k0 = 0; k0 < kv_end; k0 += step) {
    __syncthreads();                  // the previous tile is consumed
    for (int c = threadIdx.x; c < step * ROW_CHUNKS; c += kF32Threads) {
      const int row = c / ROW_CHUNKS, ch = c % ROW_CHUNKS, kp = k0 + row;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
      if (kp < kv_end) {
        kk = *reinterpret_cast<const uint4*>(K + b * p.k_sb + kp * p.k_ss +
                                             hk * p.k_sh + ch * CH);
        vv = *reinterpret_cast<const uint4*>(V + b * p.v_sb + kp * p.v_ss +
                                             hk * p.v_sh + ch * CH);
      }
      *reinterpret_cast<uint4*>(k_s + row * PITCH + ch * CH) = kk;
      *reinterpret_cast<uint4*>(v_s + row * PITCH + ch * CH) = vv;
    }
    __syncthreads();

    const int kbase = k0 + s * kF32BK;   // warp-uniform
    if (kbase >= kv_end) continue;

    // S = Q K^T for this lane's key, all R rows.
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = 0.f;
    const T* krow = k_s + (s * kF32BK + lane) * PITCH;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 8) {
      float kf[8];
      load8(krow + d0, kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float qf[8];
        load8(q_s + (g * R + r) * D + d0, qf);
#pragma unroll
        for (int i = 0; i < 8; ++i) sc[r] = fmaf(qf[i], kf[i], sc[r]);
      }
    }

    // Online softmax update; the row sum stays per lane until the end.
    const int kp = kbase + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool valid = kp < lim[r];
      const float x = valid ? sc[r] * p.scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float pr = valid ? expf(x - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + pr;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
      m[r] = m_new;
      p_w[r * kF32BK + lane] = round_to<T>(pr);
    }
    __syncwarp();

    // O += P V: lane owns output dims [lane * DPL, lane * DPL + DPL).
    const T* vbase = v_s + (s * kF32BK) * PITCH + lane * DPL;
#pragma unroll 2
    for (int j = 0; j < kF32BK; j += 4) {
      float4 pj[R];
#pragma unroll
      for (int r = 0; r < R; ++r) pj[r] = *reinterpret_cast<const float4*>(p_w + r * kF32BK + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vf[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) vf[i] = to_f(vbase[(j + jj) * PITCH + i]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pv = jj == 0 ? pj[r].x : jj == 1 ? pj[r].y : jj == 2 ? pj[r].z : pj[r].w;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pv, vf[i], acc[r][i]);
        }
      }
    }
    __syncwarp();                     // p_w is rewritten next tile
  }

#pragma unroll
  for (int r = 0; r < R; ++r) l[r] = warp_sum(l[r]);

  if (ns > 1) {
    // Merge the NS key splits of each row group.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (lane == 0) {
        st_s[(warp * R + r) * 2] = m[r];
        st_s[(warp * R + r) * 2 + 1] = l[r];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc_s[(warp * R + r) * D + lane * DPL + i] = acc[r][i];
    }
    __syncthreads();
    if (s != 0) return;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = kNegInf;
      for (int t = 0; t < ns; ++t) mx = fmaxf(mx, st_s[((g * ns + t) * R + r) * 2]);
      float lsum = 0.f, o[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) o[i] = 0.f;
      for (int t = 0; t < ns; ++t) {
        const int w = g * ns + t;
        const float c = expf(st_s[(w * R + r) * 2] - mx);
        lsum += st_s[(w * R + r) * 2 + 1] * c;
#pragma unroll
        for (int i = 0; i < DPL; ++i) o[i] += acc_s[(w * R + r) * D + lane * DPL + i] * c;
      }
      l[r] = lsum;
      m[r] = mx;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = o[i];
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qr = q0 + g * R + r;
    if (qr >= p.sq) continue;
    if (p.lse && lane == 0)             // natural-log units; -inf: no key
      p.lse[((long long)b * p.hq + hq) * p.sq + qr] =
          l[r] == 0.f ? -CUDART_INF_F : m[r] + logf(l[r]);
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    T* orow = O + b * p.o_sb + qr * p.o_ss + hq * p.o_sh + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[i] = from_f<T>(acc[r][i] * inv);
  }
}

template <typename T, int D, int R>
cudaError_t launch_fp32(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D, R>(p.nq, p.ns);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_fp32<T, D, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int bq = p.nq * R;
  const dim3 grid((p.sq + bq - 1) / bq, p.hq, B);
  flash_fwd_fp32<T, D, R><<<grid, kF32Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_fp32_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_fp32<T, 32, R>(p, B, stream);
    case 64: return launch_fp32<T, 64, R>(p, B, stream);
    case 128: return launch_fp32<T, 128, R>(p, B, stream);
    case 160: return launch_fp32<T, 160, R>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_fp32_r(Params p, int B, int D, cudaStream_t stream) {
  // R rows per warp; NQ row groups x NS key splits fill the 4 warps.
  const int R = p.sq >= 16 ? 4 : 1;
  const int groups = (p.sq + R - 1) / R;
  int nq = 1;
  while (nq < kF32Warps && nq < groups) nq *= 2;
  p.nq = nq;
  p.ns = kF32Warps / nq;
  return R == 4 ? launch_fp32_d<T, 4>(p, B, D, stream) : launch_fp32_d<T, 1>(p, B, D, stream);
}


// ---- path 1: bfloat16, Sq >= 2, on the tensor cores -------------------------

constexpr int kBK = 64;                 // keys per K/V tile (paths 1 and 2)
constexpr int kPrefillWarps = 4;
constexpr int kPrefillStages = 2;

// Dynamic shared memory: q_s [BQ][pitch] then the ring [stages][K, V][kBK][pitch].
template <int D, int BQ>
__host__ __device__ constexpr size_t prefill_smem_bytes() {
  return (size_t)(BQ + kPrefillStages * 2 * kBK) * pitch<__nv_bfloat16, D>() *
         sizeof(__nv_bfloat16);
}

// 4 warps of MT m-tiles (16 rows each): a warp's K and V fragments serve
// all MT of its m-tiles.
template <int D, int MT>
__global__ void __launch_bounds__(kPrefillWarps * 32, 2) flash_fwd_prefill_mma(const Params p) {
  using T = __nv_bfloat16;
  constexpr int NW = kPrefillWarps;
  constexpr int WR = 16 * MT;                  // rows per warp
  constexpr int BQ = NW * WR;
  constexpr int PITCH = pitch<T, D>();
  constexpr int CH = D / 8;                    // 16-byte chunks per row
  constexpr int NT = NW * 32;
  constexpr int NST = kPrefillStages;
  constexpr int KD = D / 16;                   // k-steps of Q K^T
  constexpr int ND = D / 8;                    // n-blocks of O

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;     // mma fragment row, column pair
  const int hq = blockIdx.x % p.hq, b = blockIdx.x / p.hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;    // last tile first
  const int hk = hq / (p.hq / p.hkv);
  const int q_offset = p.q_offsets ? p.q_offsets[b] : p.q_offset;

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* ring = q_s + BQ * PITCH;

  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + hq * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // Keys the block needs, keys the warp needs, and keys that no row of the
  // warp masks.
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, q_offset + min(q0 + BQ, p.sq));
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  const int w0 = q0 + warp * WR;
  const bool active = w0 < p.sq;
  const int warp_end =
      p.causal ? min(p.kv_len, q_offset + min(w0 + WR, p.sq)) : p.kv_len;
  const int warp_full = p.causal ? min(p.kv_len, q_offset + w0 + 1) : p.kv_len;
  // This lane's rows: g and g + 8 of each m-tile, and their key limits.
  int lim[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w0 + mt * 16 + g + h * 8;
      lim[mt][h] = p.causal ? min(p.kv_len, q_offset + row + 1) : p.kv_len;
    }

  // Q rows past Sq are zero-filled in place.
  for (int c = tid; c < BQ * CH; c += NT) {
    const int r = c / CH, ch = c % CH, qr = q0 + r;
    cp_async16(q_s + r * PITCH + ch * 8,
               Q + (long long)(qr < p.sq ? qr : 0) * p.q_ss + ch * 8,
               qr < p.sq ? 16 : 0);
  }
  auto load_kv = [&](int t) {
    T* ks = ring + (t % NST) * 2 * kBK * PITCH;
    T* vs = ks + kBK * PITCH;
    for (int c = tid; c < kBK * CH; c += NT) {
      const int r = c / CH, ch = c % CH, kp = t * kBK + r;
      const bool in = kp < kv_end;
      const long long row = in ? kp : 0;
      cp_async16(ks + r * PITCH + ch * 8, K + row * p.k_ss + ch * 8, in ? 16 : 0);
      cp_async16(vs + r * PITCH + ch * 8, V + row * p.v_ss + ch * 8, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {         // Q joins the first group
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  uint32_t qf[MT][KD][4];
  float o[MT][ND][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mt][n][i] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = kNegInf;                      // log2 units
      l[mt][h] = 0.f;                          // this lane's share of the sum
    }
  }
  const float sl2 = p.scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + NST - 1 < n_tiles) load_kv(t + NST - 1);
    cp_async_commit();
    cp_async_wait<NST - 1>();                  // tile t (and Q) have landed
    __syncthreads();
    const int k0 = t * kBK;
    if (active && k0 < warp_end) {             // warp-uniform
      if (t == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < KD; ++kk)
            ldmatrix_x4(qf[mt][kk],
                        q_s + (warp * WR + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  PITCH + kk * 16 + (lane >> 4) * 8);
      }
      const T* ks = ring + (t % NST) * 2 * kBK * PITCH;
      const T* vs = ks + kBK * PITCH;

      // S = Q K^T: per m-tile 16 rows x 64 keys, as 8 n-blocks of 8 keys.
      float s[MT][8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[mt][n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          uint32_t kf[4];
          ldmatrix_x4(kf, ks + (nb * 16 + (lane & 7) + (lane >> 4) * 8) * PITCH +
                              kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * nb], qf[mt][kk], kf[0], kf[1]);
            mma_bf16(s[mt][2 * nb + 1], qf[mt][kk], kf[2], kf[3]);
          }
        }
      }

      // Online softmax on the fragments; only a tile that crosses a row's
      // limit is masked element by element (-inf: ex2 gives 0).
      if (k0 + kBK > warp_full) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (k0 + n * 8 + tig * 2 + (i & 1) >= lim[mt][i >> 1])
                s[mt][n][i] = -CUDART_INF_F;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {          // row g, then row g + 8
          float mx = s[mt][0][2 * h];
#pragma unroll
          for (int n = 0; n < 8; ++n)
            mx = fmaxf(mx, fmaxf(s[mt][n][2 * h], s[mt][n][2 * h + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));  // the quad
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));  // shares a row
          // Running max in log2 units; never below -1e30, so never -inf.
          const float mn = fmaxf(m[mt][h], mx * sl2);
          const float corr = exp2f(m[mt][h] - mn);
          m[mt][h] = mn;
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              s[mt][n][2 * h + j] = ex2_ftz(fmaf(s[mt][n][2 * h + j], sl2, -mn));
              sum += s[mt][n][2 * h + j];
            }
          l[mt][h] = l[mt][h] * corr + sum;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            o[mt][n][2 * h] *= corr;
            o[mt][n][2 * h + 1] *= corr;
          }
        }
      }

      // O += P V: P rounded to bf16 in registers is the A operand.
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = pack_bf16(s[mt][2 * kc][0], s[mt][2 * kc][1]);
          pa[mt][1] = pack_bf16(s[mt][2 * kc][2], s[mt][2 * kc][3]);
          pa[mt][2] = pack_bf16(s[mt][2 * kc + 1][0], s[mt][2 * kc + 1][1]);
          pa[mt][3] = pack_bf16(s[mt][2 * kc + 1][2], s[mt][2 * kc + 1][3]);
        }
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                         PITCH + nd * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][2 * nd], pa[mt], vf[0], vf[1]);
            mma_bf16(o[mt][2 * nd + 1], pa[mt], vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();                           // stage t % NST is free again
  }

  if (!active) return;
  T* O = static_cast<T*>(p.o) + b * p.o_sb + hq * p.o_sh;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[mt][h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / (sum == 0.f ? 1.f : sum);
      const int row = w0 + mt * 16 + g + h * 8;
      if (row >= p.sq) continue;
      if (p.lse && tig == 0)            // m is in log2 units of the scaled score
        p.lse[((long long)b * p.hq + hq) * p.sq + row] =
            sum == 0.f ? -CUDART_INF_F : (m[mt][h] + log2f(sum)) * kLn2;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<__nv_bfloat162*>(O + (long long)row * p.o_ss + n * 8 + tig * 2) =
            __floats2bfloat162_rn(o[mt][n][2 * h] * inv, o[mt][n][2 * h + 1] * inv);
    }
}

template <int D, int MT>
cudaError_t launch_prefill(const Params& p, int B, cudaStream_t stream) {
  constexpr int NW = kPrefillWarps;
  constexpr int BQ = NW * 16 * MT;
  constexpr size_t smem = prefill_smem_bytes<D, BQ>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_prefill_mma<D, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long tiles = (p.sq + BQ - 1) / BQ;
  if ((long long)B * p.hq > 0x7fffffffLL || tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * p.hq, (unsigned)tiles);
  flash_fwd_prefill_mma<D, MT><<<grid, NW * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_prefill_d(const Params& p, int B, int D, cudaStream_t stream) {
  // Two m-tiles a warp (128 rows a block) where the fragments fit in
  // registers and the rows fill them; one (64 rows) for short prompts and
  // for D 128 and 160.
  const bool wide = p.sq > 64;
  switch (D) {
    case 32: return wide ? launch_prefill<32, 2>(p, B, stream) : launch_prefill<32, 1>(p, B, stream);
    case 64: return wide ? launch_prefill<64, 2>(p, B, stream) : launch_prefill<64, 1>(p, B, stream);
    case 128: return launch_prefill<128, 1>(p, B, stream);
    case 160: return launch_prefill<160, 1>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- path 2: Sq == 1, split-KV decode ---------------------------------------

constexpr int kDecWarps = 4;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecStages = 3;
constexpr int kDecKeys = kBK / kDecWarps;    // keys per warp per tile: 16

// Stages of the decode ring: kDecStages, but two for float32 at D 160,
// where three do not fit in a block's shared memory (see the header).
template <typename T, int D>
__host__ __device__ constexpr int decode_stages() {
  return sizeof(T) == 4 && D > 128 ? 2 : kDecStages;
}

// Dynamic shared memory of the decode kernel, floats first:
//   q_s   [R][D + 8] f32        query rows; each half of D padded by 16 bytes
//   p_s   [warps][R][kDecKeys]  each warp's P
//   st_s  [warps][R][2]         each warp's (max, sum)
//   acc_s [warps][R][D]         each warp's accumulator
//   ring  [stages][K, V][kBK][pitch] T
template <int D, int R>
__host__ __device__ constexpr size_t decode_smem_floats() {
  return (size_t)R * (D + 8) + (size_t)kDecWarps * R * (kDecKeys + 2 + D);
}
template <typename T, int D, int R>
__host__ __device__ constexpr size_t decode_smem_bytes() {
  return decode_smem_floats<D, R>() * sizeof(float) +
         (size_t)decode_stages<T, D>() * 2 * kBK * pitch<T, D>() * sizeof(T);
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kDecThreads) flash_fwd_decode_split(const Params p) {
  constexpr int PITCH = pitch<T, D>();
  constexpr int CH = 16 / (int)sizeof(T);     // elements per 16-byte chunk
  constexpr int ROW_CHUNKS = D / CH;
  constexpr int DH = D / 2;                   // dims of q.k per lane
  constexpr int QP = D + 8;
  constexpr int DPL = D / 32;                 // output dims per lane
  constexpr int NST = decode_stages<T, D>();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kl = lane & 15, half = lane >> 4; // two lanes per key
  const int split = blockIdx.x, b = blockIdx.z;
  const int group = p.hq / p.hkv;
  const int chunks = (group + R - 1) / R;
  const int hk = blockIdx.y / chunks;
  const int h0 = hk * group + (blockIdx.y % chunks) * R;   // first query head
  const int rows = min(R, hk * group + group - h0);

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + R * QP;
  float* st_s = p_s + kDecWarps * R * kDecKeys;
  float* acc_s = st_s + kDecWarps * R * 2;
  T* ring = reinterpret_cast<T*>(acc_s + kDecWarps * R * D);

  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb;   // the one row
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // This split's keys: [k_begin, k_end), whole tiles of kv_len.
  int kv_end = p.kv_len;
  if (p.causal)
    kv_end = min(kv_end, (p.q_offsets ? p.q_offsets[b] : p.q_offset) + 1);
  const int k_begin = split * p.split_len;
  const int k_end = min(kv_end, k_begin + p.split_len);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  for (int i = tid; i < R * D; i += kDecThreads) {
    const int r = i / D, d = i % D;
    q_s[r * QP + (d / DH) * (DH + 4) + d % DH] =
        r < rows ? to_f(Q[(long long)(h0 + r) * p.q_sh + d]) : 0.f;
  }
  auto load_kv = [&](int t) {
    T* ks = ring + (t % NST) * 2 * kBK * PITCH;
    T* vs = ks + kBK * PITCH;
    for (int c = tid; c < kBK * ROW_CHUNKS; c += kDecThreads) {
      const int r = c / ROW_CHUNKS, ch = c % ROW_CHUNKS;
      const int kp = k_begin + t * kBK + r;
      const bool in = kp < k_end;
      const long long row = in ? kp : 0;
      cp_async16(ks + r * PITCH + ch * CH, K + row * p.k_ss + ch * CH, in ? 16 : 0);
      cp_async16(vs + r * PITCH + ch * CH, V + row * p.v_ss + ch * CH, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;                               // this lane's share of the sum
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const float sl2 = p.scale * kLog2e;         // scores in log2 units
  float* p_w = p_s + warp * R * kDecKeys;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + NST - 1 < n_tiles) load_kv(t + NST - 1);
    cp_async_commit();
    cp_async_wait<NST - 1>();                 // tile t has landed
    __syncthreads();
    const T* ks = ring + (t % NST) * 2 * kBK * PITCH;
    const T* vs = ks + kBK * PITCH;
    const int kw = warp * kDecKeys;           // the warp's keys in the tile
    const int kbase = k_begin + t * kBK + kw;
    if (kbase < k_end) {                      // warp-uniform
      // S: each lane takes half of D of its key; the pair adds up.
      float sc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) sc[r] = 0.f;
      const T* krow = ks + (kw + kl) * PITCH + half * DH;
#pragma unroll
      for (int d0 = 0; d0 < DH; d0 += 8) {
        float kf[8];
        load8(krow + d0, kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float qf[8];
          load8(q_s + r * QP + half * (DH + 4) + d0, qf);
#pragma unroll
          for (int i = 0; i < 8; ++i) sc[r] = fmaf(qf[i], kf[i], sc[r]);
        }
      }
      const bool valid = kbase + kl < k_end;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], 16);
        const float x = valid ? sc[r] * sl2 : kNegInf;
        float mx = x;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[r], mx);
        const float pr = valid ? exp2f(x - m_new) : 0.f;
        const float corr = exp2f(m[r] - m_new);
        l[r] = l[r] * corr + (half ? 0.f : pr);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
        m[r] = m_new;
        if (!half) p_w[r * kDecKeys + kl] = round_to<T>(pr);
      }
      __syncwarp();

      // O += P V: lane owns output dims [lane * DPL, lane * DPL + DPL).
      const T* vbase = vs + kw * PITCH + lane * DPL;
#pragma unroll 4
      for (int j = 0; j < kDecKeys; ++j) {
        float vf[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) vf[i] = to_f(vbase[j * PITCH + i]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pj = p_w[r * kDecKeys + j];
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vf[i], acc[r][i]);
        }
      }
      __syncwarp();                           // p_w is rewritten next tile
    }
    __syncthreads();                          // stage t % NST is free again
  }

  // Merge the four warps; then the output, or this split's partial state.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    l[r] = warp_sum(l[r]);
    if (lane == 0) {
      st_s[(warp * R + r) * 2] = m[r];
      st_s[(warp * R + r) * 2 + 1] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc_s[(warp * R + r) * D + lane * DPL + i] = acc[r][i];
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += kDecThreads) {
    const int r = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, st_s[(w * R + r) * 2]);
    float ls = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float c = exp2f(st_s[(w * R + r) * 2] - mx);
      ls += st_s[(w * R + r) * 2 + 1] * c;
      o += acc_s[(w * R + r) * D + d] * c;
    }
    const int hq = h0 + r;
    if (p.splits == 1) {
      T* O = static_cast<T*>(p.o);
      O[b * p.o_sb + hq * p.o_sh + d] = from_f<T>(o / (ls == 0.f ? 1.f : ls));
    } else {
      float* part = p.scratch + ((size_t)b * p.hq + hq) * p.splits * (D + 2) +
                    (size_t)split * (D + 2);
      part[2 + d] = o;
      if (d == 0) {
        part[0] = mx;                         // -1e30 and 0 for an empty split
        part[1] = ls;
      }
    }
  }
}

// The splits of one (b, hq): one thread per output dim.
template <typename T, int D>
__global__ void __launch_bounds__(D) flash_fwd_decode_merge(const Params p) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const float* part = p.scratch + ((size_t)b * p.hq + hq) * p.splits * (D + 2);
  float mx = kNegInf;
  for (int s = 0; s < p.splits; ++s) mx = fmaxf(mx, part[s * (D + 2)]);
  float ls = 0.f, o = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float c = exp2f(part[s * (D + 2)] - mx);
    ls += part[s * (D + 2) + 1] * c;
    o += part[s * (D + 2) + 2 + d] * c;
  }
  T* O = static_cast<T*>(p.o);
  O[b * p.o_sb + hq * p.o_sh + d] = from_f<T>(o / (ls == 0.f ? 1.f : ls));
}

template <typename T, int D, int R>
cudaError_t launch_decode(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = decode_smem_bytes<T, D, R>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_decode_split<T, D, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long gy = (long long)p.hkv * ((p.hq / p.hkv + R - 1) / R);
  if (gy > 65535) return cudaErrorInvalidValue;
  flash_fwd_decode_split<T, D, R>
      <<<dim3(p.splits, (unsigned)gy, B), kDecThreads, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  flash_fwd_decode_merge<T, D><<<dim3(p.hq, B), D, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_decode_r(const Params& p, int B, cudaStream_t stream) {
  // R: query heads per block, the group size rounded up to 1, 2, 4 or 8.
  const int group = p.hq / p.hkv;
  if (group <= 1) return launch_decode<T, D, 1>(p, B, stream);
  if (group <= 2) return launch_decode<T, D, 2>(p, B, stream);
  if (group <= 4) return launch_decode<T, D, 4>(p, B, stream);
  return launch_decode<T, D, 8>(p, B, stream);
}

template <typename T>
cudaError_t launch_decode_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_decode_r<T, 32>(p, B, stream);
    case 64: return launch_decode_r<T, 64>(p, B, stream);
    case 128: return launch_decode_r<T, 128>(p, B, stream);
    case 160: return launch_decode_r<T, 160>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// path: 0 = prefill_mma, 1 = decode_split, 2 = fp32 (see the header; the
// wrapper's ``plan`` applies the rule).  dtype: 0 = float32, 1 = bfloat16.
// strides: 12 element strides, the (b, s, h) strides of q, k, v and o in
// that order; the d stride is 1.  splits: key splits of the decode path;
// with more than one, ``scratch`` holds B * Hq * splits * (D + 2) floats.
// q_offsets: null, or B ints on the device, each row's query offset in
// place of ``q_offset``.  lse: null, or B * Hq * Sq floats that take each
// query row's log-sum-exp of its scaled scores (natural log; -inf for a
// row that sees no key), which the backward (flash_bwd.cu) reads; only the
// two prefill paths write it.  Returns a cudaError_t (0 on success).
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* scratch, int path, int dtype, int B, int Hq, int Hkv,
              int Sq, int D, const long long* strides, int kv_len,
              int q_offset, const int* q_offsets, int causal, float scale,
              int splits, float* lse, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.scratch = static_cast<float*>(scratch);
  p.q_offsets = q_offsets;
  p.lse = lse;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.sq = Sq; p.hq = Hq; p.hkv = Hkv;
  p.kv_len = kv_len; p.q_offset = q_offset; p.causal = causal;
  p.nq = 1; p.ns = 1;
  p.splits = 1; p.split_len = 0;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (path == 0) {
    if (dtype != 1 || Sq < 2) return (int)cudaErrorInvalidValue;
    return (int)launch_prefill_d(p, B, D, st);
  }
  if (path == 1) {
    if (Sq != 1 || splits < 1 || (splits > 1 && scratch == nullptr) || lse)
      return (int)cudaErrorInvalidValue;
    p.splits = splits;
    const int per = (kv_len + splits - 1) / splits;
    p.split_len = (per + kBK - 1) / kBK * kBK;
    if (dtype == 0) return (int)launch_decode_d<float>(p, B, D, st);
    return (int)launch_decode_d<__nv_bfloat16>(p, B, D, st);
  }
  if (path == 2) {
    if (dtype != 0 || Sq < 2) return (int)cudaErrorInvalidValue;
    return (int)launch_fp32_r<float>(p, B, D, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
