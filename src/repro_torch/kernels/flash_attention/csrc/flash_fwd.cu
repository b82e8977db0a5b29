// Flash-attention forward for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the TPU Pallas kernel
//   src/repro/kernels/flash_attention/kernel.py::_flash_fwd_kernel
// (called through ``flash_attention``).  It computes the same function:
// online softmax with fp32 running max, sum and accumulator; QK^T and PV
// on operands of the input type with fp32 accumulation, P rounded to v's
// type before PV; GQA/MQA through kv head ``h / (Hq / Hkv)``; a ``kv_len``
// mask for padded caches; rows that see no key give 0.  One runtime
// argument is added for the model path: ``q_offset``, the absolute
// position of query row 0, so that the causal test is
// ``k_pos <= q_offset + q_row`` (0 gives the TPU kernel exactly).
//
// What bounds it on an H100: decode (one query row over a long cache) is
// bound by the bytes of K and V (3.35 TB/s); long causal prefill is bound
// by operations, which this first version does on the CUDA cores in fp32
// FMAs (~67 TFLOP/s) rather than on the tensor cores (989 TFLOP/s bf16).
// The design keeps it simple and right, and keeps decode near its bytes:
//   * the TPU's sequential kv grid axis becomes a loop inside the block
//     over KV tiles staged in shared memory with 16-byte loads;
//   * one block covers (b, hq, a tile of BQ = NQ * R query rows); its 4
//     warps are NQ row groups x NS key splits, NQ * NS = 4.  Each warp owns
//     R rows (R = 4 for Sq >= 16, else R = 1) and one 32-key sub-tile of
//     every staged tile, one key per lane.  With Sq = 1 (decode) the four
//     warps split the keys (NS = 4) instead of idling on padded rows; their
//     partial (max, sum, accumulator) states are merged at the end;
//   * the KV loop stops at min(kv_len, q_offset + last_row + 1) when causal,
//     so fully masked causal tiles are never loaded.
// mma.sync / wgmma, TMA and a pipelined tile ring are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_fwd.so flash_fwd.cu
// Bound with ctypes (see ../kernel.py).  The launcher allocates nothing,
// launches on the stream it is given and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 32;                 // keys per warp sub-tile: one per lane
constexpr float kNegInf = -1.0e30f;     // as NEG_INF in the TPU kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;           // element strides of (b, s, h)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int sq, hq, hkv;
  int kv_len, q_offset, causal;
  int nq, ns;
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
// 16-byte row reads of eight neighbouring lanes fall in distinct banks.
template <typename T, int D>
__host__ __device__ constexpr int pitch() { return D + 16 / (int)sizeof(T); }

// Layout of the dynamic shared memory, in bytes, shared by host and device:
//   q_s   [BQ][D] f32      the block's query rows
//   p_s   [kWarps][R][kBK] f32   each warp's P tile
//   st_s  [kWarps][R][2] f32     per-warp (max, sum) for the split merge
//   acc_s [kWarps][R][D] f32     per-warp accumulators (only when NS > 1)
//   k_s, v_s [NS * kBK][pitch] T  the staged KV tile
template <typename T, int D, int R>
__host__ __device__ constexpr size_t smem_floats(int nq, int ns) {
  return (size_t)nq * R * D + (size_t)kWarps * R * kBK + (size_t)kWarps * R * 2 +
         (ns > 1 ? (size_t)kWarps * R * D : 0);
}
template <typename T, int D, int R>
__host__ __device__ constexpr size_t smem_bytes(int nq, int ns) {
  return smem_floats<T, D, R>(nq, ns) * sizeof(float) +
         2 * (size_t)ns * kBK * pitch<T, D>() * sizeof(T);
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
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

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + (size_t)bq * D;
  float* st_s = p_s + kWarps * R * kBK;
  float* acc_s = st_s + kWarps * R * 2;
  T* k_s = reinterpret_cast<T*>(reinterpret_cast<float*>(smem) +
                                smem_floats<T, D, R>(nq, ns));
  T* v_s = k_s + (size_t)ns * kBK * PITCH;

  const T* Q = static_cast<const T*>(p.q);
  const T* K = static_cast<const T*>(p.k);
  const T* V = static_cast<const T*>(p.v);
  T* O = static_cast<T*>(p.o);

  for (int i = threadIdx.x; i < bq * D; i += kThreads) {
    const int r = i / D, d = i % D, qr = q0 + r;
    q_s[i] = qr < p.sq ? to_f(Q[b * p.q_sb + qr * p.q_ss + hq * p.q_sh + d]) : 0.f;
  }

  // Keys this block needs at all.
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, p.q_offset + min(q0 + bq, p.sq));

  // This warp's rows and the key limit of each.
  int lim[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qr = q0 + g * R + r;
    lim[r] = p.causal ? min(p.kv_len, p.q_offset + qr + 1) : p.kv_len;
  }

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;                       // this lane's share of the row sum
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  float* p_w = p_s + warp * R * kBK;
  const int step = ns * kBK;
  for (int k0 = 0; k0 < kv_end; k0 += step) {
    __syncthreads();                  // the previous tile is consumed
    for (int c = threadIdx.x; c < step * ROW_CHUNKS; c += kThreads) {
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

    const int kbase = k0 + s * kBK;   // warp-uniform
    if (kbase >= kv_end) continue;

    // S = Q K^T for this lane's key, all R rows.
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = 0.f;
    const T* krow = k_s + (s * kBK + lane) * PITCH;
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
      p_w[r * kBK + lane] = round_to<T>(pr);
    }
    __syncwarp();

    // O += P V: lane owns output dims [lane * DPL, lane * DPL + DPL).
    const T* vbase = v_s + (s * kBK) * PITCH + lane * DPL;
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pj[R];
#pragma unroll
      for (int r = 0; r < R; ++r) pj[r] = *reinterpret_cast<const float4*>(p_w + r * kBK + j);
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
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = o[i];
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qr = q0 + g * R + r;
    if (qr >= p.sq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    T* orow = O + b * p.o_sb + qr * p.o_ss + hq * p.o_sh + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[i] = from_f<T>(acc[r][i] * inv);
  }
}

template <typename T, int D, int R>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D, R>(p.nq, p.ns);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int bq = p.nq * R;
  const dim3 grid((p.sq + bq - 1) / bq, p.hq, B);
  flash_fwd_kernel<T, D, R><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32, R>(p, B, stream);
    case 64: return launch<T, 64, R>(p, B, stream);
    case 128: return launch<T, 128, R>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_r(Params p, int B, int D, cudaStream_t stream) {
  // R rows per warp; NQ row groups x NS key splits fill the 4 warps.
  const int R = p.sq >= 16 ? 4 : 1;
  const int groups = (p.sq + R - 1) / R;
  int nq = 1;
  while (nq < kWarps && nq < groups) nq *= 2;
  p.nq = nq;
  p.ns = kWarps / nq;
  return R == 4 ? launch_d<T, 4>(p, B, D, stream) : launch_d<T, 1>(p, B, D, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, the
// (b, s, h) strides of q, k, v and o in that order; the d stride is 1.
// Returns a cudaError_t (0 on success).
int flash_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
              int B, int Hq, int Hkv, int Sq, int D, const long long* strides,
              int kv_len, int q_offset, int causal, float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.sq = Sq; p.hq = Hq; p.hkv = Hkv;
  p.kv_len = kv_len; p.q_offset = q_offset; p.causal = causal;
  p.nq = 1; p.ns = 1;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_r<float>(p, B, D, st);
  if (dtype == 1) return (int)launch_r<__nv_bfloat16>(p, B, D, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
