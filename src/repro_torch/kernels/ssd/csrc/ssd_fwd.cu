// Mamba-2 chunked SSD scan for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the TPU Pallas kernel
//   src/repro/kernels/ssd/kernel.py:27 (``_ssd_kernel``, called through
//   ``ssd_scan``).
// Per chunk of L = min(chunk, T) rows it computes what that kernel computes:
// the inclusive cumsum css of dt * a, the masked lower-triangular
// intra-chunk term sum_{m <= l} (C_l . B_m) exp(css_l - css_m) dt_m x_m, the
// inter-chunk term exp(css_l) C_l . state, and the state update
// state <- exp(css_end) state + sum_l B_l exp(css_end - css_l) dt_l x_l,
// with the fp32 (P, N) state of each (batch, head) carried across chunks.
// Head h reads B/C group h / (H / G), as ``jnp.repeat`` maps it.  The
// ragged last chunk is masked in place: rows past T read as x = B = C = 0
// and dt = 0, which is the JAX package's zero padding (identity decay, no
// input).  Two things are added, and they are the contract of the JAX
// model's own XLA twin ``src/repro/models/mamba2.py::ssd_chunked``, which is
// what the model calls: an optional initial state (a null pointer means
// zeros) and the final state written out (the TPU kernel drops it).  So
// this is the function the JAX package computes, not a new feature.
//
// Inputs: x (B, T, H, P), B_ and C_ (B, T, G, N), f32 or bf16 (all three
// the same), with any element strides: the model passes strided views of
// its conv output, read here in place without a copy.  dt (B, T, H) f32
// with any element strides; a (H,) f32, contiguous.  Outputs, contiguous
// fp32: y (B, T, H, P) and the final state (B, H, P, N); state0 is a
// contiguous fp32 (B, H, P, N) or null.  All arithmetic is fp32 (bf16
// inputs are upcast on load, as ``_ssd_kernel`` upcasts).  exp is formed
// only where its argument is <= 0: exp(css_l - css_m) for m <= l alone,
// never exp(css_l) * exp(-css_m).
//
// What bounds it on an H100: per chunk and head it does about 2 L^2 N
// (scores) + 2 L^2 P (intra) + 4 L N P (inter, update) operations on
// L (P + 2N) inputs, so a long prefill is bound by operations and a short
// one (the serve prompts) by its bytes, chiefly the state read and written
// (32 KB per head at P 64, N 128) and the fp32 y.  This first version runs
// the products as fp32 FMAs on the CUDA cores (~67 TFLOP/s) and not on the
// tensor cores, and one block per (batch, head) fills 64 of the 132 SMs at
// batch 1.  The design keeps it simple and right:
//   * one block of 256 threads per (b, h); the TPU's sequential chunk axis
//     is a loop inside the block, and the state lives in shared memory;
//   * a chunk is staged in shared memory as fp32: x (L, P), B and C
//     transposed (N, L) so that the score loop reads 16-byte vectors;
//   * the cumsum is one warp's inclusive scan (shuffles);
//   * the L x L block is formed in row strips of 32 rows, one 4 x 4 tile a
//     thread, and each strip's y rows are finished from it right away, so
//     the staged chunk, the state and one strip fit in 218 KB at
//     L 128, P 64, N 128;
//   * tiles above the diagonal are never formed.
// mma.sync / wgmma, a cooperative split of long prefills over P and a
// pipelined chunk ring are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd_fwd.so ssd_fwd.cu
// Bound with ctypes (see ../kernel.py).  The launcher allocates nothing,
// launches on the stream it is given and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 32;              // rows of the L x L block per strip
constexpr int kLdA = kStrip + 4;        // row stride of the strip buffer
constexpr int kMaxL = 128;

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* state0;                  // may be null: zeros
  float* y;
  float* state;
  long long x_sb, x_st, x_sh, x_sp;     // element strides
  long long dt_sb, dt_st, dt_sh;
  long long b_sb, b_st, b_sg, b_sn;
  long long c_sb, c_st, c_sg, c_sn;
  int T, H, G, L, Lp, n_chunks;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Shared-memory layout (floats), with Lp = L rounded up to 4.
__host__ __device__ constexpr int ld_bc(int Lp) { return Lp + 4; }
template <int P> __host__ __device__ constexpr int ld_s() { return P + 4; }

template <int P, int N>
__host__ __device__ size_t smem_floats(int Lp) {
  return (size_t)Lp * P                 // xs   [Lp][P]
         + 2 * (size_t)N * ld_bc(Lp)    // bt, ct [N][Lp + 4]
         + (size_t)N * ld_s<P>()        // st   [N][P + 4]
         + (size_t)Lp * kLdA            // at   [Lp][kLdA]: strip, transposed
         + 4 * (size_t)Lp;              // css, ecs, w, dts
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int Lp = p.Lp, LdB = ld_bc(Lp);
  constexpr int LdS = ld_s<P>();
  float* xs = reinterpret_cast<float*>(smem4);
  float* bt = xs + Lp * P;
  float* ct = bt + N * LdB;
  float* st = ct + N * LdB;
  float* at = st + N * LdS;
  float* css = at + Lp * kLdA;
  float* ecs = css + Lp;
  float* w = ecs + Lp;
  float* dts = w + Lp;

  const int h = blockIdx.x, bb = blockIdx.y, tid = threadIdx.x;
  const int g = h / (p.H / p.G);
  const float a = p.a[h];
  const T* X = static_cast<const T*>(p.x) + bb * p.x_sb + h * p.x_sh;
  const T* Bg = static_cast<const T*>(p.b) + bb * p.b_sb + g * p.b_sg;
  const T* Cg = static_cast<const T*>(p.c) + bb * p.c_sb + g * p.c_sg;
  const float* DT = p.dt + bb * p.dt_sb + h * p.dt_sh;
  float* Y = p.y + ((long long)bb * p.T * p.H + h) * P;
  const long long y_st = (long long)p.H * P;
  const long long s_off = ((long long)bb * p.H + h) * P * N;

  for (int e = tid; e < P * N; e += kThreads) {
    const int pp = e / N, n = e % N;
    st[n * LdS + pp] = p.state0 ? p.state0[s_off + e] : 0.f;
  }

  for (int ck = 0; ck < p.n_chunks; ++ck) {
    const int t0 = ck * p.L;
    const int nv = min(p.L, p.T - t0);   // valid rows; the rest read as 0
    // ---- stage the chunk in fp32 -----------------------------------------
    for (int e = tid; e < Lp * P; e += kThreads) {
      const int l = e / P, pp = e % P;
      xs[e] = l < nv ? to_f(X[(t0 + l) * p.x_st + pp * p.x_sp]) : 0.f;
    }
    for (int e = tid; e < Lp * N; e += kThreads) {
      const int l = e / N, n = e % N;
      const bool v = l < nv;
      bt[n * LdB + l] = v ? to_f(Bg[(t0 + l) * p.b_st + n * p.b_sn]) : 0.f;
      ct[n * LdB + l] = v ? to_f(Cg[(t0 + l) * p.c_st + n * p.c_sn]) : 0.f;
    }
    for (int l = tid; l < Lp; l += kThreads)
      dts[l] = l < nv ? DT[(t0 + l) * p.dt_st] : 0.f;
    __syncthreads();

    // ---- inclusive cumsum of dt * a: one warp, K rows a lane -------------
    if (tid < 32) {
      const int K = (Lp + 31) / 32;      // <= 4
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = tid * K + k;
        run += (k < K && l < Lp) ? dts[l] * a : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = tid * K + k;
        if (k < K && l < Lp) css[l] = excl + v[k];
      }
    }
    __syncthreads();
    const float seg = css[Lp - 1];       // padded rows add 0
    for (int l = tid; l < Lp; l += kThreads) {
      ecs[l] = expf(css[l]);
      w[l] = expf(seg - css[l]) * dts[l];
    }
    __syncthreads();

    // ---- row strips of the masked L x L block, then their y rows ---------
    for (int l0 = 0; l0 < Lp; l0 += kStrip) {
      const int rs = min(kStrip, Lp - l0);   // a multiple of 4
      const int nrt = rs / 4, nct = (l0 + rs) / 4;
      for (int t = tid; t < nrt * nct; t += kThreads) {
        const int r = t % nrt, cm = t / nrt;
        const int lt = l0 + 4 * r, mt = 4 * cm;
        if (mt > lt + 3) continue;           // above the diagonal
        float acc[4][4] = {};
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(ct + n * LdB + lt);
          const float4 bv = *reinterpret_cast<const float4*>(bt + n * LdB + mt);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cr[i], br[j], acc[i][j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = mt + j;
          float o[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int l = lt + i;
            o[i] = m <= l ? acc[i][j] * expf(css[l] - css[m]) * dts[m] : 0.f;
          }
          *reinterpret_cast<float4*>(at + m * kLdA + 4 * r) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
      }
      __syncthreads();
      // y rows l, l + 1 x 4 columns a thread:
      //   exp(css_l) C_l . state[p]  +  sum_{m <= l} att[l][m] x[m][p]
      constexpr int npt = P / 4;
      for (int t = tid; t < (rs / 2) * npt; t += kThreads) {
        const int pt = t % npt, rr = t / npt;
        const int l = l0 + 2 * rr, p0 = 4 * pt;
        float acc[2][4] = {};
        for (int n = 0; n < N; ++n) {
          const float2 cv = *reinterpret_cast<const float2*>(ct + n * LdB + l);
          const float4 sv = *reinterpret_cast<const float4*>(st + n * LdS + p0);
          const float cr[2] = {cv.x, cv.y};
          const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cr[i], sr[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] *= ecs[l + i];
        const int m_end = l + 2;             // att[l][l + 1] is 0
        for (int m = 0; m < m_end; ++m) {
          const float2 av = *reinterpret_cast<const float2*>(at + m * kLdA + (l - l0));
          const float4 xv = *reinterpret_cast<const float4*>(xs + m * P + p0);
          const float ar[2] = {av.x, av.y};
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], xr[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (l + i < nv)
            *reinterpret_cast<float4*>(Y + (t0 + l + i) * y_st + p0) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      }
      __syncthreads();
    }

    // ---- state update: 4 n x 4 p a thread --------------------------------
    const float dend = expf(seg);
    constexpr int nsp = P / 4;
    for (int t = tid; t < (N / 4) * nsp; t += kThreads) {
      const int pt = t % nsp, n0 = 4 * (t / nsp), p0 = 4 * pt;
      float acc[4][4] = {};
      for (int l = 0; l < nv; ++l) {
        const float wl = w[l];
        const float4 xv = *reinterpret_cast<const float4*>(xs + l * P + p0);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float bw = bt[(n0 + i) * LdB + l] * wl;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bw, xr[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* sp = reinterpret_cast<float4*>(st + (n0 + i) * LdS + p0);
        const float4 s = *sp;
        *sp = make_float4(fmaf(s.x, dend, acc[i][0]), fmaf(s.y, dend, acc[i][1]),
                          fmaf(s.z, dend, acc[i][2]), fmaf(s.w, dend, acc[i][3]));
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < P * N; e += kThreads) {
    const int pp = e / N, n = e % N;
    p.state[s_off + e] = st[n * LdS + pp];
  }
}

template <typename T, int P, int N>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_floats<P, N>(p.Lp) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_fwd_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.H, B);
  ssd_fwd_kernel<T, P, N><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_n(const Params& p, int B, int N, cudaStream_t stream) {
  switch (N) {
    case 8: return launch<T, P, 8>(p, B, stream);
    case 16: return launch<T, P, 16>(p, B, stream);
    case 128: return launch<T, P, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_pn(const Params& p, int B, int P, int N,
                      cudaStream_t stream) {
  switch (P) {
    case 8: return launch_n<T, 8>(p, B, N, stream);
    case 16: return launch_n<T, 16>(p, B, N, stream);
    case 64: return launch_n<T, 64>(p, B, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of x, B_ and C_: 0 = float32, 1 = bfloat16.  strides: 15 element
// strides, x (b, t, h, p), dt (b, t, h), B_ (b, t, g, n), C_ (b, t, g, n).
// state0 may be null.  Returns a cudaError_t (0 on success).
int ssd_fwd(const void* x, const float* dt, const float* a, const void* b,
            const void* c, const float* state0, float* y, float* state,
            int dtype, int B, int T, int H, int G, int P, int N, int L,
            const long long* strides, void* stream) {
  if (B < 1 || T < 1 || H < 1 || G < 1 || H % G || L < 1 || L > kMaxL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.dt = dt; p.a = a; p.b = b; p.c = c;
  p.state0 = state0; p.y = y; p.state = state;
  p.x_sb = strides[0]; p.x_st = strides[1]; p.x_sh = strides[2];
  p.x_sp = strides[3];
  p.dt_sb = strides[4]; p.dt_st = strides[5]; p.dt_sh = strides[6];
  p.b_sb = strides[7]; p.b_st = strides[8]; p.b_sg = strides[9];
  p.b_sn = strides[10];
  p.c_sb = strides[11]; p.c_st = strides[12]; p.c_sg = strides[13];
  p.c_sn = strides[14];
  p.T = T; p.H = H; p.G = G; p.L = L;
  p.Lp = (L + 3) / 4 * 4;
  p.n_chunks = (T + L - 1) / L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_pn<float>(p, B, P, N, st);
  if (dtype == 1) return (int)launch_pn<__nv_bfloat16>(p, B, P, N, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
