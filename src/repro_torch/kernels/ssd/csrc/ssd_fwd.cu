// Mamba-2 chunked SSD scan for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the TPU Pallas kernel
//   src/repro/kernels/ssd/kernel.py:27 (``_ssd_kernel``, called through
//   ``ssd_scan``).
// Per chunk of L = min(chunk, T) rows it computes what that kernel computes:
// the inclusive cumsum css of dt * a, the masked lower-triangular
// intra-chunk term sum_{m <= l} (C_l . B_m) exp(css_l - css_m) dt_m x_m, the
// inter-chunk term exp(css_l) C_l . state, and the state update
// state <- exp(seg) state + sum_l B_l exp(seg - css_l) dt_l x_l (seg: the
// chunk's last css), with the fp32 (P, N) state of each (batch, head)
// carried across chunks.  Head h reads B/C group h / (H / G), as
// ``jnp.repeat`` maps it.  The ragged last chunk is masked in place: rows
// past T read as x = B = C = 0 and dt = 0, which is the JAX package's zero
// padding (identity decay, no input), and their y is not written.  Two
// things are added, and they are the contract of the JAX model's own XLA
// twin ``src/repro/models/mamba2.py::ssd_chunked``, which is what the model
// calls: an optional initial state (a null pointer means zeros) and the
// final state written out (the TPU kernel drops it).
//
// Inputs: x (B, T, H, P), B_ and C_ (B, T, G, N) with any element strides:
// the model passes strided views of its conv output, read in place.  dt
// (B, T, H) f32 with any element strides; a (H,) f32, contiguous.  Outputs,
// contiguous fp32: y (B, T, H, P) and the final state (B, H, P, N); state0
// is a contiguous fp32 (B, H, P, N) on 16 bytes, or null.  exp is formed only where its
// argument is <= 0: exp(css_l - css_m) for m <= l alone.
//
// Two paths; the wrapper (../kernel.py, ``plan``) picks one by dtype:
//
//   1. bfloat16 x/B/C: ``chunked``, Mamba-2's own chunk-parallel split, on
//      the tensor cores.  Bound: at a long prefill the bytes of the
//      chunk-state scratch and y, at the serve prompts the launches.
//      Four kernels, launched in order on the caller's stream:
//        a. ``ssd_chunk_cb``, grid (chunks, B * G): CB = C B^T (L x L,
//           fp32) of each chunk and group, 16 x 16 tiles on and below the
//           diagonal only, into a scratch (B, chunks, G, Lp, Lp).  It is
//           formed once per group, not once per head;
//        b. ``ssd_chunk_state``, grid (chunks, B * H): the state a chunk
//           adds, S_c[p, n] = sum_l x[l, p] (w_l B[l, n]) with
//           w_l = exp(seg - css_l) dt_l, into a scratch (B, chunks, H, P, N)
//           fp32, and seg into a scratch (B, chunks, H);
//        c. ``ssd_state_passing``, grid (tiles of P * N, B * H): the only
//           sequential part, elementwise and coalesced: s <- exp(seg_c) s
//           + S_c from state0 (or zeros); S_c is overwritten in place by
//           the state entering chunk c, and the final state is written;
//        d. ``ssd_chunk_scan``, grid (chunks, B * H): y = exp(css_l) C_l .
//           s_in (the inter-chunk term) + sum_{m <= l} att[l, m] x[m]
//           with att = CB[l, m] exp(css_l - css_m) dt_m (the intra-chunk
//           term), att formed tile by tile in registers, exp only where
//           m <= l.
//      With one chunk (every serve prompt, T <= 128) c is skipped: b's
//      epilogue writes exp(seg) state0 + S_0 as the final state and d
//      reads state0 itself.  Each of a, b and d recomputes its chunk's
//      cumsum with one warp scan.
//      Products: mma.sync.m16n8k16 bf16 x bf16 -> fp32, fragments through
//      ldmatrix (.trans where the stored layout is k-major).  N is
//      instantiated at 16 (N 8 and 16), 64 (zamba2's d_state) and 128
//      (mamba2's); padding N 64 to 128 would double the state work and the
//      shared memory of every zamba2 prefill.  C B^T takes
//      bf16 operands as they come and is exact in its products.  The other
//      three products have one fp32 operand, which is split into bf16
//      terms, hi = bf16(v), then bf16 of what is left, each term
//      multiplied: the carried state in two terms (~16 bits), att and
//      w_l B in three (~24 bits).  One term would miss the 1e-5 bar of
//      tests/test_kernels.py by ~200x; two terms of each gave up to 5.0e-6
//      of max |y| at the serve prompts on the card, so the two operands of
//      the products that reach y and the state directly take a third
//      (tests/test_torch_ssd.py emulates these arithmetics).  P and N are
//      padded to 16 with zeros in shared memory, the chunk's rows to Lp =
//      L rounded up to 16 (the wrapper's plan, passed in).  A block stages
//      its chunk with 16-byte cp.async where the view's base and strides
//      allow it and element by element otherwise: b holds x and B (55 KB at L 128, P 64, N 128: four
//      blocks an SM), d holds x, C and the fp32 state (90 KB: two); no
//      tile loop remains to pipeline.  Warp w of a and d takes the 16-row
//      tiles w and 7 - w, so that the triangle's work is balanced; in b
//      each warp takes two of the eight 16-column tiles of N and all four
//      of P, so that each split fragment of w_l B serves four products.
//      What holds d at ~3x its bytes at the 4k prefill (PERF.md): its
//      loads, made by every block at once, and its products, latency-bound
//      at 8 warps an SM, take turns rather than overlap.
//   2. float32 x/B/C: ``fp32``, the first port's CUDA-core kernel,
//      ``ssd_fwd_fp32``, unchanged in what it computes: one block of 256
//      threads per (b, h) loops over the chunks with the state in shared
//      memory; all products are fp32 FMAs.  The tensor cores have no fp32
//      product but TF32, and a three-term split of both operands would
//      cost more than float32, the type of the parity checks, is worth.
//
// Training asks for one more output, ``states``: the fp32 state entering
// each chunk, (B, chunks, H, P, N), which the backward (ssd_bwd.cu) reads
// instead of recomputing it.  The chunked path's state passing already
// leaves exactly that in its scratch c, so with more than one chunk the
// buffer takes the scratch's place; with one chunk b writes state0 (or
// zeros) into it; the fp32 kernel writes its shared state at each chunk's
// start.  Serving passes null and nothing more is written.
//
// wgmma, TMA and a fused single-pass scan are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd_fwd.so ssd_fwd.cu
// Bound with ctypes (see ../kernel.py).  The launcher allocates nothing
// (the wrapper passes the scratch), launches on the stream it is given and
// returns the first cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

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
  float* cb;                            // chunked: (B, chunks, G, Lp, Lp)
  float* cs;                            // chunked: (B, chunks, H, P, N)
  float* segs;                          // chunked: (B, chunks, H)
  float* states;                        // may be null: (B, chunks, H, P, N)
  long long x_sb, x_st, x_sh, x_sp;     // element strides
  long long dt_sb, dt_st, dt_sh;
  long long b_sb, b_st, b_sg, b_sn;
  long long c_sb, c_st, c_sg, c_sn;
  int T, H, G, P, N, L, Lp, n_chunks;
  int x_vec, b_vec, c_vec;              // chunked: 16-byte copies allowed
};

// Inclusive cumsum of dt * a over Lp <= 128 rows, by one warp (K rows a
// lane, then a shuffle scan of the lanes' totals).
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a,
                                             float* css, int Lp, int lane) {
  const int K = (Lp + 31) / 32;         // <= 4
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int l = lane * K + k;
    run += (k < K && l < Lp) ? dts[l] * a : 0.f;
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const float excl = incl - run;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int l = lane * K + k;
    if (k < K && l < Lp) css[l] = excl + v[k];
  }
}

// ---- path 2: float32 (the first port's CUDA-core kernel) -------------------

constexpr int kThreads = 256;
constexpr int kStrip = 32;              // rows of the L x L block per strip
constexpr int kLdA = kStrip + 4;        // row stride of the strip buffer

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

// One block of 256 threads per (b, h); the chunks in a loop, the state in
// shared memory.  A chunk is staged as fp32: x (L, P), B and C transposed
// (N, L) so that the score loop reads 16-byte vectors; the L x L block is
// formed in row strips of 32 rows, one 4 x 4 tile a thread, tiles above
// the diagonal never, and each strip's y rows are finished from it.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_fp32(const Params p) {
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
  const float* X = static_cast<const float*>(p.x) + bb * p.x_sb + h * p.x_sh;
  const float* Bg = static_cast<const float*>(p.b) + bb * p.b_sb + g * p.b_sg;
  const float* Cg = static_cast<const float*>(p.c) + bb * p.c_sb + g * p.c_sg;
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
    if (p.states) {                      // the state entering the chunk
      float* sd = p.states + (((long long)bb * p.n_chunks + ck) * p.H + h) * P * N;
      for (int e = tid; e < P * N; e += kThreads)
        sd[e] = st[(e % N) * LdS + e / N];
    }
    // ---- stage the chunk -------------------------------------------------
    for (int e = tid; e < Lp * P; e += kThreads) {
      const int l = e / P, pp = e % P;
      xs[e] = l < nv ? X[(t0 + l) * p.x_st + pp * p.x_sp] : 0.f;
    }
    for (int e = tid; e < Lp * N; e += kThreads) {
      const int l = e / N, n = e % N;
      const bool v = l < nv;
      bt[n * LdB + l] = v ? Bg[(t0 + l) * p.b_st + n * p.b_sn] : 0.f;
      ct[n * LdB + l] = v ? Cg[(t0 + l) * p.c_st + n * p.c_sn] : 0.f;
    }
    for (int l = tid; l < Lp; l += kThreads)
      dts[l] = l < nv ? DT[(t0 + l) * p.dt_st] : 0.f;
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, a, css, Lp, tid);
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

template <int P, int N>
cudaError_t launch_fp32(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_floats<P, N>(p.Lp) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_fwd_fp32<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.H, B);
  ssd_fwd_fp32<P, N><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_fp32_n(const Params& p, int B, cudaStream_t stream) {
  switch (p.N) {
    case 8: return launch_fp32<P, 8>(p, B, stream);
    case 16: return launch_fp32<P, 16>(p, B, stream);
    case 64: return launch_fp32<P, 64>(p, B, stream);
    case 128: return launch_fp32<P, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_fp32_pn(const Params& p, int B, cudaStream_t stream) {
  switch (p.P) {
    case 8: return launch_fp32_n<8>(p, B, stream);
    case 16: return launch_fp32_n<16>(p, B, stream);
    case 64: return launch_fp32_n<64>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- path 1: bfloat16, chunk-parallel on the tensor cores ------------------

constexpr int kWarps = 4;
constexpr int kMmaThreads = kWarps * 32;
constexpr int kPassThreads = 256;

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
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}
// Two floats as a bf16 pair hi = bf16(v) and the pair of what it left out,
// lo = bf16(v - hi); the lower column in the low half.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}
// The same in three terms: hi, mid = bf16(v - hi), lo = bf16(v - hi - mid).
__device__ __forceinline__ void split3_bf16(float v0, float v1, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  split_bf16(v0 - hf.x, v1 - hf.y, mid, lo);
  hi = as_u32(h);
}

// The chunk's rows [0, Lp) x columns [0, WP) of a bf16 (rows, W) view into
// shared memory of row pitch ``ld``; rows >= nv and columns >= W read as 0.
// Sixteen-byte copies where ``vec`` says the view allows them (unit column
// stride, 16-byte aligned rows), element by element otherwise.  The caller
// waits for the copies (cp_async_wait_all) and synchronises.
template <int WP>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long rs, long long cs, int nv,
                                          int W, int Lp, int vec) {
  if (vec) {
    constexpr int CPR = WP / 8;
    for (int i = threadIdx.x; i < Lp * CPR; i += kMmaThreads) {
      const int r = i / CPR, ch = i % CPR;
      const bool in = r < nv && ch * 8 < W;
      cp_async16(dst + r * ld + ch * 8, in ? src + r * rs + ch * 8 : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < Lp * WP; i += kMmaThreads) {
      const int r = i / WP, col = i % WP;
      dst[r * ld + col] = (r < nv && col < W) ? src[r * rs + col * cs]
                                              : __float2bfloat16(0.f);
    }
  }
}

// The chunk's dt (rows past nv as 0) and, by warp 0, its cumsum; the caller
// synchronises.
__device__ __forceinline__ void chunk_dt(const Params& p, int bb, int h,
                                         int t0, int nv, float* dts,
                                         float* css) {
  const float* DT = p.dt + bb * p.dt_sb + h * p.dt_sh + t0 * p.dt_st;
  for (int l = threadIdx.x; l < p.Lp; l += kMmaThreads)
    dts[l] = l < nv ? DT[l * p.dt_st] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) chunk_cumsum(dts, p.a[h], css, p.Lp, threadIdx.x);
}

// Row pitch (elements) of a bf16 shared-memory tile of W columns: the row
// plus 16 bytes, so that ldmatrix's eight row reads fall in distinct banks.
__host__ __device__ constexpr int pitch16(int W) { return W + 8; }

template <int NP>
__host__ __device__ size_t cb_smem_bytes(int Lp) {
  return 2 * (size_t)Lp * pitch16(NP) * sizeof(bf16);
}

// a. CB = C B^T of one (b, chunk, group): warp w forms the 16-row tiles w
// and 7 - w, each against the 16-column tiles on and left of the diagonal.
template <int NP>
__global__ void __launch_bounds__(kMmaThreads)
ssd_chunk_cb(const Params p) {
  constexpr int LD = pitch16(NP), NK = NP / 16;
  const int c = blockIdx.x, bb = blockIdx.y / p.G, g = blockIdx.y % p.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tig = lane & 3;
  const int Lp = p.Lp, t0 = c * p.L, nv = min(p.L, p.T - t0);

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* cs_ = reinterpret_cast<bf16*>(smem);
  bf16* bs_ = cs_ + Lp * LD;
  load_tile<NP>(cs_, LD, static_cast<const bf16*>(p.c) + bb * p.c_sb +
                t0 * p.c_st + g * p.c_sg, p.c_st, p.c_sn, nv, p.N, Lp, p.c_vec);
  load_tile<NP>(bs_, LD, static_cast<const bf16*>(p.b) + bb * p.b_sb +
                t0 * p.b_st + g * p.b_sg, p.b_st, p.b_sn, nv, p.N, Lp, p.b_vec);
  cp_async_wait_all();
  __syncthreads();

  float* out = p.cb + (((long long)bb * p.n_chunks + c) * p.G + g) * Lp * Lp;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int mt = s ? 2 * kWarps - 1 - warp : warp;
    if (mt * 16 >= Lp) continue;
    uint32_t af[NK][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      ldmatrix_x4(af[kk], cs_ + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                              kk * 16 + (lane >> 4) * 8);
    for (int nb = 0; nb <= mt; ++nb) {
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, bs_ + (nb * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                             kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[0], af[kk], bfr[0], bfr[1]);
        mma_bf16(acc[1], af[kk], bfr[2], bfr[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(out + (mt * 16 + gr + hh * 8) * Lp +
                                     nb * 16 + j * 8 + tig * 2) =
              make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
  }
}

template <int PP, int NP>
__host__ __device__ size_t state_smem_bytes(int Lp) {
  return ((size_t)Lp * pitch16(PP) + (size_t)Lp * pitch16(NP)) *
             sizeof(bf16) + 3 * (size_t)Lp * sizeof(float);
}

// b. The state one (b, chunk, head) adds, S[p, n] = sum_l x[l, p] wB[l, n]
// (M = P, N = N, K = the chunk's rows), wB = w_l B[l, n] formed and split
// into three bf16 terms in registers from B's fragments.
template <int PP, int NP>
__global__ void __launch_bounds__(kMmaThreads, 4)
ssd_chunk_state(const Params p) {
  constexpr int LDX = pitch16(PP), LDB = pitch16(NP);
  constexpr int MI = PP / 16, NI = NP / 16;      // 16 x 16 output tiles
  constexpr int WN = NI < kWarps ? NI : kWarps, WM = kWarps / WN;
  constexpr int MT = (MI + WM - 1) / WM, NT = NI / WN;   // tiles a warp
  const int c = blockIdx.x, bb = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int g = h / (p.H / p.G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tig = lane & 3;
  const int wn = warp % WN, wm = warp / WN;
  const int Lp = p.Lp, t0 = c * p.L, nv = min(p.L, p.T - t0);

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* bs = xs + Lp * LDX;
  float* css = reinterpret_cast<float*>(bs + Lp * LDB);
  float* dts = css + Lp;
  float* w = dts + Lp;

  load_tile<PP>(xs, LDX, static_cast<const bf16*>(p.x) + bb * p.x_sb +
                t0 * p.x_st + h * p.x_sh, p.x_st, p.x_sp, nv, p.P, Lp, p.x_vec);
  load_tile<NP>(bs, LDB, static_cast<const bf16*>(p.b) + bb * p.b_sb +
                t0 * p.b_st + g * p.b_sg, p.b_st, p.b_sn, nv, p.N, Lp, p.b_vec);
  chunk_dt(p, bb, h, t0, nv, dts, css);
  cp_async_wait_all();
  __syncthreads();
  const float seg = css[Lp - 1];         // padded rows add 0
  for (int l = threadIdx.x; l < Lp; l += kMmaThreads)
    w[l] = expf(seg - css[l]) * dts[l];
  __syncthreads();

  // Warp w takes the n-tiles wn, wn + WN, ... and the m-tiles wm, wm + WM,
  // ...: each B fragment is split once and serves all of the warp's
  // m-tiles, each A fragment all of its n-tiles.
  float acc[MT][NT][2][4] = {};
  for (int kk = 0; kk < Lp / 16; ++kk) {
    uint32_t af[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (wm + WM * i < MI)
        ldmatrix_x4_trans(af[i], xs + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * LDX +
                                     (wm + WM * i) * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bf[4], bh[4], bm[4], bl[4];
      ldmatrix_x4_trans(bf, bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB +
                                (wn + WN * j) * 16 + (lane >> 4) * 8);
      // bf[r] holds rows (k) kk * 16 + 2 tig + {0, 1}, + 8 for odd r
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = kk * 16 + (r & 1) * 8 + 2 * tig;
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&bf[r]));
        split3_bf16(w[k] * v.x, w[k + 1] * v.y, bh[r], bm[r], bl[r]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (wm + WM * i >= MI) continue;
        mma_bf16(acc[i][j][0], af[i], bh[0], bh[1]);
        mma_bf16(acc[i][j][0], af[i], bm[0], bm[1]);
        mma_bf16(acc[i][j][0], af[i], bl[0], bl[1]);
        mma_bf16(acc[i][j][1], af[i], bh[2], bh[3]);
        mma_bf16(acc[i][j][1], af[i], bm[2], bm[3]);
        mma_bf16(acc[i][j][1], af[i], bl[2], bl[3]);
      }
    }
  }

  // One chunk: this is the final state, exp(seg) state0 + S (state0 read
  // in full before the first store, so that its loads overlap).  Otherwise
  // S goes to the scratch for the state passing, with seg.
  const bool one = p.n_chunks == 1;
  const long long PN = (long long)p.P * p.N;
  float* dst = one ? p.state + ((long long)bb * p.H + h) * PN
                   : p.cs + (((long long)bb * p.n_chunks + c) * p.H + h) * PN;
  const float* s0 = one && p.state0 ? p.state0 + ((long long)bb * p.H + h) * PN : nullptr;
  const float dend = expf(seg);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 0 && !s0) continue;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int pp = (wm + WM * i) * 16 + gr + hh * 8;
            const int n = (wn + WN * j) * 16 + jn * 8 + tig * 2;
            if (pp >= p.P || n >= p.N) continue;
            float* v = &acc[i][j][jn][2 * hh];
            if (pass == 0) {
              const float2 s = *reinterpret_cast<const float2*>(s0 + pp * p.N + n);
              v[0] = fmaf(s.x, dend, v[0]);
              v[1] = fmaf(s.y, dend, v[1]);
            } else {
              *reinterpret_cast<float2*>(dst + pp * p.N + n) = make_float2(v[0], v[1]);
            }
          }
  }
  if (!one && threadIdx.x == 0)
    p.segs[((long long)bb * p.n_chunks + c) * p.H + h] = seg;
  // One chunk: the state entering it, for the backward, is state0 (or 0).
  if (one && p.states) {
    float* sd = p.states + ((long long)bb * p.H + h) * PN;
    for (int e = threadIdx.x; e < PN; e += kMmaThreads)
      sd[e] = s0 ? s0[e] : 0.f;
  }
}

// c. s <- exp(seg_c) s + S_c over the chunks, four state elements a
// thread; S_c is replaced by the state entering chunk c.  The loads of
// kPassDepth chunks are issued before their results are used, so that
// enough bytes are in flight to stream at the HBM rate.
constexpr int kPassDepth = 8;

__device__ __forceinline__ float4 fma4(float4 s, float d, float4 v) {
  return make_float4(fmaf(s.x, d, v.x), fmaf(s.y, d, v.y), fmaf(s.z, d, v.z),
                     fmaf(s.w, d, v.w));
}

__global__ void __launch_bounds__(kPassThreads)
ssd_state_passing(const Params p) {
  const int PN4 = p.P * p.N / 4;
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= PN4) return;
  const int bh = blockIdx.y, bb = bh / p.H, h = bh % p.H, nc = p.n_chunks;
  const long long step = (long long)p.H * PN4;
  float4* cs = reinterpret_cast<float4*>(p.cs) +
               ((long long)bb * nc * p.H + h) * PN4 + e;
  const float* segs = p.segs + (long long)bb * nc * p.H + h;
  float4 s = p.state0
                 ? reinterpret_cast<const float4*>(p.state0)[(long long)bh * PN4 + e]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kPassDepth) {
    float4 v[kPassDepth];
    float d[kPassDepth];
#pragma unroll
    for (int i = 0; i < kPassDepth; ++i)
      if (c0 + i < nc) {
        v[i] = cs[(c0 + i) * step];
        d[i] = expf(segs[(c0 + i) * p.H]);
      }
#pragma unroll
    for (int i = 0; i < kPassDepth; ++i)
      if (c0 + i < nc) {
        cs[(c0 + i) * step] = s;
        s = fma4(s, d[i], v[i]);
      }
  }
  reinterpret_cast<float4*>(p.state)[(long long)bh * PN4 + e] = s;
}

template <int PP, int NP>
__host__ __device__ size_t scan_smem_bytes(int Lp) {
  return ((size_t)Lp * pitch16(NP) + (size_t)Lp * pitch16(PP)) *
             sizeof(bf16) +
         ((size_t)PP * pitch16(NP) + 3 * (size_t)Lp) * sizeof(float);
}

// d. y of one (b, chunk, head): warp w takes the 16-row tiles w and 7 - w.
// Inter-chunk: exp(css_l) C[l, :] . s_in[p, :] (M = rows, N = P, K = N),
// s_in staged in fp32 and split hi + lo in registers.  Intra-chunk: att
// (M = rows, K = rows m <= l) formed in registers from CB, split into
// three bf16 terms, times x (N = P).
template <int PP, int NP>
__global__ void __launch_bounds__(kMmaThreads)
ssd_chunk_scan(const Params p) {
  constexpr int LDC = pitch16(NP), LDX = pitch16(PP), LDS = pitch16(NP);
  constexpr int NK = NP / 16, NB = PP / 8;
  const int c = blockIdx.x, bb = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int g = h / (p.H / p.G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tig = lane & 3;
  const int Lp = p.Lp, t0 = c * p.L, nv = min(p.L, p.T - t0);

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* cs_ = reinterpret_cast<bf16*>(smem);
  bf16* xs = cs_ + Lp * LDC;
  float* ss = reinterpret_cast<float*>(xs + Lp * LDX);
  float* css = ss + PP * LDS;
  float* dts = css + Lp;
  float* ecs = dts + Lp;

  load_tile<NP>(cs_, LDC, static_cast<const bf16*>(p.c) + bb * p.c_sb +
                t0 * p.c_st + g * p.c_sg, p.c_st, p.c_sn, nv, p.N, Lp, p.c_vec);
  load_tile<PP>(xs, LDX, static_cast<const bf16*>(p.x) + bb * p.x_sb +
                t0 * p.x_st + h * p.x_sh, p.x_st, p.x_sp, nv, p.P, Lp, p.x_vec);
  // The state entering the chunk (the state passing's output, or state0
  // when there is one chunk, or none), (P, N) into ss [PP][LDS].
  const long long PN = (long long)p.P * p.N;
  const float* sin =
      p.n_chunks > 1
          ? p.cs + (((long long)bb * p.n_chunks + c) * p.H + h) * PN
          : (p.state0 ? p.state0 + ((long long)bb * p.H + h) * PN : nullptr);
  if (sin) {
    for (int i = threadIdx.x; i < PP * NP / 4; i += kMmaThreads) {
      const int pp = i / (NP / 4), n = 4 * (i % (NP / 4));
      const bool in = pp < p.P && n < p.N;
      cp_async16(ss + pp * LDS + n, in ? sin + pp * p.N + n : sin, in ? 16 : 0);
    }
  }
  chunk_dt(p, bb, h, t0, nv, dts, css);
  cp_async_wait_all();
  __syncthreads();
  for (int l = threadIdx.x; l < Lp; l += kMmaThreads) ecs[l] = expf(css[l]);
  __syncthreads();

  // The warp's row tiles; the second is absent where Lp is short.
  const int mts[2] = {warp, 2 * kWarps - 1 - warp};
  const bool has[2] = {mts[0] * 16 < Lp, mts[1] * 16 < Lp};
  if (!has[0]) return;
  float acc[2][NB][4] = {};
  if (sin) {
#pragma unroll 2
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (has[s])
          ldmatrix_x4(af[s], cs_ + (mts[s] * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDC +
                                 kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        // B fragment: s_in[p][n] at p = nb * 8 + gr, n = kk * 16 + 2 tig
        // (+ 8 for the second register)
        const float* sp = ss + (nb * 8 + gr) * LDS + kk * 16 + 2 * tig;
        const float2 v0 = *reinterpret_cast<const float2*>(sp);
        const float2 v1 = *reinterpret_cast<const float2*>(sp + 8);
        uint32_t hi0, lo0, hi1, lo1;
        split_bf16(v0.x, v0.y, hi0, lo0);
        split_bf16(v1.x, v1.y, hi1, lo1);
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (has[s]) {
            mma_bf16(acc[s][nb], af[s], hi0, hi1);
            mma_bf16(acc[s][nb], af[s], lo0, lo1);
          }
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (!has[s]) continue;
      const float e0 = ecs[mts[s] * 16 + gr], e1 = ecs[mts[s] * 16 + gr + 8];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        acc[s][n][0] *= e0; acc[s][n][1] *= e0;
        acc[s][n][2] *= e1; acc[s][n][3] *= e1;
      }
    }
  }

  const float* cbp =
      p.cb + (((long long)bb * p.n_chunks + c) * p.G + g) * Lp * Lp;
  float* Y = p.y + ((long long)bb * p.T * p.H + h) * p.P;
  const long long y_st = (long long)p.H * p.P;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (!has[s]) continue;
    const int mt = mts[s];
    const int r0 = mt * 16 + gr, r1 = r0 + 8;
    const float c0 = css[r0], c1 = css[r1];
    // CB at rows r0, r1 and columns m, m + 1, m + 8, m + 9 of tile kc; the
    // next tile's are loaded while this one is used.
    float2 cbn[2][2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
        cbn[hh][kh] = *reinterpret_cast<const float2*>(
            cbp + (hh ? r1 : r0) * Lp + kh * 8 + tig * 2);
    for (int kc = 0; kc <= mt; ++kc) {
      float2 cbt[2][2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          cbt[hh][kh] = cbn[hh][kh];
          if (kc < mt)
            cbn[hh][kh] = *reinterpret_cast<const float2*>(
                cbp + (hh ? r1 : r0) * Lp + (kc + 1) * 16 + kh * 8 + tig * 2);
        }
      float at[2][2][2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          const int r = hh ? r1 : r0, m = kc * 16 + kh * 8 + tig * 2;
          const float cr = hh ? c1 : c0;
          const float2 cbv = cbt[hh][kh];
          at[hh][kh][0] = m <= r ? cbv.x * expf(cr - css[m]) * dts[m] : 0.f;
          at[hh][kh][1] = m + 1 <= r ? cbv.y * expf(cr - css[m + 1]) * dts[m + 1] : 0.f;
        }
      uint32_t ahi[4], amid[4], alo[4];
      split3_bf16(at[0][0][0], at[0][0][1], ahi[0], amid[0], alo[0]);
      split3_bf16(at[1][0][0], at[1][0][1], ahi[1], amid[1], alo[1]);
      split3_bf16(at[0][1][0], at[0][1][1], ahi[2], amid[2], alo[2]);
      split3_bf16(at[1][1][0], at[1][1][1], ahi[3], amid[3], alo[3]);
#pragma unroll
      for (int nd = 0; nd < PP / 16; ++nd) {
        uint32_t xf[4];
        ldmatrix_x4_trans(xf, xs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX +
                                  nd * 16 + (lane >> 4) * 8);
        mma_bf16(acc[s][2 * nd], ahi, xf[0], xf[1]);
        mma_bf16(acc[s][2 * nd], amid, xf[0], xf[1]);
        mma_bf16(acc[s][2 * nd], alo, xf[0], xf[1]);
        mma_bf16(acc[s][2 * nd + 1], ahi, xf[2], xf[3]);
        mma_bf16(acc[s][2 * nd + 1], amid, xf[2], xf[3]);
        mma_bf16(acc[s][2 * nd + 1], alo, xf[2], xf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int p0 = n * 8 + tig * 2;
      if (p0 >= p.P) continue;
      if (r0 < nv)
        *reinterpret_cast<float2*>(Y + (t0 + r0) * y_st + p0) =
            make_float2(acc[s][n][0], acc[s][n][1]);
      if (r1 < nv)
        *reinterpret_cast<float2*>(Y + (t0 + r1) * y_st + p0) =
            make_float2(acc[s][n][2], acc[s][n][3]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int PP, int NP>
cudaError_t launch_chunked(const Params& p, int B, cudaStream_t stream) {
  const int Lp = p.Lp;
  cudaError_t e;
  const size_t cb_smem = cb_smem_bytes<NP>(Lp);
  if ((e = allow_smem(ssd_chunk_cb<NP>, cb_smem)) != cudaSuccess) return e;
  ssd_chunk_cb<NP><<<dim3(p.n_chunks, B * p.G), kMmaThreads, cb_smem, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t st_smem = state_smem_bytes<PP, NP>(Lp);
  if ((e = allow_smem(ssd_chunk_state<PP, NP>, st_smem)) != cudaSuccess) return e;
  ssd_chunk_state<PP, NP>
      <<<dim3(p.n_chunks, B * p.H), kMmaThreads, st_smem, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  if (p.n_chunks > 1) {
    const int tiles = (p.P * p.N / 4 + kPassThreads - 1) / kPassThreads;
    ssd_state_passing<<<dim3(tiles, B * p.H), kPassThreads, 0, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }

  const size_t sc_smem = scan_smem_bytes<PP, NP>(Lp);
  if ((e = allow_smem(ssd_chunk_scan<PP, NP>, sc_smem)) != cudaSuccess) return e;
  ssd_chunk_scan<PP, NP>
      <<<dim3(p.n_chunks, B * p.H), kMmaThreads, sc_smem, stream>>>(p);
  return cudaGetLastError();
}

template <int PP>
cudaError_t launch_chunked_n(const Params& p, int B, cudaStream_t stream) {
  if (p.N <= 16) return launch_chunked<PP, 16>(p, B, stream);
  if (p.N == 64) return launch_chunked<PP, 64>(p, B, stream);
  return launch_chunked<PP, 128>(p, B, stream);
}

// A bf16 view allows 16-byte copies of its rows: unit column stride, and
// every row of every (b, h or g) starts on 16 bytes.
int vec_ok(const void* ptr, long long sb, long long st, long long sh,
           long long sc) {
  return sc == 1 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         sb % 8 == 0 && st % 8 == 0 && sh % 8 == 0;
}

}  // namespace

extern "C" {

// path: 0 = chunked (bfloat16 x, B_, C_), 1 = fp32 (float32).  L, Lp and
// n_chunks are the caller's plan (../kernel.py, ``plan``): the chunk's rows,
// L padded to the path's tile (16 for chunked, 4 for fp32) and the number
// of chunks; they are checked, not recomputed.  strides: 15 element
// strides, x (b, t, h, p), dt (b, t, h), B_ (b, t, g, n), C_ (b, t, g, n).
// state0 may be null.  The chunked path takes three scratch buffers from
// the caller: cb of B * chunks * G * Lp * Lp floats, and, with more than
// one chunk, cs of B * chunks * H * P * N and segs of B * chunks * H
// floats.  ``states`` may be null; if given (contiguous fp32 (B, chunks, H,
// P, N)), the state entering each chunk is written there for the backward
// (ssd_bwd.cu): on the chunked path with more than one chunk it takes the
// place of cs, whose state passing leaves exactly that in it.  Returns a
// cudaError_t (0 on success).
int ssd_fwd(const void* x, const float* dt, const float* a, const void* b,
            const void* c, const float* state0, float* y, float* state,
            float* cb, float* cs, float* segs, float* states, int path,
            int B, int T, int H,
            int G, int P, int N, int L, int Lp, int n_chunks,
            const long long* strides, void* stream) {
  const int tile = path == 0 ? 16 : 4;
  if (B < 1 || T < 1 || H < 1 || G < 1 || H % G || L < 1 || L > kMaxL ||
      (P != 8 && P != 16 && P != 64) || (N != 8 && N != 16 && N != 64 && N != 128) ||
      Lp < L || Lp >= L + tile || Lp % tile || Lp > kMaxL ||
      (long long)(n_chunks - 1) * L >= T || (long long)n_chunks * L < T)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.dt = dt; p.a = a; p.b = b; p.c = c;
  p.state0 = state0; p.y = y; p.state = state;
  if (path == 0 && n_chunks > 1 && states) cs = states;
  p.cb = cb; p.cs = cs; p.segs = segs; p.states = states;
  p.x_sb = strides[0]; p.x_st = strides[1]; p.x_sh = strides[2];
  p.x_sp = strides[3];
  p.dt_sb = strides[4]; p.dt_st = strides[5]; p.dt_sh = strides[6];
  p.b_sb = strides[7]; p.b_st = strides[8]; p.b_sg = strides[9];
  p.b_sn = strides[10];
  p.c_sb = strides[11]; p.c_st = strides[12]; p.c_sg = strides[13];
  p.c_sn = strides[14];
  p.T = T; p.H = H; p.G = G; p.P = P; p.N = N; p.L = L;
  p.Lp = Lp; p.n_chunks = n_chunks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 1) return (int)launch_fp32_pn(p, B, st);
  if (path != 0 || !cb || (n_chunks > 1 && (!cs || !segs)))
    return (int)cudaErrorInvalidValue;
  p.x_vec = vec_ok(x, p.x_sb, p.x_st, p.x_sh, p.x_sp);
  p.b_vec = vec_ok(b, p.b_sb, p.b_st, p.b_sg, p.b_sn);
  p.c_vec = vec_ok(c, p.c_sb, p.c_st, p.c_sg, p.c_sn);
  return (int)(P == 64 ? launch_chunked_n<64>(p, B, st)
                       : launch_chunked_n<16>(p, B, st));
}

const char* ssd_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
