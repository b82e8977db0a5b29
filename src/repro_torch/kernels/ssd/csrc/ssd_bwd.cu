// The gradient of the Mamba-2 chunked SSD scan for NVIDIA Hopper (sm_90a),
// written by hand.
//
// Replaces the gradient of the TPU Pallas kernel
//   src/repro/kernels/ssd/kernel.py:27 (``_ssd_kernel``), which the JAX
//   package takes by XLA's autodiff of its XLA twin
//   src/repro/models/mamba2.py:60 (``ssd_chunked``).
// It computes what ../ref.py's ``ssd_chunked_bwd`` computes, from the same
// formulas: given dy (the gradient of y) and dstate (that of the final
// state, or null for zeros), the gradients dx, ddt, da, dB, dC and dstate0.
// Per chunk of L rows and head h (group g = h / (H / G)), with css the
// inclusive cumsum of dt a, seg its last value, E[l, m] = exp(css_l - css_m)
// for m <= l, w_m = exp(seg - css_m), s_in the state entering the chunk and
// ds the gradient of the state leaving it:
//
//   dx_m   = sum_l (C_l . B_m) E dt_m dy_l + w_m dt_m ds B_m
//   dC_l   = exp(css_l) s_in^T dy_l + sum_m A2[l, m] B_m,  A2 = (dy_l . x_m) E dt_m
//   dB_m   = sum_l A2[l, m] C_l + w_m dt_m ds^T x_m
//   ddt_m  = colsum_m Z + v_m + a dda_m,  Z = (dy_l . x_m)(C_l . B_m) E,
//            v_m = w_m x_m . (ds B_m)
//   dcss_l = C_l . (exp(css_l) s_in^T dy_l) + sum_m Z[l, m] dt_m
//            - dt_l colsum_l Z - dt_l v_l;  the last row also takes
//            sum_m dt_m v_m + exp(seg) <ds, s_in>
//   dda    = the reverse cumsum of dcss;  da_h = sum over (b, t) of dt dda
//   ds_prev = exp(seg) ds + sum_l exp(css_l) dy_l C_l^T;  dstate0 = the
//            first chunk's ds_prev.
//
// The states entering the chunks are not recomputed: the forward
// (ssd_fwd.cu) writes them into a (B, chunks, H, P, N) fp32 buffer when it
// is asked to (its ``states`` output; the chunked path keeps its state
// passing's scratch), and the autograd function saves it.  Recomputing them
// would cost a second forward (the chunk states and the sequential state
// passing) inside every backward; keeping them costs B T H P N / L floats,
// 268 MB per mamba2 layer call at B 4, T 4,096, of which one layer's are
// alive at a time under full remat.
//
// Five launches on the caller's stream:
//   a. ``ssd_bwd_dstate``, grid (chunks, B * H): the chunk's dy terms: the
//      state-gradient term dS = sum_l exp(css_l) dy_l C_l^T (P x N, into the
//      ds scratch), the inter-chunk term of dC, exp(css_l) s_in^T dy_l (into
//      the per-head dC partials, as their first value) with its dcss share
//      C_l . that (into a (B, chunks, H, Lp) scratch), and seg.  Two blocks
//      an SM (100 KB of shared memory at L 128, P 64, N 128);
//   b. ``ssd_bwd_state_passing``, grid (tiles of P * N, B * H): the only
//      sequential part, elementwise over P * N, the forward's state passing
//      run backwards: ds_prev = exp(seg_c) ds_c + dS_c from dstate (or
//      zeros), ds_c replacing dS_c in place; dstate0 is written;
//   c. ``ssd_bwd_chunk``, grid (chunks, B * H): the rest of the chunk.  The
//      chunk's x, dy, B and C are staged in fp32 in shared memory (228 KB at
//      L 128, P 64, N 128: one block an SM).  The lower triangle of the
//      L x L matrices is taken in strips of 16 rows l: each strip forms
//      C_l . B_m and dy_l . x_m for m <= l (a warp two rows, a lane the
//      columns lane + 32 q) and the strip's rows of A1 = CB E dt_m, A2 and
//      Z into shared memory, then adds A1^T dy and A2^T C to dx and dB
//      (whose (Lp x P) and (Lp x N) sums each thread keeps in registers
//      across the strips), finishes the strip's rows of dC = the inter term
//      + A2 B, and its row and column sums of Z.  Then the inter-chunk terms
//      of dx and dB from ds (staged where dy was), v, <ds, s_in>, and one
//      warp's reverse scan of dcss gives dda, ddt and the chunk's share of
//      da;
//   d. ``ssd_bwd_group_sum``: dB and dC summed over the heads of a group,
//      in head order;
//   e. ``ssd_bwd_da_sum``, grid H: da summed over (b, chunk) in a fixed
//      tree.
// No atomics: every sum runs in an order fixed by the shapes, so a rerun
// equals the first bit for bit.  Rows past T read as x = B = C = dy = 0 and
// dt = 0, the forward's padding, and nothing is written for them.
//
// Products run on the CUDA cores in fp32, with fp32 sums, for both input
// types (bf16 x/B/C are widened as they are staged), so the gradients meet
// the 1e-5 bar with room (chip_smoke.py 13f).  Bound: at mamba2's training
// shape (B 4, T 4,096, H 64, P 64, N 128, L 128) the bytes the gradient
// needs (~0.70 GB: x, B, C, dt and dy read, dx, ddt, dB and dC written,
// once each) over the HBM rate, 0.21 ms; the chunk states this design
// also reads (0.27 GB) are its own choice and not counted.  The
// operations, ~0.12 TFLOP over the triangle, take 0.12 ms at the bf16
// peak and ~1.8 ms at the CUDA cores' fp32 peak.  This design is ~85x
// the bound (PERF.md): one block of 8 warps an SM in c, whose FMAs
// wait on shared-memory loads (~1 load for 2 FMA) and whose staging is
// not overlapped with compute.  The tensor cores (the forward's split bf16
// terms), wgmma, TMA and fusing a into c are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd_bwd.so ssd_bwd.cu
// Bound with ctypes (see ../kernel.py).  The launcher allocates nothing
// (the wrapper passes outputs and scratch), launches on the stream it is
// given and returns the first cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxL = 128;
constexpr int kThreads = 256;
constexpr int kTile = 16;          // rows of a strip; Lp is a multiple of it
constexpr int kRows = kMaxL / kTile;

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* dy;
  const float* dstate;             // may be null: zeros
  const float* states;             // (B, chunks, H, P, N): entering each chunk
  float* dx;                       // (B, T, H, P)
  float* ddt;                      // (B, T, H)
  float* dstate0;                  // (B, H, P, N), may be null: not written
  float* dbh;                      // (B, T, H, N) per-head partials
  float* dch;
  float* db;                       // (B, T, G, N)
  float* dc;
  float* da;                       // (H,)
  float* dsc;                      // scratch (B, chunks, H, P, N): dS, then ds
  float* segs;                     // scratch (B, chunks, H)
  float* dcss;                     // scratch (B, chunks, H, Lp): dC's dcss share
  float* da_part;                  // scratch (B, chunks, H)
  long long x_sb, x_st, x_sh, x_sp;   // element strides
  long long dt_sb, dt_st, dt_sh;
  long long b_sb, b_st, b_sg, b_sn;
  long long c_sb, c_st, c_sg, c_sn;
  long long dy_sb, dy_st, dy_sh, dy_sp;
  int B, T, H, G, P, N, L, Lp, n_chunks, in_bf16;
};

__device__ __forceinline__ float load_in(const void* p, long long i,
                                         int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// The chunk's rows [0, Lp) x columns [0, WP) of a (rows, W) view into
// shared memory of row pitch ``ld``, in fp32; rows >= nv and columns >= W
// read as 0.  The caller synchronises.
__device__ __forceinline__ void stage(float* dst, int ld, const void* src,
                                      long long rs, long long cs, int nv,
                                      int W, int WP, int Lp, int is_bf16) {
  for (int i = threadIdx.x; i < Lp * WP; i += kThreads) {
    const int r = i / WP, col = i % WP;
    dst[r * ld + col] =
        (r < nv && col < W) ? load_in(src, r * rs + col * cs, is_bf16) : 0.f;
  }
}

// The chunk's dt (rows past nv as 0) and, by warp 0, the inclusive cumsum
// of dt * a over Lp <= 128 rows (K rows a lane, then a shuffle scan of the
// lanes' totals), as ssd_fwd.cu forms it.  The caller synchronises.
__device__ __forceinline__ void chunk_dt(const Params& p, int bb, int h,
                                         int t0, int nv, float* dts,
                                         float* css) {
  const float* DT = p.dt + bb * p.dt_sb + h * p.dt_sh + t0 * p.dt_st;
  for (int l = threadIdx.x; l < p.Lp; l += kThreads)
    dts[l] = l < nv ? DT[l * p.dt_st] : 0.f;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, Lp = p.Lp, K = (Lp + 31) / 32;
  const float a = p.a[h];
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

// Sum over the 16 lanes of a half warp, in a fixed order; every lane of the
// half gets the sum.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ long long chunk_index(const Params& p, int bb,
                                                 int c, int h) {
  return ((long long)bb * p.n_chunks + c) * p.H + h;
}

// ---- a. the chunk's dy terms ------------------------------------------------

template <int PP, int NP>
__host__ __device__ size_t dstate_smem_floats(int Lp) {
  return (size_t)Lp * (PP + 1)          // dys [Lp][PP + 1], exp(css_l) dy_l
         + (size_t)Lp * (NP + 1)        // cs  [Lp][NP + 1]
         + 2 * (size_t)Lp;              // dts, css
}

// Thread (tr, tc) = (tid / 16, tid % 16) takes dS[p][n] at p = tr + 16 i,
// n = tc + 16 j, then the inter term of dC at rows l = tr + 16 r and the
// same n.  s_in is read from global memory (its 32 KB stay in L1), so that
// the block's shared memory (100 KB at L 128, P 64, N 128) lets two blocks
// share an SM, one staging its chunk while the other computes.
template <int PP, int NP>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dstate(const Params p) {
  constexpr int LDY = PP + 1, LDC = NP + 1, PI = PP / 16, NJ = NP / 16;
  const int c = blockIdx.x, bb = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int g = h / (p.H / p.G);
  const int Lp = p.Lp, t0 = c * p.L, nv = min(p.L, p.T - t0);
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;

  extern __shared__ float smem[];
  float* dys = smem;
  float* cs = dys + Lp * LDY;
  float* dts = cs + Lp * LDC;
  float* css = dts + Lp;

  stage(dys, LDY, p.dy + bb * p.dy_sb + t0 * p.dy_st + h * p.dy_sh, p.dy_st,
        p.dy_sp, nv, p.P, PP, Lp, 0);
  stage(cs, LDC, static_cast<const char*>(p.c) +
                     (bb * p.c_sb + t0 * p.c_st + g * p.c_sg) *
                         (p.in_bf16 ? 2 : 4),
        p.c_st, p.c_sn, nv, p.N, NP, Lp, p.in_bf16);
  const long long ci = chunk_index(p, bb, c, h);
  const long long PN = (long long)p.P * p.N;
  const float* S_in = p.states + ci * PN;
  chunk_dt(p, bb, h, t0, nv, dts, css);
  __syncthreads();
  for (int i = threadIdx.x; i < Lp * PP; i += kThreads) {
    const int l = i / PP, pp = i % PP;
    dys[l * LDY + pp] *= expf(css[l]);
  }
  __syncthreads();

  // dS = sum_l (exp(css_l) dy_l) C_l^T
  {
    float acc[PI][NJ] = {};
    for (int l = 0; l < nv; ++l) {
      float dv[PI], cv[NJ];
#pragma unroll
      for (int i = 0; i < PI; ++i) dv[i] = dys[l * LDY + tr + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) cv[j] = cs[l * LDC + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < PI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dv[i], cv[j], acc[i][j]);
    }
    float* dS = p.dsc + ci * PN;
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int pp = tr + 16 * i, n = tc + 16 * j;
        if (pp < p.P && n < p.N) dS[pp * p.N + n] = acc[i][j];
      }
  }
  if (threadIdx.x == 0) p.segs[ci] = css[Lp - 1];   // padded rows add 0

  // dC's inter term, exp(css_l) s_in^T dy_l, at rows l = tr + 16 r (all of
  // the thread's rows at once, so that each s_in value loaded serves
  // them all), and its dcss share C_l . it
  float* DC = p.dch + ((long long)bb * p.T * p.H + h) * p.N;
  const long long dc_st = (long long)p.H * p.N;
  const int nr = Lp / 16;
  float acc[kRows][NJ] = {};
  for (int pp = 0; pp < p.P; ++pp) {
    float sv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tc + 16 * j;
      sv[j] = n < p.N ? __ldg(S_in + pp * p.N + n) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nr) continue;
      const float dv = dys[(tr + 16 * r) * LDY + pp];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] = fmaf(dv, sv[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= nr) continue;
    const int l = tr + 16 * r;
    float share = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tc + 16 * j;
      share = fmaf(cs[l * LDC + n], acc[r][j], share);
      if (l < nv && n < p.N) DC[(t0 + l) * dc_st + n] = acc[r][j];
    }
    share = half_warp_sum(share);
    if (tc == 0) p.dcss[ci * Lp + l] = share;
  }
}

// ---- b. the state gradient, passed backwards over the chunks ---------------

constexpr int kPassThreads = 256;
constexpr int kPassDepth = 8;

__device__ __forceinline__ float4 fma4(float4 s, float d, float4 v) {
  return make_float4(fmaf(s.x, d, v.x), fmaf(s.y, d, v.y), fmaf(s.z, d, v.z),
                     fmaf(s.w, d, v.w));
}

// ds <- exp(seg_c) ds + dS_c from the last chunk to the first, four state
// elements a thread; dS_c is replaced by ds_c, the gradient of the state
// leaving chunk c.  kPassDepth chunks' loads are issued before their use.
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_state_passing(const Params p) {
  const int PN4 = p.P * p.N / 4;
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= PN4) return;
  const int bh = blockIdx.y, bb = bh / p.H, h = bh % p.H, nc = p.n_chunks;
  const long long step = (long long)p.H * PN4;
  float4* ds = reinterpret_cast<float4*>(p.dsc) +
               ((long long)bb * nc * p.H + h) * PN4 + e;
  const float* segs = p.segs + (long long)bb * nc * p.H + h;
  float4 s = p.dstate
                 ? reinterpret_cast<const float4*>(p.dstate)[(long long)bh * PN4 + e]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = nc - 1; c0 >= 0; c0 -= kPassDepth) {
    float4 v[kPassDepth];
    float d[kPassDepth];
#pragma unroll
    for (int i = 0; i < kPassDepth; ++i)
      if (c0 - i >= 0) {
        v[i] = ds[(c0 - i) * step];
        d[i] = expf(segs[(c0 - i) * p.H]);
      }
#pragma unroll
    for (int i = 0; i < kPassDepth; ++i)
      if (c0 - i >= 0) {
        ds[(c0 - i) * step] = s;
        s = fma4(s, d[i], v[i]);
      }
  }
  if (p.dstate0)
    reinterpret_cast<float4*>(p.dstate0)[(long long)bh * PN4 + e] = s;
}

// ---- c. the rest of the chunk -----------------------------------------------

// The strip's entries (l, m) at its rows l = l0 + 2 w2 + {0, 1} (w2 the
// warp) and the columns m = lane + 32 q, q < NQ: C_l . B_m and dy_l . x_m,
// then A1 = CB E dt_m, A2 = (dy_l . x_m) E dt_m and Z = CB (dy_l . x_m) E
// where m <= l (0 above the diagonal) into the strip buffers, for m below
// ``mcols``.  Each B (or x) value loaded serves both rows.
template <int NQ>
__device__ __forceinline__ void form_strip(
    const float* cs, const float* bs, const float* dys, const float* xs,
    const float* css, const float* dts, float* a1s, float* a2s, float* zs,
    int LDN, int LDP, int LDS, int N, int P, int Lp, int l0, int mcols,
    int w2, int lane) {
  const int r0 = 2 * w2;
  const float* c0 = cs + (l0 + r0) * LDN;
  const float* d0 = dys + (l0 + r0) * LDP;
  int mrow[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) mrow[q] = min(lane + 32 * q, Lp - 1);
  float s1[2][NQ] = {}, s2[2][NQ] = {};
  for (int n = 0; n < N; ++n) {
    const float ca = c0[n], cb = c0[LDN + n];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float bv = bs[mrow[q] * LDN + n];
      s1[0][q] = fmaf(ca, bv, s1[0][q]);
      s1[1][q] = fmaf(cb, bv, s1[1][q]);
    }
  }
  for (int pp = 0; pp < P; ++pp) {
    const float da = d0[pp], db = d0[LDP + pp];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float xv = xs[mrow[q] * LDP + pp];
      s2[0][q] = fmaf(da, xv, s2[0][q]);
      s2[1][q] = fmaf(db, xv, s2[1][q]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int lr = r0 + rr, l = l0 + lr;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int m = lane + 32 * q;
      if (m >= mcols) continue;
      float a1 = 0.f, a2 = 0.f, z = 0.f;
      if (m <= l) {
        const float e = expf(css[l] - css[m]), md = e * dts[m];
        a1 = s1[rr][q] * md;
        a2 = s2[rr][q] * md;
        z = s1[rr][q] * s2[rr][q] * e;
      }
      a1s[lr * LDS + m] = a1;
      a2s[lr * LDS + m] = a2;
      zs[lr * LDS + m] = z;
    }
  }
}

template <int PP, int NP>
__host__ __device__ size_t chunk_smem_floats(int Lp) {
  const size_t x = (size_t)Lp * (PP + 1);
  const size_t dy = (size_t)Lp * (PP + 1) > (size_t)PP * (NP + 1)
                        ? (size_t)Lp * (PP + 1) : (size_t)PP * (NP + 1);
  return x + dy                          // xs, dys (then ds) [.][PP + 1]
         + 2 * (size_t)Lp * (NP + 1)     // bs, cs [Lp][NP + 1]
         + 3 * (size_t)kTile * (Lp + 1)  // a1s, a2s, zs [16][Lp + 1]
         + 7 * (size_t)Lp                // dts, css, w, colz, rowq, vv, dcssi
         + kThreads;                     // a block's partial sums
}

// Thread (tr, tc) = (tid / 16, tid % 16) keeps dx[m][p] and dB[m][n] at
// m = tr + 16 r, p (or n) = tc + 16 j in registers across the strips, and
// takes Z's row sums of strip row tr.  In the strip's forming and its dC
// rows, warp w2 takes the rows 2 w2 and 2 w2 + 1, lane ``lane`` the
// columns lane + 32 q.
template <int PP, int NP>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk(const Params p) {
  constexpr int LDP = PP + 1, LDN = NP + 1, PJ = PP / 16, NJ = NP / 16;
  const int c = blockIdx.x, bb = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int g = h / (p.H / p.G);
  const int Lp = p.Lp, LDS = Lp + 1, t0 = c * p.L, nv = min(p.L, p.T - t0);
  const int nt = Lp / kTile;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int w2 = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int esz = p.in_bf16 ? 2 : 4;

  extern __shared__ float smem[];
  float* xs = smem;
  float* dys = xs + Lp * LDP;
  float* bs = dys + (Lp * LDP > PP * LDN ? Lp * LDP : PP * LDN);
  float* cs = bs + Lp * LDN;
  float* a1s = cs + Lp * LDN;
  float* a2s = a1s + kTile * LDS;
  float* zs = a2s + kTile * LDS;
  float* dts = zs + kTile * LDS;
  float* css = dts + Lp;
  float* w = css + Lp;
  float* colz = w + Lp;
  float* rowq = colz + Lp;
  float* vv = rowq + Lp;
  float* dcssi = vv + Lp;
  float* red = dcssi + Lp;

  stage(xs, LDP, static_cast<const char*>(p.x) +
                     (bb * p.x_sb + t0 * p.x_st + h * p.x_sh) * esz,
        p.x_st, p.x_sp, nv, p.P, PP, Lp, p.in_bf16);
  stage(dys, LDP, p.dy + bb * p.dy_sb + t0 * p.dy_st + h * p.dy_sh, p.dy_st,
        p.dy_sp, nv, p.P, PP, Lp, 0);
  stage(bs, LDN, static_cast<const char*>(p.b) +
                     (bb * p.b_sb + t0 * p.b_st + g * p.b_sg) * esz,
        p.b_st, p.b_sn, nv, p.N, NP, Lp, p.in_bf16);
  stage(cs, LDN, static_cast<const char*>(p.c) +
                     (bb * p.c_sb + t0 * p.c_st + g * p.c_sg) * esz,
        p.c_st, p.c_sn, nv, p.N, NP, Lp, p.in_bf16);
  const long long ci = chunk_index(p, bb, c, h);
  for (int l = threadIdx.x; l < Lp; l += kThreads) {
    colz[l] = 0.f;
    dcssi[l] = p.dcss[ci * Lp + l];
  }
  chunk_dt(p, bb, h, t0, nv, dts, css);
  __syncthreads();
  const float seg = css[Lp - 1];
  for (int l = threadIdx.x; l < Lp; l += kThreads) w[l] = expf(seg - css[l]);

  float dx[kRows][PJ] = {}, db[kRows][NJ] = {};
  float* DC = p.dch + ((long long)bb * p.T * p.H + h) * p.N;
  const long long hn_st = (long long)p.H * p.N;

  for (int i = 0; i < nt; ++i) {
    const int l0 = i * kTile, lg = l0 + tr;
    const int mcols = l0 + kTile;           // the columns m <= the strip's rows
    // -- form the strip's entries, in groups of 32 columns
    switch ((mcols + 31) / 32) {
      case 1:
        form_strip<1>(cs, bs, dys, xs, css, dts, a1s, a2s, zs, LDN, LDP, LDS,
                      p.N, p.P, Lp, l0, mcols, w2, lane);
        break;
      case 2:
        form_strip<2>(cs, bs, dys, xs, css, dts, a1s, a2s, zs, LDN, LDP, LDS,
                      p.N, p.P, Lp, l0, mcols, w2, lane);
        break;
      case 3:
        form_strip<3>(cs, bs, dys, xs, css, dts, a1s, a2s, zs, LDN, LDP, LDS,
                      p.N, p.P, Lp, l0, mcols, w2, lane);
        break;
      default:
        form_strip<4>(cs, bs, dys, xs, css, dts, a1s, a2s, zs, LDN, LDP, LDS,
                      p.N, p.P, Lp, l0, mcols, w2, lane);
    }
    __syncthreads();

    // -- dx += A1^T dy and dB += A2^T C over the strip's rows
    const int lend = min(kTile, nv - l0);
    for (int ll = 0; ll < lend; ++ll) {
      const int l = l0 + ll;
      float dv[PJ], cv[NJ];
#pragma unroll
      for (int j = 0; j < PJ; ++j) dv[j] = dys[l * LDP + tc + 16 * j];
#pragma unroll
      for (int j = 0; j < NJ; ++j) cv[j] = cs[l * LDN + tc + 16 * j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r > i) continue;
        const float a1 = a1s[ll * LDS + tr + 16 * r];
        const float a2 = a2s[ll * LDS + tr + 16 * r];
#pragma unroll
        for (int j = 0; j < PJ; ++j) dx[r][j] = fmaf(a1, dv[j], dx[r][j]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) db[r][j] = fmaf(a2, cv[j], db[r][j]);
      }
    }

    // -- the strip's rows of dC (warp w2: rows 2 w2, 2 w2 + 1; columns
    // n = lane + 32 j): the inter term (from a) + A2 B
    {
      constexpr int NJ2 = (NP + 31) / 32;
      const int r0 = 2 * w2;
      float acc[2][NJ2] = {};
      for (int m = 0; m < mcols; ++m) {
        const float a0 = a2s[r0 * LDS + m], a1 = a2s[(r0 + 1) * LDS + m];
#pragma unroll
        for (int j = 0; j < NJ2; ++j) {
          const float bv = bs[m * LDN + lane + 32 * j];
          acc[0][j] = fmaf(a0, bv, acc[0][j]);
          acc[1][j] = fmaf(a1, bv, acc[1][j]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int l = l0 + r0 + rr;
        if (l >= nv) continue;
#pragma unroll
        for (int j = 0; j < NJ2; ++j) {
          const int n = lane + 32 * j;
          if (n < p.N) {
            float* dst = DC + (t0 + l) * hn_st + n;
            *dst = *dst + acc[rr][j];
          }
        }
      }
    }

    // -- Z's row sums (times dt_m) and column sums
    {
      float q = 0.f;
      for (int m = tc; m < mcols; m += 16) q = fmaf(zs[tr * LDS + m], dts[m], q);
      q = half_warp_sum(q);
      if (tc == 0) rowq[lg] = q;
      if (threadIdx.x < mcols) {
        const int m = threadIdx.x;
        float s = colz[m];
        for (int ll = 0; ll < kTile; ++ll) s += zs[ll * LDS + m];
        colz[m] = s;
      }
    }
    __syncthreads();
  }

  // -- the inter-chunk terms from ds, staged where dy was
  const long long PN = (long long)p.P * p.N;
  const float* DS = p.dsc + ci * PN;
  float* dsm = dys;
  for (int e = threadIdx.x; e < PP * NP; e += kThreads) {
    const int pp = e / NP, n = e % NP;
    dsm[pp * LDN + n] = (pp < p.P && n < p.N) ? DS[pp * p.N + n] : 0.f;
  }
  __syncthreads();
  {   // <ds, s_in>: the block's partials, summed in a fixed tree below
    const float* S_in = p.states + ci * PN;
    float s = 0.f;
    for (int e = threadIdx.x; e < PN; e += kThreads)
      s = fmaf(DS[e], S_in[e], s);
    red[threadIdx.x] = s;
  }
  float* DX = p.dx + ((long long)bb * p.T * p.H + h) * p.P;
  float* DB = p.dbh + ((long long)bb * p.T * p.H + h) * p.N;
  const long long hp_st = (long long)p.H * p.P;
  // u = ds B_m at the thread's rows m = tr + 16 r and p = tc + 16 j, all
  // rows at once (each ds value loaded serves them all); then
  // dx += w dt u and v_m = w_m x_m . u
  float u[kRows][PJ] = {}, wdt[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    wdt[r] = r < nt ? w[tr + 16 * r] * dts[tr + 16 * r] : 0.f;
  for (int n = 0; n < p.N; ++n) {
    float dv[PJ];
#pragma unroll
    for (int j = 0; j < PJ; ++j) dv[j] = dsm[(tc + 16 * j) * LDN + n];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nt) continue;
      const float bv = bs[(tr + 16 * r) * LDN + n];
#pragma unroll
      for (int j = 0; j < PJ; ++j) u[r][j] = fmaf(bv, dv[j], u[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= nt) continue;
    const int m = tr + 16 * r;
    float xu = 0.f;
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      dx[r][j] = fmaf(wdt[r], u[r][j], dx[r][j]);
      xu = fmaf(xs[m * LDP + tc + 16 * j], u[r][j], xu);
    }
    xu = half_warp_sum(xu);
    if (tc == 0) vv[m] = w[m] * xu;
  }
  // dB += w dt ds^T x_m at n = tc + 16 j, as sum_p (w_m dt_m x_mp) ds_pn
  for (int pp = 0; pp < p.P; ++pp) {
    float dv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) dv[j] = dsm[pp * LDN + tc + 16 * j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nt) continue;
      const float xw = wdt[r] * xs[(tr + 16 * r) * LDP + pp];
#pragma unroll
      for (int j = 0; j < NJ; ++j) db[r][j] = fmaf(xw, dv[j], db[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= nt) continue;
    const int m = tr + 16 * r;
    if (m < nv) {
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int pp = tc + 16 * j;
        if (pp < p.P) DX[(t0 + m) * hp_st + pp] = dx[r][j];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tc + 16 * j;
        if (n < p.N) DB[(t0 + m) * hn_st + n] = db[r][j];
      }
    }
  }
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }

  // -- one warp: dcss, its reverse cumsum dda, ddt and the chunk's da share
  if (threadIdx.x >= 32) return;
  const int K = (Lp + 31) / 32;   // warp 0: lane == threadIdx.x
  float rv = 0.f;                       // sum_m dt_m v_m
  for (int k = 0; k < K; ++k) {
    const int m = lane * K + k;
    if (m < Lp) rv = fmaf(dts[m], vv[m], rv);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) rv += __shfl_xor_sync(0xffffffffu, rv, off);
  const float extra = rv + expf(seg) * red[0];
  float d[4];
  float run = 0.f;                      // the lane's rows, last to first
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    const int l = lane * K + k;
    if (k < K && l < Lp)
      run += dcssi[l] + rowq[l] - dts[l] * (colz[l] + vv[l]);
    d[k] = run;
  }
  float incl = run;                     // suffix sums over the lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float dn = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += dn;
  }
  const float after = incl - run + extra;   // the lanes above, and the last row's
  const float a = p.a[h];
  float* DDT = p.ddt + (long long)bb * p.T * p.H + h;
  float dap = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int m = lane * K + k;
    if (k < K && m < Lp) {
      const float dda = after + d[k];
      dap = fmaf(dts[m], dda, dap);
      if (m < nv) DDT[(t0 + m) * (long long)p.H] = colz[m] + vv[m] + a * dda;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dap += __shfl_xor_sync(0xffffffffu, dap, off);
  if (lane == 0) p.da_part[ci] = dap;
}

// ---- d. dB and dC over the heads of a group; e. da over (b, chunk) --------

__global__ void __launch_bounds__(kThreads)
ssd_bwd_group_sum(const Params p) {
  const long long total = (long long)p.B * p.T * p.G * p.N;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const float* part = blockIdx.y ? p.dch : p.dbh;
  float* out = blockIdx.y ? p.dc : p.db;
  const int rep = p.H / p.G;
  const int n = (int)(e % p.N);
  const long long btg = e / p.N;
  const int g = (int)(btg % p.G);
  const long long bt = btg / p.G;
  const float* src = part + (bt * p.H + (long long)g * rep) * p.N + n;
  float s = 0.f;
  for (int j = 0; j < rep; ++j) s += src[(long long)j * p.N];
  out[e] = s;
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_da_sum(const Params p) {
  __shared__ float red[kThreads];
  const int h = blockIdx.x, count = p.B * p.n_chunks;
  float s = 0.f;
  for (int i = threadIdx.x; i < count; i += kThreads)
    s += p.da_part[(long long)i * p.H + h];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int k = kThreads / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) red[threadIdx.x] += red[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) p.da[h] = red[0];
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int PP, int NP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t e;
  const dim3 grid(p.n_chunks, p.B * p.H);
  const size_t a_smem = dstate_smem_floats<PP, NP>(p.Lp) * sizeof(float);
  if ((e = allow_smem(ssd_bwd_dstate<PP, NP>, a_smem)) != cudaSuccess) return e;
  ssd_bwd_dstate<PP, NP><<<grid, kThreads, a_smem, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int tiles = (p.P * p.N / 4 + kPassThreads - 1) / kPassThreads;
  ssd_bwd_state_passing<<<dim3(tiles, p.B * p.H), kPassThreads, 0, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t c_smem = chunk_smem_floats<PP, NP>(p.Lp) * sizeof(float);
  if ((e = allow_smem(ssd_bwd_chunk<PP, NP>, c_smem)) != cudaSuccess) return e;
  ssd_bwd_chunk<PP, NP><<<grid, kThreads, c_smem, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const long long total = (long long)p.B * p.T * p.G * p.N;
  ssd_bwd_group_sum<<<dim3((unsigned)((total + kThreads - 1) / kThreads), 2),
                      kThreads, 0, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  ssd_bwd_da_sum<<<p.H, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int PP>
cudaError_t launch_n(const Params& p, cudaStream_t stream) {
  if (p.N <= 16) return launch<PP, 16>(p, stream);
  if (p.N == 64) return launch<PP, 64>(p, stream);
  return launch<PP, 128>(p, stream);
}

}  // namespace

extern "C" {

// Shared memory (bytes) of the chunk kernel (c) at head dim P, state dim N
// and Lp rows, so that a test can hold the layout to the card's limit.
long long ssd_bwd_chunk_smem(int P, int N, int Lp) {
  const int n = N <= 16 ? 16 : N;
  size_t f = 0;
  if (P <= 16)
    f = n == 16 ? chunk_smem_floats<16, 16>(Lp)
        : n == 64 ? chunk_smem_floats<16, 64>(Lp) : chunk_smem_floats<16, 128>(Lp);
  else
    f = n == 16 ? chunk_smem_floats<64, 16>(Lp)
        : n == 64 ? chunk_smem_floats<64, 64>(Lp) : chunk_smem_floats<64, 128>(Lp);
  return (long long)(f * sizeof(float));
}

// in_bf16: x, B_ and C_ are bfloat16 (else float32); dy, dt, a, dstate and
// states are float32.  L, Lp (L rounded up to 16) and n_chunks are the
// caller's plan (../kernel.py, ``bwd_plan``), checked, not recomputed.
// strides: 19 element strides, x (b, t, h, p), dt (b, t, h), B_ and C_
// (b, t, g, n), dy (b, t, h, p).  dstate and dstate0 may be null; dstate,
// states and dstate0 are contiguous and on 16 bytes.  Outputs, contiguous
// fp32: dx (B, T, H, P), ddt (B, T, H), da (H,), dB and dC (B, T, G, N).
// Scratch from the caller, fp32: dbh and dch of B * T * H * N, dsc of
// B * chunks * H * P * N, segs and da_part of B * chunks * H, dcss of
// B * chunks * H * Lp.  Returns a cudaError_t (0 on success).
int ssd_bwd(const void* x, const float* dt, const float* a, const void* b,
            const void* c, const float* dy, const float* dstate,
            const float* states, float* dx, float* ddt, float* da, float* db,
            float* dc, float* dstate0, float* dbh, float* dch, float* dsc,
            float* segs, float* dcss, float* da_part, int in_bf16, int B,
            int T, int H, int G, int P, int N, int L, int Lp, int n_chunks,
            const long long* strides, void* stream) {
  if (B < 1 || T < 1 || H < 1 || G < 1 || H % G || L < 1 || L > kMaxL ||
      (P != 8 && P != 16 && P != 64) ||
      (N != 8 && N != 16 && N != 64 && N != 128) || Lp < L ||
      Lp >= L + kTile || Lp % kTile || Lp > kMaxL ||
      (long long)(n_chunks - 1) * L >= T || (long long)n_chunks * L < T ||
      !states || !dx || !ddt || !da || !db || !dc || !dbh || !dch || !dsc ||
      !segs || !dcss || !da_part)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.dt = dt; p.a = a; p.b = b; p.c = c; p.dy = dy;
  p.dstate = dstate; p.states = states;
  p.dx = dx; p.ddt = ddt; p.dstate0 = dstate0; p.dbh = dbh; p.dch = dch;
  p.db = db; p.dc = dc; p.da = da;
  p.dsc = dsc; p.segs = segs; p.dcss = dcss; p.da_part = da_part;
  p.x_sb = strides[0]; p.x_st = strides[1]; p.x_sh = strides[2];
  p.x_sp = strides[3];
  p.dt_sb = strides[4]; p.dt_st = strides[5]; p.dt_sh = strides[6];
  p.b_sb = strides[7]; p.b_st = strides[8]; p.b_sg = strides[9];
  p.b_sn = strides[10];
  p.c_sb = strides[11]; p.c_st = strides[12]; p.c_sg = strides[13];
  p.c_sn = strides[14];
  p.dy_sb = strides[15]; p.dy_st = strides[16]; p.dy_sh = strides[17];
  p.dy_sp = strides[18];
  p.B = B; p.T = T; p.H = H; p.G = G; p.P = P; p.N = N; p.L = L;
  p.Lp = Lp; p.n_chunks = n_chunks; p.in_bf16 = in_bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(P == 64 ? launch_n<64>(p, st) : launch_n<16>(p, st));
}

const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
