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
// Two paths; the wrapper (../kernel.py, ``bwd_plan``) picks one by dtype and
// passes it in.  No atomics on either: every sum runs in an order fixed by
// the shapes, so a rerun equals the first bit for bit.  Rows past T read as
// x = B = C = dy = 0 and dt = 0, the forward's padding, and nothing is
// written for them.  The launcher allocates nothing: outputs and scratch
// come from the wrapper, so a call can be captured in a CUDA graph.
//
// 1. bfloat16 x/B/C: ``mma``, seven launches on the caller's stream.  A
//    block of the three chunk-level kernels takes one chunk and a slice of
//    a group's heads (``bwd_slices``: S slices of H / (G S) heads, the
//    fewest that give 256 blocks, two waves; 32 heads a block at mamba2's
//    training shape), loops over its heads in head order, and fetches the
//    next head's inputs by cp.async while this one computes.  Products are
//    mma.sync.m16n8k16 bf16 x bf16 -> fp32 with ldmatrix (the building
//    blocks of ssd_fwd.cu; wgmma's 64-row tiles fit the L x L triangle
//    badly).  C B^T takes the bf16 inputs as they come, exact in its
//    products; every fp32 operand (exp(css) dy, dy, s_in, ds, A1 and the A2
//    sum) is split into kTerms = 3 bf16 terms (hi = bf16(v), then bf16 of
//    what is left), split once as it is staged (A1 and the A2 sum in
//    registers); a product of two fp32 operands (ey s_in, A1^T dy) takes
//    the term pairs (i, j) with i + j < 3.  tests/test_torch_ssd.py
//    emulates this arithmetic: with three terms every gradient is within
//    1.4e-6 of its max against jax.vjp of ssd_chunked at mamba2's and
//    zamba2's widths; with one it misses 1e-5 by ~100x.
//      a. ``ssd_bwd_dstate_mma``, grid (chunks, B G S): C once; per head
//         ey = exp(css_l) dy_l and s_in in terms; dS = ey^T C (into the ds
//         scratch, then passed backwards by b), dC's inter term ey s_in
//         with its dcss share, summed over the block's heads in registers:
//         the first value of the slice's dC partial;
//      b. ``ssd_bwd_state_passing``, as on path 2;
//      c1. ``ssd_bwd_inter``: B once; per head x and ds in terms: u = B_m
//         ds^T (dx's first value w_m dt_m u, v_m = w_m x_m . u), x ds
//         times w_m dt_m summed over the heads in registers (the first
//         value of the slice's dB partial), <ds, s_in>;
//      c2. ``ssd_bwd_chunk_mma``: C B^T once (fp32, in shared memory);
//         per head dy in terms; over the 16 x 16 tiles (m, l) of the lower
//         triangle, dyx^T = x dy^T, A1^T, A2^T and Z^T in registers, dx +=
//         A1^T dy, the A2 sum over the heads (in shared memory), Z's
//         column and row sums; after the heads dB += A2^T C and dC += A2 B
//         once for the block, so that no per-head dB or dC is formed;
//      c3. ``ssd_bwd_dda``, one warp a (b, chunk, head): dcss, its
//         reverse cumsum dda, ddt and the chunk's da share;
//      d. ``ssd_bwd_group_sum``: the S slice partials of dB and dC in
//         slice order (B T G S N floats each, 16.8 MB at mamba2's shape);
//      e. ``ssd_bwd_da_sum``.
//    Shared memory at L 128, P 64, N 128 (``ssd_bwd_smem``): a 212,480
//    bytes, c1 194,560, c2 210,944, one block an SM each (2 x 8 warps would
//    need < 113 KB a block: C or B, the split terms of this head and the
//    fp32 copies of the next one's do not fit in it).  Bound at mamba2's
//    training shape (B 4, T 4,096, H 64, P 64, N 128, L 128): the bytes the
//    gradient needs (~0.70 GB: x, B, C, dt and dy read, dx, ddt, dB and dC
//    written, once each) over the HBM rate, 0.21 ms; the operations,
//    ~0.12 TFLOP over the triangle, take 0.12 ms at the bf16 peak.  What
//    holds it back (PERF.md): mma.sync from 8 warps an SM, each warp
//    loading its fragments from shared memory (the split terms triple the
//    B operands), and the per-head barriers; c2's pair of warps for an
//    m-tile forms its dyx^T twice (each keeps half of dx); and the bytes
//    of the design, ~3.4 GB a call at that shape (dx written twice, the
//    chunk states read twice, the ds scratch moved four times), ~1 ms at
//    the HBM rate.
// 2. float32 x/B/C: ``cuda_core``, the first design, five launches, every
//    product fp32 on the CUDA cores (a product of two fp32 operands on the
//    tensor cores would cost more terms than float32, the type of the
//    parity checks, is worth):
//      a. ``ssd_bwd_dstate``, grid (chunks, B * H): the chunk's dy terms:
//         dS = sum_l exp(css_l) dy_l C_l^T (P x N, into the ds scratch), the
//         inter-chunk term of dC, exp(css_l) s_in^T dy_l (into the per-head
//         dC partials, as their first value) with its dcss share C_l . that
//         (into a (B, chunks, H, Lp) scratch), and seg;
//      b. ``ssd_bwd_state_passing``, grid (tiles of P * N, B * H): the only
//         sequential part, elementwise over P * N, the forward's state
//         passing run backwards: ds_prev = exp(seg_c) ds_c + dS_c from
//         dstate (or zeros), ds_c replacing dS_c in place; dstate0 is
//         written;
//      c. ``ssd_bwd_chunk``, grid (chunks, B * H): the rest of the chunk,
//         x, dy, B and C staged in fp32 (228,032 bytes at L 128, P 64,
//         N 128), the L x L triangle in strips of 16 rows, then the terms
//         from ds and one warp's reverse scan of dcss;
//      d. ``ssd_bwd_group_sum``: dB and dC summed over the heads of a
//         group, in head order;
//      e. ``ssd_bwd_da_sum``, grid H: da summed over (b, chunk) in a fixed
//         tree.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd_bwd.so ssd_bwd.cu
// Bound with ctypes (see ../kernel.py).  The launcher launches on the
// stream it is given and returns the first cudaError_t.

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
  float* dcss;                     // scratch (B, chunks, H, Lp): dC's dcss
                                   // share (mma: a half each, 2 Lp)
  float* da_part;                  // scratch (B, chunks, H)
  long long x_sb, x_st, x_sh, x_sp;   // element strides
  long long dt_sb, dt_st, dt_sh;
  long long b_sb, b_st, b_sg, b_sn;
  long long c_sb, c_st, c_sg, c_sn;
  long long dy_sb, dy_st, dy_sh, dy_sp;
  int B, T, H, G, P, N, L, Lp, n_chunks, in_bf16;
  // the dB, dC partials are (B, T, G * S, N): on the mma path S slices of
  // a group's heads, a block each; on the CUDA-core path S = H / G, one a
  // head.  v and <ds, s_in> of each (b, chunk, head) pass from the inter
  // kernel, Z's sums from the chunk kernel, to the scan.
  int S;
  float* vv;                       // scratch (B, chunks, H, 2, Lp): halves
  float* dsin;                     // scratch (B, chunks, H)
  float* colz;                     // scratch (B, chunks, H, Lp): Z's column
  float* rowq;                     // and row sums, chunk kernel to scan
  int x_vec, b_vec, c_vec, dy_vec; // 16-byte copies allowed
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

// The inclusive cumsum of dt * a over Lp <= 128 rows by one warp (K rows a
// lane, then a shuffle scan of the lanes' totals), as ssd_fwd.cu forms it.
__device__ __forceinline__ void warp_cumsum(const float* dts, float a,
                                            float* css, int Lp, int lane) {
  const int K = (Lp + 31) / 32;
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

// The chunk's dt (rows past nv as 0) and, by warp 0, its cumsum.  The
// caller synchronises.
__device__ __forceinline__ void chunk_dt(const Params& p, int bb, int h,
                                         int t0, int nv, float* dts,
                                         float* css) {
  const float* DT = p.dt + bb * p.dt_sb + h * p.dt_sh + t0 * p.dt_st;
  for (int l = threadIdx.x; l < p.Lp; l += kThreads)
    dts[l] = l < nv ? DT[l * p.dt_st] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) warp_cumsum(dts, p.a[h], css, p.Lp, threadIdx.x);
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

// ---- d. dB and dC over the partials of a group; e. da over (b, chunk) ----

__global__ void __launch_bounds__(kThreads)
ssd_bwd_group_sum(const Params p) {
  const long long total = (long long)p.B * p.T * p.G * p.N;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const float* part = blockIdx.y ? p.dch : p.dbh;
  float* out = blockIdx.y ? p.dc : p.db;
  const int rep = p.S;             // partials a group, summed in their order
  const int n = (int)(e % p.N);
  const long long btg = e / p.N;
  const int g = (int)(btg % p.G);
  const long long bt = btg / p.G;
  const float* src =
      part + (bt * p.G * rep + (long long)g * rep) * p.N + n;
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

// ---- the bf16 path ("mma"): the same formulas on the tensor cores ---------
//
// Products are mma.sync.m16n8k16 bf16 x bf16 -> fp32 with ldmatrix, as in
// ssd_fwd.cu.  C B^T takes the bf16 inputs as they are; every fp32 operand
// is split into kTerms bf16 terms (hi = bf16(v), then bf16 of what is
// left), and a product whose two operands are both fp32 takes the term
// pairs (i, j) with i + j < kTerms.

constexpr int kTerms = 3;
constexpr int kMmaWarps = kThreads / 32;

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
// 4 bytes global -> shared (through L1), for strided fp32 rows.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
// Two floats as kTerms bf16 pairs, the lower column in the low half.
__device__ __forceinline__ void split_pair(float v0, float v1,
                                           uint32_t (&t)[kTerms]) {
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    const float2 hf = __bfloat1622float2(h);
    t[k] = as_u32(h);
    v0 -= hf.x;
    v1 -= hf.y;
  }
}
// Four floats (a float4 of a row) as kTerms bf16 terms, into shared memory
// ``term`` elements apart, as 8-byte stores.
__device__ __forceinline__ void split_store4(float4 v, bf16* dst, int term) {
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(dst + k * term) = make_uint2(as_u32(h0), as_u32(h1));
    const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
    v.x -= f0.x;
    v.y -= f0.y;
    v.z -= f1.x;
    v.w -= f1.y;
  }
}
// An accumulator tile (16 x 16: two n8 halves of 4) as the A operand of a
// product, split into kTerms terms (the accumulator's layout is the A
// operand's).
__device__ __forceinline__ void acc_to_a(const float (&v)[2][4],
                                         uint32_t (&a)[kTerms][4]) {
  uint32_t t[kTerms];
  split_pair(v[0][0], v[0][1], t);
#pragma unroll
  for (int k = 0; k < kTerms; ++k) a[k][0] = t[k];
  split_pair(v[0][2], v[0][3], t);
#pragma unroll
  for (int k = 0; k < kTerms; ++k) a[k][1] = t[k];
  split_pair(v[1][0], v[1][1], t);
#pragma unroll
  for (int k = 0; k < kTerms; ++k) a[k][2] = t[k];
  split_pair(v[1][2], v[1][3], t);
#pragma unroll
  for (int k = 0; k < kTerms; ++k) a[k][3] = t[k];
}

// Row pitch (elements) of a bf16 shared-memory tile of W columns: the row
// plus 16 bytes, so that ldmatrix's eight row reads fall in distinct banks.
__host__ __device__ constexpr int pitch16(int W) { return W + 8; }

// The chunk's rows [0, Lp) x columns [0, WP) of a bf16 (rows, W) view into
// shared memory of row pitch ``ld``; rows >= nv and columns >= W read as 0.
// Sixteen-byte cp.async copies where ``vec`` allows (the caller commits,
// waits and synchronises), element by element otherwise.
template <int WP>
__device__ __forceinline__ void load_bf16(bf16* dst, int ld, const bf16* src,
                                          long long rs, long long cs, int nv,
                                          int W, int Lp, int vec) {
  if (vec) {
    constexpr int CPR = WP / 8;
    for (int i = threadIdx.x; i < Lp * CPR; i += kThreads) {
      const int r = i / CPR, ch = i % CPR;
      const bool in = r < nv && ch * 8 < W;
      cp_async16(dst + r * ld + ch * 8, in ? src + r * rs + ch * 8 : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < Lp * WP; i += kThreads) {
      const int r = i / WP, col = i % WP;
      dst[r * ld + col] = (r < nv && col < W) ? src[r * rs + col * cs]
                                              : __float2bfloat16(0.f);
    }
  }
}

// The same for an fp32 (rows, W) view, row pitch ``ld`` floats.
template <int WP>
__device__ __forceinline__ void load_f32(float* dst, int ld, const float* src,
                                         long long rs, long long cs, int nv,
                                         int W, int Lp, int vec) {
  if (vec) {
    constexpr int CPR = WP / 4;
    for (int i = threadIdx.x; i < Lp * CPR; i += kThreads) {
      const int r = i / CPR, ch = i % CPR;
      const bool in = r < nv && ch * 4 < W;
      cp_async16(dst + r * ld + ch * 4, in ? src + r * rs + ch * 4 : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < Lp * WP; i += kThreads) {
      const int r = i / WP, col = i % WP;
      dst[r * ld + col] = (r < nv && col < W) ? src[r * rs + col * cs] : 0.f;
    }
  }
}

// The block's (b, group, slice) from blockIdx.y, and its first head.
struct Slice {
  int bb, gs, g, h0, hps;
};
__device__ __forceinline__ Slice slice_of(const Params& p) {
  Slice s;
  const int GS = p.G * p.S;
  s.bb = blockIdx.y / GS;
  s.gs = blockIdx.y % GS;
  s.g = s.gs / p.S;
  s.hps = p.H / GS;
  s.h0 = s.g * (p.H / p.G) + (s.gs % p.S) * s.hps;
  return s;
}

// The chunk's dt of head h (rows past nv as 0) by cp.async; the caller
// commits, waits and synchronises.
__device__ __forceinline__ void load_dt(const Params& p, int bb, int h,
                                        int t0, int nv, float* dts) {
  const float* DT = p.dt + bb * p.dt_sb + h * p.dt_sh + t0 * p.dt_st;
  for (int l = threadIdx.x; l < p.Lp; l += kThreads)
    cp_async4(dts + l, l < nv ? DT + l * p.dt_st : DT, l < nv ? 4 : 0);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// ---- a'. the chunk's dy terms, a block for a slice of a group's heads ------

template <int PP, int NP>
__host__ __device__ size_t dstate_mma_smem(int Lp) {
  return ((size_t)Lp * pitch16(NP)                  // C
          + kTerms * (size_t)Lp * pitch16(PP)       // exp(css) dy, in terms
          + kTerms * (size_t)PP * pitch16(NP)) * 2  // s_in, in terms
         + ((size_t)Lp * (PP + 4)                   // the next head's dy,
            + (size_t)PP * (NP + 4)                 // s_in and dt, as they
            + 3 * (size_t)Lp) * 4;                  // come; css, ecs
}

// C is staged once.  Per head, ey = exp(css_l) dy_l and s_in are split into
// terms from the fp32 copies that cp.async fetched while the previous head
// computed (the next head's are fetched while this one computes).  dS =
// ey^T C (M = P, N = N, K = rows) into the ds scratch; dC's inter term
// ey s_in (M = rows: warp w the row tiles 2 (w % 4) and 2 (w % 4) + 1 and
// the half w / 4 of N, K = P), its dcss share C_l . it (a partial each
// half), and its sum over the slice's heads in head order, in registers;
// the sum is the first value of the slice's dC partial.
template <int PP, int NP>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dstate_mma(const Params p) {
  constexpr int LDC = pitch16(NP), LDY = pitch16(PP), LDS = pitch16(NP);
  // dS: warp (wm, wn) the p-tiles wm + WM i (i < MT) and the n16 blocks
  // wn + WN j (j < NT): two of each at N 128
  constexpr int MI = PP / 16, NI = NP / 16, NT = NI >= 8 ? 2 : 1;
  constexpr int WN = NI / NT < kMmaWarps ? NI / NT : kMmaWarps;
  constexpr int WM = kMmaWarps / WN, MT = (MI + WM - 1) / WM;
  constexpr int NB16 = NP / 16, NBW = (NB16 + 1) / 2;  // n16 blocks a half
  constexpr int LDR = PP + 4, LDSR = NP + 4;
  const Slice sl = slice_of(p);
  const int c = blockIdx.x, bb = sl.bb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tig = lane & 3;
  const int wn = warp % WN, wm = warp / WN;
  const int wq = warp & 3, ph = warp >> 2;
  const int nb0 = ph * NBW, nb1 = min(NB16, nb0 + NBW);
  const int Lp = p.Lp, nt = Lp / 16, t0 = c * p.L, nv = min(p.L, p.T - t0);
  const int lt0 = 2 * wq;
  const bool two = lt0 + 1 < nt;

  extern __shared__ __align__(16) unsigned char smem8[];
  bf16* cs = reinterpret_cast<bf16*>(smem8);
  bf16* eys = cs + Lp * LDC;
  bf16* sts = eys + kTerms * Lp * LDY;
  float* dyr = reinterpret_cast<float*>(sts + kTerms * PP * LDS);
  float* sir = dyr + Lp * LDR;
  float* dtn = sir + PP * LDSR;
  float* css = dtn + Lp;
  float* ecs = css + Lp;

  const long long PN = (long long)p.P * p.N;
  auto fetch = [&](int j) {
    const int h = sl.h0 + j;
    load_f32<PP>(dyr, LDR, p.dy + bb * p.dy_sb + t0 * p.dy_st + h * p.dy_sh,
                 p.dy_st, p.dy_sp, nv, p.P, Lp, p.dy_vec);
    load_f32<NP>(sir, LDSR, p.states + chunk_index(p, bb, c, h) * PN, p.N, 1,
                 p.P, p.N, PP, 1);
    load_dt(p, bb, h, t0, nv, dtn);
    cp_async_commit();
  };
  load_bf16<NP>(cs, LDC, static_cast<const bf16*>(p.c) + bb * p.c_sb +
                t0 * p.c_st + sl.g * p.c_sg, p.c_st, p.c_sn, nv, p.N, Lp,
                p.c_vec);
  fetch(0);
  float acc[2][2 * NBW][4] = {};    // dC's inter term over the warp's tiles

  for (int j = 0; j < sl.hps; ++j) {
    const int h = sl.h0 + j;
    const long long ci = chunk_index(p, bb, c, h);
    cp_async_wait_all();
    __syncthreads();
    if (warp == 0) {
      warp_cumsum(dtn, p.a[h], css, Lp, lane);
      __syncwarp();
      for (int l = lane; l < Lp; l += 32) ecs[l] = expf(css[l]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < Lp * PP / 4; i += kThreads) {
      const int l = i / (PP / 4), pp = 4 * (i % (PP / 4));
      const float e = ecs[l];
      float4 v = *reinterpret_cast<const float4*>(dyr + l * LDR + pp);
      v.x *= e;
      v.y *= e;
      v.z *= e;
      v.w *= e;
      split_store4(v, eys + l * LDY + pp, Lp * LDY);
    }
    for (int i = threadIdx.x; i < PP * NP / 4; i += kThreads) {
      const int pp = i / (NP / 4), n = 4 * (i % (NP / 4));
      split_store4(*reinterpret_cast<const float4*>(sir + pp * LDSR + n),
                   sts + pp * LDS + n, PP * LDS);
    }
    __syncthreads();
    if (j + 1 < sl.hps) fetch(j + 1);

    // dS = ey^T C: A = ey^T (ey stored rows x P: ldmatrix.trans), B = C
    {
      float d[MT][NT][2][4] = {};
      for (int kk = 0; kk < nt; ++kk) {
        uint32_t af[MT][kTerms][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (wm + WM * i < MI)
#pragma unroll
            for (int t = 0; t < kTerms; ++t)
              ldmatrix_x4_trans(af[i][t],
                                eys + t * Lp * LDY +
                                    (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * LDY +
                                    (wm + WM * i) * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, cs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDC +
                                    (wn + WN * jn) * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            if (wm + WM * i >= MI) continue;
#pragma unroll
            for (int t = 0; t < kTerms; ++t) {
              mma_bf16(d[i][jn][0], af[i][t], bf[0], bf[1]);
              mma_bf16(d[i][jn][1], af[i][t], bf[2], bf[3]);
            }
          }
        }
      }
      float* dS = p.dsc + ci * PN;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int pp = (wm + WM * i) * 16 + gr + hh * 8;
              const int n = (wn + WN * jn) * 16 + jj * 8 + tig * 2;
              if (wm + WM * i < MI && pp < p.P && n < p.N)
                *reinterpret_cast<float2*>(dS + pp * p.N + n) =
                    make_float2(d[i][jn][jj][2 * hh], d[i][jn][jj][2 * hh + 1]);
            }
    }
    if (threadIdx.x == 0) p.segs[ci] = css[Lp - 1];   // padded rows add 0

    // dC's inter term ey s_in over the warp's row tiles 2 wq, 2 wq + 1 and
    // its half ph of N (each s_in fragment serves both tiles), its dcss
    // share over that half (a partial each half, summed by the scan), and
    // its sum over the heads
    if (lt0 < nt) {
      float tmp[2][2 * NBW][4] = {};
#pragma unroll
      for (int kk = 0; kk < PP / 16; ++kk) {
        uint32_t af[2][kTerms][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (r == 0 || two)
#pragma unroll
            for (int t = 0; t < kTerms; ++t)
              ldmatrix_x4(af[r][t], eys + t * Lp * LDY +
                                        ((lt0 + r) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDY +
                                        kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nl = 0; nl < NBW; ++nl) {
          const int nb = nb0 + nl;
          if (nb >= nb1) continue;
          uint32_t bt[kTerms][4];
#pragma unroll
          for (int t = 0; t < kTerms; ++t)
            ldmatrix_x4_trans(bt[t], sts + t * PP * LDS +
                                         (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                         nb * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (r == 1 && !two) continue;
#pragma unroll
            for (int i = 0; i < kTerms; ++i)
#pragma unroll
              for (int t = 0; t + i < kTerms; ++t) {
                mma_bf16(tmp[r][2 * nl], af[r][i], bt[t][0], bt[t][1]);
                mma_bf16(tmp[r][2 * nl + 1], af[r][i], bt[t][2], bt[t][3]);
              }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r == 1 && !two) continue;
        float share[2] = {0.f, 0.f};
#pragma unroll
        for (int nl = 0; nl < NBW; ++nl) {
          if (nb0 + nl >= nb1) continue;
#pragma unroll
          for (int jn = 0; jn < 2; ++jn)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int row = (lt0 + r) * 16 + gr + (q >> 1) * 8;
              const int n = (nb0 + nl) * 16 + jn * 8 + 2 * tig + (q & 1);
              share[q >> 1] = fmaf(__bfloat162float(cs[row * LDC + n]),
                                   tmp[r][2 * nl + jn][q], share[q >> 1]);
              acc[r][2 * nl + jn][q] += tmp[r][2 * nl + jn][q];
            }
        }
        share[0] = quad_sum(share[0]);
        share[1] = quad_sum(share[1]);
        if (tig == 0) {
          float* dst = p.dcss + (ci * 2 + ph) * Lp + (lt0 + r) * 16 + gr;
          dst[0] = share[0];
          dst[8] = share[1];
        }
      }
    }
  }

  if (lt0 < nt) {
    const long long GS = (long long)p.G * p.S, st = GS * p.N;
    float* DC = p.dch + ((long long)bb * p.T * GS + sl.gs) * p.N;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && !two) continue;
#pragma unroll
      for (int nl = 0; nl < NBW; ++nl) {
        if (nb0 + nl >= nb1) continue;
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = (lt0 + r) * 16 + gr + hh * 8;
            const int n = (nb0 + nl) * 16 + jn * 8 + 2 * tig;
            if (row < nv && n < p.N)
              *reinterpret_cast<float2*>(DC + (t0 + row) * st + n) =
                  make_float2(acc[r][2 * nl + jn][2 * hh],
                              acc[r][2 * nl + jn][2 * hh + 1]);
          }
      }
    }
  }
}

// ---- c1. the terms from ds, a block for a slice of a group's heads ---------

template <int PP, int NP>
__host__ __device__ size_t inter_smem(int Lp) {
  return ((size_t)Lp * pitch16(NP)                  // B
          + 2 * (size_t)Lp * pitch16(PP)            // x, this head's, next's
          + kTerms * (size_t)PP * pitch16(NP)) * 2  // ds, in terms
         + (2 * (size_t)PP * (NP + 4)               // the next head's ds and
            + 4 * (size_t)Lp + kThreads) * 4;       // s_in as they come; dt,
}                                                   // css, w, wdt; red

// B is staged once.  Per head, ds is split into terms from the fp32 copy
// that cp.async fetched, with x, s_in and dt, while the previous head
// computed (the next head's are fetched while this one computes).  Warp w
// takes the rows m of the tiles 2 (w % 4) and 2 (w % 4) + 1 and the half
// w / 4 of P and of N: u = B_m ds^T (M = rows, N = P, K = N), whence dx's
// first value w_m dt_m u and v_m = w_m x_m . u (a partial each half); then
// x ds (K = P) in passes of 32 columns, added times w_m dt_m to dB's inter
// term, which is summed over the slice's heads in head order in registers
// and is the first value of the slice's dB partial.  <ds, s_in> by a fixed
// tree.
template <int PP, int NP>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_inter(const Params p) {
  constexpr int LDB = pitch16(NP), LDX = pitch16(PP), LDS = pitch16(NP);
  constexpr int LDR = NP + 4;
  constexpr int PBW = (PP / 16 + 1) / 2, NBW = (NP / 16 + 1) / 2;  // a half
  const Slice sl = slice_of(p);
  const int c = blockIdx.x, bb = sl.bb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tig = lane & 3;
  const int Lp = p.Lp, nt = Lp / 16, t0 = c * p.L, nv = min(p.L, p.T - t0);

  extern __shared__ __align__(16) unsigned char smem8[];
  bf16* bs = reinterpret_cast<bf16*>(smem8);
  bf16* xb[2] = {bs + Lp * LDB, bs + Lp * LDB + Lp * LDX};
  bf16* dst = xb[1] + Lp * LDX;
  float* dsr = reinterpret_cast<float*>(dst + kTerms * PP * LDS);
  float* sir = dsr + PP * LDR;
  float* dts = sir + PP * LDR;
  float* css = dts + Lp;
  float* w = css + Lp;
  float* wdt = w + Lp;
  float* red = wdt + Lp;

  const long long PN = (long long)p.P * p.N;
  const long long hp_st = (long long)p.H * p.P;
  auto fetch = [&](int j) {
    const int h = sl.h0 + j;
    const long long ci = chunk_index(p, bb, c, h);
    load_bf16<PP>(xb[j & 1], LDX, static_cast<const bf16*>(p.x) + bb * p.x_sb +
                  t0 * p.x_st + h * p.x_sh, p.x_st, p.x_sp, nv, p.P, Lp,
                  p.x_vec);
    load_f32<NP>(dsr, LDR, p.dsc + ci * PN, p.N, 1, p.P, p.N, PP, 1);
    load_f32<NP>(sir, LDR, p.states + ci * PN, p.N, 1, p.P, p.N, PP, 1);
    load_dt(p, bb, h, t0, nv, dts);
    cp_async_commit();
  };
  load_bf16<NP>(bs, LDB, static_cast<const bf16*>(p.b) + bb * p.b_sb +
                t0 * p.b_st + sl.g * p.b_sg, p.b_st, p.b_sn, nv, p.N, Lp,
                p.b_vec);
  fetch(0);
  // the warp's m-tiles 2 wq, 2 wq + 1 (each ds fragment serves both) and
  // its half ph of P (u, dx) and of N (dB)
  const int wq = warp & 3, ph = warp >> 2;
  const int mt0 = 2 * wq;
  const bool two = mt0 + 1 < nt;
  const int pb0 = ph * PBW, pb1 = min(PP / 16, pb0 + PBW);
  const int nb0 = ph * NBW, nb1 = min(NP / 16, nb0 + NBW);
  float db[2][2 * NBW][4] = {};     // dB's inter term over the warp's tiles

  for (int j = 0; j < sl.hps; ++j) {
    const int h = sl.h0 + j;
    const long long ci = chunk_index(p, bb, c, h);
    const bf16* xs = xb[j & 1];
    cp_async_wait_all();
    __syncthreads();
    {   // ds in terms; <ds, s_in>: the block's partials, summed in a fixed
        // tree below
      float s = 0.f;
      for (int i = threadIdx.x; i < PP * NP / 4; i += kThreads) {
        const int pp = i / (NP / 4), n = 4 * (i % (NP / 4));
        const float4 v = *reinterpret_cast<const float4*>(dsr + pp * LDR + n);
        const float4 q = *reinterpret_cast<const float4*>(sir + pp * LDR + n);
        s = fmaf(v.x, q.x, fmaf(v.y, q.y, fmaf(v.z, q.z, fmaf(v.w, q.w, s))));
        split_store4(v, dst + pp * LDS + n, PP * LDS);
      }
      red[threadIdx.x] = s;
    }
    if (warp == 0) warp_cumsum(dts, p.a[h], css, Lp, lane);
    __syncthreads();
    const float seg = css[Lp - 1];
    for (int l = threadIdx.x; l < Lp; l += kThreads) {
      w[l] = expf(seg - css[l]);
      wdt[l] = w[l] * dts[l];
    }
    __syncthreads();
    if (j + 1 < sl.hps) fetch(j + 1);

    if (mt0 < nt) {
      // u = B_m ds^T: A = B rows, B operand = ds (P x N, n-major rows)
      float u[2][2 * PBW][4] = {};
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        uint32_t ba[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (r == 0 || two)
            ldmatrix_x4(ba[r], bs + ((mt0 + r) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB +
                                   kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int pl = 0; pl < PBW; ++pl) {
          if (pb0 + pl >= pb1) continue;
#pragma unroll
          for (int t = 0; t < kTerms; ++t) {
            uint32_t bf[4];
            ldmatrix_x4(bf, dst + t * PP * LDS +
                                ((pb0 + pl) * 16 + (lane & 7) + (lane >> 4) * 8) * LDS +
                                kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              if (r == 1 && !two) continue;
              mma_bf16(u[r][2 * pl], ba[r], bf[0], bf[1]);
              mma_bf16(u[r][2 * pl + 1], ba[r], bf[2], bf[3]);
            }
          }
        }
      }
      float* DX = p.dx + ((long long)bb * p.T * p.H + h) * p.P;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r == 1 && !two) continue;
        const int m0 = (mt0 + r) * 16 + gr, m1 = m0 + 8;
        const float wd0 = wdt[m0], wd1 = wdt[m1];
        float v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int pl = 0; pl < PBW; ++pl) {
          if (pb0 + pl >= pb1) continue;
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            const float* uu = u[r][2 * pl + jn];
            const int pc = (pb0 + pl) * 16 + jn * 8 + 2 * tig;
            const float2 x0 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xs + m0 * LDX + pc));
            const float2 x1 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xs + m1 * LDX + pc));
            v0 = fmaf(x0.x, uu[0], fmaf(x0.y, uu[1], v0));
            v1 = fmaf(x1.x, uu[2], fmaf(x1.y, uu[3], v1));
            if (pc < p.P) {
              if (m0 < nv)
                *reinterpret_cast<float2*>(DX + (t0 + m0) * hp_st + pc) =
                    make_float2(wd0 * uu[0], wd0 * uu[1]);
              if (m1 < nv)
                *reinterpret_cast<float2*>(DX + (t0 + m1) * hp_st + pc) =
                    make_float2(wd1 * uu[2], wd1 * uu[3]);
            }
          }
        }
        v0 = quad_sum(v0);
        v1 = quad_sum(v1);
        if (tig == 0) {          // v over the half, a partial each half
          float* vd = p.vv + (ci * 2 + ph) * Lp;
          vd[m0] = w[m0] * v0;
          vd[m1] = w[m1] * v1;
        }
      }
      // dB's inter term += w dt (x ds): A = x rows, B operand = ds (K = P),
      // in passes of 32 columns
      uint32_t xa[2][PP / 16][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (r == 0 || two)
#pragma unroll
          for (int kk = 0; kk < PP / 16; ++kk)
            ldmatrix_x4(xa[r][kk], xs + ((mt0 + r) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX +
                                       kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int ng = 0; ng < (NBW + 1) / 2; ++ng) {
        float tmp[2][4][4] = {};
#pragma unroll
        for (int nd = 0; nd < 2; ++nd) {
          const int nl = ng * 2 + nd;
          if (nl >= NBW || nb0 + nl >= nb1) continue;
#pragma unroll
          for (int kk = 0; kk < PP / 16; ++kk)
#pragma unroll
            for (int t = 0; t < kTerms; ++t) {
              uint32_t bf[4];
              ldmatrix_x4_trans(bf, dst + t * PP * LDS +
                                        (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                        (nb0 + nl) * 16 + (lane >> 4) * 8);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                if (r == 1 && !two) continue;
                mma_bf16(tmp[r][2 * nd], xa[r][kk], bf[0], bf[1]);
                mma_bf16(tmp[r][2 * nd + 1], xa[r][kk], bf[2], bf[3]);
              }
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (r == 1 && !two) continue;
          const int m0 = (mt0 + r) * 16 + gr;
          const float wd0 = wdt[m0], wd1 = wdt[m0 + 8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int nl8 = ng * 4 + i;     // n8 index within the half
            if (nl8 >= 2 * NBW) continue;
            db[r][nl8][0] += wd0 * tmp[r][i][0];
            db[r][nl8][1] += wd0 * tmp[r][i][1];
            db[r][nl8][2] += wd1 * tmp[r][i][2];
            db[r][nl8][3] += wd1 * tmp[r][i][3];
          }
        }
      }
    }
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
      __syncthreads();
    }
    if (threadIdx.x == 0) p.dsin[ci] = red[0];
  }

  if (mt0 < nt) {
    const long long GS = (long long)p.G * p.S, st = GS * p.N;
    float* DB = p.dbh + ((long long)bb * p.T * GS + sl.gs) * p.N;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && !two) continue;
#pragma unroll
      for (int nl8 = 0; nl8 < 2 * NBW; ++nl8) {
        const int n = nb0 * 16 + nl8 * 8 + 2 * tig;
        if (nb0 + nl8 / 2 >= nb1 || n >= p.N) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = (mt0 + r) * 16 + gr + hh * 8;
          if (m < nv)
            *reinterpret_cast<float2*>(DB + (t0 + m) * st + n) =
                make_float2(db[r][nl8][2 * hh], db[r][nl8][2 * hh + 1]);
        }
      }
    }
  }
}

// ---- c2. the L x L terms, a block for a slice of a group's heads ----------

// dyx^T of the tile (m-tile of ``xa``, l-tile lt) = x_m dy_l^T (K = P),
// one sum for each of dy's terms, so that the products form kTerms
// independent chains.
template <int PP>
__device__ __forceinline__ void dyx_tile(const uint32_t (&xa)[PP / 16][4],
                                         const bf16* dyt, int Lp, int LDX,
                                         int lt, int lane,
                                         float (&o)[kTerms][2][4]) {
#pragma unroll
  for (int t = 0; t < kTerms; ++t)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int q = 0; q < 4; ++q) o[t][jj][q] = 0.f;
#pragma unroll
  for (int kk = 0; kk < PP / 16; ++kk)
#pragma unroll
    for (int t = 0; t < kTerms; ++t) {
      uint32_t bf[4];
      ldmatrix_x4(bf, dyt + t * Lp * LDX +
                          (lt * 16 + (lane & 7) + (lane >> 4) * 8) * LDX +
                          kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(o[t][0], xa[kk], bf[0], bf[1]);
      mma_bf16(o[t][1], xa[kk], bf[2], bf[3]);
    }
}

// A lane's accumulator fragment of tile T (16 x 16 floats, fragment
// order): its first four floats at [0], its last four at [32], so that a
// warp's float4 accesses are contiguous.
__device__ __forceinline__ float4* frag(float* tiles, int T, int lane) {
  return reinterpret_cast<float4*>(tiles + T * 256) + lane;
}

// Shared memory of the chunk kernel, in bytes from the start.  A2 and CB
// are 16 x 16 tiles (mt, lt), lt >= mt, of A2^T and C B^T (rows m, columns
// l) in the accumulator's fragment order (``frag``), tile lt (lt + 1) / 2 +
// mt.  Then, in the head loop, x in two buffers (the
// next head's is fetched while this one computes), dy in terms, the next
// head's dy as it comes (fp32), dt in two buffers and the small arrays; at
// the block's start B and C (to form CB); at its end A2^T's terms
// (row-major) over CB and the loop's buffers, then B and C after them.
struct ChunkLayout {
  int a2, cb, x0, x1, dyt, dyraw, small, bs, cs, terms, be, ce, total;
};
template <int PP, int NP>
__host__ __device__ ChunkLayout chunk_layout(int Lp) {
  ChunkLayout o;
  const int nt = Lp / 16, tri = nt * (nt + 1) / 2 * 1024;
  const int xb = Lp * pitch16(PP) * 2, bc = Lp * pitch16(NP) * 2;
  o.a2 = 0;
  o.cb = tri;
  const int R = 2 * tri;
  o.x0 = R;
  o.x1 = o.x0 + xb;
  o.dyt = o.x1 + xb;
  o.dyraw = o.dyt + kTerms * xb;
  o.small = o.dyraw + Lp * (PP + 4) * 4;
  // dt (this head's and the next's), css, colz, rowq[8]
  const int loop_end = o.small + 12 * Lp * 4;
  o.bs = R;
  o.cs = R + bc;
  const int start_end = R + 2 * bc;
  o.terms = tri;
  o.be = o.terms + kTerms * Lp * pitch16(Lp) * 2;
  o.ce = o.be + bc;
  const int end_end = o.ce + bc;
  o.total = loop_end > start_end ? loop_end : start_end;
  if (end_end > o.total) o.total = end_end;
  return o;
}

// C B^T is formed once a block; per head, dy is split into terms from the
// fp32 copy that cp.async fetched, with x and dt, while the previous head
// computed.  Warp w (wq = w % 4, ph = w / 4) takes the m-tiles wq and
// 7 - wq and, for every lt >= mt, the tile (mt, lt): dyx^T = x_m dy_l^T
// (K = P, dy in terms; the next tile's is formed while this tile's products
// run), CB^T from shared memory, E, A1^T = CB E dt_m, A2^T = dyx E dt_m and
// Z^T = dyx CB E in registers, then dx_m += A1^T dy_l (both split) over its
// half ph of P, from the inter kernel's first value.  The warp with ph = 0
// for the first m-tile and ph = 1 for the second also adds A2^T to the A2
// sum over the slice's heads (in shared memory), Z's column sums over l
// (colz) and its row sums times dt_m (rowq, per warp, summed over the warps
// in order), which go to the scan.  After the heads, the A2 sum times C
// and B are added to the slice's dB and dC partials.
template <int PP, int NP>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_mma(const Params p) {
  constexpr int LDX = pitch16(PP), LDN = pitch16(NP), LDR = PP + 4;
  constexpr int PB = PP / 16, PBW = (PB + 1) / 2;     // n16 blocks of P a warp
  constexpr int NB16 = NP / 16, NBW = (NB16 + 1) / 2; // n16 blocks of N a warp
  const Slice sl = slice_of(p);
  const int c = blockIdx.x, bb = sl.bb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tig = lane & 3;
  const int wq = warp & 3, ph = warp >> 2;
  const int Lp = p.Lp, nt = Lp / 16, ntri = nt * (nt + 1) / 2;
  const int t0 = c * p.L, nv = min(p.L, p.T - t0);
  const int LDT = pitch16(Lp);
  const ChunkLayout o = chunk_layout<PP, NP>(Lp);

  extern __shared__ __align__(16) unsigned char smem8[];
  float* a2t = reinterpret_cast<float*>(smem8 + o.a2);
  float* cbt = reinterpret_cast<float*>(smem8 + o.cb);
  bf16* xb[2] = {reinterpret_cast<bf16*>(smem8 + o.x0),
                 reinterpret_cast<bf16*>(smem8 + o.x1)};
  bf16* dyt = reinterpret_cast<bf16*>(smem8 + o.dyt);
  float* dyraw = reinterpret_cast<float*>(smem8 + o.dyraw);
  float* dtb = reinterpret_cast<float*>(smem8 + o.small);   // [2][Lp]
  float* css = dtb + 2 * Lp;
  float* colz = css + Lp;
  float* rowq = colz + Lp;            // [kMmaWarps][Lp]

  // -- C B^T, once a block: tile (mt, lt) = B_m C_l^T, by the warps in turn
  {
    bf16* bs = reinterpret_cast<bf16*>(smem8 + o.bs);
    bf16* cs = reinterpret_cast<bf16*>(smem8 + o.cs);
    load_bf16<NP>(bs, LDN, static_cast<const bf16*>(p.b) + bb * p.b_sb +
                  t0 * p.b_st + sl.g * p.b_sg, p.b_st, p.b_sn, nv, p.N, Lp,
                  p.b_vec);
    load_bf16<NP>(cs, LDN, static_cast<const bf16*>(p.c) + bb * p.c_sb +
                  t0 * p.c_st + sl.g * p.c_sg, p.c_st, p.c_sn, nv, p.N, Lp,
                  p.c_vec);
    cp_async_commit();
    for (int i = threadIdx.x; i < ntri * 256; i += kThreads) a2t[i] = 0.f;
    cp_async_wait_all();
    __syncthreads();
    for (int tix = warp; tix < ntri; tix += kMmaWarps) {
      int lt = 0;
      while ((lt + 1) * (lt + 2) / 2 <= tix) ++lt;
      const int mt = tix - lt * (lt + 1) / 2;
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        uint32_t af[4], bf[4];
        ldmatrix_x4(af, bs + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN +
                            kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(bf, cs + (lt * 16 + (lane & 7) + (lane >> 4) * 8) * LDN +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[0], af, bf[0], bf[1]);
        mma_bf16(acc[1], af, bf[2], bf[3]);
      }
      float4* dst = frag(cbt, tix, lane);
      dst[0] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      dst[32] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
    }
    __syncthreads();          // B and C are overwritten by the head loop
  }

  const long long hp_st = (long long)p.H * p.P;
  // a head's x, dy and dt, fetched while the previous head computes
  auto fetch = [&](int j) {
    const int h = sl.h0 + j, b2 = j & 1;
    load_bf16<PP>(xb[b2], LDX, static_cast<const bf16*>(p.x) + bb * p.x_sb +
                  t0 * p.x_st + h * p.x_sh, p.x_st, p.x_sp, nv, p.P, Lp,
                  p.x_vec);
    load_f32<PP>(dyraw, LDR, p.dy + bb * p.dy_sb + t0 * p.dy_st + h * p.dy_sh,
                 p.dy_st, p.dy_sp, nv, p.P, Lp, p.dy_vec);
    load_dt(p, bb, h, t0, nv, dtb + b2 * Lp);
    cp_async_commit();
  };
  fetch(0);

  const int mts[2] = {wq, 2 * 4 - 1 - wq};
  const int pb0 = ph * PBW, pb1 = min(PB, pb0 + PBW);
  for (int j = 0; j < sl.hps; ++j) {
    const int h = sl.h0 + j;
    const long long ci = chunk_index(p, bb, c, h);
    const bf16* xs = xb[j & 1];
    const float* dts = dtb + (j & 1) * Lp;
    float* DX = p.dx + ((long long)bb * p.T * p.H + h) * p.P;
    // dx starts from the inter kernel's first value, loaded here so that
    // the loads overlap the staging; the products of the lower A1 terms
    // go to a second sum (dxl), so that the chains are half as long
    float dx[2][2 * PBW][4] = {}, dxl[2][2 * PBW][4] = {};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int mt = mts[s];
      if (mt >= nt) continue;
#pragma unroll
      for (int pl = 0; pl < PBW; ++pl) {
        if (pb0 + pl >= pb1) continue;
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          const int pc = (pb0 + pl) * 16 + jn * 8 + 2 * tig;
          if (pc >= p.P) continue;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int m = mt * 16 + gr + hh * 8;
            if (m >= nv) continue;
            const float2 o2 =
                *reinterpret_cast<const float2*>(DX + (t0 + m) * hp_st + pc);
            dx[s][2 * pl + jn][2 * hh] = o2.x;
            dx[s][2 * pl + jn][2 * hh + 1] = o2.y;
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
    for (int i = threadIdx.x; i < Lp * PP / 4; i += kThreads) {
      const int l = i / (PP / 4), pp = 4 * (i % (PP / 4));
      split_store4(*reinterpret_cast<const float4*>(dyraw + l * LDR + pp),
                   dyt + l * LDX + pp, Lp * LDX);
    }
    for (int l = threadIdx.x; l < Lp; l += kThreads) colz[l] = 0.f;
    for (int i = threadIdx.x; i < kMmaWarps * Lp; i += kThreads) rowq[i] = 0.f;
    if (warp == 0) warp_cumsum(dts, p.a[h], css, Lp, lane);
    __syncthreads();
    if (j + 1 < sl.hps) fetch(j + 1);

#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int mt = mts[s];
      if (mt >= nt) continue;
      const bool own = s == ph;
      const int m0 = mt * 16 + gr, m1 = m0 + 8;
      const float cm0 = css[m0], cm1 = css[m1], dm0 = dts[m0], dm1 = dts[m1];
      uint32_t xa[PP / 16][4];
#pragma unroll
      for (int kk = 0; kk < PP / 16; ++kk)
        ldmatrix_x4(xa[kk], xs + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX +
                                kk * 16 + (lane >> 4) * 8);
      float cz0 = 0.f, cz1 = 0.f;
      // dyx^T of the next tile, a sum for each dy term, formed while this
      // tile's products run
      float nx[kTerms][2][4];
      dyx_tile<PP>(xa, dyt, Lp, LDX, mt, lane, nx);
      for (int lt = mt; lt < nt; ++lt) {
        float s2[2][4];                // dyx^T
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float v = nx[0][jj][q];
#pragma unroll
            for (int t = 1; t < kTerms; ++t) v += nx[t][jj][q];
            s2[jj][q] = v;
          }
        if (lt + 1 < nt) dyx_tile<PP>(xa, dyt, Lp, LDX, lt + 1, lane, nx);
        const int T = lt * (lt + 1) / 2 + mt;
        const float4* cp = frag(cbt, T, lane);
        const float4 c0 = cp[0], c1 = cp[32];
        const float s1[2][4] = {{c0.x, c0.y, c0.z, c0.w},
                                {c1.x, c1.y, c1.z, c1.w}};
        float a1[2][4], a2[2][4], z[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int l = lt * 16 + jj * 8 + 2 * tig + (q & 1);
            const int m = q < 2 ? m0 : m1;
            const float e = l >= m ? expf(css[l] - (q < 2 ? cm0 : cm1)) : 0.f;
            const float dm = q < 2 ? dm0 : dm1;
            a1[jj][q] = s1[jj][q] * e * dm;
            a2[jj][q] = s2[jj][q] * e * dm;
            z[jj][q] = s2[jj][q] * s1[jj][q] * e;
          }
        uint32_t at[kTerms][4];
        acc_to_a(a1, at);
#pragma unroll
        for (int pl = 0; pl < PBW; ++pl) {
          const int pb = pb0 + pl;
          if (pb >= pb1) continue;
#pragma unroll
          for (int t = 0; t < kTerms; ++t) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, dyt + t * Lp * LDX +
                                      (lt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX +
                                      pb * 16 + (lane >> 4) * 8);
            mma_bf16(dx[s][2 * pl], at[0], bf[0], bf[1]);
            mma_bf16(dx[s][2 * pl + 1], at[0], bf[2], bf[3]);
#pragma unroll
            for (int i = 1; i + t < kTerms; ++i) {
              mma_bf16(dxl[s][2 * pl], at[i], bf[0], bf[1]);
              mma_bf16(dxl[s][2 * pl + 1], at[i], bf[2], bf[3]);
            }
          }
        }
        if (own) {
          float4* ap = frag(a2t, T, lane);
          float4 v0 = ap[0], v1 = ap[32];
          v0.x += a2[0][0]; v0.y += a2[0][1]; v0.z += a2[0][2]; v0.w += a2[0][3];
          v1.x += a2[1][0]; v1.y += a2[1][1]; v1.z += a2[1][2]; v1.w += a2[1][3];
          ap[0] = v0;
          ap[32] = v1;
          cz0 += (z[0][0] + z[0][1]) + (z[1][0] + z[1][1]);
          cz1 += (z[0][2] + z[0][3]) + (z[1][2] + z[1][3]);
          float rq[2][2];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              float v = fmaf(z[jj][cc], dm0, z[jj][2 + cc] * dm1);
#pragma unroll
              for (int off = 4; off < 32; off <<= 1)
                v += __shfl_xor_sync(0xffffffffu, v, off);
              rq[jj][cc] = v;
            }
          if (gr == 0)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc)
                rowq[warp * Lp + lt * 16 + jj * 8 + 2 * tig + cc] += rq[jj][cc];
        }
      }
      if (own) {
        cz0 = quad_sum(cz0);
        cz1 = quad_sum(cz1);
        if (tig == 0) {
          colz[m0] = cz0;
          colz[m1] = cz1;
        }
      }
    }
    // dx: the inter kernel's first value plus the L x L term
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int mt = mts[s];
      if (mt >= nt) continue;
#pragma unroll
      for (int pl = 0; pl < PBW; ++pl) {
        if (pb0 + pl >= pb1) continue;
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          const int pc = (pb0 + pl) * 16 + jn * 8 + 2 * tig;
          if (pc >= p.P) continue;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int m = mt * 16 + gr + hh * 8;
            if (m >= nv) continue;
            const float* d = dx[s][2 * pl + jn];
            const float* e = dxl[s][2 * pl + jn];
            *reinterpret_cast<float2*>(DX + (t0 + m) * hp_st + pc) =
                make_float2(d[2 * hh] + e[2 * hh], d[2 * hh + 1] + e[2 * hh + 1]);
          }
        }
      }
    }
    __syncthreads();
    // Z's column sums and its row sums times dt (the warps' partials in
    // warp order) for the scan kernel
    for (int l = threadIdx.x; l < Lp; l += kThreads) {
      float rq = 0.f;
      for (int w2 = 0; w2 < kMmaWarps; ++w2) rq += rowq[w2 * Lp + l];
      p.rowq[ci * Lp + l] = rq;
      p.colz[ci * Lp + l] = colz[l];
    }
  }

  // -- the A2 sum: dB += A2^T C (m-tiles), dC += A2 B (l-tiles), over the
  // warp's half of N; A2^T in terms, row-major, zeros below lt < mt
  cp_async_wait_all();
  __syncthreads();
  bf16* terms = reinterpret_cast<bf16*>(smem8 + o.terms);
  bf16* be = reinterpret_cast<bf16*>(smem8 + o.be);
  bf16* ce = reinterpret_cast<bf16*>(smem8 + o.ce);
  load_bf16<NP>(be, LDN, static_cast<const bf16*>(p.b) + bb * p.b_sb +
                t0 * p.b_st + sl.g * p.b_sg, p.b_st, p.b_sn, nv, p.N, Lp,
                p.b_vec);
  load_bf16<NP>(ce, LDN, static_cast<const bf16*>(p.c) + bb * p.c_sb +
                t0 * p.c_st + sl.g * p.c_sg, p.c_st, p.c_sn, nv, p.N, Lp,
                p.c_vec);
  cp_async_commit();
  for (int tix = warp; tix < nt * nt; tix += kMmaWarps) {
    const int mt = tix / nt, lt = tix % nt;
    float v[2][4] = {};
    if (lt >= mt) {
      const float4* ap = frag(a2t, lt * (lt + 1) / 2 + mt, lane);
      const float4 v0 = ap[0], v1 = ap[32];
      v[0][0] = v0.x; v[0][1] = v0.y; v[0][2] = v0.z; v[0][3] = v0.w;
      v[1][0] = v1.x; v[1][1] = v1.y; v[1][2] = v1.z; v[1][3] = v1.w;
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t t[kTerms];
        split_pair(v[jj][2 * hh], v[jj][2 * hh + 1], t);
        const int m = mt * 16 + gr + hh * 8, l = lt * 16 + jj * 8 + 2 * tig;
#pragma unroll
        for (int k = 0; k < kTerms; ++k)
          *reinterpret_cast<uint32_t*>(terms + k * Lp * LDT + m * LDT + l) = t[k];
      }
  }
  cp_async_wait_all();
  __syncthreads();

  const int nb0 = ph * NBW, nb1 = min(NB16, nb0 + NBW);
  const long long GS = (long long)p.G * p.S, gst = GS * p.N;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {      // 0: dB, 1: dC
    float* OUT = (pass ? p.dch : p.dbh) + ((long long)bb * p.T * GS + sl.gs) * p.N;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int r = mts[s];                   // the m-tile (dB) or l-tile (dC)
      if (r >= nt) continue;
      float acc[2 * NBW][4] = {};
      const int k0 = pass ? 0 : r, k1 = pass ? r + 1 : nt;
      for (int k = k0; k < k1; ++k) {
        uint32_t af[kTerms][4];
#pragma unroll
        for (int t = 0; t < kTerms; ++t) {
          if (pass)      // A = A2 (rows l, K = m): A2^T stored (m, l)
            ldmatrix_x4_trans(af[t], terms + t * Lp * LDT +
                                         (k * 16 + (lane >> 4) * 8 + (lane & 7)) * LDT +
                                         r * 16 + ((lane >> 3) & 1) * 8);
          else           // A = A2^T (rows m, K = l)
            ldmatrix_x4(af[t], terms + t * Lp * LDT +
                                   (r * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDT +
                                   k * 16 + (lane >> 4) * 8);
        }
        const bf16* rhs = pass ? be : ce;     // rows K
#pragma unroll
        for (int nl = 0; nl < NBW; ++nl) {
          const int nb = nb0 + nl;
          if (nb >= nb1) continue;
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, rhs + (k * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN +
                                    nb * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int t = 0; t < kTerms; ++t) {
            mma_bf16(acc[2 * nl], af[t], bf[0], bf[1]);
            mma_bf16(acc[2 * nl + 1], af[t], bf[2], bf[3]);
          }
        }
      }
#pragma unroll
      for (int nl = 0; nl < NBW; ++nl) {
        if (nb0 + nl >= nb1) continue;
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          const int n = (nb0 + nl) * 16 + jn * 8 + 2 * tig;
          if (n >= p.N) continue;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r * 16 + gr + hh * 8;
            if (row >= nv) continue;
            float2* d = reinterpret_cast<float2*>(OUT + (t0 + row) * gst + n);
            const float2 o2 = *d;
            *d = make_float2(o2.x + acc[2 * nl + jn][2 * hh],
                             o2.y + acc[2 * nl + jn][2 * hh + 1]);
          }
        }
      }
    }
  }
}

// ---- c3. the scan: dcss, its reverse cumsum dda, ddt and da's shares ----

// One warp a (b, chunk, head), lane ``lane`` the rows lane K + k (K = Lp /
// 32 <= 4): seg from dt, v and the dcss share from their two halves,
// dcss_l = share_l + rowq_l - dt_l (colz_l + v_l),
// the last row also sum_m dt_m v_m + exp(seg) <ds, s_in>; dda its reverse
// cumsum, ddt = colz + v + a dda, and the chunk's da share sum dt dda.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dda(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ci = (long long)blockIdx.x * kMmaWarps + warp;
  if (ci >= (long long)p.B * p.n_chunks * p.H) return;
  const int h = (int)(ci % p.H);
  const long long bc = ci / p.H;
  const int c = (int)(bc % p.n_chunks), bb = (int)(bc / p.n_chunks);
  const int Lp = p.Lp, K = (Lp + 31) / 32, t0 = c * p.L;
  const int nv = min(p.L, p.T - t0);
  const float* DT = p.dt + bb * p.dt_sb + h * p.dt_sh + t0 * p.dt_st;
  const float a = p.a[h];
  float dtv[4], vvv[4], zc[4], q[4];
  float run = 0.f, rv = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int l = lane * K + k;
    const bool in = k < K && l < Lp;
    dtv[k] = in && l < nv ? DT[l * p.dt_st] : 0.f;
    vvv[k] = in ? p.vv[ci * 2 * Lp + l] + p.vv[(ci * 2 + 1) * Lp + l] : 0.f;
    zc[k] = in ? p.colz[ci * Lp + l] : 0.f;
    q[k] = in ? (p.dcss[ci * 2 * Lp + l] + p.dcss[(ci * 2 + 1) * Lp + l]) +
                    p.rowq[ci * Lp + l]
              : 0.f;
    run += dtv[k] * a;
    rv = fmaf(dtv[k], vvv[k], rv);      // sum_m dt_m v_m
  }
  float seg = run;                      // padded rows add 0
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    seg += __shfl_xor_sync(0xffffffffu, seg, off);
    rv += __shfl_xor_sync(0xffffffffu, rv, off);
  }
  const float extra = rv + expf(seg) * p.dsin[ci];
  float d[4];
  float tail = 0.f;                     // the lane's rows, last to first
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    tail += q[k] - dtv[k] * (zc[k] + vvv[k]);
    d[k] = tail;
  }
  float sfx = tail;                     // suffix sums over the lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float dn = __shfl_down_sync(0xffffffffu, sfx, off);
    if (lane + off < 32) sfx += dn;
  }
  const float after = sfx - tail + extra;
  float* DDT = p.ddt + (long long)bb * p.T * p.H + h;
  float dap = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int m = lane * K + k;
    if (k < K && m < Lp) {
      const float dda = after + d[k];
      dap = fmaf(dtv[k], dda, dap);
      if (m < nv) DDT[(t0 + m) * (long long)p.H] = zc[k] + vvv[k] + a * dda;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dap += __shfl_xor_sync(0xffffffffu, dap, off);
  if (lane == 0) p.da_part[ci] = dap;
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

template <int PP, int NP>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  cudaError_t e;
  const dim3 grid(p.n_chunks, p.B * p.G * p.S);
  const size_t a_smem = dstate_mma_smem<PP, NP>(p.Lp);
  if ((e = allow_smem(ssd_bwd_dstate_mma<PP, NP>, a_smem)) != cudaSuccess)
    return e;
  ssd_bwd_dstate_mma<PP, NP><<<grid, kThreads, a_smem, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int tiles = (p.P * p.N / 4 + kPassThreads - 1) / kPassThreads;
  ssd_bwd_state_passing<<<dim3(tiles, p.B * p.H), kPassThreads, 0, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t i_smem = inter_smem<PP, NP>(p.Lp);
  if ((e = allow_smem(ssd_bwd_inter<PP, NP>, i_smem)) != cudaSuccess) return e;
  ssd_bwd_inter<PP, NP><<<grid, kThreads, i_smem, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t c_smem = chunk_layout<PP, NP>(p.Lp).total;
  if ((e = allow_smem(ssd_bwd_chunk_mma<PP, NP>, c_smem)) != cudaSuccess)
    return e;
  ssd_bwd_chunk_mma<PP, NP><<<grid, kThreads, c_smem, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const long long heads = (long long)p.B * p.n_chunks * p.H;
  ssd_bwd_dda<<<(unsigned)((heads + kMmaWarps - 1) / kMmaWarps), kThreads, 0,
                stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const long long total = (long long)p.B * p.T * p.G * p.N;
  ssd_bwd_group_sum<<<dim3((unsigned)((total + kThreads - 1) / kThreads), 2),
                      kThreads, 0, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  ssd_bwd_da_sum<<<p.H, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int PP>
cudaError_t launch_n(const Params& p, int mma, cudaStream_t stream) {
  if (mma) {
    if (p.N <= 16) return launch_mma<PP, 16>(p, stream);
    if (p.N == 64) return launch_mma<PP, 64>(p, stream);
    return launch_mma<PP, 128>(p, stream);
  }
  if (p.N <= 16) return launch<PP, 16>(p, stream);
  if (p.N == 64) return launch<PP, 64>(p, stream);
  return launch<PP, 128>(p, stream);
}

// Dynamic shared memory (bytes) of the chunk kernel (cuda_core) or of the
// largest of the three (mma) at instantiation (PP, NP).
template <int PP, int NP>
size_t path_smem(int mma, int Lp) {
  if (!mma) return chunk_smem_floats<PP, NP>(Lp) * sizeof(float);
  size_t m = dstate_mma_smem<PP, NP>(Lp);
  if (inter_smem<PP, NP>(Lp) > m) m = inter_smem<PP, NP>(Lp);
  const size_t c = chunk_layout<PP, NP>(Lp).total;
  return c > m ? c : m;
}

// A bf16 view allows 16-byte copies of its rows: unit column stride, and
// every row of every (b, h or g) starts on 16 bytes; an fp32 view the same
// with strides in fours.
int vec_ok(const void* ptr, long long sb, long long st, long long sh,
           long long sc, int per16) {
  return sc == 1 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         sb % per16 == 0 && st % per16 == 0 && sh % per16 == 0;
}

}  // namespace

extern "C" {

// Shared memory (bytes) of a block of the path's largest kernel (path 0:
// cuda_core, its chunk kernel; 1: mma, the largest of its three) at head
// dim P, state dim N and Lp rows, so that a test can hold the layout to
// the card's limit.
long long ssd_bwd_smem(int path, int P, int N, int Lp) {
  const int n = N <= 16 ? 16 : N;
  size_t f = 0;
  if (P <= 16)
    f = n == 16 ? path_smem<16, 16>(path, Lp)
        : n == 64 ? path_smem<16, 64>(path, Lp) : path_smem<16, 128>(path, Lp);
  else
    f = n == 16 ? path_smem<64, 16>(path, Lp)
        : n == 64 ? path_smem<64, 64>(path, Lp) : path_smem<64, 128>(path, Lp);
  return (long long)f;
}

// path: 0 = cuda_core (fp32 products on the CUDA cores; x, B_ and C_ are
// bfloat16 if in_bf16, else float32), 1 = mma (bfloat16 x, B_, C_ on the
// tensor cores, ``slices`` blocks a group of heads).  dy, dt, a, dstate
// and states are float32.  L, Lp (L rounded up to 16), n_chunks and slices
// are the caller's plan (../kernel.py, ``bwd_plan``, ``bwd_slices``),
// checked, not recomputed.  strides: 19 element strides, x (b, t, h, p), dt
// (b, t, h), B_ and C_ (b, t, g, n), dy (b, t, h, p).  dstate and dstate0
// may be null; dstate, states and dstate0 are contiguous and on 16 bytes.
// Outputs, contiguous fp32: dx (B, T, H, P), ddt (B, T, H), da (H,), dB and
// dC (B, T, G, N).  Scratch from the caller, fp32 (``bwd_scratch``): dbh and
// dch, the dB and dC partials, of B * T * H * N (cuda_core: per head) or
// B * T * G * slices * N (mma: per slice); dsc of B * chunks * H * P * N;
// segs and da_part of B * chunks * H; dcss of B * chunks * H * Lp; on the
// mma path also vv, colz and rowq of B * chunks * H * Lp and dsin of
// B * chunks * H (null on cuda_core).  Returns a cudaError_t (0 on success).
int ssd_bwd(const void* x, const float* dt, const float* a, const void* b,
            const void* c, const float* dy, const float* dstate,
            const float* states, float* dx, float* ddt, float* da, float* db,
            float* dc, float* dstate0, float* dbh, float* dch, float* dsc,
            float* segs, float* dcss, float* da_part, float* vv, float* dsin,
            float* colz, float* rowq, int path, int slices, int in_bf16, int B, int T, int H, int G,
            int P, int N, int L, int Lp, int n_chunks,
            const long long* strides, void* stream) {
  if (B < 1 || T < 1 || H < 1 || G < 1 || H % G || L < 1 || L > kMaxL ||
      (P != 8 && P != 16 && P != 64) ||
      (N != 8 && N != 16 && N != 64 && N != 128) || Lp < L ||
      Lp >= L + kTile || Lp % kTile || Lp > kMaxL ||
      (long long)(n_chunks - 1) * L >= T || (long long)n_chunks * L < T ||
      !states || !dx || !ddt || !da || !db || !dc || !dbh || !dch || !dsc ||
      !segs || !dcss || !da_part || (path != 0 && path != 1) ||
      (path == 1 && (!in_bf16 || slices < 1 || (H / G) % slices || !vv ||
                     !dsin || !colz || !rowq)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.dt = dt; p.a = a; p.b = b; p.c = c; p.dy = dy;
  p.dstate = dstate; p.states = states;
  p.dx = dx; p.ddt = ddt; p.dstate0 = dstate0; p.dbh = dbh; p.dch = dch;
  p.db = db; p.dc = dc; p.da = da;
  p.dsc = dsc; p.segs = segs; p.dcss = dcss; p.da_part = da_part;
  p.vv = vv; p.dsin = dsin; p.colz = colz; p.rowq = rowq;
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
  p.S = path == 1 ? slices : H / G;
  p.x_vec = vec_ok(x, p.x_sb, p.x_st, p.x_sh, p.x_sp, 8);
  p.b_vec = vec_ok(b, p.b_sb, p.b_st, p.b_sg, p.b_sn, 8);
  p.c_vec = vec_ok(c, p.c_sb, p.c_st, p.c_sg, p.c_sn, 8);
  p.dy_vec = vec_ok(dy, p.dy_sb, p.dy_st, p.dy_sh, p.dy_sp, 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(P == 64 ? launch_n<64>(p, path, st) : launch_n<16>(p, path, st));
}

const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
