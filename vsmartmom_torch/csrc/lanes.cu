// Lanes-layout RT layer step for Hopper: doubling of the elemental layer and
// the two-solve adding under the composite, every operand in lanes layout.
//
// Replaces the TPU kernel vsmartmom/pallas/lanes_kernel.py:_lanes_kernel
// (body lanes_layer_step_math), reached from fused_layer_step_lanes. Same
// algebra and association: per doubling step A = I - r r, M = NS(A), and
// r += t (M (r t)), jm += t (M v1), jp = j1p + t (M v2), t = t (M t); the
// interaction with two NS solves, c_tmm (M1 x1) and t (M2 x2), tt never
// materialized.
//
// Layout: matrices (N, N, S), vectors (N, S); element (i, j) of point s at
// (i N + j) S + s. Two paths, chosen by the wrapper from N alone:
//
// Team path (N <= 63, lanes_team_kernel): the layer step's design
// (layer_step.cu) on the team helpers of rt_device.cuh. Bound: per point a
// chain of small dependent N x N fp32 products, O(N^3) FMAs against O(N^2)
// bytes of device memory, so arithmetic and the shared-memory loads that
// feed it bound it, not device memory. A team of whole warps per spectral
// point owns its arena in dynamic shared memory for the whole step; a block
// holds as many teams as half an SM's shared memory takes and shares the D
// diagonal. Products are register-tiled fp32 FMA (no TF32, no tensor
// cores) with the elementwise passes fused into their stores. Loads and
// stores address device memory in lanes layout directly, (i N + j) S + p:
// the teams of a block hold consecutive points, so they read the same
// 32-byte sectors and L1/L2 absorb the stride. c_rpm and c_tmm arrive by
// cp.async while the doubling runs. The doubling is vsm::doubling_phase;
// the interaction runs the TPU body's two NS solves:
//   solve 1: a1 = I - r2mp c_rpm, M1 = NS(a1), y1 = M1 x1 in place,
//            x1 = [r2mp c_tpp | t2mm | r2mp c_jp + j2m];
//            c_tmm y1 -> r_mp (+ c_rmp), t_mm, j_m (+ c_jm)
//   solve 2: a2 = I - c_rpm r2mp, M2 = NS(a2), y2 = M2 x2 in place,
//            x2 = [c_tpp | c_rpm t2mm | c_jp + c_rpm j2m];
//            t y2 -> t_pp, r_pm (+ r2pm), j_p (+ jp)
// Per-point arena (floats; sq = n ld, ld the padded row stride, every slot
// on 16 bytes): the doubling's Arena (R, T, A, M0, M1, TMP, JP, JM, W1, W2),
// whose W1, W2 the interaction reuses as X [n x wx] | X2 [n x wx],
// wx = round4(2n + 1), then CRPM [sq] | CTMM [sq]. The ragged last block is
// masked: a team past S returns after the block's only barrier.
//
// Wide path (64 <= N <= 136, lanes_wide_kernel<CS>): the team arena no
// longer fits a block (194.5 KiB at N = 64, 400.3 KiB at N = 92), so the
// step is reassociated onto six n x n slots and a cluster of CS CTAs holds
// one point: CS = 1 for N <= 96 (206 KB at N = 92), 2 for N <= 136 (221 KB
// a CTA at N = 136; lanes_kernel.wide_launch_config). Each CTA owns a row
// slab of every slot; a product computes the CTA's rows of its output from
// its rows of A and every CTA's rows of B, the other CTAs' through
// distributed shared memory (map_shared_rank). Whole vectors are kept in
// every CTA, each CTA writing its rows into every copy. The cluster barrier
// (__syncthreads for CS = 1) separates dependent products. Bound: fp32 FMA
// and the shared-memory loads that feed it, as on the team path. Products
// are 4 x 4 register tiles of fp32 FMA (vsm::tile4: per four l, 4 + 4
// float4 loads for 64 FMAs; 8 x 4 tiles in a cluster of 2), dealt round
// the CTA's threads, each output one fmaf chain over l in order. Per step
// (the team path's products, one at a time):
//   doubling: A = I - R R; M = NS(A); X = R T; Y = M X; Z = M T;
//             R += T Y; T' = T Z (vectors beside them)
//   solve 1:  a1 = I - R c_rpm, M1 = NS(a1); o_rmp = c_rmp + c_tmm (M1
//             (R c_tpp)), o_tmm = c_tmm (M1 t2mm), o_jm likewise
//   solve 2:  a2 = I - c_rpm R, M2 = NS(a2); o_rpm = r2pm + t (M2 (c_rpm
//             t2mm)), o_tpp = t (M2 c_tpp), o_jp likewise
// Six slots are enough because c_rpm and c_tpp are read again from device
// memory where a solve needed their slots (c_rpm three times, c_tpp twice).
// State never leaves shared memory during the step; loads and stores
// address the lanes layout directly, and consecutive clusters hold
// consecutive points, so L2 absorbs the stride. Wider N raises in the
// wrapper.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "rt_device.cuh"

namespace {

namespace cg = cooperative_groups;

using vsm::Arena;
using vsm::doubling_arena_floats;
using vsm::doubling_phase;
using vsm::each;
using vsm::each_flat;
using vsm::each_row;
using vsm::kMaxBlock;
using vsm::kMaxSched;
using vsm::mm;
using vsm::mv;
using vsm::ns;
using vsm::ns_seed;
using vsm::round4;
using vsm::Schedule;
using vsm::Team;

// ---- team path ------------------------------------------------------------

// row stride of the interaction's X and X2 (2n + 1 columns each)
__host__ __device__ inline int x_stride(int n) { return round4(2 * n + 1); }

// the team arena: the doubling's (X, X2 fit in its W1, W2), then CRPM, CTMM
__host__ __device__ inline int lanes_arena_floats(int n, int ld) {
  return doubling_arena_floats(n, ld) + 2 * n * ld;
}

// offsets of point p's elements in lanes layout
struct Lanes {
  size_t S;
  int n, p;
  __device__ size_t m(int i, int j) const {
    return ((size_t)i * n + j) * S + p;
  }
  __device__ size_t v(int i) const { return (size_t)i * S + p; }
};

template <class C>
__global__ void __launch_bounds__(kMaxBlock)
lanes_team_kernel(const float* __restrict__ c_rmp,
                  const float* __restrict__ c_rpm,
                  const float* __restrict__ c_tpp,
                  const float* __restrict__ c_tmm,
                  const float* __restrict__ c_jp,
                  const float* __restrict__ c_jm,
                  const float* __restrict__ r_f, const float* __restrict__ t,
                  const float* __restrict__ jp, const float* __restrict__ jm_f,
                  const float* __restrict__ ek, const float* __restrict__ d,
                  float* __restrict__ o_rmp, float* __restrict__ o_rpm,
                  float* __restrict__ o_tpp, float* __restrict__ o_tmm,
                  float* __restrict__ o_jp, float* __restrict__ o_jm,
                  int S, int n, int ld, int P, Schedule sch) {
  extern __shared__ float smem[];
  float* dv = smem;  // D-matrix diagonal, shared by all points
  for (int i = threadIdx.x; i < n; i += blockDim.x) dv[i] = d[i];
  __syncthreads();
  const int team = threadIdx.x / C::TT;
  const int p = blockIdx.x * P + team;
  if (p >= S) return;
  const Team<C> tm(threadIdx.x - team * C::TT, 1 + team);
  float* ar = smem + round4(n) + team * lanes_arena_floats(n, ld);
  Arena o(n, ld);
  const Lanes g{(size_t)S, n, p};

  // ---- load: c_rpm, c_tmm by cp.async (overlapping the doubling) ---------
  float* CRPM = ar + doubling_arena_floats(n, ld);
  float* CTMM = CRPM + n * ld;
  each_flat(tm, n, n, [=](int i, int j) {
    vsm::cp_async4(CRPM + i * ld + j, c_rpm + g.m(i, j));
    vsm::cp_async4(CTMM + i * ld + j, c_tmm + g.m(i, j));
  });
  vsm::cp_async_commit();
  {
    float* R = ar + o.oR;
    float* T = ar + o.oT;
    each_flat(tm, n, n, [=](int i, int j) {
      R[i * ld + j] = r_f[g.m(i, j)];
      T[i * ld + j] = t[g.m(i, j)];
    });
    each_row(tm, n, [=](int i) {
      ar[o.oJP + i] = jp[g.v(i)];
      ar[o.oJM + i] = jm_f[g.v(i)];
    });
  }
  tm.sync();

  // ---- 1. doubling (flipped space) ----------------------------------------
  doubling_phase(tm, ar, o, ek[p], sch);

  float* R = ar + o.oR;
  const float* T = ar + o.oT;
  const float* JP = ar + o.oJP;
  float* JM = ar + o.oJM;
  float* A = ar + o.oA;
  float* M0 = ar + o.oM0;
  // until solve 1 takes their slots: t2mm (an aligned copy, the B of
  // c_rpm t2mm) and c_jp
  float* T2 = ar + o.oTMP;
  float* CJP = ar + o.oM1;
  const int wx = x_stride(n);
  float* X = ar + o.oW1;
  float* X2 = X + n * wx;

  // ---- 2. un-flip R <- D R (r2mp), JM <- D JM (j2m); t2mm, c_tpp, c_jp ----
  each(tm, n, n, [=](int i, int j) {
    R[i * ld + j] = dv[i] * R[i * ld + j];
    const float t2 = (dv[i] * dv[j]) * T[i * ld + j];
    X[i * wx + n + j] = t2;
    T2[i * ld + j] = t2;
  });
  each_flat(tm, n, n,
            [=](int i, int j) { X2[i * wx + j] = c_tpp[g.m(i, j)]; });
  each_row(tm, n, [=](int i) {
    JM[i] = dv[i] * JM[i];
    CJP[i] = c_jp[g.v(i)];
  });
  vsm::cp_async_wait_all();
  tm.sync();

  // ---- 3. interaction under the composite (two NS solves) -----------------
  // x1 = [r2mp c_tpp | t2mm | r2mp c_jp + j2m]           -> X
  // x2 = [c_tpp | c_rpm t2mm | c_jp + c_rpm j2m]         -> X2
  // a1 = I - r2mp c_rpm (and the NS seed)
  mm(tm, n, n, R, ld, X2, wx,
     [=](int i, int j, float s) { X[i * wx + j] = s; });
  mv(tm, n, R, ld, [=](int l) { return CJP[l]; },
     [=](int i, float s) { X[i * wx + 2 * n] = __fadd_rn(s, JM[i]); });
  mm(tm, n, n, CRPM, ld, T2, ld,
     [=](int i, int j, float s) { X2[i * wx + n + j] = s; });
  mv(tm, n, CRPM, ld, [=](int l) { return JM[l]; },
     [=](int i, float s) { X2[i * wx + 2 * n] = __fadd_rn(CJP[i], s); });
  mm(tm, n, n, R, ld, CRPM, ld, [=](int i, int j, float s) {
    ns_seed(A, M0, i * ld + j, i == j, s);
  });
  tm.sync();
  // solve 1: M1 = NS inverse of a1 (ni iterations); y1 = M1 x1 in place
  const float* M1 =
      ar + ns(tm, ar, n, ld, o.oA, o.oM0, o.oM1, o.oTMP, sch.ni);
  mm<C, true>(tm, n, 2 * n + 1, M1, ld, X, wx,
              [=](int i, int j, float s) { X[i * wx + j] = s; });
  tm.sync();
  // c_tmm y1 -> r_mp, t_mm, j_m; a2 = I - c_rpm r2mp (and the NS seed)
  mm(tm, n, 2 * n + 1, CTMM, ld, X, wx, [=](int i, int j, float s) {
    if (j < n) {
      o_rmp[g.m(i, j)] = __fadd_rn(c_rmp[g.m(i, j)], s);
    } else if (j < 2 * n) {
      o_tmm[g.m(i, j - n)] = s;
    } else {
      o_jm[g.v(i)] = __fadd_rn(c_jm[g.v(i)], s);
    }
  });
  mm(tm, n, n, CRPM, ld, R, ld, [=](int i, int j, float s) {
    ns_seed(A, M0, i * ld + j, i == j, s);
  });
  tm.sync();
  // solve 2: M2 = NS inverse of a2; y2 = M2 x2 in place
  const float* M2 =
      ar + ns(tm, ar, n, ld, o.oA, o.oM0, o.oM1, o.oTMP, sch.ni);
  mm<C, true>(tm, n, 2 * n + 1, M2, ld, X2, wx,
              [=](int i, int j, float s) { X2[i * wx + j] = s; });
  tm.sync();
  // t y2 -> t_pp, r_pm (+ r2pm = (d_i d_j) r2mp), j_p
  mm(tm, n, 2 * n + 1, T, ld, X2, wx, [=](int i, int j, float s) {
    if (j < n) {
      o_tpp[g.m(i, j)] = s;
    } else if (j < 2 * n) {
      o_rpm[g.m(i, j - n)] =
          __fadd_rn((dv[i] * dv[j - n]) * R[i * ld + j - n], s);
    } else {
      o_jp[g.v(i)] = __fadd_rn(JP[i], s);
    }
  });
}

// ---- wide path ------------------------------------------------------------

// Whole vectors of a wide CTA's arena.
constexpr int kWideVecs = 8;

// A thread's register tile in the wide path, TM rows x 4 columns (the
// float4 tile of vsm::tile4), and the threads a CTA may have (the launch
// bound), by cluster size. A cluster of 2 takes 8-row tiles, which halve
// the reads of the other CTA's rows through distributed shared memory (on
// an H100 at N = 136, S = 1 007: 31.1 ms against 43.8 with 4-row tiles);
// one CTA a point keeps 4-row tiles (N = 64 to 92: 8-row tiles 2-20 %
// slower).
template <int CS>
struct WideTile {
  static constexpr int TM = CS == 1 ? 4 : 8, TN = 4;
  static constexpr int kThreads = CS == 1 ? 576 : 320;
};

// One CTA's arena (floats): six slots of rs rows at row stride ld (this
// CTA's rows of six n x n matrices), then kWideVecs whole vectors of
// round4(n). Must match lanes_kernel.wide_arena_floats.
__host__ __device__ inline int wide_arena_floats(int n, int rs, int ld) {
  return 6 * rs * ld + kWideVecs * round4(n);
}

// A CTA's place in its point's cluster of CS CTAs: rank q owns rows
// q rs .. min(n, (q + 1) rs) - 1 of every slot, at the same arena offsets
// in every CTA. With CS = 1 the block is the cluster.
template <int CS>
struct Wide {
  int n, ld, rs, r0, nr, p;
  size_t S;
  int rank;
  // offsets of point p's elements in lanes layout
  __device__ size_t m(int i, int j) const {
    return ((size_t)i * n + j) * S + p;
  }
  __device__ size_t v(int i) const { return (size_t)i * S + p; }
  // offset of own row i (a global row index), column j, in a slot
  __device__ int e(int i, int j) const { return (i - r0) * ld + j; }
  __device__ __forceinline__ void sync() const {
    if constexpr (CS == 1) {
      __syncthreads();
    } else {
      cg::this_cluster().sync();
    }
  }
  // x (an arena address of this CTA) in rank q's arena
  template <class T>
  __device__ __forceinline__ T* at(T* x, int q) const {
    if constexpr (CS == 1) {
      return x;
    } else {
      return q == rank ? x : cg::this_cluster().map_shared_rank(x, q);
    }
  }
  // element i of a whole vector, in every CTA's copy
  __device__ __forceinline__ void put(float* x, int i, float s) const {
#pragma unroll
    for (int q = 0; q < CS; ++q) at(x, q)[i] = s;
  }
};

// out(i, j, s) for this CTA's rows i (global indices) and every column j of
// A @ B, n x n: A this CTA's rows of a slot, B a slot whose rows lie in the
// cluster's CTAs. The tiles (WideTile<CS>) are dealt round the block;
// each runs vsm::tile4 over the B rows of rank 0, 1, ... in turn, so s is
// one fmaf chain over l = 0 .. n-1 from 0, as in the team kernels. No
// output may be written into A or B.
template <int CS, class Out>
__device__ __forceinline__ void wmm(const Wide<CS>& w, const float* A,
                                    const float* B, Out out) {
  using Tile = WideTile<CS>;
  const int n = w.n, nct = (n + 3) >> 2,
            ntile = (w.nr + Tile::TM - 1) / Tile::TM * nct;
  for (int tile = threadIdx.x; tile < ntile; tile += blockDim.x) {
    const int rt = tile / nct, j0 = (tile - rt * nct) * 4;
    int ra[Tile::TM];
#pragma unroll
    for (int r = 0; r < Tile::TM; ++r)
      ra[r] = min(rt * Tile::TM + r, w.nr - 1) * w.ld;
    float acc[Tile::TM][Tile::TN];
    vsm::zero<Tile>(acc);
    // not unrolled: unrolled, the cluster kernels ran on a stack
#pragma unroll 1
    for (int q = 0; q < CS; ++q) {
      const int l0 = q * w.rs;
      vsm::tile4<Tile, vsm::kF32, vsm::kF32>(
          acc, ra, min(w.rs, n - l0), A + l0, w.at(B, q), w.ld, j0);
    }
#pragma unroll
    for (int r = 0; r < Tile::TM; ++r) {
      const int i = rt * Tile::TM + r;
      if (i < w.nr) {
#pragma unroll
        for (int c = 0; c < Tile::TN; ++c)
          if (j0 + c < n) out(w.r0 + i, j0 + c, acc[r][c]);
      }
    }
  }
}

// out(i, s) for this CTA's rows of A @ x, x(l) a whole vector: one row per
// thread, the fmaf chain over l.
template <int CS, class X, class Out>
__device__ __forceinline__ void wmv(const Wide<CS>& w, const float* A, X x,
                                    Out out) {
  for (int i = threadIdx.x; i < w.nr; i += blockDim.x)
    out(w.r0 + i, vsm::dot<vsm::kF32, vsm::kF32>(A + i * w.ld, w.n, x));
}

// Newton-Schulz inverse of A from the seed in m (both written, then
// synchronised): m <- m (2I - A m) `iters` times through the scratch slot
// s. Returns synchronised with the result in m; m2 is then free.
template <int CS>
__device__ __forceinline__ void wns(const Wide<CS>& w, const float* A,
                                    float*& m, float*& m2, float* s,
                                    int iters) {
  for (int q = 0; q < iters; ++q) {
    const float* mc = m;
    wmm(w, A, mc, [=](int i, int j, float v) {
      s[w.e(i, j)] = (i == j ? 2.f : 0.f) - v;
    });
    w.sync();
    float* mo = m2;
    wmm(w, mc, s, [=](int i, int j, float v) { mo[w.e(i, j)] = v; });
    w.sync();
    m2 = m;
    m = mo;
  }
}

// this CTA's rows of a lanes-layout (n, n, S) input into a slot
template <int CS>
__device__ __forceinline__ void load_m(const Wide<CS>& w, float* X,
                                       const float* __restrict__ g) {
  const int n = w.n;
  for (int e = threadIdx.x; e < w.nr * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    X[i * w.ld + j] = g[w.m(w.r0 + i, j)];
  }
}

// this CTA's rows of t2mm = (d_i d_j) t into a slot
template <int CS>
__device__ __forceinline__ void t2mm(const Wide<CS>& w, float* X,
                                     const float* T, const float* dv) {
  const int n = w.n;
  for (int e = threadIdx.x; e < w.nr * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    X[i * w.ld + j] = (dv[w.r0 + i] * dv[j]) * T[i * w.ld + j];
  }
}

template <int CS>
__global__ void __launch_bounds__(WideTile<CS>::kThreads, 1)
lanes_wide_kernel(const float* __restrict__ c_rmp,
                  const float* __restrict__ c_rpm,
                  const float* __restrict__ c_tpp,
                  const float* __restrict__ c_tmm,
                  const float* __restrict__ c_jp,
                  const float* __restrict__ c_jm,
                  const float* __restrict__ r_f, const float* __restrict__ t,
                  const float* __restrict__ jp, const float* __restrict__ jm_f,
                  const float* __restrict__ ek_in,
                  const float* __restrict__ d, float* __restrict__ o_rmp,
                  float* __restrict__ o_rpm, float* __restrict__ o_tpp,
                  float* __restrict__ o_tmm, float* __restrict__ o_jp,
                  float* __restrict__ o_jm, int S, int n, int rs, int ld,
                  Schedule sch) {
  extern __shared__ float smem[];
  Wide<CS> w;
  w.p = blockIdx.x / CS;
  if (w.p >= S) return;  // the whole cluster: it holds one point
  w.rank = CS == 1 ? 0 : (int)cg::this_cluster().block_rank();
  w.n = n;
  w.ld = ld;
  w.rs = rs;
  w.r0 = w.rank * rs;
  w.nr = min(rs, n - w.r0);
  w.S = (size_t)S;
  const int sq = rs * ld, nv = round4(n);
  // six slots: R, T and four free ones that the steps below rotate
  float* R = smem;
  float* T = smem + sq;
  float* F0 = smem + 2 * sq;
  float* F1 = smem + 3 * sq;
  float* F2 = smem + 4 * sq;
  float* F3 = smem + 5 * sq;
  float* dv = smem + 6 * sq;
  float* JP = dv + nv;
  float* JM = dv + 2 * nv;
  float* V1 = dv + 3 * nv;
  float* V2 = dv + 4 * nv;
  float* W1 = dv + 5 * nv;
  float* W2 = dv + 6 * nv;
  float* W3 = dv + 7 * nv;

  load_m(w, R, r_f);
  load_m(w, T, t);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    dv[i] = d[i];
    JP[i] = jp[w.v(i)];
    JM[i] = jm_f[w.v(i)];
  }
  float ek = ek_in[w.p];
  w.sync();

  // ---- 1. doubling (flipped space) ----------------------------------------
  for (int step = 0; step < sch.nd; ++step) {
    {  // A = I - R R (F0), M0 = 2I - A (F1)
      float* A = F0;
      float* M0 = F1;
      wmm(w, R, R, [=](int i, int j, float s) {
        vsm::ns_seed(A, M0, w.e(i, j), i == j, s);
      });
    }
    w.sync();
    float* m = F1;
    float* m2 = F2;
    wns(w, F0, m, m2, F3, sch.it[step]);
    // X = R T (F0); V1 = J1M + R JP, V2 = JP + R J1M (J1M = JM ek)
    float* X = F0;
    float* Y = F3;
    float* Z = m2;
    const float* M = m;
    wmm(w, R, T, [=](int i, int j, float s) { X[w.e(i, j)] = s; });
    wmv(w, R, [=](int l) { return JP[l]; }, [=](int i, float s) {
      w.put(V1, i, __fadd_rn(__fmul_rn(JM[i], ek), s));
    });
    wmv(w, R, [=](int l) { return __fmul_rn(JM[l], ek); },
        [=](int i, float s) { w.put(V2, i, __fadd_rn(JP[i], s)); });
    w.sync();
    // Y = M X, Z = M T, W1 = M V1, W2 = M V2
    wmm(w, M, X, [=](int i, int j, float s) { Y[w.e(i, j)] = s; });
    wmm(w, M, T, [=](int i, int j, float s) { Z[w.e(i, j)] = s; });
    wmv(w, M, [=](int l) { return V1[l]; },
        [=](int i, float s) { w.put(W1, i, s); });
    wmv(w, M, [=](int l) { return V2[l]; },
        [=](int i, float s) { w.put(W2, i, s); });
    w.sync();
    // R += T Y; T' = T Z (X's slot); JM += T W1; JP = JP ek + T W2
    wmm(w, T, Y, [=](int i, int j, float s) {
      R[w.e(i, j)] = __fadd_rn(R[w.e(i, j)], s);
    });
    wmm(w, T, Z, [=](int i, int j, float s) { X[w.e(i, j)] = s; });
    wmv(w, T, [=](int l) { return W1[l]; },
        [=](int i, float s) { w.put(JM, i, __fadd_rn(JM[i], s)); });
    wmv(w, T, [=](int l) { return W2[l]; }, [=](int i, float s) {
      w.put(JP, i, __fadd_rn(__fmul_rn(JP[i], ek), s));
    });
    w.sync();
    F0 = T;
    T = X;
    F1 = m;
    F2 = m2;
    ek = __fmul_rn(ek, ek);
  }

  // ---- 2. un-flip R <- D R (r2mp), JM <- D JM (j2m); c_rpm, c_jp ----------
  for (int e = threadIdx.x; e < w.nr * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    R[i * ld + j] = dv[w.r0 + i] * R[i * ld + j];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    JM[i] = dv[i] * JM[i];  // every CTA its own copy
    V1[i] = c_jp[w.v(i)];
  }
  load_m(w, F0, c_rpm);
  w.sync();

  // ---- 3. interaction under the composite (two NS solves) -----------------
  const float* CJP = V1;
  float* VX1 = V2;  // r2mp c_jp + j2m
  float* VX2 = W1;  // c_jp + c_rpm j2m
  float* Y1C = W2;
  float* Y2C = W3;
  {  // a1 = I - r2mp c_rpm (F1), its seed (F2)
    float* A = F1;
    float* M0 = F2;
    wmm(w, R, F0, [=](int i, int j, float s) {
      vsm::ns_seed(A, M0, w.e(i, j), i == j, s);
    });
  }
  wmv(w, R, [=](int l) { return CJP[l]; },
      [=](int i, float s) { w.put(VX1, i, __fadd_rn(s, JM[i])); });
  {
    const float* CRPM = F0;
    wmv(w, CRPM, [=](int l) { return JM[l]; },
        [=](int i, float s) { w.put(VX2, i, __fadd_rn(CJP[i], s)); });
  }
  w.sync();
  // solve 1: M1 = NS inverse of a1 (F0, c_rpm's slot, is its scratch)
  float* m = F2;
  float* m2 = F3;
  wns(w, F1, m, m2, F0, sch.ni);
  {
    const float* M1 = m;
    float* G0 = F0;
    float* G1 = F1;
    float* G2 = m2;
    load_m(w, G0, c_tpp);
    w.sync();
    wmm(w, R, G0, [=](int i, int j, float s) { G1[w.e(i, j)] = s; });
    w.sync();
    // y1 = M1 x1: M1 (r2mp c_tpp) -> G0, M1 (r2mp c_jp + j2m) -> Y1C
    wmm(w, M1, G1, [=](int i, int j, float s) { G0[w.e(i, j)] = s; });
    wmv(w, M1, [=](int l) { return VX1[l]; },
        [=](int i, float s) { w.put(Y1C, i, s); });
    w.sync();
    load_m(w, G1, c_tmm);
    t2mm(w, G2, T, dv);
    w.sync();
    // o_rmp = c_rmp + c_tmm y1a, o_jm = c_jm + c_tmm y1c
    wmm(w, G1, G0, [=](int i, int j, float s) {
      o_rmp[w.m(i, j)] = __fadd_rn(c_rmp[w.m(i, j)], s);
    });
    wmv(w, G1, [=](int l) { return Y1C[l]; },
        [=](int i, float s) { o_jm[w.v(i)] = __fadd_rn(c_jm[w.v(i)], s); });
    w.sync();
    // o_tmm = c_tmm (M1 t2mm)
    wmm(w, M1, G2, [=](int i, int j, float s) { G0[w.e(i, j)] = s; });
    w.sync();
    wmm(w, G1, G0, [=](int i, int j, float s) { o_tmm[w.m(i, j)] = s; });
    // solve 2's c_rpm into M1's slot (no longer read)
    float* H = m;
    load_m(w, H, c_rpm);
    w.sync();
    {  // a2 = I - c_rpm r2mp (G2), its seed (G0)
      float* A = G2;
      float* M0 = G0;
      wmm(w, H, R, [=](int i, int j, float s) {
        vsm::ns_seed(A, M0, w.e(i, j), i == j, s);
      });
    }
    w.sync();
    // solve 2: M2 = NS inverse of a2 (H, c_rpm's slot, is its scratch)
    m = G0;
    m2 = G1;
    wns(w, G2, m, m2, H, sch.ni);
    const float* M2 = m;
    float* K0 = H;
    float* K1 = G2;
    float* K2 = m2;
    load_m(w, K0, c_rpm);
    t2mm(w, K1, T, dv);
    w.sync();
    wmm(w, K0, K1, [=](int i, int j, float s) { K2[w.e(i, j)] = s; });
    w.sync();
    // y2 = M2 x2: M2 (c_rpm t2mm) -> K0, M2 (c_jp + c_rpm j2m) -> Y2C
    wmm(w, M2, K2, [=](int i, int j, float s) { K0[w.e(i, j)] = s; });
    wmv(w, M2, [=](int l) { return VX2[l]; },
        [=](int i, float s) { w.put(Y2C, i, s); });
    w.sync();
    // o_rpm = r2pm + t y2b (r2pm = (d_i d_j) r2mp), o_jp = jp + t y2c
    wmm(w, T, K0, [=](int i, int j, float s) {
      o_rpm[w.m(i, j)] = __fadd_rn((dv[i] * dv[j]) * R[w.e(i, j)], s);
    });
    wmv(w, T, [=](int l) { return Y2C[l]; },
        [=](int i, float s) { o_jp[w.v(i)] = __fadd_rn(JP[i], s); });
    load_m(w, K1, c_tpp);
    w.sync();
    // o_tpp = t (M2 c_tpp)
    wmm(w, M2, K1, [=](int i, int j, float s) { K2[w.e(i, j)] = s; });
    w.sync();
    wmm(w, T, K2, [=](int i, int j, float s) { o_tpp[w.m(i, j)] = s; });
  }
  // no CTA leaves while another may still read its shared memory
  if constexpr (CS > 1) w.sync();
}

}  // namespace

// Launch one lanes-layout layer step on the team path (N <= 63) on
// `stream`: composite (N, N, S) x 4 + (N, S) x 2, elemental r_f, t
// (N, N, S), jp, jm_f (N, S), ek (S), d (N), outputs like the composite; ld
// is the arena's padded row stride (>= n, a multiple of 4), pts_per_block
// the teams of a block. Returns the launch's cudaError_t.
extern "C" int vsm_lanes(
    const float* c_rmp, const float* c_rpm, const float* c_tpp,
    const float* c_tmm, const float* c_jp, const float* c_jm,
    const float* r_f, const float* t, const float* jp, const float* jm_f,
    const float* ek, const float* d, float* o_rmp, float* o_rpm,
    float* o_tpp, float* o_tmm, float* o_jp, float* o_jm, int S, int n,
    int ld, const int* sched, int nd, int ni, int pts_per_block,
    int smem_bytes, void* stream) {
  if (S <= 0) return 0;
  if (n < 1 || nd < 0 || nd > kMaxSched || ni < 0)
    return (int)cudaErrorInvalidValue;
  const size_t need =
      (size_t)(round4(n) + pts_per_block * lanes_arena_floats(n, ld))
      * sizeof(float);
  const int tt = vsm::team_threads(n, ld, pts_per_block, need, smem_bytes);
  if (tt < 0) return (int)cudaErrorInvalidValue;
  const Schedule s = vsm::make_schedule(sched, nd, ni);
  const int blocks = (S + pts_per_block - 1) / pts_per_block;
  return vsm::with_class(n, [&](auto c) {
    auto* kern = lanes_team_kernel<decltype(c)>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<blocks, pts_per_block * tt, smem_bytes, (cudaStream_t)stream>>>(
        c_rmp, c_rpm, c_tpp, c_tmm, c_jp, c_jm, r_f, t, jp, jm_f, ek, d,
        o_rmp, o_rpm, o_tpp, o_tmm, o_jp, o_jm, S, n, ld, pts_per_block, s);
    return (int)cudaGetLastError();
  });
}

// Launch one lanes-layout layer step on the wide path on `stream`: the
// operands of vsm_lanes; cs CTAs a point (1 or 2, one cluster), each
// owning rs rows (rs = n for cs = 1, else a multiple of 4 with
// (cs - 1) rs < n <= cs rs) at row stride ld (>= n, a multiple of 4),
// `threads` a CTA (whole warps, at most WideTile<cs>::kThreads) and
// smem_bytes of dynamic shared memory each. Returns the launch's
// cudaError_t.
extern "C" int vsm_lanes_wide(
    const float* c_rmp, const float* c_rpm, const float* c_tpp,
    const float* c_tmm, const float* c_jp, const float* c_jm,
    const float* r_f, const float* t, const float* jp, const float* jm_f,
    const float* ek, const float* d, float* o_rmp, float* o_rpm,
    float* o_tpp, float* o_tmm, float* o_jp, float* o_jm, int S, int n,
    int cs, int rs, int ld, int threads, const int* sched, int nd, int ni,
    int smem_bytes, void* stream) {
  if (S <= 0) return 0;
  const bool rows_ok = cs == 1 ? rs == n
                               : rs % 4 == 0 && (cs - 1) * rs < n
                                     && n <= cs * rs;
  if (n < 1 || nd < 0 || nd > kMaxSched || ni < 0 || !rows_ok || ld < n
      || ld % 4 != 0 || threads < 32 || threads % 32 != 0
      || threads > (cs == 1 ? WideTile<1>::kThreads : WideTile<2>::kThreads)
      || (size_t)smem_bytes < sizeof(float) * wide_arena_floats(n, rs, ld)
      || (long long)S * cs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Schedule s = vsm::make_schedule(sched, nd, ni);
  auto run = [&](auto* kern) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(S * cs);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cs > 1 ? 1 : 0;
    e = cudaLaunchKernelEx(&cfg, kern, c_rmp, c_rpm, c_tpp, c_tmm, c_jp,
                           c_jm, r_f, t, jp, jm_f, ek, d, o_rmp, o_rpm, o_tpp,
                           o_tmm, o_jp, o_jm, S, n, rs, ld, s);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  };
  if (cs == 1) return run(lanes_wide_kernel<1>);
  if (cs == 2) return run(lanes_wide_kernel<2>);
  return (int)cudaErrorInvalidValue;
}
