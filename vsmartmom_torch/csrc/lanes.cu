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
// Wide path (N > 63, lanes_wide_kernel; any N: the tile classes of
// rt_device.cuh stop at NP = 64): a warp covers 32 consecutive points,
// every load and store of a warp is one coalesced line, and the state and
// scratch live in a device-memory workspace in the same layout,
// (6 N^2 + 6 N) S floats, allocated by the wrapper. A block is 32 points x
// R row threads (R = min(N, 16)); the thread (s, r) computes rows r, r + R,
// ... of each product for point s, and __syncthreads() separates dependent
// products. Every operand of every product is re-read from the cache
// hierarchy.

#include <cuda_runtime.h>

#include "rt_device.cuh"

namespace {

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

constexpr int kLanes = 32;        // points per block (one warp's width)
constexpr int kMaxRows = 16;      // row threads per point

struct L {
  int n;
  size_t S;      // lane stride
  int s;         // this thread's point
  bool live;     // s < S
  __device__ float& m(float* x, int i, int j) const {
    return x[((size_t)i * n + j) * S + s];
  }
  __device__ float m(const float* x, int i, int j) const {
    return x[((size_t)i * n + j) * S + s];
  }
  __device__ float& v(float* x, int i) const { return x[(size_t)i * S + s]; }
  __device__ float v(const float* x, int i) const {
    return x[(size_t)i * S + s];
  }
};

// C = A @ B (+ D): this thread's rows of point s; D may be nullptr or alias
// C. Sum over k in order, then the addend, as the TPU body.
__device__ inline void lmm(const L& l, float* C, const float* A,
                           const float* B, const float* D) {
  if (!l.live) return;
  const int n = l.n;
  for (int i = threadIdx.y; i < n; i += blockDim.y)
    for (int j = 0; j < n; ++j) {
      float acc = 0.f;
      for (int k = 0; k < n; ++k) acc = fmaf(l.m(A, i, k), l.m(B, k, j), acc);
      l.m(C, i, j) = D ? l.m(D, i, j) + acc : acc;
    }
}

// c = A @ v (+ e): this thread's rows
__device__ inline void lmv(const L& l, float* c, const float* A,
                           const float* v, const float* e) {
  if (!l.live) return;
  const int n = l.n;
  for (int i = threadIdx.y; i < n; i += blockDim.y) {
    float acc = 0.f;
    for (int k = 0; k < n; ++k) acc = fmaf(l.m(A, i, k), l.v(v, k), acc);
    l.v(c, i) = e ? l.v(e, i) + acc : acc;
  }
}

// X = c I - X on this thread's rows (c = 1 or 2)
__device__ inline void eye_minus(const L& l, float* X, float c) {
  if (!l.live) return;
  for (int i = threadIdx.y; i < l.n; i += blockDim.y)
    for (int j = 0; j < l.n; ++j)
      l.m(X, i, j) = (i == j ? c : 0.f) - l.m(X, i, j);
}

// Newton-Schulz inverse of A = I - B: M = 2I - A, M <- M (2I - A M) iters
// times. *m and *m2 are swapped as the iterate moves; the result is *m.
// tmp is scratch. Enters and returns synchronised.
__device__ void lns(const L& l, const float* A, float** m, float** m2,
                    float* tmp, int iters) {
  if (l.live)
    for (int i = threadIdx.y; i < l.n; i += blockDim.y)
      for (int j = 0; j < l.n; ++j)
        l.m(*m, i, j) = (i == j ? 2.f : 0.f) - l.m(A, i, j);
  __syncthreads();
  for (int q = 0; q < iters; ++q) {
    lmm(l, tmp, A, *m, nullptr);
    eye_minus(l, tmp, 2.f);        // own rows only: no barrier needed
    __syncthreads();
    lmm(l, *m2, *m, tmp, nullptr);
    __syncthreads();
    float* x = *m; *m = *m2; *m2 = x;
  }
}

__global__ void __launch_bounds__(kLanes * kMaxRows)
lanes_wide_kernel(const float* __restrict__ c_rmp,
                  const float* __restrict__ c_rpm,
                  const float* __restrict__ c_tpp,
                  const float* __restrict__ c_tmm,
                  const float* __restrict__ c_jp,
                  const float* __restrict__ c_jm,
                  const float* __restrict__ r_f,
                  const float* __restrict__ t_in,
                  const float* __restrict__ jp_in,
                  const float* __restrict__ jm_in,
                  const float* __restrict__ ek_in,
                  const float* __restrict__ d, float* __restrict__ o_rmp,
                  float* __restrict__ o_rpm, float* __restrict__ o_tpp,
                  float* __restrict__ o_tmm, float* __restrict__ o_jp,
                  float* __restrict__ o_jm, float* __restrict__ ws, int S,
                  int n, Schedule sch) {
  const int s = blockIdx.x * kLanes + threadIdx.x;
  L l;
  l.n = n; l.S = (size_t)S; l.s = s; l.live = s < S;
  const size_t nn = (size_t)n * n * S, nv = (size_t)n * S;
  float* R = ws;
  float* T = ws + nn;
  float* A = ws + 2 * nn;
  float* M = ws + 3 * nn;
  float* M2 = ws + 4 * nn;
  float* TMP = ws + 5 * nn;
  float* JP = ws + 6 * nn;
  float* JM = JP + nv;
  float* V1 = JP + 2 * nv;
  float* V2 = JP + 3 * nv;
  float* W1 = JP + 4 * nv;
  float* W2 = JP + 5 * nv;

  float ek = l.live ? ek_in[s] : 0.f;
  if (l.live)
    for (int i = threadIdx.y; i < n; i += blockDim.y) {
      for (int j = 0; j < n; ++j) {
        l.m(R, i, j) = l.m(r_f, i, j);
        l.m(T, i, j) = l.m(t_in, i, j);
      }
      l.v(JP, i) = l.v(jp_in, i);
      l.v(JM, i) = l.v(jm_in, i);
    }
  __syncthreads();

  // ---- 1. doubling (flipped space) ----------------------------------------
  for (int step = 0; step < sch.nd; ++step) {
    lmm(l, A, R, R, nullptr);
    eye_minus(l, A, 1.f);
    __syncthreads();
    lns(l, A, &M, &M2, TMP, sch.it[step]);
    // V1 = j1m + r jp, V2 = jp + r j1m (j1m = jm ek, as W1); A = r t
    if (l.live)
      for (int i = threadIdx.y; i < n; i += blockDim.y)
        l.v(W1, i) = l.v(JM, i) * ek;
    __syncthreads();
    lmv(l, V1, R, JP, W1);
    lmv(l, V2, R, W1, JP);
    lmm(l, A, R, T, nullptr);
    __syncthreads();
    // TMP = M (r t); W1 = M V1; W2 = M V2
    lmm(l, TMP, M, A, nullptr);
    lmv(l, W1, M, V1, nullptr);
    lmv(l, W2, M, V2, nullptr);
    __syncthreads();
    // r += t TMP; jm += t W1; jp = jp ek + t W2; A = M t
    lmm(l, R, T, TMP, R);
    if (l.live)
      for (int i = threadIdx.y; i < n; i += blockDim.y) {
        float a1 = 0.f, a2 = 0.f;
        for (int k = 0; k < n; ++k) {
          a1 = fmaf(l.m(T, i, k), l.v(W1, k), a1);
          a2 = fmaf(l.m(T, i, k), l.v(W2, k), a2);
        }
        l.v(JM, i) = l.v(JM, i) + a1;
        l.v(JP, i) = l.v(JP, i) * ek + a2;
      }
    lmm(l, A, M, T, nullptr);
    __syncthreads();
    // t = t (M t)
    lmm(l, TMP, T, A, nullptr);
    __syncthreads();
    float* x = T; T = TMP; TMP = x;
    ek = ek * ek;
  }

  // ---- 2. un-flip: R <- D R (r2mp), JM <- D JM (j2m) ----------------------
  if (l.live)
    for (int i = threadIdx.y; i < n; i += blockDim.y) {
      for (int j = 0; j < n; ++j) l.m(R, i, j) = d[i] * l.m(R, i, j);
      l.v(JM, i) = d[i] * l.v(JM, i);
    }
  __syncthreads();

  // ---- 3. interaction under the composite (two NS solves) -----------------
  lmm(l, A, R, c_rpm, nullptr);
  eye_minus(l, A, 1.f);
  __syncthreads();
  lns(l, A, &M, &M2, TMP, sch.ni);
  // V1 = r2mp c_jp + j2m; A = r2mp c_tpp; M2 = t2mm
  lmv(l, V1, R, c_jp, JM);
  lmm(l, A, R, c_tpp, nullptr);
  if (l.live)
    for (int i = threadIdx.y; i < n; i += blockDim.y)
      for (int j = 0; j < n; ++j)
        l.m(M2, i, j) = (d[i] * d[j]) * l.m(T, i, j);
  __syncthreads();
  // W1 = M1 V1; TMP = M1 A
  lmv(l, W1, M, V1, nullptr);
  lmm(l, TMP, M, A, nullptr);
  __syncthreads();
  // o_jm = c_jm + c_tmm W1; o_rmp = c_rmp + c_tmm TMP; A = M1 t2mm
  lmv(l, o_jm, c_tmm, W1, c_jm);
  lmm(l, o_rmp, c_tmm, TMP, c_rmp);
  lmm(l, A, M, M2, nullptr);
  __syncthreads();
  lmm(l, o_tmm, c_tmm, A, nullptr);
  __syncthreads();

  lmm(l, A, c_rpm, R, nullptr);
  eye_minus(l, A, 1.f);
  __syncthreads();
  lns(l, A, &M, &M2, TMP, sch.ni);
  // V1 = c_jp + c_rpm j2m; M2 = t2mm (M2 is free after the solve)
  lmv(l, V1, c_rpm, JM, c_jp);
  if (l.live)
    for (int i = threadIdx.y; i < n; i += blockDim.y)
      for (int j = 0; j < n; ++j)
        l.m(M2, i, j) = (d[i] * d[j]) * l.m(T, i, j);
  __syncthreads();
  // W1 = M2 V1; A = c_rpm t2mm; TMP = M2 c_tpp
  lmv(l, W1, M, V1, nullptr);
  lmm(l, A, c_rpm, M2, nullptr);
  lmm(l, TMP, M, c_tpp, nullptr);
  __syncthreads();
  // o_jp = jp + t W1; o_tpp = t TMP; M2 = M (c_rpm t2mm)
  lmv(l, o_jp, T, W1, JP);
  lmm(l, o_tpp, T, TMP, nullptr);
  lmm(l, M2, M, A, nullptr);
  __syncthreads();
  // o_rpm = r2pm + t M2
  if (l.live)
    for (int i = threadIdx.y; i < n; i += blockDim.y)
      for (int j = 0; j < n; ++j) {
        float acc = 0.f;
        for (int k = 0; k < n; ++k)
          acc = fmaf(l.m(T, i, k), l.m(M2, k, j), acc);
        l.m(o_rpm, i, j) = (d[i] * d[j]) * l.m(R, i, j) + acc;
      }
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

// Launch one lanes-layout layer step on the wide path (any N) on `stream`:
// the operands of vsm_lanes and a workspace of (6 N^2 + 6 N) S floats.
// Returns the launch's cudaError_t.
extern "C" int vsm_lanes_wide(
    const float* c_rmp, const float* c_rpm, const float* c_tpp,
    const float* c_tmm, const float* c_jp, const float* c_jm,
    const float* r_f, const float* t, const float* jp, const float* jm_f,
    const float* ek, const float* d, float* o_rmp, float* o_rpm,
    float* o_tpp, float* o_tmm, float* o_jp, float* o_jm, float* ws, int S,
    int n, const int* sched, int nd, int ni, void* stream) {
  if (S <= 0) return 0;
  if (n < 1 || nd < 0 || nd > kMaxSched || ni < 0)
    return (int)cudaErrorInvalidValue;
  const Schedule s = vsm::make_schedule(sched, nd, ni);
  const dim3 block(kLanes, n < kMaxRows ? n : kMaxRows);
  const int blocks = (S + kLanes - 1) / kLanes;
  lanes_wide_kernel<<<blocks, block, 0, (cudaStream_t)stream>>>(
      c_rmp, c_rpm, c_tpp, c_tmm, c_jp, c_jm, r_f, t, jp, jm_f, ek, d, o_rmp,
      o_rpm, o_tpp, o_tmm, o_jp, o_jm, ws, S, n, s);
  return (int)cudaGetLastError();
}
