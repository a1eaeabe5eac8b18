// Fused RT layer scan for Hopper: one launch runs a whole schedule bucket of
// consecutive layers (same ndoubl, NS schedule and ni) under the composite.
//
// Replaces the TPU kernel vsmartmom/pallas/layer_scan_kernel.py:_kernel,
// reached from fused_layer_scan. Per layer: Z mixing Z = sum_k zw_k Z_k, the
// elemental single-scattering layer in flipped space (core/rt.py:elemental /
// elemental_flipped: the wct2 <= 1e-8 column mask, the same_mu and mu0-node
// degenerate limits, expm1 arguments as one subtraction of exact node
// values, atten = exp(-tau_sum / mu0_node)), the scheduled Newton-Schulz
// doubling (the doubling phase shared with layer_step.cu), the D-unflip and
// the two-solve interaction under the composite (core/rt.py:interaction
// with a schulz right-solve of ni iterations). Where the TPU kernel uses a
// 6-term Taylor expm1 (Mosaic has none), this kernel uses expm1f.
//
// On the TPU the layer axis was the innermost sequential grid dimension and
// the composite stayed in VMEM scratch between grid steps. On Hopper blocks
// run in no order, so the layer loop lives inside the kernel: a team of
// whole warps owns one spectral point and loops over the bucket's layers
// itself, and the point's composite stays in shared memory for the whole
// bucket. Device memory sees the input composite once, the per-layer
// scalars (tau, omega, tau_sum, zw) and the output composite once.
//
// Bound: as the layer step, a chain of small dependent N x N fp32 products
// per point (O(N^3) FMAs against O(N^2) bytes), so arithmetic and the
// shared-memory loads that feed it, not device memory. Design: the team
// helpers of rt_device.cuh (one warp per point at N <= 16, 2 / 6 / 8 warps
// for the width classes 32 / 48 / 64; register-tiled products with the
// elementwise passes fused into their stores; each team synchronises only
// itself). Every output is the fmaf chain of the block-wide version over l in
// order, with the same association of every product and both solves.
//
// Per-point arena (floats; sq = n ld, ld the padded row stride, every slot
// on 16 bytes): the doubling phase's Arena (R, T, A, M0, M1, TMP, JP, JM,
// W1, W2) followed by the composite
//   CRMP [sq] | CRPM [sq] | CTPP [sq] | CTMM [sq] | CJP [n4] | CJM [n4]
// (n4 = round4(n)): one point at N = 44 is 111 KB, and N <= 64 fits one
// point in a block's 227 KB (N = 63, 64 with ld = 64). The Z mixtures
// and the interaction's operands reuse the doubling scratch. Z_c, qp, wct2,
// i0 and d are read from device memory (they are shared by every point and
// stay in cache).
//
// The elemental layer rounds as the torch version does: a sum of a product
// is rounded twice (__fmul_rn, __fadd_rn), never contracted into one FMA.
// The doubling multiplies the transmission diagonal by itself 2^ndoubl
// times, so one ulp of difference there grows 256-fold at ndoubl = 8.

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
using vsm::Schedule;
using vsm::Team;

__host__ __device__ inline int scan_arena_floats(int n, int ld) {
  return doubling_arena_floats(n, ld) + 4 * n * ld + 2 * vsm::round4(n);
}

struct ScanArgs {
  int n, ld, nz, K, S, i_mu0_n, n_stokes;
  float mu0, mu0_node, wct02, inv_scale;
};

// e^-b - e^-a from e_b, e_a and arg = a - b, as core/rt.py:exp_difference:
// beyond arg = 80 e_a is negligible and e_a * expm1f(arg) would be 0 * inf.
// expm1f runs on every element (its argument clamped to the cut), so the
// select adds no branch to the element loop.
__device__ __forceinline__ float exp_difference(float e_b, float e_a,
                                                float arg) {
  const float d = e_a * expm1f(fminf(arg, 80.f));
  return arg > 80.f ? e_b : d;
}

// Z mixtures of layer z into A (z_pp) and M0 (z_mp), the elemental layer in
// flipped space into R, T (the current slot), JP, JM. Returns the layer's
// e^(-dtau/mu0), synchronised.
template <class C>
__device__ __forceinline__ float
elemental_phase(const Team<C>& tm, float* ar, const Arena& o, int p, int z,
                const ScanArgs& a, const float* __restrict__ tau,
                const float* __restrict__ omega,
                const float* __restrict__ tau_sum,
                const float* __restrict__ zw, const float* __restrict__ zpp_c,
                const float* __restrict__ zmp_c, const float* __restrict__ qp,
                const float* __restrict__ wct2, const float* __restrict__ i0,
                const float* __restrict__ d) {
  const int n = a.n, ld = a.ld, nn = n * n, S = a.S, K = a.K;
  const size_t lz = (size_t)z * S;
  const float dt = tau[lz + p] * a.inv_scale;
  const float om = omega[lz + p];
  float* ZPP = ar + o.oA;
  float* ZMP = ar + o.oM0;
  float* R = ar + o.oR;
  float* T = ar + o.oT;
  each(tm, n, n, [&](int i, int j) {
    float zpp = 0.f, zmp = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = zw[((size_t)z * K + k) * S + p];
      zpp = __fadd_rn(zpp, __fmul_rn(w, zpp_c[k * nn + i * n + j]));
      zmp = __fadd_rn(zmp, __fmul_rn(w, zmp_c[k * nn + i * n + j]));
    }
    ZPP[i * ld + j] = zpp;
    ZMP[i * ld + j] = zmp;
    const float mu_i = qp[i], mu_j = qp[j], w_j = wct2[j];
    const float exp_i = 1.f + expm1f(-dt / mu_i);
    float r = om * zmp * (mu_j / (mu_i + mu_j)) * w_j
              * (-expm1f(-dt * (1.f / mu_i + 1.f / mu_j)));
    float t;
    if (!(w_j > 1e-8f)) {
      // zero-weight (camera-only) column: the attenuated beam only
      r = 0.f;
      t = i == j ? exp_i : 0.f;
    } else if (mu_i == mu_j) {
      // two distinct nodes at one mu (a view merged with a quadrature node
      // in float32) take the diagonal's scattered part, as elemental does;
      // the Stokes components of one node keep no off-diagonal term
      const float e = __fmul_rn(exp_i, om * zpp * (dt / mu_i) * w_j);
      t = i == j ? __fadd_rn(exp_i, e)
                 : (i / a.n_stokes != j / a.n_stokes ? e : 0.f);
    } else {
      const float exp_diff = exp_difference(
          exp_i, 1.f + expm1f(-dt / mu_j),
          dt * (mu_i - mu_j) / (mu_i * mu_j));
      t = om * zpp * (mu_j / (mu_i - mu_j)) * w_j * exp_diff;
    }
    R[i * ld + j] = d[i] * r;
    T[i * ld + j] = t;
  });
  tm.sync();
  each_row(tm, n, [&](int i) {
    const float mu_i = qp[i], mu0n = a.mu0_node;
    float zpp_i0 = 0.f, zmp_i0 = 0.f;
    for (int j = 0; j < n; ++j) {
      zpp_i0 = fmaf(ZPP[i * ld + j], i0[j], zpp_i0);
      zmp_i0 = fmaf(ZMP[i * ld + j], i0[j], zmp_i0);
    }
    const bool same0 = (i >= a.i_mu0_n && i < a.i_mu0_n + a.n_stokes)
                       || mu_i == mu0n;
    float jp;
    if (same0) {
      jp = (dt / mu_i) * (1.f + expm1f(-dt / mu_i));
    } else {
      const float exp_diff0 = exp_difference(
          1.f + expm1f(-dt / mu_i), 1.f + expm1f(-dt / mu0n),
          dt * (mu_i - mu0n) / (mu_i * mu0n));
      jp = (mu0n / (mu_i - mu0n)) * exp_diff0;
    }
    jp = a.wct02 * om * zpp_i0 * jp;
    float jm = a.wct02 * om * zmp_i0 * (mu0n / (mu_i + mu0n))
               * (-expm1f(-dt * (1.f / mu_i + 1.f / mu0n)));
    const float atten = expf(-tau_sum[lz + p] / mu0n);
    ar[o.oJP + i] = jp * atten;
    ar[o.oJM + i] = d[i] * (jm * atten);
  });
  tm.sync();
  return 1.f + expm1f(-dt / a.mu0);
}

// The doubled layer (R = D-flipped r, T, JP, JM) added under the composite
// C at oC with two Newton-Schulz solves (core/rt.py:interaction):
//   t01 = c_tmm M(I - r2mp c_rpm), t21 = t M(I - c_rpm r2mp),
//   r_mp' = c_rmp + t01 r2mp c_tpp, t_mm' = t01 t2mm,
//   j_m'  = c_jm + t01 (r2mp c_jp + j2m),
//   r_pm' = r2pm + t21 c_rpm t2mm, t_pp' = t21 c_tpp,
//   j_p'  = jp + t21 (c_jp + c_rpm j2m).
// Returns synchronised.
template <class C>
__device__ __forceinline__ void
interaction_phase(const Team<C>& tm, float* ar, const Arena& o, int oC,
                  int ni, const float* __restrict__ d) {
  const int n = o.n, ld = o.ld, w2 = o.w2, sq = n * ld, wy = 2 * n + 1;
  float* R = ar + o.oR;
  const float* T = ar + o.oT;
  const float* JP = ar + o.oJP;
  float* JM = ar + o.oJM;
  float* A = ar + o.oA;
  float* M0 = ar + o.oM0;
  float* W1 = ar + o.oW1;
  float* W2 = ar + o.oW2;
  float* CRMP = ar + oC;
  float* CRPM = CRMP + sq;
  float* CTPP = CRMP + 2 * sq;
  float* CTMM = CRMP + 3 * sq;
  float* CJP = CRMP + 4 * sq;
  float* CJM = CJP + vsm::round4(n);

  // un-flip: R <- D R (r2mp), JM <- D JM (j2m); W2[:, n:2n] = t2mm, and an
  // aligned copy in W1[:, 0:n] (the B of c_rpm t2mm)
  each(tm, n, n, [=](int i, int j) {
    R[i * ld + j] = d[i] * R[i * ld + j];
    const float t2 = (d[i] * d[j]) * T[i * ld + j];
    W2[i * w2 + n + j] = t2;
    W1[i * w2 + j] = t2;
  });
  each_row(tm, n, [=](int i) { JM[i] = d[i] * JM[i]; });
  tm.sync();

  // ---- upward half ---------------------------------------------------------
  // A = I - r2mp c_rpm (and the NS seed);
  // W2[:, 0:n] = r2mp c_tpp, W2[:, 2n] = r2mp c_jp + j2m
  mm(tm, n, n, R, ld, CRPM, ld, [=](int i, int j, float s) {
    ns_seed(A, M0, i * ld + j, i == j, s);
  });
  mm(tm, n, n, R, ld, CTPP, ld,
     [=](int i, int j, float s) { W2[i * w2 + j] = s; });
  mv(tm, n, R, ld, [=](int l) { return CJP[l]; },
     [=](int i, float s) { W2[i * w2 + 2 * n] = __fadd_rn(s, JM[i]); });
  tm.sync();
  const float* M = ar + ns(tm, ar, n, ld, o.oA, o.oM0, o.oM1, o.oTMP, ni);
  // t01 = c_tmm M -> A
  mm(tm, n, n, CTMM, ld, M, ld,
     [=](int i, int j, float s) { A[i * ld + j] = s; });
  tm.sync();
  // t01 W2 -> r_mp += ., t_mm = ., j_m += .
  mm(tm, n, wy, A, ld, W2, w2, [=](int i, int j, float s) {
    if (j < n) {
      CRMP[i * ld + j] = __fadd_rn(CRMP[i * ld + j], s);
    } else if (j < 2 * n) {
      CTMM[i * ld + j - n] = s;
    } else {
      CJM[i] = __fadd_rn(CJM[i], s);
    }
  });
  tm.sync();

  // ---- downward half -------------------------------------------------------
  // A = I - c_rpm r2mp (and the NS seed);
  // W1 = [c_tpp (below) | c_rpm t2mm | c_jp + c_rpm j2m]
  mm(tm, n, n, CRPM, ld, R, ld, [=](int i, int j, float s) {
    ns_seed(A, M0, i * ld + j, i == j, s);
  });
  mm(tm, n, n, CRPM, ld, W1, w2,
     [=](int i, int j, float s) { W1[i * w2 + n + j] = s; });
  mv(tm, n, CRPM, ld, [=](int l) { return JM[l]; },
     [=](int i, float s) { W1[i * w2 + 2 * n] = __fadd_rn(CJP[i], s); });
  tm.sync();
  M = ar + ns(tm, ar, n, ld, o.oA, o.oM0, o.oM1, o.oTMP, ni);
  // t21 = t M -> A; W1[:, 0:n] = c_tpp
  mm(tm, n, n, T, ld, M, ld,
     [=](int i, int j, float s) { A[i * ld + j] = s; });
  each(tm, n, n,
       [=](int i, int j) { W1[i * w2 + j] = CTPP[i * ld + j]; });
  tm.sync();
  // t21 W1 -> t_pp = ., r_pm = r2pm + ., j_p = jp + .
  mm(tm, n, wy, A, ld, W1, w2, [=](int i, int j, float s) {
    if (j < n) {
      CTPP[i * ld + j] = s;
    } else if (j < 2 * n) {
      CRPM[i * ld + j - n] =
          __fadd_rn((d[i] * d[j - n]) * R[i * ld + j - n], s);
    } else {
      CJP[i] = __fadd_rn(JP[i], s);
    }
  });
  tm.sync();
}

template <class C>
__global__ void __launch_bounds__(kMaxBlock)
layer_scan_kernel(const float* __restrict__ tau,
                  const float* __restrict__ omega,
                  const float* __restrict__ tau_sum,
                  const float* __restrict__ zw,
                  const float* __restrict__ zpp_c,
                  const float* __restrict__ zmp_c,
                  const float* __restrict__ qp,
                  const float* __restrict__ wct2,
                  const float* __restrict__ i0, const float* __restrict__ d,
                  const float* __restrict__ ci_rmp,
                  const float* __restrict__ ci_rpm,
                  const float* __restrict__ ci_tpp,
                  const float* __restrict__ ci_tmm,
                  const float* __restrict__ ci_jp,
                  const float* __restrict__ ci_jm,
                  float* __restrict__ o_rmp, float* __restrict__ o_rpm,
                  float* __restrict__ o_tpp, float* __restrict__ o_tmm,
                  float* __restrict__ o_jp, float* __restrict__ o_jm,
                  ScanArgs a, int P, Schedule sch) {
  extern __shared__ float smem[];
  const int team = threadIdx.x / C::TT;
  const int p = blockIdx.x * P + team;
  if (p >= a.S) return;
  const Team<C> tm(threadIdx.x - team * C::TT, 1 + team);
  const int n = a.n, ld = a.ld, sq = n * ld;
  float* ar = smem + team * scan_arena_floats(n, ld);
  Arena o(n, ld);
  const int oC = doubling_arena_floats(n, ld);
  float* c = ar + oC;
  const size_t gm = (size_t)p * n * n, gv = (size_t)p * n;

  // seed the composite from the input composite
  each_flat(tm, n, n, [=](int i, int j) {
    const int e = i * ld + j;
    const size_t g = gm + i * n + j;
    c[e] = ci_rmp[g];
    c[sq + e] = ci_rpm[g];
    c[2 * sq + e] = ci_tpp[g];
    c[3 * sq + e] = ci_tmm[g];
  });
  const int n4 = vsm::round4(n);
  each_row(tm, n, [=](int i) {
    c[4 * sq + i] = ci_jp[gv + i];
    c[4 * sq + n4 + i] = ci_jm[gv + i];
  });
  tm.sync();

  for (int z = 0; z < a.nz; ++z) {
    const float ek = elemental_phase(tm, ar, o, p, z, a, tau, omega, tau_sum,
                                     zw, zpp_c, zmp_c, qp, wct2, i0, d);
    doubling_phase(tm, ar, o, ek, sch);
    interaction_phase(tm, ar, o, oC, sch.ni, d);
  }

  each_flat(tm, n, n, [=](int i, int j) {
    const int e = i * ld + j;
    const size_t g = gm + i * n + j;
    o_rmp[g] = c[e];
    o_rpm[g] = c[sq + e];
    o_tpp[g] = c[2 * sq + e];
    o_tmm[g] = c[3 * sq + e];
  });
  each_row(tm, n, [=](int i) {
    o_jp[gv + i] = c[4 * sq + i];
    o_jm[gv + i] = c[4 * sq + n4 + i];
  });
}

}  // namespace

// Launch one bucket of nz layers on `stream`: per-layer scalars tau, omega,
// tau_sum (nz, S) and zw (nz, K, S); Z components (K, n, n) x 2; qp, wct2,
// i0, d (n); the composite above the bucket (S, n, n) x 4 + (S, n) x 2 in,
// the composite through it out; ld the arena's padded row stride (>= n, a
// multiple of 4),
// pts_per_block the teams of a block. Returns the launch's cudaError_t.
extern "C" int vsm_layer_scan(
    const float* tau, const float* omega, const float* tau_sum,
    const float* zw, const float* zpp_c, const float* zmp_c, const float* qp,
    const float* wct2, const float* i0, const float* d, const float* ci_rmp,
    const float* ci_rpm, const float* ci_tpp, const float* ci_tmm,
    const float* ci_jp, const float* ci_jm, float* o_rmp, float* o_rpm,
    float* o_tpp, float* o_tmm, float* o_jp, float* o_jm, int S, int n,
    int ld, int nz, int K, const int* sched, int nd, int ni, int i_mu0_n,
    int n_stokes, float mu0, float mu0_node, float wct02, int pts_per_block,
    int smem_bytes, void* stream) {
  if (S <= 0) return 0;
  if (n < 1 || nz < 1 || K < 1 || nd < 0 || nd > kMaxSched || ni < 0)
    return (int)cudaErrorInvalidValue;
  const size_t need =
      (size_t)pts_per_block * scan_arena_floats(n, ld) * sizeof(float);
  const int tt = vsm::team_threads(n, ld, pts_per_block, need, smem_bytes);
  if (tt < 0) return (int)cudaErrorInvalidValue;
  const Schedule s = vsm::make_schedule(sched, nd, ni);
  ScanArgs a;
  a.n = n; a.ld = ld; a.nz = nz; a.K = K; a.S = S; a.i_mu0_n = i_mu0_n;
  a.n_stokes = n_stokes; a.mu0 = mu0; a.mu0_node = mu0_node;
  a.wct02 = wct02;
  a.inv_scale = 1.f;
  for (int i = 0; i < nd; ++i) a.inv_scale *= 0.5f;   // 2^-nd, exact
  const int blocks = (S + pts_per_block - 1) / pts_per_block;
  return vsm::with_class(n, [&](auto c) {
    auto* kern = layer_scan_kernel<decltype(c)>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<blocks, pts_per_block * tt, smem_bytes, (cudaStream_t)stream>>>(
        tau, omega, tau_sum, zw, zpp_c, zmp_c, qp, wct2, i0, d, ci_rmp,
        ci_rpm, ci_tpp, ci_tmm, ci_jp, ci_jm, o_rmp, o_rpm, o_tpp, o_tmm,
        o_jp, o_jm, a, pts_per_block, s);
    return (int)cudaGetLastError();
  });
}
