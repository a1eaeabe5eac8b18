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
// run in no order, so the layer loop lives inside the block: each block owns
// P spectral points and loops over the bucket's layers itself, and each
// point's composite stays in the block's shared memory for the whole bucket.
// Device memory sees the input composite once, the per-layer scalars (tau,
// omega, tau_sum, zw) and the output composite once.
//
// Bound: as the layer step, a chain of small dependent N x N fp32 products
// per point (O(N^3) FMAs against O(N^2) bytes), so arithmetic and
// shared-memory bandwidth, not device memory. All threads of the block sweep
// the (point, row, column) outputs of each product (rt_device.cuh).
//
// Per-point arena (floats; nn = n*n): the doubling phase's arena
// (vsm::Arena, 10 nn + 6 n + 1) followed by the composite
//   CRMP [nn] | CRPM [nn] | CTPP [nn] | CTMM [nn] | CJP [n] | CJM [n]
// = 14 nn + 8 n + 1 floats: one point at N = 44 is 110 KB, and N <= 64 fits
// one point in a block's 227 KB. The Z mixtures, the elemental layer and the
// interaction's operands reuse the doubling scratch (A, M0, M1, TMP, W1, W2).
// Z_c, qp, wct2, i0 and d are read from device memory (they are shared by
// every point and stay in cache). The ragged last block is masked.
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
using vsm::kMaxSched;
using vsm::kThreads;
using vsm::mm;
using vsm::ns_solve;
using vsm::Schedule;

__host__ __device__ inline int scan_arena_floats(int n) {
  return doubling_arena_floats(n) + 4 * n * n + 2 * n;
}

struct ScanArgs {
  int n, nz, K, S, i_mu0_n, n_stokes;
  float mu0, mu0_node, wct02, inv_scale;
};

// Z mixtures of layer z into A (z_pp) and M0 (z_mp), then the elemental
// layer in flipped space into R, T, JP, JM, EK. Returns synchronised.
__device__ void elemental_phase(float* ar, int AR, const Arena& o, int np,
                                int p0, int z, const ScanArgs& a,
                                const float* __restrict__ tau,
                                const float* __restrict__ omega,
                                const float* __restrict__ tau_sum,
                                const float* __restrict__ zw,
                                const float* __restrict__ zpp_c,
                                const float* __restrict__ zmp_c,
                                const float* __restrict__ qp,
                                const float* __restrict__ wct2,
                                const float* __restrict__ i0,
                                const float* __restrict__ d) {
  const int n = a.n, nn = n * n, S = a.S, K = a.K;
  const size_t lz = (size_t)z * S;
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn;
    float zpp = 0.f, zmp = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = zw[((size_t)z * K + k) * S + p0 + p];
      zpp = __fadd_rn(zpp, __fmul_rn(w, zpp_c[k * nn + e]));
      zmp = __fadd_rn(zmp, __fmul_rn(w, zmp_c[k * nn + e]));
    }
    ar[p * AR + o.oA + e] = zpp;
    ar[p * AR + o.oM0 + e] = zmp;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
    float* ap = ar + p * AR;
    const float dt = tau[lz + p0 + p] * a.inv_scale;
    const float om = omega[lz + p0 + p];
    const float mu_i = qp[i], mu_j = qp[j], w_j = wct2[j];
    const float zpp = ap[o.oA + e], zmp = ap[o.oM0 + e];
    const float exp_i = 1.f + expm1f(-dt / mu_i);
    float r = om * zmp * (mu_j / (mu_i + mu_j)) * w_j
              * (-expm1f(-dt * (1.f / mu_i + 1.f / mu_j)));
    float t;
    if (!(w_j > 1e-8f)) {
      // zero-weight (camera-only) column: the attenuated beam only
      r = 0.f;
      t = i == j ? exp_i : 0.f;
    } else if (mu_i == mu_j) {
      t = i == j ? __fadd_rn(exp_i, __fmul_rn(exp_i, om * zpp * (dt / mu_i)
                                                      * w_j))
                 : 0.f;
    } else {
      const float exp_diff = (1.f + expm1f(-dt / mu_j))
                             * expm1f(dt * (mu_i - mu_j) / (mu_i * mu_j));
      t = om * zpp * (mu_j / (mu_i - mu_j)) * w_j * exp_diff;
    }
    ap[o.oR + e] = d[i] * r;
    ap[o.oT + e] = t;
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    float* ap = ar + p * AR;
    const float dt = tau[lz + p0 + p] * a.inv_scale;
    const float om = omega[lz + p0 + p];
    const float mu_i = qp[i], mu0n = a.mu0_node;
    float zpp_i0 = 0.f, zmp_i0 = 0.f;
    for (int j = 0; j < n; ++j) {
      zpp_i0 = fmaf(ap[o.oA + i * n + j], i0[j], zpp_i0);
      zmp_i0 = fmaf(ap[o.oM0 + i * n + j], i0[j], zmp_i0);
    }
    const bool same0 = (i >= a.i_mu0_n && i < a.i_mu0_n + a.n_stokes)
                       || mu_i == mu0n;
    float jp;
    if (same0) {
      jp = (dt / mu_i) * (1.f + expm1f(-dt / mu_i));
    } else {
      const float exp_diff0 = (1.f + expm1f(-dt / mu0n))
                              * expm1f(dt * (mu_i - mu0n) / (mu_i * mu0n));
      jp = (mu0n / (mu_i - mu0n)) * exp_diff0;
    }
    jp = a.wct02 * om * zpp_i0 * jp;
    float jm = a.wct02 * om * zmp_i0 * (mu0n / (mu_i + mu0n))
               * (-expm1f(-dt * (1.f / mu_i + 1.f / mu0n)));
    const float atten = expf(-tau_sum[lz + p0 + p] / mu0n);
    ap[o.oJP + i] = jp * atten;
    ap[o.oJM + i] = d[i] * (jm * atten);
  }
  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    const float dt = tau[lz + p0 + p] * a.inv_scale;
    ar[p * AR + o.oEK] = 1.f + expm1f(-dt / a.mu0);
  }
  __syncthreads();
}

// The doubled layer (R = D-flipped r, T, JP, JM) added under the composite
// C with two Newton-Schulz solves (core/rt.py:interaction):
//   t01 = c_tmm M(I - r2mp c_rpm), t21 = t M(I - c_rpm r2mp),
//   r_mp' = c_rmp + t01 r2mp c_tpp, t_mm' = t01 t2mm,
//   j_m'  = c_jm + t01 (r2mp c_jp + j2m),
//   r_pm' = r2pm + t21 c_rpm t2mm, t_pp' = t21 c_tpp,
//   j_p'  = jp + t21 (c_jp + c_rpm j2m).
// Returns synchronised.
__device__ void interaction_phase(float* ar, int AR, const Arena& o, int n,
                                  int np, int oC, int ni,
                                  const float* __restrict__ d) {
  const int nn = n * n, w2 = o.w2, wy = 2 * n + 1;
  const int oR = o.oR, oT = o.oT, oJP = o.oJP, oJM = o.oJM;
  const int oA = o.oA, oW1 = o.oW1, oW2 = o.oW2;
  const int oCRMP = oC, oCRPM = oC + nn, oCTPP = oC + 2 * nn,
            oCTMM = oC + 3 * nn, oCJP = oC + 4 * nn, oCJM = oC + 4 * nn + n;

  // un-flip: R <- D R (r2mp), JM <- D JM (j2m)
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n;
    ar[p * AR + oR + e] = d[i] * ar[p * AR + oR + e];
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    ar[p * AR + oJM + i] = d[i] * ar[p * AR + oJM + i];
  }
  __syncthreads();

  // ---- upward half: W1 = r2mp [c_rpm | c_tpp | c_jp] ----------------------
  mm(ar + oW1, w2, AR, ar + oR, n, AR, ar + oCRPM, n, AR, n, n, np, false);
  mm(ar + oW1 + n, w2, AR, ar + oR, n, AR, ar + oCTPP, n, AR, n, n, np,
     false);
  mm(ar + oW1 + 2 * n, w2, AR, ar + oR, n, AR, ar + oCJP, 1, AR, n, 1, np,
     false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
    float* ap = ar + p * AR;
    ap[oA + e] = (i == j ? 1.f : 0.f) - ap[oW1 + i * w2 + j];
  }
  __syncthreads();
  int oM = ns_solve(ar, AR, n, np, oA, o.oM0, o.oM1, o.oTMP, ni);
  // t01 = c_tmm M -> A;  W2 = [r2mp c_tpp | t2mm | r2mp c_jp + j2m]
  mm(ar + oA, n, AR, ar + oCTMM, n, AR, ar + oM, n, AR, n, n, np, false);
  for (int idx = threadIdx.x; idx < np * n * wy; idx += blockDim.x) {
    const int p = idx / (n * wy), e = idx - p * n * wy;
    const int i = e / wy, j = e - i * wy;
    float* ap = ar + p * AR;
    float v;
    if (j < n) v = ap[oW1 + i * w2 + n + j];
    else if (j < 2 * n) v = (d[i] * d[j - n]) * ap[oT + i * n + (j - n)];
    else v = ap[oW1 + i * w2 + 2 * n] + ap[oJM + i];
    ap[oW2 + i * w2 + j] = v;
  }
  __syncthreads();
  // W1 = t01 W2
  mm(ar + oW1, w2, AR, ar + oA, n, AR, ar + oW2, w2, AR, n, wy, np, false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
    float* ap = ar + p * AR;
    ap[oCRMP + e] = ap[oCRMP + e] + ap[oW1 + i * w2 + j];
    ap[oCTMM + e] = ap[oW1 + i * w2 + n + j];
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    float* ap = ar + p * AR;
    ap[oCJM + i] = ap[oCJM + i] + ap[oW1 + i * w2 + 2 * n];
  }
  // W2 = [r2mp | t2mm | j2m]
  for (int idx = threadIdx.x; idx < np * n * wy; idx += blockDim.x) {
    const int p = idx / (n * wy), e = idx - p * n * wy;
    const int i = e / wy, j = e - i * wy;
    float* ap = ar + p * AR;
    float v;
    if (j < n) v = ap[oR + i * n + j];
    else if (j < 2 * n) v = (d[i] * d[j - n]) * ap[oT + i * n + (j - n)];
    else v = ap[oJM + i];
    ap[oW2 + i * w2 + j] = v;
  }
  __syncthreads();

  // ---- downward half: W1 = c_rpm [r2mp | t2mm | j2m] ----------------------
  mm(ar + oW1, w2, AR, ar + oCRPM, n, AR, ar + oW2, w2, AR, n, wy, np,
     false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
    float* ap = ar + p * AR;
    ap[oA + e] = (i == j ? 1.f : 0.f) - ap[oW1 + i * w2 + j];
  }
  __syncthreads();
  oM = ns_solve(ar, AR, n, np, oA, o.oM0, o.oM1, o.oTMP, ni);
  // t21 = t M -> A;  W2 = [c_tpp | c_rpm t2mm | c_jp + c_rpm j2m]
  mm(ar + oA, n, AR, ar + oT, n, AR, ar + oM, n, AR, n, n, np, false);
  for (int idx = threadIdx.x; idx < np * n * wy; idx += blockDim.x) {
    const int p = idx / (n * wy), e = idx - p * n * wy;
    const int i = e / wy, j = e - i * wy;
    float* ap = ar + p * AR;
    float v;
    if (j < n) v = ap[oCTPP + i * n + j];
    else if (j < 2 * n) v = ap[oW1 + i * w2 + j];
    else v = ap[oCJP + i] + ap[oW1 + i * w2 + 2 * n];
    ap[oW2 + i * w2 + j] = v;
  }
  __syncthreads();
  // W1 = t21 W2
  mm(ar + oW1, w2, AR, ar + oA, n, AR, ar + oW2, w2, AR, n, wy, np, false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
    float* ap = ar + p * AR;
    ap[oCTPP + e] = ap[oW1 + i * w2 + j];
    ap[oCRPM + e] = (d[i] * d[j]) * ap[oR + e] + ap[oW1 + i * w2 + n + j];
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    float* ap = ar + p * AR;
    ap[oCJP + i] = ap[oJP + i] + ap[oW1 + i * w2 + 2 * n];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
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
  const int n = a.n, nn = n * n;
  const int AR = scan_arena_floats(n);
  float* ar = smem;
  const int p0 = blockIdx.x * P;
  const int np = min(P, a.S - p0);
  const Arena o(n);
  const int oC = doubling_arena_floats(n);
  const size_t gm = (size_t)p0 * nn, gv = (size_t)p0 * n;

  // seed the composite from the input composite
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn;
    float* c = ar + p * AR + oC;
    c[e] = ci_rmp[gm + idx];
    c[nn + e] = ci_rpm[gm + idx];
    c[2 * nn + e] = ci_tpp[gm + idx];
    c[3 * nn + e] = ci_tmm[gm + idx];
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    float* c = ar + p * AR + oC + 4 * nn;
    c[i] = ci_jp[gv + idx];
    c[n + i] = ci_jm[gv + idx];
  }
  __syncthreads();

  for (int z = 0; z < a.nz; ++z) {
    elemental_phase(ar, AR, o, np, p0, z, a, tau, omega, tau_sum, zw, zpp_c,
                    zmp_c, qp, wct2, i0, d);
    doubling_phase(ar, AR, o, n, np, sch);
    interaction_phase(ar, AR, o, n, np, oC, sch.ni, d);
  }

  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn;
    const float* c = ar + p * AR + oC;
    o_rmp[gm + idx] = c[e];
    o_rpm[gm + idx] = c[nn + e];
    o_tpp[gm + idx] = c[2 * nn + e];
    o_tmm[gm + idx] = c[3 * nn + e];
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    const float* c = ar + p * AR + oC + 4 * nn;
    o_jp[gv + idx] = c[i];
    o_jm[gv + idx] = c[n + i];
  }
}

}  // namespace

// Launch one bucket of nz layers on `stream`: per-layer scalars tau, omega,
// tau_sum (nz, S) and zw (nz, K, S); Z components (K, n, n) x 2; qp, wct2,
// i0, d (n); the composite above the bucket (S, n, n) x 4 + (S, n) x 2 in,
// the composite through it out. Returns the launch's cudaError_t.
extern "C" int vsm_layer_scan(
    const float* tau, const float* omega, const float* tau_sum,
    const float* zw, const float* zpp_c, const float* zmp_c, const float* qp,
    const float* wct2, const float* i0, const float* d, const float* ci_rmp,
    const float* ci_rpm, const float* ci_tpp, const float* ci_tmm,
    const float* ci_jp, const float* ci_jm, float* o_rmp, float* o_rpm,
    float* o_tpp, float* o_tmm, float* o_jp, float* o_jm, int S, int n,
    int nz, int K, const int* sched, int nd, int ni, int i_mu0_n,
    int n_stokes, float mu0, float mu0_node, float wct02, int pts_per_block,
    int smem_bytes, void* stream) {
  if (S <= 0) return 0;
  if (n < 1 || nz < 1 || K < 1 || nd < 0 || nd > kMaxSched || ni < 0
      || pts_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const size_t need =
      (size_t)pts_per_block * scan_arena_floats(n) * sizeof(float);
  if ((size_t)smem_bytes < need) return (int)cudaErrorInvalidValue;
  const Schedule s = vsm::make_schedule(sched, nd, ni);
  ScanArgs a;
  a.n = n; a.nz = nz; a.K = K; a.S = S; a.i_mu0_n = i_mu0_n;
  a.n_stokes = n_stokes; a.mu0 = mu0; a.mu0_node = mu0_node;
  a.wct02 = wct02;
  a.inv_scale = 1.f;
  for (int i = 0; i < nd; ++i) a.inv_scale *= 0.5f;   // 2^-nd, exact
  cudaError_t e = cudaFuncSetAttribute(
      layer_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (S + pts_per_block - 1) / pts_per_block;
  layer_scan_kernel<<<blocks, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      tau, omega, tau_sum, zw, zpp_c, zmp_c, qp, wct2, i0, d, ci_rmp, ci_rpm,
      ci_tpp, ci_tmm, ci_jp, ci_jm, o_rmp, o_rpm, o_tpp, o_tmm, o_jp, o_jm,
      a, pts_per_block, s);
  return (int)cudaGetLastError();
}
