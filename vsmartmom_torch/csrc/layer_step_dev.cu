// Split-form ("deviation form") RT layer step for Hopper: the doubling of a
// pre-split elemental layer, the D-unflip and the adding under the running
// composite, one launch per atmospheric layer, with every transmission
// operator carried as T = diag(g) + E so that no product operand holds the
// ~1.0 direct-beam diagonal.
//
// Replaces the TPU kernel vsmartmom/pallas/layer_step_kernel.py:
// _layer_step_kernel_dev (reached from _fused_layer_step_dev_prim), whose
// algebra is vsmartmom/core/rt.py:doubling_dev + interaction_dev with the
// Y-form Newton-Schulz solve over the static schedules. Additions keep the
// association the algebra writes (e.g. (e + y g) + yp).
//
// Bound: as the plain layer step (layer_step.cu), a chain of small dependent
// N x N products per spectral point, O(N^3) fp32 FMAs against O(N^2) bytes:
// arithmetic and shared-memory bandwidth. Design: the same block-cooperative
// products on per-point shared-memory arenas (rt_device.cuh); the composite
// is read from device memory where a product needs it and written once.
// fp32 FMA on the CUDA cores (no TF32, no tensor cores).
//
// Per-point arena layout (floats; nn = n*n), 10 nn + 8 n + 1 in all:
//   R [nn] | E [nn] | G [n] | JP [n] | JM [n] | EK [1] | scratch [8 nn + 5 n]
// scratch: Y [nn] | then, by phase,
//   NS solve:    RR [nn] | W [nn] | D [nn] | T [nn]
//   doubling:    PA [n x (2n+2)] | PB [n x (2n+2)]
//   interaction: Z [n x (3n+2)] | YZ [n x (3n+2)] | X2 [n x (n+1)]

#include <cuda_runtime.h>

#include "rt_device.cuh"

namespace {

using vsm::kMaxSched;
using vsm::kThreads;
using vsm::Schedule;
using vsm::mm;
using vsm::ns_y;

__host__ __device__ inline int dev_arena_floats(int n) {
  return 10 * n * n + 8 * n + 1;
}

__global__ void __launch_bounds__(kThreads)
layer_step_dev_kernel(const float* __restrict__ c_rmp,
                      const float* __restrict__ c_rpm,
                      const float* __restrict__ c_epp,
                      const float* __restrict__ c_emm,
                      const float* __restrict__ c_g,
                      const float* __restrict__ c_jp,
                      const float* __restrict__ c_jm,
                      const float* __restrict__ r_f,
                      const float* __restrict__ g_el,
                      const float* __restrict__ e_el,
                      const float* __restrict__ jp,
                      const float* __restrict__ jm_f,
                      const float* __restrict__ ek,
                      const float* __restrict__ d,
                      float* __restrict__ o_rmp, float* __restrict__ o_rpm,
                      float* __restrict__ o_epp, float* __restrict__ o_emm,
                      float* __restrict__ o_g, float* __restrict__ o_jp,
                      float* __restrict__ o_jm, int S, int n, int P,
                      Schedule sch) {
  extern __shared__ float smem[];
  const int nn = n * n;
  const int AR = dev_arena_floats(n);
  float* dv = smem;          // D-matrix diagonal, shared by all points
  float* ar = smem + n;      // P per-point arenas
  const int p0 = blockIdx.x * P;
  const int np = min(P, S - p0);

  const int oR = 0, oE = nn, oG = 2 * nn, oJP = 2 * nn + n;
  const int oJM = 2 * nn + 2 * n, oEK = 2 * nn + 3 * n, oS = oEK + 1;
  const int oY = oS, oRR = oS + nn, oW = oS + 2 * nn, oD = oS + 3 * nn;
  const int oT = oS + 4 * nn;
  const int w1 = n + 2, w2 = 2 * n + 2, oPA = oS + nn, oPB = oPA + n * w2;
  const int wz = 3 * n + 2, oZ = oS + nn, oYZ = oZ + n * wz;
  const int wx2 = n + 1, oX2 = oYZ + n * wz, wo = 2 * n + 1;

  // block-local views of the per-point device arrays
  const size_t gm = (size_t)p0 * nn, gv = (size_t)p0 * n;
  const float* g_rmp = c_rmp + gm;
  const float* g_rpm = c_rpm + gm;
  const float* g_epp = c_epp + gm;
  const float* g_emm = c_emm + gm;
  const float* g_g = c_g + gv;
  const float* g_jp = c_jp + gv;
  const float* g_jm = c_jm + gv;

  // ---- load the elemental layer ------------------------------------------
  for (int i = threadIdx.x; i < n; i += blockDim.x) dv[i] = d[i];
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn;
    ar[p * AR + oR + e] = r_f[gm + idx];
    ar[p * AR + oE + e] = e_el[gm + idx];
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    ar[p * AR + oG + i] = g_el[gv + idx];
    ar[p * AR + oJP + i] = jp[gv + idx];
    ar[p * AR + oJM + i] = jm_f[gv + idx];
  }
  for (int p = threadIdx.x; p < np; p += blockDim.x)
    ar[p * AR + oEK] = ek[p0 + p];
  __syncthreads();

  // ---- 1. split-form doubling (flipped space) -----------------------------
  for (int step = 0; step < sch.nd; ++step) {
    // Y = (I - R R)^-1 - I, Y-form NS
    mm(ar + oRR, n, AR, ar + oR, n, AR, ar + oR, n, AR, n, n, np, false);
    __syncthreads();
    ns_y(ar, AR, n, np, oRR, oY, oW, oD, oT, sch.it[step]);
    // PA = [E | JP | JM ek] (row stride n+2); PB = R PA
    for (int idx = threadIdx.x; idx < np * n * w1; idx += blockDim.x) {
      const int p = idx / (n * w1), e = idx - p * n * w1;
      const int i = e / w1, j = e - i * w1;
      float* a = ar + p * AR;
      a[oPA + i * w1 + j] = j < n ? a[oE + i * n + j]
                          : (j == n ? a[oJP + i] : a[oJM + i] * a[oEK]);
    }
    __syncthreads();
    mm(ar + oPB, w1, AR, ar + oR, n, AR, ar + oPA, w1, AR, n, w1, np,
       false);
    __syncthreads();
    // PA = [rt | E | v1 | v2] (row stride 2n+2):
    // rt = R G + R E, v1 = j1m + R jp, v2 = jp + R j1m
    for (int idx = threadIdx.x; idx < np * n * w2; idx += blockDim.x) {
      const int p = idx / (n * w2), e = idx - p * n * w2;
      const int i = e / w2, j = e - i * w2;
      float* a = ar + p * AR;
      float v;
      if (j < n) v = a[oR + i * n + j] * a[oG + j] + a[oPB + i * w1 + j];
      else if (j < 2 * n) v = a[oE + i * n + (j - n)];
      else if (j == 2 * n) v = a[oJM + i] * a[oEK] + a[oPB + i * w1 + n];
      else v = a[oJP + i] + a[oPB + i * w1 + n + 1];
      a[oPA + i * w2 + j] = v;
    }
    __syncthreads();
    // PB = Y PA
    mm(ar + oPB, w2, AR, ar + oY, n, AR, ar + oPA, w2, AR, n, w2, np,
       false);
    __syncthreads();
    // PA = [mrt | d_mt | mv1 | mv2]: PA + PB, and d_mt = E + Y G + Y E
    for (int idx = threadIdx.x; idx < np * n * w2; idx += blockDim.x) {
      const int p = idx / (n * w2), e = idx - p * n * w2;
      const int i = e / w2, j = e - i * w2;
      float* a = ar + p * AR;
      const float yp = a[oPB + i * w2 + j];
      if (j >= n && j < 2 * n) {
        const int c = j - n;
        a[oPA + i * w2 + j] =
            a[oE + i * n + c] + a[oY + i * n + c] * a[oG + c] + yp;
      } else {
        a[oPA + i * w2 + j] = a[oPA + i * w2 + j] + yp;
      }
    }
    __syncthreads();
    // PB = E PA
    mm(ar + oPB, w2, AR, ar + oE, n, AR, ar + oPA, w2, AR, n, w2, np,
       false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
      const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
      float* a = ar + p * AR;
      const float gi = a[oG + i];
      a[oR + e] = a[oR + e] + gi * a[oPA + i * w2 + j] + a[oPB + i * w2 + j];
      a[oE + e] = gi * a[oPA + i * w2 + n + j] + a[oE + e] * a[oG + j]
                + a[oPB + i * w2 + n + j];
    }
    for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
      const int p = idx / n, i = idx - p * n;
      float* a = ar + p * AR;
      const float gi = a[oG + i];
      a[oJM + i] = a[oJM + i] + gi * a[oPA + i * w2 + 2 * n]
                 + a[oPB + i * w2 + 2 * n];
      a[oJP + i] = a[oJP + i] * a[oEK] + gi * a[oPA + i * w2 + 2 * n + 1]
                 + a[oPB + i * w2 + 2 * n + 1];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
      const int p = idx / n, i = idx - p * n;
      ar[p * AR + oG + i] = ar[p * AR + oG + i] * ar[p * AR + oG + i];
    }
    for (int p = threadIdx.x; p < np; p += blockDim.x)
      ar[p * AR + oEK] = ar[p * AR + oEK] * ar[p * AR + oEK];
    __syncthreads();
  }

  // ---- 2. un-flip: R <- D R (r2mp), JM <- D JM (j2m) ----------------------
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n;
    ar[p * AR + oR + e] = dv[i] * ar[p * AR + oR + e];
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    ar[p * AR + oJM + i] = dv[i] * ar[p * AR + oJM + i];
  }
  __syncthreads();
  // added layer: r2mp = R, r2pm = sgn R, e2 = E, e2mm = sgn E, g2 = G,
  // j2p = JP, j2m = JM (sgn_ij = d_i d_j)

  // ---- 3. split-form interaction (push-through single solve) --------------
  // Y = (I - r2mp c_rpm)^-1 - I
  mm(ar + oRR, n, AR, ar + oR, n, AR, g_rpm, n, nn, n, n, np, false);
  __syncthreads();
  ns_y(ar, AR, n, np, oRR, oY, oW, oD, oT, sch.ni);
  // Z = [rc_tpp | e2mm | v1 | p3]: p1 = r2mp [c_epp | c_jp] into Z[:, 0:n]
  // and Z[:, 2n]; e2mm into Z[:, n:2n]
  mm(ar + oZ, wz, AR, ar + oR, n, AR, g_epp, n, nn, n, n, np, false);
  mm(ar + oZ + 2 * n, wz, AR, ar + oR, n, AR, g_jp, 1, n, n, 1, np, false);
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
    float* a = ar + p * AR;
    a[oZ + i * wz + n + j] = (dv[i] * dv[j]) * a[oE + e];
  }
  __syncthreads();
  // rc_tpp = r2mp gc + p1, v1 = p1 + j2m
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
    float* a = ar + p * AR;
    a[oZ + i * wz + j] = a[oR + e] * g_g[p * n + j] + a[oZ + i * wz + j];
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    float* a = ar + p * AR;
    a[oZ + i * wz + 2 * n] = a[oZ + i * wz + 2 * n] + a[oJM + i];
  }
  // X2 = [crpm_t2mm | v2]: p2 = c_rpm [e2mm | j2m]
  mm(ar + oX2, wx2, AR, g_rpm, n, nn, ar + oZ + n, wz, AR, n, n, np, false);
  mm(ar + oX2 + n, wx2, AR, g_rpm, n, nn, ar + oJM, 1, AR, n, 1, np, false);
  __syncthreads();
  // crpm_t2mm = c_rpm g2 + p2, v2 = c_jp + p2
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
    float* a = ar + p * AR;
    a[oX2 + i * wx2 + j] = g_rpm[idx] * a[oG + j] + a[oX2 + i * wx2 + j];
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    float* a = ar + p * AR;
    a[oX2 + i * wx2 + n] = g_jp[idx] + a[oX2 + i * wx2 + n];
  }
  __syncthreads();
  // p3 = r2mp X2 into Z[:, 2n+1:3n+2]
  mm(ar + oZ + 2 * n + 1, wz, AR, ar + oR, n, AR, ar + oX2, wx2, AR, n, wx2,
     np, false);
  __syncthreads();
  // YZ = Y Z; then YZ = [y_a | d2 | y_v1 | y_b2 | y_bv] = Z + YZ, with
  // d2 = e2mm + Y g2 + YZ
  mm(ar + oYZ, wz, AR, ar + oY, n, AR, ar + oZ, wz, AR, n, wz, np, false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < np * n * wz; idx += blockDim.x) {
    const int p = idx / (n * wz), e = idx - p * n * wz;
    const int i = e / wz, j = e - i * wz;
    float* a = ar + p * AR;
    const float z = a[oZ + i * wz + j];
    if (j >= n && j < 2 * n) {
      const int c = j - n;
      a[oYZ + i * wz + j] =
          z + a[oY + i * n + c] * a[oG + c] + a[oYZ + i * wz + j];
    } else {
      a[oYZ + i * wz + j] = z + a[oYZ + i * wz + j];
    }
  }
  __syncthreads();
  // p4 = c_emm [y_a | d2 | y_v1] into Z (row stride 2n+1); outputs
  // r_mp, e_mm, j_m
  mm(ar + oZ, wo, AR, g_emm, n, nn, ar + oYZ, wz, AR, n, wo, np, false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
    const float* a = ar + p * AR;
    const float gci = g_g[p * n + i];
    o_rmp[gm + idx] = g_rmp[idx] + gci * a[oYZ + i * wz + j]
                    + a[oZ + i * wo + j];
    o_emm[gm + idx] = gci * a[oYZ + i * wz + n + j] + g_emm[idx] * a[oG + j]
                    + a[oZ + i * wo + n + j];
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    const float* a = ar + p * AR;
    o_jm[gv + idx] = g_jm[idx] + g_g[idx] * a[oYZ + i * wz + 2 * n]
                   + a[oZ + i * wo + 2 * n];
  }
  __syncthreads();
  // p5 = c_rpm [y_b1 | y_b2 | y_bv] (y_b1 = y_a) into Z; then
  // Z = [i1 | i2 | iv] = [c_epp | crpm_t2mm | v2] + p5
  mm(ar + oZ, wo, AR, g_rpm, n, nn, ar + oYZ, wz, AR, n, n, np, false);
  mm(ar + oZ + n, wo, AR, g_rpm, n, nn, ar + oYZ + 2 * n + 1, wz, AR, n,
     n + 1, np, false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < np * n * wo; idx += blockDim.x) {
    const int p = idx / (n * wo), e = idx - p * n * wo;
    const int i = e / wo, j = e - i * wo;
    float* a = ar + p * AR;
    const float x = j < n ? g_epp[p * nn + i * n + j]
                          : a[oX2 + i * wx2 + (j - n)];
    a[oZ + i * wo + j] = x + a[oZ + i * wo + j];
  }
  __syncthreads();
  // p6 = e2 [i1 | i2 | iv] into YZ (row stride 2n+1); outputs e_pp, r_pm,
  // j_p, g
  mm(ar + oYZ, wo, AR, ar + oE, n, AR, ar + oZ, wo, AR, n, wo, np, false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
    const float* a = ar + p * AR;
    const float g2i = a[oG + i];
    o_epp[gm + idx] = g2i * a[oZ + i * wo + j] + a[oE + e] * g_g[p * n + j]
                    + a[oYZ + i * wo + j];
    o_rpm[gm + idx] = (dv[i] * dv[j]) * a[oR + e]
                    + g2i * a[oZ + i * wo + n + j] + a[oYZ + i * wo + n + j];
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    const float* a = ar + p * AR;
    o_jp[gv + idx] = a[oJP + i] + a[oG + i] * a[oZ + i * wo + 2 * n]
                   + a[oYZ + i * wo + 2 * n];
    o_g[gv + idx] = g_g[idx] * a[oG + i];
  }
}

}  // namespace

// Launch one split-form layer step on `stream`. Returns the cudaError_t of
// the launch (0 on success); the caller raises on anything else.
extern "C" int vsm_layer_step_dev(
    const float* c_rmp, const float* c_rpm, const float* c_epp,
    const float* c_emm, const float* c_g, const float* c_jp,
    const float* c_jm, const float* r_f, const float* g_el,
    const float* e_el, const float* jp, const float* jm_f, const float* ek,
    const float* d, float* o_rmp, float* o_rpm, float* o_epp, float* o_emm,
    float* o_g, float* o_jp, float* o_jm, int S, int n, const int* sched,
    int nd, int ni, int pts_per_block, int smem_bytes, void* stream) {
  if (S <= 0) return 0;
  if (n < 1 || nd < 0 || nd > kMaxSched || ni < 0 || pts_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const size_t need =
      (size_t)(n + pts_per_block * dev_arena_floats(n)) * sizeof(float);
  if ((size_t)smem_bytes < need) return (int)cudaErrorInvalidValue;
  const Schedule s = vsm::make_schedule(sched, nd, ni);
  cudaError_t e = cudaFuncSetAttribute(
      layer_step_dev_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (S + pts_per_block - 1) / pts_per_block;
  layer_step_dev_kernel<<<blocks, kThreads, smem_bytes,
                          (cudaStream_t)stream>>>(
      c_rmp, c_rpm, c_epp, c_emm, c_g, c_jp, c_jm, r_f, g_el, e_el, jp, jm_f,
      ek, d, o_rmp, o_rpm, o_epp, o_emm, o_g, o_jp, o_jm, S, n,
      pts_per_block, s);
  return (int)cudaGetLastError();
}
