// Fused RT layer step for Hopper: doubling of the elemental layer plus the
// adding of the doubled layer under the running composite, one launch per
// atmospheric layer; and the doubling-only kernel, which runs phase 1 alone.
//
// layer_step_kernel replaces the TPU kernel
// vsmartmom/pallas/layer_step_kernel.py:_layer_step_kernel (doubling via
// vsmartmom/pallas/doubling_kernel.py:doubling_body). Same algebra, same
// Newton-Schulz schedules, same push-through single-solve interaction.
// doubling_kernel replaces vsmartmom/pallas/doubling_kernel.py:
// _doubling_kernel (reached from fused_doubling): the same doubling phase,
// with the doubled (r, t, jp, jm) written back instead of added.
//
// Bound: every spectral point runs a chain of small dependent N x N products
// (N <= 63) on its own data, O(N^3) fp32 FMAs per product against O(N^2)
// bytes of device memory per layer, so the kernels are bound by arithmetic
// and shared-memory bandwidth, not by device memory. Design: one block of 256
// threads owns P points; each point has a private arena in dynamic shared
// memory that holds its whole state (elemental layer, NS iterates, packed
// right-hand operands) for the entire step. The composite operands are read
// from device memory where a product needs them; the new composite is
// written once at the end. All threads of the block sweep the
// (point, row, column) outputs of each product together (rt_device.cuh).
// fp32 FMA on the CUDA cores: no TF32, no tensor cores (a first, exact
// version).
//
// Per-point arena layout (floats; nn = n*n): the doubling phase's arena
// (vsm::Arena in rt_device.cuh: R, T, JP, JM, EK, A, M0, M1, TMP and the
// packed operands W1, W2 of n x (2n+2)); the interaction reuses the region
// from W1 on as X [n x (4n+2)] | X2 [n x (2n+1)]. The doubling-only kernel's
// arena ends after W2 (10 nn + 6 n + 1 floats).

#include <cuda_runtime.h>

#include "rt_device.cuh"

namespace {

using vsm::Arena;
using vsm::doubling_arena_floats;
using vsm::doubling_phase;
using vsm::eye_minus;
using vsm::kMaxSched;
using vsm::kThreads;
using vsm::mm;
using vsm::ns_solve;
using vsm::Schedule;

__host__ __device__ inline int arena_floats(int n) {
  return 12 * n * n + 6 * n + 1;
}

// R, T, JP, JM, EK of the block's np points from device memory
__device__ void load_elemental(float* ar, int AR, const Arena& o, int n,
                               int np, int p0, const float* r_f,
                               const float* t, const float* jp,
                               const float* jm_f, const float* ek) {
  const int nn = n * n;
  const size_t gm = (size_t)p0 * nn, gv = (size_t)p0 * n;
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn;
    ar[p * AR + o.oR + e] = r_f[gm + idx];
    ar[p * AR + o.oT + e] = t[gm + idx];
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    ar[p * AR + o.oJP + i] = jp[gv + idx];
    ar[p * AR + o.oJM + i] = jm_f[gv + idx];
  }
  for (int p = threadIdx.x; p < np; p += blockDim.x)
    ar[p * AR + o.oEK] = ek[p0 + p];
}

__global__ void __launch_bounds__(kThreads)
layer_step_kernel(const float* __restrict__ c_rmp,
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
                  int S, int n, int P, Schedule sch) {
  extern __shared__ float smem[];
  const int nn = n * n;
  const int AR = arena_floats(n);
  float* dv = smem;          // D-matrix diagonal, shared by all points
  float* ar = smem + n;      // P per-point arenas
  const int p0 = blockIdx.x * P;
  const int np = min(P, S - p0);

  const Arena o(n);
  const int oR = o.oR, oT = o.oT, oJP = o.oJP, oJM = o.oJM;
  const int oA = o.oA, oM0 = o.oM0, oM1 = o.oM1, oTMP = o.oTMP;
  const int oX = o.oW1, wx = 4 * n + 2, oX2 = oX + n * wx, wx2 = 2 * n + 1;

  // block-local views of the per-point device arrays
  const size_t gm = (size_t)p0 * nn, gv = (size_t)p0 * n;
  const float* g_rmp = c_rmp + gm;
  const float* g_rpm = c_rpm + gm;
  const float* g_tpp = c_tpp + gm;
  const float* g_tmm = c_tmm + gm;
  const float* g_jp = c_jp + gv;
  const float* g_jm = c_jm + gv;

  // ---- load the elemental layer ------------------------------------------
  for (int i = threadIdx.x; i < n; i += blockDim.x) dv[i] = d[i];
  load_elemental(ar, AR, o, n, np, p0, r_f, t, jp, jm_f, ek);
  __syncthreads();

  // ---- 1. doubling (flipped space) ----------------------------------------
  doubling_phase(ar, AR, o, n, np, sch);

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

  // ---- 3. interaction under the composite (push-through) ------------------
  // x1 = [r2mp c_tpp | t2mm | r2mp c_jp + j2m]           -> X[:, 0:2n+1]
  // x2 = [c_tpp | c_rpm t2mm | c_jp + c_rpm j2m]         -> X2
  // X[:, 2n+1:4n+2] = r2mp x2
  mm(ar + oX, wx, AR, ar + oR, n, AR, g_tpp, n, nn, n, n, np, false);
  mm(ar + oX + 2 * n, wx, AR, ar + oR, n, AR, g_jp, 1, n, n, 1, np, false);
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
    float* a = ar + p * AR;
    a[oX + i * wx + n + j] = (dv[i] * dv[j]) * a[oT + e];
    a[oX2 + i * wx2 + j] = g_tpp[idx];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    float* a = ar + p * AR;
    a[oX + i * wx + 2 * n] = a[oX + i * wx + 2 * n] + a[oJM + i];
  }
  mm(ar + oX2 + n, wx2, AR, g_rpm, n, nn, ar + oX + n, wx, AR, n, n, np,
     false);
  mm(ar + oX2 + 2 * n, wx2, AR, g_rpm, n, nn, ar + oJM, 1, AR, n, 1, np,
     false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    float* a = ar + p * AR;
    a[oX2 + i * wx2 + 2 * n] = g_jp[idx] + a[oX2 + i * wx2 + 2 * n];
  }
  __syncthreads();
  mm(ar + oX + 2 * n + 1, wx, AR, ar + oR, n, AR, ar + oX2, wx2, AR, n, wx2,
     np, false);
  // a1 = I - r2mp c_rpm; M1 = NS inverse (ni iterations)
  mm(ar + oA, n, AR, ar + oR, n, AR, g_rpm, n, nn, n, n, np, false);
  __syncthreads();
  eye_minus(ar, AR, n, np, oA);
  __syncthreads();
  const int oM = ns_solve(ar, AR, n, np, oA, oM0, oM1, oTMP, sch.ni);
  // y = M1 [x1 | r2mp x2], in place in X, n columns at a time through TMP
  for (int c0 = 0; c0 < wx; c0 += n) {
    const int kb = min(n, wx - c0);
    mm(ar + oTMP, n, AR, ar + oM, n, AR, ar + oX + c0, wx, AR, n, kb, np,
       false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < np * n * kb; idx += blockDim.x) {
      const int p = idx / (n * kb), e = idx - p * n * kb;
      const int i = e / kb, j = e - i * kb;
      ar[p * AR + oX + i * wx + c0 + j] = ar[p * AR + oTMP + i * n + j];
    }
    __syncthreads();
  }
  // o1 = c_tmm y[:, 0:2n+1] (into the free NS region)
  const int oO = oA;
  mm(ar + oO, wx2, AR, g_tmm, n, nn, ar + oX, wx, AR, n, wx2, np, false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
    const float* o = ar + p * AR + oO + i * wx2;
    o_rmp[gm + idx] = g_rmp[idx] + o[j];
    o_tmm[gm + idx] = o[n + j];
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    o_jm[gv + idx] = g_jm[idx] + ar[p * AR + oO + i * wx2 + 2 * n];
  }
  // x2 += c_rpm y[:, 2n+1:4n+2]; o2 = t2 x2
  mm(ar + oX2, wx2, AR, g_rpm, n, nn, ar + oX + 2 * n + 1, wx, AR, n, wx2,
     np, true);
  __syncthreads();
  mm(ar + oO, wx2, AR, ar + oT, n, AR, ar + oX2, wx2, AR, n, wx2, np, false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
    const float* a = ar + p * AR;
    const float* o = a + oO + i * wx2;
    o_tpp[gm + idx] = o[j];
    o_rpm[gm + idx] = (dv[i] * dv[j]) * a[oR + e] + o[n + j];
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    o_jp[gv + idx] = ar[p * AR + oJP + i] + ar[p * AR + oO + i * wx2 + 2 * n];
  }
}

__global__ void __launch_bounds__(kThreads)
doubling_kernel(const float* __restrict__ r_f, const float* __restrict__ t,
                const float* __restrict__ jp, const float* __restrict__ jm_f,
                const float* __restrict__ ek, float* __restrict__ o_r,
                float* __restrict__ o_t, float* __restrict__ o_jp,
                float* __restrict__ o_jm, int S, int n, int P,
                Schedule sch) {
  extern __shared__ float smem[];
  const int nn = n * n;
  const int AR = doubling_arena_floats(n);
  float* ar = smem;
  const int p0 = blockIdx.x * P;
  const int np = min(P, S - p0);
  const Arena o(n);
  load_elemental(ar, AR, o, n, np, p0, r_f, t, jp, jm_f, ek);
  __syncthreads();
  doubling_phase(ar, AR, o, n, np, sch);
  const size_t gm = (size_t)p0 * nn, gv = (size_t)p0 * n;
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn;
    o_r[gm + idx] = ar[p * AR + o.oR + e];
    o_t[gm + idx] = ar[p * AR + o.oT + e];
  }
  for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    o_jp[gv + idx] = ar[p * AR + o.oJP + i];
    o_jm[gv + idx] = ar[p * AR + o.oJM + i];
  }
}

}  // namespace

// Launch one layer step on `stream`. Returns the cudaError_t of the launch
// (0 on success); the caller raises on anything else.
extern "C" int vsm_layer_step(
    const float* c_rmp, const float* c_rpm, const float* c_tpp,
    const float* c_tmm, const float* c_jp, const float* c_jm,
    const float* r_f, const float* t, const float* jp, const float* jm_f,
    const float* ek, const float* d, float* o_rmp, float* o_rpm,
    float* o_tpp, float* o_tmm, float* o_jp, float* o_jm, int S, int n,
    const int* sched, int nd, int ni, int pts_per_block, int smem_bytes,
    void* stream) {
  if (S <= 0) return 0;
  if (n < 1 || nd < 0 || nd > kMaxSched || ni < 0 || pts_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const size_t need =
      (size_t)(n + pts_per_block * arena_floats(n)) * sizeof(float);
  if ((size_t)smem_bytes < need) return (int)cudaErrorInvalidValue;
  const Schedule s = vsm::make_schedule(sched, nd, ni);
  cudaError_t e = cudaFuncSetAttribute(
      layer_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (S + pts_per_block - 1) / pts_per_block;
  layer_step_kernel<<<blocks, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      c_rmp, c_rpm, c_tpp, c_tmm, c_jp, c_jm, r_f, t, jp, jm_f, ek, d, o_rmp,
      o_rpm, o_tpp, o_tmm, o_jp, o_jm, S, n, pts_per_block, s);
  return (int)cudaGetLastError();
}

// Launch the doubling recursion alone on `stream`: (r, t, jp, jm) of S points
// grown over the nd scheduled steps. Returns the launch's cudaError_t.
extern "C" int vsm_doubling(const float* r_f, const float* t, const float* jp,
                            const float* jm_f, const float* ek, float* o_r,
                            float* o_t, float* o_jp, float* o_jm, int S,
                            int n, const int* sched, int nd,
                            int pts_per_block, int smem_bytes, void* stream) {
  if (S <= 0) return 0;
  if (n < 1 || nd < 0 || nd > kMaxSched || pts_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const size_t need =
      (size_t)pts_per_block * doubling_arena_floats(n) * sizeof(float);
  if ((size_t)smem_bytes < need) return (int)cudaErrorInvalidValue;
  const Schedule s = vsm::make_schedule(sched, nd, 0);
  cudaError_t e = cudaFuncSetAttribute(
      doubling_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (S + pts_per_block - 1) / pts_per_block;
  doubling_kernel<<<blocks, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      r_f, t, jp, jm_f, ek, o_r, o_t, o_jp, o_jm, S, n, pts_per_block, s);
  return (int)cudaGetLastError();
}
