// Lanes-layout RT layer step for Hopper: doubling of the elemental layer and
// the two-solve adding under the composite, with the spectral points on the
// contiguous (minor) axis of every operand.
//
// Replaces the TPU kernel vsmartmom/pallas/lanes_kernel.py:_lanes_kernel
// (body lanes_layer_step_math), reached from fused_layer_step_lanes. Same
// algebra and association: per doubling step A = I - r r, M = NS(A), and
// r += t (M (r t)), jm += t (M v1), jp = j1p + t (M v2), t = t (M t); the
// interaction with two NS solves, c_tmm (M1 X) and t (M2 X), tt never
// materialized.
//
// Layout: matrices (N, N, S), vectors (N, S); element (i, j) of point s at
// (i N + j) S + s. A warp covers 32 consecutive points, so every load and
// store of a warp is one coalesced 128-byte line, and no point needs a
// shared-memory arena: its state and scratch live in a device-memory
// workspace in the same layout, (6 N^2 + 6 N) S floats, allocated by the
// wrapper. A block is 32 points x R row threads (R = min(N, 16)); the thread
// (s, r) computes rows r, r + R, ... of each product for point s, and
// __syncthreads() separates dependent products. Ragged S is masked (the
// threads of a missing point skip every load and store but keep the
// barriers); the TPU wrapper padded T with an identity instead. Any N
// is taken: nothing per point is held on chip.
//
// Bound: per point a chain of small dependent N x N fp32 products, O(N^3)
// FMAs against O(N^2) bytes of inputs and outputs, so arithmetic on paper;
// in this first version every operand of every product is re-read from the
// cache hierarchy (L1/L2), so cache bandwidth is what it meets first.

#include <cuda_runtime.h>

#include "rt_device.cuh"

namespace {

using vsm::kMaxSched;
using vsm::Schedule;

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
__device__ void ns(const L& l, const float* A, float** m, float** m2,
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
lanes_kernel(const float* __restrict__ c_rmp, const float* __restrict__ c_rpm,
             const float* __restrict__ c_tpp, const float* __restrict__ c_tmm,
             const float* __restrict__ c_jp, const float* __restrict__ c_jm,
             const float* __restrict__ r_f, const float* __restrict__ t_in,
             const float* __restrict__ jp_in, const float* __restrict__ jm_in,
             const float* __restrict__ ek_in, const float* __restrict__ d,
             float* __restrict__ o_rmp, float* __restrict__ o_rpm,
             float* __restrict__ o_tpp, float* __restrict__ o_tmm,
             float* __restrict__ o_jp, float* __restrict__ o_jm,
             float* __restrict__ ws, int S, int n, Schedule sch) {
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
    ns(l, A, &M, &M2, TMP, sch.it[step]);
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
  ns(l, A, &M, &M2, TMP, sch.ni);
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
  ns(l, A, &M, &M2, TMP, sch.ni);
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

// Launch one lanes-layout layer step on `stream`: composite (N, N, S) x 4 +
// (N, S) x 2, elemental r_f, t (N, N, S), jp, jm_f (N, S), ek (S), d (N),
// outputs like the composite, and a workspace of (6 N^2 + 6 N) S floats.
// Returns the launch's cudaError_t.
extern "C" int vsm_lanes(
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
  lanes_kernel<<<blocks, block, 0, (cudaStream_t)stream>>>(
      c_rmp, c_rpm, c_tpp, c_tmm, c_jp, c_jm, r_f, t, jp, jm_f, ek, d, o_rmp,
      o_rpm, o_tpp, o_tmm, o_jp, o_jm, ws, S, n, s);
  return (int)cudaGetLastError();
}
