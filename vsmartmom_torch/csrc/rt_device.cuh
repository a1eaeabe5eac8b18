// Device helpers shared by the RT layer kernels (layer_step.cu,
// layer_step_dev.cu): block-cooperative batched products and Newton-Schulz
// solves on per-point arenas in shared memory.
//
// Every helper is called by all threads of a block. The block owns `np`
// spectral points; point p's arena starts at ar + p * AR, and the helpers
// address their operands by float offsets into it. The caller places the
// __syncthreads() between dependent phases, except inside ns_solve and
// ns_y, which synchronise their own steps and return synchronised.
#pragma once

#include <cuda_runtime.h>

namespace vsm {

constexpr int kThreads = 256;
constexpr int kMaxSched = 64;

struct Schedule {
  int nd;                 // doubling steps
  int ni;                 // NS iterations of the interaction solve
  int it[kMaxSched];      // NS iterations of each doubling step
};

// C[p] (n x k, row stride ldc) = D[p] + A[p] (n x n, lda) @ B[p] (n x k,
// ldb) for the block's np points; sc/sd/sa/sb step between points. D may be
// nullptr (no addend) or alias C (accumulate). Pointers are generic: shared
// arenas or device memory. fp32 FMA, one output element per thread.
__device__ inline void mm_add(float* C, int ldc, int sc, const float* D,
                              int ldd, int sd, const float* A, int lda,
                              int sa, const float* B, int ldb, int sb, int n,
                              int k, int np) {
  const int per = n * k;
  for (int idx = threadIdx.x; idx < np * per; idx += blockDim.x) {
    const int p = idx / per;
    const int r = idx - p * per;
    const int i = r / k;
    const int j = r - i * k;
    const float* a = A + p * sa + i * lda;
    const float* b = B + p * sb + j;
    float s = 0.f;
    for (int l = 0; l < n; ++l) s = fmaf(a[l], b[l * ldb], s);
    float* c = C + p * sc + i * ldc + j;
    *c = D ? D[p * sd + i * ldd + j] + s : s;
  }
}

// C = A @ B, or C += A @ B with acc
__device__ inline void mm(float* C, int ldc, int sc, const float* A, int lda,
                          int sa, const float* B, int ldb, int sb, int n,
                          int k, int np, bool acc) {
  mm_add(C, ldc, sc, acc ? C : nullptr, ldc, sc, A, lda, sa, B, ldb, sb, n,
         k, np);
}

// Newton-Schulz approximate inverse of A = I - B (A already in the arena):
// M0 = 2I - A, then M <- M (2I - A M) `iters` times. Returns the offset of
// the buffer holding the result (M0 or M1).
__device__ inline int ns_solve(float* ar, int AR, int n, int np, int offA,
                               int offM0, int offM1, int offT, int iters) {
  const int nn = n * n;
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
    float* a = ar + p * AR;
    a[offM0 + e] = (i == j ? 2.f : 0.f) - a[offA + e];
  }
  __syncthreads();
  int cur = offM0, oth = offM1;
  for (int q = 0; q < iters; ++q) {
    mm(ar + offT, n, AR, ar + offA, n, AR, ar + cur, n, AR, n, n, np, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
      const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
      float* tmp = ar + p * AR + offT;
      tmp[e] = (i == j ? 2.f : 0.f) - tmp[e];
    }
    __syncthreads();
    mm(ar + oth, n, AR, ar + cur, n, AR, ar + offT, n, AR, n, n, np, false);
    __syncthreads();
    const int s = cur; cur = oth; oth = s;
  }
  return cur;
}

// Y-form Newton-Schulz of the split form: Y ~= (I - B)^{-1} - I for B at
// offB: Y = B, then W = B + B Y, Y <- W + Y (W - Y) `iters` times. The
// result lands at offY; offW, offD, offT are scratch (nn floats each).
__device__ inline void ns_y(float* ar, int AR, int n, int np, int offB,
                            int offY, int offW, int offD, int offT,
                            int iters) {
  const int nn = n * n;
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn;
    ar[p * AR + offY + e] = ar[p * AR + offB + e];
  }
  __syncthreads();
  for (int q = 0; q < iters; ++q) {
    // W = B + B Y
    mm_add(ar + offW, n, AR, ar + offB, n, AR, ar + offB, n, AR, ar + offY,
           n, AR, n, n, np);
    __syncthreads();
    for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
      const int p = idx / nn, e = idx - p * nn;
      float* a = ar + p * AR;
      a[offD + e] = a[offW + e] - a[offY + e];
    }
    __syncthreads();
    // T = W + Y (W - Y); Y = T
    mm_add(ar + offT, n, AR, ar + offW, n, AR, ar + offY, n, AR, ar + offD,
           n, AR, n, n, np);
    __syncthreads();
    for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
      const int p = idx / nn, e = idx - p * nn;
      ar[p * AR + offY + e] = ar[p * AR + offT + e];
    }
    __syncthreads();
  }
}

// A = I - A in place (A holds a product)
__device__ inline void eye_minus(float* ar, int AR, int n, int np,
                                 int offA) {
  const int nn = n * n;
  for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
    const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
    float* a = ar + p * AR + offA;
    a[e] = (i == j ? 1.f : 0.f) - a[e];
  }
}

// The launch parameters' schedule from a host array of nd counts.
inline Schedule make_schedule(const int* sched, int nd, int ni) {
  Schedule s;
  s.nd = nd;
  s.ni = ni;
  for (int i = 0; i < kMaxSched; ++i) s.it[i] = i < nd ? sched[i] : 0;
  return s;
}

}  // namespace vsm
