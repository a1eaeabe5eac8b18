// Device helpers shared by the RT layer kernels (layer_step.cu,
// layer_step_dev.cu, layer_scan.cu): block-cooperative batched products,
// Newton-Schulz solves and the plain-form doubling phase on per-point arenas
// in shared memory.
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

// Shared-memory floats of the doubling phase's arena (below): the state
// R, T, JP, JM, EK (2 nn + 2n + 1) and the scratch A, M0, M1, TMP (4 nn) and
// W1, W2 (2 n (2n+2)).
__host__ __device__ inline int doubling_arena_floats(int n) {
  return 10 * n * n + 6 * n + 1;
}

// Arena offsets of the doubling phase (floats; nn = n*n):
//   R [nn] | T [nn] | JP [n] | JM [n] | EK [1] |
//   A [nn] | M0 [nn] | M1 [nn] | TMP [nn] | W1 [n x (2n+2)] | W2 [n x (2n+2)]
// Used by the layer-step, doubling-only and layer-scan kernels.
struct Arena {
  int oR, oT, oJP, oJM, oEK, oA, oM0, oM1, oTMP, oW1, w2, oW2;
  __device__ explicit Arena(int n) {
    const int nn = n * n;
    oR = 0; oT = nn; oJP = 2 * nn; oJM = 2 * nn + n; oEK = 2 * nn + 2 * n;
    const int oS = oEK + 1;
    oA = oS; oM0 = oS + nn; oM1 = oS + 2 * nn; oTMP = oS + 3 * nn;
    oW1 = oS + 4 * nn; w2 = 2 * n + 2; oW2 = oW1 + n * w2;
  }
};

// All scheduled doubling steps (flipped space) on the arena's R, T, JP, JM,
// EK: per step A = I - R R, M = NS inverse of A, then
// [R T | T | J1M + R JP | JP + R J1M] rides T (M .) once
// (vsmartmom/pallas/doubling_kernel.py:doubling_body). Returns synchronised.
__device__ inline void doubling_phase(float* ar, int AR, const Arena& o,
                                      int n, int np, const Schedule& sch) {
  const int nn = n * n, w2 = o.w2;
  const int oR = o.oR, oT = o.oT, oJP = o.oJP, oJM = o.oJM, oEK = o.oEK;
  const int oA = o.oA, oW1 = o.oW1, oW2 = o.oW2;
  for (int step = 0; step < sch.nd; ++step) {
    // A = I - R R; M = NS inverse of A
    mm(ar + oA, n, AR, ar + oR, n, AR, ar + oR, n, AR, n, n, np, false);
    __syncthreads();
    eye_minus(ar, AR, n, np, oA);
    __syncthreads();
    const int oM = ns_solve(ar, AR, n, np, oA, o.oM0, o.oM1, o.oTMP,
                            sch.it[step]);
    // W1[:, 0:n+2] = [T | JP | JM ek]
    for (int idx = threadIdx.x; idx < np * n * (n + 2); idx += blockDim.x) {
      const int p = idx / (n * (n + 2)), e = idx - p * n * (n + 2);
      const int i = e / (n + 2), j = e - i * (n + 2);
      float* a = ar + p * AR;
      a[oW1 + i * w2 + j] = j < n ? a[oT + i * n + j]
                          : (j == n ? a[oJP + i] : a[oJM + i] * a[oEK]);
    }
    __syncthreads();
    // W2[:, 0:n+2] = R [T | JP | J1M]
    mm(ar + oW2, w2, AR, ar + oR, n, AR, ar + oW1, w2, AR, n, n + 2, np,
       false);
    __syncthreads();
    // W1 = [R T | T | J1M + R JP | JP + R J1M]
    for (int idx = threadIdx.x; idx < np * n * w2; idx += blockDim.x) {
      const int p = idx / (n * w2), e = idx - p * n * w2;
      const int i = e / w2, j = e - i * w2;
      float* a = ar + p * AR;
      float v;
      if (j < n) v = a[oW2 + i * w2 + j];
      else if (j < 2 * n) v = a[oT + i * n + (j - n)];
      else if (j == 2 * n) v = a[oJM + i] * a[oEK] + a[oW2 + i * w2 + n];
      else v = a[oJP + i] + a[oW2 + i * w2 + n + 1];
      a[oW1 + i * w2 + j] = v;
    }
    __syncthreads();
    // W1 = T (M W1)
    mm(ar + oW2, w2, AR, ar + oM, n, AR, ar + oW1, w2, AR, n, w2, np, false);
    __syncthreads();
    mm(ar + oW1, w2, AR, ar + oT, n, AR, ar + oW2, w2, AR, n, w2, np, false);
    __syncthreads();
    for (int idx = threadIdx.x; idx < np * n; idx += blockDim.x) {
      const int p = idx / n, i = idx - p * n;
      float* a = ar + p * AR;
      a[oJM + i] = a[oJM + i] + a[oW1 + i * w2 + 2 * n];
      a[oJP + i] = a[oJP + i] * a[oEK] + a[oW1 + i * w2 + 2 * n + 1];
    }
    for (int idx = threadIdx.x; idx < np * nn; idx += blockDim.x) {
      const int p = idx / nn, e = idx - p * nn, i = e / n, j = e - i * n;
      float* a = ar + p * AR;
      a[oR + e] = a[oR + e] + a[oW1 + i * w2 + j];
      a[oT + e] = a[oW1 + i * w2 + n + j];
    }
    __syncthreads();
    for (int p = threadIdx.x; p < np; p += blockDim.x)
      ar[p * AR + oEK] = ar[p * AR + oEK] * ar[p * AR + oEK];
    __syncthreads();
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
