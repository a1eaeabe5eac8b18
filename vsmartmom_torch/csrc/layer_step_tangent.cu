// Tangent of the fused RT layer step for Hopper: the forward-mode rule of
// layer_step.cu's step (the plain form) for K tangent columns at once, one
// launch per atmospheric layer, as torch.func.jvp/jacfwd reach it.
//
// layer_step_tangent_kernel linearises the iteration the step runs, term by
// term: the doubling's scheduled Newton-Schulz iterates, the unflip and the
// push-through interaction with its ni iterates, each product A B by
// d(A B) = dA B + A dB and each elementwise pass by its own derivative. It
// does not use the exact inverse's derivative (-M dA M): its result is the
// tangent torch.func.jvp takes of the plain version
// (cuda/layer_step_kernel.py:layer_step_body), to float32 rounding. The
// products are in the primal's mode (rt_device.cuh mmj, mvj: each bf16 pass
// of dA B and of A dB summed as torch.func.jvp sums batch_mm's passes), on
// the CUDA cores in every mode. No TPU kernel computes a tangent; the
// JAX package takes its jnp twin's jvp.
//
// Design: one team of whole warps per (point, column), as layer_step.cu has
// one per point; a block holds as many teams as half an SM's shared memory
// takes, the K columns of a point in consecutive teams (their primal loads
// hit the same lines). Each team recomputes the primal chain beside its
// column's tangent in its own arena: the primal needs every Newton-Schulz
// iterate where its tangent is formed, so sharing one primal among K columns
// keeps K tangent arenas beside it in one team, (1 + K) / K of this arena a
// column and K times the serial work a team. The arena is the step's
// (layer_step.cu) twice: the primal at offset 0, the tangent's slots at
// the same offsets from step_arena_floats(n, ld). Each product of the
// primal and its tangent run as one register-tiled pass (mmj: s, dA B and
// A dB from the same loads of A, dA, B, dB) with the elementwise passes of
// both fused into its stores; the interaction's two output products
// compute the tangent alone. The block shares the D diagonal; each team
// reads its column's tangent of D from device memory.

#include <cuda_runtime.h>

#include "rt_device.cuh"

namespace {

using vsm::Arena;
using vsm::each;
using vsm::each_flat;
using vsm::each_row;
using vsm::kMaxBlock;
using vsm::kMaxSched;
using vsm::launch_team;
using vsm::load_elemental;
using vsm::mmj;
using vsm::mvj;
using vsm::round4;
using vsm::Schedule;
using vsm::step_arena_floats;
using vsm::step_composite_offset;
using vsm::Team;
using vsm::x2_stride;

__device__ __forceinline__ float fsum2(float a, float b, float c, float d) {
  return __fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// Newton-Schulz inverse of A from the seed at oM0, with its tangent from dA
// and the seed's tangent at the same offsets of dar: M <- M (2I - A M) and
// dM <- dM S + M dS, dS = -(dA M + A dM), `iters` times, the scratch S at
// oS. Returns the offset of the result in both arenas, synchronised.
template <class C>
__device__ __forceinline__ int
ns_tangent(const Team<C>& tm, float* ar, float* dar, int n, int ld, int oA,
           int oM0, int oM1, int oS, int iters) {
  int cur = oM0, oth = oM1;
  float* s = ar + oS;
  float* ds = dar + oS;
  for (int q = 0; q < iters; ++q) {
    mmj(tm, n, n, ar + oA, dar + oA, ld, ar + cur, dar + cur, ld,
        [=](int i, int j, float v, float dv) {
          s[i * ld + j] = (i == j ? 2.f : 0.f) - v;
          ds[i * ld + j] = -dv;
        });
    tm.sync();
    float* m = ar + oth;
    float* dm = dar + oth;
    mmj(tm, n, n, ar + cur, dar + cur, ld, s, ds, ld,
        [=](int i, int j, float v, float dv) {
          m[i * ld + j] = v;
          dm[i * ld + j] = dv;
        });
    tm.sync();
    const int x = cur;
    cur = oth;
    oth = x;
  }
  return cur;
}

// The doubling phase (rt_device.cuh doubling_phase) with its tangent: dar
// holds the tangents of R, T, JP, JM at the arena's offsets, dek that of
// ek. Per step the primal's products and passes, and
//   dA = -(dR R + R dR), dM0 = -dA, dM by ns_tangent,
//   dW1 = [dR T + R dT | dT | dJ1M + dR JP + R dJP | dJP + dR J1M + R dJ1M]
//   with dJ1M = dJM ek + JM dek, dW2 = dM W1 + M dW1, then from
//   dT W2 + T dW2: dR +=, dT' =, dJM +=, dJP = dJP ek + JP dek +;
//   dek <- dek ek + ek dek.
// Returns synchronised, with o.oT naming the current T in both arenas.
template <class C>
__device__ __forceinline__ void
doubling_tangent(const Team<C>& tm, float* ar, float* dar, Arena& o,
                 float ek, float dek, const Schedule& sch) {
  const int n = o.n, ld = o.ld, w2 = o.w2;
  float* R = ar + o.oR;
  float* JP = ar + o.oJP;
  float* JM = ar + o.oJM;
  float* A = ar + o.oA;
  float* M0 = ar + o.oM0;
  float* W1 = ar + o.oW1;
  float* W2 = ar + o.oW2;
  float* dR = dar + o.oR;
  float* dJP = dar + o.oJP;
  float* dJM = dar + o.oJM;
  float* dA = dar + o.oA;
  float* dM0 = dar + o.oM0;
  float* dW1 = dar + o.oW1;
  float* dW2 = dar + o.oW2;
  for (int step = 0; step < sch.nd; ++step) {
    const float* T = ar + o.oT;
    const float* dT = dar + o.oT;
    float* Tn = ar + o.oTMP;
    float* dTn = dar + o.oTMP;
    mmj(tm, n, n, R, dR, ld, R, dR, ld, [=](int i, int j, float s, float ds) {
      const int e = i * ld + j;
      vsm::ns_seed(A, M0, e, i == j, s);
      dA[e] = -ds;
      dM0[e] = ds;
    });
    tm.sync();
    const int om = ns_tangent(tm, ar, dar, n, ld, o.oA, o.oM0, o.oM1,
                              o.oTMP, sch.it[step]);
    const float* M = ar + om;
    const float* dM = dar + om;
    mmj(tm, n, n, R, dR, ld, T, dT, ld, [=](int i, int j, float s, float ds) {
      W1[i * w2 + j] = s;
      W1[i * w2 + n + j] = T[i * ld + j];
      dW1[i * w2 + j] = ds;
      dW1[i * w2 + n + j] = dT[i * ld + j];
    });
    mvj(tm, n, R, dR, ld, [=](int l) { return JP[l]; },
        [=](int l) { return dJP[l]; }, [=](int i, float s, float ds) {
          W1[i * w2 + 2 * n] = __fadd_rn(__fmul_rn(JM[i], ek), s);
          dW1[i * w2 + 2 * n] = __fadd_rn(fsum2(dJM[i], ek, JM[i], dek), ds);
        });
    mvj(tm, n, R, dR, ld, [=](int l) { return __fmul_rn(JM[l], ek); },
        [=](int l) { return fsum2(dJM[l], ek, JM[l], dek); },
        [=](int i, float s, float ds) {
          W1[i * w2 + 2 * n + 1] = __fadd_rn(JP[i], s);
          dW1[i * w2 + 2 * n + 1] = __fadd_rn(dJP[i], ds);
        });
    tm.sync();
    mmj(tm, n, 2 * n + 2, M, dM, ld, W1, dW1, w2,
        [=](int i, int j, float s, float ds) {
          W2[i * w2 + j] = s;
          dW2[i * w2 + j] = ds;
        });
    tm.sync();
    // the tangents first: dJP's update reads the JP the primal's replaces
    // (the same thread owns both)
    mmj(tm, n, 2 * n + 2, T, dT, ld, W2, dW2, w2,
        [=](int i, int j, float s, float ds) {
          if (j < n) {
            dR[i * ld + j] = __fadd_rn(dR[i * ld + j], ds);
            R[i * ld + j] = __fadd_rn(R[i * ld + j], s);
          } else if (j < 2 * n) {
            dTn[i * ld + j - n] = ds;
            Tn[i * ld + j - n] = s;
          } else if (j == 2 * n) {
            dJM[i] = __fadd_rn(dJM[i], ds);
            JM[i] = __fadd_rn(JM[i], s);
          } else {
            dJP[i] = __fadd_rn(fsum2(dJP[i], ek, JP[i], dek), ds);
            JP[i] = __fadd_rn(__fmul_rn(JP[i], ek), s);
          }
        });
    tm.sync();
    const int x = o.oT;
    o.oT = o.oTMP;
    o.oTMP = x;
    dek = fsum2(dek, ek, ek, dek);
    ek = __fmul_rn(ek, ek);
  }
}

// The tangent kernel's parameters and their names: the step's 12 primal
// operands (layer_step.cu), their tangents stacked over K columns (the
// composite's and the elemental layer's (K, S, n, n) / (K, S, n), ek's
// (K, S), d's (K, n)) and the six output tangents (K, S, ...).
#define TANGENT_PARAMS                                                      \
  const float *__restrict__ c_rmp, const float *__restrict__ c_rpm,        \
      const float *__restrict__ c_tpp, const float *__restrict__ c_tmm,    \
      const float *__restrict__ c_jp, const float *__restrict__ c_jm,      \
      const float *__restrict__ r_f, const float *__restrict__ t,          \
      const float *__restrict__ jp, const float *__restrict__ jm_f,        \
      const float *__restrict__ ek, const float *__restrict__ d,           \
      const float *__restrict__ dc_rmp, const float *__restrict__ dc_rpm,  \
      const float *__restrict__ dc_tpp, const float *__restrict__ dc_tmm,  \
      const float *__restrict__ dc_jp, const float *__restrict__ dc_jm,    \
      const float *__restrict__ dr_f, const float *__restrict__ dt,        \
      const float *__restrict__ djp, const float *__restrict__ djm_f,      \
      const float *__restrict__ dek, const float *__restrict__ dd,         \
      float *__restrict__ o_rmp, float *__restrict__ o_rpm,                \
      float *__restrict__ o_tpp, float *__restrict__ o_tmm,                \
      float *__restrict__ o_jp, float *__restrict__ o_jm, int S, int K,    \
      int n, int ld, int P, Schedule sch

template <class C>
__global__ void __launch_bounds__(kMaxBlock, 1)
layer_step_tangent_kernel(TANGENT_PARAMS) {
  extern __shared__ float smem[];
  float* dv = smem;  // D-matrix diagonal, shared by all teams
  for (int i = threadIdx.x; i < n; i += blockDim.x) dv[i] = d[i];
  __syncthreads();
  const int team = threadIdx.x / C::TT;
  const int g = blockIdx.x * P + team;
  if (g >= S * K) return;
  const int p = g / K, k = g - p * K;
  const Team<C> tm(threadIdx.x - team * C::TT, 1 + team);
  const int fl = step_arena_floats(n, ld);
  float* ar = smem + round4(n) + team * 2 * fl;
  float* dar = ar + fl;
  Arena o(n, ld);
  const size_t gm = (size_t)p * n * n, gv = (size_t)p * n;
  // the column's tangents: the same point in the column's (S, ...) slab
  const size_t km = (size_t)k * S * n * n, kv = (size_t)k * S * n;
  const size_t kgm = km + gm, kgv = kv + gv;
  const float* ddv = dd + (size_t)k * n;

  // ---- load: c_rpm, c_tmm and their tangents by cp.async -----------------
  const int oc = step_composite_offset(n, ld);
  float* CRPM = ar + oc;
  float* CTMM = CRPM + n * ld;
  float* dCRPM = dar + oc;
  float* dCTMM = dCRPM + n * ld;
  each_flat(tm, n, n, [=](int i, int j) {
    vsm::cp_async4(CRPM + i * ld + j, c_rpm + gm + i * n + j);
    vsm::cp_async4(CTMM + i * ld + j, c_tmm + gm + i * n + j);
    vsm::cp_async4(dCRPM + i * ld + j, dc_rpm + kgm + i * n + j);
    vsm::cp_async4(dCTMM + i * ld + j, dc_tmm + kgm + i * n + j);
  });
  vsm::cp_async_commit();
  load_elemental(tm, ar, o, p, r_f, t, jp, jm_f);
  load_elemental(tm, dar, o, p, dr_f + km, dt + km, djp + kv, djm_f + kv);
  tm.sync();

  // ---- 1. doubling (flipped space) ----------------------------------------
  doubling_tangent(tm, ar, dar, o, ek[p], dek[(size_t)k * S + p], sch);

  float* R = ar + o.oR;
  const float* T = ar + o.oT;
  const float* JP = ar + o.oJP;
  float* JM = ar + o.oJM;
  float* dR = dar + o.oR;
  const float* dT = dar + o.oT;
  const float* dJP = dar + o.oJP;
  float* dJM = dar + o.oJM;
  float* T2 = ar + o.oTMP;
  float* CJP = ar + o.oM1;
  float* dT2 = dar + o.oTMP;
  float* dCJP = dar + o.oM1;
  const int wx2 = x2_stride(n), wx = 2 * wx2;
  float* X = ar + o.oW1;
  float* X2 = X + n * wx;
  float* dX = dar + o.oW1;
  float* dX2 = dX + n * wx;

  // ---- 2. un-flip: r2mp = D R, t2mm = (D D) T, j2m = D JM and their
  // tangents (D's included); c_tpp, c_jp and theirs ---------------------
  each(tm, n, n, [=](int i, int j) {
    const int e = i * ld + j;
    const float r = R[e];
    R[e] = dv[i] * r;
    dR[e] = fsum2(ddv[i], r, dv[i], dR[e]);
    const float sg = dv[i] * dv[j];
    const float dsg = fsum2(ddv[i], dv[j], dv[i], ddv[j]);
    const float t2 = sg * T[e];
    const float dt2 = fsum2(dsg, T[e], sg, dT[e]);
    X[i * wx + n + j] = t2;
    T2[e] = t2;
    dX[i * wx + n + j] = dt2;
    dT2[e] = dt2;
  });
  each_flat(tm, n, n, [=](int i, int j) {
    X2[i * wx2 + j] = c_tpp[gm + i * n + j];
    dX2[i * wx2 + j] = dc_tpp[kgm + i * n + j];
  });
  each_row(tm, n, [=](int i) {
    const float jm = JM[i];
    JM[i] = dv[i] * jm;
    dJM[i] = fsum2(ddv[i], jm, dv[i], dJM[i]);
    CJP[i] = c_jp[gv + i];
    dCJP[i] = dc_jp[kgv + i];
  });
  vsm::cp_async_wait_all();
  tm.sync();

  // ---- 3. interaction under the composite (push-through), with tangents --
  // x1 = [r2mp c_tpp | t2mm | r2mp c_jp + j2m]           -> X[:, 0:2n+1]
  // x2 = [c_tpp | c_rpm t2mm | c_jp + c_rpm j2m]         -> X2[:, 0:2n+1]
  // a1 = I - r2mp c_rpm (and the NS seed)
  mmj(tm, n, n, R, dR, ld, X2, dX2, wx2,
      [=](int i, int j, float s, float ds) {
        X[i * wx + j] = s;
        dX[i * wx + j] = ds;
      });
  mvj(tm, n, R, dR, ld, [=](int l) { return CJP[l]; },
      [=](int l) { return dCJP[l]; }, [=](int i, float s, float ds) {
        X[i * wx + 2 * n] = __fadd_rn(s, JM[i]);
        dX[i * wx + 2 * n] = __fadd_rn(ds, dJM[i]);
      });
  mmj(tm, n, n, CRPM, dCRPM, ld, T2, dT2, ld,
      [=](int i, int j, float s, float ds) {
        X2[i * wx2 + n + j] = s;
        dX2[i * wx2 + n + j] = ds;
      });
  mvj(tm, n, CRPM, dCRPM, ld, [=](int l) { return JM[l]; },
      [=](int l) { return dJM[l]; }, [=](int i, float s, float ds) {
        X2[i * wx2 + 2 * n] = __fadd_rn(CJP[i], s);
        dX2[i * wx2 + 2 * n] = __fadd_rn(dCJP[i], ds);
      });
  float* A = ar + o.oA;
  float* M0 = ar + o.oM0;
  float* dA = dar + o.oA;
  float* dM0 = dar + o.oM0;
  mmj(tm, n, n, R, dR, ld, CRPM, dCRPM, ld,
      [=](int i, int j, float s, float ds) {
        const int e = i * ld + j;
        vsm::ns_seed(A, M0, e, i == j, s);
        dA[e] = -ds;
        dM0[e] = ds;
      });
  tm.sync();
  // X[:, wx2:wx2+2n+1] = r2mp x2
  mmj(tm, n, 2 * n + 1, R, dR, ld, X2, dX2, wx2,
      [=](int i, int j, float s, float ds) {
        X[i * wx + wx2 + j] = s;
        dX[i * wx + wx2 + j] = ds;
      });
  tm.sync();
  // M = NS inverse of a1 (ni iterations); y = M [x1 | r2mp x2] in place
  const int om =
      ns_tangent(tm, ar, dar, n, ld, o.oA, o.oM0, o.oM1, o.oTMP, sch.ni);
  mmj<C, true, true>(tm, n, wx2 + 2 * n + 1, ar + om, dar + om, ld, X, dX,
                     wx, [=](int i, int j, float s, float ds) {
                       X[i * wx + j] = s;
                       dX[i * wx + j] = ds;
                     });
  tm.sync();
  // do1 = dc_tmm y + c_tmm dy -> r_mp, t_mm, j_m;  x2 += c_rpm y[:, wx2:]
  mmj<C, false>(tm, n, 2 * n + 1, CTMM, dCTMM, ld, X, dX, wx,
                [=](int i, int j, float, float ds) {
                  if (j < n) {
                    o_rmp[kgm + i * n + j] =
                        __fadd_rn(dc_rmp[kgm + i * n + j], ds);
                  } else if (j < 2 * n) {
                    o_tmm[kgm + i * n + j - n] = ds;
                  } else {
                    o_jm[kgv + i] = __fadd_rn(dc_jm[kgv + i], ds);
                  }
                });
  mmj(tm, n, 2 * n + 1, CRPM, dCRPM, ld, X + wx2, dX + wx2, wx,
      [=](int i, int j, float s, float ds) {
        X2[i * wx2 + j] = __fadd_rn(X2[i * wx2 + j], s);
        dX2[i * wx2 + j] = __fadd_rn(dX2[i * wx2 + j], ds);
      });
  tm.sync();
  // do2 = dt2 x2 + t2 dx2 -> t_pp, r_pm (+ d r2pm), j_p (+ d jp2)
  mmj<C, false>(tm, n, 2 * n + 1, T, dT, ld, X2, dX2, wx2,
                [=](int i, int j, float, float ds) {
                  if (j < n) {
                    o_tpp[kgm + i * n + j] = ds;
                  } else if (j < 2 * n) {
                    const int jj = j - n, e = i * ld + jj;
                    const float sg = dv[i] * dv[jj];
                    const float dsg = fsum2(ddv[i], dv[jj], dv[i], ddv[jj]);
                    o_rpm[kgm + i * n + jj] =
                        __fadd_rn(fsum2(dsg, R[e], sg, dR[e]), ds);
                  } else {
                    o_jp[kgv + i] = __fadd_rn(dJP[i], ds);
                  }
                });
}

// The tangent kernel's launch entry's parameters (vsm_layer_step_tangent)
#define TANGENT_ENTRY_PARAMS                                                \
  const float *c_rmp, const float *c_rpm, const float *c_tpp,              \
      const float *c_tmm, const float *c_jp, const float *c_jm,            \
      const float *r_f, const float *t, const float *jp, const float *jm_f, \
      const float *ek, const float *d, const float *dc_rmp,                \
      const float *dc_rpm, const float *dc_tpp, const float *dc_tmm,       \
      const float *dc_jp, const float *dc_jm, const float *dr_f,           \
      const float *dt, const float *djp, const float *djm_f,               \
      const float *dek, const float *dd, float *o_rmp, float *o_rpm,       \
      float *o_tpp, float *o_tmm, float *o_jp, float *o_jm, int S, int K,  \
      int n, int ld, const int *sched, int nd, int ni, int mode,           \
      int pts_per_block, int smem_bytes, void *stream

// the widest tile class the tangent kernel is built for: its arena (twice
// the step's) leaves no block of the N <= 64 class within shared memory
constexpr int kMaxTangentNP = 48;

}  // namespace

// Launch the tangent of one layer step for K columns on `stream`: S K teams,
// pts_per_block a block, ld the arena's row stride, mode the product mode
// (vsm::Mode). Returns the cudaError_t of the launch (0 on success); the
// caller raises on anything else.
extern "C" int vsm_layer_step_tangent(TANGENT_ENTRY_PARAMS) {
  if (S <= 0 || K <= 0) return 0;
  if (n < 1 || nd < 0 || nd > kMaxSched || ni < 0
      || (long long)S * K > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const size_t need =
      (size_t)(round4(n) + pts_per_block * 2 * step_arena_floats(n, ld))
      * sizeof(float);
  using Kernel = decltype(&layer_step_tangent_kernel<vsm::C16>);
  return launch_team(
      [](auto c, auto m) -> Kernel {
        using C = decltype(c);
        if constexpr (C::NP <= kMaxTangentNP)
          return layer_step_tangent_kernel<
              vsm::WithMode<C, decltype(m)::value>>;
        return nullptr;
      },
      S * K, n, ld, mode, pts_per_block, smem_bytes, need, stream, c_rmp,
      c_rpm, c_tpp, c_tmm, c_jp, c_jm, r_f, t, jp, jm_f, ek, d, dc_rmp,
      dc_rpm, dc_tpp, dc_tmm, dc_jp, dc_jm, dr_f, dt, djp, djm_f, dek, dd,
      o_rmp, o_rpm, o_tpp, o_tmm, o_jp, o_jm, S, K, n, ld, pts_per_block,
      vsm::make_schedule(sched, nd, ni));
}
