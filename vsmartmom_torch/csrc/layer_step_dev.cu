// Split-form ("deviation form") RT layer step for Hopper: the doubling of a
// pre-split elemental layer, the D-unflip and the adding under the running
// composite, one launch per atmospheric layer, with every transmission
// operator carried as T = diag(g) + E so that no product operand holds the
// ~1.0 direct-beam diagonal.
//
// Replaces the TPU kernel vsmartmom/pallas/layer_step_kernel.py:
// _layer_step_kernel_dev (reached from _fused_layer_step_dev_prim), whose
// algebra is vsmartmom/core/rt.py:doubling_dev + interaction_dev with the
// Y-form Newton-Schulz solve over the static schedules. Every sum outside a
// product rounds as the plain version's torch ops do, with the association
// core/rt.py writes (e.g. (e + y g) + yp): __fmul_rn / __fadd_rn, never
// contracted into an FMA.
//
// Bound: as the plain layer step (layer_step.cu), a chain of small dependent
// N x N products per spectral point, O(N^3) FMAs against O(N^2) bytes of
// device memory, so arithmetic and the shared-memory loads that feed it
// bound it, not device memory. Design: the layer step's (layer_step.cu) on
// the team helpers of rt_device.cuh. A team of whole warps per point owns
// its arena in dynamic shared memory for the whole step and synchronises
// only itself; the elementwise passes are fused into the products' stores,
// and the outputs are stored to device memory straight from the last
// products. The tile classes are those of rt_device.cuh for N <= 64 and the
// fifth class C80 for N = 65 .. 75, which only this kernel instantiates.
// The JAX kernel's precision_name picks the body. "bf16x3" (three bf16
// passes, the JAX default) is layer_step_dev_tc_kernel: every product on
// the tensor cores (rt_device.cuh: mm_tc, mma.sync m16n8k16 bf16 with fp32
// accumulation), which is what the TPU kernel's modes exist for (its
// batch_mm feeds them to the matrix unit). "highest" and "default" are
// layer_step_dev_kernel, register-tiled FMA on the CUDA cores in the
// plain version's order (no TF32; "default" rounds each loaded operand to
// bf16): one bf16 pass keeps no low part, so a sum in another order moves
// an intermediate by an ulp and flips its next bf16 rounding by 2^-8; on an
// H100 the tensor cores' order left "default" up to 3.4e-4 of max from its
// plain version (PERF.md), where the step is held to 1e-5.
//
// Per doubling step (flipped space; E's slot holds [E | jp | j1m], so one
// product covers r [E | jp | j1m]):
//   B = R R, Y = B, PY[:, n:2n] = E          (one product, fused stores)
//   Y = ns_y(B)                               (sch.it[step] iterations)
//   R [E | jp | j1m]  -> PY = [rt | E | v1 | v2]
//   Y PY, in place    -> PY = [mrt | d_mt | mv1 | mv2]
//   E PY              -> R, E' (the other E slot), JM, JP, and E' 's jp,
//                        j1m columns; then g <- g g, ek <- ek ek
// Then the unflip R <- D R, JM <- D JM, E2J = [sgn E | j2m], and the
// push-through interaction, products p1 .. p6 of core/rt.py:interaction_dev
// with one Y-form solve of b1 = r2mp c_rpm:
//   p1 = r2mp [c_epp | c_jp] -> ZA = [rc_tpp | e2mm | v1]
//   p2 = c_rpm E2J           -> X2 = [crpm_t2mm | v2]
//   p3 = r2mp X2             -> P3
//   Y ZA, Y P3 (in place)    -> ZA = [y_a | d2 | y_v1], P3 = [y_b2 | y_bv]
//   p4 = c_emm ZA            -> r_mp, e_mm, j_m (device memory)
//   p5 = c_rpm [y_a], c_rpm P3 (in place) -> ZA[:, 0:n] = i1, P3 = [i2 | iv]
//   p6 = e2 [i1], e2 [i2 | iv] -> e_pp; r_pm, j_p (device memory)
//
// Per-point arena (floats; ld >= n + 2 the row stride, a multiple of 4 and
// 4 mod 8 where the arena fits; sq = n ld; every slot on 16 bytes):
//   R [sq] | E0 [sq] | E1 [sq] | G | JP | JM | GC [round4(n) each] |
//   scratch: s0 s1 | s2 s3 | s4 | s5 [sq each]
// Doubling: PY = s0 s1 (row stride 2 ld), B = s2, D = s3, Y and W = s4, s5
// (swapped by each NS iteration); E0 and E1 swap every step. Interaction:
// the NS solve in the same slots; ZA = s2 s3 (row stride 2 ld), X2 = the Y
// slot the solve leaves free, E2J = the free E slot. The composite's squares
// are staged by cp.async into slots the doubling frees: c_rpm and
// [c_epp | c_jp] into s0, s1 after the doubling (P3 = s1 once p1 has read
// it), c_emm into the solve's Y slot once Y's products are done. Staging
// them beside the doubling's state instead, while it runs, needs three
// more squares: at N = 15 that arena holds 7 points a block against 10,
// and ran slower. The block shares the D diagonal (round4(n) floats)
// ahead of its arenas; the ragged last block is masked (a team past S
// returns after the block's only barrier).

#include <cuda_runtime.h>

#include "rt_device.cuh"

namespace {

using vsm::each;
using vsm::each_flat;
using vsm::each_row;
using vsm::kMaxBlock;
using vsm::kMaxSched;
using vsm::mm;
using vsm::ns_y;
using vsm::round4;
using vsm::Schedule;
using vsm::Team;

// f(C{}) for the split-form step's tile class of width n (1 <= n <= 80);
// -1 beyond.
template <class F>
inline int with_dev_class(int n, F f) {
  if (n > 64 && n <= 80) return f(vsm::C80{});
  return vsm::with_class(n, f);
}

struct DevArena {
  int n, ld, sq;
  int oR, oE0, oE1, oG, oJP, oJM, oGC;
  int oS;                    // s0; slot k at oS + k sq
  __host__ __device__ DevArena(int n_, int ld_)
      : n(n_), ld(ld_), sq(n_ * ld_) {
    const int n4 = round4(n);
    oR = 0; oE0 = sq; oE1 = 2 * sq;
    oG = 3 * sq; oJP = oG + n4; oJM = oJP + n4; oGC = oJM + n4;
    oS = oGC + n4;
  }
  __host__ __device__ int slot(int k) const { return oS + k * sq; }
  __host__ __device__ int floats() const { return slot(6); }
};

// the step's parameters: the composite, the elemental layer, ek, the D
// diagonal, the new composite; S points, width n, row stride ld, P points a
// block, the schedule
#define DEV_STEP_PARAMS                                                     \
  const float *__restrict__ c_rmp, const float *__restrict__ c_rpm,        \
      const float *__restrict__ c_epp, const float *__restrict__ c_emm,    \
      const float *__restrict__ c_g, const float *__restrict__ c_jp,       \
      const float *__restrict__ c_jm, const float *__restrict__ r_f,       \
      const float *__restrict__ g_el, const float *__restrict__ e_el,      \
      const float *__restrict__ jp, const float *__restrict__ jm_f,        \
      const float *__restrict__ ek, const float *__restrict__ d,           \
      float *__restrict__ o_rmp, float *__restrict__ o_rpm,                \
      float *__restrict__ o_epp, float *__restrict__ o_emm,                \
      float *__restrict__ o_g, float *__restrict__ o_jp,                   \
      float *__restrict__ o_jm, int S, int n, int ld, int P, Schedule sch
#define DEV_STEP_ARGS                                                       \
  c_rmp, c_rpm, c_epp, c_emm, c_g, c_jp, c_jm, r_f, g_el, e_el, jp, jm_f,  \
      ek, d, o_rmp, o_rpm, o_epp, o_emm, o_g, o_jp, o_jm, S, n, ld, P, sch

template <class C>
__device__ __forceinline__ void layer_step_dev(DEV_STEP_PARAMS) {
  extern __shared__ float smem[];
  float* dv = smem;  // D-matrix diagonal, shared by all points
  for (int i = threadIdx.x; i < n; i += blockDim.x) dv[i] = d[i];
  __syncthreads();
  const int team = threadIdx.x / C::TT;
  const int p = blockIdx.x * P + team;
  if (p >= S) return;
  const Team<C> tm(threadIdx.x - team * C::TT, 1 + team);
  const DevArena o(n, ld);
  float* ar = smem + round4(n) + team * o.floats();
  const size_t gm = (size_t)p * n * n, gv = (size_t)p * n;
  const int w2 = 2 * ld;  // row stride of the two-square slots PY, ZA

  float* R = ar + o.oR;
  float* G = ar + o.oG;
  float* JP = ar + o.oJP;
  float* JM = ar + o.oJM;
  float* GC = ar + o.oGC;
  float* PY = ar + o.slot(0);
  float* B = ar + o.slot(2);

  // ---- load: the elemental layer, g and c_g -------------------------------
  float ekp = ek[p];
  {
    float* E0 = ar + o.oE0;
    each_flat(tm, n, n, [=](int i, int j) {
      R[i * ld + j] = r_f[gm + i * n + j];
      E0[i * ld + j] = e_el[gm + i * n + j];
    });
    each_row(tm, n, [=](int i) {
      G[i] = g_el[gv + i];
      JP[i] = jp[gv + i];
      JM[i] = jm_f[gv + i];
      GC[i] = c_g[gv + i];
      E0[i * ld + n] = jp[gv + i];
      E0[i * ld + n + 1] = __fmul_rn(jm_f[gv + i], ekp);
    });
  }
  tm.sync();

  // ---- 1. split-form doubling (flipped space) -----------------------------
  int oE = o.oE0, oEn = o.oE1, oY = o.slot(4), oW = o.slot(5);
  const int oD = o.slot(3);
  for (int step = 0; step < sch.nd; ++step) {
    const float* E = ar + oE;
    float* En = ar + oEn;
    {
      float* Y = ar + oY;
      mm(tm, n, n, R, ld, R, ld, [=](int i, int j, float s) {
        B[i * ld + j] = s;
        Y[i * ld + j] = s;
        PY[i * w2 + n + j] = E[i * ld + j];
      });
    }
    tm.sync();
    oY = ns_y(tm, ar, n, ld, o.slot(2), oY, oW, oD, sch.it[step]);
    oW = oY == o.slot(4) ? o.slot(5) : o.slot(4);
    const float* Y = ar + oY;
    // rp = R [E | jp | j1m]: rt = R g + R E, v1 = j1m + R jp, v2 = jp + R j1m
    mm(tm, n, n + 2, R, ld, E, ld, [=](int i, int j, float s) {
      if (j < n) {
        PY[i * w2 + j] = __fadd_rn(__fmul_rn(R[i * ld + j], G[j]), s);
      } else if (j == n) {
        PY[i * w2 + 2 * n] = __fadd_rn(E[i * ld + n + 1], s);
      } else {
        PY[i * w2 + 2 * n + 1] = __fadd_rn(JP[i], s);
      }
    });
    tm.sync();
    // yp = Y [rt | E | v1 | v2]: mrt = rt + ., d_mt = (E + Y g) + ., mv1,
    // mv2
    mm<C, true>(tm, n, 2 * n + 2, Y, ld, PY, w2, [=](int i, int j, float s) {
      float* q = PY + i * w2 + j;
      if (j >= n && j < 2 * n) {
        const int c = j - n;
        *q = __fadd_rn(__fadd_rn(E[i * ld + c],
                                 __fmul_rn(Y[i * ld + c], G[c])), s);
      } else {
        *q = __fadd_rn(*q, s);
      }
    });
    tm.sync();
    // ep = E [mrt | d_mt | mv1 | mv2]: r = (r + g mrt) + ., e' = (g d_mt +
    // e g) + ., jm = (jm + g mv1) + ., jp = (jp ek + g mv2) + .
    const float ek2 = __fmul_rn(ekp, ekp);
    const float ekc = ekp;
    mm(tm, n, 2 * n + 2, E, ld, PY, w2, [=](int i, int j, float s) {
      const float gi = G[i];
      const float* q = PY + i * w2;
      if (j < n) {
        R[i * ld + j] =
            __fadd_rn(__fadd_rn(R[i * ld + j], __fmul_rn(gi, q[j])), s);
      } else if (j < 2 * n) {
        const int c = j - n;
        En[i * ld + c] = __fadd_rn(__fadd_rn(__fmul_rn(gi, q[j]),
                                             __fmul_rn(E[i * ld + c], G[c])),
                                   s);
      } else if (j == 2 * n) {
        const float m = __fadd_rn(__fadd_rn(JM[i], __fmul_rn(gi, q[j])), s);
        JM[i] = m;
        En[i * ld + n + 1] = __fmul_rn(m, ek2);
      } else {
        const float v = __fadd_rn(
            __fadd_rn(__fmul_rn(JP[i], ekc), __fmul_rn(gi, q[j])), s);
        JP[i] = v;
        En[i * ld + n] = v;
      }
    });
    tm.sync();
    // read next after the next step's first product and its barrier
    each_row(tm, n, [=](int i) { G[i] = __fmul_rn(G[i], G[i]); });
    const int x = oE;
    oE = oEn;
    oEn = x;
    ekp = ek2;
  }

  // ---- 2. un-flip: R <- D R (r2mp), JM <- D JM (j2m), E2J = [sgn E | j2m]
  const float* E = ar + oE;
  float* E2J = ar + oEn;
  each(tm, n, n, [=](int i, int j) {
    R[i * ld + j] = __fmul_rn(dv[i], R[i * ld + j]);
    E2J[i * ld + j] = __fmul_rn(__fmul_rn(dv[i], dv[j]), E[i * ld + j]);
  });
  each_row(tm, n, [=](int i) {
    const float m = __fmul_rn(dv[i], JM[i]);
    JM[i] = m;
    E2J[i * ld + n] = m;
  });
  // c_rpm -> CRPM, [c_epp | c_jp] -> CEP, into the doubling's PY
  float* CRPM = ar + o.slot(0);
  float* CEP = ar + o.slot(1);
  each_flat(tm, n, n, [=](int i, int j) {
    vsm::cp_async4(CRPM + i * ld + j, c_rpm + gm + i * n + j);
    vsm::cp_async4(CEP + i * ld + j, c_epp + gm + i * n + j);
  });
  each_row(tm, n,
           [=](int i) { vsm::cp_async4(CEP + i * ld + n, c_jp + gv + i); });
  vsm::cp_async_commit();
  vsm::cp_async_wait_all();
  tm.sync();

  // ---- 3. split-form interaction (push-through single solve) --------------
  // b1 = r2mp c_rpm, Y = b1; Y = ns_y(b1)
  {
    float* Y = ar + oY;
    mm(tm, n, n, R, ld, CRPM, ld, [=](int i, int j, float s) {
      B[i * ld + j] = s;
      Y[i * ld + j] = s;
    });
  }
  tm.sync();
  oY = ns_y(tm, ar, n, ld, o.slot(2), oY, oW, oD, sch.ni);
  float* Y = ar + oY;
  float* X2 = ar + (oY == o.slot(4) ? o.slot(5) : o.slot(4));
  float* ZA = B;  // s2 s3, row stride w2
  float* P3 = CEP;  // once p1 has read it
  // p1 = r2mp [c_epp | c_jp]: ZA = [rc_tpp | e2mm | v1], rc_tpp = r2mp gc +
  // p1, v1 = p1 + j2m
  mm(tm, n, n + 1, R, ld, CEP, ld, [=](int i, int j, float s) {
    if (j < n) {
      ZA[i * w2 + j] = __fadd_rn(__fmul_rn(R[i * ld + j], GC[j]), s);
      ZA[i * w2 + n + j] = E2J[i * ld + j];
    } else {
      ZA[i * w2 + 2 * n] = __fadd_rn(s, JM[i]);
    }
  });
  // p2 = c_rpm [e2mm | j2m]: X2 = [crpm_t2mm | v2], crpm_t2mm = c_rpm g2 +
  // p2, v2 = c_jp + p2
  mm(tm, n, n + 1, CRPM, ld, E2J, ld, [=](int i, int j, float s) {
    if (j < n) {
      X2[i * ld + j] = __fadd_rn(__fmul_rn(CRPM[i * ld + j], G[j]), s);
    } else {
      X2[i * ld + n] = __fadd_rn(c_jp[gv + i], s);
    }
  });
  tm.sync();
  // p3 = r2mp [crpm_t2mm | v2]
  mm(tm, n, n + 1, R, ld, X2, ld,
     [=](int i, int j, float s) { P3[i * ld + j] = s; });
  tm.sync();
  // Y ZA in place: [y_a | d2 | y_v1], d2 = (e2mm + Y g2) + .; Y P3 in
  // place: [y_b2 | y_bv]
  mm<C, true>(tm, n, 2 * n + 1, Y, ld, ZA, w2, [=](int i, int j, float s) {
    float* z = ZA + i * w2 + j;
    if (j >= n && j < 2 * n) {
      const int c = j - n;
      *z = __fadd_rn(__fadd_rn(*z, __fmul_rn(Y[i * ld + c], G[c])), s);
    } else {
      *z = __fadd_rn(*z, s);
    }
  });
  mm<C, true>(tm, n, n + 1, Y, ld, P3, ld, [=](int i, int j, float s) {
    P3[i * ld + j] = __fadd_rn(P3[i * ld + j], s);
  });
  tm.sync();
  // c_emm -> CEMM, into Y's slot, free now
  float* CEMM = Y;
  each_flat(tm, n, n, [=](int i, int j) {
    vsm::cp_async4(CEMM + i * ld + j, c_emm + gm + i * n + j);
  });
  vsm::cp_async_commit();
  vsm::cp_async_wait_all();
  tm.sync();
  // p4 = c_emm [y_a | d2 | y_v1]: r_mp = (c_rmp + gc y_a) + ., e_mm =
  // (gc d2 + c_emm g2) + ., j_m = (c_jm + gc y_v1) + .
  {
    const float* CE = CEMM;
    mm(tm, n, 2 * n + 1, CE, ld, ZA, w2, [=](int i, int j, float s) {
      const float gci = GC[i];
      const float z = ZA[i * w2 + j];
      if (j < n) {
        o_rmp[gm + i * n + j] = __fadd_rn(
            __fadd_rn(c_rmp[gm + i * n + j], __fmul_rn(gci, z)), s);
      } else if (j < 2 * n) {
        const int c = j - n;
        o_emm[gm + i * n + c] = __fadd_rn(
            __fadd_rn(__fmul_rn(gci, z), __fmul_rn(CE[i * ld + c], G[c])),
            s);
      } else {
        o_jm[gv + i] = __fadd_rn(__fadd_rn(c_jm[gv + i], __fmul_rn(gci, z)),
                                 s);
      }
    });
  }
  tm.sync();
  // p5 = c_rpm [y_a | y_b2 | y_bv] in place: i1 = c_epp + ., [i2 | iv] =
  // [crpm_t2mm | v2] + .
  mm<C, true>(tm, n, n, CRPM, ld, ZA, w2, [=](int i, int j, float s) {
    ZA[i * w2 + j] = __fadd_rn(c_epp[gm + i * n + j], s);
  });
  mm<C, true>(tm, n, n + 1, CRPM, ld, P3, ld, [=](int i, int j, float s) {
    P3[i * ld + j] = __fadd_rn(X2[i * ld + j], s);
  });
  tm.sync();
  // p6 = e2 [i1 | i2 | iv]: e_pp = (g2 i1 + e2 gc) + ., r_pm = (sgn r2mp +
  // g2 i2) + ., j_p = (j2p + g2 iv) + .; g = gc g2
  mm(tm, n, n, E, ld, ZA, w2, [=](int i, int j, float s) {
    o_epp[gm + i * n + j] = __fadd_rn(
        __fadd_rn(__fmul_rn(G[i], ZA[i * w2 + j]),
                  __fmul_rn(E[i * ld + j], GC[j])), s);
  });
  mm(tm, n, n + 1, E, ld, P3, ld, [=](int i, int j, float s) {
    const float q = __fmul_rn(G[i], P3[i * ld + j]);
    if (j < n) {
      o_rpm[gm + i * n + j] = __fadd_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(dv[i], dv[j]), R[i * ld + j]), q),
          s);
    } else {
      o_jp[gv + i] = __fadd_rn(__fadd_rn(JP[i], q), s);
    }
  });
  each_row(tm, n, [=](int i) { o_g[gv + i] = __fmul_rn(GC[i], G[i]); });
}

// On the CUDA cores: full fp32, or "default"'s one bf16 pass with the
// operands rounded in registers. (kMaxBlock, 1): with the block bound alone
// ptxas holds the C16 instantiation to 64 registers and spills it to a
// 56-byte stack.
template <class C>
__global__ void __launch_bounds__(kMaxBlock, 1)
layer_step_dev_kernel(DEV_STEP_PARAMS) {
  layer_step_dev<C>(DEV_STEP_ARGS);
}

// The tensor-core body's block bound: the most threads a launch of class C
// takes (build.team_launch_config: half an SM's shared memory holds two
// N <= 48 points at most from N = 33, one from N = 49), so that ptxas may
// give a thread 65 536 / bound registers. Under kMaxBlock's 128 the
// fragments a warp keeps (8 registers a k tile) spilled the C48, C64 and
// C80 classes to 48-264-byte stacks.
template <class C>
constexpr int tc_block_bound() {
  return C::NP <= 32 ? kMaxBlock : C::NP == 48 ? 2 * C::TT : C::TT;
}

// bf16x3, every product on the tensor cores (C::TC).
template <class C>
__global__ void __launch_bounds__(tc_block_bound<C>(), 1)
layer_step_dev_tc_kernel(DEV_STEP_PARAMS) {
  static_assert(C::TC, "the tensor-core step takes a tensor-core class");
  layer_step_dev<C>(DEV_STEP_ARGS);
}

// The launch entries' parameters (vsm_layer_step_dev below).
#define DEV_ENTRY_PARAMS                                                    \
  const float *c_rmp, const float *c_rpm, const float *c_epp,              \
      const float *c_emm, const float *c_g, const float *c_jp,             \
      const float *c_jm, const float *r_f, const float *g_el,              \
      const float *e_el, const float *jp, const float *jm_f,               \
      const float *ek, const float *d, float *o_rmp, float *o_rpm,         \
      float *o_epp, float *o_emm, float *o_g, float *o_jp, float *o_jm,    \
      int S, int n, int ld, const int *sched, int nd, int ni, int mode,    \
      int pts_per_block, int smem_bytes, void *stream
#define DEV_ENTRY_ARGS                                                      \
  c_rmp, c_rpm, c_epp, c_emm, c_g, c_jp, c_jm, r_f, g_el, e_el, jp, jm_f,  \
      ek, d, o_rmp, o_rpm, o_epp, o_emm, o_g, o_jp, o_jm, S, n, ld, sched,  \
      nd, ni, mode, pts_per_block, smem_bytes, stream

// Checks the launch and launches pick(class, mode)'s kernel, which is
// nullptr for a mode the entry does not take.
template <class Pick>
int launch_dev(Pick pick, DEV_ENTRY_PARAMS) {
  if (S <= 0) return 0;
  if (n < 1 || nd < 0 || nd > kMaxSched || ni < 0 || pts_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const int tt = with_dev_class(n, [](auto c) { return decltype(c)::TT; });
  if (tt < 0 || ld < n + 2 || ld % 4 != 0
      || pts_per_block * tt > kMaxBlock)
    return (int)cudaErrorInvalidValue;
  const size_t need =
      (round4(n) + (size_t)pts_per_block * DevArena(n, ld).floats())
      * sizeof(float);
  if ((size_t)smem_bytes < need) return (int)cudaErrorInvalidValue;
  const Schedule s = vsm::make_schedule(sched, nd, ni);
  const int blocks = (S + pts_per_block - 1) / pts_per_block;
  const int err = with_dev_class(n, [&](auto c) {
    return vsm::with_mode(mode, [&](auto m) {
      auto* kern = pick(c, m);
      if (kern == nullptr) return (int)cudaErrorInvalidValue;
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (e != cudaSuccess) return (int)e;
      kern<<<blocks, pts_per_block * tt, smem_bytes,
             (cudaStream_t)stream>>>(
          c_rmp, c_rpm, c_epp, c_emm, c_g, c_jp, c_jm, r_f, g_el, e_el, jp,
          jm_f, ek, d, o_rmp, o_rpm, o_epp, o_emm, o_g, o_jp, o_jm, S, n,
          ld, pts_per_block, s);
      return (int)cudaGetLastError();
    });
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

// every split-form kernel has this type
using DevKernel = decltype(&layer_step_dev_kernel<vsm::C16>);

}  // namespace

// Launch one split-form layer step on `stream`: ld is the arena's row stride
// (>= n + 2, a multiple of 4), mode the product mode (vsm::Mode),
// pts_per_block the teams of a block. vsm_layer_step_dev takes "highest"
// and "default" (the body on the CUDA cores), vsm_layer_step_dev_tc
// "bf16x3" (the tensor-core body); each refuses the other's. Returns the
// cudaError_t of the launch (0 on success); the caller raises on anything
// else.
extern "C" int vsm_layer_step_dev(DEV_ENTRY_PARAMS) {
  return launch_dev(
      [](auto c, auto m) -> DevKernel {
        constexpr int M = decltype(m)::value;
        if constexpr (M != vsm::kBf16x3)
          return layer_step_dev_kernel<vsm::WithMode<decltype(c), M>>;
        return nullptr;
      },
      DEV_ENTRY_ARGS);
}

extern "C" int vsm_layer_step_dev_tc(DEV_ENTRY_PARAMS) {
  return launch_dev(
      [](auto c, auto m) -> DevKernel {
        if constexpr (decltype(m)::value == vsm::kBf16x3)
          return layer_step_dev_tc_kernel<vsm::WithTensorCores<decltype(c)>>;
        return nullptr;
      },
      DEV_ENTRY_ARGS);
}
