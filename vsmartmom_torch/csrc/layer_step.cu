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
// (N <= 63) on its own data, O(N^3) fp32 FMAs against O(N^2) bytes of device
// memory per layer, so the kernels are bound by arithmetic and by the
// shared-memory loads that feed it, not by device memory. Design: a team of
// whole warps per spectral point (one warp at N <= 16, 2 / 6 / 8 warps for
// the width classes 32 / 48 / 64, rt_device.cuh), a block holding as many
// teams as half an SM's shared memory takes. Each team owns its point's
// arena in dynamic shared memory for the whole step (elemental layer, NS
// iterates, packed operands, the composite's c_rpm and c_tmm) and
// synchronises only itself. Products are register-tiled (TM x TN outputs a
// thread) with the elementwise passes fused into their stores: the NS seed
// and 2I - A M, the W1 packing and the state update of the doubling, the
// outputs of the interaction, stored to device memory straight from the
// products. c_rpm and c_tmm arrive by cp.async while the doubling runs.
// fp32 FMA on the CUDA cores: no TF32. Every output is the fmaf chain of the
// block-wide version over l in order, with the same association of every
// product. Both kernels are templates on the tile class and the product
// mode of the JAX kernels' precision_name (rt_device.cuh: full fp32, or one
// or three bf16 passes, the operands rounded in registers), which covers
// every product, the mv products of the source vectors (JAX's packed vector
// columns) included. At "high" (bf16x3) the N <= 16 class runs the same
// bodies with every N x N product on the tensor cores (layer_step_tc_kernel,
// doubling_tc_kernel: rt_device.cuh mm_tc, mma.sync m16n8k16 bf16, fp32
// accumulation, the diagonal terms of T and the Newton-Schulz iterates in
// the a_hi b_hi pass summed apart and added after it (kTcDiag); the mv
// products keep their three passes on the CUDA cores), launched through
// their own entries.
//
// Per-point arena (floats; sq = n ld, ld the padded row stride, every slot
// on 16 bytes): the doubling's Arena (R, T, A, M0, M1, TMP, JP, JM, W1, W2;
// rt_device.cuh), whose region from W1 on the interaction reuses as
//   X [n x 2 wx2] | X2 [n x wx2],  wx2 = round4(2n + 1),
// then CRPM [sq] | CTMM [sq]. The block shares the D diagonal (round4(n)
// floats) ahead of its arenas. The doubling-only kernel's arena ends after
// W2.

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
using vsm::launch_team;
using vsm::load_elemental;
using vsm::mm;
using vsm::mv;
using vsm::ns;
using vsm::ns_seed;
using vsm::round4;
using vsm::Schedule;
using vsm::step_arena_floats;
using vsm::step_composite_offset;
using vsm::Team;
using vsm::x2_stride;

// The layer step's parameters and their names (the body below and its two
// kernels)
#define LAYER_STEP_PARAMS                                                   \
  const float *__restrict__ c_rmp, const float *__restrict__ c_rpm,        \
      const float *__restrict__ c_tpp, const float *__restrict__ c_tmm,    \
      const float *__restrict__ c_jp, const float *__restrict__ c_jm,      \
      const float *__restrict__ r_f, const float *__restrict__ t,          \
      const float *__restrict__ jp, const float *__restrict__ jm_f,        \
      const float *__restrict__ ek, const float *__restrict__ d,           \
      float *__restrict__ o_rmp, float *__restrict__ o_rpm,                \
      float *__restrict__ o_tpp, float *__restrict__ o_tmm,                \
      float *__restrict__ o_jp, float *__restrict__ o_jm, int S, int n,    \
      int ld, int P, Schedule sch
#define LAYER_STEP_ARGS                                                     \
  c_rmp, c_rpm, c_tpp, c_tmm, c_jp, c_jm, r_f, t, jp, jm_f, ek, d, o_rmp,  \
      o_rpm, o_tpp, o_tmm, o_jp, o_jm, S, n, ld, P, sch

template <class C>
__device__ __forceinline__ void layer_step(LAYER_STEP_PARAMS) {
  extern __shared__ float smem[];
  float* dv = smem;  // D-matrix diagonal, shared by all points
  for (int i = threadIdx.x; i < n; i += blockDim.x) dv[i] = d[i];
  __syncthreads();
  const int team = threadIdx.x / C::TT;
  const int p = blockIdx.x * P + team;
  if (p >= S) return;
  const Team<C> tm(threadIdx.x - team * C::TT, 1 + team);
  float* ar = smem + round4(n) + team * step_arena_floats(n, ld);
  Arena o(n, ld);
  const size_t gm = (size_t)p * n * n, gv = (size_t)p * n;

  // ---- load: c_rpm, c_tmm by cp.async (overlapping the doubling) ---------
  float* CRPM = ar + step_composite_offset(n, ld);
  float* CTMM = CRPM + n * ld;
  each_flat(tm, n, n, [=](int i, int j) {
    vsm::cp_async4(CRPM + i * ld + j, c_rpm + gm + i * n + j);
    vsm::cp_async4(CTMM + i * ld + j, c_tmm + gm + i * n + j);
  });
  vsm::cp_async_commit();
  load_elemental(tm, ar, o, p, r_f, t, jp, jm_f);
  tm.sync();

  // ---- 1. doubling (flipped space) ----------------------------------------
  doubling_phase(tm, ar, o, ek[p], sch);

  float* R = ar + o.oR;
  const float* T = ar + o.oT;
  const float* JP = ar + o.oJP;
  float* JM = ar + o.oJM;
  float* A = ar + o.oA;
  float* M0 = ar + o.oM0;
  // until the NS solve takes their slots: t2mm (an aligned copy, the B of
  // c_rpm t2mm) and c_jp
  float* T2 = ar + o.oTMP;
  float* CJP = ar + o.oM1;
  const int wx2 = x2_stride(n), wx = 2 * wx2;
  float* X = ar + o.oW1;
  float* X2 = X + n * wx;

  // ---- 2. un-flip R <- D R (r2mp), JM <- D JM (j2m); t2mm, c_tpp, c_jp ----
  each(tm, n, n, [=](int i, int j) {
    R[i * ld + j] = dv[i] * R[i * ld + j];
    const float t2 = (dv[i] * dv[j]) * T[i * ld + j];
    X[i * wx + n + j] = t2;
    T2[i * ld + j] = t2;
  });
  each_flat(tm, n, n, [=](int i, int j) {
    X2[i * wx2 + j] = c_tpp[gm + i * n + j];
  });
  each_row(tm, n, [=](int i) {
    JM[i] = dv[i] * JM[i];
    CJP[i] = c_jp[gv + i];
  });
  vsm::cp_async_wait_all();
  tm.sync();

  // ---- 3. interaction under the composite (push-through) ------------------
  // x1 = [r2mp c_tpp | t2mm | r2mp c_jp + j2m]           -> X[:, 0:2n+1]
  // x2 = [c_tpp | c_rpm t2mm | c_jp + c_rpm j2m]         -> X2[:, 0:2n+1]
  // a1 = I - r2mp c_rpm (and the NS seed)
  mm(tm, n, n, R, ld, X2, wx2,
     [=](int i, int j, float s) { X[i * wx + j] = s; });
  mv(tm, n, R, ld, [=](int l) { return CJP[l]; },
     [=](int i, float s) { X[i * wx + 2 * n] = __fadd_rn(s, JM[i]); });
  mm(tm, n, n, CRPM, ld, T2, ld,
     [=](int i, int j, float s) { X2[i * wx2 + n + j] = s; });
  mv(tm, n, CRPM, ld, [=](int l) { return JM[l]; },
     [=](int i, float s) { X2[i * wx2 + 2 * n] = __fadd_rn(CJP[i], s); });
  mm(tm, n, n, R, ld, CRPM, ld, [=](int i, int j, float s) {
    ns_seed(A, M0, i * ld + j, i == j, s);
  });
  tm.sync();
  // X[:, wx2:wx2+2n+1] = r2mp x2
  mm(tm, n, 2 * n + 1, R, ld, X2, wx2,
     [=](int i, int j, float s) { X[i * wx + wx2 + j] = s; });
  tm.sync();
  // M1 = NS inverse of a1 (ni iterations); y = M1 [x1 | r2mp x2] in place
  const float* M =
      ar + ns(tm, ar, n, ld, o.oA, o.oM0, o.oM1, o.oTMP, sch.ni);
  mm<C, true>(tm, n, wx2 + 2 * n + 1, M, ld, X, wx,
              [=](int i, int j, float s) { X[i * wx + j] = s; });
  tm.sync();
  // o1 = c_tmm y[:, 0:2n+1] -> r_mp, t_mm, j_m;  x2 += c_rpm y[:, wx2:]
  mm(tm, n, 2 * n + 1, CTMM, ld, X, wx, [=](int i, int j, float s) {
    if (j < n) {
      o_rmp[gm + i * n + j] = __fadd_rn(c_rmp[gm + i * n + j], s);
    } else if (j < 2 * n) {
      o_tmm[gm + i * n + j - n] = s;
    } else {
      o_jm[gv + i] = __fadd_rn(c_jm[gv + i], s);
    }
  });
  mm(tm, n, 2 * n + 1, CRPM, ld, X + wx2, wx, [=](int i, int j, float s) {
    X2[i * wx2 + j] = __fadd_rn(X2[i * wx2 + j], s);
  });
  tm.sync();
  // o2 = t2 x2 -> t_pp, r_pm, j_p
  mm(tm, n, 2 * n + 1, T, ld, X2, wx2, [=](int i, int j, float s) {
    if (j < n) {
      o_tpp[gm + i * n + j] = s;
    } else if (j < 2 * n) {
      o_rpm[gm + i * n + j - n] =
          __fadd_rn((dv[i] * dv[j - n]) * R[i * ld + j - n], s);
    } else {
      o_jp[gv + i] = __fadd_rn(JP[i], s);
    }
  });
}

// Full fp32: the launch bound alone, as before the product modes.
template <class C>
__global__ void __launch_bounds__(kMaxBlock)
layer_step_kernel(LAYER_STEP_PARAMS) {
  layer_step<C>(LAYER_STEP_ARGS);
}

// A bf16 mode: (kMaxBlock, 1), as the split-form step has it: with the
// block bound alone ptxas holds the N <= 16 class at bf16x3 to 64 registers
// and spills it to a 64-byte stack.
template <class C>
__global__ void __launch_bounds__(kMaxBlock, 1)
layer_step_kernel_bf16(LAYER_STEP_PARAMS) {
  layer_step<C>(LAYER_STEP_ARGS);
}

// Whether class C has a tensor-core body: kTcDiag sums one k tile
// (rt_device.cuh mm_tc), the N <= 16 class alone. Which widths take it is
// the wrapper's choice (cuda/layer_step_kernel.py on_tensor_cores).
template <class C>
constexpr bool has_tc_body() {
  return C::NP == 16;
}

// "high" (bf16x3), every N x N product on the tensor cores (C::TC), under
// the bf16 kernels' (kMaxBlock, 1): a launch takes 16 points of one warp at
// most, and the A fragments mm_tc keeps take 8 registers.
template <class C>
__global__ void __launch_bounds__(kMaxBlock, 1)
layer_step_tc_kernel(LAYER_STEP_PARAMS) {
  static_assert(C::TC == vsm::kTcDiag, "the step takes kTcDiag classes");
  layer_step<C>(LAYER_STEP_ARGS);
}

// The doubling kernels' parameters and their names
#define DOUBLING_PARAMS                                                     \
  const float *__restrict__ r_f, const float *__restrict__ t,              \
      const float *__restrict__ jp, const float *__restrict__ jm_f,        \
      const float *__restrict__ ek, float *__restrict__ o_r,               \
      float *__restrict__ o_t, float *__restrict__ o_jp,                   \
      float *__restrict__ o_jm, int S, int n, int ld, int P, Schedule sch
#define DOUBLING_ARGS \
  r_f, t, jp, jm_f, ek, o_r, o_t, o_jp, o_jm, S, n, ld, P, sch

template <class C>
__device__ __forceinline__ void doubling(DOUBLING_PARAMS) {
  extern __shared__ float smem[];
  const int team = threadIdx.x / C::TT;
  const int p = blockIdx.x * P + team;
  if (p >= S) return;
  const Team<C> tm(threadIdx.x - team * C::TT, 1 + team);
  float* ar = smem + team * doubling_arena_floats(n, ld);
  Arena o(n, ld);
  load_elemental(tm, ar, o, p, r_f, t, jp, jm_f);
  tm.sync();
  doubling_phase(tm, ar, o, ek[p], sch);
  const size_t gm = (size_t)p * n * n, gv = (size_t)p * n;
  const float* R = ar + o.oR;
  const float* T = ar + o.oT;
  each_flat(tm, n, n, [=](int i, int j) {
    o_r[gm + i * n + j] = R[i * ld + j];
    o_t[gm + i * n + j] = T[i * ld + j];
  });
  each_row(tm, n, [=](int i) {
    o_jp[gv + i] = ar[o.oJP + i];
    o_jm[gv + i] = ar[o.oJM + i];
  });
}

template <class C>
__global__ void __launch_bounds__(kMaxBlock)
doubling_kernel(DOUBLING_PARAMS) {
  doubling<C>(DOUBLING_ARGS);
}

// "high" (bf16x3), every N x N product on the tensor cores (C::TC),
// under (kMaxBlock, 1) as layer_step_tc_kernel.
template <class C>
__global__ void __launch_bounds__(kMaxBlock, 1)
doubling_tc_kernel(DOUBLING_PARAMS) {
  static_assert(C::TC == vsm::kTcDiag, "the doubling takes kTcDiag classes");
  doubling<C>(DOUBLING_ARGS);
}

// every layer-step kernel, and every doubling kernel, has this type
using StepKernel = decltype(&layer_step_kernel<vsm::C16>);
using DoublingKernel = decltype(&doubling_kernel<vsm::C16>);

// The layer step's launch entries' parameters (vsm_layer_step below)
#define STEP_ENTRY_PARAMS                                                   \
  const float *c_rmp, const float *c_rpm, const float *c_tpp,              \
      const float *c_tmm, const float *c_jp, const float *c_jm,            \
      const float *r_f, const float *t, const float *jp, const float *jm_f, \
      const float *ek, const float *d, float *o_rmp, float *o_rpm,         \
      float *o_tpp, float *o_tmm, float *o_jp, float *o_jm, int S, int n,  \
      int ld, const int *sched, int nd, int ni, int mode,                  \
      int pts_per_block, int smem_bytes, void *stream

template <class Pick>
int launch_step(Pick pick, STEP_ENTRY_PARAMS) {
  if (S <= 0) return 0;
  if (n < 1 || nd < 0 || nd > kMaxSched || ni < 0)
    return (int)cudaErrorInvalidValue;
  const size_t need =
      (size_t)(round4(n) + pts_per_block * step_arena_floats(n, ld))
      * sizeof(float);
  return launch_team(pick, S, n, ld, mode, pts_per_block, smem_bytes, need,
                     stream, c_rmp, c_rpm, c_tpp, c_tmm, c_jp, c_jm, r_f, t,
                     jp, jm_f, ek, d, o_rmp, o_rpm, o_tpp, o_tmm, o_jp, o_jm,
                     S, n, ld, pts_per_block,
                     vsm::make_schedule(sched, nd, ni));
}

// The doubling's launch entries' parameters (vsm_doubling below)
#define DOUBLING_ENTRY_PARAMS                                               \
  const float *r_f, const float *t, const float *jp, const float *jm_f,    \
      const float *ek, float *o_r, float *o_t, float *o_jp, float *o_jm,   \
      int S, int n, int ld, const int *sched, int nd, int mode,            \
      int pts_per_block, int smem_bytes, void *stream

template <class Pick>
int launch_doubling(Pick pick, DOUBLING_ENTRY_PARAMS) {
  if (S <= 0) return 0;
  if (n < 1 || nd < 0 || nd > kMaxSched) return (int)cudaErrorInvalidValue;
  const size_t need =
      (size_t)pts_per_block * doubling_arena_floats(n, ld) * sizeof(float);
  return launch_team(pick, S, n, ld, mode, pts_per_block, smem_bytes, need,
                     stream, r_f, t, jp, jm_f, ek, o_r, o_t, o_jp, o_jm, S,
                     n, ld, pts_per_block, vsm::make_schedule(sched, nd, 0));
}

}  // namespace

// Launch one layer step on `stream`: ld is the arena's padded row stride
// (>= n, a multiple of 4), mode the product mode (vsm::Mode),
// pts_per_block the teams of a block. vsm_layer_step runs the body on the
// CUDA cores at every mode and class, vsm_layer_step_tc the tensor-core body
// at "high" (bf16x3) in the classes that have one (has_tc_body) and refuses
// the rest. Returns the cudaError_t of the launch (0 on success); the caller
// raises on anything else.
extern "C" int vsm_layer_step(STEP_ENTRY_PARAMS) {
  return launch_step(
      [](auto c, auto m) -> StepKernel {
        using C = decltype(c);
        constexpr int M = decltype(m)::value;
        if constexpr (M == vsm::kHighest)
          return layer_step_kernel<C>;
        else
          return layer_step_kernel_bf16<vsm::WithMode<C, M>>;
      },
      c_rmp, c_rpm, c_tpp, c_tmm, c_jp, c_jm, r_f, t, jp, jm_f, ek, d, o_rmp,
      o_rpm, o_tpp, o_tmm, o_jp, o_jm, S, n, ld, sched, nd, ni, mode,
      pts_per_block, smem_bytes, stream);
}

extern "C" int vsm_layer_step_tc(STEP_ENTRY_PARAMS) {
  return launch_step(
      [](auto c, auto m) -> StepKernel {
        using C = decltype(c);
        if constexpr (decltype(m)::value == vsm::kBf16x3
                      && has_tc_body<C>())
          return layer_step_tc_kernel<vsm::WithTensorCores<C, vsm::kTcDiag>>;
        return nullptr;
      },
      c_rmp, c_rpm, c_tpp, c_tmm, c_jp, c_jm, r_f, t, jp, jm_f, ek, d, o_rmp,
      o_rpm, o_tpp, o_tmm, o_jp, o_jm, S, n, ld, sched, nd, ni, mode,
      pts_per_block, smem_bytes, stream);
}

// Launch the doubling recursion alone on `stream`: (r, t, jp, jm) of S points
// grown over the nd scheduled steps, products in `mode`. vsm_doubling runs
// the body on the CUDA cores at every mode and class, vsm_doubling_tc the
// tensor-core body as vsm_layer_step_tc does. Returns the launch's
// cudaError_t.
extern "C" int vsm_doubling(DOUBLING_ENTRY_PARAMS) {
  return launch_doubling(
      [](auto c, auto m) -> DoublingKernel {
        return doubling_kernel<
            vsm::WithMode<decltype(c), decltype(m)::value>>;
      },
      r_f, t, jp, jm_f, ek, o_r, o_t, o_jp, o_jm, S, n, ld, sched, nd, mode,
      pts_per_block, smem_bytes, stream);
}

extern "C" int vsm_doubling_tc(DOUBLING_ENTRY_PARAMS) {
  return launch_doubling(
      [](auto c, auto m) -> DoublingKernel {
        using C = decltype(c);
        if constexpr (decltype(m)::value == vsm::kBf16x3
                      && has_tc_body<C>())
          return doubling_tc_kernel<vsm::WithTensorCores<C, vsm::kTcDiag>>;
        return nullptr;
      },
      r_f, t, jp, jm_f, ek, o_r, o_t, o_jp, o_jm, S, n, ld, sched, nd, mode,
      pts_per_block, smem_bytes, stream);
}
