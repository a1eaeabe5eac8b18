// Device helpers shared by the RT layer kernels (layer_step.cu,
// layer_step_tangent.cu, layer_step_dev.cu, layer_scan.cu, lanes.cu): a team
// of whole warps per spectral point, register-tiled products with fused
// stores and their forward-mode twins, the Newton-Schulz solves (plain and
// Y-form), the plain-form doubling phase, the layer step's arena and the
// team launch.
//
// A team of C::TT threads, whole warps, owns one spectral point and its
// arena for the whole launch and synchronises only itself (__syncwarp, or a
// named barrier when it spans warps); no helper waits for the other points
// of the block.
//
// Products are register-tiled on a padded width class NP >= n: thread
// (rg, cg) of the team owns rows rg + r RG (r < TM) and the TN = 4
// contiguous columns c0 + cg TN + c of every column block c0 (CB columns
// wide). Per four l it loads TM float4 of A and four float4 of B and issues
// 16 TM FMAs (every operand 16-byte aligned, strides multiples of 4). Rows or
// columns past the operand's edge load a clamped, valid element and are
// never stored, so no padded value reaches an output. Every output is one
// fmaf chain over l = 0 .. n-1 from 0, in the order of torch's batched
// matmul at these sizes. The tile coordinates are computed once per team;
// no inner loop divides.
//
// Product modes (C::MODE, a template parameter, so that kHighest compiles to
// the fp32 code alone): the JAX kernels' batch_mm
// (vsmartmom/pallas/doubling_kernel.py:35-58, core/precision.py). kHighest
// multiplies the fp32 operands; kBf16 rounds each loaded operand to bf16
// (round to nearest even) in registers, and kBf16x3 runs three passes,
// (a_hi b_lo + a_lo b_hi) + a_hi b_hi with x_hi = bf16(x), x_lo =
// bf16(x - x_hi), one accumulator each, summed in that order. A product of
// two bf16 values is exact in fp32, so each pass is the fmaf chain of exact
// products over l, summed in fp32, as torch's matmul of the same values.
//
// Tensor-core products (C::TC, at kBf16x3: the split-form step in every
// class, the layer step and the doubling in the N <= 16 class): mm()
// runs mm_tc(), the same function on mma.sync m16n8k16 bf16 tiles with fp32
// accumulation. Each warp owns one 16-row tile of A and every G-th 8-column
// tile of the output; it splits its A fragments into x_hi, x_lo once a
// product (the C80 class once a column tile) and each B fragment once a
// tile. The bf16 products are exact, but the tensor cores sum them in their
// own order, so the result differs from the fmaf chain in the last bits.
// They align the products of a tile to the largest one and cut the rest
// toward zero, which biases a sum whose terms span many binades. The plain
// form's operands carry a ~1.0 diagonal (T, the Newton-Schulz iterates, and
// T's block in the packed W1, W2, X), so its kernels take C::TC ==
// kTcDiag: the terms l = i and l = j mod n of output (i, j), where those
// diagonals sit, leave the a_hi b_hi pass's sum and are added to it after.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace vsm {

constexpr int kMaxSched = 64;

struct Schedule {
  int nd;                 // doubling steps
  int ni;                 // NS iterations of the interaction solve
  int it[kMaxSched];      // NS iterations of each doubling step
};

// Product modes (build.MODE_CODES): full fp32, three bf16 passes, one.
enum Mode : int { kHighest = 0, kBf16x3 = 1, kBf16 = 2 };

// Where a class's products run (Cfg::TC): the CUDA cores, the tensor
// cores, or the tensor cores with the diagonal terms summed apart.
enum TensorCores : int { kCudaCores = 0, kTc = 1, kTcDiag = 2 };

// Tile classes: padded width NP, team threads TT, tile rows TM x columns TN;
// the product mode MODE, and TC: where the products run (kBf16x3 alone on
// the tensor cores).
template <int NP_, int TT_, int TM_, int TN_, int MODE_ = kHighest,
          int TC_ = kCudaCores>
struct Cfg {
  static constexpr int NP = NP_, TT = TT_, TM = TM_, TN = TN_, MODE = MODE_;
  static constexpr int TC = TC_;
  static constexpr int RG = NP / TM;  // row groups
  static constexpr int CG = TT / RG;  // column groups
  static constexpr int CB = CG * TN;  // columns per block
  static_assert(RG * TM == NP && RG * CG == TT && TT % 32 == 0, "tile");
  static_assert(!TC || MODE == kBf16x3, "tensor cores take kBf16x3");
};
using C16 = Cfg<16, 32, 2, 4>;
using C32 = Cfg<32, 64, 4, 4>;
using C48 = Cfg<48, 192, 3, 4>;
using C64 = Cfg<64, 256, 4, 4>;
// the split-form step's fifth class, N = 65 .. 80 (layer_step_dev.cu alone
// instantiates it; with_class below stops at 64)
using C80 = Cfg<80, 320, 4, 4>;

// tile class C in product mode M (CUDA cores), and in kBf16x3 on the
// tensor cores (TC: kTc, or kTcDiag for the plain form)
template <class C, int M>
using WithMode = Cfg<C::NP, C::TT, C::TM, C::TN, M>;
template <class C, int TC = kTc>
using WithTensorCores = Cfg<C::NP, C::TT, C::TM, C::TN, kBf16x3, TC>;

// f(std::integral_constant<int, mode>{}) for a valid mode; -1 otherwise.
template <class F>
inline int with_mode(int mode, F f) {
  if (mode == kHighest) return f(std::integral_constant<int, kHighest>{});
  if (mode == kBf16x3) return f(std::integral_constant<int, kBf16x3>{});
  if (mode == kBf16) return f(std::integral_constant<int, kBf16>{});
  return -1;
}

// Threads per block at most (the team kernels' launch bound; <= 128
// registers a thread).
constexpr int kMaxBlock = 512;

// f(C{}) for the tile class of width n (1 <= n <= 64); -1 beyond.
template <class F>
inline int with_class(int n, F f) {
  if (n <= 16) return f(C16{});
  if (n <= 32) return f(C32{});
  if (n <= 48) return f(C48{});
  if (n <= 64) return f(C64{});
  return -1;
}

// A team launch's checks: a tile class for n, a row stride ld >= n that is a
// multiple of 4, the block within kMaxBlock threads and smem_bytes >= need.
// Returns the class's team threads, or -1.
inline int team_threads(int n, int ld, int pts_per_block, size_t need,
                        int smem_bytes) {
  const int tt = with_class(n, [](auto c) { return decltype(c)::TT; });
  if (tt < 0 || ld < n || ld % 4 != 0 || pts_per_block < 1
      || pts_per_block * tt > kMaxBlock || (size_t)smem_bytes < need)
    return -1;
  return tt;
}

template <class C>
struct Team {
  int t, rg, cg, bar;
  __device__ Team(int t_, int bar_)
      : t(t_), rg(t_ / C::CG), cg(t_ % C::CG), bar(bar_) {}
  __device__ __forceinline__ void sync() const {
    if (C::TT == 32) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(C::TT) : "memory");
    }
  }
};

// f(i, j) for every i < n, j < k that this thread owns: the rows of its
// product tiles, every CG-th column.
template <class C, class F>
__device__ __forceinline__ void each(const Team<C>& tm, int n, int k, F f) {
  for (int i = tm.rg; i < n; i += C::RG)
    for (int j = tm.cg; j < k; j += C::CG) f(i, j);
}

// f(i) for every i < n, one per thread.
template <class C, class F>
__device__ __forceinline__ void each_row(const Team<C>& tm, int n, F f) {
  for (int i = tm.t; i < n; i += C::TT) f(i);
}

// f(i, j) over an n x k array in row-major order, consecutive threads on
// consecutive elements (coalesced device memory).
template <class C, class F>
__device__ __forceinline__ void each_flat(const Team<C>& tm, int n, int k,
                                          F f) {
  const int di = C::TT / k, dj = C::TT - di * k;
  int i = tm.t / k, j = tm.t - i * k;
  while (i < n) {
    f(i, j);
    i += di;
    j += dj;
    if (j >= k) {
      j -= k;
      ++i;
    }
  }
}

// The operand a pass reads: x itself (kF32), its bf16 part x_hi (kHi) or
// the bf16 part of the remainder, x_lo = bf16(x - x_hi) (kLo); x - x_hi is
// exact in fp32.
enum Part : int { kF32 = 0, kHi = 1, kLo = 2 };

template <int K>
__device__ __forceinline__ float part(float x) {
  if constexpr (K == kF32) {
    return x;
  } else {
    const float hi = __bfloat162float(__float2bfloat16_rn(x));
    if constexpr (K == kHi) return hi;
    return __bfloat162float(__float2bfloat16_rn(__fsub_rn(x, hi)));
  }
}

template <int K>
__device__ __forceinline__ float4 part4(float4 v) {
  if constexpr (K == kF32) {
    return v;
  } else {
    return make_float4(part<K>(v.x), part<K>(v.y), part<K>(v.z),
                       part<K>(v.w));
  }
}

// The float4 tile of one column block and one pass: acc[r][c] = sum over l
// of part<KA>(A[ra[r] + l]) * part<KB>(B[l ldb + jb + c]), one fmaf chain
// per element in the order of l. A, B and their row strides are 16-byte
// aligned, so A is read as float4 over four l and B as one float4 of the
// thread's TN = 4 columns.
template <class C, int KA, int KB>
__device__ __forceinline__ void tile4(float (&acc)[C::TM][C::TN],
                                      const int (&ra)[C::TM], int n,
                                      const float* A, const float* B,
                                      int ldb, int jb) {
  static_assert(C::TN == 4, "float4 tiles are four columns wide");
  const float* b = B + jb;
  int l = 0;
  // no unrolling past the four l of one step: unrolled further, ptxas spills
  // the N <= 16 and N <= 48 classes to the stack and runs them slower
#pragma unroll 1
  for (; l + 4 <= n; l += 4, b += 4 * ldb) {
    float4 av[C::TM], bv[4];
#pragma unroll
    for (int r = 0; r < C::TM; ++r)
      av[r] = part4<KA>(*reinterpret_cast<const float4*>(A + ra[r] + l));
#pragma unroll
    for (int q = 0; q < 4; ++q)
      bv[q] = part4<KB>(*reinterpret_cast<const float4*>(b + q * ldb));
#pragma unroll
    for (int r = 0; r < C::TM; ++r) {
      const float a4[4] = {av[r].x, av[r].y, av[r].z, av[r].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[r][0] = fmaf(a4[q], bv[q].x, acc[r][0]);
        acc[r][1] = fmaf(a4[q], bv[q].y, acc[r][1]);
        acc[r][2] = fmaf(a4[q], bv[q].z, acc[r][2]);
        acc[r][3] = fmaf(a4[q], bv[q].w, acc[r][3]);
      }
    }
  }
#pragma unroll 1
  for (; l < n; ++l, b += ldb) {
    const float4 v = part4<KB>(*reinterpret_cast<const float4*>(b));
#pragma unroll
    for (int r = 0; r < C::TM; ++r) {
      const float a = part<KA>(A[ra[r] + l]);
      acc[r][0] = fmaf(a, v.x, acc[r][0]);
      acc[r][1] = fmaf(a, v.y, acc[r][1]);
      acc[r][2] = fmaf(a, v.z, acc[r][2]);
      acc[r][3] = fmaf(a, v.w, acc[r][3]);
    }
  }
}

template <class C>
__device__ __forceinline__ void zero(float (&acc)[C::TM][C::TN]) {
#pragma unroll
  for (int r = 0; r < C::TM; ++r)
#pragma unroll
    for (int c = 0; c < C::TN; ++c) acc[r][c] = 0.f;
}

// The tile of one column block in C::MODE: one pass, or kBf16x3's three
// passes summed (a_hi b_lo + a_lo b_hi) + a_hi b_hi.
template <class C>
__device__ __forceinline__ void tile(float (&acc)[C::TM][C::TN],
                                     const int (&ra)[C::TM], int n,
                                     const float* A, const float* B, int ldb,
                                     int jb) {
  zero<C>(acc);
  if constexpr (C::MODE == kHighest) {
    tile4<C, kF32, kF32>(acc, ra, n, A, B, ldb, jb);
  } else if constexpr (C::MODE == kBf16) {
    tile4<C, kHi, kHi>(acc, ra, n, A, B, ldb, jb);
  } else {
    tile4<C, kHi, kLo>(acc, ra, n, A, B, ldb, jb);
#pragma unroll 1
    for (int q = 0; q < 2; ++q) {
      float p[C::TM][C::TN];
      zero<C>(p);
      if (q == 0) {
        tile4<C, kLo, kHi>(p, ra, n, A, B, ldb, jb);
      } else {
        tile4<C, kHi, kHi>(p, ra, n, A, B, ldb, jb);
      }
#pragma unroll
      for (int r = 0; r < C::TM; ++r)
#pragma unroll
        for (int c = 0; c < C::TN; ++c)
          acc[r][c] = __fadd_rn(acc[r][c], p[r][c]);
    }
  }
}

// bf16x2 of (x0, x1), x0 in the low half, each rounded to nearest even.
__device__ __forceinline__ unsigned bf16x2(float x0, float x1) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(x1), "f"(x0));
  return d;
}

// The bf16 parts of (x0, x1), as part<kHi> and part<kLo>: hi = bf16(x) and
// lo = bf16(x - hi) (x - hi is exact in fp32), each a bf16x2.
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  hi = bf16x2(x0, x1);
  lo = bf16x2(__fsub_rn(x0, __uint_as_float(hi << 16)),
              __fsub_rn(x1, __uint_as_float(hi & 0xffff0000u)));
}

// d += a b on one m16n8k16 tile: A 16 x 16 (row), B 16 x 8 (column), bf16
// products exact, summed in fp32 by the tensor cores.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mm() on the tensor cores in kBf16x3: the passes a_hi b_lo, a_lo b_hi and
// a_hi b_hi in three accumulators, summed (p1 + p2) + p3 as batch_mm sums
// its three products. M and K pad to MT = NP / 16 tiles of 16, the
// output's columns to tiles of 8. Warp w owns m tile w % MT and the column
// tiles w / MT + G q (G = warps / MT). Lane (g, t) = (lane / 4, lane % 4)
// holds A rows g, g + 8 and columns (K) 2t, 2t + 1, 2t + 8, 2t + 9 of a
// tile, B rows (K) 2t, 2t + 1, 2t + 8, 2t + 9 of column g, and outputs rows
// g, g + 8, columns 2t, 2t + 1 (the PTX fragment layouts). Past the K edge
// (l >= n) both operands read 0, so padded terms add nothing; rows past n
// and columns past k read a clamped valid element and are never stored.
// A's row stride lda must exceed n (A is read as float2 at l, l + 1 <= n).
// With kTcDiag (one k tile: n <= 16) the a_hi b_hi pass reads A as 0 at
// l = i and B at l = j mod n, and adds those terms after the mma, rounded
// to nearest: a_ii b_ij, then a_i,j' b_j',j (j' = j mod n, unless j' = i).
// Two more mma compute them exactly, each a sum of one product: A's
// diagonal alone times B, and A without it times B's l = j mod n entries
// alone. The two small passes keep those terms: their sums are 2^-8 of the
// result, so the tensor cores' cut moves it by far less than an ulp.
// With Inplace every warp has read B's columns of a round of column tiles
// before any warp stores into them.
template <class C, bool Inplace, class Out>
__device__ __forceinline__ void mm_tc(const Team<C>& tm, int n, int k,
                                      const float* A, int lda, const float* B,
                                      int ldb, Out out) {
  constexpr int MT = C::NP / 16, W = C::TT / 32, G = W / MT;
  constexpr bool kDiag = C::TC == kTcDiag;
  static_assert(MT * 16 == C::NP && G * MT == W, "tensor-core tiles");
  static_assert(C::MODE == kBf16x3, "the tensor-core product is bf16x3");
  static_assert(!kDiag || MT == 1, "the diagonal terms take one k tile");
  const int lane = tm.t & 31, warp = tm.t >> 5;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int i0 = 16 * (warp % MT) + g;
  const float* a0 = A + min(i0, n - 1) * lda;
  const float* a1 = A + min(i0 + 8, n - 1) * lda;
  // kTcDiag: the fragments of A_hi without its l = i terms, and of those
  // terms alone
  unsigned ad[4], ai[4];
  // the A fragments of k tile kt, split
  auto load_a = [&](int kt, unsigned (&hi)[4], unsigned (&lo)[4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = 16 * kt + 8 * h + t2;
      const int lc = min(l, (n - 1) & ~1);  // l, l + 1 <= n < lda
      float2 x = *reinterpret_cast<const float2*>(a0 + lc);
      float2 y = *reinterpret_cast<const float2*>(a1 + lc);
      if (l >= n) x.x = y.x = 0.f;
      if (l + 1 >= n) x.y = y.y = 0.f;
      split2(x.x, x.y, hi[2 * h], lo[2 * h]);
      split2(y.x, y.y, hi[2 * h + 1], lo[2 * h + 1]);
      if constexpr (kDiag) {
        const bool x0 = l == i0, x1 = l + 1 == i0;
        const bool y0 = l == i0 + 8, y1 = l + 1 == i0 + 8;
        ad[2 * h] = bf16x2(x0 ? 0.f : x.x, x1 ? 0.f : x.y);
        ad[2 * h + 1] = bf16x2(y0 ? 0.f : y.x, y1 ? 0.f : y.y);
        ai[2 * h] = bf16x2(x0 ? x.x : 0.f, x1 ? x.y : 0.f);
        ai[2 * h + 1] = bf16x2(y0 ? y.x : 0.f, y1 ? y.y : 0.f);
      }
    }
  };
  // Up to four k tiles the warp keeps its A fragments, split once; the C80
  // class (five) loads them again for each column tile: held, they spilled
  // it to a 64-byte stack under its 168 registers.
  constexpr bool kHold = MT <= 4;
  unsigned ah[kHold ? MT : 1][4], al[kHold ? MT : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kt = 0; kt < MT; ++kt) load_a(kt, ah[kt], al[kt]);
  }
  const int tiles = (k + 7) >> 3;
#pragma unroll 1
  for (int q0 = 0; q0 < tiles; q0 += G) {  // the same rounds in every warp
    const int j0 = 8 * (q0 + warp / MT);
    float p[3][4] = {};  // a_hi b_lo, a_lo b_hi, a_hi b_hi
    if (j0 < k) {
      const float* b = B + min(j0 + g, k - 1);
#pragma unroll
      for (int kt = 0; kt < MT; ++kt) {
        const int ka = kHold ? kt : 0;
        if constexpr (!kHold) load_a(kt, ah[0], al[0]);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = 16 * kt + t2 + (e & 1) + 8 * (e >> 1);
          v[e] = l < n ? b[min(l, n - 1) * ldb] : 0.f;
        }
        unsigned bh0, bh1, bl0, bl1;
        split2(v[0], v[1], bh0, bl0);
        split2(v[2], v[3], bh1, bl1);
        mma_bf16(p[0], ah[ka], bl0, bl1);
        mma_bf16(p[1], al[ka], bh0, bh1);
        if constexpr (kDiag) {
          // column j0 + g's l = j mod n term: B' without it, B_d it alone
          const int jd = (j0 + g) % n;
          bool m[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            m[e] = t2 + (e & 1) + 8 * (e >> 1) == jd;
          float d1[4] = {}, d2[4] = {};
          mma_bf16(p[2], ad, bf16x2(m[0] ? 0.f : v[0], m[1] ? 0.f : v[1]),
                   bf16x2(m[2] ? 0.f : v[2], m[3] ? 0.f : v[3]));
          mma_bf16(d1, ai, bh0, bh1);  // a_ii b_ij
          mma_bf16(d2, ad, bf16x2(m[0] ? v[0] : 0.f, m[1] ? v[1] : 0.f),
                   bf16x2(m[2] ? v[2] : 0.f, m[3] ? v[3] : 0.f));
#pragma unroll
          for (int c = 0; c < 4; ++c)
            p[2][c] = __fadd_rn(__fadd_rn(p[2][c], d1[c]), d2[c]);
        } else {
          mma_bf16(p[2], ah[ka], bh0, bh1);
        }
      }
    }
    if (Inplace) tm.sync();
    if (j0 < k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + 8 * (c >> 1), j = j0 + t2 + (c & 1);
        if (i < n && j < k)
          out(i, j, __fadd_rn(__fadd_rn(p[0][c], p[1][c]), p[2][c]));
      }
    }
  }
}

// out(i, j, s) for every output of A (n x n, row stride lda) @ B (n x k, row
// stride ldb), s = the fmaf chain over l (with C::TC, mm_tc's tensor-core
// sum). A, B, lda and ldb must be 16-byte aligned (every arena slot is;
// tile4 reads float4). With Inplace the team synchronises before each
// column block's stores, so out may write the block's columns of B.
template <class C, bool Inplace = false, class Out>
__device__ __forceinline__ void mm(const Team<C>& tm, int n, int k,
                                   const float* A, int lda, const float* B,
                                   int ldb, Out out) {
  if constexpr (C::TC) {
    mm_tc<C, Inplace>(tm, n, k, A, lda, B, ldb, out);
  } else {
    int ra[C::TM];
#pragma unroll
    for (int r = 0; r < C::TM; ++r)
      ra[r] = min(tm.rg + r * C::RG, n - 1) * lda;
    for (int c0 = 0; c0 < k; c0 += C::CB) {
      const int j0 = c0 + tm.cg * C::TN;  // the thread's first column
      float acc[C::TM][C::TN];
      // past the edge (j0 >= ldb >= k: nothing stored) read the row's last
      // TN columns
      tile<C>(acc, ra, n, A, B, ldb, min(j0, ldb - C::TN));
      if (Inplace) tm.sync();
#pragma unroll
      for (int r = 0; r < C::TM; ++r) {
        const int i = tm.rg + r * C::RG;
        if (i < n) {
#pragma unroll
          for (int c = 0; c < C::TN; ++c)
            if (j0 + c < k) out(i, j0 + c, acc[r][c]);
        }
      }
    }
  }
}

// One pass of a row of A times x: the fmaf chain over l of part<KA>(a[l])
// part<KX>(x(l)).
template <int KA, int KX, class X>
__device__ __forceinline__ float dot(const float* a, int n, X x) {
  float s = 0.f;
  for (int l = 0; l < n; ++l) s = fmaf(part<KA>(a[l]), part<KX>(x(l)), s);
  return s;
}

// out(i, s) for every row of A (n x n, row stride lda) @ x, x(l) the vector,
// in C::MODE as tile(); one row per thread.
template <class C, class X, class Out>
__device__ __forceinline__ void mv(const Team<C>& tm, int n, const float* A,
                                   int lda, X x, Out out) {
  for (int i = tm.t; i < n; i += C::TT) {
    const float* a = A + i * lda;
    float s;
    if constexpr (C::MODE == kHighest) {
      s = dot<kF32, kF32>(a, n, x);
    } else if constexpr (C::MODE == kBf16) {
      s = dot<kHi, kHi>(a, n, x);
    } else {
      s = __fadd_rn(__fadd_rn(dot<kHi, kLo>(a, n, x), dot<kLo, kHi>(a, n, x)),
                    dot<kHi, kHi>(a, n, x));
    }
    out(i, s);
  }
}

// Forward-mode products (the tangent kernel, layer_step_tangent.cu): the
// product s = A B and its tangent ds = dA B + A dB in one pass over l, A and
// dA of one row stride, B and dB of another. Each pass of C::MODE
// contributes pass(dA, B) + pass(A, dB) to ds, and the passes sum as tile()
// sums them: the tangent torch.func.jvp takes of batch_mm in that mode
// (core/precision.py), term for term. Without P, s is not computed.
template <class C, int KA, int KB, bool P>
__device__ __forceinline__ void tile4j(float (&acc)[C::TM][C::TN],
                                       float (&d1)[C::TM][C::TN],
                                       float (&d2)[C::TM][C::TN],
                                       const int (&ra)[C::TM], int n,
                                       const float* A, const float* dA,
                                       const float* B, const float* dB,
                                       int ldb, int jb) {
  static_assert(C::TN == 4, "float4 tiles are four columns wide");
  const float* b = B + jb;
  const float* db = dB + jb;
  int l = 0;
#pragma unroll 1
  for (; l + 4 <= n; l += 4, b += 4 * ldb, db += 4 * ldb) {
    float4 av[C::TM], dav[C::TM], bv[4], dbv[4];
#pragma unroll
    for (int r = 0; r < C::TM; ++r) {
      av[r] = part4<KA>(*reinterpret_cast<const float4*>(A + ra[r] + l));
      dav[r] = part4<KA>(*reinterpret_cast<const float4*>(dA + ra[r] + l));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bv[q] = part4<KB>(*reinterpret_cast<const float4*>(b + q * ldb));
      dbv[q] = part4<KB>(*reinterpret_cast<const float4*>(db + q * ldb));
    }
#pragma unroll
    for (int r = 0; r < C::TM; ++r) {
      const float a4[4] = {av[r].x, av[r].y, av[r].z, av[r].w};
      const float da4[4] = {dav[r].x, dav[r].y, dav[r].z, dav[r].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float bq[4] = {bv[q].x, bv[q].y, bv[q].z, bv[q].w};
        const float dbq[4] = {dbv[q].x, dbv[q].y, dbv[q].z, dbv[q].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (P) acc[r][c] = fmaf(a4[q], bq[c], acc[r][c]);
          d1[r][c] = fmaf(da4[q], bq[c], d1[r][c]);
          d2[r][c] = fmaf(a4[q], dbq[c], d2[r][c]);
        }
      }
    }
  }
#pragma unroll 1
  for (; l < n; ++l, b += ldb, db += ldb) {
    const float4 v = part4<KB>(*reinterpret_cast<const float4*>(b));
    const float4 dv = part4<KB>(*reinterpret_cast<const float4*>(db));
    const float bq[4] = {v.x, v.y, v.z, v.w};
    const float dbq[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
    for (int r = 0; r < C::TM; ++r) {
      const float a = part<KA>(A[ra[r] + l]);
      const float da = part<KA>(dA[ra[r] + l]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (P) acc[r][c] = fmaf(a, bq[c], acc[r][c]);
        d1[r][c] = fmaf(da, bq[c], d1[r][c]);
        d2[r][c] = fmaf(a, dbq[c], d2[r][c]);
      }
    }
  }
}

// acc += p and dacc += d1 + d2, elementwise, rounded to nearest
template <class C, bool P>
__device__ __forceinline__ void add_pass(float (&acc)[C::TM][C::TN],
                                         float (&dacc)[C::TM][C::TN],
                                         const float (&p)[C::TM][C::TN],
                                         const float (&d1)[C::TM][C::TN],
                                         const float (&d2)[C::TM][C::TN]) {
#pragma unroll
  for (int r = 0; r < C::TM; ++r)
#pragma unroll
    for (int c = 0; c < C::TN; ++c) {
      if (P) acc[r][c] = __fadd_rn(acc[r][c], p[r][c]);
      dacc[r][c] = __fadd_rn(dacc[r][c], __fadd_rn(d1[r][c], d2[r][c]));
    }
}

// One pass (KA, KB) of the tangent alone: dacc = d1 + d2 (first) or dacc +
// (d1 + d2), d1 = pass(dA, B) and d2 = pass(A, dB), each by tile4.
template <class C, int KA, int KB>
__device__ __forceinline__ void tangent_pass(float (&dacc)[C::TM][C::TN],
                                             bool first,
                                             const int (&ra)[C::TM], int n,
                                             const float* A, const float* dA,
                                             const float* B, const float* dB,
                                             int ldb, int jb) {
  float d1[C::TM][C::TN], d2[C::TM][C::TN];
  zero<C>(d1);
  zero<C>(d2);
  tile4<C, KA, KB>(d1, ra, n, dA, B, ldb, jb);
  tile4<C, KA, KB>(d2, ra, n, A, dB, ldb, jb);
#pragma unroll
  for (int r = 0; r < C::TM; ++r)
#pragma unroll
    for (int c = 0; c < C::TN; ++c) {
      const float t = __fadd_rn(d1[r][c], d2[r][c]);
      dacc[r][c] = first ? t : __fadd_rn(dacc[r][c], t);
    }
}

// The tile of one column block and its tangent in C::MODE. The N <= 16
// class (two tile rows a thread) runs each pass's s, dA B and A dB in one
// sweep of l (tile4j); the classes of three and four tile rows would spill
// those twelve or sixteen accumulators and their operands, so they run
// tile() for s and then each pass's dA B and A dB apart (tangent_pass).
// Either way every sum is the same fmaf chain, added in the same order.
template <class C, bool P>
__device__ __forceinline__ void tilej(float (&acc)[C::TM][C::TN],
                                      float (&dacc)[C::TM][C::TN],
                                      const int (&ra)[C::TM], int n,
                                      const float* A, const float* dA,
                                      const float* B, const float* dB,
                                      int ldb, int jb) {
  constexpr int K0A = C::MODE == kHighest ? kF32 : kHi;
  constexpr int K0B = C::MODE == kHighest ? kF32 : C::MODE == kBf16 ? kHi
                                                                    : kLo;
  if constexpr (C::TM > 2) {
    if (P) tile<C>(acc, ra, n, A, B, ldb, jb);
    tangent_pass<C, K0A, K0B>(dacc, true, ra, n, A, dA, B, dB, ldb, jb);
    if constexpr (C::MODE == kBf16x3) {
      tangent_pass<C, kLo, kHi>(dacc, false, ra, n, A, dA, B, dB, ldb, jb);
      tangent_pass<C, kHi, kHi>(dacc, false, ra, n, A, dA, B, dB, ldb, jb);
    }
  } else {
    float d2[C::TM][C::TN];
    zero<C>(acc);
    zero<C>(dacc);
    zero<C>(d2);
    tile4j<C, K0A, K0B, P>(acc, dacc, d2, ra, n, A, dA, B, dB, ldb, jb);
#pragma unroll
    for (int r = 0; r < C::TM; ++r)
#pragma unroll
      for (int c = 0; c < C::TN; ++c)
        dacc[r][c] = __fadd_rn(dacc[r][c], d2[r][c]);
    if constexpr (C::MODE == kBf16x3) {
#pragma unroll 1
      for (int q = 0; q < 2; ++q) {
        float p[C::TM][C::TN], d1[C::TM][C::TN];
        zero<C>(p);
        zero<C>(d1);
        zero<C>(d2);
        if (q == 0) {
          tile4j<C, kLo, kHi, P>(p, d1, d2, ra, n, A, dA, B, dB, ldb, jb);
        } else {
          tile4j<C, kHi, kHi, P>(p, d1, d2, ra, n, A, dA, B, dB, ldb, jb);
        }
        add_pass<C, P>(acc, dacc, p, d1, d2);
      }
    }
  }
}

// out(i, j, s, ds) for every output of A (n x n, row stride lda) @ B (n x k,
// row stride ldb) and of its tangent dA B + A dB (dA of stride lda, dB of
// stride ldb): s as mm() gives it (unset without P), ds as tilej. On the
// CUDA cores in every mode. With Inplace the team synchronises before each
// column block's stores, so out may write the block's columns of B and dB.
template <class C, bool P = true, bool Inplace = false, class Out>
__device__ __forceinline__ void mmj(const Team<C>& tm, int n, int k,
                                    const float* A, const float* dA, int lda,
                                    const float* B, const float* dB, int ldb,
                                    Out out) {
  static_assert(!C::TC, "the tangent's products run on the CUDA cores");
  int ra[C::TM];
#pragma unroll
  for (int r = 0; r < C::TM; ++r)
    ra[r] = min(tm.rg + r * C::RG, n - 1) * lda;
  for (int c0 = 0; c0 < k; c0 += C::CB) {
    const int j0 = c0 + tm.cg * C::TN;
    float acc[C::TM][C::TN], dacc[C::TM][C::TN];
    tilej<C, P>(acc, dacc, ra, n, A, dA, B, dB, ldb, min(j0, ldb - C::TN));
    if (Inplace) tm.sync();
#pragma unroll
    for (int r = 0; r < C::TM; ++r) {
      const int i = tm.rg + r * C::RG;
      if (i < n) {
#pragma unroll
        for (int c = 0; c < C::TN; ++c)
          if (j0 + c < k) out(i, j0 + c, acc[r][c], dacc[r][c]);
      }
    }
  }
}

// One pass of a row of A times x and its tangent: s += pa(a) px(x), ds +=
// pa(da) px(x) + pa(a) px(dx) (dot, and the pass's tangent).
template <int KA, int KX, class X, class DX>
__device__ __forceinline__ void dotj(const float* a, const float* da, int n,
                                     X x, DX dx, float& s, float& ds) {
  float p = 0.f, d1 = 0.f, d2 = 0.f;
  for (int l = 0; l < n; ++l) {
    const float al = part<KA>(a[l]), xl = part<KX>(x(l));
    p = fmaf(al, xl, p);
    d1 = fmaf(part<KA>(da[l]), xl, d1);
    d2 = fmaf(al, part<KX>(dx(l)), d2);
  }
  s = p;
  ds = __fadd_rn(d1, d2);
}

// out(i, s, ds) for every row of A (n x n, row stride lda) @ x, s as mv()
// gives it and ds its tangent dA x + A dx, the passes summed as tilej.
template <class C, class X, class DX, class Out>
__device__ __forceinline__ void mvj(const Team<C>& tm, int n, const float* A,
                                    const float* dA, int lda, X x, DX dx,
                                    Out out) {
  for (int i = tm.t; i < n; i += C::TT) {
    const float* a = A + i * lda;
    const float* da = dA + i * lda;
    float s, ds;
    if constexpr (C::MODE == kHighest) {
      dotj<kF32, kF32>(a, da, n, x, dx, s, ds);
    } else if constexpr (C::MODE == kBf16) {
      dotj<kHi, kHi>(a, da, n, x, dx, s, ds);
    } else {
      float s2, ds2, s3, ds3;
      dotj<kHi, kLo>(a, da, n, x, dx, s, ds);
      dotj<kLo, kHi>(a, da, n, x, dx, s2, ds2);
      dotj<kHi, kHi>(a, da, n, x, dx, s3, ds3);
      s = __fadd_rn(__fadd_rn(s, s2), s3);
      ds = __fadd_rn(__fadd_rn(ds, ds2), ds3);
    }
    out(i, s, ds);
  }
}

// The epilogue of a product s that starts a Newton-Schulz solve:
// A = I - s and the seed M0 = 2I - A, at element e (diagonal or not).
__device__ __forceinline__ void ns_seed(float* a, float* m0, int e, bool diag,
                                        float s) {
  const float v = (diag ? 1.f : 0.f) - s;
  a[e] = v;
  m0[e] = (diag ? 2.f : 0.f) - v;
}

// Newton-Schulz inverse of A (n x n, stride ld) from the seed at oM0 (both
// written by the caller, then synchronised): M <- M (2I - A M) `iters`
// times, with 2I - A M fused into the product's stores and the scratch at
// oS. Returns the offset of the result, synchronised.
template <class C>
__device__ __forceinline__ int
ns(const Team<C>& tm, float* ar, int n, int ld, int oA, int oM0, int oM1,
   int oS, int iters) {
  int cur = oM0, oth = oM1;
  float* s = ar + oS;
  for (int q = 0; q < iters; ++q) {
    mm(tm, n, n, ar + oA, ld, ar + cur, ld, [=](int i, int j, float v) {
      s[i * ld + j] = (i == j ? 2.f : 0.f) - v;
    });
    tm.sync();
    float* m = ar + oth;
    mm(tm, n, n, ar + cur, ld, s, ld,
       [=](int i, int j, float v) { m[i * ld + j] = v; });
    tm.sync();
    const int x = cur;
    cur = oth;
    oth = x;
  }
  return cur;
}

// Y-form Newton-Schulz of the split form: Y ~= (I - B)^{-1} - I for B at oB
// (n x n, stride ld), from the seed Y = B at oY (both written by the caller,
// then synchronised). Per iteration two products with fused stores:
//   W = B + B Y, and D = W - Y in the same store;
//   W <- W + Y D, which is the new Y (W's slot and Y's swap).
// Sums round as torch's (core/rt.py:ns_y). oW and oD are scratch. Returns
// the offset of the result, synchronised; the other of oY, oW is free.
template <class C>
__device__ __forceinline__ int
ns_y(const Team<C>& tm, float* ar, int n, int ld, int oB, int oY, int oW,
     int oD, int iters) {
  const float* B = ar + oB;
  float* D = ar + oD;
  for (int q = 0; q < iters; ++q) {
    const float* Y = ar + oY;
    float* W = ar + oW;
    mm(tm, n, n, B, ld, Y, ld, [=](int i, int j, float s) {
      const int e = i * ld + j;
      const float w = __fadd_rn(B[e], s);
      W[e] = w;
      D[e] = __fsub_rn(w, Y[e]);
    });
    tm.sync();
    mm(tm, n, n, Y, ld, D, ld, [=](int i, int j, float s) {
      W[i * ld + j] = __fadd_rn(W[i * ld + j], s);
    });
    tm.sync();
    const int x = oY;
    oY = oW;
    oW = x;
  }
  return oY;
}

// 4-byte asynchronous copy from device to shared memory (cp.async), and the
// wait for all of this thread's copies.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// n rounded up to a multiple of 4 floats (16 bytes)
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Arena of the doubling phase (floats): six square slots of n rows, row
// stride ld >= n (a multiple of 4, and 4 mod 8 where the kernel's arena
// fits, so that the float4 rows a warp reads as A fall on distinct banks),
// then
//   R | T | A | M0 | M1 | TMP | JP [n4] | JM [n4] | W1 [n x w2] | W2 [n x w2]
// with n4 = round4(n) and w2 = round4(2n + 2): every slot starts on 16
// bytes. The doubling swaps T and TMP every step (the new T is written
// beside the old one), so the current slots are oT and oTMP.
struct Arena {
  int n, ld, w2;
  int oR, oT, oA, oM0, oM1, oTMP, oJP, oJM, oW1, oW2;
  __host__ __device__ Arena(int n_, int ld_)
      : n(n_), ld(ld_), w2(round4(2 * n_ + 2)) {
    const int sq = n * ld;
    oR = 0; oT = sq; oA = 2 * sq; oM0 = 3 * sq; oM1 = 4 * sq; oTMP = 5 * sq;
    oJP = 6 * sq; oJM = oJP + round4(n); oW1 = oJM + round4(n);
    oW2 = oW1 + n * w2;
  }
};

__host__ __device__ inline int doubling_arena_floats(int n, int ld) {
  const Arena o(n, ld);
  return o.oW2 + n * o.w2;
}

// All scheduled doubling steps (flipped space) on the arena's R, T, JP, JM,
// with ek the elemental layer's e^(-dtau/mu0) (kept in a register). Per step:
//   A = I - R R, M0 = 2I - A           (one product, fused stores)
//   M = NS inverse of A                (sch.it[step] iterations)
//   W1 = [R T | T | J1M + R JP | JP + R J1M], J1M = JM ek (n x (2n+2))
//   W2 = M W1; T W2 -> R += ., T' = ., JM += ., JP = JP ek + .
// (vsmartmom/pallas/doubling_kernel.py:doubling_body). The sums of a
// product round as torch's do (__fmul_rn, __fadd_rn). Returns synchronised,
// with o.oT naming the current T.
template <class C>
__device__ __forceinline__ void
doubling_phase(const Team<C>& tm, float* ar, Arena& o, float ek,
               const Schedule& sch) {
  const int n = o.n, ld = o.ld, w2 = o.w2;
  float* R = ar + o.oR;
  float* JP = ar + o.oJP;
  float* JM = ar + o.oJM;
  float* A = ar + o.oA;
  float* M0 = ar + o.oM0;
  float* W1 = ar + o.oW1;
  float* W2 = ar + o.oW2;
  for (int step = 0; step < sch.nd; ++step) {
    const float* T = ar + o.oT;
    float* Tn = ar + o.oTMP;
    mm(tm, n, n, R, ld, R, ld, [=](int i, int j, float s) {
      ns_seed(A, M0, i * ld + j, i == j, s);
    });
    tm.sync();
    const float* M =
        ar + ns(tm, ar, n, ld, o.oA, o.oM0, o.oM1, o.oTMP, sch.it[step]);
    mm(tm, n, n, R, ld, T, ld, [=](int i, int j, float s) {
      W1[i * w2 + j] = s;
      W1[i * w2 + n + j] = T[i * ld + j];
    });
    mv(tm, n, R, ld, [=](int l) { return JP[l]; }, [=](int i, float s) {
      W1[i * w2 + 2 * n] = __fadd_rn(__fmul_rn(JM[i], ek), s);
    });
    mv(tm, n, R, ld, [=](int l) { return __fmul_rn(JM[l], ek); },
       [=](int i, float s) { W1[i * w2 + 2 * n + 1] = __fadd_rn(JP[i], s); });
    tm.sync();
    mm(tm, n, 2 * n + 2, M, ld, W1, w2,
       [=](int i, int j, float s) { W2[i * w2 + j] = s; });
    tm.sync();
    mm(tm, n, 2 * n + 2, T, ld, W2, w2, [=](int i, int j, float s) {
      if (j < n) {
        R[i * ld + j] = __fadd_rn(R[i * ld + j], s);
      } else if (j < 2 * n) {
        Tn[i * ld + j - n] = s;
      } else if (j == 2 * n) {
        JM[i] = __fadd_rn(JM[i], s);
      } else {
        JP[i] = __fadd_rn(__fmul_rn(JP[i], ek), s);
      }
    });
    tm.sync();
    const int x = o.oT;
    o.oT = o.oTMP;
    o.oTMP = x;
    ek = __fmul_rn(ek, ek);
  }
}

// The layer step's arena beyond the doubling's (layer_step.cu,
// layer_step_tangent.cu).
// Row strides of the interaction's X2 [n x wx2] and X [n x 2 wx2]: X holds
// x1 (2n+1 columns) from column 0 and r2mp x2 from column wx2.
__host__ __device__ inline int x2_stride(int n) { return round4(2 * n + 1); }

// offset of CRPM in the step's arena (CTMM follows): after the doubling's
// W1, W2 or the interaction's X, X2, whichever is larger
__host__ __device__ inline int step_composite_offset(int n, int ld) {
  const Arena o(n, ld);
  return o.oW1 + max(2 * n * o.w2, 3 * n * x2_stride(n));
}

__host__ __device__ inline int step_arena_floats(int n, int ld) {
  return step_composite_offset(n, ld) + 2 * n * ld;
}

// R, T, JP, JM of point p from device memory into the arena
template <class C>
__device__ __forceinline__ void
load_elemental(const Team<C>& tm, float* ar, const Arena& o, int p,
               const float* r_f, const float* t, const float* jp,
               const float* jm_f) {
  const int n = o.n, ld = o.ld;
  const size_t gm = (size_t)p * n * n, gv = (size_t)p * n;
  float* R = ar + o.oR;
  float* T = ar + o.oT;
  each_flat(tm, n, n, [=](int i, int j) {
    R[i * ld + j] = r_f[gm + i * n + j];
    T[i * ld + j] = t[gm + i * n + j];
  });
  each_row(tm, n, [=](int i) {
    ar[o.oJP + i] = jp[gv + i];
    ar[o.oJM + i] = jm_f[gv + i];
  });
}

// Launches pick(class, mode)'s kernel (nullptr for a mode the entry does not
// take) on `teams` teams, pts_per_block a block, with `need` bytes of shared
// memory a block and `args`; returns the cudaError_t of the launch.
template <class Pick, class... Args>
int launch_team(Pick pick, int teams, int n, int ld, int mode,
                int pts_per_block, int smem_bytes, size_t need, void* stream,
                Args... args) {
  const int tt = team_threads(n, ld, pts_per_block, need, smem_bytes);
  if (tt < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (teams + pts_per_block - 1) / pts_per_block;
  const int err = with_class(n, [&](auto c) {
    return with_mode(mode, [&](auto m) {
      auto* kern = pick(c, m);
      if (kern == nullptr) return (int)cudaErrorInvalidValue;
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (e != cudaSuccess) return (int)e;
      kern<<<blocks, pts_per_block * tt, smem_bytes,
             (cudaStream_t)stream>>>(args...);
      return (int)cudaGetLastError();
    });
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
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
