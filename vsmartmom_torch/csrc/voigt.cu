// Layered line-by-line Voigt cross section for Hopper.
//
// Replaces the TPU kernel vsmartmom/pallas/voigt_kernel.py:_voigt_kernel
// (reached through _voigt_pallas_call from VoigtPlan.run):
//   sigma(nu) = sum_l amp_l Re w(igd_l (nu - nu_l) + i y_l)
// over the lines with |nu - nu_l| <= cutoff and amp_l > 0, Re w from
// Humlicek region II where |x| + y >= 8 and Weideman-32 elsewhere, all in
// f32 real arithmetic. The host keeps the absolute wavenumbers in f64 and
// ships offsets from the centre of the real points of each block's
// 1024-point tile, as the TPU kernel takes them (offsets from each 256-point
// block's own centre put the port 3.2e-5 of max sigma from the JAX plan,
// over the 2e-5 the tests allow).
//
// Bound: a few dozen f32 operations per in-window (line, grid point) pair
// (a few hundred on Weideman's branch) against a few bytes per grid point,
// so arithmetic bounds it; one pair is a chain of dependent operations with
// a division, so latency is what a thread waits on.
// Design, for every layer of a band in one launch:
// - the grid is cut into point blocks of kBlock points, and the host plan
//   gives each block its own line range at line granularity, split into
//   items of at most kSplit lines; the launch is a grid of (item, layer)
//   blocks of kThreads threads, so even a narrow band fills the card;
// - an item stages its lines (tile-centred) in shared memory once, then
//   each thread sweeps them for kPts grid points at a time: the points'
//   Humlicek chains are independent and interleave, Weideman's branch runs
//   only for the pairs that need it (near a line centre), and a select, not
//   a branch, keeps the in-window pairs;
// - every item writes its partial sums to a workspace, and a second pass
//   adds a block's items in item order: no float atomics, so two runs of
//   the same inputs agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;                  // threads of an item's block
constexpr int kPts = 4;                       // grid points a thread
constexpr int kBlock = kThreads * kPts;       // grid points of a point block
constexpr int kSplit = 128;                   // most lines an item sweeps
constexpr int kReduceThreads = 256;

constexpr float kIsqrtPi = 0.5641895835477563f;
// sqrt(32 / sqrt(2))
constexpr float kL32 = 4.7568284600108841f;

// Weideman (1994) N = 32 coefficients (vsmartmom/spectroscopy/cef.py:_W32)
__constant__ float kW32[32] = {
    2.5722534081245696e+00f, 2.2635372999002676e+00f, 1.8256696296324824e+00f,
    1.3455441692345453e+00f, 9.0192548936480144e-01f, 5.4601397206393498e-01f,
    2.9544451071508926e-01f, 1.4060716226893769e-01f, 5.7304403529837900e-02f,
    1.9006155784845689e-02f, 4.5195411053501429e-03f, 3.9259136070122748e-04f,
    -2.4532980269928922e-04f, -1.3075449254548613e-04f,
    -2.1409619200870880e-05f, 6.8210319440412389e-06f, 4.4015317319048931e-06f,
    4.2558331390536872e-07f, -4.1840763666294341e-07f,
    -1.4813078891201116e-07f, 2.2930439569075392e-08f, 2.3797557105844622e-08f,
    8.1248960947953431e-10f, -3.2080150458594088e-09f,
    -5.2310170266050247e-10f, 4.1537465934749353e-10f, 1.1658312885903929e-10f,
    -5.5441820344468828e-11f, -2.1542618451370239e-11f, 8.0314997274316680e-12f,
    3.7424975634801558e-12f, -1.3031797863050087e-12f};

// Re w(x + iy), Humlicek (1982) region II:
// t = y - i x; w = t (1.410474 + u/sqrt(pi)) / (0.75 + u (3 + u)), u = t^2.
// The last division is __fdividef (2 ulp; 0 where the denominator exceeds
// 2^126, i.e. |x| > ~5.5e4, where IEEE division gives 0 at ~6.6e4): it
// replaces the IEEE division's refinement and slow-path check, the longest
// stretch of the pair's instruction stream.
__device__ float rew_humlicek2(float x, float y) {
  const float u_re = y * y - x * x;
  const float u_im = -2.f * x * y;
  const float a = 1.410474f + kIsqrtPi * u_re;
  const float b = kIsqrtPi * u_im;
  const float num_re = y * a + x * b;
  const float num_im = y * b - x * a;
  const float d3 = 3.f + u_re;
  const float den_re = 0.75f + u_re * d3 - u_im * u_im;
  const float den_im = u_im * d3 + u_re * u_im;
  return __fdividef(num_re * den_re + num_im * den_im,
                    den_re * den_re + den_im * den_im);
}

// Re w(x + iy), Weideman-32: iz = (-y, x); Z = (L + iz)/(L - iz);
// w = (1/sqrt(pi) + 2 poly(Z) R) R with R = 1/(L - iz)
__device__ float rew_weideman32(float x, float y) {
  const float lr = kL32 + y, li = -x;
  const float inv = 1.f / (lr * lr + li * li);
  const float r_re = lr * inv, r_im = -li * inv;
  const float n_re = kL32 - y, n_im = x;
  const float z_re = n_re * r_re - n_im * r_im;
  const float z_im = n_re * r_im + n_im * r_re;
  float p_re = kW32[31], p_im = 0.f;
  for (int k = 30; k >= 0; --k) {
    const float t_re = p_re * z_re - p_im * z_im + kW32[k];
    p_im = p_re * z_im + p_im * z_re;
    p_re = t_re;
  }
  const float q_re = 2.f * (p_re * r_re - p_im * r_im) + kIsqrtPi;
  const float q_im = 2.f * (p_re * r_im + p_im * r_re);
  return q_re * r_re - q_im * r_im;
}

// One (item, layer): the partial sums of the item's lines over its point
// block, written to ws[layer][item][0 .. kBlock).
__global__ void __launch_bounds__(kThreads)
voigt_kernel(const float* __restrict__ grid_b,
             const float* __restrict__ centers,
             const int* __restrict__ item_block,
             const int* __restrict__ item_lo, const int* __restrict__ item_hi,
             const float* __restrict__ nu, const float* __restrict__ amp,
             const float* __restrict__ igd, const float* __restrict__ yv,
             int n_lines, int n_items, float cutoff, float* __restrict__ ws) {
  __shared__ float4 s_line[kSplit];   // (nu - centre, amp, igd, y)
  const int item = blockIdx.x, layer = blockIdx.y;
  const int blk = item_block[item];
  const int lo = item_lo[item];
  const int n = item_hi[item] - lo;
  const float c = centers[blk];
  const size_t row = (size_t)layer * n_lines + lo;
  for (int i = threadIdx.x; i < n; i += kThreads)
    s_line[i] = make_float4(nu[row + i] - c, amp[row + i], igd[row + i],
                            yv[row + i]);
  float g[kPts], acc[kPts];
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    g[k] = grid_b[(size_t)blk * kBlock + k * kThreads + threadIdx.x];
    acc[k] = 0.f;
  }
  __syncthreads();
  for (int l = 0; l < n; ++l) {
    const float4 ln = s_line[l];
    float dx[kPts], x[kPts], rw[kPts];
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      dx[k] = g[k] - ln.x;
      x[k] = ln.z * dx[k];
      rw[k] = rew_humlicek2(x[k], ln.w);
    }
#pragma unroll
    for (int k = 0; k < kPts; ++k)
      if (fabsf(x[k]) + ln.w < 8.f) rw[k] = rew_weideman32(x[k], ln.w);
#pragma unroll
    for (int k = 0; k < kPts; ++k)
      acc[k] += (fabsf(dx[k]) <= cutoff && ln.y > 0.f) ? ln.y * rw[k] : 0.f;
  }
  float* out = ws + ((size_t)layer * n_items + item) * kBlock;
#pragma unroll
  for (int k = 0; k < kPts; ++k) out[k * kThreads + threadIdx.x] = acc[k];
}

// out[layer][p] = the sum of p's block's items in item order.
__global__ void __launch_bounds__(kReduceThreads)
voigt_reduce_kernel(const float* __restrict__ ws,
                    const int* __restrict__ block_item0, int n_items,
                    int n_grid, float* __restrict__ out) {
  const int layer = blockIdx.y;
  const int p = blockIdx.x * kReduceThreads + threadIdx.x;
  if (p >= n_grid) return;
  const int blk = p / kBlock;
  const float* w = ws + (size_t)layer * n_items * kBlock + p % kBlock;
  float s = 0.f;
  for (int i = block_item0[blk]; i < block_item0[blk + 1]; ++i)
    s += w[(size_t)i * kBlock];
  out[(size_t)layer * n_grid + p] = s;
}

}  // namespace

// The layered Voigt sum on `stream`: grid_b (n_blocks, kBlock) grid offsets
// from the centre of each block's tile, and those (n_blocks,) centres; items (n_items,): point block, first and
// end line; block_item0 (n_blocks + 1,): each block's first item; per layer
// and sorted line nu (band-centred), amp, igd, y, (n_layers, n_lines); ws
// (n_layers, n_items, kBlock) partial sums; out (n_layers, n_grid). Returns
// the first launch's non-zero cudaError_t, else 0.
extern "C" int vsm_voigt(const float* grid_b, const float* centers,
                         const int* item_block, const int* item_lo,
                         const int* item_hi, const int* block_item0,
                         const float* nu, const float* amp, const float* igd,
                         const float* y, int n_layers, int n_lines,
                         int n_items, int n_grid, float cutoff, float* ws,
                         float* out, void* stream) {
  if (n_layers <= 0 || n_grid <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  voigt_kernel<<<dim3(n_items, n_layers), kThreads, 0, s>>>(
      grid_b, centers, item_block, item_lo, item_hi, nu, amp, igd, y,
      n_lines, n_items, cutoff, ws);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  voigt_reduce_kernel<<<dim3((n_grid + kReduceThreads - 1) / kReduceThreads,
                             n_layers),
                        kReduceThreads, 0, s>>>(ws, block_item0, n_items,
                                                n_grid, out);
  return (int)cudaGetLastError();
}
