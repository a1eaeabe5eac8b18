// Tiled line-by-line Voigt cross section for Hopper.
//
// Replaces the TPU kernel vsmartmom/pallas/voigt_kernel.py:_voigt_kernel
// (reached through _voigt_pallas_call from VoigtPlan.run):
//   sigma(nu) = sum_l amp_l Re w(igd_l (nu - nu_l) + i y_l)
// over the lines with |nu - nu_l| <= cutoff and amp_l > 0, Re w from
// Humlicek region II where |x| + y >= 8 and Weideman-32 elsewhere, all in
// f32 real arithmetic around each tile's own centre (the host keeps the
// absolute wavenumbers in f64 and ships tile-centred offsets).
//
// Bound: a few hundred f32 operations per (line, grid point) pair inside the
// wing window and a handful of bytes per grid point, so arithmetic bounds
// it. Design: one block per 1024-point tile, one thread per grid point; the
// lines (sorted on the host) are swept only over the tile's own range, and
// are staged through shared memory 256 at a time so each line parameter is
// read from device memory once per tile. A thread evaluates only the branch
// its (x, y) selects and skips lines outside the window.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;    // grid points per block (one per thread)
constexpr int kChunk = 64;     // line rows of the host plan
constexpr int kStage = 256;    // lines staged per shared-memory pass

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
// t = y - i x; w = t (1.410474 + u/sqrt(pi)) / (0.75 + u (3 + u)), u = t^2
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
  return (num_re * den_re + num_im * den_im) /
         (den_re * den_re + den_im * den_im);
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

__global__ void __launch_bounds__(kTile)
voigt_kernel(const float* __restrict__ grid_t,
             const float* __restrict__ centers,
             const int* __restrict__ starts, const int* __restrict__ n_chunks,
             const float* __restrict__ nu, const float* __restrict__ amp,
             const float* __restrict__ igd, const float* __restrict__ yv,
             int n_lines, float cutoff, float* __restrict__ out) {
  __shared__ float s_nu[kStage], s_amp[kStage], s_igd[kStage], s_y[kStage];
  const int tile = blockIdx.x;
  const float g = grid_t[(size_t)tile * kTile + threadIdx.x];
  const float c = centers[tile];
  const int lo = starts[tile] * kChunk;
  const int hi = min((starts[tile] + n_chunks[tile]) * kChunk, n_lines);
  float acc = 0.f;
  for (int base = lo; base < hi; base += kStage) {
    const int m = min(kStage, hi - base);
    if (threadIdx.x < m) {
      const int l = base + threadIdx.x;
      s_nu[threadIdx.x] = nu[l] - c;
      s_amp[threadIdx.x] = amp[l];
      s_igd[threadIdx.x] = igd[l];
      s_y[threadIdx.x] = yv[l];
    }
    __syncthreads();
    for (int l = 0; l < m; ++l) {
      const float dx = g - s_nu[l];
      if (fabsf(dx) <= cutoff && s_amp[l] > 0.f) {
        const float x = s_igd[l] * dx;
        const float y = s_y[l];
        const float rw = fabsf(x) + y >= 8.f ? rew_humlicek2(x, y)
                                             : rew_weideman32(x, y);
        acc += s_amp[l] * rw;
      }
    }
    __syncthreads();
  }
  out[(size_t)tile * kTile + threadIdx.x] = acc;
}

}  // namespace

// Launch the tiled Voigt sum on `stream`: grid_t (n_tiles, 1024) tile-centred
// grid; per-tile centres, first line row and row count; sorted per-line
// nu (band-centred), amp, igd, y. Returns the launch's cudaError_t.
extern "C" int vsm_voigt(const float* grid_t, const float* centers,
                         const int* starts, const int* n_chunks,
                         const float* nu, const float* amp, const float* igd,
                         const float* y, int n_lines, float cutoff,
                         float* out, int n_tiles, void* stream) {
  if (n_tiles <= 0) return 0;
  voigt_kernel<<<n_tiles, kTile, 0, (cudaStream_t)stream>>>(
      grid_t, centers, starts, n_chunks, nu, amp, igd, y, n_lines, cutoff,
      out);
  return (int)cudaGetLastError();
}
