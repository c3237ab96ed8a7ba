// Fused Hodgkin-Huxley soma update, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hh_neuron.py::hh_step_pallas (body
// _hh_kernel).  Same function, cell by cell: the m, h and n gates advance
// by exponential Euler at the rates of the old voltage v0, then the soma
// voltage relaxes towards the conductance-weighted reversal potential:
//   x' = x_inf + (x - x_inf) exp(-dt / tau_x),  tau_x = 1 / (a_x + b_x)
//   g_tot = G_NA m'^3 h' + G_K n'^4 + G_L + g_syn
//   v' = v_inf + (v0 - v_inf) exp(-dt g_tot / C_M),  v_inf = I / g_tot
// About 90 fp32 operations a cell (8 of them exp, 10 divisions), seven
// inputs and four outputs, all [N] fp32.
//
// Bound on the H100: bytes.  The update reads 7 x 4 and writes 4 x 4 bytes
// a cell (5.77 MB at the ring's 131,072 cells, about 1.7 us at 3.35 TB/s)
// against those 90 operations, about 2 a byte, far below the ~20 fp32
// operations per byte where the CUDA cores would bound it.  The TPU kernel
// fused the same pass into VMEM tiles of 8 x 128 cells; here the design is
// the plain one for an elementwise pass:
//
// * One thread per cell, 256 threads a block, with a grid-stride loop: a
//   grid cut below N (max_blocks; the wrapper does not cut it, the CPU
//   emulation cuts it to a few blocks) walks the rest.  Neighbouring
//   threads read neighbouring floats, so every load and store is
//   coalesced.  Any N up to 2^30 is taken (the index stays an int); the
//   TPU's padding to whole (8, 128) tiles is gone.
// * One pass: the seven inputs are read once, the gates and the voltage
//   live in registers, the four outputs are written once.
// * _vtrap takes its branch per cell.  jnp.where computes both, and at
//   v = -40 (alpha_m) and v = -55 (alpha_n) the discarded one is 0/0; here
//   the limit y (1 - x/y/2) is taken where |x/y| < 1e-6 and the quotient
//   nowhere else.
// * expf and IEEE division, never __expf or fast math (the build passes no
//   --use_fast_math): the ring's spike counts over 8,000 steps must equal
//   those of the plain version, which rounds each operation on its own.
//   nvcc may still contract a product and a sum into one fma, so the two
//   differ by a few ulp a step, far inside the 3e-5 the tests hold them to.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

// the classic HH constants, as neuro/cable.py has them
constexpr float kCm = 1.0f;
constexpr float kGNa = 120.0f, kENa = 50.0f;
constexpr float kGK = 36.0f, kEK = -77.0f;
constexpr float kGL = 0.3f, kEL = -54.4f;
constexpr float kESyn = 0.0f;

__device__ __forceinline__ float vtrap(float x, float y) {
  const float r = x / y;
  if (fabsf(r) < 1e-6f) return y * (1.0f - r / 2.0f);
  return x / (expf(r) - 1.0f);
}

__device__ __forceinline__ float gate(float x, float a, float b, float dt) {
  const float tau = 1.0f / (a + b);
  const float inf = a * tau;
  return inf + (x - inf) * expf(-dt / tau);
}

__global__ void __launch_bounds__(kThreads) hh_step_kernel(
    const float* __restrict__ v0, const float* __restrict__ m,
    const float* __restrict__ h, const float* __restrict__ n,
    const float* __restrict__ g_syn, const float* __restrict__ i_axial,
    const float* __restrict__ i_ext, float* __restrict__ v_out,
    float* __restrict__ m_out, float* __restrict__ h_out,
    float* __restrict__ n_out, int cells, float dt) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cells;
       i += stride) {
    const float v = v0[i];
    const float a_m = 0.1f * vtrap(-(v + 40.0f), 10.0f);
    const float b_m = 4.0f * expf(-(v + 65.0f) / 18.0f);
    const float a_h = 0.07f * expf(-(v + 65.0f) / 20.0f);
    const float b_h = 1.0f / (expf(-(v + 35.0f) / 10.0f) + 1.0f);
    const float a_n = 0.01f * vtrap(-(v + 55.0f), 10.0f);
    const float b_n = 0.125f * expf(-(v + 65.0f) / 80.0f);

    const float m_n = gate(m[i], a_m, b_m, dt);
    const float h_n = gate(h[i], a_h, b_h, dt);
    const float n_n = gate(n[i], a_n, b_n, dt);

    const float g = g_syn[i];
    const float g_na = kGNa * (m_n * m_n * m_n) * h_n;
    const float g_k = kGK * (n_n * n_n * n_n * n_n);
    const float g_tot = g_na + g_k + kGL + g;
    const float i_inf = g_na * kENa + g_k * kEK + kGL * kEL + g * kESyn +
                        i_axial[i] + i_ext[i];
    const float v_inf = i_inf / g_tot;
    v_out[i] = v_inf + (v - v_inf) * expf(-dt * g_tot / kCm);
    m_out[i] = m_n;
    h_out[i] = h_n;
    n_out[i] = n_n;
  }
}

}  // namespace

// Launches on ``stream``; returns a cudaError_t (0 on success).
// ``max_blocks`` caps the grid (<= 0: one thread per cell).
extern "C" int hh_step_launch(const float* v0, const float* m, const float* h,
                              const float* n, const float* g_syn,
                              const float* i_axial, const float* i_ext,
                              float* v_out, float* m_out, float* h_out,
                              float* n_out, int cells, float dt,
                              int max_blocks, void* stream) {
  if (cells < 1 || cells > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = (cells + kThreads - 1) / kThreads;
  if (max_blocks > 0 && blocks > max_blocks) blocks = max_blocks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  hh_step_kernel<<<blocks, kThreads, 0, st>>>(v0, m, h, n, g_syn, i_axial,
                                              i_ext, v_out, m_out, h_out,
                                              n_out, cells, dt);
  return static_cast<int>(cudaGetLastError());
}
