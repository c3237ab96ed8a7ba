// Hodgkin-Huxley cable cells for Hopper (sm_90a): the fused soma update of
// one dt step, and a whole exchange epoch of cable steps in one launch.
//
// The soma, hh_soma(), is one function for both kernels.  Cell by cell:
// the m, h and n gates advance by exponential Euler at the rates of the
// old voltage v0, then the soma voltage relaxes towards the
// conductance-weighted reversal potential:
//   x' = x_inf + (x - x_inf) exp(-dt / tau_x),  tau_x = 1 / (a_x + b_x)
//   g_tot = G_NA m'^3 h' + G_K n'^4 + G_L + g_syn
//   v' = v_inf + (v0 - v_inf) exp(-dt g_tot / C_M),  v_inf = I / g_tot
// About 90 fp32 operations a cell (8 of them exp, 10 divisions).
//
// * The soma rounds as the plain version's PyTorch ops round on the card
//   (see hh_soma), so the two agree bit for bit there: the ring's spike
//   counts over 8,000 steps, and a spike's timing at any step, must equal
//   the plain version's, and an ulp a step is enough to move a spike on
//   its upstroke.  expf and IEEE division, never __expf or fast math (the
//   build passes no --use_fast_math).  On the CPU the plain version
//   divides by a scalar exactly and takes PyTorch's own exp, so there the
//   two differ by an ulp or so a step.
// * vtrap takes its branch per cell.  jnp.where computes both, and at
//   v = -40 (alpha_m) and v = -55 (alpha_n) the discarded one is 0/0; here
//   the limit y (1 - x/y/2) is taken where |x/y| < 1e-6 and the quotient
//   nowhere else.
//
// hh_step_kernel replaces the TPU kernel
// repro/kernels/hh_neuron.py::hh_step_pallas (body _hh_kernel): one dt
// step's soma, seven [N] fp32 inputs and four outputs.  It is bound by
// bytes (44 bytes a cell against those 90 operations, 5.77 MB at the
// ring's 131,072 cells, about 1.7 us at 3.35 TB/s): one thread per cell,
// 256 threads a block, one coalesced pass.  neuro/cable.py::step reaches
// it once a dt step.
//
// cable_epoch_kernel replaces the inner lax.scan of
// repro/neuro/sim.py::_epoch_fn: every dt step of one exchange epoch of
// repro/neuro/cable.py::step, with _hh_kernel inside each.  Within an
// epoch the cells are independent (spikes cross only at the exchange, and
// the epoch's incoming spikes are known when it starts), so one thread
// advances one cell through all the epoch's steps with its state on chip,
// as Arbor's GPU backend keeps it:
//
// * Bound on the H100: operations.  A cell-step does 3 synapse, 4 C
//   stencil, 5 (C - 1) dendrite and ~90 soma operations plus the spike
//   test, 378 at C = 32 (about 500 instructions with expf's and the
//   divisions' own), against 5 bytes of spikes in and out.  The ring's
//   epoch (131,072 cells x 200 steps) does 9.9e9 fp32 operations, 0.15 ms
//   at 67 TFLOP/s, and moves 169 MB, 0.05 ms at 3.35 TB/s.  The plain
//   step moves every [N, C] array through DRAM about twenty times a step.
// * The design: the C voltages, m, h, n and g_syn live in registers for
//   the whole epoch (C is a template parameter, so the compartment loop is
//   unrolled and indexed statically); the state is read once and written
//   once, as new arrays.  A step reads one float of incoming spikes a
//   cell (coalesced, loaded a step ahead) and writes one byte of spiked.
//   128-thread blocks; for C <= 32, __launch_bounds__ asks for 8 blocks an
//   SM (64 registers), so the ring's 4,096 warps fit in one wave of 132
//   SMs x 32 warps; C = 64 keeps its voltages at the cost of occupancy.
//   A grid-stride loop walks a grid cut below N (only the CPU emulation
//   cuts it).
// * Rounding as the plain version rounds: the synapse, stencil and
//   dendrite too round every product and sum on its own (__fmul_rn and
//   __fadd_rn, which nvcc never contracts into an fma).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;        // hh_step_kernel
constexpr int kEpochThreads = 128;   // cable_epoch_kernel

// the classic HH constants, as neuro/cable.py has them
constexpr float kCm = 1.0f;
constexpr float kGNa = 120.0f, kENa = 50.0f;
constexpr float kGK = 36.0f, kEK = -77.0f;
constexpr float kGL = 0.3f;
constexpr float kESyn = 0.0f;
constexpr float kVThresh = -20.0f;   // upward crossing = spike

// The soma rounds as the plain version's PyTorch ops round on the card,
// one op at a time: every product and sum on its own (__fmul_rn and
// __fadd_rn, which nvcc never contracts into an fma); a tensor divided by a
// Python scalar as a product with the scalar's rounded reciprocal (what
// PyTorch's CUDA division does); a Python scalar divided by a tensor as
// the tensor's reciprocal times the scalar (``Tensor.__rtruediv__``);
// n ** 4 through powf; G_L E_L as the Python product rounded once.
constexpr float kInv10 = 1.0f / 10.0f, kInv18 = 1.0f / 18.0f;
constexpr float kInv20 = 1.0f / 20.0f, kInv80 = 1.0f / 80.0f;
constexpr float kGLEL = static_cast<float>(0.3 * -54.4);

// _vtrap(x, 10): the limit where |x / 10| < 1e-6, the quotient elsewhere
__device__ __forceinline__ float vtrap10(float x) {
  const float r = __fmul_rn(x, kInv10);
  if (fabsf(r) < 1e-6f) return __fmul_rn(10.0f, 1.0f - __fmul_rn(r, 0.5f));
  return x / (expf(r) - 1.0f);
}

__device__ __forceinline__ float gate(float x, float a, float b, float dt) {
  const float tau = 1.0f / (a + b);
  const float inf = __fmul_rn(a, tau);
  const float decay = expf(__fmul_rn(1.0f / tau, -dt));
  return __fadd_rn(inf, __fmul_rn(x - inf, decay));
}

// One cell's soma update (the body of _hh_kernel): v is v0 on entry and
// the new voltage on return, m, h and n likewise.
__device__ __forceinline__ void hh_soma(float& v, float& m, float& h,
                                        float& n, float g, float i_axial,
                                        float i_ext, float dt) {
  const float a_m = __fmul_rn(vtrap10(-(v + 40.0f)), 0.1f);
  const float b_m = __fmul_rn(expf(__fmul_rn(-(v + 65.0f), kInv18)), 4.0f);
  const float a_h = __fmul_rn(expf(__fmul_rn(-(v + 65.0f), kInv20)), 0.07f);
  const float b_h =
      1.0f / __fadd_rn(expf(__fmul_rn(-(v + 35.0f), kInv10)), 1.0f);
  const float a_n = __fmul_rn(vtrap10(-(v + 55.0f)), 0.01f);
  const float b_n = __fmul_rn(expf(__fmul_rn(-(v + 65.0f), kInv80)), 0.125f);

  m = gate(m, a_m, b_m, dt);
  h = gate(h, a_h, b_h, dt);
  n = gate(n, a_n, b_n, dt);

  const float g_na = __fmul_rn(__fmul_rn(kGNa, __fmul_rn(__fmul_rn(m, m), m)),
                               h);
  const float g_k = __fmul_rn(kGK, powf(n, 4.0f));
  const float g_tot = __fadd_rn(__fadd_rn(__fadd_rn(g_na, g_k), kGL), g);
  float i_inf = __fadd_rn(__fmul_rn(g_na, kENa), __fmul_rn(g_k, kEK));
  i_inf = __fadd_rn(__fadd_rn(i_inf, kGLEL), __fmul_rn(g, kESyn));
  i_inf = __fadd_rn(__fadd_rn(i_inf, i_axial), i_ext);
  const float v_inf = i_inf / g_tot;
  // exp(-dt g_tot / C_M): the division by C_M = 1 is exact
  const float relax = expf(__fmul_rn(g_tot, -dt / kCm));
  v = __fadd_rn(v_inf, __fmul_rn(v - v_inf, relax));
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
    float v = v0[i], mi = m[i], hi = h[i], ni = n[i];
    hh_soma(v, mi, hi, ni, g_syn[i], i_axial[i], i_ext[i], dt);
    v_out[i] = v;
    m_out[i] = mi;
    h_out[i] = hi;
    n_out[i] = ni;
  }
}

// A cell's constants (neuro/cable.py's CellConfig), as fp32.
struct Cable {
  float dt, dt_cm;           // dt, and dt / C_M
  float g_axial, g_pas, e_pas;
  float syn_decay;           // exp(-dt / tau_syn)
  float syn_weight;
};

// State in [cells, C] (v) and [cells] (m, h, n, g), incoming spikes
// [steps, cells], i_stim [cells]: step s takes i_stim while s < stim_left
// and no external current after.  Writes the state after `steps` steps
// and spiked [steps, cells].
template <int C>
__global__ void __launch_bounds__(kEpochThreads, C <= 32 ? 8 : 1)
cable_epoch_kernel(const float* __restrict__ v_in,
                   const float* __restrict__ m_in,
                   const float* __restrict__ h_in,
                   const float* __restrict__ n_in,
                   const float* __restrict__ g_in,
                   const float* __restrict__ incoming,
                   const float* __restrict__ i_stim,
                   float* __restrict__ v_out, float* __restrict__ m_out,
                   float* __restrict__ h_out, float* __restrict__ n_out,
                   float* __restrict__ g_out, bool* __restrict__ spiked,
                   int cells, int steps, int stim_left, Cable p) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cells;
       i += stride) {
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = v_in[static_cast<size_t>(i) * C + c];
    float m = m_in[i], h = h_in[i], n = n_in[i], g = g_in[i];
    const float stim = i_stim[i];
    const float* in = incoming + i;
    bool* out = spiked + i;
    float spike_next = *in;
    for (int s = 0; s < steps; ++s, out += cells) {
      const float spike = spike_next;
      if (s + 1 < steps) {
        in += cells;
        spike_next = *in;
      }
      // synapse: exponential decay + event increments
      g = __fadd_rn(__fmul_rn(g, p.syn_decay), __fmul_rn(p.syn_weight, spike));
      // stencil from the old voltages (each end's outer neighbour is
      // itself, the edge padding), and the passive dendrite 1..C-1
      const float v0 = v[0];
      const float i_ax0 =
          __fmul_rn(p.g_axial, __fadd_rn(v0 - 2.0f * v0, v[C > 1 ? 1 : 0]));
      float left = v0;
#pragma unroll
      for (int c = 1; c < C; ++c) {
        const float old = v[c];
        const float right = c + 1 < C ? v[c + 1] : old;
        const float i_ax =
            __fmul_rn(p.g_axial, __fadd_rn(left - 2.0f * old, right));
        const float dv = __fmul_rn(
            __fadd_rn(i_ax, __fmul_rn(p.g_pas, p.e_pas - old)), p.dt_cm);
        v[c] = __fadd_rn(old, dv);
        left = old;
      }
      float v_soma = v0;
      hh_soma(v_soma, m, h, n, g, i_ax0, s < stim_left ? stim : 0.0f, p.dt);
      *out = v_soma >= kVThresh && v0 < kVThresh;
      v[0] = v_soma;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) v_out[static_cast<size_t>(i) * C + c] = v[c];
    m_out[i] = m;
    h_out[i] = h;
    n_out[i] = n;
    g_out[i] = g;
  }
}

// Runs `kernel` over `cells` cells, one thread each in blocks of
// `threads`, the grid cut to `max_blocks` where that is > 0; the
// cudaError_t of the launch.  Both kernels are launched here.
template <typename... K, typename... A>
cudaError_t launch(void (*kernel)(K...), int threads, int cells,
                   int max_blocks, cudaStream_t st, A... args) {
  if (cells < 1 || cells > (1 << 30)) return cudaErrorInvalidValue;
  int blocks = (cells + threads - 1) / threads;
  if (max_blocks > 0 && blocks > max_blocks) blocks = max_blocks;
  kernel<<<blocks, threads, 0, st>>>(args...);
  return cudaGetLastError();
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
  return static_cast<int>(launch(
      hh_step_kernel, kThreads, cells, max_blocks,
      static_cast<cudaStream_t>(stream), v0, m, h, n, g_syn, i_axial, i_ext,
      v_out, m_out, h_out, n_out, cells, dt));
}

// One epoch of ``steps`` cable steps for ``cells`` cells of
// ``compartments`` compartments (2, 4, 8, 16, 32 or 64); ``spiked`` is
// [steps, cells] bytes.  Launches on ``stream``; returns a cudaError_t.
extern "C" int cable_epoch_launch(
    const float* v, const float* m, const float* h, const float* n,
    const float* g_syn, const float* incoming, const float* i_stim,
    float* v_out, float* m_out, float* h_out, float* n_out, float* g_out,
    bool* spiked, int cells, int compartments, int steps, int stim_left,
    float dt, float dt_cm, float g_axial, float g_pas, float e_pas,
    float syn_decay, float syn_weight, int max_blocks, void* stream) {
  if (steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Cable p{dt, dt_cm, g_axial, g_pas, e_pas, syn_decay, syn_weight};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CABLE_EPOCH_CASE(C)                                                 \
  case C:                                                                   \
    return static_cast<int>(launch(cable_epoch_kernel<C>, kEpochThreads,    \
                                   cells, max_blocks, st, v, m, h, n,       \
                                   g_syn, incoming, i_stim, v_out, m_out,   \
                                   h_out, n_out, g_out, spiked, cells,      \
                                   steps, stim_left, p));
  switch (compartments) {
    CABLE_EPOCH_CASE(2)
    CABLE_EPOCH_CASE(4)
    CABLE_EPOCH_CASE(8)
    CABLE_EPOCH_CASE(16)
    CABLE_EPOCH_CASE(32)
    CABLE_EPOCH_CASE(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CABLE_EPOCH_CASE
}
