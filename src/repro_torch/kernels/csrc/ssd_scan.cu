// Mamba2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan_pallas (body
// _ssd_kernel).  Same function: for every (batch, head) the sequence is
// walked chunk by chunk (Q = chunk tokens).  Within a chunk, with
// seg = cumsum(dt * a):
//   y = (C B^T * exp(seg_q - seg_k) * [k <= q] * dt_k) x + (C * exp(seg)) S^T
//   S <- S * exp(seg_last) + x^T (B * exp(seg_last - seg) * dt)
// The state S [P, N] is fp32; groups of B and C broadcast to heads by
// h / (H / G).  y is accumulated in fp32 and rounded once to x's dtype; the
// final state is written in fp32.
//
// Bound on the H100: bytes.  At the training call (x [4, 2048, 80, 64]
// bf16, chunk 256, N 128) the call must move about 185 MB (x and y 84 MB
// each, dt, B, C and the final state) and do about 3.3e10 useful flops
// (C B^T shared by the heads of a group), so it sits below the card's ~295
// flops per byte.  This first design is the simple one, and it is far from
// that bound: scalar fp32 FMAs on the CUDA cores, C B^T recomputed for every
// head.  What it does:
//
// * One block of 256 threads per (batch, head).  The TPU grid walks the
//   chunks in order with the state in VMEM scratch; here the chunk loop runs
//   inside the block and the state lives in shared memory ([P][N+1] floats,
//   padded so a warp's lanes reading different p rows hit different banks).
// * A chunk is cut into tiles of kT = 32 query rows; for each, the keys are
//   walked in tiles of 32 up to the diagonal tile (tiles above it are never
//   visited).  A tile of C (query rows), B and x (key rows) is staged in
//   shared memory as fp32; B at Q = 256, N = 128 would not fit whole beside
//   C.  Each warp owns four query rows; in the C B^T product a lane owns one
//   key, in the product with x a lane owns the p columns lane + 32 j.
// * Only k <= q is computed: exp(seg_q - seg_k) is taken inside the mask,
//   where the argument is never positive, so it cannot overflow (the
//   reference's dense exp above the diagonal can, and is masked after).
// * seg is one thread's sequential cumsum, in the reference's order.
// * After the chunk's outputs, the state update walks the key tiles once
//   more, B pre-scaled by exp(seg_last - seg_k) dt_k; a warp owns the p rows
//   warp + 8 r and a lane the n columns lane + 32 j of the new state.
//
// P and N up to 128 each (any value; templates on ceil(P/32) and ceil(N/32)),
// any chunk whose working set fits shared memory, S a multiple of the chunk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // 8
constexpr int kT = 32;                  // query rows / keys per tile
constexpr int kRows = kT / kWarps;      // query rows per warp in a tile: 4
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;
constexpr size_t kMaxSmem = 232448;     // a block's shared memory on sm_90

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// kPJ = ceil(P / 32): p columns per lane; kNJ = ceil(N / 32): n columns per
// lane in the state update, where a warp owns kPJ * 4 = ceil(P / 8) p rows.
template <typename T, int kPJ, int kNJ>
__global__ void __launch_bounds__(kThreads, 2) ssd_scan_kernel(
    const void* x_, const float* __restrict__ dt, const float* __restrict__ a,
    const void* b_, const void* c_, void* y_, float* __restrict__ fin, int S,
    int H, int P, int G, int N, int Q) {
  const T* __restrict__ x = static_cast<const T*>(x_);
  const T* __restrict__ bm = static_cast<const T*>(b_);
  const T* __restrict__ cm = static_cast<const T*>(c_);
  T* __restrict__ y = static_cast<T*>(y_);
  constexpr int kPR = kPJ * 4;  // state rows per warp: p = warp + 8 r
  extern __shared__ float smem[];
  const int NS = N + 1;                // padded row stride of state and B
  float* state = smem;                 // [P][NS]
  float* seg = state + P * NS;         // [Q] cumsum(dt * a)
  float* dts = seg + Q;                // [Q] dt
  float* wk = dts + Q;                 // [Q] exp(seg_last - seg) * dt
  float* ctile = wk + Q;               // [kT][NS] C rows of the query tile
  float* btile = ctile + kT * NS;      // [kT][NS] B rows of the key tile
  float* xtile = btile + kT * NS;      // [kT][P]  x rows of the key tile
  float* mtile = xtile + kT * P;       // [kT][kT + 1] masked decayed C B^T dt

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float ah = a[h];
  const size_t xs = (size_t)H * P;     // stride of one token in x and y
  const size_t bs = (size_t)G * N;     // stride of one token in B and C
  const T* xb = x + (size_t)b * S * xs + (size_t)h * P;
  T* yb = y + (size_t)b * S * xs + (size_t)h * P;
  const T* bb = bm + (size_t)b * S * bs + (size_t)grp * N;
  const T* cb = cm + (size_t)b * S * bs + (size_t)grp * N;
  const float* dtb = dt + (size_t)b * S * H + h;

  for (int i = tid; i < P * NS; i += kThreads) state[i] = 0.f;

  // Stage kT rows from token t0 of a [S, *, width] tensor into a tile of
  // row stride `stride`, scaled by `scale` (rows past the chunk are zeros).
  auto stage = [&](float* tile, int stride, const T* src, size_t tok_stride,
                   int width, int t0, int rows, const float* scale) {
    for (int i = tid; i < kT * width; i += kThreads) {
      const int r = i / width, c = i % width;
      float v = 0.f;
      if (r < rows) {
        v = ld(src + (size_t)(t0 + r) * tok_stride + c);
        if (scale != nullptr) v *= scale[r];
      }
      tile[r * stride + c] = v;
    }
  };

  for (int c0 = 0; c0 < S; c0 += Q) {
    for (int i = tid; i < Q; i += kThreads) dts[i] = dtb[(size_t)(c0 + i) * H];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += dts[i] * ah;
        seg[i] = run;
      }
    }
    __syncthreads();
    const float last = seg[Q - 1];
    for (int i = tid; i < Q; i += kThreads) wk[i] = expf(last - seg[i]) * dts[i];

    // ---- outputs, one tile of kT query rows at a time ----
    for (int q0 = 0; q0 < Q; q0 += kT) {
      const int qrows = min(kT, Q - q0);
      stage(ctile, NS, cb, bs, N, c0 + q0, qrows, nullptr);
      __syncthreads();

      float acc[kRows][kPJ];
      // inter-chunk term: exp(seg_q) * sum_n C[q, n] S[p, n]
      {
        int prow[kPJ];
#pragma unroll
        for (int j = 0; j < kPJ; ++j) prow[j] = min(lane + 32 * j, P - 1) * NS;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < kPJ; ++j) acc[r][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[kRows], sv[kPJ];
#pragma unroll
          for (int r = 0; r < kRows; ++r) cv[r] = ctile[(warp + kWarps * r) * NS + n];
#pragma unroll
          for (int j = 0; j < kPJ; ++j) sv[j] = state[prow[j] + n];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int j = 0; j < kPJ; ++j) acc[r][j] += cv[r] * sv[j];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int qi = warp + kWarps * r;
          const float e = qi < qrows ? expf(seg[q0 + qi]) : 0.f;
#pragma unroll
          for (int j = 0; j < kPJ; ++j) acc[r][j] *= e;
        }
      }

      // intra-chunk term over the key tiles up to the diagonal
      for (int k0 = 0; k0 <= q0; k0 += kT) {
        const int krows = min(kT, Q - k0);
        stage(btile, NS, bb, bs, N, c0 + k0, krows, nullptr);
        stage(xtile, P, xb, xs, P, c0 + k0, krows, nullptr);
        __syncthreads();
        {
          // lane owns key k0 + lane; M = C B^T * exp(seg_q - seg_k) * dt_k
          float cbv[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) cbv[r] = 0.f;
          const float* brow = btile + lane * NS;
          for (int n = 0; n < N; ++n) {
            const float bv = brow[n];
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              cbv[r] += ctile[(warp + kWarps * r) * NS + n] * bv;
          }
          const int k = k0 + lane;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int qi = warp + kWarps * r, q = q0 + qi;
            float m = 0.f;
            if (k <= q && qi < qrows && lane < krows)
              m = cbv[r] * expf(seg[q] - seg[k]) * dts[k];
            mtile[qi * (kT + 1) + lane] = m;
          }
        }
        __syncthreads();
        for (int kk = 0; kk < krows; ++kk) {
          float xv[kPJ];
#pragma unroll
          for (int j = 0; j < kPJ; ++j)
            xv[j] = xtile[kk * P + min(lane + 32 * j, P - 1)];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float mv = mtile[(warp + kWarps * r) * (kT + 1) + kk];
#pragma unroll
            for (int j = 0; j < kPJ; ++j) acc[r][j] += mv * xv[j];
          }
        }
        __syncthreads();  // the next key tile overwrites B, x and M
      }

#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int qi = warp + kWarps * r;
        if (qi >= qrows) continue;
        T* yrow = yb + (size_t)(c0 + q0 + qi) * xs;
#pragma unroll
        for (int j = 0; j < kPJ; ++j) {
          const int p = lane + 32 * j;
          if (p < P) store1(yrow + p, acc[r][j]);
        }
      }
    }

    // ---- state update: S <- S exp(seg_last) + x^T (B * wk) ----
    float sacc[kPR][kNJ];
#pragma unroll
    for (int r = 0; r < kPR; ++r)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) sacc[r][j] = 0.f;
    for (int k0 = 0; k0 < Q; k0 += kT) {
      const int krows = min(kT, Q - k0);
      stage(btile, NS, bb, bs, N, c0 + k0, krows, wk + k0);
      stage(xtile, P, xb, xs, P, c0 + k0, krows, nullptr);
      __syncthreads();
      for (int kk = 0; kk < krows; ++kk) {
        float bv[kNJ];
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          bv[j] = btile[kk * NS + min(lane + 32 * j, N - 1)];
#pragma unroll
        for (int r = 0; r < kPR; ++r) {
          const float xv = xtile[kk * P + min(warp + kWarps * r, P - 1)];
#pragma unroll
          for (int j = 0; j < kNJ; ++j) sacc[r][j] += xv * bv[j];
        }
      }
      __syncthreads();
    }
    const float decay = expf(last);
#pragma unroll
    for (int r = 0; r < kPR; ++r) {
      const int p = warp + kWarps * r;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int n = lane + 32 * j;
        if (p < P && n < N)
          state[p * NS + n] = state[p * NS + n] * decay + sacc[r][j];
      }
    }
    __syncthreads();
  }

  float* fb = fin + (size_t)bh * P * N;
  for (int i = tid; i < P * N; i += kThreads)
    fb[i] = state[(i / N) * NS + i % N];
}

using Kernel = void (*)(const void*, const float*, const float*, const void*,
                        const void*, void*, float*, int, int, int, int, int,
                        int);

template <typename T, int kPJ>
Kernel pick_n(int nj) {
  switch (nj) {
#define SSD_CASE(NJ) \
  case NJ:           \
    return ssd_scan_kernel<T, kPJ, NJ>;
    SSD_CASE(1) SSD_CASE(2) SSD_CASE(3) SSD_CASE(4)
#undef SSD_CASE
    default:
      return nullptr;
  }
}

template <typename T>
Kernel pick(int pj, int nj) {
  switch (pj) {
    case 1: return pick_n<T, 1>(nj);
    case 2: return pick_n<T, 2>(nj);
    case 3: return pick_n<T, 3>(nj);
    case 4: return pick_n<T, 4>(nj);
    default: return nullptr;
  }
}

}  // namespace

// x, y: [B, S, H, P]; dt: [B, S, H] fp32; a: [H] fp32; b, c: [B, S, G, N]
// in x's dtype; fin: [B, H, P, N] fp32.  All contiguous.  dtype: 0 =
// float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* a,
                               const void* b, const void* c, void* y,
                               float* fin, int B, int S, int H, int P, int G,
                               int N, int Q, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 ||
      P > kMaxP || N < 1 || N > kMaxN || Q < 1 || S % Q != 0 ||
      (long long)B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) *
      ((size_t)P * (N + 1) + 3 * (size_t)Q + 2 * (size_t)kT * (N + 1) +
       (size_t)kT * P + (size_t)kT * (kT + 1));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int pj = (P + 31) / 32, nj = (N + 31) / 32;
  const Kernel kernel = dtype == 0   ? pick<float>(pj, nj)
                        : dtype == 1 ? pick<__nv_bfloat16>(pj, nj)
                                     : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<grid, kThreads, smem, st>>>(x, dt, a, b, c, y, fin, S, H, P, G, N,
                                       Q);
  return static_cast<int>(cudaGetLastError());
}
