// Blockwise flash attention (the training forward), for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel).  Same function: for every (batch*head) row block,
// softmax(q k^T * scale) v over [BH, S, D], causal or not, with an fp32
// online softmax (running max, running denominator, fp32 accumulator) and one
// rounding of the output to q's dtype.  Key tiles wholly above the diagonal
// are never visited.  It also writes the fp32 row log-sum-exp [BH, S]
// (m + log l, on the scaled scores) that the backward reads to rebuild P.
//
// Bound on the H100: operations.  A causal call does 2 * BH * S^2 * D flops
// and moves 4 * BH * S * D inputs and outputs once, so at the training shape
// (S 2048, D 128) it sits far above the card's ~295 flops per byte.  This
// first design is the simple one: fp32 FMAs on the CUDA cores (no tensor
// cores), so it cannot come near the bf16 tensor-core bound; wgmma with TMA
// staging is later work.  What it does to keep the CUDA cores fed:
//
// * One block of 128 threads per (bh, tile of kBQ = 32 query rows); the
//   heaviest (last) row tiles are launched first, since causal work grows
//   with the tile index.  The TPU grid walks key blocks in order inside one
//   core; here the key loop runs inside the block.
// * Each query row belongs to kTPR = 4 neighbouring lanes.  A lane holds
//   every 4th 16-byte chunk of its row's q and of its fp32 accumulator in
//   registers, so a key's dot product is kTPR partial sums joined by two
//   shuffles.
// * K and V tiles of kBK = 32 keys are staged in shared memory as fp32,
//   loaded by the whole block with 8- or 16-byte loads.  In the score and
//   P*V loops the 8 rows of a warp read the same 64 bytes of a key row, so
//   every shared-memory read is a conflict-free broadcast of one float4 that
//   feeds four FMAs.
// * The online softmax runs once per tile: the tile's 32 scores of a row sit
//   in registers; masked keys (causal, or past S) get P = 0.
//
// Head dims 4..128 in multiples of 4 (every dense arch's 32..128); any S,
// with tail rows and keys masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;                // query rows per block
constexpr int kBK = 32;                // keys per shared-memory tile
constexpr int kTPR = 4;                // lanes per query row
constexpr int kThreads = kBQ * kTPR;   // 128
constexpr int kMaxD = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // four bf16 in 8 bytes; a bf16 is the high half of its float
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  float4 r;
  r.x = __uint_as_float(u.x << 16);
  r.y = __uint_as_float(u.x & 0xffff0000u);
  r.z = __uint_as_float(u.y << 16);
  r.w = __uint_as_float(u.y & 0xffff0000u);
  return r;
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  p[0] = __float2bfloat16(v.x);  // round to nearest even, as torch's cast
  p[1] = __float2bfloat16(v.y);
  p[2] = __float2bfloat16(v.z);
  p[3] = __float2bfloat16(v.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// kNC: 16-byte chunks per lane, ceil(D / 16); a lane owns chunks
// c * kTPR + t of its row.
template <typename T, int kNC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const void* q_, const void* k_, const void* v_,
                       void* out_, float* __restrict__ lse, int BH, int S,
                       int D, float scale, int causal) {
  extern __shared__ float smem[];
  float* ks = smem;             // [kBK][D] fp32
  float* vs = smem + kBK * D;   // [kBK][D] fp32
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  T* out = static_cast<T*>(out_);

  const int nq = (S + kBQ - 1) / kBQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int tid = threadIdx.x;
  const int t = tid % kTPR;
  const int row = qt * kBQ + tid / kTPR;
  const bool live = row < S;
  const int D4 = D / 4;
  const size_t base = static_cast<size_t>(bh) * S * D;

  float4 qr[kNC], acc[kNC];
#pragma unroll
  for (int c = 0; c < kNC; ++c) {
    const int ch = c * kTPR + t;
    qr[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live && ch < D4) qr[c] = load4(q + base + (size_t)row * D + ch * 4);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, l = 0.f;

  // causal: keys past the tile's last row are above the diagonal
  const int n_keys = causal ? min(qt * kBQ + kBQ, S) : S;
  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    __syncthreads();  // every lane is done with the previous tile
    for (int e = tid; e < kBK * D4; e += kThreads) {
      const int j = e / D4, ch = e % D4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (k0 + j < S) {
        const size_t off = base + (size_t)(k0 + j) * D + ch * 4;
        kk = load4(k + off);
        vv = load4(v + off);
      }
      store4(ks + j * D + ch * 4, kk);
      store4(vs + j * D + ch * 4, vv);
    }
    __syncthreads();

    float s[kBK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int ch = c * kTPR + t;
        if (ch < D4) part += dot4(qr[c], load4(ks + j * D + ch * 4));
      }
      part += __shfl_xor_sync(kFull, part, 1);
      part += __shfl_xor_sync(kFull, part, 2);
      const int key = k0 + j;
      const bool ok = key < S && (!causal || key <= row);
      s[j] = ok ? part * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;  // no live key for this row yet
    const float alpha = expf(m - m_new);   // 0 on the first live tile
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);           // masked keys: exp(-inf) = 0
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = s[j];
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int ch = c * kTPR + t;
        if (ch < D4) {
          const float4 vv = load4(vs + j * D + ch * 4);
          acc[c].x += p * vv.x;
          acc[c].y += p * vv.y;
          acc[c].z += p * vv.z;
          acc[c].w += p * vv.w;
        }
      }
    }
    m = m_new;
  }

  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < kNC; ++c) {
    const int ch = c * kTPR + t;
    if (ch < D4) {
      const float4 o = make_float4(acc[c].x / denom, acc[c].y / denom,
                                   acc[c].z / denom, acc[c].w / denom);
      store4(out + base + (size_t)row * D + ch * 4, o);
    }
  }
  if (t == 0) lse[(size_t)bh * S + row] = m + logf(denom);
}

using Kernel = void (*)(const void*, const void*, const void*, void*, float*,
                        int, int, int, float, int);

template <typename T>
Kernel pick(int nc) {
  switch (nc) {
#define FA_CASE(N) \
  case N:          \
    return flash_attention_kernel<T, N>;
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4)
    FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
#undef FA_CASE
    default:
      return nullptr;
  }
}

}  // namespace

// q, k, v, out: [BH, S, D] contiguous, 16-byte aligned; lse: [BH, S] fp32.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int BH, int S, int D, float scale,
                                      int causal, int dtype, void* stream) {
  if (BH < 1 || S < 1 || D < 4 || D > kMaxD || D % 4 != 0 ||
      (long long)BH * ((S + kBQ - 1) / kBQ) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (D / 4 + kTPR - 1) / kTPR;
  const Kernel kernel = dtype == 0   ? pick<float>(nc)
                        : dtype == 1 ? pick<__nv_bfloat16>(nc)
                                     : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BH * ((S + kBQ - 1) / kBQ));
  const size_t smem = 2 * kBK * D * sizeof(float);  // <= 32 KB
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<grid, kThreads, smem, st>>>(
      q, k, v, out, lse, BH, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
