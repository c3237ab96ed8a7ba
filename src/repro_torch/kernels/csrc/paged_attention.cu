// Chunked decode attention through the page table, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::paged_attention_pallas
// (body _paged_kernel).  Same function: for each lane b and kv head h, the
// C*G query rows (chunk positions times the GQA group) attend the lane's
// pages 0..last of the shared K/V pool, reached through page_table[b], under
// the causal chunk mask k_pos <= pos + row / G; an fp32 online softmax; the
// output cast once.  Rows at or past max(n_new, 1) * G are garbage the
// caller discards: they are written as zeros, so the output never holds
// uninitialised memory.  Idle lanes (n_new == 0) still attend page 0.
//
// Bound on the H100: device memory.  Every (lane, kv head) reads the K and V
// rows of its visited pages once, hd * 2 * sizeof(T) bytes per key, and does
// 4 * hd flops per key and query row: with a handful of query rows per kv
// head that is far below the card's ~295 flops per byte, so the least time is
// the bytes of the visited pages over 3.35 TB/s.  What the design does about
// it is to keep many wide loads in flight and little else on the way:
//
// * One thread block per (lane, kv head, tile of kRows query rows); the block
//   reads its own pos, n_new and page-table row (in place of the TPU's
//   scalar prefetch).  Its kWarps warps split the lane's pages (page j goes
//   to warp j % kWarps), so even a single decode row walks its pages
//   eight-wide.  The query rows sit in shared memory as fp32.
// * Scores: a page is taken kKeysPerPass keys at a time, LPK lanes per key.
//   Each lane loads 16-byte chunks of its key's row (kCB chunks in flight per
//   lane, neighbouring lanes on neighbouring addresses) and the key's dot
//   products are reduced over its LPK lanes by log2(LPK) shuffles: no
//   reduction per key over the whole warp.
// * Online softmax once per pass: one warp max and one warp sum per row.
// * P*V: a V row is spread over lpr lanes, 16 bytes each, and the warp's
//   32 / lpr lane groups take different keys; the groups' sums are added
//   once at the end.  Each lane keeps a running max, denominator and its
//   slice of the hd-wide accumulator in fp32 registers.
// * The warps' partial softmaxes are merged once through shared memory.
//
// K and V are read straight from device memory into registers; staging
// through shared memory with TMA, wgmma for long chunks and split-K across
// blocks (for few lanes times kv heads) are later work.  Head dims whose
// rows are not a whole number of 16-byte chunks take the same kernel with
// one element per chunk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 8;           // query rows per block
constexpr int kCB = 8;             // K chunks loaded together per lane
constexpr float kNegInf = -1e30f;  // the mask value of the TPU kernel
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// E consecutive elements of a K or V row, loaded as one access.  The vector
// forms hold 16 bytes and convert on use (bf16 -> fp32 is a shift: exact).
template <typename T, bool kVec>
struct Chunk;

template <typename T>
struct Chunk<T, false> {
  static constexpr int E = 1;
  float x;
  __device__ __forceinline__ void load(const T* p) { x = to_float(*p); }
  __device__ __forceinline__ void zero() { x = 0.f; }
  __device__ __forceinline__ float get(int) const { return x; }
};

template <>
struct Chunk<float, true> {
  static constexpr int E = 4;
  uint4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { raw = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ float get(int e) const {
    return __uint_as_float(word(raw, e));
  }
};

template <>
struct Chunk<__nv_bfloat16, true> {
  static constexpr int E = 8;
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { raw = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ float get(int e) const {
    const uint32_t w = word(raw, e >> 1);  // element 2i is the low half
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

// fp32 dot product of E query values in shared memory with a chunk
template <int E, typename Ch>
__device__ __forceinline__ float dot_chunk(const float* qs, const Ch& k,
                                           float acc) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int e4 = 0; e4 < E; e4 += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + e4);
      acc = fmaf(qv.x, k.get(e4), acc);
      acc = fmaf(qv.y, k.get(e4 + 1), acc);
      acc = fmaf(qv.z, k.get(e4 + 2), acc);
      acc = fmaf(qv.w, k.get(e4 + 3), acc);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) acc = fmaf(qs[e], k.get(e), acc);
  }
  return acc;
}

__host__ __device__ constexpr int pow2ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// LPK: lanes per key in the score pass.  kVec: 16-byte chunks.
template <typename T, int LPK, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ page_table,
                       const int* __restrict__ pos_arr,
                       const int* __restrict__ n_new_arr, T* __restrict__ out,
                       int C, int KV, int G, int hd, int bs, int n_pages,
                       float scale) {
  using Ch = Chunk<T, kVec>;
  constexpr int E = Ch::E;
  constexpr int kKeysPerPass = 32 / LPK;
  // V chunks per lane at hd <= 256, and V rows loaded together per lane
  constexpr int kCPL = kVec ? (sizeof(T) == 2 ? 1 : 2) : 8;
  constexpr int kVB = 8 / kCPL;

  extern __shared__ float smem[];
  float* sq = smem;                          // [kRows][hd] query rows
  float* sm_m = sq + kRows * hd;             // [kWarps][kRows]
  float* sm_l = sm_m + kWarps * kRows;       // [kWarps][kRows]
  float* sm_acc = sm_l + kWarps * kRows;     // [kWarps][kRows][hd]

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int row0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int pos = pos_arr[b];
  // a lane has at most C fresh rows (the TPU kernel's block shape bounds
  // them): never index q past the lane's chunk
  const int n_eff = min(max(n_new_arr[b], 1), C);
  const int rows_total = C * G;
  // live rows of this tile; rows past max(n_new, 1) * G are garbage
  const int nr = max(0, min(kRows, n_eff * G - row0));
  const int nch = hd / E;                    // chunks per K or V row
  const int lpr = min(32, pow2ceil(nch));    // lanes per V row
  const int kgv = 32 / lpr;                  // V lane groups (keys at once)
  const int vsub = lane % lpr;
  const int vgrp = lane / lpr;
  const int ksub = lane % LPK;
  const int kkey = lane / LPK;

  for (int i = threadIdx.x; i < kRows * hd; i += blockDim.x) {
    const int r = i / hd;
    const int rr = row0 + r;
    sq[i] = r < nr ? to_float(q[((((size_t)b * C + rr / G) * KV + h) * G +
                                 rr % G) * (size_t)hd + i % hd])
                   : 0.f;
  }
  __syncthreads();

  float m[kRows];
  float l[kRows];
  float acc[kRows][kCPL][E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int w = 0; w < kCPL; ++w)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][w][e] = 0.f;
  }

  if (nr > 0) {
    // the lane's last page holding a valid row (the TPU kernel's `last`);
    // the table is never read past n_pages
    const int last = min((pos + n_eff - 1) / bs, n_pages - 1);
    const int* pt = page_table + (size_t)b * n_pages;
    const size_t row_stride = (size_t)KV * hd;
    const int v_iters = (kKeysPerPass + kgv - 1) / kgv;
    for (int j = warp; j <= last; j += kWarps) {
      const size_t base = (size_t)pt[j] * bs * row_stride + (size_t)h * hd;
      for (int t0 = 0; t0 < bs; t0 += kKeysPerPass) {
        // ---- scores of keys t0 .. t0 + kKeysPerPass - 1, LPK lanes each
        const int t = t0 + kkey;
        const bool key_ok = t < bs;
        const T* kp = k_pool + base + (size_t)(key_ok ? t : 0) * row_stride;
        float s[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) s[r] = 0.f;
        for (int c0 = ksub; c0 < nch; c0 += LPK * kCB) {
          Ch kc[kCB];
#pragma unroll
          for (int u = 0; u < kCB; ++u) {
            const int c = c0 + u * LPK;
            if (c < nch) kc[u].load(kp + c * E); else kc[u].zero();
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < nr) {
#pragma unroll
              for (int u = 0; u < kCB; ++u) {
                const int c = c0 + u * LPK;
                if (c < nch) s[r] = dot_chunk<E>(sq + r * hd + c * E, kc[u], s[r]);
              }
            }
          }
        }
        // ---- online softmax over the pass; masked keys weigh exactly 0
        // (a warp may meet a pass with no valid key for a row before any
        // other)
        const int kpos = j * bs + t;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < nr) {
            float x = s[r];
#pragma unroll
            for (int o = LPK / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
            const bool ok = key_ok && kpos <= pos + (row0 + r) / G;
            x = ok ? x * scale : kNegInf;            // causal chunk mask
            const float m_new = fmaxf(m[r], warp_max(x));
            const float alpha = expf(m[r] - m_new);
            const float p = ok ? expf(x - m_new) : 0.f;
            l[r] = l[r] * alpha + warp_sum(ksub == 0 ? p : 0.f);
            m[r] = m_new;
            s[r] = p;
#pragma unroll
            for (int w = 0; w < kCPL; ++w)
#pragma unroll
              for (int e = 0; e < E; ++e) acc[r][w][e] *= alpha;
          }
        }
        // ---- P*V: lane group vgrp takes keys vgrp, vgrp + kgv, ...
        for (int i0 = 0; i0 < v_iters; i0 += kVB) {
          Ch vc[kVB][kCPL];
#pragma unroll
          for (int u = 0; u < kVB; ++u) {
            const int kk = vgrp + kgv * (i0 + u);
            const bool ok = kk < kKeysPerPass && t0 + kk < bs;
            const T* vp = v_pool + base + (size_t)(ok ? t0 + kk : 0) * row_stride;
#pragma unroll
            for (int w = 0; w < kCPL; ++w) {
              const int c = vsub + lpr * w;
              if (ok && c < nch) vc[u][w].load(vp + c * E); else vc[u][w].zero();
            }
          }
#pragma unroll
          for (int u = 0; u < kVB; ++u) {
            // the key's weight, from a lane of its score group (a key out of
            // range has weight 0 and zero chunks)
            const int src = min(vgrp + kgv * (i0 + u), kKeysPerPass - 1) * LPK;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (r < nr) {
                const float p = __shfl_sync(kFull, s[r], src);
#pragma unroll
                for (int w = 0; w < kCPL; ++w)
#pragma unroll
                  for (int e = 0; e < E; ++e)
                    acc[r][w][e] = fmaf(p, vc[u][w].get(e), acc[r][w][e]);
              }
            }
          }
        }
      }
    }
    // add the V lane groups' sums: lanes vsub, vsub + lpr, ... hold parts
    // of the same dims
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nr) {
        for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
          for (int w = 0; w < kCPL; ++w)
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[r][w][e] += __shfl_xor_sync(kFull, acc[r][w][e], o);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane == 0) {
      sm_m[warp * kRows + r] = m[r];
      sm_l[warp * kRows + r] = l[r];
    }
    if (vgrp == 0) {
#pragma unroll
      for (int w = 0; w < kCPL; ++w) {
        const int c = vsub + lpr * w;
        if (c < nch) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            sm_acc[(warp * kRows + r) * hd + c * E + e] = acc[r][w][e];
        }
      }
    }
  }
  __syncthreads();

  // merge the warps' partial softmaxes; warp w finalises row w
  for (int r = warp; r < kRows; r += kWarps) {
    const int rr = row0 + r;
    if (rr >= rows_total) break;
    T* o = out + ((((size_t)b * C + rr / G) * KV + h) * G + rr % G) * (size_t)hd;
    if (r >= nr) {
      for (int d = lane; d < hd; d += 32) o[d] = from_float<T>(0.f);
      continue;
    }
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * kRows + r]);
    float wt[kWarps];
    float denom = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      wt[w] = expf(sm_m[w * kRows + r] - mx);
      denom += sm_l[w * kRows + r] * wt[w];
    }
    denom = fmaxf(denom, 1e-30f);
    for (int d = lane; d < hd; d += 32) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += sm_acc[(w * kRows + r) * hd + d] * wt[w];
      o[d] = from_float<T>(a / denom);
    }
  }
}

template <typename T, int LPK, bool kVec>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* pos, const void* nn, void* out, int B, int C, int KV,
           int G, int hd, int bs, int n_pages, float scale,
           cudaStream_t stream) {
  const size_t smem =
      ((size_t)(kRows + kWarps * kRows) * hd + 2 * kWarps * kRows) *
      sizeof(float);
  auto kernel = paged_attention_kernel<T, LPK, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B * KV, (C * G + kRows - 1) / kRows);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pt),
      static_cast<const int*>(pos), static_cast<const int*>(nn),
      static_cast<T*>(out), C, KV, G, hd, bs, n_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
int launch_lpk(int lpk, const void* q, const void* k, const void* v,
               const void* pt, const void* pos, const void* nn, void* out,
               int B, int C, int KV, int G, int hd, int bs, int n_pages,
               float scale, cudaStream_t s) {
  switch (lpk) {
#define PA_CASE(L)                                                          \
  case L:                                                                   \
    return launch<T, L, kVec>(q, k, v, pt, pos, nn, out, B, C, KV, G, hd,  \
                              bs, n_pages, scale, s);
    PA_CASE(1) PA_CASE(2) PA_CASE(4) PA_CASE(8)
#undef PA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, const void* pt,
                 const void* pos, const void* nn, void* out, int B, int C,
                 int KV, int G, int hd, int bs, int n_pages, float scale,
                 cudaStream_t s) {
  // enough lanes per key that one pass covers a page of up to 32 keys
  const int keys = pow2ceil(bs < 32 ? bs : 32);
  const int lpk = keys >= 32 ? 1 : keys >= 4 ? 32 / keys : 8;
  // 16-byte chunks when every K/V row starts on a 16-byte boundary
  const bool vec = (hd * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (vec)
    return launch_lpk<T, true>(lpk, q, k, v, pt, pos, nn, out, B, C, KV, G,
                               hd, bs, n_pages, scale, s);
  return launch_lpk<T, false>(lpk, q, k, v, pt, pos, nn, out, B, C, KV, G,
                              hd, bs, n_pages, scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* page_table, const void* pos,
                                      const void* n_new, void* out, int B,
                                      int C, int KV, int G, int hd, int bs,
                                      int n_pages, float scale, int dtype,
                                      void* stream) {
  if (B < 1 || C < 1 || KV < 1 || G < 1 || hd < 1 || hd > 256 || bs < 1 ||
      bs > 64 || n_pages < 1 || (C * G + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<float>(q, k_pool, v_pool, page_table, pos, n_new, out,
                               B, C, KV, G, hd, bs, n_pages, scale, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k_pool, v_pool, page_table, pos,
                                       n_new, out, B, C, KV, G, hd, bs,
                                       n_pages, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
