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
// (S 2048, D 128) it sits far above the card's ~295 flops per byte.  Two
// designs, chosen up front by dtype and head dim (flash_attention_design):
//
// The tensor-core design (bf16, D a multiple of 16 from 32: every arch's
// head dim).  Its products run as mma.sync m16n8k16 bf16 -> fp32, whose
// rate is far above the 67 TFLOP/s fp32 floor that held the scalar design
// at 2 ms or more (1.375e11 flops at the training shape).  Against the
// scalar design's four limits (scalar FMAs, 255 registers, a synchronous
// fp32 staging between two barriers, 32-row query tiles):
//
// * One block of 8 warps per (bh, tile of 128 query rows), 16 rows a warp;
//   the heaviest causal tiles are launched first.  Each K/V tile of 64 keys
//   is fetched once for 128 query rows.
// * Q is staged once and its A fragments kept in registers (ldmatrix.x4).
//   K and V go through a 2-stage ring in shared memory as bf16, every load a
//   16-byte cp.async.cg (rows past S zero-filled through its src-size), one
//   commit group a tile: tile k+1 is in flight while tile k is multiplied,
//   and one barrier a tile orders the ring.  Rows are 16-byte chunks,
//   chunk c of row r stored at c ^ (r & 7) in a row of a multiple of 8
//   chunks, so every ldmatrix (8 rows at one logical chunk) is free of bank
//   conflicts.
// * S = Q K^T: K's B fragments by non-transposed ldmatrix (K is stored key
//   by d, i.e. N by K).  The online softmax runs on the accumulator
//   fragments: a row's 64 scores lie on the 4 lanes of a quad, so its max
//   takes two shuffles; each lane keeps a partial row sum, joined once at
//   the end.  The mask is applied only on tiles that cross the diagonal or
//   S; a warp skips the tiles wholly above its rows.
// * O += P V: the C fragments of two neighbouring 8-key tiles are one A
//   fragment of k 16, so P is packed to bf16x2 in registers.  bf16 P alone
//   misses the plain version's band at S 2048 (the plain version keeps P in
//   fp32), so P goes through as P_hi = bf16(p) and P_lo = bf16(p - P_hi):
//   two MMAs a fragment, 1.5x the tensor-core flops of one.  V's B
//   fragments come by ldmatrix.trans.  The row sum is taken from the fp32 p.
// * Scores are scaled by scale * log2(e) and exponentiated with exp2f; the
//   log-sum-exp is converted back to natural log once per row.
// * Registers: a lane holds O (D / 2 fp32), S (32), Q's fragments (D / 4)
//   and P's hi and lo (8): ptxas gives 229 at D 128 without spills, so one
//   8-warp block an SM, the scalar design's 8 warps, now each issuing
//   16 x 8 x 16 products an instruction.
//
// This design is bounded by mma.sync's issue rate and the softmax between
// the two products; wgmma with TMA and warp specialisation is later work.
//
// The scalar design (fp32 inputs, whose 2e-5 band TF32 cannot meet, and
// bf16 head dims that are not a multiple of 16, or are 16, where the
// tensor-core tiling spills): fp32 FMAs on the CUDA cores, bounded by
// their 67 TFLOP/s.
//
// * One block of 128 threads per (bh, tile of kBQ = 32 query rows); the
//   heaviest (last) row tiles are launched first.
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
// Head dims 4..128 in multiples of 4; any S, with tail rows and keys masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;
constexpr unsigned kFull = 0xffffffffu;

// The dynamic shared memory of either design.
__device__ __forceinline__ float4* dynamic_smem() {
  extern __shared__ float4 flash_smem[];
  return flash_smem;
}

// ------------------------------------------------------------ PTX helpers
// One instruction each.  A CPU build supplies its own definitions of the
// same names.
#ifdef __CUDACC__
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and register m gets (row lane / 4, columns 2 (lane % 4) + 0, 1)
// of matrix m
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// the same, each matrix transposed: register m gets (rows 2 (lane % 4)
// + 0, 1, column lane / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest even as bf16x2, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
#endif  // __CUDACC__

// ------------------------------------------------- the tensor-core design

constexpr int kMRows = 128;             // query rows per block
constexpr int kMKeys = 64;              // keys per shared-memory tile
constexpr int kMWarps = kMRows / 16;    // one m16 tile of rows a warp
constexpr int kMThreads = 32 * kMWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 16-byte chunks in a shared-memory row of D bf16: D / 8 rounded up to a
// multiple of 8, so the XOR swizzle stays inside the row
__host__ __device__ constexpr int mma_pitch(int d) {
  return (d / 8 + 7) / 8 * 8;
}

__device__ __forceinline__ int swizzle(int row, int chunk) {
  return chunk ^ (row & 7);
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// rows [row0, row0 + kRows) of a [S, kD] bf16 matrix into a swizzled tile,
// rows past S as zeros; one cp.async per 16-byte chunk
template <int kD, int kRows>
__device__ __forceinline__ void load_tile(uint4* tile,
                                          const __nv_bfloat16* src, int row0,
                                          int S, int tid) {
  constexpr int kC = kD / 8, kP = mma_pitch(kD);
#pragma unroll
  for (int e = tid; e < kRows * kC; e += kMThreads) {
    const int r = e / kC, c = e % kC;
    const bool ok = row0 + r < S;
    cp_async_16(tile + r * kP + swizzle(r, c),
                src + static_cast<size_t>(ok ? row0 + r : 0) * kD + c * 8,
                ok);
  }
}

template <int kD>
__global__ void __launch_bounds__(kMThreads)
flash_attention_mma_kernel(const void* q_, const void* k_, const void* v_,
                           void* out_, float* __restrict__ lse, int BH,
                           int S, int D, float scale, int causal) {
  constexpr int kP = mma_pitch(kD);
  constexpr int kKS = kD / 16;        // k steps of Q K^T
  constexpr int kNT = kD / 8;         // 8-column tiles of the output
  constexpr int kST = kMKeys / 8;     // 8-key tiles of S
  uint4* qs = reinterpret_cast<uint4*>(dynamic_smem());  // [kMRows][kP]
  uint4* ks = qs + kMRows * kP;                          // [2][kMKeys][kP]
  uint4* vs = ks + 2 * kMKeys * kP;                      // [2][kMKeys][kP]
  const auto* q = static_cast<const __nv_bfloat16*>(q_);
  const auto* k = static_cast<const __nv_bfloat16*>(k_);
  const auto* v = static_cast<const __nv_bfloat16*>(v_);
  auto* out = static_cast<__nv_bfloat16*>(out_);

  const int nq = (S + kMRows - 1) / kMRows;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t base = static_cast<size_t>(bh) * S * kD;
  const int q0 = qt * kMRows;
  const int row_lo = q0 + 16 * warp;          // the warp's first row
  // causal: keys past the tile's last row are above the diagonal
  const int n_keys = causal ? min(q0 + kMRows, S) : S;
  const int n_tiles = (n_keys + kMKeys - 1) / kMKeys;

  load_tile<kD, kMRows>(qs, q + base, q0, S, tid);
  cp_async_commit();
  load_tile<kD, kMKeys>(ks, k + base, 0, S, tid);
  load_tile<kD, kMKeys>(vs, v + base, 0, S, tid);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; K/V tile 0 may be in flight
  __syncthreads();

  // Q's A fragments: matrix lane / 8 of the x4 is (rows +8 if its bit 0,
  // columns +8 if its bit 1), so lane i points at row i % 16
  uint32_t qf[kKS][4];
#pragma unroll
  for (int s = 0; s < kKS; ++s) {
    const int r = 16 * warp + (lane & 15);
    ldmatrix_x4(qf[s], qs + r * kP + swizzle(r, 2 * s + (lane >> 4)));
  }

  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // per lane: rows g and g + 8 of the warp's 16; m in log2 units, l the
  // lane's partial sum over its own columns
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl = scale * kLog2e;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int stage = kt & 1;
    cp_async_wait<0>();  // tile kt has landed (this thread's copies)
    // every thread's copies are visible, and every warp is done reading
    // the stage that tile kt + 1 is about to overwrite
    __syncthreads();
    if (kt + 1 < n_tiles) {
      load_tile<kD, kMKeys>(ks + (stage ^ 1) * kMKeys * kP, k + base,
                            (kt + 1) * kMKeys, S, tid);
      load_tile<kD, kMKeys>(vs + (stage ^ 1) * kMKeys * kP, v + base,
                            (kt + 1) * kMKeys, S, tid);
      cp_async_commit();
    }
    const int k0 = kt * kMKeys;
    // warp-uniform: past S, or every key of the tile above every row
    if (row_lo >= S || (causal && k0 > row_lo + 15)) continue;
    const uint4* kst = ks + stage * kMKeys * kP;
    const uint4* vst = vs + stage * kMKeys * kP;

    // S = Q K^T: an x4 of K gives the B fragments of two 8-key tiles
    // (matrix bit 0: columns +8; bit 1: keys +8)
    float sc[kST][4];
#pragma unroll
    for (int j = 0; j < kST; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int s = 0; s < kKS; ++s) {
#pragma unroll
      for (int jp = 0; jp < kST / 2; ++jp) {
        const int r = 16 * jp + ((lane >> 4) << 3) + (lane & 7);
        uint32_t kb[4];
        ldmatrix_x4(kb, kst + r * kP + swizzle(r, 2 * s + ((lane >> 3) & 1)));
        mma_bf16(sc[2 * jp], qf[s], kb[0], kb[1]);
        mma_bf16(sc[2 * jp + 1], qf[s], kb[2], kb[3]);
      }
    }

    // online softmax on the C fragments: value i of tile j is row
    // g + 8 (i / 2), key k0 + 8 j + 2 t + i % 2
    const bool masked = k0 + kMKeys > S || (causal && k0 + kMKeys - 1 > row_lo);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kST; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sc[j][i] * sl;
        if (masked) {
          const int key = k0 + 8 * j + 2 * t + (i & 1);
          const int row = row_lo + g + 8 * (i >> 1);
          if (key >= S || (causal && key > row)) x = -INFINITY;
        }
        sc[j][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // a row with no live key yet keeps P = 0 and its zero state
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = exp2f(m[h] - m_use[h]);  // 0 on the first live tile
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < kST; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[j][i] = exp2f(sc[j][i] - m_use[i >> 1]);  // masked: exp2(-inf) = 0
        l[i >> 1] += sc[j][i];
      }
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, 16 keys a step: S tiles 2 kk and 2 kk + 1 are P's A
    // fragment; an x4.trans of V gives the B fragments of two 8-column
    // tiles (matrix bit 0: keys +8; bit 1: columns +8)
#pragma unroll
    for (int kk = 0; kk < kMKeys / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p0 = sc[2 * kk + (a >> 1)][2 * (a & 1)];
        const float p1 = sc[2 * kk + (a >> 1)][2 * (a & 1) + 1];
        hi[a] = pack_bf16x2(p0, p1);
        lo[a] = pack_bf16x2(p0 - bf16_lo(hi[a]), p1 - bf16_hi(hi[a]));
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        const int r = 16 * kk + (((lane >> 3) & 1) << 3) + (lane & 7);
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vst + r * kP + swizzle(r, 2 * np + (lane >> 4)));
        mma_bf16(o[2 * np], hi, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], hi, vb[2], vb[3]);
        mma_bf16(o[2 * np], lo, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], lo, vb[2], vb[3]);
      }
    }
  }

  if (row_lo >= S) return;  // warp-uniform
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    const int row = row_lo + g + 8 * h;
    if (row >= S) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        out + base + static_cast<size_t>(row) * kD + 2 * t);
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      dst[4 * n] = pack_bf16x2(o[n][2 * h] / denom, o[n][2 * h + 1] / denom);
    if (t == 0)
      lse[static_cast<size_t>(bh) * S + row] = m[h] * kLn2 + logf(denom);
  }
}

// ------------------------------------------------------ the scalar design

constexpr int kBQ = 32;                // query rows per block
constexpr int kBK = 32;                // keys per shared-memory tile
constexpr int kTPR = 4;                // lanes per query row
constexpr int kThreads = kBQ * kTPR;   // 128

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
  float* smem = reinterpret_cast<float*>(dynamic_smem());
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

Kernel pick_mma(int d) {
  switch (d) {
#define FA_CASE(N) \
  case N:          \
    return flash_attention_mma_kernel<N>;
    FA_CASE(32) FA_CASE(48) FA_CASE(64) FA_CASE(80)
    FA_CASE(96) FA_CASE(112) FA_CASE(128)
#undef FA_CASE
    default:
      return nullptr;
  }
}

}  // namespace

// The design a call takes: 1 the tensor-core design (bf16, D a multiple of
// 16 from 32), 0 the scalar design, -1 a head dim or dtype the kernel does
// not take.
extern "C" int flash_attention_design(int D, int dtype) {
  if (D < 4 || D > kMaxD || D % 4 != 0 || (dtype != 0 && dtype != 1))
    return -1;
  return dtype == 1 && D % 16 == 0 && D >= 32 ? 1 : 0;
}

// q, k, v, out: [BH, S, D] contiguous, 16-byte aligned; lse: [BH, S] fp32.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int BH, int S, int D, float scale,
                                      int causal, int dtype, void* stream) {
  const int design = flash_attention_design(D, dtype);
  if (BH < 1 || S < 1 || design < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Kernel kernel;
  int threads, rows;
  size_t smem;
  if (design == 1) {
    kernel = pick_mma(D);
    threads = kMThreads;
    rows = kMRows;
    smem = static_cast<size_t>(kMRows + 4 * kMKeys) * mma_pitch(D) * 16;
  } else {
    const int nc = (D / 4 + kTPR - 1) / kTPR;
    kernel = dtype == 0 ? pick<float>(nc) : pick<__nv_bfloat16>(nc);
    threads = kThreads;
    rows = kBQ;
    smem = 2 * kBK * D * sizeof(float);  // <= 32 KB
  }
  if (kernel == nullptr ||
      (long long)BH * ((S + rows - 1) / rows) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {  // 96 KB at D 80..128: 2 blocks an SM
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(BH * ((S + rows - 1) / rows));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<grid, threads, smem, st>>>(
      q, k, v, out, lse, BH, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
