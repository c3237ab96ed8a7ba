// Mamba2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan_pallas (body
// _ssd_kernel).  Same function: for every (batch, head) the sequence is
// cut into chunks of Q tokens.  Within a chunk, with seg = cumsum(dt * a):
//   y = (C B^T * exp(seg_q - seg_k) * [k <= q] * dt_k) x + (C * exp(seg)) S^T
//   S <- S * exp(seg_last) + x^T (B * exp(seg_last - seg) * dt)
// The state S [P, N] is fp32 and starts at zero; groups of B and C
// broadcast to heads by h / (H / G).  y is accumulated in fp32 and rounded
// once to x's dtype; the final state is written in fp32.
//
// Bound on the H100: bytes.  At the training call (x [4, 2048, 80, 64]
// bf16, chunk 256, N 128) the call must move about 185 MB (x and y 84 MB
// each, dt, B, C and the final state) and do about 2.4e10 useful flops
// (C B^T shared by the heads of a group), so it sits below the card's ~295
// flops per byte.  Two designs, chosen up front by dtype and shape
// (ssd_scan_design):
//
// The chunk-parallel tensor-core design (bf16, P and N multiples of 16 up
// to 128, a chunk that is a multiple of 64 up to 256: every arch's call).
// Read for its work, a chunk is a causal linear attention (C the queries,
// B the keys, x the values, exp(seg_q - seg_k) dt_k the score transform)
// plus a recurrence across chunks that is a [P, N] multiply-add a chunk;
// only that recurrence is sequential.  Four kernels, launched in order on
// the caller's stream, share a workspace the caller allocates (carve).
//
// It rounds y as the plain version does.  The plain version's fp32 sums
// are FMA chains in index order, and a bf16 y one step off theirs in a
// small share of values moves the model's bf16 gradients by more than the
// training parity of chip_smoke.py holds (even the exact scan does), so:
// C B^T is that chain; an fp32 operand of a product goes through as three
// bf16 parts (kParts), whose sum is the value, so the tensor cores' products
// are exact; their sums start from zero every 16 keys and are added in
// fp32; beside y the kernel sums |terms|, and a y value within kFlagScale
// of that sum of a bf16 rounding midpoint is recomputed in the plain
// version's order (ssd_plain_value).  seg is summed in the plain version's
// order and the decays are expf of its differences, as there.  Tiles of
// 64 rows of 16-byte chunks are staged by cp.async.cg in a 2-stage ring in
// shared memory, chunk c of row r stored at c ^ (r & 7) so every ldmatrix
// is free of bank conflicts.
//
// 1. ssd_scan_chunk_state_kernel, one 8-warp block per (batch, chunk,
//    head): seg = cumsum(dt a), one thread's running sum, written out; w =
//    exp(seg_last - seg) dt; the chunk's own state x^T (B w) [P, N], 64 keys
//    a tile, x the A operand by ldmatrix.trans, B's fragments by
//    ldmatrix.trans, scaled by w and split in registers once for the warp's
//    pieces of the state that share their columns.  Then its share of the
//    group's C B^T rows (heads split the rows), on the CUDA cores: once a
//    group, not once a head.
// 2. ssd_scan_state_pass_kernel, one thread per (batch, head, p, n): walks
//    the chunks, carries S <- S exp(seg_last) + own in fp32 and writes each
//    chunk's incoming state as three parts; the last carry is the final
//    state.  No block waits on another.
// 3. ssd_scan_chunk_scan_kernel, one 4-warp block per (batch, chunk,
//    64-row query tile, block of E heads of one group), heaviest tiles
//    first; a warp owns 16 query rows.  C's A fragments stay in registers
//    and the tile's C B^T in shared memory, in the accumulators' own layout
//    (each lane reads back what it wrote), for the E heads.  Per head:
//    exp(seg_q) C S_in^T, S_in's parts streaming through the ring; then
//    M x over the key tiles, M = C B^T exp(seg_q - seg_k) dt_k built in
//    registers (zero past the diagonal, where the decay is never taken)
//    and split in three, x by ldmatrix.trans.  y is rounded once; the
//    values near a midpoint are listed for pass 4, by a prefix sum over
//    the warp's lanes.  E is the largest of 8..1 dividing H / G whose grid
//    still has kFillBlocks blocks (8 at the training call, 2 at one
//    request's 512-token prefill), at least 2 wherever a group has 2 heads.
// 4. ssd_scan_fixup_kernel, one block per (batch, chunk, head) with listed
//    values: the head's x, seg and dt of the chunk staged in shared
//    memory, a thread per listed value computes its plain-order y.
//
// The design is bounded by latency: 4 warps a block and 2 blocks an SM
// (C B^T's 64 KB of shared memory at chunk 256), and each head's S_in read
// again by every query tile of its chunk.  wgmma with TMA, and a block
// that covers a whole chunk, are later work.
//
// The scalar design (f32, and bf16 shapes outside the above): scalar fp32
// FMAs on the CUDA cores, C B^T recomputed for every head.
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

// The dynamic shared memory of every kernel in this file.
__device__ __forceinline__ float4* dynamic_smem() {
  extern __shared__ float4 ssd_smem[];
  return ssd_smem;
}

// ------------------------------------------------------------ PTX helpers
// One instruction each, as in flash_attention.cu.  A CPU build supplies
// its own definitions of the same names.
#ifdef __CUDACC__
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously
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

// ------------------------------------------- the chunk-parallel design

constexpr int kTile = 64;               // keys, or query rows, a tile
constexpr int kMaxChunk = 256;
constexpr int kStateThreads = 256;      // pass 1: 8 warps
constexpr int kStateWarps = kStateThreads / 32;
constexpr int kStateStages = 2;         // pass 1's ring
constexpr int kPassThreads = 256;       // pass 2
constexpr int kScanWarps = kTile / 16;  // pass 3: a warp per 16 query rows
constexpr int kScanThreads = 32 * kScanWarps;
constexpr int kFixThreads = 128;        // pass 4
constexpr int kMaxHeads = 8;            // heads a pass-3 block
constexpr long long kFillBlocks = 2 * 132;  // two blocks on each SM
// bf16 parts of an fp32 operand: with three, their sum is the value
constexpr int kParts = 3;
// a y value within kFlagScale * sum |terms| of a bf16 rounding midpoint
// is recomputed in the plain version's order (pass 4); a build may set
// another scale (the CPU tests set one that takes every value)
#ifndef SSD_FLAG_SCALE
#define SSD_FLAG_SCALE (1.f / (1 << 19))
#endif
constexpr float kFlagScale = SSD_FLAG_SCALE;

// 16-byte chunks in a shared-memory row of d bf16: d / 8 rounded up to a
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

// v0, v1 as kParts bf16x2 parts, each the rounding of what the parts
// before it leave: three parts hold all 24 bits of an fp32 value
__device__ __forceinline__ void split_bf16x2(float v0, float v1,
                                             uint32_t (&part)[kParts]) {
#pragma unroll
  for (int i = 0; i < kParts; ++i) {
    part[i] = pack_bf16x2(v0, v1);
    v0 -= bf16_lo(part[i]);
    v1 -= bf16_hi(part[i]);
  }
}

// sum_n c_n b_n over `chunks` 16-byte chunks of bf16, n in order, one FMA
// each from zero: the plain version's fp32 product, bit for bit
__device__ __forceinline__ float dot_chain(const uint4* c, const uint4* b,
                                           int chunks) {
  float acc = 0.f;
  for (int i = 0; i < chunks; ++i) {
    const uint4 cv = c[i], bv = b[i];
    const uint32_t cw[4] = {cv.x, cv.y, cv.z, cv.w};
    const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc = fmaf(bf16_lo(cw[j]), bf16_lo(bw[j]), acc);
      acc = fmaf(bf16_hi(cw[j]), bf16_hi(bw[j]), acc);
    }
  }
  return acc;
}

// `rows` rows of `chunks` 16-byte chunks each, row r at src + r * stride,
// into a swizzled tile of row pitch `pitch`; one cp.async per chunk.
// Thread tid copies chunks tid, tid + threads, ... in row-major order,
// stepping its (row, chunk) without a division per chunk.
__device__ __forceinline__ void load_rows(uint4* tile, int pitch,
                                          const __nv_bfloat16* src,
                                          size_t stride, int chunks, int tid,
                                          int threads, int rows = kTile) {
  const int dr = threads / chunks, dc = threads - dr * chunks;
  int r = tid / chunks, c = tid - r * chunks;
  while (r < rows) {
    cp_async_16(tile + r * pitch + swizzle(r, c), src + r * stride + c * 8,
                true);
    r += dr;
    c += dc;
    if (c >= chunks) {
      c -= chunks;
      ++r;
    }
  }
}

// The workspace, carved from the caller's fp32 buffer (see
// ssd_scan_workspace_floats): each chunk's own state [B, nc, H, P, N]
// fp32; its incoming state as kParts bf16 parts [B, nc, H, kParts, P, N];
// seg [B, nc, H, Q]; C B^T [B, nc, G, Q, Q] (keys up to the diagonal);
// and the y values pass 3 hands to pass 4: a count for every 16 query
// rows of a head (a region) and up to fix_cap(P) entries each.
struct Workspace {
  float* state;
  __nv_bfloat16* in;
  float* seg;
  float* cb;
  int* fix_count;
  uint32_t* fix_list;
};

__host__ __device__ inline Workspace carve(float* ws, int B, int S, int H,
                                           int P, int G, int N, int Q) {
  const size_t states = static_cast<size_t>(B) * (S / Q) * H * P * N;
  const size_t tokens = static_cast<size_t>(B) * S;
  Workspace w;
  w.state = ws;
  w.in = reinterpret_cast<__nv_bfloat16*>(ws + states);
  w.seg = ws + states + (kParts * states + 1) / 2;
  w.cb = w.seg + tokens * H;
  w.fix_count = reinterpret_cast<int*>(w.cb + tokens * G * Q);
  w.fix_list = reinterpret_cast<uint32_t*>(w.fix_count + tokens * H / 16);
  return w;
}

// Entries a region may hand to pass 4 (1/8 of its values); past them
// pass 3 recomputes a value itself.  (The CPU tests build with every
// value sent one way and then the other.)
#ifndef SSD_FIX_CAP
#define SSD_FIX_CAP(P) (2 * (P))
#endif
__host__ __device__ constexpr int fix_cap(int P) { return SSD_FIX_CAP(P); }

// y at one (batch b, chunk c, head h, chunk row q, column p) as the plain
// version computes it: the intra-chunk sum over keys 0..q in order, one
// FMA each, of M = C B^T exp(seg_q - seg_k) dt_k (two roundings, as
// there) times x; the inter-chunk sum over n of (C exp(seg_q)) S_in; their
// sum.  C B^T comes from pass 1 and S_in from pass 2; x of the head's
// chunk (key k at xk + k * xs), its seg and dt ([Q] each) from wherever
// the caller holds them.  Operands are loaded 8 keys (or n) ahead of the
// FMAs that take them, in the same order.
__device__ float ssd_plain_value(const __nv_bfloat16* __restrict__ xk,
                                 size_t xs, const float* __restrict__ seg,
                                 const float* __restrict__ dtk,
                                 const __nv_bfloat16* __restrict__ cm,
                                 const Workspace& w, int b, int c, int h,
                                 int q, int p, int S, int H, int P, int G,
                                 int N, int Q) {
  const int nc = S / Q, grp = h / (H / G);
  const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const size_t slot = (static_cast<size_t>(b) * nc + c) * H + h;
  const float* cbr =
      w.cb + (((static_cast<size_t>(b) * nc + c) * G + grp) * Q + q) * Q;
  const float sq = seg[q];
  float intra = 0.f;
  for (int k0 = 0; k0 <= q; k0 += 8) {
    const float4 u = *reinterpret_cast<const float4*>(cbr + k0);
    const float4 v = *reinterpret_cast<const float4*>(cbr + k0 + 4);
    const float cv[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
    float m[8], xv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool in = k0 + i <= q;  // keys past the row: nothing read
      m[i] = in ? cv[i] * expf(sq - seg[k0 + i]) * dtk[k0 + i] : 0.f;
      xv[i] = in ? __bfloat162float(xk[(k0 + i) * xs]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (k0 + i <= q) intra = fmaf(m[i], xv[i], intra);
  }
  float inter = 0.f;
  if (c > 0) {
    const float e = expf(sq);
    const uint4* crow = reinterpret_cast<const uint4*>(
        cm + (t0 + q) * G * N + static_cast<size_t>(grp) * N);
    const size_t pn = static_cast<size_t>(P) * N;
    const uint4* s0 = reinterpret_cast<const uint4*>(
        w.in + slot * kParts * pn + static_cast<size_t>(p) * N);
    for (int n8 = 0; n8 < N / 8; ++n8) {
      const uint4 cu = crow[n8];
      uint4 su[kParts];
#pragma unroll
      for (int i = 0; i < kParts; ++i) su[i] = s0[i * pn / 8 + n8];
      const uint32_t cw[4] = {cu.x, cu.y, cu.z, cu.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = j / 2;
        float sv = 0.f;
#pragma unroll
        for (int i = 0; i < kParts; ++i) {
          const uint32_t wd[4] = {su[i].x, su[i].y, su[i].z, su[i].w};
          const float part = j % 2 ? bf16_hi(wd[r]) : bf16_lo(wd[r]);
          sv = i == 0 ? part : sv + part;
        }
        const float cn = (j % 2 ? bf16_hi(cw[r]) : bf16_lo(cw[r])) * e;
        inter = fmaf(cn, sv, inter);
      }
    }
  }
  return intra + inter;
}

// Pass 1.  kPT and kNS: P / 16 and N / 16 at most (4 or 8 each).
template <int kPT, int kNS>
__global__ void __launch_bounds__(kStateThreads, kPT * kNS <= 32 ? 2 : 1)
ssd_scan_chunk_state_kernel(const __nv_bfloat16* __restrict__ x,
                            const float* __restrict__ dt,
                            const float* __restrict__ a,
                            const __nv_bfloat16* __restrict__ bm,
                            const __nv_bfloat16* __restrict__ cm,
                            Workspace w, int S, int H, int P, int G, int N,
                            int Q) {
  // pieces of 16 p rows by 32 n columns a warp
  constexpr int kIt = (kPT * kNS / 2 + kStateWarps - 1) / kStateWarps;
  const int pP = mma_pitch(P), pN = mma_pitch(N);
  const int n_tiles = Q / kTile;
  // a ring of kStateStages key tiles of x and B
  uint4* xs = reinterpret_cast<uint4*>(dynamic_smem());  // [.][kTile][pP]
  uint4* bs = xs + kStateStages * kTile * pP;            // [.][kTile][pN]
  float* seg = reinterpret_cast<float*>(bs + kStateStages * kTile * pN);
  float* wk = seg + Q;                                   // [Q]

  const int nc = S / Q;
  const int h = static_cast<int>(blockIdx.x) % H;
  const int bc = static_cast<int>(blockIdx.x) / H;       // b * nc + c
  const int b = bc / nc, c = bc % nc, grp = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const size_t xstride = static_cast<size_t>(H) * P;
  const size_t bstride = static_cast<size_t>(G) * N;
  const __nv_bfloat16* xb = x + t0 * xstride + static_cast<size_t>(h) * P;
  const __nv_bfloat16* bb = bm + t0 * bstride + static_cast<size_t>(grp) * N;

  auto load_tile = [&](int kt) {
    if (kt >= n_tiles) return;
    const int st = kt % kStateStages;
    const size_t row = static_cast<size_t>(kt) * kTile;
    load_rows(xs + st * kTile * pP, pP, xb + row * xstride, xstride, P / 8,
              tid, kStateThreads);
    load_rows(bs + st * kTile * pN, pN, bb + row * bstride, bstride, N / 8,
              tid, kStateThreads);
  };
  // the first tiles in flight during the scan, a commit group each
  for (int kt = 0; kt < kStateStages - 1; ++kt) {
    load_tile(kt);
    cp_async_commit();
  }

  // seg = cumsum(dt a): dt a a token a thread (Q <= kStateThreads), then
  // one thread's running sum in the plain version's order
  const float dtv = tid < Q ? dt[(t0 + tid) * H + h] : 0.f;
  if (tid < Q) seg[tid] = dtv * a[h];
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < Q; ++i) seg[i] = run += seg[i];
  }
  __syncthreads();
  if (tid < Q) {
    w.seg[(static_cast<size_t>(bc) * H + h) * Q + tid] = seg[tid];
    wk[tid] = expf(seg[Q - 1] - seg[tid]) * dtv;
  }
  // (the ring's first barrier orders wk before any read)

  const int n_groups = (N + 31) / 32;        // 32-column groups of n
  const int n_items = (P / 16) * n_groups;
  float acc[kIt][4][4];
#pragma unroll
  for (int it = 0; it < kIt; ++it)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[it][j][0] = acc[it][j][1] = acc[it][j][2] = acc[it][j][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kStateStages - 2>();  // tile kt has landed
    // every thread's copies are visible, and every warp is done with the
    // stage that tile kt + kStateStages - 1 is about to overwrite
    __syncthreads();
    load_tile(kt + kStateStages - 1);
    cp_async_commit();
    const uint4* xt = xs + (kt % kStateStages) * kTile * pP;
    const uint4* bt = bs + (kt % kStateStages) * kTile * pN;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      // this lane's keys in the B fragments: 2t, 2t + 1, and 8 more
      const int key = kt * kTile + 16 * kk + 2 * t;
      const float w0 = wk[key], w1 = wk[key + 1];
      const float w8 = wk[key + 8], w9 = wk[key + 9];
      // B w's parts of the item's column group, split once for the
      // warp's items that share the group
      uint32_t bw[2][4][kParts];
      int split_ng = -1;
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int item = warp + kStateWarps * it;
        if (item >= n_items) continue;  // warp-uniform
        const int mt = item / n_groups, ng = item % n_groups;
        if (ng != split_ng) {
          split_ng = ng;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const int n8 = 4 * ng + 2 * np;  // first 8-column tile of a pair
            if (8 * n8 >= N) continue;       // warp-uniform
            // B: matrix bit 0 is key + 8, bit 1 the next 8 columns
            const int r = 16 * kk + (((lane >> 3) & 1) << 3) + (lane & 7);
            uint32_t vb[4];
            ldmatrix_x4_trans(vb,
                              bt + r * pN + swizzle(r, n8 + (lane >> 4)));
#pragma unroll
            for (int m = 0; m < 4; ++m)
              split_bf16x2(bf16_lo(vb[m]) * (m & 1 ? w8 : w0),
                           bf16_hi(vb[m]) * (m & 1 ? w9 : w1), bw[np][m]);
          }
        }
        // A = x^T: matrix bit 0 is p + 8, bit 1 key + 8
        uint32_t af[4];
        {
          const int r = 16 * kk + ((lane >> 4) << 3) + (lane & 7);
          ldmatrix_x4_trans(af, xt + r * pP +
                                    swizzle(r, 2 * mt + ((lane >> 3) & 1)));
        }
        // these 16 keys' sum from zero, the smallest part first, then
        // added to the state in fp32 (the tensor cores' own sums would
        // drift from the plain version's over many steps)
        float step[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          step[j][0] = step[j][1] = step[j][2] = step[j][3] = 0.f;
#pragma unroll
        for (int i = kParts - 1; i >= 0; --i)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            if (8 * (4 * ng + 2 * np) >= N) continue;
            mma_bf16(step[2 * np], af, bw[np][0][i], bw[np][1][i]);
            mma_bf16(step[2 * np + 1], af, bw[np][2][i], bw[np][3][i]);
          }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[it][j][v] += step[j][v];
      }
    }
  }

  // value i of tile j: p row 16 mt + g + 8 (i / 2), n 8 n8 + 2 t + i % 2
  float* out = w.state + (static_cast<size_t>(bc) * H + h) * P * N;
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int item = warp + kStateWarps * it;
    if (item >= n_items) continue;
    const int mt = item / n_groups, ng = item % n_groups;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 8 * (4 * ng + j) + 2 * t;
      if (n >= N) continue;
      float* row = out + static_cast<size_t>(16 * mt + g) * N + n;
      *reinterpret_cast<float2*>(row) = make_float2(acc[it][j][0],
                                                    acc[it][j][1]);
      *reinterpret_cast<float2*>(row + 8 * N) = make_float2(acc[it][j][2],
                                                            acc[it][j][3]);
    }
  }

  // C B^T of the group, once: this head's share of its rows (hl, hl + hg,
  // ... of the chunk), keys up to the diagonal, each the plain version's
  // chain (dot_chain) from the bf16 rows in device memory
  const int hg = H / G;
  const uint4* cq = reinterpret_cast<const uint4*>(
      cm + t0 * bstride + static_cast<size_t>(grp) * N);
  const uint4* bq = reinterpret_cast<const uint4*>(bb);
  const size_t rs = bstride / 8;  // 16-byte chunks a token
  float* cbo = w.cb + (static_cast<size_t>(bc) * G + grp) * Q * Q;
  for (int q = h % hg; q < Q; q += hg)
    for (int k = tid; k <= q; k += kStateThreads)
      cbo[static_cast<size_t>(q) * Q + k] =
          dot_chain(cq + q * rs, bq + k * rs, N / 8);
}

// Pass 2: the recurrence across chunks in the plain version's order (a
// product, then a sum), the chunks' own states read ahead four at a time;
// each chunk's incoming state is written as kParts bf16 parts for pass
// 3's tensor cores.  PN = P * N.
__global__ void __launch_bounds__(kPassThreads)
ssd_scan_state_pass_kernel(Workspace w, float* __restrict__ fin, int B,
                           int H, int PN, int nc, int Q) {
  const size_t e =
      static_cast<size_t>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (e >= static_cast<size_t>(B) * H * PN) return;
  const size_t bh = e / PN, pn = e % PN;
  const size_t b = bh / H, h = bh % H;
  float carry = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float own[4], decay[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j >= nc) continue;
      const size_t slot = (b * nc + c0 + j) * H + h;
      own[j] = w.state[slot * PN + pn];
      decay[j] = expf(w.seg[slot * Q + Q - 1]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j >= nc) continue;
      const size_t slot = (b * nc + c0 + j) * H + h;
      float rest = carry;
#pragma unroll
      for (int i = 0; i < kParts; ++i) {
        const __nv_bfloat16 part = __float2bfloat16(rest);
        w.in[(kParts * slot + i) * PN + pn] = part;
        rest -= __bfloat162float(part);
      }
      carry = __fadd_rn(__fmul_rn(carry, decay[j]), own[j]);
    }
  }
  fin[e] = carry;
}

// Pass 3.  kPT and kNS as in pass 1.  Everything the block reads after C
// and C B^T streams through one 2-stage ring of kTile rows of max(pP, pN)
// chunks, as items: per head S_in's parts (the smallest first) in parts of
// up to kTile p rows, and x's key tiles.
template <int kPT, int kNS>
__global__ void __launch_bounds__(kScanThreads)
ssd_scan_chunk_scan_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ dt,
                           const __nv_bfloat16* __restrict__ cm,
                           __nv_bfloat16* __restrict__ y, Workspace w,
                           int B, int S, int H, int P, int G, int N, int Q,
                           int E) {
  const int pP = mma_pitch(P), pN = mma_pitch(N), pS = max(pP, pN);
  const int nc = S / Q, nqt = Q / kTile, hg = H / G, nhb = hg / E;
  // C B^T: [nqt][kScanWarps][8 tiles of 8 keys][32 lanes], a float4 each
  float4* cbs = dynamic_smem();
  uint4* ring = reinterpret_cast<uint4*>(cbs + nqt * kScanWarps * 8 * 32);
  const int stage_chunks = kTile * pS;
  // seg and dt of the block's heads
  float* segs = reinterpret_cast<float*>(ring + 2 * stage_chunks);
  float* dts = segs + E * Q;  // [E][Q] each

  const int per_tile = B * nc * G * nhb;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x) / per_tile;
  int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int hb = rest % nhb;
  rest /= nhb;
  const int grp = rest % G;
  rest /= G;
  const int c = rest % nc, b = rest / nc;
  const int h0 = grp * hg + hb * E;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_keys = (qt + 1) * kTile;  // the keys up to the diagonal
  const int row0 = qt * kTile + 16 * warp + g;  // chunk rows row0, row0 + 8
  const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const size_t xstride = static_cast<size_t>(H) * P;
  const size_t bstride = static_cast<size_t>(G) * N;
  const __nv_bfloat16* cq = cm + t0 * bstride + static_cast<size_t>(grp) * N;
  const size_t slot0 = static_cast<size_t>(b * nc + c) * H;

  // the items: per head n_s parts of S_in (kTile p rows each) and the
  // qt + 1 key tiles of x
  const int n_sp = (P + kTile - 1) / kTile;
  const int n_s = c > 0 ? kParts * n_sp : 0;  // chunk 0 starts from zero
  const int per_head = n_s + qt + 1;
  const int n_items = E * per_head;
  auto load_item = [&](int i) {
    if (i >= n_items) return;
    uint4* dst = ring + (i & 1) * stage_chunks;
    const int r = i % per_head;
    const size_t h = h0 + i / per_head;
    if (r < n_s) {
      const int part = kParts - 1 - r / n_sp, sp = r % n_sp;
      load_rows(dst, pN,
                w.in + ((kParts * (slot0 + h) + part) * P +
                        static_cast<size_t>(sp) * kTile) * N,
                N, N / 8, tid, kScanThreads, min(kTile, P - sp * kTile));
    } else {
      load_rows(dst, pP,
                x + (t0 + static_cast<size_t>(r - n_s) * kTile) * xstride +
                    h * P,
                xstride, P / 8, tid, kScanThreads);
    }
  };

  // C's query tile goes where C B^T will be (free until then); then the
  // first item
  uint4* cs = reinterpret_cast<uint4*>(cbs);
  load_rows(cs, pN, cq + static_cast<size_t>(qt) * kTile * bstride, bstride,
            N / 8, tid, kScanThreads);
  cp_async_commit();
  load_item(0);
  cp_async_commit();
  for (int i = tid; i < E * n_keys; i += kScanThreads) {
    const int e = i / n_keys, k = i % n_keys;
    segs[e * Q + k] = w.seg[(slot0 + h0 + e) * Q + k];
    dts[e * Q + k] = dt[(t0 + k) * H + h0 + e];
  }
  cp_async_wait<1>();  // C has landed; item 0 may be in flight
  __syncthreads();

  // C's A fragments: matrix bit 0 is row + 8, bit 1 column + 8
  uint32_t cf[kNS][4];
#pragma unroll
  for (int s = 0; s < kNS; ++s) {
    if (16 * s >= N) continue;
    const int r = 16 * warp + (lane & 15);
    ldmatrix_x4(cf[s], cs + r * pN + swizzle(r, 2 * s + (lane >> 4)));
  }
  __syncthreads();  // every warp has C before C B^T overwrites it

  // C B^T from pass 1 for the warp's 16 rows, in the accumulators' layout:
  // each lane writes, and later reads back, its own values (keys past a
  // row hold whatever the workspace held; M is zero there)
  const float* cbw =
      w.cb + ((static_cast<size_t>(b) * nc + c) * G + grp) * Q * Q;
  for (int kt = 0; kt <= qt; ++kt)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* r0 =
          cbw + static_cast<size_t>(row0) * Q + kt * kTile + 8 * j + 2 * t;
      const float2 u = *reinterpret_cast<const float2*>(r0);
      const float2 v = *reinterpret_cast<const float2*>(r0 + 8 * Q);
      cbs[((kt * kScanWarps + warp) * 8 + j) * 32 + lane] =
          make_float4(u.x, u.y, v.x, v.y);
    }

  // Each item: wait for it, then put the next in flight, into the stage
  // the item before used; the barrier also means every warp is done with
  // that stage.  Per head: exp(seg_q) C S_in^T from S_in's parts (p by n:
  // their rows give B fragments), then M x over key tiles 0..qt; beside
  // y, the same sums of |terms| from the first parts: the scale that
  // bounds how far y may be from the plain version's sums.
  float yacc[2 * kPT][4], aacc[2 * kPT][4];
  const int cap = fix_cap(P);  // pass-4 entries a region
  for (int i = 0; i < n_items; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    load_item(i + 1);
    cp_async_commit();
    const uint4* tile = ring + (i & 1) * stage_chunks;
    const int e = i / per_head, r = i % per_head;
    const int h = h0 + e;
    const float* seg = segs + e * Q;
    const float* dtk = dts + e * Q;
    if (r == 0) {
#pragma unroll
      for (int j = 0; j < 2 * kPT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) yacc[j][v] = aacc[j][v] = 0.f;
    }
    if (r < n_s) {
      const int p0 = (r % n_sp) * kTile;  // the part's first p row
      const bool first = r / n_sp == kParts - 1;  // S_in's first part
#pragma unroll
      for (int s = 0; s < kNS; ++s) {
        if (16 * s >= N) continue;
#pragma unroll
        for (int jp = 0; jp < kPT; ++jp) {  // y's p columns 16 jp..
          if (16 * jp < p0 || 16 * jp >= min(p0 + kTile, P)) continue;
          const int row = 16 * jp - p0 + ((lane >> 4) << 3) + (lane & 7);
          uint32_t kb[4];
          ldmatrix_x4(kb, tile + row * pN +
                              swizzle(row, 2 * s + ((lane >> 3) & 1)));
          mma_bf16(yacc[2 * jp], cf[s], kb[0], kb[1]);
          mma_bf16(yacc[2 * jp + 1], cf[s], kb[2], kb[3]);
          if (first) {
            const uint32_t ca[4] = {cf[s][0] & 0x7fff7fffu,
                                    cf[s][1] & 0x7fff7fffu,
                                    cf[s][2] & 0x7fff7fffu,
                                    cf[s][3] & 0x7fff7fffu};
            mma_bf16(aacc[2 * jp], ca, kb[0] & 0x7fff7fffu,
                     kb[1] & 0x7fff7fffu);
            mma_bf16(aacc[2 * jp + 1], ca, kb[2] & 0x7fff7fffu,
                     kb[3] & 0x7fff7fffu);
          }
        }
      }
      if (r == n_s - 1) {
        const float e0 = expf(seg[row0]), e1 = expf(seg[row0 + 8]);
#pragma unroll
        for (int j = 0; j < 2 * kPT; ++j) {
          yacc[j][0] *= e0;
          yacc[j][1] *= e0;
          yacc[j][2] *= e1;
          yacc[j][3] *= e1;
          aacc[j][0] *= e0;
          aacc[j][1] *= e0;
          aacc[j][2] *= e1;
          aacc[j][3] *= e1;
        }
      }
      continue;
    }
    const int kt = r - n_s;

    // M x over this key tile, 16 keys a step: C B^T tiles 2 kk and
    // 2 kk + 1 give M's A fragment; x (key by p) by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      if (kt == qt && kk > warp) continue;  // above the diagonal
      // M's A fragment: register m is row row0 + 8 (m % 2) and keys
      // 2t, 2t + 1 of C B^T tile 2 kk + m / 2; the decay's exponent is
      // never positive where k <= q, and M is zero past the diagonal
      const float4 c0 =
          cbs[((kt * kScanWarps + warp) * 8 + 2 * kk) * 32 + lane];
      const float4 c1 =
          cbs[((kt * kScanWarps + warp) * 8 + 2 * kk + 1) * 32 + lane];
      const int k0 = kt * kTile + 16 * kk + 2 * t;  // keys k0, +1, +8, +9
      const float sq[2] = {seg[row0], seg[row0 + 8]};
      const float sk[4] = {seg[k0], seg[k0 + 1], seg[k0 + 8], seg[k0 + 9]};
      const float dk[4] = {dtk[k0], dtk[k0 + 1], dtk[k0 + 8], dtk[k0 + 9]};
      const float cv[4][2] = {{c0.x, c0.y}, {c0.z, c0.w},
                              {c1.x, c1.y}, {c1.z, c1.w}};
      uint32_t mp[4][kParts], ma[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float mv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int kj = 2 * (m >> 1) + u;  // which of the four keys
          const bool past = kt == qt &&
                            k0 + 8 * (m >> 1) + u > row0 + 8 * (m & 1);
          mv[u] = past ? 0.f : cv[m][u] * expf(sq[m & 1] - sk[kj]) * dk[kj];
        }
        split_bf16x2(mv[0], mv[1], mp[m]);
        ma[m] = mp[m][0] & 0x7fff7fffu;  // |first part|
      }
      // x's fragments, then the step's sum from zero for all p columns,
      // the smallest part first and part by part (so no product waits on
      // the one before it), added to y in fp32
      uint32_t vb[kPT][4];
#pragma unroll
      for (int np = 0; np < kPT; ++np) {
        if (16 * np >= P) continue;
        const int row = 16 * kk + (((lane >> 3) & 1) << 3) + (lane & 7);
        ldmatrix_x4_trans(vb[np], tile + row * pP +
                                      swizzle(row, 2 * np + (lane >> 4)));
      }
      float step[2 * kPT][4];
#pragma unroll
      for (int j = 0; j < 2 * kPT; ++j)
        step[j][0] = step[j][1] = step[j][2] = step[j][3] = 0.f;
#pragma unroll
      for (int i = kParts - 1; i >= 0; --i) {
        const uint32_t a[4] = {mp[0][i], mp[1][i], mp[2][i], mp[3][i]};
#pragma unroll
        for (int np = 0; np < kPT; ++np) {
          if (16 * np >= P) continue;
          mma_bf16(step[2 * np], a, vb[np][0], vb[np][1]);
          mma_bf16(step[2 * np + 1], a, vb[np][2], vb[np][3]);
        }
      }
#pragma unroll
      for (int np = 0; np < kPT; ++np) {
        if (16 * np >= P) continue;
        mma_bf16(aacc[2 * np], ma, vb[np][0] & 0x7fff7fffu,
                 vb[np][1] & 0x7fff7fffu);
        mma_bf16(aacc[2 * np + 1], ma, vb[np][2] & 0x7fff7fffu,
                 vb[np][3] & 0x7fff7fffu);
      }
#pragma unroll
      for (int j = 0; j < 2 * kPT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) yacc[j][v] += step[j][v];
    }

    if (kt == qt) {  // the head's last key tile: y, rounded once
      __nv_bfloat16* yrow = y + (t0 + row0) * xstride +
                            static_cast<size_t>(h) * P + 2 * t;
      uint64_t near = 0;  // bit 4 j + v: value v of tile j
#pragma unroll
      for (int j = 0; j < 2 * kPT; ++j) {
        if (8 * j >= P) continue;
        *reinterpret_cast<uint32_t*>(yrow + 8 * j) =
            pack_bf16x2(yacc[j][0], yacc[j][1]);
        *reinterpret_cast<uint32_t*>(yrow + 8 * xstride + 8 * j) =
            pack_bf16x2(yacc[j][2], yacc[j][3]);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float mid = __uint_as_float(
              (__float_as_uint(yacc[j][v]) & 0xffff0000u) | 0x8000u);
          if (fabsf(yacc[j][v] - mid) <= kFlagScale * aacc[j][v])
            near |= 1ull << (4 * j + v);
        }
      }
      // the warp's values near a midpoint go to pass 4 as entries of
      // this region (the warp's 16 rows of head h), row << 7 | p, at
      // slots from a prefix sum over the lanes; past the region's cap a
      // lane computes its own (rare)
      const int mine = __popcll(near);
      int incl = mine;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = static_cast<int>(__shfl_sync(
            0xffffffffu, static_cast<float>(incl), (lane - o) & 31));
        if (lane >= o) incl += v;
      }
      const int total = static_cast<int>(
          __shfl_sync(0xffffffffu, static_cast<float>(incl), 31));
      const size_t region =
          ((((static_cast<size_t>(b) * nc + c) * nqt + qt) * H + h) *
               kScanWarps + warp);
      if (lane == 0) w.fix_count[region] = min(total, cap);
      int slot = incl - mine;
      while (near) {
        const int bit = __ffsll(near) - 1;
        near &= near - 1;
        const int j = bit / 4, v = bit % 4;
        const int row = g + 8 * (v / 2), p = 8 * j + 2 * t + v % 2;
        if (slot < cap) {
          w.fix_list[region * cap + slot] = (row << 7) | p;
        } else {
          const int q = row0 - g + row;
          const size_t col = static_cast<size_t>(h) * P + p;
          y[(t0 + q) * xstride + col] = __float2bfloat16(ssd_plain_value(
              x + t0 * xstride + col, xstride, seg, dtk, cm, w, b, c, h, q,
              p, S, H, P, G, N, Q));
        }
        ++slot;
      }
    }
  }
}

// Pass 4: the y values pass 3 found near a bf16 rounding midpoint, each
// recomputed in the plain version's order (ssd_plain_value), so that y
// rounds as the plain version's does.  One block per (batch, chunk,
// head): the entries of its 4 Q / kTile regions, with the head's x, seg
// and dt of the chunk staged in shared memory once (none where the
// chunk has no entries).
__global__ void __launch_bounds__(kFixThreads)
ssd_scan_fixup_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ dt,
                      const __nv_bfloat16* __restrict__ cm,
                      __nv_bfloat16* __restrict__ y, Workspace w, int S,
                      int H, int P, int G, int N, int Q) {
  const int cap = fix_cap(P), nc = S / Q, nqt = Q / kTile;
  const int n_reg = nqt * kScanWarps;  // at most 16
  uint4* xs = reinterpret_cast<uint4*>(dynamic_smem());   // [Q][P / 8]
  float* seg = reinterpret_cast<float*>(xs + Q * (P / 8));  // [Q]
  float* dts = seg + Q;                                   // [Q]
  int* first = reinterpret_cast<int*>(dts + Q);  // [n_reg + 1]
  const int h = static_cast<int>(blockIdx.x) % H;
  const int bc = static_cast<int>(blockIdx.x) / H;
  const int b = bc / nc, c = bc % nc;
  const int tid = threadIdx.x;
  // region (qt, warp) of this head: ((bc * nqt + qt) * H + h) * 4 + warp
  auto region = [&](int r) {
    return ((static_cast<size_t>(bc) * nqt + r / kScanWarps) * H + h) *
               kScanWarps + r % kScanWarps;
  };
  if (tid == 0) {
    int total = 0;
    for (int r = 0; r < n_reg; ++r) {
      first[r] = total;
      total += w.fix_count[region(r)];
    }
    first[n_reg] = total;
  }
  __syncthreads();
  const int total = first[n_reg];
  if (total == 0) return;
  const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const size_t xstride = static_cast<size_t>(H) * P;
  for (int i = tid; i < Q * (P / 8); i += kFixThreads) {
    const int k = i / (P / 8), ch = i % (P / 8);
    xs[i] = *reinterpret_cast<const uint4*>(
        x + (t0 + k) * xstride + static_cast<size_t>(h) * P + 8 * ch);
  }
  for (int k = tid; k < Q; k += kFixThreads) {
    seg[k] = w.seg[(static_cast<size_t>(bc) * H + h) * Q + k];
    dts[k] = dt[(t0 + k) * H + h];
  }
  __syncthreads();
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(xs);
  for (int i = tid; i < total; i += kFixThreads) {
    int r = 0;
    while (first[r + 1] <= i) ++r;
    const uint32_t entry = w.fix_list[region(r) * cap + (i - first[r])];
    const int q = (r / kScanWarps) * kTile + 16 * (r % kScanWarps) +
                  static_cast<int>(entry >> 7);
    const int p = static_cast<int>(entry & 127);
    y[(t0 + q) * xstride + static_cast<size_t>(h) * P + p] =
        __float2bfloat16(ssd_plain_value(xb + p, P, seg, dts, cm, w, b, c, h,
                                         q, p, S, H, P, G, N, Q));
  }
}

// ------------------------------------------------------ the scalar design

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
  float* smem = reinterpret_cast<float*>(dynamic_smem());
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

// Runs `kernel` on `blocks` blocks of `threads` (dynamic shared memory
// above 48 KB allowed first); the cudaError_t of the launch.  Every pass
// of both designs is launched here.
template <typename... K, typename... A>
cudaError_t launch(void (*kernel)(K...), long long blocks, int threads,
                   size_t smem, cudaStream_t st, A... args) {
  if (blocks < 1 || blocks > 0x7fffffffLL || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(static_cast<unsigned>(blocks)), threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// Heads a chunk-scan block: the largest E <= kMaxHeads dividing H / G
// whose grid keeps kFillBlocks blocks; where even E = 1 falls short of
// that (a small call), half the blocks of E = 1, so C B^T is shared by at
// least two heads wherever a group has two.  `units`: (batch, chunk,
// query tile, group) units.
int heads_per_block(long long units, int hg) {
  const long long want =
      units * hg / 2 < kFillBlocks ? units * hg / 2 : kFillBlocks;
  for (int e = hg < kMaxHeads ? hg : kMaxHeads; e > 1; --e)
    if (hg % e == 0 && units * (hg / e) >= want) return e;
  return 1;
}

template <int kPT, int kNS>
cudaError_t launch_chunked(const __nv_bfloat16* x, const float* dt,
                           const float* a, const __nv_bfloat16* b,
                           const __nv_bfloat16* c, __nv_bfloat16* y,
                           float* fin, float* ws, int B, int S, int H, int P,
                           int G, int N, int Q, cudaStream_t st) {
  const int nc = S / Q, nqt = Q / kTile, hg = H / G;
  const int pP = mma_pitch(P), pN = mma_pitch(N);
  const Workspace w = carve(ws, B, S, H, P, G, N, Q);
  const size_t smem1 = 16 * kStateStages * kTile * static_cast<size_t>(pP + pN) +
                       sizeof(float) * 2 * Q;
  cudaError_t err = launch(ssd_scan_chunk_state_kernel<kPT, kNS>,
                           static_cast<long long>(B) * nc * H, kStateThreads,
                           smem1, st, x, dt, a, b, c, w, S, H, P, G, N, Q);
  if (err != cudaSuccess) return err;
  const long long elems = static_cast<long long>(B) * H * P * N;
  err = launch(ssd_scan_state_pass_kernel,
               (elems + kPassThreads - 1) / kPassThreads, kPassThreads, 0, st,
               w, fin, B, H, P * N, nc, Q);
  if (err != cudaSuccess) return err;
  const long long units = static_cast<long long>(nqt) * B * nc * G;
  const int E = heads_per_block(units, hg);
  const size_t smem3 = 16 * (static_cast<size_t>(nqt) * kScanWarps * 8 * 32 +
                             2 * kTile * static_cast<size_t>(pP > pN ? pP : pN)) +
                       sizeof(float) * 2 * E * Q;
  err = launch(ssd_scan_chunk_scan_kernel<kPT, kNS>, units * (hg / E),
               kScanThreads, smem3, st, x, dt, c, y, w, B, S, H, P, G, N, Q,
               E);
  if (err != cudaSuccess) return err;
  const size_t smem4 = 2 * static_cast<size_t>(Q) * P + sizeof(float) * 2 * Q +
                       sizeof(int) * (nqt * kScanWarps + 1);
  return launch(ssd_scan_fixup_kernel, static_cast<long long>(B) * nc * H,
                kFixThreads, smem4, st, x, dt, c, y, w, S, H, P, G, N, Q);
}

using ScalarKernel = void (*)(const void*, const float*, const float*,
                              const void*, const void*, void*, float*, int,
                              int, int, int, int, int);

template <typename T, int kPJ>
ScalarKernel pick_n(int nj) {
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
ScalarKernel pick(int pj, int nj) {
  switch (pj) {
    case 1: return pick_n<T, 1>(nj);
    case 2: return pick_n<T, 2>(nj);
    case 3: return pick_n<T, 3>(nj);
    case 4: return pick_n<T, 4>(nj);
    default: return nullptr;
  }
}

}  // namespace

// The design a call takes: 1 the chunk-parallel tensor-core design (bf16,
// P and N multiples of 16, a chunk that is a multiple of 64 up to 256), 0
// the scalar design, -1 a P, N, chunk or dtype the kernel does not take.
extern "C" int ssd_scan_design(int P, int N, int Q, int dtype) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 ||
      (dtype != 0 && dtype != 1))
    return -1;
  return dtype == 1 && P % 16 == 0 && N % 16 == 0 && Q % kTile == 0 &&
                 Q <= kMaxChunk
             ? 1
             : 0;
}

// fp32 elements of the chunk-parallel design's workspace (see carve): each
// chunk's own state, its incoming state as kParts bf16 parts, seg, C B^T
// of every chunk and group, and pass 4's counts and entries.
extern "C" long long ssd_scan_workspace_floats(int B, int S, int H, int P,
                                               int N, int Q, int G) {
  if (B < 1 || H < 1 || P < 1 || N < 1 || Q < 1 || G < 1 || S % Q != 0 ||
      S % 16 != 0)
    return -1;
  const long long states = static_cast<long long>(B) * (S / Q) * H * P * N;
  const long long tokens = static_cast<long long>(B) * S;
  return states + (kParts * states + 1) / 2 + tokens * H + tokens * G * Q +
         tokens * H / 16 + tokens * H / 16 * fix_cap(P);
}

// Heads that share one C B^T in the chunk-parallel design's pass 3.
extern "C" int ssd_scan_heads_per_block(int B, int S, int H, int G, int Q) {
  if (B < 1 || G < 1 || H % G != 0 || Q < kTile || S % Q != 0) return -1;
  return heads_per_block(static_cast<long long>(Q / kTile) * B * (S / Q) * G,
                         H / G);
}

// x, y: [B, S, H, P]; dt: [B, S, H] fp32; a: [H] fp32; b, c: [B, S, G, N]
// in x's dtype; fin: [B, H, P, N] fp32; ws: the chunk-parallel design's
// workspace of ssd_scan_workspace_floats floats (unused, and may be null,
// in the scalar design).  All contiguous, 16-byte aligned in the
// chunk-parallel design.  dtype: 0 = float32, 1 = bfloat16.  Returns the
// cudaError_t of the launches.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* a,
                               const void* b, const void* c, void* y,
                               float* fin, float* ws, int B, int S, int H,
                               int P, int G, int N, int Q, int dtype,
                               void* stream) {
  const int design = ssd_scan_design(P, N, Q, dtype);
  if (design < 0 || B < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 ||
      S % Q != 0 || (long long)B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* bb = static_cast<const __nv_bfloat16*>(b);
    const auto* cb = static_cast<const __nv_bfloat16*>(c);
    auto* yb = static_cast<__nv_bfloat16*>(y);
    cudaError_t err;
    if (P <= 64 && N <= 64)
      err = launch_chunked<4, 4>(xb, dt, a, bb, cb, yb, fin, ws, B, S, H, P,
                                 G, N, Q, st);
    else if (P <= 64)
      err = launch_chunked<4, 8>(xb, dt, a, bb, cb, yb, fin, ws, B, S, H, P,
                                 G, N, Q, st);
    else if (N <= 64)
      err = launch_chunked<8, 4>(xb, dt, a, bb, cb, yb, fin, ws, B, S, H, P,
                                 G, N, Q, st);
    else
      err = launch_chunked<8, 8>(xb, dt, a, bb, cb, yb, fin, ws, B, S, H, P,
                                 G, N, Q, st);
    return static_cast<int>(err);
  }
  const size_t smem = sizeof(float) *
      ((size_t)P * (N + 1) + 3 * (size_t)Q + 2 * (size_t)kT * (N + 1) +
       (size_t)kT * P + (size_t)kT * (kT + 1));
  const int pj = (P + 31) / 32, nj = (N + 31) / 32;
  const ScalarKernel kernel = dtype == 0 ? pick<float>(pj, nj)
                                         : pick<__nv_bfloat16>(pj, nj);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(kernel, static_cast<long long>(B) * H,
                                 kThreads, smem, st, x, dt, a, b, c, y, fin,
                                 S, H, P, G, N, Q));
}
