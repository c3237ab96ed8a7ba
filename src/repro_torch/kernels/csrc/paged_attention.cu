// Chunked decode attention through the page table, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::paged_attention_pallas
// (body _paged_kernel).  Same function: for each lane b and kv head h, the
// R = C*G query rows (chunk positions times the GQA group) attend the lane's
// pages 0..last of the shared K/V pool, reached through page_table[b], under
// the causal chunk mask k_pos <= pos + row / G; an fp32 online softmax; the
// output cast once.  A lane has at most C fresh rows (n_new is capped at C);
// rows at or past max(n_new, 1) * G are garbage the caller discards and are
// written as zeros.  Idle lanes (n_new == 0) still attend page 0.  With
// all_rows set (the moe family, whose router takes every row of a chunk
// together) every one of a lane's C*G rows is computed as the plain version
// computes it, idle lanes included: row r sees the keys up to pos + r / G,
// over the pages up to min((pos + C - 1) / bs, n_pages - 1).
//
// Bound on the H100: device memory.  A (lane, kv head) must read the K and
// V rows of its visited pages once, 2 * hd * sizeof(T) bytes a key, and does
// 4 * hd flops a key and query row: with at most C*G = 112 rows (every
// arch's chunk) that stays below the card's ~295 bf16 flops a byte, so the
// least time is the bytes of the distinct pages the lanes visit over 3.35
// TB/s.  A design with one block per lane, kv head and 8-row tile, its
// warps walking pages in turn, falls far short of that: at the serving
// tick 128 blocks for 132 SMs, every page a chain of dependent trips to
// memory, K/V read again by every row tile, and scores on the CUDA cores.
// This design:
//
// * Splits a lane's pages across blocks (flash-decoding).  The grid is
//   (lanes x kv heads x row groups, splits) with `pps` pages a split, chosen
//   on the host (paged_attention_splits) so that about kTargetBlocks blocks
//   fill the card, and each split reads at least kKeysPerRow keys a query
//   row, so its fp32 partial (m, l, acc for its live rows) stays small
//   beside its K/V.  A block first reads the lane's pos and n_new together
//   with its slice of the page table (one round trip: the slice, pps ints,
//   is issued before liveness is known); a split past the lane's last page
//   then returns with no K/V traffic.  A lane whose keys all lie in split 0
//   is written by that block alone, zero rows included.  Otherwise each
//   live split writes its partial to a workspace the caller allocates, and
//   a second kernel (paged_merge_kernel) folds the partials in split order,
//   kMergeBatch splits' loads in flight at once, so two calls give equal
//   bits, and writes every row, zeros included.  No atomics.
// * Reads K/V once for all of a (lane, kv head)'s rows: a block holds every
//   row of its row group (up to 128 rows; only C*G above that makes more
//   than one group, and then each group reads the pages again).  No block
//   exists only to write zeros.
// * Keeps loads in flight: each block walks its keys in tiles, gathered key
//   by key through the table into a ring in shared memory by 16-byte
//   cp.async (keys past the split's last valid one zero-filled), each
//   thread stepping through its (key, chunk) pairs without dividing.  The
//   mma design holds kStages tiles of kMT keys, two in flight while one is
//   computed (32 KB a block at hd 128); the scalar design kScalarStages
//   tiles of kScalarTileBytes of K, one in flight, and more blocks an SM.
//   Head dims whose rows are not a whole number of 16-byte chunks (or pools
//   not on a 16-byte boundary) copy element by element, synchronously.
// * Two designs, chosen up front (paged_attention_design):
//   - "mma" (bf16, hd a multiple of 16 up to 128, C*G >= kMmaMinRows): one
//     warp per 16 query rows.  S = Q K^T and O += P V run as mma.sync
//     m16n8k16 bf16 -> fp32 with ldmatrix (.trans for V) on XOR-swizzled
//     tiles, the online softmax on the accumulator fragments, as in
//     flash_attention.cu.  P goes through as P_hi + P_lo (two bf16 parts),
//     which holds the plain version's fp32 P to the bf16 band at 2,048
//     keys.  Rows of a 16-row tile past C*G are computed on zeros and
//     never written; a decode row pays 16 rows of tensor-core work, which
//     is far below its bytes.  A block whose live rows fit one 16-row tile
//     while it has more warps (the engine's decode of a GQA group: a chunk
//     of C*G rows, G of them live) walks its keys key-parallel: each warp
//     takes those 16 rows over every nw-th tile of kKpKeys keys through a
//     cp.async ring of its own (kKpStages deep, no block barrier in the
//     walk), and warp 0 folds the warps' partials in warp order.  Else a
//     warp whose rows are all past the live ones only helps to load.
//   - "scalar" (f32, odd head dims, fewer than kMmaMinRows rows): 128
//     threads.  Each score is 8 lanes' partial dot products of an fp32 q row
//     (staged once) with a K row in shared memory, joined by 3 shuffles; a
//     warp per row takes a tile's max, exponentials and sum; P*V runs one
//     thread per (row, dim) over the tile's keys into an fp32 accumulator in
//     shared memory.
//   Scores are scaled by scale * log2(e) and exponentiated with exp2f; the
//   partials keep m in those units.
//
// At the serving tick's size (about 18 MB of distinct pages) the time is
// mostly fixed: a launch, the trips before the first tile lands, and the
// merge's launch.  Beyond that the decode calls stream their bytes at 50-80%
// of the bound, a GQA block held to one per SM by its registers, and a
// 112-row GQA chunk is bound by its mma.sync work (PERF.md).  TMA gathers
// of whole pages and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxRows = 128;        // query rows a block: 8 m16 tiles
constexpr int kScalarAcc = 16384;    // rows x hd of a scalar block's fp32 acc
constexpr int kMmaMinRows = 4;       // C*G from which bf16 takes the mma design
constexpr int kMmaMaxD = 128;
constexpr int kTargetBlocks = 1056;  // 8 blocks on each of the card's 132 SMs
constexpr int kKeysPerRow = 8;       // least keys a split reads per query row
constexpr int kMaxPps = 1024;        // pages a split (its table slice in smem)
constexpr int kStages = 3;           // mma ring: two tiles in flight
constexpr int kMT = 32;              // keys a tile, mma design
constexpr int kKpStages = 3;         // a key-parallel warp's own ring
constexpr int kKpKeys = 16;          // keys a tile of that ring
constexpr int kScalarStages = 2;     // scalar ring: one tile in flight
constexpr int kScalarTileBytes = 8192;  // K bytes a scalar tile (at most)
constexpr int kLPI = 8;              // lanes a score, scalar design
constexpr int kScalarThreads = 128;
constexpr int kMergeRows = 4;        // rows a merge block, a warp each
constexpr int kMergeThreads = 32 * kMergeRows;
constexpr int kMergeBatch = 16;      // splits whose loads the merge issues at once
constexpr size_t kMaxSmem = 227 * 1024;

// The dynamic shared memory of every kernel here.
__device__ __forceinline__ float4* dynamic_smem() {
  extern __shared__ float4 paged_smem[];
  return paged_smem;
}

// ------------------------------------------------------------ PTX helpers
// One instruction each, as in flash_attention.cu.  A CPU build supplies its
// own definitions of the same names.
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

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// element e of a 16-byte chunk of T
__device__ __forceinline__ float chunk_elem(const uint4& c, int e, float*) {
  const uint32_t w = e == 0 ? c.x : e == 1 ? c.y : e == 2 ? c.z : c.w;
  return __uint_as_float(w);
}
__device__ __forceinline__ float chunk_elem(const uint4& c, int e,
                                            __nv_bfloat16*) {
  const int i = e >> 1;
  const uint32_t w = i == 0 ? c.x : i == 1 ? c.y : i == 2 ? c.z : c.w;
  return (e & 1) ? bf16_hi(w) : bf16_lo(w);
}

// 16-byte chunks in a shared-memory row of D bf16: D / 8 rounded up to a
// multiple of 8, so the XOR swizzle stays inside the row
__host__ __device__ constexpr int mma_pitch(int d) {
  return (d / 8 + 7) / 8 * 8;
}

__device__ __forceinline__ int swizzle(int row, int chunk) {
  return chunk ^ (row & 7);
}

// ------------------------------------------------------ shared geometry

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pt;
  const int* pos;
  const int* n_new;
  void* out;
  float* ws;            // [B*KV][n_splits][R][hd] acc, then [..][R][2] (m, l)
  long long ml_off;     // floats before the (m, l) pairs
  int C, KV, G, hd, bs, n_pages;
  int bs_shift;         // log2(bs) when bs is a power of two, else -1
  int R;                // C * G rows a (lane, kv head)
  int rows_blk;         // rows a block holds (a row group)
  int row_groups;
  int pps;              // pages a split
  int n_splits;
  int kt;               // keys a tile (scalar design)
  int all_rows;         // compute all C chunk rows, not the live ones
  float scale_log2;     // scale * log2(e)
};

// Chunk positions a lane computes: all C with all_rows, else its live ones
// (max(n_new, 1), capped at C).  They set both the rows a block computes
// and the last key it reads: pos + chunk_rows - 1.
__device__ __forceinline__ int chunk_rows(const Args& a, int b) {
  return a.all_rows ? a.C : min(max(a.n_new[b], 1), a.C);
}

// One block's share: (lane b, kv head h, row group, split).
struct Blk {
  int b, h, split, row0, rows, nlb, pos, page0, key0, key_end;
  int n_live;  // splits of the lane holding a valid key
};

template <typename T>
__device__ __forceinline__ T* out_row(const Args& a, int b, int h, int r) {
  return static_cast<T*>(a.out) +
         ((((size_t)b * a.C + r / a.G) * a.KV + h) * a.G + r % a.G) *
             (size_t)a.hd;
}

template <typename T>
__device__ __forceinline__ const T* q_row(const Args& a, int b, int h,
                                          int r) {
  return static_cast<const T*>(a.q) +
         ((((size_t)b * a.C + r / a.G) * a.KV + h) * a.G + r % a.G) *
             (size_t)a.hd;
}

// Zeros into the output rows [row0 + from, row0 + rows) of (b, h): a
// warp a row, 16 bytes a lane where rows are whole 16-byte chunks.
template <typename T>
__device__ void zero_rows(const Args& a, const Blk& k, int from) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool vec = (a.hd * (int)sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  for (int r = from + warp; r < k.rows; r += blockDim.x / 32) {
    T* o = out_row<T>(a, k.b, k.h, k.row0 + r);
    if (vec) {
      for (int c = lane; c < a.hd * (int)sizeof(T) / 16; c += 32)
        reinterpret_cast<uint4*>(o)[c] = make_uint4(0, 0, 0, 0);
    } else {
      for (int d = lane; d < a.hd; d += 32) o[d] = from_float<T>(0.f);
    }
  }
}

// Reads the lane's pos and n_new and this split's slice of the page table
// into spt, all issued before any is used.  False when the block has no
// work: a split past the lane's last page, or a row group past the lane's
// computed rows (whose zeros split 0 writes when it is the lane's only live
// split, and the merge otherwise).
template <typename T>
__device__ bool block_setup(const Args& a, int* spt, Blk& k) {
  k.b = blockIdx.x / (a.KV * a.row_groups);
  k.h = (blockIdx.x / a.row_groups) % a.KV;
  const int rg = blockIdx.x % a.row_groups;
  k.split = blockIdx.y;
  const int page0 = k.page0 = k.split * a.pps;
  const int npg = min(a.pps, a.n_pages - page0);
  const int* pt = a.pt + (size_t)k.b * a.n_pages + page0;
  for (int i = threadIdx.x; i < npg; i += blockDim.x) spt[i] = pt[i];
  k.pos = a.pos[k.b];
  const int n_eff = chunk_rows(a, k.b);
  __syncthreads();
  k.row0 = rg * a.rows_blk;
  k.rows = min(a.rows_blk, a.R - k.row0);
  k.nlb = max(0, min(k.rows, n_eff * a.G - k.row0));
  // the lane's last page holding a computed row (the TPU kernel's `last`
  // when only live rows are computed); keys past pos + n_eff - 1 are masked
  // for every row
  const int last = min((k.pos + n_eff - 1) / a.bs, a.n_pages - 1);
  k.key0 = page0 * a.bs;
  k.key_end = min(min(page0 + a.pps, a.n_pages) * a.bs, k.pos + n_eff);
  k.n_live = min(last / a.pps + 1, a.n_splits);
  if (page0 > last) return false;
  if (k.nlb == 0) {  // rows all past the computed ones: zeros, here or merged
    if (k.n_live == 1) zero_rows<T>(a, k, 0);
    return false;
  }
  return true;
}

// The fp32 partial slot of row `row` of (b, h) in split s.
__device__ __forceinline__ size_t slot(const Args& a, const Blk& k, int s,
                                       int row) {
  return ((size_t)(k.b * a.KV + k.h) * a.n_splits + s) * a.R + row;
}

// The pool row (physical row * KV + h) of one of the split's keys.
__device__ __forceinline__ size_t key_row(const Args& a, const Blk& k,
                                          const int* spt, int key) {
  int page, off;
  if (a.bs_shift >= 0) {
    page = key >> a.bs_shift;
    off = key & (a.bs - 1);
  } else {
    page = key / a.bs;
    off = key - page * a.bs;
  }
  return ((size_t)spt[page - k.page0] * a.bs + off) * a.KV + k.h;
}

// Copies keys [kk, kk + nk) of the split (K and V, kv head h) into a
// stage: row j of a tile at dst + j * pitch (16-byte units) with its
// 16-byte chunk c at chunk_at(j, c).  Keys at or past key_end are zeros.
// kNch: 16-byte chunks a row when known at compile time (else 0); a
// thread steps through its (row, chunk) pairs without dividing.
// The copies are shared by `step` threads, this one being `tid`.
template <typename T, int kNch, typename F>
__device__ __forceinline__ void load_tile_16(const Args& a, const Blk& k,
                                             const int* spt, int kk, int nk,
                                             uint4* kdst, uint4* vdst,
                                             int pitch, F chunk_at, int tid,
                                             int step) {
  const int nch = kNch > 0 ? kNch : a.hd * (int)sizeof(T) / 16;
  const int dj = step / nch, dc = step % nch;
  int j = tid / nch, c = tid % nch;
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  for (int e = tid; e < nk * nch; e += step) {
    const int key = kk + j;
    const bool ok = key < k.key_end;
    const size_t off = key_row(a, k, spt, ok ? key : k.key0) * a.hd +
                       (size_t)c * (16 / sizeof(T));
    const int at = j * pitch + chunk_at(j, c);
    cp_async_16(kdst + at, kp + off, ok);
    cp_async_16(vdst + at, vp + off, ok);
    j += dj;
    c += dc;
    if (c >= nch) {
      c -= nch;
      ++j;
    }
  }
}

// ------------------------------------------------- the tensor-core design

// Rows of kP 16-byte units before the table slice: the block's ring
// (kStages tiles of kMT keys, K and V) and Q's nw * 16 rows, or in the
// key-parallel walk nw warps' own rings (kKpStages tiles of kKpKeys keys
// each) and Q's 16 rows, whichever is larger.
__host__ __device__ constexpr int mma_smem_rows(int nw) {
  return kStages * 2 * kMT + nw * 16 > nw * kKpStages * 2 * kKpKeys + 16
             ? kStages * 2 * kMT + nw * 16
             : nw * kKpStages * 2 * kKpKeys + 16;
}

// One warp's online-softmax step over kKeys keys staged at kst and vst
// (rows of kP units, XOR-swizzled), for its 16 query rows in qf: rows g and
// g + 8 of the lane, m in log2 units, l the lane's partial sum over its own
// columns, o the output fragments.  k0 is the tile's first key; a row sees
// keys up to kmax.
template <int kD, int kKeys>
__device__ __forceinline__ void mma_tile(const uint32_t (&qf)[kD / 16][4],
                                         const uint4* kst, const uint4* vst,
                                         int k0, const int (&kmax)[2],
                                         float scale_log2, float (&m)[2],
                                         float (&l)[2], float (&o)[kD / 8][4],
                                         int lane) {
  constexpr int kP = mma_pitch(kD);
  constexpr int kKS = kD / 16;        // k steps of Q K^T
  constexpr int kNT = kD / 8;         // 8-column tiles of the output
  constexpr int kST = kKeys / 8;      // 8-key tiles of S
  const int t = lane % 4;

  // S = Q K^T: an x4 of K gives the B fragments of two 8-key tiles
  float sc[kST][4];
#pragma unroll
  for (int j = 0; j < kST; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
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
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kST; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 8 * j + 2 * t + (i & 1);
      const float x = key <= kmax[i >> 1] ? sc[j][i] * scale_log2 : -INFINITY;
      sc[j][i] = x;
      mx[i >> 1] = fmaxf(mx[i >> 1], x);
    }
  }
  float m_use[2], alpha[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(kFull, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(kFull, mx[hh], 2));
    const float m_new = fmaxf(m[hh], mx[hh]);
    // a row with no live key yet keeps P = 0 and its zero state
    m_use[hh] = m_new == -INFINITY ? 0.f : m_new;
    alpha[hh] = exp2f(m[hh] - m_use[hh]);  // 0 on the first live tile
    m[hh] = m_new;
    l[hh] *= alpha[hh];
  }
#pragma unroll
  for (int j = 0; j < kST; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sc[j][i] = exp2f(sc[j][i] - m_use[i >> 1]);  // masked: 0
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

  // O += P V, 16 keys a step, P as P_hi + P_lo; an x4.trans of V gives the
  // B fragments of two 8-column tiles
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float p0 = sc[2 * kk + (x >> 1)][2 * (x & 1)];
      const float p1 = sc[2 * kk + (x >> 1)][2 * (x & 1) + 1];
      hi[x] = pack_bf16x2(p0, p1);
      lo[x] = pack_bf16x2(p0 - bf16_lo(hi[x]), p1 - bf16_hi(hi[x]));
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

// kD: head dim, a multiple of 16 up to 128.  One warp per 16 rows, all
// warps loading each tile of the block's ring.  A block whose live rows fit
// one 16-row tile (a decode lane of a GQA group: its other warps would only
// load) runs key-parallel instead: every warp takes those 16 rows over its
// own tiles (tile w, w + nw, ...) through its own cp.async ring, with no
// block barrier in the walk, and warp 0 folds the warps' partials in warp
// order.
template <int kD>
__global__ void __launch_bounds__(32 * kMaxRows / 16)
paged_mma_kernel(Args a) {
  constexpr int kP = mma_pitch(kD);
  constexpr int kKS = kD / 16;        // k steps of Q K^T
  constexpr int kNT = kD / 8;         // 8-column tiles of the output
  constexpr int kTile = kMT * kP;     // 16-byte units of one K (or V) tile
  constexpr int kKpTile = kKpKeys * kP;
  const int nw = blockDim.x / 32;
  // the ring ([kStages][K, V][kMT][kP], or [nw][kKpStages][K, V][kKpKeys]
  // [kP]), then Q ([nw * 16][kP], or [16][kP]), then the table slice [pps]
  uint4* ring = reinterpret_cast<uint4*>(dynamic_smem());
  int* spt = reinterpret_cast<int*>(ring + mma_smem_rows(nw) * kP);

  Blk k;
  if (!block_setup<__nv_bfloat16>(a, spt, k)) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4;
  const bool kpar = nw > 1 && k.nlb <= 16;  // block-uniform
  uint4* qs = ring + (kpar ? nw * kKpStages * 2 * kKpKeys : kStages * 2 * kMT) * kP;
  const int q_rows = kpar ? 16 : nw * 16;
  const int qw = kpar ? 0 : warp;           // the warp's 16-row tile
  const bool live = 16 * qw < k.nlb;        // warp-uniform
  const int n_tiles = (k.key_end - k.key0 + kMT - 1) / kMT;
  const auto at = [](int r, int c) { return swizzle(r, c); };
  const auto issue = [&](int tile) {
    if (tile < n_tiles) {
      uint4* st = ring + (tile % kStages) * 2 * kTile;
      const int kk = k.key0 + tile * kMT;
      load_tile_16<__nv_bfloat16, kD / 8>(a, k, spt, kk, kMT, st,
                                           st + kTile, kP, at, tid,
                                           blockDim.x);
    }
    cp_async_commit();
  };
  // key-parallel: this warp's i-th tile of kKpKeys keys is tile
  // warp + i * nw of the split
  uint4* wring = ring + warp * kKpStages * 2 * kKpTile;
  const int kp_tiles = (k.key_end - k.key0 + kKpKeys - 1) / kKpKeys;
  const auto issue_kp = [&](int i) {
    const int tile = warp + i * nw;
    if (tile < kp_tiles) {
      uint4* st = wring + (i % kKpStages) * 2 * kKpTile;
      load_tile_16<__nv_bfloat16, kD / 8>(a, k, spt,
                                           k.key0 + tile * kKpKeys, kKpKeys,
                                           st, st + kKpTile, kP, at, lane, 32);
    }
    cp_async_commit();
  };

  // Q rows of the block, rows past its live rows as zeros
  for (int e = tid; e < q_rows * (kD / 8); e += blockDim.x) {
    const int r = e / (kD / 8), c = e % (kD / 8);
    const bool ok = r < k.nlb;
    cp_async_16(qs + r * kP + swizzle(r, c),
                q_row<__nv_bfloat16>(a, k.b, k.h, ok ? k.row0 + r : 0) + c * 8,
                ok);
  }
  cp_async_commit();
  if (kpar) {
    issue_kp(0);
    cp_async_wait<1>();            // Q has landed; the first tile may not
  } else {
    for (int i = 0; i < kStages - 1; ++i) issue(i);
    cp_async_wait<kStages - 1>();  // Q has landed; the first tiles may not
  }
  __syncthreads();

  uint32_t qf[kKS][4];
  if (live) {
#pragma unroll
    for (int s = 0; s < kKS; ++s) {
      const int r = 16 * qw + (lane & 15);
      ldmatrix_x4(qf[s], qs + r * kP + swizzle(r, 2 * s + (lane >> 4)));
    }
  }
  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // the last key each of the lane's two rows may see
  int kmax[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    kmax[hh] = min(k.key_end - 1,
                   k.pos + (k.row0 + 16 * qw + g + 8 * hh) / a.G);

  if (kpar) {
    for (int i = 0; warp + i * nw < kp_tiles; ++i) {
      issue_kp(i + 1);
      cp_async_wait<1>();  // tile i has landed (this lane's copies)
      __syncwarp();        // and every lane's
      const uint4* kst = wring + (i % kKpStages) * 2 * kKpTile;
      mma_tile<kD, kKpKeys>(qf, kst, kst + kKpTile,
                            k.key0 + (warp + i * nw) * kKpKeys, kmax,
                            a.scale_log2, m, l, o, lane);
      __syncwarp();        // every lane is done with the stage of tile i
    }
  } else {
    for (int tile = 0; tile < n_tiles; ++tile) {
      cp_async_wait<kStages - 2>();  // tile `tile` has landed (this thread's)
      // every copy is visible, and every warp is done with the stage that
      // tile + kStages - 1 is about to overwrite
      __syncthreads();
      issue(tile + kStages - 1);
      if (!live) continue;
      const uint4* kst = ring + (tile % kStages) * 2 * kTile;
      mma_tile<kD, kMT>(qf, kst, kst + kTile, k.key0 + tile * kMT, kmax,
                        a.scale_log2, m, l, o, lane);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // each row's sum over its four lanes
    l[hh] += __shfl_xor_sync(kFull, l[hh], 1);
    l[hh] += __shfl_xor_sync(kFull, l[hh], 2);
  }

  if (kpar) {
    // every warp's (m, l, o) for rows 0..15 into the ring, then warp 0
    // folds warps 1.. in order into its own: the same bits on every call
    __syncthreads();  // every warp is done with its ring
    float* red = reinterpret_cast<float*>(ring);             // [nw][16][kD]
    float* red_ml = red + nw * 16 * kD;                       // [nw][16][2]
    const int t = lane % 4;
    if (warp > 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = g + 8 * hh;
        float2* dst = reinterpret_cast<float2*>(red + (warp * 16 + r) * kD +
                                                2 * t);
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          dst[4 * n] = make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
        if (t == 0) {
          red_ml[2 * (warp * 16 + r)] = m[hh];
          red_ml[2 * (warp * 16 + r) + 1] = l[hh];
        }
      }
    }
    __syncthreads();
    for (int w = 1; w < nw && warp == 0; ++w) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = g + 8 * hh;
        const float mw = red_ml[2 * (w * 16 + r)];
        const float lw = red_ml[2 * (w * 16 + r) + 1];
        const float m_new = fmaxf(m[hh], mw);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float a0 = exp2f(m[hh] - m_use), a1 = exp2f(mw - m_use);
        m[hh] = m_new;
        l[hh] = l[hh] * a0 + lw * a1;
        const float2* src = reinterpret_cast<const float2*>(
            red + (w * 16 + r) * kD + 2 * t);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const float2 x = src[4 * n];
          o[n][2 * hh] = o[n][2 * hh] * a0 + x.x * a1;
          o[n][2 * hh + 1] = o[n][2 * hh + 1] * a0 + x.y * a1;
        }
      }
    }
  }

  const bool direct = k.n_live == 1;
  if (kpar ? warp == 0 : live) {
    const int t = lane % 4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * qw + g + 8 * hh;  // row in the block
      if (r >= k.nlb) continue;
      const int row = k.row0 + r;
      if (direct) {
        const float denom = fmaxf(l[hh], 1e-30f);
        uint32_t* dst = reinterpret_cast<uint32_t*>(
            out_row<__nv_bfloat16>(a, k.b, k.h, row) + 2 * t);
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          dst[4 * n] =
              pack_bf16x2(o[n][2 * hh] / denom, o[n][2 * hh + 1] / denom);
      } else {
        const size_t sl = slot(a, k, k.split, row);
        float2* dst = reinterpret_cast<float2*>(a.ws + sl * kD + 2 * t);
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          dst[4 * n] = make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
        if (t == 0) {
          a.ws[a.ml_off + 2 * sl] = m[hh];
          a.ws[a.ml_off + 2 * sl + 1] = l[hh];
        }
      }
    }
  }
  if (direct) zero_rows<__nv_bfloat16>(a, k, k.nlb);
}

// ------------------------------------------------------ the scalar design

// kVec: K/V rows are whole 16-byte chunks on 16-byte boundaries, copied by
// cp.async; otherwise element by element.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kScalarThreads)
paged_scalar_kernel(Args a) {
  const int hd = a.hd, kt = a.kt;
  // [3][K,V][kt][hd] T, then fp32: q [rows_blk][hd] (scaled), acc
  // [rows_blk][hd], p [rows_blk][kt], m, l, alpha [rows_blk]; then the table
  const int tile = kt * hd;                       // elements of a K tile
  const int ring16 = (kScalarStages * 2 * tile * (int)sizeof(T) + 15) / 16;
  T* ring = reinterpret_cast<T*>(dynamic_smem());
  float* sq = reinterpret_cast<float*>(dynamic_smem() + ring16);
  float* sacc = sq + a.rows_blk * hd;
  float* sp = sacc + a.rows_blk * hd;
  float* sm = sp + a.rows_blk * kt;
  float* sl = sm + a.rows_blk;
  float* salpha = sl + a.rows_blk;
  int* spt = reinterpret_cast<int*>(salpha + a.rows_blk);

  Blk k;
  if (!block_setup<T>(a, spt, k)) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nthreads = blockDim.x;
  const int n_tiles = (k.key_end - k.key0 + kt - 1) / kt;
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const auto issue = [&](int ti) {
    if (ti < n_tiles) {
      T* kst = ring + (ti % kScalarStages) * 2 * tile;
      const int kk = k.key0 + ti * kt;
      if constexpr (kVec) {
        const int nch = hd * (int)sizeof(T) / 16;
        load_tile_16<T, 0>(a, k, spt, kk, kt, reinterpret_cast<uint4*>(kst),
                        reinterpret_cast<uint4*>(kst + tile), nch,
                        [](int, int c) { return c; }, tid, nthreads);
      } else {
        for (int e = tid; e < tile; e += nthreads) {
          const int key = kk + e / hd;
          const bool ok = key < k.key_end;
          const size_t off =
              key_row(a, k, spt, ok ? key : k.key0) * hd + e % hd;
          kst[e] = ok ? kp[off] : from_float<T>(0.f);
          kst[tile + e] = ok ? vp[off] : from_float<T>(0.f);
        }
      }
    }
    if constexpr (kVec) cp_async_commit();
  };
  for (int i = 0; i < kScalarStages - 1; ++i) issue(i);
  for (int i = tid; i < k.nlb * hd; i += nthreads) {
    sq[i] = to_float(q_row<T>(a, k.b, k.h, k.row0 + i / hd)[i % hd]) *
            a.scale_log2;
    sacc[i] = 0.f;
  }
  for (int r = tid; r < k.nlb; r += nthreads) {
    sm[r] = -INFINITY;
    sl[r] = 0.f;
  }
  const int sub = lane % kLPI;
  const int grp = tid / kLPI;                 // score slot of the block
  const int n_grp = nthreads / kLPI;
  const int items = k.nlb * kt;

  for (int ti = 0; ti < n_tiles; ++ti) {
    if constexpr (kVec) cp_async_wait<kScalarStages - 2>();
    // tile ti is visible, and the stage of ti + kScalarStages - 1 is free
    __syncthreads();
    issue(ti + kScalarStages - 1);
    const T* kst = ring + (ti % kScalarStages) * 2 * tile;
    const T* vst = kst + tile;
    const int k0 = k.key0 + ti * kt;

    // scores, kLPI lanes each: item (row r, key j); the loop runs the same
    // count on every lane, so the shuffles see whole warps
    for (int u = 0; u * n_grp < items; ++u) {
      const int it = u * n_grp + grp;
      const bool ok = it < items;
      const int r = ok ? it / kt : 0, j = ok ? it % kt : 0;
      const float* qr = sq + r * hd;
      const T* kr = kst + j * hd;
      float s = 0.f;
      if (ok) {
        if constexpr (kVec) {
          constexpr int E = 16 / sizeof(T);
          for (int c = sub; c < hd / E; c += kLPI) {
            const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * E);
#pragma unroll
            for (int e4 = 0; e4 < E; e4 += 4) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qr + c * E + e4);
              s = fmaf(qv.x, chunk_elem(raw, e4, (T*)nullptr), s);
              s = fmaf(qv.y, chunk_elem(raw, e4 + 1, (T*)nullptr), s);
              s = fmaf(qv.z, chunk_elem(raw, e4 + 2, (T*)nullptr), s);
              s = fmaf(qv.w, chunk_elem(raw, e4 + 3, (T*)nullptr), s);
            }
          }
        } else {
          for (int d = sub; d < hd; d += kLPI)
            s = fmaf(qr[d], to_float(kr[d]), s);
        }
      }
#pragma unroll
      for (int o = kLPI / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      if (ok && sub == 0) {
        const int key = k0 + j;
        const bool valid =
            key < k.key_end && key <= k.pos + (k.row0 + r) / a.G;
        sp[r * kt + j] = valid ? s : -INFINITY;  // causal chunk mask
      }
    }
    __syncthreads();

    // online softmax, a warp a row, a lane a key
    for (int r = warp; r < k.nlb; r += nthreads / 32) {
      const float x = lane < kt ? sp[r * kt + lane] : -INFINITY;
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p = exp2f(x - m_use);             // masked keys: 0
      const float alpha = exp2f(m_old - m_use);     // 0 on the first live tile
      const float psum = warp_sum(p);
      if (lane < kt) sp[r * kt + lane] = p;
      if (lane == 0) {
        sm[r] = m_new;
        sl[r] = sl[r] * alpha + psum;
        salpha[r] = alpha;
      }
    }
    __syncthreads();

    // P V, a thread per (row, dim); keys past key_end are zero rows of V
    // with weight 0
    for (int i = tid; i < k.nlb * hd; i += nthreads) {
      const int r = i / hd, d = i % hd;
      const float* pr = sp + r * kt;
      float acc = 0.f;
      for (int j = 0; j < kt; ++j) acc = fmaf(pr[j], to_float(vst[j * hd + d]), acc);
      sacc[i] = sacc[i] * salpha[r] + acc;
    }
  }
  if constexpr (kVec) cp_async_wait<0>();
  __syncthreads();

  if (k.n_live == 1) {
    for (int i = tid; i < k.nlb * hd; i += nthreads) {
      const int r = i / hd;
      out_row<T>(a, k.b, k.h, k.row0 + r)[i % hd] =
          from_float<T>(sacc[i] / fmaxf(sl[r], 1e-30f));
    }
    zero_rows<T>(a, k, k.nlb);
  } else {
    const size_t slot0 = slot(a, k, k.split, k.row0);
    for (int i = tid; i < k.nlb * hd; i += nthreads)
      a.ws[slot0 * hd + i] = sacc[i];
    for (int r = tid; r < k.nlb; r += nthreads) {
      a.ws[a.ml_off + 2 * (slot0 + r)] = sm[r];
      a.ws[a.ml_off + 2 * (slot0 + r) + 1] = sl[r];
    }
  }
}

// ------------------------------------------------------------- the merge

// One warp per row of a (lane, kv head), kMergeRows rows a block; a lane
// holds dims lane, lane + 32, ... (kDims of them).  A lane with one live
// split was written by its split block.  Otherwise the live splits'
// partials are folded in split order, kMergeBatch splits at a time with
// every load of a batch issued before any is used (the partials sit in L2,
// and a split a load in turn would pay its latency once a split), into a
// running max, denominator and row: the same bits on every call.  Then the
// row is divided by its denominator and cast once; rows past the lane's
// live rows are written as zeros.
template <typename T, int kDims>
__global__ void __launch_bounds__(kMergeThreads)
paged_merge_kernel(Args a) {
  Blk k;
  const int bh = blockIdx.x;
  k.b = bh / a.KV;
  k.h = bh % a.KV;
  const int r = blockIdx.y * kMergeRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= a.R) return;
  const int pos = a.pos[k.b];
  const int n_eff = chunk_rows(a, k.b);
  const int last = min((pos + n_eff - 1) / a.bs, a.n_pages - 1);
  const int n_live = min(last / a.pps + 1, a.n_splits);
  if (n_live == 1) return;
  T* o = out_row<T>(a, k.b, k.h, r);
  if (r >= n_eff * a.G) {
    for (int d = lane; d < a.hd; d += 32) o[d] = from_float<T>(0.f);
    return;
  }
  const float* ml = a.ws + a.ml_off + 2 * slot(a, k, 0, r);
  const float* acc = a.ws + slot(a, k, 0, r) * a.hd;
  const size_t stride = (size_t)a.R;  // slots from one split to the next
  float mx = -INFINITY, denom = 0.f, x[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) x[i] = 0.f;
  for (int s0 = 0; s0 < n_live; s0 += kMergeBatch) {
    float m[kMergeBatch], l[kMergeBatch], v[kMergeBatch][kDims];
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      const bool ok = s0 + u < n_live;
      const size_t s = ok ? s0 + u : s0;
      m[u] = ok ? ml[2 * s * stride] : -INFINITY;
      l[u] = ml[2 * s * stride + 1];
#pragma unroll
      for (int i = 0; i < kDims; ++i) {
        const int d = lane + 32 * i;
        v[u][i] = d < a.hd ? acc[s * stride * a.hd + d] : 0.f;
      }
    }
    float bm = mx;
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) bm = fmaxf(bm, m[u]);
    // split 0 holds key 0, which every row sees, so bm is finite
    const float alpha = exp2f(mx - bm);
    denom *= alpha;
#pragma unroll
    for (int i = 0; i < kDims; ++i) x[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      // 0 past n_live and for a row without a valid key in the split
      const float w = exp2f(m[u] - bm);
      denom += l[u] * w;
#pragma unroll
      for (int i = 0; i < kDims; ++i) x[i] += v[u][i] * w;
    }
    mx = bm;
  }
  denom = fmaxf(denom, 1e-30f);
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    const int d = lane + 32 * i;
    if (d < a.hd) o[d] = from_float<T>(x[i] / denom);
  }
}

// ---------------------------------------------------------------- launch

// Runs `kernel` on `grid` blocks of `threads` (dynamic shared memory above
// 48 KB allowed first); the cudaError_t of the launch.  Every kernel here
// is launched from this one place.
template <typename... K, typename... A>
int launch(void (*kernel)(K...), dim3 grid, int threads, size_t smem,
           cudaStream_t st, A... args) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

using Kernel = void (*)(Args);

Kernel pick_mma(int d) {
  switch (d) {
#define PA_CASE(N) \
  case N:          \
    return paged_mma_kernel<N>;
    PA_CASE(16) PA_CASE(32) PA_CASE(48) PA_CASE(64)
    PA_CASE(80) PA_CASE(96) PA_CASE(112) PA_CASE(128)
#undef PA_CASE
    default:
      return nullptr;
  }
}

// Query rows a block holds: up to 8 m16 tiles, and in the scalar design at
// most kScalarAcc / hd, so its fp32 q and accumulator fit shared memory.
int rows_per_block(int design, int R, int hd) {
  const int cap = design == 1 ? kMaxRows
                              : (kScalarAcc / hd < kMaxRows ? kScalarAcc / hd
                                                            : kMaxRows);
  return R < cap ? R : cap;
}

// Keys a scalar tile: about kScalarTileBytes of K rows, at most a warp's
// worth (the softmax takes a key a lane).
int scalar_tile_keys(int hd, int item) {
  const int kt = kScalarTileBytes / (hd * item);
  return kt < 1 ? 1 : (kt > 32 ? 32 : kt);
}

// Pages a split, or 0 for a geometry the kernel does not take.
int pages_per_split(int B, int C, int KV, int G, int hd, int bs, int n_pages,
                    int design) {
  if (design < 0 || B < 1 || C < 1 || KV < 1 || G < 1 || bs < 1 || bs > 64 ||
      n_pages < 1 || (long long)C * G > 0x7fffffffLL)
    return 0;
  const int R = C * G;
  const int rows = rows_per_block(design, R, hd);
  const long long units = (long long)B * KV * ((R + rows - 1) / rows);
  if (units > 0x7fffffffLL) return 0;
  long long want = (kTargetBlocks + units - 1) / units;
  if (want > n_pages) want = n_pages;
  long long pps = (n_pages + want - 1) / want;
  const long long min_pages = ((long long)kKeysPerRow * rows + bs - 1) / bs;
  if (pps < min_pages) pps = min_pages;
  if (pps < (n_pages + 65534) / 65535) pps = (n_pages + 65534) / 65535;
  if (pps > kMaxPps) pps = kMaxPps;
  if (pps > n_pages) pps = n_pages;
  return static_cast<int>(pps);
}

}  // namespace

// The design a call takes: 1 the tensor-core design (bf16, hd a multiple of
// 16 up to 128, at least kMmaMinRows rows a kv head), 0 the scalar design,
// -1 a head dim or dtype the kernel does not take.
extern "C" int paged_attention_design(int dtype, int C, int G, int hd) {
  if (hd < 1 || hd > 256 || (dtype != 0 && dtype != 1)) return -1;
  return dtype == 1 && hd % 16 == 0 && hd <= kMmaMaxD &&
                 (long long)C * G >= kMmaMinRows
             ? 1
             : 0;
}

// Splits of a lane's pages (grid.y), or -1 for a geometry the kernel does
// not take.
extern "C" int paged_attention_splits(int B, int C, int KV, int G, int hd,
                                      int bs, int n_pages, int dtype) {
  const int pps = pages_per_split(B, C, KV, G, hd, bs, n_pages,
                                  paged_attention_design(dtype, C, G, hd));
  return pps < 1 ? -1 : (n_pages + pps - 1) / pps;
}

// fp32 elements of the workspace a call needs: none with one split.
extern "C" long long paged_attention_workspace_floats(int B, int C, int KV,
                                                      int G, int hd, int bs,
                                                      int n_pages, int dtype) {
  const int n = paged_attention_splits(B, C, KV, G, hd, bs, n_pages, dtype);
  if (n < 2) return 0;
  return (long long)B * KV * n * C * G * (hd + 2);
}

// q [B, C, KV, G, hd], pools [blocks, bs, KV, hd] (dtype: 0 = float32,
// 1 = bfloat16); page_table [B, n_pages], pos and n_new [B] int32; out like
// q; ws paged_attention_workspace_floats fp32 (null when that is 0).  The
// tensor-core design takes q and the pools on 16-byte boundaries.
// all_rows: 0 computes a lane's live rows and writes the rest as zeros, 1
// computes every row.  Returns the cudaError_t of the launch.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* page_table, const void* pos,
                                      const void* n_new, void* out, void* ws,
                                      int B, int C, int KV, int G, int hd,
                                      int bs, int n_pages, float scale,
                                      int dtype, int all_rows,
                                      void* stream) {
  const int design = paged_attention_design(dtype, C, G, hd);
  const int pps = pages_per_split(B, C, KV, G, hd, bs, n_pages, design);
  if (pps < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.pt = static_cast<const int*>(page_table);
  a.pos = static_cast<const int*>(pos);
  a.n_new = static_cast<const int*>(n_new);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.C = C;
  a.KV = KV;
  a.G = G;
  a.hd = hd;
  a.bs = bs;
  a.n_pages = n_pages;
  a.bs_shift = -1;
  for (int sh = 0; sh < 7; ++sh)
    if (bs == 1 << sh) a.bs_shift = sh;
  a.R = C * G;
  a.rows_blk = rows_per_block(design, a.R, hd);
  a.row_groups = (a.R + a.rows_blk - 1) / a.rows_blk;
  a.pps = pps;
  a.n_splits = (n_pages + pps - 1) / pps;
  a.kt = 0;
  a.all_rows = all_rows != 0;
  a.scale_log2 = scale * kLog2e;
  a.ml_off = (long long)B * KV * a.n_splits * a.R * hd;
  if (a.n_splits > 1 && ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int item = dtype == 1 ? 2 : 4;
  const bool aligned = (reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k_pool) |
                        reinterpret_cast<uintptr_t>(v_pool)) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(B * KV * a.row_groups),
                  static_cast<unsigned>(a.n_splits));
  const size_t spt_bytes = ((size_t)pps * 4 + 15) / 16 * 16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (design == 1) {
    if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
    const int nw = (a.rows_blk + 15) / 16;
    const size_t smem =
        spt_bytes + (size_t)mma_smem_rows(nw) * mma_pitch(hd) * 16;
    rc = launch(pick_mma(hd), grid, 32 * nw, smem, st, a);
  } else {
    a.kt = scalar_tile_keys(hd, item);
    const bool vec = aligned && (hd * item) % 16 == 0;
    const size_t ring =
        ((size_t)kScalarStages * 2 * a.kt * hd * item + 15) / 16 * 16;
    const size_t smem =
        ring + (size_t)a.rows_blk * (2 * hd + a.kt + 3) * 4 + spt_bytes;
    Kernel kernel = dtype == 0
        ? (vec ? paged_scalar_kernel<float, true>
               : paged_scalar_kernel<float, false>)
        : (vec ? paged_scalar_kernel<__nv_bfloat16, true>
               : paged_scalar_kernel<__nv_bfloat16, false>);
    rc = launch(kernel, grid, kScalarThreads, smem, st, a);
  }
  if (rc != 0 || a.n_splits == 1) return rc;
  const int merge_rows = (a.R + kMergeRows - 1) / kMergeRows;
  if (merge_rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Kernel merge = dtype == 0
      ? (hd <= 128 ? paged_merge_kernel<float, 4> : paged_merge_kernel<float, 8>)
      : (hd <= 128 ? paged_merge_kernel<__nv_bfloat16, 4>
                   : paged_merge_kernel<__nv_bfloat16, 8>);
  return launch(merge,
                dim3(static_cast<unsigned>(B * KV),
                     static_cast<unsigned>(merge_rows)),
                kMergeThreads, 0, st, a);
}
