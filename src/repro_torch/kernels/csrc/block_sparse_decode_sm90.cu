// Block-sparse flash decoding over fp or int8 K/V, redesigned for Hopper
// (sm_90a).
//
// Replaces six TPU kernel bodies of src/repro/kernels/block_sparse_decode.py:
//   block_sparse_decode        (:222; fp body _kernel :165 -> _flash_group
//                              -> _flash_accum): block_sparse_decode_sm90_launch;
//                              int8 body _kernel_quant (:170):
//                              block_sparse_decode_sm90_quant_launch;
//   block_sparse_decode_paged  (:285; fp body _kernel_paged :181): the same
//                              template with Paged = true,
//                              block_sparse_decode_sm90_paged_launch; int8
//                              body _kernel_paged_quant (:190):
//                              block_sparse_decode_sm90_paged_quant_launch;
//   block_sparse_decode_paged_splitk (:407; fp body _kernel_paged_splitk
//                              :361, int8 body _kernel_paged_splitk_quant
//                              :393, the jnp combine :499-505): the two paged
//                              entry points above at the caller's num_splits,
//                              whose segments are the reference's splits and
//                              whose combine kernel is its rescale.
//
// Contract:
//   q        [B, Hkv, G, Dh]    one new query token, grouped per kv head
//   k, v     [B, Hkv, S, Dh]    post-rope caches (bf16 or fp32, same as q,
//            or int8 codes), or, Paged, the pools [P, Hkv, ps, Dh] with
//            ps == bs and page_table [B, npt] int32 mapping a LOGICAL block
//            id to its physical page (the page id clamped at 0, as the
//            reference's kv_map does; masking stays in logical positions)
//   idx      [B, Hkv, nsel]     int32 selected block ids, -1 = padding
//   kv_len   [B] int32          valid lengths (masks the partial last block)
//   out      [B, Hkv, G, Dh]    in q's dtype
// GQA flash decode over ONLY the selected blocks, scale 1/sqrt(Dh), fp32
// online softmax and accumulation, normalised by max(l, 1e-30): a row with
// no valid key gives 0.
// Int8 K/V (value = code * scale) come with f32 scales: [B, Hkv, nsb] per
// cache block (contiguous) or [P, Hkv] per physical page (paged, the
// pool's [P, Hkv, 1] rows). A block's two scales are read at its own
// (physical) id and used only when its rows are: the K scale rides in the
// stage's score scale, s = (q . k_code) * k_scale / sqrt(Dh), and the V
// scale in each key's p before P.V, acc += (p * v_scale) * v_code, while
// l sums the plain p. Within fp32 that is the plain version's function,
// which scales every element before the dots.
//
// Bound on the H100: at the main path's shape (B = 4, Hkv = 8, G = 2,
// 64 selected blocks of 64 tokens, Dh 128) one call must read ~67 MB of
// bf16 K and V (~20 us at 3.35 TB/s), or ~34 MB of int8 codes (~10 us).
// The work is 4 * G * Dh operations a token, far below the ridge, so the
// bytes bound it; the design's job is to keep enough of them in flight on
// every SM, and, for int8, to turn codes into floats at full rate.
//
// Design:
// - Fill the card. The wrapper cuts each (b, kv-head)'s selected list into
//   ns segments of per = ceil(nsel / ns) entries (the reference's split-K
//   boundaries). For #2, #4 and their int8 bodies it picks ns from (B,
//   Hkv, nsel, the SM count) only, for about two CTAs per SM: 8 segments of
//   8 blocks, 256 CTAs at the main path's shape; split-K (5, 5q) takes the
//   caller's ns (4 on the sharded serve: 128 CTAs). A segment that starts
//   past nsel (ns > nsel) stages nothing and writes an empty partial.
//   kv_len, the pool, the page table and the dtype do not enter the plan,
//   so the same inputs give the same bits whatever the pool holds, and the
//   contiguous and paged entry points agree bitwise; 5 at ns is #4 at ns,
//   bit for bit.
//   A CTA holds gp query rows (a power of two up to 32), each lane at most
//   kMaxChunks chunks of its row: further rows of a group go to ngc =
//   ceil(G / gp) g-chunk CTAs and heads wider than 32 lanes x kMaxChunks
//   chunks to ncs column-slice CTAs (none of either at the main path's G =
//   2, Dh = 128; at granite_20b's MQA group, G 48 x Dh 128, bf16 and int8
//   take gp 8 and ngc 6, fp32 gp 4 and ngc 12; at gemma_2b's G 8 x Dh 256
//   bf16 and int8 take gp 4 and ngc 2, fp32 gp 2 and ngc 4). No register
//   array grows with G or Dh, so neither has a limit of its own. The limits
//   are the shared memory and the grid (plan_for, launch): the ring (3
//   stages of K and V rows, at least one row each) or the warps' merge
//   (kWarps x gp x (2 + Dh) floats), whichever is larger, plus the entry
//   tables, must fit 227 KB (at G 1 that refuses Dh past 9216 fp32, 14398
//   bf16 and 14270 int8; Dh 16384 in every dtype); and B x H x ns x ngc x ncs
//   CTAs must fit a grid's x dimension (2^31 - 1). Every g-chunk and
//   column-slice CTA stages the segment's blocks itself: at ngc 6 a call
//   reads its selected K and V six times (from L2 after the first).
// - Hide the copy latency. A ring of kStages shared-memory stages, each
//   one (block, row chunk)'s K and V rows (at most kStageBytes together,
//   so 64 bf16 rows of Dh 128: a whole block; an int8 block fills half a
//   stage). A page or cache block is one contiguous [bs, Dh] range, so
//   each stage is filled by 16-byte cp.async.cg copies from all threads
//   while the two stages before it are computed; rows past kv_len are
//   neither copied nor read. Where the 16-byte test fails (Dh * sizeof(KV)
//   % 16, or an unaligned base) the stage is filled by plain loads into
//   rows padded to whole chunks. Three stages of at most 32 KB: two CTAs
//   (8 warps) an SM. The segment's ids (and pages) are staged in shared
//   memory first, so a copy never waits on two dependent global loads; an
//   int8 segment's scales are staged next, while the first copies fly.
// - One CTA-wide barrier per stage, the ring's own. Each warp takes its own
//   rows of the stage (batches of up to kBatch keys) and keeps its own
//   online-softmax state (m, l, acc; exp2 with log2(e) folded into the
//   scale); the warps merge once, at the end of the segment, through
//   shared memory, in a fixed order. A batch has no branch per key: rows
//   past its end read its last row and are masked, so the compiler issues
//   the whole batch's loads together (a branch per key serialised them).
// - Lanes split the group: gp query rows (a power of two, G padded with
//   zero rows) x 32 / gp lanes a row. Each lane holds its row's q for its
//   column chunks (chunk li, li + lpg, ...) in registers and reads the same
//   chunks of each K row from shared memory (a quarter or half warp reads
//   contiguous bytes: no bank conflict); a score is the lane partials
//   summed over the row's lanes by log2(32 / gp) xor shuffles, which
//   reduce every row of the group at once. P.V then gives each lane the
//   same columns of its row: acc += p * v. A chunk is 16 bytes of fp (4
//   fp32, 8 bf16) and 8 bytes of int8 (8 codes), so at G = 2, Dh = 128
//   each of a row's 16 lanes holds one chunk of real columns in either
//   dtype (16-byte int8 chunks would leave half the lanes on padding).
//   No tensor cores: at G = 2 there is nothing for them to do.
// - Int8 codes become floats without the conversion unit (cvt.f32.s8 runs
//   at 16 results a clock an SM on sm_90, slower than the bytes arrive):
//   one XOR flips the four sign bits of a 32-bit word, one byte permute
//   (PRMT) a code sets c + 128 in the low mantissa bits of 2^23, and one
//   FADD of -(2^23 + 128) leaves exactly (float)c, for every c in
//   -128..127. Integer ops and one FADD, all at full rate.
// - The segment partials (ns > 1) go to an f32 workspace [B, H, ns, G, Dh]
//   (acc), then [B, H, ns, G] (m, -inf for a segment with no valid key)
//   and [B, H, ns, G] (l), and a second small kernel combines them in split
//   order with the reference's two-pass rescale (block_sparse_decode.py:
//   499-505): m = max_s m_s, r_s = (l_s > 0) ? exp(m_s - m) : 0,
//   l = sum_s r_s l_s, o = sum_s r_s acc_s / max(l, 1e-30). At ns == 1 the
//   CTA writes o itself: one launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 16;                // keys a warp scores before its softmax update
constexpr int kStages = 3;                // depth of the shared-memory ring
constexpr int kStageBytes = 32 * 1024;    // K + V rows of one stage
constexpr size_t kMaxSmem = 227 * 1024;   // dynamic shared memory an SM grants a CTA
constexpr int kMaxChunks = 4;             // column chunks a lane holds of its row
constexpr int kTab = 256;                 // selected entries a CTA keeps in shared memory

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scales;  // int8 K/V: [B, H, nsb] or, paged, [P, H]
  const float* v_scales;
  const int* idx;
  const int* page_table;
  const int* kv_len;
  void* out;
  float* part;
  int H, G, Dh, S, npt, nsel, bs;
  int nsb;    // scales per (b, h) row of the contiguous int8 cache
  int ns;     // segments of each selected list
  int gp;     // query rows a CTA holds (a power of two <= 32)
  int ngc;    // CTAs over the group: ceil(G / gp)
  int ncs;    // CTAs over the columns (Dh wider than 32 lanes x kMaxChunks chunks)
  int rows;   // K/V rows a stage holds
  int ldr;    // shared-memory row stride in elements (Dh padded to whole chunks)
  int vec;    // 16-byte cp.async copies (rows contiguous and 16-byte aligned)
  float scale;
};

// A lane's chunk of a K or V row: 16 bytes of fp, 8 bytes (8 codes) of int8.
template <typename KV>
struct Lane {
  using Chunk = uint4;
  static constexpr int kElems = 16 / sizeof(KV);
};
template <>
struct Lane<int8_t> {
  using Chunk = uint2;
  static constexpr int kElems = 8;
};

template <typename KV>
constexpr bool kQuant = std::is_same<KV, int8_t>::value;

constexpr float kInt8Magic = 8388736.f;  // 2^23 + 128

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return __uint_as_float(0x4B000000u | ((uint32_t)(uint8_t)x ^ 0x80u)) - kInt8Magic;
}
__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* o) { *o = __float2bfloat16(x); }

// the floats of one chunk: 4 fp32, 8 bf16 or 8 int8 codes (element 0 in
// the low bits)
__device__ __forceinline__ void unpack(const uint4& u, float* x, const float*) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* x, const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// code c -> bits 0x4B0000uu with uu = c ^ 0x80 = c + 128 (the float 2^23 +
// c + 128), then one FADD: exactly (float)c
__device__ __forceinline__ void unpack(const uint2& u, float* x, const int8_t*) {
  const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[4 * i + j] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540u | j)) - kInt8Magic;
}

// one shared-memory read of a chunk (an LDS.128, or LDS.64 for int8)
__device__ __forceinline__ void lds(const void* p, uint4& u) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "r"(a));
}
__device__ __forceinline__ void lds(const void* p, uint2& u) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(u.x), "=r"(u.y) : "r"(a));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The physical page of logical block blk of row b (npt table entries a
// row), the id clamped at 0 as the reference's kv_map clamps it.
__device__ __forceinline__ int phys_page(const int* __restrict__ page_table, int b, int npt,
                                         int blk) {
  return max(page_table[(size_t)b * npt + blk], 0);
}

// Offset of the first element of a block of (b, h): logical block blk's
// rows of the contiguous cache [B, H, S, Dh], or physical page phys of the
// pool [P, H, ps, Dh].
template <bool Paged>
__device__ __forceinline__ size_t block_offset(int b, int h, int H, int S, int Dh, int bs,
                                               int blk, int phys) {
  if (Paged) return ((size_t)phys * H + h) * bs * Dh;
  return (((size_t)b * H + h) * S + (size_t)blk * bs) * Dh;
}

// Index of a block's int8 scales: (b, h, blk) of the contiguous cache's
// [B, H, nsb], or the scale row of its PHYSICAL page in [P, H] (as
// _kernel_paged_quant's lookup reads it).
template <bool Paged>
__device__ __forceinline__ size_t scale_index(const Params& p, int b, int h, int blk, int phys) {
  if (Paged) return (size_t)phys * p.H + h;
  return ((size_t)b * p.H + h) * p.nsb + blk;
}

// (K scale, V scale) of logical block blk (physical page phys)
template <bool Paged>
__device__ __forceinline__ float2 block_scales(const Params& p, int b, int h, int blk,
                                               int phys) {
  const size_t si = scale_index<Paged>(p, b, h, blk, phys);
  return make_float2(p.k_scales[si], p.v_scales[si]);
}

// Walks a segment's (block, row chunk) items that hold valid rows, in
// order: -1 padding and blocks wholly past kv_len are skipped. The producer
// (copies) and the consumer (compute) each run one, kStages - 1 items apart.
// The segment's first kTab ids (and, paged, their pages) sit in shared
// memory (tab, tabp); later ones are read from global memory.
struct Walk {
  int j, c;  // next entry of the segment, next chunk of its block
  __device__ __forceinline__ bool next(const int* __restrict__ irow, const int* tab, int j0,
                                       int j1, int bs, int len, int rows, int& e, int& r0,
                                       int& nr) {
    while (j < j1) {
      const int bl = j - j0 < kTab ? tab[j - j0] : irow[j];
      const int nt = bl < 0 ? 0 : min(bs, len - bl * bs);  // valid rows of this block
      if (c * rows < nt) {
        e = j;
        r0 = c * rows;
        nr = min(rows, nt - r0);
        ++c;
        return true;
      }
      ++j;
      c = 0;
    }
    return false;
  }
};

// q . k over this lane's chunks of one K row: chunk k at row[k * step], step
// = lpg * V elements (rows are padded with zeros to whole chunks, so every
// chunk is a whole shared-memory read)
template <typename KV, int NCH>
__device__ __forceinline__ float lane_dot(const float* qr, const KV* row, int step) {
  constexpr int V = Lane<KV>::kElems;
  float d = 0.f;
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    typename Lane<KV>::Chunk u;
    lds(row + k * step, u);
    float x[V];
    unpack(u, x, row);
#pragma unroll
    for (int e = 0; e < V; ++e) d = fmaf(qr[k * V + e], x[e], d);
  }
  return d;
}

// acc += p * v over this lane's chunks of one V row
template <typename KV, int NCH>
__device__ __forceinline__ void lane_axpy(float* acc, float p, const KV* row, int step) {
  constexpr int V = Lane<KV>::kElems;
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    typename Lane<KV>::Chunk u;
    lds(row + k * step, u);
    float x[V];
    unpack(u, x, row);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[k * V + e] = fmaf(p, x[e], acc[k * V + e]);
  }
}

// The lane's share of q . k over the row's OTHER column slices, where Dh
// takes more than one (ncs > 1): q read from global memory
template <typename T, typename KV, int NCH>
__device__ __noinline__ float other_slices_dot(const T* qg, const KV* row, int li, int lpg,
                                               int Dh, int cs, int ncs) {
  constexpr int V = Lane<KV>::kElems;
  float d = 0.f;
  for (int sl = 0; sl < ncs; ++sl) {
    if (sl == cs) continue;
    for (int k = 0; k < NCH; ++k) {
      const int c0 = (sl * lpg * NCH + li + lpg * k) * V;
      for (int e = 0; e < V; ++e)
        if (c0 + e < Dh) d = fmaf(to_f32(qg[c0 + e]), to_f32(row[c0 + e]), d);
    }
  }
  return d;
}

// Copy nr valid rows of one block (from row r0) of K and of V into a stage
// (rows of ldr elements; the pad columns past Dh stay zero).
template <typename KV, bool Paged>
__device__ __forceinline__ void fill_stage(KV* dk, const Params& p, int b, int h, int blk,
                                           int phys, int r0, int nr) {
  constexpr int C = 16 / sizeof(KV);  // elements of a 16-byte copy
  KV* dv = dk + (size_t)p.rows * p.ldr;
  const size_t off = block_offset<Paged>(b, h, p.H, p.S, p.Dh, p.bs, blk, phys) +
                     (size_t)r0 * p.Dh;
  const KV* ks = static_cast<const KV*>(p.k) + off;
  const KV* vs = static_cast<const KV*>(p.v) + off;
  if (p.vec && p.ldr == p.Dh) {  // one contiguous range
    const int n = nr * p.Dh / C;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      cp_async16(dk + i * C, ks + i * C);
      cp_async16(dv + i * C, vs + i * C);
    }
  } else if (p.vec) {
    const int cpr = p.Dh / C;  // copies a row
    const int n = nr * cpr;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / cpr;
      const int dst = r * p.ldr + (i - r * cpr) * C;
      cp_async16(dk + dst, ks + i * C);
      cp_async16(dv + dst, vs + i * C);
    }
  } else {
    const int n = nr * p.Dh;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / p.Dh, d = i - r * p.Dh;
      dk[r * p.ldr + d] = ks[i];
      dv[r * p.ldr + d] = vs[i];
    }
  }
}

// CTA blockIdx.x = (((b * H + h) * ns + s) * ngc + gc) * ncs + cs reduces
// segment s of (b, h)'s selected list for query rows [gc * gp, min((gc + 1)
// * gp, G)) and column slice cs (all of Dh where ncs == 1). Scores, m and
// the partials' m are in log2 units (the softmax runs on exp2). T: q and
// out; KV: the cache elements (T, or int8_t codes with f32 scales).
template <typename T, typename KV, bool Paged, int NCH>
__global__ void __launch_bounds__(kThreads) sparse_decode_sm90(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool Quant = kQuant<KV>;
  constexpr int V = Lane<KV>::kElems;
  constexpr int E = NCH * V;  // columns a lane holds
  const int cs = blockIdx.x % p.ncs;
  const int gci = (blockIdx.x / p.ncs) % p.ngc;
  const int rest = blockIdx.x / (p.ncs * p.ngc);
  const int split = rest % p.ns;
  const int bh = rest / p.ns;
  const int b = bh / p.H, h = bh - b * p.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lpg = 32 / p.gp;                          // lanes of a query row
  const int gl = lane / lpg, li = lane - gl * lpg;    // row in the CTA, lane in the row
  const int g = gci * p.gp + gl;
  const int cb = cs * lpg * E;                        // first column of the slice
  const int lcol = cb + li * V;                       // the lane's first column
  const int step = lpg * V;                           // from one of its chunks to the next
  const float scale0 = p.scale * 1.4426950408889634f; // 1/sqrt(Dh) in log2 units

  // the segment: the reference's split-K boundaries
  const int per = (p.nsel + p.ns - 1) / p.ns;
  const int j0 = split * per;
  const int j1 = min(j0 + per, p.nsel);
  const int len = min(p.kv_len[b], p.S);
  const int* irow = p.idx + (size_t)bh * p.nsel;

  float qr[E], acc[E];
  const T* qg = static_cast<const T*>(p.q) + ((size_t)bh * p.G + min(g, p.G - 1)) * p.Dh;
#pragma unroll
  for (int k = 0; k < NCH; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int col = lcol + k * step + e;
      qr[k * V + e] = (g < p.G && col < p.Dh) ? to_f32(qg[col]) : 0.f;
      acc[k * V + e] = 0.f;
    }
  float m = kNegInf, l = 0.f;

  // the ring, then the segment's ids, pages and (int8) scales; zero the
  // ring once where rows are padded: the pad columns past Dh are read
  // (times q = 0) and must hold finite values
  KV* ring = reinterpret_cast<KV*>(smem);
  const size_t stage_elems = 2 * (size_t)p.rows * p.ldr;  // K rows, then V rows
  int* tab = reinterpret_cast<int*>(ring + kStages * stage_elems);
  int* tabp = tab + kTab;
  float2* tsc = reinterpret_cast<float2*>(tabp + kTab);
  if (p.ldr != p.Dh) {
    uint4* z = reinterpret_cast<uint4*>(ring);
    const int nz = (int)(kStages * stage_elems * sizeof(KV) / 16);
    for (int i = threadIdx.x; i < nz; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  const int nt = min(j1 - j0, kTab);
  for (int i = threadIdx.x; i < nt; i += kThreads) {
    const int bl = irow[j0 + i];
    tab[i] = bl;
    if (Paged) tabp[i] = bl < 0 ? 0 : phys_page(p.page_table, b, p.npt, bl);
  }
  __syncthreads();
  // entry e's block and page
  auto entry = [&](int e, int& bl, int& phys) {
    const bool staged = e - j0 < kTab;
    bl = staged ? tab[e - j0] : irow[e];
    phys = 0;
    if (Paged) phys = staged ? tabp[e - j0] : phys_page(p.page_table, b, p.npt, bl);
  };
  // the producer's item: entry e, rows [r0, r0 + nr)
  auto fill = [&](int st, int e, int r0, int nr) {
    int bl, phys;
    entry(e, bl, phys);
    fill_stage<KV, Paged>(ring + st * stage_elems, p, b, h, bl, phys, r0, nr);
  };
  Walk prod{j0, 0}, cons{j0, 0};
  int e, r0, nr;
  for (int s = 0; s < kStages - 1; ++s) {
    if (prod.next(irow, tab, j0, j1, p.bs, len, p.rows, e, r0, nr)) fill(s, e, r0, nr);
    cp_async_commit();
  }
  // int8: the staged entries' scales, read while the first copies fly (the
  // first stage's barrier publishes them); -1 padding reads none
  if (Quant) {
    for (int i = threadIdx.x; i < nt; i += kThreads) {
      const int bl = tab[i];
      tsc[i] = bl < 0 ? make_float2(0.f, 0.f)
                      : block_scales<Paged>(p, b, h, bl, Paged ? tabp[i] : 0);
    }
  }
  int stage = 0;
  while (cons.next(irow, tab, j0, j1, p.bs, len, p.rows, e, r0, nr)) {
    cp_async_wait<kStages - 2>();  // this thread's copies of the stage have landed
    __syncthreads();               // everyone's have; the previous stage is free
    {
      int pe, pr0, pnr;
      if (prod.next(irow, tab, j0, j1, p.bs, len, p.rows, pe, pr0, pnr))
        fill((stage + kStages - 1) % kStages, pe, pr0, pnr);
      cp_async_commit();
    }
    // the stage's (K, V) scales: 1 for fp; the block's own for int8
    float2 sc = make_float2(1.f, 1.f);
    if (Quant) {
      if (e - j0 < kTab) {
        sc = tsc[e - j0];
      } else {
        int bl, phys;
        entry(e, bl, phys);
        sc = block_scales<Paged>(p, b, h, bl, phys);
      }
    }
    const float scale2 = scale0 * sc.x;
    const KV* ks = ring + stage * stage_elems;
    const KV* vs = ks + (size_t)p.rows * p.ldr;
    // the warps split the stage's nr rows into batches of bz keys
    const int bz = max(1, min(kBatch, (nr + kWarps - 1) / kWarps));
    for (int rb = warp * bz; rb < nr; rb += kWarps * bz) {
      const int nb = min(bz, nr - rb);  // keys of this batch (the same on every lane)
      const KV* kb = ks + (size_t)rb * p.ldr + lcol;
      // keys past nb read the batch's last row (no branch: the loads of the
      // whole batch issue together) and are masked below
      float s[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t)
        s[t] = lane_dot<KV, NCH>(qr, kb + (size_t)min(t, nb - 1) * p.ldr, step);
      if (p.ncs > 1 && g < p.G) {
#pragma unroll
        for (int t = 0; t < kBatch; ++t)
          if (t < nb)
            s[t] += other_slices_dot<T, KV, NCH>(qg, kb - lcol + (size_t)t * p.ldr, li, lpg,
                                                 p.Dh, cs, p.ncs);
      }
      // sum the lane partials over the row's lanes: every row of the group
      // at once, one level for all the batch's keys at a time
      for (int o = lpg >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int t = 0; t < kBatch; ++t) s[t] += __shfl_xor_sync(0xffffffffu, s[t], o);
      }
      // online-softmax update over the batch (every lane of a row holds all
      // of the row's scores)
      float mx = m;
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        s[t] = (t < nb) ? s[t] * scale2 : kNegInf;
        mx = fmaxf(mx, s[t]);
      }
      const float alpha = exp2f(m - mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        // guard: a masked key would give exp(NEG_INF - NEG_INF) = 1
        s[t] = (s[t] > kNegInf / 2) ? exp2f(s[t] - mx) : 0.f;
        sum += s[t];
      }
      l = alpha * l + sum;
      m = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= alpha;
      const KV* vb = vs + (size_t)rb * p.ldr + lcol;
#pragma unroll
      for (int t = 0; t < kBatch; ++t)  // p = 0 past nb
        lane_axpy<KV, NCH>(acc, s[t] * sc.y, vb + (size_t)min(t, nb - 1) * p.ldr, step);
    }
    stage = (stage + 1) % kStages;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' states now

  // merge the warps' states, in warp order: [kWarps][gp] m and l, then
  // [kWarps][gp][Dh] acc (this slice's columns)
  float* mw = reinterpret_cast<float*>(smem);
  float* lw = mw + kWarps * p.gp;
  float* aw = lw + kWarps * p.gp;
  if (li == 0) {
    mw[warp * p.gp + gl] = m;
    lw[warp * p.gp + gl] = l;
  }
#pragma unroll
  for (int k = 0; k < NCH; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int col = lcol + k * step + e;
      if (col < p.Dh) aw[(size_t)(warp * p.gp + gl) * p.Dh + col] = acc[k * V + e];
    }
  __syncthreads();
  const int gc = min(p.gp, p.G - gci * p.gp);
  const int cw = min(lpg * E, p.Dh - cb);  // columns of the slice
  for (int i = threadIdx.x; i < gc * cw; i += kThreads) {
    const int r = i / cw, d = cb + i - r * cw;
    float mm = -INFINITY;
    for (int w = 0; w < kWarps; ++w)
      if (lw[w * p.gp + r] > 0.f) mm = fmaxf(mm, mw[w * p.gp + r]);
    float ll = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float lv = lw[w * p.gp + r];
      if (lv > 0.f) {
        const float f = exp2f(mw[w * p.gp + r] - mm);
        ll += f * lv;
        a += f * aw[(size_t)(w * p.gp + r) * p.Dh + d];
      }
    }
    const size_t row = (size_t)bh * p.G + gci * p.gp + r;
    if (p.ns == 1) {
      from_f32(a / fmaxf(ll, 1e-30f), static_cast<T*>(p.out) + row * p.Dh + d);
    } else {
      // the unnormalised partial of this segment: m is -inf when it held
      // no valid key
      const size_t BH = (size_t)gridDim.x / ((size_t)p.ns * p.ngc * p.ncs);
      const size_t prow = ((size_t)bh * p.ns + split) * p.G + gci * p.gp + r;
      p.part[prow * p.Dh + d] = a;
      if (d == 0) {  // column 0 lies in slice 0
        float* pm = p.part + BH * p.ns * p.G * p.Dh;
        pm[prow] = (ll > 0.f) ? mm : -INFINITY;
        pm[BH * p.ns * p.G + prow] = ll;
      }
    }
  }
}

// Combine the ns segment partials of each (b, h, g) (the workspace layout
// above, m in log2 units; BH = B * H): one thread per output element, the
// reference's two-pass rescale in fp32, in split order.
template <typename T>
__global__ void __launch_bounds__(256)
sm90_combine(const float* __restrict__ part, T* __restrict__ out, int BH, int G, int Dh, int ns) {
  const int GD = G * Dh;
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= (size_t)BH * GD) return;
  const size_t bh = e / GD;
  const int r = (int)(e - bh * GD), g = r / Dh;
  const float* acc = part + bh * ns * GD + r;                        // + s * GD
  const float* pm = part + (size_t)BH * ns * GD + bh * ns * G + g;   // + s * G
  const float* pl = pm + (size_t)BH * ns * G;
  float m = -INFINITY;
  for (int s = 0; s < ns; ++s) m = fmaxf(m, pm[s * G]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float ls = pl[s * G];
    const float rs = (ls > 0.f) ? exp2f(pm[s * G] - m) : 0.f;
    l += rs * ls;
    o += rs * acc[(size_t)s * GD];
  }
  from_f32(o / fmaxf(l, 1e-30f), out + e);
}

constexpr int kMaxDevices = 64;

// Raises the instance's dynamic shared-memory limit on the current device
// to at least smem, once: the largest limit set so far is kept per device,
// so a call that needs no more than it makes no runtime call (a repeated
// cudaFuncSetAttribute is host time on every launch).
template <typename T, typename KV, bool Paged, int NCH>
int reserve_smem(size_t smem) {
  static int set_to[kMaxDevices] = {};  // bytes, per device (0: the 48 KB default)
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && set_to[dev] >= (int)smem) return 0;
  e = cudaFuncSetAttribute(sparse_decode_sm90<T, KV, Paged, NCH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices) set_to[dev] = (int)smem;
  return 0;
}

template <typename T, typename KV, bool Paged, int NCH>
int launch_body(const Params& p, int grid, size_t smem, cudaStream_t stream) {
  const int rc = reserve_smem<T, KV, Paged, NCH>(smem);
  if (rc != 0) return rc;
  sparse_decode_sm90<T, KV, Paged, NCH><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// How a CTA cuts the group and the head (see the design notes): gp rows a
// CTA, ngc CTAs over the group, ncs column slices, nch chunks a lane of its
// slice (nchb those of the instance: 1, 2 or kMaxChunks), ldr the padded
// row, rows the K/V rows a stage holds, smem the dynamic shared memory.
struct Plan {
  int gp, ngc, ncs, nch, nchb, ldr, rows;
  size_t smem;
};

// kv_bytes: the size of a K/V element; V: elements of a lane's chunk
Plan plan_for(int G, int Dh, int bs, int kv_bytes, int V, bool quant) {
  Plan pl{};
  // rows of the group a CTA holds: as many as leave each lane at most
  // kMaxChunks chunks of its row (all of G where G * Dh fits 32 lanes x
  // kMaxChunks chunks); a row wider than one lane-set takes ncs CTAs
  const int chunks = (Dh + V - 1) / V;
  auto nch_of = [&](int gp) { const int lpg = 32 / gp; return (chunks + lpg - 1) / lpg; };
  int gp = 1;
  while (gp < G && gp < 32) gp <<= 1;
  while (gp > 1 && nch_of(gp) > kMaxChunks) gp >>= 1;
  pl.gp = gp;
  pl.ncs = (nch_of(gp) + kMaxChunks - 1) / kMaxChunks;
  pl.nch = (nch_of(gp) + pl.ncs - 1) / pl.ncs;
  pl.ngc = (G + gp - 1) / gp;
  pl.nchb = pl.nch <= 1 ? 1 : pl.nch <= 2 ? 2 : kMaxChunks;  // the instance's chunks a lane
  pl.ldr = pl.ncs * (32 / gp) * pl.nchb * V;                 // every lane's chunks, zero-padded
  pl.rows = max(1, min(bs, kStageBytes / (2 * pl.ldr * kv_bytes)));
  const size_t ring = (size_t)kStages * 2 * pl.rows * pl.ldr * kv_bytes;
  const size_t merge = (size_t)kWarps * gp * (2 + Dh) * sizeof(float);
  const size_t tabs = kTab * (2 * sizeof(int) + (quant ? sizeof(float2) : 0));
  pl.smem = (ring > merge ? ring : merge) + tabs;
  return pl;
}

template <typename T, typename KV, bool Paged>
int launch(Params p, int B, cudaStream_t stream) {
  const Plan pl = plan_for(p.G, p.Dh, p.bs, (int)sizeof(KV), Lane<KV>::kElems, kQuant<KV>);
  p.gp = pl.gp;
  p.ngc = pl.ngc;
  p.ncs = pl.ncs;
  p.ldr = pl.ldr;
  p.rows = pl.rows;
  p.vec = ((uintptr_t)p.k % 16 == 0) && ((uintptr_t)p.v % 16 == 0) &&
          ((p.Dh * sizeof(KV)) % 16 == 0);
  const int nch = pl.nch;
  const size_t smem = pl.smem;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long grid = (long long)B * p.H * p.ns * p.ngc * p.ncs;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int rc;
  if (nch <= 1)
    rc = launch_body<T, KV, Paged, 1>(p, (int)grid, smem, stream);
  else if (nch <= 2)
    rc = launch_body<T, KV, Paged, 2>(p, (int)grid, smem, stream);
  else
    rc = launch_body<T, KV, Paged, kMaxChunks>(p, (int)grid, smem, stream);
  if (rc != 0 || p.ns == 1) return rc;
  const size_t total = (size_t)B * p.H * p.G * p.Dh;
  sm90_combine<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      p.part, static_cast<T*>(p.out), B * p.H, p.G, p.Dh, p.ns);
  return (int)cudaGetLastError();
}

// quant: int8 K/V with f32 scales (p.k_scales, p.v_scales); otherwise K/V
// in q's dtype
template <bool Paged>
int dispatch(Params p, int B, int dtype, bool quant, void* stream) {
  if (B <= 0 || p.H <= 0 || p.G <= 0 || p.Dh <= 0 || p.S <= 0 || p.nsel <= 0 || p.bs <= 0 ||
      p.ns <= 0 || (Paged && p.npt <= 0) || (p.ns > 1 && p.part == nullptr) ||
      (quant && (p.k_scales == nullptr || p.v_scales == nullptr ||
                 (!Paged && (long long)p.nsb * p.bs < p.S))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return quant ? launch<float, int8_t, Paged>(p, B, s) : launch<float, float, Paged>(p, B, s);
  if (dtype == 1)
    return quant ? launch<__nv_bfloat16, int8_t, Paged>(p, B, s)
                 : launch<__nv_bfloat16, __nv_bfloat16, Paged>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v, const void* k_scales,
                   const void* v_scales, const void* idx, const void* page_table,
                   const void* kv_len, void* out, void* workspace, int H, int G, int Dh, int S,
                   int npt, int nsb, int nsel, int bs, int num_splits, float scale) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.idx = static_cast<const int*>(idx);
  p.page_table = static_cast<const int*>(page_table);
  p.kv_len = static_cast<const int*>(kv_len);
  p.out = out;
  p.part = static_cast<float*>(workspace);
  p.H = H;
  p.G = G;
  p.Dh = Dh;
  p.S = S;
  p.npt = npt;
  p.nsb = nsb;
  p.nsel = nsel;
  p.bs = bs;
  p.ns = num_splits;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q and out; fp K/V too). num_splits
// segments of each selected list; num_splits > 1 needs workspace of B * H *
// num_splits * (G * Dh + 2 * G) floats and launches the combine after the
// body. Each entry point returns cudaGetLastError() after its launches.
int block_sparse_decode_sm90_launch(const void* q, const void* k, const void* v, const void* idx,
                                    const void* kv_len, void* out, void* workspace, int B, int H,
                                    int G, int Dh, int S, int nsel, int bs, int num_splits,
                                    float scale, int dtype, void* stream) {
  return dispatch<false>(make_params(q, k, v, nullptr, nullptr, idx, nullptr, kv_len, out,
                                     workspace, H, G, Dh, S, 0, 0, nsel, bs, num_splits, scale),
                         B, dtype, false, stream);
}

// k_pages, v_pages [P, H, ps, Dh] with ps == bs; page_table [B, npt]. Blocks
// are masked in logical positions against kv_len, up to npt * ps.
int block_sparse_decode_sm90_paged_launch(const void* q, const void* k_pages,
                                          const void* v_pages, const void* idx,
                                          const void* page_table, const void* kv_len, void* out,
                                          void* workspace, int B, int H, int G, int Dh, int npt,
                                          int nsel, int bs, int num_splits, float scale,
                                          int dtype, void* stream) {
  return dispatch<true>(make_params(q, k_pages, v_pages, nullptr, nullptr, idx, page_table,
                                    kv_len, out, workspace, H, G, Dh, npt * bs, npt, 0, nsel, bs,
                                    num_splits, scale),
                        B, dtype, false, stream);
}

// int8 k, v [B, H, S, Dh]; k_scales, v_scales [B, H, nsb] float32 with
// nsb * bs >= S (one scale per cache block). dtype is q's and out's.
int block_sparse_decode_sm90_quant_launch(const void* q, const void* k, const void* v,
                                          const void* k_scales, const void* v_scales,
                                          const void* idx, const void* kv_len, void* out,
                                          void* workspace, int B, int H, int G, int Dh, int S,
                                          int nsb, int nsel, int bs, int num_splits, float scale,
                                          int dtype, void* stream) {
  return dispatch<false>(make_params(q, k, v, k_scales, v_scales, idx, nullptr, kv_len, out,
                                     workspace, H, G, Dh, S, 0, nsb, nsel, bs, num_splits, scale),
                         B, dtype, true, stream);
}

// int8 k_pages, v_pages [P, H, ps, Dh]; k_scales, v_scales [P, H] float32
// (one row per physical page); page_table [B, npt]. dtype is q's and out's.
int block_sparse_decode_sm90_paged_quant_launch(const void* q, const void* k_pages,
                                                const void* v_pages, const void* k_scales,
                                                const void* v_scales, const void* idx,
                                                const void* page_table, const void* kv_len,
                                                void* out, void* workspace, int B, int H, int G,
                                                int Dh, int npt, int nsel, int bs, int num_splits,
                                                float scale, int dtype, void* stream) {
  return dispatch<true>(make_params(q, k_pages, v_pages, k_scales, v_scales, idx, page_table,
                                    kv_len, out, workspace, H, G, Dh, npt * bs, npt, 0, nsel, bs,
                                    num_splits, scale),
                        B, dtype, true, stream);
}

// The plan a launch of these shapes takes (dtype and quant as above):
// out[0..5] = gp, ngc, ncs, chunks a lane, K/V rows a stage, shared-memory
// bytes. Returns cudaErrorInvalidValue where the launch would refuse the
// shapes (the shared memory past 227 KB), else 0.
int block_sparse_decode_sm90_plan(int G, int Dh, int bs, int dtype, int quant, long long* out) {
  if (G <= 0 || Dh <= 0 || bs <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const int kv_bytes = quant ? 1 : dtype == 0 ? 4 : 2;
  const int V = quant ? Lane<int8_t>::kElems : dtype == 0 ? Lane<float>::kElems
                                                           : Lane<__nv_bfloat16>::kElems;
  const Plan pl = plan_for(G, Dh, bs, kv_bytes, V, quant != 0);
  const long long v[6] = {pl.gp, pl.ngc, pl.ncs, pl.nch, pl.rows, (long long)pl.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return pl.smem > kMaxSmem ? (int)cudaErrorInvalidValue : 0;
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
