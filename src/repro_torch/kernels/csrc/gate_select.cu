// Fused gate scoring + exact top-k block selection for one decode step,
// redesigned for Hopper (sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/gate_select.py:
//   fused_gate_select        (:133; body _select_kernel, selection core
//                            _rank_and_pick :73): gate_select_launch below;
//   fused_gate_select_paged  (:218; body _select_paged_kernel, the same
//                            core): the template with Paged = true,
//                            gate_select_paged_launch.
// Contiguous contract:
//   qg      [B, Hkv, Dg]       post-rope gate query (bf16 or fp32)
//   kg      [B, Hkv, nb, Dg]   head-major K-compression cache (same dtype)
//   n_valid [B] int32          visible blocks
//   out     [B, Hkv, k] int32  selected block ids, -1 padding
// For each (b, kv-head), as _rank_and_pick: score = qg . Kg^T * (1/sqrt(Dg))
// in fp32; blocks at or past n_valid are masked to NEG_INF; the threshold
// method takes a softmax over the masked logits and admits probabilities
// > tau; the first and last visible blocks are pinned (1e30); the ids come
// in descending value, the LOWER index first on ties (the reference's
// iterative argmax, jax.lax.top_k's order), -1 where the value is at or
// below the cutoff (budget NEG_INF/2, threshold 0) and as padding.
// Paged contract: kg is the pool kg_pages [P, Hkv, Dg] (one row per
// physical page) and page_table [B, npt] int32 maps logical block j to its
// page; nb = npt. Entries at or past n_valid (the null page 0, or stale
// ids) are masked before ranking, so neither they nor their rows are read.
//
// Bound on the H100: at the main path's shape (B 4, Hkv 8, nb 257, Dg 128,
// bf16) a call reads ~2.1 MB of Kg (~0.6 us at 3.35 TB/s), less than a
// launch's own latency. What bounds it is the chain of serial steps in one
// CTA: rounds of dependent global loads and CTA-wide barriers. The previous
// body loaded ~33 rows a warp one after another and ran k_sel rounds of a
// CTA-wide argmax (two barriers each, 128 at k 64, thread 0 alone
// combining the warps' candidates).
//
// Design: one CTA of kThreads (512; 256 measured slower) per (b, kv-head);
// everything after the loads lives in shared memory.
// - Stage: q (as fp32) and, paged, the slot's page-table row [0, n_valid)
//   (the null page 0 past it) are copied into shared memory together, one
//   coalesced read each, one barrier: no row load then waits behind a
//   dependent table load in device memory.
// - Score: a row is read in 16-byte chunks (8 bf16 or 4 fp32 a lane); the
//   L lanes (a power of two >= the chunks a row, at most 32) of a group
//   share a row, 32 / L rows a warp instruction, and each lane loads its
//   chunk of kUnroll row groups before it sums any, with no branch between
//   the loads (a masked block's lanes read row 0 and drop the sum), so a
//   warp keeps kUnroll loads in flight; the kUnroll shuffle trees (log2(L)
//   steps each) run side by side. At the main path: 16 lanes a row, 2 rows
//   an instruction, 256 rows a pass of the CTA.
//   Where Dg * sizeof(T) is not a multiple of 16 or the base is not 16-byte
//   aligned, the same loop runs with one-element chunks.
// - Rank: each ranked value, clamped at the cutoff (all values at or below
//   it give -1, whatever their order), becomes an order-preserving 32-bit
//   key (-0.0 first made +0.0, so that equal values compare equal). Pass 0
//   of the select builds its histogram in the same loop.
// - Select: a radix select over the keys, up to 4 passes of 8 bits from the
//   top, finds the bin of K*, the k_sel-th largest key, and k_left, how many
//   of the bin's keys are taken; it stops early once that is the whole bin.
//   Shared-memory histograms with warp-aggregated atomics; one warp scans
//   the 256 bins; two barriers a pass.
// - Place: every slot is first set to -1. The warps walk the keys in index
//   order with ballots. Where the bin is a single key K* taken in part, its
//   first k_left keys take slots g .. k_sel - 1 in index order (g = k_sel -
//   k_left); the g keys above it (or, the bin taken whole, all k_sel keys
//   from the bin up) go to a list, whose entries each take the slot given
//   by the number of listed entries that beat them (a larger key, or an
//   equal key and the lower index), counted by P lanes together:
//   O(g^2 / kThreads) shared-memory compares, 8 a lane at k 64.
// At most 12 barriers a call whatever k_sel (4 more for the threshold
// method's softmax), and no step on one thread alone. The grid stays B * Hkv
// CTAs. Limits: nb <= kMaxBlocks, Dg <= kMaxDg (shared memory: the scores,
// the survivor list and, paged, the table row it overlays).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef GATE_SELECT_THREADS
#define GATE_SELECT_THREADS 512
#endif

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kBig = 1e30f;
constexpr int kThreads = GATE_SELECT_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;           // row groups whose loads a lane issues together
constexpr int kMaxBlocks = 16384;    // keep in step with gate_select.py's MAX_BLOCKS
constexpr int kMaxDg = 1024;         // and MAX_DG
constexpr int kMaxDevices = 64;
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// A chunk of a Kg row: 16 bytes (Vec), or one element.
template <typename T, bool Vec>
struct Chunk {
  static constexpr int N = 1;
  float v;
  __device__ __forceinline__ void load(const T* p) { v = to_f32(*p); }
  __device__ __forceinline__ float dot(const float* q, float acc) const {
    return fmaf(q[0], v, acc);
  }
};

template <>
struct Chunk<__nv_bfloat16, true> {
  static constexpr int N = 8;
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  // element 2i is the low half of word i, 2i + 1 the high half
  __device__ __forceinline__ float dot(const float* q, float acc) const {
    const float4 a = *reinterpret_cast<const float4*>(q);
    const float4 b = *reinterpret_cast<const float4*>(q + 4);
    acc = fmaf(a.x, __uint_as_float(w.x << 16), acc);
    acc = fmaf(a.y, __uint_as_float(w.x & 0xffff0000u), acc);
    acc = fmaf(a.z, __uint_as_float(w.y << 16), acc);
    acc = fmaf(a.w, __uint_as_float(w.y & 0xffff0000u), acc);
    acc = fmaf(b.x, __uint_as_float(w.z << 16), acc);
    acc = fmaf(b.y, __uint_as_float(w.z & 0xffff0000u), acc);
    acc = fmaf(b.z, __uint_as_float(w.w << 16), acc);
    return fmaf(b.w, __uint_as_float(w.w & 0xffff0000u), acc);
  }
};

template <>
struct Chunk<float, true> {
  static constexpr int N = 4;
  float4 w;
  __device__ __forceinline__ void load(const float* p) {
    w = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ float dot(const float* q, float acc) const {
    const float4 a = *reinterpret_cast<const float4*>(q);
    acc = fmaf(a.x, w.x, acc);
    acc = fmaf(a.y, w.y, acc);
    acc = fmaf(a.z, w.z, acc);
    return fmaf(a.w, w.w, acc);
  }
};

// s[j] = q . Kg row j * scale for the visible rows, kNegInf for the rest.
template <typename T, bool Vec, bool Paged>
__device__ __forceinline__ void score_rows(const float* q, const T* kg, const int* tbl,
                                           float* s, int b, int h, int H, int nb, int nv,
                                           int dg, float scale) {
  using C = Chunk<T, Vec>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cpr = dg / C::N;  // chunks a row
  int L = 1;                  // lanes a row
  while (L < cpr && L < 32) L <<= 1;
  const int rw = 32 / L;  // rows a warp instruction
  const int grp = lane / L, sub = lane & (L - 1);
  // logical block j's row: base + j * step (contiguous) or base + page * step
  const T* base = kg + (Paged ? (size_t)h * dg : ((size_t)b * H + h) * nb * dg);
  const size_t step = Paged ? (size_t)H * dg : (size_t)dg;
  for (int j0 = warp * rw * kUnroll; j0 < nb; j0 += kWarps * rw * kUnroll) {
    const T* row[kUnroll];
    bool vis[kUnroll];
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * rw + grp;
      vis[u] = j < nb && j < nv;
      // a masked block's row is never read: its lanes read row 0 (paged:
      // the null page's) and drop the sum, so no load waits on a branch
      row[u] = base + (size_t)(vis[u] ? (Paged ? tbl[j] : j) : 0) * step;
      acc[u] = 0.f;  // +0.0: the dot cannot give -0.0
    }
    for (int c = sub; c < cpr; c += L) {
      C ch[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) ch[u].load(row[u] + c * C::N);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc[u] = ch[u].dot(q + c * C::N, acc[u]);
    }
    for (int off = L >> 1; off > 0; off >>= 1)  // the kUnroll trees side by side
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * rw + grp;
      if (sub == 0 && j < nb) s[j] = vis[u] ? acc[u] * scale : kNegInf;
    }
  }
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[w]);
  __syncthreads();
  return v;
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.f;
  for (int w = 0; w < kWarps; ++w) v += red[w];
  __syncthreads();
  return v;
}

// Unsigned keys in the order of the floats.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v == 0.f ? 0.f : v);  // -0.0 ties +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The id a slot holds: -1 where the value is at or below the cutoff.
__device__ __forceinline__ int out_id(uint32_t key, int j, uint32_t cut) {
  return key > cut ? j : -1;
}

// A listed survivor: its key above its index.
__device__ __forceinline__ uint64_t survivor(uint32_t key, int j) {
  return ((uint64_t)key << 32) | (uint32_t)j;
}

// Whether listed survivor o ranks before me: a larger key, or an equal key
// and the lower index.
__device__ __forceinline__ bool beats(uint64_t o, uint64_t me) {
  const uint32_t ko = (uint32_t)(o >> 32), km = (uint32_t)(me >> 32);
  return ko > km || (ko == km && (uint32_t)o < (uint32_t)me);
}

// hist[digit] += 1 for each lane that takes part; lanes of one digit add
// once, together. The whole warp calls it.
__device__ __forceinline__ void hist_add(int* hist, bool take, uint32_t digit) {
  if (!__any_sync(0xffffffffu, take)) return;
  const unsigned peers = __match_any_sync(0xffffffffu, take ? digit : 256u);
  if (take && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
}

// One warp: the digit whose bin holds the k-th largest candidate, that
// candidate's rank within the bin, and whether that rank is the bin's size
// (the whole bin is taken). Lane l scans digits 255 - 8l down to 248 - 8l;
// exactly one (lane, digit) holds it.
__device__ __forceinline__ void pick_digit(const int* hist, int k, int* digit, int* k_left,
                                           int* whole) {
  const int lane = threadIdx.x & 31;
  const int4 up = *reinterpret_cast<const int4*>(hist + 252 - 8 * lane);
  const int4 dn = *reinterpret_cast<const int4*>(hist + 248 - 8 * lane);
  const int c[8] = {up.w, up.z, up.y, up.x, dn.w, dn.z, dn.y, dn.x};
  int tot = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) tot += c[i];
  int incl = tot;
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  int above = incl - tot;  // candidates in higher digits
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (above < k && k <= above + c[i]) {
      *digit = 255 - 8 * lane - i;
      *k_left = k - above;
      *whole = k - above == c[i];
    }
    above += c[i];
  }
}

// Dynamic shared memory: q [dg] fp32 (16-byte padded), the survivor list
// (uint64 [k_sel]; paged, the page-table row [nb] before it), the scores
// [nb] (then their keys).
__host__ __device__ __forceinline__ size_t q_bytes(int dg) { return ((size_t)dg * 4 + 15) / 16 * 16; }
__host__ __device__ __forceinline__ size_t list_bytes(int nb, int k_sel, bool paged) {
  const size_t n = (size_t)k_sel * 8 > (paged ? (size_t)nb * 4 : 0) ? (size_t)k_sel * 8 : (size_t)nb * 4;
  return (n + 15) / 16 * 16;
}
size_t smem_bytes(int nb, int dg, int k_sel, bool paged) {
  return q_bytes(dg) + list_bytes(nb, k_sel, paged) + (size_t)nb * 4;
}

template <typename T, bool Paged>
__global__ void __launch_bounds__(kThreads)
gate_select_kernel(const T* __restrict__ qg, const T* __restrict__ kg,
                   const int* __restrict__ page_table, const int* __restrict__ n_valid,
                   int* __restrict__ out, int H, int nb, int dg, int k_sel, int threshold_method,
                   float threshold, int force_first, int force_last, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q = reinterpret_cast<float*>(smem);
  uint64_t* list = reinterpret_cast<uint64_t*>(smem + q_bytes(dg));
  int* tbl = reinterpret_cast<int*>(list);  // paged: the table row, dead after scoring
  float* s = reinterpret_cast<float*>(smem + q_bytes(dg) + list_bytes(nb, k_sel, Paged));
  uint32_t* keys = reinterpret_cast<uint32_t*>(s);
  __shared__ __align__(16) int hist[2][256];
  __shared__ float red[kWarps];
  __shared__ int w_eq[kWarps], w_gt[kWarps];
  __shared__ int sh_digit, sh_left, sh_whole;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nv = n_valid[b];
  int* orow = out + (size_t)bh * k_sel;

  // stage q and the table row; clear both histograms
  for (int d = tid; d < dg; d += kThreads) q[d] = to_f32(qg[(size_t)bh * dg + d]);
  if (Paged)  // entries at or past n_valid are not read: the null page 0
    for (int j = tid; j < nb; j += kThreads)
      tbl[j] = (j < nv) ? max(page_table[(size_t)b * nb + j], 0) : 0;
  for (int i = tid; i < 2 * 256; i += kThreads) hist[i >> 8][i & 255] = 0;
  __syncthreads();

  if (vec)
    score_rows<T, true, Paged>(q, kg, tbl, s, b, h, H, nb, nv, dg, scale);
  else
    score_rows<T, false, Paged>(q, kg, tbl, s, b, h, H, nb, nv, dg, scale);
  __syncthreads();

  // ranked values as _rank_and_pick makes them, clamped at the cutoff,
  // as keys; pass 0's histogram (top 8 bits) on the way
  const float cutoff = threshold_method ? 0.f : kNegInf / 2;
  float m = 0.f, sum = 1.f;
  if (threshold_method) {
    // softmax over the UNFORCED masked logits
    float mt = -INFINITY;
    for (int j = tid; j < nb; j += kThreads) mt = fmaxf(mt, s[j]);
    m = block_max(mt, red);
    float st = 0.f;
    for (int j = tid; j < nb; j += kThreads) st += expf(s[j] - m);
    sum = block_sum(st, red);
  }
  for (int j0 = 0; j0 < nb; j0 += kThreads) {
    const int j = j0 + tid;
    uint32_t key = 0;
    if (j < nb) {
      float r = s[j];
      if (threshold_method) r = (j < nv) ? expf(r - m) / sum : -1.f;
      if (force_last && j == nv - 1) r = kBig;
      if (force_first && j == 0) r = kBig;
      if (threshold_method && !(r > threshold)) r = -1.f;
      key = order_key(r > cutoff ? r : cutoff);
      keys[j] = key;
    }
    hist_add(hist[0], j < nb, key >> 24);
  }

  // radix select: K* (the top bits of the k_sel-th largest key that the
  // passes fixed, kmask) and k_left, the keys in K*'s bin to take; it stops
  // early where that is the whole bin
  uint32_t kstar = 0, kmask = 0;
  int k_left = k_sel;
  bool whole = false;
  for (int pass = 0; pass < 4 && !whole; ++pass) {
    const int shift = 24 - 8 * pass;
    if (pass > 0) {
      for (int j0 = 0; j0 < nb; j0 += kThreads) {
        const int j = j0 + tid;
        const uint32_t key = j < nb ? keys[j] : 0u;
        hist_add(hist[pass & 1], j < nb && (key & kmask) == kstar, (key >> shift) & 255u);
      }
    }
    for (int i = tid; i < 256; i += kThreads) hist[(pass + 1) & 1][i] = 0;
    __syncthreads();
    if (warp == 0) pick_digit(hist[pass & 1], k_left, &sh_digit, &sh_left, &sh_whole);
    __syncthreads();
    kstar |= (uint32_t)sh_digit << shift;
    kmask |= 0xffu << shift;
    k_left = sh_left;
    whole = sh_whole;
  }

  // place: each warp walks its span of ids in order. Keys above K*'s bin,
  // and its keys where the whole bin is taken, are listed; otherwise (K*
  // then a whole key) the bin's first k_left keys by index follow them.
  const int g = whole ? k_sel : k_sel - k_left;
  const uint32_t cut = order_key(cutoff);
  const int span = ((nb + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int lo = min(nb, warp * span), hi = min(nb, lo + span);
  int n_eq = 0, n_gt = 0;
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    const uint32_t mk = j < hi ? keys[j] & kmask : 0u;
    const bool bin = j < hi && mk == kstar;
    n_eq += __popc(__ballot_sync(0xffffffffu, bin && !whole));
    n_gt += __popc(__ballot_sync(0xffffffffu, (j < hi && mk > kstar) || (bin && whole)));
  }
  if (lane == 0) {
    w_eq[warp] = n_eq;
    w_gt[warp] = n_gt;
  }
  for (int r = tid; r < k_sel; r += kThreads) orow[r] = -1;
  __syncthreads();
  int at_eq = 0, at_gt = 0;  // placed-by-index and listed keys of earlier warps' spans
  for (int w = 0; w < warp; ++w) {
    at_eq += w_eq[w];
    at_gt += w_gt[w];
  }
  const unsigned below = (1u << lane) - 1u;
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    const uint32_t key = j < hi ? keys[j] : 0u;
    const bool bin = j < hi && (key & kmask) == kstar;
    const bool eq = bin && !whole, gt = (j < hi && (key & kmask) > kstar) || (bin && whole);
    const unsigned b_eq = __ballot_sync(0xffffffffu, eq), b_gt = __ballot_sync(0xffffffffu, gt);
    if (gt) list[at_gt + __popc(b_gt & below)] = survivor(key, j);
    if (eq) {
      const int rank = at_eq + __popc(b_eq & below);
      if (rank < k_left) orow[g + rank] = out_id(key, j, cut);
    }
    at_eq += __popc(b_eq);
    at_gt += __popc(b_gt);
  }
  __syncthreads();
  // P adjacent lanes rank one survivor, each over every P-th entry (P as
  // large as keeps all survivors in one pass, at most 32)
  int P = 32;
  while (P > 1 && P * g > kThreads) P >>= 1;
  for (int i0 = 0; i0 < g; i0 += kThreads / P) {
    const int i = i0 + tid / P, part = tid & (P - 1);
    const uint64_t me = i < g ? list[i] : 0u;
    int slot = 0;
    if (i < g)
#pragma unroll 4
      for (int x = part; x < g; x += P) slot += beats(list[x], me);
    for (int off = P >> 1; off > 0; off >>= 1) slot += __shfl_xor_sync(0xffffffffu, slot, off);
    if (i < g && part == 0) orow[slot] = out_id((uint32_t)(me >> 32), (int)(uint32_t)me, cut);
  }
}

// Raises the instance's dynamic shared-memory limit on the current device
// to at least smem, once (the largest limit set so far is kept per device).
template <typename T, bool Paged>
int reserve_smem(size_t smem) {
  static int set_to[kMaxDevices] = {};
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && set_to[dev] >= (int)smem) return 0;
  e = cudaFuncSetAttribute(gate_select_kernel<T, Paged>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices) set_to[dev] = (int)smem;
  return 0;
}

template <typename T, bool Paged>
int launch(const void* qg, const void* kg, const void* page_table, const void* n_valid,
           void* out, int B, int H, int nb, int dg, int k_sel, int threshold_method,
           float threshold, int force_first, int force_last, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(nb, dg, k_sel, Paged);
  const int rc = reserve_smem<T, Paged>(smem);
  if (rc != 0) return rc;
  const int vec = (dg * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(kg) % 16 == 0;
  gate_select_kernel<T, Paged><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(qg), static_cast<const T*>(kg),
      static_cast<const int*>(page_table), static_cast<const int*>(n_valid),
      static_cast<int*>(out), H, nb, dg, k_sel, threshold_method, threshold, force_first,
      force_last, scale, vec);
  return (int)cudaGetLastError();
}

template <bool Paged>
int dispatch(const void* qg, const void* kg, const void* page_table, const void* n_valid,
             void* out, int B, int H, int nb, int dg, int k_sel, int threshold_method,
             float threshold, int force_first, int force_last, float scale, int dtype,
             void* stream) {
  if (B <= 0 || H <= 0 || nb <= 0 || dg <= 0 || k_sel <= 0 || k_sel > nb || nb > kMaxBlocks ||
      dg > kMaxDg)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, Paged>(qg, kg, page_table, n_valid, out, B, H, nb, dg, k_sel,
                                threshold_method, threshold, force_first, force_last, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, Paged>(qg, kg, page_table, n_valid, out, B, H, nb, dg, k_sel,
                                        threshold_method, threshold, force_first, force_last,
                                        scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
int gate_select_launch(const void* qg, const void* kg, const void* n_valid, void* out, int B,
                       int H, int nb, int dg, int k_sel, int threshold_method, float threshold,
                       int force_first, int force_last, float scale, int dtype, void* stream) {
  return dispatch<false>(qg, kg, nullptr, n_valid, out, B, H, nb, dg, k_sel, threshold_method,
                         threshold, force_first, force_last, scale, dtype, stream);
}

// kg_pages [P, H, dg], page_table [B, npt]; nb = npt.
int gate_select_paged_launch(const void* qg, const void* kg_pages, const void* page_table,
                             const void* n_valid, void* out, int B, int H, int npt, int dg,
                             int k_sel, int threshold_method, float threshold, int force_first,
                             int force_last, float scale, int dtype, void* stream) {
  return dispatch<true>(qg, kg_pages, page_table, n_valid, out, B, H, npt, dg, k_sel,
                        threshold_method, threshold, force_first, force_last, scale, dtype,
                        stream);
}

// Threads a CTA of either instance; the grid is B * Hkv CTAs.
int gate_select_cta_threads(void) { return kThreads; }

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
