// Split-K paged block-sparse decoding over fp or int8 K/V (Hopper, sm_90a).
//
// Replaces two TPU kernel bodies of src/repro/kernels/block_sparse_decode.py:
//   block_sparse_decode_paged_splitk (fp body _kernel_paged_splitk, the jnp
//                              combine of its entry point :407) and its int8
//                              body _kernel_paged_splitk_quant (:393):
//                              block_sparse_decode_paged_splitk_launch and
//                              block_sparse_decode_paged_splitk_quant_launch.
// Every other decode body moved to block_sparse_decode_sm90.cu, a body
// redesigned for the card (split over the SMs, a cp.async ring, warps with
// their own softmax state): the fp ones (#2, #4) and the int8 ones (2q, 4q).
// This file keeps the original loop of kernels 5 and 5q, arithmetic
// unchanged, with their combine, until they move onto that body too.
//
// Contract: q [B, Hkv, G, Dh], one new query token grouped per kv head;
// k, v the pools [P, Hkv, ps, Dh] with ps == bs (bf16 or fp32, same as q,
// or int8 codes); page_table [B, npt] int32 maps a LOGICAL block id to its
// physical page; idx [B, Hkv, nsel] int32 selected block ids, -1 =
// padding; kv_len [B] int32; out [B, Hkv, G, Dh] in q's dtype. Selected
// ids stay logical: the block's base address becomes
// ((page_table[b, blk] * Hkv + h) * ps) * Dh (the page id clamped at 0, as
// the reference's kv_map does), while the masking stays in logical
// positions (t0 = blk*bs against kv_len), as _kernel_paged does. Scale
// 1/sqrt(Dh), fp32 online softmax and accumulation.
//
// Int8 contract (Quant): k, v hold int8 codes (value = code * scale) and
// the scales are f32 [P, H] per physical page (the pool's [P, H, 1] rows).
// Each selected block's two scales are read once, inside the block loop,
// at the block's own physical page, and folded where they cost least: the
// K scale into the score scale, s = (q . k_code) * (k_scale / sqrt(Dh)),
// the V scale into the block's P.V partial, acc += v_scale * sum_t p[t] *
// v_code[t]. Within fp32 accumulation that is the plain version's
// function, which scales every element before the dots.
//
// Split-K: the selected list of each (b, h) is cut into num_splits
// segments of per = ceil(nsel / num_splits) entries, segment s holding
// entries [s*per, min((s+1)*per, nsel)) (the reference's boundaries:
// ref.paged_sparse_decode_splitk_ref pads the tail with -1; the Pallas
// kernel only pads each segment to its blocks_per_step). CTA (b, h, s)
// runs the body over its segment and writes the UNNORMALISED flash partial
// to an f32 workspace [B, H, ns, G, Dh] (acc), then [B, H, ns, G] (m) and
// [B, H, ns, G] (l). A segment with no valid key writes acc = 0, l = 0 and
// m = -inf: it has no maximum, and the combine's l > 0 mask keeps it out
// of the sum (a row whose segments are all empty, an idle slot, gives 0).
// A second small kernel combines the partials of each (b, h, g) with the
// reference's two-pass rescale (block_sparse_decode.py:499-505):
//   m = max_s m_s, r_s = (l_s > 0) ? exp(m_s - m) : 0,
//   l = sum_s r_s l_s, o = sum_s r_s acc_s / max(l, 1e-30),
// and writes o in q's dtype. The reference does the combine in jnp outside
// its Pallas call; here it is a kernel, so that one call of the wrapper is
// two launches (the serve step is host-bound: a dozen torch ops per layer
// would cost more than the combine's work).
//
// Design: each CTA loops over its segment's selected blocks. A block's K
// and V rows [bs, Dh] are one contiguous range of the pool, so each is
// copied into shared memory with 16-byte vector loads, all of a thread's K
// and V loads issued before its stores (rows past kv_len are neither
// copied nor read). The CTA computes the G x bs scores in fp32 (one warp
// per (row, key) pair, lanes across Dh), runs the online-softmax update per
// row, then accumulates P.V into registers (each thread owns G*Dh/256
// output elements). The TPU tiling (blocks_per_step, the 16-row G padding,
// the 128-lane m/l scratch) is not carried over: each CTA reads its own
// block-index row in place of the scalar-prefetch index map.
//
// Bound on the H100: at the main path's shape (B=4, Hkv=8, k=64 blocks x
// 64 tokens x Dh 128, K+V) bf16 pools hold ~67 MB of the selected rows
// (~20 us at 3.35 TB/s), int8 pools ~34 MB of codes (~10 us) plus 8 bytes
// of scales and 4 of page table per selected block, and the f32 partials
// add (G*Dh + 2G) * 4 bytes per split, written and read once (4 KiB per
// (b, h) at 4 splits). This loop does not reach it: each CTA waits for a
// block's loads before it computes on them, so at most one block per CTA
// is in flight (no cp.async pipeline across blocks), and num_splits x
// B*Hkv CTAs (128 at 4 splits) leave SMs idle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 16;  // G*Dh <= kThreads*kMaxPerThread = 4096

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* o) { *o = __float2bfloat16(x); }

// copy the n valid elements of one block of K and of V (contiguous in the
// head-major pool) global -> shared. Each thread issues all its K and V
// loads before its stores, so a block's reads are in flight together
// instead of one 16-byte load at a time. Rows past kv_len are not copied:
// the score and P.V loops never read them.
template <typename T>
__device__ __forceinline__ void load_kv(T* ks, T* vs, const T* __restrict__ kg,
                                        const T* __restrict__ vg, int n, bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kUnroll = 4;
    const int n4 = n / kPer;  // n is a multiple of Dh, Dh*sizeof(T) % 16 == 0
    const uint4* k4 = reinterpret_cast<const uint4*>(kg);
    const uint4* v4 = reinterpret_cast<const uint4*>(vg);
    uint4* dk = reinterpret_cast<uint4*>(ks);
    uint4* dv = reinterpret_cast<uint4*>(vs);
    for (int base = threadIdx.x; base < n4; base += kThreads * kUnroll) {
      uint4 rk[kUnroll], rv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < n4) {
          rk[u] = k4[i];
          rv[u] = v4[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < n4) {
          dk[i] = rk[u];
          dv[i] = rv[u];
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      ks[i] = kg[i];
      vs[i] = vg[i];
    }
  }
}

// The physical page of logical block blk of row b (npt table entries a
// row), the id clamped at 0 as the reference's kv_map clamps it.
__device__ __forceinline__ int phys_page(const int* __restrict__ page_table, int b, int npt,
                                         int blk) {
  return max(page_table[(size_t)b * npt + blk], 0);
}

// CTA blockIdx.x = (b * H + h) * ns + s reduces segment s of (b, h)'s
// selected list into the partials in part. T: q and out; KV: the pool's
// elements (T, or int8_t when Quant, with f32 scale rows [P, H]).
template <typename T, typename KV, bool Quant>
__global__ void __launch_bounds__(kThreads)
block_sparse_decode_splitk_kernel(const T* __restrict__ q, const KV* __restrict__ kc,
                                  const KV* __restrict__ vc, const float* __restrict__ k_scales,
                                  const float* __restrict__ v_scales,
                                  const int* __restrict__ idx,
                                  const int* __restrict__ page_table,
                                  const int* __restrict__ kv_len, float* __restrict__ part,
                                  int H, int G, int Dh, int S, int npt, int nsel, int bs,
                                  float sm_scale, int vec, int ns) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int GD = G * Dh;
  float* qs = reinterpret_cast<float*>(smem_raw);  // [G*Dh]
  float* ps = qs + GD;                             // [G*bs] scores, then p
  float* m_s = ps + G * bs;                        // [G] running max
  float* l_s = m_s + G;                            // [G] running sum
  float* a_s = l_s + G;                            // [G] this block's rescale
  size_t off = ((size_t)(GD + G * bs + 3 * G) * sizeof(float) + 15) & ~(size_t)15;
  KV* ks = reinterpret_cast<KV*>(smem_raw + off);  // [bs*Dh]
  KV* vs = ks + (size_t)bs * Dh;                   // [bs*Dh]

  const int bh = blockIdx.x / ns;
  const int b = bh / H, h = bh - b * H;
  // the entries of the selected list this CTA walks: its segment (the
  // reference's boundaries)
  const int per = (nsel + ns - 1) / ns;
  const int j0 = (blockIdx.x - bh * ns) * per;
  const int j1 = min(j0 + per, nsel);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = kv_len[b];
  const int* irow = idx + (size_t)bh * nsel;

  for (int e = tid; e < GD; e += kThreads) qs[e] = to_f32(q[(size_t)bh * GD + e]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) acc[i] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int blk = irow[j];
    if (blk < 0) continue;                       // -1 padding
    const int t0 = blk * bs;
    int nt = min(bs, min(len, S) - t0);          // valid rows of this block
    if (nt <= 0) continue;                       // wholly past kv_len: adds nothing
    __syncthreads();                             // previous block done with ks/vs/ps
    const int phys = phys_page(page_table, b, npt, blk);
    const size_t boff = ((size_t)phys * H + h) * bs * Dh;
    load_kv(ks, vs, kc + boff, vc + boff, nt * Dh, vec != 0);
    float scale = sm_scale, v_scale = 1.f;  // fp: the plain 1/sqrt(Dh)
    if (Quant) {
      const size_t si = (size_t)phys * H + h;   // the scale row of the PHYSICAL page
      scale = k_scales[si] * sm_scale;
      v_scale = v_scales[si];
    }
    __syncthreads();

    // scores s[g][t] = q[g] . k[t] * scale, masked past kv_len (int8: the
    // K scale rides in scale)
    for (int pr = warp; pr < G * bs; pr += kWarps) {
      const int g = pr / bs, t = pr - g * bs;
      float s = 0.f;
      if (t < nt) {
        const float* qg = qs + g * Dh;
        const KV* kt = ks + (size_t)t * Dh;
        for (int d = lane; d < Dh; d += 32) s += qg[d] * to_f32(kt[d]);
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      }
      if (lane == 0) ps[pr] = (t < nt) ? s * scale : kNegInf;
    }
    __syncthreads();

    // online-softmax update, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* pg = ps + g * bs;
      float mx = kNegInf;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, pg[t]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        // guard: a masked key would give exp(NEG_INF - NEG_INF) = 1
        const float p = (pg[t] > kNegInf / 2) ? expf(pg[t] - m_new) : 0.f;
        pg[t] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g][d] = alpha[g] * acc[g][d] + sum_t p[g][t] * v[t][d] (int8: the
    // block's sum over t times its V scale)
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < GD) {
        const int g = e / Dh, d = e - g * Dh;
        const float* pg = ps + g * bs;
        float a = acc[i] * a_s[g];
        if (Quant) {
          float pv = 0.f;
          for (int t = 0; t < nt; ++t) pv += pg[t] * to_f32(vs[(size_t)t * Dh + d]);
          a += v_scale * pv;
        } else {
          for (int t = 0; t < nt; ++t) a += pg[t] * to_f32(vs[(size_t)t * Dh + d]);
        }
        acc[i] = a;
      }
    }
  }
  __syncthreads();
  // the unnormalised partial of this segment: acc, then m (-inf when the
  // segment held no valid key) and l
  float* pacc = part + (size_t)blockIdx.x * GD;
  float* pm = part + (size_t)gridDim.x * GD + (size_t)blockIdx.x * G;
  float* pl = pm + (size_t)gridDim.x * G;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (e < GD) pacc[e] = acc[i];
  }
  for (int g = tid; g < G; g += kThreads) {
    pm[g] = (l_s[g] > 0.f) ? m_s[g] : -INFINITY;
    pl[g] = l_s[g];
  }
}

// Combine the ns split-K partials of each (b, h, g) (the workspace layout
// of the split body; BH = B * H): one thread per output element, the
// reference's two-pass rescale in fp32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
splitk_combine_kernel(const float* __restrict__ part, T* __restrict__ out, int BH, int G,
                      int Dh, int ns) {
  const int GD = G * Dh;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
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
    const float rs = (ls > 0.f) ? expf(pm[s * G] - m) : 0.f;
    l += rs * ls;
    o += rs * acc[(size_t)s * GD];
  }
  from_f32(o / fmaxf(l, 1e-30f), out + e);
}

template <typename T, typename KV, bool Quant>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* idx, const void* page_table, const void* kv_len, void* out, void* part,
           int B, int H, int G, int Dh, int npt, int nsel, int bs, int ns, float scale,
           cudaStream_t stream) {
  const size_t head = ((size_t)(G * Dh + G * bs + 3 * G) * sizeof(float) + 15) & ~(size_t)15;
  const size_t smem = head + 2 * (size_t)bs * Dh * sizeof(KV);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = block_sparse_decode_splitk_kernel<T, KV, Quant>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = ((uintptr_t)k % 16 == 0) && ((uintptr_t)v % 16 == 0) &&
                  ((Dh * sizeof(KV)) % 16 == 0);
  kernel<<<B * H * ns, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<const int*>(idx),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_len),
      static_cast<float*>(part), H, G, Dh, npt * bs, npt, nsel, bs, scale, vec, ns);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)B * H * G * Dh;
  splitk_combine_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                             stream>>>(static_cast<const float*>(part), static_cast<T*>(out),
                                       B * H, G, Dh, ns);
  return (int)cudaGetLastError();
}

// Quant selects int8 K/V with f32 scales (ks, vs); otherwise K/V share q's
// dtype and ks/vs are unused. part is the f32 workspace of
// B * H * ns * (G * Dh + 2 * G) floats.
template <bool Quant>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* idx, const void* page_table, const void* kv_len, void* out, void* part,
             int B, int H, int G, int Dh, int npt, int nsel, int bs, int ns, float scale,
             int dtype, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || Dh <= 0 || npt <= 0 || nsel <= 0 || bs <= 0 || ns <= 0 ||
      G * Dh > kThreads * kMaxPerThread)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, typename std::conditional<Quant, int8_t, float>::type, Quant>(
        q, k, v, ks, vs, idx, page_table, kv_len, out, part, B, H, G, Dh, npt, nsel, bs, ns,
        scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, typename std::conditional<Quant, int8_t, __nv_bfloat16>::type,
                  Quant>(q, k, v, ks, vs, idx, page_table, kv_len, out, part, B, H, G, Dh, npt,
                         nsel, bs, ns, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q and out). Each entry point returns
// cudaGetLastError() after its launches.

// Split-K paged decode over fp pools [P, H, ps, Dh] (ps == bs) and a page
// table [B, npt], the selected list cut into num_splits segments; workspace holds B * H *
// num_splits * (G * Dh + 2 * G) floats. Two launches: the split body, then
// the combine into out.
int block_sparse_decode_paged_splitk_launch(const void* q, const void* k_pages,
                                            const void* v_pages, const void* idx,
                                            const void* page_table, const void* kv_len, void* out,
                                            void* workspace, int B, int H, int G, int Dh, int npt,
                                            int nsel, int bs, int num_splits, float scale,
                                            int dtype, void* stream) {
  return dispatch<false>(q, k_pages, v_pages, nullptr, nullptr, idx, page_table, kv_len, out,
                         workspace, B, H, G, Dh, npt, nsel, bs, num_splits, scale, dtype, stream);
}

// The int8 twin: int8 pools with [P, H] float32 scale rows, one per
// physical page.
int block_sparse_decode_paged_splitk_quant_launch(const void* q, const void* k_pages,
                                                  const void* v_pages, const void* k_scales,
                                                  const void* v_scales, const void* idx,
                                                  const void* page_table, const void* kv_len,
                                                  void* out, void* workspace, int B, int H, int G,
                                                  int Dh, int npt, int nsel, int bs,
                                                  int num_splits, float scale, int dtype,
                                                  void* stream) {
  return dispatch<true>(q, k_pages, v_pages, k_scales, v_scales, idx, page_table, kv_len, out,
                        workspace, B, H, G, Dh, npt, nsel, bs, num_splits, scale, dtype, stream);
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
