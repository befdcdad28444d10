// Fused gate scoring + block selection for one decode step (Hopper, sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/gate_select.py:
//   fused_gate_select        (body _select_kernel, selection core
//                            _rank_and_pick): gate_select_launch below;
//   fused_gate_select_paged  (body _select_paged_kernel): the same kernel
//                            over the paged Kg pool, gate_select_paged_launch.
// Contiguous contract:
//   qg      [B, Hkv, Dg]       post-rope gate query (bf16 or fp32)
//   kg      [B, Hkv, nb, Dg]   head-major K-compression cache (same dtype)
//   n_valid [B] int32          visible blocks
//   out     [B, Hkv, k] int32  selected block ids, -1 padding
// For each (b, kv-head): score = qg . Kg^T * (1/sqrt(Dg)) in fp32; blocks at
// or past n_valid are masked to NEG_INF; the threshold method takes a
// softmax over the masked logits and admits probabilities > tau; the first
// and last visible blocks are pinned; then an exact top-k in descending
// score order, the LOWER index first on ties (jax.lax.top_k's order).
//
// Paged contract: kg is the pool kg_pages [P, Hkv, Dg] (one row per
// physical page) and page_table [B, npt] int32 maps logical block j to its
// page; nb = npt. Logical block j of (b, h) reads row
// kg_pages[page_table[b, j], h] in place of kg[b, h, j]. Entries at or past
// n_valid (the null page 0, or stale ids) are masked before ranking, so
// their rows are not read at all.
//
// Design: one CTA per (b, kv-head). The CTA scores its nb blocks into shared
// memory (one warp per block row, lanes across Dg: coalesced reads of each
// Kg row), applies mask/softmax/threshold/pinning as _rank_and_pick does,
// then runs k rounds of a block-wide argmax, each taking the lower index on
// ties and writing -1 once the best value is <= the cutoff (the remaining
// slots are then filled with -1 at once).
//
// Bound on the H100: at the main path's shape (B=4, Hkv=8, nb=257, Dg=128,
// bf16) one call reads ~2.1 MB of Kg (the paged kernel also reads the
// page table, 4 bytes per visible block): ~0.6 us at 3.35 TB/s, so the call is
// bound by launch latency and by the k sequential argmax rounds (two
// barriers each), not by bytes. The design keeps everything after the
// scoring pass in shared memory (nb*4 bytes, ~1 KB) and stops the rounds
// early once only padding is left; B*Hkv = 32 CTAs occupy 32 of 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kBig = 1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// keep (v, i) as the larger value; equal values keep the lower index
__device__ __forceinline__ void arg_combine(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
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

// The address of Kg row (b, h, logical block j): contiguous cache, or the
// page pool through the page table.
template <typename T, bool Paged>
__device__ __forceinline__ const T* kg_row(const T* kg, const int* page_table, int b, int h,
                                           int H, int nb, int dg, int j) {
  if (Paged) {
    const int phys = max(page_table[(size_t)b * nb + j], 0);
    return kg + ((size_t)phys * H + h) * dg;
  }
  return kg + (((size_t)b * H + h) * nb + j) * dg;
}

template <typename T, bool Paged>
__global__ void __launch_bounds__(kThreads)
gate_select_kernel(const T* __restrict__ qg, const T* __restrict__ kg,
                   const int* __restrict__ page_table,
                   const int* __restrict__ n_valid, int* __restrict__ out,
                   int H, int nb, int dg, int k_sel, int threshold_method,
                   float threshold, int force_first, int force_last, float scale) {
  extern __shared__ float smem[];
  float* q = smem;            // [dg]
  float* ranked = smem + dg;  // [nb]
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float best_v;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nv = n_valid[b];
  const T* qrow = qg + (size_t)bh * dg;
  int* orow = out + (size_t)bh * k_sel;

  for (int d = tid; d < dg; d += kThreads) q[d] = to_f32(qrow[d]);
  __syncthreads();

  // scores with the visibility mask (masked rows are not read)
  for (int j = warp; j < nb; j += kWarps) {
    float acc = 0.f;
    if (j < nv) {
      const T* krow = kg_row<T, Paged>(kg, page_table, b, h, H, nb, dg, j);
      for (int d = lane; d < dg; d += 32) acc += q[d] * to_f32(krow[d]);
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) ranked[j] = (j < nv) ? acc * scale : kNegInf;
  }
  __syncthreads();

  float cutoff, drop;
  if (threshold_method) {
    // softmax over the UNFORCED masked logits, then: invisible -> -1,
    // pin last/first, admit > tau
    float m = -INFINITY;
    for (int j = tid; j < nb; j += kThreads) m = fmaxf(m, ranked[j]);
    m = block_max(m, red_v);
    float s = 0.f;
    for (int j = tid; j < nb; j += kThreads) s += expf(ranked[j] - m);
    s = block_sum(s, red_v);
    for (int j = tid; j < nb; j += kThreads) {
      float r = (j < nv) ? expf(ranked[j] - m) / s : -1.f;
      if (force_last && j == nv - 1) r = kBig;
      if (force_first && j == 0) r = kBig;
      ranked[j] = (r > threshold) ? r : -1.f;
    }
    cutoff = 0.f;
    drop = -2.f;
  } else {
    // budget: top-k on the raw masked logits
    for (int j = tid; j < nb; j += kThreads) {
      float r = ranked[j];
      if (force_last && j == nv - 1) r = kBig;
      if (force_first && j == 0) r = kBig;
      ranked[j] = r;
    }
    cutoff = kNegInf / 2;
    drop = 2 * kNegInf;
  }
  __syncthreads();

  // exact top-k: k rounds of a block-wide argmax, lower index on ties
  for (int r = 0; r < k_sel; ++r) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int j = tid; j < nb; j += kThreads) arg_combine(bv, bi, ranked[j], j);
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      arg_combine(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      bv = red_v[0];
      bi = red_i[0];
      for (int w = 1; w < kWarps; ++w) arg_combine(bv, bi, red_v[w], red_i[w]);
      orow[r] = (bv > cutoff) ? bi : -1;
      ranked[bi] = drop;
      best_v = bv;
    }
    __syncthreads();
    if (best_v <= cutoff) {  // only padding is left: fill the rest with -1
      for (int rr = r + 1 + tid; rr < k_sel; rr += kThreads) orow[rr] = -1;
      break;
    }
  }
}

template <typename T, bool Paged>
int launch(const void* qg, const void* kg, const void* page_table, const void* n_valid,
           void* out, int B, int H, int nb, int dg, int k_sel, int threshold_method,
           float threshold, int force_first, int force_last, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(dg + nb) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gate_select_kernel<T, Paged>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gate_select_kernel<T, Paged><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(qg), static_cast<const T*>(kg),
      static_cast<const int*>(page_table), static_cast<const int*>(n_valid),
      static_cast<int*>(out), H, nb, dg, k_sel, threshold_method, threshold, force_first,
      force_last, scale);
  return (int)cudaGetLastError();
}

template <bool Paged>
int dispatch(const void* qg, const void* kg, const void* page_table, const void* n_valid,
             void* out, int B, int H, int nb, int dg, int k_sel, int threshold_method,
             float threshold, int force_first, int force_last, float scale, int dtype,
             void* stream) {
  if (B <= 0 || H <= 0 || nb <= 0 || dg <= 0 || k_sel <= 0 || k_sel > nb ||
      (size_t)(dg + nb) * sizeof(float) > 227 * 1024)
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

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
