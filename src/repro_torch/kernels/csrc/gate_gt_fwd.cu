// Distillation-target flash attention forward (Hopper, sm_90a).
//
// Replaces the TPU kernel gate_gt_flash_fwd of src/repro/kernels/gate_gt_fwd.py
// (body _kernel): a causal GQA FlashAttention-2 forward that also writes
// blockmax, the max masked logit of each (query row, KV block). softmax over
// the blocks of blockmax is the gate's distillation target (core/distill.py).
// Contract:
//   q     [B, Lq, H, Dh]     post-rope queries, seq-major (bf16 or fp32)
//   k, v  [B, Lk, Hkv, Dh]   post-rope keys and values in q's dtype;
//                            Lk = nb * bs, GQA: head h reads KV head h / (H/Hkv)
//   seg   [B, L] int32       optional packed-document ids (Lq == Lk), or null
//   o     [B, Lq, H, Dh]     in q's dtype
//   bm    [B, H, Lq, nb]     fp32
// Score s = (q . k) / sqrt(Dh) in fp32, masked to exactly -1e30 unless
// qpos >= kpos and seg[q] == seg[k] (positions are row indices, as in the
// reference's training path). bm[row, j] is the max of the row's masked
// scores over block j: -1e30 where the whole block is masked, and for every
// block that starts after the tile's last row, which is never read. o is the
// online softmax over the unmasked keys, acc / max(l, 1e-30); a masked score
// contributes p = 0, not exp(-1e30 - -1e30) = 1 (the Pallas guard).
//
// The reference kernel reads head-major q/k/v after a transpose and writes
// bm block-major [B, H, nb, Lq], transposed back after the call; here the
// tensors are read and written in the model's own layouts, so neither copy
// exists.
//
// Design (a simple first version on the CUDA cores, fp32 throughout): one
// CTA of 256 threads per (b, h, tile of 64 query rows), the heaviest tiles
// (the last rows, which see the most blocks) launched first. The CTA stages
// its Q tile in shared memory as fp32 once, then for each KV block from 0
// to the last one that starts at or before the tile's last row:
//   1. stages the block's K and V rows [bs, Dh] as fp32 (16-byte loads, all
//      of a thread's loads issued before its stores) and their segment ids;
//   2. computes the 64 x bs scores: thread (ty, tx) owns rows 4ty..4ty+3 and
//      columns tx, tx+16, tx+32, tx+48, so each float4 of Q and of K read
//      from shared memory feeds four FMAs;
//   3. masks, takes each row's block max over the 16 lanes of its row group
//      (warp shuffles) and writes it to bm;
//   4. folds the block into the running (m, l, acc) of each row: alpha =
//      exp(m_old - m_new), p = exp(s - m_new) for unmasked s, else 0;
//   5. writes P to shared memory (over the K buffer, which step 2 is done
//      with) and accumulates P.V: thread (ty, tx) owns output columns tx +
//      16j of its four rows, 4 * Dh / 16 fp32 accumulators.
// Shared memory at Dh 128: Q 33 KB + K/P 33 KB + V 32 KB = 98 KB, two CTAs
// per SM. No tensor cores, no TMA and no pipelining across blocks: a block's
// loads complete before its scores start, hidden only by the other CTA.
//
// Work at the training shape (B 4, L 4096, H 16, Hkv 8, Dh 128, bs 64): the
// scores and P.V of the visible blocks, 2 * 64 * 64 * 128 FMAs per (tile,
// block) pair, 2080 pairs per (b, h): 1.4e11 FMAs, ~4.2 ms at the fp32
// CUDA-core peak (67 TFLOP/s), against 0.28 ms for the same operations on
// the bf16 tensor cores; bytes (q, k, v, o, bm once each) ~268 MB, 0.08 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kRows = 64;     // query rows per CTA: 16 row groups x 4 rows
constexpr int kMaxBlock = 64; // key rows per block: 16 lanes x 4 columns
constexpr int kPS = kMaxBlock + 4;  // P row stride: row groups 4 apart hit other banks

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* dst);

template <>
__device__ __forceinline__ void unpack16<float>(const uint4& u, float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                                                __uint_as_float(u.z), __uint_as_float(u.w));
}

template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ void store(float x, float* o) { *o = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* o) { *o = __float2bfloat16(x); }

// max / sum over the 16 lanes of a row group (lane bits 0..3)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [0, n) of a [n, DH] slab whose row r starts at src + r * stride
// (elements) -> dst[r * ld + d] as fp32, 16-byte loads, all of a thread's
// loads before its stores. Rows in [n, n_zero) are zeroed.
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* __restrict__ src,
                                           size_t stride, int n, int n_zero) {
  constexpr int kVE = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int kVR = DH / kVE;        // vectors per row
  constexpr int kUnroll = 4;
  const int nvec = n_zero * kVR;
  for (int base = threadIdx.x; base < nvec; base += kThreads * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads, row = i / kVR, c = i % kVR;
      r[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < nvec && row < n)
        r[u] = __ldg(reinterpret_cast<const uint4*>(src + row * stride) + c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads, row = i / kVR, c = i % kVR;
      if (i < nvec) unpack16<T>(r[u], dst + row * ld + c * kVE);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
    gate_gt_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ seg, T* __restrict__ o,
                       float* __restrict__ bm, int Lq, int Lk, int H, int Hkv, int bs, int nb,
                       float scale) {
  constexpr int kQS = DH + 4;   // Q/K row stride: float4 reads of 8 rows hit 8 bank quads
  constexpr int kKB = (kMaxBlock * kQS > kRows * kPS) ? kMaxBlock * kQS : kRows * kPS;
  constexpr int kNJ = DH / 16;  // output columns per thread and row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [kRows][kQS]
  float* Ks = Qs + kRows * kQS; // [kMaxBlock][kQS]; P [kRows][kPS] once the scores are done
  float* Vs = Ks + kKB;         // [kMaxBlock][DH]
  __shared__ int qseg[kRows];
  __shared__ int kseg[kMaxBlock];

  const int n_tiles = gridDim.x;
  const int tile = n_tiles - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = tile * kRows;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = min(kRows, Lq - q0);

  stage_rows<T, DH>(Qs, kQS, q + ((size_t)b * Lq + q0) * H * DH + (size_t)h * DH,
                    (size_t)H * DH, nq, kRows);
  if (tid < kRows) qseg[tid] = (seg != nullptr && tid < nq) ? seg[(size_t)b * Lq + q0 + tid] : 0;

  float m[4], l[4], acc[4][kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;
  }

  const int last_row = q0 + nq - 1;
  const int n_vis = min(nb, last_row / bs + 1);   // blocks starting at or before last_row
  const T* kb = k + (size_t)b * Lk * Hkv * DH + (size_t)hk * DH;
  const T* vb = v + (size_t)b * Lk * Hkv * DH + (size_t)hk * DH;
  float* bm_rows = bm + ((size_t)b * H + h) * Lq * nb;

  for (int jb = 0; jb < n_vis; ++jb) {
    const int k0 = jb * bs;
    __syncthreads();  // the previous block's P.V is done with Ks (P) and Vs
    stage_rows<T, DH>(Ks, kQS, kb + (size_t)k0 * Hkv * DH, (size_t)Hkv * DH, bs, bs);
    stage_rows<T, DH>(Vs, DH, vb + (size_t)k0 * Hkv * DH, (size_t)Hkv * DH, bs, bs);
    if (tid < bs) kseg[tid] = seg != nullptr ? seg[(size_t)b * Lk + k0 + tid] : 0;
    __syncthreads();

    // scores: rows 4ty+i, columns tx+16c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * kQS + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kk[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * kQS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(a[i].x, kk[c].x, s[i][c]);
          s[i][c] = fmaf(a[i].y, kk[c].y, s[i][c]);
          s[i][c] = fmaf(a[i].z, kk[c].z, s[i][c]);
          s[i][c] = fmaf(a[i].w, kk[c].w, s[i][c]);
        }
    }

    // mask, block row max -> bm, online softmax
    float rbm[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i, qpos = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c, kpos = k0 + col;
        const bool ok = col < bs && r < nq && kpos <= qpos && qseg[r] == kseg[col];
        s[i][c] = ok ? s[i][c] * scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      rbm[i] = group_max(mx);
    }
    {
      const int i = tx & 3, r = 4 * ty + i;
      const float val = i == 0 ? rbm[0] : i == 1 ? rbm[1] : i == 2 ? rbm[2] : rbm[3];
      if (tx < 4 && r < nq) bm_rows[(size_t)(q0 + r) * nb + jb] = val;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], rbm[i]);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = s[i][c] > 0.5f * kNegInf ? expf(s[i][c] - m_new) : 0.f;
        s[i][c] = p;
        ps += p;
      }
      l[i] = alpha * l[i] + group_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every thread is done reading Ks: P goes there
    float* Ps = Ks;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (tx + 16 * c < bs) Ps[(4 * ty + i) * kPS + tx + 16 * c] = s[i][c];
    __syncthreads();

    // P.V: rows 4ty+i, output columns tx+16j
    int c = 0;
    for (; c + 4 <= bs; c += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * kPS + c);
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float v0 = Vs[(c + 0) * DH + tx + 16 * j], v1 = Vs[(c + 1) * DH + tx + 16 * j];
        const float v2 = Vs[(c + 2) * DH + tx + 16 * j], v3 = Vs[(c + 3) * DH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = fmaf(p[i].x, v0, acc[i][j]);
          acc[i][j] = fmaf(p[i].y, v1, acc[i][j]);
          acc[i][j] = fmaf(p[i].z, v2, acc[i][j]);
          acc[i][j] = fmaf(p[i].w, v3, acc[i][j]);
        }
      }
    }
    for (; c < bs; ++c) {
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float vv = Vs[c * DH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(Ps[(4 * ty + i) * kPS + c], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= nq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + (((size_t)b * Lq + q0 + r) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) store(acc[i][j] * inv, orow + tx + 16 * j);
  }
  // blocks after the tile's last row: never read, fully masked
  const int nf = nb - n_vis;
  for (int e = tid; e < nq * nf; e += kThreads) {
    const int r = e / nf, jb = n_vis + e % nf;
    bm_rows[(size_t)(q0 + r) * nb + jb] = kNegInf;
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* seg, void* o, void* bm,
           int B, int Lq, int Lk, int H, int Hkv, int bs, int nb, float scale,
           cudaStream_t stream) {
  constexpr int kQS = DH + 4;
  constexpr int kKB = (kMaxBlock * kQS > kRows * kPS) ? kMaxBlock * kQS : kRows * kPS;
  const size_t smem = (size_t)(kRows * kQS + kKB + kMaxBlock * DH) * sizeof(float);
  auto kernel = gate_gt_fwd_kernel<T, DH>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Lq + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(seg), static_cast<T*>(o), static_cast<float*>(bm), Lq, Lk, H, Hkv,
      bs, nb, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int by_head_dim(const void* q, const void* k, const void* v, const void* seg, void* o,
                void* bm, int B, int Lq, int Lk, int H, int Hkv, int Dh, int bs, int nb,
                float scale, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, seg, o, bm, B, Lq, Lk, H, Hkv, bs, nb, scale, s);
    case 32: return launch<T, 32>(q, k, v, seg, o, bm, B, Lq, Lk, H, Hkv, bs, nb, scale, s);
    case 64: return launch<T, 64>(q, k, v, seg, o, bm, B, Lq, Lk, H, Hkv, bs, nb, scale, s);
    case 128: return launch<T, 128>(q, k, v, seg, o, bm, B, Lq, Lk, H, Hkv, bs, nb, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o). seg may be null. q, k, v
// must be 16-byte aligned. Returns cudaGetLastError() after the launch.
int gate_gt_fwd_launch(const void* q, const void* k, const void* v, const void* seg, void* o,
                       void* bm, int B, int Lq, int Lk, int H, int Hkv, int Dh, int bs, int nb,
                       float scale, int dtype, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || bs <= 0 ||
      bs > kMaxBlock || nb * bs != Lk || H > 65535 || B > 65535 ||
      (seg != nullptr && Lq != Lk) || (uintptr_t)q % 16 || (uintptr_t)k % 16 ||
      (uintptr_t)v % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_head_dim<float>(q, k, v, seg, o, bm, B, Lq, Lk, H, Hkv, Dh, bs, nb, scale, s);
  if (dtype == 1)
    return by_head_dim<__nv_bfloat16>(q, k, v, seg, o, bm, B, Lq, Lk, H, Hkv, Dh, bs, nb,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
