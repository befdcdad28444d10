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
// block the kernel never reads. o is the online softmax over the unmasked
// keys, acc / max(l, 1e-30); a masked score contributes p = 0, not
// exp(-1e30 - -1e30) = 1 (the Pallas guard), so a row whose first blocks
// hold only other documents keeps m = -1e30 until its own keys arrive.
//
// The reference kernel reads head-major q/k/v after a transpose and writes
// bm block-major [B, H, nb, Lq], transposed back after the call; here the
// tensors are read and written in the model's own layouts, so neither copy
// exists.
//
// Two bodies, chosen by the dtype argument of the entry point:
//
// bf16, on the tensor cores (gate_gt_fwd_tc; bs 8, 16, 32, 64 or 128, a
// template parameter; Dh 16 .. 256). The bound is the operations: 4 * Dh
// per (query, key) pair that the data needs, the causal pairs within
// documents, at the bf16 tensor-core rate (989 TFLOP/s dense). At the
// training shape (B 4, L 4096, H 16, Hkv 8, Dh 128, bs 64, documents of
// mean length 2048) that is
// 1.38e11 operations, 0.14 ms; the bytes (q, k, v, o and bm once each,
// ~268 MB) take 0.08 ms. The design:
//   * Products on the tensor cores: mma.sync m16n8k16, bf16 operands, fp32
//     accumulators. S = Q.K^T with Q and K fragments by ldmatrix; O += P.V
//     with V by ldmatrix.trans. P is rounded to bf16 in registers and fed
//     back as the A operand (the m16n8 accumulator layout is the A-fragment
//     layout): P never touches shared memory. l sums the fp32 p, not the
//     rounded ones.
//   * Tiles: a CTA of 4 warps takes 64 query rows of HP heads; warp w takes
//     rows 16w .. 16w + 15 of each of them. HP = 2 when the GQA group is
//     even: both heads of a pair read one KV head, so each K and V fragment
//     a warp loads feeds two heads' products, which halves the shared-memory
//     reads per mma. Two CTAs fit on an SM (255 registers a thread, ~103 KB
//     of shared memory at Dh 128). At Dh 256 a warp's output fragments
//     alone are 128 fp32 registers a thread a head, so HP = 1 there, and
//     one CTA fits an SM (~169 KB of shared memory). The KV tile is 64
//     keys: 64/bs gate blocks, or half of a 128-key block. The query tile
//     is the fastest grid dimension, reversed, so the heaviest tiles of a
//     head launch first and the CTAs in flight share their heads' K/V in
//     L2.
//   * Copies: a two-stage ring of K/V tiles in shared memory filled by
//     16-byte cp.async (commit_group / wait_group): tile j+1 is in flight
//     while tile j is computed. Rows are padded by 16 bytes, so the 8 rows
//     of each ldmatrix fall in distinct banks. Q is copied once.
//   * Masks: the causal mask is applied only where a tile reaches past the
//     warp's first row, the Lk edge only on a partial last tile, and the
//     segment mask only where the query tile or the KV tile holds more than
//     one document. A small pre-pass writes each 64-row tile's lowest and
//     highest segment id (the CTA keeps its row of them in shared memory);
//     a (query tile, KV tile) pair whose id ranges do not overlap shares no
//     document, so it would give p = 0 everywhere and leave m unchanged: it
//     is skipped outright, no copy and no mma, and its bm entries get -1e30
//     in the epilogue. That cuts the work from all causal pairs toward the
//     pairs within documents.
//   * Blockmax from the score fragments already in registers: the thread's
//     two columns of each n8 tile, then the n8 tiles of a gate block, then
//     __shfl_xor_sync over the quad that shares a row; one lane writes each
//     (row, block); a 128-key block's max carries over its two tiles in
//     registers and is written after the second (or after the only one read
//     where the other is skipped). The softmax runs in base 2 on the
//     special-function unit (ex2.approx.ftz) with no branch inside: the
//     block size is a template parameter, and a masked score needs no
//     test, since ex2 of -1.4e30 is 0.
//   * Deterministic: no atomics, a fixed order of every sum.
//
// fp32, on the CUDA cores (gate_gt_fwd_fp32; bs 1..128): the tensor cores
// would run fp32 as TF32, about three digits, so fp32 inputs keep a plain
// tiled body. One CTA of 256 threads per (b, h, tile of 64 query rows),
// heaviest tiles first. The CTA stages its Q tile in shared memory once,
// then for each KV block from 0 to the last one that starts at or before
// the tile's last row, in chunks of at most 64 keys (a 128-key block is two):
// stages the chunk's K and V rows; computes the 64 x 64 scores (thread (ty,
// tx) owns rows 4ty..4ty+3 and columns tx + 16c); masks, takes each row's
// chunk max over the 16 lanes of its row group into the block's; folds the
// chunk into the running (m, l, acc); writes P to shared memory and
// accumulates P.V; after the block's last chunk writes its max to bm. At Dh
// 256 it holds ~194 KB of shared memory, one CTA an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32 body (CUDA cores)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kRows = 64;     // query rows per CTA: 16 row groups x 4 rows
constexpr int kChunk = 64;    // key rows staged at once: 16 lanes x 4 columns
constexpr int kMaxBlock = 128; // gate block rows (both bodies): a block of the fp32 body
                               // is staged in chunks of kChunk keys
constexpr int kPS = kChunk + 4;  // P row stride: row groups 4 apart hit other banks

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
// (elements) -> dst[r * ld + d], 16-byte loads, all of a thread's loads
// before its stores. Rows in [n, n_zero) are zeroed.
template <int DH>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* __restrict__ src,
                                           size_t stride, int n, int n_zero) {
  constexpr int kVR = DH / 4;  // float4 vectors per row
  constexpr int kUnroll = 4;
  const int nvec = n_zero * kVR;
  for (int base = threadIdx.x; base < nvec; base += kThreads * kUnroll) {
    float4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads, row = i / kVR, c = i % kVR;
      r[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < nvec && row < n) r[u] = __ldg(reinterpret_cast<const float4*>(src + row * stride) + c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads, row = i / kVR, c = i % kVR;
      if (i < nvec) *reinterpret_cast<float4*>(dst + row * ld + c * 4) = r[u];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, DH >= 256 ? 1 : 2)
    gate_gt_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg,
                     float* __restrict__ o, float* __restrict__ bm, int Lq, int Lk, int H,
                     int Hkv, int bs, int nb, float scale) {
  constexpr int kQS = DH + 4;   // Q/K row stride: float4 reads of 8 rows hit 8 bank quads
  constexpr int kKB = (kChunk * kQS > kRows * kPS) ? kChunk * kQS : kRows * kPS;
  constexpr int kNJ = DH / 16;  // output columns per thread and row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [kRows][kQS]
  float* Ks = Qs + kRows * kQS; // [kChunk][kQS]; P [kRows][kPS] once the scores are done
  float* Vs = Ks + kKB;         // [kChunk][DH]
  __shared__ int qseg[kRows];
  __shared__ int kseg[kChunk];

  const int n_tiles = gridDim.x;
  const int tile = n_tiles - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = tile * kRows;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = min(kRows, Lq - q0);

  stage_rows<DH>(Qs, kQS, q + ((size_t)b * Lq + q0) * H * DH + (size_t)h * DH,
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
  const float* kb = k + (size_t)b * Lk * Hkv * DH + (size_t)hk * DH;
  const float* vb = v + (size_t)b * Lk * Hkv * DH + (size_t)hk * DH;
  float* bm_rows = bm + ((size_t)b * H + h) * Lq * nb;

  // chunk kc: keys [c0, c0 + nk) of block jb; a block's row maxima carry
  // over its chunks (bmx) and are written after its last
  const int cpb = (bs + kChunk - 1) / kChunk;  // chunks a block
  float bmx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
  for (int kc = 0; kc < n_vis * cpb; ++kc) {
    const int jb = kc / cpb, c0 = (kc % cpb) * kChunk, nk = min(kChunk, bs - c0);
    const int k0 = jb * bs + c0;
    __syncthreads();  // the previous chunk's P.V is done with Ks (P) and Vs
    stage_rows<DH>(Ks, kQS, kb + (size_t)k0 * Hkv * DH, (size_t)Hkv * DH, nk, nk);
    stage_rows<DH>(Vs, DH, vb + (size_t)k0 * Hkv * DH, (size_t)Hkv * DH, nk, nk);
    if (tid < nk) kseg[tid] = seg != nullptr ? seg[(size_t)b * Lk + k0 + tid] : 0;
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

    // mask, the chunk's row max -> the block's (-> bm after its last
    // chunk), online softmax
    float rbm[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i, qpos = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c, kpos = k0 + col;
        const bool ok = col < nk && r < nq && kpos <= qpos && qseg[r] == kseg[col];
        s[i][c] = ok ? s[i][c] * scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      rbm[i] = group_max(mx);
      bmx[i] = c0 == 0 ? rbm[i] : fmaxf(bmx[i], rbm[i]);
    }
    if (c0 + nk == bs) {
      const int i = tx & 3, r = 4 * ty + i;
      const float val = i == 0 ? bmx[0] : i == 1 ? bmx[1] : i == 2 ? bmx[2] : bmx[3];
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
        if (tx + 16 * c < nk) Ps[(4 * ty + i) * kPS + tx + 16 * c] = s[i][c];
    __syncthreads();

    // P.V: rows 4ty+i, output columns tx+16j
    int c = 0;
    for (; c + 4 <= nk; c += 4) {
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
    for (; c < nk; ++c) {
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
    float* orow = o + (((size_t)b * Lq + q0 + r) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) orow[tx + 16 * j] = acc[i][j] * inv;
  }
  // blocks after the tile's last row: never read, fully masked
  const int nf = nb - n_vis;
  for (int e = tid; e < nq * nf; e += kThreads) {
    const int r = e / nf, jb = n_vis + e % nf;
    bm_rows[(size_t)(q0 + r) * nb + jb] = kNegInf;
  }
}

template <int DH>
int launch_fp32(const void* q, const void* k, const void* v, const void* seg, void* o,
                void* bm, int B, int Lq, int Lk, int H, int Hkv, int bs, int nb, float scale,
                cudaStream_t stream) {
  constexpr int kQS = DH + 4;
  constexpr int kKB = (kChunk * kQS > kRows * kPS) ? kChunk * kQS : kRows * kPS;
  // 194 KB at Dh 256
  const size_t smem = (size_t)(kRows * kQS + kKB + kChunk * DH) * sizeof(float);
  auto kernel = gate_gt_fwd_fp32<DH>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Lq + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<float*>(o), static_cast<float*>(bm), Lq, Lk, H,
      Hkv, bs, nb, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 body (tensor cores)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTile = 64;   // query rows of a head per CTA; keys per KV tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte (4-byte) async copy global -> shared; !valid zero-fills the
// destination and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a . b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 -> one register of two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x on the special-function unit (flushes subnormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// an accumulator fragment's rows g (c0, c1) and g + 8 (c2, c3) times their
// softmax rescale factors
__device__ __forceinline__ void rescale(float (&c)[4], float a0, float a1) {
  c[0] *= a0;
  c[1] *= a0;
  c[2] *= a1;
  c[3] *= a1;
}

// the lowest and highest segment id of each 64-row tile: out [B, nkt] int2;
// grid (nkt, B), one warp
__global__ void tile_segment_range(const int* __restrict__ seg, int2* __restrict__ out, int L,
                                   int nkt) {
  const int j = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  int lo = INT_MAX, hi = INT_MIN;
  for (int r = j * kTile + lane; r < min(L, (j + 1) * kTile); r += 32) {
    const int s = seg[(size_t)b * L + r];
    lo = min(lo, s);
    hi = max(hi, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) out[(size_t)b * nkt + j] = make_int2(lo, hi);
}

// CTA: query rows [q0, q0 + 64) of heads h0 .. h0 + HP - 1 of batch row b;
// warp w takes rows q0 + 16 w .. q0 + 16 w + 15 of every one of those heads,
// so each K and V fragment it loads feeds HP heads' products. The gate
// block is 2^BSL keys (8 .. 128): up to 64 a KV tile holds 64 >> BSL blocks;
// a 128-key block spans a pair of tiles, and each row's block max carries
// over the pair (bmc) until the block's last read tile, then one lane
// writes it. At Dh 256 one CTA fits an SM (~169 KB of shared memory).
template <int DH, int HP, int BSL>
__global__ void __launch_bounds__(128, DH >= 256 ? 1 : 2)
    gate_gt_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ seg,
                   const int2* __restrict__ tile_seg, bf16* __restrict__ o,
                   float* __restrict__ bm, int Lq, int Lk, int H, int Hkv, int nb, float scale) {
  constexpr int kNThreads = 128;
  constexpr int kLd = DH + 8;   // padded row (elements): ldmatrix rows hit distinct banks
  constexpr int kVR = DH / 8;   // 16-byte vectors per row
  constexpr int kKS = DH / 16;  // k16 steps of Q.K^T
  constexpr int kDT = DH / 8;   // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);         // [HP][64][kLd]
  bf16* Ks = Qs + HP * kTile * kLd;                      // [2][64][kLd]
  bf16* Vs = Ks + 2 * kTile * kLd;                       // [2][64][kLd]
  int* Ksg = reinterpret_cast<int*>(Vs + 2 * kTile * kLd);  // [2][64]
  int2* Tsg = reinterpret_cast<int2*>(Ksg + 2 * kTile);      // [nkt] with seg

  const int n_tiles = gridDim.x;
  const int tile = n_tiles - 1 - blockIdx.x;  // heaviest tiles of a head first
  const int h0 = blockIdx.y * HP, b = blockIdx.z;
  const int hk = h0 / (H / Hkv);              // HP divides the group: one KV head
  const int q0 = tile * kTile, nq = min(kTile, Lq - q0);
  const int tid = threadIdx.x, lane = tid & 31, wr = (tid >> 5) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const int nkt = (Lk + kTile - 1) / kTile;
  const int n_vis = min(nkt, (q0 + nq - 1) / kTile + 1);  // KV tiles at or before the last row
  constexpr int kStep = BSL > 6 ? 8 : 1 << (BSL - 3);    // n8 tiles per gate block in a tile
  constexpr int kNbt = BSL > 6 ? 1 : kTile >> BSL;        // gate blocks per KV tile
  constexpr int kTpb = BSL > 6 ? 1 << (BSL - 6) : 1;      // KV tiles per gate block

  int qlo = 0, qhi = 0;
  if (seg != nullptr) {
    for (int i = tid; i < nkt; i += kNThreads) Tsg[i] = tile_seg[(size_t)b * nkt + i];
    __syncthreads();
    qlo = Tsg[tile].x;
    qhi = Tsg[tile].y;
  }
  // KV tile j holds a document of the query tile (a pair that does not is
  // skipped: it would give p = 0 everywhere)
  auto shares_doc = [&](int j) -> bool {
    if (seg == nullptr) return true;
    const int2 r = Tsg[j];
    return qlo <= r.y && r.x <= qhi;
  };
  auto next_tile = [&](int j) {
    while (j < n_vis && !shares_doc(j)) ++j;
    return j;
  };
  auto load_kv = [&](int j, int st) {
    const int k0 = j * kTile;
    for (int i = tid; i < kTile * kVR; i += kNThreads) {
      const int r = i / kVR, c = i % kVR;
      const bool ok = k0 + r < Lk;
      const size_t off = (((size_t)b * Lk + (ok ? k0 + r : 0)) * Hkv + hk) * DH + c * 8;
      cp_async16(Ks + (st * kTile + r) * kLd + c * 8, k + off, ok);
      cp_async16(Vs + (st * kTile + r) * kLd + c * 8, v + off, ok);
    }
    if (seg != nullptr && tid < kTile) {
      const bool ok = k0 + tid < Lk;
      cp_async4(Ksg + st * kTile + tid, seg + (size_t)b * Lk + (ok ? k0 + tid : 0), ok);
    }
  };

  for (int i = tid; i < HP * kTile * kVR; i += kNThreads) {
    const int row = i / kVR, c = i % kVR, hp = row / kTile, r = row % kTile;
    const bool ok = r < nq;
    cp_async16(Qs + row * kLd + c * 8,
               q + (((size_t)b * Lq + q0 + (ok ? r : 0)) * H + h0 + hp) * DH + c * 8, ok);
  }
  int j = next_tile(0);
  if (j < n_vis) load_kv(j, 0);
  cp_async_commit();

  int qsg[2] = {0, 0};  // segment ids of the thread's rows g and g + 8
  if (seg != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wr + g + 8 * i;
      if (r < nq) qsg[i] = seg[(size_t)b * Lq + q0 + r];
    }
  }

  float m[HP][2], l[HP][2], acc[HP][kDT][4];
  float bmc[HP][2];  // kTpb > 1: the rows' max over the read tiles of block cjb
  int cjb = -1;
#pragma unroll
  for (int hp = 0; hp < HP; ++hp) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[hp][i] = kNegInf;
      l[hp][i] = 0.f;
      bmc[hp][i] = kNegInf;
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hp][dt][e] = 0.f;
  }

  // kTpb > 1: write the carried block max of block jb (one lane a row)
  auto flush_block = [&](int jb) {
#pragma unroll
    for (int hp = 0; hp < HP; ++hp)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wr + g + 8 * i;
        if (t4 == 0 && row < nq)
          bm[(((size_t)b * H + h0 + hp) * Lq + q0 + row) * nb + jb] = bmc[hp][i];
        bmc[hp][i] = kNegInf;
      }
  };

  int st = 0;
  while (j < n_vis) {
    const int jn = next_tile(j + 1);
    if (jn < n_vis) load_kv(jn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q, with the first) has landed
    __syncthreads();

    const int k0 = j * kTile;
    if (kTpb > 1 && j / kTpb != cjb) {  // the first read tile of another block
      if (cjb >= 0) flush_block(cjb);
      cjb = j / kTpb;
    }
    const bf16* ks = Ks + st * kTile * kLd;
    const bf16* vs = Vs + st * kTile * kLd;
    const int* ksg = Ksg + st * kTile;

    // S = Q.K^T: 16 rows x 64 keys a head, n8 tile n holds keys 8n .. 8n + 7
    float s[HP][8][4];
#pragma unroll
    for (int hp = 0; hp < HP; ++hp)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[hp][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t qa[HP][4];
#pragma unroll
      for (int hp = 0; hp < HP; ++hp)
        ldmatrix_x4(qa[hp], Qs + (hp * kTile + wr + (lane & 15)) * kLd + kk * 16 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 +
                            ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int hp = 0; hp < HP; ++hp) {
          mma_bf16(s[hp][2 * np], qa[hp], kf[0], kf[1]);
          mma_bf16(s[hp][2 * np + 1], qa[hp], kf[2], kf[3]);
        }
      }
    }
#pragma unroll
    for (int hp = 0; hp < HP; ++hp)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[hp][n][e] *= scale;

    // masks, only where a tile needs them: the causal edge, the Lk edge,
    // a pair of tiles that holds more than one document
    bool mixed = false;
    if (seg != nullptr) mixed = !(qlo == qhi && Tsg[j].x == Tsg[j].y);
    if (k0 + kTile - 1 > q0 + wr || k0 + kTile > Lk || mixed) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * t4 + (e & 1), kpos = k0 + col;
          const int qpos = q0 + wr + g + 8 * (e >> 1);
          const bool keep = kpos <= qpos && kpos < Lk && (!mixed || qsg[e >> 1] == ksg[col]);
#pragma unroll
          for (int hp = 0; hp < HP; ++hp)
            if (!keep) s[hp][n][e] = kNegInf;
        }
    }

    // blockmax from the fragments, the row max, the online softmax
#pragma unroll
    for (int hp = 0; hp < HP; ++hp) {
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float t[8];
#pragma unroll
        for (int n = 0; n < 8; ++n) t[n] = fmaxf(s[hp][n][2 * i], s[hp][n][2 * i + 1]);
#pragma unroll
        for (int w = 1; w < kStep; w *= 2)
#pragma unroll
          for (int n = 0; n < 8; n += 2 * w) t[n] = fmaxf(t[n], t[n + w]);
        const int row = wr + g + 8 * i;
        float* bm_row = bm + (((size_t)b * H + h0 + hp) * Lq + q0 + row) * nb;
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < 8; n += kStep) {  // the first n8 tile of each gate block
          const float x = quad_max(t[n]);
          mx = fmaxf(mx, x);
          const int jb = (k0 + 8 * n) >> BSL;
          if (kTpb == 1 && (n / kStep) % 4 == t4 && jb < nb && row < nq) bm_row[jb] = x;
        }
        if (kTpb > 1) bmc[hp][i] = fmaxf(bmc[hp][i], mx);
        const float m_new = fmaxf(m[hp][i], mx);
        alpha[i] = ex2((m[hp][i] - m_new) * kLog2e);
        m[hp][i] = m_new;
        // a row with no unmasked key yet keeps the exponent's base at 0, so
        // its masked scores give ex2(-1.4e30) = 0, not ex2(0) = 1
        const float mb = m_new > 0.5f * kNegInf ? m_new * kLog2e : 0.f;
        float ps = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            const float p = ex2(fmaf(s[hp][n][e], kLog2e, -mb));
            s[hp][n][e] = p;
            ps += p;
          }
        l[hp][i] = alpha[i] * l[hp][i] + ps;
      }
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) rescale(acc[hp][dt], alpha[0], alpha[1]);
    }

    // O += P.V: P in bf16 straight from the score registers as the A operand
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[HP][4];
#pragma unroll
      for (int hp = 0; hp < HP; ++hp) {
        pa[hp][0] = pack_bf16(s[hp][2 * kc][0], s[hp][2 * kc][1]);
        pa[hp][1] = pack_bf16(s[hp][2 * kc][2], s[hp][2 * kc][3]);
        pa[hp][2] = pack_bf16(s[hp][2 * kc + 1][0], s[hp][2 * kc + 1][1]);
        pa[hp][3] = pack_bf16(s[hp][2 * kc + 1][2], s[hp][2 * kc + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                  dp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int hp = 0; hp < HP; ++hp) {
          mma_bf16(acc[hp][2 * dp], pa[hp], vf[0], vf[1]);
          mma_bf16(acc[hp][2 * dp + 1], pa[hp], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
    j = jn;
    st ^= 1;
  }
  cp_async_wait<0>();
  if (kTpb > 1 && cjb >= 0) flush_block(cjb);

#pragma unroll
  for (int hp = 0; hp < HP; ++hp)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wr + g + 8 * i;
      const float inv = 1.f / fmaxf(quad_sum(l[hp][i]), 1e-30f);
      if (row >= nq) continue;
      bf16* orow = o + (((size_t)b * Lq + q0 + row) * H + h0 + hp) * DH + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * dt) =
            __floats2bfloat162_rn(acc[hp][dt][2 * i] * inv, acc[hp][dt][2 * i + 1] * inv);
    }
  // the blocks none of whose KV tiles was read (past the tile's last row,
  // or sharing no document): fully masked
  for (int jb0 = 0; jb0 < nb; jb0 += kNbt) {
    bool read = false;
#pragma unroll
    for (int u = 0; u < kTpb; ++u) {
      const int jt = (jb0 << BSL) / kTile + u;
      read = read || (jt < n_vis && shares_doc(jt));
    }
    if (read) continue;
    const int nbj = min(kNbt, nb - jb0), per = nq * nbj;
    for (int e = tid; e < HP * per; e += kNThreads) {
      const int hp = e / per, r = (e % per) / nbj, jb = jb0 + e % nbj;
      bm[(((size_t)b * H + h0 + hp) * Lq + q0 + r) * nb + jb] = kNegInf;
    }
  }
}


template <int DH, int HP, int BSL>
int launch_tc(const void* q, const void* k, const void* v, const void* seg, void* tile_seg,
              void* o, void* bm, int B, int Lq, int Lk, int H, int Hkv, int nb, float scale,
              cudaStream_t stream) {
  const int nkt = (Lk + kTile - 1) / kTile;
  const size_t smem = (size_t)(HP + 4) * kTile * (DH + 8) * sizeof(bf16) +
                      2 * kTile * sizeof(int) + (seg != nullptr ? nkt * sizeof(int2) : 0);
  auto kernel = gate_gt_fwd_tc<DH, HP, BSL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (seg != nullptr) {
    tile_segment_range<<<dim3(nkt, B), 32, 0, stream>>>(static_cast<const int*>(seg),
                                                        static_cast<int2*>(tile_seg), Lk, nkt);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Lq + kTile - 1) / kTile, H / HP, B);
  kernel<<<grid, 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const int2*>(tile_seg), static_cast<bf16*>(o),
      static_cast<float*>(bm), Lq, Lk, H, Hkv, nb, scale);
  return (int)cudaGetLastError();
}

template <int DH, int HP>
int tc_by_block(const void* q, const void* k, const void* v, const void* seg, void* tile_seg,
                void* o, void* bm, int B, int Lq, int Lk, int H, int Hkv, int bs, int nb,
                float scale, cudaStream_t s) {
  switch (bs) {
    case 8: return launch_tc<DH, HP, 3>(q, k, v, seg, tile_seg, o, bm, B, Lq, Lk, H, Hkv, nb, scale, s);
    case 16: return launch_tc<DH, HP, 4>(q, k, v, seg, tile_seg, o, bm, B, Lq, Lk, H, Hkv, nb, scale, s);
    case 32: return launch_tc<DH, HP, 5>(q, k, v, seg, tile_seg, o, bm, B, Lq, Lk, H, Hkv, nb, scale, s);
    case 64: return launch_tc<DH, HP, 6>(q, k, v, seg, tile_seg, o, bm, B, Lq, Lk, H, Hkv, nb, scale, s);
    case 128: return launch_tc<DH, HP, 7>(q, k, v, seg, tile_seg, o, bm, B, Lq, Lk, H, Hkv, nb, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int HP>
int tc_by_head_dim(const void* q, const void* k, const void* v, const void* seg,
                   void* tile_seg, void* o, void* bm, int B, int Lq, int Lk, int H, int Hkv,
                   int Dh, int bs, int nb, float scale, cudaStream_t s) {
  switch (Dh) {
    case 16: return tc_by_block<16, HP>(q, k, v, seg, tile_seg, o, bm, B, Lq, Lk, H, Hkv, bs, nb, scale, s);
    case 32: return tc_by_block<32, HP>(q, k, v, seg, tile_seg, o, bm, B, Lq, Lk, H, Hkv, bs, nb, scale, s);
    case 64: return tc_by_block<64, HP>(q, k, v, seg, tile_seg, o, bm, B, Lq, Lk, H, Hkv, bs, nb, scale, s);
    case 128: return tc_by_block<128, HP>(q, k, v, seg, tile_seg, o, bm, B, Lq, Lk, H, Hkv, bs, nb, scale, s);
    case 256:  // HP 1 only: two heads' output fragments would not fit the registers
      if constexpr (HP == 1)
        return tc_by_block<256, 1>(q, k, v, seg, tile_seg, o, bm, B, Lq, Lk, H, Hkv, bs, nb, scale, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

int fp32_by_head_dim(const void* q, const void* k, const void* v, const void* seg, void* o,
                     void* bm, int B, int Lq, int Lk, int H, int Hkv, int Dh, int bs, int nb,
                     float scale, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch_fp32<16>(q, k, v, seg, o, bm, B, Lq, Lk, H, Hkv, bs, nb, scale, s);
    case 32: return launch_fp32<32>(q, k, v, seg, o, bm, B, Lq, Lk, H, Hkv, bs, nb, scale, s);
    case 64: return launch_fp32<64>(q, k, v, seg, o, bm, B, Lq, Lk, H, Hkv, bs, nb, scale, s);
    case 128: return launch_fp32<128>(q, k, v, seg, o, bm, B, Lq, Lk, H, Hkv, bs, nb, scale, s);
    case 256: return launch_fp32<256>(q, k, v, seg, o, bm, B, Lq, Lk, H, Hkv, bs, nb, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA-core body, bs 1..128), 1 = bfloat16 (tensor-core
// body, bs 8, 16, 32, 64 or 128) for q, k, v and o; Dh 16, 32, 64, 128 or
// 256 (the bf16 body takes GQA head pairs, HP 2, at Dh <= 128 only). seg may be null; with seg and
// bf16, tile_seg is scratch of B * ceil(Lk / 64) int2. q, k, v must be
// 16-byte aligned. Returns cudaGetLastError() after the launch.
int gate_gt_fwd_launch(const void* q, const void* k, const void* v, const void* seg,
                       void* tile_seg, void* o, void* bm, int B, int Lq, int Lk, int H, int Hkv,
                       int Dh, int bs, int nb, float scale, int dtype, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || bs <= 0 ||
      bs > kMaxBlock || nb * bs != Lk || H > 65535 || B > 65535 ||
      (seg != nullptr && Lq != Lk) || (uintptr_t)q % 16 || (uintptr_t)k % 16 ||
      (uintptr_t)v % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fp32_by_head_dim(q, k, v, seg, o, bm, B, Lq, Lk, H, Hkv, Dh, bs, nb, scale, s);
  if (dtype != 1 || (seg != nullptr && tile_seg == nullptr)) return (int)cudaErrorInvalidValue;
  if ((H / Hkv) % 2 == 0 && Dh <= 128)
    return tc_by_head_dim<2>(q, k, v, seg, tile_seg, o, bm, B, Lq, Lk, H, Hkv, Dh, bs, nb,
                             scale, s);
  return tc_by_head_dim<1>(q, k, v, seg, tile_seg, o, bm, B, Lq, Lk, H, Hkv, Dh, bs, nb, scale,
                           s);
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
