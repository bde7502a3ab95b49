// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of
// flexflow_tpu/kernels/flash_attention.py:
//
//   flash_fwd_tc_kernel<.., false> (bf16) and
//   flash_fwd_kernel<float, .., false>      <- `_flash_kernel` with
//                                  save_lse=True (`_flash_forward`)
//   flash_fwd_tc_kernel<.., true> (bf16) and
//   flash_fwd_kernel<float, .., true>       <- `_flash_kernel` with
//                                  partial_out=True
//                                  (`_flash_forward_partial`, ring
//                                  attention's block step)
//   flash_bwd_dq_tc_kernel (bf16) and
//   flash_bwd_dq_kernel<float, ..>   <- `_flash_bwd_dq_kernel`
//                                  (`_flash_backward`)
//   flash_bwd_dkv_tc_kernel (bf16) and
//   flash_bwd_dkv_kernel<float, ..>  <- `_flash_bwd_dkv_kernel`
//                                  (`_flash_backward`)
//
// It computes the same functions, not the same blocking.  For one (b, h):
//
//   s   = q k^T * scale, causal entries above the end-aligned diagonal
//         (col > row + Sk - Sq) filled with the finite -1e30
//   out = softmax(s) v,   lse = m + log(max(l, 1e-30))
//   dq  = ds k,  dk = ds^T q,  dv = p^T dO,
//   p   = exp(s - lse),  ds = p * (dO v^T - delta) * scale,
//
// where delta = rowsum(dO * out) comes from the caller in fp32, as the
// reference computes it outside Pallas.  Operands are [B, S, H, D] (fp32
// or bf16) read in place: no transpose to [B*H, S, D] around the call.
// lse and delta are [B, H, Sq] fp32.  All math is fp32 with the
// reference's roundings for bf16: products of two bf16 values are exact
// in fp32, p is rounded to bf16 (against the running row max in the
// forwards) before p.v and before p^T dO, ds before ds.k and ds^T.q.
// Any Sq, Sk >= 1; the ragged edge is masked.
//
// Rows with no live key (causal with Sq > Sk, rows < Sq - Sk) follow the
// reference's XLA path, not the Pallas kernel (whose value there depends
// on its block size): attention is uniform over all Sk keys (out = mean
// of v, lse = log Sk), and such rows get zero ds, so no dq and no dk, and
// dv += dO / Sk.
//
// The partial-output forward writes the UNNORMALIZED online-softmax
// state in place of out and lse, for ring attention to merge across
// ranks: acc [B, H, Sq, D] = sum_j exp(s_j - m) v_j, m and l [B, H, Sq]
// (the row max and sum_j exp(s_j - m)), all fp32; no l floor and no
// division (the ring divides after its last merge).  A row with no live
// key gets the XLA twin's (`_xla_attention_partial`) values: every logit
// is -1e30, so m = -1e30, l = Sk and acc = sum of v.  The ring never
// makes such rows (its calls have Sq == Sk, or no mask).
//
// What bounds the bf16 forward on the card.  At the training path's
// shape (B 8, S 1024, H 12, D 64, causal) one layer's forward moves
// about 50 MB (q, k, v, out read or written once) and does about 12.9
// GFLOP over 50.4 M live (q, k) pairs: 15 us of bytes at 3.35 TB/s
// against 13 us of dense bf16 tensor-core time, so the two sit close;
// scalar fp32 FMAs (67 TFLOP/s) could not go below 0.19 ms.  The partial
// forward at the zigzag ring's half-chunk shape (B 2, Sq = Sk = 512, H
// 12, D 64, no mask) reads q, k, v once (4.7 MB) and writes acc, m and l
// (3.2 MB): 2.4 us of bytes against 1.6 us of tensor-core time, and its
// fp32 acc is two thirds of the bytes (the price of a merge across ranks
// in fp32, as the reference's).
//
// What the bf16 forward's design does about it (flash_fwd_tc_kernel):
// both products run on the tensor cores as wgmma, from operands that
// TMA copies into shared memory in bf16, so no thread spends
// instructions or registers on loads.  One block per (b, h, 64-row q
// tile): 64-row tiles give 192 blocks on 132 SMs at the half-chunk
// shape, where 128-row tiles would leave 36 SMs idle; the q tiles are
// the grid's outermost dimension in reverse, so under a causal mask the
// blocks with the most k tiles start first.  A producer warp loads the q
// tile once and streams K and V tiles through a 3-stage ring (full /
// empty mbarriers), so loads run two tiles ahead of the products; the
// consumer warpgroup computes s = q k^T (m64n64k16 from shared memory),
// runs the online softmax on the accumulator fragment in registers (a
// row lives in a quad of lanes: two shuffles per reduction), converts p
// to bf16 in registers into the A fragment of o += p v (v MN-major from
// shared memory through the transpose bit), so p never touches shared
// memory.  The softmax of tile kb runs while p v of tile kb - 1 is still
// on the tensor cores (s of tile kb is issued with it, and o is rescaled
// once both are done).  Head dims pad to 64 or 128 columns in
// shared memory: TMA zero-fills columns past D and rows past S, zero
// columns add nothing to either product, and zero-filled keys are masked
// by col < Sk.  The causal block skip of the TPU kernel is kept, and only
// tiles that cross the diagonal or the ragged end evaluate the mask.
// The epilogue stages the tile in shared memory and writes it with
// coalesced 16-byte stores.
//
// What bounds the bf16 backward pair.  At the training shape dq does
// three products per live pair (s = q k^T, dp = dO v^T, ds k: 19.4
// GFLOP) and dkv four (s^T, dp^T, p^T dO, ds^T q: 25.8 GFLOP), against
// about 63 MB (dq) and 76 MB (dkv) of operands read and gradients
// written once: 20 and 26 us of dense bf16 tensor-core time against 19
// and 23 us of bytes, so both sit near the line, the products a little
// above it; scalar fp32 FMAs could not go below 0.29 and 0.39 ms.
//
// What their design does about it (flash_bwd_dq_tc_kernel,
// flash_bwd_dkv_tc_kernel): the forward's TMA maps, 3-stage ring and its
// two wgmma forms only.  Every product is either "A and B K-major from
// shared memory" (issue_qk: s, dp, and the transposed s^T = k q^T, dp^T
// = v dO^T) or "A as bf16 pairs in registers, B MN-major from shared
// memory" (issue_pv: ds k in dq; p^T dO and ds^T q in dkv).  dq: one
// block per (b, h, 64-row q tile), q and dO loaded once by TMA, K and V
// streamed through the ring; each thread keeps its two rows' lse and
// delta in registers and turns the s and dp fragments into ds in
// registers (the mask only on edge tiles), rounded to bf16 into the A
// fragment of dq += ds k.  dkv: one block per (b, h, 64-row k tile), k
// and v loaded once, q, dO and the q tile's 64 lse and delta values
// streamed (lse and delta by plain loads into the stage's slot: rows of
// [B, H, Sq] are 16-byte aligned only when Sq % 4 == 0); the fragments
// are transposed, rows keys and columns queries, so p^T and ds^T are A
// fragments as they stand, and each thread reads its 16 columns' lse
// and delta from the slot.  In both, the next tile's two score products
// are issued with this tile's gradient products, the elementwise pass
// runs while the latter are on the tensor cores, and a stage is refilled
// (loads two tiles ahead) once a block barrier shows every warp's last
// wgmma on it is done.  Unlike the forward, the blocks have no producer
// warp: thread 0 issues the loads.  Each of the SM's four register
// files serves every fourth warp of a block, so a fifth warp shares one
// with another warp of the block; dkv's threads need about 190
// registers (dk, dv, s^T, dp^T: 4 x 32 fp32, two A fragments of 16, and
// addresses), and with a producer warp only one block fits an SM (at D'
// = 128, 9 warps cap a thread at 168 registers and it spills); without,
// two, and dq's three.  Every output element is written once by one
// block in a fixed order: no atomics, so two calls give bit-equal
// gradients.  At D' = 128, dk and dv alone would take 128 registers, so
// the dkv block has two warpgroups, each owning 64 columns of dk and dv
// and recomputing s^T and dp^T (1.5x the products, spill-free; D' = 128
// is no main path's width).  dq at D' = 128 holds its 64 accumulators in
// one warpgroup.
//
// fp32 keeps the scalar design (flash_fwd_kernel<float, ..>,
// flash_bwd_dq_kernel<float, ..>, flash_bwd_dkv_kernel<float, ..>): one
// block per (b, h, 64-row tile) keeps its q tile (forward, dq) or its k
// and v tiles (dkv) in shared memory while it walks the other axis, so
// no [Sq, Sk] matrix reaches device memory; 256 threads each own a 4x4
// patch of the score tile, scalar fp32 FMAs from shared memory (row
// stride D+1, free of bank conflicts).  TF32 products would break fp32
// parity with the reference.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // q rows and k rows per tile
constexpr int kLdS = kTile + 1;  // row stride of the score tiles in shared
constexpr float kNegInf = -1e30f;  // the reference's finite mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision (the identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// reductions over the 16 lanes that share a row group
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [row0, row0 + kTile) of one head of a [B, S, H, D] tensor into
// shared memory as fp32, row stride D + 1; rows at or past S read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          size_t head_base, int row0, int S,
                                          int HD) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] =
        row < S ? to_f32(src[head_base + (size_t)row * HD + c]) : 0.f;
  }
}

// s[a][j] = sum_d A[ty*4 + a][d] * Bm[tx + 16*j][d]  (both tiles stride D+1)
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4],
                                         const float* __restrict__ A,
                                         const float* __restrict__ Bm,
                                         int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty * 4 + a) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bm[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = fmaf(av[a], bv[j], s[a][j]);
  }
}

// acc[a][e] += sum_j P[ty*4 + a][j] * X[j][tx + 16*e]  (P stride kLdS)
template <int D>
__device__ __forceinline__ void tile_acc(float (&acc)[4][D / 16],
                                         const float* __restrict__ P,
                                         const float* __restrict__ X, int ty,
                                         int tx) {
  constexpr int NE = D / 16;
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float pv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) pv[a] = P[(ty * 4 + a) * kLdS + j];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const float x = X[j * (D + 1) + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][e] = fmaf(pv[a], x, acc[a][e]);
    }
  }
}

// the logit of (row, col) after masking; a row with no live key (causal,
// row + off < 0) takes `dead` everywhere: 0 gives uniform attention,
// -1e30 the partial's m = -1e30 (both give p = 1 for every key)
__device__ __forceinline__ float masked_logit(float dot, int row, int col,
                                              int off, int causal,
                                              float scale, float dead = 0.f) {
  if (!causal) return dot * scale;
  if (row + off < 0) return dead;
  return row + off >= col ? dot * scale : kNegInf;
}

// The scalar forward, launched for fp32 (bf16 takes flash_fwd_tc_kernel).
// Partial = false: out [B, Sq, H, D] in T and lse [B, H, Sq] (o0, o1).
// Partial = true: acc [B, H, Sq, D], m and l [B, H, Sq], fp32 (o0-o2).
template <typename T, int D, bool Partial>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, void* __restrict__ o0,
                     float* __restrict__ o1, float* __restrict__ o2, int H,
                     int Sq, int Sk, int causal, float scale) {
  constexpr int NE = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sP = sV + kTile * (D + 1);

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int HD = H * D;
  const int off = Sk - Sq;
  const size_t q_base = (size_t)b * Sq * HD + (size_t)h * D;
  const size_t k_base = (size_t)b * Sk * HD + (size_t)h * D;

  load_tile<T, D>(sQ, q, q_base, q0, Sq, HD);

  float m[4], l[4], acc[4][NE];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[a][e] = 0.f;
  }

  // causal block skip: k tiles past the last live key of the tile's last
  // row hold nothing; a tile with a row that has no live key reads all
  const int q_last = min(q0 + kTile, Sq) - 1;
  int nk = (Sk + kTile - 1) / kTile;
  if (causal && q0 + off >= 0) nk = min(nk, (q_last + off) / kTile + 1);

  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();  // every reader of the previous k tile is done
    load_tile<T, D>(sK, k, k_base, k0, Sk, HD);
    load_tile<T, D>(sV, v, k_base, k0, Sk, HD);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + ty * 4 + a;
      float m_cur = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        s[a][j] = masked_logit(s[a][j], row, col, off, causal, scale,
                               Partial ? kNegInf : 0.f);
        if (col < Sk) m_cur = fmaxf(m_cur, s[a][j]);
      }
      const float m_new = fmaxf(m[a], group_max(m_cur));
      const float alpha = expf(m[a] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = col < Sk ? expf(s[a][j] - m_new) : 0.f;
        psum += p;
        sP[(ty * 4 + a) * kLdS + tx + 16 * j] = round_to<T>(p);
      }
      l[a] = l[a] * alpha + group_sum(psum);
      m[a] = m_new;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[a][e] *= alpha;
    }
    __syncthreads();
    tile_acc<D>(acc, sP, sV, ty, tx);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty * 4 + a;
    if (row >= Sq) continue;
    const size_t r = ((size_t)b * H + h) * Sq + row;
    if (Partial) {
      float* arow = static_cast<float*>(o0) + r * D;
#pragma unroll
      for (int e = 0; e < NE; ++e) arow[tx + 16 * e] = acc[a][e];
      if (tx == 0) {
        o1[r] = m[a];
        o2[r] = l[a];
      }
    } else {
      const float lf = fmaxf(l[a], 1e-30f);
      T* orow = static_cast<T*>(o0) + q_base + (size_t)row * HD;
#pragma unroll
      for (int e = 0; e < NE; ++e)
        orow[tx + 16 * e] = from_f32<T>(acc[a][e] / lf);
      if (tx == 0) o1[r] = m[a] + logf(lf);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int Sq, int Sk, int causal, float scale) {
  constexpr int NE = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kTile * (D + 1);
  float* sK = sDO + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sDS = sV + kTile * (D + 1);

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int HD = H * D;
  const int off = Sk - Sq;
  const size_t q_base = (size_t)b * Sq * HD + (size_t)h * D;
  const size_t k_base = (size_t)b * Sk * HD + (size_t)h * D;
  const size_t r_base = ((size_t)b * H + h) * Sq;

  load_tile<T, D>(sQ, q, q_base, q0, Sq, HD);
  load_tile<T, D>(sDO, dout, q_base, q0, Sq, HD);
  float lse_r[4], delta_r[4], acc[4][NE];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty * 4 + a;
    lse_r[a] = row < Sq ? lse[r_base + row] : 0.f;
    delta_r[a] = row < Sq ? delta[r_base + row] : 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[a][e] = 0.f;
  }

  // rows with no live key get ds = 0, so only live keys need a k tile
  const int q_last = min(q0 + kTile, Sq) - 1;
  int nk = (Sk + kTile - 1) / kTile;
  if (causal) nk = q_last + off < 0 ? 0 : min(nk, (q_last + off) / kTile + 1);

  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();
    load_tile<T, D>(sK, k, k_base, k0, Sk, HD);
    load_tile<T, D>(sV, v, k_base, k0, Sk, HD);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sDO, sV, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + ty * 4 + a;
      const bool row_live = row < Sq && !(causal && row + off < 0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = expf(
            masked_logit(s[a][j], row, col, off, causal, scale) - lse_r[a]);
        const float ds = (row_live && col < Sk)
                             ? p * (dp[a][j] - delta_r[a]) * scale
                             : 0.f;
        sDS[(ty * 4 + a) * kLdS + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
    tile_acc<D>(acc, sDS, sK, ty, tx);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty * 4 + a;
    if (row >= Sq) continue;
    T* drow = dq + q_base + (size_t)row * HD;
#pragma unroll
    for (int e = 0; e < NE; ++e) drow[tx + 16 * e] = from_f32<T>(acc[a][e]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Sq, int Sk,
                         int causal, float scale) {
  constexpr int NE = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * (D + 1);
  float* sQ = sV + kTile * (D + 1);
  float* sDO = sQ + kTile * (D + 1);
  float* sPT = sDO + kTile * (D + 1);
  float* sDST = sPT + kTile * kLdS;
  float* sL = sDST + kTile * kLdS;
  float* sDel = sL + kTile;

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int HD = H * D;
  const int off = Sk - Sq;
  const size_t q_base = (size_t)b * Sq * HD + (size_t)h * D;
  const size_t k_base = (size_t)b * Sk * HD + (size_t)h * D;
  const size_t r_base = ((size_t)b * H + h) * Sq;

  load_tile<T, D>(sK, k, k_base, k0, Sk, HD);
  load_tile<T, D>(sV, v, k_base, k0, Sk, HD);
  float acc_k[4][NE], acc_v[4][NE];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      acc_k[a][e] = 0.f;
      acc_v[a][e] = 0.f;
    }

  // causal block skip (the reference's rule at flash_attention.py:262):
  // q tiles whose last row sees no key of this tile contribute nothing.
  // With Sq > Sk the rows without a live key (the first Sq - Sk) add
  // dO / Sk to dv, so every q tile is read.
  int ib0 = 0;
  if (causal && off >= 0 && k0 - off > 0) ib0 = (k0 - off) / kTile;
  const int nq = (Sq + kTile - 1) / kTile;

  for (int ib = ib0; ib < nq; ++ib) {
    const int i0 = ib * kTile;
    __syncthreads();
    load_tile<T, D>(sQ, q, q_base, i0, Sq, HD);
    load_tile<T, D>(sDO, dout, q_base, i0, Sq, HD);
    if (threadIdx.x < kTile) {
      const int row = i0 + threadIdx.x;
      sL[threadIdx.x] = row < Sq ? lse[r_base + row] : 0.f;
      sDel[threadIdx.x] = row < Sq ? delta[r_base + row] : 0.f;
    }
    __syncthreads();
    // transposed tiles: thread patch rows are keys, columns are queries
    float s[4][4], dp[4][4];
    tile_dot<D>(s, sK, sQ, ty, tx);
    tile_dot<D>(dp, sV, sDO, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int col = k0 + ty * 4 + a;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = tx + 16 * j;
        const int row = i0 + i;
        const bool valid = row < Sq && col < Sk;
        const float p =
            valid ? expf(masked_logit(s[a][j], row, col, off, causal, scale) -
                         sL[i])
                  : 0.f;
        const bool row_live = !(causal && row + off < 0);
        const float ds =
            (valid && row_live) ? p * (dp[a][j] - sDel[i]) * scale : 0.f;
        sPT[(ty * 4 + a) * kLdS + i] = round_to<T>(p);
        sDST[(ty * 4 + a) * kLdS + i] = round_to<T>(ds);
      }
    }
    __syncthreads();
    tile_acc<D>(acc_v, sPT, sDO, ty, tx);
    tile_acc<D>(acc_k, sDST, sQ, ty, tx);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int col = k0 + ty * 4 + a;
    if (col >= Sk) continue;
    T* krow = dk + k_base + (size_t)col * HD;
    T* vrow = dv + k_base + (size_t)col * HD;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      krow[tx + 16 * e] = from_f32<T>(acc_k[a][e]);
      vrow[tx + 16 * e] = from_f32<T>(acc_v[a][e]);
    }
  }
}


// ---------------------------------------------------------------------------
// The bf16 forward on the tensor cores: flash_fwd_tc_kernel<D, Partial>.
//
// One block per (64-row q tile, h, b): warps 0-3 are one consumer
// warpgroup that owns the 64 query rows, warp 4 the producer, whose lane
// 0 issues every load.  Head dims pad to DP = 64 (D <= 64) or 128 in
// shared memory; each operand tile is DP / 64 boxes of 64 rows x 64
// columns (128 bytes a row, 8 KB a box), written by TMA with the 128-byte
// swizzle that the wgmma descriptors name.
constexpr int kTcThreads = 160;  // one consumer warpgroup + a producer warp
constexpr int kStages = 3;       // K/V tiles in flight
constexpr int kBox = 64 * 128;   // bytes of one 64 x 64 bf16 box
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of `bar` with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a [B, S, H, D] bf16 tensor, (d0, h, row, b) its first
// element, into shared memory; completion counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int d0, int h, int row, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(h), "r"(row), "r"(b),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor with the 128-byte swizzle; strides in
// bytes (lbo: between 64-column boxes along a MN-major operand's N;
// sbo: between groups of 8 rows)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// the consumer warpgroup's own barrier (the producer warp never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// d[64 x 64] (+)= A (shared, K-major) * B (shared, K-major)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A (registers, bf16 pairs) * B (shared, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A (registers, bf16 pairs) * B (shared, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 64) {
    wgmma_m64n64k16_rs(o, a, db);
  } else {
    wgmma_m64n128k16_rs(o, a, db);
  }
}

// What the online softmax of one thread needs about its two rows.
struct Rows {
  int row[2];  // global query rows (16w + g and + 8)
  int c;       // lane & 3: the thread's column pair in each 8 columns
  int q0, Sk, off, causal;
  float scale;
  float dead;  // the logit of a row with no live key
};

// s = q k^T of one k tile: DP/16 k-steps of 16 columns, each 32 bytes on
// along the swizzled 128-byte rows of a box; one committed group
template <int DP>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q,
                                         uint32_t k) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t step = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_m64n64k16_ss(s, smem_desc(q + step, 16, 1024),
                       smem_desc(k + step, 16, 1024), 1);
  }
  wgmma_commit();
}

// o += p v: v is MN-major (d contiguous); 16 keys are two 1024-byte
// groups of 8 rows, the second 64-column box kBox bytes on; one group
template <int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&pa)[4][4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv<DP>(o, pa[kk], smem_desc(v + kk * 2048, kBox, 1024));
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The online softmax of the k tile at k0 on the score fragment s: scale,
// mask (only on tiles that cross the causal diagonal or the ragged end;
// zero-filled keys past Sk are masked too), update the row max m and sum
// l, leave p in s and the factor that rescales o in alpha.
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2],
                                               const Rows& r, int k0) {
  const bool edge =
      k0 + kTile > r.Sk || (r.causal && k0 + kTile - 1 > r.q0 + r.off);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float x = s[i] * r.scale;
    if (edge) {
      const int col = k0 + 8 * (i >> 2) + 2 * r.c + (i & 1);
      const int row = r.row[h] + r.off;
      if (r.causal) x = row < 0 ? r.dead : (row >= col ? x : kNegInf);
      if (col >= r.Sk) x = -INFINITY;
    }
    s[i] = x;
    mx[h] = fmaxf(mx[h], x);
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]));
    // (a - b) * log2 e, never a fused product: at a row with no live
    // key a == b == -1e30 and the difference must be exactly 0
    alpha[h] = exp2f((m[h] - m_new) * kLog2e);
    m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = exp2f((s[i] - m[h]) * kLog2e);
    psum[h] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(psum[h]);
}

// p to bf16 in registers: the score fragment's columns 16kk..16kk+15 are
// the A fragment of the kk-th k-step of p v
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4],
                                       const float (&p)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] = pack_bf16(p[8 * kk + 2 * j], p[8 * kk + 2 * j + 1]);
}

// A thread's share of a 64 x NC accumulator fragment (rows 16 wq + g and
// + 8) in bf16 into shared memory at `tile`, in the layout of the TMA
// boxes (128-byte rows, 16-byte chunks swizzled by the row), so that
// store_rows_bf16 can write whole rows with 16-byte stores
template <int NC>
__device__ __forceinline__ void stage_bf16(uint8_t* tile,
                                           const float (&o)[NC / 2], int wq,
                                           int g, int c) {
#pragma unroll
  for (int i = 0; i < NC / 2; i += 2) {
    const int lr = wq * 16 + g + 8 * ((i >> 1) & 1);
    const int j = i >> 2;
    const int at = (j >> 3) * kBox + lr * 128 + (((j & 7) ^ (lr & 7)) << 4)
                   + 4 * c;
    *reinterpret_cast<uint32_t*>(tile + at) = pack_bf16(o[i], o[i + 1]);
  }
}

// the backward's barriers, which have no empty half: kStages full ones
// and one for the tiles loaded once, each completed by thread 0's
// arrive + the bytes
__device__ __forceinline__ void init_loads(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(smem_u32(bars + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// the first nrow rows of a staged tile to head h of a bf16 [B, S, H, D]
// tensor, rows row0 = b * S + (the tile's first row) on, D / 8 16-byte
// chunks a row, by the block's first nthreads threads
__device__ __forceinline__ void store_rows_bf16(const uint8_t* tile,
                                                __nv_bfloat16* out,
                                                size_t row0, int H, int h,
                                                int D, int nrow,
                                                int nthreads) {
  const int n8 = D / 8;
  for (int idx = threadIdx.x; idx < nrow * n8; idx += nthreads) {
    const int r = idx / n8;
    const int ch = idx - r * n8;
    const int at = (ch >> 3) * kBox + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(out + ((row0 + r) * H + h) * D + ch * 8) =
        *reinterpret_cast<const uint4*>(tile + at);
  }
}

// The bf16 forward for head dims padded to DP (64 or 128) in shared
// memory.  Partial = false: out [B, Sq, H, D] bf16 and lse [B, H, Sq]
// (o0, o1); Partial = true: acc [B, H, Sq, D], m and l [B, H, Sq], fp32
// (o0-o2).  q, k, v come through the tensor maps mq, mk, mv.
//
// Accumulator register i of a thread (lane = 4g + c of warp w) holds row
// 16w + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2c + (i & 1) of its
// 64-row tile: each row lives in one quad of lanes.
template <int DP, bool Partial>
__global__ void __launch_bounds__(kTcThreads)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        void* __restrict__ o0, float* __restrict__ o1,
                        float* __restrict__ o2, int H, int Sq, int Sk, int D,
                        int causal, float scale) {
  constexpr int NB = DP / 64;             // boxes per operand tile
  constexpr int kTileBytes = NB * kBox;   // one operand tile
  extern __shared__ uint8_t tc_smem[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* base = tc_smem + ((1024 - (smem_u32(tc_smem) & 1023)) & 1023);
  const uint32_t sq = smem_u32(base);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(base + (1 + 2 * kStages) * kTileBytes);
  auto k_tile = [&](int st) { return sq + (1 + 2 * st) * kTileBytes; };
  auto v_tile = [&](int st) { return sq + (2 + 2 * st) * kTileBytes; };
  auto full = [&](int st) { return smem_u32(bars + st); };
  auto empty = [&](int st) { return smem_u32(bars + kStages + st); };
  const uint32_t q_ready = smem_u32(bars + 2 * kStages);

  // the q tiles in reverse, outermost: under a causal mask the blocks
  // with the most k tiles start first, every head's at once
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int off = Sk - Sq;
  // causal block skip: k tiles past the last live key of the tile's last
  // row hold nothing; a tile with a row that has no live key reads all
  const int q_last = min(q0 + kTile, Sq) - 1;
  int nk = (Sk + kTile - 1) / kTile;
  if (causal && q0 + off >= 0) nk = min(nk, (q_last + off) / kTile + 1);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);   // the producer's arrive + the bytes
      mbar_init(empty(st), 4);  // one arrive per consumer warp
    }
    mbar_init(q_ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // producer: Q once, then K and V through the ring
    if (lane == 0) {
      mbar_expect_tx(q_ready, kTileBytes);
      for (int bx = 0; bx < NB; ++bx)
        tma_load(sq + bx * kBox, &mq, bx * 64, h, q0, b, q_ready);
      for (int kb = 0; kb < nk; ++kb) {
        const int st = kb % kStages;
        if (kb >= kStages) mbar_wait(empty(st), (kb / kStages - 1) & 1);
        mbar_expect_tx(full(st), 2 * kTileBytes);
        for (int bx = 0; bx < NB; ++bx) {
          tma_load(k_tile(st) + bx * kBox, &mk, bx * 64, h, kb * kTile, b,
                   full(st));
          tma_load(v_tile(st) + bx * kBox, &mv, bx * 64, h, kb * kTile, b,
                   full(st));
        }
      }
    }
    return;
  }

  // consumers: 4 warps x 16 rows.  The products of consecutive tiles
  // overlap the softmax: s of tile kb is issued with p v of tile kb - 1,
  // and the softmax of tile kb runs while p v is still in flight.
  const int g = lane >> 2;
  const int c = lane & 3;
  const Rows rows{{q0 + warp * 16 + g, q0 + warp * 16 + g + 8}, c, q0, Sk,
                  off, causal, scale, Partial ? kNegInf : 0.f};
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float s[32], alpha[2];
  uint32_t pa[4][4];

  mbar_wait(q_ready, 0);
  mbar_wait(full(0), 0);
  issue_qk<DP>(s, sq, k_tile(0));
  wgmma_wait<0>();
  online_softmax(s, m, l, alpha, rows, 0);
  pack_p(pa, s);
  for (int kb = 1; kb < nk; ++kb) {
    const int st = kb % kStages;
    const int prev = (kb - 1) % kStages;
    mbar_wait(full(st), (kb / kStages) & 1);
    issue_qk<DP>(s, sq, k_tile(st));  // its fence also covers o and pa
    issue_pv<DP>(o, pa, v_tile(prev));
    wgmma_wait<1>();  // s is ready; p v of tile kb - 1 may still run
    online_softmax(s, m, l, alpha, rows, kb * kTile);
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(prev));
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_p(pa, s);
  }
  wgmma_fence();
  issue_pv<DP>(o, pa, v_tile((nk - 1) % kStages));
  wgmma_wait<0>();

  // epilogue: stage the tile in shared memory (every warp's last wgmma
  // has read q and the ring), then 16-byte coalesced stores of rows < Sq
  consumers_sync();
  const size_t r_base = ((size_t)b * H + h) * Sq;
  const int nrow = min(kTile, Sq - q0);
  if (Partial) {
    constexpr int LD = DP + 4;  // fp32 row stride, 16-byte aligned
    float* st = reinterpret_cast<float*>(base + kTileBytes);
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int lr = warp * 16 + g + 8 * ((i >> 1) & 1);
      *reinterpret_cast<float2*>(st + lr * LD + 8 * (i >> 2) + 2 * c) =
          make_float2(o[i], o[i + 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (c == 0 && rows.row[r] < Sq) {
        o1[r_base + rows.row[r]] = m[r];
        o2[r_base + rows.row[r]] = l[r];
      }
    }
    consumers_sync();
    float* acc = static_cast<float*>(o0) + (r_base + q0) * D;
    const int n4 = D / 4;
    for (int idx = threadIdx.x; idx < nrow * n4; idx += 128) {
      const int r = idx / n4;
      const int c4 = (idx - r * n4) * 4;
      *reinterpret_cast<float4*>(acc + (size_t)r * D + c4) =
          *reinterpret_cast<const float4*>(st + r * LD + c4);
    }
  } else {
    float lf[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lf[r] = fmaxf(l[r], 1e-30f);
      if (c == 0 && rows.row[r] < Sq)
        o1[r_base + rows.row[r]] = m[r] + logf(lf[r]);
    }
    // out in bf16 over q's tile
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] /= lf[(i >> 1) & 1];
    stage_bf16<DP>(base, o, warp, g, c);
    consumers_sync();
    store_rows_bf16(base, static_cast<__nv_bfloat16*>(o0),
                    (size_t)b * Sq + q0, H, h, D, nrow, 128);
  }
}

// ---------------------------------------------------------------------------
// The bf16 backward pair on the tensor cores: flash_bwd_dq_tc_kernel<DP>
// and flash_bwd_dkv_tc_kernel<DP>, on the forward's ring, TMA maps and
// wgmma forms (the design note at the top of the file).

// What the dq kernel's elementwise pass needs about a thread's two rows
struct DqRows {
  int row[2];     // global query rows (16w + g and + 8)
  bool live[2];   // row < Sq and the row has a live key
  float lse[2];
  float delta[2];
  int c, q0, Sq, Sk, off, causal;
  float scale;
};

// ds of the k tile at k0 from the fragments s = q k^T and dp = dO v^T:
// p = exp(s scale - lse) under the forward's mask (evaluated only on
// tiles that cross the causal diagonal or a ragged end; a row with no
// live key has logit 0), ds = p (dp - delta) scale, and 0 for keys past
// Sk and for rows past Sq or with no live key; ds is left in s
__device__ __forceinline__ void dq_ds(float (&s)[32], const float (&dp)[32],
                                      const DqRows& r, int k0) {
  const bool edge = k0 + kTile > r.Sk || r.q0 + kTile > r.Sq ||
                    (r.causal && k0 + kTile - 1 > r.q0 + r.off);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float x = s[i] * r.scale;
    bool live = true;
    if (edge) {
      const int col = k0 + 8 * (i >> 2) + 2 * r.c + (i & 1);
      const int diag = r.row[h] + r.off;
      if (r.causal) x = diag < 0 ? 0.f : (diag >= col ? x : kNegInf);
      live = r.live[h] && col < r.Sk;
    }
    const float p = exp2f((x - r.lse[h]) * kLog2e);
    s[i] = live ? p * (dp[i] - r.delta[h]) * r.scale : 0.f;
  }
}

// One warpgroup (64 q rows) and no producer warp (see the note at the
// top): thread 0 issues every load, refilling a stage once a block
// barrier shows that every warp's products have read it.  dq += ds k
// reads k MN-major (d contiguous) through issue_pv, as p v reads v.
template <int DP>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, int H, int Sq,
                           int Sk, int D, int causal, float scale) {
  constexpr int NB = DP / 64;
  constexpr int kTileBytes = NB * kBox;
  extern __shared__ uint8_t tc_smem[];
  uint8_t* base = tc_smem + ((1024 - (smem_u32(tc_smem) & 1023)) & 1023);
  // q and dO resident, then kStages (k, v) pairs, then the barriers
  const uint32_t sq = smem_u32(base);
  const uint32_t sdo = sq + kTileBytes;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(base + (2 + 2 * kStages) * kTileBytes);
  auto k_tile = [&](int st) { return sq + (2 + 2 * st) * kTileBytes; };
  auto v_tile = [&](int st) { return sq + (3 + 2 * st) * kTileBytes; };
  auto full = [&](int st) { return smem_u32(bars + st); };
  const uint32_t q_ready = smem_u32(bars + kStages);

  // the q tiles in reverse, outermost: causal blocks with the most k
  // tiles start first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int off = Sk - Sq;
  // rows with no live key get ds = 0, so only live keys need a k tile
  const int q_last = min(q0 + kTile, Sq) - 1;
  int nk = (Sk + kTile - 1) / kTile;
  if (causal) nk = q_last + off < 0 ? 0 : min(nk, (q_last + off) / kTile + 1);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  init_loads(bars);
  auto load_kv = [&](int kb) {  // k tile kb into stage kb % kStages
    const int st = kb % kStages;
    mbar_expect_tx(full(st), 2 * kTileBytes);
    for (int bx = 0; bx < NB; ++bx) {
      tma_load(k_tile(st) + bx * kBox, &mk, bx * 64, h, kb * kTile, b,
               full(st));
      tma_load(v_tile(st) + bx * kBox, &mv, bx * 64, h, kb * kTile, b,
               full(st));
    }
  };
  if (threadIdx.x == 0 && nk > 0) {
    mbar_expect_tx(q_ready, 2 * kTileBytes);
    for (int bx = 0; bx < NB; ++bx) {
      tma_load(sq + bx * kBox, &mq, bx * 64, h, q0, b, q_ready);
      tma_load(sdo + bx * kBox, &mdo, bx * 64, h, q0, b, q_ready);
    }
    for (int kb = 0; kb < min(nk, kStages); ++kb) load_kv(kb);
  }

  // 4 warps x 16 rows.  s and dp of tile kb are issued with dq += ds k
  // of tile kb - 1, and ds of tile kb is formed while the latter runs;
  // then tile kb + 2 goes into the stage tile kb - 1 leaves.
  const int g = lane >> 2;
  const int c = lane & 3;
  const size_t r_base = ((size_t)b * H + h) * Sq;
  DqRows rows;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    rows.row[r] = row;
    rows.live[r] = row < Sq && !(causal && row + off < 0);
    rows.lse[r] = row < Sq ? lse[r_base + row] : 0.f;
    rows.delta[r] = row < Sq ? delta[r_base + row] : 0.f;
  }
  rows.c = c;
  rows.q0 = q0;
  rows.Sq = Sq;
  rows.Sk = Sk;
  rows.off = off;
  rows.causal = causal;
  rows.scale = scale;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float s[32], dp[32];
  uint32_t da[4][4];

  if (nk > 0) {
    mbar_wait(q_ready, 0);
    mbar_wait(full(0), 0);
    issue_qk<DP>(s, sq, k_tile(0));
    issue_qk<DP>(dp, sdo, v_tile(0));
    wgmma_wait<0>();
    dq_ds(s, dp, rows, 0);
    pack_p(da, s);
    for (int kb = 1; kb < nk; ++kb) {
      const int st = kb % kStages;
      const int prev = (kb - 1) % kStages;
      mbar_wait(full(st), (kb / kStages) & 1);
      issue_qk<DP>(s, sq, k_tile(st));  // its fence also covers da
      issue_qk<DP>(dp, sdo, v_tile(st));
      issue_pv<DP>(acc, da, k_tile(prev));
      wgmma_wait<1>();  // s and dp are ready; ds k of tile kb - 1 may run
      dq_ds(s, dp, rows, kb * kTile);
      wgmma_wait<0>();
      __syncthreads();  // every warp's products have read stage prev
      if (threadIdx.x == 0 && kb + kStages - 1 < nk)
        load_kv(kb + kStages - 1);
      pack_p(da, s);
    }
    wgmma_fence();
    issue_pv<DP>(acc, da, k_tile((nk - 1) % kStages));
    wgmma_wait<0>();
  }

  // epilogue through q's tile (every warp's last wgmma has read it)
  __syncthreads();
  stage_bf16<DP>(base, acc, warp, g, c);
  __syncthreads();
  store_rows_bf16(base, dq, (size_t)b * Sq + q0, H, h, D,
                  min(kTile, Sq - q0), 128);
}

// What the dkv kernel's elementwise pass needs: the fragments' rows are
// keys, their columns the q tile's rows
struct DkvCols {
  int key[2];  // global keys of a thread's two rows (16w + g and + 8)
  int c, k0, Sq, off, causal;
  float scale;
};

// p^T and ds^T of the q tile at i0 from s^T = k q^T in st and dp^T = v
// dO^T in dpt, with the tile's lse and delta from its ring slot (sl, sd):
// the columns a thread holds are 8j + 2c and + 1.  q rows past Sq (TMA
// zero-fills them, and lse 0 would give p = 1) are masked on edge
// tiles; a q row with no live key has logit 0 and ds 0.  p^T is left in
// st, ds^T in dpt.
__device__ __forceinline__ void dkv_p_ds(float (&st)[32], float (&dpt)[32],
                                         const float* sl, const float* sd,
                                         const DkvCols& r, int i0) {
  const bool edge = i0 + kTile > r.Sq ||
                    (r.causal && r.k0 + kTile - 1 > i0 + r.off);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * r.c);
    const float2 d2 = *reinterpret_cast<const float2*>(sd + 8 * j + 2 * r.c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float l = (e & 1) ? l2.y : l2.x;
      const float d = (e & 1) ? d2.y : d2.x;
      float x = st[i] * r.scale;
      bool valid = true;
      bool live = true;
      if (edge) {
        const int row = i0 + 8 * j + 2 * r.c + (e & 1);
        const int diag = row + r.off;
        if (r.causal)
          x = diag < 0 ? 0.f : (diag >= r.key[e >> 1] ? x : kNegInf);
        valid = row < r.Sq;
        live = valid && !(r.causal && diag < 0);
      }
      const float p = valid ? exp2f((x - l) * kLog2e) : 0.f;
      dpt[i] = live ? p * (dpt[i] - d) * r.scale : 0.f;
      st[i] = p;
    }
  }
}

// dv += p^T dO and dk += ds^T q over one q tile, for the 64 columns of
// dv and dk whose boxes of dO and q start at d_o and q (MN-major, d
// contiguous); one committed group
__device__ __forceinline__ void issue_dkv(float (&dv)[32], float (&dk)[32],
                                          const uint32_t (&pa)[4][4],
                                          const uint32_t (&dsa)[4][4],
                                          uint32_t d_o, uint32_t q) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_rs(dv, pa[kk], smem_desc(d_o + kk * 2048, kBox, 1024));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_rs(dk, dsa[kk], smem_desc(q + kk * 2048, kBox, 1024));
  wgmma_commit();
}

// One warpgroup per 64 columns of dk and dv (DP / 64 of them) and no
// producer warp, as in the dq kernel.
template <int DP>
__global__ void __launch_bounds__(128 * (DP / 64))
    flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap mq,
                            const __grid_constant__ CUtensorMap mk,
                            const __grid_constant__ CUtensorMap mv,
                            const __grid_constant__ CUtensorMap mdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int H, int Sq,
                            int Sk, int D, int causal, float scale) {
  constexpr int NB = DP / 64;
  constexpr int NWG = NB;  // warpgroups
  constexpr int kTileBytes = NB * kBox;
  extern __shared__ uint8_t tc_smem[];
  uint8_t* base = tc_smem + ((1024 - (smem_u32(tc_smem) & 1023)) & 1023);
  // k and v resident, then kStages (q, dO) pairs, each stage's slot of
  // the q tile's lse (64 floats) and delta (64), then the barriers
  const uint32_t sk = smem_u32(base);
  const uint32_t sv = sk + kTileBytes;
  auto q_tile = [&](int st) { return sk + (2 + 2 * st) * kTileBytes; };
  auto do_tile = [&](int st) { return sk + (3 + 2 * st) * kTileBytes; };
  float* slots =
      reinterpret_cast<float*>(base + (2 + 2 * kStages) * kTileBytes);
  auto slot = [&](int st) { return slots + st * 2 * kTile; };
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + kStages * 2 * kTile);
  auto full = [&](int st) { return smem_u32(bars + st); };
  const uint32_t kv_ready = smem_u32(bars + kStages);

  // the k tiles in order, outermost: under a causal mask with Sq <= Sk
  // the early k tiles see the most q tiles and start first
  const int k0 = blockIdx.z * kTile;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int off = Sk - Sq;
  // causal block skip (the reference's rule at flash_attention.py:262):
  // q tiles whose last row sees no key of this tile contribute nothing.
  // With Sq > Sk the rows without a live key (the first Sq - Sk) add
  // dO / Sk to dv, so every q tile is read.  ib0 < the number of q tiles,
  // since k0 - off < Sq: a block always has a q tile.
  int ib0 = 0;
  if (causal && off >= 0 && k0 - off > 0) ib0 = (k0 - off) / kTile;
  const int nq = (Sq + kTile - 1) / kTile - ib0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  init_loads(bars);
  auto load_q = [&](int n) {  // the block's q tile n into stage n % kStages
    const int st = n % kStages;
    const int i0 = (ib0 + n) * kTile;
    mbar_expect_tx(full(st), 2 * kTileBytes);
    for (int bx = 0; bx < NB; ++bx) {
      tma_load(q_tile(st) + bx * kBox, &mq, bx * 64, h, i0, b, full(st));
      tma_load(do_tile(st) + bx * kBox, &mdo, bx * 64, h, i0, b, full(st));
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_ready, 2 * kTileBytes);
    for (int bx = 0; bx < NB; ++bx) {
      tma_load(sk + bx * kBox, &mk, bx * 64, h, k0, b, kv_ready);
      tma_load(sv + bx * kBox, &mv, bx * 64, h, k0, b, kv_ready);
    }
    for (int n = 0; n < min(nq, kStages); ++n) load_q(n);
  }
  // lse and delta go into a stage's slot by plain loads and stores (rows
  // of [B, H, Sq] start 16-byte aligned only when Sq % 4 == 0): thread t
  // < 128 carries slot entry t, lse of row t (t < 64) or delta of row t -
  // 64 of a q tile, loaded a tile ahead; the block barrier of the
  // iteration in between orders the store before every read
  const size_t r_base = ((size_t)b * H + h) * Sq;
  const bool slot_thread = threadIdx.x < 2 * kTile;
  const float* src = threadIdx.x < kTile ? lse : delta;
  auto fetch = [&](int n) {
    const int row = (ib0 + n) * kTile + (threadIdx.x & (kTile - 1));
    return slot_thread && n < nq && row < Sq ? src[r_base + row] : 0.f;
  };
  for (int n = 0; n < min(nq, kStages); ++n)
    if (slot_thread) slot(n)[threadIdx.x] = fetch(n);
  float next = fetch(kStages);
  __syncthreads();

  // warpgroup wg owns columns [64 wg, 64 wg + 64) of dk and dv; each of
  // its 4 warps 16 keys.  s^T and dp^T of q tile n are issued with the
  // gradient products of tile n - 1, and p^T, ds^T of tile n are formed
  // while those run; then tile n + 2 goes into the stage tile n - 1
  // leaves.
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int c = lane & 3;
  const DkvCols cols{{k0 + wq * 16 + g, k0 + wq * 16 + g + 8}, c, k0, Sq,
                     off, causal, scale};
  const uint32_t box = wg * kBox;  // this warpgroup's columns of q and dO
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  float s[32], dp[32];
  uint32_t pa[4][4], dsa[4][4];

  mbar_wait(kv_ready, 0);
  mbar_wait(full(0), 0);
  issue_qk<DP>(s, sk, q_tile(0));
  issue_qk<DP>(dp, sv, do_tile(0));
  wgmma_wait<0>();
  dkv_p_ds(s, dp, slot(0), slot(0) + kTile, cols, ib0 * kTile);
  pack_p(pa, s);
  pack_p(dsa, dp);
  for (int n = 1; n < nq; ++n) {
    const int st = n % kStages;
    const int prev = (n - 1) % kStages;
    mbar_wait(full(st), (n / kStages) & 1);
    issue_qk<DP>(s, sk, q_tile(st));  // its fence also covers pa and dsa
    issue_qk<DP>(dp, sv, do_tile(st));
    issue_dkv(dv_acc, dk_acc, pa, dsa, do_tile(prev) + box,
              q_tile(prev) + box);
    wgmma_wait<1>();  // s^T and dp^T are ready; tile n - 1's may run
    dkv_p_ds(s, dp, slot(st), slot(st) + kTile, cols, (ib0 + n) * kTile);
    wgmma_wait<0>();
    __syncthreads();  // every warp has read stage prev and its slot
    if (n + kStages - 1 < nq) {
      if (threadIdx.x == 0) load_q(n + kStages - 1);
      if (slot_thread) slot(prev)[threadIdx.x] = next;
      next = fetch(n + kStages);
    }
    pack_p(pa, s);
    pack_p(dsa, dp);
  }
  wgmma_fence();
  const int last = (nq - 1) % kStages;
  issue_dkv(dv_acc, dk_acc, pa, dsa, do_tile(last) + box, q_tile(last) + box);
  wgmma_wait<0>();

  // epilogue: dk through k's tile, dv through v's (every warpgroup's last
  // wgmma has read them), each warpgroup its own box
  __syncthreads();
  stage_bf16<64>(base + wg * kBox, dk_acc, wq, g, c);
  stage_bf16<64>(base + kTileBytes + wg * kBox, dv_acc, wq, g, c);
  __syncthreads();
  const int nrow = min(kTile, Sk - k0);
  const size_t row0 = (size_t)b * Sk + k0;
  store_rows_bf16(base, dk, row0, H, h, D, nrow, 128 * NWG);
  store_rows_bf16(base + kTileBytes, dv, row0, H, h, D, nrow, 128 * NWG);
}

constexpr size_t fwd_smem(int D) {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kLdS);
}
constexpr size_t dq_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kLdS);
}
constexpr size_t dkv_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kLdS + 2 * kTile);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* o0;  // out | acc | dq | dk
  void* o1;  // lse | m   | -  | dv
  void* o2;  // -   | l   | -  | -
  int B, H, Sq, Sk, causal;
  float scale;
  cudaStream_t stream;
};

enum Which { kFwd = 0, kFwdPartial = 1, kDq = 2, kDkv = 3 };

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no link against libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The [B, S, H, D] bf16 tensor at `ptr` as a 4-D tensor map, dims (D, H,
// S, B) innermost first, boxes of 64 x 1 x 64 x 1 with the 128-byte
// swizzle; TMA fills zeros past D and past S.
cudaError_t bshd_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                     int D) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr size_t tc_smem_bytes(int DP) {
  // q and kStages (k, v) tiles, the barriers, and slack to align to 1024
  return (size_t)(DP / 64) * kBox * (1 + 2 * kStages) +
         sizeof(uint64_t) * (2 * kStages + 1) + 1024;
}

template <int DP, bool Partial>
cudaError_t launch_fwd_tc(const Args& a, int D) {
  static const cudaError_t ready = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<DP, Partial>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tc_smem_bytes(DP));
  if (ready != cudaSuccess) return ready;
  CUtensorMap mq, mk, mv;
  cudaError_t err = bshd_map(&mq, a.q, a.B, a.Sq, a.H, D);
  if (err == cudaSuccess) err = bshd_map(&mk, a.k, a.B, a.Sk, a.H, D);
  if (err == cudaSuccess) err = bshd_map(&mv, a.v, a.B, a.Sk, a.H, D);
  if (err != cudaSuccess) return err;
  const int nq = (a.Sq + kTile - 1) / kTile;
  if (nq > 65535) return cudaErrorInvalidValue;  // grid z
  const dim3 grid(a.H, a.B, nq);
  flash_fwd_tc_kernel<DP, Partial>
      <<<grid, kTcThreads, tc_smem_bytes(DP), a.stream>>>(
          mq, mk, mv, a.o0, static_cast<float*>(a.o1),
          static_cast<float*>(a.o2), a.H, a.Sq, a.Sk, D, a.causal, a.scale);
  return cudaGetLastError();
}

// the bf16 forwards: every head dim the kernels take, padded to 64 or 128
cudaError_t dispatch_fwd_tc(bool partial, int D, const Args& a) {
  switch (D) {
    case 16:
    case 32:
    case 48:
    case 64:
      return partial ? launch_fwd_tc<64, true>(a, D)
                     : launch_fwd_tc<64, false>(a, D);
    case 80:
    case 96:
    case 112:
    case 128:
      return partial ? launch_fwd_tc<128, true>(a, D)
                     : launch_fwd_tc<128, false>(a, D);
  }
  return cudaErrorInvalidValue;
}

constexpr size_t bwd_tc_smem_bytes(int DP, bool dkv) {
  // two resident tiles and kStages pairs in the ring, dkv's lse and delta
  // slots, the barriers, and slack to align to 1024
  return (size_t)(DP / 64) * kBox * (2 + 2 * kStages) +
         (dkv ? sizeof(float) * 2 * kTile * kStages : 0) +
         sizeof(uint64_t) * (kStages + 1) + 1024;
}

template <int DP>
cudaError_t launch_bwd_tc(Which which, const Args& a, int D) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = bshd_map(&mq, a.q, a.B, a.Sq, a.H, D);
  if (err == cudaSuccess) err = bshd_map(&mk, a.k, a.B, a.Sk, a.H, D);
  if (err == cudaSuccess) err = bshd_map(&mv, a.v, a.B, a.Sk, a.H, D);
  if (err == cudaSuccess) err = bshd_map(&mdo, a.dout, a.B, a.Sq, a.H, D);
  if (err != cudaSuccess) return err;
  if (which == kDq) {
    static const cudaError_t ready = cudaFuncSetAttribute(
        flash_bwd_dq_tc_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bwd_tc_smem_bytes(DP, false));
    if (ready != cudaSuccess) return ready;
    const int nq = (a.Sq + kTile - 1) / kTile;
    if (nq > 65535) return cudaErrorInvalidValue;  // grid z
    flash_bwd_dq_tc_kernel<DP><<<dim3(a.H, a.B, nq), 128,
                                 bwd_tc_smem_bytes(DP, false), a.stream>>>(
        mq, mk, mv, mdo, a.lse_in, a.delta,
        static_cast<__nv_bfloat16*>(a.o0), a.H, a.Sq, a.Sk, D, a.causal,
        a.scale);
  } else {
    static const cudaError_t ready = cudaFuncSetAttribute(
        flash_bwd_dkv_tc_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bwd_tc_smem_bytes(DP, true));
    if (ready != cudaSuccess) return ready;
    const int nk = (a.Sk + kTile - 1) / kTile;
    if (nk > 65535) return cudaErrorInvalidValue;  // grid z
    flash_bwd_dkv_tc_kernel<DP><<<dim3(a.H, a.B, nk), 128 * (DP / 64),
                                  bwd_tc_smem_bytes(DP, true), a.stream>>>(
        mq, mk, mv, mdo, a.lse_in, a.delta,
        static_cast<__nv_bfloat16*>(a.o0), static_cast<__nv_bfloat16*>(a.o1),
        a.H, a.Sq, a.Sk, D, a.causal, a.scale);
  }
  return cudaGetLastError();
}

// the bf16 backward pair: every head dim the kernels take, padded to 64
// or 128
cudaError_t dispatch_bwd_tc(Which which, int D, const Args& a) {
  switch (D) {
    case 16:
    case 32:
    case 48:
    case 64:
      return launch_bwd_tc<64>(which, a, D);
    case 80:
    case 96:
    case 112:
    case 128:
      return launch_bwd_tc<128>(which, a, D);
  }
  return cudaErrorInvalidValue;
}

// Above 48 KB a kernel takes dynamic shared memory only after
// cudaFuncSetAttribute; each kernel instance makes the call once (the
// function-local statics below are per instance).  The scalar kernels
// are launched for fp32 only: run sends bf16 to dispatch_fwd_tc and
// dispatch_bwd_tc.
template <int D, bool Partial>
cudaError_t launch_fwd_fp32(const Args& a) {
  static const cudaError_t ready = cudaFuncSetAttribute(
      flash_fwd_kernel<float, D, Partial>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fwd_smem(D));
  if (ready != cudaSuccess) return ready;
  const unsigned nq = (unsigned)((a.Sq + kTile - 1) / kTile);
  flash_fwd_kernel<float, D, Partial><<<dim3(nq, a.H, a.B), dim3(kThreads),
                                        fwd_smem(D), a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.o0, static_cast<float*>(a.o1),
      static_cast<float*>(a.o2), a.H, a.Sq, a.Sk, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(Which which, const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const dim3 block(kThreads);
  if (which == kDq) {
    static const cudaError_t ready = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem(D));
    if (ready != cudaSuccess) return ready;
    const unsigned nq = (unsigned)((a.Sq + kTile - 1) / kTile);
    flash_bwd_dq_kernel<T, D><<<dim3(nq, a.H, a.B), block, dq_smem(D),
                                a.stream>>>(
        q, k, v, dout, a.lse_in, a.delta, static_cast<T*>(a.o0), a.H, a.Sq,
        a.Sk, a.causal, a.scale);
  } else {
    static const cudaError_t ready = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem(D));
    if (ready != cudaSuccess) return ready;
    const unsigned nk = (unsigned)((a.Sk + kTile - 1) / kTile);
    flash_bwd_dkv_kernel<T, D><<<dim3(nk, a.H, a.B), block, dkv_smem(D),
                                 a.stream>>>(
        q, k, v, dout, a.lse_in, a.delta, static_cast<T*>(a.o0),
        static_cast<T*>(a.o1), a.H, a.Sq, a.Sk, a.causal, a.scale);
  }
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, D>) for the head dims the scalar
// kernels take.
template <typename F>
cudaError_t dispatch_d(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
  }
  return cudaErrorInvalidValue;
}

int run(Which which, int D, int is_bf16, const Args& a) {
  if (a.B < 0 || a.H < 1 || a.Sq < 1 || a.Sk < 1 || a.B > 65535 ||
      a.H > 65535 || D < 16 || D > 128 || D % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.B == 0) return (int)cudaGetLastError();
  if (which == kFwd || which == kFwdPartial) {
    if (is_bf16) return (int)dispatch_fwd_tc(which == kFwdPartial, D, a);
    return (int)dispatch_d(D, [&](auto d) {
      return which == kFwd ? launch_fwd_fp32<decltype(d)::value, false>(a)
                           : launch_fwd_fp32<decltype(d)::value, true>(a);
    });
  }
  if (is_bf16) return (int)dispatch_bwd_tc(which, D, a);
  return (int)dispatch_d(D, [&](auto d) {
    return launch_bwd<float, decltype(d)::value>(which, a);
  });
}

}  // namespace

// q [B,Sq,H,D], k/v [B,Sk,H,D], all fp32 or all bf16, contiguous, on the
// current device; out like q; lse [B,H,Sq] fp32.  Launches on `stream`
// without synchronising and returns the launch's cudaError_t.
extern "C" int ffflash_fwd(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int H, int Sq,
                           int Sk, int D, int is_bf16, int causal,
                           float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, lse, nullptr, B, H, Sq,
         Sk, causal, scale, static_cast<cudaStream_t>(stream)};
  return run(kFwd, D, is_bf16, a);
}

// q [B,Sq,H,D], k/v [B,Sk,H,D] as ffflash_fwd; acc [B,H,Sq,D], m and l
// [B,H,Sq], all fp32 and unnormalized.
extern "C" int ffflash_fwd_partial(const void* q, const void* k,
                                   const void* v, void* acc, void* m,
                                   void* l, int B, int H, int Sq, int Sk,
                                   int D, int is_bf16, int causal,
                                   float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, acc, m, l, B, H, Sq, Sk,
         causal, scale, static_cast<cudaStream_t>(stream)};
  return run(kFwdPartial, D, is_bf16, a);
}

// dout like q; lse, delta [B,H,Sq] fp32; dq like q.
extern "C" int ffflash_bwd_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq, int B, int H,
                              int Sq, int Sk, int D, int is_bf16, int causal,
                              float scale, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr, nullptr, B, H, Sq,
         Sk, causal, scale, static_cast<cudaStream_t>(stream)};
  return run(kDq, D, is_bf16, a);
}

// as ffflash_bwd_dq; dk, dv like k and v.
extern "C" int ffflash_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv, int B,
                               int H, int Sq, int Sk, int D, int is_bf16,
                               int causal, float scale, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dk, dv, nullptr, B, H, Sq, Sk,
         causal, scale, static_cast<cudaStream_t>(stream)};
  return run(kDkv, D, is_bf16, a);
}
