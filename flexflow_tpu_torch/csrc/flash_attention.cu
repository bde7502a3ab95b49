// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of
// flexflow_tpu/kernels/flash_attention.py:
//
//   flash_fwd_kernel<.., false> <- `_flash_kernel` with save_lse=True
//                                  (launched by `_flash_forward`)
//   flash_fwd_kernel<.., true>  <- `_flash_kernel` with partial_out=True
//                                  (launched by `_flash_forward_partial`,
//                                  ring attention's block step)
//   flash_bwd_dq_kernel         <- `_flash_bwd_dq_kernel` (`_flash_backward`)
//   flash_bwd_dkv_kernel        <- `_flash_bwd_dkv_kernel` (`_flash_backward`)
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
// or bf16) read in place through strides: no transpose to [B*H, S, D]
// around the call.  lse and delta are [B, H, Sq] fp32.  All math is fp32
// with the reference's roundings for bf16: products of two bf16 values
// are exact in fp32, p is rounded to bf16 before p.v and before p^T dO,
// ds before ds.k and ds^T.q.  Any Sq, Sk >= 1; the ragged edge is masked.
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
// What bounds it on the card.  At the training path's shape (B 8, S 1024,
// H 12, D 64, causal) one layer's forward moves about 50 MB (q, k, v, out
// read or written once, bf16) and does about 12.9 GFLOP over 50.4 M live
// (q, k) pairs: 15 us of bytes against 13 us of dense bf16 tensor-core
// time at the published peaks, so the two sit close.  The backward does
// 3x (dq) and 4x (dkv) the forward's products per pair.
//
// The partial forward at the zigzag ring's half-chunk shape (B 2, Sq = Sk
// = 512, H 12, D 64, bf16, no mask) reads q, k, v once (4.7 MB) and
// writes acc, m and l (3.2 MB): 2.4 us of bytes at 3.35 TB/s against
// 1.6 GFLOP, 1.6 us of dense bf16 tensor-core time.  It is bytes-bound,
// and its fp32 acc is two thirds of the bytes: the price of a merge
// across ranks in fp32, as the reference's.
//
// What the design does about it: a tile of q rows is read once and kept
// in shared memory while the block walks the k tiles (forward, dq), or a
// tile of k and v is kept while the block walks the q tiles (dkv), so
// no [Sq, Sk] matrix reaches device memory and each operand crosses it
// once per tile pass.  One block per (b, h, 64-row tile), 256 threads,
// each owning a 4x4 patch of the 64x64 score tile and 4 rows of the
// output tile; rows of a score tile reduce with warp shuffles inside
// 16-lane groups.  The causal block skip of the TPU kernels is kept.
// The products are scalar fp32 FMAs from shared memory (row stride D+1,
// free of bank conflicts): right first.  mma.sync/wgmma tensor-core
// products, TMA loads and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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

// Above 48 KB a kernel takes dynamic shared memory only after
// cudaFuncSetAttribute; each kernel instance makes the call once (the
// function-local statics below are per instance).
template <typename T, int D, bool Partial>
cudaError_t launch_fwd(const Args& a, const T* q, const T* k, const T* v) {
  static const cudaError_t ready = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, Partial>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fwd_smem(D));
  if (ready != cudaSuccess) return ready;
  const unsigned nq = (unsigned)((a.Sq + kTile - 1) / kTile);
  flash_fwd_kernel<T, D, Partial><<<dim3(nq, a.H, a.B), dim3(kThreads),
                                    fwd_smem(D), a.stream>>>(
      q, k, v, a.o0, static_cast<float*>(a.o1), static_cast<float*>(a.o2),
      a.H, a.Sq, a.Sk, a.causal, a.scale);
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch(Which which, const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const dim3 block(kThreads);
  const unsigned nq = (unsigned)((a.Sq + kTile - 1) / kTile);
  const unsigned nk = (unsigned)((a.Sk + kTile - 1) / kTile);
  if (which == kFwd || which == kFwdPartial) {
    const cudaError_t err = which == kFwd
                                ? launch_fwd<T, D, false>(a, q, k, v)
                                : launch_fwd<T, D, true>(a, q, k, v);
    if (err != cudaSuccess) return err;
  } else if (which == kDq) {
    static const cudaError_t ready = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem(D));
    if (ready != cudaSuccess) return ready;
    flash_bwd_dq_kernel<T, D><<<dim3(nq, a.H, a.B), block, dq_smem(D),
                                a.stream>>>(
        q, k, v, dout, a.lse_in, a.delta, static_cast<T*>(a.o0), a.H, a.Sq,
        a.Sk, a.causal, a.scale);
  } else {
    static const cudaError_t ready = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem(D));
    if (ready != cudaSuccess) return ready;
    flash_bwd_dkv_kernel<T, D><<<dim3(nk, a.H, a.B), block, dkv_smem(D),
                                 a.stream>>>(
        q, k, v, dout, a.lse_in, a.delta, static_cast<T*>(a.o0),
        static_cast<T*>(a.o1), a.H, a.Sq, a.Sk, a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Which which, int D, const Args& a) {
  switch (D) {
    case 16: return launch<T, 16>(which, a);
    case 32: return launch<T, 32>(which, a);
    case 48: return launch<T, 48>(which, a);
    case 64: return launch<T, 64>(which, a);
    case 80: return launch<T, 80>(which, a);
    case 96: return launch<T, 96>(which, a);
    case 112: return launch<T, 112>(which, a);
    case 128: return launch<T, 128>(which, a);
  }
  return cudaErrorInvalidValue;
}

int run(Which which, int D, int is_bf16, const Args& a) {
  if (a.B < 0 || a.H < 1 || a.Sq < 1 || a.Sk < 1 || a.B > 65535 ||
      a.H > 65535 || D < 16 || D > 128 || D % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.B == 0) return (int)cudaGetLastError();
  return (int)(is_bf16 ? dispatch_d<__nv_bfloat16>(which, D, a)
                       : dispatch_d<float>(which, D, a));
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
