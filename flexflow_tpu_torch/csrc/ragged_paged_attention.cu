// Ragged paged decode attention for Hopper (sm_90a).
//
// rpa_split_kernel<T, D> replaces the Pallas TPU kernel `_rpa_kernel` in
// flexflow_tpu/kernels/ragged_paged_attention.py (launched by
// `_pallas_ragged_paged`), for fp32 and bf16 pools;
// rpa_quant_split_kernel<D> replaces `_rpa_kernel_quant` (launched by
// `_pallas_ragged_paged_quant`), for INT8 pools.  They compute the same
// function, not the same blocking: for every sequence b and head h,
//
//   out[b,h] = sum_t softmax_t(q[b,h] . k_t * scale) v_t
//
// over the first seq_lens[b] tokens of the sequence's pages, where token
// t lives in pool page page_table[b, t / page_size], slot t % page_size.
// Math is fp32 for every pool; l is floored at 1e-30, so seq_lens[b] == 0
// gives zeros (the TPU kernel's semantics).  A page id outside
// [0, num_pages) is never dereferenced: the row it would feed comes out
// NaN.  An INT8 pool carries one fp32 scale per (page, slot), shared
// across heads, for k and for v: the scale factors out of the dot,
// s_t = k_scale[t] * (q . k_int8[t]) * scale, and out of p_t v_t, which
// is one rounding away from the plain version that dequantises first;
// the int8 values become fp32 in registers only.
//
// What bounds it on the card: device-memory bytes.  Each live token is
// read once per head, k and v, so the work moves
//   sum_b len_b * H * D * 2 * bytes_per_elem   (+ 8 scale bytes a token)
// plus q and out, against about 4 * sum_b len_b * H * D fp32 operations:
// one operation per byte or less, so tensor cores do not apply (an M = 1
// product).  The time is then set by how many bytes are in flight across
// the card and by the chain of dependent steps each token costs.
//
// What the design does about it (flash-decoding):
// * Split-KV.  A sequence's tokens are cut into splits of kSplitTokens
//   (128 tokens: 8 pages at the serving path's page size of 16).  One
//   block of 128 threads computes one (b, h, split): the grid is
//   B * H * ceil(page_size * pages_per_seq / kSplitTokens) blocks, from
//   host-known shapes only, and a block whose split starts past
//   seq_lens[b] exits at once.  A split's boundaries depend on nothing
//   but its sequence's length, so a sequence gives the same bits alone
//   and inside any batch.  (On an H100 at the serving shape 128 and 256
//   tokens measured alike and 64 a few percent slower: rpa_probe.py.)
// * The merge.  A sequence of one split writes its output directly.
//   Otherwise each split writes its partial (m, l, acc[D]) in fp32 to a
//   workspace, and the last block of the (b, h) to finish (a per-(b, h)
//   counter, which that block resets to 0) merges the partials in split
//   order: no second launch, and two calls are bit-equal.
// * Loads ahead of use, 16 bytes a thread.  The split's page ids are
//   read beside seq_lens, and its token -> pool row map goes to shared
//   memory once.  A row of D elements is shared by a group of D / 16
//   lanes, 16 elements each; the block's groups take a tile of rows at
//   once.  Each thread copies its own 16-byte chunks of K and V (and an
//   INT8 row's two scales) by cp.async into its own slots of a ring of
//   up to kTiles + 1 stages in shared memory, so a split's tiles are all
//   in flight while the first is computed, and no thread waits for
//   another's copies: the tile loop has no block barrier.
// * A short chain per token.  A score is the group's dot slices summed
//   in log2(D / 16) shuffles, with q in registers; each group keeps its
//   own running max, rescaled once per tile; p . v accumulates the
//   thread's 16 elements of V.  The groups' (m, l, acc) merge once per
//   split, in shared memory, in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kElems = 16;          // elements of a row each thread owns
constexpr int kSplitTokens = 128;   // tokens per split
constexpr int kRingBudget = 32 * 1024;
constexpr float kNegInf = -1e30f;   // the reference's mask value

// The layout of one (pool type, head dim) instantiation.  A row of D
// elements is kChunks 16-byte chunks; a group of kGP lanes shares it,
// the first kG of them (the rest idle) lane g owning chunks g, g + kG,
// ... (kLaneChunks of them, kElems elements).  The kSlots groups of a
// block take kSlots rows at once: a tile.  Every thread stages its own
// chunks (and, for INT8, its row's scales) in its own slots of each ring
// stage, laid out [k, v][chunk][thread] x 16 bytes, so that a warp's
// loads and reads cover 512 contiguous bytes and no thread waits for
// another's copies.
template <typename T, int D>
struct Plan {
  static constexpr bool kQuant = sizeof(T) == 1;
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kChunks = D / kVec;
  static constexpr int kLaneChunks = kElems / kVec;
  static constexpr int kG = kChunks / kLaneChunks;
  static constexpr int kGP = kG <= 2 ? 2 : kG <= 4 ? 4 : kG <= 8 ? 8 : 16;
  static constexpr int kSlots = kThreads / kGP;
  static constexpr int kChunkBytes = 2 * kLaneChunks * kThreads * 16;
  static constexpr int kStageBytes =
      kChunkBytes + (kQuant ? 2 * kThreads * 4 : 0);
  // ring stages: a split's tiles all in flight at once where they fit
  // in kRingBudget bytes, else as many as fit (at least 2)
  static constexpr int kTiles = (kSplitTokens + kSlots - 1) / kSlots;
  static constexpr int kFit = kRingBudget / kStageBytes;
  static constexpr int kStages =
      kTiles + 1 <= kFit ? kTiles + 1 : (kFit < 2 ? 2 : kFit);
  static constexpr int kRingBytes = kStages * kStageBytes;
  // after the ring: the split's pool rows, q
  static constexpr int kSmemBytes = kRingBytes + kSplitTokens * 4 + D * 4;
  static_assert(D % kElems == 0 && kG <= 16, "head dims 32..256");
  static_assert(kSlots * (D + 3) * 4 <= kRingBytes,
                "the split's reduction reuses the ring");
  static_assert(kSmemBytes <= 48 * 1024, "no opt-in shared memory");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 16-byte chunk of a staged row -> fp32.
__device__ __forceinline__ void load_chunk(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float* out) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i is the low half
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// int8 -> fp32 without I2F: with the sign bit flipped a byte is b + 128;
// placed under the exponent of 2^23 it reads as 2^23 + b + 128.
__device__ __forceinline__ void load_chunk(const signed char* p,
                                           float* out) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned u = words[i] ^ 0x80808080u;
    out[4 * i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) -
                 8388736.f;
    out[4 * i + 1] =
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
    out[4 * i + 2] =
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
    out[4 * i + 3] =
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  }
}

// One (b, h, split) block; blockIdx.x = (b * H + h) * num_splits + split.
template <typename T, int D>
__device__ __forceinline__ void split_attention(
    const float* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ page_table,
    const int* __restrict__ seq_lens, float* __restrict__ out,
    float* __restrict__ workspace, int* __restrict__ counters, int H,
    int num_pages, int page_size, int pages_per_seq, int num_splits,
    float scale) {
  using P = Plan<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  unsigned char* ring = smem;
  int* tok_sm = reinterpret_cast<int*>(smem + P::kRingBytes);
  float* q_sm = reinterpret_cast<float*>(tok_sm + kSplitTokens);

  const int split = (int)(blockIdx.x % (unsigned)num_splits);
  const int bh = (int)(blockIdx.x / (unsigned)num_splits);
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;

  // the split's page ids are read beside seq_lens, not after it (every
  // split starts below the cap, and a page id is checked before use)
  const int cap = page_size * pages_per_seq;
  const int t_begin = split * kSplitTokens;
  constexpr int kPerThread = (kSplitTokens + kThreads - 1) / kThreads;
  int pages[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int t = t_begin + tid + j * kThreads;
    pages[j] = tid + j * kThreads < kSplitTokens && t < cap
                   ? page_table[(size_t)b * pages_per_seq + t / page_size]
                   : -1;
  }
  int n = seq_lens[b];
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const int live_splits = n == 0 ? 1 : (n + kSplitTokens - 1) / kSplitTokens;
  if (split >= live_splits) return;
  const int n_split = min(kSplitTokens, n - t_begin);
  const int n_tiles = (n_split + P::kSlots - 1) / P::kSlots;

  // the split's pool rows once; q into shared memory
  int bad = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int u = tid + j * kThreads;
    if (u < n_split) {
      int tok = -1;
      if ((unsigned)pages[j] < (unsigned)num_pages) {
        tok = pages[j] * page_size + (t_begin + u) % page_size;
      } else {
        bad = 1;
      }
      tok_sm[u] = tok;
    }
  }
  for (int d = tid; d < D; d += kThreads) q_sm[d] = q[(size_t)bh * D + d];
  bad = __syncthreads_or(bad);

  const int lane = tid % P::kGP;    // in the row's group
  const int slot = tid / P::kGP;    // the group: rows slot, slot + kSlots..
  const bool active = lane < P::kG;
  const size_t slot_stride = (size_t)H * D;  // pool layout [P, ps, H, D]
  const size_t head_off = (size_t)h * D;
  auto chunk_at = [&](unsigned char* stage, int kv, int k) {
    return stage + ((kv * P::kLaneChunks + k) * kThreads + tid) * 16;
  };
  auto scale_at = [&](unsigned char* stage, int kv) {
    return reinterpret_cast<float*>(stage + P::kChunkBytes) +
           kv * kThreads + tid;
  };
  // this thread's chunks of its row of tile i into stage i % kStages; one
  // commit group a tile (empty past the last), so that group i is
  // always tile i
  auto issue = [&](int i) {
    const int u = i * P::kSlots + slot;
    const int tok = i < n_tiles && u < n_split ? tok_sm[u] : -1;
    if (tok >= 0) {
      unsigned char* stage = ring + (i % P::kStages) * P::kStageBytes;
      if (active) {
        const size_t row = (size_t)tok * slot_stride + head_off;
#pragma unroll
        for (int k = 0; k < P::kLaneChunks; ++k) {
          const size_t at = row + (size_t)(lane + k * P::kG) * P::kVec;
          cp_async16(chunk_at(stage, 0, k), k_pages + at);
          cp_async16(chunk_at(stage, 1, k), v_pages + at);
        }
      }
      if constexpr (P::kQuant) {
        cp_async4(scale_at(stage, 0), k_scale + tok);
        cp_async4(scale_at(stage, 1), v_scale + tok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < P::kStages - 1; ++i) issue(i);

  float qv[P::kLaneChunks][P::kVec];
  float acc[P::kLaneChunks][P::kVec];
#pragma unroll
  for (int k = 0; k < P::kLaneChunks; ++k) {
#pragma unroll
    for (int e = 0; e < P::kVec; ++e) {
      qv[k][e] = active ? q_sm[(lane + k * P::kG) * P::kVec + e] : 0.f;
      acc[k][e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<P::kStages - 2>();  // this thread's copies of tile i
    issue(i + P::kStages - 1);        // into the stage tile i - 1 used
    unsigned char* stage = ring + (i % P::kStages) * P::kStageBytes;
    const bool live = i * P::kSlots + slot < n_split;  // the group's row

    // the score: a slice of the dot each, summed over the group
    float dot = 0.f;
    if (live && active) {
#pragma unroll
      for (int k = 0; k < P::kLaneChunks; ++k) {
        float kv[P::kVec];
        load_chunk(reinterpret_cast<const T*>(chunk_at(stage, 0, k)), kv);
#pragma unroll
        for (int e = 0; e < P::kVec; ++e) dot = fmaf(qv[k][e], kv[e], dot);
      }
    }
#pragma unroll
    for (int o = P::kGP / 2; o > 0; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (!live) continue;
    float s_row = dot * scale;
    if constexpr (P::kQuant) s_row *= *scale_at(stage, 0);

    // one max and one rescale per tile
    const float m_new = fmaxf(m, s_row);
    const float alpha = expf(m - m_new);
    const float p = expf(s_row - m_new);
    m = m_new;
    l = fmaf(l, alpha, p);
    float pv = p;
    if constexpr (P::kQuant) pv *= *scale_at(stage, 1);
    if (active) {
#pragma unroll
      for (int k = 0; k < P::kLaneChunks; ++k) {
        float vv[P::kVec];
        load_chunk(reinterpret_cast<const T*>(chunk_at(stage, 1, k)), vv);
#pragma unroll
        for (int e = 0; e < P::kVec; ++e)
          acc[k][e] = fmaf(pv, vv[e], acc[k][e] * alpha);
      }
    }
  }

  // merge the groups in a fixed order, in the ring (every copy has
  // landed: only empty groups are outstanding)
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [kSlots][D]
  float* red_m = red + P::kSlots * D;            // [kSlots]
  float* red_l = red_m + P::kSlots;              // [kSlots]
  float* red_w = red_l + P::kSlots;              // [kSlots]
  if (active) {
#pragma unroll
    for (int k = 0; k < P::kLaneChunks; ++k) {
#pragma unroll
      for (int e = 0; e < P::kVec; ++e)
        red[slot * D + (lane + k * P::kG) * P::kVec + e] = acc[k][e];
    }
  }
  if (lane == 0) {
    red_m[slot] = m;
    red_l[slot] = l;
  }
  __syncthreads();
  float m_all = kNegInf;
#pragma unroll
  for (int g = 0; g < P::kSlots; ++g) m_all = fmaxf(m_all, red_m[g]);
  if (tid < P::kSlots) red_w[tid] = expf(red_m[tid] - m_all);
  __syncthreads();
  float l_all = 0.f;
#pragma unroll
  for (int g = 0; g < P::kSlots; ++g) l_all = fmaf(red_l[g], red_w[g], l_all);
  auto column = [&](int d) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < P::kSlots; ++g) a = fmaf(red[g * D + d], red_w[g], a);
    return a;
  };

  if (live_splits == 1) {
    const float inv_l = 1.f / fmaxf(l_all, 1e-30f);
    for (int d = tid; d < D; d += kThreads)
      out[(size_t)bh * D + d] = bad ? nanf("") : column(d) * inv_l;
    return;
  }

  // the partial: acc [BH * num_splits][D], then (m, l) [BH * num_splits][2]
  // (l is NaN where the split met a bad page id)
  const size_t parts = (size_t)(gridDim.x);
  float* ws_acc = workspace;
  float* ws_ml = workspace + parts * D;
  const size_t part = (size_t)bh * num_splits + split;
  for (int d = tid; d < D; d += kThreads) ws_acc[part * D + d] = column(d);
  if (tid == 0) {
    ws_ml[2 * part] = m_all;
    ws_ml[2 * part + 1] = bad ? nanf("") : l_all;
  }
  __syncthreads();  // the block's partial is written; one thread
  if (tid == 0) {   // publishes it and counts the arrival
    __threadfence();
    is_last = atomicAdd(counters + bh, 1) == live_splits - 1;
    if (is_last) {
      counters[bh] = 0;  // ready for the next call
      __threadfence();
    }
  }
  __syncthreads();
  if (!is_last) return;

  const size_t first = (size_t)bh * num_splits;
  float m_parts = kNegInf;
  for (int s = 0; s < live_splits; ++s)
    m_parts = fmaxf(m_parts, __ldcg(ws_ml + 2 * (first + s)));
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
    float l_parts = 0.f;
    bool any_bad = false;
    for (int s = 0; s < live_splits; ++s) {
      const float l_s = __ldcg(ws_ml + 2 * (first + s) + 1);
      const float w = expf(__ldcg(ws_ml + 2 * (first + s)) - m_parts);
      any_bad |= isnan(l_s);
      l_parts = fmaf(l_s, w, l_parts);
      a = fmaf(__ldcg(ws_acc + (first + s) * D + d), w, a);
    }
    out[(size_t)bh * D + d] =
        any_bad ? nanf("") : a / fmaxf(l_parts, 1e-30f);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
rpa_split_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
                 const T* __restrict__ v_pages,
                 const int* __restrict__ page_table,
                 const int* __restrict__ seq_lens, float* __restrict__ out,
                 float* __restrict__ workspace, int* __restrict__ counters,
                 int H, int num_pages, int page_size, int pages_per_seq,
                 int num_splits, float scale) {
  split_attention<T, D>(q, k_pages, v_pages, nullptr, nullptr, page_table,
                        seq_lens, out, workspace, counters, H, num_pages,
                        page_size, pages_per_seq, num_splits, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
rpa_quant_split_kernel(const float* __restrict__ q,
                       const signed char* __restrict__ k_pages,
                       const signed char* __restrict__ v_pages,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ page_table,
                       const int* __restrict__ seq_lens,
                       float* __restrict__ out, float* __restrict__ workspace,
                       int* __restrict__ counters, int H, int num_pages,
                       int page_size, int pages_per_seq, int num_splits,
                       float scale) {
  split_attention<signed char, D>(
      q, k_pages, v_pages, k_scale, v_scale, page_table, seq_lens, out,
      workspace, counters, H, num_pages, page_size, pages_per_seq,
      num_splits, scale);
}

int splits_of(int page_size, int pages_per_seq) {
  return (page_size * pages_per_seq + kSplitTokens - 1) / kSplitTokens;
}

// The operands of one call, shared by both entries.
struct Call {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pt;
  const int* sl;
  float* out;
  float* ws;
  int* counters;
  int B, H, num_pages, page_size, pages_per_seq;
  float scale;
  cudaStream_t stream;

  unsigned blocks() const {
    return (unsigned)((long long)B * H * splits_of(page_size, pages_per_seq));
  }

  template <typename T, int D>
  cudaError_t plain() const {
    rpa_split_kernel<T, D><<<blocks(), kThreads, Plan<T, D>::kSmemBytes,
                             stream>>>(
        static_cast<const float*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), pt, sl, out, ws, counters, H, num_pages,
        page_size, pages_per_seq, splits_of(page_size, pages_per_seq),
        scale);
    return cudaSuccess;
  }

  template <int D>
  cudaError_t quant() const {
    rpa_quant_split_kernel<D><<<blocks(), kThreads,
                                Plan<signed char, D>::kSmemBytes, stream>>>(
        static_cast<const float*>(q), static_cast<const signed char*>(k),
        static_cast<const signed char*>(v), ks, vs, pt, sl, out, ws,
        counters, H, num_pages, page_size, pages_per_seq,
        splits_of(page_size, pages_per_seq), scale);
    return cudaSuccess;
  }
};

// pool: 0 fp32, 1 bf16, 2 int8.
struct Launch {
  const Call& call;
  int pool;
  template <int D>
  cudaError_t run() const {
    if (pool == 2) return call.quant<D>();
    if (pool == 1) return call.plain<__nv_bfloat16, D>();
    return call.plain<float, D>();
  }
};

struct Occupancy {
  int pool;
  int* blocks;
  template <typename Kernel>
  cudaError_t of(Kernel kernel, int smem) const {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         kThreads, smem);
  }
  template <int D>
  cudaError_t run() const {
    if (pool == 2)
      return of(rpa_quant_split_kernel<D>, Plan<signed char, D>::kSmemBytes);
    if (pool == 1)
      return of(rpa_split_kernel<__nv_bfloat16, D>,
                Plan<__nv_bfloat16, D>::kSmemBytes);
    return of(rpa_split_kernel<float, D>, Plan<float, D>::kSmemBytes);
  }
};

// Every head dim the kernels take: D = 32 * (1..8).
template <typename F>
cudaError_t dispatch_d(int D, const F& f) {
  switch (D / 32) {
    case 1: return f.template run<32>();
    case 2: return f.template run<64>();
    case 3: return f.template run<96>();
    case 4: return f.template run<128>();
    case 5: return f.template run<160>();
    case 6: return f.template run<192>();
    case 7: return f.template run<224>();
    case 8: return f.template run<256>();
  }
  return cudaErrorInvalidValue;
}

bool valid(int B, int H, int D, int num_pages, int page_size,
           int pages_per_seq) {
  return B >= 0 && H >= 1 && D >= 32 && D <= 256 && D % 32 == 0 &&
         num_pages >= 1 && page_size >= 1 && pages_per_seq >= 1 &&
         (long long)page_size * pages_per_seq <= INT_MAX - kSplitTokens &&
         (long long)B * H * splits_of(page_size, pages_per_seq) <= INT_MAX;
}

int run(const Call& call, int D, int pool) {
  if (call.B == 0) return (int)cudaGetLastError();
  const cudaError_t err = dispatch_d(D, Launch{call, pool});
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Tokens per split: the wrapper sizes the workspace with it.
extern "C" int ffrpa_split_tokens() { return kSplitTokens; }

// q [B,H,D] fp32; k_pages/v_pages [num_pages,page_size,H,D] fp32 or bf16,
// 16-byte aligned; page_table [B,pages_per_seq] int32; seq_lens [B] int32;
// out [B,H,D] fp32; workspace B * H * splits * (D + 2) fp32, where
// splits = ceil(page_size * pages_per_seq / ffrpa_split_tokens()), any
// contents; counters [B*H] int32, zero before the call and zero after
// it.  All contiguous, on the current device.  Launches on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" int ffrpa_launch(const void* q, const void* k_pages,
                            const void* v_pages, const void* page_table,
                            const void* seq_lens, void* out, void* workspace,
                            void* counters, int B, int H, int D,
                            int num_pages, int page_size, int pages_per_seq,
                            int kv_is_bf16, float scale, void* stream) {
  if (!valid(B, H, D, num_pages, page_size, pages_per_seq)) {
    return (int)cudaErrorInvalidValue;
  }
  const Call call{q, k_pages, v_pages, nullptr, nullptr,
                  static_cast<const int*>(page_table),
                  static_cast<const int*>(seq_lens),
                  static_cast<float*>(out), static_cast<float*>(workspace),
                  static_cast<int*>(counters), B, H, num_pages, page_size,
                  pages_per_seq, scale, static_cast<cudaStream_t>(stream)};
  return run(call, D, kv_is_bf16 ? 1 : 0);
}

// As ffrpa_launch over int8 pools (16-byte aligned) with k_scale/v_scale
// [num_pages,page_size] fp32.
extern "C" int ffrpa_quant_launch(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scale,
                                  const void* v_scale, const void* page_table,
                                  const void* seq_lens, void* out,
                                  void* workspace, void* counters, int B,
                                  int H, int D, int num_pages, int page_size,
                                  int pages_per_seq, float scale,
                                  void* stream) {
  if (!valid(B, H, D, num_pages, page_size, pages_per_seq)) {
    return (int)cudaErrorInvalidValue;
  }
  const Call call{q, k_pages, v_pages,
                  static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale),
                  static_cast<const int*>(page_table),
                  static_cast<const int*>(seq_lens),
                  static_cast<float*>(out), static_cast<float*>(workspace),
                  static_cast<int*>(counters), B, H, num_pages, page_size,
                  pages_per_seq, scale, static_cast<cudaStream_t>(stream)};
  return run(call, D, 2);
}

// Resident blocks per SM of the kernel for pool (0 fp32, 1 bf16, 2 int8)
// at head dim D, into *blocks.  Returns a cudaError_t.
extern "C" int ffrpa_blocks_per_sm(int pool, int D, int* blocks) {
  if (D < 32 || D > 256 || D % 32 != 0 || pool < 0 || pool > 2) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)dispatch_d(D, Occupancy{pool, blocks});
}
