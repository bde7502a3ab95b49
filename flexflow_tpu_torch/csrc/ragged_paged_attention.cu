// Ragged paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rpa_kernel` in
// flexflow_tpu/kernels/ragged_paged_attention.py (launched by
// `_pallas_ragged_paged`).  It computes the same function, not the same
// blocking: for every sequence b and head h,
//
//   out[b,h] = sum_t softmax_t(q[b,h] . k_t * scale) v_t
//
// over the first seq_lens[b] tokens of the sequence's pages, where token
// t lives in pool page page_table[b, t / page_size], slot t % page_size.
// Math is fp32 for fp32 and bf16 pools alike; l is floored at 1e-30, so
// seq_lens[b] == 0 gives zeros (the TPU kernel's semantics).  A page id
// outside [0, num_pages) is never dereferenced: the row it would feed
// comes out NaN.
//
// What bounds it on the card: device-memory bytes.  Each live token is
// read once per head, k and v, so the work moves
//   sum_b len_b * H * D * 2 * bytes_per_elem
// plus q and out, against about 4 * sum_b len_b * H * D fp32 operations:
// one operation per byte or less, far below the ~20 operations per byte
// where H100's fp32 (non-tensor-core) rate would take over.
//
// What the design does about it: it reads only live pages, once each.
// A warp walks the live tokens and reads page_table itself, touching no
// page past ceil(len / page_size) (the TPU version still DMA'd page 0
// for every dead page).  One block per (b, h), four warps; each warp
// takes runs of UNROLL consecutive tokens so that 2 * UNROLL row loads
// are in flight before the first use, lane l holds elements l, l+32, ...
// of q and of the accumulator (each load instruction reads 32
// consecutive elements), and a warp-shuffle sum gives each score.  Each
// warp keeps its own online softmax (m, l, acc); the warps merge in
// shared memory at the end.  wgmma, TMA and split-KV are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;  // the reference's finite mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// VPL = values per lane = D / 32.
template <typename T, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
rpa_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
           const T* __restrict__ v_pages, const int* __restrict__ page_table,
           const int* __restrict__ seq_lens, float* __restrict__ out, int H,
           int num_pages, int page_size, int pages_per_seq, float scale) {
  constexpr int D = VPL * 32;
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int cap = page_size * pages_per_seq;
  int n = seq_lens[b];
  n = n < 0 ? 0 : (n > cap ? cap : n);

  float qv[VPL];
  float acc[VPL];
  const float* qrow = q + (size_t)bh * D;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    qv[i] = qrow[i * 32 + lane];
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;
  int bad = 0;

  const int* pt_row = page_table + (size_t)b * pages_per_seq;
  const size_t slot_stride = (size_t)H * D;  // pool layout [P, ps, H, D]
  const size_t head_off = (size_t)h * D;

  for (int t0 = warp * kUnroll; t0 < n; t0 += kWarps * kUnroll) {
    float kv[kUnroll][VPL];
    float vv[kUnroll][VPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      int page = 0;
      bool live = t < n;
      if (live) {
        page = pt_row[t / page_size];
        if ((unsigned)page >= (unsigned)num_pages) {
          bad = 1;
          live = false;
        }
      }
      if (live) {
        const size_t base =
            ((size_t)page * page_size + (t % page_size)) * slot_stride +
            head_off;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          kv[u][i] = to_f32(k_pages[base + i * 32 + lane]);
          vv[u][i] = to_f32(v_pages[base + i * 32 + lane]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          kv[u][i] = 0.f;
          vv[u][i] = 0.f;
        }
      }
    }
    float s[kUnroll];
    float m_cur = kNegInf;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) d = fmaf(qv[i], kv[u][i], d);
      s[u] = warp_sum(d) * scale;
      if (t0 + u < n) m_cur = fmaxf(m_cur, s[u]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    float p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      p[u] = (t0 + u < n) ? expf(s[u] - m_new) : 0.f;
      psum += p[u];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vv[u][i], a);
      acc[i] = a;
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) sm_acc[warp][i * 32 + lane] = acc[i];
  bad = __syncthreads_or(bad);

  float m_all = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w]);
  float w_scale[kWarps];
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    w_scale[w] = expf(sm_m[w] - m_all);
    l_all += sm_l[w] * w_scale[w];
  }
  const float inv_l = 1.f / fmaxf(l_all, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = fmaf(sm_acc[w][d], w_scale[w], a);
    out[(size_t)bh * D + d] = bad ? nanf("") : a * inv_l;
  }
}

template <int VPL>
void launch(const void* q, const void* k, const void* v, const int* pt,
            const int* sl, float* out, int B, int H, int num_pages,
            int page_size, int pages_per_seq, int kv_is_bf16, float scale,
            cudaStream_t stream) {
  const dim3 grid((unsigned)(B * H));
  const dim3 block(kWarps * 32);
  if (kv_is_bf16) {
    rpa_kernel<__nv_bfloat16, VPL><<<grid, block, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), pt, sl, out, H, num_pages,
        page_size, pages_per_seq, scale);
  } else {
    rpa_kernel<float, VPL><<<grid, block, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), pt, sl, out, H, num_pages, page_size,
        pages_per_seq, scale);
  }
}

}  // namespace

// q [B,H,D] fp32; k_pages/v_pages [num_pages,page_size,H,D] fp32 or bf16;
// page_table [B,pages_per_seq] int32; seq_lens [B] int32; out [B,H,D]
// fp32.  All contiguous, on the current device.  Launches on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" int ffrpa_launch(const void* q, const void* k_pages,
                            const void* v_pages, const void* page_table,
                            const void* seq_lens, void* out, int B, int H,
                            int D, int num_pages, int page_size,
                            int pages_per_seq, int kv_is_bf16, float scale,
                            void* stream) {
  if (B < 0 || H < 1 || D < 32 || D > 256 || D % 32 != 0 ||
      num_pages < 1 || page_size < 1 || pages_per_seq < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaGetLastError();
  const int* pt = static_cast<const int*>(page_table);
  const int* sl = static_cast<const int*>(seq_lens);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D / 32) {
    case 1: launch<1>(q, k_pages, v_pages, pt, sl, o, B, H, num_pages, page_size, pages_per_seq, kv_is_bf16, scale, s); break;
    case 2: launch<2>(q, k_pages, v_pages, pt, sl, o, B, H, num_pages, page_size, pages_per_seq, kv_is_bf16, scale, s); break;
    case 3: launch<3>(q, k_pages, v_pages, pt, sl, o, B, H, num_pages, page_size, pages_per_seq, kv_is_bf16, scale, s); break;
    case 4: launch<4>(q, k_pages, v_pages, pt, sl, o, B, H, num_pages, page_size, pages_per_seq, kv_is_bf16, scale, s); break;
    case 5: launch<5>(q, k_pages, v_pages, pt, sl, o, B, H, num_pages, page_size, pages_per_seq, kv_is_bf16, scale, s); break;
    case 6: launch<6>(q, k_pages, v_pages, pt, sl, o, B, H, num_pages, page_size, pages_per_seq, kv_is_bf16, scale, s); break;
    case 7: launch<7>(q, k_pages, v_pages, pt, sl, o, B, H, num_pages, page_size, pages_per_seq, kv_is_bf16, scale, s); break;
    case 8: launch<8>(q, k_pages, v_pages, pt, sl, o, B, H, num_pages, page_size, pages_per_seq, kv_is_bf16, scale, s); break;
  }
  return (int)cudaGetLastError();
}
