// Exact inner-product top-k (MIPS) for Hopper, in two hand-written passes.
//
// Replaces the Pallas TPU kernel repro/kernels/mips_topk/kernel.py:
// mips_topk_pallas -> _mips_kernel (static n_valid mode) and
// _mips_kernel_masked (per-row mask mode), with their running top-k merge
// _topk_merge. The (Q, N) score matrix never reaches device memory.
//
// Pass 1, select_kernel: grid (ceil(Q/32), splits). A CTA holds up to 32
//   query rows in shared memory (transposed, fp32) and walks its contiguous
//   range of corpus rows in tiles of 64 rows. For each tile it stages the
//   corpus 32 columns at a time in shared memory; each of the 256 threads
//   owns a 2-query x 4-row block of scores. Every score is ONE sequential
//   fp32 FMA chain over d = 0 .. D-1, starting from 0: its reduction order
//   does not depend on Q, the query slot, the split or the launch, so a
//   row's scores (and therefore its top-k) are bit-identical whether it is
//   searched alone or in a batch. Then one warp per query merges the tile's
//   64 scores into that query's running top-k list in shared memory
//   (insertion under the total order below; a candidate is tested against
//   the list's worst entry first, so after the first tiles almost none
//   enter). Rows at or beyond n_valid (the wrapper passes n_valid as N) or
//   with mask[row] <= 0 never enter a list. Each CTA writes its per-query
//   list, (Q, splits, k) scores and global ids, to scratch.
// Pass 2, merge_kernel: one CTA per query selects the final k of its
//   splits*k candidates in k rounds of block-wide argmax.
//
// Order: higher score first; equal scores resolve to the lower row id (the
// lax.top_k contract). Empty list slots are (-inf, INT_MAX); an output slot
// that no valid row fills comes out as (-inf, -1).
//
// Bound: the function must read the corpus once, N*D*sizeof(T) bytes: at
// the main path's shape (N = 1,000,000, D = 256, fp32) 1.024 GB, 0.306 ms at
// the H100 SXM's 3.35 TB/s. Its arithmetic, 2*Q*N*D = 14.3 GFLOP at Q = 28,
// is 0.21 ms at the 67 TFLOP/s fp32 (non-tensor-core) peak, so it is bound
// by bytes. The design reads each corpus byte once per 32-query block (all
// of a <= 32-query batch in one pass), spreads the rows over enough CTAs to
// fill the 132 SMs, and keeps scores in registers and shared memory. It does
// not yet overlap the corpus loads with the FMAs (no cp.async/TMA ring).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;     // query slots per CTA
constexpr int kTileR = 64;  // corpus rows per tile
constexpr int kDK = 32;     // corpus columns staged per step
constexpr int kLd = kTileR + 1;  // padded row stride of the staged tiles
constexpr int kMaxK = 64;
constexpr int kMaxD = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool better(float v, int i, float wv, int wi) {
  return v > wv || (v == wv && i < wi);
}

size_t select_smem_bytes(int d) {
  return sizeof(float) * ((size_t)d * kBQ + (size_t)kDK * kLd + (size_t)kBQ * kLd) +
         (sizeof(float) + sizeof(int)) * (size_t)kBQ * kMaxK;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
select_kernel(const T* __restrict__ q, const T* __restrict__ c, const float* __restrict__ mask,
              float* __restrict__ cand_v, int* __restrict__ cand_i, int n_q, int n_rows,
              int d_model, int k, int rows_per_split, int splits) {
  extern __shared__ float smem[];
  float* q_t = smem;                           // [D][kBQ]
  float* c_t = q_t + (size_t)d_model * kBQ;    // [kDK][kLd]
  float* s_s = c_t + kDK * kLd;                // [kBQ][kLd]
  float* best_v = s_s + kBQ * kLd;             // [kBQ][kMaxK]
  int* best_i = reinterpret_cast<int*>(best_v + kBQ * kMaxK);  // [kBQ][kMaxK]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int nq = min(kBQ, n_q - q0);
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n_rows, r_begin + rows_per_split);

  for (int e = tid; e < d_model * kBQ; e += kThreads) {
    const int d = e / kBQ;
    const int s = e % kBQ;
    q_t[e] = s < nq ? to_f32(q[(size_t)(q0 + s) * d_model + d]) : 0.f;
  }
  for (int e = tid; e < kBQ * kMaxK; e += kThreads) {
    best_v[e] = -INFINITY;
    best_i[e] = INT_MAX;
  }
  __syncthreads();

  const int tq = tid & 15;  // this thread's query slots: 2*tq, 2*tq + 1
  const int tr = tid >> 4;  // this thread's tile rows: 4*tr .. 4*tr + 3
  for (int tile0 = r_begin; tile0 < r_end; tile0 += kTileR) {
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d_model; d0 += kDK) {
      // Stage rows [tile0, tile0 + 64) x columns [d0, d0 + 32): each warp
      // reads 32 consecutive columns of one row (coalesced) and stores them
      // transposed; the padded stride keeps the stores free of bank conflicts.
#pragma unroll
      for (int e = 0; e < (kTileR * kDK) / kThreads; ++e) {
        const int idx = e * kThreads + tid;
        const int r = idx / kDK;
        const int dd = idx % kDK;
        const int row = tile0 + r;
        const int d = d0 + dd;
        float v = 0.f;
        if (row < r_end && d < d_model) v = to_f32(c[(size_t)row * d_model + d]);
        c_t[dd * kLd + r] = v;
      }
      __syncthreads();
      const int dmax = min(kDK, d_model - d0);
#pragma unroll 8
      for (int dd = 0; dd < dmax; ++dd) {
        const float* qa = q_t + (size_t)(d0 + dd) * kBQ + 2 * tq;
        const float* cb = c_t + dd * kLd + 4 * tr;
        const float a0 = qa[0];
        const float a1 = qa[1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = cb[j];
          acc[0][j] = fmaf(a0, b, acc[0][j]);
          acc[1][j] = fmaf(a1, b, acc[1][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s_s[(2 * tq + i) * kLd + 4 * tr + j] = acc[i][j];
    __syncthreads();

    // One warp per query slot merges this tile's scores into its list.
    for (int s = warp; s < nq; s += kWarps) {
      float* bv = best_v + s * kMaxK;
      int* bi = best_i + s * kMaxK;
      const float* sc = s_s + s * kLd;
#pragma unroll
      for (int h = 0; h < kTileR / 32; ++h) {
        const int t = h * 32 + lane;
        const int row = tile0 + t;
        const bool valid = row < r_end && (mask == nullptr || mask[row] > 0.f);
        const float v = sc[t];
        const bool pass = valid && better(v, row, bv[k - 1], bi[k - 1]);
        unsigned todo = __ballot_sync(kFull, pass);
        while (todo) {
          const int src = __ffs(todo) - 1;
          todo &= todo - 1;
          const float cv = __shfl_sync(kFull, v, src);
          const int ci = __shfl_sync(kFull, row, src);
          if (!better(cv, ci, bv[k - 1], bi[k - 1])) continue;  // warp-uniform
          // The list is sorted, so the entries better than the candidate
          // form a prefix; its length is the insertion position.
          const bool b0 = lane < k && better(bv[lane], bi[lane], cv, ci);
          const bool b1 = lane + 32 < k && better(bv[lane + 32], bi[lane + 32], cv, ci);
          const int pos = __popc(__ballot_sync(kFull, b0)) + __popc(__ballot_sync(kFull, b1));
          const bool m0 = lane >= pos && lane < k - 1;
          const bool m1 = lane + 32 >= pos && lane + 32 < k - 1;
          float v0 = 0.f, v1 = 0.f;
          int i0 = 0, i1 = 0;
          if (m0) { v0 = bv[lane]; i0 = bi[lane]; }
          if (m1) { v1 = bv[lane + 32]; i1 = bi[lane + 32]; }
          __syncwarp();
          if (m0) { bv[lane + 1] = v0; bi[lane + 1] = i0; }
          if (m1) { bv[lane + 33] = v1; bi[lane + 33] = i1; }
          __syncwarp();
          if (lane == 0) { bv[pos] = cv; bi[pos] = ci; }
          __syncwarp();
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < nq * k; e += kThreads) {
    const int s = e / k;
    const int j = e % k;
    const size_t o = ((size_t)(q0 + s) * splits + split) * k + j;
    cand_v[o] = best_v[s * kMaxK + j];
    cand_i[o] = best_i[s * kMaxK + j];
  }
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
             float* __restrict__ out_v, int* __restrict__ out_i, int width, int k) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float last_v;
  __shared__ int last_i;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* cv = cand_v + (size_t)blockIdx.x * width;
  const int* ci = cand_i + (size_t)blockIdx.x * width;
  if (tid == 0) {
    last_v = INFINITY;
    last_i = -1;
  }
  __syncthreads();
  for (int r = 0; r < k; ++r) {
    // the best candidate strictly after the one picked last round
    const float lv = last_v;
    const int li = last_i;
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = tid; j < width; j += kThreads) {
      const float v = cv[j];
      const int i = ci[j];
      if (better(lv, li, v, i) && better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) {
        if (better(red_v[w], red_i[w], bv, bi)) {
          bv = red_v[w];
          bi = red_i[w];
        }
      }
      out_v[(size_t)blockIdx.x * k + r] = bv;
      out_i[(size_t)blockIdx.x * k + r] = bi == INT_MAX ? -1 : bi;
      last_v = bv;
      last_i = bi;
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_select(const void* q, const void* c, const float* mask, float* cand_v,
                          int* cand_i, int n_q, int n_rows, int d_model, int k,
                          int rows_per_split, int splits, cudaStream_t stream) {
  const size_t smem = select_smem_bytes(d_model);
  cudaError_t err = cudaFuncSetAttribute(
      select_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + kBQ - 1) / kBQ, splits);
  select_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(c), mask, cand_v, cand_i, n_q, n_rows,
      d_model, k, rows_per_split, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pass 1. dtype: 0 = float32, 1 = bfloat16 (queries and corpus alike).
// mask may be null (n_valid mode: pass n_valid as n_rows).
int mips_topk_select(const void* q, const void* c, const float* mask, float* cand_v,
                     int* cand_i, int n_q, int n_rows, int d_model, int k,
                     int rows_per_split, int splits, int dtype, void* stream) {
  if (n_q < 1 || n_rows < 1 || d_model < 1 || d_model > kMaxD || k < 1 || k > kMaxK ||
      rows_per_split < 1 || splits < 1 || splits > 65535 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return (int)launch_select<__nv_bfloat16>(q, c, mask, cand_v, cand_i, n_q, n_rows, d_model,
                                             k, rows_per_split, splits, s);
  }
  return (int)launch_select<float>(q, c, mask, cand_v, cand_i, n_q, n_rows, d_model, k,
                                   rows_per_split, splits, s);
}

// Pass 2: (n_q, width) candidates per query -> (n_q, k) final lists.
int mips_topk_merge(const float* cand_v, const int* cand_i, float* out_v, int* out_i, int n_q,
                    int width, int k, void* stream) {
  if (n_q < 1 || width < k || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  merge_kernel<<<n_q, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(cand_v, cand_i, out_v,
                                                                         out_i, width, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
