// blend_topn_rows / blend_topn_rows_quant (serving stage B over fetched
// rows): per query q and item i
//   pred[q, i] = alpha * x_q[i] + (1 - alpha) * ((sum_j s_qj*r_qj[i]) / k)
// with x_q the query row and r_qj its k neighbour rows, int8 with
// per-row scales (x_q = s_q * q8) or f32 (scales 1), then the top-n
// items, without writing the [Q, I] predictions to device memory.
//
// Replaces the TPU kernel repro/kernels/serving_topn.py ::
// blend_topn_rows_quant (int8) and its twin :: blend_topn_rows (f32),
// the final stage of cross-shard serving (and of int8 serving), which
// walk [bq, k, bi] blocks of pre-fetched rows.
//
// The kernel takes the address of every row: one per query and one per
// (query, neighbour).  The wrappers point them into pre-fetched rows
// [Q, k, I] (the JAX signature, which the sharded paths use) or, for
// int8 serving on one corpus, straight into the corpus rows that stage A
// selected, so the [Q, k, I] gather is never written.
//
// Bound: bytes.  Each query reads its k neighbour rows and its own row:
// Q*(k+1)*I elements when the rows are pre-fetched (3.7 GB in f32 at
// Q=256, k=300, I=11,997; a quarter of that in int8), fewer distinct
// bytes when they are corpus rows that queries share and L2 catches.
// The design is stage B's (serving_topn.cu): one block per (query,
// 1,024-item tile) sums the neighbour rows in fixed order j = 0..k-1
// (dequantizing is an exact multiply by a power of two), divides by k,
// blends with round-to-nearest intrinsics (no FMA contraction, so it
// rounds as the expression reads), bitonic-sorts the tile and keeps its
// best min(n, 1024); a second kernel merges the tiles.  Ordering is
// (value desc, item asc), as lax.top_k.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int BI = 1024;   // items per block
constexpr int NT = 256;    // threads per block
constexpr int PER_THREAD = BI / NT;

template <bool kInt8>
__device__ __forceinline__ float row_value(unsigned long long row, int i,
                                           float scale) {
  if constexpr (kInt8) {
    const int8_t v = __ldg(reinterpret_cast<const int8_t*>(row) + i);
    return __fmul_rn((float)v, scale);
  } else {
    return __ldg(reinterpret_cast<const float*>(row) + i);
  }
}

template <bool kInt8>
__global__ void __launch_bounds__(NT) rows_tile_kernel(
    const unsigned long long* __restrict__ q_rows,
    const float* __restrict__ q_scale,
    const unsigned long long* __restrict__ nbr_rows,
    const float* __restrict__ nbr_scale, int I, int k, float alpha,
    float one_minus_alpha, int L, float* __restrict__ part_v,
    int* __restrict__ part_i) {
  extern __shared__ float4 rows_smem[];
  float* tv = reinterpret_cast<float*>(rows_smem);             // [BI]
  int* ti = reinterpret_cast<int*>(tv + BI);                    // [BI]
  unsigned long long* rows =
      reinterpret_cast<unsigned long long*>(ti + BI);           // [k]
  float* scales = reinterpret_cast<float*>(rows + k);           // [k]

  const int tile = blockIdx.x;
  const int T = gridDim.x;
  const int qq = blockIdx.y;
  const int tid = threadIdx.x;
  const int i0 = tile * BI;

  for (int t = tid; t < k; t += NT) {
    rows[t] = nbr_rows[(size_t)qq * k + t];
    scales[t] = kInt8 ? nbr_scale[(size_t)qq * k + t] : 1.0f;
  }
  __syncthreads();

  float acc[PER_THREAD];
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) acc[e] = 0.0f;
  for (int j = 0; j < k; ++j) {
    const unsigned long long row = rows[j];
    const float s = scales[j];
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const int i = i0 + tid + e * NT;
      if (i < I) acc[e] = __fadd_rn(acc[e], row_value<kInt8>(row, i, s));
    }
  }
  const unsigned long long own = q_rows[qq];
  const float own_scale = kInt8 ? q_scale[qq] : 1.0f;
  const float kf = (float)k;
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int slot = tid + e * NT;
    const int i = i0 + slot;
    if (i < I) {
      const float x = row_value<kInt8>(own, i, own_scale);
      tv[slot] = __fadd_rn(__fmul_rn(alpha, x),
                           __fmul_rn(one_minus_alpha, __fdiv_rn(acc[e], kf)));
      ti[slot] = i;
    } else {
      tv[slot] = -INFINITY;
      ti[slot] = PAD_IDX;
    }
  }
  __syncthreads();
  bitonic_sort_desc<true>(tv, ti, BI, tid, NT);
  for (int t = tid; t < L; t += NT) {
    const size_t o = ((size_t)qq * T + tile) * L + t;
    part_v[o] = tv[t];
    part_i[o] = ti[t];
  }
}

}  // namespace

// q_rows: [Q] and nbr_rows: [Q, k] device addresses of rows of I
// elements (int8 when int8 != 0, with q_scale f32[Q] and nbr_scale
// f32[Q, k]; else f32 and both scales null).  part_*: scratch [Q,
// n_tiles, L] with L = min(topn, 1024), n_tiles = ceil(I / 1024);
// out_*: [Q, topn]; n2 = power of two >= max(L, topn), at most 1024.
extern "C" int blend_rows_launch(const void* q_rows, const void* q_scale,
                                 const void* nbr_rows, const void* nbr_scale,
                                 int int8, int Q, int I, int k, float alpha,
                                 float one_minus_alpha, int topn, int L,
                                 int n2, void* part_v, void* part_i,
                                 void* out_v, void* out_i, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (I + BI - 1) / BI;
  const size_t smem = (size_t)BI * 8 + (size_t)k * 12;
  const void* kernel = int8 ? (const void*)rows_tile_kernel<true>
                            : (const void*)rows_tile_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, Q);
  const auto* qr = (const unsigned long long*)q_rows;
  const auto* nr = (const unsigned long long*)nbr_rows;
  if (int8) {
    rows_tile_kernel<true><<<grid, NT, smem, st>>>(
        qr, (const float*)q_scale, nr, (const float*)nbr_scale, I, k, alpha,
        one_minus_alpha, L, (float*)part_v, (int*)part_i);
  } else {
    rows_tile_kernel<false><<<grid, NT, smem, st>>>(
        qr, nullptr, nr, nullptr, I, k, alpha, one_minus_alpha, L,
        (float*)part_v, (int*)part_i);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_lists_kernel<<<Q, 256, (size_t)n2 * 8, st>>>(
      (const float*)part_v, (const int*)part_i, n_tiles, L, n2, topn,
      (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}
