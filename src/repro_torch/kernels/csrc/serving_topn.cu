// blend_topn (serving stage B): per query q and item i
//     pred[q, i] = alpha * C[uid_q, i] + ((1 - alpha) * sum_j C[idx_qj, i]) / k
// (neighbours outside [0, M), e.g. -1, add 0 but still count in k), then
// the top-n items, without writing [Q, k, I] or [Q, I] to device memory.
//
// Replaces the TPU kernel repro/kernels/serving_topn.py ::
// blend_topn_onehot, which recovers the neighbour sum as a one-hot
// matmul over corpus tiles because the TPU's MXU prefers a contraction
// to a data-dependent gather.  On Hopper it is a gather.
//
// Bound: bytes.  Each query reads its k neighbour rows and its own row
// (at most Q*(k+1)*I*4 bytes, 3.7 GB at Q=256, k=300, I=11,997; at
// least one pass over the corpus when neighbourhoods overlap and L2
// catches the reuse).  The design:
//   * a block takes one query x one tile of BI=1024 items; it sums the
//     neighbour rows in fixed order j = 0..k-1 with coalesced row reads
//     (4 items per thread), adds the alpha term, and bitonic-sorts the
//     tile's predictions to keep its best min(n, BI);
//   * a second kernel merges the tiles' [Q, T, L] lists into [Q, n].
// The blend uses round-to-nearest intrinsics so the compiler cannot
// contract it into an FMA: the expression rounds as the plain version
// does.  Ordering is (value desc, item asc), as lax.top_k.
#include <cuda_runtime.h>

#include "topk_common.cuh"

namespace {

constexpr int BI = 1024;   // items per block
constexpr int NT = 256;    // threads per block
constexpr int PER_THREAD = BI / NT;

__global__ void __launch_bounds__(NT) blend_tile_kernel(
    const float* __restrict__ C, const int* __restrict__ uid,
    const int* __restrict__ nbr, int M, int I, int k, float alpha,
    float one_minus_alpha, int L, float* __restrict__ part_v,
    int* __restrict__ part_i) {
  extern __shared__ float4 blend_smem[];
  float* tv = reinterpret_cast<float*>(blend_smem);   // [BI]
  int* ti = reinterpret_cast<int*>(tv + BI);           // [BI]
  int* rows = ti + BI;                                  // [k]

  const int tile = blockIdx.x;
  const int T = gridDim.x;
  const int qq = blockIdx.y;
  const int tid = threadIdx.x;
  const int i0 = tile * BI;

  for (int t = tid; t < k; t += NT) rows[t] = nbr[(size_t)qq * k + t];
  __syncthreads();

  float acc[PER_THREAD];
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) acc[e] = 0.0f;
  for (int j = 0; j < k; ++j) {
    const int row = rows[j];
    if (row < 0 || row >= M) continue;               // block-uniform
    const float* cr = C + (size_t)row * I;
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const int i = i0 + tid + e * NT;
      if (i < I) acc[e] += cr[i];
    }
  }
  const int u = uid[qq];
  const bool own_ok = u >= 0 && u < M;
  const float kf = (float)k;
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int slot = tid + e * NT;
    const int i = i0 + slot;
    if (i < I) {
      const float own = own_ok ? C[(size_t)u * I + i] : 0.0f;
      tv[slot] = __fadd_rn(__fmul_rn(alpha, own),
                           __fdiv_rn(__fmul_rn(one_minus_alpha, acc[e]), kf));
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

// part_*: scratch [Q, n_tiles, L] with L = min(topn, 1024) and n_tiles =
// ceil(I / 1024); out_*: [Q, topn]; n2 = power of two >= max(L, topn),
// at most 1024.
extern "C" int blend_topn_launch(const void* C, const void* uid,
                                 const void* nbr, int Q, int M, int I, int k,
                                 float alpha, float one_minus_alpha,
                                 int topn, int L, int n2, void* part_v,
                                 void* part_i, void* out_v, void* out_i,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (I + BI - 1) / BI;
  const size_t smem = (size_t)BI * 8 + (size_t)k * 4;
  cudaError_t err = cudaFuncSetAttribute(
      blend_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_tiles, Q);
  blend_tile_kernel<<<grid, NT, smem, st>>>(
      (const float*)C, (const int*)uid, (const int*)nbr, M, I, k, alpha,
      one_minus_alpha, L, (float*)part_v, (int*)part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_lists_kernel<<<Q, 256, (size_t)n2 * 8, st>>>(
      (const float*)part_v, (const int*)part_i, n_tiles, L, n2, topn,
      (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}
