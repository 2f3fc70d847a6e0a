// knn_topk (serving stage A): per-query top-k corpus rows of the
// euclidean surrogate 2q.c - |c|^2 (with sub_qnorm the full -|q-c|^2,
// for the per-shard candidates of the sharded path; or the raw dot
// product), without writing the [Q, M] score matrix to device memory.
//
// Replaces the TPU kernel repro/kernels/knn_topk.py :: knn_topk, whose
// grid walks the corpus tiles IN ORDER per query block and merges each
// score tile into a running [bq, k] top-k held in VMEM.
//
// Bound: operations.  2*Q*M*D fp32 FLOPs (85.7 GFLOP at Q=256,
// M=13,949, D=11,997) on CUDA cores -- no tensor cores, so the result
// keeps fp32 parity with the plain version.  The design:
//   * Hopper runs blocks in parallel, not in order, so the corpus is cut
//     into S slices and a block takes BQ=16 queries x one slice; the
//     wrapper picks S so that the grid is about one block per SM (the
//     top-k lists hold most of an SM's shared memory).
//   * A slice is walked in score tiles of BM=512 rows.  D is walked in
//     BD=16 chunks staged through shared memory, double-buffered: the
//     next chunk's global loads are in flight while the current one is
//     multiplied.  Each thread holds an 8-query x 4-row register tile,
//     so 3 shared-memory vector reads feed 32 FMAs.  Each score is one
//     fmaf chain over d = 0..D-1 in order.
//   * Each [BQ, BM] score tile (in shared memory, over the staging
//     buffers) is masked (the self column whose gid row*col_stride +
//     col_offset equals the query gid scores -inf; rows past the slice
//     are no candidates) and merged by one warp per query, 64 candidates
//     at a time, into a running top-n2 list in shared memory (n2 = power
//     of two >= max(k, 64), <= 1024; topk_common.cuh merge_score_tile).
//   * A second kernel merges the S per-slice lists [Q, S, k] into [Q, k].
// Ordering is (value desc, index asc) throughout, as lax.top_k.
#include <cuda_runtime.h>

#include "topk_common.cuh"

namespace {

constexpr int NT = 256;                  // threads per block
constexpr int NWARP = NT / 32;
constexpr int BQ = 16;                   // queries per block
constexpr int TQ = 8;                    // queries per thread
constexpr int TM = 4;                    // corpus rows per thread
constexpr int ROW_THREADS = NT / (BQ / TQ);   // threads across the rows
constexpr int BM = ROW_THREADS * TM;     // 512 corpus rows per score tile
constexpr int BD = 16;                   // D chunk staged in shared memory
constexpr int CS_STRIDE = BM + 4;        // padded: 2-way bank conflicts
constexpr int QS_STRIDE = BQ + 4;        // on the transposing stores
constexpr int CS_FLOATS = BD * CS_STRIDE;
constexpr int QS_FLOATS = BD * QS_STRIDE;
constexpr int STAGE_FLOATS = 2 * (CS_FLOATS + QS_FLOATS);
constexpr int C_LOADS = BM * BD / NT;    // corpus elements per thread/chunk
static_assert(BQ * BD == NT, "one query element per thread per chunk");
static_assert(BQ * BM <= STAGE_FLOATS, "score tile fits over the staging");
static_assert(ROW_THREADS % 32 == 0, "a warp shares its query tile");

size_t tile_smem_bytes(int n2) {
  return sizeof(float) * STAGE_FLOATS +
         (sizeof(float) + sizeof(int)) *
             ((size_t)BQ * n2 + NWARP * MERGE_CAND);
}

// Global loads of one D chunk (rows m0.. of the slice, queries q0..)
// into registers; out-of-range elements read 0.
__device__ __forceinline__ void load_chunk(
    const float* __restrict__ q, const float* __restrict__ c, int Q, int D,
    int q0, int m0, int m_end, int d0, int tid, float (&creg)[C_LOADS],
    float& qreg) {
#pragma unroll
  for (int j = 0; j < C_LOADS; ++j) {
    const int e = tid + j * NT;
    const int gm = m0 + e / BD, gd = d0 + e % BD;
    creg[j] = (gm < m_end && gd < D) ? c[(size_t)gm * D + gd] : 0.0f;
  }
  const int gq = q0 + tid / BD, gd = d0 + tid % BD;
  qreg = (gq < Q && gd < D) ? q[(size_t)gq * D + gd] : 0.0f;
}

// Transpose the loaded chunk into staging buffer ``buf``: cs[d][row],
// qs[d][query].
__device__ __forceinline__ void store_chunk(float* cs, float* qs, int buf,
                                            int tid,
                                            const float (&creg)[C_LOADS],
                                            float qreg) {
  float* cb = cs + buf * CS_FLOATS;
#pragma unroll
  for (int j = 0; j < C_LOADS; ++j) {
    const int e = tid + j * NT;
    cb[(e % BD) * CS_STRIDE + e / BD] = creg[j];
  }
  qs[buf * QS_FLOATS + (tid % BD) * QS_STRIDE + tid / BD] = qreg;
}

__global__ void __launch_bounds__(NT, 1) knn_tile_kernel(
    const float* __restrict__ q, const float* __restrict__ c,
    const float* __restrict__ cn, const float* __restrict__ qn,
    const int* __restrict__ qgid, int Q,
    int M, int D, int k, int n2, int euclid, long long col_offset,
    long long col_stride, int rows_per_slice, float* __restrict__ part_v,
    int* __restrict__ part_i) {
  extern __shared__ float4 knn_smem[];
  float* cs = reinterpret_cast<float*>(knn_smem);    // [2][BD][CS_STRIDE]
  float* qs = cs + 2 * CS_FLOATS;                     // [2][BD][QS_STRIDE]
  float* sv = cs;              // [BQ][BM] scores, over the staging buffers
  float* lv = cs + STAGE_FLOATS;                      // [BQ][n2] list vals
  int* li = reinterpret_cast<int*>(lv + BQ * n2);     // [BQ][n2] list idx
  float* wv = reinterpret_cast<float*>(li + BQ * n2);   // [NWARP][CAND]
  int* wi = reinterpret_cast<int*>(wv + NWARP * MERGE_CAND);

  const int q0 = blockIdx.x * BQ;
  const int slice = blockIdx.y;
  const int S = gridDim.y;
  const int m_begin = slice * rows_per_slice;
  const int m_end = min(M, m_begin + rows_per_slice);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int tq = tid / ROW_THREADS;   // queries tq*TQ .. tq*TQ+TQ-1
  const int tm = tid % ROW_THREADS;   // rows tm*TM .. tm*TM+TM-1 of a tile
  const int n_chunks = (D + BD - 1) / BD;

  for (int t = tid; t < BQ * n2; t += NT) {
    lv[t] = -INFINITY;
    li[t] = PAD_IDX;
  }

  for (int m0 = m_begin; m0 < m_end; m0 += BM) {
    // warps whose rows all lie past the slice skip the multiply
    const bool warp_live = m0 + (tm - lane) * TM < m_end;
    float creg[C_LOADS];
    float qreg;
    float acc[TQ][TM];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;

    __syncthreads();   // the previous tile's merge is done with sv
    load_chunk(q, c, Q, D, q0, m0, m_end, 0, tid, creg, qreg);
    store_chunk(cs, qs, 0, tid, creg, qreg);
    __syncthreads();
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int buf = ch & 1;
      const bool more = ch + 1 < n_chunks;
      if (more) {
        load_chunk(q, c, Q, D, q0, m0, m_end, (ch + 1) * BD, tid, creg,
                   qreg);
      }
      if (warp_live) {
        const float* cb = cs + buf * CS_FLOATS + tm * TM;
        const float* qb = qs + buf * QS_FLOATS + tq * TQ;
#pragma unroll
        for (int dd = 0; dd < BD; ++dd) {
          const float4 a0 =
              *reinterpret_cast<const float4*>(qb + dd * QS_STRIDE);
          const float4 a1 =
              *reinterpret_cast<const float4*>(qb + dd * QS_STRIDE + 4);
          const float4 b =
              *reinterpret_cast<const float4*>(cb + dd * CS_STRIDE);
          const float a[TQ] = {a0.x, a0.y, a0.z, a0.w,
                               a1.x, a1.y, a1.z, a1.w};
          const float bb[TM] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < TQ; ++i)
#pragma unroll
            for (int j = 0; j < TM; ++j)
              acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
        }
      }
      if (more) store_chunk(cs, qs, buf ^ 1, tid, creg, qreg);
      __syncthreads();
    }

    // scores, masked, over the staging buffers (free after the last sync)
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int qi = tq * TQ + i;
      const long long my_gid =
          (q0 + qi < Q) ? (long long)qgid[q0 + qi] : -1LL;
      const float my_qn =
          (qn != nullptr && q0 + qi < Q) ? qn[q0 + qi] : 0.0f;
      float s[TM];
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int m = m0 + tm * TM + j;
        s[j] = -INFINITY;
        if (m < m_end && (long long)m * col_stride + col_offset != my_gid) {
          s[j] = acc[i][j];
          if (euclid) {
            s[j] = 2.0f * s[j] - cn[m];     // 2*acc is exact: one rounding
            if (qn != nullptr) s[j] = __fsub_rn(s[j], my_qn);
          }
        }
      }
      *reinterpret_cast<float4*>(sv + qi * BM + tm * TM) =
          make_float4(s[0], s[1], s[2], s[3]);
    }
    __syncthreads();

    merge_score_tile<BQ, BM, NWARP>(sv, lv, li, wv, wi, q0, Q, m0, m_end,
                                    k, n2);
  }
  __syncthreads();
  write_slice_lists<BQ>(lv, li, q0, Q, k, n2, slice, S, part_v, part_i);
}

}  // namespace

// part_*: scratch [Q, n_slices, k]; out_*: [Q, k].  n2 is a power of two
// in [max(k, 64), 1024]; rows_per_slice * n_slices >= M.  qn (f32[Q] or
// null) is |q|^2, subtracted from each euclidean score (sub_qnorm: the
// full -|q-c|^2 that the cross-shard merge compares).
extern "C" int knn_topk_launch(const void* q, const void* c, const void* cn,
                               const void* qn, const void* qgid, int Q,
                               int M, int D, int k, int n2, int euclid,
                               long long col_offset, long long col_stride,
                               int rows_per_slice,
                               int n_slices, void* part_v, void* part_i,
                               void* out_v, void* out_i, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  size_t smem = tile_smem_bytes(n2);
  cudaError_t err = cudaFuncSetAttribute(
      knn_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + BQ - 1) / BQ, n_slices);
  knn_tile_kernel<<<grid, NT, smem, st>>>(
      (const float*)q, (const float*)c, (const float*)cn, (const float*)qn,
      (const int*)qgid, Q, M, D, k, n2, euclid, col_offset, col_stride,
      rows_per_slice, (float*)part_v, (int*)part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_lists_kernel<<<Q, 256, (size_t)n2 * 8, st>>>(
      (const float*)part_v, (const int*)part_i, n_slices, k, n2, k,
      (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}
