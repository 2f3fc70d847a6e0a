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
// M=13,949, D=11,997) on CUDA cores -- no tensor cores and no TF32, so
// the result keeps fp32 parity with the plain version.  The design:
//   * Hopper runs blocks in parallel, not in order, so the corpus is cut
//     into S slices and a block takes BQ queries x one slice, about one
//     block per SM (knn_topk.py::plan_knn).  A block keeps one list of
//     exactly k (value, row) entries per query in shared memory, so 32
//     queries' lists take 77 KB at k=300 and BQ=32 fits up to k=456;
//     beyond that BQ=16.  Every query tile streams the corpus through
//     L2, so 32 queries a block halve that traffic against 16.
//   * A slice is walked in score tiles of BM=256 rows.  D is walked in
//     chunks of BD=32 values (128 bytes of a row) through a ring of
//     STAGES chunks in shared memory, filled by cp.async with one
//     __syncthreads per chunk.  The corpus rows' pitch (D * 4 bytes)
//     need not be a multiple of 16 (D=11,997: 4 mod 16), so the copies
//     are 4 bytes: one warp instruction moves 128 contiguous bytes of
//     one row into the row's own place in the ring, padded to PITCH
//     floats so that the compute reads it with conflict-free float4
//     loads.  D's tail is zero-filled; rows past the slice and queries
//     past Q are not copied (their scores are never used).
//     The ring has 2 stages: on an NVIDIA H100 80GB HBM3 at 700 W, at
//     TaFeng's shape (tools/dtiled_phase_split.py), a third ran slower
//     in each design tried (4.35-4.41 against 4.15-4.21 ms; 4.59-4.66
//     against 4.33-4.40): a chunk takes longer to multiply than to
//     arrive, and the smaller ring leaves L1 room for the 128-byte line
//     that two chunks of a misaligned row share.
//   * Each thread holds a TQ = BQ/4 query x 4 row register tile: per 4
//     values of D, 4 + TQ float4 shared loads feed 16*TQ fmaf.  Each
//     score is one fmaf chain over d = 0..D-1 in order.  |c|^2 is summed
//     in the same loop, also one fmaf chain in d order: each of the 4
//     query groups owns one of a thread's 4 rows (its registers are
//     rotated so the owned row sits in slot 0), so it costs every thread
//     4 fmaf per 4 values of D and the wrapper passes no |c|^2.
//     On the same card, an 8 x 8 tile (a third fewer loads per fmaf,
//     512-row tiles on a swizzled ring) multiplied no faster and
//     overlapped the copies worse (products 4.03-4.05 against 3.41-3.52
//     ms), so the 8 x 4 tile stays.
//   * Each [BQ, BM] score tile is masked (the self column whose gid
//     row*col_stride + col_offset equals the query gid scores -inf; rows
//     past the slice are no candidates).  Every two tiles (MB=512 rows)
//     are merged by one warp per query into the per-query lists at once:
//     the first tile's scores wait in their own [BQ, BM] array, the
//     second's lie over the ring; the candidates are sorted in
//     registers, then merged by rank (merge_score_tile_sorted below; the
//     result of topk_common.cuh's merge_score_tile_ranked, in an eighth
//     of its folds, and no power-of-two list).  On the same card the
//     merge takes 0.16-0.20 ms, against 0.56-0.64 folding each 256-row
//     tile and 0.77-0.80 folding 64 rows at a time.
//   * A second kernel merges the S per-slice lists [Q, S, k] into [Q, k].
// Ordering is (value desc, index asc) throughout, as lax.top_k.  The
// ring's copies, the register tile and the |c|^2 rotation live in
// knn_ring.cuh, shared with the fp32 design of knn_topk_dtiled.cu.
#include <cuda_runtime.h>

#include "knn_ring.cuh"
#include "topk_common.cuh"

namespace {

using namespace knn_ring;   // the ring, the register tile and their constants

constexpr int MB = 2 * BM;               // rows folded into the lists at once
constexpr size_t SMEM_MAX = 232448;      // shared memory a block may use

// The dynamic shared memory of one block: the ring of ``stages`` chunks
// of (BM rows + bq queries) x PITCH floats, the scores of a fold's first
// tile [bq][BM], then bq lists of k (value, row) entries.  The second
// tile's scores and the merge's scratch lie on the ring.  The same
// formula as knn_topk.py::knn_smem_bytes, which passes its result in.
size_t knn_smem_bytes(int bq, int stages, int k) {
  return sizeof(float) * stages * (size_t)(BM + bq) * PITCH +
         sizeof(float) * (size_t)bq * BM +
         (sizeof(float) + sizeof(int)) * (size_t)bq * k;
}

// Bitonic sort, descending, of a warp's 32*E (value, row) entries held in
// registers, entry t = lane*E + e in v[e], ix[e]: strides below E swap
// inside a lane, larger ones pair lanes by shuffles.
template <int E>
__device__ __forceinline__ void warp_sort_desc(float (&v)[E], int (&ix)[E],
                                               int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int t = lane * E + e;
        // entry t's block runs descending when (t & size) == 0
        const bool desc = (t & size) == 0;
        if (stride >= E) {
          const float pv = __shfl_xor_sync(0xffffffffu, v[e], stride / E);
          const int pi = __shfl_xor_sync(0xffffffffu, ix[e], stride / E);
          keep_pair(v[e], ix[e], pv, pi, ((t & stride) == 0) == desc);
        } else if ((e & stride) == 0) {
          const int f = e + stride;
          if (desc ? better(v[f], ix[f], v[e], ix[e])
                   : better(v[e], ix[e], v[f], ix[f])) {
            const float tv = v[e];
            const int ti = ix[e];
            v[e] = v[f];
            ix[e] = ix[f];
            v[f] = tv;
            ix[f] = ti;
          }
        }
      }
    }
  }
}

// Fold two masked score tiles sv0, sv1 [BQ][BM] (rows m0.. and m0 + BM..
// of the block's slice) into the per-query lists lv/li[BQ][k] (the best
// k in their first k entries), one warp per query and both tiles at
// once: the rows that beat the current k-th entry are sorted in
// registers and kept in the warp's scratch cv/ci[NWARP][MB]; each real
// list entry
// moves right by the number of candidates better than it (from the last
// one, 32 at a time, until none moves), and each candidate lands at its
// place among the candidates plus its place in the old list; what lands
// at or past k drops out.  The result is merge_score_tile_ranked's, in
// one fold per 512 rows in place of one per 64.  Every thread of the
// block calls this after both tiles are complete.
template <int BQ>
__device__ void merge_score_tile_sorted(const float* sv0, const float* sv1,
                                        float* lv, int* li, float* cv,
                                        int* ci, int q0, int Q, int m0,
                                        int m_end, int k) {
  constexpr int E = MB / 32;
  static_assert(E % 4 == 0 && BM % E == 0, "whole float4 in one tile");
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* bv = cv + warp * MB;
  int* bi = ci + warp * MB;
  // lane l's E candidates, rows l*E .., lie in one of the two tiles
  const float* sv = (lane * E < BM ? sv0 : sv1) + lane * E % BM;
  for (int h = 0; h < BQ / NWARP; ++h) {
    const int r = warp * (BQ / NWARP) + h;
    if (q0 + r >= Q) continue;                 // warp-uniform
    float* lvr = lv + r * k;
    int* lir = li + r * k;
    const float thr_v = lvr[k - 1];
    const int thr_i = lir[k - 1];
    float v[E];
    int ix[E];
    bool any = false;
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 x = *reinterpret_cast<const float4*>(sv + r * BM + e);
      v[e] = x.x;
      v[e + 1] = x.y;
      v[e + 2] = x.z;
      v[e + 3] = x.w;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int t = lane * E + e;
      ix[e] = m0 + t;
      if (m0 + t < m_end && better(v[e], ix[e], thr_v, thr_i)) {
        any = true;
      } else {
        v[e] = -INFINITY;
        ix[e] = PAD_IDX;
      }
    }
    if (!__any_sync(0xffffffffu, any)) continue;
    warp_sort_desc<E>(v, ix, lane);
    int pos[E];   // each candidate's place in the merged list
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      *reinterpret_cast<float4*>(bv + lane * E + e) =
          make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
      *reinterpret_cast<int4*>(bi + lane * E + e) =
          make_int4(ix[e], ix[e + 1], ix[e + 2], ix[e + 3]);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      pos[e] = ix[e] != PAD_IDX
                   ? lane * E + e + list_rank(lvr, lir, k, v[e], ix[e])
                   : k;
    }
    // padding entries need not move: they land on padding (or under a
    // candidate), so only the real entries, the list's head, shift
    const int n_real = list_rank(lvr, lir, k, -INFINITY, PAD_IDX);
    __syncwarp();
    for (int base = n_real - 1; base >= 0; base -= 32) {
      const int i = base - lane;
      float av = 0.0f;
      int ai = 0;
      int to = i;
      if (i >= 0) {
        av = lvr[i];
        ai = lir[i];
        to = i + list_rank(bv, bi, MB, av, ai);
      }
      // entries before these are better still: none of them moves
      if (__all_sync(0xffffffffu, to == i)) break;
      __syncwarp();
      if (to != i && to < k) {
        lvr[to] = av;
        lir[to] = ai;
      }
      __syncwarp();
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (pos[e] < k) {
        lvr[pos[e]] = v[e];
        lir[pos[e]] = ix[e];
      }
    }
    __syncwarp();
  }
}

template <int BQ, int STAGES>
__global__ void __launch_bounds__(NT, 1) knn_tile_kernel(
    const float* __restrict__ q, const float* __restrict__ c,
    const float* __restrict__ qn, const int* __restrict__ qgid, int Q,
    int M, int D, int k, int euclid, long long col_offset,
    long long col_stride, int rows_per_slice, float* __restrict__ part_v,
    int* __restrict__ part_i) {
  constexpr int TQ = BQ / QGROUPS;                  // queries per thread
  constexpr int STAGE = (BM + BQ) * PITCH;          // floats per stage
  static_assert(BQ % NWARP == 0, "whole query rows per warp");
  static_assert(STAGES >= 2, "a chunk in flight while one is multiplied");
  static_assert(BQ * BM + BM + 2 * NWARP * MB <= STAGES * STAGE,
                "scores and merge scratch fit the ring");
  extern __shared__ float4 knn_smem[];
  float* ring = reinterpret_cast<float*>(knn_smem);  // [STAGES][BM+BQ][..]
  float* sv0 = ring + STAGES * STAGE;    // [BQ][BM] a fold's first tile
  float* lv = sv0 + BQ * BM;                        // [BQ][k] list vals
  int* li = reinterpret_cast<int*>(lv + BQ * k);    // [BQ][k] list rows
  float* sv1 = ring;                     // [BQ][BM] its second, on the ring
  float* cn = ring + BQ * BM;            // [BM] |c|^2, over the ring
  float* mv = cn + BM;                   // [NWARP][MB] merge scratch,
  int* mi = reinterpret_cast<int*>(mv + NWARP * MB);   // over the ring

  const int q0 = blockIdx.x * BQ;
  const int slice = blockIdx.y;
  const int m_begin = slice * rows_per_slice;
  const int m_end = min(M, m_begin + rows_per_slice);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int tq = warp % QGROUPS;
  const int h = warp / QGROUPS;
  const int n_chunks = (D + BD - 1) / BD;
  int row[TM];
#pragma unroll
  for (int j = 0; j < TM; ++j) row[j] = tile_row(h, lane, tq, j);

  for (int t = tid; t < BQ * k; t += NT) {
    lv[t] = -INFINITY;
    li[t] = PAD_IDX;
  }

  for (int m0 = m_begin; m0 < m_end; m0 += MB) {
    // the fold's tiles: the first's scores in sv0, the second's in sv1
    for (int t = 0; t < MB / BM && m0 + t * BM < m_end; ++t) {
      const int mt = m0 + t * BM;        // the tile's first row
      float* sv = t == 0 ? sv0 : sv1;
      // a warp whose rows all lie past the slice skips the products
      const bool warp_live = mt + h * HALF < m_end;
      float acc[TQ][TM];
      float nacc = 0.0f;   // |c|^2 of row[0]
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;

      auto issue = [&](int ch) {
        issue_chunk<BQ>(ring + (ch % STAGES) * STAGE, q, c, D, Q, q0, mt,
                        m_end, ch * BD, D, warp, lane);
      };

      __syncthreads();   // the previous tile's scores and merge are done
                         // with the ring
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_chunks) issue(s);
        cp_async_commit();
      }
      for (int ch = 0; ch < n_chunks; ++ch) {
        cp_async_wait<STAGES - 2>();   // chunk ch has landed
        __syncthreads();               // ... for every thread, and chunk
                                       // ch - 1's stage is free
        if (ch + STAGES - 1 < n_chunks) issue(ch + STAGES - 1);
        cp_async_commit();
        if (warp_live) {
          const float* st = ring + (ch % STAGES) * STAGE;
          mul_chunk<TQ>(st, st + (BM + tq * TQ) * PITCH, row, acc, nacc);
        }
      }
      cp_async_wait<0>();
      __syncthreads();   // every warp is done with the ring (sv lies on it)

      cn[row[0]] = nacc;
      __syncthreads();
      // scores, masked
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int qi = tq * TQ + i;
        const bool q_ok = q0 + qi < Q;
        const long long my_gid = q_ok ? (long long)qgid[q0 + qi] : -1LL;
        const float my_qn = (qn != nullptr && q_ok) ? qn[q0 + qi] : 0.0f;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const int m = mt + row[j];
          float s = -INFINITY;
          if (m < m_end && (long long)m * col_stride + col_offset != my_gid) {
            s = acc[i][j];
            if (euclid) {
              s = 2.0f * s - cn[row[j]];    // 2*acc is exact: one rounding
              if (qn != nullptr) s = __fsub_rn(s, my_qn);
            }
          }
          sv[qi * BM + row[j]] = s;
        }
      }
    }
    __syncthreads();

    // rows past m_end are no candidates: a missing second tile's stale
    // scores are masked
    merge_score_tile_sorted<BQ>(sv0, sv1, lv, li, mv, mi, q0, Q, m0, m_end,
                                k);
  }
  __syncthreads();
  write_slice_lists<BQ>(lv, li, q0, Q, k, k, slice, gridDim.y, part_v,
                        part_i);
}

template <int BQ, int STAGES>
cudaError_t launch_tiles(dim3 grid, size_t smem, cudaStream_t st,
                         const float* q, const float* c, const float* qn,
                         const int* qgid, int Q, int M, int D, int k,
                         int euclid, long long col_offset,
                         long long col_stride, int rows_per_slice,
                         float* part_v, int* part_i) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_tile_kernel<BQ, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  knn_tile_kernel<BQ, STAGES><<<grid, NT, smem, st>>>(
      q, c, qn, qgid, Q, M, D, k, euclid, col_offset, col_stride,
      rows_per_slice, part_v, part_i);
  return cudaGetLastError();
}

}  // namespace

// q f32[Q, D], c f32[M, D], both contiguous; qn (f32[Q] or null) is
// |q|^2, subtracted from each euclidean score (sub_qnorm: the full
// -|q-c|^2 that the cross-shard merge compares).  The plan (bq, stages)
// is (32, 2) or (16, 2); smem must equal knn_smem_bytes(bq, stages, k)
// and fit a block.  rows_per_slice * n_slices >= M.
// part_*: scratch [Q, n_slices, k]; out_*: [Q, k].
extern "C" int knn_topk_launch(const void* q, const void* c, const void* qn,
                               const void* qgid, int Q, int M, int D, int k,
                               int euclid, long long col_offset,
                               long long col_stride, int bq, int stages,
                               int smem, int rows_per_slice, int n_slices,
                               void* part_v, void* part_i, void* out_v,
                               void* out_i, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (smem < 0 || (size_t)smem != knn_smem_bytes(bq, stages, k) ||
      (size_t)smem > SMEM_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((Q + bq - 1) / bq, n_slices);
  const auto* qf = (const float*)q;
  const auto* cf = (const float*)c;
  const auto* qnf = (const float*)qn;
  const auto* gid = (const int*)qgid;
  auto* pv = (float*)part_v;
  auto* pi = (int*)part_i;
  cudaError_t err;
  if (bq == 32 && stages == 2) {
    err = launch_tiles<32, 2>(
        grid, smem, st, qf, cf, qnf, gid, Q, M, D, k, euclid,
        col_offset, col_stride, rows_per_slice, pv, pi);
  } else if (bq == 16 && stages == 2) {
    err = launch_tiles<16, 2>(
        grid, smem, st, qf, cf, qnf, gid, Q, M, D, k, euclid,
        col_offset, col_stride, rows_per_slice, pv, pi);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  int n2 = 64;   // merge_lists_kernel's power-of-two list
  while (n2 < k) n2 <<= 1;
  merge_lists_kernel<<<Q, 256, (size_t)n2 * 8, st>>>(
      pv, pi, n_slices, k, n2, k, (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}
