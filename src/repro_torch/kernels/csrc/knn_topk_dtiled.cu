// knn_topk_dtiled (serving stage A over D tiles): per-query top-k corpus
// rows of the euclidean score, the q.c contraction summed per D tile of
// width bd and across tiles in tile order, for an int8 corpus with
// per-row power-of-two scales or an fp32 one, without writing the
// [Q, M] score matrix to device memory.
//
// Replaces the TPU kernel repro/kernels/knn_topk.py :: knn_topk_dtiled,
// whose third (innermost) grid axis walks D tiles into a running
// [bq, bm] accumulator so that VMEM holds O(bq*bd + bm*bd), flat in D.
//
// Score of query q and row c (one rounding after exact products, the
// expression tree of the plain version ref.dtiled_topk_ref):
//     2*(s_q*s_c)*acc - (s_c*s_c)*|c|^2   [ - (s_q*s_q)*|q|^2 ]
// with acc and |c|^2 each summed per D tile and across tiles in tile
// order, tile 0 first; the scales are 1 for an fp32 corpus.  In int8
// mode each tile's partial is an exact int32 (|partial| <= bd*127^2 <
// 2^24 for bd <= 1024, so its f32 convert is exact too), and every scale
// product is an exponent shift: values and ids equal the plain
// version's bit for bit.  In fp32 mode a tile's partial is one fmaf
// chain over its d in order (allclose).
//
// Bound: bytes in int8 mode (the corpus once: 167 MB at M=13,949,
// D=11,997 against 2*Q*M*D int8 operations on 1,979 TOP/s), operations
// in fp32 mode (2*Q*M*D on CUDA cores, no tensor cores, so fp32 keeps
// parity).  The input alone picks one of three mainloops
// (knn_topk.py::dtiled_design):
//   * fp32: stage A's mainloop (knn_ring.cuh, as knn_topk.cu runs it;
//     dtiled_ring_kernel below): 32 queries a block (16 where the lists of
//     a large k leave no room), so each query tile reads the corpus once
//     through L2; score tiles of 256 rows; D in chunks of 32 values
//     through a 2-stage ring filled by 4-byte cp.async (no staging
//     registers); an 8 x 4 fmaf register tile per thread and |c|^2
//     rotated over the query groups.  Chunks are cut per D tile
//     (ceil(bd/32) a tile, the values past its end zero-filled, none
//     past D), so any bd works;
//   * int8 rows at a 16-byte pitch with bd % 16 == 0 (the store's int8
//     cache keeps such a pitch behind a [:, :I] view; the wrapper pads
//     any other int8 corpus into such a copy): the tensor cores,
//     mma.sync m16n8k32 s8 with exact int32 tile partials, fed by a
//     cp.async ring (dtiled_mma_kernel below).  A block holds 32 queries
//     (16 for k > 512, whose lists fill shared memory), so the corpus is
//     read once per query tile, through L2;
//   * other int8 (bd no multiple of 16): the CUDA cores
//     (dtiled_tile_kernel below): 16 queries and score tiles of 512 rows
//     per block, an 8-query x 4-row register tile per thread, D staged
//     through shared memory in chunks of 16 words of 4 int8 (each
//     assembled from byte loads), double-buffered, multiplied with
//     __dp4a; |c|^2 is summed in the same loop by the threads of the
//     first query group.  Elements past the D tile's end load 0, so any
//     bd works and pad bytes are unread.
// In all three, at each D tile's end the partials are added to the f32
// accumulators held in registers (in tile order, round to nearest) and
// reset; the scores are masked (rows past the slice, the self column
// whose gid row*col_stride + col_offset equals the query gid) and folded
// into per-query top lists in shared memory (topk_common.cuh); a second
// kernel merges the slices.  Ordering is (value desc, index asc), as
// lax.top_k.
//
// The grid (knn_topk.py::plan_dtiled) is (query tiles, corpus slices)
// with about one block per SM.  Where that leaves SMs idle (at the
// million-item point, Q=32 x M=256, it fills 1 to 4 of 132), the D tiles
// are split into contiguous ranges over more blocks, which write each
// tile's partial (the exact int32 as f32, or the tile's fmaf chain) to
// scratch; dtiled_finish_kernel then sums each (query, row) over the
// tiles in tile order -- the running sum the TPU grid carried from one
// step to the next -- and scores and selects as above, so the split
// changes no bit of the result.
#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_ring.cuh"
#include "topk_common.cuh"

namespace {

using namespace knn_ring;   // NT, NWARP, TM and the fp32 mainloop

constexpr size_t SMEM_MAX = 232448;      // shared memory a block may use

// The score of one (query, row) pair from its summed q.c and |c|^2.
__device__ __forceinline__ float dtiled_score(float acc, float cn, float sq,
                                              float sc, const float* qn,
                                              float q_term) {
  float s = __fsub_rn(__fmul_rn(__fmul_rn(2.0f, __fmul_rn(sq, sc)), acc),
                      __fmul_rn(__fmul_rn(sc, sc), cn));
  if (qn != nullptr) s = __fsub_rn(s, q_term);
  return s;
}

// The D tiles [t0, t1) of split z of n_splits: contiguous, in order.
__device__ __forceinline__ void split_range(int n_tiles, int z, int n_splits,
                                            int& t0, int& t1) {
  t0 = (int)((long long)n_tiles * z / n_splits);
  t1 = (int)((long long)n_tiles * (z + 1) / n_splits);
}

// ---------------------------------------------------------------------------
// The fp32 design.  A block holds BQ queries against its slice's score
// tiles of BM rows and walks, per score tile, the chunks of its D tiles
// through the ring: one fmaf chain per (query, row) and per row's |c|^2 a
// D tile (part, npart), added at the tile's last chunk to running sums
// held in registers (acc, nacc) in tile order -- or, in a split's first
// pass, written to the second pass's scratch.  The scores, |c|^2 and the
// merge's scratch lie over the ring; the lists of k entries follow it.
constexpr int RING_STAGES = 2;   // a third ran slower in knn_topk.cu

// The dynamic shared memory of one block: the ring of RING_STAGES chunks
// of (BM rows + bq queries) x PITCH floats, then bq lists of ls (value,
// row) entries (ls = k; 0 in a split's first pass, which keeps no
// lists).  knn_topk.py::ring_smem_bytes mirrors it for the plan's bq.
size_t ring_smem_bytes(int bq, int ls) {
  return sizeof(float) * RING_STAGES * (size_t)(BM + bq) * PITCH +
         (sizeof(float) + sizeof(int)) * (size_t)bq * ls;
}

// kSplit: the block owns D tiles split_range(blockIdx.z) of its (query
// tile, slice) and writes each tile's partials to split_acc[tile][Q][M],
// and query tile 0 its |c|^2 partials to split_cn[tile][M];
// dtiled_finish_kernel scores and selects.
template <int BQ, bool kSplit>
__global__ void __launch_bounds__(NT, 1) dtiled_ring_kernel(
    const float* __restrict__ q, const float* __restrict__ c,
    const float* __restrict__ qn, const int* __restrict__ qgid, int Q,
    int M, int D, int ld, int k, int bd, long long col_offset,
    long long col_stride, int rows_per_slice, float* __restrict__ part_v,
    int* __restrict__ part_i, float* __restrict__ split_acc,
    float* __restrict__ split_cn) {
  constexpr int TQ = BQ / QGROUPS;                  // queries per thread
  constexpr int STAGE = (BM + BQ) * PITCH;          // floats per stage
  static_assert(BQ % NWARP == 0, "whole query rows per warp");
  static_assert(BQ * BM + BM + 2 * NWARP * MERGE_CAND <= RING_STAGES * STAGE,
                "scores, |c|^2 and the merge's scratch fit the ring");
  extern __shared__ float4 ring_smem[];
  float* ring = reinterpret_cast<float*>(ring_smem);  // [STAGES][BM+BQ][..]
  float* lv = ring + RING_STAGES * STAGE;           // [BQ][k] list vals
  int* li = reinterpret_cast<int*>(lv + BQ * k);    // [BQ][k] list rows
  float* sv = ring;                      // [BQ][BM] scores, over the ring
  float* cn = sv + BQ * BM;              // [BM] |c|^2, over the ring
  float* wv = cn + BM;                   // [NWARP][MERGE_CAND] merge
  int* wi = reinterpret_cast<int*>(wv + NWARP * MERGE_CAND);   // scratch

  const int q0 = blockIdx.x * BQ;
  const int slice = blockIdx.y;
  const int m_begin = slice * rows_per_slice;
  const int m_end = min(M, m_begin + rows_per_slice);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int tq = warp % QGROUPS;
  const int h = warp / QGROUPS;
  // the block's D tiles [t0, t1) in chunks: per_tile a tile, but the last
  // tile of D stops at D
  const int per_tile = (bd + BD - 1) / BD;
  const int n_tiles = (D + bd - 1) / bd;
  int t0 = 0, t1 = n_tiles;
  if (kSplit) split_range(n_tiles, blockIdx.z, gridDim.z, t0, t1);
  const int n_chunks = (t1 - 1 - t0) * per_tile +
                       (min(t1 * bd, D) - (t1 - 1) * bd + BD - 1) / BD;
  int row[TM];
#pragma unroll
  for (int j = 0; j < TM; ++j) row[j] = tile_row(h, lane, tq, j);

  if (!kSplit) {
    for (int t = tid; t < BQ * k; t += NT) {
      lv[t] = -INFINITY;
      li[t] = PAD_IDX;
    }
  }

  for (int mt = m_begin; mt < m_end; mt += BM) {
    // a warp whose rows all lie past the slice skips the products
    const bool warp_live = mt + h * HALF < m_end;
    float part[TQ][TM];   // the current D tile's fmaf chains
    float acc[TQ][TM];    // the tiles' sum, in tile order
    float npart = 0.0f;   // the same two for |c|^2 of row[0]
    float nacc = 0.0f;
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        part[i][j] = 0.0f;
        acc[i][j] = 0.0f;
      }

    // chunks are issued in order: the next one starts at value it_off of
    // D tile it_t
    int it_t = t0, it_off = 0;
    auto issue = [&](int ch) {
      issue_chunk<BQ>(ring + (ch % RING_STAGES) * STAGE, q, c, ld, Q, q0,
                      mt, m_end, it_t * bd + it_off,
                      min(it_t * bd + bd, D), warp, lane);
      it_off += BD;
      if (it_off >= bd) {
        it_off = 0;
        ++it_t;
      }
    };

    __syncthreads();   // the previous tile's scores and merge are done
                       // with the ring
    issue(0);
    cp_async_commit();
    int t = t0;           // the D tile of chunk ch
    int left = per_tile;  // its chunks from ch on
    for (int ch = 0; ch < n_chunks; ++ch) {
      cp_async_wait<0>();   // chunk ch has landed
      __syncthreads();      // ... for every thread, and chunk ch - 1's
                            // stage is free
      if (ch + 1 < n_chunks) issue(ch + 1);
      cp_async_commit();
      if (warp_live) {
        const float* st = ring + (ch % RING_STAGES) * STAGE;
        mul_chunk<TQ>(st, st + (BM + tq * TQ) * PITCH, row, part, npart);
      }
      if (--left == 0 || ch + 1 == n_chunks) {
        // a D tile's last chunk: its partials go to the sums in tile
        // order (or, split, to the second pass), then reset
        if (kSplit) {
          if (blockIdx.x == 0 && mt + row[0] < m_end) {
            split_cn[(size_t)t * M + mt + row[0]] = npart;
          }
        } else {
          nacc = __fadd_rn(nacc, npart);
        }
        npart = 0.0f;
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) {
            if (kSplit) {
              const int gq = q0 + tq * TQ + i;
              const int m = mt + row[j];
              if (gq < Q && m < m_end) {
                split_acc[((size_t)t * Q + gq) * M + m] = part[i][j];
              }
            } else {
              acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
            }
            part[i][j] = 0.0f;
          }
        ++t;
        left = per_tile;
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp is done with the ring (sv lies on it)
    if (kSplit) continue;

    cn[row[0]] = nacc;
    __syncthreads();
    // scores, masked
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int qi = tq * TQ + i;
      const int gq = q0 + qi;
      const bool q_ok = gq < Q;
      const long long my_gid = q_ok ? (long long)qgid[gq] : -1LL;
      const float q_term = (q_ok && qn != nullptr) ? qn[gq] : 0.0f;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int m = mt + row[j];
        float s = -INFINITY;
        if (m < m_end && (long long)m * col_stride + col_offset != my_gid) {
          s = dtiled_score(acc[i][j], cn[row[j]], 1.0f, 1.0f, qn, q_term);
        }
        sv[qi * BM + row[j]] = s;
      }
    }
    __syncthreads();
    merge_score_tile_ranked<BQ, BM, NWARP>(sv, lv, li, wv, wi, q0, Q, mt,
                                           m_end, k, k);
  }
  if (kSplit) return;
  __syncthreads();
  write_slice_lists<BQ>(lv, li, q0, Q, k, k, slice, gridDim.y, part_v,
                        part_i);
}

// ---------------------------------------------------------------------------
// The CUDA-core design: int8 rows with bd no multiple of 16.
constexpr int CC_BQ = 16;                // queries per block
constexpr int CC_TQ = 8;                 // queries per thread
constexpr int ROW_THREADS = NT / (CC_BQ / CC_TQ);   // threads across rows
constexpr int CC_BM = ROW_THREADS * TM;  // 512 corpus rows per score tile
constexpr int BW = 16;                   // 4-byte words per staged chunk
constexpr int PER = 4;                   // int8 per word
constexpr int CS_STRIDE = CC_BM + 4;     // padded: 2-way bank conflicts
constexpr int QS_STRIDE = CC_BQ + 4;     // on the transposing stores
constexpr int CS_WORDS = BW * CS_STRIDE;
constexpr int QS_WORDS = BW * QS_STRIDE;
constexpr int STAGE_WORDS = 2 * (CS_WORDS + QS_WORDS);
constexpr int C_LOADS = CC_BM * BW / NT;   // corpus words per thread/chunk
static_assert(CC_BQ * BW == NT, "one query word per thread per chunk");
static_assert(CC_BQ * CC_BM <= STAGE_WORDS, "score tile fits the staging");
static_assert(ROW_THREADS % 32 == 0, "a warp shares its query tile");

size_t tile_smem_bytes(int n2) {
  return sizeof(uint32_t) * STAGE_WORDS +
         (sizeof(float) + sizeof(int)) *
             ((size_t)CC_BQ * n2 + NWARP * MERGE_CAND) +
         sizeof(float) * CC_BM;
}

// One staged word of row ``row`` (pitch ``ld`` bytes) at element ``e0``:
// four consecutive int8, the first in the low byte; elements at or past
// ``e_end`` read 0.
__device__ __forceinline__ uint32_t load_word(const int8_t* __restrict__ x,
                                              size_t row, int ld, int e0,
                                              int e_end) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(x) + row * ld;
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < PER; ++b) {
    if (e0 + b < e_end) w |= (uint32_t)__ldg(p + e0 + b) << (8 * b);
  }
  return w;
}

// Global loads of one chunk (words w of elements d0 + w*PER, for rows
// m0.. of the slice and queries q0..) into registers: creg[j] is word
// e % BW of row e / BW, e = tid + j*NT; qreg word tid % BW of query
// tid / BW.
__device__ __forceinline__ void load_chunk(
    const int8_t* __restrict__ q, const int8_t* __restrict__ c, int Q,
    int ld, int q0, int m0, int m_end, int d0, int d_end, int tid,
    uint32_t (&creg)[C_LOADS], uint32_t& qreg) {
#pragma unroll
  for (int j = 0; j < C_LOADS; ++j) {
    const int e = tid + j * NT;
    const int gm = m0 + e / BW;
    creg[j] = gm < m_end ? load_word(c, gm, ld, d0 + (e % BW) * PER, d_end)
                         : 0u;
  }
  const int gq = q0 + tid / BW;
  qreg = gq < Q ? load_word(q, gq, ld, d0 + (tid % BW) * PER, d_end) : 0u;
}

// Transpose the loaded chunk into staging buffer ``buf``: cs[w][row],
// qs[w][query].
__device__ __forceinline__ void store_chunk(uint32_t* cs, uint32_t* qs,
                                            int buf, int tid,
                                            const uint32_t (&creg)[C_LOADS],
                                            uint32_t qreg) {
  uint32_t* cb = cs + buf * CS_WORDS;
  uint32_t* qb = qs + buf * QS_WORDS;
#pragma unroll
  for (int j = 0; j < C_LOADS; ++j) {
    const int e = tid + j * NT;
    cb[(e % BW) * CS_STRIDE + e / BW] = creg[j];
  }
  qb[(tid % BW) * QS_STRIDE + tid / BW] = qreg;
}

// kSplit: the block owns D tiles split_range(blockIdx.z) of its (query
// tile, slice) and writes each tile's partials (as exact f32) to
// split_acc[tile][Q][M], and query tile 0 its |c|^2 partials to
// split_cn[tile][M]; dtiled_finish_kernel scores and selects.
template <bool kSplit>
__global__ void __launch_bounds__(NT, 1) dtiled_tile_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ c,
    const float* __restrict__ qn, const float* __restrict__ q_scale,
    const float* __restrict__ c_scale, const int* __restrict__ qgid, int Q,
    int M, int D, int ld, int k, int n2, int bd, long long col_offset,
    long long col_stride, int rows_per_slice, float* __restrict__ part_v,
    int* __restrict__ part_i, float* __restrict__ split_acc,
    float* __restrict__ split_cn) {
  extern __shared__ float4 dtiled_smem[];
  uint32_t* cs = reinterpret_cast<uint32_t*>(dtiled_smem);  // [2][BW][..]
  uint32_t* qs = cs + 2 * CS_WORDS;                         // [2][BW][..]
  float* sv = reinterpret_cast<float*>(cs);   // [BQ][BM] over the staging
  float* lv = reinterpret_cast<float*>(cs + STAGE_WORDS);   // [BQ][n2]
  int* li = reinterpret_cast<int*>(lv + CC_BQ * n2);        // [BQ][n2]
  float* wv = reinterpret_cast<float*>(li + CC_BQ * n2);    // merge scratch
  int* wi = reinterpret_cast<int*>(wv + NWARP * MERGE_CAND);
  float* cn = reinterpret_cast<float*>(wi + NWARP * MERGE_CAND);  // [BM]

  const int q0 = blockIdx.x * CC_BQ;
  const int slice = blockIdx.y;
  const int S = gridDim.y;
  const int m_begin = slice * rows_per_slice;
  const int m_end = min(M, m_begin + rows_per_slice);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int tq = tid / ROW_THREADS;   // queries tq*TQ .. tq*TQ+TQ-1
  const int tm = tid % ROW_THREADS;   // rows tm*TM .. tm*TM+TM-1 of a tile
  // chunks of one D tile, and in all: chunk ch lies in tile ch / per_tile
  const int per_tile = (bd + BW * PER - 1) / (BW * PER);
  const int n_tiles = (D + bd - 1) / bd;
  int t0 = 0, t1 = n_tiles;
  if (kSplit) split_range(n_tiles, blockIdx.z, gridDim.z, t0, t1);
  const int c_begin = t0 * per_tile, c_end = t1 * per_tile;

  if (!kSplit) {
    for (int t = tid; t < CC_BQ * n2; t += NT) {
      lv[t] = -INFINITY;
      li[t] = PAD_IDX;
    }
  }

  for (int m0 = m_begin; m0 < m_end; m0 += CC_BM) {
    // warps whose rows all lie past the slice skip the multiply
    const bool warp_live = m0 + (tm - lane) * TM < m_end;
    uint32_t creg[C_LOADS];
    uint32_t qreg;
    int part[CC_TQ][TM];
    float acc[CC_TQ][TM];
    int npart[TM];      // |c|^2 of this thread's rows (first query group)
    float nacc[TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      npart[j] = 0;
      nacc[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < CC_TQ; ++i) {
        part[i][j] = 0;
        acc[i][j] = 0.0f;
      }
    }

    __syncthreads();   // the previous tile's merge is done with sv and cn
    load_chunk(q, c, Q, ld, q0, m0, m_end, t0 * bd, min(t0 * bd + bd, D),
               tid, creg, qreg);
    store_chunk(cs, qs, 0, tid, creg, qreg);
    __syncthreads();
    for (int ch = c_begin; ch < c_end; ++ch) {
      const int buf = (ch - c_begin) & 1;
      const bool more = ch + 1 < c_end;
      if (more) {
        const int t = (ch + 1) / per_tile;
        const int d0 = t * bd + ((ch + 1) % per_tile) * BW * PER;
        load_chunk(q, c, Q, ld, q0, m0, m_end, d0, min(t * bd + bd, D), tid,
                   creg, qreg);
      }
      if (warp_live) {
        const uint32_t* cb = cs + buf * CS_WORDS + tm * TM;
        const uint32_t* qb = qs + buf * QS_WORDS + tq * CC_TQ;
#pragma unroll
        for (int w = 0; w < BW; ++w) {
          const uint4 a0 =
              *reinterpret_cast<const uint4*>(qb + w * QS_STRIDE);
          const uint4 a1 =
              *reinterpret_cast<const uint4*>(qb + w * QS_STRIDE + 4);
          const uint4 b =
              *reinterpret_cast<const uint4*>(cb + w * CS_STRIDE);
          const uint32_t a[CC_TQ] = {a0.x, a0.y, a0.z, a0.w,
                                     a1.x, a1.y, a1.z, a1.w};
          const uint32_t bb[TM] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < CC_TQ; ++i)
#pragma unroll
            for (int j = 0; j < TM; ++j) {
              part[i][j] = __dp4a((int)a[i], (int)bb[j], part[i][j]);
            }
          if (tq == 0) {                    // warp-uniform
#pragma unroll
            for (int j = 0; j < TM; ++j) {
              npart[j] = __dp4a((int)bb[j], (int)bb[j], npart[j]);
            }
          }
        }
      }
      if (kSplit && (ch + 1) % per_tile == 0) {
        // end of a D tile: write its partials for the second pass
        const int t = ch / per_tile;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const int m = m0 + tm * TM + j;
          if (m < m_end) {
            if (tq == 0 && blockIdx.x == 0) {
              split_cn[(size_t)t * M + m] = (float)npart[j];
            }
#pragma unroll
            for (int i = 0; i < CC_TQ; ++i) {
              const int gq = q0 + tq * CC_TQ + i;
              if (gq < Q) {
                split_acc[((size_t)t * Q + gq) * M + m] = (float)part[i][j];
              }
            }
          }
          npart[j] = 0;
#pragma unroll
          for (int i = 0; i < CC_TQ; ++i) part[i][j] = 0;
        }
      } else if ((ch + 1) % per_tile == 0) {
        // end of a D tile: add its partials to the accumulators, in order
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          nacc[j] = __fadd_rn(nacc[j], (float)npart[j]);
          npart[j] = 0;
#pragma unroll
          for (int i = 0; i < CC_TQ; ++i) {
            acc[i][j] = __fadd_rn(acc[i][j], (float)part[i][j]);
            part[i][j] = 0;
          }
        }
      }
      if (more) store_chunk(cs, qs, buf ^ 1, tid, creg, qreg);
      __syncthreads();
    }
    if (kSplit) continue;
    if (tq == 0) {
#pragma unroll
      for (int j = 0; j < TM; ++j) cn[tm * TM + j] = nacc[j];
    }
    __syncthreads();

    // scores, masked, over the staging buffers (free after the last sync)
#pragma unroll
    for (int i = 0; i < CC_TQ; ++i) {
      const int gq = q0 + tq * CC_TQ + i;
      const bool q_ok = gq < Q;
      const long long my_gid = q_ok ? (long long)qgid[gq] : -1LL;
      const float sq = q_ok ? q_scale[gq] : 1.0f;
      const float q_term = (q_ok && qn != nullptr)
                               ? __fmul_rn(__fmul_rn(sq, sq), qn[gq])
                               : 0.0f;
      float s[TM];
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int m = m0 + tm * TM + j;
        s[j] = -INFINITY;
        if (m < m_end && (long long)m * col_stride + col_offset != my_gid) {
          s[j] = dtiled_score(acc[i][j], cn[tm * TM + j], sq, c_scale[m], qn,
                              q_term);
        }
      }
      *reinterpret_cast<float4*>(sv + (tq * CC_TQ + i) * CC_BM + tm * TM) =
          make_float4(s[0], s[1], s[2], s[3]);
    }
    __syncthreads();

    merge_score_tile_ranked<CC_BQ, CC_BM, NWARP>(sv, lv, li, wv, wi, q0, Q,
                                                 m0, m_end, k, n2);
  }
  if (kSplit) return;
  __syncthreads();
  write_slice_lists<CC_BQ>(lv, li, q0, Q, k, n2, slice, S, part_v, part_i);
}

// Second pass of a D split: block (query tile, slice) sums each (query,
// row) partial over all D tiles in tile order, tile 0 first (as the
// unsplit kernels and the plain version do), and |c|^2 likewise, forms
// the masked scores and folds them into its per-query lists, as the
// unsplit kernels' epilogue does.  The sums are sequential in the tiles,
// so a thread keeps FIN_U tiles' loads in flight per batch.
constexpr int FIN_BQ = 16;   // queries per block
constexpr int FIN_BM = 128;  // rows per score tile
constexpr int FIN_U = 32;    // tiles a thread loads at once

size_t finish_smem_bytes(int n2) {
  return sizeof(float) * (FIN_BQ * FIN_BM + FIN_BM) +
         (sizeof(float) + sizeof(int)) *
             ((size_t)FIN_BQ * n2 + NWARP * MERGE_CAND);
}

// acc + p[t * stride] over U tiles t0.. in order, the U loads first
template <int U>
__device__ __forceinline__ float sum_batch(float acc,
                                           const float* __restrict__ p,
                                           size_t stride, int t0) {
  float v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) v[u] = __ldg(p + (size_t)(t0 + u) * stride);
#pragma unroll
  for (int u = 0; u < U; ++u) acc = __fadd_rn(acc, v[u]);
  return acc;
}

// sum over t of p[t * stride], t = 0 .. n_tiles-1 in order, from 0.0f
__device__ __forceinline__ float sum_tiles(const float* __restrict__ p,
                                           size_t stride, int n_tiles) {
  float acc = 0.0f;
  int t = 0;
  for (; t + FIN_U <= n_tiles; t += FIN_U) {
    acc = sum_batch<FIN_U>(acc, p, stride, t);
  }
  for (; t + 4 <= n_tiles; t += 4) acc = sum_batch<4>(acc, p, stride, t);
  for (; t < n_tiles; ++t) acc = __fadd_rn(acc, __ldg(p + (size_t)t * stride));
  return acc;
}

__global__ void __launch_bounds__(NT, 1) dtiled_finish_kernel(
    const float* __restrict__ split_acc, const float* __restrict__ split_cn,
    int n_tiles, const float* __restrict__ qn,
    const float* __restrict__ q_scale, const float* __restrict__ c_scale,
    const int* __restrict__ qgid, int Q, int M, int k, int n2,
    long long col_offset, long long col_stride, int rows_per_slice,
    float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ float4 finish_smem[];
  float* sv = reinterpret_cast<float*>(finish_smem);   // [FIN_BQ][FIN_BM]
  float* cn = sv + FIN_BQ * FIN_BM;                    // [FIN_BM]
  float* lv = cn + FIN_BM;                             // [FIN_BQ][n2]
  int* li = reinterpret_cast<int*>(lv + FIN_BQ * n2);
  float* wv = reinterpret_cast<float*>(li + FIN_BQ * n2);
  int* wi = reinterpret_cast<int*>(wv + NWARP * MERGE_CAND);
  const int q0 = blockIdx.x * FIN_BQ;
  const int m_begin = blockIdx.y * rows_per_slice;
  const int m_end = min(M, m_begin + rows_per_slice);
  const int tid = threadIdx.x;
  for (int t = tid; t < FIN_BQ * n2; t += NT) {
    lv[t] = -INFINITY;
    li[t] = PAD_IDX;
  }
  for (int m0 = m_begin; m0 < m_end; m0 += FIN_BM) {
    const int R = min(FIN_BM, m_end - m0);   // rows of this score tile
    __syncthreads();   // the previous tile's merge is done with sv and cn
    // items p: the pairs (query p / R, row p % R), then the R rows' |c|^2
    for (int p = tid; p < (FIN_BQ + 1) * R; p += NT) {
      const int qi = p / R, ml = p % R;
      if (qi == FIN_BQ) {
        cn[ml] = sum_tiles(split_cn + m0 + ml, (size_t)M, n_tiles);
      } else if (q0 + qi < Q) {
        sv[qi * FIN_BM + ml] = sum_tiles(
            split_acc + (size_t)(q0 + qi) * M + m0 + ml, (size_t)Q * M,
            n_tiles);
      }
    }
    __syncthreads();
    for (int p = tid; p < FIN_BQ * FIN_BM; p += NT) {
      const int ml = p % FIN_BM;
      const int gq = q0 + p / FIN_BM;
      const int m = m0 + ml;
      float s = -INFINITY;
      if (gq < Q && ml < R &&
          (long long)m * col_stride + col_offset != (long long)qgid[gq]) {
        const float sq = q_scale != nullptr ? q_scale[gq] : 1.0f;
        const float q_term =
            qn != nullptr ? __fmul_rn(__fmul_rn(sq, sq), qn[gq]) : 0.0f;
        s = dtiled_score(sv[p], cn[ml], sq,
                         c_scale != nullptr ? c_scale[m] : 1.0f, qn, q_term);
      }
      sv[p] = s;
    }
    __syncthreads();
    merge_score_tile_ranked<FIN_BQ, FIN_BM, NWARP>(sv, lv, li, wv, wi, q0,
                                                   Q, m0, m_end, k, n2);
  }
  __syncthreads();
  write_slice_lists<FIN_BQ>(lv, li, q0, Q, k, n2, blockIdx.y, gridDim.y,
                            part_v, part_i);
}

// ---------------------------------------------------------------------------
// The tensor-core design: int8 rows at a 16-byte pitch with bd % 16 == 0.
// A block of 16 warps holds BQ queries (A, row-major) against a row
// tile of TC_BM corpus rows (B, k contiguous: the row-major corpus
// itself); each warp owns all BQ queries x 16 rows, as BQ/16 x 2
// mma.sync m16n8k32 s8 tiles with int32 accumulators, and |c|^2 of its
// rows by __dp4a on the B fragments it already holds.  D is staged in
// chunks of TC_BK bytes that never straddle a D tile, through a ring of
// STAGES buffers filled by cp.async (16-byte copies; the src-size
// form zero-fills the bytes at and past the tile's end or D, which are
// never read).  Rows are padded to TC_PITCH bytes, so the 8 rows of each
// ldmatrix fall in 8 distinct bank groups.  Measured on the H100 at
// TaFeng's shape: 128-byte chunks in 2 stages beat 64-byte chunks in 4,
// 3 stages of them beat 2, and 16 warps beat 8 (the top-k merge,
// latency-bound per warp, gains most).
constexpr int TC_NT = 512;                // threads per block
constexpr int TC_NWARP = TC_NT / 32;
constexpr int TC_BM = 256;                // corpus rows per row tile
constexpr int TC_WROWS = TC_BM / TC_NWARP;   // rows per warp
constexpr int TC_NTILE = TC_WROWS / 8;   // n8 tiles per warp
constexpr int TC_BK = 128;                // bytes of D per chunk: 4 k-steps
constexpr int TC_PIECES = TC_BK / 16;     // 16-byte copies per row
constexpr int TC_PITCH = TC_BK + 16;      // 144 bytes: 9 bank groups apart

// The kernel's lists keep k entries a query (the ranked merge needs no
// power of two), at a row stride of ls = k (0 in a split's first pass).
size_t tc_smem_bytes(int bq, int stages, int ls) {
  return (size_t)stages * (TC_BM + bq) * TC_PITCH +
         (sizeof(float) + sizeof(int)) *
             ((size_t)bq * ls + TC_NWARP * MERGE_CAND) +
         sizeof(float) * TC_BM;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// d += a (16 x 32 s8, row-major) * b (32 x 8 s8, column-major), s32.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment element e (0..3) of an m16n8 accumulator tile: query row
// g + 8 * (e / 2), corpus column 2 * tig + e % 2 (g = lane / 4, tig =
// lane % 4).
template <int BQ, int STAGES, bool kSplit>
__global__ void __launch_bounds__(TC_NT, 1) dtiled_mma_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ c,
    const float* __restrict__ qn, const float* __restrict__ q_scale,
    const float* __restrict__ c_scale, const int* __restrict__ qgid, int Q,
    int M, int D, int ld, int k, int ls, int bd, long long col_offset,
    long long col_stride, int rows_per_slice, float* __restrict__ part_v,
    int* __restrict__ part_i, float* __restrict__ split_acc,
    float* __restrict__ split_cn) {
  constexpr int MT = BQ / 16;                       // m16 tiles of queries
  constexpr int STAGE = (TC_BM + BQ) * TC_PITCH;    // bytes per stage
  static_assert(BQ * TC_BM * 4 <= STAGES * STAGE, "scores fit");
  extern __shared__ float4 tc_smem[];
  uint8_t* stg = reinterpret_cast<uint8_t*>(tc_smem);
  float* sv = reinterpret_cast<float*>(stg);   // [BQ][TC_BM] over the ring
  float* lv = reinterpret_cast<float*>(stg + STAGES * STAGE);  // [BQ][ls]
  int* li = reinterpret_cast<int*>(lv + BQ * ls);             // [BQ][ls]
  float* wv = reinterpret_cast<float*>(li + BQ * ls);         // merge scratch
  int* wi = reinterpret_cast<int*>(wv + TC_NWARP * MERGE_CAND);
  float* cn = reinterpret_cast<float*>(wi + TC_NWARP * MERGE_CAND);

  const int q0 = blockIdx.x * BQ;
  const int slice = blockIdx.y;
  const int m_begin = slice * rows_per_slice;
  const int m_end = min(M, m_begin + rows_per_slice);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int per_tile = (bd + TC_BK - 1) / TC_BK;   // chunks per D tile
  const int n_tiles = (D + bd - 1) / bd;
  int t0 = 0, t1 = n_tiles;
  if (kSplit) split_range(n_tiles, blockIdx.z, gridDim.z, t0, t1);
  const int c_begin = t0 * per_tile;
  const int n_chunks = (t1 - t0) * per_tile;

  if (!kSplit) {
    for (int t = tid; t < BQ * ls; t += TC_NT) {
      lv[t] = -INFINITY;
      li[t] = PAD_IDX;
    }
  }

  for (int m0 = m_begin; m0 < m_end; m0 += TC_BM) {
    // warps whose rows all lie past the slice skip the products
    const bool warp_live = m0 + warp * TC_WROWS < m_end;
    int part[MT][TC_NTILE][4];
    float acc[MT][TC_NTILE][4];
    int npart[TC_NTILE];     // |c|^2 of row j*8 + g, this lane's bytes
    float nacc[TC_NTILE];
#pragma unroll
    for (int j = 0; j < TC_NTILE; ++j) {
      npart[j] = 0;
      nacc[j] = 0.0f;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          part[mi][j][e] = 0;
          acc[mi][j][e] = 0.0f;
        }
    }

    // bytes of chunk i (of this block's range) inside its D tile and D
    auto chunk_bytes = [&](int i, int& d0) {
      const int ch = c_begin + i;
      const int t = ch / per_tile;
      const int off = (ch % per_tile) * TC_BK;
      d0 = t * bd + off;
      return min(TC_BK, min(bd - off, D - d0));
    };
    // copy chunk i into stage i % STAGES; rows past the slice, queries
    // past Q and bytes past the valid ones are zero-filled
    auto issue = [&](int i) {
      int d0;
      const int valid = chunk_bytes(i, d0);
      uint8_t* cs = stg + (i % STAGES) * STAGE;
      uint8_t* qs = cs + TC_BM * TC_PITCH;
#pragma unroll
      for (int j = 0; j < TC_BM * TC_PIECES / TC_NT; ++j) {
        const int e = tid + j * TC_NT;
        const int r = e / TC_PIECES, p = e % TC_PIECES;
        const int gm = m0 + r;
        const int n = gm < m_end ? min(16, max(0, valid - p * 16)) : 0;
        cp_async16(cs + r * TC_PITCH + p * 16,
                   n > 0 ? c + (size_t)gm * ld + d0 + p * 16 : c, n);
      }
      for (int e = tid; e < BQ * TC_PIECES; e += TC_NT) {
        const int r = e / TC_PIECES, p = e % TC_PIECES;
        const int gq = q0 + r;
        const int n = gq < Q ? min(16, max(0, valid - p * 16)) : 0;
        cp_async16(qs + r * TC_PITCH + p * 16,
                   n > 0 ? q + (size_t)gq * ld + d0 + p * 16 : q, n);
      }
    };

    __syncthreads();   // the previous row tile's merge is done with sv, cn
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_chunks) issue(s);
      cp_async_commit();
    }
    for (int i = 0; i < n_chunks; ++i) {
      cp_async_wait<STAGES - 2>();   // chunk i has landed
      __syncthreads();                  // ... for every thread, and chunk
                                        // i - 1's stage is free
      if (i + STAGES - 1 < n_chunks) issue(i + STAGES - 1);
      cp_async_commit();
      int d0;
      const int valid = chunk_bytes(i, d0);
      if (warp_live) {
        const uint8_t* cs = stg + (i % STAGES) * STAGE;
        const uint8_t* qs = cs + TC_BM * TC_PITCH;
#pragma unroll
        for (int ks = 0; ks < TC_BK / 32; ++ks) {
          if (ks * 32 >= valid) break;   // all zeros past the tile's end
          uint32_t a[MT][4];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            ldmatrix_x4(a[mi], qs + (mi * 16 + lane % 16) * TC_PITCH +
                                   ks * 32 + (lane / 16) * 16);
          }
          uint32_t b[TC_NTILE][2];
#pragma unroll
          for (int pr = 0; pr < TC_NTILE / 2; ++pr) {
            uint32_t r[4];
            ldmatrix_x4(r, cs + (warp * TC_WROWS + pr * 16 +
                                 (lane / 16) * 8 + lane % 8) * TC_PITCH +
                               ks * 32 + ((lane / 8) % 2) * 16);
            b[2 * pr][0] = r[0];
            b[2 * pr][1] = r[1];
            b[2 * pr + 1][0] = r[2];
            b[2 * pr + 1][1] = r[3];
          }
#pragma unroll
          for (int j = 0; j < TC_NTILE; ++j) {
            npart[j] = __dp4a((int)b[j][0], (int)b[j][0], npart[j]);
            npart[j] = __dp4a((int)b[j][1], (int)b[j][1], npart[j]);
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
              mma_s8(part[mi][j], a[mi], b[j][0], b[j][1]);
            }
          }
        }
      }
      const int ch = c_begin + i;
      if ((ch + 1) % per_tile == 0) {
        // end of a D tile: its exact int32 partials go to the f32 sums
        // in tile order (or, split, to the second pass), then reset
        const int t = ch / per_tile;
#pragma unroll
        for (int j = 0; j < TC_NTILE; ++j) {
          int s = npart[j];
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          npart[j] = 0;
          const int mrow = m0 + warp * TC_WROWS + j * 8 + g;
          if (kSplit) {
            if (tig == 0 && blockIdx.x == 0 && mrow < m_end) {
              split_cn[(size_t)t * M + mrow] = (float)s;
            }
          } else {
            nacc[j] = __fadd_rn(nacc[j], (float)s);
          }
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (kSplit) {
                const int gq = q0 + mi * 16 + g + 8 * (e / 2);
                const int m = m0 + warp * TC_WROWS + j * 8 + 2 * tig + e % 2;
                if (gq < Q && m < m_end) {
                  split_acc[((size_t)t * Q + gq) * M + m] =
                      (float)part[mi][j][e];
                }
              } else {
                acc[mi][j][e] = __fadd_rn(acc[mi][j][e],
                                          (float)part[mi][j][e]);
              }
              part[mi][j][e] = 0;
            }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp is done with the ring (sv lies on it)
    if (kSplit) continue;

    if (tig == 0) {
#pragma unroll
      for (int j = 0; j < TC_NTILE; ++j) {
        cn[warp * TC_WROWS + j * 8 + g] = nacc[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = mi * 16 + g + 8 * h;
        const int gq = q0 + qi;
        const bool q_ok = gq < Q;
        const long long my_gid = q_ok ? (long long)qgid[gq] : -1LL;
        const float sq = q_ok ? q_scale[gq] : 1.0f;
        const float q_term = (q_ok && qn != nullptr)
                                 ? __fmul_rn(__fmul_rn(sq, sq), qn[gq])
                                 : 0.0f;
#pragma unroll
        for (int j = 0; j < TC_NTILE; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ml = warp * TC_WROWS + j * 8 + 2 * tig + e;
            const int m = m0 + ml;
            float s = -INFINITY;
            if (q_ok && m < m_end &&
                (long long)m * col_stride + col_offset != my_gid) {
              s = dtiled_score(acc[mi][j][2 * h + e], cn[ml], sq,
                               c_scale[m], qn, q_term);
            }
            sv[qi * TC_BM + ml] = s;
          }
      }
    __syncthreads();
    merge_score_tile_ranked<BQ, TC_BM, TC_NWARP>(sv, lv, li, wv, wi, q0, Q,
                                                 m0, m_end, k, ls);
  }
  if (kSplit) return;
  __syncthreads();
  write_slice_lists<BQ>(lv, li, q0, Q, k, ls, slice, gridDim.y, part_v,
                        part_i);
}

template <bool kSplit>
cudaError_t launch_tiles(dim3 grid, size_t smem, cudaStream_t st,
                         const void* q, const void* c, const float* qn,
                         const float* q_scale, const float* c_scale,
                         const int* qgid, int Q, int M, int D, int ld, int k,
                         int n2, int bd, long long col_offset,
                         long long col_stride, int rows_per_slice,
                         float* part_v, int* part_i, float* split_acc,
                         float* split_cn) {
  cudaError_t err = cudaFuncSetAttribute(
      dtiled_tile_kernel<kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dtiled_tile_kernel<kSplit><<<grid, NT, smem, st>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(c), qn,
      q_scale, c_scale, qgid, Q, M, D, ld, k, n2, bd, col_offset, col_stride,
      rows_per_slice, part_v, part_i, split_acc, split_cn);
  return cudaGetLastError();
}

template <int BQ, bool kSplit>
cudaError_t launch_ring(dim3 grid, size_t smem, cudaStream_t st,
                        const void* q, const void* c, const float* qn,
                        const int* qgid, int Q, int M, int D, int ld, int k,
                        int bd, long long col_offset, long long col_stride,
                        int rows_per_slice, float* part_v, int* part_i,
                        float* split_acc, float* split_cn) {
  cudaError_t err = cudaFuncSetAttribute(
      dtiled_ring_kernel<BQ, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dtiled_ring_kernel<BQ, kSplit><<<grid, NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(c), qn, qgid,
      Q, M, D, ld, k, bd, col_offset, col_stride, rows_per_slice, part_v,
      part_i, split_acc, split_cn);
  return cudaGetLastError();
}

template <int BQ, int STAGES, bool kSplit>
cudaError_t launch_mma_ring(dim3 grid, cudaStream_t st, const void* q,
                            const void* c, const float* qn,
                            const float* q_scale, const float* c_scale,
                            const int* qgid, int Q, int M, int D, int ld,
                            int k, int ls, int bd, long long col_offset,
                            long long col_stride, int rows_per_slice,
                            float* part_v, int* part_i, float* split_acc,
                            float* split_cn) {
  const size_t smem = tc_smem_bytes(BQ, STAGES, ls);
  cudaError_t err = cudaFuncSetAttribute(
      dtiled_mma_kernel<BQ, STAGES, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dtiled_mma_kernel<BQ, STAGES, kSplit><<<grid, TC_NT, smem, st>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(c), qn,
      q_scale, c_scale, qgid, Q, M, D, ld, k, ls, bd, col_offset, col_stride,
      rows_per_slice, part_v, part_i, split_acc, split_cn);
  return cudaGetLastError();
}

// The ring: 3 stages where the per-query lists leave room (k <= 386 at
// 32 queries), else 2; 5 in a split's first pass, which keeps no lists.
template <int BQ, bool kSplit>
cudaError_t launch_mma(dim3 grid, cudaStream_t st, const void* q,
                       const void* c, const float* qn, const float* q_scale,
                       const float* c_scale, const int* qgid, int Q, int M,
                       int D, int ld, int k, int bd, long long col_offset,
                       long long col_stride, int rows_per_slice,
                       float* part_v, int* part_i, float* split_acc,
                       float* split_cn) {
  if constexpr (kSplit) {
    return launch_mma_ring<BQ, 5, true>(
        grid, st, q, c, qn, q_scale, c_scale, qgid, Q, M, D, ld, k, 0, bd,
        col_offset, col_stride, rows_per_slice, part_v, part_i, split_acc,
        split_cn);
  } else {
    if (tc_smem_bytes(BQ, 3, k) <= SMEM_MAX) {
      return launch_mma_ring<BQ, 3, false>(
          grid, st, q, c, qn, q_scale, c_scale, qgid, Q, M, D, ld, k, k, bd,
          col_offset, col_stride, rows_per_slice, part_v, part_i, split_acc,
          split_cn);
    }
    return launch_mma_ring<BQ, 2, false>(
        grid, st, q, c, qn, q_scale, c_scale, qgid, Q, M, D, ld, k, k, bd,
        col_offset, col_stride, rows_per_slice, part_v, part_i, split_acc,
        split_cn);
  }
}

// The first pass of the design the input takes: fp32 the ring design
// (BQ = bq, 32 or 16); int8 the tensor cores for rows at a 16-byte pitch
// with bd % 16 == 0 (vec), BQ = bq, else the CUDA cores (BQ = 16).  Each
// sizes its own shared memory.
template <bool kSplit>
cudaError_t launch_design(int int8, int vec, int bq, dim3 grid,
                          int n2, cudaStream_t st, const void* q,
                          const void* c, const float* qn,
                          const float* q_scale, const float* c_scale,
                          const int* qgid, int Q, int M, int D, int ld, int k,
                          int bd, long long col_offset, long long col_stride,
                          int rows_per_slice, float* part_v, int* part_i,
                          float* split_acc, float* split_cn) {
  if (!int8) {
    // a split's first pass keeps no lists
    const size_t smem = ring_smem_bytes(bq, kSplit ? 0 : k);
    if (vec || smem > SMEM_MAX) return cudaErrorInvalidValue;
    if (bq == 32) {
      return launch_ring<32, kSplit>(grid, smem, st, q, c, qn, qgid, Q, M, D,
                                     ld, k, bd, col_offset, col_stride,
                                     rows_per_slice, part_v, part_i,
                                     split_acc, split_cn);
    }
    if (bq == 16) {
      return launch_ring<16, kSplit>(grid, smem, st, q, c, qn, qgid, Q, M, D,
                                     ld, k, bd, col_offset, col_stride,
                                     rows_per_slice, part_v, part_i,
                                     split_acc, split_cn);
    }
    return cudaErrorInvalidValue;
  }
  if (vec && bq == 32) {
    return launch_mma<32, kSplit>(grid, st, q, c, qn, q_scale, c_scale, qgid,
                                  Q, M, D, ld, k, bd, col_offset, col_stride,
                                  rows_per_slice, part_v, part_i, split_acc,
                                  split_cn);
  }
  if (vec && bq == 16) {
    return launch_mma<16, kSplit>(grid, st, q, c, qn, q_scale, c_scale, qgid,
                                  Q, M, D, ld, k, bd, col_offset, col_stride,
                                  rows_per_slice, part_v, part_i, split_acc,
                                  split_cn);
  }
  if (vec || bq != CC_BQ) return cudaErrorInvalidValue;
  const int lists_n2 = kSplit ? 0 : n2;   // a split pass keeps no lists
  return launch_tiles<kSplit>(
      grid, tile_smem_bytes(lists_n2), st, q, c, qn, q_scale, c_scale, qgid,
      Q, M, D, ld, k, lists_n2, bd, col_offset, col_stride, rows_per_slice,
      part_v, part_i, split_acc, split_cn);
}

}  // namespace

// q: [Q, *] and c: [M, *], rows of D elements at a pitch of ld elements
// (ld >= D), both int8 (int8 != 0; q_scale f32[Q] and c_scale f32[M]) or
// both f32 (scales null).  f32 takes the ring design: bq (queries per
// block) 32 or 16, its shared memory within SMEM_MAX.  int8: vec != 0
// takes the tensor-core design: ld, bd and the row addresses multiples
// of 16, and bq 32 with n2 <= 512, or 16; the CUDA cores take bq = 16.
// qn: f32[Q] |q|^2 summed in the same D tiles (ref.tiled_sqnorm_ref), or
// null unless sub_qnorm.  1 <= bd (<= 1024 in int8 mode).  The grid is
// (ceil(Q / bq), n_slices, n_splits) with rows_per_slice * n_slices >=
// M.  n_splits > 1 splits the D tiles across blocks: split_acc f32
// [ceil(D / bd), Q, M] and split_cn f32[ceil(D / bd), M] take the
// partials, and the second pass runs over (ceil(Q / 16), fin_slices)
// blocks of fin_rows rows.  part_*: scratch [Q, lists, k], lists =
// n_slices unsplit, fin_slices split; out_*: [Q, k]; n2 a power of two
// in [max(k, 64), 1024].
extern "C" int knn_topk_dtiled_launch(
    const void* q, const void* c, const void* qn, const void* q_scale,
    const void* c_scale, const void* qgid, int Q, int M, int D, int ld,
    int k, int n2, int bd, int int8, int vec, long long col_offset,
    long long col_stride, int bq, int rows_per_slice,
    int n_slices, int n_splits, void* split_acc, void* split_cn,
    int fin_rows, int fin_slices, void* part_v, void* part_i, void* out_v,
    void* out_i, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_splits < 1) return (int)cudaErrorInvalidValue;
  const auto* qn_f = (const float*)qn;
  const auto* qs_f = (const float*)q_scale;
  const auto* cs_f = (const float*)c_scale;
  const auto* qgid_i = (const int*)qgid;
  const dim3 grid((Q + bq - 1) / bq, n_slices, n_splits);
  int lists = n_slices;
  cudaError_t err;
  if (n_splits == 1) {
    err = launch_design<false>(int8, vec, bq, grid, n2, st, q, c, qn_f,
                               qs_f, cs_f, qgid_i, Q, M, D, ld, k, bd,
                               col_offset, col_stride, rows_per_slice,
                               (float*)part_v, (int*)part_i, nullptr,
                               nullptr);
  } else {
    err = launch_design<true>(int8, vec, bq, grid, n2, st, q, c, qn_f,
                              qs_f, cs_f, qgid_i, Q, M, D, ld, k, bd,
                              col_offset, col_stride, rows_per_slice,
                              nullptr, nullptr, (float*)split_acc,
                              (float*)split_cn);
    if (err != cudaSuccess) return (int)err;
    const size_t fsmem = finish_smem_bytes(n2);
    err = cudaFuncSetAttribute(dtiled_finish_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)fsmem);
    if (err != cudaSuccess) return (int)err;
    dtiled_finish_kernel<<<dim3((Q + FIN_BQ - 1) / FIN_BQ, fin_slices), NT,
                           fsmem, st>>>(
        (const float*)split_acc, (const float*)split_cn, (D + bd - 1) / bd,
        qn_f, qs_f, cs_f, qgid_i, Q, M, k, n2, col_offset, col_stride,
        fin_rows, (float*)part_v, (int*)part_i);
    err = cudaGetLastError();
    lists = fin_slices;
  }
  if (err != cudaSuccess) return (int)err;
  merge_lists_kernel<<<Q, 256, (size_t)n2 * 8, st>>>(
      (const float*)part_v, (const int*)part_i, lists, k, n2, k,
      (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}
