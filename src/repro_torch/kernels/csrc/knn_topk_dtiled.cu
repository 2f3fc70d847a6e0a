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
// parity).  The design is stage A's (knn_topk.cu):
//   * corpus slices across blocks (the wrapper plans about one block per
//     SM), BQ=16 queries x one slice per block, score tiles of BM=512
//     rows, an 8-query x 4-row register tile per thread;
//   * D staged through shared memory in chunks of 16 four-byte words
//     (16 floats, or 64 int8 packed four to a word), double-buffered,
//     and multiplied with fmaf or __dp4a.  int8 rows are read as 16-byte
//     vectors when the rows have a 16-byte pitch and bd is a multiple of
//     16: the store's int8 cache keeps such a pitch behind a [:, :I]
//     view, and the wrapper pads any other int8 corpus (an I=11,997
//     one's rows do not start 4-byte aligned) into such a copy;
//     otherwise each word is assembled from byte loads.  Elements past
//     the D tile's end load 0, so any bd works and pad bytes are unread;
//   * |c|^2 is summed in the same loop from the staged words (by the
//     threads of the first query group), per D tile as acc is;
//   * at each D tile's end the partials are added to the f32
//     accumulators (in tile order, round to nearest) and reset;
//   * scores are masked (rows past the slice, the self column whose gid
//     row*col_stride + col_offset equals the query gid) and folded into
//     per-query top-n2 lists (topk_common.cuh); a second kernel merges
//     the slices.  Ordering is (value desc, index asc), as lax.top_k.
// The million-item point (M=256, Q=32) gives this plan only 4 blocks;
// splitting D across blocks while keeping the tile order is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "topk_common.cuh"

namespace {

constexpr int NT = 256;                  // threads per block
constexpr int NWARP = NT / 32;
constexpr int BQ = 16;                   // queries per block
constexpr int TQ = 8;                    // queries per thread
constexpr int TM = 4;                    // corpus rows per thread
constexpr int ROW_THREADS = NT / (BQ / TQ);   // threads across the rows
constexpr int BM = ROW_THREADS * TM;     // 512 corpus rows per score tile
constexpr int BW = 16;                   // 4-byte words per staged chunk
constexpr int CS_STRIDE = BM + 4;        // padded: 2-way bank conflicts
constexpr int QS_STRIDE = BQ + 4;        // on the transposing stores
constexpr int CS_WORDS = BW * CS_STRIDE;
constexpr int QS_WORDS = BW * QS_STRIDE;
constexpr int STAGE_WORDS = 2 * (CS_WORDS + QS_WORDS);
constexpr int C_LOADS = BM * BW / NT;    // corpus words per thread/chunk
constexpr int QUADS = BW / 4;            // 16-byte vectors per row/chunk
static_assert(BQ * BW == NT, "one query word per thread per chunk");
static_assert(BQ * BM <= STAGE_WORDS, "score tile fits over the staging");
static_assert(ROW_THREADS % 32 == 0, "a warp shares its query tile");

size_t tile_smem_bytes(int n2) {
  return sizeof(uint32_t) * STAGE_WORDS +
         (sizeof(float) + sizeof(int)) *
             ((size_t)BQ * n2 + NWARP * MERGE_CAND) +
         sizeof(float) * BM;
}

// Zero the bytes of the 16-byte vector at element e0 that lie at or past
// e_end.
__device__ __forceinline__ uint4 mask_vec(uint4 v, int e0, int e_end) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = e_end - (e0 + 4 * i);
    if (n <= 0) {
      w[i] = 0u;
    } else if (n < 4) {
      w[i] &= (1u << (8 * n)) - 1u;
    }
  }
  return v;
}

// One staged word of row ``row`` (pitch ``ld``) at element ``e0`` (fp32:
// the float's bits; int8: four consecutive int8, the first in the low
// byte); elements at or past ``e_end`` read 0.
template <bool kInt8>
__device__ __forceinline__ uint32_t load_word(const void* __restrict__ x,
                                              size_t row, int ld, int e0,
                                              int e_end) {
  if constexpr (kInt8) {
    const uint8_t* p = static_cast<const uint8_t*>(x) + row * ld;
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (e0 + b < e_end) w |= (uint32_t)__ldg(p + e0 + b) << (8 * b);
    }
    return w;
  } else {
    const float* p = static_cast<const float*>(x) + row * ld;
    return e0 < e_end ? __float_as_uint(__ldg(p + e0)) : 0u;
  }
}

// Global loads of one chunk (words w of elements d0 + w*PER, for rows
// m0.. of the slice and queries q0..) into registers: creg[j] is word
// e % BW of row e / BW, e = tid + j*NT; qreg[0] word tid % BW of query
// tid / BW.  With kVec (int8, 16-byte pitch, d0 a multiple of 16),
// creg[4j..4j+3] is vector e % QUADS of row e / QUADS and qreg[0..3]
// vector tid % QUADS of query tid / QUADS (tid < BQ*QUADS).
template <bool kInt8, bool kVec>
__device__ __forceinline__ void load_chunk(
    const void* __restrict__ q, const void* __restrict__ c, int Q, int ld,
    int q0, int m0, int m_end, int d0, int d_end, int tid,
    uint32_t (&creg)[C_LOADS], uint32_t (&qreg)[4]) {
  if constexpr (kVec) {
#pragma unroll
    for (int j = 0; j < C_LOADS / 4; ++j) {
      const int e = tid + j * NT;
      const int gm = m0 + e / QUADS;
      const int e0 = d0 + (e % QUADS) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gm < m_end && e0 < d_end) {
        v = mask_vec(__ldg(reinterpret_cast<const uint4*>(
                         static_cast<const uint8_t*>(c) + (size_t)gm * ld +
                         e0)),
                     e0, d_end);
      }
      creg[4 * j] = v.x;
      creg[4 * j + 1] = v.y;
      creg[4 * j + 2] = v.z;
      creg[4 * j + 3] = v.w;
    }
    const int gq = q0 + tid / QUADS;
    const int e0 = d0 + (tid % QUADS) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (tid < BQ * QUADS && gq < Q && e0 < d_end) {
      v = mask_vec(__ldg(reinterpret_cast<const uint4*>(
                       static_cast<const uint8_t*>(q) + (size_t)gq * ld +
                       e0)),
                   e0, d_end);
    }
    qreg[0] = v.x;
    qreg[1] = v.y;
    qreg[2] = v.z;
    qreg[3] = v.w;
  } else {
    constexpr int PER = kInt8 ? 4 : 1;
#pragma unroll
    for (int j = 0; j < C_LOADS; ++j) {
      const int e = tid + j * NT;
      const int gm = m0 + e / BW;
      creg[j] = gm < m_end ? load_word<kInt8>(c, gm, ld,
                                              d0 + (e % BW) * PER, d_end)
                           : 0u;
    }
    const int gq = q0 + tid / BW;
    qreg[0] = gq < Q ? load_word<kInt8>(q, gq, ld, d0 + (tid % BW) * PER,
                                        d_end)
                     : 0u;
  }
}

// Transpose the loaded chunk into staging buffer ``buf``: cs[w][row],
// qs[w][query].
template <bool kVec>
__device__ __forceinline__ void store_chunk(uint32_t* cs, uint32_t* qs,
                                            int buf, int tid,
                                            const uint32_t (&creg)[C_LOADS],
                                            const uint32_t (&qreg)[4]) {
  uint32_t* cb = cs + buf * CS_WORDS;
  uint32_t* qb = qs + buf * QS_WORDS;
  if constexpr (kVec) {
#pragma unroll
    for (int j = 0; j < C_LOADS / 4; ++j) {
      const int e = tid + j * NT;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        cb[((e % QUADS) * 4 + i) * CS_STRIDE + e / QUADS] = creg[4 * j + i];
      }
    }
    if (tid < BQ * QUADS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qb[((tid % QUADS) * 4 + i) * QS_STRIDE + tid / QUADS] = qreg[i];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < C_LOADS; ++j) {
      const int e = tid + j * NT;
      cb[(e % BW) * CS_STRIDE + e / BW] = creg[j];
    }
    qb[(tid % BW) * QS_STRIDE + tid / BW] = qreg[0];
  }
}

template <bool kInt8>
__device__ __forceinline__ void mac(uint32_t a, uint32_t b,
                                    typename std::conditional<
                                        kInt8, int, float>::type& acc) {
  if constexpr (kInt8) {
    acc = __dp4a((int)a, (int)b, acc);
  } else {
    acc = fmaf(__uint_as_float(a), __uint_as_float(b), acc);
  }
}

template <bool kInt8, bool kVec>
__global__ void __launch_bounds__(NT, 1) dtiled_tile_kernel(
    const void* __restrict__ q, const void* __restrict__ c,
    const float* __restrict__ qn, const float* __restrict__ q_scale,
    const float* __restrict__ c_scale, const int* __restrict__ qgid, int Q,
    int M, int D, int ld, int k, int n2, int bd, long long col_offset,
    long long col_stride, int rows_per_slice, float* __restrict__ part_v,
    int* __restrict__ part_i) {
  using Part = typename std::conditional<kInt8, int, float>::type;
  constexpr int PER = kInt8 ? 4 : 1;      // elements per staged word
  extern __shared__ float4 dtiled_smem[];
  uint32_t* cs = reinterpret_cast<uint32_t*>(dtiled_smem);  // [2][BW][..]
  uint32_t* qs = cs + 2 * CS_WORDS;                         // [2][BW][..]
  float* sv = reinterpret_cast<float*>(cs);   // [BQ][BM] over the staging
  float* lv = reinterpret_cast<float*>(cs + STAGE_WORDS);   // [BQ][n2]
  int* li = reinterpret_cast<int*>(lv + BQ * n2);           // [BQ][n2]
  float* wv = reinterpret_cast<float*>(li + BQ * n2);       // merge scratch
  int* wi = reinterpret_cast<int*>(wv + NWARP * MERGE_CAND);
  float* cn = reinterpret_cast<float*>(wi + NWARP * MERGE_CAND);  // [BM]

  const int q0 = blockIdx.x * BQ;
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
  const int n_chunks = n_tiles * per_tile;

  for (int t = tid; t < BQ * n2; t += NT) {
    lv[t] = -INFINITY;
    li[t] = PAD_IDX;
  }

  for (int m0 = m_begin; m0 < m_end; m0 += BM) {
    // warps whose rows all lie past the slice skip the multiply
    const bool warp_live = m0 + (tm - lane) * TM < m_end;
    uint32_t creg[C_LOADS];
    uint32_t qreg[4];
    Part part[TQ][TM];
    float acc[TQ][TM];
    Part npart[TM];     // |c|^2 of this thread's rows (first query group)
    float nacc[TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      npart[j] = 0;
      nacc[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        part[i][j] = 0;
        acc[i][j] = 0.0f;
      }
    }

    __syncthreads();   // the previous tile's merge is done with sv and cn
    load_chunk<kInt8, kVec>(q, c, Q, ld, q0, m0, m_end, 0, min(bd, D), tid,
                            creg, qreg);
    store_chunk<kVec>(cs, qs, 0, tid, creg, qreg);
    __syncthreads();
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int buf = ch & 1;
      const bool more = ch + 1 < n_chunks;
      if (more) {
        const int t = (ch + 1) / per_tile;
        const int d0 = t * bd + ((ch + 1) % per_tile) * BW * PER;
        load_chunk<kInt8, kVec>(q, c, Q, ld, q0, m0, m_end, d0,
                                min(t * bd + bd, D), tid, creg, qreg);
      }
      if (warp_live) {
        const uint32_t* cb = cs + buf * CS_WORDS + tm * TM;
        const uint32_t* qb = qs + buf * QS_WORDS + tq * TQ;
#pragma unroll
        for (int w = 0; w < BW; ++w) {
          const uint4 a0 =
              *reinterpret_cast<const uint4*>(qb + w * QS_STRIDE);
          const uint4 a1 =
              *reinterpret_cast<const uint4*>(qb + w * QS_STRIDE + 4);
          const uint4 b =
              *reinterpret_cast<const uint4*>(cb + w * CS_STRIDE);
          const uint32_t a[TQ] = {a0.x, a0.y, a0.z, a0.w,
                                  a1.x, a1.y, a1.z, a1.w};
          const uint32_t bb[TM] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < TQ; ++i)
#pragma unroll
            for (int j = 0; j < TM; ++j) mac<kInt8>(a[i], bb[j], part[i][j]);
          if (tq == 0) {                    // warp-uniform
#pragma unroll
            for (int j = 0; j < TM; ++j) mac<kInt8>(bb[j], bb[j], npart[j]);
          }
        }
      }
      if ((ch + 1) % per_tile == 0) {
        // end of a D tile: add its partials to the accumulators, in order
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          nacc[j] = __fadd_rn(nacc[j], (float)npart[j]);
          npart[j] = 0;
#pragma unroll
          for (int i = 0; i < TQ; ++i) {
            acc[i][j] = __fadd_rn(acc[i][j], (float)part[i][j]);
            part[i][j] = 0;
          }
        }
      }
      if (more) store_chunk<kVec>(cs, qs, buf ^ 1, tid, creg, qreg);
      __syncthreads();
    }
    if (tq == 0) {
#pragma unroll
      for (int j = 0; j < TM; ++j) cn[tm * TM + j] = nacc[j];
    }
    __syncthreads();

    // scores, masked, over the staging buffers (free after the last sync)
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int gq = q0 + tq * TQ + i;
      const bool q_ok = gq < Q;
      const long long my_gid = q_ok ? (long long)qgid[gq] : -1LL;
      const float sq = (q_ok && q_scale != nullptr) ? q_scale[gq] : 1.0f;
      const float q_term = (q_ok && qn != nullptr)
                               ? __fmul_rn(__fmul_rn(sq, sq), qn[gq])
                               : 0.0f;
      float s[TM];
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int m = m0 + tm * TM + j;
        s[j] = -INFINITY;
        if (m < m_end && (long long)m * col_stride + col_offset != my_gid) {
          const float sc = c_scale != nullptr ? c_scale[m] : 1.0f;
          s[j] = __fsub_rn(
              __fmul_rn(__fmul_rn(2.0f, __fmul_rn(sq, sc)), acc[i][j]),
              __fmul_rn(__fmul_rn(sc, sc), cn[tm * TM + j]));
          if (qn != nullptr) s[j] = __fsub_rn(s[j], q_term);
        }
      }
      *reinterpret_cast<float4*>(sv + (tq * TQ + i) * BM + tm * TM) =
          make_float4(s[0], s[1], s[2], s[3]);
    }
    __syncthreads();

    merge_score_tile<BQ, BM, NWARP>(sv, lv, li, wv, wi, q0, Q, m0, m_end,
                                    k, n2);
  }
  __syncthreads();
  write_slice_lists<BQ>(lv, li, q0, Q, k, n2, slice, S, part_v, part_i);
}

template <bool kInt8, bool kVec>
cudaError_t launch_tiles(dim3 grid, size_t smem, cudaStream_t st,
                         const void* q, const void* c, const float* qn,
                         const float* q_scale, const float* c_scale,
                         const int* qgid, int Q, int M, int D, int ld, int k,
                         int n2, int bd, long long col_offset,
                         long long col_stride, int rows_per_slice,
                         float* part_v, int* part_i) {
  cudaError_t err = cudaFuncSetAttribute(
      dtiled_tile_kernel<kInt8, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dtiled_tile_kernel<kInt8, kVec><<<grid, NT, smem, st>>>(
      q, c, qn, q_scale, c_scale, qgid, Q, M, D, ld, k, n2, bd, col_offset,
      col_stride, rows_per_slice, part_v, part_i);
  return cudaGetLastError();
}

}  // namespace

// q: [Q, *] and c: [M, *], rows of D elements at a pitch of ld elements
// (ld >= D), both int8 (int8 != 0; q_scale f32[Q] and c_scale f32[M]) or
// both f32 (scales null).  vec != 0 (int8 only) asks for 16-byte row
// loads: ld and bd multiples of 16.  qn: f32[Q] |q|^2 summed in the same
// D tiles (ref.tiled_sqnorm_ref), or null unless sub_qnorm.  1 <= bd
// (<= 1024 in int8 mode).  part_*: scratch [Q, n_slices, k]; out_*:
// [Q, k]; n2 a power of two in [max(k, 64), 1024]; rows_per_slice *
// n_slices >= M.
extern "C" int knn_topk_dtiled_launch(
    const void* q, const void* c, const void* qn, const void* q_scale,
    const void* c_scale, const void* qgid, int Q, int M, int D, int ld,
    int k, int n2, int bd, int int8, int vec, long long col_offset,
    long long col_stride, int rows_per_slice, int n_slices, void* part_v,
    void* part_i, void* out_v, void* out_i, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = tile_smem_bytes(n2);
  const dim3 grid((Q + BQ - 1) / BQ, n_slices);
  const auto* qn_f = (const float*)qn;
  const auto* qgid_i = (const int*)qgid;
  cudaError_t err;
  if (int8 && vec) {
    err = launch_tiles<true, true>(
        grid, smem, st, q, c, qn_f, (const float*)q_scale,
        (const float*)c_scale, qgid_i, Q, M, D, ld, k, n2, bd, col_offset,
        col_stride, rows_per_slice, (float*)part_v, (int*)part_i);
  } else if (int8) {
    err = launch_tiles<true, false>(
        grid, smem, st, q, c, qn_f, (const float*)q_scale,
        (const float*)c_scale, qgid_i, Q, M, D, ld, k, n2, bd, col_offset,
        col_stride, rows_per_slice, (float*)part_v, (int*)part_i);
  } else {
    err = launch_tiles<false, false>(
        grid, smem, st, q, c, qn_f, nullptr, nullptr, qgid_i, Q, M, D, ld,
        k, n2, bd, col_offset, col_stride, rows_per_slice, (float*)part_v,
        (int*)part_i);
  }
  if (err != cudaSuccess) return (int)err;
  merge_lists_kernel<<<Q, 256, (size_t)n2 * 8, st>>>(
      (const float*)part_v, (const int*)part_i, n_slices, k, n2, k,
      (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}
