// The fp32 stage-A mainloop shared by knn_topk.cu (B3, D whole) and the
// fp32 design of knn_topk_dtiled.cu (B5, D in tiles of bd): a block of
// NT threads multiplies BQ queries against a score tile of BM corpus
// rows, with D streamed in chunks of BD values through a ring of chunks
// in shared memory.
//   * The ring is filled by 4-byte cp.async, so rows at any 4-byte pitch
//     (D=11,997: 4 mod 16 bytes) are copied as they lie: one warp
//     instruction moves 128 contiguous bytes of one row into the row's
//     own place in the ring, padded to PITCH floats so that the compute
//     reads it with conflict-free float4 loads.  Values past a chunk's
//     end are zero-filled through the copy's source size.
//   * Each thread holds a TQ = BQ/4 query x TM = 4 row register tile: per
//     4 values of D, 4 + TQ float4 shared loads feed 16*TQ fmaf, each
//     score one fmaf chain in d order.  |c|^2 is summed in the same loop,
//     also one fmaf chain in d order: each of the 4 query groups owns one
//     of a thread's 4 rows (tile_row rotates the slots so that the owned
//     row sits in slot 0), so it costs every thread 4 fmaf per 4 values.
#pragma once

#include <cuda_runtime.h>

namespace knn_ring {

constexpr int NT = 256;                  // threads per block
constexpr int NWARP = NT / 32;
constexpr int QGROUPS = 4;               // query groups of a block
constexpr int TM = 4;                    // corpus rows per thread
constexpr int BM = NT / QGROUPS * TM;    // 256 corpus rows per score tile
constexpr int HALF = BM / 2;             // rows of one warp: 128
constexpr int BD = 32;                   // values of D per chunk
constexpr int PITCH = BD + 4;            // 36 floats: 9 16-byte units
static_assert(TM == QGROUPS, "each query group owns one row's |c|^2");
static_assert((PITCH / 4) % 2 == 1, "an odd pitch in 16-byte units");

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy one chunk into the stage ``st`` ([BM + BQ][PITCH] floats): warp w
// takes ring rows w, w + 8, .. (corpus rows mt + r below m_end, then
// queries q0 + r - BM below Q; rows past either are not copied, their
// scores are never used), lane l value d0 + l of each row (pitch ``ld``
// floats); values at or past d_end are zero-filled from a valid address.
template <int BQ>
__device__ __forceinline__ void issue_chunk(float* st,
                                            const float* __restrict__ q,
                                            const float* __restrict__ c,
                                            int ld, int Q, int q0, int mt,
                                            int m_end, int d0, int d_end,
                                            int warp, int lane) {
  const int d = d0 + lane;
  const int nb = d < d_end ? 4 : 0;
  const size_t dc = (size_t)min(d, d_end - 1);
#pragma unroll
  for (int i = 0; i < BM / NWARP; ++i) {
    const int r = warp + i * NWARP;
    if (mt + r < m_end) {
      cp_async4(st + r * PITCH + lane, c + (size_t)(mt + r) * ld + dc, nb);
    }
  }
#pragma unroll
  for (int i = 0; i < BQ / NWARP; ++i) {
    const int r = warp + i * NWARP;
    if (q0 + r < Q) {
      cp_async4(st + (BM + r) * PITCH + lane,
                q + (size_t)(q0 + r) * ld + dc, nb);
    }
  }
}

// acc[i][j] += q_i . c_j over one staged chunk ``st``, d in order, for
// query i of the thread's TQ at qb + i*PITCH (one address for the whole
// warp) and tile row row[j]; nacc += |c|^2 of row[0], also in d order.
template <int TQ>
__device__ __forceinline__ void mul_chunk(const float* st, const float* qb,
                                          const int (&row)[TM],
                                          float (&acc)[TQ][TM],
                                          float& nacc) {
#pragma unroll
  for (int dd = 0; dd < BD; dd += 4) {
    float4 b[TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      b[j] = *reinterpret_cast<const float4*>(st + row[j] * PITCH + dd);
    }
    nacc = fmaf(b[0].x, b[0].x, nacc);
    nacc = fmaf(b[0].y, b[0].y, nacc);
    nacc = fmaf(b[0].z, b[0].z, nacc);
    nacc = fmaf(b[0].w, b[0].w, nacc);
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(qb + i * PITCH + dd);
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
      }
    }
  }
}

// Warp w is query group tq = w % 4 (queries tq*TQ ..) and row half
// h = w / 4; lane l's row slot j holds tile row
//     h*128 + (l/8)*32 + ((j + tq) % 4)*8 + l%8,
// so the 8 lanes of each quarter warp read 8 consecutive rows (distinct
// bank groups at an odd pitch), a warp's rows are one contiguous half of
// the tile, and slot 0 is the row whose |c|^2 this thread sums.
__device__ __forceinline__ int tile_row(int h, int lane, int tq, int j) {
  return h * HALF + (lane / 8) * 32 + ((j + tq) % TM) * 8 + lane % 8;
}

}  // namespace knn_ring
