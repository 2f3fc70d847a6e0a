// Shared pieces of the port's top-k kernels (stage A and stage B).
//
// Candidates are (value, index) pairs under one total order: the higher
// value first and, for equal values, the LOWER index first -- the
// tie-break of lax.top_k that the JAX package's kernels keep.  Padding
// entries are (-inf, PAD_IDX), which every real candidate beats.
//
// Lists live in shared memory as two arrays (values, indices) and are
// sorted with bitonic networks by a group of threads: a warp (syncs
// with __syncwarp) or a whole block (syncs with __syncthreads).
//
// Both stage-A kernels (knn_topk.cu, knn_topk_dtiled.cu) share the
// corpus-slice plan below: a block keeps one top-k list per query in
// shared memory, folds each masked score tile into it by rank
// (merge_score_tile_ranked in knn_topk_dtiled.cu, 64 candidates at a
// time; knn_topk.cu folds two 256-row tiles at once on the same ranks),
// writes its slice's lists (write_slice_lists), and merge_lists_kernel
// merges the slices.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define PAD_IDX 0x7fffffff

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

template <bool kBlock>
__device__ __forceinline__ void group_sync() {
  if (kBlock) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

__device__ __forceinline__ void swap_entries(float* v, int* ix, int a,
                                             int b) {
  float tv = v[a];
  v[a] = v[b];
  v[b] = tv;
  int ti = ix[a];
  ix[a] = ix[b];
  ix[b] = ti;
}

// Sort n = 2^p entries into descending order (best first).
// tid in [0, nthreads); every thread of the group must call this.
template <bool kBlock>
__device__ void bitonic_sort_desc(float* v, int* ix, int n, int tid,
                                  int nthreads) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (n >> 1); t += nthreads) {
        int lo = 2 * stride * (t / stride) + (t % stride);
        int hi = lo + stride;
        bool first_block = (lo & size) == 0;
        bool swap = first_block ? better(v[hi], ix[hi], v[lo], ix[lo])
                                : better(v[lo], ix[lo], v[hi], ix[hi]);
        if (swap) swap_entries(v, ix, lo, hi);
      }
      group_sync<kBlock>();
    }
  }
}

// Sort a bitonic sequence of n = 2^p entries into descending order.
template <bool kBlock>
__device__ void bitonic_merge_desc(float* v, int* ix, int n, int tid,
                                   int nthreads) {
  for (int stride = n >> 1; stride > 0; stride >>= 1) {
    for (int t = tid; t < (n >> 1); t += nthreads) {
      int lo = 2 * stride * (t / stride) + (t % stride);
      int hi = lo + stride;
      if (better(v[hi], ix[hi], v[lo], ix[lo])) swap_entries(v, ix, lo, hi);
    }
    group_sync<kBlock>();
  }
}

// Fold a descending list b[0..nb) (nb <= n) into the descending list
// a[0..n) so that a keeps the best n of both: pair a[i] with
// b[n-1-i], keep the better of each pair (the result is bitonic), then
// bitonic-merge.  Every thread of the group must call this.
template <bool kBlock>
__device__ void fold_into_list(float* av, int* ai, const float* bv,
                               const int* bi, int nb, int n, int tid,
                               int nthreads) {
  for (int j = tid; j < nb; j += nthreads) {
    int i = n - 1 - j;
    if (better(bv[j], bi[j], av[i], ai[i])) {
      av[i] = bv[j];
      ai[i] = bi[j];
    }
  }
  group_sync<kBlock>();
  bitonic_merge_desc<kBlock>(av, ai, n, tid, nthreads);
}

// Second pass of both top-k stages: merge, per query (one block each),
// S descending lists of length L into the best kout entries.
// in_*: [Q, S, L]; out_*: [Q, kout]; n2 = power of two >= max(L, kout).
// Dynamic shared memory: n2 * 8 bytes.
static __global__ void merge_lists_kernel(const float* __restrict__ in_v,
                                          const int* __restrict__ in_i,
                                          int S, int L, int n2, int kout,
                                          float* __restrict__ out_v,
                                          int* __restrict__ out_i) {
  extern __shared__ float4 merge_smem[];
  float* av = reinterpret_cast<float*>(merge_smem);
  int* ai = reinterpret_cast<int*>(av + n2);
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int t = tid; t < n2; t += nt) {
    av[t] = -INFINITY;
    ai[t] = PAD_IDX;
  }
  __syncthreads();
  for (int s = 0; s < S; ++s) {
    const size_t base = ((size_t)q * S + s) * L;
    fold_into_list<true>(av, ai, in_v + base, in_i + base, L, n2, tid, nt);
  }
  for (int t = tid; t < kout; t += nt) {
    out_v[(size_t)q * kout + t] = av[t];
    out_i[(size_t)q * kout + t] = ai[t];
  }
}

constexpr int MERGE_CAND = 64;   // candidates a warp merges at once

// Keep the better (take_better) or the worse of (v, i) and its partner.
__device__ __forceinline__ void keep_pair(float& v, int& i, float pv, int pi,
                                          bool take_better) {
  if (take_better == better(pv, pi, v, i)) {
    v = pv;
    i = pi;
  }
}

// Bitonic sort, descending, of the warp's 64 entries held in registers:
// entry e is (v0, i0) of lane e for e < 32 and (v1, i1) of lane e - 32
// otherwise.  The same network as bitonic_sort_desc, on shuffles.
__device__ __forceinline__ void warp_sort64_desc(float& v0, int& i0,
                                                 float& v1, int& i1,
                                                 int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {   // size 64, one descending block: in-lane
        if (better(v1, i1, v0, i0)) {
          const float tv = v0;
          const int ti = i0;
          v0 = v1;
          i0 = i1;
          v1 = tv;
          i1 = ti;
        }
        continue;
      }
      const bool lo = (lane & stride) == 0;
      const float p0 = __shfl_xor_sync(0xffffffffu, v0, stride);
      const int q0 = __shfl_xor_sync(0xffffffffu, i0, stride);
      const float p1 = __shfl_xor_sync(0xffffffffu, v1, stride);
      const int q1 = __shfl_xor_sync(0xffffffffu, i1, stride);
      // entry e's block runs descending when (e & size) == 0
      keep_pair(v0, i0, p0, q0, lo == ((lane & size) == 0));
      keep_pair(v1, i1, p1, q1, lo == (((lane + 32) & size) == 0));
    }
  }
}

// The number of entries of the descending list v/ix[0..n) that are
// better than (cv, ci): its place in the list.
__device__ __forceinline__ int list_rank(const float* v, const int* ix,
                                         int n, float cv, int ci) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(v[mid], ix[mid], cv, ci)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The D-tiled kernels' merge: fold one masked score tile sv[BQ][BM]
// (rows m0.. of the block's slice) into the per-query lists lv/li[BQ][n2]
// (the best k in their first k entries), one warp per query, MERGE_CAND
// candidates at a time:
// a group none of whose candidates beats the current k-th entry is
// skipped; otherwise the candidates that do are sorted in registers,
// kept in the warp's scratch wv/wi[NWARP][MERGE_CAND], and merged into
// the list's first k entries in place: each real entry moves right by
// the number of candidates better than it (from the last real entry, 32
// entries at a time, until none moves), and each candidate lands at its
// index plus its place in the old list; what lands at or past k drops
// out.
// Rows at or past m_end are no candidates.  Every thread of the block
// calls this after sv is complete.
template <int BQ, int BM, int NWARP>
__device__ void merge_score_tile_ranked(const float* sv, float* lv, int* li,
                                 float* wv, int* wi, int q0, int Q, int m0,
                                 int m_end, int k, int n2) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int h = 0; h < BQ / NWARP; ++h) {
    const int r = warp * (BQ / NWARP) + h;
    if (q0 + r >= Q) continue;                 // warp-uniform
    float* lvr = lv + r * n2;
    int* lir = li + r * n2;
    for (int g = 0; g < BM && m0 + g < m_end; g += MERGE_CAND) {
      const float thr_v = lvr[k - 1];
      const int thr_i = lir[k - 1];
      const int i0 = m0 + g + lane;
      const int i1 = i0 + 32;
      const float v0 = sv[r * BM + g + lane];
      const float v1 = sv[r * BM + g + lane + 32];
      const bool p0 = i0 < m_end && better(v0, i0, thr_v, thr_i);
      const bool p1 = i1 < m_end && better(v1, i1, thr_v, thr_i);
      if (!__any_sync(0xffffffffu, p0 || p1)) continue;
      float c0 = p0 ? v0 : -INFINITY, c1 = p1 ? v1 : -INFINITY;
      int j0 = p0 ? i0 : PAD_IDX, j1 = p1 ? i1 : PAD_IDX;
      warp_sort64_desc(c0, j0, c1, j1, lane);
      float* bv = wv + warp * MERGE_CAND;
      int* bi = wi + warp * MERGE_CAND;
      bv[lane] = c0;
      bi[lane] = j0;
      bv[lane + 32] = c1;
      bi[lane + 32] = j1;
      // the candidates' places in the merged list (padding stays out)
      const int r0 =
          j0 != PAD_IDX ? lane + list_rank(lvr, lir, k, c0, j0) : k;
      const int r1 =
          j1 != PAD_IDX ? lane + 32 + list_rank(lvr, lir, k, c1, j1) : k;
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
          to = i + list_rank(bv, bi, MERGE_CAND, av, ai);
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
      if (r0 < k) {
        lvr[r0] = c0;
        lir[r0] = j0;
      }
      if (r1 < k) {
        lvr[r1] = c1;
        lir[r1] = j1;
      }
      __syncwarp();
    }
  }
}

// Write the block's k best of each query's list to part_*[Q, S, k] at
// slice ``slice`` of S.  Every thread of the block calls this.
template <int BQ>
__device__ void write_slice_lists(const float* lv, const int* li, int q0,
                                  int Q, int k, int n2, int slice, int S,
                                  float* __restrict__ part_v,
                                  int* __restrict__ part_i) {
  for (int t = threadIdx.x; t < BQ * k; t += blockDim.x) {
    const int r = t / k, j = t % k;
    const int gq = q0 + r;
    if (gq < Q) {
      const size_t o = ((size_t)gq * S + slice) * k + j;
      part_v[o] = lv[r * n2 + j];
      part_i[o] = li[r * n2 + j];
    }
  }
}
