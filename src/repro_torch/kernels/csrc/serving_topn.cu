// blend_topn (serving stage B): per query q and item i
//     pred[q, i] = alpha * C[uid_q, i] + ((1 - alpha) * sum_j C[idx_qj, i]) / k
// (neighbours outside [0, M), e.g. -1, add 0 but still count in k; an
// own row outside [0, M) adds 0), then the top-n items, without writing
// [Q, k, I] or [Q, I] to device memory.
//
// Replaces the TPU kernel repro/kernels/serving_topn.py ::
// blend_topn_onehot, which recovers the neighbour sum as a one-hot
// contraction over corpus tiles because the TPU's MXU prefers a
// contraction to a data-dependent gather.  Here the sum is gathered
// from rows staged in shared memory.
//
// Bound: the distinct rows the queries name, each read once, and
// Q*(k+1)*I adds.  Stage A's lists overlap heavily (rows of low norm are
// near every query), so the adds bound it, not the bytes.  A kernel in
// which every query reads its own k rows moves Q*k*I*4 bytes through L2
// (3.7 GB at Q=256, k=300, I=11,997) and is bound by L2.  This design
// reads each distinct row of a group of G queries once per item tile and
// sums from shared memory:
//   * blend_plan_kernel, one block per group: the group's distinct valid
//     rows in ascending order (a bitmap over row ids and a prefix count
//     of its words, no sort), and each query's valid entries as local
//     slots in that list, grouped by staging pass (a pass: S consecutive
//     slots, the rows the staging area holds) and in order j within one;
//   * blend_group_kernel, one block per (group, strip of 32-item tiles):
//     per tile and pass, the 128-byte tiles of the pass's rows are copied
//     into shared memory (4-byte cp.async: rows start at any 4-byte
//     alignment); then a warp sums 4 queries at once, lane = (query, 4
//     items), in order j: the query's slots read 8 at a time, each row's
//     4 items one 16-byte shared load, 8 loads in flight; it adds the
//     passes in order, blends with the own row (read once per query and
//     tile) and folds the tile's 32 predictions into the query's running
//     top n (for n <= 32 held in registers, a few new entries inserted by
//     rank and many sorted and merged by shuffles; a list in shared
//     memory above);
//   * merge_select_kernel (n <= 32, 8 warps a query, by shuffles) or
//     merge_lists_kernel (above) merges the strips' lists into [Q, n].
// A group whose rows fit one pass sums each query's rows in order
// j = 0..k-1, bitwise a plain loop over j; with more passes each pass is
// summed in order j and the passes are added in order.  The blend uses
// round-to-nearest intrinsics so the compiler cannot contract it into an
// FMA: the expression rounds as the plain version does.  Ordering is
// (value desc, item asc), as lax.top_k.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int kTile = 32;            // items per tile: one per lane
constexpr int kThreads = 256;        // blend threads
constexpr int kWarps = kThreads / 32;
constexpr int kQuads = 4;            // queries a warp, items a lane
constexpr int kPlanThreads = 1024;
constexpr int kBitmapWords = 8192;   // a plan round covers 32x as many ids
constexpr int kMaxSelect = 32;       // top n in registers up to this n
constexpr int kInsertMax = 6;        // new entries inserted one by one
constexpr int kNoSlot = 0xffff;
constexpr unsigned kFull = 0xffffffffu;
// 1: staging, 2: sums, 4: selection -- all of them here;
// tools/dtiled_phase_split.py builds copies with parts left out
constexpr int kPhases = 7;

__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// the blend's shared memory: the group's entries [G][kp] (u16 slots; kp
// = k rounded up to 8), each warp's candidates of a tile [4][kTile]
// (values, items), a row of kTile zeros, for n > 32 the lists [G][n2]
// (values, items), then the staging area [S][kTile] f32
__host__ __device__ inline size_t blend_smem(int G, int k, int n2,
                                             bool select, int S) {
  size_t b = align16((size_t)G * ((k + 7) & ~7) * 2) +
             (size_t)kWarps * kQuads * kTile * 8 + kTile * 4;
  if (!select) b += (size_t)G * n2 * 8;
  return b + (size_t)S * kTile * 4;
}

// the plan's: the bitmap and its words' prefix, scan scratch, the
// entries' slots [G][k] (u16)
__host__ __device__ inline size_t plan_smem(int G, int k) {
  return (size_t)kBitmapWords * 8 + 64 * 4 + align16((size_t)G * k * 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 4 bytes into shared memory, or 4 zero bytes when bytes == 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// four 16-byte shared loads in one asm statement, so none waits on another
__device__ __forceinline__ void lds128x4(float4& a, float4& b, float4& c,
                                         float4& d, uint32_t pa, uint32_t pb,
                                         uint32_t pc, uint32_t pd) {
  asm volatile(
      "ld.shared.v4.f32 {%0, %1, %2, %3}, [%16];\n\t"
      "ld.shared.v4.f32 {%4, %5, %6, %7}, [%17];\n\t"
      "ld.shared.v4.f32 {%8, %9, %10, %11}, [%18];\n\t"
      "ld.shared.v4.f32 {%12, %13, %14, %15}, [%19];\n"
      : "=f"(a.x), "=f"(a.y), "=f"(a.z), "=f"(a.w), "=f"(b.x), "=f"(b.y),
        "=f"(b.z), "=f"(b.w), "=f"(c.x), "=f"(c.y), "=f"(c.z), "=f"(c.w),
        "=f"(d.x), "=f"(d.y), "=f"(d.z), "=f"(d.w)
      : "r"(pa), "r"(pb), "r"(pc), "r"(pd)
      : "memory");
}

template <typename Idx>
__device__ __forceinline__ long long index_at(const void* p, size_t e) {
  return (long long)reinterpret_cast<const Idx*>(p)[e];
}

// One block per group of G queries: rows[g][0..D) the group's distinct
// rows in [0, M), ascending; cnt[g][q] query q's valid entries, pent[q]
// (a row of kp) their slots (positions in rows), those of pass 0 (slots
// [0, S)) first, then pass 1, ..., each pass in order j, then no-slot
// marks to the row's end; cnt[g][G] = D.
template <typename Idx>
__global__ void __launch_bounds__(kPlanThreads) blend_plan_kernel(
    const void* __restrict__ nbr, int Q, int M, int k, int kp, int G,
    int S, int* __restrict__ prow, int* __restrict__ pcnt,
    uint16_t* __restrict__ pent) {
  extern __shared__ __align__(16) unsigned char plan_buf[];
  uint32_t* bits = reinterpret_cast<uint32_t*>(plan_buf);
  int* pre = reinterpret_cast<int*>(bits + kBitmapWords);
  int* wsum = pre + kBitmapWords;                        // [32]
  int* next_base = wsum + 32;
  uint16_t* slot = reinterpret_cast<uint16_t*>(wsum + 64);
  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = g * G;
  const int gq = min(G, Q - q0);
  const int E = gq * k;
  const size_t e0 = (size_t)q0 * k;
  int* rows = prow + (size_t)g * G * k;
  for (int e = tid; e < E; e += kPlanThreads) slot[e] = (uint16_t)kNoSlot;
  int base = 0;
  constexpr long long kSpan = (long long)kBitmapWords * 32;
  for (long long c0 = 0; c0 < M; c0 += kSpan) {
    const int span = (int)min(kSpan, (long long)M - c0);
    const int nw = (span + 31) >> 5;
    for (int w = tid; w < nw; w += kPlanThreads) bits[w] = 0u;
    __syncthreads();
    for (int e = tid; e < E; e += kPlanThreads) {
      const long long r = index_at<Idx>(nbr, e0 + e) - c0;
      if (r >= 0 && r < span) atomicOr(&bits[r >> 5], 1u << (r & 31));
    }
    __syncthreads();
    // exclusive prefix of the words' counts, kPer words a thread
    constexpr int kPer = kBitmapWords / kPlanThreads;
    int mine[kPer];
    int sum = 0;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int w = tid * kPer + t;
      mine[t] = w < nw ? __popc(bits[w]) : 0;
      sum += mine[t];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = wsum[lane];
      int x = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      wsum[lane] = x - v;
    }
    __syncthreads();
    int run = base + wsum[warp] + incl - sum;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int w = tid * kPer + t;
      if (w < nw) pre[w] = run;
      run += mine[t];
    }
    if (tid == kPlanThreads - 1) *next_base = run;
    __syncthreads();
    for (int w = tid; w < nw; w += kPlanThreads) {
      uint32_t b = bits[w];
      int s = pre[w];
      while (b) {
        rows[s++] = (int)(c0 + w * 32 + (__ffs(b) - 1));
        b &= b - 1u;
      }
    }
    for (int e = tid; e < E; e += kPlanThreads) {
      const long long r = index_at<Idx>(nbr, e0 + e) - c0;
      if (r >= 0 && r < span) {
        const int w = (int)(r >> 5);
        const uint32_t below = (1u << (r & 31)) - 1u;
        slot[e] = (uint16_t)(pre[w] + __popc(bits[w] & below));
      }
    }
    base = *next_base;
    __syncthreads();
  }
  if (tid == 0) pcnt[g * (G + 1) + G] = base;
  const int P = (base + S - 1) / S;
  for (int q = warp; q < G; q += kPlanThreads / 32) {
    int out = 0;
    if (q < gq) {
      uint16_t* dst = pent + (size_t)(q0 + q) * kp;
      for (int p = 0; p < P; ++p) {
        const int lo = p * S, hi = lo + S;
        for (int j0 = 0; j0 < k; j0 += 32) {
          const int j = j0 + lane;
          const int s = j < k ? (int)slot[q * k + j] : kNoSlot;
          const bool in = s != kNoSlot && s >= lo && s < hi;
          const unsigned m = __ballot_sync(kFull, in);
          if (in) dst[out + __popc(m & ((1u << lane) - 1u))] = (uint16_t)s;
          out += __popc(m);
        }
      }
      for (int t = out + lane; t < kp; t += 32) dst[t] = (uint16_t)kNoSlot;
    }
    if (lane == 0) pcnt[g * (G + 1) + q] = out;
  }
}

// Bitonic sort, descending, of the warp's 32 entries, one a lane.
__device__ __forceinline__ void warp_sort32_desc(float& v, int& i,
                                                 int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float pv = __shfl_xor_sync(kFull, v, stride);
      const int pi = __shfl_xor_sync(kFull, i, stride);
      const bool lo = (lane & stride) == 0;
      keep_pair(v, i, pv, pi, lo == ((lane & size) == 0));
    }
  }
}

// A bitonic sequence of 32 entries, one a lane, into descending order.
__device__ __forceinline__ void warp_merge32_desc(float& v, int& i,
                                                  int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const float pv = __shfl_xor_sync(kFull, v, stride);
    const int pi = __shfl_xor_sync(kFull, i, stride);
    keep_pair(v, i, pv, pi, (lane & stride) == 0);
  }
}

// Fold the descending 32 entries (v, i), one a lane, into the list
// (lv, li) whose entry l lane l holds: the list against the entries
// reversed, the better of each pair (the best 32 of both, a bitonic
// run), merged.
__device__ __forceinline__ void warp_fold32(float& lv, int& li, float v,
                                            int i, int lane) {
  const float rv = __shfl_sync(kFull, v, 31 - lane);
  const int ri = __shfl_sync(kFull, i, 31 - lane);
  if (better(rv, ri, lv, li)) {
    lv = rv;
    li = ri;
  }
  warp_merge32_desc(lv, li, lane);
}

// One block per (group, strip of tiles_per_strip tiles).  Warp w sums
// the group's queries 4w..4w+3: lane l takes query 4w + l/8 and items
// 4(l%8)..4(l%8)+3 of the tile, reads its query's slots 8 at a time and
// each row's 4 items as one 16-byte load.  Writes each query's best L of
// the strip to part_*[Q, strips, L].
template <bool kSelect>
__global__ void __launch_bounds__(kThreads, 2) blend_group_kernel(
    const float* __restrict__ C, const void* __restrict__ uid, int uid64,
    const int* __restrict__ prow, const int* __restrict__ pcnt,
    const uint16_t* __restrict__ pent, int Q, int M, int I, int k, int kp,
    int G, int S, int tiles_per_strip, float alpha, float one_minus_alpha,
    int n, int n2, int L, float* __restrict__ part_v,
    int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char blend_buf[];
  uint16_t* ent = reinterpret_cast<uint16_t*>(blend_buf);
  float* cv = reinterpret_cast<float*>(blend_buf +
                                       align16((size_t)G * kp * 2));
  int* ci = reinterpret_cast<int*>(cv + kWarps * kQuads * kTile);
  float* zero = reinterpret_cast<float*>(ci + kWarps * kQuads * kTile);
  unsigned char* free_at = reinterpret_cast<unsigned char*>(zero + kTile);
  float* lv = nullptr;
  int* li = nullptr;
  if constexpr (!kSelect) {
    lv = reinterpret_cast<float*>(free_at);
    li = reinterpret_cast<int*>(lv + (size_t)G * n2);
    free_at = reinterpret_cast<unsigned char*>(li + (size_t)G * n2);
  }
  float* stage = reinterpret_cast<float*>(free_at);
  const uint32_t stage_s = smem_u32(stage);

  const int g = blockIdx.x, strip = blockIdx.y, strips = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = lane >> 3, iq = lane & 7;   // this lane's query, items
  const int q0 = g * G;
  const int gq = min(G, Q - q0);
  const int ql = warp * kQuads + quad;         // the lane's query
  const bool q_ok = ql < gq;
  const int n_tiles = (I + kTile - 1) / kTile;
  const int t0 = strip * tiles_per_strip;
  const int t1 = min(n_tiles, t0 + tiles_per_strip);
  const int* rows = prow + (size_t)g * G * k;
  const int D = pcnt[g * (G + 1) + G];
  const int P = (D + S - 1) / S;
  const float kf = (float)k;
  float* wcv = cv + warp * kQuads * kTile;     // the warp's candidates
  int* wci = ci + warp * kQuads * kTile;

  for (int e = tid; e < gq * kp / 4; e += kThreads) {
    reinterpret_cast<uint2*>(ent)[e] =
        reinterpret_cast<const uint2*>(pent + (size_t)q0 * kp)[e];
  }
  const int cnt = q_ok ? pcnt[g * (G + 1) + ql] : 0;
  long long own_row = -1;
  if (q_ok) {
    const long long u = uid64 ? index_at<long long>(uid, q0 + ql)
                              : index_at<int>(uid, q0 + ql);
    if (u >= 0 && u < M) own_row = u;
  }
  // kSelect: the lists of the warp's queries, entry l at lane l
  float sel_v[kQuads];
  int sel_i[kQuads];
#pragma unroll
  for (int h = 0; h < kQuads; ++h) {
    sel_v[h] = -INFINITY;
    sel_i[h] = PAD_IDX;
  }
  if constexpr (!kSelect) {
    for (int t = tid; t < G * n2; t += kThreads) {
      lv[t] = -INFINITY;
      li[t] = PAD_IDX;
    }
  }
  if (tid < kTile) zero[tid] = 0.0f;
  float keep = 0.0f;   // holds the sums when the selection is left out
  const uint16_t* eq = ent + ql * kp;
  const uint32_t zero_s = smem_u32(zero) + 16u * iq;
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    const int i0 = t * kTile + kQuads * iq;   // the lane's first item
    float total[kQuads], own[kQuads];
#pragma unroll
    for (int e = 0; e < kQuads; ++e) {
      total[e] = 0.0f;
      own[e] = own_row >= 0 && i0 + e < I
                   ? __ldg(C + (size_t)own_row * I + i0 + e)
                   : 0.0f;
    }
    int c = 0;   // the lane's next entry
    for (int p = 0; p < P; ++p) {
      const int lo = p * S;
      const int nr = min(S, D - lo);
      __syncthreads();   // every warp is done with the last pass's rows
      if (kPhases & 1) {
        // row r0 + tt * kWarps + warp of the pass by warp `warp`, item
        // t * kTile + lane of it by this lane
        const int item = t * kTile + lane;
        const bool in_i = item < I;
        for (int r0 = 0; r0 < nr; r0 += 32 * kWarps) {
          const int mine = r0 + lane * kWarps + warp;
          const int my_row = mine < nr ? rows[lo + mine] : 0;
          const int n_mine =
              max(0, min(32, (nr - r0 - warp + kWarps - 1) / kWarps));
          for (int tt = 0; tt < n_mine; ++tt) {
            const int row = __shfl_sync(kFull, my_row, tt);
            const int at = r0 + tt * kWarps + warp;
            cp_async4(stage_s + (uint32_t)(at * kTile + lane) * 4u,
                      C + (size_t)row * I + (in_i ? item : 0),
                      in_i ? 4 : 0);
          }
        }
        cp_async_wait_all();
      }
      __syncthreads();
      if (kPhases & 2) {
        const int hi = min(lo + S, D);   // the pass's slots: [lo, hi)
        const uint32_t base = stage_s + 16u * iq - 128u * (uint32_t)lo;
        float acc[kQuads] = {0.0f, 0.0f, 0.0f, 0.0f};
        // the pass's entries are a prefix of the lane's rest: walk the
        // aligned chunks of 8 slots from the one holding the next entry
        // (the following chunk's slots read under this one's sums) until
        // no lane has one left.  An entry out of the pass reads the zero
        // row: adding +0.0 leaves the sum's bits as they are (a sum from
        // +0.0 is never -0.0)
        int b = c & ~7;
        int skip = c - b;
        uint4 raw = make_uint4(~0u, ~0u, ~0u, ~0u);
        if (b < cnt) raw = *reinterpret_cast<const uint4*>(eq + b);
        while (true) {
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
          uint32_t at[8];
          int n_in = 0;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int sl = (int)((w[u >> 1] >> (16 * (u & 1))) & 0xffffu);
            const bool in = u >= skip && sl < hi;
            n_in += in;
            at[u] = in ? base + 128u * (uint32_t)sl : zero_s;
          }
          if (!__any_sync(kFull, n_in > 0)) break;
          const int nb = b + 8;
          raw = make_uint4(~0u, ~0u, ~0u, ~0u);
          if (nb < cnt) raw = *reinterpret_cast<const uint4*>(eq + nb);
          float4 v[8];
          lds128x4(v[0], v[1], v[2], v[3], at[0], at[1], at[2], at[3]);
          lds128x4(v[4], v[5], v[6], v[7], at[4], at[5], at[6], at[7]);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            acc[0] = __fadd_rn(acc[0], v[u].x);
            acc[1] = __fadd_rn(acc[1], v[u].y);
            acc[2] = __fadd_rn(acc[2], v[u].z);
            acc[3] = __fadd_rn(acc[3], v[u].w);
          }
          c += n_in;
          b = nb;
          skip = 0;
        }
#pragma unroll
        for (int e = 0; e < kQuads; ++e) total[e] = __fadd_rn(total[e], acc[e]);
      }
    }
    // blend; the candidates into the warp's scratch, query-major
    bool hit = false;
    float thr_v = -INFINITY;
    int thr_i = PAD_IDX;
    if constexpr (kSelect) {
#pragma unroll
      for (int h = 0; h < kQuads; ++h) {
        const float tv = __shfl_sync(kFull, sel_v[h], n - 1);
        const int ti = __shfl_sync(kFull, sel_i[h], n - 1);
        if (h == quad) {
          thr_v = tv;
          thr_i = ti;
        }
      }
    } else if (q_ok) {
      thr_v = lv[(size_t)ql * n2 + n - 1];
      thr_i = li[(size_t)ql * n2 + n - 1];
    }
#pragma unroll
    for (int e = 0; e < kQuads; ++e) {
      const int i = i0 + e;
      float v = -INFINITY;
      int it = PAD_IDX;
      if (q_ok && i < I) {
        v = __fadd_rn(__fmul_rn(alpha, own[e]),
                      __fdiv_rn(__fmul_rn(one_minus_alpha, total[e]), kf));
        it = i;
      }
      hit |= better(v, it, thr_v, thr_i);
      keep = __fadd_rn(keep, v);
      wcv[quad * kTile + kQuads * iq + e] = v;
      wci[quad * kTile + kQuads * iq + e] = it;
    }
    if (!(kPhases & 4)) continue;
    const unsigned hits = __ballot_sync(kFull, hit);
    if (!hits) continue;
    __syncwarp();
#pragma unroll
    for (int h = 0; h < kQuads; ++h) {
      if (!((hits >> (8 * h)) & 0xffu)) continue;   // warp-uniform
      float v = wcv[h * kTile + lane];
      int it = wci[h * kTile + lane];
      if constexpr (kSelect) {
        float tv = __shfl_sync(kFull, sel_v[h], n - 1);
        int ti = __shfl_sync(kFull, sel_i[h], n - 1);
        unsigned m = __ballot_sync(kFull, better(v, it, tv, ti));
        if (__popc(m) > kInsertMax) {
          warp_sort32_desc(v, it, lane);
          warp_fold32(sel_v[h], sel_i[h], v, it, lane);
        }
        // a few: each into the list at its rank (the entries better than
        // it), those after it moving down one; a candidate the list's
        // n-th entry now beats is dropped
        while (__popc(m) <= kInsertMax && m) {
          const int src = __ffs(m) - 1;
          const float cv = __shfl_sync(kFull, v, src);
          const int ci = __shfl_sync(kFull, it, src);
          const int rank = __popc(
              __ballot_sync(kFull, better(sel_v[h], sel_i[h], cv, ci)));
          const float uv = __shfl_up_sync(kFull, sel_v[h], 1);
          const int ui = __shfl_up_sync(kFull, sel_i[h], 1);
          if (lane > rank) {
            sel_v[h] = uv;
            sel_i[h] = ui;
          } else if (lane == rank) {
            sel_v[h] = cv;
            sel_i[h] = ci;
          }
          tv = __shfl_sync(kFull, sel_v[h], n - 1);
          ti = __shfl_sync(kFull, sel_i[h], n - 1);
          m &= (m - 1) & __ballot_sync(kFull, better(v, it, tv, ti));
        }
      } else {
        warp_sort32_desc(v, it, lane);
        __syncwarp();
        wcv[h * kTile + lane] = v;
        wci[h * kTile + lane] = it;
        __syncwarp();
        const int qh = warp * kQuads + h;
        fold_into_list<false>(lv + (size_t)qh * n2, li + (size_t)qh * n2,
                              wcv + h * kTile, wci + h * kTile, kTile, n2,
                              lane, 32);
      }
    }
    __syncwarp();   // the scratch is read before the next tile's writes
  }
  if (!(kPhases & 4)) {
    if (q_ok) part_v[((size_t)(q0 + ql) * strips + strip) * L] = keep;
    return;
  }
#pragma unroll
  for (int h = 0; h < kQuads; ++h) {
    const int qh = warp * kQuads + h;
    if (qh >= gq) continue;   // warp-uniform
    const size_t o = ((size_t)(q0 + qh) * strips + strip) * L;
    if constexpr (kSelect) {
      if (lane < L) {
        part_v[o + lane] = sel_v[h];
        part_i[o + lane] = sel_i[h];
      }
    } else {
      for (int e = lane; e < L; e += 32) {
        part_v[o + e] = lv[(size_t)qh * n2 + e];
        part_i[o + e] = li[(size_t)qh * n2 + e];
      }
    }
  }
}

// The strips' lists of n <= 32 entries into [Q, n], one block a query:
// warp w folds strips w, w + 8, ... into its own list (entry l at lane
// l) by shuffles, the next strip's entries read under the fold; warp 0
// then folds the 8 lists.
__global__ void __launch_bounds__(256) merge_select_kernel(
    const float* __restrict__ in_v, const int* __restrict__ in_i, int S,
    int L, int n, float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float wv[8][32];
  __shared__ int wi[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x;
  float lv = -INFINITY;
  int li = PAD_IDX;
  float nv = -INFINITY;
  int ni = PAD_IDX;
  if (warp < S && lane < L) {
    nv = in_v[((size_t)q * S + warp) * L + lane];
    ni = in_i[((size_t)q * S + warp) * L + lane];
  }
  for (int s = warp; s < S; s += 8) {
    const float v = nv;
    const int i = ni;
    nv = -INFINITY;
    ni = PAD_IDX;
    if (s + 8 < S && lane < L) {
      nv = in_v[((size_t)q * S + s + 8) * L + lane];
      ni = in_i[((size_t)q * S + s + 8) * L + lane];
    }
    const float tv = __shfl_sync(kFull, lv, n - 1);
    const int ti = __shfl_sync(kFull, li, n - 1);
    if (__any_sync(kFull, better(v, i, tv, ti))) {
      warp_fold32(lv, li, v, i, lane);
    }
  }
  wv[warp][lane] = lv;
  wi[warp][lane] = li;
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < 8; ++w) {
    warp_fold32(lv, li, wv[w][lane], wi[w][lane], lane);
  }
  if (lane < n) {
    out_v[(size_t)q * n + lane] = lv;
    out_i[(size_t)q * n + lane] = li;
  }
}

}  // namespace

// index_bits: bit 0 for int64 uid, bit 1 for int64 nbr (else int32).
// The plan (serving_topn.plan_blend): G queries a group, S rows a
// staging pass, strips x tiles_per_strip tiles of 32 items, lists of L
// entries, n2 the merge's power of two, and both kernels' shared memory,
// which the entry recomputes and refuses a launch where they differ.
// Scratch: prow [groups, G*k] i32, pcnt [groups, G+1] i32, pent
// [groups*G, kp] u16 (kp: k rounded up to 8), part_* [Q, strips, L];
// out_* [Q, topn].
extern "C" int blend_topn_launch(const void* C, const void* uid,
                                 const void* nbr, int index_bits, int Q,
                                 int M, int I, int k, float alpha,
                                 float one_minus_alpha, int topn, int G,
                                 int S, int strips, int tiles_per_strip,
                                 int L, int n2, int smem_bytes,
                                 int plan_smem_bytes, void* prow, void* pcnt,
                                 void* pent, void* part_v, void* part_i,
                                 void* out_v, void* out_i, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool select = topn <= kMaxSelect;
  const int kp = (k + 7) & ~7;
  if (G < 1 || G > kQuads * kWarps || (long long)G * k >= kNoSlot ||
      S < 1 || L < 1 || L > n2 || topn > n2 || n2 > 1024 ||
      (size_t)smem_bytes != blend_smem(G, k, n2, select, S) ||
      (size_t)plan_smem_bytes != plan_smem(G, k)) {
    return (int)cudaErrorInvalidValue;
  }
  const int groups = (Q + G - 1) / G;
  cudaError_t err;
  if (index_bits & 2) {
    err = cudaFuncSetAttribute(blend_plan_kernel<long long>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               plan_smem_bytes);
    if (err != cudaSuccess) return (int)err;
    blend_plan_kernel<long long><<<groups, kPlanThreads, plan_smem_bytes,
                                   st>>>(nbr, Q, M, k, kp, G, S, (int*)prow,
                                         (int*)pcnt, (uint16_t*)pent);
  } else {
    err = cudaFuncSetAttribute(blend_plan_kernel<int>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               plan_smem_bytes);
    if (err != cudaSuccess) return (int)err;
    blend_plan_kernel<int><<<groups, kPlanThreads, plan_smem_bytes, st>>>(
        nbr, Q, M, k, kp, G, S, (int*)prow, (int*)pcnt, (uint16_t*)pent);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto blend = select ? blend_group_kernel<true> : blend_group_kernel<false>;
  err = cudaFuncSetAttribute(blend, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's 228 KB as shared memory: two blocks of the plan's
  // share fit only so
  err = cudaFuncSetAttribute(blend,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  blend<<<dim3(groups, strips), kThreads, smem_bytes, st>>>(
      (const float*)C, uid, index_bits & 1, (const int*)prow,
      (const int*)pcnt, (const uint16_t*)pent, Q, M, I, k, kp, G, S,
      tiles_per_strip, alpha, one_minus_alpha, topn, n2, L, (float*)part_v,
      (int*)part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (select) {
    merge_select_kernel<<<Q, 256, 0, st>>>(
        (const float*)part_v, (const int*)part_i, strips, L, topn,
        (float*)out_v, (int*)out_i);
  } else {
    merge_lists_kernel<<<Q, 256, (size_t)n2 * 8, st>>>(
        (const float*)part_v, (const int*)part_i, strips, L, n2, topn,
        (float*)out_v, (int*)out_i);
  }
  return (int)cudaGetLastError();
}
