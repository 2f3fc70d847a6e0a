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
// The kernel finds every row from a base address, a pitch and, where
// given, an index per (query, neighbour) (struct Rows).  The wrappers
// point it at pre-fetched rows [Q, k, I] (the JAX signature: no index),
// at the corpus rows that stage A selected (int8 serving on one corpus:
// stage A's indices), or at rows in the shard corpora (cross-shard
// serving: their addresses), so the last two never write a [Q, k, I]
// gather.
//
// Bound: bytes.  Each query reads its k neighbour rows and its own row:
// Q*(k+1)*I elements when the rows are pre-fetched (3.7 GB in f32 at
// Q=256, k=300, I=11,997; a quarter of that in int8), fewer distinct
// bytes when they are corpus rows that queries share and L2 catches.
//
// Design.  One block per (query, tile of 4 KB of each row: 1,024 f32 or
// 4,096 int8 items): 8 consumer warps (4 or 16 items a thread) and one
// producer warp.  The producer feeds a ring of row tiles in shared
// memory with cp.async.bulk, each completing on its slot's mbarrier, so
// STAGES rows are in flight per block whatever the consumers do.  Rows lie at any 4-byte (f32) or 1-byte (int8)
// alignment -- I = 11,997 gives a 47,988-byte pitch, 4 mod 16 -- so the
// producer copies each tile's 16-byte-aligned superset and the slot's
// header tells the consumers where the tile starts in it.  A copy never
// reads past the end of the tensor that holds the row: where the
// aligned superset would (the last row of a tensor whose end is not
// 16-byte aligned, listed in RowEnds), the last < 16 bytes are loaded
// by the producer lanes instead.  The consumers sum the rows in fixed
// order j = 0..k-1 with round-to-nearest adds (int8: an exact
// dequantizing multiply by a power of two first, the int8 -> f32
// convert done on the integer pipe), divide by k and blend with
// round-to-nearest intrinsics (no FMA contraction), so the predictions
// are bitwise those of a plain loop over j.  The tile's best n come from
// a selection for n <= 32 (each warp extracts its best n by warp
// argmaxes, warp 0 merges the 8 lists the same way) and from a bitonic
// sort of the tile otherwise; a second kernel merges the tiles.
// Ordering is (value desc, item asc), as lax.top_k.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

constexpr int NT = 256;             // consumer threads
constexpr int NW = NT / 32;         // consumer warps
constexpr int THREADS = NT + 32;    // and one producer warp
constexpr int MAX_SELECT = 32;      // top-n by selection up to this n
constexpr int MAX_ENDS = 16;        // unaligned tensor ends a launch takes
constexpr unsigned FULL_MASK = 0xffffffffu;

// items per block by element type (a 4 KB piece of each row), and the
// ring's depth
template <typename T>
constexpr int kTile = sizeof(T) == 1 ? 4096 : 1024;
constexpr int STAGES = 8;
template <typename T>
constexpr int kIpt = kTile<T> / NT;   // items per consumer thread

// a tile's bytes and the 16-byte-aligned superset a slot holds
template <typename T>
constexpr int kSlot = kTile<T> * (int)sizeof(T) + 16;

// shared memory: the ring (reused by the tile's lists once every row is
// summed), one (offset, scale) header and two mbarriers per slot
template <typename T, bool kSelect>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int ring = STAGES * kSlot<T>;
  constexpr int lists = kSelect ? NW * MAX_SELECT * 8 : kTile<T> * 8;
  return (ring > lists ? ring : lists) + STAGES * 24;
}

// Where the rows lie.  Query q's row: q_base + q * q_pitch.  Neighbour
// j of query q: nbr_base + x * nbr_pitch, x = idx[q * k + j] (int32, or
// int64 when idx64) or, without idx, q * k + j; its int8 scale
// nbr_scale[x] when scale_by_idx, else nbr_scale[q * k + j].  Explicit
// addresses are int64 idx with base 0 and pitch 1.
struct Rows {
  unsigned long long q_base;
  long long q_pitch;
  const float* q_scale;
  unsigned long long nbr_base;
  long long nbr_pitch;
  const void* idx;
  const float* nbr_scale;
  int idx64;
  int scale_by_idx;
};

// the ends of the tensors that hold rows, where an end is not 16-byte
// aligned: a row that ends within 16 bytes of one is not read past it
struct RowEnds {
  unsigned long long end[MAX_ENDS];
  int n;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from a 16-byte-aligned global address into
// shared memory, completing on the barrier
__device__ __forceinline__ void bulk_copy(uint32_t dst,
                                          unsigned long long src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

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

// the tile item of a consumer thread's e-th value: f32 strided by NT (a
// warp reads 128 consecutive bytes), int8 in groups of 4 consecutive
// bytes a thread (a warp reads 128 consecutive bytes per group)
template <typename T>
__device__ __forceinline__ int item_slot(int t, int e) {
  if constexpr (sizeof(T) == 1) {
    return (e >> 2) * (4 * NT) + 4 * t + (e & 3);
  } else {
    return t + e * NT;
  }
}

// The producer warp: row j of the query into slot j % STAGES, once the
// consumers have released the slot's previous row.
template <typename T>
__device__ __forceinline__ void produce_rows(
    unsigned char* ring, int2* header, uint32_t full, uint32_t empty,
    const Rows& rows, const RowEnds& ends, long long qk, int k, int i0,
    int i1, int I, int lane) {
  constexpr int S = STAGES;
  constexpr unsigned long long SZ = sizeof(T);
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    unsigned long long my_row = 0ull;
    float my_scale = 1.0f;
    if (j < k) {
      long long x = qk + j;
      if (rows.idx != nullptr) {
        x = rows.idx64 ? reinterpret_cast<const long long*>(rows.idx)[x]
                       : reinterpret_cast<const int*>(rows.idx)[x];
      }
      my_row = rows.nbr_base + x * rows.nbr_pitch;
      if (sizeof(T) == 1) {
        my_scale = rows.nbr_scale[rows.scale_by_idx ? x : qk + j];
      }
    }
    const int n = min(32, k - j0);
    for (int t = 0; t < n; ++t) {
      const int jj = j0 + t;
      const int slot = jj % S;
      const unsigned long long row = __shfl_sync(FULL_MASK, my_row, t);
      const float scale = __shfl_sync(FULL_MASK, my_scale, t);
      if (jj >= S) mbar_wait(empty + 8 * slot, ((jj / S) - 1) & 1);
      const unsigned long long start = row + i0 * SZ;
      const unsigned long long end = row + i1 * SZ;
      const unsigned long long row_end = row + I * SZ;
      unsigned long long limit = (row_end + 15) & ~15ull;
      for (int e = 0; e < ends.n; ++e) {
        if (ends.end[e] > row && ends.end[e] < limit) limit = row_end;
      }
      const unsigned long long a0 = start & ~15ull;
      unsigned long long b1 = (end + 15) & ~15ull;
      if (b1 > limit) b1 = end & ~15ull;
      const uint32_t nbytes = (uint32_t)(b1 - a0);
      const int tail = end > b1 ? (int)((end - b1) / SZ) : 0;
      unsigned char* dst = ring + slot * kSlot<T>;
      if (lane < tail) {
        reinterpret_cast<T*>(dst + nbytes)[lane] =
            reinterpret_cast<const T*>(b1)[lane];
        // order these writes before a later bulk copy into the slot
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      if (lane == 0) {
        header[slot] = make_int2((int)(start - a0), __float_as_int(scale));
        mbar_arrive_expect_tx(full + 8 * slot, nbytes);
        if (nbytes > 0) bulk_copy(smem_u32(dst), a0, nbytes, full + 8 * slot);
      } else {
        mbar_arrive(full + 8 * slot);
      }
    }
  }
}

// The consumer warps: every row of the tile into acc, in order j.
template <typename T>
__device__ __forceinline__ void consume_rows(float (&acc)[kIpt<T>],
                                             const unsigned char* ring,
                                             const int2* header,
                                             uint32_t full, uint32_t empty,
                                             int k, int tid) {
  constexpr int S = STAGES;
  for (int j = 0; j < k; ++j) {
    const int slot = j % S;
    mbar_wait(full + 8 * slot, (j / S) & 1);
    const int2 h = header[slot];
    const unsigned char* base = ring + slot * kSlot<T>;
    if constexpr (sizeof(T) == 1) {
      const float scale = __int_as_float(h.y);
#pragma unroll
      for (int g = 0; g < kIpt<T> / 4; ++g) {
        const int off = h.x + g * (4 * NT) + 4 * tid;
        const uint32_t* w =
            reinterpret_cast<const uint32_t*>(base) + (off >> 2);
        // the group's 4 bytes, each biased to 0x4B0000xx = 2^23 + v + 128
        const uint32_t b = __funnelshift_r(w[0], w[1], (off & 3) * 8) ^
                           0x80808080u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = __fsub_rn(
              __int_as_float(__byte_perm(b, 0x4B000000u, 0x7540 + e)),
              8388736.0f);
          acc[4 * g + e] = __fadd_rn(acc[4 * g + e], __fmul_rn(v, scale));
        }
      }
    } else {
      const float* r = reinterpret_cast<const float*>(base + h.x);
#pragma unroll
      for (int e = 0; e < kIpt<T>; ++e) {
        acc[e] = __fadd_rn(acc[e], r[tid + e * NT]);
      }
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty + 8 * slot);
  }
}

// (bv, bi) := the better of itself and every lane's
__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, bv, off);
    const int oi = __shfl_xor_sync(FULL_MASK, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

// The tile's best L (<= 32) of the consumers' pv/pi, descending, into
// out_v/out_i: each warp takes its best L by L warp argmaxes into wv/wi
// [NW][MAX_SELECT]; warp 0 merges the NW lists the same way.
template <int IPT>
__device__ __forceinline__ void select_tile(float (&pv)[IPT], int (&pi)[IPT],
                                            float* wv, int* wi, int L,
                                            float* out_v, int* out_i,
                                            int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < NW) {
    for (int r = 0; r < L; ++r) {
      float bv = pv[0];
      int bi = pi[0];
#pragma unroll
      for (int e = 1; e < IPT; ++e) {
        if (better(pv[e], pi[e], bv, bi)) {
          bv = pv[e];
          bi = pi[e];
        }
      }
      warp_best(bv, bi);
#pragma unroll
      for (int e = 0; e < IPT; ++e) {
        if (pi[e] == bi) {
          pv[e] = -INFINITY;
          pi[e] = PAD_IDX;
        }
      }
      if (lane == 0) {
        wv[warp * MAX_SELECT + r] = bv;
        wi[warp * MAX_SELECT + r] = bi;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {
    int head = 0;
    for (int r = 0; r < L; ++r) {
      const bool live = lane < NW && head < L;
      float bv = live ? wv[lane * MAX_SELECT + head] : -INFINITY;
      int bi = live ? wi[lane * MAX_SELECT + head] : PAD_IDX;
      const int mine = bi;
      warp_best(bv, bi);
      if (live && mine == bi) ++head;
      if (lane == 0) {
        out_v[r] = bv;
        out_i[r] = bi;
      }
    }
  }
}

// Blend the tile's sums with the query row and keep the tile's best L
// in part_*: called by every thread of the block once the sums are done
// (threads >= NT hold none); lists: shared memory free for them.
template <typename T, bool kSelect>
__device__ __forceinline__ void finish_tile(
    const float (&acc)[kIpt<T>], const Rows& rows, unsigned char* lists,
    int I, int k,
    float alpha, float one_minus_alpha, int L, float* __restrict__ part_v,
    int* __restrict__ part_i) {
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int IPT = kIpt<T>;
  const int tile = blockIdx.x;
  const int qq = blockIdx.y;
  const int tid = threadIdx.x;
  const int i0 = tile * kTile<T>;
  float pv[IPT];
  int pi[IPT];
  const unsigned long long own = rows.q_base + qq * rows.q_pitch;
  const float own_scale = kInt8 ? rows.q_scale[qq] : 1.0f;
  const float kf = (float)k;
#pragma unroll
  for (int e = 0; e < IPT; ++e) {
    const int i = i0 + item_slot<T>(tid, e);
    if (tid < NT && i < I) {
      const float x = row_value<kInt8>(own, i, own_scale);
      pv[e] = __fadd_rn(__fmul_rn(alpha, x),
                        __fmul_rn(one_minus_alpha, __fdiv_rn(acc[e], kf)));
      pi[e] = i;
    } else {
      pv[e] = -INFINITY;
      pi[e] = PAD_IDX;
    }
  }
  __syncthreads();   // every row summed: the lists take over the ring
  const size_t o = ((size_t)qq * gridDim.x + tile) * L;
  float* lv = reinterpret_cast<float*>(lists);
  if constexpr (kSelect) {
    select_tile(pv, pi, lv, reinterpret_cast<int*>(lv + NW * MAX_SELECT), L,
                part_v + o, part_i + o, tid);
  } else {
    int* li = reinterpret_cast<int*>(lv + kTile<T>);
    if (tid < NT) {
#pragma unroll
      for (int e = 0; e < IPT; ++e) {
        lv[item_slot<T>(tid, e)] = pv[e];
        li[item_slot<T>(tid, e)] = pi[e];
      }
    }
    __syncthreads();
    bitonic_sort_desc<true>(lv, li, kTile<T>, tid, blockDim.x);
    for (int t = tid; t < L; t += blockDim.x) {
      part_v[o + t] = lv[t];
      part_i[o + t] = li[t];
    }
  }
}

template <typename T, bool kSelect>
__global__ void __launch_bounds__(THREADS) rows_ring_kernel(
    const Rows rows, const RowEnds ends, int I, int k,
    float alpha, float one_minus_alpha, int L, float* __restrict__ part_v,
    int* __restrict__ part_i) {
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int S = STAGES;
  constexpr int BODY = smem_bytes<T, kSelect>() - S * 24;
  extern __shared__ __align__(128) unsigned char rows_smem[];
  int2* header = reinterpret_cast<int2*>(rows_smem + BODY);
  const uint32_t full = smem_u32(header + S);
  const uint32_t empty = full + 8 * S;

  const int qq = blockIdx.y;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kTile<T>;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[kIpt<T>];
#pragma unroll
  for (int e = 0; e < kIpt<T>; ++e) acc[e] = 0.0f;
  if (tid >= NT) {
    produce_rows<T>(rows_smem, header, full, empty, rows, ends,
                    (long long)qq * k, k, i0, min(I, i0 + kTile<T>), I,
                    tid - NT);
  } else {
    consume_rows<T>(acc, rows_smem, header, full, empty, k, tid);
  }

  finish_tile<T, kSelect>(acc, rows, rows_smem, I, k, alpha,
                          one_minus_alpha, L, part_v, part_i);
}

template <typename T, bool kSelect>
cudaError_t launch_tiles(const Rows& rows, const RowEnds& ends, int Q,
                         int I, int k, float alpha, float one_minus_alpha,
                         int L, void* part_v, void* part_i, cudaStream_t st) {
  constexpr int smem = smem_bytes<T, kSelect>();
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)rows_ring_kernel<T, kSelect>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((I + kTile<T> - 1) / kTile<T>, Q);
  rows_ring_kernel<T, kSelect><<<grid, THREADS, smem, st>>>(
      rows, ends, I, k, alpha, one_minus_alpha, L, (float*)part_v,
      (int*)part_i);
  return cudaGetLastError();
}

}  // namespace

// The row blend of Q queries over rows of I elements (int8 when int8 !=
// 0, with the scales q_scale f32[Q] and nbr_scale; else f32 and both
// scales null), the rows where the fields of Rows (above) say: query q
// at q_base + q * q_pitch, neighbour j at nbr_base + x * nbr_pitch.
// The tensors holding the neighbour rows start 16-byte aligned; ends:
// host array of the n_ends (<= 16) of them whose end is not.  part_*:
// scratch [Q, n_tiles, L] with L = min(topn, tile), n_tiles = ceil(I /
// tile), tile = kTile of the element type; out_*: [Q, topn]; n2 = power
// of two >= max(L, topn), at most 1024.  smem: the tile kernel's
// shared-memory bytes as the wrapper planned them (refused if they
// differ from this file's).
extern "C" int blend_rows_launch(
    const void* q_base, long long q_pitch, const void* q_scale,
    const void* nbr_base, long long nbr_pitch, const void* idx, int idx64,
    const void* nbr_scale, int scale_by_idx, int int8, int Q, int I, int k,
    float alpha, float one_minus_alpha, int topn, int L, int n2,
    const void* ends, int n_ends, int smem, void* part_v, void* part_i,
    void* out_v, void* out_i, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_ends < 0 || n_ends > MAX_ENDS || k < 1 || L < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Rows rows{(unsigned long long)q_base, q_pitch,
                  (const float*)q_scale, (unsigned long long)nbr_base,
                  nbr_pitch, idx, (const float*)nbr_scale, idx64,
                  scale_by_idx};
  RowEnds e{};
  e.n = n_ends;
  for (int i = 0; i < n_ends; ++i) {
    e.end[i] = ((const unsigned long long*)ends)[i];
  }
  const bool select = topn <= MAX_SELECT;
  const int want = int8 ? (select ? smem_bytes<int8_t, true>()
                                  : smem_bytes<int8_t, false>())
                        : (select ? smem_bytes<float, true>()
                                  : smem_bytes<float, false>());
  if (smem != want) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (int8) {
    err = select ? launch_tiles<int8_t, true>(rows, e, Q, I, k, alpha,
                                              one_minus_alpha, L, part_v,
                                              part_i, st)
                 : launch_tiles<int8_t, false>(rows, e, Q, I, k, alpha,
                                               one_minus_alpha, L, part_v,
                                               part_i, st);
  } else {
    err = select ? launch_tiles<float, true>(rows, e, Q, I, k, alpha,
                                             one_minus_alpha, L, part_v,
                                             part_i, st)
                 : launch_tiles<float, false>(rows, e, Q, I, k, alpha,
                                              one_minus_alpha, L, part_v,
                                              part_i, st);
  }
  if (err != cudaSuccess) return (int)err;
  const int tile = int8 ? kTile<int8_t> : kTile<float>;
  const int n_tiles = (I + tile - 1) / tile;
  merge_lists_kernel<<<Q, 256, (size_t)n2 * 8, st>>>(
      (const float*)part_v, (const int*)part_i, n_tiles, L, n2, topn,
      (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}
