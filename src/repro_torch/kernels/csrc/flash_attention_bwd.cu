// flash_attention_bwd: the gradient of flash_attention (9b).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention on the training path, where that Pallas kernel has no
// backward: the JAX package takes attention's gradient by autodiff of the
// model-level blocked attention (repro/models/transformer.py ::
// _attend_block).  The port keeps the forward kernel in training, so its
// gradient is a kernel too.
//
// q [B, S, H, D], k and v [B, S, KV, D] (H % KV == 0), the output's
// gradient dO [B, S, H, D]; f32 or bf16; 1 <= D <= 256; causal and/or a
// sliding window as the forward takes them.  With s = q.k * scale (f32,
// scale = 1/sqrt(D)), masked s = -1e30, P = softmax(s):
//   dV = round(P)^T . dO      (P rounded to the V dtype, as the forward
//                              rounds it before P . V)
//   dP = dO . V^T,  Delta = sum_j P_j dP_j  (per query row)
//   dS = P o (dP - Delta)
//   dQ = dS . K * scale,  dK = dS^T . Q * scale
// Delta is the softmax's own vjp term (sum P . dP), not rowsum(dO o O): it
// needs no O and matches the autodiff of the JAX function in f32.
//
// FlashAttention-2's split in three launches, no atomics, so a gradient
// repeats bit for bit from run to run:
//   1. bwd_stats_kernel, one block per (batch*head, query tile): walks the
//      key tiles with an online max m, denominator l and t = sum p . dP
//      (rescaled with l), writing lse = m + log(l) and Delta = t / l for
//      every query row (f32 scratch [B*H, S]).
//   2. bwd_dkdv_kernel, one block per (batch*KV head, key tile): K and V
//      of the tile stay in shared memory; it walks its group's query heads
//      in head order and, for each, the query tiles that can see the tile,
//      accumulating dK and dV in registers, written once.
//   3. bwd_dq_kernel, one block per (batch*head, query tile): walks the
//      key tiles its rows see, accumulating dQ in registers.
// Every kernel skips the tiles that the causal mask or the window hide
// from the whole tile, as the forward does (flash_attention.FlashBwdPlan
// mirrors the ranges).
//
// Two designs of flash_attention.plan_flash_bwd; the wrapper passes the
// planned one and this entry refuses inputs it does not take.
//
// Tensor-core design (bwd_mma_*_kernel), bf16 with D in {64, 128} and
// 16-byte aligned rows (bases and strides multiples of 8 elements): 4 warps
// a block over 64-row tiles staged as bf16 by 16-byte vectors, every
// product on mma.sync m16n8k16 with f32 accumulators (the fragment code of
// flash_attention.cu's mma_sync design, mma_bf16.cuh).  A warp owns 16
// rows of the block's tile: 16 queries in the stats and dQ kernels, 16
// keys in the dK/dV kernel, which computes S^T = K.Q^T and dP^T = V.dO^T
// so that P^T and dS^T come out as its rows' fragments and feed dV += P^T
// . dO and dK += dS^T . Q straight from registers (P and dS rounded to
// bf16 there; at D = 128 it takes the query tile in halves of 32, which
// keeps its two [16, 128] accumulators and the scores in registers).  A
// warp skips a tile whose pairs the mask hides from all its rows.
//
// CUDA-core design (bwd_*_kernel) for every other input: tiles of BT = 64
// rows (32 at D > 128, where four f32 tiles of 64 would not fit in shared
// memory) staged as f32 with a row pitch of DP + 1 floats; 256 threads,
// thread (ty, tx) owns rows R*ty .. R*ty + R - 1 (R = BT / 16) and columns
// tx + 16j of each score tile and the output dims tx + 16j; dS stays f32.
//
// Bound: operations.  5 products of 2*D flops per unmasked (query, key)
// pair are the gradient's own work (2.5x the forward's); both designs also
// recompute Q.K^T and dO.V^T in launch 1 and again in launches 2 and 3 (9
// products in all).  The CUDA-core design runs on the f32 cores, 1/15th
// of the bf16 tensor-core peak; the tensor-core design on mma.sync (not
// wgmma), loading each tile between barriers with no overlap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// the tile geometry of D <= 16 * DC
template <int DC>
struct Tiles {
  static constexpr int DP = 16 * DC;          // D padded
  static constexpr int LD = DP + 1;           // staged row pitch (floats)
  static constexpr int BT = DC == 16 ? 32 : 64;
  static constexpr int R = BT / 16;           // rows (and columns) a thread
  static constexpr int LP = BT + 1;           // score tile pitch
  static constexpr int TILE = BT * LD;        // floats of a staged tile
};

template <int DC>
constexpr int stats_bytes() {
  return 4 * Tiles<DC>::TILE * 4;
}
template <int DC>
constexpr int dq_bytes() {
  return (4 * Tiles<DC>::TILE + Tiles<DC>::BT * Tiles<DC>::LP) * 4;
}
template <int DC>
constexpr int dkdv_bytes() {
  return (4 * Tiles<DC>::TILE + 2 * Tiles<DC>::BT * Tiles<DC>::LP +
          2 * Tiles<DC>::BT) * 4;
}

// rows [r0, r0 + BT) of one head (row stride rs, D contiguous) into a
// staged f32 tile, zero past S and past D
template <typename T, int DC>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      long long rs, int r0, int S, int D) {
  using TL = Tiles<DC>;
  for (int idx = threadIdx.x; idx < TL::BT * TL::DP; idx += THREADS) {
    const int r = idx / TL::DP, d = idx % TL::DP, p = r0 + r;
    dst[r * TL::LD + d] = (p < S && d < D) ? to_f(src[p * rs + d]) : 0.f;
  }
}

// a[i][j] = A[row i] . B[col j] and c[i][j] = C[row i] . E[col j] over the
// first D dims of staged tiles; row i = R*ty + i, col j = tx + 16j
template <int DC>
__device__ __forceinline__ void two_products(
    float (&a)[Tiles<DC>::R][Tiles<DC>::R],
    float (&c)[Tiles<DC>::R][Tiles<DC>::R], const float* A, const float* B,
    const float* C, const float* E, int D, int ty, int tx) {
  using TL = Tiles<DC>;
  constexpr int R = TL::R;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) a[i][j] = c[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float ra[R], rb[R], rc[R], re[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      ra[i] = A[(R * ty + i) * TL::LD + d];
      rc[i] = C[(R * ty + i) * TL::LD + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      rb[j] = B[(tx + 16 * j) * TL::LD + d];
      re[j] = E[(tx + 16 * j) * TL::LD + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        a[i][j] = fmaf(ra[i], rb[j], a[i][j]);
        c[i][j] = fmaf(rc[i], re[j], c[i][j]);
      }
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal,
                                        int window) {
  return qp < S && kp < S && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// the key tiles of BT rows a query tile from row q0 sees
// (FlashBwdPlan.key_tiles)
__device__ __forceinline__ void key_range(int q0, int BT, int S, int causal,
                                          int window, int& lo, int& hi) {
  const int q_last = min(q0 + BT, S) - 1;
  const int nk = (S + BT - 1) / BT;
  hi = causal ? min(nk - 1, q_last / BT) : nk - 1;
  lo = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BT : 0;
}

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS) bwd_stats_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    float* __restrict__ lse, float* __restrict__ delta, int S, int H,
    int KV, int D, Strides st, float scale, int causal, int window) {
  using TL = Tiles<DC>;
  constexpr int R = TL::R, BT = TL::BT;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + TL::TILE;
  float* Ks = Os + TL::TILE;
  float* Vs = Ks + TL::TILE;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* kb = k + b * st.kb + kvh * st.kh;
  const T* vb = v + b * st.vb + kvh * st.vh;
  stage<T, DC>(Qs, q + b * st.qb + h * st.qh, st.qs, q0, S, D);
  stage<T, DC>(Os, dout + b * st.ob + h * st.oh, st.os, q0, S, D);

  float m_i[R], l_i[R], t_i[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m_i[i] = -1e30f;
    l_i[i] = 0.f;
    t_i[i] = 0.f;
  }
  int kt_lo, kt_hi;
  key_range(q0, BT, S, causal, window, kt_lo, kt_hi);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();   // the previous tile's readers are done
    stage<T, DC>(Ks, kb, st.ks, k0, S, D);
    stage<T, DC>(Vs, vb, st.vs, k0, S, D);
    __syncthreads();
    float s[R][R], dp[R][R];
    two_products<DC>(s, dp, Qs, Ks, Os, Vs, D, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + R * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float x = s[i][j] * scale;
        s[i][j] = kp >= S ? -INFINITY
                          : (visible(qp, kp, S, causal, window) ? x : -1e30f);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.f, tsum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        tsum = fmaf(p, dp[i][j], tsum);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
      }
      l_i[i] = l_i[i] * alpha + sum;
      t_i[i] = t_i[i] * alpha + tsum;
      m_i[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + R * ty + i;
      if (qp >= S) continue;
      lse[(long long)bh * S + qp] = m_i[i] + logf(l_i[i]);
      delta[(long long)bh * S + qp] = t_i[i] / l_i[i];
    }
  }
}

// (THREADS, 1): with THREADS alone ptxas held the bf16 D > 128 instance to
// 80 registers and spilled
template <typename T, int DC>
__global__ void __launch_bounds__(THREADS, 1) bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int S, int H, int KV, int D, Strides st,
    float scale, int causal, int window) {
  using TL = Tiles<DC>;
  constexpr int R = TL::R, BT = TL::BT;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + TL::TILE;
  float* Ks = Os + TL::TILE;
  float* Vs = Ks + TL::TILE;
  float* Ss = Vs + TL::TILE;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* kb = k + b * st.kb + kvh * st.kh;
  const T* vb = v + b * st.vb + kvh * st.vh;
  stage<T, DC>(Qs, q + b * st.qb + h * st.qh, st.qs, q0, S, D);
  stage<T, DC>(Os, dout + b * st.ob + h * st.oh, st.os, q0, S, D);
  float lse_i[R], del_i[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + R * ty + i;
    lse_i[i] = qp < S ? lse[(long long)bh * S + qp] : 0.f;
    del_i[i] = qp < S ? delta[(long long)bh * S + qp] : 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }
  int kt_lo, kt_hi;
  key_range(q0, BT, S, causal, window, kt_lo, kt_hi);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();   // the previous tile's readers are done
    stage<T, DC>(Ks, kb, st.ks, k0, S, D);
    stage<T, DC>(Vs, vb, st.vs, k0, S, D);
    __syncthreads();
    float s[R][R], dp[R][R];
    two_products<DC>(s, dp, Qs, Ks, Os, Vs, D, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + R * ty + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float p = visible(qp, kp, S, causal, window)
                            ? expf(s[i][j] * scale - lse_i[i]) : 0.f;
        Ss[(R * ty + i) * TL::LP + tx + 16 * j] = p * (dp[i][j] - del_i[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float ds[R];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = Ss[(R * ty + i) * TL::LP + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float kv = Ks[kk * TL::LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + R * ty + i;
    if (qp >= S) continue;
    T* row = dq + (((long long)b * S + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int d = tx + 16 * j;
      if (d < D) row[d] = from_f<T>(acc[i][j] * scale);
    }
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS) bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV, int D,
    Strides st, float scale, int causal, int window) {
  using TL = Tiles<DC>;
  constexpr int R = TL::R, BT = TL::BT;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TL::TILE;
  float* Qs = Vs + TL::TILE;
  float* Os = Qs + TL::TILE;
  float* Ps = Os + TL::TILE;
  float* Ss = Ps + BT * TL::LP;
  float* Ls = Ss + BT * TL::LP;
  float* Dl = Ls + BT;

  const int bkv = blockIdx.x;
  const int b = bkv / KV, kvh = bkv % KV, group = H / KV;
  const int k0 = blockIdx.y * BT;
  const int k_last = min(k0 + BT, S) - 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  stage<T, DC>(Ks, k + b * st.kb + kvh * st.kh, st.ks, k0, S, D);
  stage<T, DC>(Vs, v + b * st.vb + kvh * st.vh, st.vs, k0, S, D);
  float acc_k[R][DC], acc_v[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // the query tiles that see this key tile (FlashBwdPlan.query_tiles)
  const int nq = (S + BT - 1) / BT;
  const int qt_lo = causal ? k0 / BT : 0;
  const int qt_hi = window > 0 ? min(nq - 1, (k_last + window - 1) / BT)
                               : nq - 1;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const long long bh = (long long)b * H + h;
    const T* qb = q + b * st.qb + h * st.qh;
    const T* ob = dout + b * st.ob + h * st.oh;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();   // the previous tile's readers are done
      stage<T, DC>(Qs, qb, st.qs, q0, S, D);
      stage<T, DC>(Os, ob, st.os, q0, S, D);
      if (tid < BT) {
        const int qp = q0 + tid;
        Ls[tid] = qp < S ? lse[bh * S + qp] : 0.f;
        Dl[tid] = qp < S ? delta[bh * S + qp] : 0.f;
      }
      __syncthreads();
      // rows: keys of this tile; columns: queries
      float s[R][R], dp[R][R];
      two_products<DC>(s, dp, Ks, Qs, Vs, Os, D, ty, tx);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kp = k0 + R * ty + i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int c = tx + 16 * j, qp = q0 + c;
          const float p = visible(qp, kp, S, causal, window)
                              ? expf(s[i][j] * scale - Ls[c]) : 0.f;
          Ps[(R * ty + i) * TL::LP + c] = to_f(from_f<T>(p));
          Ss[(R * ty + i) * TL::LP + c] = p * (dp[i][j] - Dl[c]);
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int qq = 0; qq < BT; ++qq) {
        float pr[R], sr[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pr[i] = Ps[(R * ty + i) * TL::LP + qq];
          sr[i] = Ss[(R * ty + i) * TL::LP + qq];
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          const float ov = Os[qq * TL::LD + tx + 16 * j];
          const float qv = Qs[qq * TL::LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc_v[i][j] = fmaf(pr[i], ov, acc_v[i][j]);
            acc_k[i][j] = fmaf(sr[i], qv, acc_k[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kp = k0 + R * ty + i;
    if (kp >= S) continue;
    const long long off = (((long long)b * S + kp) * KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dk[off + d] = from_f<T>(acc_k[i][j] * scale);
        dv[off + d] = from_f<T>(acc_v[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core design (mma.sync m16n8k16, f32 accumulate), D 64 or 128
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;           // 4 warps, 16 rows each
constexpr int MT = 64;                     // rows of a tile
constexpr int MMA_PAD = 8;                 // bf16 per smem row: 16-byte pad

template <int D>
__host__ __device__ constexpr int mma_tile() {   // bf16 of a staged tile
  return MT * (D + MMA_PAD);
}
template <int D>
constexpr int mma_bytes(int kernel) {      // 0 stats, 1 dK/dV, 2 dQ
  return 4 * mma_tile<D>() * 2 + (kernel == 1 ? 2 * MT * 4 : 0);
}

// rows [r0, r0 + 64) of one head (row stride rs, D contiguous) into smem
// rows of D + 8 bf16, zero past S; 16-byte vectors
template <int D>
__device__ __forceinline__ void mma_stage(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int r0, int S) {
  constexpr int LD = D + MMA_PAD, VPR = D / 8;
  for (int i = threadIdx.x; i < MT * VPR; i += MMA_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// a[j] = A[rows ra..ra+15] . B[rows cb + 8j..]^T and c[j] = C[..] . E[..]^T
// over D: a warp's 16 rows against 8*NB rows of another tile, as mma
// accumulator fragments (row quad (+8), columns 8j + 2tq (+1))
template <int D, int NB>
__device__ __forceinline__ void mma_two_products(
    float (&a)[NB][4], float (&c)[NB][4], const __nv_bfloat16* A,
    const __nv_bfloat16* B, const __nv_bfloat16* C, const __nv_bfloat16* E,
    int ra, int cb, int lane) {
  constexpr int LD = D + MMA_PAD;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = c[j][e] = 0.f;
  const int r = ra + (lane & 15), co = (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    unsigned fa[4], fc[4];
    ldsm_x4(fa[0], fa[1], fa[2], fa[3], A + r * LD + ks * 16 + co);
    ldsm_x4(fc[0], fc[1], fc[2], fc[3], C + r * LD + ks * 16 + co);
#pragma unroll
    for (int jj = 0; jj < NB / 2; ++jj) {
      const int row = cb + jj * 16 + (lane >> 4) * 8 + (lane & 7);
      const int d = ks * 16 + ((lane >> 3) & 1) * 8;
      unsigned b0, b1, b2, b3;
      ldsm_x4(b0, b1, b2, b3, B + row * LD + d);
      mma_bf16(a[2 * jj], fa, b0, b1);
      mma_bf16(a[2 * jj + 1], fa, b2, b3);
      ldsm_x4(b0, b1, b2, b3, E + row * LD + d);
      mma_bf16(c[2 * jj], fc, b0, b1);
      mma_bf16(c[2 * jj + 1], fc, b2, b3);
    }
  }
}

// acc[n] += X . M[rows mb .. mb + 16NK): X the warp's 16 rows x 16NK
// columns given as accumulator fragments x (rounded to bf16 here), M's
// rows the product's depth and its D columns the output's
template <int D, int NK>
__device__ __forceinline__ void mma_accumulate(float (&acc)[D / 8][4],
                                               const float (&x)[2 * NK][4],
                                               const __nv_bfloat16* M,
                                               int mb, int lane) {
  constexpr int LD = D + MMA_PAD;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const unsigned pa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const int row = mb + kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      unsigned b0, b1, b2, b3;
      ldsm_x4_t(b0, b1, b2, b3, M + row * LD + nn * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * nn], pa, b0, b1);
      mma_bf16(acc[2 * nn + 1], pa, b2, b3);
    }
  }
}

// a warp's 16 query rows [qf, qf + 15] see no key of [k0, k0 + 63]
__device__ __forceinline__ bool keys_hidden(int qf, int k0, int causal,
                                            int window) {
  return (causal && k0 > qf + 15) || (window > 0 && k0 + 63 <= qf - window);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) bwd_mma_stats_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, float* __restrict__ lse,
    float* __restrict__ delta, int S, int H, int KV, Strides st,
    float scale, int causal, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Os = Qs + mma_tile<D>();
  __nv_bfloat16* Ks = Os + mma_tile<D>();
  __nv_bfloat16* Vs = Ks + mma_tile<D>();

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* kb = k + b * st.kb + kvh * st.kh;
  const __nv_bfloat16* vb = v + b * st.vb + kvh * st.vh;
  mma_stage<D>(Qs, q + b * st.qb + h * st.qh, st.qs, q0, S);
  mma_stage<D>(Os, dout + b * st.ob + h * st.oh, st.os, q0, S);

  const int qf = q0 + warp * 16, row0 = qf + quad;
  float m_i[2] = {-1e30f, -1e30f}, l_i[2] = {0.f, 0.f}, t_i[2] = {0.f, 0.f};
  int kt_lo, kt_hi;
  key_range(q0, MT, S, causal, window, kt_lo, kt_hi);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * MT;
    __syncthreads();   // the previous tile's readers are done
    mma_stage<D>(Ks, kb, st.ks, k0, S);
    mma_stage<D>(Vs, vb, st.vs, k0, S);
    __syncthreads();
    if (keys_hidden(qf, k0, causal, window)) continue;
    float s[8][4], dp[8][4];
    mma_two_products<D, 8>(s, dp, Qs, Ks, Os, Vs, warp * 16, 0, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = row0 + (e >> 1) * 8, kp = k0 + j * 8 + tq * 2 + (e & 1);
        const float x = s[j][e] * scale;
        s[j][e] = kp >= S ? -INFINITY
                          : (visible(qp, kp, S, causal, window) ? x : -1e30f);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f}, tsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = expf(m_i[r] - m_new);
      m_i[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_i[e >> 1]);
        sum[e >> 1] += p;
        tsum[e >> 1] = fmaf(p, dp[j][e], tsum[e >> 1]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      for (int off = 1; off <= 2; off <<= 1) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
        tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], off);
      }
      l_i[r] = l_i[r] * alpha[r] + sum[r];
      t_i[r] = t_i[r] * alpha[r] + tsum[r];
    }
  }
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + r * 8;
      if (qp >= S) continue;
      lse[(long long)bh * S + qp] = m_i[r] + logf(l_i[r]);
      delta[(long long)bh * S + qp] = t_i[r] / l_i[r];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) bwd_mma_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int S,
    int H, int KV, Strides st, float scale, int causal, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Os = Qs + mma_tile<D>();
  __nv_bfloat16* Ks = Os + mma_tile<D>();
  __nv_bfloat16* Vs = Ks + mma_tile<D>();

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* kb = k + b * st.kb + kvh * st.kh;
  const __nv_bfloat16* vb = v + b * st.vb + kvh * st.vh;
  mma_stage<D>(Qs, q + b * st.qb + h * st.qh, st.qs, q0, S);
  mma_stage<D>(Os, dout + b * st.ob + h * st.oh, st.os, q0, S);

  const int qf = q0 + warp * 16, row0 = qf + quad;
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + r * 8;
    lse_r[r] = qp < S ? lse[(long long)bh * S + qp] : 0.f;
    del_r[r] = qp < S ? delta[(long long)bh * S + qp] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  int kt_lo, kt_hi;
  key_range(q0, MT, S, causal, window, kt_lo, kt_hi);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * MT;
    __syncthreads();   // the previous tile's readers are done
    mma_stage<D>(Ks, kb, st.ks, k0, S);
    mma_stage<D>(Vs, vb, st.vs, k0, S);
    __syncthreads();
    if (keys_hidden(qf, k0, causal, window)) continue;
    float s[8][4], dp[8][4];
    mma_two_products<D, 8>(s, dp, Qs, Ks, Os, Vs, warp * 16, 0, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, qp = row0 + r * 8;
        const int kp = k0 + j * 8 + tq * 2 + (e & 1);
        const float p = visible(qp, kp, S, causal, window)
                            ? expf(s[j][e] * scale - lse_r[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - del_r[r]);           // dS
      }
    mma_accumulate<D, 4>(acc, s, Ks, 0, lane);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + r * 8;
    if (qp >= S) continue;
    __nv_bfloat16* row = dq + (((long long)b * S + qp) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + tq * 2) =
          __floats2bfloat162_rn(acc[n][2 * r] * scale,
                                acc[n][2 * r + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) bwd_mma_dkdv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int S, int H, int KV, Strides st,
    float scale, int causal, int window) {
  constexpr int QS = D == 128 ? 32 : 64;   // queries a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + mma_tile<D>();
  __nv_bfloat16* Qs = Vs + mma_tile<D>();
  __nv_bfloat16* Os = Qs + mma_tile<D>();
  float* Ls = reinterpret_cast<float*>(Os + mma_tile<D>());
  float* Dl = Ls + MT;

  const int bkv = blockIdx.x;
  const int b = bkv / KV, kvh = bkv % KV, group = H / KV;
  const int k0 = blockIdx.y * MT;
  const int k_last = min(k0 + MT, S) - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane >> 2, tq = lane & 3;
  mma_stage<D>(Ks, k + b * st.kb + kvh * st.kh, st.ks, k0, S);
  mma_stage<D>(Vs, v + b * st.vb + kvh * st.vh, st.vs, k0, S);
  const int kf = k0 + warp * 16, krow0 = kf + quad;
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const int nq = (S + MT - 1) / MT;
  const int qt_lo = causal ? k0 / MT : 0;
  const int qt_hi = window > 0 ? min(nq - 1, (k_last + window - 1) / MT)
                               : nq - 1;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const long long bh = (long long)b * H + h;
    const __nv_bfloat16* qb = q + b * st.qb + h * st.qh;
    const __nv_bfloat16* ob = dout + b * st.ob + h * st.oh;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * MT;
      __syncthreads();   // the previous tile's readers are done
      mma_stage<D>(Qs, qb, st.qs, q0, S);
      mma_stage<D>(Os, ob, st.os, q0, S);
      if (threadIdx.x < MT) {
        const int qp = q0 + threadIdx.x;
        Ls[threadIdx.x] = qp < S ? lse[bh * S + qp] : 0.f;
        Dl[threadIdx.x] = qp < S ? delta[bh * S + qp] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int half = 0; half < MT / QS; ++half) {
        const int qs0 = q0 + half * QS;
        // every query of the pass before every key of the warp, or every
        // key too old for every query
        if ((causal && qs0 + QS - 1 < kf) ||
            (window > 0 && kf + 15 <= qs0 - window))
          continue;
        // rows: the warp's 16 keys; columns: the pass's queries
        float s[QS / 8][4], dp[QS / 8][4];
        mma_two_products<D, QS / 8>(s, dp, Ks, Qs, Vs, Os, warp * 16,
                                    half * QS, lane);
#pragma unroll
        for (int j = 0; j < QS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = krow0 + (e >> 1) * 8;
            const int c = half * QS + j * 8 + tq * 2 + (e & 1);
            const float p = visible(q0 + c, kp, S, causal, window)
                                ? expf(s[j][e] * scale - Ls[c]) : 0.f;
            s[j][e] = p;                                 // P^T
            dp[j][e] = p * (dp[j][e] - Dl[c]);          // dS^T
          }
        mma_accumulate<D, QS / 16>(acc_v, s, Os, half * QS, lane);
        mma_accumulate<D, QS / 16>(acc_k, dp, Qs, half * QS, lane);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = krow0 + r * 8;
    if (kp >= S) continue;
    const long long off = (((long long)b * S + kp) * KV + kvh) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8 + tq * 2) =
          __floats2bfloat162_rn(acc_k[n][2 * r] * scale,
                                acc_k[n][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8 + tq * 2) =
          __floats2bfloat162_rn(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int DC>
int launch_bwd(const void* q, const void* k, const void* v,
               const void* dout, void* dq, void* dk, void* dv, float* lse,
               float* delta, int B, int S, int H, int KV, int D,
               const Strides& st, float scale, int causal, int window,
               const int* smem, cudaStream_t stream) {
  constexpr int BT = Tiles<DC>::BT;
  if (smem[0] != stats_bytes<DC>() || smem[1] != dkdv_bytes<DC>() ||
      smem[2] != dq_bytes<DC>())
    return (int)cudaErrorInvalidValue;
  auto stats = bwd_stats_kernel<T, DC>;
  auto dkdv = bwd_dkdv_kernel<T, DC>;
  auto dqk = bwd_dq_kernel<T, DC>;
  cudaError_t err = set_smem(stats, smem[0]);
  if (err == cudaSuccess) err = set_smem(dkdv, smem[1]);
  if (err == cudaSuccess) err = set_smem(dqk, smem[2]);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((S + BT - 1) / BT);
  const T* tq = (const T*)q;
  const T* tk = (const T*)k;
  const T* tv = (const T*)v;
  const T* to = (const T*)dout;
  stats<<<dim3((unsigned)(B * H), tiles), THREADS, smem[0], stream>>>(
      tq, tk, tv, to, lse, delta, S, H, KV, D, st, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv<<<dim3((unsigned)(B * KV), tiles), THREADS, smem[1], stream>>>(
      tq, tk, tv, to, lse, delta, (T*)dk, (T*)dv, S, H, KV, D, st, scale,
      causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3((unsigned)(B * H), tiles), THREADS, smem[2], stream>>>(
      tq, tk, tv, to, lse, delta, (T*)dq, S, H, KV, D, st, scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, float* lse, float* delta,
               int B, int S, int H, int KV, const Strides& st, float scale,
               int causal, int window, const int* smem,
               cudaStream_t stream) {
  if (smem[0] != mma_bytes<D>(0) || smem[1] != mma_bytes<D>(1) ||
      smem[2] != mma_bytes<D>(2))
    return (int)cudaErrorInvalidValue;
  auto stats = bwd_mma_stats_kernel<D>;
  auto dkdv = bwd_mma_dkdv_kernel<D>;
  auto dqk = bwd_mma_dq_kernel<D>;
  cudaError_t err = set_smem(stats, smem[0]);
  if (err == cudaSuccess) err = set_smem(dkdv, smem[1]);
  if (err == cudaSuccess) err = set_smem(dqk, smem[2]);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  const unsigned tiles = (unsigned)((S + MT - 1) / MT);
  const bf* tq = (const bf*)q;
  const bf* tk = (const bf*)k;
  const bf* tv = (const bf*)v;
  const bf* to = (const bf*)dout;
  stats<<<dim3((unsigned)(B * H), tiles), MMA_THREADS, smem[0], stream>>>(
      tq, tk, tv, to, lse, delta, S, H, KV, st, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv<<<dim3((unsigned)(B * KV), tiles), MMA_THREADS, smem[1], stream>>>(
      tq, tk, tv, to, lse, delta, (bf*)dk, (bf*)dv, S, H, KV, st, scale,
      causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3((unsigned)(B * H), tiles), MMA_THREADS, smem[2], stream>>>(
      tq, tk, tv, to, lse, delta, (bf*)dq, S, H, KV, st, scale, causal,
      window);
  return (int)cudaGetLastError();
}

// the tensor-core design reads and writes 16-byte vectors and bf16 pairs:
// bf16 with D 64 or 128, every base 16-byte aligned, every stride a
// positive multiple of 8 elements
bool mma_ok(const void* const* ptrs, int D, int bf16, const Strides& st) {
  if (!bf16 || (D != 64 && D != 128)) return false;
  for (int i = 0; i < 7; ++i)
    if ((uintptr_t)ptrs[i] % 16 != 0) return false;
  for (long long x : {st.qb, st.qs, st.qh, st.kb, st.ks, st.kh, st.vb, st.vs,
                      st.vh, st.ob, st.os, st.oh})
    if (x <= 0 || x % 8 != 0) return false;
  return true;
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v,
                 const void* dout, void* dq, void* dk, void* dv, float* lse,
                 float* delta, int B, int S, int H, int KV, int D,
                 const Strides& st, float scale, int causal, int window,
                 const int* smem, cudaStream_t s) {
  if (D <= 32)
    return launch_bwd<T, 2>(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H,
                            KV, D, st, scale, causal, window, smem, s);
  if (D <= 64)
    return launch_bwd<T, 4>(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H,
                            KV, D, st, scale, causal, window, smem, s);
  if (D <= 128)
    return launch_bwd<T, 8>(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H,
                            KV, D, st, scale, causal, window, smem, s);
  return launch_bwd<T, 16>(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H,
                           KV, D, st, scale, causal, window, smem, s);
}

}  // namespace

// strides (batch, seq, head) in elements of q, k, v and dO, each with a
// contiguous last dim; dq [B, S, H, D] and dk, dv [B, S, KV, D] are
// contiguous outputs in the inputs' dtype; lse and delta are f32 scratch of
// B*H*S each.  design 0 is the CUDA-core kernels (any input), 1 the
// mma.sync kernels; smem: the shared bytes of the stats, dK/dV and dQ
// kernels, which must be flash_attention.plan_flash_bwd's.  An input the
// design does not take, or other bytes, returns cudaErrorInvalidValue with
// nothing launched.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, float* lse, float* delta, int B, int S, int H,
    int KV, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss,
    long long osh, float scale, int causal, int window, int bf16,
    int design, int smem_stats, int smem_dkdv, int smem_dq, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (D < 1 || D > 256 || KV < 1 || H % KV != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                   osb, oss, osh};
  const int smem[3] = {smem_stats, smem_dkdv, smem_dq};
  cudaStream_t s = (cudaStream_t)stream;
  if (design == 1) {
    const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
    if (!mma_ok(ptrs, D, bf16, st)) return (int)cudaErrorInvalidValue;
    if (D == 64)
      return launch_mma<64>(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H,
                            KV, st, scale, causal, window, smem, s);
    return launch_mma<128>(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H,
                           KV, st, scale, causal, window, smem, s);
  }
  if (design != 0) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_dtype<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, lse,
                                       delta, B, S, H, KV, D, st, scale,
                                       causal, window, smem, s);
  return launch_dtype<float>(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H,
                             KV, D, st, scale, causal, window, smem, s);
}
