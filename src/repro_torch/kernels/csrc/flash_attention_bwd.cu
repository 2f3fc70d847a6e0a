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
// The CUDA-core design of flash_attention.plan_flash_bwd, for every input
// that flash_attention_bwd_wgmma.cu (the Hopper design, which reads the
// forward's saved log-sum-exp and output) does not take: f32, D other
// than 64 and 128, rows off a 16-byte boundary, and a forward that saved
// no log-sum-exp.  Tiles of BT = 64 rows (32 at D > 128, where four f32
// tiles of 64 would not fit in shared memory) staged as f32 with a row
// pitch of DP + 1 floats; 256 threads, thread (ty, tx) owns rows R*ty ..
// R*ty + R - 1 (R = BT / 16) and columns tx + 16j of each score tile and
// the output dims tx + 16j; dS stays f32.  The entry refuses inputs and
// shared bytes other than the plan's.
//
// Bound: operations.  5 products of 2*D flops per unmasked (query, key)
// pair are the gradient's own work (2.5x the forward's); this design also
// recomputes Q.K^T and dO.V^T in launch 1 and again in launches 2 and 3
// (9 products in all), on the f32 cores, 1/15th of the bf16 tensor-core
// peak.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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

// The CUDA-core design of flash_attention.plan_flash_bwd ("cuda_cores").
// Strides (batch, seq, head) in elements of q, k, v and dO, each with a
// contiguous last dim; dq [B, S, H, D] and dk, dv [B, S, KV, D] are
// contiguous outputs in the inputs' dtype; lse and delta are f32 scratch of
// B*H*S each.  smem: the shared bytes of the stats, dK/dV and dQ kernels,
// which must be flash_attention.plan_flash_bwd's.  An input the kernels do
// not take (V's width Dv other than D among them), or other bytes,
// returns cudaErrorInvalidValue with nothing launched.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, float* lse, float* delta, int B, int S, int H,
    int KV, int D, int Dv, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss,
    long long osh, float scale, int causal, int window, int bf16,
    int smem_stats, int smem_dkdv, int smem_dq, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (D < 1 || D > 256 || Dv != D || KV < 1 || H % KV != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                   osb, oss, osh};
  const int smem[3] = {smem_stats, smem_dkdv, smem_dq};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_dtype<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, lse,
                                       delta, B, S, H, KV, D, st, scale,
                                       causal, window, smem, s);
  return launch_dtype<float>(q, k, v, dout, dq, dk, dv, lse, delta, B, S, H,
                             KV, D, st, scale, causal, window, smem, s);
}
