// flash_attention: causal (optionally sliding-window) softmax attention.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention: q [B, S, H, D], k and v [B, S, KV, D] with
// H % KV == 0 (query head h reads KV head h / (H/KV); KV == H is the
// JAX kernel's contract), out [B, S, H, D] in q's dtype, f32 or bf16.
//   s = (q . k) * scale                      f32, scale = 1/sqrt(D)
//   masked (kpos > qpos, or kpos <= qpos - window when window > 0) -> -1e30
//   online softmax over K/V tiles with f32 running max m, denominator l
//   and accumulator acc; p is rounded to the V dtype before P . V, l sums
//   the unrounded p; out = acc / max(l, 1e-30).
// These follow the Pallas kernel's _kernel line for line.  Key positions
// past S (the ragged last tile) score -inf and so add exactly nothing.
//
// Two of the three designs of flash_attention.plan_flash; the wrapper
// passes the planned one and this entry refuses inputs it does not take.
// bf16 with D in {64, 128} (aligned) runs the Hopper design of
// flash_attention_wgmma.cu; bf16 with D = 32 and 16-byte aligned rows the
// tensor-core design here; everything else the CUDA-core design.
//
// CUDA-core design (flash_kernel): one block of 256 threads per
// (batch*head, 64-query tile), staging Q, K and V in shared memory as
// f32.  Thread (ty, tx) owns rows 4ty..4ty+3: it computes scores for keys
// tx + 16j (j < 4) and the outputs d = tx + 16j (j < D_pad/16); the 16
// threads of a row reduce max and sum by warp shuffles.  Any D <= 256.
//
// Tensor-core design (flash_mma_kernel, D = 32): one block of 4 warps per
// (batch*head, 64-query tile), each warp 16 query rows.  Q's fragments
// stay in registers (ldmatrix once); each 64-key tile of K and V is
// copied to shared memory in 16-byte vectors, S = Q K^T and O += P V run
// as mma.sync m16n8k16 bf16 with f32 accumulators (V through
// ldmatrix.trans), and the softmax works on the accumulator fragments,
// a quad of lanes sharing each row.  P is packed to bf16 (round to
// nearest) straight from the S fragments, which is the rounding the TPU
// kernel applies before P . V.
//
// Both: the query tiles run last-first so the longest causal rows start
// first; a block walks the 64-key tiles from the first one its window
// reaches to the last one its causal mask reaches (the tiles skipped are
// fully masked for every row of the tile, so the result is the same).
//
// Bound: operations.  2 * 2 * D flops per unmasked (query, key) pair
// (QK^T and P.V) at the bf16 tensor-core peak.  The CUDA-core design runs
// on the f32 cores, 1/15th of that peak; the tensor-core design uses
// mma.sync (not wgmma) and loads each K/V tile without overlapping it
// with the products (at D = 64 it ran granite-3-2b's prefill attention in
// 1.95 ms against 0.28, which the Hopper design took over).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LDP = BK + 1;

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

template <int DC>
constexpr int smem_floats() {
  return BQ * (16 * DC + 1) + BK * (16 * DC + 1) + BK * 16 * DC + BQ * LDP;
}

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int S, int H, int KV,
    int D, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, float scale, int causal, int window) {
  constexpr int DP = 16 * DC;
  constexpr int LDQ = DP + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDQ;
  float* Ps = Vs + BK * DP;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int idx = tid; idx < BQ * DP; idx += THREADS) {
    int r = idx / DP, d = idx % DP, qp = q0 + r;
    Qs[r * LDQ + d] = (qp < S && d < D) ? to_f(qb[qp * qss + d]) : 0.f;
  }
  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -1e30f;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int nk = (S + BK - 1) / BK;
  const int kt_hi = causal ? min(nk - 1, q_last / BK) : nk - 1;
  int kt_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BK;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < BK * DP; idx += THREADS) {
      int r = idx / DP, d = idx % DP, kp = k0 + r;
      bool ok = kp < S && d < D;
      Ks[r * LDQ + d] = ok ? to_f(kb[kp * kss + d]) : 0.f;
      Vs[r * DP + d] = ok ? to_f(vb[kp * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool keep = true;
        if (causal) keep = keep && kp <= qp;
        if (window > 0) keep = keep && kp > qp - window;
        float x = s[i][j] * scale;
        s[i][j] = kp >= S ? -INFINITY : (keep ? x : -1e30f);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty * 4 + i) * LDP + tx + 16 * j] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        float vv = Vs[kk * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    T* orow = o + (((long long)b * S + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = from_f<T>(acc[i][j] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core variant (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;               // 16 query rows each
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_PAD = 8;                 // bf16 per smem row: 16-byte pad

// copy rows [r0, r0 + 64) of one head (row stride rs, D contiguous bf16)
// into smem rows of LD bf16, zero past S; 16-byte vectors
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int r0, int S) {
  constexpr int LD = D + MMA_PAD;
  constexpr int VPR = D / 8;                 // 16-byte vectors per row
  for (int i = threadIdx.x; i < 64 * VPR; i += MMA_THREADS) {
    int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int S, int H, int KV, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, float scale, int causal, int window) {
  constexpr int LD = D + MMA_PAD;
  constexpr int KS = D / 16;                 // k-steps of Q.K^T
  constexpr int DN = D / 8;                  // n-blocks of P.V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + 64 * LD;
  __nv_bfloat16* Vs = Ks + 64 * LD;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;

  load_tile<D>(Qs, qb, qss, q0, S);
  __syncthreads();
  unsigned qf[KS][4];
  {
    const int r = warp * 16 + (lane & 15), c = (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldsm_x4(qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3],
              Qs + r * LD + ks * 16 + c);
  }

  // this thread's two rows: quad and quad + 8 of the warp's 16
  const int row0 = q0 + warp * 16 + quad;
  float m_i[2] = {-1e30f, -1e30f}, l_i[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int q_last = min(q0 + 64, S) - 1;
  const int nk = (S + 63) / 64;
  const int kt_hi = causal ? min(nk - 1, q_last / 64) : nk - 1;
  int kt_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / 64;
  const int warp_last = q0 + warp * 16 + 15;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * 64;
    __syncthreads();   // the previous tile's readers are done
    load_tile<D>(Ks, kb, kss, k0, S);
    load_tile<D>(Vs, vb, vss, k0, S);
    __syncthreads();
    // every row of this warp is before the tile: fully masked, skipped
    if (causal && k0 > warp_last) continue;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {       // pairs of 8-key blocks
        unsigned b0, b1, b2, b3;
        const int key = jj * 16 + (lane >> 4) * 8 + (lane & 7);
        const int d = ks * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(b0, b1, b2, b3, Ks + key * LD + d);
        mma_bf16(s[2 * jj], qf[ks], b0, b1);
        mma_bf16(s[2 * jj + 1], qf[ks], b2, b3);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = row0 + (e >> 1) * 8;
        const int kp = k0 + j * 8 + tq * 2 + (e & 1);
        bool keep = true;
        if (causal) keep = keep && kp <= qp;
        if (window > 0) keep = keep && kp > qp - window;
        const float x = s[j][e] * scale;
        s[j][e] = kp >= S ? -INFINITY : (keep ? x : -1e30f);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = expf(m_i[r] - m_new);
      m_i[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_i[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_i[r] = l_i[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // P (rounded to bf16) . V, 16 keys per k-step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < DN / 2; ++nn) {  // pairs of 8-wide d blocks
        unsigned b0, b1, b2, b3;
        const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int d = nn * 16 + (lane >> 4) * 8;
        ldsm_x4_t(b0, b1, b2, b3, Vs + key * LD + d);
        mma_bf16(acc[2 * nn], pa, b0, b1);
        mma_bf16(acc[2 * nn + 1], pa, b2, b3);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + r * 8;
    if (qp >= S) continue;
    const float denom = fmaxf(l_i[r], 1e-30f);
    __nv_bfloat16* orow = o + (((long long)b * S + qp) * H + h) * D;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      __nv_bfloat162 val = __floats2bfloat162_rn(acc[n][2 * r] / denom,
                                                 acc[n][2 * r + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + tq * 2) = val;
    }
  }
}

template <typename T, int DC>
int launch_one(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KV, int D, const long long* st,
               float scale, int causal, int window, cudaStream_t stream) {
  const int bytes = smem_floats<DC>() * (int)sizeof(float);
  auto kern = flash_kernel<T, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
  kern<<<grid, THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KV, D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* o,
                 int B, int S, int H, int KV, int D, const long long* st,
                 float scale, int causal, int window, cudaStream_t stream) {
  if (D <= 32)
    return launch_one<T, 2>(q, k, v, o, B, S, H, KV, D, st, scale, causal,
                            window, stream);
  if (D <= 64)
    return launch_one<T, 4>(q, k, v, o, B, S, H, KV, D, st, scale, causal,
                            window, stream);
  if (D <= 128)
    return launch_one<T, 8>(q, k, v, o, B, S, H, KV, D, st, scale, causal,
                            window, stream);
  return launch_one<T, 16>(q, k, v, o, B, S, H, KV, D, st, scale, causal,
                           window, stream);
}

int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KV, const long long* st, float scale,
               int causal, int window, cudaStream_t stream) {
  const int bytes = 3 * 64 * (32 + MMA_PAD) * (int)sizeof(__nv_bfloat16);
  auto kern = flash_mma_kernel<32>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * H), (unsigned)((S + 63) / 64));
  kern<<<grid, MMA_THREADS, bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, S, H, KV, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal,
      window);
  return (int)cudaGetLastError();
}

// the tensor-core design reads 16-byte vectors: bf16 with D = 32, 16-byte
// aligned bases and strides that are positive multiples of 8 elements
bool mma_ok(const void* q, const void* k, const void* v, int D, int bf16,
            const long long* st) {
  if (!bf16 || D != 32) return false;
  for (const void* p : {q, k, v})
    if ((uintptr_t)p % 16 != 0) return false;
  for (int i = 0; i < 9; ++i)
    if (st[i] <= 0 || st[i] % 8 != 0) return false;
  return true;
}

}  // namespace

// strides: q (batch, seq, head), k (...), v (...), in elements; the last
// dim of each is contiguous and o is a contiguous [B, S, H, D].  design
// 0 is the CUDA-core kernel (any input), 1 the mma.sync kernel; an input
// the design does not take returns cudaErrorInvalidValue, nothing
// launched.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int KV, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, float scale, int causal, int window,
    int bf16, int design, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = (cudaStream_t)stream;
  if (design == 1) {
    if (!mma_ok(q, k, v, D, bf16, st)) return (int)cudaErrorInvalidValue;
    return launch_mma(q, k, v, o, B, S, H, KV, st, scale, causal, window,
                      s);
  }
  if (design != 0) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_dtype<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, st,
                                       scale, causal, window, s);
  return launch_dtype<float>(q, k, v, o, B, S, H, KV, D, st, scale, causal,
                             window, s);
}
