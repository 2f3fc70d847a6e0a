// flash_attention, Hopper design: a TMA-fed K/V ring and wgmma products.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention for bf16 inputs with (D, Dv) in {(64, 64), (128, 128),
// (192, 128)} (the granite-3-2b and qwen2-moe prefills, and MLA's:
// Q/K 192, V 128): q [B, S, H, D], k [B, S, KV, D] and v [B, S, KV, Dv]
// with H % KV == 0, any strides that are positive multiples of 8
// elements, 16-byte aligned bases; out a contiguous [B, S, H, Dv] bf16,
// scale 1/sqrt(D) (Q's width, as MLA's is).  It computes what the TPU
// kernel does: s = q . k^T * scale in f32; masked scores (kpos > qpos, or
// kpos <= qpos - window) -1e30 (here -2^100 before the scale); running
// max m, denominator l and accumulator acc in f32; p rounded to bf16
// before P . V while l sums the unrounded p; out = acc / max(l, 1e-30).
// Key positions past S score -inf.  For training (a non-null lse) each
// row's log-sum-exp m * scale + log(l) is written too, for the
// gradient's Hopper design (flash_attention_bwd_wgmma.cu); out does not
// change.  The exponent is taken as
// exp2(s * scale * log2e - m * scale * log2e) (one fmaf and one
// ex2.approx), a few f32 ulps from exp(s * scale - m * scale), far below
// the bf16 rounding of p.
//
// Design.  A persistent grid, one block per SM, walks work items of BQ
// query rows of one (batch, head) -- BQ = 192 at D = 64, 128 at D = 128
// and 192 -- the longest causal rows first.  A block has NWG consumer
// warpgroups of 64 rows (3 at D = 64, 2 otherwise) and one producer
// warpgroup:
//   * the producer (setmaxnreg down to 24 or 32 registers) has one thread
//     issue every TMA copy: each item's Q tile into one of NQ Q buffers,
//     then its 128-key K and V tiles into a 2-stage ring, each with a full
//     and an empty mbarrier (K and V apart, so S = Q K^T starts before V
//     lands), running ahead into the next item while the consumers finish
//     this one.  128-byte swizzle, one 64-wide box per row chunk (D / 64
//     for Q and K, Dv / 64 for V); the copy engine zero-fills rows past S
//     and before 0.  NQ = 2 (the next item's Q loads under this one) but
//     at (192, 128), where a second 48 KB Q buffer would not fit beside
//     the ring: there the next Q loads once the consumers have issued
//     this item's last S = Q K^T, under its last P V and epilogue.
//   * each consumer (240 or 160 registers) issues tile j's S = Q K^T
//     (wgmma m64n128k16, Q and K K-major in shared memory) together with
//     tile j-1's O += P V (wgmma m64nDk16, P in registers, V read MN-major
//     through the transpose bit), then takes tile j's online softmax on
//     the accumulator fragments (a quad of lanes per row; the mask built
//     only on the key tiles the diagonal, the window edge or S cut) while
//     P V runs, and packs P to bf16 pairs straight into wgmma's A
//     registers.  The consumer warpgroups take turns issuing their
//     products (named barriers), so one's softmax runs under another's
//     products.
// Measured on the H100 and dropped as slower or no faster (PERF.md
// section 6): a tile's two products in series, the overlap without the
// turns, one block per work item, a third ring stage, two consumer
// warpgroups at D = 64, the bf16 packing on the integer pipe, skipping
// the rescale of O when no row's max moved, the row max and sum in
// several partials.
//
// Bound: operations.  2 * (D + Dv) flops per unmasked (query, key) pair
// at the bf16 tensor-core peak (989 TFLOP/s); at granite-3-2b's prefill (4 x
// 4,096 tokens, 32 heads, 8 KV heads, D = 64) 2.75e11 flops, 0.278 ms,
// against 0.13 GB moved.  At D = 64 the exponentials (one per score, 16 a
// clock per SM) take as long as the products, and the softmax runs at
// about half an instruction a clock per SM sub-partition: it, not the
// tensor cores, sets the time (PERF.md section 6).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

#include "flash_hopper.cuh"

namespace {

using namespace flash_hopper;   // mbarriers, TMA, wgmma, the tensor maps

constexpr int BK = 128;                 // keys a tile
constexpr int BOX_BYTES = 128 * 128;    // one K/V box: 128 rows x 64 bf16
// the masked score, -2^100 (about -1.27e30): a power of two, so NEG * c
// is exact and a row masked so far scores exp2(fmaf(NEG, c, -NEG * c)) =
// exp2(0) = 1 per masked key, as the TPU kernel's exp(-1e30 + 1e30) does,
// until its first unmasked key rescales that by alpha = 0
constexpr float NEG = -0x1p100f;

// shared memory of one block, from a 1024-byte aligned base: NQ Q tiles
// of BQ rows (a work item's and, with two, the next one's), the K ring,
// the V ring, then the mbarriers (full Q, empty Q per Q tile; full K,
// empty K, full V, empty V per stage); the C entry and
// flash_attention.wgmma_smem_bytes agree
template <int DQK, int DV, int BQ, int NQ, int STAGES>
struct Layout {
  static constexpr int kQ = (DQK / 64) * BQ * 128;       // BQ rows x D
  static constexpr int kTileK = (DQK / 64) * BOX_BYTES;  // 128 rows x D
  static constexpr int kTileV = (DV / 64) * BOX_BYTES;   // 128 rows x Dv
  static constexpr int kK = NQ * kQ;
  static constexpr int kV = kK + STAGES * kTileK;
  static constexpr int kBar = kV + STAGES * kTileV;
  static constexpr int kBytes = 1024 + kBar + 8 * (2 * NQ + 4 * STAGES);
};

// S = Q K^T for this warpgroup's 64 rows over one K tile (not waited)
template <int D, int BQ>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_smem,
                                         uint32_t k_smem) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;    // 16 of a box's 64 columns
    wgmma_qk(s, desc_sw128(q_smem + (ks / 4) * BQ * 128 + col, 16),
             desc_sw128(k_smem + (ks / 4) * BOX_BYTES + col, 16), ks > 0);
  }
  wgmma_commit();
  fence_regs(s);
}

// O += P V over one V tile of D columns (not waited)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&p)[32],
                                         uint32_t v_smem) {
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_pv(o, p + 4 * kk, desc_sw128(v_smem + kk * 2048, BOX_BYTES));
  wgmma_commit();
  fence_regs(o);
}

// The online softmax of one score tile, in place: the mask (edge tiles
// only), the rows' new max, alpha = exp(m_old - m_new), s = exp(s - m),
// and l = l * alpha + this thread's part of the row sum (the quad's
// parts are summed once, at the end).  Element r of the fragment is key
// (r >> 2) * 8 + 2t + (r & 1) of row qa (r & 2 == 0) or qb.
__device__ __forceinline__ void softmax_tile(
    float (&s)[64], float (&m)[2], float (&l)[2], float (&alpha)[2],
    bool edge, int k0, int t, int qa, int qb, int S, int causal,
    int window, float c) {
  if (edge) {
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      const int kp = k0 + (r >> 2) * 8 + 2 * t + (r & 1);
      const int qp = (r & 2) ? qb : qa;
      const bool drop =
          (causal && kp > qp) || (window > 0 && kp <= qp - window);
      s[r] = kp >= S ? -INFINITY : (drop ? NEG : s[r]);
    }
  }
  float mx[2] = {m[0], m[1]}, mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 64; ++r)
    mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], s[r]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = ex2((m[i] - mx[i]) * c);
    m[i] = mx[i];
    mc[i] = mx[i] * c;
  }
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    s[r] = ex2(fmaf(s[r], c, -mc[(r >> 1) & 1]));
    sum[(r >> 1) & 1] += s[r];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
}

// O *= alpha per row, then P = bf16(s) as wgmma A fragments: k-step kk
// takes keys 16kk..16kk+15, elements 8kk..8kk+7 of the score fragment
template <int D>
__device__ __forceinline__ void rescale_and_pack(float (&o)[D / 2],
                                                 uint32_t (&p)[32],
                                                 const float (&s)[64],
                                                 const float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < D / 2; ++r) o[r] *= alpha[(r >> 1) & 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// One work item: the BQ query rows from q0 of (b, h), and the key tiles
// [kt_lo, kt_lo + n) they walk: from the first their window reaches to
// the last their causal mask reaches (the others are masked for every
// row)
struct Item {
  int b, h, kvh, q0, kt_lo, n;
};

// work item w: the rows S - (w / BH + 1) BQ .. S - (w / BH) BQ - 1 of
// batch * head w % BH.  The tiles end at S, the longest rows first, so
// only the shortest item (q0 < 0: rows the copy fills with zeros, never
// stored) is partial.
template <int BQ>
__device__ __forceinline__ Item item_of(int w, int BH, int H, int KV, int S,
                                        int causal, int window) {
  Item it;
  const int bh = w % BH;
  it.b = bh / H;
  it.h = bh % H;
  it.kvh = it.h / (H / KV);
  it.q0 = S - (w / BH + 1) * BQ;
  const int first = max(it.q0, 0), last = it.q0 + BQ - 1;
  const int nk = (S + BK - 1) / BK;
  const int hi = causal ? last / BK : nk - 1;
  it.kt_lo = (window > 0 && first - window + 1 > 0)
                 ? (first - window + 1) / BK : 0;
  it.n = hi - it.kt_lo + 1;
  return it;
}

// NWG consumer warpgroups of 64 query rows (BQ = 64 NWG) and one producer
// warpgroup.  A persistent grid: block i takes work items item_index(r,
// i, G), r = 0, 1, ... while they are < n_items; the producer runs ahead
// across items (the next item's Q into the next of NQ Q tiles once it is
// free, its K/V into the ring) while the consumers finish the current
// one.
template <int DQK, int DV, int STAGES, int NWG, int NQ>
__global__ void __launch_bounds__(128 * (NWG + 1), 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int lse_pitch, float scale, int S, int H,
    int KV, int BH, int n_items, float c, int causal, int window) {
  constexpr int BQ = 64 * NWG;
  using L = Layout<DQK, DV, BQ, NQ, STAGES>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar0 = base + L::kBar;
  // full / empty Q of Q tile x; full K, empty K, full V, empty V of stage
  auto bar_q = [&](int empty, int x) {
    return bar0 + 8u * (NQ * empty + x);
  };
  auto bar = [&](int kind, int st) {
    return bar0 + 8u * (2 * NQ + kind * STAGES + st);
  };
  auto k_smem = [&](int st) { return base + L::kK + st * L::kTileK; };
  auto v_smem = [&](int st) { return base + L::kV + st * L::kTileV; };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int x = 0; x < NQ; ++x) {
      mbar_init(bar_q(0, x), 1);
      mbar_init(bar_q(1, x), 4 * NWG);   // one arrival per consumer warp
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar(0, st), 1);
      mbar_init(bar(1, st), 4 * NWG);
      mbar_init(bar(2, st), 1);
      mbar_init(bar(3, st), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread issues every copy ----
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    if (threadIdx.x == 128 * NWG) {
      int st = 0, ph = 0;
      for (int r = 0;; ++r) {
        const int w = item_index(r, blockIdx.x, gridDim.x);
        if (w >= n_items) break;
        const Item it = item_of<BQ>(w, BH, H, KV, S, causal, window);
        const int x = r % NQ;             // Q tile x's (r / NQ)-th use
        mbar_wait(bar_q(1, x), ((r / NQ) & 1) ^ 1);
        mbar_expect_tx(bar_q(0, x), L::kQ);
        for (int d = 0; d < DQK / 64; ++d)
          tma_load(base + x * L::kQ + d * BQ * 128, &qmap, bar_q(0, x),
                   64 * d, it.q0, it.h, it.b);
        for (int j = 0; j < it.n; ++j) {
          const int k0 = (it.kt_lo + j) * BK;
          mbar_wait(bar(1, st), ph ^ 1);
          mbar_expect_tx(bar(0, st), L::kTileK);
          for (int d = 0; d < DQK / 64; ++d)
            tma_load(k_smem(st) + d * BOX_BYTES, &kmap, bar(0, st), 64 * d,
                     k0, it.kvh, it.b);
          mbar_wait(bar(3, st), ph ^ 1);
          mbar_expect_tx(bar(2, st), L::kTileV);
          for (int d = 0; d < DV / 64; ++d)
            tma_load(v_smem(st) + d * BOX_BYTES, &vmap, bar(2, st), 64 * d,
                     k0, it.kvh, it.b);
          advance<STAGES>(st, ph);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int t = lane & 3;
    auto release = [&](uint32_t b_) {
      __syncwarp();
      if (lane == 0) mbar_arrive(b_);
    };
    float s[64], acc[DV / 2];
    uint32_t p[32];
    int st = 0, ph = 0;
    // the warpgroups take turns on the tensor cores in order 0, 1, ...:
    // warpgroup wg waits for its turn at named barrier 1 + wg and hands
    // the next turn to wg + 1 (mod NWG); the last warpgroup gives the
    // first turn and hands none over after its last
    if (wg == NWG - 1) named_arrive(1);
    for (int r = 0;; ++r) {
      const int w = item_index(r, blockIdx.x, gridDim.x);
      if (w >= n_items) break;
      const bool last_item =
          item_index(r + 1, blockIdx.x, gridDim.x) >= n_items;
      const Item it = item_of<BQ>(w, BH, H, KV, S, causal, window);
      const int x = r % NQ, n = it.n;
      const int row_w = it.q0 + wg * 64 + warp * 16;   // warp's first row
      const int qa = row_w + (lane >> 2), qb = qa + 8;
      const uint32_t q_smem = base + x * L::kQ + wg * 64 * 128;
      // does the mask cut key tile k0 for any row of this warp?
      auto edge = [&](int k0) {
        return k0 + BK > S || (causal && k0 + BK - 1 > row_w) ||
               (window > 0 && k0 <= row_w + 15 - window);
      };
      auto hand_over = [&](int j) {
        if (!(wg == NWG - 1 && last_item && j == n - 1))
          named_arrive(1 + (wg + 1) % NWG);
      };
      float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
      mbar_wait(bar_q(0, x), (r / NQ) & 1);

      named_sync(1 + wg);
      mbar_wait(bar(0, st), ph);
      issue_qk<DQK, BQ>(s, q_smem, k_smem(st));
      hand_over(0);
      wgmma_wait<0>();
      fence_regs(s);
      release(bar(1, st));
      softmax_tile(s, m, l, alpha, edge(it.kt_lo * BK), it.kt_lo * BK, t,
                   qa, qb, S, causal, window, c);
      rescale_and_pack<DV>(acc, p, s, alpha);
      int pst = st, pph = ph;             // the stage P's V lies in
      advance<STAGES>(st, ph);
      for (int j = 1; j < n; ++j) {
        const int k0 = (it.kt_lo + j) * BK;
        named_sync(1 + wg);
        mbar_wait(bar(0, st), ph);
        issue_qk<DQK, BQ>(s, q_smem, k_smem(st));
        mbar_wait(bar(2, pst), pph);
        issue_pv<DV>(acc, p, v_smem(pst));
        hand_over(j);
        wgmma_wait<1>();
        fence_regs(s);
        release(bar(1, st));
        softmax_tile(s, m, l, alpha, edge(k0), k0, t, qa, qb, S, causal,
                     window, c);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(p);
        release(bar(3, pst));
        rescale_and_pack<DV>(acc, p, s, alpha);
        pst = st;
        pph = ph;
        advance<STAGES>(st, ph);
      }
      release(bar_q(1, x));
      mbar_wait(bar(2, pst), pph);
      issue_pv<DV>(acc, p, v_smem(pst));
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(p);
      release(bar(3, pst));

      // epilogue: the quad's row sums, acc / max(l, 1e-30) to bf16
      float den[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        den[i] = fmaxf(l[i], 1e-30f);
      }
      // the rows' log-sum-exp for the gradient (training only): m in
      // score units times the scale, plus log l
      if (lse != nullptr && t == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = i ? qb : qa;
          if (row >= 0)
            lse[((long long)it.b * H + it.h) * lse_pitch + row] =
                m[i] * scale + logf(l[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < DV / 2; i += 2) {
        const int row = ((i >> 1) & 1) ? qb : qa;
        if (row >= 0) {
          __nv_bfloat16* orow =
              o + (((long long)it.b * S + row) * H + it.h) * DV;
          *reinterpret_cast<__nv_bfloat162*>(orow + (i >> 2) * 8 + 2 * t) =
              __floats2bfloat162_rn(acc[i] / den[(i >> 1) & 1],
                                    acc[i + 1] / den[(i >> 1) & 1]);
        }
      }
    }
  }
}


// NWG consumer warpgroups for D: three (192-query items) at D = 64, two
// at D = 128 and 192 (whose accumulators need the registers); NQ Q
// buffers: two, but one at D = 192, where two would not fit beside the
// ring (2 x 48 KB + 2 x 80 KB)
template <int D>
constexpr int NWG_OF = D == 64 ? 3 : 2;
template <int D>
constexpr int NQ_OF = D == 192 ? 1 : 2;
constexpr int RING_STAGES = 2;

template <int DQK, int DV>
constexpr int smem_bytes() {
  return Layout<DQK, DV, 64 * NWG_OF<DQK>, NQ_OF<DQK>, RING_STAGES>::kBytes;
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o,
           float* lse, int lse_pitch, float scale, int B, int S, int H,
           int KV, const long long* st, float c, int causal, int window,
           cudaStream_t stream) {
  constexpr int NWG = NWG_OF<DQK>, BQ = 64 * NWG;
  constexpr int bytes = smem_bytes<DQK, DV>();
  static_assert(bytes <= 232448, "one block's shared memory");
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, DQK, S, H, B, st[1], st[2], st[0], BQ) ||
      !make_map(&km, k, DQK, S, KV, B, st[4], st[5], st[3], BK) ||
      !make_map(&vm, v, DV, S, KV, B, st[7], st[8], st[6], BK))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<DQK, DV, RING_STAGES, NWG, NQ_OF<DQK>>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_items = B * H * ((S + BQ - 1) / BQ);
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  kern<<<min(n_items, sms), 128 * (NWG + 1), bytes, stream>>>(
      qm, km, vm, (__nv_bfloat16*)o, lse, lse_pitch, scale, S, H, KV, B * H,
      n_items, c, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// The Hopper design of flash_attention.plan_flash ("tma_wgmma").  Q/K
// width D, V width Dv; strides q (batch, seq, head), k (...), v (...) in
// elements, the last dim contiguous; o a contiguous [B, S, H, Dv].  With
// `lse` not null (training) each row's log-sum-exp, m * scale + log(l) in
// f32, goes to lse[(b * H + h) * lse_pitch + row] (lse_pitch >= S); O is
// the same with or without it.  Returns cudaErrorInvalidValue (nothing
// launched) for inputs the design does not take -- (D, Dv) not (64, 64),
// (128, 128) or (192, 128), a base not 16-byte aligned, a stride not a
// positive multiple of 8 elements, an lse pitch below S -- or when
// `stages` or `smem` differ from the design's ring depth and shared
// bytes; otherwise cudaGetLastError().
extern "C" int flash_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int KV, int D, int Dv, long long qsb, long long qss,
    long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, float scale, int causal, int window,
    void* lse, int lse_pitch, int stages, int smem, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const bool shape = ((D == 64 || D == 128) && Dv == D) ||
                     (D == 192 && Dv == 128);
  const int bytes = D == 64    ? smem_bytes<64, 64>()
                    : D == 128 ? smem_bytes<128, 128>()
                               : smem_bytes<192, 128>();
  bool ok = shape && H % KV == 0 && stages == RING_STAGES && smem == bytes &&
            (lse == nullptr || ((uintptr_t)lse % 4 == 0 && lse_pitch >= S));
  for (const void* p : {q, k, v, (const void*)o})
    ok = ok && (uintptr_t)p % 16 == 0;
  for (long long x : st) ok = ok && x > 0 && x % 8 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  const float c = scale * LOG2E;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (D == 64)
    return launch<64, 64>(q, k, v, o, l, lse_pitch, scale, B, S, H, KV, st,
                          c, causal, window, s);
  if (D == 128)
    return launch<128, 128>(q, k, v, o, l, lse_pitch, scale, B, S, H, KV,
                            st, c, causal, window, s);
  return launch<192, 128>(q, k, v, o, l, lse_pitch, scale, B, S, H, KV, st,
                          c, causal, window, s);
}
