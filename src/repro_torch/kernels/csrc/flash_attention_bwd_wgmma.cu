// flash_attention_bwd_wgmma: the gradient of flash_attention (9b), Hopper
// design.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention on the training path (its gradient, which the JAX
// package takes by autodiff of repro/models/transformer.py ::
// _attend_block; flash_attention_bwd.cu says why the port keeps a kernel)
// for what B9's Hopper forward (flash_attention_wgmma.cu) takes: bf16
// with (D, Dv) in {(64, 64), (128, 128), (192, 128)} (Q/K width D, V
// width Dv: MLA's is 192 and 128), strides positive multiples of 8
// elements, 16-byte aligned bases.  It reads the log-sum-exp lse that the
// forward saved for each query row, so no launch keeps an online max or a
// running sum.  dP = dO V^T and dV = P^T dO run at width Dv; S = Q K^T,
// dK = dS^T Q and dQ = dS K at D.  With s = q.k * scale (f32, scale =
// 1/sqrt(D)) and the forward's mask:
//   P = exp(s - lse)                (0 where masked)
//   dP = dO . V^T,  Delta = sum_j P_j dP_j  (per query row, f32)
//   dS = P o (dP - Delta)           (0 in a row that sees one key)
//   dV = round(P)^T . dO,  dK = round(dS)^T . Q * scale,
//   dQ = round(dS) . K * scale
// P and dS rounded to bf16 before their products, as JAX's autodiff
// rounds them.  Delta is the softmax's own vjp term, as the plain version
// takes it: rowsum(dO o O) over the bf16 O (FlashAttention-2/3's) left
// the rounding of P and O in every row's sum of dS, which in a row that
// sees a few keys is most of its gradient (PERF.md section 6).
//
// Three launches, no atomics, so a gradient repeats bit for bit:
//   1. bwd_wgmma_stats_kernel, one work item per (batch, head, query tile
//      of 128 rows) on a persistent grid, the last query tile first: Q and
//      dO loaded once (two buffers, so the next item's load runs under
//      this one; one at D = 192, where two do not fit beside the rings),
//      64-key K and V tiles through a 2-stage ring; S = Q K^T
//      and dP = dO V^T (wgmma, both operands K-major in shared memory),
//      P, and each row's Delta summed in key order, written with lse *
//      log2(e) (the exponent's units) to an f32 scratch [B*H, 2, pitch].
//   2. bwd_wgmma_dkdv_kernel, one work item per (batch, KV head, key tile
//      of 128 rows), key tile 0 (the longest under the causal mask)
//      first: K and V of the tile loaded once by TMA; a producer thread
//      streams 64-row Q and dO tiles, with their lse and Delta slices (one
//      2-D TMA box of the scratch), through a 2-stage ring, each query
//      head of the group in head order and, for each, only the query tiles
//      the mask lets see the key tile; two consumer warpgroups own 64 keys
//      each and compute S^T = K Q^T and dP^T = V dO^T, P^T and dS^T on the
//      accumulator fragments (the mask only on tiles it cuts, in a loop of
//      its own), then dV += P^T dO and dK += dS^T Q (A from registers, B
//      MN-major, as the forward's P V).  dK and dV stay in registers and
//      are written once; past D = 64 a stage is taken in passes of
//      fewer queries, so that the scores leave them the registers: two of
//      32 at D = 128, four of 16 at D = 192 (dK's 96 and dV's 64
//      accumulators a lane; 32 spilled a register there).
//   3. bwd_wgmma_dq_kernel, launch 1's pass again with dS and dQ += dS K
//      in place of the sums; dQ written once, times the scale.
// 9 products in all: the gradient's own 5, and S and dP taken once more
// in each of the other launches.  Each warpgroup skips a streamed tile
// whose pairs the mask hides from all its rows
// (flash_attention.FlashBwdPlan mirrors the walked tiles).  Design:
// FlashAttention-3's backward (Shah et al., 2024, section 3) without its
// dQ accumulated across key tiles by atomics.
// Tried on the H100 while it was built (PERF.md section 6): the
// consumers' instruction count, not the tensor cores or the copies, sets
// the time.  Taking the mask test out of the exponent loop and making
// each operand's descriptor once a step paid most; a deeper ring, and dV
// and dK issued a step later with or without the forward's turns
// between warpgroups, did not.
//
// Bound: operations.  5 products per unmasked (query, key) pair given
// the saved lse, 2 * (3 D + 2 Dv) flops (2.5x the forward's at Dv = D;
// the 9 run here 2 * (5 D + 4 Dv)), at the bf16 tensor-core peak (989
// TFLOP/s).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

#include "flash_hopper.cuh"

namespace {

using namespace flash_hopper;   // mbarriers, TMA, wgmma, the tensor maps

constexpr int BI = 128;               // rows of a work item: 64 a warpgroup
constexpr int BS = 64;                // rows of a streamed tile
constexpr int NWG = 2;                // consumer warpgroups
constexpr int STAGES = 2;             // ring depth
constexpr int IBOX = BI * 128;        // an item box: 128 rows x 64 bf16
constexpr int SBOX = BS * 128;        // a streamed box: 64 rows x 64 bf16
constexpr int STAT = 2 * BS * 4;      // a stage's lse and Delta slices
constexpr int THREADS = 128 * (NWG + 1);
// registers a thread after setmaxnreg, the producer's and the consumers':
// 40 + 2 x 232 a lane of a warpgroup is the 168 x 3 the block starts
// with (an increase the block's own release does not cover would wait
// for ever; the launch checks the compiled count)
constexpr int REGS_PRODUCER = 40, REGS_CONSUMER = 232;

// shared memory of the dK/dV kernel, from a 1024-byte aligned base: the
// K and V tiles of the item, the Q ring, the dO ring, the lse/Delta
// slices of each stage, then the mbarriers (full and empty K/V; full and
// empty per stage); the C entry and flash_attention.wgmma_bwd_smem_bytes
// agree.  Q and K rows are DQK wide, V and dO rows DV.
template <int DQK, int DV>
struct DkdvLayout {
  static constexpr int kItemK = (DQK / 64) * IBOX;  // 128 rows x DQK
  static constexpr int kItemV = (DV / 64) * IBOX;   // 128 rows x DV
  static constexpr int kStepQ = (DQK / 64) * SBOX;  // 64 rows x DQK
  static constexpr int kStepO = (DV / 64) * SBOX;   // 64 rows x DV
  static constexpr int kK = 0;
  static constexpr int kV = kItemK;
  static constexpr int kQ = kV + kItemV;
  static constexpr int kO = kQ + STAGES * kStepQ;
  static constexpr int kStat = kO + STAGES * kStepO;
  static constexpr int kBar = kStat + STAGES * STAT;
  static constexpr int kBytes = 1024 + kBar + 8 * (2 + 2 * STAGES);
};

// Q/dO buffers of the query passes: two (an item's and the next one's),
// but one at DQK = 192, where two (2 x 80 KB) and the rings would pass a
// block's 227 KB
template <int DQK>
constexpr int NQ_OF = DQK == 192 ? 1 : 2;

// shared memory of the statistics and dQ kernels: NQ Q tiles and NQ dO
// tiles of 128 rows, the K ring, the V ring, then the mbarriers (full and
// empty per Q/dO buffer; full K, empty K, full V, empty V per stage)
template <int DQK, int DV>
struct DqLayout {
  static constexpr int NQ = NQ_OF<DQK>;
  static constexpr int kItemQ = (DQK / 64) * IBOX;  // 128 rows x DQK
  static constexpr int kItemO = (DV / 64) * IBOX;   // 128 rows x DV
  static constexpr int kStepK = (DQK / 64) * SBOX;  // 64 rows x DQK
  static constexpr int kStepV = (DV / 64) * SBOX;   // 64 rows x DV
  static constexpr int kQ = 0;
  static constexpr int kO = NQ * kItemQ;
  static constexpr int kK = kO + NQ * kItemO;
  static constexpr int kV = kK + STAGES * kStepK;
  static constexpr int kBar = kV + STAGES * kStepV;
  static constexpr int kBytes = 1024 + kBar + 8 * (2 * NQ + 4 * STAGES);
};

// mbar_wait, but a wait that outlasts any real one by far (2^33 clocks,
// about 4 s, read every 2^16 polls) traps: a fault in the barrier
// protocol ends the launch with an error instead of hanging it.  (Every
// wait of both kernels is this one: with the header's plain mbar_wait in
// the producer, ptxas held the consumers to far fewer registers than
// setmaxnreg gives them, and they spilled.)
__device__ __forceinline__ void wait_or_trap(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, polls = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((++polls & 0xFFFF) == 0) {
      const long long now = clock64();
      if (start == 0) start = now;
      else if (now - start > (1ll << 33)) __trap();
    }
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal,
                                        int window) {
  return qp < S && kp < S && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// query row qp sees a single key: its softmax is exactly 1 there, so its
// dS is exactly 0 whatever dP is, as in the plain version.  The kernels
// write that 0 (dP - Delta made 0 for the row): their P is 1 only up to
// ex2's rounding, which would leave a trace in a row whose gradient is 0.
__device__ __forceinline__ bool one_key(int qp, int S, int causal,
                                        int window) {
  const int hi = causal ? qp : S - 1;
  const int lo = window > 0 ? max(qp - window + 1, 0) : 0;
  return hi == lo;
}

// no (query, key) pair of queries [q0, q1] and keys [k0, k1] is visible
__device__ __forceinline__ bool none_visible(int q0, int q1, int k0, int k1,
                                             int S, int causal, int window) {
  return q0 >= S || k0 >= S || (causal && k0 > q1) ||
         (window > 0 && k1 <= q0 - window);
}

// every pair of the two ranges is visible (no mask to build)
__device__ __forceinline__ bool all_visible(int q0, int q1, int k0, int k1,
                                            int S, int causal, int window) {
  return q1 < S && k1 < S && (!causal || k1 <= q0) &&
         (window <= 0 || k0 > q1 - window);
}

// one box of a 2-D map (column, row) into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// x, through a copy the compiler cannot see through: an operand's
// descriptors are then made where they are used, not hoisted out of the
// loops into registers the accumulators need
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  uint32_t y;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// descriptor d moved `bytes` further into shared memory: the address
// field is the low 14 bits and stays below 2^14, so the add never
// carries out of the low word
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t bytes) {
  return (d & ~0xFFFFFFFFull) | (uint32_t)((uint32_t)d + (bytes >> 4));
}

// one 64 x N score-like tile (wgmma m64nNk16 over D): d = A B^T with
// A's 64 rows from a_smem (boxes a_box bytes apart) and B's N rows from
// b_smem (boxes SBOX apart), both K-major; issued and committed, not
// waited.  The first k-step writes d without reading it, so d's last
// values need not live until here.
template <int D, int N>
__device__ __forceinline__ void issue_scores(float (&d)[N / 2],
                                             uint32_t a_smem, int a_box,
                                             uint32_t b_smem) {
  const uint64_t da = desc_sw128(opaque(a_smem), 16);
  const uint64_t db = desc_sw128(opaque(b_smem), 16);
  wgmma_fence();
  wgmma_qk_first(d, da, db);
#pragma unroll
  for (int ks = 1; ks < D / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;    // 16 of a box's 64 columns
    wgmma_qk(d, desc_at(da, (ks / 4) * a_box + col),
             desc_at(db, (ks / 4) * SBOX + col), 1);
  }
  wgmma_commit();
  fence_regs(d);
}

// acc += X M over K rows of a streamed tile: X (64 x K, bf16 pairs in
// wgmma A registers) times M (K rows x D in shared memory, read
// MN-major); issued and committed, not waited
template <int D, int K>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 2],
                                          uint32_t (&x)[K / 4],
                                          uint32_t m_smem) {
  const uint64_t dm = desc_sw128(opaque(m_smem), SBOX);
  fence_regs(acc);
  fence_regs(x);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_pv(acc, x + 4 * kk, desc_at(dm, kk * 2048));
  wgmma_commit();
  fence_regs(acc);
}

// dK/dV work item w: key tile w / BKV (0 first: under the causal mask
// the longest) of (batch, KV head) w % BKV, and the 64-row query tiles
// [qlo, qhi] that see it (flash_attention.FlashBwdPlan.query_tiles)
struct KeyItem {
  int b, kvh, k0, qlo, qhi;
};

__device__ __forceinline__ KeyItem key_item(int w, int BKV, int KV, int S,
                                            int causal, int window) {
  KeyItem it;
  const int bkv = w % BKV;
  it.b = bkv / KV;
  it.kvh = bkv % KV;
  it.k0 = (w / BKV) * BI;
  const int k_last = min(it.k0 + BI, S) - 1;
  it.qlo = causal ? it.k0 / BS : 0;
  it.qhi = (S + BS - 1) / BS - 1;
  if (window > 0) it.qhi = min(it.qhi, (k_last + window - 1) / BS);
  return it;
}

// dQ work item w: query tile n_tiles - 1 - w / BH (the last first) of
// (batch, head) w % BH, and the 64-key tiles [klo, khi] it sees
// (flash_attention.FlashBwdPlan.key_tiles)
struct QueryItem {
  int b, h, kvh, q0, klo, khi;
};

__device__ __forceinline__ QueryItem query_item(int w, int BH, int H, int KV,
                                                int S, int causal,
                                                int window) {
  QueryItem it;
  const int bh = w % BH, n_tiles = (S + BI - 1) / BI;
  it.b = bh / H;
  it.h = bh % H;
  it.kvh = it.h / (H / KV);
  it.q0 = (n_tiles - 1 - w / BH) * BI;
  const int q_last = min(it.q0 + BI, S) - 1;
  it.khi = causal ? q_last / BS : (S + BS - 1) / BS - 1;
  it.klo = (window > 0 && it.q0 - window + 1 > 0)
               ? (it.q0 - window + 1) / BS : 0;
  return it;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1) bwd_wgmma_dkdv_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap omap,
    const __grid_constant__ CUtensorMap smap, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int S, int H, int KV, int BKV,
    int n_items, float c, float scale, int causal, int window) {
  using L = DkdvLayout<DQK, DV>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar0 = base + L::kBar;
  const uint32_t kv_full = bar0, kv_empty = bar0 + 8;
  auto full = [&](int st) { return bar0 + 16u + 8u * st; };
  auto empty = [&](int st) { return bar0 + 16u + 8u * (STAGES + st); };
  auto q_smem = [&](int st) { return base + L::kQ + st * L::kStepQ; };
  auto o_smem = [&](int st) { return base + L::kO + st * L::kStepO; };
  auto stat = [&](int st) { return L::kStat + st * STAT; };
  const int wg = threadIdx.x / 128, group = H / KV;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 4 * NWG);    // one arrival per consumer warp
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS_PRODUCER)
                 : "memory");
    if (threadIdx.x == 128 * NWG) {
      int st = 0, ph = 0;
      for (int r = 0;; ++r) {
        const int w = item_index(r, blockIdx.x, gridDim.x);
        if (w >= n_items) break;
        const KeyItem it = key_item(w, BKV, KV, S, causal, window);
        wait_or_trap(kv_empty, (r & 1) ^ 1);
        mbar_expect_tx(kv_full, L::kItemK + L::kItemV);
        for (int d = 0; d < DQK / 64; ++d)
          tma_load(base + L::kK + d * IBOX, &kmap, kv_full, 64 * d, it.k0,
                   it.kvh, it.b);
        for (int d = 0; d < DV / 64; ++d)
          tma_load(base + L::kV + d * IBOX, &vmap, kv_full, 64 * d, it.k0,
                   it.kvh, it.b);
        for (int g = 0; g < group; ++g) {
          const int h = it.kvh * group + g;
          for (int qt = it.qlo; qt <= it.qhi; ++qt) {
            const int q0 = qt * BS;
            wait_or_trap(empty(st), ph ^ 1);
            mbar_expect_tx(full(st), L::kStepQ + L::kStepO + STAT);
            for (int d = 0; d < DQK / 64; ++d)
              tma_load(q_smem(st) + d * SBOX, &qmap, full(st), 64 * d, q0, h,
                       it.b);
            for (int d = 0; d < DV / 64; ++d)
              tma_load(o_smem(st) + d * SBOX, &omap, full(st), 64 * d, q0, h,
                       it.b);
            tma_load_2d(base + stat(st), &smap, full(st), q0,
                        2 * (it.b * H + h));
            advance<STAGES>(st, ph);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 keys a warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS_CONSUMER)
                 : "memory");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int t = lane & 3;
    auto release = [&](uint32_t b_) {
      __syncwarp();
      if (lane == 0) mbar_arrive(b_);
    };
    // QH queries a pass: the stage's 64 at D = 64, at D = 128 two passes
    // of 32, at D = 192 four of 16, whose scores, dP^T and packed P^T and
    // dS^T leave the registers that dK and dV take (passes of 32 spilled
    // a register at D = 192)
    constexpr int QH = DQK == 64 ? 64 : DQK == 192 ? 16 : 32;
    float acc_k[DQK / 2], acc_v[DV / 2], s[QH / 2], dp[QH / 2];
    uint32_t pa[QH / 4], pb[QH / 4];
    int st = 0, ph = 0;
    for (int r = 0;; ++r) {
      const int w = item_index(r, blockIdx.x, gridDim.x);
      if (w >= n_items) break;
      const KeyItem it = key_item(w, BKV, KV, S, causal, window);
      const int kw0 = it.k0 + 64 * wg;                // the warpgroup's keys
      const int ka = kw0 + warp * 16 + (lane >> 2);   // rows ka and ka + 8
      const uint32_t k_a = base + L::kK + wg * 64 * 128;
      const uint32_t v_a = base + L::kV + wg * 64 * 128;
#pragma unroll
      for (int i = 0; i < DQK / 2; ++i) acc_k[i] = 0.f;
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc_v[i] = 0.f;
      wait_or_trap(kv_full, r & 1);
      for (int g = 0; g < group; ++g) {
        for (int qt = it.qlo; qt <= it.qhi; ++qt) {
          wait_or_trap(full(st), ph);
#pragma unroll
          for (int hq = 0; hq < BS / QH; ++hq) {
            const int q0 = qt * BS + hq * QH;
            if (none_visible(q0, q0 + QH - 1, kw0, kw0 + 63, S, causal,
                             window))
              continue;
            const uint32_t q_h = q_smem(st) + hq * QH * 128;
            const uint32_t o_h = o_smem(st) + hq * QH * 128;
            // this thread's lse2 and Delta: columns 8j + 2t (+ 1)
            const float* ls = reinterpret_cast<const float*>(
                                  gbase + stat(st)) + hq * QH + 2 * t;
            const float* dl = ls + BS;
            issue_scores<DQK, QH>(s, k_a, IBOX, q_h);      // S^T = K Q^T
            issue_scores<DV, QH>(dp, v_a, IBOX, o_h);      // dP^T = V dO^T
            wgmma_wait<1>();
            fence_regs(s);
            // element e of the fragment: key row ka (+8 when e & 2),
            // query column (e >> 2) * 8 + 2t + (e & 1)
#pragma unroll
            for (int e = 0; e < QH / 2; ++e)
              s[e] = ex2(fmaf(s[e], c, -ls[(e >> 2) * 8 + (e & 1)]));
            const bool edge = !all_visible(q0, q0 + QH - 1, kw0, kw0 + 63, S,
                                           causal, window);
            if (edge) {
#pragma unroll
              for (int e = 0; e < QH / 2; ++e)
                if (!visible(q0 + (e >> 2) * 8 + 2 * t + (e & 1),
                             ka + ((e >> 1) & 1) * 8, S, causal, window))
                  s[e] = 0.f;
            }
            wgmma_wait<0>();
            fence_regs(dp);
            if (edge) {
#pragma unroll
              for (int e = 0; e < QH / 2; ++e)
                if (one_key(q0 + (e >> 2) * 8 + 2 * t + (e & 1), S, causal,
                            window))
                  dp[e] = dl[(e >> 2) * 8 + (e & 1)];
            }
            // dS^T, packed as it is made (each dP^T pair dies at once),
            // then P^T
#pragma unroll
            for (int i = 0; i < QH / 4; ++i) {
              const float d0 = dl[(i >> 1) * 8], d1 = dl[(i >> 1) * 8 + 1];
              pb[i] = pack_bf16(s[2 * i] * (dp[2 * i] - d0),
                                s[2 * i + 1] * (dp[2 * i + 1] - d1));
            }
#pragma unroll
            for (int i = 0; i < QH / 4; ++i)
              pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
            issue_acc<DV, QH>(acc_v, pa, o_h);             // dV += P^T dO
            issue_acc<DQK, QH>(acc_k, pb, q_h);            // dK += dS^T Q
            wgmma_wait<0>();
            fence_regs(acc_v);
            fence_regs(acc_k);
            fence_regs(pa);
            fence_regs(pb);
          }
          release(empty(st));
          advance<STAGES>(st, ph);
        }
      }
      release(kv_empty);
      // epilogue: rows ka and ka + 8 below S, dK times the scale
      const long long rows = (long long)it.b * S * KV + it.kvh;
#pragma unroll
      for (int i = 0; i < DQK / 2; i += 2) {
        const int row = ((i >> 1) & 1) ? ka + 8 : ka;
        if (row < S)
          *reinterpret_cast<__nv_bfloat162*>(
              dk + (rows + (long long)row * KV) * DQK + (i >> 2) * 8 + 2 * t) =
              __floats2bfloat162_rn(acc_k[i] * scale, acc_k[i + 1] * scale);
      }
#pragma unroll
      for (int i = 0; i < DV / 2; i += 2) {
        const int row = ((i >> 1) & 1) ? ka + 8 : ka;
        if (row < S)
          *reinterpret_cast<__nv_bfloat162*>(
              dv + (rows + (long long)row * KV) * DV + (i >> 2) * 8 + 2 * t) =
              __floats2bfloat162_rn(acc_v[i], acc_v[i + 1]);
      }
    }
  }
}

// One query-side pass over (batch, head, 128-query tile) items: S = Q K^T
// and dP = dO V^T over the visible 64-key tiles, P = exp(S - lse).  STATS
// (the first launch): each row's Delta = sum_j P_j dP_j, accumulated in
// f32 in key order and written, with lse * log2(e), to stats[b * H + h]
// (rows S .. pitch - 1 get 0).  Otherwise (the last launch): dS = P o (dP
// - Delta) from those statistics, and dQ += dS K, written once.
template <int DQK, int DV, bool STATS>
__device__ __forceinline__ void query_pass(
    const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* omap,
    const float* __restrict__ lse, float* __restrict__ stats, int pitch,
    __nv_bfloat16* __restrict__ dq, int S, int H, int KV, int BH,
    int n_items, float c, float scale, int causal, int window) {
  using L = DqLayout<DQK, DV>;
  constexpr int NQ = L::NQ;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar0 = base + L::kBar;
  // full / empty Q and dO of buffer x; full K, empty K, full V, empty V
  // of stage st
  auto bar_q = [&](int empty, int x) {
    return bar0 + 8u * (NQ * empty + x);
  };
  auto bar = [&](int kind, int st) {
    return bar0 + 8u * (2 * NQ + kind * STAGES + st);
  };
  auto k_smem = [&](int st) { return base + L::kK + st * L::kStepK; };
  auto v_smem = [&](int st) { return base + L::kV + st * L::kStepV; };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int x = 0; x < NQ; ++x) {
      mbar_init(bar_q(0, x), 1);
      mbar_init(bar_q(1, x), 4 * NWG);
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
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS_PRODUCER)
                 : "memory");
    if (threadIdx.x == 128 * NWG) {
      int st = 0, ph = 0;
      for (int r = 0;; ++r) {
        const int w = item_index(r, blockIdx.x, gridDim.x);
        if (w >= n_items) break;
        const QueryItem it = query_item(w, BH, H, KV, S, causal, window);
        const int x = r % NQ;             // buffer x's (r / NQ)-th use
        wait_or_trap(bar_q(1, x), ((r / NQ) & 1) ^ 1);
        mbar_expect_tx(bar_q(0, x), L::kItemQ + L::kItemO);
        for (int d = 0; d < DQK / 64; ++d)
          tma_load(base + L::kQ + x * L::kItemQ + d * IBOX, qmap,
                   bar_q(0, x), 64 * d, it.q0, it.h, it.b);
        for (int d = 0; d < DV / 64; ++d)
          tma_load(base + L::kO + x * L::kItemO + d * IBOX, omap,
                   bar_q(0, x), 64 * d, it.q0, it.h, it.b);
        for (int j = it.klo; j <= it.khi; ++j) {
          const int k0 = j * BS;
          wait_or_trap(bar(1, st), ph ^ 1);
          mbar_expect_tx(bar(0, st), L::kStepK);
          for (int d = 0; d < DQK / 64; ++d)
            tma_load(k_smem(st) + d * SBOX, kmap, bar(0, st), 64 * d, k0,
                     it.kvh, it.b);
          wait_or_trap(bar(3, st), ph ^ 1);
          mbar_expect_tx(bar(2, st), L::kStepV);
          for (int d = 0; d < DV / 64; ++d)
            tma_load(v_smem(st) + d * SBOX, vmap, bar(2, st), 64 * d, k0,
                     it.kvh, it.b);
          advance<STAGES>(st, ph);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS_CONSUMER)
                 : "memory");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int t = lane & 3;
    auto release = [&](uint32_t b_) {
      __syncwarp();
      if (lane == 0) mbar_arrive(b_);
    };
    float acc[DQK / 2], s[32], dp[32];
    uint32_t pb[16];
    int st = 0, ph = 0;
    for (int r = 0;; ++r) {
      const int w = item_index(r, blockIdx.x, gridDim.x);
      if (w >= n_items) break;
      const QueryItem it = query_item(w, BH, H, KV, S, causal, window);
      const int x = r % NQ;
      const int wq0 = it.q0 + 64 * wg;               // the warpgroup's rows
      const int qa = wq0 + warp * 16 + (lane >> 2);  // rows qa and qa + 8
      const long long bh = (long long)it.b * H + it.h;
      float* lrow = stats + bh * 2 * pitch;
      float l2[2], dl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = qa + 8 * i;
        if constexpr (STATS) {
          l2[i] = row < S ? lse[bh * pitch + row] * LOG2E : 0.f;
          dl[i] = 0.f;                        // Delta, summed below
        } else {
          l2[i] = row < S ? lrow[row] : 0.f;
          dl[i] = row < S ? lrow[pitch + row] : 0.f;
        }
      }
      if constexpr (!STATS) {
#pragma unroll
        for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.f;
      }
      const uint32_t q_a = base + L::kQ + x * L::kItemQ + wg * 64 * 128;
      const uint32_t o_a = base + L::kO + x * L::kItemO + wg * 64 * 128;
      wait_or_trap(bar_q(0, x), (r / NQ) & 1);
      for (int j = it.klo; j <= it.khi; ++j) {
        const int k0 = j * BS;
        const bool hidden =
            none_visible(wq0, wq0 + 63, k0, k0 + 63, S, causal, window);
        wait_or_trap(bar(0, st), ph);
        if (!hidden) issue_scores<DQK, BS>(s, q_a, IBOX, k_smem(st));  // QK^T
        wait_or_trap(bar(2, st), ph);
        if (!hidden) {
          issue_scores<DV, BS>(dp, o_a, IBOX, v_smem(st));        // dO V^T
          wgmma_wait<1>();
          fence_regs(s);
          // element e: query row qa (+8 when e & 2), key column
          // (e >> 2) * 8 + 2t + (e & 1)
#pragma unroll
          for (int e = 0; e < 32; ++e)
            s[e] = ex2(fmaf(s[e], c, -l2[(e >> 1) & 1]));
          const bool edge =
              !all_visible(wq0, wq0 + 63, k0, k0 + 63, S, causal, window);
          if (edge) {
#pragma unroll
            for (int e = 0; e < 32; ++e)
              if (!visible(qa + 8 * ((e >> 1) & 1),
                           k0 + (e >> 2) * 8 + 2 * t + (e & 1), S, causal,
                           window))
                s[e] = 0.f;
          }
          wgmma_wait<0>();
          fence_regs(dp);
          if constexpr (STATS) {
            // this thread's part of each row's sum P o dP, in key order
#pragma unroll
            for (int e = 0; e < 32; ++e)
              dl[(e >> 1) & 1] = fmaf(s[e], dp[e], dl[(e >> 1) & 1]);
          } else {
            if (edge) {
#pragma unroll
              for (int e = 0; e < 32; ++e)
                if (one_key(qa + 8 * ((e >> 1) & 1), S, causal, window))
                  dp[e] = dl[(e >> 1) & 1];
            }
#pragma unroll
            for (int i = 0; i < 16; ++i)
              pb[i] = pack_bf16(s[2 * i] * (dp[2 * i] - dl[i & 1]),
                                s[2 * i + 1] * (dp[2 * i + 1] - dl[i & 1]));
            issue_acc<DQK, BS>(acc, pb, k_smem(st));              // dS K
            wgmma_wait<0>();
            fence_regs(acc);
            fence_regs(pb);
          }
        }
        release(bar(1, st));
        release(bar(3, st));
        advance<STAGES>(st, ph);
      }
      release(bar_q(1, x));
      if constexpr (STATS) {
        // the quad's parts of each row's Delta, then the rows below the
        // pitch
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dl[i] += __shfl_xor_sync(0xffffffffu, dl[i], 1);
          dl[i] += __shfl_xor_sync(0xffffffffu, dl[i], 2);
          const int row = qa + 8 * i;
          if (t == 0 && row < pitch) {
            lrow[row] = l2[i];
            lrow[pitch + row] = row < S ? dl[i] : 0.f;
          }
        }
        continue;
      }
      // epilogue: rows qa and qa + 8 below S, dQ times the scale
#pragma unroll
      for (int i = 0; i < DQK / 2; i += 2) {
        const int row = ((i >> 1) & 1) ? qa + 8 : qa;
        if (row < S) {
          __nv_bfloat16* out =
              dq + (((long long)it.b * S + row) * H + it.h) * DQK;
          *reinterpret_cast<__nv_bfloat162*>(out + (i >> 2) * 8 + 2 * t) =
              __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
        }
      }
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1) bwd_wgmma_stats_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap omap,
    const float* __restrict__ lse, float* __restrict__ stats, int pitch,
    int S, int H, int KV, int BH, int n_items, float c, int causal,
    int window) {
  query_pass<DQK, DV, true>(&qmap, &kmap, &vmap, &omap, lse, stats, pitch,
                      nullptr, S, H, KV, BH, n_items, c, 0.f, causal,
                      window);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1) bwd_wgmma_dq_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap omap,
    float* __restrict__ stats, int pitch, __nv_bfloat16* __restrict__ dq,
    int S, int H, int KV, int BH, int n_items, float c, float scale,
    int causal, int window) {
  query_pass<DQK, DV, false>(&qmap, &kmap, &vmap, &omap, nullptr, stats, pitch,
                       dq, S, H, KV, BH, n_items, c, scale, causal, window);
}

template <int DQK, int DV>
constexpr int dkdv_bytes() {
  return DkdvLayout<DQK, DV>::kBytes;
}
template <int DQK, int DV>
constexpr int dq_bytes() {
  return DqLayout<DQK, DV>::kBytes;
}

template <typename K>
cudaError_t set_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// the 2-D map over the row statistics, [B * H * 2, pitch] f32: boxes of
// 64 columns by 2 rows (a tile's lse and Delta slices), no swizzle
bool make_stat_map(CUtensorMap* map, const float* stats, int pitch,
                   int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)pitch, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)pitch * 4};
  cuuint32_t box[2] = {(cuuint32_t)BS, 2};
  cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<float*>(stats), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// strides: q, k, v, dO as (batch, seq, head) in elements; stats: f32
// scratch of B * H x 2 x pitch (each row's lse in log2 units, then its
// Delta)
template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* stats, void* dq, void* dk, void* dv,
           int B, int S, int H, int KV, const long long* st, int pitch,
           float scale, int causal, int window, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // the dK/dV kernel's maps: Q and dO in 64-row boxes, K and V in 128;
  // the query passes' the other way round
  CUtensorMap q64, o64, k128, v128, q128, o128, k64, v64, sm;
  if (!make_map(&q64, q, DQK, S, H, B, st[1], st[2], st[0], BS) ||
      !make_map(&o64, dout, DV, S, H, B, st[10], st[11], st[9], BS) ||
      !make_map(&k128, k, DQK, S, KV, B, st[4], st[5], st[3], BI) ||
      !make_map(&v128, v, DV, S, KV, B, st[7], st[8], st[6], BI) ||
      !make_map(&q128, q, DQK, S, H, B, st[1], st[2], st[0], BI) ||
      !make_map(&o128, dout, DV, S, H, B, st[10], st[11], st[9], BI) ||
      !make_map(&k64, k, DQK, S, KV, B, st[4], st[5], st[3], BS) ||
      !make_map(&v64, v, DV, S, KV, B, st[7], st[8], st[6], BS) ||
      !make_stat_map(&sm, stats, pitch, 2 * B * H))
    return (int)cudaErrorInvalidValue;
  constexpr int dqb = dq_bytes<DQK, DV>(), dkdvb = dkdv_bytes<DQK, DV>();
  static_assert(dqb <= 232448 && dkdvb <= 232448, "one block's shared memory");
  auto stk = bwd_wgmma_stats_kernel<DQK, DV>;
  auto dkdv = bwd_wgmma_dkdv_kernel<DQK, DV>;
  auto dqk = bwd_wgmma_dq_kernel<DQK, DV>;
  cudaError_t err = set_smem(stk, dqb);
  if (err == cudaSuccess) err = set_smem(dkdv, dkdvb);
  if (err == cudaSuccess) err = set_smem(dqk, dqb);
  if (err != cudaSuccess) return (int)err;
  // setmaxnreg moves registers within the block's own allocation: a
  // kernel compiled to fewer than its producer and consumers take would
  // wait for ever at the increase, so it is refused here
  for (const void* kern :
       {(const void*)stk, (const void*)dkdv, (const void*)dqk}) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return (int)err;
    if (fa.numRegs * THREADS < 128 * (REGS_PRODUCER + NWG * REGS_CONSUMER))
      return (int)cudaErrorInvalidConfiguration;
  }
  const float c = scale * LOG2E;
  const int tiles = (S + BI - 1) / BI;
  const int q_items = B * H * tiles, k_items = B * KV * tiles;
  stk<<<min(q_items, sms), THREADS, dqb, stream>>>(
      q128, k64, v64, o128, lse, stats, pitch, S, H, KV, B * H, q_items, c,
      causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv<<<min(k_items, sms), THREADS, dkdvb, stream>>>(
      q64, k128, v128, o64, sm, (bf*)dk, (bf*)dv, S, H, KV, B * KV, k_items,
      c, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<min(q_items, sms), THREADS, dqb, stream>>>(
      q128, k64, v64, o128, stats, pitch, (bf*)dq, S, H, KV, B * H, q_items,
      c, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// 9b's Hopper design (flash_attention.plan_flash_bwd "tma_wgmma").  q, k,
// v as the forward took them and dout its output's gradient, all bf16
// [B, S, heads, width] (q and k D wide, v and dout Dv) with strides
// (batch, seq, head) in elements and a contiguous last dim; lse the
// forward's f32 log-sum-exp at lse[(b * H + h) * lse_pitch + row]; stats
// f32 scratch of B * H x 2 x lse_pitch; dq [B, S, H, D], dk [B, S, KV, D]
// and dv [B, S, KV, Dv] contiguous bf16 outputs.  smem: the shared bytes
// of the statistics, dK/dV and dQ kernels, which must be
// flash_attention.plan_flash_bwd's.  Returns cudaErrorInvalidValue with
// nothing launched for what the design does not take -- (D, Dv) not
// (64, 64), (128, 128) or (192, 128), a base not 16-byte aligned, a
// stride not a positive multiple of 8 elements, a pitch below S or not a
// multiple of 64 -- or for other bytes; otherwise cudaGetLastError().
extern "C" int flash_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* stats, void* dq, void* dk, void* dv, int B, int S,
    int H, int KV, int D, int Dv, long long qsb, long long qss,
    long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long dsb, long long dss,
    long long dsh, int lse_pitch, float scale, int causal, int window,
    int smem_stats, int smem_dkdv, int smem_dq, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, dsb, dss, dsh};
  const bool shape = ((D == 64 || D == 128) && Dv == D) ||
                     (D == 192 && Dv == 128);
  const int dkdv = D == 64    ? dkdv_bytes<64, 64>()
                   : D == 128 ? dkdv_bytes<128, 128>()
                              : dkdv_bytes<192, 128>();
  const int dqb = D == 64    ? dq_bytes<64, 64>()
                  : D == 128 ? dq_bytes<128, 128>()
                             : dq_bytes<192, 128>();
  bool ok = shape && KV >= 1 && H % KV == 0 && window >= 0 &&
            lse_pitch >= S && lse_pitch % BS == 0 && smem_stats == dqb &&
            smem_dkdv == dkdv && smem_dq == dqb;
  for (const void* p : {q, k, v, dout, lse, (const void*)stats,
                        (const void*)dq, (const void*)dk, (const void*)dv})
    ok = ok && (uintptr_t)p % 16 == 0;
  for (long long x : st) ok = ok && x > 0 && x % 8 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* sc = (float*)stats;
  if (D == 64)
    return launch<64, 64>(q, k, v, dout, l, sc, dq, dk, dv, B, S, H, KV, st,
                          lse_pitch, scale, causal, window, s);
  if (D == 128)
    return launch<128, 128>(q, k, v, dout, l, sc, dq, dk, dv, B, S, H, KV,
                            st, lse_pitch, scale, causal, window, s);
  return launch<192, 128>(q, k, v, dout, l, sc, dq, dk, dv, B, S, H, KV, st,
                          lse_pitch, scale, causal, window, s);
}
