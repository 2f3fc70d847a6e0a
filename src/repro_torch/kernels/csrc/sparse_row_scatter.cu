// sparse_row_scatter: table[rows[r], ids[r, w]] += vals[r, w], in place;
// ids outside [0, I) are skipped, rows clamp to [0, M), duplicate
// (row, id) pairs accumulate.
//
// Replaces the TPU kernel repro/kernels/sparse_row_scatter.py ::
// sparse_row_scatter, whose wrapper sorts the (row, tile) visits before
// the pallas_call so that the revisits of one output block are
// consecutive grid steps.  Here the plan is built on the card inside the
// one launch: the wrapper checks its inputs and launches, nothing more
// (no sort, no key tensor, no cast: rows and ids are read as given,
// int32 or int64 each).
//
// One block per entry row r.  The block clamps rows[r] and scans
// rows[0..U): if an earlier entry row names the same table row it exits,
// so the first entry row of each run of equal rows (its head) owns the
// table row.  The head walks the entries (r', w) of every r' >= r that
// names its row, in entry order, kTile at a time (kPer coalesced loads
// in flight a thread), stages the valid ones in shared memory as a key
// (id, slot) and a value, kChunk at a time, sorts each chunk by key
// (bitonic), and the first thread of each run of equal ids reads its
// cell once, adds the run's values in slot order and writes the cell
// once.  Chunks go in entry order with a __syncthreads() between them;
// a slab of kThreads entries that does not fit flushes the chunk first,
// inside a tile or at its start (sparse_row_scatter.chunk_flushes says
// where, for the checks).
//
// Determinism: no float atomics.  Every cell gets its deltas added one
// at a time in entry order, the order of a sequential scatter-add, in
// any chunk layout, so reruns agree bitwise and the result is bitwise
// ref.sparse_row_scatter_ordered_ref.
//
// Bound: launch latency at the appliers' sub-batch (U = 512 rows, W =
// 168 ids: about 1 MB, microseconds of HBM time).  What the design
// saves is the host's work: one launch a call in place of a cast, eight
// key ops, a radix sort and a gather.  Two costs grow past that: every
// block reads all U rows (U^2 reads in all, from L2), and a run's head
// walks all its L x W ids alone, one tile latency per kTile of them (a
// sub-batch's padding rows alias user 0 and form one run).  Against the
// sort's device time on an H100 (tools/dtiled_phase_split.py --kernel
// sparse_row_scatter, W = 168): U distinct users reach it at U = 16,384
// (0.59 against 0.61 ms, 0.12-0.25 of it the row scan), and the fullest
// pow2 bucket, half of it padding, passes it at U = 4,096 (0.22 against
// 0.18 ms; 1.12 against 0.53 at 16,384).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                    // entries a thread loads a tile
constexpr int kTile = kThreads * kPer;     // entries read at once
constexpr int kChunk = 2048;               // entries staged at once
constexpr int kApply = kChunk / kThreads;  // sorted entries a thread adds

template <typename R>
__device__ __forceinline__ long long clamped_row(const R* rows, int r,
                                                 long long M) {
  const long long v = (long long)rows[r];
  return v < 0 ? 0 : (v >= M ? M - 1 : v);
}

// Exclusive prefix sum of ``v`` over the block's threads in thread
// order, and the sum of all (``total``).  Every thread calls it.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += x;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int c = s_warp[i];
    before += i < warp ? c : 0;
    total += c;
  }
  __syncthreads();                 // s_warp is free for the next call
  return before + inc - v;
}

// Sorts s_key[0, n) ascending (bitonic, padded to a power of two with
// keys above every real one), then adds each run of equal ids to its
// cell in slot order: one read and one write a cell, the reads issued
// together.  Its first __syncthreads() publishes the staged entries.
__device__ __forceinline__ void flush_chunk(
    float* __restrict__ cells, unsigned long long* s_key,
    const float* s_val, int n) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int i = n + (int)threadIdx.x; i < n2; i += kThreads)
    s_key[i] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n2 >> 1); p += kThreads) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const unsigned long long a = s_key[i], b = s_key[i + j];
        if ((a > b) == ((i & k) == 0)) {
          s_key[i] = b;
          s_key[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  float acc[kApply];
  bool head[kApply];
#pragma unroll
  for (int j = 0; j < kApply; ++j) {
    const int s = threadIdx.x + j * kThreads;
    const unsigned id = (unsigned)(s_key[s] >> 32);
    head[j] = s < n && (s == 0 || (unsigned)(s_key[s - 1] >> 32) != id);
    acc[j] = cells[head[j] ? id : 0];       // unconditional: in flight together
  }
#pragma unroll
  for (int j = 0; j < kApply; ++j) {
    if (!head[j]) continue;
    const int s = threadIdx.x + j * kThreads;
    const unsigned id = (unsigned)(s_key[s] >> 32);
    for (int q = s; q < n && (unsigned)(s_key[q] >> 32) == id; ++q)
      acc[j] += s_val[(unsigned)s_key[q]];
    cells[id] = acc[j];
  }
  __syncthreads();                 // cells written, staging free again
}

template <typename R, typename Ix>
__global__ void __launch_bounds__(kThreads) sparse_row_scatter_kernel(
    float* __restrict__ table, const R* __restrict__ rows,
    const Ix* __restrict__ ids, const float* __restrict__ vals, int M,
    int I, int U, int W) {
  __shared__ unsigned long long s_key[kChunk];   // (id << 32) | slot
  __shared__ float s_val[kChunk];
  __shared__ int s_run[kThreads];
  __shared__ int s_warp[kWarps];
  __shared__ int s_count[kPer][kWarps];

  // the run's head owns the table row: a block whose row an earlier
  // entry row names exits; a head that no later entry row shares walks
  // its own row alone
  const int r = blockIdx.x;
  const long long row = clamped_row(rows, r, M);
  bool before = false, after = false;
#pragma unroll 4
  for (int t = threadIdx.x; t < U; t += kThreads) {
    const bool same = clamped_row(rows, t, M) == row;
    before |= same && t < r;
    after |= same && t > r;
  }
  if (__syncthreads_or(before)) return;
  const bool alone = !__syncthreads_or(after);
  float* __restrict__ cells = table + row * (long long)I;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a thread's entry moves kThreads on a slab: step_rows rows, step_w ids
  const int step_rows = kThreads / W, step_w = kThreads % W;

  int n = 0;                                  // entries staged (uniform)
  // the run's rows, kThreads candidates at a time from the head on
  const int t_end = alone ? r + 1 : U;
  for (int t0 = r; t0 < t_end; t0 += kThreads) {
    int nrun = 1;
    if (alone) {
      if (threadIdx.x == 0) s_run[0] = r;
    } else {
      const int t = t0 + threadIdx.x;
      const bool same = t < U && clamped_row(rows, t, M) == row;
      const int at = block_scan(same, s_warp, nrun);
      if (same) s_run[at] = t;
    }
    __syncthreads();
    // entry f = f0 + j * kThreads + threadIdx.x of the rows s_run[0, nrun)
    // is id w of row s_run[i]; a tile is kPer slabs of kThreads entries
    int i = threadIdx.x / W, w = threadIdx.x % W;
    for (int f0 = 0; f0 < nrun * W; f0 += kTile) {
      unsigned id_r[kPer];
      float v_r[kPer];
      unsigned own = 0;
      // every load unconditional (an entry past the run reads the run's
      // first one and is not owned), so a tile's loads are in flight
      // together
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool in = i < nrun;
        const long long e = (long long)s_run[in ? i : 0] * W + (in ? w : 0);
        const long long id = (long long)ids[e];
        v_r[j] = vals[e];
        id_r[j] = (unsigned)id;
        own |= (unsigned)(in && id >= 0 && id < I) << j;
        i += step_rows;
        w += step_w;
        if (w >= W) {
          w -= W;
          ++i;
        }
      }
      // a tile of no valid id stages nothing (padding rows): one barrier
      if (!__syncthreads_or(own)) continue;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const unsigned b = __ballot_sync(0xffffffffu, (own >> j) & 1u);
        if (lane == 0) s_count[j][warp] = __popc(b);
      }
      __syncthreads();
      // slab j in thread order; a slab that does not fit flushes first
      int start = 0;
      for (;;) {
        int stop = kPer;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          if (j < start || j >= stop) continue;
          int before_warp = 0, total = 0;
#pragma unroll
          for (int q = 0; q < kWarps; ++q) {
            const int c = s_count[j][q];
            before_warp += q < warp ? c : 0;
            total += c;
          }
          if (n + total > kChunk) {
            stop = j;
            continue;
          }
          const unsigned b = __ballot_sync(0xffffffffu, (own >> j) & 1u);
          if ((own >> j) & 1u) {
            const int slot = n + before_warp + __popc(b & ((1u << lane) - 1u));
            s_key[slot] = (unsigned long long)id_r[j] << 32 | (unsigned)slot;
            s_val[slot] = v_r[j];
          }
          n += total;
        }
        if (stop == kPer) break;
        flush_chunk(cells, s_key, s_val, n);
        n = 0;
        start = stop;
      }
      __syncthreads();                         // s_count is read
    }
    __syncthreads();                           // s_run is read
  }
  if (n > 0) flush_chunk(cells, s_key, s_val, n);
}

template <typename R, typename Ix>
void launch(void* table, const void* rows, const void* ids, const void* vals,
            int M, int I, int U, int W, cudaStream_t stream) {
  sparse_row_scatter_kernel<R, Ix><<<U, kThreads, 0, stream>>>(
      (float*)table, (const R*)rows, (const Ix*)ids, (const float*)vals, M,
      I, U, W);
}

}  // namespace

// index_bits: bit 0 set when rows are int64 (else int32), bit 1 when ids
// are int64 (else int32).
extern "C" int srs_launch(void* table, const void* rows, const void* ids,
                          const void* vals, int M, int I, int U, int W,
                          int index_bits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (U > 0 && W > 0) {
    switch (index_bits) {
      case 0: launch<int32_t, int32_t>(table, rows, ids, vals, M, I, U, W, st);
        break;
      case 1: launch<int64_t, int32_t>(table, rows, ids, vals, M, I, U, W, st);
        break;
      case 2: launch<int32_t, int64_t>(table, rows, ids, vals, M, I, U, W, st);
        break;
      case 3: launch<int64_t, int64_t>(table, rows, ids, vals, M, I, U, W, st);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
