// decayed_scatter: out[u, i] = sum_{n,b} w[u, n] * [ids[u, n, b] == i].
//
// Replaces the TPU kernel repro/kernels/decayed_scatter.py ::
// decayed_scatter (and batched_decayed_scatter, its vmap over users):
// the Eq. 1+2 from-scratch TIFU-kNN user vector.  The TPU kernel builds a
// [bn*B, bi] one-hot tile per (item tile, row tile) grid step and reduces
// it on the VPU: O(N*B*I) compares per user, and it needs I % bi == 0.
// Here the work follows the ids instead of the items.
//
// Design: two kernels on the wrapper's stream.  The first writes zeros
// over the whole [U, I] output in 16-byte stores.  The second takes one block per user row and walks the row's
// N*B entries in chunks of CHUNK: the valid entries of a chunk (ids in
// [0, I)) go to shared memory as 64-bit keys (id << 32 | entry index),
// a bitonic sort orders them by (id, entry), and the head of each run of
// equal ids sums the run's weights in entry order, starting from the
// cell's current value, and writes the cell once.  Every cell is thus
// 0 + w_1 + w_2 + ... added left to right in (n, b) order, the order of a
// sequential scatter-add: no float atomics, and reruns agree bitwise.
// Any N, B and I (no divisibility condition); I < 2^31.
//
// Bound: bytes.  The [U, I] f32 write is the traffic (669 MB for all
// 13,949 TaFeng users against 30 MB of ids); the sort of the ~35 valid
// entries of a typical user row is a few hundred shared-memory steps.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4096;   // entries sorted at a time (32 KB of keys)

// out is the wrapper's fresh allocation, so 16-byte aligned
__global__ void zero_rows(float* __restrict__ out, long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float4* o4 = reinterpret_cast<float4*>(out);
  long long n4 = n / 4;
  for (long long p = t; p < n4; p += stride)
    o4[p] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long p = n4 * 4 + t; p < n; p += stride) out[p] = 0.f;
}

__global__ void __launch_bounds__(THREADS) scatter_rows(
    float* __restrict__ out, const int* __restrict__ ids,
    const float* __restrict__ w, int n, int b, int n_items) {
  __shared__ unsigned long long keys[CHUNK];
  __shared__ int count;
  const int u = blockIdx.x;
  const long long e_row = (long long)n * b;
  const int* row_ids = ids + (long long)u * e_row;
  const float* row_w = w + (long long)u * n;
  float* row_out = out + (long long)u * n_items;

  for (long long c0 = 0; c0 < e_row; c0 += CHUNK) {
    const int len = (int)(e_row - c0 < CHUNK ? e_row - c0 : CHUNK);
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    // gather the chunk's valid entries (their slot order does not matter:
    // the key carries the entry index, and the sort fixes the order)
    for (int e = threadIdx.x; e < len; e += THREADS) {
      int id = row_ids[c0 + e];
      if (id >= 0 && id < n_items) {
        int slot = atomicAdd(&count, 1);
        keys[slot] = ((unsigned long long)(unsigned)id << 32) |
                     (unsigned)(c0 + e);
      }
    }
    __syncthreads();
    const int cnt = count;
    int p2 = 1;
    while (p2 < cnt) p2 <<= 1;
    for (int i = cnt + threadIdx.x; i < p2; i += THREADS)
      keys[i] = ~0ull;
    __syncthreads();   // every thread has read count before it is reset
    if (cnt == 0) continue;                   // uniform across the block
    // bitonic sort of keys[0, p2), ascending
    for (int size = 2; size <= p2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = threadIdx.x; i < p2 / 2; i += THREADS) {
          int lo = 2 * i - (i & (stride - 1));
          int hi = lo + stride;
          bool up = (lo & size) == 0;
          unsigned long long a = keys[lo], bb = keys[hi];
          if ((a > bb) == up) {
            keys[lo] = bb;
            keys[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    // one thread per run head: continue the cell's left-to-right sum
    for (int i = threadIdx.x; i < cnt; i += THREADS) {
      unsigned id = (unsigned)(keys[i] >> 32);
      if (i > 0 && (unsigned)(keys[i - 1] >> 32) == id) continue;
      float acc = row_out[id];
      for (int j = i; j < cnt && (unsigned)(keys[j] >> 32) == id; ++j) {
        unsigned e = (unsigned)(keys[j] & 0xffffffffu);
        acc += row_w[e / b];
      }
      row_out[id] = acc;
    }
    __syncthreads();   // the next chunk's heads read these cells
  }
}

}  // namespace

extern "C" int decayed_scatter_launch(void* out, const void* ids,
                                      const void* w, int u, int n, int b,
                                      int n_items, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long total = (long long)u * n_items;
  if (total > 0) {
    long long want = (total / 4 + THREADS - 1) / THREADS;
    if (want < 1) want = 1;
    unsigned blocks = (unsigned)(want < 132LL * 16 ? want : 132LL * 16);
    zero_rows<<<blocks, THREADS, 0, s>>>((float*)out, total);
  }
  if (u > 0 && (long long)n * b > 0 && n_items > 0)
    scatter_rows<<<u, THREADS, 0, s>>>((float*)out, (const int*)ids,
                                        (const float*)w, n, b, n_items);
  return (int)cudaGetLastError();
}
