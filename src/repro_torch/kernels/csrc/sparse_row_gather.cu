// sparse_row_gather: out[r, w] = table[rows[r], ids[r, w]]; ids outside
// [0, I) read 0, rows clamp to [0, M).
//
// Replaces the TPU kernel repro/kernels/sparse_row_gather.py ::
// sparse_row_gather (a tile-planned one-hot compare-and-reduce, there
// because the TPU dislikes data-dependent gathers).  Hopper gathers
// directly: one thread per (r, w), any n_items, no tile plan.
//
// Bound: launch latency.  U*W is a few hundred thousand elements at
// most (4 or 8 bytes of index in, 4 of table and 4 of output per
// element), microseconds of HBM time, so the design spends nothing on
// tiling and launches one flat grid.  It reads the index tensors as the
// caller holds them, int32 or int64 each (the update appliers pass
// int64 rows and int32 ids), so the wrapper launches no cast.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename R, typename Ix>
__global__ void sparse_row_gather_kernel(
    const float* __restrict__ table, const R* __restrict__ rows,
    const Ix* __restrict__ ids, float* __restrict__ out, int M, int I,
    long long n, int W) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  long long r = e / W;
  long long id = (long long)ids[e];
  long long row = min(max((long long)rows[r], 0LL), (long long)M - 1);
  out[e] = (id >= 0 && id < I) ? table[row * I + id] : 0.0f;
}

template <typename R, typename Ix>
void launch(const void* table, const void* rows, const void* ids, void* out,
            int M, int I, long long n, int W, cudaStream_t stream) {
  const int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  sparse_row_gather_kernel<R, Ix><<<blocks, threads, 0, stream>>>(
      (const float*)table, (const R*)rows, (const Ix*)ids, (float*)out, M,
      I, n, W);
}

}  // namespace

// index_bits: bit 0 set when rows are int64 (else int32), bit 1 when ids
// are int64 (else int32).
extern "C" int srg_launch(const void* table, const void* rows,
                          const void* ids, void* out, int M, int I, int U,
                          int W, int index_bits, void* stream) {
  long long n = (long long)U * W;
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    switch (index_bits) {
      case 0: launch<int32_t, int32_t>(table, rows, ids, out, M, I, n, W, st);
        break;
      case 1: launch<int64_t, int32_t>(table, rows, ids, out, M, I, n, W, st);
        break;
      case 2: launch<int32_t, int64_t>(table, rows, ids, out, M, I, n, W, st);
        break;
      case 3: launch<int64_t, int64_t>(table, rows, ids, out, M, I, n, W, st);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
