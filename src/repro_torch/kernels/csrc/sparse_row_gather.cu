// sparse_row_gather: out[r, w] = table[rows[r], ids[r, w]]; ids outside
// [0, I) read 0, rows clamp to [0, M).
//
// Replaces the TPU kernel repro/kernels/sparse_row_gather.py ::
// sparse_row_gather (a tile-planned one-hot compare-and-reduce, there
// because the TPU dislikes data-dependent gathers).  Hopper gathers
// directly: one thread per (r, w), any n_items, no tile plan.
//
// Bound: launch latency.  U*W is a few hundred thousand elements at
// most (4 bytes of index in, 4 of table and 4 of output per element),
// microseconds of HBM time, so the design spends nothing on tiling and
// launches one flat grid.
#include <cuda_runtime.h>

static __global__ void sparse_row_gather_kernel(
    const float* __restrict__ table, const int* __restrict__ rows,
    const int* __restrict__ ids, float* __restrict__ out, int M, int I,
    long long n, int W) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  int r = (int)(e / W);
  int id = ids[e];
  int row = min(max(rows[r], 0), M - 1);
  out[e] = (id >= 0 && id < I) ? table[(size_t)row * I + id] : 0.0f;
}

extern "C" int srg_launch(const void* table, const void* rows,
                          const void* ids, void* out, int M, int I, int U,
                          int W, void* stream) {
  long long n = (long long)U * W;
  if (n > 0) {
    const int threads = 256;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    sparse_row_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const int*)rows, (const int*)ids, (float*)out,
        M, I, n, W);
  }
  return (int)cudaGetLastError();
}
