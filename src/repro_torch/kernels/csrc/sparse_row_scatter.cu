// sparse_row_scatter: table[rows[r], ids[r, w]] += vals[r, w], in place.
//
// Replaces the TPU kernel repro/kernels/sparse_row_scatter.py ::
// sparse_row_scatter, whose tile plan sorts the (row, tile) visits so
// that revisits of one output block are consecutive grid steps.  Here
// the wrapper sorts flat cell keys row*I + id instead (a stable sort,
// the counterpart of the JAX wrapper's argsort + build_plan, which also
// run outside the pallas_call); invalid entries carry the key M*I and
// sort last.
//
// Determinism: no float atomics.  One thread per run head of equal keys
// reads the cell once, adds the run's values in their original order
// (the sort is stable) and writes the cell once -- the same order of
// additions as a sequential scatter-add, so reruns agree bitwise.
//
// Bound: launch latency.  A sub-batch moves well under 10 MB (keys,
// values and the touched cells), so the design needs no tiling.
#include <cuda_runtime.h>

static __global__ void sparse_row_scatter_kernel(
    float* __restrict__ table, const long long* __restrict__ keys,
    const float* __restrict__ vals, long long n, long long limit) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  long long key = keys[p];
  if (key >= limit) return;                   // invalid entries sort last
  if (p > 0 && keys[p - 1] == key) return;    // not the head of its run
  float acc = table[key];
  for (long long s = p; s < n && keys[s] == key; ++s) acc += vals[s];
  table[key] = acc;
}

extern "C" int srs_launch(void* table, const void* keys, const void* vals,
                          long long n, long long limit, void* stream) {
  if (n > 0) {
    const int threads = 256;
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    sparse_row_scatter_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (float*)table, (const long long*)keys, (const float*)vals, n, limit);
  }
  return (int)cudaGetLastError();
}
