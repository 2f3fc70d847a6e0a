// Corpus case: a __global__ kernel no contract names (KC01).
//
// It compiles and could be launched from C, but nothing states its
// shapes, shared memory or parity, so no rule can check it.
#include <cuda_runtime.h>

namespace {

__global__ void thing_kernel(float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  acc += 1.0f;
  out[i] = acc;
}

__global__ void stray_kernel(float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = 0.0f;
}

}  // namespace

extern "C" int thing_launch(float* out, int n, void* stream) {
  const unsigned blocks = (unsigned)((n + 255) / 256);
  thing_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, n);
  return (int)cudaGetLastError();
}
