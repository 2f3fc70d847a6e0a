// Corpus case: a launch past 48 KiB of dynamic shared memory whose
// source never raises the kernel's limit (KC03).
//
// Without cudaFuncAttributeMaxDynamicSharedMemorySize the launch fails
// at run time.
#include <cuda_runtime.h>

namespace {

__global__ void thing_kernel(float* __restrict__ out, int n) {
  extern __shared__ float tile[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  tile[threadIdx.x] = 1.0f;
  acc += tile[threadIdx.x];
  out[i] = acc;
}

}  // namespace

extern "C" int thing_launch(float* out, int n, void* stream) {
  const int bytes = 256 * 64 * (int)sizeof(float);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  thing_kernel<<<blocks, 256, bytes, (cudaStream_t)stream>>>(out, n);
  return (int)cudaGetLastError();
}
