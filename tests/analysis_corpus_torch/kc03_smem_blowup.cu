// Corpus case: the shared-memory model passes a block's opt-in at the
// declared max shapes (KC03).
//
// The launch fails with an invalid-argument error at those shapes, on
// the card only.
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
  cudaError_t err = cudaFuncSetAttribute(
      thing_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  thing_kernel<<<blocks, 256, bytes, (cudaStream_t)stream>>>(out, n);
  return (int)cudaGetLastError();
}
