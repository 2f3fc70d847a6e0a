// Corpus case: the contract declares a tail guard the kernel no longer
// holds (KC04).
//
// The guard was rewritten as a clamp of the index; the contract still
// names the old one, so nothing states what protects the tail.
#include <cuda_runtime.h>

namespace {

__global__ void thing_kernel(float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > n - 1) return;
  float acc = 0.0f;
  acc += 1.0f;
  out[i] = acc;
}

}  // namespace

extern "C" int thing_launch(float* out, int n, void* stream) {
  const unsigned blocks = (unsigned)((n + 255) / 256);
  thing_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, n);
  return (int)cudaGetLastError();
}
