// Corpus case: a double in a kernel source (KC06).
//
// The H100 runs fp64 at a fraction of fp32's rate, and the plain
// version sums in fp32: the kernel no longer matches it.
#include <cuda_runtime.h>

namespace {

__global__ void thing_kernel(float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  double wide = 1.0;
  acc += (float)wide;
  out[i] = acc;
}

}  // namespace

extern "C" int thing_launch(float* out, int n, void* stream) {
  const unsigned blocks = (unsigned)((n + 255) / 256);
  thing_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, n);
  return (int)cudaGetLastError();
}
