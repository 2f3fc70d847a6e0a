// Corpus case: a running accumulator declared __half (KC08).
//
// Each addition rounds to 11 bits; the contract declares a float sum.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

__global__ void thing_kernel(float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  __half acc = __float2half(0.0f);
  acc = __hadd(acc, __float2half(1.0f));
  out[i] = __half2float(acc);
}

}  // namespace

extern "C" int thing_launch(float* out, int n, void* stream) {
  const unsigned blocks = (unsigned)((n + 255) / 256);
  thing_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, n);
  return (int)cudaGetLastError();
}
