// Corpus case: a C constant for a block's shared memory that differs
// from the one the Python plans use (KC03).
//
// A plan sized by one and refused by the other fails only on the card.
#include <cuda_runtime.h>

namespace {

constexpr size_t SMEM_MAX = 232449;   // one byte past the opt-in

__global__ void thing_kernel(float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
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
