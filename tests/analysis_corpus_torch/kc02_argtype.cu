// Corpus case: the C prototype takes long long where ctypes passes
// c_int (KC02).
//
// On x86-64 the callee reads a 64-bit register of which ctypes set
// only the low half: n is garbage.
#include <cuda_runtime.h>

namespace {

__global__ void thing_kernel(float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  acc += 1.0f;
  out[i] = acc;
}

}  // namespace

extern "C" int thing_launch(float* out, long long n, void* stream) {
  const unsigned blocks = (unsigned)((n + 255) / 256);
  thing_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, (int)n);
  return (int)cudaGetLastError();
}
