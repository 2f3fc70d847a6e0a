// Corpus case: PTX ex2.approx in an exact-parity kernel (KC07).
//
// The inline assembly bypasses the compiler's precise exp2f.
#include <cuda_runtime.h>

namespace {

__global__ void thing_kernel(float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"((float)i));
  acc += y;
  out[i] = acc;
}

}  // namespace

extern "C" int thing_launch(float* out, int n, void* stream) {
  const unsigned blocks = (unsigned)((n + 255) / 256);
  thing_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, n);
  return (int)cudaGetLastError();
}
