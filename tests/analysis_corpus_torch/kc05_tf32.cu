// Corpus case: a tf32 tensor-core product in an exact-parity source
// (KC05).
//
// tf32 rounds the fp32 operands to 10 mantissa bits: the scores no
// longer equal the plain version's fmaf chain.
#include <cuda_runtime.h>

namespace {

__global__ void thing_kernel(float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  unsigned a0 = 0u, a1 = 0u, b0 = 0u;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a0), "r"(a1), "r"(b0));
  acc += c0;
  acc += 1.0f;
  out[i] = acc;
}

}  // namespace

extern "C" int thing_launch(float* out, int n, void* stream) {
  const unsigned blocks = (unsigned)((n + 255) / 256);
  thing_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, n);
  return (int)cudaGetLastError();
}
