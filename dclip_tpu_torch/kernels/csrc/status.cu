// Error text for the codes the kernel entry points return, so the Python
// wrappers can raise with cudaGetErrorString's message; and the loader's
// self-check, one tiny launch that doubles a buffer.
//
// The self-check replaces dclip_tpu/kernels/__init__.py `_copy` (K13, line
// 39: the x2 copy of an [8, 128] f32 block that `_pallas_probe_once` runs
// and compares before the JAX package trusts its Pallas toolchain). The
// port's loader (kernels/_build.py) runs it once per process, before it
// hands the library out, and raises on a mismatch; there is no watchdog,
// memo or fallback. Bound on the H100: launch latency (8 KB of traffic).
#include <cuda_runtime.h>

namespace {

__global__ void probe_x2_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = 2.f * x[i];
}

}  // namespace

extern "C" const char* dclip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: [n] f32 device buffers.
extern "C" int dclip_probe_x2(const void* x, void* y, int n, void* stream) {
  probe_x2_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return static_cast<int>(cudaGetLastError());
}
