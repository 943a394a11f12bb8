// Error text for the codes the kernel entry points return, so the Python
// wrappers can raise with cudaGetErrorString's message.
#include <cuda_runtime.h>

extern "C" const char* dclip_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
