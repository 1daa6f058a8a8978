// Error text for the cudaError_t values that the kernel entry points return.

#include <cuda_runtime.h>

extern "C" const char* im2im_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
