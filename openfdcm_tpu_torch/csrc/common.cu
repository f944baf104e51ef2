// Shared C entry of the kernel library: CUDA error names for the wrappers'
// exceptions (each launch function returns cudaGetLastError()).
#include <cuda_runtime.h>

extern "C" const char* fdcm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
