// Error strings for the launchers' cudaError_t return codes.
#include <cuda_runtime.h>

extern "C" const char* ctts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
