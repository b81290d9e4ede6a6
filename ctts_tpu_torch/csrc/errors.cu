// Error strings for the launchers' cudaError_t return codes, an empty
// kernel (the launch floor that chip_smoke.py times beside the kernels
// whose bound is below it), and the device this library's statically
// linked CUDA runtime takes as current (chip_smoke.py holds it to
// PyTorch's under torch.cuda.device).
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" const char* ctts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int ctts_empty(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ctts_current_device(int* device) {
  return static_cast<int>(cudaGetDevice(device));
}
