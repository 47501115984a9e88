// The C boundary every kernel library of the port shares (each csrc/*.cu
// includes this once, so each library carries one copy).
//
// Each extern "C" entry point takes the device index of its tensors and
// PyTorch's current stream on that device last, and returns a cudaError_t
// (0 on success); utils/cuda_build.py binds and calls them all the same way.

#pragma once

#include <cuda_runtime.h>

namespace sstpu {

// Makes `dev` the current device for a launch, only when it is not already,
// and switches back on leaving the scope.  The usual call, on the current
// device, costs one cudaGetDevice.
class OnDevice {
 public:
  explicit OnDevice(int dev) {
    int cur = 0;
    err_ = cudaGetDevice(&cur);
    if (err_ == cudaSuccess && cur != dev) {
      err_ = cudaSetDevice(dev);
      if (err_ == cudaSuccess) prev_ = cur;
    }
  }
  ~OnDevice() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  OnDevice(const OnDevice&) = delete;
  OnDevice& operator=(const OnDevice&) = delete;
  cudaError_t error() const { return err_; }

 private:
  cudaError_t err_;
  int prev_ = -1;
};

}  // namespace sstpu

extern "C" const char* sstpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
