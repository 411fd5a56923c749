// DeviceGuard: make `device` current for one C entry and give the caller's
// device back on every return path.
//
// Every extern "C" qnn_* entry launches on the device its tensors lie on,
// and the thread's current device is state its caller owns: PyTorch puts a
// later device="cuda" tensor on it.  So an entry switches the device only
// inside the guard's scope, and the destructor restores the saved one after
// the return value has been computed (a cudaGetLastError of the launch
// reads the launch, not the restore).
#pragma once

#include <cuda_runtime.h>

namespace qnn {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    error_ = cudaGetDevice(&saved_);
    if (error_ == cudaSuccess && saved_ != device) {
      error_ = cudaSetDevice(device);
      switched_ = error_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(saved_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // cudaSuccess, or why the device could not be made current.
  cudaError_t error() const { return error_; }

 private:
  int saved_ = 0;
  bool switched_ = false;
  cudaError_t error_ = cudaSuccess;
};

}  // namespace qnn
