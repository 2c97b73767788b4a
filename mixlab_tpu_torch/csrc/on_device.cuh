// The card a C entry point launches on, shared by every source here.
//
// A wrapper's tensors may lie on another card than the one current in the
// calling thread.  OnDevice makes `device` current for its scope when it is
// not already (one cudaGetDevice when it is), and the previous card current
// again at the end, as torch.cuda.device does in Python at a fraction of
// its host cost.

#pragma once

#include <cuda_runtime.h>

class OnDevice {
 public:
  explicit OnDevice(int device) {
    int current = 0;
    error_ = cudaGetDevice(&current);
    if (error_ == cudaSuccess && current != device) {
      error_ = cudaSetDevice(device);
      if (error_ == cudaSuccess) previous_ = current;
    }
  }
  ~OnDevice() {
    if (previous_ >= 0) cudaSetDevice(previous_);
  }
  OnDevice(const OnDevice&) = delete;
  OnDevice& operator=(const OnDevice&) = delete;

  cudaError_t error() const { return error_; }

 private:
  int previous_ = -1;
  cudaError_t error_;
};
