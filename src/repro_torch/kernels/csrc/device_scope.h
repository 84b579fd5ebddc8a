// The device of one C entry's launch, set for the entry's span only.
//
// cudaSetDevice changes the calling host thread's current device, which
// PyTorch also reads (an allocation on a bare "cuda" lands there). An
// entry that set the device of its tensors and left it set would move the
// caller's current device whenever it launched on another card, so each
// entry holds a DeviceScope: it records the current device, sets the
// launch's, and gives the recorded one back when the entry returns.
#pragma once

#include <cuda_runtime.h>

struct DeviceScope {
  int prev = -1;
  cudaError_t err;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err != cudaSuccess) {
      prev = -1;
      return;
    }
    err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
};
