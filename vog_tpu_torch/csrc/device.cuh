// The device guard of every C entry point.
//
// A wrapper's ctypes call runs on whichever thread calls it: the main
// thread, a serving thread, autograd's worker thread for the device.  The
// CUDA runtime launches on that thread's current device, which need not be
// the device of the tensors (the stream handle the wrapper passes is
// theirs).  Each entry point therefore takes the tensors' device ordinal
// and opens a DeviceGuard first: it makes that device current when another
// one is, and gives the previous one back when the entry point returns.
// Where the device already is current nothing is set (a CUDA graph capture
// may be running on the caller's stream).
#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  int prev = -1;
  bool switched = false;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
      switched = err == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};

// Opens the guard for ``device`` and returns its error, if any, from the
// enclosing entry point.
#define VOG_DEVICE_GUARD(device)        \
  DeviceGuard vog_device_guard_(device); \
  if (vog_device_guard_.err != cudaSuccess) return (int)vog_device_guard_.err
