// The host side's context binding, shared by every C entry that encodes a
// tensor map (through sm90_common.cuh, and by fp8_matmul.cu directly).

#pragma once

#include <cuda_runtime.h>

namespace {

// Makes `device` current for the calling thread and binds its primary
// context: a thread that has made no CUDA runtime call yet has none bound,
// and cuTensorMapEncodeTiled then refuses to encode a tensor map.
// *previous gets the thread's device before the call, to restore where it
// differs.
cudaError_t bind_device(int device, int* previous) {
  const cudaError_t err = cudaGetDevice(previous);
  return err != cudaSuccess ? err : cudaSetDevice(device);
}

}  // namespace
