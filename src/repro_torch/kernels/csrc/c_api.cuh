// The part of the plain C interface that every library of the port shares.
// Each csrc/<name>.cu builds into a library of its own and includes this
// header once.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
