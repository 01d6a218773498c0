// The error-string export every kernel library of raft_tpu_torch.ops
// carries: ops/_build.py loads it beside the kernel's entry point and
// turns a non-zero launch code into a message.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
