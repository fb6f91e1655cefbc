// The span marker of colddiff_torch/tracing.py, on Hopper (sm_90a).
//
// While a torch.profiler session is active, each boundary of a span of the
// port launches this kernel on the current stream, so that the device
// operations between a span's two markers in the profiler's trace are the
// ones launched inside the span.  It computes nothing: one thread spins on
// the SM clock for `cycles` cycles (2,000 read 1.9 us in an H100's trace),
// long enough that the profiler records every launch.  Its name is the
// port's alone: the benchmark's own markers are torch's spin_kernel, and
// its roofline readers sum kernels named convnext_front*.
//
// Replaces no TPU kernel: the JAX package has no spans of its own, only
// the Trainer's jax.profiler window (colddiff/train.py:427-436).

#include <cuda_runtime.h>

extern "C" __global__ void colddiff_trace_mark(long long cycles) {
  const long long start = clock64();
  while (clock64() - start < cycles) {
  }
}

// C entry point, bound with ctypes by colddiff_torch/tracing.py.  Returns
// the cudaError_t of the launch (0 = launched).
extern "C" int colddiff_trace_mark_launch(long long cycles, void* stream) {
  colddiff_trace_mark<<<1, 1, 0, (cudaStream_t)stream>>>(cycles);
  return (int)cudaGetLastError();
}
