// The four probe kernels of scripts/bisect_mosaic.py, on Hopper (sm_90a).
//
// The JAX script bisected a Mosaic compiler crash in the TPU front kernel's
// lane-packed layout: each probe is one pl.pallas_call holding one construct
// of that kernel.  Here each probe computes what its TPU kernel computes, on
// fp32, with none of the TPU's VMEM blocks or 128-lane layout:
//
//   roll         (k_roll, :37-39)        out[r,j] = x[r, (j - shift) mod W]
//   roll + slice (k_roll_slice, :42-46)  the roll for j < split, x[r,j] after
//   masked_norm  (k_masked_norm, :49-61) x minus the mean of its 64-lane group
//   dyn_sublane  (k_dyn_sublane, :64-70) out[r,:] = sum_{dy<7} x[r+dy,:]
//
// All four are bound by bytes: each output element is one read (seven for
// dyn_sublane, six of them from L1/L2) and one write.  The designs keep every
// warp's loads and stores on 32 neighbouring addresses:
//   - the rolls are gathers with one thread per output element, so a warp
//     reads one contiguous run of x (two at the wrap);
//   - masked_norm gives each 64-element group one warp, two elements a lane,
//     and reduces the sum with shuffles;
//   - dyn_sublane gives each output element one thread and sums its seven
//     rows in the TPU kernel's order (row 0 first), so it rounds as the plain
//     version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 64;   // masked_norm: elements per mean (c = 64 on the TPU)
constexpr int kWindow = 7;   // dyn_sublane: rows per sum

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

__global__ void roll_kernel(const float* __restrict__ x, float* __restrict__ out,
                            long long n, int width, int shift, int split) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int j = (int)(i % width);
  long long row = i - j;
  int src = j;
  if (j < split) {
    src = j - shift;
    if (src < 0) src += width;
  }
  out[i] = x[row + src];
}

__global__ void masked_norm_kernel(const float* __restrict__ x, float* __restrict__ out,
                                   long long groups) {
  long long g = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  int lane = threadIdx.x % 32;
  if (g >= groups) return;  // whole warps leave together
  const float* xg = x + g * kGroup;
  float a = xg[lane], b = xg[lane + 32];
  float s = a + b;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  float mean = s * (1.0f / kGroup);
  float* og = out + g * kGroup;
  og[lane] = a - mean;
  og[lane + 32] = b - mean;
}

__global__ void dyn_sublane_kernel(const float* __restrict__ x, float* __restrict__ out,
                                   long long n, int rows_out, int width) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int col = (int)(i % width);
  long long r = i / width;  // batch * rows_out + row
  long long b = r / rows_out;
  int row = (int)(r % rows_out);
  const float* src = x + (b * (rows_out + kWindow - 1) + row) * width + col;
  float acc = src[0];
#pragma unroll
  for (int dy = 1; dy < kWindow; ++dy) acc += src[(long long)dy * width];
  out[i] = acc;
}

}  // namespace

// C entry points, bound with ctypes by colddiff_torch/ops/bisect_mosaic.py.
// All tensors are contiguous fp32.  Each returns the cudaError_t of its
// launch (0 = launched).

// x, out: [rows, width]; shift: jnp.roll's shift, 0 <= shift < width;
// columns j >= split are copied unrolled (split = width rolls the whole row).
extern "C" int colddiff_probe_roll(const float* x, float* out, int rows, int width,
                                   int shift, int split, void* stream) {
  if (rows <= 0 || width <= 0 || shift < 0 || shift >= width || split < 0 || split > width)
    return (int)cudaErrorInvalidValue;
  long long n = (long long)rows * width;
  roll_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(x, out, n, width, shift,
                                                                    split);
  return (int)cudaGetLastError();
}

// x, out: [rows, width], width a multiple of 64.
extern "C" int colddiff_probe_masked_norm(const float* x, float* out, int rows, int width,
                                          void* stream) {
  if (rows <= 0 || width <= 0 || width % kGroup != 0) return (int)cudaErrorInvalidValue;
  long long groups = (long long)rows * width / kGroup;
  masked_norm_kernel<<<blocks_for(groups * 32), kThreads, 0, (cudaStream_t)stream>>>(
      x, out, groups);
  return (int)cudaGetLastError();
}

// x: [batch, rows_in, width]; out: [batch, rows_in - 6, width].
extern "C" int colddiff_probe_dyn_sublane(const float* x, float* out, int batch, int rows_in,
                                          int width, void* stream) {
  if (batch <= 0 || width <= 0 || rows_in < kWindow) return (int)cudaErrorInvalidValue;
  int rows_out = rows_in - (kWindow - 1);
  long long n = (long long)batch * rows_out * width;
  dyn_sublane_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(x, out, n,
                                                                           rows_out, width);
  return (int)cudaGetLastError();
}
