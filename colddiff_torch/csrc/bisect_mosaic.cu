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
// All four are bound by bytes: each input element is read once and each
// output element written once.  At the probes' sizes (~2 MB each way) the
// data stays in L2, so what held the first kernels (one float a thread)
// back was instructions and waves, not bytes: a 64-bit division or two per
// element, 4-byte accesses, and ~2 waves of 256-thread blocks plus a tail.
//
// - roll_kernel (both rolls): a 2-D grid, blockIdx.y the row and
//   blockIdx.x a block of columns, so a column is a 32-bit add and no
//   division; one wave at the probes' shape (576 blocks of 128 threads, two
//   units a thread, both loaded before either is stored).  The wrapper
//   picks the unit: a float4 when width, shift and split are multiples of 4
//   and both pointers are 16-byte aligned (an aligned output quad then has
//   one aligned input quad as its source, never split by the wrap), else a
//   float.  A roll is a copy, so both paths are bitwise the plain version.
// - dyn_sublane_kernel: each thread owns one column unit (the same rule)
//   and a strip of kSumStrip output rows; it reads the strip's
//   kSumStrip + 6 input rows once into registers and sums each output from
//   them, so an input row is fetched (kSumStrip + 6) / kSumStrip times per
//   output row instead of up to 7.  blockIdx.z is the batch, blockIdx.y the
//   strip: no division.  Each output adds rows r .. r+6 in that order with
//   plain fp32 adds, as the plain version does, so it is bitwise equal.
//   At the probe's shape: 272 blocks of 64 threads, 14 row reads for 8
//   outputs.  Its loads set its pace, not their bytes: all of a thread's
//   reads land before its first sum, and longer strips (fewer bytes, fewer
//   threads) ran slower on the card (PERF.md).
// - masked_norm_kernel: the roll's grid (a row x column-block grid, 32-bit
//   columns, no division) with a 16-byte float4 unit a lane, so a half-warp
//   of 16 lanes holds one 64-element group.  Each lane adds its quad as
//   x + y + z + w, then 4 xor-shuffle steps inside the half-warp (offsets
//   8, 4, 2, 1) give every lane of the group bitwise the same sum: the
//   order is fixed, so the kernel is deterministic run to run.  Each
//   thread holds kNormUnits units of different groups and issues all their
//   loads before the first reduction.  At the probe's shape (64 x 8192):
//   256 blocks of 256 threads, one wave (timed against 64-1024 threads, 1-4
//   units, a warp a group and streaming stores, PERF.md).  Where a pointer
//   is not 16-byte aligned the wrapper takes masked_norm_float_kernel: a
//   warp a group, two floats a lane, 5 shuffle steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 64;   // masked_norm: elements per mean (c = 64 on the TPU)
constexpr int kWindow = 7;   // dyn_sublane: rows per sum
constexpr int kRollThreads = 128;  // roll: threads per block
constexpr int kRollUnits = 2;      // roll: units (float4 or float) per thread
constexpr int kSumThreads = 64;    // dyn_sublane: threads per block
constexpr int kSumStrip = 8;       // dyn_sublane: output rows per thread
constexpr int kNormThreads = 256;  // masked_norm: threads per block
constexpr int kNormUnits = 2;      // masked_norm: float4 units (groups) per thread
constexpr int kMaxGridYZ = 65535;  // gridDim.y and .z; larger counts loop

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }
int blocks_of(int n, int per_block) { return (n + per_block - 1) / per_block; }

// The float4 path's condition (ops/bisect_mosaic.py's quad_path, checked
// again): both pointers 16-byte aligned, width, shift and split whole quads.
bool quads_fit(const float* x, const float* out, int width, int shift, int split) {
  return ((uintptr_t)x | (uintptr_t)out) % 16 == 0 && width % 4 == 0 && shift % 4 == 0 &&
         split % 4 == 0;
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// T is the unit, float4 or float; units, shift and split count units.
template <typename T>
__global__ void __launch_bounds__(kRollThreads)
    roll_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int units, int shift,
                int split) {
  const int j0 = blockIdx.x * (kRollUnits * kRollThreads) + threadIdx.x;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const T* xr = x + (long long)r * units;
    T* orow = out + (long long)r * units;
    T v[kRollUnits];
#pragma unroll
    for (int k = 0; k < kRollUnits; ++k) {
      const int j = j0 + k * kRollThreads;
      int src = j;
      if (j < split) {
        src = j - shift;
        if (src < 0) src += units;
      }
      if (j < units) v[k] = xr[src];
    }
#pragma unroll
    for (int k = 0; k < kRollUnits; ++k) {
      const int j = j0 + k * kRollThreads;
      if (j < units) orow[j] = v[k];
    }
  }
}

__device__ __forceinline__ float4 minus(float4 v, float m) {
  return make_float4(v.x - m, v.y - m, v.z - m, v.w - m);
}

// x, out: [rows, units] of float4, a row a whole number of 64-float groups
// (16 units).  A block covers kNormUnits * kNormThreads units of one row;
// unit k of a thread is j0 + k * kNormThreads, so each half-warp holds one
// whole group.
__global__ void __launch_bounds__(kNormThreads)
    masked_norm_kernel(const float4* __restrict__ x, float4* __restrict__ out, int rows,
                       int units) {
  constexpr int kLanes = kGroup / 4;  // lanes a group
  const int j0 = blockIdx.x * (kNormUnits * kNormThreads) + threadIdx.x;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const float4* xr = x + (long long)r * units;
    float4* orow = out + (long long)r * units;
    float4 v[kNormUnits];
    float s[kNormUnits];
#pragma unroll
    for (int k = 0; k < kNormUnits; ++k) {
      const int j = j0 + k * kNormThreads;
      v[k] = j < units ? xr[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kNormUnits; ++k) s[k] = v[k].x + v[k].y + v[k].z + v[k].w;
    // every lane shuffles (a group past the row's end is all zeros and
    // stays inside its own half-warp)
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < kNormUnits; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
    }
#pragma unroll
    for (int k = 0; k < kNormUnits; ++k) {
      const int j = j0 + k * kNormThreads;
      if (j < units) orow[j] = minus(v[k], s[k] * (1.0f / kGroup));
    }
  }
}

// The float path: a warp a group, two floats a lane (any 4-byte alignment).
__global__ void masked_norm_float_kernel(const float* __restrict__ x, float* __restrict__ out,
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

// T as in roll_kernel; x: [batch, rows_in, units], out: [batch, rows_in - 6, units].
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    dyn_sublane_kernel(const T* __restrict__ x, T* __restrict__ out, int batch, int rows_in,
                       int units) {
  const int c = blockIdx.x * kSumThreads + threadIdx.x;
  if (c >= units) return;
  const int rows_out = rows_in - (kWindow - 1);
  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    for (int r0 = blockIdx.y * kSumStrip; r0 < rows_out; r0 += gridDim.y * kSumStrip) {
      const T* src = x + ((long long)b * rows_in + r0) * units + c;
      T* dst = out + ((long long)b * rows_out + r0) * units + c;
      T v[kSumStrip + kWindow - 1];
#pragma unroll
      for (int i = 0; i < kSumStrip + kWindow - 1; ++i)
        if (r0 + i < rows_in) v[i] = src[(long long)i * units];
#pragma unroll
      for (int i = 0; i < kSumStrip; ++i) {
        if (r0 + i < rows_out) {  // the last strip may be short
          T acc = v[i];
#pragma unroll
          for (int dy = 1; dy < kWindow; ++dy) acc = add(acc, v[i + dy]);
          dst[(long long)i * units] = acc;
        }
      }
    }
  }
}

}  // namespace

// C entry points, bound with ctypes by colddiff_torch/ops/bisect_mosaic.py.
// All tensors are contiguous fp32.  Each returns the cudaError_t of its
// launch (0 = launched).

// x, out: [rows, width]; shift: jnp.roll's shift, 0 <= shift < width;
// columns j >= split are copied unrolled (split = width rolls the whole row).
// quads: 1 takes the float4 path (refused unless width, shift and split are
// multiples of 4 and both pointers 16-byte aligned), 0 the float path.
extern "C" int colddiff_probe_roll(const float* x, float* out, int rows, int width,
                                   int shift, int split, int quads, void* stream) {
  if (rows <= 0 || width <= 0 || shift < 0 || shift >= width || split < 0 || split > width ||
      (quads && !quads_fit(x, out, width, shift, split)))
    return (int)cudaErrorInvalidValue;
  const int q = quads ? 4 : 1, units = width / q;
  const dim3 grid(blocks_of(units, kRollUnits * kRollThreads),
                  rows < kMaxGridYZ ? rows : kMaxGridYZ);
  if (quads)
    roll_kernel<<<grid, kRollThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)x, (float4*)out, rows, units, shift / q, split / q);
  else
    roll_kernel<<<grid, kRollThreads, 0, (cudaStream_t)stream>>>(x, out, rows, units, shift,
                                                                 split);
  return (int)cudaGetLastError();
}

// x, out: [rows, width], width a multiple of 64.  quads: 1 takes the
// float4 path (refused unless both pointers are 16-byte aligned), 0 the
// float path.
extern "C" int colddiff_probe_masked_norm(const float* x, float* out, int rows, int width,
                                          int quads, void* stream) {
  if (rows <= 0 || width <= 0 || width % kGroup != 0 || (quads && !quads_fit(x, out, width, 0, 0)))
    return (int)cudaErrorInvalidValue;
  if (quads) {
    const int units = width / 4;
    const dim3 grid(blocks_of(units, kNormUnits * kNormThreads),
                    rows < kMaxGridYZ ? rows : kMaxGridYZ);
    masked_norm_kernel<<<grid, kNormThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)x, (float4*)out, rows, units);
  } else {
    long long groups = (long long)rows * width / kGroup;
    masked_norm_float_kernel<<<blocks_for(groups * 32), kThreads, 0, (cudaStream_t)stream>>>(
        x, out, groups);
  }
  return (int)cudaGetLastError();
}

// x: [batch, rows_in, width]; out: [batch, rows_in - 6, width]; quads as
// for the roll, with shift = split = 0.
extern "C" int colddiff_probe_dyn_sublane(const float* x, float* out, int batch, int rows_in,
                                          int width, int quads, void* stream) {
  if (batch <= 0 || width <= 0 || rows_in < kWindow || (quads && !quads_fit(x, out, width, 0, 0)))
    return (int)cudaErrorInvalidValue;
  const int q = quads ? 4 : 1, units = width / q;
  const int strips = blocks_of(rows_in - (kWindow - 1), kSumStrip);
  const dim3 grid(blocks_of(units, kSumThreads), strips < kMaxGridYZ ? strips : kMaxGridYZ,
                  batch < kMaxGridYZ ? batch : kMaxGridYZ);
  if (quads)
    dyn_sublane_kernel<<<grid, kSumThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)x, (float4*)out, batch, rows_in, units);
  else
    dyn_sublane_kernel<<<grid, kSumThreads, 0, (cudaStream_t)stream>>>(x, out, batch, rows_in,
                                                                       units);
  return (int)cudaGetLastError();
}
