// ConvNeXt block front on Hopper (sm_90a): depthwise 7x7 conv (zero pad 3)
// + conv bias + per-image conditioning + channel LayerNorm, one pass.
//
//   out[b,h,w,:] = LN_c(dwconv7x7(x)[b,h,w,:] + bias + cond[b]) * gamma + beta
//
// Replaces the TPU kernel in colddiff/ops/pallas/convnext_front.py
// (_pallas_forward_packed -> _kernel_packed).  None of the TPU layout tricks
// carry over (lane packing, pltpu.roll, H tiling): they exist for 128-lane
// vector registers.
//
// Design: one warp per output pixel; lane l owns channels l, l+32, l+64, ...
// x is NHWC in memory (an NCHW tensor in channels_last format), so the 32
// lanes of a warp read 32 neighbouring channels of one input pixel: one
// coalesced load per tap.  Taps, bias and conditioning accumulate in fp32
// registers for any input dtype; the warp then reduces mean and (biased)
// variance with shuffles, applies gamma/beta and rounds once to the output
// dtype.
//
// What bounds it: bytes.  Each output element costs 49 FMAs and 49 loads of
// x and of the tap weights.  Those loads hit L1/L2 (the 8 warps of a block
// are 8 neighbouring pixels of one row and share most of their 7x7 windows),
// so device memory sees roughly one read of x and one write of out per
// element; the kernel's floor is that traffic, and the L1 load rate it
// reaches is what later versions would raise (shared-memory row tiles,
// 16-byte vector loads).
//
// The weights arrive as [49, C] (tap-major), so the lanes' weight loads are
// coalesced too.  This warp kernel takes C from 32 to 1024 (NK = ceil(C/32)
// <= 32 channels per lane, held in registers).
//
// Small C (C < 32): a second kernel, for the same TPU kernel at the
// channel counts it never took (the C=3 stem of every UNet, C=1 for MNIST,
// the narrow test UNets' C=8/16).  The warp kernel is slow there for two
// reasons: at C=3, 29 of a warp's 32 lanes idle, and every output pixel
// makes 49 global (L1/L2) loads per channel group, with 8 pixels per block
// sharing little of them.  The small-C kernel gives each output pixel one
// thread, which holds all C channels in fp32 registers (padded to CP, a
// power of two, zeros beyond C) and runs the LayerNorm alone: no shuffles,
// no idle lanes, and each thread writes its C contiguous outputs beside its
// neighbour's.  A block owns a 16x16 output tile of one image (grid
// ceil(W/16) x ceil(H/16) x B, so one cond row per block) and first copies
// its 22x22xC input halo into shared memory as fp32, zeros outside the image
// and in the padding channels, so the 49-tap loop has no branches and reads
// only shared memory: 16-byte loads once CP >= 4, with the 16-byte chunks of
// each pixel XOR-swizzled at CP >= 8 so that a quarter-warp's loads meet in
// no bank.  Each input row of the tile is one contiguous NHWC run of 22*C
// elements, loaded coalesced, 8 loads per thread in flight at a time.  The
// weights arrive in their torch layout [C, 49] ([C,1,7,7] contiguous, no
// transpose copy per call) and are stored tap-major [49][CP] in shared
// memory.  Tile and shared bytes per CP (halo + weights + bias/cond, gamma,
// beta, all fp32): 16x16 at every CP; CP=1 2,144 B, 2 4,288, 4 8,576,
// 8 17,152, 16 34,304, 32 68,608 (dynamic shared memory above 48 KB, after
// cudaFuncAttributeMaxDynamicSharedMemorySize).
//
// Its bound at the stem (16,128,128,3), counting one read of x and one write
// of out, 49 FMAs per output at 3.35 TB/s and 67 TFLOP/s fp32: 1.88 us in
// fp32 (6.29 MB, bytes-bound), 1.15 us in bf16 (77 MFLOP, operations-bound).
// What it spends instead: 49 shared loads of x and 49 broadcast loads of the
// weights per output (one 16-byte load each at CP=4), so shared-memory
// bandwidth, not device memory, sets its pace; reusing a row of x across
// several outputs of one thread is the next step.  Measured times beside
// these bounds are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxChannels = 1024;
constexpr int kSmallCLimit = 32;  // C < kSmallCLimit takes the small-C kernel
constexpr int kTile = 16;         // small-C output tile: kTile x kTile pixels
constexpr int kHalo = kTile + 6;  // its input tile side (zero pad 3 each way)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int NK>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
convnext_front_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                      const T* __restrict__ bias, const T* __restrict__ cond,
                      const T* __restrict__ gamma, const T* __restrict__ beta,
                      T* __restrict__ out, int H, int W, int C, int64_t npix,
                      int norm, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t pix = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pix >= npix) return;  // pix is uniform across the warp
  const int px = (int)(pix % W);
  const int py = (int)((pix / W) % H);
  const int64_t b = pix / ((int64_t)W * H);

  float acc[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) acc[k] = 0.f;

  for (int dy = 0; dy < 7; ++dy) {
    const int yy = py + dy - 3;
    if (yy < 0 || yy >= H) continue;  // zero padding (warp-uniform branch)
    for (int dx = 0; dx < 7; ++dx) {
      const int xx = px + dx - 3;
      if (xx < 0 || xx >= W) continue;
      const T* xp = x + ((b * H + yy) * W + xx) * C;
      const T* wp = wt + (dy * 7 + dx) * C;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int c = lane + 32 * k;
        if (c < C) acc[k] = fmaf(to_f32(xp[c]), to_f32(wp[c]), acc[k]);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = lane + 32 * k;
    if (c < C) {
      float add = to_f32(bias[c]);
      if (cond != nullptr) add += to_f32(cond[b * C + c]);
      acc[k] += add;
    }
  }

  if (norm) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      if (lane + 32 * k < C) s += acc[k];
    }
    const float mean = warp_sum(s) / (float)C;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      if (lane + 32 * k < C) {
        const float d = acc[k] - mean;
        v += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(v) / (float)C + eps);
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int c = lane + 32 * k;
      if (c < C) acc[k] = (acc[k] - mean) * rstd * to_f32(gamma[c]) + to_f32(beta[c]);
    }
  }

  T* op = out + pix * C;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = lane + 32 * k;
    if (c < C) op[c] = from_f32<T>(acc[k]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wt, const void* bias, const void* cond,
                   const void* gamma, const void* beta, void* out, int B, int H,
                   int W, int C, int norm, float eps, cudaStream_t stream) {
  const int64_t npix = (int64_t)B * H * W;
  const int64_t blocks = (npix + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(kWarpsPerBlock * 32);
  const int nk = (C + 31) / 32;
#define COLDDIFF_FRONT_LAUNCH(N)                                                  \
  convnext_front_kernel<T, N><<<grid, block, 0, stream>>>(                        \
      (const T*)x, (const T*)wt, (const T*)bias, (const T*)cond, (const T*)gamma, \
      (const T*)beta, (T*)out, H, W, C, npix, norm, eps)
  if (nk <= 1) {
    COLDDIFF_FRONT_LAUNCH(1);
  } else if (nk <= 2) {
    COLDDIFF_FRONT_LAUNCH(2);
  } else if (nk <= 4) {
    COLDDIFF_FRONT_LAUNCH(4);
  } else if (nk <= 8) {
    COLDDIFF_FRONT_LAUNCH(8);
  } else if (nk <= 16) {
    COLDDIFF_FRONT_LAUNCH(16);
  } else {
    COLDDIFF_FRONT_LAUNCH(32);
  }
#undef COLDDIFF_FRONT_LAUNCH
  return cudaGetLastError();
}

// Shared floats of the small-C kernel: the halo tile [kHalo*kHalo][CP], the
// weights [49][CP], and bias+cond, gamma, beta [3][CP].
template <int CP>
constexpr int small_c_smem_floats() {
  return (kHalo * kHalo + 49 + 3) * CP;
}

// Where the 16-byte chunk k (channels 4k..4k+3) of halo pixel p sits in the
// pixel's CP floats: chunk k ^ swizzle<CP>(p).  A quarter-warp's 8 threads
// read 8 consecutive pixels; with CP >= 8 they would meet in the same bank
// groups (2-, 4- or 8-way at CP = 8, 16, 32), and the XOR spreads them over
// all 8 groups of 16 bytes.  At CP <= 4 a pixel is one chunk or less.
template <int CP>
__device__ __forceinline__ int swizzle(int p) {
  constexpr int kChunks = CP / 4;
  if constexpr (kChunks <= 1) {
    return 0;
  } else {
    return (p / (8 / kChunks)) % kChunks;
  }
}

template <typename T, int CP>
__global__ void __launch_bounds__(kTile * kTile)
convnext_front_small_c_kernel(const T* __restrict__ x, const T* __restrict__ w,
                              const T* __restrict__ bias, const T* __restrict__ cond,
                              const T* __restrict__ gamma, const T* __restrict__ beta,
                              T* __restrict__ out, int H, int W, int C, int norm,
                              float eps) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [kHalo*kHalo][CP]
  float* ws = xs + kHalo * kHalo * CP;          // [49][CP], tap-major
  float* vs = ws + 49 * CP;                     // [3][CP]: bias+cond, gamma, beta
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int64_t b = blockIdx.z;
  const T* xb = x + b * H * W * C;

  // Consecutive threads take consecutive channels of consecutive pixels, so
  // each tile row is read as one coalesced run; zeros outside the image and
  // in the channels C..CP-1.  Loads go in batches of 8 per thread, all in
  // flight before their stores.
  constexpr int kThreads = kTile * kTile;
  constexpr int kTileFloats = kHalo * kHalo * CP;
  constexpr int kBatch = 8;
  for (int i0 = tid; i0 < kTileFloats; i0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int c = i % CP, p = i / CP;
      const int yy = y0 - 3 + p / kHalo, xx = x0 - 3 + p % kHalo;
      v[u] = 0.f;
      if (i < kTileFloats && c < C && yy >= 0 && yy < H && xx >= 0 && xx < W)
        v[u] = to_f32(xb[((int64_t)yy * W + xx) * C + c]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= kTileFloats) continue;
      if constexpr (CP <= 4) {
        xs[i] = v[u];
      } else {
        const int c = i % CP, p = i / CP;
        xs[p * CP + (((c >> 2) ^ swizzle<CP>(p)) << 2) + (c & 3)] = v[u];
      }
    }
  }
  for (int i = tid; i < 49 * CP; i += kThreads) {
    const int c = i % CP, tap = i / CP;
    ws[i] = c < C ? to_f32(w[c * 49 + tap]) : 0.f;
  }
  if (tid < CP) {
    float add = 0.f, g = 0.f, be = 0.f;
    if (tid < C) {
      add = to_f32(bias[tid]);
      if (cond != nullptr) add += to_f32(cond[b * C + tid]);
      if (norm) {
        g = to_f32(gamma[tid]);
        be = to_f32(beta[tid]);
      }
    }
    vs[tid] = add;
    vs[CP + tid] = g;
    vs[2 * CP + tid] = be;
  }
  __syncthreads();

  const int tx = tid % kTile, ty = tid / kTile;
  const int px = x0 + tx, py = y0 + ty;
  if (px >= W || py >= H) return;  // after the block's only barrier

  float acc[CP];
#pragma unroll
  for (int k = 0; k < CP; ++k) acc[k] = 0.f;
#pragma unroll
  for (int dy = 0; dy < 7; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 7; ++dx) {
      const int p = (ty + dy) * kHalo + tx + dx;
      const float* xp = xs + p * CP;
      const float* wp = ws + (dy * 7 + dx) * CP;
      if constexpr (CP >= 4) {
        const int s = swizzle<CP>(p);
#pragma unroll
        for (int k = 0; k < CP; k += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xp + (((k >> 2) ^ s) << 2));
          const float4 wv = *reinterpret_cast<const float4*>(wp + k);
          acc[k] = fmaf(xv.x, wv.x, acc[k]);
          acc[k + 1] = fmaf(xv.y, wv.y, acc[k + 1]);
          acc[k + 2] = fmaf(xv.z, wv.z, acc[k + 2]);
          acc[k + 3] = fmaf(xv.w, wv.w, acc[k + 3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < CP; ++k) acc[k] = fmaf(xp[k], wp[k], acc[k]);
      }
    }
  }

  // the padding channels hold 0 here: zero x, zero weights, zero bias
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CP; ++k) {
    acc[k] += vs[k];
    s += acc[k];
  }
  if (norm) {
    const float mean = s / (float)C;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < CP; ++k) {
      if (k < C) {
        const float d = acc[k] - mean;
        v += d * d;
      }
    }
    const float rstd = rsqrtf(v / (float)C + eps);
#pragma unroll
    for (int k = 0; k < CP; ++k) acc[k] = (acc[k] - mean) * rstd * vs[CP + k] + vs[2 * CP + k];
  }

  T* op = out + (((b * H) + py) * W + px) * C;
#pragma unroll
  for (int k = 0; k < CP; ++k) {
    if (k < C) op[k] = from_f32<T>(acc[k]);
  }
}

template <typename T, int CP>
cudaError_t launch_small_c_cp(const void* x, const void* w, const void* bias,
                              const void* cond, const void* gamma, const void* beta,
                              void* out, int B, int H, int W, int C, int norm, float eps,
                              cudaStream_t stream) {
  constexpr int smem = (int)sizeof(float) * small_c_smem_floats<CP>();
  const auto kernel = convnext_front_small_c_kernel<T, CP>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  kernel<<<grid, kTile * kTile, smem, stream>>>(
      (const T*)x, (const T*)w, (const T*)bias, (const T*)cond, (const T*)gamma,
      (const T*)beta, (T*)out, H, W, C, norm, eps);
  return cudaGetLastError();
}

// C < kSmallCLimit; w is [C, 49], the torch layout.
template <typename T>
cudaError_t launch_small_c(const void* x, const void* w, const void* bias, const void* cond,
                           const void* gamma, const void* beta, void* out, int B, int H,
                           int W, int C, int norm, float eps, cudaStream_t stream) {
  if (B > 65535 || (H + kTile - 1) / kTile > 65535) return cudaErrorInvalidValue;
#define COLDDIFF_SMALL_C_LAUNCH(N) \
  launch_small_c_cp<T, N>(x, w, bias, cond, gamma, beta, out, B, H, W, C, norm, eps, stream)
  if (C <= 1) return COLDDIFF_SMALL_C_LAUNCH(1);
  if (C <= 2) return COLDDIFF_SMALL_C_LAUNCH(2);
  if (C <= 4) return COLDDIFF_SMALL_C_LAUNCH(4);
  if (C <= 8) return COLDDIFF_SMALL_C_LAUNCH(8);
  if (C <= 16) return COLDDIFF_SMALL_C_LAUNCH(16);
  return COLDDIFF_SMALL_C_LAUNCH(32);
#undef COLDDIFF_SMALL_C_LAUNCH
}

}  // namespace

// C entry point, bound with ctypes by colddiff_torch/ops/convnext_front.py.
// x, out: [B,H,W,C] (NHWC memory); bias, gamma, beta: [C]; cond: [B,C] or
// NULL; gamma/beta are read only when norm != 0.  The kernel follows C:
// C < 32 launches the small-C kernel and takes w as [C,49] (the torch
// layout); C >= 32 launches the warp kernel and takes w as [49,C].
// dtype: 0 = float32, 1 = bfloat16 (all tensors share it).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int colddiff_convnext_front(const void* x, const void* w, const void* bias,
                                       const void* cond, const void* gamma,
                                       const void* beta, void* out, int B, int H, int W,
                                       int C, int norm, float eps, int dtype,
                                       void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > kMaxChannels)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C < kSmallCLimit) {
    if (dtype == 0)
      return (int)launch_small_c<float>(x, w, bias, cond, gamma, beta, out, B, H, W, C,
                                        norm, eps, s);
    if (dtype == 1)
      return (int)launch_small_c<__nv_bfloat16>(x, w, bias, cond, gamma, beta, out, B, H,
                                                W, C, norm, eps, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return (int)launch<float>(x, w, bias, cond, gamma, beta, out, B, H, W, C, norm, eps, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, bias, cond, gamma, beta, out, B, H, W, C,
                                      norm, eps, s);
  return (int)cudaErrorInvalidValue;
}
