// GroupNorm + affine + optional swish over channels_last, on Hopper
// (sm_90a), in one pass:
//
//   xn  = round(x * rstd_g + (-mean_g * rstd_g))     statistics in fp32
//   y   = round(round(xn * gamma) + beta)
//   out = swish ? round(y / (1 + exp(-y))) : y      in fp32
//
// round() is to the tensor's dtype (fp32 or bf16), at the rounding points
// of colddiff_torch/ops/group_norm.py's plain version: F.group_norm on an
// fp32 copy (whose CUDA kernel forms xn with that fma), the cast back, then
// the affine and F.silu in the dtype.  The statistics' summation order is
// the only difference, but for swish in bf16 (silu_bf16).
//
// Replaces no TPU kernel: the JAX package computes its GroupNorm in plain
// XLA, whose fusion beat a Pallas version that was then deleted
// (colddiff/models/layers.py:92-95).  Eager PyTorch fuses nothing: on the
// H100 the plain chain (an fp32 copy, F.group_norm's NCHW copy and two
// kernels, the cast back, the strided affine and swish) took 21.1 of a
// 39.3 ms CIFAR-10 ResNet call at B=256, about 36 bytes moved an element in
// eight kernels.
//
// What bounds it: bytes.  One read and one write of each element, ~10
// operations on it; at the 51 norms of a CIFAR-10 ResNet forward at B=256
// in bf16 that is 3.45 GB, 1.03 ms at 3.35 TB/s.  How the design meets it:
//
// 1. A block owns all C channels of a run of pixels of one image.  Thread t
//    holds the 16-byte vector v = t % V of the channels (V = C / U, U = 8
//    bf16 or 4 fp32 values) at pixel rows t / V + j * P (j < NV, P = the
//    block's rows), so its channels, their groups, gamma and beta are fixed
//    and each row of the block's loads and stores is one contiguous run of
//    P * C elements.  The block has V * P <= 512 threads.
// 2. The data stays in registers (NV <= 16 vectors a thread) from the load
//    to the write: the image is read once and written once.  Where one
//    block cannot hold an image, the k <= 8 blocks of a thread block
//    cluster share it, each a slice of its pixels, and only the group
//    statistics cross between them, through distributed shared memory.
// 3. Statistics: each thread sums its channels over its vectors, the block
//    sums those partials per group in shared memory (a warp a group, its
//    lanes in a fixed order, then an xor tree); the chunk's mean comes
//    first, then its sum of squared deviations from that mean (a second
//    pass over the registers).  Chunks and cluster ranks combine their
//    (count, mean, M2) by Chan's rule in a fixed order, so every block of a
//    cluster gets bitwise the same mean and rstd and two runs give the same
//    output.  Chan's rule is kept out of the per-thread parts: its
//    divisions there, for one round in place of two, took 6-10 us a block.
// 4. Few instructions an element, so that the arithmetic hides under the
//    memory time: in bf16 the affine runs on bf16 pairs (fma.rn.bf16x2,
//    which rounds as the fp32 product and sum rounded to bf16 do) and each
//    pair is converted once; swish is the one fp32 step, with the
//    hardware's exp2 and reciprocal (silu_bf16).
// 5. Images larger than a cluster's registers (the ResNet at 64 and 128 px,
//    e.g. 384 x 128 x 128: 12.6 MB) take the streaming form of the same
//    kernel: each block of the cluster walks its slice in chunks, keeping
//    the running statistics, then reads its slice again to write it (the
//    last chunk from the registers).  x is read twice there.
// The form is picked from the shape (configure): NV is the smallest power
// of two that lets one block hold the image, else 16 with a cluster of
// ceil(need / 16) blocks, else the streaming form on 8.
//
// Instantiations: NV = 1, 2, 4, 8, 16 for each of fp32 and bf16.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;   // the most threads a block has
constexpr int kMaxNV = 16;      // the most 16-byte vectors a thread holds
constexpr int kMaxCluster = 8;  // blocks of a cluster: the portable limit

// A 16-byte vector as U floats: bf16 widens (channel c in the low half)
template <int U>
__device__ __forceinline__ void unpack(const uint4& q, float (&f)[U]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (U == 8) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      f[i] = __uint_as_float(w[i]);
    }
  }
}

// The two halves of a cluster barrier: all threads of all blocks arrive,
// then wait; the release / acquire order shared-memory accesses across it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Chan's rule: (n, mean, m2) takes in a part of nb elements with mean mb
// and sum of squared deviations m2b.  An empty part changes nothing; the
// first part is taken exactly.
__device__ __forceinline__ void chan(float& n, float& mean, float& m2, float nb, float mb,
                                     float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb, d = mb - mean;
  mean += d * (nb / nn);
  m2 += m2b + d * d * (n * nb / nn);
  n = nn;
}

// Group g's sum of the block's per-channel partials red[P][C], by one
// whole warp: lane l adds entries l, l + 32, ... of the group's P x cgs,
// then an xor tree; every lane returns the same total.
__device__ __forceinline__ float group_sum(const float* red, int g, int P, int C, int cgs,
                                           int lane) {
  float s = 0.f;
  for (int i = lane; i < P * cgs; i += 32) {
    const int p = i / cgs;
    s += red[p * C + g * cgs + (i - p * cgs)];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// d = a * b + c on two bf16 lanes, rounded once.  With c = -0 it is the
// bf16 product, with b = 1 the bf16 sum: the exact results rounded to
// nearest even, which is what rounding the fp32 product or sum of two bf16
// values gives (an fp32 product of 8-bit significands is exact; an fp32 sum
// is inexact only where the smaller addend lies far below half a bf16 ulp
// of the larger, and then both round to the larger).
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
constexpr uint32_t kBf16x2NegZero = 0x80008000u, kBf16x2One = 0x3f803f80u;

// swish as F.silu computes it in fp32: expf and an IEEE division
__device__ __forceinline__ float silu(float y) { return y / (1.0f + expf(-y)); }
// the same with the hardware's exp2 and reciprocal (within 2 fp32 ulps):
// rounded to bf16 it gives what silu() gives (held on the card for y over
// [-80, 80]), but for y in (-88.8, -87.3), where the reciprocal of a
// denominator above 2^126 is 0 and the output -0 in place of ~-1e-36.  The
// IEEE division took a fifth of the kernel's time at the CIFAR-10 ResNet's
// shapes.
__device__ __forceinline__ float silu_bf16(float y) { return __fdividef(y, 1.0f + __expf(-y)); }

struct Args {
  const void *x, *gamma, *beta;
  void* out;
  int HW, C, G;
  int k;      // blocks an image: a cluster when > 1
  int slice;  // pixels a block owns (the last block's slice may be short)
  int swish;
  float eps;
};

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) group_norm_swish_kernel(const Args a) {
  constexpr int U = 16 / sizeof(T);
  constexpr bool BF16 = sizeof(T) == 2;
  const int C = a.C, G = a.G, cgs = C / G;
  const int V = C / U, P = blockDim.x / V;
  const int t = threadIdx.x, v = t % V, row = t / V, lane = t & 31;
  const int warp = t >> 5, nwarps = blockDim.x >> 5;  // whole warps combine the groups
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);  // [P][C] per-channel partials
  float* cmean = red + blockDim.x * U;             // [G] the chunk's means
  float* run = cmean + G;                          // [3][G] the block's n, mean, M2
  float* fin = run + 3 * G;                        // [2][G] the image's mean, rstd

  const int rank = a.k > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int64_t base = (int64_t)(blockIdx.x / a.k) * a.HW * C + v * U;
  const T* x = static_cast<const T*>(a.x) + base;
  T* out = static_cast<T*>(a.out) + base;
  const int s0 = rank * a.slice, s1 = min(a.HW, s0 + a.slice);
  const int chunk = P * NV;
  const int nchunks = s1 > s0 ? (s1 - s0 + chunk - 1) / chunk : 0;

  for (int g = t; g < G; g += blockDim.x) run[g] = run[G + g] = run[2 * G + g] = 0.f;

  uint4 buf[NV];
  for (int c = 0; c < nchunks; ++c) {
    const int p0 = s0 + c * chunk, np = min(chunk, s1 - p0);
    const int mine = row < np ? min(NV, (np - row + P - 1) / P) : 0;  // valid vectors
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      buf[j] = j < mine
                   ? __ldg(reinterpret_cast<const uint4*>(x + (int64_t)(p0 + row + j * P) * C))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    const float cnt = (float)np * cgs;
    // pass 1: the chunk's group means
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (j < mine) {
        float f[U];
        unpack<U>(buf[j], f);
#pragma unroll
        for (int u = 0; u < U; ++u) acc[u] += f[u];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) red[row * C + v * U + u] = acc[u];
    __syncthreads();
    if (warp < nwarps) {
      for (int g = warp; g < G; g += nwarps) {
        const float s = group_sum(red, g, P, C, cgs, lane);
        if (lane == 0) cmean[g] = s / cnt;
      }
    }
    __syncthreads();
    // pass 2: the chunk's sums of squared deviations from its means
    float m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      m[u] = cmean[(v * U + u) / cgs];
      acc[u] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (j < mine) {
        float f[U];
        unpack<U>(buf[j], f);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float d = f[u] - m[u];
          acc[u] += d * d;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) red[row * C + v * U + u] = acc[u];
    __syncthreads();
    if (warp < nwarps) {
      for (int g = warp; g < G; g += nwarps) {
        const float s = group_sum(red, g, P, C, cgs, lane);
        if (lane == 0) chan(run[g], run[G + g], run[2 * G + g], cnt, cmean[g], s);
      }
    }
    __syncthreads();  // red and cmean are free for the next chunk
  }

  // the image's statistics: the cluster's blocks in rank order
  if (a.k > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's run is final
    for (int g = t; g < G; g += blockDim.x) {
      float n = 0.f, mean = 0.f, m2 = 0.f;
      for (int q = 0; q < a.k; ++q) {
        const float* r = cluster.map_shared_rank(run, q);
        chan(n, mean, m2, r[g], r[G + g], r[2 * G + g]);
      }
      fin[g] = mean;
      fin[G + g] = rsqrtf(m2 / n + a.eps);
    }
    cluster_arrive();  // this block's reads of its peers' run are done
  } else {
    for (int g = t; g < G; g += blockDim.x) {
      fin[g] = run[G + g];
      fin[G + g] = rsqrtf(run[2 * G + g] / run[g] + a.eps);
    }
  }
  __syncthreads();

  // xn = x * rstd + (-mean * rstd), in fp32 with one rounding, as
  // F.group_norm's CUDA kernel forms it; then the affine in T
  float rs[U], nb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int g = (v * U + u) / cgs;
    rs[u] = fin[G + g];
    nb[u] = -fin[g] * rs[u];
  }
  uint32_t gw[4], bw[4];  // bf16: gamma and beta as bf16 pairs
  float ga[U], be[U];     // fp32: gamma and beta
  if constexpr (BF16) {
    const uint32_t* g32 = static_cast<const uint32_t*>(a.gamma) + v * U / 2;
    const uint32_t* b32 = static_cast<const uint32_t*>(a.beta) + v * U / 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) gw[i] = g32[i], bw[i] = b32[i];
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ga[u] = static_cast<const float*>(a.gamma)[v * U + u];
      be[u] = static_cast<const float*>(a.beta)[v * U + u];
    }
  }
  // the last chunk is still in the registers; a streaming block reads its
  // other chunks again
  for (int i = 0; i < nchunks; ++i) {
    const int c = i == 0 ? nchunks - 1 : i - 1;
    const int p0 = s0 + c * chunk, np = min(chunk, s1 - p0);
    const int mine = row < np ? min(NV, (np - row + P - 1) / P) : 0;
    if (i > 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (j < mine)
          buf[j] = __ldg(reinterpret_cast<const uint4*>(x + (int64_t)(p0 + row + j * P) * C));
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (j < mine) {
        float f[U];
        unpack<U>(buf[j], f);
        uint4 o;
        if constexpr (BF16) {
          uint32_t w[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const __nv_bfloat162 xn =
                __floats2bfloat162_rn(fmaf(f[2 * h], rs[2 * h], nb[2 * h]),
                                      fmaf(f[2 * h + 1], rs[2 * h + 1], nb[2 * h + 1]));
            uint32_t y =
                bf16x2_fma(*reinterpret_cast<const uint32_t*>(&xn), gw[h], kBf16x2NegZero);
            y = bf16x2_fma(y, kBf16x2One, bw[h]);
            if (a.swish) {
              const __nv_bfloat162 s = __floats2bfloat162_rn(
                  silu_bf16(__uint_as_float(y << 16)),
                  silu_bf16(__uint_as_float(y & 0xffff0000u)));
              y = *reinterpret_cast<const uint32_t*>(&s);
            }
            w[h] = y;
          }
          o = make_uint4(w[0], w[1], w[2], w[3]);
        } else {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float y = __fadd_rn(__fmul_rn(fmaf(f[u], rs[u], nb[u]), ga[u]), be[u]);
            f[u] = a.swish ? silu(y) : y;
          }
          o = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                         __float_as_uint(f[3]));
        }
        *reinterpret_cast<uint4*>(out + (int64_t)(p0 + row + j * P) * C) = o;
      }
    }
  }
  // a block's run stays in its shared memory until its peers have read it
  if (a.k > 1) cluster_wait();
}

struct Config {
  int threads, nv, k, slice, chunks;
};

// The form for an image of HW pixels and C channels of esize bytes; false
// where the kernel does not take C (C not a whole number of 16-byte
// vectors, or more than kThreads of them).
bool configure(int HW, int C, int esize, Config& cfg) {
  const int U = 16 / esize;
  if (HW <= 0 || C <= 0 || C % U != 0 || C / U > kThreads) return false;
  const int V = C / U, P = kThreads / V;
  const int64_t need = (HW + (int64_t)P - 1) / P;  // vectors a thread, one block an image
  int nv = 1;
  while (nv < need && nv < kMaxNV) nv *= 2;
  const int64_t k = (need + nv - 1) / nv;
  cfg.threads = V * P;
  cfg.nv = nv;
  cfg.k = (int)(k < kMaxCluster ? k : kMaxCluster);
  cfg.slice = (int)((HW + (int64_t)cfg.k - 1) / cfg.k);
  cfg.chunks = (cfg.slice + P * nv - 1) / (P * nv);
  return true;
}

template <typename T, int NV>
cudaError_t launch_nv(const Args& a, int B, int threads, cudaStream_t stream) {
  const auto kernel = group_norm_swish_kernel<T, NV>;
  // the threads' partials, the chunk's means, the block's and the image's statistics
  const int smem = (int)sizeof(float) * (threads * (16 / (int)sizeof(T)) + 6 * a.G);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)B * a.k);
  if (a.k == 1) {
    kernel<<<grid, threads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.k;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // before the first launch of each cluster size: can the card place one?
  static bool placed[kMaxCluster + 1];
  if (!placed[a.k]) {
    int clusters = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters == 0) return cudaErrorInvalidConfiguration;
    placed[a.k] = true;
  }
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename T>
cudaError_t launch(const Args& a, int B, const Config& cfg, cudaStream_t stream) {
  switch (cfg.nv) {
    case 1: return launch_nv<T, 1>(a, B, cfg.threads, stream);
    case 2: return launch_nv<T, 2>(a, B, cfg.threads, stream);
    case 4: return launch_nv<T, 4>(a, B, cfg.threads, stream);
    case 8: return launch_nv<T, 8>(a, B, cfg.threads, stream);
    case 16: return launch_nv<T, 16>(a, B, cfg.threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes by colddiff_torch/ops/group_norm.py.
// x, out: [B, HW, C] (channels_last memory), 16-byte aligned; gamma, beta:
// [C]; all in dtype (0 = float32, 1 = bfloat16).  G groups of C / G
// channels; swish != 0 applies swish.  Returns the cudaError_t of the launch
// (0 = launched); cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int colddiff_group_norm_swish(const void* x, const void* gamma, const void* beta,
                                         void* out, int B, int HW, int C, int G, float eps,
                                         int swish, int dtype, void* stream) {
  Config cfg;
  if (B <= 0 || G <= 0 || C % G != 0 || dtype < 0 || dtype > 1 ||
      !configure(HW, C, dtype == 0 ? 4 : 2, cfg) || (int64_t)B * cfg.k > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Args a{x, gamma, beta, out, HW, C, G, cfg.k, cfg.slice, swish, eps};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0 ? launch<float>(a, B, cfg, s) : launch<__nv_bfloat16>(a, B, cfg, s));
}

// The form the kernel takes for HW pixels of C channels in dtype:
// cfg[0..4] = threads a block, vectors a thread NV, blocks an image k (a
// cluster when > 1), pixels a block, chunks a block (> 1: the streaming
// form).  Returns 0, or cudaErrorInvalidValue where the kernel does not
// take C.
extern "C" int colddiff_group_norm_swish_config(int HW, int C, int dtype, int* cfg) {
  Config c;
  if (dtype < 0 || dtype > 1 || !configure(HW, C, dtype == 0 ? 4 : 2, c))
    return (int)cudaErrorInvalidValue;
  const int v[5] = {c.threads, c.nv, c.k, c.slice, c.chunks};
  for (int i = 0; i < 5; ++i) cfg[i] = v[i];
  return 0;
}
