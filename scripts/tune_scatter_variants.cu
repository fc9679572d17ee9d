// Variants of the shared-memory scatter kernels that measured slower on an
// H100 than the ones in event_utils_tpu_torch/csrc/scatter_kernels.cu, kept
// here so that scripts/tune_scatter_routes.py can go on measuring them. Not
// part of the package: the tune script builds this file on its own.
//
// Each variant takes its launch parameters as arguments:
//   patches_variant   channels per block (kb), block size, bulk or per-thread
//                     store;
//   private_variant   blocks, block size, flush of the private images by
//                     cp.reduce.async.bulk add.f32 (bulk = 1) or by
//                     per-thread atomics that skip zeros (bulk = 0);
//   tiles_variant     mode 0: every block reads all slots of its tile, plain
//                     launch; mode 1: one thread-block cluster per tile whose
//                     blocks split the slots and add each tap into the
//                     owner's shared memory (distributed shared memory);
//                     mode 2: mode 0 launched as clusters; bins go in groups
//                     of up to 8 (the portable cluster size) per launch;
//   probe             the direct bilinear kernel with its atomics replaced by
//                     a register sum: loads, arithmetic and launch alone;
//   voxel_probe,      the direct voxel kernel and the one-thread-per-element
//   flat_probe        flat kernel, likewise without atomics;
//   flat_rows         the flat kernel with one thread per (row, id) element,
//                     which re-reads the id for every row and divides to
//                     find the row (the package's first flat kernel);
//   flat_ahead        the direct flat kernel with kAhead ids loaded before
//                     their reductions start;
//   voxel_single      the vector voxel kernel with one accumulator: a float2
//                     reduction for an even first bin, two scalar ones for
//                     an odd one, then a transpose;
//   red_probe         the L2's rate of reductions: every thread sends one
//                     scalar, two scalars half a buffer apart, two adjacent
//                     scalars, one float2 or one float4 to a random place;
//   shared_atomic_probe  atomicAdd on shared memory, int against float;
//   band_variant      a row-band splat for few events, one launch and no
//                     memset: each block owns rows of the uninitialised
//                     output, either zeroed there and reached by L2
//                     reductions (band_body) or held in shared memory and
//                     stored once (band_shared_body: shared-memory atomics,
//                     then bulk or per-thread stores); both lost to the
//                     direct route (memset + global atomics) in device time
//                     at the main path's few-event splats;
//   plane_variant     K >= 2 images past 227 KB as one private plane per
//                     (sample, channel) in shared memory, stored once: the
//                     alternative to the vector route that part 11 measures
//                     beside it;
//   cluster_wide,     private copies summed across a thread-block cluster
//   patches_cluster   through distributed shared memory and stored once
//                     (cluster_splat_body: a unit's slots split over the
//                     cluster's CTAs, CTA r sums band r of the copies),
//                     which lost to the package's private kernel (more
//                     blocks a sample in waves) for images and to its
//                     direct patch kernel for few patches: images in
//                     clusters of up to 16 CTAs (non-portable past 8) and
//                     several clusters a sample, one cluster per (patch,
//                     channel), and their occupancy; mode 1 groups a warp's
//                     lanes by pixel (splat_range_grouped: lanes whose
//                     events share a pixel sum their taps by shuffles and
//                     send one shared-memory add); mode 2 sends an event's
//                     two horizontal taps of a row as one 64-bit
//                     compare-and-swap where they share a word.
// With the shipped parameters each computes what the shipped kernel does.
// The helpers (zero_shared, splat_range, store_wait, ...) are the package's.

#include <climits>

#include <cooperative_groups.h>

#include "../event_utils_tpu_torch/csrc/scatter_kernels.cu"

namespace {

namespace cg = cooperative_groups;

// Private planes combined across a thread-block cluster, the design that
// lost to the package's bilinear_private_kernel (more blocks a sample in
// waves) and to its direct patch kernel (few patches). A unit is one
// sample's (K, H, W) image (blockIdx.y = s; one image is S = 1), or one
// (patch, channel) plane (patches_cluster). Its slots [0, n) are split over the
// gridDim.x CTAs of the unit, which form gridDim.x / G clusters of G (G =
// the cluster size, at most 8, the portable limit). Each CTA splats its
// contiguous share into a private copy of the unit's planes in its own
// shared memory (splat_range). Then, after cluster.sync(), CTA r of a
// cluster owns rows [r * K*H / G, (r + 1) * K*H / G) of the (K*H, W) stack:
// it sums the G copies of that band, its own from its shared memory and
// its peers' by reads of distributed shared memory (DSMEM), in the fixed
// order 0 .. G-1, and writes each sum once from registers. DSMEM is only
// read, once per element per copy; a tap never crosses the cluster. A final
// cluster.sync() keeps every CTA's shared memory alive until its peers have
// read it.
//
// One cluster a unit (gridDim.x == G): the sums are the unit's planes and
// are stored into out, which needs no memset and sees no atomic; with G = 1
// the copy itself is stored by the bulk copy. Several clusters a unit (few
// samples spread over the card): each cluster adds the non-zero sums of its
// band to the zeroed out; with G = 1 that is one private image a CTA added
// to the output, the kernel this one replaced.
//
// Weights: channel k of slot i of unit (u, v) is
// w[u * w_unit + v * w_group + k * wn + i]; coordinates x[u * x_unit + i].
// out of unit (u, v) starts at out + u * out_unit + v * out_group.
// splat(img, x, y, w, lo, hi) adds slots [lo, hi) of the unit whose
// coordinates and weights start at x, y, w to the copy img (splat_range).
//
// What bounds it: 8 B of coordinates per slot, 4K B per live weight and the
// planes written once; above that, the shared-memory atomics of the splat
// (a CAS loop on this card, ~0.34 T adds/s over 132 SMs: the pace of a
// grid level), the zeroing of every copy and the DSMEM reads of the
// combine (each CTA reads K*H*W floats; ~2.5 TB/s over the card).
template <bool kCluster, typename Splat>
__device__ __forceinline__ void cluster_splat_body(
    Splat splat, const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ w, long long n, long long x_unit,
    long long w_unit, long long w_group, long long out_unit,
    long long out_group, int K, int H, int W, float* __restrict__ out) {
  extern __shared__ __align__(16) float img[];
  const int total = K * H * W;
  zero_shared(img, total);
  __syncthreads();
  const long long u = blockIdx.y;
  const long long v = blockIdx.z;
  const long long share = (n + gridDim.x - 1) / gridDim.x;
  const long long lo = blockIdx.x * share;
  const long long hi = lo + share < n ? lo + share : n;
  splat(img, x + u * x_unit, y + u * x_unit, w + u * w_unit + v * w_group,
        lo, hi);
  float* o = out + u * out_unit + v * out_group;
  if (gridDim.x == 1) {
    fence_async_proxy();
    __syncthreads();
    store_start(o, img, total);
    store_wait();
    return;
  }
  // G = 1 (several single CTAs a unit) is launched without a cluster and
  // compiled without cluster code: a kernel that has it cost ~1.4 us more
  // a launch on an H100, in clusters of one too
  int G = 1;
  int r = 0;
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    G = static_cast<int>(cluster.num_blocks());
    r = static_cast<int>(cluster.block_rank());
    cluster.sync();
  } else {
    __syncthreads();
  }
  // copy g of element i (a float4 at i for at4): this CTA's own from its
  // shared memory, a peer's through DSMEM
  auto at = [&](int g, int i) -> float {
    if constexpr (kCluster) {
      if (g != r) return *cg::this_cluster().map_shared_rank(img + i, g);
    }
    return img[i];
  };
  auto at4 = [&](int g, int i) -> float4 {
    if constexpr (kCluster) {
      if (g != r)
        return *reinterpret_cast<const float4*>(
            cg::this_cluster().map_shared_rank(img + i, g));
    }
    return *reinterpret_cast<const float4*>(img + i);
  };
  const bool store = static_cast<int>(gridDim.x) == G;
  const int rows = K * H;
  const int b0 = r * rows / G * W;
  const int b1 = (r + 1) * rows / G * W;
  if (!store) {
    // one of several clusters of its unit: each non-zero sum added to the
    // zeroed out, one element a thread so that a warp's adds are adjacent
    // (the L2 takes adjacent adds faster than adds 16 B apart)
    for (int i = b0 + static_cast<int>(threadIdx.x); i < b1;
         i += static_cast<int>(blockDim.x)) {
      float sum = at(0, i);
      for (int g = 1; g < G; ++g) sum += at(g, i);
      if (sum != 0.0f) atomicAdd(o + i, sum);
    }
  } else {
    // the cluster's unit: float4 reads inside the band (every copy has the
    // same shared offsets, so peers' addresses share the alignment),
    // scalars at its two ends; float4 stores where out is aligned
    const int a0 = min((b0 + 3) & ~3, b1);
    const int a1 = max(a0, b1 & ~3);
    const bool vec_out = (reinterpret_cast<unsigned long long>(o) & 15ULL) == 0;
    for (int i = a0 + 4 * static_cast<int>(threadIdx.x); i < a1;
         i += 4 * static_cast<int>(blockDim.x)) {
      float4 sum = at4(0, i);
      for (int g = 1; g < G; ++g) {
        const float4 p = at4(g, i);
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      if (vec_out) {
        *reinterpret_cast<float4*>(o + i) = sum;
      } else {
        o[i] = sum.x;
        o[i + 1] = sum.y;
        o[i + 2] = sum.z;
        o[i + 3] = sum.w;
      }
    }
    // the band's ends: below a0 and from a1 on, at most 3 floats each
    const int tid = static_cast<int>(threadIdx.x);
    const int e = tid < 4 ? b0 + tid : a1 + tid - 4;
    if (tid < 8 && e < (tid < 4 ? a0 : b1)) {
      float sum = at(0, e);
      for (int g = 1; g < G; ++g) sum += at(g, e);
      o[e] = sum;
    }
  }
  if constexpr (kCluster) cg::this_cluster().sync();
}

// The image kernel: cluster_splat_body with splat_range (channel k of a
// slot's weights wn floats after channel 0).
template <bool kCluster>
__global__ void __launch_bounds__(kImageThreads)
cluster_splat_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ w, long long n,
                     long long x_unit, long long w_unit, long long w_group,
                     long long wn, long long out_unit, long long out_group,
                     int K, int H, int W, float* __restrict__ out) {
  cluster_splat_body<kCluster>(
      [=](float* img, const float* xu, const float* yu, const float* wu,
          long long lo, long long hi) {
        splat_range(img, H * W, K, H, W, xu, yu, wu, wn, lo, hi);
      },
      x, y, w, n, x_unit, w_unit, w_group, out_unit, out_group, K, H, W,
      out);
}

constexpr int kMaxCluster = 8;  // the portable cluster size

// A launch configuration of `grid` in clusters of (G, 1, 1).
void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    dim3 grid, int G, int threads, size_t smem,
                    void* stream) {
  cfg->gridDim = grid;
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Launch a kernel of cluster_splat_body on `grid` in clusters of G
// (cudaLaunchKernelEx with the cluster dimension attribute; it captures into
// CUDA graphs): kPlain, its instantiation without cluster code, where
// G = 1, else kCluster. A refused launch (too much shared memory,
// cudaErrorClusterOutOfResources) is returned, never replaced by another
// kernel.
template <auto kPlain, auto kCluster, typename... Args>
int launch_cluster_splat(dim3 grid, int G, int threads, size_t smem,
                         void* stream, Args... args) {
  static const cudaError_t attr[2] = {allow_max_shared(kPlain),
                                      allow_max_shared(kCluster)};
  if (attr[0] != cudaSuccess) return static_cast<int>(attr[0]);
  if (attr[1] != cudaSuccess) return static_cast<int>(attr[1]);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[1];
  cluster_config(&cfg, attrs, grid, G, threads, smem, stream);
  cudaError_t err;
  if (G == 1) {
    cfg.numAttrs = 0;  // no cluster
    err = cudaLaunchKernelEx(&cfg, kPlain, args...);
  } else {
    err = cudaLaunchKernelEx(&cfg, kCluster, args...);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch is reported once, here
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kMergeGroups = 16;  // a warp merges its lanes up to this many

// Send n floats of shared memory s to global g: stored, or with kReduce
// added to what g holds. All threads call it, after a barrier that follows
// the last write to s (and fence_async_proxy in every writer). With bulk set
// and both addresses 16-byte aligned, thread 0 starts 1-D bulk copies for
// the leading n & ~3 floats and the block's first threads move the <= 3
// left over; otherwise every thread moves its share itself (the reduction
// then skips zeros, which an image of warped events is mostly made of).
// store_wait must follow before the block ends.
template <bool kReduce>
__device__ __forceinline__ void flush_start(float* g, const float* s, int n,
                                            bool bulk) {
  const unsigned int s_addr =
      static_cast<unsigned int>(__cvta_generic_to_shared(s));
  const bool aligned =
      ((reinterpret_cast<unsigned long long>(g) | s_addr) & 15ULL) == 0;
  if (bulk && aligned) {
    const int n4 = n & ~3;
    if (threadIdx.x == 0) {
      fence_async_proxy();
      for (int done = 0; done < n4 * 4; done += kBulkBytes) {
        const int bytes = min(kBulkBytes, n4 * 4 - done);
        const char* gp = reinterpret_cast<const char*>(g) + done;
        if (kReduce) {
          asm volatile(
              "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
              "[%0], [%1], %2;"
              :: "l"(gp), "r"(s_addr + done), "r"(bytes) : "memory");
        } else {
          asm volatile(
              "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
              :: "l"(gp), "r"(s_addr + done), "r"(bytes) : "memory");
        }
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    const int i = n4 + threadIdx.x;
    if (i < n) {
      if (kReduce) atomicAdd(g + i, s[i]); else g[i] = s[i];
    }
    return;
  }
  if (kReduce) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float v = s[i];
      if (v != 0.0f) atomicAdd(g + i, v);
    }
  } else if (aligned) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    float4* g4 = reinterpret_cast<float4*>(g);
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) g4[i] = s4[i];
    for (int i = (n4 << 2) + threadIdx.x; i < n; i += blockDim.x) g[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) g[i] = s[i];
  }
}

// bilinear_patches_kernel with kb channels of a patch per block.
__global__ void __launch_bounds__(1024)
patches_variant_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const float* __restrict__ w, long long C, int K,
                       int kb, int PH, int PW, float* __restrict__ out,
                       int bulk) {
  extern __shared__ __align__(16) float img[];
  const int plane = PH * PW;
  const long long P = gridDim.x;
  const long long q = blockIdx.x;
  const int k0 = blockIdx.y * kb;
  const int kn = min(kb, K - k0);
  zero_shared(img, kn * plane);
  __syncthreads();
  splat_range(img, plane, kn, PH, PW, x, y, w + k0 * P * C, P * C, q * C,
              (q + 1) * C);
  fence_async_proxy();
  __syncthreads();
  for (int k = 0; k < kn; ++k)
    flush_start<false>(out + ((k0 + k) * P + q) * plane, img + k * plane,
                       plane, bulk != 0);
  store_wait();
}

// bilinear_private_kernel with the choice of flush.
__global__ void __launch_bounds__(1024)
private_variant_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const float* __restrict__ w, long long n, int K,
                       int H, int W, float* __restrict__ out, int bulk) {
  extern __shared__ __align__(16) float img[];
  const int total = K * H * W;
  zero_shared(img, total);
  __syncthreads();
  const long long share = (n + gridDim.x - 1) / gridDim.x;
  const long long lo = blockIdx.x * share;
  const long long hi = lo + share < n ? lo + share : n;
  splat_range(img, H * W, K, H, W, x, y, w, n, lo, hi);
  fence_async_proxy();
  __syncthreads();
  if (gridDim.x == 1)
    flush_start<false>(out, img, total, bulk != 0);
  else
    flush_start<true>(out, img, total, bulk != 0);
  store_wait();
}

// Per-tile voxel grids, bins [b_lo, b_lo + nb) of every tile: block r of
// each group of nb consecutive blocks owns plane (tile, b_lo + r). kRemote:
// the group is a cluster whose blocks split the tile's slots and add each
// tap into the owner's shared memory. Otherwise every block reads all slots
// of its tile and keeps the taps of its own bin, as voxel_tiles_private_kernel.
template <bool kRemote>
__global__ void __launch_bounds__(1024)
tiles_variant_kernel(const int* __restrict__ bx, const int* __restrict__ by,
                     const float* __restrict__ t_norm,
                     const float* __restrict__ bp, long long cap, int B,
                     int b_lo, int nb, int th, int tw,
                     float* __restrict__ out, int bulk) {
  extern __shared__ __align__(16) float bin[];
  const int plane = th * tw;
  const int r = blockIdx.x % nb;  // the block's rank in its cluster
  const long long tile = blockIdx.x / nb;
  zero_shared(bin, plane);
  if constexpr (kRemote)
    cg::this_cluster().sync();
  else
    __syncthreads();

  // the bins this block adds to: the whole group (kRemote) or its own
  const float f_lo = static_cast<float>(kRemote ? b_lo : b_lo + r);
  const float f_hi = static_cast<float>(kRemote ? b_lo + nb : b_lo + r + 1);
  const long long base = tile * cap;
  const long long start = kRemote ? static_cast<long long>(r) * blockDim.x : 0;
  const long long stride =
      static_cast<long long>(blockDim.x) * (kRemote ? nb : 1);
  for (long long first = start + threadIdx.x; first < cap;
       first += stride * kAhead) {
    // t_norm first: it says whether a tap of the slot falls into this
    // block's bins, and only then are the slot's other 12 bytes read. Dead
    // slots carry t_norm = -100 and fail the test.
    float tv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long i = first + u * stride;
      tv[u] = i < cap ? t_norm[base + i] : -100.0f;
    }
    int xs[kAhead], ys[kAhead];
    float pv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const float b0 = floorf(tv[u]);
      const bool want = b0 + 1.0f >= f_lo && b0 < f_hi;
      const long long i = base + first + u * stride;
      pv[u] = want ? bp[i] : 0.0f;
      xs[u] = want ? bx[i] : 0;
      ys[u] = want ? by[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const float p = pv[u];
      if (p == 0.0f) continue;
      const int xi = xs[u];
      const int yi = ys[u];
      if (xi < 0 || xi >= tw || yi < 0 || yi >= th) continue;
      const float t = tv[u];
      const float b0 = floorf(t);
      const float fb = t - b0;
      const int pix = yi * tw + xi;
#pragma unroll
      for (int tap = 0; tap < 2; ++tap) {
        const float b = b0 + static_cast<float>(tap);
        // float tests first: a NaN or huge bin fails them before any cast
        if (!(b >= f_lo && b < f_hi)) continue;
        const float v = tap == 0 ? p * (1.0f - fb) : p * fb;
        if constexpr (kRemote) {
          const int owner = static_cast<int>(b) - b_lo;
          atomicAdd(cg::this_cluster().map_shared_rank(bin, owner) + pix, v);
        } else {
          atomicAdd(bin + pix, v);
        }
      }
    }
  }
  fence_async_proxy();
  if constexpr (kRemote)
    cg::this_cluster().sync();
  else
    __syncthreads();
  flush_start<false>(out + (tile * B + b_lo + r) * plane, bin, plane,
                     bulk != 0);
  store_wait();
}


// bilinear_scatter_kernel with its four atomics replaced by a register sum
__global__ void probe_kernel(const float* __restrict__ x,
                             const float* __restrict__ y,
                             const float* __restrict__ w, long long n, int H,
                             int W, float* __restrict__ sums) {
  const float fW = static_cast<float>(W);
  const float fH = static_cast<float>(H);
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float acc = 0.0f;
  for (long long i = tid; i < n; i += stride) {
    const float xf = x[i];
    const float yf = y[i];
    const float x0 = floorf(xf);
    const float y0 = floorf(yf);
    const bool okx0 = x0 >= 0.0f && x0 < fW;
    const bool okx1 = x0 + 1.0f >= 0.0f && x0 + 1.0f < fW;
    const bool oky0 = y0 >= 0.0f && y0 < fH;
    const bool oky1 = y0 + 1.0f >= 0.0f && y0 + 1.0f < fH;
    if (!(okx0 || okx1) || !(oky0 || oky1)) continue;
    const float dx = xf - x0;
    const float dy = yf - y0;
    const float wk = w[i];
    if (wk == 0.0f) continue;
    const float w0 = wk * (1.0f - dx);
    const float w1 = wk * dx;
    const float base = y0 * fW + x0;  // stands for the address arithmetic
    if (oky0) {
      if (okx0) acc += w0 * (1.0f - dy) + base;
      if (okx1) acc += w1 * (1.0f - dy);
    }
    if (oky1) {
      if (okx0) acc += w0 * dy;
      if (okx1) acc += w1 * dy;
    }
  }
  sums[tid] = acc;
}


// voxel_scatter_kernel with its two atomics replaced by a register sum
__global__ void voxel_probe_kernel(const int* __restrict__ xs,
                                   const int* __restrict__ ys,
                                   const float* __restrict__ t_norm,
                                   const float* __restrict__ ps, long long n,
                                   int B, int H, int W,
                                   float* __restrict__ sums) {
  const long long plane = static_cast<long long>(H) * W;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float acc = 0.0f;
  for (long long i = tid; i < n; i += stride) {
    const float p = ps[i];
    if (p == 0.0f) continue;
    const int x = xs[i];
    const int y = ys[i];
    if (x < 0 || x >= W || y < 0 || y >= H) continue;
    const float t = t_norm[i];
    const float b0 = floorf(t);
    const float fb = t - b0;
    const long long pix = static_cast<long long>(y) * W + x;
    if (b0 >= 0.0f && b0 < static_cast<float>(B))
      acc += p * (1.0f - fb) +
             static_cast<float>(static_cast<long long>(b0) * plane + pix);
    const float b1 = b0 + 1.0f;
    if (b1 >= 0.0f && b1 < static_cast<float>(B)) acc += p * fb;
  }
  sums[tid] = acc;
}

// One thread per (row, id) element of a flat scatter: the row comes from a
// 64-bit division and the id is read again for every row. kProbe replaces
// the atomic by a register sum.
template <bool kProbe>
__global__ void flat_rows_kernel(const int* __restrict__ idx,
                                 const float* __restrict__ w, long long n,
                                 int D, long long nb,
                                 float* __restrict__ out) {
  const long long total = n * D;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float acc = 0.0f;
  for (long long i = tid; i < total; i += stride) {
    const long long d = i / n;
    const int id = idx[i - d * n];
    if (id < 0 || id >= nb) continue;
    const float v = w[i];
    if (v == 0.0f) continue;
    if (kProbe)
      acc += v + static_cast<float>(d * nb + id);
    else
      atomicAdd(out + d * nb + id, v);
  }
  if (kProbe) out[tid] = acc;
}

// flat_scatter_kernel with kAhead ids and first-row weights loaded before
// their reductions start.
__global__ void flat_ahead_kernel(const int* __restrict__ idx,
                                  const float* __restrict__ w, long long n,
                                  int D, long long nb,
                                  float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
       first < n; first += stride * kAhead) {
    int ids[kAhead];
    float w0[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long i = first + u * stride;
      ids[u] = i < n ? idx[i] : -1;
      w0[u] = i < n ? w[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int id = ids[u];
      if (id < 0 || id >= nb) continue;
      const long long i = first + u * stride;
      for (int d = 0; d < D; ++d) {
        const float v = d == 0 ? w0[u] : w[d * n + i];
        if (v != 0.0f) atomicAdd(out + d * nb + id, v);
      }
    }
  }
}

// voxel_vector_kernel with one zeroed accumulator (H*W, Bp), column c = bin
// c: an event with even b0 sends one float2, one with odd b0 two scalars.
__global__ void voxel_single_kernel(const int* __restrict__ xs,
                                    const int* __restrict__ ys,
                                    const float* __restrict__ t_norm,
                                    const float* __restrict__ ps, long long n,
                                    int B, int H, int W, int Bp,
                                    float* __restrict__ acc) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float p = ps[i];
    if (p == 0.0f) continue;
    const int x = xs[i];
    const int y = ys[i];
    if (x < 0 || x >= W || y < 0 || y >= H) continue;
    const float t = t_norm[i];
    const float b0 = floorf(t);
    if (!(b0 >= -1.0f && b0 < static_cast<float>(B))) continue;
    const float fb = t - b0;
    const int ib = static_cast<int>(b0);
    float* a = acc + (static_cast<long long>(y) * W + x) * Bp + ib;
    if ((ib & 1) == 0) {
      atomicAdd(reinterpret_cast<float2*>(a),
                make_float2(p * (1.0f - fb), p * fb));
    } else {
      if (ib >= 0) atomicAdd(a, p * (1.0f - fb));
      if (ib + 1 < B) atomicAdd(a + 1, p * fb);
    }
  }
}

__device__ __forceinline__ unsigned int hash32(unsigned int x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

// Every one of n threads adds ones to a pseudo-random place of buf (F
// floats, F a multiple of 4, zeroed). kMode 0: one scalar; 1: two scalars
// F/2 floats apart; 2: two adjacent scalars; 3: one float2; 4: one float4.
template <int kMode>
__global__ void red_probe_kernel(float* __restrict__ buf, unsigned int F,
                                 long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const unsigned int h = hash32(static_cast<unsigned int>(i));
    if (kMode == 4) {
      atomicAdd(reinterpret_cast<float4*>(buf + 4 * (h % (F / 4))),
                make_float4(1.0f, 1.0f, 1.0f, 1.0f));
      continue;
    }
    const unsigned int base = 2 * (h % (F / 2));
    if (kMode == 3) {
      atomicAdd(reinterpret_cast<float2*>(buf + base),
                make_float2(1.0f, 1.0f));
      continue;
    }
    atomicAdd(buf + base, 1.0f);
    if (kMode == 1) atomicAdd(buf + (base + F / 2) % F, 1.0f);
    if (kMode == 2) atomicAdd(buf + base + 1, 1.0f);
  }
}

// Every thread sends per_thread atomicAdds (of 1 and 2 in turn) to
// pseudo-random cells of its block's shared memory (cells a power of two),
// then the block writes the cells out so that the adds stay live.
template <typename T>
__global__ void shared_atomic_probe_kernel(T* __restrict__ out,
                                           int per_thread, int cells) {
  extern __shared__ __align__(16) unsigned char raw[];
  T* s = reinterpret_cast<T*>(raw);
  for (int i = threadIdx.x; i < cells; i += blockDim.x) s[i] = T(0);
  __syncthreads();
  unsigned int h = hash32(blockIdx.x * blockDim.x + threadIdx.x);
  for (int k = 0; k < per_thread; ++k) {
    h = hash32(h + k);
    // 1 or 2: a constant 1 would let the compiler count the warp's
    // matching lanes instead of adding (ATOMS.POPC.INC)
    atomicAdd(s + (h & (cells - 1)), T(1 + (k & 1)));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x)
    out[static_cast<long long>(blockIdx.x) * cells + i] = s[i];
}

// Sum v over the lanes of `peers` (this lane's group, from
// __match_any_sync), for groups of at most `widest` lanes, by pointer
// jumping: each lane holds the lane of the next rank in its group; after
// the step of distance d the lane of rank r holds the sum of ranks
// [r, r + 2d) and points at rank r + 2d. The group's first lane ends with
// the whole sum. All 32 lanes call it.
__device__ __forceinline__ float4 group_sum(float4 v, unsigned int peers,
                                            int lane, int widest) {
  const unsigned int above = peers & ~((2u << lane) - 1u);
  int next = above ? __ffs(above) - 1 : 32;
  for (int d = 1; d < widest; d <<= 1) {
    const int from = next < 32 ? next : lane;
    const float4 t = make_float4(__shfl_sync(0xffffffffu, v.x, from),
                                 __shfl_sync(0xffffffffu, v.y, from),
                                 __shfl_sync(0xffffffffu, v.z, from),
                                 __shfl_sync(0xffffffffu, v.w, from));
    const int after = __shfl_sync(0xffffffffu, next, from);
    if (next < 32) {
      v.x += t.x;
      v.y += t.y;
      v.z += t.z;
      v.w += t.w;
      next = after;
    }
  }
  return v;
}

// splat_range with the lanes of a warp grouped by pixel: the lanes whose
// events share their top-left tap (and so all four taps) sum their four
// tap weights by shuffles (group_sum) and the group's first lane alone
// sends the four shared-memory adds. On this card such an add is a
// compare-and-swap loop in which the lanes of a warp that hit one address
// succeed one per round, and the events of a patch or an image sharpened by
// contrast maximisation pile onto few pixels: the grouping turns up to 32
// rounds into one. A warp whose events all fall on distinct pixels skips
// the shuffles. Warps run while their first lane has slots, so every lane
// takes part in the warp-wide calls (a slot past the range is a NaN
// coordinate, which joins no pixel).
__device__ __forceinline__ void splat_range_grouped(
    float* img, int plane, int K, int H, int W, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ w, long long wn,
    long long lo, long long hi) {
  const float fW = static_cast<float>(W);
  const float fH = static_cast<float>(H);
  const int lane = static_cast<int>(threadIdx.x & 31);
  const long long step = static_cast<long long>(blockDim.x) * kAhead;
  for (long long first = lo + threadIdx.x; first - lane < hi; first += step) {
    float xs[kAhead], ys[kAhead], w0[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long i = first + static_cast<long long>(u) * blockDim.x;
      const bool in = i < hi;
      xs[u] = in ? x[i] : __int_as_float(0x7fc00000);
      ys[u] = in ? y[i] : 0.0f;
      w0[u] = in ? w[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const float xf = xs[u];
      const float yf = ys[u];
      const float x0 = floorf(xf);
      const float y0 = floorf(yf);
      const bool okx0 = x0 >= 0.0f && x0 < fW;
      const bool okx1 = x0 + 1.0f >= 0.0f && x0 + 1.0f < fW;
      const bool oky0 = y0 >= 0.0f && y0 < fH;
      const bool oky1 = y0 + 1.0f >= 0.0f && y0 + 1.0f < fH;
      const bool live = (okx0 || okx1) && (oky0 || oky1);
      // the top-left tap's id (x0 = -1 or y0 = -1 included: down to
      // -W - 1); a slot with no tap gets a key no tap id can equal
      const int pix = live ? static_cast<int>(y0) * W + static_cast<int>(x0)
                           : INT_MIN;
      const unsigned int peers = __match_any_sync(0xffffffffu, pix);
      const bool first_lane = (peers & ((1u << lane) - 1u)) == 0u;
      // merge only where the warp's events fall on few pixels (warp-uniform)
      const bool merge =
          __popc(__ballot_sync(0xffffffffu, first_lane)) <= kMergeGroups;
      const int widest =
          merge ? static_cast<int>(
                      __reduce_max_sync(0xffffffffu, __popc(peers)))
                : 1;
      const float dx = live ? xf - x0 : 0.0f;
      const float dy = live ? yf - y0 : 0.0f;
      const long long i = first + static_cast<long long>(u) * blockDim.x;
      for (int k = 0; k < K; ++k) {
        float wk = k == 0 ? w0[u] : (i < hi ? w[k * wn + i] : 0.0f);
        if (!live) wk = 0.0f;
        const float wl = wk * (1.0f - dx);
        const float wr = wk * dx;
        float4 t = make_float4(oky0 && okx0 ? wl * (1.0f - dy) : 0.0f,
                               oky0 && okx1 ? wr * (1.0f - dy) : 0.0f,
                               oky1 && okx0 ? wl * dy : 0.0f,
                               oky1 && okx1 ? wr * dy : 0.0f);
        if (widest > 1) t = group_sum(t, peers, lane, widest);
        if (live && (first_lane || !merge)) {
          // the tap pixels of a group are the same: its first lane's
          float* o = img + k * plane + pix;
          if (t.x != 0.0f) atomicAdd(o, t.x);
          if (t.y != 0.0f) atomicAdd(o + 1, t.y);
          if (t.z != 0.0f) atomicAdd(o + W, t.z);
          if (t.w != 0.0f) atomicAdd(o + W + 1, t.w);
        }
      }
    }
  }
}

// Add (a, b) to the two floats of shared memory at p (8-byte aligned) with
// one 64-bit compare-and-swap loop.
__device__ __forceinline__ void add_pair(float* p, float a, float b) {
  unsigned long long* word = reinterpret_cast<unsigned long long*>(p);
  unsigned long long seen = *word;
  unsigned long long want;
  do {
    want = seen;
    const float lo = __uint_as_float(static_cast<unsigned int>(want)) + a;
    const float hi = __uint_as_float(static_cast<unsigned int>(want >> 32)) +
                     b;
    seen = atomicCAS(word, want,
                     (static_cast<unsigned long long>(__float_as_uint(hi))
                      << 32) |
                         __float_as_uint(lo));
  } while (seen != want);
}

// splat_range with an event's two horizontal taps of a row sent as one
// 64-bit compare-and-swap where both lie inside the image and share an
// aligned 8-byte word (an even flat index), else as two float adds.
__device__ __forceinline__ void splat_range_paired(
    float* img, int plane, int K, int H, int W, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ w, long long wn,
    long long lo, long long hi) {
  const float fW = static_cast<float>(W);
  const float fH = static_cast<float>(H);
  const long long step = static_cast<long long>(blockDim.x) * kAhead;
  for (long long first = lo + threadIdx.x; first < hi; first += step) {
    float xs[kAhead], ys[kAhead], w0[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long i = first + static_cast<long long>(u) * blockDim.x;
      const bool in = i < hi;
      xs[u] = in ? x[i] : __int_as_float(0x7fc00000);
      ys[u] = in ? y[i] : 0.0f;
      w0[u] = in ? w[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const float xf = xs[u];
      const float yf = ys[u];
      const float x0 = floorf(xf);
      const float y0 = floorf(yf);
      const bool okx0 = x0 >= 0.0f && x0 < fW;
      const bool okx1 = x0 + 1.0f >= 0.0f && x0 + 1.0f < fW;
      const bool oky0 = y0 >= 0.0f && y0 < fH;
      const bool oky1 = y0 + 1.0f >= 0.0f && y0 + 1.0f < fH;
      if (!(okx0 || okx1) || !(oky0 || oky1)) continue;
      const float dx = xf - x0;
      const float dy = yf - y0;
      const int pix = static_cast<int>(y0) * W + static_cast<int>(x0);
      const long long i = first + static_cast<long long>(u) * blockDim.x;
      for (int k = 0; k < K; ++k) {
        const float wk = k == 0 ? w0[u] : w[k * wn + i];
        if (wk == 0.0f) continue;
        const float wl = wk * (1.0f - dx);
        const float wr = wk * dx;
        float* o = img + k * plane + pix;
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          if (!(row == 0 ? oky0 : oky1)) continue;
          const float wy = row == 0 ? 1.0f - dy : dy;
          float* r = o + row * W;
          const int at = pix + row * W + k * plane;
          if (okx0 && okx1 && (at & 1) == 0) {
            add_pair(r, wl * wy, wr * wy);
          } else {
            if (okx0) atomicAdd(r, wl * wy);
            if (okx1) atomicAdd(r + 1, wr * wy);
          }
        }
      }
    }
  }
}

// The cluster kernel body with the paired splat.
template <bool kCluster>
__global__ void __launch_bounds__(kImageThreads)
paired_cluster_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ w, long long n,
                      long long x_unit, long long w_unit, long long w_group,
                      long long wn, long long out_unit, long long out_group,
                      int K, int H, int W, float* __restrict__ out) {
  cluster_splat_body<kCluster>(
      [=](float* img, const float* xu, const float* yu, const float* wu,
          long long lo, long long hi) {
        splat_range_paired(img, H * W, K, H, W, xu, yu, wu, wn, lo, hi);
      },
      x, y, w, n, x_unit, w_unit, w_group, out_unit, out_group, K, H, W,
      out);
}

// The cluster kernel body with the grouped splat: the few-patch
// route that lost to the direct kernel (one cluster of G per (patch,
// channel), K = 1 a unit), and images with grouped lanes.
template <bool kCluster>
__global__ void __launch_bounds__(kImageThreads)
grouped_cluster_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const float* __restrict__ w, long long n,
                       long long x_unit, long long w_unit, long long w_group,
                       long long wn, long long out_unit, long long out_group,
                       int K, int H, int W, float* __restrict__ out) {
  cluster_splat_body<kCluster>(
      [=](float* img, const float* xu, const float* yu, const float* wu,
          long long lo, long long hi) {
        splat_range_grouped(img, H * W, K, H, W, xu, yu, wu, wn, lo, hi);
      },
      x, y, w, n, x_unit, w_unit, w_group, out_unit, out_group, K, H, W,
      out);
}

// ---------------------------------------------------------------------------
// Row bands: few events, one launch, no memset (lost; see band_variant)
// ---------------------------------------------------------------------------

constexpr int kBandAhead = 8;      // events a thread loads at once
constexpr int kBandK = 4;          // channels whose weights load with them

// One batch of a band block's events: kBandAhead events a thread, coalesced
// across the block, with their x, y and first kBandK weights (0 past K);
// a slot past the events gets y = NaN, which every row test drops.
struct BandBatch {
  float x[kBandAhead], y[kBandAhead], w[kBandAhead][kBandK];
};

__device__ __forceinline__ void load_batch(BandBatch& b,
                                           const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           const float* __restrict__ w,
                                           long long first, long long n,
                                           int K) {
#pragma unroll
  for (int u = 0; u < kBandAhead; ++u) {
    const long long i = first + static_cast<long long>(u) * blockDim.x;
    const bool in = i < n;
    b.y[u] = in ? y[i] : __int_as_float(0x7fc00000);
    b.x[u] = in ? x[i] : 0.0f;
#pragma unroll
    for (int k = 0; k < kBandK; ++k)
      b.w[u][k] = in && k < K ? w[static_cast<long long>(k) * n + i] : 0.0f;
  }
}

// Splat into rows [r0, r1) of every channel of one sample the taps of its
// events [0, n) that fall there: channel k's row r0 starts at base + k *
// stride, rows W floats apart (the band's own rows of the output, or a
// copy of them in shared memory), zeroed by the caller before its first
// barrier. An event is kept only if a tap row of it, floor(y) or
// floor(y) + 1, lies in [r0, r1) (float tests: NaN, +-inf and huge rows
// fail them; r0 >= 0 and r1 <= H hold the image's own row bounds). At
// these sizes the time is the chain of memory latencies, not bandwidth, so
// every batch is loaded whole, kept or not (the first by the caller,
// before it zeroes the band): one latency a batch before its atomics. Tap
// (y0+oy, x0+ox) gets (w*wx)*wy as in splat_global, and only where its row
// is in the band: an event with floor(y) = r1 - 1 sends its first row here
// and its second to the next band, whose block keeps it too.
__device__ __forceinline__ void splat_band(float* base, long long stride,
                                           int r0, int r1, int K, int W,
                                           const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           const float* __restrict__ w,
                                           long long n, BandBatch& b) {
  const float fW = static_cast<float>(W);
  const float lo = static_cast<float>(r0);
  const float hi = static_cast<float>(r1);
  const long long step = static_cast<long long>(blockDim.x) * kBandAhead;
  for (long long first = threadIdx.x; first < n; first += step) {
    if (first != threadIdx.x) load_batch(b, x, y, w, first, n, K);
#pragma unroll
    for (int u = 0; u < kBandAhead; ++u) {
      const float y0 = floorf(b.y[u]);
      const bool oky0 = y0 >= lo && y0 < hi;
      const bool oky1 = y0 + 1.0f >= lo && y0 + 1.0f < hi;
      if (!(oky0 || oky1)) continue;
      const float x0 = floorf(b.x[u]);
      const bool okx0 = x0 >= 0.0f && x0 < fW;
      const bool okx1 = x0 + 1.0f >= 0.0f && x0 + 1.0f < fW;
      if (!(okx0 || okx1)) continue;
      const float dx = b.x[u] - x0;
      const float dy = b.y[u] - y0;
      // band row of tap row y0: -1 where only the second row is ours
      const int pix = (static_cast<int>(y0) - r0) * W + static_cast<int>(x0);
      const long long i = first + static_cast<long long>(u) * blockDim.x;
      for (int k = 0; k < K; ++k) {
        const float wk =
            k < kBandK ? b.w[u][k] : w[static_cast<long long>(k) * n + i];
        if (wk == 0.0f) continue;
        const float wl = wk * (1.0f - dx);
        const float wr = wk * dx;
        float* o = base + k * stride + pix;
        if (oky0) {
          if (okx0) atomicAdd(o, wl * (1.0f - dy));
          if (okx1) atomicAdd(o + 1, wr * (1.0f - dy));
        }
        if (oky1) {
          if (okx0) atomicAdd(o + W, wl * dy);
          if (okx1) atomicAdd(o + W + 1, wr * dy);
        }
      }
    }
  }
}

// The row-band splat, which lost to bilinear_scatter_kernel with its
// memset: 2,048 events into 181x241 (K = 1) 0.0046 against 0.0041 ms,
// 1,226 events 0.00391 against 0.00338, 4,096 events 0.0052 against
// 0.0037, 20,000 events 3.4x (H100 80GB HBM3, 700 W; part 11 and
// chip_smoke.py). It spares a host launch (the memset) and so an eager
// call's host wall (0.0204 against 0.0273 ms at 2,048 events), but a
// host loop of such splats measured no resolved difference end to end.
//
// The band block's whole life, for any block size. Block (g, s) owns rows
// [g * rows, min((g + 1) * rows, H)) of every channel of sample s (x, y:
// row s of (S, n); weights at w + s * w_stride, as in
// bilinear_scatter_kernel); the bands tile the K x H rows of every sample
// exactly, so out needs no memset. The block loads its first batch of y,
// zeroes its own rows of out with plain stores, and after a barrier (which
// orders those stores before every later access of the block) adds its
// taps to them with L2 reductions (splat_band): no other block touches
// these rows, and no shared memory is needed.
__device__ __forceinline__ void band_body(const float* __restrict__ x,
                                          const float* __restrict__ y,
                                          const float* __restrict__ w,
                                          long long n, long long w_stride,
                                          int K, int H, int W, int rows,
                                          float* __restrict__ out) {
  const long long s = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, H);
  const int plane = (r1 - r0) * W;
  const long long image = static_cast<long long>(H) * W;
  float* o = out + s * K * image + static_cast<long long>(r0) * W;
  const float* xs = x + s * n;
  const float* ys = y + s * n;
  const float* ws = w + s * w_stride;
  BandBatch b;
  load_batch(b, xs, ys, ws, threadIdx.x, n, K);
  for (int k = 0; k < K; ++k)
    for (int i = threadIdx.x; i < plane; i += blockDim.x)
      o[k * image + i] = 0.0f;
  __syncthreads();
  splat_band(o, image, r0, r1, K, W, xs, ys, ws, n, b);
}

// The band design with the rows in shared memory, which lost to band_body
// and to the direct route at every shape part 11 measured (its chain of
// zeroing, barrier, loads, shared-memory CAS loops, barrier and stores cost
// more than the memset node it spares): zero the band there, splat with
// shared-memory atomics (splat_band), store each channel's rows once, by
// one bulk copy a channel (bulk) or by every thread's own stores.
__device__ __forceinline__ void band_shared_body(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ w, long long n, long long w_stride, int K,
    int H, int W, int rows, float* __restrict__ out, bool bulk) {
  extern __shared__ __align__(16) float band[];
  const long long s = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, H);
  const int plane = (r1 - r0) * W;
  const float* xs = x + s * n;
  const float* ys = y + s * n;
  const float* ws = w + s * w_stride;
  BandBatch b;
  load_batch(b, xs, ys, ws, threadIdx.x, n, K);
  zero_shared(band, K * plane);
  __syncthreads();
  splat_band(band, plane, r0, r1, K, W, xs, ys, ws, n, b);
  if (bulk) fence_async_proxy();
  __syncthreads();
  const long long image = static_cast<long long>(H) * W;
  float* o = out + s * K * image + static_cast<long long>(r0) * W;
  for (int k = 0; k < K; ++k) {
    if (bulk) {
      store_start(o + k * image, band + k * plane, plane);
    } else {
      for (int i = threadIdx.x; i < plane; i += blockDim.x)
        o[k * image + i] = band[k * plane + i];
    }
  }
  if (bulk) store_wait();
}

// The band kernels at any block size up to 1024 (512 measured fastest at
// 2,048 events). mode 0: band_body, the rows in the output; mode 1:
// band_shared_body with per-thread stores; mode 2: the same with bulk
// stores.
__global__ void __launch_bounds__(1024)
band_variant_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ w, long long n,
                    long long w_stride, int K, int H, int W, int rows,
                    float* __restrict__ out, int mode) {
  if (mode == 0) {
    band_body(x, y, w, n, w_stride, K, H, W, rows, out);
  } else {
    band_shared_body(x, y, w, n, w_stride, K, H, W, rows, out, mode == 2);
  }
}

// The alternative to the vector route for K >= 2 images past 227 KB: one
// block per (sample, channel) owns that (H, W) plane in shared memory (the
// plane must fit 227 KB: 181x241 does), splats every event of its sample
// with the channel's weights (splat_range, shared-memory atomics) and
// stores the plane once into an uninitialised output. Each event is read K
// times, once per channel's block.
__global__ void __launch_bounds__(kImageThreads)
plane_variant_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ w, long long n,
                     long long w_stride, int K, int H, int W,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) float img[];
  const long long s = blockIdx.y;
  const long long k = blockIdx.x;
  const int plane = H * W;
  zero_shared(img, plane);
  __syncthreads();
  splat_range(img, plane, 1, H, W, x + s * n, y + s * n,
              w + s * w_stride + k * n, n, 0, n);
  fence_async_proxy();
  __syncthreads();
  store_start(out + (s * K + k) * plane, img, plane);
  store_wait();
}

// voxel_batched_private_kernel with knobs: bands of `rows` rows a block,
// `planes` = 2: both signs' planes of a split row in one block (half the
// reads of t_norm; on an H100 0.0475 against one plane's 0.0490 ms at 96
// split rows of 12,288 into 128x128, 0.0296 against 0.0274 at 8 of
// 65,536, and no path sends split rows past 32 MB of grids, so the package
// keeps one plane a block), A slots of a row a thread per pass (A = 4 is
// the package's), mode bit 1: t_norm read as float4 (four neighbouring
// slots a load; n a multiple of 4), bit 0: the planes stored by every
// thread (float4 where aligned) instead of one bulk copy, bit 2: no store
// at all (what zeroing and accumulating cost alone).
template <int A>
__global__ void __launch_bounds__(1024)
voxel_private_variant_kernel(const int* __restrict__ xs,
                             const int* __restrict__ ys,
                             const float* __restrict__ t_norm,
                             const float* __restrict__ ps, long long n, int B,
                             int H, int W, int split, int planes, int rows,
                             int mode, float* __restrict__ out) {
  extern __shared__ __align__(16) float bin[];
  const int bands = (H + rows - 1) / rows;
  const int G = split ? 2 : 1;
  long long id = blockIdx.x;
  const int r0 = static_cast<int>(id % bands) * rows;
  id /= bands;
  const int b = static_cast<int>(id % B);
  id /= B;
  const int q = static_cast<int>(id % (G / planes));
  const long long s = id / (G / planes);
  const int r1 = min(H, r0 + rows);
  const int span = rows * W;
  zero_shared(bin, planes * span);
  __syncthreads();
  const float own = static_cast<float>(b);
  const float* const tr = t_norm + s * n;
  const long long stride = blockDim.x;
  const bool vec = mode & 2;
  for (long long pass = 0; pass < n; pass += stride * A) {
    float tv[A];
    long long iv[A];
#pragma unroll
    for (int u = 0; u < A; ++u)
      iv[u] = vec ? pass + 4 * (threadIdx.x + (u / 4) * stride) + u % 4
                  : pass + threadIdx.x + u * stride;
    if (vec) {
#pragma unroll
      for (int j = 0; j < A / 4; ++j) {
        const long long e = iv[4 * j];
        const float4 v = e < n ? *reinterpret_cast<const float4*>(tr + e)
                               : make_float4(-100.0f, -100.0f, -100.0f,
                                             -100.0f);
        tv[4 * j] = v.x;
        tv[4 * j + 1] = v.y;
        tv[4 * j + 2] = v.z;
        tv[4 * j + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < A; ++u) tv[u] = iv[u] < n ? tr[iv[u]] : -100.0f;
    }
    int xv[A], yv[A];
    float pv[A];
#pragma unroll
    for (int u = 0; u < A; ++u) {
      const float b0 = floorf(tv[u]);
      const bool want = b0 == own || b0 + 1.0f == own;
      const long long i = s * n + iv[u];
      pv[u] = want ? ps[i] : 0.0f;
      xv[u] = want ? xs[i] : 0;
      yv[u] = want ? ys[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < A; ++u) {
      float p = pv[u];
      if (p == 0.0f) continue;
      int k = 0;
      if (split) {
        const int neg = p < 0.0f;
        if (planes == 2) {
          k = neg;
        } else if (neg != q) {
          continue;
        }
        p = fabsf(p);
      }
      const int yi = yv[u];
      const int xi = xv[u];
      if (yi < r0 || yi >= r1 || xi < 0 || xi >= W) continue;
      const float b0 = floorf(tv[u]);
      const float fb = tv[u] - b0;
      atomicAdd(bin + k * span + (yi - r0) * W + xi,
                b0 == own ? p * (1.0f - fb) : p * fb);
    }
  }
  if (mode & 4) return;
  const long long grid = static_cast<long long>(B) * H * W;
  float* const o = out + (s * G + q * planes) * grid +
                   static_cast<long long>(b) * H * W +
                   static_cast<long long>(r0) * W;
  const int live = (r1 - r0) * W;
  if (mode & 1) {
    __syncthreads();
    for (int k = 0; k < planes; ++k) {
      float* g = o + k * grid;
      const float* sm = bin + k * span;
      if (((reinterpret_cast<unsigned long long>(g) |
            static_cast<unsigned long long>(__cvta_generic_to_shared(sm))) &
           15ULL) == 0) {
        for (int i = threadIdx.x; i < live / 4; i += blockDim.x)
          reinterpret_cast<float4*>(g)[i] =
              reinterpret_cast<const float4*>(sm)[i];
        for (int i = (live & ~3) + threadIdx.x; i < live; i += blockDim.x)
          g[i] = sm[i];
      } else {
        for (int i = threadIdx.x; i < live; i += blockDim.x) g[i] = sm[i];
      }
    }
    return;
  }
  fence_async_proxy();
  __syncthreads();
  for (int k = 0; k < planes; ++k)
    store_start(o + k * grid, bin + k * span, live);
  store_wait();
}

}  // namespace

extern "C" {

// The batched private voxel kernel's knobs (voxel_private_variant_kernel):
// ahead 4 or 8 slots a thread per pass; mode as the kernel's.
int voxel_private_variant(const void* xs, const void* ys, const void* t_norm,
                          const void* ps, long long S, long long n, int B,
                          int H, int W, int split, int planes, int rows,
                          int threads, int ahead, int mode, void* out,
                          void* stream) {
  static const cudaError_t a4 =
      allow_max_shared(voxel_private_variant_kernel<4>);
  static const cudaError_t a8 =
      allow_max_shared(voxel_private_variant_kernel<8>);
  if (a4 != cudaSuccess || a8 != cudaSuccess)
    return static_cast<int>(a4 != cudaSuccess ? a4 : a8);
  const int G = split ? 2 : 1;
  const long long smem = 4LL * planes * rows * W;
  if (S > 65535 || planes < 1 || G % planes != 0 || rows < 1 || rows > H ||
      threads < 32 || threads > 1024 || threads % 32 != 0 ||
      smem > kMaxSharedBytes || (ahead != 4 && ahead != 8) ||
      ((mode & 2) && n % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = S * (G / planes) * B * ((H + rows - 1) / rows);
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int nb = static_cast<unsigned int>(blocks);
  const size_t sm = static_cast<size_t>(smem);
  if (ahead == 4) {
    voxel_private_variant_kernel<4><<<nb, threads, sm, st>>>(
        static_cast<const int*>(xs), static_cast<const int*>(ys),
        static_cast<const float*>(t_norm), static_cast<const float*>(ps), n,
        B, H, W, split, planes, rows, mode, static_cast<float*>(out));
  } else {
    voxel_private_variant_kernel<8><<<nb, threads, sm, st>>>(
        static_cast<const int*>(xs), static_cast<const int*>(ys),
        static_cast<const float*>(t_norm), static_cast<const float*>(ps), n,
        B, H, W, split, planes, rows, mode, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// band_variant: bands of `rows` rows, `threads` a block, the rows in the
// output (mode 0) or in shared memory (1: per-thread stores, 2: bulk).
int band_variant(const void* x, const void* y, const void* w, long long S,
                 long long n, long long w_stride, int K, int H, int W,
                 int rows, int threads, int mode, void* out, void* stream) {
  static const cudaError_t attr = allow_max_shared(band_variant_kernel);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long smem = mode ? 4LL * K * rows * W : 0;
  if (S > 65535 || rows < 1 || smem > kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0 && K > 0) {
    const dim3 grid(static_cast<unsigned int>((H + rows - 1) / rows),
                    static_cast<unsigned int>(S));
    band_variant_kernel<<<grid, threads, static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(w), n, w_stride, K, H, W, rows,
        static_cast<float*>(out), mode);
  }
  return static_cast<int>(cudaGetLastError());
}

// plane_variant: one block per (sample, channel); out may hold anything.
int plane_variant(const void* x, const void* y, const void* w, long long S,
                  long long n, long long w_stride, int K, int H, int W,
                  void* out, void* stream) {
  static const cudaError_t attr = allow_max_shared(plane_variant_kernel);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (S > 65535 || 4LL * H * W > kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0 && K > 0) {
    const dim3 grid(static_cast<unsigned int>(K),
                    static_cast<unsigned int>(S));
    plane_variant_kernel<<<grid, kImageThreads, sizeof(float) * H * W,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(w), n, w_stride, K, H, W,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int patches_variant(const void* x, const void* y, const void* w,
                             long long P, long long C, int K, int kb, int PH,
                             int PW, void* out, int threads, int bulk,
                             void* stream) {
  static const cudaError_t attr = allow_max_shared(patches_variant_kernel);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (P > 0 && K > 0) {
    const size_t shared = sizeof(float) * kb * PH * PW;
    const dim3 grid(static_cast<unsigned int>(P),
                    static_cast<unsigned int>((K + kb - 1) / kb));
    patches_variant_kernel<<<grid, threads, shared,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(w), C, K, kb, PH, PW,
        static_cast<float*>(out), bulk);
  }
  return static_cast<int>(cudaGetLastError());
}


int private_variant(const void* x, const void* y, const void* w,
                             long long n, int K, int H, int W, void* out,
                             int blocks, int threads, int bulk,
                             void* stream) {
  static const cudaError_t attr = allow_max_shared(private_variant_kernel);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (K > 0 && blocks > 0) {
    const size_t shared = sizeof(float) * K * H * W;
    private_variant_kernel<<<blocks, threads, shared,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(w), n, K, H, W, static_cast<float*>(out),
        bulk);
  }
  return static_cast<int>(cudaGetLastError());
}


int tiles_variant(const void* bx, const void* by,
                                const void* t_norm, const void* bp,
                                long long T, long long cap, int B, int th,
                                int tw, void* out, int mode, int threads,
                                int bulk, void* stream) {
  static const cudaError_t attr_r =
      allow_max_shared(tiles_variant_kernel<true>);
  static const cudaError_t attr_l =
      allow_max_shared(tiles_variant_kernel<false>);
  if (attr_r != cudaSuccess) return static_cast<int>(attr_r);
  if (attr_l != cudaSuccess) return static_cast<int>(attr_l);
  for (int b_lo = 0; T > 0 && b_lo < B; b_lo += 8) {
    const int nb = B - b_lo < 8 ? B - b_lo : 8;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned int>(T * nb));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = sizeof(float) * th * tw;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = nb;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = mode != 0 ? 1 : 0;
    const cudaError_t rc = cudaLaunchKernelEx(
        &cfg,
        mode == 1 ? tiles_variant_kernel<true>
                  : tiles_variant_kernel<false>,
        static_cast<const int*>(bx), static_cast<const int*>(by),
        static_cast<const float*>(t_norm), static_cast<const float*>(bp), cap,
        B, b_lo, nb, th, tw, static_cast<float*>(out), bulk);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}



int probe(const void* x, const void* y, const void* w, long long n,
                     int H, int W, void* sums, int blocks, void* stream) {
  probe_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(w), n, H, W, static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}

int voxel_probe(const void* xs, const void* ys, const void* t_norm,
                const void* ps, long long n, int B, int H, int W, void* sums,
                void* stream) {
  voxel_probe_kernel<<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(xs), static_cast<const int*>(ys),
      static_cast<const float*>(t_norm), static_cast<const float*>(ps), n, B,
      H, W, static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}

// probe != 0: out takes one float per thread of the grid (at most
// 132 * 16 * 256) and needs no zeroing
int flat_rows(const void* idx, const void* w, long long n, int D,
              long long nb, void* out, int probe, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (probe) {
    flat_rows_kernel<true><<<grid_for(n * D), kThreads, 0, s>>>(
        static_cast<const int*>(idx), static_cast<const float*>(w), n, D, nb,
        static_cast<float*>(out));
  } else {
    flat_rows_kernel<false><<<grid_for(n * D), kThreads, 0, s>>>(
        static_cast<const int*>(idx), static_cast<const float*>(w), n, D, nb,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int flat_ahead(const void* idx, const void* w, long long n, int D,
               long long nb, void* out, void* stream) {
  flat_ahead_kernel<<<grid_for((n + kAhead - 1) / kAhead), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w), n, D, nb,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// acc: one zeroed accumulator (H*W, Bp), Bp even and at least B + 1; out
// (B, H, W) may hold anything
int voxel_single(const void* xs, const void* ys, const void* t_norm,
                 const void* ps, long long n, int B, int H, int W, int Bp,
                 void* acc, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(H) * W;
  voxel_single_kernel<<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const int*>(xs), static_cast<const int*>(ys),
      static_cast<const float*>(t_norm), static_cast<const float*>(ps), n, B,
      H, W, Bp, static_cast<float*>(acc));
  flat_transpose_kernel<<<grid_for(plane), kThreads, 0, s>>>(
      static_cast<const float*>(acc), plane, B, Bp, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int red_probe(void* buf, long long F, long long n, int mode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* b = static_cast<float*>(buf);
  const unsigned int f = static_cast<unsigned int>(F);
  const unsigned int g = grid_for(n);
  switch (mode) {
    case 0: red_probe_kernel<0><<<g, kThreads, 0, s>>>(b, f, n); break;
    case 1: red_probe_kernel<1><<<g, kThreads, 0, s>>>(b, f, n); break;
    case 2: red_probe_kernel<2><<<g, kThreads, 0, s>>>(b, f, n); break;
    case 3: red_probe_kernel<3><<<g, kThreads, 0, s>>>(b, f, n); break;
    case 4: red_probe_kernel<4><<<g, kThreads, 0, s>>>(b, f, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: blocks * cells values of 4 bytes; cells a power of two, at most 8192
int shared_atomic_probe(void* out, int blocks, int per_thread, int cells,
                        int as_float, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (as_float) {
    shared_atomic_probe_kernel<float><<<blocks, kThreads, cells * 4, s>>>(
        static_cast<float*>(out), per_thread, cells);
  } else {
    shared_atomic_probe_kernel<int><<<blocks, kThreads, cells * 4, s>>>(
        static_cast<int*>(out), per_thread, cells);
  }
  return static_cast<int>(cudaGetLastError());
}

// The cluster kernel (grouped = 0), the grouped one (1) or the paired one
// (2), launched in clusters of G up to 16: past 8 (the portable size) only
// with the non-portable attribute. Arguments as
// bilinear_scatter_batched_private's, with G CTAs a cluster and `clusters`
// clusters a sample for its blocks.
int cluster_wide(const void* x, const void* y, const void* w, long long S,
                 long long n, long long w_stride, int K, int H, int W,
                 void* out, int G, int clusters, int grouped, void* stream) {
  static const cudaError_t wide[3] = {
      cudaFuncSetAttribute(cluster_splat_kernel<true>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1),
      cudaFuncSetAttribute(grouped_cluster_kernel<true>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1),
      cudaFuncSetAttribute(paired_cluster_kernel<true>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1)};
  for (int i = 0; i < 3; ++i)
    if (wide[i] != cudaSuccess) return static_cast<int>(wide[i]);
  if (S > 65535 || G < 1 || G > 16 || clusters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(G * clusters),
                  static_cast<unsigned int>(S), 1);
  const size_t smem = sizeof(float) * K * H * W;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* wf = static_cast<const float*>(w);
  const long long plane = static_cast<long long>(K) * H * W;
  float* o = static_cast<float*>(out);
  if (grouped == 1)
    return launch_cluster_splat<grouped_cluster_kernel<false>,
                                grouped_cluster_kernel<true>>(
        grid, G, kImageThreads, smem, stream, xf, yf, wf, n, n, w_stride,
        0LL, n, plane, 0LL, K, H, W, o);
  if (grouped == 2)
    return launch_cluster_splat<paired_cluster_kernel<false>,
                                paired_cluster_kernel<true>>(
        grid, G, kImageThreads, smem, stream, xf, yf, wf, n, n, w_stride,
        0LL, n, plane, 0LL, K, H, W, o);
  return launch_cluster_splat<cluster_splat_kernel<false>,
                              cluster_splat_kernel<true>>(
      grid, G, kImageThreads, smem, stream, xf, yf, wf, n, n, w_stride, 0LL,
      n, plane, 0LL, K, H, W, o);
}

// The few-patch route on the cluster kernel, grouped or not: one cluster
// of G (1..8) per (patch, channel), CTAs of kPatchThreads; out may hold
// anything.
int patches_cluster(const void* x, const void* y, const void* w, long long P,
                    long long C, int K, int PH, int PW, void* out, int G,
                    int grouped, void* stream) {
  if (P > 65535 || K > 65535 || G < 1 || G > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(G), static_cast<unsigned int>(P),
                  static_cast<unsigned int>(K));
  const size_t smem = sizeof(float) * PH * PW;
  const long long plane = static_cast<long long>(PH) * PW;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (grouped)
    return launch_cluster_splat<grouped_cluster_kernel<false>,
                                grouped_cluster_kernel<true>>(
        grid, G, kPatchThreads, smem, stream, xf, yf, wf, C, C, C, P * C,
        P * C, plane, P * plane, 1, PH, PW, o);
  return launch_cluster_splat<cluster_splat_kernel<false>,
                              cluster_splat_kernel<true>>(
      grid, G, kPatchThreads, smem, stream, xf, yf, wf, C, C, C, P * C,
      P * C, plane, P * plane, 1, PH, PW, o);
}

// cudaOccupancyMaxActiveClusters for G up to 16 (non-portable past 8), of
// the cluster kernel (grouped = 0) or the grouped one.
int cluster_wide_occupancy(int G, int threads, int smem_bytes, int grouped,
                           void* active) {
  static const cudaError_t wide[2] = {
      cudaFuncSetAttribute(cluster_splat_kernel<true>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1),
      cudaFuncSetAttribute(grouped_cluster_kernel<true>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1)};
  static const cudaError_t attr[2] = {
      allow_max_shared(cluster_splat_kernel<true>),
      allow_max_shared(grouped_cluster_kernel<true>)};
  for (int i = 0; i < 2; ++i) {
    if (wide[i] != cudaSuccess) return static_cast<int>(wide[i]);
    if (attr[i] != cudaSuccess) return static_cast<int>(attr[i]);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[1];
  cluster_config(&cfg, attrs, dim3(G, 1, 1), G, threads, smem_bytes, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      static_cast<int*>(active),
      grouped ? grouped_cluster_kernel<true> : cluster_splat_kernel<true>,
      &cfg));
}
}  // extern "C"
