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
//   shared_atomic_probe  atomicAdd on shared memory, int against float.
// With the shipped parameters each computes what the shipped kernel does.
// The helpers (zero_shared, splat_range, store_wait, ...) are the package's.

#include <cooperative_groups.h>

#include "../event_utils_tpu_torch/csrc/scatter_kernels.cu"

namespace {

namespace cg = cooperative_groups;

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

}  // namespace

extern "C" {

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

}  // extern "C"
