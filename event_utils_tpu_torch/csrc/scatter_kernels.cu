// Hand-written Hopper (sm_90a) kernels for event accumulation.
//
// They replace the four Pallas TPU kernels of the JAX package's
// event_utils_tpu/ops/pallas_scatter.py. The TPU kernels recast every
// scatter as a one-hot matmul because a TPU has no fast scatter; an H100 has
// atomics in its L2 and, faster still, in the shared memory of each SM, so
// each kernel here computes the same function directly:
//
//   voxel_scatter        <- _voxel_kernel (voxel_matmul / _voxel_core);
//                           as voxel_scatter_batched, the same kernel
//                           under jax.vmap (voxel_grids_fixed_n, the
//                           trainers' padded rows): the row is a grid
//                           axis, one launch for all rows
//   voxel_tiles_scatter  <- _voxel_kernel on the (tile, chunk) grid
//                           (voxel_matmul_tiles)
//   flat_scatter         <- _image_kernel (image_matmul,
//                           scatter_add_flat_pallas)
//   bilinear_scatter     <- _bilinear_kernel (bilinear_matmul /
//                           _bilinear_core), whole images and, as
//                           bilinear_patches_scatter, runs of slots that
//                           each own one patch; as bilinear_scatter_batched,
//                           the same kernel under jax.vmap, which Pallas
//                           batches by adding a grid axis (one launch for
//                           all parameter samples of a grid search)
//
// Three designs live here.
//
// Direct (the direct routes of every kernel): one thread per event in a
// grid-stride loop, float atomicAdd into an output that the wrapper has
// zeroed. Coalesced reads, enough blocks to fill 132 SMs; the adds are
// native reductions in the L2 (REDG.E.ADD.F32) that need no answer, so a
// thread sends them and goes on. They resolve in L2 while the output fits
// its 50 MB and in device memory beyond. What bounds it is the L2's rate of
// reductions (~77 G/s measured) and, where very many events share a pixel,
// their serialisation.
//
// Vector reductions (voxel_scatter and flat_scatter from ~2.6 x 10^5 events
// on): what bounds the direct kernels is the number of reductions the L2
// takes, not their bytes, and sm_90 can add a float2 or a float4 to global
// memory in one request (atomicAdd(float2*), atomicAdd(float4*): global
// addresses, naturally aligned; with the result unused they compile to
// REDG.E.ADD.F32x2 and REDG.E.ADD.F32x4). Measured on an H100, 2^21 threads
// adding to random places of a 2 MB buffer take 0.026 ms whether each sends
// one float, one float2 or one float4, and 0.049 ms for two floats, adjacent
// or not. So the taps that one event sends are made adjacent in a scratch
// accumulator and go as one request; a second small kernel rearranges the
// scratch into the output, which then needs no memset.
//   - voxel_vector: the two temporal taps of an event, bins b0 and b0 + 1 of
//     one pixel, are neighbours in a bins-innermost scratch (H*W, Bp) of its
//     grid (one per row, two with the polarity split). A
//     float2 must start at an even column, so there are two accumulators:
//     events with even b0 add (b0, b0+1) to the first, events with odd b0
//     add to the second, which is stored one column to the right so that
//     its pairs are aligned too. voxel_combine adds the two into (B, H, W).
//   - flat_vector: the D weights of one id are neighbours in a
//     rows-innermost scratch (num_buckets, Dp) and go as one float2 (D = 2)
//     or as float4s (four rows each); flat_transpose writes (D, num_buckets).
//   - bilinear_vector: the K channels of one bilinear tap are neighbours in
//     a channels-innermost scratch (S, H*W, Kp) and go as one float2 (K = 2)
//     or float4 (K = 3, 4); bilinear_unpack writes (S, K, H, W). For K >= 2
//     images past 227 KB (the timestamp image, zhu's grid levels).
//
// Private tiles (the bilinear and per-tile voxel kernels' other routes): the
// output, or the part of it that a block owns, is accumulated in that
// block's shared memory and leaves the SM once. On this card a float
// atomicAdd on shared memory is a compare-and-swap loop (ATOMS.CAST.SPIN):
// updates of one pixel form a serial chain of ~100 cycles each. So a
// private tile pays where the output outgrows the L2 (the patches of one
// batched loss evaluation, 88 MB), where it spares the memset and the
// atomics of a large output (per-tile voxel grids), or where events pile
// onto few pixels; the wrapper sends the other shapes to the direct
// kernels.
//   - bilinear_patches: run q of C consecutive slots splats into patch q
//     only, so one block per (patch, channel) owns its plane outright: zero
//     in shared memory, shared atomics, one 1-D bulk store (cp.async.bulk,
//     pointer + byte count: no tensor map). The output needs no memset and
//     sees no global atomic.
//   - bilinear_private: whole (K, H, W) images that fit 227 KB, S samples
//     of them (blockIdx.y = s; one image is S = 1). G blocks a sample each
//     splat a contiguous share of its events into a private copy and add
//     its non-zero pixels to the zeroed output; G is the wrapper's, by
//     shape: G * S within the card's 132 SMs for few samples, up to 3 a
//     sample in waves where one block a sample would leave SMs idle. With
//     one block a sample the copy is stored like a patch. The direct route,
//     bilinear_scatter_kernel, has the same sample axis and serves what no
//     other route wins.
//   - voxel_tiles_private: one block per (tile, bin) owns that bin plane in
//     its shared memory and stores it once. Every block reads t_norm of all
//     slots of its tile and keeps the taps of its own bin.
//   - voxel_batched_private (voxel_scatter_batched:private): the same
//     design with the row in place of the tile, one block per (grid, bin)
//     of S rows' grids, each plane stored once by cp.async.bulk. The
//     wrapper sends it the batches that the direct route would take and
//     whose grids pass 32 MB, two thirds of the L2 (104 DAVIS240 windows:
//     90 MB), where that route's memset and reductions reach device
//     memory; fewer rows stay direct, and the vector route keeps what it
//     takes.
//
// Variants that measured slower on an H100 (taps sent through a cluster's
// distributed shared memory, private copies summed across a cluster through
// it and stored once, for images and for few patches, cp.reduce.async.bulk
// of whole private images, several channels per block, other block sizes,
// one voxel accumulator with scalar reductions for odd first bins, flat ids
// loaded ahead or one thread per (row, id) element, a row-band splat for
// few events that spares the memset, batched voxel planes in bands of rows,
// both signs' planes in one block or read ahead by 8 slots) live with the
// script that measures them,
// scripts/tune_scatter_variants.cu.
//
// Every tap is bounds-checked in float before any integer cast
// (out-of-range taps are dropped, never wrapped), and zero-weight events
// (masked or folded away by the wrapper) skip their atomics.
//
// Atomics make the order of accumulation, and so the last bits of the sum,
// vary from run to run. The deterministic route is the port's 'sort' impl.
//
// Each entry point launches on the caller's stream, allocates nothing, and
// returns the first CUDA error so that the Python wrapper raises on a
// refused launch. Which route a call takes is the wrapper's choice, by
// shape alone; nothing here gives way to another kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // 16 resident blocks per SM

inline unsigned int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

// Blocks along x for S rows of n items each on the grid's y axis: one per
// kThreads items of a row, at most ~kMaxBlocks in all.
inline unsigned int row_blocks(long long S, long long n) {
  long long bx = (n + kThreads - 1) / kThreads;
  const long long cap = (kMaxBlocks + S - 1) / S;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  return static_cast<unsigned int>(bx);
}

// S rows of n events each (xs, ys, t_norm, ps: (S, n)) into S * G
// temporally-bilinear voxel grids (B, H, W), with the row as the grid's y
// axis (blockIdx.y = s), as the batching rule of the TPU kernel adds a grid
// axis under jax.vmap; one grid is S = 1. G = 1: row s goes to grid s.
// G = 2 (split): an event with p > 0 goes to grid 2s with weight p, one with
// p < 0 to grid 2s + 1 with weight -p (the positive and negative grids of
// events_to_neg_pos_voxel, which the wrapper encodes in the sign of p).
// The wrapper has already applied voxel_matmul's preprocessing: out-of-image
// and masked events carry p = 0, coordinates are clipped into the image, and
// out-of-window events are pinned to the edge bin with their surviving tap
// folded into p. Each event adds p*(1-fb) to bin floor(t) and p*fb to bin
// floor(t)+1 of its grid, where either bin lies in [0, B). out is zeroed.
__global__ void voxel_scatter_kernel(const int* __restrict__ xs,
                                     const int* __restrict__ ys,
                                     const float* __restrict__ t_norm,
                                     const float* __restrict__ ps,
                                     long long n, int B, int H, int W,
                                     int split, float* __restrict__ out) {
  const long long plane = static_cast<long long>(H) * W;
  const long long grid = B * plane;
  const long long row = static_cast<long long>(blockIdx.y) * n;
  float* const first = out + static_cast<long long>(blockIdx.y) *
                                 (split ? 2 : 1) * grid;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float p = ps[row + i];
    if (p == 0.0f) continue;
    const int x = xs[row + i];
    const int y = ys[row + i];
    if (x < 0 || x >= W || y < 0 || y >= H) continue;
    float* o = first;
    if (split && p < 0.0f) {
      o += grid;
      p = -p;
    }
    const float t = t_norm[row + i];
    const float b0 = floorf(t);
    const float fb = t - b0;
    const long long pix = static_cast<long long>(y) * W + x;
    if (b0 >= 0.0f && b0 < static_cast<float>(B))
      atomicAdd(o + static_cast<long long>(b0) * plane + pix,
                p * (1.0f - fb));
    const float b1 = b0 + 1.0f;
    if (b1 >= 0.0f && b1 < static_cast<float>(B))
      atomicAdd(o + static_cast<long long>(b1) * plane + pix, p * fb);
  }
}

// The voxel function with one float2 reduction per event. Each of the S * G
// grids (rows and groups as in voxel_scatter_kernel) has two zeroed
// accumulators of (H*W, Bp) floats, bins innermost, Bp even and at least
// B + 1 (B + 2 for even B): acc is (S * G, 2, H*W, Bp). Column c of the
// first holds bin c; column c of the second holds bin c - 1. An event with
// even b0 adds (p*(1-fb), p*fb) at columns (b0, b0+1) of the first, one with
// odd b0 (b0 = -1 too) at columns (b0+1, b0+2) of the second: either pair
// starts at an even column, 8-byte aligned. A tap outside [0, B) (bin -1, or
// bin B of an event at t_norm = B-1) lands in a column that
// voxel_combine_kernel never reads.
//
// What bounds it: 16 B read per event and one L2 reduction; then the scratch
// (2 * H*W * Bp floats a grid, in L2) is read once and the grids written
// once.
__global__ void voxel_vector_kernel(const int* __restrict__ xs,
                                    const int* __restrict__ ys,
                                    const float* __restrict__ t_norm,
                                    const float* __restrict__ ps,
                                    long long n, int B, int H, int W, int Bp,
                                    int split, float* __restrict__ acc) {
  const long long half = static_cast<long long>(H) * W * Bp;
  const long long row = static_cast<long long>(blockIdx.y) * n;
  float* const first = acc + static_cast<long long>(blockIdx.y) *
                                 (split ? 2 : 1) * 2 * half;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float p = ps[row + i];
    if (p == 0.0f) continue;
    const int x = xs[row + i];
    const int y = ys[row + i];
    if (x < 0 || x >= W || y < 0 || y >= H) continue;
    const float t = t_norm[row + i];
    const float b0 = floorf(t);
    // float test before the cast: NaN, +-inf and huge bins fail it; below
    // -1 or from B on neither tap has a bin
    if (!(b0 >= -1.0f && b0 < static_cast<float>(B))) continue;
    float* g = first;
    if (split && p < 0.0f) {
      g += 2 * half;
      p = -p;
    }
    const float fb = t - b0;
    const int ib = static_cast<int>(b0);  // -1 .. B-1
    const int odd = ib & 1;               // 1 for -1 too
    float* a = g + odd * half + (static_cast<long long>(y) * W + x) * Bp +
               (ib + odd);
    atomicAdd(reinterpret_cast<float2*>(a),
              make_float2(p * (1.0f - fb), p * fb));
  }
}

// out[g, b, pix] = first[g][pix, b] + second[g][pix, b + 1] for the two
// accumulators of each of the grids g = blockIdx.y, blockIdx.y + gridDim.y,
// ... < grids of voxel_vector_kernel: one thread per pixel, so that every
// store of a warp is coalesced; the strided reads of the scratch come from
// L2 and L1.
__global__ void voxel_combine_kernel(const float* __restrict__ acc,
                                     long long plane, long long grids, int B,
                                     int Bp, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = blockIdx.y; g < grids; g += gridDim.y) {
    const float* a = acc + g * 2 * plane * Bp;
    float* o = out + g * B * plane;
    for (long long pix = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
         pix < plane; pix += stride) {
      const float* even = a + pix * Bp;
      const float* odd = even + plane * Bp + 1;
      for (int b = 0; b < B; ++b) o[b * plane + pix] = even[b] + odd[b];
    }
  }
}

// (T, B, th, tw) per-tile voxel grids of events bucketed by sensor tile:
// slot i of the (T, cap) arrays belongs to tile i / cap and carries
// tile-local coordinates. The wrapper has applied voxel_matmul_tiles'
// preprocessing: out-of-tile and masked slots carry p = 0 (and the pad
// sentinel t = -100), coordinates are clipped into the tile, and
// out-of-window slots are pinned to the edge bin with their surviving tap
// folded into p. Each slot adds p*(1-fb) to bin floor(t) and p*fb to bin
// floor(t)+1 of its own tile, where either bin lies in [0, B); at t == B-1
// the second tap has fb = 0 and bin B, and is dropped.
//
// What bounds it: 16 B read per slot and one or two atomics. At 720p with
// (96, 128) tiles the output is 80 x 5 x 96 x 128 x 4 B = 19.7 MB, inside
// the 50 MB L2, so the atomics resolve there. Slot indices are 64-bit: T*cap
// may pass 2^31.
__global__ void voxel_tiles_scatter_kernel(const int* __restrict__ bx,
                                           const int* __restrict__ by,
                                           const float* __restrict__ t_norm,
                                           const float* __restrict__ bp,
                                           long long n, long long cap, int B,
                                           int th, int tw,
                                           float* __restrict__ out) {
  const long long plane = static_cast<long long>(th) * tw;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float p = bp[i];
    if (p == 0.0f) continue;
    const int x = bx[i];
    const int y = by[i];
    if (x < 0 || x >= tw || y < 0 || y >= th) continue;
    const float t = t_norm[i];
    const float b0 = floorf(t);
    const float fb = t - b0;
    float* o = out + (i / cap) * B * plane + static_cast<long long>(y) * tw + x;
    if (b0 >= 0.0f && b0 < static_cast<float>(B))
      atomicAdd(o + static_cast<long long>(b0) * plane, p * (1.0f - fb));
    const float b1 = b0 + 1.0f;
    if (b1 >= 0.0f && b1 < static_cast<float>(B))
      atomicAdd(o + static_cast<long long>(b1) * plane, p * fb);
  }
}

// (D, num_buckets) flat scatter-add: row d gets w[d, e] at bucket idx[e].
// Ids outside [0, num_buckets) are dropped. One thread per id reads the id
// once and sends one reduction per non-zero row.
__global__ void flat_scatter_kernel(const int* __restrict__ idx,
                                    const float* __restrict__ w,
                                    long long n, int D, long long nb,
                                    float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int id = idx[i];
    if (id < 0 || id >= nb) continue;
    for (int d = 0; d < D; ++d) {
      const float v = w[d * n + i];
      if (v != 0.0f) atomicAdd(out + d * nb + id, v);
    }
  }
}

// The flat function with vector reductions of V floats (2 or 4) into a
// zeroed rows-innermost scratch (num_buckets, Dp), Dp a multiple of V and at
// least D: the weights of V consecutive rows at one id go as one request.
// A group whose weights are all zero is skipped; rows from D on add zeros to
// pad columns that flat_transpose_kernel never reads.
//
// What bounds it: 4 + 4D B read per id and ceil(D / V) L2 reductions; then
// the scratch is read once and the output written once.
template <int V>
__global__ void flat_vector_kernel(const int* __restrict__ idx,
                                   const float* __restrict__ w, long long n,
                                   int D, long long nb, int Dp,
                                   float* __restrict__ scratch) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int id = idx[i];
    if (id < 0 || id >= nb) continue;
    float* row = scratch + static_cast<long long>(id) * Dp;
    for (int g = 0; g < Dp; g += V) {
      float v[V];
      bool any = false;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        v[u] = g + u < D ? w[(g + u) * n + i] : 0.0f;
        any = any || v[u] != 0.0f;
      }
      if (!any) continue;
      if constexpr (V == 2) {
        atomicAdd(reinterpret_cast<float2*>(row + g),
                  make_float2(v[0], v[1]));
      } else {
        atomicAdd(reinterpret_cast<float4*>(row + g),
                  make_float4(v[0], v[1], v[2], v[3]));
      }
    }
  }
}

// out[d, id] = scratch[id, d]: one thread per id, coalesced stores.
__global__ void flat_transpose_kernel(const float* __restrict__ scratch,
                                      long long nb, int D, int Dp,
                                      float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long id = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       id < nb; id += stride) {
    const float* row = scratch + id * Dp;
    for (int d = 0; d < D; ++d) out[d * nb + id] = row[d];
  }
}

// (K, H, W) 4-tap bilinear splat of K weight channels sharing the float
// coordinates (x, y), events first, first + stride, ... < n, with global
// atomics into out. Tap (y0+oy, x0+ox) gets w*wx*wy with wx in {1-dx, dx},
// wy in {1-dy, dy}; taps outside the image are dropped. Channel k's weights
// are w[k * n + i].
__device__ __forceinline__ void splat_global(const float* __restrict__ x,
                                             const float* __restrict__ y,
                                             const float* __restrict__ w,
                                             long long n, int K, int H,
                                             int W, float* __restrict__ out,
                                             long long first,
                                             long long stride) {
  const long long plane = static_cast<long long>(H) * W;
  const float fW = static_cast<float>(W);
  const float fH = static_cast<float>(H);
  for (long long i = first; i < n; i += stride) {
    const float xf = x[i];
    const float yf = y[i];
    const float x0 = floorf(xf);
    const float y0 = floorf(yf);
    // float comparisons: NaN and huge coordinates fail them and are dropped
    const bool okx0 = x0 >= 0.0f && x0 < fW;
    const bool okx1 = x0 + 1.0f >= 0.0f && x0 + 1.0f < fW;
    const bool oky0 = y0 >= 0.0f && y0 < fH;
    const bool oky1 = y0 + 1.0f >= 0.0f && y0 + 1.0f < fH;
    if (!(okx0 || okx1) || !(oky0 || oky1)) continue;
    const float dx = xf - x0;
    const float dy = yf - y0;
    const long long base = static_cast<long long>(y0) * W +
                           static_cast<long long>(x0);
    for (int k = 0; k < K; ++k) {
      const float wk = w[static_cast<long long>(k) * n + i];
      if (wk == 0.0f) continue;
      const float w0 = wk * (1.0f - dx);
      const float w1 = wk * dx;
      float* o = out + k * plane + base;
      if (oky0) {
        if (okx0) atomicAdd(o, w0 * (1.0f - dy));
        if (okx1) atomicAdd(o + 1, w1 * (1.0f - dy));
      }
      if (oky1) {
        if (okx0) atomicAdd(o + W, w0 * dy);
        if (okx1) atomicAdd(o + W + 1, w1 * dy);
      }
    }
  }
}

// (S, K, H, W): S samples of n events each (x, y: (S, n)), each splatted by
// splat_global, with the sample as a grid axis (blockIdx.y = s), as the
// batching rule of the TPU kernel adds one. The weights are
// w + s * w_stride: w_stride = 0 for (K, n) weights that all samples share,
// K * n for (S, K, n). One image is S = 1. out is zeroed.
__global__ void bilinear_scatter_kernel(const float* __restrict__ x,
                                        const float* __restrict__ y,
                                        const float* __restrict__ w,
                                        long long n, long long w_stride,
                                        int K, int H, int W,
                                        float* __restrict__ out) {
  const long long s = blockIdx.y;
  splat_global(x + s * n, y + s * n, w + s * w_stride, n, K, H, W,
               out + s * K * static_cast<long long>(H) * W,
               static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
               static_cast<long long>(gridDim.x) * blockDim.x);
}


// ---------------------------------------------------------------------------
// Private tiles in shared memory
// ---------------------------------------------------------------------------

constexpr int kMaxSharedBytes = 232448;  // 227 KB, the most one block can get
constexpr int kAhead = 4;  // events loaded ahead of their atomics
constexpr int kBulkBytes = 32768;  // one bulk copy moves at most this
constexpr int kPatchThreads = 256;   // block sizes that measured fastest
constexpr int kImageThreads = 1024;
constexpr int kTileThreads = 1024;
constexpr int kRowThreads = 1024;    // batched private voxel grids

// Zero n floats of shared memory (16-byte aligned), all threads.
__device__ __forceinline__ void zero_shared(float* s, int n) {
  float4* s4 = reinterpret_cast<float4*>(s);
  const int n4 = n >> 2;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    s4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = (n4 << 2) + threadIdx.x; i < n; i += blockDim.x) s[i] = 0.0f;
}

// Make this thread's shared-memory writes visible to the bulk-copy engine.
// Every thread that wrote calls it before the barrier that precedes
// store_start.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

// Store n floats of shared memory s to global g. All threads call it, after
// a barrier that follows the last write to s (and fence_async_proxy in every
// writer). Where both addresses are 16-byte aligned, thread 0 starts 1-D bulk
// copies (cp.async.bulk, pointer + byte count: no tensor map) for the leading
// n & ~3 floats and the block's first threads store the <= 3 left over;
// otherwise every thread stores its share itself. store_wait must follow
// before the block ends.
__device__ __forceinline__ void store_start(float* g, const float* s, int n) {
  const unsigned int s_addr =
      static_cast<unsigned int>(__cvta_generic_to_shared(s));
  if (((reinterpret_cast<unsigned long long>(g) | s_addr) & 15ULL) != 0) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) g[i] = s[i];
    return;
  }
  const int n4 = n & ~3;
  if (threadIdx.x == 0) {
    fence_async_proxy();
    for (int done = 0; done < n4 * 4; done += kBulkBytes) {
      const int bytes = min(kBulkBytes, n4 * 4 - done);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
          :: "l"(reinterpret_cast<const char*>(g) + done),
             "r"(s_addr + done), "r"(bytes) : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
  const int i = n4 + threadIdx.x;
  if (i < n) g[i] = s[i];
}

// Thread 0 waits until the bulk copies it started have read their source:
// shared memory must outlive them.
__device__ __forceinline__ void store_wait() {
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Splat slots [lo, hi) of (x, y) into the K planes of img (shared memory,
// plane floats apart) with shared-memory atomics; channel k's weights are
// w[k * wn + slot]. Each thread loads kAhead events before it starts their
// atomics, so the loads of one batch are in flight together. Tap
// (y0+oy, x0+ox) gets w*wx*wy as in bilinear_scatter_kernel; taps outside
// [0, H) x [0, W) are dropped, zero weights skip.
__device__ __forceinline__ void splat_range(
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
      // a slot past the range gets a NaN coordinate: every tap test fails
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

// (K, P, PH, PW) patches: run q of C consecutive slots is splatted, with
// patch-local coordinates, into patch q only. Block (q, k) owns channel k of
// patch q in shared memory and writes it out once: every element of out is
// written by exactly one block, so out needs no memset and sees no atomic.
//
// What bounds it: 8 B of coordinates per slot, 4 B per live weight, and the
// output written once.
__global__ void __launch_bounds__(kPatchThreads)
bilinear_patches_kernel(const float* __restrict__ x,
                        const float* __restrict__ y,
                        const float* __restrict__ w, long long C, int PH,
                        int PW, float* __restrict__ out) {
  extern __shared__ __align__(16) float img[];
  const int plane = PH * PW;
  const long long P = gridDim.x;
  const long long q = blockIdx.x;
  const long long k = blockIdx.y;
  zero_shared(img, plane);
  __syncthreads();
  splat_range(img, plane, 1, PH, PW, x, y, w + k * P * C, P * C, q * C,
              (q + 1) * C);
  fence_async_proxy();
  __syncthreads();
  store_start(out + (k * P + q) * plane, img, plane);
  store_wait();
}

// The patch function with one thread per slot and global atomics into a
// zeroed out: for patches whose plane does not fit one block's shared
// memory.
__global__ void bilinear_patches_direct_kernel(const float* __restrict__ x,
                                               const float* __restrict__ y,
                                               const float* __restrict__ w,
                                               long long n, long long C,
                                               long long P, int K, int PH,
                                               int PW,
                                               float* __restrict__ out) {
  const long long plane = static_cast<long long>(PH) * PW;
  const float fW = static_cast<float>(PW);
  const float fH = static_cast<float>(PH);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
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
    const long long base = (i / C) * plane +
                           static_cast<long long>(y0) * PW +
                           static_cast<long long>(x0);
    for (int k = 0; k < K; ++k) {
      const float wk = w[static_cast<long long>(k) * n + i];
      if (wk == 0.0f) continue;
      const float wl = wk * (1.0f - dx);
      const float wr = wk * dx;
      float* o = out + k * P * plane + base;
      if (oky0) {
        if (okx0) atomicAdd(o, wl * (1.0f - dy));
        if (okx1) atomicAdd(o + 1, wr * (1.0f - dy));
      }
      if (oky1) {
        if (okx0) atomicAdd(o + PW, wl * dy);
        if (okx1) atomicAdd(o + PW + 1, wr * dy);
      }
    }
  }
}

// (S, K, H, W) images that each fit one block's shared memory, with the
// sample as the grid's y axis (one image is S = 1). Each of the gridDim.x
// blocks of sample s (x, y: row s of (S, n); weights at w + s * w_stride,
// as in bilinear_scatter_kernel) splats a contiguous share of its events
// into a private copy of its image. One block a sample: the copy is the
// result and is stored into out, which needs no memset. Several: each adds
// the non-zero pixels of its copy to the zeroed out (an image of warped
// events is mostly zeros).
//
// What bounds it: 8 B of coordinates per slot, 4K B per weight read (once
// for all samples where they share the weights) and S images written once;
// above that bound it pays for zeroing and flushing gridDim.x copies of
// each image.
__global__ void __launch_bounds__(kImageThreads)
bilinear_private_kernel(const float* __restrict__ x,
                        const float* __restrict__ y,
                        const float* __restrict__ w, long long n,
                        long long w_stride, int K, int H, int W,
                        float* __restrict__ out) {
  extern __shared__ __align__(16) float img[];
  const long long s = blockIdx.y;
  const int total = K * H * W;
  zero_shared(img, total);
  __syncthreads();
  const long long share = (n + gridDim.x - 1) / gridDim.x;
  const long long lo = blockIdx.x * share;
  const long long hi = lo + share < n ? lo + share : n;
  splat_range(img, H * W, K, H, W, x + s * n, y + s * n, w + s * w_stride,
              n, lo, hi);
  fence_async_proxy();
  __syncthreads();
  float* o = out + s * total;
  if (gridDim.x == 1) {
    store_start(o, img, total);
    store_wait();
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const float v = img[i];
      if (v != 0.0f) atomicAdd(o + i, v);
    }
  }
}

// (T, B, th, tw) per-tile voxel grids. Block (tile, b) owns bin plane
// (tile, b) in shared memory and stores it once; out needs no memset and
// sees no atomic. Every block reads t_norm of all slots of its tile and, for
// the slots with a tap in its own bin, the rest. Slots need not be
// time-sorted.
//
// What bounds it: 4 B per slot, 12 B more per live slot, the output written
// once. Above that it reads t_norm B times and the rest of a live slot twice
// (one block per tap), from L2 after the first.
__global__ void __launch_bounds__(kTileThreads)
voxel_tiles_private_kernel(const int* __restrict__ bx,
                           const int* __restrict__ by,
                           const float* __restrict__ t_norm,
                           const float* __restrict__ bp, long long cap, int B,
                           int th, int tw, float* __restrict__ out) {
  extern __shared__ __align__(16) float bin[];
  const int plane = th * tw;
  const long long tile = blockIdx.x / B;
  const float own = static_cast<float>(blockIdx.x % B);  // this block's bin
  zero_shared(bin, plane);
  __syncthreads();
  const long long base = tile * cap;
  const long long stride = blockDim.x;
  for (long long first = threadIdx.x; first < cap; first += stride * kAhead) {
    // t_norm first: it says whether a tap of the slot falls into this
    // block's bin, and only then are the slot's other 12 bytes read. Dead
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
      // float tests: a NaN or huge bin fails them, and no bin is ever cast
      const float b0 = floorf(tv[u]);
      const bool want = b0 == own || b0 + 1.0f == own;
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
      atomicAdd(bin + yi * tw + xi, b0 == own ? p * (1.0f - fb) : p * fb);
    }
  }
  fence_async_proxy();
  __syncthreads();
  store_start(out + blockIdx.x * static_cast<long long>(plane), bin, plane);
  store_wait();
}

// S rows of n events (xs, ys, t_norm, ps: (S, n)) into S * G voxel grids
// (B, H, W), the function of voxel_scatter_kernel (G = 2 with split: p > 0
// to grid 2s with weight p, p < 0 to grid 2s + 1 with weight -p), with each
// output element written by exactly one block: out needs no memset and
// sees no atomic. Block (g * B + b) owns bin plane b of grid g = s * G + q
// in shared memory. The blocks of one row are neighbours, so that they run
// in the same wave and its events come from the L2 after the first read.
// Every block reads t_norm of its row's n slots and, for the slots with a
// tap in its own bin, the other 12 bytes; it keeps the taps of its sign,
// as voxel_tiles_private_kernel does. Float tests: a NaN, infinite or huge
// bin fails them, and no bin is ever cast.
//
// What bounds it: 4 B per slot, 12 B more per live slot, the grids written
// once. Above that each row's t_norm is read by all of its blocks and a
// live slot's other 12 bytes by the blocks of its two bins, from the L2
// after the first read, and the taps meet in the shared-memory CAS loop:
// the reads' latency, one block an SM at 180x240, sets the pace.
__global__ void __launch_bounds__(kRowThreads)
voxel_batched_private_kernel(const int* __restrict__ xs,
                             const int* __restrict__ ys,
                             const float* __restrict__ t_norm,
                             const float* __restrict__ ps, long long n, int B,
                             int H, int W, int split,
                             float* __restrict__ out) {
  extern __shared__ __align__(16) float bin[];
  const int plane = H * W;
  const int G = split ? 2 : 1;
  const int b = static_cast<int>(blockIdx.x % B);
  const long long g = blockIdx.x / B;  // the grid: row g / G, sign g % G
  const int q = static_cast<int>(g % G);
  zero_shared(bin, plane);
  __syncthreads();
  const float own = static_cast<float>(b);
  const long long base = g / G * n;
  const long long stride = blockDim.x;
  for (long long first = threadIdx.x; first < n; first += stride * kAhead) {
    // t_norm first: whether a tap of the slot falls into this block's bin
    float tv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long i = first + u * stride;
      tv[u] = i < n ? t_norm[base + i] : -100.0f;
    }
    int xv[kAhead], yv[kAhead];
    float pv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const float b0 = floorf(tv[u]);
      const bool want = b0 == own || b0 + 1.0f == own;
      const long long i = base + first + u * stride;
      pv[u] = want ? ps[i] : 0.0f;
      xv[u] = want ? xs[i] : 0;
      yv[u] = want ? ys[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      float p = pv[u];
      if (p == 0.0f) continue;
      if (split) {
        if ((p < 0.0f) != q) continue;  // the other sign's grid
        p = fabsf(p);
      }
      const int yi = yv[u];
      const int xi = xv[u];
      if (yi < 0 || yi >= H || xi < 0 || xi >= W) continue;
      const float t = tv[u];
      const float b0 = floorf(t);
      const float fb = t - b0;
      atomicAdd(bin + yi * W + xi, b0 == own ? p * (1.0f - fb) : p * fb);
    }
  }
  fence_async_proxy();
  __syncthreads();
  store_start(out + (g * B + b) * plane, bin, plane);
  store_wait();
}

// ---------------------------------------------------------------------------
// Channels innermost: many events into K >= 2 channels past shared memory
// ---------------------------------------------------------------------------

// Add f * (v[0], .., v[V-1]) to V neighbouring floats of global memory in
// one reduction (REDG.E.ADD.F32x2 / .F32x4; p aligned to V floats).
template <int V>
__device__ __forceinline__ void add_vector(float* p, const float* v,
                                           float f) {
  if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0] * f, v[1] * f));
  } else {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0] * f, v[1] * f, v[2] * f, v[3] * f));
  }
}

// (S, K, H, W) splats with each tap's K values sent as vector reductions
// into a zeroed channels-innermost scratch (S, H*W, Kp): Kp = 2 for K = 2
// (one float2 a tap), else K rounded up to whole float4s (one float4 a tap
// for K = 3 and K = 4; pad channels add zeros to columns that
// bilinear_unpack_kernel never reads). One thread per slot, the sample as
// the grid's y axis, weights at w + s * w_stride (bilinear_scatter_kernel's
// layout); a group of V channels whose weights are all zero is skipped.
// Each value is (w*wx)*wy, the direct kernel's order of products.
//
// What bounds it: what bounds the direct kernel, the L2's rate of
// reduction requests, now one a tap instead of K; then the scratch is read
// once and the output written once (bilinear_unpack_kernel).
template <int V>
__global__ void bilinear_vector_kernel(const float* __restrict__ x,
                                       const float* __restrict__ y,
                                       const float* __restrict__ w,
                                       long long n, long long w_stride,
                                       int K, int H, int W, int Kp,
                                       float* __restrict__ scratch) {
  const long long s = blockIdx.y;
  const float* xs = x + s * n;
  const float* ys = y + s * n;
  const float* ws = w + s * w_stride;
  float* acc = scratch + s * static_cast<long long>(H) * W * Kp;
  const float fW = static_cast<float>(W);
  const float fH = static_cast<float>(H);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float xf = xs[i];
    const float yf = ys[i];
    const float x0 = floorf(xf);
    const float y0 = floorf(yf);
    const bool okx0 = x0 >= 0.0f && x0 < fW;
    const bool okx1 = x0 + 1.0f >= 0.0f && x0 + 1.0f < fW;
    const bool oky0 = y0 >= 0.0f && y0 < fH;
    const bool oky1 = y0 + 1.0f >= 0.0f && y0 + 1.0f < fH;
    if (!(okx0 || okx1) || !(oky0 || oky1)) continue;
    const float dx = xf - x0;
    const float dy = yf - y0;
    float* a = acc + (static_cast<long long>(y0) * W +
                      static_cast<long long>(x0)) * Kp;
    const long long row = static_cast<long long>(W) * Kp;
    for (int g = 0; g < Kp; g += V) {
      float wl[V], wr[V];
      bool any = false;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float wk =
            g + u < K ? ws[static_cast<long long>(g + u) * n + i] : 0.0f;
        any = any || wk != 0.0f;
        wl[u] = wk * (1.0f - dx);
        wr[u] = wk * dx;
      }
      if (!any) continue;
      if (oky0) {
        if (okx0) add_vector<V>(a + g, wl, 1.0f - dy);
        if (okx1) add_vector<V>(a + Kp + g, wr, 1.0f - dy);
      }
      if (oky1) {
        if (okx0) add_vector<V>(a + row + g, wl, dy);
        if (okx1) add_vector<V>(a + row + Kp + g, wr, dy);
      }
    }
  }
}

// out[s, k, pix] = scratch[s, pix, k] for k < K: one thread per (sample,
// pixel) reads its scratch row as V-float vectors and stores the K values
// coalesced, one plane apart.
template <int V>
__global__ void bilinear_unpack_kernel(const float* __restrict__ scratch,
                                       long long pixels, long long image,
                                       int K, int Kp,
                                       float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       p < pixels; p += stride) {
    const long long s = p / image;
    float* o = out + s * K * image + (p - s * image);
    const float* row = scratch + p * Kp;
    for (int g = 0; g < K; g += V) {
      float v[V];
      if constexpr (V == 2) {
        const float2 q = *reinterpret_cast<const float2*>(row + g);
        v[0] = q.x;
        v[1] = q.y;
      } else {
        const float4 q = *reinterpret_cast<const float4*>(row + g);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
      }
#pragma unroll
      for (int u = 0; u < V; ++u)
        if (g + u < K) o[(g + u) * image] = v[u];
    }
  }
}

// Let a kernel ask for up to 227 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_max_shared(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
}

}  // namespace

extern "C" {

// S rows of n events into S * G zeroed grids (split: G = 2, else 1). At
// most 65535 rows (the grid's y extent): the wrapper launches larger
// batches in chunks.
int voxel_scatter_batched(const void* xs, const void* ys, const void* t_norm,
                          const void* ps, long long S, long long n, int B,
                          int H, int W, int split, void* out, void* stream) {
  if (S > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0 && n > 0 && B > 0) {
    const dim3 grid(row_blocks(S, n), static_cast<unsigned int>(S));
    voxel_scatter_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(xs), static_cast<const int*>(ys),
        static_cast<const float*>(t_norm), static_cast<const float*>(ps), n, B,
        H, W, split, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int voxel_tiles_scatter(const void* bx, const void* by, const void* t_norm,
                        const void* bp, long long n, long long cap, int B,
                        int th, int tw, void* out, void* stream) {
  if (n > 0 && cap > 0) {
    voxel_tiles_scatter_kernel<<<grid_for(n), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(bx), static_cast<const int*>(by),
        static_cast<const float*>(t_norm), static_cast<const float*>(bp), n,
        cap, B, th, tw, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int flat_scatter(const void* idx, const void* w, long long n, int D,
                 long long num_buckets, void* out, void* stream) {
  if (n > 0 && D > 0) {
    flat_scatter_kernel<<<grid_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(idx), static_cast<const float*>(w), n, D,
        num_buckets, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// scratch: (num_buckets, Dp) zeroed floats, 16-byte aligned; Dp = 2 for
// D = 2, else D rounded up to a multiple of 4. out may hold anything.
int flat_scatter_vector(const void* idx, const void* w, long long n, int D,
                        long long num_buckets, int Dp, void* scratch,
                        void* out, void* stream) {
  if (D < 2 || Dp < D || (Dp != 2 && Dp % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (Dp == 2) {
      flat_vector_kernel<2><<<grid_for(n), kThreads, 0, s>>>(
          static_cast<const int*>(idx), static_cast<const float*>(w), n, D,
          num_buckets, Dp, static_cast<float*>(scratch));
    } else {
      flat_vector_kernel<4><<<grid_for(n), kThreads, 0, s>>>(
          static_cast<const int*>(idx), static_cast<const float*>(w), n, D,
          num_buckets, Dp, static_cast<float*>(scratch));
    }
  }
  if (num_buckets > 0) {
    flat_transpose_kernel<<<grid_for(num_buckets), kThreads, 0, s>>>(
        static_cast<const float*>(scratch), num_buckets, D, Dp,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// acc: (S * G, 2, H*W, Bp) zeroed floats (two accumulators a grid), 8-byte
// aligned; Bp even, at least B + 1 for odd B and B + 2 for even B; G = 2
// with split, else 1. out may hold anything. At most 65535 rows.
int voxel_scatter_batched_vector(const void* xs, const void* ys,
                                 const void* t_norm, const void* ps,
                                 long long S, long long n, int B, int H,
                                 int W, int split, int Bp, void* acc,
                                 void* out, void* stream) {
  if (S > 65535 || B < 1 || Bp % 2 != 0 || Bp < B + 1 + (B % 2 == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(H) * W;
  const long long grids = S * (split ? 2 : 1);
  if (S > 0 && n > 0) {
    const dim3 grid(row_blocks(S, n), static_cast<unsigned int>(S));
    voxel_vector_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const int*>(xs), static_cast<const int*>(ys),
        static_cast<const float*>(t_norm), static_cast<const float*>(ps), n, B,
        H, W, Bp, split, static_cast<float*>(acc));
  }
  if (grids > 0 && plane > 0) {
    const long long gy = grids < 65535 ? grids : 65535;
    const dim3 grid(row_blocks(gy, plane), static_cast<unsigned int>(gy));
    voxel_combine_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(acc), plane, grids, B, Bp,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int bilinear_patches_scatter(const void* x, const void* y, const void* w,
                             long long P, long long C, int K, int PH, int PW,
                             void* out, void* stream) {
  static const cudaError_t attr = allow_max_shared(bilinear_patches_kernel);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (P > 0 && K > 0) {
    const dim3 grid(static_cast<unsigned int>(P), static_cast<unsigned int>(K));
    bilinear_patches_kernel<<<grid, kPatchThreads, sizeof(float) * PH * PW,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(w), C, PH, PW, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int bilinear_patches_scatter_direct(const void* x, const void* y,
                                    const void* w, long long P, long long C,
                                    int K, int PH, int PW, void* out,
                                    void* stream) {
  const long long n = P * C;
  if (n > 0 && K > 0) {
    bilinear_patches_direct_kernel<<<grid_for(n), kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(w), n, C, P, K, PH, PW,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// S samples (x, y: (S, n)) into (S, K, H, W); w is (K, n) shared
// (w_stride 0) or (S, K, n) (w_stride K * n). At most 65535 samples (the
// grid's y extent): the wrapper launches larger batches in chunks.
// Direct: out zeroed.
int bilinear_scatter_batched(const void* x, const void* y, const void* w,
                             long long S, long long n, long long w_stride,
                             int K, int H, int W, void* out, void* stream) {
  if (S > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0 && n > 0 && K > 0) {
    const dim3 grid(row_blocks(S, n), static_cast<unsigned int>(S));
    bilinear_scatter_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(w), n, w_stride, K, H, W,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Private: blocks per sample; 1 stores each image (out may hold anything),
// more add their private images to out, which must be zeroed.
int bilinear_scatter_batched_private(const void* x, const void* y,
                                     const void* w, long long S, long long n,
                                     long long w_stride, int K, int H, int W,
                                     void* out, int blocks, void* stream) {
  static const cudaError_t attr = allow_max_shared(bilinear_private_kernel);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (S > 65535 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0 && K > 0) {
    const dim3 grid(static_cast<unsigned int>(blocks),
                    static_cast<unsigned int>(S));
    bilinear_private_kernel<<<grid, kImageThreads,
                              sizeof(float) * K * H * W,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(w), n, w_stride, K, H, W,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// scratch: (S, H*W, Kp) zeroed floats, 16-byte aligned; Kp = 2 for K = 2,
// else K rounded up to a multiple of 4. out may hold anything.
int bilinear_scatter_batched_vector(const void* x, const void* y,
                                    const void* w, long long S, long long n,
                                    long long w_stride, int K, int H, int W,
                                    int Kp, void* scratch, void* out,
                                    void* stream) {
  if (S > 65535 || K < 2 || Kp < K || (Kp != 2 && Kp % 4 != 0) ||
      (Kp == 2) != (K == 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long pixels = S * static_cast<long long>(H) * W;
  if (S > 0 && n > 0) {
    const dim3 grid(row_blocks(S, n), static_cast<unsigned int>(S));
    const float* xf = static_cast<const float*>(x);
    const float* yf = static_cast<const float*>(y);
    const float* wf = static_cast<const float*>(w);
    float* acc = static_cast<float*>(scratch);
    if (Kp == 2) {
      bilinear_vector_kernel<2><<<grid, kThreads, 0, st>>>(
          xf, yf, wf, n, w_stride, K, H, W, Kp, acc);
    } else {
      bilinear_vector_kernel<4><<<grid, kThreads, 0, st>>>(
          xf, yf, wf, n, w_stride, K, H, W, Kp, acc);
    }
  }
  if (pixels > 0) {
    const long long image = static_cast<long long>(H) * W;
    if (Kp == 2) {
      bilinear_unpack_kernel<2><<<grid_for(pixels), kThreads, 0, st>>>(
          static_cast<const float*>(scratch), pixels, image, K, Kp,
          static_cast<float*>(out));
    } else {
      bilinear_unpack_kernel<4><<<grid_for(pixels), kThreads, 0, st>>>(
          static_cast<const float*>(scratch), pixels, image, K, Kp,
          static_cast<float*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int voxel_tiles_scatter_private(const void* bx, const void* by,
                                const void* t_norm, const void* bp,
                                long long T, long long cap, int B, int th,
                                int tw, void* out, void* stream) {
  static const cudaError_t attr = allow_max_shared(voxel_tiles_private_kernel);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (T > 0 && B > 0) {
    voxel_tiles_private_kernel<<<static_cast<unsigned int>(T * B),
                                 kTileThreads, sizeof(float) * th * tw,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(bx), static_cast<const int*>(by),
        static_cast<const float*>(t_norm), static_cast<const float*>(bp), cap,
        B, th, tw, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// S rows of n events into S * G grids (split: G = 2, else 1) by
// voxel_batched_private_kernel, one plane of H * W floats a block within
// 227 KB. out may hold anything. At most 65535 rows.
int voxel_scatter_batched_private(const void* xs, const void* ys,
                                  const void* t_norm, const void* ps,
                                  long long S, long long n, int B, int H,
                                  int W, int split, void* out, void* stream) {
  static const cudaError_t attr =
      allow_max_shared(voxel_batched_private_kernel);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long smem = 4LL * H * W;
  if (S > 65535 || smem > kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = S * (split ? 2 : 1) * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0 && smem > 0) {
    voxel_batched_private_kernel<<<
        static_cast<unsigned int>(blocks), kRowThreads,
        static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(xs), static_cast<const int*>(ys),
        static_cast<const float*>(t_norm), static_cast<const float*>(ps), n, B,
        H, W, split, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
