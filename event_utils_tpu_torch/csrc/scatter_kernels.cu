// Hand-written Hopper (sm_90a) kernels for event accumulation.
//
// They replace the four Pallas TPU kernels of the JAX package's
// event_utils_tpu/ops/pallas_scatter.py. The TPU kernels recast every
// scatter as a one-hot matmul because a TPU has no fast scatter; an H100 has
// fast L2 atomics, so each kernel here computes the same function directly:
//
//   voxel_scatter        <- _voxel_kernel (voxel_matmul / _voxel_core)
//   voxel_tiles_scatter  <- _voxel_kernel on the (tile, chunk) grid
//                           (voxel_matmul_tiles)
//   flat_scatter         <- _image_kernel (image_matmul,
//                           scatter_add_flat_pallas)
//   bilinear_scatter     <- _bilinear_kernel (bilinear_matmul /
//                           _bilinear_core)
//
// What bounds them on this card: each event is read once from device memory
// (16 B/event voxel, 8 B per (id, weight) pair flat, 8 + 4K B/event
// bilinear) and scattered with float atomicAdd. The outputs of the main path
// (180x240 sensors: 864 KB voxel grid, 174 KB image) sit in the 50 MB L2, so
// the atomics resolve there; the limits are L2 atomic throughput and
// serialisation when many events hit one hot pixel. The design: one thread
// per event in a grid-stride loop (coalesced reads, enough blocks in flight
// to fill 132 SMs), every tap bounds-checked in float before any integer
// cast (out-of-image taps are dropped, never wrapped), and zero-weight
// events (masked or folded away by the wrapper) skip their atomics.
//
// Atomics make the order of accumulation, and so the last bits of the sum,
// vary from run to run. The deterministic route is the port's 'sort' impl.
//
// Each entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so that the Python wrapper raises on a refused
// launch.

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

// (B, H, W) temporally-bilinear voxel grid. The wrapper has already applied
// voxel_matmul's preprocessing: out-of-image and masked events carry p = 0,
// coordinates are clipped into the image, and out-of-window events are
// pinned to the edge bin with their surviving tap folded into p. Each event
// adds p*(1-fb) to bin floor(t) and p*fb to bin floor(t)+1, where either bin
// lies in [0, B).
__global__ void voxel_scatter_kernel(const int* __restrict__ xs,
                                     const int* __restrict__ ys,
                                     const float* __restrict__ t_norm,
                                     const float* __restrict__ ps,
                                     long long n, int B, int H, int W,
                                     float* __restrict__ out) {
  const long long plane = static_cast<long long>(H) * W;
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
    const float fb = t - b0;
    const long long pix = static_cast<long long>(y) * W + x;
    if (b0 >= 0.0f && b0 < static_cast<float>(B))
      atomicAdd(out + static_cast<long long>(b0) * plane + pix,
                p * (1.0f - fb));
    const float b1 = b0 + 1.0f;
    if (b1 >= 0.0f && b1 < static_cast<float>(B))
      atomicAdd(out + static_cast<long long>(b1) * plane + pix, p * fb);
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
// Ids outside [0, num_buckets) are dropped.
__global__ void flat_scatter_kernel(const int* __restrict__ idx,
                                    const float* __restrict__ w,
                                    long long n, int D, long long nb,
                                    float* __restrict__ out) {
  const long long total = n * D;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const long long d = i / n;
    const int id = idx[i - d * n];
    if (id < 0 || id >= nb) continue;
    const float v = w[i];
    if (v == 0.0f) continue;
    atomicAdd(out + d * nb + id, v);
  }
}

// (K, H, W) 4-tap bilinear splat of K weight channels sharing the float
// coordinates (x, y). Tap (y0+oy, x0+ox) gets w*wx*wy with
// wx in {1-dx, dx}, wy in {1-dy, dy}; taps outside the image are dropped.
__global__ void bilinear_scatter_kernel(const float* __restrict__ x,
                                        const float* __restrict__ y,
                                        const float* __restrict__ w,
                                        long long n, int K, int H, int W,
                                        float* __restrict__ out) {
  const long long plane = static_cast<long long>(H) * W;
  const float fW = static_cast<float>(W);
  const float fH = static_cast<float>(H);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
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

}  // namespace

extern "C" {

int voxel_scatter(const void* xs, const void* ys, const void* t_norm,
                  const void* ps, long long n, int B, int H, int W, void* out,
                  void* stream) {
  if (n > 0) {
    voxel_scatter_kernel<<<grid_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(xs), static_cast<const int*>(ys),
        static_cast<const float*>(t_norm), static_cast<const float*>(ps), n, B,
        H, W, static_cast<float*>(out));
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
    flat_scatter_kernel<<<grid_for(n * D), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(idx), static_cast<const float*>(w), n, D,
        num_buckets, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int bilinear_scatter(const void* x, const void* y, const void* w, long long n,
                     int K, int H, int W, void* out, void* stream) {
  if (n > 0 && K > 0) {
    bilinear_scatter_kernel<<<grid_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(w), n, K, H, W, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
