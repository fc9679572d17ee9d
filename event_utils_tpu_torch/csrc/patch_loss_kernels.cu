// The ROI patch loss of the variance objective under the linear-velocity
// warp, value and gradient in one Hopper (sm_90a) kernel.
//
// It replaces no TPU kernel. The JAX package's make_patch_loss (and the
// port's, events_cmax.py) composes one evaluation of the ROI solvers' loss
// from the warp, the masks, the patch splat (bilinear_matmul, here
// bilinear_patches_scatter), two blur convolutions and two sums, and
// autograd adds the backward. On the card that is ~90 launches of small
// kernels an evaluation, and the ROI refine runs 33 evaluations a window.
// This kernel computes the same function for one ROI per block:
//
//   1. t0, the masked latest stamp (0 for an empty ROI), and each slot's
//      patch-local coordinates px = x - (t - t0) vx - (ox + rw/2 - PW/2),
//      py likewise, with the body's f32 operations in the body's order
//      (no contraction into FMAs), so the in-patch test agrees with it;
//   2. the bilinear splat of w = p * mask into a (PH, PW) f32 plane in
//      shared memory, for slots whose four taps all lie in the patch
//      (events with a tap outside it weigh 0, as in the body);
//   3. the separable zero-padded blur by the taps k (two passes through a
//      second plane), Q = sum iwe^2 and S = sum iwe, and the loss
//      -(Q/FP - (S/FP)^2), FP the full frame's pixel count;
//   4. with the gradient: dL/diwe = -2 iwe/FP + 2 S/FP^2 blurred back by
//      the flipped taps (the blur's transpose under zero padding), then,
//      per slot, the derivative of its four bilinear fractions against
//      that plane, times -(t - t0), summed over the block: dL/d(vx, vy).
//
// The splat touches only a small box of the patch (the ROI's events moved
// by the warp), so the blur passes run over that box widened by the
// taps' radius, found with shared int atomics during the splat; the rest
// of the plane is zero and adds nothing to Q and S, and the gradient is
// needed only at the splat's taps.
//
// What bounds it: not bytes (20 B a slot, read up to three times from L2,
// a few MB an evaluation) but latency: one block per ROI (108 on 132 SMs,
// one wave), ~10 barriers, and the splat's shared float atomics, which on
// this card are compare-and-swap loops (ATOMS.CAST.SPIN). 1024 threads a
// block keep as many of those loops in flight as an SM holds. Everything
// is f32; the order of the atomics, and so the last bits of the sums,
// varies from run to run.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns the first CUDA error, so that the Python wrapper raises on a
// refused launch.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSharedBytes = 232448;  // 227 KB, the most one block can get

// Shared memory of a block: two (PH, PW) planes, the taps (padded to a
// multiple of 4), 2 * kWarps floats for the reductions and the splat's box
// (4 ints). ops/cuda_scatter.py's patch_variance_shared_bytes mirrors it.
inline long long shared_bytes(int PH, int PW, int r) {
  const long long taps = ((2LL * r + 1 + 3) / 4) * 4;
  return 4LL * (2LL * PH * PW + taps + 2 * kWarps + 4);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block sums of (a, b), the same in every thread: each warp reduces the
// warps' partials in one order. red holds 2 * kWarps floats.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[2 * warp] = a;
    red[2 * warp + 1] = b;
  }
  __syncthreads();
  a = warp_sum(lane < kWarps ? red[2 * lane] : 0.0f);
  b = warp_sum(lane < kWarps ? red[2 * lane + 1] : 0.0f);
  __syncthreads();  // red is free again
  return make_float2(a, b);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = warp_max(lane < kWarps ? red[lane] : __int_as_float(0xff800000));
  __syncthreads();
  return v;
}

// Slot i under velocity (vx, vy): patch-local (px, py), weight w = p * mask
// and dt = t - t0. True where the slot splats: nonzero weight and all four
// taps inside the patch.
__device__ __forceinline__ bool place(const float* __restrict__ x,
                                      const float* __restrict__ y,
                                      const float* __restrict__ t,
                                      const float* __restrict__ p,
                                      const float* __restrict__ mask,
                                      long long i, float t0, float vx,
                                      float vy, float offx, float offy,
                                      float fH, float fW, float& px,
                                      float& py, float& w, float& dt) {
  w = __fmul_rn(p[i], mask[i]);
  dt = __fsub_rn(t[i], t0);
  px = __fsub_rn(__fsub_rn(x[i], __fmul_rn(dt, vx)), offx);
  py = __fsub_rn(__fsub_rn(y[i], __fmul_rn(dt, vy)), offy);
  const float x0 = floorf(px);
  const float y0 = floorf(py);
  return w != 0.0f && x0 >= 0.0f && x0 + 1.0f < fW && y0 >= 0.0f &&
         y0 + 1.0f < fH;
}

// One ROI per block (blockIdx.x): slots [q*C, (q+1)*C) of x, y, t, p, mask;
// origin (R, 2) as (y, x); params (R, 2) as (vx, vy); taps 2r + 1 floats.
// Writes loss[q] and, with with_grad, grad[2q], grad[2q + 1].
__global__ void __launch_bounds__(kThreads)
patch_variance_vg_kernel(const float* __restrict__ x,
                         const float* __restrict__ y,
                         const float* __restrict__ t,
                         const float* __restrict__ p,
                         const float* __restrict__ mask,
                         const float* __restrict__ origin,
                         const float* __restrict__ params,
                         const float* __restrict__ taps, long long C, int r,
                         int PH, int PW, float half_rh, float half_rw,
                         float FP, int with_grad, float* __restrict__ loss,
                         float* __restrict__ grad) {
  extern __shared__ __align__(16) float smem[];
  const int plane = PH * PW;
  const int ntaps = 2 * r + 1;
  float* const a = smem;
  float* const b = smem + plane;
  float* const k = b + plane;
  float* const red = k + ((ntaps + 3) / 4) * 4;
  int* const box = reinterpret_cast<int*>(red + 2 * kWarps);
  const long long q = blockIdx.x;
  const float* const xq = x + q * C;
  const float* const yq = y + q * C;
  const float* const tq = t + q * C;
  const float* const pq = p + q * C;
  const float* const mq = mask + q * C;
  const float fH = static_cast<float>(PH);
  const float fW = static_cast<float>(PW);

  for (int i = threadIdx.x; i < ntaps; i += kThreads) k[i] = taps[i];
  if (threadIdx.x == 0) {
    box[0] = INT_MAX;  // least and greatest y0, least and greatest x0
    box[1] = -1;
    box[2] = INT_MAX;
    box[3] = -1;
  }
  {  // zero the splat's plane
    float4* a4 = reinterpret_cast<float4*>(a);
    for (int i = threadIdx.x; i < (plane >> 2); i += kThreads)
      a4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = ((plane >> 2) << 2) + threadIdx.x; i < plane; i += kThreads)
      a[i] = 0.0f;
  }

  // 1. t0: the latest stamp among masked-in slots, 0 where there is none
  float tmax = __int_as_float(0xff800000);
  int any = 0;
  for (long long i = threadIdx.x; i < C; i += kThreads) {
    if (mq[i] != 0.0f) {
      tmax = fmaxf(tmax, tq[i]);
      any = 1;
    }
  }
  any = __syncthreads_or(any);
  tmax = block_max(tmax, red);
  const float t0 = any ? tmax : 0.0f;
  const float vx = params[2 * q];
  const float vy = params[2 * q + 1];
  const float offx = __fsub_rn(__fadd_rn(origin[2 * q + 1], half_rw),
                               0.5f * fW);
  const float offy = __fsub_rn(__fadd_rn(origin[2 * q], half_rh),
                               0.5f * fH);

  // 2. splat, and the box of the taps' top-left corners
  int ylo = INT_MAX, yhi = -1, xlo = INT_MAX, xhi = -1;
  for (long long i = threadIdx.x; i < C; i += kThreads) {
    float px, py, w, dt;
    if (!place(xq, yq, tq, pq, mq, i, t0, vx, vy, offx, offy, fH, fW, px, py,
               w, dt))
      continue;
    const float x0 = floorf(px);
    const float y0 = floorf(py);
    const float dx = px - x0;
    const float dy = py - y0;
    const int ix = static_cast<int>(x0);
    const int iy = static_cast<int>(y0);
    ylo = min(ylo, iy);
    yhi = max(yhi, iy);
    xlo = min(xlo, ix);
    xhi = max(xhi, ix);
    const float wl = w * (1.0f - dx);
    const float wr = w * dx;
    float* o = a + iy * PW + ix;
    atomicAdd(o, wl * (1.0f - dy));
    atomicAdd(o + 1, wr * (1.0f - dy));
    atomicAdd(o + PW, wl * dy);
    atomicAdd(o + PW + 1, wr * dy);
  }
  ylo = __reduce_min_sync(0xffffffffu, ylo);
  yhi = __reduce_max_sync(0xffffffffu, yhi);
  xlo = __reduce_min_sync(0xffffffffu, xlo);
  xhi = __reduce_max_sync(0xffffffffu, xhi);
  if ((threadIdx.x & 31) == 0 && yhi >= 0) {
    atomicMin(box, ylo);
    atomicMax(box + 1, yhi);
    atomicMin(box + 2, xlo);
    atomicMax(box + 3, xhi);
  }
  __syncthreads();
  // The splat is nonzero in rows [by0, by1) and columns [bx0, bx1) only;
  // the blurred image in those widened by r (clamped to the patch).
  const bool empty = box[1] < 0;
  const int by0 = empty ? 0 : box[0];
  const int by1 = empty ? 0 : box[1] + 2;
  const int bx0 = empty ? 0 : box[2];
  const int bx1 = empty ? 0 : box[3] + 2;
  const int ry0 = max(by0 - r, 0);
  const int ry1 = empty ? 0 : min(by1 + r, PH);
  const int rx0 = max(bx0 - r, 0);
  const int rx1 = empty ? 0 : min(bx1 + r, PW);

  // 3. blur: columns of the splat into b, then rows of b into a (the IWE)
  {
    const int w_ = bx1 - bx0;
    const int n = (ry1 - ry0) * w_;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int yy = ry0 + i / w_;
      const int xx = bx0 + i % w_;
      const int j0 = max(0, by0 - yy + r);
      const int j1 = min(ntaps, by1 - yy + r);
      float s = 0.0f;
      for (int j = j0; j < j1; ++j) s += k[j] * a[(yy + j - r) * PW + xx];
      b[yy * PW + xx] = s;
    }
  }
  __syncthreads();
  float qsum = 0.0f, ssum = 0.0f;
  {
    const int w_ = rx1 - rx0;
    const int n = (ry1 - ry0) * w_;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int yy = ry0 + i / w_;
      const int xx = rx0 + i % w_;
      const int j0 = max(0, bx0 - xx + r);
      const int j1 = min(ntaps, bx1 - xx + r);
      float s = 0.0f;
      for (int j = j0; j < j1; ++j) s += k[j] * b[yy * PW + xx + j - r];
      a[yy * PW + xx] = s;
      qsum += s * s;
      ssum += s;
    }
  }
  const float2 qs = block_sum2(qsum, ssum, red);  // its barriers order a
  const float Q = qs.x;
  const float S = qs.y;
  if (threadIdx.x == 0) {
    const float sf = S / FP;
    loss[q] = -(Q / FP - sf * sf);
  }
  if (!with_grad) return;

  // 4. gradient: g = cA * iwe + cB over the whole patch (the IWE is zero
  // outside the widened box), blurred back by the flipped taps at the
  // splat's box: columns into b, rows into a (G)
  const float cA = -2.0f / FP;
  const float cB = 2.0f * S / (FP * FP);
  {
    const int w_ = rx1 - rx0;
    const int n = (by1 - by0) * w_;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int yy = by0 + i / w_;
      const int xx = rx0 + i % w_;
      const int j0 = max(0, r - yy);
      const int j1 = min(ntaps, PH - yy + r);
      float s = 0.0f;
      for (int j = j0; j < j1; ++j)
        s += k[ntaps - 1 - j] * (cA * a[(yy + j - r) * PW + xx] + cB);
      b[yy * PW + xx] = s;
    }
  }
  __syncthreads();
  {
    const int w_ = bx1 - bx0;
    const int n = (by1 - by0) * w_;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int yy = by0 + i / w_;
      const int xx = bx0 + i % w_;
      const int j0 = max(0, r - xx);
      const int j1 = min(ntaps, PW - xx + r);
      float s = 0.0f;
      for (int j = j0; j < j1; ++j)
        s += k[ntaps - 1 - j] * b[yy * PW + xx + j - r];
      a[yy * PW + xx] = s;
    }
  }
  __syncthreads();

  // the bilinear fractions' derivatives against G, times -dt
  float gvx = 0.0f, gvy = 0.0f;
  for (long long i = threadIdx.x; i < C; i += kThreads) {
    float px, py, w, dt;
    if (!place(xq, yq, tq, pq, mq, i, t0, vx, vy, offx, offy, fH, fW, px, py,
               w, dt))
      continue;
    const float x0 = floorf(px);
    const float y0 = floorf(py);
    const float dx = px - x0;
    const float dy = py - y0;
    const float* g = a + static_cast<int>(y0) * PW + static_cast<int>(x0);
    const float g00 = g[0], g01 = g[1], g10 = g[PW], g11 = g[PW + 1];
    const float gx = w * ((1.0f - dy) * (g01 - g00) + dy * (g11 - g10));
    const float gy = w * ((1.0f - dx) * (g10 - g00) + dx * (g11 - g01));
    gvx -= gx * dt;
    gvy -= gy * dt;
  }
  const float2 gv = block_sum2(gvx, gvy, red);
  if (threadIdx.x == 0) {
    grad[2 * q] = gv.x;
    grad[2 * q + 1] = gv.y;
  }
}

}  // namespace

extern "C" {

// x, y, t, p, mask: (R, C) f32; origin, params: (R, 2) f32; taps: 2r + 1
// f32; loss (R,) and, with with_grad, grad (R, 2) f32, written whole. All
// on one card, contiguous. half_rh, half_rw: half the ROI's height and
// width; FP: the full frame's pixel count.
int patch_variance_vg(const void* x, const void* y, const void* t,
                      const void* p, const void* mask, const void* origin,
                      const void* params, const void* taps, long long R,
                      long long C, int r, int PH, int PW, float half_rh,
                      float half_rw, float FP, int with_grad, void* loss,
                      void* grad, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      patch_variance_vg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSharedBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long bytes = shared_bytes(PH, PW, r);
  if (r < 0 || PH < 2 || PW < 2 || bytes > kMaxSharedBytes || R > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R > 0) {
    patch_variance_vg_kernel<<<static_cast<unsigned int>(R), kThreads,
                               static_cast<size_t>(bytes),
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(t), static_cast<const float*>(p),
        static_cast<const float*>(mask), static_cast<const float*>(origin),
        static_cast<const float*>(params), static_cast<const float*>(taps), C,
        r, PH, PW, half_rh, half_rw, FP, with_grad,
        static_cast<float*>(loss), static_cast<float*>(grad));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
