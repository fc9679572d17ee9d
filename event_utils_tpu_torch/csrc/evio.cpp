// evio — native host-side event-ingest runtime.
//
// The TPU compute path is JAX/XLA/Pallas; this library is the CPU runtime
// that keeps the chip fed: windowed batch assembly from memory-mapped event
// files into the fixed-capacity padded layout XLA consumes, without Python
// per-event loops. Exposed through ctypes (event_utils_tpu/native/__init__.py).
//
// Functions are plain-C ABI, operate on caller-owned buffers (numpy arrays /
// np.memmap views), and use std::thread for parallel window assembly.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

#if defined(__AVX2__)
// Interleave 4 (x,y) f32 pairs with 4 (t,p) f32 pairs into the
// (x, y, t, p) * 4 output layout, treating each pair as one f64 lane:
//   unpacklo/hi_pd give (XY0 TP0 XY2 TP2) / (XY1 TP1 XY3 TP3);
//   permute2f128 restores event order. 64 bytes stored per call.
inline void store4_events(float* dst, __m256 xyv, __m128 t4, __m128 p4) {
    const __m128 tp_lo = _mm_unpacklo_ps(t4, p4);  // t0 p0 t1 p1
    const __m128 tp_hi = _mm_unpackhi_ps(t4, p4);  // t2 p2 t3 p3
    const __m256 tpv = _mm256_set_m128(tp_hi, tp_lo);
    const __m256d a = _mm256_castps_pd(xyv);
    const __m256d b = _mm256_castps_pd(tpv);
    const __m256d lo = _mm256_unpacklo_pd(a, b);   // XY0 TP0 XY2 TP2
    const __m256d hi = _mm256_unpackhi_pd(a, b);   // XY1 TP1 XY3 TP3
    _mm256_storeu_pd(reinterpret_cast<double*>(dst),
                     _mm256_permute2f128_pd(lo, hi, 0x20));
    _mm256_storeu_pd(reinterpret_cast<double*>(dst + 8),
                     _mm256_permute2f128_pd(lo, hi, 0x31));
}

// +-1 polarity floats from 8 uint8 flags.
inline __m256 polarity8(const uint8_t* p) {
    const __m256i pi = _mm256_cvtepu8_epi32(
        _mm_loadl_epi64(reinterpret_cast<const __m128i*>(p)));
    const __m256 sel = _mm256_castsi256_ps(
        _mm256_cmpgt_epi32(pi, _mm256_setzero_si256()));
    return _mm256_blendv_ps(_mm256_set1_ps(-1.0f), _mm256_set1_ps(1.0f), sel);
}

// window-relative f32 timestamps from 8 f64.
inline __m256 reltime8(const double* t, double t_base) {
    const __m256d base = _mm256_set1_pd(t_base);
    const __m128 lo = _mm256_cvtpd_ps(
        _mm256_sub_pd(_mm256_loadu_pd(t), base));
    const __m128 hi = _mm256_cvtpd_ps(
        _mm256_sub_pd(_mm256_loadu_pd(t + 4), base));
    return _mm256_set_m128(hi, lo);
}
#endif  // __AVX2__

}  // namespace

extern "C" {

// Binary search over a sorted float64 array (the on-disk timestamp layout).
// side = 0: leftmost insertion point; side = 1: rightmost.
long evio_searchsorted_f64(const double* ts, long n, double x, int side) {
    if (side == 0) {
        return std::lower_bound(ts, ts + n, x) - ts;
    }
    return std::upper_bound(ts, ts + n, x) - ts;
}

// Vectorized search: m queries into one sorted array.
void evio_searchsorted_f64_batch(const double* ts, long n, const double* xs,
                                 long m, int side, long* out) {
    for (long i = 0; i < m; ++i) {
        out[i] = evio_searchsorted_f64(ts, n, xs[i], side);
    }
}

// Window index tables ------------------------------------------------------

// Fixed-count windows with overlap: idx[i] = (i*stride, i*stride + k).
long evio_k_event_windows(long num_events, long k, long overlap,
                          long* idx0, long* idx1, long max_windows) {
    const long stride = k - overlap;
    if (stride <= 0) return 0;
    long count = 0;
    for (long s = 0; s + k <= num_events && count < max_windows; s += stride) {
        idx0[count] = s;
        idx1[count] = s + k;
        ++count;
    }
    return count;
}

// Fixed-duration windows with overlap over a sorted timestamp array.
long evio_t_second_windows(const double* ts, long n, double t_width,
                           double overlap, long* idx0, long* idx1,
                           long max_windows) {
    if (n == 0 || t_width <= overlap) return 0;
    const double stride = t_width - overlap;
    const double t0 = ts[0];
    const double tk = ts[n - 1];
    long count = 0;
    for (double s = t0; s + t_width <= tk + 1e-12 && count < max_windows;
         s += stride) {
        idx0[count] = evio_searchsorted_f64(ts, n, s, 0);
        idx1[count] = evio_searchsorted_f64(ts, n, s + t_width, 0);
        ++count;
    }
    return count;
}

// Padded batch assembly ----------------------------------------------------
//
// Fill (nwin, capacity, 4) float32 events + (nwin, capacity) float32 masks
// from the RPG memmap component layout: t float64 (n), xy int16 (n, 2),
// p uint8 (n). Polarity maps {0,1} -> {-1,+1}; timestamps are shifted to
// window-relative (t - t_first) when relative_time != 0 so float32 keeps
// precision on long recordings. Windows overflowing capacity are truncated
// (truncation count returned).
long evio_fill_padded_batches(const double* t, const int16_t* xy,
                              const uint8_t* p, long num_events,
                              const long* idx0, const long* idx1, long nwin,
                              long capacity, int relative_time,
                              float* out_events, float* out_mask,
                              int nthreads) {
    std::atomic<long> truncated{0};
    if (nthreads <= 0) nthreads = 1;

    auto work = [&](long w_begin, long w_end) {
        for (long w = w_begin; w < w_end; ++w) {
            long s = idx0[w];
            long e = idx1[w];
            if (s < 0) s = 0;
            if (e > num_events) e = num_events;
            long count = e - s;
            if (count < 0) count = 0;  // inverted window: emit all-pad
            if (count > capacity) {
                truncated.fetch_add(count - capacity,
                                    std::memory_order_relaxed);
                count = capacity;
            }
            float* ev = out_events + w * capacity * 4;
            float* mk = out_mask + w * capacity;
            const double t_base = (relative_time && count > 0) ? t[s] : 0.0;
            long i = 0;
#if defined(__AVX2__)
            for (; i + 8 <= count; i += 8) {
                const long src = s + i;
                // 16 int16 = 8 interleaved (x, y) pairs -> 8 f32 pairs
                const __m256i xy01 = _mm256_cvtepi16_epi32(_mm_loadu_si128(
                    reinterpret_cast<const __m128i*>(xy + src * 2)));
                const __m256i xy23 = _mm256_cvtepi16_epi32(_mm_loadu_si128(
                    reinterpret_cast<const __m128i*>(xy + src * 2 + 8)));
                const __m256 t8 = reltime8(t + src, t_base);
                const __m256 p8 = polarity8(p + src);
                store4_events(ev + i * 4, _mm256_cvtepi32_ps(xy01),
                              _mm256_castps256_ps128(t8),
                              _mm256_castps256_ps128(p8));
                store4_events(ev + i * 4 + 16, _mm256_cvtepi32_ps(xy23),
                              _mm256_extractf128_ps(t8, 1),
                              _mm256_extractf128_ps(p8, 1));
                _mm256_storeu_ps(mk + i, _mm256_set1_ps(1.0f));
            }
#endif
            for (; i < count; ++i) {
                const long src = s + i;
                ev[i * 4 + 0] = static_cast<float>(xy[src * 2 + 0]);
                ev[i * 4 + 1] = static_cast<float>(xy[src * 2 + 1]);
                ev[i * 4 + 2] = static_cast<float>(t[src] - t_base);
                ev[i * 4 + 3] = p[src] ? 1.0f : -1.0f;
                mk[i] = 1.0f;
            }
            // pad: zero events, repeat last timestamp to keep sorts stable
            const float t_last = count > 0 ? ev[(count - 1) * 4 + 2] : 0.0f;
            for (long j = count; j < capacity; ++j) {
                ev[j * 4 + 0] = 0.0f;
                ev[j * 4 + 1] = 0.0f;
                ev[j * 4 + 2] = t_last;
                ev[j * 4 + 3] = 0.0f;
                mk[j] = 0.0f;
            }
        }
    };

    if (nthreads == 1 || nwin < 2) {
        work(0, nwin);
    } else {
        std::vector<std::thread> pool;
        const long per = (nwin + nthreads - 1) / nthreads;
        for (int th = 0; th < nthreads; ++th) {
            const long b = th * per;
            const long e = std::min(nwin, b + per);
            if (b >= e) break;
            pool.emplace_back(work, b, e);
        }
        for (auto& th : pool) th.join();
    }
    return truncated.load();
}

// Component-array variant (HDF5-style separate xs/ys arrays, any int type
// pre-converted to int32 by the caller).
long evio_fill_padded_batches_components(
    const double* t, const int32_t* xs, const int32_t* ys, const uint8_t* p,
    long num_events, const long* idx0, const long* idx1, long nwin,
    long capacity, int relative_time, float* out_events, float* out_mask,
    int nthreads) {
    std::atomic<long> truncated{0};
    if (nthreads <= 0) nthreads = 1;

    auto work = [&](long w_begin, long w_end) {
        for (long w = w_begin; w < w_end; ++w) {
            long s = idx0[w];
            long e = idx1[w];
            if (s < 0) s = 0;
            if (e > num_events) e = num_events;
            long count = e - s;
            if (count < 0) count = 0;  // inverted window: emit all-pad
            if (count > capacity) {
                truncated.fetch_add(count - capacity,
                                    std::memory_order_relaxed);
                count = capacity;
            }
            float* ev = out_events + w * capacity * 4;
            float* mk = out_mask + w * capacity;
            const double t_base = (relative_time && count > 0) ? t[s] : 0.0;
            long i = 0;
#if defined(__AVX2__)
            for (; i + 8 <= count; i += 8) {
                const long src = s + i;
                const __m256 xv = _mm256_cvtepi32_ps(_mm256_loadu_si256(
                    reinterpret_cast<const __m256i*>(xs + src)));
                const __m256 yv = _mm256_cvtepi32_ps(_mm256_loadu_si256(
                    reinterpret_cast<const __m256i*>(ys + src)));
                // interleave x/y into (x, y) pairs per 128-bit half
                const __m128 xy_a = _mm_unpacklo_ps(
                    _mm256_castps256_ps128(xv), _mm256_castps256_ps128(yv));
                const __m128 xy_b = _mm_unpackhi_ps(
                    _mm256_castps256_ps128(xv), _mm256_castps256_ps128(yv));
                const __m128 xy_c = _mm_unpacklo_ps(
                    _mm256_extractf128_ps(xv, 1), _mm256_extractf128_ps(yv, 1));
                const __m128 xy_d = _mm_unpackhi_ps(
                    _mm256_extractf128_ps(xv, 1), _mm256_extractf128_ps(yv, 1));
                const __m256 t8 = reltime8(t + src, t_base);
                const __m256 p8 = polarity8(p + src);
                store4_events(ev + i * 4, _mm256_set_m128(xy_b, xy_a),
                              _mm256_castps256_ps128(t8),
                              _mm256_castps256_ps128(p8));
                store4_events(ev + i * 4 + 16, _mm256_set_m128(xy_d, xy_c),
                              _mm256_extractf128_ps(t8, 1),
                              _mm256_extractf128_ps(p8, 1));
                _mm256_storeu_ps(mk + i, _mm256_set1_ps(1.0f));
            }
#endif
            for (; i < count; ++i) {
                const long src = s + i;
                ev[i * 4 + 0] = static_cast<float>(xs[src]);
                ev[i * 4 + 1] = static_cast<float>(ys[src]);
                ev[i * 4 + 2] = static_cast<float>(t[src] - t_base);
                ev[i * 4 + 3] = p[src] ? 1.0f : -1.0f;
                mk[i] = 1.0f;
            }
            const float t_last = count > 0 ? ev[(count - 1) * 4 + 2] : 0.0f;
            for (long j = count; j < capacity; ++j) {
                ev[j * 4 + 0] = 0.0f;
                ev[j * 4 + 1] = 0.0f;
                ev[j * 4 + 2] = t_last;
                ev[j * 4 + 3] = 0.0f;
                mk[j] = 0.0f;
            }
        }
    };

    if (nthreads == 1 || nwin < 2) {
        work(0, nwin);
    } else {
        std::vector<std::thread> pool;
        const long per = (nwin + nthreads - 1) / nthreads;
        for (int th = 0; th < nthreads; ++th) {
            const long b = th * per;
            const long e = std::min(nwin, b + per);
            if (b >= e) break;
            pool.emplace_back(work, b, e);
        }
        for (auto& th : pool) th.join();
    }
    return truncated.load();
}

// ROI bucketing: per-event ROI ids + per-ROI counts (host side of
// grid_cmax batching). rid = min(y/rh, ny-1)*nx + min(x/rw, nx-1).
void evio_roi_ids(const int32_t* xs, const int32_t* ys, long n, int rh,
                  int rw, int ny, int nx, int32_t* rid, int64_t* counts) {
    std::memset(counts, 0, sizeof(int64_t) * (size_t)(ny * nx));
    for (long i = 0; i < n; ++i) {
        int by = ys[i] / rh;
        int bx = xs[i] / rw;
        if (by >= ny) by = ny - 1;
        if (bx >= nx) bx = nx - 1;
        const int id = by * nx + bx;
        rid[i] = id;
        ++counts[id];
    }
}

// Counting-sort bucket fill: scatter events into fixed-capacity padded
// per-bucket arrays in ONE O(n) pass (no comparison sort), preserving the
// input (time) order within each bucket. Events beyond a bucket's capacity
// are dropped (truncation count returned); callers that need uniform
// subsampling instead size capacity >= max count or use the numpy path.
// Outputs are (R, capacity) float32, zero-padded, plus the validity mask.
long evio_bucket_fill(const double* xs, const double* ys, const double* ts,
                      const double* ps, long n, int rh, int rw, int ny,
                      int nx, long capacity, float* bx, float* by, float* bt,
                      float* bp, float* bmask) {
    const long R = (long)ny * nx;
    std::vector<long> fill((size_t)R, 0);
    std::memset(bx, 0, sizeof(float) * (size_t)(R * capacity));
    std::memset(by, 0, sizeof(float) * (size_t)(R * capacity));
    std::memset(bt, 0, sizeof(float) * (size_t)(R * capacity));
    std::memset(bp, 0, sizeof(float) * (size_t)(R * capacity));
    std::memset(bmask, 0, sizeof(float) * (size_t)(R * capacity));
    long truncated = 0;
    for (long i = 0; i < n; ++i) {
        int iy = (int)(ys[i]) / rh;
        int ix = (int)(xs[i]) / rw;
        if (iy >= ny) iy = ny - 1;
        if (ix >= nx) ix = nx - 1;
        if (iy < 0) iy = 0;
        if (ix < 0) ix = 0;
        const long r = (long)iy * nx + ix;
        const long pos = fill[(size_t)r];
        if (pos >= capacity) {
            ++truncated;
            continue;
        }
        const long o = r * capacity + pos;
        bx[o] = (float)xs[i];
        by[o] = (float)ys[i];
        bt[o] = (float)ts[i];
        bp[o] = (float)ps[i];
        bmask[o] = 1.0f;
        fill[(size_t)r] = pos + 1;
    }
    return truncated;
}

}  // extern "C"
