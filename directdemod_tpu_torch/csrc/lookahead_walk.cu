// K2: the lookahead peak walk (billauer's alternating max/min detector with
// lookahead confirmation) over precomputed forward-window extrema.
//
// Replaces the TPU kernel directdemod_tpu/ops/peaks.py::_pk_kernel (wrapper
// _lookahead_events_pallas) and the lax.scan it stood in for,
// directdemod_tpu/ops/peaks.py::_lookahead_scan. For i < limit, with state
// (mx, mn, mxpos, mnpos) starting at (-inf, +inf, 0, 0):
//
//     if y[i] > mx: mx, mxpos = y[i], i
//     if y[i] < mn: mn, mnpos = y[i], i
//     fire_max = y[i] < mx - delta && isfinite(mx) && fmax[i] < mx
//     fire_min = !fire_max && y[i] > mn + delta && isfinite(mn) && fmin[i] > mn
//     a max fire appends (i, mxpos, mx, 1) and sets mx = mn = +inf;
//     a min fire appends (i, mnpos, mn, 0) and sets mx = mn = -inf.
//
// Events go out in index order with their count. With delta >= 0 no fire
// follows a fire at the next index, so limit / 2 + 2 slots always suffice
// (the wrapper allocates that many; there is no cap and no overflow).
//
// What bounds it on an H100: every step depends on the state the previous
// step left, so the walk is one chain of dependent compares and selects on
// one thread; neither memory bandwidth nor the card's width matters. The
// design is the simple one: a single block of 256 threads. Warp 0's lane 0
// walks a tile of y, fmax and fmin held in shared memory, the state in
// registers, while warps 1-7 stage the next tile into the other half of a
// double buffer, so the walker never waits on device memory. The TPU kernel's
// per-chunk event slots and the XLA compaction after it are gone: the one
// walker appends straight to the global event buffer.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE = 4096;     // samples per staged tile
constexpr int THREADS = 256;

__device__ __forceinline__ void stage(float* dst, const float* __restrict__ y,
                                      const float* __restrict__ fmax,
                                      const float* __restrict__ fmin,
                                      long long base, int len, int first, int step) {
  for (int i = first; i < len; i += step) {
    dst[i] = y[base + i];
    dst[TILE + i] = fmax[base + i];
    dst[2 * TILE + i] = fmin[base + i];
  }
}

__global__ void __launch_bounds__(THREADS)
lookahead_walk_kernel(const float* __restrict__ y, const float* __restrict__ fmax,
                      const float* __restrict__ fmin, long long limit, float delta,
                      long long* __restrict__ ev_idx, long long* __restrict__ ev_pos,
                      float* __restrict__ ev_val, uint8_t* __restrict__ ev_is_max,
                      long long* __restrict__ count) {
  extern __shared__ float smem[];   // two buffers of [y | fmax | fmin] tiles
  const int tid = threadIdx.x;
  const long long tiles = (limit + TILE - 1) / TILE;
  if (tiles > 0) stage(smem, y, fmax, fmin, 0, (int)min((long long)TILE, limit), tid, THREADS);
  __syncthreads();

  float mx = -CUDART_INF_F, mn = CUDART_INF_F;
  long long mxpos = 0, mnpos = 0, cnt = 0;
  for (long long t = 0; t < tiles; ++t) {
    const float* cur = smem + (t & 1) * 3 * TILE;
    const long long base = t * TILE;
    if (tid == 0) {
      const int len = (int)min((long long)TILE, limit - base);
      for (int i = 0; i < len; ++i) {
        const float yi = cur[i];
        const float fx = cur[TILE + i];
        const float fn = cur[2 * TILE + i];
        const long long gi = base + i;
        if (yi > mx) { mx = yi; mxpos = gi; }
        if (yi < mn) { mn = yi; mnpos = gi; }
        const bool fire_max = (yi < mx - delta) && isfinite(mx) && (fx < mx);
        const bool fire_min = !fire_max && (yi > mn + delta) && isfinite(mn) && (fn > mn);
        if (fire_max || fire_min) {
          ev_idx[cnt] = gi;
          ev_pos[cnt] = fire_max ? mxpos : mnpos;
          ev_val[cnt] = fire_max ? mx : mn;
          ev_is_max[cnt] = fire_max ? 1 : 0;
          ++cnt;
          mx = mn = fire_max ? CUDART_INF_F : -CUDART_INF_F;
        }
      }
    } else if (tid >= 32 && t + 1 < tiles) {
      const long long next = base + TILE;
      stage(smem + ((t + 1) & 1) * 3 * TILE, y, fmax, fmin, next,
            (int)min((long long)TILE, limit - next), tid - 32, THREADS - 32);
    }
    __syncthreads();
  }
  if (tid == 0) *count = cnt;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns a cudaError_t (0 = ok).
// y, fmax, fmin: `limit` float32 each on the device; ev_idx, ev_pos: int64,
// ev_val: float32, ev_is_max: uint8, each with room for limit / 2 + 2
// events; count: one int64. Launches on `stream` and does not synchronise.
extern "C" int lookahead_walk_launch(const void* y, const void* fmax, const void* fmin,
                                     long long limit, float delta, void* ev_idx,
                                     void* ev_pos, void* ev_val, void* ev_is_max,
                                     void* count, int device, void* stream) {
  if (limit < 0 || !(delta >= 0.f)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * 2 * 3 * TILE;
  err = cudaFuncSetAttribute(lookahead_walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lookahead_walk_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)fmax, (const float*)fmin, limit, delta,
      (long long*)ev_idx, (long long*)ev_pos, (float*)ev_val, (uint8_t*)ev_is_max,
      (long long*)count);
  return (int)cudaGetLastError();
}
