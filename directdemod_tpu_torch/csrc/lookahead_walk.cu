// K2: the lookahead peak walk (billauer's alternating max/min detector with
// lookahead confirmation) over precomputed forward-window extrema, as a
// chunk-speculative walk.
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
// follows a fire at the next index, so limit / 2 + 2 slots always suffice.
//
// What bounds it on an H100: the walk is a recurrence, one chain of
// dependent compares and selects a sample; on one thread that chain is the
// whole time (61.6 ns a sample for a one-thread walk on an NVIDIA H100
// 80GB HBM3 at 700 W). But the chain restarts at
// every fire, to one of two fixed states: (+inf, +inf) after a max, (-inf,
// -inf) after a min (a position is stale only while its value is infinite,
// and then it is never emitted). And the decisions of a step read only the
// values (mx, mn), never the positions. So two walks over the same samples
// that fire the same kind of event at the same index, or that hold the same
// (mx, mn) after the same index, decide alike from there on. Three passes,
// all on the wrapper's stream:
//   1. speculative walks: [0, limit) is cut into chunks of L samples; chunk
//      0 is walked from the true initial state, every other chunk twice,
//      from the post-max and the post-min state, one thread a walk (the two
//      walks of a chunk on neighbouring lanes, which read the same lines).
//      Each writes its events (at most L / 2 + 2) into its own slice of a
//      scratch buffer, their count, its exit state, and its (mx, mn) after
//      every Q samples (a checkpoint);
//   2. stitch, one thread, in chunk order: the true state entering chunk c
//      is the exit state of chunk c-1's route. If it is a reset state, the
//      matching walk is chunk c's route from its start. Else the stitch
//      walks chunk c from it, writing its events straight to the output,
//      until it fires an event whose index and kind equal an event of one
//      of the two speculative walks, or until its (mx, mn) equal a walk's
//      at a checkpoint, bit for bit; from there on that walk is the route
//      (its later events, its exit state). Where the AFSK edge strength is
//      exactly zero, between frames, no walk fires, and the checkpoints are
//      what meets. A chunk where no walk meets is walked to its end: right,
//      only slower. It records the steps it walked a chunk;
//   3. gather: every chunk's adopted events are copied to their place in
//      the output, in parallel. After a checkpoint meeting, an adopted
//      event whose position the walk set before the meeting takes the true
//      walk's position there (its value is the same).
// The three kernels are named k2_speculative_walks, k2_stitch and k2_gather,
// names no library kernel holds, so a trace finds them by name alone.
// The step is the sequential walk's step (written without branches), so
// events equal the plain version's exactly. Time: L steps of one walker (pass 1, in
// parallel over 2 * limit / L walkers) plus, a chunk, the stitch's steps
// (at most Q + a few) and its dependent reads of the walks' records.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WALK_THREADS = 32;      // one warp a block: walkers spread over SMs
constexpr int GATHER_THREADS = 256;
constexpr int U = 8;                   // samples a walker loads ahead
constexpr int Q = 32;                  // samples between checkpoints (a multiple of U)

struct Walk {
  float mx, mn;
  long long mxpos, mnpos;
};

struct Args {
  const float* y;
  const float* fmax;
  const float* fmin;
  long long limit, chunk, n_chunks, cap;   // cap: event slots a walk
  float delta;
  // pass 1: per walk (2 a chunk) its events, their count and its exit state
  long long* sp_idx;
  long long* sp_pos;
  float* sp_val;
  uint8_t* sp_max;
  long long* sp_cnt;
  float* ex_val;                           // mx, mn
  long long* ex_pos;                       // mxpos, mnpos
  float* cp;                               // (mx, mn) every Q samples, cpc a walk
  long long cpc;
  // pass 2: per chunk (adopted walk or -1, its first event, output offset,
  // events, the checkpoint index it met at or -1, the true mxpos and mnpos
  // there) and the samples the stitch walked
  long long* rec;
  long long* steps;
  long long* ev_idx;
  long long* ev_pos;
  float* ev_val;
  uint8_t* ev_is_max;
  long long* count;
};

// One step of the walk at index i, without a branch: 1 for a max fire, 0
// for a min fire, -1 for none; pos and val get what a fire would emit.
// isfinite(mx) is mx != +inf here: with mx = -inf the test y < mx - delta
// already fails (and isfinite(mn) is mn != -inf alike). A max fire wins
// over a min fire, so the new state is two selects deep: the chain a step
// is a compare and select for the extreme, the threshold compare and two
// selects.
__device__ __forceinline__ int step(Walk& w, float yi, float fx, float fn, long long i,
                                    float delta, long long& pos, float& val) {
  const bool up = yi > w.mx, down = yi < w.mn;
  const float mx = up ? yi : w.mx, mn = down ? yi : w.mn;
  w.mxpos = up ? i : w.mxpos;
  w.mnpos = down ? i : w.mnpos;
  const bool fire_max = (fx < mx) & (mx != CUDART_INF_F) & (yi < mx - delta);
  const bool fire_min = (fn > mn) & (mn != -CUDART_INF_F) & (yi > mn + delta);
  pos = fire_max ? w.mxpos : w.mnpos;
  val = fire_max ? mx : mn;
  const float kx = fire_min ? -CUDART_INF_F : mx, kn = fire_min ? -CUDART_INF_F : mn;
  w.mx = fire_max ? CUDART_INF_F : kx;
  w.mn = fire_max ? CUDART_INF_F : kn;
  return fire_max ? 1 : (fire_min ? 0 : -1);
}

// Write an event at slot k of the four arrays. A walk writes its next slot
// every step and moves on only where it fired, so a step has no branch.
__device__ __forceinline__ void put(long long* idx, long long* pos, float* val,
                                    uint8_t* is_max, long long k, long long i,
                                    long long p, float v, int kind) {
  idx[k] = i;
  pos[k] = p;
  val[k] = v;
  is_max[k] = (uint8_t)kind;
}

// Pass 1: walk t covers chunk t / 2; walk 2c starts from the post-max state
// (chunk 0: the true initial state), walk 2c + 1 from the post-min state.
__global__ void __launch_bounds__(WALK_THREADS) k2_speculative_walks(Args g) {
  const long long t = (long long)blockIdx.x * WALK_THREADS + threadIdx.x;
  if (t >= 2 * g.n_chunks) return;
  const long long c = t >> 1;
  const bool post_min = t & 1;
  if (c == 0 && post_min) {               // chunk 0 needs one walk
    g.sp_cnt[t] = 0;
    return;
  }
  Walk w;
  w.mx = c == 0 ? -CUDART_INF_F : (post_min ? -CUDART_INF_F : CUDART_INF_F);
  w.mn = c == 0 ? CUDART_INF_F : w.mx;
  w.mxpos = w.mnpos = 0;
  const long long lo = c * g.chunk, hi = min(g.limit, lo + g.chunk);
  const long long base = t * g.cap;
  const float delta = g.delta;
  long long cnt = 0;
  // the next U samples are loaded into registers while the current U are
  // walked; whole groups first, then the ragged end
  float ya[U], xa[U], na[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (lo + u < hi) { ya[u] = g.y[lo + u]; xa[u] = g.fmax[lo + u]; na[u] = g.fmin[lo + u]; }
  long long i = lo;
  for (; i + U <= hi; i += U) {
    float yb[U], xb[U], nb[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + U + u < hi) {
        yb[u] = g.y[i + U + u]; xb[u] = g.fmax[i + U + u]; nb[u] = g.fmin[i + U + u];
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      long long pos;
      float val;
      const int k = step(w, ya[u], xa[u], na[u], i + u, delta, pos, val);
      put(g.sp_idx, g.sp_pos, g.sp_val, g.sp_max, base + cnt, i + u, pos, val, k);
      cnt += k >= 0;
      ya[u] = yb[u]; xa[u] = xb[u]; na[u] = nb[u];
    }
    if ((i + U - lo) % Q == 0) {          // checkpoint after index i + U - 1
      float* cp = g.cp + 2 * (t * g.cpc + (i + U - lo) / Q - 1);
      cp[0] = w.mx;
      cp[1] = w.mn;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (i + u < hi) {
      long long pos;
      float val;
      const int k = step(w, ya[u], xa[u], na[u], i + u, delta, pos, val);
      put(g.sp_idx, g.sp_pos, g.sp_val, g.sp_max, base + cnt, i + u, pos, val, k);
      cnt += k >= 0;
    }
  g.sp_cnt[t] = cnt;
  g.ex_val[2 * t] = w.mx;
  g.ex_val[2 * t + 1] = w.mn;
  g.ex_pos[2 * t] = w.mxpos;
  g.ex_pos[2 * t + 1] = w.mnpos;
}

// Pass 2: one thread resolves the chunks in order.
__global__ void k2_stitch(Args g) {
  if (threadIdx.x != 0) return;
  Walk w{-CUDART_INF_F, CUDART_INF_F, 0, 0};
  const float delta = g.delta;
  long long out = 0;
  for (long long c = 0; c < g.n_chunks; ++c) {
    const long long lo = c * g.chunk, hi = min(g.limit, lo + g.chunk);
    long long src = -1, from = 0, walked = 0, meet = -1, fix_mx = 0, fix_mn = 0;
    if (c == 0) src = 0;                  // walk 0 started from the true state
    else if (w.mx == CUDART_INF_F && w.mn == CUDART_INF_F) src = 2 * c;
    else if (w.mx == -CUDART_INF_F && w.mn == -CUDART_INF_F) src = 2 * c + 1;
    else {
      const long long b0 = 2 * c * g.cap, b1 = b0 + g.cap;
      const long long n0 = g.sp_cnt[2 * c], n1 = g.sp_cnt[2 * c + 1];
      long long p0 = 0, p1 = 0;
      // one step of the stitch; after the meeting step the state is
      // replaced by the adopted walk's, and nothing more is kept
      auto visit = [&](long long i, float yi, float fx, float fn) {
        const bool live = src < 0;
        long long pos;
        float val;
        const int k = step(w, yi, fx, fn, i, delta, pos, val);
        put(g.ev_idx, g.ev_pos, g.ev_val, g.ev_is_max, out, i, pos, val, k);
        walked += live;
        if (live & (k >= 0)) {
          ++out;
          while (p0 < n0 && g.sp_idx[b0 + p0] < i) ++p0;
          while (p1 < n1 && g.sp_idx[b1 + p1] < i) ++p1;
          if (p0 < n0 && g.sp_idx[b0 + p0] == i && g.sp_max[b0 + p0] == k) {
            src = 2 * c;
            from = p0 + 1;
          } else if (p1 < n1 && g.sp_idx[b1 + p1] == i && g.sp_max[b1 + p1] == k) {
            src = 2 * c + 1;
            from = p1 + 1;
          }
        }
      };
      float ya[U], xa[U], na[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (lo + u < hi) { ya[u] = g.y[lo + u]; xa[u] = g.fmax[lo + u]; na[u] = g.fmin[lo + u]; }
      long long i0 = lo;
      for (; i0 + U <= hi && src < 0; i0 += U) {
        float yb[U], xb[U], nb[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (i0 + U + u < hi) {
            yb[u] = g.y[i0 + U + u]; xb[u] = g.fmax[i0 + U + u]; nb[u] = g.fmin[i0 + U + u];
          }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          visit(i0 + u, ya[u], xa[u], na[u]);
          ya[u] = yb[u]; xa[u] = xb[u]; na[u] = nb[u];
        }
        if (src < 0 && (i0 + U - lo) % Q == 0) {
          // a checkpoint: (mx, mn) equal to a walk's there, bit for bit,
          // take every later decision as that walk does
          const long long j = (i0 + U - lo) / Q - 1, m = i0 + U - 1;
          const unsigned bx = __float_as_uint(w.mx), bn = __float_as_uint(w.mn);
          const float* c0 = g.cp + 2 * (2 * c * g.cpc + j);
          const float* c1 = g.cp + 2 * ((2 * c + 1) * g.cpc + j);
          long long v = -1;
          if (__float_as_uint(c0[0]) == bx && __float_as_uint(c0[1]) == bn) v = 0;
          else if (__float_as_uint(c1[0]) == bx && __float_as_uint(c1[1]) == bn) v = 1;
          if (v >= 0) {
            long long p = v == 0 ? p0 : p1;
            const long long b = v == 0 ? b0 : b1, nv = v == 0 ? n0 : n1;
            while (p < nv && g.sp_idx[b + p] <= m) ++p;
            src = 2 * c + v;
            from = p;
            meet = m;
            fix_mx = w.mxpos;
            fix_mn = w.mnpos;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (src < 0 && i0 + u < hi) visit(i0 + u, ya[u], xa[u], na[u]);
    }
    long long n = 0;
    if (src >= 0) {
      n = g.sp_cnt[src] - from;
      w.mx = g.ex_val[2 * src];
      w.mn = g.ex_val[2 * src + 1];
      // a position the walk set before a checkpoint meeting is the true walk's
      const long long px = g.ex_pos[2 * src], pn = g.ex_pos[2 * src + 1];
      w.mxpos = px <= meet ? fix_mx : px;
      w.mnpos = pn <= meet ? fix_mn : pn;
    }
    long long* r = g.rec + 7 * c;
    r[0] = src;
    r[1] = from;
    r[2] = out;
    r[3] = n;
    r[4] = meet;
    r[5] = fix_mx;
    r[6] = fix_mn;
    g.steps[c] = walked;
    out += n;
  }
  *g.count = out;
}

// Pass 3: block c copies chunk c's adopted events into the output, giving
// an event whose position was set before a checkpoint meeting the true
// walk's position.
__global__ void __launch_bounds__(GATHER_THREADS) k2_gather(Args g) {
  const long long* r = g.rec + 7 * (long long)blockIdx.x;
  const long long src = r[0], n = r[3], meet = r[4];
  if (src < 0) return;
  const long long s0 = src * g.cap + r[1], d0 = r[2];
  for (long long j = threadIdx.x; j < n; j += GATHER_THREADS) {
    const uint8_t is_max = g.sp_max[s0 + j];
    const long long pos = g.sp_pos[s0 + j];
    g.ev_idx[d0 + j] = g.sp_idx[s0 + j];
    g.ev_pos[d0 + j] = pos <= meet ? (is_max ? r[5] : r[6]) : pos;
    g.ev_val[d0 + j] = g.sp_val[s0 + j];
    g.ev_is_max[d0 + j] = is_max;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns a cudaError_t (0 = ok).
// y, fmax, fmin: `limit` float32 each on the device; chunk >= 1 samples a
// chunk, n_chunks = ceil(limit / chunk), walks = 2 * n_chunks, cap =
// chunk / 2 + 2; scratch: sp_idx, sp_pos (int64), sp_val (float32), sp_max
// (uint8), walks * cap each; sp_cnt (int64) walks; ex_val (float32) and
// ex_pos (int64) 2 * walks each; cp (float32) 2 * walks * max(1, chunk /
// 32); rec (int64) 7 * n_chunks; steps (int64) n_chunks. Output: ev_idx, ev_pos (int64), ev_val (float32), ev_is_max
// (uint8), each with room for limit / 2 + 2 events; count: one int64.
// Launches the three passes on `stream` and does not synchronise.
extern "C" int lookahead_walk_launch(const void* y, const void* fmax, const void* fmin,
                                     long long limit, float delta, long long chunk,
                                     void* sp_idx, void* sp_pos, void* sp_val,
                                     void* sp_max, void* sp_cnt, void* ex_val,
                                     void* ex_pos, void* cp, void* rec, void* steps,
                                     void* ev_idx,
                                     void* ev_pos, void* ev_val, void* ev_is_max,
                                     void* count, int device, void* stream) {
  if (limit < 0 || chunk < 1 || !(delta >= 0.f)) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (limit + chunk - 1) / chunk;
  if (n_chunks > 0x3fffffffLL) return (int)cudaErrorInvalidValue;   // grid sizes
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args g{(const float*)y, (const float*)fmax, (const float*)fmin, limit, chunk,
         n_chunks, chunk / 2 + 2, delta, (long long*)sp_idx, (long long*)sp_pos,
         (float*)sp_val, (uint8_t*)sp_max, (long long*)sp_cnt, (float*)ex_val,
         (long long*)ex_pos, (float*)cp, chunk < Q ? 1 : chunk / Q, (long long*)rec,
         (long long*)steps, (long long*)ev_idx, (long long*)ev_pos, (float*)ev_val, (uint8_t*)ev_is_max, (long long*)count};
  cudaStream_t s = (cudaStream_t)stream;
  if (n_chunks > 0) {
    const long long blocks = (2 * n_chunks + WALK_THREADS - 1) / WALK_THREADS;
    k2_speculative_walks<<<(unsigned)blocks, WALK_THREADS, 0, s>>>(g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  k2_stitch<<<1, 32, 0, s>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_chunks > 0) {
    k2_gather<<<(unsigned)n_chunks, GATHER_THREADS, 0, s>>>(g);
    err = cudaGetLastError();
  }
  return (int)err;
}
