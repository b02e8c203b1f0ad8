// The tile of the fused DDC + FM kernels K1 (ddc_fm_u8.cu, raw uint8 IQ)
// and K4 (ddc_fm_c64.cu, complex64 samples), which differ only in how a
// sample is staged. Window contract, per channel ch < C: output m covers
// samples x[m*J .. m*J+K),
//
//     c[ch][m]     = sum_n w[ch][n] x[m*J + n]     (w = reversed modulated taps)
//     audio[ch][m] = atan2(d), d = c[ch][m] * conj(c[ch][m-1]) * rot[ch],
//     c[ch][-1]    = c_prev[ch],  c_last[ch] = c[ch][out_len-1].
//
// A tile of T threads owns T-1 new outputs. Thread t computes c[m] for
// m = b*(T-1) - 1 + t, so thread 0 recomputes the output before the tile
// (the TPU kernels carried it across their sequential grid; tiles here run
// in any order) with the same per-output arithmetic as the tile that owns
// it: the discriminator sees c[m-1] exactly as it was written, and tile 0's
// thread 0 takes c_prev instead. The block stages the span of samples a
// tile's windows cover into shared memory as float2, the taps beside it,
// and each thread sums its window with fp32 FMAs in tap order. When the
// span does not fit the shared memory next to the taps, it is staged in
// passes; a thread's sums carry from pass to pass in shared memory in the
// same tap order, so the result does not depend on the number of passes.
// Sample offsets are 64-bit.
//
// What bounds the tile on an H100: the shared memory, 128 bytes a cycle an
// SM. Per tap a warp issues 4 FMAs a channel (one issue cycle of the SM's
// four schedulers), a broadcast load of the tap (one wavefront) and an
// 8-byte load of a sample a lane (two wavefronts when no two lanes meet in
// a bank); and a tile's staging waits a round trip to device memory. With
// the samples packed, lane t's window starts t*J words in, so even J puts
// lanes on the same banks (2-way at J = 34, 4-way at J = 68 and 92). The
// design:
//
// - skewed staging for even J: span sample s lies at xs[s + s/J], one
//   float2 of padding after every J samples, so neighbouring lanes' windows
//   start J+1 words apart, an odd stride, and meet no bank conflict. Windows
//   start at multiples of J within the span, so every lane meets the pads at
//   the same offsets: the taps are staged once in the same skew with a zero
//   tap at each pad, and the tap loop runs over L = K + (K-1)/J positions
//   with one index. fmaf(0, x, c) returns c exactly for finite x unless c is
//   -0, and a sum that starts at +0 never becomes -0, so every output keeps
//   the bits of the packed layout (about 4 more FMAs an output at J = 34).
//   Passes then hold a multiple of J samples so that the pads stay aligned.
//   Odd J has no conflict and keeps the packed layout (no pads, L = K);
// - for C <= 4 channels (the kernel templated on C) the C sums stay in
//   registers inside the tap loop: a lane loads each staged sample once per
//   tap and applies the C taps, broadcasts, to it (2 + C wavefronts a
//   warp-tap where a channel-outer loop takes 3 C). Each channel's FMA
//   sequence is the one-channel kernel's, so a bank's channel equals the
//   one-channel launch bit for bit. More channels loop over the channels
//   outside the tap loop (the general case of the same kernel);
// - staging by cp.async, device memory straight into shared memory with the
//   whole pass in flight and no register held (start_stage, finish_stage);
// - a persistent grid: as many blocks as the SMs hold, each walking tiles,
//   so a block stages the taps once, and the tiles of the other resident
//   blocks compute while one waits for its copies.
//
// The samples are the concatenation [head | x]: a stream's history (the
// n_head samples before the block) and the block, read through two
// pointers, so a stream never copies a block to put its history in front.
// A Src gives both: head(s) is head[s] for s < n_head, body(s) is x[s]. A
// pass that starts past the head copies from x asynchronously, with no
// choice to make; a pass that reaches into the head (with n_head <= K-1,
// only the first tile's) loads sample by sample, choosing its pointer.
#pragma once
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace ddc_tile {

constexpr int T_MAX = 128;   // threads per block; halved down to T_MIN
constexpr int T_MIN = 32;    // while the span does not fit
constexpr int CONV = 8;      // K1 samples a thread converts between meetings
constexpr int C_REG = 4;     // most channels whose sums stay in registers

struct Args {
  const float2* taps;        // C*K reversed modulated taps, channel-major
  int C, K, J;
  int L;                     // tap positions a channel: K + (K-1)/J skewed, else K
  long long out_len;
  const float2* rot;
  const float2* c_prev;
  float* audio;
  float2* c_last;
  int S;                     // span samples a pass (a multiple of J when skewed
                             // and staged in more than one pass)
  unsigned skew;             // 0: packed; else floor(2^32 / J) + 1, so that
                             // __umulhi(i, skew) == i / J for i < 2^16
};

// Position of span sample (or tap) i < 2^16 in the staged layout.
__device__ __forceinline__ int pos(int i, unsigned skew) {
  return i + (int)__umulhi((unsigned)i, skew);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Where a tile of T-1 new outputs lies. Its thread t computes c[m] for
// m = b0 - 1 + t, the first thread recomputing the output before the tile.
struct Tile {
  long long b0, m, m_first, m_end, s0, ns, base;
  bool mine;
  __device__ __forceinline__ Tile(long long tile, int T, int tid, int J, int K,
                                  long long out_len) {
    const long long tn = T - 1;
    b0 = tile * tn;                                   // first new output
    m = b0 - 1 + tid;                                 // this thread's c
    m_first = b0 > 0 ? b0 - 1 : 0;
    m_end = out_len < b0 + tn ? out_len : b0 + tn;
    mine = m >= 0 && m < m_end;
    s0 = m_first * J;                                 // first span sample
    ns = (m_end - 1 - m_first) * J + K;               // span length
    base = mine ? m * J - s0 : 0;                     // window in the span
  }
};

// Start staging span samples [first, first + len), sample i at xs[pos(i)]
// (xs holds `cap` positions). From the body it is asynchronous and holds no
// register: cp.async copies from device memory straight into shared
// memory, the whole pass in flight, as one commit group.
// - K4 (Src::kPairs false) copies each 8-byte sample to its place.
// - K1 (Src::kPairs true) copies 4-byte-aligned pairs of (I, Q) byte pairs
//   into the tail of the buffer, the first pair reaching back one sample
//   when the pass starts on an odd one; `finish_stage` converts them.
// A pass that reaches into the head (with n_head <= K-1, only the first
// tile's) loads and stores sample by sample, choosing its pointer.
template <typename Src>
__device__ __forceinline__ void start_stage(const Src& src, float2* xs, int cap,
                                            long long first, int len, int tid, int T,
                                            unsigned skew) {
  if (first < src.n_head) {
    for (int i = tid; i < len; i += T) {
      const long long s = first + i;
      xs[pos(i, skew)] = s < src.n_head ? src.head(s) : src.body(s - src.n_head);
    }
  } else if constexpr (!Src::kPairs) {
    const long long f = first - src.n_head;
    for (int i = tid; i < len; i += T) src.copy_async(xs + pos(i, skew), f + i);
  } else {
    const long long f = first - src.n_head;
    const int ph = src.pair_phase(f);            // f's place in its pair
    const int np = (len + ph + 1) / 2;           // pairs covering [f, f + len)
    char* bytes = reinterpret_cast<char*>(xs) + 8 * cap - 4 * np;
    for (int q = tid; q < np; q += T) src.copy_pair_async(bytes + 4 * q, f - ph + 2LL * q);
  }
  cp_async_commit();
}

// After the copies of `start_stage` are in and the block has met: K1
// converts its byte pairs to float2 in place, in ascending chunks of CONV*T
// samples. A chunk's float2s end below the bytes of every later sample (8
// bytes a position against 2 a sample), so a thread reads its chunk's
// bytes, the block meets, and it writes. The bytes overlay pads, which are
// zeroed again after. The caller meets the block before reading xs.
template <typename Src>
__device__ __forceinline__ void finish_stage(const Src& src, float2* xs, int cap,
                                             long long first, int len, int tid, int T,
                                             int J, unsigned skew) {
  if constexpr (Src::kPairs) {
    if (first < src.n_head) return;
    const int ph = src.pair_phase(first - src.n_head);
    const int np = (len + ph + 1) / 2;
    const uchar2* iq = reinterpret_cast<const uchar2*>(
        reinterpret_cast<const char*>(xs) + 8 * cap - 4 * np) + ph;   // sample i at iq[i]
    for (int i0 = 0; i0 < len; i0 += CONV * T) {
      float2 v[CONV];
#pragma unroll
      for (int u = 0; u < CONV; ++u) {
        const int i = i0 + tid + u * T;
        if (i < len) v[u] = Src::sample(iq[i]);
      }
      __syncthreads();           // every thread holds its samples of the chunk
#pragma unroll
      for (int u = 0; u < CONV; ++u) {
        const int i = i0 + tid + u * T;
        if (i < len) xs[pos(i, skew)] = v[u];
      }
    }
    if (skew) {
      for (int r = tid; r < (len - 1) / J; r += T) xs[r * (J + 1) + J] = make_float2(0.f, 0.f);
    }
  }
}

// Add the taps of this thread's window that fall in the pass [lo, lo + len)
// staged in xs to its sums in cs, in tap order.
template <int CT>
__device__ __forceinline__ void accumulate(const float2* xs, const float2* w, float2* cs,
                                           long long lo, int len, const Tile& t, int C,
                                           int K, int J, int L, int T, int tid,
                                           unsigned skew) {
  if (!t.mine) return;
  const int a = (int)(lo > t.base ? lo - t.base : 0);       // taps [a, e) in this pass
  const int e = (int)(lo + len - t.base < K ? lo + len - t.base : K);
  if (a >= e) return;
  const int pa = pos(a, skew), pe = pos(e - 1, skew) + 1;
  // base - lo is a multiple of J when skewed (lo is), so the window's row
  // offset times J + 1 puts tap position p on sample base + n
  const float2* xp = xs + (skew ? (t.base - lo) / J * (J + 1) : t.base - lo);
  if constexpr (CT > 0) {
    float2 c[CT];
#pragma unroll
    for (int ch = 0; ch < CT; ++ch) c[ch] = cs[ch * T + tid];
#pragma unroll 8
    for (int p = pa; p < pe; ++p) {
      const float2 q = xp[p];
#pragma unroll
      for (int ch = 0; ch < CT; ++ch) {
        const float2 v = w[ch * L + p];
        c[ch].x = fmaf(v.x, q.x, c[ch].x);
        c[ch].x = fmaf(-v.y, q.y, c[ch].x);
        c[ch].y = fmaf(v.x, q.y, c[ch].y);
        c[ch].y = fmaf(v.y, q.x, c[ch].y);
      }
    }
#pragma unroll
    for (int ch = 0; ch < CT; ++ch) cs[ch * T + tid] = c[ch];
  } else {
    for (int ch = 0; ch < C; ++ch) {
      const float2* wc = w + (size_t)ch * L;
      float2 c = cs[ch * T + tid];
#pragma unroll 8
      for (int p = pa; p < pe; ++p) {
        const float2 v = wc[p];
        const float2 q = xp[p];
        c.x = fmaf(v.x, q.x, c.x);
        c.x = fmaf(-v.y, q.y, c.x);
        c.y = fmaf(v.x, q.y, c.y);
        c.y = fmaf(v.y, q.x, c.y);
      }
      cs[ch * T + tid] = c;
    }
  }
}

// The kernel body: each block walks tiles blockIdx.x, + gridDim.x, ... (a
// grid of as many blocks as the SMs hold, which stage the taps once). A
// tile is staged whole when it fits, else pass by pass. Nothing carries
// from tile to tile, so the result does not depend on the grid.
template <int CT, typename Src>
__device__ __forceinline__ void run(const Src& src, const Args& g) {
  extern __shared__ float2 smem[];
  const int C = CT > 0 ? CT : g.C;
  const int K = g.K, J = g.J, L = g.L, S = g.S;
  const int T = blockDim.x, tid = threadIdx.x;
  const int cap = g.skew ? S + (S - 1) / J : S;            // positions of xs
  float2* w = smem;                         // C*L staged taps, channel-major
  float2* cs = w + (size_t)C * L;           // C*T sums, channel-major
  float2* xs = cs + (size_t)C * T;          // one pass of staged samples
  const long long tiles = (g.out_len + T - 2) / (T - 1);

  for (int i = tid; i < C * L; i += T) {
    const int ch = i / L, p = i - ch * L;
    const int r = g.skew ? p / (J + 1) : 0;                 // row of the position
    const bool pad = g.skew && p - r * (J + 1) == J;
    w[i] = pad ? make_float2(0.f, 0.f) : g.taps[(size_t)ch * K + p - r];
  }
  if (g.skew) {       // the pads between staged rows
    for (int r = tid; r < (S - 1) / J; r += T) xs[r * (J + 1) + J] = make_float2(0.f, 0.f);
  }

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile t(tile, T, tid, J, K, g.out_len);
    for (long long lo = 0; lo < t.ns; lo += S) {
      const int len = (int)(t.ns - lo < S ? t.ns - lo : S);
      __syncthreads();            // the last pass (or tile) is done with xs and cs
      if (lo == 0) {              // (the last tile's discriminator read thread tid's c)
        for (int ch = 0; ch < C; ++ch) cs[ch * T + tid] = make_float2(0.f, 0.f);
      }
      start_stage(src, xs, cap, t.s0 + lo, len, tid, T, g.skew);
      cp_async_wait_all();
      __syncthreads();
      finish_stage(src, xs, cap, t.s0 + lo, len, tid, T, J, g.skew);
      __syncthreads();
      accumulate<CT>(xs, w, cs, lo, len, t, C, K, J, L, T, tid, g.skew);
    }
    if (tile == 0 && tid == 0) {
      for (int ch = 0; ch < C; ++ch) cs[ch * T] = g.c_prev[ch];
    }
    __syncthreads();

    if (t.mine && tid >= 1) {
      for (int ch = 0; ch < C; ++ch) {
        const float2 c = cs[ch * T + tid];
        const float2 p = cs[ch * T + tid - 1];
        const float2 r = g.rot[ch];
        // q = c * conj(p), d = q * rot
        const float qr = c.x * p.x + c.y * p.y;
        const float qi = c.y * p.x - c.x * p.y;
        const float dr = qr * r.x - qi * r.y;
        const float di = qr * r.y + qi * r.x;
        g.audio[(long long)ch * g.out_len + t.m] = atan2f(di, dr);
        if (t.m == g.out_len - 1) g.c_last[ch] = c;
      }
    }
  }
}

// The kernels of one Src: [0] loops over the channels outside the tap loop,
// [c] for c <= C_REG keeps c channels' sums in registers.
template <typename Src>
using Kernel = void (*)(Src, Args);
template <typename Src>
using Kernels = Kernel<Src>[C_REG + 1];

// What `launch` chooses for a call, as `plan` reports it.
struct Plan {
  long long T, S, skew, L, smem, passes, blocks_per_sm, grid;
};

// Staged positions of n span samples (n >= 1).
inline long long positions(long long n, int J, bool skew) {
  return skew ? n + (n - 1) / J : n;
}

// Blocks of `kernel` an SM holds at T threads and smem bytes, asked of the
// runtime once for each (kernel, T, smem, device): the question costs more
// host time than the rest of a launch.
inline int resident_blocks(const void* kernel, int T, size_t smem, int device, int* n) {
  struct Entry {
    const void* kernel;
    int T, device;
    size_t smem;
    int n;
  };
  static Entry seen[64];
  static int used = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = seen[i];
    if (e.kernel == kernel && e.T == T && e.smem == smem && e.device == device) {
      *n = e.n;
      return 0;
    }
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, T, smem);
  if (err == cudaSuccess && used < 64) seen[used++] = Entry{kernel, T, device, smem, *n};
  return (int)err;
}

// Choose the layout (skewed for even J when a pass holds a whole row of J
// samples), T (128 halved down to 32 while a tile's whole span does not fit
// the device's opt-in shared memory) and the staged samples a pass, S, for
// `kernel`; set its shared-memory limit and ask the runtime how many blocks
// an SM holds. The grid: that many blocks on every SM, at most one a tile.
// Returns a cudaError_t (0 = ok).
template <typename Src>
int make_plan(Kernel<Src> kernel, int C, int K, int J, long long out_len, int device,
              Plan* p) {
  if (C < 1 || K < 1 || J < 1 || out_len < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int limit = 0, sms = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long words = limit / (long long)sizeof(float2);
  bool found = false;
  for (int skew = (J % 2 == 0 && K < (1 << 16)) ? 1 : 0; skew >= 0 && !found; --skew) {
    const long long L = skew ? K + (K - 1) / J : K;
    long long T = T_MAX;
    while (T > T_MIN && C * (L + T) + positions((T - 1) * J + K, J, skew) > words) T /= 2;
    const long long room = words - C * (L + T);           // staged positions
    if (room < 1) return (int)cudaErrorInvalidValue;
    const long long span = (T - 1) * J + K;
    long long S = span;
    if (positions(span, J, skew) > room) {
      // rows of J samples and their pads: q*J + q - 1 <= room
      S = skew ? (room + 1) / (J + 1) * J : room;
      if (S < 1) continue;                                  // no whole row: packed
    }
    *p = Plan{T, S, skew, L, 8 * (C * (L + T) + positions(S, J, skew)), (span + S - 1) / S,
              0, 0};
    found = true;
  }
  if (!found) return (int)cudaErrorInvalidValue;
  if (p->smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p->smem);
    if (err != cudaSuccess) return (int)err;
  }
  int n = 0;
  const int e = resident_blocks((const void*)kernel, (int)p->T, (size_t)p->smem, device, &n);
  if (e != 0) return e;
  if (n < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (out_len + p->T - 2) / (p->T - 1);
  p->blocks_per_sm = n;
  p->grid = tiles < (long long)n * sms ? tiles : (long long)n * sms;
  return 0;
}

template <typename Src>
Kernel<Src> pick(const Kernels<Src>& kernels, int C) {
  return kernels[C <= C_REG ? C : 0];
}

// The plan of a call, as eight 64-bit integers: T, S, skew (0/1), L, shared
// bytes a block, passes a tile, resident blocks an SM, blocks.
template <typename Src>
int plan(const Kernels<Src>& kernels, int C, int K, int J, long long out_len, int device,
         long long* out) {
  Plan p;
  const int err = make_plan(pick(kernels, C), C, K, J, out_len, device, &p);
  if (err == 0) {
    const long long v[8] = {p.T, p.S, p.skew, p.L, p.smem, p.passes, p.blocks_per_sm,
                            p.grid};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
  }
  return err;
}

// Plan, then launch the kernel for C channels on `stream`. Returns a
// cudaError_t (0 = ok).
template <typename Src>
int launch(const Kernels<Src>& kernels, Src src, const void* taps, int C, int K, int J,
           long long out_len, const void* rot, const void* c_prev, void* audio,
           void* c_last, int device, void* stream) {
  const Kernel<Src> kernel = pick(kernels, C);
  Plan p;
  const int err = make_plan(kernel, C, K, J, out_len, device, &p);
  if (err != 0) return err;
  const Args g{(const float2*)taps, C, K, J, (int)p.L, out_len, (const float2*)rot,
               (const float2*)c_prev, (float*)audio, (float2*)c_last, (int)p.S,
               p.skew ? (unsigned)((1ull << 32) / (unsigned)J + 1) : 0u};
  kernel<<<(unsigned)p.grid, (unsigned)p.T, (size_t)p.smem, (cudaStream_t)stream>>>(src, g);
  return (int)cudaGetLastError();
}

}  // namespace ddc_tile
