// The tile of the fused DDC + FM kernels K1 (ddc_fm_u8.cu, raw uint8 IQ)
// and K4 (ddc_fm_c64.cu, complex64 samples), which differ only in how a
// sample is loaded. Window contract, per channel ch < C: output m covers
// samples x[m*J .. m*J+K),
//
//     c[ch][m]     = sum_n w[ch][n] x[m*J + n]     (w = reversed modulated taps)
//     audio[ch][m] = atan2(d), d = c[ch][m] * conj(c[ch][m-1]) * rot[ch],
//     c[ch][-1]    = c_prev[ch],  c_last[ch] = c[ch][out_len-1].
//
// One thread block of T threads owns T-1 new outputs. Thread t computes
// c[m] for m = b*(T-1) - 1 + t, so thread 0 recomputes the output before
// the tile (the TPU kernels carried it across their sequential grid; blocks
// here run in any order) with the same per-output arithmetic as the block
// that owns it: the discriminator sees c[m-1] exactly as it was written,
// and block 0's thread 0 takes c_prev instead. The block stages the span of
// samples its windows cover once into shared memory as float2, all C*K
// taps beside it (each read by the whole warp at once, a broadcast), and
// loops over the channels on the staged samples: the input is read once
// for all channels. A thread stages with UNROLL loads in flight before it
// stores them: a block of few warps (large J leaves room for one or two
// blocks an SM) still keeps enough loads in flight to cover the latency of
// device memory. One thread computes one output per channel with fp32
// FMAs in tap order. When the span does not fit the shared memory next to
// the taps, it is staged in passes; a thread's sum carries from pass to
// pass in shared memory in the same tap order, so the result does not
// depend on the number of passes. Sample offsets are 64-bit.
//
// The samples are the concatenation [head | x]: a stream's history (the
// n_head samples before the block) and the block, read through two
// pointers, so a stream never copies a block to put its history in front.
// A Src gives both: head(s) is head[s] for s < n_head, body(s) is x[s]. A
// pass that starts past the head stages from x with the unrolled loop,
// which has no choice to make; a pass that reaches into the head (with
// n_head <= K-1, only the first block's) chooses sample by sample. The
// staging loop is sensitive to how this is written: on an H100, a choice
// in every load, a loop that starts past the head samples or an
// out-of-line head loop each made K1 and K4 slower at J = 34 and J = 409.
// With this layout only K4 at a stride far above K (J = 409) pays, about
// half again its time without a head (PERF.md).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace ddc_tile {

constexpr int T_MAX = 128;   // threads per block; halved down to T_MIN
constexpr int T_MIN = 32;    // while the span does not fit
constexpr int UNROLL = 8;    // staging loads in flight a thread

template <typename Src>
__device__ __forceinline__ void run(Src src, const float2* __restrict__ taps,
                                    int C, int K, int J, long long out_len,
                                    const float2* __restrict__ rot,
                                    const float2* __restrict__ c_prev,
                                    float* __restrict__ audio,
                                    float2* __restrict__ c_last, int S) {
  extern __shared__ float2 smem[];
  const int T = blockDim.x;
  float2* w = smem;                 // C*K taps, channel-major
  float2* cs = w + (size_t)C * K;   // C*T sums, channel-major
  float2* xs = cs + (size_t)C * T;  // S staged samples

  const int tid = threadIdx.x;
  const long long tn = T - 1;
  const long long b0 = (long long)blockIdx.x * tn;        // first new output
  const long long m = b0 - 1 + tid;                         // this thread's c
  const long long m_first = b0 > 0 ? b0 - 1 : 0;
  const long long m_end = out_len < b0 + tn ? out_len : b0 + tn;
  const bool mine = m >= 0 && m < m_end;
  const long long s0 = m_first * J;                         // first span sample
  const long long ns = (m_end - 1 - m_first) * J + K;       // span length
  const long long base = mine ? m * J - s0 : 0;             // window in the span

  for (int i = tid; i < C * K; i += T) w[i] = taps[i];
  for (int i = tid; i < C * T; i += T) cs[i] = make_float2(0.f, 0.f);

  for (long long lo = 0; lo < ns; lo += S) {
    const int len = (int)(ns - lo < S ? ns - lo : S);
    __syncthreads();              // the last pass is done with xs
    const long long first = s0 + lo;
    if (first >= src.n_head) {
      int i = tid;
      for (; i + (UNROLL - 1) * T < len; i += UNROLL * T) {
        float2 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = src.body(first + i + u * T - src.n_head);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) xs[i + u * T] = v[u];
      }
      for (; i < len; i += T) xs[i] = src.body(first + i - src.n_head);
    } else {                      // the pass reaches into the head
      for (int i = tid; i < len; i += T) {
        const long long s = first + i;
        xs[i] = s < src.n_head ? src.head(s) : src.body(s - src.n_head);
      }
    }
    __syncthreads();
    if (mine) {
      const int a = (int)(lo > base ? lo - base : 0);
      const int e = (int)(lo + len - base < K ? lo + len - base : K);
      const float2* xp = xs + (base - lo);
      for (int ch = 0; ch < C && a < e; ++ch) {
        const float2* wc = w + (size_t)ch * K;
        float2 c = cs[ch * T + tid];
#pragma unroll 4
        for (int n = a; n < e; ++n) {
          const float2 p = wc[n];
          const float2 q = xp[n];
          c.x = fmaf(p.x, q.x, c.x);
          c.x = fmaf(-p.y, q.y, c.x);
          c.y = fmaf(p.x, q.y, c.y);
          c.y = fmaf(p.y, q.x, c.y);
        }
        cs[ch * T + tid] = c;
      }
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    for (int ch = 0; ch < C; ++ch) cs[ch * T] = c_prev[ch];
  }
  __syncthreads();

  if (mine && tid >= 1) {
    for (int ch = 0; ch < C; ++ch) {
      const float2 c = cs[ch * T + tid];
      const float2 p = cs[ch * T + tid - 1];
      const float2 r = rot[ch];
      // q = c * conj(p), d = q * rot
      const float qr = c.x * p.x + c.y * p.y;
      const float qi = c.y * p.x - c.x * p.y;
      const float dr = qr * r.x - qi * r.y;
      const float di = qr * r.y + qi * r.x;
      audio[(long long)ch * out_len + m] = atan2f(di, dr);
      if (m == out_len - 1) c_last[ch] = c;
    }
  }
}

// Shared memory of a block of t threads staging its whole span.
inline size_t span_bytes(int C, int K, int J, int t) {
  return sizeof(float2) * ((size_t)C * K + (size_t)C * t + (size_t)(t - 1) * J + K);
}

// Choose T (128 halved down to 32 while the span does not fit the
// device's opt-in shared memory a block) and the staged samples a pass, S,
// then launch `kernel` on `stream`. Returns a cudaError_t (0 = ok).
template <typename Src>
int launch(void (*kernel)(Src, const float2*, int, int, int, long long,
                          const float2*, const float2*, float*, float2*, int),
           Src src, const void* taps, int C, int K, int J, long long out_len,
           const void* rot, const void* c_prev, void* audio, void* c_last,
           int device, void* stream) {
  if (C < 1 || K < 1 || J < 1 || out_len < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  int T = T_MAX;
  while (T > T_MIN && span_bytes(C, K, J, T) > (size_t)limit) T /= 2;
  const size_t fixed = sizeof(float2) * ((size_t)C * K + (size_t)C * T);
  if (fixed + sizeof(float2) > (size_t)limit) return (int)cudaErrorInvalidValue;
  const long long span = (long long)(T - 1) * J + K;
  const long long room = (long long)(((size_t)limit - fixed) / sizeof(float2));
  const long long S = span < room ? span : room;
  const size_t smem = fixed + sizeof(float2) * (size_t)S;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (out_len + T - 2) / (T - 1);
  kernel<<<(unsigned)blocks, T, smem, (cudaStream_t)stream>>>(
      src, (const float2*)taps, C, K, J, out_len, (const float2*)rot,
      (const float2*)c_prev, (float*)audio, (float2*)c_last, (int)S);
  return (int)cudaGetLastError();
}

}  // namespace ddc_tile
