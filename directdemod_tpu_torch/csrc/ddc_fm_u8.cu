// K1: fused unpack + DDC + FM discriminator from raw interleaved uint8 IQ.
//
// Replaces the TPU kernel directdemod_tpu/ops/pallas_ddc.py::_kernel_u8
// (wrapper ddc_fm_pallas_u8) and its dense-GEMM lowering
// directdemod_tpu/ops/ddc_conv.py BytePlan.apply_dot. Window contract:
// output m covers complex samples x[m*J .. m*J+K), i.e. bytes
// raw[2*m*J .. 2*(m*J+K)), with x[s] = (raw[2s] - 127.5) + 1j*(raw[2s+1] - 127.5):
//
//     c[m]     = sum_n w[n] x[m*J + n]        (w = reversed modulated taps)
//     audio[m] = atan2(d), d = c[m] * conj(c[m-1]) * rot,  c[-1] = c_prev
//
// What bounds it on an H100: each input sample is read once as 2 bytes and
// costs about 35 FLOP (151 complex taps x 8 FLOP per output, one output per
// J = 34 samples), so byte reads and fp32 FMA throughput bound it together.
// The design is the simple one:
//   * one thread block per tile of T outputs stages its byte span,
//     (T-1)*J + K samples plus J for the halo, once from device memory,
//     converted to float2 with the 127.5 offset already subtracted (exact in
//     fp32, so no large constant is cancelled afterwards), so each sample's
//     convert is paid once and not once per overlapping window;
//   * the K taps sit in shared memory; every thread of a warp reads the same
//     tap at the same step (a broadcast);
//   * one thread computes one output with fp32 FMAs.
// The TPU kernel carried c[m-1] across its sequential grid. Blocks here run
// in any order, so each block recomputes the one c before its tile from its
// own halo (warp 0, a shuffle reduction); only output 0 reads c_prev. The
// atan2 and the c_last write (at output out_len - 1, not at the end of the
// tile grid) are fused in, and byte offsets are 64-bit, so a capture of more
// than 2^31 bytes goes through in one call.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 128;  // outputs (threads) per block

__global__ void __launch_bounds__(T)
ddc_fm_u8_kernel(const uint8_t* __restrict__ raw, const float2* __restrict__ taps,
                 int K, int J, long long out_len, const float2* __restrict__ rotp,
                 const float2* __restrict__ c_prev, float* __restrict__ audio,
                 float2* __restrict__ c_last) {
  extern __shared__ float2 smem[];
  float2* w = smem;              // K taps
  float2* cs = smem + K;         // T + 1 conv outputs: cs[0] = c[m0 - 1]
  float2* xs = cs + T + 1;       // staged samples

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * T;
  const int n_here = (int)min((long long)T, out_len - m0);
  const int halo = m0 > 0 ? 1 : 0;
  const long long s0 = (m0 - halo) * (long long)J;   // first staged sample
  const int ns = (n_here - 1 + halo) * J + K;        // staged sample count

  for (int i = tid; i < K; i += T) w[i] = taps[i];
  const uint8_t* src = raw + 2 * s0;
  for (int i = tid; i < ns; i += T) {
    xs[i] = make_float2((float)src[2 * i] - 127.5f, (float)src[2 * i + 1] - 127.5f);
  }
  __syncthreads();

  float2 c = make_float2(0.f, 0.f);
  if (tid < n_here) {
    const float2* x = xs + (tid + halo) * J;
#pragma unroll 4
    for (int n = 0; n < K; ++n) {
      const float2 a = w[n];
      const float2 b = x[n];
      c.x = fmaf(a.x, b.x, c.x);
      c.x = fmaf(-a.y, b.y, c.x);
      c.y = fmaf(a.x, b.y, c.y);
      c.y = fmaf(a.y, b.x, c.y);
    }
    cs[tid + 1] = c;
  }
  if (tid < 32) {
    float2 h = make_float2(0.f, 0.f);
    if (halo) {
      for (int n = tid; n < K; n += 32) {
        const float2 a = w[n];
        const float2 b = xs[n];
        h.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, h.x));
        h.y = fmaf(a.x, b.y, fmaf(a.y, b.x, h.y));
      }
      for (int o = 16; o > 0; o >>= 1) {
        h.x += __shfl_down_sync(0xffffffffu, h.x, o);
        h.y += __shfl_down_sync(0xffffffffu, h.y, o);
      }
    } else {
      h = *c_prev;
    }
    if (tid == 0) cs[0] = h;
  }
  __syncthreads();

  if (tid < n_here) {
    const float2 p = cs[tid];
    const float2 r = *rotp;
    // q = c * conj(p), d = q * rot
    const float qr = c.x * p.x + c.y * p.y;
    const float qi = c.y * p.x - c.x * p.y;
    const float dr = qr * r.x - qi * r.y;
    const float di = qr * r.y + qi * r.x;
    const long long m = m0 + tid;
    audio[m] = atan2f(di, dr);
    if (m == out_len - 1) *c_last = c;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns a cudaError_t (0 = ok).
// raw: device bytes, at least 2*((out_len-1)*J + K); taps: K complex64;
// rot, c_prev, c_last: one complex64 each; audio: out_len float32.
// Launches on `stream` and does not synchronise.
extern "C" int ddc_fm_u8_launch(const void* raw, const void* taps, int K, int J,
                                long long out_len, const void* rot,
                                const void* c_prev, void* audio, void* c_last,
                                int device, void* stream) {
  if (K < 1 || J < 1 || out_len < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float2) * ((size_t)K + T + 1 + (size_t)T * J + K);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ddc_fm_u8_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (out_len + T - 1) / T;
  ddc_fm_u8_kernel<<<(unsigned)blocks, T, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)raw, (const float2*)taps, K, J, out_len,
      (const float2*)rot, (const float2*)c_prev, (float*)audio, (float2*)c_last);
  return (int)cudaGetLastError();
}
