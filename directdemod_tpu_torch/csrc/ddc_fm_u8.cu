// K1: fused unpack + DDC + FM discriminator from raw interleaved uint8 IQ,
// for one or more channels.
//
// Replaces the TPU kernel directdemod_tpu/ops/pallas_ddc.py::_kernel_u8
// (wrapper ddc_fm_pallas_u8) and its dense-GEMM lowering
// directdemod_tpu/ops/ddc_conv.py BytePlan.apply_dot; the channel axis is
// the vmap of directdemod_tpu/models/multichannel.py. Sample s is
// x[s] = (raw[2s] - 127.5) + 1j*(raw[2s+1] - 127.5); the window contract and
// the tile are in ddc_fm_tile.cuh.
//
// What bounds it on an H100: each input sample is read once as 2 bytes and
// costs about 35 FLOP a channel (151 complex taps x 8 FLOP per output, one
// output per J = 34 samples), so byte reads and fp32 FMA throughput bound
// it together. Each sample is converted to float2 once, with the 127.5
// offset already subtracted (exact in fp32, so no large constant is
// cancelled afterwards), when the block stages it, and not once per
// overlapping window or channel.
#include "ddc_fm_tile.cuh"

namespace {

__device__ __forceinline__ float2 u8_sample(uchar2 v) {
  return make_float2((float)v.x - 127.5f, (float)v.y - 127.5f);
}

struct U8Src {
  const uchar2* __restrict__ h;      // the n_head (I, Q) pairs before iq
  const uchar2* __restrict__ iq;     // the block's bytes as (I, Q) pairs
  long long n_head;
  __device__ __forceinline__ float2 head(long long s) const { return u8_sample(__ldg(h + s)); }
  __device__ __forceinline__ float2 body(long long s) const { return u8_sample(__ldg(iq + s)); }
};

__global__ void __launch_bounds__(ddc_tile::T_MAX)
ddc_fm_u8_kernel(U8Src src, const float2* taps, int C, int K, int J,
                 long long out_len, const float2* rot, const float2* c_prev,
                 float* audio, float2* c_last, int S) {
  ddc_tile::run(src, taps, C, K, J, out_len, rot, c_prev, audio, c_last, S);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns a cudaError_t (0 = ok).
// The bytes are [head | raw], both at even addresses and read as (I, Q)
// pairs, 2 bytes a load: head holds n_head pairs (may be null when n_head
// is 0), raw the block, together at least (out_len-1)*J + K pairs; taps:
// C*K complex64 (channel-major); rot, c_prev, c_last: C complex64 each;
// audio: C*out_len float32 (channel-major). All on the device. Launches on
// `stream` and does not synchronise.
extern "C" int ddc_fm_u8_launch(const void* head, long long n_head,
                                const void* raw, const void* taps, int C, int K,
                                int J, long long out_len, const void* rot,
                                const void* c_prev, void* audio, void* c_last,
                                int device, void* stream) {
  return ddc_tile::launch(ddc_fm_u8_kernel,
                          U8Src{(const uchar2*)head, (const uchar2*)raw, n_head},
                          taps, C, K, J, out_len, rot, c_prev, audio, c_last,
                          device, stream);
}
