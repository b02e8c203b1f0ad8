// K4: fused DDC + FM discriminator from complex64 samples, for one or more
// channels.
//
// Replaces the TPU kernel directdemod_tpu/ops/pallas_ddc.py::_kernel
// (wrapper ddc_fm_pallas). The TPU kernel read the input pre-swizzled into
// polyphase lanes, x[a*J + r] at (r, a), so that its matrix unit could take
// the windows as small matrix products; here the block reads the samples as
// they lie, one float2 (8 bytes) a thread, neighbouring threads on
// neighbouring samples, and the window contract and the tile are those of
// K1 (ddc_fm_tile.cuh). The TPU kernel returned as c_last the carry at the
// end of its 512-output tile grid, which is c[out_len-1] only when out_len
// is a multiple of 512; this one returns c[out_len-1].
//
// What bounds it on an H100: each input sample is read once as 8 bytes and
// costs about 35 FLOP a channel at J = 34 (151 complex taps x 8 FLOP per
// output), so it is bound by device-memory bytes: 160 MB a 20 M-sample
// block, 48 us at 3.35 TB/s, against 11 us of fp32 FMAs.
#include "ddc_fm_tile.cuh"

namespace {

struct C64Src {
  const float2* __restrict__ h;      // the n_head samples before x
  const float2* __restrict__ x;
  long long n_head;
  __device__ __forceinline__ float2 head(long long s) const { return __ldg(h + s); }
  __device__ __forceinline__ float2 body(long long s) const { return __ldg(x + s); }
};

__global__ void __launch_bounds__(ddc_tile::T_MAX)
ddc_fm_c64_kernel(C64Src src, const float2* taps, int C, int K, int J,
                  long long out_len, const float2* rot, const float2* c_prev,
                  float* audio, float2* c_last, int S) {
  ddc_tile::run(src, taps, C, K, J, out_len, rot, c_prev, audio, c_last, S);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns a cudaError_t (0 = ok).
// The samples are [head | x]: head holds n_head complex64 samples (may be
// null when n_head is 0), x the block, together at least (out_len-1)*J + K;
// taps: C*K complex64 (channel-major); rot, c_prev, c_last: C complex64
// each; audio: C*out_len float32 (channel-major). All on the device.
// Launches on `stream` and does not synchronise.
extern "C" int ddc_fm_c64_launch(const void* head, long long n_head,
                                 const void* x, const void* taps, int C, int K,
                                 int J, long long out_len, const void* rot,
                                 const void* c_prev, void* audio, void* c_last,
                                 int device, void* stream) {
  return ddc_tile::launch(ddc_fm_c64_kernel,
                          C64Src{(const float2*)head, (const float2*)x, n_head},
                          taps, C, K, J, out_len, rot, c_prev, audio, c_last,
                          device, stream);
}
