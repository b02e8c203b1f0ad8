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
// output), so its bound is device-memory bytes: 160 MB a 20 M-sample block,
// 48 us at 3.35 TB/s, against 11 us of fp32 FMAs. What the tile reaches is
// set by the shared memory's wavefronts, which its skewed staging and its
// channels in registers cut to 2 + C a warp-tap, and by how much of device
// memory's latency its staging covers: each sample goes by cp.async straight
// to its place in shared memory, the whole span in flight (ddc_fm_tile.cuh).
#include "ddc_fm_tile.cuh"

namespace {

struct C64Src {
  static constexpr bool kPairs = false;
  const float2* __restrict__ h;      // the n_head samples before x
  const float2* __restrict__ x;
  long long n_head;
  // copy body sample s into shared memory at dst without a register
  __device__ __forceinline__ void copy_async(float2* dst, long long s) const {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(x + s) : "memory");
  }
  __device__ __forceinline__ float2 head(long long s) const { return __ldg(h + s); }
  __device__ __forceinline__ float2 body(long long s) const { return __ldg(x + s); }
};

template <int CT>
__global__ void __launch_bounds__(ddc_tile::T_MAX)
ddc_fm_c64_kernel(C64Src src, ddc_tile::Args g) {
  ddc_tile::run<CT>(src, g);
}

// [0]: any number of channels; [c]: c <= C_REG channels in registers
const ddc_tile::Kernels<C64Src> kKernels = {
    ddc_fm_c64_kernel<0>, ddc_fm_c64_kernel<1>, ddc_fm_c64_kernel<2>,
    ddc_fm_c64_kernel<3>, ddc_fm_c64_kernel<4>};

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
  return ddc_tile::launch(kKernels,
                          C64Src{(const float2*)head, (const float2*)x, n_head},
                          taps, C, K, J, out_len, rot, c_prev, audio, c_last,
                          device, stream);
}

// What the launch of C channels at stride J over out_len outputs chooses, as
// eight 64-bit integers into `out`: threads a block T, span samples a pass
// S, the skewed layout (0/1), tap positions a channel L, shared bytes a
// block, passes a tile, resident blocks an SM and blocks (each walks tiles
// of T - 1 outputs). Returns a cudaError_t.
extern "C" int ddc_fm_c64_plan(int C, int K, int J, long long out_len,
                               int device, long long* out) {
  return ddc_tile::plan(kKernels, C, K, J, out_len, device, out);
}
