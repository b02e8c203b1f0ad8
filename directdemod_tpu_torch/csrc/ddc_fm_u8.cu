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
// What bounds it on an H100: each input sample is read once as 2 bytes
// (40 MB a 20 M-sample block, 12 us at 3.35 TB/s) and costs about 35 FLOP a
// channel at J = 34 (151 complex taps x 8 FLOP per output; 11 us of fp32
// FMAs), so on paper bytes and FMAs bound it together near 12 us. In fact
// the shared memory bounds it: every tap of every output reads its staged
// sample and its tap there, 3 wavefronts a warp-tap at the least against
// one issue cycle of FMAs; and a tile's staging waits a round trip to
// device memory, which 2-byte loads with few in flight never cover. The
// tile (ddc_fm_tile.cuh) skews its staging (no bank conflict at even J),
// keeps up to 4 channels' sums in registers (one sample load for all of
// them), copies its bytes with cp.async, the whole span in flight, into the
// tail of the sample buffer and converts them there, and walks tiles in a
// persistent grid. Each sample is converted to float2 once, with the 127.5
// offset already subtracted (exact in fp32, so no large constant is
// cancelled afterwards), and not once per overlapping window or channel.
#include "ddc_fm_tile.cuh"

namespace {

__device__ __forceinline__ float2 u8_sample(uchar2 v) {
  return make_float2((float)v.x - 127.5f, (float)v.y - 127.5f);
}

struct U8Src {
  static constexpr bool kPairs = true;
  const uchar2* __restrict__ h;      // the n_head (I, Q) pairs before iq
  const uchar2* __restrict__ iq;     // the block's bytes as (I, Q) pairs
  long long n_head;
  // 1 when body sample s is the second of its 4-byte-aligned pair
  __device__ __forceinline__ int pair_phase(long long s) const {
    return (int)((reinterpret_cast<uintptr_t>(iq + s) >> 1) & 1);
  }
  // copy body samples s, s+1 (s pair-aligned) into shared memory at dst
  __device__ __forceinline__ void copy_pair_async(char* dst, long long s) const {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(iq + s) : "memory");
  }
  __device__ __forceinline__ static float2 sample(uchar2 v) { return u8_sample(v); }
  __device__ __forceinline__ float2 head(long long s) const {
    return u8_sample(__ldg(h + s));
  }
  __device__ __forceinline__ float2 body(long long s) const {
    return u8_sample(__ldg(iq + s));
  }
};

template <int CT>
__global__ void __launch_bounds__(ddc_tile::T_MAX)
ddc_fm_u8_kernel(U8Src src, ddc_tile::Args g) {
  ddc_tile::run<CT>(src, g);
}

// [0]: any number of channels; [c]: c <= C_REG channels in registers
const ddc_tile::Kernels<U8Src> kKernels = {
    ddc_fm_u8_kernel<0>, ddc_fm_u8_kernel<1>, ddc_fm_u8_kernel<2>,
    ddc_fm_u8_kernel<3>, ddc_fm_u8_kernel<4>};

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
  return ddc_tile::launch(kKernels,
                          U8Src{(const uchar2*)head, (const uchar2*)raw, n_head},
                          taps, C, K, J, out_len, rot, c_prev, audio, c_last,
                          device, stream);
}

// What the launch of C channels at stride J over out_len outputs chooses, as
// eight 64-bit integers into `out`: threads a block T, span samples a pass
// S, the skewed layout (0/1), tap positions a channel L, shared bytes a
// block, passes a tile, resident blocks an SM and blocks (each walks tiles
// of T - 1 outputs). Returns a cudaError_t.
extern "C" int ddc_fm_u8_plan(int C, int K, int J, long long out_len,
                              int device, long long* out) {
  return ddc_tile::plan(kKernels, C, K, J, out_len, device, out);
}
