// The two edges of the fused R-CED / CR-CED inference forward: layer 1 and
// the final (1, 129) projection, float32 on the CUDA cores.
//
// They replace no TPU kernel: the JAX package's fused forward
// (fullycnnspeechenhancement_tpu/ops/pallas_rced.py,
// `_fused_inference_forward`) leaves both convs to XLA around its Pallas
// stack kernel.  The port ran them as cuDNN convs around rced_stack.cu, and
// with TF32 off (the engine keeps float32 for waveform parity) cuDNN takes a
// generic implicit-GEMM kernel on the CUDA cores that handles neither a
// 1-channel input under an (8, 11) kernel nor a 129-tap kernel with one
// output channel well: about 12 ms of a 416 s call's 24 device ms on an
// H100, against the stack kernel's 7.
//
//   rced_first_kernel: out[c, t, f] = act(b[c] + sum_{i, j} w[c, i, j] *
//     mag[t + i - (kh - 1) / 2, f + j - (kw - 1) / 2]), the batch norm
//     folded into w and b, zeros outside [0, T) x [0, 129) (TF SAME);
//     [B, T, 129] -> [B, C, T, 129], the layout rced_stack.cu reads.
//   rced_proj_kernel: out[t, f] = b + sum_{c, j} z[c, t, f + j - 64] *
//     w[c, j] over the taps whose bin lies in [0, 129); [B, C, T, 129] ->
//     [B, T, 129], the fused forward's result.
//
// What bounds them on an H100: arithmetic, on the CUDA cores, since both
// keep float32 (no 1xTF32, which costs the waveform its parity).  For V2
// (layer 1 (8, 11), 1 -> 10; the projection 10 -> 1) a frame needs
// 111,120 multiply-adds in layer 1 (a tap meets 129 - |j - lo| bins) and
// 124,810 in the projection (12,481 real (bin, tap) pairs a channel), so a
// 416 s call (25,999 frames) needs 2.89 G and 3.24 G: 0.183 ms at the data
// sheet's 67 TFLOP/s float32 rate.  They read their input once and write
// their output once, 295 MB together, 0.09 ms at 3.35 TB/s.
//
// What the design does about it.
// - Register tiles, so that each shared-memory load feeds several FMAs.
//   In layer 1 a thread holds one bin of 4 consecutive frames for every
//   output channel (C templated in pairs, so the tile is all registers):
//   per tap column j it loads the 11 input values its 4 frames' 8 time
//   taps read, then for each channel pair 4 float4 broadcasts of weights
//   (8 time taps x 2 channels), each feeding 16 FMAs: about 10 FMAs per
//   load at V2.  In the projection a lane holds 8 consecutive bins of one
//   frame and slides them over the taps, 4 at a time: one float4 weight
//   broadcast and 4 new input values feed 32 FMAs.
// - No padding copies: layer 1 stages its frames' rows (tile + 7) with
//   zeros outside the input, and the projection each channel's rows with
//   12 zero bins on both sides; a tap's shift is an address offset.
// - Threads where the work is.  Layer 1 numbers (frame group, bin) pairs
//   straight across the block's threads (129 G of them rounded up to a
//   warp; 9 warps for G = 2), not a warp-aligned 160 bins a group, which
//   would leave a fifth of the lanes idle.  The projection gives each warp
//   one group of 8 bins and each lane a frame, so a warp's tap range is
//   uniform: it runs only the taps that meet a real bin of its group
//   (13,856 of the 16,641 a full window would, against 12,481 real), and
//   its lanes read 32 frames' rows 153 floats apart (odd), 32 banks.
// - The projection stages a channel's 32 frames with 4-byte cp.async into
//   one of two buffers while the block works on the other.
// - Enough blocks for short requests: the host picks the tiles (ops/
//   rced_edges.py `first_plan`, `proj_plan`, set by timings on an H100):
//   layer 1 takes 4 frames a block where 8 would leave most SMs idle, and
//   the projection splits its 17 bin groups over blocks of fewer warps
//   (at least 4, which share each channel's staging) while its 32-frame
//   tiles are few, so a 2 s request (T = 124) runs 31 and 20 blocks.
// - Sums in float32 in a fixed order (layer 1: tap column, then time tap;
//   the projection: channel, then tap), no atomics, so a launch repeats
//   bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 129;
constexpr int kTimeTaps = 8;  // layer 1's time taps computed; rows past kh carry zero weights
constexpr int kMaxKw = 13;
constexpr int kMaxChannels = 32;
constexpr int kFirstHalo = (kMaxKw - 1) / 2;
constexpr int kFirstRow = kBins + 2 * kFirstHalo;  // floats a staged input row
constexpr int kFrames = 4;                         // frames of a layer-1 thread's tile
constexpr int kMaxGroups = 2;                      // frame groups of kFrames a layer-1 block
constexpr int kFirstThreads = (kMaxGroups * kBins + 31) / 32 * 32;

constexpr int kProjTaps = 129;
constexpr int kProjCentre = (kProjTaps - 1) / 2;
constexpr int kProjTapsPadded = 132;  // a multiple of 4, zero weights past 129
constexpr int kGroupBins = 8;         // bins a projection lane slides over the taps
constexpr int kBinGroups = (kBins + kGroupBins - 1) / kGroupBins;  // 17
constexpr int kProjHalo = 12;
constexpr int kProjRow = kProjHalo + kBins + kProjHalo;  // 153, odd
constexpr int kProjFrames = 32;                          // frames of a projection block, one a lane

static_assert(kProjRow % 2 == 1, "lanes' rows must fall in distinct banks");

// ---- layer 1 ------------------------------------------------------------

// NCH channel pairs (C <= 2 NCH; the pack zero-pads an odd C).  `w` is
// [kw][NCH][kTimeTaps][2] floats: for tap column j and pair k the 8 time
// taps of both channels, so two time taps are one float4.  `bias` is
// [2 NCH].  A block takes `groups` x kFrames frames of one batch row.
template <int NCH>
__global__ void __launch_bounds__(kFirstThreads) rced_first_kernel(
    const float* __restrict__ mag, float* __restrict__ out, const float* __restrict__ w,
    const float* __restrict__ bias, int frames, int channels, int kh, int kw, int relu, int groups) {
  __shared__ float s_x[(kMaxGroups * kFrames + kTimeTaps - 1) * kFirstRow];
  __shared__ __align__(16) float s_w[kMaxKw * NCH * kTimeTaps * 2];

  const int tile = groups * kFrames;
  const int t0 = blockIdx.x * tile;
  const int b = blockIdx.y;
  const int top = (kh - 1) / 2, lo = (kw - 1) / 2;
  const float* x = mag + static_cast<size_t>(b) * frames * kBins;

  // input rows t0 - top .. t0 - top + tile + 6, zeros outside the input
  const int staged = (tile + kTimeTaps - 1) * kFirstRow;
  for (int e = threadIdx.x; e < staged; e += blockDim.x) {
    const int r = e / kFirstRow, q = e - r * kFirstRow - kFirstHalo;
    const int t = t0 - top + r;
    s_x[e] = (t >= 0 && t < frames && q >= 0 && q < kBins) ? x[static_cast<size_t>(t) * kBins + q] : 0.f;
  }
  for (int e = threadIdx.x; e < kw * NCH * kTimeTaps * 2; e += blockDim.x) s_w[e] = w[e];
  __syncthreads();

  const int items = groups * kBins;
  const int item = min(static_cast<int>(threadIdx.x), items - 1);  // the rounding-up lanes repeat the last
  const int g = item / kBins, f = item - g * kBins;

  float acc[kFrames][2 * NCH];
#pragma unroll
  for (int c = 0; c < 2 * NCH; ++c) {
    const float bc = bias[c];
#pragma unroll
    for (int r = 0; r < kFrames; ++r) acc[r][c] = bc;
  }

  const float* xr = s_x + g * kFrames * kFirstRow + f + kFirstHalo - lo;
  for (int j = 0; j < kw; ++j) {
    float xv[kFrames + kTimeTaps - 1];
#pragma unroll
    for (int s = 0; s < kFrames + kTimeTaps - 1; ++s) xv[s] = xr[s * kFirstRow + j];
    const float4* wj = reinterpret_cast<const float4*>(s_w + j * NCH * kTimeTaps * 2);
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
#pragma unroll
      for (int i2 = 0; i2 < kTimeTaps / 2; ++i2) {
        const float4 ww = wj[k * kTimeTaps / 2 + i2];  // taps 2 i2 and 2 i2 + 1 of channels 2k, 2k + 1
#pragma unroll
        for (int r = 0; r < kFrames; ++r) {
          acc[r][2 * k] = fmaf(xv[r + 2 * i2], ww.x, acc[r][2 * k]);
          acc[r][2 * k + 1] = fmaf(xv[r + 2 * i2], ww.y, acc[r][2 * k + 1]);
        }
#pragma unroll
        for (int r = 0; r < kFrames; ++r) {
          acc[r][2 * k] = fmaf(xv[r + 2 * i2 + 1], ww.z, acc[r][2 * k]);
          acc[r][2 * k + 1] = fmaf(xv[r + 2 * i2 + 1], ww.w, acc[r][2 * k + 1]);
        }
      }
    }
  }

  if (static_cast<int>(threadIdx.x) >= items) return;
  float* o = out + static_cast<size_t>(b) * channels * frames * kBins;
#pragma unroll
  for (int c = 0; c < 2 * NCH; ++c) {
    if (c >= channels) break;
#pragma unroll
    for (int r = 0; r < kFrames; ++r) {
      const int t = t0 + g * kFrames + r;
      if (t < frames) {
        const float v = acc[r][c];
        o[(static_cast<size_t>(c) * frames + t) * kBins + f] = relu ? fmaxf(v, 0.f) : v;
      }
    }
  }
}

// ---- the projection -----------------------------------------------------

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// `w` is [channels][kProjTapsPadded] floats, `bias` one float.  Block
// (blockIdx.x, blockIdx.y): batch row and 32-frame tile blockIdx.x, bin
// groups blockIdx.y * warps + warp; shared memory: the weights, then two
// buffers of 32 rows of kProjRow floats.
__global__ void __launch_bounds__(32 * kBinGroups) rced_proj_kernel(
    const float* __restrict__ z, float* __restrict__ out, const float* __restrict__ w,
    const float* __restrict__ bias, int frames, int channels, int tiles) {
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;
  float* s_z = smem + channels * kProjTapsPadded;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / tiles, t0 = (blockIdx.x - b * tiles) * kProjFrames;
  const int valid = min(kProjFrames, frames - t0);

  for (int e = threadIdx.x; e < 2 * kProjFrames * kProjRow; e += blockDim.x) s_z[e] = 0.f;
  for (int e = threadIdx.x; e < channels * kProjTapsPadded; e += blockDim.x) s_w[e] = w[e];
  __syncthreads();  // the zeros land before any copy

  const float* zb = z + (static_cast<size_t>(b) * channels * frames + t0) * kBins;
  auto stage = [&](int c) {
    const float* src = zb + static_cast<size_t>(c) * frames * kBins;
    float* buf = s_z + (c & 1) * kProjFrames * kProjRow + kProjHalo;
    for (int e = threadIdx.x; e < valid * kBins; e += blockDim.x) {
      const int r = e / kBins;
      copy4(buf + r * kProjRow + (e - r * kBins), src + e);
    }
    copy_commit();
  };

  const int group = blockIdx.y * warps + warp;
  const bool active = group < kBinGroups;
  const int f0 = kGroupBins * group;
  const int fmax = min(f0 + kGroupBins - 1, kBins - 1);
  // the taps whose input bin f + j - 64 lies in [0, 129) for a real bin f
  // of the group, widened to multiples of 4 (zero inputs or weights)
  const int j0 = max(0, kProjCentre - fmax) & ~3;
  const int j1 = (min(kProjTaps - 1, kProjCentre + kBins - 1 - f0) + 4) & ~3;

  float acc[kGroupBins];
#pragma unroll
  for (int u = 0; u < kGroupBins; ++u) acc[u] = 0.f;

  stage(0);
  for (int c = 0; c < channels; ++c) {
    if (c + 1 < channels) {
      stage(c + 1);  // into the buffer channel c - 1 used: every warp left it at the last barrier
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* row = s_z + (c & 1) * kProjFrames * kProjRow + lane * kProjRow + kProjHalo + f0 - kProjCentre;
      const float4* wc = reinterpret_cast<const float4*>(s_w + c * kProjTapsPadded);
      float win[kGroupBins + 4];
#pragma unroll
      for (int u = 0; u < kGroupBins; ++u) win[u] = row[j0 + u];
      for (int j = j0; j < j1; j += 4) {
        const float4 ww = wc[j / 4];
#pragma unroll
        for (int u = 0; u < 4; ++u) win[kGroupBins + u] = row[j + kGroupBins + u];
#pragma unroll
        for (int u = 0; u < kGroupBins; ++u) acc[u] = fmaf(win[u], ww.x, acc[u]);
#pragma unroll
        for (int u = 0; u < kGroupBins; ++u) acc[u] = fmaf(win[u + 1], ww.y, acc[u]);
#pragma unroll
        for (int u = 0; u < kGroupBins; ++u) acc[u] = fmaf(win[u + 2], ww.z, acc[u]);
#pragma unroll
        for (int u = 0; u < kGroupBins; ++u) acc[u] = fmaf(win[u + 3], ww.w, acc[u]);
#pragma unroll
        for (int u = 0; u < kGroupBins; ++u) win[u] = win[u + 4];
      }
    }
    __syncthreads();  // buffer c & 1 is staged again for channel c + 2
  }

  if (!active || lane >= valid) return;
  const float bb = bias[0];
  float* o = out + (static_cast<size_t>(b) * frames + t0 + lane) * kBins;
#pragma unroll
  for (int u = 0; u < kGroupBins; ++u)
    if (f0 + u < kBins) o[f0 + u] = acc[u] + bb;
}

template <int NCH>
cudaError_t launch_first(const float* mag, float* out, const float* w, const float* bias, int batch,
                         int frames, int channels, int kh, int kw, int relu, int groups,
                         cudaStream_t stream) {
  const int tile = groups * kFrames;
  const dim3 grid((frames + tile - 1) / tile, batch);
  const int threads = (groups * kBins + 31) / 32 * 32;
  rced_first_kernel<NCH><<<grid, threads, 0, stream>>>(mag, out, w, bias, frames, channels, kh, kw, relu,
                                                       groups);
  return cudaGetLastError();
}

}  // namespace

// Layer 1 on `stream`: mag [batch, frames, 129] -> out [batch, channels,
// frames, 129], float32, contiguous.  `w` is the pack's [kw][ceil(channels /
// 2)][8][2] floats (time taps past kh and a channel past an odd count zero),
// `bias` [2 ceil(channels / 2)]; `relu` applies the ReLU; `groups` (1 or 2)
// sets 4 or 8 frames a block.  Returns the CUDA error code of the launch (0
// on success); never synchronises.
extern "C" int rced_first_forward(const float* mag, float* out, const float* w, const float* bias, int batch,
                                  int frames, int channels, int kh, int kw, int relu, int groups,
                                  void* stream) {
  if (batch < 1 || batch > 65535 || frames < 1 || channels < 1 || channels > kMaxChannels || kh < 1 ||
      kh > kTimeTaps || kw < 1 || kw > kMaxKw || groups < 1 || groups > kMaxGroups ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((channels + 1) / 2) {
#define FIRST_CASE(N) \
  case N:             \
    return static_cast<int>(launch_first<N>(mag, out, w, bias, batch, frames, channels, kh, kw, relu, groups, s));
    FIRST_CASE(1) FIRST_CASE(2) FIRST_CASE(3) FIRST_CASE(4) FIRST_CASE(5) FIRST_CASE(6) FIRST_CASE(7)
    FIRST_CASE(8) FIRST_CASE(9) FIRST_CASE(10) FIRST_CASE(11) FIRST_CASE(12) FIRST_CASE(13) FIRST_CASE(14)
    FIRST_CASE(15) FIRST_CASE(16)
#undef FIRST_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The projection on `stream`: z [batch, channels, frames, 129] -> out
// [batch, frames, 129], float32, contiguous.  `w` is [channels][132] floats
// (zeros past tap 129), `bias` one float on the device; `warps` (1..17)
// sets the bin groups of 8 a block takes, so blockIdx.y runs over
// ceil(17 / warps) chunks of them.  Returns the CUDA error code of the
// launch (0 on success); never synchronises.
extern "C" int rced_proj_forward(const float* z, float* out, const float* w, const float* bias, int batch,
                                 int frames, int channels, int warps, void* stream) {
  const long long tiles = (frames + kProjFrames - 1) / kProjFrames;
  if (batch < 1 || frames < 1 || channels < 1 || channels > kMaxChannels || warps < 1 ||
      warps > kBinGroups || batch * tiles > 0x7fffffffLL || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(float)) * (channels * kProjTapsPadded + 2 * kProjFrames * kProjRow);
  cudaError_t err = cudaFuncSetAttribute(rced_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(batch * tiles), (kBinGroups + warps - 1) / warps);
  rced_proj_kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      z, out, w, bias, frames, channels, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rced_edges_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
