// Frequency-only (1, K) convolution, float32: one layer (`freq_conv`) and a
// chain of layers kept in shared memory (`freq_conv_stack`).
//
// Replaces the Pallas TPU kernels of the repo-root probes
// benchmarks/micro_pallas_{conv,roll,roll2,min,min2}.py (`main.vA/vB/vC`,
// `k1`..`k6`, `mk_stack`), which time one (1, K) frequency conv, its Mosaic
// formulations, and chains of it kept on chip.  Every one of them computes
//
//   y[b, r, p, d] = sum_j sum_c w[j, c, d] * x[b, r, p + j * dil - lo, c]
//
// with a zero boundary (TF SAME: lo before, K - 1 - lo after) or a circular
// one over P, then an optional epilogue in this order: the position mask
// (p % period < valid), ReLU, a scale.
//
// What bounds it on an H100: arithmetic, for every shape the probes and
// the R-CED layers give it (V2's 14 inner layers at 64 x 8 s: 2.4110e11
// FLOP, 3.6 ms at 67 TFLOP/s float32 without tensor cores, against 0.2 ms
// to move their inputs and outputs at 3.35 TB/s).  At the probes' own
// shapes (1e8..4e9 FLOP) a launch costs more than the bound.
//
// What the design does about it:
//  * `freq_conv` takes element strides for a [B, R, P, C] input, a
//    [B, R, P, D] output and [K, C, D] weights, so NHWC, channels-before-
//    frequency, NCHW and the flat [C, N] roll layout are all views with no
//    copy (a stride of 0 repeats a tap).  A block stages all K * C * D
//    weights in shared memory once (output channels padded to a multiple
//    of 4 with zeros) and then walks its share of (row, tile) items: for
//    each it stages the C input rows of the tile with their halo (zero or
//    wrapped), so a tap is an offset read.  Each thread computes 4 output
//    channels at 2 positions, so one float4 weight read and two input reads
//    feed 8 fused multiply-adds.  Positions the mask zeroes are not
//    computed.  129 bins and 25 channels are not multiples of 4: the
//    staging is scalar, and nothing is read unaligned.
//  * `freq_conv_stack` runs `depth` layers with the same [K, C, C] weights
//    on the flat roll layout [C, N] (frames of `frame` lanes, the first
//    `valid` of them live), with the mask, ReLU and scale after every
//    layer.  One block owns one frame: it keeps the frame's activations in
//    two shared-memory buffers (ping-pong), so the chain reads device
//    memory once and writes it once.  Layer 1 reads its halo from the
//    neighbouring frames, circularly over N, as the probes' roll does;
//    after the mask the pad lanes are zero, so later layers see zero halos.
//  * Sums and operands are float32; tensor cores, TMA and tuning are later
//    work.
//
// Both kernels launch on the caller's stream, never synchronise and
// allocate nothing.

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 13;
constexpr int kSlack = 4;  // floats after the last staged row: discarded over-reads

// The geometry of one freq_conv launch, as an array of int64 filled by
// ops/freq_conv.py in this order.
enum Field {
  kBatch, kRows, kP, kCin, kCout,
  kXb, kXr, kXp, kXc,  // element strides of x as [B, R, P, C]
  kYb, kYr, kYp, kYd,  // of y as [B, R, P, D]
  kWj, kWc, kWd,       // of w as [K, C, D]
  kLo, kDil, kCircular, kPeriod, kValid, kRelu, kTile,
  kFields
};

struct Geom {
  long long f[kFields];
};

// ws[(c * K + j) * d4 + d] = w[j, c, d]; zero for d >= cout.
__device__ __forceinline__ void stage_weights(float* ws, const float* __restrict__ w, int K,
                                              int cin, int cout, int d4, long long wj,
                                              long long wc, long long wd) {
  const int n = cin * K * d4;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int d = i % d4;
    const int cj = i / d4;
    const int j = cj % K;
    const int c = cj / K;
    ws[i] = d < cout ? __ldg(w + j * wj + c * wc + d * wd) : 0.f;
  }
}

// Sums for output channels 4g..4g+3 at two positions: `xr` points at the
// staged entry of the first position's tap 0 in channel row 0 (rows are
// `xrow` floats apart); the second position is `half` entries later.
template <int K>
__device__ __forceinline__ void conv_item(const float* xr, int xrow, const float4* ws4,
                                          int groups, int g, int cin, int dil, int half,
                                          float a0[4], float a1[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) a0[k] = a1[k] = 0.f;
  const float4* wg = ws4 + g;
  for (int c = 0; c < cin; ++c) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float4 wv = wg[(c * K + j) * groups];
      const float x0 = xr[j * dil];
      const float x1 = xr[j * dil + half];
      a0[0] = fmaf(wv.x, x0, a0[0]);
      a0[1] = fmaf(wv.y, x0, a0[1]);
      a0[2] = fmaf(wv.z, x0, a0[2]);
      a0[3] = fmaf(wv.w, x0, a0[3]);
      a1[0] = fmaf(wv.x, x1, a1[0]);
      a1[1] = fmaf(wv.y, x1, a1[1]);
      a1[2] = fmaf(wv.z, x1, a1[2]);
      a1[3] = fmaf(wv.w, x1, a1[3]);
    }
    xr += xrow;
  }
}

__device__ __forceinline__ float epilogue(float v, bool live, bool relu, float scale) {
  v = live ? v : 0.f;
  if (relu) v = fmaxf(v, 0.f);
  return v * scale;
}

// One layer.  Work items are (row b * R + r, tile of `tile` positions);
// each block takes items blockIdx.x, blockIdx.x + gridDim.x, ...
// Shared memory: the weights [cin][K][d4], then cin staged rows of
// span = tile + (K - 1) * dil floats, then kSlack floats.
template <int K>
__global__ void __launch_bounds__(kThreads)
freq_conv_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
                 const Geom g, float scale) {
  extern __shared__ float4 smem4[];
  const int cin = static_cast<int>(g.f[kCin]);
  const int cout = static_cast<int>(g.f[kCout]);
  const int groups = (cout + 3) / 4;
  const int dil = static_cast<int>(g.f[kDil]);
  const int tile = static_cast<int>(g.f[kTile]);
  const int span = tile + (K - 1) * dil;
  const int half = (tile + 1) / 2;
  const long long P = g.f[kP];
  const long long lo = g.f[kLo];
  const long long period = g.f[kPeriod];
  const long long valid = g.f[kValid];
  const bool circular = g.f[kCircular] != 0;
  const bool relu = g.f[kRelu] != 0;
  const long long tiles = (P + tile - 1) / tile;
  const long long n_items = g.f[kBatch] * g.f[kRows] * tiles;

  float* ws = reinterpret_cast<float*>(smem4);
  float* xs = ws + cin * K * groups * 4;
  stage_weights(ws, w, K, cin, cout, groups * 4, g.f[kWj], g.f[kWc], g.f[kWd]);
  for (int i = threadIdx.x; i < kSlack; i += kThreads) xs[cin * span + i] = 0.f;

  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const long long br = item / tiles;
    const long long p_start = (item - br * tiles) * tile;
    const long long b = br / g.f[kRows];
    const long long r = br - b * g.f[kRows];
    const float* xrow = x + b * g.f[kXb] + r * g.f[kXr];
    float* yrow = y + b * g.f[kYb] + r * g.f[kYr];

    __syncthreads();  // the previous item's reads of xs are done
    // staged entry s of channel c holds position p_start + s - lo
    for (int i = threadIdx.x; i < cin * span; i += kThreads) {
      const int c = i / span;
      const int s = i - c * span;
      long long q = p_start + s - lo;
      float v = 0.f;
      if (circular) {
        q %= P;
        if (q < 0) q += P;
        v = __ldg(xrow + q * g.f[kXp] + c * g.f[kXc]);
      } else if (q >= 0 && q < P) {
        v = __ldg(xrow + q * g.f[kXp] + c * g.f[kXc]);
      }
      xs[i] = v;
    }
    __syncthreads();

    const int items = groups * half;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int gi = it / half;
      const int p0 = it - gi * half;
      const long long pa = p_start + p0;
      const long long pb = pa + half;
      if (pa >= P) continue;
      const bool has_b = p0 + half < tile && pb < P;
      const bool live_a = period == 0 || pa % period < valid;
      const bool live_b = has_b && (period == 0 || pb % period < valid);
      float a0[4], a1[4];
      if (live_a || live_b) {
        conv_item<K>(xs + p0, span, reinterpret_cast<const float4*>(ws), groups, gi, cin, dil,
                     half, a0, a1);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) a0[k] = a1[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = gi * 4 + k;
        if (d < cout) {
          yrow[pa * g.f[kYp] + d * g.f[kYd]] = epilogue(a0[k], live_a, relu, scale);
          if (has_b) yrow[pb * g.f[kYp] + d * g.f[kYd]] = epilogue(a1[k], live_b, relu, scale);
        }
      }
    }
  }
}

// `depth` chained layers on x [C, N] (contiguous) -> y [C, N]; one block per
// frame of `frame` lanes, of which lanes [0, valid) are live.  Shared
// memory: the weights [C][K][c4], then two buffers of C rows of
// xrow = lo + valid + (K - 1 - lo) floats and kSlack floats each; entry s of
// a row holds lane s - lo of the frame.
template <int K>
__global__ void __launch_bounds__(kThreads)
freq_conv_stack_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ y, int C, long long N, int frame, int valid, int lo,
                       int depth, long long wj, long long wc, long long wd, float scale) {
  extern __shared__ float4 smem4[];
  const int groups = (C + 3) / 4;
  const int hi = K - 1 - lo;
  const int xrow = lo + valid + hi;
  const int buf = C * xrow + kSlack;
  const int half = (valid + 1) / 2;
  float* ws = reinterpret_cast<float*>(smem4);
  float* in = ws + C * K * groups * 4;
  float* out = in + buf;
  const long long base = static_cast<long long>(blockIdx.x) * frame;

  stage_weights(ws, w, K, C, C, groups * 4, wj, wc, wd);
  // layer 1's input, its halo wrapped over N as the probes' roll wraps
  for (int i = threadIdx.x; i < C * xrow; i += kThreads) {
    const int c = i / xrow;
    const int s = i - c * xrow;
    long long q = (base + s - lo) % N;
    if (q < 0) q += N;
    in[i] = __ldg(x + c * N + q);
  }
  for (int i = threadIdx.x; i < kSlack; i += kThreads) in[C * xrow + i] = 0.f;
  for (int i = threadIdx.x; i < buf; i += kThreads) out[i] = 0.f;
  __syncthreads();

  const int items = groups * half;
  for (int l = 0; l < depth; ++l) {
    const bool last = l == depth - 1;
    if (l == 1) {
      // `out` held layer 1's input: zero its halo, which from here on
      // stands for masked lanes of the neighbouring frames
      for (int i = threadIdx.x; i < C * (lo + hi); i += kThreads) {
        const int c = i / (lo + hi);
        const int s = i - c * (lo + hi);
        out[c * xrow + (s < lo ? s : valid + s)] = 0.f;
      }
    }
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int gi = it / half;
      const int p0 = it - gi * half;
      const bool has_b = p0 + half < valid;
      float a0[4], a1[4];
      conv_item<K>(in + p0, xrow, reinterpret_cast<const float4*>(ws), groups, gi, C, 1, half,
                   a0, a1);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = gi * 4 + k;
        if (d >= C) continue;
        const float v0 = fmaxf(a0[k], 0.f) * scale;
        const float v1 = fmaxf(a1[k], 0.f) * scale;
        if (last) {
          y[d * N + base + p0] = v0;
          if (has_b) y[d * N + base + p0 + half] = v1;
        } else {
          out[d * xrow + lo + p0] = v0;
          if (has_b) out[d * xrow + lo + p0 + half] = v1;
        }
      }
    }
    __syncthreads();
    float* t = in;
    in = out;
    out = t;
  }
  // the masked lanes of every channel
  const int pad = frame - valid;
  for (int i = threadIdx.x; i < C * pad; i += kThreads) {
    const int c = i / pad;
    y[c * N + base + valid + (i - c * pad)] = 0.f;
  }
}

template <int K>
int launch_conv(const float* x, const float* w, float* y, const Geom& g, float scale,
                cudaStream_t stream) {
  const int cin = static_cast<int>(g.f[kCin]);
  const int groups = (static_cast<int>(g.f[kCout]) + 3) / 4;
  const int span = static_cast<int>(g.f[kTile] + (K - 1) * g.f[kDil]);
  const size_t smem = sizeof(float) * (static_cast<size_t>(cin) * K * groups * 4 +
                                       static_cast<size_t>(cin) * span + kSlack);
  cudaError_t err = cudaFuncSetAttribute(freq_conv_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, freq_conv_kernel<K>, kThreads,
                                                           smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (g.f[kP] + g.f[kTile] - 1) / g.f[kTile];
  const long long n_items = g.f[kBatch] * g.f[kRows] * tiles;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(n_items < resident ? n_items : resident);
  freq_conv_kernel<K><<<grid, kThreads, smem, stream>>>(x, w, y, g, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_stack(const float* x, const float* w, float* y, int C, long long N, int frame,
                 int valid, int lo, int depth, long long wj, long long wc, long long wd,
                 float scale, cudaStream_t stream) {
  const int groups = (C + 3) / 4;
  const int xrow = valid + K - 1;
  const size_t smem = sizeof(float) * (static_cast<size_t>(C) * K * groups * 4 +
                                       2 * (static_cast<size_t>(C) * xrow + kSlack));
  cudaError_t err = cudaFuncSetAttribute(freq_conv_stack_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  freq_conv_stack_kernel<K><<<static_cast<unsigned>(N / frame), kThreads, smem, stream>>>(
      x, w, y, C, N, frame, valid, lo, depth, wj, wc, wd, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One layer on `stream`.  `geom` is a host array of kFields int64 (see
// Field); `k` is the number of taps.  Returns the CUDA error code of the
// launch (0 on success); never synchronises.
extern "C" int freq_conv_forward(const float* x, const float* w, float* y, const long long* geom,
                                 int k, float scale, void* stream) {
  Geom g;
  memcpy(g.f, geom, sizeof(g.f));
  if (g.f[kBatch] < 1 || g.f[kRows] < 1 || g.f[kP] < 1 || g.f[kCin] < 1 || g.f[kCout] < 1 ||
      g.f[kDil] < 1 || g.f[kTile] < 1 || g.f[kPeriod] < 0 ||
      (g.f[kPeriod] > 0 && (g.f[kValid] < 0 || g.f[kValid] > g.f[kPeriod])))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define FREQ_CONV_CASE(K) \
  case K: return launch_conv<K>(x, w, y, g, scale, s);
    FREQ_CONV_CASE(1) FREQ_CONV_CASE(2) FREQ_CONV_CASE(3) FREQ_CONV_CASE(4) FREQ_CONV_CASE(5)
    FREQ_CONV_CASE(6) FREQ_CONV_CASE(7) FREQ_CONV_CASE(8) FREQ_CONV_CASE(9) FREQ_CONV_CASE(10)
    FREQ_CONV_CASE(11) FREQ_CONV_CASE(12) FREQ_CONV_CASE(13)
#undef FREQ_CONV_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// `depth` chained layers on `stream`: x, y [C, N] contiguous, w [K, C, C]
// with element strides (wj, wc, wd).  Needs N % frame == 0, lo <= frame -
// valid and valid + K - 1 - lo <= frame, so that after layer 1 every halo
// lane is a masked lane.  Returns the CUDA error code of the launch.
extern "C" int freq_conv_stack_forward(const float* x, const float* w, float* y, int C,
                                       long long N, int frame, int valid, int k, int lo,
                                       int depth, long long wj, long long wc, long long wd,
                                       float scale, void* stream) {
  if (C < 1 || frame < 1 || N < frame || N % frame != 0 || valid < 1 || depth < 1 || lo < 0 ||
      lo > k - 1 || lo > frame - valid || valid + k - 1 - lo > frame)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define FREQ_CONV_STACK_CASE(K) \
  case K: return launch_stack<K>(x, w, y, C, N, frame, valid, lo, depth, wj, wc, wd, scale, s);
    FREQ_CONV_STACK_CASE(1) FREQ_CONV_STACK_CASE(2) FREQ_CONV_STACK_CASE(3)
    FREQ_CONV_STACK_CASE(4) FREQ_CONV_STACK_CASE(5) FREQ_CONV_STACK_CASE(6)
    FREQ_CONV_STACK_CASE(7) FREQ_CONV_STACK_CASE(8) FREQ_CONV_STACK_CASE(9)
    FREQ_CONV_STACK_CASE(10) FREQ_CONV_STACK_CASE(11) FREQ_CONV_STACK_CASE(12)
    FREQ_CONV_STACK_CASE(13)
#undef FREQ_CONV_STACK_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* freq_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
