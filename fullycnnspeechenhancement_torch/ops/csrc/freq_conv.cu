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
// (p % period < valid), ReLU, a scale.  `freq_conv` is one such layer;
// `freq_conv_stack` is a chain of them (micro_pallas_roll.py `k3`,
// micro_pallas_roll2.py `mk_stack`).
//
// freq_conv: what bounds it on an H100.  Per layer it is a GEMM of
// (positions) x (C * K) x (D), run on the tensor cores in 3xTF32 (three
// TF32 products for each float32 one, at the data sheet's 495 TFLOP/s).
// The K = 11 probes ([1, 64, 129, 25] -> 25 channels, and the roll
// layout [32, 64 * 256]) are bound by operations, at under a microsecond
// (0.67 us for micro_pallas_conv.py's), the K = 1 probes by bytes (0.49
// us); a launch and its latency cost more than either.  V2's 14 inner
// layers at 64 x 8 s need 2.3781e11 FLOP (1.441 ms in 3xTF32) but, one
// launch per layer, read each input and write each output once: about
// 8.0e9 bytes, 2.39 ms at 3.35 TB/s, so their sum is bound by bytes (its
// wide layers by operations, its narrow ones by bytes).
//
// What the design does about it.
// - Tensor cores at float32 accuracy: mma.sync.m16n8k8 TF32 with M =
//   positions (m16 tiles), N = D (n8 tiles, up to four a pass), K = C * K
//   taps, tap-outer and channel-inner, in k8 chunks (zero weights past the
//   end).  Each operand is split into big (x rounded to TF32 by adding half
//   an ulp and clearing the 13 low mantissa bits) and small (x - big,
//   exact, rounded the same way), and each tile accumulates small*big,
//   big*small, big*big.  Rounding, not truncation: the errors then do not
//   all lean one way, which matters in a chain of 16 layers of positive
//   sums (phase 14 of chip_smoke.py).  The tensor cores truncate as they
//   accumulate, so each tile's sums are added into float32 registers every
//   kFlushChunks chunks (64 K positions).
// - Weights split once per block, in fragment order: a block copies w
//   (through any strides) into shared memory as each lane's (b0, b1)
//   pairs, then splits them in place into float4 (big b0, big b1, small
//   b0, small b1), so a B fragment is one 16-byte load and costs the mma
//   loop no arithmetic.  No second launch packs them: every call may pass
//   w with other strides.
// - No im2col copy: a block stages the C input rows of its tile with their
//   halo (zeros, or wrapped over P) in shared memory, and an offset table
//   gives each k its place (c * cs + j * dil * ps), so the tap shift,
//   dilation included, is an address offset.  The staging's fast index
//   follows x's smaller stride: channel-major rows of span = tile +
//   (K - 1) * dil floats (ps = 1, cs = row stride, 8 or 24 mod 32) for
//   NCHW and the roll layout, position-major rows of C floats (cs = 1,
//   ps = row stride, 4 mod 8) for NHWC, so the copies are coalesced and an
//   A fragment whose four k lie in one tap hits 32 distinct banks.
// - All copies into shared memory are 4-byte cp.async, zero-filled off the
//   row by the copy's src-size.  Loads into registers, then stores, took
//   more instructions per float and ran slower on the H100 (PERF.md).
// - A launch that fills the card (ops/freq_conv.py::freq_conv_plan): one
//   warp per m16 tile and share of the k8 chunks, tiles cut so every probe
//   launches at least one block per SM and the K split fills each block
//   to nine warps (the probes' blocks are bound by the latency of few
//   warps, not by the tensor cores).  On 129-bin rows with at most 24
//   output channels a warp takes two m16 tiles, which share each B
//   fragment: the mma loop is bound by shared-memory bandwidth, and B's
//   16-byte loads are most of it.  An m16 tile (or pair) whose positions
//   are all masked is not multiplied (7 of each 256-lane frame of the
//   roll layout) and is written as zeros.  Where the items far outnumber
//   the blocks the card holds (V2's 31,936 rows), blocks are persistent:
//   each stages its weights once and the next item's input while it
//   computes this one (two buffers).
// - A light launch: the plan is cached per geometry by the wrapper;
//   cudaFuncSetAttribute runs once per instantiation and shared-memory
//   size; no occupancy or device query per call.
//
// freq_conv_stack runs `depth` layers with the same [K, C, C] weights on
// the flat roll layout [C, N] (frames of `frame` lanes, the first `valid`
// of them live), with the mask, ReLU and scale after every layer.  One
// block owns one frame: it keeps the frame's activations in two
// shared-memory buffers (ping-pong), so the chain reads device memory once
// and writes it once.  Layer 1 reads its halo from the neighbouring
// frames, circularly over N, as the probes' roll does; after the mask the
// pad lanes are zero, so later layers see zero halos.  Its sums are
// float32 SIMT (4 output channels at 2 positions a thread).
//
// Both kernels launch on the caller's stream, never synchronise and
// allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// -- freq_conv ---------------------------------------------------------------

constexpr int kMaxWarps = 9;   // warps a block: m16 tiles x K splits
constexpr int kMaxNT = 4;      // n8 tiles a warp accumulates at once
constexpr int kFlushChunks = 8;
constexpr int kSplitRound = 4;  // fragment slots a thread splits per round
constexpr int kMaxDevices = 64;

// The geometry and plan of one launch, as an array of int64 filled by
// ops/freq_conv.py in this order.
enum Field {
  kRows, kRowsPerBatch, kP, kCin, kCout, kTaps,
  kXb, kXr, kXp, kXc,  // element strides of x as [B, R, P, C]
  kYb, kYr, kYp, kYd,  // of y as [B, R, P, D]
  kWj, kWc, kWd,       // of w as [K, C, D]
  kLo, kDil, kCircular, kPeriod, kValid, kRelu,
  kTile, kItemsPerRow, kItems, kChanMajor, kRowStride, kSpan,
  kChunks, kGroups, kKSplit, kBufFloats, kBuffers, kGrid, kBlockThreads, kSmemBytes,
  kFields
};

struct Conv {
  long long P, xb, xr, xp, xc, yb, yr, yp, yd, wj, wc, wd, period, valid;
  int rows_per_batch, items, items_per_row, C, D, K, lo, dil, circular, relu;
  int tile, mtiles, mwarps, ksplit, chan_major, row_stride, span, chunks, groups, buf_floats,
      buffers;
};

// big = x rounded to TF32 (half an ulp added, 13 low mantissa bits
// cleared), small = the same of x - big (exact); x = big + small +
// O(2^-22 |x|), and the errors lean neither way.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4-byte copy to shared memory; src_bytes 0 writes a zero.
__device__ __forceinline__ void copy4(float* dst, const float* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void copy_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// The tables of k = j * C + c (tap-outer, channel-inner): off[k] = c * cs +
// j * dil * ps, the place of (tap j, channel c) in a staged buffer relative
// to the output position, and woff[k] = j * wj + c * wc, its row of w.
// Padded k repeat the last offset (their weights are zero).
__device__ void build_tables(int* off, long long* woff, const Conv& c) {
  const int ps = c.chan_major ? 1 : c.row_stride;
  const int cs = c.chan_major ? c.row_stride : 1;
  const int kc = c.C * c.K;
  for (int k = threadIdx.x; k < 8 * c.chunks; k += blockDim.x) {
    const int j = min(k, kc - 1) / c.C, ch = min(k, kc - 1) - j * c.C;
    off[k] = ch * cs + j * c.dil * ps;
    woff[k] = j * c.wj + ch * c.wc;
  }
}

// Copies w into `raw` in fragment order, unsplit: slot ((ng * chunks + ch)
// * NT + n) * 32 + lane holds (B[k0][d], B[k0 + 4][d]) for k0 = 8ch + t,
// d = 8 (ng * NT + n) + g, zeros past C * K and D.
template <int NT>
__device__ void copy_weights(float2* raw, const float* __restrict__ w, const long long* woff,
                             const Conv& c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3, kc = c.C * c.K;
  for (int ng = 0; ng < c.groups; ++ng) {
    for (int ch = warp; ch < c.chunks; ch += nw) {
      const int k0 = 8 * ch + t, k1 = k0 + 4;
      const float* w0 = w + (k0 < kc ? woff[k0] : 0);
      const float* w1 = w + (k1 < kc ? woff[k1] : 0);
      float2* slot = raw + (ng * c.chunks + ch) * NT * 32 + lane;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int d = 8 * (ng * NT + n) + g;
        const long long dd = d < c.D ? d * c.wd : 0;
        float* dst = reinterpret_cast<float*>(slot + n * 32);
        copy4(dst, w0 + dd, k0 < kc && d < c.D ? 4 : 0);
        copy4(dst + 1, w1 + dd, k1 < kc && d < c.D ? 4 : 0);
      }
    }
  }
}

// Splits the fragments in place: raw slot f (upper half of the region) ->
// float4 (big b0, big b1, small b0, small b1) at slot f.  An output slot f
// overwrites raw slots below f only, so each round reads its slots into
// registers, waits for the block, then writes.
__device__ void split_weights(float4* frag, int slots) {
  const float2* raw = reinterpret_cast<const float2*>(frag) + slots;
  for (int base = 0; base < slots; base += kSplitRound * blockDim.x) {
    float2 r[kSplitRound];
#pragma unroll
    for (int i = 0; i < kSplitRound; ++i) {
      const int f = base + i * blockDim.x + threadIdx.x;
      r[i] = f < slots ? raw[f] : make_float2(0.f, 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSplitRound; ++i) {
      const int f = base + i * blockDim.x + threadIdx.x;
      uint32_t b0, b1, s0, s1;
      split_tf32(r[i].x, b0, s0);
      split_tf32(r[i].y, b1, s1);
      if (f < slots)
        frag[f] = make_float4(__uint_as_float(b0), __uint_as_float(b1), __uint_as_float(s0),
                              __uint_as_float(s1));
    }
    __syncthreads();
  }
}

// Position q of a row (any integer) -> its element offset along P, and
// whether it holds data (a zero boundary has none outside [0, P)).
__device__ __forceinline__ bool locate(long long q, const Conv& c, long long& at) {
  if (q < 0 || q >= c.P) {
    if (!c.circular) return false;
    q %= c.P;
    if (q < 0) q += c.P;
  }
  at = q * c.xp;
  return true;
}

// The input of one item into `buf`: staged entry s of channel ch holds
// position p0 - lo + s, at ch * row_stride + s (channel-major: warps over
// channels, lanes over positions) or s * row_stride + ch (position-major:
// warps over positions, lanes over channels), so lanes copy along x's
// smaller stride.
__device__ void stage_input(float* buf, const float* __restrict__ x, const Conv& c, int row,
                            long long p0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int b = row / c.rows_per_batch;
  const float* xr = x + b * c.xb + (row - b * c.rows_per_batch) * c.xr;
  const long long q0 = p0 - c.lo;
  if (c.chan_major) {
    for (int s = lane; s < c.span; s += 32) {
      long long at = 0;
      const int bytes = locate(q0 + s, c, at) ? 4 : 0;
      const float* src = xr + at;
      for (int ch = warp; ch < c.C; ch += nw)
        copy4(buf + ch * c.row_stride + s, src + ch * c.xc, bytes);
    }
  } else {
    for (int s = warp; s < c.span; s += nw) {
      long long at = 0;
      const int bytes = locate(q0 + s, c, at) ? 4 : 0;
      const float* src = xr + at;
      for (int ch = lane; ch < c.C; ch += 32)
        copy4(buf + s * c.row_stride + ch, src + ch * c.xc, bytes);
    }
  }
}

__device__ __forceinline__ bool is_live(long long p, const Conv& c) {
  return c.period == 0 || p % c.period < c.valid;
}

// One layer.  Items are (row, tile of `tile` positions), row-major; block
// i takes items i, i + gridDim.x, ...  Warp w = (wm, ks), wm = w % mwarps,
// computes the MB m16 tiles wm, wm + mwarps, ... of the item over K split
// ks = w / mwarps (MB > 1 only without a split): the MB tiles share each B
// fragment load.  The other splits add their sums into split 0's through
// shared memory, and split 0 writes the tiles through y's strides.  A
// warp whose tiles hold no live position gets no products and writes
// zeros; a tile index past the item's is computed on tile wm's rows and
// not written.  Shared memory: the weight fragments (float4 [groups *
// chunks * NT * 32]), the offsets [kpad], `buffers` input buffers of
// buf_floats, and the split sums.  With two buffers the next item's
// copies fly while this one is computed.
template <int NT, int MB>
__global__ void __launch_bounds__(32 * ((kMaxWarps + MB - 1) / MB), 2)
freq_conv_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
                 const Conv c, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int slots = c.groups * c.chunks * NT * 32;
  float4* frag = reinterpret_cast<float4*>(sm);
  int* off = reinterpret_cast<int*>(sm + 4 * slots);
  float* const buf0 = sm + 4 * slots + 8 * c.chunks;
  float* const red = buf0 + c.buffers * c.buf_floats;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % c.mwarps, ks = warp / c.mwarps;

  // Tables; then the weights and item 0's input in flight together; then
  // the split.  woff lives in the fragments' lower half until the split.
  build_tables(off, reinterpret_cast<long long*>(sm), c);
  __syncthreads();
  copy_weights<NT>(reinterpret_cast<float2*>(sm) + slots, w, reinterpret_cast<long long*>(sm), c);
  int item = blockIdx.x;
  int row = item / c.items_per_row;
  long long p0 = static_cast<long long>(item - row * c.items_per_row) * c.tile;
  stage_input(buf0, x, c, row, p0);
  copy_commit();
  copy_wait_all();
  __syncthreads();
  split_weights(frag, slots);

  const int per_split = (c.chunks + c.ksplit - 1) / c.ksplit;
  const int ch_begin = ks * per_split;
  const int ch_end = min(c.chunks, ch_begin + per_split);
  const int ps = c.chan_major ? 1 : c.row_stride;
  for (int cur = 0;; cur ^= 1) {
    const int next = item + gridDim.x;
    const bool more = next < c.items;
    int row_n = 0;
    long long p0_n = 0;
    if (more) {
      row_n = next / c.items_per_row;
      p0_n = static_cast<long long>(next - row_n * c.items_per_row) * c.tile;
      stage_input(buf0 + (cur ^ 1) * c.buf_floats, x, c, row_n, p0_n);
      copy_commit();
    }
    // tile i: positions pa[i] (rows g) and pa[i] + 8
    const float* a[MB];
    long long pa[MB];
    bool real[MB], live_a[MB], live_b[MB];
    bool any = false;
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      const int mt = wm + i * c.mwarps;
      const long long pm = p0 + 16 * mt;
      real[i] = mt < c.mtiles && pm < c.P;
      const long long p = pm + (lane & 15);
      bool live = real[i];
      if (c.period) live = __any_sync(0xffffffffu, real[i] && p < c.P && is_live(p, c)) != 0;
      any = any || live;
      a[i] = buf0 + cur * c.buf_floats + (16 * (real[i] ? mt : wm) + g) * ps;
      pa[i] = pm + g;
      live_a[i] = is_live(pa[i], c);
      live_b[i] = is_live(pa[i] + 8, c);
    }
    const int b = row / c.rows_per_batch;
    float* yrow = y + b * c.yb + (row - b * c.rows_per_batch) * c.yr;
    for (int ng = 0; ng < c.groups; ++ng) {
      float sum[MB][NT][4];
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[i][n][e] = 0.f;
      if (any) {
        const float4* fg = frag + ng * c.chunks * NT * 32 + lane;
        for (int c0 = ch_begin; c0 < ch_end; c0 += kFlushChunks) {
          const int c1 = min(c0 + kFlushChunks, ch_end);
          float acc[MB][NT][4];
#pragma unroll
          for (int i = 0; i < MB; ++i)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
#pragma unroll 2
          for (int ch = c0; ch < c1; ++ch) {
            // A[m][k] = buf[off[k] + m * ps]; this lane's k are 8ch + t, + 4
            const int o0 = off[8 * ch + t], o1 = off[8 * ch + t + 4];
            float4 bf[NT];
#pragma unroll
            for (int n = 0; n < NT; ++n) bf[n] = fg[(ch * NT + n) * 32];
#pragma unroll
            for (int i = 0; i < MB; ++i) {
              uint32_t ab[4], as[4];
              split_tf32(a[i][o0], ab[0], as[0]);           // (g, t)
              split_tf32(a[i][o0 + 8 * ps], ab[1], as[1]);  // (g + 8, t)
              split_tf32(a[i][o1], ab[2], as[2]);           // (g, t + 4)
              split_tf32(a[i][o1 + 8 * ps], ab[3], as[3]);  // (g + 8, t + 4)
              // one pass of each product over all n tiles before the next
#pragma unroll
              for (int n = 0; n < NT; ++n)
                mma_tf32(acc[i][n], as, __float_as_uint(bf[n].x), __float_as_uint(bf[n].y));
#pragma unroll
              for (int n = 0; n < NT; ++n)
                mma_tf32(acc[i][n], ab, __float_as_uint(bf[n].z), __float_as_uint(bf[n].w));
#pragma unroll
              for (int n = 0; n < NT; ++n)
                mma_tf32(acc[i][n], ab, __float_as_uint(bf[n].x), __float_as_uint(bf[n].y));
            }
          }
#pragma unroll
          for (int i = 0; i < MB; ++i)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) sum[i][n][e] += acc[i][n][e];
        }
      }
      if (c.ksplit > 1) {  // then groups == 1 and MB == 1: every warp reaches these barriers
        float* mine = red + ((ks - 1) * c.mwarps + wm) * (NT * 4 * 32) + lane;
        if (ks > 0)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32] = sum[0][n][e];
        __syncthreads();
        if (ks == 0)
          for (int s = 1; s < c.ksplit; ++s) {
            const float* theirs = red + ((s - 1) * c.mwarps + wm) * (NT * 4 * 32) + lane;
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) sum[0][n][e] += theirs[(n * 4 + e) * 32];
          }
        __syncthreads();
      }
      // C element e of n tile n of tile i: position pa[i] (+ 8 for e >= 2),
      // channel 8 * (ng * NT + n) + 2t + (e & 1)
      if (ks == 0) {
#pragma unroll
        for (int i = 0; i < MB; ++i) {
          if (!real[i]) continue;
          float* yt = yrow + pa[i] * c.yp + 2 * t * c.yd;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int d = 8 * (ng * NT + n) + 2 * t + (e & 1);
              const long long p = pa[i] + (e >> 1) * 8;
              if (p < c.P && d < c.D) {
                float v = (e < 2 ? live_a[i] : live_b[i]) ? sum[i][n][e] : 0.f;
                if (c.relu) v = fmaxf(v, 0.f);
                yt[(e >> 1) * 8 * c.yp + (8 * (ng * NT + n) + (e & 1)) * c.yd] = v * scale;
              }
            }
        }
      }
    }
    if (!more) break;
    copy_wait_all();
    __syncthreads();  // the next buffer is in, and every read of this one is done
    item = next;
    row = row_n;
    p0 = p0_n;
  }
}

// The dynamic shared memory each instantiation has been allowed, per device.
int g_smem_set[kMaxDevices][kMaxNT + 1][2];

template <int NT, int MB>
cudaError_t allow_smem(int device, int smem) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int& set = g_smem_set[device][NT][MB - 1];
  if (smem <= set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      freq_conv_kernel<NT, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) set = smem;
  return err;
}

template <int NT, int MB>
int launch_conv(const float* x, const float* w, float* y, const long long* f, int device,
                float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(f[kSmemBytes]);
  cudaError_t err = allow_smem<NT, MB>(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Conv c;
  c.P = f[kP];
  c.xb = f[kXb], c.xr = f[kXr], c.xp = f[kXp], c.xc = f[kXc];
  c.yb = f[kYb], c.yr = f[kYr], c.yp = f[kYp], c.yd = f[kYd];
  c.wj = f[kWj], c.wc = f[kWc], c.wd = f[kWd];
  c.period = f[kPeriod];
  c.valid = f[kValid];
  c.rows_per_batch = static_cast<int>(f[kRowsPerBatch]);
  c.items = static_cast<int>(f[kItems]);
  c.items_per_row = static_cast<int>(f[kItemsPerRow]);
  c.C = static_cast<int>(f[kCin]);
  c.D = static_cast<int>(f[kCout]);
  c.K = static_cast<int>(f[kTaps]);
  c.lo = static_cast<int>(f[kLo]);
  c.dil = static_cast<int>(f[kDil]);
  c.circular = static_cast<int>(f[kCircular]);
  c.relu = static_cast<int>(f[kRelu]);
  c.tile = static_cast<int>(f[kTile]);
  c.mtiles = static_cast<int>(f[kTile] / 16);
  c.mwarps = (c.mtiles + MB - 1) / MB;
  c.ksplit = static_cast<int>(f[kKSplit]);
  c.chan_major = static_cast<int>(f[kChanMajor]);
  c.row_stride = static_cast<int>(f[kRowStride]);
  c.span = static_cast<int>(f[kSpan]);
  c.chunks = static_cast<int>(f[kChunks]);
  c.groups = static_cast<int>(f[kGroups]);
  c.buf_floats = static_cast<int>(f[kBufFloats]);
  c.buffers = static_cast<int>(f[kBuffers]);
  freq_conv_kernel<NT, MB><<<static_cast<unsigned>(f[kGrid]),
                             static_cast<unsigned>(f[kBlockThreads]), smem, stream>>>(x, w, y, c,
                                                                                       scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, int MB>
int conv_blocks_per_sm(int device, int threads, int smem, int* blocks) {
  cudaError_t err = allow_smem<NT, MB>(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, freq_conv_kernel<NT, MB>, threads, static_cast<size_t>(smem)));
}

// -- freq_conv_stack -----------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kSlack = 4;  // floats after the last staged row: discarded over-reads

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
// Field), `nt` the n8 tiles a warp accumulates at once (1..4), `mb` the
// m16 tiles it takes (1 or 2), `device` the CUDA device of the tensors.
// Returns the CUDA error code of the launch (0 on success); never
// synchronises.
extern "C" int freq_conv_forward(const float* x, const float* w, float* y, const long long* geom,
                                 int nt, int mb, int device, float scale, void* stream) {
  const long long* f = geom;
  const long long mwarps = (f[kTile] / 16 + mb - 1) / mb;
  if (f[kRows] < 1 || f[kRowsPerBatch] < 1 || f[kP] < 1 || f[kCin] < 1 || f[kCout] < 1 ||
      f[kTaps] < 1 || f[kDil] < 1 || f[kTile] < 16 || f[kTile] % 16 != 0 || f[kKSplit] < 1 ||
      mb < 1 || mb > 2 || mwarps * f[kKSplit] > (kMaxWarps + mb - 1) / mb ||
      f[kBlockThreads] != 32 * mwarps * f[kKSplit] ||
      (f[kKSplit] > 1 && (f[kGroups] != 1 || mb != 1)) || f[kPeriod] < 0 ||
      (f[kPeriod] > 0 && (f[kValid] < 0 || f[kValid] > f[kPeriod])) || f[kChunks] < 1 ||
      8 * f[kChunks] < f[kCin] * f[kTaps] || f[kGroups] < 1 ||
      8 * nt * f[kGroups] < f[kCout] || f[kGrid] < 1 || f[kGrid] > f[kItems] ||
      f[kItems] > 0x7fffffffLL || f[kItems] != f[kRows] * f[kItemsPerRow] || f[kBuffers] < 1 ||
      f[kBuffers] > 2 || (f[kBuffers] == 1 && f[kGrid] != f[kItems]))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt * 4 + mb - 1) {
#define FREQ_CONV_CASE(NT, MB) \
  case NT * 4 + MB - 1: return launch_conv<NT, MB>(x, w, y, f, device, scale, s);
    FREQ_CONV_CASE(1, 1) FREQ_CONV_CASE(2, 1) FREQ_CONV_CASE(3, 1) FREQ_CONV_CASE(4, 1)
    FREQ_CONV_CASE(1, 2) FREQ_CONV_CASE(2, 2) FREQ_CONV_CASE(3, 2) FREQ_CONV_CASE(4, 2)
#undef FREQ_CONV_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the freq_conv kernel with `nt` n8 tiles and `mb` m16 tiles a
// warp, `threads` threads and `smem` bytes of dynamic shared memory that one
// SM of `device` holds, into *blocks (the CUDA occupancy calculator:
// registers and shared memory).  Returns the CUDA error code.
extern "C" int freq_conv_blocks_per_sm(int nt, int mb, int device, int threads, int smem,
                                       int* blocks) {
  switch (nt * 4 + mb - 1) {
#define FREQ_CONV_CASE(NT, MB) \
  case NT * 4 + MB - 1: return conv_blocks_per_sm<NT, MB>(device, threads, smem, blocks);
    FREQ_CONV_CASE(1, 1) FREQ_CONV_CASE(2, 1) FREQ_CONV_CASE(3, 1) FREQ_CONV_CASE(4, 1)
    FREQ_CONV_CASE(1, 2) FREQ_CONV_CASE(2, 2) FREQ_CONV_CASE(3, 2) FREQ_CONV_CASE(4, 2)
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
