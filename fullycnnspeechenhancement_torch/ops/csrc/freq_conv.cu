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
// of them live), with the mask, ReLU and scale after every layer.  What
// bounds it on an H100: at roll2's shape (C = 32, 64 frames, K = 11) a
// chain of 16 needs 2.9166e9 FLOP (17.68 us in 3xTF32) and moves 4.24 MB
// once, so it is bound by operations; but a frame's layers are serial
// (layer l + 1 needs all of layer l), each layer is a small GEMM (129
// positions x 32 channels x 352), and 64 frames give one block a frame 64
// of the 132 SMs.  What the design does about it:
// - A cluster of blocks a frame (ops/freq_conv.py::stack_plan: two at
//   roll2's shape, 128 blocks): each computes its share of the output
//   channels as whole n8 tiles, with weights staged and split once for
//   the whole chain, and keeps all C channels of the frame in two
//   shared-memory buffers (ping-pong), so the chain reads device memory
//   once and writes it once.
// - Each layer is freq_conv's 3xTF32 GEMM (gemm_chunks): M = the frame's
//   positions (9 m16 tiles for 129 bins, rows past `valid` computed and
//   not written), N = the block's channels, K = C * taps through an offset
//   table; at roll2's shape a warp takes two m16 tiles, which share each B
//   fragment load (shared-memory bandwidth binds the mma loop), and one of
//   3 K splits: 15 warps.
// - The exchange: a block writes its outputs into its own buffer, then
//   sends each of its channel rows to every peer as one bulk copy
//   (cp.async.bulk shared::cta -> shared::cluster) that completes on the
//   peer's mbarrier; a thread's stores into a peer's shared memory wait on
//   one another, and a cluster barrier a layer left the SMs idle while the
//   last copy landed.  K runs over the block's own channels first, so a
//   layer multiplies those while the peers' rows are still in flight.  A
//   peer's rows arrive only after it has read its last input, so no
//   barrier guards the buffers.
// - Layer 1 reads its halo from the neighbouring frames, circularly over
//   N, as the probes' roll does; after the mask the pad lanes are zero, so
//   later layers see zero halos.  A block zeros the halo of its own rows
//   only: its peers' rows come with the halo they zeroed.  The last layer
//   writes y, and the masked lanes are written as zeros.
// - Where a block's share of the split weights and its buffers outgrow
//   shared memory (C > 50 at K = 11), the plan uses clusters of up to 8.
//
// Both kernels launch on the caller's stream, never synchronise and
// allocate nothing.

#include <cooperative_groups.h>
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
// d = 8 (ng * NT + n) + g, zeros past kc = C * K and D.
template <int NT>
__device__ void copy_weights(float2* raw, const float* __restrict__ w, const long long* woff,
                             int kc, int D, int chunks, int groups, long long wd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int ng = 0; ng < groups; ++ng) {
    for (int ch = warp; ch < chunks; ch += nw) {
      const int k0 = 8 * ch + t, k1 = k0 + 4;
      const float* w0 = w + (k0 < kc ? woff[k0] : 0);
      const float* w1 = w + (k1 < kc ? woff[k1] : 0);
      float2* slot = raw + (ng * chunks + ch) * NT * 32 + lane;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int d = 8 * (ng * NT + n) + g;
        const long long dd = d < D ? d * wd : 0;
        float* dst = reinterpret_cast<float*>(slot + n * 32);
        copy4(dst, w0 + dd, k0 < kc && d < D ? 4 : 0);
        copy4(dst + 1, w1 + dd, k1 < kc && d < D ? 4 : 0);
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

// The products of MB m16 tiles by NT n8 tiles over k8 chunks [ch_begin,
// ch_end), added into `sum`: A[m][k] = a[i][off[k] + m * ps] (a[i] points at
// row g of tile i), B from the split fragments `fg` (this lane's slot of
// chunk 0, n tile 0).  Each chunk adds small*big, big*small, big*big, one
// pass of each over all n tiles before the next; every kFlushChunks chunks
// the tensor cores' sums are added into `sum` in float32.
template <int MB, int NT>
__device__ __forceinline__ void gemm_chunks(float (&sum)[MB][NT][4], const float* const (&a)[MB],
                                            const int* off, const float4* fg, int ch_begin,
                                            int ch_end, int ps) {
  const int t = threadIdx.x & 3;
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

// Adds the K splits' sums into split 0's through `red` (a slot of MB * NT *
// 4 * 32 floats per warp of splits 1..), in split order.  Every warp of the
// block must call it: it holds two barriers.
template <int MB, int NT>
__device__ __forceinline__ void add_split_sums(float (&sum)[MB][NT][4], float* red, int ks,
                                               int ksplit, int mwarps, int wm) {
  constexpr int kSlot = MB * NT * 4 * 32;
  const int lane = threadIdx.x & 31;
  if (ks > 0) {
    float* mine = red + ((ks - 1) * mwarps + wm) * kSlot + lane;
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[((i * NT + n) * 4 + e) * 32] = sum[i][n][e];
  }
  __syncthreads();
  if (ks == 0)
    for (int s = 1; s < ksplit; ++s) {
      const float* theirs = red + ((s - 1) * mwarps + wm) * kSlot + lane;
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[i][n][e] += theirs[((i * NT + n) * 4 + e) * 32];
    }
  __syncthreads();
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
  copy_weights<NT>(reinterpret_cast<float2*>(sm) + slots, w, reinterpret_cast<long long*>(sm),
                   c.C * c.K, c.D, c.chunks, c.groups, c.wd);
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
      if (any)
        gemm_chunks<MB, NT>(sum, a, off, frag + ng * c.chunks * NT * 32 + lane, ch_begin, ch_end,
                            ps);
      // then groups == 1 and MB == 1: every warp reaches the barriers
      if (c.ksplit > 1) add_split_sums<MB, NT>(sum, red, ks, c.ksplit, c.mwarps, wm);
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

constexpr int kStackMaxWarps = 18;  // warps a block: m16 tile groups x K splits
constexpr int kStackMaxCluster = 8;  // the largest cluster the card takes without an opt-in

// The geometry and plan of one chain, as an array of int64 filled by
// ops/freq_conv.py in this order.
enum StackField {
  sC, sN, sFrame, sValid, sTaps, sLo,
  sWj, sWc, sWd,  // element strides of w as [K, C, D]
  sCluster, sTiles, sGroups, sMtiles, sUnits, sMwarps, sRounds, sKSplit,
  sChunks, sRowStride, sBufFloats, sGrid, sThreads, sSmemBytes,
  sFields
};

struct Stack {
  long long N, wj, wc, wd;
  int C, K, frame, valid, lo, depth;
  int cluster, tiles, groups, mtiles, units, mwarps, rounds, ksplit, chunks, row_stride,
      buf_floats;
};

// The chain's tables for the block whose channels are [d0, d0 + dn): k
// runs over those channels first (k < K * dn: tap k / dn, channel d0 + k %
// dn), then over the others, tap-outer and channel-inner in each part, so
// the chunks of this block's own channels need nothing from its peers.
// off[k] = c * row_stride + j, woff[k] = j * wj + c * wc; padded k repeat
// the last.
__device__ void build_stack_tables(int* off, long long* woff, const Stack& s, int d0, int dn) {
  const int kc = s.C * s.K, own = s.K * dn, rest = s.C - dn;
  for (int k = threadIdx.x; k < 8 * s.chunks; k += blockDim.x) {
    const int kk = min(k, kc - 1);
    int j, c;
    if (kk < own) {
      j = kk / dn;
      c = d0 + kk - j * dn;
    } else {
      j = (kk - own) / rest;
      c = kk - own - j * rest;
      if (c >= d0) c += dn;
    }
    off[k] = c * s.row_stride + j;
    woff[k] = j * s.wj + c * s.wc;
  }
}

// A block learns that its peers' rows of a layer are in through an
// mbarrier of its own shared memory, one per buffer: one arrival (its own,
// with the bytes it expects) and the bulk copies' bytes complete a phase.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `parity` to complete.  A copy that never comes
// traps after about 2^34 cycles (seconds) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t at = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(at), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// Copies `bytes` (16-byte aligned) of shared memory at `src` to the same
// place in block `rank` of the cluster, completing on that block's `bar`.
__device__ __forceinline__ void copy_to_peer(const float* src, uint64_t* bar, int rank,
                                             uint32_t bytes) {
  uint32_t dst, peer_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(smem_addr(src)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(peer_bar) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "r"(smem_addr(src)), "r"(bytes), "r"(peer_bar)
      : "memory");
}

// Zeros the halo entries of the channel rows [d0, d0 + dn) of `b` (entries
// [0, lo) and [lo + valid, valid + K - 1)): the masked lanes of the
// neighbouring frames.  The other rows of `b` come whole from the peers,
// by bulk copies that a write here would race.
__device__ void zero_halo(float* b, const Stack& s, int d0, int dn) {
  const int h = s.K - 1;
  for (int i = threadIdx.x; i < dn * h; i += blockDim.x) {
    const int c = d0 + i / h, e = i - (c - d0) * h;
    b[c * s.row_stride + (e < s.lo ? e : s.valid + e)] = 0.f;
  }
}

// `depth` chained layers on x [C, N] (contiguous) -> y [C, N].  One frame
// of `frame` lanes (the first `valid` live) per cluster of `cluster`
// blocks; block rank r computes output channels [8 r tiles, 8 (r + 1)
// tiles), as n8 tiles in `groups` passes of NT.  Every block keeps all C
// channels of the frame in two buffers (ping-pong): channel-major rows of
// row_stride floats, entry e of a row lane e - lo of the frame.  Layer 1
// reads buffer 0, staged with its halo wrapped over N; each layer writes
// its outputs (masked, ReLU, scaled) into the other buffer, then sends
// those rows to every peer (bulk copies onto the peer's mbarrier of that
// buffer); the last layer writes y.  Each layer is a GEMM: M = the frame's
// positions (m16 tiles), N = this block's channels, K = C * taps
// (gemm_chunks), the block's own channels first: a layer waits for its
// peers' rows only after it has multiplied its own.  Warp w = (wm, ks)
// takes units wm, wm + mwarps, ... (a unit is the MB tiles u, u + units,
// ...; a tile index past mtiles is computed on tile u's rows and not
// written) over K split ks.  Rows past valid read unstaged entries and are
// not written.  Shared memory: the weight fragments (float4 [groups *
// chunks * NT * 32]), the offsets, two buffers, the split sums, two
// mbarriers.
template <int NT, int MB>
__global__ void __launch_bounds__(32 * kStackMaxWarps)
freq_conv_stack_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ y, const Stack s, float scale) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float sm[];
  const int slots = s.groups * s.chunks * NT * 32;
  float4* frag = reinterpret_cast<float4*>(sm);
  int* off = reinterpret_cast<int*>(sm + 4 * slots);
  float* const buf = sm + 4 * slots + 8 * s.chunks;
  float* const red = buf + 2 * s.buf_floats;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(red + (s.ksplit - 1) * s.mwarps * MB * NT * 128);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % s.mwarps, ks = warp / s.mwarps;
  const int rank = blockIdx.x % s.cluster;
  const long long base = static_cast<long long>(blockIdx.x / s.cluster) * s.frame;
  const int d0 = 8 * s.tiles * rank;            // this block's first channel
  const int dn = min(s.C - d0, 8 * s.tiles);  // and its count
  const int rs = s.row_stride;

  // Tables; then the weights and layer 1's input in flight together, and
  // the zeros that need no input; then the split.  woff lives in the
  // fragments' lower half until the split.
  build_stack_tables(off, reinterpret_cast<long long*>(sm), s, d0, dn);
  __syncthreads();
  copy_weights<NT>(reinterpret_cast<float2*>(sm) + slots, w + d0 * s.wd,
                   reinterpret_cast<long long*>(sm), s.C * s.K, dn, s.chunks, s.groups, s.wd);
  for (int e = lane; e < s.valid + s.K - 1; e += 32) {
    long long q = (base + e - s.lo) % s.N;  // the probes' roll wraps over N
    if (q < 0) q += s.N;
    for (int c = warp; c < s.C; c += nw) copy4(buf + c * rs + e, x + c * s.N + q, 4);
  }
  copy_commit();
  zero_halo(buf + s.buf_floats, s, d0, dn);  // layer 2's input
  const int pad = s.frame - s.valid;
  for (int i = threadIdx.x; i < dn * pad; i += blockDim.x) {
    const int d = i / pad;
    y[(d0 + d) * s.N + base + s.valid + (i - d * pad)] = 0.f;  // masked lanes
  }
  copy_wait_all();
  __syncthreads();
  split_weights(frag, slots);
  const int row4 = (s.valid + s.K - 1 + 3) / 4;  // float4 of a row's live lanes and halo
  const uint32_t incoming = 16u * row4 * (s.C - dn);  // the peers' rows of a layer, in bytes
  cg::cluster_group cluster = cg::this_cluster();
  if (s.cluster > 1) {
    if (threadIdx.x == 0) {
      for (int b = 0; b < 2; ++b) {
        mbar_init(&bars[b]);
        mbar_expect(&bars[b], incoming);  // buffer 1 for layer 1's rows, 0 for layer 2's
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster.sync();  // the peers run, their mbarriers armed, before anything is sent
  }

  // K split ks takes its share of the own chunks [0, own) and of the
  // peers' chunks [own, chunks); a chunk that mixes both is a peers' one
  const int own = s.cluster > 1 ? s.K * dn / 8 : s.chunks;
  const int per_own = (own + s.ksplit - 1) / s.ksplit;
  const int per_peer = (s.chunks - own + s.ksplit - 1) / s.ksplit;
  const int own_begin = min(own, ks * per_own), own_end = min(own, own_begin + per_own);
  const int peer_begin = min(s.chunks, own + ks * per_peer);
  const int peer_end = min(s.chunks, peer_begin + per_peer);
  for (int l = 0; l < s.depth; ++l) {
    const float* in = buf + (l & 1) * s.buf_floats;
    const int out = ((l + 1) & 1) * s.buf_floats;
    const bool last = l == s.depth - 1;
    // layer 1 has read its halo: from here on it stands for masked lanes
    if (l == 1) zero_halo(buf, s, d0, dn);
    for (int r = 0; r < s.rounds; ++r) {
      const int u = wm + r * s.mwarps;
      const bool has = u < s.units;
      // tile i: positions pa[i] (rows g) and pa[i] + 8
      const float* a[MB];
      int pa[MB];
      bool real[MB];
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        const int mt = u + i * s.units;
        real[i] = has && mt < s.mtiles;
        a[i] = in + 16 * (real[i] ? mt : u) + g;
        pa[i] = 16 * mt + g;
      }
      for (int ng = 0; ng < s.groups; ++ng) {
        float sum[MB][NT][4];
#pragma unroll
        for (int i = 0; i < MB; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[i][n][e] = 0.f;
        const float4* fg = frag + ng * s.chunks * NT * 32 + lane;
        if (has) gemm_chunks<MB, NT>(sum, a, off, fg, own_begin, own_end, 1);
        // the peers' rows of the last layer are in from here on; the
        // mbarrier is armed again for the rows this buffer gets next
        if (l > 0 && s.cluster > 1 && r == 0 && ng == 0) {
          mbar_wait(&bars[l & 1], ((l - 1) >> 1) & 1);
          if (threadIdx.x == 0) mbar_expect(&bars[l & 1], incoming);
        }
        if (has) gemm_chunks<MB, NT>(sum, a, off, fg, peer_begin, peer_end, 1);
        if (s.ksplit > 1) add_split_sums<MB, NT>(sum, red, ks, s.ksplit, s.mwarps, wm);
        if (ks != 0 || !has) continue;
        // C element e of n tile n of tile i: position pa[i] (+ 8 for e >= 2),
        // channel d0 + 8 * (ng * NT + n) + 2t + (e & 1)
#pragma unroll
        for (int i = 0; i < MB; ++i) {
          if (!real[i]) continue;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int d = 8 * (ng * NT + n) + 2 * t + (e & 1);
              const int p = pa[i] + (e >> 1) * 8;
              if (p >= s.valid || d >= dn) continue;
              const float v = fmaxf(sum[i][n][e], 0.f) * scale;
              if (last)
                y[(d0 + d) * s.N + base + p] = v;
              else
                buf[out + (d0 + d) * rs + s.lo + p] = v;
            }
        }
      }
    }
    if (last) break;
    // this block's outputs are in, every read of its input is done, and
    // the bulk copies (the async proxy) see the outputs
    if (s.cluster > 1) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (s.cluster > 1) {
      // this block's rows, live lanes and halo, into its peers' buffers, one
      // bulk copy a row and peer, completing on the peer's mbarrier; the
      // float4 past the halo carries an unstaged entry that no written
      // position reads.  A peer's rows arrive only once it has read its
      // last input, and it sends them only after these came in.
      for (int i = threadIdx.x; i < (s.cluster - 1) * dn; i += blockDim.x) {
        const int q = 1 + i / dn, d = i - (q - 1) * dn;
        copy_to_peer(buf + out + (d0 + d) * rs, &bars[(l + 1) & 1], (rank + q) % s.cluster,
                     16u * row4);
      }
    }
  }
  // the peers have taken this block's last rows before it exits
  if (s.cluster > 1 && s.depth > 1) cluster.sync();
}

// The dynamic shared memory each stack instantiation has been allowed, per device.
int g_stack_smem_set[kMaxDevices][kMaxNT + 1][2];

template <int NT, int MB>
cudaError_t allow_stack_smem(int device, int smem) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int& set = g_stack_smem_set[device][NT][MB - 1];
  if (smem <= set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      freq_conv_stack_kernel<NT, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) set = smem;
  return err;
}

cudaLaunchConfig_t stack_config(int grid, int threads, int smem, int cluster, cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NT, int MB>
int launch_stack(const float* x, const float* w, float* y, const long long* f, int depth,
                 int device, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(f[sSmemBytes]);
  cudaError_t err = allow_stack_smem<NT, MB>(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Stack s;
  s.N = f[sN], s.wj = f[sWj], s.wc = f[sWc], s.wd = f[sWd];
  s.C = static_cast<int>(f[sC]);
  s.K = static_cast<int>(f[sTaps]);
  s.frame = static_cast<int>(f[sFrame]);
  s.valid = static_cast<int>(f[sValid]);
  s.lo = static_cast<int>(f[sLo]);
  s.depth = depth;
  s.cluster = static_cast<int>(f[sCluster]);
  s.tiles = static_cast<int>(f[sTiles]);
  s.groups = static_cast<int>(f[sGroups]);
  s.mtiles = static_cast<int>(f[sMtiles]);
  s.units = static_cast<int>(f[sUnits]);
  s.mwarps = static_cast<int>(f[sMwarps]);
  s.rounds = static_cast<int>(f[sRounds]);
  s.ksplit = static_cast<int>(f[sKSplit]);
  s.chunks = static_cast<int>(f[sChunks]);
  s.row_stride = static_cast<int>(f[sRowStride]);
  s.buf_floats = static_cast<int>(f[sBufFloats]);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = stack_config(static_cast<int>(f[sGrid]),
                                              static_cast<int>(f[sThreads]), smem, s.cluster,
                                              stream, &attr);
  err = cudaLaunchKernelEx(&cfg, freq_conv_stack_kernel<NT, MB>, x, w, y, s, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, int MB>
int stack_occupancy(int device, int threads, int smem, int cluster, int* blocks, int* clusters) {
  cudaError_t err = allow_stack_smem<NT, MB>(device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, freq_conv_stack_kernel<NT, MB>,
                                                      threads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = stack_config(cluster, threads, smem, cluster, 0, &attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, freq_conv_stack_kernel<NT, MB>, &cfg));
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
// through its strides.  `geom` is a host array of sFields int64 (see
// StackField), `nt` the n8 tiles of a pass (1..4), `mb` the m16 tiles a
// warp (1, or 2 with nt <= 2).  The geometry needs N % frame == 0, lo <=
// frame - valid and valid + K - 1 - lo <= frame, so that after layer 1
// every halo lane is a masked lane.  Returns the CUDA error code of the
// launch (a cluster the card refuses included); never synchronises.
extern "C" int freq_conv_stack_forward(const float* x, const float* w, float* y,
                                       const long long* geom, int nt, int mb, int depth,
                                       int device, float scale, void* stream) {
  const long long* f = geom;
  const long long C = f[sC], K = f[sTaps], frames = f[sN] / (f[sFrame] > 0 ? f[sFrame] : 1);
  const long long red = (f[sKSplit] - 1) * f[sMwarps] * mb * nt * 4 * 32;
  const long long need =
      4 * (4 * f[sGroups] * f[sChunks] * nt * 32 + 8 * f[sChunks] + 2 * f[sBufFloats] + red) + 16;
  if (C < 1 || K < 1 || f[sFrame] < 1 || f[sN] < f[sFrame] || f[sN] % f[sFrame] != 0 ||
      f[sValid] < 1 || f[sValid] > f[sFrame] || depth < 1 || f[sLo] < 0 || f[sLo] > K - 1 ||
      f[sLo] > f[sFrame] - f[sValid] || f[sValid] + K - 1 - f[sLo] > f[sFrame] ||
      f[sCluster] < 1 || f[sCluster] > kStackMaxCluster || f[sGrid] != f[sCluster] * frames ||
      f[sGrid] > 0x7fffffffLL || f[sTiles] < 1 || f[sGroups] < 1 ||
      nt * f[sGroups] < f[sTiles] || 8 * f[sCluster] * f[sTiles] < C ||
      8 * (f[sCluster] - 1) * f[sTiles] >= C || mb < 1 || mb > 2 || (mb == 2 && nt > 2) ||
      16 * f[sMtiles] < f[sValid] || f[sUnits] * mb < f[sMtiles] || f[sUnits] > f[sMtiles] ||
      f[sMwarps] < 1 || f[sRounds] * f[sMwarps] < f[sUnits] || f[sKSplit] < 1 ||
      f[sMwarps] * f[sKSplit] > kStackMaxWarps ||
      f[sThreads] != 32 * f[sMwarps] * f[sKSplit] || 8 * f[sChunks] < C * K ||
      f[sRowStride] < 16 * f[sMtiles] + K - 1 || f[sBufFloats] < C * f[sRowStride] ||
      f[sSmemBytes] < need)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt * 4 + mb - 1) {
#define FREQ_CONV_STACK_CASE(NT, MB) \
  case NT * 4 + MB - 1: return launch_stack<NT, MB>(x, w, y, f, depth, device, scale, s);
    FREQ_CONV_STACK_CASE(1, 1) FREQ_CONV_STACK_CASE(2, 1) FREQ_CONV_STACK_CASE(3, 1)
    FREQ_CONV_STACK_CASE(4, 1) FREQ_CONV_STACK_CASE(1, 2) FREQ_CONV_STACK_CASE(2, 2)
#undef FREQ_CONV_STACK_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the stack kernel with `nt` n8 tiles a pass and `mb` m16 tiles a
// warp, `threads` threads and `smem` bytes of dynamic shared memory that one
// SM of `device` holds, into *blocks, and the clusters of `cluster` blocks
// the card holds at once, into *clusters (the CUDA occupancy calculator).
// Returns the CUDA error code.
extern "C" int freq_conv_stack_occupancy(int nt, int mb, int device, int threads, int smem,
                                         int cluster, int* blocks, int* clusters) {
  switch (nt * 4 + mb - 1) {
#define FREQ_CONV_STACK_CASE(NT, MB)                                                  \
  case NT * 4 + MB - 1:                                                               \
    return stack_occupancy<NT, MB>(device, threads, smem, cluster, blocks, clusters);
    FREQ_CONV_STACK_CASE(1, 1) FREQ_CONV_STACK_CASE(2, 1) FREQ_CONV_STACK_CASE(3, 1)
    FREQ_CONV_STACK_CASE(4, 1) FREQ_CONV_STACK_CASE(1, 2) FREQ_CONV_STACK_CASE(2, 2)
#undef FREQ_CONV_STACK_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* freq_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
