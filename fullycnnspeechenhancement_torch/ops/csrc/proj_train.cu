// The final (1, kw) projection of the blocked training step
// (models/blocked.py, `apply_blocked`), forward and backward, on the
// blocked layout: x [rows = B*T][positions = NB*fb][C] (the last inner
// layer's output, the pad band past the real bins zero), one output channel
// y [rows][F], with TF SAME padding of lo = (kw - 1) / 2 taps:
//
//   forward:  y[r, f] = b + sum_{f', c} x[r, f', c] w[c, f' - f + lo]
//   dX:       dx[r, f', c] = sum_f dy[r, f] w[c, f' - f + lo]  (0 in the
//             pad band, f' >= F)
//   dW, db:   dw[c, j] = sum_{r, f} x[r, f + j - lo, c] dy[r, f],
//             db = sum_{r, f} dy[r, f]
//
// with taps outside [0, kw) zero.  Flattening (f', c) into k = f' C + c
// makes each of them a product against one Toeplitz band: the tap of
// (k, f) is wflat[k - f C + lo C], wflat[j C + c] = w[c, j] (0 outside
// [0, kw C)), so the forward is [rows, P C] x [P C, F], dX is [rows, F] x
// [F, P C] against the band's transpose, and dW the band's diagonal sums
// of the cross product G[k, f] = sum_r x[r, k] dy[r, f].
//
// It replaces no TPU kernel: the JAX package leaves the projection to
// XLA.  The port ran it through cuDNN, which took a padded channels-last
// copy of the unblocked [B, T, F, C] view to 257 bins and a generic engine
// with one output channel: 11.75 ms forward and 11.16 ms backward of a
// 47.2 ms training step at R-CED16's 64 x 384 frames in bf16 on an H100,
// 49% of the step, at 0.27% of the least time the card needs for it.
//
// What bounds it on an H100: bytes.  At C = 10 and 64 x 384 frames each of
// the three products is 6.13 GFLOP over real taps (18.6 us at 989 TFLOP/s
// for all three), while x (63 MB) is read by the forward and by dW and dX
// (63 MB) is written: 209 MB in all, 62 us at 3.35 TB/s.
//
// What the design does about it.
// - x and dX are read and written where they lie, in the blocked layout:
//   no unblocking slice, no pad to 257 bins, no permute.  x moves by
//   16-byte cp.async into shared-memory tiles a stage or two ahead of the
//   tensor cores; the TF SAME halo is the band's zeros, never a padded
//   copy.
// - The band is never stored: each block builds a table of wflat in shared
//   memory (a few KB) from w, and a B fragment of mma.sync m16n8k16 is one
//   32-bit load from it, since two consecutive k of one output bin are
//   consecutive taps (the forward); for dX's band, whose two consecutive k
//   lie C taps apart, the table holds the pair (wflat[i], wflat[i - C]).
// - Every (k chunk, n tile) pair of the band is computed, its zeros
//   included (a third more products than the taps that meet real inputs):
//   the products are far from bounding it, and skipping the pairs outside
//   the band made the loops branch, which took the forward from 0.059 to
//   0.110 ms and dW from 0.109 to 0.139 ms at 64 x 384 on an H100.
// - bf16 operands, float32 sums, each result rounded once; the bias is
//   added in the forward's epilogue.  Results go through shared memory
//   so that they leave in 16-byte stores: a forward block's rows of y
//   (one contiguous range), and each warp's 16 rows by 64 columns of dX
//   (0.087 ms with 4-byte stores from the fragments, 0.062 ms so).
// - dW splits the rows over blocks and the x columns over 128-column
//   tiles: a block's eight warps each hold a 16-column by 136-bin tile of G
//   in registers over its rows, then write it to shared memory, where each
//   thread adds the diagonals of its taps in a fixed order; a second
//   kernel adds the blocks' partial sums in block order, so a repeat gives
//   the same bits.  db is added by the first column tile's blocks from the
//   dy values they stage.
// - dy ([rows][F]: rows of F bf16, not 16-byte aligned one by one, but a
//   block's or a stage's rows are one aligned range) comes in 16-byte loads
//   through registers into zero-padded shared-memory rows of 144 bins, one
//   stage ahead in dW.
//
// Instances: F in (128, 136] (kTiles output tiles, kChunks k chunks of
// dX), C even and at most 64, P C a multiple of 8; the wrapper
// (ops/proj_train.py) checks the rest before a launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTiles = 17;                // n8 tiles over the output bins
constexpr int kChunks = 9;                // k16 chunks over the output bins (dX's K)
constexpr int kBins = kTiles * 8;         // 136
constexpr int kBinsK = kChunks * 16;      // 144
constexpr int kDyStride = kBinsK + 8;     // bf16 of a staged dy row
constexpr int kRows = 64;                 // rows of a forward or dX block: 4 warps of 16
constexpr int kThreads = 128;
constexpr int kStageK = 128;              // x columns of a forward stage
constexpr int kXStride = kStageK + 8;     // bf16 of a staged x row (forward and dW)
constexpr int kFwdStages = 3;
constexpr int kDxGroup = 8;               // n8 tiles of a dX accumulator group
constexpr int kDxTile = kDxGroup * 8 + 8; // bf16 of a row of a warp's dX tile
constexpr int kDwThreads = 256;           // 8 warps, an m16 tile of x columns each
constexpr int kDwCols = 128;              // x columns of a dW block
constexpr int kDwRows = 32;               // rows of a dW stage (2 k16 chunks)
constexpr int kDwStage = kDwRows * (kXStride + kDyStride);  // bf16 of a dW stage: x then dy
constexpr int kDxVecs = (kRows * kBins / 8 + kThreads - 1) / kThreads;       // dy vectors a dX thread stages
constexpr int kDwVecs = (kDwRows * kBins / 8 + kDwThreads - 1) / kDwThreads;  // the same a dW stage
constexpr int kGStride = kBins + 4;       // floats of a G row in shared memory
constexpr int kReduceThreads = 256;

static_assert(kDwCols == 16 * (kDwThreads / 32), "a warp of dW takes 16 x columns");

__device__ __forceinline__ float bf16_to_float(uint16_t v) { return __uint_as_float(static_cast<uint32_t>(v) << 16); }

__device__ __forceinline__ uint16_t float_to_bf16(float v) { return __bfloat16_as_ushort(__float2bfloat16(v)); }

__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

// wflat[idx] of w [C][kw] (bf16 bits): w[c][j] for idx = j C + c, 0 outside [0, kw C).
__device__ __forceinline__ uint16_t wtap(const uint16_t* __restrict__ w, int idx, int C, int kw) {
  if (idx < 0 || idx >= kw * C) return 0;
  const int j = idx / C;
  return __ldg(w + (idx - j * C) * kw + j);
}

// 16 bytes from global to shared memory, or zeros where `ok` is false
// (src-size 0: nothing is read).
__device__ __forceinline__ void copy16(uint16_t* dst, const uint16_t* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i .. 8i + 7 give the
// addresses of matrix i's rows; lane 4g + t receives in r[i] row g's
// columns 2t, 2t + 1 (or, transposed, column g's rows 2t, 2t + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint16_t* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint16_t* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// ---------------------------------------------------------------------------
// Forward: a block takes 64 rows, a warp 16 of them by all kTiles output
// tiles; x streams through a ring of kFwdStages stages of 128 columns.
// Shared memory: the ring, then the tap table wf [kpad + (kBins - 1) C].

__global__ void __launch_bounds__(kThreads) proj_train_fwd_kernel(
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ w, const uint16_t* __restrict__ bias,
    uint16_t* __restrict__ y, int rows, int C, int kp, int f_dim, int kw, int lo) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  uint16_t* wf = ring + kFwdStages * kRows * kXStride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int nstages = (kp + kStageK - 1) / kStageK;
  const int lo_c = lo * C;
  const int wf_lo = (kBins - 1 - lo) * C;  // wf[i] = wflat[i - wf_lo]

  auto load = [&](int s) {
    uint16_t* dst = ring + (s % kFwdStages) * kRows * kXStride;
    for (int q = tid; q < kRows * (kStageK / 8); q += kThreads) {
      const int row = q / (kStageK / 8), col = s * kStageK + (q % (kStageK / 8)) * 8;
      const bool ok = r0 + row < rows && col < kp;
      copy16(dst + row * kXStride + col - s * kStageK, ok ? x + (r0 + row) * kp + col : x, ok);
    }
  };
  for (int s = 0; s < kFwdStages - 1; ++s) {
    if (s < nstages) load(s);
    commit();
  }
  const int table = nstages * kStageK + (kBins - 1) * C;
  for (int i = tid; i < table; i += kThreads) wf[i] = wtap(w, i - wf_lo, C, kw);

  float acc[kTiles][4] = {};
  for (int s = 0; s < nstages; ++s) {
    if (s + kFwdStages - 1 < nstages) load(s + kFwdStages - 1);
    commit();
    wait_copies<kFwdStages - 1>();
    __syncthreads();
    const uint16_t* tile = ring + (s % kFwdStages) * kRows * kXStride;
    for (int kc = 0; kc < kStageK / 16; ++kc) {
      const int k0 = s * kStageK + kc * 16;
      if (k0 >= kp) break;
      uint32_t a[4];
      ldmatrix_x4(a, tile + (warp * 16 + (lane & 15)) * kXStride + kc * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const uint16_t* b = wf + k0 + 2 * t - (j * 8 + g) * C + lo_c + wf_lo;
        mma_bf16(acc[j], a, *reinterpret_cast<const uint32_t*>(b), *reinterpret_cast<const uint32_t*>(b + 8));
      }
    }
    __syncthreads();
  }
  wait_copies<0>();

  // The block's rows of y are one contiguous range: through shared memory
  // (over the ring), out in 16-byte stores.
  const float b = bf16_to_float(__ldg(bias));
  uint16_t* ys = ring;
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + g + 8 * h, f = j * 8 + 2 * t;
      if (f < f_dim) ys[row * f_dim + f] = float_to_bf16(acc[j][2 * h] + b);
      if (f + 1 < f_dim) ys[row * f_dim + f + 1] = float_to_bf16(acc[j][2 * h + 1] + b);
    }
  }
  __syncthreads();
  const long long count = (rows - r0 < kRows ? rows - r0 : kRows) * static_cast<long long>(f_dim);
  uint16_t* dst = y + r0 * f_dim;
  for (long long i = tid; i < count / 8; i += kThreads)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(ys)[i];
  for (long long i = count / 8 * 8 + tid; i < count; i += kThreads) dst[i] = ys[i];
}

// Eight values [e0, e0 + 8) of a flat range of `count` dy values from
// `src` (16-byte aligned), zero past count.
__device__ __forceinline__ uint4 load8(const uint16_t* __restrict__ src, int e0, int count) {
  if (e0 + 8 <= count) return __ldg(reinterpret_cast<const uint4*>(src + e0));
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint16_t lo = e0 + 2 * i < count ? __ldg(src + e0 + 2 * i) : 0;
    const uint16_t hi = e0 + 2 * i + 1 < count ? __ldg(src + e0 + 2 * i + 1) : 0;
    v[i] = pack(lo, hi);
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Puts the flat values [e0, e0 + 8) of dy rows of f_dim values into staged
// rows of kDyStride; returns their sum, added in order.
__device__ __forceinline__ float put8(uint16_t* ds, int e0, uint4 v, int f_dim) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  int row = e0 / f_dim, col = e0 - row * f_dim;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint16_t h = static_cast<uint16_t>(i & 1 ? words[i >> 1] >> 16 : words[i >> 1] & 0xffffu);
    ds[row * kDyStride + col] = h;
    sum += bf16_to_float(h);
    if (++col == f_dim) col = 0, ++row;
  }
  return sum;
}

// Zeros the staged columns [f_dim, kBinsK) of `n` rows.
__device__ __forceinline__ void zero_pad_bins(uint16_t* ds, int n, int f_dim, int tid, int threads) {
  const int pad = kBinsK - f_dim;
  for (int e = tid; e < n * pad; e += threads) ds[(e / pad) * kDyStride + f_dim + e % pad] = 0;
}

// uint32 words of dX's pair table, rounded up to a 16-byte boundary.
__host__ __device__ inline int dx_table_words(int C, int kp) { return (kp + (kBinsK - 1) * C + 3) / 4 * 4; }

// ---------------------------------------------------------------------------
// dX: a block takes 64 rows of dy, staged once, a warp 16 of them, whose A
// fragments (all kChunks) stay in registers while the warp walks the P C
// output columns, kDxGroup tiles at a time, each group out through a tile
// of the warp's own.  Shared memory: dy, the pair table wp [kp + (kBinsK -
// 1) C], wp[i] = (wflat[i - wp_lo], wflat[i - wp_lo - C]), then the warps'
// tiles [16][kDxTile] from the next 16-byte boundary.

__global__ void __launch_bounds__(kThreads) proj_train_dx_kernel(
    const uint16_t* __restrict__ dy, const uint16_t* __restrict__ w, uint16_t* __restrict__ dx, int rows, int C,
    int kp, int f_dim, int kw, int lo) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* ds = reinterpret_cast<uint16_t*>(smem);
  uint32_t* wp = reinterpret_cast<uint32_t*>(ds + kRows * kDyStride);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int lo_c = lo * C, fc = f_dim * C;
  const int wp_lo = (kBinsK - 1 - lo) * C;
  uint16_t* tile = reinterpret_cast<uint16_t*>(wp + dx_table_words(C, kp)) + warp * 16 * kDxTile;

  // dy's rows of this block are one contiguous, 16-byte aligned range
  {
    const int count = static_cast<int>(rows - r0 < kRows ? rows - r0 : kRows) * f_dim;
    const uint16_t* src = dy + r0 * f_dim;
    uint4 v[kDxVecs];
#pragma unroll
    for (int i = 0; i < kDxVecs; ++i) {
      const int e0 = (tid + i * kThreads) * 8;
      if (e0 < kRows * f_dim) v[i] = load8(src, e0, count);
    }
#pragma unroll
    for (int i = 0; i < kDxVecs; ++i) {
      const int e0 = (tid + i * kThreads) * 8;
      if (e0 < kRows * f_dim) put8(ds, e0, v[i], f_dim);
    }
    zero_pad_bins(ds, kRows, f_dim, tid, kThreads);
  }
  for (int i = tid; i < kp + (kBinsK - 1) * C; i += kThreads)
    wp[i] = pack(wtap(w, i - wp_lo, C, kw), wtap(w, i - wp_lo - C, C, kw));
  __syncthreads();

  uint32_t a[kChunks][4];
#pragma unroll
  for (int kc = 0; kc < kChunks; ++kc)
    ldmatrix_x4(a[kc], ds + (warp * 16 + (lane & 15)) * kDyStride + kc * 16 + (lane >> 4) * 8);
  for (int base = 0; base < kp; base += kDxGroup * 8) {
    float acc[kDxGroup][4] = {};
#pragma unroll
    for (int j = 0; j < kDxGroup; ++j) {
      const int n0 = base + j * 8;
      if (n0 >= kp) break;
#pragma unroll
      for (int kc = 0; kc < kChunks; ++kc) {
        const uint32_t* b = wp + n0 + g - (kc * 16 + 2 * t) * C + lo_c + wp_lo;
        mma_bf16(acc[j], a[kc], b[0], b[-8 * C]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kDxGroup; ++j) {
      const int col = j * 8 + 2 * t;
      const bool real = base + col < fc;  // the pad band's gradient is 0
      *reinterpret_cast<uint32_t*>(tile + g * kDxTile + col) =
          real ? pack(float_to_bf16(acc[j][0]), float_to_bf16(acc[j][1])) : 0u;
      *reinterpret_cast<uint32_t*>(tile + (g + 8) * kDxTile + col) =
          real ? pack(float_to_bf16(acc[j][2]), float_to_bf16(acc[j][3])) : 0u;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16 * kDxGroup / 32; ++i) {  // 16 rows of kDxGroup 8-value vectors
      const int q = lane + 32 * i, row = q / kDxGroup, col = q % kDxGroup * 8;
      const long long r = r0 + warp * 16 + row;
      if (r < rows && base + col < kp)
        *reinterpret_cast<uint4*>(dx + r * kp + base + col) =
            *reinterpret_cast<const uint4*>(tile + row * kDxTile + col);
    }
  }
}

// ---------------------------------------------------------------------------
// dW and db: block (tile, split) takes x columns [128 tile, 128 tile + 128)
// over the rows [split rows_per_split, ...), a warp 16 of the columns by
// all kTiles bins of G.  Two stages: x by cp.async, dy through registers a
// stage ahead.  Then G goes to shared memory (over the stages) and each
// thread adds the diagonals of its taps into part[split][tile][kw C]; the
// first tile's blocks write db's partial sum to part_db[split].

__global__ void __launch_bounds__(kDwThreads, 2) proj_train_dw_kernel(
    const uint16_t* __restrict__ x, const uint16_t* __restrict__ dy, float* __restrict__ part,
    float* __restrict__ part_db, int rows, int C, int kp, int f_dim, int kw, int lo, int rows_per_split) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float warp_db[kDwThreads / 32];
  uint16_t* stages = reinterpret_cast<uint16_t*>(smem);
  float* gs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kDwCols, split = blockIdx.y;
  const long long r_begin = static_cast<long long>(split) * rows_per_split;
  const long long r_end = r_begin + rows_per_split < rows ? r_begin + rows_per_split : rows;
  const int nst = static_cast<int>((r_end - r_begin + kDwRows - 1) / kDwRows);
  const bool sum_db = blockIdx.x == 0;
  const int span = kw * C;
  float db = 0.f;
  uint4 dyv[kDwVecs];

  auto load_x = [&](int s) {
    uint16_t* dst = stages + (s & 1) * kDwStage;
    const long long r = r_begin + static_cast<long long>(s) * kDwRows;
    for (int q = tid; q < kDwRows * (kDwCols / 8); q += kDwThreads) {
      const int row = q / (kDwCols / 8), cc = (q % (kDwCols / 8)) * 8;
      const bool ok = r + row < r_end && m0 + cc < kp;
      copy16(dst + row * kXStride + cc, ok ? x + (r + row) * kp + m0 + cc : x, ok);
    }
    commit();
  };
  // A stage's rows of dy are one contiguous, 16-byte aligned range.
  auto fetch_dy = [&](int s) {
    const long long r = r_begin + static_cast<long long>(s) * kDwRows;
    const int count = static_cast<int>(r_end - r < kDwRows ? r_end - r : kDwRows) * f_dim;
#pragma unroll
    for (int i = 0; i < kDwVecs; ++i) {
      const int e0 = (tid + i * kDwThreads) * 8;
      if (e0 < kDwRows * f_dim) dyv[i] = load8(dy + r * f_dim, e0, count);
    }
  };
  auto store_dy = [&](int s) {
    uint16_t* dst = stages + (s & 1) * kDwStage + kDwRows * kXStride;
#pragma unroll
    for (int i = 0; i < kDwVecs; ++i) {
      const int e0 = (tid + i * kDwThreads) * 8;
      if (e0 < kDwRows * f_dim) {
        const float sum = put8(dst, e0, dyv[i], f_dim);
        if (sum_db) db += sum;
      }
    }
  };
  for (int b = 0; b < 2; ++b)
    zero_pad_bins(stages + b * kDwStage + kDwRows * kXStride, kDwRows, f_dim, tid, kDwThreads);

  float acc[kTiles][4] = {};
  if (nst > 0) {
    load_x(0);
    fetch_dy(0);
    store_dy(0);
  }
  const int i8 = lane >> 3, r8 = lane & 7;
  for (int s = 0; s < nst; ++s) {
    const bool next = s + 1 < nst;
    if (next) {
      load_x(s + 1);
      fetch_dy(s + 1);
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    const uint16_t* xs = stages + (s & 1) * kDwStage;
    const uint16_t* ds = xs + kDwRows * kXStride;
#pragma unroll
    for (int kc = 0; kc < kDwRows / 16; ++kc) {
      // A = x^T (16 columns by 16 rows), B = dy (16 rows by 2 bins tiles),
      // both transposed out of their row-major stages
      uint32_t a[4];
      ldmatrix_x4_trans(a, xs + (kc * 16 + (i8 >> 1) * 8 + r8) * kXStride + warp * 16 + (i8 & 1) * 8);
#pragma unroll
      for (int jp = 0; jp < (kTiles + 1) / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ds + (kc * 16 + (i8 & 1) * 8 + r8) * kDyStride + (2 * jp + (i8 >> 1)) * 8);
        mma_bf16(acc[2 * jp], a, b[0], b[1]);
        if (2 * jp + 1 < kTiles) mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
      }
    }
    if (next) store_dy(s + 1);
    __syncthreads();
  }

  // G [128 columns][kBins] into shared memory, over the stages.
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(gs + (warp * 16 + g + 8 * h) * kGStride + j * 8 + 2 * t) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
  __syncthreads();
  // dw[d = j C + c] gets G[m, f] for m = d + (f - lo) C in this tile's columns.
  float* out = part + (static_cast<long long>(split) * gridDim.x + blockIdx.x) * span;
  for (int d = tid; d < span; d += kDwThreads) {
    const int f_lo = max(0, lo - floor_div(d - m0, C));
    const int f_hi = min(f_dim - 1, lo + floor_div(m0 + kDwCols - 1 - d, C));
    float sum = 0.f;
    for (int f = f_lo; f <= f_hi; ++f) sum += gs[(d + (f - lo) * C - m0) * kGStride + f];
    out[d] = sum;
  }
  if (sum_db) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) db += __shfl_down_sync(0xffffffffu, db, off);
    if (lane == 0) warp_db[warp] = db;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int i = 0; i < kDwThreads / 32; ++i) sum += warp_db[i];
      part_db[split] = sum;
    }
  }
}

// dw [C][kw] and db [1] in bf16: the partial sums of every (split, tile)
// block, and db's of every split, added in block order.
__global__ void __launch_bounds__(kReduceThreads) proj_train_dw_reduce_kernel(
    const float* __restrict__ part, const float* __restrict__ part_db, uint16_t* __restrict__ dw,
    uint16_t* __restrict__ db, int slots, int splits, int C, int kw) {
  const int span = kw * C;
  const int d = blockIdx.x * kReduceThreads + threadIdx.x;
  if (d < span) {
    float sum = 0.f;
    for (int i = 0; i < slots; ++i) sum += part[static_cast<long long>(i) * span + d];
    const int j = d / C;
    dw[(d - j * C) * kw + j] = float_to_bf16(sum);
  } else if (d == span) {
    float sum = 0.f;
    for (int i = 0; i < splits; ++i) sum += part_db[i];
    db[0] = float_to_bf16(sum);
  }
}

// Shared memory of each kernel.
size_t fwd_smem(int C, int kp) {
  const int kpad = (kp + kStageK - 1) / kStageK * kStageK;
  return sizeof(uint16_t) * (kFwdStages * kRows * kXStride + kpad + (kBins - 1) * C);
}

size_t dx_smem(int C, int kp) {
  return sizeof(uint16_t) * kRows * kDyStride + sizeof(uint32_t) * dx_table_words(C, kp) +
         sizeof(uint16_t) * (kThreads / 32) * 16 * kDxTile;
}

constexpr size_t kDwSmem = sizeof(float) * kDwCols * kGStride > sizeof(uint16_t) * 2 * kDwStage
                               ? sizeof(float) * kDwCols * kGStride
                               : sizeof(uint16_t) * 2 * kDwStage;

// Raises a kernel's dynamic shared memory limit to `bytes` where it is lower.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

size_t fwd_allowed = 48 * 1024, dx_allowed = 48 * 1024, dw_allowed = 48 * 1024;

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// The shapes every kernel takes: F in (128, 136], C even in [2, 64], the
// positions' P C a multiple of 8 with P >= F, 0 <= lo < F, kw >= 1.
bool takes(int rows, int C, int positions, int f_dim, int kw, int lo) {
  return rows >= 1 && f_dim > kBins - 8 && f_dim <= kBins && C >= 2 && C <= 64 && C % 2 == 0 &&
         positions >= f_dim && positions * C % 8 == 0 && lo >= 0 && lo < f_dim && kw >= 1 &&
         static_cast<long long>(rows) * positions * C < (1LL << 40);
}

}  // namespace

// Every function launches on `stream`, returns the CUDA error code of its
// launches (0 on success, cudaErrorInvalidValue for a shape or pointer the
// kernels do not take) and never synchronises.  All tensors are bf16 but
// the partial sums: x and dx [rows][positions * C], y and dy [rows][f_dim]
// (all four 16-byte aligned), w and dw [C][kw], b and db [1].

extern "C" int proj_train_forward(const void* x, const void* w, const void* b, void* y, int rows, int C,
                                  int positions, int f_dim, int kw, int lo, void* stream) {
  if (!takes(rows, C, positions, f_dim, kw, lo) || !aligned(x, 16) || !aligned(y, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = positions * C;
  const size_t smem = fwd_smem(C, kp);
  cudaError_t err = allow_smem(proj_train_fwd_kernel, smem, fwd_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  proj_train_fwd_kernel<<<(rows + kRows - 1) / kRows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), static_cast<const uint16_t*>(b),
      static_cast<uint16_t*>(y), rows, C, kp, f_dim, kw, lo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int proj_train_grad_input(const void* dy, const void* w, void* dx, int rows, int C, int positions,
                                     int f_dim, int kw, int lo, void* stream) {
  if (!takes(rows, C, positions, f_dim, kw, lo) || !aligned(dy, 16) || !aligned(dx, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = positions * C;
  const size_t smem = dx_smem(C, kp);
  cudaError_t err = allow_smem(proj_train_dx_kernel, smem, dx_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  proj_train_dx_kernel<<<(rows + kRows - 1) / kRows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(dy), static_cast<const uint16_t*>(w), static_cast<uint16_t*>(dx), rows, C,
      kp, f_dim, kw, lo);
  return static_cast<int>(cudaGetLastError());
}

// part holds splits * tiles * kw * C floats, tiles = ceil(positions * C /
// 128); part_db `splits` floats; rows_per_split a multiple of 32 with
// splits * rows_per_split >= rows.
extern "C" int proj_train_grad_weight(const void* x, const void* dy, float* part, float* part_db, void* dw,
                                      void* db, int rows, int C, int positions, int f_dim, int kw, int lo,
                                      int rows_per_split, int splits, void* stream) {
  if (!takes(rows, C, positions, f_dim, kw, lo) || !aligned(x, 16) || !aligned(dy, 16) || splits < 1 ||
      rows_per_split < 1 || rows_per_split % kDwRows != 0 ||
      static_cast<long long>(rows_per_split) * splits < rows ||
      static_cast<long long>(rows_per_split) * (splits - 1) >= rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = positions * C;
  const int tiles = (kp + kDwCols - 1) / kDwCols;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(proj_train_dw_kernel, kDwSmem, dw_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  proj_train_dw_kernel<<<dim3(tiles, splits), kDwThreads, kDwSmem, st>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(dy), part, part_db, rows, C, kp, f_dim, kw, lo,
      rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  proj_train_dw_reduce_kernel<<<(kw * C + 1 + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, st>>>(
      part, part_db, static_cast<uint16_t*>(dw), static_cast<uint16_t*>(db), tiles * splits, splits, C, kw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* proj_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
