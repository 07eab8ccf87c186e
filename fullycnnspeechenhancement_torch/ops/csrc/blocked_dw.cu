// Weight gradient (dW) of one inner blocked frequency conv, training backward.
//
// Replaces the TPU kernel `_dw_kernel` of
// fullycnnspeechenhancement_tpu/ops/pallas_dw.py (launched by
// `blocked_dw_pallas` there).  With z [R, NB, Ci] (the layer's input) and
// dy [R, NB, Co] (the cotangent of its output), row-major and
// channels-last, R = B*T rows and NB frequency blocks:
//
//   dW[d, ci, co] = sum_{r, n} zpad[r, n + d - dc, ci] * dy[r, n, co]
//
// for the KB taps d, where zpad is z with zeros outside 0 <= n < NB (the
// forward conv's (dc, KB-1-dc) padding along NB).  The output is
// [KB, Ci, Co] float32.
//
// What bounds it on an H100: arithmetic.  For V2's 14 inner layers at
// batch 64 x 8 s (R = 32,768, NB = 17, KB = 4, dc = 2, sum of Ci*Co =
// 286,720), tap d pairs NB - |d - dc| real z blocks with dy, so the
// contraction needs 1.2026e12 FLOP.  This kernel runs it on the tensor
// cores in 3xTF32, three TF32 products for each float32 one, so its bound
// is 3 x 1.2026e12 FLOP at the 495 TFLOP/s dense TF32 rate: 7.29 ms
// (17.95 ms at the 67 TFLOP/s float32 rate without tensor cores).
// Reading z and dy once is 8.66e9 bytes, 2.59 ms at 3.35 TB/s.
//
// What the design does about it.
// - The contraction is a GEMM per tap over one flat index K = (row, block
//   position): dW^T[d] = A B_d with A[co, p] = dy at p and B_d[p, ci] = z
//   at p + d.  Each stage of `stage_rows` rows is staged in shared memory
//   with the row stride nbp = NB + KB - 1 for both operands: dy at
//   p = rr*nbp + n (its KB-1 extra positions per row are zeros), z at
//   p + dc (dc zero halo positions before its NB blocks, KB-1-dc after),
//   and KB-1 zero z positions after the stage.  Tap d's z then sits at
//   p + d for every row, so the tap shift is a uniform offset along K,
//   at a cost of nbp/NB (20/17 = 1.18x on V2) in products against zeros.
// - Tensor cores at float32 accuracy (3xTF32), with mma.sync.m16n8k8:
//   every operand x is split, as its fragment is loaded, into big = x with
//   its 13 low mantissa bits cleared (a TF32 value) and small = the same
//   of x - big (exact), and each product is accumulated in float32 as
//   small_a*big_b + big_a*small_b + big_a*big_b, one pass of each over all
//   of a warp's accumulators.  TF32 alone keeps about 3 digits; the split
//   keeps x to 2^-20 of itself.  Two bitwise ANDs and a subtraction do the
//   split: cvt.rna.tf32 would go through the conversion path, which the
//   CUDA guide's throughput table gives a quarter of the bitwise rate.
//   The split is done in registers, not at staging time: hi and lo copies
//   in shared memory would double the stage and its fragment loads.  wgmma
//   would want both TF32 operands K-major in shared memory, and here K
//   (the row index) is the slow index of both z and dy: that needs a
//   transpose and is later work.
// - Tensor cores add into their accumulators with truncation, which
//   biases long sums toward zero: on an H100, one accumulator over a few
//   thousand rows of V2's layers missed DW_TOL (chip_smoke.py).  So a
//   block adds its accumulators to its float32 partial sums, rounding to
//   nearest, every kFlushPositions positions and restarts them from zero.
// - Operand roles: dy, loaded once per k8 chunk and reused by all KB taps,
//   is the A operand (M = co, m16 fragments); z, reloaded at the shift of
//   each tap, is B (N = ci, n8 fragments).  Within a k8 chunk, mma's k = t
//   and t + 4 stand for positions 2t and 2t + 1, so tap d + 1's first z
//   fragment is tap d's second: KB taps load KB + 1 z positions, not 2 KB.
//   A block of 4 warps owns a 32 co x 32 ci tile for all taps, each warp
//   16 co x 16 ci x KB accumulators, and lane g's two co and two ci are
//   adjacent, so each fragment load is one 8-byte load.  Small blocks
//   (4 resident per SM) ran faster on V2's layers than 64-wide ones (2
//   per SM) and pad Ci x Co by 1.18x, no more.  Staged rows have a stride
//   of 32 + 4 floats, so a warp's 8-byte loads `base + 2t*ld + 2g` hit
//   distinct banks.
// - cp.async double buffering: two stages in shared memory; the next
//   stage's 16-byte cp.async.cg copies fly while the tensor cores work on
//   this one.  Rows past a split and channels past Ci or Co are zero-filled
//   by the copy's src-size; where Ci or Co is not a multiple of 4 (or a
//   pointer is not 16-byte aligned) every float is its own 4-byte copy.
//   The zero halos and pads of both buffers are written once, before the
//   loop: the copies never touch them.
// - Blocks run in parallel and carry nothing over, so the rows are cut
//   into splits that, times the tiles, fill whole waves of the card; each
//   split writes its partial sums to a scratch buffer [splits, KB, Ci, Co]
//   that the caller allocates, and a second kernel adds the splits in a
//   fixed order.  No atomics, so a run repeats bit for bit.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, phase 11) it runs
// V2's 14 layers in 33.0 ms, against 60.1 ms for cuDNN's backward-filter;
// mma.sync's TF32 products alone run at 251.5 TFLOP/s there, which puts
// the floor of this design (1.47x the needed products, 3 passes) at
// 21.1 ms.
//
// The bf16 mode (z and dy in bf16, as the JAX kernel takes them in the
// compute dtype; dW float32) is a second kernel, dw_bf16_kernel, on the
// same plan: the same per-tap GEMM over the flat K = (row, block
// position), the same nbp row stride with zero halos, the same cp.async
// double buffering, flushes and row splits.  What changes:
// - What bounds it: bytes.  The same 1.2026e12 FLOP take 1.216 ms at the
//   data sheet's 989 TFLOP/s dense bf16 rate; reading z and dy once, now
//   2 bytes a value, takes 4.33e9 bytes, 1.293 ms at 3.35 TB/s.
// - mma.sync.m16n8k16 with bf16 operands and float32 accumulators: one
//   product a tile and no split.  A bf16 x bf16 product is exact in
//   float32, so the result differs from the plain version (which promotes
//   to float32) only in the order of its sums; the flushes stay, as the
//   accumulation still truncates.
// - Fragments come from shared memory by ldmatrix.x4.trans: both operands
//   are staged [position][channel], so a stored 8 x 8 matrix of 8
//   positions by 8 channels, transposed on load, is a fragment's (k pair,
//   column) layout.  Each lane gives one row's address, so tap d's z
//   fragments start at any position: the tap shift stays a uniform
//   offset along K.
// - Shared-memory bandwidth binds this design, not the tensor cores: an
//   ldmatrix.x4 takes 4 of the SM's 128-byte cycles and an m16n8k16 mma
//   about 2 at mma.sync's rate.  So a warp covers 32 co by 16 ci (a block
//   64 co by 32 ci): per k16 chunk it loads dy's two m16 x k16 fragments
//   once for all taps and one x4 (two n8 fragments) of z per tap, 6
//   ldmatrix.x4 for 16 mma at KB = 4.  A warp tile of 16 co by 16 ci (the
//   float32 kernel's) read 5 for 8 and ran V2's 14 layers in 9.504 ms on
//   an H100 (chip_smoke.py), slower than cuDNN's 5.087 ms.
// - Staged rows hold 64 + 8 bf16 of dy and 32 + 8 of z (144 and 80
//   bytes, 9 and 5 of the 8 16-byte bank groups), so the 8 rows of an
//   ldmatrix matrix fall in 8 distinct bank groups.
// - Copies are 16-byte cp.async.cg (8 bf16) where both channel counts are
//   multiples of 8 and both pointers 16-byte aligned; 4-byte cp.async (2
//   bf16) where they are even and 4-byte aligned; else each bf16 is loaded
//   and stored by its thread (odd channel counts: no copy is aligned).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsM = 2;  // warps along co
constexpr int kWarpsN = 2;  // warps along ci
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWm = 1;  // m16 fragments (16 co) per warp
constexpr int kWn = 2;  // n8 fragments (8 ci) per warp
constexpr int kBm = 16 * kWm * kWarpsM;  // co per block
constexpr int kBn = 8 * kWn * kWarpsN;   // ci per block

// Resident blocks per SM that the registers must allow: 4 (128 registers
// a thread) up to KB = 5, 3 above, where 128 would spill.
__host__ __device__ constexpr int min_blocks(int kb) { return kb <= 5 ? 4 : 3; }
constexpr int kMaxKb = 8;
constexpr int kRowPad = 4;  // floats after each staged position's channels
// K positions a block multiplies into its tensor-core accumulators before
// it adds them to its float32 partial sums (see dw_mma_kernel).
constexpr int kFlushPositions = 4096;

struct Params {
  const void* z;  // float or bf16 (raw 16-bit) values
  const void* dy;
  float* part;
  long long rows;
  long long rows_per_split;
  int nb, ci, co, dc;
  int stage_rows;  // rows per stage; stage_rows * (nb + KB - 1) % 8 (bf16: 16) == 0
  int vec;         // values per copy: 4 or 1 floats; 8, 2 or 1 bf16
};

// The bf16 kernel's block tile: 64 co (two m16 fragments a warp) by kBn
// ci, and bf16 values of padding after each staged position's channels.
constexpr int kBmBf16 = 64;
constexpr int kRowPadBf16 = 8;

// x = big + small + O(2^-20 |x|): big is x with its 13 low mantissa bits
// cleared (a TF32 value), x - big is exact, and small is that with its
// own 13 low bits cleared.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// VEC values of T (4 bytes for float, 2 for bf16) from global to shared
// memory, or zeros where `ok` is false: 16 or 4 bytes by cp.async
// (src-size 0: nothing is read), or one bf16 by its thread.
template <typename T, int VEC>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool ok) {
  constexpr int bytes = VEC * static_cast<int>(sizeof(T));
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 16 : 0));
  } else if constexpr (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 4 : 0));
  } else {
    static_assert(bytes == 2, "a copy moves 16, 4 or 2 bytes");
    *dst = ok ? __ldg(src) : T(0);
  }
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// N consecutive floats from shared memory (N = 1, 2 or 4, aligned).
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

// Floats of one shared-memory stage: dy [P][kBm + 4], then z [P + KB - 1][kBn + 4].
__host__ __device__ inline int stage_floats(int stage_rows, int nb, int kb) {
  const int positions = stage_rows * (nb + kb - 1);
  return positions * (kBm + kRowPad) + (positions + kb - 1) * (kBn + kRowPad);
}

// bf16 values of one stage of the bf16 kernel: dy [P][kBmBf16 + 8], then
// z [P + KB - 1][kBn + 8]; a multiple of 8, so every stage and both of its
// operands start 16-byte aligned.
__host__ __device__ inline int stage_values_bf16(int stage_rows, int nb, int kb) {
  const int positions = stage_rows * (nb + kb - 1);
  return positions * (kBmBf16 + kRowPadBf16) + (positions + kb - 1) * (kBn + kRowPadBf16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of bf16 from shared memory, each transposed: lanes
// 8i .. 8i + 7 give the addresses of matrix i's 8 rows (16 bytes each),
// and lane 4g + t receives, in r[i], rows 2t (low half) and 2t + 1 (high
// half) of its column g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint16_t* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Copies one operand of the rows [pos0, pos0 + npos) (flat (row, block)
// positions; those at or past pos_end are zero-filled) into a stage:
// block n of row rr to position rr*nbp + n + shift, `width` channels from
// channel c0 of `src`'s `channels`, VEC values a copy, rows of WIDTH + PAD
// values.  Each thread keeps one channel offset and walks the positions
// without dividing.
template <int WIDTH, int VEC, int PAD = kRowPad, typename T = float>
__device__ __forceinline__ void load_operand(T* dst, const T* src, int channels, int c0,
                                             long long pos0, long long pos_end, int npos,
                                             int nb, int nbp, int shift) {
  constexpr int per_pos = WIDTH / VEC, step = kThreads / per_pos;
  static_assert(kThreads % per_pos == 0, "a thread keeps one channel offset");
  const int c = (threadIdx.x % per_pos) * VEC;
  int q = threadIdx.x / per_pos;
  int rr = q / nb, n = q - rr * nb;
  const bool col_ok = c0 + c < channels;
  const T* from = src + (pos0 + q) * channels + c0 + c;
  for (; q < npos; q += step) {
    const bool ok = col_ok && pos0 + q < pos_end;
    copy_async<T, VEC>(dst + (rr * nbp + n + shift) * (WIDTH + PAD) + c, ok ? from : src, ok);
    from += static_cast<long long>(step) * channels;
    for (n += step; n >= nb; n -= nb) ++rr;
  }
}

// Copies the rows [r0, r0 + stage_rows) of this block's tile into one
// stage: dy's block n to position rr*nbp + n, z's to rr*nbp + n + dc.
// Rows at or past r_end are zero-filled.
__device__ __forceinline__ void load_stage(const Params& p, float* ds, float* zs, long long r0,
                                           long long r_end, int nbp, int co0, int ci0) {
  const long long pos0 = r0 * p.nb, pos_end = r_end * p.nb;
  const int npos = p.stage_rows * p.nb;
  const float* dy = static_cast<const float*>(p.dy);
  const float* z = static_cast<const float*>(p.z);
  if (p.vec == 4) {
    load_operand<kBm, 4>(ds, dy, p.co, co0, pos0, pos_end, npos, p.nb, nbp, 0);
    load_operand<kBn, 4>(zs, z, p.ci, ci0, pos0, pos_end, npos, p.nb, nbp, p.dc);
  } else {
    load_operand<kBm, 1>(ds, dy, p.co, co0, pos0, pos_end, npos, p.nb, nbp, 0);
    load_operand<kBn, 1>(zs, z, p.ci, ci0, pos0, pos_end, npos, p.nb, nbp, p.dc);
  }
}

// load_stage for bf16 operands (raw 16-bit values), rows of kBmBf16 + 8
// and kBn + 8 values.
__device__ __forceinline__ void load_stage_bf16(const Params& p, uint16_t* ds, uint16_t* zs,
                                                long long r0, long long r_end, int nbp, int co0,
                                                int ci0) {
  const long long pos0 = r0 * p.nb, pos_end = r_end * p.nb;
  const int npos = p.stage_rows * p.nb;
  const uint16_t* dy = static_cast<const uint16_t*>(p.dy);
  const uint16_t* z = static_cast<const uint16_t*>(p.z);
  constexpr int P = kRowPadBf16;
  if (p.vec == 8) {
    load_operand<kBmBf16, 8, P>(ds, dy, p.co, co0, pos0, pos_end, npos, p.nb, nbp, 0);
    load_operand<kBn, 8, P>(zs, z, p.ci, ci0, pos0, pos_end, npos, p.nb, nbp, p.dc);
  } else if (p.vec == 2) {
    load_operand<kBmBf16, 2, P>(ds, dy, p.co, co0, pos0, pos_end, npos, p.nb, nbp, 0);
    load_operand<kBn, 2, P>(zs, z, p.ci, ci0, pos0, pos_end, npos, p.nb, nbp, p.dc);
  } else {
    load_operand<kBmBf16, 1, P>(ds, dy, p.co, co0, pos0, pos_end, npos, p.nb, nbp, 0);
    load_operand<kBn, 1, P>(zs, z, p.ci, ci0, pos0, pos_end, npos, p.nb, nbp, p.dc);
  }
}

// The fragments' index maps.  Within a k8 chunk at k0, mma's k = t and
// t + 4 stand for positions k0 + 2t and k0 + 2t + 1.  A warp covers
// 16 WM co and 8 WN ci, and lane g holds co 2WM*g ..
// 2WM*g + 2WM-1 and ci WN*g .. WN*g + WN-1, each as one vector load:
// m16 fragment i's rows g and g + 8 are co 2WM*g + 2i and + 1, and n8
// fragment j's column g is ci WN*g + j.
template <int KB>
__global__ void __launch_bounds__(kThreads, min_blocks(KB)) dw_mma_kernel(const Params p) {
  constexpr int WM = kWm, WN = kWn, BM = kBm, BN = kBn;
  constexpr int ldm = BM + kRowPad, ldn = BN + kRowPad;
  extern __shared__ __align__(16) float sm[];
  const int nbp = p.nb + KB - 1;
  const int P = p.stage_rows * nbp;  // K positions per stage, a multiple of 8
  const int sf = stage_floats(p.stage_rows, p.nb, KB);
  const int ci0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * BM;
  const long long r_begin = static_cast<long long>(blockIdx.z) * p.rows_per_split;
  const long long r_end = r_begin + p.rows_per_split < p.rows ? r_begin + p.rows_per_split : p.rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the fragments' groupID, thread in group
  const int warp_co = (warp / kWarpsN) * 16 * WM;
  const int warp_ci = (warp % kWarpsN) * 8 * WN;

  // Zero the halos and pads of both stages once; the copies below write
  // only dy's positions n < nb and z's dc <= n < dc + nb of each row.
  if constexpr (KB > 1) {
    for (int b = 0; b < 2; ++b) {
      float* ds = sm + b * sf;
      float* zs = ds + P * ldm;
      for (int i = threadIdx.x; i < p.stage_rows * (KB - 1) * ldm; i += kThreads) {
        const int q = i / ldm, c = i - q * ldm;
        const int rr = q / (KB - 1), h = q - rr * (KB - 1);
        ds[(rr * nbp + p.nb + h) * ldm + c] = 0.f;
      }
      for (int i = threadIdx.x; i < (p.stage_rows + 1) * (KB - 1) * ldn; i += kThreads) {
        const int q = i / ldn, c = i - q * ldn;
        const int rr = q / (KB - 1), h = q - rr * (KB - 1);
        const int pos = rr < p.stage_rows ? rr * nbp + (h < p.dc ? h : p.nb + h) : P + h;
        zs[pos * ldn + c] = 0.f;
      }
    }
  }

  float acc[KB][WM][WN][4];
#pragma unroll
  for (int d = 0; d < KB; ++d)
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[d][i][j][c] = 0.f;
  float* out = p.part + static_cast<long long>(blockIdx.z) * KB * p.ci * p.co;

  // Every split has rows (the launch checks it), so n_stages >= 1.
  const int n_stages = static_cast<int>((r_end - r_begin + p.stage_rows - 1) / p.stage_rows);
  const int flush_stages = kFlushPositions / P > 0 ? kFlushPositions / P : 1;
  load_stage(p, sm, sm + P * ldm, r_begin, r_end, nbp, co0, ci0);
  copy_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) {
      float* nxt = sm + ((s + 1) & 1) * sf;
      load_stage(p, nxt, nxt + P * ldm, r_begin + static_cast<long long>(s + 1) * p.stage_rows,
                 r_end, nbp, co0, ci0);
      copy_commit();
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();  // this stage (and, at s = 0, the zeroed halos) is visible
    const float* ds = sm + (s & 1) * sf + (2 * t) * ldm + warp_co + 2 * WM * g;
    const float* zs = sm + (s & 1) * sf + P * ldm + (2 * t) * ldn + warp_ci + WN * g;
    for (int k0 = 0; k0 < P; k0 += 8) {
      // dy at positions k0 + 2t (fragment k = t) and k0 + 2t + 1 (k = t + 4)
      float a_lo[2 * WM], a_hi[2 * WM];
      load_vec<2 * WM>(ds + k0 * ldm, a_lo);
      load_vec<2 * WM>(ds + (k0 + 1) * ldm, a_hi);
      uint32_t ab[WM][4], as[WM][4];
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        split_tf32(a_lo[2 * i], ab[i][0], as[i][0]);
        split_tf32(a_lo[2 * i + 1], ab[i][1], as[i][1]);
        split_tf32(a_hi[2 * i], ab[i][2], as[i][2]);
        split_tf32(a_hi[2 * i + 1], ab[i][3], as[i][3]);
      }
      // z at positions k0 + 2t + e, e = 0 .. KB: tap d takes e = d and d + 1
      uint32_t zb[2][WN], zsm[2][WN];
      {
        float v[WN];
        load_vec<WN>(zs + k0 * ldn, v);
#pragma unroll
        for (int j = 0; j < WN; ++j) split_tf32(v[j], zb[0][j], zsm[0][j]);
      }
#pragma unroll
      for (int d = 0; d < KB; ++d) {
        const int lo = d & 1, hi = (d + 1) & 1;
        float v[WN];
        load_vec<WN>(zs + (k0 + d + 1) * ldn, v);
#pragma unroll
        for (int j = 0; j < WN; ++j) split_tf32(v[j], zb[hi][j], zsm[hi][j]);
        // One pass of the three over all WM x WN accumulators before the
        // next, so that back-to-back mma are independent.
#pragma unroll
        for (int i = 0; i < WM; ++i)
#pragma unroll
          for (int j = 0; j < WN; ++j)
            mma_tf32(acc[d][i][j], as[i][0], as[i][1], as[i][2], as[i][3], zb[lo][j], zb[hi][j]);
#pragma unroll
        for (int i = 0; i < WM; ++i)
#pragma unroll
          for (int j = 0; j < WN; ++j)
            mma_tf32(acc[d][i][j], ab[i][0], ab[i][1], ab[i][2], ab[i][3], zsm[lo][j],
                     zsm[hi][j]);
#pragma unroll
        for (int i = 0; i < WM; ++i)
#pragma unroll
          for (int j = 0; j < WN; ++j)
            mma_tf32(acc[d][i][j], ab[i][0], ab[i][1], ab[i][2], ab[i][3], zb[lo][j], zb[hi][j]);
      }
    }
    // Every kFlushPositions positions, and at the end, the accumulators
    // are added in float32, rounding to nearest, to this block's partial
    // sums in `out` (its own slot: no other block writes there), and
    // restart from zero: tensor cores truncate as they accumulate.
    if ((s + 1) % flush_stages == 0 || s + 1 == n_stages) {
      const bool first = s < flush_stages;
#pragma unroll
      for (int d = 0; d < KB; ++d)
#pragma unroll
        for (int i = 0; i < WM; ++i)
#pragma unroll
          for (int j = 0; j < WN; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int o = co0 + warp_co + 2 * WM * g + 2 * i + (c >> 1);
              const int k = ci0 + warp_ci + WN * (2 * t + (c & 1)) + j;
              if (o < p.co && k < p.ci) {
                float* dst = out + (static_cast<long long>(d) * p.ci + k) * p.co + o;
                *dst = first ? acc[d][i][j][c] : *dst + acc[d][i][j][c];
              }
              acc[d][i][j][c] = 0.f;
            }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
}

// The bf16 mode of dw_mma_kernel: the same stages, halos, splits and
// flushes, on bf16 operands, with fragments from ldmatrix.x4.trans and
// mma.sync.m16n8k16.  A block covers 64 co by 32 ci, a warp 32 co by 16
// ci: its m16 fragment i's rows g and g + 8 are co 16i + g and 16i + g +
// 8, and n8 fragment j's column g is ci 8j + g, as mma's C layout has them.
template <int KB>
__global__ void __launch_bounds__(kThreads, min_blocks(KB)) dw_bf16_kernel(const Params p) {
  constexpr int ldm = kBmBf16 + kRowPadBf16, ldn = kBn + kRowPadBf16;
  extern __shared__ __align__(16) uint16_t smb[];
  const int nbp = p.nb + KB - 1;
  const int P = p.stage_rows * nbp;  // K positions per stage, a multiple of 16
  const int sv = stage_values_bf16(p.stage_rows, p.nb, KB);
  const int ci0 = blockIdx.x * kBn;
  const int co0 = blockIdx.y * kBmBf16;
  const long long r_begin = static_cast<long long>(blockIdx.z) * p.rows_per_split;
  const long long r_end = r_begin + p.rows_per_split < p.rows ? r_begin + p.rows_per_split : p.rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the fragments' groupID, thread in group
  const int warp_co = (warp / kWarpsN) * 32;
  const int warp_ci = (warp % kWarpsN) * 16;

  // Zero the halos and pads of both stages once (as dw_mma_kernel).
  if constexpr (KB > 1) {
    for (int b = 0; b < 2; ++b) {
      uint16_t* ds = smb + b * sv;
      uint16_t* zs = ds + P * ldm;
      for (int i = threadIdx.x; i < p.stage_rows * (KB - 1) * ldm; i += kThreads) {
        const int q = i / ldm, c = i - q * ldm;
        const int rr = q / (KB - 1), h = q - rr * (KB - 1);
        ds[(rr * nbp + p.nb + h) * ldm + c] = 0;
      }
      for (int i = threadIdx.x; i < (p.stage_rows + 1) * (KB - 1) * ldn; i += kThreads) {
        const int q = i / ldn, c = i - q * ldn;
        const int rr = q / (KB - 1), h = q - rr * (KB - 1);
        const int pos = rr < p.stage_rows ? rr * nbp + (h < p.dc ? h : p.nb + h) : P + h;
        zs[pos * ldn + c] = 0;
      }
    }
  }

  float acc[KB][2][2][4];
#pragma unroll
  for (int d = 0; d < KB; ++d)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[d][i][j][c] = 0.f;
  float* out = p.part + static_cast<long long>(blockIdx.z) * KB * p.ci * p.co;

  // This lane's row of the ldmatrix.x4 matrices.  dy's, for m16 fragment
  // i, are (k 0-7, co 0-7), (k 0-7, co 8-15), (k 8-15, co 0-7), (k 8-15,
  // co 8-15) from co 16i: mma's a0..a3.  z's are (k 0-7, ci 0-7), (k 8-15,
  // ci 0-7), (k 0-7, ci 8-15), (k 8-15, ci 8-15): b0, b1 of n8 fragment 0,
  // then of fragment 1.
  const int mat = lane >> 3, row = lane & 7;
  const int a_off = (row + (mat >> 1) * 8) * ldm + warp_co + (mat & 1) * 8;
  const int b_off = (row + (mat & 1) * 8) * ldn + warp_ci + (mat >> 1) * 8;

  const int n_stages = static_cast<int>((r_end - r_begin + p.stage_rows - 1) / p.stage_rows);
  const int flush_stages = kFlushPositions / P > 0 ? kFlushPositions / P : 1;
  load_stage_bf16(p, smb, smb + P * ldm, r_begin, r_end, nbp, co0, ci0);
  copy_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) {
      uint16_t* nxt = smb + ((s + 1) & 1) * sv;
      load_stage_bf16(p, nxt, nxt + P * ldm,
                      r_begin + static_cast<long long>(s + 1) * p.stage_rows, r_end, nbp, co0,
                      ci0);
      copy_commit();
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();  // this stage (and, at s = 0, the zeroed halos) is visible
    const uint16_t* ds = smb + (s & 1) * sv + a_off;
    const uint16_t* zs = smb + (s & 1) * sv + P * ldm + b_off;
    for (int k0 = 0; k0 < P; k0 += 16) {
      uint32_t a[2][4];
      ldmatrix_x4_trans(a[0], ds + k0 * ldm);
      ldmatrix_x4_trans(a[1], ds + k0 * ldm + 16);
#pragma unroll
      for (int d = 0; d < KB; ++d) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, zs + (k0 + d) * ldn);  // tap d: z at position + d
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[d][i][0], a[i], b[0], b[1]);
          mma_bf16(acc[d][i][1], a[i], b[2], b[3]);
        }
      }
    }
    // Flush into float32 partial sums (see dw_mma_kernel): C element c of
    // fragments (i, j) is co 16i + g + 8 (c >> 1), ci 8j + 2t + (c & 1).
    if ((s + 1) % flush_stages == 0 || s + 1 == n_stages) {
      const bool first = s < flush_stages;
#pragma unroll
      for (int d = 0; d < KB; ++d)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int o = co0 + warp_co + 16 * i + g + (c >> 1) * 8;
              const int k = ci0 + warp_ci + 8 * j + 2 * t + (c & 1);
              if (o < p.co && k < p.ci) {
                float* dst = out + (static_cast<long long>(d) * p.ci + k) * p.co + o;
                *dst = first ? acc[d][i][j][c] : *dst + acc[d][i][j][c];
              }
              acc[d][i][j][c] = 0.f;
            }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
}

// out[i] = sum over s of part[s][i], s in increasing order.
__global__ void dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 long long n, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * n + i];
  out[i] = s;
}

// The partial-sum kernel of the KB instance: dw_mma_kernel (float32) or
// dw_bf16_kernel.
template <int KB>
constexpr auto partial_kernel(bool bf16) {
  return bf16 ? dw_bf16_kernel<KB> : dw_mma_kernel<KB>;
}

template <int KB>
cudaError_t launch_partial(const Params& p, int splits, size_t smem, bool bf16,
                           cudaStream_t stream) {
  const auto kernel = partial_kernel<KB>(bf16);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int bm = bf16 ? kBmBf16 : kBm;
  const dim3 grid((p.ci + kBn - 1) / kBn, (p.co + bm - 1) / bm, splits);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int KB>
cudaError_t occupancy(int smem, bool bf16, int* blocks) {
  const auto kernel = partial_kernel<KB>(bf16);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads,
                                                       static_cast<size_t>(smem));
}

}  // namespace

// Bytes of shared memory one block takes (two stages), float32 (bf16 = 0)
// or bf16 (bf16 = 1).
extern "C" long long blocked_dw_smem_bytes(int stage_rows, int nb, int kb, int bf16) {
  return bf16 ? 2LL * sizeof(uint16_t) * stage_values_bf16(stage_rows, nb, kb)
              : 2LL * sizeof(float) * stage_floats(stage_rows, nb, kb);
}

// Blocks of the KB instance, float32 (bf16 = 0) or bf16 (bf16 = 1), that
// one SM holds at `smem` bytes each, into *blocks.  Returns the CUDA error
// code (0 on success).
extern "C" int blocked_dw_blocks_per_sm(int kb, int smem, int bf16, int* blocks) {
  cudaError_t err;
  switch (kb) {
#define DW_OCC(K)                           \
  case K:                                   \
    err = occupancy<K>(smem, bf16, blocks); \
    break;
    DW_OCC(1) DW_OCC(2) DW_OCC(3) DW_OCC(4) DW_OCC(5) DW_OCC(6) DW_OCC(7) DW_OCC(8)
#undef DW_OCC
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// dW of one blocked frequency conv on `stream`.  z [rows, nb, ci] and dy
// [rows, nb, co] contiguous, both float32 (bf16 = 0) or both bf16 (bf16 =
// 1); out [kb, ci, co] float32.  `part` is
// scratch of splits * kb * ci * co floats (unused when splits == 1, when
// the partial kernel writes `out` directly).  Row split s covers rows
// [s * rows_per_split, (s + 1) * rows_per_split), in stages of stage_rows
// rows; a block covers 32 co by 32 ci.  Returns the CUDA error code of
// the launches (0 on success); never synchronises.  (The bf16 instance's
// blocks cover 64 co by 32 ci.)
extern "C" int blocked_dw_forward(const void* z, const void* dy, float* out, float* part,
                                  long long rows, int nb, int ci, int co, int kb, int dc,
                                  long long rows_per_split, int splits, int stage_rows, int bf16,
                                  void* stream) {
  if (rows < 1 || nb < 1 || ci < 1 || co < 1 || kb < 1 || kb > kMaxKb || dc < 0 || dc >= kb ||
      rows_per_split < 1 || splits < 1 || stage_rows < 1 ||
      (splits - 1) * rows_per_split >= rows || splits * rows_per_split < rows ||
      stage_rows * (nb + kb - 1) % (bf16 ? 16 : 8) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [&](uintptr_t bytes) {
    return reinterpret_cast<uintptr_t>(z) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(dy) % bytes == 0;
  };
  int vec;
  if (bf16)
    vec = (aligned(16) && ci % 8 == 0 && co % 8 == 0) ? 8
          : (aligned(4) && ci % 2 == 0 && co % 2 == 0) ? 2
                                                       : 1;
  else
    vec = (aligned(16) && ci % 4 == 0 && co % 4 == 0) ? 4 : 1;
  const Params p{z, dy, splits == 1 ? out : part, rows, rows_per_split, nb, ci, co, dc,
                 stage_rows, vec};
  const size_t smem = static_cast<size_t>(blocked_dw_smem_bytes(stage_rows, nb, kb, bf16));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kb) {
#define DW_CASE(K)                                         \
  case K:                                                  \
    err = launch_partial<K>(p, splits, smem, bf16 != 0, s); \
    break;
    DW_CASE(1) DW_CASE(2) DW_CASE(3) DW_CASE(4) DW_CASE(5) DW_CASE(6) DW_CASE(7) DW_CASE(8)
#undef DW_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(kb) * ci * co;
  const int threads = 256;
  dw_reduce_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0, s>>>(
      part, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* blocked_dw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
