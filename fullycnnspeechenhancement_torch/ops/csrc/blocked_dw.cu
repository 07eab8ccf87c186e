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
// compute dtype; dW float32) is a second kernel, dw_wgmma_kernel.  It
// takes every bf16 pair whose Ci and Co are multiples of 8 and whose
// pointers are 16-byte aligned (every blocked layer at fb = 8, where C =
// 8 * out_ch).  ops/blocked_dw.py runs any other bf16 pair through
// dw_mma_kernel on float32 copies of z and dy: a bf16 value is its own
// TF32 big part with a zero small part, so each 3xTF32 product is exact
// and the result is float32 sums of exact products, as here.
// - What bounds it: bytes.  The same 1.2026e12 FLOP take 1.216 ms at the
//   data sheet's 989 TFLOP/s dense bf16 rate; reading z and dy once, now
//   2 bytes a value, takes 4.33e9 bytes, 1.293 ms at 3.35 TB/s.
// - Why wgmma: mma.sync's bf16 rate on an H100 (503.8 TFLOP/s alone,
//   chip_smoke.py phase 2) is half the card's, and every operand of it
//   goes through registers by ldmatrix.  An mma.sync design on the plan
//   above (ldmatrix.x4.trans fragments, blocks of 64 co by 32 ci) ran
//   V2's 14 layers in 8.1 ms on an H100, bound by shared-memory
//   bandwidth, against 4.0 ms for this kernel.  wgmma reaches the card's
//   989 TFLOP/s and reads both operands from shared memory; for 16-bit
//   types it reads either operand MN-major (its transpose flags), so dy
//   and z stay channels-last as they are staged: no transpose anywhere.
// - One GEMM per tap over the flat K, as above, but K runs position-major
//   within a stage: a stage is 8 rows, and K-row k = n * 8 + r holds row r
//   of the stage at block position n, for nbp positions (NB + KB - 1,
//   rounded up to even so a stage is whole k16 chunks).  So the 8 rows of
//   one position are one 8-deep group of K, the depth of a wgmma core
//   matrix, and tap d's shift by d positions is a shift by 8d K-rows:
//   whole groups.  That is what lets the layout be swizzled: the 128-byte
//   swizzle repeats every 8 K-rows (1024 bytes), so tap d's B descriptor
//   is tap 0's start plus d * 1024 bytes, still on the pattern's boundary
//   (base offset 0).  A stage of [position][row][64 channels] in 128-byte
//   rows, swizzled, is the canonical MN-major SW128 layout, free of bank
//   conflicts.  The no-swizzle layout with one 8-channel group a core
//   matrix was the other choice: its TMA boxes are 16 bytes wide, so
//   every read from L2 takes half of a 32-byte sector.
// - The operands: A = dy^T (M = 64 co, one A descriptor a k16 step) and
//   B = z shifted by d (N = 64 ci up to KB = 4, 32 above; KB descriptors
//   a k16 step), float32 accumulators, 64 x N x KB of them per warpgroup:
//   128 registers a thread at KB = 4.  The tile covers Ci x Co in tiles of
//   64 co by N ci; channels past C are zero-filled by TMA and never
//   written out.  M and N are each one swizzle atom, so a descriptor's
//   offset across atoms is never used: both offsets are set to the bytes
//   of one 8-row group.
// - TMA staging.  Each operand is a 3-D tensor map (channels, rows, block
//   positions), strides (2 C, 2 NB C) bytes, box (64 or N channels, 8 rows,
//   nbp positions), 128-byte (64-byte for N = 32) swizzle: one box lands a
//   whole stage of that operand in the order above.  z's box starts at
//   position -dc: TMA fills what lies out of bounds with zeros, which
//   writes z's dc halo positions before its NB blocks and those after,
//   dy's positions past NB, the rows past R and the channels past C.  No
//   thread writes a halo.  The 8 (KB - 1) K-rows after each stage's z,
//   which tap d > 0 reads against dy's zero positions, are zeroed once at
//   the start (0 * NaN would poison a sum).  The maps are encoded on the
//   host at each launch through the runtime's driver entry point
//   (cuTensorMapEncodeTiled), so the library links only the runtime, and
//   passed as __grid_constant__ parameters.
// - Warp specialisation.  One producer thread keeps a ring of stages of
//   TMA loads in flight, each on its full mbarrier; two consumer
//   warpgroups take stages in turn (stage s to warpgroup s % 2), issue
//   their wgmma on stages that have arrived, keep one stage's wgmma
//   group in flight while the next issues, and release a stage on its
//   empty mbarrier once its group has completed.  One block an SM (its
//   ring takes most of the shared memory), 288 threads.
// - Numerics and determinism as above: each warpgroup flushes its
//   accumulators into float32 partial sums every kFlushPositions K-rows
//   of its own (wgmma truncates as it accumulates too: the error grows
//   with the window), into a slot of its own of the scratch [2 splits,
//   KB, Ci, Co], padded to whole tiles so that every lane hands over all
//   of its accumulators (ptxas serialises every wgmma of a kernel that
//   reads an accumulator under a per-lane condition).  A flush goes
//   through shared memory to TMA, which stores the first window's sums
//   and adds the later ones in the L2: a flush that loaded its partial
//   sums would wait out their latency with its warpgroup idle.  The adds
//   to one address are issued one flush at a time, each after the last
//   has completed, and dw_reduce_kernel adds the slots in a fixed
//   order: a launch repeats bit for bit.
// - HBM at one pass: the grid runs tiles fastest, and a launch plan is
//   one wave where the tiles allow it, so the blocks that read the same
//   rows for different tiles run together and read them from L2.
// - What bounds it: the bytes from L2 to the SMs.  Each tile of 64 co by
//   N ci stages its rows of both operands, so a layer's rows are read
//   from L2 once per tile of the other operand's channels (4 x 3 tiles on
//   V2's widest layer), several times what HBM must give; TMA multicast
//   across a cluster of tiles that share rows is the next step.

#include <cuda.h>  // CUtensorMap and its enums only: no driver symbol is linked
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
  const float* z;
  const float* dy;
  float* part;
  long long rows;
  long long rows_per_split;
  int nb, ci, co, dc;
  int stage_rows;  // rows per stage; stage_rows * (nb + KB - 1) % 8 == 0
  int vec;         // floats per copy: 4 or 1
};

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

// VEC floats (4 or 1) from global to shared memory by cp.async, or zeros
// where `ok` is false (src-size 0: nothing is read).
template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 16 : 0));
  } else {
    static_assert(VEC == 1, "a copy moves 16 or 4 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 4 : 0));
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

// Copies one operand of the rows [pos0, pos0 + npos) (flat (row, block)
// positions; those at or past pos_end are zero-filled) into a stage:
// block n of row rr to position rr*nbp + n + shift, `width` channels from
// channel c0 of `src`'s `channels`, VEC floats a copy, rows of WIDTH +
// kRowPad floats.  Each thread keeps one channel offset and walks the
// positions without dividing.
template <int WIDTH, int VEC>
__device__ __forceinline__ void load_operand(float* dst, const float* src, int channels, int c0,
                                             long long pos0, long long pos_end, int npos,
                                             int nb, int nbp, int shift) {
  constexpr int per_pos = WIDTH / VEC, step = kThreads / per_pos;
  static_assert(kThreads % per_pos == 0, "a thread keeps one channel offset");
  const int c = (threadIdx.x % per_pos) * VEC;
  int q = threadIdx.x / per_pos;
  int rr = q / nb, n = q - rr * nb;
  const bool col_ok = c0 + c < channels;
  const float* from = src + (pos0 + q) * channels + c0 + c;
  for (; q < npos; q += step) {
    const bool ok = col_ok && pos0 + q < pos_end;
    copy_async<VEC>(dst + (rr * nbp + n + shift) * (WIDTH + kRowPad) + c, ok ? from : src, ok);
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
  if (p.vec == 4) {
    load_operand<kBm, 4>(ds, p.dy, p.co, co0, pos0, pos_end, npos, p.nb, nbp, 0);
    load_operand<kBn, 4>(zs, p.z, p.ci, ci0, pos0, pos_end, npos, p.nb, nbp, p.dc);
  } else {
    load_operand<kBm, 1>(ds, p.dy, p.co, co0, pos0, pos_end, npos, p.nb, nbp, 0);
    load_operand<kBn, 1>(zs, p.z, p.ci, ci0, pos0, pos_end, npos, p.nb, nbp, p.dc);
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

// ---- dw_wgmma_kernel -------------------------------------------------------

constexpr int kWgRows = 8;       // rows per stage: one 8-deep K group per position
constexpr int kWgCo = 64;        // co per block: wgmma's M
constexpr int kWgConsumers = 2;  // consumer warpgroups; stage s goes to s % 2
constexpr int kWgThreads = 128 * kWgConsumers + 32;  // and one producer warp
// The ring: a consumer warpgroup keeps its last stage until its next one
// has issued, so stage s + stages can load only after stage s + 2 has
// arrived: at least 3 stages.
constexpr int kWgMinStages = 3;
constexpr int kWgMaxStages = 8;
// SM clock cycles (about 10 s) a wait may take before it is taken for a
// deadlock: the kernel traps (a launch failure the caller sees) instead
// of hanging the card.
constexpr long long kWgWaitCycles = 1LL << 34;

// ci per block of the KB instance: 64 x N x KB float32 accumulators a
// warpgroup, KB * N / 2 registers a thread (128 at KB = 4 and KB = 8).
__host__ __device__ constexpr int wg_tile_ci(int kb) { return kb <= 4 ? 64 : 32; }

struct WgParams {
  float* part;  // [2 splits, KB, ci_pad, co_pad]: one slot per consumer warpgroup
  long long rows;
  long long rows_per_split;  // a multiple of kWgRows
  int ci, co, dc;
  int nbp;     // staged positions per row: NB + KB - 1 rounded up to even
  int stages;  // ring depth, kWgMinStages .. kWgMaxStages
};

// Bytes of one stage: dy [8 nbp K-rows][64 co] then z [8 (nbp + KB - 1)
// K-rows][N ci], bf16, rounded up to 1024 so every stage starts on the
// 128-byte swizzle's 1024-byte pattern.
__host__ __device__ inline int wg_stage_bytes(int nbp, int kb) {
  const int bytes = kWgRows * nbp * kWgCo * 2 + kWgRows * (nbp + kb - 1) * wg_tile_ci(kb) * 2;
  return (bytes + 1023) / 1024 * 1024;
}

// A consumer warpgroup's flush buffer: one tap's partial sums as two
// boxes of N ci rows by 32 co floats (128 bytes, swizzled as TMA's
// 128-byte swizzle has it, so that the fragment's stores fall in
// distinct banks).
constexpr int kWgFlushCo = 32;
__host__ __device__ inline int wg_flush_bytes(int kb) { return wg_tile_ci(kb) * kWgCo * 4; }

// Shared memory of one block: 1024 bytes to align the ring, the ring, a
// flush buffer per consumer warpgroup, and a full and an empty mbarrier
// per stage.
__host__ __device__ inline int wg_smem_bytes(int nbp, int kb, int stages) {
  return 1024 + stages * wg_stage_bytes(nbp, kb) + kWgConsumers * wg_flush_bytes(kb) +
         2 * kWgMaxStages * 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrives and adds `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > kWgWaitCycles) __trap();
  }
}

// One box of a 3-D tensor map at coordinates (c0, c1, c2) into shared
// memory at `dst`, completing on mbarrier `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A box of a 2-D tensor map from shared memory to global memory: stored,
// or added to what is there (the L2 adds), and their completion.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.tile.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_add_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.tile.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Until the committed groups have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Until the committed groups have completed, their writes made.
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Barrier `id` (1 + warpgroup) among the 128 threads of one warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma fences, commits and waits around it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&c)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(c[i])::"memory");
}

// A wgmma shared-memory descriptor: start address, both byte offsets (one
// 8-row group of a swizzle atom: with one atom across M or N, the offset
// across atoms is never used), and the swizzle (1: 128 bytes, 2: 64).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t group_bytes, uint32_t swizzle) {
  const uint64_t off = (group_bytes >> 4) & 0x3FFF;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (off << 16) | (off << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

// D[64 x N] += A[64 x 16] B[16 x N], bf16 operands from shared memory,
// both MN-major (transpose flags 1), float32 accumulators.  Thread t of the
// warpgroup holds, in c[4j + e], row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2)
// and column 8j + 2 (t % 4) + e % 2.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&c)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&c)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]), "+f"(c[5]), "+f"(c[6]),
        "+f"(c[7]), "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]), "+f"(c[12]), "+f"(c[13]),
        "+f"(c[14]), "+f"(c[15]), "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]), "+f"(c[20]),
        "+f"(c[21]), "+f"(c[22]), "+f"(c[23]), "+f"(c[24]), "+f"(c[25]), "+f"(c[26]), "+f"(c[27]),
        "+f"(c[28]), "+f"(c[29]), "+f"(c[30]), "+f"(c[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&c)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]), "+f"(c[5]), "+f"(c[6]),
        "+f"(c[7]), "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]), "+f"(c[12]), "+f"(c[13]),
        "+f"(c[14]), "+f"(c[15])
      : "l"(a), "l"(b), "r"(1));
}

// Block (x, y, z) covers ci [N x, N x + N), co [64 y, 64 y + 64) and the
// rows of split z.  Warps 0-7 are the two consumer warpgroups, warp 8 the
// producer.
template <int KB>
__global__ void __launch_bounds__(kWgThreads, 1)
    dw_wgmma_kernel(const __grid_constant__ CUtensorMap zmap,
                    const __grid_constant__ CUtensorMap dymap,
                    const __grid_constant__ CUtensorMap partmap, const WgParams p) {
  constexpr int N = wg_tile_ci(KB);
  constexpr uint32_t kDyGroup = kWgRows * kWgCo * 2;  // bytes of 8 K-rows of dy: 1024
  constexpr uint32_t kZGroup = kWgRows * N * 2;       // of z: 1024, or 512 at N = 32
  constexpr uint32_t kZSwizzle = N == 64 ? 1 : 2;     // 128- or 64-byte swizzle
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* ring_ptr = smem_raw + (ring - raw);
  const uint32_t stage_bytes = wg_stage_bytes(p.nbp, KB);
  const uint32_t dy_bytes = kWgRows * p.nbp * kWgCo * 2;
  const uint32_t z_box_bytes = kWgRows * p.nbp * N * 2;
  const uint32_t flush0 = ring + p.stages * stage_bytes;  // warpgroup w's at + w * flush bytes
  const uint32_t full0 = flush0 + kWgConsumers * wg_flush_bytes(KB);  // full[i] at full0 + 8 i
  const uint32_t empty0 = full0 + 8 * kWgMaxStages;
  // the warp index through a shuffle, which the compiler knows is uniform
  // across the warp
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full0 + 8 * i, 1);  // the producer's arrive, plus the bytes
      mbar_init(empty0 + 8 * i, 4);  // one arrive from each warp of a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Zero the 8 (KB - 1) K-rows after each stage's z once; TMA writes the rest.
  if constexpr (KB > 1) {
    const int tail = kWgRows * (KB - 1) * N * 2 / 16;  // 16-byte stores a stage
    for (int i = threadIdx.x; i < p.stages * tail; i += kWgThreads) {
      const int s = i / tail, k = i - s * tail;
      uint8_t* z = ring_ptr + s * stage_bytes + dy_bytes + z_box_bytes;
      reinterpret_cast<uint4*>(z)[k] = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  }
  __syncthreads();

  const long long r_begin = static_cast<long long>(blockIdx.z) * p.rows_per_split;
  const long long r_end = r_begin + p.rows_per_split < p.rows ? r_begin + p.rows_per_split : p.rows;
  const int n_stages = static_cast<int>((r_end - r_begin + kWgRows - 1) / kWgRows);
  const int ci0 = blockIdx.x * N, co0 = blockIdx.y * kWgCo;

  if (warp == 4 * kWgConsumers) {  // the producer
    if (lane == 0) {
      for (int s = 0; s < n_stages; ++s) {
        const int slot = s % p.stages, round = s / p.stages;
        if (round > 0) mbar_wait(empty0 + 8 * slot, (round - 1) & 1);
        const uint32_t full = full0 + 8 * slot, dst = ring + slot * stage_bytes;
        const int r0 = static_cast<int>(r_begin) + s * kWgRows;
        mbar_expect_tx(full, dy_bytes + z_box_bytes);
        tma_load_3d(dst, &dymap, full, co0, r0, 0);
        tma_load_3d(dst + dy_bytes, &zmap, full, ci0, r0, -p.dc);
      }
    }
    return;
  }

  // A consumer warpgroup: stages wg, wg + 2, ...  Every branch below that
  // touches the accumulators depends on warp-uniform values only (warp
  // from a shuffle, loop bounds from the block), and the flush stores all
  // of them, into scratch padded to whole tiles: an accumulator read under
  // a per-lane condition makes ptxas serialise every wgmma.
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, q = lane & 3;
  const int n_own = n_stages > wg ? (n_stages - wg + 1) / 2 : 0;
  const int k16_steps = kWgRows * p.nbp / 16;
  const int flush_stages = kFlushPositions / (kWgRows * p.nbp) > 0
                               ? kFlushPositions / (kWgRows * p.nbp) : 1;
  // Warpgroup 1's windows are offset by half a window, so that the two
  // warpgroups do not flush at the same time.
  const int offset = wg * (flush_stages / 2);
  const int windows = n_own + offset > flush_stages ? (n_own + offset + flush_stages - 1) / flush_stages : 1;
  const int ci_pad = gridDim.x * N, co_pad = gridDim.y * kWgCo;
  float* out = p.part + (static_cast<long long>(blockIdx.z) * kWgConsumers + wg) * KB * ci_pad * co_pad;
  float acc[KB][N / 2];
#pragma unroll
  for (int d = 0; d < KB; ++d)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[d][i] = 0.f;

  for (int w = 0; w < windows; ++w) {
    const int j0 = w * flush_stages - offset > 0 ? w * flush_stages - offset : 0;
    const int j1 = (w + 1) * flush_stages - offset < n_own ? (w + 1) * flush_stages - offset : n_own;
    for (int j = j0; j < j1; ++j) {
      const int s = wg + kWgConsumers * j, slot = s % p.stages;
      mbar_wait(full0 + 8 * slot, (s / p.stages) & 1);
      const uint32_t a0 = ring + slot * stage_bytes, b0 = a0 + dy_bytes;
#pragma unroll
      for (int d = 0; d < KB; ++d) fence_regs(acc[d]);
      wgmma_fence();
      for (int kk = 0; kk < k16_steps; ++kk) {
        // k16 step kk: K-rows 16 kk .. 16 kk + 15 (two 8-row groups); tap
        // d reads z d groups further on
        const uint64_t a = wg_desc(a0 + 2 * kk * kDyGroup, kDyGroup, 1);
#pragma unroll
        for (int d = 0; d < KB; ++d)
          wgmma_bf16<N>(acc[d], a, wg_desc(b0 + (2 * kk + d) * kZGroup, kZGroup, kZSwizzle));
      }
      wgmma_commit();
#pragma unroll
      for (int d = 0; d < KB; ++d) fence_regs(acc[d]);
      if (j > j0) {
        wgmma_wait<1>();  // the previous stage's group has completed
        if (lane == 0) mbar_arrive(empty0 + 8 * ((s - kWgConsumers) % p.stages));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int d = 0; d < KB; ++d) fence_regs(acc[d]);
    if (j1 > j0 && lane == 0) mbar_arrive(empty0 + 8 * ((wg + kWgConsumers * (j1 - 1)) % p.stages));
    // Every kFlushPositions K-rows, and at the end, the accumulators are
    // added (in the first window: written) to this warpgroup's partial
    // sums in float32, rounding to nearest, and restart from zero; a
    // warpgroup without stages writes its zeros.  One tap at a time, the
    // warpgroup writes its fragment to its flush buffer, and one thread
    // hands the buffer's two boxes to TMA: tensor stores in the first
    // window, tensor adds (which the L2 performs) after it, so nothing
    // waits for a load.  That thread waits for the previous flush's adds to
    // complete before it issues new ones to the same addresses, so the
    // sums are added in the same order at every launch.
    const bool first = w == 0;
    const bool issuer = wl == 0 && lane == 0;
    const uint32_t buf = flush0 + wg * wg_flush_bytes(KB);
    uint8_t* buf_ptr = ring_ptr + (buf - ring);
    const int slot_row = (blockIdx.z * kWgConsumers + wg) * KB * ci_pad + ci0;  // partmap's row
    if (issuer) bulk_wait();
#pragma unroll
    for (int d = 0; d < KB; ++d) {
      if (d > 0 && issuer) bulk_wait_read();
      warpgroup_sync(1 + wg);  // the buffer is free
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        // row r (ci), column c (co): box c / 32, its 16-byte chunk
        // (c % 32) / 4 swizzled by r % 8
        const int r = 8 * (i >> 2) + 2 * q + (i & 1), c = 16 * wl + g + 8 * ((i >> 1) & 1);
        const int off = (c / kWgFlushCo) * N * 128 + r * 128 + ((((c % kWgFlushCo) >> 2) ^ (r & 7)) << 4) +
                        (c & 3) * 4;
        *reinterpret_cast<float*>(buf_ptr + off) = acc[d][i];
        acc[d][i] = 0.f;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
      warpgroup_sync(1 + wg);
      if (issuer) {
        for (int h = 0; h < kWgCo / kWgFlushCo; ++h) {
          if (first)
            tma_store_2d(&partmap, buf + h * N * 128, co0 + h * kWgFlushCo, slot_row + d * ci_pad);
          else
            tma_add_2d(&partmap, buf + h * N * 128, co0 + h * kWgFlushCo, slot_row + d * ci_pad);
        }
        bulk_commit();
      }
    }
  }
  if (wl == 0 && lane == 0) bulk_wait();  // the last adds are made before the block ends
}

// out[d, k, o] = sum over s of part[s, d, k, o], s in increasing order,
// from scratch [slots, KB, ci_pad, co_pad] (unpadded for dw_mma_kernel,
// padded to whole tiles for dw_wgmma_kernel).
__global__ void dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int kb,
                                 int ci, int co, int ci_pad, int co_pad, int slots) {
  const long long n = static_cast<long long>(kb) * ci * co;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int o = static_cast<int>(i % co);
  const long long dk = i / co;
  const int k = static_cast<int>(dk % ci), d = static_cast<int>(dk / ci);
  const long long slot = static_cast<long long>(kb) * ci_pad * co_pad;
  const float* src = part + (static_cast<long long>(d) * ci_pad + k) * co_pad + o;
  float s = 0.f;
  for (int t = 0; t < slots; ++t) s += src[t * slot];
  out[i] = s;
}

template <int KB>
cudaError_t launch_partial(const Params& p, int splits, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(dw_mma_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.ci + kBn - 1) / kBn, (p.co + kBm - 1) / kBm, splits);
  dw_mma_kernel<KB><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Resident blocks per SM of a kernel of `threads` threads at `smem` bytes.
template <typename Kernel>
cudaError_t occupancy_of(Kernel kernel, int threads, int smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads,
                                                       static_cast<size_t>(smem));
}

template <int KB>
cudaError_t occupancy(int smem, bool wgmma, int* blocks) {
  if (wgmma) return occupancy_of(dw_wgmma_kernel<KB>, kWgThreads, smem, blocks);
  return occupancy_of(dw_mma_kernel<KB>, kThreads, smem, blocks);
}

cudaError_t reduce_slots(const float* part, float* out, int kb, int ci, int co, int ci_pad, int co_pad,
                         int slots, cudaStream_t stream) {
  const long long n = static_cast<long long>(kb) * ci * co;
  const int threads = 256;
  dw_reduce_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0, stream>>>(
      part, out, kb, ci, co, ci_pad, co_pad, slots);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (so that the
// library links no driver symbol), or null where the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                                                       : nullptr;
  }();
  return fn;
}

// Codes at and above this are kTensorMapError + the CUresult of
// cuTensorMapEncodeTiled; below, CUDA runtime error codes.
constexpr int kTensorMapError = 100000;

// The tensor map of one operand x [rows, nb, c] bf16 for dw_wgmma_kernel:
// dimensions (channels, rows, block positions), so that a box (box_c, 8
// rows, nbp positions) lands as [position][row][box_c channels].
int encode_operand(CUtensorMap* map, const void* x, long long rows, int nb, int c, int box_c,
                   int nbp) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(nb)};
  const cuuint64_t strides[2] = {2ull * nb * c, 2ull * c};  // bytes: a row, a block position
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_c), kWgRows, static_cast<cuuint32_t>(nbp)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            box_c == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// The tensor map of dw_wgmma_kernel's scratch [rows, co_pad] float32, rows
// = (slot, tap, ci): boxes of 32 co by tile_ci rows, 128-byte swizzle.
int encode_part(CUtensorMap* map, float* part, long long rows, int co_pad, int tile_ci) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(co_pad), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {4ull * co_pad};
  const cuuint32_t box[2] = {kWgFlushCo, static_cast<cuuint32_t>(tile_ci)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, part, dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

template <int KB>
cudaError_t launch_wgmma(const CUtensorMap& zmap, const CUtensorMap& dymap, const CUtensorMap& partmap,
                         const WgParams& p, int splits, cudaStream_t stream) {
  const int smem = wg_smem_bytes(p.nbp, KB, p.stages);
  cudaError_t err = cudaFuncSetAttribute(dw_wgmma_kernel<KB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.ci + wg_tile_ci(KB) - 1) / wg_tile_ci(KB), (p.co + kWgCo - 1) / kWgCo, splits);
  dw_wgmma_kernel<KB><<<grid, kWgThreads, smem, stream>>>(zmap, dymap, partmap, p);
  return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory one block of dw_mma_kernel takes (two stages).
extern "C" long long blocked_dw_smem_bytes(int stage_rows, int nb, int kb) {
  return 2LL * sizeof(float) * stage_floats(stage_rows, nb, kb);
}

// Blocks of the KB instance of dw_mma_kernel (wgmma = 0) or
// dw_wgmma_kernel (wgmma = 1) that one SM holds at `smem` bytes each, into
// *blocks.  Returns the CUDA error code (0 on success).
extern "C" int blocked_dw_blocks_per_sm(int kb, int smem, int wgmma, int* blocks) {
  cudaError_t err;
  switch (kb) {
#define DW_OCC(K)                                    \
  case K:                                            \
    err = occupancy<K>(smem, wgmma != 0, blocks); \
    break;
    DW_OCC(1) DW_OCC(2) DW_OCC(3) DW_OCC(4) DW_OCC(5) DW_OCC(6) DW_OCC(7) DW_OCC(8)
#undef DW_OCC
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// dW of one blocked frequency conv on `stream` by dw_mma_kernel.  z
// [rows, nb, ci] and dy [rows, nb, co] contiguous float32; out [kb, ci,
// co] float32.  `part` is scratch of splits * kb * ci * co floats (unused
// when splits == 1, when the partial kernel writes `out` directly).  Row
// split s covers rows [s * rows_per_split, (s + 1) * rows_per_split), in
// stages of stage_rows rows; a block covers 32 co by 32 ci.  Returns the
// CUDA error code of the launches (0 on success); never synchronises.
extern "C" int blocked_dw_forward(const float* z, const float* dy, float* out, float* part,
                                  long long rows, int nb, int ci, int co, int kb, int dc,
                                  long long rows_per_split, int splits, int stage_rows,
                                  void* stream) {
  if (rows < 1 || nb < 1 || ci < 1 || co < 1 || kb < 1 || kb > kMaxKb || dc < 0 || dc >= kb ||
      rows_per_split < 1 || splits < 1 || stage_rows < 1 ||
      (splits - 1) * rows_per_split >= rows || splits * rows_per_split < rows ||
      stage_rows * (nb + kb - 1) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(z) % 16 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  const int vec = (aligned && ci % 4 == 0 && co % 4 == 0) ? 4 : 1;
  const Params p{z, dy, splits == 1 ? out : part, rows, rows_per_split, nb, ci, co, dc,
                 stage_rows, vec};
  const size_t smem = static_cast<size_t>(blocked_dw_smem_bytes(stage_rows, nb, kb));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kb) {
#define DW_CASE(K)                                 \
  case K:                                          \
    err = launch_partial<K>(p, splits, smem, s); \
    break;
    DW_CASE(1) DW_CASE(2) DW_CASE(3) DW_CASE(4) DW_CASE(5) DW_CASE(6) DW_CASE(7) DW_CASE(8)
#undef DW_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(reduce_slots(part, out, kb, ci, co, ci, co, splits, s));
}

// dW of one blocked frequency conv on bf16 z [rows, nb, ci] and dy [rows,
// nb, co] by dw_wgmma_kernel on `stream`: ci and co multiples of 8, both
// pointers 16-byte aligned, nbp = NB + KB - 1 rounded up to even and at
// most 256; out [kb, ci, co] float32.  `part` is scratch of 2 * splits *
// kb * ci_pad * co_pad floats (a slot per consumer warpgroup of each split;
// ci and co padded to whole tiles: tile_ci and 64).  Row
// split s covers rows [s * rows_per_split, (s + 1) * rows_per_split),
// rows_per_split a multiple of 8, in a ring of `stages` stages.  Returns
// 0, a CUDA error code, or kTensorMapError + the CUresult of a refused
// tensor map; never synchronises.
extern "C" int blocked_dw_wgmma(const void* z, const void* dy, float* out, float* part,
                                long long rows, int nb, int ci, int co, int kb, int dc,
                                long long rows_per_split, int splits, int stages, void* stream) {
  const int nbp = (nb + kb - 1 + 1) / 2 * 2;
  const auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  if (rows < 1 || nb < 1 || ci < 8 || co < 8 || ci % 8 != 0 || co % 8 != 0 || kb < 1 ||
      kb > kMaxKb || dc < 0 || dc >= kb || nbp > 256 || rows_per_split < 1 ||
      rows_per_split % kWgRows != 0 || splits < 1 || (splits - 1) * rows_per_split >= rows ||
      splits * rows_per_split < rows || rows >= (1LL << 31) || stages < kWgMinStages ||
      stages > kWgMaxStages || !aligned(z) || !aligned(dy))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile_ci = wg_tile_ci(kb);
  const int ci_pad = (ci + tile_ci - 1) / tile_ci * tile_ci, co_pad = (co + kWgCo - 1) / kWgCo * kWgCo;
  CUtensorMap zmap, dymap, partmap;
  int rc = encode_operand(&zmap, z, rows, nb, ci, tile_ci, nbp);
  if (rc == 0) rc = encode_operand(&dymap, dy, rows, nb, co, kWgCo, nbp);
  if (rc == 0)
    rc = encode_part(&partmap, part, static_cast<long long>(kWgConsumers) * splits * kb * ci_pad, co_pad,
                     tile_ci);
  if (rc != 0) return rc;
  const WgParams p{part, rows, rows_per_split, ci, co, dc, nbp, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kb) {
#define DW_WG(K)                                          \
  case K:                                                 \
    err = launch_wgmma<K>(zmap, dymap, partmap, p, splits, s); \
    break;
    DW_WG(1) DW_WG(2) DW_WG(3) DW_WG(4) DW_WG(5) DW_WG(6) DW_WG(7) DW_WG(8)
#undef DW_WG
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_slots(part, out, kb, ci, co, ci_pad, co_pad, kWgConsumers * splits, s));
}

extern "C" const char* blocked_dw_error_string(int code) {
  if (code >= kTensorMapError) return "cuTensorMapEncodeTiled refused the tensor map (CUresult = code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
