// Fused inner conv stack of the R-CED / CR-CED denoisers, inference mode.
//
// Replaces the TPU kernel `_stack_kernel` of
// fullycnnspeechenhancement_tpu/ops/pallas_rced.py (launched by
// `_fused_inference_forward` there).  It runs layers 2..n-1 of V1/V2/V3
// with batch norm folded into the weights.  Each of them is a (1, kw <= 13)
// frequency-only conv, then the bias, the pre-ReLU skip (V1/V2), the ReLU
// and the post-ReLU residual (V3).  Layer 1 (the only conv with a time
// extent) and the final (1, 129) projection run outside, in the two
// kernels of rced_edges.cu.
//
// Per frame and layer the conv is a GEMM:
//
//   out[f, co] = sum_{j, ci} x[ci, f + j - lo] * w[j, ci, co]
//
// with M = 129 bins (padded to 144, nine m16 tiles), N = cout <= 32 (padded
// to n8 tiles) and K = cin * kw <= 253 (tap-outer, channel-inner, padded to
// k8 chunks with zero weights).
//
// What bounds it on an H100: arithmetic.  V2 does 3,723,162 multiply-adds
// per frame in these layers (only taps that meet one of the 129 bins count;
// the rest fall on the zero halo) and moves only its input and output
// (10 + 10 channels of 4 bytes per (frame, bin)), so at 64 x 8 s the
// products need 2.3781e11 FLOP against 0.1 ms of device memory.  On the
// tensor cores in 3xTF32 (three TF32 products for each float32 one) that is
// 1.441 ms at the data sheet's 495 TFLOP/s (3.549 ms at the 67 TFLOP/s
// float32 rate without them).  mma.sync, which this kernel issues, reaches
// about half of the data sheet's TF32 rate on the card (chip_smoke.py
// measures it), and the m16n8k8 tiles compute 1.386x those products, so
// this design's floor is about 3.96 ms there.
//
// What the design does about it.
// - Tensor cores at float32 accuracy (3xTF32, as in blocked_dw.cu): an
//   activation x is split, as its A fragment is loaded, into big = x with
//   its 13 low mantissa bits cleared and small = the same of x - big; the
//   weights are split the same way once, on the host
//   (`pack_inference_stack`), and stored in fragment order, so a lane's
//   B fragment of one (k8, n8) tile, big and small, is one 16-byte load.
//   Each tile accumulates small*big, big*small, big*big, one pass of each
//   over all of a warp's accumulators.  A layer sums at most 32 k8 chunks,
//   so the tensor cores' truncating accumulation stays inside float32's
//   tolerance without the flushes blocked_dw.cu needs.
// - No im2col copy: a block keeps every live value of one frame in shared
//   memory, one row of kRow floats per channel with bin f at kHalo + f and
//   zeros around the 129 bins, so the tap shift is an address offset.  The
//   host gives each k its offset (ci * kRow + kHalo - lo + j); lane (g, t)
//   of an A fragment reads offset[k0 + t] + m0 + g.  kRow = 136 leaves 7
//   zeros between two rows' bins, shared as the right halo of one and the
//   left halo of the next (each needs 6), and is 8 mod 32: the four
//   channels of an in-tap k quad land in four distinct 8-bank groups, so
//   an A fragment load is free of bank conflicts except where a quad
//   straddles two taps.  The padded bins 129..143 read up to 19 floats
//   into the next row or past the last (the slack); their outputs are
//   computed and never written, so halos stay zero and no other row is
//   touched.
// - Equal work per warp: nine warps, each one m16 tile and every n8 tile
//   of the layer, so a layer ends at its __syncthreads with every warp
//   done at once.  Output channels pad only to a multiple of 8.
// - Weights are read through the read-only cache.  Each warp loads a B
//   fragment for its one m tile, so at V2's three n tiles 16 L1
//   wavefronts of 128 bytes (4 for A, 12 for B) feed 9 mma, each of 1024
//   multiply-adds; the SIMT design needed a shared-memory wavefront for
//   every 4 FMA a lane, which capped it near half the float32 rate.  Three
//   m tiles a warp would
//   cut that, but leave 6 warps an SM (96 threads a block); and loading
//   the next chunk into registers before this one's products spills at
//   the register cap of 2 blocks an SM.  Both ran slower on the H100; the
//   chunk loop is unrolled by two instead, which ran faster than no
//   unrolling.
// - Occupancy: V2's 162 rows take 88 KB at kRow = 136 (91 KB at the SIMT
//   design's 141), so 2 blocks (18 warps) share an SM; 129 floats a row
//   would still allow only 2.
// - One block per frame, which zeroes its shared memory first: on an H100
//   this ran 3% faster at V2 64 x 8 s than persistent blocks (one per
//   resident slot, looping over frames, zeroing once), and no slower on a
//   single request of T = 124, 499 or 1999 frames.  A 1.5 s request
//   (T = 124) fills 124 of the card's 264 slots; its stack takes about
//   0.06 ms of a request that waits on the host, so frames are not split
//   further.
//
// The bf16 operand mode (the JAX kernel's dtype="bfloat16": weights and
// matmul operands in bf16, slabs, biases and sums in float32) is a second
// kernel, rced_stack_wgmma_kernel: products exact in float32, sums in
// float32, bias, skip, ReLU and residual on float32 values, built for
// Hopper.  ops/rced_stack.py packs it for every model whose shapes it
// takes (all of V1/V2/V3) and refuses a bf16 pack of any other.
// The bound of this mode at V2 64 x 8 s: the same 2.3781e11 FLOP at the
// data sheet's 989 TFLOP/s dense bf16 rate, 0.240 ms, against 0.1 ms of
// device memory.  On an H100 the float32 kernel above with a bf16 layer
// body (mma.sync.m16n8k16, each A value rounded to bf16 as its fragment
// loaded) ran at 12% of the floor its tiles set: per k16 chunk a lane
// waited on four dependent loads of the offset table, eight float32 loads
// and four conversions before its two to four mma, every activation was
// rounded again for every tap and m tile that read it, and every warp
// fetched the same B fragments.  This kernel answers each of those:
// - A bf16 operand copy of each layer's input, the shadow, written once:
//   the input load, and the epilogue of the layer before, write each value
//   rounded by cvt.rn (as ops/rced_stack.py::_as_operand does) into
//   [channel group of 8][bin row][8 channels], 16 bytes a row.  A tap's
//   shift of j - lo bins then moves a row address by 16 bytes, so no
//   offset table and no conversion is left in the products' loop.  A group has kWgRows = 135 rows: bins
//   0..128, then 6 zero rows that are the next group's left halo (kWgLead
//   zero rows precede group 0).  Nothing writes past bin 128, so a block
//   zeroes its shadows once, not every frame.  Layer l reads shadow l % 2
//   and writes the other.
// - wgmma.mma_async.m64nNk16.f32.bf16.bf16 with N = cout padded to 8 (8,
//   16, 24 or 32) and both operands K-major without swizzle from shared
//   memory.  Bins 0..127 are two m64 tiles, one warpgroup each.  A core
//   matrix of A is 8 bin rows of one channel group (128 bytes), so the
//   stride-byte offset is 128; an instruction's k16 pairs two k8 blocks
//   (tap, channel group), and the distance between their rows is that
//   instruction's own leading-byte offset (the host's table, per
//   instruction: start row | offset << 16), so channels pad to 8 per tap,
//   not 16.  Two taps of one group overlap (16 bytes apart), and an odd
//   block count ends in a pad block of zero weights whose offset is 0:
//   chip_smoke.py phase 2 holds both against a model of the descriptor.
//   B, the folded bf16 weights, lies in the canonical K-major layout: per
//   instruction two halves of n / 8 core matrices of 8 columns by 16
//   bytes (leading-byte offset 16 n, stride-byte offset 128).
// - Bin 128, the one bin past two tiles, is the edge warp's: an m16 tile
//   of bins 128..143 by mma.sync.m16n8k16, A by ldmatrix from the same
//   shadow rows and B from the same chunk.  In bring-up on an H100 a third
//   m64 tile (bins 128..191, one real bin in 64) ran slower than the edge
//   warp, and bin 128 on the FMA units took issue slots from the tiles'
//   epilogues and ran slower than mma.sync.
// - Each layer's weights, biases and table are one chunk the host packs;
//   the edge warp's lane 0, which no wgmma waits for, stages it by one
//   bulk copy (TMA, from L2) on an mbarrier into one of two buffers, a
//   layer ahead.  Blocks are persistent (frames blockIdx.x, blockIdx.x +
//   gridDim.x, ...), so the next frame's first chunk is staged during the
//   last layer, and its input rows are fetched into L2 then.
// - The epilogue takes every accumulator, unconditionally: ptxas
//   serialises every wgmma of a kernel that reads an accumulator under a
//   per-lane condition.  Reads are clamped into their rows (channel cout -
//   1) and writes that must not land go to dump addresses (a float past
//   the float32 rows, the first shadow row after the last group); channels
//   past cout are written to the shadow as zeros, by a select.  Float32 is
//   kept only for values a later epilogue reads (skip and residual
//   sources, and the stack's output, copied out at the end), in rows of
//   kWgF32Row = 132 floats (4 mod 32: an epilogue's loads and stores are
//   free of bank conflicts).
// - Ordering: the epilogue writes the shadow with generic stores and the
//   next layer's wgmma reads it through the async proxy, so every thread
//   fences (fence.proxy.async) before the layer's one __syncthreads;
//   wgmma.fence, commit_group and wait_group 0 surround the products.  The
//   products of a warpgroup issue in a loop and complete before its
//   epilogue: interleaving two frames in a block, one frame's epilogue
//   while the other's products fly, made ptxas wait on every wgmma
//   (WARPGROUP.DEPBAR after each in the SASS) and ran slower.
// - Shared memory, V2 (the largest of V1/V2/V3): two shadows of (6 + 4 x
//   135 + 16) rows of 16 bytes (17,984 bytes), float32 rows for the input
//   and encode_2..encode_7 (114 x 132 floats and the dump, 60,208 bytes,
//   the stack's output reusing them), and the two weight buffers (17,616
//   bytes for encode_8's chunk, 10,912 for decode_1's): 106,736 bytes, so
//   two blocks (two frames) share an SM.  All of V2's B resident (81 KB)
//   would leave room for one frame's float32 rows only.
// - What it costs in products: 144 rows for 129 bins, channels padded to 8
//   a tap, cout to 8 and a block count to even: 1.61x V2's needed
//   products, 1.43x by wgmma (a floor of 0.36 ms at the 936 TFLOP/s phase
//   2 measures for it) and 0.18x by mma.sync (0.09 ms at 502).  What binds
//   it is latency: a frame's layers are serial, each a chunk wait, the
//   products, the epilogue and a barrier, and an SM holds two frames.  A
//   from shared memory takes 2 KB an instruction, 16 of the SM's 128-byte
//   cycles, against 12 cycles of products at N = 24, so while both blocks
//   of an SM issue their products, shared-memory reads set their pace.
//
// Layout: x [B, c_in, T, 129] and y [B, c_out, T, 129], float32, NCHW.  The
// per-layer plan (chunks, n tiles, cout, shared-memory offsets of input,
// output, skip and add rows, ReLU, weight and offset-table positions) is
// computed by ops/rced_stack.py and passed by value.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBins = 129;
constexpr int kHalo = 6;
constexpr int kRow = 136;  // floats per channel row: 129 bins + 7 shared zeros
constexpr int kMTiles = 9;  // m16 tiles over bins 0..143, one to a warp
constexpr int kThreads = 32 * kMTiles;
constexpr int kMaxLayers = 16;
constexpr int kMaxNTiles = 4;  // cout <= 32
constexpr int kRec = 10;

enum Field { kChunks, kNTiles, kCout, kInOff, kOutOff, kSkipOff, kAddOff, kRelu, kWOff, kKOff };

struct Plan {
  int rec[kMaxLayers][kRec];
};

// x = big + small + O(2^-20 |x|): big is x with its 13 low mantissa bits
// cleared (a TF32 value), x - big is exact, and small is that with its own
// 13 low bits cleared.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The epilogue in the reference's order: bias, pre-ReLU skip, ReLU,
// residual.  C element e of a tile is bin m0 + g (+ 8 for e >= 2) and
// channel n0 + 2t + (e & 1); bins past 128 and channels past cout are
// dropped.
template <int NT>
__device__ __forceinline__ void store_layer(const float (&acc)[NT][4], float* out,
                                            const float* skip, const float* add, bool relu,
                                            const float* __restrict__ bias, int cout, int warp,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = warp * 16 + g + (e >> 1) * 8;
      const int co = n * 8 + 2 * t + (e & 1);
      if (m < kBins && co < cout) {
        const int o = co * kRow + kHalo + m;
        float y = acc[n][e] + __ldg(bias + co);
        if (skip) y += skip[o];
        if (relu) y = fmaxf(y, 0.f);
        if (add) y += add[o];
        out[o] = y;
      }
    }
}

// One layer of one frame for this warp's m16 tile and all NT n tiles.
// `in`, `out`, `skip` and `add` point at channel rows in shared memory.
// `wf` holds the layer's B fragments, [chunk][NT][lane] float4s of (big
// b0, big b1, small b0, small b1); `koff` the chunks * 8 A offsets.
template <int NT>
__device__ __forceinline__ void conv_layer(const float* in, float* out, const float* skip,
                                           const float* add, bool relu,
                                           const float4* __restrict__ wf,
                                           const float* __restrict__ bias,
                                           const int* __restrict__ koff, int chunks, int cout,
                                           int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;  // the fragments' groupID, thread in group
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float* a = in + warp * 16 + g;
  // Two chunks a round: one chunk's loads overlap the other's products.
#pragma unroll 2
  for (int c = 0; c < chunks; ++c) {
    // A[m][k] sits at in + koff[k] + m; this lane's k are k0 + t and k0 + t + 4
    const int o0 = __ldg(koff + 8 * c + t);
    const int o1 = __ldg(koff + 8 * c + t + 4);
    uint32_t ab[4], as[4];
    split_tf32(a[o0], ab[0], as[0]);      // (g, t)
    split_tf32(a[o0 + 8], ab[1], as[1]);  // (g + 8, t)
    split_tf32(a[o1], ab[2], as[2]);      // (g, t + 4)
    split_tf32(a[o1 + 8], ab[3], as[3]);  // (g + 8, t + 4)
    float4 b[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) b[n] = __ldg(wf + (c * NT + n) * 32 + lane);
    // One pass of each product over all accumulators before the next, so
    // that back-to-back mma are independent.
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_tf32(acc[n], as, __float_as_uint(b[n].x), __float_as_uint(b[n].y));
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_tf32(acc[n], ab, __float_as_uint(b[n].z), __float_as_uint(b[n].w));
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_tf32(acc[n], ab, __float_as_uint(b[n].x), __float_as_uint(b[n].y));
  }
  store_layer<NT>(acc, out, skip, add, relu, bias, cout, warp, lane);
}

__global__ void __launch_bounds__(kThreads, 2)
rced_stack_kernel(const float* __restrict__ x, float* __restrict__ y,
                  const float* __restrict__ weights, const int* __restrict__ koffs,
                  const Plan plan, int n_layers, int frames, int c_in, int c_out, int in_off,
                  int out_off, int smem_floats) {
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t plane = static_cast<size_t>(frames) * kBins;

  // Zero everything first: halos, gaps and slack are never written after.
  float4* sm4 = reinterpret_cast<float4*>(sm);
  for (int i = threadIdx.x; i < smem_floats / 4; i += kThreads)
    sm4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int b = blockIdx.x / frames;
  const int t = blockIdx.x - b * frames;
  const float* xs = x + static_cast<size_t>(b) * c_in * plane + static_cast<size_t>(t) * kBins;
  for (int i = threadIdx.x; i < c_in * kBins; i += kThreads) {
    const int c = i / kBins;
    const int f = i - c * kBins;
    sm[in_off + c * kRow + kHalo + f] = __ldg(xs + c * plane + f);
  }
  __syncthreads();

  for (int l = 0; l < n_layers; ++l) {
    const int* r = plan.rec[l];
    const float* in = sm + r[kInOff];
    float* out = sm + r[kOutOff];
    const float* skip = r[kSkipOff] >= 0 ? sm + r[kSkipOff] : nullptr;
    const float* add = r[kAddOff] >= 0 ? sm + r[kAddOff] : nullptr;
    const int nt = r[kNTiles];
    const float* bias = weights + r[kWOff] + r[kChunks] * nt * 128;  // 128 words a tile's fragments
    const int* koff = koffs + r[kKOff];
    const bool relu = r[kRelu] != 0;
    const float4* wf = reinterpret_cast<const float4*>(weights + r[kWOff]);
    switch (nt) {
#define RCED_CASE(N)                                                                     \
  case N:                                                                                \
    conv_layer<N>(in, out, skip, add, relu, wf, bias, koff, r[kChunks], r[kCout], warp,  \
                  lane);                                                                 \
    break;
      RCED_CASE(1) RCED_CASE(2) RCED_CASE(3) RCED_CASE(4)
#undef RCED_CASE
      default: break;  // rejected on the host
    }
    __syncthreads();
  }

  float* ys = y + static_cast<size_t>(b) * c_out * plane + static_cast<size_t>(t) * kBins;
  for (int i = threadIdx.x; i < c_out * kBins; i += kThreads) {
    const int c = i / kBins;
    const int f = i - c * kBins;
    ys[c * plane + f] = sm[out_off + c * kRow + kHalo + f];
  }
}

cudaError_t set_smem(int smem) {
  return cudaFuncSetAttribute(rced_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// ---- rced_stack_wgmma_kernel -------------------------------------------------

constexpr int kWgTiles = 2;  // m64 tiles over bins 0..127, one warpgroup each
constexpr int kWgEdgeWarp = 4 * kWgTiles;  // bin 128, by mma.sync
constexpr int kWgThreads = 128 * kWgTiles + 32;
constexpr int kWgLead = kHalo;          // zero shadow rows before group 0
constexpr int kWgRows = kBins + kHalo;  // shadow rows a channel group
constexpr int kWgSlack = 16;  // shadow rows after the last group: the edge warp's padded rows, the dump row
constexpr int kWgF32Row = 132;          // floats a float32 channel row
constexpr int kWgRec = 12;
constexpr int kWgBarrierBytes = 16;  // two mbarriers at the base
constexpr long long kWgWaitCycles = 1ll << 34;

// A layer's record (ops/rced_stack.py WgField): instructions, n, cout,
// its chunk's byte offset in `weights` and bytes, float offsets of its
// float32 output, skip and residual rows (-1: none), ReLU, cin, and byte
// offsets of the biases and the A table within the chunk.
enum WgField { kWgInstr, kWgN, kWgCout, kWgChunk, kWgChunkBytes, kWgOut, kWgSkip, kWgAdd, kWgRelu,
               kWgCin, kWgBias, kWgTable };
// The block's shared-memory map (WgmmaStack.layout): shadow groups, bytes
// of one shadow, byte offset of the float32 rows, the dump float, float
// offsets of the input's and the output's float32 rows, byte offsets of
// the two weight buffers, total bytes.
enum WgLayout { kLGroups, kLShadowBytes, kLF32, kLDump, kLInF32, kLOutF32, kLBuf0, kLBuf1, kLSmem,
                kLFields };

struct WgPlan {
  int rec[kMaxLayers][kWgRec];
  int lay[kLFields];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Arrives and adds `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Whether the phase of parity `parity` has completed.
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed (the clock is
// read only when the first test fails); a wait past 2^34 cycles traps,
// never hangs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - start > kWgWaitCycles) __trap();
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, by one bulk copy completing on mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma, bulk copies), and the reverse for reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma fences, commits and waits around it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&c)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(c[i])::"memory");
}

// D[64 x N] += A[64 x 16] B[16 x N], bf16 operands from shared memory, both
// K-major (transpose flags 0), float32 accumulators.  Thread t of the
// warpgroup holds, in c[4j + e], row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2)
// and column 8j + 2 (t % 4) + e % 2.
template <int N>
__device__ __forceinline__ void wgmma_k(float (&c)[N / 2], uint64_t a, uint64_t b);

// (scale-d is a predicate: set from operand D, a constant 1)
#define WG_ASM(N, REGS, A, B, D)                                                         \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %" #D ", 0;\n"                        \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, %" #A \
               ", %" #B ", p, 1, 1, 0, 0;\n}\n"

template <>
__device__ __forceinline__ void wgmma_k<8>(float (&c)[4], uint64_t a, uint64_t b) {
  WG_ASM(8, "%0, %1, %2, %3", 4, 5, 6)
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_k<16>(float (&c)[8], uint64_t a, uint64_t b) {
  WG_ASM(16, "%0, %1, %2, %3, %4, %5, %6, %7", 8, 9, 10)
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]), "+f"(c[5]), "+f"(c[6]),
        "+f"(c[7])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_k<24>(float (&c)[12], uint64_t a, uint64_t b) {
  WG_ASM(24, "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11", 12, 13, 14)
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]), "+f"(c[5]), "+f"(c[6]),
        "+f"(c[7]), "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_k<32>(float (&c)[16], uint64_t a, uint64_t b) {
  WG_ASM(32, "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15", 16, 17, 18)
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]), "+f"(c[5]), "+f"(c[6]),
        "+f"(c[7]), "+f"(c[8]), "+f"(c[9]), "+f"(c[10]), "+f"(c[11]), "+f"(c[12]), "+f"(c[13]),
        "+f"(c[14]), "+f"(c[15])
      : "l"(a), "l"(b), "r"(1));
}
#undef WG_ASM

// One float rounded to bf16 (to nearest even), its 16 bits.
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return static_cast<uint16_t>(pack_bf16(v, 0.f) & 0xffffu);
}

// Layer record r's chunk into the buffer of the block's global layer
// count gl (gl % 2), on that buffer's mbarrier (thread 0).  The buffer last
// held global layer gl - 2, which every warp has finished with before the
// barrier that ended global layer gl - 1; each thread fences its generic
// reads of it (the biases, the table) before that barrier.
__device__ __forceinline__ void stage_chunk(const int* r, const WgPlan& p, const uint8_t* weights, uint32_t base,
                                            int gl) {
  const uint32_t bar = base + 8 * (gl & 1);
  const uint32_t bytes = static_cast<uint32_t>(r[kWgChunkBytes]);
  mbar_expect_tx(bar, bytes);
  bulk_load(base + ((gl & 1) ? p.lay[kLBuf1] : p.lay[kLBuf0]), weights + r[kWgChunk], bytes, bar);
}

// A layer's epilogue on one thread's accumulators of J n8 groups: c[4j + e]
// is bin m0 + 8 (e / 2) (m0 + dm for e >= 2) and channel 8 j + 2 q + e % 2,
// in the reference's order (bias, pre-ReLU skip, ReLU, residual), into the
// layer's float32 rows and shadow `sh_out`, with the biases of the chunk
// in buffer `buf`.  Every accumulator is read and every store made: a value
// that must not land (a channel past cout, or any value of a lane whose
// `lands` is false) goes to a dump address (the float past the float32
// rows; the first slack row of the shadow), and the shadow gets zeros for
// channels past cout.
template <int J>
__device__ __forceinline__ void epilogue(uint8_t* sm, const int* r, const WgPlan& p, int buf, const float* c,
                                         int m0, int dm, int q, int sh_out, bool shadow_out, bool lands) {
  const int cout = r[kWgCout], out = r[kWgOut], skip = r[kWgSkip], add = r[kWgAdd];
  const bool relu = r[kWgRelu] != 0;
  const float* bias = reinterpret_cast<const float*>(sm + buf + r[kWgBias]);
  float* f32 = reinterpret_cast<float*>(sm + p.lay[kLF32]);
  const int dump = p.lay[kLDump];
  uint8_t* sh = sm + sh_out;
  const int dump_row = kWgLead + p.lay[kLGroups] * kWgRows;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c0 = 8 * j + 2 * q, c1 = c0 + 1;
    const float bias0 = bias[c0], bias1 = bias[c1];
    const int r0 = min(c0, cout - 1) * kWgF32Row, r1 = min(c1, cout - 1) * kWgF32Row;
    const bool ok0 = lands && c0 < cout, ok1 = lands && c1 < cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + dm * h;
      float y0 = c[4 * j + 2 * h] + bias0, y1 = c[4 * j + 2 * h + 1] + bias1;
      if (skip >= 0) {
        y0 += f32[skip + r0 + m];
        y1 += f32[skip + r1 + m];
      }
      if (relu) {
        y0 = fmaxf(y0, 0.f);
        y1 = fmaxf(y1, 0.f);
      }
      if (add >= 0) {
        y0 += f32[add + r0 + m];
        y1 += f32[add + r1 + m];
      }
      if (out >= 0) {
        f32[ok0 ? out + c0 * kWgF32Row + m : dump] = y0;
        f32[ok1 ? out + c1 * kWgF32Row + m : dump] = y1;
      }
      if (shadow_out) {
        const int row = lands ? kWgLead + j * kWgRows + m : dump_row;
        *reinterpret_cast<uint32_t*>(sh + row * 16 + 4 * q) = pack_bf16(ok0 ? y0 : 0.f, ok1 ? y1 : 0.f);
      }
    }
  }
}

// One layer of one frame for this warpgroup's m64 tile: the products from
// shadow `sh_in` and the chunk in buffer `buf` (byte offsets from the
// block's base), then the epilogue into the float32 rows and shadow
// `sh_out`.
template <int N>
__device__ __forceinline__ void wg_layer(uint8_t* sm, uint32_t base, const int* r, const WgPlan& p, int buf,
                                         int sh_in, int sh_out, bool shadow_out, int tile, int wl,
                                         int lane) {
  const uint32_t* table = reinterpret_cast<const uint32_t*>(sm + buf + r[kWgTable]);
  // A: this tile's start (64 rows a tile), stride-byte offset 128; the
  // table adds each instruction's start row and leading-byte offset.  B:
  // leading-byte offset 16 N, stride-byte offset 128, 32 N bytes an
  // instruction.
  const uint64_t a0 = static_cast<uint64_t>(((base + sh_in) >> 4) + 64 * tile) | (8ull << 32);
  const uint64_t b0 =
      static_cast<uint64_t>((base + buf) >> 4) | (static_cast<uint64_t>(N) << 16) | (8ull << 32);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
  const int instr = r[kWgInstr];
  for (int i = 0; i < instr; ++i) {
    const uint32_t e = table[i];
    const uint64_t a = a0 + (e & 0xffffu) + (static_cast<uint64_t>(e >> 16) << 16);
    wgmma_k<N>(acc, a, b0 + static_cast<uint64_t>(2 * N * i));
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);

  // The epilogue in the reference's order (bias, pre-ReLU skip, ReLU,
  // residual) on every accumulator; see the header for the write rule.
  const int g = lane >> 2, q = lane & 3;
  epilogue<N / 8>(sm, r, p, buf, acc, 64 * tile + 16 * wl + g, 8, q, sh_out, shadow_out, true);
}

// ldmatrix.x4: lane L gives the address of row L % 8 of matrix L / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

// ldmatrix.x2: lanes 0-15 give the addresses (row L % 8 of matrix L / 8).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&d)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(d[0]), "=r"(d[1])
               : "r"(addr));
}

// Instruction i's products for bin rows 128..143 into acc: A by
// ldmatrix.x4 from the shadow rows the wgmma tiles read (matrices: block 1
// rows 128..135 and 136..143, block 2 the same, at the instruction's start
// row and leading-byte offset); B by ldmatrix.x2 from the chunk's tiles
// (matrix h of column group j is 8 columns by 16 bytes of k, which is
// mma's B fragment as it lands); mma.sync.m16n8k16 per column group.
template <int N>
__device__ __forceinline__ void edge_mma(float (&acc)[N / 8][4], uint32_t a_lane, uint32_t b_lane, uint32_t e,
                                         int i, int lane) {
  uint32_t a[4];
  ldmatrix_x4(a, a_lane + 16 * ((e & 0xffffu) + (lane >> 4) * (e >> 16)));
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    uint32_t b[2];
    ldmatrix_x2(b, b_lane + 32 * N * i + 128 * j);
    mma_bf16(acc[j], a, b[0], b[1]);
  }
}

// Bin 128 of one layer for the edge warp: an m16 tile of bins 128..143
// (row 0 the one real bin) by mma.sync, two instructions at a time into
// two accumulators.  mma.sync takes the tensor cores from the wgmma tiles
// only for those rows; the FMA units took issue slots from the tiles'
// epilogues instead and ran slower, and a second edge warp gained
// nothing (bring-up on an H100).
template <int N>
__device__ __forceinline__ void edge_layer(uint8_t* sm, uint32_t base, const int* r, const WgPlan& p, int buf,
                                           int sh_in, int sh_out, bool shadow_out, int lane) {
  const uint32_t* table = reinterpret_cast<const uint32_t*>(sm + buf + r[kWgTable]);
  const uint32_t a_lane = base + sh_in + 16 * (kBins - 1 + (lane & 7) + ((lane >> 3) & 1) * 8);
  const uint32_t b_lane = base + buf + 16 * N * ((lane >> 3) & 1) + 16 * (lane & 7);
  float acc[N / 8][4], acc2[N / 8][4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = acc2[j][e] = 0.f;
  const int instr = r[kWgInstr];
  int i = 0;
  for (; i + 1 < instr; i += 2) {
    const uint32_t e0 = table[i], e1 = table[i + 1];
    edge_mma<N>(acc, a_lane, b_lane, e0, i, lane);
    edge_mma<N>(acc2, a_lane, b_lane, e1, i + 1, lane);
  }
  if (i < instr) edge_mma<N>(acc, a_lane, b_lane, table[i], i, lane);
  // row 0 of the tile (lanes 0..3) is bin 128
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    acc[j][0] += acc2[j][0];
    acc[j][1] += acc2[j][1];
  }
  // the other lanes' writes go to dump addresses
  float c[N / 2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    c[4 * j] = c[4 * j + 2] = acc[j][0];
    c[4 * j + 1] = c[4 * j + 3] = acc[j][1];
  }
  epilogue<N / 8>(sm, r, p, buf, c, kBins - 1, 0, q, sh_out, shadow_out, g == 0);
}

// The input rows of frame `frame` (c_in rows of 129 floats in x [B,
// c_in, T, 129]) into L2, one 128-byte line a thread, ahead of the frame.
__device__ __forceinline__ void prefetch_input(const float* __restrict__ x, int frame, int frames, int c_in,
                                               int tid) {
  const int b = frame / frames, t = frame - b * frames;
  const size_t plane = static_cast<size_t>(frames) * kBins;
  const float* xs = x + static_cast<size_t>(b) * c_in * plane + static_cast<size_t>(t) * kBins;
  const int c = tid / 5, k = tid - 5 * c;  // a row of 516 bytes meets at most 5 lines
  if (c < c_in) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(xs + c * plane + min(32 * k, kBins - 1)));
}

// Persistent blocks, each a frame at a time (frames blockIdx.x, blockIdx.x
// + gridDim.x, ...): warps 0-7 are two warpgroups, warpgroup t the bins
// 64 t .. 64 t + 63; warp 8 is the edge warp, bin 128.  Chunks are staged
// one global layer ahead across frames, and the next frame's input is
// fetched into L2 while the last layer runs.
__global__ void __launch_bounds__(kWgThreads, 2)
    rced_stack_wgmma_kernel(const float* __restrict__ x, float* __restrict__ y,
                            const uint8_t* __restrict__ weights, const __grid_constant__ WgPlan p,
                            int n_layers, int frames, int total, int c_in, int c_out) {
  extern __shared__ __align__(16) uint8_t wg_smem[];  // rced_stack_kernel's is float `sm`
  __shared__ int s_rec[kMaxLayers * kWgRec];          // the layer records, read every layer
  uint8_t* sm = wg_smem;
  const uint32_t base = smem_addr(sm);
  const int tid = threadIdx.x;
  // the warp index through a shuffle, which the compiler knows is uniform
  // across the warp
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int tile = warp >> 2, wl = warp & 3;
  const int sh0 = kWgBarrierBytes, sh1 = kWgBarrierBytes + p.lay[kLShadowBytes];
  const size_t plane = static_cast<size_t>(frames) * kBins;
  float* f32 = reinterpret_cast<float*>(sm + p.lay[kLF32]);
  const int in_f32 = p.lay[kLInF32], out_f32 = p.lay[kLOutF32];
  uint16_t* shadow0 = reinterpret_cast<uint16_t*>(sm + sh0);
  int frame = blockIdx.x;

  for (int i = tid; i < kMaxLayers * kWgRec; i += kWgThreads) s_rec[i] = p.rec[i / kWgRec][i % kWgRec];
  if (tid == 0) {
    mbar_init(base, 1);  // buffer 0's: thread 0's arrive, plus the bytes
    mbar_init(base + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Both shadows zeroed once: the lead, each group's 6 halo rows and the
  // slack are never written after (the input and the epilogues write bins
  // 0..128 only).
  for (int i = tid; i < 2 * p.lay[kLShadowBytes] / 16; i += kWgThreads)
    *reinterpret_cast<uint4*>(sm + sh0 + 16 * i) = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (tid == 0) {
    stage_chunk(s_rec, p, weights, base, 0);
    if (n_layers > 1 || frame + static_cast<int>(gridDim.x) < total)
      stage_chunk(s_rec + (1 % n_layers) * kWgRec, p, weights, base, 1);
  }

  for (int gl = 0;;) {
    // The input: shadow 0 (zeros in the padded channels of its last
    // group), and float32 rows where a later epilogue reads it.
    const int b = frame / frames, t = frame - b * frames;
    const float* xs = x + static_cast<size_t>(b) * c_in * plane + static_cast<size_t>(t) * kBins;
    for (int i = tid; i < (c_in + 7) / 8 * 8 * kBins; i += kWgThreads) {
      const int c = i / kBins;
      const int f = i - c * kBins;
      const float v = c < c_in ? __ldg(xs + c * plane + f) : 0.f;
      if (c < c_in && in_f32 >= 0) f32[in_f32 + c * kWgF32Row + f] = v;
      shadow0[(kWgLead + (c >> 3) * kWgRows + f) * 8 + (c & 7)] = bf16_bits(v);
    }
    fence_proxy_async();
    __syncthreads();

    const int next = frame + gridDim.x;
    for (int l = 0; l < n_layers; ++l, ++gl) {
      const int* r = s_rec + l * kWgRec;
      // global layer gl + 1: this frame's layer l + 1, or the next frame's
      // layer 0 (gl + 1 = 1 was staged before the loop)
      // staged by the edge warp, which no wgmma waits for
      if (tid == 32 * kWgEdgeWarp && gl >= 1) {
        if (l + 1 < n_layers)
          stage_chunk(r + kWgRec, p, weights, base, gl + 1);
        else if (next < total)
          stage_chunk(s_rec, p, weights, base, gl + 1);
      }
      if (l + 1 == n_layers && next < total) prefetch_input(x, next, frames, c_in, tid);
      mbar_wait(base + 8 * (gl & 1), (gl >> 1) & 1);
      const int buf = (gl & 1) ? p.lay[kLBuf1] : p.lay[kLBuf0];
      const int sh_in = (l & 1) ? sh1 : sh0, sh_out = (l & 1) ? sh0 : sh1;
      const bool shadow_out = l + 1 < n_layers;
      switch (r[kWgN]) {
#define WG_CASE(N)                                                                         \
  case N:                                                                                  \
    if (warp == kWgEdgeWarp)                                                               \
      edge_layer<N>(sm, base, r, p, buf, sh_in, sh_out, shadow_out, lane);                 \
    else                                                                                   \
      wg_layer<N>(sm, base, r, p, buf, sh_in, sh_out, shadow_out, tile, wl, lane);         \
    break;
        WG_CASE(8) WG_CASE(16) WG_CASE(24) WG_CASE(32)
#undef WG_CASE
        default: break;  // rejected on the host
      }
      fence_proxy_async();  // this thread's shadow writes, before the next layer's wgmma
      __syncthreads();
    }

    float* ys = y + static_cast<size_t>(b) * c_out * plane + static_cast<size_t>(t) * kBins;
    for (int i = tid; i < c_out * kBins; i += kWgThreads) {
      const int c = i / kBins;
      const int f = i - c * kBins;
      ys[c * plane + f] = f32[out_f32 + c * kWgF32Row + f];
    }
    frame = next;
    if (frame >= total) break;
    __syncthreads();  // the output is out before the next input's float32 rows land
  }
}

int wgmma_occupancy(int smem_bytes, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(rced_stack_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, rced_stack_wgmma_kernel, kWgThreads, static_cast<size_t>(smem_bytes)));
}

}  // namespace

// Blocks of rced_stack_kernel one SM holds at `smem_bytes` of dynamic
// shared memory each, into *blocks.  Returns the CUDA error code (0 on
// success).
extern "C" int rced_stack_blocks_per_sm(int smem_bytes, int* blocks) {
  cudaError_t err = set_smem(smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, rced_stack_kernel, kThreads, static_cast<size_t>(smem_bytes)));
}

// Launches the stack on `stream` for `batch` x `frames` frames, one block
// per frame, in 3xTF32.  `plan_rows` is a host array of n_layers x 10
// ints (see Field).  `weights` holds each layer's B fragments (see
// conv_layer) and then its n_tiles * 8 float32 biases; `koffs` each
// layer's chunks * 8 A offsets.  Returns the CUDA error code of the launch
// (0 on success); never synchronises.
extern "C" int rced_stack_forward(const float* x, float* y, const float* weights,
                                  const int* koffs, const int* plan_rows, int n_layers, int batch,
                                  int frames, int c_in, int c_out, int in_off, int out_off,
                                  int smem_floats, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || batch < 1 || frames < 1 || smem_floats < 4 ||
      smem_floats % 4 != 0 || reinterpret_cast<uintptr_t>(weights) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  memset(&plan, 0, sizeof(plan));
  memcpy(plan.rec, plan_rows, sizeof(int) * kRec * n_layers);
  for (int l = 0; l < n_layers; ++l) {
    const int* r = plan.rec[l];
    if (r[kChunks] < 1 || r[kNTiles] < 1 || r[kNTiles] > kMaxNTiles || r[kCout] < 1 ||
        r[kCout] > 8 * r[kNTiles] || r[kWOff] % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(sizeof(float)) * smem_floats;
  cudaError_t err = set_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * frames;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rced_stack_kernel<<<static_cast<int>(total), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, weights, koffs, plan, n_layers, frames, c_in, c_out, in_off, out_off, smem_floats);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rced_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocks of rced_stack_wgmma_kernel one SM holds at `smem_bytes` of
// dynamic shared memory each, into *blocks.  Returns the CUDA error code.
extern "C" int rced_stack_wgmma_blocks_per_sm(int smem_bytes, int* blocks) {
  return wgmma_occupancy(smem_bytes, blocks);
}

// Launches the bf16 stack on wgmma on `stream` for `batch` x `frames`
// frames in `grid` persistent blocks (at most one a frame; the host fills
// the card: blocks an SM times SMs).  `plan_rows` is a host array of
// n_layers x 12 ints (WgField), `layout` one of kLFields ints (WgLayout);
// `weights` holds each layer's chunk (B tiles, biases, A table) at a
// 16-byte offset.  Returns the CUDA error code of the launch (0 on
// success); never synchronises.
extern "C" int rced_stack_forward_wgmma(const float* x, float* y, const void* weights, const int* plan_rows,
                                        const int* layout, int n_layers, int batch, int frames, int c_in,
                                        int c_out, int grid, void* stream) {
  const long long total = static_cast<long long>(batch) * frames;
  if (n_layers < 1 || n_layers > kMaxLayers || batch < 1 || frames < 1 || c_in < 1 || c_in > 32 ||
      c_out < 1 || grid < 1 || grid > total || total > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(weights) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  WgPlan plan;
  memset(&plan, 0, sizeof(plan));
  memcpy(plan.rec, plan_rows, sizeof(int) * kWgRec * n_layers);
  memcpy(plan.lay, layout, sizeof(int) * kLFields);
  const int* lay = plan.lay;
  if (lay[kLGroups] < 1 || lay[kLGroups] > 4 || 8 * lay[kLGroups] < c_in || lay[kLSmem] > 232448 ||
      lay[kLShadowBytes] != (kWgLead + lay[kLGroups] * kWgRows + kWgSlack) * 16 || lay[kLOutF32] < 0 ||
      lay[kLF32] % 16 != 0 || lay[kLBuf0] % 16 != 0 || lay[kLBuf1] % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // a layer's chunk lands in buffer (global layer) % 2: its own parity
  // when n_layers is even, either buffer when it is odd
  const int buf0 = lay[kLBuf1] - lay[kLBuf0], buf1 = lay[kLSmem] - lay[kLBuf1];
  for (int l = 0; l < n_layers; ++l) {
    const int* r = plan.rec[l];
    const int n = r[kWgN];
    const int room = n_layers % 2 ? (buf0 < buf1 ? buf0 : buf1) : (l & 1 ? buf1 : buf0);
    if (r[kWgInstr] < 1 || (n != 8 && n != 16 && n != 24 && n != 32) || r[kWgCout] < 1 ||
        r[kWgCout] > n || r[kWgCin] > 8 * lay[kLGroups] || r[kWgChunk] % 16 != 0 ||
        r[kWgChunkBytes] % 16 != 0 || r[kWgBias] != 32 * n * r[kWgInstr] || r[kWgTable] != r[kWgBias] + 4 * n ||
        r[kWgChunkBytes] < r[kWgTable] + 4 * r[kWgInstr] || r[kWgChunkBytes] > room)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(rced_stack_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, lay[kLSmem]);
  if (err != cudaSuccess) return static_cast<int>(err);
  rced_stack_wgmma_kernel<<<grid, kWgThreads, lay[kLSmem], static_cast<cudaStream_t>(stream)>>>(
      x, y, static_cast<const uint8_t*>(weights), plan, n_layers, frames, static_cast<int>(total), c_in, c_out);
  return static_cast<int>(cudaGetLastError());
}
