// Fused inner conv stack of the R-CED / CR-CED denoisers, inference mode.
//
// Replaces the TPU kernel `_stack_kernel` of
// fullycnnspeechenhancement_tpu/ops/pallas_rced.py (launched by
// `_fused_inference_forward` there).  It runs layers 2..n-1 of V1/V2/V3
// with batch norm folded into the weights.  Each of them is a (1, kw <= 13)
// frequency-only conv, then the bias, the pre-ReLU skip (V1/V2), the ReLU
// and the post-ReLU residual (V3).  Layer 1 (the only conv with a time
// extent) and the final (1, 129) projection run outside, as cuDNN convs.
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
// matmul operands in bf16, slabs, biases and sums in float32) is the same
// kernel with another layer body, conv_layer_bf16:
// - mma.sync.m16n8k16 with bf16 operands and float32 accumulators, one
//   product per tile and no split.  A bf16 x bf16 product is exact in
//   float32, so the result differs from the plain version only in the
//   order of its float32 sums.
// - The weights are rounded to bf16 on the host and stored in fragment
//   order, 8 bytes a lane of a (k16, n8) tile.
// - Activations stay float32 in shared memory, as the JAX kernel keeps its
//   slabs float32: the skip, the residual and the next layer's bias and
//   ReLU read unrounded values.  Each A value is rounded to bf16 (to
//   nearest even, as torch's cast) when its fragment is loaded.
// - Within a k16 chunk, mma's k = 2t, 2t + 1, 2t + 8 and 2t + 9 stand for
//   the chunk's k = t, t + 4, t + 8 and t + 12 (the packing on the host
//   follows), so each of a lane's four A loads reads four consecutive k,
//   and the bank argument of the float32 body holds unchanged.
// The bound of this mode at V2 64 x 8 s: the same 2.3781e11 FLOP at the
// data sheet's 989 TFLOP/s dense bf16 rate, 0.240 ms, against 0.1 ms of
// device memory.
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

// The bf16 operand mode of conv_layer: `wf` holds the layer's B fragments
// in bf16, [chunk][NT][lane] pairs of 32-bit words, word 0 = (k t, k t + 4)
// and word 1 = (k t + 8, k t + 12) of column g, low half first; `koff` the
// chunks * 16 A offsets.
template <int NT>
__device__ __forceinline__ void conv_layer_bf16(const float* in, float* out, const float* skip,
                                                const float* add, bool relu,
                                                const uint2* __restrict__ wf,
                                                const float* __restrict__ bias,
                                                const int* __restrict__ koff, int chunks,
                                                int cout, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float* a = in + warp * 16 + g;
#pragma unroll 2
  for (int c = 0; c < chunks; ++c) {
    // this lane's k are k0 + t + 4s, s = 0..3: mma's k 2t, 2t + 1, 2t + 8, 2t + 9
    const int o0 = __ldg(koff + 16 * c + t);
    const int o1 = __ldg(koff + 16 * c + t + 4);
    const int o2 = __ldg(koff + 16 * c + t + 8);
    const int o3 = __ldg(koff + 16 * c + t + 12);
    uint32_t af[4];
    af[0] = pack_bf16(a[o0], a[o1]);          // row g
    af[1] = pack_bf16(a[o0 + 8], a[o1 + 8]);  // row g + 8
    af[2] = pack_bf16(a[o2], a[o3]);
    af[3] = pack_bf16(a[o2 + 8], a[o3 + 8]);
    uint2 b[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) b[n] = __ldg(wf + (c * NT + n) * 32 + lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_bf16(acc[n], af, b[n].x, b[n].y);
  }
  store_layer<NT>(acc, out, skip, add, relu, bias, cout, warp, lane);
}

// BF16 selects the layer body: conv_layer (3xTF32) or conv_layer_bf16.
template <bool BF16>
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
    const int words = BF16 ? 64 : 128;  // 32-bit words of one tile's fragments
    const float* bias = weights + r[kWOff] + r[kChunks] * nt * words;
    const int* koff = koffs + r[kKOff];
    const bool relu = r[kRelu] != 0;
    if constexpr (BF16) {
      const uint2* wf = reinterpret_cast<const uint2*>(weights + r[kWOff]);
      switch (nt) {
#define RCED_CASE(N)                                                                          \
  case N:                                                                                     \
    conv_layer_bf16<N>(in, out, skip, add, relu, wf, bias, koff, r[kChunks], r[kCout], warp,  \
                       lane);                                                                 \
    break;
        RCED_CASE(1) RCED_CASE(2) RCED_CASE(3) RCED_CASE(4)
#undef RCED_CASE
        default: break;  // rejected on the host
      }
    } else {
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

template <bool BF16>
cudaError_t set_smem(int smem) {
  return cudaFuncSetAttribute(rced_stack_kernel<BF16>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <bool BF16>
int occupancy(int smem_bytes, int* blocks) {
  cudaError_t err = set_smem<BF16>(smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, rced_stack_kernel<BF16>, kThreads, static_cast<size_t>(smem_bytes)));
}

template <bool BF16>
int launch(const float* x, float* y, const float* weights, const int* koffs, const Plan& plan,
           int n_layers, int batch, int frames, int c_in, int c_out, int in_off, int out_off,
           int smem_floats, void* stream) {
  const int smem = static_cast<int>(sizeof(float)) * smem_floats;
  cudaError_t err = set_smem<BF16>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * frames;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rced_stack_kernel<BF16><<<static_cast<int>(total), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      x, y, weights, koffs, plan, n_layers, frames, c_in, c_out, in_off, out_off, smem_floats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks of the float32 (bf16 = 0) or bf16 (bf16 = 1) instance one SM
// holds at `smem_bytes` of dynamic shared memory each, into *blocks.
// Returns the CUDA error code (0 on success).
extern "C" int rced_stack_blocks_per_sm(int smem_bytes, int bf16, int* blocks) {
  return bf16 ? occupancy<true>(smem_bytes, blocks) : occupancy<false>(smem_bytes, blocks);
}

// Launches the stack on `stream` for `batch` x `frames` frames, one block
// per frame, in 3xTF32 (bf16 = 0) or with bf16 operands (bf16 = 1).
// `plan_rows` is a host array of n_layers x 10 ints (see Field).
// `weights` holds each layer's B fragments (float32 or bf16, see
// conv_layer and conv_layer_bf16) and then its n_tiles * 8 float32 biases;
// `koffs` each layer's chunks * 8 (float32) or chunks * 16 (bf16) A
// offsets.  Returns the CUDA error code of the launch (0 on success);
// never synchronises.
extern "C" int rced_stack_forward(const float* x, float* y, const float* weights,
                                  const int* koffs, const int* plan_rows, int n_layers, int batch,
                                  int frames, int c_in, int c_out, int in_off, int out_off,
                                  int smem_floats, int bf16, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || batch < 1 || frames < 1 || smem_floats < 4 ||
      smem_floats % 4 != 0 || reinterpret_cast<uintptr_t>(weights) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  memset(&plan, 0, sizeof(plan));
  memcpy(plan.rec, plan_rows, sizeof(int) * kRec * n_layers);
  for (int l = 0; l < n_layers; ++l) {
    const int* r = plan.rec[l];
    if (r[kChunks] < 1 || r[kNTiles] < 1 || r[kNTiles] > kMaxNTiles || r[kCout] < 1 ||
        r[kCout] > 8 * r[kNTiles] || r[kWOff] % (bf16 ? 2 : 4) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? launch<true>(x, y, weights, koffs, plan, n_layers, batch, frames, c_in, c_out,
                             in_off, out_off, smem_floats, stream)
              : launch<false>(x, y, weights, koffs, plan, n_layers, batch, frames, c_in, c_out,
                              in_off, out_off, smem_floats, stream);
}

extern "C" const char* rced_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
