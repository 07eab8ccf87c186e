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
// 286,720), tap d pairs NB - |d - dc| real z blocks with dy (64 of the 68
// block pairs), so the contraction needs 1.203e12 FLOP, 17.95 ms at the
// 67 TFLOP/s float32 rate without tensor cores, while reading z and dy
// once is 8.66e9 bytes, 2.59 ms at 3.35 TB/s.  This kernel also multiplies
// the 4 pairs that meet its zero halo.
//
// What the design does about it.  The TPU kernel walks a sequential grid
// of 128-row tiles and keeps one [KB, Ci, Co] accumulator resident in
// VMEM across it.  Hopper blocks run in parallel and carry nothing over,
// so here a block owns a 64 x 64 (ci, co) output tile for all KB taps and
// one contiguous share (split) of the rows.  It stages `kStageRows` rows
// of z and dy at a time in shared memory; the z rows carry zero halos of
// dc and KB-1-dc blocks, so the tap shift n + d - dc is a plain offset
// read (as rced_stack.cu's halos replaced the TPU lane roll).  Each of
// the 256 threads keeps 4 ci x 4 co x KB sums in registers: per (row,
// block) one float4 of dy and KB float4s of z from shared memory feed
// 16*KB fused multiply-adds, and dy is reused across the taps.  The
// splits fill the card's SMs; each writes its partial sums to a scratch
// buffer [splits, KB, Ci, Co] that the caller allocates, and a second
// kernel adds the splits in a fixed order.  No atomics, so a run repeats
// bit for bit.  Ragged ends (rows past a split, channels past Ci or Co)
// are staged as zeros.  Float32 operands and sums; tensor cores (wgmma),
// TMA and a bf16 mode are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // ci and co per block
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each per tap
constexpr int kMaxKb = 8;

template <int KB>
__global__ void __launch_bounds__(kThreads)
dw_partial_kernel(const float* __restrict__ z, const float* __restrict__ dy,
                  float* __restrict__ part, long long rows, int nb, int ci, int co, int dc,
                  long long rows_per_split, int stage_rows) {
  extern __shared__ __align__(16) float sm[];
  const int nbp = nb + KB - 1;  // z blocks with halos
  float* zs = sm;                                  // [stage_rows][nbp][kTile]
  float* ds = sm + stage_rows * nbp * kTile;       // [stage_rows][nb][kTile]
  const int ci0 = blockIdx.x * kTile;
  const int co0 = blockIdx.y * kTile;
  const long long r_begin = static_cast<long long>(blockIdx.z) * rows_per_split;
  long long r_end = r_begin + rows_per_split;
  if (r_end > rows) r_end = rows;
  const int tx = threadIdx.x & 15;  // co group
  const int ty = threadIdx.x >> 4;  // ci group

  // The halos (block positions p < dc and p >= dc + nb) stay zero; the
  // staging below writes only dc <= p < dc + nb.
  for (int i = threadIdx.x; i < stage_rows * nbp * kTile; i += kThreads) zs[i] = 0.f;

  float acc[KB][4][4];
#pragma unroll
  for (int d = 0; d < KB; ++d)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[d][a][b] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += stage_rows) {
    __syncthreads();  // the previous stage is consumed (and the halos zeroed)
    const int n_stage = stage_rows * nb * kTile;
    for (int i = threadIdx.x; i < n_stage; i += kThreads) {
      const int c = i & (kTile - 1);
      const int t = i >> 6;
      const int n = t % nb;
      const int rr = t / nb;
      const long long r = r0 + rr;
      const bool row_ok = r < r_end;
      float zv = 0.f, dv = 0.f;
      if (row_ok && ci0 + c < ci) zv = __ldg(z + (r * nb + n) * ci + ci0 + c);
      if (row_ok && co0 + c < co) dv = __ldg(dy + (r * nb + n) * co + co0 + c);
      zs[(rr * nbp + n + dc) * kTile + c] = zv;
      ds[(rr * nb + n) * kTile + c] = dv;
    }
    __syncthreads();
    for (int rr = 0; rr < stage_rows; ++rr) {
      const float* zr = zs + rr * nbp * kTile + ty * 4;
      const float* dr = ds + rr * nb * kTile + tx * 4;
      for (int n = 0; n < nb; ++n) {
        const float4 dv = *reinterpret_cast<const float4*>(dr + n * kTile);
        const float dvs[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int d = 0; d < KB; ++d) {
          // zpad[n + d - dc] sits at halo position n + d.
          const float4 zv = *reinterpret_cast<const float4*>(zr + (n + d) * kTile);
          const float zvs[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[d][a][b] = fmaf(zvs[a], dvs[b], acc[d][a][b]);
        }
      }
    }
  }

  float* out = part + static_cast<long long>(blockIdx.z) * KB * ci * co;
#pragma unroll
  for (int d = 0; d < KB; ++d)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ci0 + ty * 4 + a;
      if (i >= ci) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int o = co0 + tx * 4 + b;
        if (o < co) out[(static_cast<long long>(d) * ci + i) * co + o] = acc[d][a][b];
      }
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

template <int KB>
cudaError_t launch_partial(const float* z, const float* dy, float* part, long long rows, int nb,
                           int ci, int co, int dc, long long rows_per_split, int splits,
                           int stage_rows, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * static_cast<size_t>(stage_rows) * (2 * nb + KB - 1) * kTile;
  cudaError_t err = cudaFuncSetAttribute(
      dw_partial_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((ci + kTile - 1) / kTile, (co + kTile - 1) / kTile, splits);
  dw_partial_kernel<KB><<<grid, kThreads, smem, stream>>>(z, dy, part, rows, nb, ci, co, dc,
                                                          rows_per_split, stage_rows);
  return cudaGetLastError();
}

}  // namespace

// dW of one blocked frequency conv on `stream`.  z [rows, nb, ci] and dy
// [rows, nb, co] float32, contiguous; out [kb, ci, co] float32.  `part` is
// scratch of splits * kb * ci * co floats (unused when splits == 1, when
// the partial kernel writes `out` directly).  Row split s covers rows
// [s * rows_per_split, (s + 1) * rows_per_split).  Returns the CUDA error
// code of the launches (0 on success); never synchronises.
extern "C" int blocked_dw_forward(const float* z, const float* dy, float* out, float* part,
                                  long long rows, int nb, int ci, int co, int kb, int dc,
                                  long long rows_per_split, int splits, int stage_rows,
                                  void* stream) {
  if (rows < 1 || nb < 1 || ci < 1 || co < 1 || kb < 1 || kb > kMaxKb || dc < 0 || dc >= kb ||
      rows_per_split < 1 || splits < 1 || stage_rows < 1 ||
      (splits - 1) * rows_per_split >= rows || splits * rows_per_split < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits == 1 ? out : part;
  cudaError_t err;
  switch (kb) {
#define DW_CASE(K)                                                                          \
  case K:                                                                                   \
    err = launch_partial<K>(z, dy, dst, rows, nb, ci, co, dc, rows_per_split, splits,       \
                            stage_rows, s);                                                 \
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
