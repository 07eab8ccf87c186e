// The chain after each batch-normalised conv of the blocked training step
// (models/blocked.py, `apply_blocked`), forward and backward: the conv's
// bias, training-mode batch norm over masked moments, the skip add before
// the ReLU (V1/V2), the ReLU, the residual add after it (V3) and the
// re-zeroed pad band, in the blocked layout [rows = B*T][positions =
// NB*fb][C] with the real frequency bins first.
//
// It replaces no TPU kernel: the JAX package leaves this chain to XLA,
// which fuses it into the convs' neighbours.  The port ran it as PyTorch's
// elementwise and reduce kernels, one full-tensor pass for each operation
// (the bias add, the float32 copy, two masked products and their sums, the
// scale, the shift, the skip add, the ReLU, the residual and the pad-band
// multiply), and autograd replayed their gradients pass by pass: at R-CED16
// (`FullyCNNV2`, 15 BN layers, 253 channels) and batch 64 x 384 frames in
// bf16 that was about 30 passes over the 1.69 GB of the layers' activations
// in the forward and twice as many in the backward, most of a training
// step's device time on an H100.
//
//   moments:    S1[c] = sum m (y + b[c]), S2[c] = sum m (y + b[c])^2 over
//               real bins, m the row's frame-mask weight (rows weighted 0
//               are not read);
//   apply:      out = pad-band zero of act((y + b) * scale + shift + skip)
//               + add, in float32, rounded once to the compute dtype, with
//               rstd = rsqrt(var + 1e-3), scale = gamma * rstd, shift =
//               beta - mean * scale (models/blocks.py `bn_scale_shift`);
//   grad_sums:  G1[c] = sum gh, G2[c] = sum gh * xhat over every row's real
//               bins, gh = g where the ReLU passed (u > 0) and xhat = (x -
//               mean) * rstd, x = y + b;
//   grad_apply: dy = scale * gh - m * (k1 + k2 * (x - mean)) with k1 =
//               scale * G1 / n, k2 = scale * rstd * G2 / n (the closed-form
//               batch-norm backward through masked moments, with G1, G2
//               and n over every data-parallel rank), dskip = gh, zero in
//               the pad band; block 0 also writes the bias's gradient
//               from the same sums.
//
// What bounds it on an H100: bytes.  Each element costs a handful of
// float32 operations against 2 bytes read or written, so 3.35 TB/s sets the
// time: V2's 15 layers at 64 x 384 frames hold 64 * 384 * 136 * 253
// values, 1.69 GB in bf16 a pass, 0.50 ms.  The least the chain needs is the
// conv output read once, the skip or residual source read once and the
// output written once in the forward; the output gradient and the conv
// output read once and the conv output's gradient written once in the
// backward (portbench's `bn_chain_roofline` counts these over real bins and
// each step's batch-max frames).  These kernels read y twice in the forward
// (moments, then apply) and g, y and the skip source twice in the backward
// (sums, then apply), since the sums must be complete before anything is
// written.
//
// What the design does about it.
// - One pass per reduction and one per elementwise stage, each value
//   loaded as part of a 16-byte vector (8 bf16 or 4 float32) by
//   neighbouring threads, and converted to float32 in registers.
// - The reductions give every thread a fixed set of channels: a row holds
//   positions * C values, a multiple of C, and a block's active threads
//   are a multiple of C / gcd(C, V), so the channel of a thread's j-th
//   value, (tid * V + j) % C, is the same in every vector it loads.  Its
//   sums, bias and BN constants stay in registers; no atomics.  A block's
//   sums meet in shared memory, one warp a (statistic, channel) adding its
//   lanes' terms and a shuffle tree; a second kernel adds the blocks'
//   partial sums in block order.  Every sum runs in a fixed order, so a
//   repeat gives the same bits, and the plan (`reduce_plan` in
//   ops/bn_chain.py) depends on the shape alone.
// - The backward recomputes x, the BN output and the ReLU's decision from
//   y, the skip source and the same per-channel constants, computed by
//   one device function with explicit roundings, so the forward and the
//   backward agree bit for bit on where the ReLU passed; the backward
//   keeps y and the skip source, which the step holds anyway, and no
//   float32 copy of an activation.
// - The elementwise kernels take one vector a thread and keep the
//   per-channel constants of the block in shared memory.
// - Two instances of each kernel (float32, bf16); flags (skip, residual,
//   ReLU, frame mask) are arguments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSumThreads = 1024;
constexpr int kMaxChannels = 64;
constexpr float kEpsilon = 1e-3f;  // models/blocks.py BN_EPSILON

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}

// The blocked layout: `rows` rows of `row_vecs` vectors (positions * C
// values); the first `real` values of a row are the real bins.  The frame
// mask, where given, is [mask_rows][frames] floats: mask_rows 1 is the
// batch-max mask, shared by every row of a frame.
struct Shape {
  int rows;
  int frames;
  int mask_rows;
  int channels;
  int row_vecs;
  int real;
};

__device__ __forceinline__ float frame_weight(const float* fm, const Shape& s, int row) {
  if (fm == nullptr) return 1.f;
  return fm[s.mask_rows == 1 ? row % s.frames : row];
}

// The batch norm's per-channel constants, rounded the same way wherever
// they are computed.
struct Norm {
  float rstd, scale, shift;
};

__device__ __forceinline__ Norm norm_of(float gamma, float beta, float mean, float var) {
  Norm n;
  n.rstd = rsqrtf(__fadd_rn(var, kEpsilon));
  n.scale = __fmul_rn(gamma, n.rstd);
  n.shift = __fmaf_rn(-mean, n.scale, beta);
  return n;
}

// u before the ReLU: (y + b) * scale + shift (+ skip); x = y + b.
__device__ __forceinline__ float pre_act(float x, float scale, float shift, float skip) {
  return __fadd_rn(__fmaf_rn(x, scale, shift), skip);
}

__host__ __device__ inline int gcd_of(int a, int b) {
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// Threads of a reduction block that load vectors: a multiple of
// C / gcd(C, V), so each keeps the same channels in every vector.
__host__ __device__ inline int active_threads(int channels, int vec) {
  const int q = channels / gcd_of(channels, vec);
  return kThreads / q * q;
}

// A block's sums meet: thread tid's s[stat][j] belongs to channel (tid * V
// + j) % C.  One warp a (statistic, channel) adds its lanes' terms, then a
// shuffle tree; partial[block][stat][c].
template <int V>
__device__ void block_sums(const float (&s1)[V], const float (&s2)[V], int channels, int active,
                           float* __restrict__ partial) {
  __shared__ float red[2][kThreads * V];
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[0][tid * V + j] = s1[j];
    red[1][tid * V + j] = s2[j];
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  const int terms = active * V / channels;
  for (int o = warp; o < 2 * channels; o += kThreads / 32) {
    const int stat = o / channels, c = o - stat * channels;
    float acc = 0.f;
    for (int k = lane; k < terms; k += 32) acc += red[stat][c + k * channels];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) partial[static_cast<size_t>(blockIdx.x) * 2 * channels + o] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bn_chain_moments_kernel(const T* __restrict__ y,
                                                                    const float* __restrict__ bias,
                                                                    const float* __restrict__ fm,
                                                                    float* __restrict__ partial, Shape s,
                                                                    int rows_per_block) {
  constexpr int V = Vec<T>::n;
  const int C = s.channels;
  const int active = active_threads(C, V);
  const int tid = threadIdx.x;
  float s1[V], s2[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s1[j] = 0.f;
    s2[j] = 0.f;
    b[j] = bias[(tid * V + j) % C];
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int nvec = (min(s.rows, r0 + rows_per_block) - r0) * s.row_vecs;
  const T* base = y + static_cast<size_t>(r0) * s.row_vecs * V;
  if (tid < active) {
    for (int i = tid; i < nvec; i += active) {
      const int rr = i / s.row_vecs;
      const int col = (i - rr * s.row_vecs) * V;
      if (col >= s.real) continue;
      const float m = frame_weight(fm, s, r0 + rr);
      if (m == 0.f) continue;
      float v[V];
      load_vec(base + static_cast<size_t>(i) * V, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (col + j < s.real) {
          const float x = __fadd_rn(v[j], b[j]);
          const float xm = x * m;
          s1[j] += xm;
          s2[j] += xm * x;
        }
      }
    }
  }
  block_sums<V>(s1, s2, C, active, partial);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bn_chain_grad_sums_kernel(
    const T* __restrict__ g, const T* __restrict__ y, const T* __restrict__ skip, const float* __restrict__ bias,
    const float* __restrict__ gamma, const float* __restrict__ beta, const float* __restrict__ mean,
    const float* __restrict__ var, float* __restrict__ partial, Shape s, int rows_per_block, int relu) {
  constexpr int V = Vec<T>::n;
  const int C = s.channels;
  const int active = active_threads(C, V);
  const int tid = threadIdx.x;
  float s1[V], s2[V], b[V], sc[V], sh[V], mu[V], rs[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = (tid * V + j) % C;
    const Norm n = norm_of(gamma[c], beta[c], mean[c], var[c]);
    s1[j] = 0.f;
    s2[j] = 0.f;
    b[j] = bias[c];
    sc[j] = n.scale;
    sh[j] = n.shift;
    mu[j] = mean[c];
    rs[j] = n.rstd;
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int nvec = (min(s.rows, r0 + rows_per_block) - r0) * s.row_vecs;
  const size_t base = static_cast<size_t>(r0) * s.row_vecs * V;
  const bool with_skip = relu && skip != nullptr;
  if (tid < active) {
    for (int i = tid; i < nvec; i += active) {
      const int rr = i / s.row_vecs;
      const int col = (i - rr * s.row_vecs) * V;
      if (col >= s.real) continue;
      const size_t at = base + static_cast<size_t>(i) * V;
      float gv[V], yv[V], kv[V];
      load_vec(g + at, gv);
      load_vec(y + at, yv);
      if (with_skip) {
        load_vec(skip + at, kv);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) kv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (col + j < s.real) {
          const float x = __fadd_rn(yv[j], b[j]);
          const float gh = (!relu || pre_act(x, sc[j], sh[j], kv[j]) > 0.f) ? gv[j] : 0.f;
          s1[j] += gh;
          s2[j] += gh * ((x - mu[j]) * rs[j]);
        }
      }
    }
  }
  block_sums<V>(s1, s2, C, active, partial);
}

// sums[o] = sum over blocks of partial[block][o], in block order.
__global__ void __launch_bounds__(kSumThreads) bn_chain_sum_partials_kernel(const float* __restrict__ partial,
                                                                           float* __restrict__ sums,
                                                                           int blocks, int outputs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int o = warp; o < outputs; o += kSumThreads / 32) {
    float acc = 0.f;
    for (int k = lane; k < blocks; k += 32) acc += partial[static_cast<size_t>(k) * outputs + o];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) sums[o] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bn_chain_apply_kernel(
    const T* __restrict__ y, const T* __restrict__ skip, const T* __restrict__ add, T* __restrict__ out,
    const float* __restrict__ bias, const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ mean, const float* __restrict__ var, Shape s, int relu) {
  constexpr int V = Vec<T>::n;
  __shared__ float cb[kMaxChannels], csc[kMaxChannels], csh[kMaxChannels];
  const int C = s.channels;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const Norm n = norm_of(gamma[c], beta[c], mean[c], var[c]);
    cb[c] = bias[c];
    csc[c] = n.scale;
    csh[c] = n.shift;
  }
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= s.rows * s.row_vecs) return;
  const int row = i / s.row_vecs;
  const int col = (i - row * s.row_vecs) * V;
  const size_t at = static_cast<size_t>(i) * V;
  float o[V];
  if (col >= s.real) {
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = 0.f;
  } else {
    float yv[V], kv[V], av[V];
    load_vec(y + at, yv);
    if (skip != nullptr) {
      load_vec(skip + at, kv);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) kv[j] = 0.f;
    }
    if (add != nullptr) load_vec(add + at, av);
    int c = col % C;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (col + j < s.real) {
        float u = pre_act(__fadd_rn(yv[j], cb[c]), csc[c], csh[c], kv[j]);
        if (relu && u < 0.f) u = 0.f;  // keeps a NaN, as torch.relu does
        o[j] = add != nullptr ? __fadd_rn(u, av[j]) : u;
      } else {
        o[j] = 0.f;
      }
      if (++c == C) c = 0;
    }
  }
  store_vec(out + at, o);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bn_chain_grad_apply_kernel(
    const T* __restrict__ g, const T* __restrict__ y, const T* __restrict__ skip, T* __restrict__ dy,
    T* __restrict__ dskip, const float* __restrict__ fm, const float* __restrict__ bias,
    const float* __restrict__ gamma, const float* __restrict__ beta, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ local, const float* __restrict__ total,
    const float* __restrict__ s1, const float* __restrict__ n_local, const float* __restrict__ n_all,
    float* __restrict__ dbias, Shape s, int relu) {
  constexpr int V = Vec<T>::n;
  __shared__ float cb[kMaxChannels], csc[kMaxChannels], csh[kMaxChannels], cmu[kMaxChannels],
      ck1[kMaxChannels], ck2[kMaxChannels];
  const int C = s.channels;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const Norm n = norm_of(gamma[c], beta[c], mean[c], var[c]);
    const float inv_n = 1.f / n_all[0];
    const float k1 = n.scale * total[c] * inv_n;
    const float k2 = n.scale * n.rstd * total[C + c] * inv_n;
    cb[c] = bias[c];
    csc[c] = n.scale;
    csh[c] = n.shift;
    cmu[c] = mean[c];
    ck1[c] = k1;
    ck2[c] = k2;
    if (blockIdx.x == 0) {
      // sum of dy over every position: m sums to n_local, m (x - mean) to
      // s1 - n_local * mean
      const float nl = n_local[0];
      dbias[c] = n.scale * local[c] - nl * k1 - k2 * (s1[c] - nl * mean[c]);
    }
  }
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= s.rows * s.row_vecs) return;
  const int row = i / s.row_vecs;
  const int col = (i - row * s.row_vecs) * V;
  const size_t at = static_cast<size_t>(i) * V;
  const bool with_skip = skip != nullptr;
  float dx[V], gh[V];
  if (col >= s.real) {
#pragma unroll
    for (int j = 0; j < V; ++j) dx[j] = gh[j] = 0.f;
  } else {
    const float m = frame_weight(fm, s, row);
    float gv[V], yv[V], kv[V];
    load_vec(g + at, gv);
    load_vec(y + at, yv);
    if (with_skip && relu) {
      load_vec(skip + at, kv);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) kv[j] = 0.f;
    }
    int c = col % C;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (col + j < s.real) {
        const float x = __fadd_rn(yv[j], cb[c]);
        gh[j] = (!relu || pre_act(x, csc[c], csh[c], kv[j]) > 0.f) ? gv[j] : 0.f;
        dx[j] = csc[c] * gh[j] - m * (ck1[c] + ck2[c] * (x - cmu[c]));
      } else {
        dx[j] = gh[j] = 0.f;
      }
      if (++c == C) c = 0;
    }
  }
  store_vec(dy + at, dx);
  if (with_skip) store_vec(dskip + at, gh);
}

bool valid(const Shape& s, int vec, const void* p) {
  return s.rows >= 1 && s.frames >= 1 && s.rows % s.frames == 0 && s.mask_rows >= 0 && s.channels >= 1 &&
         s.channels <= kMaxChannels && s.row_vecs >= 1 && s.real >= 1 && s.real <= s.row_vecs * vec &&
         static_cast<long long>(s.rows) * s.row_vecs * vec < 0x7fffffffLL &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

Shape shape_of(int rows, int frames, int mask_rows, int channels, int positions, int real_positions, int vec) {
  return Shape{rows, frames, mask_rows, channels, positions * channels / vec, real_positions * channels};
}

template <typename T>
cudaError_t launch_moments(const void* y, const float* bias, const float* fm, float* partial, float* sums,
                           const Shape& s, int rows_per_block, cudaStream_t stream) {
  const int blocks = (s.rows + rows_per_block - 1) / rows_per_block;
  bn_chain_moments_kernel<T><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(y), bias, fm, partial, s,
                                                              rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_chain_sum_partials_kernel<<<1, kSumThreads, 0, stream>>>(partial, sums, blocks, 2 * s.channels);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_grad_sums(const void* g, const void* y, const void* skip, const float* bias,
                             const float* gamma, const float* beta, const float* mean, const float* var,
                             float* partial, float* sums, const Shape& s, int rows_per_block, int relu,
                             cudaStream_t stream) {
  const int blocks = (s.rows + rows_per_block - 1) / rows_per_block;
  bn_chain_grad_sums_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(y), static_cast<const T*>(skip), bias, gamma, beta, mean,
      var, partial, s, rows_per_block, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_chain_sum_partials_kernel<<<1, kSumThreads, 0, stream>>>(partial, sums, blocks, 2 * s.channels);
  return cudaGetLastError();
}

int vec_of(int dtype) { return dtype == 0 ? Vec<float>::n : Vec<__nv_bfloat16>::n; }

unsigned elementwise_blocks(const Shape& s) {
  return static_cast<unsigned>((static_cast<long long>(s.rows) * s.row_vecs + kThreads - 1) / kThreads);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (the compute dtype of y and of every
// activation-sized tensor); the per-channel tensors are float32.  Every
// function launches on `stream`, returns the CUDA error code of its
// launches (0 on success, cudaErrorInvalidValue for a shape or pointer the
// kernels do not take) and never synchronises.  `fm` may be null (no frame
// mask); `rows_per_block` is `reduce_plan`'s, and `partial` holds
// ceil(rows / rows_per_block) * 2C floats.

// sums [2][C]: S1, S2 of y + bias over the real bins of the rows fm weights
// (moments kernel, then the partial sums' kernel).
extern "C" int bn_chain_moments(const void* y, const float* bias, const float* fm, float* partial, float* sums,
                                int dtype, int rows, int frames, int mask_rows, int channels, int positions,
                                int real_positions, int rows_per_block, void* stream) {
  const int vec = vec_of(dtype);
  const Shape s = shape_of(rows, frames, mask_rows, channels, positions, real_positions, vec);
  if ((dtype != 0 && dtype != 1) || positions * channels % vec != 0 || rows_per_block < 1 || !valid(s, vec, y))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? launch_moments<float>(y, bias, fm, partial, sums, s, rows_per_block, st)
                                     : launch_moments<__nv_bfloat16>(y, bias, fm, partial, sums, s,
                                                                     rows_per_block, st));
}

// out = the chain's output; skip (added before the ReLU) and add (after it)
// may be null.
extern "C" int bn_chain_apply(const void* y, const void* skip, const void* add, void* out, const float* bias,
                              const float* gamma, const float* beta, const float* mean, const float* var,
                              int dtype, int rows, int frames, int channels, int positions, int real_positions,
                              int relu, void* stream) {
  const int vec = vec_of(dtype);
  const Shape s = shape_of(rows, frames, 0, channels, positions, real_positions, vec);
  if ((dtype != 0 && dtype != 1) || positions * channels % vec != 0 || !valid(s, vec, y) || !aligned(out) ||
      !aligned(skip) || !aligned(add))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    bn_chain_apply_kernel<float><<<elementwise_blocks(s), kThreads, 0, st>>>(
        static_cast<const float*>(y), static_cast<const float*>(skip), static_cast<const float*>(add),
        static_cast<float*>(out), bias, gamma, beta, mean, var, s, relu);
  } else {
    bn_chain_apply_kernel<__nv_bfloat16><<<elementwise_blocks(s), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(skip),
        static_cast<const __nv_bfloat16*>(add), static_cast<__nv_bfloat16*>(out), bias, gamma, beta, mean, var,
        s, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

// sums [2][C]: G1, G2 of the output gradient g over every row's real bins
// (grad-sums kernel, then the partial sums' kernel).
extern "C" int bn_chain_grad_sums(const void* g, const void* y, const void* skip, const float* bias,
                                  const float* gamma, const float* beta, const float* mean, const float* var,
                                  float* partial, float* sums, int dtype, int rows, int frames, int channels,
                                  int positions, int real_positions, int relu, int rows_per_block, void* stream) {
  const int vec = vec_of(dtype);
  const Shape s = shape_of(rows, frames, 0, channels, positions, real_positions, vec);
  if ((dtype != 0 && dtype != 1) || positions * channels % vec != 0 || rows_per_block < 1 || !valid(s, vec, y) ||
      !aligned(g) || !aligned(skip))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? launch_grad_sums<float>(g, y, skip, bias, gamma, beta, mean, var, partial, sums, s,
                                           rows_per_block, relu, st)
                 : launch_grad_sums<__nv_bfloat16>(g, y, skip, bias, gamma, beta, mean, var, partial, sums, s,
                                                   rows_per_block, relu, st));
}

// dy (the conv output's gradient) and, where skip is given, dskip (the skip
// source's); dbias [C].  local: this rank's grad sums; total: every rank's;
// s1: this rank's forward S1; n_local, n_all: one float each on the device.
extern "C" int bn_chain_grad_apply(const void* g, const void* y, const void* skip, void* dy, void* dskip,
                                   const float* fm, const float* bias, const float* gamma, const float* beta,
                                   const float* mean, const float* var, const float* local, const float* total,
                                   const float* s1, const float* n_local, const float* n_all, float* dbias,
                                   int dtype, int rows, int frames, int mask_rows, int channels, int positions,
                                   int real_positions, int relu, void* stream) {
  const int vec = vec_of(dtype);
  const Shape s = shape_of(rows, frames, mask_rows, channels, positions, real_positions, vec);
  if ((dtype != 0 && dtype != 1) || positions * channels % vec != 0 || !valid(s, vec, y) || !aligned(g) ||
      !aligned(dy) || !aligned(skip) || !aligned(dskip) || (skip == nullptr) != (dskip == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    bn_chain_grad_apply_kernel<float><<<elementwise_blocks(s), kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(y), static_cast<const float*>(skip),
        static_cast<float*>(dy), static_cast<float*>(dskip), fm, bias, gamma, beta, mean, var, local, total, s1,
        n_local, n_all, dbias, s, relu);
  } else {
    bn_chain_grad_apply_kernel<__nv_bfloat16><<<elementwise_blocks(s), kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(y),
        static_cast<const __nv_bfloat16*>(skip), static_cast<__nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dskip), fm, bias, gamma, beta, mean, var, local, total, s1, n_local, n_all,
        dbias, s, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bn_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
