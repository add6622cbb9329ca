// T4 on Hopper: K1's cost, part by part.
//
// Replaces the TPU kernel tools/pipe_compute_probe.py::_kernel, which is
// the TPU decode kernel's body with parts cut by `mode`. This file is the
// CUDA K1's split kernel (decode_attention.cu, included below for its
// helpers, its tile constants and its combine kernel) compiled once per
// mode, with the same parts cut:
//
//   full     everything: bit for bit K1 (the wrapper asserts it on the card);
//   tap      the K and V rows are loaded and nothing is computed; row 0 of
//            each tile of K and of V is added up:
//              out[b, h, :] = sum over tiles of K[tile row 0] + V[tile row 0]
//   qk       the QK dot, the logits and each tile's max; V loaded, tapped:
//              out = sum over tiles of (max of the tile's logits + V[tile row 0])
//   softmax  no QK dot and no P.V: logits are the constants
//            -1 + K[tile row 0, column j of the flat row], j < tile, the
//            same for every head, so K is still read; the online-softmax
//            statistics run on them:
//              acc = acc * corr + p[tile row 0] + V[tile row 0]
//   pv       the same constant logits with the full P.V product.
//
// In every mode each block requests every byte of its K and V rows from
// device memory: where a mode does not use the values, they are folded
// into a word that the kernel would store through a pointer the launcher
// always passes as null, so the compiler cannot drop the loads (a load
// whose result is dead is dropped by ptxas even from `asm volatile`, and
// the mode then "streams" at several times the card's rate). So the difference of
// two modes' times is the cost of the part that one of them cuts, at the
// same byte traffic. Outputs other than `full` are not normalized by the
// softmax sum (the TPU tool's are not either); tap and qk splits report
// (m, l) = (0, 1), so the combine adds them up.
//
// The tile is K1's: 128 rows, whatever tile the TPU kernel had. The TPU
// tool's machinery cuts (its flattened one-program schedule, SMEM scalar
// loads, 4-D DMA descriptors) cut things this kernel does not have. The
// cuts of this kernel's own machinery are made by the launcher: the
// combine pass skipped (`combine` 0: the partials are the output), and no
// context split (nsplit 1).
#include "decode_attention.cu"

namespace {

enum ProbeMode { kFull = 0, kTap = 1, kQk = 2, kSoftmax = 3, kPv = 4 };

// Loads whose values a mode does not use are still folded, bit by bit,
// into `sink`, which the kernel stores only through a pointer that the
// launcher always passes as null: neither nvcc nor ptxas can drop them.
__device__ __forceinline__ void load_vec_sunk(const float* p, float* out, uint32_t& sink) {
  load_vec(p, out);
  sink ^= __float_as_uint(out[0]) ^ __float_as_uint(out[1]) ^ __float_as_uint(out[2]) ^
          __float_as_uint(out[3]);
}

__device__ __forceinline__ void load_vec_sunk(const __nv_bfloat16* p, float* out,
                                              uint32_t& sink) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  sink ^= v.x ^ v.y ^ v.z ^ v.w;
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);            // bf16 -> f32 is a shift
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// K1's decode_split_kernel with the parts that MODE names cut out. One
// block = one (b, h) pair and one split of the context; writes the f32
// accumulator, the running max and the running sum of its split.
template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kThreads)
probe_split_kernel(const T* __restrict__ q, const T* __restrict__ kv, float* __restrict__ o_part,
                   float* __restrict__ ml_part, int64_t B, int64_t H, int64_t L, int64_t S,
                   int64_t layer, int64_t cur_len, int64_t rows_per_split, float scale,
                   uint32_t* __restrict__ sink_out) {
  constexpr int VEC = Vec<T>::N;
  constexpr int TPR = D / VEC;          // threads per cache row
  constexpr int RPP = kThreads / TPR;   // rows per pass
  constexpr int PASSES = kTile / RPP;
  constexpr bool kDot = MODE == kFull || MODE == kQk;            // the QK dot runs
  constexpr bool kStats = MODE != kTap && MODE != kQk;           // online softmax runs
  constexpr bool kProduct = MODE == kFull || MODE == kPv;        // P.V runs

  __shared__ float s_p[kTile];
  __shared__ float s_red[kThreads / 32];
  __shared__ float s_acc[RPP * D];

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H;
  const int64_t h = bh % H;
  const int64_t nsplit = gridDim.y;
  const int64_t part = bh * nsplit + blockIdx.y;
  const int tid = threadIdx.x;
  const int g = tid % TPR;   // which VEC-wide slice of the head row
  const int r0 = tid / TPR;  // which row of a pass

  const int64_t hd = H * D;
  const int64_t start = static_cast<int64_t>(blockIdx.y) * rows_per_split;
  const int64_t stop = start + rows_per_split;
  const int64_t end = stop < cur_len ? stop : cur_len;
  // element offsets, 64-bit throughout
  const int64_t row_base = ((layer * B + b) * S) * hd;   // the flat row 0 of (layer, b)
  const int64_t k_base = row_base + h * D + g * VEC;
  const int64_t v_base = k_base + L * B * S * hd;

  float qf[VEC];
  load_vec(q + bh * D + g * VEC, qf);

  float m_run = -INFINITY;
  float l_run = 0.f;
  uint32_t sink = 0;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

  for (int64_t t0 = start; t0 < end; t0 += kTile) {
    const int rows = end - t0 < kTile ? static_cast<int>(end - t0) : kTile;

    // the K rows of this tile: TPR threads per row
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r = r0 + p * RPP;
      float dot = 0.f;
      if (r < rows) {
        float kf[VEC];
        if constexpr (kDot) {
          load_vec(kv + k_base + (t0 + r) * hd, kf);
#pragma unroll
          for (int j = 0; j < VEC; ++j) dot = fmaf(qf[j], kf[j], dot);
        } else {
          load_vec_sunk(kv + k_base + (t0 + r) * hd, kf, sink);
          if constexpr (MODE == kTap) {
            if (r == 0) {
#pragma unroll
              for (int j = 0; j < VEC; ++j) acc[j] += kf[j];
            }
          }
        }
      }
      if constexpr (kDot) {
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (g == 0) s_p[r] = r < rows ? dot * scale : -INFINITY;
      }
    }
    if constexpr (MODE == kSoftmax || MODE == kPv) {
      // constant logits that still read K: column `tid` of the tile's first flat row
      s_p[tid] = tid < rows ? -1.f + to_float(kv[row_base + t0 * hd + tid]) : -INFINITY;
    }
    __syncthreads();

    float corr = 1.f;
    if constexpr (MODE == kQk) {
      const float m_tile = block_max(s_p[tid], s_red);
      if (r0 == 0) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += m_tile;
      }
    }
    if constexpr (kStats) {
      // online softmax statistics in f32
      const float logit = s_p[tid];
      const float m_new = fmaxf(m_run, block_max(logit, s_red));
      const float pr = tid < rows ? expf(logit - m_new) : 0.f;
      corr = expf(m_run - m_new);  // 0 on the first tile
      l_run = l_run * corr + block_sum(pr, s_red);
      m_run = m_new;
      s_p[tid] = pr;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] *= corr;
    }

    // the V rows of this tile
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r = r0 + p * RPP;
      if (r < rows) {
        float vf[VEC];
        if constexpr (kProduct) {
          load_vec(kv + v_base + (t0 + r) * hd, vf);
          const float w = s_p[r];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = fmaf(w, vf[j], acc[j]);
        } else {
          load_vec_sunk(kv + v_base + (t0 + r) * hd, vf, sink);
          if (r == 0) {
            const float p0 = MODE == kSoftmax ? s_p[0] : 0.f;
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[j] += vf[j] + p0;
          }
        }
      }
    }
    __syncthreads();  // s_p is rewritten by the next tile
  }

  // sum the RPP row lanes of the accumulator
#pragma unroll
  for (int j = 0; j < VEC; ++j) s_acc[r0 * D + g * VEC + j] = acc[j];
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < RPP; ++r) s += s_acc[r * D + d];
    o_part[part * D + d] = s;
  }
  if (tid == 0) {
    ml_part[2 * part] = kStats ? m_run : 0.f;
    ml_part[2 * part + 1] = kStats ? l_run : 1.f;
  }
  if (sink_out != nullptr) sink_out[part * kThreads + tid] = sink;  // never taken: see above
}

// K1's combine without the division by the softmax sum, for the modes
// whose output is the accumulator itself.
template <typename T, int D>
__global__ void probe_combine_kernel(const float* __restrict__ o_part,
                                     const float* __restrict__ ml_part, T* __restrict__ out,
                                     int64_t nsplit) {
  const int64_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = ml_part + 2 * bh * nsplit;
  float m = -INFINITY;
  for (int64_t s = 0; s < nsplit; ++s) m = fmaxf(m, ml[2 * s]);
  float o = 0.f;
  for (int64_t s = 0; s < nsplit; ++s) {
    o = fmaf(o_part[(bh * nsplit + s) * D + d], expf(ml[2 * s] - m), o);
  }
  store(out + bh * D + d, o);
}

template <typename T, int MODE>
cudaError_t launch_probe(const void* q, const void* kv, void* out, float* o_part, float* ml_part,
                         int combine, int64_t B, int64_t H, int64_t L, int64_t S, int64_t layer,
                         int64_t cur_len, int64_t rows_per_split, int64_t nsplit,
                         cudaStream_t stream) {
  constexpr int D = 64;  // the 350M model's head; the probe is built for no other
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>(nsplit));
  probe_split_kernel<T, D, MODE><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), o_part, ml_part, B, H, L, S, layer,
      cur_len, rows_per_split, scale, nullptr);
  if (combine) {
    if (MODE == kFull) {
      decode_combine_kernel<T, D><<<static_cast<unsigned>(B * H), D, 0, stream>>>(
          o_part, ml_part, static_cast<T*>(out), nsplit);
    } else {
      probe_combine_kernel<T, D><<<static_cast<unsigned>(B * H), D, 0, stream>>>(
          o_part, ml_part, static_cast<T*>(out), nsplit);
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mode(int mode, const void* q, const void* kv, void* out, float* o_part,
                          float* ml_part, int combine, int64_t B, int64_t H, int64_t L,
                          int64_t S, int64_t layer, int64_t cur_len, int64_t rows_per_split,
                          int64_t nsplit, cudaStream_t stream) {
  switch (mode) {
#define MT_MODE(M)                                                                           \
  case M:                                                                                    \
    return launch_probe<T, M>(q, kv, out, o_part, ml_part, combine, B, H, L, S, layer,       \
                              cur_len, rows_per_split, nsplit, stream);
    MT_MODE(kFull)
    MT_MODE(kTap)
    MT_MODE(kQk)
    MT_MODE(kSoftmax)
    MT_MODE(kPv)
#undef MT_MODE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// mode: 0 full, 1 tap, 2 qk, 3 softmax, 4 pv. combine 0 leaves the
// partials (o_part (B*H*nsplit, D), ml_part (B*H*nsplit, 2), both f32) as
// the result. chunk must be K1's tile (128), D 64 and H*D at least a
// tile. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int mt_k1_probe(const void* q, const void* kv, void* out, void* o_part, void* ml_part,
                           int dtype, int mode, int combine, int64_t B, int64_t H, int64_t D,
                           int64_t L, int64_t S, int64_t layer, int64_t cur_len, int64_t chunk,
                           int64_t rows_per_split, int64_t nsplit, void* stream) {
  if (chunk != kTile || D != 64 || H * D < kTile || rows_per_split % kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* ml = static_cast<float*>(ml_part);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_mode<float>(mode, q, kv, out, op, ml, combine, B, H, L, S, layer, cur_len,
                               rows_per_split, nsplit, st);
  } else if (dtype == 1) {
    err = dispatch_mode<__nv_bfloat16>(mode, q, kv, out, op, ml, combine, B, H, L, S, layer,
                                       cur_len, rows_per_split, nsplit, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
