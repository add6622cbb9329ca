// K4 on Hopper for the caches that the tensor-core window kernel does not
// take: flash-decoding of W window queries, one block per (batch row,
// split of the context) covering ALL heads.
//
// Replaces, for those caches, the TPU kernel
//   meshanything_tpu/ops/decode_attention.py::_flash_decode_kernel
// with win_kv set (decode_attention_mq_impl, _mq_int8_impl,
// _mq_int4_impl, from the window forward of models/lookahead.py): W
// queries per row over the confirmed cache rows [0, base[b]) plus the W
// window rows as one causal tile. Which cases come here
// (ops/decode_attention.py::mq_kernel_for): the f32 cache; the int8 and
// int4 caches with f32 queries (held tightly, at 1e-5, against their
// plain version); and the small config's head width 8 over any cache.
// A bf16 cache at head width 64, and the int8/int4 caches with bf16
// queries at head width 64 (the fast tier's path), go to
// decode_attention_window.cu, and the entry point below refuses them.
// K2 and K3 (one query) are decode_attention_quant.cu.
//
// Numerics (the TPU kernels' contract, decode_attention.py:280-347 and
// :689-714):
//   logit = (q . codes) * (1/sqrt(D)) [* k_scale[s]]        in f32
//   l accumulates the UNSCALED p = exp(logit - m);
//   then p <- p * v_scale[s], and in the quantized tiers with bf16
//   queries p is rounded to bf16 before P.V; P.V accumulates in f32;
//   out = acc / max(l, 1e-30), cast to the query dtype once.
// Codes (int8, int4) and bf16 values are exact in f32, so the dots are
// the TPU kernels' up to summation order.
//
// A simple kernel: CUDA cores, no TMA, no pipeline. A block stages a tile
// of T whole rows (all heads) of K and V into shared memory with 16-byte
// loads, so every packed word is read from device memory once per call
// (an int4 word carries columns of 8 different heads); the W queries of a
// row share each staged tile; the context is split across blocks (grid =
// (B, splits)) and a second kernel combines the f32 partials; the window
// tile is one more split, and splits past base[b] stage no rows (base[b]
// stays on the device: the grid is sized by the cache length). Offsets
// are 64-bit. Shared-memory rows are padded by one word so that the
// logit pass (one thread per (row, head)) reads without bank conflicts.
// The kernels allocate nothing and do not synchronise; the Python wrapper
// allocates the partials and the output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "row_stream.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Fmt : int { kF32 = 0, kBF16 = 1, kI8 = 2, kI4 = 3 };

// 32-bit words in one flat row of hd columns
template <int F>
__host__ __device__ constexpr int words_per_row(int hd) {
  return F == kF32 ? hd : F == kBF16 ? hd / 2 : F == kI8 ? hd / 4 : hd / 8;
}

// rows per staged tile: the f32 / bf16 tiles are larger per row, and the
// smaller tile keeps W = 16 inside a block's 227 KB of shared memory
template <int F>
__host__ __device__ constexpr int tile_rows() {
  return (F == kF32 || F == kBF16) ? 16 : 32;
}

// columns c .. c+3 (c a multiple of 4) of a staged row, as f32.
// nw = words per row (the int4 plane width).
template <int F>
__device__ __forceinline__ void load4(const uint32_t* row, int c, int nw, float* out) {
  if constexpr (F == kF32) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = __uint_as_float(row[c + j]);
  } else if constexpr (F == kBF16) {
    // element 2i sits in the low half of word i
    const uint32_t w0 = row[c >> 1];
    const uint32_t w1 = row[(c >> 1) + 1];
    out[0] = __uint_as_float(w0 << 16);
    out[1] = __uint_as_float(w0 & 0xffff0000u);
    out[2] = __uint_as_float(w1 << 16);
    out[3] = __uint_as_float(w1 & 0xffff0000u);
  } else if constexpr (F == kI8) {
    const uint32_t w = row[c >> 2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[j] = static_cast<float>(static_cast<int32_t>(w << (24 - 8 * j)) >> 24);
  } else {
    // plane packing: column c is nibble c / nw of word c % nw; since nw
    // and c are multiples of 4, the 4 columns are 4 neighbouring words
    // of one plane. Sign extension rides the arithmetic shift.
    const int sh = 28 - 4 * (c / nw);
    const uint32_t* w = row + (c % nw);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = static_cast<float>(static_cast<int32_t>(w[j] << sh) >> 28);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Args {
  const void* q;           // (B, W, H, D) in the query dtype
  const uint32_t* kv;      // (2, L, B, S, nw) cache words, K plane then V plane
  const float* scales;     // (2, L, B, 1, S) f32, quantized caches only
  const int32_t* base;     // (B,) cache rows every query sees
  const uint32_t* win_k;   // (B, W, nw) window rows
  const uint32_t* win_v;
  const float* win_ks;     // (B, 1, W) f32, quantized caches only
  const float* win_vs;
  float* o_part;           // (B*W*H, nsplit, D) f32
  float* ml_part;          // (B*W*H, nsplit, 2) f32: running max, running sum
  int64_t B, W, H, L, S, layer, rows_per_split;
  int64_t nsplit_cache;    // splits over the cache; the window tile is split nsplit_cache
  int64_t nsplit;          // blocks along y
  float scale;             // 1 / sqrt(D)
};

// Shared-memory floats of one block (the host sizes the launch with it).
template <int F, int D, int WMAX>
__host__ __device__ constexpr int64_t smem_floats(int h) {
  constexpr int T = tile_rows<F>();
  const int hd = h * D;
  const int rs = words_per_row<F>(hd) + 1;
  const int nsets = kThreads / (hd / 4);
  return static_cast<int64_t>(WMAX) * hd + 2 * T * rs + WMAX * h * (T + 1) + 2 * T +
         3 * WMAX * h + (nsets > 1 ? kThreads * 4 * WMAX : 0);
}

// One block = batch row b and one split: the cache rows
// [split * rows_per_split, min(n, (split + 1) * rows_per_split)) or, for
// split == nsplit_cache with a window, the W window rows under the causal
// mask (query w sees window rows 0..w). Writes the split's unnormalized
// f32 accumulators and its running max and sum for every (w, h).
template <int F, typename QT, int D, int WMAX>
__global__ void __launch_bounds__(kThreads) tile_split_kernel(const Args a) {
  constexpr int T = tile_rows<F>();
  constexpr bool kQuant = F == kI8 || F == kI4;
  constexpr bool kLowP = kQuant && std::is_same<QT, __nv_bfloat16>::value;
  static_assert(D % 4 == 0 && T <= 32, "4-column groups; one lane per tile row");

  extern __shared__ __align__(16) float smem[];
  const int H = static_cast<int>(a.H);
  const int W = static_cast<int>(a.W);
  const int HD = H * D;
  const int nw = words_per_row<F>(HD);
  const int rs = nw + 1;                        // odd row stride: no bank conflicts
  const int WH = WMAX * H;
  float* s_q = smem;                            // WMAX * HD, zero past W
  uint32_t* s_k = reinterpret_cast<uint32_t*>(s_q + WMAX * HD);   // T * rs
  uint32_t* s_v = s_k + T * rs;
  float* s_l = reinterpret_cast<float*>(s_v + T * rs);            // WH * (T + 1)
  float* s_ks = s_l + WH * (T + 1);
  float* s_vs = s_ks + T;
  float* s_m = s_vs + T;                        // WH: running max
  float* s_sum = s_m + WH;                      // WH: running sum of unscaled p
  float* s_corr = s_sum + WH;                   // WH: this tile's rescale factor
  float* s_red = s_corr + WH;                   // row-set reduction (nsets > 1)

  const int64_t b = blockIdx.x;
  const int64_t split = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool windowed = split == a.nsplit_cache;

  const uint32_t* kp;
  const uint32_t* vp;
  const float* ksp = nullptr;
  const float* vsp = nullptr;
  int64_t row0, row1;
  if (windowed) {
    kp = a.win_k + b * W * nw;
    vp = a.win_v + b * W * nw;
    if (kQuant) {
      ksp = a.win_ks + b * W;
      vsp = a.win_vs + b * W;
    }
    row0 = 0;
    row1 = W;
  } else {
    int64_t n = a.base[b];
    n = n < a.S ? n : a.S;
    row0 = split * a.rows_per_split;
    row1 = row0 + a.rows_per_split < n ? row0 + a.rows_per_split : n;
    const int64_t plane = a.L * a.B * a.S;      // rows per K or V plane
    const int64_t first = (a.layer * a.B + b) * a.S;
    kp = a.kv + first * nw;
    vp = a.kv + (plane + first) * nw;
    if (kQuant) {
      ksp = a.scales + first;
      vsp = a.scales + plane + first;
    }
  }

  const QT* q = static_cast<const QT*>(a.q) + b * W * HD;
  for (int i = tid; i < WMAX * HD; i += kThreads) {
    const int w = i / HD;
    s_q[i] = w < W ? to_float(q[i]) : 0.f;
  }
  for (int i = tid; i < WH; i += kThreads) {
    s_m[i] = -INFINITY;
    s_sum[i] = 0.f;
  }

  // P.V mapping: thread owns 4 neighbouring columns (one head) of one
  // row set; row sets split the tile's rows when HD/4 < kThreads
  const int ncg = HD / 4;
  const int nsets = kThreads / ncg;
  const int cg = tid % ncg;
  const int set = tid / ncg;
  const int c0 = 4 * cg;
  const int hh = c0 / D;
  float acc[WMAX][4];
#pragma unroll
  for (int w = 0; w < WMAX; ++w)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[w][j] = 0.f;
  __syncthreads();

  for (int64_t t0 = row0; t0 < row1; t0 += T) {
    const int rows = row1 - t0 < T ? static_cast<int>(row1 - t0) : T;

    // stage K and V rows [t0, t0 + rows): 16-byte loads, each word once
    const int vpr = nw / 4;
    for (int i = tid; i < rows * vpr; i += kThreads) {
      const int r = i / vpr;
      const int j = (i - r * vpr) * 4;
      const uint4 kq = __ldg(reinterpret_cast<const uint4*>(kp + (t0 + r) * nw + j));
      const uint4 vq = __ldg(reinterpret_cast<const uint4*>(vp + (t0 + r) * nw + j));
      uint32_t* dk = s_k + r * rs + j;
      uint32_t* dv = s_v + r * rs + j;
      dk[0] = kq.x; dk[1] = kq.y; dk[2] = kq.z; dk[3] = kq.w;
      dv[0] = vq.x; dv[1] = vq.y; dv[2] = vq.z; dv[3] = vq.w;
    }
    if (kQuant && tid < rows) {
      s_ks[tid] = ksp[t0 + tid];
      s_vs[tid] = vsp[t0 + tid];
    }
    __syncthreads();

    // logits: one thread per (row, head), all WMAX queries at once
    for (int p = tid; p < T * H; p += kThreads) {
      const int r = p % T;
      const int h = p / T;
      const uint32_t* krow = s_k + r * rs;
      float dot[WMAX];
#pragma unroll
      for (int w = 0; w < WMAX; ++w) dot[w] = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; dd += 4) {
        const int c = h * D + dd;
        float k4[4];
        load4<F>(krow, c, nw, k4);
#pragma unroll
        for (int w = 0; w < WMAX; ++w) {
          const float4 qv = *reinterpret_cast<const float4*>(s_q + w * HD + c);
          dot[w] = fmaf(qv.x, k4[0], dot[w]);
          dot[w] = fmaf(qv.y, k4[1], dot[w]);
          dot[w] = fmaf(qv.z, k4[2], dot[w]);
          dot[w] = fmaf(qv.w, k4[3], dot[w]);
        }
      }
#pragma unroll
      for (int w = 0; w < WMAX; ++w) {
        float lg = dot[w] * a.scale;
        if (kQuant) lg *= s_ks[r];               // stale past `rows`: masked below
        s_l[(w * H + h) * (T + 1) + r] = lg;
      }
    }
    __syncthreads();

    // online softmax: one warp per (w, h), one lane per tile row
    for (int qh = warp; qh < W * H; qh += kWarps) {
      const int w = qh / H;
      float* lrow = s_l + qh * (T + 1);
      const bool valid = lane < rows && (!windowed || lane <= w);
      const float x = valid ? lrow[lane] : -INFINITY;
      const float m_old = s_m[qh];
      const float m_new = fmaxf(m_old, warp_max(x));   // finite: row 0 is always valid
      float p = valid ? expf(x - m_new) : 0.f;
      const float psum = warp_sum(p);
      const float corr = expf(m_old - m_new);
      if (kQuant) p = valid ? p * s_vs[lane] : 0.f;
      if (kLowP) p = __bfloat162float(__float2bfloat16_rn(p));
      if (lane < T) lrow[lane] = p;
      if (lane == 0) {
        s_sum[qh] = s_sum[qh] * corr + psum;
        s_m[qh] = m_new;
        s_corr[qh] = corr;
      }
    }
    __syncthreads();

    // P.V: rescale, then accumulate this tile's rows of the row set
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
      if (w < W) {
        const float corr = s_corr[w * H + hh];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[w][j] *= corr;
      }
    }
    for (int r = set; r < rows; r += nsets) {
      float v4[4];
      load4<F>(s_v + r * rs, c0, nw, v4);
#pragma unroll
      for (int w = 0; w < WMAX; ++w) {
        if (w < W) {
          const float pr = s_l[(w * H + hh) * (T + 1) + r];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[w][j] = fmaf(pr, v4[j], acc[w][j]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites the staged rows and s_l
  }

  // partials of this split: part = (b*W*H + w*H + h) * nsplit + split
  const int64_t part0 = b * W * H;
  if (nsets == 1) {
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
      if (w < W) {
        const int64_t part = (part0 + w * H + hh) * a.nsplit + split;
#pragma unroll
        for (int j = 0; j < 4; ++j) a.o_part[part * D + (c0 % D) + j] = acc[w][j];
      }
    }
  } else {
    // sum the row sets in a fixed order (deterministic)
#pragma unroll
    for (int w = 0; w < WMAX; ++w)
#pragma unroll
      for (int j = 0; j < 4; ++j) s_red[(set * WMAX + w) * HD + c0 + j] = acc[w][j];
    __syncthreads();
    for (int i = tid; i < W * HD; i += kThreads) {
      const int w = i / HD;
      const int c = i - w * HD;
      float s = 0.f;
      for (int st = 0; st < nsets; ++st) s += s_red[(st * WMAX + w) * HD + c];
      const int64_t part = (part0 + w * H + c / D) * a.nsplit + split;
      a.o_part[part * D + c % D] = s;
    }
  }
  for (int qh = tid; qh < W * H; qh += kThreads) {
    const int64_t part = (part0 + qh) * a.nsplit + split;
    a.ml_part[2 * part] = s_m[qh];      // -inf for an empty split
    a.ml_part[2 * part + 1] = s_sum[qh];
  }
}

// One block of D threads per (b, w, h): rescale every split to the
// global max, sum, and normalize: out = acc / max(l, 1e-30).
template <typename QT, int D>
__global__ void combine_kernel(const float* __restrict__ o_part, const float* __restrict__ ml_part,
                               QT* __restrict__ out, int64_t nsplit) {
  const int64_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = ml_part + 2 * row * nsplit;
  float m = -INFINITY;
  for (int64_t s = 0; s < nsplit; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f;
  float o = 0.f;
  for (int64_t s = 0; s < nsplit; ++s) {
    const float ms = ml[2 * s];
    if (ms == -INFINITY) continue;  // a split with no rows
    const float w = expf(ms - m);
    l = fmaf(ml[2 * s + 1], w, l);
    o = fmaf(o_part[(row * nsplit + s) * D + d], w, o);
  }
  store(out + row * D + d, o / fmaxf(l, 1e-30f));
}

template <int F, typename QT, int D, int WMAX>
cudaError_t launch(const Args& a, void* out, cudaStream_t stream) {
  const int64_t hd = a.H * D;
  if (hd % 4 || hd / 4 > kThreads || kThreads % (hd / 4) || words_per_row<F>(hd) % 4 ||
      a.W < 1 || a.W > WMAX)
    return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(smem_floats<F, D, WMAX>(static_cast<int>(a.H))) * 4;
  auto kernel = tile_split_kernel<F, QT, D, WMAX>;
  // the opt-in above 48 KB, made once a device and instantiation at the
  // largest size any head count asks for, so that a CUDA-graph capture
  // after the first call on a device sees launches only
  static int64_t opted_in[row_stream::kMaxDevices] = {};
  const cudaError_t opt = row_stream::opt_in_smem(kernel, static_cast<int64_t>(bytes), opted_in);
  if (opt != cudaSuccess) return opt;
  const dim3 grid(static_cast<unsigned>(a.B), static_cast<unsigned>(a.nsplit));
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  combine_kernel<QT, D><<<static_cast<unsigned>(a.B * a.W * a.H), D, 0, stream>>>(
      a.o_part, a.ml_part, static_cast<QT*>(out), a.nsplit);
  return cudaGetLastError();
}

// bf16 queries at head width 64 over a bf16, int8 or int4 cache are the
// window kernel's (decode_attention_window.cu): not built here
template <int F, typename QT>
__host__ __device__ constexpr bool window_kernel_case() {
  return std::is_same<QT, __nv_bfloat16>::value;
}

template <int F, typename QT, int WMAX>
cudaError_t dispatch_d(const Args& a, int64_t D, void* out, cudaStream_t stream) {
  switch (D) {
    case 8:  // small_test_config (hidden 32, 4 heads)
      return launch<F, QT, 8, WMAX>(a, out, stream);
    case 64:  // the 350M model (hidden 1024, 16 heads)
      if constexpr (window_kernel_case<F, QT>()) {
        return cudaErrorInvalidValue;
      } else {
        return launch<F, QT, 64, WMAX>(a, out, stream);
      }
    default:
      return cudaErrorInvalidValue;
  }
}

template <int F, typename QT>
cudaError_t dispatch_w(const Args& a, int64_t D, void* out, cudaStream_t stream) {
  if (a.W <= 4) return dispatch_d<F, QT, 4>(a, D, out, stream);
  if (a.W <= 8) return dispatch_d<F, QT, 8>(a, D, out, stream);
  return dispatch_d<F, QT, 16>(a, D, out, stream);
}

}  // namespace

// K4. fmt: 0 = float32, 1 = bfloat16 (qdtype must match), 2 = int8,
// 3 = int4. base (B,) int32 on the card; win_k / win_v (B, W, nw) in the
// cache's words; win_ks / win_vs (B, 1, W) f32 for the quantized caches
// (null otherwise). W <= 16. bf16 queries only at head width 8 (at 64
// they are the window kernel's: refused). o_part is
// (B*W*H*(nsplit_cache + 1), D) f32, ml_part (B*W*H*(nsplit_cache + 1), 2)
// f32.
extern "C" int mt_decode_attention_mq(const void* q, const void* kv, const void* scales,
                                      const void* base, const void* win_k, const void* win_v,
                                      const void* win_ks, const void* win_vs, void* out,
                                      void* o_part, void* ml_part, int fmt, int qdtype, int64_t B,
                                      int64_t W, int64_t H, int64_t D, int64_t L, int64_t S,
                                      int64_t layer, int64_t rows_per_split,
                                      int64_t nsplit_cache, void* stream) {
  if (W < 1 || W > 16 || win_k == nullptr || win_v == nullptr) return cudaErrorInvalidValue;
  Args a{q,
         static_cast<const uint32_t*>(kv),
         static_cast<const float*>(scales),
         static_cast<const int32_t*>(base),
         static_cast<const uint32_t*>(win_k),
         static_cast<const uint32_t*>(win_v),
         static_cast<const float*>(win_ks),
         static_cast<const float*>(win_vs),
         static_cast<float*>(o_part),
         static_cast<float*>(ml_part),
         B, W, H, L, S, layer, rows_per_split, nsplit_cache, nsplit_cache + 1,
         static_cast<float>(1.0 / sqrt(static_cast<double>(D)))};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (fmt == kF32 && qdtype == 0) err = dispatch_w<kF32, float>(a, D, out, st);
  if (fmt == kBF16 && qdtype == 1) err = dispatch_w<kBF16, __nv_bfloat16>(a, D, out, st);
  if (fmt == kI8 && qdtype == 0) err = dispatch_w<kI8, float>(a, D, out, st);
  if (fmt == kI8 && qdtype == 1) err = dispatch_w<kI8, __nv_bfloat16>(a, D, out, st);
  if (fmt == kI4 && qdtype == 0) err = dispatch_w<kI4, float>(a, D, out, st);
  if (fmt == kI4 && qdtype == 1) err = dispatch_w<kI4, __nv_bfloat16>(a, D, out, st);
  return static_cast<int>(err);
}

extern "C" const char* mt_fast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
