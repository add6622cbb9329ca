// K1 on Hopper: single-query flash-decoding over the flat KV cache.
//
// Replaces the TPU kernel
//   meshanything_tpu/ops/decode_attention.py::_flash_decode_pipelined_kernel
// (reached through decode_attention_impl(pipelined=True) from the decode
// step of models/shape_opt.py). It computes, for every batch row b and
// head h,
//   out[b, h] = softmax((q[b, h] . K[b, s, h]) / sqrt(D), s < cur_len) . V[b, s, h]
// over the cache laid out as (2, L, B, S, H*D), K at plane 0, V at plane 1,
// at a runtime layer index. Only rows s < cur_len are read.
//
// Numerics follow the TPU kernel's f32 contract: bf16 (or f32) operands
// are widened to f32, logits are accumulated in f32 and scaled by
// 1/sqrt(D) after the dot, the online-softmax statistics stay in f32,
// P.V runs with P in f32, and the result is cast to q's dtype once.
//
// What bounds it on this card: the bytes of the live K/V rows. One call
// reads 2 * B * cur_len * H * D * sizeof(T) bytes (489 MB at B=16,
// cur_len 7459, bf16) and does 4 flops per element read, far below the
// H100's ~295 flops/byte balance point, so the floor is those bytes over
// the ~3.35 TB/s of HBM3. The arithmetic hides under the row stream (the
// probe of k1_probe.cu measures it), so the design is about the stream.
//
// What the design does about it:
//   * grid (B, splits): a block owns one batch row and one split of the
//     context and streams whole flat rows (all heads), K and V of a tile
//     in flight together, through the TMA ring of row_stream.cuh, two
//     tiles ahead of the arithmetic. No thread spends a load instruction
//     or a register on the cache's bytes, and nothing waits for a K load
//     before a V load is started. A plane's tile is one 32 KiB bulk copy:
//     the probe measures it 6% ahead of one copy a row at B=16 (its
//     `tap` against `tap_rows`), and this kernel's reads need no padding;
//   * one warp a head computes the dot, the online softmax and P.V of a
//     tile out of shared memory on CUDA cores (one query: tensor cores
//     have nothing to batch), with warp shuffles only: the one block-wide
//     barrier a tile is the ring's;
//   * about one block an SM (`split_plan` in ops/decode_attention.py:
//     splits of whole tiles, balanced to within one tile), so B=1 fills
//     the card with 132 long-lived blocks;
//   * the combine is folded into this kernel (split_fold.cuh): one launch
//     a call;
//   * the live length is read on the device, so that one CUDA graph of a
//     decode step replays at every length: the grid is planned for a host
//     bound (the cache's S), each block recomputes the plan of the live
//     length (split_fold::plan_for) and the surplus blocks return at once,
//     so the rows are split and folded as a call planned for the live
//     length splits and folds them, bit for bit;
//   * all offsets into the cache are 64-bit: the B=16 bf16 cache is 11.25
//     GiB and its K->V plane stride is past 2^31 bytes.
// The kernel allocates nothing and does not synchronise; the Python
// wrapper allocates the partials and the output and holds the counters.
//
// MODE cuts parts of the body or of its machinery out for the probe of
// k1_probe.cu, which includes this file; K1 itself is MODE == kFull and
// this library builds no other.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_stream.cuh"
#include "split_fold.cuh"

namespace {

constexpr int kMaxHeads = 16;  // one warp a head

enum ProbeMode {
  kFull = 0,
  kTap = 1,
  kQk = 2,
  kSoftmax = 3,
  kPv = 4,
  kNoFold = 5,   // kFull with the partials left as the result
  kDepth1 = 6,   // kFull through a ring of one slot
  kTapRows = 7   // kTap with one bulk copy a row, landing padded
};

__host__ __device__ constexpr bool full_math(int mode) {
  return mode == kFull || mode == kNoFold || mode == kDepth1;
}
__host__ __device__ constexpr bool tap_only(int mode) { return mode == kTap || mode == kTapRows; }
__host__ __device__ constexpr int ring_depth(int mode) {
  return mode == kDepth1 ? 1 : row_stream::kDepth;
}
__host__ __device__ constexpr int ring_pad(int mode) {
  return mode == kTapRows ? row_stream::kRowPad : 0;
}

// rows of a tile: 32 bytes of rows a lane, so that a tile of the 350M
// width is 32 KiB a plane in either dtype
template <typename T>
__host__ __device__ constexpr int tile_rows() {
  return 32 / static_cast<int>(sizeof(T));
}

// One 16-byte chunk of a row in shared memory, widened to f32.
__device__ __forceinline__ void load_chunk(const unsigned char* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load_chunk(const unsigned char* p, float (&out)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);  // bf16 -> f32 is a shift
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Args {
  const void* q;     // (B, H, D)
  const void* kv;    // (2, L, B, S, H*D)
  void* out;         // (B, H, D)
  split_fold::Plan fold;    // the grid's plan, made for max_len rows
  const int32_t* cur_len;   // the live length, read on the device
  int64_t B, H, L, S, layer, max_len;
  float scale;       // 1 / sqrt(D)
};

// One block = batch row b and one split of the context: tiles
// [split * tiles / nsplit, (split + 1) * tiles / nsplit) of TR rows; one
// warp a head. Writes the split's unnormalized f32 accumulator, running
// max and running sum, then folds (split_fold.cuh).
//
// A lane is (g, c) = (lane / NCH, lane % NCH): 16-byte chunk c of the
// head's slice, in rows g, g + G, .. of the tile, for the dot as for P.V,
// so a lane's own logits are the P of the rows it multiplies with V. A
// quarter-warp reads eight neighbouring chunks of one row: no bank
// conflict whatever the stride of the rows, so they may land unpadded.
template <typename T, int D, int MODE>
__global__ void __launch_bounds__(32 * kMaxHeads, 1) decode_split_kernel(const Args a) {
  constexpr int TR = tile_rows<T>();                 // 16 (bf16) or 8 (f32) rows a tile
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements of a 16-byte chunk
  constexpr int NCH = D / EPC;                       // chunks of a head's slice of a row
  constexpr int G = 32 / NCH;                        // row groups of a warp
  constexpr int RPL = TR / G > 0 ? TR / G : 1;       // rows a lane
  constexpr bool kDot = full_math(MODE) || MODE == kQk;      // the QK dot runs
  constexpr bool kStats = !tap_only(MODE) && MODE != kQk;    // the online softmax runs
  constexpr bool kProduct = full_math(MODE) || MODE == kPv;  // P.V runs
  static_assert(D % EPC == 0 && NCH <= 32 && 32 % NCH == 0,
                "head_dim must be whole 16-byte chunks, at most 32 of them");

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[row_stream::kMaxDepth];

  const int64_t b = blockIdx.x;
  const int split = blockIdx.y;
  const int H = static_cast<int>(a.H);
  const int h = threadIdx.x >> 5;   // this warp's head
  const int lane = threadIdx.x & 31;
  const int c = lane % NCH;
  const int g = lane / NCH;

  // the live plan (split_fold.cuh): the splits and groups of the call
  // planned for this length; the grid's surplus blocks leave here
  const int64_t cur_len = split_fold::live_length(a.cur_len, a.max_len);
  const int64_t plan_len = cur_len;
  const split_fold::Plan fold = split_fold::plan_for(a.fold, (plan_len + TR - 1) / TR);
  if (split >= fold.nsplit) return;

  const int64_t tiles = (cur_len + TR - 1) / TR;
  const int64_t row0 = (split * tiles / fold.nsplit) * TR;
  int64_t row1 = ((split + 1) * tiles / fold.nsplit) * TR;
  row1 = row1 < cur_len ? row1 : cur_len;
  const uint32_t row_bytes = static_cast<uint32_t>(H * D * sizeof(T));
  const int64_t first = (a.layer * a.B + b) * a.S;   // flat row 0 of (layer, b)
  const unsigned char* kp = static_cast<const unsigned char*>(a.kv) + first * row_bytes;
  const unsigned char* vp = kp + a.L * a.B * a.S * row_bytes;

  row_stream::Ring ring;
  ring.init(smem, bars, ring_depth(MODE), TR, row_bytes, ring_pad(MODE), kp, vp, row0, row1);

  float qf[EPC];
  {
    const T* q = static_cast<const T*>(a.q) + (b * H + h) * D + c * EPC;
#pragma unroll
    for (int j = 0; j < EPC; ++j) qf[j] = to_float(q[j]);
  }

  float m_run = -INFINITY;
  float l_run = 0.f;
  float acc[EPC];
#pragma unroll
  for (int j = 0; j < EPC; ++j) acc[j] = 0.f;

  for (int i = 0; i < ring.ntiles; ++i) {
    int rows;
    const unsigned char* ks = ring.acquire(i, &rows);
    const unsigned char* kc = ks + h * D * sizeof(T) + c * 16;   // this lane's chunk of row 0
    const unsigned char* vc = kc + ring.plane_bytes;

    // the logits of this lane's rows (rows past `rows` hold an earlier tile: masked)
    float logit[RPL];
    float m_tile = -INFINITY;
#pragma unroll
    for (int it = 0; it < RPL; ++it) {
      const int rr = g + it * G;
      const bool live = rr < rows;   // rows <= TR
      logit[it] = -INFINITY;
      if constexpr (kDot) {
        float dot = 0.f;
        if (live) {
          float kf[EPC];
          load_chunk(kc + rr * ring.row_stride, kf);
#pragma unroll
          for (int e = 0; e < EPC; ++e) dot = fmaf(qf[e], kf[e], dot);
        }
#pragma unroll
        for (int off = 1; off < NCH; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (live) logit[it] = dot * a.scale;
      } else if constexpr (MODE == kSoftmax || MODE == kPv) {
        // constant logits that still read K: column rr of the tile's first flat row
        if (live) logit[it] = -1.f + to_float(reinterpret_cast<const T*>(ks)[rr]);
      }
      m_tile = fmaxf(m_tile, logit[it]);
    }

    float p[RPL];
#pragma unroll
    for (int it = 0; it < RPL; ++it) p[it] = 0.f;
    if constexpr (!tap_only(MODE)) {
#pragma unroll
      for (int off = NCH; off < 32; off <<= 1)
        m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
    }
    if constexpr (kStats) {
      // online softmax statistics in f32
      const float m_new = fmaxf(m_run, m_tile);   // finite: row 0 of a tile is live
      float psum = 0.f;
#pragma unroll
      for (int it = 0; it < RPL; ++it) {
        p[it] = g + it * G < rows ? expf(logit[it] - m_new) : 0.f;
        psum += p[it];
      }
#pragma unroll
      for (int off = NCH; off < 32; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = expf(m_run - m_new);  // 0 on the first tile
      l_run = l_run * corr + psum;
      m_run = m_new;
#pragma unroll
      for (int j = 0; j < EPC; ++j) acc[j] *= corr;
    }

    if constexpr (kProduct) {
      // P.V with P in f32
#pragma unroll
      for (int it = 0; it < RPL; ++it) {
        const int rr = g + it * G;
        if (rr < rows) {
          float vf[EPC];
          load_chunk(vc + rr * ring.row_stride, vf);
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[e] = fmaf(p[it], vf[e], acc[e]);
        }
      }
    } else if (g == 0) {
      // the cut modes tap row 0 of the tile (see k1_probe.cu)
      float vf[EPC];
      load_chunk(vc, vf);
      const float add = MODE == kSoftmax ? p[0] : MODE == kQk ? m_tile : 0.f;
      if constexpr (tap_only(MODE)) {
        float kf[EPC];
        load_chunk(kc, kf);
#pragma unroll
        for (int e = 0; e < EPC; ++e) vf[e] += kf[e];
      }
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[e] += vf[e] + add;
    }
  }

  // sum the G row groups of the accumulator, in a fixed order
#pragma unroll
  for (int off = NCH; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  const int slots = fold.nsplit + fold.ngroups;
  const int64_t slot = (b * slots + split) * H + h;
  if (g == 0) {
    float* o = a.fold.o_part + slot * D + c * EPC;
#pragma unroll
    for (int e = 0; e < EPC; ++e) o[e] = acc[e];
  }
  if (lane == 0) {
    a.fold.ml_part[2 * slot] = kStats ? m_run : 0.f;   // tap, qk: the fold adds the splits up
    a.fold.ml_part[2 * slot + 1] = kStats ? l_run : 1.f;
  }
  if constexpr (MODE != kNoFold) {
    split_fold::finish<T, D, full_math(MODE)>(fold, b, split, H,
                                              static_cast<T*>(a.out) + b * H * D);
  }
}

template <typename T, int D, int MODE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int TR = tile_rows<T>();
  const int64_t tiles = (a.max_len + TR - 1) / TR;
  const int64_t row_bytes = a.H * D * static_cast<int64_t>(sizeof(T));
  if (a.H < 1 || a.H > kMaxHeads || row_bytes % 16 || a.cur_len == nullptr || a.max_len < 1 ||
      a.max_len > a.S || a.fold.nsplit < 1 ||
      a.fold.nsplit > tiles || a.fold.nsplit > 65535 || a.fold.group < 1 ||
      a.fold.ngroups != (a.fold.nsplit + a.fold.group - 1) / a.fold.group)
    return cudaErrorInvalidValue;
  const int64_t bytes =
      static_cast<int64_t>(ring_depth(MODE)) *
      row_stream::slot_bytes(TR, static_cast<uint32_t>(row_bytes), ring_pad(MODE));
  if (bytes > row_stream::kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = decode_split_kernel<T, D, MODE>;
  static int64_t opted_in[row_stream::kMaxDevices] = {};   // one record an instantiation
  const cudaError_t opt = row_stream::opt_in_smem(kernel, bytes, opted_in);
  if (opt != cudaSuccess) return opt;
  const dim3 grid(static_cast<unsigned>(a.B), static_cast<unsigned>(a.fold.nsplit));
  kernel<<<grid, 32 * static_cast<unsigned>(a.H), static_cast<size_t>(bytes), stream>>>(a);
  return cudaGetLastError();
}

inline Args make_args(const void* q, const void* kv, void* out, void* o_part, void* ml_part,
                      void* counters, const void* cur_len, int64_t B, int64_t H, int64_t D,
                      int64_t L, int64_t S, int64_t layer, int64_t max_len, int64_t nsplit,
                      int64_t group) {
  Args a;
  a.q = q;
  a.kv = kv;
  a.out = out;
  a.fold.o_part = static_cast<float*>(o_part);
  a.fold.ml_part = static_cast<float*>(ml_part);
  a.fold.counters = static_cast<int*>(counters);
  a.fold.nsplit = static_cast<int>(nsplit);
  a.fold.group = static_cast<int>(group);
  a.fold.ngroups = group > 0 ? static_cast<int>((nsplit + group - 1) / group) : 0;
  a.B = B;
  a.H = H;
  a.L = L;
  a.S = S;
  a.layer = layer;
  a.cur_len = static_cast<const int32_t*>(cur_len);
  a.max_len = max_len;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  return a;
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int64_t D, cudaStream_t stream) {
  switch (D) {
    case 8:  // small_test_config (hidden 32, 4 heads)
      return launch<T, 8, kFull>(a, stream);
    case 64:  // the 350M model (hidden 1024, 16 heads)
      return launch<T, 64, kFull>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// cur_len points to the live length, an int32 in device memory that the
// kernel reads (clamped to max_len, 1 <= max_len <= S). The grid is
// nsplit splits a batch row (split_plan for max_len rows), folded in
// groups of `group`; the kernel runs the plan of the live length inside
// it. o_part is (B, nsplit + ngroups, H, D) f32, ml_part
// (B, nsplit + ngroups, H, 2) f32, counters at least B * (1 + ngroups)
// int32, all 0 between calls. Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int mt_decode_attention(const void* q, const void* kv, void* out, void* o_part,
                                   void* ml_part, void* counters, const void* cur_len, int dtype,
                                   int64_t B, int64_t H, int64_t D, int64_t L, int64_t S,
                                   int64_t layer, int64_t max_len, int64_t nsplit, int64_t group,
                                   void* stream) {
  const Args a = make_args(q, kv, out, o_part, ml_part, counters, cur_len, B, H, D, L, S, layer,
                           max_len, nsplit, group);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = dispatch_d<float>(a, D, st);
  if (dtype == 1) err = dispatch_d<__nv_bfloat16>(a, D, st);
  return static_cast<int>(err);
}

extern "C" const char* mt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
