// Multi-head latent attention (MLA) of the Moonlight decoder's decode step
// on Hopper, in its absorbed form: every head attends the same cache row.
//
// It replaces no TPU kernel: the JAX package has no latent decoder. The
// cache is (L, B, S, 576) bf16, a row the normalised 512-wide latent and
// then the rotated 64-wide shared rope key (ops/latent_attention.py,
// models/moonlight.py). The caller has multiplied each head's no-rope
// query into the latent space, so a head's query is one 576-wide row too:
//
//   logit[h, r] = scale * q[h] . row[r]        for r in [0, cur_len)
//   out[h]      = softmax_r(logit[h]) . row[:, :512]
//
// With the 16 heads as the 16 rows of a tensor-core tile, both products
// are matrix products over one read of each cache row:
// S (16 heads x 32 rows) = Q (16 x 576) . R^T, and O (16 x 512) += P . R.
// The design follows K1 (decode_attention.cu) and the tensor-core K4:
//   * the rows [0, cur_len) of a batch row are split over about one block
//     an SM; the live length is read on the device and the grid, planned
//     for the bound, runs the live length's plan (split_fold::plan_for),
//     so a CUDA graph of the step replays at every length;
//   * a block copies the queries once and each tile of 32 cache rows with
//     cp.async into shared memory (two slots: the next tile lands while
//     this one is computed), rows padded to 1,168 bytes so that the eight
//     rows an ldmatrix reads fall on all 32 banks;
//   * eight warps, each owning 64 of the 512 output columns: each warp
//     computes the tile's S with mma.sync m16n8k16 (bf16 in, f32
//     accumulate: the products exact, as on CUDA cores), the online
//     softmax in f32, then P.V for its columns, P fed as two bf16 terms
//     (p0 = bf16(p), p1 = bf16(p - p0)), so that P.V carries P to 16 bits
//     of mantissa (the tensor-core K4's scheme); rows past the live ones
//     are zero in shared memory (0 * stale would be NaN) and masked in S;
//   * the splits' partials (16 x 512 f32 each) combined by a second launch
//     over 64 blocks a batch row, each 128 outputs, its 32 warps taking
//     every 32nd split (a few L2 round trips a thread): split_fold.cuh's fold
//     in the same launch is one block's walk over every partial, which at
//     8,192 values a split took 12-26 us of a 34 us call on the H100 (the
//     split kernel alone 8.4 us at 3,860 rows); the combine takes the
//     splits in a fixed order, so a call is bit-equal from run to run.
// K1's TMA ring (row_stream.cuh) streams two planes of equal rows, K and
// V; the latent cache has one plane, so the tile is copied with cp.async.
// The live plan is split_fold.cuh's (live_length, plan_for).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_fold.cuh"

namespace {

constexpr int kLatent = 512;             // latent values a row (and a head's output)
constexpr int kRope = 64;                // rotated rope key values a row
constexpr int kWidth = kLatent + kRope;  // 576 values, 1,152 bytes a row
constexpr int kChunks = kWidth / 8;      // 72 chunks of 16 bytes a row
constexpr int kStride = kWidth * 2 + 16; // a row's bytes in shared memory, padded
constexpr int kTile = 32;                // rows a tile (ops/latent_attention.py TILE)
constexpr int kHeads = 16;               // the tensor-core tile's rows: at most 16 heads
constexpr int kWarps = 8;                // each owns kLatent / kWarps output columns
constexpr int kCols = kLatent / kWarps;  // 64 columns: 8 n-tiles of 8
constexpr int kQBytes = kHeads * kStride;
constexpr int kSlotBytes = kTile * kStride;
constexpr int kSmem = kQBytes + 2 * kSlotBytes;   // 93,440 bytes
constexpr int kCombineValues = 128;      // outputs a block of the combine
constexpr int kCombineGroups = 32;       // its groups of 32 threads, a share of the splits each
constexpr int kMaxDevices = 64;

struct Args {
  const __nv_bfloat16* q;      // (B, H, 576)
  const __nv_bfloat16* cache;  // (L, B, S, 576)
  __nv_bfloat16* out;          // (B, H, 512)
  split_fold::Plan fold;       // the grid's plan, made for max_len rows: partials
                               // (B, fold.nsplit, H, 512) and their (max, sum)
  const int32_t* cur_len;      // the live length, read on the device
  int64_t B, H, L, S, layer, max_len;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `rows` rows of 576 values at `src` (contiguous) into shared memory
// at `dst` (padded rows), 16 bytes a copy, and zero the rows up to `zero_to`.
__device__ __forceinline__ void copy_rows(unsigned char* dst, const __nv_bfloat16* src, int rows,
                                          int zero_to) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  for (int c = threadIdx.x; c < rows * kChunks; c += blockDim.x) {
    const int r = c / kChunks, k = c % kChunks;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst + r * kStride + 16 * k)),
                 "l"(s + 16 * static_cast<int64_t>(c))
                 : "memory");
  }
  for (int c = rows * kChunks + threadIdx.x; c < zero_to * kChunks; c += blockDim.x) {
    *reinterpret_cast<uint4*>(dst + (c / kChunks) * kStride + 16 * (c % kChunks)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One block = batch row b and one split of the rows. In a warp, lane l is
// (g, t) = (l / 4, l % 4): the rows g and g + 8 of an mma tile (heads g and
// g + 8), its columns 2t and 2t + 1.
__global__ void __launch_bounds__(32 * kWarps) latent_split_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;
  unsigned char* slots = smem + kQBytes;
  const int64_t b = blockIdx.x;
  const int split = blockIdx.y;
  const int H = static_cast<int>(a.H);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const int64_t cur_len = split_fold::live_length(a.cur_len, a.max_len);
  const split_fold::Plan fold = split_fold::plan_for(a.fold, (cur_len + kTile - 1) / kTile);
  if (split >= fold.nsplit) return;
  const int64_t tiles = (cur_len + kTile - 1) / kTile;
  const int64_t row0 = (split * tiles / fold.nsplit) * kTile;
  int64_t row1 = ((split + 1) * tiles / fold.nsplit) * kTile;
  row1 = row1 < cur_len ? row1 : cur_len;
  const int ntiles = static_cast<int>((row1 - row0 + kTile - 1) / kTile);
  const __nv_bfloat16* rows0 = a.cache + ((a.layer * a.B + b) * a.S + row0) * kWidth;
  auto tile_rows = [&](int i) {
    const int64_t left = row1 - row0 - static_cast<int64_t>(i) * kTile;
    return left < kTile ? static_cast<int>(left) : kTile;
  };

  copy_rows(qs, a.q + b * H * kWidth, H, kHeads);     // heads past H: zero queries
  copy_rows(slots, rows0, tile_rows(0), kTile);

  // this lane's ldmatrix row addresses: A (queries) and B (a tile's rows)
  const int mi = lane >> 3, mr = lane & 7;            // the lane's matrix and row in it
  const uint32_t q_addr = smem_addr(qs + (mr + 8 * (mi & 1)) * kStride + 16 * (mi >> 1));
  const uint32_t k_off = (8 * (mi >> 1) + mr) * kStride + 16 * (mi & 1);
  const uint32_t v_off = (mr + 8 * (mi & 1)) * kStride + 2 * (warp * kCols + 8 * (mi >> 1));

  float m_run[2] = {-INFINITY, -INFINITY};   // heads g and g + 8
  float l_run[2] = {0.f, 0.f};
  float o[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      copy_rows(slots + ((i + 1) & 1) * kSlotBytes,
                rows0 + static_cast<int64_t>(i + 1) * kTile * kWidth, tile_rows(i + 1), kTile);
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();
    const int rows = tile_rows(i);
    const uint32_t slot = smem_addr(slots + (i & 1) * kSlotBytes);

    // S = Q . R^T: four n-tiles of 8 rows, 36 k-steps of 16 values
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < kWidth; kk += 16) {
      uint32_t qa[4], k01[4], k23[4];
      ldmatrix_x4(qa, q_addr + 2 * kk);
      ldmatrix_x4(k01, slot + k_off + 2 * kk);
      ldmatrix_x4(k23, slot + k_off + 16 * kStride + 2 * kk);
      mma(s[0], qa, k01[0], k01[1]);
      mma(s[1], qa, k01[2], k01[3]);
      mma(s[2], qa, k23[0], k23[1]);
      mma(s[3], qa, k23[2], k23[3]);
    }

    // online softmax in f32, heads g (c0, c1) and g + 8 (c2, c3)
    float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        s[j][e] = col < rows ? s[j][e] * a.scale : -INFINITY;
        m_tile[e >> 1] = fmaxf(m_tile[e >> 1], s[j][e]);
      }
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m_run[hh], quad_max(m_tile[hh]));   // finite: row 0 is live
      corr[hh] = expf(m_run[hh] - m_new);                            // 0 on the first tile
      m_run[hh] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_run[e >> 1]);   // 0 past the live rows
        psum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * corr[hh] + quad_sum(psum[hh]);
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P . R[:, warp's columns], P as two bf16 terms; two k-steps of 16 rows
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t p_hi[4], p_lo[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        // A fragment f: n-tile 2 kk + (f >> 1), head g (f even) or g + 8 (f odd)
        const float* src = s[2 * kk + (f >> 1)] + 2 * (f & 1);
        const float h0 = __bfloat162float(__float2bfloat16_rn(src[0]));
        const float h1 = __bfloat162float(__float2bfloat16_rn(src[1]));
        p_hi[f] = pack(h0, h1);
        p_lo[f] = pack(src[0] - h0, src[1] - h1);
      }
#pragma unroll
      for (int n = 0; n < kCols / 8; n += 2) {
        uint32_t v[4];
        ldmatrix_x4_trans(v, slot + v_off + 16 * kk * kStride + 2 * 8 * n);
        mma(o[n], p_hi, v[0], v[1]);
        mma(o[n], p_lo, v[0], v[1]);
        mma(o[n + 1], p_hi, v[2], v[3]);
        mma(o[n + 1], p_lo, v[2], v[3]);
      }
    }
    __syncthreads();   // every warp is done with the slot the next copy fills
  }

  // the split's partial: heads g and g + 8, this warp's columns
  const int64_t first = (b * a.fold.nsplit + split) * H;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int head = g + 8 * hh;
    if (head >= H) continue;
    float* dst = a.fold.o_part + (first + head) * kLatent + warp * kCols + 2 * t;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
    }
    if (warp == 0 && t == 0) {
      a.fold.ml_part[2 * (first + head)] = m_run[hh];
      a.fold.ml_part[2 * (first + head) + 1] = l_run[hh];
    }
  }
}

// (m, l, acc) += the partial (m_s, l_s, o_s), rescaled to their common max.
__device__ __forceinline__ void merge(float& m, float& l, float4& acc, float m_s, float l_s,
                                      float4 o_s) {
  const float m_new = fmaxf(m, m_s);
  if (m_new == -INFINITY) return;           // both empty
  const float c = expf(m - m_new), w = expf(m_s - m_new);
  l = l * c + l_s * w;
  acc.x = acc.x * c + o_s.x * w;
  acc.y = acc.y * c + o_s.y * w;
  acc.z = acc.z * c + o_s.z * w;
  acc.w = acc.w * c + o_s.w * w;
  m = m_new;
}

// grid (B, H * 512 / 128): block (b, y) makes outputs [128 y, 128 y + 128)
// of batch row b (flat over heads). Thread (grp, i) merges four outputs
// of the live splits grp, grp + 32, ..., in order; then group 0 merges
// the groups' results in group order and normalises.
__global__ void __launch_bounds__(32 * kCombineGroups) latent_combine_kernel(const Args a) {
  __shared__ float4 s_acc[kCombineGroups][32];
  __shared__ float2 s_ml[kCombineGroups][32];
  const int64_t b = blockIdx.x;
  const int grp = threadIdx.x >> 5, i = threadIdx.x & 31;
  const int64_t v = static_cast<int64_t>(blockIdx.y) * kCombineValues + 4 * i;
  const int64_t head = v / kLatent;
  const int64_t cur_len = split_fold::live_length(a.cur_len, a.max_len);
  const int live = split_fold::plan_for(a.fold, (cur_len + kTile - 1) / kTile).nsplit;
  const int64_t H = a.H;
  float m = -INFINITY, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = grp; s < live; s += kCombineGroups) {
    const int64_t at = (b * a.fold.nsplit + s) * H;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(a.fold.ml_part) + at + head);
    const float4 o = __ldcg(reinterpret_cast<const float4*>(a.fold.o_part + at * kLatent + v));
    merge(m, l, acc, ml.x, ml.y, o);
  }
  s_acc[grp][i] = acc;
  s_ml[grp][i] = make_float2(m, l);
  __syncthreads();
  if (grp != 0) return;
  for (int k = 1; k < kCombineGroups; ++k) {
    merge(m, l, acc, s_ml[k][i].x, s_ml[k][i].y, s_acc[k][i]);
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  __nv_bfloat16* out = a.out + b * H * kLatent + v;
  out[0] = __float2bfloat16(acc.x * inv);
  out[1] = __float2bfloat16(acc.y * inv);
  out[2] = __float2bfloat16(acc.z * inv);
  out[3] = __float2bfloat16(acc.w * inv);
}

}  // namespace

// C interface, loaded with ctypes; returns the CUDA error of the launches
// (0 on success). q (B, H, 576), cache (L, B, S, 576), out (B, H, 512),
// bf16, 16-byte aligned; o_part (B, nsplit, H, 512) and ml_part (B,
// nsplit, H, 2) f32 scratch (the stream's FoldWorkspace partials,
// ops/decode_attention.py); cur_len: a device int32, the live length, at
// most max_len <= S.
extern "C" int mt_latent_attention(const void* q, const void* cache, void* out, void* o_part,
                                   void* ml_part, const void* cur_len, int64_t B, int64_t H,
                                   int64_t L, int64_t S, int64_t layer, int64_t max_len,
                                   int64_t nsplit, float scale, void* stream) {
  const int64_t tiles = (max_len + kTile - 1) / kTile;
  if (B < 1 || B > 65535 || H < 1 || H > kHeads || layer < 0 || layer >= L ||
      max_len < 1 || max_len > S || cur_len == nullptr || nsplit < 1 || nsplit > tiles ||
      nsplit > 65535 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(cache) |
        reinterpret_cast<uintptr_t>(out)) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  static bool opted_in[kMaxDevices] = {};   // the opt-in is made once a device, before any capture
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(latent_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = true;
  }
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.cache = static_cast<const __nv_bfloat16*>(cache);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.fold.o_part = static_cast<float*>(o_part);
  a.fold.ml_part = static_cast<float*>(ml_part);
  a.fold.counters = nullptr;
  a.fold.nsplit = static_cast<int>(nsplit);
  a.fold.group = static_cast<int>(nsplit);
  a.fold.ngroups = 1;
  a.cur_len = static_cast<const int32_t*>(cur_len);
  a.B = B;
  a.H = H;
  a.L = L;
  a.S = S;
  a.layer = layer;
  a.max_len = max_len;
  a.scale = scale;
  const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(nsplit));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  latent_split_kernel<<<grid, 32 * kWarps, kSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 combine(static_cast<unsigned>(B), static_cast<unsigned>(H * kLatent / kCombineValues));
  latent_combine_kernel<<<combine, 32 * kCombineGroups, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mt_latent_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
