// The combine of flash-decoding folded into the split kernel.
//
// The TPU kernels carry the running max, sum and accumulator from one grid
// step to the next in scratch memory, because a TPU core runs its grid in
// order. Here the splits of a batch row run as parallel blocks, each
// writes its f32 partial (unnormalized accumulator, running max, running
// sum), and the partials have to be combined. A second launch for that
// costs as much as the whole kernel at B=1, so the block that finishes
// last does it:
//
//   * a block writes its partial, fences, and draws a ticket from a counter
//     in device memory (atomicAdd); the block that draws the last ticket
//     of its group reads the group's partials back (through L2) and sums
//     them IN SPLIT ORDER, not in arrival order, so the result is
//     bit-equal from run to run;
//   * two levels: one block reading all 132 partials of a B=1 call would
//     spend longer on them than the stream took, so the splits are
//     grouped (about sqrt(nsplit) a group: 12 at B=1); a group's last
//     block folds its group into one more partial and then draws a ticket of the
//     batch row, and the last of those folds the group partials and
//     writes `out`. Groups fold in parallel. With one group the first
//     level writes `out` itself;
//   * whoever draws a last ticket sets its counter back to 0: no memset
//     launch is needed, and a CUDA-graph replay finds the counters clean.
//
// Partials of a batch row b: slot p in [0, nsplit) is split p, slot
// nsplit + g is group g's fold.
//   o_part  (B, nsplit + ngroups, rows, D) f32
//   ml_part (B, nsplit + ngroups, rows, 2) f32: running max (-inf: the
//           split had no rows), running sum
// `rows` is the heads of a row (or window queries x heads). Counters of
// row b: counters[b * (1 + ngroups)] for the row, then one a group.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace split_fold {

struct Plan {
  float* o_part;
  float* ml_part;
  int* counters;
  int nsplit;    // splits of a batch row
  int group;     // splits a group
  int ngroups;   // ceil(nsplit / group)
};

// The live length of a call that reads it on the device (a 0-d int32
// tensor: a CUDA graph replays the call at every length), clamped to the
// host bound `max_len` for which the grid was planned.
__device__ __forceinline__ int64_t live_length(const int32_t* len, int64_t max_len) {
  const int64_t n = *len;
  return n < 0 ? 0 : (n > max_len ? max_len : n);
}

// ops/decode_attention.py::fold_group in device code: every split in one
// group up to 24 splits, isqrt(nsplit - 1) + 1 a group beyond.
__device__ __forceinline__ int fold_group(int nsplit) {
  if (nsplit <= 24) return nsplit;
  int r = static_cast<int>(sqrtf(static_cast<float>(nsplit - 1)));
  while (r * r > nsplit - 1) --r;
  while ((r + 1) * (r + 1) <= nsplit - 1) ++r;
  return r + 1;
}

// The plan that a call planned on the host for `tiles` live tiles would
// have made (ops/decode_attention.py::split_plan): the grid's splits were
// planned for the bound, about one block an SM, so the live plan is
// min(tiles, grid splits) splits in groups of fold_group of that. Every
// block computes it from the length it read; a block whose split is not
// in it returns at once and draws no ticket, and the fold's slots and
// tickets are the live plan's, so the call partitions the rows and folds
// them exactly as the call planned for the live length does: its output
// is bit-equal to that call's. The workspace is sized for the grid's plan,
// which holds every live plan (nsplit + ngroups grows with nsplit).
__device__ __forceinline__ Plan plan_for(const Plan& grid, int64_t tiles) {
  Plan p = grid;
  p.nsplit = static_cast<int>(tiles < grid.nsplit ? tiles : grid.nsplit);
  if (p.nsplit < 1) p.nsplit = 1;
  p.group = fold_group(p.nsplit);
  p.ngroups = (p.nsplit + p.group - 1) / p.group;
  return p;
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// True in every thread of the block that arrives last of `expected`
// blocks at `counter`. The block's earlier writes to device memory are
// visible to the block that gets true (the barrier orders them before
// thread 0's fence, which is cumulative); the counter is left at 0.
__device__ __forceinline__ bool last_to_arrive(int* counter, int expected) {
  __shared__ int s_ticket;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const int ticket = atomicAdd(counter, 1);
    if (ticket == expected - 1) {
      __threadfence();
      *counter = 0;
    }
    s_ticket = ticket;
  }
  __syncthreads();
  return s_ticket == expected - 1;
}

// Rescale partials [first, first + n) of one batch row to their common
// max and add them up in order, `rows` x D values by the whole block, four
// neighbouring values a thread. To `out` (divided by the running sum when
// NORMALIZE) or, with out null, as one more partial at slot `dst`. The
// loads of kBatch partials are started together and folded as one online-
// softmax step, so a group of up to kBatch splits waits for L2 once.
constexpr int kBatch = 12;

template <typename OT, int D, bool NORMALIZE>
__device__ __forceinline__ void fold(const float* o_row, const float* ml_row, int first, int n,
                                     int rows, int dst, float* o_dst_row, float* ml_dst_row,
                                     OT* out) {
  static_assert(D % 4 == 0, "four values a thread");
  for (int idx = 4 * threadIdx.x; idx < rows * D; idx += 4 * blockDim.x) {
    const int r = idx / D;
    const float2* ml =
        reinterpret_cast<const float2*>(ml_row) + static_cast<int64_t>(first) * rows + r;
    const float4* o =
        reinterpret_cast<const float4*>(o_row + static_cast<int64_t>(first) * rows * D + idx);
    const int64_t o_step = static_cast<int64_t>(rows) * D / 4;
    float m = -INFINITY;
    float l = 0.f;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < n; s0 += kBatch) {
      float2 mls[kBatch];
      float4 os[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const bool live = s0 + j < n;
        mls[j] = live ? __ldcg(ml + static_cast<int64_t>(s0 + j) * rows)
                      : make_float2(-INFINITY, 0.f);
        os[j] = live ? __ldcg(o + (s0 + j) * o_step) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float m_new = m;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) m_new = fmaxf(m_new, mls[j].x);
      if (m_new == -INFINITY) continue;   // splits with no rows so far
      const float corr = expf(m - m_new);  // 0 on the first batch
      m = m_new;
      l *= corr;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] *= corr;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (mls[j].x == -INFINITY) continue;  // no rows: its o_part was never written
        const float w = expf(mls[j].x - m);
        l = fmaf(mls[j].y, w, l);
        acc[0] = fmaf(os[j].x, w, acc[0]);
        acc[1] = fmaf(os[j].y, w, acc[1]);
        acc[2] = fmaf(os[j].z, w, acc[2]);
        acc[3] = fmaf(os[j].w, w, acc[3]);
      }
    }
    if (out != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store_out(out + idx + j, NORMALIZE ? acc[j] / fmaxf(l, 1e-30f) : acc[j]);
    } else {
      *reinterpret_cast<float4*>(o_dst_row + static_cast<int64_t>(dst) * rows * D + idx) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      if (idx % D == 0) {
        reinterpret_cast<float2*>(ml_dst_row)[static_cast<int64_t>(dst) * rows + r] =
            make_float2(m, l);
      }
    }
  }
}

// Called by every thread of block (b, split) after it wrote its partial:
// the two-level fold above. out_row: the batch row's `rows` x D outputs.
template <typename OT, int D, bool NORMALIZE>
__device__ __forceinline__ void finish(const Plan& p, int64_t b, int split, int rows,
                                       OT* out_row) {
  const int slots = p.nsplit + p.ngroups;
  float* o_row = p.o_part + b * slots * rows * D;
  float* ml_row = p.ml_part + b * slots * rows * 2;
  int* counters = p.counters + b * (1 + p.ngroups);
  const int g = split / p.group;
  const int first = g * p.group;
  const int members = p.nsplit - first < p.group ? p.nsplit - first : p.group;
  if (!last_to_arrive(counters + 1 + g, members)) return;
  if (p.ngroups == 1) {
    fold<OT, D, NORMALIZE>(o_row, ml_row, first, members, rows, 0, nullptr, nullptr, out_row);
    return;
  }
  fold<OT, D, NORMALIZE>(o_row, ml_row, first, members, rows, p.nsplit + g, o_row, ml_row,
                         static_cast<OT*>(nullptr));
  if (!last_to_arrive(counters, p.ngroups)) return;
  fold<OT, D, NORMALIZE>(o_row, ml_row, p.nsplit, p.ngroups, rows, 0, nullptr, nullptr, out_row);
}

}  // namespace split_fold
