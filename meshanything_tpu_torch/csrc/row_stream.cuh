// The shared row stream of the attention kernels: a block streams whole
// flat cache rows (all heads) of K and of V through a ring of shared-memory
// slots, filled by the Tensor Memory Accelerator while the block computes.
//
// It takes the place of what the TPU kernels in
// meshanything_tpu/ops/decode_attention.py do with pltpu.make_async_copy
// and DMA semaphores (the double-buffered chunk loop of
// _flash_decode_pipelined_kernel): there one core walks the chunks in
// order with one copy ahead; here every block owns one batch row and one
// split of the context and keeps `depth - 1` tiles of its own in flight.
//
// The cache is (2, L, B, S, H*D): a tile of T rows of one (layer, b) is
// T * row_bytes contiguous bytes in the K plane and as many in the V
// plane. One warp drives the copies: lane 0 arms the slot's mbarrier with
// the bytes of the (possibly ragged) tile, then the copies are started, K
// and V of a tile in flight together and all reported to that one
// barrier, as the dual stream of probes.cu does (which reaches the card's
// full read rate with this pattern). Two shapes, chosen by `pad`:
//   pad 0   one cp.async.bulk a plane: the tile lands as it lies in the
//           cache. The faster stream (6% at B=16 in the probe of
//           k1_probe.cu), for a consumer whose reads do not care about the
//           stride of the rows (K1: a quarter-warp reads one row's chunks);
//   pad 16  one cp.async.bulk a row and plane (the lanes share them), each
//           row landing at a stride of row_bytes + 16: the pad shifts a row
//           by four banks, so eight neighbouring rows read at one column
//           offset (ldmatrix in the window kernel) touch all 32 banks once.
//           One copy a tile could not pad.
//
// Only rows in [row0, row1) are requested from device memory. Rows of a
// ragged last tile that were not copied keep what an earlier tile left in
// the slot: the consumer masks them (and zeroes them before a tensor-core
// product, where 0 * NaN would be NaN). Offsets into the cache are 64-bit:
// the B=16 bf16 cache's K->V plane stride is past 2^31 bytes. Copy sizes
// and addresses are multiples of 16 bytes (row_bytes is; the launcher
// checks).
//
// Per tile the block pays one __syncthreads (everyone is done with the
// slot that is refilled next) and one wait on the slot's barrier; no load
// instruction and no register is spent on the bytes. Shared memory is the
// budget: at the 350M width a padded bf16 tile of 16 rows is 2 * 16 * 2,064
// bytes, so a ring of three is 198,144 of the 232,448 bytes a block may
// have (one block an SM).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace row_stream {

constexpr int kDepth = 3;       // slots of the ring: two tiles in flight behind the arithmetic
constexpr int kMaxDepth = 4;    // barriers a block holds for it
constexpr int kRowPad = 16;     // bytes between rows in a padded slot
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may opt in to
constexpr int kMaxDevices = 64;   // cards of one process

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16) from device to shared
// memory; its completion is counted in bytes on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Orders this thread's reads and writes of shared memory (generic proxy)
// before bulk copies started after the next barrier (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bytes of one slot: the K tile, then the V tile.
__host__ __device__ constexpr uint32_t slot_bytes(int tile_rows, uint32_t row_bytes, int pad) {
  return 2u * tile_rows * (row_bytes + pad);
}

// The opt-in to more than 48 KB of dynamic shared memory for `kernel` on
// the current device, made once a device at the largest size asked for so
// far (`opted_in`: the caller's record, one a kernel), so that a
// CUDA-graph capture after the first call on a device sees launches only.
template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel kernel, int64_t bytes, int64_t (&opted_in)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= opted_in[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) opted_in[device] = bytes;
  return err;
}

struct Ring {
  unsigned char* slots;        // depth slots of slot_bytes each, 128-byte aligned
  uint32_t slots_addr;         // the same as a shared-memory address
  uint32_t bars_addr;          // depth mbarriers
  const unsigned char* k;      // row 0 of the streamed rows in the K plane
  const unsigned char* v;      // and in the V plane
  int64_t row0, row1;          // the block's rows [row0, row1)
  int ntiles;
  int depth;
  int tile_rows;
  uint32_t row_bytes, row_stride, plane_bytes, slot_size;

  // Start the copies of tile i into slot i % depth. Called by every lane
  // of one warp.
  __device__ __forceinline__ void start(int i) const {
    const int lane = threadIdx.x & 31;
    const int64_t first = row0 + static_cast<int64_t>(i) * tile_rows;
    const int rows = row1 - first < tile_rows ? static_cast<int>(row1 - first) : tile_rows;
    const uint32_t slot = static_cast<uint32_t>(i % depth);
    const uint32_t bar = bars_addr + 8 * slot;
    const uint32_t dst = slots_addr + slot * slot_size;
    if (lane == 0) mbar_expect_tx(bar, 2u * rows * row_bytes);
    __syncwarp();
    if (row_stride == row_bytes) {
      // unpadded rows: a plane's tile is one copy
      if (lane < 2) {
        bulk_load(dst + lane * plane_bytes, (lane ? v : k) + first * row_bytes,
                  rows * row_bytes, bar);
      }
      return;
    }
    for (int j = lane; j < 2 * rows; j += 32) {
      const int plane = j >= rows;
      const int r = j - plane * rows;
      const unsigned char* src = (plane ? v : k) + (first + r) * row_bytes;
      bulk_load(dst + plane * plane_bytes + r * row_stride, src, row_bytes, bar);
    }
  }

  // Set the ring up over rows [row0, row1) of the planes at k and v and
  // start the first depth - 1 tiles. Called by every thread of the block;
  // `bars` holds kMaxDepth barriers; pad is 0 or kRowPad.
  __device__ __forceinline__ void init(unsigned char* smem, uint64_t* bars, int depth_,
                                       int tile_rows_, uint32_t row_bytes_, int pad,
                                       const unsigned char* k_, const unsigned char* v_,
                                       int64_t row0_, int64_t row1_) {
    slots = smem;
    slots_addr = smem_addr(smem);
    bars_addr = smem_addr(bars);
    k = k_;
    v = v_;
    row0 = row0_;
    row1 = row1_;
    depth = depth_;
    tile_rows = tile_rows_;
    row_bytes = row_bytes_;
    row_stride = row_bytes_ + pad;
    plane_bytes = tile_rows_ * row_stride;
    slot_size = 2 * plane_bytes;
    ntiles = static_cast<int>((row1_ - row0_ + tile_rows_ - 1) / tile_rows_);
    if (threadIdx.x == 0) {
      for (int i = 0; i < depth; ++i) mbar_init(bars_addr + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      for (int i = 0; i < depth - 1 && i < ntiles; ++i) start(i);
    }
  }

  // Tile i, for every thread of the block, tiles in order: refill the slot
  // that tile i - 1 was read from with tile i + depth - 1, wait for tile
  // i, and return its slot (K rows at the slot, V rows plane_bytes later);
  // *rows gets the rows it holds.
  __device__ __forceinline__ unsigned char* acquire(int i, int* rows) const {
    fence_proxy_async();
    __syncthreads();   // every warp is done with tile i - 1
    if (threadIdx.x < 32 && i + depth - 1 < ntiles) start(i + depth - 1);
    const uint32_t slot = static_cast<uint32_t>(i % depth);
    mbar_wait(bars_addr + 8 * slot, static_cast<uint32_t>((i / depth) & 1));
    const int64_t left = row1 - row0 - static_cast<int64_t>(i) * tile_rows;
    *rows = left < tile_rows ? static_cast<int>(left) : tile_rows;
    return slots + slot * slot_size;
  }
};

}  // namespace row_stream
