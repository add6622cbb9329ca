// The measurement kernels on Hopper: the build canary (T5) and the
// HBM-stream probe (T1, T2, T3).
//
// They replace the TPU kernels
//   tools/xla_cpu_crash_repro.py::kern            (T5: o = 2 x + c)
//   tools/dma_wire_probe.py::_stream_kernel       (T1: one array, chunk by chunk)
//   tools/dma_wire_probe.py::_stream_kernel_rot   (T2: the same from chunk `start`)
//   tools/dma_wire_probe.py::_dual_kernel         (T3: two arrays together)
//
// T5 is bound by bytes at a large size (8 bytes an element) and by launch
// latency at (8, 128), where its purpose is to prove in a few seconds that
// nvcc builds for this card and that a launch runs, before the slow builds
// start. A persistent grid-stride grid (eight blocks an SM at most) moves
// 16-byte float4 vectors where both pointers are 16-byte aligned, then the
// n % 4 tail (or every element, unaligned) one at a time.
//
// T1-T3 compute, as one f32, the sum of the first element of every chunk
// of a (rows, width) array (T2 adds `start`, T3 sums two arrays), while
// every byte of the array is copied from device memory into shared
// memory. Nothing but the bytes bounds them: the result is the card's
// sustained read rate through the copy machinery, the roof that the other
// kernels' rates are read against.
//
// What the design does about it. The TPU kernel is one program, because a
// TPU has one core and megabytes of VMEM. One CUDA block can neither fill
// the H100's HBM nor hold a 1 MiB chunk in its 227 KB of shared memory. So
// the grid is persistent (a block or two an SM), block i walks chunks
// i, i + grid, i + 2 grid, ..., and each chunk passes through a ring of
// `depth` slots in shared memory in stages of at most 32 KiB a slot. One
// thread of the block drives the Tensor Memory Accelerator: it starts one
// bulk copy (cp.async.bulk) a stage, `depth - 1` stages ahead, and each
// slot's arrival is reported to an mbarrier that the same thread waits on
// before it taps the first element of a chunk's first stage. The threads
// spend no registers and no instructions on the bytes, as the TPU's DMA
// engine spent none of the core's. T3 keeps the stage of both arrays in
// one slot and in flight together, reported to one barrier (`nsem` 1) or
// to one barrier an array (`nsem` 2). All offsets are 64-bit. A block adds
// its partial sum to the output with one atomicAdd; the launcher zeroes
// the output first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- T5

__global__ void scale_shift_kernel(const float* __restrict__ x, float* __restrict__ o, float c,
                                   int64_t n) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) & 15u) == 0;
  const int64_t nvec = aligned ? n / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(o);
  for (int64_t i = first; i < nvec; i += stride) {
    const float4 v = x4[i];
    o4[i] = make_float4(2.0f * v.x + c, 2.0f * v.y + c, 2.0f * v.z + c, 2.0f * v.w + c);
  }
  for (int64_t i = 4 * nvec + first; i < n; i += stride) o[i] = 2.0f * x[i] + c;
}

// ------------------------------------------------------------ T1-T3

constexpr int kMaxDepth = 8;       // slots of the ring
constexpr int kStreamThreads = 32;  // one warp; lane 0 drives the copies

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

// The first element of a landed stage as f32. elem: 0 = bfloat16, 1 = int8.
__device__ __forceinline__ float tap(const unsigned char* p, int elem) {
  if (elem == 0) {
    const uint32_t bits = *reinterpret_cast<const volatile uint16_t*>(p);
    return __uint_as_float(bits << 16);  // bf16 -> f32 is a shift
  }
  return static_cast<float>(*reinterpret_cast<const volatile int8_t*>(p));
}

// Orders the tap's reads of a slot (generic proxy) before the bulk copy
// that refills it (async proxy). `acc` is an operand so that the tapped
// values have arrived in their register before the fence executes.
__device__ __forceinline__ void fence_taps_before_refill(float acc) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::"f"(acc) : "memory");
}

// PLANES arrays of nchunks chunks of chunk_bytes each; a stage is
// stage_bytes of one array, a slot holds the same stage of every array.
template <int PLANES>
__global__ void __launch_bounds__(kStreamThreads)
stream_kernel(const unsigned char* __restrict__ x0, const unsigned char* __restrict__ x1,
              float* __restrict__ out, int elem, int64_t nchunks, int64_t chunk_bytes,
              int stage_bytes, int depth, int nsem, int64_t start, int rot) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[kMaxDepth * 2];
  if (threadIdx.x != 0) return;  // the copy engine does the work of the other lanes

  const int64_t grid = gridDim.x;
  const int64_t first = blockIdx.x;
  const int64_t stages_per_chunk = chunk_bytes / stage_bytes;
  const int64_t my_chunks = first < nchunks ? (nchunks - first + grid - 1) / grid : 0;
  const int64_t total = my_chunks * stages_per_chunk;
  const uint32_t ring_base = smem_addr(ring);
  const uint32_t bar_base = smem_addr(bars);
  const uint32_t slot_bytes = static_cast<uint32_t>(PLANES) * stage_bytes;

  for (int i = 0; i < depth * nsem; ++i) mbar_init(bar_base + 8 * i, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  auto start_copy = [&](int64_t i) {
    const uint32_t slot = static_cast<uint32_t>(i % depth);
    int64_t c = first + (i / stages_per_chunk) * grid;
    if (rot) c = (c + start) % nchunks;
    const int64_t off = c * chunk_bytes + (i % stages_per_chunk) * stage_bytes;
    const uint32_t dst = ring_base + slot * slot_bytes;
    const uint32_t bar = bar_base + 8 * slot * nsem;
    if (PLANES == 1) {
      mbar_expect_tx(bar, stage_bytes);
      bulk_load(dst, x0 + off, stage_bytes, bar);
    } else if (nsem == 1) {
      mbar_expect_tx(bar, 2 * stage_bytes);
      bulk_load(dst, x0 + off, stage_bytes, bar);
      bulk_load(dst + stage_bytes, x1 + off, stage_bytes, bar);
    } else {
      mbar_expect_tx(bar, stage_bytes);
      bulk_load(dst, x0 + off, stage_bytes, bar);
      mbar_expect_tx(bar + 8, stage_bytes);
      bulk_load(dst + stage_bytes, x1 + off, stage_bytes, bar + 8);
    }
  };

  for (int64_t i = 0; i < depth - 1 && i < total; ++i) start_copy(i);

  float acc = blockIdx.x == 0 ? static_cast<float>(start) : 0.f;
  for (int64_t i = 0; i < total; ++i) {
    // the slot of stage i + depth - 1 is the one stage i - 1 was tapped from
    if (i + depth - 1 < total) start_copy(i + depth - 1);
    const uint32_t slot = static_cast<uint32_t>(i % depth);
    const uint32_t parity = static_cast<uint32_t>((i / depth) & 1);
    const uint32_t bar = bar_base + 8 * slot * nsem;
    mbar_wait(bar, parity);
    if (PLANES == 2 && nsem == 2) mbar_wait(bar + 8, parity);
    if (i % stages_per_chunk == 0) {
      const unsigned char* landed = ring + static_cast<size_t>(slot) * slot_bytes;
      acc += tap(landed, elem);
      if (PLANES == 2) acc += tap(landed + stage_bytes, elem);
      fence_taps_before_refill(acc);  // the next start_copy may reuse this slot
    }
  }
  if (total > 0 || blockIdx.x == 0) atomicAdd(out, acc);
}

template <int PLANES>
cudaError_t launch_stream(const void* x0, const void* x1, void* out, int elem, int64_t nchunks,
                          int64_t chunk_bytes, int stage_bytes, int depth, int nsem,
                          int64_t start, int rot, int blocks, cudaStream_t stream) {
  if (depth < 1 || depth > kMaxDepth || nsem < 1 || nsem > 2 || (elem != 0 && elem != 1) ||
      stage_bytes < 16 || stage_bytes % 16 || chunk_bytes % stage_bytes || nchunks < 1 ||
      blocks < 1 || start < 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = static_cast<size_t>(depth) * PLANES * stage_bytes;
  cudaError_t err = cudaFuncSetAttribute(stream_kernel<PLANES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(out, 0, sizeof(float), stream);
  if (err != cudaSuccess) return err;
  stream_kernel<PLANES><<<blocks, kStreamThreads, smem, stream>>>(
      static_cast<const unsigned char*>(x0), static_cast<const unsigned char*>(x1),
      static_cast<float*>(out), elem, nchunks, chunk_bytes, stage_bytes, depth, nsem, start, rot);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Each function returns the CUDA error
// of its launch (0 on success).

// T5: o = 2 x + c over n f32 elements.
extern "C" int mt_scale_shift(const void* x, void* o, float c, int64_t n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t vec_blocks = (n / 4 + threads - 1) / threads;   // a block of 256 float4
  const int64_t cap = 8LL * sms;
  const int64_t blocks = vec_blocks < 1 ? 1 : (vec_blocks < cap ? vec_blocks : cap);
  scale_shift_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), c, n);
  return static_cast<int>(cudaGetLastError());
}

// T1: out (one f32) = sum over chunks of the chunk's first element.
// elem: 0 = bfloat16, 1 = int8.
extern "C" int mt_stream(const void* x, void* out, int elem, int64_t nchunks, int64_t chunk_bytes,
                         int stage_bytes, int depth, int blocks, void* stream) {
  return static_cast<int>(launch_stream<1>(x, nullptr, out, elem, nchunks, chunk_bytes,
                                           stage_bytes, depth, 1, 0, 0, blocks,
                                           static_cast<cudaStream_t>(stream)));
}

// T2: the same sum seeded with `start`; with rot the walk begins at chunk
// `start` (mod nchunks).
extern "C" int mt_stream_rot(const void* x, void* out, int elem, int64_t nchunks,
                             int64_t chunk_bytes, int stage_bytes, int depth, int64_t start,
                             int rot, int blocks, void* stream) {
  return static_cast<int>(launch_stream<1>(x, nullptr, out, elem, nchunks, chunk_bytes,
                                           stage_bytes, depth, 1, start, rot, blocks,
                                           static_cast<cudaStream_t>(stream)));
}

// T3: two arrays of the same shape streamed together; nsem barriers a slot.
extern "C" int mt_dual_stream(const void* x0, const void* x1, void* out, int elem,
                              int64_t nchunks, int64_t chunk_bytes, int stage_bytes, int depth,
                              int nsem, int blocks, void* stream) {
  return static_cast<int>(launch_stream<2>(x0, x1, out, elem, nchunks, chunk_bytes, stage_bytes,
                                           depth, nsem, 0, 0, blocks,
                                           static_cast<cudaStream_t>(stream)));
}

extern "C" const char* mt_probes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
