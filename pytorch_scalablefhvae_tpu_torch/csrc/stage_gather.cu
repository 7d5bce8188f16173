// Round sub-pack staging gather (sm_90a).
//
// Replaces no TPU kernel: the JAX loop materialises each hierarchical round's
// sub-pack on the host (pytorch_scalablefhvae_tpu/train/loop.py, its
// store.subset(keys, materialize=True)) and uploads it. Here the host store
// is page-locked and mapped into the device's address space once
// (sfhvae_host_register), and one launch reads a round's rows straight out of
// it into the staged buffer. For each run (src, dst, n) of a runs table:
//   out[dst + i, :] = store[src + i, :]   for 0 <= i < n,
// in float32 (the bits) or in bfloat16, rounded to nearest even (the bits of
// torch's float32 -> bfloat16 conversion; a NaN stays a NaN).
//
// What bounds it on the H100: the host link's bytes. A round of 5,000
// LibriSpeech-sized sequences (1,000-1,900 frames of 80 features) reads
// 2.32 GB of float32 rows across PCIe and writes them, or half the bytes in
// bfloat16, to HBM; there is no arithmetic, and HBM is some 50x faster than
// the link.
//
// What the design does about it: each row crosses the link once, and no host
// thread copies it (the path it replaces copied the sub-pack twice in host
// memory, then uploaded it from pageable memory). A run is contiguous on both
// sides, so a block copies one run as a flat range; the host cuts long runs
// into pieces of 64 rows, so that the blocks are many and even. Each thread
// issues kUnroll independent 16-byte loads before it stores any, so a block
// keeps kThreads * kUnroll * 16 = 16 KB of reads in flight and the resident
// blocks together far more than the link's bandwidth-delay product. A row
// whose floats 4 does not divide, or an address off 16 bytes, takes 4-byte
// loads. On an H100 the loads reach 24-27 GB/s, about half of what the copy
// engine moves from pinned memory (50-54 GB/s): loads with L2 prefetch hints
// or other cache operators, more loads in flight, persistent grids and bulk
// (TMA) copies into shared memory read no faster.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <int VEC>
struct Word;
template <>
struct Word<4> { using T = float4; };
template <>
struct Word<1> { using T = float; };

// torch's float32 -> bfloat16 rounding (c10 round_to_nearest_even)
__device__ __forceinline__ unsigned bf16_bits(float f) {
  const unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ void put(float* out, long long at, float4 v) {
  *reinterpret_cast<float4*>(out + at) = v;
}
__device__ __forceinline__ void put(float* out, long long at, float v) {
  out[at] = v;
}
__device__ __forceinline__ void put(uint16_t* out, long long at, float4 v) {
  uint2 w;
  w.x = bf16_bits(v.x) | (bf16_bits(v.y) << 16);
  w.y = bf16_bits(v.z) | (bf16_bits(v.w) << 16);
  *reinterpret_cast<uint2*>(out + at) = w;
}
__device__ __forceinline__ void put(uint16_t* out, long long at, float v) {
  out[at] = static_cast<uint16_t>(bf16_bits(v));
}

// one block a run; VEC floats a load (the run's first float and the store's
// address VEC-aligned, as the row width and the addresses make them)
template <typename Out, int VEC>
__global__ void __launch_bounds__(kThreads) stage_gather_kernel(
    const float* __restrict__ store,      // [rows, dim], mapped host memory
    const long long* __restrict__ runs,   // [n_runs, 3]: src, dst, n
    Out* __restrict__ out,                // [buf_rows, dim]
    int dim) {
  using W = typename Word<VEC>::T;
  const long long* run = runs + 3 * static_cast<long long>(blockIdx.x);
  const long long src = run[0] * dim, dst = run[1] * dim;
  const long long words = run[2] * dim / VEC;
  const W* in = reinterpret_cast<const W*>(store + src);
  for (long long base = threadIdx.x; base < words;
       base += kThreads * kUnroll) {
    W v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < words) v[u] = in[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < words) put(out, dst + i * VEC, v[u]);
    }
  }
}

template <typename Out, int VEC>
int launch(const float* store, const long long* runs, int n_runs, void* out,
           int dim, cudaStream_t st) {
  stage_gather_kernel<Out, VEC><<<n_runs, kThreads, 0, st>>>(
      store, runs, static_cast<Out*>(out), dim);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Page-lock the host range [ptr, ptr + bytes) and map it into the device's
// address space (read-only where the pages are: a memory-mapped store opened
// for reading); its device address in *dev_ptr. Returns the cudaError_t of
// the registration, and leaves no error pending after a failure.
int sfhvae_host_register(void* ptr, long long bytes, int read_only,
                         void** dev_ptr) {
  unsigned flags = cudaHostRegisterMapped | cudaHostRegisterPortable;
  if (read_only) flags |= cudaHostRegisterReadOnly;
  cudaError_t e = cudaHostRegister(ptr, static_cast<size_t>(bytes), flags);
  if (e == cudaSuccess) {
    e = cudaHostGetDevicePointer(dev_ptr, ptr, 0);
    if (e != cudaSuccess) cudaHostUnregister(ptr);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

int sfhvae_host_unregister(void* ptr) {
  const cudaError_t e = cudaHostUnregister(ptr);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// store: [rows, dim] float32 at a device address (mapped host memory); runs:
// [n_runs, 3] int64 on the device, each inside the store and the output;
// out: [buf_rows, dim], float32 (out_bf16 0) or bfloat16 (1). vec: floats a
// load, 4 (dim a multiple of 4, the store 16-byte and the output 4 * element
// size aligned) or 1. Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue for another vec.
int sfhvae_stage_gather(const void* store, const void* runs, int n_runs,
                        void* out, int dim, int out_bf16, int vec,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(store);
  const long long* r = static_cast<const long long*>(runs);
  if (n_runs <= 0) return cudaSuccess;
  switch (vec * 2 + (out_bf16 ? 1 : 0)) {
    case 8: return launch<float, 4>(s, r, n_runs, out, dim, st);
    case 9: return launch<uint16_t, 4>(s, r, n_runs, out, dim, st);
    case 2: return launch<float, 1>(s, r, n_runs, out, dim, st);
    case 3: return launch<uint16_t, 1>(s, r, n_runs, out, dim, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
