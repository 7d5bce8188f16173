// Chunked windowed-segment gather (sm_90a).
//
// Replaces the TPU kernel pytorch_scalablefhvae_tpu/ops/window_gather_pallas.py:
// windowed_chunk_gather (kernel body _kernel). For C chunk starts into a
// row-major [N, D] float32 store it writes [C * spb, seg_len, D]:
//   out[c * spb + w, t, :] = store[chunk_starts[c] + w * stride + t, :]
// and rows outside [0, N) read as zero. The spb windows of a chunk lie in one
// contiguous region of (spb - 1) * stride + seg_len store rows, which is what
// the dev MAP pass walks (consecutive windows of one sequence).
//
// What bounds it on the H100: bytes. On the dev MAP path (spb 16, seg_len 20,
// stride 8, D 80) a chunk reads a 140-row region (44,800 B) and writes
// 16 windows (102,400 B): there is no arithmetic, so the HBM rate on ~147 KB a
// chunk is the bound; 128 chunks (one dev batch of 2048 windows) move 18.8 MB.
//
// What the design does about it: one block per chunk. The block copies its
// region into dynamic shared memory once with cp.async (16-byte copies when
// D * 4 is a multiple of 16 and the store is 16-byte aligned, 4-byte copies
// otherwise), so each store row is read from HBM once however many windows
// overlap it. After a barrier it writes the windows with the same vector
// width, consecutive threads on consecutive addresses: each window is
// contiguous in shared memory and in the output. The TPU kernel's 128-lane
// padding of the feature dim is not needed here and is not carried over; the
// TPU kernel's double buffering across its sequential grid is replaced by the
// many blocks the card keeps in flight.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int VEC>
__device__ __forceinline__ void copy_async(float* smem, const float* gmem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
                 "l"(gmem));
  }
}

// VEC floats per copy: 4 needs D % 4 == 0 and a 16-byte aligned store and
// output, so that a vector never crosses a row and every address is aligned.
template <int VEC>
__global__ void __launch_bounds__(kThreads) window_gather_kernel(
    const float* __restrict__ store,        // [n_rows, D]
    const int* __restrict__ chunk_starts,   // [C]
    float* __restrict__ out,                // [C * spb, seg_len, D]
    long long n_rows, int D, int spb, int seg_len, int stride, int reg_rows) {
  extern __shared__ __align__(16) float region[];  // [reg_rows, D]
  const long long start = chunk_starts[blockIdx.x];
  const int n = reg_rows * D;

  for (int i = threadIdx.x * VEC; i < n; i += kThreads * VEC) {
    const long long row = start + i / D;
    if (row >= 0 && row < n_rows) {
      copy_async<VEC>(region + i, store + row * D + (i % D));
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) region[i + v] = 0.0f;
    }
  }
  asm volatile("cp.async.commit_group;\n");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int win = seg_len * D;         // floats per window
  const int total = spb * win;         // floats per chunk of output
  float* dst = out + static_cast<long long>(blockIdx.x) * total;
  for (int i = threadIdx.x * VEC; i < total; i += kThreads * VEC) {
    const int w = i / win;
    const int src = w * stride * D + (i - w * win);
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(dst + i) =
          *reinterpret_cast<const float4*>(region + src);
    } else {
      dst[i] = region[src];
    }
  }
}

template <int VEC>
int launch(const float* store, const int* starts, float* out, long long n_rows,
           int D, int C, int spb, int seg_len, int stride, cudaStream_t st) {
  const int reg_rows = (spb - 1) * stride + seg_len;
  const size_t smem = static_cast<size_t>(reg_rows) * D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_gather_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  window_gather_kernel<VEC><<<C, kThreads, smem, st>>>(
      store, starts, out, n_rows, D, spb, seg_len, stride, reg_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest region (bytes of dynamic shared memory) a block may take.
int sfhvae_window_gather_max_smem() { return 232448; }

// store: [n_rows, D] fp32; chunk_starts: [C] int32; out: [C * spb, seg_len, D]
// fp32. vec: 4 (16-byte copies; D % 4 == 0, store and out 16-byte aligned)
// or 1. Returns the cudaError_t of the launch.
int sfhvae_window_gather(const void* store, const void* chunk_starts,
                         void* out, long long n_rows, int D, int C, int spb,
                         int seg_len, int stride, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(store);
  const int* cs = static_cast<const int*>(chunk_starts);
  float* o = static_cast<float*>(out);
  if (vec == 4) {
    return launch<4>(s, cs, o, n_rows, D, C, spb, seg_len, stride, st);
  }
  return launch<1>(s, cs, o, n_rows, D, C, spb, seg_len, stride, st);
}

}  // extern "C"
