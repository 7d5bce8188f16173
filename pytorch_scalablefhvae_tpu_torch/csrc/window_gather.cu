// Chunked windowed-segment gather (sm_90a).
//
// Replaces the TPU kernel pytorch_scalablefhvae_tpu/ops/window_gather_pallas.py:
// windowed_chunk_gather (kernel body _kernel). For C chunk starts into a
// row-major [N, D] store of any element size (float32, or bfloat16 for a
// store staged at half the bytes) it writes [C * spb, seg_len, D]:
//   out[c * spb + w, t, :] = store[chunk_starts[c] + w * stride + t, :]
// and rows outside [0, N) read as zero. The spb windows of a chunk lie in one
// contiguous region of (spb - 1) * stride + seg_len store rows, which is what
// the dev MAP pass walks (consecutive windows of one sequence).
//
// What bounds it on the H100: bytes. On the dev MAP path (spb 16, seg_len 20,
// stride 8, D 80) a float32 chunk reads a 140-row region (44,800 B) and
// writes 16 windows (102,400 B): there is no arithmetic, so the HBM rate on
// ~147 KB a chunk is the bound; 128 chunks (one dev batch of 2048 windows)
// move 18.8 MB, and half that in bfloat16.
//
// What the design does about it: one block per chunk. The kernel moves rows
// as bytes, so every element size takes the same path. The block copies its
// region into dynamic shared memory once with cp.async, so each store row is
// read from HBM once however many windows overlap it. The copy width is the
// widest that divides a row and the alignment of the store and the output:
// 16 bytes (D * 4 a multiple of 16 in float32; D * 2 in bfloat16, as at D 80
// where a bf16 row is 160 bytes), else 4 bytes (the wrapper refuses a row or
// an address that 4 does not divide). After a barrier it writes the windows
// with the same width, consecutive threads on consecutive addresses: each
// window is contiguous in shared memory and in the output. The TPU kernel's
// 128-lane padding of the feature dim is not needed here and is not carried
// over; the TPU kernel's double buffering across its sequential grid is
// replaced by the many blocks the card keeps in flight.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int VEC>
struct Word;
template <>
struct Word<16> { using T = int4; };
template <>
struct Word<4> { using T = int; };

template <int VEC>
__device__ __forceinline__ void copy_in(char* smem, const char* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr),
                 "l"(gmem));
  }
}

// VEC bytes per copy: VEC divides the row's bytes, and the store and the
// output are VEC-byte aligned, so that a copy never crosses a row and every
// address is aligned.
template <int VEC>
__global__ void __launch_bounds__(kThreads) window_gather_kernel(
    const char* __restrict__ store,         // [n_rows, row_bytes]
    const int* __restrict__ chunk_starts,   // [C]
    char* __restrict__ out,                 // [C * spb, seg_len, row_bytes]
    long long n_rows, int row_bytes, int spb, int seg_len, int stride,
    int reg_rows) {
  using W = typename Word<VEC>::T;
  extern __shared__ __align__(16) char region[];  // [reg_rows, row_bytes]
  const long long start = chunk_starts[blockIdx.x];
  const int n = reg_rows * row_bytes;

  for (int i = threadIdx.x * VEC; i < n; i += kThreads * VEC) {
    const long long row = start + i / row_bytes;
    if (row >= 0 && row < n_rows) {
      copy_in<VEC>(region + i, store + row * row_bytes + (i % row_bytes));
    } else {
      *reinterpret_cast<W*>(region + i) = W{};
    }
  }
  asm volatile("cp.async.commit_group;\n");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int win = seg_len * row_bytes;  // bytes per window
  const int total = spb * win;          // bytes per chunk of output
  char* dst = out + static_cast<long long>(blockIdx.x) * total;
  for (int i = threadIdx.x * VEC; i < total; i += kThreads * VEC) {
    const int w = i / win;
    const int src = w * stride * row_bytes + (i - w * win);
    *reinterpret_cast<W*>(dst + i) = *reinterpret_cast<const W*>(region + src);
  }
}

template <int VEC>
int launch(const char* store, const int* starts, char* out, long long n_rows,
           int row_bytes, int C, int spb, int seg_len, int stride,
           cudaStream_t st) {
  const int reg_rows = (spb - 1) * stride + seg_len;
  const size_t smem = static_cast<size_t>(reg_rows) * row_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_gather_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  window_gather_kernel<VEC><<<C, kThreads, smem, st>>>(
      store, starts, out, n_rows, row_bytes, spb, seg_len, stride, reg_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest region (bytes of dynamic shared memory) a block may take.
int sfhvae_window_gather_max_smem() { return 232448; }

// store: [n_rows, row_bytes / element size] of any element size;
// chunk_starts: [C] int32; out: [C * spb, seg_len, the same row]. vec: the
// bytes of one copy, 16 or 4 (row_bytes a multiple of it, store and out
// aligned to it). Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue for another vec.
int sfhvae_window_gather(const void* store, const void* chunk_starts,
                         void* out, long long n_rows, int row_bytes, int C,
                         int spb, int seg_len, int stride, int vec,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const char* s = static_cast<const char*>(store);
  const int* cs = static_cast<const int*>(chunk_starts);
  char* o = static_cast<char*>(out);
  switch (vec) {
    case 16:
      return launch<16>(s, cs, o, n_rows, row_bytes, C, spb, seg_len, stride,
                        st);
    case 4:
      return launch<4>(s, cs, o, n_rows, row_bytes, C, spb, seg_len, stride,
                       st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
