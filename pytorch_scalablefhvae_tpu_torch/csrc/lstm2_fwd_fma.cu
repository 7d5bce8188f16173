// Two-layer LSTM forward recurrence for the FHVAE stacks, the FMA form: fp32
// operands at any width, and bf16 operands at every width the tensor-core
// form (lstm2_fwd.cu) does not take (sm_90a).
//
// Replaces two TPU kernels of pytorch_scalablefhvae_tpu/ops/lstm_pallas.py:
//   - _fwd_kernel_p / _fwd_call_p (entry lstm2_pallas_tm_proj): the layer-1
//     x-projection runs in the kernel, plus an additive gate block xgc that is
//     one row per batch row (z1 encoder) or one broadcast row (z2 encoder);
//   - _fwd_kernel / _fwd_call (entry lstm2_pallas_tm): precomputed layer-1
//     gates with a time stride; stride 0 is the decoder's const mode.
// For training it also writes what the backward kernels read: resid
// [T, B, 3H] = h1 | c1 | c2 per step, fp32 and unrounded (the TPU kernel's
// _fwd_tail residual stream), beside tops.
//
// What bounds it on the H100: every step is a chain of dependent
// [BT, K] x [K, 4H] products (K = D + H for layer 1, 2H for layer 2) done as
// fp32 multiply-adds on the CUDA cores, with every weight element read from
// L2 at every step and used for RPT = 4 multiply-adds: L2 bandwidth and the
// step-to-step latency, not arithmetic. fp32 operands must stay true fp32
// (TF32 on the tensor cores keeps three digits; the entries are held to
// 1e-4), so this form keeps the CUDA cores.
//
// What the design does about it: one block owns BT = 8 batch rows for all T
// steps (the loop over t takes the place of the TPU grid's sequential time
// axis), and h1, c1, h2, c2 of its tile stay in shared memory. Each thread
// owns one hidden unit u for RPT = 4 rows and accumulates all four gates of
// u, so the cell update needs no exchange between threads; neighbouring
// threads read neighbouring weight columns. B = 2048 gives 256 blocks.
//
// bf16 operand mode: the weights arrive as bf16 and h (and x) are rounded to
// bf16 before each product, with fp32 products, sums, gates and carries,
// the rounding of the Pallas kernel's _make_ref_dot. The carries kept in
// shared memory for h are those rounded operands; tops, h2 and resid are
// written from the unrounded fp32 values.

#include "lstm2_common.cuh"

namespace {

using namespace lstm2;

// kResid: also write the residual stream (training); the serving
// instantiation has no residual code at all.
template <typename W, bool kResid>
__global__ void lstm2_fwd_fma_kernel(
    const float* __restrict__ x,     // [T, B, D] or null (precomputed gates)
    const float* __restrict__ xadd,  // additive layer-1 gates
    long long xadd_t_stride, long long xadd_row_stride,
    const W* __restrict__ w1x,       // [D, 4H] (unused without x)
    const W* __restrict__ w1h,       // [H, 4H]
    const W* __restrict__ w2x,       // [H, 4H]
    const W* __restrict__ w2h,       // [H, 4H]
    const float* __restrict__ b2,    // [4H]
    float* __restrict__ tops,        // [T, B, H] or null
    float* __restrict__ h2_out,      // [B, H]
    float* __restrict__ resid,       // [T, B, 3H] or null
    int T, int B, int D, int H) {
  extern __shared__ float smem[];
  float* h1 = smem;              // [BT][H], operand form
  float* h2 = h1 + kBT * H;      // [BT][H], operand form
  float* c1 = h2 + kBT * H;      // [BT][H]
  float* c2 = c1 + kBT * H;      // [BT][H]
  float* xs = c2 + kBT * H;      // [BT][D], operand form

  const int u = threadIdx.x % H;
  const int r0 = (threadIdx.x / H) * kRPT;
  const int row0 = blockIdx.x * kBT;
  const long long H3 = 3LL * H;

  for (int i = threadIdx.x; i < 4 * kBT * H; i += blockDim.x) smem[i] = 0.0f;

  for (int t = 0; t < T; ++t) {
    if (x != nullptr) {
      for (int i = threadIdx.x; i < kBT * D; i += blockDim.x) {
        const int r = i / D;
        const int row = row0 + r;
        const float v =
            row < B ? x[((long long)t * B + row) * D + (i - r * D)] : 0.0f;
        xs[i] = operand<W>(v);
      }
    }
    __syncthreads();

    // ---- layer 1: g1 = xadd + x @ w1x + h1 @ w1h
    float acc[4][kRPT];
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int row = row0 + r0 + r;
      const float* xa =
          xadd + t * xadd_t_stride + (long long)row * xadd_row_stride + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g][r] = row < B ? xa[g * H] : 0.0f;
    }
    if (x != nullptr) accumulate<W>(acc, xs + r0 * D, D, w1x, D, H, u);
    accumulate<W>(acc, h1 + r0 * H, H, w1h, H, H, u);
    __syncthreads();  // every thread has read the old h1
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int s = (r0 + r) * H + u;
      const float h = cell(acc[0][r], acc[1][r], acc[2][r], acc[3][r], &c1[s]);
      h1[s] = operand<W>(h);
      const int row = row0 + r0 + r;
      if (kResid && row < B) {
        float* rs = resid + ((long long)t * B + row) * H3 + u;
        rs[0] = h;
        rs[H] = c1[s];
      }
    }
    __syncthreads();

    // ---- layer 2: g2 = b2 + h1 @ w2x + h2 @ w2h
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g][r] = b2[g * H + u];
    }
    accumulate<W>(acc, h1 + r0 * H, H, w2x, H, H, u);
    accumulate<W>(acc, h2 + r0 * H, H, w2h, H, H, u);
    __syncthreads();  // every thread has read the old h2
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int s = (r0 + r) * H + u;
      const float h = cell(acc[0][r], acc[1][r], acc[2][r], acc[3][r], &c2[s]);
      h2[s] = operand<W>(h);
      const int row = row0 + r0 + r;
      if (row < B) {
        const long long o = (long long)t * B + row;
        if (tops != nullptr) tops[o * H + u] = h;
        if (kResid) resid[o * H3 + 2 * H + u] = c2[s];
        if (t == T - 1) h2_out[(long long)row * H + u] = h;
      }
    }
    // the next step's first __syncthreads orders these writes before any
    // read of h2, and every read of xs happened before the syncs above
  }
}

template <typename W, bool kResid>
cudaError_t launch(const void* x, const void* xadd, long long xadd_t_stride,
                   long long xadd_row_stride, const void* w1x, const void* w1h,
                   const void* w2x, const void* w2h, const void* b2,
                   void* tops, void* h2_out, void* resid, int T, int B, int D,
                   int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * kBT * H + kBT * D);
  cudaError_t e = allow_smem(lstm2_fwd_fma_kernel<W, kResid>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((B + kBT - 1) / kBT);
  const dim3 block(kNRG * H);
  lstm2_fwd_fma_kernel<W, kResid><<<grid, block, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(xadd),
      xadd_t_stride, xadd_row_stride, static_cast<const W*>(w1x),
      static_cast<const W*>(w1h), static_cast<const W*>(w2x),
      static_cast<const W*>(w2h), static_cast<const float*>(b2),
      static_cast<float*>(tops), static_cast<float*>(h2_out),
      static_cast<float*>(resid), T, B, D, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Threads per block the kernels use for hidden width H (the wrapper checks it
// against the 1024-thread limit).
int sfhvae_lstm2_threads(int H) { return kNRG * H; }

// x: [T, B, D] fp32 or null; xadd: fp32 gates read at
// xadd[t * xadd_t_stride + row * xadd_row_stride + col]; weights fp32
// (bf16 == 0) or bf16 (bf16 != 0); b2 fp32; tops: [T, B, H] fp32 or null;
// h2_out: [B, H] fp32; resid: [T, B, 3H] fp32 or null. Returns the
// cudaError_t of the launch.
int sfhvae_lstm2_fwd_fma(const void* x, const void* xadd,
                         long long xadd_t_stride, long long xadd_row_stride,
                         const void* w1x, const void* w1h, const void* w2x,
                         const void* w2h, const void* b2, void* tops,
                         void* h2_out, void* resid, int T, int B, int D,
                         int H, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto launcher) {
    return launcher(x, xadd, xadd_t_stride, xadd_row_stride, w1x, w1h, w2x,
                    w2h, b2, tops, h2_out, resid, T, B, D, H, s);
  };
  if (bf16) {
    return resid ? run(launch<__nv_bfloat16, true>)
                 : run(launch<__nv_bfloat16, false>);
  }
  return resid ? run(launch<float, true>) : run(launch<float, false>);
}

const char* sfhvae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
