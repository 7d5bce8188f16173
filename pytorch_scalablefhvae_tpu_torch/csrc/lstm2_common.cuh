// Pieces shared by the two-layer LSTM forward (lstm2_fwd.cu, lstm2_fwd_fma.cu)
// and backward (lstm2_bwd.cu, lstm2_bwd_fma.cu) kernels: the FMA kernels'
// block layout, operand rounding and per-thread product with a weight block,
// and the cell and its adjoint.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace lstm2 {

constexpr int kBT = 8;             // batch rows per block
constexpr int kRPT = 4;            // batch rows per thread
constexpr int kNRG = kBT / kRPT;   // row groups: blockDim.x = kNRG * H

template <typename W>
__device__ __forceinline__ float load_w(const W* p) {
  if constexpr (std::is_same<W, __nv_bfloat16>::value) {
    return __bfloat162float(*p);
  } else {
    return *p;
  }
}

// The value a matmul operand takes: rounded to bf16 in bf16 mode.
template <typename W>
__device__ __forceinline__ float operand(float v) {
  if constexpr (std::is_same<W, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// acc[g][r] += sum_k a[r][k] * w[k][g*H + u] for the thread's RPT rows.
template <typename W>
__device__ __forceinline__ void accumulate(float (&acc)[4][kRPT],
                                           const float* a, int lda,
                                           const W* __restrict__ w, int K,
                                           int H, int u) {
  const long long H4 = 4LL * H;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const W* wk = w + k * H4 + u;
    const float w0 = load_w(wk);
    const float w1 = load_w(wk + H);
    const float w2 = load_w(wk + 2 * H);
    const float w3 = load_w(wk + 3 * H);
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const float av = a[r * lda + k];
      acc[0][r] = fmaf(av, w0, acc[0][r]);
      acc[1][r] = fmaf(av, w1, acc[1][r]);
      acc[2][r] = fmaf(av, w2, acc[2][r]);
      acc[3][r] = fmaf(av, w3, acc[3][r]);
    }
  }
}

// Gate order i, f, g, o (models/fhvae.py _cell). Updates c in place and
// returns the new h.
__device__ __forceinline__ float cell(float gi, float gf, float gg, float go,
                                      float* c) {
  const float c_new = sigmoidf_(gf) * (*c) + sigmoidf_(gi) * tanhf(gg);
  *c = c_new;
  return sigmoidf_(go) * tanhf(c_new);
}

// Adjoint of the cell (_cell_bwd). Writes d{i,f,g,o} and updates dc in place
// from the carried dc to dc_prev.
__device__ __forceinline__ void cell_bwd(float gi, float gf, float gg,
                                         float go, float c_prev, float c_new,
                                         float dh, float* dc, float (&d)[4]) {
  const float i = sigmoidf_(gi);
  const float f = sigmoidf_(gf);
  const float g = tanhf(gg);
  const float o = sigmoidf_(go);
  const float tc = tanhf(c_new);
  d[3] = dh * tc * o * (1.0f - o);
  const float dc_tot = *dc + dh * o * (1.0f - tc * tc);
  d[0] = dc_tot * g * i * (1.0f - i);
  d[1] = dc_tot * c_prev * f * (1.0f - f);
  d[2] = dc_tot * i * (1.0f - g * g);
  *dc = dc_tot * f;
}

// Dynamic shared memory above the default 48 KiB needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace lstm2
