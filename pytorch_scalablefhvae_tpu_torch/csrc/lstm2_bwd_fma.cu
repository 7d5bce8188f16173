// Two-layer LSTM backward, the FMA form: fp32 operands and the widths the
// tensor-core form (lstm2_bwd.cu) does not take (sm_90a).
//
// Computes what lstm2_bwd.cu computes (the VJPs _bwd_call_p and _bwd_call of
// pytorch_scalablefhvae_tpu/ops/lstm_pallas.py) with scalar fp32 multiply-adds,
// so that fp32 operands stay true fp32 (the tensor cores would round them to
// TF32) and any hidden width up to the block size is taken. The wrapper
// (ops/lstm_cuda.py, backward_form) picks the form from the operand type and
// the widths alone.
//
// What bounds it on the H100: fp32 multiply-adds outside the tensor cores,
// the weights re-read from L2 in every step (a block owns 8 batch rows), and
// the latency of a step's dependent products, the gate recompute among them.
//
// The design: the work is split in two.
//   1. The recurrent kernel: one block owns BT = 8 batch rows for all T steps
//      in reverse, with the forward's thread layout (a thread owns hidden
//      unit u for RPT = 4 rows). Per step it recomputes both layers' gates
//      from the residuals (the t-1 views are zero at t = 0), applies the cell
//      adjoint (_cell_bwd), and writes dgates1 and dgates2 of the step to
//      global memory. The carries dh and dc of unit u stay in the thread's
//      registers; only the dgates rows (needed whole by every thread for the
//      adjoint products) and the staged operands pass through shared memory.
//      The adjoint products read transposed weight copies [4H, H] so that
//      neighbouring threads read neighbouring addresses.
//   2. The reductions, each a hand-written kernel over the T*B rows of the
//      saved streams: dW = sum_rows A^T dG for each weight block (a tiled
//      product per chunk of rows into a partial buffer, then a combine that
//      adds the chunks in a fixed order), db2 and dxgc / dxg1 as sums over t
//      and over rows, and dx = dG1 W1x^T as a tiled product.
// No floating-point atomics anywhere: every sum runs in a fixed order, so two
// launches on the same inputs give the same bits.
//
// bf16 operand mode (taken here only at widths the tensor-core form refuses)
// follows _make_bwd_fns: every product rounds both of its operands (dgates,
// weights, h, x) to bf16 and accumulates in fp32; the gate recompute rounds
// as the forward does; db2, dxgc and dxg1 sum the unrounded fp32 dgates; the
// carries stay fp32.

#include "lstm2_common.cuh"

namespace {

using namespace lstm2;

// out[r] = sum_j a[r][j] * wT[j][u] over j < 4H, for the thread's RPT rows.
template <typename W>
__device__ __forceinline__ void adjoint(float (&out)[kRPT], const float* a,
                                        const W* __restrict__ wT, int H,
                                        int u) {
  const int H4 = 4 * H;
#pragma unroll
  for (int r = 0; r < kRPT; ++r) out[r] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < H4; ++j) {
    const float w = load_w(wT + (long long)j * H + u);
#pragma unroll
    for (int r = 0; r < kRPT; ++r) out[r] = fmaf(a[r * H4 + j], w, out[r]);
  }
}

template <typename W>
__global__ void lstm2_bwd_recurrent_kernel(
    const float* __restrict__ x,      // [T, B, D] or null (precomputed gates)
    const float* __restrict__ xadd,   // additive layer-1 gates (as forward)
    long long xadd_t_stride, long long xadd_row_stride,
    const float* __restrict__ resid,  // [T, B, 3H]: h1 | c1 | c2
    const float* __restrict__ tops,   // [T, B, H]
    const float* __restrict__ gtops,  // [T, B, H] or null (zero)
    const float* __restrict__ gh2,    // [B, H] or null (zero)
    const W* __restrict__ w1x,        // [D, 4H]
    const W* __restrict__ w1h,        // [H, 4H]
    const W* __restrict__ w2x,        // [H, 4H]
    const W* __restrict__ w2h,        // [H, 4H]
    const W* __restrict__ w1hT,       // [4H, H]
    const W* __restrict__ w2xT,       // [4H, H]
    const W* __restrict__ w2hT,       // [4H, H]
    const float* __restrict__ b2,     // [4H]
    float* __restrict__ dg1_out,      // [T, B, 4H]
    float* __restrict__ dg2_out,      // [T, B, 4H]
    int T, int B, int D, int H) {
  extern __shared__ float smem[];
  const int H4 = 4 * H;
  float* h1t = smem;               // [BT][H] h1 at t, operand form
  float* h1p = h1t + kBT * H;      // [BT][H] h1 at t-1
  float* h2p = h1p + kBT * H;      // [BT][H] h2 at t-1
  float* xs = h2p + kBT * H;       // [BT][D] x at t
  float* dg2s = xs + kBT * D;      // [BT][4H] dgates2, operand form
  float* dg1s = dg2s + kBT * H4;   // [BT][4H] dgates1, operand form

  const int u = threadIdx.x % H;
  const int r0 = (threadIdx.x / H) * kRPT;
  const int row0 = blockIdx.x * kBT;
  const long long H3 = 3LL * H;

  float dh1[kRPT], dh2[kRPT], dc1[kRPT], dc2[kRPT];
#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    const int row = row0 + r0 + r;
    dh1[r] = dc1[r] = dc2[r] = 0.0f;
    dh2[r] = (gh2 != nullptr && row < B) ? gh2[(long long)row * H + u] : 0.0f;
  }

  for (int t = T - 1; t >= 0; --t) {
    // ---- stage the step's operands (t-1 views are zero at t = 0)
    for (int i = threadIdx.x; i < kBT * H; i += blockDim.x) {
      const int r = i / H;
      const int k = i - r * H;
      const int row = row0 + r;
      const bool ok = row < B;
      const long long o = (long long)t * B + row;
      h1t[i] = ok ? operand<W>(resid[o * H3 + k]) : 0.0f;
      h1p[i] = (ok && t > 0) ? operand<W>(resid[(o - B) * H3 + k]) : 0.0f;
      h2p[i] = (ok && t > 0) ? operand<W>(tops[(o - B) * H + k]) : 0.0f;
    }
    if (x != nullptr) {
      for (int i = threadIdx.x; i < kBT * D; i += blockDim.x) {
        const int r = i / D;
        const int row = row0 + r;
        xs[i] = row < B
                    ? operand<W>(x[((long long)t * B + row) * D + (i - r * D)])
                    : 0.0f;
      }
    }
    __syncthreads();

    // ---- recompute the gates of both layers, as the forward formed them
    float a2[4][kRPT], a1[4][kRPT];
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int row = row0 + r0 + r;
      const float* xa =
          xadd + t * xadd_t_stride + (long long)row * xadd_row_stride + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        a2[g][r] = b2[g * H + u];
        a1[g][r] = row < B ? xa[g * H] : 0.0f;
      }
    }
    accumulate<W>(a2, h1t + r0 * H, H, w2x, H, H, u);
    accumulate<W>(a2, h2p + r0 * H, H, w2h, H, H, u);
    if (x != nullptr) accumulate<W>(a1, xs + r0 * D, D, w1x, D, H, u);
    accumulate<W>(a1, h1p + r0 * H, H, w1h, H, H, u);

    // ---- layer-2 adjoint
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int row = row0 + r0 + r;
      const bool ok = row < B;
      const long long o = (long long)t * B + row;
      const float c_new = ok ? resid[o * H3 + 2 * H + u] : 0.0f;
      const float c_prev =
          (ok && t > 0) ? resid[(o - B) * H3 + 2 * H + u] : 0.0f;
      const float dh =
          dh2[r] + ((gtops != nullptr && ok) ? gtops[o * H + u] : 0.0f);
      float d[4];
      cell_bwd(a2[0][r], a2[1][r], a2[2][r], a2[3][r], c_prev, c_new, dh,
               &dc2[r], d);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dg2s[(r0 + r) * H4 + g * H + u] = operand<W>(d[g]);
        if (ok) dg2_out[o * H4 + g * H + u] = d[g];
      }
    }
    __syncthreads();  // dgates2 of every unit is in shared memory

    // dh2 <- dgates2 W2h^T;  dh1_tot = dh1 + dgates2 W2x^T
    float n1[kRPT];
    adjoint<W>(dh2, dg2s + r0 * H4, w2hT, H, u);
    adjoint<W>(n1, dg2s + r0 * H4, w2xT, H, u);

    // ---- layer-1 adjoint
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int row = row0 + r0 + r;
      const bool ok = row < B;
      const long long o = (long long)t * B + row;
      const float c_new = ok ? resid[o * H3 + H + u] : 0.0f;
      const float c_prev = (ok && t > 0) ? resid[(o - B) * H3 + H + u] : 0.0f;
      float d[4];
      cell_bwd(a1[0][r], a1[1][r], a1[2][r], a1[3][r], c_prev, c_new,
               dh1[r] + n1[r], &dc1[r], d);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dg1s[(r0 + r) * H4 + g * H + u] = operand<W>(d[g]);
        if (ok) dg1_out[o * H4 + g * H + u] = d[g];
      }
    }
    __syncthreads();  // dgates1 of every unit is in shared memory

    // dh1 <- dgates1 W1h^T
    adjoint<W>(dh1, dg1s + r0 * H4, w1hT, H, u);
    // The next step's staging writes only buffers last read before the
    // syncs above, and it writes dg2s / dg1s only after its own first sync,
    // which every thread reaches after finishing this step's reads.
  }
}

// ------------------------------------------------------------- reductions

constexpr int kTile = 64;     // output tile edge of the tiled products
constexpr int kDepth = 16;    // contraction depth staged per pass
constexpr int kChunk = 512;   // rows per partial of the A^T G reduction

template <bool kRound>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (kRound) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// part[c][i][j] = sum over rows r of chunk c of A[r][i] * G[r][j]
// (i < K, j < N). 256 threads; each owns a 4 x 4 set of outputs strided by
// 16 so that a warp's shared-memory reads hit distinct banks or broadcast.
template <bool kRound>
__global__ void tn_partial_kernel(const float* __restrict__ A, long long lda,
                                  const float* __restrict__ G, long long ldg,
                                  float* __restrict__ part, int R, int K,
                                  int N) {
  __shared__ float As[kDepth][kTile];
  __shared__ float Gs[kDepth][kTile];
  const int i0 = blockIdx.x * kTile;
  const int j0 = blockIdx.y * kTile;
  const int r_begin = blockIdx.z * kChunk;
  const int r_end = min(R, r_begin + kChunk);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.0f;
  }
  for (int rb = r_begin; rb < r_end; rb += kDepth) {
    for (int e = threadIdx.x; e < kDepth * kTile; e += blockDim.x) {
      const int rr = e / kTile;
      const int cc = e - rr * kTile;
      const long long r = rb + rr;
      const bool rok = r < r_end;
      As[rr][cc] = (rok && i0 + cc < K) ? rnd<kRound>(A[r * lda + i0 + cc])
                                        : 0.0f;
      Gs[rr][cc] = (rok && j0 + cc < N) ? rnd<kRound>(G[r * ldg + j0 + cc])
                                        : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kDepth; ++rr) {
      float a[4], g[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = As[rr][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < 4; ++n) g[n] = Gs[rr][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], g[n], acc[m][n]);
      }
    }
    __syncthreads();
  }
  float* out = part + (long long)blockIdx.z * K * N;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty + 16 * m;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = j0 + tx + 16 * n;
      if (i < K && j < N) out[(long long)i * N + j] = acc[m][n];
    }
  }
}

// out[e] = sum_c part[c][e], chunks in order.
__global__ void combine_kernel(const float* __restrict__ part,
                               float* __restrict__ out, long long n, int C) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int c = 0; c < C; ++c) s += part[(long long)c * n + e];
  out[e] = s;
}

// out[b][j] = sum_t G[t][b][j], t in order.
__global__ void sum_t_kernel(const float* __restrict__ G,
                             float* __restrict__ out, int T, long long BN) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= BN) return;
  float s = 0.0f;
  for (int t = 0; t < T; ++t) s += G[(long long)t * BN + e];
  out[e] = s;
}

// out[j] = sum_b in[b][j], b in order.
__global__ void colsum_kernel(const float* __restrict__ in,
                              float* __restrict__ out, int B, int N) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  float s = 0.0f;
  for (int b = 0; b < B; ++b) s += in[(long long)b * N + j];
  out[j] = s;
}

// out[r][n] = sum_k A[r][k] * Wm[n][k] (r < R, n < N, k < K): dx = dG1 W1x^T.
template <bool kRound>
__global__ void nt_kernel(const float* __restrict__ A, int lda,
                          const float* __restrict__ Wm, int ldw,
                          float* __restrict__ out, int ldo, int R, int N,
                          int K) {
  __shared__ float As[kDepth][kTile + 1];
  __shared__ float Ws[kDepth][kTile + 1];
  const long long r0 = (long long)blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.0f;
  }
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    for (int e = threadIdx.x; e < kDepth * kTile; e += blockDim.x) {
      const int rr = e / kDepth;   // tile row
      const int kk = e - rr * kDepth;
      const bool kok = k0 + kk < K;
      As[kk][rr] = (kok && r0 + rr < R)
                       ? rnd<kRound>(A[(r0 + rr) * lda + k0 + kk])
                       : 0.0f;
      Ws[kk][rr] = (kok && n0 + rr < N)
                       ? rnd<kRound>(Wm[(long long)(n0 + rr) * ldw + k0 + kk])
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = As[kk][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < 4; ++n) w[n] = Ws[kk][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], w[n], acc[m][n]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const long long r = r0 + ty + 16 * m;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = n0 + tx + 16 * n;
      if (r < R && c < N) out[r * ldo + c] = acc[m][n];
    }
  }
}

int chunks(int R) { return (R + kChunk - 1) / kChunk; }

// dw [K, N] = sum_r A[r]^T G[r] over R rows, through the partial buffer.
cudaError_t tn(const float* A, long long lda, const float* G, long long ldg,
               float* dw, float* part, int R, int K, int N, bool round,
               cudaStream_t s) {
  const long long n = (long long)K * N;
  if (R <= 0) return cudaMemsetAsync(dw, 0, n * sizeof(float), s);
  const dim3 grid((K + kTile - 1) / kTile, (N + kTile - 1) / kTile, chunks(R));
  if (round) {
    tn_partial_kernel<true><<<grid, 256, 0, s>>>(A, lda, G, ldg, part, R, K,
                                                  N);
  } else {
    tn_partial_kernel<false><<<grid, 256, 0, s>>>(A, lda, G, ldg, part, R, K,
                                                   N);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  combine_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, dw, n,
                                                             chunks(R));
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_bwd(const float* x, const float* xadd, long long xts,
                       long long xrs, const float* resid, const float* tops,
                       const float* gtops, const float* gh2, const void* w1x,
                       const void* w1h, const void* w2x, const void* w2h,
                       const void* w1hT, const void* w2xT, const void* w2hT,
                       const float* b2, float* dg1, float* dg2, int T, int B,
                       int D, int H, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (3 * kBT * H + kBT * D + 2 * kBT * 4 * H);
  cudaError_t e = allow_smem(lstm2_bwd_recurrent_kernel<W>, smem);
  if (e != cudaSuccess) return e;
  lstm2_bwd_recurrent_kernel<W><<<(B + kBT - 1) / kBT, kNRG * H, smem, s>>>(
      x, xadd, xts, xrs, resid, tops, gtops, gh2, static_cast<const W*>(w1x),
      static_cast<const W*>(w1h), static_cast<const W*>(w2x),
      static_cast<const W*>(w2h), static_cast<const W*>(w1hT),
      static_cast<const W*>(w2xT), static_cast<const W*>(w2hT), b2, dg1, dg2,
      T, B, D, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the A^T G reduction per partial: the wrapper sizes the partial
// buffer as ceil(R / rows) * max(D, H) * 4H floats.
int sfhvae_lstm2_bwd_fma_chunk_rows() { return kChunk; }

// The backward of both LSTM entries, all on `stream`, in order:
// the recurrent kernel (dg1, dg2 [T, B, 4H] fp32), then the reductions:
//   dw2x = sum_{t,b} h1[t]^T dg2[t],   dw2h = sum_{t>=1} h2[t-1]^T dg2[t],
//   dw1h = sum_{t>=1} h1[t-1]^T dg1[t], dw1x = sum x[t]^T dg1[t] (with x),
//   db2 = sum dg2, dx = dg1 W1x^T (when dx is not null),
//   dxadd: mode 1 sum_t dg1 -> [B, 4H]; mode 2 sum_{t,b} dg1 -> [4H];
//          mode 0 nothing (dg1 is the gradient of per-step gates).
// Weights w* [K, 4H] and w*T [4H, H] are fp32 (bf16 == 0) or bf16; w1x_f32
// [D, 4H] feeds dx; b2 fp32. part: scratch of ceil(T*B / chunk_rows) *
// max(D, H) * 4H floats; rowsum: scratch of B * 4H floats. Returns the
// cudaError_t of the first launch that failed, or 0.
int sfhvae_lstm2_bwd_fma(const void* x, const void* xadd,
                         long long xadd_t_stride, long long xadd_row_stride,
                         const void* resid, const void* tops,
                         const void* gtops, const void* gh2, const void* w1x,
                         const void* w1h, const void* w2x, const void* w2h,
                         const void* w1hT, const void* w2xT, const void* w2hT,
                         const void* w1x_f32, const void* b2, void* dg1,
                         void* dg2, void* dx, void* dxadd, int dxadd_mode,
                         void* dw1x, void* dw1h, void* dw2x, void* dw2h,
                         void* db2, void* part, void* rowsum, int T, int B,
                         int D, int H, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* rf = static_cast<const float*>(resid);
  const float* tf = static_cast<const float*>(tops);
  float* g1 = static_cast<float*>(dg1);
  float* g2 = static_cast<float*>(dg2);
  float* pt = static_cast<float*>(part);
  float* rs = static_cast<float*>(rowsum);
  const int H4 = 4 * H;
  const long long BH4 = (long long)B * H4;
  const bool round = bf16 != 0;

  cudaError_t e =
      round ? launch_bwd<__nv_bfloat16>(
                  xf, static_cast<const float*>(xadd), xadd_t_stride,
                  xadd_row_stride, rf, tf, static_cast<const float*>(gtops),
                  static_cast<const float*>(gh2), w1x, w1h, w2x, w2h, w1hT,
                  w2xT, w2hT, static_cast<const float*>(b2), g1, g2, T, B, D,
                  H, s)
            : launch_bwd<float>(
                  xf, static_cast<const float*>(xadd), xadd_t_stride,
                  xadd_row_stride, rf, tf, static_cast<const float*>(gtops),
                  static_cast<const float*>(gh2), w1x, w1h, w2x, w2h, w1hT,
                  w2xT, w2hT, static_cast<const float*>(b2), g1, g2, T, B, D,
                  H, s);
  if (e != cudaSuccess) return e;

  const int R = T * B;
  const int Rp = (T - 1) * B;  // rows with a previous step
  e = tn(rf, 3LL * H, g2, H4, static_cast<float*>(dw2x), pt, R, H, H4, round,
         s);
  if (e != cudaSuccess) return e;
  e = tn(tf, H, g2 + BH4, H4, static_cast<float*>(dw2h), pt, Rp, H, H4, round,
         s);
  if (e != cudaSuccess) return e;
  e = tn(rf, 3LL * H, g1 + BH4, H4, static_cast<float*>(dw1h), pt, Rp, H, H4,
         round, s);
  if (e != cudaSuccess) return e;
  if (xf != nullptr) {
    e = tn(xf, D, g1, H4, static_cast<float*>(dw1x), pt, R, D, H4, round, s);
    if (e != cudaSuccess) return e;
  }

  const unsigned sum_blocks = (unsigned)((BH4 + 255) / 256);
  sum_t_kernel<<<sum_blocks, 256, 0, s>>>(g2, rs, T, BH4);
  colsum_kernel<<<(H4 + 255) / 256, 256, 0, s>>>(rs, static_cast<float*>(db2),
                                                 B, H4);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (dxadd_mode == 1) {
    sum_t_kernel<<<sum_blocks, 256, 0, s>>>(g1, static_cast<float*>(dxadd), T,
                                            BH4);
  } else if (dxadd_mode == 2) {
    sum_t_kernel<<<sum_blocks, 256, 0, s>>>(g1, rs, T, BH4);
    colsum_kernel<<<(H4 + 255) / 256, 256, 0, s>>>(
        rs, static_cast<float*>(dxadd), B, H4);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  if (dx != nullptr) {
    const dim3 grid((unsigned)((R + kTile - 1) / kTile),
                    (unsigned)((D + kTile - 1) / kTile));
    if (round) {
      nt_kernel<true><<<grid, 256, 0, s>>>(
          g1, H4, static_cast<const float*>(w1x_f32), H4,
          static_cast<float*>(dx), D, R, D, H4);
    } else {
      nt_kernel<false><<<grid, 256, 0, s>>>(
          g1, H4, static_cast<const float*>(w1x_f32), H4,
          static_cast<float*>(dx), D, R, D, H4);
    }
    e = cudaGetLastError();
  }
  return e;
}

}  // extern "C"
