// Streaming discriminative log q(y | z2) over the mu2 table, forward (sm_90a).
//
// Replaces the TPU kernel pytorch_scalablefhvae_tpu/ops/discriminative.py:
// _fwd_kernel / _partials_call (entry discriminative_log_qy_pallas). Per
// batch row b, with logits[b, n] = (2 z2[b].mu2[n] - |mu2[n]|^2) / (2 sigma^2)
// plus -1e30 on padded rows (n >= num_real):
//   log_qy[b] = logits[b, seq_idx[b]] - logsumexp_n logits[b, n].
// The [B, N] logits never exist in device memory. An index outside the table
// picks nothing (picked stays 0), as in the Pallas kernel.
//
// What bounds it on the H100: at B = 2048 and N = 281,241 it is 2 * B * N * D
// = 18 GFLOP of FMAs plus one exp per logit (576 M). The table (18 MB) fits in
// the 50 MB L2, so the kernel is bound by the CUDA cores' FMA and exp rate;
// D = 16 is too shallow for the tensor cores to pay.
//
// What the design does about it: the TPU grid walked the table in order and
// carried (m, s, picked) from block to block. Here blocks run in parallel, so
// the table is cut into chunks: block (i, c) owns 32 batch rows and chunk c,
// stages the chunk through shared memory 256 table rows at a time (with their
// squared norms computed once per tile), and keeps an online max / rescaled
// sum / picked logit per (row, thread). The 8 threads of a row merge theirs
// with warp shuffles and write one partial per (row, chunk); a second kernel
// merges the chunks: m* = max m, s* = sum s e^(m - m*), picked* = sum picked,
// the same combine as the sharded TPU path (discriminative.py:327-340).
// The combine also writes the log-sum-exp per row when asked: the backward
// kernel (discriminative_bwd.cu) recomputes the softmax from it.
//
// The sharded form (entry discriminative_log_qy_pallas_sharded,
// discriminative.py:288) is sfhvae_disc_partials below: the table is one
// rank's row shard, whose first row is global row row_offset. Padding is
// judged by the global row (row_offset + n >= num_real) and the pick by
// seq_idx - row_offset, so a sequence another shard owns picks nothing here.
// Its chunk merge stops at (m, s, picked); the ranks of the model group then
// merge theirs by the same rule with two all-reduces. A shard made only of
// padding reports m = -1e30 exactly (the bias absorbs every logit in fp32)
// and s = its row count, and e^(m - m*) is then exactly 0.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;      // batch rows per block
constexpr int kLanes = 8;      // threads per batch row (consecutive lanes)
constexpr int kTile = 256;     // table rows staged in shared memory per pass
constexpr int kMaxD = 32;      // largest z2 width the kernel takes
constexpr float kNegInf = -1e30f;

__global__ void disc_partials_kernel(
    const float* __restrict__ z2,      // [B, D]
    const float* __restrict__ mu2,     // [N, D]
    const int* __restrict__ seq_idx,   // [B]
    float* __restrict__ m_out,         // [C, B]
    float* __restrict__ s_out,         // [C, B]
    float* __restrict__ p_out,         // [C, B]
    int B, int N, int D, int num_real, int row_offset, int chunk,
    float inv_two_var) {
  __shared__ float tile[kTile * (kMaxD + 1)];  // row stride D + 1: no bank
  __shared__ float sq[kTile];                  // conflicts between rows

  const int lane = threadIdx.x % kLanes;
  const int b = blockIdx.x * kRows + threadIdx.x / kLanes;
  const bool row_ok = b < B;
  const int n_begin = blockIdx.y * chunk;
  const int n_end = min(N, n_begin + chunk);

  float z[kMaxD];
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) {
    z[k] = (row_ok && k < D) ? z2[(long long)b * D + k] : 0.0f;
  }
  // the picked row and the first padded row, in this shard's numbering
  const int y = row_ok ? seq_idx[b] - row_offset : -1;
  const int n_real = num_real - row_offset;

  float m = kNegInf, s = 0.0f, picked = 0.0f;
  for (int n0 = n_begin; n0 < n_end; n0 += kTile) {
    const int cnt = min(kTile, n_end - n0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < cnt * D; i += blockDim.x) {
      const int n = i / D;
      tile[n * (D + 1) + (i - n * D)] = mu2[(long long)n0 * D + i];
    }
    __syncthreads();
    for (int n = threadIdx.x; n < cnt; n += blockDim.x) {
      float acc = 0.0f;
      for (int k = 0; k < D; ++k) {
        const float v = tile[n * (D + 1) + k];
        acc = fmaf(v, v, acc);
      }
      sq[n] = acc;
    }
    __syncthreads();
    for (int n = lane; n < cnt; n += kLanes) {
      const float* row = tile + n * (D + 1);
      float cross = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxD; ++k) {
        if (k < D) cross = fmaf(z[k], row[k], cross);
      }
      const int gn = n0 + n;
      const float logit = inv_two_var * (2.0f * cross - sq[n]) +
                          (gn < n_real ? 0.0f : kNegInf);
      if (logit > m) {
        s = s * expf(m - logit) + 1.0f;
        m = logit;
      } else {
        s += expf(logit - m);
      }
      if (gn == y) picked = logit;
    }
  }

  // merge the kLanes partials of this row (all 32 lanes take part)
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const float p2 = __shfl_xor_sync(0xffffffffu, picked, off);
    const float mn = fmaxf(m, m2);
    s = s * expf(m - mn) + s2 * expf(m2 - mn);
    m = mn;
    picked += p2;
  }
  if (lane == 0 && row_ok) {
    const long long o = (long long)blockIdx.y * B + b;
    m_out[o] = m;
    s_out[o] = s;
    p_out[o] = picked;
  }
}

// One row's chunk partials merged: m* = max m, s* = sum s e^(m - m*),
// picked* = sum picked.
__device__ __forceinline__ void merge_chunks(
    const float* __restrict__ m_part, const float* __restrict__ s_part,
    const float* __restrict__ p_part, int b, int B, int C, float& m, float& s,
    float& picked) {
  m = kNegInf;
  for (int c = 0; c < C; ++c) m = fmaxf(m, m_part[(long long)c * B + b]);
  s = 0.0f;
  picked = 0.0f;
  for (int c = 0; c < C; ++c) {
    const long long o = (long long)c * B + b;
    s += s_part[o] * expf(m_part[o] - m);
    picked += p_part[o];
  }
}

__global__ void disc_combine_kernel(const float* __restrict__ m_part,
                                    const float* __restrict__ s_part,
                                    const float* __restrict__ p_part,
                                    float* __restrict__ out,
                                    float* __restrict__ lse_out, int B,
                                    int C) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float m, s, picked;
  merge_chunks(m_part, s_part, p_part, b, B, C, m, s, picked);
  const float lse = m + logf(s);
  out[b] = picked - lse;
  if (lse_out != nullptr) lse_out[b] = lse;
}

// The sharded form's merge: it stops at this shard's (m, s, picked) per row.
__global__ void disc_merge_kernel(const float* __restrict__ m_part,
                                  const float* __restrict__ s_part,
                                  const float* __restrict__ p_part,
                                  float* __restrict__ m_out,
                                  float* __restrict__ s_out,
                                  float* __restrict__ p_out, int B, int C) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float m, s, picked;
  merge_chunks(m_part, s_part, p_part, b, B, C, m, s, picked);
  m_out[b] = m;
  s_out[b] = s;
  p_out[b] = picked;
}

}  // namespace

extern "C" {

int sfhvae_disc_rows_per_block() { return kRows; }
int sfhvae_disc_max_dim() { return kMaxD; }

// z2: [B, D] fp32; mu2: [N, D] fp32; seq_idx: [B] int32; m/s/p: [n_chunks, B]
// fp32 scratch; out: [B] fp32. Chunk c covers table rows
// [c * chunk, min(N, (c + 1) * chunk)); every chunk must be non-empty.
// lse: [B] fp32 or null. Returns the cudaError_t of the launches.
int sfhvae_disc_fwd(const void* z2, const void* mu2, const void* seq_idx,
                    void* m, void* s, void* p, void* out, void* lse, int B,
                    int N, int D,
                    int num_real, int chunk, int n_chunks, float inv_two_var,
                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kRows - 1) / kRows, n_chunks);
  disc_partials_kernel<<<grid, kRows * kLanes, 0, st>>>(
      static_cast<const float*>(z2), static_cast<const float*>(mu2),
      static_cast<const int*>(seq_idx), static_cast<float*>(m),
      static_cast<float*>(s), static_cast<float*>(p), B, N, D, num_real, 0,
      chunk, inv_two_var);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  disc_combine_kernel<<<(B + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(m), static_cast<const float*>(s),
      static_cast<const float*>(p), static_cast<float*>(out),
      static_cast<float*>(lse), B, n_chunks);
  return cudaGetLastError();
}

// The sharded form: mu2 is one rank's shard [N, D] whose first row is global
// row row_offset; num_real counts the real rows of the whole table; seq_idx
// holds global rows. m/s/p: [n_chunks, B] scratch as above; m_out, s_out,
// p_out: [B] fp32, this shard's online max, rescaled sum and picked logit.
int sfhvae_disc_partials(const void* z2, const void* mu2, const void* seq_idx,
                         void* m, void* s, void* p, void* m_out, void* s_out,
                         void* p_out, int B, int N, int D, int num_real,
                         int row_offset, int chunk, int n_chunks,
                         float inv_two_var, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kRows - 1) / kRows, n_chunks);
  disc_partials_kernel<<<grid, kRows * kLanes, 0, st>>>(
      static_cast<const float*>(z2), static_cast<const float*>(mu2),
      static_cast<const int*>(seq_idx), static_cast<float*>(m),
      static_cast<float*>(s), static_cast<float*>(p), B, N, D, num_real,
      row_offset, chunk, inv_two_var);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  disc_merge_kernel<<<(B + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(m), static_cast<const float*>(s),
      static_cast<const float*>(p), static_cast<float*>(m_out),
      static_cast<float*>(s_out), static_cast<float*>(p_out), B, n_chunks);
  return cudaGetLastError();
}

}  // extern "C"
