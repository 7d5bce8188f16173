// Streaming discriminative log q(y | z2) over the mu2 table, backward
// (sm_90a).
//
// Replaces the TPU kernel pytorch_scalablefhvae_tpu/ops/discriminative.py:
// _bwd_kernel / _bwd_call (the VJP of _log_qy_single). With the logits of the
// forward kernel, the saved log-sum-exp per row and the cotangent g [B]:
//   p[b, n]       = exp(logits[b, n] - lse[b])        (recomputed, never stored)
//   dlogits[b, n] = g[b] * (onehot(seq_idx[b])[n] - p[b, n])
//   dz2[b]        = 2c * sum_n dlogits[b, n] mu2[n]
//   dmu2[n]       = 2c * (sum_b dlogits[b, n] z2[b] - mu2[n] sum_b dlogits[b, n])
// with c = 1 / (2 sigma^2). Padded rows (n >= num_real) carry the -1e30 bias,
// so their p underflows to exactly 0 and their dmu2 is exactly 0; an index
// outside the table matches no row, as in the forward.
//
// The same kernels serve the sharded form (bwd_local of
// discriminative_log_qy_pallas_sharded, discriminative.py:343): mu2 is then
// one rank's row shard whose first row is global row row_offset, lse is the
// log-sum-exp over the whole table, padding is judged by the global row and
// the pick by seq_idx == row_offset + n. dz2 is this shard's part (the ranks
// of the model group add theirs); dmu2 is the shard's own. The single table
// passes row_offset 0.
//
// What bounds it on the H100: like the forward, 2 * B * N * D FMAs for the
// logits plus B * N exps, and as many FMAs again for the two products; the
// table fits in L2. The TPU kernel walks the table in order and accumulates
// dz2 in a revisited VMEM block; here blocks run in parallel.
//
// What the design does about it: two kernels, each exact without atomics.
//   - dmu2: a block owns 32 table rows (8 lanes each) and loops over all B
//     batch rows, staged 256 at a time in shared memory; each lane sums its
//     share of the batch rows and the 8 lanes merge by warp shuffle in a
//     fixed pattern, so each dmu2 row is written once, in a fixed order.
//   - dz2: a warp owns one batch row and loops over the whole table, staged
//     256 rows at a time (with their squared norms) in shared memory; the 32
//     lanes merge by warp shuffle. The sum over N stays inside the warp, so no
//     partials and no combine pass are needed.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 32;      // largest z2 width the kernel takes
constexpr int kTile = 256;     // rows staged in shared memory per pass
constexpr int kMuRows = 32;    // table rows per block (dmu2)
constexpr int kMuLanes = 8;    // threads per table row (dmu2)
constexpr int kZRows = 8;      // batch rows per block (dz2): one warp each
constexpr float kNegInf = -1e30f;

__global__ void disc_bwd_mu_kernel(
    const float* __restrict__ z2,     // [B, D]
    const float* __restrict__ mu2,    // [N, D]
    const int* __restrict__ seq_idx,  // [B]
    const float* __restrict__ lse,    // [B]
    const float* __restrict__ g,      // [B]
    float* __restrict__ dmu2,         // [N, D]
    int B, int N, int D, int num_real, int row_offset, float inv_two_var) {
  __shared__ float zt[kTile * (kMaxD + 1)];  // row stride D + 1
  __shared__ float lt[kTile];
  __shared__ float gt[kTile];
  __shared__ int st[kTile];

  const int lane = threadIdx.x % kMuLanes;
  const int n = blockIdx.x * kMuRows + threadIdx.x / kMuLanes;
  const bool row_ok = n < N;

  float m[kMaxD];
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) {
    m[k] = (row_ok && k < D) ? mu2[(long long)n * D + k] : 0.0f;
    sq = fmaf(m[k], m[k], sq);
  }
  const int gn = row_offset + n;  // this row in the whole table
  const float bias = gn < num_real ? 0.0f : kNegInf;

  float acc[kMaxD];
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) acc[k] = 0.0f;
  float colsum = 0.0f;

  for (int b0 = 0; b0 < B; b0 += kTile) {
    const int cnt = min(kTile, B - b0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < cnt * D; i += blockDim.x) {
      const int b = i / D;
      zt[b * (D + 1) + (i - b * D)] = z2[(long long)b0 * D + i];
    }
    for (int b = threadIdx.x; b < cnt; b += blockDim.x) {
      lt[b] = lse[b0 + b];
      gt[b] = g[b0 + b];
      st[b] = seq_idx[b0 + b];
    }
    __syncthreads();
    if (row_ok) {
      for (int b = lane; b < cnt; b += kMuLanes) {
        const float* zr = zt + b * (D + 1);
        float cross = 0.0f;
#pragma unroll
        for (int k = 0; k < kMaxD; ++k) {
          if (k < D) cross = fmaf(m[k], zr[k], cross);
        }
        const float logit = inv_two_var * (2.0f * cross - sq) + bias;
        const float p = expf(logit - lt[b]);
        const float dl = gt[b] * ((st[b] == gn ? 1.0f : 0.0f) - p);
        colsum += dl;
#pragma unroll
        for (int k = 0; k < kMaxD; ++k) {
          if (k < D) acc[k] = fmaf(dl, zr[k], acc[k]);
        }
      }
    }
  }

  // merge the kMuLanes partials of this table row (all 32 lanes take part)
#pragma unroll
  for (int off = kMuLanes / 2; off > 0; off >>= 1) {
    colsum += __shfl_xor_sync(0xffffffffu, colsum, off);
#pragma unroll
    for (int k = 0; k < kMaxD; ++k) {
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    }
  }
  if (lane == 0 && row_ok) {
    const float c2 = 2.0f * inv_two_var;
    for (int k = 0; k < D; ++k) {
      dmu2[(long long)n * D + k] = c2 * (acc[k] - m[k] * colsum);
    }
  }
}

__global__ void disc_bwd_z_kernel(
    const float* __restrict__ z2,     // [B, D]
    const float* __restrict__ mu2,    // [N, D]
    const int* __restrict__ seq_idx,  // [B]
    const float* __restrict__ lse,    // [B]
    const float* __restrict__ g,      // [B]
    float* __restrict__ dz2,          // [B, D]
    int B, int N, int D, int num_real, int row_offset, float inv_two_var) {
  __shared__ float tile[kTile * (kMaxD + 1)];
  __shared__ float sq[kTile];

  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * kZRows + threadIdx.x / 32;
  const bool row_ok = b < B;

  float z[kMaxD];
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) {
    z[k] = (row_ok && k < D) ? z2[(long long)b * D + k] : 0.0f;
  }
  const int y = row_ok ? seq_idx[b] : -1;
  const float lse_b = row_ok ? lse[b] : 0.0f;
  const float g_b = row_ok ? g[b] : 0.0f;

  float acc[kMaxD];
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) acc[k] = 0.0f;

  for (int n0 = 0; n0 < N; n0 += kTile) {
    const int cnt = min(kTile, N - n0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < cnt * D; i += blockDim.x) {
      const int n = i / D;
      tile[n * (D + 1) + (i - n * D)] = mu2[(long long)n0 * D + i];
    }
    __syncthreads();
    for (int n = threadIdx.x; n < cnt; n += blockDim.x) {
      float s = 0.0f;
      for (int k = 0; k < D; ++k) {
        const float v = tile[n * (D + 1) + k];
        s = fmaf(v, v, s);
      }
      sq[n] = s;
    }
    __syncthreads();
    if (row_ok) {
      for (int n = lane; n < cnt; n += 32) {
        const float* row = tile + n * (D + 1);
        float cross = 0.0f;
#pragma unroll
        for (int k = 0; k < kMaxD; ++k) {
          if (k < D) cross = fmaf(z[k], row[k], cross);
        }
        const int gn = row_offset + n0 + n;
        const float logit = inv_two_var * (2.0f * cross - sq[n]) +
                            (gn < num_real ? 0.0f : kNegInf);
        const float p = expf(logit - lse_b);
        const float dl = g_b * ((gn == y ? 1.0f : 0.0f) - p);
#pragma unroll
        for (int k = 0; k < kMaxD; ++k) {
          if (k < D) acc[k] = fmaf(dl, row[k], acc[k]);
        }
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kMaxD; ++k) {
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    }
  }
  if (lane == 0 && row_ok) {
    const float c2 = 2.0f * inv_two_var;
    for (int k = 0; k < D; ++k) dz2[(long long)b * D + k] = c2 * acc[k];
  }
}

}  // namespace

extern "C" {

// z2: [B, D] fp32; mu2: [N, D] fp32; seq_idx: [B] int32; lse, g: [B] fp32;
// dz2: [B, D] fp32; dmu2: [N, D] fp32. D <= sfhvae_disc_max_dim(). mu2's first
// row is row row_offset of the whole table (0 for a single table); num_real
// and seq_idx count in the whole table. Returns the cudaError_t of the
// launches.
int sfhvae_disc_bwd(const void* z2, const void* mu2, const void* seq_idx,
                    const void* lse, const void* g, void* dz2, void* dmu2,
                    int B, int N, int D, int num_real, int row_offset,
                    float inv_two_var, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  disc_bwd_mu_kernel<<<(N + kMuRows - 1) / kMuRows, kMuRows * kMuLanes, 0,
                       st>>>(
      static_cast<const float*>(z2), static_cast<const float*>(mu2),
      static_cast<const int*>(seq_idx), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<float*>(dmu2), B, N, D,
      num_real, row_offset, inv_two_var);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  disc_bwd_z_kernel<<<(B + kZRows - 1) / kZRows, kZRows * 32, 0, st>>>(
      static_cast<const float*>(z2), static_cast<const float*>(mu2),
      static_cast<const int*>(seq_idx), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<float*>(dz2), B, N, D,
      num_real, row_offset, inv_two_var);
  return cudaGetLastError();
}

}  // extern "C"
