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
// with c = 1 / (2 sigma^2) and logits[b, n] = 2c z2[b].mu2[n] - c |mu2[n]|^2
// (discriminative_common.cuh: the forward's code and bits; precise expf). Padded
// rows (n >= num_real) carry the -1e30 bias, so their p underflows to exactly
// 0 and their dmu2 is exactly 0; an index outside the table matches no row,
// as in the forward.
//
// The same kernels serve the sharded form (bwd_local of
// discriminative_log_qy_pallas_sharded, discriminative.py:343): mu2 is then
// one rank's row shard whose first row is global row row_offset, lse is the
// log-sum-exp over the whole table, padding is judged by the global row and
// the pick by seq_idx - row_offset == n. dz2 is this shard's part (the ranks
// of the model group add theirs); dmu2 is the shard's own. The single table
// passes row_offset 0.
//
// What bounds it on the H100: operations. The logits take B * N * D
// multiply-adds and B * N exps, the two products 2 * B * N * D more, all in
// fp32 on the CUDA cores (D = 16 is too shallow for the tensor cores to pay,
// and a TF32 cross term would be off by ~1e-2 in a logit of magnitude 1e2);
// the bound counts 6 * B * N * D operations over 67 TFLOP/s. The table, z2
// and the outputs are a few MB and stay in L2.
//
// What the design does about it: one fused pass computes each softmax weight
// once. Block (chunk, group) owns a chunk of 128-row table tiles (its size a
// function of N alone) and a group of 64-row batch tiles, chosen by the
// wrapper so that chunks x groups fill the card. For every pair of tiles the
// block stages both in shared memory (the table tile with its logit shifts,
// squared norm and bias; a chunk of one tile is staged once), computes the
// 64 x 128 logits as 4 x 8 register micro-tiles, and writes dlogits into a
// 64 x 128 tile in shared memory. From that tile both products run as 4 x 4
// register micro-tiles: dz2 += dl . mu2 in registers, held across the chunk's
// table tiles, and dmu2 += dl^T . z2 with the column sums, added per pair to
// accumulators in shared memory that persist across the group's batch tiles;
// each contraction is split over up to 8 neighbouring lanes, whose sums meet
// by shuffles in a fixed tree. Every sum runs in a fixed order, without
// atomics: dz2 goes out as one partial per chunk ([chunks, B, D]) and dmu2 as
// one per group ([groups, N, D + 1] with its column sum; written finished
// when there is one group); a second kernel adds the partials in index order
// and applies 2c and the -mu2 * colsum term. Since the chunks follow N alone,
// a dz2 row does not depend on how the batch is split; two launches give the
// same bits.

#include <cuda_runtime.h>

#include "discriminative_common.cuh"

namespace {

using namespace disc;

constexpr int kMaxChunkTiles = 8;     // table tiles a chunk may hold
                                      // (ops/discriminative.py: bwd_geometry)
constexpr int kDlStride = kNT + 4;    // 16-byte rows, 8 rows on distinct banks

// Shared memory of the fused pass, offsets in floats, for a z2 width padded
// to DP (8, 16 or 32; the padding holds zeros).
template <int DP>
struct Smem {
  static constexpr int kRowStride = DP + 4;   // zR, muR: 16-byte rows (as
                                              // stage_table_row writes muR)
  static constexpr int kAccStride = DP + 1;   // dmu2 columns, then colsum
  static constexpr int zT = 0;                          // [DP][kBT]
  static constexpr int zR = zT + DP * kBT;              // [kBT][kRowStride]
  static constexpr int muT = zR + kBT * kRowStride;     // [DP][kNT]
  static constexpr int muR = muT + DP * kNT;            // [kNT][kRowStride]
  static constexpr int shift = muR + kNT * kRowStride;  // [kNT]
  static constexpr int lse = shift + kNT;               // [kBT]
  static constexpr int g = lse + kBT;                   // [kBT]
  static constexpr int seq = g + kBT;                   // [kBT], int
  static constexpr int dl = seq + kBT;                  // [kBT][kDlStride]
  static constexpr int acc = dl + kBT * kDlStride;      // [tiles * kNT][...]
  static size_t bytes(int tiles) {
    return sizeof(float) *
           (acc + static_cast<size_t>(tiles) * kNT * kAccStride);
  }
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 2) disc_bwd_fused_kernel(
    const float* __restrict__ z2,       // [B, D]
    const float* __restrict__ mu2,      // [N, D]
    const void* __restrict__ seq_idx,   // [B], int64 (seq64) or int32
    int seq64,
    const float* __restrict__ lse,      // [B]
    const float* __restrict__ g,        // [B]
    float* __restrict__ dmu2,           // [N, D], when n_groups == 1
    float* __restrict__ part_z,         // [n_chunks, B, D]
    float* __restrict__ part_mu,        // [n_groups, N, D + 1], n_groups > 1
    int B, int N, int D, int num_real, int row_offset, int chunk_tiles,
    int group_tiles, int n_groups, float inv_two_var) {
  using L = Smem<DP>;
  extern __shared__ __align__(16) float sm[];
  int* seq_s = reinterpret_cast<int*>(sm + L::seq);
  float* acc = sm + L::acc;
  const int tid = threadIdx.x;

  const int n_first = blockIdx.x * chunk_tiles * kNT;
  const int n_stop = min(N, n_first + chunk_tiles * kNT);
  const int tiles = (n_stop - n_first + kNT - 1) / kNT;
  const int b_first = blockIdx.y * group_tiles * kBT;
  const int b_stop = min(B, b_first + group_tiles * kBT);

  for (int i = tid; i < tiles * kNT * L::kAccStride; i += kThreads) {
    acc[i] = 0.0f;
  }

  // logits: rows 4 ty .. 4 ty + 3, columns 4 tx .. 4 tx + 3 and 64 more
  const int tx = tid % 16, ty = tid / 16;
  // Both products take 4 x 4 micro-tiles of their output, column group cg
  // (columns 4 cg .. 4 cg + 3), with the contraction split over kZS (kMS)
  // neighbouring lanes, each taking every kZS-th group of 4 table rows
  // (every kMS-th batch row); the lanes' sums meet by lane_sum.
  constexpr int kCG = DP / 4;
  // dz2: batch rows 4 zg .. 4 zg + 3 of the tile
  constexpr int kZS = 64 / DP;
  const int zq = tid % kZS, zcg = (tid / kZS) % kCG, zg = tid / (kZS * kCG);
  // dmu2: table rows 4 mg .. 4 mg + 3 of the tile
  constexpr int kMS = 32 / DP;
  const int mq = tid % kMS, mcg = (tid / kMS) % kCG, mg = tid / (kMS * kCG);

  for (int b0 = b_first; b0 < b_stop; b0 += kBT) {
    const int bcnt = min(kBT, b_stop - b0);
    float dz[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int w = 0; w < 4; ++w) dz[i][w] = 0.0f;
    }

    for (int t = 0; t < tiles; ++t) {
      const int n0 = n_first + t * kNT;
      const int ncnt = min(kNT, n_stop - n0);
      __syncthreads();  // the previous pair's products are done
      if (tid < kNT) {
        // table row tid of the tile (zeros past the table) and its logit
        // shift, with the bias -1e30 on padding and past the table, where p
        // is then exactly 0. A chunk of one tile is staged once
        if (tiles > 1 || b0 == b_first) {
          const bool in_tile = tid < ncnt;
          stage_table_row<DP>(mu2 + (long long)(n0 + tid) * D, in_tile,
                              in_tile && row_offset + n0 + tid < num_real, D,
                              tid, inv_two_var, sm + L::muT, sm + L::muR,
                              sm + L::shift);
        }
      } else if (t == 0 && tid < kNT + kBT) {
        // batch row r of the tile, once per batch tile; past B, g = 0 and
        // the log-sum-exp 1e30, so that p and dl are exactly 0
        const int r = tid - kNT;
        const bool ok = r < bcnt;
        const long long b = b0 + r;
        float v[DP];
#pragma unroll
        for (int k = 0; k < DP; ++k) {
          v[k] = (ok && k < D) ? z2[b * D + k] : 0.0f;
          sm[L::zT + k * kBT + r] = v[k];
        }
#pragma unroll
        for (int k = 0; k < DP; k += 4) {
          *reinterpret_cast<float4*>(sm + L::zR + r * L::kRowStride + k) =
              make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
        }
        sm[L::lse + r] = ok ? lse[b] : -kNegInf;
        sm[L::g + r] = ok ? g[b] : 0.0f;
        seq_s[r] = ok ? local_row(seq_idx, seq64, b, row_offset, N) : -1;
      }
      __syncthreads();

      // the 64 x 128 cross terms, k in order
      float cr[4][8];
      cross_tile<DP>(sm + L::zT, sm + L::muT, tx, ty, cr);

      // dlogits into shared memory
      float shift[8];
      int gn[8];  // the shard's row of each column
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tile_col(tx, j);
        shift[j] = sm[L::shift + n];
        gn[j] = n0 + n;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const float lse_r = sm[L::lse + r], g_r = sm[L::g + r];
        const int y = seq_s[r];
        float d[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float logit = tile_logit(inv_two_var, cr[i][j], shift[j]);
          const float p = expf(logit - lse_r);
          d[j] = g_r * ((gn[j] == y ? 1.0f : 0.0f) - p);
        }
        float* row = sm + L::dl + r * kDlStride + tx * 4;
        *reinterpret_cast<float4*>(row) = make_float4(d[0], d[1], d[2], d[3]);
        *reinterpret_cast<float4*>(row + 64) =
            make_float4(d[4], d[5], d[6], d[7]);
      }
      __syncthreads();

      // dz2 += dl . mu2 (registers, across the chunk's tiles)
#pragma unroll 2
      for (int j = 0; j < kNT / (4 * kZS); ++j) {
        const int n = 4 * (zq + kZS * j);
        float d[4][4], m[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lds4(sm + L::dl + (4 * zg + i) * kDlStride + n, d[i]);
          lds4(sm + L::muR + (n + i) * L::kRowStride + 4 * zcg, m[i]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              dz[i][w] = fmaf(d[i][e], m[e][w], dz[i][w]);
            }
          }
        }
      }
      // dmu2 += dl^T . z2 and colsum += sum_b dl (shared memory, across the
      // group's batch tiles)
      {
        float s[4][4], cs[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cs[i] = 0.0f;
#pragma unroll
          for (int w = 0; w < 4; ++w) s[i][w] = 0.0f;
        }
#pragma unroll 2
        for (int j = 0; j < kBT / kMS; ++j) {
          const int r = mq + kMS * j;
          float d[4], zv[4];
          lds4(sm + L::dl + r * kDlStride + 4 * mg, d);
          lds4(sm + L::zR + r * L::kRowStride + 4 * mcg, zv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            cs[i] += d[i];
#pragma unroll
            for (int w = 0; w < 4; ++w) s[i][w] = fmaf(d[i], zv[w], s[i][w]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cs[i] = lane_sum<kMS>(cs[i]);
#pragma unroll
          for (int w = 0; w < 4; ++w) s[i][w] = lane_sum<kMS>(s[i][w]);
        }
        if (mq == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* a = acc + (t * kNT + 4 * mg + i) * L::kAccStride;
#pragma unroll
            for (int w = 0; w < 4; ++w) a[4 * mcg + w] += s[i][w];
            if (mcg == 0) a[DP] += cs[i];
          }
        }
      }
    }

    // this chunk's part of dz2 for the batch tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int w = 0; w < 4; ++w) dz[i][w] = lane_sum<kZS>(dz[i][w]);
    }
    if (zq == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * zg + i;
        if (r >= bcnt) continue;
        float* out = part_z + ((long long)blockIdx.x * B + b0 + r) * D;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          if (4 * zcg + w < D) out[4 * zcg + w] = dz[i][w];
        }
      }
    }
  }

  __syncthreads();  // the accumulators are complete
  const float c2 = 2.0f * inv_two_var;
  for (int i = tid; i < tiles * kNT; i += kThreads) {
    const long long n = n_first + i;
    if (n >= n_stop) break;
    const float* a = acc + i * L::kAccStride;
    if (n_groups == 1) {
      for (int k = 0; k < D; ++k) {
        dmu2[n * D + k] = c2 * (a[k] - mu2[n * D + k] * a[DP]);
      }
    } else {
      float* p = part_mu + ((long long)blockIdx.y * N + n) * (D + 1);
      for (int k = 0; k < D; ++k) p[k] = a[k];
      p[D] = a[DP];
    }
  }
}

// dz2 = 2c * sum over chunks of part_z; when n_groups > 1 also dmu2 =
// 2c * (sum over groups of part_mu - mu2 * sum over groups of colsum). Each
// sum starts at index 0 and runs in index order.
__global__ void disc_bwd_combine_kernel(const float* __restrict__ part_z,
                                        const float* __restrict__ part_mu,
                                        const float* __restrict__ mu2,
                                        float* __restrict__ dz2,
                                        float* __restrict__ dmu2, int B, int N,
                                        int D, int n_chunks, int n_groups,
                                        float inv_two_var) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float c2 = 2.0f * inv_two_var;
  const long long nz = (long long)B * D;
  if (i < nz) {
    float s = part_z[i];
#pragma unroll 8
    for (int c = 1; c < n_chunks; ++c) s += part_z[c * nz + i];
    dz2[i] = c2 * s;
    return;
  }
  const long long j = i - nz;
  if (n_groups == 1 || j >= (long long)N * D) return;
  const long long n = j / D;
  const int k = static_cast<int>(j - n * D);
  const long long stride = (long long)N * (D + 1);
  const float* p = part_mu + n * (D + 1);
  float a = p[k], cs = p[D];
  for (int q = 1; q < n_groups; ++q) {
    a += p[q * stride + k];
    cs += p[q * stride + D];
  }
  dmu2[j] = c2 * (a - mu2[j] * cs);
}

template <int DP>
cudaError_t launch_fused(dim3 grid, cudaStream_t st, const float* z2,
                         const float* mu2, const void* seq_idx, int seq64,
                         const float* lse, const float* g, float* dmu2,
                         float* part_z, float* part_mu, int B, int N, int D,
                         int num_real, int row_offset, int chunk_tiles,
                         int group_tiles, int n_groups, float inv_two_var) {
  const size_t smem = Smem<DP>::bytes(chunk_tiles);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        disc_bwd_fused_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  disc_bwd_fused_kernel<DP><<<grid, kThreads, smem, st>>>(
      z2, mu2, seq_idx, seq64, lse, g, dmu2, part_z, part_mu, B, N, D,
      num_real,
      row_offset, chunk_tiles, group_tiles, n_groups, inv_two_var);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// z2: [B, D] fp32; mu2: [N, D] fp32; seq_idx: [B] int64 (seq64 = 1) or
// int32 (seq64 = 0); lse, g: [B] fp32;
// dz2: [B, D] fp32; dmu2: [N, D] fp32. D <= sfhvae_disc_max_dim(); B, N >= 1.
// mu2's first row is row row_offset of the whole table (0 for a single
// table); num_real and seq_idx count in the whole table. The geometry
// (ops/discriminative.py: bwd_geometry): chunk c holds table rows
// [c * chunk_tiles * 128, ...), chunk_tiles <= 8, every chunk non-empty;
// group q batch rows [q * group_tiles * 64, ...), every group non-empty.
// Scratch: part_z [n_chunks, B, D] fp32; part_mu [n_groups, N, D + 1] fp32,
// or null when n_groups == 1. Returns the cudaError_t of the launches.
int sfhvae_disc_bwd(const void* z2, const void* mu2, const void* seq_idx,
                    int seq64, const void* lse, const void* g, void* dz2, void* dmu2,
                    void* part_z, void* part_mu, int B, int N, int D,
                    int num_real, int row_offset, int chunk_tiles,
                    int n_chunks, int group_tiles, int n_groups,
                    float inv_two_var, void* stream) {
  if (chunk_tiles < 1 || chunk_tiles > kMaxChunkTiles || D < 1 || D > kMaxD ||
      (n_groups > 1 && part_mu == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_chunks, n_groups);
  const auto run = [&](auto fused) {
    return fused(grid, st, static_cast<const float*>(z2),
                 static_cast<const float*>(mu2),
                 seq_idx, seq64,
                 static_cast<const float*>(lse), static_cast<const float*>(g),
                 static_cast<float*>(dmu2), static_cast<float*>(part_z),
                 static_cast<float*>(part_mu), B, N, D, num_real, row_offset,
                 chunk_tiles, group_tiles, n_groups, inv_two_var);
  };
  const cudaError_t e = D <= 8    ? run(launch_fused<8>)
                        : D <= 16 ? run(launch_fused<16>)
                                  : run(launch_fused<32>);
  if (e != cudaSuccess) return e;
  const long long total =
      (long long)B * D + (n_groups > 1 ? (long long)N * D : 0);
  disc_bwd_combine_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part_z), static_cast<const float*>(part_mu),
      static_cast<const float*>(mu2), static_cast<float*>(dz2),
      static_cast<float*>(dmu2), B, N, D, n_chunks, n_groups, inv_two_var);
  return cudaGetLastError();
}

}  // extern "C"
