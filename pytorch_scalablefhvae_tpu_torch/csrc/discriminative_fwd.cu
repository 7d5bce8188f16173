// Streaming discriminative log q(y | z2) over the mu2 table, forward (sm_90a).
//
// Replaces the TPU kernel pytorch_scalablefhvae_tpu/ops/discriminative.py:
// _fwd_kernel / _partials_call (entry discriminative_log_qy_pallas). Per
// batch row b, with logits[b, n] = (2 z2[b].mu2[n] - |mu2[n]|^2) / (2 sigma^2)
// plus -1e30 on padded rows (n >= num_real):
//   log_qy[b] = logits[b, seq_idx[b]] - logsumexp_n logits[b, n].
// The [B, N] logits never exist in device memory. An index outside the table
// picks nothing (picked stays 0), as in the Pallas kernel. The logits come
// from discriminative_common.cuh, the same code and bits as the backward's.
//
// What bounds it on the H100: operations. At B = 2048 and N = 281,241 it is
// B * N * D = 9.2 G multiply-adds (the bound counts 2 B N D operations over
// 67 TFLOP/s) plus a precise exp per logit (576 M); the table (18 MB) stays
// in the 50 MB L2. D = 16 is too shallow for the tensor cores to pay, and a
// TF32 cross term would be off by ~1e-2 in a logit of magnitude 1e2, so it
// is fp32 on the CUDA cores: about 25 FMA-pipe instructions per logit.
//
// What the design does about it: the TPU grid walked the table in order and
// carried (m, s, picked) from step to step. Here block (chunk, group) owns a
// chunk of 128-row table tiles (its size a function of N alone,
// ops/discriminative.py: fwd_geometry) and a group of 64-row batch tiles.
// For each batch tile it walks the chunk's table tiles: the 64 x 128 cross
// terms as 4 x 8 register micro-tiles, then per thread and batch row one
// online step per tile (the tile max first, s rescaled once, then its 8
// exps: no branch per logit) and, in the one tile that holds a row's pick,
// one compare per column. Every buffer is double and the copies are
// cp.async: while a step's logits run, the table tile after next is on its
// way into shared memory, the next one is transposed with its logit shifts,
// and at the end of a batch tile the next batch tile is on its way; one
// barrier a step. At the end of the chunk the 16 lanes of a batch row
// merge their (m, s, picked) by a fixed shuffle tree and write one partial
// per (chunk, row); a second kernel merges the chunks in index order:
// m* = max m, s* = sum s e^(m - m*), picked* = sum picked, the same combine
// as the sharded TPU path (discriminative.py:327-340), and writes
// log_qy = picked* - lse with lse = m* + log s* (the backward recomputes the
// softmax from lse). No atomics: two launches give the same bits, and since
// the chunks follow N alone a row's log_qy and lse do not depend on how the
// batch is split.
//
// The sharded form (entry discriminative_log_qy_pallas_sharded,
// discriminative.py:288) is sfhvae_disc_partials below: the table is one
// rank's row shard, whose first row is global row row_offset. Padding is
// judged by the global row (row_offset + n >= num_real) and the pick by
// seq_idx - row_offset, so a sequence another shard owns picks nothing here.
// Its chunk merge stops at (m, s, picked); the ranks of the model group then
// merge theirs by the same rule with two all-reduces. A shard made only of
// padding reports m = -1e30 exactly (the bias absorbs every logit in fp32)
// and s = the rows of its tiles, and e^(m - m*) is then exactly 0. Rows past
// the table in the last tile carry the same bias, so they add exactly 0 to
// the s of any chunk that holds a real row.

#include <cstdint>

#include <cuda_runtime.h>

#include "discriminative_common.cuh"

namespace {

using namespace disc;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared memory of the forward, offsets in floats, for a z2 width padded to
// DP (8, 16 or 32). Every buffer is double: step s computes on one while the
// tiles of step s + 1 are staged into the other.
template <int DP>
struct FwdSmem {
  static constexpr int raw = 0;                        // [2][kNT * DP], as in
                                                       // mu2 (cp.async)
  static constexpr int muT = raw + 2 * kNT * DP;       // [2][DP][kNT]
  static constexpr int shift = muT + 2 * DP * kNT;     // [2][kNT]
  static constexpr int zT = shift + 2 * kNT;           // [2][DP][kBT]
  static constexpr int seq = zT + 2 * DP * kBT;        // [2][kBT] int64 or
                                                       // int32 (cp.async)
  static constexpr size_t bytes = sizeof(float) * (seq + 2 * 2 * kBT);
};

// kProbe 0 is the kernel the entries run; 1 and 2 leave work out, for
// timing alone (sfhvae_disc_fwd_probe): 1 the exps, 2 the cross terms (each
// row's first z2 value stands in for them).
template <int DP, int kProbe>
__global__ void __launch_bounds__(kThreads, 2) disc_fwd_kernel(
    const float* __restrict__ z2,       // [B, D]
    const float* __restrict__ mu2,      // [N, D]
    const void* __restrict__ seq_idx,   // [B], int64 (seq64) or int32
    int seq64,
    float* __restrict__ part,           // [3, n_chunks, B]: m, s, picked
    int B, int N, int D, int num_real, int row_offset, int chunk_tiles,
    int group_tiles, int n_chunks, int vec, float inv_two_var) {
  using L = FwdSmem<DP>;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n_first = blockIdx.x * chunk_tiles * kNT;
  const int n_stop = min(N, n_first + chunk_tiles * kNT);
  const int tiles = (n_stop - n_first + kNT - 1) / kNT;
  const int b_first = blockIdx.y * group_tiles * kBT;
  const int b_stop = min(B, b_first + group_tiles * kBT);
  const int steps = tiles * ((b_stop - b_first + kBT - 1) / kBT);
  const long long plane = (long long)n_chunks * B;
  const int seq_bytes = seq64 ? 8 : 4;

  // table tile t of the chunk into raw buffer q, as it lies in mu2
  // (16-byte copies when mu2 is 16-byte aligned and D a multiple of 4)
  const auto copy_tile = [&](int t, int q) {
    float* raw = sm + L::raw + q * kNT * DP;
    const int n0 = n_first + t * kNT;
    const float* src = mu2 + (long long)n0 * D;
    const int total = min(kNT, n_stop - n0) * D;
    if (vec) {
      for (int i = 4 * tid; i < total; i += 4 * kThreads) {
        cp_async16(raw + i, src + i);
      }
    } else {
      for (int i = tid; i < total; i += kThreads) cp_async4(raw + i, src + i);
    }
  };
  // the batch tile at b0 into buffer q: z2 transposed into zT (its rows
  // past D stay zero), seq_idx as it lies in device memory
  const auto copy_batch = [&](int b0, int q) {
    float* zT = sm + L::zT + q * DP * kBT;
    const int cnt = min(kBT, b_stop - b0);
    const float* src = z2 + (long long)b0 * D;
    for (int i = tid; i < cnt * D; i += kThreads) {
      const int r = i / D;
      cp_async4(zT + (i - r * D) * kBT + r, src + i);
    }
    if (tid < cnt) {
      const char* from = static_cast<const char*>(seq_idx) +
                         (long long)(b0 + tid) * seq_bytes;
      float* to = sm + L::seq + q * 2 * kBT + tid * (seq_bytes / 4);
      if (seq64) {
        cp_async8(to, reinterpret_cast<const float*>(from));
      } else {
        cp_async4(to, reinterpret_cast<const float*>(from));
      }
    }
  };
  // raw buffer q (table tile t) into muT and shift q: threads 0 .. kNT - 1
  const auto stage_table = [&](int t, int q) {
    if (tid < kNT) {
      const int n0 = n_first + t * kNT;
      const bool in_tile = tid < n_stop - n0;
      stage_table_row<DP>(sm + L::raw + q * kNT * DP + tid * D, in_tile,
                          in_tile && row_offset + n0 + tid < num_real, D, tid,
                          inv_two_var, sm + L::muT + q * DP * kNT, nullptr,
                          sm + L::shift + q * kNT);
    }
  };

  // zT's rows past D, which no copy writes, hold zeros
  for (int i = tid; i < 2 * DP * kBT; i += kThreads) {
    if ((i / kBT) % DP >= D) sm[L::zT + i] = 0.0f;
  }
  copy_tile(0, 0);
  if (tiles > 1) copy_tile(1, 1);
  copy_batch(b_first, 0);
  cp_async_wait_all();
  __syncthreads();
  stage_table(0, 0);
  __syncthreads();

  float m[4], s[4], picked[4];
  int yl[4];  // the rows' picks as rows of this shard, or -1
  for (int step = 0; step < steps; ++step) {
    const int t = step % tiles;
    const int bi = step / tiles;
    const int b0 = b_first + bi * kBT;
    const int tb = tiles > 1 ? step & 1 : 0;  // this step's table buffer
    const int zb = bi & 1;                    // and batch buffer

    // the tiles of later steps: the table tile after next on its way into
    // raw, the next one staged from raw; the next batch tile on its way
    if (tiles > 1 && step + 2 < steps) copy_tile((t + 2) % tiles, step & 1);
    if (step + 1 < steps && t == tiles - 1) copy_batch(b0 + kBT, zb ^ 1);
    if (tiles > 1 && step + 1 < steps) stage_table((t + 1) % tiles, tb ^ 1);

    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        m[i] = kNegInf;
        s[i] = 0.0f;
        picked[i] = 0.0f;
        yl[i] = local_row(sm + L::seq + zb * 2 * kBT, seq64, 4 * ty + i,
                          row_offset, N);
      }
    }

    float cr[4][8];
    if constexpr (kProbe == 2) {  // each row's first z2 value in place
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float z = sm[L::zT + zb * DP * kBT + 4 * ty + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) cr[i][j] = z;
      }
    } else {
      cross_tile<DP>(sm + L::zT + zb * DP * kBT, sm + L::muT + tb * DP * kNT,
                     tx, ty, cr);
    }
    float sh[2][4];  // the shifts of the columns tile_col(tx, j)
    lds4(sm + L::shift + tb * kNT + 4 * tx, sh[0]);
    lds4(sm + L::shift + tb * kNT + 64 + 4 * tx, sh[1]);
    const int tile_first = n_first + t * kNT;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // the picked row as a column of this tile, and then as j of
      // tile_col(tx, j); no column matches when it lies elsewhere
      const int y = yl[i] - tile_first;
      float l[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        l[j] = tile_logit(inv_two_var, cr[i][j], sh[j / 4][j % 4]);
      }
      float mt = l[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mt = fmaxf(mt, l[j]);
      const float mn = fmaxf(m[i], mt);
      const auto ex = [](float x) { return kProbe == 1 ? x : expf(x); };
      float e = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) e += ex(l[j] - mn);
      s[i] = fmaf(s[i], ex(m[i] - mn), e);
      m[i] = mn;
      if (y >= 0 && y < kNT) {  // the row's pick lies in this tile
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          picked[i] = tile_col(tx, j) == y ? l[j] : picked[i];
        }
      }
    }

    if (t == tiles - 1) {
      // the chunk is done for this batch tile: merge the 16 lanes of each
      // row in a fixed tree, then lane 0 writes the row's partial
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) {
          const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
          const float s2 = __shfl_xor_sync(0xffffffffu, s[i], off);
          const float p2 = __shfl_xor_sync(0xffffffffu, picked[i], off);
          const float mn = fmaxf(m[i], m2);
          s[i] = fmaf(s[i], expf(m[i] - mn), s2 * expf(m2 - mn));
          m[i] = mn;
          picked[i] += p2;
        }
        const int b = b0 + 4 * ty + i;
        if (tx == 0 && b < b_stop) {
          const long long o = (long long)blockIdx.x * B + b;
          part[o] = m[i];
          part[plane + o] = s[i];
          part[2 * plane + o] = picked[i];
        }
      }
    }
    if (step + 1 == steps) break;
    cp_async_wait_all();  // this thread's copies for the next steps
    __syncthreads();      // everyone's, and every read of this step's tiles
  }
}

// One row's chunk partials merged in chunk order: m* = max m,
// s* = sum s e^(m - m*), picked* = sum picked. The loads go 8 chunks at a
// time, so that a row waits for memory once per 8 chunks.
__device__ __forceinline__ void merge_chunks(const float* __restrict__ part,
                                             int b, int B, int C, float& m,
                                             float& s, float& picked) {
  constexpr int kBatch = 8;
  const long long plane = (long long)C * B;
  m = kNegInf;
  for (int c0 = 0; c0 < C; c0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      v[k] = c0 + k < C ? part[(long long)(c0 + k) * B + b] : kNegInf;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) m = fmaxf(m, v[k]);
  }
  s = 0.0f;
  picked = 0.0f;
  for (int c0 = 0; c0 < C; c0 += kBatch) {
    float vm[kBatch], vs[kBatch], vp[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const bool ok = c0 + k < C;
      const long long o = (long long)(c0 + k) * B + b;
      vm[k] = ok ? part[o] : m;
      vs[k] = ok ? part[plane + o] : 0.0f;
      vp[k] = ok ? part[2 * plane + o] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < C) {
        s += vs[k] * expf(vm[k] - m);
        picked += vp[k];
      }
    }
  }
}

__global__ void disc_combine_kernel(const float* __restrict__ part,
                                    float* __restrict__ out,
                                    float* __restrict__ lse_out, int B,
                                    int C) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float m, s, picked;
  merge_chunks(part, b, B, C, m, s, picked);
  const float lse = m + logf(s);
  out[b] = picked - lse;
  if (lse_out != nullptr) lse_out[b] = lse;
}

// The sharded form's merge: it stops at this shard's (m, s, picked) per row.
__global__ void disc_merge_kernel(const float* __restrict__ part,
                                  float* __restrict__ m_out,
                                  float* __restrict__ s_out,
                                  float* __restrict__ p_out, int B, int C) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float m, s, picked;
  merge_chunks(part, b, B, C, m, s, picked);
  m_out[b] = m;
  s_out[b] = s;
  p_out[b] = picked;
}

// The partials pass over a grid of n_chunks x n_groups blocks.
template <int kProbe = 0>
cudaError_t launch_partials(cudaStream_t st, const void* z2, const void* mu2,
                            const void* seq_idx, int seq64, void* part, int B,
                            int N, int D, int num_real, int row_offset,
                            int chunk_tiles, int n_chunks, int group_tiles,
                            int n_groups, float inv_two_var) {
  if (D < 1 || D > kMaxD || chunk_tiles < 1 || group_tiles < 1 || B < 1 ||
      N < 1) {
    return cudaErrorInvalidValue;
  }
  const int vec =
      reinterpret_cast<std::uintptr_t>(mu2) % 16 == 0 && D % 4 == 0;
  const dim3 grid(n_chunks, n_groups);
  const auto run = [&](auto kernel, size_t smem) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(z2), static_cast<const float*>(mu2),
        seq_idx, seq64, static_cast<float*>(part), B, N, D, num_real,
        row_offset, chunk_tiles, group_tiles, n_chunks, vec, inv_two_var);
    return cudaGetLastError();
  };
  return D <= 8    ? run(disc_fwd_kernel<8, kProbe>, FwdSmem<8>::bytes)
         : D <= 16 ? run(disc_fwd_kernel<16, kProbe>, FwdSmem<16>::bytes)
                   : run(disc_fwd_kernel<32, kProbe>, FwdSmem<32>::bytes);
}

}  // namespace

extern "C" {

int sfhvae_disc_max_dim() { return kMaxD; }

// z2: [B, D] fp32; mu2: [N, D] fp32; seq_idx: [B] int64 (seq64 = 1) or int32
// (seq64 = 0); part: [3, n_chunks, B] fp32 scratch; out: [B] fp32; lse: [B]
// fp32 or null. D <= sfhvae_disc_max_dim(); B, N >= 1. The geometry
// (ops/discriminative.py: fwd_geometry): chunk c holds table rows
// [c * chunk_tiles * 128, ...), group q batch rows [q * group_tiles * 64,
// ...), none empty. Returns the cudaError_t of the launches.
int sfhvae_disc_fwd(const void* z2, const void* mu2, const void* seq_idx,
                    int seq64, void* part, void* out, void* lse, int B, int N,
                    int D, int num_real, int chunk_tiles, int n_chunks,
                    int group_tiles, int n_groups, float inv_two_var,
                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_partials(
      st, z2, mu2, seq_idx, seq64, part, B, N, D, num_real, 0, chunk_tiles,
      n_chunks, group_tiles, n_groups, inv_two_var);
  if (e != cudaSuccess) return e;
  disc_combine_kernel<<<(B + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out),
      static_cast<float*>(lse), B, n_chunks);
  return cudaGetLastError();
}

// The sharded form: mu2 is one rank's shard [N, D] whose first row is global
// row row_offset; num_real counts the real rows of the whole table; seq_idx
// holds global rows. part as above; m_out, s_out, p_out: [B] fp32, this
// shard's online max, rescaled sum and picked logit.
int sfhvae_disc_partials(const void* z2, const void* mu2, const void* seq_idx,
                         int seq64, void* part, void* m_out, void* s_out,
                         void* p_out, int B, int N, int D, int num_real,
                         int row_offset, int chunk_tiles, int n_chunks,
                         int group_tiles, int n_groups, float inv_two_var,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_partials(
      st, z2, mu2, seq_idx, seq64, part, B, N, D, num_real, row_offset,
      chunk_tiles, n_chunks, group_tiles, n_groups, inv_two_var);
  if (e != cudaSuccess) return e;
  disc_merge_kernel<<<(B + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(m_out),
      static_cast<float*>(s_out), static_cast<float*>(p_out), B, n_chunks);
  return cudaGetLastError();
}

// The partials pass of sfhvae_disc_fwd alone (probe 0), or a variant of it
// that leaves work out (probe 1, 2: see disc_fwd_kernel), for timing.
int sfhvae_disc_fwd_probe(const void* z2, const void* mu2, const void* seq_idx,
                          int seq64, void* part, int B, int N, int D,
                          int num_real, int chunk_tiles, int n_chunks,
                          int group_tiles, int n_groups, float inv_two_var,
                          int probe, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto launch) {
    return launch(st, z2, mu2, seq_idx, seq64, part, B, N, D, num_real, 0,
                  chunk_tiles, n_chunks, group_tiles, n_groups, inv_two_var);
  };
  return probe == 1   ? run(launch_partials<1>)
         : probe == 2 ? run(launch_partials<2>)
                      : run(launch_partials<0>);
}

}  // extern "C"
