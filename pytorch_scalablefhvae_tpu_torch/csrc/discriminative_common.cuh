// What the discriminative forward (discriminative_fwd.cu) and backward
// (discriminative_bwd.cu) share: the table-tile staging and the 64 x 128
// cross-term micro-tile from which both compute their logits
//   logits[b, n] = 2c z2[b].mu2[n] + shift[n],
//   shift[n] = bias[n] - c |mu2[n]|^2,
// c = 1 / (2 sigma^2), bias = -1e30 on padded rows (row_offset + n >=
// num_real) and past the table (it absorbs the rest in fp32, so their logit
// is -1e30 exactly). The squared norm and the cross term are each summed by
// fmaf in k order from 0, and shift and the logit are each one explicit
// fmaf, so the forward's logits are the same bits as the ones the backward
// recomputes against the saved log-sum-exp.
//
// Tiles: 64 batch rows by 128 table rows, 256 threads. Thread (tx, ty) =
// (tid % 16, tid / 16) owns the batch rows 4 ty .. 4 ty + 3 and the table
// columns 4 tx .. 4 tx + 3 and 64 + 4 tx .. 64 + 4 tx + 3 of a tile: the 16
// threads of a batch row are 16 neighbouring lanes of one warp.

#pragma once

#include <cuda_runtime.h>

namespace disc {

constexpr int kThreads = 256;
constexpr int kBT = 64;               // batch rows of a tile
constexpr int kNT = 128;              // table rows of a tile
constexpr int kMaxD = 32;             // the widest z2 the kernels take
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// Adds a value over the kSplit neighbouring lanes (kSplit a power of two)
// in a fixed tree; every lane of the group gets the same bits.
template <int kSplit>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// seq_idx[b], stored as int64 (seq64) or int32, as this shard's row: the
// global row less row_offset, or -1 when it is not one of the shard's n rows
// (an index outside the table, or a row another shard owns).
__device__ __forceinline__ int local_row(const void* seq_idx, int seq64,
                                         long long b, int row_offset, int n) {
  const long long y =
      (seq64 ? static_cast<const long long*>(seq_idx)[b]
             : static_cast<long long>(static_cast<const int*>(seq_idx)[b])) -
      row_offset;
  return y >= 0 && y < n ? static_cast<int>(y) : -1;
}

// Table row r of a tile into shared memory, read from row (global memory or
// a shared copy of the tile; zeros past D and when the row is not in the
// tile): transposed into muT [DP][kNT], as a 16-byte row into muR [kNT]
// [DP + 4] when muR is given, and its logit shift into shift [kNT] (with
// the bias -1e30 unless real, i.e. in the tile and not padding).
template <int DP>
__device__ __forceinline__ void stage_table_row(const float* row,
                                                bool in_tile, bool real,
                                                int D, int r,
                                                float inv_two_var, float* muT,
                                                float* muR, float* shift) {
  float v[DP];
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < DP; ++k) {
    v[k] = (in_tile && k < D) ? row[k] : 0.0f;
    s = fmaf(v[k], v[k], s);
    muT[k * kNT + r] = v[k];
  }
  if (muR != nullptr) {
#pragma unroll
    for (int k = 0; k < DP; k += 4) {
      *reinterpret_cast<float4*>(muR + r * (DP + 4) + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    }
  }
  shift[r] = fmaf(-inv_two_var, s, real ? 0.0f : kNegInf);
}

// The 64 x 128 cross terms of a tile pair as thread (tx, ty)'s 4 x 8
// micro-tile: cr[i][j] for batch row 4 ty + i and table column 4 tx + j
// (j < 4) or 64 + 4 tx + j - 4 (j >= 4); zT [DP][kBT], muT [DP][kNT].
template <int DP>
__device__ __forceinline__ void cross_tile(const float* zT, const float* muT,
                                           int tx, int ty,
                                           float (&cr)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) cr[i][j] = 0.0f;
  }
#pragma unroll 4
  for (int k = 0; k < DP; ++k) {
    float zv[4], m0[4], m1[4];
    lds4(zT + k * kBT + ty * 4, zv);
    lds4(muT + k * kNT + tx * 4, m0);
    lds4(muT + k * kNT + 64 + tx * 4, m1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cr[i][j] = fmaf(zv[i], m0[j], cr[i][j]);
        cr[i][j + 4] = fmaf(zv[i], m1[j], cr[i][j + 4]);
      }
    }
  }
}

// Table column n of micro-tile column j (see cross_tile).
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j < 4 ? 0 : 64 - 4) + tx * 4 + j;
}

// The logit of a cross term: 2c cross + shift, one rounding.
__device__ __forceinline__ float tile_logit(float inv_two_var, float cross,
                                            float shift) {
  return fmaf(2.0f * inv_two_var, cross, shift);
}

}  // namespace disc
