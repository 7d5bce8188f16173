// Two-layer LSTM forward recurrence for the FHVAE stacks, the tensor-core
// form: bf16 operands at H = 128 (sm_90a).
//
// Replaces two TPU kernels of pytorch_scalablefhvae_tpu/ops/lstm_pallas.py:
//   - _fwd_kernel_p / _fwd_call_p (entry lstm2_pallas_tm_proj): the layer-1
//     input projection x W1x runs inside the call, plus an additive gate
//     block xgc that is one row per batch row (z1 encoder) or one broadcast
//     row (z2 encoder);
//   - _fwd_kernel / _fwd_call (entry lstm2_pallas_tm): precomputed layer-1
//     gates with a time stride; stride 0 is the decoder's const mode.
// For training it also writes what the backward kernels read: resid
// [T, B, 3H] = h1 | c1 | c2 per step (the TPU kernel's _fwd_tail residual
// stream), beside tops. fp32 operands and other widths take the FMA form in
// lstm2_fwd_fma.cu.
//
// What bounds it on the H100: not bytes and not operations (29 GFLOP a call
// at B 2048, 0.02 ms of tensor-core time) but the latency of T dependent
// steps, each a [rows, 3H] x [3H, 4H] product followed by the cell. The FMA
// form reads the 3 x 128 x 512 recurrent weights from L2 at every step and
// multiplies on the CUDA cores; that is 50 times the bound.
//
// What the design does about it. The TPU kernel walks a sequential grid over
// (batch tile, t) with the weights resident in VMEM and the projection fused
// so that the gate tensor never reaches HBM. Here:
//
//   A. input products outside the recurrence (proj entry only,
//      lstm2_fwd_xproj_kernel): XP = x W1x + xgc for all T*B rows at once,
//      mma.sync.m16n8k16 (bf16 operands, fp32 accumulate), written as a
//      [T, B, 4H] fp32 stream. It stays fp32 because _make_ref_dot rounds the
//      operands of a product, never its result. The stream exists because
//      W1x's columns for a block (D x 256 bf16, 40 KB at D 80) do not fit
//      beside the recurrent weights in the chain's shared memory, and because
//      nothing in it depends on the recurrence: 84 MB written and read at
//      B 2048, 0.05 ms at the card's memory rate, against a product that
//      would otherwise sit inside each of the T dependent steps. The decoder
//      entry has no pass A: the chain reads its [B, 4H] block (time stride 0)
//      or its [T, B, 4H] gates as they lie.
//   B. the chain (lstm2_fwd_chain_kernel). W1h, W2x and W2h are 384 KB in
//      bf16, more than one SM's shared memory, so a cluster of two blocks
//      owns 16 or 32 batch rows and splits the weights by hidden unit: block
//      `rank` keeps the 4 x 64 gate columns of units [64 rank, 64 rank + 64)
//      of all three blocks (192 KB) in shared memory for all T steps, read
//      from the fp32 parameters as they lie and rounded while staged. No
//      weight is read again after the prologue. The thread that holds the
//      mma accumulators of (row, unit) for the gates i, f, g, o also runs the
//      cell of that pair, so c1 and c2 never leave its registers. The new h
//      of a block's 64 units is rounded to bf16 and written into the operand
//      tile [rows, h1 | h2] of both blocks (its own, and its partner's
//      through distributed shared memory); the tiles are double-buffered, so
//      one cluster barrier a step orders both the exchange and the reuse.
//      The two layers run one step apart: layer 1 at step t and layer 2 at
//      step t - 1 both need only h1[t-1] and h2[t-2], so a phase is one
//      stacked product [h1 | h2] [[W1h, W2x], [0, W2h]] and the call has
//      T + 1 phases, not 2 T dependent products. The next phase's layer-1
//      gates are loaded into registers, and this phase's outputs stored,
//      between the two halves of the barrier, so the loads are in flight
//      while the barrier and the next products run.
//      Rows per cluster follow B so that the grid is one wave of the card
//      where it can be: 16 rows (one mma row tile) up to 66 clusters, 32
//      rows (two row tiles sharing each weight fragment) above. A ragged
//      last cluster is masked. A row's values do not depend on the rows it
//      shares a tile with, nor on the tile height.
// Instantiations without resid (serving) and without tops (the encoders)
// write nothing they do not return. No atomics: two launches give the same
// bits.
//
// Rounding follows _make_ref_dot: both operands of every product (weights,
// h, x) rounded to bf16, fp32 products and sums, fp32 gates, cells and
// carries; tops, h2 and resid are written from the unrounded fp32 values.
// bf16 x bf16 products are exact in fp32, so against the FMA form only the
// order of the fp32 sums differs.

#include <algorithm>
#include <cstdint>

#include "lstm2_common.cuh"
#include "lstm2_mma.cuh"

namespace {

using namespace lstm2;

constexpr int kH = kTcH;       // the hidden width this form takes
constexpr int kH4 = 4 * kH;
constexpr int kMaxD = kTcMaxD; // widest input of the fused projection
constexpr int kThreads = 256;  // both kernels: 8 warps
constexpr int kBatch = 8;      // global loads a thread keeps in flight when it
                               // stages a tile: one L2 round trip per batch

// ------------------------------------------- pass A: the input projection

constexpr int kPM = 64;                  // rows per tile
constexpr int kPN = 128;                 // gate columns per block
constexpr int kPPa = kMaxD + 8;          // pitches (elements): 16 bytes past
constexpr int kPPw = kPN + 8;            // a multiple of 128, no bank conflict
constexpr size_t kProjSmem =
    sizeof(__nv_bfloat16) * (kPM * kPPa + kMaxD * kPPw);

// out[r] = x[r] w1x + add[(r mod B) * add_rs], rows r < R = T * B, D a
// multiple of 16. grid (walkers, 4H / kPN). A block keeps its 128-column
// slice of W1x in shared memory (rounded as it is loaded, once) and walks
// over 64-row tiles of x, which it rounds on the way in. Warps 2 (rows) x 4
// (columns), 32 x 32 each.
__global__ void __launch_bounds__(kThreads, 2)
lstm2_fwd_xproj_kernel(const float* __restrict__ x,
                       const float* __restrict__ w1x,
                       const float* __restrict__ add, long long add_rs,
                       float* __restrict__ out, int R, int B, int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ws = As + kPM * kPPa;
  const int n0 = blockIdx.y * kPN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, tig = lane & 3;

  for (int e0 = tid; e0 < D * (kPN / 4); e0 += kThreads * kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kThreads;
      if (e < D * (kPN / 4)) {
        const int k = e / (kPN / 4);
        const int c = (e - k * (kPN / 4)) * 4;
        v[j] = *reinterpret_cast<const float4*>(w1x + (long long)k * kH4 +
                                                n0 + c);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kThreads;
      if (e < D * (kPN / 4)) {
        const int k = e / (kPN / 4);
        const int c = (e - k * (kPN / 4)) * 4;
        *reinterpret_cast<uint2*>(Ws + k * kPPw + c) = pack_bf16(v[j]);
      }
    }
  }

  const int D4 = D / 4;
  const int tiles = (R + kPM - 1) / kPM;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * kPM;
    for (int e0 = tid; e0 < kPM * D4; e0 += kThreads * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + j * kThreads;
        v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (e < kPM * D4) {
          const int row = e / D4;
          if (r0 + row < R) {
            v[j] = *reinterpret_cast<const float4*>(
                x + (long long)(r0 + row) * D + (e - row * D4) * 4);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + j * kThreads;
        if (e < kPM * D4) {
          const int row = e / D4;
          *reinterpret_cast<uint2*>(As + row * kPPa + (e - row * D4) * 4) =
              pack_bf16(v[j]);
        }
      }
    }
    __syncthreads();  // the tile (and, the first time, the weights) is staged

    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nb][i] = 0.0f;
      }
    }
    const uint32_t a_lane = smem_addr(
        As + (wm * 32 + (lane & 15)) * kPPa + (lane >> 4) * 8);
    const uint32_t w_lane = smem_addr(
        Ws + (lane & 15) * kPPw + wn * 32 + (lane >> 4) * 8);
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldsm(a[mt], a_lane + 2 * (mt * 16 * kPPa + ks * 16));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        ldsm_t(b[np], w_lane + 2 * (ks * 16 * kPPw + np * 16));
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          mma(acc[mt][nb], a[mt], b[nb >> 1][(nb & 1) * 2],
              b[nb >> 1][(nb & 1) * 2 + 1]);
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wm * 32 + mt * 16 + g + 8 * h;
        if (r < R) {
          const float* ad = add + (long long)(r % B) * add_rs;
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const int col = n0 + wn * 32 + nb * 8 + 2 * tig;
            const float2 av = *reinterpret_cast<const float2*>(ad + col);
            *reinterpret_cast<float2*>(out + (long long)r * kH4 + col) =
                make_float2(acc[mt][nb][2 * h] + av.x,
                            acc[mt][nb][2 * h + 1] + av.y);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the tile before the next one
  }
}

// --------------------------------------------------------- pass B: chain

constexpr int kUnits = 64;             // hidden units per block of the pair
constexpr int kRowBytes = 4 * kUnits * 2;  // a bf16 row of a weight slice
                                       // [k][gate][64 units] and of an
                                       // operand tile [row][h1 | h2]: 512
constexpr int kSliceBytes = kH * kRowBytes;   // one weight block's columns
constexpr int kStage = 16;             // loads in flight in the prologue
constexpr int kMaxClusters16 = 66;     // 16-row clusters the 132 SMs hold at
                                       // once; more rows take 32-row clusters
static_assert(kH * (kRowBytes / 8) % (kThreads * kStage) == 0,
              "the chain's weight staging runs in whole batches");

constexpr size_t chain_smem(int row_tiles) {
  return 3 * (size_t)kSliceBytes + 2 * (size_t)(16 * row_tiles) * kRowBytes;
}

// Byte offset of 16-byte chunk `chunk` of row `row` in an array of 512-byte
// rows, swizzled so that ldmatrix's eight rows of one chunk fall into eight
// different bank groups.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * kRowBytes + ((chunk ^ (row & 7)) << 4));
}

struct ChainArgs {
  const float* xadd;   // layer-1 gates without the recurrent part, read at
  long long xadd_ts;   // xadd[t * xadd_ts + row * xadd_rs + col]
  long long xadd_rs;
  const float* w1h;    // [H, 4H]
  const float* w2x;
  const float* w2h;
  const float* b2;     // [4H]
  float* tops;         // [T, B, H]   (kTops)
  float* h2_out;       // [B, H]
  float* resid;        // [T, B, 3H]  (kResid)
  int T;
  int B;
};

// grid 2 * ceil(B / (16 kMT)): a cluster of two blocks per 16 kMT rows;
// block `rank` owns hidden units [64 rank, 64 rank + 64) of both layers.
// Warp w owns 8 of them, lane (g, tig) the pairs rows {g, g + 8} (+ 16 per
// row tile) x units 8 w + 2 tig + {0, 1}: the layout of an mma accumulator,
// one accumulator per gate. kProbe is 0 in every kernel a forward call
// launches; the timing entry instantiates it as a set of bits: 1 no global
// traffic in the loop, 2 no products (cells, exchange and barriers alone).
template <int kMT, bool kTops, bool kResid, int kProbe>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
lstm2_fwd_chain_kernel(const ChainArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kRows = 16 * kMT;
  constexpr uint32_t kTileBytes = kRows * kRowBytes;
  const uint32_t s_w = smem_addr(smem_raw);    // W1h | W2x | W2h columns
  const uint32_t s_t = s_w + 3 * kSliceBytes;  // two operand tiles
  const uint32_t rank = cluster_rank();
  const uint32_t r_t = map_to_rank(s_t, rank ^ 1);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int T = p.T, B = p.B;
  const int row0 = (blockIdx.x >> 1) * kRows;
  const int u = (int)rank * kUnits + warp * 8 + 2 * tig;
  constexpr bool traffic = (kProbe & 1) == 0;
  constexpr bool products = (kProbe & 2) == 0;

  // the block's columns of the three weight blocks, rounded as they are
  // loaded: local column gate * 64 + j holds column gate * H + 64 rank + j
  {
    const float* src[3] = {p.w1h, p.w2x, p.w2h};
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      // kH rows of 64 float4 per block, a multiple of the batch
      for (int e0 = tid; e0 < kH * (kRowBytes / 8); e0 += kThreads * kStage) {
        float4 v[kStage];
#pragma unroll
        for (int j = 0; j < kStage; ++j) {
          const int e = e0 + j * kThreads;
          const int k = e >> 6, q = e & 63;
          v[j] = *reinterpret_cast<const float4*>(
              src[m] + (long long)k * kH4 + (q >> 4) * kH +
              (int)rank * kUnits + (q & 15) * 4);
        }
#pragma unroll
        for (int j = 0; j < kStage; ++j) {
          const int e = e0 + j * kThreads;
          const int k = e >> 6, q = e & 63;
          *reinterpret_cast<uint2*>(smem_raw + m * kSliceBytes +
                                    swz(k, q >> 1) + (q & 1) * 8) =
              pack_bf16(v[j]);
        }
      }
    }
    // h1[-1] = h2[-1] = h2[-2] = 0: both tiles start as zeros
    for (int e = tid; e < 2 * (int)kTileBytes / 16; e += kThreads) {
      *reinterpret_cast<uint4*>(smem_raw + 3 * kSliceBytes + 16 * e) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }

  bool ok[kMT][2];
  long long rowi[kMT][2];  // row index within a step, per row tile and half
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rowi[mt][h] = row0 + 16 * mt + g + 8 * h;
      ok[mt][h] = traffic && rowi[mt][h] < B;
    }
  }
  float b2r[4][2];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = *reinterpret_cast<const float2*>(p.b2 + k * kH + u);
    b2r[k][0] = v.x, b2r[k][1] = v.y;
  }

  // [mt][gate][2 * (row half) + (unit of the pair)]: the layout of the
  // accumulators. xin: the layer-1 gates of the coming step without their
  // recurrent part
  float xin[kMT][4][4];
  float c1[kMT][4], c2[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) c1[mt][q] = c2[mt][q] = 0.0f;
  }

  // Loads xin for step t. Issued a phase ahead, so the loads are in flight
  // while the barrier and the products run.
  auto load_gates = [&](int t) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* src =
            p.xadd + t * p.xadd_ts + rowi[mt][h] * p.xadd_rs + u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float2 v = make_float2(0.0f, 0.0f);
          if (ok[mt][h] && t < T) {
            v = *reinterpret_cast<const float2*>(src + k * kH);
          }
          xin[mt][k][2 * h] = v.x, xin[mt][k][2 * h + 1] = v.y;
        }
      }
    }
  };

  // per-lane ldmatrix addresses: operand tile rows lane % 16 (+ 16 per row
  // tile), chunk parity lane / 16; weight rows k = lane % 16 of a depth-16
  // step, lanes 16-31 one gate further
  const int key = lane & 7;
  const uint32_t a_lane = (lane & 15) * kRowBytes;
  const uint32_t w_lane = s_w + (lane & 15) * kRowBytes;
  const int w_chunk = (lane >> 4) * 8 + warp;  // gate (lane / 16), units 8 w

  load_gates(0);
  // the weights and the zeroed tiles are in place in both blocks before
  // either writes into its partner
  cluster_arrive();
  cluster_wait();

  // Phase ph holds layer 1 at step ph and layer 2 at step ph - 1; it reads
  // tile ph % 2 (h1[ph-1] | h2[ph-2]) and writes tile (ph + 1) % 2.
  for (int ph = 0; ph <= T; ++ph) {
    const bool v1 = ph < T, v2 = ph >= 1;
    const uint32_t cur = s_t + (ph & 1) * kTileBytes;
    const uint32_t nxt = ((ph + 1) & 1) * kTileBytes;

    float acc1[kMT][4][4], acc2[kMT][4][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc1[mt][k][i] = acc2[mt][k][i] = 0.0f;
      }
    }
    // [acc1 | acc2] += [h1 | h2] [[W1h, W2x], [0, W2h]]
    if (products) {
#pragma unroll
      for (int ks = 0; ks < kH / 16; ++ks) {
        uint32_t a1[kMT][4], a2[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const uint32_t at = cur + mt * 16 * kRowBytes + a_lane;
          ldsm(a1[mt], at + (((2 * ks + (lane >> 4)) ^ key) << 4));
          ldsm(a2[mt], at + (((16 + 2 * ks + (lane >> 4)) ^ key) << 4));
        }
        const uint32_t wk = w_lane + ks * 16 * kRowBytes;
#pragma unroll
        for (int gp = 0; gp < 2; ++gp) {  // gates (i, f), then (g, o)
          const uint32_t off = ((gp * 16 + w_chunk) ^ key) << 4;
          uint32_t b1h[4], b2x[4], b2h[4];
          ldsm_t(b1h, wk + off);
          ldsm_t(b2x, wk + kSliceBytes + off);
          ldsm_t(b2h, wk + 2 * kSliceBytes + off);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              mma(acc1[mt][2 * gp + j], a1[mt], b1h[2 * j], b1h[2 * j + 1]);
              mma(acc2[mt][2 * gp + j], a1[mt], b2x[2 * j], b2x[2 * j + 1]);
              mma(acc2[mt][2 * gp + j], a2[mt], b2h[2 * j], b2h[2 * j + 1]);
            }
          }
        }
      }
    }

    // the cells of the thread's (row, unit) pairs, in registers
    float h1n[kMT][4], h2n[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        h1n[mt][q] = h2n[mt][q] = 0.0f;
        if (v1) {
          h1n[mt][q] = cell(xin[mt][0][q] + acc1[mt][0][q],
                            xin[mt][1][q] + acc1[mt][1][q],
                            xin[mt][2][q] + acc1[mt][2][q],
                            xin[mt][3][q] + acc1[mt][3][q], &c1[mt][q]);
        }
        if (v2) {
          h2n[mt][q] = cell(acc2[mt][0][q] + b2r[0][q & 1],
                            acc2[mt][1][q] + b2r[1][q & 1],
                            acc2[mt][2][q] + b2r[2][q & 1],
                            acc2[mt][3][q] + b2r[3][q & 1], &c2[mt][q]);
        }
      }
    }

    // the new h, rounded to bf16, into the next tile of both blocks
    if (ph < T) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * mt + g + 8 * h;
          const uint32_t o1 = nxt + swz(row, u >> 3) + (u & 7) * 2;
          const uint32_t v = pack_bf16(h1n[mt][2 * h], h1n[mt][2 * h + 1]);
          st_local_smem(s_t + o1, v);
          st_cluster(r_t + o1, v);
          if (v2) {
            const uint32_t o2 = nxt + swz(row, (kH + u) >> 3) + (u & 7) * 2;
            const uint32_t w = pack_bf16(h2n[mt][2 * h], h2n[mt][2 * h + 1]);
            st_local_smem(s_t + o2, w);
            st_cluster(r_t + o2, w);
          }
        }
      }
    }
    cluster_arrive();
    // Global traffic goes between the two halves of the barrier: this
    // phase's outputs, and the next phase's layer-1 gates.
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[mt][h]) continue;
        if (kResid && v1) {
          float* rs = p.resid + ((long long)ph * B + rowi[mt][h]) * (3 * kH) + u;
          *reinterpret_cast<float2*>(rs) =
              make_float2(h1n[mt][2 * h], h1n[mt][2 * h + 1]);
          *reinterpret_cast<float2*>(rs + kH) =
              make_float2(c1[mt][2 * h], c1[mt][2 * h + 1]);
        }
        if (v2) {
          const long long o = (long long)(ph - 1) * B + rowi[mt][h];
          const float2 hv = make_float2(h2n[mt][2 * h], h2n[mt][2 * h + 1]);
          if (kTops) *reinterpret_cast<float2*>(p.tops + o * kH + u) = hv;
          if (kResid) {
            *reinterpret_cast<float2*>(p.resid + o * (3 * kH) + 2 * kH + u) =
                make_float2(c2[mt][2 * h], c2[mt][2 * h + 1]);
          }
          if (ph == T) {
            *reinterpret_cast<float2*>(p.h2_out + rowi[mt][h] * kH + u) = hv;
          }
        }
      }
    }
    load_gates(ph + 1);
    cluster_wait();  // the h of all 128 units is in this block's next tile
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

int chain_row_tiles(int B) {
  return ceil_div(B, 16) <= kMaxClusters16 ? 1 : 2;
}

template <int kMT, bool kTops, bool kResid, int kProbe = 0>
cudaError_t launch_chain(const ChainArgs& a, cudaStream_t s) {
  const size_t smem = chain_smem(kMT);
  cudaError_t e =
      allow_smem(lstm2_fwd_chain_kernel<kMT, kTops, kResid, kProbe>, smem);
  if (e != cudaSuccess) return e;
  lstm2_fwd_chain_kernel<kMT, kTops, kResid, kProbe>
      <<<2 * ceil_div(a.B, 16 * kMT), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int kMT>
cudaError_t launch_chain_outputs(const ChainArgs& a, cudaStream_t s) {
  if (a.resid != nullptr) return launch_chain<kMT, true, true>(a, s);
  if (a.tops != nullptr) return launch_chain<kMT, true, false>(a, s);
  return launch_chain<kMT, false, false>(a, s);
}

template <int kMT>
cudaError_t launch_chain_probe(const ChainArgs& a, int probe, cudaStream_t s) {
  if (probe == 0) return launch_chain<kMT, true, true>(a, s);
  if (probe == 1) return launch_chain<kMT, true, true, 1>(a, s);
  if (probe == 3) return launch_chain<kMT, true, true, 3>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Whether the tensor-core forms, forward and backward, take hidden width H
// and input width D (0: no input).
int sfhvae_lstm2_tc_takes(int H, int D) { return tc_takes(H, D); }

// Batch rows a cluster of the chain owns at batch B (16 or 32).
int sfhvae_lstm2_fwd_cluster_rows(int B) { return 16 * chain_row_tiles(B); }

// The forward of both LSTM entries in bf16 operand mode, all on `stream`.
// x: [T, B, D] fp32 with xp a [T, B, 4H] fp32 scratch (pass A writes
// xp = x w1x + xadd[row * xadd_row_stride], the chain reads xp), or null:
// the chain reads xadd[t * xadd_t_stride + row * xadd_row_stride + col] as
// it lies. Weights fp32 as the parameters hold them; tops: [T, B, H] or null
// (must be given with resid); h2_out: [B, H]; resid: [T, B, 3H] or null.
// Every pointer 16-byte aligned.
// Returns the cudaError_t of the first launch that failed, or 0.
int sfhvae_lstm2_fwd(const void* x, const void* xadd, long long xadd_t_stride,
                     long long xadd_row_stride, const void* w1x,
                     const void* w1h, const void* w2x, const void* w2h,
                     const void* b2, void* xp, void* tops, void* h2_out,
                     void* resid, int T, int B, int D, int H, void* stream) {
  if (!tc_takes(H, x == nullptr ? 0 : D) ||
      (resid != nullptr && tops == nullptr) ||
      (x != nullptr && (xp == nullptr || D == 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ChainArgs a{static_cast<const float*>(xadd),
              xadd_t_stride,
              xadd_row_stride,
              static_cast<const float*>(w1h),
              static_cast<const float*>(w2x),
              static_cast<const float*>(w2h),
              static_cast<const float*>(b2),
              static_cast<float*>(tops),
              static_cast<float*>(h2_out),
              static_cast<float*>(resid),
              T,
              B};
  if (x != nullptr) {
    const int R = T * B;
    cudaError_t e = allow_smem(lstm2_fwd_xproj_kernel, kProjSmem);
    if (e != cudaSuccess) return e;
    // two blocks per SM, each keeping its weight slice for ~10 row tiles
    const int walkers = std::min(ceil_div(R, kPM), 66);
    lstm2_fwd_xproj_kernel<<<dim3(walkers, kH4 / kPN), kThreads, kProjSmem,
                             s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1x),
        static_cast<const float*>(xadd), xadd_row_stride,
        static_cast<float*>(xp), R, B, D);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    a.xadd = static_cast<const float*>(xp);
    a.xadd_ts = (long long)B * kH4;
    a.xadd_rs = kH4;
  }
  return chain_row_tiles(B) == 1 ? launch_chain_outputs<1>(a, s)
                                 : launch_chain_outputs<2>(a, s);
}

// Timing only: the chain alone on per-step gates xg [T, B, 4H] with tops,
// h2_out and resid written, as the decoder entry launches it under autograd
// (probe 0), or a variant of it that leaves work out (probe 1, 3: see
// lstm2_fwd_chain_kernel). No forward call launches these variants.
int sfhvae_lstm2_fwd_chain_probe(const void* xg, const void* w1h,
                                 const void* w2x, const void* w2h,
                                 const void* b2, void* tops, void* h2_out,
                                 void* resid, int T, int B, int probe,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ChainArgs a{static_cast<const float*>(xg),
              (long long)B * kH4,
              kH4,
              static_cast<const float*>(w1h),
              static_cast<const float*>(w2x),
              static_cast<const float*>(w2h),
              static_cast<const float*>(b2),
              static_cast<float*>(tops),
              static_cast<float*>(h2_out),
              static_cast<float*>(resid),
              T,
              B};
  return chain_row_tiles(B) == 1 ? launch_chain_probe<1>(a, probe, s)
                                 : launch_chain_probe<2>(a, probe, s);
}

}  // extern "C"
