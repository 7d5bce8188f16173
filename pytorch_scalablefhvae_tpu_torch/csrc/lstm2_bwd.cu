// Two-layer LSTM backward (reverse-time adjoint) for the FHVAE stacks, the
// tensor-core form: bf16 operands at H = 128 (sm_90a).
//
// Replaces two TPU kernels of pytorch_scalablefhvae_tpu/ops/lstm_pallas.py:
//   - _bwd_kernel_p / _bwd_call_p (the VJP of lstm2_pallas_tm_proj): dx,
//     dxgc, dW1x, dW1h, dW2x, dW2h, db2;
//   - _bwd_kernel / _bwd_call (the VJP of lstm2_pallas_tm): dxg1 (summed over
//     t in the decoder's const mode), dW1h, dW2x, dW2h, db2.
// Both read the residuals the forward kernel saved (resid = h1 | c1 | c2 per
// step, tops = h2 per step) and recompute the gates from them, as the TPU
// kernel does (_unpack_resid, _bwd_layer2). fp32 operands and other widths
// take the FMA form in lstm2_bwd_fma.cu.
//
// The TPU kernel walks time backwards on a sequential grid and does all of
// a step's work inside it. On the H100 only the carried chain (dh, dc) is
// sequential; the gate recompute reads nothing but saved residuals and the
// weight gradients read nothing but saved streams, so both are products over
// all T*B rows at once. The call is three passes on one stream, every product
// an mma.sync.m16n8k16 (bf16 operands, fp32 accumulate) fed by ldmatrix:
//
//   A. gates (lstm2_bwd_gates_kernel), bound by bytes: the two [T*B, 4H]
//      fp32 gate streams it writes outweigh what it reads.
//        G2 = [h1[t] | h2[t-1]] [W2x; W2h] + b2,
//        G1 = [x[t] | h1[t-1]] [W1x; W1h] + xadd   (t-1 views zero at t = 0)
//      A block keeps a 128-column slice of the stacked weights in shared
//      memory (rounded to bf16 as it is loaded, once) and walks over 64-row
//      tiles of the residuals, which it rounds to bf16 on the way in.
//   B. the chain (lstm2_bwd_chain_kernel), bound by the latency of T + 1
//      dependent phases, not by bytes or operations. Per step: the cell
//      adjoint of layer 2 (elementwise), the product dgates2 [16, 4H] x
//      [W2h^T | W2x^T], the cell adjoint of layer 1, the product dgates1
//      [16, 4H] x W1h^T. The three weight blocks (384 KB in bf16) exceed one
//      SM's shared memory, so a cluster of two blocks owns 16 batch rows and
//      each block holds the 64 hidden units' rows of the three blocks
//      (192 KB) for all T steps: no weight is read again after the prologue.
//      A thread owns the same (row, unit) pairs in the cell adjoint and in
//      the products' accumulators, so dh and dc never leave its registers.
//      Each block computes the dgates of its 64 units, rounds them to bf16
//      and writes them into its own operand tile and, through distributed
//      shared memory, into its partner's. The two layers run one step apart
//      (layer 1 at step t + 1 beside layer 2 at step t, which need nothing
//      of each other), so a phase has both cell adjoints, one exchange, one
//      cluster barrier on its critical path and both products; a second
//      barrier (the tiles may be written again) is arrived at after the
//      products and waited for only after the next cell adjoints. The next
//      phase's gates and cell states are loaded while the barrier and the
//      products run. The per-row sums over t that db2 and dxgc / dxg1 need
//      are carried in registers from the unrounded fp32 dgates; the dgates
//      streams go out in bf16, the operand form pass C needs.
//   C. weight gradients (lstm2_bwd_wgrad_kernel) and dx (lstm2_bwd_dx_kernel),
//      bound by bytes (the bf16 streams and the residuals, read once):
//        dW2x = sum h1[t]^T dg2[t],        dW2h = sum_{t>=1} h2[t-1]^T dg2[t],
//        dW1h = sum_{t>=1} h1[t-1]^T dg1[t], dW1x = sum x[t]^T dg1[t],
//      all four in one launch, the rows split into chunks whose partial
//      products a combine kernel adds in a fixed order; db2 and the bias-row
//      dxgc are column sums of pass B's per-row sums, rows in a fixed order.
// No floating-point atomics anywhere: two launches on the same inputs give
// the same bits.
//
// Rounding follows _make_bwd_fns: every product rounds both of its operands
// (dgates, weights, h, x) to bf16 and accumulates in fp32; the gate recompute
// rounds as the forward does; db2, dxgc and dxg1 sum the unrounded fp32
// dgates; the carries stay fp32. bf16 x bf16 products are exact in fp32, so
// the tensor cores change only the order of the fp32 sums.

#include <algorithm>
#include <cstdint>

#include "lstm2_common.cuh"
#include "lstm2_mma.cuh"

namespace {

using namespace lstm2;

constexpr int kH = kTcH;       // the hidden width this form takes
constexpr int kH4 = 4 * kH;
constexpr int kMaxD = kTcMaxD; // widest input of the fused projection
constexpr int kThreads = 256;  // every kernel below: 8 warps
constexpr int kBatch = 8;      // global loads a thread keeps in flight when it
                               // stages a tile: one L2 round trip per batch

// --------------------------------------------------------- pass A: gates

// out[r] = [a0[r - shift0] | a1[r - shift1]] [w0; w1] + add, rows r < R. A
// source row before the first (r < shift) reads as zero: the t-1 views at
// t = 0. add[t * add_ts + b * add_rs + col] with r = t * B + b.
struct GateJob {
  const float* a0;
  long long pitch0;
  int k0;
  int shift0;
  const float* a1;
  long long pitch1;
  int k1;
  int shift1;
  const float* w0;  // [k0, 4H]
  const float* w1;  // [k1, 4H]
  const float* add;
  long long add_ts;
  long long add_rs;
  float* out;       // [R, 4H]
};

struct GateJobs {
  GateJob job[2];
};

constexpr int kGM = 64;                  // rows per tile
constexpr int kGN = 128;                 // gate columns per block
constexpr int kGK = kMaxD + kH;          // deepest stacked product
constexpr int kGPa = kGK + 8;            // pitches (elements): 16 bytes past
constexpr int kGPw = kGN + 8;            // a multiple of 128, no bank conflict
constexpr size_t kGatesSmem =
    sizeof(__nv_bfloat16) * (kGM * kGPa + kGK * kGPw);

// grid (walkers, 4H / kGN, jobs). Warps 2 (rows) x 4 (columns), 32 x 32 each.
__global__ void __launch_bounds__(kThreads, 2)
lstm2_bwd_gates_kernel(const GateJobs jobs, int R, int B) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ws = As + kGM * kGPa;
  const GateJob& job = jobs.job[blockIdx.z];
  const int k0 = job.k0;
  const int K = k0 + job.k1;
  const int n0 = blockIdx.y * kGN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, tig = lane & 3;

  // the block's weight slice, rounded as it is loaded
  for (int e0 = tid; e0 < K * (kGN / 4); e0 += kThreads * kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kThreads;
      if (e < K * (kGN / 4)) {
        const int k = e / (kGN / 4);
        const int c = (e - k * (kGN / 4)) * 4;
        const float* src = k < k0 ? job.w0 + (long long)k * kH4
                                  : job.w1 + (long long)(k - k0) * kH4;
        v[j] = *reinterpret_cast<const float4*>(src + n0 + c);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kThreads;
      if (e < K * (kGN / 4)) {
        const int k = e / (kGN / 4);
        const int c = (e - k * (kGN / 4)) * 4;
        *reinterpret_cast<uint2*>(Ws + k * kGPw + c) = pack_bf16(v[j]);
      }
    }
  }

  const int K4 = K / 4;
  const int tiles = (R + kGM - 1) / kGM;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * kGM;
    for (int e0 = tid; e0 < kGM * K4; e0 += kThreads * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + j * kThreads;
        v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (e < kGM * K4) {
          const int row = e / K4;
          const int c = (e - row * K4) * 4;
          const int r = r0 + row;
          if (r < R) {
            if (c < k0) {
              if (r >= job.shift0) {
                v[j] = *reinterpret_cast<const float4*>(
                    job.a0 + (long long)(r - job.shift0) * job.pitch0 + c);
              }
            } else if (r >= job.shift1) {
              v[j] = *reinterpret_cast<const float4*>(
                  job.a1 + (long long)(r - job.shift1) * job.pitch1 +
                  (c - k0));
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + j * kThreads;
        if (e < kGM * K4) {
          const int row = e / K4;
          *reinterpret_cast<uint2*>(As + row * kGPa + (e - row * K4) * 4) =
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
        As + (wm * 32 + (lane & 15)) * kGPa + (lane >> 4) * 8);
    const uint32_t w_lane = smem_addr(
        Ws + (lane & 15) * kGPw + wn * 32 + (lane >> 4) * 8);
    for (int ks = 0; ks < K / 16; ++ks) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldsm(a[mt], a_lane + 2 * (mt * 16 * kGPa + ks * 16));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        ldsm_t(b[np], w_lane + 2 * (ks * 16 * kGPw + np * 16));
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
          const int t = r / B;
          const float* add =
              job.add + t * job.add_ts + (long long)(r - t * B) * job.add_rs;
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const int col = n0 + wn * 32 + nb * 8 + 2 * tig;
            const float2 ad = *reinterpret_cast<const float2*>(add + col);
            *reinterpret_cast<float2*>(job.out + (long long)r * kH4 + col) =
                make_float2(acc[mt][nb][2 * h] + ad.x,
                            acc[mt][nb][2 * h + 1] + ad.y);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the tile before the next one
  }
}

// --------------------------------------------------------- pass B: chain

constexpr int kCRows = 16;    // batch rows of a cluster: one mma row tile
constexpr int kCUnits = 64;   // hidden units per block of the pair
constexpr int kTileBytes = kCRows * kH4 * 2;   // a bf16 dgates operand tile
constexpr int kSliceBytes = kCUnits * kH4 * 2;  // one weight block's rows
constexpr size_t kChainSmem = 3 * kSliceBytes + 2 * kTileBytes;
static_assert(kCUnits * (kH4 / 4) % (kThreads * kBatch) == 0,
              "the chain's weight staging runs in whole batches");

// Byte offset of 16-byte chunk `chunk` of row `row` in a [rows][4H] bf16
// array whose rows are swizzled so that ldmatrix's eight rows of one chunk
// fall into eight different bank groups.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * (kH4 * 2) + ((chunk ^ (row & 7)) << 4));
}

struct ChainArgs {
  const float* g1;      // [T, B, 4H] layer-1 gates (pass A)
  const float* g2;      // [T, B, 4H] layer-2 gates
  const float* resid;   // [T, B, 3H]: h1 | c1 | c2
  const float* gtops;   // [T, B, H] or null (zero)
  const float* gh2;     // [B, H] or null (zero)
  const float* w1h;     // [H, 4H]
  const float* w2x;
  const float* w2h;
  __nv_bfloat16* dg1b;  // [T, B, 4H] dgates1, operand form
  __nv_bfloat16* dg2b;
  float* dg1f;          // fp32 dgates1 written over g1, or null
  float* rowsum1;       // [B, 4H] sum_t dgates1, or null
  float* rowsum2;       // [B, 4H] sum_t dgates2
  int T;
  int B;
  int probe;            // timing only, a set of bits: 1 no global traffic
                        // in the loop, 2 no products (cell adjoints,
                        // exchange and barriers alone)
};

// One step's inputs of one layer for the thread's four (row, unit) pairs
// p = 2 * (row half) + (unit of the pair).
struct StepIn {
  float g[4][4];  // gates [pair][i, f, g, o]
  float cp[4];    // c at t-1
  float gt[4];    // cotangent of h at t (layer 2)
};

// grid 2 * ceil(B / 16): a cluster of two blocks per 16 rows; block `rank`
// owns hidden units [64 rank, 64 rank + 64). Warp w owns 8 of them, lane
// (g, tig) the pairs rows {g, g + 8} x units 8 w + 2 tig + {0, 1}: the
// layout of an mma accumulator.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
lstm2_bwd_chain_kernel(const ChainArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t s_w = smem_addr(smem_raw);  // W2h | W2x | W1h rows
  const uint32_t s_a2 = s_w + 3 * kSliceBytes;
  const uint32_t s_a1 = s_a2 + kTileBytes;
  const uint32_t rank = cluster_rank();
  const uint32_t r_a2 = map_to_rank(s_a2, rank ^ 1);
  const uint32_t r_a1 = map_to_rank(s_a1, rank ^ 1);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int B = p.B;
  const int row0 = (blockIdx.x >> 1) * kCRows;
  const int u = (int)rank * kCUnits + warp * 8 + 2 * tig;
  const bool traffic = (p.probe & 1) == 0;
  const bool products = (p.probe & 2) == 0;

  // the block's rows of the three weight blocks, rounded as they are loaded
  {
    const float* src[3] = {p.w2h, p.w2x, p.w1h};
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      // kCUnits * kH4 / 4 float4 per block, a multiple of the batch
      for (int e0 = tid; e0 < kCUnits * (kH4 / 4); e0 += kThreads * kBatch) {
        float4 v[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int e = e0 + j * kThreads;
          v[j] = *reinterpret_cast<const float4*>(
              src[m] + (long long)((int)rank * kCUnits) * kH4 + 4 * e);
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int e = e0 + j * kThreads;
          const int n = e / (kH4 / 4);
          const int c4 = e - n * (kH4 / 4);
          *reinterpret_cast<uint2*>(smem_raw + m * kSliceBytes +
                                    swz(n, c4 >> 1) + (c4 & 1) * 8) =
              pack_bf16(v[j]);
        }
      }
    }
  }

  bool ok[2];
  long long rowi[2];  // row index within a step, per row half
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rowi[h] = row0 + g + 8 * h;
    ok[h] = traffic && rowi[h] < B;
  }

  float dh1[4], dh2[4], dc1[4], dc2[4], c1cur[4], c2cur[4];
  float s1[4][4], s2[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dh1[q] = dh2[q] = dc1[q] = dc2[q] = c1cur[q] = c2cur[q] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) s1[q][k] = s2[q][k] = 0.0f;
  }
  const int T = p.T;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (ok[h]) {
      const long long o = (long long)(T - 1) * B + rowi[h];
      const float2 c1v =
          *reinterpret_cast<const float2*>(p.resid + o * (3 * kH) + kH + u);
      const float2 c2v = *reinterpret_cast<const float2*>(
          p.resid + o * (3 * kH) + 2 * kH + u);
      c1cur[2 * h] = c1v.x, c1cur[2 * h + 1] = c1v.y;
      c2cur[2 * h] = c2v.x, c2cur[2 * h + 1] = c2v.y;
      if (p.gh2 != nullptr) {
        const float2 v =
            *reinterpret_cast<const float2*>(p.gh2 + rowi[h] * kH + u);
        dh2[2 * h] = v.x, dh2[2 * h + 1] = v.y;
      }
    }
  }

  // Loads one layer's inputs of step t: gates from `gates`, c at t-1 from
  // column block `cblock` of resid (1: c1, 2: c2), and for layer 2 the
  // cotangent of tops.
  auto load_step = [&](StepIn& in, const float* gates, int cblock,
                       const float* gt, int t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long o = (long long)t * B + rowi[h];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float2 v = make_float2(0.0f, 0.0f);
        if (ok[h]) {
          v = *reinterpret_cast<const float2*>(gates + o * kH4 + k * kH + u);
        }
        in.g[2 * h][k] = v.x, in.g[2 * h + 1][k] = v.y;
      }
      float2 c = make_float2(0.0f, 0.0f);
      if (ok[h] && t > 0) {
        c = *reinterpret_cast<const float2*>(p.resid + (o - B) * (3 * kH) +
                                             cblock * kH + u);
      }
      in.cp[2 * h] = c.x, in.cp[2 * h + 1] = c.y;
      float2 ct = make_float2(0.0f, 0.0f);
      if (ok[h] && gt != nullptr) {
        ct = *reinterpret_cast<const float2*>(gt + o * kH + u);
      }
      in.gt[2 * h] = ct.x, in.gt[2 * h + 1] = ct.y;
    }
  };

  // The cell adjoint of one layer for the thread's pairs, in registers: the
  // dgates into d, unrounded into the running sums.
  auto cell_layer = [&](const StepIn& in, float (&ccur)[4],
                        const float (&dh)[4], float (&dc)[4],
                        float (&sum)[4][4], float (&d)[4][4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cell_bwd(in.g[q][0], in.g[q][1], in.g[q][2], in.g[q][3], in.cp[q],
               ccur[q], dh[q] + in.gt[q], &dc[q], d[q]);
      ccur[q] = in.cp[q];
#pragma unroll
      for (int k = 0; k < 4; ++k) sum[q][k] += d[q][k];
    }
  };

  // The dgates, rounded to bf16, into both blocks' operand tiles.
  auto put_tiles = [&](const float (&d)[4][4], uint32_t tile,
                       uint32_t remote) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t v = pack_bf16(d[2 * h][k], d[2 * h + 1][k]);
        const int col = k * kH + u;
        const uint32_t off = swz(g + 8 * h, col >> 3) + (col & 7) * 2;
        st_local_smem(tile + off, v);
        st_cluster(remote + off, v);
      }
    }
  };

  // ... and into the bf16 stream of step t (and the fp32 stream where one is
  // asked for).
  auto put_stream = [&](const float (&d)[4][4], __nv_bfloat16* stream,
                        float* stream_f32, int t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (ok[h]) {
        const long long o = ((long long)t * B + rowi[h]) * kH4 + u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          *reinterpret_cast<uint32_t*>(stream + o + k * kH) =
              pack_bf16(d[2 * h][k], d[2 * h + 1][k]);
          if (stream_f32 != nullptr) {
            *reinterpret_cast<float2*>(stream_f32 + o + k * kH) =
                make_float2(d[2 * h][k], d[2 * h + 1][k]);
          }
        }
      }
    }
  };

  // per-lane ldmatrix addresses: operand tile rows lane % 16, chunk parity
  // lane / 16; weight rows 8 w + lane % 8
  const int key = lane & 7;
  const uint32_t a2_lane = s_a2 + (lane & 15) * (kH4 * 2);
  const uint32_t a1_lane = s_a1 + (lane & 15) * (kH4 * 2);
  // product 1: lanes 0-15 address W2h, lanes 16-31 W2x
  const uint32_t w2_lane =
      s_w + (lane >> 4) * kSliceBytes + (warp * 8 + key) * (kH4 * 2);
  const uint32_t w1_lane = s_w + 2 * kSliceBytes + (warp * 8 + key) * (kH4 * 2);

  StepIn in1, in2;
  float n1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // every block of the cluster runs before any writes into its partner
  cluster_arrive();
  load_step(in2, p.g2, 2, p.gtops, T - 1);
  cluster_wait();

  // The two layers run one step apart, as a wavefront: phase ph holds layer
  // 2 at step t2 = T-1-ph and layer 1 at step t1 = t2 + 1, both of which need
  // only what phase ph-1 produced (dh2 and n1 from dgates2[t1], dh1 from
  // dgates1[t1 + 1]). So a phase has one exchange and one barrier to wait
  // for on its critical path; the second barrier (the tiles are free again)
  // is arrived at after the products and waited for a cell adjoint later.
  for (int ph = 0; ph <= T; ++ph) {
    const int t2 = T - 1 - ph, t1 = T - ph;
    const bool v2 = t2 >= 0, v1 = ph >= 1;
    float d1[4][4], d2[4][4];
    if (v2) cell_layer(in2, c2cur, dh2, dc2, s2, d2);
    if (v1) {
      float dh1_tot[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) dh1_tot[q] = dh1[q] + n1[q];
      cell_layer(in1, c1cur, dh1_tot, dc1, s1, d1);
    }
    if (ph > 0) cluster_wait();  // both blocks are done reading the tiles
    if (v2) put_tiles(d2, s_a2, r_a2);
    if (v1) put_tiles(d1, s_a1, r_a1);
    cluster_arrive();
    // Global traffic goes between the two halves of the barrier: the
    // streams' stores, and the next phase's inputs, which arrive while the
    // products run.
    if (v2) put_stream(d2, p.dg2b, nullptr, t2);
    if (v1) put_stream(d1, p.dg1b, p.dg1f, t1);
    if (v2) load_step(in1, p.g1, 1, nullptr, t2);
    if (t2 > 0) load_step(in2, p.g2, 2, p.gtops, t2 - 1);
    cluster_wait();  // the dgates of all 128 units are in this block's tiles

    // dh2 <- dgates2 W2h^T;  n1 = dgates2 W2x^T  (this block's 64 units)
    if (v2 && products) {
      float ah[2][4], ax[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ah[c][i] = ax[c][i] = 0.0f;
      }
#pragma unroll
      for (int ks = 0; ks < kH4 / 16; ++ks) {
        uint32_t a[4], b[4];
        ldsm(a, a2_lane + (((2 * ks + (lane >> 4)) ^ key) << 4));
        ldsm(b, w2_lane + (((2 * ks + ((lane >> 3) & 1)) ^ key) << 4));
        mma(ah[ks & 1], a, b[0], b[1]);
        mma(ax[ks & 1], a, b[2], b[3]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dh2[q] = ah[0][q] + ah[1][q];
        n1[q] = ax[0][q] + ax[1][q];
      }
    }
    // dh1 <- dgates1 W1h^T
    if (v1 && products) {
      float acc[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[c][i] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < kH4 / 32; ++kk) {  // two depth-16 steps at a time
        uint32_t a[2][4], b[4];
        ldsm(b, w1_lane + (((4 * kk + (lane >> 3)) ^ key) << 4));
        ldsm(a[0], a1_lane + (((4 * kk + (lane >> 4)) ^ key) << 4));
        ldsm(a[1], a1_lane + (((4 * kk + 2 + (lane >> 4)) ^ key) << 4));
        mma(acc[(2 * kk) & 3], a[0], b[0], b[1]);
        mma(acc[(2 * kk + 1) & 3], a[1], b[2], b[3]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dh1[q] = (acc[0][q] + acc[1][q]) + (acc[2][q] + acc[3][q]);
      }
    }
    if (!products) {  // timing only: keep the carried values alive
#pragma unroll
      for (int q = 0; q < 4; ++q) dh2[q] = dc2[q], n1[q] = dh1[q] = dc1[q];
    }
    cluster_arrive();  // this block is done reading its tiles
  }
  cluster_wait();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rowi[h] < B) {
      const long long o = rowi[h] * kH4 + u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        *reinterpret_cast<float2*>(p.rowsum2 + o + k * kH) =
            make_float2(s2[2 * h][k], s2[2 * h + 1][k]);
        if (p.rowsum1 != nullptr) {
          *reinterpret_cast<float2*>(p.rowsum1 + o + k * kH) =
              make_float2(s1[2 * h][k], s1[2 * h + 1][k]);
        }
      }
    }
  }
}

// ------------------------------------------- pass C: weight gradients, dx

// part[c][i][j] = sum over rows q of chunk c of a[q][i] * g[q + shift][j],
// q < R - shift, i < m, j < 4H.
struct WgradJob {
  const float* a;
  long long pitch;
  int m;
  int shift;
  const __nv_bfloat16* g;  // [R, 4H]
  float* part;             // [chunks][H][4H]
  float* out;              // [m, 4H]
};

struct WgradJobs {
  WgradJob job[4];
};

constexpr int kWChunk = 1024;   // rows per partial
constexpr int kWSlab = 64;      // rows staged at a time
constexpr int kWN = 128;        // output columns per block
constexpr int kWP = 128 + 8;    // pitch (elements) of both staged slabs

// grid (chunks, 4H / kWN, jobs). Warps 4 (i) x 2 (j), 32 x 64 each. Both
// operands are staged rows-major, as they lie in memory, and transposed by
// ldmatrix: the contraction runs over rows.
__global__ void __launch_bounds__(kThreads, 1)
lstm2_bwd_wgrad_kernel(const WgradJobs jobs, int R) {
  __shared__ __align__(16) __nv_bfloat16 As[kWSlab * kWP];
  __shared__ __align__(16) __nv_bfloat16 Gs[kWSlab * kWP];
  const WgradJob& job = jobs.job[blockIdx.z];
  const int m = job.m;
  const int n0 = blockIdx.y * kWN;
  const int rows = R - job.shift;
  const int q_begin = blockIdx.x * kWChunk;
  const int q_end = min(rows, q_begin + kWChunk);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;
  const bool active = wm * 32 < m;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nb][i] = 0.0f;
    }
  }
  // matrix j = lane / 8 of an A load: rows (j / 2) * 8 of the slab step,
  // columns (j % 2) * 8 of the i tile
  const uint32_t a_lane = smem_addr(
      As + ((lane & 7) + ((lane >> 4) << 3)) * kWP + wm * 32 +
      ((lane >> 3) & 1) * 8);
  const uint32_t g_lane =
      smem_addr(Gs + (lane & 15) * kWP + wn * 64 + (lane >> 4) * 8);

  // A slab's loads (8 float4 of A and 4 uint4 of G per thread) start
  // together, one slab ahead: they are in flight while the slab before them
  // is multiplied.
  float4 av[kWSlab * 32 / kThreads];
  uint4 gv[kWSlab * 16 / kThreads];
  auto load_slab = [&](int qb) {
#pragma unroll
    for (int j = 0; j < kWSlab * 32 / kThreads; ++j) {
      const int e = tid + j * kThreads;
      const int c = (e & 31) * 4;
      const int q = qb + (e >> 5);
      av[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q < q_end && c < m) {
        av[j] = *reinterpret_cast<const float4*>(
            job.a + (long long)q * job.pitch + c);
      }
    }
#pragma unroll
    for (int j = 0; j < kWSlab * 16 / kThreads; ++j) {
      const int e = tid + j * kThreads;
      const int q = qb + (e >> 4);
      gv[j] = make_uint4(0u, 0u, 0u, 0u);
      if (q < q_end) {
        gv[j] = *reinterpret_cast<const uint4*>(
            job.g + (long long)(q + job.shift) * kH4 + n0 + (e & 15) * 8);
      }
    }
  };
  if (q_begin < q_end) load_slab(q_begin);
  for (int qb = q_begin; qb < q_end; qb += kWSlab) {
#pragma unroll
    for (int j = 0; j < kWSlab * 32 / kThreads; ++j) {
      const int e = tid + j * kThreads;
      *reinterpret_cast<uint2*>(As + (e >> 5) * kWP + (e & 31) * 4) =
          pack_bf16(av[j]);
    }
#pragma unroll
    for (int j = 0; j < kWSlab * 16 / kThreads; ++j) {
      const int e = tid + j * kThreads;
      *reinterpret_cast<uint4*>(Gs + (e >> 4) * kWP + (e & 15) * 8) = gv[j];
    }
    __syncthreads();
    if (qb + kWSlab < q_end) load_slab(qb + kWSlab);
    if (active) {
#pragma unroll
      for (int ks = 0; ks < kWSlab / 16; ++ks) {
        uint32_t a[2][4], b[4][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          ldsm_t(a[mt], a_lane + 2 * (ks * 16 * kWP + mt * 16));
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          ldsm_t(b[np], g_lane + 2 * (ks * 16 * kWP + np * 16));
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            mma(acc[mt][nb], a[mt], b[nb >> 1][(nb & 1) * 2],
                b[nb >> 1][(nb & 1) * 2 + 1]);
          }
        }
      }
    }
    __syncthreads();
  }

  float* out = job.part + (long long)blockIdx.x * kH * kH4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = wm * 32 + mt * 16 + g + 8 * h;
      if (i < m) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int col = n0 + wn * 64 + nb * 8 + 2 * tig;
          *reinterpret_cast<float2*>(out + (long long)i * kH4 + col) =
              make_float2(acc[mt][nb][2 * h], acc[mt][nb][2 * h + 1]);
        }
      }
    }
  }
}

// out[e] = sum_c part[c][e] for every job, chunks in order. grid (.., jobs).
__global__ void lstm2_bwd_combine_kernel(const WgradJobs jobs, int chunks) {
  const WgradJob& job = jobs.job[blockIdx.y];
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= job.m * kH4) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    s += job.part[(long long)c * kH * kH4 + e];
  }
  job.out[e] = s;
}

// out[j] = sum_b in[b][j] over B rows of [B, 4H]: a thread sums every 32nd
// row, then the 32 sums of a column are added in order. grid (4H / 32, jobs),
// block (32, 32).
struct ColsumJobs {
  const float* in[2];
  float* out[2];
};

__global__ void lstm2_bwd_colsum_kernel(const ColsumJobs jobs, int B) {
  __shared__ float part[32][33];
  const float* in = jobs.in[blockIdx.y];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  for (int b = threadIdx.y; b < B; b += 32) s += in[(long long)b * kH4 + j];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0) {
    float tot = 0.0f;
    for (int y = 0; y < 32; ++y) tot += part[y][threadIdx.x];
    jobs.out[blockIdx.y][j] = tot;
  }
}

constexpr int kXM = 64;          // rows per tile of dx
constexpr int kXP = kH4 + 8;     // pitch (elements) of both staged operands
static_assert(16 * (kH4 / 4) % (kThreads * kBatch) == 0 &&
                  kXM * (kH4 / 8) % (kThreads * kBatch) == 0,
              "dx stages W1x and its tiles in whole batches");

// dx[r][d] = sum_j dg1[r][j] * bf16(w1x[d][j]), r < R, d < D. The block
// holds W1x in shared memory and walks over 64-row tiles of the bf16 dgates
// stream. Warps 4 (rows) x 2 (halves of D), 16 rows x D / 2 each.
__global__ void __launch_bounds__(kThreads, 1)
lstm2_bwd_dx_kernel(const __nv_bfloat16* __restrict__ dg1,
                    const float* __restrict__ w1x, float* __restrict__ dx,
                    int R, int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [D][kXP]
  __nv_bfloat16* As = Ws + D * kXP;                                // [kXM][kXP]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, tig = lane & 3;
  const int nbw = D / 16;  // column blocks of 8 per warp

  // D * kH4 / 4 float4, a multiple of the batch (D is a multiple of 16)
  for (int e0 = tid; e0 < D * (kH4 / 4); e0 += kThreads * kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      v[j] = *reinterpret_cast<const float4*>(w1x +
                                              4LL * (e0 + j * kThreads));
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kThreads;
      const int d = e / (kH4 / 4);
      *reinterpret_cast<uint2*>(Ws + d * kXP + (e - d * (kH4 / 4)) * 4) =
          pack_bf16(v[j]);
    }
  }

  const uint32_t a_lane =
      smem_addr(As + (wm * 16 + (lane & 15)) * kXP + (lane >> 4) * 8);
  // a B load covers two depth-16 steps of one column block: matrix
  // j = lane / 8 holds depth j * 8
  const uint32_t w_lane =
      smem_addr(Ws + (wn * (D / 2) + (lane & 7)) * kXP + (lane >> 3) * 8);
  const int tiles = (R + kXM - 1) / kXM;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = (long long)tile * kXM;
    // kXM * kH4 / 8 uint4 per tile: 16 per thread, in two batches
    for (int e0 = tid; e0 < kXM * (kH4 / 8); e0 += kThreads * kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + j * kThreads;
        const int row = e / (kH4 / 8);
        v[j] = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + row < R) {
          v[j] = *reinterpret_cast<const uint4*>(dg1 + r0 * kH4 + 8LL * e);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = e0 + j * kThreads;
        const int row = e / (kH4 / 8);
        *reinterpret_cast<uint4*>(As + row * kXP + (e - row * (kH4 / 8)) * 8) =
            v[j];
      }
    }
    __syncthreads();

    float acc[kMaxD / 16][4];
#pragma unroll
    for (int nb = 0; nb < kMaxD / 16; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nb][i] = 0.0f;
    }
    for (int kk = 0; kk < kH4 / 32; ++kk) {
      uint32_t a[2][4];
      ldsm(a[0], a_lane + 2 * (kk * 32));
      ldsm(a[1], a_lane + 2 * (kk * 32 + 16));
#pragma unroll
      for (int nb = 0; nb < kMaxD / 16; ++nb) {
        if (nb < nbw) {
          uint32_t b[4];
          ldsm(b, w_lane + 2 * (nb * 8 * kXP + kk * 32));
          mma(acc[nb], a[0], b[0], b[1]);
          mma(acc[nb], a[1], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = r0 + wm * 16 + g + 8 * h;
      if (r < R) {
#pragma unroll
        for (int nb = 0; nb < kMaxD / 16; ++nb) {
          if (nb < nbw) {
            const int col = wn * (D / 2) + nb * 8 + 2 * tig;
            *reinterpret_cast<float2*>(dx + r * D + col) =
                make_float2(acc[nb][2 * h], acc[nb][2 * h + 1]);
          }
        }
      }
    }
    __syncthreads();
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Rows of pass C's reduction per partial: the wrapper sizes the partial
// buffer as 4 * ceil(T * B / rows) * H * 4H floats.
int sfhvae_lstm2_bwd_chunk_rows() { return kWChunk; }

// The backward of both LSTM entries in bf16 operand mode, all on `stream`.
// `passes` is a set of bits: 1 pass A (gates into g1, g2), 2 pass B (the
// chain: dg1b, dg2b, the row sums, and in mode 0 the fp32 dgates1 over g1),
// 4 pass C (the weight gradients, db2, dxadd, dx); 7 is the whole call.
//   dxadd: mode 0 dgates1 itself (g1 holds it after pass B; dxadd unused),
//          mode 1 sum_t dgates1 -> dxadd [B, 4H],
//          mode 2 sum_{t,b} dgates1 -> dxadd [4H] through rowsum1.
// All tensors fp32 but dg1b, dg2b ([T, B, 4H] bf16); every pointer 16-byte
// aligned. part: scratch of 4 * ceil(T*B / chunk_rows) * H * 4H floats;
// rowsum1 (mode 2), rowsum2: scratch of B * 4H floats. probe (timing only):
// see ChainArgs. Returns the cudaError_t of the first launch that failed,
// or 0.
int sfhvae_lstm2_bwd(const void* x, const void* xadd, long long xadd_t_stride,
                     long long xadd_row_stride, const void* resid,
                     const void* tops, const void* gtops, const void* gh2,
                     const void* w1x, const void* w1h, const void* w2x,
                     const void* w2h, const void* b2, void* g1, void* g2,
                     void* dg1b, void* dg2b, void* dx, void* dxadd,
                     int dxadd_mode, void* dw1x, void* dw1h, void* dw2x,
                     void* dw2h, void* db2, void* part, void* rowsum1,
                     void* rowsum2, int T, int B, int D, int H, int passes,
                     int probe, void* stream) {
  if (!tc_takes(H, x == nullptr ? 0 : D)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* rf = static_cast<const float*>(resid);
  const float* tf = static_cast<const float*>(tops);
  float* g1f = static_cast<float*>(g1);
  float* g2f = static_cast<float*>(g2);
  __nv_bfloat16* d1 = static_cast<__nv_bfloat16*>(dg1b);
  __nv_bfloat16* d2 = static_cast<__nv_bfloat16*>(dg2b);
  const int R = T * B;
  if (xf == nullptr) D = 0;
  cudaError_t e = cudaSuccess;

  if (passes & 1) {
    GateJobs jobs;
    // G2 = [h1[t] | h2[t-1]] [W2x; W2h] + b2
    jobs.job[0] = GateJob{rf, 3LL * kH, kH, 0, tf, kH, kH, B,
                          static_cast<const float*>(w2x),
                          static_cast<const float*>(w2h),
                          static_cast<const float*>(b2), 0, 0, g2f};
    // G1 = [x[t] | h1[t-1]] [W1x; W1h] + xadd
    jobs.job[1] = GateJob{xf, D, D, 0, rf, 3LL * kH, kH, B,
                          static_cast<const float*>(w1x),
                          static_cast<const float*>(w1h),
                          static_cast<const float*>(xadd), xadd_t_stride,
                          xadd_row_stride, g1f};
    e = allow_smem(lstm2_bwd_gates_kernel, kGatesSmem);
    if (e != cudaSuccess) return e;
    // two blocks per SM, each keeping its weight slice for ~10 row tiles
    const int walkers = std::min(ceil_div(R, kGM), 33);
    lstm2_bwd_gates_kernel<<<dim3(walkers, kH4 / kGN, 2), kThreads,
                             kGatesSmem, s>>>(jobs, R, B);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }

  if (passes & 2) {
    ChainArgs a{g1f,
                g2f,
                rf,
                static_cast<const float*>(gtops),
                static_cast<const float*>(gh2),
                static_cast<const float*>(w1h),
                static_cast<const float*>(w2x),
                static_cast<const float*>(w2h),
                d1,
                d2,
                dxadd_mode == 0 ? g1f : nullptr,
                dxadd_mode == 1   ? static_cast<float*>(dxadd)
                : dxadd_mode == 2 ? static_cast<float*>(rowsum1)
                                  : nullptr,
                static_cast<float*>(rowsum2),
                T,
                B,
                probe};
    e = allow_smem(lstm2_bwd_chain_kernel, kChainSmem);
    if (e != cudaSuccess) return e;
    lstm2_bwd_chain_kernel<<<2 * ceil_div(B, kCRows), kThreads, kChainSmem,
                             s>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }

  if (passes & 4) {
    const int chunks = ceil_div(R, kWChunk);
    float* pt = static_cast<float*>(part);
    const long long per_job = (long long)chunks * kH * kH4;
    WgradJobs jobs;
    jobs.job[0] = WgradJob{rf, 3LL * kH, kH, 0, d2, pt,
                           static_cast<float*>(dw2x)};
    jobs.job[1] = WgradJob{tf, kH, kH, B, d2, pt + per_job,
                           static_cast<float*>(dw2h)};
    jobs.job[2] = WgradJob{rf, 3LL * kH, kH, B, d1, pt + 2 * per_job,
                           static_cast<float*>(dw1h)};
    jobs.job[3] = WgradJob{xf, D, D, 0, d1, pt + 3 * per_job,
                           static_cast<float*>(dw1x)};
    const int njobs = xf != nullptr ? 4 : 3;
    lstm2_bwd_wgrad_kernel<<<dim3(chunks, kH4 / kWN, njobs), kThreads, 0,
                             s>>>(jobs, R);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    lstm2_bwd_combine_kernel<<<dim3(kH * kH4 / 256, njobs), 256, 0, s>>>(
        jobs, chunks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;

    ColsumJobs sums;
    sums.in[0] = static_cast<const float*>(rowsum2);
    sums.out[0] = static_cast<float*>(db2);
    sums.in[1] = static_cast<const float*>(rowsum1);
    sums.out[1] = static_cast<float*>(dxadd);
    lstm2_bwd_colsum_kernel<<<dim3(kH4 / 32, dxadd_mode == 2 ? 2 : 1),
                              dim3(32, 32), 0, s>>>(sums, B);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;

    if (dx != nullptr) {
      const size_t smem = sizeof(__nv_bfloat16) * (size_t)(D + kXM) * kXP;
      e = allow_smem(lstm2_bwd_dx_kernel, smem);
      if (e != cudaSuccess) return e;
      lstm2_bwd_dx_kernel<<<std::min(ceil_div(R, kXM), 132), kThreads, smem,
                            s>>>(
          d1, static_cast<const float*>(w1x), static_cast<float*>(dx), R, D);
      e = cudaGetLastError();
    }
  }
  return e;
}

}  // extern "C"
