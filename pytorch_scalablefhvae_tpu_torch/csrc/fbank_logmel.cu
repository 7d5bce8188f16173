// Fused window + real DFT + magnitude + mel projection + floored log (sm_90a).
//
// Replaces the TPU kernel pytorch_scalablefhvae_tpu/ops/fbank_pallas.py:
// fused_logmel_frames (kernel body _kernel). For N raw frames of n_fft
// samples it writes [N, M] float32:
//   f   = frames * window                          [N, n_fft]
//   re  = f @ cos_basis,  im = f @ sin_basis       [N, K], K = n_fft / 2 + 1
//   mag = sqrt(re^2 + im^2 + 1e-30)
//   out = max(log(max(mag @ mel_fb_t, 1e-38)), log_floor)
// The windowed frames, re, im and mag never reach device memory: only
// [N, M] is written. Inference only. The bases and the bank are read as
// given (no twiddles derived, no symmetry assumed).
//
// What bounds it on the H100: operations. At the serving shape (N 6,560,
// n_fft 400, K 201, M 80) the products are 2.32 GFLOP against 13.3 MB moved:
// 35 us as fp32 FMA outside the tensor cores (67 TFLOP/s), 4 us at the
// memory rate. 91% of the operations are the DFT.
//
// Why the DFT stays fp32 FMA: the log-mel is held within 2e-4 of the plain
// version, a cuBLAS product that sums each bin in sample order, and that
// limit fixes the order. In a voiced frame the low bins are sums that
// cancel to a thousandth of their terms, so two fp32 summation orders
// differ there by more than 2e-4 (either may be as far from the exact sum:
// plain itself is 1.5e-3 from float64 there). The DFT keeps plain's order:
// one fmaf per sample, n = 0, 1, ..., from 0. An fp32-grade product on the
// tensor cores (three TF32 products, hi.hi + hi.lo + lo.hi) sums in 8-sample
// steps and missed the limit by 10x there (PERF.md). The mel projection
// sums positive terms, where any order agrees to ~1e-6, so it runs on the
// tensor cores in that 3xTF32 form.
//
// What the design does: a block owns a tile of up to 64 frames (the
// wrapper's logmel_geometry sizes the tiles, in steps of 8 frames, to fill
// whole waves of the card; blocks of 16, 32 and 64 frames; a frame's bits
// depend on none of it) and all K bins, so mag stays on the chip.
//  1. The tile's rows arrive by one bulk copy (the tensor memory
//     accelerator, cp.async.bulk, counted on an mbarrier) into the ring,
//     and are windowed and transposed from there into xs[n][frame] (pitch
//     rows + 4).
//  2. DFT: a thread owns 4 bins x 8 frames (4 frames in 16-frame blocks
//     up to 512 bins, which is what keeps a block within its threads);
//     per sample it reads its bins' cos and sin (8 neighbouring threads:
//     8 neighbouring bin groups, no bank conflict) and its frames as float4
//     (a broadcast), loading the next sample's while the current one's FMAs
//     run. The bases stream through a ring of 16-sample slices, as deep as
//     the shared memory allows: thread 0 issues a slice as two bulk copies
//     of the rows as they lie in memory (16-byte aligned whatever K: a slice
//     starts at a multiple of 16 rows), the bytes past a multiple of 16 by
//     plain loads; one barrier a slice.
//  3. The magnitudes go to shared memory as mag[frame][bin] (over xs).
//  4. Mel: mag [rows x K] . mel_fb_t [K x M] as 3xTF32 mma.sync.m16n8k8
//     (hi = tf32(x), lo = tf32(x - hi), lo.lo dropped, fp32 accumulate). A
//     tile of 8 bands runs only over the 8-bin steps where its weights are
//     not all zero (the others would add exact zeros). The whole bank
//     arrives by a bulk copy at the start, beside the ring where it fits,
//     else through the ring after the DFT. The floored log is applied to
//     the accumulators and written as out[frame][m].
// Every sum runs in one fixed order whatever N and the tile, so a frame
// gives the same bits in any batch. Rows past the tile and samples past
// n_fft are zero in shared memory and nothing past the tile is written.
// Frames, bases and bank must be 16-byte aligned (the wrapper copies a view
// that is not).
//
// What was measured and dropped (PERF.md, row 9): the DFT as 3xTF32 mma
// (missed the limit, no faster); 4-byte cp.async staging (slower); the
// bases through L1 without staging (slower); clusters sharing each slice
// by multicast bulk copies (their per-slice cluster barrier cost more than
// the L2 traffic they saved).
//
// No fast-math and no flush-to-zero: 1e-38 is below the smallest normal
// float, and log/sqrt must be the full-precision ones for a silent frame to
// reach the floor the way the plain version does.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kSlice = 16;       // samples a ring buffer holds (n_fft and K
                                 // are rounded up to it)
constexpr int kMaxStages = 8;    // ring buffers: up to seven slices in flight
constexpr int kMelTiles = 3;     // 8-band tiles a warp owns in a mel pass
constexpr int kMaxSmem = 232448 - 1024;  // dynamic shared memory a block may
                                         // take beside its mbarriers

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The least row pitch of at least `cols` floats that is `rem` mod 32.
__host__ __device__ constexpr int pitch(int cols, int rem) {
  return round_up(cols - rem, 32) + rem;
}

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Frames a DFT thread owns in a tile of `rows` at K bins, the form the
// entry takes: 4 in 16-frame blocks up to 512 bins, else 8. (Past 512 bins
// 4 would need more threads than a block may have; with 8, a 16-frame block
// takes up to 1,024 bins, more than its shared memory holds.)
__host__ __device__ constexpr int frames_per_thread(int rows, int K) {
  return rows == 16 && K <= 512 ? 4 : 8;
}

// How a block of `rows` frames is laid out; lengths in floats.
struct Layout {
  int items;       // DFT threads: 8 per (8 bin groups, frame group)
  int threads;     // items rounded up to a warp; 0: more than a block may have
  int bins;        // 4 bins a thread, 8 threads a row segment: K rounded up
  int n_pad, k_pad;  // n_fft and K rounded up to a slice
  int xs_pitch;    // windowed frames, transposed: [n_pad][xs_pitch]
  int mag_pitch;   // magnitudes [rows][mag_pitch]
  int basis;       // a slice of one basis, [kSlice][K] as in memory, padded
  int mel_cols;    // bands a mel pass covers
  int stage;       // one ring buffer: cos | sin | slack
  int stages;      // ring buffers: as many as the shared memory holds
  int ring;        // the ring: its buffers, and at least 8 rows of the
                   // bank and 4 frame rows, which also pass through it
  int bank_off;    // the whole bank, [k_pad][M] + slack, where it fits
                   // beside two ring buffers; else -1 (it then comes
                   // through the ring after the DFT)
  int ring_off, mag_off, floats;
};

__host__ __device__ inline Layout layout(int n_fft, int K, int M, int rows,
                                          int tf) {
  Layout L;
  const int octets = ((K + 3) / 4 + 7) / 8;
  L.items = 8 * (rows / tf) * octets;
  L.threads = round_up(L.items, 32);
  if (L.threads > kMaxThreads) L.threads = 0;
  L.bins = 32 * octets;
  L.n_pad = round_up(n_fft, kSlice);
  L.k_pad = round_up(K, kSlice);
  L.xs_pitch = rows + 4;
  L.mag_pitch = pitch(L.k_pad, 4);
  L.basis = round_up(kSlice * K, 4);
  L.mel_cols = imax(L.threads / 32, 1) * kMelTiles * 8;
  // the last row's bin groups read up to `bins` past its start: slack
  L.stage = round_up(2 * L.basis + L.bins, 32);
  const int xs = L.n_pad * L.xs_pitch;
  const bool mag_on_xs = rows * L.mag_pitch <= xs;
  int fixed = xs + (mag_on_xs ? 0 : rows * L.mag_pitch);
  const int bank = round_up(L.k_pad * M + 8, 32);
  const bool bank_apart = fixed + bank + 2 * L.stage <= kMaxSmem / 4;
  if (bank_apart) fixed += bank;
  L.stages = imin(kMaxStages, imax(2, (kMaxSmem / 4 - fixed) / L.stage));
  L.ring = imax(L.stages * L.stage, imax(8 * M + 8, 4 * n_fft));
  L.ring_off = xs;
  L.mag_off = mag_on_xs ? 0 : xs + L.ring;
  L.bank_off = bank_apart ? fixed - bank + L.ring : -1;
  L.floats = fixed + L.ring;
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread's bulk copy (the tensor memory accelerator) of `bytes` (a
// multiple of 16, both addresses 16-byte aligned) global -> shared; the
// mbarrier at `bar` counts the bytes in.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

// Arrive on `bar` (one of its arrivals) expecting `bytes` of bulk copies.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Orders this thread's shared-memory accesses before later bulk copies.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x = hi + lo + O(2^-22 |x|): hi and lo as TF32 (round to nearest, ties
// away), the mma's operand type.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// c[16, 8] += a[16, 8] b[8, 8], TF32 operands, fp32 accumulate. Lane l
// gives a at rows l / 4 (+8), columns l % 4 (+4); b at rows l % 4 (+4),
// column l / 4; holds c at rows l / 4 and l / 4 + 8, columns
// 2 (l % 4) + {0, 1}.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m] += a[16 MT rows, 8 s0 : 8 s1] . b[8 s0 : 8 s1, 8 tile : 8 tile +
// 8], 3xTF32 on the tensor cores (a warp's product); a and b in shared
// memory, row pitches lda and ldb; k runs in order.
template <int MT>
__device__ __forceinline__ void product(float (&acc)[MT][4], const float* a,
                                        int lda, const float* b, int ldb,
                                        int s0, int s1, int tile) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 8 * s0; k0 < 8 * s1; k0 += 8) {
    const float* bp = b + (k0 + t) * ldb + tile * 8 + g;
    uint32_t bh0, bl0, bh1, bl1;
    split(bp[0], bh0, bl0);
    split(bp[4 * ldb], bh1, bl1);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* ap = a + (m * 16 + g) * lda + k0 + t;
      uint32_t ah[4], al[4];
      split(ap[0], ah[0], al[0]);
      split(ap[8 * lda], ah[1], al[1]);
      split(ap[4], ah[2], al[2]);
      split(ap[8 * lda + 4], ah[3], al[3]);
      mma(acc[m], al, bh0, bh1);
      mma(acc[m], ah, bl0, bl1);
      mma(acc[m], ah, bh0, bh1);
    }
  }
}

// Thread 0 stages `count` floats global -> shared: a bulk copy of the
// largest multiple of 4 (both addresses 16-byte aligned), counted in on
// `bar` (one arrival), and plain loads for the rest. The caller waits on
// `bar`, then syncs the block.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int count, uint64_t* bar) {
  const int bulk = count & ~3;
  bar_expect(bar, 4u * bulk);
  if (bulk) bulk_copy(dst, src, 4u * bulk, bar);
  for (int i = bulk; i < count; ++i) dst[i] = src[i];
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Timing variants (PROBE, a sum of these; never launched by the entry).
constexpr int kNoFma = 1;       // the DFT's FMAs left out
constexpr int kOneLoad = 4;     // a slice's samples take its first sample's
                                // loaded values
constexpr int kNoMel = 16;      // the mel passes left out

// TF: frames a DFT thread owns; PROBE: 0, or a timing variant.
template <int MT, int TF, int PROBE>
__global__ void __launch_bounds__(kMaxThreads)
    fbank_logmel_kernel(const float* __restrict__ frames,  // [N, n_fft]
                        const float* __restrict__ window,  // [n_fft]
                        const float* __restrict__ cosb,    // [n_fft, K]
                        const float* __restrict__ sinb,    // [n_fft, K]
                        const float* __restrict__ fb_t,    // [K, M]
                        float* __restrict__ out,           // [N, M]
                        long long N, int n_fft, int K, int M,
                        float log_floor, int rows) {
  constexpr int kRows = MT * 16;
  constexpr int kGroups = kRows / TF;
  extern __shared__ __align__(16) float smem[];
  // per ring buffer: its slice arrived; after them: the frames' (and the
  // bank's when it comes through the ring), the bank's when it is apart
  __shared__ uint64_t bars[kMaxStages + 2];
  const Layout L = layout(n_fft, K, M, kRows, TF);
  const int S = L.stages;
  float* xs = smem;
  float* ring = smem + L.ring_off;
  float* mag = smem + L.mag_off;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  // this block's frames: [f0, f0 + live), rows <= kRows a tile
  const long long f0 = static_cast<long long>(blockIdx.x) * rows;
  const int live = N - f0 < rows ? static_cast<int>(N - f0) : rows;
  const int slices = L.n_pad / kSlice;

  // the ring starts at zero (a last slice's rows past n_fft are read);
  // thread 0 issues each slice of the bases, rows as in memory, cos and sin
  // (two arrivals on the slice's mbarrier)
  for (int i = tid; i < L.ring; i += nthreads) ring[i] = 0.0f;
  float* bank = L.bank_off < 0 ? nullptr : smem + L.bank_off;
  if (bank) {  // rows past K: zero, as the mel's last step reads them
    for (int i = K * M + tid; i < L.k_pad * M + 8; i += nthreads) {
      bank[i] = 0.0f;
    }
  }
  fence_async();
  if (tid == 0) {
    for (int i = 0; i < S; ++i) bar_init(&bars[i], 2);
    bar_init(&bars[S], 1);
    bar_init(&bars[S + 1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the bank, where it is apart, arrives while the DFT runs
  if (bank && tid == 0 && !(PROBE & kNoMel)) {
    stage(bank, fb_t, K * M, &bars[S + 1]);
  }
  auto issue_dft = [&](int s) {
    float* dst = ring + (s % S) * L.stage;
    const size_t at = static_cast<size_t>(s) * kSlice * K;
    const int count = imin(kSlice, n_fft - s * kSlice) * K;
    stage(dst, cosb + at, count, &bars[s % S]);
    stage(dst + L.basis, sinb + at, count, &bars[s % S]);
  };
  uint32_t phase = 0;  // of bars[S]

  // 1. the frame tile, windowed, transposed: xs[n][frame], zero past the
  // tile's frames and past n_fft. Rows arrive in the ring as in memory, a
  // chunk at a time, and are transposed from there.
  const int chunk = imin(kRows, L.ring / n_fft & ~3);
  for (int r0 = 0; r0 < kRows; r0 += chunk) {
    const int rc = imin(chunk, kRows - r0);
    const int lr = imax(0, imin(rc, live - r0));
    if (tid == 0) {
      fence_async();
      stage(ring, frames + (f0 + r0) * n_fft, lr * n_fft, &bars[S]);
    }
    bar_wait(&bars[S], phase);
    phase ^= 1;
    __syncthreads();
    for (int n = tid; n < L.n_pad; n += nthreads) {
      const float w = n < n_fft ? window[n] : 0.0f;
      for (int r = 0; r < rc; ++r) {
        xs[n * L.xs_pitch + r0 + r] =
            r < lr && n < n_fft ? ring[r * n_fft + n] * w : 0.0f;
      }
    }
    __syncthreads();  // the ring is read no more
  }
  if (tid == 0) {
    fence_async();
    for (int s = 0; s < S - 1 && s < slices; ++s) issue_dft(s);
  }

  // 2. DFT, fp32 FMA in sample order: 8 threads share a frame group and
  // hold 8 neighbouring groups of 4 bins; a thread loads the next sample's
  // values while the current one's FMAs run
  const bool dft = tid < L.items;
  const int group = (tid >> 3) % kGroups;
  const int bin0 = ((tid >> 3) / kGroups * 8 + (tid & 7)) * 4;
  float re[4][TF], im[4][TF];
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int j = 0; j < TF; ++j) re[b][j] = im[b][j] = 0.0f;
  for (int s = 0; s < slices; ++s) {
    bar_wait(&bars[s % S], (s / S) & 1);
    __syncthreads();  // xs is written; every thread is done with slice s - 1
    if (tid == 0 && s + S - 1 < slices) {
      fence_async();
      issue_dft(s + S - 1);
    }
    if ((PROBE & kNoFma) || !dft) continue;
    const float* cb = ring + (s % S) * L.stage + bin0;
    const float* xb = xs + s * kSlice * L.xs_pitch + group * TF;
    float c[4], sn[4];
    float4 x[TF / 4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      c[b] = cb[b];
      sn[b] = cb[L.basis + b];
    }
#pragma unroll
    for (int j = 0; j < TF / 4; ++j) x[j] = ld4(xb + 4 * j);
#pragma unroll
    for (int r = 0; r < kSlice; ++r) {
      float c_next[4], sn_next[4];
      float4 x_next[TF / 4];
      if (r + 1 < kSlice && !(PROBE & kOneLoad)) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          c_next[b] = cb[(r + 1) * K + b];
          sn_next[b] = cb[L.basis + (r + 1) * K + b];
        }
#pragma unroll
        for (int j = 0; j < TF / 4; ++j) {
          x_next[j] = ld4(xb + (r + 1) * L.xs_pitch + 4 * j);
        }
      }
#pragma unroll
      for (int j = 0; j < TF; ++j) {
        const float4 v = x[j / 4];
        const float xj = j % 4 == 0 ? v.x : j % 4 == 1 ? v.y : j % 4 == 2 ? v.z : v.w;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          re[b][j] = fmaf(xj, c[b], re[b][j]);
          im[b][j] = fmaf(xj, sn[b], im[b][j]);
        }
      }
      if (r + 1 < kSlice && !(PROBE & kOneLoad)) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          c[b] = c_next[b];
          sn[b] = sn_next[b];
        }
#pragma unroll
        for (int j = 0; j < TF / 4; ++j) x[j] = x_next[j];
      }
    }
  }
  __syncthreads();

  // 3. magnitudes (over xs); bins past K, up to the slice, are zero for
  // the mel
  if (dft) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (bin0 + b < K) {
#pragma unroll
        for (int j = 0; j < TF; ++j) {
          mag[(group * TF + j) * L.mag_pitch + bin0 + b] =
              sqrtf(re[b][j] * re[b][j] + im[b][j] * im[b][j] + 1e-30f);
        }
      }
    }
  }
  const int pad = L.k_pad - K;
  for (int i = tid; i < kRows * pad; i += nthreads) {
    const int r = i / pad;
    mag[r * L.mag_pitch + K + i - r * pad] = 0.0f;
  }

  // 4. mel passes, 3xTF32 on the tensor cores, floored log; the bank
  // arrives in the ring as in memory, as many rows at a time as it holds
  const int lane = tid & 31, warp = tid >> 5, warps = nthreads >> 5;
  const int g = lane >> 2, t = lane & 3;
  // (8 floats of slack: a tile's last columns read past its last row)
  const int k_chunk =
      bank ? L.k_pad : imin(L.k_pad, (L.ring - 8) / M & ~7);
  for (int col0 = 0; col0 < ((PROBE & kNoMel) ? 0 : M); col0 += L.mel_cols) {
    const int cols = imin(M - col0, L.mel_cols);
    float acc[kMelTiles][MT][4];
#pragma unroll
    for (int j = 0; j < kMelTiles; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][m][i] = 0.0f;
    for (int k0 = 0; k0 < L.k_pad; k0 += k_chunk) {
      const int kc = imin(k_chunk, L.k_pad - k0);
      const float* rows_k = bank ? bank : ring;
      if (bank) {
        if (col0 == 0) bar_wait(&bars[S + 1], 0);
      } else {
        if (tid == 0) {
          fence_async();
          // rows past K are left as they are: mag is zero there
          stage(ring, fb_t + static_cast<size_t>(k0) * M,
                imin(kc, K - k0) * M, &bars[S]);
        }
        bar_wait(&bars[S], phase);
        phase ^= 1;
      }
      __syncthreads();
      // a tile of 8 bands runs over the 8-bin steps where its weights are
      // not all zero: the steps left out would add exact zeros
      const int rows_in = imin(kc, K - k0);
#pragma unroll
      for (int j = 0; j < kMelTiles; ++j) {
        const int tile = warp + warps * j;
        if (tile * 8 >= cols) continue;
        int lo = kc, hi = -1;
        for (int k = lane; k < rows_in; k += 32) {
          bool any = false;
          for (int c = tile * 8; c < imin(cols, tile * 8 + 8); ++c) {
            any = any || rows_k[k * M + col0 + c] != 0.0f;
          }
          if (any) {
            lo = imin(lo, k);
            hi = k;
          }
        }
        lo = __reduce_min_sync(0xffffffffu, lo);
        hi = __reduce_max_sync(0xffffffffu, hi);
        if (hi >= 0) {
          product<MT>(acc[j], mag + k0, L.mag_pitch, rows_k + col0, M,
                      lo / 8, hi / 8 + 1, tile);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kMelTiles; ++j) {
      const int col = (warp + warps * j) * 8 + 2 * t;  // in the pass
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m * 16 + g + 8 * h;  // in the tile
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (row < live && col + e < cols) {
              out[(f0 + row) * M + col0 + col + e] = fmaxf(
                  logf(fmaxf(acc[j][m][2 * h + e], 1e-38f)), log_floor);
            }
          }
        }
      }
    }
  }
}

template <int MT, int TF, int PROBE = 0>
int launch(const float* frames, const float* window, const float* cosb,
           const float* sinb, const float* fb_t, float* out, long long N,
           int n_fft, int K, int M, float log_floor, int rows,
           cudaStream_t stream) {
  static bool opted_in = false;  // per instance: the attribute is set once
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        fbank_logmel_kernel<MT, TF, PROBE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const Layout L = layout(n_fft, K, M, MT * 16, TF);
  if (L.threads == 0) return cudaErrorInvalidConfiguration;
  const long long blocks = (N + rows - 1) / rows;
  fbank_logmel_kernel<MT, TF, PROBE>
      <<<static_cast<unsigned>(blocks), L.threads,
         static_cast<size_t>(L.floats) * sizeof(float), stream>>>(
          frames, window, cosb, sinb, fb_t, out, N, n_fft, K, M, log_floor,
          rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block of `rows` frames needs for this
// n_fft, K and M, and the most a block may take.
long long sfhvae_fbank_logmel_smem(int n_fft, int K, int M, int rows) {
  return static_cast<long long>(
             layout(n_fft, K, M, rows, frames_per_thread(rows, K)).floats)
         * static_cast<long long>(sizeof(float));
}
int sfhvae_fbank_logmel_max_smem() { return kMaxSmem; }

// Threads a block of `rows` frames takes at K bins; 0 when K needs more
// than a block may have (kMaxThreads: over 256 bins at 64 frames, over 512
// at 32; a 16-frame block's shared memory runs out first).
int sfhvae_fbank_logmel_threads(int K, int rows) {
  return layout(2 * (K - 1), K, 1, rows, frames_per_thread(rows, K)).threads;
}

// frames: [N, n_fft]; window: [n_fft]; cos_basis, sin_basis: [n_fft, K];
// mel_fb_t: [K, M]; out: [N, M]; all fp32, contiguous; frames, the bases
// and the bank 16-byte aligned (they arrive by bulk copies). N > 0; rows,
// the frames of a tile, a multiple of 8 up to 64 (a block of the 16-, 32-
// or 64-frame kernel takes the tile). Returns the cudaError_t of the
// launch.
int sfhvae_fbank_logmel(const void* frames, const void* window,
                        const void* cos_basis, const void* sin_basis,
                        const void* mel_fb_t, void* out, long long N,
                        int n_fft, int K, int M, float log_floor, int rows,
                        void* stream) {
  const auto f = static_cast<const float*>(frames);
  const auto w = static_cast<const float*>(window);
  const auto c = static_cast<const float*>(cos_basis);
  const auto s = static_cast<const float*>(sin_basis);
  const auto b = static_cast<const float*>(mel_fb_t);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (rows < 8 || rows > 64 || rows % 8) return cudaErrorInvalidValue;
  if (rows <= 16 && frames_per_thread(16, K) == 4)
    return launch<1, 4>(f, w, c, s, b, o, N, n_fft, K, M, log_floor, rows,
                        st);
  if (rows <= 16)
    return launch<1, 8>(f, w, c, s, b, o, N, n_fft, K, M, log_floor, rows,
                        st);
  if (rows <= 32)
    return launch<2, 8>(f, w, c, s, b, o, N, n_fft, K, M, log_floor, rows,
                        st);
  return launch<4, 8>(f, w, c, s, b, o, N, n_fft, K, M, log_floor, rows, st);
}

// The same launch in a timing variant, in the entry's 16-frame form (rows
// up to 16, K up to 512) or its 64-frame form (rows 40 to 64, K up to 256):
// probe kNoFma, kOneLoad or kNoMel. Not called by the port's entry.
int sfhvae_fbank_logmel_probe(const void* frames, const void* window,
                              const void* cos_basis, const void* sin_basis,
                              const void* mel_fb_t, void* out, long long N,
                              int n_fft, int K, int M, float log_floor,
                              int rows, int probe, void* stream) {
  const auto f = static_cast<const float*>(frames);
  const auto w = static_cast<const float*>(window);
  const auto c = static_cast<const float*>(cos_basis);
  const auto s = static_cast<const float*>(sin_basis);
  const auto b = static_cast<const float*>(mel_fb_t);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (rows < 8 || rows > 64 || rows % 8 || (rows > 16 && rows <= 32))
    return cudaErrorInvalidValue;
#define SFHVAE_PROBE(P)                                                     \
  if (probe == P)                                                           \
    return rows <= 16 ? launch<1, 4, P>(f, w, c, s, b, o, N, n_fft, K, M,   \
                                        log_floor, rows, st)                \
                      : launch<4, 8, P>(f, w, c, s, b, o, N, n_fft, K, M,   \
                                        log_floor, rows, st);
  SFHVAE_PROBE(kNoFma)
  SFHVAE_PROBE(kOneLoad)
  SFHVAE_PROBE(kNoMel)
#undef SFHVAE_PROBE
  return cudaErrorInvalidValue;
}

}  // extern "C"
