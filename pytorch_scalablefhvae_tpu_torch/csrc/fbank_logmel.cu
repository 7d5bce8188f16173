// Fused window + real DFT + magnitude + mel projection + floored log (sm_90a).
//
// Replaces the TPU kernel pytorch_scalablefhvae_tpu/ops/fbank_pallas.py:
// fused_logmel_frames (kernel body _kernel). For N raw frames of n_fft
// samples it writes [N, M] float32:
//   f   = frames * window                          [N, n_fft]
//   re  = f @ cos_basis,  im = f @ sin_basis       [N, K], K = n_fft / 2 + 1
//   mag = sqrt(re^2 + im^2 + 1e-30)
//   out = max(log(max(mag @ mel_fb_t, 1e-38)), log_floor)
// all in fp32 (FMA, no TF32, no tensor cores). The windowed frames, re, im
// and mag never reach device memory: only [N, M] is written. Inference only.
//
// What bounds it on the H100: operations. At the serving shape (N 6,560,
// n_fft 400, K 201, M 80) the three products are 2.32 GFLOP of fp32 FMA
// against 13.3 MB moved (frames read once, the bases and the mel bank once,
// the output written once): 35 us at the fp32 rate outside the tensor cores,
// 4 us at the memory rate.
//
// What the design does about it: one block per tile of kTile = 32 frames.
//  1. The tile is read once (coalesced along n_fft), multiplied by the window
//     and kept TRANSPOSED in shared memory, xs[n][frame], with a row pitch of
//     kTile + 4 floats so that a thread's 8 frames are two aligned float4.
//  2. Each thread owns one DFT bin k and 8 of the tile's frames: 16 fp32
//     accumulators (re, im). Per sample n it reads cos[n][k] and sin[n][k]
//     (neighbouring threads read neighbouring k: coalesced, served by L1/L2,
//     the 0.64 MB of bases stay in L2 for every block) and two float4 of xs
//     (the same address across a warp: a broadcast), then does 16 FMAs. At
//     the default K the 4 x 201 (group, bin) items are one per thread of an
//     832-thread block.
//  3. The magnitude goes to shared memory, again transposed, mag[k][frame].
//  4. Each thread owns one mel band m and 4 frames, walks k with one read of
//     mel_fb_t[k][m] (coalesced) and one float4 of mag, applies the floored
//     log and writes out[frame][m] (coalesced along m).
// Ragged N: rows past N are zero in shared memory and are not written. K and
// n_fft need not be multiples of anything: every loop is bounded, nothing is
// padded to a lane or tile multiple as the TPU kernel had to.
//
// No fast-math and no flush-to-zero: 1e-38 is below the smallest normal
// float, and log/sqrt must be the full-precision ones for a silent frame to
// reach the floor the way the plain version does.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 32;          // frames per block
constexpr int kPitch = kTile + 4;  // floats per shared-memory row
constexpr int kDftFrames = 8;      // frames per thread in the DFT phase
constexpr int kMelFrames = 4;      // frames per thread in the mel phase
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may take

__global__ void __launch_bounds__(kMaxThreads) fbank_logmel_kernel(
    const float* __restrict__ frames,   // [N, n_fft]
    const float* __restrict__ window,   // [n_fft]
    const float* __restrict__ cosb,     // [n_fft, K]
    const float* __restrict__ sinb,     // [n_fft, K]
    const float* __restrict__ fb_t,     // [K, M]
    float* __restrict__ out,            // [N, M]
    long long N, int n_fft, int K, int M, float log_floor) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                    // [n_fft][kPitch] windowed frames
  float* mag = smem + n_fft * kPitch;  // [K][kPitch] magnitudes
  const long long f0 = static_cast<long long>(blockIdx.x) * kTile;

  // 1. windowed tile, transposed
  for (int i = threadIdx.x; i < kTile * n_fft; i += blockDim.x) {
    const int f = i / n_fft;
    const int n = i - f * n_fft;
    const long long row = f0 + f;
    xs[n * kPitch + f] = row < N ? frames[row * n_fft + n] * window[n] : 0.0f;
  }
  __syncthreads();

  // 2. + 3. real DFT of 8 frames at one bin, then the magnitude
  constexpr int kGroups = kTile / kDftFrames;
  for (int item = threadIdx.x; item < kGroups * K; item += blockDim.x) {
    const int g = item / K;
    const int k = item - g * K;
    float re[kDftFrames], im[kDftFrames];
#pragma unroll
    for (int j = 0; j < kDftFrames; ++j) re[j] = im[j] = 0.0f;
    const float* xg = xs + g * kDftFrames;
    const float* cp = cosb + k;
    const float* sp = sinb + k;
    for (int n = 0; n < n_fft; ++n) {
      const float c = __ldg(cp + static_cast<size_t>(n) * K);
      const float s = __ldg(sp + static_cast<size_t>(n) * K);
      const float4 a = *reinterpret_cast<const float4*>(xg + n * kPitch);
      const float4 b = *reinterpret_cast<const float4*>(xg + n * kPitch + 4);
      const float x[kDftFrames] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < kDftFrames; ++j) {
        re[j] = fmaf(x[j], c, re[j]);
        im[j] = fmaf(x[j], s, im[j]);
      }
    }
    float* mg = mag + k * kPitch + g * kDftFrames;
#pragma unroll
    for (int j = 0; j < kDftFrames; ++j) {
      mg[j] = sqrtf(re[j] * re[j] + im[j] * im[j] + 1e-30f);
    }
  }
  __syncthreads();

  // 4. mel projection of 4 frames at one band, floored log
  constexpr int kMelGroups = kTile / kMelFrames;
  for (int item = threadIdx.x; item < kMelGroups * M; item += blockDim.x) {
    const int g = item / M;
    const int m = item - g * M;
    float acc[kMelFrames] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* mg = mag + g * kMelFrames;
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(fb_t + static_cast<size_t>(k) * M + m);
      const float4 a = *reinterpret_cast<const float4*>(mg + k * kPitch);
      acc[0] = fmaf(a.x, w, acc[0]);
      acc[1] = fmaf(a.y, w, acc[1]);
      acc[2] = fmaf(a.z, w, acc[2]);
      acc[3] = fmaf(a.w, w, acc[3]);
    }
#pragma unroll
    for (int j = 0; j < kMelFrames; ++j) {
      const long long row = f0 + g * kMelFrames + j;
      if (row < N) {
        out[row * M + m] = fmaxf(logf(fmaxf(acc[j], 1e-38f)), log_floor);
      }
    }
  }
}

size_t smem_bytes(int n_fft, int K) {
  return static_cast<size_t>(n_fft + K) * kPitch * sizeof(float);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block needs for this n_fft and K, and the
// most a block may take.
long long sfhvae_fbank_logmel_smem(int n_fft, int K) {
  return static_cast<long long>(smem_bytes(n_fft, K));
}
int sfhvae_fbank_logmel_max_smem() { return kMaxSmem; }

// frames: [N, n_fft]; window: [n_fft]; cos_basis, sin_basis: [n_fft, K];
// mel_fb_t: [K, M]; out: [N, M]; all fp32, contiguous. N > 0. Returns the
// cudaError_t of the launch.
int sfhvae_fbank_logmel(const void* frames, const void* window,
                        const void* cos_basis, const void* sin_basis,
                        const void* mel_fb_t, void* out, long long N,
                        int n_fft, int K, int M, float log_floor,
                        void* stream) {
  const size_t smem = smem_bytes(n_fft, K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fbank_logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  // one (8-frame group, bin) item per thread where the block allows it
  int work = (kTile / kDftFrames) * K;
  const int mel_work = (kTile / kMelFrames) * M;
  if (mel_work > work) work = mel_work;
  int threads = ((work + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const long long blocks = (N + kTile - 1) / kTile;
  fbank_logmel_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(window),
      static_cast<const float*>(cos_basis),
      static_cast<const float*>(sin_basis),
      static_cast<const float*>(mel_fb_t), static_cast<float*>(out), N, n_fft,
      K, M, log_floor);
  return cudaGetLastError();
}

}  // extern "C"
