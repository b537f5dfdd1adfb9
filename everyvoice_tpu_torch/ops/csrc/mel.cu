// Batched log-mel spectrogram in one launch, for sm_90a.
//
// Replaces the Pallas TPU kernel everyvoice_tpu/ops/mel_pallas.py::fused_log_mel
// (body _mel_kernel). Same function, for (B, S) float32 audio:
//     frame f, sample n:  x[reflect(f*hop + n - n_fft/2)] * window[n]
//     re, im = frames @ cos, frames @ (-sin)       (real DFT, n_bins columns)
//     mag    = sqrt(re^2 + im^2 + 1e-9)
//     out    = log(max(mag @ melw, 1e-5))          -> (B, n_mels, S/hop + 1)
// reflect() mirrors without repeating the edge sample, as jnp.pad and torch's
// "reflect" do. The window, the DFT bases and the mel weights are the ones
// the wrapper builds with the JAX package's numpy code; the kernel computes
// no sines of its own, so its constants are bit-identical to the reference's.
// Every product and sum is a float32 FMA on the CUDA cores: the reference runs
// these matmuls at Precision.HIGHEST, so no TF32 and no bf16.
//
// What bounds it on an H100: operations. The DFT as a matrix product costs
// 4*n_fft*n_bins FLOPs a frame (2.1 MFLOP at n_fft 1024) against 4*hop bytes
// of new audio and 4*n_mels bytes of output, so the arithmetic intensity is
// in the thousands of FLOP/byte: far above the 20 FLOP/byte at which float32
// FMA (67 TFLOP/s) overtakes HBM3 (3.35 TB/s). The function itself needs far
// less: a real FFT is about 2.5*n_fft*log2(n_fft) FLOPs a frame (25.6 kFLOP
// at n_fft 1024, 80x fewer), which puts its bound near the bytes' bound.
//
// What the design keeps out of device memory, as the TPU kernel does: the
// frames, the (frames x n_bins) spectrum and the magnitudes. A block owns 32
// frames of one batch row and walks over the bins in tiles of 64. For each
// bin tile it accumulates re and im over n_fft in chunks of 32 samples: the
// windowed frame samples (read from the audio through reflect-index
// arithmetic, so the padded signal never exists either) and the matching
// slice of the cos / -sin bases are staged in shared memory, and each thread
// keeps a 4-frame x 4-bin register tile of re and of im. The tile's
// magnitudes go to shared memory and are multiplied at once into a
// 32 x n_mels mel accumulator that stays in registers across bin tiles. The
// log is taken and the (n_mels, 32) output tile written once.
//
// What this simple design leaves on the table: the DFT runs as a matrix
// product instead of an FFT;
// float32 FMA instead of the tensor cores (3xTF32 split products would keep
// float32 accuracy); shared-memory chunks are loaded without double
// buffering; the bases are re-read from L2 by every block; and bins whose
// mel weights are all zero (above f_max) are computed anyway.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTM = 32;   // frames per block
constexpr int kTB = 64;   // bins per tile
constexpr int kBK = 32;   // samples per shared-memory chunk
constexpr int kFPT = 4;   // frames per thread
constexpr int kBPT = 4;   // bins per thread
constexpr int kGroups = 16;           // bin (and mel) groups of threads
constexpr int kMaxMelPerThread = 8;   // n_mels <= kGroups * 8 = 128
constexpr int kALd = kBK + 1;         // frame-major stride of the frame chunk
constexpr int kMagLd = kTM + 4;       // bin-major stride of the magnitudes
constexpr float kClipVal = 1e-5f;     // floor of the mel before the log

static_assert(kThreads == (kTM / kFPT) * kGroups, "thread layout");
static_assert(kTB == kBPT * kGroups, "bin layout");

// basis: (n_tiles, n_fft, 2*kTB) float32; row n of tile t holds cos then -sin
// of bins t*kTB .. t*kTB+63 (zero past the last bin). melw: (n_tiles*kTB,
// n_mels), zero past the last bin. window: (n_fft,), already centre-padded.
__global__ void __launch_bounds__(kThreads)
    log_mel_kernel(const float* __restrict__ audio,
                   const float* __restrict__ window,
                   const float* __restrict__ basis,
                   const float* __restrict__ melw, float* __restrict__ out,
                   int S, int n_frames, int n_fft, int hop, int n_tiles,
                   int n_mels) {
  extern __shared__ float smem[];
  float* a_s = smem;                      // kTM x kALd
  float* b_s = a_s + kTM * kALd;          // kBK x 2*kTB
  float* mag_s = b_s + kBK * 2 * kTB;     // kTB x kMagLd
  float* mw_s = mag_s + kTB * kMagLd;     // kTB x n_mels

  const int tid = threadIdx.x;
  const int tm = tid / kGroups;  // frames tm*4 .. tm*4+3 of the block
  const int tn = tid % kGroups;  // bins tn*4 .. tn*4+3 of a tile; mels tn + 16q
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTM;
  const float* x = audio + (size_t)b * S;
  const int pad = n_fft / 2;
  const int mel_groups = (n_mels + kGroups - 1) / kGroups;

  float mel_acc[kFPT][kMaxMelPerThread];
#pragma unroll
  for (int i = 0; i < kFPT; ++i)
#pragma unroll
    for (int q = 0; q < kMaxMelPerThread; ++q) mel_acc[i][q] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    float re[kFPT][kBPT], im[kFPT][kBPT];
#pragma unroll
    for (int i = 0; i < kFPT; ++i)
#pragma unroll
      for (int j = 0; j < kBPT; ++j) re[i][j] = im[i][j] = 0.f;
    const float* basis_t = basis + (size_t)tile * n_fft * 2 * kTB;

    for (int k0 = 0; k0 < n_fft; k0 += kBK) {
      // Windowed frame samples; a warp reads 32 consecutive samples of one
      // frame, so the reads coalesce and the stores hit 32 banks. Samples
      // and basis rows past n_fft (the last chunk, when kBK does not divide
      // n_fft) are zeros.
      for (int idx = tid; idx < kTM * kBK; idx += kThreads) {
        const int k = idx % kBK;
        const int m = idx / kBK;
        const int f = f0 + m;
        float v = 0.f;
        if (f < n_frames && k0 + k < n_fft) {
          int i = f * hop + k0 + k - pad;
          if (i < 0) i = -i;
          if (i >= S) i = 2 * (S - 1) - i;
          v = x[i] * window[k0 + k];
        }
        a_s[m * kALd + k] = v;
      }
      const float4* src =
          reinterpret_cast<const float4*>(basis_t + (size_t)k0 * 2 * kTB);
      float4* dst = reinterpret_cast<float4*>(b_s);
      for (int idx = tid; idx < kBK * 2 * kTB / 4; idx += kThreads)
        dst[idx] = k0 + idx / (2 * kTB / 4) < n_fft
                       ? src[idx]
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      __syncthreads();

#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        float a[kFPT];
#pragma unroll
        for (int i = 0; i < kFPT; ++i) a[i] = a_s[(tm * kFPT + i) * kALd + k];
        const float4 c =
            *reinterpret_cast<const float4*>(b_s + k * 2 * kTB + tn * kBPT);
        const float4 s = *reinterpret_cast<const float4*>(
            b_s + k * 2 * kTB + kTB + tn * kBPT);
#pragma unroll
        for (int i = 0; i < kFPT; ++i) {
          re[i][0] = fmaf(a[i], c.x, re[i][0]);
          re[i][1] = fmaf(a[i], c.y, re[i][1]);
          re[i][2] = fmaf(a[i], c.z, re[i][2]);
          re[i][3] = fmaf(a[i], c.w, re[i][3]);
          im[i][0] = fmaf(a[i], s.x, im[i][0]);
          im[i][1] = fmaf(a[i], s.y, im[i][1]);
          im[i][2] = fmaf(a[i], s.z, im[i][2]);
          im[i][3] = fmaf(a[i], s.w, im[i][3]);
        }
      }
      __syncthreads();
    }

    // This tile's magnitudes (bin-major) and mel weights, then
    // mel[frame][mel] += sum over the tile's bins of mag * melw.
#pragma unroll
    for (int i = 0; i < kFPT; ++i)
#pragma unroll
      for (int j = 0; j < kBPT; ++j)
        mag_s[(tn * kBPT + j) * kMagLd + tm * kFPT + i] =
            sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j] + 1e-9f);
    const float* melw_t = melw + (size_t)tile * kTB * n_mels;
    for (int idx = tid; idx < kTB * n_mels; idx += kThreads) mw_s[idx] = melw_t[idx];
    __syncthreads();

    for (int j = 0; j < kTB; ++j) {
      const float4 mg =
          *reinterpret_cast<const float4*>(mag_s + j * kMagLd + tm * kFPT);
#pragma unroll
      for (int q = 0; q < kMaxMelPerThread; ++q) {
        const int mel = q * kGroups + tn;
        if (q < mel_groups && mel < n_mels) {
          const float w = mw_s[j * n_mels + mel];
          mel_acc[0][q] = fmaf(mg.x, w, mel_acc[0][q]);
          mel_acc[1][q] = fmaf(mg.y, w, mel_acc[1][q]);
          mel_acc[2][q] = fmaf(mg.z, w, mel_acc[2][q]);
          mel_acc[3][q] = fmaf(mg.w, w, mel_acc[3][q]);
        }
      }
    }
    __syncthreads();
  }

  float* ob = out + (size_t)b * n_mels * n_frames;
#pragma unroll
  for (int q = 0; q < kMaxMelPerThread; ++q) {
    const int mel = q * kGroups + tn;
    if (q >= mel_groups || mel >= n_mels) continue;
#pragma unroll
    for (int i = 0; i < kFPT; ++i) {
      const int f = f0 + tm * kFPT + i;
      if (f < n_frames)
        ob[(size_t)mel * n_frames + f] = logf(fmaxf(mel_acc[i][q], kClipVal));
    }
  }
}

}  // namespace

extern "C" {

// Shared memory, in bytes, that one block of the kernel uses.
int log_mel_smem_bytes(int n_mels) {
  return (int)((kTM * kALd + kBK * 2 * kTB + kTB * kMagLd + kTB * n_mels) *
               sizeof(float));
}

// Launches the log-mel of (B, S) float32 `audio` into (B, n_mels, n_frames)
// float32 `out` on `stream`. `basis` is (n_tiles, n_fft, 128) and `melw`
// (n_tiles*64, n_mels), both zero past the last bin; `window` is (n_fft,).
// Returns cudaGetLastError() after the launch, or -1 for a configuration the
// kernel does not take.
int log_mel_launch(const void* audio, const void* window, const void* basis,
                   const void* melw, void* out, int B, int S, int n_frames,
                   int n_fft, int hop, int n_tiles, int n_mels, void* stream) {
  if (B <= 0 || S <= n_fft / 2 || n_frames <= 0 || n_fft <= 0 ||
      hop <= 0 || n_tiles <= 0 || n_tiles * kTB < n_fft / 2 + 1 || n_mels <= 0 ||
      n_mels > kGroups * kMaxMelPerThread || B > 65535)
    return -1;
  const int smem = log_mel_smem_bytes(n_mels);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + kTM - 1) / kTM, B);
  log_mel_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(window),
      static_cast<const float*>(basis), static_cast<const float*>(melw),
      static_cast<float*>(out), S, n_frames, n_fft, hop, n_tiles, n_mels);
  return (int)cudaGetLastError();
}

}  // extern "C"
