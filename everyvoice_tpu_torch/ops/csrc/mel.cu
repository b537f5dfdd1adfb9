// Batched log-mel spectrogram in one launch, for sm_90a: an FFT kernel for
// power-of-two n_fft and a DFT kernel for any other n_fft.
//
// Replaces the Pallas TPU kernel everyvoice_tpu/ops/mel_pallas.py::fused_log_mel
// (body _mel_kernel). Same function, for (B, S) float32 audio:
//     frame f, sample n:  x[reflect(f*hop + n - n_fft/2)] * window[n]
//     re, im = real DFT of the frame               (n_fft/2 + 1 bins)
//     mag    = sqrt(re^2 + im^2 + 1e-9)
//     out    = log(max(mag @ melw, 1e-5))          -> (B, n_mels, S/hop + 1)
// reflect() mirrors without repeating the edge sample, as jnp.pad and torch's
// "reflect" do. The window, the twiddles, the DFT bases and the mel weights
// are built by the wrapper with numpy in float64 and rounded once to float32;
// the kernels compute no sines of their own. Every product and sum is a
// float32 operation on the CUDA cores (no fast-math intrinsics): the
// reference runs its matmuls at Precision.HIGHEST, so no TF32 and no bf16.
//
// What bounds the function on an H100: about 29 kFLOP a frame at n_fft 1024
// (a real FFT, the magnitude, the mel basis's nonzeros, the log) against
// 4*hop bytes of new audio and 4*n_mels bytes of output, so its operations'
// bound (float32, 67 TFLOP/s) sits just above its bytes' bound (3.35 TB/s).
//
// The FFT kernel (log_mel_fft_kernel, n_fft = 2^6 .. 2^11). A block owns one
// batch row and up to 16 consecutive frames. It stages the frames' audio
// once, (F-1)*hop + n_fft samples read through reflect-index arithmetic
// (neighbouring frames share them, as the TPU kernel's row-shifted views
// do), and the constants: the centre-padded window, the twiddle table and
// the compacted mel weights. Each warp then takes a frame at a time:
//   - the n_fft real samples, windowed, are packed as n_fft/2 complex
//     points z[m] = x[2m] + i x[2m+1];
//   - a radix-2 Stockham FFT of n_fft/2 points runs in shared memory,
//     ping-ponging between the warp's two buffers with __syncwarp() between
//     stages (Stockham keeps natural order, so there is no bit reversal);
//   - the real-FFT split step X[k] = E[k] + W^k O[k] (E, O from Z[k] and
//     conj Z[n_fft/2 - k]) gives the bins that some mel filter uses, and
//     only those (bins above f_max are skipped), as magnitudes;
//   - each lane sums whole mel filters over their contiguous nonzero bin
//     ranges in ascending bin order and takes the log.
// The block's (n_mels, F) tile is written once. Only the audio, the
// constants and the log-mel cross device memory. Twiddles sit in one table
// of n_fft entries: stage Ns (Ns = 1, 2, .., n_fft/4) reads
// W_{2Ns}^k = exp(-2 pi i k / 2Ns) at [Ns - 1 + k], so a stage's lanes read
// consecutive entries; the split step reads W_{n_fft}^k, k = 0..n_fft/2, at
// [n_fft/2 - 1 + k].
//
// What the FFT kernel leaves on the table: radix 2 (radix 4 would halve the
// stages and the shared-memory round trips); the stages' writes for Ns < 32
// are 2-way bank-conflicted (stride-2 float2 stores); lanes that sum the
// wide high mel filters wait on those that sum the narrow low ones.
//
// The DFT kernel (log_mel_dft_kernel, any other n_fft, e.g. 1000) is the
// first design: it computes the DFT as a matrix product against the cos and
// -sin bases, 4*n_fft*n_bins FLOPs a frame (2.1 MFLOP at n_fft 1024). A
// block owns 32 frames of one batch row and walks over the bins in tiles of
// 64. For each bin tile it accumulates re and im over n_fft in chunks of 32
// samples: the windowed frame samples and the matching slice of the bases
// are staged in shared memory, and each thread keeps a 4-frame x 4-bin
// register tile of re and of im. The tile's magnitudes go to shared memory
// and are multiplied at once into a 32 x n_mels mel accumulator that stays
// in registers across bin tiles. The log is taken and the (n_mels, 32)
// output tile written once.

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
    log_mel_dft_kernel(const float* __restrict__ audio,
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

// ---------------------------------------------------------------------------
// The FFT kernel.

constexpr int kFftFrames = 16;         // frames per block, at most
constexpr int kMaxSmem = 232448;       // shared memory a block may use (227 KB)

template <int N>
struct FftShape {
  static constexpr int kHalf = N / 2;                 // complex points
  static constexpr int kWarps = N <= 1024 ? 8 : 4;    // frames in flight
  static constexpr int kThreads = 32 * kWarps;
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Shared-memory bytes of one FFT block with `frames` frames.
size_t fft_smem_bytes(int n_fft, int warps, int frames, int hop, int n_mels,
                      int n_weights) {
  return sizeof(float2) * ((size_t)warps * n_fft + n_fft) +
         sizeof(float) * ((size_t)n_fft + (size_t)(frames - 1) * hop + n_fft +
                          (size_t)n_mels * (frames + 1) + n_weights) +
         sizeof(int) * 3 * (size_t)n_mels;
}

// twiddle: (N,) complex, the stage tables then W_N^k for k = 0..N/2 (see the
// note at the top). window: (N,), centre-padded. mel_w: the mel filters'
// nonzero weights, filter after filter; mel_range: (3, n_mels) int32 rows
// lo, hi and offset into mel_w of each filter's bins [lo, hi). Bins at or
// above n_used are in no filter. Each block has F frames of row blockIdx.y.
template <int N>
__global__ void __launch_bounds__(FftShape<N>::kThreads)
    log_mel_fft_kernel(const float* __restrict__ audio,
                       const float* __restrict__ window,
                       const float2* __restrict__ twiddle,
                       const float* __restrict__ mel_w,
                       const int* __restrict__ mel_range,
                       float* __restrict__ out, int S, int n_frames, int hop,
                       int F, int n_mels, int n_weights, int n_used) {
  constexpr int M = FftShape<N>::kHalf;
  constexpr int kWarps = FftShape<N>::kWarps;
  constexpr int kIters = (M / 2 + 31) / 32;  // butterflies a lane takes a stage
  extern __shared__ float2 smem2[];
  float2* bufs = smem2;                       // kWarps x 2 x M
  float2* tw_s = bufs + kWarps * N;           // N
  float* win_s = reinterpret_cast<float*>(tw_s + N);  // N
  float* x_s = win_s + N;                     // (F - 1) * hop + N
  float* out_s = x_s + (F - 1) * hop + N;     // n_mels x (F + 1)
  float* w_s = out_s + n_mels * (F + 1);      // n_weights
  int* range_s = reinterpret_cast<int*>(w_s + n_weights);  // 3 x n_mels

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * F;
  const int nf = min(F, n_frames - f0);
  const float* x = audio + (size_t)b * S;

  for (int i = tid; i < N; i += blockDim.x) {
    tw_s[i] = twiddle[i];
    win_s[i] = window[i];
  }
  for (int i = tid; i < n_weights; i += blockDim.x) w_s[i] = mel_w[i];
  for (int i = tid; i < 3 * n_mels; i += blockDim.x) range_s[i] = mel_range[i];
  const int span = (nf - 1) * hop + N;
  const int g0 = f0 * hop - N / 2;
  for (int s = tid; s < span; s += blockDim.x) {
    int i = g0 + s;
    if (i < 0) i = -i;
    if (i >= S) i = 2 * (S - 1) - i;
    x_s[s] = x[i];
  }
  __syncthreads();

  float2* const ping = bufs + warp * N;
  float2* const pong = ping + M;
  const float2* const split_tw = tw_s + (M - 1);  // W_N^k, k = 0..M
  for (int fl = warp; fl < nf; fl += kWarps) {
    const float* fr = x_s + fl * hop;
    // Stage Ns = 1 (twiddle 1), reading the windowed frame as z[m].
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int j = lane + 32 * it;
      if (j < M / 2) {
        const float2 v0 = make_float2(fr[2 * j] * win_s[2 * j],
                                      fr[2 * j + 1] * win_s[2 * j + 1]);
        const float2 v1 = make_float2(fr[2 * j + M] * win_s[2 * j + M],
                                      fr[2 * j + M + 1] * win_s[2 * j + M + 1]);
        ping[2 * j] = cadd(v0, v1);
        ping[2 * j + 1] = csub(v0, v1);
      }
    }
    __syncwarp();
    float2* src = ping;
    float2* dst = pong;
#pragma unroll
    for (int ns = 2; ns < M; ns <<= 1) {
      const float2* tw = tw_s + (ns - 1);
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        const int j = lane + 32 * it;
        if (j < M / 2) {
          const int k = j & (ns - 1);
          const float2 v0 = src[j];
          const float2 v1 = cmul(src[j + M / 2], tw[k]);
          const int d = ((j - k) << 1) + k;
          dst[d] = cadd(v0, v1);
          dst[d + ns] = csub(v0, v1);
        }
      }
      __syncwarp();
      float2* t = src;
      src = dst;
      dst = t;
    }

    // src holds Z, the FFT of z, in natural order. Split into the real
    // FFT's bins and keep their magnitudes (as floats) in dst.
    float* mag = reinterpret_cast<float*>(dst);
    for (int k = lane; k < n_used; k += 32) {
      const float2 p = src[k & (M - 1)];
      const float2 q = src[(M - k) & (M - 1)];
      const float2 e = make_float2(0.5f * (p.x + q.x), 0.5f * (p.y - q.y));
      const float2 o = make_float2(0.5f * (p.y + q.y), -0.5f * (p.x - q.x));
      const float2 x_k = cadd(e, cmul(o, split_tw[k]));
      mag[k] = sqrtf(x_k.x * x_k.x + x_k.y * x_k.y + 1e-9f);
    }
    __syncwarp();
    for (int m = lane; m < n_mels; m += 32) {
      const int lo = range_s[m];
      const int hi = range_s[n_mels + m];
      const float* w = w_s + range_s[2 * n_mels + m];
      float acc = 0.f;
      for (int k = lo; k < hi; ++k) acc = fmaf(mag[k], w[k - lo], acc);
      out_s[m * (F + 1) + fl] = logf(fmaxf(acc, kClipVal));
    }
    __syncwarp();  // the next frame reuses ping and pong
  }
  __syncthreads();

  float* ob = out + (size_t)b * n_mels * n_frames + f0;
  for (int idx = tid; idx < n_mels * nf; idx += blockDim.x) {
    const int m = idx / nf;
    const int fl = idx - m * nf;
    ob[(size_t)m * n_frames + fl] = out_s[m * (F + 1) + fl];
  }
}

template <int N>
int launch_fft(const void* audio, const void* window, const void* twiddle,
               const void* mel_w, const void* mel_range, void* out, int B,
               int S, int n_frames, int hop, int n_mels, int n_weights,
               int n_used, cudaStream_t stream) {
  constexpr int kWarps = FftShape<N>::kWarps;
  // As many frames per block as fit in shared memory, up to kFftFrames.
  int frames = kFftFrames;
  while (frames > 1 &&
         fft_smem_bytes(N, kWarps, frames, hop, n_mels, n_weights) > kMaxSmem)
    --frames;
  const size_t smem = fft_smem_bytes(N, kWarps, frames, hop, n_mels, n_weights);
  if (smem > kMaxSmem) return -1;
  auto kernel = log_mel_fft_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + frames - 1) / frames, B);
  kernel<<<grid, FftShape<N>::kThreads, smem, stream>>>(
      static_cast<const float*>(audio), static_cast<const float*>(window),
      static_cast<const float2*>(twiddle), static_cast<const float*>(mel_w),
      static_cast<const int*>(mel_range), static_cast<float*>(out), S,
      n_frames, hop, frames, n_mels, n_weights, n_used);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory, in bytes, that one block of the kernel uses.
int log_mel_dft_smem_bytes(int n_mels) {
  return (int)((kTM * kALd + kBK * 2 * kTB + kTB * kMagLd + kTB * n_mels) *
               sizeof(float));
}

// Launches the log-mel of (B, S) float32 `audio` into (B, n_mels, n_frames)
// float32 `out` on `stream`. `basis` is (n_tiles, n_fft, 128) and `melw`
// (n_tiles*64, n_mels), both zero past the last bin; `window` is (n_fft,).
// Returns cudaGetLastError() after the launch, or -1 for a configuration the
// kernel does not take.
int log_mel_dft_launch(const void* audio, const void* window, const void* basis,
                   const void* melw, void* out, int B, int S, int n_frames,
                   int n_fft, int hop, int n_tiles, int n_mels, void* stream) {
  if (B <= 0 || S <= n_fft / 2 || n_frames <= 0 || n_fft <= 0 ||
      hop <= 0 || n_tiles <= 0 || n_tiles * kTB < n_fft / 2 + 1 || n_mels <= 0 ||
      n_mels > kGroups * kMaxMelPerThread || B > 65535)
    return -1;
  const int smem = log_mel_dft_smem_bytes(n_mels);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + kTM - 1) / kTM, B);
  log_mel_dft_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(window),
      static_cast<const float*>(basis), static_cast<const float*>(melw),
      static_cast<float*>(out), S, n_frames, n_fft, hop, n_tiles, n_mels);
  return (int)cudaGetLastError();
}

// Launches the FFT log-mel of (B, S) float32 `audio` into (B, n_mels,
// n_frames) float32 `out` on `stream`, for n_fft a power of two from 64 to
// 2048. `twiddle` is (n_fft, 2), `window` (n_fft,), `mel_w` the filters'
// n_weights nonzero weights and `mel_range` (3, n_mels) int32 (lo, hi,
// offset); n_used is one past the last bin a filter uses. Returns
// cudaGetLastError() after the launch, or -1 for a configuration the kernel
// does not take.
int log_mel_fft_launch(const void* audio, const void* window,
                       const void* twiddle, const void* mel_w,
                       const void* mel_range, void* out, int B, int S,
                       int n_frames, int n_fft, int hop, int n_mels,
                       int n_weights, int n_used, void* stream) {
  if (B <= 0 || B > 65535 || S <= n_fft / 2 || n_frames <= 0 || hop <= 0 ||
      n_mels <= 0 || n_weights < 0 || n_used < 0 || n_used > n_fft / 2 + 1 ||
      (size_t)(n_frames - 1) * hop > (size_t)S)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MEL_FFT_CASE(n)                                                       \
  case n:                                                                    \
    return launch_fft<n>(audio, window, twiddle, mel_w, mel_range, out, B, S, \
                         n_frames, hop, n_mels, n_weights, n_used, s);
  switch (n_fft) {
    MEL_FFT_CASE(64)
    MEL_FFT_CASE(128)
    MEL_FFT_CASE(256)
    MEL_FFT_CASE(512)
    MEL_FFT_CASE(1024)
    MEL_FFT_CASE(2048)
    default:
      return -1;
  }
#undef MEL_FFT_CASE
}

}  // extern "C"
