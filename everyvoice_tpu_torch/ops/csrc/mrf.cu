// One whole HiFiGAN multi-receptive-field (MRF) stage in one launch, for
// sm_90a.
//
// Replaces the Pallas TPU kernel everyvoice_tpu/ops/mrf_pallas.py::fused_mrf
// (body _mrf_kernel). Same function: for each ResBlock1 chain (kernel k,
// dilations ds) and each d in ds,
//     y   = conv_{k,d}(leaky(cur));  y = conv_{k,1}(leaky(y));  cur += y
// with every conv a "SAME" zero-padded 1-D conv over time whose output rows
// outside [0, T) are re-zeroed; the stage output is the mean of the chains'
// final `cur`. Conv operands (leaky activations, weights, biases) are rounded
// to the I/O type (float or bf16); products accumulate in float32 and the
// chain state stays float32, as in the TPU kernel.
//
// What bounds it on an H100: one stage does 2*B*T*C^2*sum(6*k) FLOPs (126*2
// per B*T*C^2 for V1's kernels 3/7/11 with three dilations) against one read
// and one write of the (B, T, C) activation, so it is compute-bound at every
// V1 stage (C = 256..32; arithmetic intensity > 2000 FLOP/byte).
//
// Design. The grid is persistent: each block walks over (batch, time tile)
// work items. A work item owns a window of t_tile + 2*halo rows (halo = the
// largest chain's one-sided receptive field, 60 for k=11 and d=1/3/5) held in
// a per-block float32 scratch slab in device memory: `cur` (window x C),
// `y` (window x C) and the running chain total (t_tile x C). Each conv is a
// tiled GEMM over (rows x C_out) with depth k*C_in: a 16-channel slice of the
// shifted input rows (all taps share it) and the matching weight slices are
// staged in shared memory, and each thread keeps an 8x4 register tile of
// float32 sums. Each conv computes only the rows the rest of the chain still
// needs, so the window shrinks by the conv's reach after every conv and a
// chain ends exactly on the tile's centre rows. __syncthreads() separates the
// convs; nothing crosses blocks.
//
// What this simple design leaves on the table: it runs on the CUDA cores in
// float32 FMA (67 TFLOP/s peak) instead of the tensor cores (989 TFLOP/s
// bf16 via wgmma); the intermediates go through the scratch slab (L2 and
// device memory) instead of staying in shared memory; operand tiles are
// loaded with plain loads, not TMA, so loads and FMAs do not overlap; and the
// halo rows are recomputed by neighbouring tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MRF_MAX_CHAINS 4
#define MRF_MAX_DILS 4

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // input channels per shared-memory slice
constexpr int kTM = 8;   // rows per thread
constexpr int kTN = 4;   // output channels per thread

struct MrfSpec {
  int n_chains;
  int ksize[MRF_MAX_CHAINS];
  int n_dils[MRF_MAX_CHAINS];
  int dils[MRF_MAX_CHAINS][MRF_MAX_DILS];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The value an operand of type T holds after rounding v to it.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return fmaxf(v, slope * v);
}

// dst[r] (=|+=) mask(r) * (bias + sum_j sum_ci round(leaky(src[r + (j-c)*d]))
// * w[j, ci, :]) for window rows r in [r0, r1). src and dst are (window, C)
// row-major float32 slabs; w is (k*C, C) tap-major; t_first is the global
// time index of window row 0.
template <typename T, int BN>
__device__ void conv_pass(const float* __restrict__ src,
                          float* __restrict__ dst,
                          const T* __restrict__ w,
                          const T* __restrict__ bias,
                          float* __restrict__ a_s,
                          float* __restrict__ b_s,
                          int a_stride, int r0, int r1, int k, int d, int C,
                          int t_first, int T_len, float slope, bool accumulate) {
  constexpr int NT_N = BN / kTN;
  constexpr int NT_M = kThreads / NT_N;
  constexpr int BM = NT_M * kTM;
  const int tid = threadIdx.x;
  const int tn = tid % NT_N;
  const int tm = tid / NT_N;
  const int centre = (k - 1) / 2;
  const int reach = centre * d;
  const int in_end = r1 + reach;  // first window row past the valid input
  const int a_rows = BM + (k - 1) * d;
  const int n_row_tiles = (r1 - r0 + BM - 1) / BM;
  const int n_col_tiles = C / BN;

  for (int tile = 0; tile < n_row_tiles * n_col_tiles; ++tile) {
    const int m0 = r0 + (tile / n_col_tiles) * BM;
    const int n0 = (tile % n_col_tiles) * BN;
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int n = 0; n < kTN; ++n) acc[i][n] = 0.f;

    for (int ci0 = 0; ci0 < C; ci0 += kBK) {
      // Shifted input rows [m0 - reach, m0 + BM + reach), stored
      // channel-major so a thread's 8 rows are contiguous.
      for (int idx = tid; idx < a_rows * kBK; idx += kThreads) {
        const int kk = idx % kBK;
        const int r = idx / kBK;
        const int row = m0 - reach + r;
        float v = 0.f;
        if (row < in_end) v = round_to<T>(leaky(src[row * C + ci0 + kk], slope));
        a_s[kk * a_stride + r] = v;
      }
      // Weight slices of every tap: (k, BK, BN).
      for (int idx = tid; idx < k * kBK * BN; idx += kThreads) {
        const int n = idx % BN;
        const int kk = (idx / BN) % kBK;
        const int j = idx / (BN * kBK);
        b_s[idx] = to_float(w[(j * C + ci0 + kk) * C + n0 + n]);
      }
      __syncthreads();
      for (int j = 0; j < k; ++j) {
        const float* a_j = a_s + tm * kTM + j * d;
        const float* b_j = b_s + j * kBK * BN + tn * kTN;
#pragma unroll 4
        for (int kk = 0; kk < kBK; ++kk) {
          const float4 bv = *reinterpret_cast<const float4*>(b_j + kk * BN);
          float av[kTM];
#pragma unroll
          for (int i = 0; i < kTM; ++i) av[i] = a_j[kk * a_stride + i];
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
            acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
            acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
            acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
          }
        }
      }
      __syncthreads();
    }

    float bv[kTN];
#pragma unroll
    for (int n = 0; n < kTN; ++n) bv[n] = to_float(bias[n0 + tn * kTN + n]);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = m0 + tm * kTM + i;
      if (row >= r1) continue;
      const int t = t_first + row;
      const bool in_seq = t >= 0 && t < T_len;
      float* out = dst + row * C + n0 + tn * kTN;
#pragma unroll
      for (int n = 0; n < kTN; ++n) {
        const float v = in_seq ? acc[i][n] + bv[n] : 0.f;
        out[n] = accumulate ? out[n] + v : v;
      }
    }
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    mrf_stage_kernel(const T* __restrict__ x, T* __restrict__ out,
                     const T* __restrict__ w, const T* __restrict__ bias,
                     float* __restrict__ scratch, int B, int T_len, int C,
                     int t_tile, int halo, int a_stride, MrfSpec spec,
                     float slope) {
  extern __shared__ float smem[];
  const int b_offset = kBK * a_stride;
  float* a_s = smem;
  float* b_s = smem + b_offset;

  const int window = t_tile + 2 * halo;
  float* cur = scratch + (size_t)blockIdx.x * (size_t)(2 * window + t_tile) * C;
  float* y = cur + (size_t)window * C;
  float* total = y + (size_t)window * C;
  const int n_tiles = (T_len + t_tile - 1) / t_tile;
  const int n_items = B * n_tiles;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int b = item / n_tiles;
    const int t0 = (item % n_tiles) * t_tile;
    const int t_first = t0 - halo;  // global time of window row 0
    const T* xb = x + (size_t)b * T_len * C;

    size_t w_off = 0;
    int b_off = 0;
    for (int c = 0; c < spec.n_chains; ++c) {
      const int k = spec.ksize[c];
      const int centre = (k - 1) / 2;
      int chain_halo = 0;
      for (int u = 0; u < spec.n_dils[c]; ++u)
        chain_halo += centre * (spec.dils[c][u] + 1);
      int lo = halo - chain_halo;
      int hi = halo + t_tile + chain_halo;

      for (int idx = threadIdx.x; idx < (hi - lo) * C; idx += kThreads) {
        const int row = lo + idx / C;
        const int ch = idx % C;
        const int t = t_first + row;
        cur[row * C + ch] =
            (t >= 0 && t < T_len) ? to_float(xb[(size_t)t * C + ch]) : 0.f;
      }
      __syncthreads();

      for (int u = 0; u < spec.n_dils[c]; ++u) {
        const int d = spec.dils[c][u];
        const int p1 = centre * d;
        conv_pass<T, BN>(cur, y, w + w_off, bias + b_off, a_s, b_s, a_stride,
                         lo + p1, hi - p1, k, d, C, t_first, T_len, slope,
                         false);
        w_off += (size_t)k * C * C;
        b_off += C;
        __syncthreads();
        const int p2 = centre;
        conv_pass<T, BN>(y, cur, w + w_off, bias + b_off, a_s, b_s, a_stride,
                         lo + p1 + p2, hi - p1 - p2, k, 1, C, t_first, T_len,
                         slope, true);
        w_off += (size_t)k * C * C;
        b_off += C;
        __syncthreads();
        lo += p1 + p2;
        hi -= p1 + p2;
      }

      for (int idx = threadIdx.x; idx < t_tile * C; idx += kThreads) {
        const float v = cur[(halo * C) + idx];
        total[idx] = c == 0 ? v : total[idx] + v;
      }
      __syncthreads();
    }

    const float n_chains = (float)spec.n_chains;
    T* ob = out + (size_t)b * T_len * C;
    for (int idx = threadIdx.x; idx < t_tile * C; idx += kThreads) {
      const int t = t0 + idx / C;
      if (t < T_len) ob[(size_t)t * C + idx % C] = from_float<T>(total[idx] / n_chains);
    }
    __syncthreads();
  }
}

template <typename T, int BN>
int launch(const void* x, void* out, const void* w, const void* bias,
           void* scratch, int B, int T_len, int C, int t_tile, int halo,
           int grid, const MrfSpec& spec, float slope, cudaStream_t stream) {
  int k_max = 0, span_max = 0;
  for (int c = 0; c < spec.n_chains; ++c) {
    const int k = spec.ksize[c];
    if (k > k_max) k_max = k;
    for (int u = 0; u < spec.n_dils[c]; ++u) {
      const int span = (k - 1) * spec.dils[c][u];
      if (span > span_max) span_max = span;
    }
  }
  constexpr int BM = (kThreads / (BN / kTN)) * kTM;
  const int a_stride = BM + span_max;
  const size_t smem = (size_t)(kBK * a_stride + k_max * kBK * BN) * sizeof(float);
  auto kernel = mrf_stage_kernel<T, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<float*>(scratch), B, T_len, C, t_tile, halo, a_stride, spec,
      slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one MRF stage on `stream`. x and out are (B, T, C) contiguous,
// w is every conv's (k*C, C) weight concatenated in chain order, bias every
// conv's (C,) bias, all of the I/O type (is_bf16 selects bf16, else float).
// scratch holds grid * (2*(t_tile + 2*halo) + t_tile) * C floats.
// dils is (n_chains, MRF_MAX_DILS) row-major. Returns cudaGetLastError()
// after the launch, or -1 for a configuration the kernel does not take.
int mrf_stage_launch(const void* x, void* out, const void* w, const void* bias,
                     void* scratch, int B, int T_len, int C, int t_tile,
                     int halo, int grid, int is_bf16, int n_chains,
                     const int* ksizes, const int* n_dils, const int* dils,
                     float slope, void* stream) {
  if (n_chains < 1 || n_chains > MRF_MAX_CHAINS || C % 32 != 0 || C <= 0 ||
      t_tile <= 0 || grid <= 0 || B <= 0 || T_len <= 0)
    return -1;
  MrfSpec spec;
  spec.n_chains = n_chains;
  for (int c = 0; c < n_chains; ++c) {
    spec.ksize[c] = ksizes[c];
    spec.n_dils[c] = n_dils[c];
    if (ksizes[c] % 2 == 0 || n_dils[c] < 1 || n_dils[c] > MRF_MAX_DILS)
      return -1;
    for (int u = 0; u < MRF_MAX_DILS; ++u) spec.dils[c][u] = dils[c * MRF_MAX_DILS + u];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = C % 64 == 0;
  if (is_bf16) {
    return wide ? launch<__nv_bfloat16, 64>(x, out, w, bias, scratch, B, T_len, C,
                                            t_tile, halo, grid, spec, slope, s)
                : launch<__nv_bfloat16, 32>(x, out, w, bias, scratch, B, T_len, C,
                                            t_tile, halo, grid, spec, slope, s);
  }
  return wide ? launch<float, 64>(x, out, w, bias, scratch, B, T_len, C, t_tile,
                                  halo, grid, spec, slope, s)
              : launch<float, 32>(x, out, w, bias, scratch, B, T_len, C, t_tile,
                                  halo, grid, spec, slope, s);
}

}  // extern "C"
