// One whole HiFiGAN multi-receptive-field (MRF) stage, for sm_90a: a
// tensor-core path for bfloat16 and a CUDA-core path for float32.
//
// Replaces the Pallas TPU kernel everyvoice_tpu/ops/mrf_pallas.py::fused_mrf
// (body _mrf_kernel). Same function: for each ResBlock1 chain (kernel k,
// dilations ds) and each d in ds,
//     y   = conv_{k,d}(leaky(cur));  y = conv_{k,1}(leaky(y));  cur += y
// with every conv a "SAME" zero-padded 1-D conv over time whose output rows
// outside [0, T) are zero; the stage output is the mean of the chains'
// final `cur`. Conv operands (leaky activations, weights, biases) are rounded
// to the I/O type (float or bf16); products accumulate in float32 and the
// chain state stays float32, as in the TPU kernel.
//
// What bounds it on an H100: one stage does 2*B*T*C^2*sum(6*k) FLOPs (126*2
// per B*T*C^2 for V1's kernels 3/7/11 with three dilations) against one read
// and one write of the (B, T, C) activation, so it is compute-bound at every
// V1 stage (C = 256..32; arithmetic intensity > 2000 FLOP/byte).
//
// The bfloat16 path (mrf_stage_bf16_launch): every conv is an implicit GEMM
// on the tensor cores, launched over the whole (B, T) sequence, so there is
// no halo to recompute and no scratch slab. One launch per conv position of
// the stage, the chains side by side on blockIdx.z (heaviest kernel first):
//     prologue  act0 = bf16(leaky(x))                     (shared by chains)
//     per dilation step u of every chain that has one:
//       conv1   yact_c = bf16(leaky(conv(act_c or act0) + b))
//       conv2   cur_c  = (x or cur_c) + conv(yact_c) + b   (cur_c in place)
//               act_c  = bf16(leaky(cur_c))        while the chain goes on
//     finish    out = bf16(((cur_0 + cur_1) + ..) / n_chains)
// so a V1 stage takes 8 launches. The wrapper allocates cur_c (float32),
// act_c and yact_c (bf16), (B, T, C) each per chain; cur_c is updated in
// place, and act_0 doubles as act0. For one conv, M = the B*T output rows in
// tiles of 256 that never cross a batch row, N = C_out in tiles of 64 (32
// when C is not a multiple of 64), K = k*C_in in tap-major order, the packed
// weights' layout. A block of 8 warps stages, per 16-channel slice, the
// tile's input rows with the conv's reach on each side (zero-filled outside
// [0, T) by cp.async's src-size 0, which is the "SAME" padding) and all k
// taps' (16 x BN) weight slices; the k taps read that one staging at row
// offsets j*d. Slices are double-buffered through cp.async, so the next
// slice loads while the mma's run on this one (a deeper ring would leave
// room for fewer blocks on an SM). Operands reach registers by
// ldmatrix (.trans for the weights) from rows padded by 16 bytes against
// bank conflicts; each warp owns a 64 x 32 (or 32 x 32) tile of float32 sums
// and issues mma.sync.m16n8k16 bf16 -> f32. The epilogue fuses the bias, the
// leaky activation, the residual and the rounding to bf16.
//
// What the bf16 path leaves on the table: mma.sync, not wgmma with TMA
// (the only route to the full 989 TFLOP/s); the chain state and
// activations go through device memory between convs (about 16 bytes an
// element a dilation step); a block's weight slices are re-read from L2 by
// every row tile.
//
// The float32 path (mrf_stage_f32_launch) is the first design and keeps
// float32 FMA on the CUDA cores, since the tensor cores would round its
// operands to TF32. Its grid is persistent: each block walks over (batch,
// time tile) work items. A work item owns a window of t_tile + 2*halo rows
// (halo = the largest chain's one-sided receptive field, 60 for k=11 and
// d=1/3/5) held in a per-block float32 scratch slab in device memory: `cur`
// (window x C), `y` (window x C) and the running chain total (t_tile x C).
// Each conv is a tiled GEMM over (rows x C_out) with depth k*C_in: a
// 16-channel slice of the shifted input rows (all taps share it) and the
// matching weight slices are staged in shared memory, and each thread keeps
// an 8x4 register tile of float32 sums. Each conv computes only the rows the
// rest of the chain still needs, so the window shrinks by the conv's reach
// after every conv and a chain ends exactly on the tile's centre rows.
// __syncthreads() separates the convs; nothing crosses blocks.

#include <cuda_bf16.h>
#include <algorithm>
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

// ---------------------------------------------------------------------------
// The bfloat16 path.

constexpr int kTcBK = 16;      // input channels per staged slice (one k16 step)
constexpr int kTcStages = 2;   // depth of the cp.async ring
constexpr int kTcAStride = kTcBK + 8;  // bf16 a staged input row (48 bytes)
constexpr int kTcWPad = 8;     // bf16 of padding a staged weight row
constexpr int kMaxSmem = 232448;

struct ConvJob {
  const __nv_bfloat16* act;   // (B, T, C) conv input, leaky and rounded
  const __nv_bfloat16* w;     // (k*C, C) tap-major
  const __nv_bfloat16* bias;  // (C,)
  const __nv_bfloat16* x;     // second conv of a chain's first step: residual
  float* cur;                 // second conv: chain state (read unless x)
  __nv_bfloat16* act_out;     // first conv: leaky(y); second: leaky(cur) or null
  int k, d;
};

struct ConvBatch {
  ConvJob job[MRF_MAX_CHAINS];
};

struct CurSet {
  const float* cur[MRF_MAX_CHAINS];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Bytes of shared memory a conv block takes: kTcStages slices of
// (BM + span) staged input rows and k_cap taps of (16 x BN) weights.
template <int BM, int BN>
size_t conv_smem_bytes(int span, int k_cap) {
  return sizeof(__nv_bfloat16) * kTcStages *
         ((size_t)(BM + span) * kTcAStride + (size_t)k_cap * kTcBK * (BN + kTcWPad));
}

// One conv position of every chain in `batch` (blockIdx.z picks the chain)
// as an implicit GEMM; kSecond selects the second conv's epilogue.
// Grid: (B * ceil(T / BM) * (C / BN), 1, jobs). The column tile varies
// fastest, so the blocks that stage one row tile's input run together and
// read it from L2, not each from device memory.
template <int WM, int WN, int MI, int NI, bool kSecond>
__global__ void __launch_bounds__(WM * WN * 32)
    mrf_conv_kernel(ConvBatch batch, int T_len, int C, int span_cap, int k_cap,
                    float slope) {
  constexpr int BM = WM * MI * 16;
  constexpr int BN = WN * NI * 8;
  constexpr int kThreads = WM * WN * 32;
  constexpr int kWStride = BN + kTcWPad;
  constexpr int kChunks = BN / 8;  // 16-byte chunks of a weight row
  static_assert(NI % 2 == 0, "weights are loaded two n8 tiles at a time");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* const smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int a_elems = (BM + span_cap) * kTcAStride;
  const int stage_elems = a_elems + k_cap * kTcBK * kWStride;

  const ConvJob job = batch.job[blockIdx.z];
  const int k = job.k;
  const int d = job.d;
  const int reach = (k - 1) / 2 * d;
  const int a_rows = BM + (k - 1) * d;
  const int n_col_tiles = C / BN;
  const int n_row_tiles = (T_len + BM - 1) / BM;
  const int row_tile = blockIdx.x / n_col_tiles;
  const int n0 = (blockIdx.x - row_tile * n_col_tiles) * BN;
  const int b = row_tile / n_row_tiles;
  const int t0 = (row_tile - b * n_row_tiles) * BM;
  const size_t row0 = (size_t)b * T_len;  // first (B*T) row of batch element b
  const __nv_bfloat16* const act = job.act + row0 * C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int n_slices = C / kTcBK;

  auto load_slice = [&](int slice, int stage) {
    __nv_bfloat16* a_s = smem + stage * stage_elems;
    __nv_bfloat16* w_s = a_s + a_elems;
    const int ci0 = slice * kTcBK;
    for (int idx = tid; idx < a_rows * 2; idx += kThreads) {
      const int r = idx >> 1;
      const int part = idx & 1;
      const int t = t0 - reach + r;
      const bool inside = t >= 0 && t < T_len;
      cp_async16(a_s + r * kTcAStride + part * 8,
                 act + (size_t)(inside ? t : 0) * C + ci0 + part * 8, inside);
    }
    for (int idx = tid; idx < k * kTcBK * kChunks; idx += kThreads) {
      const int chunk = idx % kChunks;
      const int row = idx / kChunks;  // tap * 16 + channel of the slice
      const int j = row / kTcBK;
      const int ci = ci0 + row % kTcBK;
      cp_async16(w_s + row * kWStride + chunk * 8,
                 job.w + ((size_t)j * C + ci) * C + n0 + chunk * 8, true);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < n_slices) load_slice(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < n_slices; ++s) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // slice s is in; every warp is done with slice s - 1
    const int next = s + kTcStages - 1;
    if (next < n_slices) load_slice(next, next % kTcStages);
    cp_async_commit();

    const __nv_bfloat16* a_s = smem + (s % kTcStages) * stage_elems;
    const __nv_bfloat16* w_s = a_s + a_elems;
    for (int j = 0; j < k; ++j) {
      // Output row r of the tile reads staged input row r + j*d.
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int row = (wm * MI + mi) * 16 + (lane & 15) + j * d;
        ldmatrix_x4(af[mi], a_s + row * kTcAStride + (lane >> 4) * 8);
      }
      uint32_t bfr[NI][2];
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        const int krow = j * kTcBK + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = (wn * NI + 2 * np) * 8 + (lane >> 4) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, w_s + krow * kWStride + col);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();

  // Thread (g, tq) holds rows g and g + 8 of each m16 tile, columns 2tq and
  // 2tq + 1 of each n8 tile.
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int n = n0 + (wn * NI + ni) * 8 + 2 * tq;
    const float b0 = __bfloat162float(job.bias[n]);
    const float b1 = __bfloat162float(job.bias[n + 1]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + (wm * MI + mi) * 16 + g + 8 * h;
        if (t >= T_len) continue;
        const size_t e = (row0 + t) * C + n;
        const float v0 = acc[mi][ni][2 * h] + b0;
        const float v1 = acc[mi][ni][2 * h + 1] + b1;
        if (!kSecond) {
          store_bf16x2(job.act_out + e, leaky(v0, slope), leaky(v1, slope));
        } else {
          float2 r;
          if (job.x != nullptr) {
            r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(job.x + e));
          } else {
            r = *reinterpret_cast<const float2*>(job.cur + e);
          }
          const float c0 = r.x + v0;
          const float c1 = r.y + v1;
          *reinterpret_cast<float2*>(job.cur + e) = make_float2(c0, c1);
          if (job.act_out != nullptr)
            store_bf16x2(job.act_out + e, leaky(c0, slope), leaky(c1, slope));
        }
      }
    }
  }
}

// act0 = bf16(leaky(x)), 8 elements a thread.
__global__ void mrf_prologue_kernel(const __nv_bfloat16* __restrict__ x,
                                    __nv_bfloat16* __restrict__ act0,
                                    size_t n8, float slope) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * blockDim.x) {
    const uint4 v = reinterpret_cast<const uint4*>(x)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint4 o;
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      oh[q] = __floats2bfloat162_rn(leaky(f.x, slope), leaky(f.y, slope));
    }
    reinterpret_cast<uint4*>(act0)[i] = o;
  }
}

// out = bf16(((cur_0 + cur_1) + ..) / n_chains), 4 elements a thread.
__global__ void mrf_finish_kernel(CurSet curs, int n_chains,
                                  __nv_bfloat16* __restrict__ out, size_t n4) {
  const float n = (float)n_chains;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 t = reinterpret_cast<const float4*>(curs.cur[0])[i];
    for (int c = 1; c < n_chains; ++c) {
      const float4 v = reinterpret_cast<const float4*>(curs.cur[c])[i];
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out) + 2 * i;
    o[0] = __floats2bfloat162_rn(t.x / n, t.y / n);
    o[1] = __floats2bfloat162_rn(t.z / n, t.w / n);
  }
}

template <int WM, int WN, int MI, int NI, bool kSecond>
int launch_conv(const ConvBatch& batch, int n_jobs, int B, int T_len, int C,
                float slope, cudaStream_t stream) {
  constexpr int BM = WM * MI * 16;
  constexpr int BN = WN * NI * 8;
  int span = 0, k_cap = 0;
  for (int z = 0; z < n_jobs; ++z) {
    span = std::max(span, (batch.job[z].k - 1) * batch.job[z].d);
    k_cap = std::max(k_cap, batch.job[z].k);
  }
  const size_t smem = conv_smem_bytes<BM, BN>(span, k_cap);
  if (smem > (size_t)kMaxSmem) return -1;
  auto kernel = mrf_conv_kernel<WM, WN, MI, NI, kSecond>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)B * ((T_len + BM - 1) / BM) * (C / BN);
  if (tiles > 0x7fffffff) return -1;
  const dim3 grid((unsigned)tiles, 1, n_jobs);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(batch, T_len, C, span, k_cap, slope);
  return (int)cudaGetLastError();
}

template <int WM, int WN, int MI, int NI>
int stage_bf16(const void* x, void* out, const void* w, const void* bias,
               void* cur, void* act, void* yact, int B, int T_len, int C,
               int n_chains, const int* ksizes, const int* n_dils,
               const int* dils, float slope, cudaStream_t stream,
               int* n_launches) {
  using bf16 = __nv_bfloat16;
  const size_t n = (size_t)B * T_len * C;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const bf16* bb = static_cast<const bf16*>(bias);
  float* curf = static_cast<float*>(cur);
  bf16* actb = static_cast<bf16*>(act);
  bf16* yactb = static_cast<bf16*>(yact);
  const int threads = 256;
  const int blocks = (int)std::min<size_t>(132 * 16, (n / 8 + threads - 1) / threads);
  int err;

  mrf_prologue_kernel<<<blocks, threads, 0, stream>>>(xb, actb, n / 8, slope);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  ++*n_launches;

  // Each chain's first conv weight and bias, in packed order.
  size_t w_off[MRF_MAX_CHAINS], b_off[MRF_MAX_CHAINS];
  int max_dils = 0;
  for (int c = 0, wo = 0, bo = 0; c < n_chains; ++c) {
    w_off[c] = (size_t)wo * C * C;
    b_off[c] = (size_t)bo * C;
    wo += 2 * n_dils[c] * ksizes[c];
    bo += 2 * n_dils[c];
    max_dils = std::max(max_dils, n_dils[c]);
  }
  // Chains in order of decreasing kernel size: the heaviest blocks start first.
  int order[MRF_MAX_CHAINS];
  for (int c = 0; c < n_chains; ++c) order[c] = c;
  for (int i = 1; i < n_chains; ++i)
    for (int j = i; j > 0 && ksizes[order[j]] > ksizes[order[j - 1]]; --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }

  for (int u = 0; u < max_dils; ++u) {
    ConvBatch first = {}, second = {};
    int jobs = 0;
    for (int i = 0; i < n_chains; ++i) {
      const int c = order[i];
      if (u >= n_dils[c]) continue;
      const int k = ksizes[c];
      const size_t conv = (size_t)k * C * C;
      ConvJob& a = first.job[jobs];
      a.act = u == 0 ? actb : actb + c * n;
      a.w = wb + w_off[c] + 2 * u * conv;
      a.bias = bb + b_off[c] + 2 * u * C;
      a.act_out = yactb + c * n;
      a.k = k;
      a.d = dils[c * MRF_MAX_DILS + u];
      ConvJob& s = second.job[jobs];
      s.act = yactb + c * n;
      s.w = a.w + conv;
      s.bias = a.bias + C;
      s.x = u == 0 ? xb : nullptr;
      s.cur = curf + c * n;
      s.act_out = u + 1 < n_dils[c] ? actb + c * n : nullptr;
      s.k = k;
      s.d = 1;
      ++jobs;
    }
    if ((err = launch_conv<WM, WN, MI, NI, false>(first, jobs, B, T_len, C, slope,
                                                  stream)) != 0)
      return err;
    ++*n_launches;
    if ((err = launch_conv<WM, WN, MI, NI, true>(second, jobs, B, T_len, C, slope,
                                                 stream)) != 0)
      return err;
    ++*n_launches;
  }

  CurSet curs = {};
  for (int c = 0; c < n_chains; ++c) curs.cur[c] = curf + c * n;
  mrf_finish_kernel<<<(int)std::min<size_t>(132 * 16, (n / 4 + threads - 1) / threads),
                      threads, 0, stream>>>(curs, n_chains, static_cast<bf16*>(out),
                                            n / 4);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  ++*n_launches;
  return 0;
}

}  // namespace

extern "C" {

// Launches one float32 MRF stage on `stream`. x and out are (B, T, C)
// contiguous, w is every conv's (k*C, C) weight concatenated in chain order,
// bias every conv's (C,) bias. scratch holds
// grid * (2*(t_tile + 2*halo) + t_tile) * C floats. dils is (n_chains,
// MRF_MAX_DILS) row-major. Returns cudaGetLastError() after the launch, or
// -1 for a configuration the kernel does not take.
int mrf_stage_f32_launch(const void* x, void* out, const void* w,
                         const void* bias, void* scratch, int B, int T_len,
                         int C, int t_tile, int halo, int grid, int n_chains,
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
  return C % 64 == 0 ? launch<float, 64>(x, out, w, bias, scratch, B, T_len, C,
                                         t_tile, halo, grid, spec, slope, s)
                     : launch<float, 32>(x, out, w, bias, scratch, B, T_len, C,
                                         t_tile, halo, grid, spec, slope, s);
}

// Issues the bfloat16 MRF stage on `stream`: 2 + 2 * (largest dilation
// count) launches. x and out are (B, T, C) bf16 contiguous; w and bias are
// packed as for the float32 path, in bf16. cur holds n_chains * B*T*C
// floats, act and yact n_chains * B*T*C bf16 each. dils is (n_chains,
// MRF_MAX_DILS) row-major. Adds each launch to *n_launches and returns the
// first nonzero cudaGetLastError() after a launch, 0 when all launched, or
// -1 for a configuration the kernels do not take.
int mrf_stage_bf16_launch(const void* x, void* out, const void* w,
                          const void* bias, void* cur, void* act, void* yact,
                          int B, int T_len, int C, int n_chains,
                          const int* ksizes, const int* n_dils, const int* dils,
                          float slope, void* stream, int* n_launches) {
  if (n_chains < 1 || n_chains > MRF_MAX_CHAINS || C % 32 != 0 || C <= 0 ||
      B <= 0 || T_len <= 0)
    return -1;
  for (int c = 0; c < n_chains; ++c)
    if (ksizes[c] % 2 == 0 || ksizes[c] < 1 || n_dils[c] < 1 ||
        n_dils[c] > MRF_MAX_DILS)
      return -1;
  // 256-row tiles of 8 warps: 64 x 32 warp tiles at C % 64 == 0, else
  // 32 x 32 (C = 32, 96).
  return C % 64 == 0
             ? stage_bf16<4, 2, 4, 4>(x, out, w, bias, cur, act, yact, B, T_len,
                                      C, n_chains, ksizes, n_dils, dils, slope,
                                      static_cast<cudaStream_t>(stream), n_launches)
             : stage_bf16<8, 1, 2, 4>(x, out, w, bias, cur, act, yact, B, T_len,
                                      C, n_chains, ksizes, n_dils, dils, slope,
                                      static_cast<cudaStream_t>(stream), n_launches);
}

}  // extern "C"
