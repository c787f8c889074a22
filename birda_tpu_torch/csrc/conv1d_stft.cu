// Conv1d-STFT for Hopper (sm_90a): a single-input-channel strided Conv1d
// with a long kernel, out[b, c, t] = sum_k x[b, t * hop + k] * w[c, k].
//
// Replaces the Pallas TPU kernel birda_tpu/ops/stft_conv.py::_conv1d_stft
// (body _kernel): bf16 operands, fp32 accumulation, bf16 [B, C, T] out. It
// carries the front-ends the fusion pass does not take: the unfused
// windowed-DFT conv (K 2048, hop 278, C 2050 at the BirdNET v2.4 geometry)
// and Perch v2's framing conv (K 640, hop 320, C 640, an identity weight;
// the kernel still does the full product, whatever the weight).
//
// What bounds it: a GEMM with M = B * T frames, N = C, K = the window. At
// Perch v2's framer, batch 32, that is 1.3e10 FLOP against ~42 MB of
// compulsory bytes (the float32 signal, the weight, the bf16 output), just
// on the operations side of the card's ratio, so it is tensor-core bound.
// The design keeps every product on the tensor cores (nvcuda::wmma, bf16
// operands, fp32 accumulators) and reuses each staged frame tile across
// TILE_C channels and each weight tile across TILE_T frames.
//
// Block = TILE_T frames of one signal x TILE_C channels; grid =
// (ceil(T / TILE_T), ceil(C / TILE_C), B). The block walks the window in
// TILE_K chunks through double-buffered shared memory (the next chunk's
// global loads are in flight while the current chunk's MMAs run):
//   - the frame chunk is staged im2col-style: frame t starts at t * hop,
//     which is 16-B aligned when hop is a multiple of 8 (hop 320: 16-B
//     vector loads) and not otherwise (hop 278: 2-byte loads), and window
//     positions past K are staged as zeros;
//   - the weight chunk arrives pre-tiled (birda_tpu_torch/ops/stft_conv.py::
//     prepare_conv1d_weights: [C tiles, K chunks, TILE_K, TILE_C], zero-
//     padded past C and K), one contiguous 8 KB block per chunk.
// The [TILE_T, TILE_C] fp32 tile is then written through shared memory
// transposed to [c][t], so the bf16 stores run along t, and the tails of T
// and C are masked there. No atomics and no cross-block pass: the result is
// deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TILE_T = 128;  // frames per block
constexpr int TILE_C = 128;  // output channels per block
constexpr int TILE_K = 32;   // window depth per pipeline stage
constexpr int WARPS = 8;     // 4 frame groups of 32 x 2 channel halves of 64
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;  // bf16 row padding: keeps 16-B rows, spreads banks
constexpr int A_LD = TILE_K + PAD;
constexpr int W_LD = TILE_C + PAD;
constexpr int O_LD = TILE_T + 4;  // fp32 output staging, [c][t]

constexpr size_t PIPE_BYTES =
    sizeof(__nv_bfloat16) * (2 * TILE_T * A_LD + 2 * TILE_K * W_LD);
constexpr size_t OUT_BYTES = sizeof(float) * TILE_C * O_LD;
constexpr size_t SMEM_BYTES = PIPE_BYTES > OUT_BYTES ? PIPE_BYTES : OUT_BYTES;

// ALIGNED: hop and the signal row stride are multiples of 8 elements, so
// every frame chunk starts on a 16-B boundary.
template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2)
conv1d_stft_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ wp,
                   __nv_bfloat16* __restrict__ out, int x_stride, int hop,
                   int K, int T, int C, int n_kc) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sW = sA + 2 * TILE_T * A_LD;
  float* sOut = reinterpret_cast<float*>(smem);  // after the main loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int t0 = blockIdx.x * TILE_T;
  const int c_tile = blockIdx.y;
  const int c0 = c_tile * TILE_C;
  const int b = blockIdx.z;
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(x) + (size_t)b * x_stride;

  const int wr = (warp & 3) * 32;  // first frame of this warp's rows
  const int wc = (warp >> 2) * 64;  // first channel of this warp's columns

  // Each thread stages 16 consecutive window samples of one frame and two
  // 16-B vectors of the weight chunk per stage.
  const int a_row = tid >> 1;
  const int a_col = (tid & 1) * 16;
  uint32_t a_reg[8];
  uint4 w_reg[2];

  auto load_chunk = [&](int c) {
    const int kb = c * TILE_K + a_col;
    const unsigned short* src = xb + (size_t)(t0 + a_row) * hop + kb;
    if (ALIGNED && kb + 16 <= K) {
      const uint4* v = reinterpret_cast<const uint4*>(src);
      const uint4 lo = __ldg(v);
      const uint4 hi = __ldg(v + 1);
      a_reg[0] = lo.x; a_reg[1] = lo.y; a_reg[2] = lo.z; a_reg[3] = lo.w;
      a_reg[4] = hi.x; a_reg[5] = hi.y; a_reg[6] = hi.z; a_reg[7] = hi.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = kb + 2 * i;
        const uint32_t e0 = k < K ? (uint32_t)__ldg(src + 2 * i) : 0u;
        const uint32_t e1 = k + 1 < K ? (uint32_t)__ldg(src + 2 * i + 1) : 0u;
        a_reg[i] = e0 | (e1 << 16);
      }
    }
    const uint4* wsrc = reinterpret_cast<const uint4*>(
        wp + ((size_t)c_tile * n_kc + c) * TILE_K * TILE_C);
#pragma unroll
    for (int i = 0; i < 2; ++i) w_reg[i] = __ldg(wsrc + tid + i * THREADS);
  };
  auto store_chunk = [&](int buf) {
    uint4* adst = reinterpret_cast<uint4*>(sA + buf * TILE_T * A_LD +
                                           a_row * A_LD + a_col);
    adst[0] = make_uint4(a_reg[0], a_reg[1], a_reg[2], a_reg[3]);
    adst[1] = make_uint4(a_reg[4], a_reg[5], a_reg[6], a_reg[7]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx >> 4;  // 16 vectors of 8 per TILE_C-wide row
      const int cv = idx & 15;
      *reinterpret_cast<uint4*>(sW + buf * TILE_K * W_LD + row * W_LD +
                                cv * 8) = w_reg[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }

  load_chunk(0);
  store_chunk(0);
  __syncthreads();

  for (int c = 0; c < n_kc; ++c) {
    const int buf = c & 1;
    const bool more = c + 1 < n_kc;
    if (more) load_chunk(c + 1);  // global loads overlap the MMAs
    const __nv_bfloat16* a = sA + buf * TILE_T * A_LD + wr * A_LD;
    const __nv_bfloat16* w = sW + buf * TILE_K * W_LD + wc;
#pragma unroll
    for (int kk = 0; kk < TILE_K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fa[i], a + i * 16 * A_LD + kk, A_LD);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fb;
        wmma::load_matrix_sync(fb, w + kk * W_LD + j * 16, W_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    if (more) store_chunk(buf ^ 1);
    __syncthreads();
  }

  // Stage the fp32 tile as [c][t] (column-major stores of each [t, c]
  // fragment), then write bf16 rows of t with the T and C tails masked.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sOut + (wc + j * 16) * O_LD + wr + i * 16,
                              acc[i][j], O_LD, wmma::mem_col_major);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < TILE_C * TILE_T; idx += THREADS) {
    const int cc = idx / TILE_T;
    const int tt = idx % TILE_T;
    const int gc = c0 + cc;
    const int gt = t0 + tt;
    if (gc < C && gt < T) {
      out[((size_t)b * C + gc) * T + gt] =
          __float2bfloat16_rn(sOut[cc * O_LD + tt]);
    }
  }
}

template <bool ALIGNED>
int launch(const void* x, const void* wp, void* out, int batch, int x_stride,
           int hop, int K, int T, int C, int n_c_tiles, int n_kc,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv1d_stft_kernel<ALIGNED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TILE_T - 1) / TILE_T, n_c_tiles, batch);
  conv1d_stft_kernel<ALIGNED><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp),
      static_cast<__nv_bfloat16*>(out), x_stride, hop, K, T, C, n_kc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile geometry, read by the Python wrapper so the two cannot drift.
int birda_conv1d_stft_tile_t() { return TILE_T; }
int birda_conv1d_stft_tile_c() { return TILE_C; }
int birda_conv1d_stft_tile_k() { return TILE_K; }

// x: [batch, x_stride] bf16, zero-padded so every frame of the last frame
// tile reads n_kc * TILE_K samples inside the row; wp: [n_c_tiles, n_kc,
// TILE_K, TILE_C] bf16; out: [batch, C, T] bf16. Returns cudaGetLastError()
// after the launch (0 = launched).
int birda_conv1d_stft(const void* x, const void* wp, void* out, int batch,
                      int x_stride, int hop, int K, int T, int C,
                      int n_c_tiles, int n_kc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hop % 8 == 0 && x_stride % 8 == 0) {
    return launch<true>(x, wp, out, batch, x_stride, hop, K, T, C, n_c_tiles,
                        n_kc, s);
  }
  return launch<false>(x, wp, out, batch, x_stride, hop, K, T, C, n_c_tiles,
                       n_kc, s);
}

}  // extern "C"
