// Fused log-mel spectrogram front-end for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel birda_tpu/ops/stft_conv.py::_fused_logmel
// (body _fused_kernel): windowed DFT as a strided matmul with fp32
// accumulation, power = re^2 + im^2 from the fp32 accumulator rounded to
// bf16, mel projection with fp32 accumulation, log(mel + eps) written as
// bf16. The [B, T, M] log-mel image is the only write to device memory.
//
// What bounds it: the windowed DFT is ~75% of the BirdNET v2.4 model's
// MACs (2 * 1025 * 2048 per frame), so the kernel is bounded by tensor-core
// throughput, not by bytes. The design keeps every product on the tensor
// cores (nvcuda::wmma, bf16 operands, fp32 accumulators) and reuses each
// weight tile across TILE_T frames. The TPU design holds all DFT slabs
// (~9.1 MB at v2.4) in VMEM; no SM can, so here the weights are streamed
// from L2 in [TILE_K, 2 * TILE_BINS] chunks and the mel projection is
// accumulated across bin tiles in registers.
//
// Block = TILE_T frames of one signal and all M mel outputs; grid =
// (ceil(T / TILE_T), B). For each tile of TILE_BINS bins the block
//   1. streams the [cos | -sin] weight chunk and the im2col frame chunk
//      through double-buffered shared memory (frame t starts at t * hop,
//      which is neither 16-B aligned nor a multiple of 8 at hop 278, so the
//      frame chunk is staged with 2-byte loads into a padded row stride);
//   2. accumulates re/im for its [TILE_T, TILE_BINS] tile in fp32;
//   3. rounds the power to bf16 into shared memory;
//   4. adds power @ fb[tile] into the [TILE_T, M] fp32 accumulator.
// No atomics and no cross-block pass: the result is deterministic.
//
// The weights arrive pre-tiled (birda_tpu_torch/ops/stft_conv.py::
// prepare_logmel_weights), zero-padded to whole bin tiles and K chunks; the
// signal arrives as bf16, zero-padded so every frame of the last tile reads
// inside the buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TILE_T = 64;     // frames per block
constexpr int TILE_BINS = 64;  // frequency bins per tile (cos and sin rows)
constexpr int TILE_K = 64;     // DFT depth per pipeline stage
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;  // bf16 row padding: keeps 16-B rows, spreads banks
constexpr int A_LD = TILE_K + PAD;
constexpr int W_LD = 2 * TILE_BINS + PAD;
constexpr int P_LD = TILE_BINS + PAD;

constexpr size_t smem_bytes(int mp) {
  return sizeof(__nv_bfloat16) *
             (2 * TILE_T * A_LD + 2 * TILE_K * W_LD +
              TILE_BINS * (mp + PAD) + TILE_T * P_LD) +
         sizeof(float) * WARPS * 256;
}

// NF: mel fragments per warp; the padded mel width is 32 * NF (two warp
// columns of 16 * NF).
template <int NF>
__global__ void __launch_bounds__(THREADS, 2)
fused_logmel_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ wp,
                    const __nv_bfloat16* __restrict__ fbp,
                    __nv_bfloat16* __restrict__ out, int x_stride, int hop,
                    int T, int M, int n_bin_tiles, int n_kc, float eps) {
  constexpr int MP = 32 * NF;
  constexpr int FB_LD = MP + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sW = sA + 2 * TILE_T * A_LD;
  __nv_bfloat16* sFB = sW + 2 * TILE_K * W_LD;
  __nv_bfloat16* sP = sFB + TILE_BINS * FB_LD;
  float* sStage = reinterpret_cast<float*>(sP + TILE_T * P_LD);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t0 = blockIdx.x * TILE_T;
  const int b = blockIdx.y;
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(x) + (size_t)b * x_stride;

  // Warp tiling: 4 row groups of 16 frames x 2 column halves.
  const int wr = (warp & 3) * 16;
  const int wc = warp >> 2;

  // Each thread stages 16 consecutive samples of one frame row per chunk
  // and 4 x 16 B of the weight chunk.
  const int a_row = tid >> 2;
  const int a_col = (tid & 3) * 16;
  uint32_t a_reg[8];
  uint4 w_reg[4];

  auto load_chunk = [&](int tile, int c) {
    const unsigned short* src =
        xb + (size_t)(t0 + a_row) * hop + (size_t)c * TILE_K + a_col;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a_reg[i] = (uint32_t)__ldg(src + 2 * i) |
                 ((uint32_t)__ldg(src + 2 * i + 1) << 16);
    }
    const uint4* wsrc = reinterpret_cast<const uint4*>(
        wp + ((size_t)tile * n_kc + c) * TILE_K * 2 * TILE_BINS);
#pragma unroll
    for (int i = 0; i < 4; ++i) w_reg[i] = __ldg(wsrc + tid + i * THREADS);
  };
  auto store_chunk = [&](int buf) {
    uint4* adst = reinterpret_cast<uint4*>(sA + buf * TILE_T * A_LD +
                                           a_row * A_LD + a_col);
    adst[0] = make_uint4(a_reg[0], a_reg[1], a_reg[2], a_reg[3]);
    adst[1] = make_uint4(a_reg[4], a_reg[5], a_reg[6], a_reg[7]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx >> 4;  // 16 vectors of 8 per 128-wide row
      const int cv = idx & 15;
      *reinterpret_cast<uint4*>(sW + buf * TILE_K * W_LD + row * W_LD +
                                cv * 8) = w_reg[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> mel[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(mel[f], 0.0f);

  float* stage = sStage + warp * 256;

  for (int tile = 0; tile < n_bin_tiles; ++tile) {
    const uint4* fsrc =
        reinterpret_cast<const uint4*>(fbp + (size_t)tile * TILE_BINS * MP);
    for (int i = tid; i < TILE_BINS * MP / 8; i += THREADS) {
      const int row = i / (MP / 8);
      const int cv = i % (MP / 8);
      *reinterpret_cast<uint4*>(sFB + row * FB_LD + cv * 8) = __ldg(fsrc + i);
    }
    load_chunk(tile, 0);
    store_chunk(0);
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> re[2], im[2];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      wmma::fill_fragment(re[f], 0.0f);
      wmma::fill_fragment(im[f], 0.0f);
    }

    for (int c = 0; c < n_kc; ++c) {
      const int buf = c & 1;
      const bool more = c + 1 < n_kc;
      if (more) load_chunk(tile, c + 1);  // global loads overlap the MMAs
      const __nv_bfloat16* a = sA + buf * TILE_T * A_LD + wr * A_LD;
      const __nv_bfloat16* w = sW + buf * TILE_K * W_LD;
#pragma unroll
      for (int kk = 0; kk < TILE_K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fa;
        wmma::load_matrix_sync(fa, a + kk, A_LD);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int col = wc * 32 + f * 16;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              fc, fs;
          wmma::load_matrix_sync(fc, w + kk * W_LD + col, W_LD);
          wmma::load_matrix_sync(fs, w + kk * W_LD + TILE_BINS + col, W_LD);
          wmma::mma_sync(re[f], fa, fc, re[f]);
          wmma::mma_sync(im[f], fa, fs, im[f]);
        }
      }
      if (more) store_chunk(buf ^ 1);
      __syncthreads();
    }

    // Power from the fp32 accumulators (re and im fragments share one
    // element layout), rounded to bf16 where the TPU kernel rounds it.
#pragma unroll
    for (int f = 0; f < 2; ++f) {
#pragma unroll
      for (int i = 0; i < re[f].num_elements; ++i) {
        re[f].x[i] = re[f].x[i] * re[f].x[i] + im[f].x[i] * im[f].x[i];
      }
      wmma::store_matrix_sync(stage, re[f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < 256; i += 32) {
        sP[(wr + (i >> 4)) * P_LD + wc * 32 + f * 16 + (i & 15)] =
            __float2bfloat16_rn(stage[i]);
      }
      __syncwarp();
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < TILE_BINS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fp;
      wmma::load_matrix_sync(fp, sP + wr * P_LD + kk, P_LD);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            ff;
        wmma::load_matrix_sync(ff, sFB + kk * FB_LD + wc * (MP / 2) + f * 16,
                               FB_LD);
        wmma::mma_sync(mel[f], fp, ff, mel[f]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int i = 0; i < mel[f].num_elements; ++i) {
      mel[f].x[i] = logf(mel[f].x[i] + eps);
    }
    wmma::store_matrix_sync(stage, mel[f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int t = t0 + wr + (i >> 4);
      const int m = wc * (MP / 2) + f * 16 + (i & 15);
      if (t < T && m < M) {
        out[((size_t)b * T + t) * M + m] = __float2bfloat16_rn(stage[i]);
      }
    }
    __syncwarp();
  }
}

template <int NF>
int launch(const void* x, const void* wp, const void* fbp, void* out,
           int batch, int x_stride, int hop, int T, int M, int n_bin_tiles,
           int n_kc, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(32 * NF);
  cudaError_t err = cudaFuncSetAttribute(
      fused_logmel_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TILE_T - 1) / TILE_T, batch);
  fused_logmel_kernel<NF><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp),
      static_cast<const __nv_bfloat16*>(fbp),
      static_cast<__nv_bfloat16*>(out), x_stride, hop, T, M, n_bin_tiles,
      n_kc, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile geometry, read by the Python wrapper so the two cannot drift.
int birda_fused_logmel_tile_t() { return TILE_T; }
int birda_fused_logmel_tile_bins() { return TILE_BINS; }
int birda_fused_logmel_tile_k() { return TILE_K; }

// x: [batch, x_stride] bf16; wp: [n_bin_tiles, n_kc, TILE_K, 2*TILE_BINS]
// bf16; fbp: [n_bin_tiles*TILE_BINS, mp] bf16; out: [batch, T, M] bf16.
// Returns cudaGetLastError() after the launch (0 = launched).
int birda_fused_logmel(const void* x, const void* wp, const void* fbp,
                       void* out, int batch, int x_stride, int hop, int T,
                       int M, int mp, int n_bin_tiles, int n_kc, float eps,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mp) {
    case 32: return launch<1>(x, wp, fbp, out, batch, x_stride, hop, T, M, n_bin_tiles, n_kc, eps, s);
    case 64: return launch<2>(x, wp, fbp, out, batch, x_stride, hop, T, M, n_bin_tiles, n_kc, eps, s);
    case 96: return launch<3>(x, wp, fbp, out, batch, x_stride, hop, T, M, n_bin_tiles, n_kc, eps, s);
    case 128: return launch<4>(x, wp, fbp, out, batch, x_stride, hop, T, M, n_bin_tiles, n_kc, eps, s);
    case 160: return launch<5>(x, wp, fbp, out, batch, x_stride, hop, T, M, n_bin_tiles, n_kc, eps, s);
    case 192: return launch<6>(x, wp, fbp, out, batch, x_stride, hop, T, M, n_bin_tiles, n_kc, eps, s);
    case 224: return launch<7>(x, wp, fbp, out, batch, x_stride, hop, T, M, n_bin_tiles, n_kc, eps, s);
    case 256: return launch<8>(x, wp, fbp, out, batch, x_stride, hop, T, M, n_bin_tiles, n_kc, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
