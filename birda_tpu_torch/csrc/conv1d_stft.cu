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
// The TPU kernel keeps the signal row and all weight slabs in VMEM. Here a
// block owns 128 frames of one signal, keeps their span in shared memory
// (read once, in the signal's own dtype: no padded copy in the wrapper)
// and walks every tile of 128 channels through the warp-specialised wgmma
// mainloop of strided_window_gemm.cuh.
//
// Store: T (499 at Perch) makes the [B, C, T] row stride neither 16-B
// aligned nor a tensor-map stride, so each consumer warpgroup writes its
// [64 t, 128 c] tile to shared memory transposed, bf16, and its threads
// store runs along t, the tails of T and C masked. No atomics and no
// cross-block pass: the result is deterministic.
//
// A wide hop (512 at K 2048, 1024 at K 1024) makes the span of 128 frames
// larger than shared memory; the host then picks the most frames per block
// that fit, 64 or fewer (stft_conv.conv1d_frames), the second warpgroup
// only keeps the ring turning, and only the first one stages its tile.

#include "strided_window_gemm.cuh"

namespace {

using namespace swg;

constexpr int STAGE_ELEMS = STAGE_BYTES / 2;
constexpr int O_LD = 64 + 8;  // bf16 staging row [c][t], padded for banks
// One consumer warpgroup's staged tile.
constexpr size_t STAGING_BYTES = TILE_N * O_LD * 2;

// ODD: odd hop (A registers packed from two 2-byte loads).
template <bool ODD>
__global__ void __launch_bounds__(THREADS, 1)
conv1d_stft_kernel(const void* __restrict__ x, int x_f32,
                   const __nv_bfloat16* __restrict__ wp,
                   __nv_bfloat16* __restrict__ out, int S, int hop, int row,
                   int pad, int tf, int K, int T, int C, int n_ct, int n_kc) {
  extern __shared__ uint8_t smem_raw[];
  const int kp = n_kc * TILE_K;
  const Smem sm(smem_raw, hop, row, pad, kp, tf);
  init_barriers(sm);

  if (warpgroup() == PRODUCER_WG) {
    // Producer warp: every K chunk of every channel tile, in order.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == PRODUCER_WG * 128) {
      RingPos pos;
      for (int j = 0; j < n_ct; ++j) {
        for (int c = 0; c < n_kc; ++c) {
          produce(sm, pos, wp + ((size_t)j * n_kc + c) * STAGE_ELEMS,
                  STAGE_BYTES);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int t0 = blockIdx.x * tf;
    const int b = blockIdx.y;
    load_span(sm.span, x, x_f32 != 0, b, S, t0 * hop, (tf - 1) * hop + kp,
              hop, row, pad, tid);
    named_bar_sync(1, CONSUMER_THREADS);

    RingPos pos;
    if (wg * 64 >= tf) {  // no frames of its own (tf <= 64)
      skip_stages(sm, pos, n_ct * n_kc);
      return;
    }
    FrameCursor<ODD> fc(sm.span, wg * 64 + warp * 16 + (lane >> 2), tf - 1,
                        hop, row, pad, K);
    __nv_bfloat16* stage =
        reinterpret_cast<__nv_bfloat16*>(sm.extra) + wg * TILE_N * O_LD;
    const int t_base = t0 + wg * 64;
    // The block's frames end at t0 + tf: the tile's rows past it repeat
    // the last frame and are not stored.
    const int t_end = min(T, t0 + tf);

    for (int j = 0; j < n_ct; ++j) {
      float acc[64];
      mma_window(acc, fc, sm, pos, n_kc);

      // Register i is frame row 16 warp + lane/4 + 8 ((i/2) % 2), channel
      // 8 (i/4) + 2 (lane % 4) + i % 2 of the tile: staged as [c][t].
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int cc = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int tt = warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
        stage[cc * O_LD + tt] = __float2bfloat16_rn(acc[i]);
      }
      named_bar_sync(2 + wg, 128);
      // Each warp stores 32 channel rows; lane l writes t = 2l, 2l + 1.
      const int gt = t_base + 2 * lane;
      for (int r = 0; r < 32; ++r) {
        const int cc = warp * 32 + r;
        const int gc = j * TILE_N + cc;
        if (gc >= C) break;
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(stage + cc * O_LD +
                                                     2 * lane);
        __nv_bfloat16* dst = out + ((size_t)b * C + gc) * T;
        if (gt < t_end) dst[gt] = v.x;
        if (gt + 1 < t_end) dst[gt + 1] = v.y;
      }
      named_bar_sync(2 + wg, 128);
    }
  }
}

template <bool ODD>
int launch(const void* x, int x_f32, const void* wp, void* out, int batch,
           int S, int hop, int row, int pad, int tf, int K, int T, int C,
           int n_ct, int n_kc, cudaStream_t stream) {
  const int kp = n_kc * TILE_K;
  const size_t smem = smem_bytes(hop, row, pad, kp, tf,
                                 (tf > 64 ? 2 : 1) * STAGING_BYTES);
  if (!span_args_ok(hop, row, pad, kp, tf) || smem > SMEM_LIMIT) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      conv1d_stft_kernel<ODD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + tf - 1) / tf, batch);
  conv1d_stft_kernel<ODD><<<grid, THREADS, smem, stream>>>(
      x, x_f32, static_cast<const __nv_bfloat16*>(wp),
      static_cast<__nv_bfloat16*>(out), S, hop, row, pad, tf, K, T, C, n_ct,
      n_kc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile geometry, read by the Python wrapper so the two cannot drift.
int birda_conv1d_stft_tile_t() { return TILE_T; }
int birda_conv1d_stft_tile_c() { return TILE_N; }
int birda_conv1d_stft_tile_k() { return TILE_K; }

// x: [batch, S] float32 (x_f32 = 1) or bf16, contiguous; wp: [n_ct, n_kc,
// TILE_N, TILE_K] bf16, each chunk a 128-B swizzled image; out: [batch, C,
// T] bf16. row: the span's row length, min(hop, n_kc * TILE_K); pad: its
// row padding (0 for an odd row); tf: frames per block, a power of two up
// to 128.
// Returns cudaGetLastError() after the launch (0 = launched).
int birda_conv1d_stft(const void* x, int x_f32, const void* wp, void* out,
                      int batch, int S, int hop, int row, int pad, int tf,
                      int K, int T, int C, int n_ct, int n_kc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row & 1) {
    return launch<true>(x, x_f32, wp, out, batch, S, hop, row, pad, tf, K, T,
                        C, n_ct, n_kc, s);
  }
  return launch<false>(x, x_f32, wp, out, batch, S, hop, row, pad, tf, K, T,
                       C, n_ct, n_kc, s);
}

}  // extern "C"
