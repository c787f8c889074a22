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
// throughput, not by bytes. The TPU design holds all DFT slabs (~9.1 MB at
// v2.4) in VMEM; no SM can. Here a block owns 128 frames of one signal and
// all M mel outputs, keeps its signal span in shared memory, and streams
// the weights from L2 through the warp-specialised wgmma mainloop of
// strided_window_gemm.cuh (a producer warp's bulk copies into an mbarrier
// ring, two consumer warpgroups with frames as the register A operand).
//
// For each tile of 64 bins the N = 128 columns are [cos 64 | -sin 64], so
// bin j's re and im (columns j and 64 + j) sit in the same thread's
// accumulator registers (index i and i + 32): the power is register-local.
// Rounded to bf16, the power accumulator is already in the A-fragment
// layout of the next wgmma, so the mel product power[64, 64 bins] @
// fb[64 bins, M] runs from registers (m64n32k16 per 32 mel columns), its
// filterbank tile riding the same ring as the DFT chunks. The mel
// accumulators stay in registers across all bin tiles; then log and store.
// No atomics and no cross-block pass: the result is deterministic.
//
// The registers hold at most 256 mel columns. A wider front end (two
// 160-mel banks) is cut into `passes` equal column ranges of at most 256,
// one per blockIdx.z: each such block recomputes the DFT of its frames and
// projects onto its own range. A wide hop takes fewer frames per block, as
// in conv1d_stft.cu (the second warpgroup then keeps the ring turning).

#include "strided_window_gemm.cuh"

namespace {

using namespace swg;

constexpr int TILE_BINS = TILE_N / 2;  // cos and -sin rows of one N tile
constexpr int FB_ROW_BYTES = TILE_BINS * 2;  // one mel column of a bin tile
constexpr int STAGE_ELEMS = STAGE_BYTES / 2;

// NQ: 32-wide mel column groups of one pass (its padded mel width is
// 32 * NQ); ODD: odd span row (A registers packed from two 2-byte loads).
template <int NQ, bool ODD>
__global__ void __launch_bounds__(THREADS, 1)
fused_logmel_kernel(const void* __restrict__ x, int x_f32,
                    const __nv_bfloat16* __restrict__ wp,
                    const __nv_bfloat16* __restrict__ fbp,
                    __nv_bfloat16* __restrict__ out, int S, int hop, int row,
                    int pad, int tf, int K, int T, int M, int mp_all,
                    int n_bt, int n_kc, float eps) {
  constexpr int MP = 32 * NQ;
  constexpr int FB_STAGES = (MP + TILE_N - 1) / TILE_N;
  extern __shared__ uint8_t smem_raw[];
  const int kp = n_kc * TILE_K;
  const Smem sm(smem_raw, hop, row, pad, kp, tf);
  const int col0 = blockIdx.z * MP;  // this pass's first mel column
  init_barriers(sm);

  if (warpgroup() == PRODUCER_WG) {
    // Producer warp: every DFT chunk of a bin tile, then its filterbank.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == PRODUCER_WG * 128) {
      RingPos pos;
      for (int j = 0; j < n_bt; ++j) {
        for (int c = 0; c < n_kc; ++c) {
          produce(sm, pos, wp + ((size_t)j * n_kc + c) * STAGE_ELEMS,
                  STAGE_BYTES);
        }
        for (int f = 0; f < FB_STAGES; ++f) {
          const int rows = min(MP - f * TILE_N, TILE_N);
          produce(sm, pos,
                  fbp + ((size_t)j * mp_all + col0 + f * TILE_N) * TILE_BINS,
                  rows * FB_ROW_BYTES);
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
      skip_stages(sm, pos, n_bt * (n_kc + FB_STAGES));
      return;
    }
    const int frame = wg * 64 + warp * 16 + (lane >> 2);
    FrameCursor<ODD> fc(sm.span, frame, tf - 1, hop, row, pad, K);
    float mel[NQ][16];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int i = 0; i < 16; ++i) mel[q][i] = 0.0f;
    }

    for (int j = 0; j < n_bt; ++j) {
      float acc[64];
      mma_window(acc, fc, sm, pos, n_kc);

      // Power rounded to bf16, packed as the A fragments of the four
      // 16-bin steps: register r of step kb holds accumulator pair
      // 8 kb + 2 r (re) and the same + 32 (im).
      uint32_t p[16];
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kb + 2 * r;
          p[4 * kb + r] =
              pack_bf16(acc[i] * acc[i] + acc[i + 32] * acc[i + 32],
                        acc[i + 1] * acc[i + 1] + acc[i + 33] * acc[i + 33]);
        }
      }

      uint32_t fb[FB_STAGES];
      {
        RingPos look = pos;
#pragma unroll
        for (int f = 0; f < FB_STAGES; ++f) {
          fb[f] = consume_wait(sm, look);
          look.advance();
        }
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) fence_regs(mel[q]);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const uint32_t addr =
              fb[q / 4] + (q % 4) * 32 * FB_ROW_BYTES;  // 32 mel columns
          wgmma_n32(mel[q], &p[4 * kb], desc_sw128(addr) + 2 * kb, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int q = 0; q < NQ; ++q) fence_regs(mel[q]);
      fence_regs(p);
#pragma unroll
      for (int f = 0; f < FB_STAGES; ++f) consume_release(sm, pos);
    }

    // log(mel + eps) as bf16: register 4 j8 + 2 h + e of group q is frame
    // row lane/4 + 8 h, mel column col0 + 32 q + 8 j8 + 2 (lane % 4) + e.
    // Pairs of columns go out as one 4-byte store where M is even. Rows
    // past the block's tf frames repeat its last frame and are not stored.
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int i = 0; i < 16; ++i) mel[q][i] = logf(mel[q][i] + eps);
    }
    const int c0 = col0 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + frame + 8 * h;
      if (t < T && frame + 8 * h < tf) {
        __nv_bfloat16* dst = out + ((size_t)b * T + t) * M + c0;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
#pragma unroll
          for (int j8 = 0; j8 < 4; ++j8) {
            const int col = 32 * q + 8 * j8;
            const float lo = mel[q][4 * j8 + 2 * h];
            const float hi = mel[q][4 * j8 + 2 * h + 1];
            if ((M & 1) == 0 && c0 + col + 1 < M) {
              *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                  __floats2bfloat162_rn(lo, hi);
            } else {
              if (c0 + col < M) dst[col] = __float2bfloat16_rn(lo);
              if (c0 + col + 1 < M) dst[col + 1] = __float2bfloat16_rn(hi);
            }
          }
        }
      }
    }
  }
}

template <int NQ, bool ODD>
int launch(const void* x, int x_f32, const void* wp, const void* fbp,
           void* out, int batch, int S, int hop, int row, int pad, int tf,
           int K, int T, int M, int passes, int n_bt, int n_kc, float eps,
           cudaStream_t stream) {
  const int kp = n_kc * TILE_K;
  const size_t smem = smem_bytes(hop, row, pad, kp, tf, 0);
  if (!span_args_ok(hop, row, pad, kp, tf) || smem > SMEM_LIMIT ||
      passes < 1 || (passes - 1) * 32 * NQ >= M) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_logmel_kernel<NQ, ODD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + tf - 1) / tf, batch, passes);
  fused_logmel_kernel<NQ, ODD><<<grid, THREADS, smem, stream>>>(
      x, x_f32, static_cast<const __nv_bfloat16*>(wp),
      static_cast<const __nv_bfloat16*>(fbp),
      static_cast<__nv_bfloat16*>(out), S, hop, row, pad, tf, K, T, M,
      passes * 32 * NQ, n_bt, n_kc, eps);
  return (int)cudaGetLastError();
}

template <int NQ>
int launch_row(const void* x, int x_f32, const void* wp, const void* fbp,
               void* out, int batch, int S, int hop, int row, int pad, int tf,
               int K, int T, int M, int passes, int n_bt, int n_kc, float eps,
               cudaStream_t stream) {
  if (row & 1) {
    return launch<NQ, true>(x, x_f32, wp, fbp, out, batch, S, hop, row, pad,
                            tf, K, T, M, passes, n_bt, n_kc, eps, stream);
  }
  return launch<NQ, false>(x, x_f32, wp, fbp, out, batch, S, hop, row, pad,
                           tf, K, T, M, passes, n_bt, n_kc, eps, stream);
}

}  // namespace

extern "C" {

// Tile geometry, read by the Python wrapper so the two cannot drift.
int birda_fused_logmel_tile_t() { return TILE_T; }
int birda_fused_logmel_tile_bins() { return TILE_BINS; }
int birda_fused_logmel_tile_k() { return TILE_K; }

// x: [batch, S] float32 (x_f32 = 1) or bf16, contiguous; wp: [n_bt, n_kc,
// 2 * TILE_BINS, TILE_K] bf16, each [cos 64 | -sin 64] x 64 chunk a 128-B
// swizzled image; fbp: [n_bt, passes * mp, TILE_BINS] bf16, the same
// swizzle; out: [batch, T, M] bf16. mp: the padded mel width of one pass
// (a multiple of 32, at most 256); row: the span's row length, min(hop,
// n_kc * TILE_K); pad: its row padding (0 for an odd row); tf: frames per
// block, a power of two up to 128. Returns cudaGetLastError() after the
// launch (0 = launched).
int birda_fused_logmel(const void* x, int x_f32, const void* wp,
                       const void* fbp, void* out, int batch, int S, int hop,
                       int row, int pad, int tf, int K, int T, int M, int mp,
                       int passes, int n_bt, int n_kc, float eps,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BIRDA_LOGMEL_CASE(NQ)                                               \
  case 32 * NQ:                                                             \
    return launch_row<NQ>(x, x_f32, wp, fbp, out, batch, S, hop, row, pad,  \
                          tf, K, T, M, passes, n_bt, n_kc, eps, s);
  switch (mp) {
    BIRDA_LOGMEL_CASE(1)
    BIRDA_LOGMEL_CASE(2)
    BIRDA_LOGMEL_CASE(3)
    BIRDA_LOGMEL_CASE(4)
    BIRDA_LOGMEL_CASE(5)
    BIRDA_LOGMEL_CASE(6)
    BIRDA_LOGMEL_CASE(7)
    BIRDA_LOGMEL_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BIRDA_LOGMEL_CASE
}

}  // extern "C"
