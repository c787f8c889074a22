// Strided-window GEMM mainloop for Hopper (sm_90a), shared by
// fused_logmel.cu and conv1d_stft.cu.
//
// The product is out[t, n] = sum_k x[t * hop + k] * w[n, k]: M = frames,
// N = output columns, K = the window. A block owns `tf` frames of one
// signal row (TILE_T = 128, or a smaller power of two where the span of
// 128 frames does not fit shared memory) and walks every N tile of TILE_N = 128
// columns, K in TILE_K = 64 chunks, with the kernel's own epilogue after
// each N tile.
//
//  - The signal span of the block's frames, (tf - 1) * hop + Kp samples,
//    is loaded once into shared memory (16-B vector loads of the signal in
//    its own dtype, float32 or bf16, rounded to bf16 to nearest even, zeros
//    at and past S). Frame t starts at t * hop, which is not 16-B aligned
//    at hop 278, so frames cannot be a shared-memory wgmma operand: they
//    are the wgmma A operand from registers. Where a row's start is even
//    each A register (two consecutive samples of one frame) is one 32-bit
//    shared load; an odd row length packs two 2-byte loads.
//  - The span is stored in rows, one per hop: `row` = min(hop, Kp) samples
//    of each (a hop longer than the window leaves samples no frame reads,
//    which are not stored), each padded by `pad` samples (span_pad() on
//    the host), so that the eight frames a warp reads at one window
//    position fall on distinct banks (row stride (row + pad) / 2 = 4 mod 8
//    words). Sample p of the span sits at (p / hop) * (row + pad) +
//    p % hop.
//  - Weights are the wgmma B operand. The host lays each [TILE_N, TILE_K]
//    chunk out as the 16 KB 128-B-swizzled K-major image the wgmma
//    descriptor reads (prepare_*_weights in ops/stft_conv.py), so one 1-D
//    bulk copy moves it; no tensor map is needed. One producer warp keeps
//    a ring of STAGES chunks in flight, signalled by full/empty mbarriers.
//  - Two consumer warpgroups each take 64 of the 128 frames and issue
//    wgmma.mma_async m64n128k16 (bf16 operands, fp32 accumulators in
//    registers); setmaxnreg moves registers from the producer to them.
//    Below 128 frames the second warpgroup only waits on and releases the
//    ring's stages, and the first one's rows past `tf` repeat its last
//    frame and are not stored.
//
// Launch: THREADS = 384 (two consumer warpgroups, then the producer),
// grid (ceil(T / tf), B), dynamic shared memory from smem layout below.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace swg {

constexpr int TILE_T = 128;  // frames per block
constexpr int TILE_N = 128;  // output columns per N tile
constexpr int TILE_K = 64;   // window depth per ring stage (128 B of bf16)
constexpr int STAGES = 4;    // 6 and 8 were no faster on an H100
constexpr int STAGE_BYTES = TILE_N * TILE_K * 2;  // 16 KB
constexpr int CONSUMER_THREADS = 256;
// The producer is a whole warpgroup (the third), so that setmaxnreg, which
// acts on warpgroups, can take its registers; one lane issues the copies.
constexpr int PRODUCER_THREADS = 128;
constexpr int PRODUCER_WG = 2;
constexpr int THREADS = CONSUMER_THREADS + PRODUCER_THREADS;
// 2 x 128 x 240 + 128 x 24 registers fit the SM's 65,536. At 240 the
// widest mel tiling (256 columns: 128 mel + 64 DFT accumulators + 16 A
// registers per thread) compiles without a spill; at 232 it spills.
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
// Shared memory a block may use on sm_90 (232,448 bytes).
constexpr size_t SMEM_LIMIT = 232448;

// The padded span: rows of `row` (+pad) samples, one per hop, covering
// (tf - 1) * hop + kp samples.
__host__ __device__ inline int span_rows(int hop, int kp, int tf) {
  return tf - 1 + (kp + hop - 1) / hop;
}
__host__ __device__ inline size_t span_bytes(int hop, int row, int pad,
                                             int kp, int tf) {
  const size_t n = (size_t)span_rows(hop, kp, tf) * (row + pad);
  return (n * 2 + 15) / 16 * 16;
}

// Dynamic shared memory: 1 KB of alignment slack, the ring (1024-B aligned,
// as the 128-B swizzle needs), 2 * STAGES mbarriers, the span, then
// `extra` bytes for the kernel's epilogue.
__host__ __device__ inline size_t smem_bytes(int hop, int row, int pad,
                                             int kp, int tf, size_t extra) {
  return 1024 + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8 +
         span_bytes(hop, row, pad, kp, tf) + extra;
}

// The geometry arguments a launch checks: tf a power of two up to TILE_T,
// row the span's row length, a pad that keeps even rows 4-B aligned.
__host__ inline bool span_args_ok(int hop, int row, int pad, int kp,
                                  int tf) {
  const bool tf_ok = tf >= 1 && tf <= TILE_T && (tf & (tf - 1)) == 0;
  const int want_row = hop < kp ? hop : kp;
  return tf_ok && row == want_row && pad >= 0 && (pad & 1) == 0 &&
         ((row & 1) == 0 || pad == 0);
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits for the phase after `parity`. A plain spin: a timeout that traps
// (or a printf) inside the consumer loop costs registers that ptxas then
// takes from the wgmma accumulators, spilling them and serialising every
// wgmma (ptxas -v reports it), at a quarter of the kernel's speed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One 1-D bulk copy global -> shared, completing `bytes` on `bar`.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// Warpgroup of this thread, known warp-uniform to the compiler (the roles
// split on it, and setmaxnreg needs uniform control flow).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma window.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A registers: they are read until the wgmma completes.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// wgmma descriptor of a K-major, 128-B-swizzled operand at shared address
// `addr` (1024-B aligned at the image's base): rows of 128 B (64 bf16 of
// K), 8-row core matrices 1024 B apart (SBO), swizzle mode 1 (128 B). A
// 16-deep K step inside the row adds 32 B (2 in the address field).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D[64 x 128] (+)= A[64 x 16] (registers, bf16) * B[16 x 128] (smem).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t* a,
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] (registers, bf16) * B[16 x 32] (smem).
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t* a,
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Shared-memory layout and the ring
// ---------------------------------------------------------------------------

struct Smem {
  uint8_t* ring;        // STAGES x STAGE_BYTES, 1024-B aligned
  uint64_t* full;       // STAGES mbarriers: stage loaded
  uint64_t* empty;      // STAGES mbarriers: stage released by consumers
  __nv_bfloat16* span;  // the padded signal span
  uint8_t* extra;       // epilogue scratch

  __device__ Smem(uint8_t* raw, int hop, int row, int pad, int kp, int tf) {
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    ring = base;
    full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE_BYTES);
    empty = full + STAGES;
    span = reinterpret_cast<__nv_bfloat16*>(empty + STAGES);
    extra = reinterpret_cast<uint8_t*>(span) +
            span_bytes(hop, row, pad, kp, tf);
  }
};

// Ring position: stage index and the phase parity of its barriers.
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Each consumer warp releases a stage once its wgmma reading it is done.
constexpr uint32_t EMPTY_ARRIVALS = CONSUMER_THREADS / 32;

// Block set-up, by every thread before the roles split.
__device__ __forceinline__ void init_barriers(const Smem& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&sm.full[s]), 1);
      mbar_init(smem_u32(&sm.empty[s]), EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Producer (one lane): wait for the slot to be free, then copy `bytes`
// from `src` into it.
__device__ __forceinline__ void produce(const Smem& sm, RingPos& pos,
                                        const void* src, uint32_t bytes) {
  const uint32_t full = smem_u32(&sm.full[pos.stage]);
  mbar_wait(smem_u32(&sm.empty[pos.stage]), pos.phase ^ 1);
  mbar_expect_tx(full, bytes);
  bulk_g2s(smem_u32(sm.ring + pos.stage * STAGE_BYTES), src, bytes, full);
  pos.advance();
}

// Consumer: wait until the stage at `pos` is loaded; its shared address.
__device__ __forceinline__ uint32_t consume_wait(const Smem& sm,
                                                 const RingPos& pos) {
  mbar_wait(smem_u32(&sm.full[pos.stage]), pos.phase);
  return smem_u32(sm.ring + pos.stage * STAGE_BYTES);
}

// Consumer: this warp is done with the stage at `pos` (after the wgmma
// reading it has completed).
__device__ __forceinline__ void consume_release(const Smem& sm,
                                                RingPos& pos) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(smem_u32(&sm.empty[pos.stage]));
  pos.advance();
}

// ---------------------------------------------------------------------------
// The span: loaded once by the consumer threads
// ---------------------------------------------------------------------------

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) {
  return v;
}

// Copies samples [g0, g0 + span_len) of signal `sig` (length S) into the
// padded span, bf16, zeros at and past S; of each hop only its first `row`
// samples. 16-B vector loads of IN.
template <typename IN>
__device__ void load_span_typed(__nv_bfloat16* span, const IN* sig, int S,
                                int g0, int span_len, int hop, int row,
                                int pad, int tid) {
  constexpr int EPV = 16 / sizeof(IN);
  const IN* src = sig + g0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  const int head = (int)((addr & 15) / sizeof(IN));
  const uint4* vsrc = reinterpret_cast<const uint4*>(addr - (addr & 15));
  const int valid = min(span_len, S - g0);
  const int nvec = (head + span_len + EPV - 1) / EPV;
  const float inv_hop = 1.0f / (float)hop;
  // LOADS vectors in flight per thread: the loads of a batch are issued
  // before any is used, so the span costs a few memory latencies, not one
  // per vector.
  constexpr int LOADS = 8;
  for (int v0 = tid; v0 < nvec; v0 += LOADS * CONSUMER_THREADS) {
    uint4 raw[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int v = v0 + i * CONSUMER_THREADS;
      raw[i] = make_uint4(0, 0, 0, 0);
      if (v < nvec && v * EPV - head < valid) raw[i] = __ldg(vsrc + v);
    }
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int v = v0 + i * CONSUMER_THREADS;
      if (v >= nvec) break;
      const int p0 = v * EPV - head;  // span position of the first element
      const IN* vals = reinterpret_cast<const IN*>(&raw[i]);
      const int p = max(p0, 0);
      int j = (int)(((float)p + 0.5f) * inv_hop);  // row of the span
      int r = p - j * hop;                          // position in the row
      if (r < 0) {
        --j;
        r += hop;
      } else if (r >= hop) {
        ++j;
        r -= hop;
      }
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        const int q = p0 + e;
        if (q >= 0 && q < span_len && r < row) {
          span[j * (row + pad) + r] =
              q < valid ? to_bf16(vals[e]) : __float2bfloat16_rn(0.0f);
        }
        if (++r == hop) {
          r = 0;
          ++j;
        }
      }
    }
  }
}

__device__ __forceinline__ void load_span(__nv_bfloat16* span, const void* x,
                                          bool x_f32, int b, int S, int g0,
                                          int span_len, int hop, int row,
                                          int pad, int tid) {
  if (x_f32) {
    load_span_typed(span, static_cast<const float*>(x) + (size_t)b * S, S,
                    g0, span_len, hop, row, pad, tid);
  } else {
    load_span_typed(span,
                    static_cast<const __nv_bfloat16*>(x) + (size_t)b * S, S,
                    g0, span_len, hop, row, pad, tid);
  }
}

// ---------------------------------------------------------------------------
// Frames as the A operand
// ---------------------------------------------------------------------------

// This thread's view of the span for m64k16 A fragments. Per warp w of a
// consumer warpgroup, lane l holds frames r0 = 16w + l/4 and r0 + 8, and
// window positions k + 2(l%4) + {0, 1} and those + 8 of each 16-deep step
// (registers {r0, k}, {r0+8, k}, {r0, k+8}, {r0+8, k+8}). Frames past the
// block's last (`last`) read the last one instead.
template <bool ODD>
struct FrameCursor {
  const __nv_bfloat16* span;
  int row0, row8;  // element offsets of the two frames' starts
  int hop, pad, K;
  // Window position of register pairs {k} and {k+8}, their offsets in the
  // padded span (k + pad * (k / hop): a window crosses a row boundary only
  // where rows are whole hops) and the next row boundary.
  int ka, ga, ba, kb, gb, bb;

  __device__ FrameCursor(const __nv_bfloat16* span_, int frame0, int last,
                         int hop_, int row, int pad_, int K_)
      : span(span_), hop(hop_), pad(pad_), K(K_) {
    row0 = min(frame0, last) * (row + pad);
    row8 = min(frame0 + 8, last) * (row + pad);
  }

  // Back to window position 0 (the start of an N tile).
  __device__ __forceinline__ void rewind() {
    const int tq = (threadIdx.x & 3) * 2;  // lane % 4
    ka = tq;
    kb = tq + 8;
    ga = ka + (ka >= hop ? pad : 0);
    ba = ka >= hop ? 2 * hop : hop;
    gb = kb + (kb >= hop ? pad : 0);
    bb = kb >= hop ? 2 * hop : hop;
  }

  __device__ __forceinline__ void step16() {
    ka += 16;
    ga += 16;
    if (ka >= ba) {
      ga += pad;
      ba += hop;
    }
    kb += 16;
    gb += 16;
    if (kb >= bb) {
      gb += pad;
      bb += hop;
    }
  }

  __device__ __forceinline__ uint32_t pair(int off) const {
    if (ODD) {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(span);
      return (uint32_t)s[off] | ((uint32_t)s[off + 1] << 16);
    }
    return *reinterpret_cast<const uint32_t*>(span + off);
  }

  // Zeroes window positions at and past K (in the last chunk of a K that
  // is not a whole number of chunks).
  static __device__ __forceinline__ uint32_t mask(int left) {
    return left >= 2 ? 0xffffffffu : (left == 1 ? 0x0000ffffu : 0u);
  }

  // The A registers of one TILE_K chunk (four 16-deep steps); advances.
  __device__ __forceinline__ void load_chunk(uint32_t (&a)[16], bool tail) {
#pragma unroll
    for (int s = 0; s < TILE_K / 16; ++s) {
      a[4 * s + 0] = pair(row0 + ga);
      a[4 * s + 1] = pair(row8 + ga);
      a[4 * s + 2] = pair(row0 + gb);
      a[4 * s + 3] = pair(row8 + gb);
      if (tail) {
        const uint32_t ma = mask(K - ka), mb = mask(K - kb);
        a[4 * s + 0] &= ma;
        a[4 * s + 1] &= ma;
        a[4 * s + 2] &= mb;
        a[4 * s + 3] &= mb;
      }
      step16();
    }
  }
};

// acc[64 x 128] = frames[64, K] x chunk images, over n_kc ring stages. On
// return every stage is released and the wgmma work is complete. Each chunk
// is waited for before the next one's frames are loaded: the other consumer
// warpgroup's wgmma fill the tensor cores meanwhile. (Keeping two chunks in
// flight needs 16 more A registers, which made ptxas serialise the wgmma of
// the wide mel tilings, and was no faster on an H100 at the narrow ones.)
template <bool ODD>
__device__ __forceinline__ void mma_window(float (&acc)[64],
                                           FrameCursor<ODD>& fc,
                                           const Smem& sm, RingPos& pos,
                                           int n_kc) {
  fc.rewind();
  const bool ragged = (fc.K % TILE_K) != 0;
  for (int c = 0; c < n_kc; ++c) {
    uint32_t a[16];
    fc.load_chunk(a, ragged && c == n_kc - 1);
    const uint64_t desc = desc_sw128(consume_wait(sm, pos));
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < TILE_K / 16; ++s) {
      wgmma_n128(acc, &a[4 * s], desc + 2 * s, c > 0 || s > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(a);
    consume_release(sm, pos);
  }
}

// A warpgroup with no frames of its own: waits on and releases `n` ring
// stages, as the consumer that reads them would.
__device__ __forceinline__ void skip_stages(const Smem& sm, RingPos& pos,
                                            int n) {
  for (int c = 0; c < n; ++c) {
    consume_wait(sm, pos);
    consume_release(sm, pos);
  }
}

}  // namespace swg
