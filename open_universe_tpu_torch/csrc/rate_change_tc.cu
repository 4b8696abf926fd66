// UNIVERSE ConvBlock rate change on Hopper's tensor cores (sm_90a), float32
// as 3xTF32, on two cores: wgmma (m64nNk8, the table RateWgTile) and
// mma.sync m16n8k8 (every other launch).
//
// Replaces no TPU kernel: the JAX package leaves the strided and transposed
// rate-change convs, PReLU and UNIVERSE++'s binomial low-pass to XLA.  Here
// cuDNN ran them on a transposed (B, C, T) view, with three elementwise
// kernels for PReLU, a depthwise conv for the low-pass, and copies back to
// the port's (B, T, C) layout around each.  This kernel computes a whole
// rate change in one pass over device memory, on that layout.
//
// Every rate-change conv has kernel = stride = r and no padding, so on
// (B, T, C) it is a plain GEMM on a block view of the rows:
//
//   down: x (B, T, Cin) as (B, T/r, r Cin) @ W (r Cin, Cout) -> (B, T/r, Cout)
//   up:   x (B, T, Cin) @ W (Cin, r Cout) -> (B, T, r Cout) = (B, T r, Cout)
//
// and each output is bias + PReLU(x) @ W, the single PReLU slope in float32
// applied as the A operand is read.  A down input whose T is not a multiple
// of r reads zeros past T, as the module's right pad does (PReLU(0) = 0).
//
// UNIVERSE++'s anti-aliased blocks (a template parameter) add the 'same'
// (2r + 1)-tap binomial low-pass, as an exact float32 FIR on the CUDA cores:
// before the GEMM on the input samples (down: PReLU, low-pass, conv) or after
// it on the output samples (up: conv, low-pass, bias).  Its half-width r
// never reaches past one neighbouring block of r samples, so a down block
// stages one halo row on each side of its tile and an up block computes one
// halo GEMM row on each side of its outputs.  At a batch row's first and
// last block the halo is zeros, never the neighbouring row's samples: the
// 'same' zero padding.  Folding the low-pass into the weights instead would
// make a 3r-tap conv and triple the tensor-core work.
//
// What bounds it on the H100.  A down block does 2 r Cin Cout FLOPs per
// output row for 4 (r Cin + Cout) bytes; at the ConvBlock widths (Cout =
// 2 Cin; an up block is the mirror) that is r Cin / (r + 2) FLOPs per byte:
// 16 at the 16 kHz model's C = 32, 183 at C = 256.  Against the card's
// balance for float32 work counted once (495 TFLOP/s over 3.35 TB/s, ~148)
// only the widest pair is bound by operations; but 3xTF32 runs three TF32
// products per product (the chain kernel's split, csrc/conv_block_tc.cu,
// which says why it holds the float32 gate), so against 495 / 3 TFLOP/s
// (~49 FLOP/byte) every block from C = 64 up is bound by the products, and
// on mma.sync by issuing them: variants that cut the split's and PReLU's
// instructions ran no faster on the card (PERF.md).
//
// The mma.sync core.  One block of 8 warps computes BM GEMM rows x CN output
// channels (up: CN channels of each of the r output samples).  The reduction
// runs in chunks of CK input channels (down: of each of the r input samples
// of a row).  Each chunk, with the weight fragments of its k-steps, is copied
// to shared memory by cp.async, zero-filled outside the rows and samples that
// exist, STAGES - 1 chunks ahead of the GEMM, so the copies overlap the
// products; a table made once per block gives each staged row's offset and
// place in its batch row.  A chunk row holds its samples' channels in groups
// of 8, [ci / 8][sample][ci % 8], so k8 step s of a chunk reads floats
// 8 s .. 8 s + 7 of a row, and the weights' reduction order is (ci / 8,
// sample, ci % 8) whatever CK is (ops/kernels/rate_change.py::kernel_weights
// orders them so).  A is read by ldmatrix (the chain kernel's TF32 A
// fragment) from rows padded by 16 bytes, so that the eight rows of an
// ldmatrix fall on distinct banks, and is split in registers as the chain
// kernel splits it.  B, the weights, comes pre-split in the chain kernel's
// fragment order, one 16-byte load per lane and n8 tile, prefetched one
// k-step ahead; staging it keeps the weights' latency out of the k-loop and
// reads them from L2 once per block rather than once per warp.  The low-pass
// runs four channels at a time from registers, each thread sliding over one
// row's 3r samples.  The epilogue adds the bias and stores float2 pairs in
// place in the contiguous output; an anti-aliased up block first puts its
// accumulators in shared memory, then filters along time and stores float4s.
// Its tile table was picked by timing variants side by side on the H100 at
// the batch-128 shapes of the 16 kHz presets (PERF.md).  On it a block
// covers at most 64 output channels, so a wide block re-staged, re-PReLUed
// and re-filtered the same input rows once per output tile.
//
// The wgmma core (below) covers the whole output width, or up to 256
// columns of it a warpgroup, so each input row is staged, PReLUed, filtered
// and split once per block; its weights stream through a shared-memory ring
// by TMA's bulk copy; and the down blocks' low-pass of the next chunk runs
// while the tensor cores work on this one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// WARPS_M x (kWarps / WARPS_M) warps; MI m16 tiles per warp (WM = 16 MI
// rows), NN n8 tiles per warp and output sample; CK input channels per
// chunk; STAGES chunks in shared memory at once; BLOCKS blocks per SM the
// registers are capped for.
template <bool UP, int R> struct RateTile;
template <int R> struct RateTile<false, R> {
  static constexpr int WARPS_M = 4, MI = 2, NN = 4, CK = R == 2 ? 16 : 8, STAGES = 2, BLOCKS = 2;
};
template <int R> struct RateTile<true, R> {
  static constexpr int WARPS_M = R <= 4 ? 2 : 4, MI = R <= 4 ? 4 : 2, NN = 1, CK = 32,
                       STAGES = 2, BLOCKS = R == 8 ? 1 : 2;
};

template <bool UP, int R, bool AA> struct RateGeometry {
  using Tl = RateTile<UP, R>;
  static constexpr int WARPS_M = Tl::WARPS_M, WARPS_N = kWarps / Tl::WARPS_M;
  static constexpr int MI = Tl::MI, NN = Tl::NN, CK = Tl::CK, STAGES = Tl::STAGES;
  static constexpr int WM = 16 * MI;
  static constexpr int BM = WARPS_M * WM;          // GEMM rows per block
  static constexpr int RA = UP ? 1 : R;            // input samples per GEMM row
  static constexpr int NS = UP ? R : 1;            // output samples per GEMM row
  static constexpr int NF = NS * NN;               // n8 tiles per warp and k-step
  static constexpr int CN = WARPS_N * NN * 8;      // output channels per block
  static constexpr int HALO = AA ? 1 : 0;
  static constexpr int SROWS = UP ? BM : BM + 2 * HALO;     // staged input rows
  static constexpr int OUT_ROWS = UP ? BM - 2 * HALO : BM;  // output rows per block
  static constexpr int RS = RA * CK + 4;           // staged row stride, floats
  static constexpr int SC = RA * CK / 8;           // k8 steps per chunk
  static constexpr int OS = CN + 4;                // up low-pass buffer stride
  static constexpr int NB8 = NS * CN / 8;          // n8 tiles per block and k-step
  static constexpr int A_STAGE = SROWS * RS;       // floats of a stage's input rows
  static constexpr int STAGE = A_STAGE + SC * NB8 * 128;  // + its weight fragments
  static constexpr int FILT = (!UP && AA) ? BM * RS : 0;
  static constexpr int OBUF = (UP && AA) ? BM * R * OS : 0;
  static constexpr int FLOATS = STAGES * STAGE + FILT > OBUF ? STAGES * STAGE + FILT : OBUF;
  static constexpr size_t SMEM = size_t(FLOATS) * sizeof(float);
  static_assert(CK % 8 == 0 && RS % 4 == 0 && (RS / 4) % 2 == 1, "chunk rows");
  static_assert(SMEM <= 232448, "buffers exceed a block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the f32 bits x rounded to TF32 (round to nearest, ties away from zero):
// its 13 low mantissa bits zero
__device__ __forceinline__ uint32_t tf32_round(uint32_t x) {
  return (x + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ float prelu(float x, float a) { return x >= 0.f ? x : a * x; }

template <bool UP, int R, bool AA>
__global__ void __launch_bounds__(kThreads, RateTile<UP, R>::BLOCKS)
ou_rate_change_kernel(const float* __restrict__ x, const uint4* __restrict__ w,
                      const float* __restrict__ bias, const float* __restrict__ alpha_p,
                      const float* __restrict__ taps_p, float* __restrict__ out,
                      int m_rows, int tb, int t_in, int cin, int cout) {
  using G = RateGeometry<UP, R, AA>;
  constexpr int MI = G::MI, NF = G::NF, NN = G::NN;
  extern __shared__ uint4 smem_u4[];
  float* const smem = reinterpret_cast<float*>(smem_u4);
  float* const filt = smem + G::STAGES * G::STAGE;  // down, anti-aliased: the filtered chunk
  float* const obuf = smem;                 // up, anti-aliased: the GEMM's output

  const int n_tiles = (cout + G::CN - 1) / G::CN;
  const int c0 = (blockIdx.x % n_tiles) * G::CN;   // the block's first output channel
  const int mt = blockIdx.x / n_tiles;
  const int row0 = mt * G::OUT_ROWS - (UP ? G::HALO : 0);  // GEMM row of local row 0
  const int srow0 = row0 - (UP ? 0 : G::HALO);              // input row of staged row 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;  // accumulator row, column pair
  const int m0 = (warp / G::WARPS_N) * G::WM, n0 = (warp % G::WARPS_N) * NN * 8;
  const bool active = c0 + n0 < cout;     // cout is a multiple of NN * 8
  const float alpha = alpha_p[0];
  float taps[2 * R + 1];
#pragma unroll
  for (int d = 0; d <= 2 * R; ++d) taps[d] = AA ? taps_p[d] : 0.f;

  // weights: the 16-byte fragment of k8 step s (over the whole reduction)
  // and n8 tile nb is w[(s * ng8 + nb) * 32 + lane]; a stage holds the
  // block's n8 tiles (output sample k, channels c0 + 8 t ..) of its chunk's
  // k-steps at [(s * NS + k) * CN / 8 + t] * 32 + lane, zero past cout
  const int ng8 = G::NS * cout / 8, cout8 = cout / 8, cb0 = c0 / 8;

  // each staged row's first input sample: its offset in x and its position
  // in its batch row (T outside the rows, so that no sample is read)
  __shared__ long long row_base[G::SROWS];
  __shared__ int row_pos[G::SROWS];
  for (int lr = threadIdx.x; lr < G::SROWS; lr += kThreads) {
    const int grow = srow0 + lr;
    int pos = t_in;
    long long base = 0;
    if (grow >= 0 && grow < m_rows) {
      const int b = grow / tb;
      pos = (grow - b * tb) * G::RA;
      base = ((long long)b * t_in + pos) * cin;
    }
    row_base[lr] = base;
    row_pos[lr] = pos;
  }
  __syncthreads();

  // a stage: chunk of input channels [chunk CK, chunk CK + CK) of the staged
  // rows, zero outside the rows and the samples [0, T) of each batch row,
  // and the weight fragments of the chunk's k-steps
  auto stage = [&](int chunk, float* buf) {
    constexpr int PIECES = G::CK / 4;  // 16-byte pieces per sample
    constexpr int PER_ROW = G::RA * PIECES;
    for (int idx = threadIdx.x; idx < G::SROWS * PER_ROW; idx += kThreads) {
      const int lr = idx / PER_ROW, rem = idx - lr * PER_ROW;
      const int k = rem / PIECES, p = rem - k * PIECES;
      const bool valid = row_pos[lr] + k < t_in;
      cp_async16(buf + lr * G::RS + ((p >> 1) * G::RA + k) * 8 + (p & 1) * 4,
                 valid ? x + row_base[lr] + k * cin + chunk * G::CK + p * 4 : x, valid);
    }
    constexpr int T8 = G::CN / 8;
    for (int idx = threadIdx.x; idx < G::SC * G::NB8 * 32; idx += kThreads) {
      const int l = idx & 31, tile = idx >> 5;
      const int sk = tile / T8, t = tile - sk * T8;  // sk = s NS + k
      const int s = sk / G::NS, k = sk - s * G::NS;
      const bool valid = cb0 + t < cout8;
      const uint4* src = w + (size_t(chunk * G::SC + s) * ng8 + k * cout8 + cb0 + t) * 32 + l;
      cp_async16(buf + G::A_STAGE + idx * 4, reinterpret_cast<const float*>(valid ? src : w),
                 valid);
    }
  };

  float acc[MI][NF][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][f][e] = 0.f;

  // the warp's tile f is output sample f / NN, channels c0 + n0 + 8 (f % NN) ..
  auto bfrag = [&](const uint4* bs, int s, int f) {
    return bs[((s * G::NS + f / NN) * (G::CN / 8) + n0 / 8 + f % NN) * 32 + lane];
  };

  // chunk c in stage c % STAGES, STAGES - 1 chunks ahead of the GEMM; one
  // commit group per chunk (empty past the last), so waiting for all but
  // the newest STAGES - 1 groups waits for chunk c
  const int chunks = cin / G::CK;
  for (int c = 0; c < G::STAGES - 1; ++c) {
    if (c < chunks) stage(c, smem + c * G::STAGE);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < chunks; ++chunk) {
    float* const raw = smem + (chunk % G::STAGES) * G::STAGE;
    const int ahead = chunk + G::STAGES - 1;
    if (ahead < chunks) stage(ahead, smem + (ahead % G::STAGES) * G::STAGE);
    cp_async_commit();
    cp_async_wait<G::STAGES - 1>();
    __syncthreads();
    const float* src = raw;
    if constexpr (!UP && AA) {
      // PReLU, then the low-pass of the GEMM rows' samples from the staged
      // rows lr .. lr + 2 (a halo row on each side), four channels at a
      // time: output sample pos + k of GEMM row lr (pos = its first sample)
      // takes taps[d] x[pos + k + d - r], zero outside [0, T)
      for (int idx = threadIdx.x; idx < G::BM * G::CK / 4; idx += kThreads) {
        const int lr = idx / (G::CK / 4), cq = idx - lr * (G::CK / 4);
        const int pos = row_pos[lr + 1] - R;  // of window sample 0
        const bool edge = pos < 0 || pos + 3 * R > t_in;
        const int col = (cq >> 1) * R * 8 + (cq & 1) * 4;
        float4 v[3 * R];
#pragma unroll
        for (int u = 0; u < 3 * R; ++u) {
          float4 xv = *reinterpret_cast<const float4*>(raw + (lr + u / R) * G::RS + col +
                                                       (u % R) * 8);
          if (edge && (pos + u < 0 || pos + u >= t_in)) xv = make_float4(0.f, 0.f, 0.f, 0.f);
          v[u] = make_float4(prelu(xv.x, alpha), prelu(xv.y, alpha), prelu(xv.z, alpha),
                             prelu(xv.w, alpha));
        }
#pragma unroll
        for (int k = 0; k < R; ++k) {
          float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int d = 0; d <= 2 * R; ++d) {
            y.x = fmaf(taps[d], v[k + d].x, y.x);
            y.y = fmaf(taps[d], v[k + d].y, y.y);
            y.z = fmaf(taps[d], v[k + d].z, y.z);
            y.w = fmaf(taps[d], v[k + d].w, y.w);
          }
          *reinterpret_cast<float4*>(filt + lr * G::RS + col + k * 8) = y;
        }
      }
      __syncthreads();
      src = filt;
    }
    if (active) {
      // ldmatrix.x4: lanes 0-15 address rows 0-15 at k 0, lanes 16-31 at k 4
      const uint32_t a_base = smem_u32(src + (m0 + (lane & 15)) * G::RS + (lane >> 4) * 4);
      const uint4* bs = reinterpret_cast<const uint4*>(raw + G::A_STAGE);
      uint4 b[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) b[f] = bfrag(bs, 0, f);
#pragma unroll 2
      for (int s = 0; s < G::SC; ++s) {
        const int sn = s + 1 < G::SC ? s + 1 : s;
        uint4 bn[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) bn[f] = bfrag(bs, sn, f);
        uint32_t a[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
          ldmatrix_x4(a[i], a_base + (i * 16 * G::RS + s * 8) * 4);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float av = __uint_as_float(a[i][e]);
            if constexpr (UP || !AA) av = prelu(av, alpha);
            hi[e] = tf32_round(__float_as_uint(av));
            lo[e] = __float_as_uint(av - __uint_as_float(hi[e]));
          }
#pragma unroll
          for (int f = 0; f < NF; ++f) {  // the small terms first
            mma_tf32(acc[i][f], lo, b[f].x, b[f].y);
            mma_tf32(acc[i][f], hi, b[f].z, b[f].w);
            mma_tf32(acc[i][f], hi, b[f].x, b[f].y);
          }
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) b[f] = bn[f];
      }
    }
    __syncthreads();
  }

  if constexpr (UP && AA) {
    // the GEMM rows' r output samples to obuf [row r + k][channel], then the
    // low-pass along time for the inner rows, plus bias
    if (active) {
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int lr = m0 + i * 16 + g + hh * 8;
            *reinterpret_cast<float2*>(obuf + (lr * R + f / NN) * G::OS + n0 +
                                       (f % NN) * 8 + q * 2) =
                make_float2(acc[i][f][2 * hh], acc[i][f][2 * hh + 1]);
          }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < G::OUT_ROWS * G::CN / 4; idx += kThreads) {
      const int lr = 1 + idx / (G::CN / 4), cw = 4 * (idx % (G::CN / 4));
      const int grow = row0 + lr, co = c0 + cw;
      if (grow >= m_rows || co >= cout) continue;
      const int t = row_pos[lr];  // the row's step in its batch row
      float4 v[3 * R];
#pragma unroll
      for (int u = 0; u < 3 * R; ++u) {
        const bool valid = u < R ? t > 0 : (u < 2 * R || t + 1 < t_in);
        v[u] = valid ? *reinterpret_cast<const float4*>(obuf + ((lr - 1) * R + u) * G::OS + cw)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float4 bb = make_float4(bias[co], bias[co + 1], bias[co + 2], bias[co + 3]);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float4 y = bb;
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int d = 0; d <= 2 * R; ++d) {
          f.x = fmaf(taps[d], v[k + d].x, f.x);
          f.y = fmaf(taps[d], v[k + d].y, f.y);
          f.z = fmaf(taps[d], v[k + d].z, f.z);
          f.w = fmaf(taps[d], v[k + d].w, f.w);
        }
        y.x += f.x, y.y += f.y, y.z += f.z, y.w += f.w;
        *reinterpret_cast<float4*>(out + (size_t(grow) * R + k) * cout + co) = y;
      }
    }
  } else {
    if (!active) return;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int co = c0 + n0 + (f % NN) * 8 + q * 2;
      const float2 bb = make_float2(bias[co], bias[co + 1]);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int grow = row0 + m0 + i * 16 + g + hh * 8;
          if (grow >= m_rows) continue;
          *reinterpret_cast<float2*>(out + (size_t(grow) * G::NS + f / NN) * cout + co) =
              make_float2(acc[i][f][2 * hh] + bb.x, acc[i][f][2 * hh + 1] + bb.y);
        }
    }
  }
}

template <bool UP, int R, bool AA>
cudaError_t launch(const float* x, const uint4* w, const float* bias, const float* alpha,
                   const float* taps, float* out, int batch, int t_in, int cin, int cout,
                   cudaStream_t stream) {
  using G = RateGeometry<UP, R, AA>;
  auto kernel = ou_rate_change_kernel<UP, R, AA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::SMEM));
  if (err != cudaSuccess) return err;
  const int tb = UP ? t_in : (t_in + R - 1) / R;
  const long long m_rows = (long long)batch * tb;
  const long long blocks =
      (m_rows + G::OUT_ROWS - 1) / G::OUT_ROWS * ((cout + G::CN - 1) / G::CN);
  if (m_rows >= (1LL << 31) || blocks >= (1LL << 31) || cin % G::CK || cout % (G::NN * 8))
    return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), kThreads, G::SMEM, stream>>>(
      x, w, bias, alpha, taps, out, int(m_rows), tb, t_in, cin, cout);
  return cudaGetLastError();
}

// ---- the wgmma core --------------------------------------------------------
//
// One block computes BM GEMM rows x BN columns with BM / 64 x WG_N consumer
// warpgroups and one producer warp.  Warpgroup w owns rows 64 (w / WG_N) ..
// and the WI columns from (w % WG_N) WI, as m64 x WI accumulators in
// registers for the whole reduction.  BN is the whole output width where
// that fits (down: Cout; up: r Cout), else a part of it: N / BN blocks per
// row tile, next to each other in the grid, so that they find the same
// input rows in L2.  An up block's columns are ordered (co / 8, sample,
// co % 8), so that a block holds all r output samples of its BN / r
// channels, which its low-pass needs.
//
// The producer streams the block's columns of the weights, KS k8 steps (hi
// and lo: 64 BN bytes each) a stage, through a ring of STAGES stages with
// cp.async.bulk and full / empty mbarriers, as the chain kernel's wgmma core
// does.  The input rows come in chunks of CK input channels (down: of each
// of the r samples of a row), copied by cp.async into a ring of up to three
// chunks, as the mma.sync core stages them.  The consumers read A from there
// by ldmatrix, apply PReLU, split it into hi and lo in registers and run
// wgmma.m64nWIk8 with A from registers and B from the stage; the
// asynchronous products of one stage run while the next stage's A is read
// and split.  Without a low-pass before the products the consumers copy the
// rows themselves, two chunks ahead.  A down block that low-passes has
// three filter warps besides: they copy the rows, two chunks ahead, and run
// PReLU and the FIR of each chunk once, into one of two filtered chunks that
// the consumers read in its place (full / empty mbarriers again), so the
// FIR runs on other warps than the products and beside them.  The epilogue
// is the mma.sync core's: bias and float2 stores, or for a low-passed up
// block the accumulators in shared memory (over the rings), the FIR along
// time and float4 stores.

// BM: GEMM rows per block (a multiple of 64); WG_N: warpgroups across the
// block's columns; WI: columns a warpgroup (one wgmma); CK: input channels
// per chunk; KS: k8 steps per weight stage; STAGES: ring depth; BLOCKS:
// blocks per SM the registers are capped for; MIN_ROWS: fewest GEMM rows
// (B ceil(T / r) down, B T up) a launch must have to take this core; below
// it, and at the shapes without an entry (BM = 0), the mma.sync core, which
// every shape keeps (its kernel takes any Cin).  Keyed by direction, r and Cin (Cout follows); picked by timing
// variants side by side on the H100 at the presets' batch-128 shapes and by
// a batch sweep (PERF.md).
template <bool UP, int R, int CIN> struct RateWgTile { static constexpr int BM = 0; };
template <> struct RateWgTile<false, 4, 64> { static constexpr int BM = 64, WG_N = 1, WI = 128, CK = 8, KS = 2, STAGES = 4, BLOCKS = 2, MIN_ROWS = 1; };
template <> struct RateWgTile<false, 4, 128> { static constexpr int BM = 128, WG_N = 1, WI = 256, CK = 8, KS = 1, STAGES = 4, BLOCKS = 1, MIN_ROWS = 8040; };
template <> struct RateWgTile<false, 5, 256> { static constexpr int BM = 64, WG_N = 2, WI = 256, CK = 8, KS = 1, STAGES = 4, BLOCKS = 1, MIN_ROWS = 2048; };
template <> struct RateWgTile<false, 2, 48> { static constexpr int BM = 64, WG_N = 1, WI = 96, CK = 16, KS = 2, STAGES = 4, BLOCKS = 2, MIN_ROWS = 1; };
template <> struct RateWgTile<false, 3, 96> { static constexpr int BM = 128, WG_N = 1, WI = 192, CK = 16, KS = 1, STAGES = 4, BLOCKS = 1, MIN_ROWS = 1; };
template <> struct RateWgTile<false, 5, 192> { static constexpr int BM = 64, WG_N = 2, WI = 192, CK = 16, KS = 1, STAGES = 4, BLOCKS = 1, MIN_ROWS = 1; };
template <> struct RateWgTile<false, 8, 384> { static constexpr int BM = 64, WG_N = 2, WI = 192, CK = 8, KS = 1, STAGES = 4, BLOCKS = 1, MIN_ROWS = 1; };
template <> struct RateWgTile<true, 5, 512> { static constexpr int BM = 64, WG_N = 2, WI = 160, CK = 64, KS = 1, STAGES = 4, BLOCKS = 1, MIN_ROWS = 1; };
template <> struct RateWgTile<true, 4, 256> { static constexpr int BM = 64, WG_N = 2, WI = 256, CK = 32, KS = 1, STAGES = 4, BLOCKS = 1, MIN_ROWS = 1; };
template <> struct RateWgTile<true, 4, 128> { static constexpr int BM = 128, WG_N = 1, WI = 256, CK = 32, KS = 1, STAGES = 4, BLOCKS = 1, MIN_ROWS = 12000; };
template <> struct RateWgTile<true, 2, 64> { static constexpr int BM = 128, WG_N = 1, WI = 64, CK = 32, KS = 2, STAGES = 4, BLOCKS = 1, MIN_ROWS = 1; };
template <> struct RateWgTile<true, 8, 768> { static constexpr int BM = 64, WG_N = 2, WI = 256, CK = 32, KS = 1, STAGES = 4, BLOCKS = 1, MIN_ROWS = 1; };
template <> struct RateWgTile<true, 5, 384> { static constexpr int BM = 64, WG_N = 2, WI = 160, CK = 32, KS = 2, STAGES = 4, BLOCKS = 1, MIN_ROWS = 1; };
template <> struct RateWgTile<true, 3, 192> { static constexpr int BM = 64, WG_N = 2, WI = 144, CK = 32, KS = 1, STAGES = 4, BLOCKS = 1, MIN_ROWS = 1; };
template <> struct RateWgTile<true, 2, 96> { static constexpr int BM = 64, WG_N = 1, WI = 96, CK = 96, KS = 2, STAGES = 4, BLOCKS = 2, MIN_ROWS = 1; };

template <bool UP, int R, int CIN, bool AA> struct RateWgGeometry {
  using W = RateWgTile<UP, R, CIN>;
  static constexpr int COUT = UP ? CIN / 2 : 2 * CIN;
  static constexpr int N = UP ? R * COUT : COUT;    // GEMM columns
  static constexpr int BM = W::BM, WG_N = W::WG_N, WI = W::WI, BN = WG_N * WI;
  static constexpr int N_TILES = N / BN;
  static constexpr int NWG = BM / 64 * WG_N;         // consumer warpgroups
  static constexpr bool FIR_IN = !UP && AA;           // the low-pass before the products
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int FIR_THREADS = FIR_IN ? 96 : 0;  // three filter warps
  static constexpr int THREADS = CONSUMERS + 32 + FIR_THREADS;  // and the producer warp
  static constexpr int CK = W::CK, KS = W::KS, STAGES = W::STAGES;
  static constexpr int RA = UP ? 1 : R;               // input samples per GEMM row
  static constexpr int HALO = AA ? 1 : 0;
  static constexpr int SROWS = UP ? BM : BM + 2 * HALO;     // staged input rows
  static constexpr int OUT_ROWS = UP ? BM - 2 * HALO : BM;  // output rows per block
  static constexpr int RS = RA * CK + 4;              // staged row stride, floats
  static constexpr int SC = RA * CK / 8;              // k8 steps per chunk
  static constexpr int GC = SC / KS;                  // weight stages per chunk
  static constexpr int CHUNKS = CIN / CK;
  static constexpr int NG = CHUNKS * GC;              // weight stages per block
  static constexpr int XS = CHUNKS < 3 ? CHUNKS : 3;  // chunks in the input ring
  static constexpr int FS = CHUNKS < 2 ? CHUNKS : 2;  // filtered chunks
  static constexpr int CN = UP ? BN / R : BN;         // output channels per block
  static constexpr int OS = CN + 4;                   // up low-pass buffer stride
  static constexpr int STAGE_BYTES = KS * 64 * BN;
  static constexpr size_t RING = size_t(STAGES) * STAGE_BYTES;
  static constexpr size_t RAW = size_t(XS) * SROWS * RS * 4;
  static constexpr size_t FILT = FIR_IN ? size_t(FS) * BM * RS * 4 : 0;
  static constexpr size_t MAIN = RING + RAW + FILT;
  static constexpr size_t OBUF = (UP && AA) ? size_t(BM) * R * OS * 4 : 0;
  static constexpr size_t BARS = (MAIN > OBUF ? MAIN : OBUF);  // full, empty barriers
  static constexpr size_t SMEM = BARS + 16 * STAGES + 16 * FS;  // and the filtered chunks'.
  static_assert(BM % 64 == 0 && N % BN == 0 && WI % 8 == 0 && WI <= 256 && SC % KS == 0 &&
                CIN % CK == 0 && CK % 8 == 0 && (RS / 4) % 2 == 1 && STAGES >= 2 &&
                CN % 8 == 0 && (!UP || BN % (8 * R) == 0) && W::MIN_ROWS >= 1,
                "wgmma rate-change tile shape");
  static_assert(SMEM + size_t(SROWS) * 12 <= 232448, "buffers exceed a block's shared memory");
};

// wgmma.m64nNk8.f32.tf32.tf32 into the warpgroup's N / 2 accumulators d, A
// from registers, B the tile at desc.  OU_WGMMA(N, the accumulators' operand
// list, the operand numbers of a[0..3], desc and the scale-d flag that follow
// them, then the accumulators eight at a time)
#define OU_D8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),       \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define OU_D16(i) OU_D8(i), OU_D8(i + 8)
#define OU_S16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define OU_S32 OU_S16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define OU_S48 OU_S32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define OU_S64 OU_S48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define OU_S72 OU_S64 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define OU_S80 OU_S72 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define OU_S96 OU_S80 ", %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define OU_S112 OU_S96 ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
#define OU_S128 OU_S112 ", %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define OU_WGMMA(N, S, A0, A1, A2, A3, DESC, ONE, ...)                                    \
  template <> struct Wgmma<N> {                                                           \
    static __device__ __forceinline__ void mma(float (&d)[N / 2], const uint32_t (&a)[4],  \
                                               uint64_t desc) {                           \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #ONE ", 0;\n"                     \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" S          \
                   "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DESC ", p, 1, 1;\n}\n" \
                   : __VA_ARGS__                                                          \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));      \
    }                                                                                     \
  };
template <int N> struct Wgmma;
OU_WGMMA(64, OU_S32, 32, 33, 34, 35, 36, 37, OU_D16(0), OU_D16(16))
OU_WGMMA(96, OU_S48, 48, 49, 50, 51, 52, 53, OU_D16(0), OU_D16(16), OU_D16(32))
OU_WGMMA(128, OU_S64, 64, 65, 66, 67, 68, 69, OU_D16(0), OU_D16(16), OU_D16(32), OU_D16(48))
OU_WGMMA(144, OU_S72, 72, 73, 74, 75, 76, 77, OU_D16(0), OU_D16(16), OU_D16(32), OU_D16(48),
         OU_D8(64))
OU_WGMMA(160, OU_S80, 80, 81, 82, 83, 84, 85, OU_D16(0), OU_D16(16), OU_D16(32), OU_D16(48),
         OU_D16(64))
OU_WGMMA(192, OU_S96, 96, 97, 98, 99, 100, 101, OU_D16(0), OU_D16(16), OU_D16(32), OU_D16(48),
         OU_D16(64), OU_D16(80))
OU_WGMMA(256, OU_S128, 128, 129, 130, 131, 132, 133, OU_D16(0), OU_D16(16), OU_D16(32),
         OU_D16(48), OU_D16(64), OU_D16(80), OU_D16(96), OU_D16(112))
#undef OU_WGMMA
#undef OU_S128
#undef OU_S112
#undef OU_S96
#undef OU_S80
#undef OU_S72
#undef OU_S64
#undef OU_S48
#undef OU_S32
#undef OU_S16
#undef OU_D16
#undef OU_D8

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (which it does not know of)
template <int N> __device__ __forceinline__ void wg_pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int KS> __device__ __forceinline__ void wg_keep(uint32_t (&hi)[KS][4], uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(hi[k][e]), "+r"(lo[k][e])::"memory");
}

// no-swizzle K-major descriptor of the B tile at shared address addr: core
// matrices of 8 columns x 4 k (128 bytes), the next 4 k 128 bytes on (LBO),
// the next 8 columns 256 bytes on (SBO)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) |
         (uint64_t(256 >> 4) << 32);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// bytes from global src to shared dst by TMA's bulk copy, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
template <int N> __device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}
template <int N> __device__ __forceinline__ void filter_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(N) : "memory");
}

template <bool UP, int R, int CIN, bool AA>
__global__ void __launch_bounds__(RateWgGeometry<UP, R, CIN, AA>::THREADS,
                                  RateWgTile<UP, R, CIN>::BLOCKS)
ou_rate_change_kernel_wgmma(const float* __restrict__ x, const float* __restrict__ w,
                            const float* __restrict__ bias, const float* __restrict__ alpha_p,
                            const float* __restrict__ taps_p, float* __restrict__ out,
                            int m_rows, int tb, int t_in) {
  using G = RateWgGeometry<UP, R, CIN, AA>;
  constexpr int KS = G::KS, RS = G::RS, COUT = G::COUT;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t ring = smem_u32(smem);
  float* const raw = reinterpret_cast<float*>(smem + G::RING);  // XS chunks of SROWS x RS
  float* const filt = raw + G::XS * G::SROWS * RS;                 // FS chunks of BM x RS
  float* const obuf = reinterpret_cast<float*>(smem);              // up, low-passed: the GEMM's output
  const uint32_t full = smem_u32(smem + G::BARS), empty = full + 8 * G::STAGES;
  const uint32_t ffull = empty + 8 * G::STAGES, fempty = ffull + 8 * G::FS;

  const int nt = blockIdx.x % G::N_TILES, mt = blockIdx.x / G::N_TILES;
  const int row0 = mt * G::OUT_ROWS - (UP ? G::HALO : 0);  // GEMM row of local row 0
  const int srow0 = row0 - (UP ? 0 : G::HALO);              // input row of staged row 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float alpha = alpha_p[0];
  float taps[2 * R + 1];
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) taps[k] = AA ? taps_p[k] : 0.f;

  // each staged row's first input sample: its offset in x and its position
  // in its batch row (T outside the rows, so that no sample is read)
  __shared__ long long row_base[G::SROWS];
  __shared__ int row_pos[G::SROWS];
  for (int lr = threadIdx.x; lr < G::SROWS; lr += G::THREADS) {
    const int grow = srow0 + lr;
    int pos = t_in;
    long long base = 0;
    if (grow >= 0 && grow < m_rows) {
      const int b = grow / tb;
      pos = (grow - b * tb) * G::RA;
      base = ((long long)b * t_in + pos) * CIN;
    }
    row_base[lr] = base;
    row_pos[lr] = pos;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * G::NWG);  // every consumer warp
    }
    for (int s = 0; s < (G::FIR_IN ? G::FS : 0); ++s) {
      mbar_init(ffull + 8 * s, G::FIR_THREADS);  // every filter thread
      mbar_init(fempty + 8 * s, 4 * G::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // input channels [chunk CK, chunk CK + CK) of the staged rows into the
  // ring, zero outside the rows and the samples [0, T) of each batch row,
  // by `threads` threads from t
  auto stage_raw = [&](int chunk, int t, int threads) {
    float* const buf = raw + (chunk % G::XS) * G::SROWS * RS;
    constexpr int PIECES = G::CK / 4;  // 16-byte pieces per sample
    constexpr int PER_ROW = G::RA * PIECES;
    for (int idx = t; idx < G::SROWS * PER_ROW; idx += threads) {
      const int lr = idx / PER_ROW, rem = idx - lr * PER_ROW;
      const int k = rem / PIECES, p = rem - k * PIECES;
      const bool valid = row_pos[lr] + k < t_in;
      cp_async16(buf + lr * RS + ((p >> 1) * G::RA + k) * 8 + (p & 1) * 4,
                 valid ? x + row_base[lr] + k * CIN + chunk * G::CK + p * 4 : x, valid);
    }
  };

  if (warp == 4 * G::NWG) {  // the producer: the block's columns of the weights
    if (lane == 0) {
      // k8 step s holds hi, then lo, each N / 8 core-matrix columns of 256
      // bytes; the block's are BN / 8 of them from nt BN / 8
      const char* wb = reinterpret_cast<const char*>(w) + size_t(nt) * G::BN * 32;
      for (int i = 0; i < G::NG; ++i) {
        const int stage = i % G::STAGES;
        if (i >= G::STAGES) mbar_wait(empty + 8 * stage, (i / G::STAGES - 1) & 1);
        mbar_expect_tx(full + 8 * stage, G::STAGE_BYTES);
#pragma unroll
        for (int k = 0; k < KS; ++k)
#pragma unroll
          for (int part = 0; part < 2; ++part)
            bulk_load(ring + stage * G::STAGE_BYTES + (k * 2 + part) * 32 * G::BN,
                      wb + (size_t(i * KS + k) * 2 + part) * G::N * 32, 32 * G::BN,
                      full + 8 * stage);
      }
    }
    return;
  }

  if constexpr (G::FIR_IN) {
    if (warp > 4 * G::NWG) {
      // the filter warps: the input rows' chunks into their ring, XS - 1
      // ahead, then PReLU and the low-pass of the GEMM rows' samples from
      // the staged rows lr .. lr + 2, four channels at a time (output sample
      // pos + k of GEMM row lr takes taps[d] x[pos + k + d - r], zero outside
      // [0, T)), into filtered chunk c % FS once the consumers are done with
      // the chunk it held
      const int ft = threadIdx.x - G::CONSUMERS - 32;
      for (int c = 0; c < G::XS - 1; ++c) {
        stage_raw(c, ft, G::FIR_THREADS);
        cp_async_commit();
      }
      for (int c = 0; c < G::CHUNKS; ++c) {
        filter_sync<G::FIR_THREADS>();  // chunk c - 1's rows are read
        if (c + G::XS - 1 < G::CHUNKS) stage_raw(c + G::XS - 1, ft, G::FIR_THREADS);
        cp_async_commit();
        cp_async_wait<G::XS - 1>();
        filter_sync<G::FIR_THREADS>();  // chunk c's rows are in
        if (c >= G::FS) mbar_wait(fempty + 8 * (c % G::FS), (c / G::FS - 1) & 1);
        const float* const src = raw + (c % G::XS) * G::SROWS * RS;
        float* const dst = filt + (c % G::FS) * G::BM * RS;
        for (int idx = ft; idx < G::BM * G::CK / 4; idx += G::FIR_THREADS) {
          const int lr = idx / (G::CK / 4), cq = idx - lr * (G::CK / 4);
          const int pos = row_pos[lr + 1] - R;  // of window sample 0
          const bool edge = pos < 0 || pos + 3 * R > t_in;
          const int col = (cq >> 1) * R * 8 + (cq & 1) * 4;
          // each window sample u into the outputs k it reaches (tap u - k)
          float4 y[R];
#pragma unroll
          for (int k = 0; k < R; ++k) y[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < 3 * R; ++u) {
            float4 v = *reinterpret_cast<const float4*>(src + (lr + u / R) * RS + col +
                                                        (u % R) * 8);
            if (edge && (pos + u < 0 || pos + u >= t_in)) v = make_float4(0.f, 0.f, 0.f, 0.f);
            v = make_float4(prelu(v.x, alpha), prelu(v.y, alpha), prelu(v.z, alpha),
                            prelu(v.w, alpha));
#pragma unroll
            for (int k = u - 2 * R > 0 ? u - 2 * R : 0; k < R && k <= u; ++k) {
              y[k].x = fmaf(taps[u - k], v.x, y[k].x);
              y[k].y = fmaf(taps[u - k], v.y, y[k].y);
              y[k].z = fmaf(taps[u - k], v.z, y[k].z);
              y[k].w = fmaf(taps[u - k], v.w, y[k].w);
            }
          }
#pragma unroll
          for (int k = 0; k < R; ++k)
            *reinterpret_cast<float4*>(dst + lr * RS + col + k * 8) = y[k];
        }
        mbar_arrive(ffull + 8 * (c % G::FS));
      }
      return;
    }
  }

  const int tid = threadIdx.x;
  const int g = lane >> 2, q = lane & 3;  // accumulator row, column pair
  const int wg = warp >> 2, wm = wg / G::WG_N, wn = wg % G::WG_N;
  const int mrow = wm * 64 + (warp & 3) * 16;  // the warp's first local row

  float d[G::WI / 2];
#pragma unroll
  for (int i = 0; i < G::WI / 2; ++i) d[i] = 0.f;
  const uint32_t b_base = ring + wn * (G::WI / 8) * 256;  // the warpgroup's columns

  // Weight stage i: k8 steps (i % GC) KS .. of chunk i / GC.  A chunk's
  // first stage waits for its rows: staged by the consumers two chunks
  // ahead, or filtered by the filter warps, whose chunk the warp hands back
  // once it has read it.  hp and lp hold the stage before's A, which its
  // wgmmas may still read: they stay live until it is waited for.
  auto group = [&](int i, uint32_t(&hi)[KS][4], uint32_t(&lo)[KS][4], uint32_t(&hp)[KS][4],
                   uint32_t(&lp)[KS][4]) {
    const int c = i / G::GC, j = i - c * G::GC;
    if constexpr (G::FIR_IN) {
      if (j == 0) mbar_wait(ffull + 8 * (c % G::FS), (c / G::FS) & 1);
    } else if (j == 0) {
      if (c > 0) {
        cp_async_wait<1>();
        consumer_sync<G::CONSUMERS>();
      }
      if (c + 2 < G::CHUNKS) stage_raw(c + 2, tid, G::CONSUMERS);
      cp_async_commit();
    }
    const float* const src = G::FIR_IN ? filt + (c % G::FS) * G::BM * RS
                                       : raw + (c % G::XS) * G::SROWS * RS;
    // ldmatrix.x4: lanes 0-15 address the warp's rows 0-15 at k 0, 16-31 at k 4
    const uint32_t a_base = smem_u32(src + (mrow + (lane & 15)) * RS + (lane >> 4) * 4);
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      uint32_t a[4];
      ldmatrix_x4(a, a_base + (j * KS + k) * 8 * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float av = __uint_as_float(a[e]);
        if constexpr (!G::FIR_IN) av = prelu(av, alpha);
        hi[k][e] = tf32_round(__float_as_uint(av));
        lo[k][e] = __float_as_uint(av - __uint_as_float(hi[k][e]));
      }
    }
    if constexpr (G::FIR_IN) {
      if (j == G::GC - 1) {  // the chunk is read
        __syncwarp();
        if (lane == 0) mbar_arrive(fempty + 8 * (c % G::FS));
      }
    }
    const int stage = i % G::STAGES;
    mbar_wait(full + 8 * stage, (i / G::STAGES) & 1);
    const uint64_t b0 = wg_desc(b_base + stage * G::STAGE_BYTES);
    constexpr uint64_t LO = 32 * G::BN >> 4;    // lo after hi
    constexpr uint64_t STEP = 64 * G::BN >> 4;  // the next k8 step
    wg_pin(d);
    wg_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k) {  // the small terms first
      Wgmma<G::WI>::mma(d, lo[k], b0 + k * STEP);
      Wgmma<G::WI>::mma(d, hi[k], b0 + k * STEP + LO);
      Wgmma<G::WI>::mma(d, hi[k], b0 + k * STEP);
    }
    wg_commit();
    wg_wait<1>();  // the stage before has been read, and its A
    wg_keep<KS>(hp, lp);
    if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % G::STAGES));
  };

  if constexpr (!G::FIR_IN) {
    stage_raw(0, tid, G::CONSUMERS);
    cp_async_commit();
    if (G::CHUNKS > 1) stage_raw(1, tid, G::CONSUMERS);
    cp_async_commit();
    cp_async_wait<1>();
    consumer_sync<G::CONSUMERS>();
  }
  uint32_t hi0[KS][4], lo0[KS][4], hi1[KS][4], lo1[KS][4];
  int i = 0;
  for (; i + 2 <= G::NG; i += 2) {
    group(i, hi0, lo0, hi1, lo1);
    group(i + 1, hi1, lo1, hi0, lo0);
  }
  if (i < G::NG) group(i, hi0, lo0, hi1, lo1);
  wg_wait<0>();
  wg_pin(d);
  wg_keep<KS>(hi0, lo0);
  wg_keep<KS>(hi1, lo1);

  // the warpgroup's accumulator d[4 n + 2 hh + e] is local row mrow + g + 8 hh,
  // block column wn WI + 8 n + 2 q + e
  if constexpr (UP && AA) {
    // the GEMM rows' r output samples to obuf [row r + k][channel], then the
    // low-pass along time for the inner rows, plus bias
    consumer_sync<G::CONSUMERS>();  // every warpgroup is done with the rings
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
    for (int n = 0; n < G::WI / 8; ++n) {
      const int j = wn * (G::WI / 8) + n;  // the block's n8 column tile
      const int co8 = j / R, k = j - co8 * R;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int lr = mrow + g + hh * 8;
        *reinterpret_cast<float2*>(obuf + (lr * R + k) * G::OS + co8 * 8 + q * 2) =
            make_float2(d[4 * n + 2 * hh], d[4 * n + 2 * hh + 1]);
      }
    }
    consumer_sync<G::CONSUMERS>();
    const int c0 = nt * G::CN;
    for (int idx = tid; idx < G::OUT_ROWS * G::CN / 4; idx += G::CONSUMERS) {
      const int lr = 1 + idx / (G::CN / 4), cw = 4 * (idx % (G::CN / 4));
      const int grow = row0 + lr, co = c0 + cw;
      if (grow >= m_rows) continue;
      const int t = row_pos[lr];  // the row's step in its batch row
      float4 v[3 * R];
#pragma unroll
      for (int u = 0; u < 3 * R; ++u) {
        const bool valid = u < R ? t > 0 : (u < 2 * R || t + 1 < t_in);
        v[u] = valid ? *reinterpret_cast<const float4*>(obuf + ((lr - 1) * R + u) * G::OS + cw)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float4 bb = make_float4(bias[co], bias[co + 1], bias[co + 2], bias[co + 3]);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float4 y = bb;
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int dd = 0; dd <= 2 * R; ++dd) {
          f.x = fmaf(taps[dd], v[k + dd].x, f.x);
          f.y = fmaf(taps[dd], v[k + dd].y, f.y);
          f.z = fmaf(taps[dd], v[k + dd].z, f.z);
          f.w = fmaf(taps[dd], v[k + dd].w, f.w);
        }
        y.x += f.x, y.y += f.y, y.z += f.z, y.w += f.w;
        *reinterpret_cast<float4*>(out + (size_t(grow) * R + k) * COUT + co) = y;
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < G::WI / 8; ++n) {
      const int j = nt * (G::BN / 8) + wn * (G::WI / 8) + n;  // the n8 column tile
      // down: channels 8 j ..; up: sample j % r of channels 8 (j / r) ..
      const int k = UP ? j % R : 0, co = (UP ? j / R : j) * 8 + q * 2;
      const float2 bb = make_float2(bias[co], bias[co + 1]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int grow = row0 + mrow + g + hh * 8;
        if (grow >= m_rows) continue;
        *reinterpret_cast<float2*>(out + (size_t(grow) * (UP ? R : 1) + k) * COUT + co) =
            make_float2(d[4 * n + 2 * hh] + bb.x, d[4 * n + 2 * hh + 1] + bb.y);
      }
    }
  }
}

template <bool UP, int R, int CIN, bool AA>
cudaError_t launch_wgmma(const float* x, const void* w, const float* bias, const float* alpha,
                         const float* taps, float* out, int batch, int t_in,
                         cudaStream_t stream) {
  using G = RateWgGeometry<UP, R, CIN, AA>;
  auto kernel = ou_rate_change_kernel_wgmma<UP, R, CIN, AA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::SMEM));
  if (err != cudaSuccess) return err;
  const int tb = UP ? t_in : (t_in + R - 1) / R;
  const long long m_rows = (long long)batch * tb;
  const long long blocks = (m_rows + G::OUT_ROWS - 1) / G::OUT_ROWS * G::N_TILES;
  if (m_rows >= (1LL << 31) || blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), G::THREADS, G::SMEM, stream>>>(
      x, static_cast<const float*>(w), bias, alpha, taps, out, int(m_rows), tb, t_in);
  return cudaGetLastError();
}

// The fewest GEMM rows a launch of shape (UP, R, CIN) needs to take the
// wgmma core; -1 where the shape has no wgmma core.
template <bool UP, int R, int CIN> constexpr int wgmma_min_rows() {
  if constexpr (RateWgTile<UP, R, CIN>::BM > 0) return RateWgTile<UP, R, CIN>::MIN_ROWS;
  else return -1;
}

// The rate change of shape (UP, R, CIN) on core 0 (mma.sync, every shape)
// or 1 (wgmma, the table's shapes); another core is cudaErrorInvalidValue.
template <bool UP, int R, int CIN>
int launch_cin(int core, bool aa, const float* x, const void* w, const float* bias,
               const float* alpha, const float* taps, float* out, int batch, int t_in,
               cudaStream_t s) {
  constexpr int cout = UP ? CIN / 2 : 2 * CIN;
  if (core == 0)
    return aa ? launch<UP, R, true>(x, static_cast<const uint4*>(w), bias, alpha, taps, out,
                                    batch, t_in, CIN, cout, s)
              : launch<UP, R, false>(x, static_cast<const uint4*>(w), bias, alpha, taps, out,
                                     batch, t_in, CIN, cout, s);
  if constexpr (wgmma_min_rows<UP, R, CIN>() > 0)
    if (core == 1)
      return aa ? launch_wgmma<UP, R, CIN, true>(x, w, bias, alpha, taps, out, batch, t_in, s)
                : launch_wgmma<UP, R, CIN, false>(x, w, bias, alpha, taps, out, batch, t_in, s);
  return cudaErrorInvalidValue;
}

// Cin of a ConvBlock rate change: Cout = 2 Cin (down) or Cin = 2 Cout (up),
// both of the chain's widths
#define OU_DOWN_CINS(X) X(32) X(48) X(64) X(96) X(128) X(192) X(256) X(384)
#define OU_UP_CINS(X) X(64) X(96) X(128) X(192) X(256) X(384) X(512) X(768)

template <bool UP, int R>
int launch_r(int core, bool aa, int cin, const float* x, const void* w, const float* bias,
             const float* alpha, const float* taps, float* out, int batch, int t_in,
             cudaStream_t s) {
#define OU_CASE(C) \
  case C:          \
    return launch_cin<UP, R, C>(core, aa, x, w, bias, alpha, taps, out, batch, t_in, s);
  if constexpr (UP) {
    switch (cin) { OU_UP_CINS(OU_CASE) default: return cudaErrorInvalidValue; }
  } else {
    switch (cin) { OU_DOWN_CINS(OU_CASE) default: return cudaErrorInvalidValue; }
  }
#undef OU_CASE
}

template <bool UP, int R> int min_rows_r(int cin) {
#define OU_CASE(C) \
  case C:          \
    return wgmma_min_rows<UP, R, C>();
  if constexpr (UP) {
    switch (cin) { OU_UP_CINS(OU_CASE) default: return -1; }
  } else {
    switch (cin) { OU_DOWN_CINS(OU_CASE) default: return -1; }
  }
#undef OU_CASE
}

#define OU_RATES(X) X(2) X(3) X(4) X(5) X(8)

}  // namespace

extern "C" {

// x (B, T, Cin) float32; w in the layout of the core
// (ops/kernels/rate_change.py::kernel_weights); bias (Cout,); alpha one
// float32 slope; taps the 2r + 1 low-pass taps, or null for none; out (B,
// ceil(T/r), Cout) (down) or (B, T r, Cout) (up); core 0 (mma.sync) or 1
// (wgmma): ou_rate_change_f32_min_rows says which a launch takes and whether
// the shape has wgmma.  Returns the cudaError_t of the launch (0 on success); the
// wrapper checks shapes.
int ou_rate_change_f32(const void* x, const void* w, const void* bias, const void* alpha,
                       const void* taps, void* out, int batch, int t_in, int cin,
                       int cout, int r, int up, void* stream, int core) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(bias);
  const float* af = static_cast<const float*>(alpha);
  const float* tf = static_cast<const float*>(taps);
  float* of = static_cast<float*>(out);
  const bool aa = taps != nullptr;
  if (cout != (up ? cin / 2 : 2 * cin)) return cudaErrorInvalidValue;
#define OU_CASE(RR)                                                                        \
  case RR:                                                                                 \
    return up ? launch_r<true, RR>(core, aa, cin, xf, w, bf, af, tf, of, batch, t_in, s)   \
              : launch_r<false, RR>(core, aa, cin, xf, w, bf, af, tf, of, batch, t_in, s);
  switch (r) {
    OU_RATES(OU_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef OU_CASE
}

// The table's core for a rate change: a launch of `rows` GEMM rows (B
// ceil(T/r) down, B T up) takes wgmma where 0 < MIN_ROWS <= rows, else
// mma.sync.  Returns MIN_ROWS, -1 where the shape has no wgmma core.
int ou_rate_change_f32_min_rows(int up, int r, int cin) {
#define OU_CASE(RR) \
  case RR:          \
    return up ? min_rows_r<true, RR>(cin) : min_rows_r<false, RR>(cin);
  switch (r) {
    OU_RATES(OU_CASE)
    default: return -1;
  }
#undef OU_CASE
}

}  // extern "C"
