// UNIVERSE ConvBlock rate change on Hopper's tensor cores (sm_90a), float32
// as 3xTF32 on mma.sync m16n8k8.
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
// which says why it holds the float32 gate), and on mma.sync the blocks
// from C = 64 up are bound by those products: variants that cut the
// split's and PReLU's instructions ran no faster on the card (PERF.md).
//
// Design.  One block of 8 warps computes BM GEMM rows x CN output channels
// (up: CN channels of each of the r output samples).  The reduction runs in
// chunks of CK input channels (down: of each of the r input samples of a
// row).  Each chunk, with the weight fragments of its k-steps, is copied to
// shared memory by cp.async, zero-filled outside the rows and samples that
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
// The tile table was picked by timing variants side by side on the H100 at
// the batch-128 shapes of the 16 kHz presets (PERF.md).
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

template <int R>
cudaError_t launch_r(bool up, bool aa, const float* x, const uint4* w, const float* bias,
                     const float* alpha, const float* taps, float* out, int batch,
                     int t_in, int cin, int cout, cudaStream_t s) {
  if (up)
    return aa ? launch<true, R, true>(x, w, bias, alpha, taps, out, batch, t_in, cin, cout, s)
              : launch<true, R, false>(x, w, bias, alpha, taps, out, batch, t_in, cin, cout, s);
  return aa ? launch<false, R, true>(x, w, bias, alpha, taps, out, batch, t_in, cin, cout, s)
            : launch<false, R, false>(x, w, bias, alpha, taps, out, batch, t_in, cin, cout, s);
}

}  // namespace

extern "C" {

// x (B, T, Cin) float32; w in the fragment order of
// ops/kernels/rate_change.py::kernel_weights; bias (Cout,); alpha one float32
// slope; taps the 2r + 1 low-pass taps, or null for none; out (B, ceil(T/r),
// Cout) (down) or (B, T r, Cout) (up).  Returns the cudaError_t of the launch
// (0 on success); the wrapper checks shapes.
int ou_rate_change_f32(const void* x, const void* w, const void* bias, const void* alpha,
                       const void* taps, void* out, int batch, int t_in, int cin,
                       int cout, int r, int up, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const uint4* wf = static_cast<const uint4*>(w);
  const float* bf = static_cast<const float*>(bias);
  const float* af = static_cast<const float*>(alpha);
  const float* tf = static_cast<const float*>(taps);
  float* of = static_cast<float*>(out);
  const bool aa = taps != nullptr;
  switch (r) {
    case 2: return launch_r<2>(up, aa, xf, wf, bf, af, tf, of, batch, t_in, cin, cout, s);
    case 3: return launch_r<3>(up, aa, xf, wf, bf, af, tf, of, batch, t_in, cin, cout, s);
    case 4: return launch_r<4>(up, aa, xf, wf, bf, af, tf, of, batch, t_in, cin, cout, s);
    case 5: return launch_r<5>(up, aa, xf, wf, bf, af, tf, of, batch, t_in, cin, cout, s);
    case 8: return launch_r<8>(up, aa, xf, wf, bf, af, tf, of, batch, t_in, cin, cout, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
