// Fused UNIVERSE ConvBlock conv chain on Hopper's tensor cores, bf16
// (sm_90a).
//
// Replaces, for bf16 storage, the Pallas TPU kernel
// open_universe_tpu/ops/pallas/conv_block.py (fused_conv_chain /
// fused_conv_chain_rows, body `_kernel`); float32 runs on the CUDA cores in
// conv_block.cu.  For h (B, T, C) it computes what conv_block.cu computes,
// with the same rounding points (to bf16 after FiLM, after each PReLU
// product, after conv3a, and on output; f32 sums; f32 PReLU slopes):
//
//   cond_out = conv5(prelu1(h)) + b5
//   c        = cond_out [+ input_cond then * sqrt(1/2)]
//   c        = gamma * c + beta                      (FiLM, if given)
//   c        = conv3a(prelu2(c)) + b3a
//   v        = (h + conv3b(prelu3(c)) + b3b) * sqrt(1/2)
//
// What bounds it on the H100.  The chain does 22*B*T*C^2 FLOPs and must move
// 3*B*T*C bf16 values (h, v, cond_out), 4*B*T*C with input_cond: 2.8*C to
// 3.7*C FLOPs per byte.  Against the bf16 tensor cores' balance (989 TFLOP/s
// over 3.35 TB/s, ~295 FLOP/byte) C = 32..64 are bound by bytes and
// C >= 96 by operations.
//
// Design.  Each conv is an implicit GEMM, out[t, co] = sum_k sum_ci
// x[t + k - K/2, ci] * w[k, ci, co]: M is time, N is C_out, the reduction is
// K * C_in, and the A operand of tap k is the activation tile shifted by k
// rows.  One block of 8 warps per (batch row, tile of TT = BM - 4 output
// steps).  The block stages prelu1(h) for t0-4 .. t0+BM+3 in shared memory;
// conv5 runs over BM rows (t0-2 ..) into a second buffer, with cond, FiLM
// and prelu2 applied to the f32 accumulators in its epilogue (cond_out is
// written from there too); conv3a runs over BM rows (t0-1 ..) back into the
// first buffer; conv3b over BM rows (t0 ..) straight to v.  The valid rows
// shrink by the halo at each conv instead of each conv being padded, so a
// block does three BM-row GEMMs for BM - 4 outputs.  Intermediates are zero
// outside [0, T), so any T >= 1 works.  Both buffers hold bf16: the chain
// rounds to bf16 at every point where they are written, so this changes no
// value and halves the shared memory of f32 buffers.
//
// Each warp computes 64 x WN tiles with mma.sync.m16n8k16 (bf16 in, f32
// accumulate).  A comes from shared memory by ldmatrix, which takes any row
// offset, so the tap shift costs nothing; rows are padded by 16 bytes so the
// eight rows of an ldmatrix fall on distinct banks.  B (the weights) is read
// from L2 (and L1, where warps of a block share columns) in a fragment-ordered
// copy that the wrapper makes once per weight tensor
// (ops/kernels/conv_block.py::mma_weights): one 16-byte load per lane feeds
// two n8 tiles, prefetched one k-step ahead.  No shared memory holds
// weights, so it all goes to the activations, and C = 768 still fits 64-row
// tiles (223 KB) without a cluster.  With 64-row warp tiles every weight
// byte read brings 64 FLOPs.  Why mma.sync and not wgmma: wgmma takes B only
// from shared memory, through descriptors whose layouts cannot be checked
// without the card; staging a weight ring there would cost the room that
// the two activation buffers need at C >= 384.  PERF.md records what wgmma
// would add.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kSqrtHalf = 0.70710678118654752440f;

// BM: rows of each conv GEMM (a multiple of the 64-row warp tile); WN:
// output channels per warp tile; BLOCKS: blocks per SM the registers are
// capped for.  Picked per width by timing tables side by side on the H100
// at the main path's shapes (ops/kernels/tile_probe.py, PERF.md): several
// blocks of narrow tiles where they fit, one block of wider tiles at
// C >= 384, where the shared memory and the L2 weight stream decide.
template <int C> struct Tile;
template <> struct Tile<32> { static constexpr int BM = 512, WN = 32, BLOCKS = 1; };
template <> struct Tile<48> { static constexpr int BM = 256, WN = 16, BLOCKS = 3; };
template <> struct Tile<64> { static constexpr int BM = 256, WN = 32, BLOCKS = 2; };
template <> struct Tile<96> { static constexpr int BM = 128, WN = 32, BLOCKS = 2; };
template <> struct Tile<128> { static constexpr int BM = 128, WN = 32, BLOCKS = 2; };
template <> struct Tile<192> { static constexpr int BM = 64, WN = 32, BLOCKS = 2; };
template <> struct Tile<256> { static constexpr int BM = 64, WN = 32, BLOCKS = 2; };
template <> struct Tile<384> { static constexpr int BM = 64, WN = 48, BLOCKS = 1; };
template <> struct Tile<512> { static constexpr int BM = 64, WN = 64, BLOCKS = 1; };
template <> struct Tile<768> { static constexpr int BM = 64, WN = 48, BLOCKS = 1; };

template <int C> struct Geometry {
  static constexpr int BM = Tile<C>::BM;
  static constexpr int WN = Tile<C>::WN;
  static constexpr int TT = BM - 4;        // output steps per block
  static constexpr int ROWS = BM + 8;      // rows of each activation buffer
  static constexpr int LDS = C + 8;        // buffer row stride in bf16
  static constexpr int NT = C / WN;        // warp tiles across the channels
  static constexpr int TILES = (BM / 64) * NT;
  static constexpr int KB = C / 16;        // k16 steps per tap
  static constexpr int NJ = WN / 16;       // 16-column B fragments per tile
  static constexpr size_t SMEM = size_t(2) * ROWS * LDS * sizeof(bf16);
  static_assert(C % WN == 0 && WN % 16 == 0 && BM % 64 == 0, "tile shape");
  static_assert(SMEM <= 232448, "two buffers exceed a block's shared memory");
};

__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// PReLU of a bf16 value; the negative branch's product is rounded to bf16
__device__ __forceinline__ float prelu(float x, float a) {
  return x >= 0.f ? x : rnd(a * x);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return make_float2(__bfloat162float(p[0]), __bfloat162float(p[1]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i][n] = the m16n8 accumulator of rows m0 + 16 i .., columns
// n0 + 8 n ..: sum over taps k and input channels of in[r + k][ci] *
// w[k][ci][co].  w is the fragment-ordered weight copy: the 16-byte
// fragment of step s = k * C/16 + ci/16 and 16-column block nb is
// w[(s * C/16 + nb) * 32 + lane].
template <int C, int K>
__device__ __forceinline__ void conv_tile(const bf16* in, const uint4* __restrict__ w,
                                          int m0, int n0, int lane,
                                          float (&acc)[4][Geometry<C>::WN / 8][4]) {
  using G = Geometry<C>;
  constexpr int S = K * G::KB;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < G::WN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  // ldmatrix.x4: lanes 0-15 address rows 0-15 at k 0, lanes 16-31 at k 8
  const uint32_t a_base =
      smem_u32(in + (m0 + (lane & 15)) * G::LDS + (lane >> 4) * 8);
  const uint4* wl = w + (n0 / 16) * 32 + lane;
  uint4 b[G::NJ];
#pragma unroll
  for (int j = 0; j < G::NJ; ++j) b[j] = __ldg(wl + j * 32);
#pragma unroll 2
  for (int s = 0; s < S; ++s) {
    const int tap = s / G::KB, kb = s - tap * G::KB;
    const int sn = s + 1 < S ? s + 1 : s;
    uint4 bn[G::NJ];
#pragma unroll
    for (int j = 0; j < G::NJ; ++j)
      bn[j] = __ldg(wl + (size_t(sn) * (C / 16) + j) * 32);
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ldmatrix_x4(a[i], a_base + ((i * 16 + tap) * G::LDS + kb * 16) * 2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < G::NJ; ++j) {
        mma(acc[i][2 * j], a[i], b[j].x, b[j].y);
        mma(acc[i][2 * j + 1], a[i], b[j].z, b[j].w);
      }
#pragma unroll
    for (int j = 0; j < G::NJ; ++j) b[j] = bn[j];
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, Tile<C>::BLOCKS)
conv_block_tc_kernel(const bf16* __restrict__ h, const uint4* __restrict__ w5,
                     const bf16* __restrict__ b5, const float* __restrict__ a1p,
                     const uint4* __restrict__ w3a, const bf16* __restrict__ b3a,
                     const float* __restrict__ a2p, const uint4* __restrict__ w3b,
                     const bf16* __restrict__ b3b, const float* __restrict__ a3p,
                     const bf16* __restrict__ film, const bf16* __restrict__ cond,
                     bf16* __restrict__ v_out, bf16* __restrict__ cond_out,
                     int t_len) {
  using G = Geometry<C>;
  constexpr int NN = G::WN / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* buf_a = reinterpret_cast<bf16*>(smem_u4);  // ROWS x LDS
  bf16* buf_b = buf_a + G::ROWS * G::LDS;          // ROWS x LDS

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * G::TT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;  // accumulator row, column pair
  const float a1 = a1p[0], a2 = a2p[0], a3 = a3p[0];
  const bf16* hb = h + size_t(b) * t_len * C;
  const bf16* cb = cond ? cond + size_t(b) * t_len * C : nullptr;
  bf16* vb = v_out + size_t(b) * t_len * C;
  bf16* ob = cond_out + size_t(b) * t_len * C;

  // stage prelu1(h) for t = t0 - 4 + r, zero outside [0, T); zero buf_b's
  // rows past BM, which the last rows of conv3a read
  constexpr int CH = C / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < G::ROWS * CH; idx += kThreads) {
    const int r = idx / CH, ch = idx - r * CH;
    const int t = t0 - 4 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < t_len) {
      x = __ldg(reinterpret_cast<const uint4*>(hb + size_t(t) * C) + ch);
      uint32_t* u = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack2(u[e]);
        u[e] = pack2(prelu(f.x, a1), prelu(f.y, a1));
      }
    }
    *reinterpret_cast<uint4*>(buf_a + r * G::LDS + ch * 8) = x;
    if (r >= G::BM)
      *reinterpret_cast<uint4*>(buf_b + r * G::LDS + ch * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // conv5: row j <-> t = t0 - 2 + j, into buf_b
  for (int tile = warp; tile < G::TILES; tile += kWarps) {
    const int m0 = (tile / G::NT) * 64, n0 = (tile % G::NT) * G::WN;
    float acc[4][NN][4];
    conv_tile<C, 5>(buf_a, w5, m0, n0, lane, acc);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n0 + n * 8 + q * 2;
      const float2 bias = load2(b5 + col);
      float2 gam = make_float2(1.f, 1.f), bet = make_float2(0.f, 0.f);
      if (film) {
        gam = load2(film + size_t(b) * 2 * C + col);
        bet = load2(film + size_t(b) * 2 * C + C + col);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = m0 + i * 16 + g + hh * 8;
          const int t = t0 - 2 + j;
          const bool valid = t >= 0 && t < t_len;
          float y0 = acc[i][n][2 * hh] + bias.x;
          float y1 = acc[i][n][2 * hh + 1] + bias.y;
          if (valid && j >= 2 && j < G::TT + 2)
            *reinterpret_cast<uint32_t*>(ob + size_t(t) * C + col) = pack2(y0, y1);
          if (cb) {
            float2 ic = make_float2(0.f, 0.f);
            if (valid) ic = unpack2(*reinterpret_cast<const uint32_t*>(cb + size_t(t) * C + col));
            y0 = (y0 + ic.x) * kSqrtHalf;
            y1 = (y1 + ic.y) * kSqrtHalf;
          }
          y0 = gam.x * y0 + bet.x;
          y1 = gam.y * y1 + bet.y;
          y0 = valid ? rnd(y0) : 0.f;
          y1 = valid ? rnd(y1) : 0.f;
          *reinterpret_cast<uint32_t*>(buf_b + j * G::LDS + col) =
              pack2(prelu(y0, a2), prelu(y1, a2));
        }
    }
  }
  __syncthreads();

  // conv3a: row j <-> t = t0 - 1 + j, into buf_a
  for (int tile = warp; tile < G::TILES; tile += kWarps) {
    const int m0 = (tile / G::NT) * 64, n0 = (tile % G::NT) * G::WN;
    float acc[4][NN][4];
    conv_tile<C, 3>(buf_b, w3a, m0, n0, lane, acc);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n0 + n * 8 + q * 2;
      const float2 bias = load2(b3a + col);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = m0 + i * 16 + g + hh * 8;
          const int t = t0 - 1 + j;
          const bool valid = t >= 0 && t < t_len;
          const float y0 = valid ? rnd(acc[i][n][2 * hh] + bias.x) : 0.f;
          const float y1 = valid ? rnd(acc[i][n][2 * hh + 1] + bias.y) : 0.f;
          *reinterpret_cast<uint32_t*>(buf_a + j * G::LDS + col) =
              pack2(prelu(y0, a3), prelu(y1, a3));
        }
    }
  }
  __syncthreads();

  // conv3b + residual: row j <-> t = t0 + j, the block's TT outputs
  for (int tile = warp; tile < G::TILES; tile += kWarps) {
    const int m0 = (tile / G::NT) * 64, n0 = (tile % G::NT) * G::WN;
    float acc[4][NN][4];
    conv_tile<C, 3>(buf_a, w3b, m0, n0, lane, acc);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n0 + n * 8 + q * 2;
      const float2 bias = load2(b3b + col);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = m0 + i * 16 + g + hh * 8;
          const int t = t0 + j;
          if (j >= G::TT || t >= t_len) continue;
          const float2 x = unpack2(*reinterpret_cast<const uint32_t*>(hb + size_t(t) * C + col));
          const float y0 = (x.x + (acc[i][n][2 * hh] + bias.x)) * kSqrtHalf;
          const float y1 = (x.y + (acc[i][n][2 * hh + 1] + bias.y)) * kSqrtHalf;
          *reinterpret_cast<uint32_t*>(vb + size_t(t) * C + col) = pack2(y0, y1);
        }
    }
  }
}

template <int C>
cudaError_t launch(const void* h, const void* w5, const void* b5, const void* a1,
                   const void* w3a, const void* b3a, const void* a2,
                   const void* w3b, const void* b3b, const void* a3,
                   const void* film, const void* cond, void* v, void* cond_out,
                   int batch, int t_len, cudaStream_t stream) {
  using G = Geometry<C>;
  auto kernel = conv_block_tc_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::SMEM));
  if (err != cudaSuccess) return err;
  dim3 grid((t_len + G::TT - 1) / G::TT, batch);
  kernel<<<grid, kThreads, G::SMEM, stream>>>(
      static_cast<const bf16*>(h), static_cast<const uint4*>(w5),
      static_cast<const bf16*>(b5), static_cast<const float*>(a1),
      static_cast<const uint4*>(w3a), static_cast<const bf16*>(b3a),
      static_cast<const float*>(a2), static_cast<const uint4*>(w3b),
      static_cast<const bf16*>(b3b), static_cast<const float*>(a3),
      static_cast<const bf16*>(film), static_cast<const bf16*>(cond),
      static_cast<bf16*>(v), static_cast<bf16*>(cond_out), t_len);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every tensor is bf16 but the slopes a1..a3 (float32); w5, w3a and w3b are
// in the fragment order of ops/kernels/conv_block.py::mma_weights.  film
// and cond may be null.  Returns the cudaError_t of the launch (0 on
// success); the wrapper checks shapes.
int ou_conv_block_tc(const void* h, const void* w5, const void* b5,
                     const void* a1, const void* w3a, const void* b3a,
                     const void* a2, const void* w3b, const void* b3b,
                     const void* a3, const void* film, const void* cond,
                     void* v, void* cond_out, int batch, int t_len, int c,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OU_CASE(CC)                                                           \
  case CC:                                                                    \
    return launch<CC>(h, w5, b5, a1, w3a, b3a, a2, w3b, b3b, a3, film, cond, \
                      v, cond_out, batch, t_len, s);
  switch (c) {
    OU_CASE(32) OU_CASE(48) OU_CASE(64) OU_CASE(96) OU_CASE(128)
    OU_CASE(192) OU_CASE(256) OU_CASE(384) OU_CASE(512) OU_CASE(768)
    default:
      return cudaErrorInvalidValue;
  }
#undef OU_CASE
}

}  // extern "C"
