// Fused UNIVERSE ConvBlock conv chain on Hopper's tensor cores (sm_90a), in
// two precisions: bf16 (mma.sync m16n8k16) and float32 (3xTF32 on
// mma.sync m16n8k8).
//
// Replaces the Pallas TPU kernel open_universe_tpu/ops/pallas/conv_block.py
// (fused_conv_chain / fused_conv_chain_rows, body `_kernel`).  For h
// (B, T, C) it computes, with the TPU kernel's rounding points (to the
// storage type after FiLM, after each PReLU product, after conv3a, and on
// output; f32 sums; f32 PReLU slopes), which are exact in f32:
//
//   cond_out = conv5(prelu1(h)) + b5
//   c        = cond_out [+ input_cond then * sqrt(1/2)]
//   c        = gamma * c + beta                      (FiLM, if given)
//   c        = conv3a(prelu2(c)) + b3a
//   v        = (h + conv3b(prelu3(c)) + b3b) * sqrt(1/2)
//
// What bounds it on the H100.  The chain does 22*B*T*C^2 FLOPs and must move
// 3*B*T*C values (h, v, cond_out), 4*B*T*C with input_cond.  bf16: 2.8*C to
// 3.7*C FLOPs per byte against the tensor cores' balance (989 TFLOP/s over
// 3.35 TB/s, ~295 FLOP/byte): C = 32..64 are bound by bytes, C >= 96 by
// operations.  f32: each product is three TF32 products (below), so the
// card gives 495 / 3 = 165 TFLOP/s of f32-accurate work against 3.35 TB/s
// (~49 FLOP/byte) for 1.4*C to 1.8*C FLOPs per byte: C = 32 is bound by
// bytes, C >= 48 by operations.
//
// Why 3xTF32 holds the f32 gate (1e-4 max|ref| against the plain version).
// One TF32 product keeps 11 significant bits of each operand (~5e-4
// relative), which breaks it.  Split each operand x = hi + lo with
// hi = tf32(x) (round to nearest, ties away, as cvt.rna does) and lo the
// TF32 part of x - hi, and sum a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in f32:
// each TF32 product is exact in f32, hi + lo keeps ~21-22 bits of x, and
// the dropped a_lo*b_lo is ~2^-22 of the product, far inside 1e-4.  The
// weights are split once per weight tensor by the wrapper
// (ops/kernels/conv_block.py::mma_weights, lo rounded to nearest).  The
// activations are split in registers once per k-step, the split reused
// across the warp's n8 tiles, in two integer operations and one subtraction
// (hi = (x + 0x1000) & ~0x1fff on the bits, lo = x - hi, whose low 13 bits
// the tensor core ignores): the kernel is bound by issuing instructions,
// and this was faster than two cvt.rna on the card (PERF.md).  A NaN keeps
// propagating through lo.  On the card the measured error against the plain
// version (1.3e-6 of max|ref| at C = 32 to 2.4e-5 at C = 768) grows with
// the reduction length: it comes from the tensor core's f32 accumulation,
// not from the split.
//
// Design.  Each conv is an implicit GEMM, out[t, co] = sum_k sum_ci
// x[t + k - K/2, ci] * w[k, ci, co]: M is time, N is C_out, the reduction is
// K * C_in, and the A operand of tap k is the activation tile shifted by k
// rows.  One block of 8 warps per (batch row, tile of TT = BM - 4 output
// steps).  The block stages prelu1(h) for t0-4 .. t0+BM-1 in shared memory;
// conv5 runs over BM rows (t0-2 ..) into a second buffer, with cond, FiLM
// and prelu2 applied to the f32 accumulators in its epilogue (cond_out is
// written from there too); conv3a runs over BM rows (t0-1 ..) back into the
// first buffer; conv3b over BM rows (t0 ..) straight to v.  The valid rows
// shrink by the halo at each conv instead of each conv being padded, so a
// block does three BM-row GEMMs for BM - 4 outputs; each buffer holds only
// the rows its conv reads (BM + 4 and BM + 2).  Intermediates are zero
// outside [0, T), so any T >= 1 works.  The buffers hold the storage type:
// the chain rounds to it at every point where they are written, so this
// changes no value (f32 buffers hold full f32).
//
// Each warp computes WM x WN tiles (WM = 64 rows, or BM where BM = 32).
// A comes from shared memory by ldmatrix, which takes any row offset, so
// the tap shift costs nothing; rows are padded by 16 bytes so the eight rows
// of an ldmatrix fall on distinct banks.  For f32, ldmatrix.m8n8.x4.b16
// reads each 8x8 b16 matrix as 8 rows x 4 floats, which is exactly
// m16n8k8's TF32 A fragment.  B (the weights) is read from L2 (and L1,
// where warps of a block share columns) in a fragment-ordered copy that the
// wrapper makes once per weight tensor: one 16-byte load per lane feeds two
// n8 tiles of a k16 step (bf16) or one n8 tile of a k8 step with its hi and
// lo halves (f32), prefetched one k-step ahead.  No shared memory holds
// weights, so it all goes to the activations.  Shared memory is
// (2 BM + 6) rows of C + 16 bytes: bf16 keeps 64-row tiles up to C = 768
// (208 KB); f32 at C >= 512 takes BM = 32 (C = 768: 216 KB), which does
// three 32-row GEMMs for 28 outputs (the halo wastes 1/8 of the operations
// there, 1/16 at BM = 64).  Why mma.sync and not wgmma: wgmma takes B only
// from shared memory, through descriptors whose layouts cannot be checked
// without the card; staging a weight ring there would cost the room that
// the two activation buffers need.  PERF.md records what wgmma would add.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kSqrtHalf = 0.70710678118654752440f;

// Precision policies: the storage type, and the output channels one
// 16-byte weight load per lane feeds (NB).
struct Bf16 {
  using T = bf16;
  static constexpr int NB = 16;
};
struct F32 {
  using T = float;
  static constexpr int NB = 8;
};

// BM: rows of each conv GEMM; WN: output channels per warp tile; BLOCKS:
// blocks per SM the registers are capped for.  Picked per width by timing
// tables side by side on the H100 at the main path's shapes
// (ops/kernels/tile_probe.py, PERF.md).
template <class P, int C> struct Tile;
template <> struct Tile<Bf16, 32> { static constexpr int BM = 512, WN = 32, BLOCKS = 1; };
template <> struct Tile<Bf16, 48> { static constexpr int BM = 256, WN = 16, BLOCKS = 3; };
template <> struct Tile<Bf16, 64> { static constexpr int BM = 256, WN = 32, BLOCKS = 2; };
template <> struct Tile<Bf16, 96> { static constexpr int BM = 128, WN = 32, BLOCKS = 2; };
template <> struct Tile<Bf16, 128> { static constexpr int BM = 128, WN = 32, BLOCKS = 2; };
template <> struct Tile<Bf16, 192> { static constexpr int BM = 64, WN = 32, BLOCKS = 2; };
template <> struct Tile<Bf16, 256> { static constexpr int BM = 64, WN = 32, BLOCKS = 2; };
template <> struct Tile<Bf16, 384> { static constexpr int BM = 64, WN = 48, BLOCKS = 1; };
template <> struct Tile<Bf16, 512> { static constexpr int BM = 64, WN = 64, BLOCKS = 1; };
template <> struct Tile<Bf16, 768> { static constexpr int BM = 64, WN = 48, BLOCKS = 1; };
template <> struct Tile<F32, 32> { static constexpr int BM = 256, WN = 16, BLOCKS = 2; };
template <> struct Tile<F32, 48> { static constexpr int BM = 256, WN = 24, BLOCKS = 2; };
template <> struct Tile<F32, 64> { static constexpr int BM = 128, WN = 16, BLOCKS = 2; };
template <> struct Tile<F32, 96> { static constexpr int BM = 128, WN = 24, BLOCKS = 2; };
template <> struct Tile<F32, 128> { static constexpr int BM = 64, WN = 16, BLOCKS = 2; };
template <> struct Tile<F32, 192> { static constexpr int BM = 64, WN = 24, BLOCKS = 2; };
template <> struct Tile<F32, 256> { static constexpr int BM = 64, WN = 32, BLOCKS = 1; };
template <> struct Tile<F32, 384> { static constexpr int BM = 64, WN = 48, BLOCKS = 1; };
template <> struct Tile<F32, 512> { static constexpr int BM = 32, WN = 64, BLOCKS = 1; };
template <> struct Tile<F32, 768> { static constexpr int BM = 32, WN = 96, BLOCKS = 1; };

template <class P, int C_> struct Geometry {
  using T = typename P::T;
  static constexpr int C = C_;
  static constexpr int BM = Tile<P, C>::BM;
  static constexpr int WM = BM < 64 ? BM : 64;    // rows per warp tile
  static constexpr int WN = Tile<P, C>::WN;
  static constexpr int TT = BM - 4;                // output steps per block
  static constexpr int ROWS_A = BM + 4;            // conv5 reads rows .. BM + 3
  static constexpr int ROWS_B = BM + 2;            // conv3a reads rows .. BM + 1
  static constexpr int LDS = C + 16 / int(sizeof(T));  // buffer row stride
  static constexpr int NT = C / WN;                // warp tiles across the channels
  static constexpr int TILES = (BM / WM) * NT;
  static constexpr int MI = WM / 16;               // m16 tiles per warp tile
  static constexpr int NN = WN / 8;                // n8 tiles per warp tile
  static constexpr size_t SMEM = size_t(ROWS_A + ROWS_B) * LDS * sizeof(T);
  static_assert(C % WN == 0 && WN % P::NB == 0 && BM % WM == 0 && WM % 16 == 0,
                "tile shape");
  static_assert(SMEM <= 232448, "two buffers exceed a block's shared memory");
};

// round a float to the storage type and back
__device__ __forceinline__ float rnd(Bf16, float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float rnd(F32, float x) { return x; }

// PReLU of a value held at storage precision; the negative branch's product
// is rounded to the storage type
template <class P> __device__ __forceinline__ float prelu(float x, float a) {
  return x >= 0.f ? x : rnd(P{}, a * x);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// two neighbouring values: ld2 as two scalar loads (biases, FiLM), ld2v
// and st2 as one vector access (4- or 8-byte aligned)
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return make_float2(__bfloat162float(p[0]), __bfloat162float(p[1]));
}
__device__ __forceinline__ float2 ld2(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 ld2v(const bf16* p) {
  return unpack2(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ float2 ld2v(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(bf16* p, float y0, float y1) {
  *reinterpret_cast<uint32_t*>(p) = pack2(y0, y1);
}
__device__ __forceinline__ void st2(float* p, float y0, float y1) {
  *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
}

// prelu of each value of a 16-byte chunk of storage
__device__ __forceinline__ uint4 prelu16(Bf16, uint4 x, float a) {
  uint32_t* u = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = unpack2(u[e]);
    u[e] = pack2(prelu<Bf16>(f.x, a), prelu<Bf16>(f.y, a));
  }
  return x;
}
__device__ __forceinline__ uint4 prelu16(F32, uint4 x, float a) {
  float* f = reinterpret_cast<float*>(&x);
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = prelu<F32>(f[e], a);
  return x;
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

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the f32 bits x rounded to TF32 (round to nearest, ties away from zero,
// as cvt.rna.tf32.f32 rounds a finite value): its 13 low mantissa bits zero
__device__ __forceinline__ uint32_t tf32_round(uint32_t x) {
  return (x + 0x1000u) & 0xFFFFE000u;
}

// acc[i][n] = the m16n8 accumulator of rows m0 + 16 i .., columns
// n0 + 8 n ..: sum over taps k and input channels of in[r + k][ci] *
// w[k][ci][co].  bf16: w is mma_weights' fragment order, the 16-byte
// fragment of step s = k * C/16 + ci/16 and 16-column block nb is
// w[(s * C/16 + nb) * 32 + lane].
template <class G, int K>
__device__ __forceinline__ void conv_tile(Bf16, const bf16* in, const uint4* __restrict__ w,
                                          int m0, int n0, int lane,
                                          float (&acc)[G::MI][G::NN][4]) {
  constexpr int KB = G::C / 16;  // k16 steps per tap
  constexpr int S = K * KB;
  constexpr int NJ = G::WN / 16;
#pragma unroll
  for (int i = 0; i < G::MI; ++i)
#pragma unroll
    for (int n = 0; n < G::NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  // ldmatrix.x4: lanes 0-15 address rows 0-15 at k 0, lanes 16-31 at k 8
  const uint32_t a_base =
      smem_u32(in + (m0 + (lane & 15)) * G::LDS + (lane >> 4) * 8);
  const uint4* wl = w + (n0 / 16) * 32 + lane;
  uint4 b[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) b[j] = __ldg(wl + j * 32);
#pragma unroll 2
  for (int s = 0; s < S; ++s) {
    const int tap = s / KB, kb = s - tap * KB;
    const int sn = s + 1 < S ? s + 1 : s;
    uint4 bn[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      bn[j] = __ldg(wl + (size_t(sn) * (G::C / 16) + j) * 32);
    uint32_t a[G::MI][4];
#pragma unroll
    for (int i = 0; i < G::MI; ++i)
      ldmatrix_x4(a[i], a_base + ((i * 16 + tap) * G::LDS + kb * 16) * 2);
#pragma unroll
    for (int i = 0; i < G::MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mma(acc[i][2 * j], a[i], b[j].x, b[j].y);
        mma(acc[i][2 * j + 1], a[i], b[j].z, b[j].w);
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = bn[j];
  }
}

// f32, 3xTF32: w is mma_weights' split fragment order, the 16-byte
// fragment {hi(b0), hi(b1), lo(b0), lo(b1)} of step s = k * C/8 + ci/8 and
// n8 tile nb is w[(s * C/8 + nb) * 32 + lane].  ldmatrix.x4 gives lane
// 4g + q the floats (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4) of the
// 16 x 8 tile: m16n8k8's A fragment.
template <class G, int K>
__device__ __forceinline__ void conv_tile(F32, const float* in, const uint4* __restrict__ w,
                                          int m0, int n0, int lane,
                                          float (&acc)[G::MI][G::NN][4]) {
  constexpr int KB = G::C / 8;  // k8 steps per tap
  constexpr int S = K * KB;
#pragma unroll
  for (int i = 0; i < G::MI; ++i)
#pragma unroll
    for (int n = 0; n < G::NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  // ldmatrix.x4: lanes 0-15 address rows 0-15 at k 0, lanes 16-31 at k 4
  const uint32_t a_base =
      smem_u32(in + (m0 + (lane & 15)) * G::LDS + (lane >> 4) * 4);
  const uint4* wl = w + (n0 / 8) * 32 + lane;
  uint4 b[G::NN];
#pragma unroll
  for (int j = 0; j < G::NN; ++j) b[j] = __ldg(wl + j * 32);
#pragma unroll 2
  for (int s = 0; s < S; ++s) {
    const int tap = s / KB, kb = s - tap * KB;
    const int sn = s + 1 < S ? s + 1 : s;
    uint4 bn[G::NN];
#pragma unroll
    for (int j = 0; j < G::NN; ++j)
      bn[j] = __ldg(wl + (size_t(sn) * KB + j) * 32);
    uint32_t a[G::MI][4];
#pragma unroll
    for (int i = 0; i < G::MI; ++i)
      ldmatrix_x4(a[i], a_base + ((i * 16 + tap) * G::LDS + kb * 8) * 4);
#pragma unroll
    for (int i = 0; i < G::MI; ++i) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = tf32_round(a[i][e]);
        lo[e] = __float_as_uint(__uint_as_float(a[i][e]) - __uint_as_float(hi[e]));
      }
#pragma unroll
      for (int j = 0; j < G::NN; ++j) {  // the small terms first
        mma_tf32(acc[i][j], lo, b[j].x, b[j].y);
        mma_tf32(acc[i][j], hi, b[j].z, b[j].w);
        mma_tf32(acc[i][j], hi, b[j].x, b[j].y);
      }
    }
#pragma unroll
    for (int j = 0; j < G::NN; ++j) b[j] = bn[j];
  }
}

template <class P, int C>
__global__ void __launch_bounds__(kThreads, Tile<P, C>::BLOCKS)
conv_block_tc_kernel(const typename P::T* __restrict__ h, const uint4* __restrict__ w5,
                     const typename P::T* __restrict__ b5, const float* __restrict__ a1p,
                     const uint4* __restrict__ w3a, const typename P::T* __restrict__ b3a,
                     const float* __restrict__ a2p, const uint4* __restrict__ w3b,
                     const typename P::T* __restrict__ b3b, const float* __restrict__ a3p,
                     const typename P::T* __restrict__ film,
                     const typename P::T* __restrict__ cond,
                     typename P::T* __restrict__ v_out, typename P::T* __restrict__ cond_out,
                     int t_len) {
  using G = Geometry<P, C>;
  using T = typename P::T;
  constexpr int MI = G::MI, NN = G::NN;
  extern __shared__ uint4 smem_u4[];
  T* buf_a = reinterpret_cast<T*>(smem_u4);  // ROWS_A x LDS
  T* buf_b = buf_a + G::ROWS_A * G::LDS;     // ROWS_B x LDS

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * G::TT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;  // accumulator row, column pair
  const float a1 = a1p[0], a2 = a2p[0], a3 = a3p[0];
  const T* hb = h + size_t(b) * t_len * C;
  const T* cb = cond ? cond + size_t(b) * t_len * C : nullptr;
  T* vb = v_out + size_t(b) * t_len * C;
  T* ob = cond_out + size_t(b) * t_len * C;

  // stage prelu1(h) for t = t0 - 4 + r, zero outside [0, T); zero buf_b's
  // rows past BM, which the last rows of conv3a read
  constexpr int CH = C * int(sizeof(T)) / 16;  // 16-byte chunks per row
  constexpr int E = 16 / int(sizeof(T));       // values per chunk
  for (int idx = threadIdx.x; idx < G::ROWS_A * CH; idx += kThreads) {
    const int r = idx / CH, ch = idx - r * CH;
    const int t = t0 - 4 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < t_len)
      x = prelu16(P{}, __ldg(reinterpret_cast<const uint4*>(hb + size_t(t) * C) + ch), a1);
    *reinterpret_cast<uint4*>(buf_a + r * G::LDS + ch * E) = x;
    if (r >= G::BM && r < G::ROWS_B)
      *reinterpret_cast<uint4*>(buf_b + r * G::LDS + ch * E) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // conv5: row j <-> t = t0 - 2 + j, into buf_b
  for (int tile = warp; tile < G::TILES; tile += kWarps) {
    const int m0 = (tile / G::NT) * G::WM, n0 = (tile % G::NT) * G::WN;
    float acc[MI][NN][4];
    conv_tile<G, 5>(P{}, buf_a, w5, m0, n0, lane, acc);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n0 + n * 8 + q * 2;
      const float2 bias = ld2(b5 + col);
      float2 gam = make_float2(1.f, 1.f), bet = make_float2(0.f, 0.f);
      if (film) {
        gam = ld2(film + size_t(b) * 2 * C + col);
        bet = ld2(film + size_t(b) * 2 * C + C + col);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = m0 + i * 16 + g + hh * 8;
          const int t = t0 - 2 + j;
          const bool valid = t >= 0 && t < t_len;
          float y0 = acc[i][n][2 * hh] + bias.x;
          float y1 = acc[i][n][2 * hh + 1] + bias.y;
          if (valid && j >= 2 && j < G::TT + 2) st2(ob + size_t(t) * C + col, y0, y1);
          if (cb) {
            float2 ic = make_float2(0.f, 0.f);
            if (valid) ic = ld2v(cb + size_t(t) * C + col);
            y0 = (y0 + ic.x) * kSqrtHalf;
            y1 = (y1 + ic.y) * kSqrtHalf;
          }
          y0 = gam.x * y0 + bet.x;
          y1 = gam.y * y1 + bet.y;
          y0 = valid ? rnd(P{}, y0) : 0.f;
          y1 = valid ? rnd(P{}, y1) : 0.f;
          st2(buf_b + j * G::LDS + col, prelu<P>(y0, a2), prelu<P>(y1, a2));
        }
    }
  }
  __syncthreads();

  // conv3a: row j <-> t = t0 - 1 + j, into buf_a
  for (int tile = warp; tile < G::TILES; tile += kWarps) {
    const int m0 = (tile / G::NT) * G::WM, n0 = (tile % G::NT) * G::WN;
    float acc[MI][NN][4];
    conv_tile<G, 3>(P{}, buf_b, w3a, m0, n0, lane, acc);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n0 + n * 8 + q * 2;
      const float2 bias = ld2(b3a + col);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = m0 + i * 16 + g + hh * 8;
          const int t = t0 - 1 + j;
          const bool valid = t >= 0 && t < t_len;
          const float y0 = valid ? rnd(P{}, acc[i][n][2 * hh] + bias.x) : 0.f;
          const float y1 = valid ? rnd(P{}, acc[i][n][2 * hh + 1] + bias.y) : 0.f;
          st2(buf_a + j * G::LDS + col, prelu<P>(y0, a3), prelu<P>(y1, a3));
        }
    }
  }
  __syncthreads();

  // conv3b + residual: row j <-> t = t0 + j, the block's TT outputs
  for (int tile = warp; tile < G::TILES; tile += kWarps) {
    const int m0 = (tile / G::NT) * G::WM, n0 = (tile % G::NT) * G::WN;
    float acc[MI][NN][4];
    conv_tile<G, 3>(P{}, buf_a, w3b, m0, n0, lane, acc);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n0 + n * 8 + q * 2;
      const float2 bias = ld2(b3b + col);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = m0 + i * 16 + g + hh * 8;
          const int t = t0 + j;
          if (j >= G::TT || t >= t_len) continue;
          const float2 x = ld2v(hb + size_t(t) * C + col);
          const float y0 = (x.x + (acc[i][n][2 * hh] + bias.x)) * kSqrtHalf;
          const float y1 = (x.y + (acc[i][n][2 * hh + 1] + bias.y)) * kSqrtHalf;
          st2(vb + size_t(t) * C + col, y0, y1);
        }
    }
  }
}

template <class P, int C>
cudaError_t launch(const void* h, const void* w5, const void* b5, const void* a1,
                   const void* w3a, const void* b3a, const void* a2,
                   const void* w3b, const void* b3b, const void* a3,
                   const void* film, const void* cond, void* v, void* cond_out,
                   int batch, int t_len, cudaStream_t stream) {
  using G = Geometry<P, C>;
  using T = typename P::T;
  auto kernel = conv_block_tc_kernel<P, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::SMEM));
  if (err != cudaSuccess) return err;
  dim3 grid((t_len + G::TT - 1) / G::TT, batch);
  kernel<<<grid, kThreads, G::SMEM, stream>>>(
      static_cast<const T*>(h), static_cast<const uint4*>(w5),
      static_cast<const T*>(b5), static_cast<const float*>(a1),
      static_cast<const uint4*>(w3a), static_cast<const T*>(b3a),
      static_cast<const float*>(a2), static_cast<const uint4*>(w3b),
      static_cast<const T*>(b3b), static_cast<const float*>(a3),
      static_cast<const T*>(film), static_cast<const T*>(cond),
      static_cast<T*>(v), static_cast<T*>(cond_out), t_len);
  return cudaGetLastError();
}

template <class P>
int dispatch(const void* h, const void* w5, const void* b5, const void* a1,
             const void* w3a, const void* b3a, const void* a2, const void* w3b,
             const void* b3b, const void* a3, const void* film, const void* cond,
             void* v, void* cond_out, int batch, int t_len, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OU_CASE(CC)                                                              \
  case CC:                                                                       \
    return launch<P, CC>(h, w5, b5, a1, w3a, b3a, a2, w3b, b3b, a3, film, cond, \
                         v, cond_out, batch, t_len, s);
  switch (c) {
    OU_CASE(32) OU_CASE(48) OU_CASE(64) OU_CASE(96) OU_CASE(128)
    OU_CASE(192) OU_CASE(256) OU_CASE(384) OU_CASE(512) OU_CASE(768)
    default:
      return cudaErrorInvalidValue;
  }
#undef OU_CASE
}

}  // namespace

extern "C" {

// Every tensor has the entry's type (bf16 or float32) but the slopes a1..a3
// (float32); w5, w3a and w3b are in the fragment order of
// ops/kernels/conv_block.py::mma_weights for that type.  film and cond may
// be null.  Returns the cudaError_t of the launch (0 on success); the
// wrapper checks shapes.
int ou_conv_block_tc(const void* h, const void* w5, const void* b5,
                     const void* a1, const void* w3a, const void* b3a,
                     const void* a2, const void* w3b, const void* b3b,
                     const void* a3, const void* film, const void* cond,
                     void* v, void* cond_out, int batch, int t_len, int c,
                     void* stream) {
  return dispatch<Bf16>(h, w5, b5, a1, w3a, b3a, a2, w3b, b3b, a3, film, cond, v,
                        cond_out, batch, t_len, c, stream);
}

int ou_conv_block_tc_f32(const void* h, const void* w5, const void* b5,
                         const void* a1, const void* w3a, const void* b3a,
                         const void* a2, const void* w3b, const void* b3b,
                         const void* a3, const void* film, const void* cond,
                         void* v, void* cond_out, int batch, int t_len, int c,
                         void* stream) {
  return dispatch<F32>(h, w5, b5, a1, w3a, b3a, a2, w3b, b3b, a3, film, cond, v,
                       cond_out, batch, t_len, c, stream);
}

}  // extern "C"
