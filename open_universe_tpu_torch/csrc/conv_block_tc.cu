// Fused UNIVERSE ConvBlock conv chain on Hopper's tensor cores (sm_90a), in
// two precisions: bf16 (mma.sync m16n8k16) and float32 (3xTF32, on wgmma at
// the widths of WgTile and on mma.sync m16n8k8 at the others).
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
// rows.  One block per (batch row, tile of TT = BM - 4 output steps).  The
// block stages prelu1(h) for t0-4 .. t0+BM-1 in shared memory; conv5 runs
// over BM rows (t0-2 ..), with cond, FiLM and prelu2 applied to the f32
// accumulators in its epilogue (cond_out is written from there too); conv3a
// runs over BM rows (t0-1 ..); conv3b over BM rows (t0 ..) straight to v.
// The valid rows shrink by the halo at each conv instead of each conv being
// padded, so a block does three BM-row GEMMs for BM - 4 outputs.
// Intermediates are zero outside [0, T), so any T >= 1 works.  The buffers
// hold the storage type: the chain rounds to it at every point where they are
// written, so this changes no value (f32 buffers hold full f32).  A comes
// from shared memory by ldmatrix, which takes any row offset, so the tap
// shift costs nothing; rows are padded by 16 bytes so the eight rows of an
// ldmatrix fall on distinct banks.  For f32, ldmatrix.m8n8.x4.b16 reads each
// 8x8 b16 matrix as 8 rows x 4 floats, which is exactly m16n8k8's TF32 A
// fragment, and wgmma's for a warp's 16 rows.
//
// Two cores.  mma.sync (bf16 at every width; f32 where WgTile has no entry
// or the launch covers fewer than its MIN_ROWS rows): 8 warps, each computing
// WM x WN tiles (WM = 64 rows, or BM where BM = 32) of conv5 into a second
// buffer, of conv3a back into the first, of conv3b to v.  B (the weights) is
// read from L2 (and L1, where warps of a block share columns) in a
// fragment-ordered copy that the wrapper makes once per weight tensor: one
// 16-byte load per lane feeds two n8 tiles of a k16 step (bf16) or one n8
// tile of a k8 step with its hi and lo halves (f32), prefetched one k-step
// ahead.  Shared memory is (2 BM + 6) rows of C + 16 bytes: bf16 keeps 64-row
// tiles up to C = 768 (208 KB); f32 at C >= 512 takes BM = 32 (C = 768:
// 216 KB), which does three 32-row GEMMs for 28 outputs.
// wgmma (f32 at C = 32..384): warpgroups of 64 rows, their accumulators in
// registers for a whole conv, so one buffer serves the three convs, and the
// weights staged in shared memory once per block by TMA's bulk copy, in
// place of every warp loading its own fragments from L2 on mma.sync, which
// bound the f32 route there by instruction count (3 TF32 products per
// product).  It has no room at C >= 512 for the buffer beside a ring of
// full-width stages, and was slower at C = 512 with a ring of two
// (PERF.md).  A cluster of 2 or 4 blocks sharing each stage by TMA multicast
// was 1.6 to 2.1 times slower at every width than blocks that each copy
// their own, and is not used (PERF.md).
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
// (ops/kernels/tile_probe.py, PERF.md).  F32 has entries only at the widths
// where a launch can take this core (WgTile: none, or MIN_ROWS > 0).
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
template <> struct Tile<F32, 128> { static constexpr int BM = 64, WN = 16, BLOCKS = 2; };
template <> struct Tile<F32, 256> { static constexpr int BM = 64, WN = 32, BLOCKS = 1; };
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

// ---- the f32 route's wgmma core --------------------------------------------
//
// One block per (batch row, tile of TT = BM - 4 output steps), as above, with
// BM / 64 x NW consumer warpgroups and one producer warp.  Warpgroup w owns
// rows 64 (w / NW) .. of each conv and the C / NW output channels from
// n0 = (w % NW) C / NW: its accumulators are registers for the whole
// reduction, so the block needs one activation buffer of BM + 4 rows, which
// each conv's epilogue overwrites in place once every warpgroup has read it.
// The producer streams the three convs' weights, one k8 step (8 input
// channels of one tap, all C outputs, hi and lo: 64 C bytes) per stage, through
// a ring of STAGES stages with cp.async.bulk (TMA's bulk copy: the wrapper has
// laid the weights out as the stages hold them, so no tensor map is needed).
// A (the activations) comes from the buffer by ldmatrix into registers,
// split into hi and lo there: wgmma's TF32 A fragment of a warp's 16 rows is
// m16n8k8's.  B is the stage, read by wgmma through a no-swizzle K-major
// descriptor: core matrices of 8 output channels x 4 input channels
// (128 bytes), the next 4 input channels 128 bytes on (LBO), the next 8
// output channels 256 bytes on (SBO).

// BM: rows of each conv GEMM (a multiple of 64); NW: warpgroups across the
// channels; WI: output channels per wgmma instruction; KS: k8 steps per
// stage of the weight ring, which the warpgroups run as one wgmma group;
// STAGES: ring depth; BLOCKS: blocks per SM the registers are capped for;
// MIN_ROWS: fewest rows (B T) a launch must cover to take this core (below
// it, too few blocks fill the card).  BM = 0: the width keeps the mma.sync
// core.  Picked by timing tables side by side on the H100
// (ops/kernels/tile_probe.py, PERF.md).
template <int C> struct WgTile { static constexpr int BM = 0; };
template <> struct WgTile<32> { static constexpr int BM = 128, NW = 1, WI = 32, KS = 2, STAGES = 4, BLOCKS = 3, MIN_ROWS = 65536; };
template <> struct WgTile<48> { static constexpr int BM = 128, NW = 1, WI = 48, KS = 2, STAGES = 3, BLOCKS = 3, MIN_ROWS = 0; };
template <> struct WgTile<64> { static constexpr int BM = 128, NW = 1, WI = 64, KS = 2, STAGES = 4, BLOCKS = 2, MIN_ROWS = 0; };
template <> struct WgTile<96> { static constexpr int BM = 64, NW = 1, WI = 96, KS = 2, STAGES = 4, BLOCKS = 3, MIN_ROWS = 0; };
template <> struct WgTile<128> { static constexpr int BM = 256, NW = 1, WI = 128, KS = 1, STAGES = 8, BLOCKS = 1, MIN_ROWS = 12288; };
template <> struct WgTile<192> { static constexpr int BM = 128, NW = 2, WI = 96, KS = 1, STAGES = 8, BLOCKS = 1, MIN_ROWS = 0; };
template <> struct WgTile<256> { static constexpr int BM = 128, NW = 2, WI = 128, KS = 1, STAGES = 5, BLOCKS = 1, MIN_ROWS = 6144; };
template <> struct WgTile<384> { static constexpr int BM = 64, NW = 3, WI = 128, KS = 1, STAGES = 4, BLOCKS = 1, MIN_ROWS = 0; };

template <int C_> struct WgGeometry {
  using W = WgTile<C_>;
  static constexpr int C = C_;
  static constexpr int BM = W::BM, NW = W::NW, WN = C / NW, WI = W::WI, NCH = WN / WI;
  static constexpr int NWG = BM / 64 * NW;              // consumer warpgroups
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 32;        // and the producer warp
  static constexpr int TT = BM - 4;                     // output steps per block
  static constexpr int ROWS = BM + 4;                   // conv5 reads rows .. BM + 3
  static constexpr int LDS = C + 4;                     // buffer row stride, floats
  static constexpr int KS = W::KS, STAGES = W::STAGES;
  static constexpr int STEP_BYTES = 64 * C;             // one k8 step, hi and lo
  static constexpr int STAGE_BYTES = KS * STEP_BYTES;
  static constexpr int STEPS5 = 5 * C / 8, STEPS3 = 3 * C / 8;
  static constexpr size_t BUF = (size_t(ROWS) * LDS * 4 + 127) / 128 * 128;
  static constexpr size_t RING = size_t(STAGES) * STAGE_BYTES;
  static constexpr size_t SMEM = BUF + RING + 16 * STAGES;  // and full, empty barriers
  static_assert(BM % 64 == 0 && C % NW == 0 && WN % WI == 0 && WI % 8 == 0 &&
                C / 8 % KS == 0 && STAGES >= 2, "wgmma tile shape");
  static_assert(SMEM <= 232448, "buffer and ring exceed a block's shared memory");
};

// wgmma.m64nNk8.f32.tf32.tf32 into the warpgroup's N / 2 accumulators d, A
// from registers, B the tile at desc.  OU_WGMMA(N, the accumulators' operand
// list, the operand numbers of a[0..3], desc and the scale-d flag that follow
// them, then the accumulators eight at a time)
#define OU_D8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),       \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define OU_S16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define OU_S24 OU_S16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define OU_S32 OU_S24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define OU_S48 OU_S32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define OU_S64 OU_S48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
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
OU_WGMMA(32, OU_S16, 16, 17, 18, 19, 20, 21, OU_D8(0), OU_D8(8))
OU_WGMMA(48, OU_S24, 24, 25, 26, 27, 28, 29, OU_D8(0), OU_D8(8), OU_D8(16))
OU_WGMMA(64, OU_S32, 32, 33, 34, 35, 36, 37, OU_D8(0), OU_D8(8), OU_D8(16), OU_D8(24))
OU_WGMMA(96, OU_S48, 48, 49, 50, 51, 52, 53, OU_D8(0), OU_D8(8), OU_D8(16), OU_D8(24),
         OU_D8(32), OU_D8(40))
OU_WGMMA(128, OU_S64, 64, 65, 66, 67, 68, 69, OU_D8(0), OU_D8(8), OU_D8(16), OU_D8(24),
         OU_D8(32), OU_D8(40), OU_D8(48), OU_D8(56))
#undef OU_WGMMA
#undef OU_S64
#undef OU_S48
#undef OU_S32
#undef OU_S24
#undef OU_S16
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
template <int R> __device__ __forceinline__ void wg_pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// no-swizzle K-major descriptor of the B tile at shared address addr
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

// One group of the warpgroup's part of a conv: the KS k8 steps from s0 of
// stage `it` into d.  A of step s is rows row0 + s / KB .. (the tap) at
// input channels 8 (s % KB) .. of `in`, read into hi and lo; hp and lp hold
// the group before's A, which its wgmmas may still read: they stay live until
// that group is waited for, so these registers cannot take its place.
template <class G, int KB>
__device__ __forceinline__ void wg_group(int s0, uint32_t a_base, uint32_t b_base, uint32_t full,
                                         uint32_t empty, int it, int lane,
                                         float (&d)[G::NCH][G::WI / 2],
                                         uint32_t (&hi)[G::KS][4], uint32_t (&lo)[G::KS][4],
                                         uint32_t (&hp)[G::KS][4], uint32_t (&lp)[G::KS][4]) {
#pragma unroll
  for (int k = 0; k < G::KS; ++k) {
    const int s = s0 + k, tap = s / KB, kb = s - tap * KB;
    uint32_t a[4];
    ldmatrix_x4(a, a_base + (tap * G::LDS + kb * 8) * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[k][e] = tf32_round(a[e]);
      lo[k][e] = __float_as_uint(__uint_as_float(a[e]) - __uint_as_float(hi[k][e]));
    }
  }
  const int stage = it % G::STAGES;
  mbar_wait(full + 8 * stage, (it / G::STAGES) & 1);
  constexpr uint64_t CH = G::WI / 8 * 256 >> 4;   // the next chunk's columns
  constexpr uint64_t LO = 32 * G::C >> 4;          // lo after hi
  constexpr uint64_t STEP = G::STEP_BYTES >> 4;    // the next k8 step
  const uint64_t b0 = wg_desc(b_base + stage * G::STAGE_BYTES);
#pragma unroll
  for (int ch = 0; ch < G::NCH; ++ch) wg_pin(d[ch]);
  wg_fence();
#pragma unroll
  for (int k = 0; k < G::KS; ++k)
#pragma unroll
    for (int ch = 0; ch < G::NCH; ++ch) {  // the small terms first
      const uint64_t b = b0 + k * STEP + ch * CH;
      Wgmma<G::WI>::mma(d[ch], lo[k], b);
      Wgmma<G::WI>::mma(d[ch], hi[k], b + LO);
      Wgmma<G::WI>::mma(d[ch], hi[k], b);
    }
  wg_commit();
  wg_wait<1>();  // the group before has read its stage and its A
#pragma unroll
  for (int k = 0; k < G::KS; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(hp[k][e]), "+r"(lp[k][e])::"memory");
  if (s0 > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % G::STAGES));
}

// The warpgroup's part of one conv: d[ch] = the m64 x WI accumulators of its
// rows and of output channels n0 + ch WI .., summed over taps and input
// channels of in[r + tap][ci] * w[tap][ci][co] with w the stages' stream
// (it: this block's count of stages consumed).  Each warp releases each
// stage once its wgmmas have read it.
template <class G, int K>
__device__ __forceinline__ void wg_conv(const float* in, uint32_t ring, uint32_t full,
                                        uint32_t empty, int& it, int row0, int n0, int lane,
                                        float (&d)[G::NCH][G::WI / 2]) {
  constexpr int KB = G::C / 8;  // k8 steps per tap
  constexpr int S = K * KB;
#pragma unroll
  for (int ch = 0; ch < G::NCH; ++ch)
#pragma unroll
    for (int i = 0; i < G::WI / 2; ++i) d[ch][i] = 0.f;
  // ldmatrix.x4: lanes 0-15 address the warp's rows 0-15 at k 0, 16-31 at k 4
  const uint32_t a_base =
      smem_u32(in + (row0 + (lane & 15)) * G::LDS + (lane >> 4) * 4);
  const uint32_t b_base = ring + (n0 / 8) * 256;
  uint32_t hi0[G::KS][4], lo0[G::KS][4], hi1[G::KS][4], lo1[G::KS][4];
  int s0 = 0;
  for (; s0 + 2 * G::KS <= S; s0 += 2 * G::KS, it += 2) {
    wg_group<G, KB>(s0, a_base, b_base, full, empty, it, lane, d, hi0, lo0, hi1, lo1);
    wg_group<G, KB>(s0 + G::KS, a_base, b_base, full, empty, it + 1, lane, d, hi1, lo1, hi0,
                    lo0);
  }
  if (s0 < S) wg_group<G, KB>(s0, a_base, b_base, full, empty, it++, lane, d, hi0, lo0, hi1, lo1);
  wg_wait<0>();
#pragma unroll
  for (int ch = 0; ch < G::NCH; ++ch) wg_pin(d[ch]);
#pragma unroll
  for (int k = 0; k < G::KS; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("" : "+r"(hi0[k][e]), "+r"(lo0[k][e]), "+r"(hi1[k][e]), "+r"(lo1[k][e])::"memory");
  if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % G::STAGES));
}

template <int C>
__global__ void __launch_bounds__(WgGeometry<C>::THREADS, WgTile<C>::BLOCKS)
conv_block_tc_kernel_wgmma(const float* __restrict__ h, const uint4* __restrict__ w5,
                           const float* __restrict__ b5, const float* __restrict__ a1p,
                           const uint4* __restrict__ w3a, const float* __restrict__ b3a,
                           const float* __restrict__ a2p, const uint4* __restrict__ w3b,
                           const float* __restrict__ b3b, const float* __restrict__ a3p,
                           const float* __restrict__ film, const float* __restrict__ cond,
                           float* __restrict__ v_out, float* __restrict__ cond_out,
                           int t_len) {
  using G = WgGeometry<C>;
  using P = F32;
  extern __shared__ __align__(128) uint8_t smem[];
  float* buf = reinterpret_cast<float*>(smem);  // ROWS x LDS
  const uint32_t ring = smem_u32(smem + G::BUF);
  const uint32_t full = ring + uint32_t(G::RING), empty = full + 8 * G::STAGES;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * G::TT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* hb = h + size_t(b) * t_len * C;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * G::NWG);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * G::NWG) {  // the producer: the three convs' weight stream
    if (lane == 0) {
      const char* w[3] = {reinterpret_cast<const char*>(w5), reinterpret_cast<const char*>(w3a),
                          reinterpret_cast<const char*>(w3b)};
      constexpr int N5 = G::STEPS5 / G::KS, N3 = G::STEPS3 / G::KS;  // stages per conv
      for (int i = 0; i < N5 + 2 * N3; ++i) {
        const int stage = i % G::STAGES;
        if (i >= G::STAGES) mbar_wait(empty + 8 * stage, (i / G::STAGES - 1) & 1);
        mbar_expect_tx(full + 8 * stage, G::STAGE_BYTES);
        const int conv = i < N5 ? 0 : i < N5 + N3 ? 1 : 2;
        const int n = conv == 0 ? i : i - N5 - (conv - 1) * N3;
        bulk_load(ring + stage * G::STAGE_BYTES, w[conv] + size_t(n) * G::STAGE_BYTES,
                  G::STAGE_BYTES, full + 8 * stage);
      }
    }
  } else {
    const int g = lane >> 2, q = lane & 3;  // accumulator row, column pair
    const int wg = warp >> 2;
    const int row0 = (wg / G::NW) * 64 + (warp & 3) * 16;  // the warp's first row
    const int n0 = (wg % G::NW) * G::WN;
    const float a1 = a1p[0], a2 = a2p[0], a3 = a3p[0];
    const float* cb = cond ? cond + size_t(b) * t_len * C : nullptr;
    float* vb = v_out + size_t(b) * t_len * C;
    float* ob = cond_out + size_t(b) * t_len * C;
    float d[G::NCH][G::WI / 2];
    int it = 0;

    // stage prelu1(h) for t = t0 - 4 + r, zero outside [0, T)
    constexpr int CH = C / 4;  // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < G::ROWS * CH; idx += G::CONSUMERS) {
      const int r = idx / CH, ch = idx - r * CH;
      const int t = t0 - 4 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (t >= 0 && t < t_len)
        x = prelu16(P{}, __ldg(reinterpret_cast<const uint4*>(hb + size_t(t) * C) + ch), a1);
      *reinterpret_cast<uint4*>(buf + r * G::LDS + ch * 4) = x;
    }
    consumer_sync<G::CONSUMERS>();

    // conv5: row j <-> t = t0 - 2 + j, back into the buffer
    wg_conv<G, 5>(buf, ring, full, empty, it, row0, n0, lane, d);
    consumer_sync<G::CONSUMERS>();  // every warpgroup has read the buffer
#pragma unroll
    for (int ch = 0; ch < G::NCH; ++ch)
#pragma unroll
      for (int n = 0; n < G::WI / 8; ++n) {
        const int col = n0 + ch * G::WI + n * 8 + q * 2;
        const float2 bias = ld2(b5 + col);
        float2 gam = make_float2(1.f, 1.f), bet = make_float2(0.f, 0.f);
        if (film) {
          gam = ld2(film + size_t(b) * 2 * C + col);
          bet = ld2(film + size_t(b) * 2 * C + C + col);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = row0 + g + hh * 8;
          const int t = t0 - 2 + j;
          const bool valid = t >= 0 && t < t_len;
          float y0 = d[ch][4 * n + 2 * hh] + bias.x;
          float y1 = d[ch][4 * n + 2 * hh + 1] + bias.y;
          if (valid && j >= 2 && j < G::TT + 2) st2(ob + size_t(t) * C + col, y0, y1);
          if (cb) {
            float2 ic = make_float2(0.f, 0.f);
            if (valid) ic = ld2v(cb + size_t(t) * C + col);
            y0 = (y0 + ic.x) * kSqrtHalf;
            y1 = (y1 + ic.y) * kSqrtHalf;
          }
          y0 = gam.x * y0 + bet.x;
          y1 = gam.y * y1 + bet.y;
          y0 = valid ? y0 : 0.f;
          y1 = valid ? y1 : 0.f;
          st2(buf + j * G::LDS + col, prelu<P>(y0, a2), prelu<P>(y1, a2));
        }
      }
    // rows BM, BM + 1, which the last rows of conv3a read, are zero
    for (int idx = threadIdx.x; idx < 2 * CH; idx += G::CONSUMERS)
      *reinterpret_cast<uint4*>(buf + (G::BM + idx / CH) * G::LDS + (idx % CH) * 4) =
          make_uint4(0u, 0u, 0u, 0u);
    consumer_sync<G::CONSUMERS>();

    // conv3a: row j <-> t = t0 - 1 + j, back into the buffer
    wg_conv<G, 3>(buf, ring, full, empty, it, row0, n0, lane, d);
    consumer_sync<G::CONSUMERS>();
#pragma unroll
    for (int ch = 0; ch < G::NCH; ++ch)
#pragma unroll
      for (int n = 0; n < G::WI / 8; ++n) {
        const int col = n0 + ch * G::WI + n * 8 + q * 2;
        const float2 bias = ld2(b3a + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = row0 + g + hh * 8;
          const int t = t0 - 1 + j;
          const bool valid = t >= 0 && t < t_len;
          const float y0 = valid ? d[ch][4 * n + 2 * hh] + bias.x : 0.f;
          const float y1 = valid ? d[ch][4 * n + 2 * hh + 1] + bias.y : 0.f;
          st2(buf + j * G::LDS + col, prelu<P>(y0, a3), prelu<P>(y1, a3));
        }
      }
    consumer_sync<G::CONSUMERS>();

    // conv3b + residual: row j <-> t = t0 + j, the block's TT outputs
    wg_conv<G, 3>(buf, ring, full, empty, it, row0, n0, lane, d);
#pragma unroll
    for (int ch = 0; ch < G::NCH; ++ch)
#pragma unroll
      for (int n = 0; n < G::WI / 8; ++n) {
        const int col = n0 + ch * G::WI + n * 8 + q * 2;
        const float2 bias = ld2(b3b + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = row0 + g + hh * 8;
          const int t = t0 + j;
          if (j >= G::TT || t >= t_len) continue;
          const float2 x = ld2v(hb + size_t(t) * C + col);
          const float y0 = (x.x + (d[ch][4 * n + 2 * hh] + bias.x)) * kSqrtHalf;
          const float y1 = (x.y + (d[ch][4 * n + 2 * hh + 1] + bias.y)) * kSqrtHalf;
          st2(vb + size_t(t) * C + col, y0, y1);
        }
      }
  }
}

template <int C>
cudaError_t launch_wgmma(const void* h, const void* w5, const void* b5, const void* a1,
                         const void* w3a, const void* b3a, const void* a2, const void* w3b,
                         const void* b3b, const void* a3, const void* film, const void* cond,
                         void* v, void* cond_out, int batch, int t_len, cudaStream_t stream) {
  using G = WgGeometry<C>;
  auto kernel = conv_block_tc_kernel_wgmma<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::SMEM));
  if (err != cudaSuccess) return err;
  dim3 grid((t_len + G::TT - 1) / G::TT, batch);
  kernel<<<grid, G::THREADS, G::SMEM, stream>>>(
      static_cast<const float*>(h), static_cast<const uint4*>(w5),
      static_cast<const float*>(b5), static_cast<const float*>(a1),
      static_cast<const uint4*>(w3a), static_cast<const float*>(b3a),
      static_cast<const float*>(a2), static_cast<const uint4*>(w3b),
      static_cast<const float*>(b3b), static_cast<const float*>(a3),
      static_cast<const float*>(film), static_cast<const float*>(cond),
      static_cast<float*>(v), static_cast<float*>(cond_out), t_len);
  return cudaGetLastError();
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

// The fewest rows (B T) a launch at width C needs to take the wgmma core; -1
// where the width has no wgmma core.
template <int C> constexpr int wgmma_min_rows() {
  if constexpr (WgTile<C>::BM > 0) return WgTile<C>::MIN_ROWS;
  else return -1;
}

int min_rows(int c) {
#define OU_CASE(CC) \
  case CC:          \
    return wgmma_min_rows<CC>();
  switch (c) {
    OU_CASE(32) OU_CASE(48) OU_CASE(64) OU_CASE(96) OU_CASE(128)
    OU_CASE(192) OU_CASE(256) OU_CASE(384) OU_CASE(512) OU_CASE(768)
    default:
      return -1;
  }
#undef OU_CASE
}

// The f32 route at width C on core 0 (mma.sync, built where a launch can
// take it: the width has no wgmma core or a MIN_ROWS above 0) or 1 (wgmma,
// at the widths of WgTile); another core is cudaErrorInvalidValue.
template <int C>
int launch_f32(const void* h, const void* w5, const void* b5, const void* a1,
               const void* w3a, const void* b3a, const void* a2, const void* w3b,
               const void* b3b, const void* a3, const void* film, const void* cond,
               void* v, void* cond_out, int batch, int t_len, cudaStream_t s, int core) {
  if constexpr (wgmma_min_rows<C>() != 0)
    if (core == 0)
      return launch<F32, C>(h, w5, b5, a1, w3a, b3a, a2, w3b, b3b, a3, film, cond, v,
                            cond_out, batch, t_len, s);
  if constexpr (wgmma_min_rows<C>() >= 0)
    if (core == 1)
      return launch_wgmma<C>(h, w5, b5, a1, w3a, b3a, a2, w3b, b3b, a3, film, cond, v,
                             cond_out, batch, t_len, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Every tensor has the entry's type (bf16 or float32) but the slopes a1..a3
// (float32); w5, w3a and w3b are in the layout of
// ops/kernels/conv_block.py for that type and core (mma_weights_layout,
// mma_weights_tf32_layout or wgmma_weights_tf32_layout).  film and cond may
// be null.  Returns the cudaError_t of the launch (0 on success); the
// wrapper checks shapes.  bf16 runs the mma.sync core.
int ou_conv_block_tc(const void* h, const void* w5, const void* b5,
                     const void* a1, const void* w3a, const void* b3a,
                     const void* a2, const void* w3b, const void* b3b,
                     const void* a3, const void* film, const void* cond,
                     void* v, void* cond_out, int batch, int t_len, int c,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OU_CASE(CC)                                                                     \
  case CC:                                                                              \
    return launch<Bf16, CC>(h, w5, b5, a1, w3a, b3a, a2, w3b, b3b, a3, film, cond, v,   \
                            cond_out, batch, t_len, s);
  switch (c) {
    OU_CASE(32) OU_CASE(48) OU_CASE(64) OU_CASE(96) OU_CASE(128)
    OU_CASE(192) OU_CASE(256) OU_CASE(384) OU_CASE(512) OU_CASE(768)
    default:
      return cudaErrorInvalidValue;
  }
#undef OU_CASE
}

// float32 (3xTF32) on core 0 (mma.sync) or 1 (wgmma):
// ou_conv_block_tc_f32_min_rows says which a launch takes and which a width has.
int ou_conv_block_tc_f32(const void* h, const void* w5, const void* b5,
                         const void* a1, const void* w3a, const void* b3a,
                         const void* a2, const void* w3b, const void* b3b,
                         const void* a3, const void* film, const void* cond,
                         void* v, void* cond_out, int batch, int t_len, int c,
                         void* stream, int core) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OU_CASE(CC)                                                                     \
  case CC:                                                                              \
    return launch_f32<CC>(h, w5, b5, a1, w3a, b3a, a2, w3b, b3b, a3, film, cond, v,     \
                          cond_out, batch, t_len, s, core);
  switch (c) {
    OU_CASE(32) OU_CASE(48) OU_CASE(64) OU_CASE(96) OU_CASE(128)
    OU_CASE(192) OU_CASE(256) OU_CASE(384) OU_CASE(512) OU_CASE(768)
    default:
      return cudaErrorInvalidValue;
  }
#undef OU_CASE
}

// The table's f32 core at width c: a launch of B T rows takes wgmma where
// 0 <= MIN_ROWS <= B T, else mma.sync.  Returns MIN_ROWS, -1 where the width
// has no wgmma core; at MIN_ROWS = 0 it has no mma.sync core.
int ou_conv_block_tc_f32_min_rows(int c) { return min_rows(c); }

}  // extern "C"
