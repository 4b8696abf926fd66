// Fused UNIVERSE ConvBlock conv chain for Hopper (sm_90a), float32 on the
// CUDA cores.
//
// Replaces, for float32 storage, the Pallas TPU kernel
// open_universe_tpu/ops/pallas/conv_block.py (fused_conv_chain /
// fused_conv_chain_rows, body `_kernel`); bf16 runs on the tensor cores in
// conv_block_tc.cu.  It computes, for h (B, T, C) and folded weights in the
// (K, Cin, Cout) layout:
//
//   cond_out = conv5(prelu1(h)) + b5
//   c        = cond_out [+ input_cond then * sqrt(1/2)]
//   c        = gamma * c + beta                      (FiLM, if given)
//   c        = conv3a(prelu2(c)) + b3a
//   v        = (h + conv3b(prelu3(c)) + b3b) * sqrt(1/2)
//
// Every conv is 'same' with zero padding, and every intermediate is zero
// outside [0, T), as a chain of separately padded convs sees it.  Sums are
// taken in f32.  The rounding helpers below (round_t, prelu_t) mark the
// points where the TPU kernel rounds to the storage type: after FiLM, after
// each PReLU product, after conv3a, and on output; they are exact in f32.
//
// What bounds it on the H100.  The chain does 22*B*T*C^2 FLOPs and must move
// 3*B*T*C f32 values (h, v, cond_out), 4*B*T*C with input_cond: 1.4*C to
// 1.8*C FLOPs per byte.  Against the CUDA cores' f32 balance (67 TFLOP/s
// over 3.35 TB/s, ~20 FLOP/byte) every C on the path (32..768) is bound by
// operations.  The tensor cores' TF32 (about 3 decimal digits) would not
// hold the f32 gate of 1e-4 max|ref|, so f32 stays on the CUDA cores.  The
// unfused chain writes and reads each of its ~12 intermediates through
// device memory; this kernel keeps all of them in shared memory, so device
// traffic is the fused minimum plus the 4-row halo.
//
// Design (simple first): one block per (batch row, tile of TT time steps).
// The block stages prelu1(h) for [t0-4, t0+TT+4) in shared memory, computes
// conv5 over TT+4 rows into a second buffer, conv3a over TT+2 rows back
// into the first, and conv3b over the TT centre rows straight to the
// output.  Each thread owns 4 consecutive output channels and RPT rows
// (register tile 4 x RPT), reads the weights as one 16-byte load per tap and
// input channel from global memory (L1/L2 resident) and the activations
// from shared memory (broadcast within a warp).  The block has 256 threads
// where C/4 divides 256 (C = 32..512, powers of two) and 192 at the widths
// of the 24 kHz model (C = 48..768, C/4 = 12..192).  TT is picked per C so
// that the two float buffers stay under ~100 KB, which keeps two blocks per
// SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSqrtHalf = 0.70710678118654752440f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// round a float to the storage type and back
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// PReLU on a value already held at storage precision; the negative branch's
// product is rounded to the storage type, as the TPU kernel does
template <typename T> __device__ __forceinline__ float prelu_t(float x, float a) {
  return x >= 0.f ? x : round_t<T>(a * x);
}

__device__ __forceinline__ void load4(const float* p, float (&w)[4]) {
  float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// Time tile and threads per channel width: the two float buffers hold
// (TT+8) and (TT+4) rows of C+1 floats.
template <int C> struct Tile;
template <> struct Tile<32> { static constexpr int TT = 256, THREADS = 256; };
template <> struct Tile<48> { static constexpr int TT = 128, THREADS = 192; };
template <> struct Tile<64> { static constexpr int TT = 128, THREADS = 256; };
template <> struct Tile<96> { static constexpr int TT = 64, THREADS = 192; };
template <> struct Tile<128> { static constexpr int TT = 64, THREADS = 256; };
template <> struct Tile<192> { static constexpr int TT = 32, THREADS = 192; };
template <> struct Tile<256> { static constexpr int TT = 32, THREADS = 256; };
template <> struct Tile<384> { static constexpr int TT = 16, THREADS = 192; };
template <> struct Tile<512> { static constexpr int TT = 16, THREADS = 256; };
template <> struct Tile<768> { static constexpr int TT = 8, THREADS = 192; };

template <int C> struct Geometry {
  static constexpr int TT = Tile<C>::TT;
  static constexpr int THREADS = Tile<C>::THREADS;
  static constexpr int LD = C + 1;           // padded row stride (banks)
  static constexpr int CG = C / 4;           // channel groups of 4
  static constexpr int RG = THREADS / CG;    // row groups
  static constexpr int ROWS_A = TT + 8;
  static constexpr int ROWS_B = TT + 4;
  static constexpr int RPT = (TT + 4 + RG - 1) / RG;  // rows per thread
  static constexpr size_t SMEM = size_t(ROWS_A + ROWS_B) * LD * sizeof(float);
  static_assert(THREADS % CG == 0, "C/4 must divide the block");
};

// acc[i][q] = sum_{k, ci} in[(r_i + k) * LD + ci] * w[(k * C + ci) * C + co + q]
// for rows r_i = rg + i * RG (clamped to nout - 1; the caller drops them)
template <typename T, int C, int K>
__device__ __forceinline__ void conv_acc(const float* __restrict__ in,
                                         const T* __restrict__ w, int nout,
                                         int rg, int co,
                                         float (&acc)[Geometry<C>::RPT][4]) {
  using G = Geometry<C>;
  int base[G::RPT];
#pragma unroll
  for (int i = 0; i < G::RPT; ++i) {
    int r = rg + i * G::RG;
    base[i] = (r < nout ? r : nout - 1) * G::LD;
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T* wk = w + size_t(k) * C * C + co;
    const float* ink = in + k * G::LD;
#pragma unroll 4
    for (int ci = 0; ci < C; ++ci) {
      float wv[4];
      load4(wk + size_t(ci) * C, wv);
#pragma unroll
      for (int i = 0; i < G::RPT; ++i) {
        float x = ink[base[i] + ci];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(x, wv[q], acc[i][q]);
      }
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(Geometry<C>::THREADS)
conv_block_kernel(const T* __restrict__ h, const T* __restrict__ w5,
                  const T* __restrict__ b5, const float* __restrict__ a1p,
                  const T* __restrict__ w3a, const T* __restrict__ b3a,
                  const float* __restrict__ a2p, const T* __restrict__ w3b,
                  const T* __restrict__ b3b, const float* __restrict__ a3p,
                  const T* __restrict__ film, const T* __restrict__ cond,
                  T* __restrict__ v_out, T* __restrict__ cond_out, int t_len) {
  using G = Geometry<C>;
  extern __shared__ float smem[];
  float* buf_a = smem;                      // ROWS_A x LD
  float* buf_b = smem + G::ROWS_A * G::LD;  // ROWS_B x LD

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * G::TT;
  const float a1 = a1p[0], a2 = a2p[0], a3 = a3p[0];
  const T* hb = h + size_t(b) * t_len * C;

  // stage prelu1(h) for t in [t0-4, t0+TT+4), zero outside [0, T)
  for (int idx = threadIdx.x; idx < G::ROWS_A * C; idx += G::THREADS) {
    int r = idx / C, c = idx - r * C;
    int t = t0 - 4 + r;
    float x = 0.f;
    if (t >= 0 && t < t_len) x = prelu_t<T>(to_f(hb[size_t(t) * C + c]), a1);
    buf_a[r * G::LD + c] = x;
  }
  __syncthreads();

  const int cg = threadIdx.x % G::CG;
  const int rg = threadIdx.x / G::CG;
  const int co = cg * 4;
  float acc[G::RPT][4];

  float bias[4], gamma[4], beta[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bias[q] = to_f(b5[co + q]);
    gamma[q] = film ? to_f(film[size_t(b) * 2 * C + co + q]) : 1.f;
    beta[q] = film ? to_f(film[size_t(b) * 2 * C + C + co + q]) : 0.f;
  }

  // conv5: rows j in [0, TT+4) <-> t = t0 - 2 + j
  conv_acc<T, C, 5>(buf_a, w5, G::TT + 4, rg, co, acc);
#pragma unroll
  for (int i = 0; i < G::RPT; ++i) {
    int j = rg + i * G::RG;
    if (j >= G::TT + 4) continue;
    int t = t0 - 2 + j;
    bool valid = t >= 0 && t < t_len;
    size_t off = size_t(b) * t_len * C + size_t(t) * C + co;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float y = acc[i][q] + bias[q];
      if (valid && j >= 2 && j < G::TT + 2) cond_out[off + q] = from_f<T>(y);
      if (cond) y = (y + (valid ? to_f(cond[off + q]) : 0.f)) * kSqrtHalf;
      y = gamma[q] * y + beta[q];
      y = valid ? round_t<T>(y) : 0.f;
      buf_b[j * G::LD + co + q] = prelu_t<T>(y, a2);
    }
  }
  __syncthreads();

  // conv3a: rows j in [0, TT+2) <-> t = t0 - 1 + j, into buf_a
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = to_f(b3a[co + q]);
  conv_acc<T, C, 3>(buf_b, w3a, G::TT + 2, rg, co, acc);
#pragma unroll
  for (int i = 0; i < G::RPT; ++i) {
    int j = rg + i * G::RG;
    if (j >= G::TT + 2) continue;
    int t = t0 - 1 + j;
    bool valid = t >= 0 && t < t_len;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float y = valid ? round_t<T>(acc[i][q] + bias[q]) : 0.f;
      buf_a[j * G::LD + co + q] = prelu_t<T>(y, a3);
    }
  }
  __syncthreads();

  // conv3b + residual: rows j in [0, TT) <-> t = t0 + j
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = to_f(b3b[co + q]);
  conv_acc<T, C, 3>(buf_a, w3b, G::TT, rg, co, acc);
#pragma unroll
  for (int i = 0; i < G::RPT; ++i) {
    int j = rg + i * G::RG;
    int t = t0 + j;
    if (j >= G::TT || t >= t_len) continue;
    size_t off = size_t(t) * C + co;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float y = (to_f(hb[off + q]) + (acc[i][q] + bias[q])) * kSqrtHalf;
      v_out[size_t(b) * t_len * C + off + q] = from_f<T>(y);
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* h, const void* w5, const void* b5, const void* a1,
                   const void* w3a, const void* b3a, const void* a2,
                   const void* w3b, const void* b3b, const void* a3,
                   const void* film, const void* cond, void* v, void* cond_out,
                   int batch, int t_len, cudaStream_t stream) {
  using G = Geometry<C>;
  auto kernel = conv_block_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::SMEM));
  if (err != cudaSuccess) return err;
  dim3 grid((t_len + G::TT - 1) / G::TT, batch);
  kernel<<<grid, G::THREADS, G::SMEM, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w5),
      static_cast<const T*>(b5), static_cast<const float*>(a1),
      static_cast<const T*>(w3a), static_cast<const T*>(b3a),
      static_cast<const float*>(a2), static_cast<const T*>(w3b),
      static_cast<const T*>(b3b), static_cast<const float*>(a3),
      static_cast<const T*>(film), static_cast<const T*>(cond),
      static_cast<T*>(v), static_cast<T*>(cond_out), t_len);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every tensor is float32.  film and cond may be null.  Returns the
// cudaError_t of the launch (0 on success); the wrapper checks shapes.
int ou_conv_block(const void* h, const void* w5, const void* b5,
                  const void* a1, const void* w3a, const void* b3a,
                  const void* a2, const void* w3b, const void* b3b,
                  const void* a3, const void* film, const void* cond, void* v,
                  void* cond_out, int batch, int t_len, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OU_CASE(CC)                                                         \
  case CC:                                                                  \
    return launch<float, CC>(h, w5, b5, a1, w3a, b3a, a2, w3b, b3b, a3,     \
                             film, cond, v, cond_out, batch, t_len, s);
  switch (c) {
    OU_CASE(32) OU_CASE(48) OU_CASE(64) OU_CASE(96) OU_CASE(128)
    OU_CASE(192) OU_CASE(256) OU_CASE(384) OU_CASE(512) OU_CASE(768)
    default:
      return cudaErrorInvalidValue;
  }
#undef OU_CASE
}

}  // extern "C"
