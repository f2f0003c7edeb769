// sep2d: optional ReLU -> 3x3 SAME stride-1 depthwise -> 1x1 pointwise
// product (float32 accumulate) -> folded-BN affine, NHWC, float32 or bf16.
//
// Replaces the Pallas kernel sparkdl_tpu/core/kernels.py::sep2d (body
// _sep2d_kernel / _dw_rows), which keeps the depthwise result in VMEM and
// feeds it to the MXU without a round trip through HBM.
//
// What bounds it on an H100: at most sites, the pointwise product. A
// middle-flow Xception site (19x19, 728->728) does ~1.07 MFLOP per
// position against (Cin + Cout) activations: ~370 FLOP/byte in bf16, above
// the ~295 FLOP/byte ridge of the bf16 tensor cores, and ~180 in float32,
// far above the ~20 FLOP/byte ridge of the float32 CUDA cores. The first
// site (147x147, 64->128, ~46 FLOP/byte in bf16) is bound by its bytes.
//
// Design, simple and right first: one block owns a tile of 64 positions
// (flattened over B*H*W) x 64 output channels and walks Cin in chunks of
// 32. For each chunk it computes the depthwise for its 64 positions x 32
// channels into shared memory (taps outside the image are zero; sums in
// float32, rounded to x's type as _dw_rows yields x's type), loads the
// matching 32 x 64 slice of pw, and accumulates the product in float32
// registers (a 4x4 tile per thread, SIMT FMAs). The epilogue applies
// y*scale + shift in float32 and stores x's type. The depthwise result
// never reaches device memory, which keeps the TPU kernel's point.
// Known costs, left for a later wgmma/TMA redesign: the depthwise is
// recomputed once per 64-channel output tile (Cout/64 times), and the
// product runs on the CUDA cores, not the tensor cores.

#include "common.cuh"

namespace {

constexpr int TP = 64;        // positions per block
constexpr int TN = 64;        // output channels per block
constexpr int TK = 32;        // input channels per chunk
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 output tile

template <typename T>
__global__ void __launch_bounds__(THREADS)
sep2d_kernel(const T* __restrict__ x, const T* __restrict__ dw9,
             const T* __restrict__ pw, const float* __restrict__ scale,
             const float* __restrict__ shift, T* __restrict__ out, int H,
             int W, int Cin, int Cout, long long P, int relu_in) {
  __shared__ float dw_s[TP][TK + 1];  // depthwise chunk, +1: no bank clash
  __shared__ __align__(16) float pw_s[TK][TN];
  __shared__ int pos_h[TP];
  __shared__ int pos_w[TP];
  __shared__ long long pos_base[TP];  // element offset of (b, h, w, 0)

  const long long p0 = static_cast<long long>(blockIdx.x) * TP;
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  if (tid < TP) {
    const long long p = p0 + tid;
    if (p < P) {
      pos_w[tid] = static_cast<int>(p % W);
      pos_h[tid] = static_cast<int>((p / W) % H);
      pos_base[tid] = p * Cin;
    } else {
      pos_base[tid] = -1;
    }
  }
  const int tx = tid % 16;  // output channels tx*4 .. tx*4+3
  const int ty = tid / 16;  // positions ty*4 .. ty*4+3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < Cin; c0 += TK) {
    // Depthwise: thread owns channel c0 + tid % TK at 8 positions; a warp
    // reads 32 consecutive channels of one pixel (coalesced).
    {
      const int k = tid % TK;
      const int c = c0 + k;
      float wk[9];
#pragma unroll
      for (int j = 0; j < 9; ++j)
        wk[j] = c < Cin ? sparkdl::load_f(dw9 + j * Cin + c) : 0.f;
#pragma unroll
      for (int i = 0; i < TP / (THREADS / TK); ++i) {
        const int pl = tid / TK + i * (THREADS / TK);
        const long long base = pos_base[pl];
        float s = 0.f;
        if (c < Cin && base >= 0) {
          const int hh = pos_h[pl];
          const int ww = pos_w[pl];
#pragma unroll
          for (int dy = -1; dy <= 1; ++dy) {
            if (hh + dy < 0 || hh + dy >= H) continue;
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) {
              if (ww + dx < 0 || ww + dx >= W) continue;
              float v = sparkdl::load_f(
                  x + base + (static_cast<long long>(dy) * W + dx) * Cin + c);
              if (relu_in) v = fmaxf(v, 0.f);
              s = fmaf(v, wk[(dy + 1) * 3 + (dx + 1)], s);
            }
          }
        }
        dw_s[pl][k] = sparkdl::round_as(s, x);
      }
    }
    // Pointwise slice: pw[c0 .. c0+TK) x [n0 .. n0+TN), zero past the edge.
    {
      const int nl = tid % TN;
      const int n = n0 + nl;
#pragma unroll
      for (int i = 0; i < TK / (THREADS / TN); ++i) {
        const int kl = tid / TN + i * (THREADS / TN);
        const int c = c0 + kl;
        pw_s[kl][nl] = (c < Cin && n < Cout)
                           ? sparkdl::load_f(pw + static_cast<long long>(c) *
                                                      Cout + n)
                           : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(&pw_s[k][tx * 4]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = dw_s[ty * 4 + i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pl = ty * 4 + i;
    if (pos_base[pl] < 0) continue;
    T* row = out + (p0 + pl) * Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Cout)
        sparkdl::store_f(row + n,
                         __fadd_rn(__fmul_rn(acc[i][j], scale[n]), shift[n]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* dw9, const void* pw, const void* scale,
           const void* shift, void* out, int B, int H, int W, int Cin,
           int Cout, int relu_in, cudaStream_t stream) {
  const long long P = static_cast<long long>(B) * H * W;
  const long long blocks = (P + TP - 1) / TP;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks), (Cout + TN - 1) / TN);
  sep2d_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dw9),
      static_cast<const T*>(pw), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(out), H, W, Cin,
      Cout, P, relu_in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int sparkdl_sep2d(const void* x, const void* dw9, const void* pw,
                             const void* scale, const void* shift, void* out,
                             int B, int H, int W, int Cin, int Cout,
                             int relu_in, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dw9, pw, scale, shift, out, B, H, W, Cin, Cout,
                         relu_in, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dw9, pw, scale, shift, out, B, H, W, Cin,
                                 Cout, relu_in, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
