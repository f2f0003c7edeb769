// preproc_resize: cast + bilinear resize (half-pixel centres, no
// antialias, edge-clamped) of an NHWC batch; uint8, float32 or bf16 in,
// float32 or bf16 out.
//
// Replaces the Pallas kernel sparkdl_tpu/core/kernels.py::preproc_resize
// (body _preproc_kernel, weights _resize_matrix), which computes
// Wh . X . Ww^T per (image, channel) plane as two MXU products.
//
// What bounds it on an H100: bytes. Each output element needs 4 source
// reads and ~9 FLOPs, so the work is a few GFLOP at most against the
// output write (B*299*299*3*4 bytes in float32) and the source read.
//
// Design: each row of Wh and Ww has at most two non-zeros, so the same
// function is two row taps and two column taps per output element; the
// host builds them from _resize_matrix (same formula, same edge clamping,
// two taps landing on one index summed). One thread writes one output
// element, channels fastest, so neighbouring threads store neighbouring
// addresses. Rows are summed first, then columns (the Wh.X then .Ww^T
// order), with separate multiplies and adds (no FMA contraction), all in
// float32, then rounded once to the output type.

#include "common.cuh"

namespace {

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(256)
preproc_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
               const int* __restrict__ ytap, const float* __restrict__ ywt,
               const int* __restrict__ xtap, const float* __restrict__ xwt,
               int H, int W, int C, int TH, int TW, long long total) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(e % C);
    long long r = e / C;
    const int ox = static_cast<int>(r % TW);
    r /= TW;
    const int oy = static_cast<int>(r % TH);
    const long long b = r / TH;
    const int y0 = ytap[2 * oy], y1 = ytap[2 * oy + 1];
    const float wy0 = ywt[2 * oy], wy1 = ywt[2 * oy + 1];
    const int x0 = xtap[2 * ox], x1 = xtap[2 * ox + 1];
    const float wx0 = xwt[2 * ox], wx1 = xwt[2 * ox + 1];
    const Tin* img = x + b * H * W * C + c;
    const long long r0 = static_cast<long long>(y0) * W;
    const long long r1 = static_cast<long long>(y1) * W;
    const float a00 = sparkdl::load_f(img + (r0 + x0) * C);
    const float a01 = sparkdl::load_f(img + (r0 + x1) * C);
    const float a10 = sparkdl::load_f(img + (r1 + x0) * C);
    const float a11 = sparkdl::load_f(img + (r1 + x1) * C);
    const float t0 = __fadd_rn(__fmul_rn(wy0, a00), __fmul_rn(wy1, a10));
    const float t1 = __fadd_rn(__fmul_rn(wy0, a01), __fmul_rn(wy1, a11));
    sparkdl::store_f(out + e,
                     __fadd_rn(__fmul_rn(wx0, t0), __fmul_rn(wx1, t1)));
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, void* out, const int* ytap, const float* ywt,
           const int* xtap, const float* xwt, int B, int H, int W, int C,
           int TH, int TW, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * TH * TW * C;
  long long blocks = (total + 255) / 256;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  preproc_kernel<Tin, Tout><<<static_cast<unsigned>(blocks), 256, 0,
                              stream>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(out), ytap, ywt, xtap,
      xwt, H, W, C, TH, TW, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int dispatch_out(const void* x, void* out, const int* ytap, const float* ywt,
                 const int* xtap, const float* xwt, int B, int H, int W,
                 int C, int TH, int TW, int out_dtype, cudaStream_t s) {
  if (out_dtype == 0)
    return launch<Tin, float>(x, out, ytap, ywt, xtap, xwt, B, H, W, C, TH,
                              TW, s);
  if (out_dtype == 1)
    return launch<Tin, __nv_bfloat16>(x, out, ytap, ywt, xtap, xwt, B, H, W,
                                      C, TH, TW, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16, 2 = uint8 (input only). ytap/ywt hold
// two (index, weight) taps per output row, xtap/xwt per output column.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int sparkdl_preproc_resize(const void* x, void* out,
                                      const void* ytap, const void* ywt,
                                      const void* xtap, const void* xwt,
                                      int B, int H, int W, int C, int TH,
                                      int TW, int in_dtype, int out_dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* yt = static_cast<const int*>(ytap);
  const float* yw = static_cast<const float*>(ywt);
  const int* xt = static_cast<const int*>(xtap);
  const float* xw = static_cast<const float*>(xwt);
  if (in_dtype == 0)
    return dispatch_out<float>(x, out, yt, yw, xt, xw, B, H, W, C, TH, TW,
                               out_dtype, s);
  if (in_dtype == 1)
    return dispatch_out<__nv_bfloat16>(x, out, yt, yw, xt, xw, B, H, W, C, TH,
                                       TW, out_dtype, s);
  if (in_dtype == 2)
    return dispatch_out<uint8_t>(x, out, yt, yw, xt, xw, B, H, W, C, TH, TW,
                                 out_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
