// pw1x1: a 1x1 stride-1 conv as one GEMM with the folded-BN epilogue
// fused: out[n, c] = relu?(sum_k x[n, k] * w[k, c] * scale[c] + shift[c]),
// x the (N, Cin) row-major view of an NHWC activation, w (Cin, Cout),
// float32 accumulation, float32 affine, stored in x's type (float32/bf16).
//
// Replaces the Pallas kernel sparkdl_tpu/core/kernels.py::pw1x1 (body
// _pw1x1_kernel), which runs the product on the MXU over row blocks of the
// flattened positions, with the whole (Cin, Cout) weight held in VMEM.
//
// What bounds it on an H100: InceptionV3's 1x1 sites do 2*Cin*Cout FLOP per
// position against (Cin + Cout) activations. In bf16 that is ~48 FLOP/byte
// at 35x35 (192->64) and ~154 at 17x17 (768->192), under the tensor cores'
// ~295 FLOP/byte ridge: those sites are bound by their bytes; the 8x8
// 2048->448 site (~367) is bound by its operations. In float32 every site
// (24-184 FLOP/byte) is far above the ~20 FLOP/byte ridge of the CUDA
// cores: bound by operations.
//
// Design, simple and right first. Blocks tile (rows, output channels) and
// walk Cin in chunks staged in shared memory with 16-byte loads where the
// row widths and pointers allow it, zero-filling past every ragged edge
// (N, Cin and Cout), so no padding is needed on the host. The epilogue
// applies y*scale + shift in float32 (no FMA contraction, as the plain
// version rounds the product and the sum apart), then ReLU, then stores.
// - float32: SIMT FMAs on the CUDA cores, a 128 x 64 tile per block, an
//   8 x 4 register tile per thread. TF32 tensor cores would miss the
//   float32 contract of 1e-5 relative.
// - bf16: warp-level tensor cores (mma.sync m16n8k16, float32
//   accumulators), a 64 x 64 tile per block of four warps, each warp a
//   32 x 32 tile. Fragments are read from shared memory with 32-bit
//   (x, k-contiguous) and 16-bit (w, n-contiguous) loads on padded rows
//   that keep each warp's reads free of bank conflicts.
// Left for a later wgmma/TMA redesign: no overlap of the global loads with
// the product (one stage), no ldmatrix, and tiles of 64 output channels
// even where Cout is 32 or 48.

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: SIMT
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BM = 128;      // rows per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 16;       // input channels per stage
constexpr int THREADS = 256; // 16 x 16 threads, each 8 rows x 4 channels
constexpr int APAD = 4;      // keeps As rows 16-byte aligned

// Four consecutive values of row `row` from column `col` of a row-major
// (rows, cols) matrix, zero outside it.
template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ p,
                                      long long row, int col, long long rows,
                                      int cols, float v[4]) {
  if (row < rows) {
    const float* src = p + row * cols + col;
    if (VEC && col + 3 < cols) {
      const float4 t = *reinterpret_cast<const float4*>(src);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = col + j < cols ? src[j] : 0.f;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = 0.f;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
pw1x1_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ shift,
             float* __restrict__ out, long long N, int Cin, int Cout,
             int relu) {
  __shared__ __align__(16) float As[BK][BM + APAD];  // x chunk, k-major
  __shared__ __align__(16) float Bs[BK][BN];         // w chunk

  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channels tx*4 .. tx*4+3
  const int ty = tid / 16;  // rows ty*8 .. ty*8+7
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += BK) {
    // x: BM rows x BK channels = 512 quads, two per thread, stored k-major
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * THREADS;
      const int r = q / (BK / 4);
      const int kq = (q % (BK / 4)) * 4;
      float v[4];
      load4<VEC>(x, m0 + r, k0 + kq, N, Cin, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) As[kq + j][r] = v[j];
    }
    // w: BK rows x BN channels = 256 quads, one per thread
    {
      const int r = tid / (BN / 4);
      const int c = (tid % (BN / 4)) * 4;
      float v[4];
      load4<VEC>(w, k0 + r, n0 + c, Cin, Cout, v);
      *reinterpret_cast<float4*>(&Bs[r][c]) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * 8 + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= Cout) continue;
    const float sc = scale[n];
    const float sh = shift[n];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long m = m0 + ty * 8 + i;
      if (m >= N) continue;
      float y = __fadd_rn(__fmul_rn(acc[i][j], sc), sh);
      if (relu) y = fmaxf(y, 0.f);
      out[m * Cout + n] = y;
    }
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: warp-level tensor cores (mma.sync)
// ---------------------------------------------------------------------------

namespace bf16 {

constexpr int BM = 64;       // rows per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // input channels per stage (two k16 steps)
constexpr int THREADS = 128; // four warps, 2 x 2, each 32 rows x 32 channels
constexpr int APAD = 8;      // As rows of 40 values: 80 bytes, 20 banks apart
constexpr int BPAD = 8;      // Bs rows of 72 values: 144 bytes, 4 banks apart

using sparkdl::copy8;
using sparkdl::mma16816;
using sparkdl::pack;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
pw1x1_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ shift,
             __nv_bfloat16* __restrict__ out, long long N, int Cin, int Cout,
             int relu) {
  __shared__ __align__(16) uint16_t As[BM][BK + APAD];  // x chunk, k fastest
  __shared__ __align__(16) uint16_t Bs[BK][BN + BPAD];  // w chunk, n fastest

  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = (warp / 2) * 32;  // warp's first row in the block tile
  const int wn = (warp % 2) * 32;  // warp's first channel
  const int g = lane / 4;          // fragment row / column group
  const int t = lane % 4;          // thread within the group
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += BK) {
    // x: 64 rows x 32 channels = 256 octets; w: 32 x 64 = 256 octets.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * THREADS;
      const int ar = q / (BK / 8);
      const int ak = (q % (BK / 8)) * 8;
      copy8<VEC>(x, m0 + ar, k0 + ak, N, Cin, &As[ar][ak]);
      const int br = q / (BN / 8);
      const int bn = (q % (BN / 8)) * 8;
      copy8<VEC>(w, k0 + br, n0 + bn, Cin, Cout, &Bs[br][bn]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
      uint32_t b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        const int c = kk + 2 * t;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][c]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][c + 8]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g;
        const int k = kk + 2 * t;
        b[ni][0] = pack(Bs[k][n], Bs[k + 1][n]);
        b[ni][1] = pack(Bs[k + 8][n], Bs[k + 9][n]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma16816(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // Accumulator fragment: d0, d1 at (g, 2t), (g, 2t+1); d2, d3 eight rows on.
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn + ni * 8 + 2 * t + e;
      if (n >= Cout) continue;
      const float sc = scale[n];
      const float sh = shift[n];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = m0 + wm + mi * 16 + g + h * 8;
          if (m >= N) continue;
          float y = __fadd_rn(__fmul_rn(acc[mi][ni][2 * h + e], sc), sh);
          if (relu) y = fmaxf(y, 0.f);
          sparkdl::store_f(out + m * Cout + n, y);
        }
      }
    }
  }
}

}  // namespace bf16

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int BM, int BN>
bool grid_for(long long N, int Cout, dim3* grid) {
  const long long blocks = (N + BM - 1) / BM;
  if (blocks > 0x7fffffffLL) return false;
  *grid = dim3(static_cast<unsigned>(blocks), (Cout + BN - 1) / BN);
  return true;
}

int launch_f32(const void* x, const void* w, const float* scale,
               const float* shift, void* out, long long N, int Cin, int Cout,
               int relu, cudaStream_t stream) {
  dim3 grid;
  if (!grid_for<f32::BM, f32::BN>(N, Cout, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = Cin % 4 == 0 && Cout % 4 == 0 && aligned16(x) &&
                   aligned16(w);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  if (vec)
    f32::pw1x1_kernel<true><<<grid, f32::THREADS, 0, stream>>>(
        xf, wf, scale, shift, of, N, Cin, Cout, relu);
  else
    f32::pw1x1_kernel<false><<<grid, f32::THREADS, 0, stream>>>(
        xf, wf, scale, shift, of, N, Cin, Cout, relu);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* x, const void* w, const float* scale,
                const float* shift, void* out, long long N, int Cin, int Cout,
                int relu, cudaStream_t stream) {
  dim3 grid;
  if (!grid_for<bf16::BM, bf16::BN>(N, Cout, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = Cin % 8 == 0 && Cout % 8 == 0 && aligned16(x) &&
                   aligned16(w);
  const uint16_t* xb = static_cast<const uint16_t*>(x);
  const uint16_t* wb = static_cast<const uint16_t*>(w);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  if (vec)
    bf16::pw1x1_kernel<true><<<grid, bf16::THREADS, 0, stream>>>(
        xb, wb, scale, shift, ob, N, Cin, Cout, relu);
  else
    bf16::pw1x1_kernel<false><<<grid, bf16::THREADS, 0, stream>>>(
        xb, wb, scale, shift, ob, N, Cin, Cout, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x is (N, Cin), w (Cin, Cout), both in
// dtype; scale and shift (Cout,) float32; out (N, Cout) in dtype. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int sparkdl_pw1x1(const void* x, const void* w, const void* scale,
                             const void* shift, void* out, long long N,
                             int Cin, int Cout, int relu, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (dtype == 0)
    return launch_f32(x, w, sc, sh, out, N, Cin, Cout, relu, s);
  if (dtype == 1)
    return launch_bf16(x, w, sc, sh, out, N, Cin, Cout, relu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
