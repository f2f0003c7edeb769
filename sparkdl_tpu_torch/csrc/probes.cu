// The depthwise probes of experiments/pallas_probe.py, on the padded
// row-major layout the probes share: an (rows, C) bf16 matrix whose row r is
// position p = r % p_pad of image r / p_pad, with (h, w) = (p / W, p % W);
// rows with p >= H*W are the dead pad rows, computed like any other.
//
// - fma9: acc = sum_{i<9} x * k[i] per channel, no shifts (replaces
//   pallas_probe.py::fma9 / _fma9_kernel, the VPU ceiling of any 3x3
//   stencil);
// - dw2d: 3x3 SAME depthwise, tap (dy, dx) read from row r + W*dy + dx and
//   kept only where (h + dy, w + dx) lies inside the H x W image (replaces
//   pallas_probe.py::dw2d / _dw_rows). For a dead row, h = H, so only the
//   dy = -1 taps pass: they read the image's last live row, exactly as the
//   TPU probe's masks let them;
// - sep2d_probe: relu -> dw2d -> bf16 -> (rows, C) x (C, C) product with
//   float32 accumulators -> y * sc + sh in float32 -> bf16 (replaces
//   pallas_probe.py::sep2d / _sep2d_kernel).
//
// Rounding, the same as the plain versions in
// sparkdl_tpu_torch/experiments/probe.py: every product and partial sum of
// the nine taps in float32, without FMA contraction, in tap order
// (dy, dx row-major), rounded to bf16 once.
//
// What bounds them on an H100: fma9 and dw2d do 18 FLOP per element
// against 4 bytes moved (one bf16 read, one written): bound by bytes
// (47,104 x 728 bf16 each way at the probe's B = 128: >= 0.041 ms at
// 3.35 TB/s). One thread owns 8 channels of a row: one 16-byte load per
// tap, neighbouring threads on neighbouring addresses; dw2d's eight
// neighbour rows come again from L1/L2, so device memory sees each input
// byte about once. sep2d_probe is bound by its pointwise product
// (2 * C * C FLOP a row, ~1,450 FLOP per byte moved): >= 0.050 ms on the
// bf16 tensor cores. One block owns 64 rows: it builds their depthwise
// (64 x C bf16, ~93 KB) in shared memory once, then walks the output
// channels in tiles of 128 with mma.sync m16n8k16 (8 warps, 32 x 32 each),
// staging 32 x 128 slices of pw through shared memory. The depthwise
// result never reaches device memory, the TPU kernel's point. Left for
// later: wgmma/TMA, and overlapping the pw loads with the product.

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

using sparkdl::copy8;
using sparkdl::mma16816;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// ---------------------------------------------------------------------------
// fma9
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
fma9_kernel(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ k9,
            __nv_bfloat16* __restrict__ out, long long octets, int C) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= octets) return;
  const int c = static_cast<int>(i % (C / 8)) * 8;
  float xv[8], kv[8], acc[8];
  load8(x + i * 8, xv);
  load8(k9 + c, kv);
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = __fmul_rn(xv[e], kv[e]);
#pragma unroll
  for (int j = 1; j < 9; ++j) {
    load8(k9 + j * C + c, kv);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(xv[e], kv[e]));
  }
  store8(out + i * 8, acc);
}

// ---------------------------------------------------------------------------
// dw2d (and the depthwise of sep2d_probe)
// ---------------------------------------------------------------------------

// The depthwise of 8 channels from c of row `row`, in float32 (RELU: of
// relu(x)), summed in tap order.
template <bool RELU>
__device__ __forceinline__ void dw_octet(const __nv_bfloat16* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ k9,
                                         long long row, int c, long long rows,
                                         int C, int p_pad, int H, int W,
                                         float acc[8]) {
  const int p = static_cast<int>(row % p_pad);
  const int h = p / W;
  const int w = p % W;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int dy = j / 3 - 1;
    const int dx = j % 3 - 1;
    const long long src = row + W * dy + dx;
    if (h + dy < 0 || h + dy > H - 1 || w + dx < 0 || w + dx > W - 1 ||
        src < 0 || src >= rows)
      continue;
    float xv[8], kv[8];
    load8(x + src * C + c, xv);
    load8(k9 + j * C + c, kv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = RELU ? fmaxf(xv[e], 0.f) : xv[e];
      acc[e] = __fadd_rn(acc[e], __fmul_rn(v, kv[e]));
    }
  }
}

__global__ void __launch_bounds__(256)
dw2d_kernel(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ k9,
            __nv_bfloat16* __restrict__ out, long long rows, int C, int p_pad,
            int H, int W) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= rows * (C / 8)) return;
  const long long row = i / (C / 8);
  const int c = static_cast<int>(i % (C / 8)) * 8;
  float acc[8];
  dw_octet<false>(x, k9, row, c, rows, C, p_pad, H, W, acc);
  store8(out + row * C + c, acc);
}

// ---------------------------------------------------------------------------
// sep2d_probe
// ---------------------------------------------------------------------------

namespace sep {

constexpr int BM = 64;        // rows per block
constexpr int BN = 128;       // output channels per pass
constexpr int BK = 32;        // input channels per pw stage (two k16 steps)
constexpr int THREADS = 256;  // eight warps, 2 x 4, each 32 rows x 32 ch.
constexpr int BPAD = 8;       // Bs rows of 136 values: 272 bytes, 4 banks on
constexpr int TPAD = 8;       // T rows of Kr + 8 values (744 at C = 728:
                              // 372 words, 20 banks on: conflict-free reads)

// Kr: C rounded up to BK; the dynamic shared tile T is BM x (Kr + TPAD).
__host__ __device__ constexpr int padded_k(int C) {
  return (C + BK - 1) / BK * BK;
}

__global__ void __launch_bounds__(THREADS)
sep2d_probe_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ k9,
                   const uint16_t* __restrict__ pw,
                   const __nv_bfloat16* __restrict__ sc,
                   const __nv_bfloat16* __restrict__ sh,
                   __nv_bfloat16* __restrict__ out, long long rows, int C,
                   int p_pad, int H, int W) {
  extern __shared__ __align__(16) uint16_t T[];  // depthwise, BM x ldt
  __shared__ __align__(16) uint16_t Bs[BK][BN + BPAD];
  const int Kr = padded_k(C);
  const int ldt = Kr + TPAD;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int tid = threadIdx.x;

  // Phase 1: the depthwise of relu(x) for the block's rows, rounded to
  // bf16, into T; zero past C and past the last row.
  const int oct_row = Kr / 8;
  for (int q = tid; q < BM * oct_row; q += THREADS) {
    const int r = q / oct_row;
    const int c = (q % oct_row) * 8;
    float acc[8];
    if (m0 + r < rows && c < C) {
      dw_octet<true>(x, k9, m0 + r, c, rows, C, p_pad, H, W, acc);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    }
    store8(reinterpret_cast<__nv_bfloat16*>(&T[r * ldt + c]), acc);
  }
  __syncthreads();

  // Phase 2: out[rows, n0:n0+BN] = T x pw[:, n0:n0+BN], then the affine.
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = (warp / 4) * 32;  // warp's first row in the block tile
  const int wn = (warp % 4) * 32;  // warp's first channel in the pass
  const int g = lane / 4;
  const int t = lane % 4;
  for (int n0 = 0; n0 < C; n0 += BN) {
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    for (int k0 = 0; k0 < Kr; k0 += BK) {
      // pw: 32 rows x 128 channels = 512 octets, two per thread
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tid + i * THREADS;
        const int br = q / (BN / 8);
        const int bn = (q % (BN / 8)) * 8;
        copy8<true>(pw, k0 + br, n0 + bn, C, C, &Bs[br][bn]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[2][4];
        uint32_t b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const uint16_t* ta = &T[(wm + mi * 16 + g) * ldt + k0 + kk + 2 * t];
          a[mi][0] = *reinterpret_cast<const uint32_t*>(ta);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(ta + 8 * ldt);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(ta + 8);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(ta + 8 * ldt + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = wn + ni * 8 + g;
          const int k = kk + 2 * t;
          b[ni][0] = sparkdl::pack(Bs[k][n], Bs[k + 1][n]);
          b[ni][1] = sparkdl::pack(Bs[k + 8][n], Bs[k + 9][n]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma16816(acc[mi][ni], a[mi], b[ni]);
      }
      __syncthreads();
    }

    // Accumulator fragment: d0, d1 at (g, 2t), (g, 2t+1); d2, d3 eight
    // rows on.
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + wn + ni * 8 + 2 * t + e;
        if (n >= C) continue;
        const float s = __bfloat162float(sc[n]);
        const float b = __bfloat162float(sh[n]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const long long m = m0 + wm + mi * 16 + g + hh * 8;
            if (m >= rows) continue;
            const float y = __fadd_rn(__fmul_rn(acc[mi][ni][2 * hh + e], s), b);
            out[m * C + n] = __float2bfloat16_rn(y);
          }
        }
      }
    }
  }
}

size_t smem_bytes(int C) {
  return static_cast<size_t>(BM) * (padded_k(C) + TPAD) * sizeof(uint16_t);
}

}  // namespace sep

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The probes take C a multiple of 8 and 16-byte aligned rows.
bool layout_ok(long long rows, int C, const void* x, const void* k9,
               const void* out) {
  return rows > 0 && C > 0 && C % 8 == 0 && aligned16(x) && aligned16(k9) &&
         aligned16(out);
}

bool grid_1d(long long threads, int block, unsigned* blocks) {
  const long long n = (threads + block - 1) / block;
  if (n <= 0 || n > 0x7fffffffLL) return false;
  *blocks = static_cast<unsigned>(n);
  return true;
}

}  // namespace

// x, k9 (9, C) and out are bf16; x and out (rows, C). Each entry point
// returns cudaGetLastError() after its launch (0 = launched).
extern "C" int sparkdl_fma9(const void* x, const void* k9, void* out,
                            long long rows, int C, void* stream) {
  unsigned blocks;
  if (!layout_ok(rows, C, x, k9, out) || !grid_1d(rows * (C / 8), 256, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  fma9_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(k9), static_cast<__nv_bfloat16*>(out),
      rows * (C / 8), C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sparkdl_dw2d(const void* x, const void* k9, void* out,
                            long long rows, int C, int p_pad, int H, int W,
                            void* stream) {
  unsigned blocks;
  if (!layout_ok(rows, C, x, k9, out) || p_pad <= 0 || H <= 0 || W <= 0 ||
      !grid_1d(rows * (C / 8), 256, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  dw2d_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(k9), static_cast<__nv_bfloat16*>(out),
      rows, C, p_pad, H, W);
  return static_cast<int>(cudaGetLastError());
}

// pw (C, C), sc and sh (C,) are bf16 too.
extern "C" int sparkdl_sep2d_probe(const void* x, const void* k9,
                                   const void* pw, const void* sc,
                                   const void* sh, void* out, long long rows,
                                   int C, int p_pad, int H, int W,
                                   void* stream) {
  unsigned blocks;
  if (!layout_ok(rows, C, x, k9, out) || !aligned16(pw) || p_pad <= 0 ||
      H <= 0 || W <= 0 || !grid_1d(rows, sep::BM, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sep::smem_bytes(C);
  // Set once per device, before any launch a CUDA graph may capture.
  static int smem_set[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem_set[dev] < static_cast<int>(smem)) {
    err = cudaFuncSetAttribute(sep::sep2d_probe_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = static_cast<int>(smem);
  }
  sep::sep2d_probe_kernel<<<blocks, sep::THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(k9),
      static_cast<const uint16_t*>(pw), static_cast<const __nv_bfloat16*>(sc),
      static_cast<const __nv_bfloat16*>(sh), static_cast<__nv_bfloat16*>(out),
      rows, C, p_pad, H, W);
  return static_cast<int>(cudaGetLastError());
}
