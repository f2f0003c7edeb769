// pw1x1: a 1x1 stride-1 conv as one GEMM with the folded-BN epilogue
// fused: out[m, n] = relu?(sum_k x[m, k] * w[n, k] * scale[n] + shift[n]),
// x the (M, Cin) row-major view of an NHWC activation, w (Cout, Cin) (the
// conv weight's own layout, K contiguous; the float32 body takes (Cin,
// Cout)), float32 accumulation, float32 affine, stored in x's type
// (float32/bf16).
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
// cores: bound by operations. At 8x8 the whole product is small (M =
// 1,024 rows at B = 16), so the tile grid alone does not fill 132 SMs.
//
// Three bodies; the plan (core/kernels.py::plan_pw1x1) picks one, its
// tile width and its split of K, and this launcher checks the plan:
// - wgmma (bf16, Cin a multiple of 8): the Hopper mainloop of
//   wgmma_bf16.cuh. A block owns 64 rows x BN channels (BN 32, 48, 64 or
//   128, fitted to Cout). One producer warp keeps TMA loads of 64 x 64 x
//   tiles and BN x 64 w tiles in flight through a ring of 2-4 stages;
//   one consumer warpgroup runs wgmma m64nBNk16 on each stage as it
//   lands. TMA zero-fills past every ragged edge (rows, Cin, Cout).
// - mma (bf16 whose Cin TMA cannot stride): warp-level mma.sync m16n8k16
//   on 64 x 64 tiles, one stage, scalar loads with zero fill.
// - simt_f32 (float32): the float32 mainloop of simt_f32.cuh, shared with
//   sep2d: producer warps staging by TMA (cp.async where the rows do not
//   allow it), consumer warps on 8 x 8 float32 register tiles, persistent
//   blocks sized per site; w comes as (Cin, Cout) here. TF32 tensor cores
//   would miss the float32 contract of 1e-5 relative. Where the tile grid
//   is under one wave it splits K over a cluster of two blocks that add
//   their partial tiles through distributed shared memory in split order:
//   one launch.
// Split-K (wgmma): where the tile grid is under one wave, block z of
// `splits` sums its share of the K chunks into a float32 workspace
// (splits, M, Cout); a second launch adds the shares in split order and
// applies the epilogue. Epilogue: y*scale + shift in float32 (no FMA
// contraction, as the plain version rounds the product and the sum
// apart), then ReLU, then the store.

#include "common.cuh"
#include "mma_bf16.cuh"
#include "simt_f32.cuh"
#include "wgmma_bf16.cuh"

namespace {

enum Body { MMA = 1, WGMMA = 2, SIMT_F32 = 3 };

// K chunks [begin, end) of split z of `splits` over `chunks` chunks; the
// plan computes the same ranges.
__device__ __forceinline__ void split_range(int chunks, int splits, int z,
                                            int* begin, int* end) {
  *begin = static_cast<int>(static_cast<long long>(z) * chunks / splits);
  *end = static_cast<int>(static_cast<long long>(z + 1) * chunks / splits);
}

__device__ __forceinline__ float affine(float acc, const float* scale,
                                        const float* shift, int n, int relu) {
  float y = __fadd_rn(__fmul_rn(acc, scale[n]), shift[n]);
  return relu ? fmaxf(y, 0.f) : y;
}

// ---------------------------------------------------------------------------
// bf16, any Cin: warp-level tensor cores (mma.sync)
// ---------------------------------------------------------------------------

namespace mma {

constexpr int BM = 64;       // rows per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // input channels per stage (two k16 steps)
constexpr int THREADS = 128; // four warps, 2 x 2, each 32 rows x 32 channels
constexpr int PAD = 8;       // rows of 40 values: 80 bytes, 20 banks apart

using sparkdl::copy8;
using sparkdl::mma16816;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
pw1x1_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ shift,
             __nv_bfloat16* __restrict__ out, long long N, int Cin, int Cout,
             int relu) {
  __shared__ __align__(16) uint16_t As[BM][BK + PAD];  // x chunk, k fastest
  __shared__ __align__(16) uint16_t Bs[BN][BK + PAD];  // w chunk, k fastest

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
    // x: 64 rows x 32 channels = 256 octets; w: the same.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * THREADS;
      const int r = q / (BK / 8);
      const int k = (q % (BK / 8)) * 8;
      copy8<VEC>(x, m0 + r, k0 + k, N, Cin, &As[r][k]);
      copy8<VEC>(w, n0 + r, k0 + k, Cout, Cin, &Bs[r][k]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
      uint32_t b[4][2];
      const int c = kk + 2 * t;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][c]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][c + 8]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][c]);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][c + 8]);
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
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = m0 + wm + mi * 16 + g + h * 8;
          if (m >= N) continue;
          sparkdl::store_f(out + m * Cout + n,
                           affine(acc[mi][ni][2 * h + e], scale, shift, n,
                                  relu));
        }
      }
    }
  }
}

}  // namespace mma

// ---------------------------------------------------------------------------
// bf16, Cin a multiple of 8: the Hopper mainloop (TMA + wgmma)
// ---------------------------------------------------------------------------

namespace tc {

namespace hp = sparkdl::hopper;

constexpr int BM = 64;              // rows per block: one consumer warpgroup
constexpr int THREADS = 128 + 32;   // the consumers, then the producer warp
constexpr int MAX_STAGES = 4;
constexpr int A_BYTES = BM * hp::ROW_BYTES;

template <int BN>
constexpr int smem_bytes(int stages) {
  return hp::TILE_ALIGN + stages * (A_BYTES + BN * hp::ROW_BYTES) +
         2 * MAX_STAGES * 8;
}

template <int BN>
__global__ void __launch_bounds__(THREADS)
pw1x1_kernel(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap wmap,
             const float* __restrict__ scale, const float* __restrict__ shift,
             __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
             long long N, int Cin, int Cout, int relu, int stages,
             int splits) {
  constexpr int B_BYTES = BN * hp::ROW_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + hp::TILE_ALIGN - 1) &
      ~static_cast<uintptr_t>(hp::TILE_ALIGN - 1));
  uint8_t* a_tiles = smem;
  uint8_t* b_tiles = smem + stages * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(b_tiles + stages * B_BYTES);
  uint64_t* empty = full + MAX_STAGES;

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  int kb, ke;
  split_range((Cin + hp::KCHUNK - 1) / hp::KCHUNK, splits, blockIdx.z, &kb,
              &ke);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 128);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {  // producer warp: one thread issues every load
    if (tid == 128) {
      for (int c = kb, i = 0; c < ke; ++c, ++i) {
        const int s = i % stages;
        hp::mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
        hp::mbar_arrive_tx(&full[s], A_BYTES + B_BYTES);
        hp::tma_load_2d(a_tiles + s * A_BYTES, &xmap, c * hp::KCHUNK,
                        static_cast<int>(m0), &full[s]);
        hp::tma_load_2d(b_tiles + s * B_BYTES, &wmap, c * hp::KCHUNK, n0,
                        &full[s]);
      }
    }
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int c = kb, i = 0; c < ke; ++c, ++i) {
    const int s = i % stages;
    hp::mbar_wait(&full[s], (i / stages) & 1);
    hp::mma_stage<BN>(acc, hp::smem_addr(a_tiles + s * A_BYTES),
                      hp::smem_addr(b_tiles + s * B_BYTES));
    hp::mbar_arrive(&empty[s]);
  }

  float* part = ws + static_cast<long long>(blockIdx.z) * N * Cout;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long m = m0 + hp::frag_row(tid, e);
      const int n = n0 + hp::frag_col(tid, j, e);
      if (m >= N || n >= Cout) continue;
      if (splits > 1)
        part[m * Cout + n] = acc[4 * j + e];
      else
        sparkdl::store_f(out + m * Cout + n,
                         affine(acc[4 * j + e], scale, shift, n, relu));
    }
  }
}

template <int BN>
int launch(const void* x, const void* w, const float* scale,
           const float* shift, void* out, float* ws, long long N, int Cin,
           int Cout, int relu, int stages, int splits, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  if (!hp::encode_bf16_2d(&xmap, x, N, Cin, BM, hp::KCHUNK, true) ||
      !hp::encode_bf16_2d(&wmap, w, Cout, Cin, BN, hp::KCHUNK, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes<BN>(stages);
  static int allowed = 0;  // this instantiation's raised smem limit
  if (smem > allowed) {
    const int err = hp::allow_smem(pw1x1_kernel<BN>, smem);
    if (err != 0) return err;
    allowed = smem;
  }
  dim3 grid(static_cast<unsigned>((N + BM - 1) / BM), (Cout + BN - 1) / BN,
            splits);
  pw1x1_kernel<BN><<<grid, THREADS, smem, stream>>>(
      xmap, wmap, scale, shift, static_cast<__nv_bfloat16*>(out), ws, N, Cin,
      Cout, relu, stages, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Split-K: the shares summed in split order, then the epilogue
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
splitk_reduce(const float* __restrict__ ws, const float* __restrict__ scale,
              const float* __restrict__ shift, T* __restrict__ out,
              long long total, int Cout, int splits, int relu) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[z * total + i];
    sparkdl::store_f(out + i,
                     affine(s, scale, shift, static_cast<int>(i % Cout),
                            relu));
  }
}

template <typename T>
int reduce(const float* ws, const float* scale, const float* shift,
           void* out, long long N, int Cout, int splits, int relu,
           cudaStream_t stream) {
  const long long total = N * Cout;
  const long long blocks = (total + 255) / 256;
  splitk_reduce<T><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                     256, 0, stream>>>(ws, scale, shift,
                                       static_cast<T*>(out), total, Cout,
                                       splits, relu);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int launch_mma(const void* x, const void* w, const float* scale,
               const float* shift, void* out, long long N, int Cin, int Cout,
               int relu, cudaStream_t stream) {
  const long long blocks = (N + mma::BM - 1) / mma::BM;
  const bool vec = Cin % 8 == 0 && aligned16(x) && aligned16(w);
  const uint16_t* xb = static_cast<const uint16_t*>(x);
  const uint16_t* wb = static_cast<const uint16_t*>(w);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  dim3 grid(static_cast<unsigned>(blocks), (Cout + mma::BN - 1) / mma::BN);
  if (vec)
    mma::pw1x1_kernel<true><<<grid, mma::THREADS, 0, stream>>>(
        xb, wb, scale, shift, ob, N, Cin, Cout, relu);
  else
    mma::pw1x1_kernel<false><<<grid, mma::THREADS, 0, stream>>>(
        xb, wb, scale, shift, ob, N, Cin, Cout, relu);
  return static_cast<int>(cudaGetLastError());
}

int launch_wgmma(const void* x, const void* w, const float* scale,
                 const float* shift, void* out, float* ws, long long N,
                 int Cin, int Cout, int relu, int bn, int stages, int splits,
                 cudaStream_t stream) {
  switch (bn) {
    case 32: return tc::launch<32>(x, w, scale, shift, out, ws, N, Cin, Cout,
                                   relu, stages, splits, stream);
    case 48: return tc::launch<48>(x, w, scale, shift, out, ws, N, Cin, Cout,
                                   relu, stages, splits, stream);
    case 64: return tc::launch<64>(x, w, scale, shift, out, ws, N, Cin, Cout,
                                   relu, stages, splits, stream);
    case 128: return tc::launch<128>(x, w, scale, shift, out, ws, N, Cin,
                                     Cout, relu, stages, splits, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan, checked: a body this launcher has for the dtype, its tile
// width, stages and splits in range, a workspace where K is split.
bool plan_ok(long long N, int Cin, int Cout, int dtype, int body, int bn,
             int stages, int splits, const void* x, const void* w,
             const void* ws) {
  if (N <= 0 || Cin <= 0 || Cout <= 0 || splits < 1 || splits > 64)
    return false;
  if ((splits > 1) != (ws != nullptr)) return false;
  if (body == MMA)
    return dtype == 1 && bn == mma::BN && splits == 1 &&
           (N + mma::BM - 1) / mma::BM <= 0x7fffffffLL;
  if (body == WGMMA)
    return dtype == 1 && Cin % 8 == 0 && aligned16(x) && aligned16(w) &&
           (bn == 32 || bn == 48 || bn == 64 || bn == 128) && stages >= 2 &&
           stages <= tc::MAX_STAGES && N <= 0x7fffffffLL &&
           splits <= (Cin + sparkdl::hopper::KCHUNK - 1) /
                         sparkdl::hopper::KCHUNK;
  return false;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x is (N, Cin), w (Cout, Cin; (Cin,
// Cout) for simt_f32), both in dtype; scale and shift (Cout,) float32; out (N, Cout) in dtype. body,
// bn, stages, splits, bm, producers, blocks: the launch plan
// (core/kernels.py::plan_pw1x1); ws a float32 (splits, N, Cout) workspace
// when the wgmma body splits K, else null. Returns cudaErrorInvalidValue
// for a plan it cannot run, else cudaGetLastError() after the launches
// (0 = launched).
extern "C" int sparkdl_pw1x1(const void* x, const void* w, const void* scale,
                             const void* shift, void* out, void* ws,
                             long long N, int Cin, int Cout, int relu,
                             int dtype, int body, int bn, int stages,
                             int splits, int bm, int producers, int blocks,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == SIMT_F32) {
    namespace s32 = sparkdl::simt32;
    if (dtype != 0 || ws != nullptr || N <= 0 || N > 0x7fffffffLL ||
        bm <= 0 || bm % 8 != 0 || bn <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    s32::Params p = {};
    p.x = static_cast<const float*>(x);
    p.w = static_cast<const float*>(w);
    p.scale = static_cast<const float*>(scale);
    p.shift = static_cast<const float*>(shift);
    p.out = static_cast<float*>(out);
    p.M = static_cast<int>(N);
    p.Cin = Cin;
    p.Cout = Cout;
    p.relu = relu;
    p.ty = bm / 8;
    p.producers = producers;
    p.stages = stages;
    p.splits = splits;
    p.chunks = (Cin + s32::KC - 1) / s32::KC;
    p.tiles_n = (Cout + bn - 1) / bn;
    p.groups = p.tiles_n;
    p.units = static_cast<int>((N + bm - 1) / bm) * p.tiles_n;
    return s32::launch<false>(p, bn, blocks, s);
  }
  if (!plan_ok(N, Cin, Cout, dtype, body, bn, stages, splits, x, w, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* part = static_cast<float*>(ws);
  const int err =
      body == MMA ? launch_mma(x, w, sc, sh, out, N, Cin, Cout, relu, s)
                  : launch_wgmma(x, w, sc, sh, out, part, N, Cin, Cout, relu,
                                 bn, stages, splits, s);
  if (err != 0 || splits == 1) return err;
  return reduce<__nv_bfloat16>(part, sc, sh, out, N, Cout, splits, relu, s);
}
