// sep2d: optional ReLU -> 3x3 SAME stride-1 depthwise -> 1x1 pointwise
// product (float32 accumulate) -> folded-BN affine, NHWC, float32 or bf16.
// The pointwise weight comes as (Cout, Cin), K contiguous.
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
// Three bodies; the plan (core/kernels.py::plan_sep2d) picks one and its
// tile, and the launchers check the plan.
//
// wgmma (bf16, Cin a multiple of 8), on the Hopper mainloop of
// wgmma_bf16.cuh. A tile is 64 positions (flattened over B*H*W) x BN
// output channels (BN = 64, 128 or 256: one tile for Cout <= 256, so the
// depthwise of a position tile is computed ceil(Cout / 256) times at
// most); Cin is walked in chunks of 64. Blocks are persistent, one per
// SM, each walking tiles in turn with four warpgroups:
// - two producer warpgroups. Per chunk, one TMA load stages the tile's
//   x rows and their halo (the W + 1 rows before and after: every tap of
//   the 64 positions) into a ring of 2-4 halo slots, up to three chunks
//   ahead; the producers compute the depthwise from there in float32
//   (ReLU first where asked, taps outside the image zeroed), round it to
//   bf16 as _dw_rows yields x's type, and write it into the stage's A
//   tile in the 128-byte swizzled layout the descriptors name, then
//   fence it for the async proxy before they arrive on the stage's
//   barrier. Thread 0 of them also loads the chunk's BN x 64 slice of
//   pw into the stage's B tile by TMA.
// - two consumer warpgroups, each owning BN / 2 channels, run wgmma
//   m64n(BN/2)k16 on each stage as it is released, so the CUDA-core
//   depthwise of chunk k+1 overlaps the tensor-core product of chunk k
//   through a ring of 2-4 stages. The ring runs on across tiles, so one
//   tile's epilogue overlaps the next one's depthwise.
// The epilogue applies y*scale + shift in float32 (no FMA contraction),
// rounds to bf16 (nearest even), and stages each warpgroup's rows in
// shared memory for 16-byte stores. The depthwise result never reaches
// device memory, which keeps the TPU kernel's point.
//
// simt_f32 (float32): the float32 mainloop of simt_f32.cuh, shared with
// pw1x1. Producer warps stage each K chunk's halo, taps and pw slice (by
// TMA where the rows allow it) a ring of stages ahead and compute the
// depthwise of a row tile once per chunk into a block-resident D (all of
// Cin) that every N tile of the unit reads (or one chunk of D, recomputed
// per N tile, where all of Cin does not fit); consumer warps run 8 x 8
// float32 register tiles; persistent blocks sized per site. pw comes as
// (Cin, Cout) here. TF32 tensor cores would miss the float32 contract of
// 1e-5 relative.
//
// simt_bf16 (bf16 whose rows TMA cannot stride: Cin % 8 != 0 or an
// unaligned operand): one block owns 128 positions x 128 output channels
// and walks Cin in chunks of 32. Per chunk it stages the tile's x rows and
// halo in shared memory, computes their depthwise once from there, stages
// the chunk's slice of pw, and accumulates the product in an 8 x 8 float32
// register tile per thread, two blocks per SM.

#include "common.cuh"
#include "simt_f32.cuh"
#include "wgmma_bf16.cuh"

namespace {

enum Body { SIMT_BF16 = 0, WGMMA = 2, SIMT_F32 = 3 };

__device__ __forceinline__ float affine(float acc, const float* scale,
                                        const float* shift, int n) {
  return __fadd_rn(__fmul_rn(acc, scale[n]), shift[n]);
}

// ---------------------------------------------------------------------------
// simt_bf16
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BM = 128;       // positions per block
constexpr int BN = 128;       // output channels per block
constexpr int KC = 32;        // input channels per chunk
constexpr int THREADS = 256;  // 16 x 16 threads, each an 8 x 8 output tile
constexpr int PAD = 4;        // rows stay 16-byte aligned, fewer bank clashes
constexpr int PER_THREAD = BM * KC / THREADS;  // depthwise values a thread owns
constexpr int ROW_STEP = THREADS / KC;         // between a thread's positions

// Halo rows of a position tile: its 128 rows and the W + 1 before and after.
__host__ __device__ inline int halo_rows(int W) { return BM + 2 * W + 2; }

inline int smem_bytes(int W) {
  return (halo_rows(W) * KC + 2 * KC * (BM + PAD)) * 4;
}

// One block: 128 positions x 128 output channels. Per chunk of 32 input
// channels it stages the x rows of its positions and their halo in shared
// memory (float, ReLU applied), computes the depthwise of its positions
// once from there (nine taps in float32, rounded to x's type), stages the
// chunk's slice of pw, and accumulates the product in an 8 x 8 float32
// register tile per thread.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
sep2d_kernel(const T* __restrict__ x, const T* __restrict__ dw9,
             const T* __restrict__ pw, const float* __restrict__ scale,
             const float* __restrict__ shift, T* __restrict__ out, int H,
             int W, int Cin, int Cout, long long P, int relu_in) {
  extern __shared__ __align__(16) float fsmem[];
  const int rows = halo_rows(W);
  float* halo = fsmem;                    // [rows][KC]
  float* dw_s = halo + rows * KC;         // [KC][BM + PAD], k-major
  float* pw_s = dw_s + KC * (BM + PAD);   // [KC][BN + PAD], k-major

  const long long p0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const long long row0 = p0 - W - 1;  // global position of halo row 0

  // depthwise: channel kc of the chunk at positions first + ROW_STEP i
  const int kc = tid % KC;
  const int first = tid / KC;
  // bit (dy+1)*3 + dx+1 of a position's mask: that tap lies inside the
  // image (read after the first chunk's barrier)
  __shared__ int taps[BM];
  if (tid < BM) {
    const long long p = p0 + tid;
    const int w = static_cast<int>(p % W);
    const int h = static_cast<int>((p / W) % H);
    int mask = 0;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx)
        if (p < P && h + dy >= 0 && h + dy < H && w + dx >= 0 && w + dx < W)
          mask |= 1 << ((dy + 1) * 3 + dx + 1);
    taps[tid] = mask;
  }
  // product: rows ty*4 + i (+64), channels tx*4 + j (+64)
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += KC) {
    // stage the halo (zero outside the tensor) and the pw slice; four
    // channels a load where the rows allow 16-byte float loads
    if (VEC) {
      for (int i = tid; i < rows * (KC / 4); i += THREADS) {
        const long long p = row0 + i / (KC / 4);
        const int c = c0 + (i % (KC / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p >= 0 && p < P && c < Cin)
          v = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(x) + p * Cin + c);
        if (relu_in) {
          v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
          v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
        }
        *reinterpret_cast<float4*>(halo + i * 4) = v;
      }
    } else {
      for (int i = tid; i < rows * KC; i += THREADS) {
        const long long p = row0 + i / KC;
        const int c = c0 + i % KC;
        float v = (p >= 0 && p < P && c < Cin)
                      ? sparkdl::load_f(x + p * Cin + c) : 0.f;
        halo[i] = relu_in ? fmaxf(v, 0.f) : v;
      }
    }
#pragma unroll
    for (int i = 0; i < BN * KC / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int n = n0 + idx / KC;
      const int c = c0 + idx % KC;
      pw_s[(idx % KC) * (BN + PAD) + idx / KC] =
          (n < Cout && c < Cin)
              ? sparkdl::load_f(pw + static_cast<long long>(n) * Cin + c)
              : 0.f;
    }
    float wk[9];
#pragma unroll
    for (int j = 0; j < 9; ++j)
      wk[j] = c0 + kc < Cin ? sparkdl::load_f(dw9 + j * Cin + c0 + kc) : 0.f;
    __syncthreads();
    // the depthwise of the tile's positions, once per chunk
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int pl = first + ROW_STEP * i;
      const float* centre = halo + (pl + W + 1) * KC + kc;
      const int mask = taps[pl];
      float s = 0.f;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int tap = (dy + 1) * 3 + dx + 1;
          if (mask >> tap & 1)
            s = fmaf(centre[(dy * W + dx) * KC], wk[tap], s);
        }
      dw_s[kc * (BM + PAD) + pl] = sparkdl::round_as(s, x);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float* a = dw_s + k * (BM + PAD) + ty * 4;
      const float* b = pw_s + k * (BN + PAD) + tx * 4;
      const float4 a0 = *reinterpret_cast<const float4*>(a);
      const float4 a1 = *reinterpret_cast<const float4*>(a + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(b);
      const float4 b1 = *reinterpret_cast<const float4*>(b + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long p = p0 + ty * 4 + (i & 3) + (i >> 2) * 64;
    if (p >= P) continue;
    T* row = out + p * Cout;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 4 + (j & 3) + (j >> 2) * 64;
      if (n < Cout) sparkdl::store_f(row + n, affine(acc[i][j], scale, shift,
                                                     n));
    }
  }
}

template <typename T>
int launch(const void* x, const void* dw9, const void* pw, const void* scale,
           const void* shift, void* out, int H, int W, int Cin, int Cout,
           long long P, int relu_in, cudaStream_t stream) {
  const int smem = smem_bytes(W);
  // the static tap masks take BM ints of the block's shared memory
  if (smem > 232448 - BM * 4 || (P + BM - 1) / BM > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // float rows of a multiple of four channels at a 16-byte aligned base
  const bool vec = sizeof(T) == 4 && Cin % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto kernel = vec ? sep2d_kernel<T, true> : sep2d_kernel<T, false>;
  static int allowed[2] = {48 * 1024, 48 * 1024};  // raised smem limits
  if (smem > allowed[vec]) {
    const int err = sparkdl::hopper::allow_smem(kernel, smem);
    if (err != 0) return err;
    allowed[vec] = smem;
  }
  dim3 grid(static_cast<unsigned>((P + BM - 1) / BM), (Cout + BN - 1) / BN);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dw9),
      static_cast<const T*>(pw), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(out), H, W, Cin,
      Cout, P, relu_in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

namespace tc {

namespace hp = sparkdl::hopper;

constexpr int BM = 64;            // positions per tile
constexpr int THREADS = 4 * 128;  // consumers (2 warpgroups), producers (2)
constexpr int PRODUCERS = 256;
constexpr int QUADS = hp::KCHUNK / 4;            // 4-channel groups a chunk
constexpr int PER_THREAD = BM * QUADS / PRODUCERS;  // positions a producer owns
constexpr int ROW_STEP = PRODUCERS / QUADS;      // between a thread's positions
constexpr int MAX_STAGES = 4;
constexpr int MAX_HALO_SLOTS = 4;
constexpr int A_BYTES = BM * hp::ROW_BYTES;
constexpr int SMEM_LIMIT = 232448;

// The halo of a position tile: its 64 rows and the W + 1 before and after,
// loaded as `boxes` TMA boxes of `box_rows` rows (a box has at most 256).
struct Halo {
  int rows, boxes, box_rows, bytes;
};

inline Halo halo_of(int W) {
  Halo h;
  h.rows = BM + 2 * W + 2;
  h.boxes = (h.rows + 255) / 256;
  h.box_rows = (h.rows + h.boxes - 1) / h.boxes;
  h.bytes = h.boxes * h.box_rows * hp::ROW_BYTES;
  return h;
}

// The epilogue's staging rows of one consumer warpgroup: 64 rows of its
// BN / 2 channels, padded by 8 so the fragment writes miss no bank.
__host__ __device__ constexpr int epi_pitch(int bn) { return bn / 2 + 8; }
__host__ __device__ constexpr int epi_bytes(int bn) {
  return 2 * BM * epi_pitch(bn) * 2;
}

inline int smem_bytes(int bn, int stages, int halo_slots, int halo_bytes) {
  return hp::TILE_ALIGN + stages * (A_BYTES + bn * hp::ROW_BYTES) +
         halo_slots * halo_bytes + epi_bytes(bn) +
         (2 * MAX_STAGES + MAX_HALO_SLOTS) * 8;
}

// Four bf16 widened to float, ReLU first where asked.
template <bool RELU>
__device__ __forceinline__ float4 widen4(uint2 v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.y));
  float4 f = make_float4(a.x, a.y, b.x, b.y);
  if (RELU) {
    f.x = fmaxf(f.x, 0.f); f.y = fmaxf(f.y, 0.f);
    f.z = fmaxf(f.z, 0.f); f.w = fmaxf(f.w, 0.f);
  }
  return f;
}

__device__ __forceinline__ void fma4(float4& s, const float4& v,
                                     const float4& w) {
  s.x = fmaf(v.x, w.x, s.x); s.y = fmaf(v.y, w.y, s.y);
  s.z = fmaf(v.z, w.z, s.z); s.w = fmaf(v.w, w.w, s.w);
}

// Persistent: block b walks tiles b, b + gridDim.x, ... of the (position
// tile, channel tile) grid, channel tiles fastest so that neighbouring
// tiles share their x rows in L2; the ring of stages and the halo slots
// run on across tiles, so one tile's epilogue overlaps the next one's
// depthwise.
template <int BN, bool RELU>
__global__ void __launch_bounds__(THREADS, 1)
sep2d_kernel(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap wmap,
             const __nv_bfloat16* __restrict__ dw9,
             const float* __restrict__ scale,
             const float* __restrict__ shift,
             __nv_bfloat16* __restrict__ out, int H, int W, int Cin,
             int Cout, long long P, int tiles_n, int tiles, int stages,
             int halo_slots, int halo_boxes, int halo_box_rows) {
  constexpr int NW = BN / 2;  // channels per consumer warpgroup
  constexpr int B_BYTES = BN * hp::ROW_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + hp::TILE_ALIGN - 1) &
      ~static_cast<uintptr_t>(hp::TILE_ALIGN - 1));
  const int halo_bytes = halo_boxes * halo_box_rows * hp::ROW_BYTES;
  uint8_t* a_tiles = smem;
  uint8_t* b_tiles = a_tiles + stages * A_BYTES;
  uint8_t* halo = b_tiles + stages * B_BYTES;
  __nv_bfloat16* epi =
      reinterpret_cast<__nv_bfloat16*>(halo + halo_slots * halo_bytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(halo + halo_slots * halo_bytes +
                                  epi_bytes(BN));
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* halo_full = empty + MAX_STAGES;

  const int tid = threadIdx.x;
  const int chunks = (Cin + hp::KCHUNK - 1) / hp::KCHUNK;
  // this block's tiles, and the chunks it walks over all of them
  const int my_tiles =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int my_chunks = my_tiles * chunks;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hp::mbar_init(&full[s], PRODUCERS + 1);
      hp::mbar_init(&empty[s], 256);
    }
    for (int s = 0; s < halo_slots; ++s) hp::mbar_init(&halo_full[s], 1);
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---------------- producers: halo, depthwise, pw slices ------------
    const int pt = tid - 256;
    const bool leader = pt == 0;
    // The k-th chunk this block walks: tile blockIdx.x + (k / chunks) *
    // gridDim.x, input channels (k % chunks) * 64 ..
    auto load_halo = [&](int k) {
      const int slot = k % halo_slots;
      const int tile = blockIdx.x + (k / chunks) * gridDim.x;
      // W + 1 rows before the tile (negative rows read zeros)
      const int row0 = (tile / tiles_n) * BM - W - 1;
      hp::mbar_arrive_tx(&halo_full[slot], halo_bytes);
      for (int j = 0; j < halo_boxes; ++j)
        hp::tma_load_2d(halo + slot * halo_bytes +
                            j * halo_box_rows * hp::ROW_BYTES,
                        &xmap, (k % chunks) * hp::KCHUNK,
                        row0 + j * halo_box_rows, &halo_full[slot]);
    };
    if (leader)
      for (int k = 0; k < halo_slots && k < my_chunks; ++k) load_halo(k);

    const int q = pt % QUADS;  // channels 4q .. 4q + 3 of a chunk
    const int first = pt / QUADS;  // positions first + ROW_STEP * i
    uint2 wraw[9];  // the next chunk's taps, loaded one chunk ahead
    auto load_taps = [&](int k) {
      const int ch = (k % chunks) * hp::KCHUNK + 4 * q;
#pragma unroll
      for (int j = 0; j < 9; ++j)
        wraw[j] = ch < Cin ? *reinterpret_cast<const uint2*>(dw9 + j * Cin +
                                                            ch)
                           : make_uint2(0, 0);
    };
    if (my_chunks > 0) load_taps(0);
    int tap_offset[9];     // bytes from the centre tap's halo row
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      tap_offset[tap] = ((tap / 3 - 1) * W + tap % 3 - 1) * hp::ROW_BYTES;
    int row[PER_THREAD];   // halo row of the centre tap
    int taps[PER_THREAD];  // bit (dy+1)*3 + dx+1: tap inside the image

    for (int k = 0; k < my_chunks; ++k) {
      const int c = k % chunks;
      if (c == 0) {  // a new tile: its positions
        const int tile = blockIdx.x + (k / chunks) * gridDim.x;
        const long long p0 = static_cast<long long>(tile / tiles_n) * BM;
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
          const int pl = first + ROW_STEP * i;
          const long long p = p0 + pl;
          const int w = static_cast<int>(p % W);
          const int h = static_cast<int>((p / W) % H);
          int mask = 0;
#pragma unroll
          for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx)
              if (p < P && h + dy >= 0 && h + dy < H && w + dx >= 0 &&
                  w + dx < W)
                mask |= 1 << ((dy + 1) * 3 + dx + 1);
          taps[i] = mask;
          row[i] = pl + W + 1;
        }
      }
      const int s = k % stages;
      const int slot = k % halo_slots;
      hp::mbar_wait(&empty[s], ((k / stages) & 1) ^ 1);
      if (leader) {
        const int tile = blockIdx.x + (k / chunks) * gridDim.x;
        hp::mbar_arrive_tx(&full[s], B_BYTES);
        hp::tma_load_2d(b_tiles + s * B_BYTES, &wmap, c * hp::KCHUNK,
                        (tile % tiles_n) * BN, &full[s]);
      }
      float4 wk[9];
#pragma unroll
      for (int j = 0; j < 9; ++j) wk[j] = widen4<false>(wraw[j]);
      if (k + 1 < my_chunks) load_taps(k + 1);
      hp::mbar_wait(&halo_full[slot], (k / halo_slots) & 1);
      const uint8_t* src = halo + slot * halo_bytes + 8 * q;
      uint8_t* dst = a_tiles + s * A_BYTES;
      // Every tap is read (the halo holds them all) and those outside
      // the image are zeroed: no branch, so the two positions a warp holds
      // never diverge. All loads come before any store, so they overlap.
      float4 acc[PER_THREAD];
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i)
        acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
          uint2 v = *reinterpret_cast<const uint2*>(
              src + row[i] * hp::ROW_BYTES + tap_offset[tap]);
          if (!(taps[i] >> tap & 1)) v = make_uint2(0, 0);
          fma4(acc[i], widen4<RELU>(v), wk[tap]);
        }
      }
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i].x, acc[i].y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[i].z, acc[i].w);
        uint2 packed;
        packed.x = *reinterpret_cast<const uint32_t*>(&lo);
        packed.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(
            dst + hp::swizzled_offset(first + ROW_STEP * i, 8 * q)) = packed;
      }
      hp::fence_proxy_async();
      hp::mbar_arrive(&full[s]);
      // every producer is done with this halo slot: refill it
      hp::named_sync(1, PRODUCERS);
      if (leader && k + halo_slots < my_chunks) load_halo(k + halo_slots);
    }
    return;
  }

  // ---------------- consumers: wgmma on each released stage -------------
  const int g = tid >> 7;  // consumer warpgroup: channels g*NW ..
  const int t = tid & 127;
  float acc[NW / 2];
  int k = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    for (int c = 0; c < chunks; ++c, ++k) {
      const int s = k % stages;
      hp::mbar_wait(&full[s], (k / stages) & 1);
      hp::mma_stage<NW>(acc, hp::smem_addr(a_tiles + s * A_BYTES),
                        hp::smem_addr(b_tiles + s * B_BYTES +
                                      g * NW * hp::ROW_BYTES));
      hp::mbar_arrive(&empty[s]);
    }
    // Epilogue: the affine into this warpgroup's staging rows, then rows
    // of 16-byte stores (neighbouring threads on neighbouring addresses).
    const long long p0 = static_cast<long long>(tile / tiles_n) * BM;
    const int n0 = (tile % tiles_n) * BN + g * NW;
    __nv_bfloat16* rows = epi + g * BM * epi_pitch(BN);
    hp::named_sync(2 + g, 128);  // the last tile's rows are all stored
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = hp::frag_row(t, e);
        const int col = hp::frag_col(t, j, e);
        const int n = n0 + col < Cout ? n0 + col : Cout - 1;
        const int n1 = n0 + col + 1 < Cout ? n0 + col + 1 : Cout - 1;
        *reinterpret_cast<__nv_bfloat162*>(rows + r * epi_pitch(BN) + col) =
            __floats2bfloat162_rn(affine(acc[4 * j + e], scale, shift, n),
                                  affine(acc[4 * j + e + 1], scale, shift,
                                         n1));
      }
    }
    hp::named_sync(2 + g, 128);
    constexpr int OCTETS = NW / 8;  // 16-byte pieces of a staged row
    const bool whole = (Cout & 7) == 0;
#pragma unroll 4
    for (int i = t; i < BM * OCTETS; i += 128) {
      const int r = i / OCTETS;
      const int col = (i % OCTETS) * 8;
      const long long p = p0 + r;
      const int n = n0 + col;
      if (p >= P || n >= Cout) continue;
      const __nv_bfloat16* src = rows + r * epi_pitch(BN) + col;
      __nv_bfloat16* dst = out + p * Cout + n;
      if (whole) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && n + e < Cout; ++e) dst[e] = src[e];
      }
    }
  }
}

inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

template <int BN, bool RELU>
int launch(const void* x, const void* dw9, const void* pw, const void* scale,
           const void* shift, void* out, int H, int W, int Cin, int Cout,
           long long P, int stages, int halo_slots, cudaStream_t stream) {
  const Halo h = halo_of(W);
  const int chunks = (Cin + hp::KCHUNK - 1) / hp::KCHUNK;
  const int smem = smem_bytes(BN, stages, halo_slots, h.bytes);
  const long long tiles_m = (P + BM - 1) / BM;
  const int tiles_n = (Cout + BN - 1) / BN;
  if (smem > SMEM_LIMIT || tiles_m * tiles_n > 0x7fffffffLL || chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>(tiles_m * tiles_n);
  CUtensorMap xmap, wmap;
  if (!hp::encode_bf16_2d(&xmap, x, P, Cin, h.box_rows, hp::KCHUNK, false) ||
      !hp::encode_bf16_2d(&wmap, pw, Cout, Cin, BN, hp::KCHUNK, true))
    return static_cast<int>(cudaErrorInvalidValue);
  static int allowed = 0;  // this instantiation's raised smem limit
  if (smem > allowed) {
    const int err = hp::allow_smem(sep2d_kernel<BN, RELU>, smem);
    if (err != 0) return err;
    allowed = smem;
  }
  const int blocks = tiles < sm_count() ? tiles : sm_count();
  sep2d_kernel<BN, RELU><<<blocks, THREADS, smem, stream>>>(
      xmap, wmap, static_cast<const __nv_bfloat16*>(dw9),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<__nv_bfloat16*>(out), H, W, Cin, Cout, P, tiles_n, tiles,
      stages, halo_slots, h.boxes, h.box_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch(const void* x, const void* dw9, const void* pw, const void* scale,
           const void* shift, void* out, int H, int W, int Cin, int Cout,
           long long P, int relu_in, int stages, int halo_slots,
           cudaStream_t stream) {
  return relu_in ? launch<BN, true>(x, dw9, pw, scale, shift, out, H, W, Cin,
                                    Cout, P, stages, halo_slots, stream)
                 : launch<BN, false>(x, dw9, pw, scale, shift, out, H, W,
                                     Cin, Cout, P, stages, halo_slots,
                                     stream);
}

}  // namespace tc

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x (B, H, W, Cin), dw9 (9, Cin) and pw
// ((Cout, Cin); (Cin, Cout) for simt_f32) in dtype; scale, shift (Cout,)
// float32; out (B, H, W, Cout)
// in dtype. body, bn, stages, halo_slots, bm, groups, resident, producers,
// blocks: the launch plan (core/kernels.py::plan_sep2d). Returns
// cudaErrorInvalidValue for a plan it cannot run, else cudaGetLastError()
// after the launch (0 = launched).
extern "C" int sparkdl_sep2d(const void* x, const void* dw9, const void* pw,
                             const void* scale, const void* shift, void* out,
                             int B, int H, int W, int Cin, int Cout,
                             int relu_in, int dtype, int body, int bn,
                             int stages, int halo_slots, int bm, int groups,
                             int resident, int producers, int blocks,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long P = static_cast<long long>(B) * H * W;
  if (P <= 0 || Cin <= 0 || Cout <= 0 || (P + 63) / 64 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (body == SIMT_F32 && dtype == 0 && P <= 0x7fffffffLL && bm % 8 == 0 &&
      bn % 8 == 0) {
    namespace s32 = sparkdl::simt32;
    s32::Params p = {};
    p.x = static_cast<const float*>(x);
    p.dw9 = static_cast<const float*>(dw9);
    p.w = static_cast<const float*>(pw);
    p.scale = static_cast<const float*>(scale);
    p.shift = static_cast<const float*>(shift);
    p.out = static_cast<float*>(out);
    p.M = static_cast<int>(P);
    p.H = H;
    p.W = W;
    p.Cin = Cin;
    p.Cout = Cout;
    p.relu = relu_in;
    p.ty = bm / 8;
    p.producers = producers;
    p.stages = stages;
    p.resident = resident;
    p.groups = groups;
    p.splits = 1;
    p.chunks = (Cin + s32::KC - 1) / s32::KC;
    p.tiles_n = (Cout + bn - 1) / bn;
    p.units = static_cast<int>((P + bm - 1) / bm) * groups;
    return s32::launch<true>(p, bn, blocks, s);
  }
  if (body == SIMT_BF16 && dtype == 1 && bn == simt::BN)
    return simt::launch<__nv_bfloat16>(x, dw9, pw, scale, shift, out, H, W,
                                       Cin, Cout, P, relu_in, s);
  if (body == WGMMA && dtype == 1 && Cin % 8 == 0 && aligned16(x) &&
      aligned16(pw) && (reinterpret_cast<uintptr_t>(dw9) & 7) == 0 &&
      stages >= 2 && stages <= tc::MAX_STAGES && halo_slots >= 2 &&
      halo_slots <= tc::MAX_HALO_SLOTS && P <= 0x7fffffffLL) {
    switch (bn) {
      case 64: return tc::launch<64>(x, dw9, pw, scale, shift, out, H, W,
                                     Cin, Cout, P, relu_in, stages,
                                     halo_slots, s);
      case 128: return tc::launch<128>(x, dw9, pw, scale, shift, out, H, W,
                                       Cin, Cout, P, relu_in, stages,
                                       halo_slots, s);
      case 256: return tc::launch<256>(x, dw9, pw, scale, shift, out, H, W,
                                       Cin, Cout, P, relu_in, stages,
                                       halo_slots, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
