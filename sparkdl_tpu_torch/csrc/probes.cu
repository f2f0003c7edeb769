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
// (dy, dx row-major), rounded to bf16 once. A tap outside the image is
// skipped, which leaves the sum as the plain version's + 0 does.
//
// What bounds them on an H100: fma9 and dw2d do 18 FLOP per element
// against 4 bytes moved (one bf16 read, one written): bound by bytes
// (47,104 x 728 bf16 each way at the probe's B = 128: >= 0.041 ms at
// 3.35 TB/s). sep2d_probe is bound by its pointwise product (2 * C * C
// FLOP a row): >= 0.050 ms on the bf16 tensor cores.
//
// dw2d: a tile is BM consecutive rows x 64 channels (one 128-byte column
// of the matrix). One TMA load stages the BM + 2 (W + 1) rows its taps
// reach (rows outside the tensor read zeros) into a ring of halo slots on
// mbarriers; blocks are persistent, two per SM. The chunks of a row tile
// are neighbours in the walk, so blocks running together write whole
// rows (row starts are 16, not 32, bytes apart from a sector edge, and a
// sector half written by one block is finished by its neighbour while
// still in L2). A thread owns four channels of a run of consecutive rows
// and slides a 3 x 3 window down it: tap (dy, +1) of row r is tap (dy, 0)
// of row r + 1, so a row takes three new 8-byte shared loads, not nine.
//
// sep2d_probe: persistent blocks, one per SM, in clusters of 1 or 2,
// each owning 64-row tiles; per block one consumer warpgroup, one
// producer warpgroup and one TMA warp.
// - The producers compute the tile's depthwise once, chunk by chunk of 64
//   channels, from TMA-staged halos with the same sliding window, round it
//   to bf16 and write it into the chunk's A slot in the 128-byte swizzled
//   K-major layout the wgmma descriptors name (fence.proxy.async, then the
//   slot's mbarrier). Past C they write zeros.
// - A stays resident (all C / 64 chunks) while the consumer walks the
//   output channels in passes of 256 (wgmma m64n256k16, float32
//   accumulators, one stage's product in flight while the next is
//   issued), so the depthwise runs once per (row, channel). The last pass
//   frees each chunk for the next tile's producers.
// - pw, (C, C) with N contiguous, is read as an MN-major B through the
//   transpose bit (no copy): the TMA warp streams stages of 64 K rows x
//   256 N (four 64-wide swizzled slabs) through an mbarrier ring; TMA
//   zero-fills pw's rows past C. In a cluster the blocks walk the same
//   stages, each loads its share of the slabs and multicasts it to all,
//   and a stage's slot is refilled once every block's consumer is done
//   with it: L2 serves pw once per cluster of row tiles.
// - The epilogue applies y * sc + sh in float32 (no contraction), rounds
//   to bf16 and stores rows < rows, channels < C; neighbouring threads
//   swap halves of two 8-column slices, so a quad writes 32 contiguous
//   bytes of a row.
// The depthwise result never reaches device memory, the TPU kernel's
// point.

#include "common.cuh"
#include "wgmma_bf16.cuh"

namespace {

namespace hp = sparkdl::hopper;

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
// The depthwise of a run of rows from a staged halo (dw2d, sep2d_probe)
// ---------------------------------------------------------------------------

constexpr int CHUNK = hp::KCHUNK;  // channels a tile or A chunk holds
constexpr int QUADS = CHUNK / 4;   // four channels a thread

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

__device__ __forceinline__ uint2 pack4(const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 p;
  p.x = *reinterpret_cast<const uint32_t*>(&lo);
  p.y = *reinterpret_cast<const uint32_t*>(&hi);
  return p;
}

// acc + v * k per channel, the product and the sum each rounded (no FMA).
__device__ __forceinline__ void tap4(float4& acc, const float4& v,
                                     const float4& k) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, k.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, k.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, k.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, k.w));
}

// The nine taps of four channels from c (zero past C), as float.
__device__ __forceinline__ void load_taps(const __nv_bfloat16* __restrict__ k9,
                                          int c, int C, float4 wk[9]) {
#pragma unroll
  for (int j = 0; j < 9; ++j)
    wk[j] = c < C ? widen4<false>(*reinterpret_cast<const uint2*>(
                        k9 + j * C + c))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
}

// The tap masks of RUN consecutive rows from `row`: bit 3 (dy + 1) + dx + 1
// is set where tap (dy, dx) lies inside the image. The launchers take
// whole images of p_pad >= H * W rows, so such a tap also lies inside the
// tensor. (h, w) are stepped from the first row's, with no division.
template <int RUN>
__device__ __forceinline__ void tap_masks(int row, int p_pad, int H, int W,
                                          int masks[RUN]) {
  int p = row % p_pad;
  int h = p / W;
  int w = p - h * W;
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    const int dx = (w >= 1 ? 1 : 0) | 2 | (w <= W - 2 ? 4 : 0);
    masks[r] = (h >= 1 && h <= H ? dx : 0) | (h <= H - 1 ? dx << 3 : 0) |
               (h <= H - 2 ? dx << 6 : 0);
    if (++w == W) {
      w = 0;
      ++h;
    }
    if (++p == p_pad) {
      p = 0;
      h = 0;
      w = 0;
    }
  }
}

// The depthwise of RUN consecutive rows for four channels, handing row i's
// float sums to emit(i, sums). `col` points at the four channels of halo
// row 0 (rows of 128 bytes); `centre` is the halo row of the first row's
// centre tap, so tap (dy, dx) of row i is halo row centre + i + W dy + dx.
// The window keeps the three columns of each dy in registers: each row
// loads only its three (dy, +1) taps.
template <int RUN, bool RELU, typename Emit>
__device__ __forceinline__ void dw_run(const uint8_t* col, int centre, int W,
                                       const int masks[RUN],
                                       const float4 wk[9], Emit emit) {
  float4 win[3][3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const uint8_t* r = col + (centre + (d - 1) * W) * hp::ROW_BYTES;
    win[d][0] = widen4<RELU>(*reinterpret_cast<const uint2*>(r - hp::ROW_BYTES));
    win[d][1] = widen4<RELU>(*reinterpret_cast<const uint2*>(r));
  }
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
#pragma unroll
    for (int d = 0; d < 3; ++d)
      win[d][2] = widen4<RELU>(*reinterpret_cast<const uint2*>(
          col + (centre + i + (d - 1) * W + 1) * hp::ROW_BYTES));
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 9; ++j)
      if (masks[i] >> j & 1) tap4(acc, win[j / 3][j % 3], wk[j]);
    emit(i, acc);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      win[d][0] = win[d][1];
      win[d][1] = win[d][2];
    }
  }
}

// mbar_wait that traps (the launch fails, the card is freed) where a
// phase has not completed after ~2^34 cycles (seconds): a barrier that
// is never released is a fault to report, not a hang.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  if (hp::mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!hp::mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// A position in a ring of slots on mbarriers: the slot and the parity of
// its current use, stepped without a division.
struct RingPos {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void step(int size) {
    if (++slot == size) {
      slot = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ uint8_t* align_tile(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + hp::TILE_ALIGN - 1) &
      ~static_cast<uintptr_t>(hp::TILE_ALIGN - 1));
}

// ---------------------------------------------------------------------------
// dw2d
// ---------------------------------------------------------------------------

namespace dw {

constexpr int THREADS = 256;           // 16 quads x 16 runs of 8 rows
constexpr int RUN = 8;
constexpr int BM = THREADS / QUADS * RUN;  // 128 rows a tile
constexpr int MAX_SLOTS = 4;

// Tile t of `tiles`: rows (t / chunks) BM .., channel chunk t % chunks
// (the chunks of a row tile are neighbours, so blocks running together
// write whole rows and L2 merges each row's sectors before they reach
// device memory); block b walks tiles b, b + gridDim.x, ... with `slots`
// halos in flight.
__global__ void __launch_bounds__(THREADS, 2)
dw2d_kernel(const __grid_constant__ CUtensorMap xmap,
            const __nv_bfloat16* __restrict__ k9,
            __nv_bfloat16* __restrict__ out, int rows, int C, int p_pad,
            int H, int W, int chunks, int tiles, int slots) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* halo = align_tile(smem_raw);
  __shared__ uint64_t full[MAX_SLOTS];
  const int slot_bytes = (BM + 2 * W + 2) * hp::ROW_BYTES;
  const int tid = threadIdx.x;
  const int my_tiles =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (tid == 0) {
    for (int s = 0; s < slots; ++s) hp::mbar_init(&full[s], 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  auto load_halo = [&](int i) {
    const int t = blockIdx.x + i * gridDim.x;
    const int s = i % slots;
    hp::mbar_arrive_tx(&full[s], slot_bytes);
    hp::tma_load_2d(halo + s * slot_bytes, &xmap, (t % chunks) * CHUNK,
                    (t / chunks) * BM - W - 1, &full[s]);
  };
  if (tid == 0)
    for (int i = 0; i < slots && i < my_tiles; ++i) load_halo(i);

  const int q = tid % QUADS;  // channels 4q .. 4q + 3 of the chunk
  const int run = tid / QUADS;  // rows run * RUN .. of the tile
  float4 wk[9];
  int wk_chunk = -1;  // the chunk whose taps wk holds
  for (int i = 0; i < my_tiles; ++i) {
    const int t = blockIdx.x + i * gridDim.x;
    const int c = (t % chunks) * CHUNK + 4 * q;
    const int m = (t / chunks) * BM + run * RUN;
    if (t % chunks != wk_chunk) {  // (once, where gridDim.x % chunks == 0)
      load_taps(k9, c, C, wk);
      wk_chunk = t % chunks;
    }
    int masks[RUN];
    tap_masks<RUN>(m, p_pad, H, W, masks);
    const int s = i % slots;
    wait_phase(&full[s], (i / slots) & 1);
    __nv_bfloat16* dst = out + static_cast<long long>(m) * C + c;
    const bool live = c < C;
    dw_run<RUN, false>(halo + s * slot_bytes + 8 * q, run * RUN + W + 1, W,
                       masks, wk, [&](int r, const float4& y) {
                         if (live && m + r < rows)
                           *reinterpret_cast<uint2*>(dst + r * C) = pack4(y);
                       });
    __syncthreads();  // every thread is done with slot s: refill it
    if (tid == 0 && i + slots < my_tiles) load_halo(i + slots);
  }
}

inline int smem_bytes(int W, int slots) {
  return hp::TILE_ALIGN + slots * (BM + 2 * W + 2) * hp::ROW_BYTES;
}

}  // namespace dw

// ---------------------------------------------------------------------------
// sep2d_probe
// ---------------------------------------------------------------------------

namespace sp {

constexpr int BM = 64;                 // rows per tile
constexpr int BN = 256;                // output channels a pass
constexpr int CONSUMERS = 128;         // one warpgroup: wgmma m64n256k16
constexpr int PRODUCERS = 128;         // 16 quads x 8 runs of 8 rows
constexpr int RUN = BM / (PRODUCERS / QUADS);
constexpr int THREADS = CONSUMERS + PRODUCERS + 32;  // and one TMA warp
constexpr int MAX_A_SLOTS = 16;
constexpr int MAX_STAGES = 4;
constexpr int MAX_HALO_SLOTS = 4;
constexpr int MAX_PASSES = 4;          // C <= 1024
constexpr int A_BYTES = BM * hp::ROW_BYTES;        // one 64-channel chunk
constexpr int SLAB_BYTES = CHUNK * hp::ROW_BYTES;  // 64 K rows x 64 N
constexpr int SLABS = BN / CHUNK;
constexpr int B_BYTES = SLABS * SLAB_BYTES;        // 64 K rows x 256 N
constexpr int BAR_BYTES =
    (2 * MAX_STAGES + 2 * MAX_A_SLOTS + MAX_HALO_SLOTS) * 8;
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ inline int halo_bytes(int W) {
  return (BM + 2 * W + 2) * hp::ROW_BYTES;
}

// The affine's scale and shift, as float, zero past C: 2 * passes * BN.
__host__ __device__ inline int affine_bytes(int C) {
  return 2 * ((C + BN - 1) / BN) * BN * 4;
}

inline int smem_bytes(int a_slots, int stages, int halo_slots, int W,
                      int C) {
  return hp::TILE_ALIGN + a_slots * A_BYTES + stages * B_BYTES +
         halo_slots * halo_bytes(W) + affine_bytes(C) + BAR_BYTES;
}

// Pieces of a pw stage: its SLABS 64-wide slabs, split evenly over the
// blocks of the cluster; block `rank` loads slabs rank * SLABS / CLUSTER
// .. and multicasts them to every block.
template <int CLUSTER>
struct Stage {
  static constexpr int PER_BLOCK = SLABS / CLUSTER;
};

template <int CLUSTER>
__global__ void __launch_bounds__(THREADS, 1)
sep2d_probe_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __nv_bfloat16* __restrict__ k9,
                   const __nv_bfloat16* __restrict__ sc,
                   const __nv_bfloat16* __restrict__ sh,
                   __nv_bfloat16* __restrict__ out, int rows, int C,
                   int p_pad, int H, int W, int row_tiles, int a_slots,
                   int stages, int halo_slots) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_tiles = align_tile(smem_raw);
  uint8_t* b_tiles = a_tiles + a_slots * A_BYTES;
  uint8_t* halo = b_tiles + stages * B_BYTES;
  const int hbytes = halo_bytes(W);
  float* affine = reinterpret_cast<float*>(halo + halo_slots * hbytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(affine) + affine_bytes(C));
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* a_full = empty + MAX_STAGES;
  uint64_t* a_empty = a_full + MAX_A_SLOTS;
  uint64_t* halo_full = a_empty + MAX_A_SLOTS;

  const int tid = threadIdx.x;
  const int rank = CLUSTER > 1 ? static_cast<int>(hp::cluster_rank()) : 0;
  const int cid = blockIdx.x / CLUSTER;
  const int clusters = gridDim.x / CLUSTER;
  // The cluster walks groups of CLUSTER consecutive row tiles, cid,
  // cid + clusters, ...; this block takes tile rank of each (a tile past
  // the last row is computed and never stored, so the cluster's blocks
  // walk the same pw stages).
  const int groups = (row_tiles + CLUSTER - 1) / CLUSTER;
  const int my_groups = cid < groups ? (groups - 1 - cid) / clusters + 1 : 0;
  const int chunks = (C + CHUNK - 1) / CHUNK;
  const int passes = (C + BN - 1) / BN;
  auto tile_of = [&](int i) { return (cid + i * clusters) * CLUSTER + rank; };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], CLUSTER);
    }
    for (int a = 0; a < a_slots; ++a) {
      hp::mbar_init(&a_full[a], PRODUCERS / 32);  // one arrival a warp
      hp::mbar_init(&a_empty[a], CONSUMERS / 32);
    }
    for (int h = 0; h < halo_slots; ++h) hp::mbar_init(&halo_full[h], 1);
    hp::mbar_fence_init();
  }
  for (int c = tid; c < passes * BN; c += THREADS) {
    affine[c] = c < C ? __bfloat162float(sc[c]) : 0.f;
    affine[passes * BN + c] = c < C ? __bfloat162float(sh[c]) : 0.f;
  }
  if (CLUSTER > 1)
    hp::cluster_sync();
  else
    __syncthreads();

  if (tid >= CONSUMERS + PRODUCERS) {
    // ---------------- TMA warp: the pw stages ---------------------------
    // Stages in the order the consumer takes them: tile, pass of 256
    // output channels, K chunk; a slot is refilled once the consumer of
    // every block of the cluster is done with the stage before.
    if (tid == CONSUMERS + PRODUCERS) {
      using S = Stage<CLUSTER>;
      RingPos b;
      for (int i = 0; i < my_groups; ++i)
        for (int n = 0; n < passes; ++n)
          for (int k = 0; k < chunks; ++k) {
            wait_phase(&empty[b.slot], b.phase ^ 1);
            hp::mbar_arrive_tx(&full[b.slot], B_BYTES);
            for (int p = rank * S::PER_BLOCK; p < (rank + 1) * S::PER_BLOCK;
                 ++p) {
              uint8_t* dst = b_tiles + b.slot * B_BYTES + p * SLAB_BYTES;
              if (CLUSTER > 1)
                hp::tma_load_2d_multicast(
                    dst, &wmap, n * BN + p * CHUNK, k * CHUNK,
                    &full[b.slot], static_cast<uint16_t>((1 << CLUSTER) - 1));
              else
                hp::tma_load_2d(dst, &wmap, n * BN + p * CHUNK, k * CHUNK,
                                &full[b.slot]);
            }
            b.step(stages);
          }
    }
    __syncwarp();
  } else if (tid >= CONSUMERS) {
    // ---------------- producers: halo, depthwise, A chunks ---------------
    const int pt = tid - CONSUMERS;
    const bool leader = pt == 0;
    const int total = my_groups * chunks;
    // the next halo the leader loads: chunk `hk` of tile `hi`, slot `hn`
    int hi = 0, hk = 0, loaded = 0;
    RingPos hn;
    auto load_next_halo = [&]() {
      hp::mbar_arrive_tx(&halo_full[hn.slot], hbytes);
      hp::tma_load_2d(halo + hn.slot * hbytes, &xmap, hk * CHUNK,
                      tile_of(hi) * BM - W - 1, &halo_full[hn.slot]);
      hn.step(halo_slots);
      ++loaded;
      if (++hk == chunks) {
        hk = 0;
        ++hi;
      }
    };
    if (leader)
      while (loaded < halo_slots && loaded < total) load_next_halo();
    const int q = pt % QUADS;    // channels 4q .. 4q + 3 of a chunk
    const int run = pt / QUADS;  // rows run * RUN .. of the tile
    int masks[RUN];
    RingPos a, h;  // the A slot and the halo slot of the chunk in hand
    for (int i = 0; i < my_groups; ++i) {
      tap_masks<RUN>(tile_of(i) * BM + run * RUN, p_pad, H, W, masks);
      for (int k = 0; k < chunks; ++k) {
        const int c = k * CHUNK + 4 * q;
        float4 wk[9];
        load_taps(k9, c, C, wk);
        wait_phase(&a_empty[a.slot], a.phase ^ 1);
        wait_phase(&halo_full[h.slot], h.phase);
        uint8_t* dst = a_tiles + a.slot * A_BYTES;
        auto emit = [&](int r, const float4& y) {
          *reinterpret_cast<uint2*>(
              dst + hp::swizzled_offset(run * RUN + r, 8 * q)) = pack4(y);
        };
        if (c < C) {
          dw_run<RUN, true>(halo + h.slot * hbytes + 8 * q,
                            run * RUN + W + 1, W, masks, wk, emit);
        } else {  // past C: zeros, never stale shared memory
#pragma unroll
          for (int r = 0; r < RUN; ++r)
            emit(r, make_float4(0.f, 0.f, 0.f, 0.f));
        }
        hp::fence_proxy_async();
        __syncwarp();
        if ((pt & 31) == 0) hp::mbar_arrive(&a_full[a.slot]);
        a.step(a_slots);
        h.step(halo_slots);
        // every producer is done with this halo slot: refill it
        hp::named_sync(1, PRODUCERS);
        if (leader && loaded < total) load_next_halo();
      }
    }
  } else {
    // ---------------- consumer: wgmma over the resident A ---------------
    // Passes of 256 output channels over the tile's resident A, pw
    // stages from the TMA warp's ring.
    const int t = tid;
    // Stage slot `slot`'s product is complete: the slot is free in this
    // block (in a cluster, the TMA warp of every block waits for every
    // block).
    auto release = [&](int slot) {
      if (t < CLUSTER) {
        if (CLUSTER > 1)
          hp::mbar_arrive_cluster(&empty[slot], t);
        else
          hp::mbar_arrive(&empty[slot]);
      }
    };
    // This warp is done with A slot `slot` (the last pass's product over
    // it is complete).
    auto free_a = [&](int slot) {
      __syncwarp();
      if ((t & 31) == 0) hp::mbar_arrive(&a_empty[slot]);
    };
    // Descriptors of A slot 0 and pw stage 0; a slot, a stage and a k16
    // step add to the start address field (address / 16).
    const uint64_t desc_a = hp::desc_sw128(hp::smem_addr(a_tiles));
    const uint64_t desc_b =
        hp::desc_sw128_mn(hp::smem_addr(b_tiles), SLAB_BYTES);
    float acc[BN / 2];
    RingPos b;        // the pw stage in hand
    RingPos a_first;  // the A slot of the tile's first chunk
    for (int i = 0; i < my_groups; ++i) {
      const long long m0 = static_cast<long long>(tile_of(i)) * BM;
      RingPos a_next;  // the A slot of the next tile's first chunk
      for (int n = 0; n < passes; ++n) {
        const bool last = n == passes - 1;
        RingPos a = a_first;
        int prev_a = 0, prev_b = 0;
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
        for (int k = 0; k < chunks; ++k) {
          if (n == 0) wait_phase(&a_full[a.slot], a.phase);
          wait_phase(&full[b.slot], b.phase);
          const uint64_t da = desc_a + a.slot * (A_BYTES >> 4);
          const uint64_t db = desc_b + b.slot * (B_BYTES >> 4);
          hp::fence_regs<BN / 2>(acc);
          hp::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < CHUNK / 16; ++kk)
            hp::wgmma_k16_mn256(acc, da + kk * (32 >> 4),
                                db + kk * (16 * hp::ROW_BYTES >> 4));
          hp::wgmma_commit();
          // the previous stage's product is complete
          hp::wgmma_wait<1>();
          hp::fence_regs<BN / 2>(acc);
          if (k > 0) {
            release(prev_b);
            if (last) free_a(prev_a);
          }
          prev_a = a.slot;
          prev_b = b.slot;
          a.step(a_slots);
          b.step(stages);
        }
        if (n == 0) a_next = a;
        hp::wgmma_wait<0>();
        hp::fence_regs<BN / 2>(acc);
        release(prev_b);
        if (last) free_a(prev_a);
        // Epilogue: y * sc + sh in float32, rounded to bf16. A quad of
        // threads holds two columns of each 8-column slice, for two rows;
        // neighbouring threads swap halves of two slices, so each thread
        // stores four contiguous columns and a quad 32 bytes of a row.
        const int n0 = n * BN;
        const bool even = (t & 1) == 0;
        const float2* scale2 = reinterpret_cast<const float2*>(affine);
        const float2* shift2 =
            reinterpret_cast<const float2*>(affine + passes * BN);
#pragma unroll
        for (int jj = 0; jj < BN / 8; jj += 2) {
          uint32_t w[2][2];  // [slice jj, jj + 1][row half]
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            const int col = n0 + hp::frag_col(t, jj + i2, 0);
            const float2 sc2 = scale2[col / 2];
            const float2 sh2 = shift2[col / 2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float* a = acc + 4 * (jj + i2) + 2 * h;
              const __nv_bfloat162 v = __floats2bfloat162_rn(
                  __fadd_rn(__fmul_rn(a[0], sc2.x), sh2.x),
                  __fadd_rn(__fmul_rn(a[1], sc2.y), sh2.y));
              w[i2][h] = *reinterpret_cast<const uint32_t*>(&v);
            }
          }
          // even lanes keep slice jj and take their neighbour's pair of
          // it; odd lanes keep slice jj + 1
          const int col = n0 + 8 * (jj + (even ? 0 : 1)) + 2 * ((t & 3) & ~1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t got =
                __shfl_xor_sync(0xffffffffu, even ? w[1][h] : w[0][h], 1);
            const uint2 four = even ? make_uint2(w[0][h], got)
                                    : make_uint2(got, w[1][h]);
            const long long m = m0 + hp::frag_row(t, 2 * h);
            if (m < rows && col < C)
              *reinterpret_cast<uint2*>(out + m * C + col) = four;
          }
        }
      }
      a_first = a_next;
    }
  }
  // No block leaves while another may still arrive on its barriers or
  // write into its shared memory.
  if (CLUSTER > 1)
    hp::cluster_sync();
}

template <int CLUSTER>
int launch(const void* x, const void* k9, const void* pw, const void* sc,
           const void* sh, void* out, int rows, int C, int p_pad, int H,
           int W, int a_slots, int stages, int halo_slots, int blocks,
           cudaStream_t stream) {
  auto kernel = sep2d_probe_kernel<CLUSTER>;
  const int smem = smem_bytes(a_slots, stages, halo_slots, W, C);
  const int row_tiles = (rows + BM - 1) / BM;
  const int groups = (row_tiles + CLUSTER - 1) / CLUSTER;
  if (smem > SMEM_LIMIT || blocks % CLUSTER != 0 ||
      blocks / CLUSTER > groups || BM + 2 * W + 2 > 256 ||
      (C + BN - 1) / BN > MAX_PASSES)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  if (!hp::encode_bf16_2d(&xmap, x, rows, C, BM + 2 * W + 2, CHUNK, false) ||
      !hp::encode_bf16_2d(&wmap, pw, C, C, CHUNK, CHUNK, true))
    return static_cast<int>(cudaErrorInvalidValue);
  static int allowed = 0;  // this instantiation's raised smem limit
  if (smem > allowed) {
    const int err = hp::allow_smem(kernel, smem);
    if (err != 0) return err;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Persistent blocks: all of them must be resident at once.
  int fit = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks / CLUSTER > fit) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaLaunchKernelEx(
      &cfg, kernel, xmap, wmap, static_cast<const __nv_bfloat16*>(k9),
      static_cast<const __nv_bfloat16*>(sc),
      static_cast<const __nv_bfloat16*>(sh), static_cast<__nv_bfloat16*>(out),
      rows, C, p_pad, H, W, row_tiles, a_slots, stages, halo_slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sp

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The probes take C a multiple of 8 and 16-byte aligned rows.
bool layout_ok(long long rows, int C, const void* x, const void* k9,
               const void* out) {
  return rows > 0 && C > 0 && C % 8 == 0 && aligned16(x) && aligned16(k9) &&
         aligned16(out);
}

// Whole images of p_pad >= H * W rows, so that a tap inside the image
// lies inside the tensor.
bool images_ok(long long rows, int p_pad, int H, int W) {
  return H > 0 && W > 0 && p_pad >= H * W && rows % p_pad == 0;
}

bool grid_1d(long long threads, int block, unsigned* blocks) {
  const long long n = (threads + block - 1) / block;
  if (n <= 0 || n > 0x7fffffffLL) return false;
  *blocks = static_cast<unsigned>(n);
  return true;
}

int sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return count;
}

}  // namespace

// x, k9 (9, C) and out are bf16; x and out (rows, C). Each entry point
// returns cudaErrorInvalidValue for a layout or plan it cannot run, else
// cudaGetLastError() after its launch (0 = launched).
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

// The plan (experiments/probe.py::plan_dw2d): bm rows a tile (128 only),
// `slots` halos in flight (2-4), `blocks` persistent blocks (at most two a
// SM).
extern "C" int sparkdl_dw2d(const void* x, const void* k9, void* out,
                            long long rows, int C, int p_pad, int H, int W,
                            int bm, int slots, int blocks, void* stream) {
  const int row_tiles = static_cast<int>((rows + bm - 1) / (bm > 0 ? bm : 1));
  const long long tiles =
      static_cast<long long>(row_tiles) * ((C + CHUNK - 1) / CHUNK);
  if (!layout_ok(rows, C, x, k9, out) || rows > 0x3fffffffLL ||
      !images_ok(rows, p_pad, H, W) || bm != dw::BM || slots < 2 ||
      slots > dw::MAX_SLOTS || bm + 2 * W + 2 > 256 || blocks <= 0 ||
      blocks > 2 * sm_count() || tiles > 0x7fffffffLL || blocks > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap;
  if (!hp::encode_bf16_2d(&xmap, x, rows, C, bm + 2 * W + 2, CHUNK, false))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = dw::smem_bytes(W, slots);
  static int allowed = 0;  // the raised smem limit
  if (smem > allowed) {
    const int err = hp::allow_smem(dw::dw2d_kernel, smem);
    if (err != 0) return err;
    allowed = smem;
  }
  dw::dw2d_kernel<<<blocks, dw::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      xmap, static_cast<const __nv_bfloat16*>(k9),
      static_cast<__nv_bfloat16*>(out), static_cast<int>(rows), C, p_pad, H,
      W, (C + CHUNK - 1) / CHUNK, static_cast<int>(tiles), slots);
  return static_cast<int>(cudaGetLastError());
}

// pw (C, C), sc and sh (C,) are bf16 too. The plan
// (experiments/probe.py::plan_sep2d_probe): a_slots depthwise chunks
// resident (at least C / 64, at most 16), a ring of `stages` pw stages
// (2-4) and `halo_slots` halos (2-4), clusters of `cluster` blocks (1 or
// 2), `blocks` persistent blocks, all resident at once.
extern "C" int sparkdl_sep2d_probe(const void* x, const void* k9,
                                   const void* pw, const void* sc,
                                   const void* sh, void* out, long long rows,
                                   int C, int p_pad, int H, int W,
                                   int a_slots, int stages, int halo_slots,
                                   int cluster, int blocks, void* stream) {
  if (!layout_ok(rows, C, x, k9, out) || !aligned16(pw) ||
      rows > 0x3fffffffLL || !images_ok(rows, p_pad, H, W) ||
      a_slots < (C + CHUNK - 1) / CHUNK || a_slots > sp::MAX_A_SLOTS ||
      stages < 2 || stages > sp::MAX_STAGES || halo_slots < 2 ||
      halo_slots > sp::MAX_HALO_SLOTS || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(rows);
  switch (cluster) {
    case 1: return sp::launch<1>(x, k9, pw, sc, sh, out, r, C, p_pad, H, W,
                                 a_slots, stages, halo_slots, blocks, s);
    case 2: return sp::launch<2>(x, k9, pw, sc, sh, out, r, C, p_pad, H, W,
                                 a_slots, stages, halo_slots, blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
