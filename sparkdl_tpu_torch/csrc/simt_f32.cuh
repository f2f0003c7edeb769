// The float32 mainloop shared by the SIMT bodies of sep2d and pw1x1:
// out[m, n] = epilogue(sum_k A[m, k] * w[n, k]), float32 FMAs on the CUDA
// cores (no TF32: the float32 contract of 1e-5 relative would not hold),
// w the weight, stored (Cin, Cout). pw1x1's A is x itself; sep2d's A is
// the 3x3 depthwise of x, computed on chip from a staged halo of x and
// never written to device memory.
//
// What bounds it on an H100: the float32 FMA rate (67 TFLOP/s, ~20
// FLOP/byte ridge) at every Xception and InceptionV3 site but the first
// sep2d (147x147 64->128, level with its bytes). What the design does:
// - Tiles. A consumer thread holds an 8 x 8 register tile: rows ty + TY i
//   (i < 8), channels 4 tx + {0..3} and 4 tx + 4 TX + {0..3}. A block of
//   TY x TX consumers owns BM = 8 TY rows x BN = 8 TX channels a pass. A
//   lies row-major in shared memory and B K-major (the weight comes as
//   (Cin, Cout)), so four K steps read eight 16-byte A vectors (broadcasts:
//   a warp holds two or four consecutive rows, 20 floats apart) and eight
//   16-byte B vectors (a warp's 16 or 8 columns of lanes on consecutive
//   channels: two wavefronts a load at most) for 256 FMAs, the next four
//   steps' A values loading meanwhile.
// - Warp roles. `producers` threads (two warps or more) stage every chunk
//   of 16 K steps into a ring of 2-4 stages, zero-filled past every
//   ragged edge: by TMA (one thread asks for every box of the stage: B,
//   pw1x1's A, sep2d's halo and taps) where the rows allow it, else by
//   cp.async (4-byte copies where the rows are not 16-byte aligned; the
//   source address kept in bounds); for sep2d they also compute the
//   chunk's depthwise from the staged halo. The consumers run only the
//   product and the epilogue. Each stage has a `full` mbarrier
//   (its copies have landed, the copies arriving by themselves, and its
//   depthwise rows are written) and an `empty` one (the consumers are done
//   with it): no block-wide barrier and no producer waiting on its own
//   copies, so the loads, the depthwise and the product of different
//   chunks overlap, with one block on an SM.
// - Work. A unit is a row tile and a group of consecutive N tiles; blocks
//   are persistent, one on each SM, and walk units blockIdx.x, +
//   gridDim.x, ..., the ring running on across units. The plan
//   (core/kernels.py::plan_sep2d, plan_pw1x1) sizes TY, TX, the stages,
//   the groups and the grid per site so that no round of the card is
//   mostly empty.
// - sep2d's depthwise is computed once per (row tile, K chunk), in the
//   first pass of a unit, into a block-resident D of BM x Cin floats that
//   the unit's further passes read again (recompute = groups per row
//   tile); where D does not fit (Cin 1536 at 10x10), a unit is one N tile
//   and each stage holds its chunk of D (recompute = N tiles). Each
//   producer slides a 3 x 3 window of the halo down a run of consecutive
//   positions (three new loads a position); nine taps in float32, masked
//   taps skipped, rounded to x's type (float32: unchanged).
// - pw1x1 may split K over a cluster of `splits` blocks: each block's
//   partial tile goes to its shared memory, and block z of the cluster
//   adds the partials of its slice of rows in split order 0, 1, ... from
//   the cluster's shared memory (DSMEM), then applies the epilogue: one
//   launch, the same sums on every run.
// - Epilogue: y * scale + shift in float32 without FMA contraction, then
//   ReLU where asked, then 16-byte stores where the rows allow.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace sparkdl {
namespace simt32 {

constexpr int KC = 16;            // input channels per chunk
constexpr int MAX_CONSUMERS = 256;
constexpr int MAX_THREADS = MAX_CONSUMERS + 128;
constexpr int MAX_STAGES = 4;
constexpr int MAX_SPLITS = 2;     // clusters the card co-hosts on every SM
constexpr int MAX_RUN = 9;        // depthwise rows a producer owns

// The launch plan and the operands of one call (both kernels).
struct Params {
  // TMA boxes (tma): w's 16 x BN; pw1x1's x rows, 20 floats a row (the
  // 4 past the chunk land in the row's pad); sep2d's halo rows of 16 and
  // its nine taps
  CUtensorMap wmap, xmap, hmap, tmap;
  const float* x;      // (M, Cin)
  const float* dw9;    // sep2d: (9, Cin) taps, tap-major
  const float* w;      // (Cin, Cout)
  const float* scale;  // (Cout,)
  const float* shift;  // (Cout,)
  float* out;          // (M, Cout)
  int M, H, W;         // rows; sep2d: image height and width (M = B H W)
  int Cin, Cout;
  int relu;            // sep2d: ReLU on x; pw1x1: ReLU on the output
  int ty;              // consumer thread rows: BM = 8 ty
  int producers;       // producer threads: a multiple of 32, 64 or more
  int stages;          // ring depth, 2-4
  int resident;        // sep2d: D holds every chunk of the row tile
  int groups;          // N-tile groups per row tile
  int splits;          // pw1x1: K shares (a cluster of `splits` blocks)
  int chunks;          // K chunks of KC
  int tiles_n;         // N tiles of BN
  int units;           // row tiles x groups
  int tma;             // copies by TMA (see launch)
  int halo_boxes, halo_box_rows;  // sep2d's halo: boxes of at most 256 rows
  int vec_a;           // Cin % 4 == 0, x (and dw9) 16-byte aligned
  int vec_b;           // Cout % 4 == 0, w 16-byte aligned
  int vec_out;         // Cout % 4 == 0, out, scale, shift 16-byte aligned
};

__host__ __device__ inline int halo_rows(int bm, int W) {
  return bm + 2 * W + 2;
}

// The run of consecutive positions each producer's depthwise walks: the
// BM positions over np / 4 runs, made odd so that two runs in one 8-lane
// phase (rows run * 16 floats apart) read different banks.
__host__ __device__ inline int dw_run(int bm, int producers) {
  const int runs = producers / 4;
  const int run = (bm + runs - 1) / runs;
  return run | 1;
}

constexpr int PITCH = KC + 4;  // floats a staged A row
constexpr int TAP_FLOATS = 160;  // nine tap rows, padded to 128 bytes
constexpr int ALIGN = 128;       // bytes: every TMA destination

// sep2d's halo as TMA boxes: (boxes, rows a box), rows even so that each
// box ends on 128 bytes.
__host__ __device__ inline void halo_boxes(int bm, int W, int* boxes,
                                           int* box_rows) {
  const int rows = halo_rows(bm, W);
  *boxes = (rows + 255) / 256;
  *box_rows = ((rows + *boxes - 1) / *boxes + 1) & ~1;
}

// Floats of sep2d's staged halo: its boxes' rows.
__host__ __device__ inline int halo_floats(int bm, int W) {
  int boxes, box_rows;
  halo_boxes(bm, W, &boxes, &box_rows);
  return boxes * box_rows * KC;
}

// Floats of one ring stage: B (KC rows of BN), then A (BM rows of PITCH:
// pw1x1's x, or sep2d's chunk of D where it streams), then sep2d's halo
// (rows of KC) and its nine tap rows; each part a multiple of 128 bytes.
__host__ __device__ inline int stage_floats(bool sep, bool resident, int bm,
                                            int bn, int W) {
  return KC * bn + (sep && resident ? 0 : bm * PITCH) +
         (sep ? halo_floats(bm, W) + TAP_FLOATS : 0);
}

// sep2d's resident D: BM rows of every chunk.
__host__ __device__ inline int d_pitch(const Params& p) {
  return p.resident ? p.chunks * KC + 4 : PITCH;
}

// Dynamic shared memory of a block, in bytes: room to align the base,
// the ring, sep2d's resident D, then the stages' three mbarriers; the
// split-K reduction reuses the ring.
constexpr int BARRIER_BYTES = 3 * MAX_STAGES * 8;
__host__ __device__ inline int smem_bytes(bool sep, const Params& p, int bn) {
  const int bm = 8 * p.ty;
  int floats = p.stages * stage_floats(sep, p.resident, bm, bn, p.W);
  if (sep && p.resident) floats += bm * d_pitch(p);
  if (p.splits > 1 && bm * (bn + 4) > floats) floats = bm * (bn + 4);
  return ALIGN + floats * 4 + BARRIER_BYTES;
}

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
// An arrival on `bar` once every earlier cp.async of this thread has
// landed (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   hopper::smem_addr(bar))
               : "memory");
}

// `nrows` x `ncols` floats (ncols a power of two, 4 or more) from row
// `row0`, column `col0` of a row-major (rows, cols) matrix into shared
// rows `pitch` floats apart; neighbouring producers on neighbouring
// copies, each producer on one column and rows `step` apart. Zeros outside
// the matrix (negative rows too); a zero-byte copy keeps its source in
// bounds. vec: cols % 4 == 0 and `src` 16-byte aligned, four floats a copy.
__device__ __forceinline__ void stage_tile(float* dst, int pitch,
                                           const float* src, long long row0,
                                           long long rows, int col0, int cols,
                                           int nrows, int ncols, bool vec,
                                           int tid, int np) {
  const int per = vec ? 4 : 1;
  const int copies = ncols / per;  // a row's
  if (np % copies != 0) {          // no fixed column: one copy at a time
    for (int e = tid; e < nrows * copies; e += np) {
      const int r = e / copies, c = (e % copies) * per;
      const long long gr = row0 + r;
      const bool in = gr >= 0 && gr < rows && col0 + c < cols;
      const float* s = in ? src + gr * cols + col0 + c : src;
      if (vec) cp_async16(dst + r * pitch + c, s, in);
      else cp_async4(dst + r * pitch + c, s, in);
    }
    return;
  }
  const int c = (tid % copies) * per;
  const int step = np / copies;
  const bool col_in = col0 + c < cols;
  int r = tid / copies;
  long long gr = row0 + r;
  const float* s = src + gr * cols + col0 + c;
  float* d = dst + r * pitch + c;
  const long long s_step = static_cast<long long>(step) * cols;
  const int d_step = step * pitch;
  for (; r < nrows; r += step, gr += step, s += s_step, d += d_step) {
    const bool in = col_in && gr >= 0 && gr < rows;
    if (vec) cp_async16(d, in ? s : src, in);
    else cp_async4(d, in ? s : src, in);
  }
}

// ---------------------------------------------------------------------------
// The walk: unit, pass (N tile of the unit's group), chunk
// ---------------------------------------------------------------------------

struct Cursor {
  int unit, pass, chunk, passes, tile_m, n_tile;
  bool valid;

  __device__ void enter(const Params& p, int u) {
    unit = u;
    valid = u < p.units;
    if (!valid) return;
    const int per_group = (p.tiles_n + p.groups - 1) / p.groups;
    tile_m = u / p.groups;
    const int first = (u % p.groups) * per_group;
    passes = min(per_group, p.tiles_n - first);
    pass = 0;
    n_tile = first;
  }
  // One chunk on; `kb`, `ke`: the chunks of this block's K share.
  __device__ void advance(const Params& p, int kb, int ke) {
    if (++chunk < ke) return;
    chunk = kb;
    ++n_tile;
    if (++pass < passes) return;
    enter(p, unit + gridDim.x);
  }
};

// ---------------------------------------------------------------------------
// Compute
// ---------------------------------------------------------------------------

// One chunk of the product: `a` at the thread's first A row (its rows
// `astep` apart, K contiguous), `b` at column 4 tx of K-major B. The next
// four K steps' A values load while this four's FMAs run.
template <int TX>
__device__ __forceinline__ void product(float (&acc)[8][8], const float* a,
                                        int astep, const float* b) {
  constexpr int BP = 8 * TX;
  float4 av[8], an[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    av[i] = *reinterpret_cast<const float4*>(a + i * astep);
#pragma unroll
  for (int k4 = 0; k4 < KC; k4 += 4) {
    if (k4 + 4 < KC) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        an[i] = *reinterpret_cast<const float4*>(a + i * astep + k4 + 4);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* bk = b + (k4 + kk) * BP;
      const float4 b0 = *reinterpret_cast<const float4*>(bk);
      const float4 b1 = *reinterpret_cast<const float4*>(bk + 4 * TX);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y
                        : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
      }
    }
    if (k4 + 4 < KC) {
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = an[i];
    }
  }
}

__device__ __forceinline__ void fma4(float4& s, const float4& v,
                                     const float4& w) {
  s.x = fmaf(v.x, w.x, s.x); s.y = fmaf(v.y, w.y, s.y);
  s.z = fmaf(v.z, w.z, s.z); s.w = fmaf(v.w, w.w, s.w);
}

// Bit (dy + 1) * 3 + dx + 1: the tap lies inside the image, for the
// position `pos` of a B x H x W grid (0 past the last position).
__device__ __forceinline__ int tap_mask(const Params& p, int pos) {
  if (pos >= p.M) return 0;
  const int w = pos % p.W;
  const int h = (pos / p.W) % p.H;
  int mask = 0;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx)
      if (h + dy >= 0 && h + dy < p.H && w + dx >= 0 && w + dx < p.W)
        mask |= 1 << ((dy + 1) * 3 + dx + 1);
  return mask;
}

// The depthwise of one chunk: producer `tid` owns channel quad tid % 4
// of the run of positions r0 = (tid / 4) run, r0 + 1, ... (masks[i] for
// r0 + i); the halo's row W + 1 + r holds position r. A 3 x 3 window of
// the halo slides down the run: three new loads a position, ReLU on load.
// Writes D's rows `dpitch` floats apart.
__device__ __forceinline__ void depthwise(const Params& p, const float* halo,
                                          const float* taps, float* d,
                                          int dpitch, int bm, int run,
                                          const int (&masks)[MAX_RUN],
                                          int tid) {
  const int q = 4 * (tid & 3);
  const int r0 = (tid >> 2) * run;
  if (r0 >= bm) return;
  float4 wk[9];
#pragma unroll
  for (int t = 0; t < 9; ++t)
    wk[t] = *reinterpret_cast<const float4*>(taps + t * KC + q);
  const int W = p.W;
  const float* base = halo + (r0 + W + 1) * KC + q;  // r0's centre
  auto load = [&](int i, int dy, int dx) {
    float4 v = *reinterpret_cast<const float4*>(
        base + (i + dy * W + dx) * KC);
    if (p.relu) {
      v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
      v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
    }
    return v;
  };
  float4 win[3][3];  // [dy + 1][dx + 1]
#pragma unroll
  for (int i = 0; i < MAX_RUN; ++i) {
    if (i >= run || r0 + i >= bm) break;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      if (i == 0) {
        win[dy][0] = load(0, dy - 1, -1);
        win[dy][1] = load(0, dy - 1, 0);
      } else {
        win[dy][0] = win[dy][1];
        win[dy][1] = win[dy][2];
      }
      win[dy][2] = load(i, dy - 1, 1);
    }
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int t = 0; t < 9; ++t)
      if (masks[i] >> t & 1) fma4(s, win[t / 3][t % 3], wk[t]);
    *reinterpret_cast<float4*>(d + (r0 + i) * dpitch + q) = s;
  }
}

__device__ __forceinline__ float affine(float acc, float scale, float shift,
                                        bool relu) {
  const float y = __fadd_rn(__fmul_rn(acc, scale), shift);
  return relu ? fmaxf(y, 0.f) : y;
}

// Four channels n .. n + 3 of row m: one 16-byte store where the row
// allows it.
__device__ __forceinline__ void store4(const Params& p, long long m, int n,
                                       const float* v, bool relu) {
  if (m >= p.M || n >= p.Cout) return;
  float* dst = p.out + m * p.Cout + n;
  if (p.vec_out) {
    const float4 sc = *reinterpret_cast<const float4*>(p.scale + n);
    const float4 sh = *reinterpret_cast<const float4*>(p.shift + n);
    *reinterpret_cast<float4*>(dst) =
        make_float4(affine(v[0], sc.x, sh.x, relu),
                    affine(v[1], sc.y, sh.y, relu),
                    affine(v[2], sc.z, sh.z, relu),
                    affine(v[3], sc.w, sh.w, relu));
    return;
  }
  for (int e = 0; e < 4 && n + e < p.Cout; ++e)
    dst[e] = affine(v[e], p.scale[n + e], p.shift[n + e], relu);
}

// The epilogue of one pass, straight from the registers; m0, n0: the
// thread's first row and channel.
template <int TX>
__device__ __forceinline__ void store_tile(const Params& p,
                                           const float (&acc)[8][8],
                                           long long m0, int n0, bool relu) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + i * p.ty;
    store4(p, m, n0, acc[i], relu);
    store4(p, m, n0 + 4 * TX, acc[i] + 4, relu);
  }
}

__device__ __forceinline__ float4 ld_cluster4(const float* local,
                                              uint32_t rank) {
  float4 v;
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %4, %5;\n"
      "ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [remote];\n}\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "r"(hopper::smem_addr(local)), "r"(rank)
      : "memory");
  return v;
}

// Split K: the cluster's partial tiles summed in split order, rows
// [z BM / splits, (z + 1) BM / splits) by block z, then the epilogue. Run
// by the consumers; the producers only join the two cluster barriers.
template <int TX>
__device__ void reduce_cluster(const Params& p, const float (&acc)[8][8],
                               float* red, int tile_m, int n_tile, int ty,
                               int tx, int tid, int nt) {
  constexpr int BN = 8 * TX;
  constexpr int RP = BN + 4;
  const int bm = 8 * p.ty;
  hopper::named_sync(2, nt);  // every consumer is done with the ring
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = red + (ty + i * p.ty) * RP + 4 * tx;
    *reinterpret_cast<float4*>(row) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 4 * TX) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  hopper::cluster_sync();
  const int z = static_cast<int>(hopper::cluster_rank());
  const int r0 = z * bm / p.splits, r1 = (z + 1) * bm / p.splits;
  const long long m0 = static_cast<long long>(tile_m) * bm;
  const int n0 = n_tile * BN;
  for (int e = tid; e < (r1 - r0) * (BN / 4); e += nt) {
    const int r = r0 + e / (BN / 4);
    const int c = (e % (BN / 4)) * 4;
    float4 s = ld_cluster4(red + r * RP + c, 0);
    for (int part = 1; part < p.splits; ++part) {
      const float4 v = ld_cluster4(red + r * RP + c, part);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    const float sv[4] = {s.x, s.y, s.z, s.w};
    store4(p, m0 + r, n0 + c, sv, p.relu != 0);
  }
  hopper::cluster_sync();  // no block leaves while another reads it
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int TX, bool SEP>
__global__ void __launch_bounds__(MAX_THREADS, 1)
mainloop(const __grid_constant__ Params p) {
  constexpr int BN = 8 * TX;
  constexpr int BP = BN;  // floats a K row of B
  // aligned by an offset into the shared array, so that the compiler
  // keeps shared-memory loads
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* smem = reinterpret_cast<float*>(
      smem_raw + ((ALIGN - (hopper::smem_addr(smem_raw) & (ALIGN - 1))) &
                  (ALIGN - 1)));
  const int nc = p.ty * TX;  // consumers: threads [0, nc)
  const int bm = 8 * p.ty;
  const int dp = d_pitch(p);  // floats a row of sep2d's D
  const int stage = stage_floats(SEP, p.resident, bm, BN, p.W);
  const int hrows = halo_rows(bm, p.W);
  float* d = smem + p.stages * stage;  // sep2d's resident D
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem_raw + smem_bytes(SEP, p, BN) - BARRIER_BYTES);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* halo_full = empty + MAX_STAGES;  // sep2d: a first pass's copies
  int kb = 0, ke = p.chunks;
  if (!SEP && p.splits > 1) {
    kb = static_cast<int>(static_cast<long long>(blockIdx.z) * p.chunks /
                          p.splits);
    ke = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * p.chunks /
                          p.splits);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(&full[s], p.producers);
      hopper::mbar_init(&empty[s], nc);
      hopper::mbar_init(&halo_full[s], p.producers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= nc) {
    // ---------------- producers: loads, depthwise --------------------------
    const int tid = threadIdx.x - nc;
    const int np = p.producers;
    const int hfloats = halo_floats(bm, p.W);
    // One stage's copies, each producer arriving once on the barrier they
    // complete on: by TMA (one thread asks for every box) or by cp.async.
    auto issue = [&](const Cursor& c, int slot) {
      float* b = smem + slot * stage;
      const int k0 = c.chunk * KC;
      float* a = b + KC * BP;
      float* halo = a + (p.resident ? 0 : bm * PITCH);
      const long long m0 = static_cast<long long>(c.tile_m) * bm;
      const bool first = SEP && c.pass == 0;
      uint64_t* bar = first ? &halo_full[slot] : &full[slot];
      if (p.tma) {
        if (tid == 0) {
          int bytes = KC * BN * 4;
          if (!SEP) bytes += bm * PITCH * 4;
          if (first) bytes += (hfloats + 9 * KC) * 4;
          hopper::mbar_arrive_tx(bar, bytes);
          hopper::tma_load_2d(b, &p.wmap, c.n_tile * BN, k0, bar);
          if (!SEP)
            hopper::tma_load_2d(a, &p.xmap, k0, static_cast<int>(m0), bar);
          if (first) {
            const int row0 = static_cast<int>(m0) - p.W - 1;
            for (int j = 0; j < p.halo_boxes; ++j)
              hopper::tma_load_2d(halo + j * p.halo_box_rows * KC, &p.hmap,
                                  k0, row0 + j * p.halo_box_rows, bar);
            hopper::tma_load_2d(halo + hfloats, &p.tmap, k0, 0, bar);
          }
        } else {
          hopper::mbar_arrive(bar);
        }
        return;
      }
      stage_tile(b, BP, p.w, k0, p.Cin, c.n_tile * BN, p.Cout, KC, BN,
                 p.vec_b, tid, np);
      if (!SEP) {
        stage_tile(a, PITCH, p.x, m0, p.M, k0, p.Cin, bm, KC, p.vec_a, tid,
                   np);
      } else if (first) {
        stage_tile(halo, KC, p.x, m0 - p.W - 1, p.M, k0, p.Cin, hrows, KC,
                   p.vec_a, tid, np);
        stage_tile(halo + hfloats, KC, p.dw9, 0, 9, k0, p.Cin, 9, KC,
                   p.vec_a, tid, np);
      }
      cp_async_arrive(bar);
    };
    // ld issues stages (at least dc's, more while their slots are free);
    // a stage's copies arrive on its `full` barrier as they land, or, in
    // sep2d's first pass, on `halo_full`, and dc's depthwise then arrives
    // on `full`.
    Cursor ld, dc;
    ld.chunk = dc.chunk = kb;
    ld.enter(p, blockIdx.x);
    dc.enter(p, blockIdx.x);
    int ahead = 0;                  // stages issued beyond dc's
    int ld_slot = 0, ld_phase = 1;  // a fresh barrier: the phase before is done
    int slot = 0;
    int halo_phases = 0;            // bit s: the parity halo_full[s] is at
    const int run = dw_run(bm, np);
    int masks[MAX_RUN];
    int mask_unit = -1;
    while (dc.valid) {
      while (ld.valid && ahead < p.stages) {
        if (ahead == 0)
          hopper::mbar_wait(&empty[ld_slot], ld_phase);
        else if (!hopper::mbar_try_wait(&empty[ld_slot], ld_phase))
          break;
        issue(ld, ld_slot);
        ld.advance(p, kb, ke);
        ++ahead;
        if (++ld_slot == p.stages) { ld_slot = 0; ld_phase ^= 1; }
      }
      if (SEP && dc.pass == 0) {
        if (dc.unit != mask_unit) {
          mask_unit = dc.unit;
#pragma unroll
          for (int i = 0; i < MAX_RUN; ++i)
            masks[i] = tap_mask(p, dc.tile_m * bm + (tid >> 2) * run + i);
        }
        hopper::mbar_wait(&halo_full[slot], halo_phases >> slot & 1);
        halo_phases ^= 1 << slot;
        float* a = smem + slot * stage + KC * BP;
        float* halo = a + (p.resident ? 0 : bm * PITCH);
        depthwise(p, halo, halo + hfloats,
                  p.resident ? d + dc.chunk * KC : a, dp, bm, run, masks,
                  tid);
        hopper::mbar_arrive(&full[slot]);
      }
      dc.advance(p, kb, ke);
      --ahead;
      if (++slot == p.stages) slot = 0;
    }
    // no thread leaves with its copies in flight
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (!SEP && p.splits > 1) {  // the consumers' two cluster barriers
      hopper::cluster_sync();
      hopper::cluster_sync();
    }
    return;
  }

  // ---------------- consumers: the product, the epilogue -------------------
  // A warp covers 2 x 16 threads of a 32-wide grid with an even number of
  // rows (4 x 8 of an 8-wide, 2 x 16 of a 16-wide one): its B reads span
  // 256 bytes, its A reads two to four rows. A 32-wide grid of odd rows
  // takes a row a warp.
  const int wx = TX < 16 ? TX : TX == 32 && (p.ty & 1) ? 32 : 16;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ty = (warp / (TX / wx)) * (32 / wx) + lane / wx;
  const int tx = (warp % (TX / wx)) * wx + lane % wx;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  Cursor cc;
  cc.chunk = kb;
  cc.enter(p, blockIdx.x);
  int slot = 0, phase = 0;
  int tile_m = 0, n_tile = 0;
  while (cc.valid) {
    hopper::mbar_wait(&full[slot], phase);
    const float* b = smem + slot * stage;
    const float* a = SEP && p.resident ? d + ty * dp + cc.chunk * KC
                                       : b + KC * BP + ty * PITCH;
    product<TX>(acc, a, p.ty * dp, b + 4 * tx);
    hopper::mbar_arrive(&empty[slot]);
    tile_m = cc.tile_m;
    n_tile = cc.n_tile;
    if (cc.chunk + 1 == ke && (SEP || p.splits == 1)) {
      store_tile<TX>(p, acc, static_cast<long long>(tile_m) * bm + ty,
                     n_tile * BN + 4 * tx, !SEP && p.relu);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    cc.advance(p, kb, ke);
    if (++slot == p.stages) { slot = 0; phase ^= 1; }
  }
  if (!SEP && p.splits > 1)  // one unit a block: the cluster's tile
    reduce_cluster<TX>(p, acc, smem, tile_m, n_tile, ty, tx, tid, nc);
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// The plan, checked against what the kernel can run.
inline bool plan_ok(bool sep, const Params& p, int bn, int blocks) {
  const int nt = p.ty * (bn / 8);
  if (p.M <= 0 || p.Cin <= 0 || p.Cout <= 0 || nt < 32 ||
      nt > MAX_CONSUMERS || nt % 32 != 0 ||
      p.producers < 64 || p.producers % 32 != 0 ||
      nt + p.producers > MAX_THREADS || p.stages < 2 ||
      p.stages > MAX_STAGES || p.groups < 1 ||
      (p.groups - 1) * ((p.tiles_n + p.groups - 1) / p.groups) >= p.tiles_n ||
      p.splits < 1 || p.splits > MAX_SPLITS || blocks < 1 ||
      blocks > p.units)
    return false;
  if (p.chunks != (p.Cin + KC - 1) / KC || p.tiles_n != (p.Cout + bn - 1) / bn)
    return false;
  const long long tiles_m = (p.M + 8LL * p.ty - 1) / (8LL * p.ty);
  if (tiles_m * p.groups != p.units) return false;
  if (sep) {
    // resident: a unit's D rows are rewritten only after the consumers are
    // `stages` chunks past the last unit's reading of them
    if ((p.resident && p.chunks < p.stages) || p.splits != 1 ||
        (!p.resident && p.groups != p.tiles_n) || p.H <= 0 || p.W <= 0 ||
        p.M % (static_cast<long long>(p.H) * p.W) != 0 ||
        dw_run(8 * p.ty, p.producers) > MAX_RUN)
      return false;
  } else if (p.groups != p.tiles_n || p.resident) {
    return false;
  }
  // split K: one unit a block, each share at least one chunk
  if (p.splits > 1 && (blocks != p.units || p.chunks < p.splits))
    return false;
  return smem_bytes(sep, p, bn) <= 232448;
}

// A 2-D float32 tensor map over a row-major (rows, cols) matrix at `base`,
// boxes of (box_rows, box_cols), zeros outside; false on failure.
inline bool encode_f32_2d(CUtensorMap* map, const void* base, uint64_t rows,
                          uint64_t cols, uint32_t box_rows,
                          uint32_t box_cols) {
  hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 4};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// static: the raised limit is this library's (an inline function's static
// would be one object across every library loaded in the process).
template <int TX, bool SEP>
static int launch_one(const Params& p, int blocks, cudaStream_t stream) {
  auto kernel = mainloop<TX, SEP>;
  const int smem = smem_bytes(SEP, p, 8 * TX);
  static int allowed = 48 * 1024;  // this instantiation's raised limit
  if (smem > allowed) {
    const int err = hopper::allow_smem(kernel, smem);
    if (err != 0) return err;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, p.splits);
  cfg.blockDim = dim3(p.ty * TX + p.producers);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.splits;
  cfg.attrs = attr;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launches the body for a plan with N tiles of `bn` channels (64, 128 or
// 256); cudaErrorInvalidValue for a plan it cannot run. Copies move four
// floats where the rows allow it.
template <bool SEP>
inline int launch(Params p, int bn, int blocks, cudaStream_t stream) {
  if (!plan_ok(SEP, p, bn, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* a, const void* b, const void* c) {
    return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
             reinterpret_cast<uintptr_t>(c)) & 15) == 0;
  };
  p.vec_a = p.Cin % 4 == 0 && aligned(p.x, SEP ? p.dw9 : p.x, p.x);
  p.vec_b = p.Cout % 4 == 0 && aligned(p.w, p.w, p.w);
  p.vec_out = p.Cout % 4 == 0 && aligned(p.out, p.scale, p.shift);
  // TMA wherever the rows allow it
  const int bm = 8 * p.ty;
  halo_boxes(bm, p.W, &p.halo_boxes, &p.halo_box_rows);
  p.tma = p.vec_a && p.vec_b &&
          encode_f32_2d(&p.wmap, p.w, p.Cin, p.Cout, KC, bn) &&
          (SEP ? encode_f32_2d(&p.hmap, p.x, p.M, p.Cin, p.halo_box_rows,
                               KC) &&
                     encode_f32_2d(&p.tmap, p.dw9, 9, p.Cin, 9, KC)
               : encode_f32_2d(&p.xmap, p.x, p.M, p.Cin, bm, PITCH));
  switch (bn) {
    case 64: return launch_one<8, SEP>(p, blocks, stream);
    case 128: return launch_one<16, SEP>(p, blocks, stream);
    case 256: return launch_one<32, SEP>(p, blocks, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace simt32
}  // namespace sparkdl
