// preproc_resize: cast + bilinear resize (half-pixel centres, no
// antialias, edge-clamped) of an NHWC batch; uint8, float32 or bf16 in,
// float32 or bf16 out, any channel count.
//
// Replaces the Pallas kernel sparkdl_tpu/core/kernels.py::preproc_resize
// (body _preproc_kernel, weights _resize_matrix), which computes
// Wh . X . Ww^T per (image, channel) plane as two MXU products.
//
// What bounds it on an H100: bytes, once the index arithmetic is gone.
// 16 uint8 images of 256x256x3 resized to 299x299 in float32 read 3.1 MB
// and write 17.2 MB (6.1 us at 3.35 TB/s) for ~39 MFLOP. A kernel with one
// thread an output element spends ~150-250 instructions on each (three
// 64-bit divisions by runtime values, eight tap-table loads, four
// single-byte source loads at stride C): instructions bound it, not bytes.
//
// Design. Each row of Wh and Ww has at most two non-zeros, so an output
// element is two row taps and two column taps; the host builds them from
// _resize_matrix (core/kernels.py::_resize_taps) with the launch plan
// (core/kernels.py::plan_preproc) and its tables. C enters only there:
// the kernel walks flat (column, channel) indices of a row, so it divides
// nothing per element.
// - One block owns a band of R output rows of one image (grid: bands x
//   images). The source rows those rows tap are few runs of consecutive
//   rows (one run for an upscale; two rows an output row for a steep
//   downscale), each one contiguous range of device memory. One thread
//   stages every run into shared memory with TMA bulk copies
//   (cp.async.bulk, completing on one mbarrier) of its 16-byte aligned
//   interior; the ragged head and tail bytes of each run go by plain
//   loads. A run's staging slot starts at the run's own address modulo
//   16, so the interior lands 16-byte aligned. uint8 stays uint8 there.
//   Where even one output row's two tap rows do not fit, the vertical
//   pass reads the image in device memory instead (the plan's
//   staged = false).
// - Vertical pass, once per source column: for each band row and each
//   tapped source (column, channel), t = wy0 * a(y0) + wy1 * a(y1) into a
//   float32 row in shared memory. Columns no output column taps are
//   skipped (a table compacts them; dense when every column is tapped).
// - Horizontal pass: each thread keeps one output (column, channel)'s two
//   t indices and weights in registers and walks the band's rows:
//   out = wx0 * t0 + wx1 * t1, rounded once to the output type into a
//   shared-memory image of the band's output, which is one contiguous
//   span of R * TW * C elements in device memory.
// - Stores: the span's 16-byte aligned interior as 16-byte vectors (the
//   shared image is shifted by the span's address modulo 16, so both
//   sides are aligned; image bases are not: 299 * 299 * 3 is odd), the
//   ragged head and tail one element at a time.
// Several blocks share an SM, so one block's staging overlaps another's
// passes and stores. On an H100 80GB HBM3 (700 W) the 256x256 case takes
// about twice its bytes' time; experiments/preproc_breakdown.py shows
// where the rest goes (each block's fixed chain of table loads, staging
// and barriers; the two passes; the stores).
//
// Arithmetic is the Wh.X then .Ww^T order of the reference, with separate
// multiplies and adds (no FMA contraction), all in float32, rounded once:
// bit for bit what one thread an element computed before.

#include "common.cuh"
#include "wgmma_bf16.cuh"  // mbarriers

namespace {

namespace hp = sparkdl::hopper;

constexpr int THREADS = 256;
// The launcher's fixed layout: the mbarrier, then R band-row records.
constexpr int INFO_OFF = 16;

struct Params {
  const void* x;
  void* out;
  const int4* runs;      // RS a band: first source row, rows, staging
                         // byte offset; the band's first .w: its runs
  const int4* rowtab;    // each output row: y0, y1, their runs in the band
  const float2* ywt;     // each output row: wy0, wy1
  const int* vsrc;       // each t column: its element in a source row
  const int4* htab;      // each output (column, channel): h0, h1, wx0, wx1
  int H, WC, TH, TWC, R, NXC, RS;
  int src_off, t_off, out_off;
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(hp::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(hp::smem_addr(bar))
      : "memory");
}

// uint8 widened without I2F (a quarter-rate conversion): 2^23 + v in a
// float's bits, less 2^23, exact for every byte.
__device__ __forceinline__ float widen(const uint8_t* p) {
  return __fsub_rn(__uint_as_float(0x4B000000u | *p), 8388608.0f);
}
template <typename T>
__device__ __forceinline__ float widen(const T* p) {
  return sparkdl::load_f(p);
}

// A run's byte range [a, e) in device memory and its 16-byte aligned
// interior [lo, hi) (empty when lo >= hi).
struct Span {
  uintptr_t a, e, lo, hi;
};

__device__ __forceinline__ Span run_span(uintptr_t img, int4 run,
                                         int row_bytes) {
  Span s;
  s.a = img + static_cast<uintptr_t>(run.x) * row_bytes;
  s.e = s.a + static_cast<uintptr_t>(run.y) * row_bytes;
  s.lo = (s.a + 15) & ~static_cast<uintptr_t>(15);
  s.hi = s.e & ~static_cast<uintptr_t>(15);
  return s;
}

template <typename Tin, typename Tout, bool STAGED, bool DENSE>
__global__ void __launch_bounds__(THREADS)
preproc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int4* info = reinterpret_cast<int4*>(smem + INFO_OFF);
  constexpr int IN = static_cast<int>(sizeof(Tin));
  const int tid = threadIdx.x, band = blockIdx.x;
  const int oy0 = band * p.R, rows = min(p.R, p.TH - oy0);
  const Tin* img = static_cast<const Tin*>(p.x) +
                   static_cast<long long>(blockIdx.y) * p.H * p.WC;
  const uintptr_t img_addr = reinterpret_cast<uintptr_t>(img);
  const int row_bytes = p.WC * IN;

  // Staging: bulk copies of each run's interior, plain loads of the rest.
  int first = 0;
  if constexpr (STAGED) {
    first = band * p.RS;
    const int nruns = p.runs[first].w;
    if (tid == 0) {
      hp::mbar_init(bar, 1);
      hp::mbar_fence_init();
      uint32_t bytes = 0;
      for (int k = 0; k < nruns; ++k) {
        const Span s = run_span(img_addr, p.runs[first + k], row_bytes);
        if (s.lo < s.hi) bytes += static_cast<uint32_t>(s.hi - s.lo);
      }
      hp::mbar_arrive_tx(bar, bytes);
      for (int k = 0; k < nruns; ++k) {
        const int4 run = p.runs[first + k];
        const Span s = run_span(img_addr, run, row_bytes);
        if (s.lo < s.hi)
          bulk_load(smem + p.src_off + run.z + (s.lo - (s.a & ~15)),
                    reinterpret_cast<const void*>(s.lo),
                    static_cast<uint32_t>(s.hi - s.lo), bar);
      }
    }
    // 32 elements a run: up to 15 bytes of head and of tail, or all of a
    // run under 32 bytes that holds no aligned 16 bytes.
    for (int i = tid; i < nruns * 32; i += THREADS) {
      const int4 run = p.runs[first + (i >> 5)];
      const Span s = run_span(img_addr, run, row_bytes);
      const int m = i & 31;
      uintptr_t at;
      bool ok;
      if (s.lo < s.hi) {
        at = m < 16 ? s.a + m * IN : s.hi + (m - 16) * IN;
        ok = m < 16 ? at < s.lo : at < s.e;
      } else {
        at = s.a + m * IN;
        ok = at < s.e;
      }
      if (ok)
        *reinterpret_cast<Tin*>(smem + p.src_off + run.z + (s.a & 15) +
                                (at - s.a)) =
            *reinterpret_cast<const Tin*>(at);
    }
  }
  // Each band row: where its two tap rows start (in the staging area, or
  // in the image) and their weights.
  if (tid < rows) {
    const int4 rt = p.rowtab[oy0 + tid];
    const float2 w = p.ywt[oy0 + tid];
    int off0, off1;
    if constexpr (STAGED) {
      const int4 r0 = p.runs[first + rt.z], r1 = p.runs[first + rt.w];
      const uintptr_t a0 = img_addr + static_cast<uintptr_t>(r0.x) * row_bytes;
      const uintptr_t a1 = img_addr + static_cast<uintptr_t>(r1.x) * row_bytes;
      off0 = (r0.z + static_cast<int>(a0 & 15)) / IN + (rt.x - r0.x) * p.WC;
      off1 = (r1.z + static_cast<int>(a1 & 15)) / IN + (rt.y - r1.x) * p.WC;
    } else {
      off0 = rt.x * p.WC;
      off1 = rt.y * p.WC;
    }
    info[tid] = make_int4(off0, off1, __float_as_int(w.x),
                          __float_as_int(w.y));
  }
  __syncthreads();
  if constexpr (STAGED) hp::mbar_wait(bar, 0);

  // Vertical pass: t[r][q] for each band row r and tapped column q.
  float* t = reinterpret_cast<float*>(smem + p.t_off);
  const Tin* src;
  if constexpr (STAGED)
    src = reinterpret_cast<const Tin*>(smem + p.src_off);
  else
    src = img;
  for (int r = 0; r < rows; ++r) {
    const int4 in = info[r];
    const Tin* a0 = src + in.x;
    const Tin* a1 = src + in.y;
    const float wy0 = __int_as_float(in.z), wy1 = __int_as_float(in.w);
    float* tr = t + r * p.NXC;
    for (int q = tid; q < p.NXC; q += THREADS) {
      const int v = DENSE ? q : __ldg(p.vsrc + q);
      tr[q] = __fadd_rn(__fmul_rn(wy0, widen(a0 + v)),
                        __fmul_rn(wy1, widen(a1 + v)));
    }
  }
  __syncthreads();

  // Horizontal pass into the band's output image, shifted so that its
  // bytes sit at the span's own address modulo 16.
  Tout* gout = static_cast<Tout*>(p.out) +
               (static_cast<long long>(blockIdx.y) * p.TH + oy0) * p.TWC;
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(gout) & 15);
  Tout* o = reinterpret_cast<Tout*>(smem + p.out_off + shift);
  for (int j = tid; j < p.TWC; j += THREADS) {
    const int4 h = __ldg(p.htab + j);
    const float wx0 = __int_as_float(h.z), wx1 = __int_as_float(h.w);
    const float* tr = t;
    Tout* orow = o + j;
#pragma unroll 4
    for (int r = 0; r < rows; ++r, tr += p.NXC, orow += p.TWC)
      sparkdl::store_f(orow, __fadd_rn(__fmul_rn(wx0, tr[h.x]),
                                       __fmul_rn(wx1, tr[h.y])));
  }
  __syncthreads();

  // Stores: the aligned interior in 16-byte vectors, the ends one by one.
  constexpr int PER = 16 / static_cast<int>(sizeof(Tout));
  const int n = rows * p.TWC;
  const int head = min(n, ((16 - shift) & 15) / static_cast<int>(sizeof(Tout)));
  const int vecs = (n - head) / PER;
  if (tid < head) gout[tid] = o[tid];
  const uint4* ov = reinterpret_cast<const uint4*>(o + head);
  uint4* gv = reinterpret_cast<uint4*>(gout + head);
  for (int i = tid; i < vecs; i += THREADS) gv[i] = ov[i];
  const int tail = head + vecs * PER;
  if (tail + tid < n) gout[tail + tid] = o[tail + tid];
}

template <typename Tin, typename Tout, bool STAGED, bool DENSE>
int launch(const Params& p, int bands, int images, int smem,
           cudaStream_t stream) {
  auto kernel = preproc_kernel<Tin, Tout, STAGED, DENSE>;
  static int allowed = 48 * 1024;  // this library's own, per instantiation
  if (smem > allowed) {
    const int err = hp::allow_smem(kernel, smem);
    if (err != 0) return err;
    allowed = smem;
  }
  kernel<<<dim3(bands, images), THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int dispatch_mode(const Params& p, int bands, int images, int smem,
                  int staged, cudaStream_t s) {
  const bool dense = p.vsrc == nullptr;
  if (staged)
    return dense ? launch<Tin, Tout, true, true>(p, bands, images, smem, s)
                 : launch<Tin, Tout, true, false>(p, bands, images, smem, s);
  return dense ? launch<Tin, Tout, false, true>(p, bands, images, smem, s)
               : launch<Tin, Tout, false, false>(p, bands, images, smem, s);
}

template <typename Tin>
int dispatch_out(const Params& p, int bands, int images, int smem,
                 int staged, int out_dtype, cudaStream_t s) {
  if (out_dtype == 0)
    return dispatch_mode<Tin, float>(p, bands, images, smem, staged, s);
  if (out_dtype == 1)
    return dispatch_mode<Tin, __nv_bfloat16>(p, bands, images, smem, staged,
                                             s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16, 2 = uint8 (input only). The tables
// and the shared-memory layout (src_off, t_off, out_off, smem bytes) come
// from core/kernels.py::plan_preproc; vsrc is null when every source
// column is tapped. WC = W * C and TWC = TW * C: the kernel never sees C.
// Refuses (cudaErrorInvalidValue) a plan it cannot run. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int sparkdl_preproc_resize(
    const void* x, void* out, const void* runs, const void* rowtab,
    const void* ywt, const void* vsrc, const void* htab, int B, int H,
    int WC, int TH, int TWC, int R, int NXC, int RS, int src_off,
    int t_off, int out_off, int smem, int staged, int in_dtype,
    int out_dtype, void* stream) {
  const int bands = R > 0 ? (TH + R - 1) / R : 0;
  const bool aligned = src_off % 16 == 0 && t_off % 16 == 0 &&
                       out_off % 16 == 0;
  if (B <= 0 || B > 65535 || H <= 0 || WC <= 0 || TH <= 0 || TWC <= 0 ||
      R <= 0 || R > THREADS || NXC <= 0 || !aligned ||
      src_off < INFO_OFF + 16 * R || t_off < src_off ||
      out_off < t_off + 4 * R * NXC || smem > 232448 ||
      smem < out_off + 16 + R * TWC * (out_dtype == 0 ? 4 : 2) ||
      (staged && (runs == nullptr || RS <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.out = out;
  p.runs = static_cast<const int4*>(runs);
  p.rowtab = static_cast<const int4*>(rowtab);
  p.ywt = static_cast<const float2*>(ywt);
  p.vsrc = static_cast<const int*>(vsrc);
  p.htab = static_cast<const int4*>(htab);
  p.H = H;
  p.WC = WC;
  p.TH = TH;
  p.TWC = TWC;
  p.R = R;
  p.NXC = NXC;
  p.RS = RS;
  p.src_off = src_off;
  p.t_off = t_off;
  p.out_off = out_off;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    return dispatch_out<float>(p, bands, B, smem, staged, out_dtype, s);
  if (in_dtype == 1)
    return dispatch_out<__nv_bfloat16>(p, bands, B, smem, staged, out_dtype,
                                       s);
  if (in_dtype == 2)
    return dispatch_out<uint8_t>(p, bands, B, smem, staged, out_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
