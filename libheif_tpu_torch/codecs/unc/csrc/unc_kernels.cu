// Hand-written Hopper (sm_90a) kernels for the unci decode + YCbCr->RGB path.
//
// Three kernels replace the five pl.pallas_call sites of
// libheif_tpu/codecs/unc/pallas_fast.py:
//
//   tile_yuv_to_rgb        <- yuv420_tiles_to_rgb (:47, call :124) and
//                             yuv_tiles_to_rgb (:301, call :370)
//   planes_ycbcr8_to_rgb   <- ycbcr8_planes_to_rgb (:189, call :236), with
//                             _upsample_int16 (:144) fused in
//   strided_extract_paste  <- fused_strided_decode (:415) / _paste_tiles
//                             (:390, call :401), and planar8_tiles_to_image
//                             (:258, call :282) as its copy case
//
// What bounds them on an H100: device-memory bytes, and, close behind, the
// instructions issued.  A colour kernel moves 4.5 bytes per output pixel
// (1.5 read, 3 written), so at 3.35 TB/s the card has time for only about
// 45 thread-instructions per pixel (132 SMs x 4 schedulers x 32 lanes x
// ~1.98 GHz).  The colour kernels are built around that budget:
//
// * Work: one thread computes a run of 16 neighbouring pixels in each of
//   the two output rows that share a chroma row (one row when nothing is
//   shared).  The tile kernel's block covers a band of one tile, so the
//   tile index, base pointer and plane offsets are computed once per block
//   and thread, never per pixel, and offsets inside a tile are 32-bit.
//   Chroma taps are shifts (o >> 1) or, for a nearest resize of any other
//   ratio, a table of (o*n)/N built once per block in shared memory.
// * Memory: every load of a thread is issued before any arithmetic (48 to
//   80 bytes in flight per thread) through the read-only path, in vectors
//   of V = 16, 8, 4 or 1 bytes; the host picks V as the largest width that
//   divides every row pitch, plane offset, width and base address
//   (cuda_fast.vector_width), so each access is aligned.  The (T, S+8) tile
//   buffers of 512x512 4:2:0 tiles have a 393,224-byte pitch, so they get
//   8-byte loads (their output rows still get 16-byte stores, chosen
//   apart from the loads); TMA would need 16-byte aligned rows, and with no byte
//   reused beyond a one-column chroma halo a shared-memory ring would buy
//   nothing the vector loads do not.  Output rows leave as streaming
//   vector stores (st.global.cs).  The bilinear chroma halo comes from the
//   neighbouring lanes (shfl), and the warp's edge lanes load it.
// * Arithmetic: the f32 operations of the reference, in its order, done
//   once per chroma sample where they depend on chroma only.  A byte
//   becomes a float with one PRMT (2^23 + b as bits) and one FADD; a scaled
//   chroma integer v becomes v/s - 128 with one IADD and one FADD the same
//   way.  The division by g_den is q = x*r refined by one residual step
//   (r = RN(1/g_den)); round + clamp is one cvt.rni.sat.u8.f32 (F2IP.U8)
//   and PRMT packs four results.  Full range is a template parameter, so
//   it does no range arithmetic.
//
// Exactness: every step above gives the same f32 value as the reference
// per-pixel core below (ops.py:220-226 with _rn intrinsics, rintf, fminf,
// fmaxf and __fdiv_rn), which is kept for colour_core_check_kernel: that
// kernel compares the two over every reachable input.  The file is built
// with -fmad=false, and the constants arrive folded in f64 and cast once
// to f32, as pallas_fast.py:75-81 does.
//
// Every entry point takes the CUDA device index and stream last and returns
// the cudaError_t of its launch; it allocates nothing and does not
// synchronise.

#include <climits>
#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kWarp = 32;
constexpr int kRun = 16;                 // colour kernels: pixels per row
constexpr int kWarps = kThreads / kWarp;
constexpr int kSpan = kWarp * kRun;      // planes kernel: columns per block
constexpr int kMaxItems = 1 << 20;

struct Matrix {
  float krf, kbf, c_cr, c_cb, g_den;  // H.273 constants
  float y_mul, c_mul;                 // limited range: 255/219, 255/224
  int full_range;
};

// ---------------------------------------------------------------------------
// The reference per-pixel core: ops.py:215-226 for one pixel, cbf/crf with
// the 128 offset already removed.  Used only by colour_core_check_kernel.
__device__ __forceinline__ uint8_t pack_u8(float v) {
  v = rintf(v);
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  return static_cast<uint8_t>(v);
}

__device__ __forceinline__ void ycbcr_to_rgb(float yf, float cbf, float crf,
                                             const Matrix& m, uint8_t rgb[3]) {
  if (!m.full_range) {
    yf = __fmul_rn(__fsub_rn(yf, 16.0f), m.y_mul);
    cbf = __fmul_rn(cbf, m.c_mul);
    crf = __fmul_rn(crf, m.c_mul);
  }
  const float r = __fadd_rn(yf, __fmul_rn(m.c_cr, crf));
  const float b = __fadd_rn(yf, __fmul_rn(m.c_cb, cbf));
  const float g = __fdiv_rn(
      __fsub_rn(__fsub_rn(yf, __fmul_rn(m.krf, r)), __fmul_rn(m.kbf, b)),
      m.g_den);
  rgb[0] = pack_u8(r);
  rgb[1] = pack_u8(g);
  rgb[2] = pack_u8(b);
}

// ---------------------------------------------------------------------------
// The colour core of both colour kernels; FULL (full range) is a template
// parameter of every kernel, so full range does no range arithmetic.
struct Core {
  float krf, kbf, c_cr, c_cb, g_den;
  float g_rcp;          // RN(1 / g_den)
  float y_mul, c_mul;   // limited range: 255/219, 255/224
  int full;
};

Core core_of(const Matrix& m) {
  Core c;
  c.krf = m.krf;
  c.kbf = m.kbf;
  c.c_cr = m.c_cr;
  c.c_cb = m.c_cb;
  c.g_den = m.g_den;
  c.g_rcp = 1.0f / m.g_den;   // host SSE division: correctly rounded
  c.y_mul = m.y_mul;
  c.c_mul = m.c_mul;
  c.full = m.full_range != 0;
  return c;
}

// Scaled chroma v (the exact chroma times s = 1, 4 or 16, at most 4080) to
// v/s - 128: the bits of M = 1.5 * 2^23 / s plus v are the float M + v/s,
// exactly, and subtracting M + 128 is exact too.
struct ChromaBias {
  int bits;     // bits of M
  float sub;    // -(M + 128)
};

ChromaBias chroma_bias(int scale) {
  const float M = 12582912.0f / static_cast<float>(scale);
  ChromaBias cb;
  std::memcpy(&cb.bits, &M, sizeof M);
  cb.sub = -(M + 128.0f);
  return cb;
}

constexpr float kByteChromaSub = -8388736.0f;   // -(2^23 + 128)

// Byte i of w as the float 2^23 + b: one PRMT.
__device__ __forceinline__ float byte_biased(uint32_t w, int i) {
  return __int_as_float(static_cast<int>(__byte_perm(w, 0x4B000000u, 0x7440u | i)));
}

// Byte i of w, zero-extended.
__device__ __forceinline__ int byte_at(uint32_t w, int i) {
  return static_cast<int>(__byte_perm(w, 0u, 0x4440u | i));
}

// Y (full range) or (Y - 16) * y_mul (limited) from byte i of w.
template <bool FULL>
__device__ __forceinline__ float luma_f(uint32_t w, int i, const Core& c) {
  const float b = byte_biased(w, i);
  if constexpr (FULL)
    return __fadd_rn(b, -8388608.0f);
  else
    return __fmul_rn(__fadd_rn(b, -8388624.0f), c.y_mul);
}

__device__ __forceinline__ float scaled_chroma_f(int biased, float sub) {
  return __fadd_rn(__int_as_float(biased), sub);
}

struct Terms {
  float cr, cb;   // c_cr * crf and c_cb * cbf, range scale applied
};

template <bool FULL>
__device__ __forceinline__ Terms terms_of(float cbf, float crf, const Core& c) {
  if constexpr (!FULL) {
    cbf = __fmul_rn(cbf, c.c_mul);
    crf = __fmul_rn(crf, c.c_mul);
  }
  return {__fmul_rn(c.c_cr, crf), __fmul_rn(c.c_cb, cbf)};
}

// rint(v) clamped to 0..255 in one instruction (F2IP.U8): round half to
// even, then saturate, as rintf, fmaxf, fminf and the cast do.
__device__ __forceinline__ uint32_t u8_bits(float v) {
  uint32_t r;
  asm("cvt.rni.sat.u8.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void pixel(float yf, Terms t, const Core& c,
                                      uint32_t& r8, uint32_t& g8,
                                      uint32_t& b8) {
  const float r = __fadd_rn(yf, t.cr);
  const float b = __fadd_rn(yf, t.cb);
  const float x =
      __fsub_rn(__fsub_rn(yf, __fmul_rn(c.krf, r)), __fmul_rn(c.kbf, b));
  // x / g_den: x * RN(1/g_den), corrected once by the exact residual;
  // colour_core_check_kernel holds it equal to __fdiv_rn on every input
  float q = __fmul_rn(x, c.g_rcp);
  q = __fmaf_rn(__fmaf_rn(-q, c.g_den, x), c.g_rcp, q);
  r8 = u8_bits(r);
  g8 = u8_bits(q);
  b8 = u8_bits(b);
}

// Low bytes of a, b, c, d packed little-endian: three PRMT.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040u), __byte_perm(c, d, 0x0040u),
                     0x5410u);
}

// ---------------------------------------------------------------------------
// Runs of N bytes (16 or 8) in vectors of min(V, N) bytes.  Only bytes
// [0, valid) are touched; valid is a multiple of the vector width (the host
// chose V so), or any count when V is 1.  Bytes not read are zero.
template <int V, int N>
__device__ __forceinline__ void load_run(const uint8_t* __restrict__ p,
                                         int valid, uint32_t (&w)[N / 4]) {
  constexpr int VW = V < N ? V : N;
  if constexpr (VW == 16) {
    const uint4 v = valid > 0 ? __ldg(reinterpret_cast<const uint4*>(p))
                              : make_uint4(0, 0, 0, 0);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (VW == 8) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const uint2 v = j * 8 < valid
                          ? __ldg(reinterpret_cast<const uint2*>(p) + j)
                          : make_uint2(0, 0);
      w[2 * j] = v.x;
      w[2 * j + 1] = v.y;
    }
  } else if constexpr (VW == 4) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      w[j] = j * 4 < valid
                 ? __ldg(reinterpret_cast<const unsigned int*>(p) + j)
                 : 0u;
  } else {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * j + k < valid)
          v |= static_cast<uint32_t>(__ldg(p + 4 * j + k)) << (8 * k);
      w[j] = v;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_run(uint8_t* __restrict__ p, int valid,
                                          const uint32_t (&w)[kRun / 4]) {
  if constexpr (V == 16) {
    if (valid > 0)
      __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  } else if constexpr (V == 8) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (j * 8 < valid)
        __stcs(reinterpret_cast<uint2*>(p) + j,
               make_uint2(w[2 * j], w[2 * j + 1]));
  } else if constexpr (V == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j * 4 < valid) __stcs(reinterpret_cast<unsigned int*>(p) + j, w[j]);
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (k < valid) p[k] = static_cast<uint8_t>(w[k >> 2] >> (8 * (k & 3)));
  }
}

// Three output planes of one row run, from its luma words and the chroma
// terms of each pixel (tm(k) for pixel k).
template <int V, bool FULL, typename TermsOf>
__device__ __forceinline__ void convert_store(const uint32_t (&yw)[4],
                                              TermsOf tm, const Core& c,
                                              uint8_t* __restrict__ row,
                                              long long plane, int valid) {
  uint32_t rw[4], gw[4], bw[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t r8[4], g8[4], b8[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      pixel(luma_f<FULL>(yw[q], k, c), tm(4 * q + k), c, r8[k], g8[k],
            b8[k]);
    rw[q] = pack4(r8[0], r8[1], r8[2], r8[3]);
    gw[q] = pack4(g8[0], g8[1], g8[2], g8[3]);
    bw[q] = pack4(b8[0], b8[1], b8[2], b8[3]);
  }
  store_run<V>(row, valid, rw);
  store_run<V>(row + plane, valid, gw);
  store_run<V>(row + 2 * plane, valid, bw);
}

// ---------------------------------------------------------------------------
// tile_yuv_to_rgb: (T, pitch) u8 tile buffers, each Y | Cb | Cr planes of an
// 8-bit component-interleaved tile with chroma subsampling SX, SY in {1, 2},
// to the (3, H, W) u8 RGB image with every tile at its place; nearest
// chroma upsampling.  Work item = (tile, band of kThreads runs); a run is 16
// pixels in each of the SY rows that share one chroma row.
struct TileArgs {
  const uint8_t* tiles;
  uint8_t* out;
  long long pitch, plane;   // plane = H * W
  int tile_cols, tile_h, tile_w, W;
  int runs;                 // runs per tile row: ceil(tile_w / 16)
  int bands, items;         // bands per tile, tiles * bands
  Core c;
};

template <int V, int VS, int SX, int SY, bool FULL>
__global__ void __launch_bounds__(kThreads)
    tile_yuv_to_rgb_kernel(const TileArgs a) {
  constexpr int kC = kRun / SX;          // chroma samples per run
  const int cw = a.tile_w / SX;
  const int luma = a.tile_h * a.tile_w;
  const int chroma = (a.tile_h / SY) * cw;
  const int units = (a.tile_h / SY) * a.runs;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const int t = item / a.bands;
    const int u = (item - t * a.bands) * kThreads + threadIdx.x;
    if (u >= units) continue;
    const int cy = u / a.runs;            // chroma row
    const int tx = (u - cy * a.runs) * kRun;
    const int n = min(kRun, a.tile_w - tx);
    const uint8_t* tb = a.tiles + t * a.pitch;
    uint32_t yw[SY][4];
#pragma unroll
    for (int r = 0; r < SY; ++r)
      load_run<V, kRun>(tb + (cy * SY + r) * a.tile_w + tx, n, yw[r]);
    uint32_t cbw[kC / 4], crw[kC / 4];
    const int co = luma + cy * cw + tx / SX;
    load_run<V, kC>(tb + co, n / SX, cbw);
    load_run<V, kC>(tb + co + chroma, n / SX, crw);
    Terms tm[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j)
      tm[j] = terms_of<FULL>(
          __fadd_rn(byte_biased(cbw[j >> 2], j & 3), kByteChromaSub),
          __fadd_rn(byte_biased(crw[j >> 2], j & 3), kByteChromaSub), a.c);
    const int ti = t / a.tile_cols;
    uint8_t* row = a.out +
                   static_cast<long long>(ti * a.tile_h + cy * SY) * a.W +
                   (t - ti * a.tile_cols) * a.tile_w + tx;
#pragma unroll
    for (int r = 0; r < SY; ++r)
      convert_store<VS, FULL>(yw[r], [&](int k) { return tm[k / SX]; }, a.c,
                       row + r * static_cast<long long>(a.W), a.plane, n);
  }
}

// ---------------------------------------------------------------------------
// planes_ycbcr8_to_rgb: Y (H, W) u8 and Cb/Cr (ch, cw) u8 to (3, H, W) u8,
// with pallas_fast._upsample_int16 fused in.  Tap rule per axis:
//   kGather: nearest at (o * n) / N (a shared-memory table along x)
//   kDouble: bilinear 2x, 3 * a[o >> 1] + a[(o >> 1) -+ 1], edge-clamped
//   kHalf:   nearest with N in {2n, 2n - 1}, where (o * n) / N == o >> 1
//   kSame:   n == N
// The upsampled chroma is the exact chroma times `scale` (4 per doubled
// axis), an integer of at most 4080.  A block is one warp wide (512
// columns) and kWarps row pairs tall; lane l of a warp owns columns
// 16l .. 16l + 15 of the block in both rows of its pair.
enum Rule { kGather = 0, kDouble = 1, kHalf = 2, kSame = 3 };

struct PlanesArgs {
  const uint8_t* y;
  const uint8_t* cb;
  const uint8_t* cr;
  uint8_t* out;
  int H, W, ch, cw, y_rule;
  ChromaBias bias;
  Core c;
};

__device__ __forceinline__ int tap(int o, int rule, int n, int N) {
  return rule == kSame   ? o
         : rule == kHalf ? o >> 1
                         : static_cast<int>(static_cast<long long>(o) * n / N);
}

// Chroma of one plane for the run's columns: kCols values per chroma row.
template <int XR, int V, int kR>
struct ChromaRows {
  static constexpr int kCols = XR == kSame || XR == kGather ? kRun : kRun / 2;
  static constexpr bool kVec = XR != kGather;
  uint32_t w[kR][kVec ? kCols / 4 : 1];
  int g[kR][kVec ? 1 : kCols];   // kGather: the bytes themselves
  int left[kR], right[kR];       // kDouble: halo columns, edge lanes only

  __device__ __forceinline__ void load(const uint8_t* __restrict__ p,
                                       const int (&rows)[kR], int cw, int c0,
                                       int nc, const int* cols, int n,
                                       bool ld_left, bool ld_right) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const uint8_t* rp = p + static_cast<long long>(rows[r]) * cw;
      if constexpr (kVec) {
        load_run<V, kCols>(rp + c0, nc, w[r]);
      } else {
#pragma unroll
        for (int k = 0; k < kCols; ++k) g[r][k] = k < n ? __ldg(rp + cols[k]) : 0;
      }
      if constexpr (XR == kDouble) {
        left[r] = ld_left ? __ldg(rp + c0 - 1) : 0;
        right[r] = ld_right ? __ldg(rp + c0 + kCols) : 0;
      }
    }
  }

  __device__ __forceinline__ int at(int r, int j) const {
    if constexpr (kVec)
      return byte_at(w[r][j >> 2], j & 3);
    else
      return g[r][j];
  }
};

// Vertical taps for output row i of the pair from the chroma rows' values.
template <bool YD>
__device__ __forceinline__ int vert(int a0, int a1, int a2, int i) {
  if constexpr (YD)
    return 3 * a1 + (i ? a2 : a0);
  else
    return i ? a1 : a0;
}

// The biased scaled chroma of each of the run's 16 pixels in output row i.
template <int XR, bool YD, int V, int kR>
__device__ __forceinline__ void chroma_run(const ChromaRows<XR, V, kR>& cr,
                                           int i, int lane, int c0, int nc,
                                           int cw, int bits,
                                           int (&out)[kRun]) {
  auto col = [&](int j) {
    return vert<YD>(cr.at(0, j), cr.at(1, j), kR > 2 ? cr.at(kR - 1, j) : 0,
                    i);
  };
  if constexpr (XR == kDouble) {
    // 3v + v' + bits, as 3 (v + bits/4) + (v' + bits/4)
    constexpr int kC = kRun / 2;
    const int q = bits / 4;
    int v[kC + 2];
#pragma unroll
    for (int j = 0; j < kC; ++j) v[j + 1] = col(j) + q;
    if (nc < kC) {   // past the plane's last column: clamp to it
#pragma unroll
      for (int j = 1; j < kC; ++j)
        if (j >= nc) v[j + 1] = v[j];
    }
    const int up = __shfl_up_sync(0xffffffffu, v[kC], 1);
    const int down = __shfl_down_sync(0xffffffffu, v[1], 1);
    const int hl = vert<YD>(cr.left[0], cr.left[1],
                            kR > 2 ? cr.left[kR - 1] : 0, i) + q;
    const int hr = vert<YD>(cr.right[0], cr.right[1],
                            kR > 2 ? cr.right[kR - 1] : 0, i) + q;
    v[0] = c0 == 0 ? v[1] : lane == 0 ? hl : up;
    v[kC + 1] = c0 + kC >= cw ? v[kC] : lane == kWarp - 1 ? hr : down;
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const int j = (k >> 1) + 1;
      out[k] = 3 * v[j] + v[(k & 1) ? j + 1 : j - 1];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      out[k] = col(XR == kHalf ? k >> 1 : k) + bits;
  }
}

template <int V, int XR, bool YD, bool FULL>
__global__ void __launch_bounds__(kThreads)
    planes_ycbcr8_to_rgb_kernel(const PlanesArgs a) {
  constexpr int kR = YD ? 3 : 2;   // chroma rows read per row pair
  using Rows = ChromaRows<XR, V, kR>;
  constexpr int kCols = Rows::kCols;
  __shared__ int taps[XR == kGather ? kSpan : 1];
  const int lane = threadIdx.x % kWarp;
  const int x0 = blockIdx.x * kSpan + lane * kRun;
  if constexpr (XR == kGather) {
    for (int i = threadIdx.x; i < kSpan; i += kThreads) {
      const int o = blockIdx.x * kSpan + i;
      taps[i] = o < a.W ? tap(o, kGather, a.cw, a.W) : 0;
    }
    __syncthreads();
  }
  const int* cols = XR == kGather ? taps + lane * kRun : nullptr;
  const int n = max(0, min(kRun, a.W - x0));
  const int c0 = XR == kSame ? x0 : x0 / 2;
  const int nc = Rows::kVec ? max(0, min(kCols, a.cw - c0)) : 0;
  const bool ld_left = XR == kDouble && lane == 0 && c0 > 0 && nc > 0;
  const bool ld_right = XR == kDouble && lane == kWarp - 1 &&
                        c0 + kCols < a.cw;
  const long long plane = static_cast<long long>(a.H) * a.W;
  // the loop is uniform over a warp: every lane takes part in the shuffles
  for (int pair = blockIdx.y * kWarps + threadIdx.x / kWarp; 2 * pair < a.H;
       pair += gridDim.y * kWarps) {
    const int y0 = 2 * pair;
    const bool two = y0 + 1 < a.H;
    int rows[kR];
    if constexpr (YD) {
      rows[0] = max(pair - 1, 0);
      rows[1] = pair;
      rows[2] = min(pair + 1, a.ch - 1);
    } else {
      rows[0] = tap(y0, a.y_rule, a.ch, a.H);
      rows[1] = two ? tap(y0 + 1, a.y_rule, a.ch, a.H) : rows[0];
    }
    const long long o = static_cast<long long>(y0) * a.W + x0;
    uint32_t yw[2][4];
    load_run<V, kRun>(a.y + o, n, yw[0]);
    load_run<V, kRun>(a.y + o + a.W, two ? n : 0, yw[1]);
    Rows cb, cr;
    cb.load(a.cb, rows, a.cw, c0, nc, cols, n, ld_left, ld_right);
    cr.load(a.cr, rows, a.cw, c0, nc, cols, n, ld_left, ld_right);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int vb[kRun], vr[kRun];
      chroma_run<XR, YD>(cb, i, lane, c0, nc, a.cw, a.bias.bits, vb);
      chroma_run<XR, YD>(cr, i, lane, c0, nc, a.cw, a.bias.bits, vr);
      convert_store<V, FULL>(
          yw[i],
          [&](int k) {
            return terms_of<FULL>(scaled_chroma_f(vb[k], a.bias.sub),
                            scaled_chroma_f(vr[k], a.bias.sub), a.c);
          },
          a.c, a.out + o + i * static_cast<long long>(a.W), plane,
          i == 0 || two ? n : 0);
    }
  }
}

// ---------------------------------------------------------------------------
// colour_core_check: the colour core above against the reference core, over
// every reachable input -- y in 0..255, scaled Cb and Cr in 0..255*scale --
// counting the (y, cb, cr) whose R, G or B differ.  At scale 1 it also
// checks the byte path of the tile kernel (byte_biased + kByteChromaSub)
// against the scaled path.
__global__ void __launch_bounds__(kThreads)
    colour_core_check_kernel(Matrix m, Core c, int scale, ChromaBias bias,
                             unsigned long long* mismatches) {
  const int y = blockIdx.y;
  const int cb = blockIdx.x * blockDim.x + threadIdx.x;
  const int top = 255 * scale;
  if (cb > top) return;
  const float inv = 1.0f / static_cast<float>(scale);   // a power of two
  const float yf = c.full ? luma_f<true>(static_cast<uint32_t>(y), 0, c)
                          : luma_f<false>(static_cast<uint32_t>(y), 0, c);
  const float cbf = scaled_chroma_f(cb + bias.bits, bias.sub);
  const float cbf_ref = __fsub_rn(__fmul_rn(static_cast<float>(cb), inv), 128.0f);
  unsigned long long bad = 0;
  if (scale == 1) {
    const float byte_f = __fadd_rn(byte_biased(static_cast<uint32_t>(cb), 0),
                                   kByteChromaSub);
    bad += __float_as_uint(byte_f) != __float_as_uint(cbf_ref);
  }
  bad += __float_as_uint(cbf) != __float_as_uint(cbf_ref);
  for (int cr = 0; cr <= top; ++cr) {
    uint32_t r8, g8, b8;
    const float crf = scaled_chroma_f(cr + bias.bits, bias.sub);
    pixel(yf, c.full ? terms_of<true>(cbf, crf, c) : terms_of<false>(cbf, crf, c),
          c, r8, g8, b8);
    uint8_t ref[3];
    ycbcr_to_rgb(static_cast<float>(y), cbf_ref,
                 __fsub_rn(__fmul_rn(static_cast<float>(cr), inv), 128.0f), m,
                 ref);
    bad += ((r8 & 0xFFu) != ref[0]) | ((g8 & 0xFFu) != ref[1]) |
           ((b8 & 0xFFu) != ref[2]);
  }
  if (bad) atomicAdd(mismatches, bad);
}

// ---------------------------------------------------------------------------
// strided_extract_paste: the views of one layout -- each one component of
// byte-aligned big-endian 8- or 16-bit samples at constant byte strides
// (base, row_stride, x_stride) in every (T, pitch) tile buffer -- each
// pasted at the tile's place in its (tile_rows * h, tile_cols * w) plane,
// all views in one launch.  Bytes at or past `size` (the tile's payload
// size) read as zero, as pallas_fast.py:464-468 pads a short last row.  The
// buffers may be the payload itself (pitch == size): then the byte after a
// tile is the next tile's first byte, or the end of the allocation, and no
// load reaches it.
//
// It moves bytes and computes nothing, so it is bound by device memory (a
// 4096x4096 4:2:0 image moves 50.3 MB: 15 us at 3.35 TB/s).  The design:
//
// * Work item = (view, tile, band of rows): the view, the tile index and
//   their input and output base pointers are worked out once per block;
//   inside a tile every offset is 32-bit (the launcher rejects layouts
//   where they would not fit).  The items of all views form one 1-D grid,
//   so a layout takes one launch.  They run view by view: interleaving
//   the views tile by tile made the planar copy case 2.4x slower on an
//   H100, likely because its three planes lie 2^24 bytes apart and
//   concurrent blocks then hit aliased addresses.
// * A unit is 16 output bytes of one row.  A tile row has `full` whole
//   units; the unit slots of a row are padded to a power of two (1 << lg),
//   so a slot s is row s >> lg, unit s & mask, with no division.  A thread
//   takes kUnits slots kThreads apart: neighbouring lanes, neighbouring
//   units.
// * Contiguous views (x_stride == bytes per sample: component and row
//   interleave, the planar copy) are a vector copy: every load of the
//   thread's kUnits units (128 bytes) is issued before any store, in
//   vectors of VL = 16, 8, 4 or 1 bytes; stores are streaming (st.global.cs)
//   vectors of VS bytes, chosen by the host apart from VL (store width
//   mattered 7x more than load width for the colour kernels).  16-bit
//   samples are byte-swapped in registers, one PRMT per word.
// * Pixel-interleaved views (x_stride > bytes per sample) gather a unit's
//   samples with byte loads at 32-bit offsets, two units in flight, and
//   store the unit as vectors; each row span is read once per view.
//   (4-byte units, whose warp loads span 3 cache lines instead of 12, ran
//   1.8x slower on an H100.)
// * The ragged edges take a scalar path, sample by sample: the last,
//   partial unit of a row, and a unit whose bytes run past `size`.

constexpr int kMaxViews = 16;
constexpr int kUnit = 16;              // output bytes of a unit
constexpr int kUnits = 8;              // units of a thread per item

struct View {
  uint8_t* out;          // the view's (tile_rows * h, tile_cols * w) plane
  int base, row_stride, x_stride;
  int bps;               // bytes per sample: 1 or 2
  int h, w;              // tile rows and samples per tile row
  int row_bytes;         // w * bps: output bytes of one tile row
  int out_pitch;         // output bytes of one plane row
  int full;              // whole units per tile row
  int lg;                // unit slots per tile row: 1 << lg
  int bands, first;      // items per tile, first item of the view
};

struct StridedArgs {
  const uint8_t* tiles;
  long long pitch;
  int size, tile_cols, nviews, items;
  View v[kMaxViews];
};

// One sample of `bps` big-endian bytes at `off`; bytes at or past `size`
// read as zero.
__device__ __forceinline__ uint32_t sample_at(const uint8_t* __restrict__ tb,
                                              int off, int size, int bps) {
  const uint32_t hi = off < size ? __ldg(tb + off) : 0u;
  if (bps == 1) return hi;
  return (hi << 8) | (off + 1 < size ? __ldg(tb + off + 1) : 0u);
}

// The scalar path: n samples from off0 on, x_stride apart, into o.
__device__ __noinline__ void scalar_unit(const uint8_t* __restrict__ tb,
                                         int off0, int size, int x_stride,
                                         int bps, int n,
                                         uint8_t* __restrict__ o) {
  for (int j = 0; j < n; ++j) {
    const uint32_t s = sample_at(tb, off0 + j * x_stride, size, bps);
    if (bps == 1)
      o[j] = static_cast<uint8_t>(s);
    else
      reinterpret_cast<uint16_t*>(o)[j] = static_cast<uint16_t>(s);
  }
}

// The view of an item: the last one whose first item is at or before it
// (the launcher lists views in order and leaves out empty ones).
__device__ __forceinline__ int view_of(const StridedArgs& a, int item) {
  int vi = 0;
#pragma unroll
  for (int i = 1; i < kMaxViews; ++i) {
    if (i >= a.nviews || item < a.v[i].first) break;
    vi = i;
  }
  return vi;
}

template <int VL, int VS>
__device__ __forceinline__ void contiguous_units(
    const View& v, const uint8_t* __restrict__ tb, uint8_t* __restrict__ ob,
    int s0, int size) {
  const int mask = (1 << v.lg) - 1;
  uint32_t w[kUnits][4];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int s = s0 + k * kThreads;
    const int r = s >> v.lg, c = s & mask;
    const int off = v.base + r * v.row_stride + c * kUnit;
    const bool vec = r < v.h && c < v.full && off <= size - kUnit;
    load_run<VL, kUnit>(tb + off, vec ? kUnit : 0, w[k]);
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int s = s0 + k * kThreads;
    const int r = s >> v.lg, c = s & mask;
    if (r >= v.h || c * kUnit >= v.row_bytes) continue;
    const int off = v.base + r * v.row_stride + c * kUnit;
    uint8_t* o = ob + r * v.out_pitch + c * kUnit;
    if (c < v.full && off <= size - kUnit) {
      if (v.bps == 2) {
#pragma unroll
        for (int q = 0; q < 4; ++q) w[k][q] = __byte_perm(w[k][q], 0u, 0x2301u);
      }
      store_run<VS>(o, kUnit, w[k]);
    } else {
      scalar_unit(tb, off, size, v.bps, v.bps,
                  min(kUnit, v.row_bytes - c * kUnit) / v.bps, o);
    }
  }
}

template <int VS>
__device__ __forceinline__ void pixel_units(const View& v,
                                            const uint8_t* __restrict__ tb,
                                            uint8_t* __restrict__ ob, int s0,
                                            int size) {
  const int mask = (1 << v.lg) - 1;
  const int per = kUnit / v.bps;       // samples of a unit
#pragma unroll 2
  for (int k = 0; k < kUnits; ++k) {
    const int s = s0 + k * kThreads;
    const int r = s >> v.lg, c = s & mask;
    if (r >= v.h || c * kUnit >= v.row_bytes) continue;
    const int off = v.base + r * v.row_stride + c * per * v.x_stride;
    uint8_t* o = ob + r * v.out_pitch + c * kUnit;
    if (c < v.full && off + (per - 1) * v.x_stride + v.bps <= size) {
      uint32_t b[kUnit];               // output bytes, little-endian
      if (v.bps == 1) {
#pragma unroll
        for (int j = 0; j < kUnit; ++j) b[j] = __ldg(tb + off + j * v.x_stride);
      } else {
#pragma unroll
        for (int j = 0; j < kUnit / 2; ++j) {
          b[2 * j + 1] = __ldg(tb + off + j * v.x_stride);
          b[2 * j] = __ldg(tb + off + j * v.x_stride + 1);
        }
      }
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = pack4(b[4 * q], b[4 * q + 1], b[4 * q + 2], b[4 * q + 3]);
      store_run<VS>(o, kUnit, w);
    } else {
      scalar_unit(tb, off, size, v.x_stride, v.bps,
                  min(per, v.w - c * per), o);
    }
  }
}

template <int VL, int VS>
__global__ void __launch_bounds__(kThreads)
    strided_extract_paste_kernel(const StridedArgs a) {
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const View v = a.v[view_of(a, item)];
    const int local = item - v.first;
    const int t = local / v.bands;
    const int ti = t / a.tile_cols;
    const uint8_t* tb = a.tiles + t * a.pitch;
    uint8_t* ob = v.out + static_cast<long long>(ti * v.h) * v.out_pitch +
                  (t - ti * a.tile_cols) * v.row_bytes;
    const int s0 = (local - t * v.bands) * (kThreads * kUnits) + threadIdx.x;
    if (v.x_stride == v.bps)
      contiguous_units<VL, VS>(v, tb, ob, s0, a.size);
    else
      pixel_units<VS>(v, tb, ob, s0, a.size);
  }
}

int finish_launch() { return static_cast<int>(cudaGetLastError()); }

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// The vector width divides every given size and address.
bool aligned(int vec, std::initializer_list<unsigned long long> xs) {
  if (vec != 1 && vec != 4 && vec != 8 && vec != 16) return false;
  for (unsigned long long x : xs)
    if (x % static_cast<unsigned long long>(vec)) return false;
  return true;
}

template <int V, int VS, int SX, int SY>
void tile_launch(dim3 grid, cudaStream_t s, const TileArgs& a) {
  if (a.c.full)
    tile_yuv_to_rgb_kernel<V, VS, SX, SY, true><<<grid, kThreads, 0, s>>>(a);
  else
    tile_yuv_to_rgb_kernel<V, VS, SX, SY, false><<<grid, kThreads, 0, s>>>(a);
}

using TileFn = void (*)(dim3, cudaStream_t, const TileArgs&);

template <int V, int VS>
constexpr TileFn kTileFns[2][2] = {
    {tile_launch<V, VS, 1, 1>, tile_launch<V, VS, 1, 2>},
    {tile_launch<V, VS, 2, 1>, tile_launch<V, VS, 2, 2>}};

template <int V, int XR, bool YD>
void planes_launch(dim3 grid, cudaStream_t s, const PlanesArgs& a) {
  if (a.c.full)
    planes_ycbcr8_to_rgb_kernel<V, XR, YD, true><<<grid, kThreads, 0, s>>>(a);
  else
    planes_ycbcr8_to_rgb_kernel<V, XR, YD, false><<<grid, kThreads, 0, s>>>(a);
}

using PlanesFn = void (*)(dim3, cudaStream_t, const PlanesArgs&);

template <int V>
constexpr PlanesFn kPlanesFns[4][2] = {
    {planes_launch<V, kGather, false>, planes_launch<V, kGather, true>},
    {planes_launch<V, kDouble, false>, planes_launch<V, kDouble, true>},
    {planes_launch<V, kHalf, false>, planes_launch<V, kHalf, true>},
    {planes_launch<V, kSame, false>, planes_launch<V, kSame, true>}};

template <typename Fn>
Fn by_width(int vec, Fn f16, Fn f8, Fn f4, Fn f1) {
  return vec == 16 ? f16 : vec == 8 ? f8 : vec == 4 ? f4 : f1;
}

template <int VL, int VS>
void strided_launch(dim3 grid, cudaStream_t s, const StridedArgs& a) {
  strided_extract_paste_kernel<VL, VS><<<grid, kThreads, 0, s>>>(a);
}

using StridedFn = void (*)(dim3, cudaStream_t, const StridedArgs&);

template <int VL>
constexpr StridedFn kStridedRow[4] = {
    strided_launch<VL, 16>, strided_launch<VL, 8>, strided_launch<VL, 4>,
    strided_launch<VL, 1>};

// [load width][store width], 16, 8, 4, 1 bytes
constexpr const StridedFn* kStridedFns[4] = {
    kStridedRow<16>, kStridedRow<8>, kStridedRow<4>, kStridedRow<1>};

}  // namespace

extern "C" {

int launch_tile_yuv_to_rgb(const void* tiles, void* out, long long pitch,
                           int tile_rows, int tile_cols, int tile_h,
                           int tile_w, int sub_x, int sub_y, int vec,
                           int store_vec, float krf, float kbf, float c_cr, float c_cb,
                           float g_den, float y_mul, float c_mul,
                           int full_range, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int H = tile_rows * tile_h, W = tile_cols * tile_w;
  if (H == 0 || W == 0) return 0;
  if ((sub_x != 1 && sub_x != 2) || (sub_y != 1 && sub_y != 2) ||
      tile_w % sub_x || tile_h % sub_y ||
      static_cast<long long>(tile_h) * tile_w * 3 > INT_MAX)
    return kInvalid;
  const int cw = tile_w / sub_x;
  if (!aligned(vec, {static_cast<unsigned long long>(pitch),
                     static_cast<unsigned long long>(tile_w),
                     static_cast<unsigned long long>(cw),
                     reinterpret_cast<uintptr_t>(tiles)}) ||
      (store_vec != 16 && store_vec != vec) ||
      !aligned(store_vec, {static_cast<unsigned long long>(tile_w),
                           static_cast<unsigned long long>(W),
                           reinterpret_cast<uintptr_t>(out)}))
    return kInvalid;
  TileArgs a;
  a.tiles = static_cast<const uint8_t*>(tiles);
  a.out = static_cast<uint8_t*>(out);
  a.pitch = pitch;
  a.plane = static_cast<long long>(H) * W;
  a.tile_cols = tile_cols;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.W = W;
  a.runs = (tile_w + kRun - 1) / kRun;
  const long long units = static_cast<long long>(tile_h / sub_y) * a.runs;
  a.bands = static_cast<int>((units + kThreads - 1) / kThreads);
  const long long items = static_cast<long long>(tile_rows) * tile_cols * a.bands;
  if (items > INT_MAX) return kInvalid;
  a.items = static_cast<int>(items);
  a.c = core_of({krf, kbf, c_cr, c_cb, g_den, y_mul, c_mul, full_range});
  const int i = sub_x - 1, j = sub_y - 1;
  const TileFn f =
      store_vec == 16
          ? by_width(vec, kTileFns<16, 16>[i][j], kTileFns<8, 16>[i][j],
                     kTileFns<4, 16>[i][j], kTileFns<1, 16>[i][j])
          : by_width(vec, kTileFns<16, 16>[i][j], kTileFns<8, 8>[i][j],
                     kTileFns<4, 4>[i][j], kTileFns<1, 1>[i][j]);
  f(dim3(a.items < kMaxItems ? a.items : kMaxItems), static_cast<cudaStream_t>(stream), a);
  return finish_launch();
}

int launch_planes_ycbcr8_to_rgb(const void* y, const void* cb, const void* cr,
                                void* out, int H, int W, int ch, int cw,
                                int x_rule, int y_rule, int scale, int vec,
                                float krf, float kbf, float c_cr, float c_cb,
                                float g_den, float y_mul, float c_mul,
                                int full_range, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (H == 0 || W == 0) return 0;
  if (ch <= 0 || cw <= 0 || x_rule < kGather || x_rule > kSame ||
      y_rule < kGather || y_rule > kSame ||
      (scale != 1 && scale != 4 && scale != 16))
    return kInvalid;
  if (!aligned(vec, {static_cast<unsigned long long>(W),
                     static_cast<unsigned long long>(cw),
                     reinterpret_cast<uintptr_t>(y),
                     reinterpret_cast<uintptr_t>(cb),
                     reinterpret_cast<uintptr_t>(cr),
                     reinterpret_cast<uintptr_t>(out)}))
    return kInvalid;
  PlanesArgs a;
  a.y = static_cast<const uint8_t*>(y);
  a.cb = static_cast<const uint8_t*>(cb);
  a.cr = static_cast<const uint8_t*>(cr);
  a.out = static_cast<uint8_t*>(out);
  a.H = H;
  a.W = W;
  a.ch = ch;
  a.cw = cw;
  a.y_rule = y_rule;
  a.bias = chroma_bias(scale);
  a.c = core_of({krf, kbf, c_cr, c_cb, g_den, y_mul, c_mul, full_range});
  const int yd = y_rule == kDouble;
  const PlanesFn f = by_width(vec, kPlanesFns<16>[x_rule][yd],
                              kPlanesFns<8>[x_rule][yd],
                              kPlanesFns<4>[x_rule][yd],
                              kPlanesFns<1>[x_rule][yd]);
  const int pairs = (H + 1) / 2;
  const int gy = (pairs + kWarps - 1) / kWarps;
  f(dim3((W + kSpan - 1) / kSpan, gy < kMaxGridY ? gy : kMaxGridY),
    static_cast<cudaStream_t>(stream), a);
  return finish_launch();
}

int launch_colour_core_check(float krf, float kbf, float c_cr, float c_cb,
                             float g_den, float y_mul, float c_mul,
                             int full_range, int scale,
                             unsigned long long* mismatches, int device,
                             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (scale != 1 && scale != 4 && scale != 16) return kInvalid;
  const Matrix m{krf, kbf, c_cr, c_cb, g_den, y_mul, c_mul, full_range};
  const int n = 255 * scale + 1;
  colour_core_check_kernel<<<dim3((n + kThreads - 1) / kThreads, 256),
                             kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      m, core_of(m), scale, chroma_bias(scale), mismatches);
  return finish_launch();
}

// views: nviews rows of (out, base, row_stride, x_stride, bytes per sample,
// h, w); vec and store_vec are the load and store widths of contiguous
// views (16, 8, 4 or 1 bytes).
int launch_strided_extract_paste(const void* tiles, long long pitch,
                                 long long size, int tile_rows, int tile_cols,
                                 int nviews, const long long* views, int vec,
                                 int store_vec, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nviews < 1 || nviews > kMaxViews || tile_rows < 0 || tile_cols < 0 ||
      size < 0 || size > pitch || size > INT_MAX - kUnit)
    return kInvalid;
  StridedArgs a;
  a.tiles = static_cast<const uint8_t*>(tiles);
  a.pitch = pitch;
  a.size = static_cast<int>(size);
  a.tile_cols = tile_cols;
  a.nviews = 0;
  if (!aligned(vec, {static_cast<unsigned long long>(pitch),
                     reinterpret_cast<uintptr_t>(tiles)}))
    return kInvalid;
  const long long tiles_n = static_cast<long long>(tile_rows) * tile_cols;
  long long items = 0;
  for (int i = 0; i < nviews; ++i) {
    const long long* p = views + 7 * i;
    const long long base = p[1], rs = p[2], xs = p[3], bps = p[4], h = p[5],
                    w = p[6];
    if ((bps != 1 && bps != 2) || xs < bps || base < 0 || rs < 0 || h < 0 ||
        w < 0)
      return kInvalid;
    if (h == 0 || w == 0 || tiles_n == 0) continue;
    const long long row_bytes = w * bps, out_pitch = tile_cols * row_bytes;
    int lg = 0;
    while ((1LL << lg) * kUnit < row_bytes) ++lg;
    const long long slots = (h << lg) + kThreads * kUnits;
    // every 32-bit offset inside a tile, rows of the last band included
    if (tile_rows * h > INT_MAX || out_pitch > INT_MAX ||
        (h - 1) * out_pitch + row_bytes > INT_MAX || slots > INT_MAX ||
        base + (h + kThreads * kUnits) * rs + w * xs + kUnit > INT_MAX)
      return kInvalid;
    if (!aligned(store_vec, {static_cast<unsigned long long>(row_bytes),
                             static_cast<unsigned long long>(p[0])}) ||
        (xs == bps && !aligned(vec, {static_cast<unsigned long long>(base),
                                     static_cast<unsigned long long>(rs)})))
      return kInvalid;
    View& v = a.v[a.nviews++];
    v.out = reinterpret_cast<uint8_t*>(static_cast<uintptr_t>(p[0]));
    v.base = static_cast<int>(base);
    v.row_stride = static_cast<int>(rs);
    v.x_stride = static_cast<int>(xs);
    v.bps = static_cast<int>(bps);
    v.h = static_cast<int>(h);
    v.w = static_cast<int>(w);
    v.row_bytes = static_cast<int>(row_bytes);
    v.out_pitch = static_cast<int>(out_pitch);
    v.full = static_cast<int>(row_bytes / kUnit);
    v.lg = lg;
    v.bands = static_cast<int>(((h << lg) + kThreads * kUnits - 1) /
                               (kThreads * kUnits));
    v.first = static_cast<int>(items);
    items += tiles_n * v.bands;
    if (items > INT_MAX) return kInvalid;
  }
  if (items == 0) return 0;
  a.items = static_cast<int>(items);
  const int li = vec == 16 ? 0 : vec == 8 ? 1 : vec == 4 ? 2 : 3;
  const int si = store_vec == 16 ? 0 : store_vec == 8 ? 1 : store_vec == 4 ? 2 : 3;
  kStridedFns[li][si](dim3(a.items < kMaxItems ? a.items : kMaxItems),
                      static_cast<cudaStream_t>(stream), a);
  return finish_launch();
}

}  // extern "C"
