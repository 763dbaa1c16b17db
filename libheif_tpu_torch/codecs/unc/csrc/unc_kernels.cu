// Hand-written Hopper (sm_90a) kernels for the unci decode + YCbCr->RGB path.
//
// Three kernels replace the five pl.pallas_call sites of
// libheif_tpu/codecs/unc/pallas_fast.py:
//
//   tile_yuv_to_rgb        <- yuv420_tiles_to_rgb (:47, call :124) and
//                             yuv_tiles_to_rgb (:301, call :370)
//   planes_ycbcr8_to_rgb   <- ycbcr8_planes_to_rgb (:189, call :236), with
//                             _upsample_int16 (:144) fused in as index math
//   strided_extract_paste  <- fused_strided_decode (:415) / _paste_tiles
//                             (:390, call :401), and planar8_tiles_to_image
//                             (:258, call :282) as its copy case
//
// What bounds them on an H100: device-memory bytes.  Each output pixel
// costs about 20 f32 operations against 4.5 bytes moved (1.5 read, 3
// written), far below the ~20 operations per byte where the f32 units
// would become the limit.  So the design moves each input byte and each
// output byte once and keeps every intermediate (the upsampled chroma
// planes the TPU kernels built with 0/1 bf16 matmuls, the int16 planes
// XLA wrote ahead of ycbcr8_planes_to_rgb, the strided slices XLA wrote
// ahead of _paste_tiles) in registers: one thread computes four
// neighbouring output pixels of one row, so a warp stores 128 contiguous
// bytes of each output plane, as one 4-byte vector store per thread where
// the row width allows it.  Loads are single bytes, so the rows of the
// (T, S+8) tile buffer (393,224 bytes at 512x512 4:2:0: 8- but not
// 16-byte aligned) need no special case; a warp's loads of one row still
// fall in the same few 128-byte lines.  Wider loads and staging through
// shared memory are later work.
//
// Exactness: the colour arithmetic is written with the _rn intrinsics in
// the order of libheif_tpu/color/ops.py:220-226 (and the file is built with
// -fmad=false as well), so nothing is contracted into an FMA, the division
// is IEEE, and rounding is rintf (half to even, as torch.round and
// jnp.round).  The constants arrive from the host already folded in f64
// and cast once to f32, as pallas_fast.py:75-81 does.  The result matches
// the plain PyTorch versions in cuda_fast.py bit for bit.
//
// Every entry point takes the CUDA device index and stream last and returns
// the cudaError_t of its launch; it allocates nothing and does not
// synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kMaxGridY = 65535;

struct Matrix {
  float krf, kbf, c_cr, c_cb, g_den;  // H.273 constants
  float y_mul, c_mul;                 // limited range: 255/219, 255/224
  int full_range;
};

__device__ __forceinline__ uint8_t pack_u8(float v) {
  v = rintf(v);
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  return static_cast<uint8_t>(v);
}

// ops.py:215-226 for one pixel; cbf/crf already have the 128 offset removed.
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

// Store kPerThread values of one output row starting at column x0.
template <typename T>
__device__ __forceinline__ void store_row(T* __restrict__ row, int x0, int W,
                                          const T v[kPerThread]) {
  if ((W % kPerThread) == 0) {   // x0 + 3 < W and the address is aligned
    if constexpr (sizeof(T) == 1) {
      *reinterpret_cast<uchar4*>(row + x0) = make_uchar4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<ushort4*>(row + x0) =
          make_ushort4(v[0], v[1], v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (x0 + k < W) row[x0 + k] = v[k];
  }
}

// ---------------------------------------------------------------------------
// tile_yuv_to_rgb: (T, pitch) u8 tile buffers, each Y | Cb | Cr planes of an
// 8-bit component-interleaved tile with sub_x, sub_y in {1, 2}, to the
// (3, H, W) u8 RGB image with every tile at its place.  Nearest chroma
// upsampling is the index ty / sub_y, tx / sub_x.
__global__ void tile_yuv_to_rgb_kernel(const uint8_t* __restrict__ tiles,
                                       uint8_t* __restrict__ out,
                                       long long pitch, int tile_cols,
                                       int tile_h, int tile_w, int sub_x,
                                       int sub_y, int H, int W, Matrix m) {
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kPerThread;
  if (x0 >= W) return;
  const int cw = tile_w / sub_x;
  const long long ys = static_cast<long long>(tile_h) * tile_w;
  const long long cs = static_cast<long long>(tile_h / sub_y) * cw;
  const size_t plane = static_cast<size_t>(H) * W;
  for (int y = blockIdx.y; y < H; y += gridDim.y) {
    const int ti = y / tile_h;
    const int ty = y - ti * tile_h;
    const long long crow = ys + static_cast<long long>(ty / sub_y) * cw;
    uint8_t px[3][kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int x = x0 + k;
      uint8_t rgb[3] = {0, 0, 0};
      if (x < W) {
        const int tj = x / tile_w;
        const int tx = x - tj * tile_w;
        const uint8_t* tb =
            tiles + static_cast<long long>(ti * tile_cols + tj) * pitch;
        const long long c = crow + tx / sub_x;
        const float yf = static_cast<float>(tb[static_cast<long long>(ty) * tile_w + tx]);
        const float cbf = __fsub_rn(static_cast<float>(tb[c]), 128.0f);
        const float crf = __fsub_rn(static_cast<float>(tb[c + cs]), 128.0f);
        ycbcr_to_rgb(yf, cbf, crf, m, rgb);
      }
      px[0][k] = rgb[0];
      px[1][k] = rgb[1];
      px[2][k] = rgb[2];
    }
    const size_t row = static_cast<size_t>(y) * W;
    store_row<uint8_t>(out + row, x0, W, px[0]);
    store_row<uint8_t>(out + plane + row, x0, W, px[1]);
    store_row<uint8_t>(out + 2 * plane + row, x0, W, px[2]);
  }
}

// ---------------------------------------------------------------------------
// planes_ycbcr8_to_rgb: Y (H, W) u8 and Cb/Cr (ch, cw) u8 to (3, H, W) u8.
// The chroma upsample of pallas_fast._upsample_int16 is done per output
// pixel as index math, per axis:
//   mode 0 (gather): one tap at (o * n) / N        -- nearest, or identity
//   mode 1 (double): 3 * a[o / 2] + a[o / 2 -+ 1], edge-clamped -- bilinear
// The result is the exact chroma times `scale` (1, 4 or 16), an integer
// of at most 4080, so nothing is lost before the f32 matrix.
struct Axis {
  int n, N, mode;
};

__device__ __forceinline__ void axis_taps(const Axis& a, int o, int& i0,
                                          int& i1) {
  if (a.mode == 0) {
    i0 = static_cast<int>((static_cast<long long>(o) * a.n) / a.N);
    i1 = -1;
  } else {
    i0 = o >> 1;
    i1 = (o & 1) ? min(i0 + 1, a.n - 1) : max(i0 - 1, 0);
  }
}

__device__ __forceinline__ int chroma_scaled(const uint8_t* __restrict__ p,
                                             int cw, int r0, int r1, int c0,
                                             int c1) {
  auto h = [&](int r) {
    const uint8_t* row = p + static_cast<long long>(r) * cw;
    const int v = row[c0];
    return c1 < 0 ? v : 3 * v + row[c1];
  };
  const int v = h(r0);
  return r1 < 0 ? v : 3 * v + h(r1);
}

__global__ void planes_ycbcr8_to_rgb_kernel(
    const uint8_t* __restrict__ yp, const uint8_t* __restrict__ cbp,
    const uint8_t* __restrict__ crp, uint8_t* __restrict__ out, int H, int W,
    Axis ax, Axis ay, float inv_scale, Matrix m) {
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kPerThread;
  if (x0 >= W) return;
  const int cw = ax.n;
  const size_t plane = static_cast<size_t>(H) * W;
  for (int y = blockIdx.y; y < H; y += gridDim.y) {
    int r0, r1;
    axis_taps(ay, y, r0, r1);
    const size_t row = static_cast<size_t>(y) * W;
    uint8_t px[3][kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int x = x0 + k;
      uint8_t rgb[3] = {0, 0, 0};
      if (x < W) {
        int c0, c1;
        axis_taps(ax, x, c0, c1);
        const float yf = static_cast<float>(yp[row + x]);
        const float cbf = __fsub_rn(
            __fmul_rn(static_cast<float>(chroma_scaled(cbp, cw, r0, r1, c0, c1)),
                      inv_scale), 128.0f);
        const float crf = __fsub_rn(
            __fmul_rn(static_cast<float>(chroma_scaled(crp, cw, r0, r1, c0, c1)),
                      inv_scale), 128.0f);
        ycbcr_to_rgb(yf, cbf, crf, m, rgb);
      }
      px[0][k] = rgb[0];
      px[1][k] = rgb[1];
      px[2][k] = rgb[2];
    }
    store_row<uint8_t>(out + row, x0, W, px[0]);
    store_row<uint8_t>(out + plane + row, x0, W, px[1]);
    store_row<uint8_t>(out + 2 * plane + row, x0, W, px[2]);
  }
}

// ---------------------------------------------------------------------------
// strided_extract_paste: one component of byte-aligned big-endian 8- or
// 16-bit samples at constant byte strides (base, row_stride, x_stride) from
// each (T, pitch) tile buffer, pasted at the tile's place in the
// (tile_rows * h, tile_cols * w) plane.  Bytes at or past `size` (the
// tile's payload size; the buffer's padding lies beyond it) read as zero,
// as pallas_fast.py:464-468 pads a short last row.
template <typename T>
__global__ void strided_extract_paste_kernel(
    const uint8_t* __restrict__ tiles, T* __restrict__ out, long long pitch,
    long long size, long long base, long long row_stride, long long x_stride,
    int tile_cols, int h, int w, int H, int W) {
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kPerThread;
  if (x0 >= W) return;
  for (int y = blockIdx.y; y < H; y += gridDim.y) {
    const int ti = y / h;
    const long long roff = base + static_cast<long long>(y - ti * h) * row_stride;
    T v[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int x = x0 + k;
      T s = 0;
      if (x < W) {
        const int tj = x / w;
        const uint8_t* tb =
            tiles + static_cast<long long>(ti * tile_cols + tj) * pitch;
        const long long off = roff + static_cast<long long>(x - tj * w) * x_stride;
        const unsigned hi = off < size ? tb[off] : 0u;
        if constexpr (sizeof(T) == 1) {
          s = static_cast<T>(hi);
        } else {
          const unsigned lo = off + 1 < size ? tb[off + 1] : 0u;
          s = static_cast<T>((hi << 8) | lo);
        }
      }
      v[k] = s;
    }
    store_row<T>(out + static_cast<size_t>(y) * W, x0, W, v);
  }
}

dim3 grid_for(int H, int W) {
  const int quads = (W + kPerThread - 1) / kPerThread;
  return dim3((quads + kThreads - 1) / kThreads, H < kMaxGridY ? H : kMaxGridY);
}

int finish_launch() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

int launch_tile_yuv_to_rgb(const void* tiles, void* out, long long pitch,
                           int tile_rows, int tile_cols, int tile_h,
                           int tile_w, int sub_x, int sub_y, float krf,
                           float kbf, float c_cr, float c_cb, float g_den,
                           float y_mul, float c_mul, int full_range,
                           int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int H = tile_rows * tile_h, W = tile_cols * tile_w;
  if (H == 0 || W == 0) return 0;
  const Matrix m{krf, kbf, c_cr, c_cb, g_den, y_mul, c_mul, full_range};
  tile_yuv_to_rgb_kernel<<<grid_for(H, W), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tiles), static_cast<uint8_t*>(out), pitch,
      tile_cols, tile_h, tile_w, sub_x, sub_y, H, W, m);
  return finish_launch();
}

int launch_planes_ycbcr8_to_rgb(const void* y, const void* cb, const void* cr,
                                void* out, int H, int W, int ch, int cw,
                                int x_mode, int y_mode, float inv_scale,
                                float krf, float kbf, float c_cr, float c_cb,
                                float g_den, float y_mul, float c_mul,
                                int full_range, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (H == 0 || W == 0) return 0;
  const Matrix m{krf, kbf, c_cr, c_cb, g_den, y_mul, c_mul, full_range};
  const Axis ax{cw, W, x_mode}, ay{ch, H, y_mode};
  planes_ycbcr8_to_rgb_kernel<<<grid_for(H, W), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(cb),
      static_cast<const uint8_t*>(cr), static_cast<uint8_t*>(out), H, W, ax,
      ay, inv_scale, m);
  return finish_launch();
}

int launch_strided_extract_paste(const void* tiles, void* out, long long pitch,
                                 long long size, long long base,
                                 long long row_stride, long long x_stride,
                                 int bytes_per_sample, int tile_rows,
                                 int tile_cols, int h, int w, int device,
                                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int H = tile_rows * h, W = tile_cols * w;
  if (H == 0 || W == 0) return 0;
  const dim3 grid = grid_for(H, W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(tiles);
  if (bytes_per_sample == 1) {
    strided_extract_paste_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        in, static_cast<uint8_t*>(out), pitch, size, base, row_stride,
        x_stride, tile_cols, h, w, H, W);
  } else if (bytes_per_sample == 2) {
    strided_extract_paste_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        in, static_cast<uint16_t*>(out), pitch, size, base, row_stride,
        x_stride, tile_cols, h, w, H, W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return finish_launch();
}

}  // extern "C"
