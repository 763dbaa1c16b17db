// Hand-written Hopper (sm_90a) kernel of the JPEG reconstruction.
//
// The JAX package reconstructs JPEG with one jnp program a component,
// _recon_program (libheif_tpu/codecs/jpeg/decoder.py:500-528): dequantise
// with the natural-order table, de-zigzag, the islow IDCT
// (codecs/jpeg/idct.py idct8x8_islow :79-97, IJG jidctint.c), +128, clip,
// and reassembly of the blocks into the plane.  It has no Pallas kernel.
// Here that is one kernel, one launch for every component plane of every
// tile of a batch:
//
//   jpeg_dequant_idct  <- _recon_program + idct8x8_islow
//
// Bound: bytes.  A block reads 128 bytes of coefficients and writes 64
// samples, and does ~30 integer operations a sample, far below the card's
// operation rate; the 4032x3024 photo's 294,912 blocks move 56.6 MB.
//
// Design (a simple, correct first version): eight threads a block, 32
// blocks a CTA.  A block's eight threads load its 64 zigzag coefficients
// as eight 16-byte vectors into shared memory, then thread c dequantises
// and transforms column c (pass 1, descaled by CONST_BITS - PASS1_BITS)
// into a shared 8x8 work array, and after a warp barrier thread r
// transforms row r (pass 2, CONST_BITS + PASS1_BITS + 3), adds 128,
// clips and stores its eight samples.  A job table (one row a component
// plane: its first work block, first coefficient block, blocks_w,
// blocks_h, quant table, output address, pitch and the crop) lets the
// kernel write straight into a composed grid plane at the tile's offset;
// a CTA finds each block's job by binary search.  The arithmetic is the
// jnp program's int32 with wraparound: products and sums are formed in
// uint32 and cast to int32 only for the arithmetic right shift of the
// descale (16-bit quant tables overflow int32).
//
// The entry point takes the CUDA device index and stream last and returns
// the cudaError_t of its launch; it allocates nothing and does not
// synchronise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
constexpr int kBlocksPerCta = 32;
constexpr int kThreads = 8 * kBlocksPerCta;
constexpr int kJobCols = 10;     // JOB_COLS in cuda_fast.py

// job table columns (column 3, blocks_h, only sizes the work)
constexpr int kWork = 0, kFirst = 1, kBw = 2, kQ = 4, kOut = 5, kPitch = 6,
              kOw = 7, kOh = 8;

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

// natural position -> zigzag index (tables.py INV_ZIGZAG)
__constant__ int kInvZigzag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

__device__ __forceinline__ int mulw(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) *
                          static_cast<unsigned>(b));
}
__device__ __forceinline__ int addw(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}
__device__ __forceinline__ int subw(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) -
                          static_cast<unsigned>(b));
}
__device__ __forceinline__ int shlw(int a, int n) {
  return static_cast<int>(static_cast<unsigned>(a) << n);
}
// idct.py _descale: (x + 2^(n-1)) >> n, the sum wrapping
__device__ __forceinline__ int descale(int x, int n) {
  return addw(x, 1 << (n - 1)) >> n;
}

// idct.py _idct_1d (jidctint.c pass body), in place on c[0..7]
__device__ __forceinline__ void idct_1d(int* c, int bits) {
  int z1 = mulw(addw(c[2], c[6]), 4433);               // FIX_0_541196100
  const int tmp2 = addw(z1, mulw(c[6], -15137));       // FIX_1_847759065
  const int tmp3 = addw(z1, mulw(c[2], 6270));         // FIX_0_765366865
  const int tmp0 = shlw(addw(c[0], c[4]), kConstBits);
  const int tmp1 = shlw(subw(c[0], c[4]), kConstBits);
  const int tmp10 = addw(tmp0, tmp3);
  const int tmp13 = subw(tmp0, tmp3);
  const int tmp11 = addw(tmp1, tmp2);
  const int tmp12 = subw(tmp1, tmp2);
  int t0 = c[7], t1 = c[5], t2 = c[3], t3 = c[1];
  z1 = addw(t0, t3);
  int z2 = addw(t1, t2);
  int z3 = addw(t0, t2);
  int z4 = addw(t1, t3);
  const int z5 = mulw(addw(z3, z4), 9633);             // FIX_1_175875602
  t0 = mulw(t0, 2446);                                 // FIX_0_298631336
  t1 = mulw(t1, 16819);                                // FIX_2_053119869
  t2 = mulw(t2, 25172);                                // FIX_3_072711026
  t3 = mulw(t3, 12299);                                // FIX_1_501321110
  z1 = mulw(z1, -7373);                                // FIX_0_899976223
  z2 = mulw(z2, -20995);                               // FIX_2_562915447
  z3 = addw(mulw(z3, -16069), z5);                     // FIX_1_961570560
  z4 = addw(mulw(z4, -3196), z5);                      // FIX_0_390180644
  t0 = addw(addw(t0, z1), z3);
  t1 = addw(addw(t1, z2), z4);
  t2 = addw(addw(t2, z2), z3);
  t3 = addw(addw(t3, z1), z4);
  c[0] = descale(addw(tmp10, t3), bits);
  c[1] = descale(addw(tmp11, t2), bits);
  c[2] = descale(addw(tmp12, t1), bits);
  c[3] = descale(addw(tmp13, t0), bits);
  c[4] = descale(subw(tmp13, t0), bits);
  c[5] = descale(subw(tmp12, t1), bits);
  c[6] = descale(subw(tmp11, t2), bits);
  c[7] = descale(subw(tmp10, t3), bits);
}

__global__ void __launch_bounds__(kThreads)
jpeg_dequant_idct_kernel(const int16_t* __restrict__ coeffs,
                         const int32_t* __restrict__ quant,
                         const long long* __restrict__ jobs, int n_jobs,
                         long long n_work) {
  __shared__ int4 zz_s[kBlocksPerCta][8];
  __shared__ int ws_s[kBlocksPerCta][8][9];
  const int lane = threadIdx.x & 7;
  const int slot = threadIdx.x >> 3;
  const long long w = static_cast<long long>(blockIdx.x) * kBlocksPerCta +
                      slot;
  const bool active = w < n_work;

  // the job holding work block w: the last row whose kWork <= w
  int j = 0;
  if (active) {
    int lo = 0, hi = n_jobs - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(jobs + mid * kJobCols + kWork) <= w)
        lo = mid;
      else
        hi = mid - 1;
    }
    j = lo;
  }
  const long long* job = jobs + j * kJobCols;
  const long long local = active ? w - __ldg(job + kWork) : 0;
  const int bw = active ? static_cast<int>(__ldg(job + kBw)) : 1;
  const long long blk = __ldg(job + kFirst) + local;
  if (active)
    zz_s[slot][lane] = __ldg(reinterpret_cast<const int4*>(
                                 coeffs + blk * 64) + lane);
  __syncwarp();

  // pass 1: dequantise and transform column `lane`
  const int16_t* zz = reinterpret_cast<const int16_t*>(zz_s[slot]);
  const int32_t* q = quant + __ldg(job + kQ) * 64;
  int v[8];
  if (active) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int pos = r * 8 + lane;
      v[r] = mulw(zz[kInvZigzag[pos]], __ldg(q + pos));
    }
    idct_1d(v, kConstBits - kPass1Bits);
#pragma unroll
    for (int r = 0; r < 8; ++r) ws_s[slot][r][lane] = v[r];
  }
  __syncwarp();
  if (!active) return;

  // pass 2: transform row `lane`, level shift, clip, store
#pragma unroll
  for (int x = 0; x < 8; ++x) v[x] = ws_s[slot][lane][x];
  idct_1d(v, kConstBits + kPass1Bits + 3);
  const int by = static_cast<int>(local / bw);
  const int bx = static_cast<int>(local - static_cast<long long>(by) * bw);
  const int y = by * 8 + lane;
  if (y >= __ldg(job + kOh)) return;
  const int ow = static_cast<int>(__ldg(job + kOw));
  uint8_t* out = reinterpret_cast<uint8_t*>(__ldg(job + kOut)) +
                 y * __ldg(job + kPitch) + bx * 8;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    if (bx * 8 + x < ow) {
      const int s = addw(v[x], 128);
      out[x] = static_cast<uint8_t>(s < 0 ? 0 : (s > 255 ? 255 : s));
    }
  }
}

}  // namespace

extern "C" {

// coeffs: (N, 64) int16 zigzag, 16-byte aligned; quant: (Q, 64) int32
// natural order; jobs: (n_jobs, 10) int64 rows (work start, first block,
// blocks_w, blocks_h, quant row, output address, pitch, crop width and
// height, unused), work starts ascending from 0 and n_work their total
int launch_jpeg_dequant_idct(const void* coeffs, const void* quant,
                             const void* jobs, int n_jobs, long long n_work,
                             int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_jobs < 1 || n_work < 1 ||
      (reinterpret_cast<uintptr_t>(coeffs) & 15) != 0)
    return kInvalid;
  const long long ctas = (n_work + kBlocksPerCta - 1) / kBlocksPerCta;
  if (ctas > 0x7fffffffLL) return kInvalid;
  jpeg_dequant_idct_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coeffs),
      static_cast<const int32_t*>(quant),
      static_cast<const long long*>(jobs), n_jobs, n_work);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
