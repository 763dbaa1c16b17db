// Hand-written Hopper (sm_90a) kernels of the AV1 intra reconstruction.
//
// The JAX package reconstructs AV1 intra frames with one jnp program
// (libheif_tpu/codecs/av1/device_recon.py, _build_program :499-952); it has
// no Pallas kernel.  Both of its stages are kernels here, each one launch
// for a whole plan (a batch of pictures):
//
//   av1_dequant_itx  <- stage A, residuals (:548-604): dequantise, the 2:1
//                       prescale, the staged row and column transforms
//                       (DCT 4-64, ADST 4-16, identity, their roundings and
//                       flips), the Walsh-Hadamard path of lossless frames;
//                       every job group
//   av1_intra_wave   <- stage B, the lax.scan over waves (:885-950) with
//                       predict_normal (:606), apply_cfl (:826) and
//                       predict_fi (:850), and the scatter into the flat
//                       sample buffer; every wave of every picture
//
// What bounds them on an H100, and what the design does about it:
//
// * av1_dequant_itx reads the quantised levels and writes the residuals of
//   every job's (sq, sq) slot: device-memory bytes bound it.  A block of 128
//   threads takes jobs of one group: 32 jobs of 4x4, 16 of 8x8, 8 of 16x16,
//   4 of 32x32, or one 64-point job.  A job's threads load its levels as
//   16-byte vectors, dequantise them into shared memory (rows padded to
//   sq+1 words), transform one row each and, after a barrier, one column
//   each in registers: the 1-D transforms are compile-time lengths (the
//   butterflies of itx.py, the cosines constants), so the vectors live in
//   registers and nothing goes through local memory.  A 64-point transform
//   is split over two threads, one the even half (the 32-point DCT) and one
//   the odd half, joined through shared memory.  Rows and columns are
//   stored as 16-byte vectors (a 64-point job's columns as coalesced
//   words), a job without residual as zero vectors.  Jobs are visited in an
//   order (per group, by flags, transform size and kind) so that the
//   threads of a warp take the same branches; outputs stay at their slots.
//   A block's group comes from the block ranges of the groups.  All
//   arithmetic is the jnp program's int32: products are formed in uint32
//   and wrap as XLA's do.
//
// * av1_intra_wave is bound by the chain of dependent waves: a job reads
//   samples of its own picture written by earlier waves only.  One
//   persistent launch gives each picture one block of 16 warps, which walks
//   the picture's waves in order with __syncthreads() between them.  A
//   wave's jobs are taken in chunks that fit shared memory (almost always
//   the whole wave), each in two phases:
//     1. edge preparation, a warp a job: the job's parameters (one word a
//        lane), gather indices and gathered samples are loaded at once, a
//        CfL job's luma box beside them; the corner and edge filters, both
//        sides' upsampled lines, the DC value, CfL's Q3 box and average, or
//        filter intra's 4x2 patches along anti-diagonals (3sq/4 - 1 steps
//        instead of sq^2/8) go into the job's slot of shared memory and a
//        record of its scalars;
//     2. prediction, the whole block over every quad of samples of the
//        chunk's jobs (a job's (sq, sq) box, by shifts and masks): predict
//        four samples of a row, add their residuals (one 16-byte load),
//        clip, store.
//   The residuals of a thread's first quad are loaded before phase 1,
//   so that their latency hides behind it.  The last warp, which few jobs
//   reach, plans the next chunk during phase 1 (prefix sums over the
//   groups by shuffles) and asks L2 for the next wave's tables.  The
//   sample buffer is written during the launch, so it is never read
//   through the non-coherent path (__ldg).
//
// av1_wave_probe, a measurement probe off the decode path, has the wave
// kernel's launch shape and does per step one table load, one gather from
// a buffer at the loaded index, one store and the barrier: n_waves of its
// steps are the in-kernel chain bound of av1_intra_wave.
//
// Every entry point takes the CUDA device index and stream last and returns
// the cudaError_t of its launch; it allocates nothing and does not
// synchronise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
constexpr int kMaxGroups = 16;

// round(cos(i*pi/128) * 2^12) (itx.py _COSPI)
__constant__ int kCos[64] = {
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973,
    3948, 3920, 3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564,
    3513, 3461, 3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896,
    2824, 2751, 2675, 2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019,
    1931, 1842, 1751, 1660, 1567, 1474, 1380, 1285, 1189, 1092, 995,
    897,  799,  700,  601,  501,  401,  301,  201,  101};
// the 4-point ADST's sinpi (itx.py _SINPI)
__constant__ int kSin[5] = {0, 1321, 2482, 3344, 3803};

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
__device__ __forceinline__ int round2(int x, int n) {
  return n > 0 ? addw(x, 1 << (n - 1)) >> n : x;
}
// itx.py _half_btf: round2(w0*in0 + w1*in1, 12), int32 wrapping
__device__ __forceinline__ int btf(int w0, int in0, int w1, int in1) {
  return addw(addw(mulw(w0, in0), mulw(w1, in1)), 2048) >> 12;
}
__device__ __forceinline__ int C(int i) { return kCos[i]; }
__device__ __forceinline__ int ilog2(int v) { return 31 - __clz(v); }

// ---------------------------------------------------------- 1-D transforms
// Each takes x[0..n) and writes y[0..n); x and y do not alias.  Every loop
// is unrolled, so that arrays of registers are indexed by constants only.

__device__ __forceinline__ void idct4(const int* x, int* y) {
  const int s0 = btf(C(32), x[0], C(32), x[2]);
  const int s1 = btf(C(32), x[0], -C(32), x[2]);
  const int s2 = btf(C(48), x[1], -C(16), x[3]);
  const int s3 = btf(C(16), x[1], C(48), x[3]);
  y[0] = addw(s0, s3);
  y[1] = addw(s1, s2);
  y[2] = subw(s1, s2);
  y[3] = subw(s0, s3);
}

__device__ __forceinline__ void idct8(const int* x, int* y) {
  int xe[4] = {x[0], x[2], x[4], x[6]}, e[4];
  idct4(xe, e);
  const int s4 = btf(C(56), x[1], -C(8), x[7]);
  const int s7 = btf(C(8), x[1], C(56), x[7]);
  const int s5 = btf(C(24), x[5], -C(40), x[3]);
  const int s6 = btf(C(40), x[5], C(24), x[3]);
  const int t4 = addw(s4, s5), t5 = subw(s4, s5);
  const int t7 = addw(s7, s6), t6 = subw(s7, s6);
  const int u5 = btf(C(32), t6, -C(32), t5);
  const int u6 = btf(C(32), t6, C(32), t5);
  const int o[4] = {t4, u5, u6, t7};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    y[i] = addw(e[i], o[3 - i]);
    y[7 - i] = subw(e[i], o[3 - i]);
  }
}

__device__ __forceinline__ void idct16(const int* x, int* y) {
  int xe[8], e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) xe[i] = x[2 * i];
  idct8(xe, e);
  const int s8 = btf(C(60), x[1], -C(4), x[15]);
  const int s15 = btf(C(4), x[1], C(60), x[15]);
  const int s9 = btf(C(28), x[9], -C(36), x[7]);
  const int s14 = btf(C(36), x[9], C(28), x[7]);
  const int s10 = btf(C(44), x[5], -C(20), x[11]);
  const int s13 = btf(C(20), x[5], C(44), x[11]);
  const int s11 = btf(C(12), x[13], -C(52), x[3]);
  const int s12 = btf(C(52), x[13], C(12), x[3]);
  const int t8 = addw(s8, s9), t9 = subw(s8, s9);
  const int t10 = subw(s11, s10), t11 = addw(s11, s10);
  const int t12 = addw(s12, s13), t13 = subw(s12, s13);
  const int t14 = subw(s15, s14), t15 = addw(s15, s14);
  const int u9 = btf(-C(16), t9, C(48), t14);
  const int u14 = btf(C(48), t9, C(16), t14);
  const int u10 = btf(-C(48), t10, -C(16), t13);
  const int u13 = btf(-C(16), t10, C(48), t13);
  const int v8 = addw(t8, t11), v9 = addw(u9, u10), v10 = subw(u9, u10);
  const int v11 = subw(t8, t11), v12 = subw(t15, t12);
  const int v13 = subw(u14, u13), v14 = addw(u14, u13);
  const int v15 = addw(t15, t12);
  const int w10 = btf(-C(32), v10, C(32), v13);
  const int w13 = btf(C(32), v10, C(32), v13);
  const int w11 = btf(-C(32), v11, C(32), v12);
  const int w12 = btf(C(32), v11, C(32), v12);
  const int o[8] = {v8, v9, w10, w11, w12, w13, v14, v15};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    y[i] = addw(e[i], o[7 - i]);
    y[8 + i] = subw(e[7 - i], o[i]);
  }
}

__device__ __forceinline__ void idct32(const int* x, int* y) {
  int xe[16], e[16], xo[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    xe[i] = x[2 * i];
    xo[i] = x[2 * i + 1];
  }
  idct16(xe, e);
  int s[16], t[16], u[16], v[16], w[16], a[16], b[16];
  s[0] = btf(C(62), xo[0], -C(2), xo[15]);
  s[15] = btf(C(2), xo[0], C(62), xo[15]);
  s[1] = btf(C(30), xo[8], -C(34), xo[7]);
  s[14] = btf(C(34), xo[8], C(30), xo[7]);
  s[2] = btf(C(46), xo[4], -C(18), xo[11]);
  s[13] = btf(C(18), xo[4], C(46), xo[11]);
  s[3] = btf(C(14), xo[12], -C(50), xo[3]);
  s[12] = btf(C(50), xo[12], C(14), xo[3]);
  s[4] = btf(C(54), xo[2], -C(10), xo[13]);
  s[11] = btf(C(10), xo[2], C(54), xo[13]);
  s[5] = btf(C(22), xo[10], -C(42), xo[5]);
  s[10] = btf(C(42), xo[10], C(22), xo[5]);
  s[6] = btf(C(38), xo[6], -C(26), xo[9]);
  s[9] = btf(C(26), xo[6], C(38), xo[9]);
  s[7] = btf(C(6), xo[14], -C(58), xo[1]);
  s[8] = btf(C(58), xo[14], C(6), xo[1]);
  // stage 2
  t[0] = addw(s[0], s[1]);   t[1] = subw(s[0], s[1]);
  t[3] = addw(s[3], s[2]);   t[2] = subw(s[3], s[2]);
  t[4] = addw(s[4], s[5]);   t[5] = subw(s[4], s[5]);
  t[7] = addw(s[7], s[6]);   t[6] = subw(s[7], s[6]);
  t[8] = addw(s[8], s[9]);   t[9] = subw(s[8], s[9]);
  t[11] = addw(s[11], s[10]); t[10] = subw(s[11], s[10]);
  t[12] = addw(s[12], s[13]); t[13] = subw(s[12], s[13]);
  t[15] = addw(s[15], s[14]); t[14] = subw(s[15], s[14]);
  // stage 3
#pragma unroll
  for (int i = 0; i < 16; ++i) u[i] = t[i];
  u[1] = btf(-C(8), t[1], C(56), t[14]);
  u[14] = btf(C(56), t[1], C(8), t[14]);
  u[2] = btf(-C(56), t[2], -C(8), t[13]);
  u[13] = btf(-C(8), t[2], C(56), t[13]);
  u[5] = btf(-C(40), t[5], C(24), t[10]);
  u[10] = btf(C(24), t[5], C(40), t[10]);
  u[6] = btf(-C(24), t[6], -C(40), t[9]);
  u[9] = btf(-C(40), t[6], C(24), t[9]);
  // stage 4
  v[0] = addw(u[0], u[3]);   v[3] = subw(u[0], u[3]);
  v[1] = addw(u[1], u[2]);   v[2] = subw(u[1], u[2]);
  v[7] = addw(u[7], u[4]);   v[4] = subw(u[7], u[4]);
  v[6] = addw(u[6], u[5]);   v[5] = subw(u[6], u[5]);
  v[8] = addw(u[8], u[11]);  v[11] = subw(u[8], u[11]);
  v[9] = addw(u[9], u[10]);  v[10] = subw(u[9], u[10]);
  v[15] = addw(u[15], u[12]); v[12] = subw(u[15], u[12]);
  v[14] = addw(u[14], u[13]); v[13] = subw(u[14], u[13]);
  // stage 5
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = v[i];
  w[2] = btf(-C(16), v[2], C(48), v[13]);
  w[13] = btf(C(48), v[2], C(16), v[13]);
  w[3] = btf(-C(16), v[3], C(48), v[12]);
  w[12] = btf(C(48), v[3], C(16), v[12]);
  w[4] = btf(-C(48), v[4], -C(16), v[11]);
  w[11] = btf(-C(16), v[4], C(48), v[11]);
  w[5] = btf(-C(48), v[5], -C(16), v[10]);
  w[10] = btf(-C(16), v[5], C(48), v[10]);
  // stage 6
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = addw(w[i], w[7 - i]);
    a[7 - i] = subw(w[i], w[7 - i]);
    a[8 + i] = subw(w[15 - i], w[8 + i]);
    a[15 - i] = addw(w[15 - i], w[8 + i]);
  }
  // stage 7
#pragma unroll
  for (int i = 0; i < 16; ++i) b[i] = a[i];
#pragma unroll
  for (int i = 4; i < 8; ++i) {
    b[i] = btf(-C(32), a[i], C(32), a[15 - i]);
    b[15 - i] = btf(C(32), a[i], C(32), a[15 - i]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    y[i] = addw(e[i], b[15 - i]);
    y[16 + i] = subw(e[15 - i], b[i]);
  }
}

// stage 1 of the odd half for input pair J: A = bitrev6(32 + J), odd
// (itx.py idct64), the indices constants
template <int J, int A>
__device__ __forceinline__ void idct64_in(const int* xo, int* s) {
  const int xi = xo[(A - 1) / 2], xj = xo[(63 - A) / 2];
  s[J] = btf(C(64 - A), xi, -C(A), xj);
  s[31 - J] = btf(C(A), xi, C(64 - A), xj);
}

// The odd half of the 64-point DCT (itx.py idct64 after its even idct32):
// xo[k] = x[2k+1]; o such that y[i] = e[i] + o[31-i] and
// y[32+i] = e[31-i] - o[i], e the 32-point DCT of the even inputs.
__device__ __forceinline__ void idct64_odd(const int* xo, int* o) {
  int s[32], t[32], u[32];
  idct64_in<0, 1>(xo, s);
  idct64_in<1, 33>(xo, s);
  idct64_in<2, 17>(xo, s);
  idct64_in<3, 49>(xo, s);
  idct64_in<4, 9>(xo, s);
  idct64_in<5, 41>(xo, s);
  idct64_in<6, 25>(xo, s);
  idct64_in<7, 57>(xo, s);
  idct64_in<8, 5>(xo, s);
  idct64_in<9, 37>(xo, s);
  idct64_in<10, 21>(xo, s);
  idct64_in<11, 53>(xo, s);
  idct64_in<12, 13>(xo, s);
  idct64_in<13, 45>(xo, s);
  idct64_in<14, 29>(xo, s);
  idct64_in<15, 61>(xo, s);
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int i0 = 2 * p, i1 = 2 * p + 1;
    if (p % 2 == 0) {
      t[i0] = addw(s[i0], s[i1]);
      t[i1] = subw(s[i0], s[i1]);
    } else {
      t[i1] = addw(s[i1], s[i0]);
      t[i0] = subw(s[i1], s[i0]);
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) u[i] = t[i];
  constexpr int kB[8] = {4, 36, 20, 52, 12, 44, 28, 60};  // 4 bitrev4(8+k)
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b = kB[k];
    const int i0 = 4 * k + 1, i1 = 4 * k + 2;
    const int j0 = 30 - 4 * k, j1 = 29 - 4 * k;
    u[i0] = btf(C(b), t[i0], -C(64 - b), t[j0]);
    u[j0] = btf(-C(64 - b), t[i0], -C(b), t[j0]);
    u[i1] = btf(C(64 - b), t[i1], C(b), t[j1]);
    u[j1] = btf(C(b), t[i1], -C(64 - b), t[j1]);
  }
  // stage 4 (into s)
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const int q = 4 * g;
    if (g % 2 == 0) {
      s[q] = addw(u[q], u[q + 3]);
      s[q + 3] = subw(u[q], u[q + 3]);
      s[q + 1] = addw(u[q + 1], u[q + 2]);
      s[q + 2] = subw(u[q + 1], u[q + 2]);
    } else {
      s[q + 3] = addw(u[q + 3], u[q]);
      s[q] = subw(u[q + 3], u[q]);
      s[q + 2] = addw(u[q + 2], u[q + 1]);
      s[q + 1] = subw(u[q + 2], u[q + 1]);
    }
  }
  // stage 5 (into t)
#pragma unroll
  for (int i = 0; i < 32; ++i) t[i] = s[i];
  {
    constexpr int tab[8][4] = {{2, 29, 8, 0},  {3, 28, 8, 0},
                               {4, 27, 8, 1},  {5, 26, 8, 1},
                               {10, 21, 40, 0}, {11, 20, 40, 0},
                               {12, 19, 40, 1}, {13, 18, 40, 1}};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = tab[q][0], j = tab[q][1], b = tab[q][2];
      if (tab[q][3] == 0) {
        t[i] = btf(-C(b), s[i], C(64 - b), s[j]);
        t[j] = btf(C(64 - b), s[i], C(b), s[j]);
      } else {
        t[i] = btf(-C(64 - b), s[i], -C(b), s[j]);
        t[j] = btf(-C(b), s[i], C(64 - b), s[j]);
      }
    }
  }
  // stage 6 (into u)
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int q = 8 * g;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lo = q + i, hi = q + 7 - i;
      if (g % 2 == 0) {
        u[lo] = addw(t[lo], t[hi]);
        u[hi] = subw(t[lo], t[hi]);
      } else {
        u[hi] = addw(t[hi], t[lo]);
        u[lo] = subw(t[hi], t[lo]);
      }
    }
  }
  // stage 7 (into s)
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = u[i];
#pragma unroll
  for (int i = 4; i < 8; ++i) {
    const int j = 31 - i;
    s[i] = btf(-C(16), u[i], C(48), u[j]);
    s[j] = btf(C(48), u[i], C(16), u[j]);
  }
#pragma unroll
  for (int i = 8; i < 12; ++i) {
    const int j = 31 - i;
    s[i] = btf(-C(48), u[i], -C(16), u[j]);
    s[j] = btf(-C(16), u[i], C(48), u[j]);
  }
  // stage 8 (into t)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lo = i, hi = 15 - i;
    t[lo] = addw(s[lo], s[hi]);
    t[hi] = subw(s[lo], s[hi]);
    const int lo2 = 16 + i, hi2 = 31 - i;
    t[hi2] = addw(s[hi2], s[lo2]);
    t[lo2] = subw(s[hi2], s[lo2]);
  }
  // stage 9 (into o)
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = t[i];
#pragma unroll
  for (int i = 8; i < 16; ++i) {
    const int j = 31 - i;
    o[i] = btf(-C(32), t[i], C(32), t[j]);
    o[j] = btf(C(32), t[i], C(32), t[j]);
  }
}

__device__ __forceinline__ void iadst4(const int* x, int* y) {
  const int x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
  int s0 = mulw(kSin[1], x0);
  int s1 = mulw(kSin[2], x0);
  int s2 = mulw(kSin[3], x1);
  int s3 = mulw(kSin[4], x2);
  const int s4 = mulw(kSin[1], x2);
  const int s5 = mulw(kSin[2], x3);
  const int s6 = mulw(kSin[4], x3);
  const int s7 = addw(subw(x0, x2), x3);
  s0 = addw(s0, s3);
  s1 = subw(s1, s4);
  s3 = s2;
  s2 = mulw(kSin[3], s7);
  s0 = addw(s0, s5);
  s1 = subw(s1, s6);
  y[0] = round2(addw(s0, s3), 12);
  y[1] = round2(addw(s1, s3), 12);
  y[2] = round2(s2, 12);
  y[3] = round2(subw(addw(s0, s1), s3), 12);
}

__device__ __forceinline__ void iadst8(const int* x, int* y) {
  const int b[8] = {x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]};
  int s[8], t[8], u[8], v[8], w[8];
  s[0] = btf(C(4), b[0], C(60), b[1]);
  s[1] = btf(C(60), b[0], -C(4), b[1]);
  s[2] = btf(C(20), b[2], C(44), b[3]);
  s[3] = btf(C(44), b[2], -C(20), b[3]);
  s[4] = btf(C(36), b[4], C(28), b[5]);
  s[5] = btf(C(28), b[4], -C(36), b[5]);
  s[6] = btf(C(52), b[6], C(12), b[7]);
  s[7] = btf(C(12), b[6], -C(52), b[7]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    t[i] = addw(s[i], s[i + 4]);
    t[i + 4] = subw(s[i], s[i + 4]);
  }
  u[0] = t[0]; u[1] = t[1]; u[2] = t[2]; u[3] = t[3];
  u[4] = btf(C(16), t[4], C(48), t[5]);
  u[5] = btf(C(48), t[4], -C(16), t[5]);
  u[6] = btf(-C(48), t[6], C(16), t[7]);
  u[7] = btf(C(16), t[6], C(48), t[7]);
  v[0] = addw(u[0], u[2]); v[1] = addw(u[1], u[3]);
  v[2] = subw(u[0], u[2]); v[3] = subw(u[1], u[3]);
  v[4] = addw(u[4], u[6]); v[5] = addw(u[5], u[7]);
  v[6] = subw(u[4], u[6]); v[7] = subw(u[5], u[7]);
  w[0] = v[0]; w[1] = v[1];
  w[2] = btf(C(32), v[2], C(32), v[3]);
  w[3] = btf(C(32), v[2], -C(32), v[3]);
  w[4] = v[4]; w[5] = v[5];
  w[6] = btf(C(32), v[6], C(32), v[7]);
  w[7] = btf(C(32), v[6], -C(32), v[7]);
  y[0] = w[0]; y[1] = -w[4]; y[2] = w[6]; y[3] = -w[2];
  y[4] = w[3]; y[5] = -w[7]; y[6] = w[5]; y[7] = -w[1];
}

__device__ __forceinline__ void iadst16(const int* x, int* y) {
  const int b[16] = {x[15], x[0], x[13], x[2], x[11], x[4], x[9], x[6],
                     x[7],  x[8], x[5],  x[10], x[3], x[12], x[1], x[14]};
  int s[16], t[16], u[16], v[16], w[16], a[16], z[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ang = 2 + 8 * k;
    s[2 * k] = btf(C(ang), b[2 * k], C(64 - ang), b[2 * k + 1]);
    s[2 * k + 1] = btf(C(64 - ang), b[2 * k], -C(ang), b[2 * k + 1]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    t[i] = addw(s[i], s[i + 8]);
    t[i + 8] = subw(s[i], s[i + 8]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) u[i] = t[i];
  u[8] = btf(C(8), t[8], C(56), t[9]);
  u[9] = btf(C(56), t[8], -C(8), t[9]);
  u[10] = btf(C(40), t[10], C(24), t[11]);
  u[11] = btf(C(24), t[10], -C(40), t[11]);
  u[12] = btf(-C(56), t[12], C(8), t[13]);
  u[13] = btf(C(8), t[12], C(56), t[13]);
  u[14] = btf(-C(24), t[14], C(40), t[15]);
  u[15] = btf(C(40), t[14], C(24), t[15]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = addw(u[i], u[i + 4]);
    v[i + 4] = subw(u[i], u[i + 4]);
    v[8 + i] = addw(u[8 + i], u[12 + i]);
    v[12 + i] = subw(u[8 + i], u[12 + i]);
  }
#pragma unroll
  for (int h = 0; h < 16; h += 8) {
    w[h + 0] = v[h + 0]; w[h + 1] = v[h + 1];
    w[h + 2] = v[h + 2]; w[h + 3] = v[h + 3];
    w[h + 4] = btf(C(16), v[h + 4], C(48), v[h + 5]);
    w[h + 5] = btf(C(48), v[h + 4], -C(16), v[h + 5]);
    w[h + 6] = btf(-C(48), v[h + 6], C(16), v[h + 7]);
    w[h + 7] = btf(C(16), v[h + 6], C(48), v[h + 7]);
  }
#pragma unroll
  for (int q = 0; q < 16; q += 4) {
    a[q] = addw(w[q], w[q + 2]);
    a[q + 1] = addw(w[q + 1], w[q + 3]);
    a[q + 2] = subw(w[q], w[q + 2]);
    a[q + 3] = subw(w[q + 1], w[q + 3]);
  }
#pragma unroll
  for (int q = 0; q < 16; q += 4) {
    z[q] = a[q];
    z[q + 1] = a[q + 1];
    z[q + 2] = btf(C(32), a[q + 2], C(32), a[q + 3]);
    z[q + 3] = btf(C(32), a[q + 2], -C(32), a[q + 3]);
  }
  constexpr int ord[16] = {0, 8, 12, 4, 6, 14, 10, 2,
                           3, 11, 15, 7, 5, 13, 9, 1};
#pragma unroll
  for (int i = 0; i < 16; ++i) y[i] = (i & 1) ? -z[ord[i]] : z[ord[i]];
}

// The K-point transform of kind 0 DCT, 1 ADST (K <= 16), 2 identity
// (itx.py _txfm1d), in place on v[0..K) of a register array.
template <int K, int N>
__device__ __forceinline__ void txfm_k(int kind, int (&v)[N]) {
  int x[K], y[K];
#pragma unroll
  for (int i = 0; i < K; ++i) x[i] = v[i];
  if (kind == 0) {
    if constexpr (K == 4) idct4(x, y);
    else if constexpr (K == 8) idct8(x, y);
    else if constexpr (K == 16) idct16(x, y);
    else idct32(x, y);
  } else if (K <= 16 && kind == 1) {
    if constexpr (K == 4) iadst4(x, y);
    else if constexpr (K == 8) iadst8(x, y);
    else if constexpr (K == 16) iadst16(x, y);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if constexpr (K == 4) y[i] = round2(mulw(x[i], 5793), 12);
      else if constexpr (K == 8) y[i] = mulw(x[i], 2);
      else if constexpr (K == 16) y[i] = round2(mulw(mulw(x[i], 2), 5793), 12);
      else y[i] = mulw(x[i], 4);
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = y[i];
}

// the n-point transform (n a power of two, 4 <= n <= N <= 32), in place
template <int N>
__device__ __forceinline__ void txfm(int kind, int n, int (&v)[N]) {
  if (n == 4) {
    txfm_k<4>(kind, v);
  } else if constexpr (N >= 8) {
    if (n == 8) {
      txfm_k<8>(kind, v);
    } else if constexpr (N >= 16) {
      if (n == 16) {
        txfm_k<16>(kind, v);
      } else if constexpr (N >= 32) {
        txfm_k<32>(kind, v);
      }
    }
  }
}

// itx.py _SHIFTS: the row pass's rounding shift (the column pass's is 4)
__device__ __forceinline__ int row_shift(int w, int h) {
  const int lw = ilog2(w), lh = ilog2(h);
  if (w == h) return w == 4 ? 0 : (w == 8 ? 1 : 2);
  if (lw - lh == 1 || lh - lw == 1) return (w * h <= 32) ? 0 : 1;
  // 1:4 shapes
  return (w * h <= 64) ? 1 : 2;
}

__device__ __forceinline__ void wht4(int* v) {
  int a = v[0], c = v[1], d = v[2], b = v[3];
  a = addw(a, c);
  d = subw(d, b);
  const int e = subw(a, d) >> 1;
  b = subw(e, b);
  c = subw(e, c);
  a = subw(a, b);
  d = addw(d, c);
  v[0] = a;
  v[1] = b;
  v[2] = c;
  v[3] = d;
}

// ------------------------------------------------------- av1_dequant_itx

constexpr int kItxThreads = 128;
// shared words a block: four 32x33 jobs, or a 64-point job's 32 rows of 65
// and the exchange of its halves
constexpr int kItxSmem = 4 * 32 * 33;

struct ItxGroup {
  const int32_t* coeffs;   // (n, cs, cs), cs = min(sq, 32)
  const int32_t* txp;      // (n, 8)
  const int32_t* order;    // (n,) the order jobs are visited in
  int32_t* out;            // (n, sq, sq)
  int n;
  int sq;
  int first_block;         // the group's blocks: [first_block, next group's)
};

struct ItxArgs {
  ItxGroup g[kMaxGroups];
  int n_groups;
};

// one job's stage-A scalars (cuda_fast.py TXP_*)
struct Job {
  long long index;
  int dcq, acq, tw, th, vk, hk, ud, lr;
  bool valid, on, lossless;
};

__device__ __forceinline__ Job job_at(const ItxGroup& G, long long pos) {
  Job j{};
  j.valid = pos < G.n;
  if (!j.valid) return j;
  j.index = __ldg(G.order + pos);
  const int4* tp = reinterpret_cast<const int4*>(G.txp + j.index * 8);
  const int4 p0 = __ldg(tp), p1 = __ldg(tp + 1);
  j.dcq = p0.x;
  j.acq = p0.y;
  j.tw = p0.z;
  j.th = p0.w;
  j.vk = p1.x & 3;
  j.hk = (p1.x >> 2) & 3;
  j.ud = (p1.x >> 4) & 1;
  j.lr = (p1.x >> 5) & 1;
  j.on = p1.y & 1;
  j.lossless = p1.y & 2;
  return j;
}

// Dequantise the four levels c4 at (y, x..x+3) of job J into row y of m.
__device__ __forceinline__ void dequant4(const Job& J, int4 c4, int y, int x,
                                         int* m) {
  const int c[4] = {c4.x, c4.y, c4.z, c4.w};
  const int pels = J.tw * J.th;
  const int shift = (pels > 256) + (pels > 1024);
  const int lw = ilog2(J.tw), lh = ilog2(J.th);
  const bool rect2 = (lw - lh == 1) || (lh - lw == 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = (y == 0 && x + k == 0) ? J.dcq : J.acq;
    int d;
    if (J.lossless) {
      d = mulw(c[k], q) >> 2;
    } else {
      const int ac = c[k] < 0 ? -c[k] : c[k];
      const int mag = (mulw(ac, q) & 0xFFFFFF) >> shift;
      d = c[k] < 0 ? -mag : mag;
      if (rect2) d = round2(mulw(d, 2896), 12);
    }
    m[x + k] = d;
  }
}

// The jobs of one block of a group of sq <= 32: SQ threads a job, thread r
// of a job loading and storing SQ/4 vectors, transforming row r, then
// column r.
template <int SQ>
__device__ __forceinline__ void itx_small(const ItxGroup& G, long long b,
                                          int* sh) {
  constexpr int JPB = kItxThreads / SQ, P = SQ + 1, NV = SQ / 4;
  constexpr int LSQ = SQ == 4 ? 2 : SQ == 8 ? 3 : SQ == 16 ? 4 : 5;
  const int jl = threadIdx.x / SQ, r = threadIdx.x % SQ;
  const Job J = job_at(G, b * JPB + jl);
  int* m = sh + jl * SQ * P;

  // 1. the levels, dequantised into m
  if (J.on) {
    const int4* cp = reinterpret_cast<const int4*>(G.coeffs +
                                                   J.index * SQ * SQ);
    int4 c4[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) c4[k] = __ldg(cp + r + SQ * k);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int e = 4 * (r + SQ * k), y = e >> LSQ, x = e & (SQ - 1);
      dequant4(J, c4[k], y, x, m + y * P);
    }
  }
  __syncthreads();

  // 2. row pass: thread r transforms row r
  if (J.on && r < J.th) {
    int v[SQ];
#pragma unroll
    for (int i = 0; i < SQ; ++i) v[i] = i < J.tw ? m[r * P + i] : 0;
    if (SQ == 4 && J.lossless) {
      wht4(v);
#pragma unroll
      for (int i = 0; i < 4; ++i) m[r * P + i] = v[i];
    } else {
      txfm<SQ>(J.hk, J.tw, v);
      const int sh = row_shift(J.tw, J.th);
#pragma unroll
      for (int i = 0; i < SQ; ++i)
        if (i < J.tw) m[r * P + (J.lr ? J.tw - 1 - i : i)] = round2(v[i], sh);
    }
  }
  __syncthreads();

  // 3. column pass: thread r transforms column r
  if (J.on && r < J.tw) {
    int v[SQ];
#pragma unroll
    for (int i = 0; i < SQ; ++i) v[i] = i < J.th ? m[i * P + r] : 0;
    if (SQ == 4 && J.lossless) {
      wht4(v);
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i * P + r] = v[i];
    } else {
      txfm<SQ>(J.vk, J.th, v);
#pragma unroll
      for (int i = 0; i < SQ; ++i)
        if (i < J.th) m[(J.ud ? J.th - 1 - i : i) * P + r] = round2(v[i], 4);
    }
  }
  __syncthreads();

  // 4. the (sq, sq) slot as 16-byte vectors, zero outside (th, tw)
  if (J.valid) {
    int4* op = reinterpret_cast<int4*>(G.out + J.index * SQ * SQ);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int e = 4 * (r + SQ * k), y = e >> LSQ, x = e & (SQ - 1);
      int o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = (J.on && y < J.th && x + j < J.tw) ? m[y * P + x + j] : 0;
      op[r + SQ * k] = make_int4(o[0], o[1], o[2], o[3]);
    }
  }
}

// One job of the 64 group, the block's 128 threads.  Levels exist in the
// 32x32 corner only, so rows 32..63 are zero after the row pass and every
// 64-point transform has zero inputs past 32: thread pairs split it into
// its even half (the 32-point DCT) and its odd half.
__device__ __forceinline__ void itx_64(const ItxGroup& G, long long b,
                                       int* sh) {
  constexpr int P = 65;
  const int t = threadIdx.x;
  const Job J = job_at(G, b);
  int* m = sh;               // rows 0..31, 64 wide
  int* xr = sh + 32 * P;     // the row pass's exchange, a row a pitch

  if (!J.on) {               // no residual: the slot as zero vectors
    if (J.valid) {
      int4* op = reinterpret_cast<int4*>(G.out + J.index * 4096);
#pragma unroll
      for (int k = 0; k < 8; ++k) op[t + 128 * k] = make_int4(0, 0, 0, 0);
    }
    return;                  // the whole block: one job
  }

  // 1. levels (32x32, two vectors a thread), dequantised into m
  {
    const int4* cp = reinterpret_cast<const int4*>(G.coeffs +
                                                   J.index * 1024);
    const int4 c0 = __ldg(cp + t), c1 = __ldg(cp + t + 128);
    dequant4(J, c0, (4 * t) >> 5, (4 * t) & 31, m + ((4 * t) >> 5) * P);
    const int e1 = 4 * (t + 128);
    dequant4(J, c1, e1 >> 5, e1 & 31, m + (e1 >> 5) * P);
  }
  __syncthreads();

  // 2. row pass: row rr by thread rr (and rr + 32 for its odd half)
  const int rr = t & 31, half = (t >> 5) & 1;
  const bool row_on = t < 64 && rr < J.th;
  const bool split_r = J.tw == 64;
  int mine[32];
  if (row_on) {
    if (split_r) {
      int xin[32];
#pragma unroll
      for (int k = 0; k < 32; ++k)
        xin[k] = k < 16 ? m[rr * P + 2 * k + half] : 0;
      if (half == 0) idct32(xin, mine); else idct64_odd(xin, mine);
#pragma unroll
      for (int k = 0; k < 32; ++k) xr[rr * P + half * 32 + k] = mine[k];
    } else if (half == 0) {
      int v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = i < J.tw ? m[rr * P + i] : 0;
      txfm<32>(J.hk, J.tw, v);
      const int sh = row_shift(J.tw, J.th);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (i < J.tw) m[rr * P + (J.lr ? J.tw - 1 - i : i)] = round2(v[i], sh);
    }
  }
  __syncthreads();
  if (row_on && split_r) {
    const int sh = row_shift(64, J.th);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int y = half == 0 ? addw(mine[k], xr[rr * P + 63 - k])
                              : subw(xr[rr * P + 31 - k], mine[k]);
      const int o = half * 32 + k;
      m[rr * P + (J.lr ? 63 - o : o)] = round2(y, sh);
    }
  }
  __syncthreads();

  // 3. column pass: column c by thread c (and c + 64 for its odd half);
  // the exchange overlays m once every column is in registers
  const int c = t & 63, ch = t >> 6;
  const bool split_c = J.th == 64;
  const bool col_on = c < J.tw && (split_c || ch == 0);
  int xin[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int i = split_c ? 2 * k + ch : k;    // the input row
    xin[k] = (col_on && i < 32 && i < J.th) ? m[i * P + c] : 0;
  }
  __syncthreads();
  int* xc = sh;              // the column pass's exchange, a column a pitch
  int res[32];
  if (col_on) {
    if (split_c) {
      if (ch == 0) idct32(xin, res); else idct64_odd(xin, res);
#pragma unroll
      for (int k = 0; k < 32; ++k) xc[c * P + ch * 32 + k] = res[k];
    } else {
      txfm<32>(J.vk, J.th, xin);
#pragma unroll
      for (int k = 0; k < 32; ++k) res[k] = xin[k];
    }
  }
  __syncthreads();

  // 4. column c's rows ch*32 .. ch*32+31, zero outside (th, tw); a warp
  // stores 32 consecutive words of a row
  int32_t* out = G.out + J.index * 4096;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    int v = 0, row = ch * 32 + k;
    if (col_on) {
      if (split_c) {
        v = round2(ch == 0 ? addw(res[k], xc[c * P + 63 - k])
                           : subw(xc[c * P + 31 - k], res[k]), 4);
        if (J.ud) row = 63 - row;
      } else if (k < J.th) {
        v = round2(res[k], 4);
        if (J.ud) row = J.th - 1 - k;
      }
    }
    out[row * 64 + c] = v;
  }
}

__global__ void __launch_bounds__(kItxThreads)
av1_dequant_itx_kernel(const ItxArgs a) {
  __shared__ int sh[kItxSmem];
  // the block's group: the last whose block range starts at or before it
  // (the loop indexes the parameters with constants only)
  ItxGroup G = a.g[0];
#pragma unroll
  for (int k = 1; k < kMaxGroups; ++k)
    if (k < a.n_groups && static_cast<int>(blockIdx.x) >= a.g[k].first_block)
      G = a.g[k];
  const long long b = static_cast<long long>(blockIdx.x) - G.first_block;
  switch (G.sq) {
    case 4: itx_small<4>(G, b, sh); break;
    case 8: itx_small<8>(G, b, sh); break;
    case 16: itx_small<16>(G, b, sh); break;
    case 32: itx_small<32>(G, b, sh); break;
    default: itx_64(G, b, sh); break;
  }
}

// -------------------------------------------------------- av1_intra_wave

constexpr int kWaveWarps = 16;
constexpr int kWaveThreads = kWaveWarps * 32;
constexpr int kMaxJobs = 128;    // job records of a chunk
constexpr int kPool = 40960;     // words of the chunk's job slots
// a warp's phase-1 scratch: the corner and references of each side (EL =
// 2*64+8 words) and their filtered forms
constexpr int kEdge = 2 * 64 + 8;
constexpr int kScratch = 4 * kEdge;

// PARAM_COLS of cuda_fast.py
enum {
  kPMode, kPWv, kPHv, kPAngle, kPDx, kPDy, kPUpsA, kPUpsL, kPStrA, kPStrL,
  kPNaF, kPNlF, kPCornerF, kPHaveAbove, kPHaveLeft, kPIsCfl, kPCflAlpha,
  kPFiMode, kPDst, kPPw, kPHh, kPWw, kPLy, kPLx, kPBh, kPBw, kPLbase,
  kNParams
};
enum { kDcPred = 0, kSmoothPred = 9, kSmoothVPred = 10, kSmoothHPred = 11,
       kPaethPred = 12 };
// a job's record: what phase 2 reads
enum {
  kRFi, kRMode, kRWv, kRHv, kRPa, kRDx, kRDy, kRUpa, kRUpl, kRCfl, kRAlpha,
  kRAvg, kRDc, kRCorner, kRDst, kRPw, kRHh, kRWw, kRSlot, kRUl, kRec
};
constexpr int kDynWords = kWaveWarps * kScratch + kMaxJobs * kRec + kPool;
constexpr int kDynBytes = kDynWords * 4;

// smooth weights for sizes 4, 8, 16, 32, 64 (recon.py _pred_tables)
__constant__ int kSm[124] = {
    255, 149, 85,  64,  255, 197, 146, 105, 73,  50,  37,  32,  255, 225,
    196, 170, 145, 123, 102, 84,  68,  54,  43,  33,  26,  20,  17,  16,
    255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111, 101, 92,
    83,  74,  66,  59,  52,  45,  39,  34,  29,  25,  21,  17,  14,  12,
    10,  9,   8,   8,   255, 248, 240, 233, 225, 218, 210, 203, 196, 189,
    182, 176, 169, 163, 156, 150, 144, 138, 133, 127, 121, 116, 111, 106,
    101, 96,  91,  86,  82,  77,  73,  69,  65,  61,  57,  54,  50,  47,
    44,  41,  38,  35,  32,  29,  27,  25,  22,  20,  18,  16,  15,  13,
    12,  10,  9,   8,   7,   6,   6,   5,   5,   4,   4,   4};
// intra edge filter kernels by strength 0..3 (0: identity)
__constant__ int kEdgeK[4][5] = {
    {0, 16, 0, 0, 0}, {0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
// filter-intra taps [mode][output][input] (cdf.py filter_intra_taps)
__constant__ int kFiTaps[5][8][8] = {
    {{-6, 10, 0, 0, 0, 12, 0, 0}, {-5, 2, 10, 0, 0, 9, 0, 0},
     {-3, 1, 1, 10, 0, 7, 0, 0},  {-3, 1, 1, 2, 10, 5, 0, 0},
     {-4, 6, 0, 0, 0, 2, 12, 0},  {-3, 2, 6, 0, 0, 2, 9, 0},
     {-3, 2, 2, 6, 0, 2, 7, 0},   {-3, 1, 2, 2, 6, 3, 5, 0}},
    {{-10, 16, 0, 0, 0, 10, 0, 0}, {-6, 0, 16, 0, 0, 6, 0, 0},
     {-4, 0, 0, 16, 0, 4, 0, 0},   {-2, 0, 0, 0, 16, 2, 0, 0},
     {-10, 16, 0, 0, 0, 0, 10, 0}, {-6, 0, 16, 0, 0, 0, 6, 0},
     {-4, 0, 0, 16, 0, 0, 4, 0},   {-2, 0, 0, 0, 16, 0, 2, 0}},
    {{-8, 8, 0, 0, 0, 16, 0, 0}, {-8, 0, 8, 0, 0, 16, 0, 0},
     {-8, 0, 0, 8, 0, 16, 0, 0}, {-8, 0, 0, 0, 8, 16, 0, 0},
     {-4, 4, 0, 0, 0, 0, 16, 0}, {-4, 0, 4, 0, 0, 0, 16, 0},
     {-4, 0, 0, 4, 0, 0, 16, 0}, {-4, 0, 0, 0, 4, 0, 16, 0}},
    {{-2, 8, 0, 0, 0, 10, 0, 0}, {-1, 3, 8, 0, 0, 6, 0, 0},
     {-1, 2, 3, 8, 0, 4, 0, 0},  {0, 1, 2, 3, 8, 2, 0, 0},
     {-1, 4, 0, 0, 0, 3, 10, 0}, {-1, 3, 4, 0, 0, 4, 6, 0},
     {-1, 2, 3, 4, 0, 4, 4, 0},  {-1, 2, 2, 3, 4, 3, 3, 0}},
    {{-12, 14, 0, 0, 0, 14, 0, 0}, {-10, 0, 14, 0, 0, 12, 0, 0},
     {-9, 0, 0, 14, 0, 11, 0, 0},  {-8, 0, 0, 0, 14, 10, 0, 0},
     {-10, 12, 0, 0, 0, 0, 14, 0}, {-9, 1, 12, 0, 0, 0, 12, 0},
     {-8, 0, 0, 12, 0, 1, 11, 0},  {-7, 0, 0, 1, 12, 1, 9, 0}}};

struct WaveGroup {
  const int32_t* above;    // (n, la) sentinel-coded gather indices
  const int32_t* left;     // (n, la)
  const int32_t* corner;   // (n,)
  const int32_t* params;   // (n, kNParams)
  const int32_t* res;      // (n, sq, sq)
  int sq;
  int fi;
};

struct WaveArgs {
  WaveGroup g[kMaxGroups];
  const int32_t* rows;     // (n_groups, n_waves, pictures + 1)
  int32_t* buf;            // every plane of every picture, then trash
  int n_groups, n_waves, pictures;
  int trash, bd, edge, ssx, ssy, lh, lw;
};

// a group as the block reads it, in shared memory
struct GroupC {
  const int32_t* above;
  const int32_t* left;
  const int32_t* corner;
  const int32_t* params;
  const int32_t* res;
  int sq, lsq, fi, slot;   // slot: shared words a job of the group takes
};

// The jobs [c0, c0 + njobs) of wave w, in the wave's order (group by
// group): per group its first sample, job and slot word in the chunk and
// the row of its first job.  Groups past n_groups hold the totals.
struct Chunk {
  int w, c0, njobs, total, samples;
  int sbase[kMaxGroups], jbase[kMaxGroups], obase[kMaxGroups],
      row0[kMaxGroups];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// device_recon.py refvals :520-526
__device__ __forceinline__ int refval(const WaveArgs& a, int idx) {
  const int base = 1 << (a.bd - 1);
  if (idx == -1) return base - 1;
  if (idx == -2) return base + 1;
  if (idx == -3) return base;
  return a.buf[clampi(idx, 0, a.trash)];
}

__device__ __forceinline__ bool directional(int mode) {
  return !(mode == kDcPred || mode == kPaethPred || mode == kSmoothPred ||
           mode == kSmoothVPred || mode == kSmoothHPred);
}

// entry pos of the upsampled (or edge-padded) reference line of one side
// from its filtered edge f[0..EL); n1 = max(n_up - 1, 0) (device_recon.py
// :715-747)
__device__ __forceinline__ int line_at(const int* f, int pos, int EL, int sq,
                                       int ups, int n1, int maxv) {
  if (!ups) return f[min(pos, EL - 1)];
  const int ns = 2 * sq + 4;
  auto sv = [&](int m) {
    m = clampi(m, 0, ns - 1);
    if (m < 2) return f[0];
    return f[clampi(min(m - 2, n1), 0, EL - 2) + 1];
  };
  const int kq = (pos - 2) >> 1;
  if (pos > 2 + 2 * n1) return sv(n1 + 2);
  if ((pos & 1) == 0) return sv(min(kq, n1) + 2);
  const int km = min(kq, n1 - 1);
  const int raw = -sv(km + 1) + 9 * sv(km + 2) + 9 * sv(km + 3) - sv(km + 4);
  return clampi(round2(raw, 4), 0, maxv);
}

// A CfL job's luma box: n = wv*hv entries, entry (r, c) the sum of the NM
// luma samples at (ly + r*sy, lx + c*sx) and right of and below it, r and
// c clamped to the box's rows and columns inside the frame (rmax, cmax),
// the samples to the frame (cfl_indices of cuda_fast.py).
struct CflBox {
  const int* luma;
  int* q3;
  int n, lgw, wv, ly, lx, rmax, cmax, sy, sx, lh, lw;
};

// The box's Q3 values (sum << 3 - log2 NM) into q3[0..n), the whole warp;
// returns this lane's part of their total.
template <int NM>
__device__ __forceinline__ int cfl_box(const CflBox& b, int lane) {
  constexpr int kBatch = 4;           // entries a lane loads at once
  constexpr int q3s = NM == 4 ? 1 : (NM == 2 ? 2 : 3);
  int tot = 0;
  for (int i0 = 0; i0 < b.n; i0 += 32 * kBatch) {
    int s[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + lane + 32 * u;
      s[u] = 0;
      if (i < b.n) {
        const int y = b.ly + min(i >> b.lgw, b.rmax) * b.sy;
        const int x = b.lx + min(i & (b.wv - 1), b.cmax) * b.sx;
        const int x0 = min(x, b.lw - 1), x1 = min(x + 1, b.lw - 1);
        const int* row = b.luma + static_cast<long long>(min(y, b.lh - 1)) *
                                      b.lw;
        s[u] = row[x0];
        if (NM >= 2) s[u] += row[x1];
        if (NM == 4) {
          row = b.luma + static_cast<long long>(min(y + 1, b.lh - 1)) * b.lw;
          s[u] += row[x0] + row[x1];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + lane + 32 * u;
      if (i < b.n) {
        b.q3[i] = s[u] << q3s;
        tot += s[u] << q3s;
      }
    }
  }
  return tot;
}

// What a job's phase 1 reads that depends on no sample: its parameters
// (one a lane), its gather indices (above, left) and the corner's.
constexpr int kSeg = (2 * 64 + 7 + 31) / 32;
struct JobLoads {
  int pv, ci;
  int ia[kSeg], il[kSeg];
};

__device__ __forceinline__ JobLoads load_job(const GroupC& G, int row,
                                             int lane) {
  JobLoads L;
  const int la = G.fi ? G.sq : 2 * G.sq + 7;
  const long long r = row;
  L.pv = lane < kNParams ? __ldg(G.params + r * kNParams + lane) : 0;
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    const int i = lane + 32 * k;
    L.ia[k] = i < la ? __ldg(G.above + r * la + i) : -3;
    L.il[k] = i < la ? __ldg(G.left + r * la + i) : -3;
  }
  L.ci = __ldg(G.corner + row);
  return L;
}

// Phase 1 of one normal (non filter-intra) job, the whole warp: the
// references of a directional mode filtered and upsampled into the slot's
// two lines (slot[0..UL), slot[UL..2UL)), else the raw corner and
// references there; a CfL job's Q3 luma box at slot[2UL..) and its average.
__device__ __forceinline__ void prep_normal(const WaveArgs& a,
                                            const GroupC& G,
                                            const JobLoads& L, int* rec,
                                            int* slot, int* scr, int lane) {
  const int sq = G.sq;
  const int L2 = 2 * sq + 7, EL = L2 + 1, UL = 4 * sq + 10;
  const int pv = L.pv;
  // the samples, at once
  int va[kSeg], vl[kSeg];
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    va[k] = refval(a, L.ia[k]);
    vl[k] = refval(a, L.il[k]);
  }
  const int corner = refval(a, L.ci);
  auto P = [&](int c) { return __shfl_sync(0xffffffffu, pv, c); };
  const int mode = P(kPMode), wv = P(kPWv), hv = P(kPHv);
  const int ha = P(kPHaveAbove), hl = P(kPHaveLeft);
  const int pa = P(kPAngle), upa = P(kPUpsA), upl = P(kPUpsL);
  const int cornerf = P(kPCornerF), na = P(kPNaF), nl = P(kPNlF);
  const int str_a = P(kPStrA), str_l = P(kPStrL);
  const int is_cfl = P(kPIsCfl), alpha = P(kPCflAlpha);
  const int dst = P(kPDst), pw = P(kPPw), hh = P(kPHh), ww = P(kPWw);
  const int ly = P(kPLy), lx = P(kPLx), bh = P(kPBh), bw = P(kPBw);
  const int lbase = P(kPLbase), dxv = P(kPDx), dyv = P(kPDy);
  const int maxv = (1 << a.bd) - 1, base = 1 << (a.bd - 1);
  const bool dir = directional(mode);
  const int lgw = ilog2(wv), lgh = ilog2(hv);
  // CfL: the job's Q3 luma box, once, and its average (device_recon.py
  // :826-848); members 4 (4:2:0), 2 (4:2:2) or 1 (4:4:4).  Its loads
  // depend on the parameters only, so they go out beside the gather's.
  int avg = 0;
  if (is_cfl) {
    const int nm = (a.ssx && a.ssy) ? 4 : (a.ssx ? 2 : 1);
    const CflBox box{a.buf + lbase, slot + 2 * UL, wv * hv, lgw, wv, ly, lx,
                     max(bh - 1, 0), max(bw - 1, 0), a.ssy ? 2 : 1,
                     a.ssx ? 2 : 1, a.lh, a.lw};
    const int tot = warp_sum(nm == 4 ? cfl_box<4>(box, lane)
                             : nm == 2 ? cfl_box<2>(box, lane)
                                       : cfl_box<1>(box, lane));
    avg = (tot + (1 << (lgw + lgh - 1))) >> (lgw + lgh);
  }
  // corner, then the references: scratch for a directional mode (filtered
  // into the slot), the slot itself for the others
  int* ea = dir ? scr : slot;
  int* el = dir ? scr + kEdge : slot + UL;
  int sa = 0, sl = 0;
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    const int i = lane + 32 * k;
    if (i < L2) {
      ea[1 + i] = va[k];
      el[1 + i] = vl[k];
      if (i < wv) sa += va[k];
      if (i < hv) sl += vl[k];
    }
  }
  if (lane == 0) ea[0] = el[0] = corner;
  int dc = 0;                // DC_PRED's value (and CfL's base)
  if (mode == kDcPred) {
    sa = warp_sum(sa);
    sl = warp_sum(sl);
    if (ha && hl)
      dc = (sa + sl + ((wv + hv) >> 1)) / (wv + hv);
    else if (ha)
      dc = (sa + (1 << (lgw > 0 ? lgw - 1 : 0))) >> lgw;
    else if (hl)
      dc = (sl + (1 << (lgh > 0 ? lgh - 1 : 0))) >> lgh;
    else
      dc = base;
  }
  __syncwarp();
  if (dir) {
    const int* fa = ea;
    const int* fl = el;
    if (a.edge) {
      if (cornerf) {
        const int sC = round2(5 * ea[1] + 6 * corner + 5 * el[1], 4);
        __syncwarp();
        if (lane == 0) ea[0] = el[0] = sC;
        __syncwarp();
      }
      int* ga = scr + 2 * kEdge;
      int* gl = scr + 3 * kEdge;
      const int ka = clampi(str_a, 0, 3), kl = clampi(str_l, 0, 3);
      for (int i = lane; i < EL; i += 32) {
        int acc_a = 0, acc_l = 0;
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          acc_a += kEdgeK[ka][j] * ea[min(max(i - 2 + j, 0), max(na - 1, 0))];
          acc_l += kEdgeK[kl][j] * el[min(max(i - 2 + j, 0), max(nl - 1, 0))];
        }
        ga[i] = (str_a > 0 && i >= 1 && i < na) ? (acc_a + 8) >> 4 : ea[i];
        gl[i] = (str_l > 0 && i >= 1 && i < nl) ? (acc_l + 8) >> 4 : el[i];
      }
      __syncwarp();
      fa = ga;
      fl = gl;
    }
    // the two sides' lines, together
    const int n1a = max((pa < 90 ? wv + hv : wv) - 1, 0);
    const int n1l = max((pa > 180 ? wv + hv : hv) - 1, 0);
    for (int pos = lane; pos < UL; pos += 32) {
      const int va_ = line_at(fa, pos, EL, sq, upa, n1a, maxv);
      const int vl_ = line_at(fl, pos, EL, sq, upl, n1l, maxv);
      slot[pos] = va_;
      slot[UL + pos] = vl_;
    }
  }
  if (lane == 0) {
    rec[kRFi] = 0;
    rec[kRMode] = mode;
    rec[kRWv] = wv;
    rec[kRHv] = hv;
    rec[kRPa] = pa;
    rec[kRDx] = dxv;
    rec[kRDy] = dyv;
    rec[kRUpa] = upa;
    rec[kRUpl] = upl;
    rec[kRCfl] = is_cfl;
    rec[kRAlpha] = alpha;
    rec[kRAvg] = avg;
    rec[kRDc] = dc;
    rec[kRCorner] = corner;
    rec[kRDst] = dst;
    rec[kRPw] = pw;
    rec[kRHh] = hh;
    rec[kRWw] = ww;
    rec[kRUl] = UL;
  }
}

// Phase 1 of one filter-intra job (device_recon.py :850-881), the whole
// warp: the (sq+1)^2 patch buffer in the slot, its 4x2 patches along
// anti-diagonals (patch (i, j) reads patches (i-1, j-1), (i-1, j) and
// (i, j-1) only), a lane an output.
__device__ __forceinline__ void prep_fi(const WaveArgs& a, const GroupC& G,
                                        const JobLoads& L, int* rec, int* pb,
                                        int lane) {
  const int sq = G.sq, n = sq + 1;
  const int pv = L.pv;
  const int vt = refval(a, L.ia[0]), vl = refval(a, L.il[0]);
  const int corner = refval(a, L.ci);
  auto P = [&](int c) { return __shfl_sync(0xffffffffu, pv, c); };
  const int maxv = (1 << a.bd) - 1;
  const int mode = clampi(P(kPFiMode), 0, 4);
  const int dst = P(kPDst), pw = P(kPPw), hh = P(kPHh), ww = P(kPWw);
  if (lane < sq) {
    pb[1 + lane] = vt;
    pb[(1 + lane) * n] = vl;
  }
  if (lane == 0) pb[0] = corner;
  __syncwarp();
  const int pr = sq / 2, pc = sq / 4;     // patch rows and columns
  for (int d = 0; d < pr + pc - 1; ++d) {
    const int j0 = max(0, d - (pr - 1)), np = min(d, pc - 1) - j0 + 1;
    int v[2], at[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = lane + 32 * h, out = o & 7, j = j0 + (o >> 3);
      const int r = 1 + 2 * (d - j), c = 1 + 4 * j;
      v[h] = 0;
      at[h] = -1;
      if (o < np * 8) {
        const int* t = kFiTaps[mode][out];
        int s = 0;
#pragma unroll
        for (int k = 0; k < 5; ++k) s += t[k] * pb[(r - 1) * n + c - 1 + k];
        s += t[5] * pb[r * n + c - 1] + t[6] * pb[(r + 1) * n + c - 1];
        s = s >= 0 ? (s + 8) >> 4 : -((-s + 8) >> 4);
        v[h] = clampi(s, 0, maxv);
        at[h] = (r + (out >> 2)) * n + c + (out & 3);
      }
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (at[h] >= 0) pb[at[h]] = v[h];
    __syncwarp();
  }
  if (lane == 0) {
    rec[kRFi] = 1;
    rec[kRDst] = dst;
    rec[kRPw] = pw;
    rec[kRHh] = hh;
    rec[kRWw] = ww;
  }
}

// Phase 2 of the samples s..s+3 (s a multiple of 4, < sq*sq) of a job, in
// one row: predict, add the residuals r4, clip, store the samples inside
// the job's visible part.
__device__ __forceinline__ void put_quad(const WaveArgs& a, int sq, int lsq,
                                         const int* rec, const int* slot,
                                         int s, int4 r4) {
  const int y = s >> lsq, x0 = s & (sq - 1);
  const int hh = rec[kRHh], ww = rec[kRWw];
  if (y >= hh || x0 >= ww) return;
  const int maxv = (1 << a.bd) - 1;
  int pred[4];
  if (rec[kRFi]) {
    const int* row = slot + (1 + y) * (sq + 1) + 1 + x0;
#pragma unroll
    for (int u = 0; u < 4; ++u) pred[u] = row[u];
  } else {
    const int mode = rec[kRMode], wv = rec[kRWv], hv = rec[kRHv];
    const int UL = rec[kRUl];
    const int* ea = slot;          // corner, then the above references
    const int* el = slot + UL;     // (or, directional: the two lines)
    if (mode == kDcPred) {
      const int dc = rec[kRDc];
#pragma unroll
      for (int u = 0; u < 4; ++u) pred[u] = dc;
    } else if (mode == kPaethPred) {
      const int corner = rec[kRCorner], l = el[1 + y];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = ea[1 + x0 + u];
        const int pb = t + l - corner;
        const int pl = abs(pb - l), pt = abs(pb - t), ptl = abs(pb - corner);
        pred[u] = (pl <= pt && pl <= ptl) ? l : (pt <= ptl ? t : corner);
      }
    } else if (!directional(mode)) {
      const int wvert = kSm[clampi(hv - 4 + min(y, hv - 1), 0, 123)];
      const int l = el[1 + y], below = el[hv], right = ea[wv];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int x = x0 + u;
        const int whorz = kSm[clampi(wv - 4 + min(x, wv - 1), 0, 123)];
        const int sv = wvert * ea[1 + x] + (256 - wvert) * below;
        const int sh = whorz * l + (256 - whorz) * right;
        pred[u] = mode == kSmoothPred ? round2(sv + sh, 9)
                                      : (mode == kSmoothVPred ? round2(sv, 8)
                                                              : round2(sh, 8));
      }
    } else {
      const int pa = rec[kRPa], upa = rec[kRUpa], upl = rec[kRUpl];
      const int dxv = rec[kRDx], dyv = rec[kRDy];
      const int aoff = upa ? 2 : 1, loff = upl ? 2 : 1;
      const int* ua = ea;
      const int* ul = el;
      auto at = [&](const int* ub, int i) { return ub[clampi(i, 0, UL - 1)]; };
      auto interp = [&](const int* ub, int i, int sh) {
        return round2(at(ub, i) * (32 - sh) + at(ub, i + 1) * sh, 5);
      };
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int x = x0 + u;
        int v;
        if (pa < 90) {
          const int idx = (y + 1) * dxv;
          const int b = (idx >> (6 - upa)) + (x << upa);
          const int sh = ((idx << upa) >> 1) & 0x1F;
          const int maxb = (wv + hv - 1) << upa;
          v = b < maxb ? interp(ua, aoff + b, sh) : at(ua, aoff + maxb);
        } else if (pa == 90) {
          v = ua[aoff + x];
        } else if (pa < 180) {
          const int idx = (x << 6) - (y + 1) * dxv;
          const int b = idx >> (6 - upa);
          if (b >= -(1 << upa)) {
            v = interp(ua, aoff + b, (mulw(idx, 1 << upa) >> 1) & 0x1F);
          } else {
            const int idl = (y << 6) - (x + 1) * dyv;
            v = interp(ul, loff + (idl >> (6 - upl)),
                       (mulw(idl, 1 << upl) >> 1) & 0x1F);
          }
        } else if (pa == 180) {
          v = ul[loff + y];
        } else {
          const int idx = (x + 1) * dyv;
          const int b = (idx >> (6 - upl)) + (y << upl);
          const int sh = ((idx << upl) >> 1) & 0x1F;
          const int maxb = (wv + hv - 1) << upl;
          v = b < maxb ? interp(ul, loff + b, sh) : at(ul, loff + maxb);
        }
        pred[u] = clampi(v, 0, maxv);
      }
    }
    if (rec[kRCfl]) {
      const int* q3 = slot + 2 * UL + (y << ilog2(wv)) + x0;
      const int alpha = rec[kRAlpha], avg = rec[kRAvg];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int scaled = alpha * (q3[u] - avg);
        const int adj = scaled >= 0 ? (scaled + 32) >> 6
                                    : -((-scaled + 32) >> 6);
        pred[u] = clampi(pred[u] + adj, 0, maxv);
      }
    }
  }
  const int r[4] = {r4.x, r4.y, r4.z, r4.w};
  int32_t* out = a.buf + rec[kRDst] + static_cast<long long>(y) * rec[kRPw] +
                 x0;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (x0 + u < ww) out[u] = clampi(pred[u] + r[u], 0, maxv);
}

// the last group q whose base is at or below i (groups without jobs in
// the chunk share the next group's base; those past the end hold the total)
__device__ __forceinline__ int group_at(const int* bases, int i) {
  int g = 0;
#pragma unroll
  for (int q = 1; q < kMaxGroups; ++q) g = bases[q] <= i ? q : g;
  return g;
}

// inclusive prefix sum over the warp's lanes
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// A warp, lane g holding group g's rows [lo, lo + cnt) of wave w: the
// chunk of the wave from its job c0 on, as many jobs (in the wave's order)
// as the records and the slot pool hold.
__device__ __forceinline__ void build_chunk(Chunk& C, int w, int c0, int lo,
                                            int cnt, const GroupC* gc,
                                            int lane) {
  const int slot = lane < kMaxGroups ? gc[lane].slot : 0;
  const int l2 = lane < kMaxGroups ? 2 * gc[lane].lsq : 0;
  const int incl = warp_scan(cnt, lane);
  const int start = clampi(c0 - (incl - cnt), 0, cnt);
  const int avail = cnt - start;
  const int aj = warp_scan(avail, lane), aw = warp_scan(avail * slot, lane);
  // the first group that does not fit whole takes what still fits, the
  // groups after it nothing
  const bool fits = aj <= kMaxJobs && aw <= kPool;
  const int first = __ffs(__ballot_sync(0xffffffffu, !fits)) - 1;
  int take = avail;
  if (first >= 0 && lane >= first) {
    take = lane > first ? 0
           : min(avail, min(kMaxJobs - (aj - avail),
                            slot > 0 ? (kPool - (aw - avail * slot)) / slot
                                     : avail));
  }
  const int tj = warp_scan(take, lane), tw = warp_scan(take * slot, lane);
  const int ts = warp_scan(take << l2, lane);
  if (lane < kMaxGroups) {
    C.sbase[lane] = ts - (take << l2);
    C.jbase[lane] = tj - take;
    C.obase[lane] = tw - take * slot;
    C.row0[lane] = lo + start;
  }
  const int njobs = __shfl_sync(0xffffffffu, tj, 31);
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  const int samples = __shfl_sync(0xffffffffu, ts, 31);
  if (lane == 0) {
    C.w = w;
    C.c0 = c0;
    C.njobs = njobs;
    C.total = total;
    C.samples = samples;
  }
}

// A warp: ask L2 for the tables of the rows [lo, lo + cnt) of group
// `lane` (parameters, gather indices, corner), a wave ahead.
__device__ __forceinline__ void prefetch_rows(const GroupC* gc, int lo,
                                              int cnt, int lane) {
#ifdef __CUDA_ARCH__
  if (lane >= kMaxGroups || cnt <= 0) return;
  const GroupC& G = gc[lane];
  const int la = G.fi ? G.sq : 2 * G.sq + 7;
  auto fetch = [](const int32_t* p, int words) {
    for (int k = 0; k < words; k += 32)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p + k));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + words - 1));
  };
  fetch(G.params + static_cast<long long>(lo) * kNParams, cnt * kNParams);
  fetch(G.above + static_cast<long long>(lo) * la, cnt * la);
  fetch(G.left + static_cast<long long>(lo) * la, cnt * la);
  fetch(G.corner + lo, cnt);
#endif
}

// the row ranges of group `lane`, wave w of picture t
__device__ __forceinline__ void wave_rows_of(const WaveArgs& a, int w, int t,
                                             int lane, int& lo, int& hi) {
  lo = hi = 0;
  if (w < a.n_waves && lane < a.n_groups) {
    const int32_t* r = a.rows + (static_cast<long long>(lane) * a.n_waves +
                                 w) * (a.pictures + 1) + t;
    lo = r[0];
    hi = r[1];
  }
}

// Where sample i (a multiple of 4) of chunk C lies: its group, record and
// offset in its box; the address of its residual and the next three.
__device__ __forceinline__ const int4* locate(const Chunk& C,
                                             const GroupC* gc, int i,
                                             int& g, int& k, int& s) {
  g = group_at(C.sbase, i);
  const int off = i - C.sbase[g], l2 = 2 * gc[g].lsq;
  const int j = off >> l2;
  k = C.jbase[g] + j;
  s = off & ((1 << l2) - 1);
  return reinterpret_cast<const int4*>(
      gc[g].res + (static_cast<long long>(C.row0[g] + j) << l2) + s);
}

// One block a picture, walking its waves in order, chunk by chunk.
__global__ void __launch_bounds__(kWaveThreads, 1)
av1_intra_wave_kernel(const WaveArgs a) {
  extern __shared__ int s_dyn[];
  __shared__ GroupC s_g[kMaxGroups];
  __shared__ Chunk s_chunk[2];
  int* scratch = s_dyn;
  int* recs = s_dyn + kWaveWarps * kScratch;
  int* pool = recs + kMaxJobs * kRec;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = blockIdx.x;
  if (tid < kMaxGroups) {    // the parameters indexed with constants only
    GroupC c{};
    c.sq = 4;
#pragma unroll
    for (int k = 0; k < kMaxGroups; ++k) {
      if (k == tid && k < a.n_groups) {
        const WaveGroup& G = a.g[k];
        c.above = G.above;
        c.left = G.left;
        c.corner = G.corner;
        c.params = G.params;
        c.res = G.res;
        c.sq = G.sq;
        c.fi = G.fi;
      }
    }
    c.lsq = ilog2(c.sq);
    c.slot = tid >= a.n_groups ? 0
             : c.fi ? (c.sq + 1) * (c.sq + 1)
                    : 2 * (4 * c.sq + 10) + (c.sq <= 32 ? c.sq * c.sq : 0);
    s_g[tid] = c;
  }
  __syncthreads();
  // the last warp keeps the row ranges of the current wave and of the next
  // one (loaded a wave ahead) in its lanes, one a group, and builds each
  // chunk during the phase 1 before it (where few jobs leave it idle)
  constexpr int kPlanner = kWaveWarps - 1;
  int clo = 0, ccnt = 0, nlo = 0, nhi = 0;
  if (warp == kPlanner) {
    int hi;
    wave_rows_of(a, 0, t, lane, clo, hi);
    ccnt = hi - clo;
    wave_rows_of(a, 1, t, lane, nlo, nhi);
    build_chunk(s_chunk[0], 0, 0, clo, ccnt, s_g, lane);
  }
  __syncthreads();
  for (int cb = 0;; cb ^= 1) {
    const Chunk& C = s_chunk[cb];
    const int w = C.w;
    if (w >= a.n_waves) break;
    if (warp == kPlanner) {
      // the next chunk, of this wave or the next; the next wave's tables
      // asked of L2
      const int c1 = C.c0 + C.njobs;
      if (c1 < C.total) {
        build_chunk(s_chunk[cb ^ 1], w, c1, clo, ccnt, s_g, lane);
      } else {
        prefetch_rows(s_g, nlo, nhi - nlo, lane);
        clo = nlo;
        ccnt = nhi - nlo;
        wave_rows_of(a, w + 2, t, lane, nlo, nhi);
        build_chunk(s_chunk[cb ^ 1], w + 1, 0, clo, ccnt, s_g, lane);
      }
    }
    // the residuals of this thread's first quad of samples, in flight
    // during phase 1
    int4 rv;
    int rg = -1, rk, rs;
    if (4 * tid < C.samples) rv = __ldg(locate(C, s_g, 4 * tid, rg, rk, rs));
    // phase 1: a warp a job
    for (int k = warp; k < C.njobs; k += kWaveWarps) {
      const int g = group_at(C.jbase, k);
      const GroupC& G = s_g[g];
      const int j = k - C.jbase[g];
      int* slot = pool + C.obase[g] + j * G.slot;
      int* rec = recs + k * kRec;
      const JobLoads L = load_job(G, C.row0[g] + j, lane);
      if (G.fi)
        prep_fi(a, G, L, rec, slot, lane);
      else
        prep_normal(a, G, L, rec, slot, scratch + warp * kScratch, lane);
      if (lane == 0) rec[kRSlot] = C.obase[g] + j * G.slot;
      __syncwarp();
    }
    __syncthreads();
    // phase 2: the block over every quad of samples of the chunk's jobs
    for (int i = 4 * tid; i < C.samples; i += 4 * kWaveThreads) {
      if (i > 4 * tid) rv = __ldg(locate(C, s_g, i, rg, rk, rs));
      const GroupC& G = s_g[rg];
      const int* rec = recs + rk * kRec;
      put_quad(a, G.sq, G.lsq, rec, pool + rec[kRSlot], rs, rv);
    }
    __syncthreads();
  }
}

// The chain bound's probe: per step one table load (its address from the
// last gather), one gather at the loaded index, one store and the barrier.
// tab[t] = 2t; buf holds two words a picture, read and written in turns.
__global__ void __launch_bounds__(kWaveThreads, 1)
av1_wave_probe_kernel(const int32_t* tab, int32_t* buf, int steps) {
  const int t = blockIdx.x;
  int v = 0;
  for (int w = 0; w < steps; ++w) {
    const int i = __ldg(tab + t + v - w) + (w & 1);
    const int g = buf[i];
    if (threadIdx.x == 0) buf[i ^ 1] = g + 1;
    __syncthreads();
    v = g + 1;
  }
}

}  // namespace

extern "C" {

// groups: n_groups rows of 6 values (coeffs, txp, order, out addresses;
// jobs, sq)
int launch_av1_dequant_itx(const long long* groups, int n_groups, int jobs,
                           int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_groups < 1 || n_groups > kMaxGroups || jobs < 0) return kInvalid;
  ItxArgs a{};
  a.n_groups = n_groups;
  long long total = 0, blocks = 0;
  for (int k = 0; k < n_groups; ++k) {
    const long long* v = groups + 6 * k;
    ItxGroup& g = a.g[k];
    g.coeffs = reinterpret_cast<const int32_t*>(v[0]);
    g.txp = reinterpret_cast<const int32_t*>(v[1]);
    g.order = reinterpret_cast<const int32_t*>(v[2]);
    g.out = reinterpret_cast<int32_t*>(v[3]);
    g.n = static_cast<int>(v[4]);
    g.sq = static_cast<int>(v[5]);
    if (v[4] < 0 || v[4] > (1LL << 30) ||
        (g.sq != 4 && g.sq != 8 && g.sq != 16 && g.sq != 32 && g.sq != 64) ||
        v[0] % 16 != 0 || v[1] % 16 != 0 || v[3] % 16 != 0 ||  // vectors
        (v[4] > 0 && v[2] == 0))
      return kInvalid;
    g.first_block = static_cast<int>(blocks);
    const int per_block = g.sq == 64 ? 1 : kItxThreads / g.sq;   // jobs
    blocks += (v[4] + per_block - 1) / per_block;
    total += v[4];
  }
  if (total != jobs || blocks > (1LL << 31) - 1) return kInvalid;
  if (blocks == 0) return 0;
  av1_dequant_itx_kernel<<<static_cast<unsigned>(blocks), kItxThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// groups: n_groups rows of 7 values (above, left, corner, params, res
// addresses; sq, filter-intra flag); rows: (n_groups, n_waves,
// pictures + 1) int32; buf: the flat sample buffer, trash its last index
int launch_av1_intra_wave(const long long* groups, int n_groups,
                          const void* rows, int n_waves, int pictures,
                          void* buf, int trash, int bd, int edge, int ssx,
                          int ssy, int lh, int lw, int device,
                          void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_groups < 1 || n_groups > kMaxGroups || bd < 8 || bd > 12 ||
      n_waves < 1 || pictures < 1 || pictures > (1 << 24) || trash < 0)
    return kInvalid;
  WaveArgs a{};
  a.rows = static_cast<const int32_t*>(rows);
  a.buf = static_cast<int32_t*>(buf);
  a.n_groups = n_groups;
  a.n_waves = n_waves;
  a.pictures = pictures;
  a.trash = trash;
  a.bd = bd;
  a.edge = edge;
  a.ssx = ssx;
  a.ssy = ssy;
  a.lh = lh;
  a.lw = lw;
  for (int k = 0; k < n_groups; ++k) {
    const long long* v = groups + 7 * k;
    WaveGroup& g = a.g[k];
    g.above = reinterpret_cast<const int32_t*>(v[0]);
    g.left = reinterpret_cast<const int32_t*>(v[1]);
    g.corner = reinterpret_cast<const int32_t*>(v[2]);
    g.params = reinterpret_cast<const int32_t*>(v[3]);
    g.res = reinterpret_cast<const int32_t*>(v[4]);
    g.sq = static_cast<int>(v[5]);
    g.fi = static_cast<int>(v[6]);
    if ((g.sq != 4 && g.sq != 8 && g.sq != 16 && g.sq != 32 && g.sq != 64) ||
        v[4] % 16 != 0)    // residuals read as 16-byte vectors
      return kInvalid;
    if (g.fi && g.sq > 32) return kInvalid;
  }
  e = cudaFuncSetAttribute(av1_intra_wave_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kDynBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  av1_intra_wave_kernel<<<pictures, kWaveThreads, kDynBytes,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the probe of av1_intra_wave's chain bound: `steps` steps with the wave
// kernel's launch shape; tab holds `pictures` words (tab[t] = 2t), buf
// 2 * pictures zeros
int launch_av1_wave_probe(const void* tab, void* buf, int pictures,
                          int steps, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (pictures < 1 || steps < 0) return kInvalid;
  av1_wave_probe_kernel<<<pictures, kWaveThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tab), static_cast<int32_t*>(buf), steps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
