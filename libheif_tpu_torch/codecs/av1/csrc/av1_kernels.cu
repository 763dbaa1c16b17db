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
// Design (a simple, correct first version):
//
// * av1_dequant_itx: one block of 64 threads a transform block.  The block
//   dequantises into shared memory (rows padded to 65 words), then each
//   thread transforms one row and, after a barrier, one column in
//   registers and local memory with the butterflies of itx.py, the cosine
//   constants compile-time tables.  All arithmetic is the jnp program's
//   int32: products are formed in uint32 and wrap as XLA's do.  One launch
//   for all groups: a block finds its group in a small by-value table.
//
// * av1_intra_wave: a job reads samples of its own picture written by
//   earlier waves only, so one persistent launch gives each picture one
//   block of 8 warps, which walks the picture's waves in order with
//   __syncthreads() between waves (the design of hevc_intra_wave since
//   it became one launch a plan).  A warp takes one job at a time: it
//   resolves the sentinel-coded gather indices into its slice of shared
//   memory, runs the edge filter and upsampling of directional modes
//   there, or the serial 4x2 patch chain of filter intra, then predicts,
//   adds CfL's scaled luma AC, adds the residual, clips and stores its
//   samples.  The sample buffer is written during the launch, so it is
//   never read through the non-coherent path (__ldg).
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

// ---------------------------------------------------------- 1-D transforms
// Each takes x[0..n) and writes y[0..n); x and y do not alias.

__device__ void idct4(const int* x, int* y) {
  const int s0 = btf(C(32), x[0], C(32), x[2]);
  const int s1 = btf(C(32), x[0], -C(32), x[2]);
  const int s2 = btf(C(48), x[1], -C(16), x[3]);
  const int s3 = btf(C(16), x[1], C(48), x[3]);
  y[0] = addw(s0, s3);
  y[1] = addw(s1, s2);
  y[2] = subw(s1, s2);
  y[3] = subw(s0, s3);
}

__device__ void idct8(const int* x, int* y) {
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
  for (int i = 0; i < 4; ++i) {
    y[i] = addw(e[i], o[3 - i]);
    y[7 - i] = subw(e[i], o[3 - i]);
  }
}

__device__ void idct16(const int* x, int* y) {
  int xe[8], e[8];
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
  for (int i = 0; i < 8; ++i) {
    y[i] = addw(e[i], o[7 - i]);
    y[8 + i] = subw(e[7 - i], o[i]);
  }
}

__device__ void idct32(const int* x, int* y) {
  int xe[16], e[16], xo[16];
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
  for (int i = 0; i < 4; ++i) {
    a[i] = addw(w[i], w[7 - i]);
    a[7 - i] = subw(w[i], w[7 - i]);
    a[8 + i] = subw(w[15 - i], w[8 + i]);
    a[15 - i] = addw(w[15 - i], w[8 + i]);
  }
  // stage 7
  for (int i = 0; i < 16; ++i) b[i] = a[i];
  for (int i = 4; i < 8; ++i) {
    b[i] = btf(-C(32), a[i], C(32), a[15 - i]);
    b[15 - i] = btf(C(32), a[i], C(32), a[15 - i]);
  }
  for (int i = 0; i < 16; ++i) {
    y[i] = addw(e[i], b[15 - i]);
    y[16 + i] = subw(e[15 - i], b[i]);
  }
}

__device__ __forceinline__ int brev(int nbits, int v) {
  int out = 0;
  for (int i = 0; i < nbits; ++i) out |= ((v >> i) & 1) << (nbits - 1 - i);
  return out;
}

__device__ void idct64(const int* x, int* y) {
  int e[32];
  {
    int xe[32];
    for (int i = 0; i < 32; ++i) xe[i] = x[2 * i];
    idct32(xe, e);
  }
  int s[32], t[32], u[32];
  for (int j = 0; j < 16; ++j) {
    const int a = brev(6, 32 + j);
    const int xi = x[a], xj = x[64 - a];
    s[j] = btf(C(64 - a), xi, -C(a), xj);
    s[31 - j] = btf(C(a), xi, C(64 - a), xj);
  }
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
  for (int i = 0; i < 32; ++i) u[i] = t[i];
  for (int k = 0; k < 8; ++k) {
    const int b = 4 * brev(4, 8 + k);
    const int i0 = 4 * k + 1, i1 = 4 * k + 2;
    const int j0 = 30 - 4 * k, j1 = 29 - 4 * k;
    u[i0] = btf(C(b), t[i0], -C(64 - b), t[j0]);
    u[j0] = btf(-C(64 - b), t[i0], -C(b), t[j0]);
    u[i1] = btf(C(64 - b), t[i1], C(b), t[j1]);
    u[j1] = btf(C(b), t[i1], -C(64 - b), t[j1]);
  }
  // stage 4 (into s)
  for (int g = 0; g < 8; ++g) {
    const int o = 4 * g;
    if (g % 2 == 0) {
      s[o] = addw(u[o], u[o + 3]);
      s[o + 3] = subw(u[o], u[o + 3]);
      s[o + 1] = addw(u[o + 1], u[o + 2]);
      s[o + 2] = subw(u[o + 1], u[o + 2]);
    } else {
      s[o + 3] = addw(u[o + 3], u[o]);
      s[o] = subw(u[o + 3], u[o]);
      s[o + 2] = addw(u[o + 2], u[o + 1]);
      s[o + 1] = subw(u[o + 2], u[o + 1]);
    }
  }
  // stage 5 (into t)
  for (int i = 0; i < 32; ++i) t[i] = s[i];
  {
    const int tab[8][4] = {{2, 29, 8, 0},  {3, 28, 8, 0},  {4, 27, 8, 1},
                           {5, 26, 8, 1},  {10, 21, 40, 0}, {11, 20, 40, 0},
                           {12, 19, 40, 1}, {13, 18, 40, 1}};
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
  for (int g = 0; g < 4; ++g) {
    const int o = 8 * g;
    for (int i = 0; i < 4; ++i) {
      const int lo = o + i, hi = o + 7 - i;
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
  for (int i = 0; i < 32; ++i) s[i] = u[i];
  for (int i = 4; i < 8; ++i) {
    const int j = 31 - i;
    s[i] = btf(-C(16), u[i], C(48), u[j]);
    s[j] = btf(C(48), u[i], C(16), u[j]);
  }
  for (int i = 8; i < 12; ++i) {
    const int j = 31 - i;
    s[i] = btf(-C(48), u[i], -C(16), u[j]);
    s[j] = btf(-C(16), u[i], C(48), u[j]);
  }
  // stage 8 (into t)
  for (int i = 0; i < 8; ++i) {
    const int lo = i, hi = 15 - i;
    t[lo] = addw(s[lo], s[hi]);
    t[hi] = subw(s[lo], s[hi]);
    const int lo2 = 16 + i, hi2 = 31 - i;
    t[hi2] = addw(s[hi2], s[lo2]);
    t[lo2] = subw(s[hi2], s[lo2]);
  }
  // stage 9 (into u)
  for (int i = 0; i < 32; ++i) u[i] = t[i];
  for (int i = 8; i < 16; ++i) {
    const int j = 31 - i;
    u[i] = btf(-C(32), t[i], C(32), t[j]);
    u[j] = btf(C(32), t[i], C(32), t[j]);
  }
  for (int i = 0; i < 32; ++i) {
    y[i] = addw(e[i], u[31 - i]);
    y[32 + i] = subw(e[31 - i], u[i]);
  }
}

__device__ void iadst4(const int* x, int* y) {
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

__device__ void iadst8(const int* x, int* y) {
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

__device__ void iadst16(const int* x, int* y) {
  const int b[16] = {x[15], x[0], x[13], x[2], x[11], x[4], x[9], x[6],
                     x[7],  x[8], x[5],  x[10], x[3], x[12], x[1], x[14]};
  int s[16], t[16], u[16], v[16], w[16], a[16], z[16];
  for (int k = 0; k < 8; ++k) {
    const int ang = 2 + 8 * k;
    s[2 * k] = btf(C(ang), b[2 * k], C(64 - ang), b[2 * k + 1]);
    s[2 * k + 1] = btf(C(64 - ang), b[2 * k], -C(ang), b[2 * k + 1]);
  }
  for (int i = 0; i < 8; ++i) {
    t[i] = addw(s[i], s[i + 8]);
    t[i + 8] = subw(s[i], s[i + 8]);
  }
  for (int i = 0; i < 8; ++i) u[i] = t[i];
  u[8] = btf(C(8), t[8], C(56), t[9]);
  u[9] = btf(C(56), t[8], -C(8), t[9]);
  u[10] = btf(C(40), t[10], C(24), t[11]);
  u[11] = btf(C(24), t[10], -C(40), t[11]);
  u[12] = btf(-C(56), t[12], C(8), t[13]);
  u[13] = btf(C(8), t[12], C(56), t[13]);
  u[14] = btf(-C(24), t[14], C(40), t[15]);
  u[15] = btf(C(40), t[14], C(24), t[15]);
  for (int i = 0; i < 4; ++i) {
    v[i] = addw(u[i], u[i + 4]);
    v[i + 4] = subw(u[i], u[i + 4]);
    v[8 + i] = addw(u[8 + i], u[12 + i]);
    v[12 + i] = subw(u[8 + i], u[12 + i]);
  }
  for (int h = 0; h < 16; h += 8) {
    w[h + 0] = v[h + 0]; w[h + 1] = v[h + 1];
    w[h + 2] = v[h + 2]; w[h + 3] = v[h + 3];
    w[h + 4] = btf(C(16), v[h + 4], C(48), v[h + 5]);
    w[h + 5] = btf(C(48), v[h + 4], -C(16), v[h + 5]);
    w[h + 6] = btf(-C(48), v[h + 6], C(16), v[h + 7]);
    w[h + 7] = btf(C(16), v[h + 6], C(48), v[h + 7]);
  }
  for (int o = 0; o < 16; o += 4) {
    a[o] = addw(w[o], w[o + 2]);
    a[o + 1] = addw(w[o + 1], w[o + 3]);
    a[o + 2] = subw(w[o], w[o + 2]);
    a[o + 3] = subw(w[o + 1], w[o + 3]);
  }
  for (int o = 0; o < 16; o += 4) {
    z[o] = a[o];
    z[o + 1] = a[o + 1];
    z[o + 2] = btf(C(32), a[o + 2], C(32), a[o + 3]);
    z[o + 3] = btf(C(32), a[o + 2], -C(32), a[o + 3]);
  }
  const int ord[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
  for (int i = 0; i < 16; ++i) y[i] = (i & 1) ? -z[ord[i]] : z[ord[i]];
}

// kind 0 DCT, 1 ADST, 2 identity (itx.py _txfm1d)
__device__ void txfm1d(int kind, int n, const int* x, int* y) {
  if (kind == 0) {
    switch (n) {
      case 4: idct4(x, y); return;
      case 8: idct8(x, y); return;
      case 16: idct16(x, y); return;
      case 32: idct32(x, y); return;
      default: idct64(x, y); return;
    }
  }
  if (kind == 1) {
    switch (n) {
      case 4: iadst4(x, y); return;
      case 8: iadst8(x, y); return;
      default: iadst16(x, y); return;
    }
  }
  for (int i = 0; i < n; ++i) {
    switch (n) {
      case 4: y[i] = round2(mulw(x[i], 5793), 12); break;
      case 8: y[i] = mulw(x[i], 2); break;
      case 16: y[i] = round2(mulw(mulw(x[i], 2), 5793), 12); break;
      default: y[i] = mulw(x[i], 4); break;
    }
  }
}

__device__ __forceinline__ int ilog2(int v) { return 31 - __clz(v); }

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

constexpr int kItxThreads = 64;
constexpr int kItxPitch = 65;

struct ItxGroup {
  const int32_t* coeffs;   // (n, cs, cs)
  const int32_t* txp;      // (n, 8)
  int32_t* out;            // (n, sq, sq)
  int n;
  int sq;
  int first;               // first job index of the group
};

struct ItxArgs {
  ItxGroup g[kMaxGroups];
  int n_groups;
};

__global__ void __launch_bounds__(kItxThreads)
av1_dequant_itx_kernel(const ItxArgs a) {
  __shared__ int s[64 * kItxPitch];
  const int job = blockIdx.x;
  int gi = 0;
  for (int k = 1; k < a.n_groups; ++k)
    if (job >= a.g[k].first) gi = k;
  const ItxGroup& G = a.g[gi];
  const long long r = job - G.first;
  const int sq = G.sq;
  const int cs = sq < 32 ? sq : 32;
  const int32_t* p = G.txp + r * 8;
  const int dcq = p[0], acq = p[1], tw = p[2], th = p[3], code = p[4],
            flags = p[5];
  int32_t* out = G.out + r * sq * sq;
  const int tid = threadIdx.x;
  if (!(flags & 1)) {
    for (int i = tid; i < sq * sq; i += kItxThreads) out[i] = 0;
    return;
  }
  const int32_t* cf = G.coeffs + r * cs * cs;
  const bool lossless = flags & 2;
  const int pels = tw * th;
  const int shift = (pels > 256) + (pels > 1024);
  const int lw = ilog2(tw), lh = ilog2(th);
  const bool rect2 = (lw - lh == 1) || (lh - lw == 1);
  for (int i = tid; i < tw * th; i += kItxThreads) {
    const int y = i / tw, x = i % tw;
    const int c = (y < 32 && x < 32) ? cf[y * cs + x] : 0;
    const int q = (y == 0 && x == 0) ? dcq : acq;
    int d;
    if (lossless) {
      d = mulw(c, q) >> 2;
    } else {
      const int ac = c < 0 ? -c : c;
      const int mag = (mulw(ac, q) & 0xFFFFFF) >> shift;
      d = c < 0 ? -mag : mag;
      if (rect2) d = round2(mulw(d, 2896), 12);
    }
    s[y * kItxPitch + x] = d;
  }
  __syncthreads();
  int xv[64], yv[64];
  const int vk = code & 3, hk = (code >> 2) & 3;
  const int ud = (code >> 4) & 1, lr = (code >> 5) & 1;
  if (tid < th) {            // row pass
    int* row = s + tid * kItxPitch;
    if (lossless) {
      for (int i = 0; i < 4; ++i) xv[i] = row[i];
      wht4(xv);
      for (int i = 0; i < 4; ++i) row[i] = xv[i];
    } else {
      for (int i = 0; i < tw; ++i) xv[i] = row[i];
      txfm1d(hk, tw, xv, yv);
      const int sh = row_shift(tw, th);
      for (int i = 0; i < tw; ++i) row[lr ? tw - 1 - i : i] = round2(yv[i], sh);
    }
  }
  __syncthreads();
  if (tid < tw) {            // column pass
    for (int i = 0; i < th; ++i) xv[i] = s[i * kItxPitch + tid];
    if (lossless) {
      wht4(xv);
      for (int i = 0; i < 4; ++i) yv[i] = xv[i];
    } else {
      txfm1d(vk, th, xv, yv);
      for (int i = 0; i < th; ++i) yv[i] = round2(yv[i], 4);
    }
    for (int i = 0; i < th; ++i)
      s[(ud && !lossless ? th - 1 - i : i) * kItxPitch + tid] = yv[i];
  }
  __syncthreads();
  for (int i = tid; i < sq * sq; i += kItxThreads) {
    const int y = i / sq, x = i % sq;
    out[i] = (y < th && x < tw) ? s[y * kItxPitch + x] : 0;
  }
}

// -------------------------------------------------------- av1_intra_wave

constexpr int kWaveWarps = 8;
// per-warp shared words: directional edges (4 x (2*64+8)) and their
// upsampled forms (2 x (4*64+10)), or the (32+1)^2 filter-intra patch
// buffer
constexpr int kEdge = 2 * 64 + 8;
constexpr int kUp = 4 * 64 + 10;
constexpr int kWarpSmem =
    4 * kEdge + 2 * kUp > 33 * 33 ? 4 * kEdge + 2 * kUp : 33 * 33;

// PARAM_COLS of cuda_fast.py
enum {
  kPMode, kPWv, kPHv, kPAngle, kPDx, kPDy, kPUpsA, kPUpsL, kPStrA, kPStrL,
  kPNaF, kPNlF, kPCornerF, kPHaveAbove, kPHaveLeft, kPIsCfl, kPCflAlpha,
  kPFiMode, kPDst, kPPw, kPHh, kPWw, kPLy, kPLx, kPBh, kPBw, kPLbase,
  kNParams
};
enum { kDcPred = 0, kSmoothPred = 9, kSmoothVPred = 10, kSmoothHPred = 11,
       kPaethPred = 12 };

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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int warp_sum(int v) {
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

// the upsampled (or edge-padded) reference line of one side from its
// filtered edge f[0..EL) (device_recon.py :715-747)
__device__ void build_line(const int* f, int* ub, int EL, int UL, int sq,
                           int ups, int n_up, int maxv, int lane) {
  const int ns = 2 * sq + 4;
  const int n1 = n_up - 1 > 0 ? n_up - 1 : 0;
  auto sv = [&](int m) {
    m = clampi(m, 0, ns - 1);
    if (m < 2) return f[0];
    return f[clampi(min(m - 2, n1), 0, EL - 2) + 1];
  };
  for (int pos = lane; pos < UL; pos += 32) {
    int v;
    if (!ups) {
      v = f[min(pos, EL - 1)];
    } else {
      const int kq = (pos - 2) >> 1;
      if (pos > 2 + 2 * n1) {
        v = sv(n1 + 2);
      } else if ((pos & 1) == 0) {
        v = sv(min(kq, n1) + 2);
      } else {
        const int km = min(kq, n1 - 1);
        const int raw = -sv(km + 1) + 9 * sv(km + 2) + 9 * sv(km + 3) -
                        sv(km + 4);
        v = clampi(round2(raw, 4), 0, maxv);
      }
    }
    ub[pos] = v;
  }
}

// one normal (non filter-intra) job, the whole warp
__device__ void predict_normal_job(const WaveArgs& a, const WaveGroup& G,
                                   long long row, int* sm, int lane) {
  const int sq = G.sq;
  const int* P = G.params + row * kNParams;
  const int mode = P[kPMode], wv = P[kPWv], hv = P[kPHv];
  const int ha = P[kPHaveAbove], hl = P[kPHaveLeft];
  const int maxv = (1 << a.bd) - 1, base = 1 << (a.bd - 1);
  const int L2 = 2 * sq + 7, EL = L2 + 1, UL = 4 * sq + 10;
  int* ea = sm;              // corner, then the above references
  int* el = sm + kEdge;      // corner, then the left references
  int* fa = sm + 2 * kEdge;
  int* fl = sm + 3 * kEdge;
  int* ua = sm + 4 * kEdge;
  int* ul = ua + kUp;
  const int* ai = G.above + row * L2;
  const int* li = G.left + row * L2;
  const int corner = refval(a, G.corner[row]);
  int sa = 0, sl = 0;
  for (int i = lane; i < L2; i += 32) {
    const int va = refval(a, ai[i]), vl = refval(a, li[i]);
    ea[1 + i] = va;
    el[1 + i] = vl;
    if (i < wv) sa += va;
    if (i < hv) sl += vl;
  }
  if (lane == 0) ea[0] = el[0] = corner;
  sa = warp_sum(sa);
  sl = warp_sum(sl);
  __syncwarp();
  const int lgw = ilog2(wv), lgh = ilog2(hv);
  int dc;
  if (ha && hl)
    dc = (sa + sl + ((wv + hv) >> 1)) / (wv + hv);
  else if (ha)
    dc = (sa + (1 << (lgw > 0 ? lgw - 1 : 0))) >> lgw;
  else if (hl)
    dc = (sl + (1 << (lgh > 0 ? lgh - 1 : 0))) >> lgh;
  else
    dc = base;
  const bool directional = !(mode == kDcPred || mode == kPaethPred ||
                             mode == kSmoothPred || mode == kSmoothVPred ||
                             mode == kSmoothHPred);
  const int pa = P[kPAngle];
  const int upa = P[kPUpsA], upl = P[kPUpsL];
  if (directional) {
    if (a.edge) {
      if (P[kPCornerF]) {
        const int sC = round2(5 * ea[1] + 6 * corner + 5 * el[1], 4);
        __syncwarp();
        if (lane == 0) ea[0] = el[0] = sC;
        __syncwarp();
      }
      const int na = P[kPNaF], nl = P[kPNlF];
      const int str_a = P[kPStrA], str_l = P[kPStrL];
      for (int i = lane; i < EL; i += 32) {
        int acc_a = 0, acc_l = 0;
        for (int j = 0; j < 5; ++j) {
          acc_a += kEdgeK[clampi(str_a, 0, 3)][j] *
                   ea[min(max(i - 2 + j, 0), max(na - 1, 0))];
          acc_l += kEdgeK[clampi(str_l, 0, 3)][j] *
                   el[min(max(i - 2 + j, 0), max(nl - 1, 0))];
        }
        fa[i] = (str_a > 0 && i >= 1 && i < na) ? (acc_a + 8) >> 4 : ea[i];
        fl[i] = (str_l > 0 && i >= 1 && i < nl) ? (acc_l + 8) >> 4 : el[i];
      }
    } else {
      for (int i = lane; i < EL; i += 32) {
        fa[i] = ea[i];
        fl[i] = el[i];
      }
    }
    __syncwarp();
    build_line(fa, ua, EL, UL, sq, upa, pa < 90 ? wv + hv : wv, maxv, lane);
    build_line(fl, ul, EL, UL, sq, upl, pa > 180 ? wv + hv : hv, maxv, lane);
    __syncwarp();
  }
  // CfL: the job's Q3 luma average (device_recon.py :826-848)
  const int is_cfl = P[kPIsCfl];
  // box members 4 (4:2:0), 2 (4:2:2) or 1 (4:4:4), Q3 shift to match
  const int nm = (a.ssx && a.ssy) ? 4 : (a.ssx ? 2 : 1);
  const int q3s = nm == 4 ? 1 : (nm == 2 ? 2 : 3);
  const int sy_ = a.ssy ? 2 : 1, sx_ = a.ssx ? 2 : 1;
  int avg = 0;
  const int ly = P[kPLy], lx = P[kPLx], bh = P[kPBh], bw = P[kPBw];
  const long long lbase = P[kPLbase];
  auto q3_at = [&](int y, int x) {
    const int r = min(y, max(bh - 1, 0)), c = min(x, max(bw - 1, 0));
    int s = 0;
    for (int m = 0; m < nm; ++m) {
      const int dy = (nm == 4) ? (m >> 1) : 0;
      const int dx = (nm == 4) ? (m & 1) : (nm == 2 ? m : 0);
      const int gy = min(ly + r * sy_ + dy, a.lh - 1);
      const int gx = min(lx + c * sx_ + dx, a.lw - 1);
      s += a.buf[lbase + static_cast<long long>(gy) * a.lw + gx];
    }
    return s << q3s;
  };
  if (is_cfl) {
    int tot = 0;
    for (int i = lane; i < wv * hv; i += 32) tot += q3_at(i / wv, i % wv);
    tot = warp_sum(tot);
    avg = (tot + (1 << (lgw + lgh - 1))) >> (lgw + lgh);
  }
  const int hh = P[kPHh], ww = P[kPWw], pw = P[kPPw];
  const long long dst = P[kPDst];
  const int* res = G.res + row * sq * sq;
  const int dxv = P[kPDx], dyv = P[kPDy];
  const int aoff = upa ? 2 : 1, loff = upl ? 2 : 1;
  const int smo_w = wv - 4, smo_h = hv - 4;   // kSm offset of a size
  for (int s = lane; s < hh * ww; s += 32) {
    const int y = s / ww, x = s % ww;
    int pred;
    if (mode == kDcPred) {
      pred = dc;
    } else if (mode == kPaethPred) {
      const int t = ea[1 + x], l = el[1 + y];
      const int pb = t + l - corner;
      const int pl = abs(pb - l), pt = abs(pb - t), ptl = abs(pb - corner);
      pred = (pl <= pt && pl <= ptl) ? l : (pt <= ptl ? t : corner);
    } else if (!directional) {
      const int wvert = kSm[clampi(smo_h + min(y, hv - 1), 0, 123)];
      const int whorz = kSm[clampi(smo_w + min(x, wv - 1), 0, 123)];
      const int t = ea[1 + x], l = el[1 + y];
      const int below = el[hv], right = ea[wv];
      const int sv = wvert * t + (256 - wvert) * below;
      const int sh = whorz * l + (256 - whorz) * right;
      pred = mode == kSmoothPred ? round2(sv + sh, 9)
                                 : (mode == kSmoothVPred ? round2(sv, 8)
                                                         : round2(sh, 8));
    } else {
      auto at = [&](const int* ub, int i) { return ub[clampi(i, 0, UL - 1)]; };
      auto interp = [&](const int* ub, int i, int sh) {
        return round2(at(ub, i) * (32 - sh) + at(ub, i + 1) * sh, 5);
      };
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
      pred = clampi(v, 0, maxv);
    }
    if (is_cfl) {
      const int scaled = P[kPCflAlpha] * (q3_at(y, x) - avg);
      const int adj = scaled >= 0 ? (scaled + 32) >> 6 : -((-scaled + 32) >> 6);
      pred = clampi(pred + adj, 0, maxv);
    }
    a.buf[dst + static_cast<long long>(y) * pw + x] =
        clampi(pred + res[y * sq + x], 0, maxv);
  }
}

// one filter-intra job (device_recon.py :850-881), the whole warp: the
// 4x2 patches in raster order, lanes 0..7 one output each
__device__ void predict_fi_job(const WaveArgs& a, const WaveGroup& G,
                               long long row, int* pb, int lane) {
  const int sq = G.sq, n = sq + 1;
  const int* P = G.params + row * kNParams;
  const int maxv = (1 << a.bd) - 1;
  const int mode = clampi(P[kPFiMode], 0, 4);
  for (int i = lane; i < sq; i += 32) {
    pb[1 + i] = refval(a, G.above[row * sq + i]);
    pb[(1 + i) * n] = refval(a, G.left[row * sq + i]);
  }
  if (lane == 0) pb[0] = refval(a, G.corner[row]);
  __syncwarp();
  const int n_pc = sq / 4;
  for (int p = 0; p < (sq / 2) * n_pc; ++p) {
    const int r = 1 + 2 * (p / n_pc), c = 1 + 4 * (p % n_pc);
    int v = 0;
    if (lane < 8) {
      const int* t = kFiTaps[mode][lane];
      for (int j = 0; j < 5; ++j) v += t[j] * pb[(r - 1) * n + c - 1 + j];
      v += t[5] * pb[r * n + c - 1] + t[6] * pb[(r + 1) * n + c - 1];
      v = v >= 0 ? (v + 8) >> 4 : -((-v + 8) >> 4);
      v = clampi(v, 0, maxv);
    }
    __syncwarp();
    if (lane < 8) pb[(r + (lane >> 2)) * n + c + (lane & 3)] = v;
    __syncwarp();
  }
  const int hh = P[kPHh], ww = P[kPWw], pw = P[kPPw];
  const long long dst = P[kPDst];
  const int* res = G.res + row * sq * sq;
  for (int s = lane; s < hh * ww; s += 32) {
    const int y = s / ww, x = s % ww;
    a.buf[dst + static_cast<long long>(y) * pw + x] =
        clampi(pb[(1 + y) * n + 1 + x] + res[y * sq + x], 0, maxv);
  }
  __syncwarp();
}

struct Wave {
  int lo, cnt, incl, total;
};

// lane g < n_groups: the rows [lo, lo + cnt) of group g; incl the
// inclusive prefix sum of the counts, total the wave's job count
__device__ __forceinline__ Wave wave_of(int lo, int hi) {
  const int lane = threadIdx.x & 31;
  Wave v;
  v.lo = lo;
  v.cnt = hi - lo;
  v.incl = v.cnt;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v.incl, o);
    if (lane >= o) v.incl += u;
  }
  v.total = __shfl_sync(0xffffffffu, v.incl, 31);
  return v;
}

// One block a picture, walking its waves in order.
__global__ void __launch_bounds__(kWaveWarps * 32, 1)
av1_intra_wave_kernel(const WaveArgs a) {
  __shared__ int s_mem[kWaveWarps][kWarpSmem];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x;
  const long long stride = a.pictures + 1;
  for (int w = 0; w < a.n_waves; ++w) {
    int lo = 0, hi = 0;
    if (lane < a.n_groups) {
      const int32_t* r = a.rows + (static_cast<long long>(lane) * a.n_waves
                                   + w) * stride + t;
      lo = r[0];
      hi = r[1];
    }
    const Wave cur = wave_of(lo, hi);
    for (int i = warp; i < cur.total; i += kWaveWarps) {
      const int g = __ffs(__ballot_sync(0xffffffffu, cur.incl > i)) - 1;
      const long long row = __shfl_sync(0xffffffffu, cur.lo, g) + i -
                            (__shfl_sync(0xffffffffu, cur.incl, g) -
                             __shfl_sync(0xffffffffu, cur.cnt, g));
      const WaveGroup& G = a.g[g];
      if (G.fi)
        predict_fi_job(a, G, row, s_mem[warp], lane);
      else
        predict_normal_job(a, G, row, s_mem[warp], lane);
      __syncwarp();
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// groups: n_groups rows of 5 values (coeffs, txp, out addresses; jobs, sq)
int launch_av1_dequant_itx(const long long* groups, int n_groups, int jobs,
                           int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_groups < 1 || n_groups > kMaxGroups || jobs < 0) return kInvalid;
  ItxArgs a{};
  a.n_groups = n_groups;
  long long first = 0;
  for (int k = 0; k < n_groups; ++k) {
    const long long* v = groups + 5 * k;
    ItxGroup& g = a.g[k];
    g.coeffs = reinterpret_cast<const int32_t*>(v[0]);
    g.txp = reinterpret_cast<const int32_t*>(v[1]);
    g.out = reinterpret_cast<int32_t*>(v[2]);
    g.n = static_cast<int>(v[3]);
    g.sq = static_cast<int>(v[4]);
    g.first = static_cast<int>(first);
    if (v[3] < 0 || (g.sq != 4 && g.sq != 8 && g.sq != 16 && g.sq != 32 &&
                     g.sq != 64))
      return kInvalid;
    first += v[3];
  }
  if (first != jobs || first > (1LL << 31) - 1) return kInvalid;
  if (jobs == 0) return 0;
  // groups without jobs never own a block: move their start past the end
  for (int k = 0; k < n_groups; ++k)
    if (a.g[k].n == 0) a.g[k].first = jobs + 1;
  av1_dequant_itx_kernel<<<static_cast<unsigned>(jobs), kItxThreads, 0,
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
    if (g.sq != 4 && g.sq != 8 && g.sq != 16 && g.sq != 32 && g.sq != 64)
      return kInvalid;
    if (g.fi && g.sq > 32) return kInvalid;
  }
  av1_intra_wave_kernel<<<pictures, kWaveWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
