// Hand-written Hopper (sm_90a) kernels of the HEVC intra reconstruction.
//
// The JAX package reconstructs HEVC intra pictures with one jnp program
// (libheif_tpu/codecs/hevc/device_recon.py, _build_program :519-982); it
// has no Pallas kernel.  Two of its four stages are kernels here, each one
// launch for a whole plan (a batch of pictures):
//
//   hevc_dequant_itx  <- stage A, residuals (:540-567): dequantise, the
//                        column and row passes of the inverse DCT/DST,
//                        transform skip, bypass; every TU group
//   hevc_intra_wave   <- stage B, the lax.scan over waves (:890-927) with
//                        predict (:571-698) and the scatter into the flat
//                        sample buffers; every wave of every picture
//
//   hevc_inter_pred   <- no TPU kernel: the JAX package's host numpy motion
//                        compensation of P and B pictures (recon.py
//                        :78-166, :405-436); every PU of a picture
//
// Stages C and D (deblocking, SAO) stay plain PyTorch.
//
// What bounds them on an H100, and what the design does about it:
//
// * hevc_dequant_itx reads the coefficient levels and writes the residuals,
//   4 + 4 bytes per sample: device-memory bytes bound it.  A warp takes 32
//   rows of TUs (eight 4x4 TUs, four 8x8, two 16x16 or one 32x32): it loads
//   them as 16-byte vectors, consecutive lanes on consecutive addresses,
//   dequantises them into shared memory (rows padded to S+1 words, so the
//   column and the row reads are free of bank conflicts), then each lane
//   transforms one column and, after a __syncwarp, one row in registers
//   with HEVC's even/odd partial butterfly (HM's partialButterflyInverse),
//   the coefficients compile-time constants, and the warp stores the rows
//   as 16-byte vectors.  No block-wide barrier, no matrix in memory, and one
//   launch for all groups: a block finds its group in a small table.  A TU
//   of slot 0 (flat scaling) keeps the jnp program's int32 arithmetic: the
//   dequantise product wraps as XLA's does.  A TU whose picture has
//   scaling lists reads its factors m[y][x] from its slot of the plan's
//   (slots, 32, 32) byte table through the read-only path (four factors a
//   32-bit load, beside its 16-byte coefficient vector) and forms
//   c*m*levelScale<<(qp/6) in 64 bits, as the JAX Python engine does: up
//   to 2^15 * 255 * 72 * 2^12, about 2^41.  A plan without lists launches
//   the flat instantiation, which reads no slot and keeps the registers
//   of a kernel that knows no lists (one kernel for both cost the flat
//   plan 8-12% on the H100: 64, then 80 registers).  The butterfly adds
//   the same products as the matrix product, every partial sum below
//   2^31.
//
// * hevc_intra_wave is bound by the chain of dependent waves, not by bytes:
//   a TU can only be predicted after the TUs its reference samples come
//   from, about 340 waves for a 512x512 picture.  A TU only reads samples of
//   its own picture, so the pictures of a batch are independent: one
//   persistent launch gives each picture one block of 32 warps, which
//   walks the picture's waves in order with __syncthreads() between waves
//   and no launch between them (on the H100 one block a picture beat a
//   cluster of two or four: a cluster barrier step costs ~1.3 us against
//   ~50 ns for __syncthreads).  A wave of a 512x512 picture holds about 23 TUs, so each
//   warp takes about one TU a wave, and a wave lasts about one TU's
//   latency: the warp issues all its table loads at once (mode, reference
//   indices and availability, residuals and scatter indices in
//   registers), gathers the 4n+1 reference samples into registers,
//   substitutes the missing ones with ballots and shuffles, filters them
//   in shared memory, builds the angular modes' projected reference line
//   once, and predicts and reconstructs n*n/32 samples a lane.  The rows
//   of a (group, wave, picture) come from a (G, waves, T+1) table of
//   starts, read a wave ahead.  The sample buffers are written during the
//   launch, so they are never read through the non-coherent path.
//
// hevc_wave_probe, a measurement probe off the decode path, has the wave
// kernel's launch shape and does per step one store, the same barrier and
// one dependent load of the stored word: n_waves of its steps are the
// in-kernel chain bound of hevc_intra_wave.
//
// Every entry point takes the CUDA device index and stream last and returns
// the cudaError_t of its launch; it allocates nothing and does not
// synchronise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
constexpr int kMaxGroups = 7;

// dequantisation scale per qp % 6 (spec 8.6.2, levelScale)
__constant__ int kLevelScale[6] = {40, 45, 51, 57, 64, 72};

// intraPredAngle per mode 0..34 (spec Table 8-5; 0 for planar and DC)
__constant__ int kIntraAngle[35] = {
    0,   0,   32,  26,  21,  17,  13,  9,   5,   2,   0,   -2,
    -5,  -9,  -13, -17, -21, -26, -32, -26, -21, -17, -13, -9,
    -5,  -2,  0,   2,   5,   9,   13,  17,  21,  26,  32};

// invAngle per mode (spec Table 8-6; 0 where the angle is not negative)
__constant__ int kInvAngle[35] = {
    0,    0,    0,    0,    0,    0,    0,    0,    0,    0,    0,    -4096,
    -1638, -910, -630, -482, -390, -315, -256, -315, -390, -482, -630, -910,
    -1638, -4096, 0,   0,    0,    0,    0,    0,    0,    0,    0};

__device__ __forceinline__ int clip16(int v) {
  return min(max(v, -32768), 32767);
}

// ------------------------------------------------------- hevc_dequant_itx

constexpr int kItxWarps = 8;
constexpr int kItxThreads = kItxWarps * 32;

// Entry (r, j) of HEVC's 32-point DCT matrix (spec 8.6.4.2, transMatrix):
// 64*sqrt(2)*cos(pi*(2j+1)*r/64) as the spec rounds it, by the symmetry of
// the cosine from its first column.  The S-point matrix is rows r*32/S.
__host__ __device__ constexpr int dct32(int r, int j) {
  constexpr int c[33] = {64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80,
                         78, 75, 73, 70, 67, 64, 61, 57, 54, 50, 46,
                         43, 38, 36, 31, 25, 22, 18, 13, 9,  4,  0};
  const int a = ((2 * j + 1) * r) & 127;
  return a <= 32 ? c[a] : a <= 64 ? -c[64 - a] : a <= 96 ? -c[a - 64]
                                                         : c[128 - a];
}

// y[j] = sum_i m[i][j] x[i] for the S-point DCT matrix m: the even rows are
// the S/2-point transform of the even inputs, and the odd rows give the odd
// part, added to the first half and subtracted from the mirrored second
// half (HM's partialButterflyInverse4/8/16/32).
template <int S>
__device__ __forceinline__ void idct(const int* x, int* y) {
  if constexpr (S == 1) {
    y[0] = 64 * x[0];
  } else {
    int xe[S / 2], e[S / 2];
#pragma unroll
    for (int i = 0; i < S / 2; ++i) xe[i] = x[2 * i];
    idct<S / 2>(xe, e);
#pragma unroll
    for (int j = 0; j < S / 2; ++j) {
      int o = 0;
#pragma unroll
      for (int i = 1; i < S; i += 2) o += dct32(i * (32 / S), j) * x[i];
      y[j] = e[j] + o;
      y[S - 1 - j] = e[j] - o;
    }
  }
}

// the 4x4 DST-VII of luma intra TUs (spec 8.6.4.2, eq. 8-315), as its
// product: y[j] = sum_i m[i][j] x[i]
__device__ __forceinline__ void idst4(const int* x, int* y) {
  y[0] = 29 * x[0] + 74 * x[1] + 84 * x[2] + 55 * x[3];
  y[1] = 55 * x[0] + 74 * x[1] - 29 * x[2] - 84 * x[3];
  y[2] = 74 * x[0] - 74 * x[2] + 74 * x[3];
  y[3] = 84 * x[0] - 74 * x[1] + 55 * x[2] - 29 * x[3];
}

constexpr int kMtabSide = 32;   // a scaling-factor slot: (32, 32) bytes

struct ItxGroup {
  const int32_t* coeffs;  // (n, S, S) levels
  const int32_t* qp;      // (n,)
  const uint8_t* ts;      // (n,) transform skip
  const uint8_t* tqb;     // (n,) transquant bypass
  const int32_t* mslot;   // (n,) scaling-factor slot, 0 = flat
  int32_t* out;           // (n, S, S) residuals
  int n, log2, dst, first_block;
};

struct ItxArgs {
  ItxGroup g[kMaxGroups];
  const uint8_t* mtab;    // (slots, 32, 32) m[y][x], or null: all flat
  int n_groups, bd;
};

// One warp's 32 rows of S x S TUs, from TU tu0 on.  sh: the warp's
// 32 * (S + 1) words of shared memory.  LISTS: the plan has a factor
// table (mtab), so each TU reads its slot.
template <int S, bool LISTS>
__device__ __forceinline__ void itx_warp(const ItxGroup& G,
                                         const uint8_t* mtab, int32_t* sh,
                                         long long tu0, int bd) {
  constexpr int SS = S * S;
  constexpr int TS = S * (S + 1);   // a TU in shared memory
  constexpr int V = S / 4;          // 16-byte vectors a lane moves
  constexpr int log2 = S == 4 ? 2 : S == 8 ? 3 : S == 16 ? 4 : 5;
  const int lane = threadIdx.x & 31;
  // (c*16*scale + 2^(bs-1)) >> bs  ==  (c*scale + 2^(bs-5)) >> (bs-4)
  const int bs = bd + log2 - 5;
  const uint32_t rnd1 = 1u << (bs - 5);
  const int shift2 = 20 - bd;
  const int rnd2 = 1 << (shift2 - 1);

  // 1. load and dequantise; transform skip and bypass TUs are elementwise
  // and written here, and skipped by the store
  bool skip[V];
#pragma unroll
  for (int it = 0; it < V; ++it) {
    const int e = 4 * (lane + 32 * it);   // element of the warp's TUs
    const int tl = e / SS, i = (e / S) % S, k = e % S;
    const long long t = tu0 + tl;
    int d[4] = {0, 0, 0, 0};
    skip[it] = true;
    if (t < G.n) {
      const int4 c4 = __ldg(reinterpret_cast<const int4*>(
          G.coeffs + t * SS + e % SS));
      const int c[4] = {c4.x, c4.y, c4.z, c4.w};
      const int q = G.qp[t];
      const uint32_t scale = static_cast<uint32_t>(kLevelScale[q % 6]
                                                   << (q / 6));
      const int slot = LISTS ? __ldg(G.mslot + t) : 0;
      if (slot == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)   // int32 product and sum wrap as in XLA
          d[j] = clip16(static_cast<int32_t>(
              static_cast<uint32_t>(c[j]) * scale + rnd1) >> (bs - 4));
      } else {   // m[i][k..k+3], four bytes of the slot's row i
        const uint32_t m4 = __ldg(reinterpret_cast<const unsigned int*>(
            mtab + (static_cast<long long>(slot) * kMtabSide + i) *
                       kMtabSide + k));
        const long long rnd = 1LL << (bs - 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long v =
              (static_cast<long long>(c[j]) * ((m4 >> (8 * j)) & 255u) *
                   scale + rnd) >> bs;
          d[j] = static_cast<int>(min(max(v, -32768LL), 32767LL));
        }
      }
      const bool bypass = G.tqb[t] != 0;
      skip[it] = bypass || (S == 4 && G.ts[t] != 0);
      if (skip[it]) {
        int r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = bypass ? c[j] : ((d[j] << (5 + log2)) + rnd2) >> shift2;
        *reinterpret_cast<int4*>(G.out + t * SS + e % SS) =
            make_int4(r[0], r[1], r[2], r[3]);
      }
    }
    int32_t* dst = sh + tl * TS + i * (S + 1) + k;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j] = d[j];
  }
  __syncwarp();

  // 2. column pass, in place: lane (tl, k) takes column k of TU tl
  int x[S], y[S];
  {
    int32_t* col = sh + (lane / S) * TS + lane % S;
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = col[i * (S + 1)];
    if constexpr (S == 4) {
      if (G.dst) idst4(x, y); else idct<4>(x, y);
    } else {
      idct<S>(x, y);
    }
#pragma unroll
    for (int i = 0; i < S; ++i) col[i * (S + 1)] = clip16((y[i] + 64) >> 7);
  }
  __syncwarp();

  // 3. row pass, in place: lane (tl, i) takes row i of TU tl
  {
    int32_t* row = sh + (lane / S) * TS + (lane % S) * (S + 1);
#pragma unroll
    for (int j = 0; j < S; ++j) x[j] = row[j];
    if constexpr (S == 4) {
      if (G.dst) idst4(x, y); else idct<4>(x, y);
    } else {
      idct<S>(x, y);
    }
#pragma unroll
    for (int j = 0; j < S; ++j) row[j] = clip16((y[j] + rnd2) >> shift2);
  }
  __syncwarp();

  // 4. store the rows as 16-byte vectors
#pragma unroll
  for (int it = 0; it < V; ++it) {
    if (skip[it]) continue;
    const int e = 4 * (lane + 32 * it);
    const int tl = e / SS, i = (e / S) % S, k = e % S;
    const int32_t* src = sh + tl * TS + i * (S + 1) + k;
    *reinterpret_cast<int4*>(G.out + (tu0 + tl) * SS + e % SS) =
        make_int4(src[0], src[1], src[2], src[3]);
  }
}

// warp w of group G: its 32 rows of TUs
template <bool LISTS>
__device__ __forceinline__ void itx_dispatch(const ItxGroup& G,
                                             const ItxArgs& a, int32_t* s,
                                             long long w) {
  switch (G.log2) {
    case 2:
      if (w * 8 < G.n) itx_warp<4, LISTS>(G, a.mtab, s, w * 8, a.bd);
      break;
    case 3:
      if (w * 4 < G.n) itx_warp<8, LISTS>(G, a.mtab, s, w * 4, a.bd);
      break;
    case 4:
      if (w * 2 < G.n) itx_warp<16, LISTS>(G, a.mtab, s, w * 2, a.bd);
      break;
    default:
      if (w < G.n) itx_warp<32, LISTS>(G, a.mtab, s, w, a.bd);
      break;
  }
}

template <bool LISTS>
__global__ void __launch_bounds__(kItxThreads)
hevc_dequant_itx_kernel(const ItxArgs a) {
  __shared__ int32_t sh[kItxWarps][32 * 33];
  // this block's group: the last whose first block is at or before it
  // (the loop indexes the parameters with constants only)
  ItxGroup G = a.g[0];
#pragma unroll
  for (int k = 1; k < kMaxGroups; ++k)
    if (k < a.n_groups && static_cast<int>(blockIdx.x) >= a.g[k].first_block)
      G = a.g[k];
  const int warp = threadIdx.x >> 5;
  const long long w = static_cast<long long>(blockIdx.x - G.first_block) *
                      kItxWarps + warp;
  itx_dispatch<LISTS>(G, a, sh[warp], w);
}

// -------------------------------------------------------- hevc_intra_wave

constexpr int kWaveWarps = 32;           // warps a block, about one a TU
constexpr int kMaxRefs = 4 * 32 + 1;     // reference samples of a 32x32 TU
constexpr int kMaxLine = 3 * 32 + 1;     // its projected reference line

struct WaveGroup {
  const int32_t* ref_idx;    // (rows, 4n+1) flat indices into the buffer
  const uint8_t* ref_avail;  // (rows, 4n+1) bool
  const int32_t* mode;       // (rows,)
  const int32_t* scat;       // (rows, n*n) flat indices into the buffer
  const int32_t* res;        // (rows, n*n) residuals
  int log2, luma;
};

struct WaveArgs {
  WaveGroup g[kMaxGroups];
  const int32_t* rows;       // (n_groups, n_waves, pictures + 1) starts
  int n_groups, n_waves, pictures;
  int32_t* ybuf;
  int32_t* cbuf;
  int bd, strong;
};

// Predict row `row` of group G (TUs of 2^LOG2 samples a side) with one
// warp: gather, substitute, filter, predict, add the residual, clip,
// scatter.  Every load that does not depend on the samples (mode,
// reference indices and availability, residuals and scatter indices of
// the first eight samples a lane) is issued first, together.  The samples
// were written earlier in the launch, so they are read through the
// ordinary (coherent) path.  val, flt and line: the warp's shared
// reference samples, filtered ones and projected reference line.
template <int LOG2>
__device__ __forceinline__ void predict_tu(const WaveArgs& a,
                                           const WaveGroup& G, long long row,
                                           int* val, int* flt, int* line) {
  constexpr int n = 1 << LOG2, L = 4 * n + 1, ci = 2 * n, NN = n * n;
  constexpr int C = (L + 31) / 32;        // chunks of 32 reference samples
  constexpr int NP = (NN + 31) / 32;      // samples a lane
  constexpr int PRE = NP < 8 ? NP : 8;    // of them loaded up front
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int32_t* buf = G.luma ? a.ybuf : a.cbuf;
  const int half = 1 << (a.bd - 1), maxv = (1 << a.bd) - 1;

  // 0. the TU's tables
  const int mode = __ldg(G.mode + row);
  const int32_t* ridx = G.ref_idx + row * L;
  const uint8_t* rav = G.ref_avail + row * L;
  int ri[C];
  bool av[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    ri[c] = j < L ? __ldg(ridx + j) : 0;
    av[c] = j < L && __ldg(rav + j) != 0;
  }
  const int32_t* res = G.res + row * NN;
  const int32_t* scat = G.scat + row * NN;
  int rv[PRE], sv[PRE];
#pragma unroll
  for (int k = 0; k < PRE; ++k) {
    const int p = lane + 32 * k;
    rv[k] = p < NN ? __ldg(res + p) : 0;
    sv[k] = p < NN ? __ldg(scat + p) : 0;
  }

  // 1. gather the available reference samples, into registers
  int rs[C];
  unsigned masks[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    rs[c] = av[c] ? buf[ri[c]] : 0;
    masks[c] = __ballot_sync(all, av[c]);
  }

  // 2. substitution, by shuffles: a missing sample takes the nearest
  // available one before it, else the first available one; none
  // available: half range
  int first = half;
#pragma unroll
  for (int c = C - 1; c >= 0; --c)
    if (masks[c]) first = __shfl_sync(all, rs[c], __ffs(masks[c]) - 1);
  int prev = first;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const unsigned upto = masks[c] & ((2u << lane) - 1u);
    const int got = __shfl_sync(all, rs[c], upto ? 31 - __clz(upto) : 0);
    if (c * 32 + lane < L) val[c * 32 + lane] = upto ? got : prev;
    if (masks[c]) prev = __shfl_sync(all, rs[c], 31 - __clz(masks[c]));
  }
  __syncwarp();

  // 3. reference filtering: [1 2 1], or the bilinear strong smoothing of
  // flat 32x32 luma references
  const int* f = val;
  if (G.luma && n > 4) {
    const int dist = min(abs(mode - 26), abs(mode - 10));
    const int thresh = n == 8 ? 7 : (n == 16 ? 1 : 0);
    if (mode != 1 && (mode == 0 || dist > thresh)) {
      bool bil = false;
      if (n == 32 && a.strong) {
        const int lim = 1 << (a.bd - 5);
        bil = abs(val[ci] + val[4 * n] - 2 * val[ci + n]) < lim &&
              abs(val[ci] + val[0] - 2 * val[n]) < lim;
      }
      for (int j = lane; j < L; j += 32) {
        int v = val[j];
        if (bil) {
          const int rel = j - ci, ab = abs(rel);
          if (ab >= 1 && ab <= 2 * n - 1)
            v = ((2 * n - ab) * val[ci] + ab * (rel > 0 ? val[4 * n] : val[0])
                 + n) >> (LOG2 + 1);
        } else if (j > 0 && j < L - 1) {
          v = (val[j - 1] + 2 * val[j] + val[j + 1] + 2) >> 2;
        }
        flt[j] = v;
      }
      __syncwarp();
      f = flt;
    }
  }
  // left(i): the sample left of row i; top(i): above column i
  const int corner = f[ci];
  auto left = [&](int i) { return f[ci - 1 - i]; };
  auto top = [&](int i) { return f[ci + 1 + i]; };

  // 4. DC, or the angular modes' projected reference line, once a TU:
  // line[e] = ref[e - n] along the main direction, e in [0, 3n]
  int dc = 0;
  if (mode == 1) {
    int s = 0;
    for (int i = lane; i < n; i += 32) s += top(i) + left(i);
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(all, s, o);
    dc = (s + n) >> (LOG2 + 1);
  }
  const int m = min(max(mode, 0), 34);
  const int angle = kIntraAngle[m];
  const bool vertical = mode >= 18;
  if (mode >= 2) {
    const int inv = kInvAngle[m];
    for (int e = lane; e <= 3 * n; e += 32) {
      int v;
      if (e > n) {
        v = vertical ? top(e - n - 1) : left(e - n - 1);
      } else {
        const int nidx = ((e - n) * inv + 128) >> 8;
        const int sidx = min(max(nidx - 1, 0), 2 * n - 1);
        v = e == n || nidx == 0 ? corner
                                : (vertical ? left(sidx) : top(sidx));
      }
      line[e] = v;
    }
    __syncwarp();
  }

  // 5. predict, add the residual, clip, scatter
  const bool edge = G.luma && n < 32;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int p = lane + 32 * k;
    if (p >= NN) break;
    const int x = p & (n - 1), y = p >> LOG2;
    int pred;
    if (mode == 0) {
      pred = ((n - 1 - x) * left(y) + (x + 1) * top(n) +
              (n - 1 - y) * top(x) + (y + 1) * left(n) + n) >> (LOG2 + 1);
    } else if (mode == 1) {
      pred = dc;
      if (edge) {
        if (x == 0 && y == 0)
          pred = (left(0) + 2 * dc + top(0) + 2) >> 2;
        else if (y == 0)
          pred = (top(x) + 3 * dc + 2) >> 2;
        else if (x == 0)
          pred = (left(y) + 3 * dc + 2) >> 2;
      }
    } else {
      const int prod = (vertical ? y + 1 : x + 1) * angle;
      const int fact = prod & 31;
      const int i0 = min(n + (prod >> 5) + 1 + (vertical ? x : y), 3 * n);
      const int i1 = min(i0 + 1, 3 * n);
      pred = ((32 - fact) * line[i0] + fact * line[i1] + 16) >> 5;
      if (edge && mode == 26 && x == 0)
        pred = min(max(top(0) + ((left(y) - corner) >> 1), 0), maxv);
      if (edge && mode == 10 && y == 0)
        pred = min(max(left(0) + ((top(x) - corner) >> 1), 0), maxv);
    }
    const int r = k < PRE ? rv[k] : __ldg(res + p);
    const int d = k < PRE ? sv[k] : __ldg(scat + p);
    buf[d] = min(max(pred + r, 0), maxv);
  }
}

// The TUs of one wave of one picture: lane g < n_groups holds group g's
// first row and count, and the inclusive prefix of the counts over the
// groups (lanes past n_groups hold the wave's total).
struct Wave {
  int lo, cnt, incl, total;
};

__device__ __forceinline__ Wave wave_of(int lo, int hi) {
  const int lane = threadIdx.x & 31;
  Wave v{lo, hi - lo, hi - lo, 0};
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v.incl, o);
    if (lane >= o) v.incl += u;
  }
  v.total = __shfl_sync(0xffffffffu, v.incl, kMaxGroups);
  return v;
}

// group and row of TU i of a wave (the whole warp, one i)
__device__ __forceinline__ WaveGroup tu_of(const WaveArgs& a, const Wave& v,
                                           int i, long long& row) {
  const int g = __ffs(__ballot_sync(0xffffffffu, v.incl > i)) - 1;
  row = __shfl_sync(0xffffffffu, v.lo, g) + i -
        __shfl_sync(0xffffffffu, v.incl - v.cnt, g);
  WaveGroup G = a.g[0];      // indexed with constants only
#pragma unroll
  for (int k = 1; k < kMaxGroups; ++k)
    if (k == g) G = a.g[k];
  return G;
}

// One block a picture, walking its waves in order; the row ranges of wave
// w+1 are loaded during wave w.
__global__ void __launch_bounds__(kWaveWarps * 32, 1)
hevc_intra_wave_kernel(const WaveArgs a) {
  __shared__ int s_val[kWaveWarps][kMaxRefs];
  __shared__ int s_flt[kWaveWarps][kMaxRefs];
  __shared__ int s_line[kWaveWarps][kMaxLine];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x;
  const long long stride = a.pictures + 1;
  // lane g < n_groups: the rows [lo, hi) of group g, wave w, picture t
  auto rows_of = [&](int w, int& lo, int& hi) {
    lo = hi = 0;
    if (w < a.n_waves && lane < a.n_groups) {
      const int32_t* r = a.rows + (static_cast<long long>(lane) * a.n_waves
                                   + w) * stride + t;
      lo = r[0];
      hi = r[1];
    }
  };
  int lo, hi;
  rows_of(0, lo, hi);
  Wave cur = wave_of(lo, hi);
  for (int w = 0; w < a.n_waves; ++w) {
    rows_of(w + 1, lo, hi);
    for (int i = warp; i < cur.total; i += kWaveWarps) {
      long long row;
      const WaveGroup G = tu_of(a, cur, i, row);
      int* val = s_val[warp];
      int* flt = s_flt[warp];
      int* line = s_line[warp];
      switch (G.log2) {
        case 2: predict_tu<2>(a, G, row, val, flt, line); break;
        case 3: predict_tu<3>(a, G, row, val, flt, line); break;
        case 4: predict_tu<4>(a, G, row, val, flt, line); break;
        default: predict_tu<5>(a, G, row, val, flt, line); break;
      }
    }
    cur = wave_of(lo, hi);
    __syncthreads();
  }
}

// The chain bound's probe: per step one store, the barrier, and one
// dependent load of the stored word.
__global__ void __launch_bounds__(kWaveWarps * 32)
hevc_wave_probe_kernel(int32_t* buf, int steps) {
  int v = 0;
  for (int w = 0; w < steps; ++w) {
    if (threadIdx.x == 0) buf[blockIdx.x] = v + 1;
    __syncthreads();
    v = buf[blockIdx.x];
  }
}


// ------------------------------------------------------------ inter pred

// hevc_inter_pred: the motion-compensated prediction of every PU of one
// P or B picture (the JAX package's host numpy MC, recon.py _gather :78,
// mc_luma_14 :86, mc_chroma_14 :113, weight_uni :140, weight_bi :148,
// _mc_pu :405-436).  One block a job: a sub-block of at most 16x16 luma
// samples of one PU (the wrapper cuts PUs into such jobs; each output
// sample depends only on its position and the PU's motion), one thread a
// sample.  For each list the block loads the (16+7)^2 luma window of its
// reference into shared memory, clamping every coordinate to the
// uncropped picture, filters the window's rows with the 8-tap filter of
// the horizontal phase, then each thread the column of its sample with
// the vertical phase's, keeping HEVC's 14-bit intermediates; the two
// chroma planes follow with the 4-tap filters on (8+3)^2 windows.  Then
// default weighting, uni or bi, clipped to the bit depth.  The
// reference pictures are slots of the DPB's (slots, H, W) and (slots, 2,
// H/2, W/2) int32 tensors; the output is the picture's own flat sample
// buffers, which stage B later reads.  Bytes bound it: each job reads its
// windows (up to 2 x (529 + 2 x 121) samples) and writes 384 samples.

constexpr int kInterJobCols = 10;    // x y w h slot0 mv0x mv0y slot1 mv1x mv1y
constexpr int kInterSide = 16;       // luma job side; chroma 8
constexpr int kInterThreads = kInterSide * kInterSide;

__constant__ int kLumaTaps[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};
__constant__ int kChromaTaps[8][4] = {
    {0, 64, 0, 0},   {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

template <int K>
__device__ __forceinline__ int inter_tap(int phase, int k) {
  return K == 8 ? kLumaTaps[phase][k] : kChromaTaps[phase][k];
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The 14-bit prediction of sample (tid / B, tid % B) of a BxB block at
// (bx, by) of one plane (pw x ph) of reference `ref`, motion (mvx, mvy) in
// units of 1 / 2^FB sample; returned to threads tid < B*B (0 to the rest).
// Every thread of the block calls it: it holds three barriers.
template <int K, int B, int FB>
__device__ int inter_predict14(const int32_t* __restrict__ ref, int pw,
                               int ph, int bx, int by, int mvx, int mvy,
                               int shift1, int shift3, int* win, int* hp) {
  constexpr int P = K / 2 - 1;       // taps before the sample
  constexpr int S = B + K - 1;       // window side
  const int tid = threadIdx.x;
  const int xi = bx + (mvx >> FB), yi = by + (mvy >> FB);
  const int fx = mvx & ((1 << FB) - 1), fy = mvy & ((1 << FB) - 1);
  for (int i = tid; i < S * S; i += blockDim.x) {
    const int sy = clamp_int(yi - P + i / S, 0, ph - 1);
    const int sx = clamp_int(xi - P + i % S, 0, pw - 1);
    win[i] = ref[static_cast<size_t>(sy) * pw + sx];
  }
  __syncthreads();
  for (int i = tid; i < S * B; i += blockDim.x) {
    const int r = i / B, c = i % B;
    int s = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) s += inter_tap<K>(fx, k) * win[r * S + c + k];
    hp[i] = s >> shift1;
  }
  __syncthreads();
  int v = 0;
  if (tid < B * B) {
    const int r = tid / B, c = tid % B;
    if (fx == 0 && fy == 0) {
      v = win[(r + P) * S + c + P] << shift3;
    } else if (fy == 0) {
      v = hp[(r + P) * B + c];
    } else if (fx == 0) {
      int s = 0;
#pragma unroll
      for (int k = 0; k < K; ++k)
        s += inter_tap<K>(fy, k) * win[(r + k) * S + c + P];
      v = s >> shift1;
    } else {
      int s = 0;
#pragma unroll
      for (int k = 0; k < K; ++k)
        s += inter_tap<K>(fy, k) * hp[(r + k) * B + c];
      v = s >> 6;
    }
  }
  __syncthreads();                   // win and hp are reused next
  return v;
}

// default weighted sample prediction (spec 8.5.4.3.2)
__device__ __forceinline__ int inter_weight(const int* v, bool bi, int l,
                                            int bd) {
  const int maxv = (1 << bd) - 1;
  if (bi) {
    const int sh = 15 - bd;
    return clamp_int((v[0] + v[1] + (1 << (sh - 1))) >> sh, 0, maxv);
  }
  const int sh = 14 - bd;
  return clamp_int((v[l] + (1 << (sh - 1))) >> sh, 0, maxv);
}

struct InterArgs {
  const int32_t* jobs;
  const int32_t* ydpb;
  const int32_t* cdpb;
  int32_t* ybuf;
  int32_t* cbuf;
  int W, H, bd;
};

__global__ void __launch_bounds__(kInterThreads)
    hevc_inter_pred_kernel(InterArgs a) {
  __shared__ int win[(kInterSide + 7) * (kInterSide + 7)];
  __shared__ int hp[(kInterSide + 7) * kInterSide];
  const int32_t* jb = a.jobs + static_cast<size_t>(blockIdx.x) * kInterJobCols;
  const int x = jb[0], y = jb[1], w = jb[2], h = jb[3];
  const int slot[2] = {jb[4], jb[7]};
  const int mvx[2] = {jb[5], jb[8]};
  const int mvy[2] = {jb[6], jb[9]};
  const int shift1 = a.bd - 8, shift3 = 14 - a.bd;
  const bool bi = slot[0] >= 0 && slot[1] >= 0;
  const int uni = slot[0] >= 0 ? 0 : 1;
  const int tid = threadIdx.x;
  const size_t ysz = static_cast<size_t>(a.W) * a.H;
  int v[2] = {0, 0};
  for (int l = 0; l < 2; ++l)        // slot[l] is the same in every thread
    if (slot[l] >= 0)
      v[l] = inter_predict14<8, kInterSide, 2>(
          a.ydpb + slot[l] * ysz, a.W, a.H, x, y, mvx[l], mvy[l], shift1,
          shift3, win, hp);
  {
    const int r = tid / kInterSide, c = tid % kInterSide;
    if (r < h && c < w && y + r < a.H && x + c < a.W)
      a.ybuf[static_cast<size_t>(y + r) * a.W + x + c] =
          inter_weight(v, bi, uni, a.bd);
  }
  constexpr int CS = kInterSide / 2;
  const int cw = a.W >> 1, ch = a.H >> 1;
  const size_t csz = static_cast<size_t>(cw) * ch;
  const int cx = x >> 1, cy = y >> 1;
  const int wc = w >> 1 > 1 ? w >> 1 : 1, hc = h >> 1 > 1 ? h >> 1 : 1;
  for (int p = 0; p < 2; ++p) {
    int u[2] = {0, 0};
    for (int l = 0; l < 2; ++l)
      if (slot[l] >= 0)
        u[l] = inter_predict14<4, CS, 3>(
            a.cdpb + (static_cast<size_t>(slot[l]) * 2 + p) * csz, cw, ch,
            cx, cy, mvx[l], mvy[l], shift1, shift3, win, hp);
    if (tid < CS * CS) {
      const int r = tid / CS, c = tid % CS;
      if (r < hc && c < wc && cy + r < ch && cx + c < cw)
        a.cbuf[p * csz + static_cast<size_t>(cy + r) * cw + cx + c] =
            inter_weight(u, bi, uni, a.bd);
    }
  }
}

}  // namespace

extern "C" {

// groups: n_groups rows of 9 values (coeffs, qp, ts, tqb, mslot, out
// addresses; TUs, log2, DST-VII flag); mtab: the (slots, 32, 32) scaling
// factors, or null when every slot is 0
int launch_hevc_dequant_itx(const long long* groups, int n_groups, int bd,
                            const void* mtab, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_groups < 1 || n_groups > kMaxGroups || bd < 8 || bd > 16)
    return kInvalid;
  ItxArgs a{};
  a.n_groups = n_groups;
  a.bd = bd;
  a.mtab = static_cast<const uint8_t*>(mtab);
  if (reinterpret_cast<uintptr_t>(mtab) % 4 != 0) return kInvalid;
  long long blocks = 0;
  for (int k = 0; k < n_groups; ++k) {
    const long long* v = groups + 9 * k;
    ItxGroup& g = a.g[k];
    g.coeffs = reinterpret_cast<const int32_t*>(v[0]);
    g.qp = reinterpret_cast<const int32_t*>(v[1]);
    g.ts = reinterpret_cast<const uint8_t*>(v[2]);
    g.tqb = reinterpret_cast<const uint8_t*>(v[3]);
    g.mslot = reinterpret_cast<const int32_t*>(v[4]);
    g.out = reinterpret_cast<int32_t*>(v[5]);
    g.n = static_cast<int>(v[6]);
    g.log2 = static_cast<int>(v[7]);
    g.dst = static_cast<int>(v[8]);
    if (g.log2 < 2 || g.log2 > 5 || v[6] < 0 || v[6] > (1LL << 30) ||
        v[0] % 16 != 0 || v[5] % 16 != 0)    // 16-byte vectors
      return kInvalid;
    g.first_block = static_cast<int>(blocks);
    const int per_block = kItxWarps * (32 >> g.log2);   // TUs a block
    blocks += (v[6] + per_block - 1) / per_block;
  }
  if (blocks > (1LL << 31) - 1) return kInvalid;
  if (blocks == 0) return 0;
  auto kernel = a.mtab ? hevc_dequant_itx_kernel<true>
                       : hevc_dequant_itx_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kItxThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// groups: n_groups rows of 7 values (ref_idx, ref_avail, mode, scat, res
// addresses; log2, luma); rows: (n_groups, n_waves, pictures + 1) int32
int launch_hevc_intra_wave(const long long* groups, int n_groups,
                           const void* rows, int n_waves, int pictures,
                           void* ybuf, void* cbuf, int bd, int strong,
                           int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_groups < 1 || n_groups > kMaxGroups || bd < 8 || bd > 16 ||
      n_waves < 1 || pictures < 1 || pictures > (1 << 24))
    return kInvalid;
  WaveArgs a{};
  a.rows = static_cast<const int32_t*>(rows);
  a.n_groups = n_groups;
  a.n_waves = n_waves;
  a.pictures = pictures;
  a.ybuf = static_cast<int32_t*>(ybuf);
  a.cbuf = static_cast<int32_t*>(cbuf);
  a.bd = bd;
  a.strong = strong;
  for (int k = 0; k < n_groups; ++k) {
    const long long* v = groups + 7 * k;
    WaveGroup& g = a.g[k];
    g.ref_idx = reinterpret_cast<const int32_t*>(v[0]);
    g.ref_avail = reinterpret_cast<const uint8_t*>(v[1]);
    g.mode = reinterpret_cast<const int32_t*>(v[2]);
    g.scat = reinterpret_cast<const int32_t*>(v[3]);
    g.res = reinterpret_cast<const int32_t*>(v[4]);
    g.log2 = static_cast<int>(v[5]);
    g.luma = static_cast<int>(v[6]);
    if (g.log2 < 2 || g.log2 > 5) return kInvalid;
  }
  hevc_intra_wave_kernel<<<pictures, kWaveWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the probe of hevc_intra_wave's chain bound: `steps` steps with the wave
// kernel's launch shape; buf holds `pictures` words
int launch_hevc_wave_probe(void* buf, int pictures, int steps, int device,
                           void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (pictures < 1 || steps < 0) return kInvalid;
  hevc_wave_probe_kernel<<<pictures, kWaveWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(buf), steps);
  return static_cast<int>(cudaGetLastError());
}

// jobs: (n_jobs, 10) int32 rows x, y, w, h (a luma sub-block of at most
// 16x16 of one PU), then per list the DPB slot (-1: list unused) and the
// quarter-sample motion vector; ydpb (slots, H, W) and cdpb (slots, 2,
// H/2, W/2) int32; ybuf/cbuf the picture's flat (H*W, 2*H/2*W/2) buffers
int launch_hevc_inter_pred(const void* jobs, int n_jobs, const void* ydpb,
                           const void* cdpb, int W, int H, int bd,
                           void* ybuf, void* cbuf, int device,
                           void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_jobs < 0 || W < 8 || H < 8 || bd < 8 || bd > 12) return kInvalid;
  if (n_jobs == 0) return 0;
  InterArgs a{};
  a.jobs = static_cast<const int32_t*>(jobs);
  a.ydpb = static_cast<const int32_t*>(ydpb);
  a.cdpb = static_cast<const int32_t*>(cdpb);
  a.ybuf = static_cast<int32_t*>(ybuf);
  a.cbuf = static_cast<int32_t*>(cbuf);
  a.W = W;
  a.H = H;
  a.bd = bd;
  hevc_inter_pred_kernel<<<n_jobs, kInterThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
