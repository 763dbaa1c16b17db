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
//   hevc_mode_search  <- the encoder's open-loop intra mode search, the jnp
//                        program device_modes.py _jitted_search :161-180
//                        (notes at the end of this file); every block of
//                        one size
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
// _mc_pu :405-436).  A job is a sub-block of at most 16x16 luma samples
// of one PU (the wrapper cuts PUs into such jobs; each output sample
// depends only on its position and the PU's motion): the luma samples
// with the 8-tap quarter-sample filter, the two chroma planes' (4:2:0)
// with the 4-tap eighth-sample one, at HEVC's 14-bit intermediate
// precision, every reference coordinate clamped to the uncropped
// picture, then default uni or bi weighting clipped to the bit depth.
// The references are slots of the DPB's (slots, H, W) and (slots, 2,
// H/2, W/2) int32 tensors; the output is the picture's own flat sample
// buffers, which stage B later reads.
//
// Bytes bound it: a picture of mostly whole-sample motion reads about
// one reference sample an output sample and writes each output once,
// and fractional motion adds at most ~40 operations a sample.  What
// keeps a kernel from that bound is each job's chain of dependent
// copies, barriers and filters, so the design keeps many jobs resident
// and each chain short:
//
// * One warp a job, kInterWarps warps a block, a grid-stride walk over
//   the job table sized to the card's resident blocks (32 warps an SM),
//   the next job's row loaded while the current one runs.  No block
//   barrier: the warps of a block share nothing.
// * One memory round trip a job: before any arithmetic the warp starts
//   cp.async copies of every window of the job (both lists, luma and
//   both chroma planes), each with only the rows and columns its phase
//   needs (B+K-1 along an axis with a fractional phase, B along one
//   without), then one wait and one __syncwarp.  A window inside the
//   picture is copied in the widest vectors its first column allows (16
//   bytes, else 8 or 4), one across an edge a clamped sample at a time;
//   each lane copies one column of vectors down the rows, a few
//   instructions a copy.  Every window lands in one layout (rows of 24
//   words luma, 12 chroma), which the filters read as 16-byte vectors
//   without bank conflicts.
// * Only the passes the phase needs, in registers: an integer vector is
//   a copy shifted by 14 - bd, one fractional phase one pass, both a
//   horizontal pass written over the window in place (rows of one
//   __syncwarp round each), then the vertical one.  A lane computes 4
//   adjacent columns of 2 luma rows and of 1 chroma row, keeps both
//   lists' 14-bit values in registers, weights once, and stores luma as
//   int4 and chroma as int2 (single samples where a row is ragged or
//   unaligned, none outside the picture).
//
// Measured on the H100 (PERF.md): a 1920x1080 B picture of whole-sample
// motion runs at about two thirds of its byte bound; a 3840x2160 one
// with every phase and mostly 8x4/4x8 PUs at about a fifth, held by the
// per-warp chain of a job's round trip and its filters (a small PU
// leaves most of its warp's lanes idle).

constexpr int kInterJobCols = 10;    // x y w h slot0 mv0x mv0y slot1 mv1x mv1y
constexpr int kInterSide = 16;       // luma job side; chroma 8
constexpr int kInterWarps = 8;       // jobs a block at a time
constexpr int kInterYStride = 24;    // words a luma window row (16 + 7)
constexpr int kInterCStride = 12;    // words a chroma window row (8 + 3)
constexpr int kInterYWin = (kInterSide + 7) * kInterYStride;
constexpr int kInterCWin = (kInterSide / 2 + 3) * kInterCStride;
constexpr int kInterListWords = kInterYWin + 2 * kInterCWin;
constexpr int kInterSmem =           // bytes a block: both lists a warp
    static_cast<int>(sizeof(int)) * 2 * kInterListWords * kInterWarps;
constexpr unsigned kFullMask = 0xffffffffu;

__constant__ int kLumaTaps[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};
__constant__ int kChromaTaps[8][4] = {
    {0, 64, 0, 0},   {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

template <int K>
__device__ __forceinline__ void inter_taps(int phase, int* t) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    t[k] = K == 8 ? kLumaTaps[phase][k] : kChromaTaps[phase][k];
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

#ifndef TORCH_CUDA_EMU  // tests/torch_cuda_emu.h defines these for g++
// 4 or 2 samples to an aligned global address in one instruction (nvcc
// split a plain int4 store behind an alignment test into four)
__device__ __forceinline__ void store_global_v4(int32_t* p, int a, int b,
                                                int c, int d) {
  asm volatile("st.global.v4.s32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ void store_global_v2(int32_t* p, int a, int b) {
  asm volatile("st.global.v2.s32 [%0], {%1, %2};\n" ::"l"(p), "r"(a),
               "r"(b)
               : "memory");
}
// 16, 8 or 4 bytes from global to shared memory, asynchronously
__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void copy_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void copy_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
// every copy this thread started has landed
__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
#endif

// A window of one plane: ew x eh samples from (x0, y0), phases fx, fy.
struct InterWin {
  int x0, y0, ew, eh, fx, fy;
};

// The window of a b x bh block at (bx, by) moved by (mvx, mvy) in units
// of 1 / 2^FB sample, for a K-tap filter: the taps' reach only along an
// axis with a fractional phase.
template <int K, int FB>
__device__ __forceinline__ InterWin inter_win(int bx, int by, int bw, int bh,
                                              int mvx, int mvy) {
  constexpr int P = K / 2 - 1;       // taps before the sample
  InterWin g;
  g.fx = mvx & ((1 << FB) - 1);
  g.fy = mvy & ((1 << FB) - 1);
  g.x0 = bx + (mvx >> FB) - (g.fx ? P : 0);
  g.y0 = by + (mvy >> FB) - (g.fy ? P : 0);
  g.ew = bw + (g.fx ? K - 1 : 0);
  g.eh = bh + (g.fy ? K - 1 : 0);
  return g;
}

// The copies of the rows [r, eh) of a window, every (32 >> pl)-th one,
// by one lane: V samples a copy from `src` (row 0 of the lane's column)
// to `dst` (rows S words apart).
template <int V, int S>
__device__ __forceinline__ void inter_rows_copy(const int32_t* src,
                                                size_t pw, int* dst, int r,
                                                int eh, int pl) {
  const int step = 32 >> pl;
  src += r * pw;
  dst += r * S;
  for (; r < eh; r += step, src += step * pw, dst += step * S) {
    if (V == 4)
      copy_async16(dst, src);
    else if (V == 2)
      copy_async8(dst, src);
    else
      copy_async4(dst, src);
  }
}

// Start the copies of window g of plane `ref` (pw x ph; `rows16`: its
// rows start 16-byte aligned) into `win` (rows of S words, 16-byte
// aligned), spread over the warp's lanes: 2^pl lanes a row, each one
// column of copies.  A window inside the picture goes in aligned vectors
// of 4, 2 or 1 samples (the last one of a row may reach into the row's
// padding in `win`, never past the picture's row: x0 and pw are
// multiples of it); one across an edge sample by sample, each
// coordinate clamped.  The caller waits.
template <int S>
__device__ __forceinline__ void inter_window_copy(const int32_t* ref, int pw,
                                                  int ph, const InterWin& g,
                                                  bool rows16, int* win,
                                                  int lane) {
  const bool inside =
      g.x0 >= 0 && g.y0 >= 0 && g.x0 + g.ew <= pw && g.y0 + g.eh <= ph;
  const int vl = inside && rows16 ? ((g.x0 & 3) == 0 ? 2 : (~g.x0 & 1))
                                  : 0;
  const int per_row = (g.ew + (1 << vl) - 1) >> vl;
  const int pl = per_row <= 1 ? 0 : 32 - __clz(per_row - 1);
  const int q = lane & ((1 << pl) - 1);
  if (q >= per_row) return;
  const int c = q << vl, r = lane >> pl;
  int* dst = win + c;
  if (!inside) {
    const int sx = clamp_int(g.x0 + c, 0, pw - 1);
    for (int k = r; k < g.eh; k += 32 >> pl)
      copy_async4(dst + k * S, ref + static_cast<size_t>(clamp_int(
                                         g.y0 + k, 0, ph - 1)) * pw + sx);
    return;
  }
  const int32_t* src = ref + static_cast<size_t>(g.y0) * pw + g.x0 + c;
  if (vl == 2)
    inter_rows_copy<4, S>(src, pw, dst, r, g.eh, pl);
  else if (vl == 1)
    inter_rows_copy<2, S>(src, pw, dst, r, g.eh, pl);
  else
    inter_rows_copy<1, S>(src, pw, dst, r, g.eh, pl);
}

// 4 words from a 16-byte aligned shared address
__device__ __forceinline__ void lds4(const int* p, int* o) {
  const int4 q = *reinterpret_cast<const int4*>(p);
  o[0] = q.x;
  o[1] = q.y;
  o[2] = q.z;
  o[3] = q.w;
}

// The K-tap horizontal filter of 4 adjacent samples whose taps start at
// `row` (16-byte aligned), each sum shifted right by sh.
template <int K>
__device__ __forceinline__ void inter_h4(const int* row, const int* t, int sh,
                                         int* o) {
  constexpr int NV = (K + 6) / 4;    // vectors holding the K + 3 inputs
  int a[4 * NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) lds4(row + 4 * q, a + 4 * q);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int s = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) s += t[k] * a[j + k];
    o[j] = s >> sh;
  }
}

// The K-tap vertical filter of R rows of 4 adjacent samples whose taps
// start at `col` (16-byte aligned, rows S words apart), each sum shifted
// right by sh; o holds R groups of 4.
template <int K, int R, int S>
__device__ __forceinline__ void inter_v4(const int* col, const int* t, int sh,
                                         int* o) {
  int a[R + K - 1][4];
#pragma unroll
  for (int k = 0; k < R + K - 1; ++k) lds4(col + k * S, a[k]);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int s = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) s += t[k] * a[i + k][j];
      o[4 * i + j] = s >> sh;
    }
}

// The horizontal pass of a window with both phases, written over the
// window in place: rows 0..eh-1, 2^cs groups of 4 outputs a row, by L
// lanes (l their index; L a multiple of 2^cs, so a round takes whole
// rows).  Each round reads its rows, meets at a __syncwarp, then writes
// them, so every lane of the warp runs the same number of rounds.
template <int K, int S, int L>
__device__ __forceinline__ void inter_h_in_place(int* win, int eh, int cs,
                                                 const int* t, int sh, int l) {
  const int n = eh << cs;
  for (int base = 0; base < n; base += L) {
    const int i = base + l;
    const int r = i >> cs, c = 4 * (i & ((1 << cs) - 1));
    int o[4];
    if (i < n) inter_h4<K>(win + r * S + c, t, sh, o);
    __syncwarp();
    if (i < n)
      *reinterpret_cast<int4*>(win + r * S + c) =
          make_int4(o[0], o[1], o[2], o[3]);
  }
  __syncwarp();
}

// The 14-bit luma prediction of a lane's 8 samples (rows 2rg and 2rg+1,
// columns 4cg..4cg+3 of the job) from its window `win` (g), the job bw
// samples wide.  Warp-uniform: every lane calls it with the same g.
__device__ __forceinline__ void inter_luma14(int* win, const InterWin& g,
                                             int bw, int shift1, int shift3,
                                             int lane, int* v) {
  constexpr int S = kInterYStride;
  const int* at = win + 2 * (lane >> 2) * S + 4 * (lane & 3);
  int t[8];
  if (!g.fx && !g.fy) {
    lds4(at, v);
    lds4(at + S, v + 4);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] <<= shift3;
  } else if (!g.fy) {
    inter_taps<8>(g.fx, t);
    inter_h4<8>(at, t, shift1, v);
    inter_h4<8>(at + S, t, shift1, v + 4);
  } else if (!g.fx) {
    inter_taps<8>(g.fy, t);
    inter_v4<8, 2, S>(at, t, shift1, v);
  } else {
    inter_taps<8>(g.fx, t);
    inter_h_in_place<8, S, 32>(win, g.eh, bw <= 4 ? 0 : (bw <= 8 ? 1 : 2), t,
                               shift1, lane);
    inter_taps<8>(g.fy, t);
    inter_v4<8, 2, S>(at, t, 6, v);
  }
}

// The 14-bit chroma prediction of a lane's 4 samples (plane lane >> 4,
// row (lane >> 1) & 7, columns 4 (lane & 1)..+3) from the list's two
// chroma windows (`win`, the second kInterCWin words on), bw samples
// wide.  Warp-uniform as inter_luma14.
__device__ __forceinline__ void inter_chroma14(int* win, const InterWin& g,
                                               int bw, int shift1, int shift3,
                                               int lane, int* u) {
  constexpr int S = kInterCStride;
  int* plane = win + (lane >> 4) * kInterCWin;
  const int* at = plane + ((lane >> 1) & 7) * S + 4 * (lane & 1);
  int t[4];
  if (!g.fx && !g.fy) {
    lds4(at, u);
#pragma unroll
    for (int k = 0; k < 4; ++k) u[k] <<= shift3;
  } else if (!g.fy) {
    inter_taps<4>(g.fx, t);
    inter_h4<4>(at, t, shift1, u);
  } else if (!g.fx) {
    inter_taps<4>(g.fy, t);
    inter_v4<4, 1, S>(at, t, shift1, u);
  } else {
    inter_taps<4>(g.fx, t);
    inter_h_in_place<4, S, 16>(plane, g.eh, bw <= 4 ? 0 : 1, t, shift1,
                               lane & 15);
    inter_taps<4>(g.fy, t);
    inter_v4<4, 1, S>(at, t, 6, u);
  }
}

// default weighted sample prediction (spec 8.5.4.3.2) of the lists'
// 14-bit values: both (bi), else list 1's (l1) or list 0's
__device__ __forceinline__ int inter_weight(int v0, int v1, bool bi, bool l1,
                                            int bd) {
  const int maxv = (1 << bd) - 1;
  if (bi) {
    const int sh = 15 - bd;
    return clamp_int((v0 + v1 + (1 << (sh - 1))) >> sh, 0, maxv);
  }
  const int sh = 14 - bd;
  return clamp_int(((l1 ? v1 : v0) + (1 << (sh - 1))) >> sh, 0, maxv);
}

// Store 4 adjacent samples at dst, the first at column c of a row whose
// samples c < n exist (n: the fewer of the block's and the picture's
// remaining columns): one V-sample vector at a time where whole and
// aligned, single samples otherwise.
template <int V>
__device__ __forceinline__ void inter_store4(int32_t* dst, int c, int n,
                                             const int* o) {
#pragma unroll
  for (int q = 0; q < 4; q += V) {
    int32_t* p = dst + q;
    if (c + q + V <= n &&
        reinterpret_cast<uintptr_t>(p) % (sizeof(int32_t) * V) == 0) {
      if (V == 4)
        store_global_v4(p, o[0], o[1], o[2], o[3]);
      else
        store_global_v2(p, o[q], o[q + 1]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (c + q + k < n) p[k] = o[q + k];
    }
  }
}

struct InterArgs {
  const int32_t* jobs;
  const int32_t* ydpb;
  const int32_t* cdpb;
  int32_t* ybuf;
  int32_t* cbuf;
  int n, W, H, bd;
};

// A job's columns, from the lane k < 10 that holds column k of its row.
struct InterJob {
  int x, y, w, h, slot[2], mvx[2], mvy[2];
  __device__ __forceinline__ bool bi() const {
    return slot[0] >= 0 && slot[1] >= 0;
  }
};

__device__ __forceinline__ InterJob inter_job(int col) {
  int f[kInterJobCols];
#pragma unroll
  for (int k = 0; k < kInterJobCols; ++k)
    f[k] = __shfl_sync(kFullMask, col, k);
  InterJob b;
  b.x = f[0];
  b.y = f[1];
  b.w = f[2];
  b.h = f[3];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    b.slot[l] = f[4 + 3 * l];
    b.mvx[l] = f[5 + 3 * l];
    b.mvy[l] = f[6 + 3 * l];
  }
  return b;
}

// The geometry a warp's jobs share: the planes, their sizes, and whether
// their rows start 16-byte aligned.
struct InterPlanes {
  int cw, ch;
  size_t ysz, csz;
  bool yrows16, crows16;
};

__device__ __forceinline__ void inter_luma_win(const InterJob& b, int l,
                                               InterWin& g) {
  g = inter_win<8, 2>(b.x, b.y, b.w, b.h, b.mvx[l], b.mvy[l]);
}

__device__ __forceinline__ void inter_chroma_win(const InterJob& b, int l,
                                                 InterWin& g) {
  const int wc = b.w >> 1 > 1 ? b.w >> 1 : 1, hc = b.h >> 1 > 1 ? b.h >> 1 : 1;
  g = inter_win<4, 3>(b.x >> 1, b.y >> 1, wc, hc, b.mvx[l], b.mvy[l]);
}

// Start the copies of every window of job b (both lists, luma and both
// chroma planes; list l's into the l-th kInterListWords words of the
// warp's buffer `mine`).
__device__ __forceinline__ void inter_copy_windows(const InterArgs& a,
                                                   const InterPlanes& pl,
                                                   const InterJob& b,
                                                   int* mine, int lane) {
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    if (b.slot[l] < 0) continue;
    int* lw = mine + l * kInterListWords;
    InterWin g;
    inter_luma_win(b, l, g);
    inter_window_copy<kInterYStride>(a.ydpb + b.slot[l] * pl.ysz, a.W, a.H,
                                     g, pl.yrows16, lw, lane);
    inter_chroma_win(b, l, g);
#pragma unroll
    for (int p = 0; p < 2; ++p)
      inter_window_copy<kInterCStride>(
          a.cdpb + (static_cast<size_t>(b.slot[l]) * 2 + p) * pl.csz, pl.cw,
          pl.ch, g, pl.crows16, lw + kInterYWin + p * kInterCWin, lane);
  }
}

// Filter, weight and store job b from its windows (landed).
__device__ __forceinline__ void inter_predict(const InterArgs& a,
                                              const InterPlanes& pl,
                                              const InterJob& b, int* mine,
                                              int lane) {
  const int shift1 = a.bd - 8, shift3 = 14 - a.bd;
  const bool bi = b.bi(), l1 = b.slot[0] < 0;
  {
    int v[2][8] = {};
#pragma unroll
    for (int l = 0; l < 2; ++l)
      if (b.slot[l] >= 0) {
        InterWin g;
        inter_luma_win(b, l, g);
        inter_luma14(mine + l * kInterListWords, g, b.w, shift1, shift3,
                     lane, v[l]);
      }
    const int c = 4 * (lane & 3);
    const int n = min(b.w, a.W - b.x);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * (lane >> 2) + i;
      if (r >= b.h || b.y + r >= a.H) continue;
      int o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = inter_weight(v[0][4 * i + k], v[1][4 * i + k], bi, l1, a.bd);
      inter_store4<4>(
          a.ybuf + static_cast<size_t>(b.y + r) * a.W + b.x + c, c, n, o);
    }
  }
  {
    const int cx = b.x >> 1, cy = b.y >> 1;
    const int wc = b.w >> 1 > 1 ? b.w >> 1 : 1, hc = b.h >> 1 > 1 ? b.h >> 1 : 1;
    int u[2][4] = {};
#pragma unroll
    for (int l = 0; l < 2; ++l)
      if (b.slot[l] >= 0) {
        InterWin g;
        inter_chroma_win(b, l, g);
        inter_chroma14(mine + l * kInterListWords + kInterYWin, g, wc,
                       shift1, shift3, lane, u[l]);
      }
    const int p = lane >> 4, r = (lane >> 1) & 7, c = 4 * (lane & 1);
    if (r < hc && cy + r < pl.ch) {
      int o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = inter_weight(u[0][k], u[1][k], bi, l1, a.bd);
      inter_store4<2>(a.cbuf + p * pl.csz +
                          static_cast<size_t>(cy + r) * pl.cw + cx + c,
                      c, min(wc, pl.cw - cx), o);
    }
  }
}

__global__ void __launch_bounds__(kInterWarps * 32, 4)
    hevc_inter_pred_kernel(InterArgs a) {
  extern __shared__ int4 inter_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* const mine = reinterpret_cast<int*>(inter_smem) +
                    warp * 2 * kInterListWords;
  InterPlanes pl;
  pl.cw = a.W >> 1;
  pl.ch = a.H >> 1;
  pl.ysz = static_cast<size_t>(a.W) * a.H;
  pl.csz = static_cast<size_t>(pl.cw) * pl.ch;
  pl.yrows16 = a.W % 4 == 0 && reinterpret_cast<uintptr_t>(a.ydpb) % 16 == 0;
  pl.crows16 =
      pl.cw % 4 == 0 && reinterpret_cast<uintptr_t>(a.cdpb) % 16 == 0;
  const int step = gridDim.x * kInterWarps;
  // lane k < 10 holds column k of the job's row; the next one's is loaded
  // while this one runs
  int j = blockIdx.x * kInterWarps + warp;
  int col = j < a.n && lane < kInterJobCols
                ? __ldg(a.jobs + static_cast<size_t>(j) * kInterJobCols + lane)
                : 0;
  for (; j < a.n; j += step) {            // warp-uniform
    const InterJob b = inter_job(col);
    const int jn = j + step;
    col = jn < a.n && lane < kInterJobCols
              ? __ldg(a.jobs + static_cast<size_t>(jn) * kInterJobCols + lane)
              : 0;
    inter_copy_windows(a, pl, b, mine, lane);
    copy_async_wait_all();
    __syncwarp();
    inter_predict(a, pl, b, mine, lane);
    __syncwarp();                         // the windows are refilled next
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
  // the blocks the card holds at once, found once a device
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return kInvalid;
  auto kernel = hevc_inter_pred_kernel;
  if (resident[device] == 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kInterSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kInterWarps * 32, kInterSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident[device] = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  InterArgs a{};
  a.jobs = static_cast<const int32_t*>(jobs);
  a.ydpb = static_cast<const int32_t*>(ydpb);
  a.cdpb = static_cast<const int32_t*>(cdpb);
  a.ybuf = static_cast<int32_t*>(ybuf);
  a.cbuf = static_cast<int32_t*>(cbuf);
  a.n = n_jobs;
  a.W = W;
  a.H = H;
  a.bd = bd;
  const int need = (n_jobs + kInterWarps - 1) / kInterWarps;
  const int blocks = need < resident[device] ? need : resident[device];
  kernel<<<blocks, kInterWarps * 32, kInterSmem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// ------------------------------------------------------------ mode search
//
// hevc_mode_search <- device_modes.py _jitted_search :161-180: for every
// n x n block (n = 8, 16, 32) and each of the 35 intra modes, the open-loop
// prediction from the block's 4n+1 reference samples, the residual, its
// 2-D Hadamard transform, the sum of absolute values / n (equal to the jnp
// program's H/sqrt(n) R H/sqrt(n)), and the first mode of least cost.
//
// Bounds (the 4032x3024 luma, n = 8, 190,512 blocks): bytes, the blocks and
// references read once and a mode and cost written, 75.5 MB, 0.0225 ms at
// 3.35 TB/s; FP32 operations, per block the non-zero taps of
// device_modes.weight_matrix (the residual folded into the first tap's
// multiply-add) and DC's 2n adds, and per mode 2 n^2 log2(n): the
// butterflies but the last column stage, and that stage with the absolute
// sum as one max and one add a pair (|a + b| + |a - b| = 2 max(|a|, |b|)),
// 17,600 a block, 3.35 billion in all, 0.100 ms at 132 SMs x 128 FP32
// lanes x 1.98 GHz (0.126 and 0.150 ms at n = 16 and 32).  The operations
// bind, so the design spends few instructions beyond them and keeps every
// operand in registers or shared memory without bank conflicts.
//
// Design.
// 1. A warp a group of blocks, a lane a row: n lanes hold one block (four
//    blocks a warp at n = 8, two at 16, one at 32), lane r its row r and
//    its column r of the source samples in registers.  Warps share nothing,
//    so the kernel has no __syncthreads; a CTA is kMsWarps warps.
// 2. No tap tables.  A mode's taps are computed from the mode and the
//    row, as weight_matrix defines them.  Each block keeps its two extended
//    main references in shared memory, E[n + j] = ext[j] for j in [-n, 2n]:
//    the top one (corner and top row, refs[2n + j]) for the vertical modes
//    18-34 and the left one (refs[2n - j]) for the horizontal modes 2-17,
//    written once a block; a mode with a negative angle rewrites only the
//    part j < 0, one sample a lane, projected from the other side by
//    kInvAngle.  Row r of a vertical mode is iIdx = ((r+1) angle) >> 5 and
//    f = ((r+1) angle) & 31 into E: n + 1 consecutive loads and two FFMAs a
//    sample for the prediction less the source, weights (32 - f) / 32 and
//    f / 32 (f = 0: one tap, the second weight 0 over a padded 0).  A
//    horizontal mode is the same on the transposed block, since
//    sum |H R^T H| = sum |H R H|: lane r predicts column r from the left
//    reference and subtracts the source's column r.  Planar is
//    ((n-1-x) L[y] + (x+1) T[n] + (n-1-y) T[x] + (y+1) L[n]) / 2n, DC the
//    mean of the 2n references (a shuffle sum, once a block).  The angles
//    come from the constant bank (kIntraAngle, kInvAngle), one uniform load
//    a mode.  For 8-bit samples every prediction and residual is exact in
//    FP32, as the jnp program's are.
// 3. The Hadamard transform in registers: each lane runs the row
//    butterflies on its n values, writes them to a per-block shared array
//    of stride n + 1, reads back its column and runs the column
//    butterflies, then sums |values| and reduces over the block's lanes by
//    __shfl_xor_sync (every lane gets the same sum).  The column stage by
//    the transpose costs 2n shared accesses a lane a mode; by shuffles it
//    would cost n log2(n) (24 / 64 / 160 at n = 8 / 16 / 32), or n/2
//    log2(n) exchanging half the values a stage plus n selects a stage.
//    Shuffles and shared accesses both issue at 32 lanes a clock an SM, so
//    the transpose (16 / 32 / 64) is the cheaper at every n.  Stride n + 1,
//    the blocks of a warp 72 / 272 words apart, and the references' rows
//    MsLayout::kE words apart (= n mod 32) make every access free of bank
//    conflicts.  A mode takes two __syncwarp and no CTA barrier: one after
//    the negative angles' writes and before the transposed writes, one
//    between the transposed writes and reads.
// 4. The modes run 0, 1, 2-17, 18-34, mode order, and a lower cost
//    replaces the best only when strictly lower: argmin's first mode of
//    least cost (the flat plane's every mode ties at 0: mode 0 wins).
// 5. FP32 on the CUDA cores, no tensor cores: the near-tie rule of the
//    checks is on f32 costs.
//
// Measured (codecs/hevc/mode_search_profile.py on an H100 80GB HBM3 at a
// 700 W power limit, the 4032x3024 luma's blocks): 0.2480 / 0.2590 /
// 0.3075 ms at n = 8 / 16 / 32, 40% / 49% / 49% of the FP32 bound, 15x /
// 21x / 39x the first form (256 threads a CTA, tap tables read from
// device memory a sample a mode, butterflies in shared memory with a CTA
// barrier a stage); the mode loop 134 / 258 / 527 SASS instructions a lane
// a mode, about 16.5 a sample a mode; ptxas 48 / 64 / 128 registers, no
// spills.  Leaving a part out saves: the transposed array 18-22% of the
// time, the prediction's loads and multiply-adds 12-19%, the butterflies
// 9-25%, the shuffle sum 4-7%, the __syncwarp calls under 1%.

namespace {

constexpr int kMsWarps = 4;                    // warps a CTA
constexpr int kMsThreads = 32 * kMsWarps;
constexpr int kMsModes = 35;

template <int n>
struct MsLayout {
  static constexpr int kBlocks = 32 / n;       // blocks a warp
  // an extended reference, >= 3n + 2 words, = n mod 32
  static constexpr int kE = ((2 * n + 2 + 31) / 32) * 32 + n;
  static constexpr int kT = n * (n + 1);       // a block's transposed rows
};

// the 1-D Hadamard transform of v[0..n-1] in place (Sylvester order), its
// butterfly stages of span below kStop
template <int n, int kStop = n>
__device__ __forceinline__ void ms_fwht(float* v) {
#pragma unroll
  for (int h = 1; h < kStop; h <<= 1) {
#pragma unroll
    for (int i = 0; i < n; ++i) {
      if ((i & h) == 0) {
        const float a = v[i], b = v[i + h];
        v[i] = a + b;
        v[i + h] = a - b;
      }
    }
  }
}

// sum |H R H| / n of the block whose row r (or column r: the sum is the
// same) this lane holds in v, through the block's transposed array t; the
// caller's __syncwarp orders t's writes after the last mode's reads.  The
// last column stage is folded into the sum: |a + b| + |a - b| =
// 2 max(|a|, |b|), two instructions a pair instead of four.
template <int n>
__device__ __forceinline__ float ms_satd(float* v, float* t, int r) {
  ms_fwht<n>(v);
#pragma unroll
  for (int c = 0; c < n; ++c) t[r * (n + 1) + c] = v[c];
  __syncwarp();
#pragma unroll
  for (int c = 0; c < n; ++c) v[c] = t[c * (n + 1) + r];
  ms_fwht<n, n / 2>(v);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < n / 2; ++c) s += fmaxf(fabsf(v[c]), fabsf(v[c + n / 2]));
#pragma unroll
  for (int o = n / 2; o > 0; o >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, o);
  return s * (2.f / n);
}

__device__ __forceinline__ void ms_keep(float cost, int m, float& best,
                                        int& best_mode) {
  if (cost < best) {   // strict: the first mode of least cost
    best = cost;
    best_mode = m;
  }
}

// angular mode m on the main reference em (the side one es): lane r
// predicts row r of the vertical modes, column r of the horizontal ones,
// less src (the source's row or column r)
template <int n>
__device__ __forceinline__ void ms_angular(int m, float* em, const float* es,
                                           const float* src, float* t,
                                           int r, float& best,
                                           int& best_mode) {
  const int angle = kIntraAngle[m];
  if (angle < 0) {
    // ext[j] for j < 0: the side reference at (j invAngle + 128) >> 8
    const int j = -1 - r;
    if (j >= ((n * angle) >> 5)) {
      const int idx = (j * kInvAngle[m] + 128) >> 8;
      em[n + j] = es[n + min(idx, 2 * n)];
    }
  }
  __syncwarp();
  const int p = (r + 1) * angle;
  const int f = p & 31;
  const float w1 = static_cast<float>(f) * (1.f / 32);
  const float w0 = static_cast<float>(32 - f) * (1.f / 32);
  const float* e = em + n + (p >> 5) + 1;
  float v[n];
  float e0 = e[0];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float e1 = e[i + 1];
    v[i] = __fmaf_rn(w1, e1, __fmaf_rn(w0, e0, -src[i]));
    e0 = e1;
  }
  ms_keep(ms_satd<n>(v, t, r), m, best, best_mode);
}

template <int kLog2>
__global__ void __launch_bounds__(kMsThreads) hevc_mode_search_kernel(
    const float* __restrict__ blocks, const float* __restrict__ refs,
    int n_blocks, int* __restrict__ modes, float* __restrict__ costs) {
  constexpr int n = 1 << kLog2;
  using L = MsLayout<n>;
  __shared__ float ev_s[kMsWarps][L::kBlocks][L::kE];   // top: modes 18-34
  __shared__ float eh_s[kMsWarps][L::kBlocks][L::kE];   // left: modes 2-17
  __shared__ float t_s[kMsWarps][L::kBlocks * L::kT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = (blockIdx.x * kMsWarps + warp) * L::kBlocks;
  if (first >= n_blocks) return;               // the whole warp
  const int slot = lane >> kLog2;              // the warp's block
  const int r = lane & (n - 1);                // its row (column) here
  const int g = min(first + slot, n_blocks - 1);
  float* ev = ev_s[warp][slot];
  float* eh = eh_s[warp][slot];
  float* t = t_s[warp] + slot * L::kT;
  float row[n], col[n];
  const float* b = blocks + static_cast<long long>(g) * (n * n);
#pragma unroll
  for (int i = 0; i < n; ++i) {
    row[i] = __ldg(b + r * n + i);
    col[i] = __ldg(b + i * n + r);
  }
  // ev[n + j] = refs[2n + j], eh[n + j] = refs[2n - j], j in [0, 2n]
  const float* rf = refs + static_cast<long long>(g) * (4 * n + 1);
#pragma unroll
  for (int k = r; k <= 4 * n; k += n) {
    const float x = __ldg(rf + k);
    if (k >= 2 * n) ev[k - n] = x;
    if (k <= 2 * n) eh[3 * n - k] = x;
  }
  if (r == 0) {                                // read with weight 0 only
    ev[3 * n + 1] = 0.f;
    eh[3 * n + 1] = 0.f;
  }
  __syncwarp();
  float v[n];
  // planar: left L[i] = eh[n + 1 + i], top T[i] = ev[n + 1 + i]
  {
    const float ly = eh[n + 1 + r], ln = eh[2 * n + 1], tn = ev[2 * n + 1];
    const float base = static_cast<float>(n - 1) * ly + tn +
                       static_cast<float>(r + 1) * ln;
    const float d = tn - ly;
    const float cy = static_cast<float>(n - 1 - r);
#pragma unroll
    for (int x = 0; x < n; ++x)
      v[x] = __fmaf_rn(
          __fmaf_rn(cy, ev[n + 1 + x],
                    __fmaf_rn(static_cast<float>(x), d, base)),
          1.f / (2 * n), -row[x]);
  }
  float best = ms_satd<n>(v, t, r);
  int best_mode = 0;
  // DC: the mean of left[0..n-1] and top[0..n-1]
  {
    float dc = eh[n + 1 + r] + ev[n + 1 + r];
#pragma unroll
    for (int o = n / 2; o > 0; o >>= 1)
      dc += __shfl_xor_sync(0xffffffffu, dc, o);
    dc *= 1.f / (2 * n);
#pragma unroll
    for (int x = 0; x < n; ++x) v[x] = dc - row[x];
  }
  __syncwarp();
  ms_keep(ms_satd<n>(v, t, r), 1, best, best_mode);
#pragma unroll 1
  for (int m = 2; m < 18; ++m)
    ms_angular<n>(m, eh, ev, col, t, r, best, best_mode);
#pragma unroll 1
  for (int m = 18; m < kMsModes; ++m)
    ms_angular<n>(m, ev, eh, row, t, r, best, best_mode);
  if (r == 0 && first + slot < n_blocks) {
    modes[first + slot] = best_mode;
    costs[first + slot] = best;
  }
}

}  // namespace

extern "C" {

// blocks: (n_blocks, n^2) f32; refs: (n_blocks, 4n+1) f32; modes:
// (n_blocks,) int32; costs: (n_blocks,) f32; log2: 3, 4 or 5
int launch_hevc_mode_search(const void* blocks, const void* refs,
                            int n_blocks, int log2, void* modes, void* costs,
                            int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_blocks < 1 || log2 < 3 || log2 > 5) return kInvalid;
  const int per_cta = kMsWarps * (32 >> log2);
  const unsigned ctas = static_cast<unsigned>((n_blocks + per_cta - 1) /
                                              per_cta);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(blocks);
  const float* r = static_cast<const float*>(refs);
  int* mo = static_cast<int*>(modes);
  float* co = static_cast<float*>(costs);
  if (log2 == 3)
    hevc_mode_search_kernel<3><<<ctas, kMsThreads, 0, st>>>(b, r, n_blocks,
                                                            mo, co);
  else if (log2 == 4)
    hevc_mode_search_kernel<4><<<ctas, kMsThreads, 0, st>>>(b, r, n_blocks,
                                                            mo, co);
  else
    hevc_mode_search_kernel<5><<<ctas, kMsThreads, 0, st>>>(b, r, n_blocks,
                                                            mo, co);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
