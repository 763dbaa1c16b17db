// Hand-written Hopper (sm_90a) kernels of the HEVC intra reconstruction.
//
// The JAX package reconstructs HEVC intra pictures with one jnp program
// (libheif_tpu/codecs/hevc/device_recon.py, _build_program :519-982); it
// has no Pallas kernel.  Two of its four stages are kernels here:
//
//   hevc_dequant_itx  <- stage A, residuals (:540-567): dequantise, the
//                        column and row passes of the inverse DCT/DST as
//                        int32 matrix products, transform skip, bypass
//   hevc_intra_wave   <- stage B, one step of the lax.scan over waves
//                        (:890-927) with predict (:571-698) and the
//                        scatter into the flat sample buffers
//
// Stages C and D (deblocking, SAO) stay plain PyTorch.
//
// What bounds them on an H100:
//
// * hevc_dequant_itx reads the coefficient levels and writes the residuals,
//   4 + 4 bytes per sample, and does 2s multiply-adds per sample for an
//   s x s TU: device-memory bytes bound it.  One block of 256 threads
//   takes 256 samples (sixteen 4x4 TUs, four 8x8, one 16x16) or one 32x32
//   TU; the dequantised block and the column pass's output stay in shared
//   memory, beside the s x s matrix, so each sample is read and written
//   once.  The two passes read their operands along shared-memory rows
//   (consecutive lanes, consecutive addresses) and the matrix as a
//   broadcast.  All arithmetic is the jnp program's int32: the dequantise
//   product wraps as XLA's does, and every sum of a pass stays below 2^31.
//
// * hevc_intra_wave is bound by the chain of dependent waves, not by bytes:
//   a TU can only be predicted after the TUs its reference samples come
//   from, so a picture of 512x512 takes about 350 launches one after the
//   other, each with a few hundred to a few thousand TUs of a 48-tile
//   batch.  The design keeps each launch short: one warp per TU (four TUs
//   a block), so a TU's latency is that of one warp.  A warp gathers its
//   4n+1 reference samples into shared memory, substitutes the missing ones
//   with two ballots per 32 samples (no serial scan), filters them, and
//   predicts and reconstructs n*n/32 samples a lane.  The warp computes
//   its TU's (group, row) from the wave's per-group starts and counts,
//   which arrive as kernel parameters; there is no per-launch table.
//
// Every entry point takes the CUDA device index and stream last and returns
// the cudaError_t of its launch; it allocates nothing and does not
// synchronise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

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

constexpr int kItxThreads = 256;

template <int S>
__global__ void __launch_bounds__(kItxThreads)
hevc_dequant_itx_kernel(const int32_t* __restrict__ coeffs,
                        const int32_t* __restrict__ qp,
                        const uint8_t* __restrict__ ts,
                        const uint8_t* __restrict__ tqb,
                        const int32_t* __restrict__ mat,
                        int32_t* __restrict__ out, int n, int log2, int bd) {
  constexpr int SS = S * S;
  constexpr int P = SS >= kItxThreads ? 1 : kItxThreads / SS;  // TUs a block
  constexpr int E = P * SS;                                      // samples
  __shared__ int32_t sm[SS];    // the transform matrix m[i][j]
  __shared__ int32_t sd[E];     // dequantised levels d[t][i][k]
  __shared__ int32_t se[E];     // column pass e[t][j][k]
  const int tid = threadIdx.x;
  for (int i = tid; i < SS; i += kItxThreads) sm[i] = mat[i];
  const long long tu0 = static_cast<long long>(blockIdx.x) * P;
  // (c*16*scale + 2^(bs-1)) >> bs  ==  (c*scale + 2^(bs-5)) >> (bs-4)
  const int bs = bd + log2 - 5;
  const uint32_t rnd1 = 1u << (bs - 5);
  for (int e = tid; e < E; e += kItxThreads) {
    const long long t = tu0 + e / SS;
    int d = 0;
    if (t < n) {
      const int q = qp[t];
      const int scale = kLevelScale[q % 6] << (q / 6);
      // int32 product and sum wrap as in XLA
      const uint32_t u = static_cast<uint32_t>(coeffs[t * SS + e % SS]) *
                             static_cast<uint32_t>(scale) + rnd1;
      d = clip16(static_cast<int32_t>(u) >> (bs - 4));
    }
    sd[e] = d;
  }
  __syncthreads();
  // column pass: e[j][k] = sum_i m[i][j] d[i][k]
  for (int e = tid; e < E; e += kItxThreads) {
    const int b = (e / SS) * SS, j = (e / S) % S, k = e % S;
    int acc = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) acc += sm[i * S + j] * sd[b + i * S + k];
    se[e] = clip16((acc + 64) >> 7);
  }
  __syncthreads();
  // row pass: r[i][k] = sum_j e[i][j] m[j][k]; then transform skip (4x4)
  // and transquant bypass replace it
  const int shift2 = 20 - bd;
  for (int e = tid; e < E; e += kItxThreads) {
    const long long t = tu0 + e / SS;
    if (t >= n) continue;
    const int b = (e / SS) * SS, i = (e / S) % S, k = e % S;
    int acc = 0;
#pragma unroll
    for (int j = 0; j < S; ++j) acc += se[b + i * S + j] * sm[j * S + k];
    int r = clip16((acc + (1 << (shift2 - 1))) >> shift2);
    if (S == 4 && ts[t])
      r = ((sd[e] << (5 + log2)) + (1 << (shift2 - 1))) >> shift2;
    if (tqb[t]) r = coeffs[t * SS + e % SS];
    out[t * SS + e % SS] = r;
  }
}

template <int S>
void itx_launch(int n, cudaStream_t s, const int32_t* coeffs,
                const int32_t* qp, const uint8_t* ts, const uint8_t* tqb,
                const int32_t* mat, int32_t* out, int log2, int bd) {
  constexpr int P = S * S >= kItxThreads ? 1 : kItxThreads / (S * S);
  hevc_dequant_itx_kernel<S><<<(n + P - 1) / P, kItxThreads, 0, s>>>(
      coeffs, qp, ts, tqb, mat, out, n, log2, bd);
}

// -------------------------------------------------------- hevc_intra_wave

constexpr int kMaxGroups = 7;
constexpr int kWaveWarps = 4;            // TUs a block, one warp each
constexpr int kMaxRefs = 4 * 32 + 1;     // reference samples of a 32x32 TU
constexpr int kRefChunks = (kMaxRefs + 31) / 32;

struct WaveGroup {
  const int32_t* ref_idx;    // (rows, 4n+1) flat indices into the buffer
  const uint8_t* ref_avail;  // (rows, 4n+1) bool
  const int32_t* mode;       // (rows,)
  const int32_t* scat;       // (rows, n*n) flat indices into the buffer
  const int32_t* res;        // (rows, n*n) residuals
  int log2, luma, start, count;
};

struct WaveArgs {
  WaveGroup g[kMaxGroups];
  int cum[kMaxGroups + 1];   // TUs of the wave before group k (the
                             // wave's total from n_groups on)
  int n_groups;
  int32_t* ybuf;
  int32_t* cbuf;
  int bd, strong;
};

__global__ void __launch_bounds__(kWaveWarps * 32)
hevc_intra_wave_kernel(const WaveArgs a) {
  __shared__ int s_raw[kWaveWarps][kMaxRefs];
  __shared__ int s_val[kWaveWarps][kMaxRefs];
  __shared__ int s_flt[kWaveWarps][kMaxRefs];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWaveWarps + warp;
  if (w >= a.cum[kMaxGroups]) return;           // the whole warp
  // this warp's group: the last whose first TU is at or before w (the
  // loop indexes the parameters with constants only)
  WaveGroup G = a.g[0];
  int first_w = 0;
#pragma unroll
  for (int k = 1; k < kMaxGroups; ++k) {
    if (k < a.n_groups && w >= a.cum[k]) {
      G = a.g[k];
      first_w = a.cum[k];
    }
  }
  const long long row = G.start + (w - first_w);
  const int log2 = G.log2, n = 1 << log2, L = 4 * n + 1, ci = 2 * n;
  int32_t* buf = G.luma ? a.ybuf : a.cbuf;
  const int mode = G.mode[row];
  int* raw = s_raw[warp];
  int* val = s_val[warp];
  const int half = 1 << (a.bd - 1), maxv = (1 << a.bd) - 1;

  // 1. gather the available reference samples
  const int32_t* ridx = G.ref_idx + row * L;
  const uint8_t* rav = G.ref_avail + row * L;
  unsigned masks[kRefChunks];
#pragma unroll
  for (int c = 0; c < kRefChunks; ++c) {
    const int j = c * 32 + lane;
    bool av = false;
    if (j < L) {
      av = rav[j] != 0;
      if (av) raw[j] = buf[ridx[j]];
    }
    masks[c] = __ballot_sync(0xffffffffu, av);
  }
  __syncwarp();

  // 2. substitution: a missing sample takes the nearest available one
  // before it, else the first available one; none available: half range
  int first = -1;
#pragma unroll
  for (int c = kRefChunks - 1; c >= 0; --c)
    if (masks[c]) first = c * 32 + __ffs(masks[c]) - 1;
  int prev = -1;
#pragma unroll
  for (int c = 0; c < kRefChunks; ++c) {
    const int j = c * 32 + lane;
    const unsigned upto = masks[c] & ((2u << lane) - 1u);
    int src = upto ? c * 32 + 31 - __clz(upto) : prev;
    if (src < 0) src = first;
    if (j < L) val[j] = first < 0 ? half : raw[src];
    if (masks[c]) prev = c * 32 + 31 - __clz(masks[c]);
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
      int* flt = s_flt[warp];
      for (int j = lane; j < L; j += 32) {
        int v = val[j];
        if (bil) {
          const int rel = j - ci, ab = abs(rel);
          if (ab >= 1 && ab <= 2 * n - 1)
            v = ((2 * n - ab) * val[ci] + ab * (rel > 0 ? val[4 * n] : val[0])
                 + n) >> (log2 + 1);
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

  // 4. predict, add the residual, clip, scatter
  int dc = 0;
  if (mode == 1) {
    int s = 0;
    for (int i = lane; i < n; i += 32) s += top(i) + left(i);
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    dc = (s + n) >> (log2 + 1);
  }
  const int m = min(max(mode, 0), 34);
  const int angle = kIntraAngle[m], inv = kInvAngle[m];
  const bool vertical = mode >= 18;
  // the projected reference line: ext(e) = ref[e - n], e in [0, 3n]
  auto ext = [&](int e) {
    if (e > n) return vertical ? top(e - n - 1) : left(e - n - 1);
    if (e == n) return corner;
    const int nidx = ((e - n) * inv + 128) >> 8;
    if (nidx == 0) return corner;
    const int sidx = min(max(nidx - 1, 0), 2 * n - 1);
    return vertical ? left(sidx) : top(sidx);
  };
  const bool edge = G.luma && n < 32;
  const int32_t* res = G.res + row * n * n;
  const int32_t* scat = G.scat + row * n * n;
  for (int p = lane; p < n * n; p += 32) {
    const int x = p & (n - 1), y = p >> log2;
    int pred;
    if (mode == 0) {
      pred = ((n - 1 - x) * left(y) + (x + 1) * top(n) +
              (n - 1 - y) * top(x) + (y + 1) * left(n) + n) >> (log2 + 1);
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
      pred = ((32 - fact) * ext(i0) + fact * ext(i1) + 16) >> 5;
      if (edge && mode == 26 && x == 0)
        pred = min(max(top(0) + ((left(y) - corner) >> 1), 0), maxv);
      if (edge && mode == 10 && y == 0)
        pred = min(max(left(0) + ((top(x) - corner) >> 1), 0), maxv);
    }
    buf[scat[p]] = min(max(pred + res[p], 0), maxv);
  }
}

}  // namespace

extern "C" {

int launch_hevc_dequant_itx(const void* coeffs, const void* qp,
                            const void* ts, const void* tqb, const void* mat,
                            void* out, int n, int log2, int bd, int device,
                            void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n <= 0) return 0;
  if (bd < 8 || bd > 16) return kInvalid;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int32_t*>(coeffs);
  const auto* q = static_cast<const int32_t*>(qp);
  const auto* t = static_cast<const uint8_t*>(ts);
  const auto* b = static_cast<const uint8_t*>(tqb);
  const auto* m = static_cast<const int32_t*>(mat);
  auto* o = static_cast<int32_t*>(out);
  switch (log2) {
    case 2: itx_launch<4>(n, s, c, q, t, b, m, o, log2, bd); break;
    case 3: itx_launch<8>(n, s, c, q, t, b, m, o, log2, bd); break;
    case 4: itx_launch<16>(n, s, c, q, t, b, m, o, log2, bd); break;
    case 5: itx_launch<32>(n, s, c, q, t, b, m, o, log2, bd); break;
    default: return kInvalid;
  }
  return static_cast<int>(cudaGetLastError());
}

// groups: n_groups rows of 9 values (ref_idx, ref_avail, mode, scat, res
// addresses; log2, luma, first row of the wave, TUs of the wave)
int launch_hevc_intra_wave(const long long* groups, int n_groups,
                           void* ybuf, void* cbuf, int bd, int strong,
                           int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_groups < 1 || n_groups > kMaxGroups || bd < 8 || bd > 16)
    return kInvalid;
  WaveArgs a{};
  a.n_groups = n_groups;
  a.ybuf = static_cast<int32_t*>(ybuf);
  a.cbuf = static_cast<int32_t*>(cbuf);
  a.bd = bd;
  a.strong = strong;
  long long total = 0;
  for (int k = 0; k < n_groups; ++k) {
    const long long* v = groups + 9 * k;
    WaveGroup& g = a.g[k];
    g.ref_idx = reinterpret_cast<const int32_t*>(v[0]);
    g.ref_avail = reinterpret_cast<const uint8_t*>(v[1]);
    g.mode = reinterpret_cast<const int32_t*>(v[2]);
    g.scat = reinterpret_cast<const int32_t*>(v[3]);
    g.res = reinterpret_cast<const int32_t*>(v[4]);
    g.log2 = static_cast<int>(v[5]);
    g.luma = static_cast<int>(v[6]);
    g.start = static_cast<int>(v[7]);
    g.count = static_cast<int>(v[8]);
    if (g.log2 < 2 || g.log2 > 5 || g.count < 0) return kInvalid;
    a.cum[k] = static_cast<int>(total);
    total += g.count;
  }
  if (total > (1LL << 30)) return kInvalid;
  for (int k = n_groups; k <= kMaxGroups; ++k)
    a.cum[k] = static_cast<int>(total);
  if (total == 0) return 0;
  const int blocks = static_cast<int>((total + kWaveWarps - 1) / kWaveWarps);
  hevc_intra_wave_kernel<<<blocks, kWaveWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
