// Hand-written Hopper (sm_90a) kernels of the JPEG reconstruction and, at
// the end of the file, of the encoder's forward DCT and quantiser
// (jpeg_fdct_quant, with its own notes).
//
// Replaces: the JAX package reconstructs JPEG with one jnp program a
// component, _recon_program (libheif_tpu/codecs/jpeg/decoder.py:500-528):
// dequantise with the natural-order table, de-zigzag, the islow IDCT
// (codecs/jpeg/idct.py idct8x8_islow :79-97, IJG jidctint.c), +128, clip,
// and reassembly of the blocks into the plane.  It has no Pallas kernel.
// Here that is one kernel, one launch for every component plane of every
// tile of a batch:
//
//   jpeg_dequant_idct  <- _recon_program + idct8x8_islow
//
// Bounds.  Bytes: a block reads 128 bytes of coefficients and writes 64
// samples; the 4032x3024 photo's 294,912 blocks move 56.6 MB, 0.0169 ms at
// 3.35 TB/s.  Operations: ~16 int32 operations a sample (the dequantising
// product, two 1-D butterflies, the clip); an H100 SM has 64 INT32 lanes,
// so the same photo needs ~0.018 ms at 132 SMs x 64 x 1.98 GHz.  The two
// are about equal: the kernel has to keep its loads in flight and spend
// few instructions a sample.
//
// Design.
// 1. A CTA (two warps) takes up to kTileBlocks consecutive blocks of one
//    block row of one job (a component plane): a job's CTAs walk its block
//    rows, ceil(width / (8 kTileBlocks)) a row.  A warp finds its CTA's
//    job by a 32-way search of the jobs' first CTAs (two rounds of one
//    load for up to 1,024 jobs), then loads its job row of 8 int32
//    (output address, pitch, crop, quantisation row, first block,
//    blocks_w): one division gives its block row and column.  The
//    wrapper's tables are 36 bytes a job and nothing a CTA, so their copy
//    to the card stays short.  Only the coefficient and output addresses
//    are 64-bit.  Blocks outside the crop get no CTA.  (A persistent grid
//    that fetched the next tile during this one was no faster on the card;
//    it needs 80 registers.)
// 2. The CTA's first act after that is to put all its coefficients in
//    flight: every lane issues one 16-byte cp.async a pass (four passes,
//    one commit group each) into shared memory, then loads its
//    quantisation column and its gather offsets while they land; each
//    pass waits only for its own group.
// 3. No __constant__ indexing.  Eight threads a block: thread c
//    dequantises and transforms column c, so its eight table entries and
//    eight gather offsets are fixed for the CTA's life and held in
//    registers, loaded once from global memory (the offsets from
//    kGather, computed at compile time from kInvZigzag, as two 16-byte
//    vectors).  The 16-byte chunks of the four blocks of a warp are
//    XOR-swizzled (0, 2, 5, 7), so the column gathers touch fewer banks
//    twice than any padding does; the transposed work array (rows of 12
//    words, blocks of 104, two of them by pass parity) makes the column
//    pass's 16-byte stores and the row pass's loads free of bank conflicts
//    and needs one warp barrier a pass fewer.
// 4. Row-wide stores: thread r packs its row's eight samples into two
//    words by saturating conversions to [-128, 127] (cvt.pack.sat.s8, two
//    samples an instruction) and an xor with 0x80 for the +128, and writes
//    them as one 8-byte store; a warp's four blocks are adjacent, so each
//    store instruction writes 32 contiguous bytes of each of eight pixel
//    rows.  Views at an unaligned address or pitch, and tiles that are
//    short or cut by the crop, take a masked byte path (a separate
//    function); the choice is made once a CTA.
// 5. Few instructions a sample: 32-bit indices; the descale's rounding
//    constant is added once, to tmp0 and tmp1 (all sums wrap modulo 2^32,
//    so this gives the same bits), folding into the multiply-adds; the
//    crop and alignment tests are hoisted out of the sample work.  The
//    arithmetic is the jnp program's int32 with wraparound: products and
//    sums in uint32, cast to int32 only for the arithmetic right shift
//    (16-bit quantisation tables overflow int32).
//
// ptxas -v (sm_90a, CUDA 12.8): 48 registers at 64 threads, 10,752 bytes
// of shared memory, a 0-byte stack, no spills.

// The entry point takes the CUDA device index and stream last and returns
// the cudaError_t of its launch; it allocates nothing and does not
// synchronise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
constexpr int kTileBlocks = 32;  // TILE_BLOCKS in cuda_fast.py
constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kPassBlocks = 4 * kWarps;  // blocks a CTA computes at once
constexpr int kPasses = kTileBlocks / kPassBlocks;
constexpr int kJobCols = 8;      // JOB_COLS in cuda_fast.py
constexpr int kJobVecs = kJobCols / 4;  // int4 loads a job row
// the transposed work array: a block's column c is row c of 12 words
constexpr int kWorkRow = 12;
constexpr int kWorkBlock = 8 * kWorkRow + 8;

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int kShift1 = kConstBits - kPass1Bits;
constexpr int kShift2 = kConstBits + kPass1Bits + 3;

// natural position -> zigzag index (tables.py INV_ZIGZAG)
constexpr int kInvZigzag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

// the XOR swizzle of the 16-byte chunks of the block in warp slot b
__host__ __device__ constexpr int swizzle(int b) {
  return (0x7520 >> (4 * b)) & 7;
}

// v[b][c * 8 + r]: byte offset of the coefficient at (row r, column c) in
// the swizzled shared copy of the block in warp slot b; a thread loads its
// eight as two 16-byte vectors, once
struct alignas(16) GatherOffsets {
  int v[4][64];
};
constexpr GatherOffsets gather_offsets() {
  GatherOffsets g{};
  for (int b = 0; b < 4; ++b)
    for (int c = 0; c < 8; ++c)
      for (int r = 0; r < 8; ++r) {
        const int z = kInvZigzag[r * 8 + c];
        g.v[b][c * 8 + r] = 2 * ((((z >> 3) ^ swizzle(b)) << 3) | (z & 7));
      }
  return g;
}
__device__ const GatherOffsets kGather = gather_offsets();

#ifndef TORCH_CUDA_EMU  // tests/torch_cuda_emu.h defines these for g++
// 16 bytes from global to shared memory, asynchronously (L2 only)
__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of this thread's commit groups are still in flight
// (n a constant once the pass loop is unrolled)
__device__ __forceinline__ void copy_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}
// (c << 16) | sat_s8(a) << 8 | sat_s8(b): two samples saturated to
// [-128, 127] and packed as bytes above c's low half
__device__ __forceinline__ unsigned pack_sat_s8(int a, int b, unsigned c) {
  unsigned d;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c));
  return d;
}
#endif
static_assert(kPasses <= 4, "copy_async_wait takes at most 3 later groups");

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

// idct.py _idct_1d (jidctint.c pass body), in place on c[0..7], each
// output descaled: (x + 2^(shift-1)) >> shift with the sum wrapping.  The
// rounding constant rides on tmp0 and tmp1, which every output holds once.
template <int kShift>
__device__ __forceinline__ void idct_1d(int* c) {
  constexpr int kRound = 1 << (kShift - 1);
  int z1 = mulw(addw(c[2], c[6]), 4433);               // FIX_0_541196100
  const int tmp2 = addw(z1, mulw(c[6], -15137));       // FIX_1_847759065
  const int tmp3 = addw(z1, mulw(c[2], 6270));         // FIX_0_765366865
  const int tmp0 = addw(mulw(addw(c[0], c[4]), 1 << kConstBits), kRound);
  const int tmp1 = addw(mulw(subw(c[0], c[4]), 1 << kConstBits), kRound);
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
  c[0] = addw(tmp10, t3) >> kShift;
  c[1] = addw(tmp11, t2) >> kShift;
  c[2] = addw(tmp12, t1) >> kShift;
  c[3] = addw(tmp13, t0) >> kShift;
  c[4] = subw(tmp13, t0) >> kShift;
  c[5] = subw(tmp12, t1) >> kShift;
  c[6] = subw(tmp11, t2) >> kShift;
  c[7] = subw(tmp10, t3) >> kShift;
}

// four samples before the level shift -> four bytes of clip(v + 128):
// saturated to [-128, 127], then 0x80 flips each byte to v + 128
__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return pack_sat_s8(b, a, pack_sat_s8(d, c, 0)) ^ 0x80808080u;
}

// the masked path: the part of a row of eight samples that lies inside
// the crop (row y of a plane oh high, columns x.. of one ow wide), a byte
// at a time, at any alignment
__device__ __noinline__ void store_masked(uint8_t* out, unsigned lo,
                                          unsigned hi, int y, int oh, int x,
                                          int ow) {
  if (y >= oh) return;
  const int n = min(8, ow - x);
  for (int k = 0; k < n; ++k)
    out[k] = static_cast<uint8_t>((k < 4 ? lo >> (8 * k)
                                         : hi >> (8 * (k - 4))) & 0xff);
}

// the job of CTA t: the last whose first CTA is at most t (they ascend
// from 0), by a 32-way search of the warp: each round its lanes test 32
// evenly spaced candidates, so ceil(log32(n_jobs)) rounds of one load
__device__ __forceinline__ int find_job(const int* __restrict__ first_cta,
                                        int n_jobs, int t, int lane) {
  int lo = 0, n = n_jobs;
  while (n > 1) {
    const int step = (n + 31) >> 5;
    const unsigned le = __ballot_sync(
        0xffffffffu,
        lane * step < n && __ldg(first_cta + lo + lane * step) <= t);
    const int k = 31 - __clz(le);  // lane 0's candidate, lo, always holds
    lo += k * step;
    n = min(step, n - k * step);
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
jpeg_dequant_idct_kernel(const int16_t* __restrict__ coeffs,
                         const int32_t* __restrict__ quant,
                         const int4* __restrict__ jobs,
                         const int* __restrict__ first_cta, int n_jobs) {
  __shared__ __align__(16) int16_t coef_s[kTileBlocks][64];
  // a warp's work array, two of them so that a pass's row reads never
  // wait for the next pass's column writes
  __shared__ __align__(16) int work_s[kWarps][2][4 * kWorkBlock];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = lane >> 3;      // the warp's block this lane works on
  const int c = lane & 7;          // its column (pass 1) and row (pass 2)

  // the job (the warp's search, then its row), then this CTA's
  // coefficients in flight before any other work
  const int j = find_job(first_cta, n_jobs, blockIdx.x, lane);
  // out lo, out hi, pitch, ow | oh, quant row, first block, blocks_w
  const int4 job = __ldg(jobs + kJobVecs * j);
  const int4 job2 = __ldg(jobs + kJobVecs * j + 1);
  const int per_row = (job.w + 8 * kTileBlocks - 1) / (8 * kTileBlocks);
  const int t = static_cast<int>(blockIdx.x) - __ldg(first_cta + j);
  const int by = t / per_row;
  const int bx0 = (t - by * per_row) * kTileBlocks;
  const int nb = min(kTileBlocks, (job.w + 7) / 8 - bx0);
  const int16_t* src = coeffs + c * 8 +
      static_cast<long long>(job2.z + by * job2.w + bx0) * 64;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int k = p * kPassBlocks + warp * 4 + slot;
    if (k < nb)
      copy_async16(&coef_s[k][(c ^ swizzle(slot)) * 8], src + k * 64);
    copy_async_commit();
  }

  // this column's table entries and gather offsets
  const int oh = job2.x;
  const int32_t* q = quant + job2.y * 64 + c;
  int qv[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) qv[r] = __ldg(q + r * 8);
  const int4 g0 = __ldg(reinterpret_cast<const int4*>(kGather.v[slot]) +
                        2 * c);
  const int4 g1 = __ldg(reinterpret_cast<const int4*>(kGather.v[slot]) +
                        2 * c + 1);
  const char* blk = reinterpret_cast<const char*>(coef_s[warp * 4 + slot]);
  const int16_t* gp[8] = {
      reinterpret_cast<const int16_t*>(blk + g0.x),
      reinterpret_cast<const int16_t*>(blk + g0.y),
      reinterpret_cast<const int16_t*>(blk + g0.z),
      reinterpret_cast<const int16_t*>(blk + g0.w),
      reinterpret_cast<const int16_t*>(blk + g1.x),
      reinterpret_cast<const int16_t*>(blk + g1.y),
      reinterpret_cast<const int16_t*>(blk + g1.z),
      reinterpret_cast<const int16_t*>(blk + g1.w)};
  const int y = by * 8 + c;        // this thread's pixel row in pass 2
  const int x = (bx0 + warp * 4 + slot) * 8;
  uint8_t* out = reinterpret_cast<uint8_t*>(
                     (static_cast<unsigned long long>(
                          static_cast<unsigned>(job.y)) << 32) |
                     static_cast<unsigned>(job.x)) +
                 static_cast<long long>(y) * job.z + x;
  // whole tiles of aligned views take 8-byte stores, the rest bytes
  const bool fast = ((job.x | job.z) & 7) == 0 && by * 8 + 8 <= oh &&
                    nb == kTileBlocks && (bx0 + nb) * 8 <= job.w;

#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    if (p * kPassBlocks >= nb) continue;           // the same for the CTA
    copy_async_wait(kPasses - 1 - p);
    __syncwarp();
    // pass 1: dequantise and transform column c, store it as row c (a
    // lane whose block is past the tile's end works on stale data and
    // stores nothing)
    int v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      v[r] = mulw(gp[r][p * kPassBlocks * 64], qv[r]);
    idct_1d<kShift1>(v);
    int* w = work_s[warp][p & 1] + slot * kWorkBlock;
    reinterpret_cast<int4*>(w + c * kWorkRow)[0] =
        make_int4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<int4*>(w + c * kWorkRow)[1] =
        make_int4(v[4], v[5], v[6], v[7]);
    __syncwarp();
    // pass 2: transform row c, level shift, clip, store
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = w[i * kWorkRow + c];
    idct_1d<kShift2>(v);
    const unsigned lo = pack4(v[0], v[1], v[2], v[3]);
    const unsigned hi = pack4(v[4], v[5], v[6], v[7]);
    uint8_t* o = out + p * kPassBlocks * 8;
    if (fast)
      *reinterpret_cast<uint2*>(o) = make_uint2(lo, hi);
    else if (p * kPassBlocks + warp * 4 + slot < nb)
      store_masked(o, lo, hi, y, oh, x + p * kPassBlocks * 8, job.w);
  }
}


// ------------------------------------------------------------- encode side
//
// jpeg_fdct_quant <- _fdct_quant_program + fdct8x8_islow + _quantize
// (libheif_tpu/codecs/jpeg/encoder.py:45-84, codecs/jpeg/idct.py:100-154):
// the islow forward DCT x8 (jfdctint.c), division by 8 Q with rounding half
// away from zero, and the zigzag reorder, for every component plane of an
// image in one launch.
//
// Bounds.  Bytes: a block reads its 64 samples once and writes 64 int16
// coefficients: the 4032x3024 4:2:0 photo's 285,768 blocks move 54.9 MB,
// 0.0164 ms at 3.35 TB/s.  Operations: the two 1-D passes take 59 int32
// operations each for eight samples (14.75 a sample), the level shift one
// a row (on the row pass's DC term, 1/8 a sample) and the quantiser five
// (abs, add, multiply-high, negate, select): 19.875 a sample, 0.0217 ms
// for the photo at 132 SMs x 64 INT32 lanes x 1.98 GHz.  The function is bound by its operations, so the
// kernel has to spend few instructions beyond them and few on memory.
//
// Design.
// 1. One job a CTA tile.  A CTA of kFqWarps warps takes a tile of one job
//    (a component plane), kFqTileW blocks across by kFqTileH block rows,
//    each warp 8 x 4 of them, a thread a whole block.  The job table gives
//    each job its first CTA; a warp finds its CTA's job by one 32-wide
//    ballot over the jobs' first CTAs (a round for each 32 jobs), and the
//    tile's place is the CTA's index less that first CTA, one division a
//    CTA by the job's tiles across.  No search or division a block.
// 2. Wide loads.  A thread loads each of its block's eight rows as one
//    8-byte word, straight into registers: a warp's load instruction reads
//    four 64-byte runs of one pixel row each, whole 32-byte sectors, and
//    nothing passes through shared memory.  Blocks that reach past the
//    plane (the MCU grid's padding, odd 4:2:0 chroma) or a view whose
//    address or pitch is not a multiple of 8 take a byte path with clamped
//    coordinates (the edge replication of the JAX encoder.py's _pad_to,
//    without a padded copy); the choice is a thread's, so an edge costs
//    only its own warps and views at odd offsets go through the same
//    launch.
// 3. Both passes and the quantiser in registers: the row pass on the 64
//    samples, the column pass, then each coefficient's quantisation, all
//    at compile-time register indices; the level shift is folded into the
//    DC term of the row pass (-8 x 128 before its shift: the other outputs
//    are differences).  The zigzag reorder is a compile-time pairing of
//    the 64 coefficients into 32 words (fq_zigzag, one byte_perm a word):
//    no table is read for it.
// 4. Coalesced stores.  A thread's 128 bytes of coefficients go to shared
//    memory as eight 16-byte vectors (kFqOutRow = 36 words a block, free
//    of bank conflicts), and the warp writes its 32 blocks four whole
//    blocks (512 contiguous bytes) a store instruction.  Storing each
//    thread's 128 bytes straight to device memory made every store
//    instruction touch 32 separate lines, and held the kernel at the
//    first form's time (codecs/jpeg/kernel_times.py).  kFqMinCtas caps the
//    registers so that six CTAs share an SM.
// 5. The exact reciprocal quantiser: the CTA's first 64 threads turn the
//    job's quantiser steps q = 8 Q into q / 2 and m = (2^32 - 1) / q + 1 in
//    shared memory while the tile's loads are in flight.  For 0 <= x <
//    2^17, __umulhi(x, m) is x / q exactly (m q - 2^32 lies in [0, q), so
//    x m / 2^32 exceeds x / q by less than x / 2^32 < 2^-15 <= 1 / q, which
//    cannot carry x / q, whose fraction is at most 1 - 1 / q, past an
//    integer), for q <= 2^15, i.e. Q <= 4,095; the coefficients' magnitudes
//    stay at most 2^16 and q / 2 at most 16,380, so every x does.  A
//    coefficient's q / 2 and m are broadcast loads at a compile-time place.
//
// Measured (codecs/jpeg/kernel_times.py on an H100 80GB HBM3 at a 700 W
// power limit, the photo's three planes): the kernel alone 0.0253 ms, 86%
// of the op bound (the first form, a thread a row, a binary search and a
// division a block, byte loads and a global zigzag table: 0.0464 ms); the
// call with its table copy 0.0290 ms; 29.3 SASS instructions a sample;
// ptxas 80 registers, 18,944 bytes of shared memory, 36 bytes of spill
// stores and 20 of spill loads (a 24-byte stack frame): still faster than
// the same kernel at 95 registers without spills, five CTAs an SM
// (0.0254 against 0.0262 ms in one call).

constexpr int kFqJobCols = 12;   // FQ_JOB_COLS in cuda_fast.py
constexpr int kFqWarps = 4;
constexpr int kFqThreads = 32 * kFqWarps;
constexpr int kFqTileW = 8;              // FQ_TILE_W: blocks across a tile
constexpr int kFqTileH = 4 * kFqWarps;   // FQ_TILE_H: block rows a tile
constexpr int kFqMinCtas = 6;            // resident an SM: <= 85 registers
constexpr int kFqMaxTables = 4;
constexpr int kLevelDc = 8 * 128;        // the level shift's sum in a row
constexpr int kFqOutRow = 36;            // words a block in out_s

// zigzag index -> natural position (tables.py ZIGZAG)
__host__ __device__ constexpr int fq_zigzag(int z) {
  constexpr int zz[64] = {
      0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
      12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
      35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
      58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
  return zz[z];
}
static_assert(fq_zigzag(2) == 8 && fq_zigzag(63) == 63, "ZIGZAG");

#ifndef TORCH_CUDA_EMU  // tests/torch_cuda_emu.h defines these for g++
// eight bytes at an 8-byte aligned global address, read-only path
__device__ __forceinline__ uint2 load_global_v2u(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
// 16 bytes to an aligned global address in one instruction
__device__ __forceinline__ void store_global_v4(int32_t* p, int a, int b,
                                                int c, int d) {
  asm volatile("st.global.v4.s32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
#endif

__device__ __forceinline__ int fq_descale(int x, int n) {
  return (x + (1 << (n - 1))) >> n;
}

// idct.py _fdct_1d (jfdctint.c pass body) in place on v[0], v[s], ...,
// v[7s]; the row pass (kFirst) keeps kPass1Bits of headroom and takes
// unshifted samples, the level shift applied to its DC output alone.
// 8-bit samples keep every product and sum far inside int32.
template <bool kFirst, int s>
__device__ __forceinline__ void fdct_1d(int* v) {
  const int tmp0 = v[0] + v[7 * s], tmp7 = v[0] - v[7 * s];
  const int tmp1 = v[s] + v[6 * s], tmp6 = v[s] - v[6 * s];
  const int tmp2 = v[2 * s] + v[5 * s], tmp5 = v[2 * s] - v[5 * s];
  const int tmp3 = v[3 * s] + v[4 * s], tmp4 = v[3 * s] - v[4 * s];
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  constexpr int sh = kFirst ? kConstBits - kPass1Bits
                            : kConstBits + kPass1Bits;
  if (kFirst) {
    v[0] = (tmp10 + tmp11 - kLevelDc) << kPass1Bits;
    v[4 * s] = (tmp10 - tmp11) << kPass1Bits;
  } else {
    v[0] = fq_descale(tmp10 + tmp11, kPass1Bits);
    v[4 * s] = fq_descale(tmp10 - tmp11, kPass1Bits);
  }
  int z1 = (tmp12 + tmp13) * 4433;                     // FIX_0_541196100
  v[2 * s] = fq_descale(z1 + tmp13 * 6270, sh);       // FIX_0_765366865
  v[6 * s] = fq_descale(z1 + tmp12 * -15137, sh);     // FIX_1_847759065
  z1 = tmp4 + tmp7;
  int z2 = tmp5 + tmp6;
  int z3 = tmp4 + tmp6;
  int z4 = tmp5 + tmp7;
  const int z5 = (z3 + z4) * 9633;                     // FIX_1_175875602
  const int t4 = tmp4 * 2446;                          // FIX_0_298631336
  const int t5 = tmp5 * 16819;                         // FIX_2_053119869
  const int t6 = tmp6 * 25172;                         // FIX_3_072711026
  const int t7 = tmp7 * 12299;                         // FIX_1_501321110
  z1 = z1 * -7373;                                     // FIX_0_899976223
  z2 = z2 * -20995;                                    // FIX_2_562915447
  z3 = z3 * -16069 + z5;                               // FIX_1_961570560
  z4 = z4 * -3196 + z5;                                // FIX_0_390180644
  v[7 * s] = fq_descale(t4 + z1 + z3, sh);
  v[5 * s] = fq_descale(t5 + z2 + z4, sh);
  v[3 * s] = fq_descale(t6 + z2 + z3, sh);
  v[s] = fq_descale(t7 + z1 + z4, sh);
}

// o[w] = coefficients 2w and 2w + 1 of the zigzag order, as int16 halves
template <int w>
__device__ __forceinline__ void fq_pack(const int* c, unsigned* o) {
  constexpr int a = fq_zigzag(2 * w), b = fq_zigzag(2 * w + 1);
  o[w] = __byte_perm(static_cast<unsigned>(c[a]), static_cast<unsigned>(c[b]),
                     0x5410);
  if constexpr (w + 1 < 32) fq_pack<w + 1>(c, o);
}

// jobs: n_jobs rows of kFqJobCols int32 (plane address low and high words,
// pitch, width, height, blocks_w, blocks_h, table, first output block,
// tiles across, 0, 0), then each job's first CTA, ascending from 0; quant:
// (n_tables, 64) int32 natural order, 1 <= Q <= 4,095; out: (n_blocks, 64)
// int16 zigzag, 16-byte aligned
__global__ void __launch_bounds__(kFqThreads, kFqMinCtas)
    jpeg_fdct_quant_kernel(
    const int4* __restrict__ jobs, const int* __restrict__ first_cta,
    int n_jobs, const int32_t* __restrict__ quant,
    int16_t* __restrict__ out) {
  __shared__ int half_s[64];                 // 4 Q
  __shared__ unsigned recip_s[64];           // of 8 Q
  // each thread's 32 words of coefficients, kFqOutRow words apart (its
  // 16-byte accesses free of bank conflicts), for the coalesced stores
  __shared__ __align__(16) unsigned out_s[kFqWarps][32][kFqOutRow];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cta = static_cast<int>(blockIdx.x);
  // the CTA's job: the last whose first CTA is <= cta (first CTAs ascend,
  // so those form a prefix)
  int job = 0;
  for (int base = 0; base < n_jobs; base += 32) {
    const int i = base + lane;
    const unsigned le =
        __ballot_sync(0xffffffffu, i < n_jobs && __ldg(first_cta + i) <= cta);
    if (le != 0) job = base + 31 - __clz(le);
    if (le != 0xffffffffu) break;
  }
  const int4 j0 = __ldg(jobs + 3 * job), j1 = __ldg(jobs + 3 * job + 1),
             j2 = __ldg(jobs + 3 * job + 2);
  const unsigned long long addr =
      (static_cast<unsigned long long>(static_cast<unsigned>(j0.y)) << 32) |
      static_cast<unsigned>(j0.x);
  const uint8_t* plane = reinterpret_cast<const uint8_t*>(addr);
  const int pitch = j0.z, w = j0.w, h = j1.x;
  const int t = cta - __ldg(first_cta + job);
  const int ty = t / j2.y, tx = t - ty * j2.y;          // j2.y: tiles across
  const int bx = tx * kFqTileW + (lane & 7);
  const int by = ty * kFqTileH + warp * 4 + (lane >> 3);
  const bool live = bx < j1.y && by < j1.z;
  const bool fast = live && ((addr | static_cast<unsigned>(pitch)) & 7) == 0 &&
                    bx * 8 + 8 <= w && by * 8 + 8 <= h;
  uint2 rows[8];
  if (fast) {
    const uint8_t* p = plane + static_cast<long long>(by * 8) * pitch + bx * 8;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      rows[r] = load_global_v2u(p + static_cast<long long>(r) * pitch);
  }
  if (threadIdx.x < 64) {
    const int q = __ldg(quant + j1.w * 64 + threadIdx.x);
    half_s[threadIdx.x] = q * 4;
    recip_s[threadIdx.x] = 0xffffffffu / static_cast<unsigned>(q * 8) + 1u;
  }
  __syncthreads();                    // the tables are in shared memory
  if (live) {
    int v[64];
    if (fast) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v[r * 8 + c] =
              static_cast<int>(__byte_perm(rows[r].x, 0, 0x4440 + c));
          v[r * 8 + 4 + c] =
              static_cast<int>(__byte_perm(rows[r].y, 0, 0x4440 + c));
        }
    } else {
      // the clamped byte path: coordinates past the plane repeat its edge
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint8_t* row =
            plane + static_cast<long long>(min(by * 8 + r, h - 1)) * pitch;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          v[r * 8 + c] = static_cast<int>(row[min(bx * 8 + c, w - 1)]);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) fdct_1d<true, 1>(v + r * 8);
#pragma unroll
    for (int c = 0; c < 8; ++c) fdct_1d<false, 8>(v + c);
    // quantise: |c| + 4Q over 8Q by the reciprocal, the sign restored
#pragma unroll
    for (int k = 0; k < 64; ++k) {
      const int c = v[k];
      const int mag = static_cast<int>(
          __umulhi(static_cast<unsigned>((c < 0 ? -c : c) + half_s[k]),
                   recip_s[k]));
      v[k] = c < 0 ? -mag : mag;
    }
    unsigned o[32];
    fq_pack<0>(v, o);
    int4* mine = reinterpret_cast<int4*>(out_s[warp][lane]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      mine[i] = make_int4(static_cast<int>(o[4 * i]),
                          static_cast<int>(o[4 * i + 1]),
                          static_cast<int>(o[4 * i + 2]),
                          static_cast<int>(o[4 * i + 3]));
  }
  __syncwarp();
  // the warp's 32 blocks out, four whole blocks of one block row (512
  // contiguous bytes) a store instruction
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int slot = 4 * i + (lane >> 3), part = lane & 7;
    const int sx = tx * kFqTileW + (slot & 7);
    const int sy = ty * kFqTileH + warp * 4 + (slot >> 3);
    if (sx < j1.y && sy < j1.z) {
      const int4 q = reinterpret_cast<const int4*>(out_s[warp][slot])[part];
      store_global_v4(
          reinterpret_cast<int32_t*>(
              out + (static_cast<long long>(j2.x) +
                     static_cast<long long>(sy) * j1.y + sx) * 64) +
              4 * part,
          q.x, q.y, q.z, q.w);
    }
  }
}
}  // namespace

extern "C" {

// coeffs: (N, 64) int16 zigzag, 16-byte aligned; quant: (Q, 64) int32
// natural order; table: n_jobs rows of 8 int32 (output address low and
// high words, pitch, crop width, crop height, quant row, first block,
// blocks_w), 16-byte aligned, followed by each job's first CTA, ascending
// from 0; n_ctas: the CTAs of all jobs
int launch_jpeg_dequant_idct(const void* coeffs, const void* quant,
                             const void* table, int n_jobs, int n_ctas,
                             int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_jobs < 1 || n_ctas < 1 ||
      ((reinterpret_cast<uintptr_t>(coeffs) |
        reinterpret_cast<uintptr_t>(table)) & 15) != 0)
    return kInvalid;
  const int4* jobs = static_cast<const int4*>(table);
  jpeg_dequant_idct_kernel<<<static_cast<unsigned>(n_ctas), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coeffs),
      static_cast<const int32_t*>(quant), jobs,
      reinterpret_cast<const int*>(jobs + kJobVecs *
                                   static_cast<long long>(n_jobs)),
      n_jobs);
  return static_cast<int>(cudaGetLastError());
}


// table: n_jobs rows of 12 int32 (FQ_JOB_COLS), 16-byte aligned, then
// each job's first CTA, ascending from 0; n_ctas: the CTAs of all jobs;
// quant: (n_tables, 64) int32 natural order, 1 <= n_tables <= 4, every Q
// in 1..4,095; out: (n_blocks, 64) int16, 16-byte aligned
int launch_jpeg_fdct_quant(const void* table, int n_jobs, int n_ctas,
                           const void* quant, int n_tables, void* out,
                           int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_jobs < 1 || n_ctas < 1 || n_tables < 1 || n_tables > kFqMaxTables ||
      ((reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(table)) & 15) != 0)
    return kInvalid;
  const int4* jobs = static_cast<const int4*>(table);
  jpeg_fdct_quant_kernel<<<static_cast<unsigned>(n_ctas), kFqThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      jobs,
      reinterpret_cast<const int*>(jobs + (kFqJobCols / 4) *
                                   static_cast<long long>(n_jobs)),
      n_jobs, static_cast<const int32_t*>(quant),
      static_cast<int16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
