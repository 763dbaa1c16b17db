// AV1 intra-frame decode engine (host C++).
//
// A copy of libheif_tpu/native/src/av1_native.cc, the JAX package's C++
// AV1 decoder: a full-speed port of its Python AV1 decoder
// (libheif_tpu/codecs/av1/{msac,cdf,tile,recon,itx,palette,deblock,
// cdef,lr}.py), difftested against it plane for plane and against
// libaom.  It parses, reconstructs and runs the in-loop filters of one
// intra frame.  This replaces the external decode boundary the
// reference delegates to dav1d/aom (reference:
// libheif/plugins/decoder_dav1d.cc:457, decoder_aom.cc).
//
// Interface: one C ABI entry point, tpuheif_av1_decode_frame.  The
// Python side (codecs/av1/native_decode.py) parses OBUs, flattens the
// frame-header parameters and the default CDF tables (single source of
// truth: codecs/av1/default_cdfs.npz + cdf.py), and receives the fully
// reconstructed + loop-filtered planes.
//
// The port's copy reads no environment variable: the JAX package's
// timing printouts are left out (the caller's trace spans time the
// call), and the tile and filter work always takes a second thread where
// the host has two cores (the JAX package had a switch for that).  Its
// shared tables are filled once under std::call_once, so the first
// decodes of a process may start on several threads at once.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <ctime>
#include <vector>
#include <array>
#include <algorithm>
#include <thread>
#include <atomic>
#include <mutex>

namespace av1n {

typedef int64_t i64;
typedef int32_t i32;
typedef uint8_t u8;
typedef uint16_t u16;

static inline int floor_log2(uint32_t v) { return 31 - __builtin_clz(v); }
static inline int bitlen(i64 v) { return v <= 0 ? 0 : 64 - __builtin_clzll((uint64_t)v); }
static inline i64 round2(i64 x, int n) { return n == 0 ? x : ((x + ((i64)1 << (n - 1))) >> n); }
static inline i64 clampi(i64 v, i64 lo, i64 hi) { return v < lo ? lo : (v > hi ? hi : v); }

// ======================================================================
// MSAC (codecs/av1/msac.py; spec 8.2, daala EC)
// ======================================================================

static const int EC_PROB_SHIFT = 6;
static const int EC_MIN_PROB = 4;

#if defined(__SSE2__)
#include <emmintrin.h>
// per-n bias vectors: lane i = EC_MIN_PROB * (n - 1 - i)
static const u16 kMsacBias[9][8] = {
    {0}, {0},
    {4, 0, 0, 0, 0, 0, 0, 0},
    {8, 4, 0, 0, 0, 0, 0, 0},
    {12, 8, 4, 0, 0, 0, 0, 0},
    {16, 12, 8, 4, 0, 0, 0, 0},
    {20, 16, 12, 8, 4, 0, 0, 0},
    {24, 20, 16, 12, 8, 4, 0, 0},
    {28, 24, 20, 16, 12, 8, 4, 0},
};
static const u16 kMsacIdx[8] = {0, 1, 2, 3, 4, 5, 6, 7};
#endif

struct Msac {
  const u8* data;
  i64 size;
  i64 bitpos;                 // bits fetched into the cache
  i64 max_bits;
  uint32_t value;
  uint32_t range;
  uint64_t cache;             // prefetched bits, next at bit (ncache-1)
  int ncache;
  bool allow_update;

  void init(const u8* d, i64 n, bool update) {
    data = d; size = n; bitpos = 0;
    cache = 0; ncache = 0;
    max_bits = n * 8 - 15;
    int num_bits = (int)std::min<i64>(n * 8, 15);
    uint32_t buf = read_bits(num_bits);
    uint32_t padded = buf << (15 - num_bits);
    value = ((1u << 15) - 1) ^ padded;
    range = 1u << 15;
    allow_update = update;
  }

  // amortized whole-byte refill (zeros past end of buffer); fast path
  // tops up from one 64-bit load instead of a byte loop
  void refill() {
    i64 b = bitpos >> 3;
    if (b + 8 <= size) {
      int nbytes = (56 - ncache) >> 3;
      uint64_t chunk;
      memcpy(&chunk, data + b, 8);
      chunk = __builtin_bswap64(chunk) >> (64 - 8 * nbytes);
      cache = (cache << (8 * nbytes)) | chunk;
      ncache += 8 * nbytes;
      bitpos = (b + nbytes) << 3;
      return;
    }
    while (ncache <= 48) {
      uint32_t byte = (b < size) ? data[b] : 0;
      cache = (cache << 8) | byte;
      ncache += 8;
      b++;
    }
    bitpos = b << 3;
  }

  uint32_t read_bits(int n) {  // n <= 16 from renorm/init
    if (ncache < n) refill();
    ncache -= n;
    return (uint32_t)((cache >> ncache) & (((uint64_t)1 << n) - 1));
  }

  void renorm() {
    uint32_t rng = range;
    int bits = 15 - floor_log2(rng);
    if (bits == 0) return;
    range = rng << bits;
    int num_bits = (int)std::min<i64>(bits, std::max<i64>(0, max_bits));
    uint32_t new_data = read_bits(num_bits);
    uint32_t read_data = new_data << (bits - num_bits);
    value = ((value + 1) << bits) - read_data - 1;
    max_bits -= bits;
  }

  // decode against an icdf row of n symbols; row[n] is the adaptation
  // counter.  adapt=false for ephemeral rows (split bool).
#if defined(__SSE2__)
  // vector path for n <= 8 (dav1d's msac_decode_symbol_adapt design):
  // all thresholds at once via mulhi ((rng8 * (f>>6)) >> 1 ==
  // mulhi_epu16(range & 0xFF00, (f & ~63) << 1)), symbol from the
  // prefix popcount, branchless CDF adaptation. Bit-exact vs the
  // scalar loop (validated against libaom conformance).
  int read_symbol_simd(u16* icdf, int n, bool adapt) {
    __m128i cdf = _mm_loadu_si128((const __m128i*)icdf);
    __m128i rngs = _mm_set1_epi16((short)(range & 0xFF00u));
    __m128i fmasked = _mm_slli_epi16(_mm_srli_epi16(cdf, 6), 7);
    __m128i cur = _mm_add_epi16(
        _mm_mulhi_epu16(rngs, fmasked),
        _mm_loadu_si128((const __m128i*)kMsacBias[n]));
    // unsigned cur > val  (bias both by 0x8000 for signed cmp)
    __m128i bias = _mm_set1_epi16((short)0x8000);
    __m128i valv = _mm_set1_epi16((short)(value & 0xFFFFu));
    __m128i gt = _mm_cmpgt_epi16(_mm_xor_si128(cur, bias),
                                 _mm_xor_si128(valv, bias));
    unsigned mask = (unsigned)_mm_movemask_epi8(gt) &
                    ((1u << (2 * n)) - 1);
    int symbol = __builtin_popcount(mask) >> 1;
    u16 curs[8];
    _mm_storeu_si128((__m128i*)curs, cur);
    uint32_t prev = symbol == 0 ? range : curs[symbol - 1];
    uint32_t c = curs[symbol];
    range = prev - c;
    value -= c;
    renorm();
    if (allow_update && adapt) {
      int count = icdf[n];
      int rate = 3 + (count > 15) + (count > 31) +
                 std::min(floor_log2(n), 2);
      // lanes i < symbol: v += (32768 - v) >> rate; i in
      // [symbol, n-1): v -= v >> rate; lanes >= n-1 unchanged
      __m128i idx = _mm_loadu_si128((const __m128i*)kMsacIdx);
      __m128i symv = _mm_set1_epi16((short)symbol);
      __m128i m_pref = _mm_cmplt_epi16(idx, symv);
      __m128i m_act = _mm_cmplt_epi16(idx, _mm_set1_epi16((short)(n - 1)));
      __m128i up = _mm_srli_epi16(
          _mm_sub_epi16(_mm_set1_epi16((short)0x8000), cdf), rate);
      __m128i dn = _mm_srli_epi16(cdf, rate);
      __m128i delta = _mm_or_si128(_mm_and_si128(m_pref, up),
                                   _mm_andnot_si128(m_pref,
                                       _mm_sub_epi16(_mm_setzero_si128(),
                                                     dn)));
      __m128i upd = _mm_add_epi16(cdf, _mm_and_si128(m_act, delta));
      _mm_storeu_si128((__m128i*)icdf, upd);
      icdf[n] = (u16)(count + (count < 32));
    }
    return symbol;
  }
#endif

  int read_symbol_n(u16* icdf, int n, bool adapt = true) {
#if defined(__SSE2__)
    if (n <= 8) return read_symbol_simd(icdf, n, adapt);
#endif
    uint32_t rng8 = range >> 8;
    uint32_t val = value;
    uint32_t cur = range;
    int symbol = -1;
    uint32_t prev;
    while (true) {
      symbol++;
      prev = cur;
      uint32_t f = icdf[symbol];
      cur = ((rng8 * (f >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) +
            EC_MIN_PROB * (n - 1 - symbol);
      if (val >= cur) break;
    }
    range = prev - cur;
    value = val - cur;
    renorm();
    if (allow_update && adapt) {
      int count = icdf[n];
      int rate = 3 + (count > 15) + (count > 31) +
                 std::min(floor_log2(n), 2);
      for (int i = 0; i < n - 1; i++) {
        int v = icdf[i];
        if (i < symbol)
          icdf[i] = (u16)(v + ((32768 - v) >> rate));
        else
          icdf[i] = (u16)(v - (v >> rate));
      }
      icdf[n] = (u16)(count + (count < 32));
    }
    return symbol;
  }

  int read_bit() {
    uint32_t rng8 = range >> 8;
    uint32_t cur = (rng8 << 7) + EC_MIN_PROB;
    int bit;
    if (value >= cur) {
      bit = 0;
      range -= cur;
      value -= cur;
    } else {
      bit = 1;
      range = cur;
    }
    renorm();
    return bit;
  }

  int read_literal(int n) {
    int v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | read_bit();
    return v;
  }

  int read_golomb() {
    int length = 0;
    while (!read_bit()) {
      length++;
      if (length > 20) break;
    }
    int v = 1;
    for (int i = 0; i < length; i++) v = (v << 1) | read_bit();
    return v - 1;
  }
};

// ======================================================================
// Static tables (codecs/av1/tables.py; spec 6.10.4 / 9.3 / 9.24)
// ======================================================================

static const int N_BSIZES = 22;
static const int BW[N_BSIZES] = {4,4,8,8,8,16,16,16,32,32,32,64,64,64,128,128,4,16,8,32,16,64};
static const int BH[N_BSIZES] = {4,8,4,8,16,8,16,32,16,32,64,32,64,128,64,128,16,4,32,8,64,16};
static const int BLOCK_INVALID = 255;
static const int BLOCK_4X4 = 0, BLOCK_8X8 = 3, BLOCK_64X64 = 12,
                 BLOCK_128X128 = 15;

enum {
  PARTITION_NONE = 0, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
  PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B,
  PARTITION_HORZ_4, PARTITION_VERT_4
};

enum {
  DC_PRED = 0, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
  D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
  PAETH_PRED, UV_CFL_PRED
};

// INTRA_MODE_TO_TX_TYPE (tables.py)
static const int INTRA_MODE_TO_TX_TYPE[14] = {0,1,2,0,3,1,2,2,1,3,1,2,3,0};
static const int INTRA_MODE_CONTEXT[13] = {0,1,2,3,4,4,4,4,3,0,1,2,0};

static int mode_to_angle(int mode) {
  switch (mode) {
    case V_PRED: return 90;
    case H_PRED: return 180;
    case D45_PRED: return 45;
    case D135_PRED: return 135;
    case D113_PRED: return 113;
    case D157_PRED: return 157;
    case D203_PRED: return 203;
    case D67_PRED: return 67;
  }
  return -1;
}

static const int N_TXS = 19;
static const int TXW[N_TXS] = {4,8,16,32,64,4,8,8,16,16,32,32,64,4,16,8,32,16,64};
static const int TXH[N_TXS] = {4,8,16,32,64,8,4,16,8,32,16,64,32,16,4,32,8,64,16};
static const int TX_4X4 = 0;

enum {
  DCT_DCT = 0, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
  FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
  V_ADST, H_ADST, V_FLIPADST, H_FLIPADST, WHT_WHT
};

struct Tables {
  int partition_subsize[10][N_BSIZES];
  int max_tx_size_rect[N_BSIZES];
  int split_tx_size[N_TXS];
  int tx_size_sqr[N_TXS];
  int tx_size_sqr_up[N_TXS];
  // scans: per (tx, class) flat indices; class 0='2d',1='h',2='v'
  std::vector<i32> scans[N_TXS][3];
  // prefix bounding box: scan_maxr[t][cls][c] = 1 + max row among the
  // first c+1 scan entries (same for cols) — bounds the region a
  // parse with eob = c+1 can touch, so per-TXB clears scale with eob
  std::vector<u8> scan_maxr[N_TXS][3], scan_maxc[N_TXS][3];

  int bs_index(int w, int h) const {
    for (int i = 0; i < N_BSIZES; i++)
      if (BW[i] == w && BH[i] == h) return i;
    return BLOCK_INVALID;
  }
  int tx_index(int w, int h) const {
    for (int i = 0; i < N_TXS; i++)
      if (TXW[i] == w && TXH[i] == h) return i;
    return -1;
  }

  void init() {
    for (int b = 0; b < N_BSIZES; b++) {
      int w = BW[b], h = BH[b];
      partition_subsize[PARTITION_NONE][b] = b;
      partition_subsize[PARTITION_HORZ][b] = bs_index(w, h / 2);
      partition_subsize[PARTITION_VERT][b] = bs_index(w / 2, h);
      partition_subsize[PARTITION_SPLIT][b] = bs_index(w / 2, h / 2);
      partition_subsize[PARTITION_HORZ_A][b] = bs_index(w, h / 2);
      partition_subsize[PARTITION_HORZ_B][b] = bs_index(w, h / 2);
      partition_subsize[PARTITION_VERT_A][b] = bs_index(w / 2, h);
      partition_subsize[PARTITION_VERT_B][b] = bs_index(w / 2, h);
      partition_subsize[PARTITION_HORZ_4][b] = bs_index(w, h / 4);
      partition_subsize[PARTITION_VERT_4][b] = bs_index(w / 4, h);
      // AV1 transforms include 4:1 aspects (tables.py
      // MAX_TX_SIZE_RECT)
      int tw = std::min(w, 64), th = std::min(h, 64);
      while (tw > 4 * th) tw /= 2;
      while (th > 4 * tw) th /= 2;
      max_tx_size_rect[b] = tx_index(tw, th);
    }
    for (int i = 0; i < N_TXS; i++) {
      int w = TXW[i], h = TXH[i];
      if (w == 4 && h == 4) {
        split_tx_size[i] = i;
      } else if (w == h) {
        split_tx_size[i] = tx_index(w / 2, h / 2);
      } else {
        int nw = (w >= h && w > 4) ? w / 2 : w;
        int nh = (h >= w && h > 4) ? h / 2 : h;
        split_tx_size[i] = tx_index(nw, nh);
      }
      int s = std::min(w, h);
      int u = std::min(std::max(w, h), 64);
      tx_size_sqr[i] = tx_index(s, s);
      tx_size_sqr_up[i] = tx_index(u, u);
    }
    // scans (tables.py get_scan)
    for (int t = 0; t < N_TXS; t++) {
      int w = std::min(TXW[t], 32), h = std::min(TXH[t], 32);
      // 2d
      {
        std::vector<i32>& s = scans[t][0];
        s.clear();
        if (w == h) {
          for (int d = 0; d < w + h - 1; d++) {
            std::vector<std::pair<int,int>> cells;
            for (int r = 0; r < h; r++) {
              int c = d - r;
              if (c >= 0 && c < w) cells.push_back({r, c});
            }
            // even diagonals: bottom-left -> top-right (reverse row sort)
            if (d % 2 == 0)
              std::sort(cells.begin(), cells.end(),
                        [](const std::pair<int,int>& a,
                           const std::pair<int,int>& b) { return a.first > b.first; });
            else
              std::sort(cells.begin(), cells.end());
            for (auto& rc : cells) s.push_back(rc.first * w + rc.second);
          }
        } else {
          for (int d = 0; d < w + h - 1; d++) {
            std::vector<std::pair<int,int>> cells;
            int r0 = std::max(0, d - w + 1), r1 = std::min(h, d + 1);
            for (int r = r0; r < r1; r++) cells.push_back({r, d - r});
            if (w > h) std::reverse(cells.begin(), cells.end());
            for (auto& rc : cells) s.push_back(rc.first * w + rc.second);
          }
        }
      }
      // h class: column-by-column
      {
        std::vector<i32>& s = scans[t][1];
        s.clear();
        for (int c = 0; c < w; c++)
          for (int r = 0; r < h; r++) s.push_back(r * w + c);
      }
      // v class: row-by-row
      {
        std::vector<i32>& s = scans[t][2];
        s.clear();
        for (int r = 0; r < h; r++)
          for (int c = 0; c < w; c++) s.push_back(r * w + c);
      }
      for (int cls = 0; cls < 3; cls++) {
        const std::vector<i32>& s = scans[t][cls];
        std::vector<u8>& mr = scan_maxr[t][cls];
        std::vector<u8>& mc = scan_maxc[t][cls];
        mr.resize(s.size());
        mc.resize(s.size());
        int rmax = 0, cmax = 0;
        for (size_t i = 0; i < s.size(); i++) {
          int r = s[i] / w, c = s[i] % w;
          rmax = std::max(rmax, r + 1);
          cmax = std::max(cmax, c + 1);
          mr[i] = (u8)rmax;
          mc[i] = (u8)cmax;
        }
      }
    }
  }
};

static Tables g_tables;
static std::once_flag g_tables_once;


// ======================================================================
// CDF set (codecs/av1/cdf.py; defaults flattened by native_decode.py)
// ======================================================================

// fixed flattening order shared with native_decode.py _flatten_cdf_buf
struct CdfSet {
  u16 txb_skip[5][13][3];
  u16 eob_extra[5][2][9][3];
  u16 dc_sign[2][3][3];
  u16 eob_pt16[2][2][6];
  u16 eob_pt32[2][2][7];
  u16 eob_pt64[2][2][8];
  u16 eob_pt128[2][2][9];
  u16 eob_pt256[2][2][10];
  u16 eob_pt512[2][2][11];
  u16 eob_pt1024[2][2][12];
  u16 coeff_base_eob[5][2][4][4];
  u16 coeff_base[5][2][42][5];
  u16 coeff_br[5][2][21][5];
  u16 kf_y_mode[5][5][14];
  u16 uv_mode[2][13][15];
  u16 partition[20][11];
  u16 intra_ext_tx[3][4][13][17];
  u16 cfl_sign[9];
  u16 cfl_alpha[6][17];
  u16 filter_intra_use[22][3];
  u16 filter_intra_mode[6];
  u16 tx_size[4][3][4];
  u16 angle_delta[8][8];
  u16 skip[3][3];
  u16 palette_y_mode[7][3][3];
  u16 palette_uv_mode[2][3];
  u16 palette_y_size[7][8];
  u16 palette_uv_size[7][8];
  u16 palette_y_color[7][5][9];
  u16 palette_uv_color[7][5][9];
  u16 restore_switchable[4];
  u16 restore_wiener[3];
  u16 restore_sgrproj[3];
  // intrabc / inter-tx tables (cdf.py intrabc block)
  u16 intrabc[3];
  u16 txfm_partition[21][3];
  u16 dv_joints[5];
  u16 dv_sign[2][3];
  u16 dv_classes[2][12];
  u16 dv_class0[2][3];
  u16 dv_bits[2][10][3];
  u16 inter_ext_tx[3][4][17];
  u16 simd_pad[8];   // lets 8-lane SSE loads at any row stay in-bounds
};

// table sizes in int32 units, in flattening order
static const i64 CDF_SIZES[] = {
  5*13*3, 5*2*9*3, 2*3*3, 2*2*6, 2*2*7, 2*2*8, 2*2*9, 2*2*10, 2*2*11,
  2*2*12, 5*2*4*4, 5*2*42*5, 5*2*21*5, 5*5*14, 2*13*15, 20*11,
  3*4*13*17, 9, 6*17, 22*3, 6, 4*3*4, 8*8, 3*3, 7*3*3, 2*3, 7*8, 7*8,
  7*5*9, 7*5*9, 4, 3, 3,
  3, 21*3, 5, 2*3, 2*12, 2*3, 2*10*3, 3*4*17,
};
static const int N_CDF_TABLES = (int)(sizeof(CDF_SIZES) / sizeof(i64));
// extras appended after CDFs: sm_weights[124], dr_intra_derivative[90],
// filter_intra_taps[5*8*8] (signed)
static const i64 EXTRA_SIZES[] = {124, 90, 5*8*8};

static i64 cdf_total_size() {
  i64 t = 0;
  for (int i = 0; i < N_CDF_TABLES; i++) t += CDF_SIZES[i];
  for (int i = 0; i < 3; i++) t += EXTRA_SIZES[i];
  return t;
}

static void cdf_init_from_buf(CdfSet* c, const i32* buf) {
  u16* dst[] = {
    &c->txb_skip[0][0][0], &c->eob_extra[0][0][0][0], &c->dc_sign[0][0][0],
    &c->eob_pt16[0][0][0], &c->eob_pt32[0][0][0], &c->eob_pt64[0][0][0],
    &c->eob_pt128[0][0][0], &c->eob_pt256[0][0][0], &c->eob_pt512[0][0][0],
    &c->eob_pt1024[0][0][0], &c->coeff_base_eob[0][0][0][0],
    &c->coeff_base[0][0][0][0], &c->coeff_br[0][0][0][0],
    &c->kf_y_mode[0][0][0], &c->uv_mode[0][0][0], &c->partition[0][0],
    &c->intra_ext_tx[0][0][0][0], &c->cfl_sign[0], &c->cfl_alpha[0][0],
    &c->filter_intra_use[0][0], &c->filter_intra_mode[0],
    &c->tx_size[0][0][0], &c->angle_delta[0][0], &c->skip[0][0],
    &c->palette_y_mode[0][0][0], &c->palette_uv_mode[0][0],
    &c->palette_y_size[0][0], &c->palette_uv_size[0][0],
    &c->palette_y_color[0][0][0], &c->palette_uv_color[0][0][0],
    &c->restore_switchable[0], &c->restore_wiener[0],
    &c->restore_sgrproj[0],
    &c->intrabc[0], &c->txfm_partition[0][0], &c->dv_joints[0],
    &c->dv_sign[0][0], &c->dv_classes[0][0], &c->dv_class0[0][0],
    &c->dv_bits[0][0][0], &c->inter_ext_tx[0][0][0],
  };
  i64 off = 0;
  for (int t = 0; t < N_CDF_TABLES; t++) {
    for (i64 i = 0; i < CDF_SIZES[t]; i++)
      dst[t][i] = (u16)buf[off + i];
    off += CDF_SIZES[t];
  }
}

// ======================================================================
// Frame parameters (flattened by native_decode.py)
// ======================================================================

struct Params {
  int mi_cols, mi_rows, frame_w, frame_h;
  int bit_depth, ssx, ssy, monochrome;
  int sb128;
  int base_q_idx;
  int dq[5];  // y_dc, u_dc, u_ac, v_dc, v_ac
  int coded_lossless, tx_mode_select, reduced_tx_set;
  int allow_screen_content, enable_filter_intra, enable_intra_edge_filter;
  int enable_cdef, allow_intrabc, disable_cdf_update, delta_q_present;
  int cdef_damping, cdef_bits;
  int cdef_y_pri[8], cdef_y_sec[8], cdef_uv_pri[8], cdef_uv_sec[8];
  int lr_type[3], lr_unit_size[3];
  int lf_levels[4], lf_sharpness, lf_delta_enabled, lf_ref_delta_intra;
  // bit-depth-matched dequant lookups (spec 7.12.2), appended by
  // native_decode.py _params_array so 10/12-bit streams carry their
  // own tables
  const i32* dc_qtab;
  const i32* ac_qtab;
};

static void params_from_buf(Params* p, const i32* b) {
  int k = 0;
  p->mi_cols = b[k++]; p->mi_rows = b[k++];
  p->frame_w = b[k++]; p->frame_h = b[k++];
  p->bit_depth = b[k++]; p->ssx = b[k++]; p->ssy = b[k++];
  p->monochrome = b[k++]; p->sb128 = b[k++];
  p->base_q_idx = b[k++];
  for (int i = 0; i < 5; i++) p->dq[i] = b[k++];
  p->coded_lossless = b[k++]; p->tx_mode_select = b[k++];
  p->reduced_tx_set = b[k++]; p->allow_screen_content = b[k++];
  p->enable_filter_intra = b[k++]; p->enable_intra_edge_filter = b[k++];
  p->enable_cdef = b[k++]; p->allow_intrabc = b[k++];
  p->disable_cdf_update = b[k++]; p->delta_q_present = b[k++];
  p->cdef_damping = b[k++]; p->cdef_bits = b[k++];
  for (int i = 0; i < 8; i++) p->cdef_y_pri[i] = b[k++];
  for (int i = 0; i < 8; i++) p->cdef_y_sec[i] = b[k++];
  for (int i = 0; i < 8; i++) p->cdef_uv_pri[i] = b[k++];
  for (int i = 0; i < 8; i++) p->cdef_uv_sec[i] = b[k++];
  for (int i = 0; i < 3; i++) p->lr_type[i] = b[k++];
  for (int i = 0; i < 3; i++) p->lr_unit_size[i] = b[k++];
  for (int i = 0; i < 4; i++) p->lf_levels[i] = b[k++];
  p->lf_sharpness = b[k++]; p->lf_delta_enabled = b[k++];
  p->lf_ref_delta_intra = b[k++];
  p->dc_qtab = b + k; k += 256;
  p->ac_qtab = b + k; k += 256;
}
static const int N_PARAMS = 72 + 512;

}  // namespace av1n

namespace av1n {

// ======================================================================
// Intra prediction (codecs/av1/recon.py; spec 7.11.2)
// ======================================================================

struct PredTables {
  const i32* sm_weights;          // [124]
  const i32* dr_deriv;            // [90]
  const i32* fi_taps;             // [5][8][8] signed
};

static const i32* sm_w_for(const PredTables& pt, int n) {
  switch (n) {
    case 4: return pt.sm_weights + 0;
    case 8: return pt.sm_weights + 4;
    case 16: return pt.sm_weights + 12;
    case 32: return pt.sm_weights + 28;
    default: return pt.sm_weights + 60;  // 64
  }
}

// spec 7.11.2.7 Intra_Edge_Filter_Strength (recon.py _edge_filter_strength)
static int edge_filter_strength(int w, int h, int delta, int filter_type) {
  int d = std::abs(delta);
  int blk_wh = w + h;
  int strength = 0;
  if (filter_type == 0) {
    if (blk_wh <= 8) { if (d >= 56) strength = 1; }
    else if (blk_wh <= 12) { if (d >= 40) strength = 1; }
    else if (blk_wh <= 16) { if (d >= 40) strength = 1; }
    else if (blk_wh <= 24) {
      if (d >= 8) strength = 1;
      if (d >= 16) strength = 2;
      if (d >= 32) strength = 3;
    } else if (blk_wh <= 32) {
      if (d >= 1) strength = 1;
      if (d >= 4) strength = 2;
      if (d >= 32) strength = 3;
    } else { if (d >= 1) strength = 3; }
  } else {
    if (blk_wh <= 8) {
      if (d >= 40) strength = 1;
      if (d >= 64) strength = 2;
    } else if (blk_wh <= 16) {
      if (d >= 20) strength = 1;
      if (d >= 48) strength = 2;
    } else if (blk_wh <= 24) { if (d >= 4) strength = 3; }
    else { if (d >= 1) strength = 3; }
  }
  return strength;
}

static const int EDGE_KERNELS[3][5] = {
  {0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2},
};

// spec 7.11.2.8, in place over buf[0:n]
static void filter_edge(i64* buf, int n, int strength) {
  if (strength == 0) return;
  const int* k = EDGE_KERNELS[strength - 1];
  i64 src[280];
  memcpy(src, buf, sizeof(i64) * n);
  for (int i = 1; i < n; i++) {
    i64 s = 0;
    for (int j = 0; j < 5; j++) {
      int idx = std::min(std::max(i - 2 + j, 0), n - 1);
      s += k[j] * src[idx];
    }
    buf[i] = (s + 8) >> 4;
  }
}

// spec 7.11.2.10
static int use_upsample(int w, int h, int delta, int filter_type) {
  int d = std::abs(delta);
  int blk_wh = w + h;
  if (d <= 0 || d >= 40) return 0;
  return (filter_type == 0 ? blk_wh <= 16 : blk_wh <= 8) ? 1 : 0;
}

// spec 7.11.2.11: buf[0]=corner, buf[1..n]=edge.  Writes `out` (offset
// 2 indexing) which must hold 2 + 2*n + 8 entries.
static void upsample_edge(const i64* buf, int n, int bit_depth, i64* out,
                          int out_len) {
  i64 maxv = (1 << bit_depth) - 1;
  i64 s[284];
  memset(s, 0, sizeof(i64) * (n + 4));
  s[1] = buf[0];
  for (int i = 0; i < n; i++) s[2 + i] = buf[1 + i];
  s[0] = s[1];
  s[n + 2] = s[n + 1];
  s[n + 3] = s[n + 1];
  for (int i = 0; i < out_len; i++) out[i] = 0;
  for (int k = -1; k < n; k++) {
    out[2 + 2 * k] = s[k + 2];
    if (k < n - 1) {
      i64 v = -s[k + 1] + 9 * s[k + 2] + 9 * s[k + 3] - s[k + 4];
      out[2 + 2 * k + 1] = clampi(round2(v, 4), 0, maxv);
    }
  }
  for (int i = 2 + 2 * (n - 1) + 1; i < out_len; i++)
    out[i] = out[2 + 2 * (n - 1)];
}

// Plane view: int32 data with row stride.
struct PlaneView {
  // 8-bit engine: pixels live in u16 planes (halved bandwidth, wider
  // SIMD lanes in the filters); arithmetic happens in int registers
  u16* data;
  int w, h, stride;
  i64 at(int y, int x) const { return data[(i64)y * stride + x]; }
  void set(int y, int x, i64 v) { data[(i64)y * stride + x] = (u16)v; }
};

// predict a (h, w) block at (x, y); out is row-major h*w i64
static void predict_intra(const PredTables& pt, const PlaneView& plane,
                          int x, int y, int w, int h, int mode,
                          int angle_delta, bool have_above, bool have_left,
                          int n_top_right, int n_bottom_left, int bit_depth,
                          bool enable_edge_filter, int filter_type,
                          i64* out) {
  i64 maxv = (1 << bit_depth) - 1;
  i64 base = 1 << (bit_depth - 1);
  int ma = mode_to_angle(mode);
  bool is_dir = ma >= 0;
  int p_angle = is_dir ? ma + angle_delta * 3 : 0;

  int buf_n = w + h + 16;
  i64 above[144], left[144];
  memset(above, 0, sizeof(i64) * buf_n);
  memset(left, 0, sizeof(i64) * buf_n);
  int plane_w = plane.w, plane_h = plane.h;

  if (have_above) {
    int avail = std::min(w, plane_w - x);
    for (int i = 0; i < avail; i++) above[i] = plane.at(y - 1, x + i);
    for (int i = avail; i < w; i++) above[i] = above[avail - 1];
    int ntr = std::min(n_top_right, w);
    if (ntr > 0) {
      int ext_avail = std::min(ntr, plane_w - (x + w));
      for (int i = 0; i < ext_avail; i++)
        above[w + i] = plane.at(y - 1, x + w + i);
      i64 last = ext_avail > 0 ? above[w + ext_avail - 1] : above[w - 1];
      for (int i = w + ext_avail; i < buf_n; i++) above[i] = last;
    } else {
      for (int i = w; i < buf_n; i++) above[i] = above[w - 1];
    }
  } else {
    i64 fill = have_left ? plane.at(y, x - 1) : base - 1;
    for (int i = 0; i < buf_n; i++) above[i] = fill;
  }
  if (have_left) {
    int avail = std::min(h, plane_h - y);
    for (int i = 0; i < avail; i++) left[i] = plane.at(y + i, x - 1);
    for (int i = avail; i < h; i++) left[i] = left[avail - 1];
    int nbl = std::min(n_bottom_left, h);
    if (nbl > 0) {
      int ext_avail = std::min(nbl, plane_h - (y + h));
      for (int i = 0; i < ext_avail; i++)
        left[h + i] = plane.at(y + h + i, x - 1);
      i64 last = ext_avail > 0 ? left[h + ext_avail - 1] : left[h - 1];
      for (int i = h + ext_avail; i < buf_n; i++) left[i] = last;
    } else {
      for (int i = h; i < buf_n; i++) left[i] = left[h - 1];
    }
  } else {
    i64 fill = have_above ? above[0] : base + 1;
    for (int i = 0; i < buf_n; i++) left[i] = fill;
  }
  i64 corner;
  if (have_above && have_left) corner = plane.at(y - 1, x - 1);
  else if (have_above) corner = above[0];
  else if (have_left) corner = left[0];
  else corner = base;

  // non-directional
  if (mode == DC_PRED) {
    i64 dc;
    if (have_above && have_left) {
      i64 s = 0;
      for (int i = 0; i < w; i++) s += above[i];
      for (int i = 0; i < h; i++) s += left[i];
      dc = (s + ((w + h) >> 1)) / (w + h);
    } else if (have_above) {
      i64 s = 0;
      for (int i = 0; i < w; i++) s += above[i];
      dc = round2(s, floor_log2(w));
    } else if (have_left) {
      i64 s = 0;
      for (int i = 0; i < h; i++) s += left[i];
      dc = round2(s, floor_log2(h));
    } else {
      dc = base;
    }
    for (int i = 0; i < h * w; i++) out[i] = dc;
    return;
  }
  if (mode == PAETH_PRED) {
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        i64 t = above[j], l = left[i], tl = corner;
        i64 pbase = t + l - tl;
        i64 pl = std::abs(pbase - l), ptp = std::abs(pbase - t),
            ptl = std::abs(pbase - tl);
        i64 v = (pl <= ptp && pl <= ptl) ? l : (ptp <= ptl ? t : tl);
        out[i * w + j] = v;
      }
    return;
  }
  if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED ||
      mode == SMOOTH_H_PRED) {
    const i32* wv = sm_w_for(pt, h);
    const i32* wh = sm_w_for(pt, w);
    i64 below = left[h - 1];
    i64 right = above[w - 1];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        if (mode == SMOOTH_PRED) {
          i64 sv = (i64)wv[i] * above[j] + (256 - wv[i]) * below;
          i64 sh = (i64)wh[j] * left[i] + (256 - wh[j]) * right;
          out[i * w + j] = round2(sv + sh, 9);
        } else if (mode == SMOOTH_V_PRED) {
          i64 sv = (i64)wv[i] * above[j] + (256 - wv[i]) * below;
          out[i * w + j] = round2(sv, 8);
        } else {
          i64 sh = (i64)wh[j] * left[i] + (256 - wh[j]) * right;
          out[i * w + j] = round2(sh, 8);
        }
      }
    return;
  }

  // directional
  int ebuf_n = 1 + w + h + 8;
  i64 edge_a[280], edge_l[280], up_a[280], up_l[280];
  i64* above_row = edge_a;
  i64* left_col = edge_l;
  memset(edge_a, 0, sizeof(i64) * ebuf_n);
  memset(edge_l, 0, sizeof(i64) * ebuf_n);
  above_row[0] = corner;
  for (int i = 0; i < w + h + 7; i++) above_row[1 + i] = above[i];
  left_col[0] = corner;
  for (int i = 0; i < h + w + 7; i++) left_col[1 + i] = left[i];
  int upsample_above = 0, upsample_left = 0;
  if (enable_edge_filter) {
    if (p_angle != 90 && p_angle != 180) {
      if (p_angle > 90 && p_angle < 180 && (w + h) >= 24) {
        i64 s = round2(5 * above_row[1] + 6 * corner + 5 * left_col[1], 4);
        above_row[0] = left_col[0] = s;
      }
      int filt = filter_type;
      if (have_above) {
        int strength = edge_filter_strength(w, h, p_angle - 90, filt);
        int num = w + (p_angle < 90 ? h : 0) + 1;
        filter_edge(above_row, num, strength);
      }
      if (have_left) {
        int strength = edge_filter_strength(w, h, p_angle - 180, filt);
        int num = h + (p_angle > 180 ? w : 0) + 1;
        filter_edge(left_col, num, strength);
      }
    }
    upsample_above = have_above ?
        use_upsample(w, h, p_angle - 90, filter_type) : 0;
    upsample_left = have_left ?
        use_upsample(w, h, p_angle - 180, filter_type) : 0;
    if (upsample_above) {
      int n = w + (p_angle < 90 ? h : 0);
      upsample_edge(above_row, n, bit_depth, up_a, 2 + 2 * n + 8);
      above_row = up_a;
    }
    if (upsample_left) {
      int n = h + (p_angle > 180 ? w : 0);
      upsample_edge(left_col, n, bit_depth, up_l, 2 + 2 * n + 8);
      left_col = up_l;
    }
  }

  i64 dx = 0, dy = 0;
  if (p_angle > 0 && p_angle < 90) dx = pt.dr_deriv[p_angle];
  else if (p_angle > 90 && p_angle < 180) dx = pt.dr_deriv[180 - p_angle];
  if (p_angle > 90 && p_angle < 180) dy = pt.dr_deriv[p_angle - 90];
  else if (p_angle > 180 && p_angle < 270) dy = pt.dr_deriv[270 - p_angle];

  int a_off = upsample_above ? 2 : 1;
  int l_off = upsample_left ? 2 : 1;

  if (p_angle < 90) {
    int upa = upsample_above;
    i64 maxbase = (i64)(w + h - 1) << upa;
    for (int i = 0; i < h; i++) {
      i64 idx = (i64)(i + 1) * dx;
      for (int j = 0; j < w; j++) {
        i64 b = (idx >> (6 - upa)) + ((i64)j << upa);
        i64 shift = ((idx << upa) >> 1) & 0x1F;
        i64 v;
        if (b < maxbase)
          v = round2(above_row[a_off + b] * (32 - shift) +
                     above_row[a_off + b + 1] * shift, 5);
        else
          v = above_row[a_off + maxbase];
        out[i * w + j] = clampi(v, 0, maxv);
      }
    }
  } else if (p_angle == 90) {
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++)
        out[i * w + j] = clampi(above_row[a_off + j], 0, maxv);
  } else if (p_angle < 180) {
    int upa = upsample_above, upl = upsample_left;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        i64 idx = ((i64)j << 6) - (i64)(i + 1) * dx;
        i64 b = idx >> (6 - upa);
        i64 v;
        if (b >= -((i64)1 << upa)) {
          i64 shift = ((idx << upa) >> 1) & 0x1F;
          v = round2(above_row[a_off + b] * (32 - shift) +
                     above_row[a_off + b + 1] * shift, 5);
        } else {
          i64 idx2 = ((i64)i << 6) - (i64)(j + 1) * dy;
          i64 b2 = idx2 >> (6 - upl);
          i64 shift2 = ((idx2 << upl) >> 1) & 0x1F;
          v = round2(left_col[l_off + b2] * (32 - shift2) +
                     left_col[l_off + b2 + 1] * shift2, 5);
        }
        out[i * w + j] = clampi(v, 0, maxv);
      }
  } else if (p_angle == 180) {
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++)
        out[i * w + j] = clampi(left_col[l_off + i], 0, maxv);
  } else {
    int upl = upsample_left;
    i64 maxbase = (i64)(w + h - 1) << upl;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        i64 idx = (i64)(j + 1) * dy;
        i64 b = (idx >> (6 - upl)) + ((i64)i << upl);
        i64 shift = ((idx << upl) >> 1) & 0x1F;
        i64 v;
        if (b < maxbase)
          v = round2(left_col[l_off + b] * (32 - shift) +
                     left_col[l_off + b + 1] * shift, 5);
        else
          v = left_col[l_off + maxbase];
        out[i * w + j] = clampi(v, 0, maxv);
      }
  }
}

// recursive filter-intra (recon.py predict_filter_intra; spec 7.11.2.3)
static void predict_filter_intra(const PredTables& pt,
                                 const PlaneView& plane, int x, int y,
                                 int w, int h, int fi_mode,
                                 bool have_above, bool have_left,
                                 int bit_depth, i64* out) {
  const i32* taps = pt.fi_taps + fi_mode * 64;
  i64 base = 1 << (bit_depth - 1);
  i64 maxv = (1 << bit_depth) - 1;
  int bw = w + 1, bh = h + 1;
  i64 buf[33 * 33];
  memset(buf, 0, sizeof(i64) * bh * bw);
  int plane_w = plane.w, plane_h = plane.h;
  if (have_above) {
    int avail = std::min(w, plane_w - x);
    for (int i = 0; i < avail; i++) buf[1 + i] = plane.at(y - 1, x + i);
    for (int i = avail; i < w; i++) buf[1 + i] = buf[avail];  // last avail
  } else {
    i64 fill = have_left ? plane.at(y, x - 1) : base - 1;
    for (int i = 0; i < w; i++) buf[1 + i] = fill;
  }
  if (have_left) {
    int avail = std::min(h, plane_h - y);
    for (int i = 0; i < avail; i++)
      buf[(i64)(1 + i) * bw] = plane.at(y + i, x - 1);
    for (int i = avail; i < h; i++)
      buf[(i64)(1 + i) * bw] = buf[(i64)avail * bw];
  } else {
    i64 fill = have_above ? buf[1] : base + 1;
    for (int i = 0; i < h; i++) buf[(i64)(1 + i) * bw] = fill;
  }
  if (have_above && have_left) buf[0] = plane.at(y - 1, x - 1);
  else if (have_above) buf[0] = buf[1];
  else if (have_left) buf[0] = buf[bw];
  else buf[0] = base;

  for (int r = 1; r < h + 1; r += 2)
    for (int c = 1; c < w + 1; c += 4) {
      i64 p[8] = {
        buf[(i64)(r - 1) * bw + c - 1], buf[(i64)(r - 1) * bw + c],
        buf[(i64)(r - 1) * bw + c + 1], buf[(i64)(r - 1) * bw + c + 2],
        buf[(i64)(r - 1) * bw + c + 3], buf[(i64)r * bw + c - 1],
        buf[(i64)(r + 1) * bw + c - 1], 0,
      };
      for (int k = 0; k < 8; k++) {
        int ro = k >> 2, co = k & 3;
        i64 v = 0;
        for (int t = 0; t < 8; t++) v += (i64)taps[k * 8 + t] * p[t];
        v = v >= 0 ? (v + 8) >> 4 : -((-v + 8) >> 4);
        buf[(i64)(r + ro) * bw + c + co] = clampi(v, 0, maxv);
      }
    }
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++)
      out[i * w + j] = buf[(i64)(1 + i) * bw + 1 + j];
}

// ======================================================================
// Inverse transforms (codecs/av1/itx.py; spec 7.13.3)
// ======================================================================

static const int COS_BIT = 12;
static i64 COSPI[64];
static i64 SINPI[5];
static const i64 INV_SQRT2 = 2896;
static const i64 NEW_SQRT2 = 5793;
static std::once_flag g_itx_once;

static void itx_init() {
  std::call_once(g_itx_once, [] {
    for (int i = 0; i < 64; i++)
      COSPI[i] = (i64)llround(cos(i * M_PI / 128) * (1 << COS_BIT));
    SINPI[0] = 0;
    for (int i = 1; i < 5; i++)
      SINPI[i] = (i64)llround(sin(i * M_PI / 9) * sqrt(2.0) * (2.0 / 3.0) *
                              (1 << COS_BIT));
  });
}

static inline i64 half_btf(i32 w0, i64 in0, i32 w1, i64 in1) {
  return round2(w0 * in0 + w1 * in1, COS_BIT);
}

static void idct4(const i32* x, i32* o) {
  const i64* c = COSPI;
  i32 s0 = half_btf(c[32], x[0], c[32], x[2]);
  i32 s1 = half_btf(c[32], x[0], -c[32], x[2]);
  i32 s2 = half_btf(c[48], x[1], -c[16], x[3]);
  i32 s3 = half_btf(c[16], x[1], c[48], x[3]);
  o[0] = s0 + s3; o[1] = s1 + s2; o[2] = s1 - s2; o[3] = s0 - s3;
}

static void idct8(const i32* x, i32* o) {
  const i64* c = COSPI;
  i32 ein[4] = {x[0], x[2], x[4], x[6]};
  i32 e[4];
  idct4(ein, e);
  i32 s4 = half_btf(c[56], x[1], -c[8], x[7]);
  i32 s7 = half_btf(c[8], x[1], c[56], x[7]);
  i32 s5 = half_btf(c[24], x[5], -c[40], x[3]);
  i32 s6 = half_btf(c[40], x[5], c[24], x[3]);
  i32 t4 = s4 + s5, t5 = s4 - s5, t7 = s7 + s6, t6 = s7 - s6;
  i32 u5 = half_btf(c[32], t6, -c[32], t5);
  i32 u6 = half_btf(c[32], t6, c[32], t5);
  i32 od[4] = {t4, u5, u6, t7};
  o[0] = e[0] + od[3]; o[1] = e[1] + od[2];
  o[2] = e[2] + od[1]; o[3] = e[3] + od[0];
  o[4] = e[3] - od[0]; o[5] = e[2] - od[1];
  o[6] = e[1] - od[2]; o[7] = e[0] - od[3];
}

static void idct16(const i32* x, i32* o) {
  const i64* c = COSPI;
  i32 ein[8], e[8];
  for (int i = 0; i < 8; i++) ein[i] = x[2 * i];
  idct8(ein, e);
  i32 s8 = half_btf(c[60], x[1], -c[4], x[15]);
  i32 s15 = half_btf(c[4], x[1], c[60], x[15]);
  i32 s9 = half_btf(c[28], x[9], -c[36], x[7]);
  i32 s14 = half_btf(c[36], x[9], c[28], x[7]);
  i32 s10 = half_btf(c[44], x[5], -c[20], x[11]);
  i32 s13 = half_btf(c[20], x[5], c[44], x[11]);
  i32 s11 = half_btf(c[12], x[13], -c[52], x[3]);
  i32 s12 = half_btf(c[52], x[13], c[12], x[3]);
  i32 t8 = s8 + s9, t9 = s8 - s9;
  i32 t10 = s11 - s10, t11 = s11 + s10;
  i32 t12 = s12 + s13, t13 = s12 - s13;
  i32 t14 = s15 - s14, t15 = s15 + s14;
  i32 u9 = half_btf(-c[16], t9, c[48], t14);
  i32 u14 = half_btf(c[48], t9, c[16], t14);
  i32 u10 = half_btf(-c[48], t10, -c[16], t13);
  i32 u13 = half_btf(-c[16], t10, c[48], t13);
  i32 v8 = t8 + t11, v9 = u9 + u10, v10 = u9 - u10, v11 = t8 - t11;
  i32 v12 = t15 - t12, v13 = u14 - u13, v14 = u14 + u13, v15 = t15 + t12;
  i32 w10 = half_btf(-c[32], v10, c[32], v13);
  i32 w13 = half_btf(c[32], v10, c[32], v13);
  i32 w11 = half_btf(-c[32], v11, c[32], v12);
  i32 w12 = half_btf(c[32], v11, c[32], v12);
  i32 od[8] = {v8, v9, w10, w11, w12, w13, v14, v15};
  for (int i = 0; i < 8; i++) o[i] = e[i] + od[7 - i];
  for (int i = 0; i < 8; i++) o[8 + i] = e[7 - i] - od[i];
}

static void idct32(const i32* x, i32* o) {
  const i64* c = COSPI;
  i32 ein[16], e[16];
  for (int i = 0; i < 16; i++) ein[i] = x[2 * i];
  idct16(ein, e);
  i32 xo[16] = {x[1], x[3], x[5], x[7], x[9], x[11], x[13], x[15],
                x[17], x[19], x[21], x[23], x[25], x[27], x[29], x[31]};
  i32 s[16];
  s[0] = half_btf(c[62], xo[0], -c[2], xo[15]);
  s[15] = half_btf(c[2], xo[0], c[62], xo[15]);
  s[1] = half_btf(c[30], xo[8], -c[34], xo[7]);
  s[14] = half_btf(c[34], xo[8], c[30], xo[7]);
  s[2] = half_btf(c[46], xo[4], -c[18], xo[11]);
  s[13] = half_btf(c[18], xo[4], c[46], xo[11]);
  s[3] = half_btf(c[14], xo[12], -c[50], xo[3]);
  s[12] = half_btf(c[50], xo[12], c[14], xo[3]);
  s[4] = half_btf(c[54], xo[2], -c[10], xo[13]);
  s[11] = half_btf(c[10], xo[2], c[54], xo[13]);
  s[5] = half_btf(c[22], xo[10], -c[42], xo[5]);
  s[10] = half_btf(c[42], xo[10], c[22], xo[5]);
  s[6] = half_btf(c[38], xo[6], -c[26], xo[9]);
  s[9] = half_btf(c[26], xo[6], c[38], xo[9]);
  s[7] = half_btf(c[6], xo[14], -c[58], xo[1]);
  s[8] = half_btf(c[58], xo[14], c[6], xo[1]);
  i32 t[16];
  t[0] = s[0] + s[1]; t[1] = s[0] - s[1];
  t[3] = s[3] + s[2]; t[2] = s[3] - s[2];
  t[4] = s[4] + s[5]; t[5] = s[4] - s[5];
  t[7] = s[7] + s[6]; t[6] = s[7] - s[6];
  t[8] = s[8] + s[9]; t[9] = s[8] - s[9];
  t[11] = s[11] + s[10]; t[10] = s[11] - s[10];
  t[12] = s[12] + s[13]; t[13] = s[12] - s[13];
  t[15] = s[15] + s[14]; t[14] = s[15] - s[14];
  i32 u[16];
  for (int i = 0; i < 16; i++) u[i] = t[i];
  u[1] = half_btf(-c[8], t[1], c[56], t[14]);
  u[14] = half_btf(c[56], t[1], c[8], t[14]);
  u[2] = half_btf(-c[56], t[2], -c[8], t[13]);
  u[13] = half_btf(-c[8], t[2], c[56], t[13]);
  u[5] = half_btf(-c[40], t[5], c[24], t[10]);
  u[10] = half_btf(c[24], t[5], c[40], t[10]);
  u[6] = half_btf(-c[24], t[6], -c[40], t[9]);
  u[9] = half_btf(-c[40], t[6], c[24], t[9]);
  i64 v[16];
  v[0] = u[0] + u[3]; v[3] = u[0] - u[3];
  v[1] = u[1] + u[2]; v[2] = u[1] - u[2];
  v[7] = u[7] + u[4]; v[4] = u[7] - u[4];
  v[6] = u[6] + u[5]; v[5] = u[6] - u[5];
  v[8] = u[8] + u[11]; v[11] = u[8] - u[11];
  v[9] = u[9] + u[10]; v[10] = u[9] - u[10];
  v[15] = u[15] + u[12]; v[12] = u[15] - u[12];
  v[14] = u[14] + u[13]; v[13] = u[14] - u[13];
  i64 w[16];
  for (int i = 0; i < 16; i++) w[i] = v[i];
  w[2] = half_btf(-c[16], v[2], c[48], v[13]);
  w[13] = half_btf(c[48], v[2], c[16], v[13]);
  w[3] = half_btf(-c[16], v[3], c[48], v[12]);
  w[12] = half_btf(c[48], v[3], c[16], v[12]);
  w[4] = half_btf(-c[48], v[4], -c[16], v[11]);
  w[11] = half_btf(-c[16], v[4], c[48], v[11]);
  w[5] = half_btf(-c[48], v[5], -c[16], v[10]);
  w[10] = half_btf(-c[16], v[5], c[48], v[10]);
  i64 a[16];
  a[0] = w[0] + w[7]; a[7] = w[0] - w[7];
  a[1] = w[1] + w[6]; a[6] = w[1] - w[6];
  a[2] = w[2] + w[5]; a[5] = w[2] - w[5];
  a[3] = w[3] + w[4]; a[4] = w[3] - w[4];
  a[8] = w[15] - w[8]; a[15] = w[15] + w[8];
  a[9] = w[14] - w[9]; a[14] = w[14] + w[9];
  a[10] = w[13] - w[10]; a[13] = w[13] + w[10];
  a[11] = w[12] - w[11]; a[12] = w[12] + w[11];
  i64 b[16];
  for (int i = 0; i < 16; i++) b[i] = a[i];
  b[4] = half_btf(-c[32], a[4], c[32], a[11]);
  b[11] = half_btf(c[32], a[4], c[32], a[11]);
  b[5] = half_btf(-c[32], a[5], c[32], a[10]);
  b[10] = half_btf(c[32], a[5], c[32], a[10]);
  b[6] = half_btf(-c[32], a[6], c[32], a[9]);
  b[9] = half_btf(c[32], a[6], c[32], a[9]);
  b[7] = half_btf(-c[32], a[7], c[32], a[8]);
  b[8] = half_btf(c[32], a[7], c[32], a[8]);
  for (int i = 0; i < 16; i++) o[i] = e[i] + b[15 - i];
  for (int i = 0; i < 16; i++) o[16 + i] = e[15 - i] - b[i];
}

static int brev(int nbits, int v) {
  int out = 0;
  for (int i = 0; i < nbits; i++) out |= ((v >> i) & 1) << (nbits - 1 - i);
  return out;
}

static void idct64(const i32* x, i32* o) {
  const i64* c = COSPI;
  i32 ein[32], e[32];
  for (int i = 0; i < 32; i++) ein[i] = x[2 * i];
  idct32(ein, e);
  i32 s[32];
  for (int j = 0; j < 16; j++) {
    int a = brev(6, 32 + j);
    i64 xi = x[a], xj = x[64 - a];
    s[j] = half_btf(c[64 - a], xi, -c[a], xj);
    s[31 - j] = half_btf(c[a], xi, c[64 - a], xj);
  }
  i32 t[32];
  for (int p = 0; p < 16; p++) {
    int i0 = 2 * p, i1 = 2 * p + 1;
    if (p % 2 == 0) { t[i0] = s[i0] + s[i1]; t[i1] = s[i0] - s[i1]; }
    else { t[i1] = s[i1] + s[i0]; t[i0] = s[i1] - s[i0]; }
  }
  i32 u[32];
  for (int i = 0; i < 32; i++) u[i] = t[i];
  for (int k = 0; k < 8; k++) {
    int b = 4 * brev(4, 8 + k);
    int i0 = 4 * k + 1, i1 = 4 * k + 2;
    int j0 = 30 - 4 * k, j1 = 29 - 4 * k;
    u[i0] = half_btf(c[b], t[i0], -c[64 - b], t[j0]);
    u[j0] = half_btf(-c[64 - b], t[i0], -c[b], t[j0]);
    u[i1] = half_btf(c[64 - b], t[i1], c[b], t[j1]);
    u[j1] = half_btf(c[b], t[i1], -c[64 - b], t[j1]);
  }
  i64 v[32];
  for (int g = 0; g < 8; g++) {
    int off = 4 * g;
    if (g % 2 == 0) {
      v[off] = u[off] + u[off + 3]; v[off + 3] = u[off] - u[off + 3];
      v[off + 1] = u[off + 1] + u[off + 2];
      v[off + 2] = u[off + 1] - u[off + 2];
    } else {
      v[off + 3] = u[off + 3] + u[off]; v[off] = u[off + 3] - u[off];
      v[off + 2] = u[off + 2] + u[off + 1];
      v[off + 1] = u[off + 2] - u[off + 1];
    }
  }
  i64 w[32];
  for (int i = 0; i < 32; i++) w[i] = v[i];
  {
    const int spec[8][4] = {
      {2, 29, 8, 0}, {3, 28, 8, 0}, {4, 27, 8, 1}, {5, 26, 8, 1},
      {10, 21, 40, 0}, {11, 20, 40, 0}, {12, 19, 40, 1}, {13, 18, 40, 1},
    };
    for (int q = 0; q < 8; q++) {
      int i = spec[q][0], j = spec[q][1], b = spec[q][2], form = spec[q][3];
      if (form == 0) {
        w[i] = half_btf(-c[b], v[i], c[64 - b], v[j]);
        w[j] = half_btf(c[64 - b], v[i], c[b], v[j]);
      } else {
        w[i] = half_btf(-c[64 - b], v[i], -c[b], v[j]);
        w[j] = half_btf(-c[b], v[i], c[64 - b], v[j]);
      }
    }
  }
  i64 a6[32];
  for (int g = 0; g < 4; g++) {
    int off = 8 * g;
    for (int i = 0; i < 4; i++) {
      int lo = off + i, hi = off + 7 - i;
      if (g % 2 == 0) { a6[lo] = w[lo] + w[hi]; a6[hi] = w[lo] - w[hi]; }
      else { a6[hi] = w[hi] + w[lo]; a6[lo] = w[hi] - w[lo]; }
    }
  }
  i64 b7[32];
  for (int i = 0; i < 32; i++) b7[i] = a6[i];
  for (int i = 4; i < 8; i++) {
    int j = 31 - i;
    b7[i] = half_btf(-c[16], a6[i], c[48], a6[j]);
    b7[j] = half_btf(c[48], a6[i], c[16], a6[j]);
  }
  for (int i = 8; i < 12; i++) {
    int j = 31 - i;
    b7[i] = half_btf(-c[48], a6[i], -c[16], a6[j]);
    b7[j] = half_btf(-c[16], a6[i], c[48], a6[j]);
  }
  i64 r8[32];
  for (int i = 0; i < 8; i++) {
    int lo = i, hi = 15 - i;
    r8[lo] = b7[lo] + b7[hi]; r8[hi] = b7[lo] - b7[hi];
    int lo2 = 16 + i, hi2 = 31 - i;
    r8[hi2] = b7[hi2] + b7[lo2]; r8[lo2] = b7[hi2] - b7[lo2];
  }
  i64 q[32];
  for (int i = 0; i < 32; i++) q[i] = r8[i];
  for (int i = 8; i < 16; i++) {
    int j = 31 - i;
    q[i] = half_btf(-c[32], r8[i], c[32], r8[j]);
    q[j] = half_btf(c[32], r8[i], c[32], r8[j]);
  }
  for (int i = 0; i < 32; i++) o[i] = e[i] + q[31 - i];
  for (int i = 0; i < 32; i++) o[32 + i] = e[31 - i] - q[i];
}

static void iadst4(const i32* x, i32* o) {
  const i64* sp = SINPI;
  i64 x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
  i32 s0 = sp[1] * x0;
  i32 s1 = sp[2] * x0;
  i32 s2 = sp[3] * x1;
  i32 s3 = sp[4] * x2;
  i32 s4 = sp[1] * x2;
  i32 s5 = sp[2] * x3;
  i32 s6 = sp[4] * x3;
  i32 s7 = (x0 - x2) + x3;
  s0 = s0 + s3;
  s1 = s1 - s4;
  s3 = s2;
  s2 = sp[3] * s7;
  s0 = s0 + s5;
  s1 = s1 - s6;
  i64 y0 = s0 + s3, y1 = s1 + s3, y2 = s2, y3 = (s0 + s1) - s3;
  o[0] = round2(y0, COS_BIT); o[1] = round2(y1, COS_BIT);
  o[2] = round2(y2, COS_BIT); o[3] = round2(y3, COS_BIT);
}

static void iadst8(const i32* x, i32* o) {
  const i64* c = COSPI;
  i64 b[8] = {x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]};
  i32 s[8] = {
    half_btf(c[4], b[0], c[60], b[1]),
    half_btf(c[60], b[0], -c[4], b[1]),
    half_btf(c[20], b[2], c[44], b[3]),
    half_btf(c[44], b[2], -c[20], b[3]),
    half_btf(c[36], b[4], c[28], b[5]),
    half_btf(c[28], b[4], -c[36], b[5]),
    half_btf(c[52], b[6], c[12], b[7]),
    half_btf(c[12], b[6], -c[52], b[7]),
  };
  i32 t[8] = {s[0] + s[4], s[1] + s[5], s[2] + s[6], s[3] + s[7],
              s[0] - s[4], s[1] - s[5], s[2] - s[6], s[3] - s[7]};
  i32 u[8] = {t[0], t[1], t[2], t[3],
              half_btf(c[16], t[4], c[48], t[5]),
              half_btf(c[48], t[4], -c[16], t[5]),
              half_btf(-c[48], t[6], c[16], t[7]),
              half_btf(c[16], t[6], c[48], t[7])};
  i64 v[8] = {u[0] + u[2], u[1] + u[3], u[0] - u[2], u[1] - u[3],
              u[4] + u[6], u[5] + u[7], u[4] - u[6], u[5] - u[7]};
  i64 w[8] = {v[0], v[1],
              half_btf(c[32], v[2], c[32], v[3]),
              half_btf(c[32], v[2], -c[32], v[3]),
              v[4], v[5],
              half_btf(c[32], v[6], c[32], v[7]),
              half_btf(c[32], v[6], -c[32], v[7])};
  o[0] = w[0]; o[1] = -w[4]; o[2] = w[6]; o[3] = -w[2];
  o[4] = w[3]; o[5] = -w[7]; o[6] = w[5]; o[7] = -w[1];
}

static void iadst16(const i32* x, i32* o) {
  const i64* c = COSPI;
  i64 b[16] = {x[15], x[0], x[13], x[2], x[11], x[4], x[9], x[6],
               x[7], x[8], x[5], x[10], x[3], x[12], x[1], x[14]};
  i32 s[16];
  for (int k = 0; k < 8; k++) {
    int ang = 2 + 8 * k;
    s[2 * k] = half_btf(c[ang], b[2 * k], c[64 - ang], b[2 * k + 1]);
    s[2 * k + 1] = half_btf(c[64 - ang], b[2 * k], -c[ang], b[2 * k + 1]);
  }
  i32 t[16];
  for (int i = 0; i < 8; i++) t[i] = s[i] + s[i + 8];
  for (int i = 0; i < 8; i++) t[8 + i] = s[i] - s[i + 8];
  i32 u[16];
  for (int i = 0; i < 8; i++) u[i] = t[i];
  u[8] = half_btf(c[8], t[8], c[56], t[9]);
  u[9] = half_btf(c[56], t[8], -c[8], t[9]);
  u[10] = half_btf(c[40], t[10], c[24], t[11]);
  u[11] = half_btf(c[24], t[10], -c[40], t[11]);
  u[12] = half_btf(-c[56], t[12], c[8], t[13]);
  u[13] = half_btf(c[8], t[12], c[56], t[13]);
  u[14] = half_btf(-c[24], t[14], c[40], t[15]);
  u[15] = half_btf(c[40], t[14], c[24], t[15]);
  i64 v[16] = {u[0] + u[4], u[1] + u[5], u[2] + u[6], u[3] + u[7],
               u[0] - u[4], u[1] - u[5], u[2] - u[6], u[3] - u[7],
               u[8] + u[12], u[9] + u[13], u[10] + u[14], u[11] + u[15],
               u[8] - u[12], u[9] - u[13], u[10] - u[14], u[11] - u[15]};
  i64 w[16];
  for (int i = 0; i < 4; i++) w[i] = v[i];
  w[4] = half_btf(c[16], v[4], c[48], v[5]);
  w[5] = half_btf(c[48], v[4], -c[16], v[5]);
  w[6] = half_btf(-c[48], v[6], c[16], v[7]);
  w[7] = half_btf(c[16], v[6], c[48], v[7]);
  for (int i = 8; i < 12; i++) w[i] = v[i];
  w[12] = half_btf(c[16], v[12], c[48], v[13]);
  w[13] = half_btf(c[48], v[12], -c[16], v[13]);
  w[14] = half_btf(-c[48], v[14], c[16], v[15]);
  w[15] = half_btf(c[16], v[14], c[48], v[15]);
  i64 a[16];
  {
    int idx = 0;
    const int offs[4] = {0, 4, 8, 12};
    for (int oi = 0; oi < 4; oi++) {
      int off = offs[oi];
      a[idx++] = w[off] + w[off + 2];
      a[idx++] = w[off + 1] + w[off + 3];
      a[idx++] = w[off] - w[off + 2];
      a[idx++] = w[off + 1] - w[off + 3];
    }
  }
  i64 z[16];
  {
    int idx = 0;
    const int offs[4] = {0, 4, 8, 12};
    for (int oi = 0; oi < 4; oi++) {
      int off = offs[oi];
      z[idx++] = a[off];
      z[idx++] = a[off + 1];
      z[idx++] = half_btf(c[32], a[off + 2], c[32], a[off + 3]);
      z[idx++] = half_btf(c[32], a[off + 2], -c[32], a[off + 3]);
    }
  }
  o[0] = z[0]; o[1] = -z[8]; o[2] = z[12]; o[3] = -z[4];
  o[4] = z[6]; o[5] = -z[14]; o[6] = z[10]; o[7] = -z[2];
  o[8] = z[3]; o[9] = -z[11]; o[10] = z[15]; o[11] = -z[7];
  o[12] = z[5]; o[13] = -z[13]; o[14] = z[9]; o[15] = -z[1];
}

static void iidentity(const i32* x, i32* o, int n) {
  if (n == 4) for (int i = 0; i < 4; i++) o[i] = round2(x[i] * NEW_SQRT2, 12);
  else if (n == 8) for (int i = 0; i < 8; i++) o[i] = x[i] * 2;
  else if (n == 16)
    for (int i = 0; i < 16; i++) o[i] = round2(x[i] * 2 * NEW_SQRT2, 12);
  else for (int i = 0; i < 32; i++) o[i] = x[i] * 4;
}

// kind: 0 = DCT, 1 = ADST, 2 = identity
static void txfm1d(int kind, int n, const i32* x, i32* o) {
  if (kind == 2) { iidentity(x, o, n); return; }
  if (kind == 0) {
    switch (n) {
      case 4: idct4(x, o); return;
      case 8: idct8(x, o); return;
      case 16: idct16(x, o); return;
      case 32: idct32(x, o); return;
      default: idct64(x, o); return;
    }
  }
  switch (n) {
    case 4: iadst4(x, o); return;
    case 8: iadst8(x, o); return;
    default: iadst16(x, o); return;
  }
}

// tx_type -> (vkind, hkind, ud_flip, lr_flip)
static const int TX1D[16][4] = {
  {0, 0, 0, 0}, {1, 0, 0, 0}, {0, 1, 0, 0}, {1, 1, 0, 0},
  {1, 0, 1, 0}, {0, 1, 0, 1}, {1, 1, 1, 1}, {1, 1, 0, 1},
  {1, 1, 1, 0}, {2, 2, 0, 0}, {0, 2, 0, 0}, {2, 0, 0, 0},
  {1, 2, 0, 0}, {2, 1, 0, 0}, {1, 2, 1, 0}, {2, 1, 0, 1},
};

static void shift_pair(int tw, int th, int* sh_row, int* sh_col) {
  // itx.py _SHIFTS: right-shift amounts (positive here)
  *sh_col = 4;
  int mx = std::max(tw, th);
  if (tw == th) {
    *sh_row = tw == 4 ? 0 : (tw == 8 ? 1 : 2);
  } else if ((tw == 4 && th == 8) || (tw == 8 && th == 4)) {
    *sh_row = 0;
  } else if ((tw == 8 && th == 16) || (tw == 16 && th == 8) ||
             (tw == 16 && th == 32) || (tw == 32 && th == 16) ||
             (tw == 32 && th == 64) || (tw == 64 && th == 32) ||
             (tw == 4 && th == 16) || (tw == 16 && th == 4)) {
    *sh_row = 1;
  } else {
    *sh_row = 2;  // 8x32, 32x8, 16x64, 64x16
  }
  (void)mx;
}

// full 2-D inverse transform: coeffs (ch, cw) into res (th, tw)
static void inv_txfm2d(const i32* coeffs, int cw, int ch, int tw, int th,
                       int tx_type, i32* res) {
  int vk = TX1D[tx_type][0], hk = TX1D[tx_type][1];
  int ud_flip = TX1D[tx_type][2], lr_flip = TX1D[tx_type][3];
  int sh_row, sh_col;
  shift_pair(tw, th, &sh_row, &sh_col);
  i32 buf[64 * 64];
  memset(buf, 0, sizeof(i32) * th * tw);
  for (int r = 0; r < ch; r++)
    for (int c2 = 0; c2 < cw; c2++) buf[(i64)r * tw + c2] = coeffs[r * cw + c2];
  // rows at/after the last nonzero coefficient row transform to all
  // zeros in the row pass (every 1-D transform maps 0 -> 0), so only
  // the populated prefix needs work
  int n_rows = 0;
  for (int r = ch - 1; r >= 0; r--) {
    bool nz = false;
    for (int c2 = 0; c2 < cw; c2++)
      if (buf[(i64)r * tw + c2]) { nz = true; break; }
    if (nz) { n_rows = r + 1; break; }
  }
  int lw = floor_log2(tw), lh = floor_log2(th);
  bool rect2 = std::abs(lw - lh) == 1;
  if (rect2)
    for (i64 i = 0; i < (i64)n_rows * tw; i++)
      buf[i] = round2(buf[i] * INV_SQRT2, 12);
  // row pass (horizontal transform of each row)
  i32 tmp_in[64], tmp_out[64];
  for (int r = 0; r < n_rows; r++) {
    for (int c2 = 0; c2 < tw; c2++) tmp_in[c2] = buf[(i64)r * tw + c2];
    txfm1d(hk, tw, tmp_in, tmp_out);
    for (int c2 = 0; c2 < tw; c2++)
      buf[(i64)r * tw + c2] = round2(tmp_out[c2], sh_row);
  }
  if (lr_flip)
    for (int r = 0; r < th; r++)
      for (int c2 = 0; c2 < tw / 2; c2++)
        std::swap(buf[(i64)r * tw + c2], buf[(i64)r * tw + tw - 1 - c2]);
  // column pass
  for (int c2 = 0; c2 < tw; c2++) {
    for (int r = 0; r < th; r++) tmp_in[r] = buf[(i64)r * tw + c2];
    txfm1d(vk, th, tmp_in, tmp_out);
    for (int r = 0; r < th; r++)
      buf[(i64)r * tw + c2] = round2(tmp_out[r], sh_col);
  }
  if (ud_flip)
    for (int r = 0; r < th / 2; r++)
      for (int c2 = 0; c2 < tw; c2++)
        std::swap(buf[(i64)r * tw + c2], buf[(i64)(th - 1 - r) * tw + c2]);
  for (i64 i = 0; i < (i64)th * tw; i++) res[i] = buf[i];
}

// inverse 4x4 Walsh-Hadamard (recon.py iwht4; lossless)
static void iwht4(const i32* in, i32* out) {
  i32 m[16];
  for (int i = 0; i < 16; i++) m[i] = in[i] >> 2;
  // rows then columns, butterfly over (a, c, d, b) element order
  for (int r = 0; r < 4; r++) {
    i64 a = m[r * 4 + 0], c2 = m[r * 4 + 1], d = m[r * 4 + 2],
        b = m[r * 4 + 3];
    a = a + c2; d = d - b;
    i32 e = (a - d) >> 1;
    b = e - b; c2 = e - c2;
    a = a - b; d = d + c2;
    m[r * 4 + 0] = a; m[r * 4 + 1] = b; m[r * 4 + 2] = c2; m[r * 4 + 3] = d;
  }
  for (int c2 = 0; c2 < 4; c2++) {
    i64 a = m[0 * 4 + c2], cc = m[1 * 4 + c2], d = m[2 * 4 + c2],
        b = m[3 * 4 + c2];
    a = a + cc; d = d - b;
    i32 e = (a - d) >> 1;
    b = e - b; cc = e - cc;
    a = a - b; d = d + cc;
    m[0 * 4 + c2] = a; m[1 * 4 + c2] = b; m[2 * 4 + c2] = cc;
    m[3 * 4 + c2] = d;
  }
  for (int i = 0; i < 16; i++) out[i] = m[i];
}

}  // namespace av1n

namespace av1n {

// ======================================================================
// Palette helpers (codecs/av1/palette.py)
// ======================================================================

static const int PALETTE_MAX_SIZE = 8;
static const int PAL_W[3] = {2, 1, 2};      // left, above-left, above
static const int PAL_HM[3] = {1, 2, 2};

static int pal_ctx_lookup(int h) {
  switch (h) {
    case 2: return 0;
    case 5: return 4;
    case 6: return 3;
    case 7: return 2;
    case 8: return 1;
  }
  return 0;
}

static int ceil_log2(int n) {
  if (n < 2) return 0;
  return bitlen(n - 1);
}

static int read_uniform(Msac& r, int n) {
  int l = bitlen(n);
  int m = (1 << l) - n;
  int v = l > 1 ? r.read_literal(l - 1) : 0;
  if (v < m) return v;
  return (v << 1) - m + r.read_literal(1);
}

// merged sorted color cache (palette.py get_palette_cache)
static int palette_cache(const u8* n_map, const i32* c_map, int mi_cols,
                         int mi_r, int mi_c, int mr0, int mc0, int* out) {
  const i32* above = nullptr;
  int n_above = 0;
  const i32* left = nullptr;
  int n_left = 0;
  if ((mi_r * 4) % 64 != 0 && mi_r > mr0) {
    i64 idx = (i64)(mi_r - 1) * mi_cols + mi_c;
    n_above = n_map[idx];
    above = c_map + idx * PALETTE_MAX_SIZE;
  }
  if (mi_c > mc0) {
    i64 idx = (i64)mi_r * mi_cols + mi_c - 1;
    n_left = n_map[idx];
    left = c_map + idx * PALETTE_MAX_SIZE;
  }
  int n_out = 0;
  int i = 0, j = 0;
  while (i < n_above && j < n_left) {
    int va = above[i], vl = left[j];
    if (vl < va) {
      if (n_out == 0 || vl != out[n_out - 1]) out[n_out++] = vl;
      j++;
    } else {
      if (n_out == 0 || va != out[n_out - 1]) out[n_out++] = va;
      i++;
      if (vl == va) j++;
    }
  }
  for (; i < n_above; i++)
    if (n_out == 0 || above[i] != out[n_out - 1]) out[n_out++] = above[i];
  for (; j < n_left; j++)
    if (n_out == 0 || left[j] != out[n_out - 1]) out[n_out++] = left[j];
  return n_out;
}

static void read_colors_y(Msac& r, const int* cache, int n_cache, int n,
                          int bd, int* out) {
  int cached[PALETTE_MAX_SIZE];
  int nc = 0;
  for (int i = 0; i < n_cache && nc < n; i++)
    if (r.read_literal(1)) cached[nc++] = cache[i];
  int rest[PALETTE_MAX_SIZE];
  int nr = 0;
  if (nc < n) {
    rest[nr++] = r.read_literal(bd);
    if (nc + nr < n) {
      int min_bits = bd - 3;
      int bits = min_bits + r.read_literal(2);
      int rng = (1 << bd) - rest[nr - 1] - 1;
      while (nc + nr < n) {
        int delta = r.read_literal(bits) + 1;
        int v = (int)clampi(rest[nr - 1] + delta, 0, (1 << bd) - 1);
        rng -= v - rest[nr - 1];
        rest[nr++] = v;
        bits = std::min(bits, ceil_log2(rng));
      }
    }
  }
  for (int i = 0; i < nc; i++) out[i] = cached[i];
  for (int i = 0; i < nr; i++) out[nc + i] = rest[i];
  std::sort(out, out + n);
}

static void read_colors_uv(Msac& r, const int* cache, int n_cache, int n,
                           int bd, int* out_u, int* out_v) {
  int cached[PALETTE_MAX_SIZE];
  int nc = 0;
  for (int i = 0; i < n_cache && nc < n; i++)
    if (r.read_literal(1)) cached[nc++] = cache[i];
  int rest[PALETTE_MAX_SIZE];
  int nr = 0;
  if (nc < n) {
    rest[nr++] = r.read_literal(bd);
    if (nc + nr < n) {
      int min_bits = bd - 3;
      int bits = min_bits + r.read_literal(2);
      int rng = (1 << bd) - rest[nr - 1];
      while (nc + nr < n) {
        int delta = r.read_literal(bits);
        int v = (int)clampi(rest[nr - 1] + delta, 0, (1 << bd) - 1);
        rng -= v - rest[nr - 1];
        rest[nr++] = v;
        bits = std::min(bits, ceil_log2(rng));
      }
    }
  }
  for (int i = 0; i < nc; i++) out_u[i] = cached[i];
  for (int i = 0; i < nr; i++) out_u[nc + i] = rest[i];
  std::sort(out_u, out_u + n);

  int max_val = 1 << bd;
  if (r.read_literal(1)) {  // delta encoding
    int bits = (bd - 4) + r.read_literal(2);
    out_v[0] = r.read_literal(bd);
    for (int i = 1; i < n; i++) {
      int delta = r.read_literal(bits);
      if (delta && r.read_literal(1)) delta = -delta;
      int v = out_v[i - 1] + delta;
      if (v < 0) v += max_val;
      if (v >= max_val) v -= max_val;
      out_v[i] = v;
    }
  } else {
    for (int i = 0; i < n; i++) out_v[i] = r.read_literal(bd);
  }
}

static int color_index_context(const u8* m, int stride, int row, int col,
                               int n, int* order) {
  int scores[PALETTE_MAX_SIZE] = {0};
  if (col > 0) scores[m[row * stride + col - 1]] += PAL_W[0];
  if (row > 0 && col > 0) scores[m[(row - 1) * stride + col - 1]] += PAL_W[1];
  if (row > 0) scores[m[(row - 1) * stride + col]] += PAL_W[2];
  for (int i = 0; i < PALETTE_MAX_SIZE; i++) order[i] = i;
  for (int i = 0; i < 3; i++) {
    int max_v = scores[i];
    int max_idx = i;
    for (int j = i + 1; j < n; j++)
      if (scores[j] > max_v) { max_v = scores[j]; max_idx = j; }
    if (max_idx != i) {
      int max_score = scores[max_idx];
      int max_order = order[max_idx];
      for (int k = max_idx; k > i; k--) {
        scores[k] = scores[k - 1];
        order[k] = order[k - 1];
      }
      scores[i] = max_score;
      order[i] = max_order;
    }
  }
  int hsh = scores[0] * PAL_HM[0] + scores[1] * PAL_HM[1] +
            scores[2] * PAL_HM[2];
  return pal_ctx_lookup(hsh);
}

// wavefront index-map parse (palette.py read_color_map)
static void read_color_map(Msac& r, u16 (*cdf_rows)[5][9], int n, int rows,
                           int cols, int block_h, int block_w, u8* m) {
  memset(m, 0, (size_t)block_h * block_w);
  m[0] = (u8)read_uniform(r, n);
  int order[PALETTE_MAX_SIZE];
  for (int i = 1; i < rows + cols - 1; i++) {
    int r0 = std::max(0, i - cols + 1), r1 = std::min(i, rows - 1);
    for (int row = r0; row <= r1; row++) {
      int col = i - row;
      int ctx = color_index_context(m, block_w, row, col, n, order);
      int sym = r.read_symbol_n(cdf_rows[n - 2][ctx], n);
      m[row * block_w + col] = (u8)order[sym];
    }
  }
  for (int row = 0; row < rows; row++)
    for (int col = cols; col < block_w; col++)
      m[row * block_w + col] = m[row * block_w + cols - 1];
  for (int row = rows; row < block_h; row++)
    for (int col = 0; col < block_w; col++)
      m[row * block_w + col] = m[(rows - 1) * block_w + col];
}

// ======================================================================
// Frame context + tile parser (codecs/av1/tile.py)
// ======================================================================

static const int SKIP_CONTEXTS_TAB[5][5] = {
  {1, 2, 2, 2, 3}, {1, 4, 4, 4, 5}, {1, 4, 4, 4, 5},
  {1, 4, 4, 4, 5}, {1, 4, 4, 4, 6},
};
static const int EOB_GROUP_START[12] = {0,1,2,3,5,9,17,33,65,129,257,513};
static const int EOB_OFFSET_BITS[12] = {0,0,0,1,2,3,4,5,6,7,8,9};

// tx class: 0 = 2d, 1 = h (H_*), 2 = v (V_*)
static int tx_class_of(int tx_type) {
  if (tx_type == V_DCT || tx_type == V_ADST || tx_type == V_FLIPADST)
    return 2;
  if (tx_type == H_DCT || tx_type == H_ADST || tx_type == H_FLIPADST)
    return 1;
  return 0;
}

static const int EXT_TX_SET_INTRA_1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT,
                                          ADST_ADST, ADST_DCT, DCT_ADST};
static const int EXT_TX_SET_INTER_1[16] = {IDTX, V_DCT, H_DCT, V_ADST,
    H_ADST, V_FLIPADST, H_FLIPADST, DCT_DCT, ADST_DCT, DCT_ADST,
    FLIPADST_DCT, DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST,
    ADST_FLIPADST, FLIPADST_ADST};
static const int EXT_TX_SET_INTER_2[12] = {IDTX, V_DCT, H_DCT, DCT_DCT,
    ADST_DCT, DCT_ADST, FLIPADST_DCT, DCT_FLIPADST, ADST_ADST,
    FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
static const int EXT_TX_SET_INTER_3[2] = {IDTX, DCT_DCT};
static const int EXT_TX_SET_INTRA_2[5] = {IDTX, DCT_DCT, ADST_ADST,
                                          ADST_DCT, DCT_ADST};

struct FrameCtx {
  Params p;
  PredTables pt;
  int mi_cols, mi_rows, sb_mi, num_planes;
  int bd;
  i64 mi_total;
  // planes: 0=Y (padded mi area), 1=U, 2=V
  PlaneView planes[3];
  std::vector<u16> plane_buf[3];
  // frame-lifetime maps (mi granularity)
  std::vector<i32> y_modes, uv_modes, skip_map, pal_y_flag, tx_wide, tx_high;
  std::vector<i32> cdef_idx;
  // intrabc state (tile.py ibc_on / ibc_mv / bsize_map / txtype_map)
  std::vector<u8> ibc_on;
  std::vector<i32> ibc_mv;            // [mi][2] (row, col) 1/8 pel
  std::vector<i32> bsize_map;
  std::vector<i32> txtype_map;
  bool use_intrabc_cur = false;
  int cur_partition = 0;
  std::vector<u8> pal_y_n, pal_u_n;
  std::vector<i32> pal_y_c, pal_u_c;
  std::vector<u8> block_decoded[3];   // (mi_rows+2) x (mi_cols+2)
  // deblock edge maps, per plane at 4px granularity over padded dims
  std::vector<u8> edge_vert[3], edge_horz[3];
  std::vector<i32> edge_tw[3], edge_th[3];
  int egw[3], egh[3];
  // loop restoration
  int lr_ur[3], lr_uc[3];
  std::vector<i32> lr_type_map[3];
  std::vector<i32> lr_wiener[3];      // [ur][uc][2][3]
  std::vector<i32> lr_sgr_set[3];
  std::vector<i32> lr_xqd[3];         // [ur][uc][2]
  // per-tile state
  Msac r;
  CdfSet cdf;
  const i32* cdf_defaults;
  int mc0, mc1, mr0, mr1, sb_mi_row, sb_mi_col;
  std::vector<i32> above_part, left_part, above_skip, left_skip;
  std::vector<i32> above_lvl[3], left_lvl[3], above_sign[3], left_sign[3];
  int ref_lr_wiener[3][2][3];
  int ref_sgr_xqd[3][2];
  // block-scope state
  int pal_colors[3][PALETTE_MAX_SIZE];
  int pal_n[3];                       // y, u, v color counts (0 = none)
  std::vector<u8> pal_y_map, pal_uv_map;
  int pal_y_org_x, pal_y_org_y, pal_uv_org_x, pal_uv_org_y;
  int pal_map_w[2];                   // strides of y/uv maps
  int fi_mode;                        // -1 = none
  int cfl_alpha_u, cfl_alpha_v;
  int filt_type_y, filt_type_uv;
  int cur_tx_type, cur_qindex;
  char* err;
  int errlen;
  int rc;

  void fail(int code, const char* msg) {
    if (rc == 0) {
      rc = code;
      snprintf(err, errlen, "%s", msg);
    }
  }

  int init(const Params& pp, const i32* cdf_buf, char* e, int el) {
    p = pp;
    err = e; errlen = el; rc = 0;
    std::call_once(g_tables_once, [] { g_tables.init(); });
    itx_init();
    if (p.bit_depth != 8 && p.bit_depth != 10 && p.bit_depth != 12) {
      fail(2, "unsupported AV1 bit depth");
      return rc;
    }
    if (p.delta_q_present) { fail(2, "delta_q in tiles"); return rc; }
    bd = p.bit_depth;
    mi_cols = p.mi_cols; mi_rows = p.mi_rows;
    mi_total = (i64)mi_rows * mi_cols;
    sb_mi = p.sb128 ? 32 : 16;
    num_planes = p.monochrome ? 1 : 3;
    cdf_defaults = cdf_buf;
    // pred tables live after the CDFs in the same buffer
    i64 off = 0;
    for (int i = 0; i < N_CDF_TABLES; i++) off += CDF_SIZES[i];
    pt.sm_weights = cdf_buf + off; off += EXTRA_SIZES[0];
    pt.dr_deriv = cdf_buf + off; off += EXTRA_SIZES[1];
    pt.fi_taps = cdf_buf + off;

    int pw = mi_cols * 4, ph = mi_rows * 4;
    for (int pl = 0; pl < num_planes; pl++) {
      int w = pl == 0 ? pw : pw >> p.ssx;
      int h = pl == 0 ? ph : ph >> p.ssy;
      plane_buf[pl].assign((i64)w * h, 0);
      planes[pl] = PlaneView{plane_buf[pl].data(), w, h, w};
      egw[pl] = (w + 3) / 4;
      egh[pl] = (h + 3) / 4;
      edge_vert[pl].assign((i64)egh[pl] * egw[pl], 0);
      edge_horz[pl].assign((i64)egh[pl] * egw[pl], 0);
      edge_tw[pl].assign((i64)egh[pl] * egw[pl], 4);
      edge_th[pl].assign((i64)egh[pl] * egw[pl], 4);
    }
    y_modes.assign(mi_total, DC_PRED);
    uv_modes.assign(mi_total, DC_PRED);
    skip_map.assign(mi_total, 0);
    pal_y_flag.assign(mi_total, 0);
    tx_wide.assign(mi_total, 0);
    tx_high.assign(mi_total, 0);
    cdef_idx.assign(mi_total, -1);
    ibc_on.assign(mi_total, 0);
    ibc_mv.assign(mi_total * 2, 0);
    bsize_map.assign(mi_total, 0);
    txtype_map.assign(mi_total, 0);
    pal_y_n.assign(mi_total, 0);
    pal_u_n.assign(mi_total, 0);
    pal_y_c.assign(mi_total * PALETTE_MAX_SIZE, 0);
    pal_u_c.assign(mi_total * PALETTE_MAX_SIZE, 0);
    for (int pl = 0; pl < 3; pl++)
      block_decoded[pl].assign((i64)(mi_rows + 2) * (mi_cols + 2), 0);
    // loop restoration unit grids
    for (int pl = 0; pl < num_planes; pl++) {
      int sub_x = pl == 0 ? 0 : p.ssx;
      int sub_y = pl == 0 ? 0 : p.ssy;
      int usize = p.lr_unit_size[pl];
      int fw = (int)round2(p.frame_w, sub_x);
      int fh = (int)round2(p.frame_h, sub_y);
      int ur = std::max((fh + (usize >> 1)) / usize, 1);
      int uc = std::max((fw + (usize >> 1)) / usize, 1);
      lr_ur[pl] = ur; lr_uc[pl] = uc;
      lr_type_map[pl].assign((i64)ur * uc, 0);
      lr_wiener[pl].assign((i64)ur * uc * 6, 0);
      lr_sgr_set[pl].assign((i64)ur * uc, 0);
      lr_xqd[pl].assign((i64)ur * uc * 2, 0);
    }
    above_part.assign(mi_cols + 32, 0);
    left_part.assign(sb_mi, 0);
    above_skip.assign(mi_cols + 32, 0);
    left_skip.assign(sb_mi, 0);
    for (int pl = 0; pl < 3; pl++) {
      above_lvl[pl].assign(mi_cols + 32, 0);
      left_lvl[pl].assign(sb_mi, 0);
      above_sign[pl].assign(mi_cols + 32, 0);
      left_sign[pl].assign(sb_mi, 0);
    }
    pal_y_map.assign(128 * 128, 0);
    pal_uv_map.assign(128 * 128, 0);
    cur_tx_type = DCT_DCT;
    cur_qindex = p.base_q_idx;
    fi_mode = -1;
    return 0;
  }

  // ---------------------------------------------------------- tile loop

  void decode_tile(const u8* data, i64 size, int c0, int c1, int r0,
                   int r1) {
    r.init(data, size, !p.disable_cdf_update);
    cdf_init_from_buf(&cdf, cdf_defaults);
    mc0 = c0; mc1 = c1; mr0 = r0; mr1 = r1;
    std::fill(above_part.begin(), above_part.end(), 0);
    std::fill(above_skip.begin(), above_skip.end(), 0);
    for (int pl = 0; pl < 3; pl++) {
      std::fill(above_lvl[pl].begin(), above_lvl[pl].end(), 0);
      std::fill(above_sign[pl].begin(), above_sign[pl].end(), 0);
    }
    for (int pl = 0; pl < 3; pl++)
      std::fill(block_decoded[pl].begin(), block_decoded[pl].end(), 0);
    for (int pl = 0; pl < num_planes; pl++) {
      for (int pp2 = 0; pp2 < 2; pp2++) {
        ref_lr_wiener[pl][pp2][0] = 3;
        ref_lr_wiener[pl][pp2][1] = -7;
        ref_lr_wiener[pl][pp2][2] = 15;
      }
      ref_sgr_xqd[pl][0] = -32;
      ref_sgr_xqd[pl][1] = 31;
    }
    int sb_bsize = p.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    for (int mr = mr0; mr < mr1; mr += sb_mi) {
      std::fill(left_part.begin(), left_part.end(), 0);
      std::fill(left_skip.begin(), left_skip.end(), 0);
      for (int pl = 0; pl < 3; pl++) {
        std::fill(left_lvl[pl].begin(), left_lvl[pl].end(), 0);
        std::fill(left_sign[pl].begin(), left_sign[pl].end(), 0);
      }
      sb_mi_row = mr;
      for (int mc = mc0; mc < mc1; mc += sb_mi) {
        sb_mi_col = mc;
        read_lr(mr, mc);
        decode_partition(mr, mc, sb_bsize);
        if (rc) return;
      }
    }
  }

  // -------------------------------------------------- loop restoration

  int decode_subexp_bool(int num_syms, int k) {
    int i = 0, mk = 0;
    while (true) {
      int b2 = i ? k + i - 1 : k;
      int a = 1 << b2;
      if (num_syms <= mk + 3 * a) {
        int n = num_syms - mk;
        int w = bitlen(n);
        int m = (1 << w) - n;
        int v = w > 1 ? r.read_literal(w - 1) : 0;
        if (v < m) return v + mk;
        return ((v << 1) - m + r.read_literal(1)) + mk;
      }
      if (r.read_literal(1)) {
        i++;
        mk += a;
      } else {
        return r.read_literal(b2) + mk;
      }
    }
  }

  int decode_signed_subexp_with_ref(int low, int high, int k, int ref) {
    int mx = high - low;
    int rr = ref - low;
    int v = decode_subexp_bool(mx, k);
    // aom inv_recenter_nonneg: EVEN v above the ref, ODD below
    auto inverse_recenter = [](int r0, int v0) {
      if (v0 > 2 * r0) return v0;
      if (v0 & 1) return r0 - ((v0 + 1) >> 1);
      return r0 + (v0 >> 1);
    };
    if ((rr << 1) <= mx) return inverse_recenter(rr, v) + low;
    return mx - 1 - inverse_recenter(mx - 1 - rr, v) + low;
  }

  void read_lr(int mr, int mc) {
    if (p.allow_intrabc) return;
    static const int WIENER_MIN[3] = {-5, -23, -17};
    static const int WIENER_MAX[3] = {10, 8, 46};
    static const int WIENER_K[3] = {1, 2, 3};
    for (int plane = 0; plane < num_planes; plane++) {
      if (p.lr_type[plane] == 0) continue;
      int sub_x = plane == 0 ? 0 : p.ssx;
      int sub_y = plane == 0 ? 0 : p.ssy;
      int usize = p.lr_unit_size[plane];
      int ur_total = lr_ur[plane], uc_total = lr_uc[plane];
      int row_start = ((mr * 4 >> sub_y) + usize - 1) / usize;
      int row_end = std::min(ur_total,
          (((mr + sb_mi) * 4 >> sub_y) + usize - 1) / usize);
      int numer = 4 >> sub_x;
      int denom = usize;
      int col_start = (mc * numer + denom - 1) / denom;
      int col_end = std::min(uc_total,
          ((mc + sb_mi) * numer + denom - 1) / denom);
      for (int ur = row_start; ur < row_end; ur++)
        for (int uc = col_start; uc < col_end; uc++) {
          // read_lr_unit (spec 5.11.58)
          int frame_type = p.lr_type[plane];
          int unit_type;
          if (frame_type == 1) {
            int sym = r.read_symbol_n(cdf.restore_switchable, 3);
            unit_type = sym == 0 ? 0 : (sym == 1 ? 2 : 3);
          } else if (frame_type == 2) {
            unit_type = r.read_symbol_n(cdf.restore_wiener, 2) ? 2 : 0;
          } else {
            unit_type = r.read_symbol_n(cdf.restore_sgrproj, 2) ? 3 : 0;
          }
          i64 ui = (i64)ur * uc_total + uc;
          lr_type_map[plane][ui] = unit_type;
          if (unit_type == 2) {
            for (int pp2 = 0; pp2 < 2; pp2++) {
              int first = plane ? 1 : 0;
              if (plane) lr_wiener[plane][ui * 6 + pp2 * 3 + 0] = 0;
              for (int j = first; j < 3; j++) {
                int v = decode_signed_subexp_with_ref(
                    WIENER_MIN[j], WIENER_MAX[j] + 1, WIENER_K[j],
                    ref_lr_wiener[plane][pp2][j]);
                lr_wiener[plane][ui * 6 + pp2 * 3 + j] = v;
                ref_lr_wiener[plane][pp2][j] = v;
              }
            }
          } else if (unit_type == 3) {
            static const int SGR_R[16][2] = {
              {2,1},{2,1},{2,1},{2,1},{2,1},{2,1},{2,1},{2,1},
              {2,1},{2,1},{0,1},{0,1},{0,1},{0,1},{2,0},{2,0}};
            static const int XQD_MIN[2] = {-96, -32};
            static const int XQD_MAX[2] = {31, 95};
            int set2 = r.read_literal(4);
            lr_sgr_set[plane][ui] = set2;
            for (int i = 0; i < 2; i++) {
              int radius = SGR_R[set2][i];
              int mn = XQD_MIN[i], mx = XQD_MAX[i];
              int v;
              if (radius) {
                v = decode_signed_subexp_with_ref(mn, mx + 1, 4,
                                                  ref_sgr_xqd[plane][i]);
              } else {
                v = 0;
                if (i == 1)
                  v = (int)clampi((1 << 7) - lr_xqd[plane][ui * 2 + 0],
                                  mn, mx);
              }
              lr_xqd[plane][ui * 2 + i] = v;
              ref_sgr_xqd[plane][i] = v;
            }
          }
        }
    }
  }

  // --------------------------------------------------------- partition

  int prob_of(const u16* cdf_row, int k) {
    int hi = k == 0 ? 32768 : cdf_row[k - 1];
    return hi - cdf_row[k];
  }

  int read_split_bool(const u16* cdf_row, int n_parts, bool vert) {
    int subtract_v[6] = {PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A,
                         PARTITION_VERT_A, PARTITION_VERT_B,
                         PARTITION_VERT_4};
    int subtract_h[6] = {PARTITION_HORZ, PARTITION_SPLIT, PARTITION_HORZ_A,
                         PARTITION_HORZ_B, PARTITION_VERT_A,
                         PARTITION_HORZ_4};
    const int* subtract = vert ? subtract_v : subtract_h;
    int cnt = n_parts > 8 ? 6 : 5;
    int s = 0;
    for (int i = 0; i < cnt; i++)
      if (subtract[i] < n_parts) s += prob_of(cdf_row, subtract[i]);
    // 8 lanes: read_symbol_simd loads (and ignores) all 8; the JAX
    // package's u16 tmp[3] lets that load read past the array
    u16 tmp[8] = {(u16)s, 0, 0, 0, 0, 0, 0, 0};
    return r.read_symbol_n(tmp, 2, /*adapt=*/false);
  }

  void update_partition_ctx(int mr, int mc, int bsize, int subsize) {
    int w = BW[bsize], h = BH[bsize];
    int sw = BW[subsize], sh = BH[subsize];
    int mi_w = w / 4, mi_h = h / 4;
    // 6-bit values: bit 5 answers 128-level queries (tile.py
    // _update_partition_ctx)
    int above_val = (64 - (2 << (bitlen(sw / 4) - 1))) & 63;
    int left_val = (64 - (2 << (bitlen(sh / 4) - 1))) & 63;
    for (int i = 0; i < mi_w; i++)
      if (mc + i < (int)above_part.size()) above_part[mc + i] = above_val;
    int lr0 = mr - sb_mi_row;
    for (int i = 0; i < mi_h; i++)
      if (lr0 + i < (int)left_part.size()) left_part[lr0 + i] = left_val;
  }

  void decode_partition(int mr, int mc, int bsize) {
    if (mr >= mr1 || mc >= mc1 || rc) return;
    int w = BW[bsize], h = BH[bsize];
    int mi_w = w / 4, mi_h = h / 4;
    bool has_rows = mr + mi_h / 2 < mr1;
    bool has_cols = mc + mi_w / 2 < mc1;
    int bsl = bitlen(mi_w) - 1;

    int part;
    if (bsize == BLOCK_4X4) {
      part = PARTITION_NONE;
    } else {
      int above = (above_part[mc] >> bsl) & 1;
      int left = (left_part[mr - sb_mi_row] >> bsl) & 1;
      int ctx = left * 2 + above;
      u16* cdf_row = cdf.partition[(bsl - 1) * 4 + ctx];
      int n_parts = bsize == BLOCK_8X8 ? 4 :
                    (bsize == BLOCK_128X128 ? 8 : 10);
      if (has_rows && has_cols) {
        part = r.read_symbol_n(cdf_row, n_parts);
      } else if (has_cols) {
        int split = read_split_bool(cdf_row, n_parts, true);
        part = split ? PARTITION_SPLIT : PARTITION_HORZ;
      } else if (has_rows) {
        int split = read_split_bool(cdf_row, n_parts, false);
        part = split ? PARTITION_SPLIT : PARTITION_VERT;
      } else {
        part = PARTITION_SPLIT;
      }
    }

    int sub = g_tables.partition_subsize[part][bsize];
    cur_partition = part;
    int half_w = mi_w / 2, half_h = mi_h / 2;
    int quarter_w = mi_w / 4, quarter_h = mi_h / 4;
    int bsize2 = g_tables.partition_subsize[PARTITION_SPLIT][bsize];

    switch (part) {
      case PARTITION_NONE:
        decode_block(mr, mc, bsize);
        break;
      case PARTITION_HORZ:
        decode_block(mr, mc, sub);
        if (has_rows) decode_block(mr + half_h, mc, sub);
        break;
      case PARTITION_VERT:
        decode_block(mr, mc, sub);
        if (has_cols) decode_block(mr, mc + half_w, sub);
        break;
      case PARTITION_SPLIT:
        decode_partition(mr, mc, sub);
        decode_partition(mr, mc + half_w, sub);
        decode_partition(mr + half_h, mc, sub);
        decode_partition(mr + half_h, mc + half_w, sub);
        break;
      case PARTITION_HORZ_A:
        decode_block(mr, mc, bsize2);
        decode_block(mr, mc + half_w, bsize2);
        decode_block(mr + half_h, mc, sub);
        break;
      case PARTITION_HORZ_B:
        decode_block(mr, mc, sub);
        decode_block(mr + half_h, mc, bsize2);
        decode_block(mr + half_h, mc + half_w, bsize2);
        break;
      case PARTITION_VERT_A:
        decode_block(mr, mc, bsize2);
        decode_block(mr + half_h, mc, bsize2);
        decode_block(mr, mc + half_w, sub);
        break;
      case PARTITION_VERT_B:
        decode_block(mr, mc, sub);
        decode_block(mr, mc + half_w, bsize2);
        decode_block(mr + half_h, mc + half_w, bsize2);
        break;
      case PARTITION_HORZ_4:
        for (int i = 0; i < 4; i++) {
          int row = mr + quarter_h * i;
          if (row >= mr1) break;
          decode_block(row, mc, sub);
        }
        break;
      case PARTITION_VERT_4:
        for (int i = 0; i < 4; i++) {
          int col = mc + quarter_w * i;
          if (col >= mc1) break;
          decode_block(mr, col, sub);
        }
        break;
    }

    if (part == PARTITION_SPLIT && bsize != BLOCK_8X8) {
      // children updated their own contexts
    } else if (part == PARTITION_HORZ_A) {
      update_partition_ctx(mr, mc, sub, bsize2);
      update_partition_ctx(mr + half_h, mc, sub, sub);
    } else if (part == PARTITION_HORZ_B) {
      update_partition_ctx(mr, mc, sub, sub);
      update_partition_ctx(mr + half_h, mc, sub, bsize2);
    } else if (part == PARTITION_VERT_A) {
      update_partition_ctx(mr, mc, sub, bsize2);
      update_partition_ctx(mr, mc + half_w, sub, sub);
    } else if (part == PARTITION_VERT_B) {
      update_partition_ctx(mr, mc, sub, sub);
      update_partition_ctx(mr, mc + half_w, sub, bsize2);
    } else {
      update_partition_ctx(mr, mc, bsize, sub);
    }
  }

  // ------------------------------------------------------------- block

  bool has_chroma_of(int mr, int mc, int bsize) {
    if (num_planes == 1) return false;
    int w = BW[bsize], h = BH[bsize];
    int mi_w = w / 4, mi_h = h / 4;
    bool need_c = !(p.ssx && mi_w == 1) || (mc & 1);
    bool need_r = !(p.ssy && mi_h == 1) || (mr & 1);
    return need_c && need_r;
  }

  bool cfl_allowed_of(int w, int h) {
    if (p.coded_lossless)
      return (w >> p.ssx) <= 4 && (h >> p.ssy) <= 4;
    return w <= 32 && h <= 32;
  }

  static bool use_angle_delta_of(int bsize) {
    // aom av1_use_angle_delta: enum-ordered gate; extended rect sizes
    // (16X4, ...) DO read angle deltas (tile.py)
    return bsize >= BLOCK_8X8;
  }

  static int max_tx_depth(int bsize) {
    int w = BW[bsize], h = BH[bsize];
    if (w == 4 && h == 4) return 0;
    if (std::max(w, h) == 8) return 1;
    return 2;
  }

  int read_tx_size(int mr, int mc, int bsize, bool have_above,
                   bool have_left) {
    int max_tx = g_tables.max_tx_size_rect[bsize];
    int w = BW[bsize], h = BH[bsize];
    if (w <= 4 && h <= 4) return TX_4X4;
    int sqr_up = g_tables.tx_size_sqr_up[max_tx];
    int sqw = TXW[sqr_up];
    int cat = sqw == 4 || sqw == 8 ? 0 : (sqw == 16 ? 1 : (sqw == 32 ? 2 : 3));
    // aom get_tx_size_context: inter (intrabc) neighbors contribute
    // their BLOCK dims, not their var-tx leaf dims (tile.py fix)
    auto above_ge = [&]() {
      i64 mi = (i64)(mr - 1) * mi_cols + mc;
      if (ibc_on[mi]) return BW[bsize_map[mi]] >= TXW[max_tx] ? 1 : 0;
      return tx_wide[mi] >= TXW[max_tx] ? 1 : 0;
    };
    auto left_ge = [&]() {
      i64 mi = (i64)mr * mi_cols + mc - 1;
      if (ibc_on[mi]) return BH[bsize_map[mi]] >= TXH[max_tx] ? 1 : 0;
      return tx_high[mi] >= TXH[max_tx] ? 1 : 0;
    };
    int ctx;
    if (have_above && have_left)
      ctx = above_ge() + left_ge();
    else if (have_above)
      ctx = above_ge();
    else if (have_left)
      ctx = left_ge();
    else
      ctx = 0;
    int n = std::min(max_tx_depth(bsize) + 1, 3);
    int depth = r.read_symbol_n(cdf.tx_size[cat][ctx], n);
    int tx = max_tx;
    for (int i = 0; i < depth; i++) tx = g_tables.split_tx_size[tx];
    return tx;
  }

  int uv_tx_size_of(int bsize) {
    // aom av1_get_max_uv_txsize: largest rect tx of the chroma plane
    // block + av1_get_adjusted_tx_size (only 64-px dims clamp; 4:1
    // shapes like TX_4X16 are legal and kept — tile.py _uv_tx_size)
    int w = BW[bsize], h = BH[bsize];
    int cw = std::max(w >> p.ssx, 4), ch = std::max(h >> p.ssy, 4);
    cw = std::min(cw, 64); ch = std::min(ch, 64);
    if (cw == 64) { cw = 32; ch = std::min(ch, 32); }
    else if (ch == 64) { ch = 32; cw = std::min(cw, 32); }
    return g_tables.tx_index(cw, ch);
  }

  // ------------------------------------------------------- intrabc

  static constexpr int IBC_DELAY_PX = 256;       // INTRABC_DELAY_PIXELS
  static constexpr int REF_CAT_LEVEL = 640;

  bool has_top_right_of(int mr, int mc, int bw4, int bh4) {
    // tile.py _has_top_right (aom has_top_right)
    int bs = std::max(bw4, bh4);
    if (bs > 16) return false;
    int mask_row = mr & (sb_mi - 1);
    int mask_col = mc & (sb_mi - 1);
    bool has_tr = !((mask_row & bs) && (mask_col & bs));
    int b = bs;
    while (b < sb_mi) {
      if (mask_col & b) {
        if ((mask_col & (2 * b)) && (mask_row & (2 * b))) {
          has_tr = false;
          break;
        }
      } else {
        break;
      }
      b <<= 1;
    }
    if (bw4 < bh4) {
      bool is_sec_rect = ((mc + bw4) & (bh4 - 1)) == 0;
      if (!is_sec_rect) has_tr = true;
    }
    if (bw4 > bh4) {
      bool is_sec_rect = (mr & (bw4 - 1)) != 0;
      if (is_sec_rect) has_tr = false;
    }
    if (cur_partition == PARTITION_VERT_A) {
      if (bw4 == bh4 && (mask_row & bs)) has_tr = false;
    }
    return has_tr;
  }

  struct DvState {
    i32 stack[8][2];
    i32 weight[8];
    int n = 0;
    int row_match = 0, col_match = 0;
    int processed_rows = 0, processed_cols = 0;
  };

  void dv_add(DvState& st, i32 mvr, i32 mvc, i32 wt) {
    for (int i = 0; i < st.n; i++)
      if (st.stack[i][0] == mvr && st.stack[i][1] == mvc) {
        st.weight[i] += wt;
        return;
      }
    if (st.n < 8) {
      st.stack[st.n][0] = mvr;
      st.stack[st.n][1] = mvc;
      st.weight[st.n] = wt;
      st.n++;
    }
  }

  // candidate at mi (rr, cc): fills (mv?, cand_w4, cand_h4); returns
  // false out-of-tile
  bool dv_cand(int rr, int cc, bool* has_mv, i32* mv, int* cw4,
               int* ch4) {
    if (rr < mr0 || cc < mc0 || rr >= mr1 || cc >= mc1) return false;
    int bs = bsize_map[(i64)rr * mi_cols + cc];
    *cw4 = std::max(BW[bs] / 4, 1);
    *ch4 = std::max(BH[bs] / 4, 1);
    if (ibc_on[(i64)rr * mi_cols + cc]) {
      *has_mv = true;
      mv[0] = ibc_mv[((i64)rr * mi_cols + cc) * 2];
      mv[1] = ibc_mv[((i64)rr * mi_cols + cc) * 2 + 1];
    } else {
      *has_mv = false;
    }
    return true;
  }

  void dv_scan_row(DvState& st, int mr, int mc, int bw4,
                   int row_offset, int max_row_offset) {
    int end_mi = std::min(std::min(bw4, mi_cols - mc), 16);
    int col_off = 0;
    if (std::abs(row_offset) > 1) {
      col_off = 1;
      if ((mc & 1) && bw4 < 2) col_off -= 1;
    }
    bool use_step_16 = bw4 >= 16;
    int i = 0;
    while (i < end_mi) {
      bool has_mv;
      i32 mv[2];
      int cw4, ch4;
      if (!dv_cand(mr + row_offset, mc + col_off + i, &has_mv, mv, &cw4,
                   &ch4))
        break;
      int ln = std::min(bw4, cw4);
      if (use_step_16) ln = std::max(4, ln);
      else if (std::abs(row_offset) > 1) ln = std::max(ln, 2);
      int wt = 2;
      if (bw4 >= 2 && bw4 <= cw4) {
        int inc = std::min(-max_row_offset + row_offset + 1, ch4);
        wt = std::max(wt, inc);
        st.processed_rows = inc - row_offset - 1;
      }
      if (has_mv) {
        dv_add(st, mv[0], mv[1], ln * wt);
        st.row_match = 1;
      }
      i += ln;
    }
  }

  void dv_scan_col(DvState& st, int mr, int mc, int bh4,
                   int col_offset, int max_col_offset) {
    int end_mi = std::min(std::min(bh4, mi_rows - mr), 16);
    int row_off = 0;
    if (std::abs(col_offset) > 1) {
      row_off = 1;
      if ((mr & 1) && bh4 < 2) row_off -= 1;
    }
    bool use_step_16 = bh4 >= 16;
    int i = 0;
    while (i < end_mi) {
      bool has_mv;
      i32 mv[2];
      int cw4, ch4;
      if (!dv_cand(mr + row_off + i, mc + col_offset, &has_mv, mv, &cw4,
                   &ch4))
        break;
      int ln = std::min(bh4, ch4);
      if (use_step_16) ln = std::max(4, ln);
      else if (std::abs(col_offset) > 1) ln = std::max(ln, 2);
      int wt = 2;
      if (bh4 >= 2 && bh4 <= ch4) {
        int inc = std::min(-max_col_offset + col_offset + 1, cw4);
        wt = std::max(wt, inc);
        st.processed_cols = inc - col_offset - 1;
      }
      if (has_mv) {
        dv_add(st, mv[0], mv[1], ln * wt);
        st.col_match = 1;
      }
      i += ln;
    }
  }

  void dv_scan_point(DvState& st, int mr, int mc, int bw4,
                     int row_offset, int col_offset) {
    bool has_mv;
    i32 mv[2];
    int cw4, ch4;
    if (dv_cand(mr + row_offset, mc + col_offset, &has_mv, mv, &cw4,
                &ch4) && has_mv) {
      dv_add(st, mv[0], mv[1], 4);
      if (row_offset == -1 && col_offset == bw4) st.row_match = 1;
    }
  }

  void ref_dv_of(int mr, int mc, int bsize, i32* out) {
    // tile.py _ref_dv: setup_ref_mv_list port for the intrabc case
    int w = BW[bsize], h = BH[bsize];
    int bw4 = std::max(w / 4, 1), bh4 = std::max(h / 4, 1);
    DvState st;
    bool up_avail = mr > mr0;
    bool left_avail = mc > mc0;
    int row_adj = (bh4 < 2 && (mr & 1)) ? 1 : 0;
    int col_adj = (bw4 < 2 && (mc & 1)) ? 1 : 0;
    int max_row_offset = 0;
    if (up_avail) {
      max_row_offset = -(3 << 1) + row_adj;
      if (bh4 < 2) max_row_offset = -(2 << 1) + row_adj;
      max_row_offset = std::max(max_row_offset, mr0 - mr);
    }
    int max_col_offset = 0;
    if (left_avail) {
      max_col_offset = -(3 << 1) + col_adj;
      if (bw4 < 2) max_col_offset = -(2 << 1) + col_adj;
      max_col_offset = std::max(max_col_offset, mc0 - mc);
    }
    if (up_avail) dv_scan_row(st, mr, mc, bw4, -1, max_row_offset);
    if (left_avail) dv_scan_col(st, mr, mc, bh4, -1, max_col_offset);
    if (up_avail && has_top_right_of(mr, mc, bw4, bh4))
      dv_scan_point(st, mr, mc, bw4, -1, bw4);

    int nearest = st.n;
    for (int i = 0; i < nearest; i++) st.weight[i] += REF_CAT_LEVEL;
    if (up_avail && left_avail) dv_scan_point(st, mr, mc, bw4, -1, -1);
    for (int idx = 2; idx <= 3; idx++) {
      int row_offset = -(idx << 1) + 1 + row_adj;
      int col_offset = -(idx << 1) + 1 + col_adj;
      if (up_avail && std::abs(row_offset) <= std::abs(max_row_offset) &&
          std::abs(row_offset) > st.processed_rows)
        dv_scan_row(st, mr, mc, bw4, row_offset, max_row_offset);
      if (left_avail &&
          std::abs(col_offset) <= std::abs(max_col_offset) &&
          std::abs(col_offset) > st.processed_cols)
        dv_scan_col(st, mr, mc, bh4, col_offset, max_col_offset);
    }

    auto bubble = [&](int lo, int hi) {
      int ln = hi;
      while (ln > lo) {
        int nr = lo;
        for (int i = lo + 1; i < ln; i++)
          if (st.weight[i - 1] < st.weight[i]) {
            std::swap(st.stack[i - 1][0], st.stack[i][0]);
            std::swap(st.stack[i - 1][1], st.stack[i][1]);
            std::swap(st.weight[i - 1], st.weight[i]);
            nr = i;
          }
        ln = nr;
      }
    };
    bubble(0, nearest);
    bubble(nearest, st.n);

    // clamp (aom clamp_mv_ref, MV_BORDER = 128 eighth-pel) + integer
    int bw_px = bw4 * 4, bh_px = bh4 * 4;
    i64 lo_c = -(i64)(mc * 4) * 8 - bw_px * 8 - 128;
    i64 hi_c = ((i64)mi_cols * 4 - mc * 4 - bw_px) * 8 + bw_px * 8 + 128;
    i64 lo_r = -(i64)(mr * 4) * 8 - bh_px * 8 - 128;
    i64 hi_r = ((i64)mi_rows * 4 - mr * 4 - bh_px) * 8 + bh_px * 8 + 128;
    auto to_int = [](i64 v) {
      i64 m = v >= 0 ? v % 8 : -((-v) % 8);
      v -= m;
      if (m > 4) v += 8;
      else if (m < -4) v -= 8;
      return v;
    };
    i64 lst[2][2] = {{0, 0}, {0, 0}};
    int nl = std::min(2, st.n);
    for (int i = 0; i < nl; i++) {
      lst[i][0] = to_int(clampi(st.stack[i][0], lo_r, hi_r));
      lst[i][1] = to_int(clampi(st.stack[i][1], lo_c, hi_c));
    }
    i64 dvr = lst[0][0], dvc = lst[0][1];
    if (dvr == 0 && dvc == 0) { dvr = lst[1][0]; dvc = lst[1][1]; }
    if (dvr == 0 && dvc == 0) {
      if (mr - sb_mi < mr0) {
        dvr = 0;
        dvc = -(i64)(4 * sb_mi + IBC_DELAY_PX) * 8;
      } else {
        dvr = -(i64)(4 * sb_mi) * 8;
        dvc = 0;
      }
    }
    out[0] = (i32)((dvr >> 3) * 8);
    out[1] = (i32)((dvc >> 3) * 8);
  }

  int read_dv_component(int comp) {
    int sign = r.read_symbol_n(cdf.dv_sign[comp], 2);
    int cls = r.read_symbol_n(cdf.dv_classes[comp], 11);
    int d, mag0;
    if (cls == 0) {
      d = r.read_symbol_n(cdf.dv_class0[comp], 2);
      mag0 = 0;
    } else {
      d = 0;
      for (int i = 0; i < cls; i++)
        d |= r.read_symbol_n(cdf.dv_bits[comp][i], 2) << i;
      mag0 = 2 << (cls + 2);
    }
    int mag = mag0 + ((d << 3) | (3 << 1) | 1) + 1;
    return sign ? -mag : mag;
  }

  void read_dv(const i32* ref, i32* out) {
    int j = r.read_symbol_n(cdf.dv_joints, 4);
    int drow = (j == 2 || j == 3) ? read_dv_component(0) : 0;
    int dcol = (j == 1 || j == 3) ? read_dv_component(1) : 0;
    out[0] = ref[0] + drow;
    out[1] = ref[1] + dcol;
  }

  int txfm_partition_ctx_of(int px, int py, int bsize, int tx) {
    int txw = TXW[tx], txh = TXH[tx];
    int bx = px >> 2, by = py >> 2;
    int above_v = 64, left_v = 64;
    if (by - 1 >= mr0) {
      int v = tx_wide[(i64)(by - 1) * mi_cols + bx];
      above_v = v ? v : 64;
    }
    if (bx - 1 >= mc0) {
      int v = tx_high[(i64)by * mi_cols + bx - 1];
      left_v = v ? v : 64;
    }
    int above = above_v < txw ? 1 : 0;
    int left = left_v < txh ? 1 : 0;
    int max_dim = std::max(BW[bsize], BH[bsize]);
    int md = std::min(max_dim, 64);
    int max_tx_sq = md == 4 ? 0 : (md == 8 ? 1 : (md == 16 ? 2
                    : (md == 32 ? 3 : 4)));
    int sq_up_dim = TXW[g_tables.tx_size_sqr_up[tx]];
    int category = ((sq_up_dim != md && max_tx_sq > 1) ? 1 : 0) +
                   (4 - max_tx_sq) * 2;
    return category * 3 + above + left;
  }

  void mark_tx_dims(int px, int py, int tw, int th, int vw, int vh) {
    int bx = px >> 2, by = py >> 2;
    int nw = std::max(tw / 4, 1), nh = std::max(th / 4, 1);
    for (int i = 0; i < nh && by + i < mi_rows; i++)
      for (int j = 0; j < nw && bx + j < mi_cols; j++) {
        tx_wide[(i64)(by + i) * mi_cols + bx + j] = vw;
        tx_high[(i64)(by + i) * mi_cols + bx + j] = vh;
      }
  }

  void vartx_node(int bsize, int tx, int depth, int px, int py,
                  std::vector<std::array<int, 3>>& tus) {
    int tw = TXW[tx], th = TXH[tx];
    int split = 0;
    if (depth != 2 && tx != TX_4X4) {
      int ctx = txfm_partition_ctx_of(px, py, bsize, tx);
      split = r.read_symbol_n(cdf.txfm_partition[ctx], 2);
    }
    if (split) {
      int sub = g_tables.split_tx_size[tx];
      if (sub == TX_4X4) {
        for (int yy = py; yy < py + th; yy += 4)
          for (int xx = px; xx < px + tw; xx += 4)
            tus.push_back({xx, yy, TX_4X4});
        mark_tx_dims(px, py, tw, th, 4, 4);
        return;
      }
      int sw = TXW[sub], sh = TXH[sub];
      for (int yy = py; yy < py + th; yy += sh)
        for (int xx = px; xx < px + tw; xx += sw)
          vartx_node(bsize, sub, depth + 1, xx, yy, tus);
    } else {
      tus.push_back({px, py, tx});
      mark_tx_dims(px, py, tw, th, tw, th);
    }
  }

  int read_tx_type_inter(int plane, int tx, int px, int py) {
    // tile.py _read_tx_type_inter
    int sup = TXW[g_tables.tx_size_sqr_up[tx]];
    int sq = TXW[g_tables.tx_size_sqr[tx]];
    if (plane != 0) {
      int ly = (py << p.ssy) >> 2;
      int lx = (px << p.ssx) >> 2;
      ly = std::min(ly, mi_rows - 1);
      lx = std::min(lx, mi_cols - 1);
      int tt = txtype_map[(i64)ly * mi_cols + lx];
      if (sup >= 64) return DCT_DCT;
      const int* allowed;
      int an;
      if (sup == 32 || p.reduced_tx_set) {
        allowed = EXT_TX_SET_INTER_3; an = 2;
      } else if (sq == 16) {
        allowed = EXT_TX_SET_INTER_2; an = 12;
      } else {
        allowed = EXT_TX_SET_INTER_1; an = 16;
      }
      for (int i = 0; i < an; i++)
        if (allowed[i] == tt) return tt;
      return DCT_DCT;
    }
    int tt;
    if (sup >= 64) {
      tt = DCT_DCT;
    } else {
      const int* tx_set;
      int set_idx, set_n;
      if (sup == 32 || p.reduced_tx_set) {
        tx_set = EXT_TX_SET_INTER_3; set_idx = 3; set_n = 2;
      } else if (sq == 16) {
        tx_set = EXT_TX_SET_INTER_2; set_idx = 2; set_n = 12;
      } else {
        tx_set = EXT_TX_SET_INTER_1; set_idx = 1; set_n = 16;
      }
      int sq_idx = std::min(sq, 32) == 4 ? 0
                   : (sq == 8 ? 1 : (sq == 16 ? 2 : 3));
      int sym = r.read_symbol_n(cdf.inter_ext_tx[set_idx - 1][sq_idx],
                                set_n);
      tt = tx_set[sym];
    }
    int nw = std::max(TXW[tx] / 4, 1), nh = std::max(TXH[tx] / 4, 1);
    int by = py >> 2, bx = px >> 2;
    for (int i = 0; i < nh && by + i < mi_rows; i++)
      for (int j = 0; j < nw && bx + j < mi_cols; j++)
        txtype_map[(i64)(by + i) * mi_cols + bx + j] = tt;
    return tt;
  }

  void ibc_copy(int plane, int px, int py, int tw, int th,
                const i32* mv) {
    int sx = plane ? p.ssx : 0;
    int sy = plane ? p.ssy : 0;
    PlaneView& frame = planes[plane];
    int pw = frame.w, ph = frame.h;
    int hh = std::min(th, ph - py);
    int ww = std::min(tw, pw - px);
    int offy = mv[0] >> 3, offx = mv[1] >> 3;
    if (plane == 0) {
      int sy0 = py + offy, sx0 = px + offx;
      if (sy0 < 0 || sx0 < 0 || sy0 + hh > ph || sx0 + ww > pw) {
        fail(1, "intrabc source out of frame");
        return;
      }
      for (int i = 0; i < hh; i++)
        for (int j = 0; j < ww; j++)
          frame.set(py + i, px + j, frame.at(sy0 + i, sx0 + j));
      return;
    }
    int cy_off = offy >> sy, cx_off = offx >> sx;
    int fy = offy & sy, fx = offx & sx;
    int sy0 = py + cy_off, sx0 = px + cx_off;
    if (sy0 < 0 || sx0 < 0 || sy0 + hh + fy > ph || sx0 + ww + fx > pw) {
      fail(1, "intrabc chroma source out of frame");
      return;
    }
    if (!fy && !fx) {
      for (int i = 0; i < hh; i++)
        for (int j = 0; j < ww; j++)
          frame.set(py + i, px + j, frame.at(sy0 + i, sx0 + j));
      return;
    }
    // BILINEAR convolve (tile.py _ibc_copy; InterRound0=3, Round1=11)
    i64 maxv = (1 << bd) - 1;
    std::vector<i64> hrow((i64)(hh + fy) * ww);
    for (int i = 0; i < hh + fy; i++)
      for (int j = 0; j < ww; j++) {
        i64 a0 = frame.at(sy0 + i, sx0 + j);
        i64 a1 = fx ? frame.at(sy0 + i, sx0 + j + 1) : a0;
        hrow[(i64)i * ww + j] = fx ? ((64 * a0 + 64 * a1) >> 3)
                                   : ((128 * a0) >> 3);
      }
    for (int i = 0; i < hh; i++)
      for (int j = 0; j < ww; j++) {
        i64 v = fy ? (64 * hrow[(i64)i * ww + j] +
                      64 * hrow[(i64)(i + 1) * ww + j])
                   : (128 * hrow[(i64)i * ww + j]);
        frame.set(py + i, px + j,
                  clampi((v + (1 << 10)) >> 11, 0, maxv));
      }
  }

  void ibc_txb(int plane, int px, int py, int tx, int blk_w, int blk_h) {
    // tile.py _ibc_txb: coefficients + residual add onto the copy
    int sx = plane ? p.ssx : 0;
    int sy = plane ? p.ssy : 0;
    int pw = (mi_cols * 4) >> sx;
    int ph = (mi_rows * 4) >> sy;
    if (px >= pw || py >= ph) return;
    int tw = TXW[tx], th = TXH[tx];
    PlaneView& frame = planes[plane];
    // deblock edge maps (transform_block's marker)
    {
      int gy = py / 4, gx = px / 4;
      int nh2 = std::max(th / 4, 1), nw2 = std::max(tw / 4, 1);
      int gw = egw[plane];
      for (int i = 0; i < nh2 && gy + i < egh[plane]; i++)
        edge_vert[plane][(i64)(gy + i) * gw + gx] = 1;
      for (int j = 0; j < nw2 && gx + j < gw; j++)
        edge_horz[plane][(i64)gy * gw + gx + j] = 1;
      for (int i = 0; i < nh2 && gy + i < egh[plane]; i++)
        for (int j = 0; j < nw2 && gx + j < gw; j++) {
          edge_tw[plane][(i64)(gy + i) * gw + gx + j] = tw;
          edge_th[plane][(i64)(gy + i) * gw + gx + j] = th;
        }
    }
    i32 coeffs[32 * 32];
    int eob = 0, cul = 0, dcsign = 0, tx_type = DCT_DCT;
    eob = read_coeffs(plane, px, py, tx, DC_PRED, blk_w, blk_h, coeffs,
                      &cul, &dcsign, &tx_type);
    int hh = std::min(th, ph - py);
    int ww = std::min(tw, pw - px);
    if (eob > 0) {
      i32 res[64 * 64];
      inv_transform(plane, tx, coeffs, cur_qindex, tx_type, res);
      i64 maxv = (1 << bd) - 1;
      for (int i = 0; i < hh; i++)
        for (int j = 0; j < ww; j++)
          frame.set(py + i, px + j,
                    clampi(frame.at(py + i, px + j) + res[i * tw + j],
                           0, maxv));
    }
    // context updates (transform_block's cells)
    int u_c = px / 4;
    int sb_py = (sb_mi_row * 4) >> sy;
    int lrow = (py - sb_py) / 4;
    int n_w = std::max(tw / 4, 1), n_h = std::max(th / 4, 1);
    int w_cells = std::min(n_w, std::max((pw - px) / 4, 0));
    int h_cells = std::min(n_h, std::max((ph - py) / 4, 0));
    for (int i = 0;
         i < w_cells && u_c + i < (int)above_lvl[plane].size(); i++) {
      above_lvl[plane][u_c + i] = std::min(cul, 63);
      above_sign[plane][u_c + i] = dcsign;
    }
    for (int i = 0;
         i < h_cells && lrow + i < (int)left_lvl[plane].size(); i++) {
      left_lvl[plane][lrow + i] = std::min(cul, 63);
      left_sign[plane][lrow + i] = dcsign;
    }
  }

  void block_intrabc(int mr, int mc, int bsize, int skip) {
    int w = BW[bsize], h = BH[bsize];
    int mi_w = std::max(w / 4, 1), mi_h = std::max(h / 4, 1);
    i32 dv_ref[2], mv[2];
    ref_dv_of(mr, mc, bsize, dv_ref);
    read_dv(dv_ref, mv);

    use_intrabc_cur = true;
    fi_mode = -1;
    pal_n[0] = pal_n[1] = pal_n[2] = 0;
    bool has_chroma = has_chroma_of(mr, mc, bsize);

    for (int i = 0; i < mi_h && mr + i < mi_rows; i++)
      for (int j = 0; j < mi_w && mc + j < mi_cols; j++) {
        i64 mi = (i64)(mr + i) * mi_cols + mc + j;
        skip_map[mi] = skip;
        pal_y_flag[mi] = 0;
        ibc_on[mi] = 1;
        ibc_mv[mi * 2] = mv[0];
        ibc_mv[mi * 2 + 1] = mv[1];
        bsize_map[mi] = bsize;
        txtype_map[mi] = DCT_DCT;
      }
    for (int i = 0; i < mi_w && mc + i < (int)above_skip.size(); i++)
      above_skip[mc + i] = skip;
    for (int i = 0; i < mi_h && mr - sb_mi_row + i < (int)left_skip.size();
         i++)
      left_skip[mr - sb_mi_row + i] = skip;

    // tx sizes + luma TU list
    std::vector<std::array<int, 3>> luma_tus;
    int x0 = mc * 4, y0 = mr * 4;
    if (p.coded_lossless) {
      for (int yy = y0; yy < y0 + h; yy += 4)
        for (int xx = x0; xx < x0 + w; xx += 4)
          luma_tus.push_back({xx, yy, TX_4X4});
      mark_tx_dims(x0, y0, w, h, 4, 4);
    } else if (skip || !p.tx_mode_select) {
      int tx = g_tables.max_tx_size_rect[bsize];
      int tw = TXW[tx], th = TXH[tx];
      for (int yy = y0; yy < y0 + h; yy += th)
        for (int xx = x0; xx < x0 + w; xx += tw)
          luma_tus.push_back({xx, yy, tx});
      if (skip) mark_tx_dims(x0, y0, w, h, w, h);
      else mark_tx_dims(x0, y0, w, h, tw, th);
    } else {
      int max_tx = g_tables.max_tx_size_rect[bsize];
      int tw = TXW[max_tx], th = TXH[max_tx];
      for (int yy = y0; yy < y0 + h; yy += th)
        for (int xx = x0; xx < x0 + w; xx += tw)
          vartx_node(bsize, max_tx, 0, xx, yy, luma_tus);
    }

    // ---- eager copy, then residual adds (deferred-job order) ----
    int pw = mi_cols * 4, ph = mi_rows * 4;
    ibc_copy(0, x0, y0, std::min(w, pw - x0), std::min(h, ph - y0), mv);
    int cr_ = mr, cc_ = mc, cw = 0, ch_ = 0, cx0 = 0, cy0 = 0;
    if (has_chroma && num_planes > 1) {
      cr_ = (mi_h == 1 && p.ssy) ? (mr & ~1) : mr;
      cc_ = (mi_w == 1 && p.ssx) ? (mc & ~1) : mc;
      cw = std::max(w, p.ssx ? 8 : 4) >> p.ssx;
      ch_ = std::max(h, p.ssy ? 8 : 4) >> p.ssy;
      cx0 = (cc_ * 4) >> p.ssx;
      cy0 = (cr_ * 4) >> p.ssy;
      for (int pl = 1; pl < num_planes; pl++)
        ibc_copy(pl, cx0, cy0, cw, ch_, mv);
    }
    if (rc) return;

    if (!skip) {
      for (auto& tu : luma_tus)
        ibc_txb(0, tu[0], tu[1], tu[2], w, h);
      if (has_chroma && num_planes > 1) {
        int uv_tx = p.coded_lossless ? TX_4X4 : uv_tx_size_of(bsize);
        int utw = TXW[uv_tx], uth = TXH[uv_tx];
        for (int pl = 1; pl < num_planes; pl++)
          for (int ty = 0; ty < ch_; ty += uth)
            for (int tx_x = 0; tx_x < cw; tx_x += utw)
              ibc_txb(pl, cx0 + tx_x, cy0 + ty, uv_tx, cw, ch_);
      }
    } else {
      // aom av1_reset_entropy_context (tile.py skip branch)
      int u_c = x0 / 4;
      int lrow = mr - sb_mi_row;
      for (int i = 0; i < mi_w && u_c + i < (int)above_lvl[0].size();
           i++) {
        above_lvl[0][u_c + i] = 0;
        above_sign[0][u_c + i] = 0;
      }
      for (int i = 0; i < mi_h && lrow + i < (int)left_lvl[0].size();
           i++) {
        left_lvl[0][lrow + i] = 0;
        left_sign[0][lrow + i] = 0;
      }
      if (has_chroma && num_planes > 1) {
        int cu_c = ((cc_ * 4) >> p.ssx) / 4;
        int clrow = (((cr_ - sb_mi_row) * 4) >> p.ssy) / 4;
        int cw_c = std::max((std::max(w, p.ssx ? 8 : 4) >> p.ssx) / 4, 1);
        int ch_c = std::max((std::max(h, p.ssy ? 8 : 4) >> p.ssy) / 4, 1);
        for (int pl = 1; pl < 3; pl++) {
          for (int i = 0;
               i < cw_c && cu_c + i < (int)above_lvl[pl].size(); i++) {
            above_lvl[pl][cu_c + i] = 0;
            above_sign[pl][cu_c + i] = 0;
          }
          for (int i = 0;
               i < ch_c && clrow + i < (int)left_lvl[pl].size(); i++) {
            left_lvl[pl][clrow + i] = 0;
            left_sign[pl][clrow + i] = 0;
          }
        }
      }
    }

    use_intrabc_cur = false;
    // block_decoded marks (tile.py _block_intrabc tail)
    u8* dec0 = block_decoded[0].data();
    int dstride = mi_cols + 2;
    for (int i = 0; i < mi_h && mr + 1 + i < mi_rows + 2; i++)
      for (int j = 0; j < mi_w && mc + 1 + j < dstride; j++)
        dec0[(i64)(mr + 1 + i) * dstride + mc + 1 + j] = 1;
    if (has_chroma && num_planes > 1) {
      int ch4 = std::max(mi_h >> p.ssy, 1);
      int cw4 = std::max(mi_w >> p.ssx, 1);
      for (int pl = 1; pl < 3; pl++) {
        u8* dec = block_decoded[pl].data();
        for (int i = 0; i < ch4; i++)
          for (int j = 0; j < cw4; j++) {
            int rr = (cr_ >> p.ssy) + 1 + i;
            int cc2 = (cc_ >> p.ssx) + 1 + j;
            if (rr < mi_rows + 2 && cc2 < dstride)
              dec[(i64)rr * dstride + cc2] = 1;
          }
      }
    }
  }

  void decode_block(int mr, int mc, int bsize) {
    if (mr >= mr1 || mc >= mc1 || rc) return;
    int w = BW[bsize], h = BH[bsize];
    int mi_w = std::max(w / 4, 1), mi_h = std::max(h / 4, 1);
    bool have_above = mr > mr0;
    bool have_left = mc > mc0;

    // skip
    int a_skip = have_above ? above_skip[mc] : 0;
    int l_skip = have_left ? left_skip[mr - sb_mi_row] : 0;
    int skip = r.read_symbol_n(cdf.skip[a_skip + l_skip], 2);

    // cdef index (spec read_cdef 5.11.56)
    if (!skip && !p.coded_lossless && p.enable_cdef && !p.allow_intrabc) {
      int r1b = mr & ~15, c1b = mc & ~15;
      if (cdef_idx[(i64)r1b * mi_cols + c1b] == -1) {
        int idx = r.read_literal(p.cdef_bits);
        for (int i = r1b; i < r1b + std::max(mi_h, 1); i += 16)
          for (int j = c1b; j < c1b + std::max(mi_w, 1); j += 16)
            if (i < mi_rows && j < mi_cols)
              cdef_idx[(i64)i * mi_cols + j] = idx;
      }
    }

    // intra block copy (spec 5.11.17 intra_frame_mode_info)
    if (p.allow_intrabc && r.read_symbol_n(cdf.intrabc, 2)) {
      block_intrabc(mr, mc, bsize, skip);
      return;
    }

    // y mode
    int above_mode = have_above ? y_modes[(i64)(mr - 1) * mi_cols + mc]
                                : DC_PRED;
    int left_mode = have_left ? y_modes[(i64)mr * mi_cols + mc - 1]
                              : DC_PRED;
    int ctx_a = INTRA_MODE_CONTEXT[above_mode];
    int ctx_l = INTRA_MODE_CONTEXT[left_mode];
    int y_mode = r.read_symbol_n(cdf.kf_y_mode[ctx_a][ctx_l], 13);
    int angle_y = 0;
    if (mode_to_angle(y_mode) >= 0 && use_angle_delta_of(bsize)) {
      int sym = r.read_symbol_n(cdf.angle_delta[y_mode - V_PRED], 7);
      angle_y = sym - 3;
    }

    // chroma
    bool has_chroma = has_chroma_of(mr, mc, bsize);
    int uv_mode = DC_PRED;
    int angle_uv = 0;
    cfl_alpha_u = cfl_alpha_v = 0;
    if (has_chroma) {
      bool cfl_allowed = cfl_allowed_of(w, h);
      uv_mode = r.read_symbol_n(cdf.uv_mode[cfl_allowed ? 1 : 0][y_mode],
                                cfl_allowed ? 14 : 13);
      if (uv_mode == UV_CFL_PRED) {
        int js = r.read_symbol_n(cdf.cfl_sign, 8);
        int sign_u = (js + 1) / 3, sign_v = (js + 1) % 3;
        int alpha_u = 0, alpha_v = 0;
        if (sign_u != 0) {
          int idx = r.read_symbol_n(cdf.cfl_alpha[js - 2], 16);
          alpha_u = (idx + 1) * (sign_u == 2 ? 1 : -1);
        }
        if (sign_v != 0) {
          int ctx_v = sign_v * 3 + sign_u - 3;
          int idx = r.read_symbol_n(cdf.cfl_alpha[ctx_v], 16);
          alpha_v = (idx + 1) * (sign_v == 2 ? 1 : -1);
        }
        cfl_alpha_u = alpha_u;
        cfl_alpha_v = alpha_v;
      }
      if (mode_to_angle(uv_mode) >= 0 && use_angle_delta_of(bsize)) {
        int sym = r.read_symbol_n(cdf.angle_delta[uv_mode - V_PRED], 7);
        angle_uv = sym - 3;
      }
    }

    // palette (spec 5.11.46)
    pal_n[0] = pal_n[1] = pal_n[2] = 0;
    int has_pal_y = 0;
    if (p.allow_screen_content && bsize >= BLOCK_8X8 && w <= 64 &&
        h <= 64) {
      if (y_mode == DC_PRED) {
        int bctx = bitlen(w * h) - 1 - 6;
        int pal_ctx =
            (have_above ? pal_y_flag[(i64)(mr - 1) * mi_cols + mc] : 0) +
            (have_left ? pal_y_flag[(i64)mr * mi_cols + mc - 1] : 0);
        has_pal_y = r.read_symbol_n(cdf.palette_y_mode[bctx][pal_ctx], 2);
        if (has_pal_y) {
          int n_y = r.read_symbol_n(cdf.palette_y_size[bctx], 7) + 2;
          int cache[2 * PALETTE_MAX_SIZE];
          int nc = palette_cache(pal_y_n.data(), pal_y_c.data(), mi_cols,
                                 mr, mc, mr0, mc0, cache);
          read_colors_y(r, cache, nc, n_y, bd, pal_colors[0]);
          pal_n[0] = n_y;
        }
      }
      if (has_chroma && uv_mode == DC_PRED) {
        int bctx = bitlen(w * h) - 1 - 6;
        int has_pal_uv =
            r.read_symbol_n(cdf.palette_uv_mode[has_pal_y ? 1 : 0], 2);
        if (has_pal_uv) {
          int n_uv = r.read_symbol_n(cdf.palette_uv_size[bctx], 7) + 2;
          int cache[2 * PALETTE_MAX_SIZE];
          int nc = palette_cache(pal_u_n.data(), pal_u_c.data(), mi_cols,
                                 mr, mc, mr0, mc0, cache);
          read_colors_uv(r, cache, nc, n_uv, bd, pal_colors[1],
                         pal_colors[2]);
          pal_n[1] = pal_n[2] = n_uv;
        }
      }
    }
    fi_mode = -1;
    if (p.enable_filter_intra && y_mode == DC_PRED && pal_n[0] == 0 &&
        w <= 32 && h <= 32) {
      int use_fi = r.read_symbol_n(cdf.filter_intra_use[bsize], 2);
      if (use_fi) fi_mode = r.read_symbol_n(cdf.filter_intra_mode, 5);
    }

    // palette color-index maps (before the tx-size symbol)
    if (pal_n[0] > 0 || pal_n[1] > 0) {
      int vis_h = std::min(h, (mi_rows - mr) * 4);
      int vis_w = std::min(w, (mi_cols - mc) * 4);
      if (pal_n[0] > 0) {
        pal_map_w[0] = w;
        read_color_map(r, cdf.palette_y_color, pal_n[0], vis_h, vis_w, h,
                       w, pal_y_map.data());
        pal_y_org_x = mc * 4;
        pal_y_org_y = mr * 4;
      }
      if (pal_n[1] > 0) {
        // spec 5.11.50 palette_tokens: sub-8 chroma dims (<4 after
        // subsampling) extend by +2 rows/cols — onscreen dims too, so
        // the extra indices are parsed, not replicated (mirrors the
        // Python engine fix caught by the intrabc oracle sweep)
        int cbw = w >> p.ssx;
        int cbh = h >> p.ssy;
        int ovw = vis_w >> p.ssx;
        int ovh = vis_h >> p.ssy;
        if (cbw < 4) { cbw += 2; ovw += 2; }
        if (cbh < 4) { cbh += 2; ovh += 2; }
        pal_map_w[1] = cbw;
        read_color_map(r, cdf.palette_uv_color, pal_n[1], ovh,
                       ovw, cbh, cbw, pal_uv_map.data());
      }
    }

    // tx size
    int tx;
    if (p.coded_lossless) tx = TX_4X4;
    else if (!p.tx_mode_select || skip)
      tx = g_tables.max_tx_size_rect[bsize];
    else
      tx = read_tx_size(mr, mc, bsize, have_above, have_left);

    // record maps
    for (int i = mr; i < std::min(mr + mi_h, mi_rows); i++)
      for (int j = mc; j < std::min(mc + mi_w, mi_cols); j++) {
        i64 idx = (i64)i * mi_cols + j;
        y_modes[idx] = y_mode;
        uv_modes[idx] = uv_mode;
        skip_map[idx] = skip;
        bsize_map[idx] = bsize;
        pal_y_flag[idx] = pal_n[0] > 0 ? 1 : 0;
        tx_wide[idx] = TXW[tx];
        tx_high[idx] = TXH[tx];
        pal_y_n[idx] = (u8)pal_n[0];
        pal_u_n[idx] = (u8)pal_n[1];
        if (pal_n[0])
          for (int k = 0; k < pal_n[0]; k++)
            pal_y_c[idx * PALETTE_MAX_SIZE + k] = pal_colors[0][k];
        if (pal_n[1])
          for (int k = 0; k < pal_n[1]; k++)
            pal_u_c[idx * PALETTE_MAX_SIZE + k] = pal_colors[1][k];
      }
    for (int j = mc; j < std::min(mc + mi_w, (int)above_skip.size()); j++)
      above_skip[j] = skip;
    for (int i = mr - sb_mi_row;
         i < std::min(mr - sb_mi_row + mi_h, (int)left_skip.size()); i++)
      left_skip[i] = skip;

    // intra-edge filter type
    auto smooth = [](int m) {
      return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
    };
    int ab_y = have_above ? y_modes[(i64)(mr - 1) * mi_cols + mc] : -1;
    int le_y = have_left ? y_modes[(i64)mr * mi_cols + mc - 1] : -1;
    filt_type_y = (smooth(ab_y) || smooth(le_y)) ? 1 : 0;
    int cr_ = (h / 4) == 1 ? (mr & ~1) : mr;
    int cc_ = (w / 4) == 1 ? (mc & ~1) : mc;
    // chroma neighbor mbmi: bottom-right-most mi of the above/left
    // chroma reference block (tile.py; aom set_mi_row_col)
    int ac_ = std::min(cc_ + p.ssx, mi_cols - 1);
    int lr2_ = std::min(cr_ + p.ssy, mi_rows - 1);
    int ab_uv = cr_ > mr0 ? uv_modes[(i64)(cr_ - 1) * mi_cols + ac_] : -1;
    int le_uv = cc_ > mc0 ? uv_modes[(i64)lr2_ * mi_cols + cc_ - 1] : -1;
    filt_type_uv = (smooth(ab_uv) || smooth(le_uv)) ? 1 : 0;

    residual(mr, mc, bsize, y_mode, uv_mode, angle_y, angle_uv, tx, skip,
             has_chroma);
  }

  void residual(int mr, int mc, int bsize, int y_mode, int uv_mode,
                int angle_y, int angle_uv, int tx, int skip,
                bool has_chroma) {
    int w = BW[bsize], h = BH[bsize];
    int tw = TXW[tx], th = TXH[tx];
    int x0 = mc * 4, y0 = mr * 4;
    int cr = mr, cc = mc;
    if (p.ssy && (h / 4) == 1) cr = mr & ~1;
    if (p.ssx && (w / 4) == 1) cc = mc & ~1;
    int cw = std::max(w, p.ssx ? 8 : 4) >> p.ssx;
    int ch = std::max(h, p.ssy ? 8 : 4) >> p.ssy;
    int uv_tx = p.coded_lossless ? TX_4X4 : uv_tx_size_of(bsize);
    int utw = TXW[uv_tx], uth = TXH[uv_tx];
    int cx0 = (cc * 4) >> p.ssx, cy0 = (cr * 4) >> p.ssy;
    pal_uv_org_x = cx0;
    pal_uv_org_y = cy0;
    for (int cy = 0; cy < h; cy += 64)
      for (int cx = 0; cx < w; cx += 64) {
        for (int ty = cy; ty < std::min(cy + 64, h); ty += th)
          for (int tx_x = cx; tx_x < std::min(cx + 64, w); tx_x += tw)
            transform_block(0, x0 + tx_x, y0 + ty, tx, y_mode, angle_y,
                            skip, mr, mc, bsize);
        if (has_chroma) {
          int ccy0 = cy >> p.ssy, ccx0 = cx >> p.ssx;
          int ccy1 = std::min(ccy0 + (64 >> p.ssy), ch);
          int ccx1 = std::min(ccx0 + (64 >> p.ssx), cw);
          for (int plane = 1; plane < num_planes; plane++)
            for (int ty = ccy0; ty < ccy1; ty += uth)
              for (int tx_x = ccx0; tx_x < ccx1; tx_x += utw)
                transform_block(plane, cx0 + tx_x, cy0 + ty, uv_tx,
                                uv_mode, angle_uv, skip, mr, mc, bsize);
        }
      }
  }

  // ------------------------------------------------------ coefficients

  int txb_skip_ctx_of(int plane, int px, int py, int tx, int blk_w,
                      int blk_h) {
    int tw = TXW[tx], th = TXH[tx];
    int sy = plane ? p.ssy : 0;
    int au = px / 4;
    int lrow = (py - ((sb_mi_row * 4) >> sy)) / 4;
    int n_w = std::max(tw / 4, 1), n_h = std::max(th / 4, 1);
    int top = 0, left = 0;
    for (int i = 0; i < n_w && au + i < (int)above_lvl[plane].size(); i++)
      top |= above_lvl[plane][au + i];
    for (int i = 0; i < n_h && lrow + i < (int)left_lvl[plane].size(); i++)
      left |= left_lvl[plane][lrow + i];
    if (plane == 0) {
      if (blk_w == tw && blk_h == th) return 0;
      top &= 63;
      left &= 63;
      int mx = std::min(top | left, 4);
      int mn = std::min(std::min(top, left), 4);
      return SKIP_CONTEXTS_TAB[mn][mx];
    }
    int ctx_base = (top != 0) + (left != 0);
    int ctx_offset = (i64)blk_w * blk_h > (i64)tw * th ? 10 : 7;
    return ctx_base + ctx_offset;
  }

  int dc_sign_ctx_of(int plane, int px, int py, int tx) {
    int tw = TXW[tx], th = TXH[tx];
    int sy = plane ? p.ssy : 0;
    int au = px / 4;
    int lrow = (py - ((sb_mi_row * 4) >> sy)) / 4;
    int n_w = std::max(tw / 4, 1), n_h = std::max(th / 4, 1);
    int s = 0;
    for (int i = 0; i < n_w && au + i < (int)above_sign[plane].size();
         i++) {
      int v = above_sign[plane][au + i];
      s += v == 2 ? 1 : (v == 1 ? -1 : 0);
    }
    for (int i = 0; i < n_h && lrow + i < (int)left_sign[plane].size();
         i++) {
      int v = left_sign[plane][lrow + i];
      s += v == 2 ? 1 : (v == 1 ? -1 : 0);
    }
    if (s < 0) return 1;
    if (s > 0) return 2;
    return 0;
  }

  // aom fimode_to_intradir (tile.py _FIMODE_TO_INTRADIR)
  static constexpr int FIMODE_TO_INTRADIR[5] = {DC_PRED, V_PRED, H_PRED,
                                                D157_PRED, DC_PRED};

  int read_tx_type(int plane, int tx, int mode) {
    if (p.coded_lossless) return WHT_WHT;
    if (plane == 0 && fi_mode >= 0) mode = FIMODE_TO_INTRADIR[fi_mode];
    int sup = TXW[g_tables.tx_size_sqr_up[tx]];
    if (plane != 0) {
      if (sup >= 32) return DCT_DCT;
      int tt = INTRA_MODE_TO_TX_TYPE[mode];
      int sq = TXW[g_tables.tx_size_sqr[tx]];
      const int* tx_set = (p.reduced_tx_set || sq == 16)
                              ? EXT_TX_SET_INTRA_2 : EXT_TX_SET_INTRA_1;
      int set_n = (p.reduced_tx_set || sq == 16) ? 5 : 7;
      for (int i = 0; i < set_n; i++)
        if (tx_set[i] == tt) return tt;
      return DCT_DCT;
    }
    if (sup >= 32) return DCT_DCT;
    int sq = TXW[g_tables.tx_size_sqr[tx]];
    const int* tx_set;
    int set_idx, set_n;
    if (p.reduced_tx_set || sq == 16) {
      tx_set = EXT_TX_SET_INTRA_2; set_idx = 2; set_n = 5;
    } else {
      tx_set = EXT_TX_SET_INTRA_1; set_idx = 1; set_n = 7;
    }
    int sq_idx = std::min(sq, 32) == 4 ? 0 : (sq == 8 ? 1 : (sq == 16 ? 2 : 3));
    int sym = r.read_symbol_n(cdf.intra_ext_tx[set_idx][sq_idx][mode],
                              set_n);
    return tx_set[sym];
  }

  // coeff base context (tile.py base_ctx)
  static int base_ctx_of(const u8* levels, int lstride, int row, int col,
                         int pos, int tcls, int full_w, int full_h) {
    auto L = [&](int r0, int c0) {
      return (int)levels[(i64)r0 * lstride + c0];
    };
    if (tcls == 0) {
      if (pos == 0) return 0;
      int mag = std::min(L(row, col + 1), 3) + std::min(L(row + 1, col), 3) +
                std::min(L(row + 1, col + 1), 3) +
                std::min(L(row, col + 2), 3) + std::min(L(row + 2, col), 3);
      mag = std::min((mag + 1) >> 1, 4);
      if (full_w < full_h && row < 2) return mag + 11;
      if (full_w > full_h && col < 2) return mag + 16;
      int d = row + col;
      if (d < 2) return mag + 1;
      if (d < 4) return mag + 6;
      return mag + 21;
    }
    int mag = std::min(L(row + 1, col), 3) + std::min(L(row, col + 1), 3);
    int coord;
    if (tcls == 2) {  // 'v'
      mag += std::min(L(row + 2, col), 3) + std::min(L(row + 3, col), 3) +
             std::min(L(row + 4, col), 3);
      coord = row;
    } else {          // 'h'
      mag += std::min(L(row, col + 2), 3) + std::min(L(row, col + 3), 3) +
             std::min(L(row, col + 4), 3);
      coord = col;
    }
    mag = std::min((mag + 1) >> 1, 4);
    return mag + 26 + (coord == 0 ? 0 : (coord == 1 ? 5 : 10));
  }

  static int br_ctx_of(const u8* levels, int lstride, int row, int col,
                       int pos, int tcls) {
    auto L = [&](int r0, int c0) {
      return (int)levels[(i64)r0 * lstride + c0];
    };
    int mag = L(row, col + 1) + L(row + 1, col);
    if (tcls == 0) {
      mag += L(row + 1, col + 1);
      mag = std::min((mag + 1) >> 1, 6);
      if (pos == 0) return mag;
      return mag + (row < 2 && col < 2 ? 7 : 14);
    }
    if (tcls == 1) {
      mag += L(row, col + 2);
      mag = std::min((mag + 1) >> 1, 6);
      if (pos == 0) return mag;
      return mag + (col == 0 ? 7 : 14);
    }
    mag += L(row + 2, col);
    mag = std::min((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    return mag + (row == 0 ? 7 : 14);
  }

  static int base_eob_ctx_of(int c, int n_coeffs) {
    if (c == 0) return 0;
    if (c <= n_coeffs / 8) return 1;
    if (c <= n_coeffs / 4) return 2;
    return 3;
  }

  // returns eob; coeffs (th*tw, scan-resident) written; cul/dcsign out
  int cur_nzr, cur_nzc;       // nonzero row/col extent of last read_coeffs

  int read_coeffs(int plane, int px, int py, int tx, int mode, int blk_w,
                  int blk_h, i32* coeffs, int* cul_out, int* dcsign_out,
                  int* tx_type_out) {
    cur_nzr = 0; cur_nzc = 0;
    int tw = std::min(TXW[tx], 32), th = std::min(TXH[tx], 32);
    int ptp = plane == 0 ? 0 : 1;
    static const int sizes[5] = {4, 8, 16, 32, 64};
    auto size_idx = [&](int v) {
      for (int i = 0; i < 5; i++) if (sizes[i] == v) return i;
      return 4;
    };
    int txs_ctx = std::min(
        (size_idx(TXW[g_tables.tx_size_sqr[tx]]) +
         size_idx(TXW[g_tables.tx_size_sqr_up[tx]]) + 1) >> 1, 4);

    int skip_ctx = txb_skip_ctx_of(plane, px, py, tx, blk_w, blk_h);
    int all_zero = r.read_symbol_n(cdf.txb_skip[txs_ctx][skip_ctx], 2);
    if (all_zero) {
      *cul_out = 0;
      *dcsign_out = 0;
      return 0;
    }

    int tx_type = (use_intrabc_cur && !p.coded_lossless)
                      ? read_tx_type_inter(plane, tx, px, py)
                      : read_tx_type(plane, tx, mode);
    cur_tx_type = tx_type;
    *tx_type_out = tx_type;
    int tcls = tx_class_of(tx_type);
    const std::vector<i32>& scan = g_tables.scans[tx][tcls];
    int n_coeffs = tw * th;

    int eob_multi_ctx = tcls == 0 ? 0 : 1;
    u16* eob_cdf;
    int eob_cdf_n;
    switch (n_coeffs) {
      case 16: eob_cdf = cdf.eob_pt16[ptp][eob_multi_ctx]; eob_cdf_n = 5; break;
      case 32: eob_cdf = cdf.eob_pt32[ptp][eob_multi_ctx]; eob_cdf_n = 6; break;
      case 64: eob_cdf = cdf.eob_pt64[ptp][eob_multi_ctx]; eob_cdf_n = 7; break;
      case 128: eob_cdf = cdf.eob_pt128[ptp][eob_multi_ctx]; eob_cdf_n = 8; break;
      case 256: eob_cdf = cdf.eob_pt256[ptp][eob_multi_ctx]; eob_cdf_n = 9; break;
      case 512: eob_cdf = cdf.eob_pt512[ptp][eob_multi_ctx]; eob_cdf_n = 10; break;
      default: eob_cdf = cdf.eob_pt1024[ptp][eob_multi_ctx]; eob_cdf_n = 11; break;
    }
    int eob_pt = r.read_symbol_n(eob_cdf, eob_cdf_n) + 1;
    int eob = EOB_GROUP_START[eob_pt];
    int extra_bits = EOB_OFFSET_BITS[eob_pt];
    if (extra_bits > 0) {
      int ctx_idx = eob_pt - 3;
      int bit = r.read_symbol_n(cdf.eob_extra[txs_ctx][ptp][ctx_idx], 2);
      if (bit) eob += 1 << (extra_bits - 1);
      for (int k = 1; k < extra_bits; k++)
        if (r.read_bit()) eob += 1 << (extra_bits - 1 - k);
    }

    int lstride = tw + 4;
    u8 levels[36 * 36];
    // clear only the scan prefix's bounding box (+ctx read margin of 4
    // rows/cols for levels); parses with small eob skip ~90% of the
    // full-block memset traffic
    int bb_r = g_tables.scan_maxr[tx][tcls][eob - 1];
    int bb_c = g_tables.scan_maxc[tx][tcls][eob - 1];
    if (p.coded_lossless) { bb_r = th; bb_c = tw; }  // iwht4 reads all 16
    {
      int lr = std::min(bb_r + 4, th + 4);
      int lc = std::min(bb_c + 4, tw + 4);
      if (lc >= tw) {
        memset(levels, 0, (size_t)lr * lstride);
      } else {
        for (int rr2 = 0; rr2 < lr; rr2++)
          memset(levels + (i64)rr2 * lstride, 0, lc);
      }
      if (bb_c >= tw) {
        memset(coeffs, 0, sizeof(i32) * (size_t)bb_r * tw);
      } else {
        for (int rr2 = 0; rr2 < bb_r; rr2++)
          memset(coeffs + (i64)rr2 * tw, 0, sizeof(i32) * bb_c);
      }
    }

    for (int c = eob - 1; c >= 0; c--) {
      int pos = scan[c];
      int row = pos >> (bitlen(tw) - 1), col = pos & (tw - 1);
      int level;
      if (c == eob - 1) {
        int ctx = base_eob_ctx_of(c, n_coeffs);
        int sym = r.read_symbol_n(cdf.coeff_base_eob[txs_ctx][ptp][ctx], 3);
        level = sym + 1;
      } else {
        int ctx = base_ctx_of(levels, lstride, row, col, pos, tcls,
                              TXW[tx], TXH[tx]);
        level = r.read_symbol_n(cdf.coeff_base[txs_ctx][ptp][ctx], 4);
      }
      if (level > 2) {
        int bctx = br_ctx_of(levels, lstride, row, col, pos, tcls);
        for (int t = 0; t < 4; t++) {
          int k = r.read_symbol_n(
              cdf.coeff_br[std::min(txs_ctx, 3)][ptp][bctx], 4);
          level += k;
          if (k < 3) break;
        }
      }
      levels[(i64)row * lstride + col] = (u8)std::min(level, 63);
      coeffs[pos] = level;
      if (level) {
        if (row >= cur_nzr) cur_nzr = row + 1;
        if (col >= cur_nzc) cur_nzc = col + 1;
      }
    }

    i64 cul = 0;
    int dc_sign_val = 0;
    for (int c = 0; c < eob; c++) {
      int pos = scan[c];
      i64 level = coeffs[pos];
      if (level == 0) continue;
      int sign;
      if (c == 0) {
        int ctx = dc_sign_ctx_of(plane, px, py, tx);
        sign = r.read_symbol_n(cdf.dc_sign[ptp][ctx], 2);
      } else {
        sign = r.read_bit();
      }
      if (level > 14) level += r.read_golomb();
      cul += level;
      if (c == 0) dc_sign_val = sign ? 1 : 2;
      coeffs[pos] = (i32)(sign ? -level : level);
    }
    *cul_out = (int)std::min<i64>(cul, 63);
    *dcsign_out = dc_sign_val;
    return eob;
  }

  // -------------------------------------------- dequant + inverse txfm

  void inv_transform(int plane, int tx, const i32* coeffs, int qindex,
                     int tx_type, i32* res) {
    int dc_d, ac_d;
    if (plane == 0) { dc_d = p.dq[0]; ac_d = 0; }
    else if (plane == 1) { dc_d = p.dq[1]; ac_d = p.dq[2]; }
    else { dc_d = p.dq[3]; ac_d = p.dq[4]; }
    i64 dc_q = p.dc_qtab[clampi(qindex + dc_d, 0, 255)];
    i64 ac_q = p.ac_qtab[clampi(qindex + ac_d, 0, 255)];
    int tw = TXW[tx], th = TXH[tx];
    int cw = std::min(tw, 32), ch = std::min(th, 32);
    if (p.coded_lossless) {
      i32 d[16];
      for (int i = 0; i < 16; i++) d[i] = (i32)((i64)coeffs[i] * ac_q);
      d[0] = (i32)((i64)coeffs[0] * dc_q);
      iwht4(d, res);
      return;
    }
    i64 pels = (i64)tw * th;
    int shift = (pels > 256 ? 1 : 0) + (pels > 1024 ? 1 : 0);
    // only the rows/cols read_coeffs actually populated need dequant;
    // the rest is known zero
    int nzr = std::min(cur_nzr, ch), nzc = std::min(cur_nzc, cw);
    i32 d[32 * 32];
    memset(d, 0, sizeof(i32) * ch * cw);
    for (int r2 = 0; r2 < nzr; r2++)
      for (int c2 = 0; c2 < nzc; c2++) {
        i64 i = (i64)r2 * cw + c2;
        i64 cv = coeffs[i];
        if (!cv) continue;
        i64 q = i == 0 ? dc_q : ac_q;
        i64 mag = ((std::abs(cv) * q) & 0xFFFFFF) >> shift;
        d[i] = (i32)(cv < 0 ? -mag : mag);
      }
    inv_txfm2d(d, cw, ch, tw, th, tx_type, res);
  }

  // ------------------------------------------------- transform block

  void transform_block(int plane, int px, int py, int tx, int mode,
                       int angle, int skip, int mr, int mc, int bsize) {
    int sx = plane ? p.ssx : 0;
    int sy = plane ? p.ssy : 0;
    int pw = (mi_cols * 4) >> sx;
    int ph = (mi_rows * 4) >> sy;
    if (px >= pw || py >= ph) return;
    int tw = TXW[tx], th = TXH[tx];
    PlaneView& frame = planes[plane];
    // deblock edge maps
    {
      int gy = py / 4, gx = px / 4;
      int nh = std::max(th / 4, 1), nw = std::max(tw / 4, 1);
      int gw = egw[plane];
      for (int i = 0; i < nh && gy + i < egh[plane]; i++)
        edge_vert[plane][(i64)(gy + i) * gw + gx] = 1;
      for (int j = 0; j < nw && gx + j < gw; j++)
        edge_horz[plane][(i64)gy * gw + gx + j] = 1;
      for (int i = 0; i < nh && gy + i < egh[plane]; i++)
        for (int j = 0; j < nw && gx + j < gw; j++) {
          edge_tw[plane][(i64)(gy + i) * gw + gx + j] = tw;
          edge_th[plane][(i64)(gy + i) * gw + gx + j] = th;
        }
    }

    u8* dec = block_decoded[plane].data();
    int dstride = mi_cols + 2;
    int u_r = py / 4, u_c = px / 4;
    int n_w = std::max(tw / 4, 1), n_h = std::max(th / 4, 1);
    bool have_above = py > 0 && dec[(i64)u_r * dstride + u_c + 1];
    bool have_left = px > 0 && dec[(i64)(u_r + 1) * dstride + u_c];
    int n_tr = 0;
    if (py > 0 && px + tw < pw) {
      int steps = 0;
      int cc = u_c + n_w;
      while (steps < th && (cc * 4) < pw &&
             dec[(i64)u_r * dstride + cc + 1]) {
        steps += 4;
        cc += 1;
      }
      n_tr = steps;
    }
    int n_bl = 0;
    if (px > 0 && py + th < ph) {
      int steps = 0;
      int rr2 = u_r + n_h;
      while (steps < tw && (rr2 * 4) < ph &&
             dec[(i64)(rr2 + 1) * dstride + u_c]) {
        steps += 4;
        rr2 += 1;
      }
      n_bl = steps;
    }

    int pred_mode = (plane && mode == UV_CFL_PRED) ? DC_PRED : mode;
    // palette prediction (computed from the parsed index map)
    bool use_pal = false;
    const u8* pmap = nullptr;
    const int* pcolors = nullptr;
    int pmw = 0, rx = 0, ry = 0;
    if (plane == 0 && pal_n[0] > 0) {
      use_pal = true;
      pmap = pal_y_map.data();
      pcolors = pal_colors[0];
      pmw = pal_map_w[0];
      rx = px - pal_y_org_x;
      ry = py - pal_y_org_y;
    } else if (plane == 1 && pal_n[1] > 0) {
      use_pal = true;
      pmap = pal_uv_map.data();
      pcolors = pal_colors[1];
      pmw = pal_map_w[1];
      rx = px - pal_uv_org_x;
      ry = py - pal_uv_org_y;
    } else if (plane == 2 && pal_n[2] > 0) {
      use_pal = true;
      pmap = pal_uv_map.data();
      pcolors = pal_colors[2];
      pmw = pal_map_w[1];
      rx = px - pal_uv_org_x;
      ry = py - pal_uv_org_y;
    }

    int w_b = BW[bsize], h_b = BH[bsize];
    int blk_w = std::max(w_b >> sx, 4);
    int blk_h = std::max(h_b >> sy, 4);
    i32 coeffs[32 * 32];
    int eob = 0, cul = 0, dcsign = 0, tx_type = cur_tx_type;
    if (!skip) {
      eob = read_coeffs(plane, px, py, tx, mode, blk_w, blk_h,
                        coeffs, &cul, &dcsign, &tx_type);
    }

    int hh = std::min(th, ph - py);
    int ww = std::min(tw, pw - px);

    // ---- eager reconstruction (tile.py _run_job) ----
    i64 pred[64 * 64];
    if (use_pal) {
      for (int i = 0; i < th; i++)
        for (int j = 0; j < tw; j++)
          pred[i * tw + j] = pcolors[pmap[(i64)(ry + i) * pmw + rx + j]];
    } else if (plane == 0 && fi_mode >= 0) {
      predict_filter_intra(pt, frame, px, py, tw, th, fi_mode, have_above,
                           have_left, bd, pred);
    } else {
      predict_intra(pt, frame, px, py, tw, th, pred_mode, angle,
                    have_above, have_left, n_tr, n_bl, bd,
                    p.enable_intra_edge_filter,
                    plane == 0 ? filt_type_y : filt_type_uv, pred);
    }
    bool is_cfl = plane && mode == UV_CFL_PRED;
    if (is_cfl) {
      int alpha = plane == 1 ? cfl_alpha_u : cfl_alpha_v;
      const PlaneView& luma = planes[0];
      int ly = py << p.ssy, lx = px << p.ssx;
      i64 q3[64 * 64];
      int bh2, bw2;
      if (p.ssx && p.ssy) {
        bh2 = std::min(th, (luma.h - ly + 1) >> 1);
        bw2 = std::min(tw, (luma.w - lx + 1) >> 1);
        for (int i = 0; i < bh2; i++)
          for (int j = 0; j < bw2; j++) {
            int yy = ly + 2 * i, xx = lx + 2 * j;
            i64 box = luma.at(yy, xx) +
                      (xx + 1 < luma.w ? luma.at(yy, xx + 1) : 0) +
                      (yy + 1 < luma.h ? luma.at(yy + 1, xx) : 0) +
                      (yy + 1 < luma.h && xx + 1 < luma.w
                           ? luma.at(yy + 1, xx + 1) : 0);
            q3[i * tw + j] = box << 1;
          }
      } else if (p.ssx) {
        bh2 = std::min(th, luma.h - ly);
        bw2 = std::min(tw, (luma.w - lx + 1) >> 1);
        for (int i = 0; i < bh2; i++)
          for (int j = 0; j < bw2; j++) {
            int xx = lx + 2 * j;
            i64 box = luma.at(ly + i, xx) +
                      (xx + 1 < luma.w ? luma.at(ly + i, xx + 1) : 0);
            q3[i * tw + j] = box << 2;
          }
      } else {
        bh2 = std::min(th, luma.h - ly);
        bw2 = std::min(tw, luma.w - lx);
        for (int i = 0; i < bh2; i++)
          for (int j = 0; j < bw2; j++)
            q3[i * tw + j] = luma.at(ly + i, lx + j) << 3;
      }
      // cfl_pad: replicate last row/col
      for (int i = 0; i < bh2; i++)
        for (int j = bw2; j < tw; j++)
          q3[i * tw + j] = q3[i * tw + bw2 - 1];
      for (int i = bh2; i < th; i++)
        for (int j = 0; j < tw; j++)
          q3[i * tw + j] = q3[(bh2 - 1) * tw + j];
      i64 sum = 0;
      for (i64 i = 0; i < (i64)th * tw; i++) sum += q3[i];
      // rounded average (aom subtract_average; matches tile.py)
      int npel_log2 = bitlen(tw) - 1 + bitlen(th) - 1;
      i64 avg = (sum + ((i64)1 << (npel_log2 - 1))) >> npel_log2;
      i64 maxv = (1 << bd) - 1;
      for (i64 i = 0; i < (i64)th * tw; i++) {
        i64 ac = q3[i] - avg;
        i64 scaled = (i64)alpha * ac;
        i64 adj = scaled >= 0 ? (scaled + 32) >> 6 : -((-scaled + 32) >> 6);
        pred[i] = clampi(pred[i] + adj, 0, maxv);
      }
    }

    if (eob > 0) {
      i32 res[64 * 64];
      inv_transform(plane, tx, coeffs, cur_qindex, tx_type, res);
      i64 maxv = (1 << bd) - 1;
      for (int i = 0; i < hh; i++)
        for (int j = 0; j < ww; j++)
          frame.set(py + i, px + j,
                    clampi(pred[i * tw + j] + res[i * tw + j], 0, maxv));
    } else {
      for (int i = 0; i < hh; i++)
        for (int j = 0; j < ww; j++)
          frame.set(py + i, px + j, pred[i * tw + j]);
    }

    // context updates
    int sb_py = (sb_mi_row * 4) >> sy;
    int lrow = (py - sb_py) / 4;
    int w_cells = std::min(n_w, std::max((pw - px) / 4, 0));
    int h_cells = std::min(n_h, std::max((ph - py) / 4, 0));
    for (int i = 0; i < w_cells && u_c + i < (int)above_lvl[plane].size();
         i++) {
      above_lvl[plane][u_c + i] = std::min(cul, 63);
      above_sign[plane][u_c + i] = dcsign;
    }
    for (int i = 0; i < h_cells && lrow + i < (int)left_lvl[plane].size();
         i++) {
      left_lvl[plane][lrow + i] = std::min(cul, 63);
      left_sign[plane][lrow + i] = dcsign;
    }
    for (int i = 0; i < n_h && u_r + 1 + i < mi_rows + 2; i++)
      for (int j = 0; j < n_w && u_c + 1 + j < dstride; j++)
        dec[(i64)(u_r + 1 + i) * dstride + u_c + 1 + j] = 1;
  }
};

}  // namespace av1n

namespace av1n {

// ======================================================================
// Deblocking (codecs/av1/deblock.py; spec 7.14, intra specialization)
// ======================================================================

static int adjust_lf_level(int base, bool delta_enabled, int intra_delta) {
  // aom av1_loop_filter_frame_init intra level: NO base==0 early-out —
  // zero base + ref_deltas[INTRA_FRAME]=1 still filters at level 1
  // (deblock.py _adjust_level)
  if (!delta_enabled) return base;
  int scale = 1 << (base >> 5);
  return (int)clampi(base + intra_delta * scale, 0, 63);
}

static void lf_thresholds(int lvl, int sharpness, int* blimit, int* limit,
                          int* thresh) {
  int shift = sharpness > 4 ? 2 : (sharpness > 0 ? 1 : 0);
  int lim;
  if (sharpness > 0)
    lim = (int)clampi(lvl >> shift, 1, 9 - sharpness);
  else
    lim = std::max(1, lvl);
  *blimit = 2 * (lvl + 2) + lim;
  *limit = lim;
  *thresh = lvl >> 4;
}

// filter one line: samples via get/set with signed offset from the edge
// (offset 0 = first sample right of / below the edge)
template <typename GET, typename SET>
static void deblock_line(GET g, SET setv, int length, int blimit, int limit,
                         int thresh, int bd) {
  i64 p6 = g(-7), p5 = g(-6), p4 = g(-5), p3 = g(-4), p2 = g(-3),
      p1 = g(-2), p0 = g(-1);
  i64 q0 = g(0), q1 = g(1), q2 = g(2), q3 = g(3), q4 = g(4), q5 = g(5),
      q6 = g(6);
  auto ab = [](i64 x) { return x < 0 ? -x : x; };
  bool fm = ab(p1 - p0) <= limit && ab(q1 - q0) <= limit &&
            ab(p0 - q0) * 2 + (ab(p1 - q1) >> 1) <= blimit;
  if (length >= 6) fm = fm && ab(p2 - p1) <= limit && ab(q2 - q1) <= limit;
  if (length >= 8) fm = fm && ab(p3 - p2) <= limit && ab(q3 - q2) <= limit;
  if (!fm) return;

  // flat threshold / filter4 clamps scale with depth (spec 7.14.6.2)
  const i64 F = (i64)1 << (bd - 8);
  const i64 mid = (i64)128 << (bd - 8);
  const i64 maxv = ((i64)1 << bd) - 1;
  bool flat = false, flat2 = false;
  if (length >= 6) {
    flat = ab(p1 - p0) <= F && ab(q1 - q0) <= F && ab(p2 - p0) <= F &&
           ab(q2 - q0) <= F;
    if (length >= 8) flat = flat && ab(p3 - p0) <= F && ab(q3 - q0) <= F;
  }
  if (length >= 14)
    flat2 = flat && ab(p6 - p0) <= F && ab(q6 - q0) <= F &&
            ab(p5 - p0) <= F && ab(q5 - q0) <= F && ab(p4 - p0) <= F &&
            ab(q4 - q0) <= F;

  // narrow filter (filter4)
  bool hev = ab(p1 - p0) > thresh || ab(q1 - q0) > thresh;
  auto c8 = [mid](i64 x) { return clampi(x, -mid, mid - 1); };
  i64 ps1 = p1 - mid, ps0 = p0 - mid, qs0 = q0 - mid, qs1 = q1 - mid;
  i64 f = hev ? c8(ps1 - qs1) : 0;
  f = c8(f + 3 * (qs0 - ps0));
  i64 f1 = c8(f + 4) >> 3;
  i64 f2 = c8(f + 3) >> 3;
  i64 n_q0 = clampi(c8(qs0 - f1) + mid, 0, maxv);
  i64 n_p0 = clampi(c8(ps0 + f2) + mid, 0, maxv);
  i64 f3 = (f1 + 1) >> 1;
  i64 n_q1 = hev ? q1 : clampi(c8(qs1 - f3) + mid, 0, maxv);
  i64 n_p1 = hev ? p1 : clampi(c8(ps1 + f3) + mid, 0, maxv);

  auto r2 = [](i64 x) { return (x + 4) >> 3; };
  auto r4 = [](i64 x) { return (x + 8) >> 4; };
  if (length == 4) {
    setv(-2, n_p1); setv(-1, n_p0); setv(0, n_q0); setv(1, n_q1);
    return;
  }
  if (length == 6) {
    if (flat) {
      setv(-2, r2(p2 * 3 + p1 * 2 + p0 * 2 + q0));
      setv(-1, r2(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1));
      setv(0, r2(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2));
      setv(1, r2(q2 * 3 + q1 * 2 + q0 * 2 + p0));
    } else {
      setv(-2, n_p1); setv(-1, n_p0); setv(0, n_q0); setv(1, n_q1);
    }
    return;
  }
  // length >= 8
  if (length >= 14 && flat2) {
    setv(-6, r4(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0));
    setv(-5, r4(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 +
                q1));
    setv(-4, r4(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 +
                q1 + q2));
    setv(-3, r4(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 +
                q1 + q2 + q3));
    setv(-2, r4(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 +
                q1 + q2 + q3 + q4));
    setv(-1, r4(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 +
                q2 + q3 + q4 + q5));
    setv(0, r4(q6 + q5 + q4 + q3 + q2 + q1 * 2 + q0 * 2 + p0 * 2 + p1 +
               p2 + p3 + p4 + p5));
    setv(1, r4(q6 * 2 + q5 + q4 + q3 + q2 * 2 + q1 * 2 + q0 * 2 + p0 +
               p1 + p2 + p3 + p4));
    setv(2, r4(q6 * 3 + q5 + q4 + q3 * 2 + q2 * 2 + q1 * 2 + q0 + p0 +
               p1 + p2 + p3));
    setv(3, r4(q6 * 4 + q5 + q4 * 2 + q3 * 2 + q2 * 2 + q1 + q0 + p0 +
               p1 + p2));
    setv(4, r4(q6 * 5 + q5 * 2 + q4 * 2 + q3 * 2 + q2 + q1 + q0 + p0 +
               p1));
    setv(5, r4(q6 * 7 + q5 * 2 + q4 * 2 + q3 + q2 + q1 + q0 + p0));
    return;
  }
  if (flat) {
    setv(-3, r2(p3 * 3 + p2 * 2 + p1 + p0 + q0));
    setv(-2, r2(p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1));
    setv(-1, r2(p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2));
    setv(0, r2(q3 + q2 + q1 + q0 * 2 + p0 + p1 + p2));
    setv(1, r2(q3 * 2 + q2 + q1 * 2 + q0 + p0 + p1));
    setv(2, r2(q3 * 3 + q2 * 2 + q1 + q0 + p0));
  } else {
    setv(-2, n_p1); setv(-1, n_p0); setv(0, n_q0); setv(1, n_q1);
  }
}

static void apply_deblock(FrameCtx& ctx) {
  const Params& p = ctx.p;
  int intra_delta = p.lf_ref_delta_intra;
  bool delta_en = p.lf_delta_enabled;
  int sharp = p.lf_sharpness;
  int lvls[4];
  for (int i = 0; i < 4; i++)
    lvls[i] = adjust_lf_level(p.lf_levels[i], delta_en, intra_delta);
  // aom av1_loop_filter_frame plane gates on the RAW levels: luma
  // both-zero → nothing filters at all; each chroma plane gated on
  // its own raw level (deblock.py apply_deblock)
  if (p.lf_levels[0] == 0 && p.lf_levels[1] == 0) return;

  // one (plane, direction) pass over worker widx's share of the
  // disjoint 4-row segments; directions are barriered by the caller
  // (the horizontal pass reads the vertical pass's output)
  auto run_dir = [&](int plane, int direction, int widx, int wcnt) {
    PlaneView& buf = ctx.planes[plane];
    int max_len = plane == 0 ? 14 : 6;
    // plane-scaled visible frame dims: spec 7.14.2 skips an edge when
    // x >= FrameWidth or y >= FrameHeight (plane coords), so edges in
    // the 8px alignment padding stay unfiltered (CDEF reads the raw
    // recon padding there, like aom)
    int ssx = plane > 0 ? ctx.p.ssx : 0;
    int ssy = plane > 0 ? ctx.p.ssy : 0;
    int fw_p = (ctx.p.frame_w + ssx) >> ssx;
    int fh_p = (ctx.p.frame_h + ssy) >> ssy;
    {
      int lvl = plane == 0 ? lvls[direction] : lvls[plane + 1];
      if (lvl == 0) return;
      int blimit, limit, thresh;
      lf_thresholds(lvl, sharp, &blimit, &limit, &thresh);
      // threshold scaling for high bit depth (spec 7.14.4)
      blimit <<= p.bit_depth - 8;
      limit <<= p.bit_depth - 8;
      thresh <<= p.bit_depth - 8;
      const u8* edge = direction == 0 ? ctx.edge_vert[plane].data()
                                      : ctx.edge_horz[plane].data();
      const i32* tdim = direction == 0 ? ctx.edge_tw[plane].data()
                                       : ctx.edge_th[plane].data();
      int gw = ctx.egw[plane], gh = ctx.egh[plane];
      // axis semantics: direction 0 filters along x (vertical edges,
      // columns left->right); direction 1 along y (transposed walk)
      int pw = direction == 0 ? buf.w : buf.h;
      int ph = direction == 0 ? buf.h : buf.w;
      int egx = direction == 0 ? gw : gh;  // transposed edge dims
      int egy = direction == 0 ? gh : gw;
      int edge_lim = direction == 0 ? fw_p : fh_p;
      int row_lim = direction == 0 ? fh_p : fw_p;
      int n_gy = (ph + 3) / 4;
      // gy-outer/gx-inner: edges within one 4-row segment must run
      // left-to-right (wide filters read previous columns' output) but
      // segments in different rows are disjoint — split gy over workers
      // in contiguous halves (interleaved stripes false-share cache
      // lines at every segment boundary)
      int gy_end = std::min(std::min(egy, n_gy), (row_lim + 3) / 4);
      int gy_lo = (int)((i64)gy_end * widx / wcnt);
      int gy_hi = (int)((i64)gy_end * (widx + 1) / wcnt);
      int gx_end = std::min((pw + 3) / 4, egx);
      for (int gy = gy_lo; gy < gy_hi; gy++) {
        for (int gx = 1; gx < gx_end; gx++) {
          int x = gx * 4;
          if (x >= edge_lim) break;
          u8 e = direction == 0 ? edge[(i64)gy * gw + gx]
                                : edge[(i64)gx * gw + gy];
          if (!e) continue;
          i64 cur = direction == 0 ? tdim[(i64)gy * gw + gx]
                                   : tdim[(i64)gx * gw + gy];
          i64 prev = direction == 0 ? tdim[(i64)gy * gw + gx - 1]
                                    : tdim[(i64)(gx - 1) * gw + gy];
          int ln_raw = (int)std::min<i64>(std::min(cur, prev), max_len);
          int ln;
          if (plane == 0)
            ln = ln_raw >= 14 ? 14 : (ln_raw >= 8 ? 8 :
                                      (ln_raw >= 6 ? 6 : 4));
          else
            ln = ln_raw >= 6 ? 6 : 4;
          for (int rr = gy * 4; rr < std::min(gy * 4 + 4, ph); rr++) {
            if (direction == 0) {
              auto g = [&](int k) {
                int xc = (int)clampi(x + k, 0, pw - 1);
                return buf.at(rr, xc);
              };
              auto s = [&](int k, i64 v) {
                int xc = x + k;
                if (xc >= 0 && xc < pw) buf.set(rr, xc, v);
              };
              deblock_line(g, s, ln, blimit, limit, thresh, p.bit_depth);
            } else {
              auto g = [&](int k) {
                int yc = (int)clampi(x + k, 0, pw - 1);
                return buf.at(yc, rr);
              };
              auto s = [&](int k, i64 v) {
                int yc = x + k;
                if (yc >= 0 && yc < pw) buf.set(yc, rr, v);
              };
              deblock_line(g, s, ln, blimit, limit, thresh, p.bit_depth);
            }
          }
        }
      }
    }
  };
  int npl = std::min(3, ctx.num_planes);
  bool threaded = std::thread::hardware_concurrency() >= 2;
  // stage list: (plane, direction) in spec order; ONE helper thread for
  // the whole filter, spin barriers between stages (pass 1 reads pass
  // 0's output; planes are independent but kept in order for clarity)
  struct Stage { int plane, dir; };
  Stage stages[6];
  int n_stages = 0;
  for (int plane = 0; plane < npl; plane++) {
    if (plane > 0 && p.lf_levels[plane + 1] == 0) continue;
    for (int direction = 0; direction < 2; direction++)
      stages[n_stages++] = {plane, direction};
  }
  if (threaded) {
    std::atomic<int> done0{-1}, done1{-1};
    std::thread th([&]() {
      for (int s = 0; s < n_stages; s++) {
        while (done0.load(std::memory_order_acquire) < s - 1) {}
        run_dir(stages[s].plane, stages[s].dir, 1, 2);
        done1.store(s, std::memory_order_release);
      }
    });
    for (int s = 0; s < n_stages; s++) {
      run_dir(stages[s].plane, stages[s].dir, 0, 2);
      done0.store(s, std::memory_order_release);
      while (done1.load(std::memory_order_acquire) < s &&
             s + 1 < n_stages) {}
    }
    th.join();
  } else {
    for (int s = 0; s < n_stages; s++)
      run_dir(stages[s].plane, stages[s].dir, 0, 1);
  }
}

// ======================================================================
// CDEF (codecs/av1/cdef.py; spec 7.15)
// ======================================================================

static const int CDEF_VERY_LARGE = 30000;
static const int CDEF_DIR[8][2][2] = {
  {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
  {{0, 1}, {1, 2}}, {{1, 1}, {2, 2}}, {{1, 0}, {2, 1}},
  {{1, 0}, {2, 0}}, {{1, 0}, {2, -1}},
};
static const int CDEF_DIV[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
static const int CDEF_PRI_TAPS[2][2] = {{4, 2}, {3, 3}};
static const int CDEF_SEC_TAPS[2] = {2, 1};

static void cdef_find_dir(const u16* pad, int pstride, int y0, int x0,
                          int coeff_shift, int* dir_out, i64* var_out) {
  i64 partial[8][15];
  memset(partial, 0, sizeof(partial));
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) {
      i64 x = ((i64)pad[(i64)(y0 + i + 2) * pstride + x0 + j + 2] >>
               coeff_shift) - 128;
      partial[0][i + j] += x;
      partial[1][i + j / 2] += x;
      partial[2][i] += x;
      partial[3][3 + i - j / 2] += x;
      partial[4][7 + i - j] += x;
      partial[5][3 - i / 2 + j] += x;
      partial[6][j] += x;
      partial[7][i / 2 + j] += x;
    }
  i64 cost[8] = {0};
  for (int i = 0; i < 8; i++) {
    cost[2] += partial[2][i] * partial[2][i];
    cost[6] += partial[6][i] * partial[6][i];
  }
  cost[2] *= 105;
  cost[6] *= 105;
  for (int i = 0; i < 7; i++) {
    cost[0] += (partial[0][i] * partial[0][i] +
                partial[0][14 - i] * partial[0][14 - i]) * CDEF_DIV[i + 1];
    cost[4] += (partial[4][i] * partial[4][i] +
                partial[4][14 - i] * partial[4][14 - i]) * CDEF_DIV[i + 1];
  }
  cost[0] += partial[0][7] * partial[0][7] * CDEF_DIV[8];
  cost[4] += partial[4][7] * partial[4][7] * CDEF_DIV[8];
  for (int d = 1; d < 8; d += 2) {
    for (int j = 0; j < 5; j++)
      cost[d] += partial[d][3 + j] * partial[d][3 + j];
    cost[d] *= 105;
    for (int j = 0; j < 3; j++)
      cost[d] += (partial[d][j] * partial[d][j] +
                  partial[d][10 - j] * partial[d][10 - j]) *
                 CDEF_DIV[2 * j + 2];
  }
  int best = 0;
  for (int d = 1; d < 8; d++)
    if (cost[d] > cost[best]) best = d;
  *dir_out = best;
  *var_out = (cost[best] - cost[(best + 4) & 7]) >> 10;
}

static i64 cdef_constrain(i64 diff, i64 threshold, int damping) {
  if (!threshold) return 0;
  int damp = std::max(0, damping - (bitlen(threshold) - 1));
  i64 a = diff < 0 ? -diff : diff;
  i64 v = std::min(a, std::max<i64>(0, threshold - (a >> damp)));
  return diff < 0 ? -v : v;
}

static void cdef_filter_block(u16* dst, int dstride, const u16* pad,
                              int pstride, int y0, int x0, int h, int w,
                              i64 pri, i64 sec, int damping, int dir,
                              int coeff_shift) {
  // flat tap list (offset, tap, threshold, damp): up to 4 pri + 8 sec;
  // the inner per-row loops are branch-light so -O3 vectorizes them
  const int* pri_taps = CDEF_PRI_TAPS[(pri >> coeff_shift) & 1];
  int damp_pri = pri ? std::max(0, damping - (bitlen(pri) - 1)) : 0;
  int damp_sec = sec ? std::max(0, damping - (bitlen(sec) - 1)) : 0;
  int n_taps = 0;
  int t_off[12], t_tap[12];
  i32 t_thr[12];
  int t_damp[12];
  if (pri) {
    for (int k = 0; k < 2; k++) {
      int oy = CDEF_DIR[dir][k][0], ox = CDEF_DIR[dir][k][1];
      for (int sg = 1; sg >= -1; sg -= 2) {
        t_off[n_taps] = sg * (oy * pstride + ox);
        t_tap[n_taps] = pri_taps[k];
        t_thr[n_taps] = (i32)pri;
        t_damp[n_taps] = damp_pri;
        n_taps++;
      }
    }
  }
  if (sec) {
    for (int k = 0; k < 2; k++)
      for (int dd = 0; dd < 2; dd++) {
        int d2 = (dir + (dd == 0 ? 2 : 6)) & 7;
        int oy = CDEF_DIR[d2][k][0], ox = CDEF_DIR[d2][k][1];
        for (int sg = 1; sg >= -1; sg -= 2) {
          t_off[n_taps] = sg * (oy * pstride + ox);
          t_tap[n_taps] = CDEF_SEC_TAPS[k];
          t_thr[n_taps] = (i32)sec;
          t_damp[n_taps] = damp_sec;
          n_taps++;
        }
      }
  }
#if defined(__SSE2__)
  // 8-lane i16 path (8-bit content: samples <= 255, taps <= 4,
  // thresholds <= 19, so every intermediate fits i16; VERY_LARGE
  // padding lanes are excluded from min/max by masking and contribute
  // 0 to the sum because threshold - (a >> damp) goes negative).
  // Bit-exact vs the scalar loop below; w==4 rows store 4 lanes.
  if (w == 8 || w == 4) {
    const __m128i vl = _mm_set1_epi16((short)CDEF_VERY_LARGE);
    const __m128i i16min = _mm_set1_epi16((short)0x8000);
    const __m128i i16max = _mm_set1_epi16(0x7fff);
    for (int dy = 0; dy < h; dy++) {
      const u16* row = pad + (i64)(y0 + dy + 2) * pstride + x0 + 2;
      __m128i x = _mm_loadu_si128((const __m128i*)row);
      __m128i s = _mm_setzero_si128();
      __m128i mn = x, mx = x;
      for (int t = 0; t < n_taps; t++) {
        __m128i pv = _mm_loadu_si128((const __m128i*)(row + t_off[t]));
        __m128i diff = _mm_sub_epi16(pv, x);
        __m128i sgn = _mm_srai_epi16(diff, 15);
        __m128i a = _mm_sub_epi16(_mm_xor_si128(diff, sgn), sgn);
        __m128i cl = _mm_subs_epu16(_mm_set1_epi16((short)t_thr[t]),
                                    _mm_sra_epi16(a,
                                        _mm_cvtsi32_si128(t_damp[t])));
        __m128i v = _mm_min_epi16(a, cl);
        v = _mm_sub_epi16(_mm_xor_si128(v, sgn), sgn);
        s = _mm_add_epi16(s, _mm_mullo_epi16(
                                 _mm_set1_epi16((short)t_tap[t]), v));
        __m128i inval = _mm_cmpeq_epi16(pv, vl);
        mx = _mm_max_epi16(mx, _mm_or_si128(
                                   _mm_andnot_si128(inval, pv),
                                   _mm_and_si128(inval, i16min)));
        mn = _mm_min_epi16(mn, _mm_or_si128(
                                   _mm_andnot_si128(inval, pv),
                                   _mm_and_si128(inval, i16max)));
      }
      __m128i neg = _mm_srli_epi16(s, 15);     // 1 where s < 0
      __m128i adj = _mm_sub_epi16(_mm_add_epi16(s,
                                      _mm_set1_epi16(8)), neg);
      __m128i out = _mm_add_epi16(x, _mm_srai_epi16(adj, 4));
      out = _mm_max_epi16(mn, _mm_min_epi16(mx, out));
      u16* drow = dst + (i64)(y0 + dy) * dstride + x0;
      if (w == 8)
        _mm_storeu_si128((__m128i*)drow, out);
      else
        _mm_storel_epi64((__m128i*)drow, out);
    }
    return;
  }
#endif
  i32 xr[8], sr[8], mnr[8], mxr[8];
  for (int dy = 0; dy < h; dy++) {
    const u16* row = pad + (i64)(y0 + dy + 2) * pstride + x0 + 2;
    for (int j = 0; j < w; j++) {
      xr[j] = row[j];
      sr[j] = 0;
      mnr[j] = xr[j];
      mxr[j] = xr[j];
    }
    for (int t = 0; t < n_taps; t++) {
      const u16* prow = row + t_off[t];
      i32 thr = t_thr[t], tap = t_tap[t];
      int damp = t_damp[t];
      for (int j = 0; j < w; j++) {
        i32 pv = prow[j];
        i32 diff = pv - xr[j];
        i32 a = diff < 0 ? -diff : diff;
        i32 cl = std::max(0, thr - (a >> damp));
        i32 v = a < cl ? a : cl;
        sr[j] += tap * (diff < 0 ? -v : v);
        bool valid = pv != CDEF_VERY_LARGE;
        mxr[j] = valid && pv > mxr[j] ? pv : mxr[j];
        mnr[j] = valid && pv < mnr[j] ? pv : mnr[j];
      }
    }
    u16* drow = dst + (i64)(y0 + dy) * dstride + x0;
    for (int j = 0; j < w; j++) {
      i32 v = xr[j] + ((8 + sr[j] - (sr[j] < 0 ? 1 : 0)) >> 4);
      drow[j] = (u16)std::max(mnr[j], std::min(mxr[j], v));
    }
  }
}


// u16 padded snapshot of the current planes (border = CDEF_VERY_LARGE,
// interior offset +2) shared by CDEF (tap source) and LR (boundary
// source) so no full-precision i32 frame copies are needed
struct PadSnap {
  std::vector<u16> buf[3];
  int stride[3], vw[3], vh[3];
};

static void build_pad_snapshot(FrameCtx& ctx, PadSnap* out) {
  const Params& p = ctx.p;
  int a = 7;
  int vw0 = (p.frame_w + a) & ~a;
  int vh0 = (p.frame_h + a) & ~a;
  auto build = [&](int pl) {
    int pw = pl == 0 ? vw0 : vw0 >> p.ssx;
    int ph = pl == 0 ? vh0 : vh0 >> p.ssy;
    out->vw[pl] = pw; out->vh[pl] = ph;
    int fw = ctx.planes[pl].w, fh = ctx.planes[pl].h;
    out->stride[pl] = fw + 4;
    // +8 u16 slack: the SSE2 cdef kernel's unaligned 8-lane loads may
    // read past the last row's end (extra lanes are discarded)
    out->buf[pl].assign((i64)(fh + 4) * (fw + 4) + 8, CDEF_VERY_LARGE);
    const u16* src = ctx.planes[pl].data;
    for (int y = 0; y < ph; y++) {
      u16* dr = out->buf[pl].data() + (i64)(y + 2) * out->stride[pl] + 2;
      const u16* sr = src + (i64)y * fw;
      for (int x = 0; x < pw; x++) dr[x] = (u16)sr[x];
    }
  };
  if (ctx.num_planes > 1 && std::thread::hardware_concurrency() >= 2) {
    std::thread tp([&]() { build(0); });
    for (int pl = 1; pl < ctx.num_planes; pl++) build(pl);
    tp.join();
  } else {
    for (int pl = 0; pl < ctx.num_planes; pl++) build(pl);
  }
}

// filter the frame; planes are overwritten with the CDEF output.
// pre->buf holds the deblocked-frame snapshot used as the tap source.
static void apply_cdef(FrameCtx& ctx, const PadSnap* pre) {
  const Params& p = ctx.p;
  int coeff_shift = p.bit_depth - 8;
  int num_planes = ctx.num_planes;
  const std::vector<u16>* pads = pre->buf;
  const int* pstride = pre->stride;

  int mi_rows = ctx.mi_rows, mi_cols = ctx.mi_cols;
  int y_damp = p.cdef_damping + coeff_shift;
  int uv_damp = y_damp - 1;
  int nby = (mi_rows + 1) >> 1, nbx = (mi_cols + 1) >> 1;
  // 8x8 block rows write disjoint plane rows and read only the frozen
  // padded copies: dispatch rows over 2 threads
  auto run_row = [&](int by) {
    for (int bx = 0; bx < nbx; bx++) {
      int r0 = by * 2, c0 = bx * 2;
      int r1 = std::min(r0 + 1, mi_rows - 1);
      int c1 = std::min(c0 + 1, mi_cols - 1);
      bool blk_skip = ctx.skip_map[(i64)r0 * mi_cols + c0] &&
                      ctx.skip_map[(i64)r0 * mi_cols + c1] &&
                      ctx.skip_map[(i64)r1 * mi_cols + c0] &&
                      ctx.skip_map[(i64)r1 * mi_cols + c1];
      int unit_r = std::min(by * 2 / 16 * 16, mi_rows - 1);
      int unit_c = std::min(bx * 2 / 16 * 16, mi_cols - 1);
      i64 idx = ctx.cdef_idx[(i64)unit_r * mi_cols + unit_c];
      if (idx < 0 || blk_skip) continue;
      int ys = by * 8, xs = bx * 8;
      i64 y_pri = (i64)p.cdef_y_pri[idx] << coeff_shift;
      i64 y_sec = (i64)p.cdef_y_sec[idx] << coeff_shift;
      int dir = 0;
      i64 var = 0;
      i64 uv_pri_blk = num_planes > 1
          ? ((i64)p.cdef_uv_pri[idx] << coeff_shift) : 0;
      // direction is computed from luma when the luma OR chroma
      // primary strength is nonzero (dav1d cdef_brow)
      if (y_pri > 0 || uv_pri_blk > 0)
        cdef_find_dir(pads[0].data(), pstride[0], ys, xs, coeff_shift,
                      &dir, &var);
      i64 v6 = var >> 6;
      i64 i_log = v6 > 0 ? std::min(bitlen(v6) - 1, 12) : 0;
      i64 pri_adj = var != 0 ? (y_pri * (4 + i_log) + 8) >> 4 : 0;
      if (y_pri <= 0) pri_adj = 0;
      bool luma_on = pri_adj > 0 || y_sec > 0 || y_pri > 0;
      // each plane uses the direction only when ITS primary strength
      // is nonzero (cdef.py)
      int luma_dir = y_pri > 0 ? dir : 0;
      if (luma_on)
        cdef_filter_block(ctx.planes[0].data, ctx.planes[0].stride,
                          pads[0].data(), pstride[0], ys, xs, 8, 8,
                          pri_adj, y_sec, y_damp, luma_dir, coeff_shift);
      if (num_planes > 1) {
        i64 uv_pri = (i64)p.cdef_uv_pri[idx] << coeff_shift;
        i64 uv_sec = (i64)p.cdef_uv_sec[idx] << coeff_shift;
        if (uv_pri > 0 || uv_sec > 0) {
          int cy = ys >> p.ssy, cx = xs >> p.ssx;
          int uv_dir = uv_pri > 0 ? dir : 0;
          for (int pl = 1; pl < 3; pl++)
            cdef_filter_block(ctx.planes[pl].data, ctx.planes[pl].stride,
                              pads[pl].data(), pstride[pl], cy, cx,
                              8 >> p.ssy, 8 >> p.ssx, uv_pri, uv_sec,
                              uv_damp, uv_dir, coeff_shift);
        }
      }
    }
  };
  bool threads_ok = nby > 1 && std::thread::hardware_concurrency() >= 2;
  if (threads_ok) {
    std::atomic<int> next{0};
    auto worker = [&]() {
      for (;;) {
        int by = next.fetch_add(1);
        if (by >= nby) break;
        run_row(by);
      }
    };
    std::thread th(worker);
    worker();
    th.join();
  } else {
    for (int by = 0; by < nby; by++) run_row(by);
  }
}

// ======================================================================
// Loop restoration (codecs/av1/lr.py; spec 7.17)
// ======================================================================

// from libaom av1_sgr_params rodata (see lr.py SGR_PARAMS)
static const int SGR_PARAMS_T[16][4] = {
  {2, 12, 1, 4}, {2, 15, 1, 6}, {2, 18, 1, 8}, {2, 21, 1, 9},
  {2, 24, 1, 10}, {2, 29, 1, 11}, {2, 36, 1, 12}, {2, 45, 1, 13},
  {2, 56, 1, 14}, {2, 68, 1, 15}, {0, 0, 1, 5}, {0, 0, 1, 8},
  {0, 0, 1, 11}, {0, 0, 1, 14}, {2, 30, 0, 0}, {2, 76, 0, 0},
};

// padded source rectangle per the get_source_sample rule (lr.py
// _gather_piece): margin 3
static void lr_gather(const u16* cdef_p, const u16* deblk_p, int stride,
                      int x0, int x1, int y0, int h, int ss_start,
                      int ss_end, int plane_w, int plane_h, i32* out,
                      int ow) {
  int w = x1 - x0;
  int margin = 3;
  int ph = h + 2 * margin;
  for (int i = 0; i < ph; i++) {
    int y = y0 - margin + i;
    y = std::min(std::max(y, 0), plane_h - 1);
    const u16* row;
    if (y < ss_start) {
      int yy = std::max(ss_start - 2, y);
      row = deblk_p + (i64)(yy + 2) * stride + 2;
    } else if (y > ss_end) {
      int yy = std::min(ss_end + 2, y);
      row = deblk_p + (i64)(yy + 2) * stride + 2;
    } else {
      row = cdef_p + (i64)(y + 2) * stride + 2;
    }
    for (int j = 0; j < w + 2 * margin; j++) {
      int x = (int)clampi(x0 - margin + j, 0, plane_w - 1);
      out[(i64)i * ow + j] = (i32)row[x];
    }
  }
}

static void wiener_filter(const i32* pad, int ow, int w, int h,
                          const i32* vcoeff, const i32* hcoeff, int bd,
                          u16* out, int ostride) {
  // i32 throughout for 8-bit content (|tap| <= 128, samples <= 2^16:
  // horizontal sums <= ~229k, vertical <= ~59M) so AVX2 autovectorizes
  // both passes
  i32 hf[7], vf[7];
  {
    i32 w0 = hcoeff[0], w1 = hcoeff[1], w2 = hcoeff[2];
    i32 w3 = 128 - 2 * (w0 + w1 + w2);
    hf[0] = w0; hf[1] = w1; hf[2] = w2; hf[3] = w3;
    hf[4] = w2; hf[5] = w1; hf[6] = w0;
    w0 = vcoeff[0]; w1 = vcoeff[1]; w2 = vcoeff[2];
    w3 = 128 - 2 * (w0 + w1 + w2);
    vf[0] = w0; vf[1] = w1; vf[2] = w2; vf[3] = w3;
    vf[4] = w2; vf[5] = w1; vf[6] = w0;
  }
  // spec 7.11.3.2: only 12-bit tightens the horizontal rounding
  int inter_round0 = bd == 12 ? 5 : 3;
  int inter_round1 = bd == 12 ? 9 : 11;
  i32 offset = 1 << (bd + 7 - inter_round0 - 1);
  i32 limit = (1 << (bd + 1 + 7 - inter_round0)) - 1;

  std::vector<i32> inter((i64)(h + 6) * w);
  for (int i = 0; i < h + 6; i++) {
    const i32* prow = pad + (i64)i * ow;
    i32* irow = inter.data() + (i64)i * w;
    for (int j = 0; j < w; j++) {
      i32 s = 0;
      for (int t = 0; t < 7; t++) s += hf[t] * prow[t + j];
      s = (s + (1 << (inter_round0 - 1))) >> inter_round0;
      irow[j] = std::max(-offset, std::min(limit - offset, s));
    }
  }
  i32 maxv = (1 << bd) - 1;
  for (int i = 0; i < h; i++) {
    u16* orow = out + (i64)i * ostride;
    const i32* ir = inter.data() + (i64)i * w;
    for (int j = 0; j < w; j++) {
      i32 s = 0;
      for (int t = 0; t < 7; t++) s += vf[t] * ir[(i64)t * w + j];
      s = (s + (1 << (inter_round1 - 1))) >> inter_round1;
      orow[j] = (u16)std::max(0, std::min(maxv, s));
    }
  }
}

// a2 = ((z<<8) + z/2) / (z+1) for z in [0,254]; z=0 -> 1 (lr.py)
static i64 g_sgr_a2[255];
static std::once_flag g_sgr_a2_once;
static void sgr_a2_init() {
  std::call_once(g_sgr_a2_once, [] {
    g_sgr_a2[0] = 1;
    for (i64 z = 1; z < 255; z++)
      g_sgr_a2[z] = ((z << 8) + z / 2) / (z + 1);
  });
}

static const int SGRPROJ_RST_BITS = 4;
static const int SGRPROJ_PRJ_BITS = 7;
static const int SGRPROJ_SGR_BITS = 8;
static const int SGRPROJ_MTABLE_BITS = 20;
static const int SGRPROJ_RECIP_BITS = 12;

// one box-filter pass (lr.py _box_filter); flt (h, w)
static void box_filter(const i32* pad, int ow, int w, int h, int sgr_set,
                       int pass_idx, int bd, i64* flt) {
  sgr_a2_init();
  int r = SGR_PARAMS_T[sgr_set][pass_idx * 2];
  i64 eps = SGR_PARAMS_T[sgr_set][pass_idx * 2 + 1];
  i64 n = (i64)(2 * r + 1) * (2 * r + 1);
  i64 n2e = n * n * eps;
  i64 s_val = (((i64)1 << SGRPROJ_MTABLE_BITS) + n2e / 2) / n2e;
  i64 one_over_n = (((i64)1 << SGRPROJ_RECIP_BITS) + (n >> 1)) / n;

  // A/B grids for i in -1..h, j in -1..w  (grid index [i+1][j+1]);
  // window sums via integral images over the padded piece.  8-bit
  // content: every quantity fits i32 (integral of squares over a
  // 70x70 piece <= 70*70*65025 ~ 318M; b2 <= 740M) except pv*s_val,
  // widened to i64 for the z computation only — the narrow types let
  // AVX2 autovectorize these loops (measured on the LR-heavy
  // example.avif bench).
  int gh = h + 2, gw = w + 2;
  std::vector<i32> A((i64)gh * gw), B((i64)gh * gw);
  int shift = 2 * (bd - 8);
  int ph6 = h + 6, pw6 = w + 6;
  std::vector<i32> csq((i64)(ph6 + 1) * (pw6 + 1), 0),
      cs((i64)(ph6 + 1) * (pw6 + 1), 0);
  for (int y = 0; y < ph6; y++) {
    i32 row_sq = 0, row_s = 0;
    for (int x = 0; x < pw6; x++) {
      i32 v = (i32)pad[(i64)y * ow + x];
      row_sq += v * v;
      row_s += v;
      csq[(i64)(y + 1) * (pw6 + 1) + x + 1] =
          csq[(i64)y * (pw6 + 1) + x + 1] + row_sq;
      cs[(i64)(y + 1) * (pw6 + 1) + x + 1] =
          cs[(i64)y * (pw6 + 1) + x + 1] + row_s;
    }
  }
  int wn = 2 * r + 1;
  int pw1 = pw6 + 1;
  for (int gi = 0; gi < gh; gi++) {
    int y0w = gi - 1 + 3 - r;     // window top-left in padded coords
    const i32* sq_t = csq.data() + (i64)y0w * pw1;
    const i32* sq_b = csq.data() + (i64)(y0w + wn) * pw1;
    const i32* s_t = cs.data() + (i64)y0w * pw1;
    const i32* s_b = cs.data() + (i64)(y0w + wn) * pw1;
    i32* Arow = A.data() + (i64)gi * gw;
    i32* Brow = B.data() + (i64)gi * gw;
    int x0w0 = -1 + 3 - r;
    for (int gj = 0; gj < gw; gj++) {
      int x0w = x0w0 + gj;
      i32 a_sum = sq_b[x0w + wn] - sq_t[x0w + wn] - sq_b[x0w] + sq_t[x0w];
      i32 b_sum = s_b[x0w + wn] - s_t[x0w + wn] - s_b[x0w] + s_t[x0w];
      i32 a_r = shift ? (i32)round2(a_sum, shift) : a_sum;
      i32 d_r = bd > 8 ? (i32)round2(b_sum, bd - 8) : b_sum;
      i32 pv = std::max(0, a_r * (i32)n - d_r * d_r);
      i64 z = ((i64)pv * s_val + ((i64)1 << (SGRPROJ_MTABLE_BITS - 1))) >>
              SGRPROJ_MTABLE_BITS;
      i32 a2 = z >= 255 ? 256 : (i32)g_sgr_a2[z];
      i32 b2 = (i32)((((1 << SGRPROJ_SGR_BITS) - a2) * b_sum *
                      (i32)one_over_n +
                      (1 << (SGRPROJ_RECIP_BITS - 1))) >> SGRPROJ_RECIP_BITS);
      Arow[gj] = a2;
      Brow[gj] = b2;
    }
  }

  for (int i = 0; i < h; i++) {
    int gi = i + 1;
    for (int j = 0; j < w; j++) {
      i64 center = pad[(i64)(i + 3) * ow + j + 3];
      i64 av, bv;
      int nb;
      if (pass_idx == 0) {
        if (i % 2 == 0) {
          av = 6 * (A[(i64)(gi - 1) * gw + j + 1] +
                    A[(i64)(gi + 1) * gw + j + 1]) +
               5 * (A[(i64)(gi - 1) * gw + j] + A[(i64)(gi - 1) * gw + j + 2] +
                    A[(i64)(gi + 1) * gw + j] + A[(i64)(gi + 1) * gw + j + 2]);
          bv = 6 * (B[(i64)(gi - 1) * gw + j + 1] +
                    B[(i64)(gi + 1) * gw + j + 1]) +
               5 * (B[(i64)(gi - 1) * gw + j] + B[(i64)(gi - 1) * gw + j + 2] +
                    B[(i64)(gi + 1) * gw + j] + B[(i64)(gi + 1) * gw + j + 2]);
          nb = 5;
        } else {
          av = 6 * A[(i64)gi * gw + j + 1] +
               5 * (A[(i64)gi * gw + j] + A[(i64)gi * gw + j + 2]);
          bv = 6 * B[(i64)gi * gw + j + 1] +
               5 * (B[(i64)gi * gw + j] + B[(i64)gi * gw + j + 2]);
          nb = 4;
        }
      } else {
        // total weight 32 -> nb = 5 (lr.py)
        nb = 5;
        av = 4 * (A[(i64)gi * gw + j + 1] + A[(i64)(gi - 1) * gw + j + 1] +
                  A[(i64)(gi + 1) * gw + j + 1] + A[(i64)gi * gw + j] +
                  A[(i64)gi * gw + j + 2]) +
             3 * (A[(i64)(gi - 1) * gw + j] + A[(i64)(gi - 1) * gw + j + 2] +
                  A[(i64)(gi + 1) * gw + j] + A[(i64)(gi + 1) * gw + j + 2]);
        bv = 4 * (B[(i64)gi * gw + j + 1] + B[(i64)(gi - 1) * gw + j + 1] +
                  B[(i64)(gi + 1) * gw + j + 1] + B[(i64)gi * gw + j] +
                  B[(i64)gi * gw + j + 2]) +
             3 * (B[(i64)(gi - 1) * gw + j] + B[(i64)(gi - 1) * gw + j + 2] +
                  B[(i64)(gi + 1) * gw + j] + B[(i64)(gi + 1) * gw + j + 2]);
      }
      i64 v = av * center + bv;
      flt[(i64)i * w + j] =
          (v + ((i64)1 << (SGRPROJ_SGR_BITS + nb - SGRPROJ_RST_BITS - 1)))
          >> (SGRPROJ_SGR_BITS + nb - SGRPROJ_RST_BITS);
    }
  }
}

static void sgrproj_filter(const i32* pad, int ow, int w, int h,
                           int sgr_set, const i32* xqd, int bd, u16* out,
                           int ostride) {
  int r0 = SGR_PARAMS_T[sgr_set][0];
  int r1 = SGR_PARAMS_T[sgr_set][2];
  std::vector<i64> flt0((i64)h * w), flt1((i64)h * w), u((i64)h * w);
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++)
      u[(i64)i * w + j] = pad[(i64)(i + 3) * ow + j + 3]
                          << SGRPROJ_RST_BITS;
  if (r0) box_filter(pad, ow, w, h, sgr_set, 0, bd, flt0.data());
  else flt0 = u;
  if (r1) box_filter(pad, ow, w, h, sgr_set, 1, bd, flt1.data());
  else flt1 = u;
  // aom decode_xq: xqd[1] codes the COMPLEMENT weight (lr.py)
  i64 w0, w2;
  if (r0 == 0) {
    w0 = 0;
    w2 = ((i64)1 << SGRPROJ_PRJ_BITS) - xqd[1];
  } else if (r1 == 0) {
    w0 = xqd[0];
    w2 = 0;
  } else {
    w0 = xqd[0];
    w2 = ((i64)1 << SGRPROJ_PRJ_BITS) - w0 - xqd[1];
  }
  i64 w1 = ((i64)1 << SGRPROJ_PRJ_BITS) - w0 - w2;
  i64 maxv = (1 << bd) - 1;
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) {
      i64 v = w0 * flt0[(i64)i * w + j] + w1 * u[(i64)i * w + j] +
              w2 * flt1[(i64)i * w + j];
      i64 s = (v + ((i64)1 << (SGRPROJ_RST_BITS + SGRPROJ_PRJ_BITS - 1)))
              >> (SGRPROJ_RST_BITS + SGRPROJ_PRJ_BITS);
      out[(i64)i * ostride + j] = (u16)clampi(s, 0, maxv);
    }
}

// frame loop-restore; planes currently hold the CDEF output, deblocked
// holds the pre-CDEF frame.  Output written in place.
static void apply_lr(FrameCtx& ctx, const PadSnap* cdef_snap,
                     const PadSnap* deblk_snap) {
  const Params& p = ctx.p;
  int bd = p.bit_depth;
  // every (plane, unit-row) writes a disjoint output rect and reads
  // only the frozen cdef/deblocked copies: dispatch them over 2 threads
  struct LrTask { int plane, ur; };
  std::vector<LrTask> tasks;
  for (int plane = 0; plane < ctx.num_planes; plane++) {
    if (p.lr_type[plane] == 0) continue;
    for (int ur = 0; ur < ctx.lr_ur[plane]; ur++)
      tasks.push_back({plane, ur});
  }
  auto run_task = [&](int plane, int ur) {
    int sub_x = plane == 0 ? 0 : p.ssx;
    int sub_y = plane == 0 ? 0 : p.ssy;
    int plane_w = (int)round2(p.frame_w, sub_x);
    int plane_h = (int)round2(p.frame_h, sub_y);
    int usize = p.lr_unit_size[plane];
    int ur_total = ctx.lr_ur[plane], uc_total = ctx.lr_uc[plane];
    int stripe_size = 64 >> sub_y;
    int voffset = 8 >> sub_y;
    int stride = ctx.planes[plane].stride;
    int pad_stride = cdef_snap->stride[plane];
    const u16* cdef_p = cdef_snap->buf[plane].data();
    const u16* deblk_p = deblk_snap->buf[plane].data();
    {
      // unit-row extents shift up by the stripe offset (lr.py)
      int uy0 = ur == 0 ? 0 : ur * usize - voffset;
      int uy1 = ur == ur_total - 1
                    ? plane_h
                    : std::min((ur + 1) * usize - voffset, plane_h);
      for (int uc = 0; uc < uc_total; uc++) {
        i64 ui = (i64)ur * uc_total + uc;
        int unit_type = ctx.lr_type_map[plane][ui];
        if (unit_type == 0) continue;
        int ux0 = uc * usize;
        int ux1 = uc == uc_total - 1 ? plane_w
                                     : std::min((uc + 1) * usize, plane_w);
        int w = ux1 - ux0;
        if (w <= 0) continue;
        int y = uy0;
        while (y < uy1) {
          int stripe_num = (y + voffset) / stripe_size;
          int ss_start = stripe_num * stripe_size - voffset;
          int ss_end = ss_start + stripe_size - 1;
          int h = std::min(uy1 - 1, ss_end) - y + 1;
          int ow = w + 6;
          std::vector<i32> pad((i64)(h + 6) * ow);
          lr_gather(cdef_p, deblk_p, pad_stride, ux0, ux1, y, h, ss_start,
                    ss_end, plane_w, plane_h, pad.data(), ow);
          u16* outp = ctx.planes[plane].data + (i64)y * stride + ux0;
          if (unit_type == 2) {
            const i32* wn = &ctx.lr_wiener[plane][ui * 6];
            wiener_filter(pad.data(), ow, w, h, wn, wn + 3, bd, outp,
                          stride);
          } else {
            sgrproj_filter(pad.data(), ow, w, h,
                           ctx.lr_sgr_set[plane][ui],
                           &ctx.lr_xqd[plane][ui * 2], bd, outp, stride);
          }
          y += h;
        }
      }
    }
  };
  bool threads_ok = tasks.size() > 1 &&
                    std::thread::hardware_concurrency() >= 2;
  if (threads_ok) {
    std::atomic<size_t> next{0};
    auto worker = [&]() {
      for (;;) {
        size_t i = next.fetch_add(1);
        if (i >= tasks.size()) break;
        run_task(tasks[i].plane, tasks[i].ur);
      }
    };
    std::thread th(worker);
    worker();
    th.join();
  } else {
    for (const LrTask& t : tasks) run_task(t.plane, t.ur);
  }
}

}  // namespace av1n

// ======================================================================
// C ABI
// ======================================================================

namespace av1n {

// merge the frame-wide outputs a second tile-decoding context produced
// for its tiles into the main context.  AV1 tiles are fully independent
// (no cross-tile prediction or entropy state), so every buffer below is
// written in disjoint regions and a plain region copy is exact.
static void merge_tile_worker(FrameCtx* a, FrameCtx* b,
                              const long long* tile_meta, int n_tiles,
                              const signed char* owner) {
  for (int t = 0; t < n_tiles; t++) {
    if (!owner[t]) continue;
    const long long* m = tile_meta + (i64)t * 6;
    int c0 = (int)m[2], c1 = (int)m[3], r0 = (int)m[4], r1 = (int)m[5];
    for (int r = r0; r < r1; r++) {
      i64 o = (i64)r * a->mi_cols;
      memcpy(&a->skip_map[o + c0], &b->skip_map[o + c0],
             (size_t)(c1 - c0) * sizeof(i32));
      memcpy(&a->cdef_idx[o + c0], &b->cdef_idx[o + c0],
             (size_t)(c1 - c0) * sizeof(i32));
    }
    for (int pl = 0; pl < a->num_planes; pl++) {
      int sx = pl ? a->p.ssx : 0, sy = pl ? a->p.ssy : 0;
      int x0 = (c0 * 4) >> sx, x1 = std::min((c1 * 4) >> sx, a->planes[pl].w);
      int y0 = (r0 * 4) >> sy, y1 = std::min((r1 * 4) >> sy, a->planes[pl].h);
      int stride = a->planes[pl].stride;
      for (int y = y0; y < y1; y++)
        memcpy(a->plane_buf[pl].data() + (i64)y * stride + x0,
               b->plane_buf[pl].data() + (i64)y * stride + x0,
               (size_t)(x1 - x0) * sizeof(u16));
      int gw = a->egw[pl];
      int gx0 = x0 >> 2, gx1 = std::min((x1 + 3) >> 2, gw);
      int gy0 = y0 >> 2, gy1 = std::min((y1 + 3) >> 2, a->egh[pl]);
      for (int g = gy0; g < gy1; g++) {
        i64 o = (i64)g * gw;
        memcpy(&a->edge_vert[pl][o + gx0], &b->edge_vert[pl][o + gx0],
               (size_t)(gx1 - gx0));
        memcpy(&a->edge_horz[pl][o + gx0], &b->edge_horz[pl][o + gx0],
               (size_t)(gx1 - gx0));
        memcpy(&a->edge_tw[pl][o + gx0], &b->edge_tw[pl][o + gx0],
               (size_t)(gx1 - gx0) * sizeof(i32));
        memcpy(&a->edge_th[pl][o + gx0], &b->edge_th[pl][o + gx0],
               (size_t)(gx1 - gx0) * sizeof(i32));
      }
    }
  }
  // loop-restoration units: the worker only writes units owned by its
  // tiles' superblocks, all other entries stay at their zero init
  for (int pl = 0; pl < a->num_planes; pl++) {
    i64 nunits = (i64)a->lr_ur[pl] * a->lr_uc[pl];
    for (i64 u = 0; u < nunits; u++) {
      if (b->lr_type_map[pl][u] == 0) continue;
      a->lr_type_map[pl][u] = b->lr_type_map[pl][u];
      for (int k = 0; k < 6; k++)
        a->lr_wiener[pl][u * 6 + k] = b->lr_wiener[pl][u * 6 + k];
      a->lr_sgr_set[pl][u] = b->lr_sgr_set[pl][u];
      a->lr_xqd[pl][u * 2] = b->lr_xqd[pl][u * 2];
      a->lr_xqd[pl][u * 2 + 1] = b->lr_xqd[pl][u * 2 + 1];
    }
  }
}

}  // namespace av1n

extern "C" int tpuheif_av1_decode_frame(
    const uint8_t* tiles_buf, long long tiles_len,
    const long long* tile_meta, int n_tiles,
    const int* params_buf, int n_params,
    const int* cdf_buf, long long cdf_len,
    unsigned char* y_out, unsigned char* u_out, unsigned char* v_out,
    char* err, int errlen) {
  using namespace av1n;
  if (n_params < N_PARAMS) {
    snprintf(err, errlen, "params too short");
    return 1;
  }
  Params p;
  params_from_buf(&p, params_buf);
  if (cdf_len < cdf_total_size()) {
    snprintf(err, errlen, "cdf buffer too short");
    return 1;
  }
  FrameCtx* ctx = new FrameCtx();
  int rc = ctx->init(p, cdf_buf, err, errlen);
  if (rc) { delete ctx; return rc; }
  // decode tiles; with >1 tile and >1 core, split across two contexts
  // pulling from a shared work queue (AV1 tiles are independent)
  bool threaded = n_tiles > 1 &&
                  std::thread::hardware_concurrency() >= 2;
  if (threaded) {
    char werr[200] = {0};
    FrameCtx* wctx = new FrameCtx();
    std::atomic<int> next{0};
    std::atomic<bool> w_ok{false};
    std::vector<signed char> owner((size_t)n_tiles, 0);
    auto run_tiles = [&](FrameCtx* c, signed char tag) {
      for (;;) {
        int t = next.fetch_add(1);
        if (t >= n_tiles) break;
        owner[t] = tag;
        const long long* m = tile_meta + (i64)t * 6;
        i64 off = m[0], size = m[1];
        if (off < 0 || size < 0 || off + size > tiles_len) {
          c->fail(1, "tile range out of bounds");
          break;
        }
        c->decode_tile(tiles_buf + off, size, (int)m[2], (int)m[3],
                       (int)m[4], (int)m[5]);
        if (c->rc) break;
      }
    };
    // the worker initializes its own context so the ~10MB of zeroing
    // overlaps the main thread's first tiles; if init fails the shared
    // work queue lets the main context finish everything
    std::thread th([&]() {
      if (wctx->init(p, cdf_buf, werr, sizeof(werr)) == 0) {
        w_ok.store(true);
        run_tiles(wctx, 1);
      }
    });
    run_tiles(ctx, 0);
    th.join();
    if (ctx->rc) rc = ctx->rc;
    else if (w_ok.load() && wctx->rc) {
      snprintf(err, errlen, "%s", werr);
      rc = wctx->rc;
    }
    if (!rc && w_ok.load())
      merge_tile_worker(ctx, wctx, tile_meta, n_tiles, owner.data());
    delete wctx;
    if (rc) { delete ctx; return rc; }
  } else {
    for (int t = 0; t < n_tiles; t++) {
      const long long* m = tile_meta + (i64)t * 6;
      i64 off = m[0], size = m[1];
      if (off < 0 || size < 0 || off + size > tiles_len) {
        snprintf(err, errlen, "tile range out of bounds");
        delete ctx;
        return 1;
      }
      ctx->decode_tile(tiles_buf + off, size, (int)m[2], (int)m[3],
                       (int)m[4], (int)m[5]);
      if (ctx->rc) { rc = ctx->rc; delete ctx; return rc; }
    }
  }

  // in-loop filters: deblock -> CDEF -> LR (decoder.py finish_frame)
  bool any_lf = p.lf_levels[0] || p.lf_levels[1] || p.lf_levels[2] ||
                p.lf_levels[3];
  if (!p.coded_lossless && any_lf) apply_deblock(*ctx);
  bool any_cdef = false;
  for (int i = 0; i < 8; i++)
    any_cdef = any_cdef || p.cdef_y_pri[i] || p.cdef_y_sec[i] ||
               p.cdef_uv_pri[i] || p.cdef_uv_sec[i];
  bool any_lr = p.lr_type[0] || p.lr_type[1] || p.lr_type[2];
  bool run_cdef = !p.coded_lossless && any_cdef;
  // one u16 snapshot of the deblocked frame serves as both the CDEF tap
  // source and LR's above/below-stripe source; a second snapshot after
  // CDEF is LR's in-stripe source (8-bit samples fit u16, no i32 copies)
  PadSnap pre_snap;
  if (run_cdef || any_lr) build_pad_snapshot(*ctx, &pre_snap);
  if (run_cdef) apply_cdef(*ctx, &pre_snap);
  if (any_lr) {
    PadSnap post_snap;
    const PadSnap* cdef_src = &pre_snap;
    if (run_cdef) {
      build_pad_snapshot(*ctx, &post_snap);
      cdef_src = &post_snap;
    }
    apply_lr(*ctx, cdef_src, &pre_snap);
  }

  // copy out: u8 for 8-bit, raw u16 for 10/12-bit (the caller
  // allocates the matching dtype)
  {
    unsigned char* outs[3] = {y_out, u_out, v_out};
    for (int pl = 0; pl < ctx->num_planes; pl++) {
      const u16* src = ctx->plane_buf[pl].data();
      i64 n = (i64)ctx->plane_buf[pl].size();
      if (p.bit_depth > 8) {
        memcpy(outs[pl], src, (size_t)n * sizeof(u16));
      } else {
        unsigned char* dst = outs[pl];
        for (i64 i = 0; i < n; i++) dst[i] = (unsigned char)src[i];
      }
    }
  }
  delete ctx;
  return 0;
}
