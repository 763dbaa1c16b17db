// HEVC I-slice CABAC entropy decode + syntax parse (host engine).
//
// A copy of libheif_tpu/native/src/hevc_parse.cc, the JAX package's C++
// parser, which is difftested bin for bin against its Python SliceParser
// and against libde265 decodes.  The PyTorch port has no Python parser:
// this is its only one.  native_parse.py builds it with the system C++
// compiler at first use and calls it through ctypes.
//
// Interface: one C ABI entry point (and its WPP variant), flat buffers,
// caller-allocated numpy arrays.  Context-model layout and initial
// states are computed in Python (tables.py, cabac.py) and passed in.
//
// The port extends the copy to pictures of several slices: one call
// parses one independent slice segment, from its first CTB (params
// P_START_CTB) to its end_of_slice_segment_flag, into the picture's
// shared maps, and claims its CTBs in the slice map (P_SLICE_IDX).  A
// neighbour in another slice is unavailable (spec 6.4.1): is_avail, the
// split_cu_flag contexts and MPM derivation through it, and the SAO merge
// candidates (7.3.8.3).  The caller starts each call from that slice's
// context states, QP and chroma QP offsets.  Under WPP a row's contexts
// come from CTB 1 of the row above only where that CTB is in the same
// segment.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <limits.h>
#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>
#include <vector>
#include <atomic>
#include <thread>

// bin-level trace for difftesting against the Python engine
// (enable with TPUHEIF_TRACE=1; lines go to stderr)
static bool g_trace = getenv("TPUHEIF_TRACE") != nullptr;

namespace {

// ---------------------------------------------------------------- tables

// rangeTabLPS (spec table 9-46)
static const uint8_t kRangeTabLPS[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216},
    {123, 150, 178, 205}, {116, 142, 169, 195}, {111, 135, 160, 185},
    {105, 128, 152, 175}, {100, 122, 144, 166}, {95, 116, 137, 158},
    {90, 110, 130, 150},  {85, 104, 123, 142},  {81, 99, 117, 135},
    {77, 94, 111, 128},   {73, 89, 105, 122},   {69, 85, 100, 116},
    {66, 80, 95, 110},    {62, 76, 90, 104},    {59, 72, 86, 99},
    {56, 69, 81, 94},     {53, 65, 77, 89},     {51, 62, 73, 85},
    {48, 59, 69, 80},     {46, 56, 66, 76},     {43, 53, 63, 72},
    {41, 50, 59, 69},     {39, 48, 56, 65},     {37, 45, 54, 62},
    {35, 43, 51, 59},     {33, 41, 48, 56},     {32, 39, 46, 53},
    {30, 37, 43, 50},     {29, 35, 41, 48},     {27, 33, 39, 45},
    {26, 31, 37, 43},     {24, 30, 35, 41},     {23, 28, 33, 39},
    {22, 27, 32, 37},     {21, 26, 30, 35},     {20, 24, 29, 33},
    {19, 23, 27, 31},     {18, 22, 26, 30},     {17, 21, 25, 28},
    {16, 20, 23, 27},     {15, 19, 22, 25},     {14, 18, 21, 24},
    {14, 17, 20, 23},     {13, 16, 19, 22},     {12, 15, 18, 21},
    {12, 14, 17, 20},     {11, 14, 16, 19},     {11, 13, 15, 18},
    {10, 12, 15, 17},     {10, 12, 14, 16},     {9, 11, 13, 15},
    {9, 11, 12, 14},      {8, 10, 12, 14},      {8, 9, 11, 13},
    {7, 9, 11, 12},       {7, 9, 10, 12},       {7, 8, 10, 11},
    {6, 8, 9, 11},        {6, 7, 9, 10},        {6, 7, 8, 9},
    {2, 2, 2, 2}};

// transIdxLPS (spec table 9-47)
static const uint8_t kTransIdxLPS[64] = {
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15, 15,
    16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26, 26, 27,
    27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33, 33, 33, 34, 34, 35, 35,
    35, 36, 36, 36, 37, 37, 37, 38, 38, 63};

static uint8_t kTransIdxMPS[64];
static bool init_mps_table() {
  for (int i = 0; i < 64; i++) kTransIdxMPS[i] = (i + 1 < 62) ? i + 1 : 62;
  kTransIdxMPS[62] = 62;
  kTransIdxMPS[63] = 63;
  return true;
}
static bool g_mps_init = init_mps_table();

// sig_coeff_flag 4x4 context map (spec 9.3.4.2.5)
static const uint8_t kCtxIdxMap4x4[16] = {0, 1, 4, 5, 2, 3, 4, 5,
                                          6, 6, 8, 8, 7, 7, 8, 8};

// chroma QP mapping (spec table 8-10), qpi in [30, 43]
static const uint8_t kChromaQpMap[44 - 30 + 1] = {
    29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37, 38};

static int chroma_qp(int qpi) {
  if (qpi < 30) return qpi;
  if (qpi > 43) return qpi - 6;
  return kChromaQpMap[qpi - 30];
}

// scan orders (spec 6.5.3; mirrors tables.py diag/horiz/vert_scan)
struct Scan {
  std::vector<uint8_t> x, y;        // position i -> (x, y)
  std::vector<uint8_t> of;          // (y*size+x) -> scan index
};

static Scan make_scan(int kind, int size) {
  Scan s;
  s.x.reserve(size * size);
  s.y.reserve(size * size);
  if (kind == 0) {            // up-right diagonal
    for (int d = 0; d < 2 * size - 1; d++) {
      int x = d - size + 1 > 0 ? d - size + 1 : 0;
      int y = d < size - 1 ? d : size - 1;
      while (x < size && y >= 0) {
        s.x.push_back((uint8_t)x);
        s.y.push_back((uint8_t)y);
        x++;
        y--;
      }
    }
  } else if (kind == 1) {     // horizontal
    for (int y = 0; y < size; y++)
      for (int x = 0; x < size; x++) {
        s.x.push_back((uint8_t)x);
        s.y.push_back((uint8_t)y);
      }
  } else {                    // vertical
    for (int x = 0; x < size; x++)
      for (int y = 0; y < size; y++) {
        s.x.push_back((uint8_t)x);
        s.y.push_back((uint8_t)y);
      }
  }
  s.of.resize(size * size);
  for (size_t i = 0; i < s.x.size(); i++)
    s.of[s.y[i] * size + s.x[i]] = (uint8_t)i;
  return s;
}

// ------------------------------------------------------- context families

enum CtxFamily {
  F_SAO_MERGE = 0,
  F_SAO_TYPE,
  F_SPLIT_CU,
  F_CU_TQB,
  F_PART_MODE,
  F_PREV_INTRA,
  F_INTRA_CHROMA,
  F_SPLIT_TRANSFORM,
  F_CBF_LUMA,
  F_CBF_CHROMA,
  F_CU_QP_DELTA,
  F_TRANSFORM_SKIP,
  F_LAST_X,
  F_LAST_Y,
  F_CODED_SUB_BLOCK,
  F_SIG_COEFF,
  F_GT1,
  F_GT2,
  N_FAMILIES
};

// ----------------------------------------------------------- parameters

enum ParamIdx {
  P_PIC_WIDTH = 0,
  P_PIC_HEIGHT,
  P_LOG2_CTB,
  P_LOG2_MIN_CB,
  P_LOG2_MIN_TB,
  P_LOG2_MAX_TB,
  P_MAX_TRAFO_DEPTH_INTRA,
  P_SAO_ENABLED,
  P_PCM_ENABLED,
  P_TQB_ENABLED,
  P_CU_QP_DELTA_ENABLED,
  P_DIFF_CU_QP_DELTA_DEPTH,
  P_PPS_CB_QP_OFFSET,
  P_PPS_CR_QP_OFFSET,
  P_TRANSFORM_SKIP_ENABLED,
  P_SIGN_DATA_HIDING,
  P_WPP,
  P_SH_QP,
  P_SH_SAO_LUMA,
  P_SH_SAO_CHROMA,
  P_SH_CB_QP_OFFSET,
  P_SH_CR_QP_OFFSET,
  P_N_CTB_COLS,
  P_N_CTB_ROWS,
  P_BIT_DEPTH_LUMA,
  P_BIT_DEPTH_CHROMA,
  P_START_CTB,      // the slice segment's first CTB (raster address)
  P_SLICE_IDX,      // its index in the picture, written to the slice map
  N_PARAMS
};

// --------------------------------------------------------------- engine

struct ParseError {
  int code = 0;               // 1 invalid input, 2 unsupported
  char msg[200] = {0};
};

struct Cabac {
  const uint8_t* data;
  int64_t pos;                // bit position (byte-aligned when assigned)
  int64_t end;                // end byte (exclusive)
  uint32_t range, offset;
  uint64_t cache;             // prefetched bits, next bit at (ncache-1)
  int ncache;
  uint8_t* p_state;
  uint8_t* val_mps;

  // amortized refill: pulls whole bytes (zeros past `end`, matching the
  // spec's read-past-end-as-zero behavior the old per-bit reader had)
  inline void refill() {
    int64_t b = pos >> 3;
    while (ncache <= 48) {
      uint32_t byte = (b < end) ? data[b] : 0;
      cache = (cache << 8) | byte;
      ncache += 8;
      b++;
    }
    pos = b << 3;
  }

  inline uint32_t get_bits(int n) {  // n <= 24
    if (ncache < n) refill();
    ncache -= n;
    return (uint32_t)((cache >> ncache) & ((1u << n) - 1));
  }

  bool init() {               // spec 9.3.4.3.1
    range = 510;
    cache = 0;
    ncache = 0;
    offset = get_bits(9);
    return offset < 510;
  }

  int decode_bin(int ctx_idx) {
    int ps = p_state[ctx_idx];
    uint32_t lps = kRangeTabLPS[ps][(range >> 6) & 3];
    range -= lps;
    int binval;
    if (offset >= range) {
      offset -= range;
      range = lps;
      binval = 1 - val_mps[ctx_idx];
      if (ps == 0) val_mps[ctx_idx] = 1 - val_mps[ctx_idx];
      p_state[ctx_idx] = kTransIdxLPS[ps];
    } else {
      binval = val_mps[ctx_idx];
      p_state[ctx_idx] = kTransIdxMPS[ps];
      if (range >= 256) {     // common case: no renorm needed
        if (g_trace) fprintf(stderr, "B %d %d\n", ctx_idx, binval);
        return binval;
      }
    }
    int sh = __builtin_clz(range) - 23;  // range in [2,255] -> sh in [1,7]
    range <<= sh;
    offset = (offset << sh) | get_bits(sh);
    if (g_trace) fprintf(stderr, "B %d %d\n", ctx_idx, binval);
    return binval;
  }

  int decode_bypass() {
    offset = (offset << 1) | get_bits(1);
    int v = 0;
    if (offset >= range) {
      offset -= range;
      v = 1;
    }
    if (g_trace) fprintf(stderr, "Y %d\n", v);
    return v;
  }

  // n bypass bins at once: bypass decoding is long division of the
  // offset window by `range`, so the n bins are the n quotient bits
  uint32_t decode_bypass_bits(int n) {
    if (g_trace) {            // keep the per-bit trace stream identical
      uint32_t v = 0;
      for (int i = 0; i < n; i++) v = (v << 1) | decode_bypass();
      return v;
    }
    uint32_t v = 0;
    while (n > 0) {
      int c = n > 16 ? 16 : n;
      uint32_t ext = (offset << c) | get_bits(c);
      uint32_t q = ext / range;       // < 2^c since offset < range
      offset = ext - q * range;
      v = (v << c) | q;
      n -= c;
    }
    return v;
  }

  int decode_terminate() {
    range -= 2;
    if (offset >= range) return 1;
    if (range < 256) {
      int sh = __builtin_clz(range) - 23;
      range <<= sh;
      offset = (offset << sh) | get_bits(sh);
    }
    return 0;
  }

  int decode_tu_bypass(int c_max) {
    int v = 0;
    while (v < c_max && decode_bypass()) v++;
    return v;
  }

  int decode_eg_bypass(int k, ParseError* err) {
    int leading = 0;
    while (decode_bypass()) {
      leading++;
      if (leading > 32) {
        err->code = 1;
        snprintf(err->msg, sizeof(err->msg), "EGk runaway");
        return 0;
      }
    }
    uint32_t value = ((1u << leading) - 1) << k;
    value += decode_bypass_bits(leading + k);
    return (int)value;
  }
};
// cross-row wavefront synchronization for WPP-parallel entropy decode
// (spec 6.3.2 / libde265 thread-task analogue): worker parsing CTB
// (r, c) waits until row r-1 completed column min(c+2, n_cols) — that
// covers the above/above-right neighbor context AND the post-CTB-1
// CABAC context snapshot each row inherits (spec 9.3.1).
struct WppSync {
  std::vector<uint32_t> col_done;                 // per row, futex words
  std::vector<std::vector<uint8_t>> snap_p, snap_m;  // per-row ctx
  std::atomic<int> stop_flag{0};

  void init(int n_rows) {
    col_done.assign(n_rows, 0);
    snap_p.resize(n_rows);
    snap_m.resize(n_rows);
  }
  void set_col(int row, int c) {
    __atomic_store_n(&col_done[row], (uint32_t)c, __ATOMIC_RELEASE);
    syscall(SYS_futex, &col_done[row], FUTEX_WAKE, INT_MAX, nullptr,
            nullptr, 0);
  }
  bool wait_col(int row, uint32_t need) {
    for (;;) {
      uint32_t v = __atomic_load_n(&col_done[row], __ATOMIC_ACQUIRE);
      if (v >= need) return true;
      if (stop_flag.load(std::memory_order_relaxed)) return false;
      struct timespec ts {0, 2000000};   // bounded so aborts are seen
      syscall(SYS_futex, &col_done[row], FUTEX_WAIT, v, &ts, nullptr, 0);
    }
  }
  void stop() {
    stop_flag.store(1);
    for (size_t r = 0; r < col_done.size(); r++)
      syscall(SYS_futex, &col_done[r], FUTEX_WAKE, INT_MAX, nullptr,
              nullptr, 0);
  }
};

struct Parser {
  // config
  int32_t P[N_PARAMS];
  const int32_t* fam;         // context family base offsets
  const uint8_t* init_p_state;
  const uint8_t* init_val_mps;
  int32_t n_ctx;
  const uint8_t* rbsp;
  int64_t rbsp_len;
  const int64_t* substreams;  // pairs
  int32_t n_sub;

  // outputs
  uint8_t *intra_mode_y, *intra_mode_c, *ct_depth, *cu_log2_map,
      *tu_log2_map, *tqb_map, *nonzero_y, *avail;
  int16_t* qp_y;
  int16_t* slice_map = nullptr;   // slice index per 4x4 (null: one slice)
  int64_t last_ctb = -1;          // the slice segment's last CTB
  int32_t w4, h4;
  int32_t* tu_meta;           // 10 int32 per TU
  int64_t tu_cap;
  int32_t* coeff_buf;
  int64_t coeff_cap;
  // appended-range limits; equal to the caps in serial mode, a
  // worker-private segment end under WPP-parallel parse
  int64_t tu_limit = -1;
  int64_t coeff_limit = -1;
  int16_t* sao_buf;           // 20 int16 per CTB
  int64_t n_tus = 0;
  int64_t n_coeff = 0;

  // state
  std::vector<uint8_t> p_state, val_mps, saved_p, saved_m;
  bool have_saved = false;
  Cabac dec;
  ParseError err;

  int qp_prev, qg_pred;
  bool pending_qp_reset = false;
  int qg_serial = -1;
  int64_t qg_ox = -1, qg_oy = -1;
  int cu_qp_delta = 0;
  bool qp_delta_coded = false;
  int log2_min_qg;
  bool cur_tqb = false;

  // per-CU state
  int cu_luma_modes[4];
  int cu_chroma_mode;
  bool cu_part_nxn;
  int cu_x0, cu_y0, cu_log2v;
  int max_trafo_depth;

  Scan scans4[3];             // 4x4 position scans
  Scan sb_scans[3][4];        // [kind][log2(n_sb)] n_sb in {1,2,4,8}

  // ---------------------------------------------------------------- util

  void fail(int code, const char* m) {
    if (!err.code) {
      err.code = code;
      snprintf(err.msg, sizeof(err.msg), "%s", m);
    }
  }

  bool inside_pic(int x, int y) const {
    return x >= 0 && x < P[P_PIC_WIDTH] && y >= 0 && y < P[P_PIC_HEIGHT];
  }

  bool is_avail(int x, int y) const {
    if (!inside_pic(x, y)) return false;
    const int64_t i = (int64_t)(y >> 2) * w4 + (x >> 2);
    return avail[i] != 0 && (!slice_map || slice_map[i] == P[P_SLICE_IDX]);
  }

  // CTB (cx, cy) belongs to this slice (its CTBs are claimed before they
  // are parsed, so an earlier CTB of the slice is claimed too)
  bool same_slice_ctb(int cx, int cy) const {
    if (!slice_map) return true;
    const int c4 = 1 << (P[P_LOG2_CTB] - 2);
    return slice_map[(int64_t)cy * c4 * w4 + (int64_t)cx * c4] ==
           P[P_SLICE_IDX];
  }

  void claim_ctb(int cx, int cy) {
    if (!slice_map) return;
    const int c4 = 1 << (P[P_LOG2_CTB] - 2);
    fill_map<int16_t>(slice_map, cx * c4, cy * c4, c4, c4,
                      (int16_t)P[P_SLICE_IDX]);
  }

  int ctx(int family, int inc = 0) const { return fam[family] + inc; }

  template <typename T>
  void fill_map(T* map, int bx, int by, int nbx, int nby, T v) {
    for (int yy = by; yy < by + nby; yy++)
      for (int xx = bx; xx < bx + nbx; xx++)
        map[(int64_t)yy * w4 + xx] = v;
  }

  // ------------------------------------------------------------- TU emit

  void emit_tu(int x, int y, int log2, int c_idx, int pred_mode,
               int transform_skip, int32_t* coeffs /* size*size or null */) {
    if (n_tus >= tu_limit) {
      fail(1, "TU buffer overflow");
      return;
    }
    int32_t* m = tu_meta + n_tus * 10;
    m[0] = x;
    m[1] = y;
    m[2] = log2;
    m[3] = c_idx;
    m[4] = pred_mode;
    m[5] = 0;                 // qp — assigned below or per-CU
    m[6] = qg_serial;
    m[7] = transform_skip;
    m[8] = cur_tqb ? 1 : 0;
    m[9] = -1;
    if (!P[P_CU_QP_DELTA_ENABLED])
      assign_tu_qp(n_tus, P[P_SH_QP]);
    if (coeffs) {
      int64_t n = (int64_t)1 << (2 * log2);
      if (n_coeff + n > coeff_limit) {
        fail(1, "coeff buffer overflow");
        return;
      }
      memcpy(coeff_buf + n_coeff, coeffs, n * sizeof(int32_t));
      m[9] = (int32_t)n_coeff;
      n_coeff += n;
    }
    n_tus++;
  }

  // WPP-parallel worker configuration (run_wpp_worker)
  WppSync* wpp = nullptr;
  int wpp_first_row = 0, wpp_row_stride = 1;
  int64_t* wpp_row_tu_start = nullptr;   // per-row [start, end) spans
  int64_t* wpp_row_tu_end = nullptr;


  // one WPP wavefront worker: parses rows wpp_first_row, +stride, ...
  // Bit-exact with run(): same per-row CABAC inheritance (post-CTB-1
  // snapshot of the row above), same qp-chain reset, same terminate
  // handling; cross-row neighbor state is ordered by WppSync.
  int run_wpp_worker() {
    log2_min_qg = P[P_LOG2_CTB] - P[P_DIFF_CU_QP_DELTA_DEPTH];
    qp_prev = P[P_SH_QP];
    qg_pred = P[P_SH_QP];
    for (int k = 0; k < 3; k++) {
      scans4[k] = make_scan(k, 4);
      for (int l = 0; l < 4; l++) sb_scans[k][l] = make_scan(k, 1 << l);
    }
    int ctb = 1 << P[P_LOG2_CTB];
    int n_cols = P[P_N_CTB_COLS];
    int n_rows = P[P_N_CTB_ROWS];
    dec.data = rbsp;
    for (int row = wpp_first_row; row < n_rows; row += wpp_row_stride) {
      if (row >= n_sub) {
        fail(1, "missing WPP entry point");
        break;
      }
      if (row == 0) {
        p_state.assign(init_p_state, init_p_state + n_ctx);
        val_mps.assign(init_val_mps, init_val_mps + n_ctx);
      } else {
        // ctx inheritance needs row-1 past CTB 1 (spec 9.3.1); with a
        // single column there is no saved snapshot — fresh init
        uint32_t need = n_cols > 1 ? 2u : 1u;
        if (!wpp->wait_col(row - 1, need)) {
          fail(1, "WPP worker aborted");
          break;
        }
        if (n_cols > 1) {
          p_state = wpp->snap_p[row - 1];
          val_mps = wpp->snap_m[row - 1];
        } else {
          p_state.assign(init_p_state, init_p_state + n_ctx);
          val_mps.assign(init_val_mps, init_val_mps + n_ctx);
        }
        pending_qp_reset = true;
      }
      dec.pos = substreams[2 * row] * 8;
      dec.end = substreams[2 * row + 1];
      dec.p_state = p_state.data();
      dec.val_mps = val_mps.data();
      if (!dec.init()) {
        fail(1, "CABAC init offset invalid");
        break;
      }
      wpp_row_tu_start[row] = n_tus;
      for (int col = 0; col < n_cols; col++) {
        if (row > 0) {
          uint32_t need = (uint32_t)(col + 2 < n_cols ? col + 2 : n_cols);
          if (!wpp->wait_col(row - 1, need)) {
            fail(1, "WPP worker aborted");
            break;
          }
        }
        int x0 = col * ctb, y0 = row * ctb;
        if (P[P_SAO_ENABLED] && (P[P_SH_SAO_LUMA] || P[P_SH_SAO_CHROMA]))
          parse_sao(col, row);
        coding_quadtree(x0, y0, P[P_LOG2_CTB], 0);
        if (err.code) break;
        if (col == 1 && n_cols > 1) {
          wpp->snap_p[row] = p_state;
          wpp->snap_m[row] = val_mps;
        }
        int end = dec.decode_terminate();
        bool is_last = (row == n_rows - 1 && col == n_cols - 1);
        if (end && !is_last) {
          fail(1, "premature end_of_slice");
          break;
        }
        wpp->set_col(row, col + 1);
      }
      wpp_row_tu_end[row] = n_tus;
      if (err.code) break;
    }
    if (err.code) wpp->stop();
    return err.code;
  }

  // pipeline progress: when set, the cumulative TU count is published
  // after each finished CTB row so a concurrent reconstructor can
  // stream rows (release store pairs with the consumer's acquire load)
  int64_t* row_counts = nullptr;
  int64_t* rows_done = nullptr;
  int published_rows = 0;

  void publish_row(int row) {
    if (!row_counts) return;
    row_counts[row] = n_tus;
    published_rows = row + 1;
    __atomic_store_n(rows_done, (int64_t)(row + 1), __ATOMIC_RELEASE);
    // wake the streaming consumer (futex word = low 32 bits, LE)
    syscall(SYS_futex, (uint32_t*)rows_done, FUTEX_WAKE, INT_MAX,
            nullptr, nullptr, 0);
  }

  // variant for coefficients already decoded in place at coeff_buf +
  // n_coeff (skips the scratch copy)
  void emit_tu_inplace(int x, int y, int log2, int c_idx, int pred_mode,
                       int transform_skip, int64_t n_vals) {
    if (n_tus >= tu_limit) {
      fail(1, "TU buffer overflow");
      return;
    }
    int32_t* m = tu_meta + n_tus * 10;
    m[0] = x;
    m[1] = y;
    m[2] = log2;
    m[3] = c_idx;
    m[4] = pred_mode;
    m[5] = 0;
    m[6] = qg_serial;
    m[7] = transform_skip;
    m[8] = cur_tqb ? 1 : 0;
    m[9] = (int32_t)n_coeff;
    n_coeff += n_vals;
    if (!P[P_CU_QP_DELTA_ENABLED])
      assign_tu_qp(n_tus, P[P_SH_QP]);
    n_tus++;
  }

  void assign_tu_qp(int64_t tu_idx, int qp_y_val) {
    // m[5] carries the dequant qP' incl. the bit-depth offset
    // (spec 8.6.1: qP = Qp + QpBdOffset); qp_y_val stays QpY
    int32_t* m = tu_meta + tu_idx * 10;
    int c_idx = m[3];
    if (c_idx == 0) {
      m[5] = qp_y_val + 6 * (P[P_BIT_DEPTH_LUMA] - 8);
    } else {
      int off = (c_idx == 1)
                    ? P[P_PPS_CB_QP_OFFSET] + P[P_SH_CB_QP_OFFSET]
                    : P[P_PPS_CR_QP_OFFSET] + P[P_SH_CR_QP_OFFSET];
      int bd_off_c = 6 * (P[P_BIT_DEPTH_CHROMA] - 8);
      int qpi = qp_y_val + off;
      if (qpi < -bd_off_c) qpi = -bd_off_c;
      if (qpi > 57) qpi = 57;
      m[5] = chroma_qp(qpi) + bd_off_c;
    }
  }

  // ----------------------------------------------------------------- SAO

  void parse_sao(int cx, int cy) {
    int n_cols = P[P_N_CTB_COLS];
    int16_t* me = sao_buf + ((int64_t)cy * n_cols + cx) * 20;
    memset(me, 0, 20 * sizeof(int16_t));
    bool merge = false;
    if (cx > 0 && same_slice_ctb(cx - 1, cy)) {
      if (dec.decode_bin(ctx(F_SAO_MERGE))) {
        memcpy(me, sao_buf + ((int64_t)cy * n_cols + cx - 1) * 20,
               20 * sizeof(int16_t));
        merge = true;
      }
    }
    if (!merge && cy > 0 && same_slice_ctb(cx, cy - 1)) {
      if (dec.decode_bin(ctx(F_SAO_MERGE))) {
        memcpy(me, sao_buf + ((int64_t)(cy - 1) * n_cols + cx) * 20,
               20 * sizeof(int16_t));
        merge = true;
      }
    }
    if (merge) return;

    int16_t* type_idx = me;           // [3]
    int16_t* offsets = me + 3;        // [3][4]
    int16_t* band_pos = me + 15;      // [3]
    int16_t* eo_class = me + 18;      // [2]
    int n_comp = P[P_SH_SAO_CHROMA] ? 3 : 1;
    for (int c_idx = 0; c_idx < n_comp; c_idx++) {
      if (c_idx == 0 && !P[P_SH_SAO_LUMA]) continue;
      // offset cMax/scale follow the component bit depth (spec 7.4.9.3:
      // cMax = (1 << (Min(bd,10) - 5)) - 1, saoShift = bd - Min(bd,10))
      int bd = (c_idx == 0) ? P[P_BIT_DEPTH_LUMA] : P[P_BIT_DEPTH_CHROMA];
      int off_max = (1 << ((bd < 10 ? bd : 10) - 5)) - 1;
      int bd_shift = bd > 10 ? bd - 10 : 0;
      if (c_idx == 2) {
        type_idx[2] = type_idx[1];
      } else if (!dec.decode_bin(ctx(F_SAO_TYPE))) {
        type_idx[c_idx] = 0;
      } else {
        type_idx[c_idx] = dec.decode_bypass() ? 2 : 1;
      }
      if (type_idx[c_idx] == 0) continue;
      int offs[4];
      for (int i = 0; i < 4; i++) offs[i] = dec.decode_tu_bypass(off_max);
      if (type_idx[c_idx] == 1) {  // band
        for (int i = 0; i < 4; i++)
          if (offs[i] && dec.decode_bypass()) offs[i] = -offs[i];
        band_pos[c_idx] = (int16_t)dec.decode_bypass_bits(5);
      } else {                     // edge
        offs[2] = -offs[2];
        offs[3] = -offs[3];
        if (c_idx == 0)
          eo_class[0] = (int16_t)dec.decode_bypass_bits(2);
        else if (c_idx == 1)
          eo_class[1] = (int16_t)dec.decode_bypass_bits(2);
      }
      for (int i = 0; i < 4; i++)
        offsets[c_idx * 4 + i] = (int16_t)(offs[i] << bd_shift);
    }
  }

  // ----------------------------------------------------------- QP groups

  void start_qg(int x0, int y0) {
    if (x0 == qg_ox && y0 == qg_oy) return;
    if (pending_qp_reset) {
      qp_prev = P[P_SH_QP];
      pending_qp_reset = false;
    }
    qg_ox = x0;
    qg_oy = y0;
    qg_serial++;
    cu_qp_delta = 0;
    qp_delta_coded = false;
    qg_pred = qp_pred(x0, y0);
  }

  int qp_pred(int xq, int yq) {
    int ctb_mask = ~((1 << P[P_LOG2_CTB]) - 1);
    int qp_a = -1000, qp_b = -1000;
    if (xq - 1 >= 0 && ((xq - 1) & ctb_mask) == (xq & ctb_mask) &&
        avail[(int64_t)(yq >> 2) * w4 + ((xq - 1) >> 2)])
      qp_a = qp_y[(int64_t)(yq >> 2) * w4 + ((xq - 1) >> 2)];
    if (qp_a == -1000) qp_a = qp_prev;
    if (yq - 1 >= 0 && (((yq - 1) >> 2) >= 0) &&
        (((yq - 1) & ctb_mask) == (yq & ctb_mask)) &&
        avail[(int64_t)((yq - 1) >> 2) * w4 + (xq >> 2)])
      qp_b = qp_y[(int64_t)((yq - 1) >> 2) * w4 + (xq >> 2)];
    if (qp_b == -1000) qp_b = qp_prev;
    return (qp_a + qp_b + 1) >> 1;
  }

  // ------------------------------------------------------------ quadtree

  void coding_quadtree(int x0, int y0, int log2, int depth) {
    if (err.code) return;
    int size = 1 << log2;
    if (P[P_CU_QP_DELTA_ENABLED] && log2 >= log2_min_qg) start_qg(x0, y0);

    bool inside = (x0 + size <= P[P_PIC_WIDTH] &&
                   y0 + size <= P[P_PIC_HEIGHT]);
    int split;
    if (inside && log2 > P[P_LOG2_MIN_CB]) {
      int ctx_inc = 0;
      if (is_avail(x0 - 1, y0) &&
          ct_depth[(int64_t)(y0 >> 2) * w4 + ((x0 - 1) >> 2)] > depth)
        ctx_inc++;
      if (is_avail(x0, y0 - 1) &&
          ct_depth[(int64_t)((y0 - 1) >> 2) * w4 + (x0 >> 2)] > depth)
        ctx_inc++;
      split = dec.decode_bin(ctx(F_SPLIT_CU, ctx_inc));
    } else {
      split = log2 > P[P_LOG2_MIN_CB] ? 1 : 0;
    }

    if (split) {
      int half = size >> 1;
      static const int dxy[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
      for (int i = 0; i < 4; i++) {
        int x1 = x0 + dxy[i][0] * half, y1 = y0 + dxy[i][1] * half;
        if (x1 < P[P_PIC_WIDTH] && y1 < P[P_PIC_HEIGHT])
          coding_quadtree(x1, y1, log2 - 1, depth + 1);
        if (err.code) return;
      }
    } else {
      coding_unit(x0, y0, log2, depth);
    }
  }

  // --------------------------------------------------------- intra modes

  int derive_intra_mode(int px, int py, int prev_flag, int value) {
    int cand_a = 1, cand_b = 1;  // INTRA_DC
    if (is_avail(px - 1, py))
      cand_a = intra_mode_y[(int64_t)(py >> 2) * w4 + ((px - 1) >> 2)];
    if (is_avail(px, py - 1) &&
        ((py - 1) >> P[P_LOG2_CTB]) == (py >> P[P_LOG2_CTB]))
      cand_b = intra_mode_y[(int64_t)((py - 1) >> 2) * w4 + (px >> 2)];

    int mpm[3];
    if (cand_a == cand_b) {
      if (cand_a < 2) {
        mpm[0] = 0;   // planar
        mpm[1] = 1;   // dc
        mpm[2] = 26;  // angular26
      } else {
        mpm[0] = cand_a;
        mpm[1] = 2 + ((cand_a + 29) % 32);
        mpm[2] = 2 + ((cand_a - 2 + 1) % 32);
      }
    } else {
      mpm[0] = cand_a;
      mpm[1] = cand_b;
      if (cand_a != 0 && cand_b != 0)
        mpm[2] = 0;
      else if (cand_a != 1 && cand_b != 1)
        mpm[2] = 1;
      else
        mpm[2] = 26;
    }

    if (prev_flag) return mpm[value];
    int s0 = mpm[0], s1 = mpm[1], s2 = mpm[2], t;
    if (s0 > s1) { t = s0; s0 = s1; s1 = t; }
    if (s1 > s2) { t = s1; s1 = s2; s2 = t; }
    if (s0 > s1) { t = s0; s0 = s1; s1 = t; }
    int mode = value;
    if (mode >= s0) mode++;
    if (mode >= s1) mode++;
    if (mode >= s2) mode++;
    return mode;
  }

  // ---------------------------------------------------------- coding unit

  void coding_unit(int x0, int y0, int log2, int depth) {
    int size = 1 << log2;
    int bx0 = x0 >> 2, by0 = y0 >> 2, nb = size >> 2;

    cur_tqb = false;
    if (P[P_TQB_ENABLED])
      cur_tqb = dec.decode_bin(ctx(F_CU_TQB)) != 0;

    bool part_nxn = false;
    if (log2 == P[P_LOG2_MIN_CB])
      part_nxn = !dec.decode_bin(ctx(F_PART_MODE));

    if (P[P_PCM_ENABLED] && !part_nxn) {
      // pcm size range check is passed pre-resolved via params? the
      // Python parser checks log2 within [min_pcm, max_pcm]; PCM
      // streams are rejected either way, so gate on the flag + range
      // fields packed into P_PCM_ENABLED by the caller:
      // P_PCM_ENABLED = 1 + (min_pcm << 8) + (max_pcm << 16)
      int min_pcm = (P[P_PCM_ENABLED] >> 8) & 0xff;
      int max_pcm = (P[P_PCM_ENABLED] >> 16) & 0xff;
      if (log2 >= min_pcm && log2 <= max_pcm) {
        if (dec.decode_terminate()) {
          fail(2, "PCM coding units");
          return;
        }
      }
    }

    int n_parts = part_nxn ? 4 : 1;
    int half = size >> 1;
    int part_pos[4][2] = {{x0, y0}, {x0 + half, y0},
                          {x0, y0 + half}, {x0 + half, y0 + half}};

    int prev_flags[4], mpm_or_rem[4];
    for (int i = 0; i < n_parts; i++)
      prev_flags[i] = dec.decode_bin(ctx(F_PREV_INTRA));
    for (int i = 0; i < n_parts; i++) {
      if (prev_flags[i])
        mpm_or_rem[i] = dec.decode_tu_bypass(2);
      else
        mpm_or_rem[i] = (int)dec.decode_bypass_bits(5);
    }

    for (int i = 0; i < n_parts; i++) {
      int px = part_pos[i][0], py = part_pos[i][1];
      int mode = derive_intra_mode(px, py, prev_flags[i], mpm_or_rem[i]);
      cu_luma_modes[i] = mode;
      int pb = (1 << (log2 - (part_nxn ? 1 : 0))) >> 2;
      if (pb < 1) pb = 1;
      fill_map<uint8_t>(intra_mode_y, px >> 2, py >> 2, pb, pb,
                        (uint8_t)mode);
      fill_map<uint8_t>(avail, px >> 2, py >> 2, pb, pb, 1);
    }

    int chroma_mode;
    if (dec.decode_bin(ctx(F_INTRA_CHROMA))) {
      int idx = (int)dec.decode_bypass_bits(2);
      static const int cand[4] = {0, 26, 10, 1};
      chroma_mode = cand[idx];
      if (chroma_mode == cu_luma_modes[0]) chroma_mode = 34;
    } else {
      chroma_mode = cu_luma_modes[0];
    }
    cu_chroma_mode = chroma_mode;
    fill_map<uint8_t>(intra_mode_c, bx0, by0, nb, nb, (uint8_t)chroma_mode);

    fill_map<uint8_t>(ct_depth, bx0, by0, nb, nb, (uint8_t)depth);
    fill_map<uint8_t>(cu_log2_map, bx0, by0, nb, nb, (uint8_t)log2);
    fill_map<uint8_t>(tqb_map, bx0, by0, nb, nb, (uint8_t)(cur_tqb ? 1 : 0));

    max_trafo_depth = P[P_MAX_TRAFO_DEPTH_INTRA] + (part_nxn ? 1 : 0);
    cu_part_nxn = part_nxn;
    cu_x0 = x0;
    cu_y0 = y0;
    cu_log2v = log2;
    int64_t cu_tu_start = n_tus;
    transform_tree(x0, y0, x0, y0, log2, 0, 0, true, true);
    if (err.code) return;

    if (P[P_CU_QP_DELTA_ENABLED]) {
      int qbd = 6 * (P[P_BIT_DEPTH_LUMA] - 8);
      int n = 52 + qbd;
      int qp_cu = (((qg_pred + cu_qp_delta + 52 + 2 * qbd) % n + n) % n)
                  - qbd;
      fill_map<int16_t>(qp_y, bx0, by0, nb, nb, (int16_t)qp_cu);
      for (int64_t t = cu_tu_start; t < n_tus; t++) assign_tu_qp(t, qp_cu);
      qp_prev = qp_cu;
    }
    fill_map<uint8_t>(avail, bx0, by0, nb, nb, 1);
  }

  int luma_mode_at(int x, int y) const {
    if (!cu_part_nxn) return cu_luma_modes[0];
    int half = 1 << (cu_log2v - 1);
    int idx = ((x - cu_x0) >= half ? 1 : 0) + ((y - cu_y0) >= half ? 2 : 0);
    return cu_luma_modes[idx];
  }

  void record_pred_only(int x, int y, int log2, int c_idx, int mode) {
    emit_tu(x, y, log2, c_idx, mode, 0, nullptr);
  }

  // ------------------------------------------------------- transform tree

  void transform_tree(int x0, int y0, int x_base, int y_base, int log2,
                      int depth, int blk_idx, bool parent_cbf_cb,
                      bool parent_cbf_cr) {
    if (err.code) return;
    bool intra_split = cu_part_nxn;
    int split;
    if (log2 > P[P_LOG2_MAX_TB])
      split = 1;
    else if (intra_split && depth == 0)
      split = 1;
    else if (log2 == P[P_LOG2_MIN_TB] || depth >= max_trafo_depth)
      split = 0;
    else
      split = dec.decode_bin(ctx(F_SPLIT_TRANSFORM, 5 - log2));

    bool cbf_cb = parent_cbf_cb, cbf_cr = parent_cbf_cr;
    if (log2 > 2) {
      if (depth == 0 || parent_cbf_cb)
        cbf_cb = dec.decode_bin(ctx(F_CBF_CHROMA, depth)) != 0;
      else
        cbf_cb = false;
      if (depth == 0 || parent_cbf_cr)
        cbf_cr = dec.decode_bin(ctx(F_CBF_CHROMA, depth)) != 0;
      else
        cbf_cr = false;
    }

    if (split) {
      int half = 1 << (log2 - 1);
      transform_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0, cbf_cb, cbf_cr);
      transform_tree(x0 + half, y0, x0, y0, log2 - 1, depth + 1, 1, cbf_cb,
                     cbf_cr);
      transform_tree(x0, y0 + half, x0, y0, log2 - 1, depth + 1, 2, cbf_cb,
                     cbf_cr);
      transform_tree(x0 + half, y0 + half, x0, y0, log2 - 1, depth + 1, 3,
                     cbf_cb, cbf_cr);
      return;
    }

    bool cbf_luma =
        dec.decode_bin(ctx(F_CBF_LUMA, depth == 0 ? 1 : 0)) != 0;

    int nb = (1 << log2) >> 2;
    if (nb < 1) nb = 1;
    fill_map<uint8_t>(tu_log2_map, x0 >> 2, y0 >> 2, nb, nb, (uint8_t)log2);
    if (cbf_luma)
      fill_map<uint8_t>(nonzero_y, x0 >> 2, y0 >> 2, nb, nb, 1);

    transform_unit(x0, y0, x_base, y_base, log2, depth, blk_idx, cbf_luma,
                   cbf_cb, cbf_cr);
    if (err.code) return;

    if (!cbf_luma)
      record_pred_only(x0, y0, log2, 0, luma_mode_at(x0, y0));
    bool chroma_here = (log2 > 2) || blk_idx == 3;
    if (chroma_here) {
      int cx = log2 > 2 ? x0 : x_base;
      int cy = log2 > 2 ? y0 : y_base;
      int clog2 = log2 > 2 ? log2 - 1 : 2;
      if (!(cbf_cb && chroma_here))
        record_pred_only(cx, cy, clog2, 1, cu_chroma_mode);
      if (!(cbf_cr && chroma_here))
        record_pred_only(cx, cy, clog2, 2, cu_chroma_mode);
    }
  }

  void transform_unit(int x0, int y0, int x_base, int y_base, int log2,
                      int depth, int blk_idx, bool cbf_luma, bool cbf_cb,
                      bool cbf_cr) {
    bool chroma_here = (log2 > 2) || blk_idx == 3;
    bool cb = cbf_cb && chroma_here;
    bool cr = cbf_cr && chroma_here;

    if (cbf_luma || cbf_cb || cbf_cr) {
      if (P[P_CU_QP_DELTA_ENABLED] && !qp_delta_coded) {
        int prefix = 0;
        if (dec.decode_bin(ctx(F_CU_QP_DELTA, 0))) {
          prefix = 1;
          while (prefix < 5 && dec.decode_bin(ctx(F_CU_QP_DELTA, 1)))
            prefix++;
        }
        int val = prefix;
        if (prefix == 5) val = 5 + dec.decode_eg_bypass(0, &err);
        if (val && dec.decode_bypass()) val = -val;
        cu_qp_delta = val;
        qp_delta_coded = true;
      }

      if (cbf_luma) residual(x0, y0, log2, 0, luma_mode_at(x0, y0));
      if (log2 > 2) {
        if (cb) residual(x0, y0, log2 - 1, 1, cu_chroma_mode);
        if (cr) residual(x0, y0, log2 - 1, 2, cu_chroma_mode);
      } else if (blk_idx == 3) {
        if (cb) residual(x_base, y_base, 2, 1, cu_chroma_mode);
        if (cr) residual(x_base, y_base, 2, 2, cu_chroma_mode);
      }
    }
  }

  // -------------------------------------------------------- residual

  // sig-coeff ctx pattern by csbf-neighbor state `prev`, indexed yp*4+xp
  // (spec 9.3.4.2.5 condensed to tables)
  static constexpr uint8_t kSigPat[4][16] = {
      {2, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0},
      {2, 2, 2, 2, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0},
      {2, 1, 0, 0, 2, 1, 0, 0, 2, 1, 0, 0, 2, 1, 0, 0},
      {2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2},
  };

  int sig_ctx(int xc, int yc, int log2, int c_idx, int scan_idx, int sx,
              int sy, const uint8_t* csbf, int n_sb) {
    int s;
    if (log2 == 2) {
      s = kCtxIdxMap4x4[((yc & 3) << 2) + (xc & 3)];
    } else if (xc + yc == 0) {
      s = 0;
    } else {
      int right = sx + 1 < n_sb ? csbf[sy * n_sb + sx + 1] : 0;
      int below = sy + 1 < n_sb ? csbf[(sy + 1) * n_sb + sx] : 0;
      int prev = right + 2 * below;
      int xp = xc & 3, yp = yc & 3;
      if (prev == 0)
        s = xp + yp == 0 ? 2 : (xp + yp < 3 ? 1 : 0);
      else if (prev == 1)
        s = yp == 0 ? 2 : (yp == 1 ? 1 : 0);
      else if (prev == 2)
        s = xp == 0 ? 2 : (xp == 1 ? 1 : 0);
      else
        s = 2;
      if (c_idx == 0) {
        if (sx != 0 || sy != 0) s += 3;
        s += (log2 == 3) ? (scan_idx == 0 ? 9 : 15) : 21;
      } else {
        s += (log2 == 3) ? 9 : 12;
      }
    }
    return s + (c_idx ? 27 : 0);
  }

  void residual(int x0, int y0, int log2, int c_idx, int pred_mode) {
    if (err.code) return;
    int size = 1 << log2;

    int transform_skip = 0;
    if (P[P_TRANSFORM_SKIP_ENABLED] && !cur_tqb && log2 == 2)
      transform_skip =
          dec.decode_bin(ctx(F_TRANSFORM_SKIP, c_idx == 0 ? 0 : 1));

    int scan_idx = 0;
    if ((c_idx == 0 && (log2 == 2 || log2 == 3)) ||
        (c_idx > 0 && log2 == 2)) {
      if (pred_mode >= 6 && pred_mode <= 14)
        scan_idx = 2;
      else if (pred_mode >= 22 && pred_mode <= 30)
        scan_idx = 1;
    }

    // last significant coefficient position
    int c_max = (log2 << 1) - 1;
    int offset, shift;
    if (c_idx == 0) {
      offset = 3 * (log2 - 2) + ((log2 - 1) >> 2);
      shift = (log2 + 1) >> 2;
    } else {
      offset = 15;
      shift = log2 - 2;
    }
    int px = 0;
    while (px < c_max &&
           dec.decode_bin(ctx(F_LAST_X, offset + (px >> shift))))
      px++;
    int py = 0;
    while (py < c_max &&
           dec.decode_bin(ctx(F_LAST_Y, offset + (py >> shift))))
      py++;

    int last_x, last_y;
    if (px > 3) {
      int nbits = (px >> 1) - 1;
      last_x = ((2 + (px & 1)) << nbits) + (int)dec.decode_bypass_bits(nbits);
    } else {
      last_x = px;
    }
    if (py > 3) {
      int nbits = (py >> 1) - 1;
      last_y = ((2 + (py & 1)) << nbits) + (int)dec.decode_bypass_bits(nbits);
    } else {
      last_y = py;
    }
    if (scan_idx == 2) {
      int t = last_x;
      last_x = last_y;
      last_y = t;
    }
    if (last_x >= size || last_y >= size) {
      fail(1, "last significant coefficient out of range");
      return;
    }

    int n_sb = size >> 2;
    int sb_log = n_sb == 1 ? 0 : (n_sb == 2 ? 1 : (n_sb == 4 ? 2 : 3));
    const Scan& sbs = sb_scans[scan_idx][sb_log];
    const Scan& pos = scans4[scan_idx];

    int last_sb = sbs.of[(last_y >> 2) * n_sb + (last_x >> 2)];
    int last_pos = pos.of[(last_y & 3) * 4 + (last_x & 3)];

    // decode directly into the shared coefficient stream (no scratch
    // copy); emit_tu_inplace records the offset afterwards
    int64_t n_coeff_vals = (int64_t)size * size;
    if (n_coeff + n_coeff_vals > coeff_limit) {
      fail(1, "coeff buffer overflow");
      return;
    }
    int32_t* coeffs = coeff_buf + n_coeff;
    memset(coeffs, 0, sizeof(int32_t) * size * size);
    uint8_t csbf[8 * 8] = {0};
    csbf[(last_y >> 2) * n_sb + (last_x >> 2)] = 1;
    csbf[0] = 1;

    bool prev_sb_gt1 = false;
    int sig_pos[16];
    int gt1_n[16];
    int gt1_flag[16];

    for (int i = last_sb; i >= 0; i--) {
      int sx = sbs.x[i], sy = sbs.y[i];
      bool explicit_csbf = false;
      bool sb_coded;
      if (i == last_sb || i == 0) {
        sb_coded = true;
      } else {
        int right = sx + 1 < n_sb ? csbf[sy * n_sb + sx + 1] : 0;
        int below = sy + 1 < n_sb ? csbf[(sy + 1) * n_sb + sx] : 0;
        int ctx_inc = ((right | below) ? 1 : 0) + (c_idx ? 2 : 0);
        sb_coded = dec.decode_bin(ctx(F_CODED_SUB_BLOCK, ctx_inc)) != 0;
        csbf[sy * n_sb + sx] = sb_coded ? 1 : 0;
        explicit_csbf = true;
      }
      if (!sb_coded) continue;

      // hoist the sig-coeff ctx derivation: within one subblock it only
      // depends on (xp, yp), so precompute all 16 entries once
      int cadd = c_idx ? 27 : 0;
      uint8_t sctx[16];
      if (log2 == 2) {
        for (int t = 0; t < 16; t++)
          sctx[t] = (uint8_t)(kCtxIdxMap4x4[t] + cadd);
      } else {
        int right = sx + 1 < n_sb ? csbf[sy * n_sb + sx + 1] : 0;
        int below = sy + 1 < n_sb ? csbf[(sy + 1) * n_sb + sx] : 0;
        int prev = right + 2 * below;
        int add = (c_idx == 0)
                      ? (((sx | sy) ? 3 : 0) +
                         (log2 == 3 ? (scan_idx == 0 ? 9 : 15) : 21))
                      : (log2 == 3 ? 9 : 12);
        for (int t = 0; t < 16; t++)
          sctx[t] = (uint8_t)(kSigPat[prev][t] + add + cadd);
        if (sx == 0 && sy == 0) sctx[0] = (uint8_t)cadd;  // DC special case
      }
      int sig_base = ctx(F_SIG_COEFF, 0);

      bool infer_dc = explicit_csbf;
      int start_n = (i == last_sb) ? last_pos - 1 : 15;
      int n_sig = 0;
      if (i == last_sb) sig_pos[n_sig++] = last_pos;
      for (int n = start_n; n >= 0; n--) {
        int sig;
        if (n == 0 && infer_dc && n_sig == 0) {
          sig = 1;
        } else {
          int qx = pos.x[n], qy = pos.y[n];
          sig = dec.decode_bin(sig_base + sctx[(qy << 2) + qx]);
        }
        if (sig) sig_pos[n_sig++] = n;
      }
      if (n_sig == 0) continue;

      // greater1 / greater2
      int ctx_set = (i == 0 || c_idx > 0) ? 0 : 2;
      if (prev_sb_gt1) ctx_set++;
      int greater1_ctx = 1;
      int n_gt1 = 0;
      int first_gt1_n = -1;
      for (int k = 0; k < n_sig && k < 8; k++) {
        int inc = ctx_set * 4 + (greater1_ctx < 3 ? greater1_ctx : 3) +
                  (c_idx ? 16 : 0);
        int g1 = dec.decode_bin(ctx(F_GT1, inc));
        gt1_n[n_gt1] = sig_pos[k];
        gt1_flag[n_gt1] = g1;
        n_gt1++;
        if (g1) {
          if (first_gt1_n < 0) first_gt1_n = sig_pos[k];
          greater1_ctx = 0;
        } else if (greater1_ctx > 0) {
          greater1_ctx++;
        }
      }
      int gt2 = 0;
      if (first_gt1_n >= 0)
        gt2 = dec.decode_bin(ctx(F_GT2, ctx_set + (c_idx ? 4 : 0)));
      prev_sb_gt1 = first_gt1_n >= 0;

      bool sign_hidden = P[P_SIGN_DATA_HIDING] && !cur_tqb &&
                         (sig_pos[0] - sig_pos[n_sig - 1]) > 3;
      int n_signs = sign_hidden ? n_sig - 1 : n_sig;
      uint32_t sgnbits = dec.decode_bypass_bits(n_signs);

      int rice = 0;
      int levels[16];
      int64_t sum_abs = 0;
      for (int k = 0; k < n_sig; k++) {
        int n = sig_pos[k];
        int base = 1, max_base = 1;
        for (int j = 0; j < n_gt1; j++) {
          if (gt1_n[j] == n) {
            base = 1 + gt1_flag[j] + (n == first_gt1_n ? gt2 : 0);
            max_base = (n == first_gt1_n) ? 3 : 2;
            break;
          }
        }
        int level = base;
        if (base == max_base) {
          int prefix = 0;
          while (dec.decode_bypass()) {
            prefix++;
            if (prefix > 31) {
              fail(1, "coeff remaining runaway");
              return;
            }
          }
          int rem;
          if (prefix <= 3)
            rem = (prefix << rice) + (int)dec.decode_bypass_bits(rice);
          else
            rem = ((((1 << (prefix - 3)) + 3 - 1)) << rice) +
                  (int)dec.decode_bypass_bits(prefix - 3 + rice);
          level = base + rem;
        }
        if (level > (3 << rice)) rice = rice + 1 < 4 ? rice + 1 : 4;
        levels[k] = level;
        sum_abs += level;
      }

      for (int k = 0; k < n_sig; k++) {
        int n = sig_pos[k];
        int qx = pos.x[n], qy = pos.y[n];
        int xc = (sx << 2) + qx, yc = (sy << 2) + qy;
        int level = levels[k];
        bool neg;
        if (sign_hidden && k == n_sig - 1)
          neg = (sum_abs & 1) == 1;
        else
          neg = ((sgnbits >> (n_signs - 1 - k)) & 1) != 0;
        coeffs[(size_t)yc * size + xc] = neg ? -level : level;
      }
    }

    emit_tu_inplace(x0, y0, log2, c_idx, pred_mode, transform_skip,
                    n_coeff_vals);
  }

  // ------------------------------------------------------------- toplevel

  int run() {
    log2_min_qg = P[P_LOG2_CTB] - P[P_DIFF_CU_QP_DELTA_DEPTH];
    qp_prev = P[P_SH_QP];
    qg_pred = P[P_SH_QP];

    for (int k = 0; k < 3; k++) {
      scans4[k] = make_scan(k, 4);
      for (int l = 0; l < 4; l++) sb_scans[k][l] = make_scan(k, 1 << l);
    }

    p_state.assign(init_p_state, init_p_state + n_ctx);
    val_mps.assign(init_val_mps, init_val_mps + n_ctx);

    int ctb = 1 << P[P_LOG2_CTB];
    int n_cols = P[P_N_CTB_COLS];
    int n_rows = P[P_N_CTB_ROWS];
    bool wpp = P[P_WPP] != 0;

    int sub_idx = 0;
    dec.data = rbsp;
    dec.end = substreams[1];
    dec.pos = substreams[0] * 8;
    dec.p_state = p_state.data();
    dec.val_mps = val_mps.data();
    if (!dec.init()) {
      fail(1, "CABAC init offset invalid");
      return err.code;
    }

    const int64_t n_ctbs = (int64_t)n_cols * n_rows;
    const int64_t start = P[P_START_CTB];
    if (start < 0 || start >= n_ctbs) {
      fail(1, "slice segment address out of range");
      return err.code;
    }
    // the slice segment: CTBs from its address to its
    // end_of_slice_segment_flag (or the picture's last CTB).  Under WPP
    // each CTB row after the segment's first starts a substream, from the
    // contexts saved after CTB 1 of the row above where that CTB is in
    // this segment (spec 9.3.1: the above-right CTB available), else
    // from the initial states
    for (int64_t idx = start; idx < n_ctbs; idx++) {
      const int col = (int)(idx % n_cols), row = (int)(idx / n_cols);
      if (wpp && col == 0 && idx != start) {
        sub_idx++;
        if (sub_idx >= n_sub) {
          fail(1, "missing WPP entry point");
          return err.code;
        }
        if (have_saved && n_cols > 1) {
          p_state = saved_p;
          val_mps = saved_m;
        } else {
          p_state.assign(init_p_state, init_p_state + n_ctx);
          val_mps.assign(init_val_mps, init_val_mps + n_ctx);
        }
        have_saved = false;
        dec.pos = substreams[2 * sub_idx] * 8;
        dec.end = substreams[2 * sub_idx + 1];
        dec.p_state = p_state.data();
        dec.val_mps = val_mps.data();
        if (!dec.init()) {
          fail(1, "CABAC init offset invalid");
          return err.code;
        }
        pending_qp_reset = true;
      }
      claim_ctb(col, row);
      if (P[P_SAO_ENABLED] && (P[P_SH_SAO_LUMA] || P[P_SH_SAO_CHROMA]))
        parse_sao(col, row);
      coding_quadtree(col * ctb, row * ctb, P[P_LOG2_CTB], 0);
      if (err.code) return err.code;
      if (wpp && col == 1) {
        saved_p = p_state;
        saved_m = val_mps;
        have_saved = true;
      }
      const int end = dec.decode_terminate();
      if (col == n_cols - 1) publish_row(row);
      if (end || idx == n_ctbs - 1) {
        last_ctb = idx;
        break;
      }
    }
    fill_slice_qp(start);
    return 0;
  }

  // without cu_qp_delta, QpY is the slice's QP (ctu.py _finalize_qgs):
  // the whole map for the picture's first slice, the CTBs from `start`
  // to last_ctb for a later one
  void fill_slice_qp(int64_t start) {
    if (P[P_CU_QP_DELTA_ENABLED]) return;
    const int16_t qp = (int16_t)P[P_SH_QP];
    if (start == 0) {
      for (int64_t i = 0; i < (int64_t)w4 * h4; i++) qp_y[i] = qp;
      return;
    }
    const int n_cols = P[P_N_CTB_COLS];
    const int c4 = 1 << (P[P_LOG2_CTB] - 2);
    for (int64_t idx = start; idx <= last_ctb; idx++)
      fill_map<int16_t>(qp_y, (int)(idx % n_cols) * c4,
                        (int)(idx / n_cols) * c4, c4, c4, qp);
  }
};

}  // namespace

extern "C" {

// returns 0 on success; 1 invalid input; 2 unsupported feature.
// err_msg receives a NUL-terminated description on failure.
int tpuheif_hevc_parse_slice(
    const uint8_t* rbsp, int64_t rbsp_len, const int32_t* params,
    const int32_t* family_offsets, const uint8_t* init_p_state,
    const uint8_t* init_val_mps, int32_t n_ctx, const int64_t* substreams,
    int32_t n_sub, uint8_t* intra_mode_y, uint8_t* intra_mode_c,
    uint8_t* ct_depth, uint8_t* cu_log2_map, uint8_t* tu_log2_map,
    int16_t* qp_y, uint8_t* tqb_map, uint8_t* nonzero_y, uint8_t* avail,
    int16_t* slice_map,
    int32_t w4, int32_t h4, int32_t* tu_meta, int64_t tu_cap,
    int32_t* coeff_buf, int64_t coeff_cap, int16_t* sao_buf,
    int64_t* out_counts, char* err_msg, int32_t err_cap,
    int64_t* row_tu_counts, int64_t* rows_done) {
  Parser ps;
  memcpy(ps.P, params, sizeof(ps.P));
  ps.fam = family_offsets;
  ps.init_p_state = init_p_state;
  ps.init_val_mps = init_val_mps;
  ps.n_ctx = n_ctx;
  ps.rbsp = rbsp;
  ps.rbsp_len = rbsp_len;
  ps.substreams = substreams;
  ps.n_sub = n_sub;
  ps.intra_mode_y = intra_mode_y;
  ps.intra_mode_c = intra_mode_c;
  ps.ct_depth = ct_depth;
  ps.cu_log2_map = cu_log2_map;
  ps.tu_log2_map = tu_log2_map;
  ps.qp_y = qp_y;
  ps.tqb_map = tqb_map;
  ps.nonzero_y = nonzero_y;
  ps.avail = avail;
  ps.slice_map = slice_map;
  ps.w4 = w4;
  ps.h4 = h4;
  ps.tu_meta = tu_meta;
  ps.tu_cap = tu_cap;
  ps.coeff_buf = coeff_buf;
  ps.coeff_cap = coeff_cap;
  ps.tu_limit = tu_cap;
  ps.coeff_limit = coeff_cap;
  ps.sao_buf = sao_buf;

  ps.row_counts = row_tu_counts;
  ps.rows_done = rows_done;
  int rc = ps.run();
  if (row_tu_counts) {
    // on failure (or early return) publish the remaining rows at the
    // current TU count so a streaming consumer never blocks or reads
    // partially-written TU records
    int n_rows = ps.P[P_N_CTB_ROWS];
    for (int r = ps.published_rows; r < n_rows; r++)
      row_tu_counts[r] = ps.n_tus;
    __atomic_store_n(rows_done, (int64_t)n_rows, __ATOMIC_RELEASE);
    syscall(SYS_futex, (uint32_t*)rows_done, FUTEX_WAKE, INT_MAX,
            nullptr, nullptr, 0);
  }
  out_counts[0] = ps.n_tus;
  out_counts[1] = ps.n_coeff;
  out_counts[2] = ps.last_ctb;
  if (rc && err_msg && err_cap > 0) {
    snprintf(err_msg, err_cap, "%s", ps.err.msg);
  }
  return rc ? ps.err.code : 0;
}

// WPP wavefront-parallel variant of tpuheif_hevc_parse_slice: rows
// interleave across n_workers threads with the spec's 2-CTB-column
// wavefront lag (SURVEY §7(a); libde265's WPP thread tasks are the
// reference behavior).  Requirements enforced by the Python caller:
// pps WPP on, one entry point per CTB row, cu_qp_delta disabled.
// TU records are re-ordered to raster-row order after the join, so
// the output is byte-identical to the serial parse (except qg_serial,
// which is worker-local; nothing downstream consumes it).
int tpuheif_hevc_parse_slice_wpp(
    const uint8_t* rbsp, int64_t rbsp_len, const int32_t* params,
    const int32_t* family_offsets, const uint8_t* init_p_state,
    const uint8_t* init_val_mps, int32_t n_ctx, const int64_t* substreams,
    int32_t n_sub, uint8_t* intra_mode_y, uint8_t* intra_mode_c,
    uint8_t* ct_depth, uint8_t* cu_log2_map, uint8_t* tu_log2_map,
    int16_t* qp_y, uint8_t* tqb_map, uint8_t* nonzero_y, uint8_t* avail,
    int16_t* slice_map,
    int32_t w4, int32_t h4, int32_t* tu_meta, int64_t tu_cap,
    int32_t* coeff_buf, int64_t coeff_cap, int16_t* sao_buf,
    int64_t* out_counts, char* err_msg, int32_t err_cap,
    int64_t* row_tu_counts, int64_t* rows_done, int32_t n_workers) {
  int n_rows = params[P_N_CTB_ROWS];
  if (params[P_START_CTB] != 0 || params[P_SLICE_IDX] != 0) {
    // the workers parse whole rows of a picture of one slice
    if (err_msg && err_cap > 0)
      snprintf(err_msg, err_cap, "threaded WPP parse of a slice segment");
    return 1;
  }
  if (n_workers < 2 || n_rows < 2 || !params[P_WPP] ||
      params[P_CU_QP_DELTA_ENABLED] || n_sub < n_rows) {
    // fall back to the serial engine
    return tpuheif_hevc_parse_slice(
        rbsp, rbsp_len, params, family_offsets, init_p_state,
        init_val_mps, n_ctx, substreams, n_sub, intra_mode_y,
        intra_mode_c, ct_depth, cu_log2_map, tu_log2_map, qp_y, tqb_map,
        nonzero_y, avail, slice_map, w4, h4, tu_meta, tu_cap, coeff_buf,
        coeff_cap,
        sao_buf, out_counts, err_msg, err_cap, row_tu_counts, rows_done);
  }
  if (n_workers > n_rows) n_workers = n_rows;

  WppSync sync;
  sync.init(n_rows);
  std::vector<int64_t> row_start(n_rows, 0), row_end(n_rows, 0);
  std::vector<Parser*> workers(n_workers);
  for (int w = 0; w < n_workers; w++) {
    Parser* ps = new Parser();
    memcpy(ps->P, params, sizeof(ps->P));
    ps->fam = family_offsets;
    ps->init_p_state = init_p_state;
    ps->init_val_mps = init_val_mps;
    ps->n_ctx = n_ctx;
    ps->rbsp = rbsp;
    ps->rbsp_len = rbsp_len;
    ps->substreams = substreams;
    ps->n_sub = n_sub;
    ps->intra_mode_y = intra_mode_y;
    ps->intra_mode_c = intra_mode_c;
    ps->ct_depth = ct_depth;
    ps->cu_log2_map = cu_log2_map;
    ps->tu_log2_map = tu_log2_map;
    ps->qp_y = qp_y;
    ps->tqb_map = tqb_map;
    ps->nonzero_y = nonzero_y;
    ps->avail = avail;
    ps->w4 = w4;
    ps->h4 = h4;
    ps->tu_meta = tu_meta;
    ps->tu_cap = tu_cap;
    ps->coeff_buf = coeff_buf;
    ps->coeff_cap = coeff_cap;
    ps->sao_buf = sao_buf;
    // worker-private buffer segments (TU meta + coefficients)
    ps->n_tus = w * (tu_cap / n_workers);
    ps->tu_limit = (w + 1) * (tu_cap / n_workers);
    ps->n_coeff = w * (coeff_cap / n_workers);
    ps->coeff_limit = (w + 1) * (coeff_cap / n_workers);
    ps->wpp = &sync;
    ps->wpp_first_row = w;
    ps->wpp_row_stride = n_workers;
    ps->wpp_row_tu_start = row_start.data();
    ps->wpp_row_tu_end = row_end.data();
    workers[w] = ps;
  }
  std::vector<std::thread> threads;
  for (int w = 1; w < n_workers; w++)
    threads.emplace_back([ps = workers[w]]() { ps->run_wpp_worker(); });
  workers[0]->run_wpp_worker();
  for (auto& t : threads) t.join();

  int rc = 0;
  for (int w = 0; w < n_workers; w++) {
    if (workers[w]->err.code && !rc) {
      rc = workers[w]->err.code;
      if (err_msg && err_cap > 0)
        snprintf(err_msg, err_cap, "%s", workers[w]->err.msg);
    }
  }

  int64_t total_tus = 0;
  if (!rc) {
    // re-order TU records into raster-row order (coefficient offsets
    // in m[9] are absolute, so only the 10-int32 meta rows move)
    for (int r = 0; r < n_rows; r++) total_tus += row_end[r] - row_start[r];
    std::vector<int32_t> merged((size_t)total_tus * 10);
    int64_t at = 0;
    for (int r = 0; r < n_rows; r++) {
      int64_t cnt = row_end[r] - row_start[r];
      memcpy(merged.data() + at * 10, tu_meta + row_start[r] * 10,
             (size_t)cnt * 10 * sizeof(int32_t));
      at += cnt;
      if (row_tu_counts) row_tu_counts[r] = at;
    }
    memcpy(tu_meta, merged.data(), merged.size() * sizeof(int32_t));
    if (!params[P_CU_QP_DELTA_ENABLED]) {
      for (int64_t i = 0; i < (int64_t)w4 * h4; i++)
        qp_y[i] = (int16_t)params[P_SH_QP];
    }
  }
  if (row_tu_counts) {
    if (rc)
      for (int r = 0; r < n_rows; r++) row_tu_counts[r] = 0;
    __atomic_store_n(rows_done, (int64_t)n_rows, __ATOMIC_RELEASE);
    syscall(SYS_futex, (uint32_t*)rows_done, FUTEX_WAKE, INT_MAX,
            nullptr, nullptr, 0);
  }
  // n_coeff spans are per-worker segments; report the high-water mark
  int64_t max_coeff = 0;
  for (int w = 0; w < n_workers; w++)
    if (workers[w]->n_coeff > max_coeff) max_coeff = workers[w]->n_coeff;
  out_counts[0] = total_tus;
  out_counts[1] = max_coeff;
  out_counts[2] = (int64_t)n_rows * params[P_N_CTB_COLS] - 1;
  for (int w = 0; w < n_workers; w++) delete workers[w];
  return rc;
}

}  // extern "C"
