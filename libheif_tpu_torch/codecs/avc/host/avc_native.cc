// H.264/AVC I-slice native decode engine (CABAC + intra recon +
// deblock), C++ drop-in for codecs/avc/{cabac,mb,deblock}.py, which
// stay the conformance anchors (difftested plane-for-plane; the whole
// stack is oracle-checked against libavcodec/x264 in the suite).
// Replaces the reference's openh264/ffmpeg plugin boundary
// (reference: libheif/plugins/decoder_openh264.cc).
//
// Interface: tpuheif_avc_decode_slice decodes one I slice into the
// caller's planes + per-MB state arrays (Python owns all state, so
// multi-slice pictures just call again); tpuheif_avc_deblock applies
// the in-loop filter over the finished frame.
//
// A copy of libheif_tpu/native/src/avc_native.cc, unchanged but for
// this paragraph; libheif_tpu_torch/_build.py builds it as the
// avc_host library (AVC_HOST_LIBRARY).  The port's decoder calls the
// two decode exports (codecs/avc/native_decode.py), its still-image
// encoder the encode export, tpuheif_avc_encode_slice
// (codecs/avc/encoder.py _NativeSliceEncoder).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <algorithm>

namespace avcn {

typedef int64_t i64;
typedef int32_t i32;
typedef uint8_t u8;
typedef uint16_t u16;

// M-coder tables are the same ones H.265 inherited; keep in sync with
// codecs/hevc/tables.py (validated bit-exact vs libde265/libavcodec).
static const u8 kRangeTabLPS[64][4] = {
    {128, 176, 208, 240},
    {128, 167, 197, 227},
    {128, 158, 187, 216},
    {123, 150, 178, 205},
    {116, 142, 169, 195},
    {111, 135, 160, 185},
    {105, 128, 152, 175},
    {100, 122, 144, 166},
    {95, 116, 137, 158},
    {90, 110, 130, 150},
    {85, 104, 123, 142},
    {81, 99, 117, 135},
    {77, 94, 111, 128},
    {73, 89, 105, 122},
    {69, 85, 100, 116},
    {66, 80, 95, 110},
    {62, 76, 90, 104},
    {59, 72, 86, 99},
    {56, 69, 81, 94},
    {53, 65, 77, 89},
    {51, 62, 73, 85},
    {48, 59, 69, 80},
    {46, 56, 66, 76},
    {43, 53, 63, 72},
    {41, 50, 59, 69},
    {39, 48, 56, 65},
    {37, 45, 54, 62},
    {35, 43, 51, 59},
    {33, 41, 48, 56},
    {32, 39, 46, 53},
    {30, 37, 43, 50},
    {29, 35, 41, 48},
    {27, 33, 39, 45},
    {26, 31, 37, 43},
    {24, 30, 35, 41},
    {23, 28, 33, 39},
    {22, 27, 32, 37},
    {21, 26, 30, 35},
    {20, 24, 29, 33},
    {19, 23, 27, 31},
    {18, 22, 26, 30},
    {17, 21, 25, 28},
    {16, 20, 23, 27},
    {15, 19, 22, 25},
    {14, 18, 21, 24},
    {14, 17, 20, 23},
    {13, 16, 19, 22},
    {12, 15, 18, 21},
    {12, 14, 17, 20},
    {11, 14, 16, 19},
    {11, 13, 15, 18},
    {10, 12, 15, 17},
    {10, 12, 14, 16},
    {9, 11, 13, 15},
    {9, 11, 12, 14},
    {8, 10, 12, 14},
    {8, 9, 11, 13},
    {7, 9, 11, 12},
    {7, 9, 10, 12},
    {7, 8, 10, 11},
    {6, 8, 9, 11},
    {6, 7, 9, 10},
    {6, 7, 8, 9},
    {2, 2, 2, 2},
};
static const u8 kTransIdxLPS[64] = {
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
};
static const u8 kTransIdxMPS[64] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48,
    49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 62, 63,
};

// context bases (codecs/avc/tables.py:98-117)
static const int CTX_MB_TYPE_I = 3;
static const int CTX_MB_QP_DELTA = 60;
static const int CTX_CHROMA_PRED = 64;
static const int CTX_PREV_I4X4 = 68;
static const int CTX_REM_I4X4 = 69;
static const int CTX_CBP_LUMA = 73;
static const int CTX_CBP_CHROMA = 77;
static const int CTX_CBF = 85;
static const int CTX_SIG = 105;
static const int CTX_LAST = 166;
static const int CTX_ABS = 227;
static const int CTX_TRANSFORM_8X8 = 399;
static const int CTX_SIG_8X8 = 402;
static const int CTX_LAST_8X8 = 417;
static const int CTX_ABS_8X8 = 426;
static const int SIG_CAT_OFF[5] = {0, 15, 29, 44, 47};
static const int ABS_CAT_OFF[5] = {0, 10, 20, 30, 39};
static const int CAT_LUMA_DC = 0, CAT_LUMA_AC = 1, CAT_LUMA_4X4 = 2,
                 CAT_CHROMA_DC = 3, CAT_CHROMA_AC = 4, CAT_LUMA_8X8 = 5;
// intra mode ids (tables.py)
static const int I4_DC = 2;

static const int BLK4_X[16] = {0,1,0,1,2,3,2,3,0,1,0,1,2,3,2,3};
static const int BLK4_Y[16] = {0,0,1,1,0,0,1,1,2,2,3,3,2,2,3,3};
static int BLK4_IDX[4][4];
static bool g_blk_init = false;
static void blk_init() {
  if (g_blk_init) return;
  for (int k = 0; k < 16; k++) BLK4_IDX[BLK4_Y[k]][BLK4_X[k]] = k;
  g_blk_init = true;
}

// mb.py _check_intra_mode: corrupt CABAC can signal modes whose
// reference samples don't exist; 4x4/8x8 numbering (VERT/DDL/VL need
// top, HOR/HU left, DC none, DDR/VR/HD all three)
static inline bool intra_mode_ok(int mode, bool ht, bool hl, bool htl) {
  switch (mode) {
    case 0: case 3: case 7: return ht;
    case 1: case 8: return hl;
    case 2: return true;
    default: return ht && hl && htl;
  }
}

static inline int clip3i(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ------------------------------------------------------------- CABAC

#ifdef TPUHEIF_AVC_TRACE_BUILD
// bin-trace hook for differential debugging vs the Python engine
// (tests drive it via TPUHEIF_AVC_TRACE=<path>); zero cost unless the
// library is built with -DTPUHEIF_AVC_TRACE_BUILD.
static FILE* avc_trace() {
  static FILE* f = nullptr;
  static bool init = false;
  if (!init) {
    init = true;
    const char* p = getenv("TPUHEIF_AVC_TRACE");
    if (p) f = fopen(p, "w");
  }
  return f;
}
#endif

struct Cabac {
  const u8* data;
  i64 size;
  i64 bitpos;                 // bits fetched into the cache
  uint64_t cache;
  int ncache;
  uint32_t range, offset;
  u8* p_state;
  u8* val_mps;

  inline void refill() {
    i64 b = bitpos >> 3;
    while (ncache <= 48) {
      uint32_t byte = (b < size) ? data[b] : 0;
      cache = (cache << 8) | byte;
      ncache += 8;
      b++;
    }
    bitpos = b << 3;
  }
  inline uint32_t get_bits(int n) {
    if (ncache < n) refill();
    ncache -= n;
    return (uint32_t)((cache >> ncache) & ((1u << n) - 1));
  }
  inline i64 consumed() const { return bitpos - ncache; }

  void init_at(i64 bit_pos) {
    cache = 0;
    ncache = 0;
    bitpos = bit_pos;
    range = 510;
    offset = get_bits(9);
  }

  inline int decode_bin(int ctx_idx) {
#ifdef TPUHEIF_AVC_TRACE_BUILD
    int _r = decode_bin_impl(ctx_idx);
    if (FILE* f = avc_trace()) fprintf(f, "b %d %d\n", ctx_idx, _r);
    return _r;
  }
  inline int decode_bin_impl(int ctx_idx) {
#endif
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
      if (range >= 256) return binval;
    }
    int sh = __builtin_clz(range) - 23;
    range <<= sh;
    offset = (offset << sh) | get_bits(sh);
    return binval;
  }

  inline int decode_bypass() {
#ifdef TPUHEIF_AVC_TRACE_BUILD
    int _r = decode_bypass_impl();
    if (FILE* f = avc_trace()) fprintf(f, "y %d\n", _r);
    return _r;
  }
  inline int decode_bypass_impl() {
#endif
    offset = (offset << 1) | get_bits(1);
    if (offset >= range) {
      offset -= range;
      return 1;
    }
    return 0;
  }

  inline uint32_t decode_bypass_bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | decode_bypass();
    return v;
  }

  inline int decode_terminate() {
#ifdef TPUHEIF_AVC_TRACE_BUILD
    int _r = decode_terminate_impl();
    if (FILE* f = avc_trace()) fprintf(f, "t %d\n", _r);
    return _r;
  }
  inline int decode_terminate_impl() {
#endif
    range -= 2;
    if (offset >= range) return 1;
    if (range < 256) {
      int sh = __builtin_clz(range) - 23;
      range <<= sh;
      offset = (offset << sh) | get_bits(sh);
    }
    return 0;
  }

  int decode_eg_bypass(int k, int* err) {
    int v = 0;
    while (decode_bypass()) {
      v += 1 << k;
      k += 1;
      if (k > 30) { *err = 1; return 0; }
    }
    if (k) v += (int)decode_bypass_bits(k);
    return v;
  }
};

// --------------------------------------------------- transforms

// 4x4 core inverse transform (spec 8.5.12.2); in-place i32
static void itrans4(const i32* d, i32* out) {
  i32 f[16];
  for (int r = 0; r < 4; r++) {
    i32 d0 = d[r * 4 + 0], d1 = d[r * 4 + 1], d2 = d[r * 4 + 2],
        d3 = d[r * 4 + 3];
    i32 e0 = d0 + d2, e1 = d0 - d2, e2 = (d1 >> 1) - d3,
        e3 = d1 + (d3 >> 1);
    f[r * 4 + 0] = e0 + e3;
    f[r * 4 + 1] = e1 + e2;
    f[r * 4 + 2] = e1 - e2;
    f[r * 4 + 3] = e0 - e3;
  }
  for (int c = 0; c < 4; c++) {
    i32 f0 = f[0 * 4 + c], f1 = f[1 * 4 + c], f2 = f[2 * 4 + c],
        f3 = f[3 * 4 + c];
    i32 e0 = f0 + f2, e1 = f0 - f2, e2 = (f1 >> 1) - f3,
        e3 = f1 + (f3 >> 1);
    out[0 * 4 + c] = (e0 + e3 + 32) >> 6;
    out[1 * 4 + c] = (e1 + e2 + 32) >> 6;
    out[2 * 4 + c] = (e1 - e2 + 32) >> 6;
    out[3 * 4 + c] = (e0 - e3 + 32) >> 6;
  }
}

static void ihadamard4(const i32* c, i32* out) {
  i32 f[16];
  for (int r = 0; r < 4; r++) {
    i32 c0 = c[r * 4 + 0], c1 = c[r * 4 + 1], c2 = c[r * 4 + 2],
        c3 = c[r * 4 + 3];
    i32 e0 = c0 + c2, e1 = c0 - c2, e2 = c1 - c3, e3 = c1 + c3;
    f[r * 4 + 0] = e0 + e3;
    f[r * 4 + 1] = e1 + e2;
    f[r * 4 + 2] = e1 - e2;
    f[r * 4 + 3] = e0 - e3;
  }
  for (int cc = 0; cc < 4; cc++) {
    i32 f0 = f[0 * 4 + cc], f1 = f[1 * 4 + cc], f2 = f[2 * 4 + cc],
        f3 = f[3 * 4 + cc];
    i32 e0 = f0 + f2, e1 = f0 - f2, e2 = f1 - f3, e3 = f1 + f3;
    out[0 * 4 + cc] = e0 + e3;
    out[1 * 4 + cc] = e1 + e2;
    out[2 * 4 + cc] = e1 - e2;
    out[3 * 4 + cc] = e0 - e3;
  }
}

static inline void itrans8_vec(const i32* a, i32* r) {
  i32 e0 = a[0] + a[4];
  i32 e1 = -a[3] + a[5] - a[7] - (a[7] >> 1);
  i32 e2 = a[0] - a[4];
  i32 e3 = a[1] + a[7] - a[3] - (a[3] >> 1);
  i32 e4 = (a[2] >> 1) - a[6];
  i32 e5 = -a[1] + a[7] + a[5] + (a[5] >> 1);
  i32 e6 = a[2] + (a[6] >> 1);
  i32 e7 = a[3] + a[5] + a[1] + (a[1] >> 1);
  i32 f0 = e0 + e6, f1 = e1 + (e7 >> 2), f2 = e2 + e4,
      f3 = e3 + (e5 >> 2), f4 = e2 - e4, f5 = (e3 >> 2) - e5,
      f6 = e0 - e6, f7 = e7 - (e1 >> 2);
  r[0] = f0 + f7; r[1] = f2 + f5; r[2] = f4 + f3; r[3] = f6 + f1;
  r[4] = f6 - f1; r[5] = f4 - f3; r[6] = f2 - f5; r[7] = f0 - f7;
}

static void itrans8(const i32* d, i32* out) {
  i32 f[64], tmp[8], res[8];
  for (int r = 0; r < 8; r++) itrans8_vec(d + r * 8, f + r * 8);
  for (int c = 0; c < 8; c++) {
    for (int r = 0; r < 8; r++) tmp[r] = f[r * 8 + c];
    itrans8_vec(tmp, res);
    for (int r = 0; r < 8; r++) out[r * 8 + c] = (res[r] + 32) >> 6;
  }
}

}  // namespace avcn

namespace avcn {

// ----------------------------------------------- intra prediction
// (ports of mb.py pred_4x4 / pred_8x8 / pred_16x16 / pred_chroma)

// mode ids from tables.py
static const int I4_VERT = 0, I4_HOR = 1, /*I4_DC=2*/ I4_DDL = 3,
                 I4_DDR = 4, I4_VR = 5, I4_HD = 6, I4_VL = 7, I4_HU = 8;
static const int I16_VERT = 0, I16_HOR = 1, I16_DC = 2;
static const int C_DC = 0, C_HOR = 1, C_VERT = 2;

struct Border {
  i32 top[16];   // w samples
  i32 left[16];
  i32 tr[16];    // top-right extension (w extra)
  i32 tl;
  bool have_top, have_left, have_tl;
};

static void pred_4x4(int mode, const Border& b, i32* p) {
  const i32* top = b.have_top ? b.top : nullptr;
  const i32* left = b.have_left ? b.left : nullptr;
  i32 m = b.tl;
  if (mode == I4_DC) {
    int v;
    if (top && left) {
      int s = 0;
      for (int i = 0; i < 4; i++) s += top[i] + left[i];
      v = (s + 4) >> 3;
    } else if (top) {
      int s = top[0] + top[1] + top[2] + top[3];
      v = (s + 2) >> 2;
    } else if (left) {
      int s = left[0] + left[1] + left[2] + left[3];
      v = (s + 2) >> 2;
    } else {
      v = 128;
    }
    for (int i = 0; i < 16; i++) p[i] = v;
    return;
  }
  if (mode == I4_VERT) {
    for (int y = 0; y < 4; y++)
      for (int x = 0; x < 4; x++) p[y * 4 + x] = top[x];
    return;
  }
  if (mode == I4_HOR) {
    for (int y = 0; y < 4; y++)
      for (int x = 0; x < 4; x++) p[y * 4 + x] = left[y];
    return;
  }
  i32 t[8];
  if (top) {
    for (int i = 0; i < 4; i++) t[i] = top[i];
    for (int i = 0; i < 4; i++) t[4 + i] = b.tr[i];
  }
  const i32* l = left;
  switch (mode) {
    case I4_DDL:
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
          int i = x + y;
          p[y * 4 + x] = i == 6 ? (t[6] + 3 * t[7] + 2) >> 2
                                : (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2;
        }
      return;
    case I4_DDR:
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
          if (x > y) {
            int i = x - y;
            p[y * 4 + x] = i >= 2
                ? (t[i - 2] + 2 * t[i - 1] + t[i] + 2) >> 2
                : (m + 2 * t[0] + t[1] + 2) >> 2;
          } else if (x < y) {
            int i = y - x;
            p[y * 4 + x] = i >= 2
                ? (l[i - 2] + 2 * l[i - 1] + l[i] + 2) >> 2
                : (m + 2 * l[0] + l[1] + 2) >> 2;
          } else {
            p[y * 4 + x] = (t[0] + 2 * m + l[0] + 2) >> 2;
          }
        }
      return;
    case I4_VR:
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
          int z = 2 * x - y;
          if (z >= 0 && z % 2 == 0) {
            int i = x - (y >> 1);
            p[y * 4 + x] = i >= 1 ? (t[i - 1] + t[i] + 1) >> 1
                                  : (m + t[0] + 1) >> 1;
          } else if (z >= 0) {
            int i = x - (y >> 1);
            p[y * 4 + x] = i >= 2
                ? (t[i - 2] + 2 * t[i - 1] + t[i] + 2) >> 2
                : (m + 2 * t[0] + t[1] + 2) >> 2;
          } else if (z == -1) {
            p[y * 4 + x] = (l[0] + 2 * m + t[0] + 2) >> 2;
          } else {
            // mirrors the Python reference exactly (x=0, y in {2,3}):
            // (l[y-1] + 2*l[y-2] + (m if y-3<0 else l[y-3]) + 2) >> 2
            p[y * 4 + x] = (l[y - 1] + 2 * l[y - 2] +
                            (y - 3 < 0 ? m : l[y - 3]) + 2) >> 2;
          }
        }
      return;
    case I4_HD:
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
          int z = 2 * y - x;
          if (z >= 0 && z % 2 == 0) {
            int i = y - (x >> 1);
            p[y * 4 + x] = i >= 1 ? (l[i - 1] + l[i] + 1) >> 1
                                  : (m + l[0] + 1) >> 1;
          } else if (z >= 0) {
            int i = y - (x >> 1);
            p[y * 4 + x] = i >= 2
                ? (l[i - 2] + 2 * l[i - 1] + l[i] + 2) >> 2
                : (m + 2 * l[0] + l[1] + 2) >> 2;
          } else if (z == -1) {
            p[y * 4 + x] = (t[0] + 2 * m + l[0] + 2) >> 2;
          } else {
            int i = x - 2 * y;
            p[y * 4 + x] = (t[i - 1] + 2 * t[i - 2] +
                            (i >= 3 ? t[i - 3] : m) + 2) >> 2;
          }
        }
      return;
    case I4_VL:
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
          int i = x + (y >> 1);
          p[y * 4 + x] = (y % 2 == 0)
              ? (t[i] + t[i + 1] + 1) >> 1
              : (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2;
        }
      return;
    case I4_HU:
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
          int z = x + 2 * y;
          if (z > 5) p[y * 4 + x] = l[3];
          else if (z == 5) p[y * 4 + x] = (l[2] + 3 * l[3] + 2) >> 2;
          else {
            int i = y + (x >> 1);
            p[y * 4 + x] = (z % 2 == 0)
                ? (l[i] + l[i + 1] + 1) >> 1
                : (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2;
          }
        }
      return;
  }
}

// 8x8 with reference filtering (spec 8.3.2.2); top has 16 samples
// (top-right already substituted)
static void pred_8x8(int mode, const Border& b, i32* p) {
  i32 ft[16], fl[8];
  i32 fm = 0;
  bool ht = b.have_top, hl = b.have_left, htl = b.have_tl;
  if (ht) {
    i32 t[16];
    for (int i = 0; i < 8; i++) t[i] = b.top[i];
    for (int i = 0; i < 8; i++) t[8 + i] = b.tr[i];
    ft[0] = htl ? (b.tl + 2 * t[0] + t[1] + 2) >> 2
                : (3 * t[0] + t[1] + 2) >> 2;
    for (int x = 1; x < 15; x++)
      ft[x] = (t[x - 1] + 2 * t[x] + t[x + 1] + 2) >> 2;
    ft[15] = (t[14] + 3 * t[15] + 2) >> 2;
  }
  if (htl) {
    int m = b.tl;
    if (ht && hl) fm = (b.left[0] + 2 * m + b.top[0] + 2) >> 2;
    else if (ht) fm = (3 * m + b.top[0] + 2) >> 2;
    else if (hl) fm = (3 * m + b.left[0] + 2) >> 2;
    else fm = m;
  }
  if (hl) {
    const i32* l0 = b.left;
    fl[0] = htl ? (b.tl + 2 * l0[0] + l0[1] + 2) >> 2
                : (3 * l0[0] + l0[1] + 2) >> 2;
    for (int y = 1; y < 7; y++)
      fl[y] = (l0[y - 1] + 2 * l0[y] + l0[y + 1] + 2) >> 2;
    fl[7] = (l0[6] + 3 * l0[7] + 2) >> 2;
  }
  const i32* t = ht ? ft : nullptr;
  const i32* l = hl ? fl : nullptr;
  i32 m = fm;
  if (mode == I4_DC) {
    int v;
    if (t && l) {
      int s = 0;
      for (int i = 0; i < 8; i++) s += t[i] + l[i];
      v = (s + 8) >> 4;
    } else if (t) {
      int s = 0;
      for (int i = 0; i < 8; i++) s += t[i];
      v = (s + 4) >> 3;
    } else if (l) {
      int s = 0;
      for (int i = 0; i < 8; i++) s += l[i];
      v = (s + 4) >> 3;
    } else {
      v = 128;
    }
    for (int i = 0; i < 64; i++) p[i] = v;
    return;
  }
  if (mode == I4_VERT) {
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) p[y * 8 + x] = t[x];
    return;
  }
  if (mode == I4_HOR) {
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) p[y * 8 + x] = l[y];
    return;
  }
  switch (mode) {
    case I4_DDL:
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
          int i = x + y;
          p[y * 8 + x] = i == 14
              ? (t[14] + 3 * t[15] + 2) >> 2
              : (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2;
        }
      return;
    case I4_DDR:
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
          if (x > y) {
            int i = x - y;
            p[y * 8 + x] = i >= 2
                ? (t[i - 2] + 2 * t[i - 1] + t[i] + 2) >> 2
                : (m + 2 * t[0] + t[1] + 2) >> 2;
          } else if (x < y) {
            int i = y - x;
            p[y * 8 + x] = i >= 2
                ? (l[i - 2] + 2 * l[i - 1] + l[i] + 2) >> 2
                : (m + 2 * l[0] + l[1] + 2) >> 2;
          } else {
            p[y * 8 + x] = (t[0] + 2 * m + l[0] + 2) >> 2;
          }
        }
      return;
    case I4_VR:
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
          int z = 2 * x - y;
          int i = x - (y >> 1);
          if (z >= 0 && z % 2 == 0) {
            p[y * 8 + x] = i >= 1 ? (t[i - 1] + t[i] + 1) >> 1
                                  : (m + t[0] + 1) >> 1;
          } else if (z >= 0) {
            p[y * 8 + x] = i >= 2
                ? (t[i - 2] + 2 * t[i - 1] + t[i] + 2) >> 2
                : (m + 2 * t[0] + t[1] + 2) >> 2;
          } else if (z == -1) {
            p[y * 8 + x] = (l[0] + 2 * m + t[0] + 2) >> 2;
          } else {
            int i2 = y - 2 * x - 1;
            p[y * 8 + x] = (l[i2] + 2 * l[i2 - 1] +
                            (i2 >= 2 ? l[i2 - 2] : m) + 2) >> 2;
          }
        }
      return;
    case I4_HD:
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
          int z = 2 * y - x;
          int i = y - (x >> 1);
          if (z >= 0 && z % 2 == 0) {
            p[y * 8 + x] = i >= 1 ? (l[i - 1] + l[i] + 1) >> 1
                                  : (m + l[0] + 1) >> 1;
          } else if (z >= 0) {
            p[y * 8 + x] = i >= 2
                ? (l[i - 2] + 2 * l[i - 1] + l[i] + 2) >> 2
                : (m + 2 * l[0] + l[1] + 2) >> 2;
          } else if (z == -1) {
            p[y * 8 + x] = (t[0] + 2 * m + l[0] + 2) >> 2;
          } else {
            int i2 = x - 2 * y - 1;
            p[y * 8 + x] = (t[i2] + 2 * t[i2 - 1] +
                            (i2 >= 2 ? t[i2 - 2] : m) + 2) >> 2;
          }
        }
      return;
    case I4_VL:
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
          int i = x + (y >> 1);
          p[y * 8 + x] = (y % 2 == 0)
              ? (t[i] + t[i + 1] + 1) >> 1
              : (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2;
        }
      return;
    case I4_HU:
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
          int z = x + 2 * y;
          if (z > 13) p[y * 8 + x] = l[7];
          else if (z == 13) p[y * 8 + x] = (l[6] + 3 * l[7] + 2) >> 2;
          else {
            int i = y + (x >> 1);
            p[y * 8 + x] = (z % 2 == 0)
                ? (l[i] + l[i + 1] + 1) >> 1
                : (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2;
          }
        }
      return;
  }
}

static void pred_16x16(int mode, const i32* top, const i32* left,
                       int tl, bool ht, bool hl, bool htl, i32* p) {
  if (mode == I16_DC) {
    int v;
    if (ht && hl) {
      int s = 0;
      for (int i = 0; i < 16; i++) s += top[i] + left[i];
      v = (s + 16) >> 5;
    } else if (ht) {
      int s = 0;
      for (int i = 0; i < 16; i++) s += top[i];
      v = (s + 8) >> 4;
    } else if (hl) {
      int s = 0;
      for (int i = 0; i < 16; i++) s += left[i];
      v = (s + 8) >> 4;
    } else {
      v = 128;
    }
    for (int i = 0; i < 256; i++) p[i] = v;
  } else if (mode == I16_VERT) {
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++) p[y * 16 + x] = top[x];
  } else if (mode == I16_HOR) {
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++) p[y * 16 + x] = left[y];
  } else {  // plane
    i64 h = 0, v = 0;
    for (int x = 0; x < 8; x++)
      h += (i64)(x + 1) * (top[8 + x] - (x < 7 ? top[6 - x] : tl));
    for (int y = 0; y < 8; y++)
      v += (i64)(y + 1) * (left[8 + y] - (y < 7 ? left[6 - y] : tl));
    i64 a = 16 * ((i64)top[15] + left[15]);
    i64 bb = (5 * h + 32) >> 6;
    i64 c = (5 * v + 32) >> 6;
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++)
        p[y * 16 + x] = (i32)clip3i(
            0, 255, (int)((a + bb * (x - 7) + c * (y - 7) + 16) >> 5));
  }
}

static void pred_chroma8(int mode, const i32* top, const i32* left,
                         int tl, bool ht, bool hl, bool htl, i32* p) {
  if (mode == C_DC) {
    for (int by = 0; by < 8; by += 4)
      for (int bx = 0; bx < 8; bx += 4) {
        const i32* t = ht ? top + bx : nullptr;
        const i32* l = hl ? left + by : nullptr;
        int v;
        auto sum4 = [](const i32* a) {
          return a[0] + a[1] + a[2] + a[3];
        };
        if ((bx == 0 && by == 0) || (bx == 4 && by == 4)) {
          if (t && l) v = (sum4(t) + sum4(l) + 4) >> 3;
          else if (t) v = (sum4(t) + 2) >> 2;
          else if (l) v = (sum4(l) + 2) >> 2;
          else v = 128;
        } else if (bx == 4 && by == 0) {
          if (t) v = (sum4(t) + 2) >> 2;
          else if (l) v = (sum4(l) + 2) >> 2;
          else v = 128;
        } else {
          if (l) v = (sum4(l) + 2) >> 2;
          else if (t) v = (sum4(t) + 2) >> 2;
          else v = 128;
        }
        for (int y = by; y < by + 4; y++)
          for (int x = bx; x < bx + 4; x++) p[y * 8 + x] = v;
      }
    return;
  }
  if (mode == C_HOR) {
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) p[y * 8 + x] = left[y];
    return;
  }
  if (mode == C_VERT) {
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) p[y * 8 + x] = top[x];
    return;
  }
  i64 h = 0, v = 0;
  for (int x = 0; x < 4; x++)
    h += (i64)(x + 1) * (top[4 + x] - (x < 3 ? top[2 - x] : tl));
  for (int y = 0; y < 4; y++)
    v += (i64)(y + 1) * (left[4 + y] - (y < 3 ? left[2 - y] : tl));
  i64 a = 16 * ((i64)top[7] + left[7]);
  i64 bb = (17 * h + 16) >> 5;
  i64 c = (17 * v + 16) >> 5;
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++)
      p[y * 8 + x] = (i32)clip3i(
          0, 255, (int)((a + bb * (x - 3) + c * (y - 3) + 16) >> 5));
}

}  // namespace avcn

namespace avcn {

// ----------------------------------------------------- slice decoder

static const int I_NXN = 0, I_PCM = 25;

// mb_state layout per MB (8 i32): [decoded, is_nxn, is_pcm, is_i16,
// tx8, cbp_luma, cbp_chroma, chroma_mode]; qp in mb_qp
enum { MS_DECODED = 0, MS_NXN, MS_PCM, MS_I16, MS_TX8, MS_CBPL,
       MS_CBPC, MS_CMODE, MS_N };

struct Slice {
  // config
  int mb_w, mb_h, mono, first_mb, transform_8x8_mode;
  int cb_qp_off, cr_qp_off;
  // tables from Python
  const i32* sig8;      // 63
  const i32* last8;     // 63
  const i32* zz4;       // 16
  const i32* zz8;       // 64
  const i32* ls4;       // 6*16  (LEVEL_SCALE_4 flattened)
  const i32* ls8;       // 6*64
  const i32* chroma_qp_tab;   // 52
  // state (Python-owned)
  i32* mb_state;        // n_mb * MS_N
  i32* mb_qp;
  i32* i4_modes;        // (mb_h*4)*(mb_w*4)
  u8* cbf_luma;         // (mb_h*4)*(mb_w*4)
  u8* cbf_luma_dc;      // n_mb
  u8* cbf_cdc;          // 2*n_mb
  u8* cbf_cac;          // 2*(mb_h*2)*(mb_w*2)
  u16* planes[3];
  int pw[3], ph[3];
  Cabac d;
  int qp, prev_qp_delta;
  int mbx, mby, blk;
  i32* cur;             // current mb_state row
  int cur_qp_delta;
  int rc;
  char* err; int errlen;

  void fail(const char* msg) {
    if (!rc) { rc = 1; snprintf(err, errlen, "%s", msg); }
  }

  i32* mb_at(int x, int y) {
    if (x < 0 || y < 0 || x >= mb_w || y >= mb_h) return nullptr;
    int idx = y * mb_w + x;
    if (idx < first_mb) return nullptr;
    i32* m = mb_state + (i64)idx * MS_N;
    return m[MS_DECODED] ? m : nullptr;
  }

  // ------------------------------------------------------ ctx helpers

  int mb_type_inc() {
    i32* a = mb_at(mbx - 1, mby);
    i32* b = mb_at(mbx, mby - 1);
    return ((a && !a[MS_NXN]) ? 1 : 0) + ((b && !b[MS_NXN]) ? 1 : 0);
  }
  int tx8_inc() {
    i32* a = mb_at(mbx - 1, mby);
    i32* b = mb_at(mbx, mby - 1);
    return ((a && a[MS_TX8]) ? 1 : 0) + ((b && b[MS_TX8]) ? 1 : 0);
  }
  int chroma_mode_inc() {
    i32* a = mb_at(mbx - 1, mby);
    i32* b = mb_at(mbx, mby - 1);
    return ((a && !a[MS_PCM] && a[MS_CMODE] != 0) ? 1 : 0) +
           ((b && !b[MS_PCM] && b[MS_CMODE] != 0) ? 1 : 0);
  }

  static int cbp_luma_nb_bit(const i32* nb, int bit) {
    if (!nb) return 0;
    if (nb[MS_PCM]) return 0;
    return ((nb[MS_CBPL] >> bit) & 1) ? 0 : 1;
  }
  int cbp_luma_inc(int cbp_so_far, int bit) {
    i32* a = mb_at(mbx - 1, mby);
    i32* b = mb_at(mbx, mby - 1);
    if (bit == 0)
      return cbp_luma_nb_bit(a, 1) + 2 * cbp_luma_nb_bit(b, 2);
    if (bit == 1)
      return ((cbp_so_far & 1) ? 0 : 1) + 2 * cbp_luma_nb_bit(b, 3);
    if (bit == 2)
      return cbp_luma_nb_bit(a, 3) + 2 * ((cbp_so_far & 1) ? 0 : 1);
    return ((cbp_so_far & 4) ? 0 : 1) + 2 * ((cbp_so_far & 2) ? 0 : 1);
  }
  int cbp_chroma_inc(int stage) {
    i32* a = mb_at(mbx - 1, mby);
    i32* b = mb_at(mbx, mby - 1);
    auto cond = [&](i32* nb) {
      if (!nb) return 0;
      if (nb[MS_PCM]) return 1;
      if (stage == 0) return nb[MS_CBPC] != 0 ? 1 : 0;
      return nb[MS_CBPC] == 2 ? 1 : 0;
    };
    return cond(a) + 2 * cond(b);
  }

  int cbf_inc(int cat, int blk_x, int blk_y, int plane) {
    if (cat == CAT_LUMA_DC) {
      auto dc_cond = [&](i32* nb, int x, int y) {
        if (!nb) return 1;
        if (nb[MS_PCM]) return 1;
        if (!nb[MS_I16]) return 0;
        return (int)cbf_luma_dc[y * mb_w + x];
      };
      return dc_cond(mb_at(mbx - 1, mby), mbx - 1, mby) +
             2 * dc_cond(mb_at(mbx, mby - 1), mbx, mby - 1);
    }
    if (cat == CAT_LUMA_AC || cat == CAT_LUMA_4X4) {
      int gx = mbx * 4 + blk_x, gy = mby * 4 + blk_y;
      auto l_cond = [&](int x, int y) {
        if (x < 0 || y < 0 || x >= mb_w * 4 || y >= mb_h * 4) return 1;
        i32* nb = mb_at(x / 4, y / 4);
        if (!nb) return 1;
        if (nb[MS_PCM]) return 1;
        return (int)cbf_luma[(i64)y * (mb_w * 4) + x];
      };
      return l_cond(gx - 1, gy) + 2 * l_cond(gx, gy - 1);
    }
    if (cat == CAT_CHROMA_DC) {
      auto cdc_cond = [&](i32* nb, int x, int y) {
        if (!nb) return 1;
        if (nb[MS_PCM]) return 1;
        return (int)cbf_cdc[(i64)(plane - 1) * mb_w * mb_h + y * mb_w + x];
      };
      return cdc_cond(mb_at(mbx - 1, mby), mbx - 1, mby) +
             2 * cdc_cond(mb_at(mbx, mby - 1), mbx, mby - 1);
    }
    int gx = mbx * 2 + blk_x, gy = mby * 2 + blk_y;
    auto ca_cond = [&](int x, int y) {
      if (x < 0 || y < 0 || x >= mb_w * 2 || y >= mb_h * 2) return 1;
      i32* nb = mb_at(x / 2, y / 2);
      if (!nb) return 1;
      if (nb[MS_PCM]) return 1;
      return (int)cbf_cac[(i64)(plane - 1) * (mb_w * 2) * (mb_h * 2) +
                          (i64)y * (mb_w * 2) + x];
    };
    return ca_cond(gx - 1, gy) + 2 * ca_cond(gx, gy - 1);
  }

  int cbf(int cat, int blk_x, int blk_y, int plane) {
    return d.decode_bin(CTX_CBF + 4 * cat + cbf_inc(cat, blk_x, blk_y,
                                                    plane));
  }

  // -------------------------------------------------------- residual

  // coeffs written in scan order; returns nonzero flag
  int residual_block(int cat, int max_coeff, i32* coeffs) {
    memset(coeffs, 0, sizeof(i32) * max_coeff);
    int sig_base, last_base, abs_base;
    if (cat == CAT_LUMA_8X8) {
      sig_base = CTX_SIG_8X8;
      last_base = CTX_LAST_8X8;
      abs_base = CTX_ABS_8X8;
    } else {
      sig_base = CTX_SIG + SIG_CAT_OFF[cat];
      last_base = CTX_LAST + SIG_CAT_OFF[cat];
      abs_base = CTX_ABS + ABS_CAT_OFF[cat];
    }
    int sig[64];
    int n_sig = 0;
    int i = 0;
    bool found_last = false;
    while (i < max_coeff - 1) {
      int s_inc, l_inc;
      if (cat == CAT_LUMA_8X8) {
        s_inc = sig8[i];
        l_inc = last8[i];
      } else if (cat == CAT_CHROMA_DC) {
        s_inc = i < 2 ? i : 2;
        l_inc = s_inc;
      } else {
        s_inc = i;
        l_inc = i;
      }
      if (d.decode_bin(sig_base + s_inc)) {
        sig[n_sig++] = i;
        if (d.decode_bin(last_base + l_inc)) {
          found_last = true;
          break;
        }
      }
      i++;
    }
    if (!found_last) sig[n_sig++] = max_coeff - 1;
    int n_eq1 = 0, n_gt1 = 0;
    int eg_err = 0;
    for (int k = n_sig - 1; k >= 0; k--) {
      int pos = sig[k];
      int level;
      int inc0 = n_gt1 != 0 ? 0 : (1 + n_eq1 < 4 ? 1 + n_eq1 : 4);
      if (d.decode_bin(abs_base + inc0) == 0) {
        level = 1;
        n_eq1++;
      } else {
        int cap = 4 - (cat == CAT_CHROMA_DC ? 1 : 0);
        int inc = 5 + (n_gt1 < cap ? n_gt1 : cap);
        int v = 1;
        while (v < 14 && d.decode_bin(abs_base + inc)) v++;
        if (v == 14) v += d.decode_eg_bypass(0, &eg_err);
        if (eg_err) { fail("EGk runaway"); return 0; }
        level = 1 + v;
        n_gt1++;
      }
      if (d.decode_bypass()) level = -level;
      coeffs[pos] = level;
    }
    return 1;
  }

  // ----------------------------------------------------- dequant

  void dequant4(const i32* c /*4x4*/, int qp_v, i32* out) {
    const i32* ls = ls4 + (qp_v % 6) * 16;
    if (qp_v >= 24) {
      int sh = qp_v / 6 - 4;
      for (int i = 0; i < 16; i++) out[i] = (c[i] * ls[i]) << sh;
    } else {
      int sh = 4 - qp_v / 6;
      int add = 1 << (3 - qp_v / 6);
      for (int i = 0; i < 16; i++) out[i] = (c[i] * ls[i] + add) >> sh;
    }
  }
  void dequant8(const i32* c, int qp_v, i32* out) {
    const i32* ls = ls8 + (qp_v % 6) * 64;
    if (qp_v >= 36) {
      int sh = qp_v / 6 - 6;
      for (int i = 0; i < 64; i++) out[i] = (c[i] * ls[i]) << sh;
    } else {
      int sh = 6 - qp_v / 6;
      int add = 1 << (5 - qp_v / 6);
      for (int i = 0; i < 64; i++) out[i] = (c[i] * ls[i] + add) >> sh;
    }
  }

  // ------------------------------------------------- borders / modes

  bool sample_decoded(int x, int y) {
    int mx = x / 16, my = y / 16;
    int cur_idx = mby * mb_w + mbx;
    int idx = my * mb_w + mx;
    if (idx < first_mb) return false;
    if (idx < cur_idx) return true;
    if (idx > cur_idx) return false;
    int bx = (x % 16) / 4, by = (y % 16) / 4;
    return BLK4_IDX[by][bx] < blk;
  }

  void luma_border(int x0, int y0, int w, Border* b) {
    const u16* Y = planes[0];
    int fw = mb_w * 16;
    b->have_top = y0 > 0 && sample_decoded(x0, y0 - 1);
    b->have_left = x0 > 0 && sample_decoded(x0 - 1, y0);
    b->have_tl = x0 > 0 && y0 > 0 && sample_decoded(x0 - 1, y0 - 1);
    if (b->have_top)
      for (int i = 0; i < w; i++) b->top[i] = Y[(i64)(y0 - 1) * fw + x0 + i];
    if (b->have_left)
      for (int i = 0; i < w; i++) b->left[i] = Y[(i64)(y0 + i) * fw + x0 - 1];
    b->tl = b->have_tl ? Y[(i64)(y0 - 1) * fw + x0 - 1] : 0;
    if (b->have_top) {
      for (int i = 0; i < w; i++) {
        int x = x0 + w + i;
        if (x < fw && sample_decoded(x, y0 - 1))
          b->tr[i] = Y[(i64)(y0 - 1) * fw + x];
        else
          b->tr[i] = i > 0 ? b->tr[i - 1] : Y[(i64)(y0 - 1) * fw + x0 + w - 1];
      }
    }
  }

  int i4_mode_at(int gx, int gy) {
    if (gx < 0 || gy < 0 || gx >= mb_w * 4 || gy >= mb_h * 4) return -1;
    i32* nb = mb_at(gx / 4, gy / 4);
    if (!nb) return -1;
    if (!nb[MS_NXN]) return I4_DC;
    return i4_modes[(i64)gy * (mb_w * 4) + gx];
  }
  int predict_i4_mode(int gx, int gy) {
    int ma = i4_mode_at(gx - 1, gy);
    int mb = i4_mode_at(gx, gy - 1);
    if (ma < 0 || mb < 0) return I4_DC;
    return ma < mb ? ma : mb;
  }

  int decode_chroma_mode() {
    if (d.decode_bin(CTX_CHROMA_PRED + chroma_mode_inc()) == 0) return 0;
    if (d.decode_bin(CTX_CHROMA_PRED + 3) == 0) return 1;
    return 2 + d.decode_bin(CTX_CHROMA_PRED + 3);
  }

  void decode_qp_delta() {
    int inc = prev_qp_delta != 0 ? 1 : 0;
    int val;
    if (d.decode_bin(CTX_MB_QP_DELTA + inc) == 0) {
      val = 0;
    } else {
      int k = 1;
      if (d.decode_bin(CTX_MB_QP_DELTA + 2)) {
        k = 2;
        while (d.decode_bin(CTX_MB_QP_DELTA + 3)) {
          k++;
          if (k > 87) { fail("qp_delta runaway"); return; }
        }
      }
      val = k;
    }
    int delta = (val % 2) ? (val + 1) / 2 : -(val / 2);
    prev_qp_delta = delta;
    qp = (qp + delta + 52) % 52;
    cur_qp_delta = delta;
    mb_qp[mby * mb_w + mbx] = qp;
  }

  int cqp(int qp_y, int plane) {
    int off = plane == 0 ? cb_qp_off : cr_qp_off;
    return chroma_qp_tab[clip3i(0, 51, qp_y + off)];
  }

  // ------------------------------------------------------ chroma recon

  void recon_chroma() {
    i32* curm = cur;
    int qp_y = mb_qp[mby * mb_w + mbx];
    int qpc[2];
    i32 dcs[2][4];
    for (int pl = 1; pl <= 2; pl++) {
      int q = cqp(qp_y, pl - 1);
      qpc[pl - 1] = q;
      i32 dc[4] = {0, 0, 0, 0};
      int dc_nz = 0;
      if (curm[MS_CBPC]) {
        if (cbf(CAT_CHROMA_DC, 0, 0, pl)) {
          residual_block(CAT_CHROMA_DC, 4, dc);
          dc_nz = 1;
        }
      }
      cbf_cdc[(i64)(pl - 1) * mb_w * mb_h + mby * mb_w + mbx] =
          (u8)dc_nz;
      // 2x2 Hadamard + scale (mb.py _recon_chroma)
      i32 c0 = dc[0], c1 = dc[1], c2 = dc[2], c3 = dc[3];
      i32 f[4] = {c0 + c1 + c2 + c3, c0 - c1 + c2 - c3,
                  c0 + c1 - c2 - c3, c0 - c1 - c2 + c3};
      i32 scale = ls4[(q % 6) * 16];     // LEVEL_SCALE_4[q%6,0,0]
      for (int i = 0; i < 4; i++)
        dcs[pl - 1][i] = (i32)((((i64)f[i] * scale) << (q / 6)) >> 5);
    }
    for (int pl = 1; pl <= 2; pl++) {
      int q = qpc[pl - 1];
      int x0 = mbx * 8, y0 = mby * 8;
      int cw = mb_w * 8;
      const u16* C = planes[pl];
      i32 top[8], left[8];
      int tl = 0;
      bool ht = y0 > 0 && mb_nb_decoded(0, -1);
      bool hl = x0 > 0 && mb_nb_decoded(-1, 0);
      bool htl = x0 > 0 && y0 > 0 && mb_nb_decoded(-1, -1);
      if (ht)
        for (int i = 0; i < 8; i++) top[i] = C[(i64)(y0 - 1) * cw + x0 + i];
      if (hl)
        for (int i = 0; i < 8; i++) left[i] = C[(i64)(y0 + i) * cw + x0 - 1];
      if (htl) tl = C[(i64)(y0 - 1) * cw + x0 - 1];
      if ((curm[MS_CMODE] == C_HOR && !hl) ||
          (curm[MS_CMODE] == C_VERT && !ht) ||
          (curm[MS_CMODE] == 3 && !(ht && hl && htl))) {
        fail("intra mode requires unavailable neighbor samples");
        return;
      }
      i32 p[64];
      pred_chroma8(curm[MS_CMODE], ht ? top : nullptr,
                   hl ? left : nullptr, tl, ht, hl, htl, p);
      i32 res[64];
      memset(res, 0, sizeof(res));
      for (int k = 0; k < 4; k++) {
        int bx = k & 1, by = k >> 1;
        i32 blkz[16];
        memset(blkz, 0, sizeof(blkz));
        int nz = 0;
        if (curm[MS_CBPC] == 2) {
          if (cbf(CAT_CHROMA_AC, bx, by, pl)) {
            i32 ac[15];
            residual_block(CAT_CHROMA_AC, 15, ac);
            for (int i = 0; i < 15; i++) blkz[zz4[1 + i]] = ac[i];
            nz = 1;
          }
        }
        cbf_cac[(i64)(pl - 1) * (mb_w * 2) * (mb_h * 2) +
                (i64)(mby * 2 + by) * (mb_w * 2) + mbx * 2 + bx] = (u8)nz;
        i32 d4[16], r4[16];
        dequant4(blkz, q, d4);
        d4[0] = dcs[pl - 1][by * 2 + bx];
        itrans4(d4, r4);
        for (int yy = 0; yy < 4; yy++)
          for (int xx = 0; xx < 4; xx++)
            res[(by * 4 + yy) * 8 + bx * 4 + xx] = r4[yy * 4 + xx];
      }
      u16* Cw = planes[pl];
      for (int yy = 0; yy < 8; yy++)
        for (int xx = 0; xx < 8; xx++)
          Cw[(i64)(y0 + yy) * cw + x0 + xx] =
              (u16)clip3i(0, 255, p[yy * 8 + xx] + res[yy * 8 + xx]);
    }
  }

  bool mb_nb_decoded(int dx, int dy) {
    int x = mbx + dx, y = mby + dy;
    if (x < 0 || y < 0 || x >= mb_w || y >= mb_h) return false;
    int idx = y * mb_w + x;
    return first_mb <= idx && idx < mby * mb_w + mbx;
  }
};

}  // namespace avcn

namespace avcn {

// ------------------------------------------------------ luma recon

// member-style continuation of Slice (kept out of the struct body for
// readability parity with mb.py's method groups)
struct SliceOps {
  Slice& s;

  void recon_i_nxn(const int* modes) {
    i32* cur = s.cur;
    int mbx = s.mbx, mby = s.mby;
    u16* Y = s.planes[0];
    int fw = s.mb_w * 16;
    int qpv = s.mb_qp[mby * s.mb_w + mbx];
    if (cur[MS_TX8]) {
      for (int k = 0; k < 4; k++) {
        int bx = (k & 1) * 2, by = (k >> 1) * 2;
        s.blk = BLK4_IDX[by][bx];
        int x0 = mbx * 16 + bx * 4, y0 = mby * 16 + by * 4;
        Border b;
        s.luma_border(x0, y0, 8, &b);
        if (!intra_mode_ok(modes[k], b.have_top, b.have_left,
                           b.have_tl)) {
          s.fail("intra mode requires unavailable neighbor samples");
          return;
        }
        i32 p[64];
        pred_8x8(modes[k], b, p);
        i32 res[64];
        int nz = 0;
        bool has_res = (cur[MS_CBPL] >> k) & 1;
        if (has_res) {
          i32 coeffs[64], blk64[64], dq[64];
          s.residual_block(CAT_LUMA_8X8, 64, coeffs);
          if (s.rc) return;
          memset(blk64, 0, sizeof(blk64));
          for (int i = 0; i < 64; i++) {
            blk64[s.zz8[i]] = coeffs[i];
            if (coeffs[i]) nz = 1;
          }
          s.dequant8(blk64, qpv, dq);
          itrans8(dq, res);
        } else {
          memset(res, 0, sizeof(res));
        }
        for (int yy = 0; yy < 2; yy++)
          for (int xx = 0; xx < 2; xx++)
            s.cbf_luma[(i64)(mby * 4 + by + yy) * (s.mb_w * 4) +
                       mbx * 4 + bx + xx] = (u8)nz;
        for (int yy = 0; yy < 8; yy++)
          for (int xx = 0; xx < 8; xx++)
            Y[(i64)(y0 + yy) * fw + x0 + xx] =
                (u16)clip3i(0, 255, p[yy * 8 + xx] + res[yy * 8 + xx]);
      }
    } else {
      for (int k = 0; k < 16; k++) {
        int bx = BLK4_X[k], by = BLK4_Y[k];
        s.blk = k;
        int x0 = mbx * 16 + bx * 4, y0 = mby * 16 + by * 4;
        Border b;
        s.luma_border(x0, y0, 4, &b);
        if (!intra_mode_ok(modes[k], b.have_top, b.have_left,
                           b.have_tl)) {
          s.fail("intra mode requires unavailable neighbor samples");
          return;
        }
        i32 p[16];
        pred_4x4(modes[k], b, p);
        int blk8 = (by / 2) * 2 + (bx / 2);
        int nz = 0;
        i32 res[16];
        memset(res, 0, sizeof(res));
        if ((cur[MS_CBPL] >> blk8) & 1) {
          if (s.cbf(CAT_LUMA_4X4, bx, by, 0)) {
            i32 coeffs[16], blk16[16], dq[16];
            s.residual_block(CAT_LUMA_4X4, 16, coeffs);
            if (s.rc) return;
            memset(blk16, 0, sizeof(blk16));
            for (int i = 0; i < 16; i++) blk16[s.zz4[i]] = coeffs[i];
            s.dequant4(blk16, qpv, dq);
            itrans4(dq, res);
            nz = 1;
          }
        }
        s.cbf_luma[(i64)(mby * 4 + by) * (s.mb_w * 4) + mbx * 4 + bx] =
            (u8)nz;
        for (int yy = 0; yy < 4; yy++)
          for (int xx = 0; xx < 4; xx++)
            Y[(i64)(y0 + yy) * fw + x0 + xx] =
                (u16)clip3i(0, 255, p[yy * 4 + xx] + res[yy * 4 + xx]);
      }
    }
    if (!s.mono) s.recon_chroma();
  }

  void recon_i16(int i16_mode) {
    i32* cur = s.cur;
    int mbx = s.mbx, mby = s.mby;
    u16* Y = s.planes[0];
    int fw = s.mb_w * 16;
    int x0 = mbx * 16, y0 = mby * 16;
    s.blk = 0;
    Border b;
    s.luma_border(x0, y0, 16, &b);
    if ((i16_mode == I16_VERT && !b.have_top) ||
        (i16_mode == I16_HOR && !b.have_left) ||
        (i16_mode == 3 && !(b.have_top && b.have_left && b.have_tl))) {
      s.fail("intra mode requires unavailable neighbor samples");
      return;
    }
    i32 p[256];
    pred_16x16(i16_mode, b.have_top ? b.top : nullptr,
               b.have_left ? b.left : nullptr, b.tl,
               b.have_top, b.have_left, b.have_tl, p);
    int qpv = s.mb_qp[mby * s.mb_w + mbx];
    int dc_sig = s.cbf(CAT_LUMA_DC, 0, 0, 0);
    s.cbf_luma_dc[mby * s.mb_w + mbx] = (u8)dc_sig;
    i32 dc[16];
    memset(dc, 0, sizeof(dc));
    if (dc_sig) {
      i32 coeffs[16];
      s.residual_block(CAT_LUMA_DC, 16, coeffs);
      if (s.rc) return;
      for (int i = 0; i < 16; i++) dc[s.zz4[i]] = coeffs[i];
    }
    i32 f[16];
    ihadamard4(dc, f);
    i32 dcs[16];
    i32 ls00 = s.ls4[(qpv % 6) * 16];
    if (qpv >= 36) {
      int sh = qpv / 6 - 6;
      for (int i = 0; i < 16; i++) dcs[i] = (f[i] * ls00) << sh;
    } else {
      int sh = 6 - qpv / 6;
      int add = 1 << (5 - qpv / 6);
      for (int i = 0; i < 16; i++) dcs[i] = (f[i] * ls00 + add) >> sh;
    }
    for (int k = 0; k < 16; k++) {
      int bx = BLK4_X[k], by = BLK4_Y[k];
      i32 blk16[16];
      memset(blk16, 0, sizeof(blk16));
      int nz = 0;
      if (cur[MS_CBPL]) {
        if (s.cbf(CAT_LUMA_AC, bx, by, 0)) {
          i32 ac[15];
          s.residual_block(CAT_LUMA_AC, 15, ac);
          if (s.rc) return;
          for (int i = 0; i < 15; i++) blk16[s.zz4[1 + i]] = ac[i];
          nz = 1;
        }
      }
      s.cbf_luma[(i64)(mby * 4 + by) * (s.mb_w * 4) + mbx * 4 + bx] =
          (u8)nz;
      i32 dq[16], r4[16];
      s.dequant4(blk16, qpv, dq);
      dq[0] = dcs[by * 4 + bx];
      itrans4(dq, r4);
      for (int yy = 0; yy < 4; yy++)
        for (int xx = 0; xx < 4; xx++)
          Y[(i64)(y0 + by * 4 + yy) * fw + x0 + bx * 4 + xx] =
              (u16)clip3i(0, 255,
                          p[(by * 4 + yy) * 16 + bx * 4 + xx] +
                              r4[yy * 4 + xx]);
    }
    if (!s.mono) s.recon_chroma();
  }

  // ------------------------------------------------------------ PCM

  void decode_pcm() {
    Cabac& d = s.d;
    int mbx = s.mbx, mby = s.mby;
    // PCM starts at the first byte the engine has not touched —
    // bytes holding any consumed bit (incl. the 9-bit lookahead)
    // count as used (mb.py _decode_pcm; empirically matches
    // libavcodec's byte-window rollback on x264 streams)
    i64 byte = (d.consumed() + 7) / 8;
    i64 need = 256 + (s.mono ? 0 : 128);
    if (byte < 0 || byte + need > d.size) {
      s.fail("PCM past end of slice data");
      return;
    }
    u16* Y = s.planes[0];
    int fw = s.mb_w * 16;
    int y0 = mby * 16, x0 = mbx * 16;
    for (int yy = 0; yy < 16; yy++)
      for (int xx = 0; xx < 16; xx++)
        Y[(i64)(y0 + yy) * fw + x0 + xx] = d.data[byte + yy * 16 + xx];
    byte += 256;
    if (!s.mono) {
      int cw = s.mb_w * 8;
      for (int pl = 1; pl <= 2; pl++) {
        u16* C = s.planes[pl];
        for (int yy = 0; yy < 8; yy++)
          for (int xx = 0; xx < 8; xx++)
            C[(i64)(y0 / 2 + yy) * cw + x0 / 2 + xx] =
                d.data[byte + yy * 8 + xx];
        byte += 64;
      }
    }
    d.init_at(byte * 8);
    s.mb_qp[mby * s.mb_w + mbx] = s.qp;
    for (int yy = 0; yy < 4; yy++)
      for (int xx = 0; xx < 4; xx++) {
        s.cbf_luma[(i64)(mby * 4 + yy) * (s.mb_w * 4) + mbx * 4 + xx] = 1;
        s.i4_modes[(i64)(mby * 4 + yy) * (s.mb_w * 4) + mbx * 4 + xx] =
            I4_DC;
      }
    s.cbf_luma_dc[mby * s.mb_w + mbx] = 1;
    for (int pl = 0; pl < 2; pl++) {
      s.cbf_cdc[(i64)pl * s.mb_w * s.mb_h + mby * s.mb_w + mbx] = 1;
      for (int yy = 0; yy < 2; yy++)
        for (int xx = 0; xx < 2; xx++)
          s.cbf_cac[(i64)pl * (s.mb_w * 2) * (s.mb_h * 2) +
                    (i64)(mby * 2 + yy) * (s.mb_w * 2) + mbx * 2 + xx] = 1;
    }
  }

  // ----------------------------------------------------------- I_NxN

  void decode_i_nxn() {
    Cabac& d = s.d;
    i32* cur = s.cur;
    int mbx = s.mbx, mby = s.mby;
    if (s.transform_8x8_mode)
      cur[MS_TX8] = d.decode_bin(CTX_TRANSFORM_8X8 + s.tx8_inc());
    int n_blocks = cur[MS_TX8] ? 4 : 16;
    int modes[16];
    for (int k = 0; k < n_blocks; k++) {
      int bx, by;
      if (cur[MS_TX8]) {
        bx = (k & 1) * 2;
        by = (k >> 1) * 2;
      } else {
        bx = BLK4_X[k];
        by = BLK4_Y[k];
      }
      int gx = mbx * 4 + bx, gy = mby * 4 + by;
      int pred = s.predict_i4_mode(gx, gy);
      int mode;
      if (d.decode_bin(CTX_PREV_I4X4)) {
        mode = pred;
      } else {
        int rem = d.decode_bin(CTX_REM_I4X4);
        rem += 2 * d.decode_bin(CTX_REM_I4X4);
        rem += 4 * d.decode_bin(CTX_REM_I4X4);
        mode = rem < pred ? rem : rem + 1;
      }
      modes[k] = mode;
      if (cur[MS_TX8]) {
        for (int yy = 0; yy < 2; yy++)
          for (int xx = 0; xx < 2; xx++)
            s.i4_modes[(i64)(gy + yy) * (s.mb_w * 4) + gx + xx] = mode;
      } else {
        s.i4_modes[(i64)gy * (s.mb_w * 4) + gx] = mode;
      }
    }
    cur[MS_CMODE] = s.mono ? 0 : s.decode_chroma_mode();
    // coded_block_pattern (9.3.3.1.1.4)
    int cbp = 0;
    for (int bit = 0; bit < 4; bit++)
      cbp |= d.decode_bin(CTX_CBP_LUMA + s.cbp_luma_inc(cbp, bit)) << bit;
    int chroma = 0;
    if (!s.mono) {
      if (d.decode_bin(CTX_CBP_CHROMA + s.cbp_chroma_inc(0)))
        chroma = 1 + d.decode_bin(CTX_CBP_CHROMA + 4 + s.cbp_chroma_inc(1));
    }
    cur[MS_CBPL] = cbp;
    cur[MS_CBPC] = chroma;
    if (cbp || chroma) {
      s.decode_qp_delta();
      if (s.rc) return;
    } else {
      s.prev_qp_delta = 0;
      s.mb_qp[mby * s.mb_w + mbx] = s.qp;
    }
    recon_i_nxn(modes);
  }

  // -------------------------------------------------------------- MB

  void decode_mb() {
    Cabac& d = s.d;
    i32* cur = s.cur;
    int inc = s.mb_type_inc();
    if (d.decode_bin(CTX_MB_TYPE_I + inc) == 0) {
      cur[MS_NXN] = 1;
      decode_i_nxn();
    } else if (d.decode_terminate()) {
      cur[MS_PCM] = 1;
      decode_pcm();
    } else {
      int luma_flag = d.decode_bin(CTX_MB_TYPE_I + 3);
      int chroma = 0;
      if (d.decode_bin(CTX_MB_TYPE_I + 4))
        chroma = 1 + d.decode_bin(CTX_MB_TYPE_I + 5);
      int mode = 2 * d.decode_bin(CTX_MB_TYPE_I + 6);
      mode += d.decode_bin(CTX_MB_TYPE_I + 7);
      cur[MS_I16] = 1;
      cur[MS_CBPL] = luma_flag ? 15 : 0;
      cur[MS_CBPC] = chroma;
      cur[MS_CMODE] = s.mono ? 0 : s.decode_chroma_mode();
      s.decode_qp_delta();
      if (s.rc) return;
      recon_i16(mode);
    }
  }

  // slice loop (mb.py decode_slice); returns MBs decoded or -1
  i64 run(i64 start_byte) {
    Cabac& d = s.d;
    d.init_at(start_byte * 8);
    s.prev_qp_delta = 0;
    i64 addr = s.first_mb;
    i64 n = (i64)s.mb_w * s.mb_h;
    while (addr < n) {
      s.mbx = (int)(addr % s.mb_w);
      s.mby = (int)(addr / s.mb_w);
      s.cur = s.mb_state + addr * MS_N;
      memset(s.cur, 0, sizeof(i32) * MS_N);
      s.cur[MS_DECODED] = 1;
      decode_mb();
      if (s.rc) return -1;
      addr++;
      if (d.decode_terminate()) break;
    }
    return addr;
  }
};

// ---------------------------------------------------------- deblock

struct DeblockCtx {
  const u8* alpha_tab;   // 52
  const u8* beta_tab;    // 52
  const i32* tc0_col2;   // 52 (DEBLOCK_TC0[:,2], bS=3)
  int a_off, b_off;
};

// one luma line: v[0..3]=p3..p0, v[4..7]=q0..q3 (deblock.py
// _filter_luma_edge)
static inline void luma_line(i32* v, int alpha, int beta, int bs4,
                             int tc0) {
  i32 p3 = v[0], p2 = v[1], p1 = v[2], p0 = v[3];
  i32 q0 = v[4], q1 = v[5], q2 = v[6], q3 = v[7];
  int fs = (abs(p0 - q0) < alpha) && (abs(p1 - p0) < beta) &&
           (abs(q1 - q0) < beta);
  int ap = abs(p2 - p0) < beta;
  int aq = abs(q2 - q0) < beta;
  if (bs4) {
    int strong = fs && (abs(p0 - q0) < ((alpha >> 2) + 2));
    int sp = strong && ap;
    int sq = strong && aq;
    v[3] = sp ? (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
              : (fs ? (2 * p1 + p0 + q1 + 2) >> 2 : p0);
    v[2] = sp ? (p2 + p1 + p0 + q0 + 2) >> 2 : p1;
    v[1] = sp ? (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3 : p2;
    v[4] = sq ? (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
              : (fs ? (2 * q1 + q0 + p1 + 2) >> 2 : q0);
    v[5] = sq ? (q2 + q1 + q0 + p0 + 2) >> 2 : q1;
    v[6] = sq ? (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3 : q2;
  } else {
    int tc = tc0 + ap + aq;
    i32 delta = clip3i(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    if (fs) {
      v[3] = clip3i(0, 255, p0 + delta);
      v[4] = clip3i(0, 255, q0 - delta);
    }
    i32 dp1 = clip3i(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1);
    i32 dq1 = clip3i(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1);
    if (fs && ap) v[2] = p1 + dp1;
    if (fs && aq) v[5] = q1 + dq1;
  }
}

// one chroma line: v[0]=p1, v[1]=p0, v[2]=q0, v[3]=q1
static inline void chroma_line(i32* v, int alpha, int beta, int bs4,
                               int tc0) {
  i32 p1 = v[0], p0 = v[1], q0 = v[2], q1 = v[3];
  int fs = (abs(p0 - q0) < alpha) && (abs(p1 - p0) < beta) &&
           (abs(q1 - q0) < beta);
  if (!fs) return;
  if (bs4) {
    v[1] = (2 * p1 + p0 + q1 + 2) >> 2;
    v[2] = (2 * q1 + q0 + p1 + 2) >> 2;
  } else {
    int tc = tc0 + 1;
    i32 delta = clip3i(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    v[1] = clip3i(0, 255, p0 + delta);
    v[2] = clip3i(0, 255, q0 - delta);
  }
}

static void luma_edge_v(u16* Y, int fw, int y0, int x, int qp_avg,
                        int bs4, const DeblockCtx& c) {
  int idx_a = clip3i(0, 51, qp_avg + c.a_off);
  int idx_b = clip3i(0, 51, qp_avg + c.b_off);
  int alpha = c.alpha_tab[idx_a], beta = c.beta_tab[idx_b];
  if (alpha == 0 || beta == 0) return;
  int tc0 = (int)c.tc0_col2[idx_a];
  for (int r = 0; r < 16; r++) {
    u16* row = Y + (i64)(y0 + r) * fw + x;
    i32 v[8];
    for (int i = 0; i < 8; i++) v[i] = row[i - 4];
    luma_line(v, alpha, beta, bs4, tc0);
    for (int i = 0; i < 8; i++) row[i - 4] = (u16)v[i];
  }
}

static void luma_edge_h(u16* Y, int fw, int y, int x0, int qp_avg,
                        int bs4, const DeblockCtx& c) {
  int idx_a = clip3i(0, 51, qp_avg + c.a_off);
  int idx_b = clip3i(0, 51, qp_avg + c.b_off);
  int alpha = c.alpha_tab[idx_a], beta = c.beta_tab[idx_b];
  if (alpha == 0 || beta == 0) return;
  int tc0 = (int)c.tc0_col2[idx_a];
  for (int col = 0; col < 16; col++) {
    u16* base = Y + (i64)(y - 4) * fw + x0 + col;
    i32 v[8];
    for (int i = 0; i < 8; i++) v[i] = base[(i64)i * fw];
    luma_line(v, alpha, beta, bs4, tc0);
    for (int i = 0; i < 8; i++) base[(i64)i * fw] = (u16)v[i];
  }
}

static void chroma_edge_v(u16* C, int cw, int y0, int x, int qp_avg,
                          int bs4, const DeblockCtx& c) {
  int idx_a = clip3i(0, 51, qp_avg + c.a_off);
  int idx_b = clip3i(0, 51, qp_avg + c.b_off);
  int alpha = c.alpha_tab[idx_a], beta = c.beta_tab[idx_b];
  if (alpha == 0 || beta == 0) return;
  int tc0 = (int)c.tc0_col2[idx_a];
  for (int r = 0; r < 8; r++) {
    u16* row = C + (i64)(y0 + r) * cw + x;
    i32 v[4];
    for (int i = 0; i < 4; i++) v[i] = row[i - 2];
    chroma_line(v, alpha, beta, bs4, tc0);
    for (int i = 0; i < 4; i++) row[i - 2] = (u16)v[i];
  }
}

static void chroma_edge_h(u16* C, int cw, int y, int x0, int qp_avg,
                          int bs4, const DeblockCtx& c) {
  int idx_a = clip3i(0, 51, qp_avg + c.a_off);
  int idx_b = clip3i(0, 51, qp_avg + c.b_off);
  int alpha = c.alpha_tab[idx_a], beta = c.beta_tab[idx_b];
  if (alpha == 0 || beta == 0) return;
  int tc0 = (int)c.tc0_col2[idx_a];
  for (int col = 0; col < 8; col++) {
    u16* base = C + (i64)(y - 2) * cw + x0 + col;
    i32 v[4];
    for (int i = 0; i < 4; i++) v[i] = base[(i64)i * cw];
    chroma_line(v, alpha, beta, bs4, tc0);
    for (int i = 0; i < 4; i++) base[(i64)i * cw] = (u16)v[i];
  }
}

}  // namespace avcn

// ------------------------------------------------------ C ABI

extern "C" {

// decode one I-slice (codecs/avc/mb.py SliceDecoder.decode_slice).
// params: [mb_w, mb_h, mono, slice_qp, first_mb, transform_8x8_mode,
//          cb_qp_off, cr_qp_off]
// p_state/val_mps: 1024-entry CABAC state, pre-initialized Python-side
// (tables.init_cabac_states(slice_qp)). State arrays (mb_state, mb_qp,
// i4_modes, cbf_*) are Python-owned and persist across slices.
// Returns number of MBs decoded so far (addr after the slice), -1 on
// error with a message in err.
int64_t tpuheif_avc_decode_slice(
    const uint8_t* rbsp, int64_t rbsp_len, int64_t start_byte,
    const int64_t* params, uint8_t* p_state, uint8_t* val_mps,
    const int32_t* sig8, const int32_t* last8, const int32_t* zz4,
    const int32_t* zz8, const int32_t* ls4, const int32_t* ls8,
    const int32_t* chroma_qp_tab, int32_t* mb_state, int32_t* mb_qp,
    int32_t* i4_modes, uint8_t* cbf_luma, uint8_t* cbf_luma_dc,
    uint8_t* cbf_cdc, uint8_t* cbf_cac, uint16_t* y, uint16_t* cb,
    uint16_t* cr, char* err, int64_t errlen) {
  using namespace avcn;
  blk_init();
  Slice s;
  memset(&s, 0, sizeof(s));
  s.mb_w = (int)params[0];
  s.mb_h = (int)params[1];
  s.mono = (int)params[2];
  s.qp = (int)params[3];
  s.first_mb = (int)params[4];
  s.transform_8x8_mode = (int)params[5];
  s.cb_qp_off = (int)params[6];
  s.cr_qp_off = (int)params[7];
  s.sig8 = sig8;
  s.last8 = last8;
  s.zz4 = zz4;
  s.zz8 = zz8;
  s.ls4 = ls4;
  s.ls8 = ls8;
  s.chroma_qp_tab = chroma_qp_tab;
  s.mb_state = mb_state;
  s.mb_qp = mb_qp;
  s.i4_modes = i4_modes;
  s.cbf_luma = cbf_luma;
  s.cbf_luma_dc = cbf_luma_dc;
  s.cbf_cdc = cbf_cdc;
  s.cbf_cac = cbf_cac;
  s.planes[0] = y;
  s.planes[1] = cb;
  s.planes[2] = cr;
  s.err = err;
  s.errlen = (int)errlen;
  s.d.data = rbsp;
  s.d.size = rbsp_len;
  s.d.p_state = p_state;
  s.d.val_mps = val_mps;
  SliceOps ops{s};
  return ops.run(start_byte);
}

// deblock the full frame in place (codecs/avc/deblock.py
// deblock_frame). params: [mb_w, mb_h, mono, a_off, b_off, cb_qp_off,
// cr_qp_off]
void tpuheif_avc_deblock(
    const int64_t* params, const int32_t* mb_state, const int32_t* mb_qp,
    const uint8_t* alpha_tab, const uint8_t* beta_tab,
    const int32_t* tc0_col2, const int32_t* chroma_qp_tab,
    uint16_t* y, uint16_t* cb, uint16_t* cr) {
  using namespace avcn;
  int mb_w = (int)params[0], mb_h = (int)params[1];
  int mono = (int)params[2];
  DeblockCtx c{alpha_tab, beta_tab, tc0_col2, (int)params[3],
               (int)params[4]};
  int cb_off = (int)params[5], cr_off = (int)params[6];
  int fw = mb_w * 16, cw = mb_w * 8;
  uint16_t* planes[3] = {y, cb, cr};
  auto cqp = [&](int qp, int pl) {
    int off = pl == 0 ? cb_off : cr_off;
    return (int)chroma_qp_tab[clip3i(0, 51, qp + off)];
  };
  for (int mby = 0; mby < mb_h; mby++) {
    for (int mbx = 0; mbx < mb_w; mbx++) {
      int idx = mby * mb_w + mbx;
      const int32_t* cur = mb_state + (int64_t)idx * MS_N;
      if (!cur[MS_DECODED]) continue;
      int cur_qp = mb_qp[idx];
      int x0 = mbx * 16, y0 = mby * 16;
      // vertical luma edges, left to right
      if (mbx > 0) {
        const int32_t* nb = mb_state + (int64_t)(idx - 1) * MS_N;
        if (nb[MS_DECODED]) {
          int qp_avg = (mb_qp[idx - 1] + cur_qp + 1) >> 1;
          luma_edge_v(y, fw, y0, x0, qp_avg, 1, c);
        }
      }
      if (cur[MS_TX8]) {
        luma_edge_v(y, fw, y0, x0 + 8, cur_qp, 0, c);
      } else {
        luma_edge_v(y, fw, y0, x0 + 4, cur_qp, 0, c);
        luma_edge_v(y, fw, y0, x0 + 8, cur_qp, 0, c);
        luma_edge_v(y, fw, y0, x0 + 12, cur_qp, 0, c);
      }
      if (!mono) {
        int cx0 = mbx * 8, cy0 = mby * 8;
        if (mbx > 0) {
          const int32_t* nb = mb_state + (int64_t)(idx - 1) * MS_N;
          if (nb[MS_DECODED]) {
            for (int pl = 0; pl < 2; pl++) {
              int qp_avg = (cqp(mb_qp[idx - 1], pl) + cqp(cur_qp, pl) +
                            1) >> 1;
              chroma_edge_v(planes[pl + 1], cw, cy0, cx0, qp_avg, 1, c);
            }
          }
        }
        for (int pl = 0; pl < 2; pl++) {
          int qp_avg = cqp(cur_qp, pl);
          chroma_edge_v(planes[pl + 1], cw, cy0, cx0 + 4, qp_avg, 0, c);
        }
      }
      // horizontal luma edges, top to bottom
      if (mby > 0) {
        const int32_t* nb = mb_state + (int64_t)(idx - mb_w) * MS_N;
        if (nb[MS_DECODED]) {
          int qp_avg = (mb_qp[idx - mb_w] + cur_qp + 1) >> 1;
          luma_edge_h(y, fw, y0, x0, qp_avg, 1, c);
        }
      }
      if (cur[MS_TX8]) {
        luma_edge_h(y, fw, y0 + 8, x0, cur_qp, 0, c);
      } else {
        luma_edge_h(y, fw, y0 + 4, x0, cur_qp, 0, c);
        luma_edge_h(y, fw, y0 + 8, x0, cur_qp, 0, c);
        luma_edge_h(y, fw, y0 + 12, x0, cur_qp, 0, c);
      }
      if (!mono) {
        int cx0 = mbx * 8, cy0 = mby * 8;
        if (mby > 0) {
          const int32_t* nb = mb_state + (int64_t)(idx - mb_w) * MS_N;
          if (nb[MS_DECODED]) {
            for (int pl = 0; pl < 2; pl++) {
              int qp_avg = (cqp(mb_qp[idx - mb_w], pl) + cqp(cur_qp, pl) +
                            1) >> 1;
              chroma_edge_h(planes[pl + 1], cw, cy0, cx0, qp_avg, 1, c);
            }
          }
        }
        for (int pl = 0; pl < 2; pl++) {
          int qp_avg = cqp(cur_qp, pl);
          chroma_edge_h(planes[pl + 1], cw, cy0 + 4, cx0, qp_avg, 0, c);
        }
      }
    }
  }
}

}  // extern "C"

// ======================================================================
// AVC intra encoder (codecs/avc/encoder.py SliceEncoder) — byte-exact
// native port: same mode decisions, same bin stream, same recon.
// ======================================================================

namespace avcn {

// M-coder encoder (encoder.py AvcCabacEncoder; spec 9.3.4)
struct CabacEnc {
  u8* out;
  i64 cap, nbytes;
  int acc, nbits;
  u8* p_state;
  u8* val_mps;
  int low, range, bits_outstanding;
  bool first_bit;
  int overflow;

  void init(u8* buf, i64 capacity, u8* ps, u8* vm) {
    out = buf;
    cap = capacity;
    nbytes = 0;
    acc = 0;
    nbits = 0;
    p_state = ps;
    val_mps = vm;
    low = 0;
    range = 510;
    bits_outstanding = 0;
    first_bit = true;
    overflow = 0;
  }
  inline void put_raw(int b) {
    acc = (acc << 1) | b;
    if (++nbits == 8) {
      if (nbytes < cap) out[nbytes] = (u8)acc;
      else overflow = 1;
      nbytes++;
      acc = 0;
      nbits = 0;
    }
  }
  inline void put_bit(int b) {
    if (first_bit) first_bit = false;
    else put_raw(b);
    while (bits_outstanding > 0) {
      put_raw(1 - b);
      bits_outstanding--;
    }
  }
  inline void renorm() {
    while (range < 256) {
      if (low < 256) {
        put_bit(0);
      } else if (low >= 512) {
        put_bit(1);
        low -= 512;
      } else {
        bits_outstanding++;
        low -= 256;
      }
      low <<= 1;
      range <<= 1;
    }
  }
  inline void encode_bin(int ctx, int binval) {
    int ps = p_state[ctx];
    int lps = kRangeTabLPS[ps][(range >> 6) & 3];
    range -= lps;
    if (binval != val_mps[ctx]) {
      low += range;
      range = lps;
      if (ps == 0) val_mps[ctx] = (u8)(1 - val_mps[ctx]);
      p_state[ctx] = kTransIdxLPS[ps];
    } else {
      p_state[ctx] = kTransIdxMPS[ps];
    }
    renorm();
  }
  inline void encode_bypass(int binval) {
    low <<= 1;
    if (binval) low += range;
    if (low >= 1024) {
      put_bit(1);
      low -= 1024;
    } else if (low < 512) {
      put_bit(0);
    } else {
      bits_outstanding++;
      low -= 512;
    }
  }
  inline void encode_bypass_bits(int value, int n) {
    for (int i = n - 1; i >= 0; i--) encode_bypass((value >> i) & 1);
  }
  inline void encode_terminate(int binval) {
    range -= 2;
    if (binval) low += range;
    else renorm();
  }
  void encode_eg_bypass(int k, int value) {
    int leading = 0;
    while (value >= ((1 << leading) << k)) {
      value -= (1 << leading) << k;
      leading++;
    }
    for (int i = 0; i < leading; i++) encode_bypass(1);
    encode_bypass(0);
    if (leading + k) encode_bypass_bits(value, leading + k);
  }
  void flush() {
    range = 2;
    renorm();
    put_bit((low >> 9) & 1);
    put_raw((low >> 8) & 1);
    put_raw(1);   // rbsp_stop_one_bit
  }
  i64 finish() {
    if (nbits) {
      if (nbytes < cap) out[nbytes] = (u8)(acc << (8 - nbits));
      else overflow = 1;
      nbytes++;
      acc = 0;
      nbits = 0;
    }
    return nbytes;
  }
};

// forward transforms (encoder.py ftrans4/fhadamard4/ftrans8)

static void ftrans4_rowpass(const i64* d, i64* o) {
  for (int r = 0; r < 4; r++) {
    i64 s03 = d[r * 4 + 0] + d[r * 4 + 3];
    i64 s12 = d[r * 4 + 1] + d[r * 4 + 2];
    i64 d03 = d[r * 4 + 0] - d[r * 4 + 3];
    i64 d12 = d[r * 4 + 1] - d[r * 4 + 2];
    o[r * 4 + 0] = s03 + s12;
    o[r * 4 + 1] = 2 * d03 + d12;
    o[r * 4 + 2] = s03 - s12;
    o[r * 4 + 3] = d03 - 2 * d12;
  }
}

static void enc_ftrans4(const i64* b, i64* out) {
  i64 f[16], ft[16], g[16];
  ftrans4_rowpass(b, f);
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) ft[i * 4 + j] = f[j * 4 + i];
  ftrans4_rowpass(ft, g);
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) out[i * 4 + j] = g[j * 4 + i];
}

static void fhad4_rowpass(const i64* d, i64* o) {
  for (int r = 0; r < 4; r++) {
    i64 s03 = d[r * 4 + 0] + d[r * 4 + 3];
    i64 s12 = d[r * 4 + 1] + d[r * 4 + 2];
    i64 d03 = d[r * 4 + 0] - d[r * 4 + 3];
    i64 d12 = d[r * 4 + 1] - d[r * 4 + 2];
    o[r * 4 + 0] = s03 + s12;
    o[r * 4 + 1] = d03 + d12;
    o[r * 4 + 2] = s03 - s12;
    o[r * 4 + 3] = d03 - d12;
  }
}

static void enc_fhadamard4(const i64* b, i64* out) {
  i64 f[16], ft[16], g[16];
  fhad4_rowpass(b, f);
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) ft[i * 4 + j] = f[j * 4 + i];
  fhad4_rowpass(ft, g);
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) out[i * 4 + j] = g[j * 4 + i] >> 1;
}

static void ftrans8_1d(const i64* s, i64* o) {
  i64 a0 = s[0], a1 = s[1], a2 = s[2], a3 = s[3], a4 = s[4], a5 = s[5],
      a6 = s[6], a7 = s[7];
  i64 s07 = a0 + a7, s16 = a1 + a6, s25 = a2 + a5, s34 = a3 + a4;
  i64 b0 = s07 + s34, b1 = s16 + s25, b2 = s07 - s34, b3 = s16 - s25;
  i64 d07 = a0 - a7, d16 = a1 - a6, d25 = a2 - a5, d34 = a3 - a4;
  i64 b4 = d16 + d25 + (d07 + (d07 >> 1));
  i64 b5 = d07 - d34 - (d25 + (d25 >> 1));
  i64 b6 = d07 + d34 - (d16 + (d16 >> 1));
  i64 b7 = d16 - d25 + (d34 + (d34 >> 1));
  o[0] = b0 + b1;
  o[1] = b4 + (b7 >> 2);
  o[2] = b2 + (b3 >> 1);
  o[3] = b5 + (b6 >> 2);
  o[4] = b0 - b1;
  o[5] = b6 - (b5 >> 2);
  o[6] = (b2 >> 1) - b3;
  o[7] = (b4 >> 2) - b7;
}

static void enc_ftrans8(const i64* b, i64* out) {
  i64 f[64], ft[64], g[64];
  for (int r = 0; r < 8; r++) ftrans8_1d(b + r * 8, f + r * 8);
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) ft[i * 8 + j] = f[j * 8 + i];
  for (int r = 0; r < 8; r++) ftrans8_1d(ft + r * 8, g + r * 8);
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) out[i * 8 + j] = g[j * 8 + i];
}

// quantization (encoder.py quant4/quant8/quant_dc4/quant_dc2); mf
// tables passed from Python (MF4 6x16, MF8 6x64 flattened)
static inline i32 q_one(i64 c, i64 mf, i64 f, int qbits) {
  i64 lvl = ((c < 0 ? -c : c) * mf + f) >> qbits;
  return (i32)(c < 0 ? -lvl : lvl);
}

}  // namespace avcn

namespace avcn {

struct ChPlane {
  i32 pred[64];
  i32 dc[4];
  i32 ac[4][15];
  int q;
};

struct Enc {
  Slice& s;
  CabacEnc& e;
  const u8* src[3];
  int tx8_policy;          // 0 never, 1 always, 2 alternate, 3 auto
  const i32* mf4;          // 6*16
  const i32* mf8;          // 6*64

  // ---------------------------------------------------------- quant
  void quant4_blk(const i64* c, int qp, i32* out) {
    int qbits = 15 + qp / 6;
    i64 f = ((i64)1 << qbits) / 3;
    const i32* mf = mf4 + (qp % 6) * 16;
    for (int i = 0; i < 16; i++) out[i] = q_one(c[i], mf[i], f, qbits);
  }
  void quant8_blk(const i64* c, int qp, i32* out) {
    int qbits = 16 + qp / 6;
    i64 f = ((i64)1 << qbits) / 3;
    const i32* mf = mf8 + (qp % 6) * 64;
    for (int i = 0; i < 64; i++) out[i] = q_one(c[i], mf[i], f, qbits);
  }
  void quant_dc4_blk(const i64* c, int qp, i32* out) {
    int qbits = 15 + qp / 6;
    i64 f = ((i64)1 << qbits) / 3;
    i64 mf = mf4[(qp % 6) * 16];
    for (int i = 0; i < 16; i++)
      out[i] = q_one(c[i], mf, 2 * f, qbits + 1);
  }
  void quant_dc2_blk(const i64* c, int qp, i32* out) {
    int qbits = 15 + qp / 6;
    i64 f = ((i64)1 << qbits) / 3;
    i64 mf = mf4[(qp % 6) * 16];
    for (int i = 0; i < 4; i++)
      out[i] = q_one(c[i], mf, 2 * f, qbits + 1);
  }

  // ------------------------------------------------------- emitters

  void emit_chroma_mode(int mode) {
    e.encode_bin(CTX_CHROMA_PRED + s.chroma_mode_inc(),
                 mode == 0 ? 0 : 1);
    if (mode > 0) {
      e.encode_bin(CTX_CHROMA_PRED + 3, mode == 1 ? 0 : 1);
      if (mode > 1) e.encode_bin(CTX_CHROMA_PRED + 3, mode - 2);
    }
  }

  void emit_qp_delta(int delta) {
    int inc = s.prev_qp_delta != 0 ? 1 : 0;
    int val = delta > 0 ? 2 * delta - 1 : -2 * delta;
    if (val == 0) {
      e.encode_bin(CTX_MB_QP_DELTA + inc, 0);
    } else {
      e.encode_bin(CTX_MB_QP_DELTA + inc, 1);
      if (val == 1) {
        e.encode_bin(CTX_MB_QP_DELTA + 2, 0);
      } else {
        e.encode_bin(CTX_MB_QP_DELTA + 2, 1);
        for (int i = 0; i < val - 2; i++)
          e.encode_bin(CTX_MB_QP_DELTA + 3, 1);
        e.encode_bin(CTX_MB_QP_DELTA + 3, 0);
      }
    }
    s.prev_qp_delta = delta;
    s.qp = (s.qp + delta + 52) % 52;
    s.mb_qp[s.mby * s.mb_w + s.mbx] = s.qp;
  }

  // encoder.py _emit_residual: scan holds levels, >=1 nonzero
  void emit_residual(int cat, const i32* scan, int max_coeff) {
    int sig_base, last_base, abs_base;
    if (cat == CAT_LUMA_8X8) {
      sig_base = CTX_SIG_8X8;
      last_base = CTX_LAST_8X8;
      abs_base = CTX_ABS_8X8;
    } else {
      sig_base = CTX_SIG + SIG_CAT_OFF[cat];
      last_base = CTX_LAST + SIG_CAT_OFF[cat];
      abs_base = CTX_ABS + ABS_CAT_OFF[cat];
    }
    int sig[64], n_sig = 0;
    for (int i = 0; i < max_coeff; i++)
      if (scan[i]) sig[n_sig++] = i;
    int last_pos = sig[n_sig - 1];
    int stop = last_pos + 1 < max_coeff - 1 ? last_pos + 1 : max_coeff - 1;
    for (int i = 0; i < stop; i++) {
      int s_inc, l_inc;
      if (cat == CAT_LUMA_8X8) {
        s_inc = s.sig8[i];
        l_inc = s.last8[i];
      } else if (cat == CAT_CHROMA_DC) {
        s_inc = i < 2 ? i : 2;
        l_inc = s_inc;
      } else {
        s_inc = i;
        l_inc = i;
      }
      if (scan[i]) {
        e.encode_bin(sig_base + s_inc, 1);
        e.encode_bin(last_base + l_inc, i == last_pos ? 1 : 0);
      } else {
        e.encode_bin(sig_base + s_inc, 0);
      }
    }
    int n_eq1 = 0, n_gt1 = 0;
    for (int k = n_sig - 1; k >= 0; k--) {
      int level = scan[sig[k]];
      int mag = level < 0 ? -level : level;
      int inc0 = n_gt1 != 0 ? 0 : (1 + n_eq1 < 4 ? 1 + n_eq1 : 4);
      if (mag == 1) {
        e.encode_bin(abs_base + inc0, 0);
        n_eq1++;
      } else {
        e.encode_bin(abs_base + inc0, 1);
        int cap = 4 - (cat == CAT_CHROMA_DC ? 1 : 0);
        int inc = 5 + (n_gt1 < cap ? n_gt1 : cap);
        int v = mag - 1;
        if (v < 14) {
          for (int i = 0; i < v - 1; i++)
            e.encode_bin(abs_base + inc, 1);
          e.encode_bin(abs_base + inc, 0);
        } else {
          for (int i = 0; i < 13; i++) e.encode_bin(abs_base + inc, 1);
          e.encode_eg_bypass(0, v - 14);
        }
        n_gt1++;
      }
      e.encode_bypass(level < 0 ? 1 : 0);
    }
  }

  // ------------------------------------------------ chroma decision

  void chroma_border_enc(int pl, int x0, int y0, i32* top, i32* left,
                         int* tl, bool* ht, bool* hl, bool* htl) {
    const u16* C = s.planes[pl];
    int cw = s.mb_w * 8;
    *ht = y0 > 0 && s.mb_nb_decoded(0, -1);
    *hl = x0 > 0 && s.mb_nb_decoded(-1, 0);
    *htl = x0 > 0 && y0 > 0 && s.mb_nb_decoded(-1, -1);
    if (*ht)
      for (int i = 0; i < 8; i++) top[i] = C[(i64)(y0 - 1) * cw + x0 + i];
    if (*hl)
      for (int i = 0; i < 8; i++) left[i] = C[(i64)(y0 + i) * cw + x0 - 1];
    *tl = *htl ? C[(i64)(y0 - 1) * cw + x0 - 1] : 0;
  }

  // encoder.py _chroma_levels; returns cbp (0/1/2) and mode
  int chroma_levels(ChPlane ch[2], int* mode_out) {
    int mbx = s.mbx, mby = s.mby;
    int x0 = mbx * 8, y0 = mby * 8;
    int cw = s.mb_w * 8;
    i32 topb[2][8], leftb[2][8];
    int tlb[2];
    bool htb[2], hlb[2], htlb[2];
    for (int pl = 1; pl <= 2; pl++)
      chroma_border_enc(pl, x0, y0, topb[pl - 1], leftb[pl - 1],
                        &tlb[pl - 1], &htb[pl - 1], &hlb[pl - 1],
                        &htlb[pl - 1]);
    // candidates in encoder.py order: DC, HOR?, VERT?, PLANE?
    int cands[4], n_cands = 0;
    cands[n_cands++] = 0;
    if (hlb[0]) cands[n_cands++] = C_HOR;
    if (htb[0]) cands[n_cands++] = C_VERT;
    if (htb[0] && hlb[0] && htlb[0]) cands[n_cands++] = 3;
    i64 srcs[2][64];
    for (int pl = 1; pl <= 2; pl++)
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
          srcs[pl - 1][i * 8 + j] =
              src[pl][(i64)(y0 + i) * cw + x0 + j];
    int best_m = 0;
    i64 best_sse = -1;
    for (int c = 0; c < n_cands; c++) {
      int m = cands[c];
      i64 sse = 0;
      for (int pl = 1; pl <= 2; pl++) {
        i32 p[64];
        pred_chroma8(m, htb[pl - 1] ? topb[pl - 1] : nullptr,
                     hlb[pl - 1] ? leftb[pl - 1] : nullptr, tlb[pl - 1],
                     htb[pl - 1], hlb[pl - 1], htlb[pl - 1], p);
        for (int i = 0; i < 64; i++) {
          i64 d = srcs[pl - 1][i] - p[i];
          sse += d * d;
        }
      }
      if (best_sse < 0 || sse < best_sse) {
        best_m = m;
        best_sse = sse;
      }
    }
    *mode_out = best_m;
    int qp_y = s.qp;
    bool any_dc = false, any_ac = false;
    for (int pl = 1; pl <= 2; pl++) {
      ChPlane& cp = ch[pl - 1];
      int q = s.cqp(qp_y, pl - 1);
      cp.q = q;
      pred_chroma8(best_m, htb[pl - 1] ? topb[pl - 1] : nullptr,
                   hlb[pl - 1] ? leftb[pl - 1] : nullptr, tlb[pl - 1],
                   htb[pl - 1], hlb[pl - 1], htlb[pl - 1], cp.pred);
      i64 dcs[4];
      for (int k = 0; k < 4; k++) {
        int bx = k & 1, by = k >> 1;
        i64 resid[16];
        for (int i = 0; i < 4; i++)
          for (int j = 0; j < 4; j++)
            resid[i * 4 + j] =
                srcs[pl - 1][(by * 4 + i) * 8 + bx * 4 + j] -
                cp.pred[(by * 4 + i) * 8 + bx * 4 + j];
        i64 coef[16];
        enc_ftrans4(resid, coef);
        dcs[k] = coef[0];
        i32 qv[16];
        quant4_blk(coef, q, qv);
        qv[0] = 0;
        for (int i = 0; i < 15; i++) cp.ac[k][i] = qv[s.zz4[1 + i]];
        for (int i = 0; i < 15; i++)
          if (cp.ac[k][i]) any_ac = true;
      }
      // 2x2 forward hadamard on (raster) DCs
      i64 fdc[4] = {dcs[0] + dcs[1] + dcs[2] + dcs[3],
                    dcs[0] - dcs[1] + dcs[2] - dcs[3],
                    dcs[0] + dcs[1] - dcs[2] - dcs[3],
                    dcs[0] - dcs[1] - dcs[2] + dcs[3]};
      quant_dc2_blk(fdc, q, cp.dc);
      for (int i = 0; i < 4; i++)
        if (cp.dc[i]) any_dc = true;
    }
    int cbp = any_ac ? 2 : (any_dc ? 1 : 0);
    if (cbp < 2)
      for (int pl = 0; pl < 2; pl++)
        memset(ch[pl].ac, 0, sizeof(ch[pl].ac));
    if (cbp == 0)
      for (int pl = 0; pl < 2; pl++)
        memset(ch[pl].dc, 0, sizeof(ch[pl].dc));
    return cbp;
  }

  // encoder.py _emit_and_recon_chroma
  void emit_and_recon_chroma(int cbp, ChPlane ch[2]) {
    int mbx = s.mbx, mby = s.mby;
    int x0 = mbx * 8, y0 = mby * 8;
    int cw = s.mb_w * 8;
    i64 dcs_pl[2][4];
    for (int pl = 1; pl <= 2; pl++) {
      ChPlane& cp = ch[pl - 1];
      int dc_nz = 0;
      for (int i = 0; i < 4; i++)
        if (cp.dc[i]) dc_nz = 1;
      if (cbp) {
        int inc = s.cbf_inc(CAT_CHROMA_DC, 0, 0, pl);
        e.encode_bin(CTX_CBF + 4 * CAT_CHROMA_DC + inc, dc_nz);
        s.cbf_cdc[(i64)(pl - 1) * s.mb_w * s.mb_h + mby * s.mb_w + mbx] =
            (u8)dc_nz;
        if (dc_nz) emit_residual(CAT_CHROMA_DC, cp.dc, 4);
      } else {
        s.cbf_cdc[(i64)(pl - 1) * s.mb_w * s.mb_h + mby * s.mb_w + mbx] =
            0;
      }
      i64 c0 = cp.dc[0], c1 = cp.dc[1], c2 = cp.dc[2], c3 = cp.dc[3];
      i64 f[4] = {c0 + c1 + c2 + c3, c0 - c1 + c2 - c3,
                  c0 + c1 - c2 - c3, c0 - c1 - c2 + c3};
      i64 scale = s.ls4[(cp.q % 6) * 16];
      for (int i = 0; i < 4; i++)
        dcs_pl[pl - 1][i] = ((f[i] * scale) << (cp.q / 6)) >> 5;
    }
    for (int pl = 1; pl <= 2; pl++) {
      ChPlane& cp = ch[pl - 1];
      u16* C = s.planes[pl];
      for (int k = 0; k < 4; k++) {
        int bx = k & 1, by = k >> 1;
        int nz = 0;
        if (cbp == 2) {
          for (int i = 0; i < 15; i++)
            if (cp.ac[k][i]) nz = 1;
          int inc = s.cbf_inc(CAT_CHROMA_AC, bx, by, pl);
          e.encode_bin(CTX_CBF + 4 * CAT_CHROMA_AC + inc, nz);
          s.cbf_cac[(i64)(pl - 1) * (s.mb_w * 2) * (s.mb_h * 2) +
                    (i64)(mby * 2 + by) * (s.mb_w * 2) + mbx * 2 + bx] =
              (u8)nz;
          if (nz) emit_residual(CAT_CHROMA_AC, cp.ac[k], 15);
        } else {
          s.cbf_cac[(i64)(pl - 1) * (s.mb_w * 2) * (s.mb_h * 2) +
                    (i64)(mby * 2 + by) * (s.mb_w * 2) + mbx * 2 + bx] =
              0;
        }
        i32 blk[16], d4[16], r4[16];
        memset(blk, 0, sizeof(blk));
        if (nz)
          for (int i = 0; i < 15; i++) blk[s.zz4[1 + i]] = cp.ac[k][i];
        s.dequant4(blk, cp.q, d4);
        d4[0] = (i32)dcs_pl[pl - 1][by * 2 + bx];
        itrans4(d4, r4);
        for (int i = 0; i < 4; i++)
          for (int j = 0; j < 4; j++)
            C[(i64)(y0 + by * 4 + i) * cw + x0 + bx * 4 + j] =
                (u16)clip3i(0, 255,
                            cp.pred[(by * 4 + i) * 8 + bx * 4 + j] +
                                r4[i * 4 + j]);
      }
    }
  }
};

}  // namespace avcn

namespace avcn {

struct EncOps {
  Enc& E;
  Slice& s;
  CabacEnc& e;
  EncOps(Enc& enc) : E(enc), s(enc.s), e(enc.e) {}

  // --------------------------------------------------------- I16 MB

  void encode_i16_mb(int mode) {
    i32* cur = s.cur;
    int mbx = s.mbx, mby = s.mby;
    int x0 = mbx * 16, y0 = mby * 16;
    int fw = s.mb_w * 16;
    int qp = s.qp;
    i64 srcb[256];
    for (int i = 0; i < 16; i++)
      for (int j = 0; j < 16; j++)
        srcb[i * 16 + j] = E.src[0][(i64)(y0 + i) * fw + x0 + j];
    s.blk = 0;
    Border b;
    s.luma_border(x0, y0, 16, &b);
    i32 p[256];
    pred_16x16(mode, b.have_top ? b.top : nullptr,
               b.have_left ? b.left : nullptr, b.tl, b.have_top,
               b.have_left, b.have_tl, p);
    // forward transform all 16 4x4 blocks; collect DCs (raster 4x4)
    i64 dcr[16];
    i32 acq[16][16];        // [blk raster by*4+bx][raster coeffs]
    int any_ac = 0;
    for (int by = 0; by < 4; by++)
      for (int bx = 0; bx < 4; bx++) {
        i64 resid[16], coef[16];
        for (int i = 0; i < 4; i++)
          for (int j = 0; j < 4; j++)
            resid[i * 4 + j] = srcb[(by * 4 + i) * 16 + bx * 4 + j] -
                               p[(by * 4 + i) * 16 + bx * 4 + j];
        enc_ftrans4(resid, coef);
        dcr[by * 4 + bx] = coef[0];
        E.quant4_blk(coef, qp, acq[by * 4 + bx]);
        acq[by * 4 + bx][0] = 0;
        for (int i = 1; i < 16; i++)
          if (acq[by * 4 + bx][i]) any_ac = 1;
      }
    i64 fh[16];
    enc_fhadamard4(dcr, fh);
    i32 dcq[16];
    E.quant_dc4_blk(fh, qp, dcq);

    int cbp_luma = any_ac ? 15 : 0;
    cur[MS_I16] = 1;
    cur[MS_CBPL] = cbp_luma;

    ChPlane ch[2];
    int cmode = 0, cbp_chroma = 0;
    if (!s.mono) cbp_chroma = E.chroma_levels(ch, &cmode);
    cur[MS_CBPC] = cbp_chroma;
    cur[MS_CMODE] = cmode;

    // mb_type bins
    e.encode_bin(CTX_MB_TYPE_I + s.mb_type_inc(), 1);
    e.encode_terminate(0);
    e.encode_bin(CTX_MB_TYPE_I + 3, cbp_luma ? 1 : 0);
    if (cbp_chroma == 0) {
      e.encode_bin(CTX_MB_TYPE_I + 4, 0);
    } else {
      e.encode_bin(CTX_MB_TYPE_I + 4, 1);
      e.encode_bin(CTX_MB_TYPE_I + 5, cbp_chroma - 1);
    }
    e.encode_bin(CTX_MB_TYPE_I + 6, mode >> 1);
    e.encode_bin(CTX_MB_TYPE_I + 7, mode & 1);

    if (!s.mono) E.emit_chroma_mode(cmode);
    E.emit_qp_delta(0);

    // luma DC
    i32 dc_scan[16];
    for (int i = 0; i < 16; i++) dc_scan[i] = dcq[s.zz4[i]];
    int dc_sig = 0;
    for (int i = 0; i < 16; i++)
      if (dc_scan[i]) dc_sig = 1;
    int inc = s.cbf_inc(CAT_LUMA_DC, 0, 0, 0);
    e.encode_bin(CTX_CBF + 4 * CAT_LUMA_DC + inc, dc_sig);
    s.cbf_luma_dc[mby * s.mb_w + mbx] = (u8)dc_sig;
    if (dc_sig) E.emit_residual(CAT_LUMA_DC, dc_scan, 16);

    // recon DC exactly as the decoder
    i32 dcd[16];
    memset(dcd, 0, sizeof(dcd));
    for (int i = 0; i < 16; i++) dcd[s.zz4[i]] = dc_scan[i];
    i32 f[16];
    ihadamard4(dcd, f);
    i32 dcs[16];
    i32 ls00 = s.ls4[(qp % 6) * 16];
    if (qp >= 36) {
      int sh = qp / 6 - 6;
      for (int i = 0; i < 16; i++) dcs[i] = (f[i] * ls00) << sh;
    } else {
      int sh = 6 - qp / 6;
      int add = 1 << (5 - qp / 6);
      for (int i = 0; i < 16; i++) dcs[i] = (f[i] * ls00 + add) >> sh;
    }

    u16* Y = s.planes[0];
    for (int k = 0; k < 16; k++) {
      int bx = BLK4_X[k], by = BLK4_Y[k];
      i32 ac_scan[15];
      const i32* q = acq[by * 4 + bx];
      for (int i = 0; i < 15; i++) ac_scan[i] = q[s.zz4[1 + i]];
      int nz = 0;
      if (cbp_luma) {
        for (int i = 0; i < 15; i++)
          if (ac_scan[i]) nz = 1;
        int inc2 = s.cbf_inc(CAT_LUMA_AC, bx, by, 0);
        e.encode_bin(CTX_CBF + 4 * CAT_LUMA_AC + inc2, nz);
        s.cbf_luma[(i64)(mby * 4 + by) * (s.mb_w * 4) + mbx * 4 + bx] =
            (u8)nz;
        if (nz) E.emit_residual(CAT_LUMA_AC, ac_scan, 15);
      } else {
        s.cbf_luma[(i64)(mby * 4 + by) * (s.mb_w * 4) + mbx * 4 + bx] = 0;
      }
      i32 blk[16], d4[16], r4[16];
      memset(blk, 0, sizeof(blk));
      if (nz)
        for (int i = 0; i < 15; i++) blk[s.zz4[1 + i]] = ac_scan[i];
      s.dequant4(blk, qp, d4);
      d4[0] = dcs[by * 4 + bx];
      itrans4(d4, r4);
      for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++)
          Y[(i64)(y0 + by * 4 + i) * fw + x0 + bx * 4 + j] =
              (u16)clip3i(0, 255,
                          p[(by * 4 + i) * 16 + bx * 4 + j] +
                              r4[i * 4 + j]);
    }
    if (!s.mono) E.emit_and_recon_chroma(cur[MS_CBPC], ch);
    s.mb_qp[mby * s.mb_w + mbx] = s.qp;
  }

  // --------------------------------------------------------- NxN MB

  bool choose_tx8() {
    if (!s.transform_8x8_mode) return false;
    if (E.tx8_policy == 0) return false;
    if (E.tx8_policy == 1) return true;
    if (E.tx8_policy == 2) return (s.mbx + s.mby) % 2 == 0;
    // auto: smooth MBs -> 8x8 (mean abs gradient, double like numpy)
    int x0 = s.mbx * 16, y0 = s.mby * 16;
    int fw = s.mb_w * 16;
    i64 sx = 0, sy = 0;
    for (int i = 0; i < 16; i++)
      for (int j = 0; j < 15; j++) {
        i64 d = (i64)E.src[0][(i64)(y0 + i) * fw + x0 + j + 1] -
                E.src[0][(i64)(y0 + i) * fw + x0 + j];
        sx += d < 0 ? -d : d;
      }
    for (int i = 0; i < 15; i++)
      for (int j = 0; j < 16; j++) {
        i64 d = (i64)E.src[0][(i64)(y0 + i + 1) * fw + x0 + j] -
                E.src[0][(i64)(y0 + i) * fw + x0 + j];
        sy += d < 0 ? -d : d;
      }
    return (sx / 240.0 + sy / 240.0) < 12.0;
  }

  void encode_nxn_mb() {
    i32* cur = s.cur;
    int mbx = s.mbx, mby = s.mby;
    cur[MS_NXN] = 1;
    cur[MS_TX8] = choose_tx8() ? 1 : 0;

    e.encode_bin(CTX_MB_TYPE_I + s.mb_type_inc(), 0);
    if (s.transform_8x8_mode)
      e.encode_bin(CTX_TRANSFORM_8X8 + s.tx8_inc(), cur[MS_TX8]);

    int n_blocks = cur[MS_TX8] ? 4 : 16;
    int modes[16];
    i32 coeffs_scan[16][64];
    int scan_any[16];
    int qp = s.qp;
    u16* Y = s.planes[0];
    int fw = s.mb_w * 16;

    for (int k = 0; k < n_blocks; k++) {
      int bx, by, bw;
      if (cur[MS_TX8]) {
        bx = (k & 1) * 2;
        by = (k >> 1) * 2;
        bw = 8;
      } else {
        bx = BLK4_X[k];
        by = BLK4_Y[k];
        bw = 4;
      }
      s.blk = BLK4_IDX[by][bx];
      int x0 = mbx * 16 + bx * 4, y0 = mby * 16 + by * 4;
      int gx = mbx * 4 + bx, gy = mby * 4 + by;
      Border b;
      s.luma_border(x0, y0, bw, &b);
      i64 sblk[64];
      for (int i = 0; i < bw; i++)
        for (int j = 0; j < bw; j++)
          sblk[i * bw + j] = E.src[0][(i64)(y0 + i) * fw + x0 + j];
      // candidate modes (encoder.py _modes_for order)
      int cand[9], n_cand = 0;
      cand[n_cand++] = I4_DC;
      if (b.have_top) {
        cand[n_cand++] = 0;   // VERT
        cand[n_cand++] = 3;   // DDL
        cand[n_cand++] = 7;   // VL
      }
      if (b.have_left) {
        cand[n_cand++] = 1;   // HOR
        cand[n_cand++] = 8;   // HU
      }
      if (b.have_top && b.have_left && b.have_tl) {
        cand[n_cand++] = 4;   // DDR
        cand[n_cand++] = 5;   // VR
        cand[n_cand++] = 6;   // HD
      }
      int pred_mode = s.predict_i4_mode(gx, gy);
      int best_m = -1;
      i64 best_cost = -1;
      i32 best_p[64];
      for (int c = 0; c < n_cand; c++) {
        int m = cand[c];
        i32 p[64];
        if (cur[MS_TX8]) pred_8x8(m, b, p);
        else pred_4x4(m, b, p);
        i64 cost = m == pred_mode ? 0 : 256;
        for (int i = 0; i < bw * bw; i++) {
          i64 d = sblk[i] - p[i];
          cost += d * d;
        }
        if (best_cost < 0 || cost < best_cost) {
          best_m = m;
          best_cost = cost;
          memcpy(best_p, p, sizeof(i32) * bw * bw);
        }
      }
      modes[k] = best_m;
      if (cur[MS_TX8]) {
        for (int i = 0; i < 2; i++)
          for (int j = 0; j < 2; j++)
            s.i4_modes[(i64)(gy + i) * (s.mb_w * 4) + gx + j] = best_m;
      } else {
        s.i4_modes[(i64)gy * (s.mb_w * 4) + gx] = best_m;
      }

      i64 resid[64];
      for (int i = 0; i < bw * bw; i++) resid[i] = sblk[i] - best_p[i];
      scan_any[k] = 0;
      i32 rec[64];
      memset(rec, 0, sizeof(rec));
      if (cur[MS_TX8]) {
        i64 coef[64];
        enc_ftrans8(resid, coef);
        i32 q[64];
        E.quant8_blk(coef, qp, q);
        for (int i = 0; i < 64; i++) {
          coeffs_scan[k][i] = q[s.zz8[i]];
          if (q[i]) scan_any[k] = 1;
        }
        if (scan_any[k]) {
          i32 dq[64];
          s.dequant8(q, qp, dq);
          itrans8(dq, rec);
        }
      } else {
        i64 coef[16];
        enc_ftrans4(resid, coef);
        i32 q[16];
        E.quant4_blk(coef, qp, q);
        for (int i = 0; i < 16; i++) {
          coeffs_scan[k][i] = q[s.zz4[i]];
          if (q[i]) scan_any[k] = 1;
        }
        if (scan_any[k]) {
          i32 dq[16];
          s.dequant4(q, qp, dq);
          itrans4(dq, rec);
        }
      }
      for (int i = 0; i < bw; i++)
        for (int j = 0; j < bw; j++)
          Y[(i64)(y0 + i) * fw + x0 + j] =
              (u16)clip3i(0, 255, (i32)(best_p[i * bw + j]) +
                                      rec[i * bw + j]);
    }

    // cbp luma + cbf bookkeeping
    int cbp = 0;
    for (int k = 0; k < n_blocks; k++) {
      if (cur[MS_TX8]) {
        if (scan_any[k]) cbp |= 1 << k;
      } else if (scan_any[k]) {
        int bx = BLK4_X[k], by = BLK4_Y[k];
        cbp |= 1 << ((by / 2) * 2 + (bx / 2));
      }
    }
    cur[MS_CBPL] = cbp;
    for (int k = 0; k < n_blocks; k++) {
      int nz = scan_any[k];
      if (cur[MS_TX8]) {
        int bx = (k & 1) * 2, by = (k >> 1) * 2;
        for (int i = 0; i < 2; i++)
          for (int j = 0; j < 2; j++)
            s.cbf_luma[(i64)(mby * 4 + by + i) * (s.mb_w * 4) + mbx * 4 +
                       bx + j] = (u8)nz;
      } else {
        int bx = BLK4_X[k], by = BLK4_Y[k];
        s.cbf_luma[(i64)(mby * 4 + by) * (s.mb_w * 4) + mbx * 4 + bx] =
            (u8)nz;
      }
    }

    ChPlane ch[2];
    int cmode = 0, cbp_chroma = 0;
    if (!s.mono) cbp_chroma = E.chroma_levels(ch, &cmode);
    cur[MS_CBPC] = cbp_chroma;
    cur[MS_CMODE] = cmode;

    // intra pred mode bins
    for (int k = 0; k < n_blocks; k++) {
      int bx, by;
      if (cur[MS_TX8]) {
        bx = (k & 1) * 2;
        by = (k >> 1) * 2;
      } else {
        bx = BLK4_X[k];
        by = BLK4_Y[k];
      }
      int gx = mbx * 4 + bx, gy = mby * 4 + by;
      int pred = s.predict_i4_mode(gx, gy);
      int m = modes[k];
      if (m == pred) {
        e.encode_bin(CTX_PREV_I4X4, 1);
      } else {
        e.encode_bin(CTX_PREV_I4X4, 0);
        int rem = m < pred ? m : m - 1;
        e.encode_bin(CTX_REM_I4X4, rem & 1);
        e.encode_bin(CTX_REM_I4X4, (rem >> 1) & 1);
        e.encode_bin(CTX_REM_I4X4, (rem >> 2) & 1);
      }
    }

    if (!s.mono) E.emit_chroma_mode(cmode);
    int emitted = 0;
    for (int bit = 0; bit < 4; bit++) {
      int v = (cbp >> bit) & 1;
      e.encode_bin(CTX_CBP_LUMA + s.cbp_luma_inc(emitted, bit), v);
      emitted |= v << bit;
    }
    if (!s.mono) {
      e.encode_bin(CTX_CBP_CHROMA + s.cbp_chroma_inc(0),
                   cbp_chroma ? 1 : 0);
      if (cbp_chroma)
        e.encode_bin(CTX_CBP_CHROMA + 4 + s.cbp_chroma_inc(1),
                     cbp_chroma - 1);
    }
    if (cbp || cbp_chroma) {
      E.emit_qp_delta(0);
    } else {
      s.prev_qp_delta = 0;
      s.mb_qp[mby * s.mb_w + mbx] = s.qp;
    }
    s.mb_qp[mby * s.mb_w + mbx] = s.qp;

    // luma residuals
    for (int k = 0; k < n_blocks; k++) {
      if (cur[MS_TX8]) {
        if ((cbp >> k) & 1)
          E.emit_residual(CAT_LUMA_8X8, coeffs_scan[k], 64);
      } else {
        int bx = BLK4_X[k], by = BLK4_Y[k];
        int blk8 = (by / 2) * 2 + (bx / 2);
        if ((cbp >> blk8) & 1) {
          int nz = scan_any[k];
          int inc = s.cbf_inc(CAT_LUMA_4X4, bx, by, 0);
          e.encode_bin(CTX_CBF + 4 * CAT_LUMA_4X4 + inc, nz);
          if (nz) E.emit_residual(CAT_LUMA_4X4, coeffs_scan[k], 16);
        }
      }
    }
    if (!s.mono) E.emit_and_recon_chroma(cbp_chroma, ch);
  }

  // ------------------------------------------------- MB mode select

  void encode_mb() {
    int mbx = s.mbx, mby = s.mby;
    int x0 = mbx * 16, y0 = mby * 16;
    int fw = s.mb_w * 16;
    // I16 candidate: best mode by pred SSE (encoder.py _encode_mb)
    s.blk = 0;
    Border b;
    s.luma_border(x0, y0, 16, &b);
    i64 srcb[256];
    for (int i = 0; i < 16; i++)
      for (int j = 0; j < 16; j++)
        srcb[i * 16 + j] = E.src[0][(i64)(y0 + i) * fw + x0 + j];
    int cands[4], n_cands = 0;
    cands[n_cands++] = I16_DC;
    if (b.have_top) cands[n_cands++] = I16_VERT;
    if (b.have_left) cands[n_cands++] = I16_HOR;
    if (b.have_top && b.have_left && b.have_tl) cands[n_cands++] = 3;
    int best16 = -1;
    i64 sse16 = -1;
    for (int c = 0; c < n_cands; c++) {
      i32 p[256];
      pred_16x16(cands[c], b.have_top ? b.top : nullptr,
                 b.have_left ? b.left : nullptr, b.tl, b.have_top,
                 b.have_left, b.have_tl, p);
      i64 sse = 0;
      for (int i = 0; i < 256; i++) {
        i64 d = srcb[i] - p[i];
        sse += d * d;
      }
      if (sse16 < 0 || sse < sse16) {
        best16 = cands[c];
        sse16 = sse;
      }
    }
    // NxN estimate: per-4x4 best of DC/VERT/HOR on source neighbors
    i64 sse4 = 0;
    for (int k = 0; k < 16; k++) {
      int bx = BLK4_X[k], by = BLK4_Y[k];
      int bxp = x0 + bx * 4, byp = y0 + by * 4;
      s.blk = k;
      bool ht = byp > 0 && s.sample_decoded(bxp, byp - 1);
      bool hl = bxp > 0 && s.sample_decoded(bxp - 1, byp);
      i64 t[4], l[4];
      if (ht)
        for (int j = 0; j < 4; j++)
          t[j] = E.src[0][(i64)(byp - 1) * fw + bxp + j];
      if (hl)
        for (int i = 0; i < 4; i++)
          l[i] = E.src[0][(i64)(byp + i) * fw + bxp - 1];
      i64 sb[16];
      for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++)
          sb[i * 4 + j] = E.src[0][(i64)(byp + i) * fw + bxp + j];
      i64 best = -1;
      for (int mi = 0; mi < 3; mi++) {
        // order: DC, VERT, HOR (encoder.py loop over (DC,VERT,HOR))
        int m = mi == 0 ? I4_DC : (mi == 1 ? 0 : 1);
        if (m == 0 && !ht) continue;
        if (m == 1 && !hl) continue;
        i64 sse = 0;
        if (m == I4_DC) {
          i64 v;
          if (ht && hl) {
            i64 sum = 0;
            for (int j = 0; j < 4; j++) sum += t[j] + l[j];
            v = (sum + 4) >> 3;
          } else if (ht) {
            i64 sum = t[0] + t[1] + t[2] + t[3];
            v = (sum + 2) >> 2;
          } else if (hl) {
            i64 sum = l[0] + l[1] + l[2] + l[3];
            v = (sum + 2) >> 2;
          } else {
            v = 128;
          }
          for (int i = 0; i < 16; i++) {
            i64 d = sb[i] - v;
            sse += d * d;
          }
        } else if (m == 0) {   // VERT
          for (int i = 0; i < 4; i++)
            for (int j = 0; j < 4; j++) {
              i64 d = sb[i * 4 + j] - t[j];
              sse += d * d;
            }
        } else {               // HOR
          for (int i = 0; i < 4; i++)
            for (int j = 0; j < 4; j++) {
              i64 d = sb[i * 4 + j] - l[i];
              sse += d * d;
            }
        }
        if (best < 0 || sse < best) best = sse;
      }
      sse4 += best;
    }
    bool use_i16 = sse16 >= 0 && sse16 <= sse4 + 2048;
    if (use_i16) encode_i16_mb(best16);
    else encode_nxn_mb();
  }

  i64 run() {
    i64 n = (i64)s.mb_w * s.mb_h;
    s.prev_qp_delta = 0;
    for (i64 addr = s.first_mb; addr < n; addr++) {
      s.mbx = (int)(addr % s.mb_w);
      s.mby = (int)(addr / s.mb_w);
      s.cur = s.mb_state + addr * MS_N;
      memset(s.cur, 0, sizeof(i32) * MS_N);
      s.cur[MS_DECODED] = 1;
      encode_mb();
      e.encode_terminate(addr == n - 1 ? 1 : 0);
    }
    e.flush();
    return e.finish();
  }
};

}  // namespace avcn

extern "C" {

// encode one I slice (codecs/avc/encoder.py SliceEncoder.encode_slice)
// params: [mb_w, mb_h, mono, slice_qp, first_mb, transform_8x8_mode,
//          tx8_policy(0 never/1 always/2 alternate/3 auto),
//          cb_qp_off, cr_qp_off]
// Returns slice-data byte count (written to out), -1 on error.
int64_t tpuheif_avc_encode_slice(
    const uint8_t* src_y, const uint8_t* src_u, const uint8_t* src_v,
    const int64_t* params, uint8_t* p_state, uint8_t* val_mps,
    const int32_t* sig8, const int32_t* last8, const int32_t* zz4,
    const int32_t* zz8, const int32_t* ls4, const int32_t* ls8,
    const int32_t* mf4, const int32_t* mf8,
    const int32_t* chroma_qp_tab, int32_t* mb_state, int32_t* mb_qp,
    int32_t* i4_modes, uint8_t* cbf_luma, uint8_t* cbf_luma_dc,
    uint8_t* cbf_cdc, uint8_t* cbf_cac, uint16_t* recon_y,
    uint16_t* recon_cb, uint16_t* recon_cr, uint8_t* out,
    int64_t out_cap, char* err, int64_t errlen) {
  using namespace avcn;
  blk_init();
  Slice s;
  memset(&s, 0, sizeof(s));
  s.mb_w = (int)params[0];
  s.mb_h = (int)params[1];
  s.mono = (int)params[2];
  s.qp = (int)params[3];
  s.first_mb = (int)params[4];
  s.transform_8x8_mode = (int)params[5];
  s.cb_qp_off = (int)params[7];
  s.cr_qp_off = (int)params[8];
  s.sig8 = sig8;
  s.last8 = last8;
  s.zz4 = zz4;
  s.zz8 = zz8;
  s.ls4 = ls4;
  s.ls8 = ls8;
  s.chroma_qp_tab = chroma_qp_tab;
  s.mb_state = mb_state;
  s.mb_qp = mb_qp;
  s.i4_modes = i4_modes;
  s.cbf_luma = cbf_luma;
  s.cbf_luma_dc = cbf_luma_dc;
  s.cbf_cdc = cbf_cdc;
  s.cbf_cac = cbf_cac;
  s.planes[0] = recon_y;
  s.planes[1] = recon_cb;
  s.planes[2] = recon_cr;
  s.err = err;
  s.errlen = (int)errlen;
  CabacEnc e;
  e.init(out, out_cap, p_state, val_mps);
  Enc enc{s, e, {src_y, src_u, src_v}, (int)params[6], mf4, mf8};
  EncOps ops(enc);
  i64 nbytes = ops.run();
  if (e.overflow) {
    snprintf(err, errlen, "output buffer too small");
    return -1;
  }
  return nbytes;
}

}  // extern "C"
