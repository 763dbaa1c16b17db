// HEVC intra encoder fast path (C++ for the default parameter set of
// codecs/hevc/encoder.py IntraEncoder -- fixed CU size, auto or fixed
// mode decision, no SAO/RQT/NxN/WPP/sign-hiding/delta-QP, 8 bits).
//
// A copy of libheif_tpu/native/src/hevc_enc.cc.  It mirrors the Python
// encoder bit for bit: tests/test_torch_hevc_encode.py holds its slice
// payload and reconstruction to the JAX package's.  The Python loop
// covers the other parameters (SAO cycling, QP patterns, WPP, ...).
// _build.HOST_LIBRARY builds it with the parser into the hevc_host
// library; encoder.py calls it through ctypes.
//
// Replaces the reference's x265 plugin boundary for still images
// (reference: libheif/plugins/encoder_x265.cc speed path).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <algorithm>

namespace hevc_enc {

typedef int64_t i64;
typedef int32_t i32;
typedef uint8_t u8;

// ----------------------------------------------------------- tables

// context family order shared with native_parse.py _FAMILIES
enum CtxFamily {
  F_SAO_MERGE = 0, F_SAO_TYPE, F_SPLIT_CU, F_CU_TQB, F_PART_MODE,
  F_PREV_INTRA, F_INTRA_CHROMA, F_SPLIT_TRANSFORM, F_CBF_LUMA,
  F_CBF_CHROMA, F_CU_QP_DELTA, F_TRANSFORM_SKIP, F_LAST_X, F_LAST_Y,
  F_CODED_SUB_BLOCK, F_SIG_COEFF, F_GT1, F_GT2, N_FAMILIES
};

static const u8 kRangeTabLPS[64][4] = {
  {128,176,208,240},{128,167,197,227},{128,158,187,216},{123,150,178,205},
  {116,142,169,195},{111,135,160,185},{105,128,152,175},{100,122,144,166},
  {95,116,137,158},{90,110,130,150},{85,104,123,142},{81,99,117,135},
  {77,94,111,128},{73,89,105,122},{69,85,100,116},{66,80,95,110},
  {62,76,90,104},{59,72,86,99},{56,69,81,94},{53,65,77,89},
  {51,62,73,85},{48,59,69,80},{46,56,66,76},{43,53,63,72},
  {41,50,59,69},{39,48,56,65},{37,45,54,62},{35,43,51,59},
  {33,41,48,56},{32,39,46,53},{30,37,43,50},{29,35,41,48},
  {27,33,39,45},{26,31,37,43},{24,30,35,41},{23,28,33,39},
  {22,27,32,37},{21,26,30,35},{20,24,29,33},{19,23,27,31},
  {18,22,26,30},{17,21,25,28},{16,20,23,27},{15,19,22,25},
  {14,18,21,24},{14,17,20,23},{13,16,19,22},{12,15,18,21},
  {12,14,17,20},{11,14,16,19},{11,13,15,18},{10,12,15,17},
  {10,12,14,16},{9,11,13,15},{9,11,12,14},{8,10,12,14},
  {8,9,11,13},{7,9,11,12},{7,9,10,12},{7,8,10,11},
  {6,8,9,11},{6,7,9,10},{6,7,8,9},{2,2,2,2},
};
static const u8 kTransIdxLPS[64] = {
  0,0,1,2,2,4,4,5,6,7,8,9,9,11,11,12,13,13,15,15,16,16,18,18,19,19,21,21,22,22,23,24,24,25,26,26,27,27,28,29,29,30,30,30,31,32,32,33,33,33,34,34,35,35,35,36,36,36,37,37,37,38,38,63,
};
static const u8 kTransIdxMPS[64] = {
  1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19,20,21,22,23,24,25,26,27,28,29,30,31,32,33,34,35,36,37,38,39,40,41,42,43,44,45,46,47,48,49,50,51,52,53,54,55,56,57,58,59,60,61,62,62,63,
};
static void tab_init() {}

static const int kQuantScale[6] = {26214, 23302, 20560, 18396, 16384, 14564};
static const i64 kLevelScale[6] = {40, 45, 51, 57, 64, 72};

// spec table 8-10 chroma QP mapping (4:2:0)
static int chroma_qp(int qpi) {
  if (qpi < 30) return qpi;
  static const int map[] = {29, 30, 31, 32, 33, 33, 34, 34, 35, 35,
                            36, 36, 37, 37};
  if (qpi <= 43) return map[qpi - 30];
  return qpi - 6;
}

// intra prediction angles (spec table 8-4/8-5)
static const int kPredAngle[35] = {
  0, 0, 32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26,
  -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32};
static int inv_angle_of(int a) {
  switch (a) {
    case -2: return -4096; case -5: return -1638; case -9: return -910;
    case -13: return -630; case -17: return -482; case -21: return -390;
    case -26: return -315; case -32: return -256; default: return 0;
  }
}

static const int INTRA_PLANAR = 0, INTRA_DC = 1, INTRA_ANGULAR26 = 26;

// 4x4 sig-coeff ctx map (spec 9.3.4.2.5)
static const u8 kCtxIdxMap4x4[16] = {0, 1, 4, 5, 2, 3, 4, 5,
                                     6, 6, 8, 8, 7, 7, 8, 99};

// ------------------------------------------------------------ scans

struct Scan {               // x/y per scan index
  std::vector<u8> x, y;
  std::vector<u8> of;       // (y*size+x) -> scan index
};

static Scan make_scan(int idx, int size) {
  Scan s;
  s.x.reserve(size * size);
  s.y.reserve(size * size);
  if (idx == 0) {           // up-right diagonal
    for (int d = 0; d < 2 * size - 1; d++) {
      int x = d < size ? 0 : d - size + 1;
      int y = d < size ? d : size - 1;
      while (x < size && y >= 0) {
        s.x.push_back((u8)x); s.y.push_back((u8)y);
        x++; y--;
      }
    }
  } else if (idx == 1) {    // horizontal
    for (int y = 0; y < size; y++)
      for (int x = 0; x < size; x++) {
        s.x.push_back((u8)x); s.y.push_back((u8)y);
      }
  } else {                  // vertical
    for (int x = 0; x < size; x++)
      for (int y = 0; y < size; y++) {
        s.x.push_back((u8)x); s.y.push_back((u8)y);
      }
  }
  s.of.assign((size_t)size * size, 0);
  for (size_t i = 0; i < s.x.size(); i++)
    s.of[(size_t)s.y[i] * size + s.x[i]] = (u8)i;
  return s;
}

// ------------------------------------------------------ CABAC encoder

struct CabacEnc {
  u8* p_state;
  u8* val_mps;
  uint32_t low = 0, range = 510;
  int bits_outstanding = 0;
  bool first_bit = true;
  std::vector<u8> bytes;
  uint32_t acc = 0;
  int nacc = 0;

  inline void raw_bit(int b) {
    acc = (acc << 1) | (uint32_t)b;
    if (++nacc == 8) {
      bytes.push_back((u8)acc);
      acc = 0; nacc = 0;
    }
  }
  inline void put_bit(int b) {
    if (first_bit) first_bit = false;
    else raw_bit(b);
    while (bits_outstanding > 0) {
      raw_bit(1 - b);
      bits_outstanding--;
    }
  }
  inline void renorm() {
    while (range < 256) {
      if (low < 256) put_bit(0);
      else if (low >= 512) { put_bit(1); low -= 512; }
      else { bits_outstanding++; low -= 256; }
      low <<= 1;
      range <<= 1;
    }
  }
  bool trace = false;
  inline void encode_bin(int ctx_idx, int binval) {
    if (trace) fprintf(stderr, "B %d %d\n", ctx_idx, binval);
    int ps = p_state[ctx_idx];
    uint32_t lps = kRangeTabLPS[ps][(range >> 6) & 3];
    range -= lps;
    if (binval != val_mps[ctx_idx]) {
      low += range;
      range = lps;
      if (ps == 0) val_mps[ctx_idx] = 1 - val_mps[ctx_idx];
      p_state[ctx_idx] = kTransIdxLPS[ps];
    } else {
      p_state[ctx_idx] = kTransIdxMPS[ps];
    }
    renorm();
  }
  inline void encode_bypass(int binval) {
    if (trace) fprintf(stderr, "Y %d\n", binval);
    low <<= 1;
    if (binval) low += range;
    if (low >= 1024) { put_bit(1); low -= 1024; }
    else if (low < 512) put_bit(0);
    else { bits_outstanding++; low -= 512; }
  }
  inline void encode_bypass_bits(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--) encode_bypass((v >> i) & 1);
  }
  inline void encode_tu_bypass(int c_max, int v) {
    for (int i = 0; i < v; i++) encode_bypass(1);
    if (v < c_max) encode_bypass(0);
  }
  inline void encode_terminate(int binval) {
    range -= 2;
    if (binval) low += range;
    else renorm();
  }
  void flush() {
    range = 2;
    renorm();
    put_bit((low >> 9) & 1);
    raw_bit((low >> 8) & 1);
    raw_bit(1);                 // rbsp_stop_one_bit
    if (nacc) {                 // zero-pad the final byte
      bytes.push_back((u8)(acc << (8 - nacc)));
      acc = 0; nacc = 0;
    }
  }
};

// ------------------------------------------------------------ encoder

struct Enc {
  // params
  int qp, ctb_log2, cu_log2, width, height, fixed_mode, strong_smooth;
  int max_tb_log2, min_tb_log2 = 2, min_cb_log2 = 3;
  const i32* fam;
  // transform tables
  const i32* dst4;
  const i32* dct[6];          // [log2] 4..32
  // source + recon planes (int32, stride = width / width/2)
  const i32* src[3];
  std::vector<i32> recon[3];
  int pw[3], ph[3];
  // maps (4x4 luma granularity)
  int w4, h4;
  std::vector<u8> syn_avail, recon_avail, intra_mode_y, ct_depth;
  CabacEnc cab;
  char* err; int errlen; int rc = 0;

  Scan scans4[3];
  Scan sb_scans[3][4];

  void fail(const char* msg) {
    if (!rc) { rc = 1; snprintf(err, errlen, "%s", msg); }
  }

  int ctx(int family, int inc = 0) const { return fam[family] + inc; }

  bool syn_av(int x, int y) const {
    if (x < 0 || y < 0 || x >= width || y >= height) return false;
    return syn_avail[(i64)(y >> 2) * w4 + (x >> 2)] != 0;
  }
  bool sample_av(int lx, int ly) const {
    if (lx < 0 || ly < 0 || lx >= width || ly >= height) return false;
    return recon_avail[(i64)(ly >> 2) * w4 + (lx >> 2)] != 0;
  }

  // ------------------------------------------------------- prediction
  // (port of recon.py _gather_refs/_filter_refs/_predict; spec 8.4.4.2)

  void gather_refs(int x, int y, int log2, int c_idx, i32* vals) {
    int n = 1 << log2;
    int shift = c_idx ? 1 : 0;
    int px = c_idx ? (x >> shift) : x;
    int py = c_idx ? (y >> shift) : y;
    const i32* plane = c_idx ? recon[c_idx].data() : recon[0].data();
    int w = pw[c_idx], h = ph[c_idx];
    int total = 4 * n + 1;
    bool any = false;
    std::vector<u8> av(total, 0);
    for (int i = 0; i < total; i++) {
      int sx, sy;
      if (i < 2 * n) { sx = px - 1; sy = py + 2 * n - 1 - i; }
      else if (i == 2 * n) { sx = px - 1; sy = py - 1; }
      else { sx = px + (i - 2 * n - 1); sy = py - 1; }
      int lx = c_idx ? (sx << shift) : sx;
      int ly = c_idx ? (sy << shift) : sy;
      vals[i] = 0;
      if (sx >= 0 && sy >= 0 && sx < w && sy < h && sample_av(lx, ly)) {
        vals[i] = plane[(i64)sy * w + sx];
        av[i] = 1;
        any = true;
      }
    }
    if (!any) {
      for (int i = 0; i < total; i++) vals[i] = 128;
      return;
    }
    if (!av[0]) {
      int idx = 0;
      while (!av[idx]) idx++;
      vals[0] = vals[idx];
      av[0] = 1;
    }
    for (int i = 1; i < total; i++)
      if (!av[i]) vals[i] = vals[i - 1];
  }

  void filter_refs(int log2, int c_idx, int mode, const i32* ref,
                   i32* out) {
    int n = 1 << log2;
    int total = 4 * n + 1;
    if (c_idx != 0 || n == 4 || mode == INTRA_DC) {
      memcpy(out, ref, total * sizeof(i32));
      return;
    }
    int dist = std::min(std::abs(mode - 26), std::abs(mode - 10));
    int thresh = n == 8 ? 7 : (n == 16 ? 1 : 0);
    if (mode != INTRA_PLANAR && dist <= thresh) {
      memcpy(out, ref, total * sizeof(i32));
      return;
    }
    int corner = 2 * n;
    if (n == 32 && strong_smooth) {
      bool flat_top = std::abs(ref[corner] + ref[4 * n] -
                               2 * ref[corner + n]) < 8;
      bool flat_left = std::abs(ref[corner] + ref[0] - 2 * ref[n]) < 8;
      if (flat_top && flat_left) {
        memcpy(out, ref, total * sizeof(i32));
        for (int i = 1; i < 2 * n; i++) {
          out[corner + i] = ((2 * n - i) * ref[corner] + i * ref[4 * n] +
                             n) >> (log2 + 1);
          out[corner - i] = ((2 * n - i) * ref[corner] + i * ref[0] + n)
                            >> (log2 + 1);
        }
        return;
      }
    }
    out[0] = ref[0];
    out[total - 1] = ref[total - 1];
    for (int i = 1; i < total - 1; i++)
      out[i] = (ref[i - 1] + 2 * ref[i] + ref[i + 1] + 2) >> 2;
  }

  void predict(int x, int y, int log2, int c_idx, int mode, i32* pred) {
    int n = 1 << log2;
    i32 refbuf[129], fref[129];
    gather_refs(x, y, log2, c_idx, refbuf);
    filter_refs(log2, c_idx, mode, refbuf, fref);
    int corner = 2 * n;
    // left[i] = fref[corner-1-i], top[i] = fref[corner+1+i]
    const i32* f = fref;
    i32 cval = f[corner];
    auto leftv = [&](int i) { return f[corner - 1 - i]; };
    auto topv = [&](int i) { return f[corner + 1 + i]; };

    if (mode == INTRA_PLANAR) {
      int tr = topv(n), bl = leftv(n);
      for (int yy = 0; yy < n; yy++)
        for (int xx = 0; xx < n; xx++)
          pred[yy * n + xx] =
              (i32)(((n - 1 - xx) * leftv(yy) + (xx + 1) * tr +
                     (n - 1 - yy) * topv(xx) + (yy + 1) * bl + n)
                    >> (log2 + 1));
      return;
    }
    if (mode == INTRA_DC) {
      i64 s = 0;
      for (int i = 0; i < n; i++) s += topv(i) + leftv(i);
      int dc = (int)((s + n) >> (log2 + 1));
      for (int i = 0; i < n * n; i++) pred[i] = dc;
      if (c_idx == 0 && n < 32) {
        pred[0] = (leftv(0) + 2 * dc + topv(0) + 2) >> 2;
        for (int xx = 1; xx < n; xx++)
          pred[xx] = (topv(xx) + 3 * dc + 2) >> 2;
        for (int yy = 1; yy < n; yy++)
          pred[yy * n] = (leftv(yy) + 3 * dc + 2) >> 2;
      }
      return;
    }
    int angle = kPredAngle[mode];
    int maxv = 255;
    bool vertical = mode >= 18;
    // ref[] indexed lo..2n with offset
    int lo = angle < 0 ? std::min(0, (n * angle) >> 5) : 0;
    int off = -lo;
    i32 er[32 + 65];
    int erlen = off + 2 * n + 1;
    er[off] = cval;
    for (int i = 0; i < 2 * n; i++)
      er[off + 1 + i] = vertical ? topv(i) : leftv(i);
    if (angle < 0) {
      int inv = inv_angle_of(angle);
      for (int xx = -1; xx >= lo; xx--) {
        int idx = (xx * inv + 128) >> 8;
        er[off + xx] = idx == 0
            ? cval
            : (vertical ? leftv(std::min(idx - 1, 2 * n - 1))
                        : topv(std::min(idx - 1, 2 * n - 1)));
      }
    }
    int hi = erlen - 1;
    for (int di = 0; di < n; di++) {
      int k = di + 1;
      int i_idx = (k * angle) >> 5;
      int i_fact = (k * angle) & 31;
      int base = off + i_idx + 1;
      for (int p = 0; p < n; p++) {
        int idx0 = std::min(p + base, hi);
        i32 v;
        if (i_fact == 0) {
          v = er[idx0];
        } else {
          int idx1 = std::min(p + base + 1, hi);
          v = ((32 - i_fact) * er[idx0] + i_fact * er[idx1] + 16) >> 5;
        }
        if (vertical) pred[di * n + p] = v;
        else pred[p * n + di] = v;
      }
    }
    if (angle == 0 && c_idx == 0 && n < 32) {
      if (vertical) {
        for (int yy = 0; yy < n; yy++) {
          i32 v = topv(0) + ((leftv(yy) - cval) >> 1);
          pred[yy * n] = std::max(0, std::min(maxv, v));
        }
      } else {
        for (int xx = 0; xx < n; xx++) {
          i32 v = leftv(0) + ((topv(xx) - cval) >> 1);
          pred[xx] = std::max(0, std::min(maxv, v));
        }
      }
    }
  }

  // ------------------------------------------- transforms + quant

  void forward_transform(const i32* block, int log2, int c_idx,
                         i32* out) {
    int n = 1 << log2;
    const i32* m = (c_idx == 0 && n == 4) ? dst4 : dct[log2];
    int shift1 = log2 - 1;     // log2 + 8 - 9
    int shift2 = log2 + 6;
    // t = m @ block  (>> shift1, rounded, shift1 > 0 for log2 >= 2)
    i64 t[32 * 32];
    for (int i = 0; i < n; i++)
      for (int j = 0; j < n; j++) {
        i64 acc = 0;
        for (int k = 0; k < n; k++)
          acc += (i64)m[i * n + k] * block[k * n + j];
        t[i * n + j] = (acc + ((i64)1 << (shift1 - 1))) >> shift1;
      }
    // c = t @ m^T (>> shift2, rounded)
    for (int i = 0; i < n; i++)
      for (int j = 0; j < n; j++) {
        i64 acc = 0;
        for (int k = 0; k < n; k++)
          acc += t[i * n + k] * (i64)m[j * n + k];
        out[i * n + j] = (i32)((acc + ((i64)1 << (shift2 - 1))) >> shift2);
      }
  }

  void quantize(const i32* coeffs, int qp_v, int log2, i32* out) {
    int n = 1 << log2;
    int tshift = 15 - 8 - log2;
    int qbits = 14 + qp_v / 6 + tshift;
    i64 scale = kQuantScale[qp_v % 6];
    i64 add = (i64)171 << (qbits - 9);
    for (int i = 0; i < n * n; i++) {
      i64 c = coeffs[i];
      i64 mag = ((c < 0 ? -c : c) * scale + add) >> qbits;
      out[i] = (i32)(c < 0 ? -mag : (c > 0 ? mag : 0));
    }
  }

  // closed-loop recon of one TU (dequant + inverse transform + add)
  void recon_tu(int x, int y, int log2, int c_idx, int mode, int qp_v,
                const i32* coeffs, const i32* pred, bool cbf) {
    int n = 1 << log2;
    int shift = c_idx ? 1 : 0;
    int px = c_idx ? (x >> shift) : x;
    int py = c_idx ? (y >> shift) : y;
    i32* plane = recon[c_idx].data();
    int w = pw[c_idx];
    i32 res[32 * 32];
    if (cbf) {
      // dequant (spec 8.6.3)
      int bd_shift = 8 + log2 - 5;
      i64 scale = kLevelScale[qp_v % 6] << (qp_v / 6);
      i32 d[32 * 32];
      for (int i = 0; i < n * n; i++) {
        i64 v = ((i64)coeffs[i] * 16 * scale +
                 ((i64)1 << (bd_shift - 1))) >> bd_shift;
        d[i] = (i32)(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
      }
      const i32* m = (c_idx == 0 && n == 4) ? dst4 : dct[log2];
      // stage 1: e = clip((M^T @ d + 64) >> 7)
      i32 e[32 * 32];
      for (int i = 0; i < n; i++)
        for (int j = 0; j < n; j++) {
          i64 acc = 0;
          for (int k = 0; k < n; k++)
            acc += (i64)m[k * n + i] * d[k * n + j];
          i64 v = (acc + 64) >> 7;
          e[i * n + j] = (i32)(v < -32768 ? -32768
                                          : (v > 32767 ? 32767 : v));
        }
      int shift2 = 12;           // 20 - bd
      for (int i = 0; i < n; i++)
        for (int j = 0; j < n; j++) {
          i64 acc = 0;
          for (int k = 0; k < n; k++)
            acc += (i64)e[i * n + k] * m[k * n + j];
          i64 v = (acc + (1 << 11)) >> shift2;
          res[i * n + j] = (i32)(v < -32768 ? -32768
                                            : (v > 32767 ? 32767 : v));
        }
    } else {
      memset(res, 0, sizeof(i32) * n * n);
    }
    for (int i = 0; i < n; i++)
      for (int j = 0; j < n; j++) {
        i32 v = pred[i * n + j] + res[i * n + j];
        plane[(i64)(py + i) * w + px + j] =
            v < 0 ? 0 : (v > 255 ? 255 : v);
      }
    if (c_idx == 0) {
      for (int by = y >> 2; by < (y + n) >> 2; by++)
        for (int bx = x >> 2; bx < (x + n) >> 2; bx++)
          recon_avail[(i64)by * w4 + bx] = 1;
    }
  }

  // ---------------------------------------------------- mode decision

  int choose_mode(int x0, int y0, int log2) {
    if (fixed_mode >= 0) return fixed_mode;
    int l2 = std::min(log2, 5);
    int n = 1 << l2;
    static const int cand[11] = {INTRA_PLANAR, INTRA_DC, 10, 26, 2, 18,
                                 34, 6, 14, 22, 30};
    i64 best_sad = ((i64)1 << 60);
    int best_mode = INTRA_DC;
    i32 pred[32 * 32];
    for (int ci = 0; ci < 11; ci++) {
      int mode = cand[ci];
      predict(x0, y0, l2, 0, mode, pred);
      i64 sad = 0;
      for (int i = 0; i < n; i++) {
        const i32* sr = src[0] + (i64)(y0 + i) * width + x0;
        for (int j = 0; j < n; j++) {
          i32 d = sr[j] - pred[i * n + j];
          sad += d < 0 ? -d : d;
        }
      }
      if (sad < best_sad) { best_sad = sad; best_mode = mode; }
    }
    return best_mode;
  }

  // ---------------------------------------------------------- MPM

  void mpm_list(int px, int py, int* mpm) {
    int cand_a = INTRA_DC, cand_b = INTRA_DC;
    if (syn_av(px - 1, py))
      cand_a = intra_mode_y[(i64)(py >> 2) * w4 + ((px - 1) >> 2)];
    if (syn_av(px, py - 1) &&
        ((py - 1) >> ctb_log2) == (py >> ctb_log2))
      cand_b = intra_mode_y[(i64)((py - 1) >> 2) * w4 + (px >> 2)];
    if (cand_a == cand_b) {
      if (cand_a < 2) {
        mpm[0] = INTRA_PLANAR; mpm[1] = INTRA_DC; mpm[2] = INTRA_ANGULAR26;
      } else {
        mpm[0] = cand_a;
        mpm[1] = 2 + ((cand_a + 29) % 32);
        mpm[2] = 2 + ((cand_a - 2 + 1) % 32);
      }
      return;
    }
    mpm[0] = cand_a;
    mpm[1] = cand_b;
    if (cand_a != INTRA_PLANAR && cand_b != INTRA_PLANAR)
      mpm[2] = INTRA_PLANAR;
    else if (cand_a != INTRA_DC && cand_b != INTRA_DC)
      mpm[2] = INTRA_DC;
    else
      mpm[2] = INTRA_ANGULAR26;
  }

  // ------------------------------------------------------- residual

  int sig_ctx(int xc, int yc, int log2, int c_idx, int scan_idx, int sx,
              int sy, const u8* csbf, int n_sb) {
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

  static int scan_sel(int log2, int c_idx, int mode) {
    if ((c_idx == 0 && (log2 == 2 || log2 == 3)) ||
        (c_idx > 0 && log2 == 2)) {
      if (mode >= 6 && mode <= 14) return 2;
      if (mode >= 22 && mode <= 30) return 1;
    }
    return 0;
  }

  void write_residual(int log2, int c_idx, int mode, const i32* coeffs) {
    int size = 1 << log2;
    int scan_idx = scan_sel(log2, c_idx, mode);
    int n_sb = size >> 2;
    int sb_log = n_sb == 1 ? 0 : (n_sb == 2 ? 1 : (n_sb == 4 ? 2 : 3));
    const Scan& sbs = sb_scans[scan_idx][sb_log];
    const Scan& pos = scans4[scan_idx];

    // last significant coefficient in scan order
    int last_scan = -1;
    for (int i = 0; i < n_sb * n_sb; i++) {
      int sx = sbs.x[i], sy = sbs.y[i];
      for (int n = 0; n < 16; n++) {
        int qx = pos.x[n], qy = pos.y[n];
        if (coeffs[((sy << 2) + qy) * size + (sx << 2) + qx])
          last_scan = i * 16 + n;
      }
    }
    if (last_scan < 0) { fail("write_residual with all-zero TU"); return; }
    int last_sb = last_scan / 16, last_pos = last_scan % 16;
    int lx = (sbs.x[last_sb] << 2) + pos.x[last_pos];
    int ly = (sbs.y[last_sb] << 2) + pos.y[last_pos];
    int wx = scan_idx == 2 ? ly : lx;
    int wy = scan_idx == 2 ? lx : ly;

    auto last_prefix_of = [](int v) {
      if (v <= 3) return v;
      int p = 4;
      for (;;) {
        int nbits = (p >> 1) - 1;
        int base = (2 + (p & 1)) << nbits;
        if (base <= v && v < base + (1 << nbits)) return p;
        p++;
      }
    };
    auto write_last_prefix = [&](int family, int prefix) {
      int c_max = (log2 << 1) - 1;
      int offset, shift;
      if (c_idx == 0) {
        offset = 3 * (log2 - 2) + ((log2 - 1) >> 2);
        shift = (log2 + 1) >> 2;
      } else {
        offset = 15;
        shift = log2 - 2;
      }
      for (int i = 0; i < prefix; i++)
        cab.encode_bin(ctx(family, offset + (i >> shift)), 1);
      if (prefix < c_max)
        cab.encode_bin(ctx(family, offset + (prefix >> shift)), 0);
    };
    auto write_last_suffix = [&](int prefix, int v) {
      if (prefix > 3) {
        int nbits = (prefix >> 1) - 1;
        int base = (2 + (prefix & 1)) << nbits;
        cab.encode_bypass_bits((uint32_t)(v - base), nbits);
      }
    };
    int pfx = last_prefix_of(wx);
    int pfy = last_prefix_of(wy);
    write_last_prefix(F_LAST_X, pfx);
    write_last_prefix(F_LAST_Y, pfy);
    write_last_suffix(pfx, wx);
    write_last_suffix(pfy, wy);

    u8 csbf[8 * 8] = {0};
    for (int i = 0; i <= last_sb; i++) {
      int sx = sbs.x[i], sy = sbs.y[i];
      bool any = false;
      for (int yy = 0; yy < 4 && !any; yy++)
        for (int xx = 0; xx < 4; xx++)
          if (coeffs[((sy << 2) + yy) * size + (sx << 2) + xx]) {
            any = true;
            break;
          }
      if (any) csbf[sy * n_sb + sx] = 1;
    }
    csbf[(i64)sbs.y[last_sb] * n_sb + sbs.x[last_sb]] = 1;
    csbf[0] = 1;

    bool prev_sb_gt1 = false;
    for (int i = last_sb; i >= 0; i--) {
      int sx = sbs.x[i], sy = sbs.y[i];
      bool explicit_sb = !(i == last_sb || i == 0);
      bool sb_coded = csbf[sy * n_sb + sx] != 0;
      if (explicit_sb) {
        int right = sx + 1 < n_sb ? csbf[sy * n_sb + sx + 1] : 0;
        int below = sy + 1 < n_sb ? csbf[(sy + 1) * n_sb + sx] : 0;
        int ctx_inc = ((right | below) ? 1 : 0) + (c_idx ? 2 : 0);
        cab.encode_bin(ctx(F_CODED_SUB_BLOCK, ctx_inc), sb_coded ? 1 : 0);
      }
      if (!sb_coded) continue;

      int start_n = (i == last_sb) ? last_pos - 1 : 15;
      int sig_pos[16];
      int n_sig = 0;
      i32 vals[16];
      if (i == last_sb) {
        sig_pos[n_sig++] = last_pos;
      }
      for (int n = 0; n < 16; n++) {
        int qx = pos.x[n], qy = pos.y[n];
        vals[n] = coeffs[((sy << 2) + qy) * size + (sx << 2) + qx];
      }
      for (int n = start_n; n >= 0; n--) {
        int qx = pos.x[n], qy = pos.y[n];
        int xc = (sx << 2) + qx, yc = (sy << 2) + qy;
        int sig = vals[n] ? 1 : 0;
        bool have_pos_gt0 = false;
        for (int k = 0; k < n_sig; k++)
          if (sig_pos[k] > 0) { have_pos_gt0 = true; break; }
        if (n == 0 && explicit_sb && !have_pos_gt0) {
          // DC sig inferred by the decoder
        } else {
          int sctx = sig_ctx(xc, yc, log2, c_idx, scan_idx, sx, sy, csbf,
                             n_sb);
          cab.encode_bin(ctx(F_SIG_COEFF, sctx), sig);
        }
        if (sig) sig_pos[n_sig++] = n;
      }

      int ctx_set = (i == 0 || c_idx > 0) ? 0 : 2;
      if (prev_sb_gt1) ctx_set++;
      int greater1_ctx = 1;
      int gt1_flag[16];
      bool has_gt1[16] = {false};
      int first_gt1_n = -1;
      for (int k = 0; k < n_sig && k < 8; k++) {
        int n = sig_pos[k];
        int level = std::abs(vals[n]);
        int g1 = level > 1 ? 1 : 0;
        int inc = ctx_set * 4 + std::min(3, greater1_ctx) +
                  (c_idx ? 16 : 0);
        cab.encode_bin(ctx(F_GT1, inc), g1);
        gt1_flag[k] = g1;
        has_gt1[k] = true;
        if (g1) {
          if (first_gt1_n < 0) first_gt1_n = n;
          greater1_ctx = 0;
        } else if (greater1_ctx > 0) {
          greater1_ctx++;
        }
      }
      int g2 = 0;
      if (first_gt1_n >= 0) {
        g2 = std::abs(vals[first_gt1_n]) > 2 ? 1 : 0;
        cab.encode_bin(ctx(F_GT2, ctx_set + (c_idx ? 4 : 0)), g2);
      }
      prev_sb_gt1 = first_gt1_n >= 0;

      // signs (sign hiding unsupported in the fast path)
      for (int k = 0; k < n_sig; k++)
        cab.encode_bypass(vals[sig_pos[k]] < 0 ? 1 : 0);

      int rice = 0;
      for (int k = 0; k < n_sig; k++) {
        int n = sig_pos[k];
        int level = std::abs(vals[n]);
        int base, max_base;
        if (k < 8 && has_gt1[k]) {
          base = 1 + gt1_flag[k] + (n == first_gt1_n ? g2 : 0);
          max_base = n == first_gt1_n ? 3 : 2;
        } else {
          base = 1;
          max_base = 1;
        }
        if (base == max_base) {
          int rem = level - base;
          if (rem < (4 << rice)) {
            int prefix = rem >> rice;
            for (int t = 0; t < prefix; t++) cab.encode_bypass(1);
            cab.encode_bypass(0);
            cab.encode_bypass_bits((uint32_t)(rem & ((1 << rice) - 1)),
                                   rice);
          } else {
            int p = 4;
            int base2, span;
            for (;;) {
              base2 = (((1 << (p - 3)) + 3 - 1)) << rice;
              span = 1 << (p - 3 + rice);
              if (base2 <= rem && rem < base2 + span) break;
              p++;
            }
            for (int t = 0; t < p; t++) cab.encode_bypass(1);
            cab.encode_bypass(0);
            cab.encode_bypass_bits((uint32_t)(rem - base2), p - 3 + rice);
          }
        }
        if (level > (3 << rice)) rice = std::min(rice + 1, 4);
      }
    }
  }

  // --------------------------------------------------------- CU / tree

  // prepare one TU: predict + transform + quant; returns cbf
  struct TuData {
    i32 pred[32 * 32];
    i32 coeffs[32 * 32];
    bool cbf;
  };

  bool prepare_tu(int x, int y, int clog2, int c_idx, int cmode, int qp_v,
                  TuData* out) {
    int n = 1 << clog2;
    predict(x, y, clog2, c_idx, cmode, out->pred);
    int shift = c_idx ? 1 : 0;
    int px = c_idx ? (x >> shift) : x;
    int py = c_idx ? (y >> shift) : y;
    i32 diff[32 * 32];
    const i32* sp = src[c_idx];
    int w = pw[c_idx];
    for (int i = 0; i < n; i++)
      for (int j = 0; j < n; j++)
        diff[i * n + j] = sp[(i64)(py + i) * w + px + j] -
                          out->pred[i * n + j];
    i32 fwd[32 * 32];
    forward_transform(diff, clog2, c_idx, fwd);
    quantize(fwd, qp_v, clog2, out->coeffs);
    out->cbf = false;
    for (int i = 0; i < n * n; i++)
      if (out->coeffs[i]) { out->cbf = true; break; }
    return out->cbf;
  }

  // transform-tree node for the fast path: either a leaf or a forced
  // split (log2 > max_tb); explicit RQT splits are not supported here
  void emit_tt(int x0, int y0, int log2, int depth, bool parent_cbf_cb,
               bool parent_cbf_cr, int qp_v, int cqp, int mode, int cmode,
               TuData* cb_tu, TuData* cr_tu, int blk_idx,
               TuData* parent_cb, TuData* parent_cr) {
    bool split = log2 > max_tb_log2;
    bool cbf_cb = parent_cbf_cb, cbf_cr = parent_cbf_cr;
    if (log2 > 2) {
      if (depth == 0 || parent_cbf_cb) {
        cab.encode_bin(ctx(F_CBF_CHROMA, depth), cb_tu->cbf ? 1 : 0);
        cbf_cb = cb_tu->cbf;
      } else {
        cbf_cb = false;
      }
      if (depth == 0 || parent_cbf_cr) {
        cab.encode_bin(ctx(F_CBF_CHROMA, depth), cr_tu->cbf ? 1 : 0);
        cbf_cr = cr_tu->cbf;
      } else {
        cbf_cr = false;
      }
    }
    if (split) {
      fail("forced RQT split unsupported in native fast path");
      return;
    }

    TuData ltu;
    prepare_tu(x0, y0, log2, 0, mode, qp_v, &ltu);
    cab.encode_bin(ctx(F_CBF_LUMA, depth == 0 ? 1 : 0), ltu.cbf ? 1 : 0);

    bool chroma_here = log2 > 2 || blk_idx == 3;
    TuData* ecb = log2 > 2 ? cb_tu : parent_cb;
    TuData* ecr = log2 > 2 ? cr_tu : parent_cr;
    bool eff_cb = log2 > 2 ? cbf_cb : (parent_cbf_cb && chroma_here);
    bool eff_cr = log2 > 2 ? cbf_cr : (parent_cbf_cr && chroma_here);

    if (ltu.cbf) write_residual(log2, 0, mode, ltu.coeffs);
    recon_tu(x0, y0, log2, 0, mode, qp_v, ltu.coeffs, ltu.pred, ltu.cbf);

    if (chroma_here) {
      if (eff_cb) write_residual(log2 > 2 ? log2 - 1 : 2, 1, cmode,
                                 ecb->coeffs);
      if (eff_cr) write_residual(log2 > 2 ? log2 - 1 : 2, 2, cmode,
                                 ecr->coeffs);
    }
  }

  void encode_cu(int x0, int y0, int log2, int depth) {
    if (rc) return;
    int size = 1 << log2;
    int nb = size >> 2;
    int bx0 = x0 >> 2, by0 = y0 >> 2;

    if (log2 == min_cb_log2)
      cab.encode_bin(ctx(F_PART_MODE), 1);     // PART_2Nx2N

    int mode = choose_mode(x0, y0, log2);
    for (int by = by0; by < by0 + nb; by++)
      for (int bx = bx0; bx < bx0 + nb; bx++) {
        intra_mode_y[(i64)by * w4 + bx] = (u8)mode;
        syn_avail[(i64)by * w4 + bx] = 1;
      }
    int mpm[3];
    mpm_list(x0, y0, mpm);
    int mpm_flag = -1;
    for (int i = 0; i < 3; i++)
      if (mpm[i] == mode) { mpm_flag = i; break; }
    cab.encode_bin(ctx(F_PREV_INTRA), mpm_flag >= 0 ? 1 : 0);
    if (mpm_flag >= 0) {
      cab.encode_tu_bypass(2, mpm_flag);
    } else {
      int rem = mode;
      int srt[3] = {mpm[0], mpm[1], mpm[2]};
      std::sort(srt, srt + 3);
      for (int i = 2; i >= 0; i--)
        if (rem > srt[i]) rem--;
      cab.encode_bypass_bits((uint32_t)rem, 5);
    }

    for (int by = by0; by < by0 + nb; by++)
      for (int bx = bx0; bx < bx0 + nb; bx++)
        ct_depth[(i64)by * w4 + bx] = (u8)depth;

    cab.encode_bin(ctx(F_INTRA_CHROMA), 0);    // derived chroma mode
    int cmode = mode;
    int cqp = chroma_qp(std::min(std::max(qp, 0), 57));

    // chroma prepass (single leaf in the fast path): prepare + recon
    int clog2 = log2 > 2 ? log2 - 1 : 2;
    TuData cb_tu, cr_tu;
    prepare_tu(x0, y0, clog2, 1, cmode, cqp, &cb_tu);
    recon_tu(x0, y0, clog2, 1, cmode, cqp, cb_tu.coeffs, cb_tu.pred,
             cb_tu.cbf);
    prepare_tu(x0, y0, clog2, 2, cmode, cqp, &cr_tu);
    recon_tu(x0, y0, clog2, 2, cmode, cqp, cr_tu.coeffs, cr_tu.pred,
             cr_tu.cbf);

    emit_tt(x0, y0, log2, 0, true, true, qp, cqp, mode, cmode, &cb_tu,
            &cr_tu, 0, nullptr, nullptr);

    for (int by = by0; by < by0 + nb; by++)
      for (int bx = bx0; bx < bx0 + nb; bx++)
        syn_avail[(i64)by * w4 + bx] = 1;
  }

  void quadtree(int x0, int y0, int log2, int depth) {
    if (rc) return;
    int size = 1 << log2;
    bool inside = x0 + size <= width && y0 + size <= height;
    bool split = log2 > cu_log2;
    if (inside && log2 > min_cb_log2) {
      int ctx_inc = 0;
      if (syn_av(x0 - 1, y0) &&
          ct_depth[(i64)(y0 >> 2) * w4 + ((x0 - 1) >> 2)] > depth)
        ctx_inc++;
      if (syn_av(x0, y0 - 1) &&
          ct_depth[(i64)((y0 - 1) >> 2) * w4 + (x0 >> 2)] > depth)
        ctx_inc++;
      cab.encode_bin(ctx(F_SPLIT_CU, ctx_inc), split ? 1 : 0);
    }
    if (split) {
      int half = size >> 1;
      static const int order[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};
      for (int i = 0; i < 4; i++) {
        int x1 = x0 + order[i][1] * half;
        int y1 = y0 + order[i][0] * half;
        if (x1 < width && y1 < height)
          quadtree(x1, y1, log2 - 1, depth + 1);
      }
    } else {
      encode_cu(x0, y0, log2, depth);
    }
  }

  int run() {
    tab_init();
    for (int k = 0; k < 3; k++) {
      scans4[k] = make_scan(k, 4);
      for (int l = 0; l < 4; l++) sb_scans[k][l] = make_scan(k, 1 << l);
    }
    int ctb = 1 << ctb_log2;
    int n_cols = width / ctb, n_rows = height / ctb;
    for (int row = 0; row < n_rows && !rc; row++)
      for (int col = 0; col < n_cols && !rc; col++) {
        quadtree(col * ctb, row * ctb, ctb_log2, 0);
        bool last = row == n_rows - 1 && col == n_cols - 1;
        cab.encode_terminate(last ? 1 : 0);
      }
    if (!rc) cab.flush();
    return rc;
  }
};

}  // namespace hevc_enc

extern "C" {

// returns 0 on success (payload written), 1 on unsupported/overflow.
// params: [qp, ctb_log2, cu_log2, padded_w, padded_h, fixed_mode(-1 =
// auto), strong_smoothing, max_tb_log2]
int tpuheif_hevc_encode_slice(
    const int32_t* params, const int32_t* fam,
    const uint8_t* init_p_state, const uint8_t* init_val_mps,
    int32_t n_ctx, const int32_t* src_y, const int32_t* src_cb,
    const int32_t* src_cr, const int32_t* dst4, const int32_t* dct4,
    const int32_t* dct8, const int32_t* dct16, const int32_t* dct32,
    uint8_t* out_buf, int64_t out_cap, int64_t* out_len,
    int32_t* recon_y, int32_t* recon_cb, int32_t* recon_cr,
    char* err, int32_t errlen) {
  using namespace hevc_enc;
  Enc e;
  e.qp = params[0];
  e.ctb_log2 = params[1];
  e.cu_log2 = params[2];
  e.width = params[3];
  e.height = params[4];
  e.fixed_mode = params[5];
  e.strong_smooth = params[6];
  e.max_tb_log2 = params[7];
  e.fam = fam;
  e.dst4 = dst4;
  e.dct[2] = dct4; e.dct[3] = dct8; e.dct[4] = dct16; e.dct[5] = dct32;
  e.src[0] = src_y; e.src[1] = src_cb; e.src[2] = src_cr;
  e.err = err;
  e.errlen = errlen;
  e.pw[0] = e.width; e.ph[0] = e.height;
  e.pw[1] = e.pw[2] = e.width >> 1;
  e.ph[1] = e.ph[2] = e.height >> 1;
  for (int pl = 0; pl < 3; pl++)
    e.recon[pl].assign((i64)e.pw[pl] * e.ph[pl], 0);
  e.w4 = (e.width + 3) / 4 + 1;
  e.h4 = (e.height + 3) / 4 + 1;
  e.syn_avail.assign((i64)e.w4 * e.h4, 0);
  e.recon_avail.assign((i64)e.w4 * e.h4, 0);
  e.intra_mode_y.assign((i64)e.w4 * e.h4, 0);
  e.ct_depth.assign((i64)e.w4 * e.h4, 0);

  std::vector<u8> ps(init_p_state, init_p_state + n_ctx);
  std::vector<u8> vm(init_val_mps, init_val_mps + n_ctx);
  e.cab.p_state = ps.data();
  e.cab.val_mps = vm.data();
  e.cab.trace = getenv("TPUHEIF_ENC_TRACE") != nullptr;

  int rc = e.run();
  if (rc) return rc;
  if ((int64_t)e.cab.bytes.size() > out_cap) {
    snprintf(err, errlen, "output buffer too small");
    return 1;
  }
  memcpy(out_buf, e.cab.bytes.data(), e.cab.bytes.size());
  *out_len = (int64_t)e.cab.bytes.size();
  if (recon_y) {
    // closed-loop reconstruction (callers use it for RD metrics and
    // the encoder difftests)
    memcpy(recon_y, e.recon[0].data(), e.recon[0].size() * sizeof(i32));
    memcpy(recon_cb, e.recon[1].data(), e.recon[1].size() * sizeof(i32));
    memcpy(recon_cr, e.recon[2].data(), e.recon[2].size() * sizeof(i32));
  }
  return 0;
}

}  // extern "C"
