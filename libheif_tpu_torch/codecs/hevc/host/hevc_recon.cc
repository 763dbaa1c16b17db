// HEVC intra reconstruction + in-loop filters (host engine).
//
// A copy of libheif_tpu/native/src/hevc_recon.cc, the JAX package's C++
// reconstructor: the per-TU serial dependency chain (each TU predicts
// from already-reconstructed neighbors), deblocking and SAO, over the raw
// TU stream of tpuheif_hevc_parse_slice (host/hevc_parse.cc), so the
// engine never materializes per-TU Python objects.  Semantics mirror the
// numpy IntraReconstructor / Deblocker / apply_sao (recon.py,
// filters.py) of a picture of one slice.  Authoritative tables (DST/DCT
// matrices, beta/tc, intra angles) are computed in Python (tables.py)
// and passed in.
//
// The port runs it serially, after the whole picture is parsed
// (native_parse.decode_picture_native).  The JAX package's streaming
// consumer, which reconstructed CTB rows while a second thread parsed
// them, is left out: under load it gave wrong samples.  So is its
// profiling printout; the caller's trace spans time the call.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <vector>

namespace {

static const uint8_t kChromaQpMap[44 - 30 + 1] = {
    29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37, 38};

static int chroma_qp(int qpi) {
  if (qpi < 30) return qpi;
  if (qpi > 43) return qpi - 6;
  return kChromaQpMap[qpi - 30];
}

static const int64_t kLevelScale[6] = {40, 45, 51, 57, 64, 72};

static inline int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

enum RParamIdx {
  R_PIC_WIDTH = 0,
  R_PIC_HEIGHT,
  R_LOG2_CTB,
  R_BIT_DEPTH,
  R_BIT_DEPTH_CHROMA,
  R_STRONG_SMOOTHING,
  R_DEBLOCK_DISABLED,
  R_BETA_OFFSET,            // already *2
  R_TC_OFFSET,              // already *2
  R_PPS_CB_QP_OFFSET,
  R_PPS_CR_QP_OFFSET,
  R_SAO_PRESENT,
  R_N_PARAMS
};

struct Recon {
  int32_t P[R_N_PARAMS];
  const int32_t* tu_meta;
  int64_t n_tus;
  const int32_t* coeff_buf;
  const uint8_t *tu_log2_map, *cu_log2_map, *tqb_map;
  const int16_t* qp_y;
  int32_t w4s, h4s;           // syntax-map stride dims
  const int16_t* sao_buf;
  const int32_t *dst4, *dct[6];  // dct[2..5] = 4..32
  const int32_t *beta_table, *tc_table;
  const int32_t *pred_angle, *inv_angle;  // indexed by mode 0..34
  // 8-bit engine: pixel planes are u16 (halved bandwidth, wider SIMD
  // lanes in deblock/SAO); arithmetic stays in int registers
  uint16_t* planes[3];
  int w, h, cw, ch, bd;

  std::vector<uint8_t> avail;  // recon z-order availability, 4x4 luma
  int aw4, ah4;

  char errmsg[200] = {0};
  int errcode = 0;

  void fail(const char* m) {
    if (!errcode) {
      errcode = 1;
      snprintf(errmsg, sizeof(errmsg), "%s", m);
    }
  }

  bool sample_avail(int lx, int ly) const {
    if (lx < 0 || ly < 0 || lx >= w || ly >= h) return false;
    return avail[(int64_t)(ly >> 2) * aw4 + (lx >> 2)] != 0;
  }

  // ------------------------------------------------------------- residual

  // dequant + inverse transform into res[n*n] (recon.py dequant /
  // inverse_transform)
  void residual(const int32_t* m, int32_t* res) {
    int log2 = m[2], c_idx = m[3], qp = m[5];
    int n = 1 << log2;
    const int32_t* coeffs = coeff_buf + m[9];
    if (m[8]) {  // transquant bypass
      memcpy(res, coeffs, (size_t)n * n * sizeof(int32_t));
      return;
    }
    // dequant (spec 8.6.3, flat list m=16)
    int bd_shift = bd + log2 - 5;
    int64_t scale = kLevelScale[qp % 6] << (qp / 6);
    // coefficients are sparse: track the last nonzero row/col so both
    // matmul stages skip the all-zero tail (int32 accumulators are
    // exact: |M| <= 90, |d|,|e| <= 32767, n <= 32 -> |acc| < 2^27.5)
    int32_t d[32 * 32];
    int nzr = 0, nzc = 0;
    for (int r2 = 0; r2 < n; r2++) {
      bool rnz = false;
      for (int c2 = 0; c2 < n; c2++) {
        int32_t cv = coeffs[r2 * n + c2];
        if (cv == 0) {
          d[r2 * n + c2] = 0;
          continue;
        }
        int64_t v = ((int64_t)cv * 16 * scale +
                     ((int64_t)1 << (bd_shift - 1))) >> bd_shift;
        d[r2 * n + c2] =
            (int32_t)(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
        rnz = true;
        if (c2 >= nzc) nzc = c2 + 1;
      }
      if (rnz) nzr = r2 + 1;
    }
    if (m[7]) {  // transform skip (4x4)
      int ts_shift = 5 + log2;
      int bd_shift2 = 20 - bd;
      for (int i = 0; i < n * n; i++) {
        int64_t r = ((int64_t)d[i] << ts_shift);
        res[i] = (int32_t)((r + ((int64_t)1 << (bd_shift2 - 1))) >>
                           bd_shift2);
      }
      return;
    }
    const int32_t* M = (c_idx == 0 && n == 4) ? dst4 : dct[log2];
    // stage 1: e = clip((M^T @ d + 64) >> 7)   [e is n x n]; rows of d
    // beyond nzr are zero, columns beyond nzc are zero
    int32_t e[32 * 32];
    for (int i = 0; i < n; i++) {        // row of e
      for (int j = 0; j < nzc; j++) {    // col
        int32_t acc = 0;
        for (int k = 0; k < nzr; k++)
          acc += M[k * n + i] * d[k * n + j];
        int32_t v = (acc + 64) >> 7;
        e[i * n + j] = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
      }
    }
    // stage 2: r = clip((e @ M + off) >> shift2); e columns beyond nzc
    // are zero
    int shift2 = 20 - bd;
    int32_t off = 1 << (shift2 - 1);
    for (int i = 0; i < n; i++) {
      for (int j = 0; j < n; j++) {
        int32_t acc = 0;
        for (int k = 0; k < nzc; k++)
          acc += e[i * n + k] * M[k * n + j];
        int32_t v = (acc + off) >> shift2;
        res[i * n + j] = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
      }
    }
  }

  // ------------------------------------------------------------ reference

  // ref[4n+1]: bottom-left .. corner .. top-right (recon.py _gather_refs)
  void gather_refs(const int32_t* m, int32_t* ref) {
    int log2 = m[2], c_idx = m[3];
    int n = 1 << log2;
    int shift = c_idx ? 1 : 0;
    int px = c_idx ? (m[0] >> shift) : m[0];
    int py = c_idx ? (m[1] >> shift) : m[1];
    const uint16_t* plane = planes[c_idx];
    int pw = c_idx ? cw : w, ph = c_idx ? ch : h;

    int total = 4 * n + 1;
    std::vector<uint8_t> av((size_t)total, 0);
    bool any = false, all = true;
    for (int i = 0; i < total; i++) {
      int sx, sy;
      if (i < 2 * n) {                  // left column bottom -> top
        sx = px - 1;
        sy = py + 2 * n - 1 - i;
      } else if (i == 2 * n) {          // corner
        sx = px - 1;
        sy = py - 1;
      } else {                          // top row left -> right
        sx = px + (i - 2 * n - 1);
        sy = py - 1;
      }
      int lx = c_idx ? (sx << shift) : sx;
      int ly = c_idx ? (sy << shift) : sy;
      ref[i] = 0;
      if (sx >= 0 && sx < pw && sy >= 0 && sy < ph &&
          sample_avail(lx, ly)) {
        ref[i] = plane[(int64_t)sy * pw + sx];
        av[i] = 1;
        any = true;
      } else {
        all = false;
      }
    }
    if (!any) {
      for (int i = 0; i < total; i++) ref[i] = 1 << (bd - 1);
      return;
    }
    if (!all) {
      if (!av[0]) {
        int idx = 0;
        while (!av[idx]) idx++;
        ref[0] = ref[idx];
        av[0] = 1;
      }
      for (int i = 1; i < total; i++)
        if (!av[i]) ref[i] = ref[i - 1];
    }
  }

  // (recon.py _filter_refs)
  void filter_refs(const int32_t* m, int32_t* ref) {
    int log2 = m[2], c_idx = m[3], mode = m[4];
    int n = 1 << log2;
    if (c_idx != 0 || n == 4 || mode == 1 /* DC */) return;
    int dist = abs(mode - 26) < abs(mode - 10) ? abs(mode - 26)
                                               : abs(mode - 10);
    int thresh = n == 8 ? 7 : (n == 16 ? 1 : 0);
    if (mode != 0 /* planar */ && dist <= thresh) return;
    int corner = 2 * n;
    int total = 4 * n + 1;
    if (n == 32 && P[R_STRONG_SMOOTHING]) {
      bool flat_top =
          abs(ref[corner] + ref[4 * n] - 2 * ref[corner + n]) <
          (1 << (bd - 5));
      bool flat_left =
          abs(ref[corner] + ref[0] - 2 * ref[n]) < (1 << (bd - 5));
      if (flat_top && flat_left) {
        std::vector<int32_t> out(ref, ref + total);
        for (int i = 1; i < 2 * n; i++) {
          out[corner + i] = ((2 * n - i) * ref[corner] + i * ref[4 * n] +
                             n) >> (log2 + 1);
          out[corner - i] = ((2 * n - i) * ref[corner] + i * ref[0] + n) >>
                            (log2 + 1);
        }
        memcpy(ref, out.data(), (size_t)total * sizeof(int32_t));
        return;
      }
    }
    std::vector<int32_t> out(ref, ref + total);
    for (int i = 1; i < total - 1; i++)
      out[i] = (ref[i - 1] + 2 * ref[i] + ref[i + 1] + 2) >> 2;
    memcpy(ref, out.data(), (size_t)total * sizeof(int32_t));
  }

  // ------------------------------------------------------------ predictor

  void predict(const int32_t* m, int32_t* pred) {
    int log2 = m[2], c_idx = m[3], mode = m[4];
    int n = 1 << log2;
    std::vector<int32_t> refbuf((size_t)4 * n + 1);
    int32_t* ref = refbuf.data();
    gather_refs(m, ref);
    filter_refs(m, ref);
    int corner = 2 * n;
    // left[i] = ref[corner-1-i], top[i] = ref[corner+1+i]  (len 2n each)
    const int32_t* topp = ref + corner + 1;
    int cval = ref[corner];
    auto leftv = [&](int i) { return ref[corner - 1 - i]; };

    if (mode == 0) {  // planar
      int tr = topp[n], bl = leftv(n);
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++)
          pred[y * n + x] =
              ((n - 1 - x) * leftv(y) + (x + 1) * tr +
               (n - 1 - y) * topp[x] + (y + 1) * bl + n) >> (log2 + 1);
      return;
    }
    if (mode == 1) {  // DC
      int64_t s = 0;
      for (int i = 0; i < n; i++) s += topp[i] + leftv(i);
      int dc = (int)((s + n) >> (log2 + 1));
      for (int i = 0; i < n * n; i++) pred[i] = dc;
      if (c_idx == 0 && n < 32) {
        pred[0] = (leftv(0) + 2 * dc + topp[0] + 2) >> 2;
        for (int x = 1; x < n; x++) pred[x] = (topp[x] + 3 * dc + 2) >> 2;
        for (int y = 1; y < n; y++)
          pred[y * n] = (leftv(y) + 3 * dc + 2) >> 2;
      }
      return;
    }

    int angle = pred_angle[mode];
    int maxv = (1 << bd) - 1;
    bool vertical = mode >= 18;
    // main/side edge selection (recon.py _predict)
    std::vector<int32_t> main_src((size_t)2 * n), side_src((size_t)2 * n);
    for (int i = 0; i < 2 * n; i++) {
      main_src[i] = vertical ? topp[i] : leftv(i);
      side_src[i] = vertical ? leftv(i) : topp[i];
    }

    int lo = angle < 0 ? ((n * angle) >> 5 < 0 ? (n * angle) >> 5 : 0) : 0;
    int off = -lo;
    std::vector<int32_t> er((size_t)(off + 2 * n + 1), 0);
    er[off] = cval;
    for (int i = 0; i < 2 * n; i++) er[off + 1 + i] = main_src[i];
    if (angle < 0) {
      int inv = inv_angle[mode];
      for (int x = -1; x >= lo; x--) {
        int idx = (x * inv + 128) >> 8;
        er[off + x] = idx == 0
                          ? cval
                          : side_src[(idx - 1) < (2 * n - 1) ? (idx - 1)
                                                             : (2 * n - 1)];
      }
    }

    int hi = (int)er.size() - 1;
    // predT[d][pos]; pred = predT (vertical) or transpose (horizontal)
    for (int di = 0; di < n; di++) {
      int k = di + 1;
      int i_idx = (k * angle) >> 5;
      int f = (k * angle) & 31;
      int base = off + i_idx + 1;
      for (int p = 0; p < n; p++) {
        int idx0 = p + base;
        if (idx0 > hi) idx0 = hi;
        int v;
        if (f == 0) {
          v = er[idx0];
        } else {
          int idx1 = p + base + 1;
          if (idx1 > hi) idx1 = hi;
          v = ((32 - f) * er[idx0] + f * er[idx1] + 16) >> 5;
        }
        if (vertical)
          pred[di * n + p] = v;
        else
          pred[p * n + di] = v;
      }
    }

    if (angle == 0 && c_idx == 0 && n < 32) {
      if (vertical) {  // mode 26
        for (int y = 0; y < n; y++)
          pred[y * n] = clip3(0, maxv, topp[0] + ((leftv(y) - cval) >> 1));
      } else {         // mode 10
        for (int x = 0; x < n; x++)
          pred[x] = clip3(0, maxv, leftv(0) + ((topp[x] - cval) >> 1));
      }
    }
  }

  // ----------------------------------------------------------- recon loop

  void reconstruct_range(int64_t t_begin, int64_t t_end) {
    int maxv = (1 << bd) - 1;
    int32_t pred[32 * 32], res[32 * 32];
    for (int64_t t = t_begin; t < t_end; t++) {
      const int32_t* m = tu_meta + t * 10;
      int log2 = m[2], c_idx = m[3];
      int n = 1 << log2;
      int shift = c_idx ? 1 : 0;
      int px = c_idx ? (m[0] >> shift) : m[0];
      int py = c_idx ? (m[1] >> shift) : m[1];
      predict(m, pred);
      if (m[9] >= 0) {
        residual(m, res);
        for (int i = 0; i < n * n; i++) pred[i] += res[i];
      }
      uint16_t* plane = planes[c_idx];
      int pw = c_idx ? cw : w, ph = c_idx ? ch : h;
      int hh = n < ph - py ? n : ph - py;
      int ww = n < pw - px ? n : pw - px;
      for (int y = 0; y < hh; y++)
        for (int x = 0; x < ww; x++)
          plane[(int64_t)(py + y) * pw + px + x] =
              clip3(0, maxv, pred[y * n + x]);
      if (c_idx == 0) {
        for (int by = m[1] >> 2; by < (m[1] + n) >> 2; by++)
          for (int bx = m[0] >> 2; bx < (m[0] + n) >> 2; bx++)
            avail[(int64_t)by * aw4 + bx] = 1;
      }
    }
  }

  // ------------------------------------------------------------- deblock

  bool is_block_edge(int x, int y, bool vertical) const {
    int bx = x >> 2, by = y >> 2;
    int tu_l2 = tu_log2_map[(int64_t)by * w4s + bx];
    int cu_l2 = cu_log2_map[(int64_t)by * w4s + bx];
    if (tu_l2 == 0) tu_l2 = cu_l2 ? cu_l2 : 3;
    int pos = vertical ? x : y;
    return (pos % (1 << tu_l2) == 0) ||
           (cu_l2 && pos % (1 << cu_l2) == 0);
  }

  int avg_qp(int x, int y, bool vertical) const {
    int qp_p, qp_q;
    if (vertical) {
      qp_p = qp_y[(int64_t)(y >> 2) * w4s + ((x - 1) >> 2)];
      qp_q = qp_y[(int64_t)(y >> 2) * w4s + (x >> 2)];
    } else {
      qp_p = qp_y[(int64_t)((y - 1) >> 2) * w4s + (x >> 2)];
      qp_q = qp_y[(int64_t)(y >> 2) * w4s + (x >> 2)];
    }
    return (qp_p + qp_q + 1) >> 1;
  }

  void luma_pass(bool vertical) {
    uint16_t* plane = planes[0];
    int maxv = (1 << bd) - 1;
    int edge_end = vertical ? w : h;
    int seg_end = vertical ? h : w;
    for (int pos = 8; pos < edge_end; pos += 8) {
      for (int seg = 0; seg < seg_end; seg += 4) {
        int x = vertical ? pos : seg;
        int y = vertical ? seg : pos;
        if (!is_block_edge(x, y, vertical)) continue;
        // boundary guards (filters.py _filter_luma_segment)
        int n_lines = vertical ? (h - y < 4 ? h - y : 4)
                               : (w - x < 4 ? w - x : 4);
        if (n_lines <= 0) continue;
        if (vertical && (x < 4 || x > w - 4)) continue;
        if (!vertical && (y < 4 || y > h - 4)) continue;
        if (n_lines < 4) continue;

        // lines[i][j]: j=0..7 = [p3 p2 p1 p0 q0 q1 q2 q3]
        int32_t lines[4][8];
        for (int i = 0; i < 4; i++)
          for (int j = 0; j < 8; j++)
            lines[i][j] = vertical
                              ? plane[(int64_t)(y + i) * w + x - 4 + j]
                              : plane[(int64_t)(y - 4 + j) * w + x + i];

        int qp = avg_qp(x, y, vertical);
        // beta/tc scale with bit depth (spec 8.7.2.5.3)
        int beta = beta_table[clip3(0, 51, qp + P[R_BETA_OFFSET])]
                   << (bd - 8);
        int tc =
            tc_table[clip3(0, 53, qp + 2 * (2 - 1) + P[R_TC_OFFSET])]
            << (bd - 8);
        if (beta == 0 && tc == 0) continue;

        auto pv = [&](int i, int j) { return lines[i][3 - j]; };
        auto qv = [&](int i, int j) { return lines[i][4 + j]; };

        int dp0 = abs(pv(0, 2) - 2 * pv(0, 1) + pv(0, 0));
        int dp3 = abs(pv(3, 2) - 2 * pv(3, 1) + pv(3, 0));
        int dq0 = abs(qv(0, 2) - 2 * qv(0, 1) + qv(0, 0));
        int dq3 = abs(qv(3, 2) - 2 * qv(3, 1) + qv(3, 0));
        int dpq0 = dp0 + dq0, dpq3 = dp3 + dq3;
        int d = dpq0 + dpq3;
        if (d >= beta) continue;

        auto strong_line = [&](int i) {
          int dpq = i == 0 ? dpq0 : dpq3;
          return 2 * dpq < (beta >> 2) &&
                 abs(pv(i, 3) - pv(i, 0)) + abs(qv(i, 0) - qv(i, 3)) <
                     (beta >> 3) &&
                 abs(pv(i, 0) - qv(i, 0)) < ((5 * tc + 1) >> 1);
        };
        bool strong = strong_line(0) && strong_line(3);

        int32_t out[4][8];
        memcpy(out, lines, sizeof(out));
        if (strong) {
          for (int i = 0; i < 4; i++) {
            int p0 = pv(i, 0), p1 = pv(i, 1), p2 = pv(i, 2), p3 = pv(i, 3);
            int q0 = qv(i, 0), q1 = qv(i, 1), q2 = qv(i, 2), q3 = qv(i, 3);
            int c2 = 2 * tc;
            int np0 = clip3(p0 - c2, p0 + c2,
                            (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
            int np1 = clip3(p1 - c2, p1 + c2, (p2 + p1 + p0 + q0 + 2) >> 2);
            int np2 = clip3(p2 - c2, p2 + c2,
                            (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
            int nq0 = clip3(q0 - c2, q0 + c2,
                            (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
            int nq1 = clip3(q1 - c2, q1 + c2, (p0 + q0 + q1 + q2 + 2) >> 2);
            int nq2 = clip3(q2 - c2, q2 + c2,
                            (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3);
            out[i][1] = np2;
            out[i][2] = np1;
            out[i][3] = np0;
            out[i][4] = nq0;
            out[i][5] = nq1;
            out[i][6] = nq2;
          }
        } else {
          int d_ep = (dp0 + dp3 < ((beta + (beta >> 1)) >> 3)) ? 1 : 0;
          int d_eq = (dq0 + dq3 < ((beta + (beta >> 1)) >> 3)) ? 1 : 0;
          for (int i = 0; i < 4; i++) {
            int p0 = pv(i, 0), p1 = pv(i, 1), p2 = pv(i, 2);
            int q0 = qv(i, 0), q1 = qv(i, 1), q2 = qv(i, 2);
            int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
            if (abs(delta) >= tc * 10) continue;
            delta = clip3(-tc, tc, delta);
            out[i][3] = clip3(0, maxv, p0 + delta);
            out[i][4] = clip3(0, maxv, q0 - delta);
            if (d_ep) {
              int dp = clip3(-(tc >> 1), tc >> 1,
                             ((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1));
              out[i][2] = clip3(0, maxv, p1 + dp);
            }
            if (d_eq) {
              int dq = clip3(-(tc >> 1), tc >> 1,
                             ((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1));
              out[i][5] = clip3(0, maxv, q1 + dq);
            }
          }
        }
        for (int i = 0; i < 4; i++)
          for (int j = 0; j < 8; j++) {
            int v = clip3(0, maxv, out[i][j]);
            if (vertical)
              plane[(int64_t)(y + i) * w + x - 4 + j] = v;
            else
              plane[(int64_t)(y - 4 + j) * w + x + i] = v;
          }
      }
    }
  }

  void chroma_pass(bool vertical) {
    for (int c_idx = 1; c_idx <= 2; c_idx++) {
      uint16_t* plane = planes[c_idx];
      int maxv = (1 << P[R_BIT_DEPTH_CHROMA]) - 1;
      int off = c_idx == 1 ? P[R_PPS_CB_QP_OFFSET] : P[R_PPS_CR_QP_OFFSET];
      int edge_end = vertical ? cw : ch;
      int seg_end = vertical ? ch : cw;
      for (int pos = 8; pos < edge_end; pos += 8) {
        for (int seg = 0; seg < seg_end; seg += 4) {
          int x = vertical ? pos : seg;
          int y = vertical ? seg : pos;
          int lx = x << 1, ly = y << 1;
          if (!is_block_edge(lx, ly, vertical)) continue;
          int n = vertical ? (ch - y < 4 ? ch - y : 4)
                           : (cw - x < 4 ? cw - x : 4);
          if (n <= 0) continue;
          int qp_l = avg_qp(lx, ly, vertical);
          int qpc = chroma_qp(clip3(0, 57, qp_l + off));
          int tc = tc_table[clip3(0, 53, qpc + 2 + P[R_TC_OFFSET])]
                   << (P[R_BIT_DEPTH_CHROMA] - 8);
          if (tc == 0) continue;
          for (int i = 0; i < n; i++) {
            int p1, p0, q0, q1;
            if (vertical) {
              p1 = plane[(int64_t)(y + i) * cw + x - 2];
              p0 = plane[(int64_t)(y + i) * cw + x - 1];
              q0 = plane[(int64_t)(y + i) * cw + x];
              q1 = plane[(int64_t)(y + i) * cw + x + 1];
            } else {
              p1 = plane[(int64_t)(y - 2) * cw + x + i];
              p0 = plane[(int64_t)(y - 1) * cw + x + i];
              q0 = plane[(int64_t)y * cw + x + i];
              q1 = plane[(int64_t)(y + 1) * cw + x + i];
            }
            int delta =
                clip3(-tc, tc, (((q0 - p0) * 4) + p1 - q1 + 4) >> 3);
            int np0 = clip3(0, maxv, p0 + delta);
            int nq0 = clip3(0, maxv, q0 - delta);
            if (vertical) {
              plane[(int64_t)(y + i) * cw + x - 1] = np0;
              plane[(int64_t)(y + i) * cw + x] = nq0;
            } else {
              plane[(int64_t)(y - 1) * cw + x + i] = np0;
              plane[(int64_t)y * cw + x + i] = nq0;
            }
          }
        }
      }
    }
  }

  // ----------------------------------------------------------------- SAO

  void apply_sao() {
    if (!P[R_SAO_PRESENT]) return;
    int ctb = 1 << P[R_LOG2_CTB];
    int n_ctb_cols = (w + ctb - 1) / ctb;
    int n_ctb_rows = (h + ctb - 1) / ctb;
    static const int eo_dx[4][2] = {{-1, 1}, {0, 0}, {-1, 1}, {1, -1}};
    static const int eo_dy[4][2] = {{0, 0}, {-1, 1}, {-1, 1}, {-1, 1}};

    for (int c_idx = 0; c_idx < 3; c_idx++) {
      int shift = c_idx == 0 ? 0 : 1;
      int pw = c_idx ? cw : w, ph = c_idx ? ch : h;
      int maxv = (1 << bd) - 1;
      uint16_t* plane = planes[c_idx];
      std::vector<int32_t> src(plane, plane + (int64_t)pw * ph);

      for (int cy = 0; cy < n_ctb_rows; cy++) {
        for (int cx = 0; cx < n_ctb_cols; cx++) {
          const int16_t* e = sao_buf + ((int64_t)cy * n_ctb_cols + cx) * 20;
          int t = e[c_idx];
          if (t == 0) continue;
          int x0 = (cx * ctb) >> shift;
          int y0 = (cy * ctb) >> shift;
          int x1 = x0 + (ctb >> shift) < pw ? x0 + (ctb >> shift) : pw;
          int y1 = y0 + (ctb >> shift) < ph ? y0 + (ctb >> shift) : ph;
          if (x0 >= x1 || y0 >= y1) continue;
          const int16_t* offs = e + 3 + c_idx * 4;
          if (t == 1) {  // band: 32-entry offset table kills the k-loop
            int band_pos = e[15 + c_idx];
            int32_t bofs[32] = {0};
            for (int k = 0; k < 4; k++) bofs[(band_pos + k) & 31] = offs[k];
            int sh5 = bd - 5;
            for (int y = y0; y < y1; y++) {
              const int32_t* sr = src.data() + (int64_t)y * pw;
              uint16_t* dr = plane + (int64_t)y * pw;
              for (int x = x0; x < x1; x++) {
                int v = sr[x];
                dr[x] = (uint16_t)clip3(0, maxv, v + bofs[(v >> sh5) & 31]);
              }
            }
          } else {       // edge
            int eo = e[18 + (c_idx == 0 ? 0 : 1)];
            int dx0 = eo_dx[eo][0], dx1 = eo_dx[eo][1];
            int dy0 = eo_dy[eo][0], dy1 = eo_dy[eo][1];
            int mindx = dx0 < dx1 ? dx0 : dx1;
            int maxdx = dx0 > dx1 ? (dx0 > 0 ? dx0 : 0)
                                  : (dx1 > 0 ? dx1 : 0);
            int mindy = dy0 < dy1 ? dy0 : dy1;
            int maxdy = dy0 > dy1 ? (dy0 > 0 ? dy0 : 0)
                                  : (dy1 > 0 ? dy1 : 0);
            int ys0 = y0 > -mindy ? y0 : -mindy;
            int ys1 = y1 < ph - maxdy ? y1 : ph - maxdy;
            int gx0 = x0 > -mindx ? x0 : -mindx;
            int gx1 = x1 < pw - maxdx ? x1 : pw - maxdx;
            if (gx0 >= gx1 || ys0 >= ys1) continue;
            // 5-entry table over edge_idx; branchless interior rows
            const int32_t eofs[5] = {offs[0], offs[1], 0, offs[2], offs[3]};
            for (int y = y0; y < y1; y++) {
              const int32_t* sr = src.data() + (int64_t)y * pw;
              const int32_t* s1 = sr + (int64_t)dy0 * pw + dx0;
              const int32_t* s2 = sr + (int64_t)dy1 * pw + dx1;
              uint16_t* dr = plane + (int64_t)y * pw;
              bool row_in = (y >= ys0 && y < ys1);
              if (row_in) {
                for (int x = gx0; x < gx1; x++) {
                  int v = sr[x];
                  int e_idx = 2 + ((v > s1[x]) - (v < s1[x])) +
                              ((v > s2[x]) - (v < s2[x]));
                  dr[x] = (uint16_t)clip3(0, maxv, v + eofs[e_idx]);
                }
              }
              // untouched border columns/rows just copy through
              int cxa = row_in ? gx0 : x1;
              for (int x = x0; x < cxa; x++)
                dr[x] = (uint16_t)clip3(0, maxv, sr[x]);
              int cxb = row_in ? gx1 : x1;
              for (int x = cxb; x < x1; x++)
                dr[x] = (uint16_t)clip3(0, maxv, sr[x]);
            }
          }
        }
      }

      // transquant-bypass passthrough (filters.py apply_sao tail)
      for (int by = 0; by < h4s; by++)
        for (int bx = 0; bx < w4s; bx++) {
          if (!tqb_map[(int64_t)by * w4s + bx]) continue;
          int yy0 = (by * 4) >> shift;
          int xx0 = (bx * 4) >> shift;
          int step = 4 >> shift;
          for (int y = yy0; y < yy0 + step && y < ph; y++)
            for (int x = xx0; x < xx0 + step && x < pw; x++)
              plane[(int64_t)y * pw + x] = src[(int64_t)y * pw + x];
        }
    }
  }

  int run(int deblock_and_sao) {
    aw4 = (w + 3) / 4 + 1;
    ah4 = (h + 3) / 4 + 1;
    avail.assign((size_t)aw4 * ah4, 0);
    reconstruct_range(0, n_tus);
    if (errcode) return errcode;
    if (deblock_and_sao) {
      if (!P[R_DEBLOCK_DISABLED]) {
        luma_pass(true);
        chroma_pass(true);
        luma_pass(false);
        chroma_pass(false);
      }
      apply_sao();
    }
    return errcode;
  }
};

}  // namespace

extern "C" {

int tpuheif_hevc_recon(
    const int32_t* rparams, const int32_t* tu_meta, int64_t n_tus,
    const int32_t* coeff_buf, const uint8_t* tu_log2_map,
    const uint8_t* cu_log2_map, const int16_t* qp_y,
    const uint8_t* tqb_map, int32_t w4s, int32_t h4s,
    const int16_t* sao_buf, const int32_t* dst4, const int32_t* dct4,
    const int32_t* dct8, const int32_t* dct16, const int32_t* dct32,
    const int32_t* beta_table, const int32_t* tc_table,
    const int32_t* pred_angle, const int32_t* inv_angle,
    uint16_t* out_y, uint16_t* out_cb, uint16_t* out_cr,
    int32_t deblock_and_sao,
    char* err_msg, int32_t err_cap) {
  Recon rc;
  memcpy(rc.P, rparams, sizeof(rc.P));
  rc.tu_meta = tu_meta;
  rc.n_tus = n_tus;
  rc.coeff_buf = coeff_buf;
  rc.tu_log2_map = tu_log2_map;
  rc.cu_log2_map = cu_log2_map;
  rc.qp_y = qp_y;
  rc.tqb_map = tqb_map;
  rc.w4s = w4s;
  rc.h4s = h4s;
  rc.sao_buf = sao_buf;
  rc.dst4 = dst4;
  rc.dct[2] = dct4;
  rc.dct[3] = dct8;
  rc.dct[4] = dct16;
  rc.dct[5] = dct32;
  rc.beta_table = beta_table;
  rc.tc_table = tc_table;
  rc.pred_angle = pred_angle;
  rc.inv_angle = inv_angle;
  rc.w = rparams[R_PIC_WIDTH];
  rc.h = rparams[R_PIC_HEIGHT];
  rc.cw = rc.w >> 1;
  rc.ch = rc.h >> 1;
  rc.bd = rparams[R_BIT_DEPTH];
  rc.planes[0] = out_y;
  rc.planes[1] = out_cb;
  rc.planes[2] = out_cr;
  memset(out_y, 0, (size_t)rc.w * rc.h * sizeof(uint16_t));
  memset(out_cb, 0, (size_t)rc.cw * rc.ch * sizeof(uint16_t));
  memset(out_cr, 0, (size_t)rc.cw * rc.ch * sizeof(uint16_t));

  int code = rc.run(deblock_and_sao);
  if (code && err_msg && err_cap > 0)
    snprintf(err_msg, err_cap, "%s", rc.errmsg);
  return code;
}

}  // extern "C"
