// HT-J2K (ISO/IEC 15444-15 / ITU-T T.814) block coder — native
// drop-in for codecs/j2k/htj2k.py, which stays the conformance anchor
// (byte-identical encode, bit-exact decode; the pair is additionally
// oracle-checked against the OpenJPEG 2.5 HT decoder).  Replaces the
// reference's OpenJPH boundary (plugins/encoder_openjph.cc,
// codecs/jpeg2000_enc.h:84 Encoder_HTJ2K).
//
// The CxtVLC decode tables are normative spec constants; they are
// passed in from Python (codecs/j2k/ht_tables.py, single source of
// truth) via tpuheif_ht_set_tables, and the encoder-side candidate
// lists are derived here with the same dedupe + (len, cwd, e_k, e_1)
// ordering so encoder output stays byte-identical to the anchor.
//
// A copy of libheif_tpu/native/src/ht_j2k.cc, unchanged but for this
// paragraph; built with j2k_t1.cc as the j2k_host library
// (libheif_tpu_torch/_build.py J2K_HOST_LIBRARY).  The exports return 1
// for tables not yet set, a block wider or taller than 4096 or an
// output larger than the caller's buffer, and 2 for a cleanup segment
// that cannot be decoded or encoded (codecs/j2k/native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace ht_j2k {

typedef int64_t i64;
typedef int32_t i32;
typedef uint8_t u8;
typedef uint16_t u16;
typedef uint64_t u64;

// MEL state exponents E(k) (T.814 Table 4)
static const int MEL_E[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};

static u16 g_vlc_init[1024];
static u16 g_vlc_noninit[1024];
struct EncCand { u8 ln, cwd, e_k, e_1; };
// candidate lists per (ctx, rho, u_off) = [8][16][2]
static std::vector<EncCand> g_enc_init[8][16][2];
static std::vector<EncCand> g_enc_noninit[8][16][2];
static bool g_tables_set = false;

static void build_enc(const u16* tbl, std::vector<EncCand> enc[8][16][2]) {
  for (int c = 0; c < 8; c++) {
    bool seen[8][128] = {};      // [ln][cwd]
    for (int i = 0; i < 128; i++) {
      u16 v = tbl[c * 128 + i];
      int ln = v & 7;
      int cwd = i & ((1 << ln) - 1);
      if (seen[ln][cwd]) continue;
      seen[ln][cwd] = true;
      int rho = (v >> 4) & 0xF;
      int u_off = (v >> 3) & 1;
      int e_1 = (v >> 8) & 0xF;
      int e_k = (v >> 12) & 0xF;
      enc[c][rho][u_off].push_back({(u8)ln, (u8)cwd, (u8)e_k, (u8)e_1});
    }
  }
  for (int c = 0; c < 8; c++)
    for (int r = 0; r < 16; r++)
      for (int u = 0; u < 2; u++)
        std::sort(enc[c][r][u].begin(), enc[c][r][u].end(),
                  [](const EncCand& a, const EncCand& b) {
                    if (a.ln != b.ln) return a.ln < b.ln;
                    if (a.cwd != b.cwd) return a.cwd < b.cwd;
                    if (a.e_k != b.e_k) return a.e_k < b.e_k;
                    return a.e_1 < b.e_1;
                  });
}

static int bitlen(u64 v) { return v ? 64 - __builtin_clzll(v) : 0; }

// --------------------------------------------------------------- streams

// Forward byte stream, bits packed LSB-first; a byte following an
// emitted 0xFF holds only 7 data bits (htj2k.py MagSgnWriter).
struct MagSgnWriter {
  std::vector<u8> out;
  u64 acc = 0;
  int nbits = 0, cap = 8;

  void bits(u64 v, int n) {
    while (n > 0) {
      int take = std::min(n, cap - nbits);
      acc |= (v & (((u64)1 << take) - 1)) << nbits;
      v >>= take;
      n -= take;
      nbits += take;
      if (nbits == cap) {
        out.push_back((u8)acc);
        cap = acc == 0xFF ? 7 : 8;
        acc = 0;
        nbits = 0;
      }
    }
  }
  void flush() {
    if (nbits) {
      out.push_back((u8)acc);
      acc = 0;
      nbits = 0;
    }
    if (!out.empty() && out.back() == 0xFF) out.push_back(0);
  }
};

// Forward LSB-first reader with the 0xFF/7-bit rule; fill_byte is the
// past-the-end padding (0xFF for MagSgn, 0x00 for SigProp).
struct MagSgnReader {
  const u8* data;
  i64 len, pos = 0;
  u64 acc = 0;
  int nbits = 0;
  bool prev_ff = false;
  u8 fill_byte;

  MagSgnReader(const u8* d, i64 n, u8 fill) : data(d), len(n),
                                              fill_byte(fill) {}
  u64 bits(int n) {
    while (nbits < n) {
      u8 b = pos < len ? data[pos++] : fill_byte;
      int take = prev_ff ? 7 : 8;
      acc |= (u64)(b & ((1 << take) - 1)) << nbits;
      nbits += take;
      prev_ff = b == 0xFF;
    }
    u64 v = acc & (((u64)1 << n) - 1);
    acc >>= n;
    nbits -= n;
    return v;
  }
};

// MEL adaptive run coder (T.814 clause 7.2), MSB-first bytes.
struct MELEncoder {
  int k = 0, run = 0;
  std::vector<u8> out;
  int acc = 0, nbits = 0, cap = 8;

  void bit(int b) {
    acc = (acc << 1) | (b & 1);
    if (++nbits == cap) {
      out.push_back((u8)acc);
      cap = acc == 0xFF ? 7 : 8;
      acc = 0;
      nbits = 0;
    }
  }
  void event(int e) {
    if (!e) {
      if (++run == 1 << MEL_E[k]) {
        bit(1);
        run = 0;
        k = std::min(k + 1, 12);
      }
    } else {
      bit(0);
      for (int i = MEL_E[k] - 1; i >= 0; i--) bit((run >> i) & 1);
      run = 0;
      k = std::max(k - 1, 0);
    }
  }
  void flush() {
    if (run) bit(1);
    if (nbits) {
      acc <<= cap - nbits;
      out.push_back((u8)acc);
      acc = 0;
      nbits = 0;
    }
  }
};

struct MELDecoder {
  const u8* data;
  i64 len, pos = 0;
  int k = 0, acc = 0, nbits = 0;
  bool prev_ff = false;
  int zeros = 0, one = 0;

  MELDecoder(const u8* d, i64 n) : data(d), len(n) {}
  int bit() {
    if (nbits == 0) {
      u8 b = pos < len ? data[pos++] : 0xFF;
      nbits = prev_ff ? 7 : 8;
      acc = b & ((1 << nbits) - 1);
      prev_ff = b == 0xFF;
    }
    nbits--;
    return (acc >> nbits) & 1;
  }
  int event() {
    for (;;) {
      if (zeros) { zeros--; return 0; }
      if (one) { one = 0; return 1; }
      if (bit()) {
        zeros = 1 << MEL_E[k];
        k = std::min(k + 1, 12);
      } else {
        int run = 0;
        for (int i = 0; i < MEL_E[k]; i++) run = (run << 1) | bit();
        k = std::max(k - 1, 0);
        zeros = run;
        one = 1;
      }
    }
  }
};

// Backward-growing VLC stream (htj2k.py VLCWriter).
struct VLCWriter {
  std::vector<u8> bits;
  void codeword(int v, int n) {
    for (int i = 0; i < n; i++) bits.push_back((v >> i) & 1);
  }
  // (nibble, tail bytes: tail[0] = byte at Lcup-3, toward lower addrs)
  void pack(int* nib_out, std::vector<u8>* tail) {
    const std::vector<u8>& b = bits;
    size_t i = 0;
    int nib = 0;
    if (b.size() >= 3 && b[0] && b[1] && b[2]) {
      nib = 0x7;
      i = 3;
    } else {
      while (i < std::min<size_t>(4, b.size())) {
        nib |= b[i] << i;
        i++;
      }
    }
    bool prev_gt = nib >= 9;
    while (i < b.size()) {
      int val = 0;
      int take = (int)std::min<size_t>(7, b.size() - i);
      for (int j = 0; j < take; j++) val |= b[i + j] << j;
      i += take;
      // after a byte > 0x8F the next byte holds 7 bits only when its
      // low seven bits are all ones (bit 7 is then a stuffed 0)
      if ((!prev_gt || val != 0x7F) && i < b.size()) {
        val |= b[i] << 7;
        i++;
      }
      tail->push_back((u8)val);
      prev_gt = val > 0x8F;
    }
    *nib_out = nib;
  }
};

// Backward VLC bit reader over a cleanup segment suffix.
struct VLCReader {
  const u8* seg;
  i64 pos, lo;
  u64 acc;
  int nbits;
  bool prev_gt;

  VLCReader(const u8* s, i64 lcup, i64 scup) : seg(s) {
    pos = lcup - 2;
    lo = lcup - scup;
    u8 first = seg[lcup - 2];
    int nib = first >> 4;
    acc = nib;
    nbits = (nib & 7) == 7 ? 3 : 4;
    prev_gt = (first | 0x0F) > 0x8F;
    pos--;
  }
  void fill() {
    u8 b = pos >= lo ? seg[pos] : 0xFF;
    if (pos >= lo) pos--;
    int take = 8;
    if (prev_gt && (b & 0x7F) == 0x7F) take = 7;
    acc |= (u64)(b & ((1 << take) - 1)) << nbits;
    nbits += take;
    prev_gt = b > 0x8F;
  }
  int peek(int n) {
    while (nbits < n) fill();
    return (int)(acc & (((u64)1 << n) - 1));
  }
  void skip(int n) {
    while (nbits < n) fill();
    acc >>= n;
    nbits -= n;
  }
};

// --------------------------------------------------------------- u-VLC

// (prefix bit list via (val, len) LSB-first, suffix value, suffix len)
static void u_codeword(int u, int* pfx, int* pfx_len, int* sfx,
                       int* sfx_len) {
  if (u == 1) { *pfx = 1; *pfx_len = 1; *sfx = 0; *sfx_len = 0; }
  else if (u == 2) { *pfx = 2; *pfx_len = 2; *sfx = 0; *sfx_len = 0; }
  else if (u <= 4) { *pfx = 4; *pfx_len = 3; *sfx = u - 3; *sfx_len = 1; }
  else { *pfx = 0; *pfx_len = 3; *sfx = u - 5; *sfx_len = 5; }
}

static void write_u_pair(VLCWriter& vlc, int u0, int u1) {
  int p[2] = {u0, u1};
  int pfx[2], pl[2], sfx[2], sl[2];
  for (int j = 0; j < 2; j++)
    if (p[j]) u_codeword(p[j], &pfx[j], &pl[j], &sfx[j], &sl[j]);
  for (int j = 0; j < 2; j++)
    if (p[j]) vlc.codeword(pfx[j], pl[j]);
  for (int j = 0; j < 2; j++)
    if (p[j] && sl[j]) vlc.codeword(sfx[j], sl[j]);
}

static void write_u_pair_initial(VLCWriter& vlc, int u0, int u1) {
  // initial-row both-u_off pair with MEL event 0: when u0 > 2 the
  // other quad's u is 1 or 2, coded as one bit between pfx0 and sfx0
  if (u0 > 2) {
    int pfx, pl, sfx, sl;
    u_codeword(u0, &pfx, &pl, &sfx, &sl);
    vlc.codeword(pfx, pl);
    vlc.codeword(u1 - 1, 1);
    if (sl) vlc.codeword(sfx, sl);
  } else {
    write_u_pair(vlc, u0, u1);
  }
}

static void read_u(VLCReader& vlc, int* base, int* sfx_len) {
  int p = vlc.peek(3);
  if (p & 1) { vlc.skip(1); *base = 1; *sfx_len = 0; }
  else if (p & 2) { vlc.skip(2); *base = 2; *sfx_len = 0; }
  else if (p & 4) { vlc.skip(3); *base = 3; *sfx_len = 1; }
  else { vlc.skip(3); *base = 5; *sfx_len = 5; }
}

static void read_u_pair(VLCReader& vlc, bool want0, bool want1,
                        int* u0, int* u1) {
  int b0 = 0, s0 = 0, b1 = 0, s1 = 0;
  if (want0) read_u(vlc, &b0, &s0);
  if (want1) read_u(vlc, &b1, &s1);
  *u0 = *u1 = 0;
  if (want0) {
    *u0 = b0 + (s0 ? vlc.peek(s0) : 0);
    vlc.skip(s0);
  }
  if (want1) {
    *u1 = b1 + (s1 ? vlc.peek(s1) : 0);
    vlc.skip(s1);
  }
}

static void read_u_pair_initial(VLCReader& vlc, int* u0, int* u1) {
  int b0, s0;
  read_u(vlc, &b0, &s0);
  if (b0 >= 3) {               // 3-bit prefix: u0 > 2, u1 in {1, 2}
    *u1 = vlc.peek(1) + 1;
    vlc.skip(1);
    *u0 = b0 + (s0 ? vlc.peek(s0) : 0);
    vlc.skip(s0);
    return;
  }
  int b1, s1;
  read_u(vlc, &b1, &s1);
  *u0 = b0 + (s0 ? vlc.peek(s0) : 0);
  vlc.skip(s0);
  *u1 = b1 + (s1 ? vlc.peek(s1) : 0);
  vlc.skip(s1);
}

// ------------------------------------------------------------ cleanup

// rc: 0 ok, 2 invalid input
static int decode_cleanup(const u8* seg, i64 lcup, int w, int h, int B,
                          i32* out) {
  if (lcup < 2) return 2;
  i64 scup = ((i64)seg[lcup - 1] << 4) | (seg[lcup - 2] & 0xF);
  if (scup < 2 || scup > std::min<i64>(lcup, 4079)) return 2;
  MELDecoder mel(seg + (lcup - scup), scup);
  VLCReader vlc(seg, lcup, scup);
  MagSgnReader ms(seg, lcup - scup, 0xFF);
  memset(out, 0, sizeof(i32) * (size_t)w * h);
  int qw = (w + 1) / 2, qh = (h + 1) / 2;
  std::vector<u8> prev_s(qw + 2, 0), cur_s(qw + 2, 0);
  std::vector<i32> prev_e(qw + 2, 0), cur_e(qw + 2, 0);
  struct QInfo { int q, rho, u_off, e_k, e_1; };
  for (int qy = 0; qy < qh; qy++) {
    bool initial = qy == 0;
    const u16* tbl = initial ? g_vlc_init : g_vlc_noninit;
    std::fill(cur_s.begin(), cur_s.end(), 0);
    std::fill(cur_e.begin(), cur_e.end(), 0);
    int carry = 0;
    int qx = 0;
    while (qx < qw) {
      int npair = std::min(2, qw - qx);
      QInfo qi[2];
      for (int j = 0; j < npair; j++) {
        int q = qx + j;
        int ctx = initial ? carry
                          : ((int)prev_s[q] | (carry << 1)
                             | ((int)prev_s[q + 1] << 2));
        int rho = 0, u_off = 0, e_k = 0, e_1 = 0;
        if (!(ctx == 0 && !mel.event())) {
          u16 ent = tbl[(ctx << 7) | vlc.peek(7)];
          vlc.skip(ent & 7);
          rho = (ent >> 4) & 0xF;
          u_off = (ent >> 3) & 1;
          e_1 = (ent >> 8) & 0xF;
          e_k = (ent >> 12) & 0xF;
        }
        carry = initial
            ? (((rho | (rho >> 1)) & 1) | ((rho >> 1) & 2)
               | ((rho >> 1) & 4))
            : ((rho >> 2) | (rho >> 3)) & 1;
        qi[j] = {q, rho, u_off, e_k, e_1};
      }
      int us[2] = {0, 0};
      if (npair == 2 && qi[0].u_off && qi[1].u_off) {
        if (initial) {
          if (mel.event()) {
            read_u_pair(vlc, true, true, &us[0], &us[1]);
            us[0] += 2;
            us[1] += 2;
          } else {
            read_u_pair_initial(vlc, &us[0], &us[1]);
          }
        } else {
          read_u_pair(vlc, true, true, &us[0], &us[1]);
        }
      } else if (qi[0].u_off || (npair == 2 && qi[1].u_off)) {
        read_u_pair(vlc, qi[0].u_off != 0,
                    npair == 2 && qi[1].u_off != 0, &us[0], &us[1]);
      }
      for (int j = 0; j < npair; j++) {
        int q = qi[j].q, rho = qi[j].rho;
        if (!rho) continue;
        bool gamma = (rho & (rho - 1)) != 0;
        int kappa = (initial || !gamma)
            ? 1 : std::max(1, std::max(prev_e[q], prev_e[q + 1]) - 1);
        int bigu = kappa + us[j];
        if (bigu > B + 1) return 2;
        for (int n = 0; n < 4; n++) {
          if (!((rho >> n) & 1)) continue;
          int x = 2 * q + (n >> 1);
          int y = 2 * qy + (n & 1);
          if (x >= w || y >= h) return 2;
          int m = bigu - ((qi[j].e_k >> n) & 1);
          u64 val = ms.bits(m) | ((u64)((qi[j].e_1 >> n) & 1) << m);
          i64 mu = (i64)(val >> 1) + 1;
          out[(i64)y * w + x] = (val & 1) ? (i32)-mu : (i32)mu;
          if (n == 1 || n == 3) {
            int col = q + (n >> 1);
            cur_s[col] = 1;
            cur_e[col] = std::max(cur_e[col], (i32)bitlen(val | 1));
          }
        }
      }
      qx += npair;
    }
    std::swap(prev_s, cur_s);
    std::swap(prev_e, cur_e);
  }
  return 0;
}

// rc: 0 ok, 2 cannot encode (all-zero / Scup overflow / no codeword)
static int encode_cleanup(const i32* coef, int w, int h,
                          std::vector<u8>* seg_out, int* B_out) {
  i64 mu_max = 0;
  for (i64 i = 0; i < (i64)w * h; i++) {
    i64 a = coef[i] < 0 ? -(i64)coef[i] : coef[i];
    mu_max = std::max(mu_max, a);
  }
  if (mu_max == 0) return 2;
  int B = bitlen(mu_max);
  int qw = (w + 1) / 2, qh = (h + 1) / 2;

  // v = 2*(|c|-1) + sign for significant samples
  auto sample = [&](int qx, int qy, int n, bool* sig, u64* v) {
    int x = 2 * qx + (n >> 1);
    int y = 2 * qy + (n & 1);
    if (x >= w || y >= h) { *sig = false; *v = 0; return; }
    i64 c = coef[(i64)y * w + x];
    if (c == 0) { *sig = false; *v = 0; return; }
    i64 a = c < 0 ? -c : c;
    *sig = true;
    *v = (u64)(2 * (a - 1) + (c < 0 ? 1 : 0));
  };

  MELEncoder mel;
  VLCWriter vlc;
  MagSgnWriter ms;
  std::vector<u8> prev_s(qw + 2, 0), cur_s(qw + 2, 0);
  std::vector<i32> prev_e(qw + 2, 0), cur_e(qw + 2, 0);

  for (int qy = 0; qy < qh; qy++) {
    bool initial = qy == 0;
    auto& enc_tbl = initial ? g_enc_init : g_enc_noninit;
    std::fill(cur_s.begin(), cur_s.end(), 0);
    std::fill(cur_e.begin(), cur_e.end(), 0);
    int carry = 0;
    int qx = 0;
    while (qx < qw) {
      int npair = std::min(2, qw - qx);
      int uoffs[2] = {0, 0}, uvals[2] = {0, 0};
      for (int j = 0; j < npair; j++) {
        int q = qx + j;
        bool sig[4];
        u64 sv[4];
        for (int n = 0; n < 4; n++) sample(q, qy, n, &sig[n], &sv[n]);
        int rho = 0;
        for (int n = 0; n < 4; n++) if (sig[n]) rho |= 1 << n;
        int ctx = initial ? carry
                          : ((int)prev_s[q] | (carry << 1)
                             | ((int)prev_s[q + 1] << 2));
        if (ctx == 0) mel.event(rho ? 1 : 0);
        if (rho || ctx != 0) {
          int es[4];
          int emax = 0;
          for (int n = 0; n < 4; n++) {
            es[n] = sig[n] ? bitlen(sv[n] | 1) : 0;
            emax = std::max(emax, es[n]);
          }
          int u, bigu;
          if (rho) {
            bool gamma = (rho & (rho - 1)) != 0;
            int kappa = (initial || !gamma)
                ? 1 : std::max(1, std::max(prev_e[q], prev_e[q + 1]) - 1);
            u = std::max(0, emax - kappa);
            bigu = kappa + u;
          } else {
            u = 0;
            bigu = 0;
          }
          int u_off = u > 0 ? 1 : 0;
          uoffs[j] = u_off;
          uvals[j] = u;
          int alpha = 0;
          for (int n = 0; n < 4; n++)
            if (sig[n] && es[n] == bigu) alpha |= 1 << n;
          const std::vector<EncCand>& cands = enc_tbl[ctx][rho][u_off];
          const EncCand* cw = nullptr;
          for (const EncCand& c : cands) {
            if (c.e_k & ~rho) continue;
            if ((c.e_1 & c.e_k) != (alpha & c.e_k)) continue;
            cw = &c;
            break;
          }
          if (!cw) return 2;      // tables complete; cannot happen
          vlc.codeword(cw->cwd, cw->ln);
          for (int n = 0; n < 4; n++) {
            if (sig[n]) {
              int m = bigu - ((cw->e_k >> n) & 1);
              ms.bits(sv[n] & (((u64)1 << m) - 1), m);
            }
          }
        }
        carry = initial
            ? (((rho | (rho >> 1)) & 1) | ((rho >> 1) & 2)
               | ((rho >> 1) & 4))
            : ((rho >> 2) | (rho >> 3)) & 1;
        if (sig[1]) {            // bottom-left
          cur_s[q] = 1;
          cur_e[q] = std::max(cur_e[q], (i32)bitlen(sv[1] | 1));
        }
        if (sig[3]) {            // bottom-right
          cur_s[q + 1] = 1;
          cur_e[q + 1] = std::max(cur_e[q + 1], (i32)bitlen(sv[3] | 1));
        }
      }
      if (npair == 2 && uoffs[0] && uoffs[1]) {
        if (initial) {
          bool both_big = uvals[0] > 2 && uvals[1] > 2;
          mel.event(both_big ? 1 : 0);
          if (both_big)
            write_u_pair(vlc, uvals[0] - 2, uvals[1] - 2);
          else
            write_u_pair_initial(vlc, uvals[0], uvals[1]);
        } else {
          write_u_pair(vlc, uvals[0], uvals[1]);
        }
      } else if (uoffs[0] || (npair == 2 && uoffs[1])) {
        write_u_pair(vlc, uoffs[0] ? uvals[0] : 0,
                     (npair == 2 && uoffs[1]) ? uvals[1] : 0);
      }
      qx += npair;
    }
    std::swap(prev_s, cur_s);
    std::swap(prev_e, cur_e);
  }

  mel.flush();
  std::vector<u8> mel_bytes(mel.out);
  int nib;
  std::vector<u8> tail;
  vlc.pack(&nib, &tail);
  ms.flush();
  // avoid 0xFF >0x8F marker emulation at the MEL/VLC seam
  int vlc_first = tail.empty() ? (nib << 4) : tail.back();
  if (!mel_bytes.empty() && mel_bytes.back() == 0xFF && vlc_first > 0x8F)
    mel_bytes.push_back(0);
  i64 scup = (i64)mel_bytes.size() + (i64)tail.size() + 2;
  if (scup > 4079) return 2;
  std::vector<u8>& seg = *seg_out;
  seg = ms.out;
  seg.insert(seg.end(), mel_bytes.begin(), mel_bytes.end());
  for (size_t i = tail.size(); i-- > 0;) seg.push_back(tail[i]);
  seg.push_back((u8)((nib << 4) | (scup & 0xF)));
  seg.push_back((u8)(scup >> 4));
  *B_out = B;
  return 0;
}

// ------------------------------------------------- SigProp / MagRef

// Backward-growing MagRef raw stream (htj2k.py MagRefWriter; stuffing
// pinned against OpenJPEG ht_dec.c rev_*_mrp).
struct MagRefWriter {
  std::vector<u8> bits;
  void bit(int b) { bits.push_back(b & 1); }
  void pack(std::vector<u8>* out_rev) {
    const std::vector<u8>& b = bits;
    std::vector<u8> out;          // out[0] = byte at the segment end
    size_t i = 0;
    bool skip_next = false;       // this byte's bit 0 is stuffed
    bool unstuff = true;          // previous byte (read order) > 0x8F
    while (i < b.size()) {
      int val;
      if (skip_next) {
        int take = (int)std::min<size_t>(7, b.size() - i);
        val = 0;
        for (int j = 0; j < take; j++) val |= b[i + j] << (j + 1);
        i += take;
      } else {
        bool seven_ones = unstuff && b.size() - i >= 7;
        if (seven_ones)
          for (int j = 0; j < 7; j++) seven_ones = seven_ones && b[i + j];
        if (seven_ones) {
          if (b.size() - i >= 8 && b[i + 7]) {
            val = 0xFF;
            i += 8;
          } else {
            val = 0x7F;
            i += 7;
          }
        } else {
          int take = (int)std::min<size_t>(8, b.size() - i);
          val = 0;
          for (int j = 0; j < take; j++) val |= b[i + j] << j;
          i += take;
        }
      }
      skip_next = unstuff && (val & 0x7F) == 0x7F && val > 0x7F;
      unstuff = val > 0x8F;
      out.push_back((u8)val);
    }
    out_rev->assign(out.rbegin(), out.rend());
  }
};

struct MagRefReader {
  const u8* data;
  i64 pos;
  int acc = 0, nbits = 0;
  bool skip_next = false, unstuff = true;

  MagRefReader(const u8* d, i64 n) : data(d), pos(n - 1) {}
  int bit() {
    if (nbits == 0) {
      u8 b = pos >= 0 ? data[pos] : 0;
      if (pos >= 0) pos--;
      int start = skip_next ? 1 : 0;
      bool special = unstuff && (b & 0x7F) == 0x7F;
      int end;
      if (special && b > 0x7F) {       // 0xFF-form: 8th bit is data
        end = 8;
        skip_next = true;
      } else if (special) {            // 0x7F-form: bit 7 stuffed
        end = 7;
        skip_next = false;
      } else {
        end = 8;
        skip_next = false;
      }
      acc = (b >> start) & ((1 << (end - start)) - 1);
      nbits = end - start;
      unstuff = b > 0x8F;
    }
    int v = acc & 1;
    acc >>= 1;
    nbits--;
    return v;
  }
};

// SigProp neighborhood: any 8-neighbor significant (sig0 | new_sig)
static inline bool neighbor_sig(const u8* sig, int w, int h, int x,
                                int y) {
  int x0 = std::max(0, x - 1), x1 = std::min(w - 1, x + 1);
  int y0 = std::max(0, y - 1), y1 = std::min(h - 1, y + 1);
  for (int ny = y0; ny <= y1; ny++)
    for (int nx = x0; nx <= x1; nx++)
      if ((nx != x || ny != y) && sig[(i64)ny * w + nx]) return true;
  return false;
}

// SigProp sample groups: four stripe columns per group, samples
// column-major within the group (htj2k.py _sigprop_groups).  The
// callback receives each (x, y).
template <typename F>
static void sigprop_groups(int w, int h, F&& per_group) {
  std::vector<std::pair<int, int>> group;
  for (int ys = 0; ys < h; ys += 4) {
    int sh = std::min(4, h - ys);
    for (int xb = 0; xb < w; xb += 4) {
      group.clear();
      for (int x = xb; x < std::min(xb + 4, w); x++)
        for (int dy = 0; dy < sh; dy++) group.push_back({x, ys + dy});
      per_group(group);
    }
  }
}

static void encode_refinement(const i32* coef, const i32* high, int w,
                              int h, std::vector<u8>* out) {
  // sig[] carries sig0 | new_sig for the causal neighbor test
  std::vector<u8> sig((i64)w * h);
  std::vector<u8> sig0((i64)w * h);
  for (i64 i = 0; i < (i64)w * h; i++) {
    sig0[i] = high[i] != 0;
    sig[i] = sig0[i];
  }
  MagSgnWriter sp;                // same forward packing rules
  std::vector<std::pair<int, int>> grp_new;
  sigprop_groups(w, h, [&](const std::vector<std::pair<int, int>>& g) {
    grp_new.clear();
    for (auto& xy : g) {
      int x = xy.first, y = xy.second;
      if (sig[(i64)y * w + x]) continue;
      if (!neighbor_sig(sig.data(), w, h, x, y)) continue;
      i64 c = coef[(i64)y * w + x];
      int b = (int)((c < 0 ? -c : c) & 1);
      sp.bits(b, 1);
      if (b) {
        sig[(i64)y * w + x] = 1;
        grp_new.push_back(xy);
      }
    }
    for (auto& xy : grp_new)
      sp.bits(coef[(i64)xy.second * w + xy.first] < 0 ? 1 : 0, 1);
  });
  sp.flush();

  MagRefWriter mr;
  for (int ys = 0; ys < h; ys += 4) {
    int sh = std::min(4, h - ys);
    for (int x = 0; x < w; x++)
      for (int dy = 0; dy < sh; dy++) {
        int y = ys + dy;
        if (sig0[(i64)y * w + x]) {
          i64 c = coef[(i64)y * w + x];
          mr.bit((int)((c < 0 ? -c : c) & 1));
        }
      }
  }
  std::vector<u8> mr_bytes;
  mr.pack(&mr_bytes);
  *out = sp.out;
  out->insert(out->end(), mr_bytes.begin(), mr_bytes.end());
}

static void decode_refinement(const u8* seg, i64 len, const i32* high,
                              int w, int h, int magref, i32* out) {
  std::vector<u8> sig((i64)w * h);       // sig0 | new_sig
  std::vector<u8> sig0((i64)w * h);
  std::vector<i32> mag((i64)w * h);
  std::vector<int8_t> sgn((i64)w * h);
  for (i64 i = 0; i < (i64)w * h; i++) {
    sig0[i] = high[i] != 0;
    sig[i] = sig0[i];
    i64 a = high[i] < 0 ? -(i64)high[i] : high[i];
    mag[i] = (i32)(2 * a);
    sgn[i] = high[i] < 0 ? -1 : 1;
  }
  MagSgnReader sp(seg, len, 0x00);       // SigProp: zero padding
  std::vector<std::pair<int, int>> grp_new;
  sigprop_groups(w, h, [&](const std::vector<std::pair<int, int>>& g) {
    grp_new.clear();
    for (auto& xy : g) {
      int x = xy.first, y = xy.second;
      if (sig[(i64)y * w + x]) continue;
      if (!neighbor_sig(sig.data(), w, h, x, y)) continue;
      if (sp.bits(1)) {
        sig[(i64)y * w + x] = 1;
        grp_new.push_back(xy);
      }
    }
    for (auto& xy : grp_new) {
      i64 i = (i64)xy.second * w + xy.first;
      mag[i] = 1;
      sgn[i] = sp.bits(1) ? -1 : 1;
    }
  });
  if (magref) {
    MagRefReader mr(seg, len);
    for (int ys = 0; ys < h; ys += 4) {
      int sh = std::min(4, h - ys);
      for (int x = 0; x < w; x++)
        for (int dy = 0; dy < sh; dy++) {
          int y = ys + dy;
          i64 i = (i64)y * w + x;
          if (sig0[i]) mag[i] |= mr.bit();
        }
    }
  }
  for (i64 i = 0; i < (i64)w * h; i++) out[i] = sgn[i] * mag[i];
}

}  // namespace ht_j2k

extern "C" {

void tpuheif_ht_set_tables(const uint16_t* vlc_init,
                           const uint16_t* vlc_noninit) {
  using namespace ht_j2k;
  memcpy(g_vlc_init, vlc_init, sizeof(g_vlc_init));
  memcpy(g_vlc_noninit, vlc_noninit, sizeof(g_vlc_noninit));
  for (int c = 0; c < 8; c++)
    for (int r = 0; r < 16; r++)
      for (int u = 0; u < 2; u++) {
        g_enc_init[c][r][u].clear();
        g_enc_noninit[c][r][u].clear();
      }
  build_enc(g_vlc_init, g_enc_init);
  build_enc(g_vlc_noninit, g_enc_noninit);
  g_tables_set = true;
}

int tpuheif_ht_decode_cleanup(const uint8_t* seg, int64_t len,
                              int32_t w, int32_t h, int32_t B,
                              int32_t* out) {
  using namespace ht_j2k;
  if (!g_tables_set || w <= 0 || h <= 0 || w > 4096 || h > 4096) return 1;
  return decode_cleanup(seg, len, w, h, B, out);
}

int tpuheif_ht_encode_cleanup(const int32_t* coef, int32_t w, int32_t h,
                              uint8_t* out_buf, int64_t cap,
                              int64_t* out_len, int32_t* B_out) {
  using namespace ht_j2k;
  if (!g_tables_set || w <= 0 || h <= 0 || w > 4096 || h > 4096) return 1;
  std::vector<u8> seg;
  int B = 0;
  int rc = encode_cleanup(coef, w, h, &seg, &B);
  if (rc) return rc;
  if ((int64_t)seg.size() > cap) return 1;
  memcpy(out_buf, seg.data(), seg.size());
  *out_len = (int64_t)seg.size();
  *B_out = B;
  return 0;
}

int tpuheif_ht_encode_refinement(const int32_t* coef, const int32_t* high,
                                 int32_t w, int32_t h, uint8_t* out_buf,
                                 int64_t cap, int64_t* out_len) {
  using namespace ht_j2k;
  if (w <= 0 || h <= 0 || w > 4096 || h > 4096) return 1;
  std::vector<u8> seg;
  encode_refinement(coef, high, w, h, &seg);
  if ((int64_t)seg.size() > cap) return 1;
  memcpy(out_buf, seg.data(), seg.size());
  *out_len = (int64_t)seg.size();
  return 0;
}

int tpuheif_ht_decode_refinement(const uint8_t* seg, int64_t len,
                                 const int32_t* high, int32_t w,
                                 int32_t h, int32_t magref,
                                 int32_t* out) {
  using namespace ht_j2k;
  if (w <= 0 || h <= 0 || w > 4096 || h > 4096) return 1;
  decode_refinement(seg, len, high, w, h, magref, out);
  return 0;
}

}  // extern "C"
