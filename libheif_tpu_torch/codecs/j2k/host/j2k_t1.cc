// JPEG 2000 EBCOT tier-1 block coder (ISO/IEC 15444-1 Annex C/D) —
// native drop-in for codecs/j2k/{mq,t1}.py, which stay the conformance
// anchors (difftested bit-for-bit; the decoder is additionally oracle-
// checked against OpenJPEG).  Replaces the reference's OpenJPEG
// opj_t1.c/opj_mqc.c boundary (plugins/decoder_openjpeg.cc).
//
// A copy of libheif_tpu/native/src/j2k_t1.cc, unchanged but for this
// paragraph; libheif_tpu_torch/_build.py builds it with ht_j2k.cc as
// the j2k_host library (J2K_HOST_LIBRARY), which codecs/j2k/native.py
// loads.  Both exports return 1 for a block wider or taller than 4096
// (the callers route such a block to Python before the call) and the
// encoder 1 for an output larger than the caller's buffer.

#include <cstdint>
#include <cstring>
#include <vector>

namespace j2k_t1 {

typedef int64_t i64;
typedef int32_t i32;
typedef uint8_t u8;

// MQ-coder probability table (Annex C table C.2), generated from
// codecs/j2k/mq.py QE_TABLE (single source of truth)
static const struct { uint16_t qe; uint8_t nmps, nlps, sw; }
kQe[47] = {
  {0x5601,1,1,1}, {0x3401,2,6,0}, {0x1801,3,9,0}, {0x0AC1,4,12,0},
  {0x0521,5,29,0}, {0x0221,38,33,0}, {0x5601,7,6,1}, {0x5401,8,14,0},
  {0x4801,9,14,0}, {0x3801,10,14,0}, {0x3001,11,17,0}, {0x2401,12,18,0},
  {0x1C01,13,20,0}, {0x1601,29,21,0}, {0x5601,15,14,1}, {0x5401,16,14,0},
  {0x5101,17,15,0}, {0x4801,18,16,0}, {0x3801,19,17,0}, {0x3401,20,18,0},
  {0x3001,21,19,0}, {0x2801,22,19,0}, {0x2401,23,20,0}, {0x2201,24,21,0},
  {0x1C01,25,22,0}, {0x1801,26,23,0}, {0x1601,27,24,0}, {0x1401,28,25,0},
  {0x1201,29,26,0}, {0x1101,30,27,0}, {0x0AC1,31,28,0}, {0x09C1,32,29,0},
  {0x08A1,33,30,0}, {0x0521,34,31,0}, {0x0441,35,32,0}, {0x02A1,36,33,0},
  {0x0221,37,34,0}, {0x0141,38,35,0}, {0x0111,39,36,0}, {0x0085,40,37,0},
  {0x0049,41,38,0}, {0x0025,42,39,0}, {0x0015,43,40,0}, {0x0009,44,41,0},
  {0x0005,45,42,0}, {0x0001,45,43,0}, {0x5601,46,46,0},
};

static const int N_CONTEXTS = 19;
static const int CTX_UNI = 18;
static const int CTX_RL = 17;

struct Ctx { u8 idx; u8 mps; };

static void init_states(Ctx* st) {
  for (int i = 0; i < N_CONTEXTS; i++) { st[i].idx = 0; st[i].mps = 0; }
  st[CTX_UNI].idx = 46;
  st[CTX_RL].idx = 3;
  st[0].idx = 4;
}

// ------------------------------------------------------------- MQ dec

struct MQDec {
  const u8* data;
  i64 len, bp;
  uint32_t c, a;
  int ct;
  Ctx st[N_CONTEXTS];

  void bytein() {
    u8 b = bp < len ? data[bp] : 0xFF;
    if (b == 0xFF) {
      u8 b1 = bp + 1 < len ? data[bp + 1] : 0xFF;
      if (b1 > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp += 1;
        c += (uint32_t)b1 << 9;
        ct = 7;
      }
    } else {
      bp += 1;
      u8 b1 = bp < len ? data[bp] : 0xFF;
      c += (uint32_t)b1 << 8;
      ct = 8;
    }
  }

  void init(const u8* d, i64 n) {
    data = d; len = n; bp = 0;
    init_states(st);
    u8 b = n ? d[0] : 0xFF;
    c = (uint32_t)b << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  int decode(int cx) {
    Ctx& s = st[cx];
    uint16_t qe = kQe[s.idx].qe;
    int d;
    a -= qe;
    if (((c >> 16) & 0xFFFF) < qe) {
      if (a < qe) {
        d = s.mps;
        s.idx = kQe[s.idx].nmps;
      } else {
        d = 1 - s.mps;
        if (kQe[s.idx].sw) s.mps = 1 - s.mps;
        s.idx = kQe[s.idx].nlps;
      }
      a = qe;
    } else {
      c -= (uint32_t)qe << 16;
      if (a & 0x8000) return s.mps;
      if (a < qe) {
        d = 1 - s.mps;
        if (kQe[s.idx].sw) s.mps = 1 - s.mps;
        s.idx = kQe[s.idx].nlps;
      } else {
        d = s.mps;
        s.idx = kQe[s.idx].nmps;
      }
    }
    do {
      if (ct == 0) bytein();
      a = (a << 1) & 0xFFFF;
      c <<= 1;
      ct--;
    } while (!(a & 0x8000));
    return d;
  }
};

// ------------------------------------------------------------- MQ enc

struct MQEnc {
  std::vector<u8> out;
  uint32_t c, a;
  int ct;
  int b;
  bool bvalid;
  Ctx st[N_CONTEXTS];

  void init() {
    init_states(st);
    out.clear();
    a = 0x8000; c = 0; ct = 12; b = 0; bvalid = false;
  }

  void emit(int byte) {
    if (bvalid) out.push_back((u8)b);
    b = byte;
    bvalid = true;
  }

  void byteout() {
    if (bvalid && b == 0xFF) {
      emit((c >> 20) & 0xFF);
      c &= 0xFFFFF;
      ct = 7;
    } else if (c < 0x8000000) {
      emit((c >> 19) & 0xFF);
      c &= 0x7FFFF;
      ct = 8;
    } else {
      b += 1;
      if (b == 0xFF) {
        c &= 0x7FFFFFF;
        emit((c >> 20) & 0xFF);
        c &= 0xFFFFF;
        ct = 7;
      } else {
        emit((c >> 19) & 0xFF);
        c &= 0x7FFFF;
        ct = 8;
      }
    }
  }

  void encode(int cx, int d) {
    Ctx& s = st[cx];
    uint16_t qe = kQe[s.idx].qe;
    if (d == s.mps) {
      a -= qe;
      if (a & 0x8000) {
        c += qe;
        return;
      }
      if (a < qe) a = qe;
      else c += qe;
      s.idx = kQe[s.idx].nmps;
    } else {
      a -= qe;
      if (a < qe) c += qe;
      else a = qe;
      if (kQe[s.idx].sw) s.mps = 1 - s.mps;
      s.idx = kQe[s.idx].nlps;
    }
    do {
      a = (a << 1) & 0xFFFF;
      c = (c << 1) & 0xFFFFFFF;
      ct--;
      if (ct == 0) byteout();
    } while (!(a & 0x8000));
  }

  void flush() {
    uint32_t tempc = c + a;
    c |= 0xFFFF;
    if (c >= tempc) c -= 0x8000;
    c = (c << ct) & 0xFFFFFFF;
    byteout();
    c = (c << ct) & 0xFFFFFFF;
    byteout();
    if (bvalid && b != 0xFF) out.push_back((u8)b);
    bvalid = false;
    while (!out.empty() && out.back() == 0xFF) out.pop_back();
  }
};

// ------------------------------------------------- block coding state

static const int LL = 0, HL = 1, LH = 2, HH = 3;


// zero-coding context (Table D.1; mirrors t1.py _zc_table)
static void build_zc_table(int orient, u8* t /* [3][3][5] */) {
  for (int h = 0; h < 3; h++)
    for (int v = 0; v < 3; v++)
      for (int d = 0; d < 5; d++) {
        int cx;
        if (orient == HH) {
          int hv = h + v < 2 ? h + v : 2;
          if (d >= 3) cx = 8;
          else if (d == 2) cx = hv >= 1 ? 7 : 6;
          else if (d == 1) cx = 3 + hv;
          else cx = hv;
        } else {
          int hh = (orient == LL || orient == LH) ? h : v;
          int vv = (orient == LL || orient == LH) ? v : h;
          if (hh > 2) hh = 2;
          if (vv > 2) vv = 2;
          if (hh == 2) cx = 8;
          else if (hh == 1) cx = vv >= 1 ? 7 : (d >= 1 ? 6 : 5);
          else if (vv == 2) cx = 4;
          else if (vv == 1) cx = 3;
          else cx = d >= 2 ? 2 : (d == 1 ? 1 : 0);
        }
        t[(h * 3 + v) * 5 + d] = (u8)cx;
      }
}

// sign-coding (Table D.3, from t1.py _SC_TABLE):
// (1,1)->13/0 (1,0)->12/0 (1,-1)->11/0 (0,1)->10/0 (0,0)->9/0
// (0,-1)->10/1 (-1,1)->11/1 (-1,0)->12/1 (-1,-1)->13/1
static inline void sc_lookup(int hc, int vc, int* cx, int* xr) {
  static const int ctx_tab[3][3] = {   // [hc+1][vc+1]
      {13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
  static const int xor_tab[3][3] = {
      {1, 1, 1}, {1, 0, 0}, {0, 0, 0}};
  *cx = ctx_tab[hc + 1][vc + 1];
  *xr = xor_tab[hc + 1][vc + 1];
}

struct Block {
  int w, h;
  u8 zc[3 * 3 * 5];
  std::vector<u8> sig, vis, refined;   // (h+2)*(w+2)
  std::vector<signed char> sgn;
  std::vector<i64> mag;                // h*w
  std::vector<signed char> last_plane;
  int stride;

  void init(int w_, int h_, int orient) {
    w = w_; h = h_;
    stride = w + 2;
    build_zc_table(orient, zc);
    sig.assign((size_t)(h + 2) * stride, 0);
    vis.assign((size_t)(h + 2) * stride, 0);
    refined.assign((size_t)(h + 2) * stride, 0);
    sgn.assign((size_t)(h + 2) * stride, 0);
    mag.assign((size_t)h * w, 0);
    last_plane.assign((size_t)h * w, 0);
  }

  inline int zc_ctx(int x, int y) const {
    const u8* s = sig.data() + (size_t)(y + 1) * stride + x + 1;
    int hsum = s[-1] + s[1];
    int vsum = s[-stride] + s[stride];
    int dsum = s[-stride - 1] + s[-stride + 1] + s[stride - 1] +
               s[stride + 1];
    return zc[(hsum * 3 + vsum) * 5 + dsum];
  }

  inline void sc_ctx(int x, int y, int* cx, int* xr) const {
    const signed char* g = sgn.data() + (size_t)(y + 1) * stride + x + 1;
    int hc = g[-1] + g[1];
    int vc = g[-stride] + g[stride];
    hc = hc < -1 ? -1 : (hc > 1 ? 1 : hc);
    vc = vc < -1 ? -1 : (vc > 1 ? 1 : vc);
    sc_lookup(hc, vc, cx, xr);
  }

  inline int mr_ctx(int x, int y) const {
    if (refined[(size_t)(y + 1) * stride + x + 1]) return 16;
    const u8* s = sig.data() + (size_t)(y + 1) * stride + x + 1;
    int sum = s[-1] + s[1] + s[-stride] + s[stride] + s[-stride - 1] +
              s[-stride + 1] + s[stride - 1] + s[stride + 1];
    return sum ? 15 : 14;
  }
};

// --------------------------------------------------------------- decode

struct T1Dec : Block {
  MQDec dec;

  void become_sig(int x, int y, int plane) {
    int cx, xr;
    sc_ctx(x, y, &cx, &xr);
    int s = dec.decode(cx) ^ xr;
    sig[(size_t)(y + 1) * stride + x + 1] = 1;
    sgn[(size_t)(y + 1) * stride + x + 1] = s ? -1 : 1;
    mag[(size_t)y * w + x] |= (i64)1 << plane;
    last_plane[(size_t)y * w + x] = (signed char)plane;
  }

  void sigprop(int plane) {
    for (int k0 = 0; k0 < h; k0 += 4)
      for (int x = 0; x < w; x++)
        for (int y = k0; y < k0 + 4 && y < h; y++) {
          if (sig[(size_t)(y + 1) * stride + x + 1]) continue;
          int cx = zc_ctx(x, y);
          if (cx == 0) continue;
          vis[(size_t)(y + 1) * stride + x + 1] = 1;
          if (dec.decode(cx)) become_sig(x, y, plane);
        }
  }

  void magref(int plane) {
    for (int k0 = 0; k0 < h; k0 += 4)
      for (int x = 0; x < w; x++)
        for (int y = k0; y < k0 + 4 && y < h; y++) {
          size_t p = (size_t)(y + 1) * stride + x + 1;
          if (!sig[p] || vis[p]) continue;
          int bit = dec.decode(mr_ctx(x, y));
          refined[p] = 1;
          if (bit) mag[(size_t)y * w + x] |= (i64)1 << plane;
          last_plane[(size_t)y * w + x] = (signed char)plane;
          vis[p] = 1;
        }
  }

  void cleanup(int plane) {
    for (int k0 = 0; k0 < h; k0 += 4)
      for (int x = 0; x < w; x++) {
        int y = k0;
        if (k0 + 3 < h) {
          bool clean = true;
          for (int i = 0; i < 4 && clean; i++) {
            size_t p = (size_t)(k0 + 1 + i) * stride + x + 1;
            if (vis[p] || sig[p] || zc_ctx(x, k0 + i) != 0) clean = false;
          }
          if (clean) {
            if (!dec.decode(CTX_RL)) continue;
            int r = (dec.decode(CTX_UNI) << 1) | dec.decode(CTX_UNI);
            y = k0 + r;
            become_sig(x, y, plane);
            y += 1;
          }
        }
        for (int yy = y; yy < k0 + 4 && yy < h; yy++) {
          size_t p = (size_t)(yy + 1) * stride + x + 1;
          if (sig[p] || vis[p]) continue;
          if (dec.decode(zc_ctx(x, yy))) become_sig(x, yy, plane);
        }
      }
  }

  void run(const u8* data, i64 len, int num_passes, int mb,
           int zero_planes, i32* out) {
    int nplanes = mb - zero_planes;
    if (nplanes <= 0 || num_passes <= 0) {
      memset(out, 0, sizeof(i32) * (size_t)w * h);
      return;
    }
    dec.init(data, len);
    int p = 0, plane = nplanes - 1;
    while (p < num_passes && plane >= 0) {
      if (p == 0) {
        cleanup(plane);
        p++;
      } else {
        sigprop(plane);
        if (++p >= num_passes) break;
        magref(plane);
        if (++p >= num_passes) break;
        cleanup(plane);
        p++;
      }
      std::fill(vis.begin(), vis.end(), 0);
      plane--;
    }
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        i64 v = mag[(size_t)y * w + x];
        signed char lp = last_plane[(size_t)y * w + x];
        if (v > 0 && lp > 0) v += (i64)1 << (lp - 1);
        if (sgn[(size_t)(y + 1) * stride + x + 1] < 0) v = -v;
        out[(size_t)y * w + x] = (i32)v;
      }
  }
};

// --------------------------------------------------------------- encode

struct T1Enc : Block {
  MQEnc enc;
  const i32* src;

  inline int bit(int x, int y, int plane) const {
    i32 v = src[(size_t)y * w + x];
    i64 m = v < 0 ? -(i64)v : v;
    return (int)((m >> plane) & 1);
  }

  void become_sig(int x, int y, int plane) {
    int cx, xr;
    sc_ctx(x, y, &cx, &xr);
    int s = src[(size_t)y * w + x] < 0 ? 1 : 0;
    enc.encode(cx, s ^ xr);
    sig[(size_t)(y + 1) * stride + x + 1] = 1;
    sgn[(size_t)(y + 1) * stride + x + 1] = s ? -1 : 1;
  }

  void sigprop(int plane) {
    for (int k0 = 0; k0 < h; k0 += 4)
      for (int x = 0; x < w; x++)
        for (int y = k0; y < k0 + 4 && y < h; y++) {
          if (sig[(size_t)(y + 1) * stride + x + 1]) continue;
          int cx = zc_ctx(x, y);
          if (cx == 0) continue;
          vis[(size_t)(y + 1) * stride + x + 1] = 1;
          int b = bit(x, y, plane);
          enc.encode(cx, b);
          if (b) become_sig(x, y, plane);
        }
  }

  void magref(int plane) {
    for (int k0 = 0; k0 < h; k0 += 4)
      for (int x = 0; x < w; x++)
        for (int y = k0; y < k0 + 4 && y < h; y++) {
          size_t p = (size_t)(y + 1) * stride + x + 1;
          if (!sig[p] || vis[p]) continue;
          enc.encode(mr_ctx(x, y), bit(x, y, plane));
          refined[p] = 1;
          vis[p] = 1;
        }
  }

  void cleanup(int plane) {
    for (int k0 = 0; k0 < h; k0 += 4)
      for (int x = 0; x < w; x++) {
        int y = k0;
        if (k0 + 3 < h) {
          bool clean = true;
          for (int i = 0; i < 4 && clean; i++) {
            size_t p = (size_t)(k0 + 1 + i) * stride + x + 1;
            if (vis[p] || sig[p] || zc_ctx(x, k0 + i) != 0) clean = false;
          }
          if (clean) {
            int bits[4];
            int any = 0;
            for (int i = 0; i < 4; i++) {
              bits[i] = bit(x, k0 + i, plane);
              any |= bits[i];
            }
            if (!any) {
              enc.encode(CTX_RL, 0);
              continue;
            }
            int r = 0;
            while (!bits[r]) r++;
            enc.encode(CTX_RL, 1);
            enc.encode(CTX_UNI, (r >> 1) & 1);
            enc.encode(CTX_UNI, r & 1);
            become_sig(x, k0 + r, plane);
            y = k0 + r + 1;
          }
        }
        for (int yy = y; yy < k0 + 4 && yy < h; yy++) {
          size_t p = (size_t)(yy + 1) * stride + x + 1;
          if (sig[p] || vis[p]) continue;
          int b = bit(x, yy, plane);
          enc.encode(zc_ctx(x, yy), b);
          if (b) become_sig(x, yy, plane);
        }
      }
  }

  int run(const i32* coeffs, int* npasses_out, int* nplanes_out) {
    src = coeffs;
    i64 mx = 0;
    for (int i = 0; i < w * h; i++) {
      i64 m = coeffs[i] < 0 ? -(i64)coeffs[i] : coeffs[i];
      if (m > mx) mx = m;
    }
    int nplanes = 0;
    while (mx >> nplanes) nplanes++;
    if (nplanes == 0) {
      *npasses_out = 0;
      *nplanes_out = 0;
      return 0;
    }
    enc.init();
    int plane = nplanes - 1, npasses = 0;
    while (plane >= 0) {
      if (npasses == 0) {
        cleanup(plane);
        npasses += 1;
      } else {
        sigprop(plane);
        magref(plane);
        cleanup(plane);
        npasses += 3;
      }
      std::fill(vis.begin(), vis.end(), 0);
      plane--;
    }
    enc.flush();
    *npasses_out = npasses;
    *nplanes_out = nplanes;
    return 0;
  }
};

}  // namespace j2k_t1

extern "C" {

int tpuheif_j2k_t1_decode(const uint8_t* data, int64_t len,
                          int32_t num_passes, int32_t mb,
                          int32_t zero_planes, int32_t w, int32_t h,
                          int32_t orient, int32_t* out) {
  using namespace j2k_t1;
  if (w <= 0 || h <= 0 || w > 4096 || h > 4096) return 1;
  T1Dec d;
  d.init(w, h, orient);
  d.run(data, len, num_passes, mb, zero_planes, out);
  return 0;
}

int tpuheif_j2k_t1_encode(const int32_t* coeffs, int32_t w, int32_t h,
                          int32_t orient, uint8_t* out_buf,
                          int64_t out_cap, int64_t* out_len,
                          int32_t* npasses, int32_t* nplanes) {
  using namespace j2k_t1;
  if (w <= 0 || h <= 0 || w > 4096 || h > 4096) return 1;
  T1Enc e;
  e.init(w, h, orient);
  int np = 0, npl = 0;
  e.run(coeffs, &np, &npl);
  if ((int64_t)e.enc.out.size() > out_cap) return 1;
  memcpy(out_buf, e.enc.out.data(), e.enc.out.size());
  *out_len = (int64_t)e.enc.out.size();
  *npasses = np;
  *nplanes = npl;
  return 0;
}

}  // extern "C"
