// JPEG baseline entropy-scan decoder (host C++).
//
// A copy of the scan part of libheif_tpu/native/src/jpeg_scan.cc
// (tpuheif_jpeg_decode_scan_impl :312, tpuheif_jpeg_decode_scan :435): the
// serial Huffman chain of one sequential scan into zigzag int16
// coefficients.  Its semantics are those of the Python scan of
// codecs/jpeg/decoder.py, which stays as the plain reference.  The host
// reconstruction, the fused scan and reconstruction and the encoder of
// the original are left out: the dequantisation and IDCT run on the card
// (csrc/jpeg_kernels.cu).
//
// C ABI only; driven from Python via ctypes (native_scan.py), which
// releases the GIL during the call, so the tiles of a grid scan on a
// thread pool.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitReader;

struct HuffLut {
  // 9-bit lookahead (libjpeg-turbo style): (sym << 4) | len for codes
  // of length <= 9; 0 means "long code, use the canonical slow path".
  // The former full 16-bit tables (192KB each, ~770KB live) thrashed
  // L2 and dominated scan decode.
  uint16_t fast[1 << 9];
  int32_t maxcode[17];   // largest code of each length, -1 if none
  int32_t valoff[17];    // huffval index of mincode at each length
  uint8_t huffval[256];
  bool valid = false;

  void build(const uint8_t bits[16], const uint8_t* vals, int nvals) {
    std::memset(fast, 0, sizeof(fast));
    for (int l = 0; l <= 16; ++l) { maxcode[l] = -1; valoff[l] = 0; }
    std::memcpy(huffval, vals, nvals < 256 ? nvals : 256);
    int code = 0, k = 0;
    for (int ln = 1; ln <= 16; ++ln) {
      if (bits[ln - 1] > 0) {
        valoff[ln] = k - code;     // huffval[valoff[ln] + code]
        for (int i = 0; i < bits[ln - 1]; ++i) {
          if (k >= nvals) { valid = false; return; }
          if (ln <= 9) {
            int shift = 9 - ln;
            int base = code << shift;
            uint16_t e = static_cast<uint16_t>((vals[k] << 4) | ln);
            for (int j = 0; j < (1 << shift); ++j) fast[base + j] = e;
          }
          ++code;
          ++k;
        }
        maxcode[ln] = code - 1;
      }
      code <<= 1;
    }
    valid = true;
  }

  // decode one symbol; returns -1 on invalid code
  inline int decode(BitReader& br);
  inline int decode_nofill(BitReader& br);
};

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool exhausted = false;

  void fill(int need) {
    if (nbits >= need) return;
    if (pos + 8 <= size) {
      // bulk top-up from one 64-bit load (keeps nbits <= 56 so the
      // accumulator's high byte never truncates a pending value)
      uint64_t chunk;
      std::memcpy(&chunk, data + pos, 8);
      chunk = __builtin_bswap64(chunk);
      int take = (56 - nbits) >> 3;
      acc = (acc << (8 * take)) | (chunk >> (64 - 8 * take));
      nbits += 8 * take;
      pos += take;
      return;
    }
    while (nbits < need) {
      uint8_t b = 0;
      if (pos < size) {
        b = data[pos++];
      } else {
        exhausted = true;
      }
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }
  int peek16() {
    fill(16);
    return static_cast<int>((acc >> (nbits - 16)) & 0xFFFF);
  }
  // top up to >= 32 bits when a bulk load is safe, so a symbol+value
  // pair decodes with no further fill checks; near the stream tail
  // this is a no-op and the padded fill(16) semantics are unchanged
  inline void prefill() {
    if (nbits < 32 && pos + 8 <= size) fill(32);
  }
  // bulk refill with the tail bound already established by the caller
  inline void refill_unchecked() {
    uint64_t chunk;
    std::memcpy(&chunk, data + pos, 8);
    chunk = __builtin_bswap64(chunk);
    int take = (56 - nbits) >> 3;
    acc = (acc << (8 * take)) | (chunk >> (64 - 8 * take));
    nbits += 8 * take;
    pos += take;
  }
  int read_bits(int n) {
    if (n == 0) return 0;
    fill(n);
    int v = static_cast<int>((acc >> (nbits - n)) & ((1u << n) - 1));
    nbits -= n;
    return v;
  }
  inline int read_bits_nofill(int n) {
    if (n == 0) return 0;
    int v = static_cast<int>((acc >> (nbits - n)) & ((1u << n) - 1));
    nbits -= n;
    return v;
  }
};

inline int HuffLut::decode(BitReader& br) {
  br.fill(16);
  int look = static_cast<int>((br.acc >> (br.nbits - 16)) & 0xFFFF);
  uint16_t e = fast[look >> 7];
  if (e) {
    br.nbits -= e & 0xF;
    return e >> 4;
  }
  // canonical slow path for 10..16-bit codes: prefix-freeness means a
  // too-short prefix always exceeds that length's maxcode
  for (int l = 10; l <= 16; ++l) {
    int code = look >> (16 - l);
    if (maxcode[l] >= 0 && code <= maxcode[l]) {
      br.nbits -= l;
      return huffval[valoff[l] + code];
    }
  }
  return -1;
}

// symbol decode with the accumulator known to hold >= 16 bits
inline int HuffLut::decode_nofill(BitReader& br) {
  int look = static_cast<int>((br.acc >> (br.nbits - 16)) & 0xFFFF);
  uint16_t e = fast[look >> 7];
  if (e) {
    br.nbits -= e & 0xF;
    return e >> 4;
  }
  for (int l = 10; l <= 16; ++l) {
    int code = look >> (16 - l);
    if (maxcode[l] >= 0 && code <= maxcode[l]) {
      br.nbits -= l;
      return huffval[valoff[l] + code];
    }
  }
  return -1;
}

inline int extend(int v, int size) {
  if (size == 0) return 0;
  if (v < (1 << (size - 1))) return v - (1 << size) + 1;
  return v;
}

// Decode one 8x8 block with branchless per-coefficient refills over a
// top-aligned 64-bit bit buffer; the caller guarantees >= 264 readable
// bytes (a block consumes at most 64 coefficient pairs x 32 bits, and
// each refill advances pos by at most 7).  Returns 0 ok, <0 error.
inline int decode_block_fast(BitReader& br, HuffLut& dt, HuffLut& at,
                             int16_t* block, int* pred) {
  // convert to the top-aligned representation
  uint64_t buf = br.nbits ? (br.acc << (64 - br.nbits)) : 0;
  int cnt = br.nbits;
  size_t pos = br.pos;
  const uint8_t* data = br.data;
  int err = 0;

#define TPUJ_REFILL()                                        \
  do {                                                       \
    uint64_t chunk_;                                         \
    std::memcpy(&chunk_, data + pos, 8);                     \
    buf |= __builtin_bswap64(chunk_) >> cnt;                 \
    pos += (63 - cnt) >> 3;                                  \
    cnt |= 56;                                               \
  } while (0)

#define TPUJ_SYM(lut, out_sym)                               \
  do {                                                       \
    uint16_t e_ = (lut).fast[buf >> 55];                     \
    if (e_) {                                                \
      int l_ = e_ & 0xF;                                     \
      buf <<= l_;                                            \
      cnt -= l_;                                             \
      (out_sym) = e_ >> 4;                                   \
    } else {                                                 \
      int look_ = static_cast<int>(buf >> 48);               \
      (out_sym) = -1;                                        \
      for (int l_ = 10; l_ <= 16; ++l_) {                    \
        int code_ = look_ >> (16 - l_);                      \
        if ((lut).maxcode[l_] >= 0 &&                        \
            code_ <= (lut).maxcode[l_]) {                    \
          buf <<= l_;                                        \
          cnt -= l_;                                         \
          (out_sym) = (lut).huffval[(lut).valoff[l_] + code_]; \
          break;                                             \
        }                                                    \
      }                                                      \
    }                                                        \
  } while (0)

  TPUJ_REFILL();
  int s;
  TPUJ_SYM(dt, s);
  if (s < 0) { err = -1; goto done; }
  if (s) {
    int v = static_cast<int>(buf >> (64 - s));
    buf <<= s;
    cnt -= s;
    *pred += extend(v, s);
  }
  block[0] = static_cast<int16_t>(*pred);
  {
    int k = 1;
    while (k < 64) {
      TPUJ_REFILL();
      int rs;
      TPUJ_SYM(at, rs);
      if (rs < 0) { err = -1; goto done; }
      int r = rs >> 4;
      s = rs & 15;
      if (s == 0) {
        if (r == 15) { k += 16; continue; }
        break;  // EOB
      }
      k += r;
      if (k > 63) { err = -2; goto done; }
      int v = static_cast<int>(buf >> (64 - s));
      buf <<= s;
      cnt -= s;
      block[k] = static_cast<int16_t>(extend(v, s));
      ++k;
    }
  }
done:
#undef TPUJ_REFILL
#undef TPUJ_SYM
  // convert back to the bottom-aligned reader state
  br.acc = cnt ? (buf >> (64 - cnt)) : 0;
  br.nbits = cnt;
  br.pos = pos;
  return err;
}

// Tail-safe variant (zero-padded reads past the end).
inline int decode_block_safe(BitReader& br, HuffLut& dt, HuffLut& at,
                             int16_t* block, int* pred) {
  br.prefill();
  int s = dt.decode(br);
  if (s < 0) return -1;
  *pred += s ? extend(br.read_bits(s), s) : 0;
  block[0] = static_cast<int16_t>(*pred);
  int k = 1;
  while (k < 64) {
    br.prefill();
    int rs = at.decode(br);
    if (rs < 0) return -1;
    int r = rs >> 4;
    s = rs & 15;
    if (s == 0) {
      if (r == 15) { k += 16; continue; }
      return 0;
    }
    k += r;
    if (k > 63) return -2;
    block[k] = static_cast<int16_t>(extend(br.read_bits(s), s));
    ++k;
  }
  return 0;
}

struct Comp {
  int h, v, blocks_w, blocks_h;
  int dc_tbl, ac_tbl;
  int16_t* coeffs;  // (blocks_h*blocks_w, 64), zigzag order
  int id;
};

}  // namespace

extern "C" {

// Decode one sequential scan.
//
// entropy: raw entropy-coded bytes (still containing 0xFF00 stuffing
//          and RSTn markers), exactly the [SOS-end, next-marker) span.
// Tables: 4 DC + 4 AC slots, each 16 bits-counts + up to 256 values.
// Returns 0 on success, negative error codes otherwise.
// *exhausted_out is set when the scan zero-padded past the end
// (truncated stream — caller surfaces a decode warning).
static int tpuheif_jpeg_decode_scan_impl(
    const uint8_t* entropy, size_t entropy_len,
    int ncomp,
    const int* comp_h, const int* comp_v,
    const int* comp_blocks_w, const int* comp_blocks_h,
    const int* comp_dc_tbl, const int* comp_ac_tbl,
    int16_t** comp_coeffs,
    const uint8_t* dc_bits /*4x16*/, const uint8_t* dc_vals /*4x256*/,
    const int* dc_nvals,
    const uint8_t* ac_bits, const uint8_t* ac_vals, const int* ac_nvals,
    int interleaved, int mcus_w, int total_mcus, int restart_interval,
    int* exhausted_out) {
  HuffLut dc_lut[4], ac_lut[4];
  for (int i = 0; i < 4; ++i) {
    if (dc_nvals[i] > 0) dc_lut[i].build(dc_bits + 16 * i, dc_vals + 256 * i,
                                         dc_nvals[i]);
    if (ac_nvals[i] > 0) ac_lut[i].build(ac_bits + 16 * i, ac_vals + 256 * i,
                                         ac_nvals[i]);
  }
  std::vector<Comp> comps(ncomp);
  for (int i = 0; i < ncomp; ++i) {
    comps[i] = Comp{comp_h[i], comp_v[i], comp_blocks_w[i],
                    comp_blocks_h[i], comp_dc_tbl[i], comp_ac_tbl[i],
                    comp_coeffs[i], i};
    int t = comps[i].dc_tbl, a = comps[i].ac_tbl;
    if (t < 0 || t > 3 || !dc_lut[t].valid) return -3;
    if (a < 0 || a > 3 || !ac_lut[a].valid) return -3;
  }

  // split entropy data on RSTn markers (same segmentation as the
  // Python reference path)
  std::vector<std::pair<size_t, size_t>> segs;  // [start, end)
  {
    size_t start = 0, i = 0;
    while (i + 1 < entropy_len) {
      if (entropy[i] == 0xFF && entropy[i + 1] >= 0xD0 &&
          entropy[i + 1] <= 0xD7) {
        segs.emplace_back(start, i);
        start = i + 2;
        i += 2;
      } else {
        ++i;
      }
    }
    segs.emplace_back(start, entropy_len);
  }

  int ri = restart_interval > 0 ? restart_interval : total_mcus;
  int mcu = 0;
  bool exhausted = false;
  std::vector<uint8_t> clean;
  int preds[16];

  for (auto& seg : segs) {
    // unstuff FF00 -> FF: memchr-run copies (0xFF bytes are ~1/256 of
    // the stream, so this is bulk memcpy instead of a per-byte loop)
    clean.clear();
    clean.reserve(seg.second - seg.first);
    {
      const uint8_t* p = entropy + seg.first;
      const uint8_t* end = entropy + seg.second;
      while (p < end) {
        const uint8_t* ff = static_cast<const uint8_t*>(
            std::memchr(p, 0xFF, static_cast<size_t>(end - p)));
        if (ff == nullptr) {
          clean.insert(clean.end(), p, end);
          break;
        }
        clean.insert(clean.end(), p, ff + 1);   // include the 0xFF
        p = ff + 1;
        if (p < end && *p == 0x00) ++p;         // drop the stuffing byte
      }
    }
    BitReader br{clean.data(), clean.size()};
    for (int i = 0; i < ncomp; ++i) preds[i] = 0;

    int seg_end = mcu + ri;
    if (seg_end > total_mcus) seg_end = total_mcus;
    int my = mcus_w ? mcu / mcus_w : 0;
    int mx = mcus_w ? mcu % mcus_w : 0;
    for (; mcu < seg_end; ++mcu) {
      int ncblocks = interleaved ? ncomp : 1;
      // a whole block's worst case fits in 264 bytes: refills inside
      // decode_block_fast then need no bound checks
      for (int ci = 0; ci < ncblocks; ++ci) {
        Comp& c = comps[ci];
        HuffLut& dt = dc_lut[c.dc_tbl];
        HuffLut& at = ac_lut[c.ac_tbl];
        int nby = interleaved ? c.v : 1;
        int nbx = interleaved ? c.h : 1;
        for (int by = 0; by < nby; ++by) {
          for (int bx = 0; bx < nbx; ++bx) {
            int idx;
            if (interleaved) {
              idx = (my * c.v + by) * c.blocks_w + (mx * c.h + bx);
            } else {
              idx = mcu;
            }
            int16_t* block = c.coeffs + static_cast<size_t>(idx) * 64;
            int rc;
            if (br.pos + 264 <= br.size) {
              rc = decode_block_fast(br, dt, at, block, &preds[ci]);
            } else {
              rc = decode_block_safe(br, dt, at, block, &preds[ci]);
            }
            if (rc < 0) return rc;
          }
        }
      }
      if (++mx == mcus_w) {
        mx = 0;
        ++my;
      }
    }
    if (br.exhausted) exhausted = true;
    if (mcu >= total_mcus) break;
  }
  *exhausted_out = exhausted ? 1 : 0;
  return mcu < total_mcus ? -4 : 0;
}

int tpuheif_jpeg_decode_scan(
    const uint8_t* entropy, size_t entropy_len,
    int ncomp,
    const int* comp_h, const int* comp_v,
    const int* comp_blocks_w, const int* comp_blocks_h,
    const int* comp_dc_tbl, const int* comp_ac_tbl,
    int16_t** comp_coeffs,
    const uint8_t* dc_bits, const uint8_t* dc_vals, const int* dc_nvals,
    const uint8_t* ac_bits, const uint8_t* ac_vals, const int* ac_nvals,
    int interleaved, int mcus_w, int total_mcus, int restart_interval,
    int* exhausted_out) {
  return tpuheif_jpeg_decode_scan_impl(
      entropy, entropy_len, ncomp, comp_h, comp_v, comp_blocks_w,
      comp_blocks_h, comp_dc_tbl, comp_ac_tbl, comp_coeffs, dc_bits,
      dc_vals, dc_nvals, ac_bits, ac_vals, ac_nvals, interleaved, mcus_w,
      total_mcus, restart_interval, exhausted_out);
}

}  // extern "C"
