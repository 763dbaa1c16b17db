// Wavefront schedule for the HEVC device reconstruction.
//
// A copy of libheif_tpu/native/src/hevc_plan.cc.  Walks the parsed TU
// list in decode order and computes, per TU:
//   - the dependency wave index (1 + max wave of any TU whose samples
//     this TU's available reference samples were written by), and
//   - the availability of each of its 4n+1 reference samples under the
//     z-order progressive availability rule (H.265 §6.4.1); in a picture
//     of several slices a sample of another slice is unavailable too
//     (slice_map: the slice index per 4x4, as the JAX package's
//     recon.py _sample_available reads it).
// device_recon.build_plan turns both into the per-group tables of the
// device program.
//
// In a P or B picture a row of mode -1 stands for an inter CU (x, y, its
// log2 size): its samples are predicted and reconstructed before wave 0
// (the motion compensation and the inter residuals run first), so it
// marks its 4x4s available as the walk reaches it in decode order and
// its samples as written by wave -1; its own wave is -1.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" int tpuheif_hevc_plan(
    const int32_t* tu_meta,   // (n_tus, stride) rows: x, y, log2, c_idx, ...
    int64_t n_tus,
    int32_t stride,
    int32_t W, int32_t H,
    int32_t* waves_out,       // (n_tus,)
    uint8_t* avail_out,       // (n_tus, avail_stride)
    int32_t avail_stride,
    const int16_t* slice_map,  // (rows, slice_stride) per 4x4, or null
    int32_t slice_stride) {
  const int cw = W >> 1, ch = H >> 1;
  const int w4 = (W + 3) / 4, h4 = (H + 3) / 4;
  std::vector<uint8_t> avail4((size_t)w4 * h4, 0);
  std::vector<int32_t> wr_y((size_t)W * H, 0);
  std::vector<int32_t> wr_c[2];
  wr_c[0].assign((size_t)cw * ch, 0);
  wr_c[1].assign((size_t)cw * ch, 0);

  for (int64_t t = 0; t < n_tus; ++t) {
    const int32_t* m = tu_meta + t * stride;
    const int x = m[0], y = m[1], log2 = m[2], c = m[3];
    const int n = 1 << log2;
    if (m[4] < 0) {                   // an inter CU
      if (c != 0 || x < 0 || y < 0 || log2 < 3 || log2 > 6) return 2;
      const int hh = std::min(n, H - y), ww = std::min(n, W - x);
      for (int r = 0; r < hh; ++r)
        std::fill(wr_y.data() + (size_t)(y + r) * W + x,
                  wr_y.data() + (size_t)(y + r) * W + x + ww, -1);
      for (int k = 0; k < 2; ++k)
        for (int r = 0; r < (hh >> 1); ++r)
          std::fill(wr_c[k].data() + (size_t)((y >> 1) + r) * cw + (x >> 1),
                    wr_c[k].data() + (size_t)((y >> 1) + r) * cw + (x >> 1) +
                        (ww >> 1),
                    -1);
      for (int by = y >> 2; by < (y + hh + 3) >> 2; ++by)
        std::fill(avail4.begin() + (size_t)by * w4 + (x >> 2),
                  avail4.begin() + (size_t)by * w4 + ((x + ww + 3) >> 2), 1);
      waves_out[t] = -1;
      continue;
    }
    const int px = c ? (x >> 1) : x, py = c ? (y >> 1) : y;
    const int pw = c ? cw : W, ph = c ? ch : H;
    int32_t* wr = (c == 0) ? wr_y.data() : wr_c[c - 1].data();
    const int L = 4 * n + 1;
    if (L > avail_stride) return 1;
    const int slice =
        slice_map ? slice_map[(size_t)(y >> 2) * slice_stride + (x >> 2)] : 0;
    uint8_t* av = avail_out + t * avail_stride;
    int wave = 0;
    for (int i = 0; i < L; ++i) {
      int sx, sy;
      if (i < 2 * n) {
        sx = px - 1;
        sy = py + 2 * n - 1 - i;
      } else if (i == 2 * n) {
        sx = px - 1;
        sy = py - 1;
      } else {
        sx = px + (i - 2 * n - 1);
        sy = py - 1;
      }
      bool ok = sx >= 0 && sy >= 0 && sx < pw && sy < ph;
      if (ok) {
        const int lx = c ? (sx << 1) : sx, ly = c ? (sy << 1) : sy;
        ok = avail4[(size_t)(ly >> 2) * w4 + (lx >> 2)] != 0 &&
             (!slice_map ||
              slice_map[(size_t)(ly >> 2) * slice_stride + (lx >> 2)] ==
                  slice);
      }
      av[i] = ok ? 1 : 0;
      if (ok) {
        const int wv = wr[(size_t)sy * pw + sx];
        if (wv + 1 > wave) wave = wv + 1;
      }
    }
    waves_out[t] = wave;
    const int hh = std::min(n, ph - py), ww = std::min(n, pw - px);
    for (int r = 0; r < hh; ++r)
      std::fill(wr + (size_t)(py + r) * pw + px,
                wr + (size_t)(py + r) * pw + px + ww, wave);
    if (c == 0) {
      for (int by = y >> 2; by < (y + n) >> 2; ++by)
        std::fill(avail4.begin() + (size_t)by * w4 + (x >> 2),
                  avail4.begin() + (size_t)by * w4 + ((x + n) >> 2), 1);
    }
  }
  return 0;
}
