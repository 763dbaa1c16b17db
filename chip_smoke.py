#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (libheif_tpu_torch).

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

It needs no network and imports neither JAX nor the JAX package.  Phases:

1. print the card's name and power limit (nvidia-smi);
2. build the hand-written kernels from libheif_tpu_torch/codecs/*/csrc,
   and meanwhile the codecs' host C++ (HEVC, JPEG, AVC) on threads;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes of the CPU tests, odd sizes, every vector width and tap rule of
   the colour kernels, and the full width: all exact (the count of
   differing pixels is printed); the strided kernel on the padded (T, S+8)
   tile buffers and on the payload read in place at pitch S, with every
   load and store width the alignment allows forced, a short last row at
   pitch S, an odd address and 4096x4096 pixel-interleaved RGB8 and
   component RGB16; then compare the colour kernels' f32 core with the
   straightforward per-pixel core over every reachable input (Y 0..255 x
   scaled Cb, Cr 0..255*s, s = 1, 4, 16) for five matrices in both
   ranges, and require 0 mismatches;
4. drive the main path at full width -- a 4096x4096 YCbCr 4:2:0 unci item
   in 8x8 tiles of 512x512: box bytes -> read_all_boxes -> UnciDecoder
   .decode -> convert_image to RGB -- check it against the plain path on
   the card, against numpy on a small input, and show through the launch
   counts that it ran planes_ycbcr8_to_rgb and strided_extract_paste, the
   latter exactly once, without assembling tile buffers on the host;
4b. drive the file path through HeifContext.read_from_bytes(...)
   .decode_image(...): a file written with the port's HeifFile holding an
   8x8 grid of 512x512 4:2:0 unci items (4096x4096, the flagship's
   payload) with irot 90, imir and a centred 4032x3024 clap, and a
   4096x4096 monochrome alpha item linked by auxl, decoded to
   interleaved RGBA with the launch counts read around it
   (strided_extract_paste once per unci item, 65; planes_ycbcr8_to_rgb
   once); then that file, the flagship as a single-item file, and small
   files (overlay with a partly transparent layer, iden, decode_tile,
   a missing grid tile, 10-bit with convert_hdr_to_8bit), each decoded
   on the card and on the CPU with 0 samples differing, the grid's planes
   equal to the generator's with and without the transforms, and the
   single-item file equal to the library path's image;
4c. the HEVC phase, on the streams committed in
   libheif_tpu_torch/testdata/hevc (encoded by the JAX package, libx265
   and test-side header rewrites, with the plane hashes of the JAX
   device or Python engine, or of libde265 where the manifest names it):
   hold hevc_dequant_itx (one launch for all TU groups) against its
   plain version on every TU group of every stream (scaling lists at 8,
   10 and 12 bits among them), and on synthetic groups with |c| = 32767,
   factors of 255 and the top QP at 8, 10 and 12 bits, and
   hevc_intra_wave (one launch walking every picture's waves, one block
   a picture) against the plain lockstep wave loop, on every small
   stream (pictures of several slices among them), a batch of two
   512x512 tiles, a batch whose pictures have different wave counts, one
   512x512 tile and each photo's 48 tiles (stage A on the photos' 48
   tiles too); decode every stream on the card and require its planes'
   hashes; write a phone photo's HEIC (an 8x6 grid of 48 512x512 hvc1
   items, 4032x3024 output) and decode it through HeifContext to
   interleaved RGB, with the launch counts read around it
   (hevc_dequant_itx once, hevc_intra_wave once, planes_ycbcr8_to_rgb
   once, no strided_extract_paste) and its planes held equal to the
   single tiles' decodes placed where the grid puts them; the same for a
   slices photo (tile i the i mod 4-th of: default scaling lists, custom
   lists, 4 slices, 8 slices with deblocking; one batch, one launch of
   each HEVC kernel); decode a single-item hvc1 file, the 10-bit tile and
   the tile of eight slice NALs through the context on the card and on
   the CPU with 0 samples differing;
4d. the AV1 phase, on the streams committed in
   libheif_tpu_torch/testdata/av1 (the JAX package's Av1IntraEncoder and
   libaom with every intra tool, 8 and 10 bits, with the plane hashes of
   the JAX host engine): hold av1_dequant_itx (one launch for all job
   groups) and av1_intra_wave (one launch walking every picture's waves,
   one block a picture) against their plain versions on every small
   stream, a batch whose pictures have different wave counts, the
   512x512 tiles (stage B on three), a wave-heavy synthetic case
   (codecs/av1/wave_cases.py: 64x64, filter-intra, CfL and many 4x4
   jobs in the same waves, some waves larger than the kernel's shared
   memory) and a 48-tile AVIF photo's plan (the four photo streams'
   cached parses, 12 times each), and both kernels on the intra
   block copy streams (libaom's screen-content tools: skipped blocks'
   copies, transform units with the inter transform sets, lossless) and
   a 1920x1080 screenshot, and av1_intra_wave on synthetic intrabc waves
   (wave_cases.ibc_waves: half-sample chroma at 4:2:0, 4:2:2 and 4:4:4,
   8 and 10 bits, 64x64 copies among 4x4 jobs, sources written by the
   wave before); decode
   every stream on the card, in-loop filters and film grain included,
   and require its planes' hashes (the film-grain streams: libaom's test
   vectors 1-16, 10-bit, odd sizes, estimated grain, four 512x512
   tiles); write an AVIF photo (a 2x2 grid of the four 512x512 photo
   streams, 1000x1000 output) and decode it through HeifContext to
   interleaved RGB, with the launch counts read around it
   (av1_dequant_itx once, av1_intra_wave once, planes_ycbcr8_to_rgb
   once, no strided_extract_paste) and its planes held equal to the
   single tiles' CPU decodes placed where the grid puts them; the same
   for a grain photo (a 4x2 grid, 2000x1000 output, its 8 tiles the
   four film-grain tiles in turn, each with its own grain: the av1.grain
   span once a tile); decode
   single-item av01 files (8-bit, 10-bit, 508x500, the screenshot, with
   its launch counts) through the context on the card and on the CPU
   with 0 samples differing;
4e. the JPEG phase (run before 4d, so that its photo's profiler
   session is the process's first), on the streams committed in
   libheif_tpu_torch/testdata/jpeg (PIL's libjpeg and the JAX package's
   encoder, with the plane hashes of the JAX decode_jpeg): hold
   jpeg_dequant_idct (one launch for every component plane of a batch)
   against recon_plain on every stream, a batch of the small streams
   (different tables, sizes and sampling) into whole planes and into
   views of one plane at odd offsets, cut inside their last blocks (the
   kernel's byte path), random int16 coefficients with 16-bit tables
   (int32 wraparound) and the photo's 48 tiles; decode
   every stream on the card and require its planes' hashes (the
   progressive one must raise); write a JPEG phone photo (an 8x6 grid of
   48 512x512 jpeg items, 4032x3024 output) and decode it through
   HeifContext to interleaved RGB, with the launch counts read around it
   (jpeg_dequant_idct once, planes_ycbcr8_to_rgb once, nothing else) and
   its planes held equal to the single tiles' CPU decodes placed where
   the grid puts them; decode on the card and on the CPU with 0 samples
   differing: a single-item jpeg file and one with its tables in jpgC
   (both against the manifest), the committed mini files (an av01 image
   with alpha and Exif, an hvc1 image; written by the JAX package,
   against their manifest), a 4096x4096 tili of 64 unci 512x512 tiles
   (every tile through decode_tile, strided_extract_paste once a tile,
   each equal to the payload), a tili of the four hvc1 tiles and 8- and
   16-bit mski masks;
4f. the colour phase: at 4096x4096 on the card, through convert_image,
   each of the six colour ops the JAX package runs as jnp programs --
   ChromaResample up (bilinear), down by average and by sharp-yuv,
   RGBToYCbCr in full and limited range, RGBToMono, MonoToYCbCr,
   FlattenAlpha solid and checkerboard -- and BayerToRGB on a 16-bit
   RGGB unci file (a cpat property) decoded through HeifContext
   (strided_extract_paste once, then BayerToRGB), and a chain through
   planes_ycbcr8_to_rgb (YCbCr 4:2:0 with alpha flattened to RGB: the
   kernel once, held to the plain path on the card): each against the
   same call on the CPU (0 samples differing for the integer ops, the
   colour contract for the f32 ones), its median time of REPEATS calls
   beside its byte bound (bytes read and written / 3.35 TB/s), one CPU
   call's time and the device operations a call issues (torch.profiler);
   then a file with Exif, XMP, a region item (every geometry kind, a
   referenced mask) and a text item, read on the card's context through
   read_from_bytes and through read_from_reader (a CallbackReader), with
   the same answers from both;
4g. the mesh phase (libheif_tpu_torch/parallel), over every card
   (make_mesh()) and over a virtual mesh of 4 members on card 0 (that
   card repeated; the split, the member launches and the gather are the
   code that runs over several cards): (a) the 4096x4096 unci item of
   phase 4 through sharded_unci_decode with and without convert_to_rgb,
   strided_extract_paste (and planes_ycbcr8_to_rgb) once for each member
   with tile rows, every gathered plane equal to UnciDecoder.decode, to
   the plain strided path and to numpy, the RGB equal to the colour
   kernel's plain version and within the colour contract of the JAX
   pipeline's formula (libheif_tpu/parallel/grid_decode.py:39-61); (b)
   the HEVC photo of phase 4c through HeifContext with
   DecodingOptions(mesh=...), hevc_dequant_itx and hevc_intra_wave once
   for each member with tiles, planes equal to the unsharded decode, and
   both kernels against their plain versions on each member's plan; (c)
   decode_grid_host_sharded on the photo written to a file, 4 virtual
   hosts over the virtual mesh, equal to the context decode; (d) the
   analog of __graft_entry__.dryrun_multichip over every card (it prints
   the count and the mesh shape); with more than one card, a launch on
   the last one leaves the current device as it was.  Every phase ends
   with the current device as it began.  Each sharded decode's wall
   times print beside the unsharded one's;
4h. the sequence phase, on the msf1 files committed in
   libheif_tpu_torch/testdata/seq (the JAX package's track writer; hvc1
   streams of its SequenceEncoder and of libx265, with libde265's plane
   hashes for each frame in output order): open each 1920x1080 9-frame
   B-pyramid sequence (the JAX encoder's, with TMVP and deblocking; and
   libx265's, with intra CUs, AMP and SAO in its P and B pictures)
   through HeifContext, decode every frame in output order with
   decode_next_image and convert it to interleaved RGB, each frame equal
   to its hashes, with the launch counts read around it
   (hevc_inter_pred once a P or B picture, planes_ycbcr8_to_rgb once a
   frame, both intra kernels); then random access by decode_sample
   (restarts at the IDR), and one more in-order pass frame by frame
   inside trace.collect() for the split by span (hevc.parse: the C++
   parser of the IDR and, as hevc.parse.inter, the Python parser of P
   and B pictures; hevc.mc,
   stages A and B, the inter residuals, deblock, SAO); hold
   hevc_inter_pred against its plain version on synthetic PU tables
   (codecs/hevc/inter_cases.py: every PU shape and fractional phase, uni
   and bi, vectors beyond every edge, 8, 10 and 12 bits; and a 3840x2160
   8-bit stress picture with local motion: vectors within 64 samples,
   every phase pair, three PUs in four bi) and on P and B
   pictures' PU tables and DPB, stage A's inter groups and, on pictures
   with intra CUs, both intra kernels against theirs; then the uncv track, each
   frame on the card (strided_extract_paste once a frame) and on the
   CPU with 0 samples differing and equal to its hashes.  Each frame's
   ms and the phase's seconds print;
4i. the encode phase, through HeifContext(...).new_file() /
   encode_image / write on the card: the HEVC photo's decoded 4032x3024
   4:2:0 planes with a synthetic 8-bit alpha gradient as jpeg items at
   quality 50 and 90 (launches read around it: jpeg_fdct_quant once for
   the image and once for its alpha, nothing else), each file equal to
   the same encode on the CPU, decoded through read_from_bytes on the
   card (jpeg_dequant_idct) equal to its CPU decode, with its PSNR
   against the source; jpeg_fdct_quant against fdct_quant_plain (0
   coefficients differing) on the photo's planes and alpha, 509x301
   images at every sampling and planes at odd offsets and pitches of one
   buffer; the flagship 4096x4096 4:2:0 image as unci items in 8x8 tiles
   (zlib over the whole payload through encode_image, and zlib a tile
   through UnciEncoder and HeifFile), each equal to the CPU encode's and
   read back on the card whole (strided_extract_paste once) and tile by
   tile (once a tile), equal to the source; 8- and 16-bit mski masks;
   the intra mode search, plan_modes_device on the photo's luma (launches:
   hevc_mode_search once a block size), and hevc_mode_search against
   mode_search_plain on that luma and on flat and noise planes at n = 8,
   16 and 32 under the near-tie rule (a different mode only where the
   two modes' float64 costs are within 1e-4; the count prints), and on
   blocks that are each mode's own prediction (both find every mode, at
   cost 0); and
   encode_jpeg's wall at 4032x3024 split by its spans (jpeg.encode.fdct,
   .copy, .entropy, .write);
4j. the write API, through HeifContext on the card: inter hvc1 tracks
   (add_visual_track with TrackOptions.inter_frames; a CIF 352x288
   9-frame B pyramid and QCIF 176x144 5-frame ipp, ldb and ibp tracks of
   inter_cases.panning_scene at quality 50) from the port's
   SequenceEncoder, whose reference pictures the port's decoder
   reconstructs on the card: each file's SHA-256 equal to the JAX
   writer's for the same calls (testdata/seq/encode_manifest.json), the
   launches read around the encode (hevc_inter_pred once a P or kept B
   picture, hevc_intra_wave once, for the IDR), every frame read back on
   the card in output order equal to the encoder's DPB picture, or for a
   non-reference B to the CPU decode, then converted to RGB
   (planes_ycbcr8_to_rgb once a frame), the encode's wall, per-frame ms
   and hevc.encode.seq spans printed; 1920x1080 8-frame tracks, all-intra
   hvc1 (the C++ path), mjpg (jpeg_fdct_quant once a frame) and uncv,
   each file equal to the same calls on the CPU, each frame's card decode
   equal to its CPU decode (hvc1: frame 0, and every frame equal to the
   intra encoder's reconstruction); a file with a still, an ibp track
   with mandatory TAI timestamps and GIMI ids, a URI metadata track, an
   alpha auxv track (auxl), 3 repetitions and a timescale of 25, equal to
   the CPU write and reopened to the same tables on the card and the
   CPU; and the item writers (a 2x2 grid of 512x512 hvc1 tiles with a
   thumbnail, Exif, XMP, a region and a text item; an overlay; a tili of
   four unci tiles, strided_extract_paste once a tile on read; an hvc1
   still with alpha and Exif as mini), each equal to the CPU write, each
   decode on the card equal to the CPU's;
4k. the AVC phase, on the x264 streams committed in
   libheif_tpu_torch/testdata/avc (with libavcodec's plane hashes; the
   monochrome one from the JAX package's encoder): build and load the
   C++ intra engine (avc_host); decode every stream through AvcDecoder
   on the card, equal to the manifest (the stills also on the CPU, 0
   samples differing; the weighted-prediction stream refused on both);
   write an
   AVC phone photo (an 8x6 grid of 48 512x512 avc1 CABAC items, item i
   the committed tile i mod 4, 4032x3024 output) and decode it through
   HeifContext to interleaved RGB, with the launch counts read around it
   (planes_ycbcr8_to_rgb once, nothing else), its planes held equal to
   the single tiles' CPU decodes placed where the grid puts them, its
   RGB to planes_ycbcr8_to_rgb's plain version on the card (exact) and to
   the CPU's decode (the colour contract), its median wall of REPEATS in
   MP/s split by the avc.* and color.* spans, and the colour kernel's,
   the copies' and the card's busy share from torch.profiler; the same
   for a 1920x1080 CABAC avc1 item; 256x256 CAVLC and monochrome items
   and a tili of the four tiles on the card and the CPU; the committed
   CIF 9-frame CABAC and QCIF 6-frame CAVLC IPPP avc1 tracks through
   decode_next_image, every frame to interleaved RGB and equal to the
   manifest (planes_ycbcr8_to_rgb once a frame), then decode_sample on
   an earlier frame (a restart at the IDR) and a later one, each frame's
   ms printed;
4l. AVC encode and JPEG 2000 through HeifContext on the card (the sizes,
   qualities and the JAX writer's SHA-256 of the same calls from the
   manifests that tests/card_encodes.py writes): the HEVC photo's
   4032x3024 planes with phase 4i's alpha through encode_image(img,
   "avc") at q 50 (the C++ engine, its walls split by the avc.encode
   spans), the file's SHA-256 the JAX writer's for the same calls, read
   back on the card to interleaved RGB (planes_ycbcr8_to_rgb once,
   nothing else) with its YCbCr and alpha planes equal to the encoders'
   reconstructions after the in-loop filter; a tili of four 512x512
   avc1 tiles and a QCIF IPPP avc track (every frame read back equal to
   the encoder's reference picture), each the JAX writer's bytes; build
   and load the JPEG 2000 block coders (j2k_host); the committed
   OpenJPEG and HTJ2K codestreams as j2k1 items on the card and the CPU,
   equal to the JAX decode's hashes and OpenJPEG's where exact (5/3, 16
   bits, HTJ2K); the photo as a lossless 5/3 j2k1 item (converted to RGB
   4:4:4 on the card by planes_ycbcr8_to_rgb, once), the file the JAX
   writer's bytes, read back on the card equal to the conversion, encode
   and decode split by the j2k.* spans; a 1024x768 crop at 9/7 q 60 and
   as htj2k and a tili of four jpeg2000 tiles, each the JAX writer's
   bytes (the SHA-256 of the same calls), each read back on the card and
   the CPU alike;
4m. VVC on the host as in the JAX package, the planes copied to the card
   once (the streams, files and SHA-256 from the manifests that
   tests/vvc_streams.py writes in libheif_tpu_torch/testdata/vvc):
   decode every committed stream through VvcDecoder on the card, equal
   to the JAX decode's plane hashes (the 10-bit one among them); decode
   the 1920x1080 vvc1 item (the JAX writer's encode of
   codecs/vvc/cases.synthetic_photo) through HeifContext to interleaved
   RGB, with the launch counts read around it (planes_ycbcr8_to_rgb
   once, nothing else), its YCbCr planes equal to the JAX decode's, its
   RGB within the colour contract of the plain colour path on the card,
   its wall split by the vvc.decode spans; read a 2x2 grid of 256x256
   vvc1 tiles, a tili of four 128x128 vvc1 tiles and a 3-frame vvc1
   track, and the same samples as a vvi1 track, to RGB, each picture
   equal to the manifest; then write on the card encode_image(img,
   "vvc") of a 256x256 RGB crop, add_visual_track(..., "vvc") of three
   128x96 frames and add_tiled_image(..., fmt="vvc") of four 128x128
   tiles, each file the JAX writer's SHA-256 and each picture read back
   equal to its encoder's reconstruction, the walls split by the
   vvc.encode spans; the card's name and power limit beside each time;
4n. the read side of the C-named API (libheif_tpu_torch/api) on the card,
   as a user calls it: heif_context_alloc() (the card), heif_context_
   read_from_memory, heif_context_get_primary_image_handle,
   heif_decode_image and heif_image_get_plane_readonly on the HEVC photo
   and the JPEG photo (interleaved RGB) and phase 4b's 4096x4096 unci
   grid with alpha (interleaved RGBA), with the launch counts read around
   each decode (hevc_dequant_itx, hevc_intra_wave and
   planes_ycbcr8_to_rgb once; jpeg_dequant_idct and planes_ycbcr8_to_rgb
   once; strided_extract_paste 65 times and planes_ycbcr8_to_rgb once;
   no other kernel), each plane the image's own tensor on the card and
   equal sample for sample to HeifContext's decode on the card; a small
   file written by the port's writer on the card (an hvc1 primary with
   a jpeg thumbnail, unci depth and generic aux images, Exif, XMP, pasp,
   udes, gimi, and a second image in ster and altr groups) through every
   read function of the API on a card context and on a CPU context,
   every answer and every image equal; an image made by
   heif_image_create(..., device=None) filled through heif_image_get_plane,
   read back, encoded as unci by the context's encode_image and decoded
   back through the API, all equal; each wall beside the card's name
   and power limit;
4o. the write side of the C-named API on the card, each step on a
   context from heif_context_alloc() with its launch counts asserted:
   (a) the HEVC photo through heif_context_encode_image and
   heif_context_encode_thumbnail (256 box) with the jpeg encoder at
   quality 90 (jpeg_fdct_quant twice); (b) heif_context_encode_grid of
   its 6x8 tiles of 512x512 as jpeg tiles (jpeg_fdct_quant 48 times),
   read back through heif_decode_image to interleaved RGB
   (jpeg_dequant_idct and planes_ycbcr8_to_rgb once) equal to
   HeifContext's decode; (c) heif_context_add_empty_unci_image of
   4096x4096 in 512x512 tiles filled by 64 heif_context_add_image_tile
   calls with the flagship's planes, read back (strided_extract_paste 64
   times) equal to them; each file of (a)-(c) and (g) the JAX writer's
   SHA-256 (testdata/api/manifest.json, tests/api_writes.py); (d)
   heif_image_handle_decode_image_tile of the HEVC photo's tiles (0, 0)
   and (7, 5) to interleaved RGB (the HEVC kernels and
   planes_ycbcr8_to_rgb once each), equal to the whole decode's crop; (e)
   heif_image_add_component of the twelve datatypes at 4032x3024 on the
   card, each written whole and read back through its typed getter (the
   same tensor), and an inline mask region packed from the photo's luma
   on the card and unpacked by heif_region_get_mask_image onto it; (f) a
   .py plugin taking the jpeg format (priority 1000, numpy planes)
   serving the JPEG photo tile by tile (48 calls) equal to the built-in
   decode after heif_unload_plugin (jpeg_dequant_idct once), and
   bindings/c/example_plugin.c built with cc, loaded, the photo's luma
   round-tripped through it onto the card; (g) a QCIF ipp hevc track
   through heif_context_add_visual_sequence_track and
   heif_track_encode_sequence_image, read back with
   heif_track_decode_next_image equal to HeifContext's track decode;
   each step's wall beside the card's name and power limit;
5. drive the fused yuv420_tiles_to_rgb path (the headline of bench.py) at
   the same shape, with its own launch count;
6. time kernels, plain versions, one-call PyTorch yardsticks (also for
   planar8_tiles_to_image, the copy case of strided_extract_paste, which
   is off the main path, and for the other 4096x4096 strided layouts), a
   device-to-device copy_ of as many bytes as each kernel moves, the
   access-width sweeps of the colour and strided kernels, and the main
   path and its host parts, with CUDA events, the two files' decode
   through the context part by part (parse, item data, tile decode,
   paste, transforms, alpha, convert, interleave) over REPEATS fresh
   contexts, and their device time (torch.profiler) over wall time;
   the HEVC kernels at the photo's shapes beside their plain versions,
   the float64 matmul yardstick of the transforms, their byte bounds and
   the wave chain's bound (waves x one step of hevc_wave_probe, which has
   the wave kernel's launch shape and per step one store, the barrier and
   one dependent load), stage B as the decode calls it (predict_waves:
   buffers allocated and zeroed, then the kernel), hevc_intra_wave on one
   tile beside its chain bound, stage A on the slices photo and on its
   two scaling-list tiles alone (per coefficient beside the flat
   photo's), the plain deblock and SAO stages, and both photos' decode
   over REPEATS fresh contexts, then once split by part from the decode
   path's own spans (core/trace.py: tile parses, plan on the host, its
   copies and tables, stages A to D, compose), with the flat photo's
   device share; the AV1 kernels at the 48-tile AVIF plan's
   shapes beside their plain versions, byte bounds, ptxas resources and
   stage B's chain bound (waves x one step of av1_wave_probe), stage B
   on the intrabc screenshot beside its byte bound (the photo's one
   decode, in phase 4d, runs under torch.profiler: its launch counts,
   its split by the decode path's own spans -- core/trace.py: tile
   parses, plan on the host, its copies and the rest on the card, stages
   A and B, deblock, CDEF, loop restoration, compose, convert,
   interleave -- and its device share); jpeg_dequant_idct at the JPEG
   photo's shapes beside recon_plain, the kernel alone and the call's
   table copy from torch.profiler, its byte and int32 bounds and a copy_
   of the same bytes (the JPEG photo's decode is timed in phase 4e:
   REPEATS decodes, the first, the launch-count decode, split by the
   spans: tile parses and scans, the reconstruction's gather, copies and
   launch, compose, convert, interleave; the last under torch.profiler
   for its device share); every integer kernel's row holds its byte
   bound and its int32 bound (SMs x 64 INT32 lanes x clocks.max.sm) and
   the larger; hevc_inter_pred at the largest P or B picture of the
   libx265 sequence beside its plain version and its bounds (the
   reference samples its jobs need, each once, the job table and the
   predicted samples; the filters' taps), and on the stress picture
   beside its bounds; jpeg_fdct_quant at the photo's three planes and
   hevc_mode_search at the photo's luma (n = 8, and by size) beside their
   plain versions, their byte bounds and their operation bounds (int32
   for the FDCT; FP32 lanes x clock for the search, counting the taps
   and butterflies it needs), ptxas resources and, for the search, the
   dense prediction product as one torch.matmul (a partial yardstick);
   and print the numbers;
7. print the colour kernels' SASS instructions per output pixel, the
   strided kernel's per output byte and the JPEG kernel's per output
   sample (sass_count.py, cuobjdump).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero.
``python3 chip_smoke.py --mesh-only`` runs the build and phase 4g alone
(on a machine with several cards, the cards' mesh spans all of them);
``python3 chip_smoke.py --sequences-only`` the build, phase 4h and
hevc_inter_pred's row; ``python3 chip_smoke.py --encode-only`` the build,
phases 4i and 4j and the two encode kernels' rows;
``python3 chip_smoke.py --avc-only`` the build, phase 4k and phase 4l's
AVC encode; ``python3 chip_smoke.py --j2k-only`` the build and phase 4l's
JPEG 2000 half; ``python3 chip_smoke.py --vvc-only`` the build and phase
4m; ``python3 chip_smoke.py --api-only`` the build and phase 4n;
``python3 chip_smoke.py --api-write-only`` the build and phase 4o.  Each AV1
stream is parsed once a run (av1_parse_once): the phases decode the same
committed streams many times over.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import hashlib
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from libheif_tpu_torch import (
    DecodingOptions, EncodingOptions, HeifContext, HeifFile, _build, api)
from libheif_tpu_torch import context as context_mod
from libheif_tpu_torch.boxes import read_all_boxes
from libheif_tpu_torch.boxes.codec_cfg import (
    Box_av1C, Box_avcC, Box_hvcC, Box_jpgC, Box_vvcC)
from libheif_tpu_torch.boxes.j2k import Box_cdef, Box_j2kH
from libheif_tpu_torch.boxes.meta import (
    Box_altr, Box_auxC, Box_clap, Box_gimi_content_id, Box_grpl, Box_imir,
    Box_irot, Box_ispe, Box_pasp, Box_ster, Box_udes, TaiClockInfo,
    TaiTimestampPacket)
from libheif_tpu_torch.boxes.tild import Box_tilC, TiledImageParameters
from libheif_tpu_torch.boxes.unc import (
    Box_uncC, Box_cmpd, Box_cpat, CmpdComponent, UncCComponent,
    InterleaveMode, SamplingMode)
from libheif_tpu_torch.codecs.av1 import cuda_fast as av1_fast
from libheif_tpu_torch.codecs.av1 import decoder as av1_decoder
from libheif_tpu_torch.codecs.av1 import device_recon as av1_recon
from libheif_tpu_torch.codecs.av1 import encoder as av1_encoder
from libheif_tpu_torch.codecs.av1 import obu as av1_obu
from libheif_tpu_torch.codecs.av1 import wave_cases as av1_cases
from libheif_tpu_torch.codecs.avc import AvcDecoder
from libheif_tpu_torch.codecs.avc import encoder as avc_encoder
from libheif_tpu_torch.codecs.avc import headers as avc_headers
from libheif_tpu_torch.codecs.hevc import cuda_fast as hevc_fast
from libheif_tpu_torch.codecs.hevc import decoder as hevc_decoder
from libheif_tpu_torch.codecs.hevc import device_modes
from libheif_tpu_torch.codecs.hevc import device_recon
from libheif_tpu_torch.codecs.hevc import encoder as hevc_encoder
from libheif_tpu_torch.codecs.hevc import headers as hevc_headers
from libheif_tpu_torch.codecs.hevc import inter_cases
from libheif_tpu_torch.codecs import kernel_timing, registry
from libheif_tpu_torch.codecs.j2k import native as j2k_native
from libheif_tpu_torch.codecs.jpeg import cuda_fast as jpeg_fast
from libheif_tpu_torch.codecs.jpeg import decoder as jpeg_decoder
from libheif_tpu_torch.codecs.jpeg import encoder as jpeg_encoder
from libheif_tpu_torch.codecs.jpeg import idct as jpeg_idct
from libheif_tpu_torch.codecs.vvc import VvcDecoder
from libheif_tpu_torch.codecs.vvc import encoder as vvc_encoder
from libheif_tpu_torch.codecs.vvc.cases import synthetic_photo
from libheif_tpu_torch.codecs.unc import (
    UnciDecoder, UnciEncoder, cuda_fast, kernels, sass_count)
from libheif_tpu_torch.codecs.unc.layout import (
    ComponentView, UncLayout, compute_layout)
from libheif_tpu_torch.color import convert_image, get_kr_kb
from libheif_tpu_torch.color.ops import ColorConversionOptions, YCbCrToRGB
from libheif_tpu_torch.core import trace
from libheif_tpu_torch.core.bitstream import ByteWriter
from libheif_tpu_torch.core.error import HeifError
from libheif_tpu_torch.core.fourcc import fourcc
from libheif_tpu_torch.core.fraction import Fraction
from libheif_tpu_torch.image.pixel_image import (
    Channel, Colorspace, Chroma, PixelImage)
from libheif_tpu_torch.items.derived import ImageGrid, ImageOverlay
from libheif_tpu_torch.items.region_item import RegionGeometry
from libheif_tpu_torch.items.mask_item import Box_mskC
from libheif_tpu_torch.io.reader import CallbackReader
from libheif_tpu_torch.items.tiled_item import TiledHeader
from libheif_tpu_torch.parallel import (
    coded_grid, make_mesh, sharded_unci_decode)
from libheif_tpu_torch.parallel.host_sharding import decode_grid_host_sharded
from libheif_tpu_torch.parallel.mesh import chunk_bounds
from libheif_tpu_torch.sequences import TrackOptions

SEED = 0
W = H = 4096
TILES = 8                       # 8x8 grid of 512x512 tiles
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12           # f32 outside the tensor cores, same sheet
# int32 operations: an H100 SM has 64 INT32 lanes against 128 FP32 lanes
# (Hopper architecture white paper), so the rate is SMs x 64 x the SM
# clock, read from this card (int32_rate)
INT32_LANES_PER_SM = 64
PALLAS = "libheif_tpu/codecs/unc/pallas_fast.py"
SOURCE = "libheif_tpu_torch/codecs/unc/csrc/unc_kernels.cu"
KR, KB = get_kr_kb(6)
DEV = "cuda"
# mangled names of the flagship instantiations in csrc/unc_kernels.cu
SASS_TILE = r"tile_yuv_to_rgb_kernelILi8ELi16ELi2ELi2ELb1EE"
SASS_PLANES = r"planes_ycbcr8_to_rgb_kernelILi16ELi1ELb1ELb1EE"
SASS_STRIDED = r"strided_extract_paste_kernelILi16ELi16EE"
# the file phase: the grid item's clean aperture, centred after irot 90
# and imir (a 12.2 MP phone-photo frame), and the timing repeats
CLAP = (4032, 3024)
MIRROR = "vertical"
REPEATS = 5
ALPHA_URN = "urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"


# every hand-written kernel, by name
ALL_KERNELS = {**cuda_fast.KERNELS, **hevc_fast.KERNELS,
               **av1_fast.KERNELS, **jpeg_fast.KERNELS}


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ layouts

def make_boxes(comps, types, tiles=(1, 1), version=0, profile=None,
               **fields):
    uncC = Box_uncC()
    uncC.version = version
    if profile:
        uncC.profile = fourcc(profile)
    uncC.components = [UncCComponent(i, d, 0, 0) for i, d in comps]
    uncC.num_tile_cols, uncC.num_tile_rows = tiles
    for k, v in fields.items():
        setattr(uncC, k, v)
    cmpd = Box_cmpd([CmpdComponent(t) for t in types]) if types else None
    return uncC, cmpd


def implied_cmpd():
    return Box_cmpd([CmpdComponent(t) for t in (1, 2, 3)])


def ycc420(w, h, tiles):
    return make_boxes([(0, 8), (1, 8), (2, 8)], [1, 2, 3], tiles,
                      sampling_type=SamplingMode.s420)


# Byte-aligned layouts of the CPU tests (tests/test_torch_unc.py) that the
# strided kernel takes, plus odd sizes: (name, w, h, boxes).
STRIDED_CASES = [
    ("comp420_8_2x2", 64, 32, ycc420(64, 32, (2, 2))),
    ("comp422_8_2x2", 64, 32, make_boxes(
        [(0, 8), (1, 8), (2, 8)], [1, 2, 3], (2, 2),
        sampling_type=SamplingMode.s422)),
    ("comp444_8_2x1", 48, 32, make_boxes(
        [(0, 8), (1, 8), (2, 8)], [1, 2, 3], (2, 1))),
    ("comp_rgb16_2x2", 32, 32, make_boxes(
        [(0, 16), (1, 16), (2, 16)], [4, 5, 6], (2, 2))),
    ("comp420_odd_rowalign_31x19", 31, 19, make_boxes(
        [(0, 8), (1, 8), (2, 8)], [1, 2, 3], sampling_type=SamplingMode.s420,
        row_align_size=4)),
    ("pixel_rgb8_2x2", 32, 16, make_boxes(
        [(0, 8), (1, 8), (2, 8)], [4, 5, 6], (2, 2),
        interleave_type=InterleaveMode.pixel)),
    ("pixel_rgba16_2x1", 32, 16, make_boxes(
        [(0, 16), (1, 16), (2, 16), (3, 16)], [4, 5, 6, 7], (2, 1),
        interleave_type=InterleaveMode.pixel)),
    ("pixel_padded_size_4", 16, 8, make_boxes(
        [(0, 8), (1, 8), (2, 8)], [4, 5, 6],
        interleave_type=InterleaveMode.pixel, pixel_size=4)),
    ("row_rgb8_2x2", 32, 16, make_boxes(
        [(0, 8), (1, 8), (2, 8)], [4, 5, 6], (2, 2),
        interleave_type=InterleaveMode.row)),
    ("row_rgb16_odd_27x9", 27, 9, make_boxes(
        [(0, 16), (1, 16), (2, 16)], [4, 5, 6],
        interleave_type=InterleaveMode.row)),
    ("mixed_nv12", 32, 16, make_boxes([], None, version=1, profile="nv12")),
    ("comp420_8_full_4096", W, H, ycc420(W, H, (TILES, TILES))),
    ("pixel_rgb8_full_4096", W, H, make_boxes(
        [(0, 8), (1, 8), (2, 8)], [4, 5, 6], (TILES, TILES),
        interleave_type=InterleaveMode.pixel)),
    ("comp_rgb16_full_4096", W, H, make_boxes(
        [(0, 16), (1, 16), (2, 16)], [4, 5, 6], (TILES, TILES))),
]
WIDTHS = (16, 8, 4, 1)          # vector widths of the strided kernel


def layout_and_tiles(w, h, boxes, seed):
    uncC, cmpd = boxes
    lay = compute_layout(uncC, cmpd or implied_cmpd(), w, h)
    data = np.random.default_rng(seed).integers(
        0, 256, lay.total_data_size(), dtype=np.uint8).tobytes()
    return lay, data, kernels.assemble_tile_buffers(lay, data)


def short_last_row():
    """Two tiles at pitch S (the payload read in place) whose view's last
    row ends past the tile size S = 14: the kernel must read zeros there,
    not the next tile's first bytes (or, after the last tile, past the
    allocation)."""
    v = ComponentView(comp_index=0, channel=Channel.Y, depth=8, width=4,
                      height=3, base_bits=0, row_stride_bits=6 * 8,
                      x_stride_bits=8, read_bits=8, mask=0xFF)
    lay = UncLayout(width=8, height=3, tile_cols=2, tile_rows=1,
                    tile_width=4, tile_height=3, views=[v],
                    tile_size_bytes=14)
    data = bytes(range(1, 29))
    return lay, data


def strided_widths(lay, t):
    """The (load, store) widths the host picks for a layout's views."""
    views = list(cuda_fast.strided_views(lay, t.device).values())
    return (cuda_fast.strided_load_width(t.shape[1], t.data_ptr(), views),
            cuda_fast.strided_store_width(views))


def strided_forced(lay, t, widths):
    """fused_strided_decode with the kernel's (load, store) widths
    forced."""
    views = cuda_fast.strided_views(lay, t.device)
    cuda_fast.strided_extract_paste(t, lay.tile_size_bytes, lay.tile_rows,
                                    lay.tile_cols, list(views.values()),
                                    widths)
    return {ch: v.out for ch, v in views.items()}


# --------------------------------------------------------------- comparison

class Tally:
    """Per-kernel check results."""

    def __init__(self):
        self.max_abs_err = {k: 0 for k in ALL_KERNELS}
        self.checks = {k: 0 for k in ALL_KERNELS}
        self.differing = {k: 0 for k in ALL_KERNELS}

    def compare(self, kernel, what, got, ref, exact):
        torch.cuda.synchronize()
        assert got.shape == ref.shape and got.dtype == ref.dtype, \
            f"{kernel} {what}: {tuple(got.shape)} {got.dtype} vs " \
            f"{tuple(ref.shape)} {ref.dtype}"
        d = (got.to(torch.int64) - ref.to(torch.int64)).abs()
        err = int(d.max()) if d.numel() else 0
        ndiff = int((d > 0).sum())
        log(f"check {kernel:22s} {what:44s} max_abs_err {err} "
            f"differing {ndiff} of {d.numel()}")
        if exact:
            assert err == 0, f"{kernel} {what}: not exact"
        else:
            assert err <= 1 and ndiff < 0.01 * d.numel(), \
                f"{kernel} {what}: beyond 1 LSB on 1% of pixels"
        self.max_abs_err[kernel] = max(self.max_abs_err[kernel], err)
        self.checks[kernel] += 1
        self.differing[kernel] += ndiff


def check_kernels(tally):
    """Phase 3: every kernel against its plain version on the card."""
    rng = np.random.default_rng(SEED)
    # tile_yuv_to_rgb: the CPU tests' grids, odd widths, tile widths that
    # are not a multiple of 16, pitches aligned to 16 and 8 bytes and odd
    # ((tr, tc, th, tw, sx, sy, bytes of padding)), the full width
    tw, th = W // TILES, H // TILES
    grids = [(2, 2, 64, 128, 2, 2, 8), (2, 2, 64, 128, 2, 2, 16),
             (2, 2, 64, 128, 2, 2, 9), (3, 1, 18, 34, 2, 2, 8),
             (2, 2, 32, 64, 2, 1, 8), (2, 2, 32, 64, 1, 1, 8),
             (1, 3, 6, 10, 2, 2, 8), (2, 3, 8, 24, 2, 2, 8),
             (3, 2, 6, 40, 2, 2, 8), (TILES, TILES, th, tw, 2, 2, 8),
             (TILES, TILES, th, tw, 2, 1, 8), (TILES, TILES, th, tw, 1, 1, 8)]
    for tr, tc, th, tw, sx, sy, pad in grids:
        n = th * tw + 2 * (th // sy) * (tw // sx)
        tiles = torch.from_numpy(rng.integers(
            0, 256, (tr * tc, n + pad), dtype=np.uint8)).to(DEV)
        vec = cuda_fast.tile_vector_width(n + pad, tw, sx, tc,
                                          tiles.data_ptr())
        for full in (True, False):
            kw = dict(tile_rows=tr, tile_cols=tc, tile_h=th, tile_w=tw,
                      sub_x=sx, sub_y=sy, kr=float(KR), kb=float(KB),
                      full_range=full)
            tally.compare("tile_yuv_to_rgb",
                          f"{tr}x{tc} tiles {tw}x{th} sub {sx}x{sy} "
                          f"pitch {n + pad} ({vec} B) "
                          f"{'full' if full else 'limited'}",
                          cuda_fast.yuv_tiles_to_rgb(tiles, **kw),
                          cuda_fast.yuv_tiles_to_rgb_plain(tiles, **kw),
                          exact=True)
    # planes_ycbcr8_to_rgb: the CPU tests' sizes (odd 129x67 included),
    # widths of 16-, 4- and 1-byte vectors with odd heights, the full
    # width, then chroma of a general nearest ratio and identity axes
    sub = {Chroma.C420: (2, 2), Chroma.C422: (2, 1), Chroma.C444: (1, 1)}
    sizes = [(64, 32), (129, 67), (7, 5), (W, 33), (W + 4, 31), (W + 1, 29),
             (W, H)]
    geoms = [(w, h, (w + sx - 1) // sx, (h + sy - 1) // sy, chroma)
             for w, h in sizes for chroma, (sx, sy) in sub.items()
             if w < W or chroma == Chroma.C420]
    geoms += [(64, 32, 20, 10, "general ratio"), (64, 32, 64, 16, "x same"),
              (64, 32, 32, 32, "y same")]
    for w, h, cw, ch, what in geoms:
        y = torch.from_numpy(rng.integers(0, 256, (h, w),
                                          dtype=np.uint8)).to(DEV)
        cb, cr = (torch.from_numpy(rng.integers(
            0, 256, (ch, cw), dtype=np.uint8)).to(DEV) for _ in range(2))
        vec = cuda_fast.planes_vector_width(
            w, cw, *(t.data_ptr() for t in (y, cb, cr)))
        for up in ("bilinear", "nearest-neighbor"):
            rules = cuda_fast.upsample_plan(ch, cw, h, w, up)
            for full in (True, False):
                kw = dict(kr=float(KR), kb=float(KB), full_range=full,
                          upsampling=up)
                tally.compare(
                    "planes_ycbcr8_to_rgb",
                    f"{w}x{h} {cw}x{ch} {what} {up} rules {rules[:2]} "
                    f"({vec} B) {'full' if full else 'limited'}",
                    cuda_fast.ycbcr8_planes_to_rgb(y, cb, cr, **kw),
                    cuda_fast.ycbcr8_planes_to_rgb_plain(y, cb, cr, **kw),
                    exact=True)
    check_strided(tally, rng)


def check_strided(tally, rng):
    """strided_extract_paste: every byte-aligned layout on the padded
    (T, S+8) buffers and on the payload read in place at pitch S, every
    load and store width the alignment allows, a short last row at pitch
    S, an odd address, and the planar copy case."""
    def compare_planes(what, got, ref):
        for ch in ref:
            tally.compare("strided_extract_paste", f"{what} {ch}", got[ch],
                          ref[ch], exact=True)

    for i, (name, w, h, boxes) in enumerate(STRIDED_CASES):
        lay, data, tiles = layout_and_tiles(w, h, boxes, seed=i)
        padded = torch.from_numpy(tiles).to(DEV)
        inplace = kernels.payload_tiles(lay, data, DEV)
        got = cuda_fast.fused_strided_decode(lay, padded)
        assert got is not None, f"{name}: strided path declined"
        ref = cuda_fast.fused_strided_decode_plain(lay, padded)
        compare_planes(f"{name} S+8", got, ref)
        compare_planes(f"{name} S+8 vs generic", got,
                       kernels._build_extractor(kernels._layout_key(lay))(
                           padded))
        compare_planes(f"{name} S", cuda_fast.fused_strided_decode(
            lay, inplace), cuda_fast.fused_strided_decode_plain(lay, inplace))
        compare_planes(f"{name} S vs S+8", cuda_fast.fused_strided_decode(
            lay, inplace), ref)
        lo, st = strided_widths(lay, inplace)
        log(f"strided widths {name}: S+8 {strided_widths(lay, padded)} "
            f"S {(lo, st)}")
        for vl in WIDTHS:
            for vs in WIDTHS:
                if vl <= lo and vs <= st:
                    compare_planes(f"{name} S load {vl} store {vs}",
                                   strided_forced(lay, inplace, (vl, vs)),
                                   ref)
    lay, data = short_last_row()
    inplace = kernels.payload_tiles(lay, data, DEV)
    expect = torch.tensor([[1, 2, 3, 4, 15, 16, 17, 18],
                           [7, 8, 9, 10, 21, 22, 23, 24],
                           [13, 14, 0, 0, 27, 28, 0, 0]], dtype=torch.uint8,
                          device=DEV)
    compare_planes("short last row at pitch S",
                   cuda_fast.fused_strided_decode(lay, inplace),
                   {Channel.Y: expect})
    compare_planes("short last row at pitch S, 1-byte access",
                   strided_forced(lay, inplace, (1, 1)), {Channel.Y: expect})
    lay, data, tiles = layout_and_tiles(*STRIDED_CASES[0][1:], seed=0)
    flat = torch.zeros(tiles.size + 1, dtype=torch.uint8, device=DEV)
    odd = flat[1:].view(tiles.shape)
    odd.copy_(torch.from_numpy(tiles))
    assert strided_widths(lay, odd)[0] == 1
    compare_planes("odd address", cuda_fast.fused_strided_decode(lay, odd),
                   cuda_fast.fused_strided_decode_plain(lay, odd))
    try:        # a width the alignment forbids is refused, not run
        strided_forced(lay, odd, (16, 16))
        raise AssertionError("a misaligned 16-byte load was launched")
    except RuntimeError:
        pass
    for c in (1, 3):
        tiles = torch.from_numpy(rng.integers(
            0, 256, (6, c * 16 * 24 + 8), dtype=np.uint8)).to(DEV)
        kw = dict(tile_rows=3, tile_cols=2, tile_h=16, tile_w=24,
                  num_comps=c)
        tally.compare("strided_extract_paste", f"planar8 copy case C={c}",
                      cuda_fast.planar8_tiles_to_image(tiles, **kw),
                      cuda_fast.planar8_tiles_to_image_plain(tiles, **kw),
                      exact=True)


CORE_MATRICES = (1, 4, 6, 7, 9)     # every distinct named Kr/Kb pair


def check_colour_core():
    """Phase 3b: the colour kernels' f32 core against the straightforward
    per-pixel core over every reachable input; returns the counts."""
    counts = {}
    t0 = time.perf_counter()
    for mc in CORE_MATRICES:
        kr, kb = get_kr_kb(mc)
        for full in (True, False):
            for scale in (1, 4, 16):
                n = cuda_fast.colour_core_mismatches(kr, kb, full, scale)
                counts[f"mc{mc} {'full' if full else 'limited'} s{scale}"] = n
    torch.cuda.synchronize()
    log(f"colour core check: {json.dumps(counts)} "
        f"({time.perf_counter() - t0:.2f} s)")
    bad = {k: v for k, v in counts.items() if v}
    assert not bad, f"colour core differs from the reference core: {bad}"
    return counts


# ------------------------------------------------------------ numpy checks

def np_bilinear(a, out_h, out_w):
    """Bilinear 2x chroma upsample of libheif_tpu/color/ops.py:80-99 in
    numpy, for planes whose size doubles exactly."""
    a = a.astype(np.float32)
    lft = np.concatenate([a[:, :1], a[:, :-1]], 1)
    rgt = np.concatenate([a[:, 1:], a[:, -1:]], 1)
    a = np.stack([(3 * a + lft) / 4, (3 * a + rgt) / 4], -1) \
        .reshape(a.shape[0], -1)[:, :out_w]
    top = np.concatenate([a[:1], a[:-1]], 0)
    bot = np.concatenate([a[1:], a[-1:]], 0)
    return np.stack([(3 * a + top) / 4, (3 * a + bot) / 4], 1) \
        .reshape(-1, a.shape[1])[:out_h]


def np_planes(data, tiles, tw, th):
    """Component-interleaved 4:2:0 tiles → full Y, Cb, Cr in numpy."""
    s = tw * th * 3 // 2
    buf = np.frombuffer(data, np.uint8).reshape(tiles, tiles, s)
    out = []
    for off, (pw, ph) in ((0, (tw, th)), (tw * th, (tw // 2, th // 2)),
                          (tw * th * 5 // 4, (tw // 2, th // 2))):
        p = buf[:, :, off:off + pw * ph].reshape(tiles, tiles, ph, pw)
        out.append(p.transpose(0, 2, 1, 3).reshape(tiles * ph, tiles * pw))
    return out


def np_rgb(y, cb, cr):
    f = np.float32
    y = y.astype(f)
    cb = np_bilinear(cb, *y.shape) - f(128)
    cr = np_bilinear(cr, *y.shape) - f(128)
    r = y + f(2 * (1 - KR)) * cr
    b = y + f(2 * (1 - KB)) * cb
    g = (y - f(KR) * r - f(KB) * b) / f(1 - KR - KB)
    return np.stack([np.clip(np.round(c), 0, 255) for c in (r, g, b)]) \
        .astype(np.uint8)


def decode_and_convert(uncC, cmpd, w, h, data):
    """The main path as a user calls it, from box bytes."""
    boxes = {type(b): b for b in read_all_boxes(uncC.serialize()
                                                + cmpd.serialize())}
    dec = UnciDecoder(boxes[Box_uncC], boxes[Box_cmpd], w, h, device=DEV)
    img = dec.decode(data)
    return dec, img, convert_image(img, Colorspace.RGB, Chroma.C444)


def rgb_of(img):
    return torch.stack([img.plane(c) for c in (Channel.R, Channel.G,
                                               Channel.B)])


def small_input_check(tally):
    """The main path on a small input against numpy."""
    w, h, t = 128, 96, 2
    uncC, cmpd = ycc420(w, h, (t, t))
    data = np.random.default_rng(SEED + 1).integers(
        0, 256, w * h * 3 // 2, dtype=np.uint8).tobytes()
    _, img, rgb = decode_and_convert(uncC, cmpd, w, h, data)
    ref_planes = np_planes(data, t, w // t, h // t)
    for ch, ref in zip((Channel.Y, Channel.Cb, Channel.Cr), ref_planes):
        tally.compare("strided_extract_paste", f"main path {w}x{h} {ch} "
                      "vs numpy", img.plane(ch),
                      torch.from_numpy(ref).to(DEV), exact=True)
    tally.compare("planes_ycbcr8_to_rgb", f"main path {w}x{h} RGB vs numpy",
                  rgb_of(rgb), torch.from_numpy(np_rgb(*ref_planes)).to(DEV),
                  exact=False)


# ------------------------------------------------------------------- timing

class DeviceTimer:
    """Device time of a call, from CUDA events around `n` back-to-back
    calls queued behind a sleep kernel (codecs/kernel_timing.py
    queued_ms), so host overhead between calls is not counted.  One
    timed pass: the plain versions launch more kernels a call than the
    launch queue holds, so the host waits for the card whatever the
    sleep, and a repeat with a longer one would only run them again."""

    def __init__(self):
        self.cycles_per_ms = kernel_timing.sleep_cycles_per_ms(torch)

    def __call__(self, fns, n=20):
        return kernel_timing.queued_ms(torch, list(fns), n,
                                       self.cycles_per_ms, tries=1)


def bounds(nbytes, nops, ops_per_s=None):
    """Both bounds of a kernel's work and the one that binds: the bytes
    over the memory rate and the operations over ``ops_per_s``, the
    card's rate for their type (None: int32, ``int32_rate``)."""
    if ops_per_s is None:
        ops_per_s = int32_rate()[2]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "byte_bound_ms": t_bytes, "op_bound_ms": t_ops}


@functools.lru_cache(maxsize=None)
def int32_rate():
    """(SMs, max SM clock in MHz, int32 operations a second) of card 0."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "--id=0"], capture_output=True,
        text=True, check=True).stdout.strip())
    return sms, mhz, sms * INT32_LANES_PER_SM * mhz * 1e6


def vector_width_sweep(timer, rng, fused_kw, plane_copies):
    """The colour kernels at 4096^2 with their access widths forced:
    (load, store) bytes for tile_yuv_to_rgb on the flagship tile buffers
    (pitch 393,224; 16-byte loads need a 393,232 pitch), and the one
    width of planes_ycbcr8_to_rgb.  Same arithmetic, other access
    widths; each is checked exactly against the plain version first,
    and each is timed twice, in opposite orders."""
    th, tw = H // TILES, W // TILES
    n = th * tw * 3 // 2
    mat = cuda_fast._matrix(float(KR), float(KB), True)
    bufs = {pad: [torch.from_numpy(rng.integers(
        0, 256, (TILES * TILES, n + pad), dtype=np.uint8)).to(DEV)
        for _ in range(4)] for pad in (8, 16)}

    def tile(t, load, store):
        out = torch.empty((3, H, W), dtype=torch.uint8, device=DEV)
        cuda_fast.TILE_YUV_TO_RGB.launch(
            out, t.data_ptr(), out.data_ptr(), t.shape[1], TILES, TILES, th,
            tw, 2, 2, load, store, *mat)
        return out

    def planes(p, vec):
        out = torch.empty((3, H, W), dtype=torch.uint8, device=DEV)
        cuda_fast.PLANES_YCBCR8_TO_RGB.launch(
            out, *(t.data_ptr() for t in p), out.data_ptr(), H, W, H // 2,
            W // 2, cuda_fast.DOUBLE, cuda_fast.DOUBLE, 16, vec, *mat)
        return out

    cases = {f"tile_load{lo}_store{st}": (
        lambda lo=lo, st=st, pad=pad: [lambda t=t: tile(t, lo, st)
                                       for t in bufs[pad]])
        for lo, st, pad in ((16, 16, 16), (8, 16, 8), (8, 8, 8), (4, 4, 8),
                            (1, 16, 8), (1, 1, 8))}
    cases.update({f"planes_{v}": (
        lambda v=v: [lambda p=p: planes(p, v) for p in plane_copies])
        for v in (16, 8, 4, 1)})
    for name, fns in cases.items():
        if name.startswith("tile"):
            t = bufs[16 if "load16" in name else 8][0]
            ref = cuda_fast.yuv_tiles_to_rgb_plain(t, sub_x=2, sub_y=2,
                                                   **fused_kw)
        else:
            ref = cuda_fast.ycbcr8_planes_to_rgb_plain(
                *plane_copies[0], kr=float(KR), kb=float(KB))
        assert torch.equal(fns()[0](), ref), name
    out = {name: [] for name in cases}
    for name in list(cases) + list(cases)[::-1]:
        out[name].append(timer(cases[name]()))
    log(f"access widths {json.dumps(out)}")
    return out


def as_strided_copy(lay, t):
    """One PyTorch call per channel: a strided view of the (T, pitch)
    tile stack, made contiguous (the strided kernel's yardstick; the port
    never calls it).  16-bit samples are copied as int16 without the
    byte swap, so they move the same bytes but stay big-endian."""
    out = {}
    for v in lay.views:
        nb = v.depth // 8
        src = t if nb == 1 else t.view(torch.int16)
        p = src.shape[1]
        out[v.channel] = torch.as_strided(
            src, (lay.tile_rows, v.height, lay.tile_cols, v.width),
            (lay.tile_cols * p, v.row_stride_bits // 8 // nb, p,
             v.x_stride_bits // 8 // nb), v.base_bits // 8 // nb) \
            .contiguous().view(lay.tile_rows * v.height,
                               lay.tile_cols * v.width)
    return out


def same_samples(got, lib):
    """A plane of the strided kernel against its as_strided yardstick
    (16-bit: with the yardstick's bytes swapped)."""
    if got.dtype == torch.uint8:
        return torch.equal(got, lib)
    return torch.equal(got.view(torch.uint8).view(-1, 2),
                       lib.view(torch.uint8).view(-1, 2).flip(1))


def strided_width_sweep(timer, lay, inplace):
    """strided_extract_paste at 4096^2 on the payload at pitch S with its
    (load, store) widths forced, every pair: same work, other access
    widths; each is checked against the plain version first and timed
    twice, in opposite orders."""
    ref = cuda_fast.fused_strided_decode_plain(lay, inplace[0])
    cases = {}
    for vl in WIDTHS:
        for vs in WIDTHS:
            got = strided_forced(lay, inplace[0], (vl, vs))
            for ch in ref:
                assert torch.equal(got[ch], ref[ch]), (vl, vs, ch)
            cases[f"load{vl}_store{vs}"] = [
                lambda t=t, w=(vl, vs): strided_forced(lay, t, w)
                for t in inplace]
    out = {name: [] for name in cases}
    for name in list(cases) + list(cases)[::-1]:
        out[name].append(timer(cases[name]))
    log(f"strided widths {json.dumps(out)}")
    return out


def strided_layout_timings(timer):
    """strided_extract_paste on the other 4096^2 layouts of STRIDED_CASES
    (pixel-interleaved 8-bit RGB, component 16-bit RGB) at pitch S,
    beside their as_strided().contiguous() yardstick."""
    out = {}
    for i, (name, w, h, boxes) in enumerate(STRIDED_CASES):
        if w < W or name.startswith("comp420"):
            continue
        lay, data, _ = layout_and_tiles(w, h, boxes, seed=i)
        ts = [kernels.payload_tiles(lay, data, DEV) for _ in range(4)]
        got = cuda_fast.fused_strided_decode(lay, ts[0])
        for ch, p in as_strided_copy(lay, ts[0]).items():
            assert same_samples(got[ch], p), (name, ch)
        nbytes = ts[0].numel() + sum(p.numel() * p.element_size()
                                     for p in got.values())
        out[name] = {
            "ms": timer([lambda t=t: cuda_fast.fused_strided_decode(lay, t)
                         for t in ts]),
            "library_ms": timer([lambda t=t: as_strided_copy(lay, t)
                                 for t in ts]),
            "bound_ms": bounds(nbytes, 0, F32_OPS_PER_S)["bound_ms"],
            "bytes": nbytes,
            "widths": strided_widths(lay, ts[0])}
        del ts, got
    log(f"strided layouts {json.dumps(out)}")
    return out


@contextlib.contextmanager
def launch_counts():
    """Every kernel's launch count set to 0 on entry; on exit (after a
    synchronise) the dict yielded holds the counts and the number of
    host tile assemblies (kernels.assemble_tile_buffers calls) made
    inside the block."""
    assemble = kernels.assemble_tile_buffers
    counts = {"assemble_tile_buffers": 0}

    def counted_assemble(*args):
        counts["assemble_tile_buffers"] += 1
        return assemble(*args)

    kernels.assemble_tile_buffers = counted_assemble
    for k in ALL_KERNELS.values():
        k.launches = 0
    try:
        yield counts
        sync_all()
        counts.update({n: k.launches for n, k in ALL_KERNELS.items()})
    finally:
        kernels.assemble_tile_buffers = assemble


# -------------------------------------------------------------------- files
# HEIF files written with the port's own HeifFile, decoded through
# HeifContext as a user calls it.

def mono8(tiles=(1, 1)):
    return make_boxes([(0, 8)], [0], tiles)


def rgb8():
    return make_boxes([(0, 8), (1, 8), (2, 8)], [4, 5, 6])


def payload(w, h, boxes, seed):
    uncC, cmpd = boxes
    lay = compute_layout(uncC, cmpd, w, h)
    return np.random.default_rng(seed).integers(
        0, 256, lay.total_data_size(), dtype=np.uint8).tobytes()


def new_file():
    f = HeifFile()
    f.init_for_writing("mif1", ["mif1", "miaf"])
    return f


def add_unci(f, w, h, boxes, data, props=(), hidden=True):
    """An unci item with its ispe, cmpd and uncC, then ``props``
    ((box, essential) pairs) in association order."""
    uncC, cmpd = boxes
    item = f.add_new_item("unci").item_id
    f.append_item_data(item, data)
    f.add_property(item, Box_ispe(w, h), False)
    f.add_property(item, cmpd, False)
    f.add_property(item, uncC, True)
    for prop, essential in props:
        f.add_property(item, prop, essential)
    f.get_infe(item).hidden = hidden
    return item


def transforms():
    """irot 90, imir and the centred clap, in that order."""
    return [(Box_irot(90), True), (Box_imir(MIRROR), True),
            (Box_clap(Fraction(CLAP[0], 1), Fraction(CLAP[1], 1)), True)]


def alpha_payload():
    return np.random.default_rng(SEED + 2).integers(
        0, 256, W * H, dtype=np.uint8).tobytes()


def grid_file(data, alpha):
    """An 8x8 grid of 512x512 4:2:0 unci items (item i holds tile i of the
    flagship payload, so the grid's planes are the flagship's) with irot
    90, imir and the clap, plus a 4096x4096 monochrome alpha item in 8x8
    tiles with the same transforms, linked by auxl."""
    f = new_file()
    tw, th = W // TILES, H // TILES
    size = tw * th * 3 // 2
    ids = [add_unci(f, tw, th, ycc420(tw, th, (1, 1)),
                    data[i * size:(i + 1) * size])
           for i in range(TILES * TILES)]
    grid = f.add_new_item("grid").item_id
    f.append_item_data(grid, ImageGrid(TILES, TILES, W, H).write(), 1)
    f.add_property(grid, Box_ispe(W, H), False)
    for prop, essential in transforms():
        f.add_property(grid, prop, essential)
    f.add_reference("dimg", grid, ids)
    alpha_id = add_unci(f, W, H, mono8((TILES, TILES)), alpha,
                        [(Box_auxC(ALPHA_URN), False)] + transforms())
    f.add_reference("auxl", alpha_id, [grid])
    f.set_primary_item(grid)
    return f.write()


def single_file(data):
    """The flagship as a file: one 4096x4096 unci item in 8x8 tiles."""
    f = new_file()
    f.set_primary_item(add_unci(f, W, H, ycc420(W, H, (TILES, TILES)),
                                data, hidden=False))
    return f.write()


def overlay_file():
    """A 96x64 overlay on a coloured background: an RGB layer, a 4:2:0
    layer with a partly transparent alpha item hanging over the left
    edge, and a monochrome layer over the top right corner."""
    f = new_file()
    a = add_unci(f, 40, 32, rgb8(), payload(40, 32, rgb8(), 10))
    b = add_unci(f, 36, 30, ycc420(36, 30, (1, 1)),
                 payload(36, 30, ycc420(36, 30, (1, 1)), 11))
    alpha = add_unci(f, 36, 30, mono8(), payload(36, 30, mono8(), 12),
                     [(Box_auxC(ALPHA_URN), False)])
    f.add_reference("auxl", alpha, [b])
    c = add_unci(f, 17, 13, mono8(), payload(17, 13, mono8(), 13))
    ov = f.add_new_item("iovl").item_id
    f.append_item_data(ov, ImageOverlay(
        0, (0x1234, 0x5678, 0x9abc, 0xffff), 96, 64,
        [(5, 3), (-3, 20), (85, -2)]).write(), 1)
    f.add_property(ov, Box_ispe(96, 64), False)
    f.add_reference("dimg", ov, [a, b, c])
    f.set_primary_item(ov)
    return f.write()


def iden_file():
    """iden (imir horizontal) of an odd 4:2:0 unci item with irot 270."""
    f = new_file()
    boxes = ycc420(37, 23, (1, 1))
    src = add_unci(f, 37, 23, boxes, payload(37, 23, boxes, 20),
                   [(Box_irot(270), True)])
    iden = f.add_new_item("iden").item_id
    f.add_reference("dimg", iden, [src])
    f.add_property(iden, Box_ispe(23, 37), False)
    f.add_property(iden, Box_imir("horizontal"), True)
    f.set_primary_item(iden)
    return f.write()


def missing_tile_file():
    """A 2x2 grid whose second tile is an item of an unknown type."""
    f = new_file()
    boxes = ycc420(32, 32, (1, 1))
    ids = [add_unci(f, 32, 32, boxes, payload(32, 32, boxes, 30 + i))
           for i in range(3)]
    bad = f.add_new_item("zzzz").item_id
    grid = f.add_new_item("grid").item_id
    f.append_item_data(grid, ImageGrid(2, 2, 64, 64).write(), 1)
    f.add_property(grid, Box_ispe(64, 64), False)
    f.add_reference("dimg", grid, [ids[0], bad, ids[1], ids[2]])
    f.set_primary_item(grid)
    return f.write()


def hdr10_file():
    """A 48x40 4:4:4 YCbCr item of packed 10-bit samples."""
    f = new_file()
    boxes = make_boxes([(0, 10), (1, 10), (2, 10)], [1, 2, 3])
    f.set_primary_item(add_unci(f, 48, 40, boxes,
                                payload(48, 40, boxes, 40), hidden=False))
    return f.write()


def same_image(what, got, ref):
    """A decode on the card against the port's CPU decode of the same
    file (the plain versions): every sample equal."""
    assert (got.width, got.height, got.colorspace, got.chroma,
            got.channels()) == (ref.width, ref.height, ref.colorspace,
                                ref.chroma, ref.channels()), what
    assert len(got.warnings) == len(ref.warnings), what
    n = total = 0
    for ch in ref.channels():
        assert got.plane(ch).device.type == DEV, f"{what} {ch}"
        assert got.bit_depth(ch) == ref.bit_depth(ch), f"{what} {ch}"
        a, b = got.np_plane(ch), ref.np_plane(ch)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what} {ch}"
        n += int(np.count_nonzero(a != b))
        total += a.size
    log(f"check file {what:44s} {got.width}x{got.height} "
        f"{got.colorspace}/{got.chroma} {'+'.join(got.channels())} "
        f"differing {n} of {total}")
    assert n == 0, f"{what}: the card's decode differs from the CPU's"


def decode_both(what, blob, *args, tile=None, **opts):
    """The file decoded on the card and on the CPU, held equal; returns
    the card's image."""
    out = []
    for device in (None, "cpu"):
        ctx = HeifContext.read_from_bytes(blob, device=device)
        options = DecodingOptions(**opts)
        if tile is None:
            out.append(ctx.decode_image(None, *args, options=options))
        else:
            out.append(ctx.decode_tile(ctx.primary_item_id, *tile, *args,
                                       options=options))
    same_image(what, *out)
    return out[0]


def np_tiles(data, tiles, tw, th):
    """A monochrome 8-bit payload in tiles x tiles → the plane."""
    return np.frombuffer(data, np.uint8).reshape(tiles, tiles, th, tw) \
        .transpose(0, 2, 1, 3).reshape(tiles * th, tiles * tw)


def transformed(p, sub):
    """numpy's irot 90 / imir / centred clap of a plane subsampled by
    ``sub`` in both directions."""
    p = np.flip(np.rot90(p, 1), 1 if MIRROR == "vertical" else 0)
    w, h = (CLAP[0] + sub - 1) // sub, (CLAP[1] + sub - 1) // sub
    left = (p.shape[1] * sub - CLAP[0]) // 2 // sub
    top = (p.shape[0] * sub - CLAP[1]) // 2 // sub
    return p[top:top + h, left:left + w]


def check_files(data, alpha, lib_rgb):
    """Phase 4b: the file path.  The grid + alpha file at full size is
    decoded once with the launch counts read around it; then every file
    is decoded on the card and on the CPU and held equal, the grid's
    planes against the generator's with and without the transforms, and
    the single-item file against the library path's image."""
    blobs = {"grid": grid_file(data, alpha), "single": single_file(data)}
    log(f"files: grid {len(blobs['grid'])} B, single "
        f"{len(blobs['single'])} B")
    with launch_counts() as launches:
        rgba = HeifContext.read_from_bytes(blobs["grid"]).decode_image(
            None, Colorspace.RGB, Chroma.InterleavedRGBA)
    log(f"file grid launches {launches}")
    tiles = TILES * TILES
    assert launches["strided_extract_paste"] == tiles + 1, \
        "strided_extract_paste: not one launch per unci item"
    assert launches["planes_ycbcr8_to_rgb"] == 1, \
        "planes_ycbcr8_to_rgb: not one launch per decode"
    assert launches["tile_yuv_to_rgb"] == 0
    assert launches["assemble_tile_buffers"] == 0, \
        "the file path assembled tile buffers"
    inter = rgba.plane(Channel.Interleaved)
    assert (rgba.width, rgba.height) == CLAP and \
        tuple(inter.shape) == (CLAP[1], CLAP[0] * 4) and \
        inter.dtype == torch.uint8
    same_image("grid+alpha interleaved RGBA", rgba, HeifContext.read_from_bytes(
        blobs["grid"], device="cpu").decode_image(
            None, Colorspace.RGB, Chroma.InterleavedRGBA))

    # the planes against the generator's, without and with the transforms
    y, cb, cr = np_planes(data, TILES, W // TILES, H // TILES)
    a = np_tiles(alpha, TILES, W // TILES, H // TILES)
    for what, opts, fix in (("untransformed", {"ignore_transformations": True},
                             lambda p, sub: p),
                            ("transformed", {}, transformed)):
        img = decode_both(f"grid+alpha {what}", blobs["grid"], **opts)
        for ch, ref, sub in ((Channel.Y, y, 1), (Channel.Cb, cb, 2),
                             (Channel.Cr, cr, 2), (Channel.Alpha, a, 1)):
            assert np.array_equal(img.np_plane(ch), fix(ref, sub)), \
                f"grid {what} {ch} vs the generator"
        log(f"check file grid+alpha {what} planes vs the generator: equal")

    # the single-item file: the library path's image, through the context
    rgb = decode_both(f"single {W} RGB", blobs["single"], Colorspace.RGB,
                      Chroma.C444)
    for i, ch in enumerate((Channel.R, Channel.G, Channel.B)):
        assert torch.equal(rgb.plane(ch), lib_rgb[i]), \
            f"single-item file {ch} vs the library path"
    log(f"check file single {W} RGB vs the library path: equal")

    # small files, and tiles
    decode_both("overlay, partly transparent layer", overlay_file())
    decode_both("overlay RGBA", overlay_file(), Colorspace.RGB,
                Chroma.InterleavedRGBA)
    decode_both("iden", iden_file())
    decode_both("iden RGB", iden_file(), Colorspace.RGB, Chroma.C444)
    for name, tile in (("grid", (TILES // 2 - 1, TILES - 1)),
                       ("single", (TILES - 1, TILES // 2))):
        decode_both(f"{name} tile {tile}", blobs[name], tile=tile)
        decode_both(f"{name} tile {tile} RGB", blobs[name], Colorspace.RGB,
                    Chroma.C444, tile=tile)
    img = decode_both("grid missing tile, strict off", missing_tile_file())
    assert len(img.warnings) == 1 and \
        not img.np_plane(Channel.Y)[:32, 32:].any()
    try:
        HeifContext.read_from_bytes(missing_tile_file()).decode_image(
            None, options=DecodingOptions(strict_decoding=True))
        raise AssertionError("a missing grid tile decoded in strict mode")
    except HeifError:
        pass
    decode_both("10-bit", hdr10_file())
    for chroma in (Chroma.C444, Chroma.InterleavedRGB,
                   Chroma.InterleavedRGBA):
        img = decode_both(f"10-bit RGB {chroma}", hdr10_file(),
                          Colorspace.RGB, chroma)
        assert img.bit_depth(img.channels()[0]) == 10
        img = decode_both(f"10-bit RGB {chroma} convert_hdr_to_8bit",
                          hdr10_file(), Colorspace.RGB, chroma,
                          convert_hdr_to_8bit=True)
        assert img.bit_depth(img.channels()[0]) == 8
    return blobs, launches


def ms_since(t0):
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def device_ms(fn, attempts=2):
    """Device time of what ``fn`` runs, from the device events of
    torch.profiler: kernels and copies apart, and the kernels with the
    most time.  A profiler session in this process sometimes records no
    device event at all; then ``fn`` runs again under a new session, up
    to ``attempts`` runs in all.  None when none recorded
    one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        copies_us = 0.0
        kernels = {}
        events = prof.events()
        # a record_function range (core/trace.py spans) is mirrored on the
        # device timeline under its own name: it is not device work
        ranges = {e.name for e in events if e.device_type != DeviceType.CUDA}
        for e in events:
            if e.device_type != DeviceType.CUDA or e.name in ranges:
                continue
            us = e.time_range.elapsed_us()
            if e.name.startswith(("Memcpy", "Memset")):
                copies_us += us
            else:
                n, t = kernels.get(e.name[:70], (0, 0.0))
                kernels[e.name[:70]] = (n + 1, t + us)
        if kernels:
            top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
            return {"kernels_ms": sum(t for _, t in kernels.values()) / 1e3,
                    "copies_ms": copies_us / 1e3, "attempt": attempt,
                    "top": [{"name": k, "count": n, "ms": t / 1e3}
                            for k, (n, t) in top[:10]]}
        log(f"device_ms: profiler session {attempt} of {attempts} "
            "recorded no device event")
    return None


def time_grid_file(blob):
    """The grid + alpha file's decode, once through the entry point
    (total) and once part by part, in a fresh context each repeat; the
    parts' result is held equal to the entry point's."""
    tw, th = W // TILES, H // TILES
    runs = []
    for _ in range(REPEATS):
        t = {}
        t0 = time.perf_counter()
        ref = HeifContext.read_from_bytes(blob).decode_image(
            None, Colorspace.RGB, Chroma.InterleavedRGBA)
        t["total_ms"] = ms_since(t0)

        t0 = time.perf_counter()
        ctx = HeifContext.read_from_bytes(blob)
        t["parse_ms"] = ms_since(t0)
        grid = ctx.get_item(ctx.primary_item_id)
        ids = grid.tile_item_ids()
        t0 = time.perf_counter()
        for i in ids + [grid.alpha_item.item_id]:
            ctx.file.get_item_data(i)
        t["item_data_ms"] = ms_since(t0)
        t0 = time.perf_counter()
        tiles = [ctx.get_item(i).decode_image() for i in ids]
        t["tile_decode_ms"] = ms_since(t0)
        t["per_tile_decode_ms"] = t["tile_decode_ms"] / len(ids)
        t0 = time.perf_counter()
        img = PixelImage(W, H, tiles[0].colorspace, tiles[0].chroma)
        for ch in tiles[0].channels():
            img.add_plane(ch, bit_depth=8, device=DEV)
        for idx, tile in enumerate(tiles):
            ty, tx = divmod(idx, TILES)
            img.copy_into(tile, tx * tw, ty * th)
        t["paste_ms"] = ms_since(t0)
        t0 = time.perf_counter()
        img = grid.apply_transforms(img)
        t["transform_ms"] = ms_since(t0)
        t0 = time.perf_counter()
        alpha = grid.alpha_item.decode_image()
        img.set_plane(Channel.Alpha, alpha.plane(Channel.Y), 8)
        t["alpha_ms"] = ms_since(t0)
        t0 = time.perf_counter()
        rgb = convert_image(img, Colorspace.RGB, Chroma.C444)
        t["convert_ms"] = ms_since(t0)
        t0 = time.perf_counter()
        rgba = convert_image(rgb, Colorspace.RGB, Chroma.InterleavedRGBA)
        t["interleave_ms"] = ms_since(t0)
        assert torch.equal(rgba.plane(Channel.Interleaved),
                           ref.plane(Channel.Interleaved)), \
            "the parts' result differs from the entry point's"
        t["mp_per_s"] = CLAP[0] * CLAP[1] / 1e3 / t["total_ms"]
        runs.append(t)
        log(f"file grid {json.dumps(t)}")
    return runs


def host_address(buf):
    return np.frombuffer(buf, np.uint8).ctypes.data


def time_single_file(blob, lay):
    """The single-item file: parse, item data, unci decode and colour
    conversion, and the entry point's total, each repeat; and the
    payload's host→device copy (kernels.payload_tiles) from the item data
    (a view of the file buffer) beside the same from a bytes copy of it,
    with each source's host address modulo 4096."""
    runs = []
    for _ in range(REPEATS):
        t = {}
        t0 = time.perf_counter()
        HeifContext.read_from_bytes(blob).decode_image(
            None, Colorspace.RGB, Chroma.C444)
        t["total_ms"] = ms_since(t0)
        t0 = time.perf_counter()
        ctx = HeifContext.read_from_bytes(blob)
        t["parse_ms"] = ms_since(t0)
        item = ctx.get_item(ctx.primary_item_id)
        t0 = time.perf_counter()
        ctx.file.get_item_data(item.item_id)
        t["item_data_ms"] = ms_since(t0)
        t0 = time.perf_counter()
        img = item.decode_image()
        t["decode_ms"] = ms_since(t0)
        t0 = time.perf_counter()
        convert_image(img, Colorspace.RGB, Chroma.C444)
        t["convert_ms"] = ms_since(t0)
        t["mp_per_s"] = W * H / 1e3 / t["total_ms"]
        view = ctx.file.get_item_data(item.item_id)
        for name, src in (("file_view", view), ("bytes_copy", bytes(view))):
            t0 = time.perf_counter()
            kernels.payload_tiles(lay, src, DEV)
            t[f"h2d_{name}_ms"] = ms_since(t0)
            t[f"h2d_{name}_address_mod_4096"] = host_address(src) % 4096
        runs.append(t)
        log(f"file single {json.dumps(t)}")
    return runs


def file_device_share(blobs, grid_runs, single_runs):
    """Kernel and copy time on the card over the entry point's wall time
    (median of the repeats) for both files."""
    out = {}
    for name, runs, target in (
            ("grid", grid_runs, Chroma.InterleavedRGBA),
            ("single", single_runs, Chroma.C444)):
        dev = device_ms(lambda: HeifContext.read_from_bytes(
            blobs[name]).decode_image(None, Colorspace.RGB, target))
        wall = float(np.median([r["total_ms"] for r in runs]))
        if dev is None:
            out[name] = "not measured (the profiler recorded no device time)"
        else:
            dev["kernel_share"] = dev["kernels_ms"] / wall
            dev["busy_share"] = (dev["kernels_ms"] + dev["copies_ms"]) / wall
            out[name] = dev
        log(f"file {name} device {json.dumps(out[name])}")
    return out


# --------------------------------------------------------------------- HEVC
# The HEVC phase: the committed streams of libheif_tpu_torch/testdata/hevc
# (encoded by the JAX package's IntraEncoder, with the plane hashes of its
# device engine), the two reconstruction kernels against their plain
# versions, and a phone photo's HEIC: an 8x6 grid of 512x512 hvc1 tiles
# under a 4032x3024 output.

HEVC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "libheif_tpu_torch", "testdata", "hevc")
HEVC_SOURCE = "libheif_tpu_torch/codecs/hevc/csrc/hevc_kernels.cu"
JNP_RECON = "libheif_tpu/codecs/hevc/device_recon.py"
PHOTO = (4032, 3024)
PHOTO_GRID = (6, 8)                  # rows, columns of 512x512 tiles
PHOTO_TILES = ("tile512_s0", "tile512_s1", "tile512_s2", "tile512_s3")
# the slices photo: scaling lists (default, custom) and several slices (4;
# 8 with deblocking), 8-bit, one batch key
SLICES_TILES = ("tile512_slists_default", "tile512_slists_custom",
                "tile512_4slices", "tile512_8slices_deblock")
K2_BATCH = ("tile512_s0", "tile512_s1")   # the plain wave loop is slow
K2_SINGLE = "tile512_s2"
K2_MIXED = ("nxn-dqp-sh", "rqt1-cu32")    # 112 and 12 waves, one key
# int32 operations per predicted sample in hevc_intra_wave (angular: two
# products, three sums, shift, clip; planar and DC fewer) and per
# multiply-add of hevc_dequant_itx
K2_OPS_PER_SAMPLE = 10


def hevc_streams():
    with open(os.path.join(HEVC_DIR, "manifest.json")) as f:
        return {e["name"]: e for e in json.load(f)["streams"]}


def hevc_nals(e):
    """(sps, pps, [slice NALs]) of a manifest entry: its "slice" file
    holds the NAL, its "slices" file each NAL behind a 4-byte length."""
    if "slices" in e:
        with open(os.path.join(HEVC_DIR, e["slices"]), "rb") as f:
            buf = f.read()
        slices, pos = [], 0
        while pos < len(buf):
            n = int.from_bytes(buf[pos:pos + 4], "big")
            slices.append(buf[pos + 4:pos + 4 + n])
            pos += 4 + n
    else:
        with open(os.path.join(HEVC_DIR, e["slice"]), "rb") as f:
            slices = [f.read()]
    return bytes.fromhex(e["sps"]), bytes.fromhex(e["pps"]), slices


def hevc_parse(e):
    """(SliceSyntax, raw TUs) of a stream, by the host parser."""
    sps, pps, slices = hevc_nals(e)
    return hevc_decoder.parse_picture(hevc_headers.parse_sps(sps),
                                      hevc_headers.parse_pps(pps), slices)


def int32_hashes(planes):
    """SHA-256 of each plane as little-endian int32 (the manifest's)."""
    return {ch: hashlib.sha256(np.ascontiguousarray(
        p.cpu().numpy(), "<i4").tobytes()).hexdigest()
        for ch, p in zip(("Y", "Cb", "Cr"), planes)}


def add_hvc1(f, e, hidden=True):
    """An hvc1 item holding stream ``e``: each slice NAL with a 4-byte
    length, an hvcC with its SPS and PPS, and ispe."""
    sps, pps, slices = hevc_nals(e)
    cfg = Box_hvcC()
    cfg.general_profile_idc = 1 if e["bit_depth"] == 8 else 2
    cfg.bit_depth_luma = cfg.bit_depth_chroma = e["bit_depth"]
    cfg.add_nal(sps)
    cfg.add_nal(pps)
    item = f.add_new_item("hvc1").item_id
    f.append_item_data(item, b"".join(len(s).to_bytes(4, "big") + s
                                      for s in slices))
    f.add_property(item, cfg, True)
    f.add_property(item, Box_ispe(e["width"], e["height"]), False)
    f.get_infe(item).hidden = hidden
    return item


def photo_file(streams, tiles=PHOTO_TILES):
    """The phone photo: 48 hidden hvc1 items (item i holds stream tiles[i
    mod 4]) in a 6x8 grid with a 4032x3024 output."""
    f = new_file()
    rows, cols = PHOTO_GRID
    ids = [add_hvc1(f, streams[tiles[i % 4]])
           for i in range(rows * cols)]
    grid = f.add_new_item("grid").item_id
    f.append_item_data(grid, ImageGrid(rows, cols, *PHOTO).write(), 1)
    f.add_property(grid, Box_ispe(*PHOTO), False)
    f.add_reference("dimg", grid, ids)
    f.set_primary_item(grid)
    return f.write()


def hvc1_file(e):
    f = new_file()
    f.set_primary_item(add_hvc1(f, e, hidden=False))
    return f.write()


def plain_waves(plan, waves):
    """predict_waves with the plain version of hevc_intra_wave."""
    T, W, H = plan.t, plan.width, plan.height
    ybuf = torch.zeros(T * H * W + 1, dtype=torch.int32, device=plan.device)
    cbuf = torch.zeros(T * 2 * (H >> 1) * (W >> 1) + 1, dtype=torch.int32,
                       device=plan.device)
    for w in range(plan.n_waves):
        hevc_fast.intra_wave_plain(
            ybuf, cbuf, waves, [int(g.starts[w]) for g in plan.groups],
            [int(g.counts[w]) for g in plan.groups], bd=plan.bd,
            strong=plan.strong_smoothing)
    return ybuf, cbuf


def plain_residuals(plan):
    return [hevc_fast.dequant_itx_plain(
        g.coeffs, g.qp, g.ts, g.tqb,
        hevc_fast.transform_matrix(g.key[0], g.key[1], plan.device),
        log2=g.key[1],
        bd=plan.bd, mslot=g.mslot, mtab=plan.mtab) for g in plan.groups]


def check_residuals(tally, what, plan):
    """hevc_dequant_itx (one launch for every group of the plan) against
    its plain version on each group; the kernel's residuals."""
    waves = device_recon.residuals(plan)
    for g, w, ref in zip(plan.groups, waves, plain_residuals(plan)):
        tally.compare("hevc_dequant_itx", f"{what} {g.key} n={g.n}",
                      w.res, ref, exact=True)
    return waves


def check_waves(tally, what, plan, waves):
    """hevc_intra_wave against the plain lockstep wave loop; the plain
    buffers."""
    ybuf, cbuf = plain_waves(plan, waves)
    y, c = wave_buffers(plan)
    hevc_fast.intra_waves(y, c, waves, plan.wave_rows, bd=plan.bd,
                          strong=plan.strong_smoothing)
    tally.compare("hevc_intra_wave", f"{what} luma, {plan.n_waves} waves",
                  y[:-1], ybuf[:-1], exact=True)
    tally.compare("hevc_intra_wave", f"{what} chroma", c[:-1], cbuf[:-1],
                  exact=True)
    return ybuf, cbuf


def check_extreme_groups(tally):
    """hevc_dequant_itx on synthetic groups of every size and plane with
    |c| = 32767, factors of 255 and the top QP at 8, 10 and 12 bits (a
    product of about 2^41, formed in 64 bits), flat-slot, transform-skip
    and bypass TUs among them, against its plain version."""
    rng = np.random.default_rng(SEED)
    for bd in (8, 10, 12):
        top = 51 + 6 * (bd - 8)
        mtab = rng.integers(1, 256, size=(4, 32, 32)).astype(np.uint8)
        mtab[0], mtab[1] = 16, 255
        groups = []
        for log2, luma in ((2, True), (3, True), (4, True), (5, True),
                           (2, False), (3, False), (4, False)):
            s, n = 1 << log2, 64
            c = rng.choice([-32767, 32767, 0, 1], size=(n, s, s))
            qp = np.full(n, top)
            qp[::3] = top - 1 - np.arange(len(qp[::3])) % 6
            slot = np.where(np.arange(n) % 4 == 1, 2, 1)
            slot[::7] = 0
            groups.append(hevc_fast.ItxGroup(
                luma, log2, torch.tensor(c, dtype=torch.int32, device=DEV),
                torch.tensor(qp, dtype=torch.int32, device=DEV),
                torch.tensor((rng.random(n) < 0.3) & (s == 4), device=DEV),
                torch.tensor(rng.random(n) < 0.1, device=DEV),
                torch.tensor(slot, dtype=torch.int32, device=DEV)))
        mt = torch.from_numpy(mtab).to(DEV)
        got = hevc_fast.dequant_itx(groups, bd=bd, mtab=mt)
        for g, r in zip(groups, got):
            ref = hevc_fast.dequant_itx_plain(
                g.coeffs, g.qp, g.ts, g.tqb,
                hevc_fast.transform_matrix(g.luma, g.log2, DEV),
                log2=g.log2, bd=bd, mslot=g.mslot, mtab=mt)
            tally.compare("hevc_dequant_itx",
                          f"extreme |c|=32767 m=255 qp={top} {bd}-bit "
                          f"({g.luma}, {g.log2})", r, ref, exact=True)


def check_hevc_kernels(tally, streams):
    """hevc_dequant_itx on every group of every stream, and hevc_intra_wave
    on every small stream, on a batch of two 512x512 tiles, on a batch
    whose pictures have different wave counts and on one 512x512 tile,
    against their plain versions on the card; then predict_waves (the
    decode's call) against the same.  The small streams include those with
    scaling lists (stage A's factor slots) and several slices (stage B's
    waves cut at slice boundaries)."""
    small = [e for n, e in streams.items() if not n.startswith("tile512")]
    batches = [[e] for e in small] + [[streams[n] for n in K2_BATCH]]
    batches += [[streams[n] for n in K2_MIXED]]
    batches += [[e] for n, e in streams.items()
                if n.startswith("tile512") and n not in K2_BATCH]
    for batch in batches:
        what = "+".join(e["name"] for e in batch)
        parsed = [hevc_parse(e) for e in batch]
        plan = device_recon.build_plan([p[0] for p in parsed],
                                       [p[1] for p in parsed], DEV)
        waves = check_residuals(tally, what, plan)
        if len(batch) == 1 and batch[0]["name"].startswith("tile512") \
                and batch[0]["name"] != K2_SINGLE:
            continue
        ybuf, cbuf = check_waves(tally, what, plan, waves)
        y, cb, cr = device_recon.predict_waves(plan, waves)
        tally.compare("hevc_intra_wave", f"{what} predict_waves luma",
                      y.reshape(-1), ybuf[:-1], exact=True)
        tally.compare("hevc_intra_wave", f"{what} predict_waves chroma",
                      torch.stack([cb, cr], 1).reshape(-1), cbuf[:-1],
                      exact=True)


def check_hevc_streams(streams):
    """Every stream decoded on the card (decode_intra_picture): its planes
    hash to the manifest (the JAX package's device or Python engine, or
    libde265 where the entry names it)."""
    for name, e in streams.items():
        sps, pps, slices = hevc_nals(e)
        planes = hevc_decoder.decode_intra_picture(
            hevc_headers.parse_sps(sps), hevc_headers.parse_pps(pps), slices)
        assert all(p.device.type == DEV for p in planes), name
        ok = int32_hashes(planes) == e["sha256"]
        log(f"check hevc stream {name:24s} {e['width']}x{e['height']} "
            f"{e['bit_depth']}-bit {len(slices)} slice(s) planes vs "
            f"manifest ({e.get('reference', 'JAX device engine')}): "
            f"{'equal' if ok else 'DIFFERENT'}")
        assert ok, f"{name}: planes differ from the manifest"


def photo_plan(streams, tiles=PHOTO_TILES):
    """The plan of the photo's 48 tiles, as the grid path builds it."""
    rows, cols = PHOTO_GRID
    parsed = [hevc_parse(streams[tiles[i % 4]])
              for i in range(rows * cols)]
    return device_recon.build_plan([p[0] for p in parsed],
                                   [p[1] for p in parsed], DEV)


def check_photo(blob, streams, plan, tiles=PHOTO_TILES, what="hevc photo"):
    """The phone photo through HeifContext: its launches (read around the
    decode to interleaved RGB), and its YCbCr planes against the single
    tiles' decodes placed where the grid puts them."""
    with launch_counts() as launches:
        rgb = HeifContext.read_from_bytes(blob).decode_image(
            None, Colorspace.RGB, Chroma.InterleavedRGB)
    log(f"{what} launches {launches} (plan: {len(plan.groups)} "
        f"groups, {plan.n_waves} waves, factor slots "
        f"{0 if plan.mtab is None else plan.mtab.shape[0]})")
    assert launches["hevc_dequant_itx"] == 1, \
        "hevc_dequant_itx: not one launch per plan"
    assert launches["hevc_intra_wave"] == 1, \
        "hevc_intra_wave: not one launch per plan"
    assert launches["planes_ycbcr8_to_rgb"] == 1
    assert launches["strided_extract_paste"] == 0
    assert launches["tile_yuv_to_rgb"] == 0
    inter = rgb.plane(Channel.Interleaved)
    assert (rgb.width, rgb.height) == PHOTO and inter.dtype == torch.uint8 \
        and tuple(inter.shape) == (PHOTO[1], PHOTO[0] * 3) \
        and inter.device.type == DEV

    img = HeifContext.read_from_bytes(blob).decode_image(None)
    singles = {}
    for n in tiles:
        sps, pps, slices = hevc_nals(streams[n])
        singles[n] = hevc_decoder.decode_intra_picture(
            hevc_headers.parse_sps(sps), hevc_headers.parse_pps(pps), slices)
    rows, cols = PHOTO_GRID
    n_diff = 0
    for i in range(rows * cols):
        ty, tx = divmod(i, cols)
        for ch, ref, sub in zip((Channel.Y, Channel.Cb, Channel.Cr),
                                singles[tiles[i % 4]], (1, 2, 2)):
            t = 512 // sub
            y0, x0 = ty * t, tx * t
            got = img.plane(ch)[y0:y0 + t, x0:x0 + t]
            h, w = got.shape
            n_diff += int((got.to(torch.int32) != ref[:h, :w]).sum())
    log(f"check {what} YCbCr vs the single tiles placed: differing "
        f"{n_diff}")
    assert n_diff == 0, "the grid's planes differ from the single tiles"
    try:
        YCbCrToRGB.USE_KERNEL = False        # the plain path on the card
        plain = convert_image(img, Colorspace.RGB, Chroma.InterleavedRGB)
    finally:
        YCbCrToRGB.USE_KERNEL = None
    assert torch.equal(plain.plane(Channel.Interleaved), inter), \
        "the photo's RGB differs from the plain conversion"
    return launches


def check_hvc1_files(streams):
    """A single-item hvc1 file, the 10-bit tile and the tile of eight
    slices (eight NALs in the item), through the context on the card and
    on the CPU (the plain versions), YCbCr and RGB; their YCbCr against the
    manifest."""
    blobs = {}
    for name in ("tile512_s0", "tile512_10bit", "tile512_8slices_deblock"):
        e = streams[name]
        blobs[name] = hvc1_file(e)
        img = decode_both(f"hvc1 {name}", blobs[name])
        ok = int32_hashes([img.plane(c).to(torch.int32) for c in
                           (Channel.Y, Channel.Cb, Channel.Cr)]) == e["sha256"]
        assert ok, f"{name}: the file's planes differ from the manifest"
        log(f"check file hvc1 {name} planes vs manifest: equal")
        decode_both(f"hvc1 {name} RGB", blobs[name], Colorspace.RGB,
                    Chroma.C444)
    return blobs


HEVC_SPANS = ("hevc.parse", "hevc.plan", "hevc.plan.host", "hevc.plan.copies",
              "hevc.plan.tables", "hevc.stage_a", "hevc.stage_b",
              "hevc.deblock", "grid.compose")


def time_photo(blob, what="hevc photo"):
    """The photo's decode through the entry point: REPEATS runs in a
    fresh context each (the wall), then one more inside trace.collect(),
    whose spans split it by part (each span ends in a device sync, so
    that run's total is a little longer; the tile parses run on several
    threads, so hevc.parse sums their times).  Every run's RGB equals the
    first's."""
    runs, ref = [], None
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        rgb = HeifContext.read_from_bytes(blob).decode_image(
            None, Colorspace.RGB, Chroma.InterleavedRGB)
        runs.append(ms_since(t0))
        if ref is None:
            ref = rgb.plane(Channel.Interleaved)
        assert torch.equal(rgb.plane(Channel.Interleaved), ref)
    with trace.collect() as spans:
        t0 = time.perf_counter()
        rgb = HeifContext.read_from_bytes(blob).decode_image(
            None, Colorspace.RGB, Chroma.InterleavedRGB)
        split_ms = ms_since(t0)
    assert torch.equal(rgb.plane(Channel.Interleaved), ref)
    for name in HEVC_SPANS:
        assert name in spans, f"the {what}'s decode ran no {name} span"
    assert spans["hevc.parse"]["count"] == PHOTO_GRID[0] * PHOTO_GRID[1]
    assert spans["hevc.stage_a"]["count"] == spans["hevc.stage_b"]["count"] \
        == 1, "not one stage A and one stage B per photo"
    t = {"total_ms": runs,
         "mp_per_s": [PHOTO[0] * PHOTO[1] / 1e3 / ms for ms in runs],
         "split_total_ms": split_ms, "spans": spans}
    log(f"{what} {json.dumps(t)}")
    return t


def time_hvc1_single(blob):
    runs = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        HeifContext.read_from_bytes(blob).decode_image(
            None, Colorspace.RGB, Chroma.InterleavedRGB)
        runs.append(ms_since(t0))
    log(f"hevc single item total ms {runs}")
    return runs


def itx_work(plan):
    """(bytes, operations, coefficients) of hevc_dequant_itx on a plan:
    coefficients in and residuals out (int32), qp, ts and tqb, the
    matrices, and where the plan has scaling lists each TU's slot and the
    factor table; two passes of s multiply-adds per sample."""
    nbytes = sum(g.n * ((1 << 2 * g.key[1]) * 8 + 6) + (1 << 2 * g.key[1]) * 4
                 for g in plan.groups)
    if plan.mtab is not None:
        nbytes += sum(g.n * 4 for g in plan.groups) + plan.mtab.numel()
    nops = sum(g.n * (1 << 2 * g.key[1]) * 4 * (1 << g.key[1])
               for g in plan.groups)
    coeffs = sum(g.n << (2 * g.key[1]) for g in plan.groups)
    return nbytes, nops, coeffs


def hevc_kernel_rows(timer, tally, plan, launches, s_plan, l_plan,
                     s_launches):
    """The kernels' rows of the {"kernels": ...} line, at the photo's
    shapes: the 48-tile plan's stage A and stage B; stage A also on the
    slices photo's plan and on a plan of its two scaling-list tiles alone
    (48, alternating), per coefficient beside the flat photo's."""
    waves = device_recon.residuals(plan)
    rows = {}
    nbytes, nops, coeffs = itx_work(plan)
    mats = [hevc_fast.transform_matrix(g.key[0], g.key[1], DEV).double()
            for g in plan.groups]
    deq = [dequantised(g, plan.bd).double() for g in plan.groups]

    def f64_matmul():
        return [torch.matmul(torch.matmul(m.t(), d), m)
                for m, d in zip(mats, deq)]
    b = bounds(nbytes, nops)
    flat_ms = timer([lambda: device_recon.residuals(plan)])
    other = {}
    for what, p in (("slices_photo", s_plan), ("lists", l_plan)):
        nb, no, nc = itx_work(p)
        ms = timer([lambda p=p: device_recon.residuals(p)])
        other[what] = {"ms": ms, "ns_per_coefficient": ms * 1e6 / nc,
                       "coefficients": nc, "bytes": nb, "ops": no,
                       "factor_slots": 0 if p.mtab is None else
                       p.mtab.shape[0], **bounds(nb, no)}
    per_coeff = flat_ms * 1e6 / coeffs
    other["lists"]["over_flat_per_coefficient"] = \
        other["lists"]["ns_per_coefficient"] / per_coeff
    other["slices_photo"]["launches"] = s_launches["hevc_dequant_itx"]
    rows["hevc_dequant_itx"] = {
        "name": "hevc_dequant_itx", "route": "cuda", "source": HEVC_SOURCE,
        "replaces": f"{JNP_RECON}:540",
        "launches": launches["hevc_dequant_itx"],
        "max_abs_err": tally.max_abs_err["hevc_dequant_itx"],
        "ms": flat_ms, "ns_per_coefficient": per_coeff,
        "coefficients": coeffs,
        "slices_photo": other["slices_photo"], "lists_plan": other["lists"],
        # the flat plan's instantiation, then the one with scaling lists
        **ptxas_resources("hevc_dequant_itx_kernelILb0"),
        "lists_ptxas": ptxas_resources("hevc_dequant_itx_kernelILb1"),
        "plain_ms": timer([lambda: plain_residuals(plan)], n=3),
        **b,
        "library_ms": timer([f64_matmul], n=5),
        "library_call": "float64 torch.matmul, M^T D M per group",
        "checks": tally.checks["hevc_dequant_itx"],
        "differing_pixels": tally.differing["hevc_dequant_itx"],
        "bytes": nbytes, "ops": nops,
        "groups": {str(g.key): g.n for g in plan.groups}}
    # hevc_intra_wave: per TU its references (index, availability and
    # sample), mode, and per sample residual, scatter index and store
    nbytes = nops = 0
    for g in plan.groups:
        n = 1 << g.key[1]
        nbytes += g.n * ((4 * n + 1) * 9 + 4 + n * n * 12)
        nops += g.n * n * n * K2_OPS_PER_SAMPLE
    b = bounds(nbytes, nops)
    chain_ms = wave_chain_ms(timer, plan)
    empty_ms = timer([lambda: torch.cuda._sleep(0)], n=500)
    ybuf, cbuf = wave_buffers(plan)
    ybuf2, cbuf2 = wave_buffers(s_plan)
    waves2 = device_recon.residuals(s_plan)
    rows["hevc_intra_wave"] = {
        "name": "hevc_intra_wave", "route": "cuda", "source": HEVC_SOURCE,
        "replaces": f"{JNP_RECON}:890",
        "launches": launches["hevc_intra_wave"],
        "max_abs_err": tally.max_abs_err["hevc_intra_wave"],
        "ms": timer([lambda: hevc_fast.intra_waves(
            ybuf, cbuf, waves, plan.wave_rows, bd=plan.bd,
            strong=plan.strong_smoothing)]),
        # stage B as the decode calls it (and as the per-wave design's
        # row timed it): the buffers allocated and zeroed, then the kernel
        "predict_waves_ms": float(np.median([timer([
            lambda: device_recon.predict_waves(plan, waves)], n=1)
            for _ in range(5)])),
        "plain_ms": timer([lambda: plain_waves(plan, waves)], n=1),
        # the largest of the in-kernel chain (waves x one probe step),
        # the bytes and the int32 operations
        **chain_bound(b, chain_ms),
        "library_ms": None,
        "launch_chain_ms": plan.n_waves * empty_ms,
        "empty_launch_ms": empty_ms, "waves": plan.n_waves,
        "checks": tally.checks["hevc_intra_wave"],
        "differing_pixels": tally.differing["hevc_intra_wave"],
        "bytes": nbytes, "ops": nops,
        "slices_photo_ms": timer([lambda: hevc_fast.intra_waves(
            ybuf2, cbuf2, waves2, s_plan.wave_rows, bd=s_plan.bd,
            strong=s_plan.strong_smoothing)]),
        "slices_photo_waves": s_plan.n_waves,
        "slices_photo_launches": s_launches["hevc_intra_wave"],
        **ptxas_resources("hevc_intra_wave_kernel")}
    log(f"hevc kernels {json.dumps(rows)}")
    return rows


def wave_buffers(plan):
    """Flat luma and chroma sample buffers of a plan (with the trash
    slot).  The wave kernel writes every sample before it reads it, so a
    timing loop reuses them."""
    T, H, W = plan.t, plan.height, plan.width
    return (torch.zeros(T * H * W + 1, dtype=torch.int32,
                        device=plan.device),
            torch.zeros(T * 2 * (H >> 1) * (W >> 1) + 1, dtype=torch.int32,
                        device=plan.device))


def wave_chain_ms(timer, plan):
    """hevc_intra_wave's in-kernel chain bound on a plan: n_waves steps of
    hevc_wave_probe (one block a picture, as the kernel), from a launch of
    10 x n_waves steps, so the launch itself is amortised."""
    buf = torch.zeros(plan.t, dtype=torch.int32, device=DEV)
    steps = 10 * plan.n_waves
    ms = timer([lambda: hevc_fast.wave_probe(buf, steps)], n=5)
    return ms / steps * plan.n_waves


def wave_single(timer, plan):
    """hevc_intra_wave on a one-picture plan beside its chain bound."""
    waves = device_recon.residuals(plan)
    ybuf, cbuf = wave_buffers(plan)
    out = {"ms": timer([lambda: hevc_fast.intra_waves(
        ybuf, cbuf, waves, plan.wave_rows, bd=plan.bd,
        strong=plan.strong_smoothing)], n=10),
        "chain_bound_ms": wave_chain_ms(timer, plan), "waves": plan.n_waves}
    log(f"hevc wave single tile {json.dumps(out)}")
    return out


def photo_device_share(blob, runs):
    """Kernel and copy time on the card over the entry point's wall time
    (median of the repeats) for the photo."""
    dev = device_ms(lambda: HeifContext.read_from_bytes(blob).decode_image(
        None, Colorspace.RGB, Chroma.InterleavedRGB))
    wall = float(np.median(runs["total_ms"]))
    if dev is None:
        dev = "not measured (the profiler recorded no device time)"
    else:
        dev["kernel_share"] = dev["kernels_ms"] / wall
        dev["busy_share"] = (dev["kernels_ms"] + dev["copies_ms"]) / wall
    log(f"hevc photo device {json.dumps(dev)}")
    return dev


def dequantised(g, bd):
    """A group's dequantised, clipped levels: the operand of stage A's
    matrix products (device_recon.py:547-551)."""
    lvl = torch.tensor(hevc_fast.LEVEL_SCALE, dtype=torch.int32, device=DEV)
    bs = bd + g.key[1] - 5
    scale = lvl[g.qp % 6] << (g.qp // 6)
    return torch.clamp((g.coeffs * scale[:, None, None] + (1 << (bs - 5)))
                       >> (bs - 4), -32768, 32767)


def stage_ms(timer, plan):
    """Device time of the plain stages C and D on the photo's planes."""
    y, cb, cr = device_recon.predict_waves(plan, device_recon.residuals(plan))
    out = {"deblock_ms": timer([lambda: device_recon.deblock(
        plan.deblock, y, cb, cr, 255)], n=5)}
    y, cb, cr = device_recon.deblock(plan.deblock, y, cb, cr, 255)
    out["sao_ms"] = timer([lambda: device_recon.sao(plan, y, cb, cr)], n=5)
    return out


# ---------------------------------------------------------------------- AV1
# The AV1 phase: the committed streams of libheif_tpu_torch/testdata/av1
# (the JAX package's Av1IntraEncoder and libaom, with the plane hashes of
# the JAX host engine), the two reconstruction kernels against their
# plain versions, and a phone photo's AVIF: an 8x6 grid of 512x512 av01
# tiles under a 4032x3024 output.

AV1_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "libheif_tpu_torch", "testdata", "av1")
AV1_SOURCE = "libheif_tpu_torch/codecs/av1/csrc/av1_kernels.cu"
AV1_JNP = "libheif_tpu/codecs/av1/device_recon.py"
AV1_MIXED = ("aom-128-q30-c0", "aom-128-q60-c2")   # different wave counts
# stage B on these tiles alone (the photo's plan holds tile512_s0..s3)
AV1_WAVE_SINGLES = ("tile512_10bit", "tile508x500")
# the grain photo's tiles: film grain with overlap off and clipping (1),
# overlap and clipping (7), neither (12), chroma scaling from luma (15)
GRAIN_TILES = ("grain-tile512-tv1", "grain-tile512-tv7",
               "grain-tile512-tv12", "grain-tile512-tv15")
# the grain photo's grid (rows, columns) and output: each grain stream
# twice, the last row and column cut (its Python parses ~8 s, against
# ~50 s for a 48-tile grid)
GRAIN_GRID = (2, 4)
GRAIN_PHOTO = (2000, 1000)
# the grid and output of the AVIF photo that HeifContext decodes: the four
# photo streams once each, the last row and column cut (its Python parses
# ~9 s, against ~102 s for the 48 tiles of the HEVC and JPEG photos' 6x8
# grid); the AV1 kernels' checks and rows keep the 48-tile plan, built from
# the four streams' cached parses (av1_photo_plan)
AV1_PHOTO_GRID = (2, 2)
AV1_PHOTO = (1000, 1000)
SCREENSHOT = "ibc-screenshot-1920x1080"
# synthetic intrabc waves: (ssx, ssy), bit depth
AV1_IBC_CASES = (((1, 1), 8), ((1, 0), 8), ((0, 0), 8), ((1, 1), 10),
                 ((1, 0), 10))
AV1_PLAIN_WAVES_MS = {}
AV1_PARSES = {}          # av1_parse_key of a stream -> (seq, fh, TileDecoder)
AV1_PARSE_MS = {}        # av1_parse_key of a stream -> its one parse's ms
AV1_REPEATS = 2          # the photo's Python parse takes tens of seconds
# int32 operations per predicted sample of av1_intra_wave (directional:
# two index products, shifts, two samples' interpolation, clip; residual
# add and clip) and per transformed sample and 1-D stage of
# av1_dequant_itx (a butterfly's multiply-add pair and rounding)
AV1_OPS_PER_SAMPLE = 14
AV1_OPS_PER_STAGE = 4


def av1_streams():
    with open(os.path.join(AV1_DIR, "manifest.json")) as f:
        return {e["name"]: e for e in json.load(f)["streams"]}


def av1_data(e):
    with open(os.path.join(AV1_DIR, e["file"]), "rb") as f:
        return f.read()


_AV1_PARSE_FRAME = av1_decoder._parse_frame


def av1_parse_key(data):
    """A digest of what a parse of ``data`` reads: the last sequence
    header OBU before the first frame, then every frame, frame header and
    tile group OBU.  A stream and an av01 item holding it (its av1C's
    sequence header before the stream's OBUs) share a key."""
    h = hashlib.sha256()
    seq, framed = b"", False
    for ob in av1_obu.split_obus(bytes(data)):
        if ob.type == av1_obu.OBU_SEQUENCE_HEADER and not framed:
            seq = ob.payload
        elif ob.type in (av1_obu.OBU_FRAME_HEADER, av1_obu.OBU_TILE_GROUP,
                         av1_obu.OBU_FRAME):
            if not framed:
                h.update(len(seq).to_bytes(8, "big") + seq)
                framed = True
            h.update(bytes([ob.type]) + len(ob.payload).to_bytes(8, "big") +
                     ob.payload)
    return h.hexdigest()


def av1_parse_once(data, limits):
    """av1_decoder._parse_frame once a stream a run.  The AV1 phase
    decodes the same committed streams many times over (the kernel
    checks, the stream hashes, both photos, the av01 files on the card
    and the CPU, the timing), and the Python parse is much of each
    decode; a decode, its plan and its filters only read a parse, so one
    parse serves them all.  ``main`` and the phases run alone install it
    (install_av1_parse_once); AV1_PARSE_MS keeps each stream's one parse
    time, since a later decode's av1.parse span then costs ~0 ms."""
    key = av1_parse_key(data)
    if key not in AV1_PARSES:
        t0 = time.perf_counter()
        AV1_PARSES[key] = _AV1_PARSE_FRAME(data, limits)
        AV1_PARSE_MS[key] = (time.perf_counter() - t0) * 1e3
    return AV1_PARSES[key]


def install_av1_parse_once():
    av1_decoder._parse_frame = av1_parse_once


def av1_parse(e):
    """(seq, fh, TileDecoder) of a stream, by the host parse (once a
    stream, av1_parse_once)."""
    return av1_decoder.parse_frame(av1_data(e))


def av1_decode_parsed(e, device):
    """A parsed stream's cropped int32 planes on ``device``, in-loop
    filters and film grain included (decode_intra_frame after its
    parse)."""
    seq, fh, dec = av1_parse(e)
    planes = av1_recon.decode_frames_device([dec], device)[0]
    return av1_decoder.maybe_grain(
        av1_decoder.finish_frame(seq, fh, dec, planes), seq, fh)


def av1_hashes(planes):
    return {k: hashlib.sha256(np.ascontiguousarray(
        v.cpu().numpy(), "<i4").tobytes()).hexdigest()
        for k, v in planes.items()}


def leb128(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def add_av01(f, e, hidden=True):
    """An av01 item holding stream ``e``: the OBUs, an av1C with the
    sequence header OBU, and ispe."""
    data = av1_data(e)
    cfg = Box_av1C()
    cfg.high_bitdepth = int(e["bit_depth"] > 8)
    seqh = next(o for o in av1_obu.split_obus(data)
                if o.type == av1_obu.OBU_SEQUENCE_HEADER)
    cfg.config_obus = bytes([(av1_obu.OBU_SEQUENCE_HEADER << 3) | 2]) + \
        leb128(len(seqh.payload)) + seqh.payload
    item = f.add_new_item("av01").item_id
    f.append_item_data(item, data)
    f.add_property(item, cfg, True)
    f.add_property(item, Box_ispe(e["width"], e["height"]), False)
    f.get_infe(item).hidden = hidden
    return item


def av1_photo_file(streams, tiles=PHOTO_TILES, grid_shape=AV1_PHOTO_GRID,
                   size=AV1_PHOTO):
    """The AVIF photo: 4 hidden av01 items (item i holds stream tiles[i
    mod 4]) in a 2x2 grid with a 1000x1000 output (or another
    ``grid_shape`` (rows, columns) and output ``size``)."""
    f = new_file()
    rows, cols = grid_shape
    ids = [add_av01(f, streams[tiles[i % 4]])
           for i in range(rows * cols)]
    grid = f.add_new_item("grid").item_id
    f.append_item_data(grid, ImageGrid(rows, cols, *size).write(), 1)
    f.add_property(grid, Box_ispe(*size), False)
    f.add_reference("dimg", grid, ids)
    f.set_primary_item(grid)
    return f.write()


def av01_file(e):
    f = new_file()
    f.set_primary_item(add_av01(f, e, hidden=False))
    return f.write()


def av1_plain_residuals(plan):
    return [av1_fast.dequant_itx_plain(g.sq, g.coeffs, g.txp)
            for g in plan.groups]


def av1_plain_waves(plan, res):
    """Stage B with the plain version: the palette jobs, then the jnp
    program's lockstep wave loop."""
    buf, waves = av1_recon.palette_and_waves(plan, res)
    starts = plan.wave_rows[:, :, 0].T.tolist()
    counts = (plan.wave_rows[:, :, -1] - plan.wave_rows[:, :, 0]).T.tolist()
    for st, cn in zip(starts, counts):
        av1_fast.intra_wave_plain(buf, waves, st, cn,
                                  **av1_recon.wave_args(plan))
    return buf


def check_av1_plan(tally, what, plan, waves=True):
    """av1_dequant_itx (one launch for every group) against its plain
    version on each group, then av1_intra_wave (one launch) against the
    plain lockstep wave loop on the kernel's residuals (its device time,
    from CUDA events around the one run, kept in AV1_PLAIN_WAVES_MS)."""
    res = av1_recon.residuals(plan)
    for g, r, ref in zip(plan.groups, res, av1_plain_residuals(plan)):
        tally.compare("av1_dequant_itx",
                      f"{what} {av1_recon.KIND_NAMES[g.kind]}{g.sq} n={g.n}",
                      r, ref, exact=True)
    if waves:
        buf = av1_recon.predict_waves(plan, res)
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(True), torch.cuda.Event(True)
        s.record()
        ref = av1_plain_waves(plan, res)
        e.record()
        e.synchronize()
        AV1_PLAIN_WAVES_MS[what.split(" ")[0]] = s.elapsed_time(e)
        tally.compare("av1_intra_wave", f"{what}, {plan.n_waves} waves",
                      buf[:-1], ref[:-1], exact=True)
    return res


def check_av1_kernels(tally, streams):
    """Both AV1 kernels on every small stream but the film-grain ones
    (grain is a plain-torch output stage: their hashes hold it), the
    intrabc ones among them, on a batch whose pictures have different
    wave counts and on the 512x512 tiles that the photo's plan does not
    hold (AV1_WAVE_SINGLES), against their plain versions.  The photo's
    four tiles are checked in the photo's plan (check_av1_plan in main);
    the screenshot's decode is held to the manifest's hash
    (check_av1_streams) and its stage B timed (av1_screenshot_stage_b):
    its plan and plain versions took ~10 s here."""
    small = [[e] for n, e in streams.items()
             if not n.startswith(("tile", "grain")) and n != SCREENSHOT]
    batches = small + [[streams[n] for n in AV1_MIXED]]
    batches += [[streams[n]] for n in AV1_WAVE_SINGLES]
    for batch in batches:
        what = "+".join(e["name"] for e in batch)
        t0 = time.perf_counter()
        plan = av1_recon.build_plan([av1_parse(e)[2] for e in batch], DEV)
        check_av1_plan(tally, what, plan)
        log(f"av1 kernels on {what} checked in "
            f"{time.perf_counter() - t0:.2f} s")
    # waves that mix 64x64, filter-intra, CfL and 4x4 jobs (some beyond
    # the kernel's shared memory at once), against the plain version in
    # the kernel's order and in the lockstep order
    case = av1_cases.wave_heavy(seed=SEED, device=DEV)
    got, ref, lock = (case.buf.clone() for _ in range(3))
    av1_fast.intra_waves(got, case.groups, case.rows, **case.kw)
    av1_fast.intra_waves_by_picture_plain(ref, case.groups, case.rows,
                                          **case.kw)
    starts = case.rows[:, :, 0].T.tolist()
    counts = (case.rows[:, :, -1] - case.rows[:, :, 0]).T.tolist()
    for st, cn in zip(starts, counts):
        av1_fast.intra_wave_plain(lock, case.groups, st, cn, **case.kw)
    jobs = sum(g.params.shape[0] for g in case.groups)
    tally.compare("av1_intra_wave", f"wave-heavy synthetic, {jobs} jobs",
                  got[:-1], ref[:-1], exact=True)
    tally.compare("av1_intra_wave", "wave-heavy synthetic, lockstep",
                  got[:-1], lock[:-1], exact=True)
    # intra block copies among intra jobs, at each subsampling's
    # half-sample flags
    for (ssx, ssy), bd in AV1_IBC_CASES:
        case = av1_cases.ibc_waves(seed=SEED + bd, ssx=ssx, ssy=ssy, bd=bd,
                                   device=DEV)
        got, ref, lock = (case.buf.clone() for _ in range(3))
        av1_fast.intra_waves(got, case.groups, case.rows, **case.kw)
        av1_fast.intra_waves_by_picture_plain(ref, case.groups, case.rows,
                                              **case.kw)
        starts = case.rows[:, :, 0].T.tolist()
        counts = (case.rows[:, :, -1] - case.rows[:, :, 0]).T.tolist()
        for st, cn in zip(starts, counts):
            av1_fast.intra_wave_plain(lock, case.groups, st, cn, **case.kw)
        what = f"ibc synthetic ss=({ssx},{ssy}) {bd}-bit"
        tally.compare("av1_intra_wave", what, got[:-1], ref[:-1],
                      exact=True)
        tally.compare("av1_intra_wave", f"{what}, lockstep", got[:-1],
                      lock[:-1], exact=True)


def check_av1_streams(streams):
    """Every stream decoded on the card (decode_intra_frame's steps after
    the parse, in-loop filters included): its planes hash to the manifest
    (the JAX host engine)."""
    for name, e in streams.items():
        planes = av1_decode_parsed(e, DEV)
        assert all(p.device.type == DEV for p in planes.values()), name
        ok = av1_hashes(planes) == e["sha256"]
        log(f"check av1 stream {name:22s} {e['width']}x{e['height']} "
            f"{e['bit_depth']}-bit planes vs manifest: "
            f"{'equal' if ok else 'DIFFERENT'}")
        assert ok, f"{name}: planes differ from the manifest"


def av1_photo_plan(streams):
    """The plan of a 48-tile AVIF photo (PHOTO_GRID, tile i holding stream
    i mod 4), as the grid path builds it, from the streams' cached parses:
    the AV1 kernels' checks and rows run at this plan's shapes."""
    rows, cols = PHOTO_GRID
    return av1_recon.build_plan([av1_parse(streams[PHOTO_TILES[i % 4]])[2]
                                 for i in range(rows * cols)], DEV)


def check_av1_photo(blob, streams, pictures, tiles=PHOTO_TILES,
                    what="av1 photo", profile=False,
                    grid_shape=AV1_PHOTO_GRID, size=AV1_PHOTO):
    """An AVIF photo through HeifContext: its launches and the wall
    time of each span of the decode path (core/trace.py), read around the
    decode to interleaved RGB, and with ``profile`` the card's kernel and
    copy time over that wall (torch.profiler around the same decode); the
    YCbCr planes that decode hands to the output conversion against the
    single tiles' decodes on the CPU placed where the grid puts them, and
    its RGB against the plain conversion of those planes.  (The photo's
    Python parse takes about a minute, so one decode serves all of it.)
    ``pictures``: the plan's or the tiles' count; ``grid_shape`` and
    ``size`` as for av1_photo_file.  Returns (launches, the decode's times
    by part, RGB)."""
    seen = []
    real_convert = context_mod.convert_image
    out = {}

    def convert(img, *args, **kw):
        seen.append(img)
        return real_convert(img, *args, **kw)

    def decode():
        with launch_counts() as launches, trace.collect() as spans:
            t0 = time.perf_counter()
            ctx = HeifContext.read_from_bytes(blob)
            file_ms = ms_since(t0)
            rgb = ctx.decode_image(None, Colorspace.RGB,
                                   Chroma.InterleavedRGB)
            first_ms = ms_since(t0)
        out.update(launches=launches, rgb=rgb, parts={
            "total_ms": first_ms, "file_parse_ms": file_ms,
            "spans": spans})
    context_mod.convert_image = convert
    try:
        # one session only: a second would cost another minute's decode
        dev = device_ms(decode, attempts=1) if profile else decode()
    finally:
        context_mod.convert_image = real_convert
    launches, rgb, parts = out["launches"], out["rgb"], out["parts"]
    spans = parts["spans"]
    if profile:
        if dev is None:
            dev = "not measured (the profiler recorded no device time)"
        else:
            dev["kernel_share"] = dev["kernels_ms"] / parts["total_ms"]
            dev["busy_share"] = (dev["kernels_ms"] + dev["copies_ms"]) / \
                parts["total_ms"]
        parts["device"] = dev
        parts["mp_per_s"] = size[0] * size[1] / 1e3 / parts["total_ms"]
    log(f"{what} launches {launches} in {parts['total_ms']:.1f} ms, by part "
        f"{json.dumps(parts)}")
    grain = any(n.startswith("grain") for n in tiles)
    for name in ("av1.parse", "av1.plan", "av1.plan_host", "av1.plan_copies",
                 "av1.stage_a", "av1.stage_b", "av1.deblock", "av1.cdef",
                 "grid.compose") + (("av1.grain",) if grain else ("av1.lr",)):
        assert name in spans, f"the photo's decode ran no {name} span"
    assert spans["av1.parse"]["count"] == pictures, "not one parse a tile"
    if grain:
        assert spans["av1.grain"]["count"] == pictures, \
            "not one grain pass a tile"
    assert launches["av1_dequant_itx"] == 1, \
        "av1_dequant_itx: not one launch per plan"
    assert launches["av1_intra_wave"] == 1, \
        "av1_intra_wave: not one launch per plan"
    assert launches["planes_ycbcr8_to_rgb"] == 1
    assert launches["strided_extract_paste"] == 0
    assert launches["tile_yuv_to_rgb"] == 0
    assert launches["hevc_dequant_itx"] == launches["hevc_intra_wave"] == 0
    inter = rgb.plane(Channel.Interleaved)
    assert (rgb.width, rgb.height) == size and inter.dtype == torch.uint8 \
        and tuple(inter.shape) == (size[1], size[0] * 3) \
        and inter.device.type == DEV

    img, = seen
    assert (img.width, img.height, img.colorspace, img.chroma) == \
        (*size, Colorspace.YCbCr, Chroma.C420)
    singles = {}
    for n in tiles:
        planes = av1_decode_parsed(streams[n], "cpu")
        assert av1_hashes(planes) == streams[n]["sha256"], n
        singles[n] = planes
    rows, cols = grid_shape
    n_diff = 0
    for i in range(rows * cols):
        ty, tx = divmod(i, cols)
        for ch, key, sub in ((Channel.Y, "Y", 1), (Channel.Cb, "U", 2),
                             (Channel.Cr, "V", 2)):
            t = 512 // sub
            y0, x0 = ty * t, tx * t
            got = img.plane(ch)[y0:y0 + t, x0:x0 + t].cpu()
            h, w = got.shape
            ref = singles[tiles[i % 4]][key][:h, :w]
            n_diff += int((got.to(torch.int32) != ref).sum())
    log(f"check {what} YCbCr (card) vs the single tiles' CPU decodes "
        f"placed: differing {n_diff}")
    assert n_diff == 0, "the grid's planes differ from the single tiles"
    try:
        YCbCrToRGB.USE_KERNEL = False        # the plain path on the card
        plain = convert_image(img, Colorspace.RGB, Chroma.InterleavedRGB)
    finally:
        YCbCrToRGB.USE_KERNEL = None
    assert torch.equal(plain.plane(Channel.Interleaved), inter), \
        "the photo's RGB differs from the plain conversion"
    return launches, parts, rgb


def check_av01_files(streams):
    """Single-item av01 files (an 8-bit tile, the 10-bit tile, the
    non-8-aligned one and the intrabc screenshot, its launch counts read
    around its card decode) through the context on the card and on the
    CPU, YCbCr against the manifest, and the 8-bit one's RGB.  Returns
    the files and the screenshot's launches."""
    blobs = {}
    shot = {}
    for name in ("tile512_s0", "tile512_10bit", "tile508x500", SCREENSHOT):
        e = streams[name]
        blobs[name] = av01_file(e)
        if name == SCREENSHOT:
            with launch_counts() as shot:
                img = HeifContext.read_from_bytes(blobs[name]) \
                    .decode_image(None)
            log(f"av1 screenshot launches {shot}")
            assert shot["av1_dequant_itx"] == shot["av1_intra_wave"] == 1, \
                "the screenshot: not one launch of each AV1 kernel"
            same_image(f"av01 {name}", img, HeifContext.read_from_bytes(
                blobs[name], device="cpu").decode_image(None))
        else:
            img = decode_both(f"av01 {name}", blobs[name])
        ok = av1_hashes({k: img.plane(c).to(torch.int32) for k, c in
                         (("Y", Channel.Y), ("U", Channel.Cb),
                          ("V", Channel.Cr))}) == e["sha256"]
        assert ok, f"{name}: the file's planes differ from the manifest"
        log(f"check file av01 {name} planes vs manifest: equal")
        if name == "tile512_s0":
            decode_both(f"av01 {name} RGB", blobs[name], Colorspace.RGB,
                        Chroma.C444)
    return blobs, shot


def av1_itx_work(plan):
    """(bytes, int32 operations) of av1_dequant_itx on a plan's data.
    Bytes: each job's flags word, the rest of its scalars and its
    min(th, 32) x min(tw, 32) coefficients where it has a residual (a
    job without one reads nothing more), and its whole (sq x sq) output.
    Operations: per sample of a residual block a butterfly stage of each
    1-D transform (log2 of its length)."""
    nbytes = nops = 0
    for g in plan.groups:
        tw = g.txp[:, av1_fast.TXP_TW].long()
        th = g.txp[:, av1_fast.TXP_TH].long()
        on = (g.txp[:, av1_fast.TXP_FLAGS] & 1).long()
        coeffs = int((on * tw.clamp(max=32) * th.clamp(max=32)).sum())
        nbytes += g.n * 4 + int(on.sum()) * 5 * 4 + coeffs * 4 \
            + g.n * g.sq * g.sq * 4
        nops += int((on * tw * th).double().mul(
            torch.log2(tw.double()) + torch.log2(th.double())).sum()) \
            * AV1_OPS_PER_STAGE
    return nbytes, nops


# kernel's non-directional modes: DC, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH
AV1_NON_DIRECTIONAL = (0, 9, 10, 11, 12)


def av1_wave_work(plan):
    """(bytes, int32 operations) of av1_intra_wave on a plan's data
    (palette jobs are a scatter before the launch).  Bytes, per job: the
    scalars its kind reads; the gather index entries its mode uses (a
    directional or filter-intra job all of its table, the others wv
    above, hv left and, for PAETH, the corner); the distinct samples
    those entries point at (sentinels read nothing); hh x ww residuals
    read and samples stored; a CfL job's luma box (its wv x hv clipped
    to the frame, 4, 2 or 1 samples each); and the plan's wave-row table
    once; an intrabc job's scalars, source rectangle, residuals and
    stores.  Operations: AV1_OPS_PER_SAMPLE per predicted sample."""
    nm = 4 if plan.ssx and plan.ssy else (2 if plan.ssx else 1)
    nbytes = plan.wave_rows.numel() * 4
    nops = 0
    for g in plan.groups:
        if g.kind == av1_recon.KIND_PAL or not g.n:
            continue
        p = g.params.long()

        def col(name):
            return p[:, av1_fast.P[name]]
        la = g.above.shape[1]
        r = torch.arange(la, device=p.device)[None, :]
        samples = int((col("hh") * col("ww")).sum())
        if g.kind == av1_recon.KIND_IBC:
            # its scalars (dst, pw, hh, ww, source, flags), the source
            # rectangle with its half-sample neighbours, residuals, stores
            fy, fx = (col("ibc_half") >> 1) & 1, col("ibc_half") & 1
            src = int(((col("hh") + fy) * (col("ww") + fx)).sum())
            nbytes += 4 * (6 * g.n + src + 2 * samples)
            nops += samples * AV1_OPS_PER_SAMPLE
            continue
        if g.kind == av1_recon.KIND_FI:
            words = 5 * g.n                  # fi_mode, dst, pw, hh, ww
            use_a = use_l = torch.ones((g.n, la), dtype=torch.bool,
                                       device=p.device)
            use_c = torch.ones(g.n, dtype=torch.bool, device=p.device)
            cfl = 0
        else:
            mode = col("mode")
            directional = ~torch.isin(mode, torch.tensor(
                AV1_NON_DIRECTIONAL, device=p.device))
            edge = directional.long() * int(plan.edge_filter)
            is_cfl = col("is_cfl")
            words = int((20 + 5 * edge + is_cfl).sum())
            use_a = directional[:, None] | (r < col("wv")[:, None])
            use_l = directional[:, None] | (r < col("hv")[:, None])
            use_c = directional | (mode == 12)
            cfl = int((is_cfl * torch.minimum(col("wv"), col("bw")) *
                       torch.minimum(col("hv"), col("bh"))).sum()) * nm
        idx = torch.cat([torch.where(use_a, g.above.long(), -4),
                         torch.where(use_l, g.left.long(), -4),
                         torch.where(use_c, g.corner.long(), -4)[:, None]],
                        1).sort(1).values
        distinct = int(((idx[:, 1:] != idx[:, :-1]) & (idx[:, 1:] >= 0))
                       .sum() + (idx[:, 0] >= 0).sum())
        entries = int(use_a.sum() + use_l.sum() + use_c.sum())
        nbytes += 4 * (words + entries + distinct + 2 * samples + cfl)
        nops += samples * AV1_OPS_PER_SAMPLE
    return nbytes, nops


def ptxas_resources(kernel):
    """{"regs", "smem", "stack"} (bytes for the last two) that ptxas
    reported in this run's build for the entry function whose name holds
    ``kernel``; each None where the library was not built in this run."""
    return kernel_timing.ptxas_resources(_build.LIBRARY.build_log, kernel)


def chain_bound(b, chain_ms):
    """A wave kernel's bounds: ``b`` (bounds()) with its in-kernel chain,
    the largest of the three binding ("operations" for the chain)."""
    out = dict(b, chain_bound_ms=chain_ms)
    if chain_ms > b["bound_ms"]:
        out.update(bound_ms=chain_ms, bound_by="operations")
    return out


def av1_wave_chain_ms(timer, plan):
    """av1_intra_wave's in-kernel chain bound on a plan: n_waves steps of
    av1_wave_probe (one block a picture, as the kernel), from a launch of
    10 x n_waves steps, so the launch itself is amortised."""
    steps = 10 * plan.n_waves
    ms = timer([lambda: av1_fast.wave_probe(plan.t, steps, DEV)], n=5)
    return ms / steps * plan.n_waves


def av1_screenshot_stage_b(timer, streams):
    """av1_intra_wave on the intrabc screenshot's plan (one picture, one
    block of the kernel): its waves, jobs by kind, bytes and operations
    (av1_wave_work) with their bounds, and device ms."""
    plan = av1_recon.build_plan([av1_parse(streams[SCREENSHOT])[2]], DEV)
    res = av1_recon.residuals(plan)
    buf0, waves = av1_recon.palette_and_waves(plan, res)
    bufs = [buf0.clone() for _ in range(2)]
    nbytes, nops = av1_wave_work(plan)
    out = {"waves": plan.n_waves,
           "groups": {f"{av1_recon.KIND_NAMES[g.kind]}{g.sq}": g.n
                      for g in plan.groups},
           "bytes": nbytes, "ops": nops, **bounds(nbytes, nops),
           "av1_intra_wave_ms": timer([lambda b=b: av1_fast.intra_waves(
               b, waves, plan.wave_rows, **av1_recon.wave_args(plan))
               for b in bufs], n=6),
           "av1_dequant_itx_ms": timer([lambda: av1_recon.residuals(plan)])}
    log(f"av1 screenshot stage B {json.dumps(out)}")
    return out


def av1_kernel_rows(timer, tally, plan, launches, by_path, screenshot):
    """The AV1 kernels' rows of the {"kernels": ...} line, at the AVIF
    photo's shapes: its plan's stage A and stage B; beside them each
    kernel's launches on each AV1 path and stage B on the screenshot."""
    res = av1_recon.residuals(plan)
    rows = {}
    nbytes, nops = av1_itx_work(plan)
    b = bounds(nbytes, nops)
    rows["av1_dequant_itx"] = {
        "name": "av1_dequant_itx", "route": "cuda", "source": AV1_SOURCE,
        "replaces": f"{AV1_JNP}:548",
        "launches": launches["av1_dequant_itx"],
        "launches_by_path": {k: v["av1_dequant_itx"]
                             for k, v in by_path.items()},
        "max_abs_err": tally.max_abs_err["av1_dequant_itx"],
        "ms": timer([lambda: av1_recon.residuals(plan)]),
        "plain_ms": timer([lambda: av1_plain_residuals(plan)], n=2),
        **b, "library_ms": None,
        "library_note": "no one PyTorch call computes the staged AV1 "
                        "inverse transforms (integer butterflies with "
                        "their intermediate roundings; no integer matmul "
                        "on CUDA)",
        "checks": tally.checks["av1_dequant_itx"],
        "differing_pixels": tally.differing["av1_dequant_itx"],
        "bytes": nbytes, "ops": nops,
        "groups": {f"{av1_recon.KIND_NAMES[g.kind]}{g.sq}": g.n
                   for g in plan.groups},
        **ptxas_resources("av1_dequant_itx_kernel")}
    nbytes, nops = av1_wave_work(plan)
    b = bounds(nbytes, nops)
    chain_ms = av1_wave_chain_ms(timer, plan)
    buf0, waves = av1_recon.palette_and_waves(plan, res)
    bufs = [buf0.clone() for _ in range(2)]
    rows["av1_intra_wave"] = {
        "name": "av1_intra_wave", "route": "cuda", "source": AV1_SOURCE,
        "replaces": f"{AV1_JNP}:885",
        # intra block copy, which the jnp program lacks: the host engine's
        "also_replaces": ["libheif_tpu/codecs/av1/tile.py:1826"],
        "launches": launches["av1_intra_wave"],
        "launches_by_path": {k: v["av1_intra_wave"]
                             for k, v in by_path.items()},
        "screenshot": screenshot,
        "max_abs_err": tally.max_abs_err["av1_intra_wave"],
        "ms": timer([lambda b=b: av1_fast.intra_waves(
            b, waves, plan.wave_rows, **av1_recon.wave_args(plan))
            for b in bufs], n=6),
        "predict_waves_ms": timer([lambda: av1_recon.predict_waves(
            plan, res)], n=4),
        "plain_ms": AV1_PLAIN_WAVES_MS.get("photo"),
        # the largest of the in-kernel chain (waves x one probe step),
        # the bytes and the int32 operations
        **chain_bound(b, chain_ms),
        "library_ms": None,
        "library_note": "no one PyTorch call computes AV1 intra "
                        "prediction over dependency waves",
        "waves": plan.n_waves,
        **ptxas_resources("av1_intra_wave_kernel"),
        "checks": tally.checks["av1_intra_wave"],
        "differing_pixels": tally.differing["av1_intra_wave"],
        "bytes": nbytes, "ops": nops}
    log(f"av1 kernels {json.dumps(rows)}")
    return rows



# The JPEG phase: the committed streams of libheif_tpu_torch/testdata/jpeg
# (PIL's libjpeg and the JAX package's encoder, with the plane hashes of
# the JAX decode_jpeg), the reconstruction kernel against its plain
# version, a phone photo's JPEG (an 8x6 grid of 512x512 jpeg tiles under a
# 4032x3024 output), and the jpeg, mini, tili and mski items.

JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "libheif_tpu_torch", "testdata", "jpeg")
ITEMS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "libheif_tpu_torch", "testdata", "items")
JPEG_SOURCE = "libheif_tpu_torch/codecs/jpeg/csrc/jpeg_kernels.cu"
JPEG_JNP = "libheif_tpu/codecs/jpeg/decoder.py"
JPEG_PARSED = {}         # stream name -> JpegFrame, parsed once
JPEG_PLAIN_MS = {}
# int32 operations per sample of jpeg_dequant_idct: the dequantising
# product, two 1-D passes (per output ~1.5 products and ~4 adds, shifts),
# the level shift and the clip
JPEG_OPS_PER_SAMPLE = 16
TILI = 4096              # the unci tili: 8x8 tiles of 512x512


def jpeg_streams():
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        return {e["name"]: e for e in json.load(f)["streams"]}


def jpeg_data(e):
    with open(os.path.join(JPEG_DIR, e["file"]), "rb") as f:
        return f.read()


def jpeg_frame(e):
    if e["name"] not in JPEG_PARSED:
        JPEG_PARSED[e["name"]] = jpeg_decoder.parse_jpeg(jpeg_data(e))
    return JPEG_PARSED[e["name"]]


def u8_hashes(img):
    return {ch: hashlib.sha256(img.np_plane(ch).tobytes()).hexdigest()
            for ch in img.channels()}


def jpeg_jobs(frames, shared=False):
    """Every component of ``frames`` as a job on the card writing its
    whole (blocks_h*8, blocks_w*8) plane: (coefficients, tables, jobs).
    With ``shared`` the planes are views of one plane with an odd pitch,
    side by side at odd offsets, each cut by 5 rows and 3 columns inside
    its last blocks (the kernel's byte path)."""
    coeffs, quant, jobs = [], [], []
    first = 0
    comps = [c for f in frames for c in f.components]
    if shared:
        plane = torch.zeros((max(c.blocks_h for c in comps) * 8 + 1,
                             sum(c.blocks_w * 8 + 1 for c in comps) + 3),
                            dtype=torch.uint8, device=DEV)
        x = 1
    for frame in frames:
        rows = {}
        for c in frame.components:
            if c.tq not in rows:
                rows[c.tq] = len(quant)
                quant.append(frame.quant[c.tq])
            if shared:
                h, w = c.blocks_h * 8 - 5, c.blocks_w * 8 - 3
                out = plane[1:1 + h, x:x + w]
                x += c.blocks_w * 8 + 1
            else:
                out = torch.empty((c.blocks_h * 8, c.blocks_w * 8),
                                  dtype=torch.uint8, device=DEV)
            jobs.append(jpeg_fast.Job(first, c.blocks_w, c.blocks_h,
                                      rows[c.tq], out))
            coeffs.append(c.coeffs)
            first += c.blocks_w * c.blocks_h
    return (torch.from_numpy(np.concatenate(coeffs)).to(DEV),
            torch.from_numpy(np.stack(quant).astype(np.int32)).to(DEV), jobs)


def jpeg_plain(coeffs, quant, jobs):
    return [jpeg_idct.recon_plain(coeffs[j.first:j.first + j.blocks_w *
                                         j.blocks_h], quant[j.qidx],
                                  j.blocks_h, j.blocks_w) for j in jobs]


def check_jpeg_batch(tally, what, coeffs, quant, jobs):
    """jpeg_dequant_idct (one launch for every job) against recon_plain on
    the card (its device time kept in JPEG_PLAIN_MS)."""
    before = jpeg_fast.JPEG_DEQUANT_IDCT.launches
    jpeg_fast.dequant_idct(coeffs, quant, jobs)
    assert jpeg_fast.JPEG_DEQUANT_IDCT.launches - before == 1
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(True), torch.cuda.Event(True)
    s.record()
    ref = jpeg_plain(coeffs, quant, jobs)
    e.record()
    e.synchronize()
    JPEG_PLAIN_MS[what] = s.elapsed_time(e)
    got = torch.cat([j.out.reshape(-1) for j in jobs])
    ref = [r[:j.out.shape[0], :j.out.shape[1]] for r, j in zip(ref, jobs)]
    tally.compare("jpeg_dequant_idct", f"{what}, {len(jobs)} planes",
                  got, torch.cat([r.reshape(-1) for r in ref]), exact=True)


def check_jpeg_kernel(tally, streams):
    """jpeg_dequant_idct against recon_plain on the card: every committed
    stream alone, all the small streams in one batch (different tables,
    sizes and sampling), random int16 coefficients with 16-bit tables
    (int32 wraparound) and the photo's 48 tiles."""
    good = [e for e in streams.values() if "sha256" in e]
    for e in good:
        check_jpeg_batch(tally, e["name"], *jpeg_jobs([jpeg_frame(e)]))
    small = [jpeg_frame(e) for e in good if not e["name"].startswith("tile")]
    check_jpeg_batch(tally, f"batch of {len(small)} streams",
                     *jpeg_jobs(small))
    check_jpeg_batch(tally, f"batch of {len(small)} streams, odd offsets "
                     "and crops", *jpeg_jobs(small, shared=True))
    rng = np.random.default_rng(SEED + 8)
    for bh, bw in ((37, 53), (64, 64), (1, 1)):
        coeffs = torch.from_numpy(rng.integers(
            -32768, 32768, (bh * bw, 64), dtype=np.int16)).to(DEV)
        quant = torch.from_numpy(rng.integers(1, 65536, (2, 64))
                                 .astype(np.int32)).to(DEV)
        out = torch.empty((bh * 8, bw * 8), dtype=torch.uint8, device=DEV)
        check_jpeg_batch(tally, f"wrap {bh}x{bw} blocks, 16-bit tables",
                         coeffs, quant, [jpeg_fast.Job(0, bw, bh, 1, out)])
    rows, cols = PHOTO_GRID
    frames = [jpeg_frame(streams[PHOTO_TILES[i % 4]])
              for i in range(rows * cols)]
    check_jpeg_batch(tally, "photo", *jpeg_jobs(frames))
    return frames


def check_jpeg_streams(streams):
    """Every stream decoded on the card (decode_jpeg): its planes hash to
    the manifest (the JAX decode, libjpeg's where PIL gives them raw);
    the progressive stream raises Unsupported."""
    for name, e in streams.items():
        data = jpeg_data(e)
        if "sha256" not in e:
            try:
                jpeg_decoder.decode_jpeg(data)
            except HeifError as err:
                log(f"check jpeg stream {name:14s} raises: {err}")
                continue
            raise AssertionError(f"{name}: decoded, expected a refusal")
        img = jpeg_decoder.decode_jpeg(data)
        assert all(img.plane(c).device.type == DEV for c in img.channels())
        ok = u8_hashes(img) == e["sha256"]
        assert len(img.warnings) == e["warnings"], name
        log(f"check jpeg stream {name:14s} {e['width']}x{e['height']} "
            f"planes vs manifest: {'equal' if ok else 'DIFFERENT'}")
        assert ok, f"{name}: planes differ from the manifest"


def add_jpeg(f, data, w, h, config=b"", hidden=True):
    """A jpeg item holding ``data`` with its ispe, and a jpgC of
    ``config`` where given."""
    item = f.add_new_item("jpeg").item_id
    f.append_item_data(item, data)
    f.add_property(item, Box_ispe(w, h), False)
    if config:
        f.add_property(item, Box_jpgC(config), True)
    f.get_infe(item).hidden = hidden
    return item


def jpeg_photo_file(streams):
    """The JPEG phone photo: 48 hidden jpeg items (item i holds stream i
    mod 4) in a 6x8 grid with a 4032x3024 output."""
    f = new_file()
    rows, cols = PHOTO_GRID
    ids = []
    for i in range(rows * cols):
        e = streams[PHOTO_TILES[i % 4]]
        ids.append(add_jpeg(f, jpeg_data(e), e["width"], e["height"]))
    grid = f.add_new_item("grid").item_id
    f.append_item_data(grid, ImageGrid(rows, cols, *PHOTO).write(), 1)
    f.add_property(grid, Box_ispe(*PHOTO), False)
    f.add_reference("dimg", grid, ids)
    f.set_primary_item(grid)
    return f.write()


def check_jpeg_photo(blob, streams):
    """The JPEG photo through HeifContext to interleaved RGB: its launches
    and the wall time of each span of the decode path, read around it;
    the YCbCr planes handed to the output conversion against the single
    tiles' CPU decodes placed where the grid puts them, and the RGB
    against the plain conversion of those planes.  Returns (launches,
    times by part, RGB)."""
    seen = []
    real_convert = context_mod.convert_image

    def convert(img, *args, **kw):
        seen.append(img)
        return real_convert(img, *args, **kw)
    context_mod.convert_image = convert
    try:
        with launch_counts() as launches, trace.collect() as spans:
            t0 = time.perf_counter()
            ctx = HeifContext.read_from_bytes(blob)
            file_ms = ms_since(t0)
            rgb = ctx.decode_image(None, Colorspace.RGB,
                                   Chroma.InterleavedRGB)
            first_ms = ms_since(t0)
    finally:
        context_mod.convert_image = real_convert
    parts = {"total_ms": first_ms, "file_parse_ms": file_ms, "spans": spans}
    log(f"jpeg photo launches {launches} in {first_ms:.1f} ms, by part "
        f"{json.dumps(parts)}")
    n = PHOTO_GRID[0] * PHOTO_GRID[1]
    assert spans["jpeg.parse"]["count"] == spans["jpeg.scan"]["count"] == n
    assert spans["jpeg.recon"]["count"] == spans["grid.compose"]["count"] \
        == 1
    recon = {p: spans[f"jpeg.recon.{p}"]["ms"]
             for p in ("gather", "copy", "launch")}
    log(f"jpeg photo recon by part (ms): {json.dumps(recon)} of "
        f"{spans['jpeg.recon']['ms']}")
    assert launches["jpeg_dequant_idct"] == 1, \
        "jpeg_dequant_idct: not one launch for the photo"
    assert launches["planes_ycbcr8_to_rgb"] == 1
    assert launches["strided_extract_paste"] == 0
    assert sum(launches[k] for k in ALL_KERNELS) == 2, launches
    inter = rgb.plane(Channel.Interleaved)
    assert (rgb.width, rgb.height) == PHOTO and inter.dtype == torch.uint8 \
        and tuple(inter.shape) == (PHOTO[1], PHOTO[0] * 3) \
        and inter.device.type == DEV
    img, = seen
    assert (img.width, img.height, img.colorspace, img.chroma) == \
        (*PHOTO, Colorspace.YCbCr, Chroma.C420)
    singles = {n_: jpeg_decoder.decode_jpeg(jpeg_data(streams[n_]), "cpu")
               for n_ in PHOTO_TILES}
    for n_, s_img in singles.items():
        assert u8_hashes(s_img) == streams[n_]["sha256"], n_
    rows, cols = PHOTO_GRID
    n_diff = 0
    for i in range(rows * cols):
        ty, tx = divmod(i, cols)
        for ch, sub in ((Channel.Y, 1), (Channel.Cb, 2), (Channel.Cr, 2)):
            t = 512 // sub
            got = img.plane(ch)[ty * t:ty * t + t, tx * t:tx * t + t].cpu()
            h, w = got.shape
            ref = singles[PHOTO_TILES[i % 4]].plane(ch)[:h, :w]
            n_diff += int((got != ref).sum())
    log(f"check jpeg photo YCbCr (card) vs the single tiles' CPU decodes "
        f"placed: differing {n_diff}")
    assert n_diff == 0, "the grid's planes differ from the single tiles"
    try:
        YCbCrToRGB.USE_KERNEL = False        # the plain path on the card
        plain = convert_image(img, Colorspace.RGB, Chroma.InterleavedRGB)
    finally:
        YCbCrToRGB.USE_KERNEL = None
    assert torch.equal(plain.plane(Channel.Interleaved), inter), \
        "the photo's RGB differs from the plain conversion"
    return launches, parts, rgb


def jpeg_file(e, split=False):
    """A single-item jpeg file of stream ``e``; with ``split`` its SOI and
    tables (everything before SOS) in a jpgC."""
    data = jpeg_data(e)
    cut = data.index(b"\xff\xda") if split else 0
    f = new_file()
    f.set_primary_item(add_jpeg(f, data[cut:], e["width"], e["height"],
                                data[:cut], hidden=False))
    return f.write()


def unci_tili_file(data):
    """A 4096x4096 tili of 64 unci 512x512 4:2:0 tiles (tile i holds tile i
    of the flagship payload), its unci boxes in tilC."""
    tw = TILI // TILES
    size = tw * tw * 3 // 2
    return tili_file([data[i * size:(i + 1) * size]
                      for i in range(TILES * TILES)], TILI, TILI, tw, tw,
                     "unci", list(ycc420(tw, tw, (1, 1))))


def hvc1_tili_file(streams):
    """A 1024x1024 tili of the four committed hvc1 512x512 tiles, each
    tile carrying its SPS and PPS in band, the first one's hvcC in
    tilC."""
    tiles = []
    for n in PHOTO_TILES:
        sps, pps, slices = hevc_nals(streams[n])
        tiles.append(b"".join(len(x).to_bytes(4, "big") + x
                              for x in (sps, pps, *slices)))
    sps, pps, _ = hevc_nals(streams[PHOTO_TILES[0]])
    cfg = Box_hvcC()
    cfg.general_profile_idc = 1
    cfg.add_nal(sps)
    cfg.add_nal(pps)
    return tili_file(tiles, 1024, 1024, 512, 512, "hvc1", [cfg])


def tili_file(tiles, w, h, tw, th, fourcc_, props):
    """A tili item: the offset table (40-bit offsets, 24-bit sizes), then
    the tiles in grid order; ``props`` go in tilC."""
    params = TiledImageParameters(image_width=w, image_height=h,
                                  tile_width=tw, tile_height=th,
                                  compression_format=fourcc_)
    hdr = TiledHeader(params)
    pos = hdr.table_size()
    for i, t in enumerate(tiles):
        hdr.set_tile_range(i % params.tiles_h(), i // params.tiles_h(), pos,
                           len(t))
        pos += len(t)
    tilC = Box_tilC(params)
    tilC.children.extend(props)
    f = new_file()
    item = f.add_new_item("tili").item_id
    f.append_item_data(item, hdr.serialize() + b"".join(tiles))
    f.add_property(item, tilC, True)
    f.add_property(item, Box_ispe(w, h), False)
    f.set_primary_item(item)
    return f.write()


def mski_file(bits):
    """A 333x77 mask of random samples (16-bit ones big-endian)."""
    rng = np.random.default_rng(SEED + bits)
    vals = rng.integers(0, 1 << bits, (77, 333),
                        dtype=np.uint8 if bits == 8 else np.uint16)
    f = new_file()
    item = f.add_new_item("mski").item_id
    f.append_item_data(item, vals.astype(">u2" if bits == 16 else np.uint8)
                       .tobytes())
    f.add_property(item, Box_ispe(333, 77), False)
    f.add_property(item, Box_mskC(bits), True)
    f.set_primary_item(item)
    return f.write(), vals


def check_jpeg_files(streams, hevc, data):
    """jpeg (with and without jpgC), mini, tili and mski files through
    the context, each on the card and on the CPU with 0 samples differing,
    and against the manifests or the generators."""
    e = streams[PHOTO_TILES[0]]
    for split in (False, True):
        what = f"jpeg {e['name']}" + (" jpgC" if split else "")
        img = decode_both(what, jpeg_file(e, split))
        assert u8_hashes(img) == e["sha256"], what
        log(f"check file {what} planes vs manifest: equal")
    decode_both("jpeg RGB", jpeg_file(e), Colorspace.RGB, Chroma.C444)

    with open(os.path.join(ITEMS_DIR, "manifest.json")) as f:
        for m in json.load(f)["files"]:
            with open(os.path.join(ITEMS_DIR, m["file"]), "rb") as g:
                blob = g.read()
            img = decode_both(f"mini {m['name']}", blob)
            assert img.channels() == m["channels"]
            assert u8_hashes(img) == m["sha256"], m["name"]
            log(f"check file mini {m['name']} planes vs manifest: equal")

    blob = unci_tili_file(data)
    tw = TILI // TILES
    cards = []
    with launch_counts() as launches:
        ctx = HeifContext.read_from_bytes(blob)
        for i in range(TILES * TILES):
            cards.append(ctx.decode_tile(ctx.primary_item_id, i % TILES,
                                         i // TILES))
    log(f"tili unci launches {launches}")
    assert launches["strided_extract_paste"] == TILES * TILES, \
        "strided_extract_paste: not one launch per tili tile"
    assert launches["assemble_tile_buffers"] == 0
    cpu = HeifContext.read_from_bytes(blob, device="cpu")
    full = np_planes(data, TILES, tw, tw)
    for i, img in enumerate(cards):
        same_image(f"tili unci tile {i}", img, cpu.decode_tile(
            cpu.primary_item_id, i % TILES, i // TILES))
        ty, tx = divmod(i, TILES)
        for ch, plane, t in zip((Channel.Y, Channel.Cb, Channel.Cr), full,
                                (tw, tw // 2, tw // 2)):
            want = plane[ty * t:ty * t + t, tx * t:tx * t + t]
            assert np.array_equal(img.np_plane(ch), want), (i, ch)
    log(f"check file tili unci {TILI}x{TILI}: {TILES * TILES} tiles equal "
        "to the payload")

    blob = hvc1_tili_file(hevc)
    for i, n in enumerate(PHOTO_TILES):
        img = decode_both(f"tili hvc1 tile {i}", blob, tile=(i % 2, i // 2))
        assert int32_hashes([img.plane(c).to(torch.int32) for c in
                             (Channel.Y, Channel.Cb, Channel.Cr)]) == \
            hevc[n]["sha256"], n

    for bits in (8, 16):
        blob, vals = mski_file(bits)
        img = decode_both(f"mski {bits}-bit", blob)
        got = img.plane(Channel.Y).cpu()
        if bits == 16:
            got = got.view(torch.int16)
        assert np.array_equal(got.numpy().view(vals.dtype), vals), bits


def time_jpeg_photo(blob, ref, first):
    """The photo's decode through the entry point REPEATS times in fresh
    contexts, the last under torch.profiler: totals beside the first
    decode's (``first``, the launch-count decode split by part), each RGB
    equal to the first's, and the card's kernel and copy time over that
    decode's total."""
    totals = [first["total_ms"]]
    out = {}

    def decode():
        t0 = time.perf_counter()
        out["rgb"] = HeifContext.read_from_bytes(blob).decode_image(
            None, Colorspace.RGB, Chroma.InterleavedRGB)
        out["ms"] = ms_since(t0)
    for _ in range(REPEATS - 1):
        decode()
        totals.append(out["ms"])
        assert torch.equal(out["rgb"].plane(Channel.Interleaved),
                           ref.plane(Channel.Interleaved))
    dev = device_ms(decode)
    totals.append(out["ms"])
    assert torch.equal(out["rgb"].plane(Channel.Interleaved),
                       ref.plane(Channel.Interleaved))
    t = {"total_ms": totals,
         "mp_per_s": [PHOTO[0] * PHOTO[1] / 1e3 / ms for ms in totals],
         "by_part": first}
    if dev is None:
        dev = "not measured (the profiler recorded no device time)"
    else:
        dev["kernel_share"] = dev["kernels_ms"] / out["ms"]
        dev["busy_share"] = (dev["kernels_ms"] + dev["copies_ms"]) / out["ms"]
    t["device"] = dev
    log(f"jpeg photo {json.dumps(t)}")
    return t


def jpeg_kernel_row(timer, tally, frames, launches):
    """jpeg_dequant_idct's row of the {"kernels": ...} line at the photo's
    shapes (48 tiles, 294,912 blocks, one launch)."""
    sets = [jpeg_jobs(frames) for _ in range(2)]
    blocks = sum(j.blocks_w * j.blocks_h for j in sets[0][2])
    # coefficients read and samples written once, the quantisation tables
    # and the job table (JOB_COLS + 1 int32 a plane) once
    n_ctas = jpeg_fast.job_table(sets[0][2])[1]
    nbytes = blocks * (128 + 64) + sets[0][1].numel() * 4 + \
        len(sets[0][2]) * (jpeg_fast.JOB_COLS + 1) * 4
    nops = blocks * 64 * JPEG_OPS_PER_SAMPLE
    b = bounds(nbytes, nops)
    srcs = [torch.empty(nbytes // 2, dtype=torch.uint8, device=DEV)
            for _ in range(4)]
    dst = torch.empty_like(srcs[0])
    # the kernel alone and the call's table copy, from torch.profiler ("ms"
    # is the call: the copy, the launch and the kernel); None where the
    # profiler records no device time
    kernel_ms, table_copy_ms = kernel_timing.kernel_ms(
        torch, [lambda s=s: jpeg_fast.dequant_idct(*s) for s in sets], 20,
        "jpeg_dequant_idct")
    row = {
        "name": "jpeg_dequant_idct", "route": "cuda", "source": JPEG_SOURCE,
        "replaces": f"{JPEG_JNP}:500",
        "launches": launches["jpeg_dequant_idct"],
        "max_abs_err": tally.max_abs_err["jpeg_dequant_idct"],
        "ms": timer([lambda s=s: jpeg_fast.dequant_idct(*s) for s in sets]),
        "kernel_ms": kernel_ms, "table_copy_ms": table_copy_ms,
        "plain_ms": timer([lambda: jpeg_plain(*sets[0])], n=2),
        **b, "library_ms": None,
        "library_note": "no one PyTorch call computes the islow IDCT with "
                        "its fixed-point roundings and int32 wraparound",
        "copy_ms": timer([lambda s=s: dst.copy_(s) for s in srcs]),
        "checks": tally.checks["jpeg_dequant_idct"],
        "differing_pixels": tally.differing["jpeg_dequant_idct"],
        "bytes": nbytes, "ops": nops, "blocks": blocks, "ctas": n_ctas,
        "plain_ms_by_check": JPEG_PLAIN_MS,
        **ptxas_resources("jpeg_dequant_idct_kernel")}
    log(f"jpeg kernel {json.dumps(row)}")
    return {"jpeg_dequant_idct": row}


# -------------------------------------------------------------------- main

# ------------------------------------------------------------------ colour
# The colour phase: the six colour ops that the JAX package runs as jnp
# programs (libheif_tpu/color/ops.py), plain torch on the card, each
# through convert_image at 4096x4096 and held to the same call on the CPU;
# a 16-bit Bayer unci file through HeifContext; a chain through the
# planes_ycbcr8_to_rgb kernel; and a file with Exif, XMP, region and text
# items read through bytes and through a streaming reader.

COLOUR_SIDE = 4096
COLOUR_JNP = "libheif_tpu/color/ops.py"


def colour_planes(kind, bits, seed):
    """Random COLOUR_SIDE^2 numpy planes of ``kind`` (ycc420, ycc444,
    ycc420a, rgb, rgba, mono) and the image's colorspace and chroma."""
    n = COLOUR_SIDE
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bits <= 8 else np.uint16

    def plane(h, w):
        return rng.integers(0, 1 << bits, (h, w), dtype=dt)
    if kind.startswith("ycc"):
        c = n // 2 if kind.startswith("ycc420") else n
        planes = {Channel.Y: plane(n, n), Channel.Cb: plane(c, c),
                  Channel.Cr: plane(c, c)}
        space = (Colorspace.YCbCr,
                 Chroma.C420 if kind.startswith("ycc420") else Chroma.C444)
    elif kind.startswith("rgb"):
        planes = {ch: plane(n, n) for ch in (Channel.R, Channel.G, Channel.B)}
        space = (Colorspace.RGB, Chroma.C444)
    else:
        planes = {Channel.Y: plane(n, n)}
        space = (Colorspace.Monochrome, Chroma.Monochrome)
    if kind.endswith("a"):
        planes[Channel.Alpha] = plane(n, n)
    return planes, space


def colour_image(planes, space, bits, device):
    img = PixelImage(COLOUR_SIDE, COLOUR_SIDE, *space)
    for ch, a in planes.items():
        img.set_plane(ch, torch.from_numpy(a).to(device), bits)
    return img


def colour_compare(what, got, ref, exact):
    """A colour result on the card against the same call on the CPU:
    0 differing samples where ``exact``, else the colour contract (at
    most 1 LSB on fewer than 1% of the samples)."""
    assert (got.width, got.height, got.colorspace, got.chroma,
            got.channels()) == (ref.width, ref.height, ref.colorspace,
                                ref.chroma, ref.channels()), what
    n = total = err = 0
    for ch in ref.channels():
        assert got.plane(ch).device.type == DEV, f"{what} {ch}"
        assert got.bit_depth(ch) == ref.bit_depth(ch), f"{what} {ch}"
        a, b = got.np_plane(ch), ref.np_plane(ch)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what} {ch}"
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        n += int(np.count_nonzero(d))
        err = max(err, int(d.max(initial=0)))
        total += a.size
    log(f"check colour {what:44s} card vs CPU max_abs_err {err} "
        f"differing {n} of {total}")
    if exact:
        assert n == 0, f"{what}: the card differs from the CPU"
    else:
        assert err <= 1 and n < 0.01 * total, \
            f"{what}: beyond 1 LSB on 1% of the samples"
    return {"max_abs_err": err, "differing": n, "samples": total}


def median_ms(fn, n=REPEATS):
    """The median wall of ``n`` calls, each between two synchronises."""
    runs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        runs.append(ms_since(t0))
    return float(np.median(runs))


def launches_per_call(calls):
    """Device operations (kernels, memsets and copies) each of ``calls``
    (name -> fn) issues, from one torch.profiler session: spin kernels
    (torch.cuda._sleep) go on the stream between the calls and after the
    last, and the operations between two runs of spins in stream order
    are the call's, whatever the offset between the host's and the
    card's clocks.  The session misses the card's first operations (in
    one run, three spins and part of the first call), so a spin of ~25
    ms and 32 short ones open it.  None for every call when the profiler
    records no device event or not every boundary."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(50_000_000)
        for _ in range(32):
            torch.cuda._sleep(1000)
        for fn in calls.values():
            torch.cuda._sleep(1000)
            fn()
        torch.cuda._sleep(1000)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    cpu_names = {e.name for e in prof.events()
                 if e.device_type != DeviceType.CUDA}
    ops = [name for _, name in sorted(
        (e.time_range.start, e.name) for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.name not in cpu_names)]
    counts, n = [], None        # n: operations since the last run of spins
    for name in ops:
        if "spin_kernel" in name:
            if n:
                counts.append(n)
            n = 0
        elif n is not None:
            n += 1
    log(f"colour launches: {len(ops)} device operations recorded, "
        f"{len(counts)} segments between spins for {len(calls)} calls")
    if len(counts) != len(calls):
        log("colour launches: " + " | ".join(
            "spin" if "spin_kernel" in o else o[:24] for o in ops))
        return {name: None for name in calls}
    return dict(zip(calls, counts))


def bayer_file(bits=16):
    """A COLOUR_SIDE^2 RGGB filter-array unci item (one tile) with its
    cpat: cmpd holds the filter-array component and plane-less R, G, B
    reference components, as the JAX package's writer lays them out."""
    n = COLOUR_SIDE
    uncC, cmpd = make_boxes([(0, bits)], [11, 4, 5, 6])
    cpat = Box_cpat()
    cpat.pattern_width = cpat.pattern_height = 2
    cpat.components = [1, 2, 2, 3]             # R G / G B
    cpat.component_gains = [1.0] * 4
    plane = np.random.default_rng(SEED + 5).integers(
        0, 1 << bits, (n, n), dtype=np.uint16)
    f = new_file()
    item = add_unci(f, n, n, (uncC, cmpd), plane.astype(">u2").tobytes(),
                    [(cpat, False)], hidden=False)
    f.set_primary_item(item)
    return f.write()


# (name, op, input kind, bits, convert_image arguments, options, exact,
# bytes the op must move: its input planes read once, its new output
# planes written once; a plane passed through by reference moves none)
_P = COLOUR_SIDE * COLOUR_SIDE
_Q = _P // 4
COLOUR_CASES = [
    ("ChromaResample up 4:2:0->4:4:4 bilinear", "ChromaResample",
     "ycc420", 8, (Colorspace.YCbCr, Chroma.C444), {}, True,
     2 * _Q + 2 * _P),
    ("ChromaResample down average 4:4:4->4:2:0", "ChromaResample",
     "ycc444", 8, (Colorspace.YCbCr, Chroma.C420), {}, True,
     2 * _P + 2 * _Q),
    ("ChromaResample down sharp-yuv 4:4:4->4:2:0", "ChromaResample",
     "ycc444", 8, (Colorspace.YCbCr, Chroma.C420),
     dict(chroma_downsampling="sharp-yuv"), False, 2 * _P + 2 * _Q),
    ("RGBToYCbCr 4:2:0 full range", "RGBToYCbCr", "rgb", 8,
     (Colorspace.YCbCr, Chroma.C420), {}, False, 3 * _P + _P + 2 * _Q),
    ("RGBToYCbCr 4:2:0 limited range", "RGBToYCbCr", "rgb", 8,
     (Colorspace.YCbCr, Chroma.C420, "limited"), {}, False,
     3 * _P + _P + 2 * _Q),
    ("RGBToMono", "RGBToMono", "rgb", 8,
     (Colorspace.Monochrome, Chroma.Monochrome), {}, False, 3 * _P + _P),
    ("MonoToYCbCr 4:2:0", "MonoToYCbCr", "mono", 8,
     (Colorspace.YCbCr, Chroma.C420), {}, True, _Q),
    ("FlattenAlpha solid", "FlattenAlpha", "rgba", 8,
     (Colorspace.RGB, Chroma.C444, "no-alpha"),
     dict(alpha_composition_mode="solid-color"), True, 4 * _P + 3 * _P),
    ("FlattenAlpha checkerboard", "FlattenAlpha", "rgba", 8,
     (Colorspace.RGB, Chroma.C444, "no-alpha"),
     dict(alpha_composition_mode="checkerboard"), True, 4 * _P + 3 * _P),
]


def colour_call(img, target, options, device=None):
    """convert_image of ``img`` to ``target`` ((colorspace, chroma) and
    "limited" or "no-alpha") on ``device`` (None: the card), as a call."""
    colorspace, chroma, *flag = target
    kw = {}
    if flag == ["limited"]:
        kw["target_full_range"] = False
    if flag == ["no-alpha"]:
        kw["target_has_alpha"] = False
    return lambda: convert_image(
        img, colorspace, chroma,
        options=ColorConversionOptions(**options), device=device, **kw)


def cpu_run(img, target, options):
    """The same convert_image call on the CPU, once: (its result, its
    wall ms, the ops of the chain it ran, from their core/trace.py
    spans)."""
    with trace.collect() as spans:
        t0 = time.perf_counter()
        out = colour_call(img, target, options, "cpu")()
        ms = (time.perf_counter() - t0) * 1e3
    return out, ms, [n[6:] for n in spans if n.startswith("color.")]


def colour_row(name, op, nbytes, card_fn, cpu_ms, check):
    """One op's numbers: the card's median of REPEATS calls beside its
    byte bound, and the CPU call's time."""
    card_ms = median_ms(card_fn)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"name": name, "op": op,
            "replaces": f"{COLOUR_JNP}:{COLOUR_JNP_LINES[op]}",
            "ms": card_ms, "bound_ms": bound_ms, "bytes": nbytes,
            "share_of_bound": bound_ms / card_ms, "cpu_plain_ms": cpu_ms,
            **check}


# the JAX ops' lines in libheif_tpu/color/ops.py
COLOUR_JNP_LINES = {"ChromaResample": 396, "RGBToYCbCr": 282,
                    "RGBToMono": 584, "MonoToYCbCr": 362,
                    "FlattenAlpha": 508, "BayerToRGB": 615,
                    "YCbCrToRGB": 175}


def check_colour_ops(tally):
    """Phase 4f: each case of COLOUR_CASES, the Bayer file and the chain
    through planes_ycbcr8_to_rgb: the ops the chain ran, the card's
    result against the CPU's, the card's median time beside the byte
    bound, one CPU call's time and the device operations a call issues.
    Returns the rows."""
    rows, calls = [], {}
    for i, (name, op, kind, bits, target, options, exact, nbytes) in \
            enumerate(COLOUR_CASES):
        planes, space = colour_planes(kind, bits, SEED + 10 + i)
        card = colour_call(colour_image(planes, space, bits, DEV), target,
                           options)
        cpu_img = colour_image(planes, space, bits, "cpu")
        got = card()
        ref, cpu_ms, ops_run = cpu_run(cpu_img, target, options)
        assert ops_run == [op], f"{name}: the chain ran {ops_run}"
        rows.append(colour_row(name, op, nbytes, card, cpu_ms,
                               colour_compare(name, got, ref, exact)))
        calls[name] = card
        del planes, cpu_img, got, ref

    # the Bayer file through HeifContext: unci extraction, then BayerToRGB
    blob = bayer_file()
    with launch_counts() as bayer_launches:
        got = HeifContext.read_from_bytes(blob).decode_image(
            None, Colorspace.RGB, Chroma.C444)
    log(f"colour bayer file launches {bayer_launches}")
    assert bayer_launches["strided_extract_paste"] == 1, \
        "the Bayer item did not decode through strided_extract_paste"
    ref = HeifContext.read_from_bytes(blob, device="cpu").decode_image(
        None, Colorspace.RGB, Chroma.C444)
    check = colour_compare("Bayer RGGB 16-bit file -> RGB", got, ref, True)
    raw = HeifContext.read_from_bytes(blob).decode_image(None)
    raw_cpu = HeifContext.read_from_bytes(blob, device="cpu").decode_image(
        None)
    assert raw.bayer_pattern.channels == [Channel.R, Channel.G, Channel.G,
                                          Channel.B]
    target = (Colorspace.RGB, Chroma.C444)
    bayer = colour_call(raw, target, {})
    _, cpu_ms, ops_run = cpu_run(raw_cpu, target, {})
    assert ops_run == ["BayerToRGB"], ops_run
    row = colour_row("BayerToRGB RGGB 16-bit", "BayerToRGB", 2 * _P + 6 * _P,
                     bayer, cpu_ms, check)
    row["file_ms"] = median_ms(lambda: HeifContext.read_from_bytes(blob)
                               .decode_image(None, Colorspace.RGB,
                                             Chroma.C444))
    row["file_launches"] = bayer_launches
    rows.append(row)
    calls[row["name"]] = bayer
    del got, ref, raw_cpu

    # a chain through the planes_ycbcr8_to_rgb kernel: YCbCr 4:2:0 with
    # alpha, flattened onto white, to RGB
    name = "YCbCrToRGB + FlattenAlpha (kernel chain)"
    planes, space = colour_planes("ycc420a", 8, SEED + 30)
    img = colour_image(planes, space, 8, DEV)
    cpu_img = colour_image(planes, space, 8, "cpu")
    target = (Colorspace.RGB, Chroma.C444, "no-alpha")
    options = dict(alpha_composition_mode="solid-color")
    chain = colour_call(img, target, options)
    with launch_counts() as chain_launches:
        got = chain()
    log(f"colour chain launches {chain_launches}")
    assert chain_launches["planes_ycbcr8_to_rgb"] == 1, \
        "the chain did not launch planes_ycbcr8_to_rgb once"
    try:
        YCbCrToRGB.USE_KERNEL = False        # the plain path on the card
        plain = chain()
    finally:
        YCbCrToRGB.USE_KERNEL = None
    for ch in (Channel.R, Channel.G, Channel.B):
        tally.compare("planes_ycbcr8_to_rgb", f"colour chain {ch}",
                      got.plane(ch), plain.plane(ch), exact=True)
    ref, cpu_ms, ops_run = cpu_run(cpu_img, target, options)
    assert ops_run == ["YCbCrToRGB", "FlattenAlpha"], ops_run
    row = colour_row(name, "YCbCrToRGB", 2 * _P + 2 * _Q + 3 * _P, chain,
                     cpu_ms, colour_compare(name, got, ref, False))
    row["launches_by_kernel"] = chain_launches
    rows.append(row)
    calls[name] = chain
    del planes, img, cpu_img, got, ref, plain

    counts = launches_per_call(calls)
    for r in rows:
        r["launches_per_call"] = counts.get(r["name"])
    card = nvidia_smi()
    for r in rows:
        log(f"colour op {r['name']:44s} {r['ms']:.4f} ms, byte bound "
            f"{r['bound_ms']:.4f} ms ({100 * r['share_of_bound']:.2f}%), "
            f"{r['launches_per_call']} device operations a call, CPU "
            f"{r['cpu_plain_ms']:.1f} ms; {card}")
    return rows


# the metadata file's Exif payload (past its 4-byte offset), XMP and text
EXIF = b"MM\x00*\x00\x00\x00\x08" + bytes(range(24))
XMP = b'<x:xmpmeta xmlns:x="adobe:ns:meta/"><rdf:RDF/></x:xmpmeta>'
TEXT = "caption: a 64x64 test image"


def region_payload():
    """An rgan payload in 16-bit fields (version 0, flags 0; ISO 23008-12
    6.10): a point, a rectangle, an ellipse, a polygon, a polyline and a
    referenced mask, in a 640x480 reference space."""
    w = ByteWriter()
    w.write8(0)
    w.write8(0)
    w.write16(640)
    w.write16(480)
    w.write8(6)
    for code, fields in ((0, (10, -5)), (1, (1, 2, 100, 50)),
                         (2, (320, 240, 100, 60)),
                         (3, (3, 0, 0, 10, 0, 5, 9)),
                         (6, (2, 1, 1, 2, 2)), (4, (4, 6, 16, 8))):
        w.write8(code)
        for v in fields:
            w.write16(v & 0xFFFF)
    return w.data()


def metadata_file():
    """A 64x64 RGB unci image with an Exif item (4-byte TIFF offset 0),
    an XMP item, a region item whose mask geometry names an mski item,
    and a text item, each linked to the image by cdsc."""
    f = new_file()
    image = add_unci(f, 64, 64, rgb8(), payload(64, 64, rgb8(), 40),
                     hidden=False)
    f.set_primary_item(image)
    mask = f.add_new_item("mski")
    f.append_item_data(mask.item_id, bytes(range(128)))
    f.add_property(mask.item_id, Box_ispe(16, 8), False)
    f.add_property(mask.item_id, Box_mskC(8), True)
    mask.hidden = True
    items = {}
    for kind, data, content in (
            ("Exif", (0).to_bytes(4, "big") + EXIF, ""),
            ("mime", XMP, "application/rdf+xml"),
            ("rgan", region_payload(), ""),
            ("txti", TEXT.encode("utf-8"), "text/plain")):
        infe = f.add_new_item(kind)
        infe.content_type = content
        infe.hidden = True
        f.append_item_data(infe.item_id, data)
        f.add_reference("cdsc", infe.item_id, [image])
        items[kind] = infe.item_id
    f.add_reference("mask", items["rgan"], [mask.item_id])
    return f.write(), image, mask.item_id


def metadata_answers(ctx, image):
    regions = ctx.get_region_items(image)
    return {
        "blocks": [(b["item_type"], b["content_type"], bytes(b["data"]))
                   for b in ctx.get_metadata_blocks(image)],
        "exif": ctx.get_exif(image), "xmp": ctx.get_xmp(image),
        "regions": [(r.reference_width, r.reference_height,
                     [sorted(vars(g).items()) for g in r.regions])
                    for r in regions],
        "texts": [t.text for t in ctx.get_text_items(image)]}


def check_metadata_file():
    """The metadata file read on a device=None context through
    read_from_bytes and through read_from_reader (a CallbackReader that
    counts the bytes it hands out): the same answers, the expected Exif,
    XMP, regions and text, the same decode, and an open that fetched only
    the structural boxes."""
    blob, image, mask = metadata_file()
    fetched = []

    def read(start, size):
        fetched.append(size)
        return blob[start:start + size]
    by_bytes = HeifContext.read_from_bytes(blob)
    by_reader = HeifContext.read_from_reader(
        CallbackReader(read=read, file_size=lambda: len(blob)))
    opened = sum(fetched)
    a, b = metadata_answers(by_bytes, image), metadata_answers(by_reader,
                                                               image)
    assert a == b, "read_from_reader answers differently"
    assert a["exif"] == EXIF and a["xmp"] == XMP and a["texts"] == [TEXT]
    (rw, rh, geoms), = a["regions"]
    kinds = [dict(g)["kind"] for g in geoms]
    assert (rw, rh) == (640, 480) and kinds == [
        "point", "rect", "ellipse", "polygon", "polyline",
        "referenced_mask"], kinds
    assert dict(geoms[1])["width"] == 100 and dict(geoms[0])["y"] == -5
    assert dict(geoms[5])["mask_item_id"] == mask
    same_image("metadata file: reader vs bytes",
               by_reader.decode_image(None, Colorspace.RGB, Chroma.C444),
               by_bytes.decode_image(None, Colorspace.RGB, Chroma.C444))
    log(f"check metadata file {len(blob)} B: bytes and reader agree "
        f"(Exif {len(a['exif'])} B, XMP {len(a['xmp'])} B, "
        f"{len(kinds)} regions, {len(a['texts'])} text); the reader's "
        f"open fetched {opened} B")
    return {"file_bytes": len(blob), "open_fetched_bytes": opened}


# --------------------------------------------------------------------- mesh
# Phase 4g: tile-parallel and sharded decode (libheif_tpu_torch/parallel)
# over every card, and over a virtual mesh of MESH_VIRTUAL members on card
# 0: that card repeated, so that the split, the member launches and the
# gather run the code they run over several cards.

MESH_VIRTUAL = 4
MESH_REPEATS = 5


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def phase_meshes():
    return {"cards": make_mesh(),
            f"virtual{MESH_VIRTUAL}": make_mesh(MESH_VIRTUAL,
                                                device="cuda:0")}


def walls_ms(fn, n=MESH_REPEATS):
    """Wall times of ``n`` calls after an untimed one (a card's first
    launch of a kernel loads its module), each ended by a sync of every
    card."""
    fn()
    sync_all()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync_all()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def np_rgb_nearest(y, cb, cr):
    """The JAX sharded pipeline's conversion (libheif_tpu/parallel/
    grid_decode.py:39-61) of 8-bit planes in numpy: matrix 6, full range,
    chroma repeated, f32."""
    f = np.float32
    ry, rx = y.shape[0] // cb.shape[0], y.shape[1] // cb.shape[1]
    y = y.astype(f)
    cb = cb.astype(f).repeat(ry, 0).repeat(rx, 1)
    cr = cr.astype(f).repeat(ry, 0).repeat(rx, 1)
    r = y + f(2 * (1 - KR)) * (cr - f(128))
    b = y + f(2 * (1 - KB)) * (cb - f(128))
    g = (y - f(KR) * r - f(KB) * b) / f(1 - KR - KB)
    return {ch: np.clip(np.round(c), 0, 255).astype(np.uint8)
            for ch, c in (("R", r), ("G", g), ("B", b))}


def members_with(n, mesh):
    """Members of ``mesh`` that get some of ``n`` rows or tiles."""
    return sum(hi > lo for lo, hi in chunk_bounds(n, mesh.size))


def check_mesh_unci(tally, uncC, cmpd, data, ref_planes):
    """(a) the 4096x4096 8-bit 4:2:0 unci item (8 tile rows) through
    sharded_unci_decode over each mesh, with and without convert_to_rgb:
    strided_extract_paste (and planes_ycbcr8_to_rgb) once for each member
    with tile rows; every gathered plane equal to UnciDecoder.decode, to
    the plain strided path and to numpy; the RGB equal to the kernel's
    plain version on the card and within the colour contract of the JAX
    pipeline's formula in numpy.  Walls beside the unsharded decode's."""
    dec = UnciDecoder(uncC, cmpd, W, H, device=DEV)
    lay = dec.layout
    whole = dec.decode(data)
    plain = cuda_fast.fused_strided_decode_plain(
        lay, kernels.payload_tiles(lay, data, DEV))
    np_rgb = np_rgb_nearest(*ref_planes)
    out = {"walls_ms": {"unsharded_decode": walls_ms(
        lambda: dec.decode(data))}, "launches": {}, "gather_ms": {}}
    for name, mesh in phase_meshes().items():
        members = members_with(lay.tile_rows, mesh)
        for rgb in (False, True):
            what = f"{name}{' rgb' if rgb else ''}"
            with launch_counts() as launches:
                planes = sharded_unci_decode(dec, data, mesh=mesh,
                                             convert_to_rgb=rgb)
            log(f"mesh unci {what}: {members} members with tile rows, "
                f"launches {launches}")
            assert launches["strided_extract_paste"] == members, \
                f"mesh unci {what}: not one strided launch a member"
            assert launches["planes_ycbcr8_to_rgb"] == (members if rgb
                                                         else 0)
            assert launches["assemble_tile_buffers"] == 0
            out["launches"][what] = launches
            for ch, p in planes.items():
                assert len(p.shards) == members and all(
                    s.device == d for s, d in zip(p.shards, p.devices))
            t0 = time.perf_counter()
            got = {ch: p.gather(DEV) for ch, p in planes.items()}
            out["gather_ms"][what] = ms_since(t0)
            if not rgb:
                for ch, ref in zip((Channel.Y, Channel.Cb, Channel.Cr),
                                   ref_planes):
                    tally.compare("strided_extract_paste",
                                  f"mesh {what} {ch} vs decode", got[ch],
                                  whole.plane(ch), exact=True)
                    tally.compare("strided_extract_paste",
                                  f"mesh {what} {ch} vs plain", got[ch],
                                  plain[ch], exact=True)
                    assert np.array_equal(got[ch].cpu().numpy(), ref), \
                        f"mesh {what} {ch} vs numpy"
                continue
            kernel_plain = cuda_fast.ycbcr8_planes_to_rgb_plain(
                whole.plane(Channel.Y), whole.plane(Channel.Cb),
                whole.plane(Channel.Cr), kr=float(KR), kb=float(KB),
                full_range=True, upsampling=cuda_fast.NEAREST)
            for i, ch in enumerate("RGB"):
                tally.compare("planes_ycbcr8_to_rgb",
                              f"mesh {what} {ch} vs plain", got[ch],
                              kernel_plain[i], exact=True)
                tally.compare("planes_ycbcr8_to_rgb",
                              f"mesh {what} {ch} vs JAX formula", got[ch],
                              torch.from_numpy(np_rgb[ch]).to(DEV),
                              exact=False)
            out["walls_ms"][what] = walls_ms(
                lambda: sharded_unci_decode(dec, data, mesh=mesh,
                                            convert_to_rgb=True))
        out["walls_ms"][name] = walls_ms(
            lambda: sharded_unci_decode(dec, data, mesh=mesh))
    out["walls_ms"]["unsharded_decode_convert"] = walls_ms(
        lambda: convert_image(dec.decode(data), Colorspace.RGB,
                              Chroma.C444))
    log(f"mesh unci walls ms {json.dumps(out['walls_ms'])}")
    return out


def photo_tiles_parsed(blob):
    """(SPS, syntax, raw TUs) of the photo's tiles, in grid order."""
    hf = HeifFile.from_bytes(blob)
    ids = hf.get_references_from(hf.primary_item_id,
                                 "dimg")[0].to_item_ids
    return coded_grid.parse_tiles([(hf.get_property(i, Box_hvcC),
                                    hf.get_item_data(i)) for i in ids])


def check_mesh_hevc(tally, blob):
    """(b) the HEVC photo through HeifContext with DecodingOptions(mesh=)
    over each mesh: one plan a member, so hevc_dequant_itx and
    hevc_intra_wave once a member with tiles; planes equal to the
    unsharded decode; each member's plan (its chunk of the photo's 48
    tiles, on its device) holds both kernels against their plain
    versions.  Walls beside the unsharded decode's."""
    ref = HeifContext.read_from_bytes(blob).decode_image(None)
    parsed = photo_tiles_parsed(blob)
    n = len(parsed)
    out = {"walls_ms": {"unsharded": walls_ms(
        lambda: HeifContext.read_from_bytes(blob).decode_image(None),
        REPEATS)}, "launches": {}}
    for name, mesh in phase_meshes().items():
        members = members_with(n, mesh)
        opts = DecodingOptions(mesh=mesh)
        with launch_counts() as launches:
            img = HeifContext.read_from_bytes(blob).decode_image(
                None, options=opts)
        log(f"mesh hevc photo {name}: {members} members with tiles, "
            f"launches {launches}")
        for k in ("hevc_dequant_itx", "hevc_intra_wave"):
            assert launches[k] == members, f"{k}: not once a member"
        out["launches"][name] = launches
        for ch in (Channel.Y, Channel.Cb, Channel.Cr):
            assert img.plane(ch).device == ref.plane(ch).device
            n_diff = int((img.plane(ch) != ref.plane(ch)).sum())
            log(f"check mesh hevc photo {name} {ch} vs unsharded: "
                f"differing {n_diff}")
            assert n_diff == 0, f"mesh hevc photo {name} {ch} differs"
        for k, (dev, (lo, hi)) in enumerate(zip(
                mesh.members(), chunk_bounds(n, mesh.size))):
            if hi == lo:
                continue
            plan = device_recon.build_plan([p[1] for p in parsed[lo:hi]],
                                           [p[2] for p in parsed[lo:hi]],
                                           dev)
            what = f"mesh {name} member {k} tiles {lo}-{hi - 1}"
            check_waves(tally, what, plan,
                        check_residuals(tally, what, plan))
        out["walls_ms"][name] = walls_ms(
            lambda: HeifContext.read_from_bytes(blob).decode_image(
                None, options=opts), REPEATS)
    log(f"mesh hevc photo walls ms {json.dumps(out['walls_ms'])}")
    return out, ref


def host_sharded_image(planes, grid, sps):
    """The grid's (Y, Cb, Cr) from decode_grid_host_sharded's tile
    planes, each cropped and pasted where the grid puts it."""
    tw, th = sps.cropped_size
    gw, gh = grid.output_width, grid.output_height
    out = []
    for c, sub in enumerate((1, 2, 2)):
        plane = torch.zeros(((gh + sub - 1) // sub, (gw + sub - 1) // sub),
                            dtype=torch.int32, device=DEV)
        for idx, pl in enumerate(planes):
            ty, tx = divmod(idx, grid.columns)
            p = hevc_decoder.crop_to_conformance(sps, *pl)[c].to(DEV)
            y0, x0 = ty * th // sub, tx * tw // sub
            h = min(p.shape[0], plane.shape[0] - y0)
            w = min(p.shape[1], plane.shape[1] - x0)
            plane[y0:y0 + h, x0:x0 + w] = p[:h, :w]
        out.append(plane)
    return out


def check_host_sharded(blob, ref, mesh, n_hosts, what):
    """decode_grid_host_sharded on the photo written to a file: each of
    ``n_hosts`` virtual hosts range-reads and parses its chunk of tiles,
    then the tiles reconstruct over ``mesh``; equal to the context's
    decode ``ref``."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "photo.heic")
        with open(path, "wb") as f:
            f.write(blob)
        t0 = time.perf_counter()
        planes, grid, sps = decode_grid_host_sharded(path, n_hosts,
                                                     mesh=mesh)
        ms = ms_since(t0)
    for c, got in zip((Channel.Y, Channel.Cb, Channel.Cr),
                      host_sharded_image(planes, grid, sps)):
        n_diff = int((got != ref.plane(c).to(torch.int32)).sum())
        log(f"check host-sharded {what} {c} vs context decode: "
            f"differing {n_diff}")
        assert n_diff == 0, f"host-sharded {what} {c} differs"
    return ms


def dryrun_multichip(blob):
    """(d) the analog of __graft_entry__.dryrun_multichip over every card:
    an unci pipeline with one tile row a card and convert_to_rgb, the
    photo's first max(2, cards) HEVC tiles through decode_tiles_device,
    and the photo host-sharded over the cards; each against the same work
    on card 0 alone."""
    mesh = make_mesh()
    n = mesh.size
    log(f"dryrun multichip: {n} card(s), mesh shape {mesh.shape} "
        f"axes {mesh.axis_names}")
    uncC, cmpd = ycc420(64, 16 * n, (1, n))
    data = payload(64, 16 * n, (uncC, cmpd), SEED + 14)
    dec = UnciDecoder(uncC, cmpd, 64, 16 * n, device=DEV)
    planes = sharded_unci_decode(dec, data, mesh=mesh, convert_to_rgb=True)
    r = planes["R"].gather(DEV)
    assert tuple(r.shape) == (16 * n, 64) and len(planes["R"].shards) == n
    whole = dec.decode(data)
    ref = np_rgb_nearest(*(whole.np_plane(c) for c in
                           (Channel.Y, Channel.Cb, Channel.Cr)))["R"]
    d = np.abs(r.cpu().numpy().astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).sum() < 0.01 * d.size
    parsed = photo_tiles_parsed(blob)[:max(2, n)]
    syn, raw = [p[1] for p in parsed], [p[2] for p in parsed]
    tiles = coded_grid.decode_tiles_device(syn, raw, mesh)
    alone = coded_grid.decode_tiles_device(syn, raw, device=DEV)
    assert len(tiles) == len(parsed) and tiles[0][0].shape == (512, 512)
    for a, b in zip(tiles, alone):
        assert all(torch.equal(x.to(DEV), y) for x, y in zip(a, b))
    img = HeifContext.read_from_bytes(blob).decode_image(None)
    check_host_sharded(blob, img, mesh, n, f"over {n} card(s)")
    return {"cards": n, "mesh_shape": list(mesh.shape)}


def check_last_card_launch():
    """A launch on the last card leaves the caller's current device as it
    was (KernelEntry.launch restores it)."""
    n = torch.cuda.device_count()
    before = torch.cuda.current_device()
    uncC, cmpd = ycc420(64, 32, (1, 2))
    dec = UnciDecoder(uncC, cmpd, 64, 32, device=f"cuda:{n - 1}")
    dec.decode(payload(64, 32, (uncC, cmpd), SEED + 15))
    torch.cuda.synchronize(n - 1)
    after = torch.cuda.current_device()
    log(f"launch on cuda:{n - 1}: current device {before} before, "
        f"{after} after")
    assert after == before, "a launch changed the current device"


def check_mesh(tally, uncC, cmpd, data, ref_planes, photo):
    """Phase 4g: (a) to (d) and the launch device."""
    t0 = time.perf_counter()
    sync_all()          # every card's context made before anything is timed
    card = nvidia_smi()
    unci = check_mesh_unci(tally, uncC, cmpd, data, ref_planes)
    hevc, ref = check_mesh_hevc(tally, photo)
    host_ms = check_host_sharded(photo, ref, make_mesh(
        MESH_VIRTUAL, device="cuda:0"), MESH_VIRTUAL,
        f"{MESH_VIRTUAL} hosts over virtual{MESH_VIRTUAL}")
    dry = dryrun_multichip(photo)
    if torch.cuda.device_count() > 1:
        check_last_card_launch()
    out = {"card": card, "unci": unci, "hevc_photo": hevc,
           "host_sharded_ms": host_ms, "dryrun": dry,
           "seconds": time.perf_counter() - t0}
    log(f"mesh phase {out['seconds']:.1f} s on {card}")
    return out


# ---------------------------------------------------------------- sequences
# Phase 4h: image sequences (msf1) committed in libheif_tpu_torch/testdata/
# seq, opened through HeifContext and decoded track by track on the card.

SEQ_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "libheif_tpu_torch", "testdata", "seq")
# the 1920x1080 B pyramids (JAX SequenceEncoder; libx265 with intra CUs,
# AMP and SAO in P and B pictures), each frame's decode_sample order
# after the in-order pass (random access: a restart at the IDR each)
SEQ_STREAMS = {"bpyr-1920x1080": (6, 3), "x265-1920x1080": (7,)}
# hevc_inter_pred's stress picture: (W, H, bit depth, reference slots,
# seed) of inter_cases.synthetic with local motion
INTER_STRESS = (3840, 2160, 8, 3, 16)
SEQ_UNCV = "uncv-256x256"
SEQ_SPANS = ("hevc.parse", "hevc.parse.inter", "hevc.plan", "hevc.mc",
             "hevc.stage_a", "hevc.residual", "hevc.stage_b", "hevc.deblock")
INTER_REPLACES = "libheif_tpu/codecs/hevc/recon.py:86"
INTER_ALSO = ["libheif_tpu/codecs/hevc/recon.py:78",
              "libheif_tpu/codecs/hevc/recon.py:113",
              "libheif_tpu/codecs/hevc/recon.py:140",
              "libheif_tpu/codecs/hevc/recon.py:148",
              "libheif_tpu/codecs/hevc/recon.py:405"]


def seq_streams():
    with open(os.path.join(SEQ_DIR, "manifest.json")) as f:
        return {e["name"]: e for e in json.load(f)["streams"]}


def seq_blob(e):
    with open(os.path.join(SEQ_DIR, e["file"]), "rb") as f:
        return f.read()


def frame_hashes(img):
    return int32_hashes([img.plane(c).to(torch.int32)
                         for c in (Channel.Y, Channel.Cb, Channel.Cr)])


@contextlib.contextmanager
def inter_capture():
    """While inside, each P or B picture's plan and the DPB it reads are
    kept (the DPB cloned before the picture's motion compensation): the
    dict yielded maps "plans" to [(plan, ydpb, cdpb)]."""
    real = device_recon.inter_predict
    out = {"plans": []}

    def spy(plan, ydpb, cdpb, bufs):
        out["plans"].append((plan, ydpb.clone(), cdpb.clone()))
        return real(plan, ydpb, cdpb, bufs)
    device_recon.inter_predict = spy
    try:
        yield out
    finally:
        device_recon.inter_predict = real


def decode_track_frames(t, e, convert=True):
    """Every frame of track ``t`` in output order (decode_next_image),
    each to interleaved RGB too, held to the manifest's hashes; the wall
    ms of each frame (decode and conversion, ending in a sync)."""
    ms = []
    for i in range(e["frames"]):
        t0 = time.perf_counter()
        img = t.decode_next_image()
        rgb = convert_image(img, Colorspace.RGB, Chroma.InterleavedRGB) \
            if convert else None
        ms.append(ms_since(t0))
        assert frame_hashes(img) == e["sha256"][i], \
            f"{e['name']} frame {i} differs from the manifest"
        if rgb is not None:
            p = rgb.plane(Channel.Interleaved)
            assert p.shape[0] == img.height and \
                p.numel() == 3 * img.width * img.height, tuple(p.shape)
    assert t.decode_next_image() is None
    return ms


def check_inter_plan(tally, what, plan, ydpb, cdpb):
    """hevc_inter_pred against its plain version on a P or B picture's
    plan (its PU jobs and the DPB it read), stage A's inter groups
    against theirs, and, where the picture has intra CUs, both intra
    kernels on its intra groups."""
    ip = plan.inter
    bufs = []
    for fn in (hevc_fast.inter_pred, hevc_fast.inter_pred_plain):
        y, c = device_recon.buffers(plan)
        fn(ip.jobs, ydpb, cdpb, y, c, bd=plan.bd)
        bufs.append((y, c))
    tally.compare("hevc_inter_pred", f"{what} luma, {len(ip.jobs)} jobs",
                  bufs[0][0][:-1], bufs[1][0][:-1], exact=True)
    tally.compare("hevc_inter_pred", f"{what} chroma", bufs[0][1][:-1],
                  bufs[1][1][:-1], exact=True)
    res = hevc_fast.dequant_itx(ip.groups, bd=plan.bd, mtab=ip.mtab)
    for g, r in zip(ip.groups, res):
        ref = hevc_fast.dequant_itx_plain(
            g.coeffs, g.qp, g.ts, g.tqb, hevc_fast.transform_matrix(
                g.luma, g.log2, plan.device, g.inter),
            log2=g.log2, bd=plan.bd, mslot=g.mslot, mtab=ip.mtab)
        tally.compare("hevc_dequant_itx", f"{what} inter "
                      f"{(g.luma, g.log2)} n={g.coeffs.shape[0]}", r, ref,
                      exact=True)
    if plan.groups:
        check_waves(tally, f"{what} intra CUs", plan,
                    check_residuals(tally, f"{what} intra CUs", plan))


def check_sequence(tally, name, order):
    """One 1920x1080 sequence through HeifContext on the card: every frame
    in output order with its RGB conversion (the launch counts read
    around it: hevc_inter_pred once a P or B picture), random access
    (``order``), then once more in order frame by frame inside
    trace.collect() for the split by span; the kernels on its P and B
    pictures' plans against their plain versions."""
    e = seq_streams()[name]
    blob = seq_blob(e)
    n = e["frames"]
    t = HeifContext.read_from_bytes(blob).tracks[0]
    assert (t.coding, t.num_samples, t.width, t.height) == \
        ("hvc1", n, e["width"], e["height"])
    with inter_capture() as cap, launch_counts() as launches:
        frame_ms = decode_track_frames(t, e)
    log(f"sequence {name} launches {launches}")
    assert launches["hevc_inter_pred"] == n - 1, \
        f"{name}: not one hevc_inter_pred launch a P or B picture"
    assert launches["planes_ycbcr8_to_rgb"] == n
    for k in ("hevc_dequant_itx", "hevc_intra_wave"):
        assert launches[k] > 0, f"{name}: no {k} launch"
    assert launches["strided_extract_paste"] == 0
    random_ms = []
    for i in order:
        t0 = time.perf_counter()
        img = t.decode_sample(i)
        random_ms.append(ms_since(t0))
        assert frame_hashes(img) == e["sha256"][i], \
            f"{name}: random access to frame {i} differs"
    t = HeifContext.read_from_bytes(blob).tracks[0]
    split = []
    for i in range(n):
        with trace.collect() as spans:
            t0 = time.perf_counter()
            img = t.decode_next_image()
            total = ms_since(t0)
        assert frame_hashes(img) == e["sha256"][i]
        split.append({"total_ms": total, "spans": spans})
    for s in SEQ_SPANS:
        assert any(s in f["spans"] for f in split), f"{name}: no {s} span"
    plans = cap["plans"]
    big = max(range(len(plans)), key=lambda k: len(plans[k][0].inter.jobs))
    for k in sorted({0, big}):
        check_inter_plan(tally, f"seq {name} P/B picture {k + 1}",
                         *plans[k])
    intra_cus = sum(bool(p[0].groups) for p in plans)
    out = {"frames": n, "frame_ms": frame_ms, "random_order": list(order),
           "random_ms": random_ms, "launches": launches,
           "pb_pictures_with_intra_cus": intra_cus, "split": split,
           "jobs": [len(p[0].inter.jobs) for p in plans]}
    log(f"sequence {name} frame ms {frame_ms} random ms {random_ms}")
    log(f"sequence {name} split {json.dumps(split)}")
    return out, plans[big]


def check_uncv_track(tally):
    """The uncv track through HeifContext on the card and on the CPU: each
    frame strided_extract_paste once, equal on both and to the
    manifest."""
    e = seq_streams()[SEQ_UNCV]
    blob = seq_blob(e)
    t = HeifContext.read_from_bytes(blob).tracks[0]
    cpu = HeifContext.read_from_bytes(blob, device="cpu").tracks[0]
    assert t.coding == "uncv"
    with launch_counts() as launches:
        imgs = [t.decode_sample(i) for i in range(e["frames"])]
    assert launches["strided_extract_paste"] == e["frames"], launches
    for i, img in enumerate(imgs):
        ref = cpu.decode_sample(i)
        for c in (Channel.Y, Channel.Cb, Channel.Cr):
            tally.compare("strided_extract_paste",
                          f"uncv track frame {i} {c} card vs CPU",
                          img.plane(c).cpu(), ref.plane(c), exact=True)
        assert frame_hashes(img) == e["sha256"][i]
    log(f"uncv track {SEQ_UNCV} launches {launches}")
    return launches


def inter_buffers(W_, H_):
    """A W_ x H_ picture's flat luma and chroma sample buffers."""
    return (torch.zeros(W_ * H_, dtype=torch.int32, device=DEV),
            torch.zeros(2 * (W_ // 2) * (H_ // 2), dtype=torch.int32,
                        device=DEV))


def check_inter_jobs(tally, what, jobs, ydpb, cdpb, bd):
    """hevc_inter_pred against its plain version on one job table."""
    H_, W_ = ydpb.shape[1:]
    bufs = []
    for fn in (hevc_fast.inter_pred, hevc_fast.inter_pred_plain):
        y, c = inter_buffers(W_, H_)
        fn(jobs, ydpb, cdpb, y, c, bd=bd)
        bufs.append((y, c))
    for k, plane in ((0, "luma"), (1, "chroma")):
        tally.compare("hevc_inter_pred", f"{what} {bd}-bit {plane}, "
                      f"{len(jobs)} jobs", bufs[0][k], bufs[1][k],
                      exact=True)


def check_inter_cases(tally):
    """hevc_inter_pred against its plain version on
    codecs/hevc/inter_cases.synthetic (every PU shape, every chroma and
    luma phase, uni and bi, one picture in both lists, vectors beyond
    every edge) at 8, 10 and 12 bits, on one PU of the whole picture
    reaching far outside it in both lists, and on the stress picture
    (INTER_STRESS: local motion over a partition); returns the stress
    picture's (jobs, ydpb, cdpb)."""
    W_, H_ = 256, 192
    for bd in (8, 10, 12):
        jobs, ydpb, cdpb = inter_cases.synthetic(W_, H_, bd, bd, DEV)
        whole = torch.from_numpy(hevc_fast.inter_jobs(np.array(
            [[0, 0, W_, H_, 1, -8 * W_ - 3, 8 * H_ + 5, 2, 8 * W_ + 7,
              -8 * H_]], np.int32))).to(DEV)
        check_inter_jobs(tally, "synthetic partition", jobs, ydpb, cdpb, bd)
        check_inter_jobs(tally, "synthetic whole picture", whole, ydpb,
                         cdpb, bd)
    W_, H_, bd, refs, seed = INTER_STRESS
    stress = inter_cases.synthetic(W_, H_, bd, seed, DEV, refs=refs,
                                   motion="local")
    check_inter_jobs(tally, f"stress {W_}x{H_} local motion", *stress, bd)
    return stress


def check_sequences(tally):
    """Phase 4h: the synthetic motion cases, both 1920x1080 sequences and
    the uncv track; returns (its numbers, the x265 sequence's captured
    plans by name, the stress picture's inputs)."""
    t0 = time.perf_counter()
    stress = check_inter_cases(tally)
    out, captured = {"inter_cases_seconds": time.perf_counter() - t0}, {}
    for name, order in SEQ_STREAMS.items():
        t0 = time.perf_counter()
        out[name], captured[name] = check_sequence(tally, name, order)
        out[name]["seconds"] = time.perf_counter() - t0
    out["uncv_launches"] = check_uncv_track(tally)
    return out, captured, stress


def inter_work(jobs, W, H, slots):
    """(bytes, operations) hevc_inter_pred needs for a job table over a
    W x H picture: each reference sample its jobs read (the windows their
    filters need, clamped to the picture, each sample once a slot), the
    job table, each output sample written once (int32); 2 operations a
    filter tap of the passes a phase needs, and 3 a sample for the
    weighting."""
    j = jobs.to(torch.int64)
    reads, ops = 0, 0
    for luma in (True, False):
        K, fb = (8, 2) if luma else (4, 3)
        pw, ph = (W, H) if luma else (W >> 1, H >> 1)
        bx, by = (j[:, 0], j[:, 1]) if luma else (j[:, 0] >> 1, j[:, 1] >> 1)
        bw = j[:, 2] if luma else torch.clamp(j[:, 2] >> 1, min=1)
        bh = j[:, 3] if luma else torch.clamp(j[:, 3] >> 1, min=1)
        side = hevc_fast.INTER_SIDE if luma else hevc_fast.INTER_SIDE // 2
        r = torch.arange(side + K - 1, device=j.device)
        planes = 1 if luma else 2
        mask = torch.zeros((slots, ph, pw), dtype=torch.bool,
                           device=j.device)
        for l in (0, 1):
            slot, mvx, mvy = j[:, 4 + 3 * l], j[:, 5 + 3 * l], j[:, 6 + 3 * l]
            use = slot >= 0
            fx, fy = (mvx & ((1 << fb) - 1)) != 0, (mvy & ((1 << fb) - 1)) != 0
            ew = bw + torch.where(fx, K - 1, 0)
            eh = bh + torch.where(fy, K - 1, 0)
            x0 = bx + (mvx >> fb) - torch.where(fx, K // 2 - 1, 0)
            y0 = by + (mvy >> fb) - torch.where(fy, K // 2 - 1, 0)
            ys = torch.clamp(y0[:, None] + r[None], 0, ph - 1)
            xs = torch.clamp(x0[:, None] + r[None], 0, pw - 1)
            ok = use[:, None, None] & (r[None, :, None] < eh[:, None, None]) \
                & (r[None, None, :] < ew[:, None, None])
            idx = (torch.clamp(slot, min=0)[:, None, None] * ph
                   + ys[:, :, None]) * pw + xs[:, None, :]
            mask.view(-1)[idx[ok]] = True
            taps = (fx * eh * bw + fy * bh * bw) * 2 * K
            ops += planes * int((taps * use).sum())
        reads += planes * int(mask.sum())
        ops += planes * 3 * int((bw * bh).sum())
    out_samples = int((j[:, 2] * j[:, 3]).sum()) + 2 * int(
        (torch.clamp(j[:, 2] >> 1, min=1) * torch.clamp(j[:, 3] >> 1, min=1))
        .sum())
    nbytes = 4 * reads + 4 * out_samples + j.numel() * 4
    return nbytes, ops


def inter_pred_row(timer, tally, captured, launches, stress):
    """hevc_inter_pred's row: the largest P or B picture of the x265
    sequence (the kernel, its plain version, its bounds), and the stress
    picture (the kernel and its bounds)."""
    plan, ydpb, cdpb = captured
    ip = plan.inter
    bufs = [device_recon.buffers(plan) for _ in range(2)]
    nbytes, nops = inter_work(ip.jobs, plan.width, plan.height,
                              ydpb.shape[0])
    b = bounds(nbytes, nops)
    ms = timer([lambda b_=b_: hevc_fast.inter_pred(
        ip.jobs, ydpb, cdpb, *b_, bd=plan.bd) for b_ in bufs])
    plain_ms = timer([lambda: hevc_fast.inter_pred_plain(
        ip.jobs, ydpb, cdpb, *bufs[0], bd=plan.bd)], n=3)
    s_jobs, s_ydpb, s_cdpb = stress
    s_w, s_h, s_bd = INTER_STRESS[:3]
    s_bytes, s_ops = inter_work(s_jobs, s_w, s_h, s_ydpb.shape[0])
    s_b = bounds(s_bytes, s_ops)
    s_bufs = [inter_buffers(s_w, s_h) for _ in range(2)]
    s_ms = timer([lambda b_=b_: hevc_fast.inter_pred(
        s_jobs, s_ydpb, s_cdpb, *b_, bd=s_bd) for b_ in s_bufs])
    row = {"name": "hevc_inter_pred", "route": "cuda",
           "source": HEVC_SOURCE, "replaces": INTER_REPLACES,
           "also_replaces": INTER_ALSO, "launches": launches,
           "max_abs_err": tally.max_abs_err["hevc_inter_pred"],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
           "bound_by": b["bound_by"], "library_ms": None,
           "checks": tally.checks["hevc_inter_pred"],
           "differing_pixels": tally.differing["hevc_inter_pred"],
           "bytes": nbytes, "ops": nops, "byte_bound_ms": b["byte_bound_ms"],
           "op_bound_ms": b["op_bound_ms"], "jobs": len(ip.jobs),
           "picture": f"{plan.width}x{plan.height}",
           "stress": {"picture": f"{s_w}x{s_h}", "jobs": len(s_jobs),
                      "ms": s_ms, "bytes": s_bytes, "ops": s_ops, **s_b}}
    log(f"hevc_inter_pred row {json.dumps(row)}")
    return row


# ------------------------------------------------------------------ encode
# Phase 4i: still-image encode through HeifContext on the card -- the
# HEVC photo's planes with an alpha gradient as jpeg items (the FDCT and
# quantiser on the card, jpeg_fdct_quant once an item), the flagship as
# unci items in 8x8 tiles, masks as mski items, each file equal to the
# same encode on the CPU and read back through the main path; the kernel
# against its plain version; the intra mode search (hevc_mode_search, one
# launch a block size) on the photo's luma and synthetic planes, against
# its plain version under the near-tie rule.

ENC_JNP = "libheif_tpu/codecs/jpeg/encoder.py"
MODES_JNP = "libheif_tpu/codecs/hevc/device_modes.py"
ENC_QUALITIES = (50, 90)
# int32 operations a sample that jpeg_fdct_quant's function needs: the two
# 1-D islow passes (59 operations for eight samples each, 14.75 a sample),
# the level shift (one a row, on the row pass's DC term: 1/8) and the
# quantiser (abs, add, negate, select and a division by a reciprocal, one
# multiply-high: 5)
FDCT_OPS_PER_SAMPLE = 19.875
FP32_LANES_PER_SM = 128      # Hopper architecture white paper
MODE_SIZES = (3, 4, 5)
NEAR_TIE = 1e-4              # relative float64 cost gap of a near tie
SYNTH_SIDE = 1024            # the synthetic mode-search planes


def fp32_rate():
    """FP32 operations a second of card 0: SMs x 128 lanes x the SM
    clock (clocks.max.sm)."""
    sms, mhz, _ = int32_rate()
    return sms * FP32_LANES_PER_SM * mhz * 1e6


def alpha_gradient(w, h, bits=8):
    """A diagonal gradient over the full range, on the card."""
    y = torch.arange(h, device=DEV, dtype=torch.int64)[:, None]
    x = torch.arange(w, device=DEV, dtype=torch.int64)[None, :]
    top = (1 << bits) - 1
    g = (x * top // max(w - 1, 1) + y * top // max(h - 1, 1)) // 2
    return g.to(torch.uint8 if bits <= 8 else torch.uint16)


def image_of(planes, space, chroma, bits=8):
    """A PixelImage over ``planes`` {channel: 2-D tensor}, its size the
    luma's (or the first plane's)."""
    main = planes.get(Channel.Y, next(iter(planes.values())))
    h, w = main.shape
    img = PixelImage(w, h, space, chroma)
    for ch, p in planes.items():
        img.set_plane(ch, p, bits)
    return img


def cpu_copy(img):
    """The same image with every plane copied to the CPU."""
    out = PixelImage(img.width, img.height, img.colorspace, img.chroma)
    for ch in img.channels():
        out.set_plane(ch, img.plane(ch).cpu(), img.bit_depth(ch))
    out.bayer_pattern = img.bayer_pattern
    return out


def encode_file(img, fmt, options=None, device=None):
    """One image through new_file, encode_image and write on ``device``
    (None: the card); (file bytes, item id)."""
    ctx = HeifContext(device=device)
    ctx.new_file()
    iid = ctx.encode_image(img, fmt, options)
    return ctx.write(), iid


def psnr(a, b, peak=255.0):
    d = a.to(torch.float64) - b.to(torch.float64)
    mse = float((d * d).mean())
    return float("inf") if mse == 0 else 10 * np.log10(peak * peak / mse)


def planes_differing(a, b, channels):
    """Samples that differ between two decodes, by channel."""
    return {ch: int((a.plane(ch).cpu().to(torch.int32) !=
                     b.plane(ch).cpu().to(torch.int32)).sum())
            for ch in channels}


def check_jpeg_encode(src):
    """The photo with its alpha as a jpeg item at each quality: launches
    read around new_file / encode_image / write (jpeg_fdct_quant once for
    the image and once for its alpha, nothing else), the file equal to the
    CPU encode's, its decode on the card (jpeg_dequant_idct) equal to its
    decode on the CPU, and its PSNR against the source."""
    chans = (Channel.Y, Channel.Cb, Channel.Cr, Channel.Alpha)
    src_cpu = cpu_copy(src)
    out = {}
    for q in ENC_QUALITIES:
        opts = EncodingOptions(quality=q)
        with launch_counts() as launches:
            t0 = time.perf_counter()
            blob, iid = encode_file(src, "jpeg", opts)
            card_ms = ms_since(t0)
        assert launches["jpeg_fdct_quant"] == 2, \
            f"jpeg_fdct_quant: {launches['jpeg_fdct_quant']} launches for " \
            "an image and its alpha"
        others = {k: v for k, v in launches.items()
                  if v and k != "jpeg_fdct_quant"}
        assert not others, f"the jpeg encode ran {others}"
        t0 = time.perf_counter()
        cpu_blob, _ = encode_file(src_cpu, "jpeg", opts, device="cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        assert blob == cpu_blob, f"q{q}: the card's file differs from the " \
            "CPU encode's"
        with launch_counts() as dec_launches:
            card = HeifContext.read_from_bytes(blob).decode_image(None)
        assert dec_launches["jpeg_dequant_idct"] == 2, dec_launches
        cpu = HeifContext.read_from_bytes(blob, device="cpu") \
            .decode_image(None)
        diff = planes_differing(card, cpu, chans)
        assert not any(diff.values()), f"q{q}: card vs CPU decode {diff}"
        quality = {ch: psnr(card.plane(ch), src.plane(ch)) for ch in chans}
        out[q] = {"bytes": len(blob), "launches": launches,
                  "decode_launches": dec_launches, "card_ms": card_ms,
                  "cpu_ms": cpu_ms, "psnr_db": quality,
                  "card_vs_cpu_decode_differing": diff}
        log(f"check jpeg encode q{q} {src.width}x{src.height} + alpha: "
            f"{len(blob)} B, equal to the CPU encode's, card decode equal "
            f"to the CPU decode, PSNR {json.dumps(quality)}, card "
            f"{card_ms:.1f} ms, CPU {cpu_ms:.1f} ms")
    return out


def fdct_plain(jobs, quant):
    return torch.cat([jpeg_idct.fdct_quant_plain(
        jpeg_fast.padded_blocks(j), quant[j.qidx]) for j in jobs])


def sampled_image(w, h, chroma, seed):
    """Random 8-bit YCbCr (or monochrome) planes on the card."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    if chroma == "mono":
        return image_of({Channel.Y: torch.randint(
            0, 256, (h, w), generator=g, device=DEV, dtype=torch.uint8)},
            Colorspace.Monochrome, Chroma.Monochrome)
    sx, sy = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}[chroma]
    cw, ch = -(-w // sx), -(-h // sy)
    planes = {Channel.Y: (h, w), Channel.Cb: (ch, cw), Channel.Cr: (ch, cw)}
    return image_of({c: torch.randint(0, 256, s, generator=g, device=DEV,
                                      dtype=torch.uint8)
                     for c, s in planes.items()}, Colorspace.YCbCr,
                    {"444": Chroma.C444, "422": Chroma.C422,
                     "420": Chroma.C420}[chroma])


def check_fdct_kernel(tally, src, alpha_img):
    """jpeg_fdct_quant against fdct_quant_plain on the card, 0
    coefficients differing: the photo's three planes and its alpha,
    509x301 images at every sampling, and planes at odd offsets and
    pitches of one buffer with four tables.  Returns the photo's jobs and
    tables for the timing row."""
    quant = jpeg_encoder.quant_tables(90, 2, DEV)
    photo_jobs = jpeg_encoder.component_jobs(src)[0]
    cases = [("photo YCbCr 4:2:0", photo_jobs, quant),
             ("photo alpha", jpeg_encoder.component_jobs(alpha_img)[0],
              quant[:1])]
    for i, chroma in enumerate(("444", "422", "420", "mono")):
        img = sampled_image(509, 301, chroma, SEED + i)
        jobs = jpeg_encoder.component_jobs(img)[0]
        cases.append((f"509x301 {chroma}", jobs, quant[:min(len(jobs), 2)]))
    g = torch.Generator(device=DEV)
    g.manual_seed(SEED + 7)
    buf = torch.randint(0, 256, (700, 1531), generator=g, device=DEV,
                        dtype=torch.uint8)
    views = [buf[1:302, 3:512], buf[303:454, 1:256], buf[455:456, 7:8],
             buf[457:700:2, 513:1530], buf[3:300, 1001:1002]]
    four = torch.randint(1, 256, (4, 64), generator=g, device=DEV,
                         dtype=torch.int32)
    cases.append(("views at odd offsets of one buffer", [
        jpeg_fast.FdctJob(v, -(-v.shape[1] // 8), -(-v.shape[0] // 8), k % 4)
        for k, v in enumerate(views)], four))
    for what, jobs, q in cases:
        tally.compare("jpeg_fdct_quant", what, jpeg_fast.fdct_quant(jobs, q),
                      fdct_plain(jobs, q), exact=True)
    return photo_jobs, quant


def check_unci_encode(img):
    """The flagship 4096x4096 4:2:0 image (the main path's decode) as unci
    items in 8x8 tiles: through encode_image with zlib over the whole
    payload, and through UnciEncoder with zlib a tile (icef) written with
    HeifFile; each file equal to the CPU encode's and read back through
    HeifContext on the card, the whole image (strided_extract_paste once)
    and every tile by decode_tile (strided_extract_paste once a tile),
    equal to the source."""
    chans = (Channel.Y, Channel.Cb, Channel.Cr)
    img_cpu = cpu_copy(img)
    out = {}
    opts = EncodingOptions(tile_cols=TILES, tile_rows=TILES,
                           compression="zlib")
    t0 = time.perf_counter()
    whole, iid = encode_file(img, "unci", opts)
    out["whole_card_ms"] = (time.perf_counter() - t0) * 1e3
    assert whole == encode_file(img_cpu, "unci", opts, device="cpu")[0], \
        "unci (zlib whole): the card's file differs from the CPU encode's"
    enc = UnciEncoder(TILES, TILES, "zlib", compress_per_tile=True)
    t0 = time.perf_counter()
    data, cmpd, uncC, cmpC, icef = enc.encode(img)
    out["per_tile_card_ms"] = (time.perf_counter() - t0) * 1e3
    ref = enc.encode(img_cpu)
    assert data == ref[0], "unci (zlib a tile): payload differs from the CPU's"
    for a, b in zip((cmpd, uncC, cmpC, icef), ref[1:]):
        wa, wb = ByteWriter(), ByteWriter()
        a.write(wa)
        b.write(wb)
        assert wa.data() == wb.data(), "unci boxes differ from the CPU's"
    f = new_file()
    tiled_id = add_unci(f, W, H, (uncC, cmpd), data,
                        [(cmpC, True), (icef, True)], hidden=False)
    f.set_primary_item(tiled_id)
    per_tile = f.write()
    for what, blob, item in (("zlib whole", whole, iid),
                             ("zlib a tile", per_tile, tiled_id)):
        ctx = HeifContext.read_from_bytes(blob)
        with launch_counts() as launches:
            back = ctx.decode_image(item)
        assert launches["strided_extract_paste"] == 1, launches
        for ch in chans:
            assert torch.equal(back.plane(ch), img.plane(ch)), (what, ch)
        tw, th = W // TILES, H // TILES
        with launch_counts() as tile_launches:
            tiles = [(tx, ty, ctx.decode_tile(item, tx, ty))
                     for ty in range(TILES) for tx in range(TILES)]
        assert tile_launches["strided_extract_paste"] == TILES * TILES, \
            tile_launches
        for tx, ty, t in tiles:
            for ch, sub in zip(chans, (1, 2, 2)):
                x0, y0 = tx * tw // sub, ty * th // sub
                want = img.plane(ch)[y0:y0 + th // sub, x0:x0 + tw // sub]
                assert torch.equal(t.plane(ch), want), (what, tx, ty, ch)
        out[what] = {"bytes": len(blob), "decode_launches": launches,
                     "tile_launches": tile_launches}
        log(f"check unci encode {what} {W}x{H} 8x8 tiles: {len(blob)} B "
            f"equal to the CPU encode's; decode and 64 tiles equal to the "
            f"source, launches {launches['strided_extract_paste']} and "
            f"{tile_launches['strided_extract_paste']}")
    return out


def check_mski_encode(w, h):
    """8- and 16-bit masks (a gradient) as mski items: the file equal to
    the CPU encode's, its decode on the card equal to the source."""
    out = {}
    for bits in (8, 16):
        mask = image_of({Channel.Y: alpha_gradient(w, h, bits)},
                        Colorspace.Monochrome, Chroma.Monochrome, bits)
        blob, iid = encode_file(mask, "mski")
        assert blob == encode_file(cpu_copy(mask), "mski",
                                   device="cpu")[0], f"mski {bits}-bit"
        back = HeifContext.read_from_bytes(blob).decode_image(iid)
        assert back.bit_depth(Channel.Y) == bits
        assert torch.equal(back.plane(Channel.Y).to(torch.int32),
                           mask.plane(Channel.Y).to(torch.int32)), bits
        out[bits] = len(blob)
        log(f"check mski encode {bits}-bit {w}x{h}: {len(blob)} B equal to "
            "the CPU encode's, decode equal to the source")
    return out


def search_planes(luma):
    g = torch.Generator(device=DEV)
    g.manual_seed(SEED + 11)
    return {"photo luma": luma,
            "flat": torch.full((SYNTH_SIDE, SYNTH_SIDE), 97, device=DEV,
                               dtype=torch.uint8),
            "noise": torch.randint(0, 256, (SYNTH_SIDE, SYNTH_SIDE),
                                   generator=g, device=DEV,
                                   dtype=torch.uint8)}


def check_mode_search(tally, luma):
    """The mode search: plan_modes_device on the photo's luma with the
    launch counts read around it (hevc_mode_search once a size, nothing
    else), then hevc_mode_search against mode_search_plain on the photo's
    luma and on flat and noise planes at every size.  Where the modes
    differ, both modes' costs are recomputed in float64 on the card and
    must be within NEAR_TIE of the larger; the count prints.  The least
    costs' largest difference is the row's max_abs_err."""
    with launch_counts() as launches:
        maps = device_modes.plan_modes_device(luma)
    assert launches["hevc_mode_search"] == len(MODE_SIZES), launches
    others = {k: v for k, v in launches.items()
              if v and k != "hevc_mode_search"}
    assert not others, f"plan_modes_device ran {others}"
    out = {"launches": launches, "cases": []}
    for name, y in search_planes(luma).items():
        for lg in MODE_SIZES:
            b, r, (gh, gw) = device_modes.extract_blocks(y, lg)
            modes, costs = hevc_fast.mode_search(b, r, lg)
            pm, pc = hevc_fast.mode_search_plain(b, r, lg)
            torch.cuda.synchronize()
            if name == "photo luma":
                assert torch.equal(maps[lg].reshape(-1), modes), \
                    "plan_modes_device differs from mode_search"
            idx = torch.nonzero(modes != pm).reshape(-1)
            worst = 0.0
            if idx.numel():
                ca = device_modes.mode_costs(b[idx], r[idx], lg, modes[idx])
                cb = device_modes.mode_costs(b[idx], r[idx], lg, pm[idx])
                worst = float(((ca - cb).abs() / torch.clamp(
                    torch.maximum(ca, cb), min=1e-300)).max())
            cost_err = float((costs - pc).abs().max())
            case = {"plane": name, "log2": lg, "blocks": b.shape[0],
                    "near_tie_disagreements": int(idx.numel()),
                    "worst_relative_gap": worst,
                    "least_cost_max_abs_diff": cost_err}
            out["cases"].append(case)
            log(f"check hevc_mode_search {name} {y.shape[1]}x{y.shape[0]} "
                f"log2 {lg}: {b.shape[0]} blocks, {idx.numel()} near-tie "
                f"disagreements (worst gap {worst:.3g}), least costs within "
                f"{cost_err:.3g}")
            assert worst <= NEAR_TIE, f"{name} log2 {lg}: modes differ by " \
                f"{worst:.3g} of their cost"
            tally.max_abs_err["hevc_mode_search"] = max(
                tally.max_abs_err["hevc_mode_search"], cost_err)
            tally.checks["hevc_mode_search"] += 1
            tally.differing["hevc_mode_search"] += int(idx.numel())
    for lg in MODE_SIZES:
        b, r, want = each_mode_case(lg)
        modes, costs = hevc_fast.mode_search(b, r, lg)
        pm, pc = hevc_fast.mode_search_plain(b, r, lg)
        wrong = int((modes != want).sum()) + int((pm != want).sum())
        worst = float(torch.maximum(costs.abs().max(), pc.abs().max()))
        out["cases"].append({"plane": "each mode's own prediction",
                             "log2": lg, "blocks": b.shape[0],
                             "wrong_modes": wrong, "largest_cost": worst})
        log(f"check hevc_mode_search each mode's own prediction log2 {lg}: "
            f"{b.shape[0]} blocks, {wrong} modes not found, costs at most "
            f"{worst:.3g}")
        assert wrong == 0 and worst == 0, f"log2 {lg}: a mode's own " \
            f"prediction not found at cost 0 ({wrong}, {worst})"
        tally.checks["hevc_mode_search"] += 1
    return out


def each_mode_case(lg, per_mode=3):
    """Blocks that are each mode's own prediction: for m = 0..34,
    ``per_mode`` blocks ``weight_matrix(m) @ refs`` of random 8-bit
    references (exact in float32: the weights are multiples of 1/64), on
    the card; (blocks, refs, the modes)."""
    n = 1 << lg
    g = torch.Generator(device=DEV)
    g.manual_seed(SEED + 13 + lg)
    modes = torch.arange(len(device_modes.MODES), device=DEV,
                         dtype=torch.int32).repeat_interleave(per_mode)
    refs = torch.randint(0, 256, (modes.numel(), 4 * n + 1), generator=g,
                         device=DEV).to(torch.float64)
    W = torch.from_numpy(device_modes.all_weights(lg)).to(DEV, torch.float64)
    blocks = torch.bmm(W[modes.long()], refs[:, :, None])[:, :, 0]
    return blocks.to(torch.float32), refs.to(torch.float32), modes


def time_jpeg_encode(img):
    """encode_jpeg at the photo's size (YCbCr 4:2:0, q 90) REPEATS times,
    each split by its spans (jpeg.encode.fdct, .copy, .entropy, .write)."""
    runs = []
    for _ in range(REPEATS):
        with trace.collect() as spans:
            t0 = time.perf_counter()
            jpeg_encoder.encode_jpeg(img, 90)
            total = ms_since(t0)
        runs.append({"total_ms": total, "spans": dict(spans)})
    for name in ("jpeg.encode.fdct", "jpeg.encode.copy",
                 "jpeg.encode.entropy", "jpeg.encode.write"):
        assert all(name in r["spans"] for r in runs), f"no {name} span"
    log(f"jpeg encode {img.width}x{img.height} {json.dumps(runs)}")
    return runs


# the HEVC and AV1 encoders (host code; the mode search is hevc_mode_search)
CROP = 512                   # the mode="device" and AV1 crops of the photo
CROP_AT = (1024, 1536)       # (row, column) of the crops in the photo's luma
CROP10 = 256                 # the 10-bit HEVC crop
# the lossless AV1 crop: the Python encoder codes lossless pictures in 4x4
# transform blocks, about 200 s for a 512x512 crop on a CPU
CROP_LOSSLESS = 128
HEVC_ENC_SPANS = ("hevc.encode", "hevc.encode.copy", "hevc.encode.native",
                  "hevc.encode.write")
AV1_ENC_SPANS = ("av1.encode", "av1.encode.copy", "av1.encode.tile")
YCC = (Channel.Y, Channel.Cb, Channel.Cr)


@contextlib.contextmanager
def encoders_made(cls, method="encode"):
    """While inside, each ``cls.<method>`` call (IntraEncoder.encode,
    Av1IntraEncoder.encode, whose ``recon`` then holds the closed-loop
    reconstruction; the AVC _NativeSliceEncoder.encode_slice) appends its
    encoder to the list yielded."""
    real = getattr(cls, method)
    made = []

    def spy(self, *args):
        out = real(self, *args)
        made.append(self)
        return out
    setattr(cls, method, spy)
    try:
        yield made
    finally:
        setattr(cls, method, real)


def recon_differing(planes, recon, names):
    """Samples of decoded planes (tensors, cropped or not) that differ from
    an encoder's reconstruction (uncropped numpy) cropped to their size."""
    out = {}
    for name, p, r in zip(names, planes, recon):
        p = p.cpu().to(torch.int64)
        want = torch.from_numpy(np.asarray(r, np.int64))
        assert want.shape[0] >= p.shape[0] and want.shape[1] >= p.shape[1], \
            f"{name}: reconstruction {tuple(want.shape)} < {tuple(p.shape)}"
        out[name] = int((p != want[:p.shape[0], :p.shape[1]]).sum())
    return out


def photo_crop(planes, side, at=None):
    """A side x side YCbCr 4:2:0 crop of the photo's planes (views on the
    card) at luma position ``at`` (None: CROP_AT)."""
    oy, ox = at or CROP_AT
    crop = {Channel.Y: planes[Channel.Y][oy:oy + side, ox:ox + side]}
    for ch in (Channel.Cb, Channel.Cr):
        crop[ch] = planes[ch][oy // 2:(oy + side) // 2,
                              ox // 2:(ox + side) // 2]
    return crop


def check_hevc_photo_encode(src):
    """The photo with its alpha as hvc1 items at each quality (the
    registry path, the C++ encoder on the host), through new_file /
    encode_image / write: the file equal to the CPU encode's, decoded on
    the card (hevc_dequant_itx, hevc_intra_wave) equal to the encoder's
    reconstruction cropped to 4032x3024 (alpha too), its PSNR; the encode
    wall and its spans."""
    src_cpu = cpu_copy(src)
    out = {}
    for q in ENC_QUALITIES:
        opts = EncodingOptions(quality=q)
        with encoders_made(hevc_encoder.IntraEncoder) as encs, \
                launch_counts() as launches, trace.collect() as spans:
            t0 = time.perf_counter()
            blob, _ = encode_file(src, "hevc", opts)
            card_ms = ms_since(t0)
        assert len(encs) == 2, f"{len(encs)} encodes for an image + alpha"
        for name in HEVC_ENC_SPANS:
            assert spans.get(name, {}).get("count") == 2, f"span {name}"
        ran = {k: v for k, v in launches.items() if v}
        assert not ran, f"the hevc registry encode launched {ran}"
        t0 = time.perf_counter()
        cpu_blob, _ = encode_file(src_cpu, "hevc", opts, device="cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        assert blob == cpu_blob, f"q{q}: the card's hevc file differs from " \
            "the CPU encode's"
        with launch_counts() as dec_launches:
            card = HeifContext.read_from_bytes(blob).decode_image(None)
        for k in ("hevc_dequant_itx", "hevc_intra_wave"):
            assert dec_launches[k] > 0, f"the hevc decode did not launch {k}"
        assert (card.width, card.height) == PHOTO
        diff = recon_differing([card.plane(ch) for ch in YCC],
                               encs[0].recon, YCC)
        diff.update(recon_differing([card.plane(Channel.Alpha)],
                                    encs[1].recon[:1], [Channel.Alpha]))
        assert not any(diff.values()), \
            f"hevc q{q}: decode vs the encoder's reconstruction {diff}"
        quality = {ch: psnr(card.plane(ch), src.plane(ch))
                   for ch in YCC + (Channel.Alpha,)}
        out[q] = {"bytes": len(blob), "launches": launches,
                  "decode_launches": dec_launches, "card_ms": card_ms,
                  "cpu_ms": cpu_ms, "spans": dict(spans), "psnr_db": quality,
                  "decode_vs_recon_differing": diff}
        log(f"check hevc encode q{q} {src.width}x{src.height} + alpha: "
            f"{len(blob)} B, equal to the CPU encode's, card decode equal to "
            f"the encoder's reconstruction {diff}, PSNR "
            f"{json.dumps(quality)}, card {card_ms:.1f} ms, CPU "
            f"{cpu_ms:.1f} ms, spans {json.dumps(spans)}")
    return out


def decode_stream_on_card(cfg, nals):
    """An HEVC picture decoded on the card from its parameter sets and
    slice NALs: its uncropped planes and the launches it made."""
    sps = hevc_headers.parse_sps(cfg[0])
    pps = hevc_headers.parse_pps(cfg[1])
    with launch_counts() as launches:
        planes = hevc_decoder.decode_intra_picture(sps, pps, nals)
    for k in ("hevc_dequant_itx", "hevc_intra_wave"):
        assert launches[k] > 0, f"the hevc decode did not launch {k}"
    return planes, launches


def check_device_mode_encode(tally, crop):
    """IntraEncoder(mode="device") on a CROP x CROP crop of the photo, the
    Python loop: hevc_mode_search launched once a block size and nothing
    else; its maps against mode_search_plain on the same luma (a different
    mode only on a near tie, each named: block row, column, the kernel's
    and the plain search's mode); the stream decoded on the card equal to
    enc.recon; the same encoder given the plain maps writes the same
    bytes where no tie changed a mode."""
    img = image_of(crop, Colorspace.YCbCr, Chroma.C420)
    params = hevc_encoder.EncParams(qp=30, mode="device")
    enc = hevc_encoder.IntraEncoder(CROP, CROP, params)
    with launch_counts() as launches, trace.collect() as spans:
        t0 = time.perf_counter()
        nal, cfg = enc.encode(img)
        wall_ms = ms_since(t0)
    assert launches["hevc_mode_search"] == len(MODE_SIZES), launches
    others = {k: v for k, v in launches.items()
              if v and k != "hevc_mode_search"}
    assert not others, f"the mode='device' encode ran {others}"
    for name in ("hevc.encode", "hevc.encode.modes", "hevc.encode.copy",
                 "hevc.encode.loop", "hevc.encode.write"):
        assert name in spans, f"no {name} span"
    luma = crop[Channel.Y]
    plain, ties = {}, {}
    for lg in MODE_SIZES:
        b, r, (gh, gw) = device_modes.extract_blocks(luma, lg)
        pm, _ = hevc_fast.mode_search_plain(b, r, lg)
        got = torch.from_numpy(enc._device_plan[lg].reshape(-1)).to(DEV)
        idx = torch.nonzero(got != pm).reshape(-1)
        if idx.numel():
            ca = device_modes.mode_costs(b[idx], r[idx], lg, got[idx])
            cb = device_modes.mode_costs(b[idx], r[idx], lg, pm[idx])
            worst = float(((ca - cb).abs() / torch.clamp(
                torch.maximum(ca, cb), min=1e-300)).max())
            assert worst <= NEAR_TIE, f"log2 {lg}: the encoder's modes " \
                f"differ from the plain search's by {worst:.3g} of the cost"
        ties[lg] = [(i // gw, i % gw, int(got[i]), int(pm[i]))
                    for i in idx.tolist()]
        plain[lg] = pm.reshape(gh, gw)
        tally.checks["hevc_mode_search"] += 1
        tally.differing["hevc_mode_search"] += int(idx.numel())
    planes, dec_launches = decode_stream_on_card(cfg, [nal])
    diff = recon_differing(planes, enc.recon, YCC)
    assert not any(diff.values()), \
        f"mode='device': decode vs enc.recon {diff}"
    real = hevc_encoder.plan_modes_device
    hevc_encoder.plan_modes_device = lambda y, device=None: plain
    try:
        nal_plain, _ = hevc_encoder.IntraEncoder(CROP, CROP, params) \
            .encode(img)
    finally:
        hevc_encoder.plan_modes_device = real
    n_ties = sum(len(t) for t in ties.values())
    same = nal_plain == nal
    assert same or n_ties, "with no tie, the plain maps gave other bytes"
    out = {"shape": f"{CROP}x{CROP} at {CROP_AT}", "qp": 30,
           "bytes": len(nal), "launches": launches,
           "decode_launches": dec_launches, "wall_ms": wall_ms,
           "spans": dict(spans), "near_ties": ties,
           "plain_maps_same_bytes": same,
           "decode_vs_recon_differing": diff}
    log(f"check hevc encode mode=device {CROP}x{CROP}: hevc_mode_search "
        f"{launches['hevc_mode_search']} launches, near ties "
        f"{json.dumps(ties)}, decode equal to enc.recon, plain maps' bytes "
        f"{'equal' if same else 'differ (ties)'}, {wall_ms:.0f} ms, spans "
        f"{json.dumps(spans)}")
    return out


def check_ten_bit_encode(crop):
    """A CROP10 x CROP10 crop at 10 bits (the samples << 2, the low bits
    from the seed; uint16 planes) through IntraEncoder, the Python loop:
    decoded on the card equal to enc.recon."""
    g = torch.Generator(device=DEV)
    g.manual_seed(SEED + 17)
    ten = {ch: ((p.to(torch.int32) << 2) | torch.randint(
        0, 4, tuple(p.shape), generator=g, device=DEV, dtype=torch.int32))
        .to(torch.uint16)
        for ch, p in photo_crop(crop, CROP10, (0, 0)).items()}
    img = image_of(ten, Colorspace.YCbCr, Chroma.C420, bits=10)
    enc = hevc_encoder.IntraEncoder(
        CROP10, CROP10, hevc_encoder.EncParams(qp=30, bit_depth=10))
    with trace.collect() as spans:
        t0 = time.perf_counter()
        nal, cfg = enc.encode(img)
        wall_ms = ms_since(t0)
    assert "hevc.encode.loop" in spans, "the 10-bit encode left the loop"
    planes, dec_launches = decode_stream_on_card(cfg, [nal])
    diff = recon_differing(planes, enc.recon, YCC)
    assert not any(diff.values()), f"10-bit: decode vs enc.recon {diff}"
    log(f"check hevc encode 10-bit {CROP10}x{CROP10}: {len(nal)} B, decode "
        f"equal to enc.recon, {wall_ms:.0f} ms")
    return {"shape": f"{CROP10}x{CROP10}", "bytes": len(nal),
            "decode_launches": dec_launches, "wall_ms": wall_ms,
            "spans": dict(spans), "decode_vs_recon_differing": diff}


def check_av1_encode(crop):
    """The crop as an av01 item at quality 50, and a CROP_LOSSLESS crop of
    it lossless, through encode_image / write: each file equal to the CPU
    encode's, decoded on the card (av1_dequant_itx, av1_intra_wave) equal
    to the encoder's reconstruction, the lossless one equal to the
    source."""
    out = {}
    for name, opts, planes in (
            ("q50", EncodingOptions(quality=50), crop),
            ("lossless", EncodingOptions(lossless=True),
             photo_crop(crop, CROP_LOSSLESS, (0, 0)))):
        img = image_of(planes, Colorspace.YCbCr, Chroma.C420)
        img_cpu = cpu_copy(img)
        with encoders_made(av1_encoder.Av1IntraEncoder) as encs, \
                launch_counts() as launches, trace.collect() as spans:
            t0 = time.perf_counter()
            blob, _ = encode_file(img, "av1", opts)
            card_ms = ms_since(t0)
        assert len(encs) == 1
        for span in AV1_ENC_SPANS:
            assert span in spans, f"no {span} span"
        ran = {k: v for k, v in launches.items() if v}
        assert not ran, f"the av1 encode launched {ran}"
        t0 = time.perf_counter()
        cpu_blob, _ = encode_file(img_cpu, "av1", opts, device="cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        assert blob == cpu_blob, f"av1 {name}: the card's file differs " \
            "from the CPU encode's"
        with launch_counts() as dec_launches:
            card = HeifContext.read_from_bytes(blob).decode_image(None)
        for k in ("av1_dequant_itx", "av1_intra_wave"):
            assert dec_launches[k] > 0, f"the av1 decode did not launch {k}"
        got = [card.plane(ch) for ch in YCC]
        diff = recon_differing(got, encs[0].recon, YCC)
        assert not any(diff.values()), \
            f"av1 {name}: decode vs the encoder's reconstruction {diff}"
        if name == "lossless":
            src_diff = recon_differing(got, [img_cpu.plane(ch).numpy()
                                             for ch in YCC], YCC)
            assert not any(src_diff.values()), \
                f"av1 lossless: decode vs the source {src_diff}"
        quality = {ch: psnr(card.plane(ch), img.plane(ch)) for ch in YCC}
        out[name] = {"shape": f"{img.width}x{img.height}",
                     "bytes": len(blob), "decode_launches": dec_launches,
                     "card_ms": card_ms, "cpu_ms": cpu_ms,
                     "spans": dict(spans), "psnr_db": quality,
                     "decode_vs_recon_differing": diff}
        log(f"check av1 encode {name} {img.width}x{img.height}: "
            f"{len(blob)} B, equal to the CPU encode's, card decode equal to "
            f"the encoder's reconstruction, PSNR {json.dumps(quality)}, card "
            f"{card_ms:.0f} ms, CPU {cpu_ms:.0f} ms, spans "
            f"{json.dumps(spans)}")
    return out


def check_hevc_av1_encode(tally, src, planes):
    """The HEVC and AV1 encoders: the photo (with alpha) through the HEVC
    registry path, mode="device" and AV1 on a crop, 10-bit HEVC on a
    smaller one."""
    crop = photo_crop(planes, CROP)
    return {"hevc": check_hevc_photo_encode(src),
            "hevc_device_mode": check_device_mode_encode(tally, crop),
            "hevc_10bit": check_ten_bit_encode(crop),
            "av1": check_av1_encode(crop)}


def encode_round_trips(enc, name):
    """``name``'s launches in phase 4i's decodes of what the HEVC and AV1
    encoders wrote, by file or stream."""
    out = {f"hevc q{q}": r["decode_launches"][name]
           for q, r in enc["hevc"].items()}
    out["hevc mode=device"] = \
        enc["hevc_device_mode"]["decode_launches"][name]
    out["hevc 10-bit"] = enc["hevc_10bit"]["decode_launches"][name]
    out.update({f"av1 {k}": r["decode_launches"][name]
                for k, r in enc["av1"].items()})
    return out


def check_encode(tally, photo, flagship):
    """Phase 4i.  ``photo``: the HEVC photo's file; ``flagship``: the
    main path's decoded 4096x4096 image."""
    src_ycc = HeifContext.read_from_bytes(photo).decode_image(None)
    assert (src_ycc.width, src_ycc.height, src_ycc.chroma) == \
        (*PHOTO, Chroma.C420)
    planes = {ch: src_ycc.plane(ch).to(torch.uint8)
              for ch in (Channel.Y, Channel.Cb, Channel.Cr)}
    ycc = image_of(planes, Colorspace.YCbCr, Chroma.C420)
    alpha = alpha_gradient(*PHOTO)
    src = image_of({**planes, Channel.Alpha: alpha}, Colorspace.YCbCr,
                   Chroma.C420)
    alpha_img = image_of({Channel.Y: alpha}, Colorspace.Monochrome,
                         Chroma.Monochrome)
    out = {"jpeg": check_jpeg_encode(src)}
    photo_jobs, quant = check_fdct_kernel(tally, ycc, alpha_img)
    out["unci"] = check_unci_encode(flagship)
    out["mski"] = check_mski_encode(*PHOTO)
    out["mode_search"] = check_mode_search(tally, planes[Channel.Y])
    out["encode_timing"] = time_jpeg_encode(ycc)
    out.update(check_hevc_av1_encode(tally, src, planes))
    return out, ycc, planes[Channel.Y]


def jpeg_fdct_row(timer, tally, ycc, launches):
    """jpeg_fdct_quant's row at the photo's shapes (its three planes,
    q 90, one launch): the kernel, the plain version, the bounds."""
    quant = jpeg_encoder.quant_tables(90, 2, DEV)
    sets = [jpeg_encoder.component_jobs(ycc)[0]]
    sets.append([j._replace(plane=j.plane.clone()) for j in sets[0]])
    blocks = sum(j.blocks_w * j.blocks_h for j in sets[0])
    # the planes read once, the coefficients written once, the tables and
    # the job table once
    nbytes = sum(j.plane.numel() for j in sets[0]) + blocks * 128 + \
        quant.numel() * 4 + len(sets[0]) * (jpeg_fast.FQ_JOB_COLS + 1) * 4
    nops = blocks * 64 * FDCT_OPS_PER_SAMPLE
    b = bounds(nbytes, nops)
    kernel_ms, table_copy_ms = kernel_timing.kernel_ms(
        torch, [lambda s=s: jpeg_fast.fdct_quant(s, quant) for s in sets],
        20, "jpeg_fdct_quant")
    row = {
        "name": "jpeg_fdct_quant", "route": "cuda", "source": JPEG_SOURCE,
        "replaces": f"{ENC_JNP}:45",
        "also_replaces": [f"{ENC_JNP}:74",
                          "libheif_tpu/codecs/jpeg/idct.py:100"],
        "launches": launches,
        "max_abs_err": tally.max_abs_err["jpeg_fdct_quant"],
        "ms": timer([lambda s=s: jpeg_fast.fdct_quant(s, quant)
                     for s in sets]),
        "kernel_ms": kernel_ms, "table_copy_ms": table_copy_ms,
        "plain_ms": timer([lambda: fdct_plain(sets[0], quant)], n=2),
        **b, "library_ms": None,
        "library_note": "no one PyTorch call computes the islow FDCT with "
                        "its fixed-point roundings and the JPEG quantiser",
        "checks": tally.checks["jpeg_fdct_quant"],
        "differing_coefficients": tally.differing["jpeg_fdct_quant"],
        "bytes": nbytes, "ops": nops, "blocks": blocks,
        **ptxas_resources("jpeg_fdct_quant_kernel")}
    log(f"jpeg fdct kernel {json.dumps(row)}")
    return row


def mode_search_work(n_blocks, log2):
    """(bytes, FP32 operations) of hevc_mode_search on n_blocks blocks:
    the samples and references read once, a mode and a cost written; per
    block the non-zero taps' multiply-adds of every mode but DC (the
    residual folded into the first tap's), DC's 2n adds (its residual
    shifts one Hadamard coefficient), and per mode the butterflies but the
    last column stage, (2 log2(n) - 1) n^2 adds, and that stage with the
    absolute sum as one max and one add a pair (|a + b| + |a - b| =
    2 max(|a|, |b|)): 2 n^2 log2(n) a mode."""
    n = 1 << log2
    _, w = hevc_fast.mode_taps(log2)
    taps = int((w != 0).sum())
    nbytes = n_blocks * ((n * n + 4 * n + 1) * 4 + 8)
    per_block = taps + 2 * n + len(device_modes.MODES) * 2 * n * n * log2
    return nbytes, n_blocks * per_block


def mode_search_launches(enc):
    """hevc_mode_search's launches in phase 4i, by path: plan_modes_device
    on the photo's luma, and IntraEncoder(mode="device") on the crop."""
    return {"plan_modes_device photo luma":
            enc["mode_search"]["launches"]["hevc_mode_search"],
            "IntraEncoder mode=device crop":
            enc["hevc_device_mode"]["launches"]["hevc_mode_search"]}


def mode_search_row(timer, tally, luma, by_path):
    """hevc_mode_search's row at the photo's luma, n = 8 (190,512 blocks):
    the kernel, the plain version, the bounds (bytes; FP32 lanes x clock),
    and the other sizes; the dense prediction product alone as one
    torch.matmul (TF32 off) is a partial yardstick."""
    by_size = {}
    for lg in MODE_SIZES:
        blk, ref, _ = device_modes.extract_blocks(luma, lg)
        sets = [(blk, ref), (blk.clone(), ref.clone())]
        nbytes, nops = mode_search_work(blk.shape[0], lg)
        b = bounds(nbytes, nops, fp32_rate())
        n = 1 << lg
        W = torch.from_numpy(device_modes.all_weights(lg).reshape(
            -1, 4 * n + 1)).to(DEV)
        with hevc_fast._no_tf32():
            partial = timer([lambda r=r: torch.matmul(r, W.T)
                             for _, r in sets], n=5)
        by_size[lg] = {
            "blocks": blk.shape[0],
            "ms": timer([lambda s=s: hevc_fast.mode_search(*s, lg)
                         for s in sets]),
            "plain_ms": timer([lambda: hevc_fast.mode_search_plain(
                blk, ref, lg)], n=2),
            **b, "bytes": nbytes, "ops": nops,
            "partial_yardstick_dense_prediction_matmul_ms": partial,
            **ptxas_resources(f"hevc_mode_search_kernelILi{lg}E")}
        del sets
    top = by_size[MODE_SIZES[0]]
    row = {
        "name": "hevc_mode_search", "route": "cuda",
        "source": HEVC_SOURCE, "replaces": f"{MODES_JNP}:161",
        "also_replaces": [f"{MODES_JNP}:183"],
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": tally.max_abs_err["hevc_mode_search"],
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "byte_bound_ms": top["byte_bound_ms"],
        "op_bound_ms": top["op_bound_ms"], "library_ms": None,
        "library_note": "no one PyTorch call does the search; the dense "
                        "prediction product alone (one torch.matmul, TF32 "
                        "off) is a partial yardstick, by size",
        "checks": tally.checks["hevc_mode_search"],
        "near_tie_disagreements": tally.differing["hevc_mode_search"],
        "max_abs_err_is": "the least costs' largest difference",
        "by_size": by_size, "fp32_ops_per_s": fp32_rate(),
        **ptxas_resources("hevc_mode_search_kernel")}
    log(f"hevc mode search kernel {json.dumps(row)}")
    return row


# ------------------------------------------------------------ write API (4j)
# Tracks and items written through HeifContext on the card: inter hvc1
# tracks from the port's SequenceEncoder (its references decoded by the
# port's decoder on the card) held to the JAX writer's SHA-256 of the same
# calls (ENC_MANIFEST, tests/test_torch_track_write.py --write-fixtures),
# 1920x1080 all-intra, mjpg and uncv tracks, a file with everything else a
# track carries, and the item writers, each against the same calls on the
# CPU.

ENC_MANIFEST = os.path.join(SEQ_DIR, "encode_manifest.json")
HD_TRACK = (1920, 1080, 8)       # the 1920x1080 tracks: width, height, frames
HD_SEED = 21
ITEM_TILE = 512                  # the grid's and the tili's tiles
WRITE_SPANS = ("hevc.encode.seq", "hevc.encode.seq.copy",
               "hevc.encode.seq.loop", "hevc.encode.seq.recon",
               "hevc.encode.seq.write", "hevc.encode", "track.write",
               "track.write.finalize")


def enc_manifest():
    with open(ENC_MANIFEST) as f:
        return json.load(f)


def scene_image(f, device):
    """A panning_scene frame (numpy Y, Cb, Cr) as a PixelImage on
    ``device``."""
    return image_of({c: torch.from_numpy(p).to(device) for c, p in
                     zip((Channel.Y, Channel.Cb, Channel.Cr), f)},
                    Colorspace.YCbCr, Chroma.C420)


def sample_nal_types(t):
    """The NAL type of each sample's first NAL (4-byte lengths)."""
    return [(bytes(t.sample_data(i))[4] >> 1) & 0x3F
            for i in range(t.num_samples)]


def check_inter_track(name, spec, seed):
    """One inter hvc1 track (phase 4j): encoded through add_visual_track
    on the card, with the launch counts and spans read around the encode;
    its SHA-256 against the JAX writer's; every frame read back on the
    card in output order equal to the encoder's DPB picture (cropped), or
    for a non-reference B to the CPU decode of the same file, each then
    converted to RGB."""
    w, h, n, gop = (spec[k] for k in ("width", "height", "frames", "gop"))
    frames = inter_cases.panning_scene(w, h, n, seed)
    ctx = HeifContext()
    tw = ctx.add_visual_track(w, h, "hevc", options=TrackOptions(
        timescale=30, inter_frames=gop))
    recon, frame_ms = {}, []
    t0 = time.perf_counter()
    with launch_counts() as launches, trace.collect() as spans:
        for f in frames:
            t1 = time.perf_counter()
            tw.add_frame(scene_image(f, DEV), duration=1,
                         options=EncodingOptions(quality=50))
            frame_ms.append(ms_since(t1))
            recon.update(tw._enc_session.enc.dpb)
        t1 = time.perf_counter()
        blob = ctx.write()
        write_ms = ms_since(t1)
        recon.update(tw._enc_session.enc.dpb)
    wall_ms = ms_since(t0)
    digest = hashlib.sha256(blob).hexdigest()
    log(f"check track {name} {w}x{h} {gop} {n} frames: {len(blob)} B, "
        f"SHA-256 {'equal to' if digest == spec['sha256'] else 'NOT'} "
        "the JAX writer's")
    assert digest == spec["sha256"], f"{name}: not the JAX writer's bytes"

    card = HeifContext.read_from_bytes(blob).tracks[0]
    types = sample_nal_types(card)
    refs = types.count(1)            # TRAIL_R: the P and kept B pictures
    assert types.count(19) == 1 and refs + types.count(0) == n - 1, types
    assert sorted(recon) == sorted(s.pts for s, t in
                                   zip(card.samples, types) if t != 0)
    assert launches["hevc_inter_pred"] == refs, \
        f"{name}: hevc_inter_pred {launches['hevc_inter_pred']} launches " \
        f"for {refs} reference P/B pictures"
    assert launches["hevc_intra_wave"] == 1, f"not one intra wave (the IDR): {launches}"
    assert 1 <= launches["hevc_dequant_itx"] <= refs + 1, launches
    assert spans["hevc.encode.seq.recon"]["count"] == refs + 1

    # the CPU decodes the track in order alongside, where a frame is not
    # a reference picture (random access would restart at the IDR)
    cpu = HeifContext.read_from_bytes(blob, device="cpu").tracks[0] \
        if len(recon) < n else None
    n_diff = n_cpu = 0
    for i in range(n):
        with launch_counts() as read_launches:
            img = card.decode_next_image()
            convert_image(img, Colorspace.RGB, Chroma.InterleavedRGB)
        assert read_launches["planes_ycbcr8_to_rgb"] == 1, read_launches
        ref = recon.get(i)
        cpu_img = cpu.decode_next_image() if cpu is not None else None
        n_cpu += ref is None
        for k, c in enumerate((Channel.Y, Channel.Cb, Channel.Cr)):
            got = img.plane(c).to(torch.int32).cpu()
            want = cpu_img.plane(c).to(torch.int32) if ref is None else \
                torch.from_numpy(ref[k][:got.shape[0], :got.shape[1]])
            n_diff += int((got != want).sum())
    log(f"check track {name} read back on the card: {n} frames, "
        f"{n - n_cpu} against the encoder's DPB, {n_cpu} non-reference "
        f"against the CPU decode: differing {n_diff}")
    assert n_diff == 0, f"{name}: the read-back differs"
    out = {"bytes": len(blob), "frames": n, "gop": gop,
           "reference_pictures": refs, "encode_wall_ms": wall_ms,
           "frame_ms": frame_ms, "write_ms": write_ms,
           "launches": {k: launches[k] for k in
                        ("hevc_inter_pred", "hevc_dequant_itx",
                         "hevc_intra_wave")},
           "spans": {k: spans[k] for k in WRITE_SPANS if k in spans}}
    log(f"track {name} encode {json.dumps(out)}")
    return out


@contextlib.contextmanager
def intra_encodes():
    """While inside, each IntraEncoder.encode's (slice NAL, closed-loop
    reconstruction: uncropped int32 planes) is appended to the list
    yielded."""
    real = hevc_encoder.IntraEncoder.encode
    out = []

    def spy(self, img):
        nal, cfg = real(self, img)
        out.append((nal, self.recon))
        return nal, cfg
    hevc_encoder.IntraEncoder.encode = spy
    try:
        yield out
    finally:
        hevc_encoder.IntraEncoder.encode = real


def hd_track(fmt, device, frames):
    """A 1920x1080 track of ``fmt`` written on ``device`` from ``frames``:
    (the file, the launch counts, the encode's wall ms, each intra
    encode's (NAL, reconstruction))."""
    w, h, _ = HD_TRACK
    ctx = HeifContext(device=device)
    tw = ctx.add_visual_track(w, h, fmt, timescale=30)
    t0 = time.perf_counter()
    with launch_counts() as launches, intra_encodes() as encodes:
        for f in frames:
            tw.add_frame(scene_image(f, device), duration=1,
                         options=EncodingOptions(quality=50))
        blob = ctx.write()
    return blob, launches, ms_since(t0), encodes


def recon_diff(img, sample, encode):
    """Samples of ``img`` (a decoded hvc1 track frame) differing from the
    closed-loop reconstruction of the intra encode that wrote it, whose
    NAL must be the track's sample."""
    nal, recon = encode
    assert sample == len(nal).to_bytes(4, "big") + nal, "hvc1 sample"
    n = 0
    for c, r in zip((Channel.Y, Channel.Cb, Channel.Cr), recon):
        got = img.plane(c).cpu().to(torch.int32)
        n += int((got != torch.from_numpy(
            r[:got.shape[0], :got.shape[1]])).sum())
    return n


def check_hd_tracks():
    """The 1920x1080 all-intra hvc1 (the C++ path), mjpg (jpeg_fdct_quant
    once a frame) and uncv tracks: each file equal to the same calls on
    the CPU; each frame decoded on the card equal to its CPU decode, but
    for hvc1, whose CPU decode (the plain intra waves) takes seconds a
    frame: frame 0 against its CPU decode, and every frame against the
    reconstruction of the intra encode that wrote it."""
    w, h, n = HD_TRACK
    frames = inter_cases.panning_scene(w, h, n, HD_SEED)
    out = {}
    for fmt in ("hevc", "jpeg", "unc"):
        blob, launches, wall_ms, encodes = hd_track(fmt, DEV, frames)
        assert blob == hd_track(fmt, "cpu", frames)[0], \
            f"{fmt} track: the card's file differs from the CPU's"
        if fmt == "jpeg":
            assert launches["jpeg_fdct_quant"] == n, launches
        assert len(encodes) == (n if fmt == "hevc" else 0)
        card = HeifContext.read_from_bytes(blob).tracks[0]
        cpu = HeifContext.read_from_bytes(blob, device="cpu").tracks[0]
        against_cpu = (0,) if fmt == "hevc" else tuple(range(n))
        n_diff = 0
        for i in range(n):
            img = card.decode_sample(i)
            if i in against_cpu:
                ref = cpu.decode_sample(i)
                n_diff += sum(int((img.plane(c).cpu() != ref.plane(c)).sum())
                              for c in (Channel.Y, Channel.Cb, Channel.Cr))
            if fmt == "hevc":
                n_diff += recon_diff(img, bytes(card.sample_data(i)),
                                     encodes[i])
        log(f"check track {fmt} {w}x{h} {n} frames: {len(blob)} B equal to "
            f"the CPU write; card decodes vs CPU decodes of frames "
            f"{list(against_cpu)}"
            f"{', every frame vs the encoder reconstruction' if fmt == 'hevc' else ''}"
            f": differing {n_diff}; encode {wall_ms:.1f} ms")
        assert n_diff == 0, f"{fmt} track: the card's decode differs"
        out[fmt] = {"bytes": len(blob), "encode_wall_ms": wall_ms,
                    "launches": {k: v for k, v in launches.items() if v}}
    return out


def everything_track_file(device):
    """A still and an ibp track with mandatory TAI and GIMI ids, a URI
    metadata track, an alpha auxv track (auxl), 3 repetitions and a
    timescale of 25, written on ``device``."""
    ctx = HeifContext(device=device)
    rng = np.random.default_rng(SEED + 40)
    still = {c: torch.from_numpy(rng.integers(0, 256, (64, 64),
                                              dtype=np.uint8)).to(device)
             for c in (Channel.Y, Channel.Cb, Channel.Cr)}
    ctx.encode_image(image_of(still, Colorspace.YCbCr, Chroma.C444), "unci")
    ctx.set_number_of_sequence_repetitions(3)
    ctx.set_sequence_timescale(25)
    tw = ctx.add_visual_track(128, 96, "hevc", options=TrackOptions(
        timescale=25, with_tai_timestamps=1,
        tai_clock_info=TaiClockInfo(clock_type=1), with_gimi_content_ids=1,
        gimi_track_content_id="urn:uuid:phase-4j", inter_frames="ibp"))
    at = ctx.add_visual_track(128, 96, "unc", timescale=25, handler="auxv",
                              aux_type_urn=ALPHA_URN)
    at.add_reference_to_track("auxl", tw.track_id)
    mt = ctx.add_uri_metadata_track("urn:test:telemetry", timescale=25)
    for i, f in enumerate(inter_cases.panning_scene(128, 96, 5, SEED + 41)):
        tw.add_frame(scene_image(f, device), duration=1,
                     tai=TaiTimestampPacket(tai_timestamp=10**18 + i),
                     gimi_content_id=f"urn:uuid:sample-{i}")
        alpha = torch.full((96, 128), 40 * i, dtype=torch.uint8,
                           device=device)
        at.add_frame(image_of({Channel.Y: alpha}, Colorspace.Monochrome,
                              Chroma.Monochrome), duration=1)
        mt.add_metadata_sample(f"gps={i}".encode(), duration=1)
    return ctx.write()


def check_everything_track():
    """The file with everything a track carries, written on the card and
    on the CPU (equal), reopened on the card and on the CPU: the same
    tables, aux info, metadata samples and frames (the master with its
    alpha merged)."""
    blob = everything_track_file(DEV)
    assert blob == everything_track_file("cpu"), "tracks file differs"
    card, cpu = (HeifContext.read_from_bytes(blob, device=d)
                 for d in (None, "cpu"))
    assert (card.sequence_timescale(), card.sequence_duration()) == \
        (cpu.sequence_timescale(), cpu.sequence_duration()) == (25, 15)
    assert len(card.tracks) == len(cpu.tracks) == 3
    for t, c in zip(card.tracks, cpu.tracks):
        assert [vars(s) for s in t.samples] == [vars(s) for s in c.samples]
        assert (t.num_repetitions, t.reference_types(),
                t.sample_aux_info_types()) == \
            (c.num_repetitions, c.reference_types(),
             c.sample_aux_info_types()) and t.num_repetitions == 3
        for i in range(t.num_samples):
            assert t.sample_gimi_content_id(i) == c.sample_gimi_content_id(i)
            a, b = t.sample_tai_timestamp(i), c.sample_tai_timestamp(i)
            assert (a is None) == (b is None) and \
                (a is None or a.tai_timestamp == b.tai_timestamp)
    master = next(t for t in card.tracks if getattr(t, "alpha_track", None))
    cmaster = next(t for t in cpu.tracks if getattr(t, "alpha_track", None))
    assert master.gimi_track_content_id() == "urn:uuid:phase-4j"
    assert master.tai_clock_info().clock_type == 1
    for i in range(master.num_samples):
        same_image(f"tracks file frame {i} with alpha",
                   master.decode_next_image(), cmaster.decode_next_image())
    meta = next(t for t in card.tracks if t.handler == "meta")
    assert [bytes(meta.metadata_sample(i)) for i in range(5)] == \
        [f"gps={i}".encode() for i in range(5)]
    log(f"check tracks file (still, ibp track with TAI/GIMI, metadata "
        f"track, alpha track, 3 repetitions, timescale 25): {len(blob)} B "
        "equal to the CPU write, same tables on the card and the CPU")
    return len(blob)


def item_files(device):
    """The item writers on ``device``: {name: file bytes} of a 2x2 grid
    of hvc1 tiles (with a thumbnail, Exif, XMP, a region and a text item),
    an overlay, a tili of four unci tiles, and an hvc1 still with alpha
    and Exif written as mini."""
    side = 2 * ITEM_TILE
    f = inter_cases.panning_scene(side, side, 1, SEED + 42)[0]
    big = scene_image(f, device)
    out = {}

    def crop(x, y, w, h, chroma=Chroma.C420):
        planes = {c: big.plane(c)[(y >> s):(y + h) >> s, (x >> s):(x + w) >> s]
                  .contiguous() for c, s in ((Channel.Y, 0), (Channel.Cb, 1),
                                              (Channel.Cr, 1))}
        return image_of(planes, Colorspace.YCbCr, chroma)

    ctx = HeifContext(device=device)
    tiles = [ctx.encode_image(crop(x * ITEM_TILE, y * ITEM_TILE, ITEM_TILE,
                                   ITEM_TILE), "hevc",
                              EncodingOptions(quality=60))
             for y in range(2) for x in range(2)]
    gid = ctx.add_grid_image(tiles, side, side, 2, 2)
    ctx.set_primary_item(gid)
    ctx.add_thumbnail(gid, crop(0, 0, 128, 128), "jpeg")
    ctx.add_exif(gid, b"MM\x00*\x00\x00\x00\x08" + bytes(16))
    ctx.add_xmp(gid, b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>")
    ri = ctx.add_region_item(gid, side, side)
    ri.regions = [RegionGeometry(kind="rect", x=10, y=20, width=300,
                                 height=200),
                  RegionGeometry(kind="polygon",
                                 points=[(0, 0), (500, 10), (250, 400)])]
    ctx.add_text_item(gid, "phase 4j grid")
    out["grid"] = ctx.write()

    ctx = HeifContext(device=device)
    rng = np.random.default_rng(SEED + 43)
    layers = [ctx.encode_image(image_of(
        {c: torch.from_numpy(rng.integers(0, 256, (hh, ww), dtype=np.uint8))
         .to(device) for c in (Channel.R, Channel.G, Channel.B)},
        Colorspace.RGB, Chroma.C444), "unci") for ww, hh in ((96, 64),
                                                             (40, 32))]
    ctx.set_primary_item(ctx.add_overlay_image(
        120, 80, layers, offsets=[(0, 0), (70, 40)],
        background_rgba=(0, 65535, 0, 65535)))
    out["overlay"] = ctx.write()

    ctx = HeifContext(device=device)
    tid = ctx.add_tiled_image(side, side, ITEM_TILE, ITEM_TILE, fmt="unci")
    for y in range(2):
        for x in range(2):
            ctx.add_image_tile_to_tiled(tid, x, y, crop(
                x * ITEM_TILE, y * ITEM_TILE, ITEM_TILE, ITEM_TILE))
    out["tili"] = ctx.write()

    ctx = HeifContext(device=device)
    ctx.set_write_mini_format(True)
    still = crop(0, 0, ITEM_TILE, ITEM_TILE)
    still.set_plane(Channel.Alpha, alpha_gradient(ITEM_TILE, ITEM_TILE)
                    .to(device), 8)
    ctx.add_exif(ctx.encode_image(still, "hevc",
                                  EncodingOptions(quality=50)),
                 b"II*\x00\x08\x00\x00\x00")
    out["mini"] = ctx.write()
    return out


def check_item_writers():
    """Phase 4j's item files: each equal to the CPU write byte for byte,
    its decodes on the card equal to the CPU's; the tili tile by tile
    (strided_extract_paste once a tile)."""
    blobs = item_files(DEV)
    cpu = item_files("cpu")
    for name, blob in blobs.items():
        assert blob == cpu[name], f"{name}: the card's file differs"
    assert blobs["mini"][4:12] == b"ftypmif3", "not written as mini"
    decode_both("written grid", blobs["grid"])
    ctx = HeifContext.read_from_bytes(blobs["grid"])
    gid = ctx.primary_item_id
    thumb, = ctx.get_item(gid).thumbnails
    same_image("written thumbnail", ctx.decode_image(thumb.item_id),
               HeifContext.read_from_bytes(blobs["grid"], device="cpu")
               .decode_image(thumb.item_id))
    assert ctx.get_exif(gid) == b"MM\x00*\x00\x00\x00\x08" + bytes(16)
    assert ctx.get_xmp(gid).startswith(b"<x:xmpmeta")
    assert [len(r.regions) for r in ctx.get_region_items(gid)] == [2]
    assert [t.text for t in ctx.get_text_items(gid)] == ["phase 4j grid"]
    decode_both("written overlay", blobs["overlay"])
    card, cpu_ctx = (HeifContext.read_from_bytes(blobs["tili"], device=d)
                     for d in (None, "cpu"))
    tid = card.primary_item_id
    xy = [(x, y) for y in range(2) for x in range(2)]
    with launch_counts() as tili:
        got = [card.decode_tile(tid, x, y) for x, y in xy]
    assert tili["strided_extract_paste"] == 4, tili
    for (x, y), img in zip(xy, got):
        same_image(f"written tili tile {x},{y}", img,
                   cpu_ctx.decode_tile(tid, x, y))
    decode_both("written mini with alpha", blobs["mini"])
    assert HeifContext.read_from_bytes(blobs["mini"]).get_exif(
        HeifContext.read_from_bytes(blobs["mini"]).primary_item_id) == \
        b"II*\x00\x08\x00\x00\x00"
    log(f"check item writers: "
        f"{ {k: len(v) for k, v in blobs.items()} } B, each equal to the "
        "CPU write")
    return {k: len(v) for k, v in blobs.items()}


def check_write():
    """Phase 4j: the inter tracks of the manifest, the 1920x1080 tracks,
    the file with everything a track carries and the item writers."""
    t0 = time.perf_counter()
    man = enc_manifest()
    out = {"tracks": {}, "step_seconds": {}}

    def step(name, fn, *args):
        t1 = time.perf_counter()
        result = fn(*args)
        out["step_seconds"][name] = time.perf_counter() - t1
        return result
    for name, spec in man["tracks"].items():
        out["tracks"][name] = step(name, check_inter_track, name, spec,
                                   man["seed"])
    out["hd_tracks"] = step("hd_tracks", check_hd_tracks)
    out["tracks_file_bytes"] = step("tracks_file", check_everything_track)
    out["items"] = step("items", check_item_writers)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 4j steps (s) {json.dumps(out['step_seconds'])}")
    log(f"phase 4j (write API) took {out['seconds']:.1f} s")
    return out


def write_launches(wr, name):
    """``name``'s launches in phase 4j's encodes, by track: the inter
    tracks' closed loops for the HEVC kernels, the mjpg track for
    jpeg_fdct_quant."""
    if name == "jpeg_fdct_quant":
        return {"mjpg track 1920x1080":
                wr["hd_tracks"]["jpeg"]["launches"].get(name, 0)}
    return {f"track encode {n}": r["launches"][name]
            for n, r in wr["tracks"].items()}


# ---------------------------------------------------------------------- AVC
# Phase 4k: AVC decode on the host (the C++ intra engine for CABAC intra
# pictures, Python for CAVLC and P pictures), each picture's planes copied
# to the card once, the colour conversion there.

AVC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "libheif_tpu_torch", "testdata", "avc")
AVC_HD = "hd-1920x1080"
AVC_CAVLC = "cavlc-256"
AVC_MONO = "mono-128x96"
# the committed tracks and the frames decode_sample reads after the
# in-order pass: an earlier one (a restart at the IDR), then a later one
AVC_TRACKS = {"seq-cif-cabac": (2, 6), "seq-qcif-cavlc": (1, 4)}
AVC_PLANES = (("Y", Channel.Y), ("U", Channel.Cb), ("V", Channel.Cr))


def avc_streams():
    with open(os.path.join(AVC_DIR, "manifest.json")) as f:
        return {e["name"]: e for e in json.load(f)["streams"]}


def avc_parts(e):
    """(SPS list, PPS list, slice NALs) of a committed annex-B stream."""
    with open(os.path.join(AVC_DIR, e["file"]), "rb") as f:
        nals = avc_headers.split_annexb(f.read())
    kinds = [avc_headers.nal_type(n) for n in nals]
    return ([n for n, k in zip(nals, kinds) if k == avc_headers.NAL_SPS],
            [n for n, k in zip(nals, kinds) if k == avc_headers.NAL_PPS],
            [n for n, k in zip(nals, kinds)
             if k in (avc_headers.NAL_SLICE_IDR,
                      avc_headers.NAL_SLICE_NON_IDR)])


def avc_config(sps, pps):
    cfg = Box_avcC()
    cfg.avc_profile, cfg.avc_level = sps[0][1], sps[0][3]
    cfg.sps_list, cfg.pps_list = list(sps), list(pps)
    return cfg


def length_prefixed(nals):
    return b"".join(len(n).to_bytes(4, "big") + n for n in nals)


def avc_hashes(img):
    """SHA-256 of each uint8 plane under the manifest's names (Y, U, V;
    Y alone for a monochrome image)."""
    return {k: hashlib.sha256(img.np_plane(ch).tobytes()).hexdigest()
            for k, ch in AVC_PLANES if img.has_channel(ch)}


def add_avc1(f, e, hidden=True):
    """An avc1 item holding stream ``e``: its slices with 4-byte lengths,
    an avcC with its SPS and PPS, and ispe."""
    sps, pps, slices = avc_parts(e)
    item = f.add_new_item("avc1").item_id
    f.append_item_data(item, length_prefixed(slices))
    f.add_property(item, avc_config(sps, pps), True)
    f.add_property(item, Box_ispe(e["width"], e["height"]), False)
    f.get_infe(item).hidden = hidden
    return item


def avc_photo_file(streams):
    """The AVC phone photo: 48 hidden avc1 items (item i holds stream
    PHOTO_TILES[i mod 4]) in a 6x8 grid with a 4032x3024 output."""
    f = new_file()
    rows, cols = PHOTO_GRID
    ids = [add_avc1(f, streams[PHOTO_TILES[i % 4]])
           for i in range(rows * cols)]
    grid = f.add_new_item("grid").item_id
    f.append_item_data(grid, ImageGrid(rows, cols, *PHOTO).write(), 1)
    f.add_property(grid, Box_ispe(*PHOTO), False)
    f.add_reference("dimg", grid, ids)
    f.set_primary_item(grid)
    return f.write()


def avc1_file(e):
    f = new_file()
    f.set_primary_item(add_avc1(f, e, hidden=False))
    return f.write()


def avc1_tili_file(streams):
    """A 1024x1024 tili of the four 512x512 photo tiles, each tile
    carrying its SPS and PPS in band, the first one's avcC in tilC."""
    tiles = [length_prefixed(sum(avc_parts(streams[n]), []))
             for n in PHOTO_TILES]
    sps, pps, _ = avc_parts(streams[PHOTO_TILES[0]])
    return tili_file(tiles, 1024, 1024, 512, 512, "avc1",
                     [avc_config(sps, pps)])


def avc_sequence(e, device):
    """Every frame of committed sequence ``e`` through AvcDecoder's
    session on ``device``, a slice a sample."""
    sps, pps, slices = avc_parts(e)
    session = AvcDecoder(device).start_sequence(avc_config(sps, pps))
    frames = []
    for s in slices:
        session.push_sample(length_prefixed([s]))
        while (img := session.pull()) is not None:
            frames.append(img)
    return frames


def check_avc_streams(streams):
    """Every committed stream through AvcDecoder on the card and on the
    CPU: the same planes, equal to libavcodec's (the manifest); the
    weighted-prediction stream refused on both."""
    out = {}
    for name, e in streams.items():
        t0 = time.perf_counter()
        if e["kind"] == "still":
            sps, pps, slices = avc_parts(e)
            cfg, data = avc_config(sps, pps), length_prefixed(slices)
            card = AvcDecoder(DEV).decode_single_image(cfg, data)
            same_image(f"avc {name}", card,
                       AvcDecoder("cpu").decode_single_image(cfg, data))
            assert avc_hashes(card) == e["sha256"], name
        elif "refused" in e:
            for device in (DEV, "cpu"):
                try:
                    avc_sequence(e, device)
                except HeifError as err:
                    assert e["refused"] in str(err), (name, str(err))
                else:
                    raise AssertionError(f"{name} was not refused")
        else:
            card = avc_sequence(e, DEV)
            cpu = avc_sequence(e, "cpu")
            assert len(card) == len(cpu) == e["frames"], name
            for i, (a, b) in enumerate(zip(card, cpu)):
                same_image(f"avc {name} frame {i}", a, b)
                assert avc_hashes(a) == e["sha256"][i], (name, i)
        out[name] = ms_since(t0)
        log(f"check avc stream {name:22s} equal to the manifest and the "
            f"CPU ({out[name]:.0f} ms)")
    return out


def avc_photo_singles(streams):
    """The photo tiles' CPU decodes, each equal to the manifest."""
    singles = {}
    for n in PHOTO_TILES:
        sps, pps, slices = avc_parts(streams[n])
        singles[n] = AvcDecoder("cpu").decode_single_image(
            avc_config(sps, pps), length_prefixed(slices))
        assert avc_hashes(singles[n]) == streams[n]["sha256"], n
    return singles


def check_avc_photo(tally, blob, streams):
    """The AVC photo through HeifContext to interleaved RGB: its launches
    and spans read around the decode; the YCbCr planes handed to the
    output conversion against the single tiles' CPU decodes placed where
    the grid puts them; the RGB against planes_ycbcr8_to_rgb's plain
    version on the card (exact) and the whole decode on the CPU (the
    colour contract).  Returns (launches, the decode's parts, RGB)."""
    seen = []
    real_convert = context_mod.convert_image

    def convert(img, *args, **kw):
        seen.append(img)
        return real_convert(img, *args, **kw)
    context_mod.convert_image = convert
    try:
        with launch_counts() as launches, trace.collect() as spans:
            t0 = time.perf_counter()
            ctx = HeifContext.read_from_bytes(blob)
            file_ms = ms_since(t0)
            rgb = ctx.decode_image(None, Colorspace.RGB,
                                   Chroma.InterleavedRGB)
            first_ms = ms_since(t0)
    finally:
        context_mod.convert_image = real_convert
    parts = {"total_ms": first_ms, "file_parse_ms": file_ms,
             "spans": spans}
    log(f"avc photo launches {launches} in {first_ms:.1f} ms, by part "
        f"{json.dumps(parts)}")
    n = PHOTO_GRID[0] * PHOTO_GRID[1]
    for s in ("avc.decode", "avc.decode.native", "avc.decode.copy"):
        assert spans[s]["count"] == n, (s, spans[s])
    assert "avc.decode.python" not in spans
    assert launches["planes_ycbcr8_to_rgb"] == 1, launches
    assert sum(launches[k] for k in ALL_KERNELS) == 1, launches
    assert launches["assemble_tile_buffers"] == 0
    inter = rgb.plane(Channel.Interleaved)
    assert (rgb.width, rgb.height) == PHOTO and inter.dtype == torch.uint8 \
        and tuple(inter.shape) == (PHOTO[1], PHOTO[0] * 3) \
        and inter.device.type == DEV
    img, = seen
    assert (img.width, img.height, img.colorspace, img.chroma) == \
        (*PHOTO, Colorspace.YCbCr, Chroma.C420)
    singles = avc_photo_singles(streams)
    rows, cols = PHOTO_GRID
    n_diff = 0
    for i in range(rows * cols):
        ty, tx = divmod(i, cols)
        for _, ch in AVC_PLANES:
            t = 512 // (1 if ch == Channel.Y else 2)
            got = img.plane(ch)[ty * t:ty * t + t, tx * t:tx * t + t].cpu()
            h, w = got.shape
            n_diff += int((got != singles[PHOTO_TILES[i % 4]].plane(ch)
                           [:h, :w]).sum())
    log(f"check avc photo YCbCr (card) vs the single tiles' CPU decodes "
        f"placed: differing {n_diff}")
    assert n_diff == 0, "the grid's planes differ from the single tiles"
    try:
        YCbCrToRGB.USE_KERNEL = False        # the plain path on the card
        plain = convert_image(img, Colorspace.RGB, Chroma.InterleavedRGB)
    finally:
        YCbCrToRGB.USE_KERNEL = None
    tally.compare("planes_ycbcr8_to_rgb", "avc photo RGB vs plain", inter,
                  plain.plane(Channel.Interleaved), exact=True)
    cpu = HeifContext.read_from_bytes(blob, device="cpu").decode_image(
        None, Colorspace.RGB, Chroma.InterleavedRGB)
    tally.compare("planes_ycbcr8_to_rgb", "avc photo RGB vs CPU decode",
                  inter, cpu.plane(Channel.Interleaved).to(inter.device),
                  exact=False)
    return launches, parts, rgb, img


def time_avc_file(blob, ref, what, first):
    """A file's decode to interleaved RGB through the entry point REPEATS
    times in fresh contexts, the last under torch.profiler: the walls in
    MP/s beside the first decode's split (``first``: its total and
    spans), each RGB equal to ``ref``, the colour kernel's and the
    copies' device ms and the card's busy share of that decode."""
    totals = []
    out = {}

    def decode():
        t0 = time.perf_counter()
        out["rgb"] = HeifContext.read_from_bytes(blob).decode_image(
            None, Colorspace.RGB, Chroma.InterleavedRGB)
        out["ms"] = ms_since(t0)
    for _ in range(REPEATS - 1):
        decode()
        totals.append(out["ms"])
        assert torch.equal(out["rgb"].plane(Channel.Interleaved),
                           ref.plane(Channel.Interleaved)), what
    dev = device_ms(decode)
    totals.append(out["ms"])
    assert torch.equal(out["rgb"].plane(Channel.Interleaved),
                       ref.plane(Channel.Interleaved)), what
    px = ref.width * ref.height
    med = float(np.median(totals))
    t = {"total_ms": totals, "median_ms": med,
         "median_mp_per_s": px / 1e3 / med,
         "first": first}
    spans = first["spans"]
    split = {s: v["ms"] for s, v in spans.items()
             if s.startswith(("avc.", "color."))}
    # the rest: the file's parse, the grid's paste, the items' pipeline
    split["rest"] = first["total_ms"] - spans["avc.decode"]["ms"] - sum(
        v for s, v in split.items() if s.startswith("color."))
    t["split_ms"] = split
    if dev is None:
        t["device"] = "not measured (the profiler recorded no device time)"
    else:
        dev["colour_kernel_ms"] = sum(
            k["ms"] for k in dev["top"] if "planes_ycbcr8_to_rgb" in k["name"])
        dev["busy_share"] = (dev["kernels_ms"] + dev["copies_ms"]) / out["ms"]
        t["device"] = dev
    log(f"{what} {json.dumps(t)}")
    return t


def first_decode(blob, what):
    """One decode to interleaved RGB with its launches and spans read
    around it: (launches, {"total_ms", "spans"}, RGB)."""
    with launch_counts() as launches, trace.collect() as spans:
        t0 = time.perf_counter()
        rgb = HeifContext.read_from_bytes(blob).decode_image(
            None, Colorspace.RGB, Chroma.InterleavedRGB)
        ms = ms_since(t0)
    log(f"{what} launches {launches} in {ms:.1f} ms, spans "
        f"{json.dumps(spans)}")
    assert launches["planes_ycbcr8_to_rgb"] == 1, launches
    assert sum(launches[k] for k in ALL_KERNELS) == 1, launches
    return launches, {"total_ms": ms, "spans": spans}, rgb


def check_avc_items(streams):
    """The 1920x1080 CABAC item (timed), the 256x256 CAVLC item, the
    monochrome item and a tili of the four photo tiles: each on the card
    and on the CPU with 0 samples differing and equal to the manifest."""
    out = {}
    for name in (AVC_HD, AVC_CAVLC, AVC_MONO):
        e = streams[name]
        blob = avc1_file(e)
        img = decode_both(f"avc1 {name}", blob)
        assert avc_hashes(img) == e["sha256"], name
        decode_both(f"avc1 {name} RGB", blob, Colorspace.RGB, Chroma.C444)
        log(f"check file avc1 {name} planes vs manifest: equal")
        if name == AVC_HD:
            launches, first, rgb = first_decode(blob, "avc hd item")
            out["hd_item"] = time_avc_file(blob, rgb, "avc hd item", first)
            out["hd_item"]["launches"] = launches
    blob = avc1_tili_file(streams)
    for i, n in enumerate(PHOTO_TILES):
        img = decode_both(f"tili avc1 tile {i}", blob, tile=(i % 2, i // 2))
        assert avc_hashes(img) == streams[n]["sha256"], n
    return out


def check_avc_tracks(streams):
    """The committed avc1 tracks through HeifContext on the card: every
    frame in order (decode_next_image, then interleaved RGB) equal to the
    manifest, with the launches and spans read around the pass, then
    random access: an earlier frame (a restart at the IDR) and a later
    one."""
    out = {}
    for name, (earlier, later) in AVC_TRACKS.items():
        e = streams[name]
        with open(os.path.join(AVC_DIR, e["track"]), "rb") as f:
            blob = f.read()
        ms = []
        with launch_counts() as launches, trace.collect() as spans:
            t = HeifContext.read_from_bytes(blob).tracks[0]
            for i in range(e["frames"]):
                t0 = time.perf_counter()
                img = t.decode_next_image()
                rgb = convert_image(img, Colorspace.RGB,
                                    Chroma.InterleavedRGB)
                ms.append(ms_since(t0))
                assert avc_hashes(img) == e["sha256"][i], (name, i)
                assert rgb.plane(Channel.Interleaved).device.type == DEV
            assert t.decode_next_image() is None
        assert launches["planes_ycbcr8_to_rgb"] == e["frames"], launches
        assert sum(launches[k] for k in ALL_KERNELS) == e["frames"]
        access = {}
        for i in (earlier, later):
            t0 = time.perf_counter()
            img = t.decode_sample(i)
            access[i] = ms_since(t0)
            assert avc_hashes(img) == e["sha256"][i], (name, i)
        out[name] = {"frame_ms": ms, "ms_a_frame": sum(ms) / len(ms),
                     "launches": launches, "random_access_ms": access,
                     "spans": spans}
        log(f"avc track {name} {json.dumps(out[name])}")
    return out


def check_avc(tally):
    """Phase 4k: the C++ engine's build and load, every committed stream,
    the AVC photo (timed, split by span), the items and the tracks."""
    t_start = time.perf_counter()
    steps = {}

    def step(name):
        steps[name] = time.perf_counter() - t_start - sum(steps.values())
    _build.AVC_HOST_LIBRARY.load()
    log(f"avc_host {_build.AVC_HOST_LIBRARY.path}")
    step("build")
    streams = avc_streams()
    stream_ms = check_avc_streams(streams)
    step("streams")
    blob = avc_photo_file(streams)
    log(f"avc photo file {len(blob)} B")
    launches, first, rgb, ycc = check_avc_photo(tally, blob, streams)
    photo = time_avc_file(blob, rgb, "avc photo", first)
    photo["launches"] = launches
    photo["colour_kernel_event_ms"] = DeviceTimer()([
        lambda: cuda_fast.ycbcr8_planes_to_rgb(
            *(ycc.plane(c) for _, c in AVC_PLANES), kr=float(KR),
            kb=float(KB))])
    step("photo")
    items = check_avc_items(streams)
    step("items")
    tracks = check_avc_tracks(streams)
    step("tracks")
    log(f"avc phase steps (s) {json.dumps(steps)}")
    return {"stream_ms": stream_ms, "photo": photo, **items,
            "tracks": tracks, "steps_s": steps,
            "seconds": time.perf_counter() - t_start}


def avc_launches(avc):
    """planes_ycbcr8_to_rgb's launches on phase 4k's paths."""
    out = {"avc_photo": avc["photo"]["launches"]["planes_ycbcr8_to_rgb"],
           "avc_hd_item": avc["hd_item"]["launches"]["planes_ycbcr8_to_rgb"]}
    for name, t in avc["tracks"].items():
        out[f"avc track {name} in order"] = \
            t["launches"]["planes_ycbcr8_to_rgb"]
    return out


def avc_alone(tally):
    """Phase 4k and phase 4l's AVC encode, on card 0."""
    avc = check_avc(tally)
    avc["encode"] = check_avc_encode(photo_ycc())
    return avc, None


# -------------------------------------------------------------------- 4l
# AVC encode and JPEG 2000 through HeifContext on the card: what is
# encoded (sizes, qualities, crops, tiles) and the JAX writer's SHA-256
# of the same calls come from the manifests (tests/card_encodes.py)

AVC_ENC_MANIFEST = os.path.join(AVC_DIR, "encode_manifest.json")
J2K_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "libheif_tpu_torch", "testdata", "j2k")
AVC_ENC_SPANS = ("avc.encode", "avc.encode.copy", "avc.encode.native",
                 "avc.encode.write")
J2K_DEC_SPANS = ("j2k.decode", "j2k.decode.parse", "j2k.decode.t1",
                 "j2k.decode.dwt", "j2k.decode.copy")
J2K_ENC_SPANS = ("j2k.encode", "j2k.encode.copy", "j2k.encode.dwt",
                 "j2k.encode.t1", "j2k.encode.write")
RGB3 = (Channel.R, Channel.G, Channel.B)


def read_manifest(path):
    with open(path) as f:
        return json.load(f)


def sha256(blob):
    return hashlib.sha256(blob).hexdigest()


def photo_ycc():
    """The HEVC photo decoded on the card: {Y, Cb, Cr} uint8 planes."""
    img = HeifContext.read_from_bytes(photo_file(hevc_streams())) \
        .decode_image(None)
    assert (img.width, img.height, img.chroma) == (*PHOTO, Chroma.C420)
    return {ch: img.plane(ch).to(torch.uint8) for ch in YCC}


def spans_split(spans, prefix):
    """The wall of each span under ``prefix`` (ms) with its count."""
    return {s: {"ms": v["ms"], "count": v["count"]}
            for s, v in spans.items() if s.startswith(prefix)}


def card_write(what, build, want_sha):
    """``build()`` -> file bytes, written on the card: its SHA-256 is the
    JAX writer's (``want_sha``).  Returns the file, its launches and
    spans, and the wall."""
    with launch_counts() as launches, trace.collect() as spans:
        t0 = time.perf_counter()
        blob = build()
        card_ms = ms_since(t0)
    assert sha256(blob) == want_sha, \
        f"{what}: the file differs from the JAX writer's"
    log(f"check write {what:40s} {len(blob)} B equal to the JAX writer's "
        f"SHA-256; card {card_ms:.1f} ms, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return blob, launches, dict(spans), {"card_ms": card_ms,
                                          "bytes": len(blob)}


def check_avc_photo_encode(planes, man):
    """The photo with its alpha through encode_image(img, "avc") on the
    card (the C++ engine on the host after one copy of each image's
    planes): the JAX writer's bytes (its SHA-256); read back on
    the card to interleaved RGB (planes_ycbcr8_to_rgb once, no other
    launch), the YCbCr and alpha planes handed to the conversion equal to
    the encoders' reconstructions after the in-loop filter."""
    src = image_of({**planes, Channel.Alpha: alpha_gradient(*PHOTO)},
                   Colorspace.YCbCr, Chroma.C420)
    opts = EncodingOptions(quality=man["quality"])
    with encoders_made(avc_encoder._NativeSliceEncoder,
                       "encode_slice") as encs:
        blob, launches, spans, walls = card_write(
            "avc photo q%d + alpha" % man["quality"],
            lambda: encode_file(src, "avc", opts)[0],
            man["files"]["photo-alpha"]["sha256"])
    assert len(encs) == 2, f"{len(encs)} C++ encodes for an image + alpha"
    for s in AVC_ENC_SPANS:
        want = 4 if s == "avc.encode.write" else 2
        assert spans.get(s, {}).get("count") == want, (s, spans.get(s))
    assert "avc.encode.python" not in spans
    ran = {k: v for k, v in launches.items() if v}
    assert not ran, f"the avc encode launched {ran}"
    seen = []
    real_convert = context_mod.convert_image

    def convert(img, *args, **kw):
        seen.append(img)
        return real_convert(img, *args, **kw)
    context_mod.convert_image = convert
    try:
        with launch_counts() as dec_launches, trace.collect() as dspans:
            t0 = time.perf_counter()
            rgb = HeifContext.read_from_bytes(blob).decode_image(
                None, Colorspace.RGB, Chroma.InterleavedRGB)
            decode_ms = ms_since(t0)
    finally:
        context_mod.convert_image = real_convert
    assert dec_launches["planes_ycbcr8_to_rgb"] == 1, dec_launches
    assert sum(dec_launches[k] for k in ALL_KERNELS) == 1, dec_launches
    assert rgb.plane(Channel.Interleaved).device.type == DEV
    img, = seen
    for e in encs:
        e.loop_filter()
    diff = recon_differing([img.plane(ch) for ch in YCC], encs[0].planes,
                           YCC)
    diff.update(recon_differing([img.plane(Channel.Alpha)],
                                encs[1].planes[:1], [Channel.Alpha]))
    assert not any(diff.values()), \
        f"avc photo: decode vs the encoder's reconstruction {diff}"
    quality = {ch: psnr(img.plane(ch), src.plane(ch))
               for ch in YCC + (Channel.Alpha,)}
    out = {**walls, "launches": launches, "spans": spans,
           "encode_split_ms": spans_split(spans, "avc.encode"),
           "decode_ms": decode_ms, "decode_launches": dec_launches,
           "decode_spans": dict(dspans), "decode_vs_recon_differing": diff,
           "psnr_db": quality}
    log(f"avc encode photo {json.dumps(out)}")
    return out


def check_avc_tili_encode(planes, man):
    """A tili of four avc1 tiles cut from the photo, written on the card
    (the JAX writer's bytes), each tile decoded on the card and the CPU."""
    side = man["tile"]
    opts = EncodingOptions(quality=man["quality"])

    def build():
        ctx = HeifContext()
        tid = ctx.add_tiled_image(2 * side, 2 * side, side, side, fmt="avc")
        for tx, ty in ((0, 0), (1, 0), (0, 1), (1, 1)):
            ctx.add_image_tile_to_tiled(tid, tx, ty, image_of(
                photo_crop(planes, side, (ty * side, tx * side)),
                Colorspace.YCbCr, Chroma.C420), opts)
        return ctx.write()
    blob, launches, spans, walls = card_write(
        "avc tili of four avc1 tiles", build, man["files"]["tili"]["sha256"])
    for tx, ty in ((0, 0), (1, 0), (0, 1), (1, 1)):
        decode_both(f"avc tili tile {tx},{ty}", blob, tile=(tx, ty))
    return {**walls, "spans": spans}


def check_avc_track_encode(man):
    """A QCIF IPPP avc track of the panning scene written on the card:
    the JAX writer's SHA-256; every frame read back on the card equal to
    the encoder's reference picture (its deblocked reconstruction)."""
    w, h, n = man["track"]
    ctx = HeifContext()
    tw = ctx.add_visual_track(w, h, fmt="avc", options=TrackOptions(
        timescale=30, inter_frames="ipp"))
    refs = []
    with trace.collect() as spans:
        t0 = time.perf_counter()
        for f in inter_cases.panning_scene(w, h, n, man["track_seed"]):
            tw.add_frame(image_of({ch: torch.from_numpy(p).to(DEV)
                                   for ch, p in zip(YCC, f)},
                                  Colorspace.YCbCr, Chroma.C420),
                         duration=1,
                         options=EncodingOptions(quality=man["quality"]))
            refs.append(tw._enc_session.ref)
        blob = ctx.write()
        ms = ms_since(t0)
    assert sha256(blob) == man["files"]["qcif-ipp"]["sha256"], \
        "the avc track differs from the JAX writer's"
    t = HeifContext.read_from_bytes(blob).tracks[0]
    diff = {}
    for i, ref in enumerate(refs):
        img = t.decode_next_image()
        diff[i] = sum(recon_differing([img.plane(ch) for ch in YCC], ref,
                                      YCC).values())
    assert t.decode_next_image() is None
    assert not any(diff.values()), f"avc track frames vs the DPB {diff}"
    out = {"frames": n, "bytes": len(blob), "ms": ms,
           "ms_a_frame": ms / n, "spans": dict(spans),
           "frames_vs_reference_differing": diff}
    log(f"check avc track {w}x{h} IPPP x{n}: the JAX writer's SHA-256, "
        f"every frame equal to the encoder's reference {json.dumps(out)}")
    return out


def check_avc_encode(planes):
    """Phase 4l, AVC: the photo with alpha, a tili, an IPPP track."""
    t0 = time.perf_counter()
    man = read_manifest(AVC_ENC_MANIFEST)
    assert tuple(man["photo"]) == PHOTO
    out = {"photo": check_avc_photo_encode(planes, man),
           "tili": check_avc_tili_encode(planes, man),
           "track": check_avc_track_encode(man)}
    out["seconds"] = time.perf_counter() - t0
    return out


def j2k1_file(data, e):
    """A j2k1 item holding codestream ``data`` (its j2kH holding a cdef of
    its components' roles) and ispe."""
    cdef = Box_cdef()
    if e["components"] == 1:
        cdef.channels = [(0, 0, 1)]
    else:
        cdef.set_channels_rgb(False)
    j2kh = Box_j2kH()
    j2kh.children.append(cdef)
    f = new_file()
    item = f.add_new_item("j2k1").item_id
    f.append_item_data(item, data)
    f.add_property(item, j2kh, True)
    f.add_property(item, Box_ispe(e["width"], e["height"]), False)
    f.set_primary_item(item)
    return f.write()


def j2k_hashes(img):
    """SHA-256 of each component (R, G, B or Y) as the manifest holds
    them: uint8, or little-endian uint16."""
    chans = RGB3 if img.has_channel(Channel.R) else (Channel.Y,)
    return [hashlib.sha256(np.ascontiguousarray(
        img.np_plane(ch), "<u2" if img.bit_depth(ch) > 8 else "u1")
        .tobytes()).hexdigest() for ch in chans]


def check_j2k_streams(man):
    """Every committed codestream as a j2k1 item decoded on the card and
    on the CPU: the same planes, equal to the JAX decode's hashes and to
    OpenJPEG's where the two agree (5/3, HTJ2K, 16 bits)."""
    out = {}
    for e in man["streams"]:
        with open(os.path.join(J2K_DIR, e["file"]), "rb") as f:
            blob = j2k1_file(f.read(), e)
        with trace.collect() as spans:
            t0 = time.perf_counter()
            img = decode_both(f"j2k1 {e['name']}", blob)
            ms = ms_since(t0)
        assert j2k_hashes(img) == e["sha256_jax"], e["name"]
        if e["openjpeg_exact"]:
            assert j2k_hashes(img) == e["sha256_openjpeg"], e["name"]
        assert [img.bit_depth(ch) for ch in (
            RGB3 if e["components"] == 3 else (Channel.Y,))] == e["depths"]
        out[e["name"]] = {"card_and_cpu_ms": ms,
                          "spans": spans_split(spans, "j2k.")}
        log(f"check j2k stream {e['name']:20s} {e['width']}x{e['height']} "
            f"depths {e['depths']} card = CPU = the JAX decode"
            f"{' = OpenJPEG' if e['openjpeg_exact'] else ''} "
            f"({ms:.0f} ms)")
    return out


def check_j2k_photo(planes, man):
    """The photo as a lossless 5/3 j2k1 item through encode_image on the
    card (the encoder converts it to RGB 4:4:4 there: planes_ycbcr8_to_rgb
    once): the JAX writer's bytes (its SHA-256); read back on the
    card, its planes equal the photo's RGB 4:4:4 conversion exactly."""
    src = image_of(planes, Colorspace.YCbCr, Chroma.C420)
    opts = EncodingOptions(lossless=True)
    blob, launches, spans, walls = card_write(
        "j2k photo 5/3 lossless",
        lambda: encode_file(src, "jpeg2000", opts)[0],
        man["writes"]["photo-53"]["sha256"])
    for s in J2K_ENC_SPANS:
        assert spans.get(s, {}).get("count", 0) >= 1, (s, spans.get(s))
    assert launches["planes_ycbcr8_to_rgb"] == 1, launches
    assert sum(launches[k] for k in ALL_KERNELS) == 1, launches
    with launch_counts() as dec_launches, trace.collect() as dspans:
        t0 = time.perf_counter()
        img = HeifContext.read_from_bytes(blob).decode_image(None)
        decode_ms = ms_since(t0)
    assert sum(dec_launches[k] for k in ALL_KERNELS) == 0, dec_launches
    for s in J2K_DEC_SPANS:
        assert dspans.get(s, {}).get("count", 0) >= 1, (s, dspans.get(s))
    assert dspans["j2k.decode.copy"]["count"] == 1
    ref = convert_image(src, Colorspace.RGB, Chroma.C444)
    n = {ch: int((img.plane(ch) != ref.plane(ch)).sum()) for ch in RGB3}
    assert img.plane(Channel.R).device.type == DEV
    assert not any(n.values()), f"j2k photo: read back vs its source {n}"
    out = {**walls, "launches": launches,
           "encode_split_ms": spans_split(spans, "j2k.encode"),
           "decode_ms": decode_ms,
           "decode_split_ms": spans_split(dspans, "j2k."),
           "decode_vs_source_differing": n}
    log(f"j2k encode photo {json.dumps(out)}")
    return out


def check_j2k_crops(planes, man):
    """9/7 at the manifest's quality and htj2k on the crop: each the JAX
    writer's bytes (its SHA-256); decoded on the card and the CPU
    alike (the htj2k one equal to the crop's RGB 4:4:4 conversion)."""
    cw, ch_ = man["crop"]
    oy, ox = man["crop_at"]
    crop = {Channel.Y: planes[Channel.Y][oy:oy + ch_, ox:ox + cw]}
    for c in (Channel.Cb, Channel.Cr):
        crop[c] = planes[c][oy // 2:(oy + ch_) // 2, ox // 2:(ox + cw) // 2]
    src = image_of(crop, Colorspace.YCbCr, Chroma.C420)
    out = {}
    for name, fmt, opts in (
            ("crop-97-q60", "jpeg2000",
             EncodingOptions(lossless=False, quality=man["quality"])),
            ("crop-htj2k", "htj2k", EncodingOptions(lossless=True))):
        blob, launches, spans, walls = card_write(
            f"j2k {name} {cw}x{ch_}",
            lambda: encode_file(src, fmt, opts)[0],
            man["writes"][name]["sha256"])
        img = decode_both(f"j2k1 {name}", blob)
        if opts.lossless:
            ref = convert_image(src, Colorspace.RGB, Chroma.C444)
            assert all(torch.equal(img.plane(c), ref.plane(c))
                       for c in RGB3), name
        else:
            walls["psnr_db_vs_rgb"] = {
                c: psnr(img.plane(c), ref_c) for c, ref_c in zip(
                    RGB3, (convert_image(src, Colorspace.RGB, Chroma.C444)
                           .plane(c) for c in RGB3))}
        out[name] = {**walls, "launches": launches,
                     "encode_split_ms": spans_split(spans, "j2k.")}
    log(f"j2k crops {json.dumps(out)}")
    return out


def check_j2k_tili(planes, man):
    """A tili of four jpeg2000 tiles (lossless) cut from the photo,
    written on the card (the JAX writer's bytes), each tile decoded on
    the card and the CPU."""
    side = man["tile"]
    opts = EncodingOptions(lossless=True)

    def build():
        ctx = HeifContext()
        tid = ctx.add_tiled_image(2 * side, 2 * side, side, side,
                                  fmt="jpeg2000")
        for tx, ty in ((0, 0), (1, 0), (0, 1), (1, 1)):
            ctx.add_image_tile_to_tiled(tid, tx, ty, image_of(
                photo_crop(planes, side, (ty * side, tx * side)),
                Colorspace.YCbCr, Chroma.C420), opts)
        return ctx.write()
    blob, launches, spans, walls = card_write(
        "j2k tili of four jpeg2000 tiles", build,
        man["writes"]["tili"]["sha256"])
    for tx, ty in ((0, 0), (1, 0), (0, 1), (1, 1)):
        decode_both(f"j2k tili tile {tx},{ty}", blob, tile=(tx, ty))
    return {**walls, "launches": launches}


def check_j2k(planes):
    """Phase 4l, JPEG 2000: the C++ block coders' build and load, the
    committed codestreams, the photo, the crops, a tili."""
    t_start = time.perf_counter()
    steps = {}

    def step(name):
        steps[name] = time.perf_counter() - t_start - sum(steps.values())
    j2k_native.lib()
    log(f"j2k_host {_build.J2K_HOST_LIBRARY.path}")
    step("build")
    man = read_manifest(os.path.join(J2K_DIR, "manifest.json"))
    assert tuple(man["photo"]) == PHOTO
    out = {"streams": check_j2k_streams(man)}
    step("streams")
    out["photo"] = check_j2k_photo(planes, man)
    step("photo")
    out["crops"] = check_j2k_crops(planes, man)
    step("crops")
    out["tili"] = check_j2k_tili(planes, man)
    step("tili")
    log(f"j2k phase steps (s) {json.dumps(steps)}")
    out["steps_s"] = steps
    out["seconds"] = time.perf_counter() - t_start
    return out


def encode_4l_launches(avc_enc, j2k):
    """planes_ycbcr8_to_rgb's launches on phase 4l's paths."""
    out = {}
    if avc_enc is not None:
        out["avc encode photo, read back"] = \
            avc_enc["photo"]["decode_launches"]["planes_ycbcr8_to_rgb"]
    if j2k is not None:
        out["j2k encode photo (to RGB 4:4:4)"] = \
            j2k["photo"]["launches"]["planes_ycbcr8_to_rgb"]
        for name, c in j2k["crops"].items():
            out[f"j2k encode {name}"] = c["launches"]["planes_ycbcr8_to_rgb"]
        out["j2k encode tili"] = \
            j2k["tili"]["launches"]["planes_ycbcr8_to_rgb"]
    return out


def j2k_alone(tally):
    """Phase 4l's JPEG 2000 half alone, on card 0."""
    return check_j2k(photo_ycc()), None


# ---------------------------------------------------------------------- VVC
# Phase 4m: VVC on the host, as in the JAX package (its intra-only codec
# pair: CABAC, coding tree and reconstruction in Python), each picture's
# planes copied to the card once and converted to RGB there; the writes
# convert their input on the card and copy its planes to the host once.
# The streams, files and the JAX writer's SHA-256 come from the manifests
# that tests/vvc_streams.py writes.

VVC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "libheif_tpu_torch", "testdata", "vvc")
VVC_DEC_SPANS = ("vvc.decode", "vvc.decode.parse", "vvc.decode.recon",
                 "vvc.decode.copy")
VVC_ENC_SPANS = ("vvc.encode", "vvc.encode.copy", "vvc.encode.plan",
                 "vvc.encode.cabac")
VVC_HD_BUDGET_S = 60.0      # the HD decode's wall to report beyond


def vvc_nals(name):
    """[SPS, PPS, slice] of a committed stream (4-byte lengths)."""
    with open(os.path.join(VVC_DIR, f"{name}.vvc"), "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        out.append(data[pos + 4:pos + 4 + n])
        pos += 4 + n
    return out


def vvc_hashes(img):
    """SHA-256 of Y, Cb, Cr as the manifests hold them: uint8, or
    little-endian uint16 above 8 bits."""
    return [hashlib.sha256(np.ascontiguousarray(
        img.np_plane(ch), "<u2" if img.bit_depth(ch) > 8 else "u1")
        .tobytes()).hexdigest() for ch in YCC]


def vvc_file(name):
    with open(os.path.join(VVC_DIR, name), "rb") as f:
        return f.read()


def as_vvi1(blob):
    """A one-track file with its vvc1 sample entry renamed vvi1."""
    at = blob.index(b"stsd") + 16
    assert blob[at:at + 4] == b"vvc1", blob[at:at + 4]
    return blob[:at] + b"vvi1" + blob[at + 4:]


def check_vvc_streams(man, card):
    """Every committed stream through VvcDecoder on the card, the 10-bit
    one among them: planes on the card equal to the JAX decode's hashes."""
    out = {}
    for e in man["streams"]:
        t0 = time.perf_counter()
        nals = vvc_nals(e["name"])
        cfg = Box_vvcC()
        for n in nals[:2]:
            cfg.add_nal(n)
        img = VvcDecoder(DEV).decode_single_image(
            cfg, length_prefixed(nals[2:]))
        assert img.plane(Channel.Y).device.type == DEV
        assert img.bit_depth(Channel.Y) == e["depth"], e["name"]
        assert vvc_hashes(img) == e["sha256"], e["name"]
        out[e["name"]] = ms_since(t0)
        log(f"check vvc stream {e['name']:14s} {e['coded'][0]}x"
            f"{e['coded'][1]} {e['depth']}-bit equal to the JAX decode "
            f"({out[e['name']]:.0f} ms; {card})")
    return out


def vvc_rgb_decode(blob, tile=None):
    """One decode of ``blob`` (or of its tile) to interleaved RGB on the
    card, the launches and spans read around it: (launches, spans, ms,
    RGB image, the YCbCr image handed to the conversion)."""
    seen = []
    real_convert = context_mod.convert_image

    def convert(img, *args, **kw):
        seen.append(img)
        return real_convert(img, *args, **kw)
    context_mod.convert_image = convert
    try:
        with launch_counts() as launches, trace.collect() as spans:
            t0 = time.perf_counter()
            ctx = HeifContext.read_from_bytes(blob)
            if tile is None:
                rgb = ctx.decode_image(None, Colorspace.RGB,
                                       Chroma.InterleavedRGB)
            else:
                rgb = ctx.decode_tile(ctx.primary_item_id, *tile,
                                      Colorspace.RGB, Chroma.InterleavedRGB)
            ms = ms_since(t0)
    finally:
        context_mod.convert_image = real_convert
    img, = seen
    assert rgb.plane(Channel.Interleaved).device.type == DEV
    assert (img.colorspace, img.chroma) == (Colorspace.YCbCr, Chroma.C420)
    assert launches["planes_ycbcr8_to_rgb"] == 1, launches
    assert sum(launches[k] for k in ALL_KERNELS) == 1, launches
    return launches, dict(spans), ms, rgb, img


def vvc_against_plain(tally, what, rgb, img):
    """The RGB against the port's plain colour path on the card, on the
    same YCbCr planes (the colour contract)."""
    try:
        YCbCrToRGB.USE_KERNEL = False
        plain = convert_image(img, Colorspace.RGB, Chroma.InterleavedRGB)
    finally:
        YCbCrToRGB.USE_KERNEL = None
    tally.compare("planes_ycbcr8_to_rgb", what, rgb.plane(Channel.Interleaved),
                  plain.plane(Channel.Interleaved), exact=False)


def check_vvc_hd(tally, files, card):
    """The 1920x1080 vvc1 item through HeifContext to interleaved RGB: the
    VVC main path.  planes_ycbcr8_to_rgb launches exactly once and no
    other kernel; the YCbCr planes are the JAX decode's; the RGB holds the
    colour contract against the plain path; the wall is split by the
    vvc.decode spans."""
    e = files["hd"]
    blob = vvc_file(e["file"])
    assert sha256(blob) == e["sha256"]
    launches, spans, ms, rgb, img = vvc_rgb_decode(blob)
    assert (rgb.width, rgb.height) == (1920, 1080)
    assert vvc_hashes(img) == e["planes_sha256"], "hd planes"
    for s in VVC_DEC_SPANS:
        assert spans[s]["count"] == 1, (s, spans.get(s))
    vvc_against_plain(tally, "vvc hd item RGB vs plain", rgb, img)
    split = spans_split(spans, "vvc.")
    split.update(spans_split(spans, "color."))
    out = {"ms": ms, "bytes": len(blob), "launches": launches,
           "split_ms": split, "card": card,
           "rest_ms": ms - spans["vvc.decode"]["ms"] - sum(
               v["ms"] for k, v in spans.items() if k.startswith("color.")),
           "mp_per_s": 1920 * 1080 / 1e3 / ms,
           "over_budget": ms > VVC_HD_BUDGET_S * 1e3}
    log(f"vvc hd item 1920x1080 to RGB {json.dumps(out)}")
    return out


def check_vvc_reads(tally, files, card):
    """The committed grid, tili and track (and the track's samples as
    vvi1) read back to interleaved RGB on the card, each picture's planes
    equal to the JAX decode's (the manifest), one planes_ycbcr8_to_rgb
    launch a picture."""
    out = {}
    e = files["grid"]
    blob = vvc_file(e["file"])
    launches, spans, ms, rgb, img = vvc_rgb_decode(blob)
    assert vvc_hashes(img) == e["planes_sha256"], "grid planes"
    assert spans["vvc.decode"]["count"] == 4, spans["vvc.decode"]
    vvc_against_plain(tally, "vvc grid RGB vs plain", rgb, img)
    out["grid"] = {"ms": ms, "launches": launches,
                   "split_ms": spans_split(spans, "vvc.")}
    log(f"check vvc grid 2x2 of 256x256 to RGB: planes equal to the JAX "
        f"decode {json.dumps(out['grid'])} ({card})")
    e = files["tili"]
    blob = vvc_file(e["file"])
    out["tili"] = {}
    tiles = [(tx, ty) for ty in (0, 1) for tx in (0, 1)]
    for (tx, ty), ref in zip(tiles, e["tiles_sha256"]):
        launches, _, ms, rgb, img = vvc_rgb_decode(blob, (tx, ty))
        assert vvc_hashes(img) == ref, (tx, ty)
        out["tili"][f"{tx},{ty}"] = {"ms": ms, "launches": launches}
    log(f"check vvc tili 2x2 of 128x128, each tile to RGB equal to the JAX "
        f"decode {json.dumps(out['tili'])} ({card})")
    e = files["track"]
    blob = vvc_file(e["file"])
    for coding, b in (("vvc1", blob), ("vvi1", as_vvi1(blob))):
        frame_ms = []
        with launch_counts() as launches, trace.collect() as spans:
            t = HeifContext.read_from_bytes(b).tracks[0]
            assert t.coding == coding
            for ref in e["frames_sha256"]:
                t0 = time.perf_counter()
                img = t.decode_next_image()
                rgb = convert_image(img, Colorspace.RGB,
                                    Chroma.InterleavedRGB)
                frame_ms.append(ms_since(t0))
                assert vvc_hashes(img) == ref, (coding, len(frame_ms))
                assert rgb.plane(Channel.Interleaved).device.type == DEV
            assert t.decode_next_image() is None
        n = len(e["frames_sha256"])
        assert launches["planes_ycbcr8_to_rgb"] == n, launches
        assert sum(launches[k] for k in ALL_KERNELS) == n, launches
        out[f"track_{coding}"] = {"frame_ms": frame_ms, "launches": launches,
                                  "split_ms": spans_split(spans, "vvc.")}
        log(f"check vvc {coding} track {n} frames to RGB equal to the JAX "
            f"decode {json.dumps(out[f'track_{coding}'])} ({card})")
    return out


def vvc_cut(rgb, at, w, h, ycc):
    """A w x h crop of the photo at luma (row, column) ``at`` on the card:
    RGB, or (``ycc``) the YCbCr 4:2:0 planes cut from it by integer
    slicing (tests/vvc_streams.ycc_cut)."""
    oy, ox = at
    c = rgb[oy:oy + h, ox:ox + w]
    if not ycc:
        return image_of({ch: torch.from_numpy(np.ascontiguousarray(
            c[..., k])).to(DEV) for k, ch in enumerate(RGB3)},
            Colorspace.RGB, Chroma.C444)
    planes = (c[..., 1], c[::2, ::2, 0], c[::2, ::2, 2])
    return image_of({ch: torch.from_numpy(np.ascontiguousarray(p)).to(DEV)
                     for ch, p in zip(YCC, planes)},
                    Colorspace.YCbCr, Chroma.C420)


def vvc_recon_check(what, imgs, encs):
    """Decoded pictures against the encoders' reconstructions."""
    assert len(imgs) == len(encs), (what, len(imgs), len(encs))
    diff = {}
    for i, (img, enc) in enumerate(zip(imgs, encs)):
        diff[i] = sum(recon_differing([img.plane(ch) for ch in YCC],
                                      enc.recon.planes, YCC).values())
    assert not any(diff.values()), f"{what}: decode vs recon {diff}"
    return diff


def check_vvc_writes(man, card):
    """encode_image(img, "vvc") of a 256x256 RGB crop of the photo,
    add_visual_track(..., "vvc") of three 128x96 frames and
    add_tiled_image(..., fmt="vvc") of four 128x128 tiles, written on the
    card: each file the JAX writer's (its SHA-256), each picture read
    back on the card equal to its encoder's reconstruction, the walls
    split by the vvc.encode spans."""
    files = man["files"]
    q = EncodingOptions(quality=man["quality"])
    rgb = synthetic_photo(*man["photo"], man["photo_seed"])
    out = {}
    side = man["grid_side"]
    with encoders_made(vvc_encoder.VvcIntraEncoder) as encs:
        blob, launches, spans, walls = card_write(
            "vvc still 256x256 RGB", lambda: encode_file(vvc_cut(
                rgb, man["grid_at"], side, side, False), "vvc", q)[0],
            files["still"]["sha256"])
    assert not {k: v for k, v in launches.items() if v}, launches
    for s in VVC_ENC_SPANS:
        assert spans[s]["count"] == 1, (s, spans.get(s))
    _, dspans, dms, _, img = vvc_rgb_decode(blob)
    assert vvc_hashes(img) == files["still"]["planes_sha256"]
    out["still"] = {**walls, "split_ms": spans_split(spans, "vvc.encode"),
                    "decode_ms": dms, "card": card,
                    "vs_recon": vvc_recon_check("vvc still", [img], encs)}
    log(f"vvc write still {json.dumps(out['still'])}")

    w, h, n = man["track"]

    def track():
        ctx = HeifContext()
        tw = ctx.add_visual_track(w, h, fmt="vvc",
                                  options=TrackOptions(timescale=30))
        oy, ox = man["track_at"]
        for i in range(n):
            tw.add_frame(vvc_cut(rgb, (oy, ox + man["track_step"] * i), w, h,
                                 True), duration=1, options=q)
        return ctx.write()
    with encoders_made(vvc_encoder.VvcIntraEncoder) as encs:
        blob, launches, spans, walls = card_write(
            f"vvc track {w}x{h} x{n}", track, files["track"]["sha256"])
    t = HeifContext.read_from_bytes(blob).tracks[0]
    frames = [t.decode_next_image() for _ in range(n)]
    assert t.decode_next_image() is None
    out["track"] = {**walls, "split_ms": spans_split(spans, "vvc.encode"),
                    "ms_a_frame": walls["card_ms"] / n, "card": card,
                    "vs_recon": vvc_recon_check("vvc track", frames, encs)}
    log(f"vvc write track {json.dumps(out['track'])}")

    side = man["tili_side"]

    def tili():
        ctx = HeifContext()
        tid = ctx.add_tiled_image(2 * side, 2 * side, side, side, fmt="vvc")
        oy, ox = man["tili_at"]
        for ty in (0, 1):
            for tx in (0, 1):
                ctx.add_image_tile_to_tiled(tid, tx, ty, vvc_cut(
                    rgb, (oy + ty * side, ox + tx * side), side, side, True),
                    q)
        return ctx.write()
    with encoders_made(vvc_encoder.VvcIntraEncoder) as encs:
        blob, launches, spans, walls = card_write(
            f"vvc tili 2x2 of {side}x{side}", tili, files["tili"]["sha256"])
    ctx = HeifContext.read_from_bytes(blob)
    tiles = [ctx.decode_tile(ctx.primary_item_id, tx, ty)
             for ty in (0, 1) for tx in (0, 1)]
    out["tili"] = {**walls, "split_ms": spans_split(spans, "vvc.encode"),
                   "card": card,
                   "vs_recon": vvc_recon_check("vvc tili", tiles, encs)}
    log(f"vvc write tili {json.dumps(out['tili'])}")
    return out


def check_vvc(tally):
    """Phase 4m: the committed streams, the HD item (the VVC main path),
    the grid, tili and tracks, and the three writes."""
    t_start = time.perf_counter()
    card = nvidia_smi()
    steps = {}

    def step(name):
        steps[name] = time.perf_counter() - t_start - sum(steps.values())
    man = read_manifest(os.path.join(VVC_DIR, "manifest.json"))
    enc_man = read_manifest(os.path.join(VVC_DIR, "encode_manifest.json"))
    stream_ms = check_vvc_streams(man, card)
    step("streams")
    hd = check_vvc_hd(tally, enc_man["files"], card)
    step("hd")
    reads = check_vvc_reads(tally, enc_man["files"], card)
    step("reads")
    writes = check_vvc_writes(enc_man, card)
    step("writes")
    log(f"vvc phase steps (s) {json.dumps(steps)} ({card})")
    return {"card": card, "stream_ms": stream_ms, "hd_item": hd,
            "reads": reads, "writes": writes, "steps_s": steps,
            "seconds": time.perf_counter() - t_start}


def vvc_launches(vvc):
    """planes_ycbcr8_to_rgb's launches on phase 4m's paths."""
    r = vvc["reads"]
    out = {"vvc_hd_item": vvc["hd_item"]["launches"]["planes_ycbcr8_to_rgb"],
           "vvc grid": r["grid"]["launches"]["planes_ycbcr8_to_rgb"],
           "vvc tili tiles": sum(t["launches"]["planes_ycbcr8_to_rgb"]
                                 for t in r["tili"].values())}
    for coding in ("vvc1", "vvi1"):
        out[f"vvc {coding} track in order"] = \
            r[f"track_{coding}"]["launches"]["planes_ycbcr8_to_rgb"]
    return out


def vvc_alone(tally):
    """Phase 4m alone, on card 0."""
    return check_vvc(tally), None


# ---------------------------------------------------------------------- api
# Phase 4n: the read side of the C-named API (libheif_tpu_torch/api) on the
# card, as a user calls it: heif_context_alloc -> heif_context_read_from_
# memory -> heif_context_get_primary_image_handle -> heif_decode_image ->
# heif_image_get_plane_readonly.

API_DEPTH_URN = "urn:mpeg:mpegB:cicp:systems:auxiliary:depth"
API_OTHER_URN = "urn:example:aux:segmentation"
API_IMAGE = (1024, 768)      # the heif_image_create image
# the read functions the walk calls with the context, an item id or a
# handle (and, for two-argument ones, an id), by name prefix
API_READ_PREFIXES = ("heif_context_get_", "heif_context_is_",
                     "heif_item_get_", "heif_item_is_",
                     "heif_image_handle_get_", "heif_image_handle_has_",
                     "heif_image_handle_is_")
API_BRAND_READS = ("heif_read_main_brand", "heif_read_minor_version_brand",
                   "heif_list_compatible_brands", "heif_get_file_mime_type",
                   "heif_check_filetype", "heif_check_jpeg_filetype",
                   "heif_main_brand", "heif_has_compatible_filetype")


def api_decode(blob, colorspace, chroma, device=None):
    """The primary image of ``blob`` through the C-named API on ``device``
    (None: the card)."""
    ctx = api.heif_context_alloc(device=device)
    api.heif_context_read_from_memory(ctx, blob)
    handle = api.heif_context_get_primary_image_handle(ctx)
    return api.heif_decode_image(handle, colorspace, chroma)


def check_api_photo(what, blob, chroma, want, card):
    """One photo through the API on the card to ``chroma``, the launch
    counts read around it (``want`` {kernel: launches}, every other
    kernel none); its plane, read with heif_image_get_plane_readonly, the
    image's own tensor on the card and equal sample for sample to
    HeifContext's decode on the card; the wall of that first API decode,
    then the API's and HeifContext's walls in turns (API, HeifContext,
    HeifContext, API)."""
    def context_decode():
        return HeifContext.read_from_bytes(blob).decode_image(
            None, Colorspace.RGB, chroma)
    t0 = time.perf_counter()
    with launch_counts() as launches:
        img = api_decode(blob, Colorspace.RGB, chroma)
    first_ms = ms_since(t0)
    plane = api.heif_image_get_plane_readonly(img, Channel.Interleaved)
    assert plane is img.plane(Channel.Interleaved) and \
        plane.device.type == DEV, what
    only_launches(f"api {what}", launches, want)
    ref = context_decode().plane(Channel.Interleaved)
    assert plane.shape == ref.shape and plane.dtype == ref.dtype, what
    n = int((plane != ref).sum())
    walls = {"api": [], "heif_context": []}
    for who in ("api", "heif_context", "heif_context", "api"):
        t0 = time.perf_counter()
        if who == "api":
            api_decode(blob, Colorspace.RGB, chroma)
        else:
            context_decode()
        walls[who].append(ms_since(t0))
    log(f"check api {what:40s} {img.width}x{img.height} {chroma} "
        f"differing {n} of {plane.numel()} from HeifContext's decode; "
        f"launches {want}; api first {first_ms:.1f} ms, then api "
        f"{walls['api']} ms, HeifContext {walls['heif_context']} ms in "
        f"turns ({card})")
    assert n == 0, f"api {what}: the API's decode differs from HeifContext's"
    return {"size": [img.width, img.height], "chroma": chroma,
            "launches": {k: launches[k] for k in want},
            "first_ms": first_ms, "api_ms": walls["api"],
            "heif_context_ms": walls["heif_context"], "card": card}


def api_small_file():
    """A file written by the port's writer on the card: a 256x192 hvc1
    primary with a jpeg thumbnail, an unci depth image and an unci
    generic aux image, Exif and XMP, pasp, udes and a gimi content id,
    and a second (jpeg) image grouped with it by ster and altr."""
    ctx = HeifContext()
    ctx.new_file()
    opts = EncodingOptions(quality=80)
    primary = ctx.encode_image(sampled_image(256, 192, "420", 7), "hevc",
                               opts)
    ctx.set_primary_item(primary)
    second = ctx.encode_image(sampled_image(256, 192, "420", 8), "jpeg",
                              opts)
    ctx.add_thumbnail(primary, sampled_image(64, 48, "420", 9), "jpeg",
                      opts)
    f = ctx.file
    for urn, seed in ((API_DEPTH_URN, 10), (API_OTHER_URN, 11)):
        aux = ctx.encode_image(sampled_image(256, 192, "mono", seed), "unci")
        f.add_property(aux, Box_auxC(urn), True)
        f.add_reference("auxl", aux, [primary])
        f.get_infe(aux).hidden = True
    ctx.add_exif(primary, EXIF)
    ctx.add_xmp(primary, XMP)
    f.add_property(primary, Box_pasp(4, 3), False)
    f.add_property(primary, Box_udes("en", "api", "the read-side API",
                                     "card"), False)
    f.add_property(primary, Box_gimi_content_id("urn:uuid:api-read"), False)
    f.grpl = Box_grpl()
    f.meta.children.append(f.grpl)
    f.grpl.children += [Box_ster(100, [primary, second]),
                        Box_altr(101, [second, primary])]
    return ctx.write()


def api_plain(x):
    """An API answer as plain comparable values (a handle as its item id,
    a box or other object as its class and public fields)."""
    if isinstance(x, api.heif_image_handle):
        return ("handle", x.item_id)
    if isinstance(x, HeifContext):
        return "context"
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    if isinstance(x, (list, tuple)):
        return [api_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: api_plain(v) for k, v in x.items()}
    if hasattr(x, "__dict__"):
        return [type(x).__name__, {k: api_plain(v) for k, v in
                                   vars(x).items() if not k.startswith("_")}]
    return repr(x)


def api_answer(fn, *args):
    try:
        return api_plain(fn(*args))
    except HeifError as e:
        return ("HeifError", e.code.name, e.subcode.name)


def api_reads(prefixes, n_args):
    """The API's read functions named with one of ``prefixes`` that take
    ``n_args`` arguments without defaults."""
    out = []
    for name in sorted(dir(api)):
        fn = getattr(api, name)
        if not name.startswith(prefixes) or not callable(fn):
            continue
        required = [p for p in inspect.signature(fn).parameters.values()
                    if p.default is inspect.Parameter.empty]
        if len(required) == n_args:
            out.append((name, fn))
    return out


def api_walk(blob, device):
    """Every read function of the API on a context on ``device`` read
    from ``blob``: {call: answer}, and the images' decodes."""
    ctx = api.heif_context_alloc(device=device)
    api.heif_context_read_from_memory(ctx, blob)
    out = {}
    for name, fn in api_reads(("heif_context_get_", "heif_context_is_"), 1):
        out[name] = api_answer(fn, ctx)
    for name in API_BRAND_READS:
        out[name] = api_answer(getattr(api, name), blob)
    out["decoders"] = api.heif_get_decoder_descriptors()
    item_reads = api_reads(("heif_item_get_", "heif_item_is_",
                            "heif_context_get_item_references",
                            "heif_context_is_top_level_image_ID"), 2)
    handle_reads = api_reads(API_READ_PREFIXES[4:], 1)
    handle_id_reads = api_reads(API_READ_PREFIXES[4:], 2) + [
        ("image_handle.heif_image_handle_get_depth_image_handle",
         api.image_handle.heif_image_handle_get_depth_image_handle)]
    images = {}
    for iid in api.heif_context_get_list_of_item_IDs(ctx) + [999]:
        for name, fn in item_reads:
            out[(name, iid)] = api_answer(fn, ctx, iid)
        if not (iid in ctx.items and ctx.items[iid].is_image_item):
            continue
        h = api.heif_context_get_image_handle(ctx, iid)
        for name, fn in handle_reads:
            out[(name, iid)] = api_answer(fn, h)
        ids = set(api.heif_image_handle_get_list_of_thumbnail_IDs(h) +
                  api.heif_image_handle_get_list_of_auxiliary_image_IDs(h) +
                  api.heif_image_handle_get_list_of_metadata_block_IDs(h) +
                  [0, 1, 999])
        for name, fn in handle_id_reads:
            for i in sorted(ids):
                out[(name, iid, i)] = api_answer(fn, h, i)
        try:
            images[iid] = api.heif_decode_image(h)
        except HeifError as e:          # Exif, mime: not images
            images[iid] = ("HeifError", e.code.name, e.subcode.name)
    return out, images


def check_api_walk(card):
    """The small file's every read answer on a card context equal to a
    CPU context's, and each of its images decoded through the API on the
    card equal to the CPU's."""
    t0 = time.perf_counter()
    blob = api_small_file()
    write_ms = ms_since(t0)
    t0 = time.perf_counter()
    answers, images = api_walk(blob, None)
    walk_ms = ms_since(t0)
    cpu_answers, cpu_images = api_walk(blob, "cpu")
    differ = [k for k in cpu_answers if answers.get(k) != cpu_answers[k]]
    assert set(answers) == set(cpu_answers) and not differ, differ[:5]
    primary = answers["heif_context_get_primary_image_ID"]
    groups = answers["heif_context_get_entity_groups"]
    assert [g[1]["entity_group_type"] for g in groups] == ["ster", "altr"]
    assert answers[("heif_image_handle_get_pixel_aspect_ratio",
                    primary)] == [True, 4, 3]
    assert answers[("heif_image_handle_get_exif", primary)] == EXIF
    assert len(answers[("heif_image_handle_get_list_of_auxiliary_image_IDs",
                        primary)]) == 2
    assert answers[("heif_image_handle_get_number_of_depth_images",
                    primary)] == 1
    for iid, img in images.items():
        if isinstance(img, tuple):
            assert cpu_images[iid] == img, iid
        else:
            same_image(f"api small file item {iid}", img, cpu_images[iid])
    decoded = sum(not isinstance(i, tuple) for i in images.values())
    assert decoded == 5, decoded
    log(f"check api walk: {len(answers)} read calls equal on the card and "
        f"the CPU, {decoded} images decoded equal; the file "
        f"{len(blob)} B written in {write_ms:.1f} ms, read and walked on "
        f"the card in {walk_ms:.1f} ms ({card})")
    return {"file_bytes": len(blob), "read_calls": len(answers),
            "images": decoded, "write_ms": write_ms,
            "walk_ms": walk_ms, "card": card}


def check_api_image(card):
    """An image made by heif_image_create on the card, filled through
    heif_image_get_plane (writes reach the image), read back equal, then
    encoded as unci through the context's encode_image, written, and read
    back through the API on the card equal."""
    w, h = API_IMAGE
    want = sampled_image(w, h, "420", 12)
    img = api.heif_image_create(w, h, Colorspace.YCbCr, Chroma.C420)
    assert img.device.type == DEV
    for ch in (Channel.Y, Channel.Cb, Channel.Cr):
        pw, ph = want.plane_size(ch)
        api.heif_image_add_plane(img, ch, pw, ph, 8)
        assert api.heif_image_get_plane(img, ch).device.type == DEV
        api.heif_image_get_plane(img, ch)[:] = want.plane(ch)
    for ch in (Channel.Y, Channel.Cb, Channel.Cr):
        assert torch.equal(api.heif_image_get_plane_readonly(img, ch),
                           want.plane(ch)), f"write through {ch} lost"
    ctx = api.heif_context_alloc()
    ctx.new_file()
    ctx.encode_image(img, "unci")
    blob = api.heif_context_write(ctx)
    back = api_decode(blob, Colorspace.Undefined, Chroma.Undefined)
    for ch in (Channel.Y, Channel.Cb, Channel.Cr):
        p = api.heif_image_get_plane_readonly(back, ch)
        assert p.device.type == DEV and torch.equal(p, want.plane(ch)), \
            f"the unci file's {ch} differs from the image"
    log(f"check api heif_image_create {w}x{h}: planes written through "
        f"heif_image_get_plane, read back, encoded as unci ({len(blob)} B) "
        f"and decoded through the API on the card, all equal ({card})")
    return {"size": [w, h], "unci_bytes": len(blob)}


def check_api(photo, jpeg_photo, unci_grid):
    """Phase 4n: the HEVC photo, the JPEG photo and the 4096x4096 unci
    grid with alpha through the API on the card (each equal to
    HeifContext's decode, with its launch counts), the small file's walk
    (card against CPU), and an image made by heif_image_create."""
    t_start = time.perf_counter()
    card = nvidia_smi()
    photos = {
        "hevc photo": check_api_photo(
            "hevc photo", photo, Chroma.InterleavedRGB,
            {"hevc_dequant_itx": 1, "hevc_intra_wave": 1,
             "planes_ycbcr8_to_rgb": 1}, card),
        "jpeg photo": check_api_photo(
            "jpeg photo", jpeg_photo, Chroma.InterleavedRGB,
            {"jpeg_dequant_idct": 1, "planes_ycbcr8_to_rgb": 1}, card),
        "unci grid+alpha": check_api_photo(
            "unci grid+alpha", unci_grid, Chroma.InterleavedRGBA,
            {"strided_extract_paste": TILES * TILES + 1,
             "planes_ycbcr8_to_rgb": 1}, card)}
    walk = check_api_walk(card)
    image = check_api_image(card)
    seconds = time.perf_counter() - t_start
    log(f"api phase {seconds:.1f} s ({card})")
    return {"card": card, "photos": photos, "walk": walk, "image": image,
            "seconds": seconds}


def api_launches(api_phase):
    """{kernel: {path: launches}} of phase 4n's decodes."""
    out = {}
    for what, r in api_phase["photos"].items():
        for name, n in r["launches"].items():
            out.setdefault(name, {})[f"api {what}"] = n
    return out


def api_alone(tally):
    """Phase 4n alone, on card 0."""
    uncC, cmpd, data = flagship_input()
    return check_api(photo_file(hevc_streams()),
                     jpeg_photo_file(jpeg_streams()),
                     grid_file(data, alpha_payload())), None


# ---------------------------------------------------------------- api write
# Phase 4o: the write side of the C-named API on the card: encoding,
# tiling, unci, components, regions, plugins and sequences as a user calls
# them, each file against the JAX writer's SHA-256.

API_MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "libheif_tpu_torch", "testdata", "api",
                            "manifest.json")
API_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "libheif_tpu_torch")
API_QUALITY = 90
API_THUMB_BOX = 256
API_SEQUENCE = (176, 144, 3, 25)     # QCIF, frames, panning_scene seed
# heif_image_add_component's twelve (datatype, bits), the typed getter's
# suffix and the torch dtype
API_COMPONENTS = (
    ("unsigned", 8, "uint8", torch.uint8),
    ("unsigned", 16, "uint16", torch.uint16),
    ("unsigned", 32, "uint32", torch.uint32),
    ("unsigned", 64, "uint64", torch.uint64),
    ("signed", 8, "int8", torch.int8), ("signed", 16, "int16", torch.int16),
    ("signed", 32, "int32", torch.int32), ("signed", 64, "int64", torch.int64),
    ("float", 32, "float32", torch.float32),
    ("float", 64, "float64", torch.float64),
    ("complex", 32, "complex32", torch.complex64),
    ("complex", 64, "complex64", torch.complex128))
# a plugin that takes over the jpeg format: the built-in decoder on the
# CPU, its planes handed back as numpy arrays, its calls counted
API_JPEG_PLUGIN = '''
from libheif_tpu_torch.codecs import registry

CALLS = [0]


class CountingJpeg(registry.Decoder):
    id = "counting-jpeg"
    format = "jpeg"
    priority = 1000

    def decode_single_image(self, config_box, data, declared_size=None,
                            limits=None):
        CALLS[0] += 1
        img = registry.get_decoder("jpeg", "tpu-jpeg").on_device(
            "cpu").decode_single_image(config_box, data, declared_size,
                                       limits)
        img.planes = {ch: p.numpy() for ch, p in img.planes.items()}
        return img


def register():
    registry.register_decoder(CountingJpeg())
'''


def api_image(planes, space=Colorspace.YCbCr, chroma=Chroma.C420):
    """An image made through the API on the card from {channel: tensor
    on the card}, 8-bit: heif_image_create, heif_image_add_plane, each
    plane written through heif_image_get_plane."""
    main = planes.get(Channel.Y, next(iter(planes.values())))
    img = api.heif_image_create(main.shape[1], main.shape[0], space, chroma)
    for ch, p in planes.items():
        api.heif_image_add_plane(img, ch, p.shape[1], p.shape[0], 8)
        api.heif_image_get_plane(img, ch).copy_(p)
    return img


def only_launches(what, launches, want):
    """``launches`` (from launch_counts) hold ``want`` {kernel: launches}
    and no launch of another kernel."""
    for name in ALL_KERNELS:
        assert launches[name] == want.get(name, 0), \
            f"{what}: {name} launched {launches[name]} times, not " \
            f"{want.get(name, 0)}"
    return {k: launches[k] for k in want}


def planes_equal(what, got, want):
    """{channel: tensor} planes on the card, sample for sample."""
    for ch, p in want.items():
        g = got.plane(ch)
        assert g.device.type == DEV, f"{what} {ch} not on the card"
        assert g.shape == p.shape and torch.equal(g, p), \
            f"{what}: {ch} differs"


def check_api_encode_photo(planes, man):
    """(a) The photo through heif_context_encode_image and
    heif_context_encode_thumbnail with the jpeg encoder at quality 90:
    one jpeg_fdct_quant launch each."""
    def build():
        ctx = api.heif_context_alloc()
        enc = api.heif_context_get_encoder_for_format(ctx, "jpeg")
        api.heif_encoder_set_lossy_quality(enc, API_QUALITY)
        img = api_image(planes)
        h = api.heif_context_encode_image(ctx, img, enc)
        api.heif_context_encode_thumbnail(ctx, img, h, enc, None,
                                          API_THUMB_BOX)
        return api.heif_context_write(ctx)
    blob, launches, _, wall = card_write("api photo", build,
                                         man["files"]["photo"]["sha256"])
    ms = wall["card_ms"]
    return {"bytes": len(blob), "ms": ms, "launches": only_launches(
        "api write photo", launches, {"jpeg_fdct_quant": 2})}


def check_api_encode_grid(tiles, man):
    """(b) heif_context_encode_grid of the photo's 6x8 tiles as jpeg
    tiles (one jpeg_fdct_quant launch a tile), read back through
    heif_decode_image to interleaved RGB (one jpeg_dequant_idct launch for
    the grid, one planes_ycbcr8_to_rgb) equal to HeifContext's decode."""
    imgs = [api_image(t) for t in tiles]

    def build():
        ctx = api.heif_context_alloc()
        enc = api.heif_context_get_encoder_for_format(ctx, "jpeg")
        h = api.heif_context_encode_grid(
            ctx, [imgs[i % 4] for i in range(48)], 6, 8, enc.impl,
            EncodingOptions(quality=API_QUALITY))
        api.heif_context_set_primary_image(ctx, h)
        return api.heif_context_write(ctx)
    blob, launches, _, wall = card_write("api grid", build,
                                         man["files"]["grid"]["sha256"])
    ms = wall["card_ms"]
    out = {"bytes": len(blob), "ms": ms, "launches": only_launches(
        "api write grid", launches, {"jpeg_fdct_quant": 48})}
    t0 = time.perf_counter()
    with launch_counts() as launches:
        img = api_decode(blob, Colorspace.RGB, Chroma.InterleavedRGB)
    out["read_ms"] = ms_since(t0)
    out["read_launches"] = only_launches(
        "api grid read", launches,
        {"jpeg_dequant_idct": 1, "planes_ycbcr8_to_rgb": 1})
    ref = HeifContext.read_from_bytes(blob).decode_image(
        None, Colorspace.RGB, Chroma.InterleavedRGB)
    assert (img.width, img.height) == (4096, 3072)
    planes_equal("api grid read", img, {Channel.Interleaved: ref.plane(
        Channel.Interleaved)})
    return out


def check_api_unci(man):
    """(c) heif_context_add_empty_unci_image of 4096x4096 in 512x512
    tiles, 64 heif_context_add_image_tile calls with the flagship's
    planes (no kernel launch: the tiles are packed by torch ops), read
    back tile by tile through heif_image_handle_decode_image_tile (a tili
    image is read per tile only; one strided_extract_paste a tile), each
    tile equal to the input's.  The item holds 65 iloc extents (the tiled
    header and one a tile), above the default security limit of 32: the
    reading context raises it, as a reader of the JAX writer's file
    must."""
    _, _, data = flagship_input()
    t = W // TILES
    full = {ch: torch.from_numpy(np.ascontiguousarray(p)).to(DEV)
            for ch, p in zip(YCC, np_planes(data, TILES, t, t))}

    def tile(tx, ty):
        return {ch: p[ty * s:(ty + 1) * s, tx * s:(tx + 1) * s]
                for ch, p in full.items()
                for s in ((t if ch == Channel.Y else t // 2),)}

    def build():
        ctx = api.heif_context_alloc()
        p = api.heif_unci_image_parameters_alloc()
        p.image_width, p.image_height = W, H
        p.tile_width = p.tile_height = t
        h = api.heif_context_add_empty_unci_image(ctx, p)
        for ty in range(TILES):
            for tx in range(TILES):
                api.heif_context_add_image_tile(ctx, h, tx, ty,
                                                api_image(tile(tx, ty)), None)
        return api.heif_context_write(ctx)
    blob, launches, _, wall = card_write("api unci", build,
                                         man["files"]["unci"]["sha256"])
    ms = wall["card_ms"]
    out = {"bytes": len(blob), "ms": ms, "launches": only_launches(
        "api write unci", launches, {})}
    t0 = time.perf_counter()
    with launch_counts() as launches:
        ctx = api.heif_context_alloc()
        api.heif_context_get_security_limits(ctx) \
            .max_iloc_extents_per_item = TILES * TILES + 1
        api.heif_context_read_from_memory(ctx, blob)
        h = api.heif_context_get_primary_image_handle(ctx)
        got = {(tx, ty): api.heif_image_handle_decode_image_tile(
            h, "undefined", "undefined", None, tx, ty)
            for ty in range(TILES) for tx in range(TILES)}
    out["read_ms"] = ms_since(t0)
    out["read_launches"] = only_launches(
        "api unci read", launches, {"strided_extract_paste": TILES * TILES})
    for (tx, ty), img in got.items():
        planes_equal(f"api unci tile ({tx}, {ty})", img, tile(tx, ty))
    return out


def check_api_tiles(photo, planes):
    """(d) heif_image_handle_decode_image_tile of the HEVC photo's tiles
    (0, 0) and (7, 5) to interleaved RGB (one launch of each HEVC kernel
    and of planes_ycbcr8_to_rgb a tile): the tile's YCbCr equal to the
    whole decode's crop where they overlap, its RGB to the conversion of
    that YCbCr."""
    ctx = api.heif_context_alloc()
    api.heif_context_read_from_memory(ctx, photo)
    h = api.heif_context_get_primary_image_handle(ctx)
    tiling = api.heif_image_handle_get_image_tiling(h)
    assert (tiling.num_columns, tiling.num_rows, tiling.tile_width) == \
        (PHOTO_GRID[1], PHOTO_GRID[0], 512)
    out = {}
    for tx, ty in ((0, 0), (7, 5)):
        t0 = time.perf_counter()
        with launch_counts() as launches:
            rgb = api.heif_image_handle_decode_image_tile(
                h, Colorspace.RGB, Chroma.InterleavedRGB, None, tx, ty)
        ms = ms_since(t0)
        counts = only_launches(
            f"api tile ({tx}, {ty})", launches,
            {"hevc_dequant_itx": 1, "hevc_intra_wave": 1,
             "planes_ycbcr8_to_rgb": 1})
        ycc = api.heif_image_handle_decode_image_tile(
            h, "undefined", "undefined", None, tx, ty)
        for ch in YCC:
            s = 1 if ch == Channel.Y else 2
            p = ycc.plane(ch)
            whole = planes[ch][ty * 512 // s:, tx * 512 // s:]
            ph, pw = min(p.shape[0], whole.shape[0]), \
                min(p.shape[1], whole.shape[1])
            assert torch.equal(p[:ph, :pw], whole[:ph, :pw]), \
                f"tile ({tx}, {ty}) {ch} differs from the whole decode"
        want = convert_image(ycc, Colorspace.RGB, Chroma.InterleavedRGB)
        planes_equal(f"api tile ({tx}, {ty}) RGB", rgb, {
            Channel.Interleaved: want.plane(Channel.Interleaved)})
        out[f"{tx},{ty}"] = {"ms": ms, "launches": counts}
        log(f"check api tile ({tx}, {ty}): {rgb.width}x{rgb.height} RGB "
            f"equal to the whole decode's crop in {ms:.1f} ms; {counts}")
    return out


def check_api_components(planes):
    """(e) One heif_image_add_component of each datatype at the photo's
    size on the card, written whole from the host and read back through
    its typed getter (the same tensor); an inline mask region made from
    the photo's luma and unpacked by heif_region_get_mask_image on the
    card."""
    w, h = PHOTO
    img = api.heif_image_create(w, h, Colorspace.YCbCr, Chroma.C420)
    base = np.arange(w * h, dtype=np.int64).reshape(h, w) % 251
    t0 = time.perf_counter()
    for cid, (datatype, bits, suffix, dtype) in enumerate(API_COMPONENTS):
        a = api.heif_image_add_component(img, cid, "custom", datatype, bits,
                                         w, h)
        assert a.device.type == DEV and a.dtype == dtype and \
            a.shape == (h, w), (suffix, a.dtype, a.device)
        assert int(torch.count_nonzero(a.view(torch.uint8))) == 0, suffix
        host = torch.from_numpy(base).to(dtype) if not dtype.is_complex \
            else torch.complex(torch.from_numpy(base).to(
                torch.float64), -torch.from_numpy(base).to(
                    torch.float64)).to(dtype)
        a.copy_(host)
        got = getattr(api, f"heif_image_get_component_{suffix}")(img, cid)
        assert got is a and getattr(
            api, f"heif_image_get_component_{suffix}_readonly")(img, cid) \
            is a, suffix
        assert torch.equal(got.cpu().view(torch.uint8),
                           host.view(torch.uint8)), suffix
        assert api.heif_image_get_component_datatype(img, cid) == datatype
        assert api.heif_image_get_component_bits_per_pixel(img, cid) == bits
    try:
        api.heif_image_get_component_uint8(img, 1)
        raise AssertionError("a uint16 component read as uint8")
    except HeifError:
        pass
    comp_ms = ms_since(t0)
    del img
    ctx = api.heif_context_alloc()
    enc = api.heif_context_get_encoder_for_format(ctx, "jpeg")
    handle = api.heif_context_encode_image(
        ctx, sampled_image(64, 48, "420", 13), enc)
    ri = api.heif_image_handle_add_region_item(handle, w, h)
    mask = api_image({Channel.Y: planes[Channel.Y]}, Colorspace.Monochrome,
                     Chroma.Monochrome)
    t0 = time.perf_counter()
    with launch_counts() as launches:
        region = api.heif_region_item_add_region_inline_mask(
            ri, 0, 0, w, h, mask)
        x, y, mw, mh, out = api.heif_region_get_mask_image(region)
    mask_ms = ms_since(t0)
    only_launches("api inline mask", launches, {})
    assert (x, y, mw, mh) == (0, 0, w, h) and len(region.mask_data) == \
        w * h // 8
    want = ((planes[Channel.Y] >> 7) * 255).to(torch.uint8)
    planes_equal("api inline mask", out, {Channel.Y: want})
    log(f"check api components: {len(API_COMPONENTS)} datatypes at {w}x{h} "
        f"on the card in {comp_ms:.1f} ms; inline mask packed and unpacked "
        f"on the card in {mask_ms:.1f} ms")
    return {"components": len(API_COMPONENTS), "components_ms": comp_ms,
            "mask_ms": mask_ms}


def check_api_plugins(jpeg_photo, planes):
    """(f) A .py plugin that takes the jpeg format (priority 1000) serving
    the JPEG photo through heif_decode_image tile by tile, its numpy planes
    moved to the card, equal to the built-in decode after
    heif_unload_plugin (one jpeg_dequant_idct launch); then
    bindings/c/example_plugin.c built with cc and loaded, the photo's luma
    through its encoder and decoder onto the card."""
    os.makedirs(API_BUILD, exist_ok=True)
    path = os.path.join(API_BUILD, "api_counting_jpeg_plugin.py")
    with open(path, "w") as f:
        f.write(API_JPEG_PLUGIN)
    handle = api.heif_load_plugin(path)
    assert [d.id for d in handle.decoders] == ["counting-jpeg"]
    t0 = time.perf_counter()
    try:
        with launch_counts() as launches:
            img = api_decode(jpeg_photo, Colorspace.RGB, Chroma.InterleavedRGB)
        calls = handle.module.CALLS[0]
    finally:
        api.heif_unload_plugin(handle)
    plugin_ms = ms_since(t0)
    assert calls == PHOTO_GRID[0] * PHOTO_GRID[1], calls
    plugin_launches = only_launches("api jpeg plugin", launches,
                                    {"planes_ycbcr8_to_rgb": 1})
    t0 = time.perf_counter()
    with launch_counts() as launches:
        ref = api_decode(jpeg_photo, Colorspace.RGB, Chroma.InterleavedRGB)
    builtin_ms = ms_since(t0)
    builtin_launches = only_launches(
        "api jpeg after unload", launches,
        {"jpeg_dequant_idct": 1, "planes_ycbcr8_to_rgb": 1})
    planes_equal("api jpeg plugin", img, {Channel.Interleaved: ref.plane(
        Channel.Interleaved)})

    so = os.path.join(API_BUILD, "grayraw_plugin.so")
    cdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bindings", "c")
    t0 = time.perf_counter()
    subprocess.run(["cc", "-shared", "-fPIC", "-O2",
                    os.path.join(cdir, "example_plugin.c"), f"-I{cdir}",
                    "-o", so], check=True, capture_output=True)
    cc_ms = ms_since(t0)
    native = api.heif_load_plugin(so)
    try:
        luma = planes[Channel.Y]
        t0 = time.perf_counter()
        data, _, _ = registry.get_encoder("grayraw").encode_single_image(
            api_image({Channel.Y: luma}, Colorspace.Monochrome,
                      Chroma.Monochrome))
        back = registry.decoder_for("grayraw", None, None) \
            .decode_single_image(None, data)
        native_ms = ms_since(t0)
    finally:
        api.heif_unload_plugin(native)
    assert not registry.have_decoder("grayraw")
    planes_equal("api grayraw plugin", back, {Channel.Y: luma})
    log(f"check api plugins: {calls} calls of the jpeg plugin, decode "
        f"{plugin_ms:.1f} ms (built-in {builtin_ms:.1f} ms), equal; "
        f"grayraw .so built in {cc_ms:.1f} ms, {len(data)} B round trip "
        f"of the luma in {native_ms:.1f} ms, equal on the card")
    return {"plugin_calls": calls, "plugin_ms": plugin_ms,
            "plugin_launches": plugin_launches, "builtin_ms": builtin_ms,
            "builtin_launches": builtin_launches, "cc_ms": cc_ms,
            "native_ms": native_ms}


def check_api_sequence(man):
    """(g) A QCIF ipp hevc track through heif_context_add_visual_sequence_
    track and heif_track_encode_sequence_image (the encoder's references
    decoded on the card: hevc_inter_pred once a P picture, hevc_intra_wave
    once for the IDR), then read back with heif_track_decode_next_image
    equal to HeifContext's track decode, the same launches."""
    w, h, n, seed = API_SEQUENCE
    frames = [api_image({c: torch.from_numpy(p).to(DEV)
                         for c, p in zip(YCC, f)})
              for f in inter_cases.panning_scene(w, h, n, seed)]

    def build():
        ctx = api.heif_context_alloc()
        tw = api.heif_context_add_visual_sequence_track(
            ctx, w, h, "vide", "hevc",
            TrackOptions(timescale=30, inter_frames="ipp"))
        for img in frames:
            api.heif_track_encode_sequence_image(tw, img)
        api.heif_track_encode_end_of_sequence(tw)
        return api.heif_context_write(ctx)
    blob, launches, _, wall = card_write("api sequence", build,
                                         man["files"]["sequence"]["sha256"])
    ms = wall["card_ms"]
    itx = launches["hevc_dequant_itx"]
    assert 1 <= itx <= n, launches
    want = {"hevc_inter_pred": n - 1, "hevc_intra_wave": 1,
            "hevc_dequant_itx": itx}
    out = {"bytes": len(blob), "ms": ms,
           "launches": only_launches("api write sequence", launches, want)}
    ctx = api.heif_context_alloc()
    api.heif_context_read_from_memory(ctx, blob)
    track = api.heif_context_get_track(ctx, 0)
    ref = HeifContext.read_from_bytes(blob).tracks[0]
    t0 = time.perf_counter()
    with launch_counts() as launches:
        got = [api.heif_track_decode_next_image(track) for _ in range(n)]
    out["read_ms"] = ms_since(t0)
    out["read_launches"] = only_launches("api sequence read", launches,
                                         want)
    for i, img in enumerate(got):
        r = ref.decode_next_image()
        planes_equal(f"api sequence frame {i}", img,
                     {ch: r.plane(ch) for ch in YCC})
    return out


def check_api_write(photo, jpeg_photo):
    """Phase 4o: the write side of the C-named API on the card, steps (a)
    to (g) above, each against the JAX writer's SHA-256 (testdata/api/
    manifest.json, tests/api_writes.py) or its reference on the card,
    with its launch counts."""
    t_start = time.perf_counter()
    card = nvidia_smi()
    man = read_manifest(API_MANIFEST)
    steps, walls = {}, {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        steps[name] = fn(*args)
        walls[name] = time.perf_counter() - t0
    img = HeifContext.read_from_bytes(photo).decode_image(None)
    assert (img.width, img.height, img.chroma) == (*PHOTO, Chroma.C420)
    planes = {ch: img.plane(ch) for ch in YCC}
    tiles = [{ch: p[:512 // s, 512 * i // s:512 * (i + 1) // s]
              for ch, p in planes.items()
              for s in ((1 if ch == Channel.Y else 2),)} for i in range(4)]
    walls["photo_decode"] = time.perf_counter() - t_start
    step("photo", check_api_encode_photo, planes, man)
    step("grid", check_api_encode_grid, tiles, man)
    step("unci", check_api_unci, man)
    step("tiles", check_api_tiles, photo, planes)
    step("components", check_api_components, planes)
    step("plugins", check_api_plugins, jpeg_photo, planes)
    step("sequence", check_api_sequence, man)
    seconds = time.perf_counter() - t_start
    log(f"phase 4o steps (s) {json.dumps(walls)} ({card})")
    log(f"api write phase {seconds:.1f} s ({card})")
    return {"card": card, "steps": steps, "step_seconds": walls,
            "seconds": seconds}


def api_write_launches(api_write_phase):
    """{kernel: {path: launches}} of phase 4o's writes and reads."""
    out = {}
    for what, r in api_write_phase["steps"].items():
        for key in ("launches", "read_launches", "plugin_launches",
                    "builtin_launches"):
            for name, n in r.get(key, {}).items():
                out.setdefault(name, {})[f"api {what} {key}"] = n
        if what == "tiles":
            for at, t in r.items():
                for name, n in t["launches"].items():
                    out.setdefault(name, {})[f"api tile {at}"] = n
    return out


def api_write_alone(tally):
    """Phase 4o alone, on card 0."""
    return check_api_write(photo_file(hevc_streams()),
                           jpeg_photo_file(jpeg_streams())), None


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


HOST_LIBRARIES = (_build.HOST_LIBRARY, _build.JPEG_HOST_LIBRARY,
                  _build.AVC_HOST_LIBRARY, _build.J2K_HOST_LIBRARY)


def build_library():
    """Build (or load) every kernel, logging the time and ptxas's lines;
    the codecs' host C++ libraries build on threads meanwhile (each one
    ``c++``), so that no later phase waits for its build."""
    t0 = time.perf_counter()
    hosts = concurrent.futures.ThreadPoolExecutor(len(HOST_LIBRARIES))
    built = [hosts.submit(lib.load) for lib in HOST_LIBRARIES]
    _build.LIBRARY.load()
    log(f"built {_build.LIBRARY.path} in {time.perf_counter() - t0:.1f} s")
    for lib, b in zip(HOST_LIBRARIES, built):
        b.result()
        log(f"built {lib.path} by {time.perf_counter() - t0:.1f} s")
    hosts.shutdown()
    for line in _build.LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("ptxas:", line.strip())


def flagship_input():
    """The flagship unci item's uncC, cmpd and random payload."""
    uncC, cmpd = ycc420(W, H, (TILES, TILES))
    data = np.random.default_rng(SEED).integers(
        0, 256, W * H * 3 // 2, dtype=np.uint8).tobytes()
    return uncC, cmpd, data


def run_alone(what, body):
    """One phase alone (``python3 chip_smoke.py --<what>-only``): the card's
    line and the build, then ``body(tally)`` -> (its summary, its kernel
    rows or None), then the same last lines as ``main`` (the kernels line,
    where there are rows, holding those rows only)."""
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    log(nvidia_smi())
    device0 = torch.cuda.current_device()
    build_library()
    tally = Tally()
    summary, rows = body(tally)
    assert torch.cuda.current_device() == device0, \
        f"phase {what} left another current device"
    log("summary " + json.dumps({what: summary, "checks": tally.checks,
                                 "elapsed_s": time.perf_counter() - t0}))
    if rows is not None:
        print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def encode_alone(tally):
    """Phases 4i and 4j and the two encode kernels' rows, on card 0."""
    install_av1_parse_once()
    uncC, cmpd, data = flagship_input()
    _, flagship, _ = decode_and_convert(uncC, cmpd, W, H, data)
    enc, ycc, luma = check_encode(tally, photo_file(hevc_streams()),
                                  flagship)
    wr = check_write()
    timer = DeviceTimer()
    fdct = {f"jpeg encode q{q} with alpha": r["launches"]["jpeg_fdct_quant"]
            for q, r in enc["jpeg"].items()}
    fdct.update(write_launches(wr, "jpeg_fdct_quant"))
    row = jpeg_fdct_row(timer, tally, ycc, sum(fdct.values()))
    row["launches_by_path"] = fdct
    return {"encode": enc, "write": wr}, [
        row, mode_search_row(timer, tally, luma, mode_search_launches(enc))]


def sequences_alone(tally):
    """Phase 4h and hevc_inter_pred's row, on card 0."""
    seq, captured, stress = check_sequences(tally)
    return seq, [inter_pred_row(
        DeviceTimer(), tally, captured["x265-1920x1080"],
        sum(seq[n]["launches"]["hevc_inter_pred"] for n in SEQ_STREAMS),
        stress)]


def mesh_alone(tally):
    """Phase 4g on every card present (a machine with several cards runs
    the cards' mesh over all of them)."""
    uncC, cmpd, data = flagship_input()
    return check_mesh(tally, uncC, cmpd, data,
                      np_planes(data, TILES, W // TILES, H // TILES),
                      photo_file(hevc_streams())), None


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_s = {}        # seconds since the start at the end of each phase

    device0 = torch.cuda.current_device()

    def phase_done(name):
        last = max(phase_s.values(), default=0.0)
        phase_s[name] = time.perf_counter() - t_start
        log(f"phase {name} done at {phase_s[name]:.1f} s, took "
            f"{phase_s[name] - last:.1f} s")
        assert torch.cuda.current_device() == device0, \
            f"phase {name} left the current device at " \
            f"{torch.cuda.current_device()}, not {device0}"

    # 1. the card
    card = nvidia_smi()
    log(card)
    sms, mhz, int32_ops_per_s = int32_rate()
    log(f"int32 rate: {sms} SMs x {INT32_LANES_PER_SM} lanes x {mhz} MHz "
        f"(clocks.max.sm) = {int32_ops_per_s:.6g} operations/s")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. build
    build_library()
    install_av1_parse_once()

    phase_done("build")

    # 3. each kernel against its plain version
    tally = Tally()
    check_kernels(tally)
    small_input_check(tally)
    core_counts = check_colour_core()

    phase_done("kernels")

    # 4. the main path at full width
    uncC, cmpd = ycc420(W, H, (TILES, TILES))
    rng = np.random.default_rng(SEED)
    data = rng.integers(0, 256, W * H * 3 // 2, dtype=np.uint8).tobytes()
    with launch_counts() as main_launches:
        dec, img, rgb = decode_and_convert(uncC, cmpd, W, H, data)
    log(f"main path launches {main_launches}")
    for name in ("strided_extract_paste", "planes_ycbcr8_to_rgb"):
        assert main_launches[name] > 0, f"main path did not launch {name}"
    assert main_launches["strided_extract_paste"] == 1, \
        "strided_extract_paste: not one launch per decode"
    assert main_launches["assemble_tile_buffers"] == 0, \
        "the CUDA strided path assembled tile buffers"
    lay = dec.layout
    tiles_np = kernels.assemble_tile_buffers(lay, data)
    tiles = torch.from_numpy(tiles_np).to(DEV)
    generic = kernels._build_extractor(kernels._layout_key(lay))(tiles)
    for ch, ref in zip((Channel.Y, Channel.Cb, Channel.Cr),
                       np_planes(data, TILES, W // TILES, H // TILES)):
        tally.compare("strided_extract_paste", f"main path {W}x{H} {ch}",
                      img.plane(ch), generic[ch], exact=True)
        assert np.array_equal(img.np_plane(ch), ref), f"{ch} vs numpy"
    try:
        YCbCrToRGB.USE_KERNEL = False        # the plain path on the card
        plain_rgb = convert_image(img, Colorspace.RGB, Chroma.C444)
    finally:
        YCbCrToRGB.USE_KERNEL = None
    out = rgb_of(rgb)
    assert out.shape == (3, H, W) and out.dtype == torch.uint8
    tally.compare("planes_ycbcr8_to_rgb", f"main path {W}x{H} RGB",
                  out, rgb_of(plain_rgb), exact=True)

    phase_done("main_path")

    # 4b. the file path: HEIF files through HeifContext
    alpha = alpha_payload()
    blobs, file_launches = check_files(data, alpha, out)

    phase_done("files")

    # 4c. HEVC: the kernels, the streams, the phone photo, hvc1 files
    streams = hevc_streams()
    check_hevc_kernels(tally, streams)
    check_extreme_groups(tally)
    check_hevc_streams(streams)
    photo = photo_file(streams)
    plan = photo_plan(streams)
    log(f"hevc photo file {len(photo)} B, {plan.t} tiles, "
        f"{plan.n_waves} waves, groups "
        f"{ {str(g.key): g.n for g in plan.groups} }")
    check_waves(tally, f"photo {plan.t} tiles", plan,
                check_residuals(tally, f"photo {plan.t} tiles", plan))
    photo_launches = check_photo(photo, streams, plan)
    # the slices photo: scaling lists and several slices, one batch
    s_photo = photo_file(streams, SLICES_TILES)
    s_plan = photo_plan(streams, SLICES_TILES)
    log(f"hevc slices photo file {len(s_photo)} B, {s_plan.t} tiles, "
        f"{s_plan.n_waves} waves, factor slots {s_plan.mtab.shape[0]}, "
        f"groups { {str(g.key): g.n for g in s_plan.groups} }")
    check_waves(tally, f"slices photo {s_plan.t} tiles", s_plan,
                check_residuals(tally, f"slices photo {s_plan.t} tiles",
                                s_plan))
    s_launches = check_photo(s_photo, streams, s_plan, SLICES_TILES,
                             "hevc slices photo")
    hvc1_blobs = check_hvc1_files(streams)

    phase_done("hevc")

    # 4e. JPEG (before 4d: its photo's profiler session is the process's
    # first; later sessions of that decode have recorded no device
    # event): the kernel, the streams, the JPEG photo, jpeg/mini/tili/mski
    j_streams = jpeg_streams()
    j_frames = check_jpeg_kernel(tally, j_streams)
    check_jpeg_streams(j_streams)
    j_photo = jpeg_photo_file(j_streams)
    log(f"jpeg photo file {len(j_photo)} B, {len(j_frames)} tiles")
    j_launches, j_first, j_rgb = check_jpeg_photo(j_photo, j_streams)
    j_runs = time_jpeg_photo(j_photo, j_rgb, j_first)
    check_jpeg_files(j_streams, streams, data)

    phase_done("jpeg")

    # 4d. AV1: the kernels, the streams, the AVIF photo, av01 files
    av1_steps = {}
    t_step = time.perf_counter()

    def av1_step(name):
        nonlocal t_step
        av1_steps[name] = time.perf_counter() - t_step
        t_step = time.perf_counter()
    a_streams = av1_streams()
    check_av1_kernels(tally, a_streams)
    av1_step("kernels")
    check_av1_streams(a_streams)
    av1_step("streams")
    a_photo = av1_photo_file(a_streams)
    t0 = time.perf_counter()
    a_plan = av1_photo_plan(a_streams)
    a_plan_ms = ms_since(t0)
    a_groups = {f"{av1_recon.KIND_NAMES[g.kind]}{g.sq}": g.n
                for g in a_plan.groups}
    log(f"av1 photo file {len(a_photo)} B, {AV1_PHOTO_GRID} tiles; "
        f"kernel plan {a_plan.t} tiles, {a_plan.n_waves} waves, groups "
        f"{a_groups}, plan {a_plan_ms:.0f} ms")
    check_av1_plan(tally, f"photo {a_plan.t} tiles", a_plan)
    av1_step("photo_plan")
    # one decode under the profiler: launches, spans and the card's share
    a_launches, a_first, _a_rgb = check_av1_photo(
        a_photo, a_streams, AV1_PHOTO_GRID[0] * AV1_PHOTO_GRID[1],
        profile=True)
    av1_step("photo")
    g_photo = av1_photo_file(a_streams, GRAIN_TILES, GRAIN_GRID, GRAIN_PHOTO)
    log(f"av1 grain photo file {len(g_photo)} B, tiles {GRAIN_TILES}")
    g_launches, g_first, _g_rgb = check_av1_photo(
        g_photo, a_streams, GRAIN_GRID[0] * GRAIN_GRID[1], GRAIN_TILES,
        "av1 grain photo", grid_shape=GRAIN_GRID, size=GRAIN_PHOTO)
    av1_step("grain_photo")
    av01_blobs, shot_launches = check_av01_files(a_streams)
    av1_step("av01_files")
    log(f"av1 phase steps (s) {json.dumps(av1_steps)}")

    phase_done("av1")

    # 4f. colour: the six colour ops at 4096x4096, a Bayer file, a chain
    # through planes_ycbcr8_to_rgb, and the read-side metadata calls
    colour_rows = check_colour_ops(tally)
    metadata = check_metadata_file()

    phase_done("colour")

    # 4g. tile-parallel and sharded decode over every card and over a
    # virtual mesh of card 0
    mesh = check_mesh(tally, uncC, cmpd, data,
                      np_planes(data, TILES, W // TILES, H // TILES), photo)

    phase_done("mesh")

    # 4h. image sequences: the 1920x1080 sequences through HeifContext's
    # tracks (in order, random access, split by span), the kernels on their
    # P and B pictures' plans, and the uncv track
    t0 = time.perf_counter()
    seq, seq_captured, inter_stress = check_sequences(tally)
    seq["seconds"] = time.perf_counter() - t0
    log(f"phase 4h (sequences) took {seq['seconds']:.1f} s")

    phase_done("sequences")

    # 4i. still-image encode through HeifContext on the card: jpeg items of
    # the HEVC photo with alpha, unci items of the flagship, mski masks;
    # the FDCT kernel against its plain version; the intra mode search
    enc, enc_ycc, enc_luma = check_encode(tally, photo, img)

    phase_done("encode")

    # 4j. the write API on the card: inter hvc1 tracks from the sequence
    # encoder (its references decoded on the card) against the JAX
    # writer's hashes, 1920x1080 hvc1/mjpg/uncv tracks, a file with
    # everything a track carries, and the item writers, each against the
    # same calls on the CPU
    wr = check_write()

    phase_done("write")

    # 4k. AVC: the C++ intra engine, every committed stream on the card and
    # the CPU, the AVC photo (timed, split by span), items, a tili, tracks
    avc = check_avc(tally)

    phase_done("avc")

    # 4l. AVC encode (the photo with alpha, a tili, an IPPP track) and JPEG
    # 2000 (the committed codestreams, the photo, crops, a tili) through
    # HeifContext on the card, against the CPU and the JAX writer's files
    photo_planes = {ch: enc_ycc.plane(ch) for ch in YCC}
    avc_enc = check_avc_encode(photo_planes)

    phase_done("avc_encode")

    j2k = check_j2k(photo_planes)

    phase_done("j2k")

    # 4m. VVC: the committed streams, the 1920x1080 vvc1 item (the VVC main
    # path), a grid, a tili, vvc1 and vvi1 tracks, and three writes through
    # HeifContext on the card against the JAX writer's files
    vvc = check_vvc(tally)

    phase_done("vvc")

    # 4n. the read side of the C-named API on the card: the HEVC photo, the
    # JPEG photo and the unci grid with alpha through heif_decode_image,
    # the small file's read functions card against CPU, heif_image_create
    api_phase = check_api(photo, j_photo, blobs["grid"])

    phase_done("api")

    # 4o. the write side of the C-named API on the card: the photo and a
    # grid encoded as jpeg, an empty unci tiling filled tile by tile, tiles
    # of the HEVC photo, components and an inline mask, .py and .so
    # plugins, an hevc sequence track
    api_write_phase = check_api_write(photo, j_photo)

    phase_done("api_write")

    # 5. the fused tile path at full width
    fused_kw = dict(tile_rows=TILES, tile_cols=TILES, tile_h=H // TILES,
                    tile_w=W // TILES, kr=float(KR), kb=float(KB))
    with launch_counts() as fused_launches:
        fused = cuda_fast.yuv420_tiles_to_rgb(tiles, **fused_kw)
    log(f"fused path launches {fused_launches}")
    assert fused_launches["tile_yuv_to_rgb"] > 0
    nearest = convert_image(img, Colorspace.RGB, Chroma.C444,
                            options=ColorConversionOptions(
                                chroma_upsampling="nearest-neighbor"))
    tally.compare("tile_yuv_to_rgb", f"fused {W}x{H} vs main path, nearest",
                  fused, rgb_of(nearest), exact=False)
    tally.compare("tile_yuv_to_rgb", f"fused {W}x{H} vs plain",
                  fused, cuda_fast.yuv_tiles_to_rgb_plain(
                      tiles, sub_x=2, sub_y=2, **fused_kw), exact=True)

    phase_done("fused")

    # 6. timing
    timer = DeviceTimer()
    copies = [tiles.clone() for _ in range(4)]    # 100 MB: inputs not in L2
    plane_copies = [tuple(img.plane(c).clone() for c in
                          (Channel.Y, Channel.Cb, Channel.Cr))
                    for _ in range(4)]
    px = W * H
    in_bytes = px * 3 // 2
    kern = {}

    # the colour kernels' yardstick: a device-to-device copy_ that moves
    # as many bytes (half read, half written), over four copies
    colour_bytes = in_bytes + 3 * px
    srcs = [torch.empty(colour_bytes // 2, dtype=torch.uint8, device=DEV)
            for _ in range(4)]
    dst = torch.empty_like(srcs[0])
    copy_ms = timer([lambda s=s: dst.copy_(s) for s in srcs])

    def launches_by_path(name):
        return {"file_grid_alpha": file_launches[name],
                "library_4096": main_launches[name],
                "fused_4096": fused_launches[name]}

    def row(name, replaces, also, launches, fn, plain, lib, nbytes, nops,
            by_path, extra=None):
        ms, plain_ms = timer(fn), timer(plain)
        lib_ms = timer(lib) if lib is not None else None
        b = bounds(nbytes, nops, F32_OPS_PER_S)
        kern[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "also_replaces": also,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": tally.max_abs_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": lib_ms,
            "checks": tally.checks[name],
            "differing_pixels": tally.differing[name],
            "bytes": nbytes, "ops": nops, **(extra or {})}

    # f32 operations per output pixel: tile 20 (2 offsets, 9 matrix, 9
    # round/clip), planes 22 (+2 scale); limited range is not timed
    row("tile_yuv_to_rgb", f"{PALLAS}:124",
        [f"{PALLAS}:370"], fused_launches["tile_yuv_to_rgb"],
        [lambda t=t: cuda_fast.yuv420_tiles_to_rgb(t, **fused_kw)
         for t in copies],
        [lambda t=t: cuda_fast.yuv_tiles_to_rgb_plain(
            t, sub_x=2, sub_y=2, **fused_kw) for t in copies],
        None, colour_bytes, 20 * px, launches_by_path("tile_yuv_to_rgb"),
        {"copy_ms": copy_ms})
    row("planes_ycbcr8_to_rgb", f"{PALLAS}:236", [f"{PALLAS}:144"],
        file_launches["planes_ycbcr8_to_rgb"],
        [lambda p=p: cuda_fast.ycbcr8_planes_to_rgb(*p, kr=float(KR),
                                                    kb=float(KB))
         for p in plane_copies],
        [lambda p=p: cuda_fast.ycbcr8_planes_to_rgb_plain(*p, kr=float(KR),
                                                          kb=float(KB))
         for p in plane_copies],
        None, colour_bytes, 22 * px, launches_by_path("planes_ycbcr8_to_rgb"),
        {"copy_ms": copy_ms})

    # strided_extract_paste on the main path's input, the payload read in
    # place at pitch S; the yardstick copy_ moves the same 50.3 MB
    inplace = [kernels.payload_tiles(lay, data, DEV) for _ in range(4)]
    for ch, p in as_strided_copy(lay, tiles).items():
        tally.compare("strided_extract_paste", f"as_strided yardstick {ch}",
                      img.plane(ch), p, exact=True)
    srcs = [torch.empty(in_bytes, dtype=torch.uint8, device=DEV)
            for _ in range(4)]
    dst = torch.empty_like(srcs[0])
    strided_copy_ms = timer([lambda s=s: dst.copy_(s) for s in srcs])
    del srcs, dst
    row("strided_extract_paste", f"{PALLAS}:401",
        [f"{PALLAS}:415", f"{PALLAS}:282"],
        file_launches["strided_extract_paste"],
        [lambda t=t: cuda_fast.fused_strided_decode(lay, t) for t in inplace],
        [lambda t=t: cuda_fast.fused_strided_decode_plain(lay, t)
         for t in inplace],
        [lambda t=t: as_strided_copy(lay, t) for t in inplace],
        2 * in_bytes, 0, launches_by_path("strided_extract_paste"), {
            "copy_ms": strided_copy_ms,
            "widths_pitch_s": strided_widths(lay, inplace[0]),
            "ms_pitch_s_plus_8": timer([
                lambda t=t: cuda_fast.fused_strided_decode(lay, t)
                for t in copies]),
            "widths_pitch_s_plus_8": strided_widths(lay, copies[0])})
    kern["planes_ycbcr8_to_rgb"]["launches_by_path"].update(
        avc_launches(avc))
    kern["planes_ycbcr8_to_rgb"]["launches_by_path"].update(
        encode_4l_launches(avc_enc, j2k))
    kern["planes_ycbcr8_to_rgb"]["launches_by_path"].update(
        vvc_launches(vvc))
    strided_sweep = strided_width_sweep(timer, lay, inplace)
    strided_layouts = strided_layout_timings(timer)

    # planar8_tiles_to_image, the copy case of strided_extract_paste (off
    # the main path): three 8-bit planes in the same 8x8 grid of tiles
    th, tw = H // TILES, W // TILES
    planar_kw = dict(tile_rows=TILES, tile_cols=TILES, tile_h=th, tile_w=tw,
                     num_comps=3)
    planar = [torch.from_numpy(rng.integers(
        0, 256, (TILES * TILES, 3 * th * tw + 8), dtype=np.uint8)).to(DEV)
        for _ in range(4)]

    def planar_copy(t):
        # one PyTorch call: the tile stack viewed as (C, H, W), made
        # contiguous (the yardstick; the port never calls it)
        return t[:, :3 * th * tw].view(TILES, TILES, 3, th, tw) \
            .permute(2, 0, 3, 1, 4).reshape(3, H, W)

    tally.compare("strided_extract_paste", f"planar8 copy case {W}x{H} C=3",
                  cuda_fast.planar8_tiles_to_image(planar[0], **planar_kw),
                  planar_copy(planar[0]), exact=True)
    planar_bound_ms = bounds(2 * 3 * px, 0, F32_OPS_PER_S)["bound_ms"]
    widths = vector_width_sweep(timer, rng, fused_kw, plane_copies)
    before = cuda_fast.STRIDED_EXTRACT_PASTE.launches
    cuda_fast.planar8_tiles_to_image(planar[0], **planar_kw)
    planar_launches = cuda_fast.STRIDED_EXTRACT_PASTE.launches - before
    planar8 = {
        "ms": timer([lambda t=t: cuda_fast.planar8_tiles_to_image(
            t, **planar_kw) for t in planar]),
        "plain_ms": timer([lambda t=t: cuda_fast.planar8_tiles_to_image_plain(
            t, **planar_kw) for t in planar]),
        "library_ms": timer([lambda t=t: planar_copy(t) for t in planar]),
        "bound_ms": planar_bound_ms,
        "launches_per_call": planar_launches}
    del planar

    # the library path end to end, and its parts
    def e2e():
        _, _, r = decode_and_convert(uncC, cmpd, W, H, data)
        return r
    e2e()
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        e2e()
    torch.cuda.synchronize()
    e2e_ms = (time.perf_counter() - t0) * 1e3 / reps
    # the parts on the path: the payload's host view and its host→device
    # copy (kernels.payload_tiles), then the device time; tile assembly is
    # timed for comparison only (the generic program's layouts need it)
    t0 = time.perf_counter()
    for _ in range(reps):
        kernels.payload_tiles(lay, data, DEV)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        kernels.assemble_tile_buffers(lay, data)
    assemble_ms = (time.perf_counter() - t0) * 1e3 / reps
    device_ms = timer([lambda t=t: convert_image(
        dec._to_image(cuda_fast.fused_strided_decode(lay, t), W, H),
        Colorspace.RGB, Chroma.C444) for t in inplace])
    fused_ms = kern["tile_yuv_to_rgb"]["ms"]
    grid_runs = time_grid_file(blobs["grid"])
    single_runs = time_single_file(blobs["single"], lay)
    file_device = file_device_share(blobs, grid_runs, single_runs)

    # the HEVC kernels at the photo's shapes, its stages and file path
    l_plan = photo_plan(streams, SLICES_TILES[:2] * 2)
    kern.update(hevc_kernel_rows(timer, tally, plan, photo_launches, s_plan,
                                 l_plan, s_launches))
    single = hevc_parse(streams[PHOTO_TILES[0]])
    wave_one = wave_single(timer, device_recon.build_plan(
        [single[0]], [single[1]], DEV))
    hevc_stages = stage_ms(timer, plan)
    photo_runs = time_photo(photo)
    s_photo_runs = time_photo(s_photo, "hevc slices photo")
    hvc1_runs = time_hvc1_single(hvc1_blobs["tile512_s0"])
    photo_device = photo_device_share(photo, photo_runs)

    # hevc_inter_pred at the largest P or B picture of the x265 sequence
    kern["hevc_inter_pred"] = inter_pred_row(
        timer, tally, seq_captured["x265-1920x1080"],
        sum(seq[n]["launches"]["hevc_inter_pred"] for n in SEQ_STREAMS),
        inter_stress)
    kern["hevc_inter_pred"]["launches_by_path"] = {
        f"sequence {n} in order": seq[n]["launches"]["hevc_inter_pred"]
        for n in SEQ_STREAMS}
    kern["hevc_inter_pred"]["launches_by_path"].update(
        write_launches(wr, "hevc_inter_pred"))
    kern["hevc_inter_pred"]["launches"] = sum(
        kern["hevc_inter_pred"]["launches_by_path"].values())

    # the AV1 kernels at the photo's shapes, and its decode part by part;
    # stage B on the intrabc screenshot (one picture: one block)
    shot = av1_screenshot_stage_b(timer, a_streams)
    kern.update(av1_kernel_rows(timer, tally, a_plan, a_launches, {
        "avif_photo": a_launches, "grain_photo": g_launches,
        "screenshot": shot_launches}, shot))
    av01_single = []
    for _ in range(AV1_REPEATS):
        t0 = time.perf_counter()
        HeifContext.read_from_bytes(av01_blobs["tile512_s0"]).decode_image(
            None, Colorspace.RGB, Chroma.InterleavedRGB)
        av01_single.append(ms_since(t0))
    log(f"av1 single item total ms {av01_single}")

    # the JPEG kernel at the photo's shapes, and its decode part by part
    kern.update(jpeg_kernel_row(timer, tally, j_frames, j_launches))
    # the encode side's kernels at the photo's shapes
    kern["jpeg_fdct_quant"] = jpeg_fdct_row(timer, tally, enc_ycc, sum(
        r["launches"]["jpeg_fdct_quant"] for r in enc["jpeg"].values()))
    kern["jpeg_fdct_quant"]["launches_by_path"] = {
        f"jpeg encode q{q} with alpha": r["launches"]["jpeg_fdct_quant"]
        for q, r in enc["jpeg"].items()}
    kern["jpeg_fdct_quant"]["launches_by_path"].update(
        write_launches(wr, "jpeg_fdct_quant"))
    kern["jpeg_fdct_quant"]["launches"] = sum(
        kern["jpeg_fdct_quant"]["launches_by_path"].values())
    kern["hevc_mode_search"] = mode_search_row(
        timer, tally, enc_luma, mode_search_launches(enc))
    log(f"file single total ms {[r['total_ms'] for r in single_runs]} "
        f"beside the library path {e2e_ms} ms")
    # launches of phase 4n's decodes through the C-named API, per kernel
    for name, by_path in api_launches(api_phase).items():
        kern[name]["api_launches"] = by_path
    # launches of phase 4o's writes and reads through the API, per kernel
    for name, by_path in api_write_launches(api_write_phase).items():
        kern[name]["api_write_launches"] = by_path

    phase_done("timing")

    # 7. SASS instructions per output pixel of the colour kernels' flagship
    # instantiations (tile: 8-byte vectors, 4:2:0; planes: 16-byte vectors,
    # bilinear 2x2), and per output byte of the strided kernel's (16-byte
    # loads and stores; a thread moves kUnits x 16 = 128 bytes per item)
    sass = sass_count.cuobjdump_sass(str(_build.LIBRARY.path))
    for name, pattern, per in (("tile_yuv_to_rgb", SASS_TILE, 32),
                               ("planes_ycbcr8_to_rgb", SASS_PLANES, 32),
                               ("strided_extract_paste", SASS_STRIDED, 128)):
        c = sass_count.count(sass, pattern, per)
        log(f"sass {name} {json.dumps(c)}")
        kern[name]["sass_per_pixel" if per == 32 else "sass_per_byte"] = \
            c["per_pixel"]
    # the JPEG kernel's thread runs its passes once: the whole function
    # over the samples one thread computes
    c = sass_count.count(sass, "jpeg_dequant_idct_kernel",
                         jpeg_fast.SAMPLES_PER_THREAD, whole=True)
    log(f"sass jpeg_dequant_idct {json.dumps(c)}")
    kern["jpeg_dequant_idct"]["sass_per_sample"] = c["per_pixel"]
    summary = {
        "card": card, "shape": f"{W}x{H} YCbCr 4:2:0, {TILES}x{TILES} tiles",
        "fused_yuv420_tiles_to_rgb_mps": px / 1e3 / fused_ms,
        "library_path_ms": e2e_ms, "library_path_mps": px / 1e3 / e2e_ms,
        "payload_to_device_ms": h2d_ms,
        "assemble_tile_buffers_ms_off_path": assemble_ms,
        "device_decode_convert_ms": device_ms,
        "planar8_tiles_to_image": planar8,
        "strided_width_ms": strided_sweep,
        "strided_layouts_4096": strided_layouts,
        "copy_ms": copy_ms, "access_width_ms": widths,
        "colour_core_mismatches": sum(core_counts.values()),
        "file_grid_alpha": {"runs": grid_runs, "device": file_device["grid"],
                            "launches": file_launches},
        "file_single": {"runs": single_runs,
                        "device": file_device["single"],
                        "library_path_ms": e2e_ms},
        "hevc_photo": {"shape": f"{PHOTO[0]}x{PHOTO[1]} from "
                       f"{PHOTO_GRID[0]}x{PHOTO_GRID[1]} hvc1 tiles of "
                       "512x512", "waves": plan.n_waves,
                       "launches": photo_launches, "runs": photo_runs,
                       "device": photo_device,
                       "stage_device_ms": hevc_stages,
                       "wave_single_tile": wave_one},
        "hevc_slices_photo": {"tiles": SLICES_TILES,
                              "waves": s_plan.n_waves,
                              "launches": s_launches, "runs": s_photo_runs},
        "hevc_single_item_total_ms": hvc1_runs,
        "av1_photo": {"shape": f"{AV1_PHOTO[0]}x{AV1_PHOTO[1]} from "
                      f"{AV1_PHOTO_GRID[0]}x{AV1_PHOTO_GRID[1]} av01 tiles "
                      "of 512x512", "launches": a_launches, "parts": a_first},
        "av1_kernel_plan": {"tiles": a_plan.t, "waves": a_plan.n_waves,
                            "groups": a_groups},
        "av1_single_item_total_ms": av01_single,
        "av1_grain_photo": {"shape": f"{GRAIN_PHOTO[0]}x{GRAIN_PHOTO[1]} "
                            f"from {GRAIN_GRID[0]}x{GRAIN_GRID[1]} film-grain "
                            "av01 tiles of 512x512", "tiles": GRAIN_TILES,
                            "launches": g_launches, "parts": g_first},
        "av1_screenshot": {"launches": shot_launches, **shot},
        "jpeg_photo": {"shape": f"{PHOTO[0]}x{PHOTO[1]} from "
                       f"{PHOTO_GRID[0]}x{PHOTO_GRID[1]} jpeg tiles of "
                       "512x512", "launches": j_launches, "parts": j_runs},
        "colour_ops": colour_rows, "metadata_file": metadata,
        "mesh": mesh, "sequences": seq, "encode": enc, "write": wr,
        "avc": avc, "avc_encode": avc_enc, "j2k": j2k, "vvc": vvc,
        "api": api_phase, "api_write": api_write_phase,
        "av1_parses": {"streams": len(AV1_PARSES),
                       "ms": sum(AV1_PARSE_MS.values())},
        "int32_ops_per_s": int32_ops_per_s, "sms": sms, "max_sm_mhz": mhz,
        "phase_s": phase_s, "elapsed_s": time.perf_counter() - t_start}
    # launches of the mesh paths (phase 4g), per kernel and path
    for name in ("strided_extract_paste", "planes_ycbcr8_to_rgb"):
        kern[name]["mesh_launches"] = {
            f"unci {what}": c[name]
            for what, c in mesh["unci"]["launches"].items()}
    for name in ("hevc_dequant_itx", "hevc_intra_wave"):
        kern[name]["mesh_launches"] = {
            f"hevc photo {what}": c[name]
            for what, c in mesh["hevc_photo"]["launches"].items()}
        kern[name]["sequence_launches"] = {
            n: seq[n]["launches"][name] for n in SEQ_STREAMS}
    # launches of the sequence encoder's closed loop (phase 4j)
    for name in ("hevc_dequant_itx", "hevc_intra_wave"):
        kern[name]["track_encode_launches"] = write_launches(wr, name)
    # launches of the decodes of the encoded files and streams (phase 4i)
    for name in ("hevc_dequant_itx", "hevc_intra_wave", "av1_dequant_itx",
                 "av1_intra_wave"):
        kern[name]["encode_round_trip_launches"] = encode_round_trips(
            enc, name)
    log("summary " + json.dumps(summary))
    print(json.dumps({"kernels": list(kern.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    ALONE = {"--mesh-only": ("mesh", mesh_alone),
             "--sequences-only": ("sequences", sequences_alone),
             "--encode-only": ("encode", encode_alone),
             "--avc-only": ("avc", avc_alone),
             "--j2k-only": ("j2k", j2k_alone),
             "--vvc-only": ("vvc", vvc_alone),
             "--api-only": ("api", api_alone),
             "--api-write-only": ("api_write", api_write_alone)}
    alone = ALONE.get(sys.argv[1]) if len(sys.argv) == 2 else None
    sys.exit(run_alone(*alone) if alone else main())
