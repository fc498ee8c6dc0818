#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root, one card

Seventeen paths, each driven with the launch counts set to 0 just before it
and read just after:

* the headline tick: 8 simulated streams of 1920×1080 YUYV through
  ``MultiStreamEngine(device_sim=True, filter="blur_sobel", overlay=True)``
  in each of its three decode modes (default, and ``RUSTCV_DECODE=pallas``
  / ``pallas_tick``): K1, K4, K5;
* BASELINE config 4, Harris corners + NMS on one 1920×1080 YUYV stream,
  through ``rustcv_tpu_torch.models.get_model("config4_harris_1080p")
  .engine()``, as its ``harris`` mask and as ``harris_points`` corner
  lists, in the default and ``pallas`` modes: the Harris kernel's int32
  form (K6), and K4 under ``pallas``;
* config 4's response surface: ``ops.features.harris_response`` (the
  float32 API behind ``cv2.cornerHarris``) on the stream's frames: the
  Harris kernel's float32 form (K6 proper);
* the Mosaic lane-shuffle probe through its entry point
  (``rustcv_tpu_torch.probes.mosaic_shuffle``): its 13 cases (K7);
* config 6, the MJPEG-out transcode: 8 × 1920×1080 YUYV → 640×480,
  blur/Sobel, overlay and a q85 4:2:0 JPEG per stream, through
  ``get_model("config6_transcode").engine().stream_encoded()``, in the
  default and ``pallas`` modes (K1; K4 and K5 do not run with a resize);
* the host-staged path: the headline's 8 × 1920×1080 YUYV streams gathered
  on the host (``SimulationDriver(n_unique_frames=8)``,
  ``device_sim=False``, bench.py's ``host_path_fps`` shape) into pinned
  staging and uploaded, in every decode mode, by blocking ticks and by
  ``run``'s prefetching loop: K1, K4, K5;
* BASELINE config 2, the hybrid MJPEG decode: 8 × 1920×1080 MJPEG →
  640×480 through ``get_model("config2_mjpeg_resize").engine()`` (host
  entropy decode into block-packed staging, the rest on the card), with
  one forced over-capacity tick on the dense program; and the same 8
  MJPEG streams at 1080p with ``blur_sobel`` and the overlay: K1;
* every other wire format at 1920×1080 with ``blur_sobel`` and the
  overlay: host-staged (2 streams) UYVY, NV12, YV12, BGRA32, RGB24, BGR24,
  GRAY8 and the four Bayer patterns; device-sim (8 streams) NV12, BGRA32,
  RGB24 and BGR24, and NV12 under ``pallas`` and ``pallas_tick`` too: K1
  once per tick, never K4 or K5;
* ``run_chained``'s CUDA graphs: configs 1 and 4 (default and ``pallas``),
  one replay of a captured chain of 32 ticks: K6 and K4, counted by the
  wrappers while the graph was captured (a replay calls no wrapper);
* ``set_resolution``: the headline's 8 streams, device-sim and
  host-staged, swapped 1080p → 720p → 1080p: K1;
* BASELINE configs 1 (1 × 640×480, overlay), 3 (32 × 3840×2160,
  blur_sobel, one batch as the zoo runs it and ``sub_batch=4``) and 5 (8 ×
  3840×2160, blur_sobel and overlay) through the zoo, configs 1 and 5 in
  every decode mode: K1, K4, K5;
* the OpenCV-style facade: ``VideoCapture`` at 1280×720 (host and device
  decode), the ``imgproc`` draws and ``harris_corners`` on a CUDA ``Mat``,
  JPEG ``imencode`` / ``imdecode``, a ``VideoWriter(encoder="tpu")`` →
  ``.avi`` → ``VideoCapture`` round trip and ``highgui``: K6 (int32 form);
* what Pillow does in the reference, after the facade, its launches counted
  apart from the kernels line: the frozen ``put_text`` masks, the README
  loop with ``put_text`` on a CUDA Mat, the headline engine with
  ``tick(text=[8 strings])`` in every decode mode (K1, K4, K5), PNG and the
  ``highgui`` dump, config 2 with ``mjpeg_backend="host"`` and
  ``VideoWriter(encoder="host")``;
* multi-device execution on a one-rank NCCL mesh over the card
  (``rustcv_tpu_torch.parallel``): the headline engine with
  ``mesh=stream_mesh("cuda")`` in the default and ``pallas`` modes (K1, K4),
  the spatial route's row bands with their halos through
  ``band_blur_sobel`` at R = 2, 4 and 8 and ``blur_sobel_mag_spatial`` on
  the one-rank rows mesh (K1 per band), ``corner_counts_psum``, and
  ``python -m rustcv_tpu_torch.parallel.launch`` in a process of its own;
* the cv2 facade, ``import rustcv_tpu_torch.cv2 as cv2``, at 1920×1080
  with numpy in and out: ``VideoWriter`` → ``VideoCapture`` of an 8-frame
  clip, per frame colour, blurs, Sobel, Canny, threshold, resize,
  ``cornerHarris`` (K6 float32) and ``goodFeaturesToTrack`` (K6 int32),
  draws and the JPEG codecs, ORB and MOG2 over the clip, ``FileStorage``;
* the rest of the cv2 facade (its later modules and submodules) on that
  clip, numpy in and out: ``GFTTDetector.detect`` per frame (K6 int32),
  ``goodFeaturesToTrackWithQuality(useHarrisDetector=True)`` (K6 int32 and
  float32), the Farnebäck and sparse LK objects, ``fisheye.undistortImage``,
  ``dnn.blobFromImage``, ``addText``, and host copies at the sizes it
  prints (DIS, ECC, the blob, MSER and line-segment detectors, QR encode
  and decode, ArUco markers, ``Subdiv2D``, the ``detail`` blenders,
  ``dnn.NMSBoxes``, ``thresholdWithMask``, ``calibrateCameraExtended`` and
  ``solvePnPGeneric``).

Phases:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions,
   the build of the CUDA kernels from ``rustcv_tpu_torch/csrc`` and of the
   port's host C++ ``rustcv_tpu_torch.native`` (g++: the JPEG coder, the
   host JPEG decode, the PNG unfilter, the glyph rasterizer, the frame ring
   and the V4L2 driver, whose branch it prints);
2. each kernel (K1 stencil, K4 decode+interleave, K5 fused tick, both
   Harris forms) against its plain PyTorch version on the card, at
   8×1920×1080 and at small ragged shapes, on aligned and misaligned
   inputs: bit-exact, the float32 Harris response bit-identical too (and
   within rtol 2e-4, atol 1e-6); each K7 case: kernel, plain version and
   the case's numpy ref, exact;
3. the paths for 20 ticks (frames) each: the headline engine in every
   decode mode identical to a plain engine's (``stencil_impl="xla"``) on
   the card; config 4's masks and corner lists identical to the plain
   functions on the same frames on the card; config 6's images and
   coefficients identical to a plain engine's on the card; the first and
   last ticks of all three identical to the plain pipeline on the CPU fed
   by the host frame generator (config 6's coefficients within the
   reference's tolerance, max |diff| <= 1 on < 0.5 %); config 6's JPEG
   payloads entropy-decode (``native.jpeg_entropy_decode``: Huffman coding
   is lossless, and the card's machine has no Pillow) to the card's
   coefficients and quant tables, and packed and dense payloads are the
   same bytes; the host path's blocking and prefetched ticks identical to
   the device-sim engine's ticks of the same sequences and to the CPU
   pipeline, with the kernels' launches per tick counted; config 2's
   streams within max |diff| <= 2 on < 1 % of bytes of the port's float64
   oracle ``decode_jpeg_numpy`` resized by the plain resize, its dense
   tick identical to the packed program's; the MJPEG ``blur_sobel``
   engine identical to a plain one; each other format's 2 ticks identical
   to a plain engine's and stream 0 to the CPU pipeline, in the reference's
   layout; a graph replay of configs 1 and 4's chains with the probe and
   clock of as many eager ticks (a 2-tick graph's with the CPU port's
   chain), the launches captured equal to the chain's length times the
   eager tick's; 2 ticks after each resolution swap identical to a fresh
   engine's at that size; configs 1, 3 and 5 identical to a plain engine
   and stream 0 to the CPU pipeline; the facade's host and device reads
   identical, its draws on a CUDA Mat identical to a host Mat's with no
   blocking copy, ``harris_corners`` identical to the CPU's, its JPEG
   coefficients, decodes and AVI frames within max |diff| <= 1 on < 0.5 %
   of the CPU port's; and every kernel launched by its path; then the
   frozen masks' hashes, the README loop with ``put_text`` on a CUDA Mat
   identical to a CPU Mat's with no blocking copy, each headline tick with
   text identical to the untexted tick plus ``golden.blend_mask``, PNG and
   the dump lossless, config 2's host backend identical to the CPU host
   decode resized, the host-encoded AVI read back as its payloads' host
   decode; the mesh engine's 3 ticks per mode identical to the meshless
   engine's (``bgr``, ``filtered``, sequences), the band route identical to
   K1 on the whole batch and to the plain chain, with exact launch counts,
   ``corner_counts_psum`` 9, and the launcher's one process, one chip and
   ``fleet_fps == local_fps``; (3n) each slice call on the 1080p CUDA Mat
   equal to the same call on a host Mat (the CPU port), byte for byte or
   within the reference's ±1 LSB (Lab, general float kernels) and 1e-3 px
   (``corner_sub_pix``), with ``median_blur`` at k = 3, 5, 7, ``resize`` in
   all four modes to 640×480 and 3840×2160, ``gaussian_blur`` at ksize 3,
   5 with σ and 9; 3 ``xla_fused`` headline ticks identical to the default
   mode's, with exactly K1 3, K4 0, K5 0; the native ring (unpaced and
   paced) for 20 reads: frames equal to ``synth_raw``, rising sequences, a
   re-queued slot's Frame raising, the card's decode equal to the host's,
   drops under a stalled consumer; V4L2's ``DeviceNotFound`` and
   ``CameraError`` and, without a node, ``default_backend() ==
   "simulation"`` (with a capture device: 5 frames of its shape with
   rising sequences); (3o) each call of the second block of ops on 1080p
   card inputs (47: arithmetic, ``normalize``, histograms, CLAHE,
   backprojection, the warps in both modes and borders, ``remap``,
   ``warp_polar`` both ways, thinning, diffusion, the multi-band blend,
   the float32 core ops) equal to the same call on the host, byte for byte,
   within ±1 LSB where the reference documents it, or within a relative
   tolerance for float results, with no result back on the host before
   the comparison but the numbers and counts the reference returns; (3p)
   each call of group 2, features and flow (35: the corner responses,
   FAST, ORB, BRIEF and its matches, LK on 1,040 points, Farnebäck, DIS
   with and without ``refine``, TV-L1, ``match_template`` on both routes in
   every method, ``phase_correlate``, the DFT and DCT both ways, ECC's
   device twin, HOG and its score map at 1080p; SIFT and AKAZE at 720p,
   ASIFT at 480p) on the card against the same call on the host, run
   meanwhile in spawned CPU processes: exact for FAST, ORB and BRIEF bits,
   matches and ``min_max_loc`` places, else within the reference's
   device-vs-oracle tolerances (LK at its stable points, DIS where its
   flow is determined), launching no kernel; (3q) group 3 and the
   segmentation head of group 4 (22 calls: MOG2 on gray and BGR, with and
   without shadows, and KNN over a 16-frame 1080p clip; MOSSE, KCF and
   CSRT alone and as a bank of 4; ``filter_scan`` of 1,024 Kalman
   trackers over 100 steps; mean shift, k-means, watershed, SLIC, the
   components with stats, contours, both distance transforms, blobs and
   the Voronoi seam) on the card against the same call on the host in
   spawned CPU processes, at the sizes it prints: masks equal on 99.99 %
   of pixels with the model within 1e-4, tracker centres and ``ok``
   equal with scores within 5e-3, Kalman within 1e-5 of the scale, mean
   shift ±1 on 99 %, k-means' palette ±1 on 99.9 % of pixels, SLIC's
   97 % boundary band, the rest exact, launching no kernel; (3r) group 4a
   (38 calls: Hough, stereo BM/SGBM, NL-means, the domain-transform and
   guided filters, Poisson cloning, inpainting, Mertens, cascades, the
   host modules) the same way; (3s) group 4b, the geometry chain (9
   calls: 8 rendered 1080p board views detected by
   ``find_chessboard_corners`` and by ``find_chessboard_corners_sb`` and
   calibrated, fx and fy within 3 % of the truth; ``undistort`` and
   ``fisheye_undistort`` of a 1080p BGR frame byte-equal; an ArUco
   ``GridBoard`` at 720p detected and posed; a circles grid at 640×480;
   ``rgbd_normals`` of a 640×480 depth map; ``triangle_rasterize`` of
   5,000 triangles at 1280×720, held on a crop; two 640×360 crops
   stitched as CUDA Mats within ±1) against the same calls in spawned CPU
   processes, launching no kernel; and once, held to their truth alone,
   the three host-only calls on that depth map: ``depth_to_3d``,
   ``find_planes`` (its three planes) and ``rgbd_odometry`` (within 2e-3
   of a known motion); (3t) the cv2 script above, its 112 results held
   against the same calls on CPU tensors in spawned CPU processes (equal;
   the float Harris response at the reference's bar, ORB angles within
   1e-3 rad, JPEG coefficients within their tolerance), gated on both K6
   forms launching; (3u) the rest of the cv2 facade, its 28 results held
   against the same calls on CPU tensors in spawned CPU processes (equal;
   Farnebäck within the flow bar, LK within 1e-3 px with equal status, the
   Harris quality at the reference's bar), the QR text, the four markers
   and the calibration's K (within 1 % of fx) against their truth, gated
   on exactly one K6 int32 launch per ``GFTTDetector.detect`` and one of
   each form per ``goodFeaturesToTrackWithQuality(useHarrisDetector=True)``;
   (3v) the formats the port reads without Pillow (ROADMAP Queue 1 item
   8a), launching no kernel: ``decode_mjpeg_host_rgb`` of three 1080p MJPEG
   frames the channel swap of the host decode; 60 files made here with
   numpy, ``zlib`` and small writers at 641x361 (PNG at every depth and
   colour type, plain and Adam7, and with an eXIf chunk; P1-P6 at maxvals
   1, 255, 1000, 65535 and PFM; BMP 1-, 4- and 16-bit, RLE8 and RLE4;
   4:4:0 and 4:1:1 JPEG; a 4:2:0 JPEG in one scan per component) and a
   677-byte progressive JPEG written by Pillow, read by ``imread`` onto the
   card equal to the CPU read, and to their numpy truth, Pillow's hash and
   the reference's metadata; ``put_text`` of a Latin-1 string at 4, 100 and
   160 px on a 1080p CUDA Mat equal to the CPU Mat, masks to the
   reference's hashes; (3w) TIFF and GIF (item 8b), every page and frame;
   (3x) WebP reads (item 8c): the fixtures of ``tests/data/webp`` read onto
   the card equal to the CPU read and to the reference's hashes in their
   manifest, with its counts, durations, loops and metadata, no kernel
   launched; (3y) WebP writes (item 8c-ii): a 1080p BGR still, a 641x361
   BGRA still and an 8-frame 640x360 animation written from CUDA Mats (the
   YUV planes made on the card) and from host Mats, the same bytes, each
   file read back by the port's reader within the bars of
   ``tests/test_torch_webp_write.py`` against the reference's file
   (``tests/data/webp/write_refs.json``: per frame PSNR at most 0.5 dB
   below, size at most 1.25x, its mode, frame count, durations and loop,
   alpha exact), no kernel launched; (3z) animated PNG (item 8d-i): the
   fixtures of ``tests/data/apng`` read and written as the manifest says,
   and Pillow's median cut; (3za) PNG writes (item 8d-ii-a): each case of
   ``png_write_frames`` (1080p stills in every mode Pillow writes, tied
   filter scores, odd widths, LA, I;16, mixed-mode and mixed-size
   animations) written from card tensors and Mats (the row filters run on
   the card) equal to the CPU's bytes and to Pillow's chunks, controls and
   image data (``tests/data/png/write_refs.json``), at most 1.02x its size,
   no kernel launched; (3zb) the JPEG forms of item 8d-ii-b: every fixture
   of ``tests/data/jpeg`` (CMYK and YCCK, progressive streams left
   unrefined and smoothed, lossless, arithmetic-coded, the forms that stay
   refused) read by ``imread`` and ``imdecode`` onto the card equal to the
   CPU read and the manifest's hash, ``decode_mjpeg_host_rgb`` and
   ``decode_mjpeg_into_mat`` answering as the manifest says,
   ``imread_with_metadata`` its dict, no kernel launched; (3zc) TIFF pages
   of JPEG compression and of the YCbCr photometric (item 8d-ii-c-i): every
   fixture of ``tests/data/tiff`` read by ``imread``, ``imdecode`` and
   ``imreadmulti`` onto the card equal to the CPU read and the manifest's
   page hashes, ``imcount`` its count, the refused forms the reference's
   error class and old-style JPEG ``not_ported``, no kernel launched;
4. ms/tick (CUDA events) and frames/s per mode for the engines, config 6's
   delivered JPEG frames/s and payload MB/tick, configs 4 and 6's device
   time per tick and idle share (profiler), the host path's frames/s (one
   discarded warm run of 6 ticks, three runs of 20, as bench.py times it),
   gather ms and idle share per mode, config 2's ms/tick, frames/s, H2D MB
   per tick and gather ms, and each kernel's time beside its plain
   version's at 8×1920×1080 (K1 at 8×640×480, the Harris forms at
   1×1920×1080 too; K7 as its 13 cases per call); each other format
   (NV12 device-sim in every mode), configs 1 and 4 eager against
   ``run_chained``, config 3 with and without ``sub_batch`` in turns (and
   its peak memory), config 5 per mode; the facade's ms per read and
   frames/s (host and device decode, 1280×720 and 3840×2160) and ms per
   draw on a CUDA Mat; ms/tick with and without text, ms per ``put_text``,
   the rasterizer's ms per string, config 2's host backend beside its
   hybrid; the headline with and without the one-rank mesh in turns, and
   the band route at R = 2, 4, 8 beside K1 on the whole batch; (4n) ms per
   call of each slice call on the 1080p CUDA Mat, slowest first, the
   ``xla_fused`` headline's ms/tick beside the default mode's in turns, and
   ms per ``Camera`` read of the native ring at 1080p (host and card
   decode); (4o) ms per call of each phase-3o call, slowest first; (4p)
   the same for each phase-3p call; (4q) ms per frame of MOG2 and KNN at
   1080p, per ``update`` of each tracker and per step of a bank of 16, per
   ``filter_scan`` step at 1,024 trackers, and per call of the
   segmentation ops at 1080p (the host ones included); (4r) ms per call
   of group 4a; (4s) ms per call of group 4b (``undistort`` of one 1080p
   frame whole and, apart, its host map build, the maps' upload and the
   remap); (4t) ms per cv2 call at 1080p, numpy in and out, and the
   host-only calls (cv2's host algorithms, draws on numpy, FileStorage)
   on a line of their own; (4u) the same for phase 3u's calls; (4v) ms per
   ``imread`` onto the card at 1080p of a 16-bit PNG, an Adam7 PNG, a 4:4:0
   JPEG, a JPEG in one scan per component and the progressive JPEG, and
   ``put_text`` and the rasterizer at 160 px; (4w) TIFF and GIF reads and
   writes at 1080p; (4x) ``imread`` onto the card of the 1080p lossy and
   lossless WebP fixtures, ``imreadmulti`` of the 8-frame 640x360
   animation, and the native decodes alone; (4y) at 1080p the RGB -> YUV
   import on the card, the download of its planes, the native VP8 encode,
   ``imwrite`` to .webp whole from a card Mat, and ``imwritemulti`` of
   phase 3y's animation; (4z) APNG reads and writes and the GIF writer at
   1080p; (4za) ``imencode(".png")`` of a 1080p card Mat whole and split
   into the row filters on the card, the download and zlib,
   ``imwrite_with_metadata``, and ``imwritemulti`` of the 8-frame 1080p
   APNG, each file's size beside Pillow's; (4zb) ms per ``imread`` onto the
   card of each JPEG form's 1080p fixture (CMYK, YCCK, smoothed
   progressive, lossless, arithmetic sequential and progressive) beside a
   baseline 4:2:0 one, each with the native decode alone; (4zc) ms per
   ``imread`` onto the card of a 1920x1080 YCbCr JPEG TIFF (4:2:0, 256x256
   tiles, the port's encoder) and a 1080p YCbCr LZW page, each beside its
   host decode alone.

Only deterministic checks decide the exit code: equality of outputs, exact
launch counts from the kernel wrappers' counters, tolerances of values.
Times, rates, memory peaks and the profiler's records are printed, with
the card's name and power limit, and never gated.

It imports no jax and nothing of the JAX package. A failing phase prints
``chip_smoke: FAIL in <phase>: <message>`` and its traceback on stdout and
stderr and exits non-zero before the last line; the last line is the JSON
verdict, and the line before it the JSON list of kernels with their
launches, errors and times.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

N, W, H = 8, 1920, 1080
RECT, COLOR, THICKNESS = (100, 100, 400, 300), (0, 255, 0), 2  # bench.py's overlay
TICKS = 20
MODES = ("default", "pallas", "pallas_tick")
C4 = "config4_harris_1080p"
# pallas_tick runs the plain decode for the Harris filters (K5 serves
# blur_sobel only), so it is the default path again.
C4_MODES = ("default", "pallas")
C4_FILTERS = ("harris", "harris_points")
HARRIS_TOL = {"rtol": 2e-4, "atol": 1e-6}  # the reference's, tests/test_pallas_harris.py
PROFILE_TICKS = 20
C6 = "config6_transcode"
C6_W, C6_H = 640, 480  # config 6's resize_to
# pallas_tick and pallas decode at the input size: with a resize and an
# encode both run the default path, so one kernel mode is driven.
C6_MODES = ("default", "pallas")
ENC_KEYS = ("enc_y", "enc_cb", "enc_cr")
C2 = "config2_mjpeg_resize"
UNIQUE = 8  # bench.py's n_unique_frames: the sources cycle 8 frames
HOST_TICKS = 12  # ticks of the host path's prefetching run, per mode
# Launches per tick of the host path's kernels, per mode.
HOST_LAUNCHES = {"default": {"blur_sobel_mag": 1},
                 "pallas": {"blur_sobel_mag": 1, "yuyv_decode_interleave": 1},
                 "pallas_tick": {"yuyv_tick_fused": 1}}
ORACLE_TOL = (2, 1e-2)  # config 2 vs the float64 oracle: max |diff|, share of bytes
# Wire formats other than YUYV: every one the simulation encodes is staged
# from the host; the device synthesizes four of them.
HOST_FORMATS = ("UYVY", "NV12", "YV12", "BGRA32", "RGB24", "BGR24", "GRAY8",
                "BAYER_BGGR", "BAYER_GBRG", "BAYER_GRBG", "BAYER_RGGB")
SIM_FORMATS = ("NV12", "BGRA32", "RGB24", "BGR24")
CHAIN = 32  # ticks per dispatch of run_chained, as bench_models.py calls it
C1, C3, C5 = "config1_convert_overlay", "config3_blur_sobel_4k", "config5_end_to_end_4k"
CHAIN_CASES = ((C1, "default"), (C4, "default"), (C4, "pallas"))
# (model, its variants: (label, mode, engine overrides), ticks checked)
ZOO_CASES = (
    (C1, tuple((m, m, {}) for m in MODES), 4),
    (C3, (("zoo: one batch", "default", {}), ("sub_batch=4", "default", {"sub_batch": 4})), 2),
    (C5, tuple((m, m, {}) for m in MODES), 3),
)
# Launches per tick (per sub-batch) of a blur_sobel spec, per mode.
ZOO_LAUNCHES = {"default": {"blur_sobel_mag": 1},
                "pallas": {"blur_sobel_mag": 1, "yuyv_decode_interleave": 1},
                "pallas_tick": {"yuyv_tick_fused": 1}}

KERNELS = {  # name → (source, the Pallas kernel it replaces: file:line of pallas_call)
    "blur_sobel_mag": ("rustcv_tpu_torch/csrc/stencil.cu",
                       "rustcv_tpu/ops/pallas/stencil_v3.py:87"),
    "yuyv_decode_interleave": ("rustcv_tpu_torch/csrc/yuyv_tick.cu",
                               "rustcv_tpu/ops/pallas/decode_interleave.py:217"),
    "yuyv_tick_fused": ("rustcv_tpu_torch/csrc/yuyv_tick.cu",
                        "rustcv_tpu/ops/pallas/tick_fused.py:250"),
    "harris_response_f32": ("rustcv_tpu_torch/csrc/harris.cu",
                            "rustcv_tpu/ops/pallas/harris.py:138"),
    "harris_response_i32": ("rustcv_tpu_torch/csrc/harris.cu",
                            "rustcv_tpu/ops/pallas/harris.py:138"),
    "mosaic_shuffle": ("rustcv_tpu_torch/csrc/mosaic_shuffle.cu", "probe_mosaic_shuffle.py:166"),
}
HEADLINE_KERNELS = ("blur_sobel_mag", "yuyv_decode_interleave", "yuyv_tick_fused")


class SmokeFailure(Exception):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def set_mode(mode: str) -> None:
    if mode == "default":
        os.environ.pop("RUSTCV_DECODE", None)
    else:
        os.environ["RUSTCV_DECODE"] = mode


def max_abs_err(a, b) -> int:
    expect(a.shape == b.shape and a.dtype == b.dtype, f"shape/dtype {a.shape} {b.shape}")
    return int((a.int() - b.int()).abs().max().item())


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls (CUDA events),
    after one untimed call unless ``warm`` is False."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def overlay_args(w, h, n, dev, rng):
    """Per-stream rects: inside and across strips of rows, over the frame
    edges, thinner than the thickness; random colours."""
    import torch

    pool = [list(RECT), [-9, -5, w // 2 + 20, h // 3], [w - 50, h - 30, 200, 200],
            [w // 3, h // 3, 63, 33], [5, 5, 1, 1], [1, 30, w - 2, 45]]
    rects = torch.tensor([pool[i % len(pool)] for i in range(n)], dtype=torch.int32, device=dev)
    colors = torch.from_numpy(rng.integers(0, 256, (n, 3), np.uint8)).to(dev)
    return rects, colors


def harris_f32_errs(got, want) -> tuple:
    """Max abs and max rel difference of two float32 responses."""
    diff = (got - want).abs()
    return float(diff.max()), float((diff / want.abs().clamp_min(1e-30)).max())


# (W, H, N) of phase 2: the main path's shape, then ragged and tiny ones:
# W % 8 in every residue, W % 4 != 0 (the kernels' byte forms), images
# smaller than the ±3 halo.
CHECK_SHAPES = ((W, H, N), (C6_W, C6_H, N), (130, 50, 3), (64, 48, 2), (2, 1, 1), (131, 37, 3),
                (134, 9, 2), (6, 3, 1), (1, 2, 1), (129, 70, 1), (132, 33, 2), (133, 8, 1),
                (135, 40, 1), (136, 41, 2))


def misaligned(t, offset: int = 1):
    """A contiguous copy of ``t`` that starts ``offset`` bytes past an
    allocation's start (as ``buf[1:]``)."""
    import torch

    buf = torch.empty(t.numel() + offset, dtype=torch.uint8, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def check_kernels(dev) -> dict:
    """Phase 2: every kernel vs its plain version on the card, at the main
    path's shapes, ragged and tiny shapes and misaligned views (K1, K4, K5
    on words 1 and 2 bytes past an allocation's start, both Harris forms on
    a misaligned plane); K5 and K4 also with a rectangle thicker than a
    strip of rows."""
    import torch

    from rustcv_tpu_torch.ops.kernels import decode_interleave, harris, stencil, tick_fused

    errs = {name: 0 for name in KERNELS}
    for (w, h, n) in CHECK_SHAPES:
        rng = np.random.default_rng(w * 7919 + h)
        gray = torch.from_numpy(rng.integers(0, 256, (n, h, w), np.uint8)).to(dev)
        e = {"blur_sobel_mag": max(max_abs_err(stencil.blur_sobel_mag(g), stencil.blur_sobel_mag_plain(g))
                                   for g in (gray, misaligned(gray)))}
        if w % 2 == 0:
            src = torch.from_numpy(rng.integers(0, 256, (n, h * w * 2), np.uint8)).to(dev)
            rects, colors = overlay_args(w, h, n, dev, rng)
            for overlay, thickness in ((True, THICKNESS), (False, THICKNESS), (True, 40)):
                args = (src, w, h, rects, colors, thickness, overlay)
                for name, kern, plain in (
                        ("yuyv_decode_interleave", decode_interleave.yuyv_decode_interleave,
                         decode_interleave.yuyv_decode_interleave_plain),
                        ("yuyv_tick_fused", tick_fused.yuyv_tick_fused,
                         tick_fused.yuyv_tick_fused_plain)):
                    want = plain(*args)
                    for s in (src, misaligned(src), misaligned(src, 2)):
                        e[name] = max(e.get(name, 0), *map(max_abs_err, kern(s, *args[1:]), want))
        e["harris_response_i32"] = max(
            max_abs_err(harris.harris_response_i32(g, k_num),
                        harris.harris_response_i32_plain(gray, k_num))
            for k_num in (41, 61) for g in (gray, misaligned(gray)))
        want = harris.harris_response_plain(gray)
        rel, same = 0.0, True
        for g in (gray, misaligned(gray)):
            got = harris.harris_response(g)
            err, r = harris_f32_errs(got, want)
            e["harris_response_f32"] = max(e.get("harris_response_f32", 0.0), err)
            rel, same = max(rel, r), same and torch.equal(got, want)
            expect(torch.allclose(got, want, **HARRIS_TOL),
                   f"float32 Harris at N={n} {w}x{h} outside rtol 2e-4, atol 1e-6")
        torch.cuda.synchronize()
        print(f"kernels vs plain at N={n} {w}x{h} (aligned and misaligned): max|diff| {e}; "
              f"float32 Harris max rel diff {rel:.3e}, bit-identical {same}", flush=True)
        expect(same, f"float32 Harris at N={n} {w}x{h} is not bit-identical to its plain version")
        for name, v in e.items():
            errs[name] = max(errs[name], v)
    exact = {k: v for k, v in errs.items() if k != "harris_response_f32"}
    expect(all(v == 0 for v in exact.values()), f"kernel disagrees with its plain version: {errs}")
    return errs


def make_engine(mode: str, stencil_impl=None, mesh=None):
    from rustcv_tpu_torch.capture import SimulationDriver
    from rustcv_tpu_torch.core import PixelFormat, SimpleConfig
    from rustcv_tpu_torch.runtime import MultiStreamEngine

    set_mode(mode)
    return MultiStreamEngine(
        SimulationDriver(device_count=N, paced=False), N,
        SimpleConfig(width=W, height=H, fps=60, pixel_format=PixelFormat.YUYV),
        filter="blur_sobel", overlay=True, device_sim=True, stencil_impl=stencil_impl, mesh=mesh,
    )


def bench_overlay():
    rects = np.tile(np.array([RECT], np.int32), (N, 1))
    colors = np.tile(np.array([COLOR], np.uint8), (N, 1))
    return rects, colors


def host_reference(seq: int, filt: str = "blur_sobel", overlay: bool = True):
    """The plain pipeline on the CPU, fed the host generator's frame."""
    import torch

    from rustcv_tpu_torch.capture.simulation import synth_raw
    from rustcv_tpu_torch.core import PixelFormat
    from rustcv_tpu_torch.runtime.pipeline import PipelineSpec, get_pipeline

    set_mode("default")
    fn = get_pipeline(PipelineSpec(PixelFormat.YUYV, W, H, filter=filt, overlay=overlay))
    raw = torch.from_numpy(synth_raw(W, H, PixelFormat.YUYV, seq))[None]
    rects, colors = bench_overlay()
    return fn(raw, torch.from_numpy(rects[:1]), torch.from_numpy(colors[:1]), THICKNESS)


def run_main_path() -> dict:
    """Phase 3: the engine in every decode mode vs the plain engine."""
    import torch

    from rustcv_tpu_torch.ops import kernels

    rects, colors = bench_overlay()
    plain = make_engine("default", stencil_impl="xla")
    kernels.reset_launch_counts()
    ref = [plain.tick(rects=rects, rect_colors=colors) for _ in range(TICKS)]
    torch.cuda.synchronize()
    expect(sum(kernels.launch_counts().values()) == 0, "the plain engine launched a kernel")
    plain.close()

    out0 = ref[0].outputs
    expect(tuple(out0["bgr"].shape) == (N, H, 3 * W) and out0["bgr"].dtype == torch.uint8,
           f"bgr {tuple(out0['bgr'].shape)} {out0['bgr'].dtype}")
    expect(tuple(out0["filtered"].shape) == (N, H, W), f"filtered {tuple(out0['filtered'].shape)}")
    expect(out0["bgr"][0, RECT[1], 3 * RECT[0]:3 * RECT[0] + 3].tolist() == list(COLOR),
           "the rectangle's corner does not carry its colour")
    expect(int(out0["filtered"].max()) > 0, "the filter output is all zero")
    for t, s in ((0, 0), (TICKS - 1, N - 1)):
        host = host_reference(int(ref[t].sequences[s]))
        for key in ("bgr", "filtered"):
            expect(torch.equal(ref[t].outputs[key][s:s + 1].cpu(), host[key]),
                   f"tick {t} stream {s} {key} differs from the host generator + CPU pipeline")
    print(f"plain engine on the card == host generator + CPU pipeline (ticks 0 and {TICKS - 1})",
          flush=True)

    kernels.reset_launch_counts()  # the main path's run starts here
    per_mode = {}
    for mode in MODES:
        before = kernels.launch_counts()
        eng = make_engine(mode)
        expect(eng.spec.stencil_impl == "pallas", f"default stencil on the card is {eng.spec.stencil_impl}")
        for t in range(TICKS):
            res = eng.tick(rects=rects, rect_colors=colors)
            for key in ("bgr", "filtered"):
                expect(torch.equal(res.outputs[key], ref[t].outputs[key]),
                       f"mode {mode} tick {t}: {key} differs from the plain engine")
        torch.cuda.synchronize()
        eng.close()
        after = kernels.launch_counts()
        per_mode[mode] = {k: after[k] - before[k] for k in after}
        print(f"engine mode {mode}: {TICKS} ticks identical to the plain engine; "
              f"launches {per_mode[mode]}", flush=True)
    totals = kernels.launch_counts()  # read just after the main path's run
    expect(per_mode["default"]["blur_sobel_mag"] > 0, "default mode never ran the stencil kernel")
    expect(per_mode["pallas"]["blur_sobel_mag"] > 0, "pallas mode never ran the stencil kernel")
    expect(per_mode["pallas"]["yuyv_decode_interleave"] > 0, "pallas mode never ran K4")
    expect(per_mode["pallas_tick"]["yuyv_tick_fused"] > 0, "pallas_tick mode never ran K5")
    expect(all(totals[k] > 0 for k in HEADLINE_KERNELS),
           f"a kernel of the path never launched: {totals}")
    return totals


def make_c4(mode: str, filt: str = "harris"):
    """Config 4's engine through the zoo, as a user builds it."""
    from rustcv_tpu_torch.models import get_model

    set_mode(mode)
    return get_model(C4).engine(filter=filt)


def plain_c4(raw, filt: str) -> dict:
    """Config 4's outputs by the plain functions (no kernel) on raw's device."""
    from rustcv_tpu_torch.ops import color, features
    from rustcv_tpu_torch.ops.kernels import harris
    from rustcv_tpu_torch.runtime.pipeline import HARRIS_POINTS

    resp = harris.harris_response_i32_plain(color.yuyv_to_gray(raw, W, H))
    mask = features._corner_mask(resp, 0.01, 1)
    if filt == "harris":
        return {"filtered": mask}
    corners, valid = features._top_corners(resp, mask, HARRIS_POINTS)
    return {"corners": corners, "corners_valid": valid}


def run_config4() -> dict:
    """Phase 3b: config 4 through the zoo in each of its modes, its mask and
    its corner lists; returns the path's launches."""
    import torch

    from rustcv_tpu_torch.core import PixelFormat
    from rustcv_tpu_torch.ops import kernels, synth

    host = {}
    kernels.reset_launch_counts()  # config 4's path starts here
    for filt in C4_FILTERS:
        for mode in C4_MODES:
            before = kernels.launch_counts()
            eng = make_c4(mode, filt)
            expect(eng.n == 1 and (eng.spec.width, eng.spec.height) == (W, H), "config 4's shape")
            found = 0
            for t in range(TICKS):
                res = eng.tick()
                seqs = torch.from_numpy(res.sequences.astype(np.int32)).to(res.outputs["bgr"].device)
                want = plain_c4(synth.synth_raw(seqs, W, H, PixelFormat.YUYV), filt)
                for key, v in want.items():
                    expect(torch.equal(res.outputs[key], v),
                           f"config 4 {filt} mode {mode} tick {t}: {key} differs from the plain "
                           "functions on the same frame")
                found += int(want["filtered" if filt == "harris" else "corners_valid"].sum())
                if t in (0, TICKS - 1):
                    seq = int(res.sequences[0])
                    if (filt, seq) not in host:
                        host[filt, seq] = host_reference(seq, filt, overlay=False)
                    for key in ("bgr", *want):
                        expect(torch.equal(res.outputs[key].cpu(), host[filt, seq][key]),
                               f"config 4 {filt} mode {mode} tick {t}: {key} differs from the "
                               "host generator + CPU pipeline")
            torch.cuda.synchronize()
            eng.close()
            expect(found > 0, f"config 4 {filt} mode {mode} found no corner in {TICKS} frames")
            after = kernels.launch_counts()
            per = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            expect(per.get("harris_response_i32", 0) > 0, f"{filt} mode {mode} never ran Harris")
            if mode == "pallas":
                expect(per.get("yuyv_decode_interleave", 0) > 0, f"{filt} mode pallas never ran K4")
            print(f"config 4 {filt} mode {mode}: {TICKS} ticks identical to the plain functions "
                  f"(ticks 0 and {TICKS - 1} to the CPU pipeline); {found} corners; "
                  f"launches {per}", flush=True)
    return kernels.launch_counts()  # read just after config 4's run


def run_response_surface(dev) -> dict:
    """Phase 3c: the float32 response of config 4's frames, one frame per
    call, each within tolerance of the plain version; returns the path's
    launches."""
    import torch

    from rustcv_tpu_torch.core import PixelFormat
    from rustcv_tpu_torch.ops import color, features, kernels, synth
    from rustcv_tpu_torch.ops.kernels import harris

    frames = color.yuyv_to_gray(
        synth.synth_raw(torch.arange(TICKS, dtype=torch.int32, device=dev), W, H,
                        PixelFormat.YUYV), W, H)
    kernels.reset_launch_counts()  # the response-surface path starts here
    got = [features.harris_response(frames[i]) for i in range(TICKS)]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()  # read just after
    worst = (0.0, 0.0)
    for i, r in enumerate(got):
        want = harris.harris_response_plain(frames[i])
        expect(r.shape == (H, W) and r.dtype == torch.float32 and bool(r.isfinite().all()),
               f"response {i}: {tuple(r.shape)} {r.dtype}")
        expect(torch.allclose(r, want, **HARRIS_TOL), f"response {i} outside rtol 2e-4, atol 1e-6")
        worst = max(worst, harris_f32_errs(r, want))
    expect(counts["harris_response_f32"] == TICKS, f"response surface launches {counts}")
    print(f"response surface: {TICKS} frames within tolerance of the plain version "
          f"(max abs {worst[0]:.3e}, rel {worst[1]:.3e}); launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return counts


def build_native() -> None:
    """Phase 1b: build (g++) or load the port's host C++ library (config 6
    cannot finish its payloads without it, the native ring needs it), and
    print which V4L2 branch it holds."""
    t0 = time.perf_counter()
    from rustcv_tpu_torch import native

    ok = native.available()
    print(f"native library {'built or loaded' if ok else 'UNAVAILABLE'} in "
          f"{time.perf_counter() - t0:.2f} s (g++ {native.build_info.get('seconds', 0.0):.2f} s): "
          f"{native.build_info.get('path')}", flush=True)
    expect(ok, f"rustcv_tpu_torch.native is unavailable: {native.build_error()}")
    print("native library's V4L2 branch: " + (
        "the driver (linux/videodev2.h found)" if native.v4l2_available()
        else "the stub (rcv_v4l2_available() == 0)"), flush=True)


def run_mosaic_probe(dev) -> tuple:
    """Phase 2b and K7's path: the probe's entry point runs every case on
    the card (kernel vs plain version vs ref, exact); returns the path's
    launches and the kernels' max |diff| from their plain versions."""
    import torch

    from rustcv_tpu_torch.ops import kernels
    from rustcv_tpu_torch.probes import mosaic_shuffle as probe

    kernels.reset_launch_counts()  # K7's path starts here
    rc = probe.main([])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()  # read just after
    expect(rc == 0, "a Mosaic probe case mismatched")
    expect(counts["mosaic_shuffle"] == len(probe.PROBES), f"K7 launches {counts}")
    err = 0
    for name in probe.PROBES:
        r = probe.run_case(name, dev)
        err = max(err, int(np.abs(r["kernel"].astype(np.int64) - r["plain"].astype(np.int64)).max()))
    print(f"Mosaic probe: {len(probe.PROBES)} cases exact (kernel, plain, ref); max|diff| "
          f"kernel vs plain {err}; launches {counts['mosaic_shuffle']}", flush=True)
    return {k: v for k, v in counts.items() if k == "mosaic_shuffle"}, err


def make_c6(mode: str, **overrides):
    """Config 6's engine through the zoo, as a user builds it."""
    from rustcv_tpu_torch.models import get_model

    set_mode(mode)
    return get_model(C6).engine(**overrides)


def c6_host_reference(spec, seq: int):
    """Config 6's plain pipeline on the CPU, fed the host generator's frame."""
    import torch

    from rustcv_tpu_torch.capture.simulation import synth_raw
    from rustcv_tpu_torch.core import PixelFormat
    from rustcv_tpu_torch.runtime.pipeline import get_pipeline

    set_mode("default")
    fn = get_pipeline(dataclasses.replace(spec, stencil_impl="xla"))
    raw = torch.from_numpy(synth_raw(spec.width, spec.height, PixelFormat.YUYV, seq))[None]
    rects, colors = bench_overlay()
    return fn(raw, torch.from_numpy(rects[:1]), torch.from_numpy(colors[:1]), THICKNESS)


def coeff_diff(got, want) -> tuple:
    """Max |diff| and the share of coefficients that differ."""
    d = (got.to("cpu").int() - want.to("cpu").int()).abs()
    return int(d.max()), float((d > 0).float().mean())


def check_payloads(eng, res, payloads) -> None:
    """Every stream's JFIF decodes to the tick's coefficients and the q85
    tables, and the dense coder makes the same bytes as the packed one."""
    from rustcv_tpu_torch import native
    from rustcv_tpu_torch.ops.jpeg_encode import quant_tables

    expect(len(payloads) == N, f"{len(payloads)} payloads for {N} streams")
    coeffs = [res.outputs[k].cpu().numpy() for k in ENC_KEYS]
    qts = quant_tables(85)
    for i, p in enumerate(payloads):
        info, dec, qt = native.jpeg_entropy_decode(p)
        expect((info["width"], info["height"], info["ncomp"]) == (C6_W, C6_H, 3), f"JFIF {info}")
        for c in range(3):
            expect(np.array_equal(dec[c].reshape(-1, 64), coeffs[c][i]),
                   f"stream {i} component {c}: the payload does not decode to the coefficients")
            expect(np.array_equal(qt[c].reshape(-1), qts[min(c, 1)]), "quant tables differ")
    expect(eng._encode_from_host(*coeffs) == payloads, "packed and dense payloads differ")


def run_config6() -> dict:
    """Phase 3d: config 6 through the zoo, its delivery path
    (``stream_encoded``) in each mode; returns the path's launches."""
    import torch

    from rustcv_tpu_torch.ops import kernels

    rects, colors = bench_overlay()
    plain = make_c6("default", stencil_impl="xla")
    kernels.reset_launch_counts()
    ref = []
    for _ in range(TICKS):
        out = plain.tick(rects=rects, rect_colors=colors, thickness=THICKNESS).outputs
        ref.append({k: v for k, v in out.items() if not k.startswith("_")})
    torch.cuda.synchronize()
    expect(sum(kernels.launch_counts().values()) == 0, "config 6's plain engine launched a kernel")
    spec = plain.spec
    plain.close()
    # 4:2:0 at 640×480: 4,800 + 1,200 + 1,200 blocks, 450 dense rows, and a
    # blob of 275,404 B per stream (idx, val, ids, rows, count).
    nbt = (C6_W // 8) * (C6_H // 8) * 3 // 2
    cap = min(nbt, max(128, nbt // 16))
    expect((spec.resize_to, spec.encode_jpeg, spec.encode_packed, spec.encode_dense_cap)
           == ((C6_W, C6_H), 85, 10, cap), f"config 6's spec {spec}")
    shapes = {k: tuple(v.shape) for k, v in ref[0].items()}
    expect(shapes["bgr"] == (N, C6_H, 3 * C6_W) and shapes["filtered"] == (N, C6_H, C6_W)
           and shapes["enc_y"] == (N, nbt * 2 // 3, 64)
           and shapes["enc_blob"] == (N, nbt * 30 + cap * 132 + 4),
           f"config 6 output shapes {shapes}")
    host = {t: (s, c6_host_reference(spec, t)) for t, s in ((0, 0), (TICKS - 1, N - 1))}

    kernels.reset_launch_counts()  # config 6's path starts here
    for mode in C6_MODES:
        before = kernels.launch_counts()
        eng = make_c6(mode)
        expect(eng.spec == dataclasses.replace(spec, stencil_impl="pallas"),
               f"config 6's engine in mode {mode}: {eng.spec}")
        worst = (0, 0.0)
        busy = []  # blocks with more than K nonzeros, per stream and tick
        for t, (res, payloads) in enumerate(eng.stream_encoded(
                max_ticks=TICKS, rects=rects, rect_colors=colors, thickness=THICKNESS)):
            expect(res.tick_index == t and int(res.sequences[0]) == t, f"tick {res.tick_index}")
            busy += res.outputs["enc_ndense"].tolist()
            for key, want in ref[t].items():
                if not torch.equal(res.outputs[key], want):
                    if key in ENC_KEYS:
                        print(f"config 6 mode {mode} tick {t} {key}: max|diff| and share "
                              f"{coeff_diff(res.outputs[key], want)}", flush=True)
                    raise SmokeFailure(f"config 6 mode {mode} tick {t}: {key} differs from the "
                                       "plain engine")
            if t in host:
                s, cpu = host[t]
                for key in ("bgr", "filtered"):
                    expect(torch.equal(res.outputs[key][s:s + 1].cpu(), cpu[key]),
                           f"config 6 mode {mode} tick {t} stream {s}: {key} differs from the "
                           "host generator + CPU pipeline")
                for key in ENC_KEYS:
                    d = coeff_diff(res.outputs[key][s:s + 1], cpu[key])
                    worst = max(worst, d)
                    expect(d[0] <= 1 and d[1] < 5e-3, f"config 6 mode {mode} tick {t} {key}: "
                           f"max|diff| {d[0]}, share {d[1]:.2e} from the CPU pipeline")
                check_payloads(eng, res, payloads)
        torch.cuda.synchronize()
        eng.close()
        after = kernels.launch_counts()
        per = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        expect(per.get("blur_sobel_mag", 0) > 0, f"config 6 mode {mode} never ran K1")
        expect(not per.get("yuyv_decode_interleave") and not per.get("yuyv_tick_fused"),
               f"config 6 mode {mode} ran a fused decode: {per}")
        print(f"config 6 mode {mode}: {TICKS} ticks identical to the plain engine (ticks 0 and "
              f"{TICKS - 1}: images identical to the CPU pipeline, coefficients max|diff| "
              f"{worst[0]}, share {worst[1]:.2e}; payloads decode to the coefficients, packed == "
              f"dense); over-capacity ticks {eng.encode_dense_fallbacks} (busy blocks per stream "
              f"{min(busy)}-{max(busy)}, dense rows {spec.encode_dense_cap}); launches {per}",
              flush=True)
    return kernels.launch_counts()  # read just after config 6's run


def make_host_engine(mode: str, stencil_impl=None, device_sim: bool = False):
    """The headline's streams on the host-staged path (bench.py's
    ``host_path_fps`` engine), or on the device-sim path with the same
    8-frame cycle."""
    from rustcv_tpu_torch.capture import SimulationDriver
    from rustcv_tpu_torch.core import PixelFormat, SimpleConfig
    from rustcv_tpu_torch.runtime import MultiStreamEngine

    set_mode(mode)
    return MultiStreamEngine(
        SimulationDriver(device_count=N, paced=False, n_unique_frames=UNIQUE), N,
        SimpleConfig(width=W, height=H, fps=60, pixel_format=PixelFormat.YUYV),
        filter="blur_sobel", overlay=True, device_sim=device_sim, stencil_impl=stencil_impl,
    )


def recording(eng) -> list:
    """Keep every TickResult that ``eng`` makes, ``run``'s included."""
    seen = []
    tick = eng.tick

    def recorded(*args, **kwargs):
        res = tick(*args, **kwargs)
        seen.append(res)
        return res

    eng.tick = recorded
    return seen


def run_host_path() -> dict:
    """Phase 3e: the host-staged path in every decode mode, blocking ticks
    and a prefetching ``run``, each tick identical to the device-sim
    engine's tick of the same sequences; returns the path's launches."""
    import torch

    from rustcv_tpu_torch.ops import kernels

    rects, colors = bench_overlay()
    sim = make_host_engine("default", stencil_impl="xla", device_sim=True)
    ref = [sim.tick(rects=rects, rect_colors=colors).outputs for _ in range(UNIQUE)]
    torch.cuda.synchronize()
    sim.close()
    host = {seq: host_reference(seq) for seq in (0, UNIQUE - 1)}

    def check(res, what):
        seqs = res.sequences.tolist()
        expect(len(set(seqs)) == 1 and seqs[0] >= 0, f"{what}: sequences {seqs}")
        for key in ("bgr", "filtered"):
            expect(torch.equal(res.outputs[key], ref[seqs[0] % UNIQUE][key]),
                   f"{what} (seq {seqs[0]}): {key} differs from the device-sim engine")
        if seqs[0] in host:
            for s in (0, N - 1):
                for key in ("bgr", "filtered"):
                    expect(torch.equal(res.outputs[key][s:s + 1].cpu(), host[seqs[0]][key]),
                           f"{what} stream {s}: {key} differs from the host generator + "
                           "CPU pipeline")

    kernels.reset_launch_counts()  # the host path's run starts here
    for mode in MODES:
        before = kernels.launch_counts()
        eng = make_host_engine(mode)
        pinned = all(t.is_pinned() for slot in eng._staging for t, _ in slot)
        expect(pinned and eng._gather_pool is not None, f"host path {mode}: staging not pinned")
        blocking = [eng.tick(rects=rects, rect_colors=colors, block=True) for _ in range(UNIQUE)]
        seen = recording(eng)
        stats = eng.run(HOST_TICKS, warmup=0, measure_latency=False, rects=rects,
                        rect_colors=colors)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        per = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        ticks = UNIQUE + HOST_TICKS
        expect(len(seen) == HOST_TICKS and stats.dropped_frames == 0,
               f"host path {mode}: {len(seen)} ticks recorded, {stats.dropped_frames} dropped")
        expect(per == {k: v * ticks for k, v in HOST_LAUNCHES[mode].items()},
               f"host path {mode}: launches {per} in {ticks} ticks")
        for t, res in enumerate(blocking):
            check(res, f"host path {mode} blocking tick {t}")
        for t, res in enumerate(seen):
            check(res, f"host path {mode} prefetched tick {t}")
        print(f"host path mode {mode}: {UNIQUE} blocking and {HOST_TICKS} prefetched ticks "
              f"identical to the device-sim engine (seqs 0 and {UNIQUE - 1}: to the CPU "
              f"pipeline); gathers that waited for their buffer's upload {eng.staging_waits}; "
              f"launches {per} in {ticks} ticks", flush=True)
        eng.close()
    return kernels.launch_counts()  # read just after the host path's run


def make_c2(**overrides):
    """Config 2's engine through the zoo, its sources cycling 8 frames."""
    from rustcv_tpu_torch.capture import SimulationDriver
    from rustcv_tpu_torch.models import get_model

    set_mode("default")
    driver = SimulationDriver(device_count=N, paced=False, n_unique_frames=UNIQUE)
    return get_model(C2).engine(driver=driver, **overrides)


def h2d_mb(eng) -> float:
    """MB one packed tick uploads: a staging slot."""
    return sum(t.numel() * t.element_size() for t, _ in eng._staging[0]) / 1e6


def run_config2() -> dict:
    """Phase 3f: config 2 through the zoo, every stream within the oracle's
    tolerance; a forced over-capacity tick identical to the packed
    program's; then MJPEG with blur_sobel and the overlay at 1080p against
    a plain engine. Returns the paths' launches."""
    import torch

    from rustcv_tpu_torch.capture.simulation import synth_raw
    from rustcv_tpu_torch.core import PixelFormat
    from rustcv_tpu_torch.ops import kernels, resize
    from rustcv_tpu_torch.ops.jpeg_tpu import decode_jpeg_numpy

    kernels.reset_launch_counts()  # config 2's path starts here
    eng = make_c2()
    expect(eng._mjpeg_hybrid and not eng._device_sim, "config 2 is not on the hybrid path")
    outs = [eng.tick(block=True) for _ in range(TICKS)]
    spec = eng.spec
    expect(spec.mjpeg_packed and spec.resize_to == (C6_W, C6_H), f"config 2's spec {spec}")
    worst = (0, 0.0)
    for t in (0, 1):
        seq = int(outs[t].sequences[0])
        want = resize.resize_bilinear(torch.from_numpy(decode_jpeg_numpy(
            synth_raw(W, H, PixelFormat.MJPEG, seq))), C6_W, C6_H).numpy().astype(np.int64)
        got = outs[t].numpy("bgr")
        expect(got.shape == (N, C6_H, C6_W, 3), f"config 2 bgr {got.shape}")
        for i in range(N):
            d = np.abs(got[i].astype(np.int64) - want)
            worst = max(worst, (int(d.max()), float((d > 0).mean())))
    expect(worst[0] <= ORACLE_TOL[0] and worst[1] < ORACLE_TOL[1],
           f"config 2 vs the oracle: max|diff| {worst[0]}, share {worst[1]:.2e}")
    expect(all(outs[t].sequences.tolist() == [t] * N for t in range(TICKS)), "config 2 sequences")
    dense = make_c2()
    dense.tick(block=True)
    dense._dense_cap = 0  # every busy block over capacity: the dense program
    forced = dense.tick(block=True)
    expect(forced.sequences.tolist() == [1] * N and torch.equal(forced.outputs["bgr"],
                                                                 outs[1].outputs["bgr"]),
           "config 2's dense tick differs from the packed program's")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()  # read just after config 2's run
    print(f"config 2: {TICKS} ticks, every stream of ticks 0 and 1 within max|diff| "
          f"{worst[0]}, share {worst[1]:.2e} of the oracle resized; packed K = "
          f"{eng._packed_k}, {eng._dense_cap} dense rows, {h2d_mb(eng):.3f} MB per tick; the "
          f"forced dense tick identical to the packed program's; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    eng.close()
    dense.close()

    rects, colors = bench_overlay()
    kw = dict(resize_to=None, filter="blur_sobel", overlay=True)
    plain = make_c2(stencil_impl="xla", **kw)
    ref = [plain.tick(rects=rects, rect_colors=colors).outputs for _ in range(4)]
    plain.close()
    kernels.reset_launch_counts()  # the MJPEG blur_sobel path starts here
    eng = make_c2(**kw)
    got = [eng.tick(rects=rects, rect_colors=colors).outputs for _ in range(4)]
    torch.cuda.synchronize()
    mjpeg_counts = kernels.launch_counts()  # read just after
    eng.close()
    for t in range(4):
        for key in ("bgr", "filtered"):
            expect(torch.equal(got[t][key], ref[t][key]),
                   f"MJPEG blur_sobel tick {t}: {key} differs from the plain engine")
    expect(mjpeg_counts["blur_sobel_mag"] == 4, f"MJPEG blur_sobel launches {mjpeg_counts}")
    print(f"MJPEG 8 x 1080p blur_sobel + overlay: 4 ticks identical to the plain engine; "
          f"launches { {k: v for k, v in mjpeg_counts.items() if v} }", flush=True)
    return {k: counts[k] + mjpeg_counts[k] for k in counts}


def format_engine(fmt, device_sim: bool, n: int, mode: str = "default", stencil_impl=None,
                  w: int = W, h: int = H):
    """``n`` streams of ``fmt`` at w×h, blur_sobel and the overlay, frames
    made on the device or gathered on the host (each source cycling its own
    2 frames)."""
    from rustcv_tpu_torch.capture import ModeDescriptor, SimulationDriver
    from rustcv_tpu_torch.core import SimpleConfig
    from rustcv_tpu_torch.runtime import MultiStreamEngine

    set_mode(mode)
    sizes = {(w, h), (W, H), (1280, 720)}  # the sizes set_resolution may swap to
    driver = SimulationDriver(device_count=n, paced=False, n_unique_frames=0 if device_sim else 2,
                              modes=[ModeDescriptor(fmt, mw, mh, (60,)) for mw, mh in sizes])
    return MultiStreamEngine(driver, n, SimpleConfig(width=w, height=h, fps=60, pixel_format=fmt),
                             filter="blur_sobel", overlay=True, device_sim=device_sim,
                             stencil_impl=stencil_impl)


def cpu_reference(spec, seq: int, rects, colors) -> dict:
    """``spec``'s plain pipeline on the CPU (one stream), fed the host
    generator's frame of ``seq``."""
    import torch

    from rustcv_tpu_torch.capture.simulation import synth_raw
    from rustcv_tpu_torch.runtime.pipeline import get_pipeline

    set_mode("default")
    fn = get_pipeline(dataclasses.replace(spec, stencil_impl="xla"))
    raw = torch.from_numpy(synth_raw(spec.width, spec.height, spec.pixel_format, seq))[None]
    return fn(raw, torch.from_numpy(np.asarray(rects)[:1]), torch.from_numpy(np.asarray(colors)[:1]),
              THICKNESS)


def same_ticks(got, want, keys, what: str) -> None:
    import torch

    for t, (a, b) in enumerate(zip(got, want)):
        for key in keys:
            expect(torch.equal(a.outputs[key], b.outputs[key]),
                   f"{what} tick {t}: {key} differs from the plain engine")


def run_formats() -> dict:
    """Phase 3g: every wire format but YUYV (the headline's) at 1920×1080,
    host-staged (2 streams) and, for those the device synthesizes, device-sim
    (8 streams): 2 ticks each equal to a plain engine's on the card, stream
    0 of its first tick equal to the plain pipeline on the CPU, the output in
    the reference's layout, K1 once per tick; NV12 device-sim also under
    ``pallas`` and ``pallas_tick``, which take the plain decode and K1.
    Returns the path's launches."""
    import torch

    from rustcv_tpu_torch.core import PixelFormat
    from rustcv_tpu_torch.ops import kernels
    from rustcv_tpu_torch.runtime.pipeline import packed_output

    rects, colors = bench_overlay()
    cases = [(PixelFormat[f], False, 2, "default") for f in HOST_FORMATS]
    cases += [(PixelFormat[f], True, N, "default") for f in SIM_FORMATS]
    cases += [(PixelFormat.NV12, True, N, m) for m in ("pallas", "pallas_tick")]
    kernels.reset_launch_counts()  # the formats' path starts here
    for fmt, device_sim, n, mode in cases:
        what = f"{fmt.value} {'device-sim' if device_sim else 'host-staged'} {n}x1080p {mode}"
        before = kernels.launch_counts()
        plain = format_engine(fmt, device_sim, n, stencil_impl="xla")
        ref = [plain.tick(rects=rects[:n], rect_colors=colors[:n]) for _ in range(2)]
        plain.close()
        eng = format_engine(fmt, device_sim, n, mode)
        got = [eng.tick(rects=rects[:n], rect_colors=colors[:n]) for _ in range(2)]
        torch.cuda.synchronize()
        eng.close()
        after = kernels.launch_counts()
        per = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        expect(per == {"blur_sobel_mag": 2}, f"{what}: launches {per}, K1 twice expected")
        same_ticks(got, ref, ("bgr", "filtered"), what)
        layout = (n, H, 3 * W) if packed_output(eng.spec) else (n, H, W, 3)
        expect(tuple(got[0].outputs["bgr"].shape) == layout, f"{what}: bgr {got[0].outputs['bgr'].shape}")
        expect(got[0].sequences.tolist() == [0] * n, f"{what}: sequences {got[0].sequences}")
        cpu = cpu_reference(eng.spec, 0, rects, colors)
        for key in ("bgr", "filtered"):
            expect(torch.equal(got[0].outputs[key][:1].cpu(), cpu[key]),
                   f"{what}: stream 0 {key} differs from the plain pipeline on the CPU")
        expect(int(got[0].outputs["filtered"].max()) > 0, f"{what}: the filter output is all zero")
        print(f"format {what}: 2 ticks identical to the plain engine, stream 0 to the CPU; bgr "
              f"{tuple(got[0].outputs['bgr'].shape)}; launches {per}", flush=True)
    return kernels.launch_counts()  # read just after the formats' run


def chain_engine(name: str, mode: str, device="cuda"):
    from rustcv_tpu_torch.models import get_model

    set_mode(mode)
    return get_model(name).engine(device=device)


def run_chained_graphs() -> dict:
    """Phase 3h: configs 1 and 4 (default and ``pallas``) chained as
    ``bench_models.py`` runs one-stream models: one replay of the captured
    graph of CHAIN ticks gives the probe and clock of CHAIN eager ticks on
    the card, and the kernel wrappers counted CHAIN × the eager tick's
    launches of each kernel while the graph was captured; a 2-tick graph's
    probe and clock equal the CPU port's chain. Returns the path's launches
    (a replay calls no wrapper: the graph's are counted at its capture)."""
    import torch

    from rustcv_tpu_torch.ops import kernels

    rects, colors = (a[:1] for a in bench_overlay())
    r_t, c_t = torch.from_numpy(rects).cuda(), torch.from_numpy(colors).cuda()
    kernels.reset_launch_counts()  # the chained path starts here
    for name, mode in CHAIN_CASES:
        what = f"{name} mode {mode}"
        eng = chain_engine(name, mode)
        expect(eng.n == 1, f"{what}: {eng.n} streams")
        before = kernels.launch_counts()
        eng.tick(rects=rects, rect_colors=colors, thickness=THICKNESS)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        per_tick = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        for k in (CHAIN, 2):
            ch = eng._chain(k)
            expect(ch.graph is not None, f"{what}: no CUDA graph")
            want = {label: k * v for label, v in per_tick.items()}
            expect(ch.launches == want, f"{what}: launches captured in a graph of {k} ticks "
                   f"{ch.launches}, {k} x the eager tick's {per_tick} expected")
            ch.rects.copy_(r_t)
            ch.colors.copy_(c_t)
            ch.seqs.zero_()
            ch.dispatch()
            replay = ch.sync.clone()
            expect(ch.seqs.tolist() == [k], f"{what}: the clock after a replay {ch.seqs.tolist()}")
            eager = eng._build_sim_fn_chained(k)(torch.zeros(1, dtype=torch.int32, device="cuda"),
                                                 r_t, c_t, THICKNESS)
            expect(torch.equal(replay, eager["_sync"]) and eager["_next_seqs"].tolist() == [k],
                   f"{what}: replay probe {replay.tolist()} != {k} eager ticks' "
                   f"{eager['_sync'].tolist()}")
            if k == 2:
                cpu = chain_engine(name, "default", device="cpu")
                ref = cpu._build_sim_fn_chained(2)(torch.zeros(1, dtype=torch.int32),
                                                   torch.from_numpy(rects), torch.from_numpy(colors),
                                                   THICKNESS)
                expect(torch.equal(replay.cpu(), ref["_sync"]) and ref["_next_seqs"].tolist() == [2],
                       f"{what}: the 2-tick graph's probe differs from the CPU port's chain")
            else:
                print(f"chained {what}: a replay of {k} ticks == {k} eager ticks (probe "
                      f"{replay.item()}); launches captured {ch.launches}, eager tick {per_tick}",
                      flush=True)
        eng.close()
    return kernels.launch_counts()  # read just after the chained path's run


def run_set_resolution() -> dict:
    """Phase 3i: the headline's 8 streams (device-sim and host-staged),
    their 720p and 1080p buckets warmed (``warm_buckets``), swapped 1080p →
    720p → 1080p; after each swap 2 ticks equal to a fresh engine's at that
    size (device-sim: one resumed from the swapped engine's state, so the
    clocks agree). Returns the path's launches."""
    import torch

    from rustcv_tpu_torch.core import PixelFormat
    from rustcv_tpu_torch.ops import kernels
    from rustcv_tpu_torch.runtime import MultiStreamEngine

    rects, colors = bench_overlay()
    kernels.reset_launch_counts()  # the swap path starts here
    for device_sim in (True, False):
        what = "device-sim" if device_sim else "host-staged"
        eng = format_engine(PixelFormat.YUYV, device_sim, N)
        for _ in range(2):
            eng.tick(rects=rects, rect_colors=colors)
        warmed = eng.warm_buckets(buckets=[(1280, 720), (W, H)])
        expect(warmed == 2, f"{what}: warm_buckets warmed {warmed} of 2 buckets")
        for w, h in ((1280, 720), (W, H)):
            t0 = time.perf_counter()
            eng.set_resolution(w, h)
            swap_ms = (time.perf_counter() - t0) * 1e3
            if device_sim:
                fresh = MultiStreamEngine.from_state(eng.export_state())
            else:
                fresh = format_engine(PixelFormat.YUYV, False, N, w=w, h=h)
            got = [eng.tick(rects=rects, rect_colors=colors) for _ in range(2)]
            want = [fresh.tick(rects=rects, rect_colors=colors) for _ in range(2)]
            torch.cuda.synchronize()
            fresh.close()
            expect(all(tuple(r.outputs["bgr"].shape) == (N, h, 3 * w) for r in got),
                   f"{what} at {w}x{h}: bgr {tuple(got[0].outputs['bgr'].shape)}")
            expect(all(a.sequences.tolist() == b.sequences.tolist() for a, b in zip(got, want)),
                   f"{what} at {w}x{h}: sequences differ from a fresh engine's")
            same_ticks(got, want, ("bgr", "filtered"), f"{what} after the swap to {w}x{h}")
            print(f"set_resolution {what} -> {w}x{h} in {swap_ms:.1f} ms: 2 ticks identical to a "
                  f"fresh engine's", flush=True)
        eng.close()
    return kernels.launch_counts()  # read just after the swap path's run


def zoo_engine(name: str, mode: str = "default", **overrides):
    from rustcv_tpu_torch.models import get_model

    set_mode(mode)
    return get_model(name).engine(**overrides)


def run_zoo_configs() -> dict:
    """Phase 3j: BASELINE configs 1 (1 × 640×480, overlay), 3 (32 × 4K,
    blur_sobel; one batch as the zoo runs it, and sub_batch=4) and 5 (8 × 4K,
    blur_sobel and overlay; every decode mode) through the zoo at full size:
    ticks equal to a plain engine's (``stencil_impl="xla"``, the default
    mode, no sub-batch) on the card, stream 0 of seq 0 to the CPU port.
    Returns the paths' launches."""
    import torch

    from rustcv_tpu_torch.ops import kernels

    rects, colors = bench_overlay()
    kernels.reset_launch_counts()  # the zoo configs' path starts here
    for name, variants, ticks in ZOO_CASES:
        plain = zoo_engine(name, stencil_impl="xla", sub_batch=None)
        n = plain.n
        ref = [plain.tick(rects=rects[:1].repeat(n, 0), rect_colors=colors[:1].repeat(n, 0))
               for _ in range(ticks)]
        torch.cuda.synchronize()
        spec = plain.spec
        plain.close()
        cpu = cpu_reference(spec, 0, rects, colors)
        keys = [k for k in ("bgr", "filtered") if k in ref[0].outputs]
        for key in keys:
            expect(torch.equal(ref[0].outputs[key][:1].cpu(), cpu[key]),
                   f"{name}: the plain engine's stream 0 {key} differs from the CPU port")
        for label, mode, overrides in variants:
            before = kernels.launch_counts()
            eng = zoo_engine(name, mode, **overrides)
            got = [eng.tick(rects=rects[:1].repeat(n, 0), rect_colors=colors[:1].repeat(n, 0))
                   for _ in range(ticks)]
            torch.cuda.synchronize()
            eng.close()
            after = kernels.launch_counts()
            per = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            same_ticks(got, ref, keys, f"{name} {label}")
            chunks = n // eng._sub_batch if eng._sub_batch else 1  # a launch per sub-batch
            want = {k: v * ticks * chunks
                    for k, v in (ZOO_LAUNCHES[mode] if "filtered" in keys else {}).items()}
            expect(per == want, f"{name} {label}: launches {per}, expected {want}")
            print(f"{name} {label}: {ticks} ticks identical to the plain engine (stream 0 of seq "
                  f"0 to the CPU port); launches {per}", flush=True)
        del ref
        torch.cuda.empty_cache()
    return kernels.launch_counts()  # read just after the zoo configs' run


FACADE_W, FACADE_H = 1280, 720  # the README loop's set_resolution
FACADE_READS = 8
FACADE_TIMED = (20, 8)  # timed reads per decode at 1280×720 and at 3840×2160
# Hybrid MJPEG decodes and JPEG coefficients of the card against the CPU
# port: max |diff|, share of bytes (tests/test_torch_mjpeg.py and
# tests/test_torch_encode.py).
JPEG_TOL = (1, 5e-3)


def facade_draws(ip, mat) -> None:
    """The facade phase's drawing calls (the README's rectangle first), on
    a 1280×720 Mat: edges over the frame, filled and ring shapes."""
    ip.rectangle(mat, ip.Rect(60, 60, 200, 150), ip.Scalar(0, 255, 0), 2)
    ip.rectangle(mat, ip.Rect(-9, -5, 400, 200), ip.Scalar(1, 2, 3), 4)
    ip.line(mat, ip.Point(-20, 10), ip.Point(1300, 700), ip.Scalar(255, 0, 0), 3)
    ip.circle(mat, ip.Point(640, 360), 100, ip.Scalar(0, 0, 255), -1)
    ip.circle(mat, ip.Point(1250, 20), 90, ip.Scalar(0, 9, 255), 2)
    ip.fill_poly(mat, [(100, 600), (600, 400), (1279, 719), (300, 650)], ip.Scalar(7, 8, 9))
    ip.ellipse(mat, ip.Point(900, 300), (300, 120), 30.0, ip.Scalar(9, 9, 9), 2)


def within(got, want, tol, what: str) -> None:
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(want).astype(np.int64))
    expect(d.shape == np.asarray(want).shape, f"{what}: shape {d.shape}")
    share = float((d > 0).mean())
    expect(int(d.max()) <= tol[0] and share < tol[1],
           f"{what}: max |diff| {int(d.max())}, share {share:.2e} beyond {tol}")


def run_facade() -> dict:
    """Phase 3k: the OpenCV-style facade, the README loop without
    ``put_text``: ``VideoCapture(0, SimulationDriver(paced=False))`` at
    1280×720 read 8 times by the host decode (``decode_on_device=False``)
    and 8 times with ``decode_on_device=True`` on the card, equal byte for
    byte; rectangle,
    line, circle, fill_poly and ellipse on the CUDA Mat equal to the same
    calls on a host Mat, with no blocking host-to-device copy (the sync
    debug mode raises on one); ``harris_corners`` on the CUDA Mat (K6's
    int32 form) equal to the CPU Mat's; ``imencode``/``imdecode`` on the
    card within JPEG_TOL of the CPU port; ``VideoWriter`` → ``.avi`` →
    ``VideoCapture(path, decode_on_device=True, mjpeg_hybrid=True)``: the
    frame count, and each frame within JPEG_TOL of the CPU decode of the
    same bytes; ``imshow`` → ``get_window_frame`` equal to the Mat, and
    ``push_key``/``wait_key``. Returns the path's launches."""
    import tempfile

    import torch

    from rustcv_tpu_torch import highgui, imgcodecs, imgproc, native
    from rustcv_tpu_torch.capture import AviMjpegReader, SimulationDriver
    from rustcv_tpu_torch.ops import jpeg_tpu, kernels
    from rustcv_tpu_torch.prelude import Mat, VideoCapture, VideoWriter

    os.environ["RUSTCV_GUI"] = "0"  # highgui's headless sink
    kernels.reset_launch_counts()  # the facade's path starts here
    drv = SimulationDriver(paced=False, n_unique_frames=UNIQUE)
    host = VideoCapture(0, drv, decode_on_device=False)
    card = VideoCapture(0, drv, decode_on_device=True)
    frames = []
    try:
        for cap in (host, card):
            expect(cap.set_resolution(FACADE_W, FACADE_H), f"set_resolution: {cap.last_error}")
        a, b = Mat(), Mat()
        for i in range(FACADE_READS):
            expect(host.read(a) and card.read(b), f"read {i} failed")
            expect(b.is_on_device and b.device().is_cuda and not a.is_on_device,
                   f"read {i}: the decodes did not land where asked")
            expect(np.array_equal(a.to_numpy(), b.to_numpy()),
                   f"read {i}: the host and the device decode differ")
            frames.append(b.device())
    finally:
        host.release()
        card.release()
    expect(b.shape == (FACADE_H, FACADE_W, 3), f"Mat {b.shape}")
    print(f"facade: {FACADE_READS} reads at {FACADE_W}x{FACADE_H}, host and device decode "
          "identical", flush=True)

    on_host = Mat.from_array(b.to_numpy())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        facade_draws(imgproc, b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    facade_draws(imgproc, on_host)
    expect(b.is_on_device and np.array_equal(b.to_numpy(), on_host.to_numpy()),
           "the draws on the CUDA Mat differ from the host Mat's")
    corners = imgproc.harris_corners(b)
    want = imgproc.harris_corners(Mat.from_array(b.to_numpy(), device="cpu"))
    expect(corners.any() and np.array_equal(corners, want),
           "harris_corners on the CUDA Mat differs from the CPU Mat's")
    print(f"facade: draws on the CUDA Mat identical to the host Mat's, no blocking copy; "
          f"harris_corners {int(corners.sum())} corners, identical to the CPU", flush=True)

    data = imgcodecs.imencode(".jpg", b, 90, backend="tpu")
    expect(imgcodecs.imencode(".jpg", b, 90) == data,
           "imencode: the default encode of a CUDA Mat is not the card's")
    cpu = imgcodecs.imencode(".jpg", Mat.from_array(b.to_numpy(), device="cpu"), 90, backend="host")
    got_c, want_c = native.jpeg_entropy_decode(data)[1], native.jpeg_entropy_decode(cpu)[1]
    for i, (g, w) in enumerate(zip(got_c, want_c)):
        within(g, w, JPEG_TOL, f"imencode component {i}")
    same = all(np.array_equal(g, w) for g, w in zip(got_c, want_c))
    expect(not same or data == cpu, "imencode: equal coefficients but other bytes")
    dec = imgcodecs.imdecode(data, backend="tpu")
    expect(dec.device().is_cuda, "imdecode did not decode on the card")
    within(dec.to_numpy(), imgcodecs.imdecode(data, backend="tpu", device="cpu").to_numpy(), JPEG_TOL,
           "imdecode on the card against the CPU")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "facade.avi")
        with VideoWriter(path, fps=30, frame_size=(FACADE_W, FACADE_H), encoder="tpu") as writer:
            for t in frames:
                writer.write(t)
        reader = AviMjpegReader(path)
        expect((len(reader), reader.width, reader.height) == (len(frames), FACADE_W, FACADE_H),
               f"the AVI holds {len(reader)} frames of {reader.width}x{reader.height}")
        cap = VideoCapture(path, decode_on_device=True, mjpeg_hybrid=True)
        try:
            m, n = Mat(), 0
            while cap.read(m):
                expect(m.device().is_cuda, "the AVI frame did not decode on the card")
                within(m.to_numpy(), jpeg_tpu.decode_jpeg_tpu(reader.frame_bytes(n), "cpu").numpy(),
                       JPEG_TOL, f"AVI frame {n} against the CPU decode")
                n += 1
            expect(n == len(frames) and cap.last_error is None,
                   f"read {n} of {len(frames)} AVI frames ({cap.last_error})")
        finally:
            cap.release()
    print(f"facade: JPEG imencode/imdecode and a {len(frames)}-frame AVI round trip within "
          f"{JPEG_TOL} of the CPU", flush=True)

    highgui.imshow("facade", b)
    expect(np.array_equal(highgui.get_window_frame("facade"), b.to_numpy()),
           "imshow: the window frame differs from the Mat")
    highgui.push_key(highgui.KEY_ESC)
    expect(highgui.wait_key(1) == highgui.KEY_ESC and highgui.wait_key(1) == -1,
           "push_key/wait_key")
    highgui.destroy_all_windows()
    return kernels.launch_counts()  # read just after the facade's run


def time_facade(smi: str) -> None:
    """Phase 4k: ms per ``read`` and frames/s of the facade's host decode
    (``decode_on_device=False``) and of its default, which decodes where
    ``Mat()`` is, on the card (host clock over FACADE_TIMED reads after 2
    warm ones, each read synchronised; one driver, so each resolution's 8
    cycled frames are made once), at 1280×720 and at the default
    3840×2160; ms per draw on a 1280×720 CUDA Mat (CUDA events over 50
    calls, the host's issue included)."""
    import torch

    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.capture import SimulationDriver
    from rustcv_tpu_torch.prelude import Mat, VideoCapture

    tag = f"[{smi}]"
    drv = SimulationDriver(paced=False, n_unique_frames=UNIQUE)
    for size in ((FACADE_W, FACADE_H), None):
        reads = FACADE_TIMED[size is None]
        for label, kwargs in (("host decode", {"decode_on_device": False}), ("device decode", {})):
            cap = VideoCapture(0, drv, **kwargs)
            try:
                if size:
                    expect(cap.set_resolution(*size), f"set_resolution: {cap.last_error}")
                mat = Mat()
                for _ in range(2):
                    expect(cap.read(mat), "read failed")
                expect(mat.is_on_device == (label == "device decode"),
                       f"{label}: the frame did not land where asked")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reads):
                    cap.read(mat)
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / reads
                w, h = cap.get_width(), cap.get_height()
            finally:
                cap.release()
            print(f"{tag} facade read, {label}, {w}x{h}: {ms:.4f} ms/read, {1e3 / ms:.1f} frames/s",
                  flush=True)
    img = np.random.default_rng(2).integers(0, 256, (FACADE_H, FACADE_W, 3), np.uint8)
    mat = Mat.from_array(img)
    mat.device()
    draws = {
        "rectangle": lambda: ip.rectangle(mat, ip.Rect(60, 60, 200, 150), ip.Scalar(0, 255, 0), 2),
        "line": lambda: ip.line(mat, ip.Point(-20, 10), ip.Point(1300, 700), ip.Scalar(255, 0, 0), 3),
        "circle": lambda: ip.circle(mat, ip.Point(640, 360), 100, ip.Scalar(0, 0, 255), -1),
        "fill_poly": lambda: ip.fill_poly(mat, [(100, 600), (600, 400), (1279, 719), (300, 650)],
                                          ip.Scalar(7, 8, 9)),
        "ellipse": lambda: ip.ellipse(mat, ip.Point(900, 300), (300, 120), 30.0,
                                      ip.Scalar(9, 9, 9), 2),
    }
    for name, draw in draws.items():
        print(f"{tag} facade draw on a CUDA Mat, {name}, {FACADE_W}x{FACADE_H}: "
              f"{cuda_ms(draw, 50):.4f} ms/call", flush=True)


# The three frozen put_text masks: tests/test_spec_freeze.py:119-121
# (SHA-256 prefix, shape, dx, dy).
FROZEN_MASKS = {
    ("FPS: 42.0", 1.0): ("ee52d0a2ba9dbb36", (24, 128), 0, -19),
    ("Hello, RustCV!", 0.75): ("56b219d91ce6f70f", (18, 128), 0, -14),
    ("XyZ 089", 2.0): ("d4ad8f4689ecea68", (48, 256), 0, -38),
}
TEXT_READS = 4  # README loop frames with put_text, on the card and on the CPU
TEXT_TICKS = 2  # headline ticks with text per mode (the strings change between them)
TEXT_ORG, TEXT_COLOR = (20, 60), (0, 255, 255)
C2_HOST_TICKS = 6


def text_strings(t: int) -> list:
    """Per-stream overlay strings of tick ``t``: camera names and FPS
    counters, ligatures and kerning pairs among them."""
    return [f"cam {i} | FPS {59.94 - t - i / 10:.2f} fi AV" for i in range(N)]


def readme_loop(cap, mat, put_text_on_card: bool) -> list:
    """The README loop's body for TEXT_READS frames: read, rectangle,
    put_text; returns the drawn frames on the host. On the card the draws
    run under the sync debug mode, which raises on a blocking copy."""
    import torch

    from rustcv_tpu_torch import imgproc as ip

    out = []
    for i in range(TEXT_READS):
        expect(cap.read(mat), f"README loop read {i}: {cap.last_error}")
        if put_text_on_card:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            ip.rectangle(mat, ip.Rect(60, 60, 200, 150), ip.Scalar(0, 255, 0), 2)
            ip.put_text(mat, f"FPS: {30 - i * 0.25:.2f} frame {i}", ip.Point(10, 30), 1.0,
                        ip.Scalar(0, 255, 255))
            ip.put_text(mat, "Wavy fjord AV", ip.Point(1200, 715), 2.0, ip.Scalar(255, 0, 9))
        finally:
            if put_text_on_card:
                torch.cuda.set_sync_debug_mode(0)
        out.append(mat.to_numpy())
    return out


def run_text_and_codecs() -> dict:
    """Phase 3l: what Pillow does in the reference. The three frozen masks
    against their constants (this machine has neither jax nor Pillow); the
    README loop with ``put_text`` at 1280×720 on a CUDA Mat equal to the
    same loop on a CPU Mat (the card's draws under the sync debug mode);
    the headline engine, 8 × 1080p, with ``tick(text=[8 strings])`` in
    every decode mode, each tick equal to the host oracle: the same
    engine's tick without text plus ``golden.blend_mask`` of the port's
    masks; PNG through ``imwrite``/``imread`` and the ``highgui`` dump;
    config 2 with ``mjpeg_backend="host"`` byte-equal to the host decode of
    the same frames on the CPU, resized there; ``VideoWriter(encoder="host")``
    → ``.avi`` → ``VideoCapture`` on a CPU Mat. Returns the
    phase's launches, which the kernels line does not add."""
    import hashlib
    import tempfile

    import torch

    from rustcv_tpu_torch import highgui, imgcodecs, native
    from rustcv_tpu_torch.capture import AviMjpegReader, SimulationDriver
    from rustcv_tpu_torch.capture.simulation import synth_raw
    from rustcv_tpu_torch.core import PixelFormat
    from rustcv_tpu_torch.ops import golden, kernels, resize, text
    from rustcv_tpu_torch.prelude import Mat, VideoCapture, VideoWriter

    for (s, scale), want in FROZEN_MASKS.items():
        mask, dx, dy = text.rasterize(s, scale)
        got = (hashlib.sha256(mask.tobytes()).hexdigest()[:16], mask.shape, dx, dy)
        expect(got == want, f"frozen mask {s!r} at {scale}: {got} != {want}")
    print("text: the three frozen put_text masks match their hashes", flush=True)

    kernels.reset_launch_counts()  # this phase's paths start here
    drv = SimulationDriver(paced=False, n_unique_frames=UNIQUE)
    card = VideoCapture(0, drv, decode_on_device=True)
    host = VideoCapture(0, drv, decode_on_device=False)
    try:
        for cap in (card, host):
            expect(cap.set_resolution(FACADE_W, FACADE_H), f"set_resolution: {cap.last_error}")
        on_card = readme_loop(card, Mat(), True)
        on_cpu = readme_loop(host, Mat(device="cpu"), False)
    finally:
        card.release()
        host.release()
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        expect(a.shape == (FACADE_H, FACADE_W, 3) and np.array_equal(a, b),
               f"README loop frame {i}: the CUDA Mat differs from the CPU Mat")
    print(f"text: the README loop with put_text, {TEXT_READS} frames at {FACADE_W}x{FACADE_H}, "
          "CUDA Mat identical to the CPU Mat, no blocking copy", flush=True)

    rects, colors = bench_overlay()
    for mode in MODES:
        plain, texted = make_engine(mode), make_engine(mode)
        try:
            for t in range(TEXT_TICKS):
                strings = text_strings(t)
                base = plain.tick(rects=rects, rect_colors=colors, block=True).numpy("bgr")
                got = texted.tick(rects=rects, rect_colors=colors, block=True, text=strings,
                                  text_org=TEXT_ORG, text_scale=1.5,
                                  text_color=TEXT_COLOR).numpy("bgr")
                for i, s in enumerate(strings):
                    mask, dx, dy = text.rasterize(s, 1.5)
                    want = base[i].copy()
                    golden.blend_mask(want, mask, TEXT_ORG[0] + dx, TEXT_ORG[1] + dy, TEXT_COLOR)
                    expect(np.array_equal(got[i], want) and not np.array_equal(want, base[i]),
                           f"{mode} tick {t} stream {i}: text differs from the host oracle")
        finally:
            plain.close()
            texted.close()
    set_mode("default")
    print(f"text: headline {N} x {W}x{H} tick(text=[{N} strings]) in modes {MODES}, "
          f"{TEXT_TICKS} ticks each, identical to decode + golden.blend_mask", flush=True)

    frame = Mat.from_device(torch.from_numpy(on_card[-1]).cuda())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frame.png")
        expect(imgcodecs.imwrite(path, frame), "imwrite of a PNG failed")
        back = imgcodecs.imread(path)
        expect(back.device().is_cuda and np.array_equal(back.to_numpy(), on_card[-1]),
               "PNG imwrite/imread changed the pixels")
        os.environ["RUSTCV_TPU_DISPLAY_DIR"] = tmp
        try:
            highgui.imshow("text phase", frame)
        finally:
            del os.environ["RUSTCV_TPU_DISPLAY_DIR"]
            highgui.destroy_all_windows()
        dumped = imgcodecs.imread(os.path.join(tmp, "text_phase.png"), device="cpu")
        expect(np.array_equal(dumped.to_numpy(), on_card[-1]), "the highgui dump changed the pixels")

        avi = os.path.join(tmp, "host.avi")
        frames = on_cpu[:3]
        with VideoWriter(avi, fps=30, frame_size=(FACADE_W, FACADE_H), encoder="host") as writer:
            for f in frames:
                writer.write(Mat.from_array(f, device="cpu"))
        reader = AviMjpegReader(avi)
        expect(len(reader) == len(frames), f"the AVI holds {len(reader)} frames")
        cap = VideoCapture(avi)
        try:
            m, n = Mat(device="cpu"), 0
            while cap.read(m):
                payload = reader.frame_bytes(n).tobytes()
                expect(payload == jpeg_encode_cpu(frames[n]), f"AVI frame {n}: not the host encode")
                expect(np.array_equal(m.to_numpy(), native.jpeg_decode_bgr(payload)),
                       f"AVI frame {n}: the read is not the host decode")
                n += 1
            expect(n == len(frames) and cap.last_error is None, f"read {n} AVI frames")
        finally:
            cap.release()
    print("codecs: PNG imwrite/imread and the highgui dump lossless; a 3-frame "
          "VideoWriter(encoder='host') AVI read back as the host decode of its payloads", flush=True)

    eng = make_c2(mjpeg_backend="host")
    try:
        expect(eng._mjpeg_host and eng.spec.resize_to == (C6_W, C6_H), "config 2 host spec")
        for t in range(C2_HOST_TICKS):
            res = eng.tick(block=True)
            got = res.numpy("bgr")
            for i in range(N):
                seq = int(res.sequences[i])
                bgr = native.jpeg_decode_bgr(synth_raw(W, H, PixelFormat.MJPEG, seq))
                want = resize.resize_bilinear(torch.from_numpy(bgr), C6_W, C6_H).numpy()
                expect(np.array_equal(got[i], want),
                       f"config 2 host tick {t} stream {i}: not the CPU decode resized")
    finally:
        eng.close()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()  # read just after this phase's paths
    print(f"config 2, mjpeg_backend='host': {C2_HOST_TICKS} ticks of {N} streams identical to "
          f"the CPU host decode resized; launches { {k: v for k, v in counts.items() if v} }",
          flush=True)
    return counts


def jpeg_encode_cpu(bgr) -> bytes:
    """The host encoder's payload of ``bgr``: the port's encoder on a CPU
    tensor at VideoWriter's default quality."""
    import torch

    from rustcv_tpu_torch.ops.jpeg_encode import encode_jpeg

    return encode_jpeg(torch.from_numpy(np.ascontiguousarray(bgr)), quality=90)


def time_text_and_codecs(smi: str) -> None:
    """Phase 4l: the headline engine's ms/tick with and without
    ``text=[8 strings]`` (CUDA events over 20 ticks, default mode); ms per
    ``put_text`` on a 1280×720 CUDA Mat (the mask cached; CUDA events over
    50 calls); the rasterizer's ms per string (host clock, uncached, 20
    strings of 20-30 characters at scale 1.5); config 2's ms/tick and
    frames/s with ``mjpeg_backend="host"`` beside the hybrid's (run(10)
    after a warm run of 3, in turns)."""
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import text
    from rustcv_tpu_torch.prelude import Mat

    tag = f"[{smi}]"
    rects, colors = bench_overlay()
    eng = make_engine("default")
    try:
        for label, kw in (("without text", {}), ("with text", {"text": text_strings(0)})):
            ms = cuda_ms(lambda: eng.tick(rects=rects, rect_colors=colors, **kw), TICKS)
            print(f"{tag} headline {N} x {W}x{H} default mode {label}: {ms:.4f} ms/tick", flush=True)
    finally:
        eng.close()
    mat = Mat.from_array(np.random.default_rng(3).integers(0, 256, (FACADE_H, FACADE_W, 3), np.uint8))
    mat.device()
    ms = cuda_ms(lambda: ip.put_text(mat, "FPS: 29.97", ip.Point(10, 30), 1.0,
                                     ip.Scalar(0, 255, 255)), 50)
    print(f"{tag} put_text on a {FACADE_W}x{FACADE_H} CUDA Mat: {ms:.4f} ms/call", flush=True)
    strings = [f"rasterizer {i}: fjord AV Wa {i * 7.3:.1f}" for i in range(20)]
    t0 = time.perf_counter()
    for s in strings:
        text.rasterize.__wrapped__(s, 1.5)
    print(f"{tag} text rasterizer (host): {(time.perf_counter() - t0) * 1e3 / len(strings):.4f} "
          "ms/string", flush=True)
    engines = {"host": make_c2(mjpeg_backend="host"), "hybrid": make_c2()}
    try:
        for eng in engines.values():
            eng.run(3, warmup=0, measure_latency=False)
        for label in ("host", "hybrid", "hybrid", "host"):
            r = engines[label].run(10, warmup=0, measure_latency=False)
            print(f"{tag} config 2, mjpeg_backend={label!r}: {r.wall_s / r.ticks * 1e3:.4f} ms/tick, "
                  f"{r.fps_total:.2f} frames/s, gather {r.host_gather_ms:.4f} ms", flush=True)
    finally:
        for eng in engines.values():
            eng.close()


# -- phases 3v and 4v: the formats the port reads without Pillow (ROADMAP
# Queue 1 item 8a). The files are made here with numpy, zlib and small
# writers; their truth is Pillow's reading rule, computed in numpy
# (tests/test_torch_image_formats.py holds these writers and truths, and
# the constants below, against Pillow).

# A 32x24 progressive 4:2:0 JPEG (quality 60, 677 bytes), written by Pillow
# 12.1, and the SHA-256 prefix of Pillow's decode of it (BGR bytes).
PROGRESSIVE_JPEG = bytes.fromhex(
    "ffd8ffe000104a46494600010100000100010000ffdb0043000d090a0b0a080d0b0a0b0e0e0d0f13201513121213271c"
    "1e17202e2931302e292d2c333a4a3e333646372c2d405741464c4e525352323e5a615a50604a51524fffdb0043010e0e"
    "0e131113261515264f352d354f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f4f"
    "4f4f4f4f4f4f4f4f4f4f4f4f4f4fffc20011080018002003012200021101031101ffc400190000020301000000000000"
    "000000000000000402030501ffc40017010100030000000000000000000000000004010203ffda000c03010002100310"
    "000001622973145ee6230d2ed44072b5e153ff00ffc400191000030101010000000000000000000000000102031112ff"
    "da00080101000105029d915b216cbab7494e4cac98b27d59b25c94e4f5288727ffc4001b110002020301000000000000"
    "00000000000003020412132123ffda0008010301013f0162d7acaaa5e4323e6548f4ffc4001911000203010000000000"
    "00000000000000000301021104ffda0008010201013f014a69a3e28b589a469d91b7c3ffc40014100100000000000000"
    "000000000000000030ffda0008010100063f024fffc400191000030101010000000000000000000000000111102071ff"
    "da0008010100013f219b8c99976932fc26ccc111ffda000c0301000200030000001065d7c1ffc4001811000301010000"
    "000000000000000000000001411131ffda0008010301013f10ae3fd89b17a3ffc4001c11010002010500000000000000"
    "0000000001002111104161b1f0ffda0008010201013f10dfe67e36d1ee349c4b683b9fffc40019100003010101000000"
    "0000000000000000000111213141ffda0008010100013f109ba899ea3d445855788978c978cf09918acc12f84be159e5"
    "e22570ffd9")
PROGRESSIVE_SHA = "cae0a84d03bffd15"
# put_text's Latin-1 string (the soft hyphen among it) and the SHA-256
# prefix, shape, dx and dy of the reference's mask at pixel sizes 4, 100, 160.
LATIN1_TEXT = "Ça fait 3½°C, déjà vu? «Ærø» fi\xadne"
LATIN1_MASKS = {4: ("29ebf4483f4795ac", (5, 128), 0, -4),
                100: ("ad78e4349b87cb14", (117, 1792), 0, -93),
                160: ("74bfd26d65da4734", (187, 2816), 0, -149)}
# The metadata of the phase's PNG with an eXIf chunk (png_exif()), as the
# reference reports it: Pillow's set order of the tags.
PNG_EXIF_META = {"exif:36864": "b'0230'", "exif:274": "6", "exif:282": "72.0", "exif:271": "card"}
FORMAT_TIMED = 5  # imreads per timing at 1080p
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    import struct
    import zlib

    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png_rows(s, depth) -> list:
    """Samples (n, w, ch) → unfiltered PNG rows, filter byte 0 first."""
    n, w, ch = s.shape
    if depth >= 8:
        dt = ">u2" if depth == 16 else np.uint8
        return [b"\x00" + r.astype(dt).tobytes() for r in s.reshape(n, w * ch)]
    per = 8 // depth
    pad = np.zeros((n, -(-w // per) * per), np.uint8)
    pad[:, :w] = s[..., 0]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    packed = np.bitwise_or.reduce(pad.reshape(n, -1, per) << shifts, axis=2).astype(np.uint8)
    return [b"\x00" + r.tobytes() for r in packed]


def png_file(s, depth: int, ctype: int, interlace: bool = False, plte=None, extra=b"") -> bytes:
    """A PNG of samples ``s`` (H, W, channels), plain or Adam7."""
    import struct
    import zlib

    h, w = s.shape[:2]
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    rows = [r for x0, y0, dx, dy in passes if s[y0::dy, x0::dx].size
            for r in _png_rows(s[y0::dy, x0::dx], depth)]
    out = [b"\x89PNG\r\n\x1a\n",
           _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))]
    if plte is not None:
        out.append(_png_chunk(b"PLTE", plte))
    out += [extra, _png_chunk(b"IDAT", zlib.compress(b"".join(rows))), _png_chunk(b"IEND", b"")]
    return b"".join(out)


def png_truth(s, depth: int, ctype: int, plte=None) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of those samples, as BGR: sub-byte gray
    scaled by 255 / (2^d - 1), 16-bit gray clipped at 255, the other
    16-bit types' high byte, palette indices past the PLTE black."""
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte) // 3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        rgb = pal[s[..., 0]]
    else:
        if depth == 16:
            v = np.minimum(s, 255) if ctype == 0 else s >> 8
        else:
            v = s * (255 // ((1 << depth) - 1))
        v = v.astype(np.uint8)
        rgb = np.repeat(v[..., :1], 3, axis=2) if ctype in (0, 4) else v[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def exif_tiff(entries) -> bytes:
    """Little-endian TIFF IFD0 of ``[(tag, type, count, value bytes)]``."""
    import struct

    body = struct.pack("<2sHLH", b"II", 42, 8, len(entries))
    data_at = 8 + 2 + 12 * len(entries) + 4
    tail = b""
    for tag, typ, count, value in entries:
        if len(value) <= 4:
            body += struct.pack("<HHL", tag, typ, count) + value.ljust(4, b"\x00")
        else:
            body += struct.pack("<HHLL", tag, typ, count, data_at + len(tail))
            tail += value
    return body + struct.pack("<L", 0) + tail


def png_exif(s) -> bytes:
    """An 8-bit RGB PNG with an eXIf chunk: Make, Orientation, XResolution
    and ExifVersion (PNG_EXIF_META)."""
    import struct

    ifd = exif_tiff([(0x010F, 2, 5, b"card\x00"), (0x0112, 3, 1, struct.pack("<H", 6)),
                     (0x011A, 5, 1, struct.pack("<LL", 72, 1)), (36864, 7, 4, b"0230")])
    return png_file(s, 8, 2, extra=_png_chunk(b"eXIf", ifd))


def bmp_file(w: int, h: int, bits: int, body: bytes, comp: int = 0, palette: bytes = b"") -> bytes:
    """A bottom-up BMP with a 40-byte header."""
    import struct

    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, comp, len(body), 2835, 2835,
                       len(palette) // 4, 0)
    off = 14 + 40 + len(palette)
    return b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + info + palette + body


def bmp_cases(w: int, h: int, rng) -> list:
    """(name, bytes, BGR truth): 1- and 4-bit palettes, 16-bit 5-5-5, RLE8
    and RLE4 (encoded runs, an absolute run, end of line and of bitmap)."""
    out = []
    for bits in (1, 4):
        n = 1 << bits
        pal = rng.integers(0, 256, (n, 4)).astype(np.uint8)
        idx = rng.integers(0, n, (h, w, 1)).astype(np.uint8)
        stride = ((w * bits + 31) >> 3) & ~3
        rows = [r[1:].ljust(stride, b"\x00") for r in _png_rows(idx[::-1], bits)]
        out.append((f"BMP {bits}-bit", bmp_file(w, h, bits, b"".join(rows), 0, pal.tobytes()),
                    pal[idx[..., 0], :3]))
    v = rng.integers(0, 1 << 15, (h, w)).astype(np.uint16)
    stride = (w * 2 + 3) & ~3
    rows = [r.astype("<u2").tobytes().ljust(stride, b"\x00") for r in v[::-1]]
    rgb555 = np.stack([(v >> 10) & 31, (v >> 5) & 31, v & 31], -1).astype(np.uint32) * 255 // 31
    out.append(("BMP 16-bit", bmp_file(w, h, 16, b"".join(rows)), rgb555[..., ::-1].astype(np.uint8)))
    pal = rng.integers(0, 256, (16, 4)).astype(np.uint8)
    for rle4 in (False, True):
        idx = np.zeros((h, w), np.uint8)
        body = bytearray()
        for y in range(h - 1, -1, -1):  # bottom-up
            x = 0
            if w >= 4:  # an absolute run of four pixels
                run = [(y + i) % 16 for i in range(4)]
                idx[y, :4] = run
                body += bytes([0, 4]) + (bytes([run[0] << 4 | run[1], run[2] << 4 | run[3]])
                                         if rle4 else bytes(run))
                x = 4
            while x < w:
                n, c = min(w - x, 9), (x * 7 + y) % 16
                idx[y, x:x + n] = c if not rle4 else [c, (c + 1) % 16] * (n // 2) + [c] * (n % 2)
                body += bytes([n, (c << 4 | (c + 1) % 16) if rle4 else c])
                x += n
            body += b"\x00\x00"
        body += b"\x00\x01"
        out.append((f"BMP RLE{4 if rle4 else 8}", bmp_file(w, h, 4 if rle4 else 8, bytes(body),
                                                             2 if rle4 else 1, pal.tobytes()),
                    pal[idx, :3]))
    return out


def pnm_cases(w: int, h: int, rng) -> list:
    """(name, bytes, BGR truth): P1-P6 at maxvals 1, 255, 1000 and 65535
    (gray above 255 clips, colour scales), and a PFM."""
    out = []
    bits = rng.integers(0, 2, (h, w))
    gray = ((1 - bits) * 255).astype(np.uint8)
    head = b"# made by chip_smoke\n%d %d\n" % (w, h)
    out.append(("P1", b"P1\n" + head + b"\n".join(b" ".join(b"%d" % x for x in r) for r in bits),
                gray))
    out.append(("P4", b"P4\n" + head + np.packbits(bits.astype(np.uint8), axis=1).tobytes(), gray))
    for magic, ch in ((b"P2", 1), (b"P3", 3), (b"P5", 1), (b"P6", 3)):
        for maxval in (1, 255, 1000, 65535):
            v = rng.integers(0, maxval + 1, (h, w, ch)).astype(np.int64)
            if magic in (b"P2", b"P3"):
                body = b"\n".join(b" ".join(b"%d" % x for x in r) for r in v.reshape(h, -1))
            else:
                body = v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
            out_max = 65535 if ch == 1 and maxval > 255 else 255
            t = v if (maxval == 255 or (magic == b"P5" and maxval == 65535)) else \
                np.rint(v / maxval * out_max).astype(np.int64)
            t = np.minimum(t, 255).astype(np.uint8)
            out.append((f"{magic.decode()} maxval {maxval}", magic + b"\n" + head + b"%d\n" % maxval
                        + body, t.repeat(3, axis=2) if ch == 1 else t[..., ::-1]))
    f = rng.normal(120, 100, (h, w)).astype(np.float32)
    t = np.clip(np.trunc(f[::-1].astype(np.float64)), 0, 255).astype(np.uint8)
    out.append(("PFM", b"Pf\n%d %d\n-1.0\n" % (w, h) + f.astype("<f4").tobytes(), t))
    return [(n, d, t if t.ndim == 3 else np.repeat(t[..., None], 3, axis=2)) for n, d, t in out]


def jpeg_uniform(w: int, h: int, hs, vs, dc) -> tuple:
    """A JPEG of one colour per component (DC ``dc``, quant table all 8, so
    each sample is 128 + dc) at sampling factors hs x vs, and its BGR truth
    through JFIF's YCbCr → RGB in libjpeg's integer tables."""
    from rustcv_tpu_torch import native

    mx, my = -(-w // (8 * max(hs))), -(-h // (8 * max(vs)))
    q = np.full(64, 8, np.uint16)
    coeffs = []
    for c in range(3):
        blocks = np.zeros((my * vs[c], mx * hs[c], 64), np.int16)
        blocks[..., 0] = dc[c]
        coeffs.append(blocks)
    data = native.jpeg_entropy_encode(coeffs, [q, q, q], w, h, list(hs), list(vs))
    y, cb, cr = (128 + d for d in dc)
    fix = lambda x: int(x * 65536 + 0.5)  # noqa: E731
    r = y + ((fix(1.402) * (cr - 128) + 32768) >> 16)
    g = y + ((-fix(0.34414) * (cb - 128) + 32768 - fix(0.71414) * (cr - 128)) >> 16)
    b = y + ((fix(1.772) * (cb - 128) + 32768) >> 16)
    bgr = np.clip(np.array([b, g, r]), 0, 255).astype(np.uint8)
    return data, np.broadcast_to(bgr, (h, w, 3)).copy()


def jpeg_textured(w: int, h: int, hs, vs, seed: int) -> bytes:
    """A JPEG of smooth seeded planes at sampling factors hs x vs, FDCT'd
    and quantized in numpy, entropy-coded by the port's coder."""
    from rustcv_tpu_torch import native

    dct = np.array([[np.sqrt((1 if k == 0 else 2) / 8) * np.cos((2 * n + 1) * k * np.pi / 16)
                     for n in range(8)] for k in range(8)])
    mx, my = -(-w // (8 * max(hs))), -(-h // (8 * max(vs)))
    rng = np.random.default_rng(seed)
    qs = [np.full(64, 4, np.uint16), np.full(64, 6, np.uint16)]
    coeffs = []
    for c in range(3):
        bw, bh = mx * hs[c], my * vs[c]
        yy, xx = np.mgrid[0:bh * 8, 0:bw * 8]
        plane = 128 + 60 * np.sin(xx / (9.0 + c)) * np.cos(yy / (7.0 + c)) + rng.normal(0, 6, yy.shape)
        blocks = np.clip(plane, 0, 255).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128
        d = np.einsum("ij,abjk,lk->abil", dct, blocks, dct)
        coeffs.append(np.round(d / qs[min(c, 1)].reshape(8, 8)).astype(np.int16).reshape(bh, bw, 64))
    return native.jpeg_entropy_encode(coeffs, [qs[0], qs[1], qs[1]], w, h, list(hs), list(vs))


def jpeg_one_scan_per_component(data: bytes, order=(0, 1, 2)) -> bytes:
    """A baseline stream re-cut into one non-interleaved scan per component,
    in ``order`` (each the port's coder's gray stream of that component's
    coefficients over its own block extent)."""
    import struct

    from rustcv_tpu_torch import native

    def segments(d):
        p, out = 2, []
        while True:
            m, n = d[p + 1], struct.unpack(">H", d[p + 2:p + 4])[0]
            out.append((m, d[p + 4:p + 2 + n]))
            p += 2 + n
            if m == 0xDA:
                return out, d[p:]

    def seg(m, body):
        return b"\xff" + bytes([m]) + struct.pack(">H", len(body) + 2) + body

    info, coefs, qts = native.jpeg_entropy_decode(data)
    w, h, hs, vs = info["width"], info["height"], info["h_samp"], info["v_samp"]
    segs, _ = segments(data)
    sof = [b for m, b in segs if m == 0xC0][0]
    out = [b"\xff\xd8"] + [seg(m, b) for m, b in segs if m not in (0xDA, 0xC4)]
    for i, c in enumerate(order):
        cw, ch = -(-w * hs[c] // max(hs)), -(-h * vs[c] // max(vs))
        bx, by = -(-cw // 8), -(-ch // 8)
        gray = native.jpeg_entropy_encode([coefs[c][:by, :bx].reshape(by, bx, 64)], [qts[c]],
                                          cw, ch, [1], [1])
        gsegs, entropy = segments(gray)
        if i == 0:
            out += [seg(m, b) for m, b in gsegs if m == 0xC4]
        out += [seg(0xDA, bytes([1, sof[6 + 3 * c], 0x00, 0, 63, 0])), entropy[:-2]]
    return b"".join(out + [b"\xff\xd9"])


def format_cases(w: int, h: int, seed: int = 21) -> list:
    """(name, bytes, BGR truth or None) of phase 3v at w x h: PNG at every
    depth and colour type, plain and Adam7, and with an eXIf chunk; P1-P6
    and PFM; BMP 1-, 4- and 16-bit, RLE8 and RLE4; 4:4:0 and 4:1:1 JPEG of
    one colour (truth) and textured (held to the CPU read), and a 4:2:0
    stream cut into one scan per component."""
    rng = np.random.default_rng(seed)
    out = []
    for ctype, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)),
                          (6, (8, 16))):
        for depth in depths:
            for interlace in (False, True):
                s = rng.integers(0, 1 << depth, (h, w, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]))
                plte = rng.integers(0, 256, 3 * max(1, (1 << depth) // 2)).astype(np.uint8).tobytes() \
                    if ctype == 3 else None
                out.append((f"PNG type {ctype} {depth}-bit{' Adam7' if interlace else ''}",
                            png_file(s, depth, ctype, interlace, plte), png_truth(s, depth, ctype, plte)))
    s = rng.integers(0, 256, (h, w, 3))
    out.append(("PNG eXIf", png_exif(s), png_truth(s, 8, 2)))
    out += pnm_cases(w, h, rng) + bmp_cases(w, h, rng)
    for name, hs, vs in (("4:4:0", (1, 1, 1), (2, 1, 1)), ("4:1:1", (4, 1, 1), (1, 1, 1))):
        data, truth = jpeg_uniform(w, h, hs, vs, (40, -30, 25))
        out.append((f"JPEG {name} one colour", data, truth))
        out.append((f"JPEG {name}", jpeg_textured(w, h, hs, vs, seed), None))
    out.append(("JPEG 4:2:0 one scan per component",
                jpeg_one_scan_per_component(jpeg_textured(w, h, (2, 1, 1), (2, 1, 1), seed)), None))
    return out


def run_formats_8a(dev: str = "cuda", w: int = 641, h: int = 361) -> dict:
    """Phase 3v: the formats of item 8a on the card's machine, with no
    Pillow. ``decode_mjpeg_host_rgb`` of the smoke's MJPEG frames is the
    channel swap of ``decode_mjpeg_host``; every file of
    :func:`format_cases` read by ``imread`` onto ``dev`` equals the CPU
    read and its numpy truth (where it has one); the PNG eXIf's metadata
    is the reference's dict; the progressive JPEG constant decodes to
    Pillow's hash, on ``dev`` and on the CPU; ``put_text`` of a Latin-1
    string at 4, 100 and 160 px on a ``dev`` Mat equals the same on a CPU
    Mat, its masks the reference's hashes. Returns the phase's launches
    (none expected)."""
    import hashlib
    import tempfile

    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.capture.simulation import synth_raw
    from rustcv_tpu_torch.core import PixelFormat
    from rustcv_tpu_torch.imgcodecs import exif
    from rustcv_tpu_torch.ops import decode, kernels, text
    from rustcv_tpu_torch.prelude import Mat

    kernels.reset_launch_counts()
    for seq in range(3):
        frame = synth_raw(W, H, PixelFormat.MJPEG, seq)
        expect(np.array_equal(decode.decode_mjpeg_host_rgb(frame),
                              decode.decode_mjpeg_host(frame)[..., ::-1]),
               f"decode_mjpeg_host_rgb of MJPEG frame {seq} is not the host decode swapped")
    cases = format_cases(w, h)
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, data, truth) in enumerate(cases + [("progressive JPEG", PROGRESSIVE_JPEG, None)]):
            path = os.path.join(tmp, f"{i}.img")
            with open(path, "wb") as f:
                f.write(data)
            on_dev = imgcodecs.imread(path, device=dev)
            cpu = imgcodecs.imread(path, device="cpu").to_numpy()
            expect(on_dev.device().device.type == dev, f"{name}: imread landed on {on_dev.device().device}")
            expect(np.array_equal(on_dev.to_numpy(), cpu), f"{name}: the {dev} read differs from the CPU's")
            if truth is not None:
                expect(cpu.shape == truth.shape and np.array_equal(cpu, truth),
                       f"{name}: the read differs from its numpy truth")
            if name == "progressive JPEG":
                digest = hashlib.sha256(np.ascontiguousarray(cpu).tobytes()).hexdigest()[:16]
                expect(digest == PROGRESSIVE_SHA, f"progressive JPEG: {digest} != {PROGRESSIVE_SHA}")
            if name == "PNG eXIf":
                meta = imgcodecs.imread_with_metadata(path, device=dev)[1]
                expect(meta == PNG_EXIF_META and list(meta) == list(PNG_EXIF_META),
                       f"PNG eXIf metadata {meta}")
                expect(exif.metadata(data) == meta, "exif.metadata differs from imread_with_metadata")
    print(f"formats: {len(cases) + 1} files ({', '.join(n for n, _, _ in cases)}, a "
          f"{len(PROGRESSIVE_JPEG)}-byte progressive JPEG) read onto {dev} at {w}x{h} equal to the "
          f"CPU read, {sum(t is not None for _, _, t in cases)} to their numpy truth; the "
          "progressive JPEG to Pillow's hash; the PNG eXIf's metadata the reference's", flush=True)

    base = np.random.default_rng(5).integers(0, 256, (H, W, 3), np.uint8)
    on_dev, on_cpu = Mat.from_array(base.copy(), device=dev), Mat.from_array(base.copy(), device="cpu")
    on_dev.device()
    for i, px in enumerate(sorted(LATIN1_MASKS)):
        mask, dx, dy = text.rasterize(LATIN1_TEXT, px / 20)
        got = (hashlib.sha256(mask.tobytes()).hexdigest()[:16], mask.shape, dx, dy)
        expect(got == LATIN1_MASKS[px], f"Latin-1 mask at {px} px: {got} != {LATIN1_MASKS[px]}")
        for mat in (on_dev, on_cpu):
            ip.put_text(mat, LATIN1_TEXT, ip.Point(10 + 40 * i, 60 + 300 * i), px / 20,
                        ip.Scalar(0, 255 - 60 * i, 255))
    expect(on_dev.is_on_device and np.array_equal(on_dev.to_numpy(), on_cpu.to_numpy())
           and not np.array_equal(on_cpu.to_numpy(), base),
           f"put_text of Latin-1 on a {dev} Mat differs from the CPU Mat")
    print(f"text: put_text of {LATIN1_TEXT!r} at {sorted(LATIN1_MASKS)} px on a {W}x{H} {dev} Mat "
          "identical to the CPU Mat, masks equal to the reference's hashes", flush=True)
    counts = kernels.launch_counts()
    expect(not any(counts.values()), f"phase 3v launched kernels: {counts}")
    return counts


def time_formats_8a(smi: str, dev: str = "cuda") -> None:
    """Phase 4v: ms per ``imread`` onto the card at 1920x1080 (CUDA events
    over FORMAT_TIMED reads, the file in the page cache) of a 16-bit RGB
    PNG, an 8-bit RGB Adam7 PNG, a 4:4:0 JPEG, a 4:2:0 JPEG in one scan per
    component and the 32x24 progressive JPEG; ``put_text`` at 160 px on a
    1080p CUDA Mat (the mask cached) and the rasterizer at 160 px (host
    clock, uncached)."""
    import tempfile

    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import text
    from rustcv_tpu_torch.prelude import Mat

    tag = f"[{smi}]"
    yy, xx = np.mgrid[0:H, 0:W]
    smooth = np.stack([xx * 34 + yy * 3, yy * 60, (xx ^ yy) * 257], -1) % 65536
    files = {
        "16-bit RGB PNG": png_file(smooth, 16, 2),
        "Adam7 8-bit RGB PNG": png_file(smooth >> 8, 8, 2, interlace=True),
        "4:4:0 JPEG": jpeg_textured(W, H, (1, 1, 1), (2, 1, 1), 3),
        "4:2:0 JPEG, one scan per component": jpeg_one_scan_per_component(
            jpeg_textured(W, H, (2, 1, 1), (2, 1, 1), 3)),
        "32x24 progressive JPEG": PROGRESSIVE_JPEG,
    }
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in files.items():
            path = os.path.join(tmp, "x.img")
            with open(path, "wb") as f:
                f.write(data)
            ms = cuda_ms(lambda: imgcodecs.imread(path, device=dev), FORMAT_TIMED)
            print(f"{tag} imread of a {name} ({len(data)} bytes) onto the card: {ms:.4f} ms", flush=True)
    mat = Mat.from_array(np.random.default_rng(3).integers(0, 256, (H, W, 3), np.uint8), device=dev)
    mat.device()
    ms = cuda_ms(lambda: ip.put_text(mat, LATIN1_TEXT, ip.Point(10, 200), 8.0,
                                     ip.Scalar(0, 255, 255)), 20)
    print(f"{tag} put_text at 160 px on a {W}x{H} {dev} Mat: {ms:.4f} ms/call", flush=True)
    t0 = time.perf_counter()
    for i in range(5):
        text.rasterize.__wrapped__(f"{LATIN1_TEXT} {i}", 8.0)
    print(f"{tag} text rasterizer at 160 px (host): {(time.perf_counter() - t0) * 1e3 / 5:.4f} "
          "ms/string", flush=True)


# -- phases 3w and 4w: TIFF and GIF, every page and frame (ROADMAP Queue 1
# item 8b). The files are made here without Pillow: TIFF by tiff_file (raw,
# PackBits, MSB-first LZW and both Deflate codes, II and MM, BigTIFF, strips
# and tiles, planar 2, predictor 2, every photometric and depth the port
# reads), GIF by gif_file (local palettes, interlace, offsets, transparency,
# each disposal, LZW minimum code sizes 2-8) and by the port's own writers;
# their truths are Pillow's reading rules computed in numpy
# (tests/test_torch_multipage_formats.py holds the writers and truths
# against Pillow).

MULTI_TIMED = 3  # calls per timing at 1080p
GIF_CODE_SIZES = (2, 3, 5, 8)


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, the early change, a clear code first and
    whenever the table fills, the end code last)."""
    out, acc, nacc = bytearray(), 0, 0
    width, table, nxt = 9, {}, 258

    def put(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    put(256)
    if data:
        cur = data[0]  # the code of the string matched so far
        for b in data[1:]:
            nb = cur << 8 | b
            if nb in table:
                cur = table[nb]
                continue
            put(cur)
            table[nb] = nxt
            nxt += 1
            if nxt >= 4094:  # libtiff's encoder: a clear before the table fills
                put(256)
                table, nxt, width = {}, 258, 9
            elif nxt >= 1 << width:
                width += 1
            cur = b
        put(cur)
        if nxt + 1 >= 1 << width and width < 12:  # the decoder adds one more entry
            width += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 or more as repeats, the rest as literals."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _tiff_pack(v: np.ndarray, bits: int, e: str) -> bytes:
    """Samples (rows, width, per) → packed rows (sub-byte samples MSB first,
    each row on a byte)."""
    n = v.shape[0]
    if bits < 8:
        flat = v.reshape(n, -1).astype(np.uint8)
        per = 8 // bits
        pad = np.zeros((n, -(-flat.shape[1] // per) * per), np.uint8)
        pad[:, :flat.shape[1]] = flat
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        return np.bitwise_or.reduce(pad.reshape(n, -1, per) << shifts, axis=2).astype(
            np.uint8).tobytes()
    return v.astype(v.dtype.newbyteorder(e)).tobytes()


def _tiff_diff(v: np.ndarray) -> np.ndarray:
    """Predictor 2: each sample minus the one to its left, modulo 2^bits."""
    u = v.view(v.dtype.str.replace("i", "u").replace("f", "u"))
    d = u.copy()
    d[:, 1:] = u[:, 1:] - u[:, :-1]
    return d.view(v.dtype)


def ycbcr_units(v: np.ndarray, h: int, vs: int) -> np.ndarray:
    """YCbCr samples (rows, cols, 3) → TIFF data units of h x vs luma
    samples, then one Cb and one Cr (the unit's top-left chroma), the block
    padded at the right and bottom by repeating its last column and row:
    (unit rows, units per row, h * vs + 2) u8."""
    rows, cols = v.shape[:2]
    pad = np.pad(v, ((0, -rows % vs), (0, -cols % h), (0, 0)), mode="edge")
    ur, uc = pad.shape[0] // vs, pad.shape[1] // h
    luma = pad[..., 0].reshape(ur, vs, uc, h).transpose(0, 2, 1, 3).reshape(ur, uc, h * vs)
    return np.concatenate([luma, pad[::vs, ::h, 1:3]], axis=2).astype(np.uint8)


def tiff_file(pages, order: str = "II", big: bool = False) -> bytes:
    """A TIFF of ``pages``, each a dict: ``samples`` (H, W, spp) in their
    dtype (u8 for 1-8 bits, u16, i32 or f32), ``photo``, and optionally
    ``bits``, ``fmt`` (SampleFormat), ``extra``, ``colormap``, ``comp`` (1,
    5, 7, 8, 32773, 32946), ``predictor``, ``planar``, ``tile`` (tw, th) or
    ``rows`` per strip, ``fill`` (FillOrder), ``tags`` ({tag: (type,
    values)}; None drops a tag the writer would add). ``ycbcr`` (h, v):
    YCbCr samples packed in data units (:func:`ycbcr_units`) and tag 530;
    with ``comp`` 7 it writes only the tag. ``jpeg``: with ``comp`` 7, a
    function of a strip's or tile's samples (rows, cols, per) and its plane
    that returns the chunk's JPEG bytes."""
    import struct
    import zlib

    e = "<" if order == "II" else ">"
    head = (b"II" if order == "II" else b"MM") + struct.pack(e + "H", 43 if big else 42)
    out = bytearray(head + (struct.pack(e + "HHQ", 8, 0, 0) if big else b"\x00" * 4))
    link = 8 if big else 4
    fmts = {1: "B", 2: "B", 3: "H", 4: "L", 5: "L", 7: "B", 11: "f", 16: "Q"}
    for pg in pages:
        v = np.asarray(pg["samples"])
        h, w, spp = v.shape
        bits = pg.get("bits", v.dtype.itemsize * 8)
        comp, planar = pg.get("comp", 1), pg.get("planar", 1)
        chunks, counts = [], []
        tw, th = pg["tile"] if "tile" in pg else (w, pg.get("rows", h))
        planes = [v[..., i:i + 1] for i in range(spp)] if planar == 2 else [v]
        for pi, plane in enumerate(planes):
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    if "tile" in pg:
                        blk = np.zeros((th, tw, plane.shape[2]), v.dtype)
                        part = plane[y:y + th, x:x + tw]
                        blk[:part.shape[0], :part.shape[1]] = part
                    else:
                        blk = plane[y:y + th]
                    if comp == 7:
                        chunks.append(pg["jpeg"](blk, pi))
                        counts.append(len(chunks[-1]))
                        continue
                    if "ycbcr" in pg:
                        units = ycbcr_units(blk, *pg["ycbcr"])
                        blk = units.reshape(1, -1, 1)
                        if pg.get("predictor", 1) == 2:  # libtiff's rows: a unit row / v, stride 3
                            n = units[0].size // pg["ycbcr"][1]
                            flat = units.reshape(-1)
                            if n % 3 == 0:
                                rows = flat[:flat.size // n * n].reshape(-1, n // 3, 3)
                                flat[:rows.size] = _tiff_diff(rows).reshape(-1)
                    elif pg.get("predictor", 1) == 2:
                        blk = _tiff_diff(blk)
                    raw = _tiff_pack(blk, bits, e)
                    data = {1: raw, 5: tiff_lzw(raw), 32773: packbits(raw)}.get(comp)
                    if data is None:
                        data = zlib.compress(raw)
                    if pg.get("fill", 1) == 2:  # the stored bytes, each bit-reversed
                        data = np.unpackbits(np.frombuffer(data, np.uint8)).reshape(-1, 8)[:, ::-1]
                        data = np.packbits(data).tobytes()
                    chunks.append(data)
                    counts.append(len(data))
        tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [comp]),
                262: (3, [pg["photo"]]), 277: (3, [spp]), 284: (3, [planar])}
        if pg.get("fmt", 1) != 1:
            tags[339] = (3, [pg["fmt"]] * spp)
        if pg.get("extra"):
            tags[338] = (3, list(pg["extra"]))
        if pg.get("predictor", 1) != 1:
            tags[317] = (3, [pg["predictor"]])
        if pg.get("fill", 1) != 1:
            tags[266] = (3, [pg["fill"]])
        if pg.get("colormap") is not None:
            tags[320] = (3, list(pg["colormap"]))
        if "tile" in pg:
            tags[322], tags[323] = (3, [tw]), (3, [th])
            tags[324], tags[325] = (16 if big else 4, [0] * len(chunks)), (4, counts)
        else:
            tags[278] = (3, [th])
            tags[273], tags[279] = (16 if big else 4, [0] * len(chunks)), (4, counts)
        if "ycbcr" in pg:
            tags[530] = (3, list(pg["ycbcr"]))
        tags.update(pg.get("tags", {}))
        tags = {k: t for k, t in tags.items() if t is not None}
        while len(out) % 2:
            out.append(0)
        at = len(out)
        for c in chunks:  # the image data before its IFD
            out += c
        starts = list(np.cumsum([at] + counts[:-1]))
        tags[324 if "tile" in pg else 273] = (16 if big else 4, [int(x) for x in starts])
        while len(out) % 2:
            out.append(0)
        ifd = len(out)
        struct.pack_into(e + ("Q" if big else "L"), out, link, ifd)
        inline, entry = (8, 20) if big else (4, 12)
        tail_at = ifd + (8 if big else 2) + entry * len(tags) + inline
        body = bytearray(struct.pack(e + ("Q" if big else "H"), len(tags)))
        tail = bytearray()
        for tag in sorted(tags):
            typ, vals = tags[tag]
            raw = struct.pack(f"{e}{len(vals)}{fmts[typ]}", *vals) if typ != 2 else bytes(vals)
            if len(raw) <= inline:
                value = raw.ljust(inline, b"\x00")
            else:
                value = struct.pack(e + ("Q" if big else "L"), tail_at + len(tail))
                tail += raw + (b"\x00" if len(raw) % 2 else b"")
            count = len(vals) // 2 if typ == 5 else len(vals)  # a rational is two longs
            body += struct.pack(e + ("HHQ" if big else "HHL"), tag, typ, count) + value
        link = ifd + len(body)
        body += b"\x00" * inline
        out += body + tail
    return bytes(out)


def tiff_truth(pg) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of a page's samples, as BGR: gray at 1-4
    bits scaled by 255 / (2^d - 1) (inverted for photometric 0, but not at
    16 bits), 16-bit and 32-bit gray clipped, float truncated, RGB at 16 bits
    its high bytes, associated alpha un-premultiplied, a palette's colour
    map's high bytes, CMYK by Pillow's integer formula; the orientation tag
    applied."""
    v = np.asarray(pg["samples"])
    photo, bits = pg["photo"], pg.get("bits", v.dtype.itemsize * 8)
    if photo in (0, 1) and v.shape[2] <= 2 and bits <= 8:
        g = v[..., 0].astype(np.int64) * (255 // ((1 << bits) - 1))
        g = 255 - g if photo == 0 else g
    elif photo in (0, 1) and v.shape[2] == 1:
        f = np.nan_to_num(v[..., 0].astype(np.float64), nan=0.0, posinf=255.0, neginf=0.0)
        g = np.clip(np.trunc(f), 0, 255)
    else:
        g = None
    if g is not None:
        rgb = np.repeat(g.astype(np.uint8)[..., None], 3, axis=2)
    elif photo == 3:
        cm = np.asarray(pg["colormap"]).reshape(3, -1).T // 256
        rgb = cm[v[..., 0]].astype(np.uint8)
    elif photo == 5:
        c = v.astype(np.int64)
        nk = 255 - c[..., 3:4]
        t = c[..., :3] * nk + 128
        rgb = np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    else:
        c = (v >> 8).astype(np.int64) if bits == 16 else v.astype(np.int64)
        rgb = c[..., :3]
        if tuple(pg.get("extra", ()))[:1] == (1,) and pg.get("planar", 1) == 1:
            a = c[..., 3:4]
            rgb = np.where(a == 0, 0, np.where(a == 255, rgb,
                                               np.clip(rgb * 255 // np.maximum(a, 1), 0, 255)))
        rgb = rgb.astype(np.uint8)
    o = pg.get("tags", {}).get(274, (3, [1]))[1][0]
    rgb = {1: rgb, 3: rgb[::-1, ::-1], 6: np.rot90(rgb, -1), 8: np.rot90(rgb, 1)}[o]
    return np.ascontiguousarray(rgb[..., ::-1])


def tiff_cases(w: int, h: int, seed: int = 22) -> list:
    """(name, bytes, [BGR truth per page]) of phase 3w at w x h: each
    compression, predictor 2, II and MM, strips and tiles, planar 2, every
    photometric and depth the port reads, fill order 2, an orientation, a
    three-page file and a BigTIFF."""
    rng = np.random.default_rng(seed)
    u8 = lambda *c: rng.integers(0, 256, (h, w) + c).astype(np.uint8)  # noqa: E731
    cmap4 = rng.integers(0, 65536, 48)
    cmap8 = rng.integers(0, 65536, 768)
    pages = {
        "raw RGB, 64-row strips": dict(samples=u8(3), photo=2, rows=64),
        "PackBits gray": dict(samples=u8(1) // 64 * 64, photo=1, comp=32773),
        "LZW RGB": dict(samples=u8(3) // 16 * 16, photo=2, comp=5, rows=32),
        "LZW RGB, predictor 2": dict(samples=u8(3), photo=2, comp=5, predictor=2, rows=40),
        "LZW 16-bit gray, predictor 2": dict(samples=rng.integers(0, 700, (h, w, 1)).astype(
            np.uint16), photo=1, comp=5, predictor=2),
        "Deflate RGBA, predictor 2": dict(samples=u8(4), photo=2, comp=8, predictor=2, extra=(2,)),
        "Deflate (32946) CMYK": dict(samples=u8(4), photo=5, comp=32946),
        "raw 16-bit RGB": dict(samples=rng.integers(0, 65536, (h, w, 3)).astype(np.uint16), photo=2),
        "LZW RGB tiles": dict(samples=u8(3), photo=2, comp=5, tile=(64, 48)),
        "raw planar RGB": dict(samples=u8(3), photo=2, planar=2, rows=50),
        "Deflate planar RGB, predictor 2": dict(samples=u8(3), photo=2, planar=2, comp=8,
                                                predictor=2, tile=(32, 32)),
        "bilevel, WhiteIsZero": dict(samples=rng.integers(0, 2, (h, w, 1)).astype(np.uint8),
                                     photo=0, bits=1),
        "2-bit gray, PackBits": dict(samples=rng.integers(0, 4, (h, w, 1)).astype(np.uint8),
                                     photo=1, bits=2, comp=32773),
        "4-bit WhiteIsZero, LZW": dict(samples=rng.integers(0, 16, (h, w, 1)).astype(np.uint8),
                                       photo=0, bits=4, comp=5),
        "4-bit palette": dict(samples=rng.integers(0, 16, (h, w, 1)).astype(np.uint8), photo=3,
                              bits=4, colormap=cmap4),
        "8-bit palette, Deflate": dict(samples=u8(1), photo=3, colormap=cmap8, comp=8),
        "float32 gray": dict(samples=rng.normal(120, 110, (h, w, 1)).astype(np.float32), photo=1,
                             fmt=3, comp=8),
        "int32 gray, predictor 2": dict(samples=rng.integers(-300, 600, (h, w, 1)).astype(np.int32),
                                        photo=1, fmt=2, comp=5, predictor=2),
        "gray + alpha": dict(samples=u8(2), photo=1, extra=(2,)),
        "associated alpha": dict(samples=u8(4), photo=2, extra=(1,), comp=5),
        "fill order 2, LZW gray": dict(samples=u8(1) // 32 * 32, photo=1, comp=5, fill=2),
        "orientation 6": dict(samples=u8(3), photo=2, comp=8, tags={274: (3, [6])}),
    }
    big_endian = ("PackBits gray", "LZW RGB, predictor 2", "raw 16-bit RGB", "raw planar RGB",
                  "4-bit WhiteIsZero, LZW", "8-bit palette, Deflate", "associated alpha")
    out = [(name, tiff_file([pg], "MM" if name in big_endian else "II"), [tiff_truth(pg)])
           for name, pg in pages.items()]
    three = [pages["LZW RGB, predictor 2"], pages["4-bit palette"], pages["Deflate (32946) CMYK"]]
    out.append(("three pages", tiff_file(three), [tiff_truth(pg) for pg in three]))
    out.append(("BigTIFF", tiff_file([pages["LZW RGB tiles"]], big=True),
                [tiff_truth(pages["LZW RGB tiles"])]))
    return out


def gif_lzw(idx: np.ndarray, bits: int) -> bytes:
    """GIF LZW of colour indices at minimum code size ``bits`` (LSB-first,
    a clear first and whenever the table fills), cut into sub-blocks."""
    clear, eoi = 1 << bits, (1 << bits) + 1
    out, acc, nacc = bytearray(), 0, 0
    width, table, nxt = bits + 1, {}, eoi + 1

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    put(clear)
    data = bytes(np.asarray(idx, np.uint8).ravel())
    cur = data[0] if data else None  # the code of the string matched so far
    for b in data[1:]:
        nb = cur << 8 | b
        if nb in table:
            cur = table[nb]
            continue
        put(cur)
        if nxt < 4096:
            table[nb] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        else:
            put(clear)
            table, nxt, width = {}, eoi + 1, bits + 1
        cur = b
    if cur is not None:
        put(cur)
        if len(data) > 1 and nxt < 4096 and nxt + 1 > (1 << width) and width < 12:
            width += 1
    put(eoi)
    if nacc:
        out.append(acc & 255)
    blocks = b"".join(bytes([len(out[i:i + 255])]) + out[i:i + 255] for i in range(0, len(out), 255))
    return bytes([bits]) + blocks + b"\x00"


def gif_file(size, global_palette, frames, loop=None) -> bytes:
    """A GIF89a: ``frames`` dicts of ``idx`` (h, w), ``at`` (x, y), and
    optionally ``palette`` (local, n x 3), ``transparency``, ``disposal``,
    ``duration`` (ms), ``interlace``, ``bits`` (LZW minimum code size),
    ``comment``."""
    import struct

    def table(p):
        n = max(2, 1 << int(np.ceil(np.log2(max(2, len(p))))))
        return n.bit_length() - 2, np.asarray(p, np.uint8).tobytes() + bytes(3 * (n - len(p)))

    gsize, gbytes = table(global_palette)
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", size[0], size[1], 128 | gsize, 0, 0) + gbytes)
    if loop is not None:
        out += b"!\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"
    for f in frames:
        if f.get("comment"):
            out += b"!\xfe" + bytes([len(f["comment"])]) + f["comment"] + b"\x00"
        tr = f.get("transparency")
        out += b"!\xf9\x04" + bytes([(f.get("disposal", 0) << 2) | (tr is not None)]) + \
            struct.pack("<H", f.get("duration", 0) // 10) + bytes([tr or 0, 0])
        idx = np.asarray(f["idx"], np.uint8)
        h, w = idx.shape
        flags = 64 if f.get("interlace") else 0
        local = b""
        if f.get("palette") is not None:
            lsize, local = table(f["palette"])
            flags |= 128 | lsize
        out += b"," + struct.pack("<HHHHB", f["at"][0], f["at"][1], w, h, flags) + local
        if f.get("interlace"):
            idx = idx[np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                      np.arange(2, h, 4), np.arange(1, h, 2)])]
        out += gif_lzw(idx, f.get("bits", 8))
    return bytes(out + b";")


def gif_truth(size, global_palette, frames) -> list:
    """Pillow's frames (BGR) of a ``gif_file`` whose first frame covers the
    screen without transparency: each later frame pasted over the one
    before but where it is transparent; disposal 2 paints the frame's
    extent with its transparent colour (else the background's) in its own
    palette, disposal 3 restores what was under it, both before the next."""
    w, h = size
    out, canvas, pending = [], None, None
    for k, f in enumerate(frames):
        pal = np.asarray(f["palette"] if f.get("palette") is not None else global_palette, np.uint8)
        full = np.zeros((256, 3), np.uint8)  # black past the palette
        full[:len(pal)] = pal
        x, y = f["at"]
        fh, fw = np.asarray(f["idx"]).shape
        if pending is not None:
            canvas[pending[1]:pending[1] + pending[2].shape[0],
                   pending[0]:pending[0] + pending[2].shape[1]] = pending[2]
            pending = None
        if canvas is None:
            canvas = np.zeros((h, w, 3), np.uint8)
        before = canvas[y:y + fh, x:x + fw].copy()
        tr = f.get("transparency")
        if f.get("disposal") == 2:
            pending = (x, y, np.broadcast_to(full[tr if tr is not None else 0], before.shape).copy())
        elif f.get("disposal") == 3:
            pending = (x, y, before)
        rgb = full[np.asarray(f["idx"], np.uint8)]
        keep = np.zeros((fh, fw), bool) if tr is None or k == 0 else np.asarray(f["idx"]) == tr
        canvas[y:y + fh, x:x + fw] = np.where(keep[..., None], before, rgb)
        out.append(np.ascontiguousarray(canvas[..., ::-1]))
    return out


def gif_cases(w: int, h: int, seed: int = 22) -> list:
    """(name, bytes, [BGR truth per frame], durations, loop) of phase 3w:
    hand-built files at each LZW minimum code size (local palettes,
    interlace, offsets, transparency, disposals 1, 2 and 3, a comment)."""
    rng = np.random.default_rng(seed)
    out = []
    for bits in GIF_CODE_SIZES:
        n = 1 << bits
        gp = rng.integers(0, 256, (n, 3))
        lp = rng.integers(0, 256, (n, 3))
        fw, fh, x, y = w // 2, h // 3, w // 5, h // 4
        frames = [
            dict(idx=rng.integers(0, n, (h, w)), at=(0, 0), duration=40, comment=b"3w"),
            dict(idx=rng.integers(0, n, (fh, fw)), at=(x, y), palette=lp, transparency=1,
                 disposal=2, interlace=True, duration=70, bits=bits),
            dict(idx=rng.integers(0, n, (fh + 5, fw - 7)), at=(x + 9, y + 3), transparency=0,
                 disposal=3, duration=100),
            dict(idx=rng.integers(0, n, (fh, fw)), at=(3, 2), palette=lp, disposal=1,
                 interlace=True),
        ]
        for f in frames:
            f["bits"] = bits
        data = gif_file((w, h), gp, frames, loop=bits)
        out.append((f"GIF, {n} colours, LZW code size {bits}", data,
                    gif_truth((w, h), gp, frames), [40, 70, 100, 0], bits))
    return out


def run_formats_8b(dev: str = "cuda", w: int = 641, h: int = 361) -> dict:
    """Phase 3w: TIFF and GIF on the card's machine, with no Pillow. Every
    file of :func:`tiff_cases` and :func:`gif_cases` read by ``imread`` and
    ``imreadmulti`` onto ``dev`` equals the CPU read and its numpy truth,
    page for page and frame for frame, and ``imcount`` counts them; the
    port's own TIFF and GIF writes of ``dev`` Mats (``imwritemulti``, the
    GIF's nearest-entry mapping on ``dev``) read back exactly (at most 256
    colours) or as the CPU writes them; cv2's nine multi-page and animation
    calls give the frame counts, durations and loops written. Returns the
    phase's launches (none expected)."""
    import tempfile

    import rustcv_tpu_torch.cv2 as cv2
    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.ops import kernels
    from rustcv_tpu_torch.prelude import Mat

    kernels.reset_launch_counts()
    tiffs, gifs = tiff_cases(w, h), gif_cases(w, h)
    pages = 0
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, data, truths) in enumerate([(n, d, t) for n, d, t in tiffs]
                                                 + [(n, d, t) for n, d, t, _, _ in gifs]):
            path = os.path.join(tmp, f"{i}.img")
            with open(path, "wb") as f:
                f.write(data)
            expect(imgcodecs.imcount(path) == len(truths), f"{name}: imcount {imgcodecs.imcount(path)}")
            on_dev = imgcodecs.imreadmulti(path, device=dev)
            cpu = [m.to_numpy() for m in imgcodecs.imreadmulti(path, device="cpu")]
            expect(len(on_dev) == len(cpu) == len(truths), f"{name}: {len(on_dev)} pages")
            for k, (m, c, t) in enumerate(zip(on_dev, cpu, truths)):
                expect(m.device().device.type == dev, f"{name} page {k}: on {m.device().device}")
                expect(np.array_equal(m.to_numpy(), c), f"{name} page {k}: the {dev} read differs")
                expect(c.shape == t.shape and np.array_equal(c, t),
                       f"{name} page {k}: the read differs from its numpy truth")
            expect(np.array_equal(imgcodecs.imread(path, device=dev).to_numpy(), truths[0]),
                   f"{name}: imread is not the first page")
            pages += len(truths)
        for name, data, truths, durations, loop in gifs:
            ok, anim = cv2.imdecodeanimation(np.frombuffer(data, np.uint8))
            expect(ok and anim.durations == durations and anim.loop_count == loop
                   and all(np.array_equal(a, t) for a, t in zip(anim.frames, truths)),
                   f"{name}: imdecodeanimation {anim.durations} loop {anim.loop_count}")
        print(f"formats 8b: {len(tiffs)} TIFF and {len(gifs)} GIF files ({pages} pages and frames) "
              f"read onto {dev} at {w}x{h} equal to the CPU read and to their numpy truths: "
              f"{', '.join(n for n, _, _ in tiffs)}; {', '.join(n for n, *_ in gifs)}", flush=True)

        rng = np.random.default_rng(8)
        pal = rng.integers(0, 256, (200, 3), np.uint8)
        few = [pal[rng.integers(0, 200, (h, w))] for _ in range(3)]
        few.insert(2, few[1].copy())  # equal to the frame before: merged
        many = [rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(2)]
        gray = [rng.integers(0, 256, (h, w), np.uint8) for _ in range(2)]
        for label, frames, exact in (("<= 256 colours", few, True), ("gray", gray, True),
                                     ("> 256 colours", many, False)):
            for ext in (".tiff", ".gif"):
                written = {}
                for side in (dev, "cpu"):
                    path = os.path.join(tmp, f"w_{side}{ext}")
                    mats = [Mat.from_array(f.copy(), device=side) for f in frames]
                    expect(imgcodecs.imwritemulti(path, mats), f"imwritemulti {label} {ext} on {side}")
                    with open(path, "rb") as f:
                        written[side] = f.read()
                back = [m.to_numpy() for m in imgcodecs.imreadmulti(path, device="cpu")]
                want = len(frames) - (1 if label == "<= 256 colours" and ext == ".gif" else 0)
                expect(len(back) == want, f"{label} {ext}: {len(back)} frames")
                expect(written[dev] == written["cpu"], f"{label} {ext}: the {dev} write differs")
                if exact or ext == ".tiff":
                    kept = [f for i, f in enumerate(frames) if not (ext == ".gif" and label ==
                                                                     "<= 256 colours" and i == 2)]
                    expect(all(np.array_equal(b, f if f.ndim == 3 else np.repeat(f[..., None], 3, 2))
                               for b, f in zip(back, kept)), f"{label} {ext}: not read back exactly")
        anim = cv2.Animation(5)
        anim.frames, anim.durations = few, [40, 80, 80, 160]
        for ext, frames_back, durs, loop in ((".gif", 3, [40, 160, 160], 5),
                                             (".tiff", 4, [100] * 4, 0)):
            ok, buf = cv2.imencodeanimation(ext, anim)
            got = cv2.imdecodeanimation(buf)[1]
            path = os.path.join(tmp, "a" + ext)
            expect(ok and cv2.imwriteanimation(path, anim), f"imencodeanimation {ext}")
            read = cv2.imreadanimation(path)[1]
            for a in (got, read):
                expect(len(a.frames) == frames_back and a.durations == durs and a.loop_count == loop,
                       f"{ext} animation: {len(a.frames)} frames {a.durations} loop {a.loop_count}")
            ok, buf = cv2.imencodemulti(ext, few)
            ok2, back = cv2.imdecodemulti(buf)
            expect(ok and ok2 and len(back) == frames_back, f"imencodemulti {ext}: {len(back)}")
            expect(cv2.imwritemulti(path, few) and cv2.imcount(path) == frames_back
                   and len(cv2.imreadmulti(path)[1]) == frames_back, f"imwritemulti {ext}")
        expect(cv2.imencodemulti(".png", few)[0] is False, "imencodemulti .png")
    print("formats 8b: imwritemulti of <= 256-colour, gray and > 256-colour frames from "
          f"{dev} Mats writes the CPU's bytes and reads back (exactly where <= 256 colours); "
          "cv2's nine multi-page and animation calls give the counts, durations and loops "
          "written", flush=True)
    counts = kernels.launch_counts()
    expect(not any(counts.values()), f"phase 3w launched kernels: {counts}")
    return counts


def time_formats_8b(smi: str, dev: str = "cuda") -> None:
    """Phase 4w: ms per call at 1920x1080 (CUDA events over MULTI_TIMED
    calls, the file in the page cache): ``imread`` onto the card of a raw,
    an LZW + predictor 2 and a Deflate RGB TIFF; ``imreadmulti`` of an
    8-page TIFF and an 8-frame GIF; ``imwritemulti`` of 8 frames of the
    test pattern (card Mats) to TIFF and to GIF (the GIF's nearest-entry
    mapping on the card)."""
    import tempfile

    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.capture.simulation import synth_bgr
    from rustcv_tpu_torch.prelude import Mat

    tag = f"[{smi}]"
    frames = [synth_bgr(W, H, t) for t in range(8)]
    rgb = np.ascontiguousarray(frames[0][..., ::-1])
    files = {
        "raw RGB TIFF": tiff_file([dict(samples=rgb, photo=2)]),
        "LZW + predictor 2 RGB TIFF": tiff_file([dict(samples=rgb, photo=2, comp=5, predictor=2,
                                                       rows=16)]),
        "Deflate RGB TIFF": tiff_file([dict(samples=rgb, photo=2, comp=8, rows=16)]),
    }
    mats = [Mat.from_array(f, device=dev) for f in frames]
    for m in mats:
        m.device()
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in files.items():
            path = os.path.join(tmp, "x.tiff")
            with open(path, "wb") as f:
                f.write(data)
            ms = cuda_ms(lambda: imgcodecs.imread(path, device=dev), MULTI_TIMED)
            print(f"{tag} imread of a {W}x{H} {name} ({len(data)} bytes) onto the card: {ms:.4f} ms",
                  flush=True)
        for ext in (".tiff", ".gif"):
            path = os.path.join(tmp, "m" + ext)
            ms = cuda_ms(lambda: imgcodecs.imwritemulti(path, mats), MULTI_TIMED)
            size = os.path.getsize(path)
            print(f"{tag} imwritemulti of 8 {W}x{H} test-pattern frames to {ext} ({size} bytes) "
                  f"from card Mats: {ms:.4f} ms", flush=True)
            ms = cuda_ms(lambda: imgcodecs.imreadmulti(path, device=dev), MULTI_TIMED)
            print(f"{tag} imreadmulti of that 8-frame {ext} onto the card: {ms:.4f} ms", flush=True)


# -- phases 3x and 4x: WebP reads (ROADMAP Queue 1 item 8c). The card's
# machine has no Pillow, so the phase reads the fixtures committed in
# tests/data/webp (tools/make_webp_data.py, written by libwebp 1.6's encoder
# where Pillow is) and holds every frame to the SHA-256 of the reference's
# read in their manifest.

WEBP_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "webp")


def run_formats_8c(dev: str = "cuda") -> dict:
    """Phase 3x: WebP on the card's machine, with no Pillow. Every fixture
    (lossy with each filter type, segments and partitions; lossless with
    each transform; alpha raw and VP8L under its filters; VP8X metadata;
    animations with sub-rectangle, blended and disposed frames; the 1080p
    files of phase 4x) read by ``imread`` and ``imreadmulti`` onto ``dev``
    equals the CPU read and the manifest's hash frame for frame;
    ``imcount``, cv2's ``imreadanimation`` durations and loop and
    ``imread_with_metadata`` equal the manifest's. Returns the phase's
    launches (none expected)."""
    import hashlib

    import rustcv_tpu_torch.cv2 as cv2
    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    with open(os.path.join(WEBP_DATA, "manifest.json")) as f:
        manifest = json.load(f)
    frames = 0
    for name, m in sorted(manifest.items()):
        path = os.path.join(WEBP_DATA, name)
        with open(path, "rb") as f:
            data = f.read()
        expect(hashlib.sha256(data).hexdigest() == m["sha256"], f"{name}: not the committed file")
        expect(imgcodecs.imcount(path) == m["n_frames"], f"{name}: imcount {imgcodecs.imcount(path)}")
        on_dev = imgcodecs.imreadmulti(path, device=dev)
        cpu = [x.to_numpy() for x in imgcodecs.imreadmulti(path, device="cpu")]
        expect(len(on_dev) == len(cpu) == m["n_frames"], f"{name}: {len(on_dev)} frames")
        for k, (x, c, digest) in enumerate(zip(on_dev, cpu, m["frames"])):
            expect(x.device().device.type == dev, f"{name} frame {k}: on {x.device().device}")
            expect(np.array_equal(x.to_numpy(), c), f"{name} frame {k}: the {dev} read differs")
            expect(list(c.shape) == m["shapes"][k]
                   and hashlib.sha256(np.ascontiguousarray(c).tobytes()).hexdigest() == digest,
                   f"{name} frame {k}: not the reference's read")
        expect(np.array_equal(imgcodecs.imread(path, device=dev).to_numpy(), cpu[0]),
               f"{name}: imread is not the first frame")
        meta = imgcodecs.imread_with_metadata(path, device=dev)[1]
        expect(meta == m["metadata"], f"{name}: metadata {meta}")
        ok, anim = cv2.imreadanimation(path)
        expect(ok and anim.durations == m["durations"] and anim.loop_count == m["loop"],
               f"{name}: imreadanimation {anim.durations} loop {anim.loop_count}")
        frames += len(cpu)
    print(f"formats 8c: {len(manifest)} WebP files ({frames} frames) read onto {dev} equal to the "
          f"CPU read and to the reference's hashes, with its counts, durations, loops and "
          f"metadata: {', '.join(sorted(manifest))}", flush=True)
    counts = kernels.launch_counts()
    expect(not any(counts.values()), f"phase 3x launched kernels: {counts}")
    return counts


def time_formats_8c(smi: str, dev: str = "cuda") -> None:
    """Phase 4x: ms per call (CUDA events over MULTI_TIMED calls, the file in
    the page cache): ``imread`` onto the card of the 1080p lossy q80 and
    lossless fixtures, ``imreadmulti`` of the 8-frame 640x360 animation, and
    the native decode alone (``native.vp8_decode`` / ``vp8l_decode`` of the
    image chunk into RGBA on the host)."""
    from rustcv_tpu_torch import imgcodecs, native
    from rustcv_tpu_torch.imgcodecs import webp

    tag = f"[{smi}]"
    for name, what in (("p1080_lossy_q80.webp", "lossy q80"), ("p1080_lossless.webp", "lossless")):
        path = os.path.join(WEBP_DATA, name)
        with open(path, "rb") as f:
            data = f.read()
        ms = cuda_ms(lambda: imgcodecs.imread(path, device=dev), MULTI_TIMED)
        print(f"{tag} imread of the 1920x1080 {what} WebP ({len(data)} bytes) onto the card: "
              f"{ms:.4f} ms", flush=True)
        w = webp.WebP(data)
        f0 = w.frames[0]
        body = w.data[f0.image[0] + 8:f0.image[0] + f0.image[1]]
        decode = (lambda: native.vp8l_decode(body)) if f0.lossless else \
            (lambda: native.vp8_decode(body))
        decode()
        t = time.perf_counter()
        for _ in range(MULTI_TIMED):
            decode()
        ms = (time.perf_counter() - t) * 1e3 / MULTI_TIMED
        print(f"{tag} the native {what} decode alone (host clock): {ms:.4f} ms", flush=True)
    path = os.path.join(WEBP_DATA, "anim8_640x360.webp")
    ms = cuda_ms(lambda: imgcodecs.imreadmulti(path, device=dev), MULTI_TIMED)
    print(f"{tag} imreadmulti of the 8-frame 640x360 lossy WebP ({os.path.getsize(path)} bytes) "
          f"onto the card: {ms:.4f} ms", flush=True)


# -- phases 3y and 4y: WebP writes (ROADMAP Queue 1 item 8c-ii). The card's
# machine has no Pillow: the reference's sizes and PSNRs of the same inputs
# are committed in tests/data/webp/write_refs.json
# (tools/make_webp_write_refs.py, written with Pillow and its libwebp).

WEBP_PSNR_SLACK_DB, WEBP_SIZE_RATIO = 0.5, 1.25  # the bars of tests/test_torch_webp_write.py
WEBP_TIMED = 3  # calls per timing at 1080p


def webp_psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR (dB) of two u8 images over all their channels (inf where equal)."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * float(np.log10(255.0 ** 2 / mse))


def webp_rgb(img: np.ndarray) -> np.ndarray:
    """An image as the reference hands Pillow (gray, RGB or RGBA) → the RGB
    that ``convert("RGB")`` of its WebP should give."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return img[..., :3]


def webp_write_inputs() -> dict:
    """Phase 3y's inputs, seeded and made with integer arithmetic only (so
    every numpy makes the same pixels), as the reference hands them to
    Pillow (RGB or RGBA): a 1080p still, a 641x361 still with alpha (holes
    and a soft edge) and 8 frames of 640x360 with moving boxes."""
    rng = np.random.default_rng(24)

    def scene(w: int, h: int) -> np.ndarray:
        y, x = np.mgrid[0:h, 0:w]
        img = np.stack([x * 255 // (w - 1), y * 255 // (h - 1),
                        (x // 40 + y // 40) % 2 * 150 + 60], -1)
        img[h // 3:h // 2, w // 4:w // 2] = (30, 200, 90)
        img = img + rng.integers(-12, 13, (h, w, 3)) * (x > w // 2)[..., None]
        return np.clip(img, 0, 255).astype(np.uint8)

    y, x = np.mgrid[0:361, 0:641]
    alpha = np.clip(255 - np.abs((x - 320) ** 2 + (y - 180) ** 2 - 150 ** 2) // 60, 0, 255)
    alpha[(x // 16) % 3 == 0] = 0
    base = scene(640, 360)
    frames = []
    for i in range(8):
        f = base.copy()
        f[40 + 12 * i:84 + 12 * i, 60 + 25 * i:120 + 25 * i] = (255, 40, 40)
        frames.append(f)
    return {"still_1920x1080_bgr": [scene(1920, 1080)],
            "still_641x361_bgra": [np.dstack([scene(641, 361), alpha.astype(np.uint8)])],
            "anim8_640x360_bgr": frames}


def run_formats_8c_writes(dev: str = "cuda") -> dict:
    """Phase 3y: WebP writes on the card's machine. Each input of
    ``webp_write_inputs`` written from Mats on ``dev`` (``imencode`` of the
    stills, ``imwritemulti`` of the animation; the planes are made on the
    card) and from host Mats: identical bytes. Each file read back by the
    port's reader meets the bars against the reference's file of the same
    frames (``tests/data/webp/write_refs.json``): the mode, frame count,
    durations and loop equal, per frame the PSNR of the RGB against the
    input at most 0.5 dB below the reference's, the size at most 1.25x, the
    alpha of the 4-channel still exact. Returns the phase's launches (none
    expected)."""
    import tempfile

    import torch

    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.imgcodecs import webp
    from rustcv_tpu_torch.ops import kernels
    from rustcv_tpu_torch.prelude import Mat

    kernels.reset_launch_counts()
    with open(os.path.join(WEBP_DATA, "write_refs.json")) as f:
        refs = json.load(f)
    inputs = webp_write_inputs()
    expect(sorted(refs) == sorted(inputs), f"write_refs.json holds {sorted(refs)}")
    with tempfile.TemporaryDirectory() as tmp:
        for name, frames in sorted(inputs.items()):
            ref = refs[name]
            arrays = [np.ascontiguousarray(f[..., ::-1]) for f in frames]  # the Mats' channels
            on_dev = [Mat.from_device(torch.from_numpy(a).to(dev)) for a in arrays]
            on_host = [Mat.from_array(a, device="cpu") for a in arrays]
            if len(frames) == 1:
                data = imgcodecs.imencode(".webp", on_dev[0])
                host = imgcodecs.imencode(".webp", on_host[0])
            else:
                path, hpath = os.path.join(tmp, "d.webp"), os.path.join(tmp, "h.webp")
                expect(imgcodecs.imwritemulti(path, on_dev) and
                       imgcodecs.imwritemulti(hpath, on_host), f"{name}: imwritemulti failed")
                with open(path, "rb") as f, open(hpath, "rb") as g:
                    data, host = f.read(), g.read()
            expect(data == host, f"{name}: the {dev} Mats and the host Mats give other bytes")
            w = webp.WebP(data)
            back = webp.decode_frames(w)
            mode = "RGBA" if w.has_alpha() else "RGB"
            got = {"mode": mode, "n_frames": len(w.frames),
                   "durations": [f.duration for f in w.frames], "loop": w.loop}
            want = {k: ref[k] for k in got}
            expect(got == want, f"{name}: {got}, the reference's {want}")
            psnrs = [webp_psnr(b[..., :3], webp_rgb(f)) for b, f in zip(back, frames)]
            for k, (p, q) in enumerate(zip(psnrs, ref["psnr"])):
                expect(p >= q - WEBP_PSNR_SLACK_DB,
                       f"{name} frame {k}: PSNR {p:.3f} dB, the reference's {q:.3f}")
            expect(len(data) <= WEBP_SIZE_RATIO * ref["bytes"],
                   f"{name}: {len(data)} bytes, the reference's {ref['bytes']}")
            if frames[0].shape[-1] == 4:
                expect(np.array_equal(back[0][..., 3], frames[0][..., 3]),
                       f"{name}: the alpha read back is not the input's")
            print(f"formats 8c writes: {name} from {dev} and host Mats, the same {len(data)} "
                  f"bytes ({len(data) / ref['bytes']:.3f}x the reference's), {mode}, "
                  f"{len(w.frames)} frame(s), PSNR " + ", ".join(
                      f"{p:.3f} ({q:.3f})" for p, q in zip(psnrs, ref["psnr"])) +
                  " dB (the reference's)", flush=True)
    counts = kernels.launch_counts()
    expect(not any(counts.values()), f"phase 3y launched kernels: {counts}")
    return counts


def time_formats_8c_writes(smi: str, dev: str = "cuda") -> None:
    """Phase 4y: ms per call at 1080p: the RGB → YUV import on the card
    (CUDA events), the download of its planes, the native VP8 encode (the
    host clock), ``imwrite`` whole of a card Mat, and ``imwritemulti`` of
    phase 3y's 8-frame 640x360 animation from card Mats (CUDA events)."""
    import tempfile

    import torch

    from rustcv_tpu_torch import imgcodecs, native
    from rustcv_tpu_torch.imgcodecs.webp_yuv import import_yuva
    from rustcv_tpu_torch.prelude import Mat

    tag = f"[{smi}]"
    inputs = webp_write_inputs()
    rgb = torch.from_numpy(inputs["still_1920x1080_bgr"][0]).to(dev)
    ms = cuda_ms(lambda: import_yuva(rgb), WEBP_TIMED)
    print(f"{tag} the 1920x1080 RGB -> YUV 4:2:0 import on the card: {ms:.4f} ms", flush=True)
    planes = import_yuva(rgb)
    ms = cuda_ms(lambda: [p.cpu() for p in planes], WEBP_TIMED)
    print(f"{tag} the download of its planes ({sum(p.numel() for p in planes)} bytes): "
          f"{ms:.4f} ms", flush=True)
    y, u, v = (p.cpu().numpy() for p in planes)
    native.vp8_encode(y, u, v)
    t = time.perf_counter()
    for _ in range(WEBP_TIMED):
        data = native.vp8_encode(y, u, v)
    ms = (time.perf_counter() - t) * 1e3 / WEBP_TIMED
    print(f"{tag} the native VP8 encode of those planes ({len(data)} bytes, host clock): "
          f"{ms:.4f} ms", flush=True)
    mat = Mat.from_device(torch.from_numpy(
        np.ascontiguousarray(inputs["still_1920x1080_bgr"][0][..., ::-1])).to(dev))
    mats = [Mat.from_device(torch.from_numpy(np.ascontiguousarray(f[..., ::-1])).to(dev))
            for f in inputs["anim8_640x360_bgr"]]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "x.webp")
        ms = cuda_ms(lambda: imgcodecs.imwrite(path, mat), WEBP_TIMED)
        print(f"{tag} imwrite of the 1920x1080 still to .webp ({os.path.getsize(path)} bytes) "
              f"from a card Mat: {ms:.4f} ms", flush=True)
        ms = cuda_ms(lambda: imgcodecs.imwritemulti(path, mats), WEBP_TIMED)
        print(f"{tag} imwritemulti of the 8-frame 640x360 animation to .webp "
              f"({os.path.getsize(path)} bytes) from card Mats: {ms:.4f} ms", flush=True)


# -- phases 3z and 4z: animated PNG both ways and the GIF writer's median cut
# (ROADMAP Queue 1 item 8d-i). The card's machine has no Pillow: the
# reference's reads and writes of the fixtures are committed in
# tests/data/apng/manifest.json (tools/make_apng_data.py), Pillow's palettes
# and index maps of quant_frames() in tests/data/gif/quant_refs.json
# (tools/make_quant_refs.py).

APNG_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "apng")
QUANT_REFS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "gif",
                          "quant_refs.json")


def apng_timing_frames() -> list:
    """Phase 4z's animation (``tests/data/apng/anim8_1920x1080.png``): 8 RGB
    frames of 1920x1080, integer gradients with a box moving across them."""
    y, x = np.mgrid[0:1080, 0:1920]
    base = np.stack([x * 255 // 1919, y * 255 // 1079, (x + y) * 255 // 2997], -1).astype(np.uint8)
    frames = []
    for i in range(8):
        f = base.copy()
        f[200 + 40 * i:360 + 40 * i, 100 + 200 * i:400 + 200 * i] = (230, 40, 40)
        frames.append(f)
    return frames


def quant_frames() -> dict:
    """The GIF quantizer's frames (RGB), seeded and made with
    ``np.random.default_rng(seed).integers`` and integer arithmetic only: a
    noisy gradient, 641x361 of thousands of colours, 160x120 of exactly 256 and a
    1080p noise frame of more than 65,536 (the coarse hash)."""
    out = {}
    rng = np.random.default_rng(251)
    y, x = np.mgrid[0:96, 0:128]
    g = np.stack([x * 2, y * 2, x + y], -1) + rng.integers(-6, 7, (96, 128, 3))
    out["gradient_noise_128x96"] = np.clip(g, 0, 255).astype(np.uint8)
    rng = np.random.default_rng(252)
    pal = rng.integers(0, 256, (5000, 3)).astype(np.uint8)
    out["many_colours_641x361"] = pal[rng.integers(0, 5000, (361, 641))]
    rng = np.random.default_rng(253)
    packed = rng.integers(0, 1 << 24, 256)
    pal = np.stack([packed >> 16, (packed >> 8) & 255, packed & 255], 1).astype(np.uint8)
    idx = rng.integers(0, 256, (120, 160))
    idx.reshape(-1)[:256] = np.arange(256)
    out["colours_256_160x120"] = pal[idx]
    rng = np.random.default_rng(254)
    out["noise_1920x1080"] = rng.integers(0, 256, (1080, 1920, 3)).astype(np.uint8)
    return out


def _sha(a) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def apng_controls(data: bytes) -> dict:
    """acTL and every fcTL of PNG bytes, the fcTL without its sequence
    number (what ``tests/data/apng/manifest.json`` holds of a write)."""
    import struct

    out, p = {"actl": None, "fctl": []}, 8
    while p < len(data):
        n, kind = struct.unpack(">I4s", data[p:p + 8])
        body = data[p + 8:p + 8 + n]
        if kind == b"acTL":
            out["actl"] = list(struct.unpack(">II", body))
        elif kind == b"fcTL":
            out["fctl"].append(list(struct.unpack(">IIIIIHHBB", body)[1:]))
        p += 12 + n
    return out


def run_formats_8d(dev: str = "cuda") -> dict:
    """Phase 3z: animated PNG and the median cut on the card's machine.
    Every ``tests/data/apng`` fixture read by ``imreadmulti``, ``imread``,
    ``imcount``, ``imread_with_metadata`` and cv2's ``imreadanimation``
    onto ``dev`` equals the CPU read and the manifest's hashes, counts,
    durations, loop and metadata; its frames written from ``dev`` Mats by
    ``imwritemulti`` and by ``imgcodecs.encode_frames("png", durations,
    loop)`` (``imwriteanimation``'s write) give the host Mats' bytes, the
    reference's acTL and fcTL fields, and read back to the reference's
    frames. Each ``quant_frames`` frame quantized on ``dev`` gives
    Pillow's palette and index map (``quant_refs.json``) and the CPU's.
    Returns the phase's launches (none expected)."""
    import tempfile

    import torch

    import rustcv_tpu_torch.cv2 as cv2
    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.core.errors import CameraError
    from rustcv_tpu_torch.imgcodecs import quantize
    from rustcv_tpu_torch.ops import kernels
    from rustcv_tpu_torch.prelude import Mat

    kernels.reset_launch_counts()
    with open(os.path.join(APNG_DATA, "manifest.json")) as f:
        manifest = json.load(f)
    expect(sorted(manifest) == sorted(n for n in os.listdir(APNG_DATA) if n.endswith(".png")),
           f"manifest.json holds {sorted(manifest)}")
    frames = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, m in sorted(manifest.items()):
            path = os.path.join(APNG_DATA, name)
            expect(imgcodecs.imcount(path) == m["n_frames"], f"{name}: imcount {imgcodecs.imcount(path)}")
            ok, anim = cv2.imreadanimation(path)
            expect(ok == (m["read_error"] is None) and anim.durations == m["durations"]
                   and anim.loop_count == m["loop"],
                   f"{name}: imreadanimation {ok} {anim.durations} loop {anim.loop_count}")
            if m["read_error"] is None:
                on_dev = imgcodecs.imreadmulti(path, device=dev)
                cpu = [x.to_numpy() for x in imgcodecs.imreadmulti(path, device="cpu")]
            else:  # the reference's read stops with an error: imreadmulti raises, as it does
                try:
                    imgcodecs.imreadmulti(path, device="cpu")
                    expect(False, f"{name}: imreadmulti read past the reference's {m['read_error']}")
                except CameraError:
                    pass
                cpu = anim.frames
                on_dev = [imgcodecs.imread(path, device=dev)][:len(cpu)]
            expect(len(on_dev) == len(cpu) == len(m["sha256"]), f"{name}: {len(on_dev)} frames")
            for k, (x, c) in enumerate(zip(on_dev, cpu)):
                expect(x.device().device.type == dev, f"{name} frame {k}: on {x.device().device}")
                expect(np.array_equal(x.to_numpy(), c), f"{name} frame {k}: the {dev} read differs")
                expect(list(c.shape) == m["shape"] and _sha(c) == m["sha256"][k],
                       f"{name} frame {k}: not the reference's read")
            expect(np.array_equal(imgcodecs.imread(path, device=dev).to_numpy(), cpu[0]),
                   f"{name}: imread is not the first frame")
            meta = imgcodecs.imread_with_metadata(path, device=dev)[1]
            expect(meta == m["metadata"], f"{name}: metadata {meta}")
            frames += len(cpu)
            mats = {side: [Mat.from_device(torch.from_numpy(c).to(side)) for c in cpu]
                    for side in (dev, "cpu")}
            for how in ("writemulti", "writeanimation"):
                written = {}
                for side, ms in mats.items():
                    p = os.path.join(tmp, f"{how}_{side}.png")
                    if how == "writemulti":
                        expect(imgcodecs.imwritemulti(p, ms), f"{name}: imwritemulti from {side}")
                    else:
                        with open(p, "wb") as f:
                            f.write(imgcodecs.encode_frames("png", ms, duration=m["durations"],
                                                            loop=m["loop"]))
                    with open(p, "rb") as f:
                        written[side] = f.read()
                expect(written[dev] == written["cpu"], f"{name} {how}: the {dev} write differs")
                got = apng_controls(written[dev])
                want = {k: m[how][k] for k in ("actl", "fctl")}
                expect(got == want, f"{name} {how}: controls {got}, the reference's {want}")
                back = [x.to_numpy() for x in imgcodecs.imreadmulti(
                    os.path.join(tmp, f"{how}_{dev}.png"), device="cpu")]
                expect([_sha(b) for b in back] == m[how]["sha256"],
                       f"{name} {how}: the frames read back are not the reference's")
    print(f"formats 8d: {len(manifest)} animated PNG files ({frames} frames) read onto {dev} "
          f"equal to the CPU read and to the reference's hashes, counts, durations, loops and "
          f"metadata, and written from {dev} Mats with the reference's acTL and fcTL fields: "
          f"{', '.join(sorted(manifest))}", flush=True)
    with open(QUANT_REFS) as f:
        refs = json.load(f)
    qf = quant_frames()
    expect(sorted(refs) == sorted(qf), f"quant_refs.json holds {sorted(refs)}")
    for name, img in sorted(qf.items()):
        idx, pal = quantize.quantize(torch.from_numpy(img).to(dev))
        cidx, cpal = quantize.quantize(img)
        expect(np.array_equal(idx, cidx) and np.array_equal(pal, cpal),
               f"quantize {name}: the {dev} run differs from the CPU's")
        got = {"entries": len(pal), "palette_sha256": _sha(pal), "index_sha256": _sha(idx)}
        want = {k: refs[name][k] for k in got}
        expect(got == want, f"quantize {name}: {got}, Pillow's {want}")
        print(f"formats 8d: quantize {name} on {dev}: Pillow's {len(pal)}-entry palette and "
              f"index map, the CPU's", flush=True)
    counts = kernels.launch_counts()
    expect(not any(counts.values()), f"phase 3z launched kernels: {counts}")
    return counts


def time_formats_8d(smi: str, dev: str = "cuda") -> None:
    """Phase 4z: ms per call at 1080p (CUDA events over MULTI_TIMED calls,
    the file in the page cache): ``imread`` and ``imreadmulti`` onto the card
    of the 8-frame 1920x1080 APNG fixture, ``imwritemulti`` of its frames
    from card Mats to .png, the GIF write of the first frame from a card Mat
    (``imencode``: Pillow's median cut, the mapping on the card) and the
    quantizer alone on the 1080p noise frame on the card."""
    import tempfile

    import torch

    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.imgcodecs import quantize
    from rustcv_tpu_torch.prelude import Mat

    tag = f"[{smi}]"
    path = os.path.join(APNG_DATA, "anim8_1920x1080.png")
    size = os.path.getsize(path)
    ms = cuda_ms(lambda: imgcodecs.imread(path, device=dev), MULTI_TIMED)
    print(f"{tag} imread of the 8-frame 1920x1080 APNG ({size} bytes) onto the card: {ms:.4f} ms",
          flush=True)
    ms = cuda_ms(lambda: imgcodecs.imreadmulti(path, device=dev), MULTI_TIMED)
    print(f"{tag} imreadmulti of that APNG onto the card: {ms:.4f} ms", flush=True)
    mats = imgcodecs.imreadmulti(path, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "m.png")
        ms = cuda_ms(lambda: imgcodecs.imwritemulti(out, mats), MULTI_TIMED)
        print(f"{tag} imwritemulti of its 8 frames to .png ({os.path.getsize(out)} bytes) from "
              f"card Mats: {ms:.4f} ms", flush=True)
    ms = cuda_ms(lambda: imgcodecs.imencode(".gif", mats[0]), MULTI_TIMED)
    print(f"{tag} imencode of its first frame to .gif from a card Mat (Pillow's median cut): "
          f"{ms:.4f} ms", flush=True)
    noise = torch.from_numpy(quant_frames()["noise_1920x1080"]).to(dev)
    ms = cuda_ms(lambda: quantize.quantize(noise), MULTI_TIMED)
    print(f"{tag} quantize of the 1920x1080 noise frame (the coarse hash) on the card: "
          f"{ms:.4f} ms", flush=True)
    frames = [Mat.from_device(torch.from_numpy(np.ascontiguousarray(f[..., ::-1])).to(dev))
              for f in apng_timing_frames()]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "m.gif")
        ms = cuda_ms(lambda: imgcodecs.imwritemulti(out, frames), MULTI_TIMED)
        print(f"{tag} imwritemulti of those 8 frames to .gif ({os.path.getsize(out)} bytes) from "
              f"card Mats: {ms:.4f} ms", flush=True)


# -- phases 3za and 4za: PNG and animated PNG written with Pillow's row filters
# (ROADMAP Queue 1 item 8d-ii-a). The card's machine has no Pillow: what
# Pillow writes of png_write_frames()'s cases is committed in
# tests/data/png/write_refs.json (tools/make_png_write_refs.py).

PNG_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "png")
PNG_SIZE_RATIO = 1.02  # the largest size of the port's file over Pillow's
PNG_TIMED = 3  # calls per timing at 1080p


def png_gradient(seed: int, w: int = 1920, h: int = 1080) -> np.ndarray:
    """An RGB gradient (h, w, 3) u8 with every fifth row seeded noise."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    (x + y) * 255 // max(w + h - 2, 1)], -1).astype(np.uint8)
    img[::5] = np.random.default_rng(seed).integers(0, 256, img[::5].shape, np.uint8)
    return img


def _png_moving(rng, shape, n: int, top: int = 256, dtype=np.uint8) -> list:
    """``n`` frames of ``shape``: one seeded noise frame, a box of new noise
    moving across it, the last frame equal to the one before."""
    base = rng.integers(0, top, shape).astype(dtype)
    out = []
    for i in range(n - 1):
        f = base.copy()
        box = f[2 + 3 * i:9 + 3 * i, 4 + 5 * i:14 + 5 * i]
        box[...] = rng.integers(0, top, box.shape)
        out.append(f)
    return out + [out[-1].copy()]


def png_write_frames() -> dict:
    """Phase 3za's cases, {name: (frames, Pillow's save arguments, or None
    for a still PNG)}: the frames as the reference hands them to
    ``Image.fromarray`` (RGB order; u8 with 1-4 channels, bool, u16), made
    from ``np.random.default_rng(seed)`` and integer arithmetic. The 1080p
    gradient with noise rows in every still mode; rows where Pillow's
    scores tie (Sub and Up, all four, Up and Paeth); small odd widths;
    animations of LA, I;16 and 1 frames, of mixed modes (the sets whose
    written mode Pillow fixes: with an RGB or RGBA frame), of mixed sizes
    (a frame merged, a frame smaller than the one before) and phase 4z's 8
    frames of 1080p."""
    g = png_gradient(261)
    gray = np.ascontiguousarray(g[..., 1])
    y, x = np.mgrid[0:1080, 0:1920]
    alpha = ((x * 7 + y * 3) % 256).astype(np.uint8)
    out = {
        "still_rgb_1920x1080": ([g], None),
        "still_rgba_1920x1080": ([np.dstack([g, alpha])], None),
        "still_l_1920x1080": ([gray], None),
        "still_la_1920x1080": ([np.dstack([gray, alpha])], None),
        "still_1_1920x1080": ([gray > 127], None),
        "still_i16_1920x1080": ([gray.astype(np.uint16) * 256 + g[..., 0]], None),
        "tie_sub_up_5x2": ([np.array([[0, 4, 4, 1, 0], [1, 2, 5, 5, 1]], np.uint8)], None),
        "tie_all_four_3x2": ([np.array([[3, 0, 3], [0, 0, 5]], np.uint8)], None),
        "tie_up_paeth_2x2": ([np.array([[5, 0], [3, 0]], np.uint8)], None),
    }
    rng = np.random.default_rng(262)
    out["odd_rgb_13x7"] = ([rng.integers(0, 256, (7, 13, 3)).astype(np.uint8)], None)
    out["odd_la_3x5"] = ([rng.integers(0, 256, (5, 3, 2)).astype(np.uint8)], None)
    out["odd_1_9x4"] = ([rng.integers(0, 2, (4, 9)).astype(bool)], None)
    out["odd_i16_7x3"] = ([rng.integers(0, 65536, (3, 7)).astype(np.uint16)], None)
    out["odd_l_1x1"] = ([rng.integers(0, 256, (1, 1)).astype(np.uint8)], None)
    rng = np.random.default_rng(263)
    la = _png_moving(rng, (45, 61, 2), 4)
    out["apng_la"] = (la, {"duration": [40, 60, 80, 100], "loop": 2})
    # I;16 frames compare in RGBA clipped to 255: samples to 511, so some boxes show
    out["apng_i16"] = (_png_moving(rng, (45, 61), 4, 512, np.uint16), {"duration": 50})
    out["apng_1"] = ([f > 127 for f in _png_moving(rng, (45, 61), 3)], {})
    rgb, rgba = _png_moving(rng, (45, 61, 3), 3), _png_moving(rng, (45, 61, 4), 3)
    out["apng_l_rgb"] = ([rgb[0][..., 1].copy(), rgb[1], rgb[2][..., 0].copy()], {"duration": 30})
    i16 = rng.integers(0, 65536, (45, 61)).astype(np.uint16)
    out["apng_la_rgba_i16"] = ([la[0], rgba[1], i16], {"loop": 1})
    out["apng_1_rgb"] = ([rgb[0][..., 0] > 127, rgb[1]], {})
    big = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    out["apng_sizes"] = ([rgb[0], big[:30, :40].copy(), big], {})
    out["apng_sizes_merged"] = ([big[:30, :40].copy(), big, rgb[1]], {"duration": [20, 30, 40]})
    out["apng_rgb_8x1920x1080"] = (apng_timing_frames(), {})
    return out


def png_summary(data: bytes) -> dict:
    """What ``write_refs.json`` holds of a PNG file: its size, the kinds of
    its chunks in order, IHDR, acTL and every fcTL and fdAT (with their
    sequence numbers), and the SHA-256 of each frame's image data before
    zlib (each run of IDAT or fdAT chunks, inflated)."""
    import hashlib
    import struct
    import zlib

    kinds, controls, runs, p = [], [], [], 8
    while p < len(data):
        n, kind = struct.unpack(">I4s", data[p:p + 8])
        body = data[p + 8:p + 8 + n]
        if kind in (b"IDAT", b"fdAT"):
            if not kinds or kinds[-1] not in ("IDAT", "fdAT"):
                runs.append([])
            runs[-1].append(body if kind == b"IDAT" else body[4:])
        fields = {b"IHDR": ">IIBBBBB", b"acTL": ">II", b"fcTL": ">IIIIIHHBB", b"fdAT": ">I"}
        if kind in fields:
            fmt = fields[kind]
            controls.append([kind.decode()] + list(struct.unpack(fmt, body[:struct.calcsize(fmt)])))
        kinds.append(kind.decode())
        p += 12 + n
    return {"bytes": len(data), "chunks": kinds, "controls": controls,
            "frames_sha256": [hashlib.sha256(zlib.decompress(b"".join(r))).hexdigest()
                              for r in runs]}


def png_write(frames, kw) -> bytes:
    """The port's write of a case: a still PNG (``kw`` None) or an animation."""
    from rustcv_tpu_torch.imgcodecs import apng, host

    return host.write_png(frames[0]) if kw is None else apng.write_apng(frames, **kw)


def png_mat_write(frames, kw, dev: str) -> bytes:
    """The same case through the facade from Mats on ``dev`` (u8 frames only:
    BGR order, as the reference's Mats): ``imencode(".png")`` of a still,
    ``encode_frames("png", ...)`` (``imwriteanimation``'s write) of an
    animation."""
    import torch

    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.prelude import Mat

    mats = [Mat.from_device(torch.from_numpy(np.ascontiguousarray(
        f[..., ::-1] if f.ndim == 3 else f)).to(dev)) for f in frames]
    if kw is None:
        return imgcodecs.imencode(".png", mats[0])
    return imgcodecs.encode_frames("png", mats, duration=kw.get("duration"), loop=kw.get("loop"))


def run_formats_8d_writes(dev: str = "cuda") -> dict:
    """Phase 3za: PNG and animated PNG writes with Pillow's row filters on
    the card's machine. Each ``png_write_frames`` case written from tensors
    on ``dev`` (the filters run there) equals its write from numpy on the
    CPU byte for byte, and so do its u8 cases written from Mats on ``dev``
    and on the CPU; the file has Pillow's chunks in Pillow's order, its
    IHDR, acTL, fcTL and fdAT fields (sequence numbers too), each frame's
    image data before zlib byte for byte (``write_refs.json``'s hashes),
    and at most ``PNG_SIZE_RATIO`` times Pillow's size. Returns the
    phase's launches (none expected)."""
    import torch

    from rustcv_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    with open(os.path.join(PNG_DATA, "write_refs.json")) as f:
        refs = json.load(f)
    cases = png_write_frames()
    expect(sorted(refs) == sorted(cases), f"write_refs.json holds {sorted(refs)}")
    for name, (frames, kw) in sorted(cases.items()):
        ref = refs[name]
        host = png_write(frames, kw)
        card = png_write([torch.from_numpy(f).to(dev) for f in frames], kw)
        expect(card == host, f"{name}: the {dev} tensors give other bytes than the CPU's")
        how = "tensors"
        if all(f.dtype == np.uint8 for f in frames):
            expect(png_mat_write(frames, kw, dev) == host == png_mat_write(frames, kw, "cpu"),
                   f"{name}: the {dev} and CPU Mats give other bytes than the arrays")
            how = "tensors and Mats"
        got = png_summary(card)
        for key in ("chunks", "controls", "frames_sha256"):
            expect(got[key] == ref[key], f"{name}: {key} {got[key]}, Pillow's {ref[key]}")
        expect(got["bytes"] <= PNG_SIZE_RATIO * ref["bytes"],
               f"{name}: {got['bytes']} bytes, Pillow's {ref['bytes']}")
        print(f"formats 8d-ii-a: {name} from {dev} {how}: the CPU's bytes, Pillow's chunks, "
              f"controls and image data of {len(got['frames_sha256'])} frame(s); "
              f"{got['bytes']} bytes, Pillow's {ref['bytes']} "
              f"({got['bytes'] / ref['bytes']:.4f}x)", flush=True)
    counts = kernels.launch_counts()
    expect(not any(counts.values()), f"phase 3za launched kernels: {counts}")
    return counts


def time_formats_8d_writes(smi: str, dev: str = "cuda") -> None:
    """Phase 4za: ms per call at 1080p: ``imencode(".png")`` of a card Mat
    of the 1080p gradient with noise rows, whole (CUDA events) and split into
    the row filters on the card (CUDA events), the download of the filtered
    rows (CUDA events) and zlib (the host clock); ``imwrite_with_metadata``
    of that Mat; phase 4z's ``imwritemulti`` of the 8-frame 1920x1080 APNG's
    frames from card Mats, its size at most ``PNG_SIZE_RATIO`` times the
    fixture's (Pillow's) size. Each size beside Pillow's."""
    import tempfile

    import torch

    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.imgcodecs import host
    from rustcv_tpu_torch.imgcodecs.png_filter import filter_rows
    from rustcv_tpu_torch.prelude import Mat

    tag = f"[{smi}]"
    with open(os.path.join(PNG_DATA, "write_refs.json")) as f:
        pillow = json.load(f)["still_rgb_1920x1080"]["bytes"]
    g = png_write_frames()["still_rgb_1920x1080"][0][0]
    rgb = torch.from_numpy(g).to(dev)
    mat = Mat.from_device(torch.from_numpy(np.ascontiguousarray(g[..., ::-1])).to(dev))
    ms = cuda_ms(lambda: imgcodecs.imencode(".png", mat), PNG_TIMED)
    size = len(imgcodecs.imencode(".png", mat))
    print(f"{tag} imencode of the 1920x1080 gradient with noise rows to .png ({size} bytes, "
          f"Pillow's {pillow}) from a card Mat: {ms:.4f} ms", flush=True)
    ms = cuda_ms(lambda: filter_rows(rgb, 8), PNG_TIMED)
    print(f"{tag}   of which the row filters on the card: {ms:.4f} ms", flush=True)
    rows = filter_rows(rgb, 8)
    ms = cuda_ms(lambda: rows.cpu(), PNG_TIMED)
    print(f"{tag}   the download of the filtered rows ({rows.numel()} bytes): {ms:.4f} ms",
          flush=True)
    raw = rows.cpu().numpy().tobytes()
    host.deflate(raw)
    t = time.perf_counter()
    for _ in range(PNG_TIMED):
        host.deflate(raw)
    ms = (time.perf_counter() - t) * 1e3 / PNG_TIMED
    print(f"{tag}   zlib of them (host clock): {ms:.4f} ms", flush=True)
    fixture = os.path.join(APNG_DATA, "anim8_1920x1080.png")
    mats = imgcodecs.imreadmulti(fixture, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "m.png")
        ms = cuda_ms(lambda: imgcodecs.imwrite_with_metadata(out, mat, {"Title": "4za"}),
                     PNG_TIMED)
        print(f"{tag} imwrite_with_metadata of that Mat to .png ({os.path.getsize(out)} bytes): "
              f"{ms:.4f} ms", flush=True)
        ms = cuda_ms(lambda: imgcodecs.imwritemulti(out, mats), PNG_TIMED)
        size, want = os.path.getsize(out), os.path.getsize(fixture)
        print(f"{tag} imwritemulti of the 8-frame 1920x1080 APNG's frames to .png ({size} bytes, "
              f"Pillow's {want}, {size / want:.4f}x) from card Mats: {ms:.4f} ms", flush=True)
        expect(size <= PNG_SIZE_RATIO * want, f"the 8-frame APNG is {size} bytes, Pillow's {want}")


# -- phases 3zb and 4zb: the JPEG forms of ROADMAP Queue 1 item 8d-ii-b. The
# card's machine has no Pillow and no libjpeg, so the phase reads the
# fixtures committed in tests/data/jpeg (tools/make_jpeg_data.py, written by
# Pillow and libjpeg where they are) and holds each read to the reference's
# answers in their manifest.

JPEG_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "jpeg")
JPEG_FORMS_1080 = (("p1080_baseline_420.jpg", "baseline 4:2:0"), ("p1080_cmyk.jpg", "CMYK"),
                   ("p1080_ycck.jpg", "YCCK 4:2:0"),
                   ("p1080_smoothed.jpg", "progressive 4:2:0, refinements cut (smoothed)"),
                   ("p1080_lossless.jpg", "lossless RGB, predictor 4"),
                   ("p1080_arith_seq.jpg", "arithmetic sequential 4:2:0"),
                   ("p1080_arith_prog.jpg", "arithmetic progressive 4:2:0"))


def _outcome(fn) -> str:
    """"read", or the class name of what ``fn`` raises."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is the answer
        return type(e).__name__
    return "read"


def run_formats_8d_ii_b(dev: str = "cuda") -> dict:
    """Phase 3zb: the JPEG forms on the card's machine, with no Pillow.
    Every fixture (CMYK and YCCK, smoothed and unsmoothed progressive
    streams, lossless, arithmetic-coded, the forms that stay refused) read
    by ``imread`` and ``imdecode`` onto ``dev`` equals the CPU read and the
    manifest's hash, or raises the reference's error class;
    ``decode_mjpeg_host_rgb`` and ``decode_mjpeg_into_mat`` answer as the
    manifest says (``decode_mjpeg_into_mat`` reads a lossless frame of one
    or three components, which the reference's libjpeg-turbo 2.1 binding
    refuses: a deviation in the port map); ``imread_with_metadata`` gives
    the manifest's dict. Returns the phase's launches (none expected)."""
    import hashlib

    from rustcv_tpu_torch import imgcodecs, native
    from rustcv_tpu_torch.core.mat import Mat
    from rustcv_tpu_torch.ops import decode, kernels

    kernels.reset_launch_counts()
    with open(os.path.join(JPEG_DATA, "manifest.json")) as f:
        manifest = json.load(f)
    forms: dict = {}
    for name, m in sorted(manifest.items()):
        path = os.path.join(JPEG_DATA, name)
        with open(path, "rb") as f:
            data = f.read()
        expect(hashlib.sha256(data).hexdigest() == m["sha256"], f"{name}: not the committed file")
        read = m["entry"]["imread"]
        for what, call in (("imread", lambda: imgcodecs.imread(path, device=dev)),
                           ("imdecode", lambda: imgcodecs.imdecode(data, device=dev))):
            got = _outcome(call)
            expect(got == read, f"{name}: {what} answers {got}, the reference {read}")
        expect(_outcome(lambda: decode.decode_mjpeg_host_rgb(data))
               == m["entry"]["decode_mjpeg_host_rgb"], f"{name}: decode_mjpeg_host_rgb")
        into = m["entry"]["decode_mjpeg_into_mat"]
        if m["form"] == "lossless" and read == "read" and native.jpeg_header(data)[2] != 4:
            into = "read"  # the deviation: the reference's libjpeg-turbo 2.1 has no SOF3
        expect(_outcome(lambda: decode.decode_mjpeg_into_mat(data, Mat(device="cpu"))) == into,
               f"{name}: decode_mjpeg_into_mat")
        if read != "read":
            forms.setdefault(m["form"], []).append(name)
            continue
        cpu = imgcodecs.imread(path, device="cpu").to_numpy()
        expect(list(cpu.shape) == m["shape"]
               and hashlib.sha256(np.ascontiguousarray(cpu).tobytes()).hexdigest()
               == m["bgr_sha256"], f"{name}: not the reference's read")
        for what, mat in (("imread", imgcodecs.imread(path, device=dev)),
                          ("imdecode", imgcodecs.imdecode(data, device=dev))):
            expect(mat.device().device.type == dev, f"{name}: {what} on {mat.device().device}")
            expect(np.array_equal(mat.to_numpy(), cpu), f"{name}: the {dev} {what} differs")
        mat, meta = imgcodecs.imread_with_metadata(path, device=dev)
        expect(meta == m["metadata"] and np.array_equal(mat.to_numpy(), cpu),
               f"{name}: imread_with_metadata {meta}")
        rgb = decode.decode_mjpeg_host_rgb(data)
        expect(np.array_equal(rgb, cpu[..., ::-1]), f"{name}: decode_mjpeg_host_rgb differs")
        forms.setdefault(m["form"], []).append(name)
    print(f"formats 8d-ii-b: {len(manifest)} JPEG files read onto {dev} as the reference "
          f"answers (its hashes, error classes and metadata), by form: "
          f"{ {k: len(v) for k, v in sorted(forms.items())} }", flush=True)
    counts = kernels.launch_counts()
    expect(not any(counts.values()), f"phase 3zb launched kernels: {counts}")
    return counts


def time_formats_8d_ii_b(smi: str, dev: str = "cuda") -> None:
    """Phase 4zb: ms per ``imread`` onto the card (CUDA events over
    MULTI_TIMED calls, the file in the page cache, read warm) of each JPEG
    form's 1920x1080 fixture beside a baseline 4:2:0 one, and beside each
    the native decode alone (``native.jpeg_decode_bgr`` into a host array,
    the host clock)."""
    from rustcv_tpu_torch import imgcodecs, native

    tag = f"[{smi}]"
    print(f"{tag} phase 4zb, JPEG forms at 1920x1080 (files read warm):", flush=True)
    for name, what in JPEG_FORMS_1080:
        path = os.path.join(JPEG_DATA, name)
        with open(path, "rb") as f:
            data = f.read()
        ms = cuda_ms(lambda: imgcodecs.imread(path, device=dev), MULTI_TIMED)
        out = np.empty((1080, 1920, 3), np.uint8)
        native.jpeg_decode_bgr(data, out=out)
        t = time.perf_counter()
        for _ in range(MULTI_TIMED):
            native.jpeg_decode_bgr(data, out=out)
        host = (time.perf_counter() - t) * 1e3 / MULTI_TIMED
        print(f"{tag} imread of the 1920x1080 {what} JPEG ({len(data)} bytes) onto the card: "
              f"{ms:.4f} ms; the native decode alone (host clock): {host:.4f} ms", flush=True)


# -- phases 3zc and 4zc: TIFF pages of JPEG compression and of the YCbCr
# photometric (ROADMAP Queue 1 item 8d-ii-c-i). The card's machine has no
# Pillow, so 3zc reads the fixtures committed in tests/data/tiff
# (tools/make_tiff_data.py, written with Pillow here) and holds each read to
# the reference's answers in their manifest; 4zc builds its 1080p pages
# with the port's own JPEG encoder and tiff_file.

TIFF_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "tiff")


def run_formats_8d_ii_c(dev: str = "cuda") -> dict:
    """Phase 3zc: every fixture of ``tests/data/tiff`` (JPEG strips and
    tiles, JPEGTables, every photometric, planar pages, YCbCr in data units
    on PackBits, LZW and Deflate, the forms that fail) read by ``imread``,
    ``imdecode`` and ``imreadmulti`` onto ``dev`` equals the CPU read and
    the manifest's page hashes, with ``imcount`` its count; a file the
    reference cannot load raises CameraError, old-style JPEG ``not_ported``.
    Returns the phase's launches (none expected)."""
    import hashlib

    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    with open(os.path.join(TIFF_DATA, "manifest.json")) as f:
        manifest = json.load(f)
    forms: dict = {}
    pages = 0
    for name, m in sorted(manifest.items()):
        path = os.path.join(TIFF_DATA, name)
        with open(path, "rb") as f:
            data = f.read()
        expect(hashlib.sha256(data).hexdigest() == m["sha256"], f"{name}: not the committed file")
        forms[m["form"]] = forms.get(m["form"], 0) + 1
        if m["form"] == "not_ported":
            got = _outcome(lambda: imgcodecs.imread(path, device=dev))
            expect(got == "NotImplementedError", f"{name}: imread answers {got}, not not_ported")
            continue
        expect(imgcodecs.imcount(path) == m["count"], f"{name}: imcount, not {m['count']}")
        loads = [p for p in m["pages"] if "error" not in p]  # the pages before one that fails
        reads = [("imread", lambda: [imgcodecs.imread(path, device=dev)]),
                 ("imdecode", lambda: [imgcodecs.imdecode(data, device=dev)])]
        if len(loads) < len(m["pages"]):  # a page Pillow opens but cannot load
            got = _outcome(lambda: imgcodecs.imreadmulti(path, device=dev))
            expect(got == "CameraError", f"{name}: imreadmulti answers {got}, not CameraError")
            if not loads:
                got = _outcome(lambda: imgcodecs.imdecode(data, device=dev))
                expect(got == "CameraError", f"{name}: imdecode answers {got}, not CameraError")
                continue
            cpu = [imgcodecs.imread(path, device="cpu").to_numpy()]
        else:
            cpu = [mat.to_numpy() for mat in imgcodecs.imreadmulti(path, device="cpu")]
            reads.append(("imreadmulti", lambda: imgcodecs.imreadmulti(path, device=dev)))
        expect([(list(c.shape), hashlib.sha256(np.ascontiguousarray(c).tobytes()).hexdigest())
                for c in cpu] == [(p["shape"], p["bgr_sha256"]) for p in loads[:len(cpu)]],
               f"{name}: not the reference's pages")
        for what, call in reads:
            for mat, c in zip(call(), cpu):
                expect(mat.device().device.type == dev, f"{name}: {what} on {mat.device().device}")
                expect(np.array_equal(mat.to_numpy(), c), f"{name}: the {dev} {what} differs")
        pages += len(cpu)
    print(f"formats 8d-ii-c-i: {len(manifest)} TIFF files ({pages} pages) read onto {dev} as "
          f"the reference answers (its page hashes, counts and error classes), by form: "
          f"{dict(sorted(forms.items()))}", flush=True)
    counts = kernels.launch_counts()
    expect(not any(counts.values()), f"phase 3zc launched kernels: {counts}")
    return counts


def tiff_jpeg_ycbcr_1080():
    """Phase 4zc's pages of the 1920x1080 test pattern: {label: TIFF bytes}
    for a YCbCr JPEG page of 256 x 256 tiles at 4:2:0 (the port's JPEG
    encoder, its DQT and DHT moved into JPEGTables) and a YCbCr page of
    2 x 2 data units on LZW in 16-row strips."""
    import torch

    from rustcv_tpu_torch.capture.simulation import synth_bgr
    from rustcv_tpu_torch.ops.jpeg_encode import encode_jpeg

    bgr = synth_bgr(W, H, 0)
    tables = {}

    def tile(blk, plane):
        j = encode_jpeg(torch.from_numpy(np.ascontiguousarray(blk[..., ::-1])), quality=85)
        p, head = 2, bytearray(b"\xff\xd8")
        while j[p + 1] != 0xDA:  # keep SOF and the rest, move the tables out
            n = int.from_bytes(j[p + 2:p + 4], "big")
            if j[p + 1] in (0xDB, 0xC4):
                tables.setdefault(bytes(j[p:p + 2 + n]), None)
            else:
                head += j[p:p + 2 + n]
            p += 2 + n
        return bytes(head + j[p:])

    rgb = np.ascontiguousarray(bgr[..., ::-1])
    pg = dict(samples=rgb, photo=6, comp=7, ycbcr=(2, 2), tile=(256, 256), jpeg=tile)
    tiff_file([pg])
    pg["tags"] = {347: (7, list(b"\xff\xd8" + b"".join(tables) + b"\xff\xd9"))}
    return {"JPEG 4:2:0, 256x256 tiles, JPEGTables": tiff_file([pg]),
            "YCbCr 2x2 LZW, 16-row strips": tiff_file([dict(samples=rgb, photo=6, comp=5,
                                                            ycbcr=(2, 2), rows=16)])}


def time_formats_8d_ii_c(smi: str, dev: str = "cuda") -> None:
    """Phase 4zc: ms per ``imread`` onto the card (CUDA events over
    MULTI_TIMED calls, the file in the page cache, read warm) of the two
    1920x1080 pages of :func:`tiff_jpeg_ycbcr_1080`, and beside each the
    host decode alone (``imgcodecs.tiff.read_tiff``, the host clock)."""
    import tempfile

    from rustcv_tpu_torch import imgcodecs
    from rustcv_tpu_torch.imgcodecs import tiff

    tag = f"[{smi}]"
    print(f"{tag} phase 4zc, TIFF JPEG and YCbCr pages at {W}x{H} (files read warm):", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for label, data in tiff_jpeg_ycbcr_1080().items():
            path = os.path.join(tmp, "x.tif")
            with open(path, "wb") as f:
                f.write(data)
            expect(np.array_equal(imgcodecs.imread(path, device=dev).to_numpy(),
                                  imgcodecs.imread(path, device="cpu").to_numpy()),
                   f"{label}: the {dev} read differs")
            ms = cuda_ms(lambda: imgcodecs.imread(path, device=dev), MULTI_TIMED)
            tiff.read_tiff(data)
            t = time.perf_counter()
            for _ in range(MULTI_TIMED):
                tiff.read_tiff(data)
            host = (time.perf_counter() - t) * 1e3 / MULTI_TIMED
            print(f"{tag} imread of the {W}x{H} {label} TIFF ({len(data)} bytes) onto the card: "
                  f"{ms:.4f} ms; the host decode alone (host clock): {host:.4f} ms", flush=True)


def time_new_paths(smi: str) -> None:
    """Phase 4j: ms/tick (CUDA events) of every other wire format: device-sim
    at 8 × 1080p (NV12 in every mode and beside the plain engine), host-staged
    at 2 × 1080p (blocking ticks: the gather on the host clock inside them);
    configs 1 and 4 eager and chained (``run_chained(512, chain=32)``,
    ``bench_models.py``'s call); config 3 with and without sub_batch in turns
    (with, without, without, with; each with its peak memory); config 5 per
    mode."""
    import torch

    from rustcv_tpu_torch.core import PixelFormat

    rects, colors = bench_overlay()
    tag = f"[{smi}]"  # the card's name and power limit beside every time
    sim_cases = [(PixelFormat.NV12, label, mode, impl) for label, mode, impl in (
        ("plain", "default", "xla"), ("default", "default", None), ("pallas", "pallas", None),
        ("pallas_tick", "pallas_tick", None))]
    sim_cases += [(PixelFormat[f], "default", "default", None) for f in SIM_FORMATS[1:]]
    for fmt, label, mode, impl in sim_cases:
        eng = format_engine(fmt, True, N, mode, stencil_impl=impl)
        ms = cuda_ms(lambda: eng.tick(rects=rects, rect_colors=colors), 20)
        eng.close()
        print(f"{tag} {fmt.value} device-sim 8x1080p {label}: {ms:.4f} ms/tick, "
              f"{N * 1e3 / ms:.1f} frames/s", flush=True)
    for f in HOST_FORMATS:
        eng = format_engine(PixelFormat[f], False, 2)
        r2, c2 = rects[:2], colors[:2]
        ms = cuda_ms(lambda: eng.tick(rects=r2, rect_colors=c2, block=True), 10)
        eng.close()
        print(f"{tag} {f} host-staged 2x1080p: {ms:.4f} ms/tick, {2e3 / ms:.1f} frames/s",
              flush=True)
    for name, mode in CHAIN_CASES:
        eng = chain_engine(name, mode)
        r1, c1 = rects[:1], colors[:1]
        ms = cuda_ms(lambda: eng.tick(rects=r1, rect_colors=c1), 50)
        runs = [eng.run_chained(512, chain=CHAIN, warmup=1, rects=r1, rect_colors=c1)
                for _ in range(2)]
        eng.close()
        print(f"{tag} {name} mode {mode}: eager {ms:.4f} ms/tick; chained " + ", ".join(
            f"{r.wall_s / r.ticks * 1e3:.4f} ms/tick ({r.fps_total:.1f} frames/s)" for r in runs),
            flush=True)
    variants = (("sub_batch=4", {"sub_batch": 4}), ("one batch (zoo)", {}))
    for label, overrides in variants + variants[::-1]:
        eng = zoo_engine(C3, **overrides)
        n = eng.n
        args = dict(rects=rects[:1].repeat(n, 0), rect_colors=colors[:1].repeat(n, 0))
        eng.tick(**args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: eng.tick(**args), 5)
        peak = torch.cuda.max_memory_allocated()
        eng.close()
        torch.cuda.empty_cache()
        print(f"{tag} config 3 {label}: {ms:.4f} ms/tick, {n * 1e3 / ms:.1f} frames/s, "
              f"max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)
    for mode in MODES:
        eng = zoo_engine(C5, mode)
        ms = cuda_ms(lambda: eng.tick(rects=rects, rect_colors=colors), 10)
        eng.close()
        print(f"{tag} config 5 mode {mode}: {ms:.4f} ms/tick, {N * 1e3 / ms:.1f} frames/s",
              flush=True)


def time_engines() -> dict:
    """Phase 4a: ms/tick (CUDA events) and frames/s per mode, plain engine
    included, in two rounds of opposite order."""
    rects, colors = bench_overlay()
    order = [("plain", "default", "xla")] + [(m, m, None) for m in MODES]
    result = {name: [] for name, _, _ in order}
    for rnd in (order, order[::-1]):
        for name, mode, impl in rnd:
            eng = make_engine(mode, stencil_impl=impl)
            for _ in range(5):
                eng.tick(rects=rects, rect_colors=colors)
            ms = cuda_ms(lambda: eng.tick(rects=rects, rect_colors=colors), 50)
            stats = eng.run(50, warmup=2, measure_latency=False, rects=rects, rect_colors=colors)
            eng.close()
            result[name].append({"ms_per_tick": ms, "fps_events": N * 1e3 / ms,
                                 "fps_run": stats.fps_total})
    for name, runs in result.items():
        print(f"engine {name}: " + "; ".join(
            f"{r['ms_per_tick']:.4f} ms/tick, {r['fps_events']:.1f} frames/s (events), "
            f"{r['fps_run']:.1f} frames/s (run)" for r in runs), flush=True)
    return result


def time_config4() -> dict:
    """Phase 4b: config 4's ms/tick (CUDA events) and frames/s per mode and
    filter, in two rounds of opposite order."""
    order = [(filt, mode) for filt in C4_FILTERS for mode in C4_MODES]
    result = {key: [] for key in order}
    for rnd in (order, order[::-1]):
        for filt, mode in rnd:
            eng = make_c4(mode, filt)
            for _ in range(5):
                eng.tick()
            ms = cuda_ms(eng.tick, 50)
            stats = eng.run(50, warmup=2, measure_latency=False)
            eng.close()
            result[filt, mode].append({"ms_per_tick": ms, "fps_events": 1e3 / ms,
                                       "fps_run": stats.fps_total})
    for (filt, mode), runs in result.items():
        print(f"config 4 {filt} mode {mode}: " + "; ".join(
            f"{r['ms_per_tick']:.4f} ms/tick, {r['fps_events']:.1f} frames/s (events), "
            f"{r['fps_run']:.1f} frames/s (run)" for r in runs), flush=True)
    return result


def _merged_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def time_config4_stages() -> None:
    """Phase 4c: config 4's stages alone at 1 × 1920×1080 (CUDA events, 20
    calls each): what each costs in a tick whose host issues every op."""
    import torch

    from rustcv_tpu_torch.core import PixelFormat
    from rustcv_tpu_torch.ops import color, features, kernels, synth
    from rustcv_tpu_torch.runtime.pipeline import HARRIS_POINTS

    seqs = torch.zeros(1, dtype=torch.int32, device="cuda")
    raw = synth.synth_raw(seqs, W, H, PixelFormat.YUYV)
    gray = color.yuyv_to_gray(raw, W, H)
    resp = kernels.harris_response_i32(gray)
    mask = features._corner_mask(resp, 0.01, 1)
    stages = {
        "plain synth": lambda: synth.synth_raw(seqs, W, H, PixelFormat.YUYV),
        "plain yuyv_to_bgr_packed": lambda: color.yuyv_to_bgr_packed(raw, W, H),
        "plain yuyv_to_gray": lambda: color.yuyv_to_gray(raw, W, H),
        "K4 decode+gray": lambda: kernels.yuyv_decode_interleave(raw, W, H),
        "Harris kernel (int32)": lambda: kernels.harris_response_i32(gray),
        "corner mask (threshold + NMS)": lambda: features._corner_mask(resp, 0.01, 1),
        "top-K corners": lambda: features._top_corners(resp, mask, HARRIS_POINTS),
    }
    print("config 4 stages alone at N=1 1920x1080: " + "; ".join(
        f"{name} {cuda_ms(fn, 20):.4f} ms" for name, fn in stages.items()), flush=True)


def profile_ticks(label: str, tick, kernel: str, kernel_label: str) -> None:
    """Device time per tick against the host's over PROFILE_TICKS steady
    calls of ``tick`` (torch.profiler), and the device time of the kernels
    whose name holds ``kernel``."""
    for _ in range(5):
        tick()
    profile_steps(label, lambda: [tick() for _ in range(PROFILE_TICKS)], kernel, kernel_label)


def profile_steps(label: str, steps, kernel: str, kernel_label: str) -> None:
    """As :func:`profile_ticks`, for ``steps()`` making PROFILE_TICKS ticks
    at once (a prefetching ``run``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        print(f"{label}: the profiler saw no device time (not measured)", flush=True)
        return
    busy = _merged_us((e.time_range.start, e.time_range.end) for e in kern)
    kernel_us = sum(e.time_range.end - e.time_range.start for e in kern if kernel in e.name)
    print(f"{label} (profiler, {PROFILE_TICKS} ticks): host {wall_us / PROFILE_TICKS / 1e3:.4f}"
          f" ms/tick, device busy {busy / PROFILE_TICKS / 1e3:.4f} ms/tick "
          f"({len(kern) / PROFILE_TICKS:.1f} kernels/tick), {kernel_label} "
          f"{kernel_us / PROFILE_TICKS / 1e3:.4f} ms/tick, device idle {1 - busy / wall_us:.1%}",
          flush=True)
    ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)[:6]
    print("  busiest ops (own device time per tick, calls per tick): " + "; ".join(
        f"{e.key} {e.self_device_time_total / PROFILE_TICKS / 1e3:.4f} ms, "
        f"{e.count / PROFILE_TICKS:g}" for e in ops), flush=True)


def profile_config4() -> None:
    """Phase 4d: config 4's device time per tick against the host's, per mode."""
    for mode in C4_MODES:
        eng = make_c4(mode)
        profile_ticks(f"config 4 mode {mode}", eng.tick, "harris_kernel", "Harris kernel")
        eng.close()


def time_config6() -> dict:
    """Phase 4e: config 6's ms/tick (CUDA events, 50 steady ticks) and its
    delivered JPEG frames/s and payload MB/tick (``run_encoded(50)``: frames
    whose bytes reached the host), its own engine beside a plain one
    (``stencil_impl="xla"``), in two rounds of opposite order."""
    rects, colors = bench_overlay()
    order = [("plain", "xla"), ("default", None)]
    result = {name: [] for name, _ in order}
    for rnd in (order, order[::-1]):
        for name, impl in rnd:
            eng = make_c6("default", stencil_impl=impl)
            for _ in range(5):
                eng.tick(rects=rects, rect_colors=colors, thickness=THICKNESS)
            ms = cuda_ms(lambda: eng.tick(rects=rects, rect_colors=colors, thickness=THICKNESS), 50)
            stats, mb = eng.run_encoded(50, warmup=2, rects=rects, rect_colors=colors)
            result[name].append({"ms_per_tick": ms, "fps_events": N * 1e3 / ms,
                                 "fps_delivered": stats.fps_total, "mb_per_tick": mb,
                                 "over_capacity": eng.encode_dense_fallbacks})
            eng.close()
    for name, runs in result.items():
        print(f"config 6 {name}: " + "; ".join(
            f"{r['ms_per_tick']:.4f} ms/tick, {r['fps_events']:.1f} frames/s (events), "
            f"{r['fps_delivered']:.1f} JPEG frames/s delivered, {r['mb_per_tick']:.6f} MB/tick "
            f"payload, {r['over_capacity']} over-capacity ticks" for r in runs), flush=True)
    return result


def time_config6_stages() -> None:
    """Phase 4f: config 6's stages alone at 8 × 1920×1080 → 640×480 (CUDA
    events, 20 calls each), and the host coder per tick (host clock)."""
    import torch

    from rustcv_tpu_torch.core import PixelFormat
    from rustcv_tpu_torch.ops import color, draw, jpeg_encode, kernels, resize, synth

    dev = torch.device("cuda")
    seqs = torch.zeros(N, dtype=torch.int32, device=dev)
    raw = synth.synth_raw(seqs, W, H, PixelFormat.YUYV)
    bgr = color.yuyv_to_bgr_packed(raw, W, H)
    small = resize.resize_bilinear_packed(bgr, W, H, C6_W, C6_H)
    hwc = small.reshape(N, C6_H, C6_W, 3)
    gray = color.bgr_to_gray_packed_rows(small, C6_W, C6_H)
    rects = torch.tensor([RECT] * N, dtype=torch.int32, device=dev)
    colors = torch.tensor([COLOR] * N, dtype=torch.uint8, device=dev)
    coeffs = jpeg_encode.encode_coeffs(hwc, 85)
    allc = torch.cat(coeffs, dim=-2)
    eng = make_c6("default")
    k, cap = eng.spec.encode_packed, eng.spec.encode_dense_cap
    packed = jpeg_encode.pack_coeff_rows(allc, k, cap)
    stages = {
        "plain synth": lambda: synth.synth_raw(seqs, W, H, PixelFormat.YUYV),
        "plain yuyv_to_bgr_packed": lambda: color.yuyv_to_bgr_packed(raw, W, H),
        "resize to 640x480": lambda: resize.resize_bilinear_packed(bgr, W, H, C6_W, C6_H),
        "gray of the resized image": lambda: color.bgr_to_gray_packed_rows(small, C6_W, C6_H),
        "K1": lambda: kernels.blur_sobel_mag(gray),
        "overlay": lambda: draw.rectangle_packed(small, rects, colors, THICKNESS),
        "encode (colour, subsample, DCT, quantize)": lambda: jpeg_encode.encode_coeffs(hwc, 85),
        "block pack": lambda: jpeg_encode.pack_coeff_rows(allc, k, cap),
        "blob": lambda: jpeg_encode.blob_from_packed(*packed),
    }
    print(f"config 6 stages alone at N={N} {W}x{H} -> {C6_W}x{C6_H}: " + "; ".join(
        f"{name} {cuda_ms(fn, 20):.4f} ms" for name, fn in stages.items()), flush=True)
    dense = [c.cpu().numpy() for c in coeffs]
    host = [a.cpu().numpy() for a in packed[:4]]
    # The packed rows of an over-capacity tick lack blocks: their bytes
    # are not a frame, only the coder's time is read.
    coders = {"dense": lambda: eng._encode_from_host(*dense),
              "packed": lambda: eng._encode_from_host_packed(*host)}
    for name, fn in coders.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        print(f"config 6 host coder, {N} streams from {name} rows: "
              f"{(time.perf_counter() - t0) / 5 * 1e3:.4f} ms/tick", flush=True)
    eng.close()


def profile_config6() -> None:
    """Phase 4f: config 6's device time per tick against the host's."""
    rects, colors = bench_overlay()
    eng = make_c6("default")
    profile_ticks("config 6 mode default",
                  lambda: eng.tick(rects=rects, rect_colors=colors, thickness=THICKNESS),
                  "blur_sobel_kernel", "K1")
    eng.close()


def time_host_path() -> None:
    """Phase 4h: the host path per mode as bench.py times it (a discarded
    warm run of 6 ticks, then 3 prefetching runs of 20), and its device
    idle share over a prefetching run (profiler)."""
    rects, colors = bench_overlay()
    for mode in MODES:
        eng = make_host_engine(mode)
        eng.run(6, warmup=5, measure_latency=False, rects=rects, rect_colors=colors)
        runs = [eng.run(20, warmup=0, measure_latency=False, rects=rects, rect_colors=colors)
                for _ in range(3)]
        print(f"host path mode {mode}: " + "; ".join(
            f"{r.fps_total:.2f} frames/s, {r.wall_s / r.ticks * 1e3:.4f} ms/tick, gather "
            f"{r.host_gather_ms:.4f} ms" for r in runs) + f"; waits {eng.staging_waits}",
            flush=True)
        profile_steps(f"host path mode {mode}", lambda: eng.run(
            PROFILE_TICKS, warmup=0, measure_latency=False, rects=rects, rect_colors=colors),
            "blur_sobel" if mode != "pallas_tick" else "tick_fused", "its kernel")
        eng.close()


def time_config2() -> None:
    """Phase 4i: config 2's ms/tick and frames/s (prefetching runs of 20),
    blocking-tick latency, H2D MB per tick, gather ms, and its idle share."""
    eng = make_c2()
    eng.run(6, warmup=3, measure_latency=False)
    for _ in range(2):
        r = eng.run(20, warmup=0, measure_latency=False)
        lat = eng.run(20, warmup=0, measure_latency=True)
        print(f"config 2: {r.wall_s / r.ticks * 1e3:.4f} ms/tick, {r.fps_total:.2f} frames/s, "
              f"gather {r.host_gather_ms:.4f} ms (prefetched); blocking ticks p50 "
              f"{lat.p50_latency_ms:.4f} ms, p99 {lat.p99_latency_ms:.4f} ms, gather "
              f"{lat.host_gather_ms:.4f} ms; H2D {h2d_mb(eng):.3f} MB per tick; waits "
              f"{eng.staging_waits}; dense ticks {eng.mjpeg_dense_ticks}", flush=True)
    profile_steps("config 2", lambda: eng.run(PROFILE_TICKS, warmup=0, measure_latency=False),
                  "gemm", "its IDCT products")
    eng.close()


# The card's peaks (H100 SXM at 700 W, the published data sheet's): HBM
# bytes/s and float32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# The float32 Harris response per pixel: Sobel gx, gy (10), the products
# (3), three 3×3 box sums (24), det, trace and k·trace² (7).
HARRIS_F32_FLOP_PER_PX = 44
COLD_BYTES = 64e6  # cold-L2 rotation: inputs together above the 50 MB L2


def bound_ms(nbytes: float, flops: float = 0.0) -> tuple:
    """Least ms the card could take, and what bounds it: each input byte
    read once and each output byte written once at the HBM rate, or the
    float32 operations at the peak rate, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def device_ms(fn, inputs, reps: int) -> float:
    """Mean device ms per call of ``fn(x)``, x rotating over ``inputs`` (one
    input: warm; copies together larger than the L2: cold). The calls queue
    behind a spin kernel longer than their issue takes, so the events time
    the device alone, not the host's pace of wrapper calls."""
    import torch

    fn(inputs[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(inputs[(i + 1) % len(inputs)])
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(issue_s * 2 * 2e9) + 100_000)  # cycles, at up to 2 GHz
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(inputs[(i + 1) % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_copies(t) -> list:
    """``t`` and copies of it, together at least COLD_BYTES."""
    k = max(2, -(-int(COLD_BYTES) // (t.numel() * t.element_size())))
    return [t] + [t.clone() for _ in range(k - 1)]


def k7_library_calls(dev) -> dict:
    """The K7 cases that one PyTorch call computes: case → that call (timed
    beside the kernel only; the port never calls it)."""
    import torch

    idx = {n: torch.arange(n, device=dev) // 3 for n in (128, 384)}
    return {
        "strided_load": lambda x: x[:, ::2].contiguous(),
        "lane_gather": lambda x: torch.index_select(x, 1, idx[384]),
        "lane_roll": lambda x: torch.roll(x, 1, 1),
        "u8_astype": lambda x: x.to(torch.uint8),
        "gather_128": lambda x: torch.index_select(x, 1, idx[128]),
        "unaligned_slice": lambda x: x[:, 42:170].contiguous(),
        "repeat_lanes": lambda x: torch.repeat_interleave(x, 3, dim=1),
    }


def time_kernels() -> dict:
    """Phase 4g: each kernel and its plain version at 8×1920×1080 (K1 at
    config 6's 8×640×480 too, the Harris forms at 1×1920×1080 too, K7 as
    its 13 cases per call), in turns (plain, kernel, kernel, plain), warm,
    then the kernel with its input cold (rotating over copies beyond the
    L2); each beside its bound. Device time (``device_ms``): the calls queue
    behind a spin kernel, so the wrappers' host cost does not pace them. Returns name → its numbers at the main
    path's shape (the first row of each kernel)."""
    import torch

    from rustcv_tpu_torch.ops.kernels import (decode_interleave, harris, mosaic_shuffle,
                                              stencil, tick_fused)
    from rustcv_tpu_torch.probes.mosaic_shuffle import PROBES

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.integers(0, 256, (N, H * W * 2), np.uint8)).to(dev)
    gray = torch.from_numpy(rng.integers(0, 256, (N, H, W), np.uint8)).to(dev)
    rects = torch.tensor([RECT] * N, dtype=torch.int32, device=dev)
    colors = torch.tensor([COLOR] * N, dtype=torch.uint8, device=dev)
    yuyv = (W, H, rects, colors, THICKNESS, True)
    one = gray[:1].contiguous()  # config 4 gives the Harris kernel one 1080p frame per tick
    vga = gray[:, :C6_H, :C6_W].contiguous()  # config 6's resized gray
    rows = [  # (name, kernel(x), plain(x), x, bytes and float32 ops per pixel); main path first
        ("blur_sobel_mag", stencil.blur_sobel_mag, stencil.blur_sobel_mag_plain, gray, 2, 0),
        ("blur_sobel_mag", stencil.blur_sobel_mag, stencil.blur_sobel_mag_plain, vga, 2, 0),
        ("yuyv_decode_interleave", lambda x: decode_interleave.yuyv_decode_interleave(x, *yuyv),
         lambda x: decode_interleave.yuyv_decode_interleave_plain(x, *yuyv), src, 6, 0),
        ("yuyv_tick_fused", lambda x: tick_fused.yuyv_tick_fused(x, *yuyv),
         lambda x: tick_fused.yuyv_tick_fused_plain(x, *yuyv), src, 6, 0),
    ]
    for g in (one, gray):  # 1 B in, 4 B (float32 or int32) out per pixel
        rows += [("harris_response_f32", harris.harris_response, harris.harris_response_plain, g,
                  5, HARRIS_F32_FLOP_PER_PX),
                 ("harris_response_i32", harris.harris_response_i32,
                  harris.harris_response_i32_plain, g, 5, 0)]
    times = {}
    for name, kern, plain, x, bytes_per_px, flop_per_px in rows:
        px = x.numel() if x is not src else x.numel() // 2
        shape = f"N={x.shape[0]} {W if x is src else x.shape[2]}x{H if x is src else x.shape[1]}"
        p1, k1, k2, p2 = (device_ms(plain, [x], 10), device_ms(kern, [x], 50),
                          device_ms(kern, [x], 50), device_ms(plain, [x], 10))
        cold = device_ms(kern, cold_copies(x), 50)
        bound, by = bound_ms(px * bytes_per_px, px * flop_per_px)
        times.setdefault(name, {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "cold_ms": cold,
                                "bound_ms": bound, "bound_by": by, "library_ms": None})
        torch.cuda.empty_cache()
        print(f"{name} at {shape}: kernel {k1:.4f} / {k2:.4f} ms warm, {cold:.4f} ms cold L2, "
              f"plain {p1:.4f} / {p2:.4f} ms; bound {bound:.4f} ms ({px * bytes_per_px / 1e6:.1f} "
              f"MB), warm share of bound {bound / ((k1 + k2) / 2):.1%}", flush=True)

    k7_inputs = {name: [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in p.inputs()]
                 for name, p in PROBES.items()}
    k7_bytes = sum(t.numel() * t.element_size() for v in k7_inputs.values() for t in v) + sum(
        mosaic_shuffle.mosaic_shuffle_plain(k, *v).numel()
        * mosaic_shuffle.mosaic_shuffle_plain(k, *v).element_size() for k, v in k7_inputs.items())
    kern = lambda: [mosaic_shuffle.mosaic_shuffle(k, *v) for k, v in k7_inputs.items()]  # noqa: E731
    plain = lambda: [mosaic_shuffle.mosaic_shuffle_plain(k, *v) for k, v in k7_inputs.items()]  # noqa: E731
    p1, k1, k2, p2 = (device_ms(lambda _: plain(), [None], 10), device_ms(lambda _: kern(), [None], 50),
                      device_ms(lambda _: kern(), [None], 50), device_ms(lambda _: plain(), [None], 10))
    lib = {}
    for case, call in k7_library_calls(dev).items():
        x = k7_inputs[case][0]
        same = torch.equal(call(x), mosaic_shuffle.mosaic_shuffle(case, x))
        lib[case] = device_ms(call, [x], 50) if same else None
        print(f"mosaic_shuffle {case}: kernel "
              f"{device_ms(lambda t: mosaic_shuffle.mosaic_shuffle(case, t), [x], 50):.4f} ms, plain "
              f"{device_ms(lambda t: mosaic_shuffle.mosaic_shuffle_plain(case, t), [x], 50):.4f} ms, "
              f"one PyTorch call {f'{lib[case]:.4f} ms' if same else 'gives other values'}",
              flush=True)
    bound, by = bound_ms(k7_bytes)
    times["mosaic_shuffle"] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "cold_ms": None,
                               "bound_ms": bound, "bound_by": by, "library_ms": None,
                               "library_ms_cases": lib}
    print(f"mosaic_shuffle, its {len(PROBES)} cases per call: kernel {k1:.4f} / {k2:.4f} ms, "
          f"plain {p1:.4f} / {p2:.4f} ms; bound {bound:.6f} ms ({k7_bytes} B, {len(PROBES)} "
          "launches: launch latency, not bytes, sets its floor)", flush=True)
    return times


MESH_TICKS = 3  # mesh engine ticks held against the meshless engine's, per mode
MESH_MODES = ("default", "pallas")
MESH_LAUNCHES = {"default": {"blur_sobel_mag": MESH_TICKS},
                 "pallas": {"blur_sobel_mag": MESH_TICKS, "yuyv_decode_interleave": MESH_TICKS}}
BANDS = (2, 4, 8)  # row bands of the spatial route, one process
LAUNCH_TIMEOUT_S = 300


def gray_batch(dev):
    import torch

    rng = np.random.default_rng(11)
    return torch.from_numpy(rng.integers(0, 256, (N, H, W), np.uint8)).to(dev)


def band_route(gray, n_bands: int):
    """The spatial route in one process: ``n_bands`` row bands, each with
    its neighbours' HALO rows sliced off the batch, through
    ``band_blur_sobel`` (K1 per band), concatenated."""
    import torch

    from rustcv_tpu_torch.parallel.spatial import HALO, band_blur_sobel

    b = gray.shape[1] // n_bands
    out = []
    for r in range(n_bands):
        lo, hi = r * b, (r + 1) * b
        out.append(band_blur_sobel(gray[:, lo:hi], gray[:, lo - HALO:lo] if r > 0 else None,
                                   gray[:, hi:hi + HALO] if r < n_bands - 1 else None))
    return torch.cat(out, 1)


def run_launcher(ticks: int) -> dict:
    """``python -m rustcv_tpu_torch.parallel.launch --ticks <ticks>`` as a
    user starts it on one card; returns its summary line (rank 0's last)."""
    set_mode("default")
    proc = subprocess.Popen([sys.executable, "-m", "rustcv_tpu_torch.parallel.launch",
                             "--ticks", str(ticks)], cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    expect(proc.returncode == 0, f"the launcher exited {proc.returncode}: {err[-2000:]}")
    return json.loads([x for x in out.splitlines() if x.startswith("{")][-1])


def run_mesh() -> dict:
    """Phase 3m: multi-device execution on a one-rank NCCL mesh over the
    card. The headline engine with ``mesh=stream_mesh("cuda")`` in the
    default and ``pallas`` modes, each tick's ``bgr``, ``filtered`` and
    sequences identical to the meshless engine's; the spatial route (row
    bands with sliced halos through ``band_blur_sobel``, K1 per band) at
    R = 2, 4, 8 and ``blur_sobel_mag_spatial`` on the one-rank rows mesh,
    identical to K1 on the whole batch and to the plain chain;
    ``corner_counts_psum`` (the reference test's 9); the launcher's summary
    (one process, one chip, the fleet's frames/s its own). Returns the
    path's launches; the meshless engine and whole-batch K1 run before the
    counts are set to 0."""
    import torch

    from rustcv_tpu_torch import parallel
    from rustcv_tpu_torch.ops import kernels
    from rustcv_tpu_torch.ops.kernels import stencil

    mesh = parallel.stream_mesh("cuda")
    expect(mesh.size() == 1 and mesh.device_type == "cuda", f"mesh {mesh}")
    mask = np.zeros((8, 16, 16), bool)  # the reference test's (tests/test_runtime.py:216-228)
    mask[:, 4, 4] = True
    mask[0, 8, 8] = True
    total = parallel.corner_counts_psum(parallel.shard_batch(mask, mesh), mesh)  # NCCL's first
    expect(int(total) == 9 and total.device.type == "cuda", f"corner_counts_psum gave {total}")
    rects, colors = bench_overlay()
    refs = {}
    for mode in MESH_MODES:
        eng = make_engine(mode)
        refs[mode] = [eng.tick(rects=rects, rect_colors=colors) for _ in range(MESH_TICKS)]
        eng.close()
    gray = gray_batch(torch.device("cuda"))
    whole = stencil.blur_sobel_mag(gray)
    expect(torch.equal(whole, stencil.blur_sobel_mag_plain(gray)), "K1 differs from plain")
    rows = parallel.stream_mesh("cuda", axis="rows")
    torch.cuda.synchronize()

    kernels.reset_launch_counts()  # the mesh path starts here
    for mode in MESH_MODES:
        before = kernels.launch_counts()
        eng = make_engine(mode, mesh=mesh)
        expect((eng.n, eng.first_stream, eng.device) == (N, 0, torch.device("cuda", 0)),
               f"mesh engine: {eng.n} streams from {eng.first_stream} on {eng.device}")
        for t, ref in enumerate(refs[mode]):
            res = eng.tick(rects=rects, rect_colors=colors)
            for key in ("bgr", "filtered"):
                expect(torch.equal(parallel.gather_streams(res.outputs[key], mesh),
                                   ref.outputs[key]),
                       f"mesh {mode} tick {t}: {key} differs from the meshless engine")
            expect((parallel.gather_streams(res.sequences, mesh) == ref.sequences).all(),
                   f"mesh {mode} tick {t}: sequences differ")
        torch.cuda.synchronize()
        eng.close()
        after = kernels.launch_counts()
        per = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        expect(per == MESH_LAUNCHES[mode], f"mesh {mode}: launches {per}")
        print(f"mesh engine ({mode}, one-rank NCCL stream mesh): {MESH_TICKS} ticks of "
              f"{N} x {W}x{H} identical to the meshless engine; launches {per}", flush=True)
    before = kernels.launch_counts()["blur_sobel_mag"]
    for n_bands in BANDS:
        expect(torch.equal(band_route(gray, n_bands), whole),
               f"the band route at R={n_bands} differs from K1 on the whole batch")
    expect(torch.equal(parallel.blur_sobel_mag_spatial(gray, rows), whole),
           "blur_sobel_mag_spatial on the one-rank rows mesh differs from K1")
    torch.cuda.synchronize()
    band_launches = kernels.launch_counts()["blur_sobel_mag"] - before
    expect(band_launches == sum(BANDS) + 1, f"the band route launched K1 {band_launches} times")
    totals = kernels.launch_counts()  # read just after the mesh path's run
    print(f"band route: R = {BANDS} and the rows mesh identical to K1 on the whole batch and to "
          f"the plain chain; K1 launches {band_launches}", flush=True)
    del refs
    torch.cuda.empty_cache()

    summary = run_launcher(TICKS)
    print("launcher: " + json.dumps(summary), flush=True)
    expect(summary["processes"] == 1 and summary["chips"] == 1, f"launcher: {summary}")
    expect(summary["fleet_fps"] == summary["local_fps"] and summary["streams"] == N,
           f"launcher: the fleet's frames/s is not the one rank's: {summary}")
    return totals


def time_mesh(smi: str) -> None:
    """Phase 4m: headline ms/tick (CUDA events, 50 ticks, default mode) on
    the meshless engine and on the one-rank mesh in turns (meshless, mesh,
    mesh, meshless), and the band route at R = 2, 4, 8 beside K1 on the
    whole batch (device time)."""
    import torch

    from rustcv_tpu_torch import parallel
    from rustcv_tpu_torch.ops.kernels import stencil

    mesh = parallel.stream_mesh("cuda")
    rects, colors = bench_overlay()
    ms = {"meshless": [], "mesh": []}
    for label in ("meshless", "mesh", "mesh", "meshless"):
        eng = make_engine("default", mesh=mesh if label == "mesh" else None)
        for _ in range(5):
            eng.tick(rects=rects, rect_colors=colors)
        ms[label].append(cuda_ms(lambda: eng.tick(rects=rects, rect_colors=colors), 50))
        eng.close()
    print(f"headline default ms/tick: meshless {ms['meshless'][0]:.4f}, {ms['meshless'][1]:.4f}; "
          f"one-rank mesh {ms['mesh'][0]:.4f}, {ms['mesh'][1]:.4f} ({smi})", flush=True)
    gray = gray_batch(torch.device("cuda"))
    k1 = device_ms(stencil.blur_sobel_mag, [gray], 50)
    bands = {r: device_ms(lambda g: band_route(g, r), [gray], 20) for r in BANDS}
    print(f"band route ms at {N} x {W}x{H}: " + ", ".join(
        f"R={r} {v:.4f}" for r, v in bands.items()) + f"; K1 on the whole batch {k1:.4f} ({smi})",
        flush=True)


# -- the capture backends and the first group of device ops (phases 3n, 4n) --------

RING_FRAMES = 20  # Camera reads of the native ring per pacing
SLICE_TICKS = 3  # headline ticks of RUSTCV_DECODE=xla_fused
LSB = 1  # ±1 LSB: Lab and general float kernels (the reference's tolerance)
SUBPIX_TOL = 1e-3  # px: corner_sub_pix (the reference's tolerance)


def slice_calls(ip) -> dict:
    """name → (call on a Mat, tolerance, "bgr" or "gray") for every
    ``imgproc`` wrapper of the slice and the ops without one; each call
    returns a Mat, an array, a tensor or a dict (moments)."""
    import torch

    from rustcv_tpu_torch.ops import color, filters

    se = ip.get_structuring_element("ellipse", 5)
    general = np.random.default_rng(7).normal(size=(3, 5))
    exact = {
        "cvt_hsv": ip.cvt_hsv, "cvt_hsv_to_bgr": ip.cvt_hsv_to_bgr, "cvt_ycrcb": ip.cvt_ycrcb,
        "cvt_ycrcb_to_bgr": ip.cvt_ycrcb_to_bgr,
        "in_range": lambda m: ip.in_range(m, (20, 30, 40), (180, 200, 220)),
        "moments": ip.moments, "pyr_down": ip.pyr_down, "pyr_up": ip.pyr_up,
        "stack_blur": lambda m: ip.stack_blur(m, 7, 15), "box_blur": lambda m: ip.box_blur(m, 5),
        "gaussian_blur k5": lambda m: ip.gaussian_blur(m, 5),
        "threshold": lambda m: ip.threshold(m, 100, 200, "trunc"),
        "erode": lambda m: ip.erode(m, 3), "dilate": lambda m: ip.dilate(m, 5),
        "erode_kernel": lambda m: ip.erode_kernel(m, se),
        "dilate_kernel": lambda m: ip.dilate_kernel(m, se),
        "morphology_ex": lambda m: ip.morphology_ex(m, "gradient", 3),
        "median_blur k3": lambda m: ip.median_blur(m, 3),
        "median_blur k5": lambda m: ip.median_blur(m, 5),
        "median_blur k7": lambda m: ip.median_blur(m, 7),
        "filter2d dyadic": lambda m: ip.filter2d(m, np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]]) / 2),
        "integral": ip.integral, "sobel": lambda m: ip.sobel(m, 1, 1, 5),
        "laplacian": ip.laplacian, "scharr": lambda m: ip.scharr(m, 1, 0),
        "good_features_to_track": lambda m: ip.good_features_to_track(m, 256),
        "moments_rows": lambda m: color.moments_rows(m.device() if m.is_on_device
                                                     else torch.from_numpy(m.to_numpy())),
    }
    lsb = {
        "cvt_lab": ip.cvt_lab, "cvt_lab_to_bgr": ip.cvt_lab_to_bgr,
        "gaussian_blur k3": lambda m: ip.gaussian_blur(m, 3),
        "gaussian_blur k5 sigma 1.5": lambda m: ip.gaussian_blur(m, 5, 1.5),
        "gaussian_blur k9": lambda m: ip.gaussian_blur(m, 9),
        "filter2d general": lambda m: ip.filter2d(m, general),
        "sep_filter_2d": lambda m: ip.sep_filter_2d(m, [0.2, 0.5, 0.3], [0.1, 0.8, 0.1]),
    }
    calls = {k: (v, 0, "bgr") for k, v in exact.items()}
    calls.update({k: (v, LSB, "bgr") for k, v in lsb.items()})
    for mode in ("bilinear", "nearest", "area", "cubic"):
        for dw, dh in ((640, 480), (3840, 2160)):
            calls[f"resize {mode} {dw}x{dh}"] = (
                lambda m, a=(dw, dh, mode): ip.resize(m, *a), 0, "bgr")
    calls["adaptive_threshold"] = (lambda m: ip.adaptive_threshold(m, 255, "mean", 11, 2), 0,
                                   "gray")
    calls["bilateral_filter"] = (lambda m: ip.bilateral_filter(m, 25), 0, "gray")
    calls["median3_u8 gray"] = (lambda m: filters.median3_u8(m.device() if m.is_on_device
                                                             else torch.from_numpy(m.to_numpy())),
                                0, "gray")
    return calls


def slice_mats():
    """(bgr, gray) Mats on the card and the same on the host: a seeded
    1920×1080 frame of the test pattern with noise rows."""
    import torch

    from rustcv_tpu_torch.capture.simulation import synth_bgr
    from rustcv_tpu_torch.ops.color import bgr_to_gray
    from rustcv_tpu_torch.prelude import Mat

    img = synth_bgr(W, H, 11)
    img[::5] = np.random.default_rng(12).integers(0, 256, img[::5].shape, np.uint8)
    gray = bgr_to_gray(torch.from_numpy(img)).numpy()[..., None]
    mats = {}
    for kind, a in (("bgr", img), ("gray", gray)):
        dev = Mat.from_array(a.copy())
        dev.device()
        mats[kind] = (dev, Mat.from_array(a.copy(), device="cpu"))
    return mats


def _plain(x):
    if hasattr(x, "to_numpy"):
        return x.to_numpy()
    if hasattr(x, "cpu"):
        return x.cpu().numpy()
    return x


def check_slice_ops(ip) -> None:
    """Phase 3n, ops: every call of :func:`slice_calls` on the 1080p CUDA
    Mat against the same call on the host Mat (the CPU port): byte-equal,
    or within LSB where the reference's tolerance is ±1 LSB; a call that
    returns a Mat returns a CUDA Mat; corner_sub_pix of the CPU's corners
    within SUBPIX_TOL."""
    import torch

    mats = slice_mats()
    worst = {}
    for name, (call, tol, kind) in slice_calls(ip).items():
        dev_mat, host_mat = mats[kind]
        got = call(dev_mat)
        want = call(host_mat)
        if hasattr(got, "is_on_device"):
            expect(got.is_on_device and got.device().is_cuda, f"{name}: the result left the card")
        if isinstance(want, dict):
            expect(got == want, f"{name}: {got} != {want}")
            continue
        got, want = _plain(got), _plain(want)
        expect(got.shape == want.shape and got.dtype == want.dtype,
               f"{name}: {got.shape} {got.dtype} != {want.shape} {want.dtype}")
        err = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max(initial=0))
        expect(err <= tol, f"{name}: max |diff| {err} > {tol}")
        worst[name] = err
    pts = ip.good_features_to_track(mats["bgr"][1], 256) + np.float32(0.3)
    expect(len(pts) > 8, f"only {len(pts)} corners")
    got = ip.corner_sub_pix(mats["bgr"][0], pts)
    want = ip.corner_sub_pix(mats["bgr"][1], pts)
    err = float(np.abs(got - want).max())
    expect(err <= SUBPIX_TOL, f"corner_sub_pix: max |diff| {err} px")
    torch.cuda.synchronize()
    print(f"slice ops at {W}x{H}: {len(worst) + 1} calls on the card == the CPU port "
          f"(max |diff| {max(worst.values())} LSB where {LSB} is allowed; corner_sub_pix "
          f"{err:.2e} px on {len(pts)} corners)", flush=True)


def run_xla_fused_headline() -> dict:
    """Phase 3n, the xla_fused headline: 8 × 1080p device-sim YUYV with
    blur_sobel and the overlay for SLICE_TICKS ticks, equal to the default
    mode's ticks; K1 once per tick, never K4 or K5. Returns the launches of
    its ticks."""
    import torch

    from rustcv_tpu_torch.ops import kernels

    rects, colors = bench_overlay()
    base = make_engine("default")
    ref = [base.tick(rects=rects, rect_colors=colors) for _ in range(SLICE_TICKS)]
    base.close()
    kernels.reset_launch_counts()
    eng = make_engine("xla_fused")
    got = [eng.tick(rects=rects, rect_colors=colors) for _ in range(SLICE_TICKS)]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    eng.close()
    set_mode("default")
    want = {name: 0 for name in counts}
    want["blur_sobel_mag"] = SLICE_TICKS
    expect(counts == want, f"xla_fused launches {counts}, expected {want}")
    for t, (a, b) in enumerate(zip(got, ref)):
        for key in ("bgr", "filtered"):
            expect(torch.equal(a.outputs[key], b.outputs[key]),
                   f"xla_fused tick {t}: {key} differs from the default mode")
    print(f"xla_fused headline: {SLICE_TICKS} ticks of {N} x {W}x{H} identical to the default "
          f"mode; launches {counts}", flush=True)
    return counts


def ring_source(paced: bool, buffers: int = 4):
    from rustcv_tpu_torch.capture.native_source import NativeSimulationSource
    from rustcv_tpu_torch.core import PixelFormat, ResolvedConfig

    return NativeSimulationSource(ResolvedConfig(W, H, 60, PixelFormat.YUYV, buffers), paced=paced)


def run_native_ring() -> None:
    """Phase 3n, the native ring: a NativeSimulationSource at 1920×1080,
    unpaced and paced at 60 fps, in a Camera, for RING_FRAMES frames: each
    frame equal to synth_raw for its sequence number, sequences rising, a
    re-queued slot's Frame raising, ``read_decoded_device("cuda")`` equal to
    the host decode of the same frame; then a stalled consumer shows
    drops."""
    import torch

    from rustcv_tpu_torch.capture import Camera
    from rustcv_tpu_torch.capture.simulation import synth_raw
    from rustcv_tpu_torch.core import PixelFormat
    from rustcv_tpu_torch.ops import decode
    from rustcv_tpu_torch.prelude import Mat

    for paced in (False, True):
        src = ring_source(paced)
        cam = Camera(src, None)
        try:
            seqs, prev = [], None
            for i in range(RING_FRAMES):
                if i % 2 == 0:
                    frame = cam.next_frame()
                else:
                    got = cam.read_decoded_device("cuda")
                    frame = src._prev_frame  # the frame the read decoded
                    mat = Mat(device="cpu")
                    decode.decode_frame_host(frame, mat)
                    expect(got.is_cuda and np.array_equal(got.cpu().numpy(), mat.to_numpy()),
                           f"ring read {i}: the card's decode differs from the host's")
                expect(np.array_equal(frame.data, synth_raw(W, H, PixelFormat.YUYV, frame.sequence)),
                       f"ring frame {frame.sequence} differs from synth_raw")
                if prev is not None:
                    try:
                        prev.data
                        raise SmokeFailure("a re-queued slot's Frame did not raise")
                    except RuntimeError:
                        pass
                seqs.append(frame.sequence)
                prev = frame
            expect(seqs == sorted(set(seqs)), f"sequences do not rise: {seqs}")
            print(f"native ring {'paced' if paced else 'unpaced'}: {RING_FRAMES} frames equal to "
                  f"synth_raw, sequences {seqs[0]}..{seqs[-1]}, drops "
                  f"{src.telemetry().dropped_frames}", flush=True)
        finally:
            cam.close()
            src.close()
    src = ring_source(True, buffers=2)
    src.start()
    try:
        src.next_frame()
        time.sleep(0.2)  # both slots held: the 60 fps sensor drops ~12 frames
        dropped = src.telemetry().dropped_frames
        expect(dropped > 0, "a stalled consumer showed no drops")
        print(f"native ring, stalled consumer: {dropped} frames dropped in 0.2 s", flush=True)
    finally:
        src.close()
    torch.cuda.synchronize()


def run_v4l2() -> None:
    """Phase 3n, V4L2: the driver's branch and the nodes, printed; a missing
    node raises DeviceNotFound, /dev/null a CameraError; without a node
    the default backend is simulation; with a capture device, 5 frames of
    its shape with rising sequences."""
    from rustcv_tpu_torch import native, videoio
    from rustcv_tpu_torch.capture.v4l2 import V4L2Driver, enumerate_modes, list_video_devices
    from rustcv_tpu_torch.core import CameraError, DeviceNotFound, SimpleConfig

    nodes = list_video_devices()
    print(f"V4L2: rcv_v4l2_available() = {int(native.v4l2_available())}, "
          f"list_video_devices() = {nodes}", flush=True)
    for path, error in (("/dev/video255", DeviceNotFound), ("/dev/null", CameraError)):
        try:
            enumerate_modes(path)
            raise SmokeFailure(f"enumerate_modes({path!r}) did not raise")
        except error as e:
            print(f"V4L2: enumerate_modes({path!r}) raised {type(e).__name__}: {e}", flush=True)
    backend = videoio.default_backend()
    if not nodes:
        expect(backend == "simulation", f"default_backend() is {backend!r} without a node")
        return
    devs = V4L2Driver().list_devices()
    print(f"V4L2: default_backend() = {backend!r}, capture devices {[d.id for d in devs]}",
          flush=True)
    if not devs:
        return
    src, _ = V4L2Driver().open_simple(devs[0].id, SimpleConfig(width=640, height=480))
    try:
        cfg = src.resolved_config()
        seqs = []
        for _ in range(5):
            f = src.next_frame()
            expect((f.width, f.height) == (cfg.width, cfg.height) and f.data.size > 0,
                   f"V4L2 frame {f.width}x{f.height}, {f.data.size} bytes")
            seqs.append(f.sequence)
        expect(seqs == sorted(seqs), f"V4L2 sequences {seqs}")
        print(f"V4L2: 5 frames {cfg.width}x{cfg.height} {cfg.pixel_format}, sequences {seqs}",
              flush=True)
    finally:
        src.close()


def run_slice() -> dict:
    """Phase 3n: the slice's ops at 1080p, the xla_fused headline, the
    native ring and V4L2. Returns the launches of the phase's run."""
    from rustcv_tpu_torch import imgproc
    from rustcv_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    check_slice_ops(imgproc)
    ops_counts = kernels.launch_counts()
    expect(ops_counts["harris_response_i32"] > 0, "good_features_to_track never launched K6")
    headline = run_xla_fused_headline()
    run_native_ring()
    run_v4l2()
    return {k: ops_counts[k] + headline[k] for k in ops_counts}


def time_slice(smi: str) -> None:
    """Phase 4n: ms per call of each slice call on the 1080p CUDA Mat (CUDA
    events, 20 calls), slowest first; the xla_fused headline's ms/tick
    beside the default mode's, in turns; ms per Camera read of the native
    ring at 1080p, the host decode and the card's (host clock, 20 reads,
    unpaced)."""
    import torch

    from rustcv_tpu_torch import imgproc
    from rustcv_tpu_torch.capture import Camera
    from rustcv_tpu_torch.prelude import Mat

    mats = slice_mats()
    times = {}
    for name, (call, _tol, kind) in slice_calls(imgproc).items():
        times[name] = cuda_ms(lambda: call(mats[kind][0]), 20)
    pts = imgproc.good_features_to_track(mats["bgr"][1], 256) + np.float32(0.3)
    times["corner_sub_pix"] = cuda_ms(lambda: imgproc.corner_sub_pix(mats["bgr"][0], pts), 20)
    print(f"slice ms per call on a {W}x{H} CUDA Mat ({smi}), slowest first: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(times.items(), key=lambda kv: -kv[1])), flush=True)
    rects, colors = bench_overlay()
    ms = {"default": [], "xla_fused": []}
    for mode in ("default", "xla_fused", "xla_fused", "default"):
        eng = make_engine(mode)
        for _ in range(5):
            eng.tick(rects=rects, rect_colors=colors)
        ms[mode].append(cuda_ms(lambda: eng.tick(rects=rects, rect_colors=colors), 50))
        eng.close()
    set_mode("default")
    print(f"headline ms/tick ({smi}): default {ms['default'][0]:.4f}, {ms['default'][1]:.4f}; "
          f"xla_fused {ms['xla_fused'][0]:.4f}, {ms['xla_fused'][1]:.4f}", flush=True)
    src = ring_source(False)
    cam = Camera(src, None)
    try:
        reads = {}
        mat = Mat(device="cpu")
        for label, read in (("host decode", lambda: cam.read_decoded(mat)),
                            ("card decode", lambda: cam.read_decoded_device("cuda"))):
            for _ in range(2):
                read()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                read()
                torch.cuda.synchronize()
            reads[label] = (time.perf_counter() - t0) * 1e3 / 20
    finally:
        cam.close()
        src.close()
    print(f"native ring at {W}x{H}, ms per Camera read ({smi}): " + ", ".join(
        f"{k} {v:.4f}" for k, v in reads.items()), flush=True)


# Phase 3o: the second block of ops. Relative tolerances of the float
# results: norm L1's exact sum rounded once to float32 on the card (the
# host's is float64, 2**-24 apart past 2**24), float32 sums in another
# order on the card, mean_std_dev's one-pass variance E[x²] − m² (which
# cancels), and the float32 core ops.
BLOCK2_RTOL = {"norm l1": 1e-7, "norm l2": 1e-5, "mean_std_dev": 1e-4, "psnr": 1e-5,
               "magnitude": 2e-6,
               "phase": 2e-6, "phase degrees": 2e-6, "cart_to_polar": 2e-6,
               "fast_atan2": 2e-6, "cube_root": 2e-6}
BLOCK2_ATOL = 1e-5  # for angles near 0
THIN_LEVEL = 128  # the thinning mask: gray > THIN_LEVEL


def block2_sides():
    """The inputs of phase 3o on the card and the same on the host: the
    seeded 1080p BGR frame of phase 3n and its gray, a second frame (the
    first shifted), its HSV, the thresholded gray mask; as Mats (a CUDA Mat,
    a host Mat), and as tensors for the ops that take tensors (CUDA, CPU):
    both frames, a ramp blend mask, and Sobel x/y of the gray in float32;
    and the hue model of the HSV frame under the mask."""
    import torch

    from rustcv_tpu_torch.ops import color, filters, hist
    from rustcv_tpu_torch.prelude import Mat

    mats = slice_mats()
    img = mats["bgr"][1].to_numpy()
    gray = mats["gray"][1].to_numpy()
    arrays = {"bgr2": np.ascontiguousarray(np.roll(img, (13, 29), axis=(0, 1))),
              "hsv": color.bgr_to_hsv(torch.from_numpy(img)).numpy(),
              "mask": ((gray > THIN_LEVEL) * 255).astype(np.uint8)}
    ramp = np.clip(np.arange(W, dtype=np.float32) / (W - 1) * 2 - 0.5, 0, 1)
    sides = {"card": {}, "host": {}}
    for kind in ("bgr", "gray"):
        sides["card"][kind], sides["host"][kind] = mats[kind]
    for kind, a in arrays.items():
        sides["host"][kind] = Mat.from_array(a.copy(), device="cpu")
        dev = Mat.from_array(a.copy())
        dev.device()
        sides["card"][kind] = dev
    model = hist.calc_hue_hist(arrays["hsv"], arrays["mask"])  # back_project's model
    for side, device in (("card", "cuda"), ("host", "cpu")):
        t = sides[side]
        t["hue_model"] = model
        t["bgr_t"] = torch.from_numpy(img).to(device)
        t["bgr2_t"] = torch.from_numpy(arrays["bgr2"]).to(device)
        t["ramp_t"] = torch.from_numpy(np.broadcast_to(ramp, (H, W)).copy()).to(device)
        gx, gy = filters.sobel3_gray(torch.from_numpy(gray[..., 0]).to(device))
        t["gx"], t["gy"] = gx.to(torch.float32), gy.to(torch.float32)
    return sides


def block2_calls(ip) -> dict:
    """name → (call on a side of :func:`block2_sides`, tolerance): 0 for
    byte-equal, LSB where the reference documents ±1 LSB (add_weighted at
    non-dyadic weights, normalize, anisotropic_diffusion,
    multi_band_blend), "rel" for the float results (BLOCK2_RTOL)."""
    from rustcv_tpu_torch.ops import warp

    c = ((W - 1) / 2.0, (H - 1) / 2.0)
    rot = warp.get_rotation_matrix_2d(c, 30.0, 0.9)
    hom = np.array([[0.92, 0.06, 40.0], [-0.03, 0.95, 25.0], [2e-5, 4e-5, 1.0]])
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    r2 = ((xs - c[0]) ** 2 + (ys - c[1]) ** 2) / (c[0] ** 2 + c[1] ** 2)
    k = 1 + 0.12 * r2 - 0.03 * r2 * r2  # an undistortion-like radial field
    map_x = ((xs - c[0]) * k + c[0]).astype(np.float32)
    map_y = ((ys - c[1]) * k + c[1]).astype(np.float32)
    lut = (255 * (np.arange(256) / 255.0) ** 0.5).astype(np.uint8)
    calls = {
        "add": (lambda s: ip.add(s["bgr"], s["bgr2"]), 0),
        "subtract": (lambda s: ip.subtract(s["bgr"], s["bgr2"]), 0),
        "absdiff": (lambda s: ip.absdiff(s["bgr"], s["bgr2"]), 0),
        "add_weighted dyadic": (lambda s: ip.add_weighted(s["bgr"], 0.75, s["bgr2"], 0.25, 2.0), 0),
        "add_weighted": (lambda s: ip.add_weighted(s["bgr"], 0.3, s["bgr2"], 0.6, 7.0), LSB),
        "convert_scale_abs": (lambda s: ip.convert_scale_abs(s["bgr"], -1.3, 40.0), 0),
        "bitwise_and": (lambda s: ip.bitwise_and(s["bgr"], s["bgr2"]), 0),
        "bitwise_or": (lambda s: ip.bitwise_or(s["bgr"], s["bgr2"]), 0),
        "bitwise_xor": (lambda s: ip.bitwise_xor(s["bgr"], s["bgr2"]), 0),
        "bitwise_not": (lambda s: ip.bitwise_not(s["bgr"]), 0),
        "count_non_zero": (lambda s: ip.count_non_zero(s["mask"]), 0),
        "norm l1": (lambda s: ip.norm(s["bgr"], "l1"), "rel"),
        "norm l2": (lambda s: ip.norm(s["bgr"], "l2"), "rel"),
        "norm inf": (lambda s: ip.norm(s["gray"], "inf"), 0),
        "mean_std_dev": (lambda s: ip.mean_std_dev(s["bgr"]), "rel"),
        "psnr": (lambda s: ip.psnr(s["bgr"], s["bgr2"]), "rel"),
        "calc_hist": (lambda s: ip.calc_hist(s["bgr"]), 0),
        "equalize_hist": (lambda s: ip.equalize_hist(s["gray"]), 0),
        "lut": (lambda s: ip.lut(s["bgr"], lut), 0),
        "apply_color_map": (lambda s: ip.apply_color_map(s["gray"], "jet"), 0),
        "clahe": (lambda s: ip.clahe(s["gray"], 40, (8, 8)), 0),
        "back_project": (lambda s: ip.back_project(s["hsv"], s["hue_model"]), 0),
        "remap": (lambda s: ip.remap(s["bgr"], map_x, map_y), 0),
        "remap replicate": (lambda s: ip.remap(s["bgr"], map_x, map_y, "replicate"), 0),
        "warp_polar": (lambda s: ip.warp_polar(s["bgr"], c, 540.0, (720, 540)), 0),
        "warp_polar inverse": (lambda s: ip.warp_polar(s["bgr"], c, 540.0, (H, W), False, True),
                               0),
        "thinning": (lambda s: ip.thinning(s["mask"]), 0),
        "anisotropic_diffusion": (lambda s: ip.anisotropic_diffusion(s["bgr"], niters=10), LSB),
        "multi_band_blend": (lambda s: ip.multi_band_blend(s["bgr_t"], s["bgr2_t"], s["ramp_t"], 5),
                             LSB),
        "magnitude": (lambda s: ip.magnitude(s["gx"], s["gy"]), "rel"),
        "phase": (lambda s: ip.phase(s["gx"], s["gy"]), "rel"),
        "phase degrees": (lambda s: ip.phase(s["gx"], s["gy"], True), "rel"),
        "cart_to_polar": (lambda s: ip.cart_to_polar(s["gx"], s["gy"]), "rel"),
        "fast_atan2": (lambda s: ip.fast_atan2(s["gy"], s["gx"]), "rel"),
        "cube_root": (lambda s: ip.cube_root(s["gx"] * s["gy"]), "rel"),
    }
    for kind in ("minmax", "l1", "l2", "inf"):
        alpha = {"minmax": 20.0, "l1": 2.5e8, "l2": 2.5e5, "inf": 240.0}[kind]
        calls[f"normalize {kind}"] = (
            lambda s, a=alpha, k=kind: ip.normalize(s["bgr"], a, 230.0, k), LSB)
    for mode in ("bilinear", "nearest"):
        for border in ("constant", "replicate"):
            calls[f"warp_affine {mode} {border}"] = (
                lambda s, m=mode, b=border: ip.warp_affine(s["bgr"], rot, (W, H), m, b), 0)
            calls[f"warp_perspective {mode} {border}"] = (
                lambda s, m=mode, b=border: ip.warp_perspective(s["bgr"], hom, (W, H), m, b), 0)
    return calls


def _block2_plain(x):
    """A result as numpy for the comparison: a Mat's bytes, a tensor's
    values, a number as a 0-dim array; a tuple of them as a tuple."""
    if isinstance(x, tuple):
        return tuple(_block2_plain(v) for v in x)
    if hasattr(x, "to_numpy"):
        return x.to_numpy()
    if hasattr(x, "cpu"):
        return x.cpu().numpy()
    return np.asarray(x)


def _on_card(x) -> bool:
    if isinstance(x, tuple):
        return all(_on_card(v) for v in x)
    if hasattr(x, "is_on_device"):
        return x.is_on_device and x.device().is_cuda
    if hasattr(x, "is_cuda"):
        return x.is_cuda
    return True  # a number or a numpy array, as the reference returns


def _block2_err(name, got, want, tol) -> float:
    if isinstance(want, tuple):
        return max(_block2_err(name, g, w, tol) for g, w in zip(got, want))
    expect(got.shape == want.shape and got.dtype == want.dtype,
           f"{name}: {got.shape} {got.dtype} != {want.shape} {want.dtype}")
    if tol == "rel":
        g, w = got.astype(np.float64), want.astype(np.float64)
        rtol = BLOCK2_RTOL[name]
        ok = np.abs(g - w) <= BLOCK2_ATOL + rtol * np.abs(w)
        expect(bool(ok.all()), f"{name}: {int((~ok).sum())} values beyond rtol {rtol}")
        return float((np.abs(g - w) / (BLOCK2_ATOL + np.abs(w))).max(initial=0))
    err = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max(initial=0))
    expect(err <= tol, f"{name}: max |diff| {err} > {tol}")
    return err


def run_block2() -> dict:
    """Phase 3o: every call of :func:`block2_calls` on the 1080p card inputs
    against the same call on the host inputs (the CPU port: a host Mat
    takes the reference's numpy form, a CPU tensor the port's op). Results
    stay on the card until the comparison (a Mat on the card, a CUDA
    tensor; only numbers and ``calc_hist``'s counts come back, as the
    reference returns them). Prints the largest difference of each call
    that is not byte-equal and the thinning's passes. Returns the launches
    of the card's calls (no kernel runs here)."""
    import torch

    from rustcv_tpu_torch import imgproc
    from rustcv_tpu_torch.ops import kernels, morphx

    sides = block2_sides()
    calls = block2_calls(imgproc)
    kernels.reset_launch_counts()
    got = {name: call(sides["card"]) for name, (call, _tol) in calls.items()}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    diffs = {}
    for name, (call, tol) in calls.items():
        expect(_on_card(got[name]), f"{name}: the result left the card")
        err = _block2_err(name, _block2_plain(got[name]), _block2_plain(call(sides["host"])), tol)
        if err:
            diffs[name] = err
    mask = sides["card"]["mask"].device()[..., 0]
    _, passes = morphx.thinning_passes(mask)
    print(f"second block at {W}x{H}: {len(calls)} calls on the card == the CPU port; "
          f"thinning took {passes} double passes; largest differences: " + ", ".join(
              f"{k} {v:.3g}" for k, v in sorted(diffs.items())), flush=True)
    return counts


def time_block2(smi: str) -> None:
    """Phase 4o: ms per call of each phase-3o call on the 1080p card inputs
    (CUDA events, 20 calls), slowest first. Never gated."""
    from rustcv_tpu_torch import imgproc

    sides = block2_sides()
    times = {name: cuda_ms(lambda c=call: c(sides["card"]), 20)
             for name, (call, _tol) in block2_calls(imgproc).items()}
    print(f"second block ms per call on {W}x{H} card inputs ({smi}), slowest first: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(times.items(), key=lambda kv: -kv[1])), flush=True)


# Phase 3p: group 2 of the ops, features and flow. The frame of phase 3n,
# its gray, and the gray moved by a known small affine motion (G2_MOTION,
# source → destination, the convention of warp_affine_numpy). Each call
# runs on the card inputs in this process and on the host inputs in a pool
# of spawned CPU workers at the same time; the host side is a host Mat
# (the reference's numpy form) or, where that float64 form takes minutes at
# 1080p, the port's tensor op on the CPU ("C" below).
G2_MOTION = np.array([[1.0, 0.0005, 2.6], [-0.0005, 1.0, -1.4]])
G2_WORKERS = 4
G2_SVM_SEED, G2_OBS_SEED, G2_PLANE_SEED, G2_PTS_SEED = 40, 41, 42, 43
G2_TEMPLATES = {24: (500, 900), 64: (300, 1200)}  # side → (y, x) of the cut
G2_LK_POINTS, G2_BRIEF_POINTS, G2_EDGE_POINTS = 1000, 512, 40
# Phase 4p's timed calls: 10, after one untimed call; those with a host
# stage of seconds (already run in phase 3p) fewer and without it.
G2_REPS = {"sift 720p": 1, "akaze 720p": 1, "asift 640x480": 1, "ecc affine": 2,
           "ecc homography": 2, "calc_optical_flow_pyr_lk": 3, "orb_features": 3,
           "calc_optical_flow_dis refine": 3, "denoise_tvl1": 3, "brief match": 3}


def g2_points(n: int, seed: int) -> np.ndarray:
    """n seeded (x, y) points over the frame and G2_EDGE_POINTS more inside
    16 px of the four edges (a quarter each), float32."""
    rng = np.random.default_rng(seed)
    inner = np.stack([rng.uniform(0, W - 1, n), rng.uniform(0, H - 1, n)], 1)
    k = G2_EDGE_POINTS // 4
    d = rng.uniform(0, 16, (4, k))
    xs, ys = rng.uniform(0, W - 1, (2, k)), rng.uniform(0, H - 1, (2, k))
    edge = np.concatenate([np.stack([d[0], ys[0]], 1), np.stack([W - 1 - d[1], ys[1]], 1),
                           np.stack([xs[0], d[2]], 1), np.stack([xs[1], H - 1 - d[3]], 1)])
    return np.concatenate([inner, edge]).astype(np.float32)


def g2_moved(pts: np.ndarray) -> np.ndarray:
    """Points under G2_MOTION."""
    return (pts @ G2_MOTION[:, :2].T + G2_MOTION[:, 2]).astype(np.float32)


def group2_sides(side: str) -> dict:
    """Phase 3p's inputs on one side: "card" (CUDA Mats and tensors) or
    "host" (host Mats, and CPU-tensor Mats and CPU tensors for the "C"
    calls). gray2 is gray moved by G2_MOTION (replicate border); obs are
    three noisy copies of gray; plane a unit-normal float32 1080×1920
    plane; gray720 and gray480 the gray test pattern at 1280×720 and
    640×480."""
    import torch

    from rustcv_tpu_torch.capture.simulation import synth_bgr
    from rustcv_tpu_torch.ops.color import bgr_to_gray
    from rustcv_tpu_torch.ops.warp import warp_affine_numpy
    from rustcv_tpu_torch.prelude import Mat

    card = side == "card"
    dev = "cuda" if card else "cpu"
    img = synth_bgr(W, H, 11)
    img[::5] = np.random.default_rng(12).integers(0, 256, img[::5].shape, np.uint8)
    gray = bgr_to_gray(torch.from_numpy(img)).numpy()
    gray2 = warp_affine_numpy(gray, G2_MOTION, (W, H), border="replicate")
    rng = np.random.default_rng(G2_OBS_SEED)
    obs = [np.clip(gray + rng.normal(0, 20, gray.shape), 0, 255).astype(np.uint8)
           for _ in range(3)]
    small = {f"gray{h}": bgr_to_gray(torch.from_numpy(synth_bgr(w, h, 11))).numpy()
             for w, h in ((1280, 720), (640, 480))}

    def mat(a):  # a card Mat, or a host Mat (the reference's numpy form)
        if card:
            m = Mat.from_array(a[..., None].copy())
            m.device()
            return m
        return Mat.from_array(a[..., None].copy(), device="cpu")

    def tmat(a):  # a card Mat, or a CPU-tensor Mat (the port's tensor op)
        return mat(a) if card else Mat.from_device(torch.from_numpy(a.copy()))

    s = {"host": not card, "gray": mat(gray), "gray2": mat(gray2), "gray_c": tmat(gray),
         "gray2_c": tmat(gray2), "obs_c": [tmat(o) for o in obs],
         "gray_t": torch.from_numpy(gray).to(dev), "gray2_t": torch.from_numpy(gray2).to(dev),
         "gray_np": gray, "dev": dev,
         "plane_t": torch.from_numpy(np.random.default_rng(G2_PLANE_SEED).normal(
             0, 1, (H, W)).astype(np.float32)).to(dev)}
    for n, (y, x) in G2_TEMPLATES.items():
        s[f"tmpl{n}_c"] = tmat(gray[y:y + n, x:x + n])
    for k, a in small.items():
        s[k] = mat(a)
        s[k + "_np"] = a
    return s


def _g2_brief_match(ip, s):
    pts = g2_points(G2_BRIEF_POINTS - G2_EDGE_POINTS, G2_PTS_SEED)
    d1, v1 = ip.compute_brief(s["gray"], pts)
    d2, v2 = ip.compute_brief(s["gray2"], g2_moved(pts))
    import torch

    on = (lambda a: torch.from_numpy(a).to(s["dev"])) if not s["host"] else (lambda a: a)
    return d1, v1, d2, v2, ip.match_descriptors(on(d1), on(d2), on(v1), on(v2))


def group2_calls(ip) -> dict:
    """name → (call on a side of :func:`group2_sides`, check). A check takes
    (name, card result, host result) as numpy and raises on a mismatch;
    it returns the largest difference, or a note."""
    from rustcv_tpu_torch.ops import asift, hog

    svm = np.random.default_rng(G2_SVM_SEED).normal(0, 0.05, 3780).astype(np.float32)
    lk_pts = g2_points(G2_LK_POINTS, G2_PTS_SEED + 1)
    calls = {}
    for k in (3, 5):
        calls[f"spatial_gradient k{k}"] = (lambda s, k=k: ip.spatial_gradient(s["gray_t"], k),
                                           g2_exact)
        calls[f"corner_min_eigen_val k{k}"] = (
            lambda s, k=k: ip.corner_min_eigen_val(s["gray_t"], 3, k), g2_scaled(3e-6))
        calls[f"corner_eigen_vals_and_vecs k{k}"] = (
            lambda s, k=k: ip.corner_eigen_vals_and_vecs(s["gray_t"], 3, k)[..., :2],
            g2_scaled(3e-6))
        calls[f"pre_corner_detect k{k}"] = (lambda s, k=k: ip.pre_corner_detect(s["gray_t"], k),
                                            g2_scaled(3e-6))
    calls["fast_corners"] = (lambda s: ip.fast_corners(s["gray"], 20, max_corners=8192), g2_exact)
    calls["orb_features"] = (lambda s: ip.orb_features(s["gray"], 512, 20), g2_orb)
    calls["brief match"] = (lambda s: _g2_brief_match(ip, s), g2_exact)
    calls["calc_optical_flow_pyr_lk"] = (  # the host adds g2_lk's stability tracks
        lambda s: ip.calc_optical_flow_pyr_lk(s["gray"], s["gray2"], lk_pts, 21, 3, 10) + (
            (ip.calc_optical_flow_pyr_lk(s["gray"], s["gray2"], lk_pts, 21, 3, 11)[0],
             ip.calc_optical_flow_pyr_lk(s["gray"], s["gray2"], lk_pts + G2_LK_NUDGE, 21, 3,
                                         10)[0]) if s["host"] else ()), g2_lk)
    calls["calc_optical_flow_farneback"] = (
        lambda s: ip.calc_optical_flow_farneback(s["gray_c"], s["gray2_c"]), g2_flow(1e-3, 0.05, 0))
    calls["calc_optical_flow_dis"] = (
        lambda s: ip.calc_optical_flow_dis(s["gray_c"], s["gray2_c"], 1),
        g2_flow(None, 0.05, 16, True))
    calls["calc_optical_flow_dis refine"] = (
        lambda s: ip.calc_optical_flow_dis(s["gray_c"], s["gray2_c"], 1, refine=True),
        g2_flow(None, 0.05, 16, True))
    calls["denoise_tvl1"] = (lambda s: ip.denoise_tvl1(s["obs_c"], 1.0, 30), g2_lsb(1))
    for n, (y, x) in G2_TEMPLATES.items():
        for m in ("ccoeff_normed", "ccorr_normed", "sqdiff"):
            calls[f"match_template {n} {m}"] = (
                lambda s, n=n, m=m: ip.match_template(s["gray_c"], s[f"tmpl{n}_c"], m),
                g2_template(m, (x, y)))
    for win in (True, False):
        calls["phase_correlate" + ("" if win else " no window")] = (
            lambda s, win=win: ip.phase_correlate(s["gray"], s["gray2"], win), g2_close(1e-3))
    calls["dft"] = (lambda s: ip.dft(s["plane_t"]), g2_scaled(2e-5, floor=0.0))
    calls["idft"] = (lambda s: ip.idft(ip.dft(s["plane_t"])).real, g2_close(1e-3))
    calls["dct"] = (lambda s: ip.dct(s["plane_t"]), g2_close(1e-4))
    calls["idct"] = (lambda s: ip.idct(ip.dct(s["plane_t"])), g2_close(1e-4))
    for motion in ("affine", "homography"):
        calls[f"ecc {motion}"] = (
            lambda s, m=motion: ip.find_transform_ecc(s["gray_t"], s["gray2_t"], m, iterations=50,
                                                      backend="device"), g2_ecc)
    calls["hog_descriptor"] = (lambda s: ip.hog_descriptor(s["gray"]), g2_close(2e-4))
    calls["hog score map"] = (
        lambda s: hog.hog_score_map_numpy(s["gray_np"], svm, 0.1) if s["host"]
        else hog.hog_score_map(s["gray_t"], svm, 0.1), g2_close(1e-2))
    calls["sift 720p"] = (lambda s: ip.sift_features(s["gray720"]), g2_keypoints("count"))
    calls["akaze 720p"] = (lambda s: ip.akaze_features(s["gray720"]), g2_keypoints("shared"))
    calls["asift 640x480"] = (
        lambda s: asift.affine_detect_and_compute(s["gray480_np"], double_image=False,
                                                  use_device=not s["host"]),
        g2_keypoints("count"))
    return calls


# -- phase 3p's checks: the reference's own tolerances ------------------------

def _g2_pair(name, got, want):
    expect(got.shape == want.shape and got.dtype == want.dtype,
           f"{name}: {got.shape} {got.dtype} != {want.shape} {want.dtype}")


def g2_exact(name, got, want):
    if isinstance(want, tuple):
        return max(g2_exact(name, g, w) for g, w in zip(got, want))
    _g2_pair(name, got, want)
    expect(np.array_equal(got, want), f"{name}: not equal")
    return 0


def g2_scaled(rel, floor=1.0):
    """|Δ| <= rel · max(floor, max |host|), per array (the corner responses
    and the spectra)."""
    def check(name, got, want):
        if isinstance(want, tuple):
            return max(check(name, g, w) for g, w in zip(got, want))
        _g2_pair(name, got, want)
        scale = max(floor, float(np.abs(want).max()))
        err = float(np.abs(got.astype(np.complex128) - want).max())
        expect(err <= rel * scale, f"{name}: max |diff| {err:.3g} > {rel} x {scale:.4g}")
        return err / scale
    return check


def g2_close(atol):
    def check(name, got, want):
        if isinstance(want, tuple):
            return max(check(name, np.asarray(g), np.asarray(w)) for g, w in zip(got, want))
        got, want = np.asarray(got), np.asarray(want)
        expect(got.shape == want.shape, f"{name}: {got.shape} != {want.shape}")
        err = float(np.abs(got.astype(np.float64) - want).max(initial=0))
        expect(err <= atol, f"{name}: max |diff| {err:.3g} > {atol}")
        return err
    return check


def g2_lsb(tol):
    def check(name, got, want):
        got, want = np.squeeze(got), np.squeeze(want)
        _g2_pair(name, got, want)
        err = int(np.abs(got.astype(np.int64) - want).max(initial=0))
        expect(err <= tol, f"{name}: max |diff| {err} > {tol}")
        return err
    return check


def g2_true_flow(h: int, w: int) -> np.ndarray:
    """The flow of G2_MOTION: gray2(M p) = gray(p), so I1(p + u) = I0(p)
    with u = M p − p, [h, w, 2]."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    m = G2_MOTION
    return np.stack([m[0, 0] * xs + m[0, 1] * ys + m[0, 2] - xs,
                     m[1, 0] * xs + m[1, 1] * ys + m[1, 2] - ys], -1)


def g2_flow(q99, mx, border, determined=False):
    """max |Δ| < mx (and the 99th percentile < q99) away from ``border``;
    with ``determined``, only where the host's flow is within 0.1 px of
    G2_MOTION's. DIS fails on about 45 % of this frame's pixels (its 8×8
    patches hop whole periods of the 5-row noise); there the card's and the
    CPU's float32 hops part, and the share beyond mx is only reported."""
    def check(name, got, want):
        _g2_pair(name, got, want)
        sl = np.s_[border:got.shape[0] - border, border:got.shape[1] - border]
        d = np.abs(got[sl] - want[sl]).max(-1)
        note = ""
        if determined:
            ok = np.hypot(*np.moveaxis(want[sl] - g2_true_flow(*want.shape[:2])[sl], -1, 0)) < 0.1
            expect(ok.mean() > 0.05, f"{name}: the host's flow is determined at {ok.mean():.3f}")
            note = (f" on the {ok.mean():.3f} determined; {(d[~ok] >= mx).mean():.4f} of the "
                    f"others beyond {mx}, max {d[~ok].max(initial=0):.3g}")
            d = d[ok]
        expect(d.max() < mx, f"{name}: max |diff| {d.max():.3g} px >= {mx}{note}")
        if q99 is not None:
            expect(np.quantile(d, 0.99) < q99, f"{name}: 99th pct {np.quantile(d, 0.99):.3g}")
        return f"{d.max():.3g}{note}"
    return check


G2_LK_NUDGE = np.float32([1e-3, -1e-3])  # px: the start offset of g2_lk's stability test


def g2_lk(name, got, want):
    """Status equal at every point; within 1e-3 px (the reference's
    device-vs-oracle tolerance, which its test holds on well-tracked
    points) at every point whose host track is stable: its 10th and 11th
    steps within 1e-4 px, and started G2_LK_NUDGE away it ends within
    5e-4 px of the same place. On this frame a window can hop between rows
    of the 5-row noise period at a coarse level; such a track depends on
    the last bits of its arithmetic, and float32 and float64 part there by
    whole periods: those points' largest difference is only reported."""
    (pts, st), (wpts, wst, wpts11, wnudged) = got, want
    expect(np.array_equal(st, wst), f"{name}: status differs at {int((st != wst).sum())} points")
    stable = ((np.abs(wpts - wpts11).max(1) < 1e-4)
              & (np.abs(wnudged - G2_LK_NUDGE - wpts).max(1) < 5e-4))
    expect(stable.sum() > 0.5 * len(stable), f"{name}: only {int(stable.sum())} stable points")
    d = np.abs(pts - wpts).max(1)
    err = float(d[stable].max())
    expect(err < 1e-3, f"{name}: max |diff| {err:.3g} px on stable points "
                       f"({int((d[stable] >= 1e-3).sum())} of {int(stable.sum())} beyond 1e-3)")
    return (f"{err:.3g} px on {int(stable.sum())} stable points, "
            f"{float(d[~stable].max(initial=0)):.3g} on {int((~stable).sum())} others "
            f"({int((d[~stable] >= 1e-3).sum())} beyond 1e-3)")


def g2_orb(name, got, want):
    g2_exact(name, (got[0], got[2], got[3]), (want[0], want[2], want[3]))
    err = float(np.abs(got[1] - want[1]).max())
    expect(err < 1e-3, f"{name}: angles {err:.3g} rad apart")
    return err


def g2_template(method, source):
    def check(name, got, want):
        _g2_pair(name, got, want)
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(got - want).max()) / scale
        expect(err < 1e-4, f"{name}: max |diff| / scale {err:.3g}")
        from rustcv_tpu_torch.ops.template import min_max_loc

        i = 2 if method == "sqdiff" else 3
        expect(min_max_loc(got)[i] == min_max_loc(want)[i] == source,
               f"{name}: extremum at {min_max_loc(got)[i]}, {min_max_loc(want)[i]}, not {source}")
        return err
    return check


def g2_ecc(name, got, want):
    drho = abs(float(got[0]) - float(want[0]))
    dw = float(np.abs(np.asarray(got[1]) - np.asarray(want[1])).max())
    expect(drho < 1e-3 and dw < 0.05, f"{name}: rho {got[0]} vs {want[0]}, warp |diff| {dw:.3g}")
    return dw


def g2_keypoints(rule):
    """SIFT and ASIFT: counts within max(3, 15 %) (tests/test_sift.py);
    AKAZE: over 90 % of the keypoints (rounded to 0.1 px) shared with the
    host's (tests/test_akaze.py)."""
    def check(name, got, want):
        kg, kw = got[0], want[0]
        sg = {tuple(np.round(k[:2], 1)) for k in kg}
        sw = {tuple(np.round(k[:2], 1)) for k in kw}
        shared = len(sg & sw) / max(1, len(sg), len(sw))
        if rule == "count":
            expect(abs(len(kg) - len(kw)) <= max(3, 0.15 * len(kw)) and len(kw) > 0,
                   f"{name}: {len(kg)} keypoints on the card, {len(kw)} on the host")
        else:
            expect(shared > 0.9 and len(kw) > 0, f"{name}: {shared:.3f} shared of {len(kw)}")
        return f"{len(kg)}/{len(kw)} keypoints, {shared:.3f} shared"
    return check


def _g2_plain(x):
    if isinstance(x, tuple):
        return tuple(_g2_plain(v) for v in x)
    if hasattr(x, "to_numpy"):
        return x.to_numpy()
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return x if isinstance(x, np.ndarray) else np.asarray(x)


_G2_HOST = {}  # a worker's host inputs and calls, made at its first call


def group2_host(name: str):
    """One call of phase 3p on the host inputs, in a worker process: the
    result as numpy, and its seconds."""
    import torch

    if not _G2_HOST:
        torch.set_num_threads(2)
        from rustcv_tpu_torch import imgproc

        _G2_HOST["sides"] = group2_sides("host")
        _G2_HOST["calls"] = group2_calls(imgproc)
    t0 = time.perf_counter()
    out = _g2_plain(_G2_HOST["calls"][name][0](_G2_HOST["sides"]))
    return out, time.perf_counter() - t0


def run_group2() -> dict:
    """Phase 3p: every call of :func:`group2_calls` on the 1080p card inputs
    (720p and 480p for SIFT, AKAZE and ASIFT) against the same call on the
    host inputs, computed meanwhile by G2_WORKERS spawned CPU processes
    (stopped before this returns). Prints each call's largest difference
    and the known answers. Returns the launches of the card's calls (no
    kernel runs here)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from rustcv_tpu_torch import imgproc
    from rustcv_tpu_torch.ops import kernels

    calls = group2_calls(imgproc)
    heavy = ["ecc affine", "ecc homography", "asift 640x480", "sift 720p", "akaze 720p",
             "denoise_tvl1", "calc_optical_flow_dis refine", "calc_optical_flow_pyr_lk"]
    order = heavy + [n for n in calls if n not in heavy]
    pool = ProcessPoolExecutor(max_workers=G2_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = {name: pool.submit(group2_host, name) for name in order}
        sides = group2_sides("card")
        kernels.reset_launch_counts()
        got = {}
        for name, (call, _check) in calls.items():
            got[name] = call(sides)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        notes, host_s = {}, {}
        for name, (call, check) in calls.items():
            want, host_s[name] = futures[name].result(timeout=600)
            notes[name] = check(name, _g2_plain(got[name]), want)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    lk_pts = g2_points(G2_LK_POINTS, G2_PTS_SEED + 1)
    nxt, st = _g2_plain(got["calc_optical_flow_pyr_lk"])
    lk_err = np.abs(nxt - g2_moved(lk_pts))[st]
    flow = (_g2_plain(got["calc_optical_flow_farneback"]) - g2_true_flow(H, W))[100:-100, 100:-100]
    d, _ = _g2_plain(got["phase_correlate"])
    print(f"group 2 at {W}x{H}: {len(calls)} calls on the card == the CPU port; largest "
          f"differences: " + ", ".join(f"{k} {v:.3g}" if not isinstance(v, str) else f"{k} {v}"
                                       for k, v in notes.items()), flush=True)
    print(f"group 2 known answers (motion {G2_MOTION.tolist()}): LK {int(st.sum())}/{len(st)} "
          f"tracked, median |error| {np.median(lk_err):.4f} px; Farneback median |error| "
          f"{np.median(np.hypot(flow[..., 0], flow[..., 1])):.4f} px; phase correlation "
          f"{d[0]:.4f}, {d[1]:.4f}; ECC affine warp {np.round(got['ecc affine'][1], 4).tolist()}, "
          f"rho {got['ecc affine'][0]:.4f}; host seconds per call: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(host_s.items(), key=lambda kv: -kv[1])[:6]),
          flush=True)
    return counts


def time_group2(smi: str) -> None:
    """Phase 4p: ms per call of each phase-3p call on the card inputs (CUDA
    events; G2_REPS calls for those with a host stage, else 10), slowest
    first, with the card's name and power limit. Never gated."""
    from rustcv_tpu_torch import imgproc

    sides = group2_sides("card")
    times = {name: cuda_ms(lambda c=call: c(sides), G2_REPS.get(name, 10), name not in G2_REPS)
             for name, (call, _check) in group2_calls(imgproc).items()}
    print(f"group 2 ms per call on card inputs ({smi}), slowest first: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(times.items(), key=lambda kv: -kv[1])), flush=True)


# Phase 3q: group 3 (stateful analytics) and the segmentation head of group
# 4. The frame of phase 3n, a 16-frame clip made from it with numpy (a
# textured 64×64 bright square moving 3 px a frame, a band of rows darkened
# from frame 8 for MOG2's shadows, ±2 of noise per frame), seeded markers
# and masks. Each call runs on the card inputs here and on the host inputs
# in spawned CPU workers, as 3p's: the port's tensor op on CPU tensors for
# the device ops, the same host code for the host ops. MOG2 and KNN are
# per pixel, so the host runs them on the band of rows G3_BAND of the clip
# and holds the card's band; the ops whose host side would take minutes at
# 1080p run at G3_CROP on both sides (their 1080p times are phase 4q's).
G3_FRAMES, G3_SQUARE, G3_STEP = 16, 64, 3
G3_SQUARE_AT = (490, 300)  # (y, x) of the square in frame 0
G3_SHADOW_ROWS, G3_SHADOW_FROM = (570, 600), 8
G3_BAND = (480, 608)  # rows that hold the square's path and the shadow band
G3_CROP = (400, 200, 270, 480)  # (y, x, h, w) of the crop, 480×270
G3_MS_CROP = (400, 200, 180, 320)  # mean-shift's crop, 320×180
G3_STATIC = ((1200, 300), (1500, 700), (800, 800))  # the bank's other targets (x, y)
G3_BANK16 = 16  # phase 4q's bank
G3_KALMAN = (1024, 100)  # trackers, steps
G3_SEEDS, G3_MASK_SEED, G3_BLOB_SEED, G3_KALMAN_SEED = 50, 51, 52, 53
G3_WORKERS = 4


def group3_frame() -> np.ndarray:
    """Phase 3n's seeded 1080p BGR frame (the test pattern, every fifth
    row noise)."""
    from rustcv_tpu_torch.capture.simulation import synth_bgr

    img = synth_bgr(W, H, 11)
    img[::5] = np.random.default_rng(12).integers(0, 256, img[::5].shape, np.uint8)
    return img


def group3_clip(frame: np.ndarray) -> np.ndarray:
    """The 16-frame BGR clip [T, H, W, 3] made from ``frame``."""
    rng = np.random.default_rng(G3_SEEDS)
    tex = rng.integers(160, 256, (G3_SQUARE, G3_SQUARE, 3), np.uint8)
    y0, x0 = G3_SQUARE_AT
    out = np.empty((G3_FRAMES,) + frame.shape, np.uint8)
    for t in range(G3_FRAMES):
        f = frame.astype(np.int16) + rng.integers(-2, 3, frame.shape, np.int16)
        f = np.clip(f, 0, 255).astype(np.uint8)
        if t >= G3_SHADOW_FROM:
            r0, r1 = G3_SHADOW_ROWS
            f[r0:r1] = (f[r0:r1] * 0.6).astype(np.uint8)
        x = x0 + G3_STEP * t
        f[y0:y0 + G3_SQUARE, x:x + G3_SQUARE] = tex
        out[t] = f
    return out


def group3_mask() -> np.ndarray:
    """A seeded 1080p u8 mask of 300 overlapping rectangles and discs."""
    rng = np.random.default_rng(G3_MASK_SEED)
    m = np.zeros((H, W), np.uint8)
    yy, xx = np.ogrid[:H, :W]
    for _ in range(300):
        cy, cx = int(rng.integers(0, H)), int(rng.integers(0, W))
        r = int(rng.integers(4, 40))
        if rng.random() < 0.5:
            m[max(cy - r, 0):cy + r, max(cx - r // 2, 0):cx + r] = 255
        else:
            m[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 255
    return m


def group3_blobs() -> np.ndarray:
    """A seeded 1080p gray blob scene: 40 dark discs on a bright ground."""
    rng = np.random.default_rng(G3_BLOB_SEED)
    g = np.full((H, W), 220, np.uint8)
    yy, xx = np.ogrid[:H, :W]
    for _ in range(40):
        cy, cx, r = int(rng.integers(40, H - 40)), int(rng.integers(40, W - 40)), int(
            rng.integers(6, 30))
        g[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = int(rng.integers(10, 120))
    return g


def group3_markers(h: int, w: int, n: int = 12) -> np.ndarray:
    rng = np.random.default_rng(G3_SEEDS + 1)
    m = np.zeros((h, w), np.int32)
    m[rng.integers(0, h, n), rng.integers(0, w, n)] = np.arange(1, n + 1)
    return m


def _crop(a, box):
    y, x, h, w = box
    return a[..., y:y + h, x:x + w, :] if a.ndim == 3 and a.shape[-1] == 3 else a[..., y:y + h,
                                                                                  x:x + w]


def group3_sides(side: str) -> dict:
    """Phase 3q's inputs on one side: "card" (CUDA tensors and Mats) or
    "host" (CPU tensors and Mats; the BGR clip only on G3_BAND). SLIC takes
    the test pattern without its noise rows: on them the reference's host
    finish (``enforce_connectivity``) merges thousands of fragments and
    takes minutes at 480×270."""
    import torch

    from rustcv_tpu_torch.capture.simulation import synth_bgr
    from rustcv_tpu_torch.ops.color import bgr_to_gray
    from rustcv_tpu_torch.prelude import Mat

    card = side == "card"
    dev = "cuda" if card else "cpu"
    frame = group3_frame()
    clip = group3_clip(frame)
    gray_clip = bgr_to_gray(torch.from_numpy(clip)).numpy()
    band = slice(*G3_BAND)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def mat(a):
        return Mat.from_device(t(a if a.ndim == 3 else a[..., None]))

    mask, blobs = group3_mask(), group3_blobs()
    rng = np.random.default_rng(G3_KALMAN_SEED)
    n, steps = G3_KALMAN
    truth = np.cumsum(np.full((steps, n, 2), 0.5), 0) + rng.uniform(0, 500, (1, n, 2))
    s = {"host": not card, "dev": dev, "band": band if card else slice(None),
         "clip": t(clip if card else clip[:, band]),
         "gray_clip": t(gray_clip if card else gray_clip[:, band]),
         "track_clip": t(gray_clip),
         "frame_mat": mat(frame), "frame_crop_ms": t(_crop(frame, G3_MS_CROP)),
         "gray_crop": mat(_crop(gray_clip[0], G3_CROP)),
         "pattern_crop": t(_crop(synth_bgr(W, H, 11), G3_CROP)),
         "markers_crop": group3_markers(*G3_CROP[2:]),
         "mask_mat": mat(mask), "mask_t": t(mask), "mask_crop": t(_crop(mask, G3_CROP)),
         "blobs_mat": mat(blobs),
         "kalman_z": t((truth + rng.normal(0, 2.0, truth.shape)).astype(np.float32)),
         "kalman_x0": t(np.concatenate([truth[0], np.zeros((n, 2))], 1).astype(np.float32))}
    return s


def _g3_track_boxes(n_static: int):
    y0, x0 = G3_SQUARE_AT
    boxes = [(x0, y0, G3_SQUARE, G3_SQUARE)]
    boxes += [(x, y, G3_SQUARE, G3_SQUARE) for x, y in G3_STATIC[:n_static]]
    return boxes if n_static else boxes[0]


def _g3_subtract(s, which: str, gray: bool, shadows: bool):
    """A subtractor over the clip → (masks [T, band], its model in the
    band) as numpy."""
    from rustcv_tpu_torch import imgproc as ip

    frames = s["gray_clip"] if gray else s["clip"]
    sub = (ip.create_background_subtractor_mog2(detect_shadows=shadows) if which == "mog2"
           else ip.create_background_subtractor_knn())
    masks = [sub.apply(f)[s["band"]] for f in frames]
    import torch

    state = (tuple(v[:, s["band"]] for v in sub._state) if which == "mog2"
             else (sub._state.samples[:, s["band"]],))
    return torch.stack(masks), state


def _g3_track(s, mod_name: str, n_static: int):
    """Init on frame 0, step over the other 15 → per step [centres, ok,
    scores] of the bank."""
    import importlib

    import torch

    mod = importlib.import_module("rustcv_tpu_torch.ops." + mod_name)
    frames = s["track_clip"]
    st = mod.init(frames[0], _g3_track_boxes(n_static))
    rows = []
    for f in frames[1:]:
        st, ok, score = mod.step(st, f)
        rows.append(torch.cat([st.center.reshape(-1).to(torch.float64), ok.to(torch.float64),
                               score.to(torch.float64)]))
    return torch.stack(rows)


def _g3_filter_scan(s):
    from rustcv_tpu_torch.ops import kalman

    dev = s["dev"]
    import torch

    n, _ = G3_KALMAN
    a = torch.eye(4, device=dev)
    a[0, 2] = a[1, 3] = 1.0
    xs, _, _ = kalman.filter_scan(s["kalman_x0"], torch.eye(4, device=dev).repeat(n, 1, 1) * 10,
                                  s["kalman_z"], a, torch.eye(2, 4, device=dev),
                                  torch.eye(4, device=dev) * 0.01, torch.eye(2, device=dev) * 4.0)
    return xs


def group3_calls() -> dict:
    """name → (call on a side of :func:`group3_sides`, check). A check takes
    (name, card result, host result) as numpy and raises on a mismatch;
    it returns the largest difference, or a note."""
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import ccl, meanshift_filter, slic

    calls = {}
    for gray in (True, False):
        for shadows in (False, True):
            if gray and shadows:
                continue
            name = f"mog2 {'gray' if gray else 'bgr'}" + (" shadows" if shadows else "")
            calls[name] = (lambda s, g=gray, sh=shadows: _g3_subtract(s, "mog2", g, sh), g3_bgsub)
    calls["knn bgr"] = (lambda s: _g3_subtract(s, "knn", False, False), g3_bgsub)
    for mod in ("tracker", "kcf", "csrt"):
        label = "mosse" if mod == "tracker" else mod
        calls[label] = (lambda s, m=mod: _g3_track(s, m, 0), g3_track(1))
        calls[label + " bank4"] = (lambda s, m=mod: _g3_track(s, m, 3), g3_track(4))
    calls["filter_scan 1024x100"] = (_g3_filter_scan, g3_kalman)
    calls["pyr_mean_shift 320x180"] = (
        lambda s: meanshift_filter.pyr_mean_shift(s["frame_crop_ms"]), g3_mean_shift)
    calls["kmeans_quantize k8"] = (lambda s: ip.kmeans_quantize(s["frame_mat"], 8), g3_kmeans)
    calls["watershed 480x270"] = (lambda s: ip.watershed(s["gray_crop"], s["markers_crop"]),
                                  g3_exact)
    calls["slic 480x270"] = (lambda s: (slic.slic_device(s["pattern_crop"]),)
                             + ip.slic_superpixels(s["pattern_crop"]), g3_slic)
    calls["connected_components_with_stats"] = (
        lambda s: ip.connected_components_with_stats(s["mask_mat"]), g3_exact)
    calls["connected_components 8"] = (
        lambda s: ccl.connected_components(s["mask_t"], connectivity=8), g3_exact)
    calls["find_contours"] = (lambda s: tuple(ip.find_contours(s["mask_mat"])), g3_exact)
    calls["distance_transform"] = (lambda s: ip.distance_transform(s["mask_mat"]), g3_exact)
    calls["distance_transform_l2_with_labels 480x270"] = (
        lambda s: ccl.distance_transform_l2_with_labels(s["mask_crop"]), g3_exact)
    calls["detect_blobs"] = (lambda s: ip.detect_blobs(s["blobs_mat"]), g3_exact)
    calls["voronoi_seam 480x270"] = (
        lambda s: ip.voronoi_seam(s["mask_crop"], 255 - s["mask_crop"].flip(1)), g3_exact)
    return calls


# -- phase 3q's checks: the reference's own tolerances ------------------------

def g3_exact(name, got, want):
    if isinstance(want, (tuple, list)):
        expect(len(got) == len(want), f"{name}: {len(got)} parts != {len(want)}")
        for g, w in zip(got, want):
            g3_exact(name, g, w)
        return 0
    got, want = np.asarray(got), np.asarray(want)
    expect(got.shape == want.shape and np.array_equal(got, want), f"{name}: not equal")
    return 0


def g3_bgsub(name, got, want):
    """Masks equal on at least 99.99 % of pixels (a pixel on the float32
    match gate may flip), the model within 1e-4 (KNN's samples 1e-5)."""
    (masks, state), (wmasks, wstate) = got, want
    expect(masks.shape == wmasks.shape, f"{name}: {masks.shape} != {wmasks.shape}")
    differ = int((masks != wmasks).sum())
    expect(differ <= 1e-4 * masks.size, f"{name}: {differ} of {masks.size} pixels differ")
    err = max(float(np.abs(a - b).max()) for a, b in zip(state, wstate))
    expect(err <= 1e-4, f"{name}: model |diff| {err:.3g}")
    fg = float((masks > 0).mean())
    return f"{differ}/{masks.size} pixels differ, model {err:.3g}, fg share {fg:.4f}"


def g3_track(n):
    """Centres and ``ok`` equal at every step, the peak (PSR for MOSSE)
    within 5e-3 (the reference's device-vs-oracle tolerance)."""
    def check(name, got, want):
        expect(np.array_equal(got[:, :3 * n], want[:, :3 * n]),
               f"{name}: centres or ok differ: {got[-1, :3 * n]} vs {want[-1, :3 * n]}")
        err = float(np.abs(got[:, 3 * n:] - want[:, 3 * n:]).max())
        expect(err < 5e-3, f"{name}: score |diff| {err:.3g}")
        return f"{err:.3g}, ok {int(got[:, 2 * n:3 * n].sum())}/{got[:, 2 * n:3 * n].size}"
    return check


def g3_kalman(name, got, want):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    expect(err <= 1e-5, f"{name}: max |diff| / scale {err:.3g}")
    return err


def g3_mean_shift(name, got, want):
    d = np.abs(got.astype(np.int64) - want)
    share = float((d <= 1).all(-1).mean())
    expect(share >= 0.99, f"{name}: {share:.4f} of pixels within ±1")
    return f"{share:.5f} within 1, max {int(d.max())}"


def g3_kmeans(name, got, want):
    """The reference's contract (centres within 1e-3, over 99.9 % of
    labels equal) on the quantized output: the palettes within ±1 (a
    rounded centre), and over 99.9 % of pixels within ±1 (the same
    label)."""
    (img, pal), (wimg, wpal) = got, want
    dp = int(np.abs(pal.astype(np.int64) - wpal).max())
    share = float((np.abs(img.astype(np.int64) - wimg) <= 1).all(-1).mean())
    expect(dp <= 1 and share >= 0.999, f"{name}: palette |diff| {dp}, {share:.5f} of pixels "
                                       f"within 1")
    return f"palette {dp}, {share:.5f} of pixels within 1"


def g3_slic(name, got, want):
    """Raw labels: over 97 % agreement, every disagreement within 3 px of a
    host label boundary; the connected labels and their count printed."""
    raw, wraw = got[0], want[0]
    agree = float((raw == wraw).mean())
    expect(agree > 0.97, f"{name}: raw agreement {agree:.4f}")
    dis = raw != wraw
    bnd = np.zeros_like(dis)
    bnd[1:] |= wraw[1:] != wraw[:-1]
    bnd[:-1] |= wraw[1:] != wraw[:-1]
    bnd[:, 1:] |= wraw[:, 1:] != wraw[:, :-1]
    bnd[:, :-1] |= wraw[:, 1:] != wraw[:, :-1]
    for _ in range(3):
        g = bnd.copy()
        g[1:] |= bnd[:-1]
        g[:-1] |= bnd[1:]
        g[:, 1:] |= bnd[:, :-1]
        g[:, :-1] |= bnd[:, 1:]
        bnd = g
    expect(not (dis & ~bnd).any(), f"{name}: a disagreement off the boundary band")
    return f"raw agreement {agree:.5f}, {int(got[2])}/{int(want[2])} superpixels"


def _g3_plain(x):
    if isinstance(x, (tuple, list)):
        return tuple(_g3_plain(v) for v in x)
    if hasattr(x, "to_numpy"):
        return x.to_numpy()
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return x if isinstance(x, np.ndarray) else np.asarray(x)


_G3_HOST = {}  # a worker's host inputs and calls, made at its first call


def group3_host(name: str):
    """One call of phase 3q on the host inputs, in a worker process: the
    result as numpy, and its seconds."""
    import torch

    if not _G3_HOST:
        torch.set_num_threads(2)
        _G3_HOST["sides"] = group3_sides("host")
        _G3_HOST["calls"] = group3_calls()
    t0 = time.perf_counter()
    out = _g3_plain(_G3_HOST["calls"][name][0](_G3_HOST["sides"]))
    return out, time.perf_counter() - t0


def run_group3() -> dict:
    """Phase 3q: every call of :func:`group3_calls` on the card inputs
    against the same call on the host inputs, computed meanwhile by
    G3_WORKERS spawned CPU processes (stopped before this returns). Prints
    each size, each call's largest difference and the trackers' distance
    from the square's true path. Launches no kernel: returns the (zero)
    launches of the card's calls."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from rustcv_tpu_torch.ops import kernels

    calls = group3_calls()
    heavy = ["watershed 480x270", "pyr_mean_shift 320x180", "slic 480x270", "mog2 bgr shadows",
             "mog2 bgr", "voronoi_seam 480x270", "detect_blobs", "find_contours"]
    order = heavy + [n for n in calls if n not in heavy]
    pool = ProcessPoolExecutor(max_workers=G3_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = {name: pool.submit(group3_host, name) for name in order}
        sides = group3_sides("card")
        kernels.reset_launch_counts()
        got, card_s = {}, {}
        for name, (call, _check) in calls.items():
            t0 = time.perf_counter()
            got[name] = call(sides)
            torch.cuda.synchronize()
            card_s[name] = time.perf_counter() - t0
        counts = kernels.launch_counts()
        expect(not any(counts.values()), f"phase 3q launched a kernel: {counts}")
        notes, host_s = {}, {}
        for name, (call, check) in calls.items():
            want, host_s[name] = futures[name].result(timeout=600)
            notes[name] = check(name, _g3_plain(got[name]), want)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    y0, x0 = G3_SQUARE_AT
    truth = np.array([[y0 + G3_SQUARE // 2, x0 + G3_SQUARE // 2 + G3_STEP * t]
                      for t in range(1, G3_FRAMES)])
    path = {k: float(np.abs(_g3_plain(got[k])[:, :2] - truth).max())
            for k in ("mosse", "kcf", "csrt")}
    print(f"group 3 and segmentation at {W}x{H} (MOG2/KNN host side on rows {G3_BAND}, "
          f"watershed, SLIC, L2 distance and the Voronoi seam at {G3_CROP[3]}x{G3_CROP[2]}, "
          f"mean shift at {G3_MS_CROP[3]}x{G3_MS_CROP[2]}, Kalman {G3_KALMAN[0]} trackers x "
          f"{G3_KALMAN[1]} steps, {G3_FRAMES}-frame clip): {len(calls)} calls on the card == the "
          f"CPU port, no kernel launched; " + "; ".join(
              f"{k} {v:.3g}" if not isinstance(v, str) else f"{k} {v}" for k, v in notes.items()),
          flush=True)
    print("group 3 trackers' max |centre - the square's path| px: " + ", ".join(
        f"{k} {v:.0f}" for k, v in path.items()) + "; card seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(card_s.items(), key=lambda kv: -kv[1])[:6])
        + "; host seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(host_s.items(), key=lambda kv: -kv[1])[:6]), flush=True)
    return counts


def time_group3(smi: str) -> None:
    """Phase 4q: on the card (CUDA events): ms per frame of MOG2 and KNN at
    1080p, ms per ``update`` of each tracker alone and per ``step`` of a
    bank of G3_BANK16, ms per ``filter_scan`` step at 1,024 trackers, ms
    per call of the segmentation ops at 1080p (the host ones included; L2
    distance, the Voronoi seam and SLIC's host finish at 480×270), with the
    card's name and power limit, slowest first. Never gated."""
    import importlib

    import torch

    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import ccl, kalman, meanshift_filter, slic
    from rustcv_tpu_torch.prelude import Mat

    s = group3_sides("card")
    clip, gray = s["clip"], s["gray_clip"]
    times = {}
    for label, frames, make in (
            ("mog2 gray", gray, lambda: ip.create_background_subtractor_mog2()),
            ("mog2 bgr", clip, lambda: ip.create_background_subtractor_mog2()),
            ("mog2 bgr shadows", clip,
             lambda: ip.create_background_subtractor_mog2(detect_shadows=True)),
            ("knn bgr", clip, lambda: ip.create_background_subtractor_knn())):
        sub = make()
        sub.apply(frames[0])
        it = iter(range(10 ** 9))
        times[label + " per frame"] = cuda_ms(
            lambda: sub.apply(frames[1 + next(it) % (G3_FRAMES - 1)]), 30, warm=False)
    frames = s["track_clip"]
    mats = [Mat.from_device(f[..., None]) for f in frames]
    y0, x0 = G3_SQUARE_AT
    bank = [(x0 + 100 * (i % 8), y0 - 200 + 300 * (i // 8), G3_SQUARE, G3_SQUARE)
            for i in range(G3_BANK16)]
    for mod_name, cls in (("tracker", "TrackerMOSSE"), ("kcf", "TrackerKCF"),
                          ("csrt", "TrackerCSRT")):
        mod = importlib.import_module("rustcv_tpu_torch.ops." + mod_name)
        trk = getattr(mod, cls)()
        trk.init(mats[0], _g3_track_boxes(0))
        it = iter(range(10 ** 9))
        times[f"{cls} update"] = cuda_ms(lambda: trk.update(mats[1 + next(it) % 15]), 15,
                                         warm=False)
        st = [mod.init(frames[0], bank)]
        it = iter(range(10 ** 9))

        def step(st=st, mod=mod, it=it):
            st[0] = mod.step(st[0], frames[1 + next(it) % 15])[0]
        times[f"{mod_name} bank{G3_BANK16} step"] = cuda_ms(step, 15)
    n, steps = G3_KALMAN
    times[f"filter_scan step, {n} trackers"] = cuda_ms(lambda: _g3_filter_scan(s), 3) / steps
    crop = f"{G3_CROP[3]}x{G3_CROP[2]}"
    frame_t = s["frame_mat"].device()
    gray_mat = Mat.from_device(gray[0][..., None])
    markers = group3_markers(H, W)
    one = {  # label → (call, timed calls)
        "pyr_mean_shift 1080p": (lambda: meanshift_filter.pyr_mean_shift(frame_t), 1),
        "kmeans_quantize k8": (lambda: ip.kmeans_quantize(s["frame_mat"], 8), 5),
        "watershed 1080p": (lambda: ip.watershed(gray_mat, markers), 2),
        "slic_device 1080p": (lambda: slic.slic_device(frame_t), 3),
        f"slic_superpixels {crop}": (lambda: ip.slic_superpixels(s["pattern_crop"]), 2),
        "connected_components": (lambda: ip.connected_components(s["mask_mat"]), 5),
        "connected_components 8": (lambda: ccl.connected_components(s["mask_t"], connectivity=8),
                                   5),
        "connected_components_with_stats": (
            lambda: ip.connected_components_with_stats(s["mask_mat"]), 3),
        "find_contours": (lambda: ip.find_contours(s["mask_mat"]), 3),
        "distance_transform (L1)": (lambda: ip.distance_transform(s["mask_mat"]), 10),
        f"distance_transform_l2_with_labels {crop}": (
            lambda: ccl.distance_transform_l2_with_labels(s["mask_crop"]), 2),
        "detect_blobs": (lambda: ip.detect_blobs(s["blobs_mat"]), 1),
        f"voronoi_seam {crop}": (
            lambda: ip.voronoi_seam(s["mask_crop"], 255 - s["mask_crop"].flip(1)), 1),
    }
    for label, (call, reps) in one.items():
        times[label] = cuda_ms(call, reps, warm=reps > 1)
    print(f"group 3 and segmentation ms on card inputs at {W}x{H} ({smi}), slowest first: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(times.items(), key=lambda kv: -kv[1])),
          flush=True)


# Phase 3r: group 4a (Hough, stereo, NL-means, the domain-transform and
# guided filters, Poisson editing, inpainting, HDR, cascades and the host
# modules). Each call runs on the card inputs here and on the host inputs in
# spawned CPU workers, as 3q's: the port's tensor twin on CPU tensors for the
# device ops, the same host code for the host ops. Sizes: 1080p for the
# Hough transforms, the guided filter, Poisson cloning (a 200×200 patch),
# the diffusion inpaint, Mertens fusion (three exposures of the test pattern)
# and the cascade scorer; a rectified 1280×720 pair for stereo (D = 64, two
# known disparities); G4_CROP (480×270) for NL-means and the
# domain-transform family, whose host sides would take minutes at 1080p
# (their 1080p times are phase 4r's); small crops for the host modules.
G4_STEREO = (1280, 720, 64)  # width, height, disparities
G4_DISP = (12, 40)  # true disparity of the pair's left and right halves
G4_CROP = (400, 200, 270, 480)  # (y, x, h, w)
G4_SMALL = (420, 700, 120, 160)  # (y, x, h, w) of the host modules' crop
G4_CASCADE = (300, 500, 270, 480)  # (y, x, h, w): the multi-scale crop, two targets in it
G4_PAIR_CROP = (0, 0, 270, 480)  # (y, x, h, w) of the pair for the stereo wrapper
G4_CLONE = ((100, 100), 200, (960, 700))  # patch origin (y, x), side, centre (x, y)
G4_DISCS, G4_SEED = 8, 60
G4_QR = "rustcv_tpu_torch group 4a"
G4_WORKERS = 4


def group4a_sides(side: str) -> dict:
    """Phase 3r's inputs on one side: "card" (CUDA tensors and Mats) or
    "host" (CPU tensors and Mats)."""
    import torch

    from rustcv_tpu_torch.capture.simulation import synth_bgr
    from rustcv_tpu_torch.ops import cascade, filters, ghough, golden, qr
    from rustcv_tpu_torch.ops.color import bgr_to_gray
    from rustcv_tpu_torch.prelude import Mat

    dev = "cuda" if side == "card" else "cpu"
    rng = np.random.default_rng(G4_SEED)
    frame = group3_frame()
    pattern = synth_bgr(W, H, 11)
    pgray = bgr_to_gray(torch.from_numpy(pattern)).numpy()
    discs = pgray.copy()
    yy, xx = np.ogrid[:H, :W]
    for _ in range(G4_DISCS):
        cy, cx, r = int(rng.integers(60, H - 60)), int(rng.integers(60, W - 60)), int(
            rng.integers(14, 50))
        discs[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = int(rng.integers(0, 60))
    edges = filters.canny_u8(torch.from_numpy(pgray)).numpy()
    sw, sh, nd = G4_STEREO
    base = golden.gaussian5_u8(rng.integers(0, 256, (sh, sw + nd), np.uint8))
    left = np.ascontiguousarray(base[:, :sw])
    right = np.empty_like(left)
    d1, d2 = G4_DISP
    right[:, :sw // 2] = base[:, d1:sw // 2 + d1]
    right[:, sw // 2:] = base[:, sw // 2 + d2:sw + d2]
    y, x, h, w = G4_CROP
    crop = np.ascontiguousarray(frame[y:y + h, x:x + w])
    crop_gray = bgr_to_gray(torch.from_numpy(crop)).numpy()
    crop_frames = np.stack([np.clip(crop_gray.astype(np.int16) + rng.integers(
        -6, 7, crop_gray.shape, np.int16), 0, 255).astype(np.uint8) for _ in range(3)])
    exposures = np.stack([np.clip(pattern.astype(np.float32) * s, 0, 255).astype(np.uint8)
                          for s in (0.35, 1.0, 2.4)])
    (py, px), side_px, centre = G4_CLONE
    patch = np.ascontiguousarray(frame[py:py + side_px, px:px + side_px])
    hole = np.zeros((H, W), bool)  # a horizontal and a vertical scratch
    hole[H * 25 // 54:H // 2, W * 5 // 16:W * 25 // 48] = True
    hole[H * 5 // 18:H * 35 // 54, W * 5 // 8:W * 41 // 64] = True
    sy, sx, shh, sww = G4_SMALL
    small = np.ascontiguousarray(frame[sy:sy + shh, sx:sx + sww])
    small_hole = np.zeros((shh, sww), bool)
    small_hole[50:60, 30:130] = True
    win = 24
    pos = rng.integers(90, 130, (40, win, win))
    pos[:, 4:10, 3:21] = rng.integers(20, 50, (40, 6, 18))
    pos[:, 14:22, 6:18] = rng.integers(170, 220, (40, 8, 12))
    model = cascade.train_cascade(pos.astype(np.uint8),
                                  rng.integers(0, 256, (200, win, win)).astype(np.uint8),
                                  n_stages=3, n_stumps=6)
    scene = bgr_to_gray(torch.from_numpy(frame)).numpy()
    for k in range(6):  # six targets on a diagonal
        ty, tx = H * (2 + k) // 10, W * (2 + k) // 10
        scene[ty:ty + win, tx:tx + win] = pos[k]
    qr_img = qr.draw(qr.encode(G4_QR, 4, "M", 2), 6)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def mat(a):
        return Mat.from_device(t(a if a.ndim == 3 else a[..., None]))

    return {
        "dev": dev, "frame": t(frame), "frame_mat": mat(frame), "gray": t(pgray),
        "edges": t(edges), "edges_mat": mat(edges), "discs": t(discs), "discs_mat": mat(discs),
        "r_table": ghough.build_r_table(discs[H * 4 // 9:H * 4 // 9 + 64,
                                              W * 15 // 32:W * 15 // 32 + 64]),
        "left": t(left), "right": t(right), "left_mat": mat(left), "right_mat": mat(right),
        "crop": t(crop), "crop_mat": mat(crop), "crop_gray": t(crop_gray),
        "crop_gray_mat": mat(crop_gray), "crop_frames": t(crop_frames),
        "exposures": t(exposures), "exposure_mats": [mat(e) for e in exposures],
        "patch": patch, "clone_mask": np.ones((side_px, side_px), bool), "centre": centre,
        "pattern": t(pattern), "pattern_mat": mat(pattern), "hole": hole,
        "small_mat": mat(small), "small_hole": small_hole, "model": model,
        "scene": t(scene), "scene_mat": mat(scene), "qr_mat": mat(qr_img),
        "chart": _g4_chart(),
    }


def _g4_chart() -> np.ndarray:
    """The 24-patch colour checker drawn on a 300×420 card."""
    from rustcv_tpu_torch.ops.colorchecker import REFERENCE_SRGB

    img = np.full((300, 420, 3), 190, np.uint8)
    x0, y0, cw, chh, sep, frame = 60, 50, 48, 44, 6, 10
    wt, ht = 6 * cw + 7 * sep, 4 * chh + 5 * sep
    img[y0 - frame:y0 + ht + frame, x0 - frame:x0 + wt + frame] = 20
    img[y0:y0 + ht, x0:x0 + wt] = 250
    for r in range(4):
        for c in range(6):
            y, x = y0 + sep + r * (chh + sep), x0 + sep + c * (cw + sep)
            img[y:y + chh, x:x + cw] = REFERENCE_SRGB[r * 6 + c][::-1]
    return img


def group4a_calls() -> dict:
    """name → (call on a side of :func:`group4a_sides`, check). A check
    takes (name, card result, host result) as numpy and raises on a
    mismatch; it returns the largest difference, or a note."""
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import (cascade, dtfilter, ghough, hdr, hough, inpaint, nlmeans,
                                      poisson, sgbm, stereo)

    nd = G4_STEREO[2]
    c = {
        "hough_lines": (lambda s: hough.hough_lines(s["edges"], max_points=1 << 20), g3_exact),
        "hough_lines_p": (lambda s: hough.hough_lines_p(s["edges"]), g3_exact),
        "hough_circles": (lambda s: hough.hough_circles(s["discs"]), g3_exact),
        "ghough_accumulate": (lambda s: ghough.ghough_accumulate(s["discs"], s["r_table"]),
                              g3_exact),
        "stereo_bm 720p D64": (lambda s: stereo.stereo_bm(s["left"], s["right"], nd),
                               g4_disparity(1e-4)),
        "stereo_sgbm 720p D64 4 dirs": (lambda s: sgbm.stereo_sgbm(
            s["left"], s["right"], nd, num_dirs=4), g4_disparity(1e-3)),
        "stereo_sgbm 720p D64 8 dirs": (lambda s: sgbm.stereo_sgbm(s["left"], s["right"], nd),
                                        g4_disparity(1e-3)),
        "nl_means 480x270": (lambda s: nlmeans.nl_means(s["crop_gray"]), g4_within(1)),
        "nl_means_colored 480x270": (lambda s: nlmeans.nl_means_colored(s["crop"]),
                                     g4_within(1)),
        "nl_means_multi 480x270": (lambda s: nlmeans.nl_means_multi(s["crop_frames"], 1, 3),
                                   g4_within(1)),
        "dt_filter 480x270": (lambda s: dtfilter.dt_filter(s["crop"], s["crop"]),
                              g4_within(1)),
        "detail_enhance 480x270": (lambda s: dtfilter.detail_enhance(s["crop"]), g4_within(2)),
        "stylization 480x270": (lambda s: dtfilter.stylization(s["crop"]), g4_within(2)),
        "pencil_sketch 480x270": (lambda s: dtfilter.pencil_sketch(s["crop"]), g4_within(2)),
        "guided_filter": (lambda s: dtfilter.guided_filter(s["gray"], s["frame"]),
                          g4_within(1)),
        "seamless_clone normal": (lambda s: poisson.seamless_clone(
            s["patch"], s["pattern"], s["clone_mask"], s["centre"]), g4_within(1)),
        "seamless_clone mixed": (lambda s: poisson.seamless_clone(
            s["patch"], s["pattern"], s["clone_mask"], s["centre"], poisson.MIXED_CLONE),
            g4_within(1)),
        "inpaint_diffusion": (lambda s: inpaint.inpaint_diffusion(s["frame"], s["hole"]),
                              g4_within(1)),
        "merge_mertens": (lambda s: hdr.merge_mertens(s["exposures"]), g4_within(2e-3)),
        "cascade score_windows": (lambda s: cascade.score_windows_device(s["scene"], s["model"]),
                                  g4_cascade),
        "cascade_detect_multi_scale 480x270": (lambda s: ip.cascade_detect_multi_scale(
            mat_crop(s["scene_mat"], G4_CASCADE), s["model"]), g4_boxes),
        # the wrappers on a CUDA Mat (a CPU-tensor Mat on the host side)
        "imgproc.hough_circles": (lambda s: ip.hough_circles(s["discs_mat"]), g3_exact),
        "imgproc.stereo_bm 480x270": (lambda s: ip.stereo_bm(
            mat_crop(s["left_mat"], G4_PAIR_CROP), mat_crop(s["right_mat"], G4_PAIR_CROP), nd),
            g4_disparity(1e-4, (G4_DISP[0], G4_DISP[0]))),
        "imgproc.fast_nl_means_denoising 480x270": (
            lambda s: ip.fast_nl_means_denoising(s["crop_gray_mat"]), g4_within(1)),
        "imgproc.edge_preserving_filter 480x270": (
            lambda s: ip.edge_preserving_filter(s["crop_mat"]), g4_within(1)),
        "imgproc.inpaint diffusion 480x270": (lambda s: ip.inpaint(
            mat_crop(s["frame_mat"], G4_CROP), _crop(s["hole"], G4_CROP), method="diffusion"),
            g4_within(1)),
        "imgproc.merge_mertens 480x270": (lambda s: ip.merge_mertens(
            [mat_crop(m, G4_CROP) for m in s["exposure_mats"]]), g4_within(2e-3)),
        # the host modules, on CUDA Mats (downloaded by the wrappers)
        "qr_detect_and_decode": (lambda s: ip.qr_detect_and_decode(s["qr_mat"]), g4_qr),
        "detect_mser_regions 480x270": (lambda s: ip.detect_mser_regions(s["crop_gray_mat"]),
                                        g3_exact),
        "detect_line_segments 480x270": (lambda s: ip.detect_line_segments(s["crop_gray_mat"]),
                                         g3_exact),
        "grab_cut 160x120": (lambda s: ip.grab_cut(s["small_mat"], rect=(30, 20, 100, 80),
                                                   iter_count=2), g3_exact),
        "inpaint telea 160x120": (lambda s: ip.inpaint(s["small_mat"], s["small_hole"]),
                                  g3_exact),
        "color_change 160x120": (lambda s: ip.color_change(s["small_mat"], s["small_hole"]),
                                 g3_exact),
        "align_mtb 480x270": (lambda s: ip.align_mtb([mat_crop(m, G4_CROP)
                                                      for m in s["exposure_mats"]]), g3_exact),
        "merge_robertson 160x120": (lambda s: ip.merge_robertson(
            [mat_crop(m, G4_SMALL) for m in s["exposure_mats"]], np.array([0.35, 1.0, 2.4],
                                                                          np.float32)),
            g3_exact),
        "tonemap_mantiuk 160x120": (lambda s: ip.tonemap_mantiuk(
            mat_crop(s["exposure_mats"][1], G4_SMALL).to_numpy().astype(np.float32) / 64 + 0.01),
            g3_exact),
        "detect_color_checker": (lambda s: ip.detect_color_checker(s["chart"]), g3_exact),
        "IntelligentScissors 80x60": (lambda s: _g4_scissors(s["small_mat"]), g3_exact),
    }
    return c


def mat_crop(mat, box):
    """A crop (y, x, h, w) of a Mat, on its side."""
    from rustcv_tpu_torch.prelude import Mat

    y, x, h, w = box
    a = mat.device()[y:y + h, x:x + w].contiguous()
    return Mat.from_device(a)


def _g4_scissors(mat):
    from rustcv_tpu_torch import imgproc as ip

    tool = ip.IntelligentScissors().apply_image(mat.to_numpy()[:60, :80, 1])
    tool.build_map((10, 30))
    return tool.get_contour((70, 20))


# -- phase 3r's checks: the reference's own tolerances ------------------------

def g4_within(tol):
    def check(name, got, want):
        parts = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for g, w in zip(parts, wants):
            expect(g.shape == w.shape, f"{name}: {g.shape} != {w.shape}")
            err = max(err, float(np.abs(g.astype(np.float64) - w).max()))
        expect(err <= tol, f"{name}: max |diff| {err:.3g} > {tol}")
        return err
    return check


def g4_disparity(tol, truth=G4_DISP):
    """``valid`` equal, ``floor(disp + 0.5)`` equal, disparity within
    ``tol``; the note has each half's median against its true disparity."""
    def check(name, got, want):
        (d, v), (wd, wv) = got, want
        expect(np.array_equal(v, wv), f"{name}: valid differs at {int((v != wv).sum())} px")
        expect(np.array_equal(np.floor(d + 0.5), np.floor(wd + 0.5)), f"{name}: rounded differs")
        err = float(np.abs(d - wd).max())
        expect(err <= tol, f"{name}: max |diff| {err:.3g}")
        w = d.shape[1]
        halves = [np.median(d[:, a:b][v[:, a:b]]) for a, b in ((G4_STEREO[2], w // 2 - 16),
                                                                 (w // 2 + 48, w - 8))]
        return (f"{err:.3g}, valid {v.mean():.3f}, medians {halves[0]:.2f}/{halves[1]:.2f} "
                f"(true {truth[0]}/{truth[1]})")
    return check


def g4_cascade(name, got, want, eps=1e-3):
    """``ok`` equal wherever the host margin is clear of a stage threshold
    by more than ``eps`` (float32 either side); margins within 1e-3; the
    note counts the windows in the band."""
    (ok, m), (wok, wm) = got, want
    outside = np.abs(wm) > eps
    expect(np.array_equal(ok[outside], wok[outside]), f"{name}: ok differs outside the band")
    err = float(np.abs(m - wm).max())
    expect(err <= 1e-3, f"{name}: margin |diff| {err:.3g}")
    return (f"margin {err:.3g}, {int((~outside).sum())} of {ok.size} windows in the "
            f"|margin| <= {eps} band ({int((ok != wok)[~outside].sum())} of them differ), "
            f"{int(ok.sum())} pass")


def g4_boxes(name, got, want):
    (b, sc), (wb, wsc) = got, want
    expect(np.array_equal(b, wb), f"{name}: boxes differ")
    err = float(np.abs(sc - wsc).max()) if len(sc) else 0.0
    expect(err <= 1e-3, f"{name}: scores |diff| {err:.3g}")
    return f"{len(b)} boxes, scores {err:.3g}"


def g4_qr(name, got, want):
    expect(got[0] == want[0] == G4_QR, f"{name}: decoded {got[0]!r} / {want[0]!r}")
    expect(np.array_equal(got[1], want[1]), f"{name}: corners differ")
    return "decoded"


_G4_HOST = {}  # a worker's host inputs and calls, made at its first call


def group4a_host(name: str):
    """One call of phase 3r on the host inputs, in a worker process: the
    result as numpy, and its seconds."""
    import torch

    if not _G4_HOST:
        torch.set_num_threads(2)
        _G4_HOST["sides"] = group4a_sides("host")
        _G4_HOST["calls"] = group4a_calls()
    t0 = time.perf_counter()
    out = _g3_plain(_G4_HOST["calls"][name][0](_G4_HOST["sides"]))
    return out, time.perf_counter() - t0


def run_group4a() -> dict:
    """Phase 3r: every call of :func:`group4a_calls` on the card inputs
    against the same call on the host inputs, computed meanwhile by
    G4_WORKERS spawned CPU processes (stopped before this returns). Prints
    each size, each call's largest difference, the stereo medians against
    the true disparities and SGBM's scan steps. Launches no kernel: returns
    the (zero) launches of the card's calls."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from rustcv_tpu_torch.ops import kernels, sgbm

    calls = group4a_calls()
    heavy = ["stereo_sgbm 720p D64 8 dirs", "stereo_sgbm 720p D64 4 dirs", "inpaint_diffusion",
             "stereo_bm 720p D64", "seamless_clone mixed", "seamless_clone normal",
             "merge_mertens", "nl_means_colored 480x270"]
    order = heavy + [n for n in calls if n not in heavy]
    pool = ProcessPoolExecutor(max_workers=G4_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = {name: pool.submit(group4a_host, name) for name in order}
        sides = group4a_sides("card")
        kernels.reset_launch_counts()
        got, card_s, steps = {}, {}, 0
        for name, (call, _check) in calls.items():
            t0 = time.perf_counter()
            got[name] = call(sides)
            torch.cuda.synchronize()
            card_s[name] = time.perf_counter() - t0
            if name.startswith("stereo_sgbm") and name.endswith("8 dirs"):
                steps = sgbm.last_steps
        counts = kernels.launch_counts()
        expect(not any(counts.values()), f"phase 3r launched a kernel: {counts}")
        notes, host_s = {}, {}
        for name, (call, check) in calls.items():
            want, host_s[name] = futures[name].result(timeout=600)
            notes[name] = check(name, _g3_plain(got[name]), want)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    sw, sh, nd = G4_STEREO
    print(f"group 4a at {W}x{H} (stereo {sw}x{sh} D={nd}; NL-means and the domain-transform "
          f"family at {G4_CROP[3]}x{G4_CROP[2]}; the host modules at their stated sizes; clone "
          f"patch {G4_CLONE[1]}x{G4_CLONE[1]}): {len(calls)} calls on the card == the CPU port "
          f"within the reference's tolerances, no kernel launched; SGBM 8 dirs {steps} scan "
          f"steps; " + "; ".join(f"{k} {v:.3g}" if not isinstance(v, str) else f"{k} {v}"
                                 for k, v in notes.items()), flush=True)
    print("group 4a card seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(card_s.items(), key=lambda kv: -kv[1])[:8])
        + "; host seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(host_s.items(), key=lambda kv: -kv[1])[:8]), flush=True)
    return counts


def time_group4a(smi: str) -> None:
    """Phase 4r: ms per call on the card (CUDA events) of every device call
    of phase 3r at its size, and of NL-means and the domain-transform family
    at 1080p too, with the card's name and power limit, slowest first.
    Never gated."""
    from rustcv_tpu_torch.ops import color, dtfilter, nlmeans, sgbm

    s = group4a_sides("card")
    host_only = ("qr_detect_and_decode", "detect_mser", "detect_line_segments", "grab_cut",
                 "inpaint telea", "color_change", "align_mtb", "merge_robertson",
                 "tonemap_mantiuk", "detect_color_checker", "IntelligentScissors")
    reps = {"stereo_sgbm 720p D64 8 dirs": 1, "stereo_sgbm 720p D64 4 dirs": 1,
            "seamless_clone normal": 1, "seamless_clone mixed": 1, "inpaint_diffusion": 1,
            "imgproc.inpaint diffusion 480x270": 2, "nl_means_colored 480x270": 3,
            "cascade_detect_multi_scale 480x270": 2}
    times = {}
    for name, (call, _check) in group4a_calls().items():
        if name.startswith(host_only):
            continue
        times[name] = cuda_ms(lambda c=call: c(s), reps.get(name, 5))
    gray = color.bgr_to_gray(s["frame"])
    full = {"nl_means 1080p": lambda: nlmeans.nl_means(gray),
            "nl_means_colored 1080p": lambda: nlmeans.nl_means_colored(s["frame"]),
            "dt_filter 1080p": lambda: dtfilter.dt_filter(s["frame"], s["frame"]),
            "detail_enhance 1080p": lambda: dtfilter.detail_enhance(s["frame"]),
            "stylization 1080p": lambda: dtfilter.stylization(s["frame"]),
            "pencil_sketch 1080p": lambda: dtfilter.pencil_sketch(s["frame"])}
    for name, call in full.items():
        times[name] = cuda_ms(call, 2)
    sw, sh, nd = G4_STEREO
    sgbm.stereo_sgbm(s["left"], s["right"], nd)
    print(f"group 4a ms per call on card inputs ({smi}; SGBM 8 dirs {sgbm.last_steps} scan "
          f"steps at {sw}x{sh}), slowest first: " + ", ".join(
              f"{k} {v:.4f}" for k, v in sorted(times.items(), key=lambda kv: -kv[1])),
          flush=True)


# Phase 3s: group 4b, the geometry chain. The calibration path at 1080p: 8
# views of a 9×6 inner-corner board rendered under a known K and
# 5-coefficient distortion, detected with ``find_chessboard_corners`` (the
# refinement on the card) and calibrated, then detected with
# ``find_chessboard_corners_sb`` (the likelihood field and the refinement on
# the card); ``undistort`` and ``fisheye_undistort`` of a 1080p BGR frame;
# a 4×4 ArUco ``GridBoard`` warped into a 1280×720 frame, detected and
# posed; a circles grid at 640×480; ``rgbd_normals`` of a 640×480 depth
# map; ``triangle_rasterize`` of 5,000 triangles at 1280×720; two
# overlapping 640×360 crops stitched as CUDA Mats (the device composite).
# Each call runs on the card inputs here and on the host inputs in spawned
# CPU workers (the port on CPU tensors and host arrays). ``depth_to_3d``,
# ``find_planes`` and ``rgbd_odometry`` touch no tensor (numpy in and
# out): they run once, here, held to the scene's truth. The
# rasterizer's host side rasterizes only the G4B_RASTER_CROP window of the
# mesh (the triangles that reach it, shifted): at 1280×720 the CPU would
# take about a minute.
G4B_K = np.array([[1650.0, 0, 968.0], [0, 1640.0, 532.0], [0, 0, 1.0]])
G4B_DIST = np.array([-0.16, 0.05, 0.0007, -0.0011, -0.008])
G4B_FISH = np.array([0.04, -0.01, 0.002, -0.0004])
G4B_SQ, G4B_BOARD, G4B_VIEWS = 0.03, (10, 7), 8  # square (m), squares (cols, rows), views
G4B_PATTERN = (G4B_BOARD[0] - 1, G4B_BOARD[1] - 1)
G4B_MARKERS = (1280, 720)
G4B_MARKER_POSE = (np.array([0.25, -0.2, 0.1]), np.array([-0.09, -0.08, 0.55]))
G4B_CIRCLES = ((4, 11), (640, 480))  # asymmetric pattern (cols, rows), image size
G4B_DEPTH_K = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1.0]])
G4B_PLANES = ((np.array([0.0, 0, -1]), -3.0), (np.array([-1.0, 0, -0.2]), -2.0),
              (np.array([0.0, -1, -0.1]), -1.2))  # the depth scene: n·p = d, a floor and 2 walls
G4B_MOTION = (np.array([0.01, -0.02, 0.005]), np.array([0.01, 0.005, -0.02]))
G4B_MESH = (5000, 1280, 720)  # triangles, width, height
G4B_RASTER_CROP = (480, 270, 320, 180)  # (x, y, w, h)
G4B_STITCH = ((300, 200), (300, 600), (640, 360))  # crop origins (y, x), size (w, h)
G4B_WORKERS = 4


def _g4b_board_view(rv, tv, seed: int, dev) -> np.ndarray:
    """One 1080p view of the board at pose (rv, tv) under (G4B_K,
    G4B_DIST): each pixel's ideal ray (10 fixed-point undistortion steps,
    float64 on ``dev``) meets the board plane; seeded noise and a 5×5 box
    blur."""
    import torch

    from rustcv_tpu_torch.ops import calib

    k1, k2, p1, p2, k3 = (float(v) for v in G4B_DIST)
    K = G4B_K
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                            torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    x0, y0 = (xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1]
    x, y = x0, y0
    for _ in range(10):
        r2 = x * x + y * y
        rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = x + (x0 - xd), y + (y0 - yd)
    r = calib.rodrigues(np.asarray(rv, np.float64))
    hinv = np.linalg.inv(np.column_stack([r[:, 0], r[:, 1], tv]))
    bz = hinv[2, 0] * x + hinv[2, 1] * y + hinv[2, 2]
    bx = (hinv[0, 0] * x + hinv[0, 1] * y + hinv[0, 2]) / bz / G4B_SQ
    by = (hinv[1, 0] * x + hinv[1, 1] * y + hinv[1, 2]) / bz / G4B_SQ
    inside = (bx >= 0) & (bx < G4B_BOARD[0]) & (by >= 0) & (by < G4B_BOARD[1])
    black = ((torch.floor(bx) + torch.floor(by)) % 2 == 0) & inside
    noise = torch.as_tensor(np.random.default_rng(seed).normal(0, 1.5, (H, W)), device=dev)
    img = torch.where(black, 40.0, 200.0).to(torch.float64) + noise
    img = torch.nn.functional.pad(img[None, None], (2, 2, 2, 2), mode="replicate")
    img = torch.nn.functional.avg_pool2d(img, 5, stride=1)[0, 0]
    return img.clamp(0, 255).to(torch.uint8).cpu().numpy()


def _g4b_depth(rv, tv) -> np.ndarray:
    """640×480 depth of two walls and a floor seen from (rv, tv)."""
    from rustcv_tpu_torch.ops import calib

    vs, us = np.mgrid[0:480, 0:640].astype(np.float64)
    rays = np.stack([us, vs, np.ones_like(us)], -1) @ np.linalg.inv(G4B_DEPTH_K).T
    cam_rays = rays @ calib.rodrigues(np.asarray(rv, np.float64)).T
    origin = np.asarray(tv, np.float64)
    depth = np.full((480, 640), np.inf)
    for n, d in G4B_PLANES:
        denom = cam_rays @ n
        tt = (d - origin @ n) / np.where(np.abs(denom) > 1e-9, denom, 1e-9)
        depth = np.where((tt > 0.1) & (np.abs(denom) > 1e-9) & (tt < depth), tt, depth)
    return np.where(np.isinf(depth), 0.0, depth)


def _g4b_mesh(rng):
    """Two overlapping height-field grids of 50×25 cells, two triangles a
    cell (5,000 triangles), in pixel coordinates with depth: (vertices
    (V, 3), faces (T, 3), colours (V, 3))."""
    verts, faces, base = [], [], 0
    for (x0, y0, x1, y1), z0 in (((-20, -10, 900, 600), 2.0), ((380, 200, 1300, 740), 1.5)):
        gy, gx = np.mgrid[0:26, 0:51].astype(np.float64)
        gy, gx = gy / 25, gx / 50
        x = x0 + gx * (x1 - x0) + rng.normal(0, 2.0, gx.shape)
        y = y0 + gy * (y1 - y0) + rng.normal(0, 2.0, gx.shape)
        z = z0 + 0.4 * np.sin(gx * 6.0) * np.cos(gy * 5.0)
        verts.append(np.stack([x, y, z], -1).reshape(-1, 3))
        i = (np.arange(25)[:, None] * 51 + np.arange(50)[None, :]).reshape(-1) + base
        faces += [np.stack([i, i + 1, i + 51], -1), np.stack([i + 1, i + 52, i + 51], -1)]
        base += 26 * 51
    v = np.concatenate(verts).astype(np.float32)
    return v, np.concatenate(faces).astype(np.int32), rng.uniform(0, 255, (len(v), 3)).astype(
        np.float32)


@functools.lru_cache(maxsize=1)
def group4b_inputs() -> dict:
    """Phase 3s's numpy inputs, made once in the main process (the board
    views rendered on the card when there is one), pickled for the workers
    and reused by phase 4s."""
    import torch

    from rustcv_tpu_torch.ops import aruco, circles_grid, sift, warp
    from rustcv_tpu_torch.capture.simulation import synth_bgr

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    rng = np.random.default_rng(80)
    views, poses = [], []
    for v in range(G4B_VIEWS):
        rv = rng.uniform(-0.3, 0.3, 3)
        tv = np.array([rng.uniform(-0.05, 0.05) - G4B_SQ * G4B_BOARD[0] / 2,
                       rng.uniform(-0.03, 0.03) - G4B_SQ * G4B_BOARD[1] / 2,
                       rng.uniform(0.55, 0.8)])
        views.append(_g4b_board_view(rv, tv, v, dev))
        poses.append((rv, tv))
    pattern = synth_bgr(W, H, 11)
    tex = sift._blur(rng.integers(0, 256, (H, W)).astype(np.float64), 2.0)
    tex = (tex - tex.min()) / np.ptp(tex) * 255
    scene = np.clip(0.5 * pattern + 0.5 * tex[..., None], 0, 255).astype(np.uint8)
    frame = np.ascontiguousarray(scene)
    frame[..., 1] = views[0]  # a board in one channel: straight lines to bend
    # markers: a 4×4 GridBoard warped into a 1280×720 frame
    dic = aruco.Dictionary.generate(24, 4, seed=7)
    board = aruco.GridBoard((4, 4), 0.04, 0.02, dic)  # the gap a whole number of cells
    bimg = board.draw(cell_px=12)
    mk = np.array([[900.0, 0, 640], [0, 900.0, 360], [0, 0, 1]])
    mrv, mtv = G4B_MARKER_POSE
    from rustcv_tpu_torch.ops import calib

    r = calib.rodrigues(mrv)
    cell = 0.04 / (dic.bits + 2) / 12.0
    shift = np.array([[1, 0, -12.0 + 0.5], [0, 1, -12.0 + 0.5], [0, 0, 1.0]])
    hm = mk @ np.column_stack([r[:, 0], r[:, 1], mtv]) @ np.diag([cell, cell, 1.0]) @ shift
    mw, mh = G4B_MARKERS
    marker_frame = np.full((mh, mw), 255, np.uint8)
    warped = warp.warp_perspective_numpy(bimg[..., None], hm, (mw, mh))[..., 0]
    inside = warp.warp_perspective_numpy(np.full_like(bimg, 255)[..., None], hm,
                                         (mw, mh))[..., 0] > 128
    marker_frame[inside] = warped[inside]
    # circles: an asymmetric grid at 640×480
    (ccols, crows), (cw, chh) = G4B_CIRCLES
    obj = circles_grid.circles_grid_object_points((ccols, crows), 1.0, asymmetric=True)[:, :2]
    hc = np.array([[32.0, 2.5, 120.0], [-1.5, 32.0, 70.0], [1e-5, -1e-5, 1.0]])
    pc = np.concatenate([obj, np.ones((len(obj), 1))], 1) @ hc.T
    pc = pc[:, :2] / pc[:, 2:]
    yy, xx = np.mgrid[0:chh, 0:cw]
    circles = np.full((chh, cw), 215.0)
    for cx, cy in pc:
        circles[(xx - cx) ** 2 + (yy - cy) ** 2 <= 12.0 ** 2] = 35.0
    circles = np.clip(circles + rng.normal(0, 2.0, circles.shape), 0, 255).astype(np.uint8)
    # depth: frame 0 and the frame after the known motion
    rv_m, tv_m = G4B_MOTION
    rm = calib.rodrigues(rv_m)
    d0 = _g4b_depth(np.zeros(3), np.zeros(3))
    d1 = _g4b_depth(calib.rodrigues(rm.T), -rm.T @ tv_m)
    (ya, xa), (yb, xb), (sw, sh) = G4B_STITCH
    return {
        "views": views, "poses": poses, "frame": frame, "dic": dic, "board": board,
        "marker_k": mk, "marker_frame": marker_frame, "circles": circles, "d0": d0, "d1": d1,
        "mesh": _g4b_mesh(rng),
        "stitch": (np.ascontiguousarray(scene[ya:ya + sh, xa:xa + sw]),
                   np.ascontiguousarray(scene[yb:yb + sh, xb:xb + sw])),
    }


def group4b_sides(inputs: dict, side: str) -> dict:
    """Phase 3s's inputs on one side: "card" (CUDA tensors and Mats) or
    "host" (CPU tensors and Mats)."""
    import torch

    from rustcv_tpu_torch.prelude import Mat

    dev = "cuda" if side == "card" else "cpu"

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def mat(a):
        return Mat.from_device(t(a if a.ndim == 3 else a[..., None]))

    return dict(inputs, dev=dev, side=side, view_mats=[mat(v) for v in inputs["views"]],
                frame_t=t(inputs["frame"]), frame_mat=mat(inputs["frame"]),
                marker_mat=mat(inputs["marker_frame"]),
                mesh_t=tuple(t(a) for a in inputs["mesh"]),
                stitch_mats=[mat(a) for a in inputs["stitch"]])


def _g4b_calibrate(s, detector: str):
    """Detect the 8 views with ``detector``, order each found grid as the
    object points (the detector's frame may be a flip of them), calibrate:
    (found flags, corners, rms, K, dist)."""
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import calib

    cols, rows = G4B_PATTERN
    gx, gy = np.meshgrid(np.arange(1, cols + 1), np.arange(1, rows + 1))
    obj = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], 1) * G4B_SQ
    found, corners, aligned = [], [], []
    for m, (rv, tv) in zip(s["view_mats"], s["poses"]):
        f, c = getattr(ip, detector)(m, G4B_PATTERN)
        found.append(f)
        corners.append(c)
        if not f:
            continue
        truth = calib.project_points(obj, rv, tv, G4B_K, G4B_DIST).reshape(rows, cols, 2)
        cg = c.reshape(rows, cols, 2)
        err, best = min(((np.linalg.norm(g - truth, axis=2).max(), g)
                         for g in (cg, cg[::-1, ::-1], cg[::-1, :], cg[:, ::-1])),
                        key=lambda e: e[0])
        expect(err < 1.5, f"{detector}: a grid {err:.3g} px off the truth")
        aligned.append(best.reshape(-1, 2))
    expect(len(aligned) >= 6, f"{detector}: only {len(aligned)} of {G4B_VIEWS} views found")
    rms, k, dist, _, _ = calib.calibrate_camera([obj] * len(aligned), aligned, (W, H))
    return np.array(found), np.concatenate(corners), rms, k, dist


def _g4b_marker_pose(s):
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import aruco

    corners, ids = ip.detect_aruco_markers(s["marker_mat"], s["dic"])
    n, rv, tv = aruco.estimate_pose_board(corners, ids, s["board"], s["marker_k"])
    return ids, np.concatenate(corners) if corners else np.zeros((0, 2)), n, rv, tv


def _g4b_raster(s):
    """The card rasterizes the whole mesh at 1280×720 and returns the crop;
    the host rasterizes the crop's window of the mesh (the triangles whose
    box reaches it, shifted into it). Returns (crop colour, crop depth,
    the full frame's covered share)."""
    import torch

    from rustcv_tpu_torch.ops import threed

    n_tris, w, h = G4B_MESH
    x0, y0, cw, chh = G4B_RASTER_CROP
    if s["side"] == "card":
        color, depth = threed.triangle_rasterize(*s["mesh_t"], w, h)
        share = float(torch.isfinite(depth).to(torch.float32).mean())
        return (color[y0:y0 + chh, x0:x0 + cw], depth[y0:y0 + chh, x0:x0 + cw], share)
    v, f, c = s["mesh"]
    tri = v[f]
    lo, hi = tri[..., :2].min(1), tri[..., :2].max(1)
    keep = ((hi[:, 0] >= x0 - 2) & (lo[:, 0] <= x0 + cw + 1) & (hi[:, 1] >= y0 - 2)
            & (lo[:, 1] <= y0 + chh + 1))
    shifted = v - np.array([x0, y0, 0], np.float32)
    color, depth = threed.triangle_rasterize(torch.from_numpy(shifted), f[keep], c, cw, chh)
    return color, depth, float("nan")


def group4b_calls() -> dict:
    """name → (call on a side of :func:`group4b_sides`, check). A check
    takes (name, card result, host result) as numpy and raises on a
    mismatch; it returns the largest difference, or a note."""
    import torch

    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import calib, threed

    fw, fh = G4B_MARKERS
    return {
        "calibration path 1080p (find_chessboard_corners x8, calibrate_camera)": (
            lambda s: _g4b_calibrate(s, "find_chessboard_corners"), g4b_calibration),
        "find_chessboard_corners_sb x8 1080p (+ calibrate_camera)": (
            lambda s: _g4b_calibrate(s, "find_chessboard_corners_sb"), g4b_calibration),
        "undistort 1080p BGR": (lambda s: ip.undistort(s["frame_mat"], G4B_K, G4B_DIST),
                                g3_exact),
        "fisheye_undistort 1080p BGR": (lambda s: calib.fisheye_undistort(
            s["frame_t"], G4B_K, G4B_FISH, G4B_K * np.array([[0.7], [0.7], [1.0]])), g3_exact),
        f"detect_aruco_markers + estimate_pose_board {fw}x{fh}": (_g4b_marker_pose, g4b_markers),
        "find_circles_grid 640x480 asymmetric 4x11": (lambda s: ip.find_circles_grid(
            s["circles"], G4B_CIRCLES[0], asymmetric=True), g4b_circles),
        "rgbd_normals 640x480": (lambda s: threed.rgbd_normals(torch.as_tensor(
            threed.depth_to_3d(s["d0"], G4B_DEPTH_K), device=s["dev"])), g4b_rtol(1e-5)),
        "triangle_rasterize 5000 tris 1280x720": (_g4b_raster, g4b_raster),
        "stitch_images 2x640x360 CUDA Mats": (lambda s: ip.stitch_images(s["stitch_mats"]),
                                              g4b_stitch),
    }


# -- phase 3s's checks: the tolerances of the port's CPU tests ----------------

def g4b_calibration(name, got, want):
    """``found`` equal, corners within 1e-3 px, K within 1e-5 relative and
    the distortion within 5e-3 of the CPU port's; the card's fx, fy within
    3 % of the truth and its principal point within 15 px."""
    (f, c, rms, k, d), (wf, wc, wrms, wk, wd) = got, want
    expect(np.array_equal(f, wf), f"{name}: found {f} != {wf}")
    err = float(np.abs(c - wc).max())
    expect(err <= 1e-3, f"{name}: corners {err:.3g} px apart")
    expect(np.allclose(k, wk, rtol=1e-5, atol=0), f"{name}: K {k} != {wk}")
    expect(np.abs(d - wd).max() <= 5e-3, f"{name}: dist {d} != {wd}")
    kerr = max(abs(k[i, i] - G4B_K[i, i]) / G4B_K[i, i] for i in (0, 1))
    cerr = max(abs(k[i, 2] - G4B_K[i, 2]) for i in (0, 1))
    expect(kerr < 0.03 and cerr < 15, f"{name}: K {k.tolist()} vs the truth {G4B_K.tolist()}")
    return (f"corners {err:.3g} px, {int(f.sum())}/{len(f)} views found, rms {rms:.3f} px, "
            f"fx,fy within {100 * kerr:.2f} % of the truth, cx,cy within {cerr:.2f} px, "
            f"K vs CPU {float(np.abs(k - wk).max()):.3g}, dist vs CPU {float(np.abs(d - wd).max()):.3g}")


def g4b_markers(name, got, want):
    ids, corners, n, rv, tv = got
    expect(all(np.array_equal(a, b) for a, b in zip(got, want)), f"{name}: differs from the CPU")
    mrv, mtv = G4B_MARKER_POSE
    err = (float(np.abs(rv - mrv).max()), float(np.abs(tv - mtv).max()))
    expect(n >= 12 and err[0] < 0.02 and err[1] < 0.01, f"{name}: {n} markers, pose err {err}")
    return f"{len(ids)} markers, pose within {err[0]:.3g} rad / {err[1]:.3g} m"


def g4b_circles(name, got, want):
    (f, c), (wf, wc) = got, want
    expect(f and wf and np.array_equal(c, wc), f"{name}: differs from the CPU")
    return f"{len(c)} centres equal"


def g4b_rtol(rtol):
    def check(name, got, want):
        expect(got.shape == want.shape, f"{name}: {got.shape} != {want.shape}")
        err = float((np.abs(got - want) / np.maximum(np.abs(want), 1e-6)).max())
        expect(np.allclose(got, want, rtol=rtol, atol=1e-6), f"{name}: rel |diff| {err:.3g}")
        return err
    return check


def group4b_host_only_calls() -> dict:
    """name → (call on the numpy inputs, check). These calls take and
    return numpy and touch no tensor, so a CPU worker would repeat the same
    float64 code: they run once, and a check takes (name, result) and holds
    it to the scene's truth."""
    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import threed

    return {
        "depth_to_3d 640x480": (lambda i: threed.depth_to_3d(i["d0"], G4B_DEPTH_K),
                                g4b_points),
        "find_planes 640x480": (lambda i: threed.find_planes(threed.depth_to_3d(
            i["d0"], G4B_DEPTH_K), min_size=2000, threshold=0.02), g4b_planes),
        "rgbd_odometry 640x480": (lambda i: ip.rgbd_odometry(i["d0"], i["d1"], G4B_DEPTH_K),
                                  g4b_odometry),
    }


def g4b_points(name, got):
    """z is the depth; x, y its ray through G4B_DEPTH_K, within float32."""
    d = _G4B_HOST_ONLY_DEPTH["d0"]
    vs, us = np.mgrid[0:d.shape[0], 0:d.shape[1]]
    want = np.stack([(us - G4B_DEPTH_K[0, 2]) * d / G4B_DEPTH_K[0, 0],
                     (vs - G4B_DEPTH_K[1, 2]) * d / G4B_DEPTH_K[1, 1], d], -1)
    expect(got.shape == want.shape and got.dtype == np.float32, f"{name}: {got.shape}")
    err = float(np.abs(got - want).max())
    expect(err <= 1e-6 * float(np.abs(want).max()), f"{name}: {err:.3g} off the rays")
    return f"{err:.3g} off the rays"


def g4b_planes(name, got):
    """The scene's three planes, each within 2e-3 of its truth, cover 99 %
    of the pixels."""
    labels, coeffs = got
    truth = [np.append(n, -d) / np.linalg.norm(n) for n, d in G4B_PLANES]
    expect(len(coeffs) == len(truth), f"{name}: {len(coeffs)} planes")
    err = max(min(float(np.abs(c - t).max()) for t in truth) for c in coeffs)
    cover = float((labels != 255).mean())
    expect(err < 2e-3 and cover > 0.99, f"{name}: planes {err:.3g} off, cover {cover:.4f}")
    return f"{len(coeffs)} planes within {err:.3g} of the truth, {100 * cover:.2f} % of pixels"


def g4b_odometry(name, got):
    ok, rv, tv = got
    err = max(float(np.abs(rv - G4B_MOTION[0]).max()), float(np.abs(tv - G4B_MOTION[1]).max()))
    expect(bool(ok) and err < 2e-3, f"{name}: motion {err:.3g} off the truth")
    return f"{err:.3g} off the true motion"


def g4b_raster(name, got, want):
    """On the crop: cover differs on at most 0.1 % of pixels, depth within
    1e-5 and colour within 1e-4 relative where both cover."""
    (c, d, share), (wc, wd, _) = got, want
    cover, wcover = np.isfinite(d), np.isfinite(wd)
    mismatch = int((cover != wcover).sum())
    expect(mismatch <= 0.001 * d.size, f"{name}: cover differs at {mismatch} px")
    both = cover & wcover
    expect(np.allclose(d[both], wd[both], rtol=1e-5, atol=0), f"{name}: depth differs")
    expect(np.allclose(c[both], wc[both], rtol=1e-4, atol=1e-4), f"{name}: colour differs")
    derr = float((np.abs(d[both] - wd[both]) / wd[both]).max())
    return (f"crop {G4B_RASTER_CROP[2]}x{G4B_RASTER_CROP[3]}: cover differs at {mismatch} of "
            f"{d.size} px, depth rel {derr:.3g}; {100 * share:.1f} % of the frame covered")


def g4b_stitch(name, got, want):
    expect(got.shape == want.shape, f"{name}: {got.shape} != {want.shape}")
    diff = np.abs(got.astype(np.int64) - want)
    expect(diff.max() <= 1, f"{name}: max |diff| {int(diff.max())}")
    return f"{got.shape[1]}x{got.shape[0]} panorama, {int((diff > 0).sum())} values differ by 1"


_G4B_HOST = {}  # a worker's host inputs and calls, loaded at its first call


def _g4b_worker_init() -> None:
    import torch

    torch.set_num_threads(2)
    from rustcv_tpu_torch import imgproc  # noqa: F401  (the imports, while the card works)


def group4b_host(name: str, path: str):
    """One call of phase 3s on the host inputs, in a worker process (the
    inputs pickled at ``path``, loaded once): the result as numpy, and its
    seconds."""
    import pickle

    if _G4B_HOST.get("path") != path:
        with open(path, "rb") as f:
            inputs = pickle.load(f)
        _G4B_HOST.update(path=path, sides=group4b_sides(inputs, "host"), calls=group4b_calls())
    t0 = time.perf_counter()
    out = _g3_plain(_G4B_HOST["calls"][name][0](_G4B_HOST["sides"]))
    return out, time.perf_counter() - t0


_G4B_CARD_S = {}  # phase 3s's seconds per card call, which phase 4s prints
_G4B_HOST_ONLY_S = {}  # phase 3s's seconds per host-only call, which phase 4s prints
_G4B_HOST_ONLY_DEPTH = {}  # the depth map that g4b_points checks against


def run_group4b() -> dict:
    """Phase 3s: every call of :func:`group4b_calls` on the card inputs
    against the same call on the host inputs, computed meanwhile by
    G4B_WORKERS spawned CPU processes (stopped before this returns). Prints
    each size and each call's largest difference. Then runs the
    host-only calls once, against their truth. Launches no kernel:
    returns the (zero) launches of the card's calls."""
    import multiprocessing
    import pickle
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from rustcv_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(max_workers=G4B_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"),
                               initializer=_g4b_worker_init)
    try:
        for _ in range(G4B_WORKERS):  # start the workers now: torch imports while inputs build
            pool.submit(time.sleep, 0)
        inputs = group4b_inputs()
        t_inputs = time.perf_counter() - t0
        calls = group4b_calls()
        heavy = [n for n in calls if n.startswith(("stitch", "calibration", "find_chessboard",
                                                   "find_circles"))]
        order = heavy + [n for n in calls if n not in heavy]
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "inputs.pkl")
            with open(path, "wb") as f:
                pickle.dump(inputs, f)
            futures = {name: pool.submit(group4b_host, name, path) for name in order}
            sides = group4b_sides(inputs, "card")
            kernels.reset_launch_counts()
            got = {}
            for name, (call, _check) in calls.items():
                t1 = time.perf_counter()
                got[name] = call(sides)
                torch.cuda.synchronize()
                _G4B_CARD_S[name] = time.perf_counter() - t1
            counts = kernels.launch_counts()
            expect(not any(counts.values()), f"phase 3s launched a kernel: {counts}")
            _G4B_HOST_ONLY_DEPTH["d0"] = inputs["d0"]
            host_only = {}
            for name, (call, check) in group4b_host_only_calls().items():
                t1 = time.perf_counter()
                out = call(inputs)
                _G4B_HOST_ONLY_S[name] = time.perf_counter() - t1
                host_only[name] = check(name, out)
            t_card = time.perf_counter() - t0 - t_inputs
            notes, host_s = {}, {}
            for name, (call, check) in calls.items():
                want, host_s[name] = futures[name].result(timeout=600)
                notes[name] = check(name, _g3_plain(got[name]), want)
            t_wait = time.perf_counter() - t0 - t_inputs - t_card
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    print(f"group 4b (the board views, the undistorted frames and the stitch crops' scene at "
          f"{W}x{H}; the sizes in each name): {len(calls)} calls on the card == the CPU port "
          f"within the CPU tests' tolerances, no kernel launched; " + "; ".join(
              f"{k} {v:.3g}" if not isinstance(v, str) else f"{k}: {v}"
              for k, v in notes.items()), flush=True)
    print("group 4b host-only (numpy in and out, run once, held to the truth): " + "; ".join(
        f"{k}: {v}" for k, v in host_only.items()), flush=True)
    print(f"group 4b: inputs {t_inputs:.1f} s, card and host-only side {t_card:.1f} s, then "
          f"waiting for the "
          f"host side {t_wait:.1f} s", flush=True)
    print("group 4b card seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(_G4B_CARD_S.items(), key=lambda kv: -kv[1]))
        + "; host seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(host_s.items(), key=lambda kv: -kv[1])), flush=True)
    return counts


def time_group4b(smi: str) -> None:
    """Phase 4s: ms per call of phase 3s. The device-bound calls are timed
    here with CUDA events (``undistort`` of one 1080p frame whole, and
    apart its host map build on the host clock, the upload of its two maps
    and the remap on the card); the host-bound ones (detections,
    calibration, markers, circles, stitching) are phase
    3s's one card-side run on the host clock. The host-only calls
    (``depth_to_3d``, planes, odometry) print on a line of their own.
    Never gated."""
    import torch

    from rustcv_tpu_torch import imgproc as ip
    from rustcv_tpu_torch.ops import calib, chessboard, chessboard_sb, features, stitch, threed, warp

    inputs = group4b_inputs()
    s = group4b_sides(inputs, "card")
    times = {}
    frame = s["frame_t"]
    times["undistort 1080p BGR (whole call)"] = cuda_ms(
        lambda: ip.undistort(s["frame_mat"], G4B_K, G4B_DIST), 5)
    t0 = time.perf_counter()
    for _ in range(3):
        mx, my = calib.init_undistort_rectify_map(G4B_K, G4B_DIST, None, (W, H))
    times["undistort: host map build (host clock)"] = (time.perf_counter() - t0) / 3 * 1e3
    times["undistort: map upload (2 x 8.3 MB)"] = cuda_ms(
        lambda: (torch.as_tensor(mx, device="cuda"), torch.as_tensor(my, device="cuda")), 5)
    mxt, myt = torch.as_tensor(mx, device="cuda"), torch.as_tensor(my, device="cuda")
    times["undistort: remap on the card"] = cuda_ms(lambda: warp.remap(frame, mxt, myt), 10)
    times["fisheye_undistort 1080p BGR"] = cuda_ms(lambda: calib.fisheye_undistort(
        frame, G4B_K, G4B_FISH, G4B_K * np.array([[0.7], [0.7], [1.0]])), 5)
    g = torch.as_tensor((inputs["views"][0] / np.float64(255.0)).astype(np.float32),
                        device="cuda")
    times["SB likelihood 1080p (16-channel conv2d, full float32)"] = cuda_ms(
        lambda: chessboard_sb._likelihood(g), 10)
    found, corners = chessboard.find_chessboard_corners(inputs["views"][0], G4B_PATTERN,
                                                        refine=False)
    gv = torch.as_tensor(inputs["views"][0], device="cuda")
    times[f"corner_sub_pix {len(corners)} corners win 11 (one view's refinement)"] = cuda_ms(
        lambda: features.corner_sub_pix(gv, corners.astype(np.float32), win=11), 10)
    pts = torch.as_tensor(threed.depth_to_3d(inputs["d0"], G4B_DEPTH_K), device="cuda")
    times["rgbd_normals 640x480"] = cuda_ms(lambda: threed.rgbd_normals(pts), 10)
    n_tris, w, h = G4B_MESH
    times[f"triangle_rasterize {n_tris} tris {w}x{h}"] = cuda_ms(
        lambda: threed.triangle_rasterize(*s["mesh_t"], w, h), 2)
    # the crops are a translation apart: that homography, the canvas of both
    (_, xa), (_, xb), (sw, sh) = G4B_STITCH
    hs = [np.eye(3), np.array([[1.0, 0, xb - xa], [0, 1, 0], [0, 0, 1]])]
    a, b = (m.device() for m in s["stitch_mats"])
    times["stitch device composite 2x640x360 (a known homography)"] = cuda_ms(
        lambda: stitch._composite_device([a, b], hs, np.eye(3), sh, sw + xb - xa), 5)
    for name, sec in _G4B_CARD_S.items():
        if not name.startswith(("undistort", "fisheye", "rgbd_normals", "triangle")):
            times[name + " (phase 3s, host clock)"] = sec * 1e3
    print(f"group 4b ms per call on card inputs ({smi}), slowest first: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(times.items(), key=lambda kv: -kv[1])), flush=True)
    print("group 4b host-only ms per call (numpy in and out, no card work; phase 3s, host "
          "clock), slowest first: " + ", ".join(
              f"{k} {v * 1e3:.4f}"
              for k, v in sorted(_G4B_HOST_ONLY_S.items(), key=lambda kv: -kv[1])), flush=True)


# ----------------------------------------------------------------------------------
# Phase 3t: the cv2 facade (rustcv_tpu_torch.cv2), one cv2 user's script at 1080p

CV2_FRAMES = 8  # the clip phase 3t writes, reads back and processes
CV2_SMALL = (640, 360)  # resize's target (INTER_AREA)
CV2_SQUARE = (96, 400, 300, 24)  # the moving square: side, x0, y, px per frame
CV2_WORKERS = 4
CV2_REPS = 3  # phase 4t's timed calls per cv2 call
# Bars of phase 3t, card against CPU, as the CPU tests hold them: the float
# Harris response at HARRIS_TOL, ORB angles within 1e-3 rad, the JPEG
# payloads' coefficients at JPEG_TOL (card encoder against the CPU's);
# everything else equal.


def cv2_clip(w: int, h: int, n: int) -> list:
    """Phase 3t's clip: the test pattern at w×h with a textured square
    moving right, n BGR frames."""
    from rustcv_tpu_torch.capture.simulation import synth_bgr

    side, x0, y, step = CV2_SQUARE
    side, y = min(side, h // 3), min(y, h // 3)
    base = synth_bgr(w, h, 11)
    tex = np.random.default_rng(19).integers(0, 256, (side, side, 3), np.uint8)
    out = []
    for t in range(n):
        f = base.copy()
        x = (min(x0, w // 4) + step * t) % max(1, w - side)
        f[y:y + side, x:x + side] = tex
        out.append(f)
    return out


def cv2_write_read(cv2, frames, img, path: str) -> dict:
    """``cv2.VideoWriter`` (MJPG) writes the frames (``img`` makes what
    this side passes: numpy on the card's side, a CPU tensor on the CPU's),
    ``cv2.VideoCapture(path)`` reads them back."""
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (w, h))
    expect(writer.isOpened(), f"VideoWriter did not open {path}")
    for f in frames:
        writer.write(img(f))
    writer.release()
    cap = cv2.VideoCapture(path)
    try:
        expect(cap.isOpened(), f"VideoCapture did not open {path}")
        size = (cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        decoded = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            decoded.append(f)
    finally:
        cap.release()
    return {"size": size, "decoded": decoded}


def cv2_frame_calls(cv2, frame, payload: bytes, img) -> dict:
    """The per-frame calls of phase 3t's script on one decoded BGR frame,
    by name; ``payload`` is the JPEG the frame was decoded from, which
    ``imdecode`` decodes again; ``img`` as in :func:`cv2_write_read`."""
    out = {}
    f = img(frame)
    gray = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
    g = img(gray)
    out["cvtColor BGR2GRAY"] = gray
    out["GaussianBlur 5x5"] = cv2.GaussianBlur(f, (5, 5), 0)
    out["GaussianBlur 7x7 sigma 1.5"] = cv2.GaussianBlur(f, (7, 7), 1.5)
    out["Sobel CV_16S dx"] = cv2.Sobel(g, cv2.CV_16S, 1, 0)
    out["Canny 50 150"] = cv2.Canny(g, 50, 150)
    out["threshold 127 binary"] = cv2.threshold(g, 127, 255, cv2.THRESH_BINARY)[1]
    out["resize 640x360 area"] = cv2.resize(f, CV2_SMALL, interpolation=cv2.INTER_AREA)
    out["cornerHarris 2 3 0.04"] = cv2.cornerHarris(g, 2, 3, 0.04)
    out["goodFeaturesToTrack 500 0.01 10"] = cv2.goodFeaturesToTrack(g, 500, 0.01, 10)
    canvas = img(frame.copy())
    cv2.rectangle(canvas, (100, 100), (500, 400), (0, 255, 0), 2)
    cv2.circle(canvas, (960, 540), 120, (0, 0, 255), -1)
    cv2.putText(canvas, "rustcv_tpu_torch.cv2", (60, 1000), cv2.FONT_HERSHEY_SIMPLEX, 1.5,
                (255, 255, 0), 2)
    out["rectangle, circle, putText"] = canvas
    ok, jpg = cv2.imencode(".jpg", f)
    expect(ok, "imencode('.jpg') failed")
    out["imencode .jpg"] = jpg
    out["imdecode"] = cv2.imdecode(np.frombuffer(payload, np.uint8), cv2.IMREAD_COLOR)
    return out


def cv2_clip_calls(cv2, frames, img, which=("ORB", "MOG2")) -> dict:
    """The calls of phase 3t's script over the whole clip: ORB's
    ``detectAndCompute`` and MOG2's ``apply`` on every frame."""
    out = {}
    if "ORB" in which:
        orb = cv2.ORB_create()
        for t, frame in enumerate(frames):
            kps, desc = orb.detectAndCompute(img(frame), None)
            out[f"ORB {t}"] = (np.array([k.pt for k in kps], np.float64).reshape(-1, 2),
                               np.array([k.angle for k in kps], np.float64), desc)
    if "MOG2" in which:
        mog2 = cv2.createBackgroundSubtractorMOG2()
        for t, frame in enumerate(frames):
            out[f"MOG2 {t}"] = mog2.apply(img(frame))
    return out


def cv2_filestorage(cv2, corners, tmp: str) -> dict:
    """``FileStorage`` writes the corners and reads them back, in each
    format this machine reads (YAML needs PyYAML)."""
    import importlib.util

    exts = ["json", "xml"] + (["yml"] if importlib.util.find_spec("yaml") else [])
    out = {}
    for ext in exts:
        path = os.path.join(tmp, f"corners.{ext}")
        fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
        fs.write("frame", 0)
        fs.write("corners", corners)
        fs.release()
        back = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
        expect(back.isOpened(), f"FileStorage did not read {path}")
        out[ext] = (back.getNode("corners").mat(), open(path, "rb").read())
        back.release()
    return out


_CV2_HOST = {}  # a worker's decoded clip, loaded at its first call


def cv2_host(job: str, path: str):
    """One job of phase 3t's CPU side in a worker process, on CPU tensors:
    ``"clip"`` writes and reads the clip, ``"frame <t>"`` runs the
    per-frame calls on the card's decoded frame t, ``"ORB"`` and ``"MOG2"``
    the clip's calls. Returns the outputs as numpy, and its seconds."""
    import pickle
    import tempfile

    import torch

    torch.set_num_threads(2)
    import rustcv_tpu_torch.cv2 as cv2

    if _CV2_HOST.get("path") != path:
        with open(path, "rb") as f:
            _CV2_HOST.update(pickle.load(f), path=path)
    t0 = time.perf_counter()
    cpu = torch.from_numpy
    if job == "clip":
        with tempfile.TemporaryDirectory() as tmp:
            avi = os.path.join(tmp, "clip.avi")
            out = cv2_write_read(cv2, _CV2_HOST["frames"], cpu, avi)
            out["payloads"] = cv2_payloads(avi)
    elif job in ("ORB", "MOG2"):
        out = cv2_clip_calls(cv2, _CV2_HOST["decoded"], cpu, (job,))
    else:
        t = int(job.split()[1])
        out = cv2_frame_calls(cv2, _CV2_HOST["decoded"][t], _CV2_HOST["payloads"][t], cpu)
    return out, time.perf_counter() - t0


def cv2_payloads(avi: str) -> list:
    from rustcv_tpu_torch.capture import AviMjpegReader

    reader = AviMjpegReader(avi)
    return [reader.frame_bytes(i).tobytes() for i in range(len(reader))]


def cv2_jpeg_within(got: bytes, want: bytes, what: str) -> None:
    """Two JPEG payloads of the same image (the card's encoder and the
    CPU's): equal quantized coefficients within JPEG_TOL, equal tables."""
    from rustcv_tpu_torch import native

    g_info, g_coeffs, g_qts = native.jpeg_entropy_decode(bytes(got))
    w_info, w_coeffs, w_qts = native.jpeg_entropy_decode(bytes(want))
    expect(g_info == w_info, f"{what}: {g_info} against {w_info}")
    for a, b in zip(g_qts, w_qts):
        expect(np.array_equal(a, b), f"{what}: other quantization tables")
    for i, (a, b) in enumerate(zip(g_coeffs, w_coeffs)):
        within(a, b, JPEG_TOL, f"{what} component {i}")


def cv2_check(name: str, got, want) -> str:
    """Phase 3t's bar for one output, card against CPU; a note to print."""
    if name.startswith("cornerHarris"):
        import torch

        a, r = harris_f32_errs(torch.from_numpy(got), torch.from_numpy(want))
        expect(np.allclose(got, want, **HARRIS_TOL), f"{name}: {a:.3g} abs, {r:.3g} rel")
        return f"{a:.3g}"
    if name.startswith("imencode"):
        cv2_jpeg_within(got, want, name)
        return "coefficients within JPEG_TOL"
    if name.startswith("ORB"):
        expect(np.array_equal(got[0], want[0]), f"{name}: other keypoints")
        ang = np.abs((got[1] - want[1] + 180) % 360 - 180).max(initial=0)
        expect(ang <= np.degrees(1e-3), f"{name}: angles {ang:.3g} deg apart")
        expect(np.array_equal(got[2], want[2]), f"{name}: other descriptors")
        return f"{len(got[0])} keypoints"
    expect(np.asarray(got).shape == np.asarray(want).shape
           and np.asarray(got).dtype == np.asarray(want).dtype
           and np.array_equal(got, want), f"{name}: card and CPU differ")
    return "equal"


_CV2_CARD = {}  # phase 3t's inputs and results on the card, which phase 4t reuses


def run_cv2() -> dict:
    """Phase 3t: one cv2 user's script through ``import rustcv_tpu_torch.cv2
    as cv2`` at 1920×1080, numpy in and out (a numpy image goes to the
    card): ``VideoWriter`` writes the 8-frame clip, ``VideoCapture`` reads
    it back (its size from ``get``); per frame ``cvtColor``, two
    ``GaussianBlur``s, ``Sobel``, ``Canny``, ``threshold``, ``resize``,
    ``cornerHarris`` (K6 float32), ``goodFeaturesToTrack`` (K6 int32), the
    draws and ``imencode``/``imdecode``; over the clip ORB and MOG2; then
    ``FileStorage`` writes the corners and reads them back. Every result is
    held against the same call on CPU tensors in CV2_WORKERS spawned CPU
    processes (stopped before this returns). Fails unless both K6 forms
    launched. Returns the launches of the card's run."""
    import multiprocessing
    import pickle
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import torch

    import rustcv_tpu_torch.cv2 as cv2
    from rustcv_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(max_workers=CV2_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        for _ in range(CV2_WORKERS):  # the workers import torch while the card works
            pool.submit(time.sleep, 0)
        frames = cv2_clip(W, H, CV2_FRAMES)
        with tempfile.TemporaryDirectory() as tmp:
            avi = os.path.join(tmp, "clip.avi")
            kernels.reset_launch_counts()  # the cv2 path starts here
            clip = cv2_write_read(cv2, frames, lambda a: a, avi)
            decoded = clip["decoded"]
            payloads = cv2_payloads(avi)
            path = os.path.join(tmp, "clip.pkl")  # the CPU side starts on the card's frames
            with open(path, "wb") as f:
                pickle.dump({"frames": frames, "decoded": decoded, "payloads": payloads}, f)
            jobs = ["MOG2", "ORB", "clip"] + [f"frame {t}" for t in range(len(decoded))]
            futures = {job: pool.submit(cv2_host, job, path) for job in jobs}
            got = {}
            for t, frame in enumerate(decoded):
                for name, out in cv2_frame_calls(cv2, frame, payloads[t], lambda a: a).items():
                    got[f"{name} {t}"] = out
            got.update(cv2_clip_calls(cv2, decoded, lambda a: a))
            torch.cuda.synchronize()
            counts = kernels.launch_counts()  # read just after the cv2 path
            t_card = time.perf_counter() - t0
            corners = got["goodFeaturesToTrack 500 0.01 10 0"]
            stored = cv2_filestorage(cv2, corners, tmp)
            expect(clip["size"] == (float(W), float(H)) and len(decoded) == CV2_FRAMES,
                   f"VideoCapture read {len(decoded)} frames of {clip['size']}")
            expect(counts["harris_response_f32"] >= 1 and counts["harris_response_i32"] >= 1,
                   f"phase 3t: cornerHarris / goodFeaturesToTrack did not reach K6: {counts}")
            for ext, (mat, _raw) in stored.items():
                expect(mat.dtype == corners.dtype and np.array_equal(mat.reshape(corners.shape),
                                                                     corners),
                       f"FileStorage .{ext} did not read the corners back")
            notes, host_s = {}, {}
            want_clip, host_s["clip"] = futures["clip"].result(timeout=600)
            expect(want_clip["size"] == clip["size"]
                   and len(want_clip["payloads"]) == len(payloads), "the CPU clip differs")
            for t, (a, b) in enumerate(zip(payloads, want_clip["payloads"])):
                cv2_jpeg_within(a, b, f"VideoWriter frame {t}")
            notes["VideoWriter payloads"] = "coefficients within JPEG_TOL"
            want = {}
            for job in (j for j in jobs if j != "clip"):
                out, host_s[job] = futures[job].result(timeout=600)
                suffix = " " + job.split()[1] if job.startswith("frame") else ""
                want.update({f"{k}{suffix}": v for k, v in out.items()})
            expect(sorted(want) == sorted(got), "the CPU side ran other calls")
            for name in got:
                base = name.rsplit(" ", 1)[0]
                note = cv2_check(name, _g3_plain(got[name]), want[name])
                notes.setdefault(base, note)
            cpu_corners = want["goodFeaturesToTrack 500 0.01 10 0"]
            cpu_stored = cv2_filestorage(cv2, cpu_corners, tmp)
            for ext in stored:
                expect(stored[ext][1] == cpu_stored[ext][1],
                       f"FileStorage .{ext}: other bytes for the CPU's corners")
            t_wait = time.perf_counter() - t0 - t_card
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    _CV2_CARD.update(frames=frames, decoded=decoded, payloads=payloads, corners=corners)
    print(f"cv2 facade at {W}x{H}, {CV2_FRAMES} frames (numpy in, numpy out): "
          f"{len(got)} results on the card == the CPU port on CPU tensors: " + "; ".join(
              f"{k}: {v}" for k, v in notes.items()) + f"; FileStorage {sorted(stored)} read "
          f"the corners back, the same bytes as the CPU's", flush=True)
    print(f"cv2 facade: card side {t_card:.1f} s, then waiting for the CPU side "
          f"{t_wait:.1f} s; launches {({k: v for k, v in counts.items() if v})}; host seconds "
          "per job: " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
              host_s.items(), key=lambda kv: -kv[1])), flush=True)
    return counts


def time_cv2(smi: str) -> None:
    """Phase 4t: ms per cv2 call at 1080p, numpy in and numpy out (the
    uploads and downloads included; CUDA events over CV2_REPS calls after a
    warm one), slowest first, with the card's name and power limit. The
    host-only calls (cv2's own host algorithms: the u8 BGR2GRAY tables,
    Canny, the u8 area resize and the JPEG decode; the in-place draws on a
    numpy frame; FileStorage) print on a line of their own, on the host
    clock. Never gated."""
    import tempfile

    import rustcv_tpu_torch.cv2 as cv2

    frame = _CV2_CARD["decoded"][0]
    gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    jpg = np.frombuffer(_CV2_CARD["payloads"][0], np.uint8)
    calls = {
        "GaussianBlur 5x5": lambda: cv2.GaussianBlur(frame, (5, 5), 0),
        "GaussianBlur 7x7 sigma 1.5": lambda: cv2.GaussianBlur(frame, (7, 7), 1.5),
        "Sobel CV_16S dx": lambda: cv2.Sobel(gray, cv2.CV_16S, 1, 0),
        "threshold 127": lambda: cv2.threshold(gray, 127, 255, cv2.THRESH_BINARY),
        "cornerHarris (K6 f32)": lambda: cv2.cornerHarris(gray, 2, 3, 0.04),
        "goodFeaturesToTrack (K6 i32)": lambda: cv2.goodFeaturesToTrack(gray, 500, 0.01, 10),
        "imencode .jpg": lambda: cv2.imencode(".jpg", frame),
        "ORB detectAndCompute": lambda: cv2.ORB_create().detectAndCompute(frame, None),
    }
    # host code, as the reference's (cv2's own tables and algorithms)
    host_calls = {
        "cvtColor BGR2GRAY": lambda: cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY),
        "Canny 50 150": lambda: cv2.Canny(gray, 50, 150),
        "resize 640x360 area": lambda: cv2.resize(frame, CV2_SMALL, interpolation=cv2.INTER_AREA),
        "imdecode": lambda: cv2.imdecode(jpg, cv2.IMREAD_COLOR),
    }
    mog2 = cv2.createBackgroundSubtractorMOG2()
    calls["MOG2 apply"] = lambda: mog2.apply(frame)
    times = {name: cuda_ms(fn, CV2_REPS) for name, fn in calls.items()}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        clip = cv2_write_read(cv2, _CV2_CARD["frames"], lambda a: a,
                              os.path.join(tmp, "clip.avi"))
        n = len(clip["decoded"])
        times["VideoWriter write + VideoCapture read, per frame (host clock)"] = (
            (time.perf_counter() - t0) / n * 1e3)
        host = {}
        for name, fn in host_calls.items():
            fn()
            t0 = time.perf_counter()
            fn()
            host[name] = (time.perf_counter() - t0) * 1e3
        canvas = frame.copy()
        for name, draw in (
                ("rectangle", lambda: cv2.rectangle(canvas, (100, 100), (500, 400), (0, 255, 0), 2)),
                ("circle filled", lambda: cv2.circle(canvas, (960, 540), 120, (0, 0, 255), -1)),
                ("putText", lambda: cv2.putText(canvas, "rustcv_tpu_torch.cv2", (60, 1000),
                                                cv2.FONT_HERSHEY_SIMPLEX, 1.5, (255, 255, 0), 2))):
            draw()
            t0 = time.perf_counter()
            for _ in range(CV2_REPS):
                draw()
            host[name + " on a numpy frame"] = (time.perf_counter() - t0) / CV2_REPS * 1e3
        t0 = time.perf_counter()
        stored = cv2_filestorage(cv2, _CV2_CARD["corners"], tmp)
        host[f"FileStorage write + read {len(_CV2_CARD['corners'])} corners, "
             f"{len(stored)} formats"] = (time.perf_counter() - t0) * 1e3
    print(f"cv2 facade ms per call at {W}x{H}, numpy in and out ({smi}), slowest first: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(times.items(), key=lambda kv: -kv[1])),
          flush=True)
    print(f"cv2 facade host-only ms per call (no card work; host clock; {smi}): " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(host.items(), key=lambda kv: -kv[1])), flush=True)


# ----------------------------------------------------------------------------------
# Phase 3u: the rest of the cv2 facade (Queue 1 item 7b), one cv2 user's script

CV2L_SMALL = (640, 360)  # the host copies' frame: frame 0 resized (INTER_AREA)
CV2L_MARKERS = (1280, 720, 160)  # the aruco page: width, height, marker side
CV2L_MARKER_IDS = (0, 7, 19, 42)  # DICT_4X4_50
CV2L_GFTT = (500, 0.01, 10)  # maxCorners, qualityLevel, minDistance
CV2L_FISHEYE = (np.array([[1100.0, 0, 960], [0, 1100.0, 540], [0, 0, 1]]),
                np.array([0.05, -0.01, 0.002, -0.0004]))  # K, D
CV2L_BOARD = (9, 6, 0.025)  # inner corners (cols, rows), square side (m)
CV2L_CALIB_K = np.array([[1400.0, 0, 960], [0, 1400.0, 540], [0, 0, 1]])
CV2L_CALIB_DIST = np.array([-0.12, 0.04, 0.0005, -0.0008, 0.0])
CV2L_VIEWS = 8
CV2L_QR = "rustcv_tpu_torch.cv2 item 7b"
CV2L_NMS = 200  # seeded boxes
CV2L_DETAIL = (400, 240)  # the crops' width, the second crop's x: an overlap of 160 px
# Jobs of phase 3u: the card side runs them all in one process, the CPU side
# one per worker call. "gftt <t>" per clip frame; the rest once.
CV2L_CARD_JOBS = ("quality", "farneback", "lk", "fisheye", "thresholdWithMask")
CV2L_HOST_JOBS = ("blobFromImage", "addText", "dis", "ecc", "detectors", "qr", "aruco",
                  "subdiv", "detail", "nms", "calibration")
CV2L_JOB_CALLS = {  # what phase 4u prints for a host job
    "blobFromImage": "dnn.blobFromImage 640x640", "addText": "addText",
    "dis": "DISOpticalFlow.calc fast", "ecc": "findTransformECC",
    "detectors": "SimpleBlobDetector.detect + MSER.detectRegions + LineSegmentDetector.detect",
    "qr": "QRCodeEncoder.encode + paste + QRCodeDetector.detectAndDecode",
    "aruco": "aruco generateImageMarker x4 + ArucoDetector.detectMarkers",
    "subdiv": "GFTTDetector.detect + Subdiv2D.insert + getTriangleList",
    "detail": "detail.FeatherBlender + detail.MultiBandBlender",
    "nms": f"dnn.NMSBoxes ({CV2L_NMS} boxes)",
    "calibration": "calibrateCameraExtended + solvePnPGeneric",
}


def cv2l_jobs(n_frames: int) -> list:
    return [f"gftt {t}" for t in range(n_frames)] + list(CV2L_CARD_JOBS + CV2L_HOST_JOBS)


def cv2l_flow_pair(cv2, frames) -> tuple:
    """Frames 0 and 1 of the clip in gray with the same seeded texture
    added to both (smoothed normal noise, σ 10): the clip's colour bars are
    flat, and Farnebäck's flow there is undetermined (thousands of px at
    1080p, on the card and on the CPU alike)."""
    h, w = frames[0].shape[:2]
    n = np.random.default_rng(41).normal(0, 30, (h + 2, w + 2))
    tex = sum(n[i:i + h, j:j + w] for i in range(3) for j in range(3)) / 9
    return tuple(np.clip(cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) + tex, 0, 255).astype(np.uint8)
                 for f in frames[:2])


def _cv2l_kps(kps) -> np.ndarray:
    return np.array([(k.pt[0], k.pt[1], k.size, k.angle, k.response) for k in kps],
                    np.float64).reshape(-1, 5)


def _cv2l_views():
    """The 9×6 board's object points and its projections in CV2L_VIEWS
    known poses, seeded."""
    cols, rows, side = CV2L_BOARD
    obj = np.zeros((cols * rows, 3), np.float32)
    obj[:, :2] = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2) * side
    rng = np.random.default_rng(23)
    objs, imgs = [], []
    for _ in range(CV2L_VIEWS):
        rv = rng.uniform(-0.35, 0.35, 3)
        tv = np.array([rng.uniform(-0.12, 0.02), rng.uniform(-0.08, 0.0), rng.uniform(0.45, 0.7)])
        cam = obj.astype(np.float64) @ _rodrigues(rv).T + tv
        x, y = cam[:, 0] / cam[:, 2], cam[:, 1] / cam[:, 2]
        k1, k2, p1, p2, k3 = CV2L_CALIB_DIST
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
        xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        K = CV2L_CALIB_K
        uv = np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], 1)
        objs.append(obj.reshape(-1, 1, 3))
        imgs.append(uv.astype(np.float32).reshape(-1, 1, 2))
    return objs, imgs


def _rodrigues(rv) -> np.ndarray:
    th = float(np.linalg.norm(rv))
    k = rv / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * (kx @ kx)


def _cv2l_marker_page(cv2) -> np.ndarray:
    w, h, side = CV2L_MARKERS
    d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_4X4_50)
    page = np.full((h, w), 255, np.uint8)
    for i, mid in enumerate(CV2L_MARKER_IDS):  # a 2×2 grid
        y, x = h // 9 + (i // 2) * (h // 2), w // 8 + (i % 2) * (w // 2)
        page[y:y + side, x:x + side] = cv2.aruco.generateImageMarker(d, mid, side)
    return page


def _cv2l_qr_page(cv2, small) -> np.ndarray:
    """The QR code of CV2L_QR with a 4-module quiet zone, pasted into the
    frame at up to 6 px a module."""
    code = cv2.QRCodeEncoder_create().encode(CV2L_QR)  # 255 marks a dark module
    px = min(6, (min(small.shape[:2]) - 20) // (code.shape[0] + 8))
    big = np.kron(code, np.ones((px, px), np.uint8))
    q, z = big.shape[0] + 8 * px, 4 * px
    page = small.copy()
    page[10:10 + q, 10:10 + q] = 255
    page[10 + z:10 + z + big.shape[0], 10 + z:10 + z + big.shape[1]] = (255 - big)[..., None]
    return page


def cv2l_call(cv2, job: str, frames, img) -> dict:
    """One job of phase 3u's script on ``frames`` (numpy BGR at the clip's
    size), by name → output (numpy, or tuples of numpy and numbers); ``img``
    makes what this side passes (numpy on the card's side, a CPU tensor on
    the CPU's)."""
    out = {}
    f0 = frames[0]
    g0 = cv2.cvtColor(f0, cv2.COLOR_BGR2GRAY)
    if job.startswith("gftt"):
        t = int(job.split()[1])
        kps = cv2.GFTTDetector_create(*CV2L_GFTT).detect(img(frames[t]))
        out[f"GFTTDetector.detect {t}"] = _cv2l_kps(kps)
    elif job == "quality":
        pts, q = cv2.goodFeaturesToTrackWithQuality(img(g0), *CV2L_GFTT, useHarrisDetector=True)
        out["goodFeaturesToTrackWithQuality harris"] = (pts, q)
    elif job in ("farneback", "lk"):
        t0, t1 = cv2l_flow_pair(cv2, frames)
        if job == "farneback":
            out["FarnebackOpticalFlow.calc"] = cv2.FarnebackOpticalFlow_create().calc(
                img(t0), img(t1), None)
        else:
            kps = cv2.GFTTDetector_create(*CV2L_GFTT).detect(img(t0))
            pts = cv2.KeyPoint_convert(kps).reshape(-1, 1, 2)
            nxt, st, _err = cv2.SparsePyrLKOpticalFlow_create().calc(img(t0), img(t1), pts, None)
            out["SparsePyrLKOpticalFlow.calc"] = (nxt, st)
    elif job == "fisheye":
        K, D = CV2L_FISHEYE
        out["fisheye.undistortImage"] = cv2.fisheye.undistortImage(img(f0), K, D, Knew=K)
    elif job == "blobFromImage":
        out["dnn.blobFromImage 640x640"] = cv2.dnn.blobFromImage(img(f0), 1 / 255, (640, 640),
                                                                swapRB=True)
    elif job == "addText":
        canvas = img(f0.copy())
        cv2.addText(canvas, "rustcv_tpu_torch.cv2 item 7b", (10, f0.shape[0] * 9 // 10),
                    "DejaVu Sans", 28, (0, 255, 255))
        out["addText"] = canvas
    else:
        small = cv2.resize(f0, CV2L_SMALL, interpolation=cv2.INTER_AREA)
        s1 = cv2.resize(frames[1], CV2L_SMALL, interpolation=cv2.INTER_AREA)
        sg0 = cv2.cvtColor(small, cv2.COLOR_BGR2GRAY)
        sg1 = cv2.cvtColor(s1, cv2.COLOR_BGR2GRAY)
        if job == "thresholdWithMask":
            mask = np.zeros(sg0.shape, np.uint8)
            mask[60:300, 100:540] = 1
            dst = img(sg1.copy())
            cv2.thresholdWithMask(img(sg0), dst, mask, 127, 255, cv2.THRESH_BINARY)
            out["thresholdWithMask"] = dst
        elif job == "dis":
            dis = cv2.DISOpticalFlow_create(cv2.DISOpticalFlow_PRESET_FAST)
            out["DISOpticalFlow.calc fast"] = dis.calc(img(sg0), img(sg1), None)
        elif job == "ecc":
            out["findTransformECC"] = cv2.findTransformECC(img(sg0), img(sg1))
        elif job == "detectors":
            out["SimpleBlobDetector.detect"] = _cv2l_kps(
                cv2.SimpleBlobDetector_create().detect(img(sg0)))
            regions, boxes = cv2.MSER_create().detectRegions(img(sg0))
            out["MSER.detectRegions"] = (tuple(regions), boxes)
            out["LineSegmentDetector.detect"] = cv2.createLineSegmentDetector().detect(img(sg0))
        elif job == "qr":
            page = _cv2l_qr_page(cv2, small)
            text, pts, _ = cv2.QRCodeDetector().detectAndDecode(img(page))
            out["QRCodeEncoder.encode + QRCodeDetector.detectAndDecode"] = (text, pts)
        elif job == "aruco":
            d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_4X4_50)
            corners, ids, _ = cv2.aruco.ArucoDetector(d).detectMarkers(
                img(_cv2l_marker_page(cv2)))
            out["aruco.ArucoDetector.detectMarkers"] = (tuple(corners), ids)
        elif job == "subdiv":
            kps = cv2.GFTTDetector_create(*CV2L_GFTT).detect(img(f0))
            sd = cv2.Subdiv2D((0, 0, f0.shape[1], f0.shape[0]))
            sd.insert([k.pt for k in kps])
            out["Subdiv2D over the GFTT corners"] = sd.getTriangleList()
        elif job == "detail":
            w, x1 = CV2L_DETAIL
            crops = [small[:, :w].copy(), small[:, x1:x1 + w].copy()]
            corners, sizes = [(0, 0), (x1, 0)], [(w, small.shape[0])] * 2
            mask = np.full((small.shape[0], w), 255, np.uint8)
            for name, blender in (("detail.FeatherBlender", cv2.detail.FeatherBlender()),
                                  ("detail.MultiBandBlender", cv2.detail.MultiBandBlender())):
                blender.prepare(corners, sizes)
                for c, tl in zip(crops, corners):
                    blender.feed(img(c), mask, tl)
                out[name] = blender.blend()
        elif job == "nms":
            rng = np.random.default_rng(31)
            xy = rng.uniform(0, 600, (CV2L_NMS, 2))
            wh = rng.uniform(20, 120, (CV2L_NMS, 2))
            boxes = [tuple(b) for b in np.concatenate([xy, wh], 1).round(1)]
            scores = rng.uniform(0, 1, CV2L_NMS).round(4).tolist()
            out["dnn.NMSBoxes"] = cv2.dnn.NMSBoxes(boxes, scores, 0.3, 0.45)
        elif job == "calibration":
            objs, imgs = _cv2l_views()
            size = (int(2 * CV2L_CALIB_K[0, 2]), int(2 * CV2L_CALIB_K[1, 2]))
            rms, K, dist, rvs, tvs, *_rest, pve = cv2.calibrateCameraExtended(
                objs, imgs, size, None, None)
            out["calibrateCameraExtended"] = (rms, K, dist, tuple(rvs), tuple(tvs), pve)
            n, rv, tv, err = cv2.solvePnPGeneric(objs[0], imgs[0], K, dist)
            out["solvePnPGeneric"] = (n, tuple(rv), tuple(tv), err)
        else:
            raise ValueError(job)
    return out


def cv2l_check(name: str, got, want) -> str:
    """Phase 3u's bar for one output, card against CPU, as the CPU tests
    hold it; a note to print."""
    if name.startswith("FarnebackOpticalFlow"):
        d = np.abs(got.astype(np.float64) - want)
        expect(got.shape == want.shape and got.dtype == want.dtype, f"{name}: shape or dtype")
        expect(np.quantile(d, 0.99) < 1e-3 and d.max() < 0.05,
               f"{name}: 99th pct {np.quantile(d, 0.99):.3g}, max {d.max():.3g} px")
        return f"{d.max():.3g} px"
    if name.startswith("SparsePyrLK"):
        (pts, st), (wpts, wst) = got, want
        expect(np.array_equal(st, wst), f"{name}: status differs at {int((st != wst).sum())}")
        d = np.abs(pts - wpts).max(initial=0)
        expect(d < 1e-3, f"{name}: max |diff| {d:.3g} px")
        return f"{d:.3g} px on {int(st.sum())} tracked of {len(st)}"
    if name.startswith("goodFeaturesToTrackWithQuality"):
        (pts, q), (wpts, wq) = got, want
        expect(np.array_equal(pts, wpts), f"{name}: other corners")
        expect(q.dtype == wq.dtype and np.allclose(q, wq, **HARRIS_TOL),
               f"{name}: quality {np.abs(q - wq).max():.3g} apart")
        return f"{len(pts)} corners, quality {np.abs(q - wq).max(initial=0):.3g} apart"
    _cv2l_equal(name, got, want)
    return "equal"


def _cv2l_equal(name, got, want) -> None:
    if isinstance(want, (tuple, list)):
        expect(isinstance(got, (tuple, list)) and len(got) == len(want), f"{name}: length")
        for i, (g, w) in enumerate(zip(got, want)):
            _cv2l_equal(f"{name}[{i}]", g, w)
        return
    if isinstance(want, np.ndarray):
        expect(isinstance(got, np.ndarray) and got.shape == want.shape
               and got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True),
               f"{name}: card and CPU differ")
        return
    expect(type(got) is type(want) and got == want, f"{name}: {got!r} against {want!r}")


_CV2L_HOST = {}  # a worker's frames, loaded at its first call


def cv2l_host(job: str, path: str):
    """One job of phase 3u's CPU side in a worker process, on CPU tensors.
    Returns its outputs as numpy, and its seconds."""
    import pickle

    import torch

    torch.set_num_threads(2)
    import rustcv_tpu_torch.cv2 as cv2

    if _CV2L_HOST.get("path") != path:
        with open(path, "rb") as f:
            _CV2L_HOST.update(frames=pickle.load(f), path=path)
    t0 = time.perf_counter()
    out = cv2l_call(cv2, job, _CV2L_HOST["frames"], torch.from_numpy)
    return {k: _cv2l_plain(v) for k, v in out.items()}, time.perf_counter() - t0


def _cv2l_plain(x):
    """Outputs as numpy: a tensor written in place comes home."""
    if isinstance(x, (tuple, list)):
        return tuple(_cv2l_plain(v) for v in x)
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return x


_CV2L_CARD = {}  # phase 3u's frames and host seconds, which phase 4u reuses


def run_cv2_later() -> dict:
    """Phase 3u: the rest of the cv2 facade (item 7b) through ``import
    rustcv_tpu_torch.cv2 as cv2``, numpy in and out, on phase 3t's clip at
    1920×1080: ``GFTTDetector.detect`` per frame (K6 int32),
    ``goodFeaturesToTrackWithQuality(useHarrisDetector=True)`` (K6 int32
    and float32), the Farnebäck and sparse LK objects between frames 0 and
    1 (textured: :func:`cv2l_flow_pair`), ``fisheye.undistortImage``, ``dnn.blobFromImage`` and ``addText``;
    then host copies on a 640×360 resize of frame 0 (DIS, ECC, the blob,
    MSER and line-segment detectors, a QR code encoded, pasted and read
    back, ``Subdiv2D`` over the corners, the ``detail`` blenders on two
    crops, ``dnn.NMSBoxes``, ``thresholdWithMask``), four ArUco markers on a
    1280×720 page, and ``calibrateCameraExtended`` / ``solvePnPGeneric`` on
    a 9×6 board's projections in 8 known poses. Every result is held against
    the same call on CPU tensors in CV2_WORKERS spawned CPU processes; the
    markers, the QR text and the calibration against their truth too.
    Fails unless both K6 forms launched from these calls. Returns the
    launches of the card's run."""
    import multiprocessing
    import pickle
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    import torch

    import rustcv_tpu_torch.cv2 as cv2
    from rustcv_tpu_torch.ops import kernels

    print(f"cv2 later: 1080p calls at {W}x{H}; host copies on frame 0 resized to "
          f"{CV2L_SMALL[0]}x{CV2L_SMALL[1]} (1080p takes over 2 s a call there)", flush=True)
    print(f"cv2 later: ArUco page {CV2L_MARKERS[0]}x{CV2L_MARKERS[1]}, markers "
          f"{CV2L_MARKERS[2]} px", flush=True)
    print(f"cv2 later: calibration on a {CV2L_BOARD[0]}x{CV2L_BOARD[1]} board's projections in "
          f"{CV2L_VIEWS} poses (no detection)", flush=True)
    t0 = time.perf_counter()
    frames = cv2_clip(W, H, CV2_FRAMES)
    jobs = cv2l_jobs(len(frames))
    pool = ProcessPoolExecutor(max_workers=CV2_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "frames.pkl")
            with open(path, "wb") as f:
                pickle.dump(frames, f)
            futures = {job: pool.submit(cv2l_host, job, path) for job in jobs}
            # K6 through the 7b wrappers: exactly one int32 launch per GFTT
            # detect, one of each form for the quality call
            kernels.reset_launch_counts()
            cv2.GFTTDetector_create(*CV2L_GFTT).detect(frames[0])
            torch.cuda.synchronize()
            k_gftt = kernels.launch_counts()
            kernels.reset_launch_counts()
            cv2.goodFeaturesToTrackWithQuality(cv2.cvtColor(frames[0], cv2.COLOR_BGR2GRAY),
                                               *CV2L_GFTT, useHarrisDetector=True)
            torch.cuda.synchronize()
            k_quality = kernels.launch_counts()
            expect(k_gftt["harris_response_i32"] == 1 and k_gftt["harris_response_f32"] == 0,
                   f"GFTTDetector.detect launched {k_gftt}")
            expect(k_quality["harris_response_i32"] == 1
                   and k_quality["harris_response_f32"] == 1,
                   f"goodFeaturesToTrackWithQuality(useHarrisDetector=True) launched {k_quality}")
            got, card_s = {}, {}
            kernels.reset_launch_counts()  # the 7b path starts here
            for job in jobs:
                tj = time.perf_counter()
                got.update(cv2l_call(cv2, job, frames, lambda a: a))
                torch.cuda.synchronize()
                card_s[job] = time.perf_counter() - tj
            counts = kernels.launch_counts()  # read just after the 7b path
            t_card = time.perf_counter() - t0
            expect(counts["harris_response_f32"] >= 1 and counts["harris_response_i32"] >= 1,
                   f"phase 3u: the 7b calls did not reach both K6 forms: {counts}")
            want, host_s = {}, {}
            for job in jobs:
                out, host_s[job] = futures[job].result(timeout=600)
                want.update(out)
            t_wait = time.perf_counter() - t0 - t_card
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    expect(sorted(want) == sorted(got), "the CPU side ran other calls")
    notes = {}
    for name in got:
        base = name.rsplit(" ", 1)[0] if name.startswith("GFTTDetector") else name
        note = cv2l_check(name, _cv2l_plain(got[name]), want[name])
        notes.setdefault(base, note)
    # the truth of what has one
    text = got["QRCodeEncoder.encode + QRCodeDetector.detectAndDecode"][0]
    expect(text == CV2L_QR, f"the QR code read back {text!r}")
    ids = got["aruco.ArucoDetector.detectMarkers"][1]
    expect(ids is not None and sorted(ids.ravel().tolist()) == sorted(CV2L_MARKER_IDS),
           f"ArUco found {None if ids is None else ids.ravel().tolist()}")
    K = got["calibrateCameraExtended"][1]
    kerr = float(np.abs(K[:2, :3] - CV2L_CALIB_K[:2, :3]).max() / CV2L_CALIB_K[0, 0])
    expect(kerr < 0.01, f"calibrateCameraExtended: K {kerr:.3g} of fx off the truth")
    expect(got["solvePnPGeneric"][0] >= 1, "solvePnPGeneric found no pose")
    _CV2L_CARD.update(frames=frames, card_s=card_s)
    print(f"cv2 later (item 7b) at {W}x{H}, numpy in and out: {len(got)} results on the card "
          "== the CPU port on CPU tensors: " + "; ".join(f"{k}: {v}" for k, v in notes.items())
          + f"; QR read back, {len(CV2L_MARKER_IDS)} markers found, calibration K within "
          f"{kerr:.2g} of fx of the truth", flush=True)
    print(f"cv2 later: K6 per call: GFTTDetector.detect {k_gftt['harris_response_i32']} int32; "
          f"goodFeaturesToTrackWithQuality(useHarrisDetector=True) "
          f"{k_quality['harris_response_i32']} int32 + {k_quality['harris_response_f32']} "
          f"float32", flush=True)
    print(f"cv2 later: card side {t_card:.1f} s, then waiting for the CPU side {t_wait:.1f} s; "
          f"launches {({k: v for k, v in counts.items() if v})}; card seconds per job: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(card_s.items(), key=lambda kv: -kv[1]))
          + "; host seconds per job: " + ", ".join(
              f"{k} {v:.2f}" for k, v in sorted(host_s.items(), key=lambda kv: -kv[1])),
          flush=True)
    return counts


def time_cv2_later(smi: str) -> None:
    """Phase 4u: ms per call of phase 3u's card calls at their sizes, numpy
    in and out (CUDA events over CV2_REPS calls after a warm one), slowest
    first, with the card's name and power limit; the host-only calls (one
    call each after phase 3u's warm one, host clock) on a line of their
    own. Never gated."""
    import rustcv_tpu_torch.cv2 as cv2

    frames = _CV2L_CARD["frames"]
    f0 = frames[0]
    g0 = cv2.cvtColor(f0, cv2.COLOR_BGR2GRAY)
    t0, t1 = cv2l_flow_pair(cv2, frames)
    sg0 = cv2.cvtColor(cv2.resize(f0, CV2L_SMALL, interpolation=cv2.INTER_AREA),
                       cv2.COLOR_BGR2GRAY)
    mask = np.zeros(sg0.shape, np.uint8)
    mask[60:300, 100:540] = 1
    dst = sg0.copy()
    gftt = cv2.GFTTDetector_create(*CV2L_GFTT)
    pts = cv2.KeyPoint_convert(gftt.detect(t0)).reshape(-1, 1, 2)
    fb = cv2.FarnebackOpticalFlow_create()
    lk = cv2.SparsePyrLKOpticalFlow_create()
    K, D = CV2L_FISHEYE
    calls = {
        "GFTTDetector.detect (K6 i32)": lambda: gftt.detect(f0),
        "goodFeaturesToTrackWithQuality harris (K6 i32 + f32)": lambda: (
            cv2.goodFeaturesToTrackWithQuality(g0, *CV2L_GFTT, useHarrisDetector=True)),
        "FarnebackOpticalFlow.calc": lambda: fb.calc(t0, t1, None),
        f"SparsePyrLKOpticalFlow.calc ({len(pts)} points)": lambda: lk.calc(t0, t1, pts, None),
        "fisheye.undistortImage": lambda: cv2.fisheye.undistortImage(f0, K, D, Knew=K),
        f"thresholdWithMask {CV2L_SMALL[0]}x{CV2L_SMALL[1]}": lambda: cv2.thresholdWithMask(
            sg0, dst, mask, 127, 255, cv2.THRESH_BINARY),
    }
    times = {name: cuda_ms(fn, CV2_REPS) for name, fn in calls.items()}
    host = {}
    for job in CV2L_HOST_JOBS:  # once each, the CPU workers gone
        t0 = time.perf_counter()
        cv2l_call(cv2, job, frames, lambda a: a)
        host[CV2L_JOB_CALLS.get(job, job)] = (time.perf_counter() - t0) * 1e3
    print(f"cv2 later ms per call at {W}x{H} (thresholdWithMask at {CV2L_SMALL[0]}x"
          f"{CV2L_SMALL[1]}), numpy in and out ({smi}), slowest first: " + ", ".join(
              f"{k} {v:.4f}" for k, v in sorted(times.items(), key=lambda kv: -kv[1])),
          flush=True)
    print(f"cv2 later host-only ms per call (one call each; host clock; {smi}; "
          f"blobFromImage and addText at {W}x{H}, the ArUco page at {CV2L_MARKERS[0]}x"
          f"{CV2L_MARKERS[1]}, the rest at {CV2L_SMALL[0]}x{CV2L_SMALL[1]}): " + ", ".join(
              f"{k} {v:.4f}" for k, v in sorted(host.items(), key=lambda kv: -kv[1])),
          flush=True)


class PhaseFailure(Exception):
    """A phase failed; its name and traceback are already printed."""


def phase(label: str, fn, *args):
    """``fn(*args)``; on any error print ``chip_smoke: FAIL in <label>:
    <message>`` and the traceback on stdout and on stderr, then raise
    PhaseFailure."""
    try:
        return fn(*args)
    except Exception as e:  # the boundary of a phase: report which one failed
        tb = traceback.format_exc()
        for stream in (sys.stdout, sys.stderr):
            print(f"chip_smoke: FAIL in {label}: {e}", file=stream, flush=True)
            print(tb, file=stream, flush=True)
        raise PhaseFailure(label) from e


def read_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def build_kernels() -> None:
    """Phase 1: build (nvcc) or load the CUDA kernels."""
    from rustcv_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    print(f"kernels built in {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s): "
          f"{info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  ptxas: " + line.strip(), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()

    def done(label: str) -> None:
        print(f"[{time.perf_counter() - t0:.1f} s] {label} done", flush=True)

    try:
        smi = phase("nvidia-smi", read_smi)
        print(smi, flush=True)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"device {torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}", flush=True)
        phase("phase 1, kernel build", build_kernels)
        phase("phase 1, native library", build_native)
        errs = phase("phase 2, kernels vs plain", check_kernels, dev)
        k7_launches, errs["mosaic_shuffle"] = phase("phase 2, K7 probe", run_mosaic_probe, dev)
        done("phases 1-2")
        launches = {name: 0 for name in KERNELS}
        for label, path in (("headline", run_main_path), ("config 4", run_config4),
                            ("response surface", lambda: run_response_surface(dev)),
                            ("K7 probe", lambda: k7_launches), ("config 6", run_config6),
                            ("host path", run_host_path), ("config 2", run_config2),
                            ("formats", run_formats), ("chained graphs", run_chained_graphs),
                            ("set_resolution", run_set_resolution),
                            ("configs 1, 3, 5", run_zoo_configs), ("facade", run_facade),
                            ("mesh", run_mesh), ("slice ops, xla_fused, ring, V4L2", run_slice),
                            ("second block of ops (3o)", run_block2),
                            ("group 2, features and flow (3p)", run_group2),
                            ("group 3 and segmentation (3q)", run_group3),
                            ("group 4a (3r)", run_group4a),
                            ("group 4b, the geometry chain (3s)", run_group4b),
                            ("the cv2 facade (3t)", run_cv2),
                            ("the rest of the cv2 facade (3u)", run_cv2_later)):
            for name, count in phase(f"phase 3, {label}", path).items():
                launches[name] += count
            done(f"phase 3, {label}")
        phase("phase 3, launches", lambda: expect(all(v > 0 for v in launches.values()),
                                                  f"a kernel never launched: {launches}"))
        text_launches = phase("phase 3, text and host codecs", run_text_and_codecs)
        print(f"phase 3, text and host codecs: launches apart from the kernels line "
              f"{ {k: v for k, v in text_launches.items() if v} }", flush=True)
        done("phase 3, text and host codecs")
        phase("phase 3v, the formats of item 8a", run_formats_8a)
        done("phase 3v, the formats of item 8a")
        phase("phase 3w, TIFF and GIF (item 8b)", run_formats_8b)
        done("phase 3w, TIFF and GIF (item 8b)")
        phase("phase 3x, WebP reads (item 8c)", run_formats_8c)
        done("phase 3x, WebP reads (item 8c)")
        phase("phase 3y, WebP writes (item 8c-ii)", run_formats_8c_writes)
        done("phase 3y, WebP writes (item 8c-ii)")
        phase("phase 3z, animated PNG and the median cut (item 8d-i)", run_formats_8d)
        done("phase 3z, animated PNG and the median cut (item 8d-i)")
        phase("phase 3za, PNG writes with Pillow's filters (item 8d-ii-a)", run_formats_8d_writes)
        done("phase 3za, PNG writes with Pillow's filters (item 8d-ii-a)")
        phase("phase 3zb, JPEG forms (item 8d-ii-b)", run_formats_8d_ii_b)
        done("phase 3zb, JPEG forms (item 8d-ii-b)")
        phase("phase 3zc, TIFF JPEG and YCbCr pages (item 8d-ii-c-i)", run_formats_8d_ii_c)
        done("phase 3zc, TIFF JPEG and YCbCr pages (item 8d-ii-c-i)")
        for label, fn in (("headline", time_engines), ("config 4", time_config4),
                          ("config 4 stages", time_config4_stages),
                          ("config 4 profile", profile_config4), ("config 6", time_config6),
                          ("config 6 stages", time_config6_stages),
                          ("config 6 profile", profile_config6), ("host path", time_host_path),
                          ("config 2", time_config2),
                          ("formats, chained configs 1 and 4, configs 3 and 5",
                           lambda: time_new_paths(smi)), ("facade", lambda: time_facade(smi)),
                          ("text and host codecs", lambda: time_text_and_codecs(smi)),
                          ("the formats of item 8a (4v)", lambda: time_formats_8a(smi)),
                          ("TIFF and GIF (4w)", lambda: time_formats_8b(smi)),
                          ("WebP reads (4x)", lambda: time_formats_8c(smi)),
                          ("WebP writes (4y)", lambda: time_formats_8c_writes(smi)),
                          ("animated PNG and the median cut (4z)",
                           lambda: time_formats_8d(smi)),
                          ("PNG writes with Pillow's filters (4za)",
                           lambda: time_formats_8d_writes(smi)),
                          ("JPEG forms (4zb)", lambda: time_formats_8d_ii_b(smi)),
                          ("TIFF JPEG and YCbCr pages (4zc)", lambda: time_formats_8d_ii_c(smi)),
                          ("mesh", lambda: time_mesh(smi)),
                          ("slice ops, xla_fused, ring", lambda: time_slice(smi)),
                          ("second block of ops (4o)", lambda: time_block2(smi)),
                          ("group 2, features and flow (4p)", lambda: time_group2(smi)),
                          ("group 3 and segmentation (4q)", lambda: time_group3(smi)),
                          ("group 4a (4r)", lambda: time_group4a(smi)),
                          ("group 4b, the geometry chain (4s)", lambda: time_group4b(smi)),
                          ("the cv2 facade (4t)", lambda: time_cv2(smi)),
                          ("the rest of the cv2 facade (4u)", lambda: time_cv2_later(smi))):
            phase(f"phase 4, {label}", fn)
            done(f"phase 4, {label}")
        times = phase("phase 4, kernels", time_kernels)
        done("phase 4")
    except PhaseFailure:
        return 1
    finally:
        os.environ.pop("RUSTCV_DECODE", None)
        import torch.distributed as dist

        if dist.is_initialized():  # the mesh phase's one-rank NCCL group
            dist.destroy_process_group()

    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name], **times[name]}
        for name, (src, rep) in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
