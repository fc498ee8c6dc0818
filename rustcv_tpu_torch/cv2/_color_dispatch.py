"""Extended cvtColor dispatch (a copy of ``rustcv_tpu.cv2._color_dispatch``):
the ~100 u8 codes the core dispatch lacks, routed to ``ops/color_cv2.py``'s
host forms. Host code: it takes and returns numpy arrays. Returns None for
codes it does not handle (the caller raises)."""
from __future__ import annotations

import numpy as np

from . import _constants as _C
from ..ops import color_cv2 as cc


def _by_names(names):
    out = {}
    for n, v in names:
        code = getattr(_C, n, None)
        if code is not None:
            out[int(code)] = v
    return out


# families keyed by constant NAME so alias ints collapse naturally
_SHUFFLE = _by_names([
    ("COLOR_BGR2RGBA", ("rev3", True)),      # swap + alpha
    ("COLOR_RGBA2BGR", ("rev_drop", None)),
    ("COLOR_BGRA2RGBA", ("rev4", None)),
])

_PACK16 = _by_names([
    ("COLOR_BGR2BGR565", ("pack", 6, False)),
    ("COLOR_RGB2BGR565", ("pack", 6, True)),
    ("COLOR_BGRA2BGR565", ("pack", 6, False)),
    ("COLOR_RGBA2BGR565", ("pack", 6, True)),
    ("COLOR_BGR2BGR555", ("pack", 5, False)),
    ("COLOR_RGB2BGR555", ("pack", 5, True)),
    ("COLOR_BGRA2BGR555", ("pack", 5, False)),
    ("COLOR_RGBA2BGR555", ("pack", 5, True)),
    ("COLOR_BGR5652BGR", ("unpack", 6, False, False)),
    ("COLOR_BGR5652RGB", ("unpack", 6, True, False)),
    ("COLOR_BGR5652BGRA", ("unpack", 6, False, True)),
    ("COLOR_BGR5652RGBA", ("unpack", 6, True, True)),
    ("COLOR_BGR5552BGR", ("unpack", 5, False, False)),
    ("COLOR_BGR5552RGB", ("unpack", 5, True, False)),
    ("COLOR_BGR5552BGRA", ("unpack", 5, False, True)),
    ("COLOR_BGR5552RGBA", ("unpack", 5, True, True)),
    ("COLOR_BGR5652GRAY", ("to_gray", 6)),
    ("COLOR_BGR5552GRAY", ("to_gray", 5)),
    ("COLOR_GRAY2BGR565", ("from_gray", 6)),
    ("COLOR_GRAY2BGR555", ("from_gray", 5)),
])

_SIMPLE = _by_names([
    ("COLOR_BGR2XYZ", lambda a: cc.bgr_to_xyz_cv(a)),
    ("COLOR_RGB2XYZ", lambda a: cc.bgr_to_xyz_cv(a, rgb=True)),
    ("COLOR_XYZ2BGR", lambda a: cc.xyz_to_bgr_cv(a)),
    ("COLOR_XYZ2RGB", lambda a: cc.xyz_to_bgr_cv(a, rgb=True)),
    ("COLOR_BGR2YUV", lambda a: cc.bgr_to_yuv_cv(a)),
    ("COLOR_RGB2YUV", lambda a: cc.bgr_to_yuv_cv(a, rgb=True)),
    ("COLOR_YUV2BGR", lambda a: cc.yuv_to_bgr_cv(a)),
    ("COLOR_YUV2RGB", lambda a: cc.yuv_to_bgr_cv(a, rgb=True)),
    ("COLOR_BGR2HSV_FULL", lambda a: cc.bgr_to_hsv_full_cv(a)),
    ("COLOR_RGB2HSV_FULL", lambda a: cc.bgr_to_hsv_full_cv(a, rgb=True)),
    ("COLOR_HSV2BGR_FULL", lambda a: cc.hsv_to_bgr_full_cv(a)),
    ("COLOR_HSV2RGB_FULL", lambda a: cc.hsv_to_bgr_full_cv(a, rgb=True)),
    ("COLOR_BGR2HLS", lambda a: cc.bgr_to_hls_cv(a)),
    ("COLOR_RGB2HLS", lambda a: cc.bgr_to_hls_cv(a, rgb=True)),
    ("COLOR_HLS2BGR", lambda a: cc.hls_to_bgr_cv(a)),
    ("COLOR_HLS2RGB", lambda a: cc.hls_to_bgr_cv(a, rgb=True)),
    ("COLOR_BGR2HLS_FULL", lambda a: cc.bgr_to_hls_cv(a, full=True)),
    ("COLOR_RGB2HLS_FULL", lambda a: cc.bgr_to_hls_cv(a, rgb=True,
                                                      full=True)),
    ("COLOR_HLS2BGR_FULL", lambda a: cc.hls_to_bgr_cv(a, full=True)),
    ("COLOR_HLS2RGB_FULL", lambda a: cc.hls_to_bgr_cv(a, rgb=True,
                                                      full=True)),
    ("COLOR_BGR2Luv", lambda a: cc.bgr_to_luv_cv(a)),
    ("COLOR_RGB2Luv", lambda a: cc.bgr_to_luv_cv(a, rgb=True)),
    ("COLOR_Luv2BGR", lambda a: cc.luv_to_bgr_cv(a)),
    ("COLOR_Luv2RGB", lambda a: cc.luv_to_bgr_cv(a, rgb=True)),
    ("COLOR_LBGR2Luv", lambda a: cc.bgr_to_luv_cv(a, srgb=False)),
    ("COLOR_LRGB2Luv", lambda a: cc.bgr_to_luv_cv(a, rgb=True,
                                                  srgb=False)),
    ("COLOR_Luv2LBGR", lambda a: cc.luv_to_bgr_cv(a, srgb=False)),
    ("COLOR_Luv2LRGB", lambda a: cc.luv_to_bgr_cv(a, rgb=True,
                                                  srgb=False)),
    ("COLOR_LBGR2Lab", lambda a: cc.bgr_to_lab_linear_cv(a)),
    ("COLOR_LRGB2Lab", lambda a: cc.bgr_to_lab_linear_cv(a, rgb=True)),
])

_YUV420_READ = _by_names([
    ("COLOR_YUV2BGR_NV12", ("nv12", False, False)),
    ("COLOR_YUV2RGB_NV12", ("nv12", True, False)),
    ("COLOR_YUV2BGRA_NV12", ("nv12", False, True)),
    ("COLOR_YUV2RGBA_NV12", ("nv12", True, True)),
    ("COLOR_YUV2BGR_NV21", ("nv21", False, False)),
    ("COLOR_YUV2RGB_NV21", ("nv21", True, False)),
    ("COLOR_YUV2BGRA_NV21", ("nv21", False, True)),
    ("COLOR_YUV2RGBA_NV21", ("nv21", True, True)),
    ("COLOR_YUV2BGR_I420", ("i420", False, False)),
    ("COLOR_YUV2RGB_I420", ("i420", True, False)),
    ("COLOR_YUV2BGRA_I420", ("i420", False, True)),
    ("COLOR_YUV2RGBA_I420", ("i420", True, True)),
    ("COLOR_YUV2BGR_YV12", ("yv12", False, False)),
    ("COLOR_YUV2RGB_YV12", ("yv12", True, False)),
    ("COLOR_YUV2BGRA_YV12", ("yv12", False, True)),
    ("COLOR_YUV2RGBA_YV12", ("yv12", True, True)),
])

_YUV420_WRITE = _by_names([
    ("COLOR_BGR2YUV_I420", ("i420", False)),
    ("COLOR_RGB2YUV_I420", ("i420", True)),
    ("COLOR_BGRA2YUV_I420", ("i420", False)),
    ("COLOR_RGBA2YUV_I420", ("i420", True)),
    ("COLOR_BGR2YUV_YV12", ("yv12", False)),
    ("COLOR_RGB2YUV_YV12", ("yv12", True)),
    ("COLOR_BGRA2YUV_YV12", ("yv12", False)),
    ("COLOR_RGBA2YUV_YV12", ("yv12", True)),
])

_YUV422_READ = _by_names([
    ("COLOR_YUV2BGR_YUY2", ("yuy2", False, False)),
    ("COLOR_YUV2RGB_YUY2", ("yuy2", True, False)),
    ("COLOR_YUV2BGRA_YUY2", ("yuy2", False, True)),
    ("COLOR_YUV2RGBA_YUY2", ("yuy2", True, True)),
    ("COLOR_YUV2BGR_YVYU", ("yvyu", False, False)),
    ("COLOR_YUV2RGB_YVYU", ("yvyu", True, False)),
    ("COLOR_YUV2BGRA_YVYU", ("yvyu", False, True)),
    ("COLOR_YUV2RGBA_YVYU", ("yvyu", True, True)),
    ("COLOR_YUV2BGR_UYVY", ("uyvy", False, False)),
    ("COLOR_YUV2RGB_UYVY", ("uyvy", True, False)),
    ("COLOR_YUV2BGRA_UYVY", ("uyvy", False, True)),
    ("COLOR_YUV2RGBA_UYVY", ("uyvy", True, True)),
])

_YUV422_WRITE = _by_names([
    ("COLOR_BGR2YUV_YUY2", ("yuy2", False)),
    ("COLOR_RGB2YUV_YUY2", ("yuy2", True)),
    ("COLOR_BGRA2YUV_YUY2", ("yuy2", False)),
    ("COLOR_RGBA2YUV_YUY2", ("yuy2", True)),
    ("COLOR_BGR2YUV_YVYU", ("yvyu", False)),
    ("COLOR_RGB2YUV_YVYU", ("yvyu", True)),
    ("COLOR_BGRA2YUV_YVYU", ("yvyu", False)),
    ("COLOR_RGBA2YUV_YVYU", ("yvyu", True)),
    ("COLOR_BGR2YUV_UYVY", ("uyvy", False)),
    ("COLOR_RGB2YUV_UYVY", ("uyvy", True)),
    ("COLOR_BGRA2YUV_UYVY", ("uyvy", False)),
    ("COLOR_RGBA2YUV_UYVY", ("uyvy", True)),
])

_GRAY = _by_names([
    ("COLOR_YUV2GRAY_420", "g420"),
    ("COLOR_YUV2GRAY_YUY2", "yuy2"),
    ("COLOR_YUV2GRAY_UYVY", "uyvy"),
])

_BAYER = _by_names([
    # cv2 names by the SECOND row; our demosaic by the first (see
    # cv2/__init__.py demosaicing docstring)
    ("COLOR_BayerBG2BGR", ("RGGB", False)),
    ("COLOR_BayerGB2BGR", ("GRBG", False)),
    ("COLOR_BayerRG2BGR", ("BGGR", False)),
    ("COLOR_BayerGR2BGR", ("GBRG", False)),
    ("COLOR_BayerBG2RGB", ("BGGR", False)),
    ("COLOR_BayerGB2RGB", ("GBRG", False)),
    ("COLOR_BayerRG2RGB", ("RGGB", False)),
    ("COLOR_BayerGR2RGB", ("GRBG", False)),
    ("COLOR_BayerBG2GRAY", ("RGGB", True)),
    ("COLOR_BayerGB2GRAY", ("GRBG", True)),
    ("COLOR_BayerRG2GRAY", ("BGGR", True)),
    ("COLOR_BayerGR2GRAY", ("GBRG", True)),
])


def try_convert(a: np.ndarray, code: int):
    """Extended-code conversion; None if unhandled."""
    code = int(code)
    if code in _SHUFFLE:
        kind, _ = _SHUFFLE[code]
        if kind == "rev3":
            alpha = np.full(a.shape[:2] + (1,), 255, a.dtype)
            return np.concatenate([a[..., 2::-1][..., :3], alpha], -1)
        if kind == "rev_drop":
            return a[..., 2::-1][..., :3].copy() if a.shape[-1] == 4 \
                else a[..., ::-1].copy()
        if kind == "rev4":
            return np.concatenate([a[..., 2::-1][..., :3],
                                   a[..., 3:4]], -1)
    if code in _PACK16:
        spec = _PACK16[code]
        if spec[0] == "pack":
            return cc.bgr_to_packed16(a, spec[1], spec[2])
        if spec[0] == "unpack":
            return cc.packed16_to_bgr(a, spec[1], spec[2], spec[3])
        if spec[0] == "to_gray":
            return cc.packed16_to_gray(a, spec[1])
        if spec[0] == "from_gray":
            return cc.gray_to_packed16(a, spec[1])
    if code in _SIMPLE:
        return _SIMPLE[code](a)
    if code in _YUV420_READ:
        kind, rgb, alpha = _YUV420_READ[code]
        y, u, v = cc.split_420_buffer(a, kind)
        return cc.yuv420_to_bgr_cv(y, u, v, rgb, alpha)
    if code in _YUV420_WRITE:
        kind, rgb = _YUV420_WRITE[code]
        return cc.bgr_to_yuv420_cv(a, kind, rgb)
    if code in _YUV422_READ:
        kind, rgb, alpha = _YUV422_READ[code]
        return cc.yuv422_to_bgr_cv(a, kind, rgb, alpha)
    if code in _YUV422_WRITE:
        kind, rgb = _YUV422_WRITE[code]
        return cc.bgr_to_yuv422_cv(a, kind, rgb)
    if code in _GRAY:
        k = _GRAY[code]
        return cc.yuv420_to_gray_cv(a) if k == "g420" \
            else cc.yuv422_to_gray_cv(a, k)
    if code in _BAYER:
        pattern, to_gray = _BAYER[code]
        from ..ops import golden
        out = golden.demosaic_bilinear(np.asarray(a), pattern)
        if to_gray:
            from ..ops.color import bgr_to_gray_cv
            return bgr_to_gray_cv(out)
        return out
    return None
