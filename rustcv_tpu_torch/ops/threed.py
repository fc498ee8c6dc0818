"""Copy of ``rustcv_tpu.ops.threed`` (the port's ``core_ops.RNG``), with
tensor twins of its two device functions.

OpenCV 5.0 ``3d`` module roles: point-cloud I/O (``savePointCloud``
/ ``loadPointCloud``), ``depthTo3d``, ``findPlanes`` and
``triangleRasterize``.

Frozen specs:
- PLY: ascii format (the exact header cv2 writes — interop round-trips
  both directions in tests); OBJ: ``v x y z`` lines;
- depth_to_3d: X = (u − cx)·d/fx, Y = (v − cy)·d/fy, Z = d — exact vs
  cv2 (which appends a zero 4th channel; we return (H, W, 3));
- find_planes: sequential RANSAC over the organized cloud (pinned MWC
  seeds) with a connected-inlier-region constraint; accepted planes
  oriented so c ≤ 0 (normal toward the camera, cv2's convention);
  labels: 255 = no plane, else the plane index;
- triangle_rasterize: perspective-less z-buffered barycentric fill of
  pre-projected vertices (x, y in pixels, z depth) with Gouraud
  (barycentric) vertex-color interpolation; top-left-ish tie rule:
  pixels with all barycentrics ≥ 0 are covered.

The rasterizer's tensor twin computes what a sequential z-buffer over the
triangles in index order computes: at each pixel, the first triangle
among those that cover it with the least z. Triangles go in chunks; each
chunk evaluates the three barycentric half-planes of its triangles over
the full frame (elementwise iota math), takes the least z per pixel with
the lower index first on ties, and merges into the running z-buffer with
a strict ``<``. The oracle loops triangles over their bounding boxes on
the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .core_ops import RNG
from .tensors import as_tensor

# Elements (triangles × pixels) of one chunk of the rasterizer: each float32
# plane of a chunk is 256 MiB at most.
_CHUNK_ELEMS = 1 << 26


# ---------------------------------------------------------------------------
# point-cloud I/O


def save_point_cloud(path: str, points: np.ndarray) -> None:
    """ascii PLY (or OBJ when the path ends in .obj)."""
    p = np.asarray(points, np.float32).reshape(-1, 3)
    if path.lower().endswith(".obj"):
        with open(path, "w") as fh:
            for x, y, z in p:
                fh.write(f"v {x:.9g} {y:.9g} {z:.9g}\n")
        return
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\ncomment created by rustcv_tpu\n"
                 f"element vertex {len(p)}\nproperty float x\n"
                 "property float y\nproperty float z\nend_header\n")
        for x, y, z in p:
            fh.write(f"{x:.9g} {y:.9g} {z:.9g}\n")


def load_point_cloud(path: str) -> np.ndarray:
    """→ (N, 3) float32. Reads our/cv2's ascii PLY and OBJ vertices."""
    if path.lower().endswith(".obj"):
        pts = []
        with open(path) as fh:
            for line in fh:
                if line.startswith("v "):
                    pts.append([float(v) for v in line.split()[1:4]])
        return np.asarray(pts, np.float32)
    with open(path, "rb") as fh:
        header = []
        while True:
            raw = fh.readline()
            if not raw:   # EOF before end_header: reject, don't spin
                raise ValueError(f"not a PLY file: {path}")
            line = raw.decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        n = 0
        for line in header:
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
        fmt = next((ln for ln in header if ln.startswith("format")), "")
        if "ascii" not in fmt:
            raise ValueError("only ascii PLY supported")
        pts = []
        for _ in range(n):
            vals = fh.readline().split()
            pts.append([float(vals[0]), float(vals[1]), float(vals[2])])
    return np.asarray(pts, np.float32)


# ---------------------------------------------------------------------------
# depth → organized cloud


def depth_to_3d(depth: np.ndarray, k) -> np.ndarray:
    """→ (H, W, 3) float32 camera-frame points (cv2 ``depthTo3d``
    without its zero 4th channel)."""
    d = np.asarray(depth, np.float64)
    k = np.asarray(k, np.float64)
    h, w = d.shape
    vs, us = np.mgrid[0:h, 0:w].astype(np.float64)
    x = (us - k[0, 2]) * d / k[0, 0]
    y = (vs - k[1, 2]) * d / k[1, 1]
    return np.stack([x, y, d], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# plane segmentation


def find_planes(points3d: np.ndarray, min_size: int = 200,
                threshold: float = 0.01, max_planes: int = 8,
                iters: int = 150, seed: int = 11
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Sequential RANSAC plane extraction on an organized cloud →
    (labels u8 (H, W): 255 = none, else plane id; coeffs (P, 4) with
    ‖(a,b,c)‖ = 1, c ≤ 0)."""
    pts = np.asarray(points3d, np.float64)
    h, w = pts.shape[:2]
    labels = np.full((h, w), 255, np.uint8)
    coeffs: List[np.ndarray] = []
    valid = np.isfinite(pts).all(-1) & (pts[..., 2] > 0)
    rng = RNG(seed)
    flat = pts.reshape(-1, 3)
    for plane_id in range(max_planes):
        avail = (labels == 255) & valid
        idx = np.nonzero(avail.ravel())[0]
        if len(idx) < max(min_size, 3):
            break
        best_inl = None
        best_plane = None
        for _ in range(iters):
            sel = [idx[rng.uniform_int(0, len(idx))] for _ in range(3)]
            p0, p1, p2 = flat[sel]
            n = np.cross(p1 - p0, p2 - p0)
            nn = np.linalg.norm(n)
            if nn < 1e-12:
                continue
            n = n / nn
            d0 = -n @ p0
            dist = np.abs(flat[idx] @ n + d0)
            inl = dist < threshold
            if best_inl is None or inl.sum() > best_inl.sum():
                best_inl, best_plane = inl, (n, d0)
        if best_inl is None or best_inl.sum() < min_size:
            break
        # refine on inliers (least-squares plane), re-select inliers
        sub = flat[idx[best_inl]]
        c = sub.mean(0)
        # thin SVD: the reference's full one allocates an N×N U (183 GiB
        # for a plane of 157k inliers); the right vectors are the same
        _, _, vt = np.linalg.svd(sub - c, full_matrices=False)
        n = vt[2]
        d0 = -n @ c
        dist = np.abs(flat[idx] @ n + d0)
        inl = dist < threshold
        if inl.sum() < min_size:
            break
        if n[2] > 0:
            n, d0 = -n, -d0
        mask = np.zeros(h * w, bool)
        mask[idx[inl]] = True
        labels[mask.reshape(h, w)] = plane_id
        coeffs.append(np.concatenate([n, [d0]]))
    return labels, (np.stack(coeffs) if coeffs
                    else np.zeros((0, 4)))


# ---------------------------------------------------------------------------
# triangle rasterization


def triangle_rasterize_numpy(vertices: np.ndarray, indices: np.ndarray,
                             colors: np.ndarray, width: int, height: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Oracle — (color (H, W, 3) f32, depth (H, W) f32 init +inf).
    ``vertices`` are pre-projected (x_px, y_px, depth)."""
    v = np.asarray(vertices, np.float64)
    cols = np.asarray(colors, np.float64)
    color = np.zeros((height, width, 3))
    depth = np.full((height, width), np.inf)
    for tri in np.asarray(indices, np.int64):
        p0, p1, p2 = v[tri]
        c0, c1, c2 = cols[tri]
        area = ((p1[0] - p0[0]) * (p2[1] - p0[1])
                - (p2[0] - p0[0]) * (p1[1] - p0[1]))
        if abs(area) < 1e-12:
            continue
        x0 = max(int(np.floor(min(p0[0], p1[0], p2[0]))), 0)
        x1 = min(int(np.ceil(max(p0[0], p1[0], p2[0]))), width - 1)
        y0 = max(int(np.floor(min(p0[1], p1[1], p2[1]))), 0)
        y1 = min(int(np.ceil(max(p0[1], p1[1], p2[1]))), height - 1)
        if x1 < x0 or y1 < y0:
            continue
        ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1].astype(np.float64)
        w0 = ((p1[0] - xs) * (p2[1] - ys) - (p2[0] - xs)
              * (p1[1] - ys)) / area
        w1 = ((p2[0] - xs) * (p0[1] - ys) - (p0[0] - xs)
              * (p2[1] - ys)) / area
        w2 = 1.0 - w0 - w1
        cover = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        z = w0 * p0[2] + w1 * p1[2] + w2 * p2[2]
        win = cover & (z < depth[y0:y1 + 1, x0:x1 + 1])
        depth[y0:y1 + 1, x0:x1 + 1] = np.where(
            win, z, depth[y0:y1 + 1, x0:x1 + 1])
        shade = (w0[..., None] * c0 + w1[..., None] * c1
                 + w2[..., None] * c2)
        color[y0:y1 + 1, x0:x1 + 1] = np.where(
            win[..., None], shade, color[y0:y1 + 1, x0:x1 + 1])
    return color.astype(np.float32), depth.astype(np.float32)


def triangle_rasterize(vertices, indices, colors, width: int, height: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tensor twin → (color (H, W, 3) f32, depth (H, W) f32 init +inf) on
    the device of ``vertices`` (numpy vertices go to the card): chunks of
    triangles, each a full-frame barycentric test and a least-z reduction (lower index first on ties), merged into the
    z-buffer with a strict ``<`` — the pixels of a sequential z-buffer
    over the triangles in index order."""
    v = as_tensor(vertices).to(torch.float32)
    dev = v.device
    cols = as_tensor(colors, dev).to(torch.float32)
    idx = as_tensor(indices, dev).to(torch.int64)
    tri_v = v[idx]              # (T, 3, 3)
    tri_c = cols[idx]           # (T, 3, 3)
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    inf = float("inf")
    depth = torch.full((height, width), inf, dtype=torch.float32, device=dev)
    win_w0 = torch.zeros((height, width), dtype=torch.float32, device=dev)
    win_w1 = torch.zeros_like(win_w0)
    win_t = torch.zeros((height, width), dtype=torch.int64, device=dev)
    chunk = max(1, _CHUNK_ELEMS // max(height * width, 1))
    for start in range(0, tri_v.shape[0], chunk):
        pv = tri_v[start:start + chunk, :, :, None, None]    # (C, 3, 3, 1, 1)
        p0, p1, p2 = pv[:, 0], pv[:, 1], pv[:, 2]
        area = ((p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1])
                - (p2[:, 0] - p0[:, 0]) * (p1[:, 1] - p0[:, 1]))
        safe = torch.where(area.abs() < 1e-12, 1.0, area)
        w0 = ((p1[:, 0] - xs) * (p2[:, 1] - ys)
              - (p2[:, 0] - xs) * (p1[:, 1] - ys)) / safe
        w1 = ((p2[:, 0] - xs) * (p0[:, 1] - ys)
              - (p0[:, 0] - xs) * (p2[:, 1] - ys)) / safe
        w2 = 1.0 - w0 - w1
        cover = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (area.abs() >= 1e-12)
        z = w0 * p0[:, 2] + w1 * p1[:, 2] + w2 * p2[:, 2]
        zmin, arg = torch.where(cover & (z < inf), z, inf).min(dim=0)
        better = zmin < depth
        depth = torch.where(better, zmin, depth)
        win_w0 = torch.where(better, w0.gather(0, arg[None])[0], win_w0)
        win_w1 = torch.where(better, w1.gather(0, arg[None])[0], win_w1)
        win_t = torch.where(better, arg + start, win_t)
    hit = torch.isfinite(depth)
    pc = tri_c[win_t]                                       # (H, W, 3, 3)
    w0, w1 = win_w0[..., None], win_w1[..., None]
    w2 = 1.0 - w0 - w1
    shade = w0 * pc[..., 0, :] + w1 * pc[..., 1, :] + w2 * pc[..., 2, :]
    color = torch.where(hit[..., None], shade, 0.0)
    return color, depth


def register_depth(k_depth, k_rgb, rt, depth: np.ndarray,
                   out_size: Tuple[int, int],
                   dilate: bool = False) -> np.ndarray:
    """OpenCV ``registerDepth`` role: reproject the depth camera's
    cloud into the RGB camera → (h, w) depth (zeros where no data;
    z-buffered on collisions). ``out_size`` = (width, height)."""
    kd = np.asarray(k_depth, np.float64)
    kr = np.asarray(k_rgb, np.float64)
    rt = np.asarray(rt, np.float64)
    r, t = rt[:3, :3], rt[:3, 3]
    w, h = out_size
    pts = depth_to_3d(depth, kd).reshape(-1, 3).astype(np.float64)
    valid = pts[:, 2] > 0
    pts = pts[valid]
    cam = pts @ r.T + t
    front = cam[:, 2] > 1e-9
    cam = cam[front]
    proj = cam @ kr.T
    u = np.round(proj[:, 0] / proj[:, 2]).astype(np.int64)
    v = np.round(proj[:, 1] / proj[:, 2]).astype(np.int64)
    ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    out = np.full((h, w), np.inf)
    np.minimum.at(out, (v[ok], u[ok]), cam[ok, 2])
    out = np.where(np.isinf(out), 0.0, out)
    if dilate:
        p = np.pad(out, 1, mode="constant")
        stacks = np.stack([p[dy:dy + h, dx:dx + w]
                           for dy in range(3) for dx in range(3)])
        stacks = np.where(stacks == 0, np.inf, stacks)
        filled = stacks.min(axis=0)
        out = np.where(out == 0, np.where(np.isinf(filled), 0.0,
                                          filled), out)
    return out.astype(np.float32)


def warp_frame(depth: np.ndarray, image: Optional[np.ndarray], rt,
               k) -> Tuple[np.ndarray, Optional[np.ndarray],
                           np.ndarray]:
    """OpenCV ``warpFrame`` role: reproject an RGB-D frame through a
    rigid transform and render it back onto the same camera →
    (warped_depth f32 (zeros = empty), warped_image, valid mask u8)."""
    k = np.asarray(k, np.float64)
    rt = np.asarray(rt, np.float64)
    r, t = rt[:3, :3], rt[:3, 3]
    h, w = np.asarray(depth).shape
    pts = depth_to_3d(depth, k).reshape(-1, 3).astype(np.float64)
    valid = pts[:, 2] > 0
    cam = pts @ r.T + t
    proj = cam @ k.T
    front = valid & (cam[:, 2] > 1e-9)
    u = np.round(np.where(front, proj[:, 0] / np.where(
        front, proj[:, 2], 1.0), -1)).astype(np.int64)
    v = np.round(np.where(front, proj[:, 1] / np.where(
        front, proj[:, 2], 1.0), -1)).astype(np.int64)
    ok = front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    zbuf = np.full((h, w), np.inf)
    np.minimum.at(zbuf, (v[ok], u[ok]), cam[ok, 2])
    wdepth = np.where(np.isinf(zbuf), 0.0, zbuf).astype(np.float32)
    wimage = None
    if image is not None:
        img = np.asarray(image)
        flat = img.reshape(h * w, -1)
        wimage = np.zeros_like(img).reshape(h * w, -1)
        idx = np.nonzero(ok)[0]
        # paint winners only (those matching the z-buffer)
        winners = np.isclose(cam[idx, 2], zbuf[v[idx], u[idx]])
        tgt = v[idx[winners]] * w + u[idx[winners]]
        wimage[tgt] = flat[idx[winners]]
        wimage = wimage.reshape(img.shape)
    wmask = (wdepth > 0).astype(np.uint8) * 255
    return wdepth, wimage, wmask


def rescale_depth(depth: np.ndarray, factor: float) -> np.ndarray:
    """OpenCV ``rescaleDepth`` role: scale depth values (e.g. mm→m),
    mapping invalid (0/NaN) to 0."""
    d = np.asarray(depth, np.float64) * factor
    return np.where(np.isfinite(d) & (d > 0), d, 0.0).astype(np.float32)


def save_mesh(path: str, vertices: np.ndarray,
              faces: np.ndarray) -> None:
    """ascii PLY with faces (OpenCV ``saveMesh`` role)."""
    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\ncomment created by rustcv_tpu\n"
                 f"element vertex {len(v)}\nproperty float x\n"
                 "property float y\nproperty float z\n"
                 f"element face {len(f)}\n"
                 "property list uchar int vertex_indices\nend_header\n")
        for x, y, z in v:
            fh.write(f"{x:.9g} {y:.9g} {z:.9g}\n")
        for a, b, c in f:
            fh.write(f"3 {a} {b} {c}\n")


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """→ (vertices (N, 3) f32, faces (M, 3) int32) from ascii PLY."""
    with open(path) as fh:
        n_v = n_f = 0
        while True:
            raw = fh.readline()
            if not raw:   # EOF before end_header: reject, don't spin
                raise ValueError(f"not a PLY mesh: {path}")
            line = raw.strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif line == "end_header":
                break
        verts = np.array([[float(x) for x in fh.readline().split()[:3]]
                          for _ in range(n_v)], np.float32)
        faces = []
        for _ in range(n_f):
            vals = fh.readline().split()
            faces.append([int(vals[1]), int(vals[2]), int(vals[3])])
    return verts, np.asarray(faces, np.int32)


def depth_to_3d_sparse(points: np.ndarray, depths: np.ndarray,
                       k) -> np.ndarray:
    """OpenCV ``depthTo3dSparse`` role: (N, 2) pixel coords + their
    depths → (N, 3) camera-frame points."""
    p = np.asarray(points, np.float64).reshape(-1, 2)
    d = np.asarray(depths, np.float64).ravel()
    k = np.asarray(k, np.float64)
    x = (p[:, 0] - k[0, 2]) * d / k[0, 0]
    y = (p[:, 1] - k[1, 2]) * d / k[1, 1]
    return np.stack([x, y, d], axis=1).astype(np.float32)


def rgbd_normals_numpy(points3d: np.ndarray) -> np.ndarray:
    """Oracle — unit normals of an organized cloud (OpenCV
    ``RgbdNormals`` role, cross-product flavor): n = normalize(
    (P(y,x+1)−P(y,x−1)) × (P(y+1,x)−P(y−1,x))), oriented toward the
    camera (n·p < 0); border rows/cols copy their neighbor."""
    p = np.asarray(points3d, np.float64)
    dx = np.zeros_like(p)
    dy = np.zeros_like(p)
    dx[:, 1:-1] = p[:, 2:] - p[:, :-2]
    dy[1:-1, :] = p[2:, :] - p[:-2, :]
    n = np.cross(dx, dy)
    nn = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(nn, 1e-12)
    flip = (n * p).sum(-1, keepdims=True) > 0
    n = np.where(flip, -n, n)
    n[0] = n[1]
    n[-1] = n[-2]
    n[:, 0] = n[:, 1]
    n[:, -1] = n[:, -2]
    return n.astype(np.float32)


def rgbd_normals(points3d) -> torch.Tensor:
    """Tensor twin on the cloud's device (a numpy cloud goes to the card)
    — shifted-view elementwise math."""
    p = as_tensor(points3d).to(torch.float32)
    dx = torch.zeros_like(p)
    dy = torch.zeros_like(p)
    dx[:, 1:-1] = p[:, 2:] - p[:, :-2]
    dy[1:-1, :] = p[2:, :] - p[:-2, :]
    n = torch.linalg.cross(dx, dy)
    nn = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(nn, min=1e-12)
    flip = (n * p).sum(-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    n[0], n[-1] = n[1].clone(), n[-2].clone()
    n[:, 0], n[:, -1] = n[:, 1].clone(), n[:, -2].clone()
    return n
