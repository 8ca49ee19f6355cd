"""Fiducial marker detection and pose estimation (counterpart of
srl_tpu/real_robots/marker_finder.py).

Numpy only, in place of the upstream toolbox's OpenCV pipeline
(real_robots/omnirobot_utils/marker_finder.py): detect a hamming-coded
square tag in a camera image and recover its 6-DoF pose in the camera
frame. It runs on the host at camera rate (about 10 Hz for the real
Omnirobot), at the robot's boundary, not on the training path. A ROS
``camera_info`` YAML is read by ``utils.yaml_subset``.

Pipeline (mirroring marker_finder.py:118-290 semantics):
  1. adaptive mean threshold (31x5, inverted) via an integral image,
  2. connected-component labeling (two-pass union-find),
  3. per-component convex hull -> dominant 4-corner extraction ->
     total-least-squares edge refit -> corner intersection,
  4. DLT homography -> 90x90 rectification -> 9x9 cell decode,
  5. hamming match against the stored code at 4 rotations (accept < 3),
  6. planar pose from the homography (undistorted corners, IPPE-style
     K⁻¹H factorization + SVD orthonormalization) -> (rot_vec, trans_vec),
     the same outputs as cv2.solvePnP in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from srl_tpu_torch.utils.yaml_subset import read_yaml_subset


# ---------------------------------------------------------------------------
# Image ops
# ---------------------------------------------------------------------------

def adaptive_threshold(gray: np.ndarray, block: int = 31, c: float = 5.0) -> np.ndarray:
    """Binary-inverse adaptive mean threshold (marker_finder.py:120): 1 where
    pixel < local_mean - c. Local mean over a block x block window via an
    integral image with edge clamping."""
    h, w = gray.shape
    r = block // 2
    padded = np.pad(gray.astype(np.float64), r + 1, mode="edge")
    ii = padded.cumsum(0).cumsum(1)
    ys, xs = np.arange(h), np.arange(w)
    y0, y1 = ys[:, None], ys[:, None] + block
    x0, x1 = xs[None, :], xs[None, :] + block
    area = float(block * block)
    mean = (ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]) / area
    return (gray.astype(np.float64) < mean - c).astype(np.uint8)


def label_components(binary: np.ndarray) -> Tuple[np.ndarray, int]:
    """Two-pass 4-connected component labeling with union-find."""
    h, w = binary.shape
    labels = np.zeros((h, w), np.int32)
    parent = [0]  # parent[0] = background sentinel

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    next_label = 1
    for y in range(h):
        row = binary[y]
        up = labels[y - 1] if y > 0 else None
        left = 0
        for x in range(w):
            if not row[x]:
                left = 0
                continue
            top = up[x] if up is not None else 0
            if left and top:
                la, lt = find(left), find(top)
                labels[y, x] = la
                if la != lt:
                    parent[lt] = la
            elif left or top:
                labels[y, x] = left or top
            else:
                parent.append(next_label)
                labels[y, x] = next_label
                next_label += 1
            left = labels[y, x]
    # Second pass: flatten.
    flat = np.arange(next_label, dtype=np.int32)
    for i in range(1, next_label):
        flat[i] = find(i)
    remap = np.zeros(next_label, np.int32)
    uniq = np.unique(flat[1:]) if next_label > 1 else np.array([], np.int32)
    remap[uniq] = np.arange(1, len(uniq) + 1)
    return remap[flat[labels]], len(uniq)


def _cross2(a, b):
    """z-component of the 2-D cross product (np.cross on 2-vectors is
    removed in numpy 2.x)."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain; points [N,2] -> CCW hull [H,2] (in image
    coords with y down, this is CW on screen)."""
    pts = np.unique(points, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and _cross2(out[-1] - out[-2], p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1], np.float64)


def _four_corners(hull: np.ndarray) -> np.ndarray:
    """Dominant quadrilateral vertices of a convex hull: p0 farthest from the
    centroid, p2 farthest from p0, p1/p3 farthest from line p0-p2 on either
    side."""
    c = hull.mean(0)
    p0 = hull[np.argmax(np.linalg.norm(hull - c, axis=1))]
    p2 = hull[np.argmax(np.linalg.norm(hull - p0, axis=1))]
    d = p2 - p0
    n = np.array([-d[1], d[0]])
    n = n / (np.linalg.norm(n) + 1e-12)
    side = (hull - p0) @ n
    p1 = hull[np.argmax(side)]
    p3 = hull[np.argmin(side)]
    quad = np.array([p0, p1, p2, p3])
    # Order consistently around the centroid.
    qc = quad.mean(0)
    ang = np.arctan2(quad[:, 1] - qc[1], quad[:, 0] - qc[0])
    return quad[np.argsort(ang)]


def _refit_corners(hull: np.ndarray, quad: np.ndarray) -> np.ndarray:
    """Total-least-squares refit of each quad edge from the hull points
    nearest to it, then corner = adjacent-line intersection
    (the fitLine+intersection scheme of marker_finder.py:143-190)."""
    lines = []
    for j in range(4):
        a, b = quad[j], quad[(j + 1) % 4]
        ab = b - a
        L = np.linalg.norm(ab) + 1e-12
        t = (hull - a) @ ab / (L * L)
        dist = np.abs(_cross2(np.broadcast_to(ab, hull.shape), hull - a)) / L
        sel = hull[(t > -0.05) & (t < 1.05) & (dist < max(2.0, 0.03 * L))]
        if len(sel) < 2:
            sel = np.array([a, b])
        mean = sel.mean(0)
        u, s, vt = np.linalg.svd(sel - mean)
        direction = vt[0]
        lines.append((mean, direction))
    corners = np.zeros((4, 2))
    for j in range(4):
        (m1, d1), (m2, d2) = lines[j], lines[(j + 1) % 4]
        # m1 + t d1 = m2 + s d2
        A = np.stack([d1, -d2], axis=1)
        if abs(np.linalg.det(A)) < 1e-9:
            corners[(j + 1) % 4] = (m1 + m2) / 2
            continue
        t, _ = np.linalg.solve(A, m2 - m1)
        corners[(j + 1) % 4] = m1 + t * d1
    return corners


def homography_dlt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """H (3x3) with dst ~ H @ src for 4+ correspondences (normalized DLT)."""

    def norm(pts):
        c = pts.mean(0)
        s = np.sqrt(2) / (np.mean(np.linalg.norm(pts - c, axis=1)) + 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
        return (pts - c) * s, T

    sp, Ts = norm(np.asarray(src, np.float64))
    dp, Td = norm(np.asarray(dst, np.float64))
    rows = []
    for (x, y), (u, v) in zip(sp, dp):
        rows.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        rows.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, vt = np.linalg.svd(np.asarray(rows))
    H = vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ H @ Ts
    return H / H[2, 2]


def warp_perspective(img: np.ndarray, H: np.ndarray, out_shape: Tuple[int, int]) -> np.ndarray:
    """Sample img under H⁻¹ (bilinear): out[y, x] = img at H⁻¹ @ (x, y, 1)."""
    oh, ow = out_shape
    Hinv = np.linalg.inv(H)
    xs, ys = np.meshgrid(np.arange(ow), np.arange(oh))
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(oh * ow)])
    src = Hinv @ pts
    sx, sy = src[0] / src[2], src[1] / src[2]
    h, w = img.shape
    x0 = np.clip(np.floor(sx).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(sy).astype(int), 0, h - 2)
    fx, fy = np.clip(sx - x0, 0, 1), np.clip(sy - y0, 0, 1)
    v = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
         + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)
    return v.reshape(oh, ow)


# ---------------------------------------------------------------------------
# Pose math
# ---------------------------------------------------------------------------

def undistort_points(pts: np.ndarray, K: np.ndarray, dist: np.ndarray,
                     iters: int = 8) -> np.ndarray:
    """Pixel -> normalized image coords, inverting the radial-tangential
    (k1 k2 p1 p2 k3) model by fixed-point iteration."""
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    x = (pts[:, 0] - K[0, 2]) / K[0, 0]
    y = (pts[:, 1] - K[1, 2]) / K[1, 1]
    x0, y0 = x.copy(), y.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return np.stack([x, y], axis=1)


def rodrigues_from_matrix(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (cv2.Rodrigues convention)."""
    cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
    theta = np.arccos(cos)
    if theta < 1e-8:
        return np.zeros(3)
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    n = np.linalg.norm(axis)
    if n < 1e-8:  # theta ~ pi
        M = (R + np.eye(3)) / 2
        axis = np.sqrt(np.maximum(np.diag(M), 0))
        axis = axis / (np.linalg.norm(axis) + 1e-12)
        return axis * theta
    return axis / n * theta


def planar_pose(obj_corners: np.ndarray, img_corners: np.ndarray,
                K: np.ndarray, dist: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pose of a z=0 planar square from its image projection: homography in
    normalized coordinates factorizes as [r1 r2 t] up to scale."""
    norm_pts = undistort_points(img_corners, K, dist)
    H = homography_dlt(obj_corners[:, :2], norm_pts)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 2.0 / (np.linalg.norm(h1) + np.linalg.norm(h2) + 1e-12)
    if h3[2] * lam < 0:  # marker must be in front of the camera (+z)
        lam = -lam
    r1, r2, t = h1 * lam, h2 * lam, h3 * lam
    R = np.stack([r1, r2, np.cross(r1, r2)], axis=1)
    u, _, vt = np.linalg.svd(R)
    R = u @ np.diag([1, 1, np.linalg.det(u @ vt)]) @ vt
    return rodrigues_from_matrix(R), t


# ---------------------------------------------------------------------------
# The finder
# ---------------------------------------------------------------------------

class MakerFinder:
    """Reference-named API (sic — marker_finder.py:30): configure with camera
    intrinsics, register tag codes, then ``findMarker(img, marker_id)``.

    Accepts either a dict of intrinsics or a ROS camera_info yaml path (the
    reference's constructor input)."""

    MARKER_SIZE = 90  # rectified tag resolution (marker_finder.py:65)
    GRID = 9          # code cells per side (marker_finder.py:209)

    def __init__(self, camera_info, min_area: int = 70):
        if isinstance(camera_info, (str, bytes)):
            contents = read_yaml_subset(camera_info)
            self.camera_matrix = np.reshape(
                np.array(contents["camera_matrix"]["data"], np.float64), (3, 3)
            )
            self.distortion_coefficients = np.array(
                contents["distortion_coefficients"]["data"], np.float64
            )
        else:
            self.camera_matrix = np.asarray(camera_info["camera_matrix"], np.float64)
            self.distortion_coefficients = np.asarray(
                camera_info.get("distortion_coefficients", np.zeros(5)), np.float64
            )
        self.min_area = min_area
        self.marker_code: Dict[object, np.ndarray] = {}
        self.marker_real_corners: Dict[object, np.ndarray] = {}

    def setMarkerCode(self, marker_id, marker_code: np.ndarray, real_length: float):
        """Register a tag's binary code; all 4 rotations are matched
        (marker_finder.py:52-72)."""
        code = np.asarray(marker_code, np.uint8)
        rots = np.stack([np.rot90(code, -i) for i in range(4)])
        self.marker_code[marker_id] = rots
        half = real_length / 2.0
        # Same winding as the rectification square: (0,0)->(90,0)->(90,90)->
        # (0,90) in tag pixels, i.e. clockwise on screen with y down.
        self.marker_real_corners[marker_id] = np.array(
            [[-half, -half, 0], [half, -half, 0], [half, half, 0], [-half, half, 0]],
            np.float64,
        )

    # -- detection ---------------------------------------------------------
    def _candidate_quads(self, gray: np.ndarray):
        edge = adaptive_threshold(gray)
        self.edge = edge
        labels, n = label_components(edge)
        h, w = gray.shape
        quads = []
        for i in range(1, n + 1):
            ys, xs = np.nonzero(labels == i)
            if len(ys) < self.min_area:
                continue
            if ys.min() <= 1 or xs.min() <= 1 or ys.max() >= h - 2 or xs.max() >= w - 2:
                continue  # touches the border (marker_finder.py:101-110)
            hull = convex_hull(np.stack([xs, ys], axis=1).astype(np.float64))
            if len(hull) < 4:
                continue
            # Reject blobs that poorly fill their quad (non-square shapes).
            quad = _refit_corners(hull, _four_corners(hull))
            area = 0.5 * abs(
                sum(
                    quad[j, 0] * quad[(j + 1) % 4, 1]
                    - quad[(j + 1) % 4, 0] * quad[j, 1]
                    for j in range(4)
                )
            )
            if area < self.min_area:
                continue
            quads.append(quad)
        return quads

    def _decode(self, rect: np.ndarray) -> np.ndarray:
        """9x9 cell decode: dark cell -> 1 (marker_finder.py:208-221)."""
        step = self.MARKER_SIZE // self.GRID
        cells = rect[: self.GRID * step, : self.GRID * step].reshape(
            self.GRID, step, self.GRID, step
        )
        return (cells.mean(axis=(1, 3)) > 0.5).astype(np.uint8)

    def findMarker(self, img: np.ndarray, marker_id, visualise: bool = False
                   ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Detect ``marker_id`` in an RGB/gray image. Returns
        (rot_vec, trans_vec, corners[4,2]) in the camera frame, or None."""
        if img.ndim == 3:
            gray = img.astype(np.float64) @ np.array([0.299, 0.587, 0.114])
        else:
            gray = img.astype(np.float64)
        # Winding matches the angle-sorted quad corners (ascending atan2 with
        # y down = clockwise on screen): top-left, top-right, bottom-right,
        # bottom-left of the rectified tag.
        square_pts = np.float64(
            [[0, 0], [self.MARKER_SIZE, 0], [self.MARKER_SIZE, self.MARKER_SIZE],
             [0, self.MARKER_SIZE]]
        )
        for corners in self._candidate_quads(gray):
            H = homography_dlt(corners, square_pts)
            rect = warp_perspective(
                self.edge.astype(np.float64), H,
                (self.MARKER_SIZE, self.MARKER_SIZE),
            )
            code = self._decode(rect)
            dists = np.array(
                [
                    int((code != rot).sum())
                    for rot in self.marker_code[marker_id]
                ]
            )
            best = int(np.argmin(dists))
            if dists[best] >= 3:  # hamming acceptance (marker_finder.py:276)
                continue
            ordered = np.roll(corners, -best, axis=0)
            rot_vec, trans_vec = planar_pose(
                self.marker_real_corners[marker_id], ordered,
                self.camera_matrix, self.distortion_coefficients,
            )
            return rot_vec, trans_vec, ordered
        return None


MarkerFinder = MakerFinder  # correctly-spelled alias
