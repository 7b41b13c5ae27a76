"""Click-to-voxel picking semantics — a testable Python mirror (the port's
own copy of the JAX package's ``interactive/picking.py``, numpy only).

The browser client picks in screen space (`viewer.html` ``pick()`` —
keep :func:`pick_projected_nearest` in sync with it line for line). The
reference GUI instead renders a depth image, unprojects the clicked
pixel to a 3D world point, and takes the nearest voxel in 3D
(reference interactive_tool/gui.py:253-339, utils.py:27-29) —
implemented independently here as :func:`pick_depth_unproject` so the
two semantics can be compared on occluding geometry
(tests/test_torch_picking.py).

Where they agree and where they don't:

* Clicking squarely on a surface — including one that OCCLUDES another
  surface straight behind it — both pick the same front voxel: the
  depth image only sees the front surface, and the screen-space score
  ``cw*1000 + px_dist^2`` prefers the closest-depth candidate.
* Within ~12 px of a closer object's silhouette edge the semantics
  intentionally diverge: the screen-space pick snaps to the NEARER
  object anywhere inside its pixel radius (annotation-friendly:
  thin/small foreground objects are hard to hit exactly), while the
  reference picks whatever surface is under the exact pixel. This is a
  documented client UX choice, not a model-path difference — the voxel
  index handed to forward_mask is exact in both cases.
"""

from __future__ import annotations

import numpy as np

PICK_RADIUS_PX = 12.0  # viewer.html pick(): `if(d2>144) continue`
NEAR_W = 0.05          # viewer.html pick(): `if(cw<=0.05) continue`


def project(pos: np.ndarray, mvp: np.ndarray, w: int, h: int):
    """Column-major 4x4 `mvp` (as the JS stores it) applied to [N,3]
    points -> (sx, sy, cw) in CSS-pixel screen space, matching
    viewer.html's per-point math exactly."""
    m = np.asarray(mvp, np.float64).reshape(4, 4).T  # column-major -> rows
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    cw = m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3]
    cx = m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3]
    cy = m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3]
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = cx / cw * 0.5 * w + 0.5 * w
        sy = -cy / cw * 0.5 * h + 0.5 * h
    return sx, sy, cw


def pick_projected_nearest(pos: np.ndarray, mvp: np.ndarray, mx: float,
                           my: float, w: int, h: int,
                           radius_px: float = PICK_RADIUS_PX) -> int:
    """The client's screen-space pick (viewer.html pick(), lines
    mirrored 1:1): among voxels projecting within `radius_px` of the
    click, prefer closest view depth, then pixel distance. -1 = miss."""
    sx, sy, cw = project(np.asarray(pos, np.float64), mvp, w, h)
    d2 = (sx - mx) ** 2 + (sy - my) ** 2
    ok = (cw > NEAR_W) & (d2 <= radius_px * radius_px)
    if not ok.any():
        return -1
    score = np.where(ok, cw * 1000.0 + d2, np.inf)
    return int(np.argmin(score))


def pick_depth_unproject(pos: np.ndarray, mvp: np.ndarray, mx: float,
                         my: float, w: int, h: int,
                         point_px: float = 6.0) -> int:
    """The reference GUI's semantics, derived independently from its
    behavior (gui.py:253-274 renders the scene to a depth image,
    unprojects the clicked pixel, utils.py:27-29 takes the 3D-nearest
    voxel): rasterize every voxel as a `point_px`-wide splat into a
    z-buffer, read the depth under the EXACT clicked pixel, unproject
    it to a world point, return the voxel nearest in 3D. -1 if the
    click hits empty background (the reference ignores such clicks)."""
    pos = np.asarray(pos, np.float64)
    sx, sy, cw = project(pos, mvp, w, h)
    px, py = int(round(mx)), int(round(my))
    half = point_px / 2.0
    vis = cw > NEAR_W
    covers = (vis & (np.abs(sx - mx) <= half) & (np.abs(sy - my) <= half))
    if not covers.any():
        return -1
    # frontmost splat covering the pixel supplies the depth sample
    depth_w = cw[covers].min()
    # unproject (pixel center, sampled depth) back to world space
    m = np.asarray(mvp, np.float64).reshape(4, 4).T
    ndc_x = (px - 0.5 * w) / (0.5 * w)
    ndc_y = -(py - 0.5 * h) / (0.5 * h)
    clip = np.array([ndc_x * depth_w, ndc_y * depth_w, 0.0, depth_w])
    # solve m @ [xyz,1] = clip for xyz using the x/y/w rows (the z row
    # only fixes the NDC depth mapping, which cancels in w)
    a = np.stack([m[0, :3], m[1, :3], m[3, :3]])
    b = clip[[0, 1, 3]] - np.array([m[0, 3], m[1, 3], m[3, 3]])
    world = np.linalg.solve(a, b)
    return int(np.argmin(((pos - world) ** 2).sum(1)))
