"""Camera-pose picture: the COLMAP camera frustums and the sparse point
cloud drawn to a PNG (reference: vis_cam.py, which draws with matplotlib's
3D axes).

    python -m wheat3dgs_tpu_torch.apps.vis_cam -s <scene> [-o cameras.png]
        [--scale 0.2]

The sparse model is read with the port's own io/colmap.py and
utils/graphics.py. The port does not use matplotlib (the machine with the
card is not known to have it), so the picture is drawn with PIL's
ImageDraw: an orthographic view from matplotlib's default 3D view
(elevation 30 degrees, azimuth -60), each world axis scaled to the data's
extent as matplotlib's axes are. The root script's rules are kept: every
max(1, n // 5000)-th point in grey, each camera's four rays from its
centre and its image-plane loop in red for a camera id > 10 (test) and
blue otherwise (train), the camera id beside its centre, and the title.
The picture is not pixel-comparable with matplotlib's; the geometry
(`frustum_corners`) is the root script's exactly.

It reads and writes files on the host only and runs no tensor code, so it
takes no --device: it needs no card and nothing in it can use one.
"""

from __future__ import annotations

import math
import os
from argparse import ArgumentParser

import numpy as np

from ..io import colmap
from ..utils import graphics

SIZE = (1500, 1200)          # matplotlib's 10 x 8 inches at 150 dpi
MARGIN = 60
ELEV_DEG, AZIM_DEG = 30.0, -60.0
POINTS_MAX = 5000
GREY = (217, 217, 217)       # grey at alpha 0.3 on white
RED, BLUE, BLACK = (255, 0, 0), (0, 0, 255), (0, 0, 0)


def frustum_corners(w2c: np.ndarray, scale: float = 0.2) -> np.ndarray:
    """5 points: camera center + 4 image-plane corners in world space."""
    c2w = np.linalg.inv(w2c)
    corners_cam = np.array(
        [[0, 0, 0], [-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]],
        np.float64) * scale
    hom = np.concatenate([corners_cam, np.ones((5, 1))], axis=1)
    return (hom @ c2w.T)[:, :3]


def camera_id(name: str) -> int:
    """The number after the image name's last underscore (0 if none): the
    wheat naming rule's camera, > 10 for the test split."""
    tail = name.split("_")[-1].split(".")[0]
    return int(tail) if tail.isdigit() else 0


def view_axes(elev_deg: float = ELEV_DEG, azim_deg: float = AZIM_DEG):
    """The screen's right and up directions in world space for a view from
    elevation `elev_deg` and azimuth `azim_deg` (matplotlib's angles)."""
    el, az = math.radians(elev_deg), math.radians(azim_deg)
    right = np.array([-math.sin(az), math.cos(az), 0.0])
    up = np.array([-math.cos(az) * math.sin(el), -math.sin(az) * math.sin(el),
                   math.cos(el)])
    return right, up


class Projector:
    """World points to pixels: each axis scaled to [-1, 1] over the data's
    extent, then projected on the view's right / up plane and fitted into
    the picture inside MARGIN, y down."""

    def __init__(self, pts: np.ndarray, size=SIZE):
        self.lo = pts.min(axis=0)
        self.span = np.maximum(pts.max(axis=0) - self.lo, 1e-12)
        self.right, self.up = view_axes()
        s = self._screen(pts)
        self.s_lo = s.min(axis=0)
        s_span = np.maximum(s.max(axis=0) - self.s_lo, 1e-12)
        w, h = size
        self.k = min((w - 2 * MARGIN) / s_span[0],
                     (h - 2 * MARGIN) / s_span[1])
        self.h = h

    def _screen(self, pts: np.ndarray) -> np.ndarray:
        q = 2.0 * (pts - self.lo) / self.span - 1.0
        return np.stack([q @ self.right, q @ self.up], axis=1)

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        s = (self._screen(np.atleast_2d(pts)) - self.s_lo) * self.k
        return np.stack([MARGIN + s[:, 0], self.h - MARGIN - s[:, 1]],
                        axis=1)


def draw_cameras(extr: dict, points, scale: float = 0.2, size=SIZE):
    """(PIL image, {image name: (x, y) pixel of its camera centre}): the
    sparse points (`points` is load_colmap_model's, or None) and each
    camera's frustum."""
    from PIL import Image, ImageDraw, ImageFont

    frusta = {}
    for img in extr.values():
        w2c = np.eye(4)
        w2c[:3, :3] = graphics.qvec_to_rotmat(img.qvec)
        w2c[:3, 3] = img.tvec
        frusta[img.name] = frustum_corners(w2c, scale)
    sub = None
    if points is not None:
        xyz = np.asarray(points[0], np.float64)
        sub = xyz[:: max(1, len(xyz) // POINTS_MAX)]
    every = [c for c in frusta.values()] + ([sub] if sub is not None
                                             and len(sub) else [])
    proj = Projector(np.concatenate(every, axis=0), size)

    image = Image.new("RGB", size, "white")
    draw = ImageDraw.Draw(image)
    font = ImageFont.load_default()
    if sub is not None:
        for x, y in proj(sub):
            draw.point((float(x), float(y)), fill=GREY)
    centres = {}
    for name, c in frusta.items():
        color = RED if camera_id(name) > 10 else BLUE
        px = proj(c)
        for k in range(1, 5):
            draw.line([tuple(px[0]), tuple(px[k])], fill=color, width=1)
        loop = [1, 2, 3, 4, 1]
        draw.line([tuple(px[k]) for k in loop], fill=color, width=1)
        draw.text((float(px[0, 0]) + 4, float(px[0, 1]) - 12),
                  name.split(".")[0].split("_")[-1], fill=BLACK, font=font)
        centres[name] = (float(px[0, 0]), float(px[0, 1]))
    # The centres last, so a label or another camera's line drawn later
    # cannot hide the split's colour there.
    for name, (x, y) in centres.items():
        color = RED if camera_id(name) > 10 else BLUE
        draw.ellipse((x - 2, y - 2, x + 2, y + 2), fill=color)
    draw.text((size[0] // 2 - 110, 12),
              f"{len(extr)} cameras (blue=train, red=test)", fill=BLACK,
              font=font)
    return image, centres


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--output", "-o", default="cameras.png")
    parser.add_argument("--scale", type=float, default=0.2)
    args = parser.parse_args(argv)

    sparse = os.path.join(args.source_path, "sparse", "0")
    _, extr, points = colmap.load_colmap_model(sparse)
    image, _ = draw_cameras(extr, points, args.scale)
    image.save(args.output)
    print(f"wrote {args.output}")
    return args.output


if __name__ == "__main__":
    main()
