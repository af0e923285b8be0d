"""COLMAP sparse-model parsers (reference: scene/colmap_loader.py).

Pure host-side struct parsing of cameras/images/points3D in both binary and
text form, following the COLMAP on-disk format. Only the fields the pipeline
uses are kept.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple

import numpy as np

from ..utils.graphics import qvec_to_rotmat, rotmat_to_qvec  # noqa: F401 (re-export)


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray  # (4,) w,x,y,z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (M, 2)
    point3D_ids: np.ndarray  # (M,)


# COLMAP camera model id -> (name, num_params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def _read(fid, nbytes, fmt):
    return struct.unpack("<" + fmt, fid.read(nbytes))


def read_intrinsics_binary(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, 24, "iiQQ")
            name, num_params = _CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * num_params, "d" * num_params))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return cams


def read_intrinsics_text(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cams[cam_id] = ColmapCamera(
                cam_id, parts[1], int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]))
    return cams


def read_extrinsics_binary(path: str) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            vals = _read(f, 64, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name_bytes = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name_bytes += c
            (num_pts,) = _read(f, 8, "Q")
            data = _read(f, 24 * num_pts, "ddq" * num_pts)
            xys = np.column_stack([
                np.array(data[0::3], dtype=np.float64),
                np.array(data[1::3], dtype=np.float64)])
            pt_ids = np.array(data[2::3], dtype=np.int64)
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id,
                name_bytes.decode("utf-8"), xys, pt_ids)
    return images


def read_extrinsics_text(path: str) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    for meta, pts in zip(lines[0::2], lines[1::2]):
        parts = meta.split()
        image_id = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        elems = pts.split()
        xys = np.column_stack([
            np.array(elems[0::3], dtype=np.float64),
            np.array(elems[1::3], dtype=np.float64)]) if elems else np.zeros((0, 2))
        pt_ids = np.array(elems[2::3], dtype=np.int64) if elems else np.zeros(0, np.int64)
        images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name, xys, pt_ids)
    return images


def read_points3D_binary(path: str):
    """Returns (xyz (N,3), rgb (N,3) uint8, errors (N,))."""
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3), dtype=np.uint8)
        err = np.empty(num)
        for i in range(num):
            vals = _read(f, 43, "QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(f, 8, "Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return xyz, rgb, err


def read_points3D_text(path: str):
    xyz_l, rgb_l, err_l = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyz_l.append([float(x) for x in parts[1:4]])
            rgb_l.append([int(x) for x in parts[4:7]])
            err_l.append(float(parts[7]))
    return (np.array(xyz_l), np.array(rgb_l, dtype=np.uint8), np.array(err_l))


_CAMERA_MODEL_IDS = {name: (mid, nparams)
                     for mid, (name, nparams) in _CAMERA_MODELS.items()}


def write_intrinsics_binary(path: str, cams: Dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            model_id, nparams = _CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * nparams, *cam.params[:nparams]))


def write_extrinsics_binary(path: str, images: Dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.point3D_ids)
            f.write(struct.pack("<Q", n))
            for xy, pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], pid))


def write_points3D_binary(path: str, xyz: np.ndarray, rgb: np.ndarray,
                          err: np.ndarray | None = None) -> None:
    if err is None:
        err = np.zeros(len(xyz))
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<QdddBBBd", i + 1, *xyz[i],
                                int(rgb[i, 0]), int(rgb[i, 1]), int(rgb[i, 2]),
                                float(err[i])))
            f.write(struct.pack("<Q", 0))  # empty track


def load_colmap_model(sparse_dir: str):
    """Load intrinsics/extrinsics/points from a COLMAP sparse dir,
    preferring binary (reference: scene/dataset_readers.py:151-160)."""
    if os.path.exists(os.path.join(sparse_dir, "images.bin")):
        extr = read_extrinsics_binary(os.path.join(sparse_dir, "images.bin"))
        intr = read_intrinsics_binary(os.path.join(sparse_dir, "cameras.bin"))
    else:
        extr = read_extrinsics_text(os.path.join(sparse_dir, "images.txt"))
        intr = read_intrinsics_text(os.path.join(sparse_dir, "cameras.txt"))
    pts_bin = os.path.join(sparse_dir, "points3D.bin")
    pts_txt = os.path.join(sparse_dir, "points3D.txt")
    if os.path.exists(pts_bin):
        points = read_points3D_binary(pts_bin)
    elif os.path.exists(pts_txt):
        points = read_points3D_text(pts_txt)
    else:
        points = None
    return intr, extr, points


def write_intrinsics_text(path: str, cams: Dict[int, ColmapCamera]) -> None:
    """COLMAP cameras.txt (viewer-fork read_write_model.py parity)."""
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cams.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} "
                    f"{params}\n")


def write_extrinsics_text(path: str, images: Dict[int, ColmapImage]) -> None:
    """COLMAP images.txt: pose line + 2D-point track line per image."""
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            pts = " ".join(f"{float(x)!r} {float(y)!r} {int(pid)}"
                           for (x, y), pid in zip(im.xys, im.point3D_ids))
            f.write(pts + "\n")


def write_points3D_text(path: str, xyz: np.ndarray, rgb: np.ndarray,
                        err: np.ndarray | None = None) -> None:
    """COLMAP points3D.txt with empty tracks."""
    if err is None:
        err = np.zeros(len(xyz))
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[]\n")
        for i in range(len(xyz)):
            f.write(f"{i + 1} {float(xyz[i, 0])!r} {float(xyz[i, 1])!r} "
                    f"{float(xyz[i, 2])!r} "
                    f"{int(rgb[i, 0])} {int(rgb[i, 1])} {int(rgb[i, 2])} "
                    f"{float(err[i])!r}\n")


def write_model(sparse_dir: str, intr, extr, points=None,
                ext: str = ".bin") -> None:
    """Write a full COLMAP sparse model (bin or txt); points is (xyz, rgb)
    or (xyz, rgb, err)."""
    os.makedirs(sparse_dir, exist_ok=True)
    binary = ext == ".bin"
    suffix = ".bin" if binary else ".txt"
    (write_intrinsics_binary if binary else write_intrinsics_text)(
        os.path.join(sparse_dir, "cameras" + suffix), intr)
    (write_extrinsics_binary if binary else write_extrinsics_text)(
        os.path.join(sparse_dir, "images" + suffix), extr)
    if points is not None:
        (write_points3D_binary if binary else write_points3D_text)(
            os.path.join(sparse_dir, "points3D" + suffix), points[0],
            points[1], points[2] if len(points) > 2 else None)
