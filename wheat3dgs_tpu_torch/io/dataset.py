"""Scene loading: COLMAP -> SceneData (reference: scene/dataset_readers.py,
scene/__init__.py).

Counterpart of wheat3dgs_tpu/io/dataset.py's COLMAP path: parses the sparse
model, loads/resizes images with PIL (PILtoTorch semantics), applies the
wheat train/test split (camera index > 10 => test), computes the NeRF++
normalization radius, and stacks the cameras as tensors on `device`.
Images stay host numpy, as in the JAX package. The Blender reader waits
for a later slice of the port.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils import graphics
from . import colmap
from .cameras import (CameraMeta, Cameras, camera_to_json, make_camera_batch,
                      resolve_resolution)
from .ply import read_points_ply, write_points_ply


@dataclasses.dataclass
class CameraGroup:
    """One split (train or test): batched cameras + images + metadata."""

    cameras: Cameras                 # (B, ...) tensors on the device
    images: np.ndarray               # (B, 3, H, W) float32 in [0, 1] (host)
    metas: List[CameraMeta]

    def __len__(self):
        return len(self.metas)


@dataclasses.dataclass
class SceneData:
    point_cloud: Optional[graphics.BasicPointCloud]
    train: CameraGroup
    test: CameraGroup
    cameras_extent: float
    translate: np.ndarray
    ply_path: str


def nerfpp_norm(w2cs: List[np.ndarray]) -> dict:
    """Scene center/radius from camera centers
    (reference getNerfppNorm, scene/dataset_readers.py:50-71)."""
    centers = np.stack([np.linalg.inv(m)[:3, 3] for m in w2cs], axis=0)
    center = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - center, axis=1).max()
    return {"translate": -center, "radius": diagonal * 1.1}


def load_image(path: str, resolution) -> np.ndarray:
    """PIL load + resize + [0,1] normalize -> (C, H, W) float32
    (reference PILtoTorch; PIL default bicubic resize)."""
    from PIL import Image

    img = Image.open(path)
    img = img.resize(resolution)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return np.transpose(arr, (2, 0, 1))


def _split_wheat(metas_sorted: List[CameraMeta]):
    """FIP wheat rule: image name suffix int > 10 => test."""
    train_idx, test_idx = [], []
    for i, m in enumerate(metas_sorted):
        cam_idx = int(m.image_name.split("_")[-1])
        (test_idx if cam_idx > 10 else train_idx).append(i)
    return train_idx, test_idx


def read_colmap_scene(source_path: str, images_dir: str = "images",
                      eval_split: bool = True, resolution: int = 1,
                      resolution_scale: float = 1.0,
                      load_images: bool = True,
                      device="cuda") -> SceneData:
    """The COLMAP scene at `source_path`. load_images=False reads no image
    file: each split's images are zeros of the split's shape (the JAX
    reader's placeholder), for callers that need only the cameras."""
    sparse = os.path.join(source_path, "sparse", "0")
    intr, extr, points = colmap.load_colmap_model(sparse)

    bboxes_dir = os.path.join(source_path, "bboxes")
    masks_dir = os.path.join(source_path, "masks")
    if not os.path.isdir(bboxes_dir):
        bboxes_dir = None
    if not os.path.isdir(masks_dir):
        masks_dir = None

    metas: List[CameraMeta] = []
    poses: Dict[str, tuple] = {}
    for key in extr:
        e = extr[key]
        it = intr[e.camera_id]
        if it.model == "SIMPLE_PINHOLE":
            fx = fy = it.params[0]
        elif it.model == "PINHOLE":
            fx, fy = it.params[0], it.params[1]
        else:
            raise ValueError(
                f"Unsupported COLMAP camera model {it.model}: only undistorted "
                "PINHOLE / SIMPLE_PINHOLE datasets are supported")
        fovx = graphics.focal2fov(fx, it.width)
        fovy = graphics.focal2fov(fy, it.height)
        image_name = os.path.basename(e.name).split(".")[0]
        bbox_path = (os.path.join(bboxes_dir, image_name + ".pt")
                     if bboxes_dir else None)
        mask_paths = (sorted(glob.glob(os.path.join(
            masks_dir, f"{image_name}_*.png"))) if masks_dir else None)
        R_c2w = graphics.qvec_to_rotmat(e.qvec).T
        m = CameraMeta(
            uid=it.id, colmap_id=e.id, image_name=image_name,
            image_path=os.path.join(source_path, images_dir,
                                    os.path.basename(e.name)),
            bbox_path=bbox_path, mask_paths=mask_paths,
            R=R_c2w, T=np.array(e.tvec), fovx=fovx, fovy=fovy)
        poses[image_name] = (it.width, it.height)
        metas.append(m)
    metas.sort(key=lambda m: m.image_name)

    if eval_split:
        train_idx, test_idx = _split_wheat(metas)
    else:
        train_idx, test_idx = list(range(len(metas))), []

    train_w2cs = [graphics.world_to_view(metas[i].R, metas[i].T)
                  for i in train_idx]
    norm = nerfpp_norm(train_w2cs)

    def build_group(idxs: List[int]) -> CameraGroup:
        if not idxs:
            return CameraGroup(
                cameras=make_camera_batch([], [], [], [], 0, 0,
                                          device=device),
                images=np.zeros((0, 3, 0, 0), np.float32), metas=[])
        sel = [metas[i] for i in idxs]
        orig_w, orig_h = poses[sel[0].image_name]
        (w, h), total_scale = resolve_resolution(orig_w, orig_h, resolution,
                                                 resolution_scale)
        if load_images:
            images = np.stack([np.clip(load_image(m.image_path, (w, h))[:3],
                                       0.0, 1.0) for m in sel])
        else:
            images = np.zeros((len(sel), 3, h, w), np.float32)
        for m in sel:
            m.resolution_scale = total_scale
        cams = make_camera_batch(
            [m.R for m in sel], [m.T for m in sel],
            [m.fovx for m in sel], [m.fovy for m in sel], w, h,
            device=device)
        return CameraGroup(cameras=cams, images=images, metas=sel)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path) and points is not None:
        write_points_ply(ply_path, points[0], points[1])
    pcd = read_points_ply(ply_path) if os.path.exists(ply_path) else None

    return SceneData(
        point_cloud=pcd,
        train=build_group(train_idx),
        test=build_group(test_idx),
        cameras_extent=float(norm["radius"]),
        translate=norm["translate"],
        ply_path=ply_path)


def export_scene_artifacts(scene: SceneData, model_path: str) -> None:
    """Write input.ply + cameras.json like Scene.__init__
    (reference: scene/__init__.py:52-66)."""
    os.makedirs(model_path, exist_ok=True)
    if os.path.exists(scene.ply_path):
        with open(scene.ply_path, "rb") as src, \
                open(os.path.join(model_path, "input.ply"), "wb") as dst:
            dst.write(src.read())
    json_cams = []
    all_metas = scene.test.metas + scene.train.metas
    sizes = ([(scene.test.cameras.width, scene.test.cameras.height)]
             * len(scene.test.metas)
             + [(scene.train.cameras.width, scene.train.cameras.height)]
             * len(scene.train.metas))
    for uid, (meta, (w, h)) in enumerate(zip(all_metas, sizes)):
        json_cams.append(camera_to_json(uid, meta, w, h))
    with open(os.path.join(model_path, "cameras.json"), "w") as f:
        json.dump(json_cams, f)


def search_max_iteration(point_cloud_dir: str) -> int:
    """Find the max saved iteration_<N> dir
    (reference: utils/system_utils.py:26-28)."""
    saved = [int(d.split("_")[-1]) for d in os.listdir(point_cloud_dir)]
    return max(saved)
