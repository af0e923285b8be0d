"""Scene container: dataset + GaussianState + model-dir artifacts.

Counterpart of wheat3dgs_tpu/scene.py (reference Scene, scene/__init__.py:
30-117): loads the COLMAP scene, then either loads a saved iteration
(`point_cloud/iteration_<it>/point_cloud.ply`) or creates the Gaussians from
the scene's point cloud and writes input.ply / cameras.json into the model
dir, and exposes the train/test cameras and images (load_images=False
reads no image file, for callers that need only the cameras). The Blender
reader waits for a later slice of the port.
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .config import ModelParams
from .io.dataset import (SceneData, export_scene_artifacts, read_colmap_scene,
                         search_max_iteration)
from .models import gaussians as G
from .models.serialization import load_ply, save_ply


class Scene:
    def __init__(self, model: ModelParams, sh_degree: int = 3,
                 load_iteration: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0, load_images: bool = True,
                 capacity: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        self.model_path = model.model_path
        self.sh_degree = sh_degree
        if os.path.exists(os.path.join(model.source_path, "sparse")):
            self.data: SceneData = read_colmap_scene(
                model.source_path, images_dir=model.images,
                eval_split=model.eval, resolution=model.resolution,
                load_images=load_images, device=self.device)
        elif os.path.exists(os.path.join(model.source_path,
                                         "transforms_train.json")):
            raise NotImplementedError(
                "Blender scenes: the reader is not ported yet (a later "
                "slice of the port)")
        else:
            raise ValueError(
                f"could not recognize scene type in {model.source_path}")
        self.cameras_extent = self.data.cameras_extent

        self.loaded_iter = None
        if load_iteration is not None:
            pc_dir = os.path.join(self.model_path, "point_cloud")
            self.loaded_iter = (search_max_iteration(pc_dir)
                                if load_iteration == -1 else load_iteration)
            ply = os.path.join(pc_dir, f"iteration_{self.loaded_iter}",
                               "point_cloud.ply")
            self.gaussians, self.sh_degree = load_ply(
                ply, capacity=capacity, device=self.device)
        else:
            if self.data.point_cloud is None:
                raise ValueError("no points3D in scene and no saved model")
            self.gaussians = G.create_from_pcd(
                self.data.point_cloud.points.astype(np.float32),
                self.data.point_cloud.colors.astype(np.float32),
                sh_degree, capacity=capacity, device=self.device)
            if self.model_path:
                export_scene_artifacts(self.data, self.model_path)

        # Shuffled host-side index order (reference shuffles camera lists,
        # scene/__init__.py:69-71); the tensors stay in load order so metas
        # and images stay aligned.
        self.train_order = list(range(len(self.data.train.metas)))
        self.test_order = list(range(len(self.data.test.metas)))
        if shuffle:
            rnd = random.Random(seed)
            rnd.shuffle(self.train_order)
            rnd.shuffle(self.test_order)

    def cam_arrays(self, split: str, idx: int):
        group = self.data.train if split == "train" else self.data.test
        c = group.cameras
        return (c.w2c[idx], c.full_proj[idx], c.cam_center[idx],
                c.tanfovx[idx], c.tanfovy[idx])

    def cam_stack(self, split: str):
        """The split's cameras as stacked tensors (w2c, full_proj,
        cam_center, tanfovx, tanfovy), each with a leading view axis."""
        group = self.data.train if split == "train" else self.data.test
        c = group.cameras
        return (c.w2c, c.full_proj, c.cam_center, c.tanfovx, c.tanfovy)

    def gt_image(self, split: str, idx: int) -> torch.Tensor:
        """(3, H, W) float32 ground-truth image on the scene's device."""
        group = self.data.train if split == "train" else self.data.test
        return torch.as_tensor(group.images[idx], device=self.device)

    @property
    def image_size(self):
        c = self.data.train.cameras
        return c.width, c.height

    def save(self, iteration: int,
             state: Optional[G.GaussianState] = None) -> None:
        """Write `point_cloud/iteration_<it>/point_cloud.ply` (alive
        Gaussians only)."""
        state = state if state is not None else self.gaussians
        out = os.path.join(self.model_path, "point_cloud",
                           f"iteration_{iteration}")
        os.makedirs(out, exist_ok=True)
        save_ply(state, os.path.join(out, "point_cloud.ply"))
