"""Bounding boxes for head clouds (reference:
wheatheadsmorphology/bbox_functions.py).

Counterpart of wheat3dgs_tpu/morphology/bbox.py. The oriented box uses the
PCA frame of `traits.pca3` (sklearn's components and signs, without
sklearn)."""

from __future__ import annotations

import json

import numpy as np

from .traits import pca3


def extract_bounding_box(data: np.ndarray, oriented: bool = False) -> dict:
    pts = np.asarray(data[:, :3], np.float64)
    if not oriented:
        return {"type": "axis_aligned",
                "min_bound": pts.min(axis=0).tolist(),
                "max_bound": pts.max(axis=0).tolist()}
    mean = pts.mean(axis=0)
    R = pca3(pts - mean).components_.T        # columns = local axes
    local = (pts - mean) @ R
    lo, hi = local.min(axis=0), local.max(axis=0)
    center = mean + R @ ((lo + hi) / 2.0)
    return {"type": "oriented", "center": center.tolist(),
            "extent": (hi - lo).tolist(), "R": R.tolist()}


def save_bounding_boxes(bboxes: dict, filename: str) -> None:
    with open(filename, "w") as f:
        json.dump(bboxes, f, indent=2)


def load_bounding_boxes(filename: str) -> dict:
    with open(filename) as f:
        return json.load(f)


def points_in_bbox(pcd: np.ndarray, bbox: dict):
    """Membership test for either box type (reference :79-113)."""
    pts = np.asarray(pcd[:, :3])
    if bbox["type"] == "axis_aligned":
        lo = np.asarray(bbox["min_bound"])
        hi = np.asarray(bbox["max_bound"])
        mask = np.all((pts >= lo) & (pts <= hi), axis=1)
    elif bbox["type"] == "oriented":
        center = np.asarray(bbox["center"])
        half = np.asarray(bbox["extent"]) / 2.0
        R = np.asarray(bbox["R"])
        local = (pts - center) @ R
        mask = np.all(np.abs(local) <= half, axis=1)
    else:
        raise ValueError("Unknown bounding box type.")
    return pts[mask], mask
