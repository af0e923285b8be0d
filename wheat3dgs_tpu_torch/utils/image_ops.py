"""Mask / bbox / overlay helpers (reference: utils/wheatgs_utils.py,
utils/image_helper.py).

A numpy copy of wheat3dgs_tpu/utils/image_ops.py: these run on the host in
the segmentation loop and the artifact writers."""

from __future__ import annotations

import colorsys

import numpy as np


def load_image_chw(path: str, resolution=None) -> np.ndarray:
    """PIL load (+optional resize) -> (C, H, W) float32 in [0, 1]
    (reference PILtoTorch, utils/wheatgs_utils.py:14-24)."""
    from PIL import Image

    with Image.open(path) as img:
        if resolution is not None:
            img = img.resize(resolution)
        arr = np.asarray(img, dtype=np.float32)
    if arr.max() > 1.0:
        arr = np.clip(arr / 255.0, 0.0, 1.0)
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return arr


def binarize_mask(chw: np.ndarray) -> np.ndarray:
    """(1|3, H, W) in [0,1] -> (H, W) bool; any nonzero channel = foreground
    (reference binarize_mask, utils/wheatgs_utils.py:26-38)."""
    if chw.min() < 0.0 or chw.max() > 1.0:
        raise ValueError("mask values must lie in [0, 1]")
    if chw.shape[0] == 1:
        return chw[0] > 0
    if chw.shape[0] >= 3:
        return (chw[:3] > 0).any(axis=0)
    raise ValueError("mask must have 1 or 3 channels")


def read_mask(path: str, resolution=None) -> np.ndarray:
    return binarize_mask(load_image_chw(path, resolution))


def get_bbox_from_mask(mask: np.ndarray):
    """(H, W) bool -> (x_min, y_min, x_max, y_max) or None."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return None
    return (xs.min(), ys.min(), xs.max(), ys.max())


def is_overlapping(box1, box2) -> bool:
    if box1 is None or box2 is None:
        return False
    x0a, y0a, x1a, y1a = box1
    x0b, y0b, x1b, y1b = box2
    return not (x1a < x0b or x1b < x0a or y1a < y0b or y1b < y0a)


def calculate_bbox_iou(box1, box2) -> float:
    x0 = max(box1[0], box2[0])
    y0 = max(box1[1], box2[1])
    x1 = min(box1[2], box2[2])
    y1 = min(box1[3], box2[3])
    inter = max(0, x1 - x0) * max(0, y1 - y0)
    a1 = (box1[2] - box1[0]) * (box1[3] - box1[1])
    a2 = (box2[2] - box2[0]) * (box2[3] - box2[1])
    union = a1 + a2 - inter
    return inter / union if union > 0 else 0.0


def calculate_seg_iou(mask1: np.ndarray, mask2: np.ndarray) -> float:
    inter = np.logical_and(mask1, mask2).sum()
    union = np.logical_or(mask1, mask2).sum()
    return float(inter / union) if union > 0 else 0.0


def calculate_precision(pred: np.ndarray, gt: np.ndarray) -> float:
    inter = np.logical_and(pred, gt).sum()
    return float(inter / pred.sum()) if pred.sum() > 0 else 0.0


def calculate_recall(pred: np.ndarray, gt: np.ndarray) -> float:
    inter = np.logical_and(pred, gt).sum()
    return float(inter / gt.sum()) if gt.sum() > 0 else 0.0


def id2rgb(idx: int, max_num_obj: int = 999) -> np.ndarray:
    """Golden-ratio instance palette; id 0 = black
    (reference id2rgb, utils/image_helper.py:21-42)."""
    if not 0 <= idx <= max_num_obj:
        raise ValueError("ID should be in range(0, max_num_obj)")
    if idx == 0:
        return np.zeros(3, np.uint8)
    golden_ratio = 1.6180339887
    h = (idx * golden_ratio) % 1
    s = 0.5 + (idx % 2) * 0.5
    r, g, b = colorsys.hls_to_rgb(h, 0.5, s)
    return np.array([r * 255, g * 255, b * 255], np.uint8)


def palette(n: int) -> np.ndarray:
    """(n+1, 3) uint8 palette for ids 0..n."""
    return np.stack([id2rgb(i) for i in range(n + 1)])


def visualize_obj(objects: np.ndarray) -> np.ndarray:
    """(H, W) int id map -> (3, H, W) uint8 color visualization."""
    ids = np.unique(objects)
    rgb = np.zeros((*objects.shape, 3), np.uint8)
    for i in ids:
        rgb[objects == i] = id2rgb(int(i))
    return rgb.transpose(2, 0, 1)


def overlay_image(image: np.ndarray, mask_rgb: np.ndarray,
                  alpha: float = 0.5) -> np.ndarray:
    """(3,H,W) float image + (3,H,W) float mask colors -> overlay where mask
    is non-black (reference overlay_image, utils/image_helper.py:44-48)."""
    out = image.copy()
    nz = (mask_rgb > 0).any(axis=0)
    out[:, nz] = alpha * mask_rgb[:, nz] + (1 - alpha) * image[:, nz]
    return out


def save_overlay(img_chw: np.ndarray, pred_seg: np.ndarray, path: str,
                 color=(1.0, 0.0, 0.0), alpha: float = 0.5,
                 resize_factor: int = 1) -> None:
    """Red-overlay inspection JPEG (reference vis_image_w_overlay,
    utils/wheatgs_utils.py:109-138)."""
    from PIL import Image

    mask_rgb = np.zeros_like(img_chw)
    for c in range(3):
        mask_rgb[c][pred_seg] = color[c]
    out = overlay_image(img_chw, mask_rgb, alpha)
    pil = Image.fromarray(
        (np.clip(out, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8))
    if resize_factor > 1:
        pil = pil.resize((pil.width // resize_factor,
                          pil.height // resize_factor))
    pil.save(path)
