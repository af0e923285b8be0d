"""Frame -> mp4 muxing (counterpart of wheat3dgs_tpu/utils/video.py). The
reference shells out to ffmpeg (utils/wheatgs_helper.py:304-317,
render_360.py:124-135); here OpenCV's bundled encoder writes the mp4, and
where OpenCV is missing or cannot open the writer, PIL writes a GIF beside
it. The returned path says which."""

from __future__ import annotations

import os
from typing import List

import numpy as np


def write_video(frames: List[np.ndarray], path: str, fps: int = 20) -> str:
    """frames: list of (H, W, 3) uint8 RGB. Returns the written path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    h, w = frames[0].shape[:2]
    # even dimensions for broad codec compatibility (reference applies the
    # same iw-mod(iw,2) scale filter)
    w2, h2 = w - w % 2, h - h % 2
    try:
        import cv2

        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                 (w2, h2))
        if not writer.isOpened():
            raise RuntimeError("cv2.VideoWriter failed to open")
        for f in frames:
            writer.write(cv2.cvtColor(f[:h2, :w2], cv2.COLOR_RGB2BGR))
        writer.release()
        return path
    except (ImportError, RuntimeError):
        # No OpenCV, or its writer cannot open an mp4 here.
        from PIL import Image

        gif = os.path.splitext(path)[0] + ".gif"
        imgs = [Image.fromarray(f[:h2, :w2]) for f in frames]
        imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)
        return gif


def frames_to_video(frames_dir: str, out_path: str, fps: int = 20) -> str:
    """Mux saved %05d.png frames (reference render_360 writes PNGs first)."""
    from PIL import Image

    names = sorted(f for f in os.listdir(frames_dir) if f.endswith(".png"))
    frames = [np.asarray(Image.open(os.path.join(frames_dir, n)))[:, :, :3]
              for n in names]
    return write_video(frames, out_path, fps)
