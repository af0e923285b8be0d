"""SIBR remote-viewer TCP protocol (reference: gaussian_renderer/
network_gui.py — vestigial in the reference too: present but never imported
by an entry point).

Wire format: [u32-LE length][JSON camera message] in, raw RGB bytes +
[u32-LE length][verify string] out. The JSON carries row-major torch-style
(transposed) view / view-projection matrices with the SIBR Y/Z flip; this
module converts them to our column-vector convention and returns plain
arrays, so any render loop can serve the viewer.

Counterpart of wheat3dgs_tpu/render/network_gui.py; `serve_render` renders
through the port's render_fwd on the state's device.
"""

from __future__ import annotations

import json
import socket
from typing import Optional, Tuple

import numpy as np

host = "127.0.0.1"
port = 6009

conn: Optional[socket.socket] = None
addr = None
listener: Optional[socket.socket] = None


def init(wish_host: str = host, wish_port: int = port) -> None:
    global host, port, listener
    host, port = wish_host, wish_port
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, port))
    listener.listen()
    listener.settimeout(0)


def try_connect() -> bool:
    global conn, addr
    if listener is None:
        return False
    try:
        conn, addr = listener.accept()
        conn.settimeout(None)
        return True
    except (BlockingIOError, socket.timeout, OSError):
        return False


def _read_message() -> dict:
    assert conn is not None
    length = int.from_bytes(conn.recv(4), "little")
    buf = b""
    while len(buf) < length:
        chunk = conn.recv(length - len(buf))
        if not chunk:
            raise ConnectionError("viewer disconnected")
        buf += chunk
    return json.loads(buf.decode("utf-8"))


def send(image_bytes: Optional[bytes], verify: str) -> None:
    assert conn is not None
    if image_bytes is not None:
        conn.sendall(image_bytes)
    conn.sendall(len(verify).to_bytes(4, "little"))
    conn.sendall(verify.encode("ascii"))


def receive() -> Tuple[Optional[dict], bool, bool, bool, bool, float]:
    """Returns (camera dict or None, do_training, shs_python,
    rot_scale_python, keep_alive, scaling_modifier). The camera dict holds
    column-vector-convention `w2c`/`full_proj` plus width/height/tanfov."""
    msg = _read_message()
    width, height = msg["resolution_x"], msg["resolution_y"]
    if width == 0 or height == 0:
        return None, None, None, None, None, None

    # SIBR sends transposed (row-vector) matrices with Y/Z columns flipped.
    w2c_t = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
    w2c_t[:, 1] = -w2c_t[:, 1]
    w2c_t[:, 2] = -w2c_t[:, 2]
    fp_t = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
    fp_t[:, 1] = -fp_t[:, 1]
    w2c = w2c_t.T
    cam = {
        "width": int(width), "height": int(height),
        "w2c": w2c, "full_proj": fp_t.T,
        "cam_center": np.linalg.inv(w2c)[:3, 3].astype(np.float32),
        "tanfovx": float(np.tan(msg["fov_x"] / 2)),
        "tanfovy": float(np.tan(msg["fov_y"] / 2)),
        "znear": msg["z_near"], "zfar": msg["z_far"],
    }
    return (cam, bool(msg["train"]), bool(msg["shs_python"]),
            bool(msg["rot_scale_python"]), bool(msg["keep_alive"]),
            float(msg["scaling_modifier"]))


def serve_render(state, sh_degree: int, verify: str = "ok",
                 config=None) -> bool:
    """One receive -> render -> send cycle; True while the peer keeps alive."""
    import torch

    from .pipeline import RasterConfig, render_fwd

    cam, do_training, _, _, keep_alive, scale_mod = receive()
    if cam is None:
        return False
    dev = state.device
    out = render_fwd(
        state, torch.as_tensor(cam["w2c"], device=dev),
        torch.as_tensor(cam["full_proj"], device=dev),
        torch.as_tensor(cam["cam_center"], device=dev), cam["tanfovx"],
        cam["tanfovy"], cam["width"], cam["height"], sh_degree=sh_degree,
        scale_modifier=scale_mod, config=config or RasterConfig())
    img = np.clip(out.color.cpu().numpy(), 0, 1)
    payload = (img.transpose(1, 2, 0) * 255).astype(np.uint8).tobytes()
    send(payload, verify)
    return keep_alive
