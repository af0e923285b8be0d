"""LPIPS perceptual metric (reference: lpipsPyTorch/, three backbones).

Counterpart of wheat3dgs_tpu/ops/lpips.py: the VGG16, AlexNet and
SqueezeNet 1.1 feature trunks as `nn.Module`s, the LPIPS z-score,
unit-normalise and linear-head distance, loading the same npz schema.

Weights file format (npz), following torchvision ``features.<i>.*`` naming:
  vgg      conv kernels ``features.<i>.weight`` (OIHW) / ``.bias`` at the 13
           torchvision VGG16 conv indices; taps after relu1_2..relu5_3.
  alex     5 conv layers at torchvision AlexNet indices 0,3,6,8,10; taps
           after every relu.
  squeeze  first conv at ``features.0.*`` plus Fire modules at indices
           3,4,6,7,9,10,11,12 with ``.squeeze/.expand1x1/.expand3x3``
           sub-keys; 7 taps (networks.py SqueezeNet slices).
plus LPIPS heads ``lin<k>.model.1.weight`` and an optional ``__net__``
marker array (utf-8 bytes of the net type) and ``__untrained__`` flag.

``scripts/convert_lpips_weights.py`` writes this schema from the published
torch checkpoints. ``synthesize_lpips_weights`` writes the deterministic
He-initialised stand-in (the same arrays as the JAX package's, drawn from
the same seeded generator in the same order); results computed with it
are flagged by ``is_untrained`` and are not comparable to published LPIPS.

The convolutions are `F.conv2d` in float32: the package turns cuDNN's TF32
off when it is imported (wheat3dgs_tpu_torch/__init__.py).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# torchvision VGG16 conv layer indices per block (through relu x_2/x_3).
_VGG16_SLICES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
_VGG16_CH = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)

# torchvision AlexNet conv layers: (features idx, out_ch, kernel, stride,
# pad); LPIPS taps after every relu. MaxPool(3, stride 2) follows relu1 and
# relu2 only.
_ALEX_CONVS = ((0, 64, 11, 4, 2), (3, 192, 5, 1, 2), (6, 384, 3, 1, 1),
               (8, 256, 3, 1, 1), (10, 256, 3, 1, 1))
_ALEX_POOL_AFTER = (0, 1)

# torchvision SqueezeNet1_1 features: conv0 (stride 2) + Fire modules
# (idx, squeeze_ch, expand_ch), each Fire outputting 2 * expand_ch;
# MaxPool(3, 2, ceil_mode) after features idx 1, 4, 7; 7 taps.
_SQUEEZE_FIRES = ((3, 16, 64), (4, 16, 64), (6, 32, 128), (7, 32, 128),
                  (9, 48, 192), (10, 48, 192), (11, 64, 256), (12, 64, 256))
_SQUEEZE_POOL_AFTER = (1, 4, 7)
_SQUEEZE_TAPS = (1, 4, 7, 9, 10, 11, 12)

LIN_CHANNELS = {
    "vgg": (64, 128, 256, 512, 512),
    "alex": (64, 192, 384, 256, 256),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}


def _conv(data: dict, name: str, stride: int = 1, pad: int = 1) -> nn.Conv2d:
    w = torch.as_tensor(np.asarray(data[f"{name}.weight"], np.float32))
    b = torch.as_tensor(np.asarray(data[f"{name}.bias"], np.float32))
    conv = nn.Conv2d(w.shape[1], w.shape[0], w.shape[2], stride=stride,
                     padding=pad)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(b)
    return conv


class VGGFeatures(nn.Module):
    """VGG16 trunk: the five block-end ReLU outputs."""

    def __init__(self, data: dict):
        super().__init__()
        self.blocks = nn.ModuleList(
            nn.ModuleList(_conv(data, f"features.{i}") for i in block)
            for block in _VGG16_SLICES)

    def forward(self, x):
        feats = []
        for bi, block in enumerate(self.blocks):
            for conv in block:
                x = F.relu(conv(x))
            feats.append(x)
            if bi < len(self.blocks) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


class AlexFeatures(nn.Module):
    """AlexNet trunk: every ReLU output."""

    def __init__(self, data: dict):
        super().__init__()
        self.convs = nn.ModuleList(
            _conv(data, f"features.{i}", stride=s, pad=p)
            for (i, _, _, s, p) in _ALEX_CONVS)

    def forward(self, x):
        feats = []
        for ci, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            feats.append(x)
            if ci in _ALEX_POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return feats


class Fire(nn.Module):
    def __init__(self, data: dict, idx: int):
        super().__init__()
        self.squeeze = _conv(data, f"features.{idx}.squeeze", pad=0)
        self.expand1x1 = _conv(data, f"features.{idx}.expand1x1", pad=0)
        self.expand3x3 = _conv(data, f"features.{idx}.expand3x3", pad=1)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)),
                          F.relu(self.expand3x3(s))], dim=1)


class SqueezeFeatures(nn.Module):
    """SqueezeNet 1.1 trunk: the seven LPIPS taps. Its pools use ceil mode
    (torch pads right and bottom only, as the JAX package does)."""

    def __init__(self, data: dict):
        super().__init__()
        self.conv0 = _conv(data, "features.0", stride=2, pad=0)
        self.fires = nn.ModuleDict(
            {str(i): Fire(data, i) for (i, _, _) in _SQUEEZE_FIRES})

    def forward(self, x):
        feats = []
        x = F.relu(self.conv0(x))
        for idx in range(1, 13):
            if str(idx) in self.fires:
                x = self.fires[str(idx)](x)
            if idx in _SQUEEZE_TAPS:
                feats.append(x)
            if idx in _SQUEEZE_POOL_AFTER:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        return feats


_FEATURES = {"vgg": VGGFeatures, "alex": AlexFeatures,
             "squeeze": SqueezeFeatures}


def _normalize(feat, eps=1e-10):
    norm = torch.sqrt((feat ** 2).sum(dim=1, keepdim=True))
    return feat / (norm + eps)


class LPIPS(nn.Module):
    """lpips(x, y) for (3, H, W) or (B, 3, H, W) images in [0, 1]: a
    scalar for one image pair, else (B,) per pair. Images go to the z-score
    directly, with no 2x - 1 (the reference pipeline, networks.py:49-53 and
    metrics.py:31-32, feeds to_tensor() images in [0, 1])."""

    def __init__(self, data: dict, net: str):
        super().__init__()
        self.net = net
        self.features = _FEATURES[net](data)
        lins = [torch.as_tensor(np.asarray(data[f"lin{k}.model.1.weight"],
                                           np.float32)).reshape(1, -1, 1, 1)
                for k in range(len(LIN_CHANNELS[net]))]
        for k, w in enumerate(lins):
            self.register_buffer(f"lin{k}", w)
        self.register_buffer("shift", torch.as_tensor(_SHIFT).reshape(
            1, 3, 1, 1))
        self.register_buffer("scale", torch.as_tensor(_SCALE).reshape(
            1, 3, 1, 1))

    @torch.no_grad()
    def forward(self, x, y):
        if x.dim() == 3:
            x, y = x[None], y[None]
        fx = self.features((x - self.shift) / self.scale)
        fy = self.features((y - self.shift) / self.scale)
        val = 0.0
        for k, (a, b) in enumerate(zip(fx, fy)):
            d = (_normalize(a) - _normalize(b)) ** 2
            val = val + (getattr(self, f"lin{k}") * d).sum(
                dim=1, keepdim=True).mean(dim=(2, 3))
        return val.reshape(()) if val.numel() == 1 else val.reshape(-1)


def _detect_net(data: dict) -> str:
    if "__net__" in data:
        return bytes(np.asarray(data["__net__"]).tolist()).decode()
    if "features.3.squeeze.weight" in data:
        return "squeeze"
    if "features.28.weight" in data:
        return "vgg"
    return "alex"


def is_untrained(weights_path: str) -> bool:
    """True when the npz was produced by synthesize_lpips_weights: results
    computed with it must be labeled (not comparable to published LPIPS)."""
    with np.load(weights_path) as data:
        return bool(data.get("__untrained__", np.zeros(1))[0])


def load_lpips(weights_path: str, net_type: str | None = None,
               device="cuda") -> Callable:
    """The LPIPS module for the npz at `weights_path`, on `device`, in
    eval mode; call it as lpips(x, y)."""
    dev = resolve_device(device)
    data = dict(np.load(weights_path))
    net = net_type or _detect_net(data)
    return LPIPS(data, net).to(dev).eval()


def synthesize_lpips_weights(out_path: str, net_type: str = "vgg",
                             seed: int = 0) -> None:
    """Write a DETERMINISTIC He-initialised backbone npz: the exact LPIPS
    architecture with random features, reproducible from the seed (the
    arrays equal the JAX package's). Flagged by ``is_untrained``."""
    rng = np.random.default_rng(seed)

    def he(o, i, k):
        std = float(np.sqrt(2.0 / (i * k * k)))
        return rng.normal(0.0, std, size=(o, i, k, k)).astype(np.float32)

    arrs = {}
    if net_type == "vgg":
        in_ch = 3
        for i, o in zip([i for b in _VGG16_SLICES for i in b], _VGG16_CH):
            arrs[f"features.{i}.weight"] = he(o, in_ch, 3)
            arrs[f"features.{i}.bias"] = np.zeros(o, np.float32)
            in_ch = o
    elif net_type == "alex":
        in_ch = 3
        for (i, o, k, _, _) in _ALEX_CONVS:
            arrs[f"features.{i}.weight"] = he(o, in_ch, k)
            arrs[f"features.{i}.bias"] = np.zeros(o, np.float32)
            in_ch = o
    elif net_type == "squeeze":
        arrs["features.0.weight"] = he(64, 3, 3)
        arrs["features.0.bias"] = np.zeros(64, np.float32)
        in_ch = 64
        for (i, s, e) in _SQUEEZE_FIRES:
            arrs[f"features.{i}.squeeze.weight"] = he(s, in_ch, 1)
            arrs[f"features.{i}.squeeze.bias"] = np.zeros(s, np.float32)
            arrs[f"features.{i}.expand1x1.weight"] = he(e, s, 1)
            arrs[f"features.{i}.expand1x1.bias"] = np.zeros(e, np.float32)
            arrs[f"features.{i}.expand3x3.weight"] = he(e, s, 3)
            arrs[f"features.{i}.expand3x3.bias"] = np.zeros(e, np.float32)
            in_ch = 2 * e
    else:
        raise ValueError(net_type)
    for k, c in enumerate(LIN_CHANNELS[net_type]):
        arrs[f"lin{k}.model.1.weight"] = np.full((1, c, 1, 1),
                                                 1.0 / c, np.float32)
    arrs["__net__"] = np.frombuffer(net_type.encode(), np.uint8)
    arrs["__untrained__"] = np.ones(1, np.int8)
    np.savez(out_path, **arrs)


def default_weights(net_type: str = "vgg", seed: int = 0) -> str:
    """Path to the synthesized stand-in, created on first use under this
    package's .lpips_cache/."""
    cache = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".lpips_cache")
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, f"lpips_{net_type}_seed{seed}.npz")
    if not os.path.exists(path):
        # Written under a private name, then renamed: a process that finds
        # the path never reads a half-written file.
        tmp = f"{path}.{os.getpid()}.npz"
        synthesize_lpips_weights(tmp, net_type, seed)
        os.replace(tmp, path)
    return path
