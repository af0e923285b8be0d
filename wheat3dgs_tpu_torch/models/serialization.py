"""GaussianState <-> PLY, bit-compatible with the reference save_ply /
load_ply (scene/gaussian_model.py:196-293) and with the JAX package's
wheat3dgs_tpu/models/serialization.py: float32 properties
x,y,z,nx,ny,nz,f_dc_0..2,f_rest_*,opacity,scale_*,rot_*, plus the wheat
`which_object` channel (stored f4). f_rest is flattened channel-major
((N, K-1, 3) -> transpose -> (N, 3*(K-1))).

Checkpoints are the JAX package's `.npz` layout (its save_checkpoint /
load_checkpoint, :95-107): `iteration` plus `leaf_i` for the leaves of the
state in `jax.tree.flatten(GaussianState)` order (CHECKPOINT_LEAVES), so a
checkpoint written by either package restores in the other.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..io.ply import read_ply, write_ply
from .gaussians import (PARAM_FIELDS, STAT_FIELDS, GaussianParams,
                        GaussianState, init_state, state_from_numpy,
                        state_to_numpy)

# jax.tree.flatten order of the JAX GaussianState: params, Adam mu, Adam nu
# (each in PARAM_FIELDS order), the Adam step, alive, instance_id, stats.
CHECKPOINT_LEAVES = (
    [f"params.{f}" for f in PARAM_FIELDS] + [f"mu.{f}" for f in PARAM_FIELDS]
    + [f"nu.{f}" for f in PARAM_FIELDS]
    + ["step", "alive", "instance_id"] + list(STAT_FIELDS))


def save_ply(state: GaussianState, path: str) -> None:
    """Write only alive Gaussians, reference property order."""
    alive = state.alive.cpu().numpy()

    def host(x):
        return x.detach().cpu().numpy()[alive]

    p = GaussianParams(**{f: host(getattr(state.params, f))
                          for f in PARAM_FIELDS})
    inst = host(state.instance_id).astype("<f4")
    n = p.sh_rest.shape[0]
    k1 = p.sh_rest.shape[1] // 3

    props = {"x": p.means[:, 0], "y": p.means[:, 1], "z": p.means[:, 2],
             "nx": np.zeros(n, "<f4"), "ny": np.zeros(n, "<f4"),
             "nz": np.zeros(n, "<f4")}
    for c in range(3):
        props[f"f_dc_{c}"] = p.sh_dc[:, c]
    # flat coeff-major (n, 3*k1) -> reference channel-major f_rest order
    rest = p.sh_rest.reshape(n, k1, 3).transpose(0, 2, 1).reshape(n, 3 * k1)
    for j in range(3 * k1):
        props[f"f_rest_{j}"] = rest[:, j]
    props["opacity"] = p.opacity_logit
    for c in range(3):
        props[f"scale_{c}"] = p.log_scales[:, c]
    for c in range(4):
        props[f"rot_{c}"] = p.quats[:, c]
    props["which_object"] = inst
    write_ply(path, {k: np.asarray(v, "<f4") for k, v in props.items()})


def load_ply(path: str, capacity: Optional[int] = None,
             device="cuda") -> Tuple[GaussianState, int]:
    """Read a (reference, JAX-package or port) point_cloud.ply -> (state on
    `device`, padded to `capacity` slots or by the JAX package's capacity
    rule, sh_degree)."""
    from .. import resolve_device

    dev = resolve_device(device)
    v = read_ply(path)
    n = len(v["x"])
    means = np.stack([v["x"], v["y"], v["z"]], 1)
    sh_dc = np.stack([v[f"f_dc_{c}"] for c in range(3)], 1)
    rest_names = sorted((k for k in v if k.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    k1 = len(rest_names) // 3
    sh_degree = int(round(np.sqrt(k1 + 1))) - 1
    if (sh_degree + 1) ** 2 - 1 != k1:
        raise ValueError(f"{path}: {len(rest_names)} f_rest bands do not "
                         "match an SH degree")
    if k1:
        rest = np.stack([v[nm] for nm in rest_names], 1).reshape(n, 3, k1)
        sh_rest = rest.transpose(0, 2, 1).reshape(n, 3 * k1)  # coeff-major
    else:
        sh_rest = np.zeros((n, 0), np.float32)
    log_scales = np.stack([v[f"scale_{c}"] for c in range(3)], 1)
    quats = np.stack([v[f"rot_{c}"] for c in range(4)], 1)
    inst = v.get("which_object", np.zeros(n, np.float32)).astype(np.int32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)

    params = GaussianParams(means=t(means), quats=t(quats),
                            log_scales=t(log_scales), sh_dc=t(sh_dc),
                            sh_rest=t(sh_rest),
                            opacity_logit=t(v["opacity"]))
    return init_state(params, instance_id=inst, capacity=capacity), \
        sh_degree


def save_checkpoint(state: GaussianState, iteration: int, path: str) -> None:
    """The full training state (params, Adam moments and step, masks,
    statistics) at `iteration`, as the JAX package writes it."""
    st = state_to_numpy(state)
    leaves = ([st.params[f] for f in PARAM_FIELDS]
              + [st.adam["mu"][f] for f in PARAM_FIELDS]
              + [st.adam["nu"][f] for f in PARAM_FIELDS]
              + [np.asarray(st.adam["step"], np.int32), st.alive,
                 st.instance_id]
              + [getattr(st, f) for f in STAT_FIELDS])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, iteration=iteration,
             **{f"leaf_{i}": a for i, a in enumerate(leaves)})


def load_checkpoint(path: str, device="cuda") -> Tuple[GaussianState, int]:
    """A checkpoint of either package -> (state on `device` at the stored
    capacity, iteration)."""
    data = np.load(path)
    leaf = {name: data[f"leaf_{i}"]
            for i, name in enumerate(CHECKPOINT_LEAVES)}
    state = state_from_numpy(
        {f: leaf[f"params.{f}"] for f in PARAM_FIELDS},
        alive=leaf["alive"], instance_id=leaf["instance_id"], device=device,
        adam={"mu": {f: leaf[f"mu.{f}"] for f in PARAM_FIELDS},
              "nu": {f: leaf[f"nu.{f}"] for f in PARAM_FIELDS},
              "step": int(leaf["step"])},
        **{f: leaf[f] for f in STAT_FIELDS})
    return state, int(data["iteration"])
