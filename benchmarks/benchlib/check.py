"""What decides `correct`: the program's first steps, the first steps it
takes at each SH degree the window reaches, and its first densify in the
window, held against the plain reference.

- First steps (`reference_steps`, `step_gaps`): the reference starts from
  the same point cloud (it works out the initial splats itself) and follows
  the program's first three steps on the same views, iterations and
  ground truth. Compared: each step's loss (`loss_gap`, the relative gap),
  the first gradient of each leaf and of the screen-space statistic
  (`grad_gap`) and each leaf's change over the three steps (`change_gap`),
  each as the gap between the two norms over the larger of the
  reference's norm of that leaf and its median leaf's. Leaves whose
  reference gradient is under a thousandth of the median leaf's (nought to
  rounding, e.g. the SH bands above the active degree) are left out of the
  change.
- Each SH degree the window reaches (`sh_loss_gap`, `sh_grad_gap`,
  `sh_change_gap`, the worst degree): the first three steps of the first
  block at that degree (the recaptured graph: its eager first step and two
  replays). The reference starts from the program's state, Adam's moments
  and step just before that block (its own state after a thousand steps
  and a dozen densifies it could not follow in a run's time) and follows
  the three steps; compared as above.
- The first densify in the window (`DensifyRecorder`, `densify_mismatch`):
  the reference applies the published clone / split / prune rule to the
  program's state just before it (its accumulated statistics are the
  program's: the reference cannot follow hundreds of steps) and counts the
  rows of the program's result that disagree: kept rows changed or lost,
  clones and split halves missing or extra, split halves off their
  parent's Gaussian (beyond 8 sigma). With a fixed capacity the requests
  beyond the free slots are dropped, clones first, in row order, as the
  configuration states.
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

from reference import step as ref
from reference.raster import rotation

NOUGHT = 1e-3        # a leaf's gradient under this share of the median's


@contextlib.contextmanager
def tf32(on: bool):
    """Matmuls and convolutions in TF32 (on) or in float32 (off)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def reference_steps(plot, views: list, its: list, sh_max: int,
                    sh_active: int, mix: dict, dev, low: bool = False,
                    start: dict = None):
    """The reference's readings of n steps of one plot, in the program's
    record's layout (one plot), from the point cloud (start None) or from
    a program state (`Single._start`: its alive rows, Adam's moments and
    step). low: in TF32 (the control)."""
    opt = mix["optimization"]
    with tf32(low):
        if start is None:
            state = ref.init_state(plot.points, plot.colors, sh_max, dev)
            adam = ref.adam_init(state)
        else:
            rows = start["alive"]
            state = {k: start["params"][k][rows] for k in ref.LEAVES}
            adam = {"t": start["t"],
                    "m": {k: start["m"][k][rows] for k in ref.LEAVES},
                    "v": {k: start["v"][k][rows] for k in ref.LEAVES}}
        first = state
        rec = {"losses": []}
        for j, (it, v) in enumerate(zip(its, views)):
            out = ref.train_step(
                state, adam, plot.cams[v], plot.gt[v], plot.width,
                plot.height, sh_active,
                ref.learning_rates(it, opt, plot.extent),
                opt["lambda_dssim"])
            if j == 0:
                rec["grad"] = {k: float(torch.linalg.vector_norm(
                    g.double())) for k, g in out.grads.items()}
            state, adam = out.state, out.adam
            rec["losses"].append(out.loss)
        rec["change"] = {k: float(torch.linalg.vector_norm(
            (state[k] - first[k]).double())) for k in ref.LEAVES}
    return rec


def as_program(rec: dict) -> dict:
    """A reference record (one plot) in the program's record's layout: the
    control puts the reference in the program's place."""
    return {"losses": [[x] for x in rec["losses"]],
            "grad": {k: [v] for k, v in rec["grad"].items()},
            "change": {k: [v] for k, v in rec["change"].items()}}


def _gap(got: float, want: float, floor: float) -> float:
    return abs(got - want) / max(want, floor, 1e-30)


def step_gaps(prog: dict, refs: list, worst: dict = None) -> dict:
    """loss_gap, grad_gap and change_gap of the program's record against
    one reference record per plot (the worst plot); `worst`, when given,
    gets where each was read (plot, step or leaf)."""
    best = {"loss_gap": (0.0, None), "grad_gap": (0.0, None),
            "change_gap": (0.0, None)}

    def keep(name, gap, where):
        if gap >= best[name][0]:
            best[name] = (gap, where)

    for p, r in enumerate(refs):
        for j, lr in enumerate(r["losses"]):
            keep("loss_gap", _gap(prog["losses"][j][p], lr, 0.0),
                 f"plot {p} step {j + 1}")
        med = float(np.median([r["grad"][k] for k in ref.LEAVES]))
        for k, g in r["grad"].items():
            keep("grad_gap", _gap(prog["grad"][k][p], g, med),
                 f"plot {p} {k}")
        cmed = float(np.median([r["change"][k] for k in ref.LEAVES]))
        for k in ref.LEAVES:
            if r["grad"][k] >= NOUGHT * med:
                keep("change_gap", _gap(prog["change"][k][p],
                                        r["change"][k], cmed),
                     f"plot {p} {k}")
    if worst is not None:
        worst.update({k: v[1] for k, v in best.items()})
    return {k: v[0] for k, v in best.items()}


class DensifyRecorder:
    """Wraps the program's densify_and_prune and keeps, of its first call
    while `armed`, the state it was given (untouched afterwards: the
    program replaces it) and a copy of the rows it returned."""

    def __init__(self, module):
        self.module = module
        self.orig = module.densify_and_prune
        self.armed = False
        self.pre = self.post = self.args = None

    def __enter__(self):
        def wrapped(state, *args, **kw):
            out, info = self.orig(state, *args, **kw)
            if self.armed and self.pre is None:
                self.pre, self.args = state, (args, kw)
                self.post = {"alive": out.alive.clone(),
                             **{k: v.clone() for k, v in
                                out.params.as_dict().items()}}
            return out, info

        self.module.densify_and_prune = wrapped
        return self

    def __exit__(self, *exc):
        self.module.densify_and_prune = self.orig


_MIX = None


def _hash(rows: list) -> torch.Tensor:
    """An int64 key per row of the float32 tensors `rows` (bit patterns
    mixed with odd multipliers; equal rows give equal keys)."""
    global _MIX
    cols = torch.cat([r.reshape(r.shape[0], -1) for r in rows], dim=1)
    bits = cols.contiguous().view(torch.int32).to(torch.int64)
    if _MIX is None or _MIX.shape[0] < bits.shape[1]:
        g = np.random.default_rng(12345)
        _MIX = torch.as_tensor(g.integers(1, 1 << 62, 128) * 2 + 1)
    mix = _MIX[:bits.shape[1]].to(bits.device)
    return (bits * mix).sum(dim=1)


def densify_mismatch(pre, post: dict, rule: dict, extent: float,
                     prune_world: bool) -> int:
    """Rows of the program's densify result that the reference's rule does
    not give (see the module docstring)."""
    p = {k: v for k, v in pre.params.as_dict().items()}
    alive = pre.alive
    cls = ref.densify_classes(p, alive, pre.grad_accum, pre.denom, rule,
                              extent, prune_world)
    keep = alive & ~cls["prune"] & ~cls["split"]
    same = post["alive"].clone()
    for k in ref.LEAVES:
        same &= (post[k].reshape(len(same), -1)
                 == p[k].reshape(len(same), -1)).all(dim=1)
    bad = int((keep & ~same).sum())
    # The requests, in the order the free slots take them.
    free = int((~keep).sum())
    clones = torch.nonzero(cls["clone"]).squeeze(1)
    splits = torch.nonzero(cls["split"]).squeeze(1)
    n_clone = min(len(clones), free)
    clones = clones[:n_clone]
    halves = torch.arange(2 * len(splits), device=alive.device)
    halves = halves[:max(0, free - n_clone)]
    parents = splits[torch.div(halves, 2, rounding_mode="floor")]
    others = [k for k in ref.LEAVES if k not in ("means", "log_scales")]
    child_scales = torch.log(torch.exp(p["log_scales"][parents]) / (0.8 * 2.0))
    want_full = collections.Counter(_hash(
        [p[k][clones] for k in ref.LEAVES]).tolist())
    want_half = collections.Counter(_hash(
        [child_scales] + [p[k][parents] for k in others]).tolist())
    half_parent = dict(zip(_hash([child_scales] + [p[k][parents]
                                                   for k in others]).tolist(),
                           parents.tolist()))
    new = torch.nonzero(post["alive"] & ~(keep & same)).squeeze(1)
    full = _hash([post[k][new] for k in ref.LEAVES]).tolist()
    half = _hash([post["log_scales"][new]] + [post[k][new]
                                               for k in others]).tolist()
    matched_rows, matched_parents = [], []
    unmatched = 0
    for row, kf, kh in zip(new.tolist(), full, half):
        if want_full[kf] > 0:
            want_full[kf] -= 1
        elif want_half[kh] > 0:
            want_half[kh] -= 1
            matched_rows.append(row)
            matched_parents.append(half_parent[kh])
        else:
            unmatched += 1
    missing = sum(want_full.values()) + sum(want_half.values())
    far = 0
    if matched_rows:
        rows = torch.as_tensor(matched_rows, device=alive.device)
        par = torch.as_tensor(matched_parents, device=alive.device)
        q = p["quats"][par]
        q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
        off = (post["means"][rows] - p["means"][par])[:, :, None]
        z = (rotation(q).transpose(1, 2) @ off)[:, :, 0] / torch.exp(
            p["log_scales"][par])
        far = int((z.abs().amax(dim=1) > 8.0).sum())
    return bad + unmatched + missing + far

