"""The training run a cell drives: the program's own entry and feed.

`Single` drives `training.Trainer` on one plot under the training CLI's
block rule (`apps/train_vanilla.block_len`): a block of K > 1 steps goes
through `Trainer.step_block`, one step through `Trainer.step`, and the host
reads what the CLI reads (its log every LOG_EVERY iterations and each
densify's counts). It draws the views as the published trainer does, from
a stack of the train views refilled in a fresh random order when it
empties (seeded by the run's seed), so every seed sees every view equally
often. `run_block` runs the next block and returns its steps and its kind:
"replayed" (no capture), "recaptured" (the block captured its step again),
"densify" (it ends at a densify) or "single" (one eager step).

The readings `correct` holds to the reference (check.py) are taken from
the same object: the first steps of set-up (`first_steps`) and, in the
window, the first steps of the first block at each SH degree the ramp
reaches (`run_block(record=...)`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wheat3dgs_tpu_torch.apps.train_vanilla import LOG_EVERY, block_len
from wheat3dgs_tpu_torch.config import OptimizationParams
from wheat3dgs_tpu_torch.models import gaussians as G
from wheat3dgs_tpu_torch.render.pipeline import RasterConfig
from wheat3dgs_tpu_torch.training import Trainer

from .scene import plot_seed

LEAVES = G.PARAM_FIELDS
B1 = 0.9


class ViewStream:
    """A plot's view picks: epochs of random permutations of its views."""

    def __init__(self, n_views: int, seed: int):
        self.n = n_views
        self.rng = np.random.default_rng(seed)
        self.buf: list = []

    def take(self, k: int) -> list:
        while len(self.buf) < k:
            self.buf.extend(self.rng.permutation(self.n).tolist())
        out, self.buf = self.buf[:k], self.buf[k:]
        return out

    def peek(self) -> int:
        """The next pick, left in place."""
        if not self.buf:
            self.buf.extend(self.rng.permutation(self.n).tolist())
        return self.buf[0]


def optimization(mix: dict) -> OptimizationParams:
    """The program's optimiser settings from the mix's `optimization`
    group (every field of the published defaults that the mix states)."""
    names = {f.name for f in dataclasses.fields(OptimizationParams)}
    return OptimizationParams(**{k: v for k, v in mix["optimization"].items()
                                 if k in names})


def _norm(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The L2 norm of x's rows `rows` (a bool mask), as a 0-d float64
    device tensor (no host read)."""
    x = x.reshape(x.shape[0], -1).double()
    return torch.linalg.vector_norm(torch.where(rows[:, None], x, 0.0))


class Single:
    def __init__(self, cfg: dict, mix: dict, plot, seed: int, dev):
        self.mix, self.plot = mix, plot
        self.opt = optimization(mix)
        if not mix["densify"]:
            self.opt = dataclasses.replace(self.opt, densify_until_iter=0)
        state = G.create_from_pcd(plot.points, plot.colors, cfg["sh_degree"],
                                  device=dev)
        self.trainer = Trainer(state, self.opt, plot.extent,
                               sh_degree=cfg["sh_degree"],
                               config=RasterConfig(), seed=seed % (1 << 63))
        if mix["sh"] == "max":
            self.trainer.active_sh_degree = cfg["sh_degree"]
        self.views = ViewStream(plot.gt.shape[0], plot_seed(seed, 0))
        self.it = mix["first_iter"]
        self.end_events = {self.opt.iterations}

    def stacked(self) -> G.GaussianState:
        return G.map_tensors(lambda x: x[None], self.trainer.state)

    def peek_views(self) -> list:
        return [self.views.peek()]

    def sh_degree(self) -> int:
        return self.trainer.active_sh_degree

    def block_degree(self, k: int) -> int:
        """The SH degree the next block of k steps runs at (step and
        step_block raise it at a multiple of 1000)."""
        tr = self.trainer
        up = self.it % 1000 == 0 and tr.active_sh_degree < tr.max_sh_degree
        return tr.active_sh_degree + int(up)

    def _start(self) -> dict:
        """What the reference starts from and the gradient is read
        against: device copies of the leaves, Adam's moments and step, the
        screen-space statistic and the alive rows."""
        st = self.trainer.state
        return {"params": {k: v.clone() for k, v in
                           st.params.as_dict().items()},
                "m": {k: st.adam.mu[k].clone() for k in LEAVES},
                "v": {k: st.adam.nu[k].clone() for k in LEAVES},
                "t": int(st.adam.step), "stat": st.grad_accum.clone(),
                "alive": st.alive.clone()}

    def _readings(self, start: dict, losses: list, m1: dict, stat1,
                  params: dict) -> dict:
        """The record check.step_gaps reads, of one plot: each step's
        loss, each leaf's first gradient as Adam's first moment holds it
        ((m1 - b1 m0) / (1 - b1)) and the screen-space statistic's, and
        each leaf's change, as norms over the alive rows."""
        rows = start["alive"]
        grad = {k: _norm((m1[k] - B1 * start["m"][k]) / (1.0 - B1), rows)
                for k in LEAVES}
        grad["viewspace"] = _norm(stat1 - start["stat"], rows)
        change = {k: _norm(params[k] - start["params"][k], rows)
                  for k in LEAVES}
        return {"losses": losses, "grad": grad, "change": change}

    @staticmethod
    def to_host(rec: dict) -> dict:
        """A record's device numbers as host lists (one entry a plot)."""
        return {"losses": [[float(x)] for x in rec["losses"]],
                "grad": {k: [float(v)] for k, v in rec["grad"].items()},
                "change": {k: [float(v)] for k, v in rec["change"].items()},
                **{k: v for k, v in rec.items()
                   if k not in ("losses", "grad", "change")}}

    def first_steps(self, n: int) -> dict:
        """Run n steps one at a time through the window's call
        (Trainer.step_block) and keep what the reference is held against
        (`_readings`), the iterations and the views."""
        tr, p = self.trainer, self.plot
        start = self._start()
        rec = {"its": [], "views": [], "losses": []}
        for j in range(n):
            views = self.views.take(1)
            m = tr.step_block(self.it, views, p.cam_stack, p.gt, p.width,
                              p.height, n_steps=1)
            rec["its"].append(self.it)
            rec["views"].append(views)
            rec["losses"].append(m["loss"].clone())
            self.it += 1
            if j == 0:
                m1 = {k: tr.state.adam.mu[k].clone() for k in LEAVES}
                stat1 = tr.state.grad_accum.clone()
        params = {k: v.clone() for k, v in tr.state.params.as_dict().items()}
        rec.update(self._readings(start, rec["losses"], m1, stat1, params))
        return self.to_host(rec)

    def warm_up(self) -> None:
        """Run what the window will meet that the set-up's own iterations
        do not, on a copy of the state that is thrown away: a replayed
        block at each SH degree the window may reach, a densify with
        capacity growth and an opacity reset, so that kernels load and
        the allocator holds their memory before the window opens."""
        p, tr = self.plot, self.trainer
        copy = G.map_tensors(torch.clone, tr.state)
        spare = Trainer(copy, self.opt, p.extent,
                        sh_degree=tr.max_sh_degree, config=tr.config,
                        seed=0)
        views = list(range(min(2, p.gt.shape[0])))
        for deg in range(tr.active_sh_degree, tr.max_sh_degree + 1):
            spare.active_sh_degree = deg
            spare.step(self.it, tuple(a[0] for a in p.cam_stack), p.gt[0],
                       p.width, p.height)
            spare.step_block(self.it, views, p.cam_stack, p.gt, p.width,
                             p.height, n_steps=len(views))
        st, _ = G.densify_and_prune(spare.state, 0.0, 0.005, p.extent, 20.0,
                                    self.opt.percent_dense,
                                    generator=spare.generator)
        G.reset_opacity(G.grow_capacity(st, st.capacity + 32768))

    def next_len(self) -> int:
        blocks = self.mix["blocks"]
        if blocks == "block_len":
            return block_len(self.it, self.opt, self.end_events)
        return int(blocks)

    def _recorded_block(self, it: int, views: list, k: int, n: int) -> dict:
        """Trainer.step_block over the block, with its StepGraph's run
        split into its first n steps one at a time and then the rest (the
        same device work: a capture's first step is its eager warm-up
        either way, and the others replay), and the readings of those n
        steps taken between them on the device."""
        tr, p = self.trainer, self.plot
        start = self._start()
        graph = tr.graph
        run = graph.run
        losses, after = [], {}

        def split(step, k_, key, device):
            for j in range(min(n, k_)):
                run(step, 1, key, device)
                st = tr.state
                losses.append(tr._last["loss"].clone())
                if j == 0:
                    after["m1"] = {x: st.adam.mu[x].clone() for x in LEAVES}
                    after["stat1"] = st.grad_accum.clone()
            after["params"] = {x: v.clone() for x, v in
                               tr.state.params.as_dict().items()}
            if k_ > n:
                run(step, k_ - n, key, device)

        graph.run = split
        try:
            m = tr.step_block(it, views, p.cam_stack, p.gt, p.width,
                              p.height, n_steps=k)
        finally:
            del graph.run
        rec = self._readings(start, losses, after["m1"], after["stat1"],
                             after["params"])
        rec.update(its=list(range(it, it + n)), views=[[v] for v in
                                                       views[:n]],
                   start=start, degree=tr.active_sh_degree)
        return m, rec

    def run_block(self, record: int = 0):
        """Run the next block; with record = n > 0 and a block of n steps
        or more, also return the readings of its first n steps (else
        None)."""
        tr, p = self.trainer, self.plot
        k = self.next_len()
        it, views = self.it, self.views.take(k)
        captures = tr.graph.captures
        rec = None
        if k == 1:
            vi = views[0]
            m = tr.step(it, tuple(a[vi] for a in p.cam_stack), p.gt[vi],
                        p.width, p.height)
        elif record and k >= record:
            m, rec = self._recorded_block(it, views, k, record)
        else:
            m = tr.step_block(it, views, p.cam_stack, p.gt, p.width,
                              p.height, n_steps=k)
        last = it + k - 1
        self.it = last + 1
        densified = tr.last_densify is not None and tr.last_densify[0] == last
        # The CLI's host reads: its log line, and each densify's record.
        if last % LOG_EVERY == 0:
            [float(m[x]) for x in ("loss", "psnr", "n_alive",
                                   "entries_total")]
        if densified:
            [int(v) for v in tr.last_densify[1].values()]
            int(m["entries_total"])
        kind = ("densify" if densified else "single" if k == 1 else
                "recaptured" if tr.graph.captures > captures else "replayed")
        return k, kind, rec

    def captures(self) -> list:
        return list(self.trainer.graph.capture_seconds)

    def failed(self) -> int:
        """Overflows the trainer's watchdog caught: blocks in which a
        render asked for more entries than the budget (and dropped some)
        before the budget was raised."""
        return self.trainer.overflow_events

    def describe(self) -> str:
        tr = self.trainer
        return (f"iteration {self.it - 1}, alive {int(tr.state.num_alive)}, "
                f"capacity {tr.state.capacity}, entry budget "
                f"{tr.config.entry_budget}, SH {tr.active_sh_degree}, "
                f"overflow events {tr.overflow_events}")
