"""Host-driven 2D -> 3D instance segmentation (reference:
run_3d_seg.py:182-394, the paper's find-&-match algorithm).

Counterpart of wheat3dgs_tpu/seg/pipeline.py. The control flow is
sequential and data-dependent (which masks match depends on what was
lifted so far), so it stays on the host; the renders run on the device:
  - per-camera FlashSplat lifts of every mask of the view, 8 masks per
    render forward + backward (seg.flashsplat.lift_batch8), cached for the
    whole run;
  - the association step (seg.flashsplat.match_views_packed): alpha-only
    subset renders in every train view, thresholded, bit-packed and
    intersected with the device-resident packed SAM masks; only per-view
    scalars come back;
  - the per-head 2D projection (seg.flashsplat.predbits_views).
Subset renders run at a fraction of the scene's entry budget
(SegContext.seg_budget); a render whose demand exceeds it is rerun at
twice the demand, so nothing is cropped silently.

Artifacts mirror the reference tree under <model>/wheat-head/<exp>/:
ply/wh_*.ply, img/<id>/ overlays, count/<id>.pt, 2DSeg/<image>.pt,
results.csv, experiment.txt, gaussians.ply, and the resumable
loop_state.npz.
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import os
import random
import shutil
import string
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.gaussians import GaussianState
from ..models.serialization import save_ply
from ..render.pipeline import RasterConfig
from ..utils import image_ops
from . import flashsplat

def save_pt(obj: np.ndarray, path: str) -> None:
    """Reference artifacts are torch tensors (.pt)."""
    torch.save(torch.from_numpy(np.ascontiguousarray(obj)), path)


def load_pt(path: str) -> np.ndarray:
    return torch.load(path, weights_only=True).numpy()


def reset_label(instance_id: np.ndarray, obj_used_mask: np.ndarray,
                set_which_object_to: int, overlap_threshold: float = 0.8
                ) -> Tuple[np.ndarray, Optional[int]]:
    """Head-identity overlap resolution (reference GaussianModel.reset_label,
    scene/gaussian_model.py:465-506). Returns (new instance_id, overlap id
    or None)."""
    inst = instance_id.copy()
    sel = inst[obj_used_mask]
    nonzero = int(np.count_nonzero(sel))
    if nonzero > 0:
        total = int(np.count_nonzero(obj_used_mask))
        overlap_ratio = nonzero / total
        if overlap_ratio > overlap_threshold:
            vals, counts = np.unique(sel, return_counts=True)
            keep = vals != 0
            which = int(vals[keep][np.argmax(counts[keep])])
            old_mask = inst == which
            new_sum = obj_used_mask.sum()
            intersect = (obj_used_mask & old_mask).sum() / new_sum \
                if new_sum > 0 else 0.0
            if intersect < 0.6:
                inst[obj_used_mask] = set_which_object_to
                return inst, None
            inst[obj_used_mask] = which
            return inst, which
    inst[obj_used_mask] = set_which_object_to
    return inst, None


def find_new_mask_dir(img_dir: str, num_wheat_head: int) -> str:
    """Next letter suffix for a re-identified head (reference
    find_new_mask_dir, run_3d_seg.py:33-46)."""
    base = os.path.join(img_dir, f"{num_wheat_head:04d}")
    existing = set(glob.glob(base + "*"))
    if not existing:
        raise RuntimeError(f"no existing directory for {base}*")
    for letter in string.ascii_lowercase:
        if f"{base}_{letter}" not in existing:
            return letter
    raise RuntimeError("more than 26 overlaps for one head")


def _ceil128(x: int) -> int:
    return (x + 127) // 128 * 128


@dataclasses.dataclass
class SegContext:
    """Per-run data: the model, the stacked train cameras (tensors on the
    state's device), the masks and bboxes, the resolution and the config."""

    state: GaussianState
    cams: tuple                     # stacked (w2c, fp, cc, tfx, tfy)
    image_names: List[str]
    mask_paths: List[List[str]]     # per camera, sorted _000.png order
    bboxes: List[np.ndarray]        # per camera (M, 4) xyxy at load res
    width: int
    height: int
    config: RasterConfig
    images: Optional[np.ndarray] = None   # (B, 3, H, W) for overlay jpgs
    # Decoded masks, bit-packed (240 KB per 1600x1200 mask).
    mask_cache: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)
    # The packed SAM mask planes, (B, M_max, B8) uint8 on the host and on
    # the device, and their pixel areas (built by _ensure_device).
    mask_bits_np: Optional[np.ndarray] = None
    mask_bits_dev: Optional[torch.Tensor] = None
    mask_areas: Optional[np.ndarray] = None
    # FlashSplat counts, one batched lift per camera covering every
    # (initial and refinement) lift of the run.
    counts_own: Dict[tuple, np.ndarray] = dataclasses.field(
        default_factory=dict)             # (cam_i, k) -> (N,) f32
    counts_total: Dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)             # cam_i -> (N,) f32
    # Entry budget of the subset renders: full / 8 at first (a candidate
    # subset is ~100x smaller than the scene); a render whose demand
    # exceeds it reruns at twice the demand.
    seg_budget: int = 0

    def get_mask(self, path: str) -> np.ndarray:
        packed = self.mask_cache.get(path)
        if packed is None:
            m = image_ops.read_mask(path, (self.width, self.height))
            self.mask_cache[path] = np.packbits(m, axis=None)
            return m
        n = self.height * self.width
        return np.unpackbits(packed, count=n).astype(bool).reshape(
            self.height, self.width)

    def _ensure_device(self) -> None:
        if self.mask_bits_np is not None:
            return
        b8 = -(-self.width * self.height // 8)
        n_cam = len(self.image_names)
        m_max = max(1, max(len(p) for p in self.mask_paths))
        bits = np.zeros((n_cam, m_max, b8), np.uint8)
        areas = np.zeros((n_cam, m_max), np.int64)
        for ci, paths in enumerate(self.mask_paths):
            for k, p in enumerate(paths):
                m = self.get_mask(p)
                bits[ci, k] = self.mask_cache[p]
                areas[ci, k] = int(m.sum())
        self.mask_bits_np = bits
        self.mask_areas = areas
        self.mask_bits_dev = torch.as_tensor(bits, device=self.state.device)
        if self.seg_budget == 0:
            full = self.config.entry_budget or 16 * self.state.capacity
            self.seg_budget = max(2048, _ceil128(full // 8))

    def _seg_config(self) -> RasterConfig:
        """The subset renders' config: the subset budget on "pallas"; an
        "xla" config unchanged (its tile fields size it)."""
        if self.config.backend != "pallas":
            return self.config
        return dataclasses.replace(self.config, entry_budget=self.seg_budget)

    def cached_counts(self, cam_i: int, path: str) -> np.ndarray:
        """(2, N) FlashSplat counts [background, mask] of one (view, mask)
        from the per-view lift cache (filled on first touch of the
        camera)."""
        self._ensure_device()
        k = self.mask_paths[cam_i].index(path)
        if cam_i not in self.counts_total:
            self._lift_camera(cam_i)
        own = self.counts_own[(cam_i, k)]
        return np.stack([self.counts_total[cam_i] - own, own])

    def _lift_camera(self, cam_i: int) -> None:
        m = len(self.mask_paths[cam_i])
        b8 = self.mask_bits_np.shape[-1]
        # Rows: the view's M masks and one all-ones mask (the total weight,
        # which closes the background channel: bg = total - own).
        ones_bits = np.packbits(np.ones(self.width * self.height, bool),
                                axis=None)
        rows = [self.mask_bits_np[cam_i, k] for k in range(m)]
        rows.append(ones_bits[:b8])
        rows += [np.zeros(b8, np.uint8)] * ((-len(rows)) % 8)
        cam = _cam_slice(self.cams, cam_i)
        dev = self.state.device
        outs = [flashsplat.lift_batch8(
            self.state, *cam, torch.as_tensor(np.stack(rows[b0:b0 + 8]),
                                              device=dev),
            width=self.width, height=self.height, config=self.config)
            for b0 in range(0, len(rows), 8)]
        allrows = torch.cat(outs, dim=0).cpu().numpy()
        self.counts_total[cam_i] = allrows[m]
        for k in range(m):
            self.counts_own[(cam_i, k)] = allrows[k]

    def match_device(self, counts: np.ndarray):
        """used_mask and per-view (inter, pred_area, bbox) from one
        association step; on "pallas" reruns at a larger subset budget on
        overflow."""
        self._ensure_device()
        while True:
            used, inter, area, bbox, entries = flashsplat.match_views_packed(
                self.state, *self.cams, counts, self.mask_bits_dev,
                width=self.width, height=self.height,
                config=self._seg_config())
            entries = int(entries)
            if self.config.backend != "pallas" or entries <= self.seg_budget:
                return (used.cpu().numpy(), inter.cpu().numpy(),
                        area.cpu().numpy(), bbox.cpu().numpy())
            self.seg_budget = _ceil128(entries * 2)

    def predbits_device(self, used_mask: np.ndarray,
                        cams: Optional[tuple] = None) -> np.ndarray:
        """(B, H, W) bool pred-seg of the subset in every view (the train
        views by default, or an explicit stacked camera batch)."""
        self._ensure_device()
        cam_stack = cams if cams is not None else self.cams
        while True:
            bits, entries = flashsplat.predbits_views(
                self.state, *cam_stack, used_mask, width=self.width,
                height=self.height, config=self._seg_config())
            entries = int(entries)
            if self.config.backend != "pallas" or entries <= self.seg_budget:
                bits = bits.cpu().numpy()
                n = self.height * self.width
                return np.unpackbits(
                    bits, axis=-1, count=n).astype(bool).reshape(
                        bits.shape[0], self.height, self.width)
            self.seg_budget = _ceil128(entries * 2)


def _cam_slice(cams, idx):
    return tuple(c[idx] for c in cams)


def lift_counts(ctx: SegContext, cam_idx: int, mask_path: str,
                pts_filter: Optional[np.ndarray] = None) -> np.ndarray:
    """opt_label_w_seg for one (view, mask) pair (run_3d_seg.py:74-105):
    (2, N) counts [background, mask]."""
    mask = ctx.get_mask(mask_path)
    out = flashsplat.lift_view(
        ctx.state, *_cam_slice(ctx.cams, cam_idx),
        torch.as_tensor(mask.astype(np.int32)), num_obj=1, width=ctx.width,
        height=ctx.height, config=ctx.config, with_contrib=False)
    counts = out.used_count.cpu().numpy()
    if pts_filter is not None:
        counts[1:, pts_filter] = 0.0
    return counts


def counts_to_used_mask(counts: np.ndarray, slackness: float = 0.0
                        ) -> np.ndarray:
    """counts -> boolean membership of object 1 (run_3d_seg.py:107-114)."""
    labels = flashsplat.multi_instance_opt(torch.as_tensor(counts),
                                           slackness)
    return labels[1].numpy()


def alpha_all_views(ctx: SegContext, used_mask: np.ndarray) -> np.ndarray:
    """(n_train, H, W) alpha of the used_mask subset in every train view,
    at the scene's entry budget."""
    return flashsplat.alpha_views(
        ctx.state, *ctx.cams, used_mask, width=ctx.width,
        height=ctx.height, config=ctx.config).cpu().numpy()


def find_match_device(ctx: SegContext, candidate_idxs: Sequence[int],
                      counts: np.ndarray, iou_threshold: float
                      ) -> Tuple[np.ndarray, List[int], List[str]]:
    """Device-side find_match (reference find_match, run_3d_seg.py:116-172):
    one association step renders the candidate subset in every train view
    and intersects it with the packed SAM masks; the host finishes the bbox
    gate and the IoU argmax from the per-view scalars. Returns (used_mask,
    matched cam indices, matched mask paths), as find_match() on the
    rendered alphas."""
    used, inter, area, bbox = ctx.match_device(counts)
    matched_idx, matched_paths = [], []
    for cam_i in candidate_idxs:
        if area[cam_i] == 0:
            continue
        pred_bbox = tuple(bbox[cam_i].tolist())
        boxes = ctx.bboxes[cam_i]
        n_masks = len(ctx.mask_paths[cam_i])
        best_iou, best_k = iou_threshold, -1
        for k in range(min(len(boxes), n_masks)):
            if not image_ops.is_overlapping(pred_bbox,
                                            tuple(boxes[k].tolist())):
                continue
            union = ctx.mask_areas[cam_i, k] + area[cam_i] \
                - inter[cam_i, k]
            iou = inter[cam_i, k] / union if union > 0 else 0.0
            if iou > best_iou:
                best_iou, best_k = iou, k
        if best_k >= 0:
            matched_idx.append(cam_i)
            matched_paths.append(ctx.mask_paths[cam_i][best_k])
    return used, matched_idx, matched_paths


def find_match(ctx: SegContext, candidate_idxs: Sequence[int],
               used_mask: np.ndarray, iou_threshold: float,
               alphas: Optional[np.ndarray] = None
               ) -> Tuple[List[int], List[str], np.ndarray]:
    """Host-side matching on the rendered alphas (reference find_match,
    run_3d_seg.py:116-172): bbox overlap and seg-IoU over the candidate
    views. Returns (matched cams, matched mask paths, all-view alphas)."""
    if len(candidate_idxs) == 0:
        return [], [], alphas
    if alphas is None:
        alphas = alpha_all_views(ctx, used_mask)
    matched_idx, matched_paths = [], []
    for cam_i in candidate_idxs:
        pred_seg = alphas[cam_i] > 0.5
        pred_bbox = image_ops.get_bbox_from_mask(pred_seg)
        boxes = ctx.bboxes[cam_i]
        overlap = [k for k in range(len(boxes))
                   if image_ops.is_overlapping(pred_bbox,
                                               tuple(boxes[k].tolist()))]
        best_iou, best_path = 0.0, None
        for k in overlap:
            if k >= len(ctx.mask_paths[cam_i]):
                continue
            path = ctx.mask_paths[cam_i][k]
            iou = image_ops.calculate_seg_iou(ctx.get_mask(path), pred_seg)
            if iou > best_iou:
                best_iou, best_path = iou, path
        if best_iou > iou_threshold:
            matched_idx.append(cam_i)
            matched_paths.append(best_path)
    return matched_idx, matched_paths, alphas


def run_segmentation(ctx: SegContext, out_dir: str, exp_name: str,
                     iou_threshold: float = 0.6, seed: int = 0,
                     eval_names: Sequence[str] = (),
                     eval_cams: Optional[tuple] = None,
                     max_refine_rounds: int = 99,
                     verbose: bool = True, resume: bool = True,
                     _stop_after_masks: Optional[int] = None) -> Dict:
    """The find-&-match loop (reference training(), run_3d_seg.py:182).

    Returns a summary dict and writes the reference artifact tree. Each
    head runs at most max_refine_rounds rounds of lift, re-match after its
    first match (the reference loops until nothing new matches; the
    default only bounds a pathological run). The loop state (instance labels, processed-mask set, head
    counter, position in the shuffled mask order) checkpoints beside the
    periodic 2DSeg-map saves; with resume, a rerun into the same artifact
    dir picks up from the last checkpoint, and without it starts afresh.
    `_stop_after_masks` stops after that many masks at a consistent
    checkpoint (a test hook for the resume path)."""
    log = print if verbose else (lambda *a, **k: None)
    dev = ctx.state.device
    base = os.path.join(out_dir, "wheat-head", exp_name)
    ply_dir = os.path.join(base, "ply")
    img_dir = os.path.join(base, "img")
    count_dir = os.path.join(base, "count")
    seg_dir = os.path.join(base, "2DSeg")
    for d in (ply_dir, img_dir, count_dir, seg_dir):
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(base, "experiment.txt"), "w") as f:
        f.write(f"exp_name {exp_name}\niou_threshold {iou_threshold}\n")
    loop_ckpt = os.path.join(base, "loop_state.npz")
    ck = None
    if resume and os.path.exists(loop_ckpt):
        ck = dict(np.load(loop_ckpt, allow_pickle=False))
        log(f"==== resuming at mask {int(ck['next_exp_id'])} "
            f"({int(ck['num_wheat_head'])} heads so far) ====")
    results_f = open(os.path.join(base, "results.csv"),
                     "a" if ck is not None else "w", newline="")
    writer = csv.writer(results_f)
    if ck is None:
        writer.writerow(["id", "init_mask", "num_matches", "num_GS"])

    state = ctx.state
    inst = (ck["inst"].copy() if ck is not None
            else state.instance_id.cpu().numpy().copy())
    if ck is not None:
        state = dataclasses.replace(state,
                                    instance_id=torch.as_tensor(inst,
                                                                device=dev))
    means_z = state.params.means[:, 2].cpu().numpy()
    alive = state.alive.cpu().numpy()
    z_mean = means_z[alive].mean()
    pts_filter = means_z < z_mean            # below-canopy (run_3d_seg.py:207)
    pts_filter |= ~alive

    # 2DSeg maps for train + eval views (run_3d_seg.py:218-235); on resume,
    # the checkpointed maps (saved with the loop state).
    seg_maps: Dict[str, np.ndarray] = {}
    for name in list(ctx.image_names) + list(eval_names):
        pt_path = os.path.join(seg_dir, f"{name}.pt")
        if ck is not None and os.path.exists(pt_path):
            seg_maps[name] = load_pt(pt_path).astype(np.int32)
        else:
            seg_maps[name] = np.zeros((ctx.height, ctx.width), np.int32)
            save_pt(seg_maps[name], pt_path)

    all_masks = [(ci, p) for ci in range(len(ctx.image_names))
                 for p in ctx.mask_paths[ci]]
    rnd = random.Random(seed)
    rnd.shuffle(all_masks)
    processed, buffered = set(), set()
    num_wheat_head = 0
    start_exp_id = 0
    if ck is not None:
        processed = set(str(s) for s in ck["processed"])
        buffered = set(str(s) for s in ck["buffered"])
        num_wheat_head = int(ck["num_wheat_head"])
        start_exp_id = int(ck["next_exp_id"])

    def mask_name(p):
        return os.path.splitext(os.path.basename(p))[0]

    def save_loop_state(next_exp_id: int) -> None:
        tmp = loop_ckpt + ".tmp.npz"    # .npz suffix: savez appends otherwise
        np.savez(tmp, inst=inst, num_wheat_head=num_wheat_head,
                 next_exp_id=next_exp_id,
                 processed=np.array(sorted(processed), dtype="U64"),
                 buffered=np.array(sorted(buffered), dtype="U64"))
        os.replace(tmp, loop_ckpt)

    for exp_id, (cam_i, path) in enumerate(all_masks):
        if exp_id < start_exp_id:
            continue
        if _stop_after_masks is not None and exp_id >= _stop_after_masks:
            for vname, m in seg_maps.items():
                save_pt(m, os.path.join(seg_dir, f"{vname}.pt"))
            results_f.flush()
            save_loop_state(exp_id)
            results_f.close()
            return {"num_heads": num_wheat_head, "state": state,
                    "seg_maps": seg_maps, "out_dir": base,
                    "interrupted_at": exp_id}
        name = mask_name(path)
        if name in processed:
            continue
        if name in buffered:
            buffered.remove(name)
            processed.add(name)
        log(f"==== lifting {name} ====")

        counts = ctx.cached_counts(cam_i, path)
        counts[1:, pts_filter] = 0.0

        matched = [cam_i]
        matched_paths = [path]
        candidates = [i for i in range(len(ctx.image_names)) if i != cam_i]
        used_mask, new_idx, new_paths = find_match_device(
            ctx, candidates, counts, iou_threshold)
        if used_mask.sum() == 0:
            log(f"no above-canopy Gaussians for {name}; pass")
            continue
        matched += new_idx
        matched_paths += new_paths
        processed.update(mask_name(p) for p in new_paths)

        if not new_idx:
            log(f"no matches for {name}; buffered")
            if name not in processed:
                buffered.add(name)
            continue

        num_wheat_head += 1
        this_img_dir = os.path.join(img_dir, f"{num_wheat_head:04d}")
        os.makedirs(this_img_dir, exist_ok=True)
        processed.add(name)

        # Refinement: lift the newly matched masks, re-optimise, re-match
        # (run_3d_seg.py:297-323).
        for _ in range(1, max_refine_rounds + 1):
            for ci, p in zip(new_idx, new_paths):
                counts += ctx.cached_counts(ci, p)
            counts[1:, pts_filter] = 0.0
            seen = set(matched)
            candidates = [i for i in range(len(ctx.image_names))
                          if i not in seen]
            used_mask, new_idx, new_paths = find_match_device(
                ctx, candidates, counts, iou_threshold)
            if not new_idx:
                break
            matched += new_idx
            matched_paths += new_paths
            processed.update(mask_name(p) for p in new_paths)

        # Overlap resolution against the heads found before.
        inst, which_overlap = reset_label(inst, used_mask, num_wheat_head)
        state = dataclasses.replace(state,
                                    instance_id=torch.as_tensor(inst,
                                                                device=dev))
        if which_overlap is not None:
            num_wheat_head -= 1
            shutil.rmtree(this_img_dir, ignore_errors=True)
            which = which_overlap
            letter = find_new_mask_dir(img_dir, which)
            head_id = f"{which:04d}_{letter}"
            this_img_dir = os.path.join(img_dir, head_id)
            os.makedirs(this_img_dir, exist_ok=True)
        else:
            which = num_wheat_head
            head_id = f"{which:04d}"
        ply_path = os.path.join(ply_dir, f"wh_{head_id}.ply")
        log(f"==== head {head_id}: {len(matched)} matched views ====")

        head_mask = inst == which
        n_gs = int(head_mask.sum())
        head_state = dataclasses.replace(
            state, alive=torch.as_tensor(head_mask & alive, device=dev))
        save_ply(head_state, ply_path)
        writer.writerow([head_id, name, str(len(matched)), str(n_gs)])
        results_f.flush()
        save_pt(counts, os.path.join(count_dir, f"{which:04d}.pt"))

        # Project back to 2D: per-view seg maps and overlays
        # (run_3d_seg.py:351-377), from packed prediction bits.
        views = list(zip(ctx.image_names, ctx.predbits_device(used_mask)))
        if eval_cams is not None and len(eval_names):
            views += list(zip(eval_names, ctx.predbits_device(
                used_mask, cams=eval_cams)))
        for vi_, (vname, pred_seg) in enumerate(views):
            seg_maps[vname][pred_seg] = which
            # Inspection overlays (reference vis_image_w_overlay,
            # run_3d_seg.py:364-372).
            if ctx.images is not None and vi_ < len(ctx.images):
                image_ops.save_overlay(
                    ctx.images[vi_], pred_seg,
                    os.path.join(this_img_dir, f"{vname}.jpg"),
                    resize_factor=4)

        # The maps are cumulative in memory; checkpoint them with the loop
        # state every 10 heads and write the final state once at the end
        # (the reference re-saves every map after every head).
        if num_wheat_head % 10 == 0:
            for vname, m in seg_maps.items():
                save_pt(m, os.path.join(seg_dir, f"{vname}.pt"))
            results_f.flush()
            save_loop_state(exp_id + 1)
        if exp_id % 5 == 0:
            save_ply(state, os.path.join(base, "gaussians.ply"))

    for vname, m in seg_maps.items():
        save_pt(m, os.path.join(seg_dir, f"{vname}.pt"))
    save_loop_state(len(all_masks))
    save_ply(state, os.path.join(base, "gaussians.ply"))
    results_f.close()
    return {"num_heads": num_wheat_head, "state": state,
            "seg_maps": seg_maps, "out_dir": base}
