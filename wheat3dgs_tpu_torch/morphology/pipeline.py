"""Per-head trait extraction pipeline (reference:
wheatheadsmorphology/pipeline.py:35-191).

Counterpart of wheat3dgs_tpu/morphology/pipeline.py without pandas. Per
PLY/TXT head file: global shift (coordinates > 10km are shifted for float
stability) -> subsample to <=threshold points -> keep the dominant
DBSCAN/HDBSCAN cluster -> robust SOR -> traits (length, width, volume,
inclination, curvature) + optional obb/aabb json + merged inspection PLY.
Outputs an .xlsx traits table with the JAX package's columns, cell types
and file names. The clusterers' and SOR's distance work runs on `device`;
the trees, PCA, spline and hull on the host.
"""

from __future__ import annotations

import re
from datetime import datetime
from pathlib import Path

import numpy as np

from .. import resolve_device
from ..io.ply import read_ply, write_ply
from ..utils.xlsx import write_xlsx
from .bbox import extract_bounding_box, save_bounding_boxes
from .pcp_utils import (main_cluster_extraction, statistical_outlier_removal,
                        subsample_pcd)
from .traits import compute_traits

COLUMNS = ["X", "Y", "Z", "ptnr", "length", "width", "volume",
           "inclination", "curvature", "file_id"]


def _load_points(path: Path, file_format: str) -> np.ndarray:
    if file_format == "txt":
        # The JAX package parses with pandas' read_csv, which is not
        # correctly rounded: values may differ from these by an ulp.
        return np.loadtxt(path, skiprows=1, ndmin=2)[:, :3]
    if file_format == "ply":
        v = read_ply(str(path))
        return np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    raise SystemExit("file_format not supported; supported: txt, ply")


def run_pipeline(cfg, device="cuda", rng=None) -> Path:
    """cfg: MorphologyConfig or a plain dict with the same keys. `rng`: the
    np.random.RandomState the subsampling draws from (numpy's global state
    when None, as in the JAX package). Returns the traits .xlsx path."""
    dev = resolve_device(device)
    get = (lambda k: getattr(cfg, k)) if not isinstance(cfg, dict) else \
        cfg.__getitem__
    data_folder = Path(get("data_folder")).resolve()
    output_folder = Path(get("output_folder")).resolve()
    file_format = get("file_format")
    file_paths = sorted(data_folder.glob(f"*.{file_format}"))

    rows = []
    all_bboxes = {}
    kept_clouds, kept_ids = [], []

    for i, path in enumerate(file_paths):
        data = _load_points(path, file_format)

        # Global shift for float stability (reference :96-107).
        if np.any(data[0] > 10_000):
            shift = np.floor(data.mean(axis=0) / 10_000) * 10_000
            data = data - shift
        else:
            shift = np.zeros(3)

        data = subsample_pcd(data, get("subsampling_threshold"), rng=rng)
        data = main_cluster_extraction(data, get("clusterer_definition"),
                                       device=dev)
        sor = get("sor_parameters")
        if data.shape[0] > sor["k"]:
            data, _ = statistical_outlier_removal(
                data, k=sor["k"], std_ratio=sor["std_ratio"], device=dev)

        if get("get_bboxes"):
            all_bboxes[path.stem + "_obb"] = extract_bounding_box(
                data, oriented=True)
            all_bboxes[path.stem + "_aabb"] = extract_bounding_box(
                data, oriented=False)

        center = (data[:, :3].mean(axis=0) + shift).tolist()
        traits = compute_traits(data, get("distance_percentile"),
                                get("splines_smoothing_value"))
        rows.append(center + [data.shape[0]] + traits)

        if get("get_processed_pcd"):
            kept_clouds.append(data[:, :3])
            try:
                fid = int(path.stem)
            except ValueError:
                fid = i
            kept_ids.append(np.full(data.shape[0], fid, np.float32))

    for row, p in zip(rows, file_paths):
        row.append(int(p.stem) if re.fullmatch(r"\d+", p.stem) else p.stem)

    stamp = datetime.now().strftime("%d_%m_%Y_%H_%M_%S")
    parent = file_paths[0].parent.name if file_paths else "empty"
    xlsx_path = output_folder / f"{parent}_{stamp}_traits.xlsx"
    write_xlsx(str(xlsx_path), COLUMNS, rows)

    if get("get_bboxes"):
        save_bounding_boxes(
            all_bboxes, str(output_folder / f"{parent}_{stamp}_bboxes.json"))

    if get("get_processed_pcd") and kept_clouds:
        xyz = np.concatenate(kept_clouds).astype("<f4")
        ids = np.concatenate(kept_ids).astype("<f4")
        write_ply(str(output_folder / f"{parent}_{stamp}_pcd.ply"),
                  {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                   "file_id": ids})
    print(f"Done! Results saved to {xlsx_path}")
    return xlsx_path
