"""Wheat-head morphology / phenotyping (reference: wheatheadsmorphology/).

Counterpart of wheat3dgs_tpu/morphology without sklearn, pandas, pydantic
or yaml: per-head point clouds -> structural traits (length, width,
volume, curvature, inclination) + bounding boxes + inspection PLY.
HDBSCAN, DBSCAN and the k-NN distances are ports of sklearn 1.9.0's
(`cluster.py`, same labels), their distance work on the caller's device;
PCA follows sklearn's solver and signs in numpy (`traits.pca3`)."""

from .pipeline import run_pipeline  # noqa: F401
from .traits import compute_traits  # noqa: F401
from .pcp_utils import (main_cluster_extraction,  # noqa: F401
                        statistical_outlier_removal, subsample_pcd)
from .bbox import (extract_bounding_box, load_bounding_boxes,  # noqa: F401
                   points_in_bbox, save_bounding_boxes)
from .config import MorphologyConfig, load_config  # noqa: F401
