"""Parity of the port's morphology pipeline (wheat3dgs_tpu_torch.morphology
without sklearn, pandas, pydantic or yaml) with the JAX package's, which
calls them. The clusterers: tests/test_torch_morphology.py.

- SOR's kept masks exactly JAX's; the PCA's components within 1e-12 of
  sklearn's with the same signs (n = 20: full SVD; n = 1500: covariance
  eigensolver); compute_traits within 1e-9 relative, the volume exact.
- run_pipeline against JAX's on data_example as PLY (every cell equal, the
  boxes within 1e-12, the merged PLY equal) and as .txt (JAX parses with
  pandas, which is not correctly rounded: traits within 1e-9 relative),
  and on a 6000-point head subsampled to 5000 after np.random.seed beside
  a head that takes the global shift.
- load_config and the YAML subset against JAX's load_config and
  yaml.safe_load; each config JAX rejects, the port rejects; the reader
  raises outside its subset.
"""

import filecmp
import json
import os
import re
import shutil
import warnings
import zipfile

import numpy as np
import pytest
import torch
import yaml
from sklearn.decomposition import PCA

from test_torch_morphology import CLOUDS, EXAMPLE, REF_CLUSTER, ROOT, _example
from wheat3dgs_tpu.io.ply import read_ply, write_ply
from wheat3dgs_tpu.morphology import config as JC
from wheat3dgs_tpu.morphology import pcp_utils as JP
from wheat3dgs_tpu.morphology import run_pipeline as j_run
from wheat3dgs_tpu.morphology import traits as JT
from wheat3dgs_tpu_torch.morphology import config as TC
from wheat3dgs_tpu_torch.morphology import pcp_utils as TP
from wheat3dgs_tpu_torch.morphology import run_pipeline as t_run
from wheat3dgs_tpu_torch.morphology import traits as TT
from wheat3dgs_tpu_torch.morphology.bbox import extract_bounding_box

REF_CFG = {"file_format": "ply", "subsampling_threshold": 5000,
           "clusterer_definition": REF_CLUSTER,
           "sor_parameters": {"k": 200, "std_ratio": 3},
           "splines_smoothing_value": 1, "distance_percentile": 99,
           "get_bboxes": True, "get_processed_pcd": True}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cloud", ["example1", "example3", "blobs2200"])
def test_sor_keeps_what_jax_keeps(cloud):
    x = (_example(int(cloud[-1])) if cloud.startswith("example")
         else CLOUDS[cloud]())
    for k, ratio in ((200, 3), (20, 1.0)):
        jk, jd = JP.statistical_outlier_removal(x, k=k, std_ratio=ratio)
        tk, td = TP.statistical_outlier_removal(x, k=k, std_ratio=ratio,
                                                device="cpu")
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(td, jd)
    assert len(jd) > 0


@pytest.mark.parametrize("n", [20, 1500])
def test_pca_matches_sklearn(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 3)) @ rng.standard_normal((3, 3))
    sk = PCA(n_components=3).fit(x)
    got = TT.pca3(x)
    assert np.abs(got.components_ - sk.components_).max() <= 1e-12
    np.testing.assert_array_equal(np.sign(got.components_),
                                  np.sign(sk.components_))
    assert np.abs(got.mean_ - sk.mean_).max() <= 1e-12
    assert np.abs(got.transform(x) - sk.transform(x)).max() <= 1e-12
    box = extract_bounding_box(x, oriented=True)
    np.testing.assert_allclose(box["R"], sk.components_.T, rtol=0,
                               atol=1e-12)


def _synthetic_head(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-0.5, 0.5, n) * 0.2
    ang = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(0, 0.02, n)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang), t], axis=1)
    th = np.deg2rad(30.0)
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    return pts @ R.T + np.array([0.3, -0.2, 0.5])


@pytest.mark.parametrize("cloud", ["example2", "head2000", "head25"])
def test_compute_traits_matches_jax(cloud):
    x = (_example(2) if cloud == "example2"
         else _synthetic_head(n=int(cloud[4:]), seed=3))
    want = JT.compute_traits(x, 99, 1)
    got = TT.compute_traits(x, 99, 1)
    assert got[2] == want[2]                  # the hull volume, exactly
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


def _sheet(path):
    """The xlsx rows as lists of (type, text) cells."""
    xml = zipfile.ZipFile(path).read("xl/worksheets/sheet1.xml").decode()
    rows = []
    for row in re.findall(r"<row [^>]*>(.*?)</row>", xml):
        rows.append(re.findall(
            r'<c r="[A-Z]+\d+"( t="inlineStr")?>(?:<v>(.*?)</v>|'
            r"<is><t>(.*?)</t></is>)</c>", row))
    return rows


def _compare_outputs(jx, tx, rel):
    """xlsx cell by cell (X/Y/Z/ptnr/file_id exact, traits within rel;
    rel=None: every cell exact), boxes within 1e-12, merged PLY equal."""
    js, ts = _sheet(jx), _sheet(tx)
    assert len(js) == len(ts) > 1
    assert js[0] == ts[0]
    for jr, tr in zip(js[1:], ts[1:]):
        assert len(jr) == len(tr) == 10
        for c, (a, b) in enumerate(zip(jr, tr)):
            if rel is None or c in (3, 9):
                assert a == b, (c, a, b)
            else:
                assert a[0] == b[0] == "", (c, a, b)
                assert float(b[1]) == pytest.approx(float(a[1]), rel=rel,
                                                    abs=0), (c, a, b)
    jb = json.load(open(str(jx).replace("_traits.xlsx", "_bboxes.json")))
    tb = json.load(open(str(tx).replace("_traits.xlsx", "_bboxes.json")))
    assert list(jb) == list(tb)
    for k in jb:
        assert jb[k]["type"] == tb[k]["type"]
        for f in jb[k]:
            if f != "type":
                np.testing.assert_allclose(tb[k][f], jb[k][f], rtol=0,
                                           atol=1e-12)
    return filecmp.cmp(str(jx).replace("_traits.xlsx", "_pcd.ply"),
                       str(tx).replace("_traits.xlsx", "_pcd.ply"),
                       shallow=False)


def _both(tmp_path, data, fmt="ply", seed=None, **over):
    outs = []
    for name, run in (("jax", j_run), ("port", t_run)):
        out = tmp_path / name
        out.mkdir()
        cfg = dict(REF_CFG, data_folder=str(data), output_folder=str(out),
                   file_format=fmt, **over)
        if seed is not None:
            np.random.seed(seed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            outs.append(run(cfg) if name == "jax"
                        else run(cfg, device="cpu"))
    return outs


def test_run_pipeline_matches_jax_on_example_plys(tmp_path):
    jx, tx = _both(tmp_path, EXAMPLE)
    assert os.path.basename(tx).startswith("data_example_")
    assert _compare_outputs(jx, tx, rel=None)


def test_run_pipeline_matches_jax_on_example_txt(tmp_path):
    jx, tx = _both(tmp_path, EXAMPLE, fmt="txt")
    # The kept points agree; their coordinates are ~1 ulp apart.
    jp = read_ply(str(jx).replace("_traits.xlsx", "_pcd.ply"))
    tp = read_ply(str(tx).replace("_traits.xlsx", "_pcd.ply"))
    np.testing.assert_array_equal(tp["file_id"], jp["file_id"])
    for c in "xyz":
        np.testing.assert_allclose(tp[c], jp[c], rtol=1e-7, atol=0)
    _compare_outputs(jx, tx, rel=1e-9)


def test_run_pipeline_subsamples_like_jax(tmp_path):
    data = tmp_path / "heads"
    data.mkdir()
    pts = _synthetic_head(n=6000, seed=4).astype("<f4")
    write_ply(str(data / "0007.ply"),
              {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]})
    pts = _synthetic_head(n=900, seed=5).astype("<f4") + 20_000.0
    write_ply(str(data / "far.ply"),            # the global shift
              {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]})
    jx, tx = _both(tmp_path, data, seed=11)
    assert _compare_outputs(jx, tx, rel=None)
    rows = _sheet(tx)
    assert int(rows[1][3][1]) <= 5000
    assert rows[1][9][:2] == ("", "7")
    assert rows[2][9][0] == ' t="inlineStr"' and rows[2][9][2] == "far"


def _ref_yaml(tmp_path):
    src = os.path.join(ROOT, "wheatheadsmorphology", "config.yaml")
    shutil.copy(src, tmp_path / "config.yaml")
    (tmp_path / "data_example").mkdir()
    return tmp_path / "config.yaml"


GOOD_YAML = """
data_folder: "data/"
output_folder: "out/"
file_format: "ply"
subsampling_threshold: 5000
clusterer_definition:
  type: "hdbscan"
  min_samples: 15
  min_cluster_size: 250
  epsilon_hdbscan: 0.015
sor_parameters:
  k: 200
  std_ratio: 3
splines_smoothing_value: 1
distance_percentile: 99
get_bboxes: true
get_processed_pcd: true
"""


def test_load_config_matches_jax(tmp_path):
    (tmp_path / "data").mkdir()
    (tmp_path / "good.yaml").write_text(GOOD_YAML)
    for path in (_ref_yaml(tmp_path), tmp_path / "good.yaml"):
        text = path.read_text()
        assert TC.read_yaml_subset(text) == yaml.safe_load(text)
        j, t = JC.load_config(path), TC.load_config(path)
        for f in ("data_folder", "output_folder", "file_format",
                  "subsampling_threshold", "clusterer_definition",
                  "sor_parameters", "splines_smoothing_value",
                  "distance_percentile", "get_bboxes", "get_processed_pcd"):
            a, b = getattr(j, f), getattr(t, f)
            assert a == b and type(a) is type(b), f
        assert os.path.isdir(t.output_folder)


BAD = [("distance_percentile: 99", "distance_percentile: 150"),
       ("distance_percentile: 99", "distance_percentile: 0.5"),
       ('file_format: "ply"', 'file_format: "PLY"'),
       ("subsampling_threshold: 5000", "subsampling_threshold: 5000.0"),
       ("subsampling_threshold: 5000", "subsampling_threshold: true"),
       ("subsampling_threshold: 5000", 'subsampling_threshold: "5000"'),
       ('type: "hdbscan"', 'type: "kmeans"'),
       ('type: "hdbscan"', 'type: "dbscan"'),          # no epsilon
       ("min_cluster_size: 250", "min_cluster_size: 2.5e+2"),
       ("epsilon_hdbscan: 0.015", 'epsilon_hdbscan: "small"'),
       ("  min_samples: 15", "  min_samples: 15.0"),
       ("  k: 200", "  k: 20.5"),
       ("std_ratio: 3", 'std_ratio: "3"'),
       ('data_folder: "data/"', 'data_folder: "missing/"'),
       ("get_bboxes: true", "get_bboxes: 2"),
       ("splines_smoothing_value: 1", 'splines_smoothing_value: "stiff"'),
       ("get_processed_pcd: true\n", "")]


@pytest.mark.parametrize("old,new", BAD)
def test_port_rejects_what_jax_rejects(tmp_path, old, new):
    (tmp_path / "data").mkdir()
    assert old in GOOD_YAML
    p = tmp_path / "bad.yaml"
    p.write_text(GOOD_YAML.replace(old, new))
    assert TC.read_yaml_subset(p.read_text()) == yaml.safe_load(
        p.read_text())
    with pytest.raises(ValueError):
        JC.load_config(p)
    with pytest.raises(ValueError):
        TC.load_config(p)


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n  - 2\n",              # a list
    "a: &x 1\nb: *x\n",                # an anchor and an alias
    "a: {b: 1}\n",                     # flow style
    "a: [1, 2]\n",
    "a: yes\n",                        # YAML 1.1 booleans
    "a: 1e3\n",                        # a string to YAML, a float to many
    "a: |\n  text\n",                  # a block scalar
    "a:\n",                            # null
    "a: 1\na: 2\n",                    # a duplicate key
    "a: !!str 1\n",                    # a tag
    "a:\n\tb: 1\n",                    # a tab
])
def test_yaml_subset_raises_outside_it(text):
    with pytest.raises(ValueError):
        TC.read_yaml_subset(text)
