"""The port's paths on the padded-tile backend (RasterConfig(backend=
"xla")) against the JAX package's on its XLA backend, on the CPU.

The same seeded numpy Gaussians and cameras go to both packages (JAX's
fixtures `random_gaussians` / `look_at_camera`; the port's states from
`state_from_numpy`), at JAX's test configs: max_tiles_per_gauss=8,
max_per_tile=16, tile_batch=4 (tests/test_seg.py:290), which crops, and
max_tiles_per_gauss=8, max_per_tile=64, tile_batch=12
(tests/test_parallel.py:35). Bounds:
- the lifts (lift_mask with JAX's tile keywords, lift_view, lift_batch8):
  used_count within 1e-5 of its max, alpha within 2e-5, contrib_num
  equal or one apart on at most 0.1% of the pixels (the count printed);
- eval_obj_labels with head_batch=2: JAX's head map exactly;
- the seg pipeline's device association (find_match_device, whose
  overflow retry runs only on "pallas"): JAX's picks exactly;
- occupancy_probe and the (max_per_tile, max_tiles_per_gauss) rungs that
  Trainer._refresh_occupancy picks: JAX's exactly, before a densify and
  after one (JAX's densified state carried over with state_from_numpy);
- one train_step and one multi_plot_step as tests/test_torch_training.py
  and tests/test_torch_parallel.py hold the entry stream: the loss within
  rel 1e-4, Adam moments and grad_accum within 2% of each field's max;
  entries_total is -1, the Trainer's watchdog never fires and its blocks
  report -1;
- the viewer and the 360 orbit use an "xla" config as given (no probe,
  no overflow re-render).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parallel import _hold_to_jax, _j, _plots, _row, _t
from test_torch_seg import H as SH
from test_torch_seg import W as SW
from test_torch_seg import _cams as seg_cams
from test_torch_seg import _jcams, _states, _tcams
from test_torch_training import H, W, _cams, _port_state, _scene
from wheat3dgs_tpu import training as JT
from wheat3dgs_tpu.config import OptimizationParams as JOpt
from wheat3dgs_tpu.models import gaussians as JG
from wheat3dgs_tpu.ops import mask_lift as JM
from wheat3dgs_tpu.parallel import mesh as JMesh
from wheat3dgs_tpu.render.pipeline import RasterConfig as JConfig
from wheat3dgs_tpu.seg import eval as JE
from wheat3dgs_tpu.seg import flashsplat as JF
from wheat3dgs_tpu.seg import pipeline as JS
from wheat3dgs_tpu_torch import training as TT
from wheat3dgs_tpu_torch.config import OptimizationParams as TOpt
from wheat3dgs_tpu_torch.models import gaussians as TG
from wheat3dgs_tpu_torch.ops import mask_lift as TM
from wheat3dgs_tpu_torch.ops.projection import Splats2D
from wheat3dgs_tpu_torch.parallel import mesh as TMesh
from wheat3dgs_tpu_torch.render.pipeline import RasterConfig as TConfig
from wheat3dgs_tpu_torch.seg import eval as TE
from wheat3dgs_tpu_torch.seg import flashsplat as TF
from wheat3dgs_tpu_torch.seg import pipeline as TS

CROP = dict(max_tiles_per_gauss=8, max_per_tile=16, tile_batch=4)
PARALLEL = dict(max_tiles_per_gauss=8, max_per_tile=64, tile_batch=12)
BG = np.array([0.1, 0.2, 0.3], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: tiny tensors on a host shared by parallel
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(fields):
    return JConfig(backend="xla", **fields), TConfig(backend="xla", **fields)


def _hold_lift(got, want, what):
    """used_count within 1e-5 of its max, alpha within 2e-5, contrib_num
    equal or one apart on at most 0.1% of the pixels."""
    u_want = np.asarray(want.used_count)
    scale = np.abs(u_want).max()
    assert scale > 0, what
    np.testing.assert_allclose(got.used_count.numpy(), u_want,
                               atol=1e-5 * scale, rtol=0, err_msg=what)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               atol=2e-5, rtol=0, err_msg=what)
    diff = np.abs(got.contrib_num.numpy().astype(np.int64)
                  - np.asarray(want.contrib_num).astype(np.int64))
    off = int((diff > 0).sum())
    print(f"{what}: contrib_num off on {off} of {diff.size} pixels")
    assert diff.max() <= 1 and off <= 1e-3 * diff.size, what


@pytest.mark.parametrize("fields", [CROP, dict(tile=32, **PARALLEL)])
@pytest.mark.parametrize("labels", [3, 11])
def test_lift_view_and_lift_mask_match_jax(fields, labels):
    jstate, tstate = _states(n=60, seed=11)
    cams = seg_cams()
    jconf, tconf = _configs(fields)
    rng = np.random.default_rng(labels)
    gt = rng.integers(0, labels, size=(SH, SW)).astype(np.int32)
    gt[:, :10] = labels - 1
    ref = JF.lift_view(jstate, *_jcams(cams, 0), jnp.asarray(gt),
                       num_obj=labels - 1, width=SW, height=SH,
                       config=jconf)
    out = TF.lift_view(tstate, *_tcams(cams, 0), torch.from_numpy(gt),
                       num_obj=labels - 1, width=SW, height=SH,
                       config=tconf)
    assert out.used_count.shape == (labels, tstate.capacity)
    _hold_lift(out, ref, f"lift_view {fields} {labels}")
    # lift_mask with JAX's keywords on the same projected splats.
    splats = JF._project(jstate, *_jcams(cams, 0), SW, SH)
    tsplats = Splats2D(*(torch.tensor(np.asarray(x)) for x in splats))
    kw = {k: v for k, v in fields.items()}
    want = JM.lift_mask(splats, jnp.asarray(gt), labels - 1, SW, SH, **kw)
    got = TM.lift_mask(tsplats, torch.from_numpy(gt), labels - 1, SW, SH,
                       **kw)
    _hold_lift(got, want, f"lift_mask {fields} {labels}")
    with pytest.raises(ValueError, match="entry_budget"):
        TM.lift_mask(tsplats, torch.from_numpy(gt), labels - 1, SW, SH,
                     tile=16, entry_budget=4096)


def test_lift_batch8_matches_jax_on_xla():
    jstate, tstate = _states()
    cams = seg_cams()
    jconf, tconf = _configs(CROP)
    rng = np.random.default_rng(3)
    masks = rng.random((8, SH, SW)) < 0.3
    masks[7] = True
    bits8 = np.stack([np.packbits(m, axis=None) for m in masks])
    want = np.asarray(JF.lift_batch8(jstate, *_jcams(cams, 0),
                                     jnp.asarray(bits8), width=SW, height=SH,
                                     config=jconf))
    got = TF.lift_batch8(tstate, *_tcams(cams, 0), torch.from_numpy(bits8),
                         width=SW, height=SH, config=tconf).numpy()
    assert got.shape == (8, tstate.capacity)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


def test_eval_obj_labels_matches_jax_on_xla():
    jstate, tstate = _states(n=60, seed=7)
    cams = seg_cams()
    jconf, tconf = _configs(PARALLEL)
    rng = np.random.default_rng(2)
    labels = np.zeros((5, tstate.capacity), bool)
    owner = rng.integers(0, 5, size=60)
    labels[owner, np.arange(60)] = True
    labels[3] = False                       # an empty head row
    want = np.asarray(JE.eval_obj_labels(
        jstate, jnp.asarray(labels), *_jcams(cams, 0), width=SW, height=SH,
        config=jconf, head_batch=2))
    got = TE.eval_obj_labels(tstate, torch.from_numpy(labels),
                             *_tcams(cams, 0), width=SW, height=SH,
                             config=tconf, head_batch=2).numpy()
    assert len(np.unique(got)) >= 3
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="head_batch"):
        TE.eval_obj_labels(tstate, torch.from_numpy(labels),
                           *_tcams(cams, 0), width=SW, height=SH,
                           config=tconf, head_batch=0)


def test_find_match_device_matches_jax_on_xla(tmp_path):
    """The association step on "xla": JAX's picks, the subset config
    passed through unchanged and no overflow retry (entries -1)."""
    from PIL import Image

    jstate, tstate = _states()
    cams = seg_cams(((0.0, 0.0, -4.0), (0.6, -0.3, -3.8),
                     (-0.5, 0.4, -4.1)))
    jconf, tconf = _configs(CROP)
    used = np.zeros(tstate.capacity, bool)
    used[:30] = True
    alphas = TF.alpha_views(tstate, *_tcams(cams), torch.from_numpy(used),
                            width=SW, height=SH, config=tconf).numpy()
    j_alphas = np.asarray(JF.alpha_views(jstate, *_jcams(cams),
                                         jnp.asarray(used), width=SW,
                                         height=SH, config=jconf))
    np.testing.assert_allclose(alphas, j_alphas, atol=2e-5)
    rng = np.random.default_rng(8)
    mask_paths, bboxes = [], []
    for v in range(3):
        pred = alphas[v] > 0.5
        noisy = [pred ^ (rng.random(pred.shape) < p) & pred
                 for p in (0.05, 0.6)] + [rng.random(pred.shape) < 0.2]
        paths, boxes = [], []
        for k, m in enumerate(noisy):
            path = str(tmp_path / f"v{v}_{k:03d}.png")
            Image.fromarray((m * 255).astype(np.uint8), mode="L").save(path)
            paths.append(path)
            boxes.append(TS.image_ops.get_bbox_from_mask(m))
        mask_paths.append(paths)
        bboxes.append(np.asarray(boxes, np.float32))
    common = dict(image_names=["a", "b", "c"], mask_paths=mask_paths,
                  bboxes=bboxes, width=SW, height=SH)
    tctx = TS.SegContext(state=tstate, cams=_tcams(cams), config=tconf,
                         **common)
    jctx = JS.SegContext(state=jstate, cams=_jcams(cams), config=jconf,
                         **common)
    counts = np.stack([(~used).astype(np.float32), used.astype(np.float32)])
    t_used, t_idx, t_paths = TS.find_match_device(tctx, [0, 1, 2], counts,
                                                  0.6)
    j_used, j_idx, j_paths = JS.find_match_device(jctx, [0, 1, 2], counts,
                                                  0.6)
    np.testing.assert_array_equal(t_used, j_used)
    assert t_idx == j_idx and t_paths == j_paths and len(t_idx) > 0
    assert tctx._seg_config() == tconf
    _, _, _, _, entries = TF.match_views_packed(
        tstate, *_tcams(cams), counts, tctx.mask_bits_dev, width=SW,
        height=SH, config=tconf)
    assert int(entries) == -1
    bits = tctx.predbits_device(used)
    np.testing.assert_array_equal(bits, alphas > 0.5)
    # The per-camera lift cache against JAX's on "xla".
    np.testing.assert_allclose(
        tctx.cached_counts(1, mask_paths[1][0]),
        jctx.cached_counts(1, mask_paths[1][0]),
        atol=1e-5 * float(np.abs(jctx.cached_counts(
            1, mask_paths[1][0])).max()), rtol=0)


def _densified(jst):
    """JAX's state after one densify (a stored statistic over its
    threshold on every other splat)."""
    n = jst.capacity
    hot = (np.arange(n) % 2 == 0) & np.asarray(jst.alive)
    jst = dataclasses.replace(
        jst, grad_accum=jnp.asarray(np.where(hot, 1.0, 0.0), jnp.float32),
        denom=jnp.asarray(np.where(hot, 1.0, 0.0), jnp.float32))
    new, info = JG.densify_and_prune(jst, jax.random.PRNGKey(3), 2e-4, 0.005,
                                     1.0, 0.0, 0.01)
    assert int(info["n_clone"]) + int(info["n_split"]) > 0
    return new


def test_occupancy_probe_and_rungs_match_jax():
    cam, jst, _ = _scene(n=40, cap=128)
    jcam, tcam = _cams(cam)
    for st in (jst, _densified(jst)):
        tst = _port_state(st)
        for tile, mtpg in ((16, 16), (8, 4)):
            want = JT.occupancy_probe(st, *jcam, width=W, height=H,
                                      tile=tile, mtpg=mtpg)
            got = TT.occupancy_probe(tst, *tcam, width=W, height=H,
                                     tile=tile, mtpg=mtpg)
            assert [int(x) for x in got] == [int(x) for x in want]
        for conf in ((16, 16), (8, 4)):
            jtr = JT.Trainer(st, JOpt(), 1.0, sh_degree=1, config=JConfig(
                tile=conf[0], max_tiles_per_gauss=conf[1]))
            ttr = TT.Trainer(tst, TOpt(), 1.0, sh_degree=1,
                             config=TConfig(backend="xla", tile=conf[0],
                                            max_tiles_per_gauss=conf[1]))
            jtr._refresh_occupancy(jcam, W, H)
            ttr._refresh_occupancy(tcam, W, H)
            assert (ttr.config.max_per_tile,
                    ttr.config.max_tiles_per_gauss) == (
                jtr.config.max_per_tile, jtr.config.max_tiles_per_gauss)
            assert ttr.config.entry_budget == 0


def test_train_step_matches_jax_on_xla():
    cam, jst, gt = _scene()
    tst = _port_state(jst)
    jcam, tcam = _cams(cam)
    jconf, tconf = _configs(CROP)
    jnew, jm = JT.train_step(jst, *jcam, jnp.asarray(gt), jnp.asarray(BG),
                             jnp.int32(1), sh_degree=1, width=W, height=H,
                             opt=JOpt(), config=jconf, extent=2.0)
    tnew, tm = TT.train_step(tst, tcam, torch.tensor(gt), torch.tensor(BG),
                             _row(), sh_degree=1, width=W, height=H,
                             opt=TOpt(), config=tconf)
    _hold_to_jax(jnew, tnew, jm, tm)
    assert int(tm["entries_total"]) == int(jm["entries_total"]) == -1


def test_trainer_on_xla_skips_the_watchdog():
    """Trainer.step and step_block on "xla": entries_total -1, no
    overflow event, a block equal to its steps run one by one."""
    from test_torch_train_block import _stacks, _torch_stacks

    _, jst, _ = _scene()
    stacks, gts = _torch_stacks(*_stacks(n_views=4))
    conf = TConfig(backend="xla", **CROP)
    a = TT.Trainer(_port_state(jst), TOpt(), 2.0, sh_degree=1, config=conf,
                   overflow_check_every=1)
    b = TT.Trainer(_port_state(jst), TOpt(), 2.0, sh_degree=1, config=conf,
                   overflow_check_every=1)
    views = [0, 2, 1]
    for j, v in enumerate(views):
        ma = a.step(1 + j, tuple(s[v] for s in stacks), gts[v], W, H)
        assert int(ma["entries_total"]) == -1
    mb = b.step_block(1, views, stacks, gts, W, H, n_steps=3)
    assert int(mb["entries_total"]) == -1
    assert a.overflow_events == b.overflow_events == 0
    assert a._pending_overflow is None and b._pending_overflow is None
    assert a.config.backend == b.config.backend == "xla"
    for x, y in zip(TT.state_tensors(a.state), TT.state_tensors(b.state)):
        assert torch.equal(x, y)


def test_multi_plot_step_matches_jax_on_xla():
    jsts, cams, gts = _plots()
    extents = [2.0, 3.0]
    tsts = [_port_state(s) for s in jsts]
    jconf, tconf = _configs(PARALLEL)
    jnew, jm = JT.multi_plot_step(1, W, H, JOpt(), jconf)(
        JMesh.stack_states(jsts), *_j(cams), jnp.asarray(gts), jnp.asarray(BG),
        jnp.int32(1), jnp.asarray(extents, jnp.float32))
    step = TT.multi_plot_step(1, W, H, TOpt(), tconf)
    tnew, tm = step(TMesh.stack_states(tsts), _t(cams), torch.tensor(gts),
                    torch.tensor(BG), TT.plot_scalars(1, 1, TOpt(), extents))
    for p in range(2):
        _hold_to_jax(jax.tree.map(lambda x: x[p], jnew),
                     TG.map_tensors(lambda x: x[p], tnew),
                     {k: v[p] for k, v in jm.items()},
                     {k: v[p] for k, v in tm.items()}, f"plot {p} ")
    assert tm["entries_total"].tolist() == [-1, -1]
    assert np.asarray(jm["entries_total"]).tolist() == [-1, -1]



def test_viewer_and_orbit_honour_an_xla_config():
    """ViewerState and the 360 orbit take an "xla" config as given (no
    probe, no overflow re-render or raise) and draw what render_fwd on
    it draws."""
    from wheat3dgs_tpu_torch.apps import render_360_app as RA
    from wheat3dgs_tpu_torch.render.camera_paths import \
        camera_path_fixed_elevation
    from wheat3dgs_tpu_torch.render.pipeline import render_fwd
    from wheat3dgs_tpu_torch.viewer.server import ViewerState

    _, tstate = _states(n=60, seed=7)
    _, tconf = _configs(CROP)
    labels = np.zeros((3, tstate.capacity), bool)
    labels[1, :20] = labels[2, 20:40] = True
    viewer = ViewerState(tstate, 0, width=40, height=30, config=tconf,
                         obj_labels=labels, device="cpu", scale_filter=None)
    img = viewer.render_image(0.8, 0.7, 4.0, viewer.center, overlay=True)
    assert img.shape == (3, 30, 40) and viewer.reprobes == 0
    assert viewer.config == tconf
    cam = viewer._cam(0.8, 0.7, 4.0, viewer.center)
    plain = render_fwd(tstate, *cam, 40, 30, sh_degree=0, config=tconf)
    assert np.abs(plain.color.numpy()).max() > 0
    c2ws = camera_path_fixed_elevation(3, 1, camera_distance=4.0,
                                       cam_center=[0.0, 0.0, 0.0],
                                       elevation=30)
    assert RA.orbit_config(tstate, c2ws, 0.8, 0.6, 40, 30, tconf) == tconf
    frames = RA._orbit_frames(tstate, 0, c2ws, 0.8, 0.6, 40, 30,
                              torch.zeros(3), tconf, obj_labels=labels)
    assert len(frames) == 3 and frames[0].shape == (30, 40, 3)
    assert max(int(f.max()) for f in frames) > 0
