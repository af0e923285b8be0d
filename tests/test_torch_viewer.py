"""The port's web viewer (wheat3dgs_tpu_torch/viewer/server.py) and SIBR
protocol module (render/network_gui.py), mirroring tests/test_viewer.py
and tests/test_tools.py::test_network_gui_camera_decode, plus parity with
the JAX viewer:

- the page, /info, /teleport (its math and the orbit camera against JAX's
  camera_from_orbit, to 1e-6), /render with and without the overlay and
  with a head whitelist, junk head ids, the 404;
- the scale filter drops the same splats as JAX's;
- a frame's image before JPEG, with and without the overlay (whitelist
  too), against JAX's render_frame on its Pallas path (interpret mode,
  pack_payload=False) at the same budget: every uint8 level within 1;
- a render over the budget raises the budget to pick_entry_budget(demand)
  and re-renders, as JAX's does (the same new budget, the image within 1
  level), and counts the re-probe;
- network_gui: the SIBR message decodes into the column-vector camera;
  serve_render's payload against JAX's serve_render on the same message
  and state on its Pallas path at the same budget: every uint8 level
  within 1.
"""

import io
import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wheat3dgs_tpu import testing
from wheat3dgs_tpu.models import gaussians as JG
from wheat3dgs_tpu.render.pipeline import RasterConfig as JConfig
from wheat3dgs_tpu.viewer import ViewerState as JViewer
from wheat3dgs_tpu_torch.models import gaussians as TG
from wheat3dgs_tpu_torch.ops.binning import pick_entry_budget
from wheat3dgs_tpu_torch.render.pipeline import RasterConfig as TConfig
from wheat3dgs_tpu_torch.render.pipeline import render_fwd
from wheat3dgs_tpu_torch.viewer import ViewerState, serve

W, H = 96, 64
BUDGET = 8192


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(n=200, seed=0, big=0):
    """JAX's test state (__graft_entry__._tiny_state): SH 1, opacity
    logit 1; `big` splats get a scale of 0.5, the rest keep theirs."""
    g = testing.random_gaussians(n=n, seed=seed, spread=0.8, sh_degree=1)
    log_scales = np.log(g["scales"]).astype(np.float32)
    if big:
        log_scales[:] = np.log(0.02)
        log_scales[:big] = np.log(0.5)
    return {"means": g["means3d"], "quats": g["quats"],
            "log_scales": log_scales, "sh_dc": g["sh"][:, 0],
            "sh_rest": g["sh"][:, 1:].reshape(n, -1),
            "opacity_logit": np.full((n,), 1.0, np.float32)}


def _states(cap=512, **kw):
    p = _params(**kw)
    js = JG.init_state(JG.GaussianParams(
        **{k: jnp.asarray(v) for k, v in p.items()}), capacity=cap)
    ts = TG.init_state(TG.GaussianParams(
        **{k: torch.as_tensor(np.asarray(v, np.float32))
           for k, v in p.items()}), capacity=cap)
    return js, ts


def _labels(cap=512):
    labels = np.zeros((3, cap), bool)
    labels[1, :50] = True
    labels[2, 50:100] = True
    return labels


POSES = [(np.array([3.0, 0, 1.0]), np.zeros(3)),
         (np.array([1.0, 2.0, 2.0]), np.array([0.5, -0.5, 1.0]))]
NAMES = ["train:cam01", "test:cam11"]


def _fetch(base, path):
    return urllib.request.urlopen(base + path).read()


@pytest.fixture(scope="module")
def viewer():
    _, ts = _states()
    vs = ViewerState(ts, sh_degree=1, width=W, height=H,
                     obj_labels=_labels(), camera_names=NAMES,
                     camera_poses=POSES, scale_filter=None,
                     config=TConfig(entry_budget=BUDGET), device="cpu")
    httpd = serve(vs, host="127.0.0.1", port=0, blocking=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield vs, base
    httpd.shutdown()
    httpd.server_close()


def test_viewer_page_and_info(viewer):
    vs, base = viewer
    assert b"wheat3dgs_tpu_torch viewer" in _fetch(base, "/")
    info = json.loads(_fetch(base, "/info"))
    assert info["cameras"] == NAMES
    assert info["n_heads"] == 2
    assert info["radius"] > 0
    np.testing.assert_allclose(info["center"], vs.center, atol=1e-6)


def test_viewer_teleport_math(viewer):
    vs, base = viewer
    tp = json.loads(_fetch(base, "/teleport?i=0"))
    assert tp["dist"] == pytest.approx(np.sqrt(10.0), abs=1e-3)
    assert tp["az"] == pytest.approx(0.0, abs=1e-6)
    assert tp["el"] == pytest.approx(np.arcsin(1 / np.sqrt(10)), abs=1e-6)
    assert tp["center"] == [0.0, 0.0, 0.0]
    tp = json.loads(_fetch(base, "/teleport?i=1"))
    d = np.array([0.5, 2.5, 1.0])
    assert tp["dist"] == pytest.approx(np.linalg.norm(d), abs=1e-4)
    assert tp["az"] == pytest.approx(np.arctan2(2.5, 0.5), abs=1e-6)
    assert tp["center"] == [0.5, -0.5, 1.0]
    w2c, fp, eye = vs.camera_from_orbit(tp["az"], tp["el"], tp["dist"],
                                        np.asarray(tp["center"]))
    np.testing.assert_allclose(eye, [1.0, 2.0, 2.0], atol=1e-5)
    np.testing.assert_allclose((w2c @ np.array([*eye, 1.0]))[:3], 0.0,
                               atol=1e-5)
    js, _ = _states()
    jv = JViewer(js, sh_degree=1, width=W, height=H, scale_filter=None)
    for got, want in zip((w2c, fp, eye), jv.camera_from_orbit(
            tp["az"], tp["el"], tp["dist"], np.asarray(tp["center"]))):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_viewer_render_and_overlay_whitelist(viewer):
    _, base = viewer
    q = "/render?az=0.8&el=0.7&dist=4"
    plain = _fetch(base, q + "&overlay=0")
    both = _fetch(base, q + "&overlay=1")
    only1 = _fetch(base, q + "&overlay=1&heads=1")
    only2 = _fetch(base, q + "&overlay=1&heads=2")
    junk = _fetch(base, q + "&overlay=1&heads=zz,,9")
    for jpeg in (plain, both, only1, only2, junk):
        assert jpeg[:2] == b"\xff\xd8"
        assert Image.open(io.BytesIO(jpeg)).size == (W, H)
    assert only1 != only2
    assert both != plain


def test_viewer_unknown_path_404(viewer):
    _, base = viewer
    with pytest.raises(urllib.error.HTTPError) as e:
        _fetch(base, "/nope")
    assert e.value.code == 404


def test_viewer_scale_filter_drops_big_splats():
    js, ts = _states(cap=128, n=100, seed=1, big=10)
    n_alive = int(ts.num_alive)
    vs = ViewerState(ts, sh_degree=1, width=32, height=32, scale_filter=0.1,
                     config=TConfig(entry_budget=BUDGET), device="cpu")
    assert int(vs.state.num_alive) == n_alive - 10
    jv = JViewer(js, sh_degree=1, width=32, height=32, scale_filter=0.1)
    np.testing.assert_array_equal(vs.state.alive.numpy(),
                                  np.asarray(jv.state.alive))
    off = ViewerState(ts, sh_degree=1, width=32, height=32,
                      scale_filter=None, device="cpu")
    assert int(off.state.num_alive) == n_alive


def _jax_image(jv, *args, **kw):
    """JAX's render_frame's image before JPEG encoding."""
    seen = []
    real = Image.fromarray

    def capture(arr, *a, **k):
        seen.append(np.array(arr))
        return real(arr, *a, **k)

    Image.fromarray = capture
    try:
        jv.render_frame(*args, **kw)
    finally:
        Image.fromarray = real
    return seen[-1]


def _u8(img):
    return (img.transpose(1, 2, 0) * 255).astype(np.uint8)


@pytest.mark.parametrize("overlay,heads", [(False, None), (True, None),
                                           (True, {2})])
def test_render_frame_matches_jax(overlay, heads):
    js, ts = _states()
    labels = _labels()
    jv = JViewer(js, sh_degree=1, width=W, height=H, obj_labels=labels,
                 scale_filter=0.1, config=JConfig(
                     backend="pallas", pack_payload=False,
                     entry_budget=BUDGET))
    vs = ViewerState(ts, sh_degree=1, width=W, height=H, obj_labels=labels,
                     scale_filter=0.1, config=TConfig(entry_budget=BUDGET),
                     device="cpu")
    view = (0.8, 0.7, 4.0, np.array([0.1, -0.2, 0.0]))
    want = _jax_image(jv, *view, overlay=overlay, head_whitelist=heads)
    got = _u8(vs.render_image(*view, overlay=overlay, head_whitelist=heads))
    assert got.shape == want.shape == (H, W, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert vs.reprobes == 0 and vs.config.entry_budget == BUDGET


def test_render_frame_reprobes_after_overflow():
    js, ts = _states()
    small = 256
    jv = JViewer(js, sh_degree=1, width=W, height=H, scale_filter=None,
                 config=JConfig(backend="pallas", pack_payload=False,
                                entry_budget=small))
    vs = ViewerState(ts, sh_degree=1, width=W, height=H, scale_filter=None,
                     config=TConfig(entry_budget=small), device="cpu")
    view = (0.8, 0.7, 4.0, np.zeros(3))
    demand = int(render_fwd(ts, *vs._cam(*view), W, H, sh_degree=1,
                            config=vs.config).entries_total)
    assert demand > small
    want = _jax_image(jv, *view)
    got = _u8(vs.render_image(*view))
    assert vs.reprobes == 1
    assert vs.config.entry_budget == jv.config.entry_budget == \
        pick_entry_budget(demand)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    vs.render_image(*view)                    # settled: no second re-probe
    assert vs.reprobes == 1


def _sibr_message(cam, width, height):
    w2c_t = cam.w2c.T.copy()
    w2c_t[:, 1] = -w2c_t[:, 1]
    w2c_t[:, 2] = -w2c_t[:, 2]
    fp_t = cam.full_proj.T.copy()
    fp_t[:, 1] = -fp_t[:, 1]
    return {
        "resolution_x": width, "resolution_y": height, "train": False,
        "fov_x": 2 * np.arctan(cam.tanfovx),
        "fov_y": 2 * np.arctan(cam.tanfovy),
        "z_near": 0.01, "z_far": 100.0, "shs_python": False,
        "rot_scale_python": False, "keep_alive": True,
        "scaling_modifier": 1.0,
        "view_matrix": w2c_t.ravel().tolist(),
        "view_projection_matrix": fp_t.ravel().tolist(),
    }


def test_network_gui_camera_decode_and_serve(monkeypatch):
    from wheat3dgs_tpu.render import network_gui as jax_gui
    from wheat3dgs_tpu_torch.render import network_gui

    cam = testing.look_at_camera(width=32, height=24)
    msg = _sibr_message(cam, 32, 24)
    monkeypatch.setattr(network_gui, "_read_message", lambda: msg)
    out_cam, train, _, _, keep, sm = network_gui.receive()
    np.testing.assert_allclose(out_cam["w2c"], cam.w2c, atol=1e-6)
    np.testing.assert_allclose(out_cam["full_proj"], cam.full_proj,
                               atol=1e-6)
    np.testing.assert_allclose(out_cam["cam_center"], cam.cam_center,
                               atol=1e-5)
    assert keep is True and sm == 1.0 and train is False

    js, ts = _states()
    sent = []
    for mod in (network_gui, jax_gui):
        monkeypatch.setattr(mod, "_read_message", lambda: msg)
        monkeypatch.setattr(mod, "send", lambda payload, verify:
                            sent.append((payload, verify)))
    assert network_gui.serve_render(ts, 1, verify="v",
                                    config=TConfig(entry_budget=BUDGET))
    assert jax_gui.serve_render(js, 1, verify="v", config=JConfig(
        backend="pallas", pack_payload=False, entry_budget=BUDGET))
    (payload, verify), (jax_payload, _) = sent
    assert verify == "v" and len(payload) == len(jax_payload) == 32 * 24 * 3
    got = np.frombuffer(payload, np.uint8).astype(int)
    want = np.frombuffer(jax_payload, np.uint8).astype(int)
    assert np.abs(got - want).max() <= 1 and want.std() > 1
