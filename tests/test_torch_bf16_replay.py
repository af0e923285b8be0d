"""The bfloat16 replay patch (scripts/tpu_numerics.py's `bf16_replay()`,
cuda_raster.composite_bwd's `bf16_ops`): JAX's `_bwd_kernel` computes
three products of its replay from bfloat16 operands with float32 sums on
a TPU (wheat3dgs_tpu/ops/pallas_raster.py:964-990); the patch makes the
port do the same.

- The three products of `cuda_raster.bf16_replay_products` against the
  same products JAX's kernel writes (`astype(jnp.bfloat16)` operands,
  float32 sums) on the same numpy operands: the rounded operands and the
  exact products bit for bit (ties to even, subnormals), `u = gmat . ent`
  (a 9-term sum) bit for bit, the prefix and the value-row gradients
  within the float32 bound of a sum in another order (n eps sum |terms|,
  n the terms summed): XLA's CPU dot sums 128 and 1024 terms in an order
  of its own.
- Unflagged, the plain replay is the float32 replay: bit-identical rows
  with and without `bf16_ops=False`, and through `rasterize`'s backward.
  The plain training forward rounds nothing either: its image is
  bit-identical through `composite_train_fwd` and on a second call, within
  1e-5 (relative L2) of a float64 numpy construction of the float32
  forward, and at least CONSTRUCTION_GAIN times nearer it than to the
  constructions that round the transmittance prefix's addends or the
  image sums' operands to bfloat16 (JAX's forward keeps both float32).
- On tests/test_torch_train_raster.py's Pallas scene (40 splats, seed 5,
  48x32, a background), the port's gradients against JAX's
  `rasterize_pallas` (interpret mode, pack_payload=False) twice: under
  `bf16_grads()` + `bf16_replay()` and under `bf16_grads()` alone. The
  patched distance is under PATCHED_REL of each leaf's max |g| (the
  geometry sums' order: JAX's moment matmuls against the port's direct
  form; 3.3e-7 measured) and at least GAIN times below the unpatched one
  (0.032 on scales measured).
- The runner's `--bf16_replay` enters the patch around the app's main and
  restores it; a Trainer built inside the patch (the runner enters it
  before the CLI builds one) runs the flagged replay on every step of a
  block, eagerly here and from a captured CUDA graph on the card (the
  `gpu` case, which also shows a graph captured before the patch replaying
  the default build).
- `SEG_BF16_REPLAY=1` routes exp_seg_envelope.py's training and
  segmentation and exp_round5_final.sh's segmentation through the runner
  with `--bf16_replay`; a value other than 0 or 1 is refused.
- Without a card, the flagged path asked for the card raises.

The module imports no JAX at its top, so that the `gpu` case runs on the
card's machine (`python -m pytest --noconftest -m gpu`).
"""

import contextlib
import importlib.util
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from wheat3dgs_tpu_torch.ops import cuda_raster as CR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPTS = os.path.join(ROOT, "wheat3dgs_tpu_torch", "scripts")
PATCHED_REL = 1e-5
GAIN = 1000.0
EPS32 = float(np.finfo(np.float32).eps)
CONSTRUCTION_GAIN = 20.0


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"port_{name}", os.path.join(PORT_SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(nv=9, p=1024, k=128, seed=11):
    """Seeded value-row cotangents (nv, P), entry value rows (K, nv) and
    weights (P, K), with exact bfloat16 ties and subnormal-range values
    among them."""
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(nv, p)) * 1e-3).astype(np.float32)
    vals = rng.normal(size=(k, nv)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, size=(p, k)).astype(np.float32)
    for a in (g, vals, w):
        bits = a.reshape(-1).view(np.uint32)
        bits[:64] = (bits[:64] & 0xFFFF0000) | 0x8000      # ties to even
        bits[64:96] = (bits[64:96] & 0xFFFF0000) | 0x7FFF
    g[0, :8] = np.float32(1e-39)                            # subnormals
    w[:4, 0] = np.float32(3e-39)
    return g, vals, w


def test_products_round_as_jax():
    import jax
    import jax.numpy as jnp

    g, vals, w = _operands()
    k = vals.shape[0]
    u_v, terms, d_val = CR.bf16_replay_products(
        torch.as_tensor(g)[None], torch.as_tensor(vals)[None],
        torch.as_tensor(w)[None])
    u_v, terms, d_val = u_v[0].numpy(), terms[0].numpy(), d_val[0].numpy()

    def bf(x):
        return jnp.asarray(x).astype(jnp.bfloat16)

    for x in (g, vals, w):       # the rounded operands
        want = np.asarray(bf(x).astype(jnp.float32))
        got = CR.bf16_round(torch.as_tensor(x)).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        assert not np.array_equal(got, x)
    # u = gmat . ent (the kernel's dot_general, :964-967): bit for bit.
    u_j = np.asarray(jax.lax.dot_general(
        bf(g), bf(vals.T), (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32))
    assert np.array_equal(u_v, u_j)
    # The prefix's addends: w u rounded (pu.astype(bfloat16)), exact.
    pu_j = np.asarray(bf(w * u_j).astype(jnp.float32))
    assert np.array_equal(terms.view(np.uint32), pu_j.view(np.uint32))
    # The prefix (pu @ tri, :969-971) against the port's cumsum of the
    # same addends.
    tri = np.triu(np.ones((k, k), np.float32))
    pre_j = np.asarray(jnp.dot(bf(pu_j), bf(tri),
                               preferred_element_type=jnp.float32))
    pre_t = torch.cumsum(torch.as_tensor(terms), dim=1).numpy()
    bound = k * EPS32 * np.cumsum(np.abs(terms.astype(np.float64)), axis=1)
    assert (np.abs(pre_t.astype(np.float64) - pre_j) <= bound).all()
    # The value-row gradients fg = gmat . w (:986-990).
    fg_j = np.asarray(jax.lax.dot_general(
        bf(g), bf(w), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32))               # (nv, K)
    gb = np.asarray(bf(g).astype(jnp.float32)).astype(np.float64)
    wb = np.asarray(bf(w).astype(jnp.float32)).astype(np.float64)
    bound = g.shape[1] * EPS32 * (np.abs(gb) @ np.abs(wb))
    assert (np.abs(d_val.T.astype(np.float64) - fg_j) <= bound).all()
    assert (np.abs(fg_j - gb @ wb) <= bound).all()


def _replay_inputs():
    """composite_bwd's inputs on test_torch_train_raster's XLA-parity scene
    (JAX's seeded fixtures, 60 splats at 64x48: the rasterizer's own
    prologue and forward) with a seeded cotangent on every image row, and
    the plan's per-rank slot segments."""
    from test_torch_train_raster import LEAVES, _inputs

    from wheat3dgs_tpu_torch.ops import projection as TP

    cam, g, _ = _inputs(60, 9, 64, 48)
    leaves = [torch.tensor(g[k]) for k in LEAVES]
    s = TP.project_gaussians(
        *leaves[:4], torch.tensor(cam.w2c), torch.tensor(cam.full_proj),
        torch.tensor(cam.cam_center), cam.tanfovx, cam.tanfovy, cam.width,
        cam.height, sh=leaves[4], sh_degree=1)
    plan = CR.alloc_prologue(s, cam.width, cam.height, 4096)
    keys, _ = CR.decode_cull(plan)
    skeys, starts, ends, perm = CR.sorted_stream(
        keys, plan.t_total, plan.rank_bits, with_perm=True)
    feat = CR.entry_features(s, plan.order, True, True)
    img, stop = CR.composite_train_fwd(skeys, starts, ends, feat,
                                       plan.rank_bits, cam.width, cam.height)
    grad = torch.as_tensor(np.random.default_rng(3).normal(size=img.shape),
                           dtype=torch.float32)
    return (skeys, perm, starts, ends, feat, img, stop, grad,
            plan.rank_bits, cam.width, cam.height), plan


def test_unflagged_replay_is_the_float32_replay():
    tn = _script("tpu_numerics")
    args, plan = _replay_inputs()
    rows = CR.composite_bwd_plain(*args)
    assert bool((rows != 0).any())
    unflagged = CR.composite_bwd_plain(*args, bf16_ops=False)
    assert torch.equal(rows.view(torch.int32), unflagged.view(torch.int32))
    assert torch.equal(rows, CR.composite_bwd(*args))
    assert torch.equal(CR.composite_bwd_plain(*args).view(torch.int32),
                       rows.view(torch.int32))
    # The training forward: the same bits on every route and call, and the
    # float32 forward, not a bfloat16-rounded one.
    fargs = (args[0], args[2], args[3], args[4], args[8], args[9], args[10])
    img, stop = CR.composite_train_fwd_plain(*fargs)
    for again, stop_again in (CR.composite_train_fwd_plain(*fargs),
                              CR.composite_train_fwd(*fargs)):
        assert torch.equal(again.view(torch.int32), img.view(torch.int32))
        assert torch.equal(stop_again, stop)
    assert torch.equal(img.view(torch.int32), args[5].view(torch.int32))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    dist = {(p, q): rel(img.numpy().astype(np.float64),
                        _np_train_forward(*fargs, p, q))
            for p in (False, True) for q in (False, True)}
    others = [v for k, v in dist.items() if k != (False, False)]
    assert dist[(False, False)] < 1e-5, dist
    assert dist[(False, False)] * CONSTRUCTION_GAIN < min(others), dist
    flagged = CR.composite_bwd_plain(*args, bf16_ops=True)
    assert not torch.equal(rows, flagged)
    # The geometry columns move by the rounding, not beyond it.
    scale = rows.abs().amax(dim=0).clamp(min=1e-30)
    assert float(((flagged - rows).abs() / scale).max()) < 0.1
    # rasterize's backward takes the flag from the patch.
    seen = []

    def spy(*a, **kw):
        seen.append(kw.get("bf16_ops", False))
        return CR.composite_bwd_plain(*a, **kw)

    feat = args[4].clone().requires_grad_(True)
    with mock.patch.object(CR, "composite_bwd", spy):
        for flag in (False, True):
            with tn.bf16_replay() if flag else contextlib.nullcontext():
                img = CR._Composite.apply(feat, args[0], args[1], args[2],
                                          args[3], plan.seg_start,
                                          plan.seg_end, args[8], args[9],
                                          args[10], False)
                (img * args[7]).sum().backward()
    assert seen == [False, True]


def _distance(ref, got):
    return max(float(np.abs(a - b).max() / np.abs(a).max())
               for a, b in zip(ref, got))


def test_gradients_closer_to_jax_pallas_under_the_patch(capsys):
    import contextlib

    import jax.numpy as jnp
    import test_torch_train_raster as TR

    from wheat3dgs_tpu.ops.pallas_raster import rasterize_pallas

    tn = _script("tpu_numerics")
    bwd = CR.composite_bwd
    cam, g, gt = TR._inputs(40, 5, 48, 32)
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    _, _, grads_j = TR._jax_grads(
        lambda s: rasterize_pallas(s, cam.width, cam.height, jnp.asarray(bg),
                                   tile=CR.TILE_PX, interpret=True,
                                   pack_payload=False),
        cam, g, gt)
    dist = {}
    for name, patches in (("bf16_grads", (tn.bf16_grads,)),
                          ("bf16_grads + bf16_replay", (tn.bf16_grads,
                                                        tn.bf16_replay))):
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p())
            _, _, grads_t = TR._torch_grads(cam, g, gt, bg)
        dist[name] = _distance(grads_j, grads_t)
    with capsys.disabled():
        print(f"\nmax |port - JAX Pallas| / max |JAX| over the leaves: "
              f"{dist}")
    patched = dist["bf16_grads + bf16_replay"]
    assert patched < PATCHED_REL
    assert patched * GAIN < dist["bf16_grads"]
    assert CR.composite_bwd is bwd


def _replay_flag():
    """The bf16_ops that rasterize's backward passes to composite_bwd."""
    return getattr(CR.composite_bwd, "keywords", {}).get("bf16_ops", False)


def test_runner_enters_and_restores_bf16_replay(monkeypatch):
    tn = _script("tpu_numerics")
    seen = {}
    bwd = CR.composite_bwd

    def fake_main(argv):
        seen["flag"] = _replay_flag()
        return "done"

    fake = type(sys)("wheat3dgs_tpu_torch.apps.fake_app")
    fake.main = fake_main
    monkeypatch.setitem(sys.modules, "wheat3dgs_tpu_torch.apps.fake_app",
                        fake)
    assert tn.main(["--bf16_replay", "--", "apps.fake_app"]) == "done"
    assert seen["flag"] is True and CR.composite_bwd is bwd
    assert tn.main(["--", "apps.fake_app"]) == "done"
    assert seen["flag"] is False


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene

    out = str(tmp_path_factory.mktemp("bf16") / "scene")
    make_synthetic_colmap_scene(out, width=48, height=32, n_heads=1,
                                pts_per_head=40, ground_pts=160,
                                with_masks=False, device="cpu")
    return out


def _recording():
    """A spy on the plain replay, recording each call's bf16_ops."""
    seen = []
    plain = CR.composite_bwd_plain

    def spy(*a, **kw):
        seen.append(kw.get("bf16_ops", False))
        return plain(*a, **kw)

    return seen, mock.patch.object(CR, "composite_bwd_plain", spy)


def test_trainer_built_inside_the_patch_runs_the_flagged_replay(tiny_scene,
                                                               tmp_path):
    tn = _script("tpu_numerics")
    bwd = CR.composite_bwd
    seen, spy = _recording()
    with spy:
        trainer, _ = tn.main(["--bf16_replay", "--", "apps.train_vanilla",
                              "-s", tiny_scene, "-m", str(tmp_path / "m"),
                              "--iterations", "12", "--test_iterations",
                              "12", "--save_iterations", "12", "--device",
                              "cpu", "--quiet"])
    # Blocks of steps (step_block) and single steps alike.
    assert len(seen) >= 12 and all(seen)
    assert CR.composite_bwd is bwd
    seen.clear()
    with spy:
        tn.main(["--", "apps.train_vanilla", "-s", tiny_scene, "-m",
                 str(tmp_path / "m2"), "--iterations", "4",
                 "--test_iterations", "4", "--save_iterations", "4",
                 "--device", "cpu", "--quiet"])
    assert seen and not any(seen)


@pytest.mark.gpu
def test_graph_replays_the_backward_it_captured():
    """On the card: a Trainer built inside the patch replays the BF16
    build on every step of a block; one whose graph was captured before
    the patch replays the default build (why the runner enters it first)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import tempfile

    from wheat3dgs_tpu_torch import config as cfg
    from wheat3dgs_tpu_torch.io.synthetic import make_synthetic_colmap_scene
    from wheat3dgs_tpu_torch.models import gaussians as G
    from wheat3dgs_tpu_torch.scene import Scene
    from wheat3dgs_tpu_torch.training import Trainer

    tn = _script("tpu_numerics")
    with tempfile.TemporaryDirectory() as d:
        make_synthetic_colmap_scene(d, width=256, height=192, n_heads=2,
                                    pts_per_head=300, ground_pts=2000,
                                    with_masks=False, device="cuda")
        scene = Scene(cfg.ModelParams(source_path=d), device="cuda")
        w, h = scene.image_size
        gts = torch.as_tensor(scene.data.train.images, device="cuda")
        stacks = scene.cam_stack("train")

        def block(tr, it):
            CR.reset_launches()
            tr.step_block(it, [0, 1, 2], stacks, gts, w, h, n_steps=3)
            torch.cuda.synchronize()
            return CR.launches["composite_bwd_bf16"], \
                CR.launches["composite_bwd"]

        def trainer():
            st = G.state_from_numpy(
                **G.state_to_numpy(scene.gaussians)._asdict(), device="cuda")
            return Trainer(st, cfg.OptimizationParams(),
                           scene.cameras_extent, adaptive_occupancy=False)

        with tn.bf16_replay():
            inside = trainer()
            assert block(inside, 1) == (3, 0)
        before = trainer()
        assert block(before, 4) == (0, 3)
        with tn.bf16_replay():
            assert block(before, 7) == (0, 3)


def test_seg_bf16_replay_routes_through_the_runner(tmp_path, monkeypatch):
    env = _script("exp_seg_envelope")
    for k in ("SEG_KNN", "SEG_BF16_GRADS", "SEG_SEED"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SEG_BF16_REPLAY", "1")
    monkeypatch.setenv("SEG_BF16_GRADS", "1")
    monkeypatch.setenv("SEG_SCENE", str(tmp_path / "scene"))
    monkeypatch.setenv("SEG_MODEL", str(tmp_path / "model"))
    num = env.numerics(env.settings())
    assert num == {"knn": "exact", "bf16_grads": True, "seed": 0,
                   "bf16_replay": True}
    runner = os.path.join(PORT_SCRIPTS, "tpu_numerics.py")
    default_train = env.train_cmd("scene", str(tmp_path), 15000, "cpu")
    assert env.train_cmd("scene", str(tmp_path), 15000, "cpu", num) == [
        sys.executable, runner, "--bf16_grads", "--bf16_replay", "--seed",
        "0", "--", "wheat3dgs_tpu_torch.apps.train_vanilla",
        *default_train[3:]]
    assert env.seg_cmd("scene", "model", "cpu", num)[:5] == [
        sys.executable, runner, "--bf16_grads", "--bf16_replay", "--"]
    assert env.numerics_note(num) == ("tpu_numerics: knn=exact, "
                                      "bf16_grads=1, bf16_replay=1, seed=0")
    # Alone, it is off the defaults too.
    monkeypatch.setenv("SEG_BF16_GRADS", "0")
    assert env.numerics(env.settings()) == {
        "knn": "exact", "bf16_grads": False, "seed": 0, "bf16_replay": True}
    # Off, the dict and the note are the three-key ones.
    monkeypatch.setenv("SEG_BF16_REPLAY", "0")
    assert env.numerics(env.settings()) is None
    for bad in ("2", "yes", ""):
        monkeypatch.setenv("SEG_BF16_REPLAY", bad)
        with pytest.raises(SystemExit, match="SEG_BF16_REPLAY=.*0 or 1"):
            env.settings()
    monkeypatch.setenv("SEG_BF16_REPLAY", "1")
    for var in ("SEG_SCENE", "SEG_MODEL"):
        monkeypatch.delenv(var)
        with pytest.raises(SystemExit, match="needs its own SEG_SCENE"):
            env.main(["--device", "cpu"])
        monkeypatch.setenv(var, str(tmp_path / var))


@pytest.mark.parametrize("replay", ["0", "1"])
def test_round5_chain_passes_seg_bf16_replay(tmp_path, replay):
    from test_torch_pipeline_scripts import _run_logged

    scene, model = tmp_path / "scene", tmp_path / "model"
    scene.mkdir()
    exp = model / "wheat-head" / "envelope"
    (exp / "ply").mkdir(parents=True)
    (exp / "envelope_report.json").write_text("{}")
    open(model / "chkpnt15000.npz", "w").close()
    calls = _run_logged(tmp_path, os.path.join(PORT_SCRIPTS,
                                               "exp_round5_final.sh"), [],
                        SEG_SCENE=str(scene), SEG_MODEL=str(model),
                        SEG_BF16_REPLAY=replay, DEVICE="cpu")
    seg = [c["argv"] for c in calls
           if "wheat3dgs_tpu_torch.apps.run_3d_seg_app" in c["argv"]]
    assert len(seg) == 1
    if replay == "1":
        assert seg[0][:3] == [os.path.join(PORT_SCRIPTS, "tpu_numerics.py"),
                              "--bf16_replay", "--"]
    else:
        assert seg[0][:2] == ["-m", "wheat3dgs_tpu_torch.apps.run_3d_seg_app"]


def _bf16_bits(x):
    """float32 x rounded to bfloat16 (to nearest, ties to even) by its bits,
    as float32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _np_train_forward(skeys, starts, ends, feat, rank_bits, width, height,
                      round_prefix, round_sums):
    """JAX's `_fwd_kernel` per pixel in numpy: alpha with renderCUDA's
    clamps in float32, the log-transmittance prefix summed in float64 from
    log1p(-alpha), w = alpha exp(prefix - log1p(-alpha)) while the prefix
    stays at or above LOG_T_EPS, and the image rows as float64 sums of w
    times the value rows. round_prefix rounds the prefix's addends and
    round_sums both factors of the image sums to bfloat16, as a one-pass
    bfloat16 matmul would. -> (1 + nv, H, W)."""
    skeys, starts, ends, feat = (t.numpy() for t in (skeys, starts, ends,
                                                     feat))
    tile = CR.TILE_PX
    tiles_x, tiles_y = CR.num_tiles(width, height, tile)
    nv = feat.shape[1] - 6
    out = np.zeros((1 + nv, tiles_y * tile, tiles_x * tile))
    rank = skeys & ((1 << rank_bits) - 1)
    pix = np.arange(tile * tile)
    for t in range(tiles_x * tiles_y):
        f = feat[rank[starts[t]:ends[t]]]                      # (K, F)
        if not len(f):
            continue
        px = ((t % tiles_x) * tile + pix % tile).astype(np.float32)[:, None]
        py = ((t // tiles_x) * tile + pix // tile).astype(np.float32)[:, None]
        dx, dy = px - f[None, :, 0], py - f[None, :, 1]
        power = (np.float32(-0.5) * (f[None, :, 2] * dx * dx
                                     + f[None, :, 4] * dy * dy)
                 - f[None, :, 3] * dx * dy)
        alpha = np.minimum(f[None, :, 5] * np.exp(power),
                           np.float32(CR.ALPHA_MAX))
        alpha = np.where((power > 0) | (alpha < CR.ALPHA_MIN), 0, alpha)
        l1m = np.log1p(-alpha.astype(np.float32))
        log_t = np.cumsum((_bf16_bits(l1m) if round_prefix else l1m)
                          .astype(np.float64), axis=1)
        w = np.where(log_t >= CR.LOG_T_EPS,
                     alpha * np.exp(log_t - l1m), 0.0)         # (P, K)
        vals = np.concatenate([np.ones((len(f), 1), np.float32), f[:, 6:]],
                              axis=1)
        if round_sums:
            w, vals = _bf16_bits(w), _bf16_bits(vals)
        rows = vals.T.astype(np.float64) @ w.T.astype(np.float64)
        ty, tx = divmod(t, tiles_x)
        out[:, ty * tile:(ty + 1) * tile, tx * tile:(tx + 1) * tile] = \
            rows.reshape(1 + nv, tile, tile)
    return out[:, :height, :width]


def test_flagged_path_refuses_without_card(tmp_path, tiny_scene):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tn = _script("tpu_numerics")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tn.main(["--bf16_replay", "--", "apps.train_vanilla", "-s",
                 tiny_scene, "-m", str(tmp_path / "m")])
    assert not (tmp_path / "m").exists()
    tr = _script("densify_trace")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.run(["--bf16_replay", "--", "-s", tiny_scene, "-m",
                str(tmp_path / "m2")])
    # The wrapper launches the kernel or raises for a tensor off the CPU.
    args = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in _replay_inputs()[0]]
    with pytest.raises(ValueError, match="unsupported device"):
        CR.composite_bwd(*args, bf16_ops=True)
