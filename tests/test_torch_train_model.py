"""Parity of the port's training state (wheat3dgs_tpu_torch.models:
gaussians, optim, serialization) with the JAX package's.

A JAX GaussianState, with seeded random Adam moments and statistics, is
carried to the port as numpy (state_from_numpy), both packages run the same
operation, and every field is compared. densify_and_prune's split noise is
JAX's own `jax.random.normal(key, (2, cap, 3))` draw, injected into the
port. Tolerances: masks, counts and ids exact; float fields within atol
1e-6 (the same float32 operations; einsum and log/exp may round the last
ulp apart); Adam within atol 1e-6 of JAX and of torch.optim.Adam, as
tests/test_model.py holds JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheat3dgs_tpu.models import gaussians as JG
from wheat3dgs_tpu.models import optim as JO
from wheat3dgs_tpu.models import serialization as JS
from wheat3dgs_tpu_torch.models import gaussians as TG
from wheat3dgs_tpu_torch.models import optim as TO
from wheat3dgs_tpu_torch.models import serialization as TS

FIELDS = TG.PARAM_FIELDS


def _jax_state(n=6, cap=16, sh_degree=1, seed=2):
    """tests/test_model.py's _tiny_state, with seeded moments, step and
    statistics so their surgery is visible."""
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    params = JG.GaussianParams(
        means=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        quats=jnp.zeros((n, 4), jnp.float32).at[:, 0].set(1.0),
        log_scales=jnp.asarray(np.log(rng.uniform(0.05, 0.2, (n, 3))),
                               jnp.float32),
        sh_dc=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        sh_rest=jnp.asarray(rng.normal(size=(n, 3 * (k - 1))) * 0.1,
                            jnp.float32),
        opacity_logit=jnp.full((n,), 2.0, jnp.float32))
    st = JG.init_state(params, capacity=cap,
                       instance_id=np.arange(1, n + 1, dtype=np.int32))

    def rand_like(tree):
        return jax.tree.map(lambda x: jnp.asarray(
            rng.normal(size=x.shape), jnp.float32), tree)

    adam = JO.AdamState(mu=rand_like(st.params), nu=jax.tree.map(
        jnp.abs, rand_like(st.params)), step=jnp.int32(7))
    return dataclasses.replace(
        st, adam=adam,
        grad_accum=jnp.asarray(rng.uniform(0, 1e-3, cap), jnp.float32),
        denom=jnp.asarray(rng.integers(0, 5, cap), jnp.float32),
        max_radii2d=jnp.asarray(rng.integers(0, 30, cap), jnp.float32))


def _to_port(st):
    def np_tree(t):
        return {f: np.asarray(getattr(t, f)) for f in FIELDS}

    return TG.state_from_numpy(
        np_tree(st.params), alive=np.asarray(st.alive),
        instance_id=np.asarray(st.instance_id), device="cpu",
        adam={"mu": np_tree(st.adam.mu), "nu": np_tree(st.adam.nu),
              "step": int(st.adam.step)},
        grad_accum=np.asarray(st.grad_accum), denom=np.asarray(st.denom),
        max_radii2d=np.asarray(st.max_radii2d))


def _assert_same(jst, tst, atol=1e-6):
    t = TG.state_to_numpy(tst)
    assert tst.capacity == jst.capacity
    np.testing.assert_array_equal(t.alive, np.asarray(jst.alive))
    np.testing.assert_array_equal(t.instance_id, np.asarray(jst.instance_id))
    assert t.adam["step"] == int(jst.adam.step)
    for f in FIELDS:
        np.testing.assert_allclose(t.params[f],
                                   np.asarray(getattr(jst.params, f)),
                                   atol=atol, rtol=0, err_msg=f)
        for m in ("mu", "nu"):
            np.testing.assert_allclose(
                t.adam[m][f], np.asarray(getattr(getattr(jst.adam, m), f)),
                atol=atol, rtol=0, err_msg=f"{m}.{f}")
    for f in TG.STAT_FIELDS:
        np.testing.assert_allclose(getattr(t, f), np.asarray(getattr(jst, f)),
                                   atol=atol, rtol=0, err_msg=f)


def test_adam_matches_jax_and_torch():
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(8, 3)).astype(np.float32)
    grads = [rng.normal(size=(8, 3)).astype(np.float32) for _ in range(5)]

    tp = torch.nn.Parameter(torch.tensor(p0))
    topt = torch.optim.Adam([tp], lr=0.01, eps=1e-15)
    jp = {"p": jnp.asarray(p0)}
    jopt = JO.adam_init(jp)
    params = {"p": torch.tensor(p0)}
    opt = TO.adam_init(params)
    for g in grads:
        tp.grad = torch.tensor(g)
        topt.step()
        jp, jopt = JO.adam_step(jopt, {"p": jnp.asarray(g)}, jp,
                                {"p": jnp.float32(0.01)})
        TO.adam_step(opt, {"p": torch.tensor(g)}, params, {"p": 0.01})
    assert opt.step == int(jopt.step) == 5
    np.testing.assert_allclose(params["p"].numpy(), tp.detach().numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(params["p"].numpy(), np.asarray(jp["p"]),
                               atol=1e-6)
    np.testing.assert_allclose(opt.mu["p"].numpy(), np.asarray(jopt.mu["p"]),
                               atol=1e-7)
    np.testing.assert_allclose(opt.nu["p"].numpy(), np.asarray(jopt.nu["p"]),
                               atol=1e-7)


def test_knn_matches_jax_and_numpy():
    """knn_mean_sq_dist (scipy's cKDTree here, a blocked brute force in
    JAX): the mean squared distance to the 3 nearest other points."""
    from wheat3dgs_tpu.ops.knn import knn_mean_sq_dist as jknn
    from wheat3dgs_tpu_torch.ops.knn import knn_mean_sq_dist as tknn

    pts = np.random.default_rng(0).normal(size=(200, 3)).astype(np.float32)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    want = np.sort(d2, axis=1)[:, :3].mean(1)
    np.testing.assert_allclose(tknn(pts), want, rtol=1e-5)
    np.testing.assert_allclose(tknn(pts), np.asarray(jknn(jnp.asarray(pts))),
                               rtol=1e-4)


def test_create_from_pcd_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    jst = JG.create_from_pcd(pts, cols, 3)
    tst = TG.create_from_pcd(pts, cols, 3, device="cpu")
    _assert_same(jst, tst, atol=1e-5)
    assert tst.capacity == 1024 and int(tst.num_alive) == 300
    # tests/test_model.py's case: unit-distance neighbours -> scale 1.
    unit = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    st = TG.create_from_pcd(unit, np.full((4, 3), 0.5, np.float32), 3,
                            capacity=64, device="cpu")
    assert st.capacity == 64
    np.testing.assert_allclose(torch.exp(st.params.log_scales[0]).numpy(),
                               1.0, rtol=1e-4)


def _densify_both(jst, **kw):
    key = jax.random.PRNGKey(0)
    jnew, jinfo = JG.densify_and_prune(jst, key, **kw)
    noise = torch.tensor(np.asarray(jax.random.normal(
        key, (2, jst.capacity, 3), jnp.float32)))
    tnew, tinfo = TG.densify_and_prune(_to_port(jst), noise=noise, **kw)
    _assert_same(jnew, tnew)
    for k, v in jinfo.items():
        assert int(tinfo[k]) == int(v), k
    return jnew, jinfo


def test_densify_clone_and_split_matches_jax():
    st = _jax_state()
    small = jnp.log(jnp.full((3,), 0.001))
    big = jnp.log(jnp.full((3,), 0.5))
    st = dataclasses.replace(
        st, grad_accum=jnp.zeros(16).at[0].set(1.0).at[1].set(1.0),
        denom=jnp.zeros(16).at[0].set(1.0).at[1].set(1.0),
        params=dataclasses.replace(
            st.params, log_scales=st.params.log_scales.at[0].set(small)
            .at[1].set(big)))
    _, info = _densify_both(st, grad_threshold=0.5, min_opacity=0.005,
                            extent=1.0, max_screen_size=0.0,
                            percent_dense=0.01)
    assert (int(info["n_clone"]), int(info["n_split"]),
            int(info["n_alive"])) == (1, 1, 8)


def test_densify_prune_matches_jax():
    st = _jax_state()
    st = dataclasses.replace(st, params=dataclasses.replace(
        st.params, opacity_logit=st.params.opacity_logit.at[2].set(-10.0)
        .at[4].set(-7.0)))
    _, info = _densify_both(st, grad_threshold=9.9, min_opacity=0.005,
                            extent=1.0, max_screen_size=0.0)
    assert int(info["n_pruned"]) == 2 and int(info["n_alive"]) == 4
    # World-size prune only when max_screen_size > 0 (the reference's
    # screen-radius prune never fires, gaussians.py:215-223).
    _, info = _densify_both(st, grad_threshold=9.9, min_opacity=0.005,
                            extent=0.5, max_screen_size=20.0)
    assert int(info["n_pruned"]) > 2


def test_densify_capacity_overflow_drops_like_jax():
    st = _jax_state(n=14, cap=16)
    st = dataclasses.replace(st, grad_accum=jnp.ones(16), denom=jnp.ones(16))
    jnew, info = _densify_both(st, grad_threshold=0.0, min_opacity=0.005,
                               extent=100.0, max_screen_size=0.0)
    assert int(info["n_dropped"]) == 12 and int(info["n_alive"]) == 16
    tnew = TG.grow_capacity(_to_port(jnew), 32)
    _assert_same(JG.grow_capacity(jnew, 32), tnew)
    assert tnew.capacity == 32 and int(tnew.num_alive) == 16


def test_reset_opacity_and_stats_match_jax():
    st = _jax_state()
    _assert_same(JG.reset_opacity(st), TG.reset_opacity(_to_port(st)))
    rng = np.random.default_rng(5)
    ndc_grad = rng.normal(size=(16, 2)).astype(np.float32) * 1e-3
    radii = rng.integers(0, 4, 16).astype(np.int32)
    _assert_same(
        JG.add_densification_stats(st, jnp.asarray(ndc_grad),
                                   jnp.asarray(radii)),
        TG.add_densification_stats(_to_port(st), torch.tensor(ndc_grad),
                                   torch.tensor(radii)))
    kill = np.zeros(16, bool)
    kill[[1, 3]] = True
    _assert_same(JG.prune_mask(st, jnp.asarray(kill)),
                 TG.prune_mask(_to_port(st), torch.tensor(kill)))


def test_checkpoints_cross_between_packages(tmp_path):
    st = _jax_state(n=9, cap=32)
    # JAX -> port
    JS.save_checkpoint(st, 1234, str(tmp_path / "jax.npz"))
    tst, it = TS.load_checkpoint(str(tmp_path / "jax.npz"), device="cpu")
    assert it == 1234
    _assert_same(st, tst, atol=0)
    # port -> JAX (into a template of another state, as JAX restores)
    TS.save_checkpoint(tst, 99, str(tmp_path / "port.npz"))
    back, it = JS.load_checkpoint(str(tmp_path / "port.npz"), st)
    assert it == 99
    _assert_same(back, tst, atol=0)
    leaves = jax.tree.leaves(back)
    assert [np.asarray(x).dtype for x in leaves] == \
        [np.asarray(x).dtype for x in jax.tree.leaves(st)]


def test_ply_capacity_and_state_roundtrip(tmp_path):
    st = _to_port(_jax_state(n=9, cap=32))
    path = str(tmp_path / "pc.ply")
    TS.save_ply(st, path)
    loaded, deg = TS.load_ply(path, capacity=64, device="cpu")
    assert deg == 1 and loaded.capacity == 64
    assert int(loaded.num_alive) == 9
    jst, jdeg = JS.load_ply(path, capacity=64)
    _assert_same(jst, loaded, atol=0)
    back = TG.state_to_numpy(st)
    again = TG.state_from_numpy(back.params, back.alive, back.instance_id,
                                device="cpu", adam=back.adam,
                                grad_accum=back.grad_accum, denom=back.denom,
                                max_radii2d=back.max_radii2d)
    np.testing.assert_array_equal(TG.state_to_numpy(again).params["means"],
                                  back.params["means"])


def test_grow_capacity_keeps_fresh_leaves():
    """grow_capacity replaces every tensor (params and moments): nothing
    aliases the old state's storage."""
    st = _to_port(_jax_state(n=9, cap=1024))
    new = TG.grow_capacity(st, 2048)
    for f in FIELDS:
        a, b = getattr(st.params, f), getattr(new.params, f)
        assert b.shape[0] == 2048 and b.data_ptr() != a.data_ptr()
        assert new.adam.mu[f].data_ptr() != st.adam.mu[f].data_ptr()
    with pytest.raises(ValueError):
        TG.grow_capacity(st, 1024)
