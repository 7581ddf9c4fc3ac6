"""Port parity: the training loop's pieces (gauspcc_tpu_torch.utils.optim,
models.hac.train, models.hac.pipeline.{adapt_caps,train_scene}) against
the JAX package, at the tiny sizes of tests/test_torch_train.py.

Tolerances: expon_lr rtol 1e-6 (float32 on both sides, exp from other
libraries); one group-Adam update rtol 1e-6 on the leaves and the moments
(float32 elementwise; optax's bias correction computed in float32 on both
sides), with atol 1e-7 on the leaves (a few float32 ulps of the largest
step, lr <= 0.042 here) and 1e-10 on the moments (a few ulps of their
terms, 0.1 |g| <= 1e-3 here); one train step: the
moments, the statistics and the metrics as the gradients of
test_torch_train.py (atol 2e-4 of the largest plus rtol 1e-3), and each
leaf to lr times the difference of the two sides' Adam directions plus
1e-6 of the leaf and its step; adjust_anchor exact (same numpy
arithmetic, same numpy rng)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.models.hac import model as jhac
from gauspcc_tpu.models.hac import pipeline as jpipeline
from gauspcc_tpu.models.hac import train as jtrain
from gauspcc_tpu.utils import optim as joptim

from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.cli import soak as tsoak
from gauspcc_tpu_torch.models.hac import model as thac
from gauspcc_tpu_torch.models.hac import pipeline as tpipeline
from gauspcc_tpu_torch.models.hac import render as trender
from gauspcc_tpu_torch.models.hac import train as ttrain
from gauspcc_tpu_torch.utils import optim as toptim

from test_torch_train import (GRAD_ATOL, GRAD_RTOL, JCFG, TCFG, camera,
                              jax_leaf, jax_noise, jax_state, raster_cfgs)


@pytest.mark.parametrize("kw", [
    dict(lr_init=0.01 * 4.2, lr_final=0.0001 * 4.2, max_steps=30_000,
         lr_delay_mult=0.01),
    dict(lr_init=5e-3, lr_final=1e-5, max_steps=600, lr_delay_steps=50,
         lr_delay_mult=0.33),
    dict(lr_init=0.0075, lr_final=0.0075, max_steps=100, step_sub=10),
])
def test_expon_lr_matches_jax(kw):
    want, got = joptim.expon_lr(**kw), toptim.expon_lr(**kw)
    for step in (0, 1, 2, 37, 599, 600, 5000, 30_000, 40_000):
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))),
                                   rtol=1e-6, err_msg=str(step))


def _carry_moments(tree, leaves):
    """A JAX moment tree in the port's leaf layout, copied: the port updates
    its moments in place, and JAX's buffers must not change under a JAX
    computation that its asynchronous dispatch may still be running."""
    return {name: torch.from_numpy(np.array(jax_leaf(tree, name)))
            for name in leaves}


def test_group_adam_matches_optax():
    """Two updates of make_optimizer's per-group Adam on the same gradients:
    leaves and moments after each, and the first update reads lr(1)."""
    state, flat = jax_state(3)
    params, _ = jhac.split_state(state)
    opt = jtrain.OptConfig(iterations=1000)
    jopt = jtrain.make_optimizer(opt, 4.2)
    jstate = jopt.init(params)
    tstate = convert.state_from_numpy(flat, TCFG, device="cpu")
    tparams, _ = thac.split_state(tstate)
    leaves = ttrain.param_leaves(tparams)
    topt = ttrain.make_optimizer(ttrain.OptConfig(iterations=1000), 4.2)
    tst = topt.init(leaves)
    rng = np.random.default_rng(0)
    update = jax.jit(jopt.update)
    for _ in range(2):
        # jnp.array copies: jnp.asarray would share the numpy buffer when it
        # happens to be 64-byte aligned, which changes from run to run
        grads = jax.tree_util.tree_map(
            lambda p: jnp.array(rng.normal(size=p.shape).astype(np.float32)
                                * 1e-3), params)
        updates, jstate = jax.block_until_ready(update(grads, jstate, params))
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        tst = topt.update(_carry_moments(grads, leaves), tst, leaves)
        for name, t in leaves.items():
            np.testing.assert_allclose(t.detach().numpy(), jax_leaf(params, name),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
            np.testing.assert_allclose(tst["mu"][name].numpy(),
                                       jax_leaf(jstate[0].mu, name),
                                       rtol=1e-6, atol=1e-10, err_msg=name)
    assert tst["count"] == int(jstate[1]) == 2


def _flat_state(params, rest):
    from gauspcc_tpu.utils.checkpoint import _path_str
    st = jhac.merge_state(params, rest)
    return {_path_str(kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(st)[0]}


@pytest.mark.parametrize("phase", [0, 2])
def test_train_step_matches_jax(phase):
    """From the state, moments and statistics of one JAX step, one more
    step on each side: leaves, moments, statistics and metrics."""
    state, _ = jax_state(4 + phase)
    jcam, _, cam = camera(4 + phase)
    jr, tr = raster_cfgs(cam)
    opt = jtrain.OptConfig(iterations=100)
    jopt = jtrain.make_optimizer(opt, 4.0)
    params, rest = jhac.split_state(state)
    jstate = jopt.init(params)
    stats = jtrain.zero_stats(rest["valid"].shape[0], JCFG.n_offsets)
    step = jtrain.make_train_step(JCFG, jr, jopt, opt, white_background=True)
    params, jstate, stats, _ = step(params, rest, jstate, stats, jcam,
                                    jax.random.PRNGKey(0), phase=phase)
    # carry that state into the port
    tstate = convert.state_from_numpy(_flat_state(params, rest), TCFG, device="cpu")
    tparams, trest = thac.split_state(tstate)
    leaves = ttrain.param_leaves(tparams)
    topt = ttrain.make_optimizer(ttrain.OptConfig(iterations=100), 4.0)
    tst = {"mu": _carry_moments(jstate[0].mu, leaves),
           "nu": _carry_moments(jstate[0].nu, leaves), "count": int(jstate[1])}
    tstats = {k: torch.from_numpy(np.array(v)) for k, v in stats.items()}
    _, tcam, _ = camera(4 + phase)
    key = jax.random.PRNGKey(1)
    params, jstate, stats, metrics = step(params, rest, jstate, stats, jcam,
                                          key, phase=phase)
    tstep = ttrain.make_train_step(TCFG, tr, topt, ttrain.OptConfig(iterations=100),
                                   white_background=True)
    _, tst, tstats, tmetrics = tstep(tparams, trest, tst, tstats, tcam,
                                     phase=phase,
                                     noise=jax_noise(key, state, JCFG))
    assert tst["count"] == int(jstate[1]) == 2
    for name in ("loss", "l1", "psnr", "bit_per_param"):
        np.testing.assert_allclose(float(tmetrics[name]), float(metrics[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    assert int(tmetrics["nonfinite_grads"]) == int(metrics["nonfinite_grads"]) == 0
    for moment, tree in (("mu", jstate[0].mu), ("nu", jstate[0].nu)):
        for name, t in tst[moment].items():
            want = jax_leaf(tree, name)
            np.testing.assert_allclose(
                t.numpy(), want, rtol=GRAD_RTOL,
                atol=GRAD_ATOL * max(float(np.abs(want).max()), 1e-30),
                err_msg=f"{moment} {name}")
    # the leaves differ by lr times the difference of the two sides' Adam
    # directions m_hat / (sqrt(v_hat) + eps), plus float32 rounding of the
    # leaf and of its step
    lrs = {g: f(2) for g, f in topt.group_lr.items()}
    bc1, bc2 = 1 - 0.9 ** 2, 1 - 0.999 ** 2
    for name, t in leaves.items():
        theirs = jax_leaf(jstate[0].mu, name) / bc1 / (
            np.sqrt(jax_leaf(jstate[0].nu, name) / bc2) + 1e-15)
        mine = tst["mu"][name].numpy() / bc1 / (
            np.sqrt(tst["nu"][name].numpy() / bc2) + 1e-15)
        want = jax_leaf(params, name)
        lr = lrs[topt.group_of(name)]
        slack = lr * np.abs(mine - theirs) + 1e-6 * (
            np.abs(want) + lr * np.abs(theirs)) + 1e-9
        assert (np.abs(t.detach().numpy() - want) <= slack).all(), name
    for name, t in tstats.items():
        want = np.asarray(stats[name])
        np.testing.assert_allclose(t.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * max(float(np.abs(want).max()), 1e-30),
                                   err_msg=name)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adjust_both(state, stats_np, opt, rng_seed, jcfg, tcfg, rng_cls=None):
    """adjust_anchor on the JAX state and on its port copy (configs jcfg,
    tcfg), with moments drawn from a seed, and the same numpy rng on each
    side."""
    from gauspcc_tpu.utils.checkpoint import _path_str
    flat = {_path_str(kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(state)[0]}
    params, _ = jhac.split_state(state)
    jopt = jtrain.make_optimizer(opt, 1.0)
    jstate = jopt.init(params)
    mrng = np.random.default_rng(rng_seed + 100)
    mu = jax.tree_util.tree_map(
        lambda p: jnp.asarray(mrng.normal(size=p.shape).astype(np.float32)), params)
    nu = jax.tree_util.tree_map(lambda p: p * p, mu)
    jstate = (jstate[0]._replace(mu=mu, nu=nu), jstate[1])
    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    tparams, _ = thac.split_state(tstate)
    leaves = ttrain.param_leaves(tparams)
    tst = {"mu": _carry_moments(mu, leaves), "nu": _carry_moments(nu, leaves),
           "count": 0}
    jstats = {k: jnp.asarray(v) for k, v in stats_np.items()}
    tstats = {k: torch.from_numpy(v.copy()) for k, v in stats_np.items()}
    make_rng = rng_cls or (lambda: np.random.default_rng(rng_seed))
    want = jtrain.adjust_anchor(state, jstats, jstate, jcfg, opt, make_rng())
    got = ttrain.adjust_anchor(tstate, tstats, tst, tcfg,
                               ttrain.OptConfig(**vars(opt)), make_rng())
    return want, got


def _assert_adjust_equal(want, got):
    (wst, wstats, wopt, winfo), (gst, gstats, gopt, ginfo) = want, got
    assert winfo == ginfo
    for name in thac.TRAINABLE_ANCHOR_FIELDS + thac.FROZEN_ANCHOR_FIELDS:
        np.testing.assert_array_equal(gst["anchors"][name].numpy(),
                                      np.asarray(wst["anchors"][name]), err_msg=name)
    np.testing.assert_array_equal(gst["valid"].numpy(), np.asarray(wst["valid"]))
    for name in wstats:
        np.testing.assert_array_equal(gstats[name].numpy(),
                                      np.asarray(wstats[name]), err_msg=name)
    for moment, tree in (("mu", wopt[0].mu), ("nu", wopt[0].nu)):
        for name in thac.TRAINABLE_ANCHOR_FIELDS:
            np.testing.assert_array_equal(
                gopt[moment][f"anchors/{name}"].numpy(),
                np.asarray(tree["anchors"][name]), err_msg=f"{moment} {name}")


@pytest.mark.parametrize("seed", [0, 1])
def test_adjust_anchor_matches_jax_exactly(seed):
    """Growth at every depth, pruning, selective stat resets and the moment
    remap, with statistics drawn so that all of them happen; seed 1 grows
    past the capacity, into the next bucket."""
    state, _ = jax_state(seed, n_pts=300 if seed == 0 else 1000)
    cap, k = state["valid"].shape[0], JCFG.n_offsets
    rng = np.random.default_rng(seed)
    opt = jtrain.OptConfig()
    stats = {
        "opacity_accum": rng.uniform(0, 2, (cap, 1)).astype(np.float32),
        "anchor_demon": rng.integers(0, 200, (cap, 1)).astype(np.float32),
        "offset_gradient_accum": rng.uniform(0, 0.1, (cap * k, 1)).astype(np.float32),
        "offset_denom": rng.integers(0, 120, (cap * k, 1)).astype(np.float32),
    }
    want, got = _adjust_both(state, stats, opt, seed, JCFG, TCFG)
    info = got[3]
    assert info["n_added"] > 0 and info["n_pruned"] > 0
    assert info["recompiled"] == (seed == 1)
    _assert_adjust_equal(want, got)


def _oracle_state(pts):
    """(JAX state, JAX config, port config) of the oracles' tiny scene."""
    cfg_kw = dict(feat_dim=4, n_offsets=2, voxel_size=0.01, update_depth=1,
                  update_init_factor=4, update_hierachy_factor=4,
                  resolutions_3d=(6,), resolutions_2d=(16,),
                  log2_hashmap_size=13, log2_hashmap_size_2d=13)
    jcfg, tcfg = jhac.HACConfig(**cfg_kw), thac.HACConfig(**cfg_kw)
    return jhac.init_state(jax.random.PRNGKey(0), jcfg, pts), jcfg, tcfg


def test_densify_feat_scatter_max_oracle():
    """tests/test_hac_train.py:155 on the port: a grown anchor's feature is
    the element-wise max over every candidate landing in its cell."""
    state, jcfg, tcfg = _oracle_state(np.zeros((2, 3), np.float32))
    cap, k = state["valid"].shape[0], 2
    a = dict(state["anchors"])
    feats = np.zeros((cap, 4), np.float32)
    feats[0] = [1.0, 5.0, 2.0, 0.0]
    feats[1] = [4.0, 0.0, 3.0, 1.0]
    a["anchor_feat"] = jnp.asarray(feats)
    a["scaling"] = jnp.asarray(np.full((cap, 6), np.log(0.04), np.float32))
    off = np.zeros((cap, k, 3), np.float32)
    off[0, 0] = [1.0, 0.0, 0.0]   # -> xyz 0.04 -> growth cell (1, 0, 0)
    off[1, 0] = [1.05, 0.0, 0.0]  # -> xyz 0.042 -> the same cell
    a["offset"] = jnp.asarray(off)
    state = dict(state, anchors=a)
    accum = np.zeros((cap * k, 1), np.float32)
    denom = np.zeros((cap * k, 1), np.float32)
    accum[[0, k]] = 1.0
    denom[[0, k]] = 100.0
    stats = {"opacity_accum": np.zeros((cap, 1), np.float32),
             "anchor_demon": np.zeros((cap, 1), np.float32),
             "offset_gradient_accum": accum, "offset_denom": denom}

    class OnesRng:  # rand_keep = random > 0.5**(i+1) always passes
        def random(self, n):
            return np.ones(n)

    want, got = _adjust_both(state, stats, jtrain.OptConfig(), 0, jcfg,
                                tcfg, OnesRng)
    new_state, _, _, info = got
    assert info["n_added"] == 1 and info["n_pruned"] == 0
    np.testing.assert_allclose(new_state["anchors"]["anchor"][2].numpy(),
                               [0.04, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(new_state["anchors"]["anchor_feat"][2].numpy(),
                               [4.0, 5.0, 3.0, 1.0], atol=1e-6)
    _assert_adjust_equal(want, got)


def test_densify_stats_persist_for_undercounted_entries():
    """tests/test_hac_train.py:213 on the port: only counted anchors and
    growth-counted offset entries restart their accumulators."""
    state, jcfg, tcfg = _oracle_state(
        np.array([[0.0, 0, 0], [0.2, 0, 0], [0.4, 0, 0]], np.float32))
    cap, k = state["valid"].shape[0], 2
    opt = jtrain.OptConfig(densify_grad_threshold=1e9)
    anchor_thresh = opt.update_interval * opt.success_threshold
    offset_thresh = anchor_thresh * 0.5
    demon = np.zeros((cap, 1), np.float32)
    op = np.zeros((cap, 1), np.float32)
    demon[0], op[0] = 0.5 * anchor_thresh, 0.7
    demon[1], op[1] = 2.0 * anchor_thresh, 1e3
    off_den = np.zeros((cap * k, 1), np.float32)
    off_acc = np.zeros((cap * k, 1), np.float32)
    off_den[0], off_acc[0] = 0.9 * offset_thresh, 0.33
    off_den[k], off_acc[k] = 2.0 * offset_thresh, 0.44
    stats = {"anchor_demon": demon, "opacity_accum": op,
             "offset_denom": off_den, "offset_gradient_accum": off_acc}
    want, got = _adjust_both(state, stats, opt, 0, jcfg, tcfg)
    _, new_stats, _, info = got
    assert info["n_added"] == 0 and info["n_pruned"] == 0
    nd = new_stats["anchor_demon"][:, 0].numpy()
    no = new_stats["opacity_accum"][:, 0].numpy()
    assert nd[0] == pytest.approx(0.5 * anchor_thresh) and no[0] == pytest.approx(0.7)
    assert nd[1] == 0.0 and no[1] == 0.0
    nfd = new_stats["offset_denom"][:, 0].numpy()
    nfa = new_stats["offset_gradient_accum"][:, 0].numpy()
    assert nfd[0] == pytest.approx(0.9 * offset_thresh) and nfa[0] == pytest.approx(0.33)
    assert nfd[k] == 0.0 and nfa[k] == 0.0
    _assert_adjust_equal(want, got)


def test_adapt_caps_grows_as_jax_does():
    """From caps of D 2 and K 8, one adapt step on each side gives the same
    caps; the port's loop then stops growing."""
    from gauspcc_tpu.render import raster as jraster
    state, flat = jax_state(7)
    jcam, tcam, cam = camera(7)
    jr = jraster.RasterConfig(32, 32, cam.tanfovx, cam.tanfovy,
                              max_gaussians_per_tile=8, max_tiles_per_gaussian=2)
    tr = tpipeline._raster_cfg(cam, 8, 2)
    want, wgrew = jpipeline.adapt_caps(state, JCFG, jr, jcam, log=lambda *a: None)
    tstate = convert.state_from_numpy(flat, TCFG, device="cpu")
    got, grew = tpipeline.adapt_caps(tstate, TCFG, tr, tcam, log=lambda *a: None)
    assert grew == wgrew and grew
    assert (got.max_tiles_per_gaussian, got.max_gaussians_per_tile) == (
        want.max_tiles_per_gaussian, want.max_gaussians_per_tile)
    for _ in range(10):
        got, grew = tpipeline.adapt_caps(tstate, TCFG, got, tcam,
                                         log=lambda *a: None, max_d=16, max_k=512)
        if not grew:
            break
    assert not grew


def test_train_scene_on_cpu_lowers_the_loss():
    """A few CPU steps of train_scene on a small soak scene, with the soak's
    compressed schedule reaching phase 2 and two densifications: finite,
    falling loss, bits per parameter in phase 2, the anchors grow."""
    scene = tsoak.build_scene(np.random.default_rng(0), 32, 150, 9, 400,
                              device="cpu")
    opt = ttrain.OptConfig(iterations=40, start_stat=2, update_from=5,
                           update_interval=10, update_until=25)
    logs = []
    state, res = tpipeline.train_scene(
        scene, TCFG, opt, white_background=True, device="cpu", log_every=0,
        phase_of_step=tsoak.compressed_phase_schedule(40), log=logs.append)
    h = res["history"]
    assert list(np.unique(h["phase"])) == [0, 1, 2]
    assert np.isfinite(h["loss"]).all() and h["nonfinite_grads"].sum() == 0
    assert (h["bit_per_param"][h["phase"] == 2] > 0).all()
    assert [it for it, _ in res["densify"]] == [10, 20]
    assert int(state["valid"].sum()) > int(logs[0].split()[-1])
    # the objective on every training view, before and after
    pts = thac.voxelize_points(scene.points, TCFG.voxel_size, 0)
    init = thac.update_anchor_bound(thac.init_state(
        TCFG, pts, np.random.default_rng(0), device="cpu"))
    rcfg = res["rcfg"]

    def mean_loss(st):
        params, rest = thac.split_state(st)
        with torch.no_grad():
            return np.mean([float(trender.training_loss(
                params, rest, TCFG,
                trender.CameraArrays.from_camera(c, "cpu", with_image=True),
                rcfg, torch.ones(3), 0, None, None, opt.lmbda)[0])
                for c in scene.train_cameras])

    assert mean_loss(state) < 0.9 * mean_loss(init)


def test_select_eval_k_matches_jax_and_drives_evaluate():
    """The smallest K whose render matches the 2K render to 45 dB, from K 4
    on a 32x32 view, as JAX picks it; evaluate(auto_k=True) renders at the
    K select_eval_k picks."""
    state, flat = jax_state(8)
    _, _, cam = camera(8)
    from gauspcc_tpu.data.cameras import Camera as JCamera
    jc = JCamera(uid=0, R=cam.R, T=cam.T, fovx=cam.fovx, fovy=cam.fovy,
                 width=32, height=32)
    want = jpipeline.select_eval_k(state, JCFG, jc, start_k=4, max_k=64)
    tstate = convert.state_from_numpy(flat, TCFG, device="cpu")
    got = tpipeline.select_eval_k(tstate, TCFG, cam, start_k=4, max_k=64)
    assert got == want and 4 < got <= 64
    res = tpipeline.evaluate(tstate, TCFG, [cam], auto_k=True)
    assert res["eval_k"] == tpipeline.select_eval_k(tstate, TCFG, cam)


@pytest.mark.parametrize("auto_k", [True, False])
def test_evaluate_picks_k_and_d_as_jax_does(tmp_path, auto_k):
    """evaluate's caps on the same state and camera: by default (auto_k)
    select_eval_k's K and select_eval_d's D, else K 256 and D 32, as the
    JAX package's evaluate (pipeline.py:447-458) picks them."""
    state, flat = jax_state(9)
    _, _, cam = camera(9)
    from gauspcc_tpu.data.cameras import Camera as JCamera
    jc = JCamera(uid=0, R=cam.R, T=cam.T, fovx=cam.fovx, fovy=cam.fovy,
                 width=32, height=32, image=cam.image)
    want = jpipeline.evaluate(state, JCFG, [jc], str(tmp_path), auto_k=auto_k)
    tstate = convert.state_from_numpy(flat, TCFG, device="cpu")
    got = tpipeline.evaluate(tstate, TCFG, [cam],
                             **({} if auto_k else {"auto_k": False}))
    assert (got["eval_k"], got["eval_d"]) == (want["eval_k"], want["eval_d"])
    if auto_k:
        assert got["eval_d"] == tpipeline.select_eval_d(tstate, TCFG, [cam]) < 32
    else:
        assert (got["eval_k"], got["eval_d"]) == (256, 32)
