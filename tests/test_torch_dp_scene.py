"""Port parity: the data-parallel scene step
(gauspcc_tpu_torch.parallel.dp_scene) against the JAX package's
gauspcc_tpu/parallel/dp_scene.py, on gloo ranks on the CPU, at the 32x32
`SMALL` config of tests/test_torch_train.py.

The JAX side is dp_scene.py:41-77 written out without a mesh: per camera
`jax.value_and_grad` of `training_loss` with respect to the leaves and
`means2d_extra` (argnums 0 and 8; jitted once for the file, on a black
background, as JAX's DP step renders), the mean of the gradients, JAX's
`make_optimizer` update, and the four statistics summed over the cameras.
Each rank's quantization noise is JAX's own draw from that rank's key
(`jax_noise`), handed to the rank.

Tolerances (tests/test_torch_train_step.py's): the metrics rtol 1e-5; the
moments and the statistics atol 2e-4 of the largest plus rtol 1e-3; each
leaf lr times the difference of the two sides' Adam directions plus 1e-6
of the leaf and its step. The port's `offset_gradient_accum` keeps the
single step's NDC scale, which JAX's DP step lacks (dp_scene.py:62): on
these square frames it is W/2 = 16 times JAX's DP value. The ranks' leaves
are bitwise equal; a one-rank DP step equals `make_train_step` bit for bit
(it is the single step's code)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.data.cameras import Camera as JCamera
from gauspcc_tpu.models.hac import model as jhac
from gauspcc_tpu.models.hac import render as jrender
from gauspcc_tpu.models.hac import train as jtrain

from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.cli import soak as tsoak
from gauspcc_tpu_torch.models.hac import model as thac
from gauspcc_tpu_torch.models.hac import render as trender
from gauspcc_tpu_torch.models.hac import train as ttrain
from gauspcc_tpu_torch.parallel import dist as pdist
from gauspcc_tpu_torch.parallel import dp_scene

from test_torch_train import (GRAD_ATOL, GRAD_RTOL, HW, JCFG, TCFG, jax_leaf,
                              jax_noise, jax_state, raster_cfgs)

PHASE = 2
SCALE = 4.0  # spatial_lr_scale
OPT = dict(iterations=100, lmbda=1e-3)


def _cameras(n):
    """n orbit cameras at 32x32 with seeded ground truth, as JAX and port
    CameraArrays."""
    jcams, tcams = [], []
    for i, ang in enumerate(np.linspace(0.3, 1.3, n)):
        c = tsoak._orbit_camera(i, ang, HW, radius=2.2)
        c.image = np.random.default_rng(10 + i).random((3, HW, HW)).astype(np.float32)
        jc = JCamera(uid=i, R=c.R, T=c.T, fovx=c.fovx, fovy=c.fovy, width=HW,
                     height=HW, image=c.image)
        jcams.append(jrender.CameraArrays.from_camera(jc))
        tcams.append(trender.CameraArrays.from_camera(c, "cpu", with_image=True))
    return jcams, tcams, c


@pytest.fixture(scope="module")
def jax_step():
    """The JAX state, its flat arrays, two cameras, two keys, and the
    per-camera value_and_grad (compiled once)."""
    state, flat = jax_state(5)
    jcams, tcams, cam = _cameras(2)
    jr, tr = raster_cfgs(cam)
    vg = jax.jit(jax.value_and_grad(jrender.training_loss, argnums=(0, 8),
                                    has_aux=True), static_argnums=(2, 4, 6))
    keys = [jax.random.PRNGKey(20 + r) for r in range(2)]
    return state, flat, jcams, tcams, jr, tr, vg, keys


def _jax_dp_step(state, jcams, jr, vg, keys):
    """dp_scene.py:41-77 without a mesh: (params, opt_state, stats,
    metrics)."""
    params, rest = jhac.split_state(state)
    opt = jtrain.OptConfig(**OPT)
    optimizer = jtrain.make_optimizer(opt, SCALE)
    m2d = jnp.zeros((rest["valid"].shape[0] * JCFG.n_offsets, 2))
    outs = [vg(params, rest, JCFG, c, jr, jnp.zeros(3), PHASE, k, m2d,
               opt.lmbda, opt.lambda_dssim) for c, k in zip(jcams, keys)]
    grads = jax.tree_util.tree_map(lambda *g: sum(g) / len(g),
                                   *[o[1][0] for o in outs])
    updates, opt_state = optimizer.update(grads, optimizer.init(params), params)
    params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    k = JCFG.n_offsets
    stats = {n: 0.0 for n in ("opacity_accum", "anchor_demon",
                              "offset_gradient_accum", "offset_denom")}
    for (_, aux), (_, g_m2d) in outs:
        vis = aux["visible_anchor"] & rest["valid"]
        opac = jnp.maximum(aux["neural_opacity"].reshape(-1, k), 0.0)
        uf = aux["g_valid"] & (aux["radii"] > 0)
        gnorm = jnp.linalg.norm(g_m2d, axis=-1, keepdims=True)
        stats["opacity_accum"] += jnp.where(vis[:, None],
                                            jnp.sum(opac, 1, keepdims=True), 0.0)
        stats["anchor_demon"] += vis[:, None].astype(jnp.float32)
        stats["offset_gradient_accum"] += jnp.where(uf[:, None], gnorm, 0.0)
        stats["offset_denom"] += uf[:, None].astype(jnp.float32)
    metrics = {n: np.mean([float(o[0][1][n] if n != "loss" else o[0][0])
                           for o in outs]) for n in ("loss", "psnr")}
    return params, opt_state, stats, metrics


def _close(got, want, name):
    np.testing.assert_allclose(
        got, want, rtol=GRAD_RTOL,
        atol=GRAD_ATOL * max(float(np.abs(want).max()), 1e-30), err_msg=name)


def test_dp_scene_step_on_two_ranks_matches_jax(tmp_path, jax_step):
    state, flat, jcams, tcams, jr, tr, vg, keys = jax_step
    tstate = convert.state_from_numpy(flat, TCFG, device="cpu")
    noise = [jax_noise(k, state, JCFG) for k in keys]
    stacked = tuple(torch.stack([n[i] for n in noise]) for i in range(3))
    in_path = str(tmp_path / "inputs.npz")
    pdist.write_inputs(in_path, scene=dp_scene.scene_inputs(
        tstate, TCFG, "hac", tcams, tr, ttrain.OptConfig(**OPT), SCALE, PHASE,
        noise=stacked))
    pdist.launch((dp_scene.rank_main,), 2, "gloo", "cpu", in_path, str(tmp_path))
    outs = []
    for r in range(2):
        with np.load(pdist.output_path(str(tmp_path), "scene", r)) as f:
            outs.append({k: f[k] for k in f.files})
    for k, v in outs[0].items():
        if k.startswith(("leaf/", "mu/", "nu/", "stat/")):
            np.testing.assert_array_equal(outs[1][k], v, err_msg=k)
    got = outs[0]

    params, opt_state, stats, metrics = _jax_dp_step(state, jcams, jr, vg, keys)
    for name in ("loss", "psnr"):
        np.testing.assert_allclose(got[name], metrics[name], rtol=1e-5,
                                   err_msg=name)
    assert int(got["nonfinite_grads"]) == 0 and int(got["count"]) == 1
    names = [k[len("leaf/"):] for k in got if k.startswith("leaf/")]
    for name in names:
        _close(got[f"mu/{name}"], jax_leaf(opt_state[0].mu, name), f"mu {name}")
        _close(got[f"nu/{name}"], jax_leaf(opt_state[0].nu, name), f"nu {name}")
    # the leaves: lr times the two sides' Adam directions' difference, plus
    # float32 rounding of the leaf and its step (count 1: m_hat = mu / 0.1)
    lrs = {g: f(1) for g, f in ttrain.make_optimizer(
        ttrain.OptConfig(**OPT), SCALE).group_lr.items()}
    group_of = ttrain.make_optimizer(ttrain.OptConfig(**OPT), SCALE).group_of
    bc1, bc2 = 0.1, 1 - 0.999
    for name in names:
        theirs = jax_leaf(opt_state[0].mu, name) / bc1 / (
            np.sqrt(jax_leaf(opt_state[0].nu, name) / bc2) + 1e-15)
        mine = got[f"mu/{name}"] / bc1 / (np.sqrt(got[f"nu/{name}"] / bc2) + 1e-15)
        want = jax_leaf(params, name)
        lr = lrs[group_of(name)]
        slack = lr * np.abs(mine - theirs) + 1e-6 * (
            np.abs(want) + lr * np.abs(theirs)) + 1e-9
        assert (np.abs(got[f"leaf/{name}"] - want) <= slack).all(), name
    # the statistics: the two cameras' increments summed; the port's
    # gradient norm NDC-scaled by W/2 = H/2 = 16
    ndc = {"offset_gradient_accum": HW / 2}
    for name, want in stats.items():
        _close(got[f"stat/{name}"], np.asarray(want) * ndc.get(name, 1.0), name)
    assert float(got["stat/anchor_demon"].max()) >= 2.0
    assert float(got["stat/offset_gradient_accum"].max()) > 0


def test_one_rank_dp_step_equals_make_train_step(tmp_path, jax_step):
    """A one-rank DP step (in this process, gloo) and the single step from
    the same state, camera and noise: every leaf, moment, statistic and
    metric bit for bit, and the DP step's gradients those of the single
    step's body (`step_gradients`) on that state."""
    state, flat, _, tcams, _, tr, _, keys = jax_step
    noise = jax_noise(keys[0], state, JCFG)
    opt = ttrain.OptConfig(**OPT)
    runs = []
    params, rest = thac.split_state(convert.state_from_numpy(flat, TCFG,
                                                             device="cpu"))
    single = ttrain.step_gradients(TCFG, tr, opt, params, rest, tcams[0],
                                   PHASE, noise).grads
    for dp in (False, True):
        tstate = convert.state_from_numpy(flat, TCFG, device="cpu")
        params, rest = thac.split_state(tstate)
        optimizer = ttrain.make_optimizer(opt, SCALE)
        opt_state = optimizer.init(ttrain.param_leaves(params))
        stats = ttrain.zero_stats(rest["valid"].shape[0], TCFG.n_offsets)
        if dp:
            torch.distributed.init_process_group(
                "gloo", init_method=f"file://{tmp_path}/rdzv", rank=0,
                world_size=1)
            try:
                step = dp_scene.make_dp_scene_step(TCFG, tr, optimizer, opt)
                out = step(params, rest, opt_state, stats,
                           dp_scene.stack_cameras(tcams[:1]), phase=PHASE,
                           noise=tuple(n[None] for n in noise))
            finally:
                torch.distributed.destroy_process_group()
        else:
            step = ttrain.make_train_step(TCFG, tr, optimizer, opt)
            out = step(params, rest, opt_state, stats, tcams[0], phase=PHASE,
                       noise=noise)
        runs.append(out)
    (p1, o1, s1, m1), (p2, o2, s2, m2) = runs
    for name, t in ttrain.param_leaves(p1).items():
        assert torch.equal(t, ttrain.param_leaves(p2)[name]), name
        assert torch.equal(o1["mu"][name], o2["mu"][name]), name
        assert torch.equal(o1["nu"][name], o2["nu"][name]), name
        assert torch.equal(single[name], m2["grads"][name]), name
    for name in s1:
        assert torch.equal(s1[name], s2[name]), name
    for name in ("loss", "l1", "psnr", "bit_per_param", "nonfinite_grads"):
        assert torch.equal(torch.as_tensor(m1[name]),
                           torch.as_tensor(m2[name])), name
    assert o1["count"] == o2["count"] == 1
