"""TC-GS in the port (gauspcc_tpu_torch/fields/triplane.py,
gauspcc_tpu_torch/models/tcgs/model.py and render.py) against the JAX
package's, on the CPU, at the size of tests/test_tcgs.py:17-21: feat_dim
8, 3 offsets, 4 plane channels at 16x16, 2 samples an anchor, a 4-channel
latent. Inputs are drawn from a seed with numpy, weights carried by
`convert.state_from_numpy`, the training noise JAX's own draw.

Tolerances, each with its reason:
- contract, grid_sample_2d and sample_triplane, and their gradients: atol
  1e-6 (the same float32 operations in the same order; the square root
  correctly rounded on both sides);
- the autoencoder, decode_latent and the gradient of its L1 loss: atol
  1e-5 (convolutions of two libraries, summed in another order);
- knn_positions: exactly (the same cKDTree query);
- the triplane context and mlp_triplane's heads: atol 1e-5 (float32 GEMMs
  of two libraries);
- training_loss and every gradient, and one train step: those of
  tests/test_torch_train.py and tests/test_torch_train_step.py (loss rtol
  1e-5; a gradient leaf atol 2e-4 of its largest |gradient| plus rtol
  1e-3); JAX jits the loss, and XLA's fused contraction rounds an ulp
  apart from op-by-op arithmetic now and then. From phase 2 each gradient
  element may also differ by the rate's float32 conditioning, measured on
  both sides against the port's float64 rate (`rate_conditioning`): a
  texel of the 16x16 planes sums the rate gradients of a few anchors, and
  one anchor of the phase-2 state has a scaling bin of small likelihood
  whose gradient is 0.4-0.6% off the float64 value on each side (JAX
  6.0126e-3, the port 5.9538e-3, float64 5.9770e-3).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.fields import triplane as jtri
from gauspcc_tpu.models.hac import model as jhac
from gauspcc_tpu.models.hac import train as jtrain
from gauspcc_tpu.models.tcgs import model as jtcgs
from gauspcc_tpu.models.tcgs import render as jrender

from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.fields import triplane as tri
from gauspcc_tpu_torch.models.hac import model as thac
from gauspcc_tpu_torch.models.hac import train as ttrain
from gauspcc_tpu_torch.models.tcgs import model as tcgs
from gauspcc_tpu_torch.models.tcgs import render

from test_torch_hac_plus import assert_grads_close, flat_of, jax_leaf
from test_torch_train import (GRAD_ATOL, GRAD_RTOL, LMBDA, LOSS_RTOL, camera,
                              jax_noise, raster_cfgs)

SMALL = dict(feat_dim=8, n_offsets=3, voxel_size=0.05, tri_feat=4,
             tri_res=16, tri_samples=2, ae_compressed=4)
SAMPLE_ATOL = 1e-6
AE_ATOL = 1e-5
CTX_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for the module: the lane runs 6 workers
    on a few cores, where torch's thread pool oversubscribes them and
    loops of small-tensor ops slow down tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(knn: bool = False):
    return (jtcgs.TCGSConfig(**SMALL, knn_sampling=knn),
            tcgs.TCGSConfig(**SMALL, knn_sampling=knn))


def jax_state(seed=0, n_pts=300, spread=0.6, every_row=True, knn=False):
    """A JAX TC-GS state: seeded, its features, offsets and masks drawn
    from the seed (every capacity row, or the live rows as
    tests/test_tcgs.py draws them), and its flat arrays."""
    jcfg, _ = configs(knn)
    rng = np.random.default_rng(seed)
    pts = jhac.voxelize_points(
        (rng.random((n_pts, 3)) * 2 * spread - spread).astype(np.float32),
        jcfg.voxel_size)
    state = jtcgs.init_state(jax.random.PRNGKey(seed), jcfg, pts)
    rows = state["valid"].shape[0] if every_row else pts.shape[0]
    a = dict(state["anchors"])
    for name, mu, sd, shape in (("anchor_feat", 0, 0.5, (rows, jcfg.feat_dim)),
                                ("offset", 0, 0.3, (rows, jcfg.n_offsets, 3)),
                                ("mask", 1.0, 2.0, (rows, jcfg.n_offsets, 1))):
        a[name] = a[name].at[:rows].set(
            jnp.asarray(rng.normal(mu, sd, shape).astype(np.float32)))
    state = jhac.update_anchor_bound(dict(state, anchors=a))
    return state, flat_of(state)


def port_ae(params: dict, cfg: tri.AEConfig) -> tri.Autoencoder:
    """The JAX autoencoder's weights in the port's module."""
    ae = tri.Autoencoder(cfg)
    with torch.no_grad():
        for name, conv in ae.named_children():
            conv.w.copy_(torch.tensor(np.asarray(params[name]["w"])))
            conv.b.copy_(torch.tensor(np.asarray(params[name]["b"])))
    return ae


def test_contract_and_its_gradient_match_jax():
    """Inside, on and outside the unit ball, at 0 and at |x| = 1 exactly."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1.2, (2000, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 0, 0], [0, -1, 0], [0.6, 0.8, 0]]
    x[4:8] = x[4:8] * 1e-5
    w = rng.normal(size=x.shape).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(jtri.contract(v) * w))(jnp.asarray(x))
    want = np.asarray(jtri.contract(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    got = tri.contract(t)
    (g,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), t)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=SAMPLE_ATOL, rtol=0)
    np.testing.assert_array_equal(got.detach().numpy()[:4], x[:4])
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=SAMPLE_ATOL, rtol=0)
    assert np.linalg.norm(got.detach().numpy(), axis=1).max() < 2.0


def test_grid_sample_and_its_plane_gradient_match_jax():
    """Inside the plane, on its border, outside it and at pixel centres;
    the gradient with respect to the plane (a scatter-add)."""
    rng = np.random.default_rng(1)
    c, h, w = 5, 12, 16
    plane = rng.normal(size=(c, h, w)).astype(np.float32)
    inside = rng.uniform(-1, 1, (400, 2))
    outside = rng.uniform(-1.6, 1.6, (400, 2))
    # pixel centres: u = (2 i + 1) / W - 1
    centres = np.stack([(2 * rng.integers(0, w, 100) + 1) / w - 1,
                        (2 * rng.integers(0, h, 100) + 1) / h - 1], -1)
    border = np.array([[-1, -1], [1, 1], [-1, 1], [1, -1], [-1, 0.3],
                       [0.2, 1], [1 - 1 / w, 0], [-1 + 1 / w, 0],
                       [5, 5], [-5, 0]])
    uv = np.concatenate([inside, outside, centres, border]).astype(np.float32)
    wgt = rng.normal(size=(uv.shape[0], c)).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(
        jtri.grid_sample_2d(p, jnp.asarray(uv)) * wgt))(jnp.asarray(plane))
    want = np.asarray(jtri.grid_sample_2d(jnp.asarray(plane), jnp.asarray(uv)))
    tp = torch.from_numpy(plane).requires_grad_(True)
    got = tri.grid_sample_2d(tp, torch.from_numpy(uv))
    (g,) = torch.autograd.grad((got * torch.from_numpy(wgt)).sum(), tp)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=SAMPLE_ATOL, rtol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=SAMPLE_ATOL, rtol=0)
    # a pixel centre reads its pixel alone; far outside reads zeros
    i, j = 3, 7
    at = torch.tensor([[(2 * j + 1) / w - 1, (2 * i + 1) / h - 1]])
    np.testing.assert_allclose(tri.grid_sample_2d(tp, at)[0].detach().numpy(),
                               plane[:, i, j], atol=SAMPLE_ATOL)
    assert not got[-2:].detach().any()


@pytest.mark.parametrize("apply_contract", [True, False])
def test_sample_triplane_matches_jax(apply_contract):
    rng = np.random.default_rng(2)
    planes = (rng.normal(size=(3, 4, 16, 16)) * 0.1).astype(np.float32)
    coords = rng.uniform(-1.8, 1.8, (3000, 3)).astype(np.float32)
    want = np.asarray(jtri.sample_triplane(jnp.asarray(planes),
                                           jnp.asarray(coords), apply_contract))
    got = tri.sample_triplane(torch.from_numpy(planes), torch.from_numpy(coords),
                              apply_contract)
    assert got.shape == want.shape == (3000, 12)
    np.testing.assert_allclose(got.numpy(), want, atol=SAMPLE_ATOL, rtol=0)


def test_autoencoder_and_its_gradients_match_jax():
    """autoencode, decode_latent, and the gradient of lae (the L1 between
    the planes and their reconstruction) with respect to every weight and
    to the planes."""
    cfg = jtri.AEConfig(feat=4, compressed_dim=4)
    params = jtri.init_autoencoder(jax.random.PRNGKey(0), cfg)
    planes = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (3, 4, 16, 16)))

    def lae(p, x):
        return jnp.mean(jnp.abs(x - jtri.autoencode(p, x)[1]))

    (jg_p, jg_x) = jax.grad(lae, argnums=(0, 1))(params, jnp.asarray(planes))
    z, r = jtri.autoencode(params, jnp.asarray(planes))
    ae = port_ae(params, tri.AEConfig(4, 4))
    tx = torch.from_numpy(planes.copy()).requires_grad_(True)
    tz, tr = tri.autoencode(ae, tx)
    assert tuple(tz.shape) == (3, 4, 2, 2) and tr.shape == tx.shape
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(z), atol=AE_ATOL)
    np.testing.assert_allclose(tr.detach().numpy(), np.asarray(r), atol=AE_ATOL)
    np.testing.assert_allclose(
        tri.decode_latent(ae, tz).detach().numpy(),
        np.asarray(jtri.decode_latent(params, z)), atol=AE_ATOL)
    leaves = dict(ae.named_parameters())
    got = torch.autograd.grad((tx - tr).abs().mean(), [*leaves.values(), tx])
    for (name, _), g in zip(leaves.items(), got):
        layer, which = name.split(".")
        np.testing.assert_allclose(g.numpy(), np.asarray(jg_p[layer][which]),
                                   atol=AE_ATOL, err_msg=name)
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(jg_x), atol=AE_ATOL)


def test_knn_positions_equal_jax():
    rng = np.random.default_rng(3)
    pts = np.round(rng.uniform(-1, 1, (500, 3)) / 0.05).astype(np.float32) * 0.05
    for k in (2, 4):
        got = tcgs.knn_positions(pts, k)
        np.testing.assert_array_equal(got, jtcgs.knn_positions(pts, k))
        assert got.shape == (500, k, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got[:, 0], pts)  # itself first
    few = pts[:3]  # below k anchors: each repeated
    np.testing.assert_array_equal(tcgs.knn_positions(few, 4),
                                  jtcgs.knn_positions(few, 4))
    np.testing.assert_array_equal(tcgs.knn_positions(few, 4),
                                  np.repeat(few[:, None], 4, axis=1))
    np.testing.assert_array_equal(tcgs.knn_positions(pts[:0], 4),
                                  jtcgs.knn_positions(pts[:0], 4))


@pytest.mark.parametrize("knn", [False, True])
def test_triplane_context_and_heads_match_jax(knn):
    jcfg, tcfg = configs(knn)
    state, flat = jax_state(1, knn=knn)
    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    anchor = np.asarray(jhac.get_anchor(state, jcfg.as_hac()))[:200]
    knn_pos = (jtcgs.knn_positions(anchor, jcfg.tri_samples) if knn else None)
    want = jtcgs.triplane_context(
        state, jcfg, jnp.asarray(anchor),
        knn_pos=None if knn_pos is None else jnp.asarray(knn_pos))
    with torch.no_grad():
        got = tcgs.triplane_context(
            tstate, tcfg, torch.from_numpy(anchor),
            knn_pos=None if knn_pos is None else torch.from_numpy(knn_pos))
        assert got.shape == want.shape == (200, tcfg.ctx_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CTX_ATOL)
        jctx = jtcgs.grid_mlp_split(state, jcfg, want)
        tctx = tcgs.grid_mlp_split(tstate, tcfg, got)
    assert set(tctx) == set(jctx) and len(tctx) == 9
    for k, v in jctx.items():
        np.testing.assert_allclose(tctx[k].numpy(), np.asarray(v), atol=CTX_ATOL,
                                   err_msg=k)
    # the offsets' steps from TC-GS's base, 0.3
    assert float(tctx["q_offsets"].max()) <= 0.6 and tcfg.q_offsets == 0.3


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_training_loss_and_every_gradient_match_jax(phase):
    jcfg, tcfg = configs()
    state, flat = jax_state(10 + phase)
    jcam, tcam, cam = camera(phase)
    jr, tr = raster_cfgs(cam)
    key = jax.random.PRNGKey(30 + phase)
    bg = np.ones(3, np.float32)
    params, rest = jhac.split_state(state)
    m2d = jnp.zeros((rest["valid"].shape[0] * jcfg.n_offsets, 2))
    loss_and_grad = jax.jit(jax.value_and_grad(
        jrender.training_loss, argnums=(0, 8), has_aux=True),
        static_argnums=(2, 4, 6, 9))
    (want_loss, want_aux), (want_g, want_m2d) = loss_and_grad(
        params, rest, jcfg, jcam, jr, jnp.asarray(bg), phase, key, m2d, LMBDA)

    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    tparams, trest = thac.split_state(tstate)
    leaves = ttrain.param_leaves(tparams)
    for t in leaves.values():
        t.requires_grad_(True)
    tm2d = torch.zeros(tuple(m2d.shape), requires_grad=True)
    loss, aux = render.training_loss(
        tparams, trest, tcfg, tcam, tr, torch.from_numpy(bg), phase,
        jax_noise(key, state, jcfg), tm2d, LMBDA)
    got = torch.autograd.grad(loss, [*leaves.values(), tm2d], allow_unused=True)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    for name in ("l1", "ssim", "psnr", "bit_per_param", "lae"):
        np.testing.assert_allclose(float(aux[name]), float(want_aux[name]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=name)
    grads = {n: g if g is not None else torch.zeros_like(t)
             for (n, t), g in zip(leaves.items(), got[:-1])}
    moved = {part: any(float(g.abs().max()) > 0 for n, g in grads.items()
                       if n.startswith(f"nets/{part}"))
             for part in ("planes", "mlp_triplane", "autoencoder")}
    assert moved == {"planes": phase >= 2, "mlp_triplane": phase >= 2,
                     "autoencoder": phase >= 3}
    assert (float(aux["bit_per_param"]) > 0) == (phase >= 2)
    assert (float(aux["lae"]) > 0) == (phase >= 3)
    slack = {}
    if phase >= 2:
        vis = np.asarray(want_aux["visible_anchor"])

        def jax_rate(p):
            return jrender.generate_neural_gaussians(
                jhac.merge_state(p, rest), jcfg, jcam.camera_center, vis,
                training=True, phase=phase, key=key)[1]["bit_per_param"]

        slack = rate_conditioning(flat, tcfg, tcam, torch.from_numpy(vis),
                                  jax_noise(key, state, jcfg), phase,
                                  jax.jit(jax.grad(jax_rate))(params))
    for name, g in grads.items():
        want = jax_leaf(want_g, name)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = np.abs(g.detach().numpy() - want)
        bound = GRAD_RTOL * np.abs(want) + GRAD_ATOL * scale + slack.get(name, 0.0)
        assert (err <= bound).all(), (name, float((err - bound).max()), scale)
    scale = float(np.abs(np.asarray(want_m2d)).max())
    assert scale > 0
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want_m2d),
                               rtol=1e-3, atol=2e-4 * scale)
    for name in ("visible_anchor", "g_valid", "radii"):
        np.testing.assert_array_equal(aux[name].numpy(), np.asarray(want_aux[name]))


def rate_conditioning(flat, tcfg, tcam, visible, noise, phase,
                      jax_rate_grad) -> dict:
    """Per leaf, lmbda times the float32 errors of the rate's gradient on
    both sides, each against the port's float64 gradient: |port float32 -
    float64| + |JAX float32 - float64|. A bin's gradient is a difference
    of CDFs over its likelihood L, so it carries a relative error of about
    2^-23 / L in float32 (see tests/test_torch_hac_plus.py), on each side;
    the rest of the loss's gradient must then agree to the leaf's
    tolerance."""
    grads = {}
    for dtype in (torch.float32, torch.float64):
        st = convert.state_from_numpy(flat, tcfg, device="cpu")
        st = dict(st, anchors={k: v.to(dtype) for k, v in st["anchors"].items()},
                  nets=st["nets"].to(dtype),
                  **{k: st[k].to(dtype) for k in ("x_bound_min", "x_bound_max")})
        params, _ = thac.split_state(st)
        leaves = ttrain.param_leaves(params)
        for t in leaves.values():
            t.requires_grad_(True)
        _, rate, _ = render.generate_neural_gaussians(
            st, tcfg, tcam.camera_center.to(dtype), visible, training=True,
            phase=phase, noise=tuple(u.to(dtype) for u in noise))
        got = torch.autograd.grad(rate["bit_per_param"], list(leaves.values()),
                                  allow_unused=True)
        grads[dtype] = {n: g.double() for n, g in zip(leaves, got)
                        if g is not None}
    exact = {n: g.numpy() for n, g in grads[torch.float64].items()}
    return {n: LMBDA * (np.abs(g.numpy() - exact[n])
                        + np.abs(jax_leaf(jax_rate_grad, n) - exact[n]))
            for n, g in grads[torch.float32].items()}


def test_train_step_with_the_tcgs_objective_matches_jax():
    """One step of make_train_step(loss_fn=TC-GS's) at phase 3 from fresh
    moments on each side, as tests/test_torch_hac_plus.py holds HAC++'s:
    metrics, first moments, leaves; planes, autoencoder and mlp_triplane
    take mlp_grid's learning rate, as in the JAX package."""
    jcfg, tcfg = configs()
    state, flat = jax_state(17)
    jcam, tcam, cam = camera(17)
    jr, tr = raster_cfgs(cam)
    opt = jtrain.OptConfig(iterations=100)
    jopt = jtrain.make_optimizer(opt, 4.0)
    params, rest = jhac.split_state(state)
    jstats = jtrain.zero_stats(rest["valid"].shape[0], jcfg.n_offsets)
    step = jtrain.make_train_step(jcfg, jr, jopt, opt,
                                  loss_fn=jrender.training_loss,
                                  white_background=True)
    key = jax.random.PRNGKey(5)
    jparams, jst, _, metrics = step(params, rest, jopt.init(params), jstats,
                                    jcam, key, phase=3)

    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    tparams, trest = thac.split_state(tstate)
    leaves = ttrain.param_leaves(tparams)
    topt = ttrain.make_optimizer(ttrain.OptConfig(iterations=100), 4.0)
    tst = topt.init(leaves)
    tstats = ttrain.zero_stats(trest["valid"].shape[0], tcfg.n_offsets)
    tstep = ttrain.make_train_step(tcfg, tr, topt, ttrain.OptConfig(iterations=100),
                                   loss_fn=render.training_loss,
                                   white_background=True)
    _, tst, _, tmetrics = tstep(tparams, trest, tst, tstats, tcam, phase=3,
                                noise=jax_noise(key, state, jcfg))
    for name in ("loss", "l1", "psnr", "bit_per_param"):
        np.testing.assert_allclose(float(tmetrics[name]), float(metrics[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    assert int(tmetrics["nonfinite_grads"]) == int(metrics["nonfinite_grads"]) == 0
    for name in ("nets/planes", "nets/autoencoder/enc0/w",
                 "nets/autoencoder/dec2/b", "nets/mlp_triplane/fc1/weight"):
        assert name in leaves and topt.group_of(name) == "mlp_grid", name
    assert_grads_close(tst["mu"], jst[0].mu)
    lrs = {g: f(1) for g, f in topt.group_lr.items()}
    bc1, bc2 = 0.1, 0.001
    for name, t in leaves.items():
        theirs = jax_leaf(jst[0].mu, name) / bc1 / (
            np.sqrt(jax_leaf(jst[0].nu, name) / bc2) + 1e-15)
        mine = tst["mu"][name].numpy() / bc1 / (
            np.sqrt(tst["nu"][name].numpy() / bc2) + 1e-15)
        want = jax_leaf(jparams, name)
        lr = lrs[topt.group_of(name)]
        slack = lr * np.abs(mine - theirs) + 1e-6 * (
            np.abs(want) + lr * np.abs(theirs)) + 1e-9
        assert (np.abs(t.detach().numpy() - want) <= slack).all(), name


def test_state_from_numpy_takes_tcgs_keys():
    jcfg, tcfg = configs()
    state, flat = jax_state(4)
    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    nets = tstate["nets"]
    for gone in ("tables", "mlp_grid", "mlp_deform"):
        assert not hasattr(nets, gone)
    assert tuple(nets.planes.shape) == (3, 4, 16, 16)
    for name, p in ttrain.param_leaves({"anchors": {}, "nets": nets}).items():
        np.testing.assert_array_equal(p.detach().numpy(), jax_leaf(state, name),
                                      err_msg=name)
    # mlp_triplane counts, the planes and the autoencoder do not
    assert thac.mlp_size_bits(tstate) == jhac.mlp_size_bits(state)
    for key in ("nets/planes", "nets/autoencoder/dec1/w",
                "nets/mlp_triplane/fc0/b"):
        with pytest.raises(KeyError):
            convert.state_from_numpy({k: v for k, v in flat.items() if k != key},
                                     tcfg, device="cpu")
    with pytest.raises(KeyError):
        convert.state_from_numpy(dict(flat, **{"nets/mlp_grid/fc0/w": np.zeros(
            (1, 1), np.float32)}), tcfg, device="cpu")


def test_full_width_sizes_equal_the_r5_record():
    """At TCGSConfig's full width the networks are 1,636,320 bits and the
    f16 latent 6,144, as runs/soak_tcgs_r5/soak_summary.json records."""
    import json
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "..", "runs", "soak_tcgs_r5",
                           "soak_summary.json")) as f:
        record = json.load(f)["size_bits"]
    cfg = tcgs.TCGSConfig()
    nets = tcgs.TCGSNets(cfg)
    assert thac.mlp_size_bits({"nets": nets}) == record["mlps"] == 1_636_320
    with torch.no_grad():
        latent, recon = tri.autoencode(nets.autoencoder, nets.planes)
    assert latent.numel() * 16 == record["triplane"] == 6_144
    assert recon.shape == nets.planes.shape
