"""CAT-3DGS in the port (gauspcc_tpu_torch/models/cat3dgs/arm.py, field.py,
model.py and render.py) against the JAX package's, on the CPU, at the size
of tests/test_cat3dgs.py:18-21: feat_dim 8 in chcm slices (4, 4), 3
offsets, one-channel planes at 16 and 32. Inputs are drawn from a seed
with numpy, weights carried by `convert.state_from_numpy`, the training
noise JAX's own draw.

Tolerances, each with its reason:
- the fixed-point ARM (`_exp_neg_q30`, `_arm_apply_fixed`,
  `_laplace_table_fixed`, `quantize_arm`, `pack_arm`): exactly (integer
  arithmetic);
- the float plane coder's bytes: exactly (the same numpy float32
  arithmetic on the host);
- fit_pca: the same kept points as scikit-learn's LocalOutlierFactor,
  then rotation, mean and std within 1e-6 (in fact equal);
- the ARM's output, plane_rate's mu and scale: atol 1e-6; plane_rate's
  bits rtol 1e-5 (float32 sums in another order); their gradients as the
  training gradients below;
- the quantised planes: exactly where JAX's scaled latent lies more than
  1e-6 from a half-integer (the gain's power may differ by an ulp between
  torch and XLA, and a round at .5 may then go the other way; such
  elements are counted and must be few);
- the sampled features, the hyperprior and the chcm statistics: atol 1e-5
  (float32 GEMMs of two libraries);
- training_loss and every gradient, and one train step: those of
  tests/test_torch_train.py and tests/test_torch_train_step.py (loss rtol
  1e-5; a gradient leaf atol 2e-4 of its largest |gradient| plus rtol
  1e-3), applied after both packages' grad_mask.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.models.cat3dgs import arm as jarm
from gauspcc_tpu.models.cat3dgs import field as jfield
from gauspcc_tpu.models.cat3dgs import model as jcat
from gauspcc_tpu.models.cat3dgs import render as jrender
from gauspcc_tpu.models.hac import model as jhac
from gauspcc_tpu.models.hac import train as jtrain

from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.models.cat3dgs import arm
from gauspcc_tpu_torch.models.cat3dgs import field as cfield
from gauspcc_tpu_torch.models.cat3dgs import model as cat
from gauspcc_tpu_torch.models.cat3dgs import render
from gauspcc_tpu_torch.models.hac import model as thac
from gauspcc_tpu_torch.models.hac import train as ttrain

from test_torch_hac_plus import flat_of
from test_torch_native_libs import ensure_jax_native_libs
from test_torch_tcgs import one_torch_thread  # noqa: F401
from test_torch_train import (GRAD_ATOL, GRAD_RTOL, LMBDA, LOSS_RTOL, camera,
                              jax_noise, raster_cfgs)

ensure_jax_native_libs()  # before any test here loads one

SMALL = dict(feat_dim=8, n_offsets=3, voxel_size=0.05, chcm_slices=(4, 4),
             tri_feat=1, base_resolution=16, multiscale=(1, 2))
ARM_ATOL = 1e-6
BITS_RTOL = 1e-5
CTX_ATOL = 1e-5
PCA_ATOL = 1e-6
HALF_MARGIN = 1e-6


def configs(**kw):
    return jcat.CATConfig(**SMALL, **kw), cat.CATConfig(**SMALL, **kw)


def jax_state(seed=0, n_pts=300, spread=0.6, every_row=True, gains=None, **kw):
    """A JAX CAT-3DGS state: seeded, its anchor bound and PCA frame fitted
    (scikit-learn's LOF), its features, offsets and masks drawn from the
    seed (every capacity row, or the live rows as tests/test_cat3dgs.py
    draws them), `gains` in place of the field's when given; and its flat
    arrays."""
    jcfg, _ = configs(**kw)
    rng = np.random.default_rng(seed)
    pts = jhac.voxelize_points(
        (rng.random((n_pts, 3)) * 2 * spread - spread).astype(np.float32),
        jcfg.voxel_size)
    state = jcat.init_state(jax.random.PRNGKey(seed), jcfg, pts)
    state = jcat.set_pca_frame(jhac.update_anchor_bound(state), jcfg)
    rows = state["valid"].shape[0] if every_row else pts.shape[0]
    a = dict(state["anchors"])
    for name, mu, sd, shape in (("anchor_feat", 0, 0.5, (rows, jcfg.feat_dim)),
                                ("offset", 0, 0.3, (rows, jcfg.n_offsets, 3)),
                                ("mask", 1.0, 2.0, (rows, jcfg.n_offsets, 1))):
        a[name] = a[name].at[:rows].set(
            jnp.asarray(rng.normal(mu, sd, shape).astype(np.float32)))
    state = dict(state, anchors=a)
    if gains is not None:
        nets = dict(state["nets"])
        nets["field"] = dict(nets["field"], gains=jnp.asarray(gains, jnp.float32))
        state = dict(state, nets=nets)
    return state, flat_of(state)


def jax_leaf(tree, name):
    """The JAX leaf of a port leaf name, in the port's layout ([out, in]
    weights); list nodes (the scales, the layers, mlp_chcm) by index."""
    *keys, last = name.split("/")
    node = tree
    for k in keys:
        node = node[int(k)] if isinstance(node, (list, tuple)) else node[k]
    if last == "weight":
        return np.asarray(node["w"]).T
    if last == "bias":
        return np.asarray(node["b"])
    return np.asarray(node[int(last)] if isinstance(node, (list, tuple))
                      else node[last])


def cat_noise(key, state, cfg, phase):
    """The draws JAX's training_loss makes from `key`: HAC's before phase
    2; from phase 2 split(key, 5)'s last three for the attributes and the
    second for the planes, one split a scale."""
    if phase < 2:
        return jax_noise(key, state, cfg)
    _, kq, k1, k2, k3 = jax.random.split(key, 5)
    cap = state["valid"].shape[0]
    u = [np.array(jax.random.uniform(kk, shape, jnp.float32)) for kk, shape in (
        (k1, (cap, cfg.feat_dim)), (k2, (cap, 6)), (k3, (cap, cfg.n_offsets, 3)))]
    planes = []
    for p in state["nets"]["field"]["scales"]:
        kq, sub = jax.random.split(kq)
        planes.append(torch.from_numpy(np.array(jax.random.uniform(
            sub, p.shape, minval=-0.5, maxval=0.5))))
    return (*(torch.from_numpy(x) for x in u), planes)


def port_arm(params: dict) -> arm.ARM:
    """The JAX ARM's weights in the port's module."""
    m = arm.ARM()
    with torch.no_grad():
        for layer, jl in zip(m.layers, params["layers"]):
            (name, lin), = jl.items()
            assert (name == "res_lin") == layer.res
            layer.linear.weight.copy_(torch.tensor(np.asarray(lin["w"]).T))
            layer.linear.bias.copy_(torch.tensor(np.asarray(lin["b"])))
    return m


# ---------------------------------------------------------------------------
# the ARM
# ---------------------------------------------------------------------------

def test_context_is_causal_and_the_waves_are_jax_waves():
    np.testing.assert_array_equal(arm.CTX_OFFSETS, jarm.CTX_OFFSETS)
    for dy, dx in arm.CTX_OFFSETS:  # every neighbour in an earlier wave
        assert arm.WAVE_ROW_OFFSET * dy + dx < 0
    for h, w in ((5, 7), (16, 16), (3, 1)):
        got, want = arm.coding_waves(h, w), jarm.coding_waves(h, w)
        assert len(got) == len(want)
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_arm_forward_plane_rate_and_gradients_match_jax():
    """arm_apply over extract_context, plane_rate's bits, mu and scale,
    and the gradients of the bits with respect to the latent and every
    ARM weight."""
    params = jarm.init_arm(jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    latent = (np.round(rng.normal(0, 2.0, (20, 24)))
              + rng.uniform(-0.5, 0.5, (20, 24))).astype(np.float32)
    latent[0, :4] = [0.0, 0.5, -0.5, 1.0]
    jb, jmu, jsc = jarm.plane_rate(params, jnp.asarray(latent))
    jg_p, jg_x = jax.grad(lambda p, x: jarm.plane_rate(p, x)[0],
                          argnums=(0, 1))(params, jnp.asarray(latent))
    m = port_arm(params)
    x = torch.from_numpy(latent).requires_grad_(True)
    ctx = arm.extract_context(x)
    np.testing.assert_array_equal(ctx.detach().numpy(),
                                  np.asarray(jarm.extract_context(jnp.asarray(latent))))
    np.testing.assert_allclose(
        arm.arm_apply(m, ctx).detach().numpy(),
        np.asarray(jarm.arm_apply(params, jnp.asarray(ctx.detach().numpy()))),
        atol=ARM_ATOL)
    bits, mu, sc = arm.plane_rate(m, x)
    np.testing.assert_allclose(float(bits.detach()), float(jb), rtol=BITS_RTOL)
    np.testing.assert_allclose(mu.detach().numpy(), np.asarray(jmu), atol=ARM_ATOL)
    np.testing.assert_allclose(sc.detach().numpy(), np.asarray(jsc),
                               atol=ARM_ATOL, rtol=1e-6)
    leaves = dict(m.named_parameters())
    got = torch.autograd.grad(bits, [*leaves.values(), x])
    for (name, _), g in zip(leaves.items(), got):
        want = jax_leaf({"layers": jg_p["layers"]}, name.replace(".", "/"))
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)
    want = np.asarray(jg_x)
    np.testing.assert_allclose(got[-1].numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * np.abs(want).max())


def test_fixed_point_arm_integers_equal_jax():
    """_exp_neg_q30 over its range and past its cap; quantize_arm and
    pack_arm; _arm_apply_fixed on seeded integer contexts; and
    _laplace_table_fixed with the log-scale below, inside and above its
    clips and mu on both sides of the symbols."""
    rng = np.random.default_rng(4)
    t = np.concatenate([np.arange(0, 4096), rng.integers(0, 30 << 16, 20000),
                        [arm._EXP_T_MAX - 1, arm._EXP_T_MAX, 40 << 16]])
    np.testing.assert_array_equal(arm._exp_neg_q30(t), jarm._exp_neg_q30(t))
    params = jarm.init_arm(jax.random.PRNGKey(4))
    jq = jarm.quantize_arm(params)
    q = arm.quantize_arm(port_arm(params))
    assert arm.pack_arm(q) == jarm.pack_arm(jq)
    back, used = arm.unpack_arm(arm.pack_arm(q))
    assert used == len(arm.pack_arm(q)) and arm.pack_arm(back) == arm.pack_arm(q)
    ctx = rng.integers(-6, 7, (3000, arm.N_CTX))
    raw = arm._arm_apply_fixed(q, ctx)
    np.testing.assert_array_equal(raw, jarm._arm_apply_fixed(jq, ctx))
    assert raw.dtype == np.int64
    mu = np.concatenate([raw[:, 0], rng.integers(-3000, 3000, 500)])
    ls = np.concatenate([raw[:, 1], rng.integers(-6000, 6000, 500),
                         [-2560, -2561, -9999, 3537, 3538, 9999]])
    mu = np.concatenate([mu, rng.integers(-900, 900, 6)])
    for rmin, rmax in ((-6, 6), (0, 0), (-1, 3)):
        table = arm._laplace_table_fixed(mu, ls, rmin, rmax)
        np.testing.assert_array_equal(table,
                                      jarm._laplace_table_fixed(mu, ls, rmin, rmax))
        assert table.dtype == np.uint16


def test_float_plane_coder_writes_jax_bytes_and_round_trips():
    params = jarm.init_arm(jax.random.PRNGKey(2))
    m = port_arm(params)
    rng = np.random.default_rng(2)
    latent = np.round(rng.normal(0, 2.0, (24, 17))).astype(np.float32)
    stream = arm.encode_plane(m, latent)
    assert stream == jarm.encode_plane(params, latent)
    np.testing.assert_array_equal(arm.decode_plane(m, stream), latent)
    q = arm.quantize_arm(m)
    fixed = arm.encode_plane_fixed(q, latent)
    assert fixed == jarm.encode_plane_fixed(jarm.quantize_arm(params), latent)
    np.testing.assert_array_equal(arm.decode_plane_fixed(q, fixed), latent)


# ---------------------------------------------------------------------------
# the field
# ---------------------------------------------------------------------------

def _pca_cases():
    rng = np.random.default_rng(5)
    aniso = (rng.normal(size=(4000, 3)) * [10.0, 1.0, 0.1]).astype(np.float32)
    aniso[:40] *= 6.0  # a few far points for the LOF to drop
    voxel = np.unique(np.round(rng.normal(size=(5000, 3)) * [8, 5, 3])
                      .astype(np.float32), axis=0) * np.float32(0.01)
    return {"anisotropic": aniso, "voxel grid": voxel}


@pytest.mark.parametrize("case", ["anisotropic", "voxel grid"])
def test_fit_pca_keeps_sklearns_points_and_equals_jax(case):
    """The port's LOF keeps exactly the points scikit-learn's keeps (on
    voxel-grid points many distances tie); fit_pca then equals the JAX
    package's, which ran scikit-learn's."""
    from sklearn.neighbors import LocalOutlierFactor

    for n in (0, 100, 9216, 147456, 29603):
        assert cfield.adapt_resolution(n) == jfield.adapt_resolution(n), n
    pts = _pca_cases()[case]
    keep = cfield.lof_inliers(pts)
    want = LocalOutlierFactor(n_neighbors=50, contamination=0.05).fit_predict(pts) == 1
    np.testing.assert_array_equal(keep, want)
    assert 0 < (~keep).sum() <= 0.05 * pts.shape[0] + 1
    for got, jwant in zip(cfield.fit_pca(pts), jfield.fit_pca(pts)):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, jwant, atol=PCA_ATOL, rtol=0)


def test_field_planes_sample_and_rate_match_jax():
    """quantized_planes with JAX's noise and with the STE round, at
    non-integer gains (compared away from half-integers); sample and
    field_rate_bits from the noisy planes."""
    jcfg, tcfg = configs()
    state, flat = jax_state(1, gains=[0.37, 1.61])
    jf = state["nets"]["field"]
    tf = convert.state_from_numpy(flat, tcfg, device="cpu")["nets"].field
    noise = cat_noise(jax.random.PRNGKey(1), state, jcfg, 2)[3]
    kq = jax.random.split(jax.random.PRNGKey(1), 5)[1]
    with torch.no_grad():
        for q_port, q_jax in ((cfield.quantized_planes(tf, noise),
                               jfield.quantized_planes(jf, jcfg.field, kq)),
                              (cfield.quantized_planes(tf),
                               jfield.quantized_planes(jf, jcfg.field))):
            for i, (a, b) in enumerate(zip(q_port, q_jax)):
                b = np.asarray(b)
                scaled = np.asarray(jf["scales"][i]) * np.asarray(
                    2.0 ** jf["gains"][i])
                away = np.abs(np.abs(scaled - np.floor(scaled)) - 0.5) > HALF_MARGIN
                assert away.mean() > 0.99
                np.testing.assert_allclose(a.numpy()[away], b[away], atol=1e-6,
                                           rtol=1e-6)
        planes = cfield.quantized_planes(tf, noise)
        jplanes = [jnp.asarray(p.numpy()) for p in planes]
        x = np.random.default_rng(1).uniform(-1.5, 1.5, (700, 3)).astype(np.float32)
        np.testing.assert_allclose(
            cfield.normalize(tf, tcfg.field, torch.from_numpy(x)).numpy(),
            np.asarray(jfield.normalize(jf, jcfg.field, jnp.asarray(x))),
            atol=CTX_ATOL)
        got = cfield.sample(tf, tcfg.field, torch.from_numpy(x), planes)
        want = jax.jit(jfield.sample, static_argnums=1)(
            jf, jcfg.field, jnp.asarray(x), jplanes)
        assert got.shape == want.shape == (700, tcfg.ctx_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CTX_ATOL)
        np.testing.assert_allclose(
            float(cfield.field_rate_bits(tf, planes)),
            float(jax.jit(jfield.field_rate_bits, static_argnums=1)(
                jf, jcfg.field, jplanes)), rtol=BITS_RTOL)


def test_hyper_split_chcm_and_feature_stats_match_jax():
    jcfg, tcfg = configs(chcm_for_offsets=True, chcm_for_scaling=True)
    state, flat = jax_state(2, chcm_for_offsets=True, chcm_for_scaling=True)
    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    anchor = np.asarray(jhac.get_anchor(state, jcfg.as_hac()))[:250]
    feat = np.random.default_rng(2).normal(0, 0.5, (250, jcfg.feat_dim)).astype(
        np.float32)
    jh = jcat.hyper_split(state, jcfg, jnp.asarray(anchor))
    jh = jcat.chcm_adjust(state, jcfg, jh, jnp.asarray(feat))
    jm, js = jcat.feature_stats(state, jcfg, jh, jnp.asarray(feat))
    with torch.no_grad():
        th = cat.hyper_split(tstate, tcfg, torch.from_numpy(anchor))
        th = cat.chcm_adjust(tstate, tcfg, th, torch.from_numpy(feat))
        tm, ts = cat.feature_stats(tstate, tcfg, th, torch.from_numpy(feat))
    assert set(th) == set(jh) and len(th) == 9
    for k, v in jh.items():
        np.testing.assert_allclose(th[k].numpy(), np.asarray(v), atol=CTX_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=CTX_ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=CTX_ATOL)
    assert tm.shape == (250, tcfg.feat_dim)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

_JAX_LOSS = jax.jit(jax.value_and_grad(jrender.training_loss, argnums=(0, 8),
                                       has_aux=True), static_argnums=(2, 4, 6, 9))


@pytest.mark.parametrize("phase", [0, 1, 2, 3, 4, 5])
def test_training_loss_and_every_gradient_match_jax(phase):
    """The loss, its aux and every leaf's gradient, both packages' grad_mask
    applied, and the screen-space gradient."""
    jcfg, tcfg = configs()
    state, flat = jax_state(10 + phase, gains=[0.0, 1.0])
    jcam, tcam, cam = camera(phase)
    jr, tr = raster_cfgs(cam)
    key = jax.random.PRNGKey(30 + phase)
    bg = np.ones(3, np.float32)
    params, rest = jhac.split_state(state)
    m2d = jnp.zeros((rest["valid"].shape[0] * jcfg.n_offsets, 2))
    (want_loss, want_aux), (want_g, want_m2d) = _JAX_LOSS(
        params, rest, jcfg, jcam, jr, jnp.asarray(bg), phase, key, m2d, LMBDA)
    want_g = jrender.grad_mask(want_g, phase)

    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    tparams, trest = thac.split_state(tstate)
    leaves = ttrain.param_leaves(tparams)
    for t in leaves.values():
        t.requires_grad_(True)
    tm2d = torch.zeros(tuple(m2d.shape), requires_grad=True)
    noise = cat_noise(key, state, jcfg, phase)
    loss, aux = render.training_loss(tparams, trest, tcfg, tcam, tr,
                                     torch.from_numpy(bg), phase, noise, tm2d,
                                     LMBDA)
    got = torch.autograd.grad(loss, [*leaves.values(), tm2d], allow_unused=True)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    for name in ("l1", "ssim", "psnr", "bit_per_param"):
        np.testing.assert_allclose(float(aux[name]), float(want_aux[name]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=name)
    assert (float(aux["bit_per_param"]) > 0) == (phase >= 2)
    grads = render.grad_mask({n: g if g is not None else torch.zeros_like(t)
                              for (n, t), g in zip(leaves.items(), got[:-1])},
                             phase)

    def moved(prefix):
        return any(float(g.abs().max()) > 0 for n, g in grads.items()
                   if n.startswith(prefix))

    assert moved("nets/field/scales/") == (phase in (2, 5))
    assert moved("nets/field/arms/") == (phase in (3, 4, 5))
    for part in ("nets/field/rotation", "nets/field/pca_mean",
                 "nets/field/pca_std", "nets/field/gains", "nets/mlp_attr/",
                 "nets/mlp_chcm/"):
        assert moved(part) == (phase in (2, 4, 5)), part
    assert moved("nets/mlp_color/") == (phase != 3)
    for name, g in grads.items():
        want = jax_leaf(want_g, name)
        assert g.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-30)
        err = np.abs(g.detach().numpy() - want)
        bound = GRAD_RTOL * np.abs(want) + GRAD_ATOL * scale
        assert (err <= bound).all(), (name, float((err - bound).max()), scale)
    scale = float(np.abs(np.asarray(want_m2d)).max())
    if phase == 3:  # the planes' rate alone: no image term
        assert scale == 0 and (got[-1] is None or not got[-1].any())
    else:
        assert scale > 0
        np.testing.assert_allclose(got[-1].numpy(), np.asarray(want_m2d),
                                   rtol=1e-3, atol=2e-4 * scale)
    for name in ("visible_anchor", "g_valid", "radii"):
        np.testing.assert_array_equal(aux[name].numpy(), np.asarray(want_aux[name]))


def test_train_step_with_the_cat_objective_matches_jax():
    """One step of make_train_step(loss_fn=CAT's, grad_mask=CAT's) at phase
    2 from fresh moments on each side, as tests/test_torch_tcgs.py holds
    TC-GS's: metrics, first moments, leaves; the field, mlp_attr and
    mlp_chcm take mlp_grid's learning rate, as in the JAX package; the
    ARMs stay as they were."""
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
                                  grad_mask=jrender.grad_mask,
                                  white_background=True)
    key = jax.random.PRNGKey(5)
    jparams, jst, _, metrics = step(params, rest, jopt.init(params), jstats,
                                    jcam, key, phase=2)

    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    tparams, trest = thac.split_state(tstate)
    leaves = ttrain.param_leaves(tparams)
    before = {n: t.detach().clone() for n, t in leaves.items()}
    topt = ttrain.make_optimizer(ttrain.OptConfig(iterations=100), 4.0)
    tst = topt.init(leaves)
    tstats = ttrain.zero_stats(trest["valid"].shape[0], tcfg.n_offsets)
    tstep = ttrain.make_train_step(tcfg, tr, topt, ttrain.OptConfig(iterations=100),
                                   loss_fn=render.training_loss,
                                   grad_mask=render.grad_mask,
                                   white_background=True)
    _, tst, _, tmetrics = tstep(tparams, trest, tst, tstats, tcam, phase=2,
                                noise=cat_noise(key, state, jcfg, 2))
    for name in ("loss", "l1", "psnr", "bit_per_param"):
        np.testing.assert_allclose(float(tmetrics[name]), float(metrics[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    assert int(tmetrics["nonfinite_grads"]) == int(metrics["nonfinite_grads"]) == 0
    for name in ("nets/field/scales/0", "nets/field/arms/xy/layers/1/res_lin/weight",
                 "nets/field/rotation", "nets/mlp_attr/fc1/weight",
                 "nets/mlp_chcm/0/fc0/bias"):
        assert name in leaves and topt.group_of(name) == "mlp_grid", name
    lrs = {g: f(1) for g, f in topt.group_lr.items()}
    bc1, bc2 = 0.1, 0.001
    for name, t in leaves.items():
        want_mu = jax_leaf(jst[0].mu, name)
        np.testing.assert_allclose(tst["mu"][name].numpy(), want_mu, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * max(np.abs(want_mu).max(), 1e-30),
                                   err_msg=name)
        theirs = want_mu / bc1 / (np.sqrt(jax_leaf(jst[0].nu, name) / bc2) + 1e-15)
        mine = tst["mu"][name].numpy() / bc1 / (
            np.sqrt(tst["nu"][name].numpy() / bc2) + 1e-15)
        want = jax_leaf(jparams, name)
        lr = lrs[topt.group_of(name)]
        slack = lr * np.abs(mine - theirs) + 1e-6 * (
            np.abs(want) + lr * np.abs(theirs)) + 1e-9
        assert (np.abs(t.detach().numpy() - want) <= slack).all(), name
        if name.startswith("nets/field/arms/"):
            assert torch.equal(t.detach(), before[name]), name


def test_grad_mask_and_phases_match_jax():
    """phase_of_step at the JAX boundaries; grad_mask on a tree of ones by
    the port's leaf names, against the JAX package's on the same tree."""
    jcfg, tcfg = configs()
    for s in (1, 3000, 3001, 10000, 10001, 15000, 15001, 16000, 16001,
              19000, 19001, 30000):
        assert render.phase_of_step(s) == jrender.phase_of_step(s), s
    state, flat = jax_state(3)
    params, _ = jhac.split_state(state)
    ones = jax.tree_util.tree_map(jnp.ones_like, params)
    tparams, _ = thac.split_state(convert.state_from_numpy(flat, tcfg, device="cpu"))
    names = list(ttrain.param_leaves(tparams))
    for phase in range(6):
        got = render.grad_mask({n: torch.ones(1) for n in names}, phase)
        want = jrender.grad_mask(ones, phase)
        for n in names:
            assert float(got[n][0]) == float(jax_leaf(want, n).reshape(-1)[0]), (
                phase, n)


def test_view_frequency_weights_match_jax():
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 20, 64).astype(np.float32)
    valid = rng.random(64) > 0.2
    vis = rng.random(64) > 0.5
    got = render.update_view_frequency(torch.from_numpy(counts), torch.from_numpy(vis))
    want = jrender.update_view_frequency(jnp.asarray(counts), jnp.asarray(vis))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        render.view_frequency_weights(got, torch.from_numpy(valid)).numpy(),
        np.asarray(jrender.view_frequency_weights(want, jnp.asarray(valid))),
        rtol=1e-6)
    state, flat = jax_state(4)
    tstate = convert.state_from_numpy(flat, configs()[1], device="cpu")
    w = rng.uniform(0.2, 3.0, tstate["valid"].shape[0]).astype(np.float32)
    np.testing.assert_array_equal(
        render.weighted_mask(tstate, torch.from_numpy(w)).numpy(),
        np.asarray(jrender.weighted_mask(state, jnp.asarray(w))))


def test_state_from_numpy_takes_cat_keys_and_full_width_is_the_records():
    """Every nets/ key of a JAX CAT state and no other; at CATConfig's full
    width the networks are 1,124,320 bits and the three integer ARMs
    13,680 bytes, as runs/soak_cat3dgs_r5 records them."""
    jcfg, tcfg = configs(chcm_for_scaling=True)
    state, flat = jax_state(4, chcm_for_scaling=True)
    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    nets = tstate["nets"]
    for gone in ("tables", "mlp_grid", "mlp_deform"):
        assert not hasattr(nets, gone)
    leaves = ttrain.param_leaves({"anchors": {}, "nets": nets})
    assert {n for n in leaves} == {
        k.replace("/w", "/weight").replace("/b", "/bias") if k.endswith(("/w", "/b"))
        else k for k in flat if k.startswith("nets/")}
    for name, p in leaves.items():
        np.testing.assert_array_equal(p.detach().numpy(), jax_leaf(state, name),
                                      err_msg=name)
    assert thac.mlp_size_bits(tstate) == jhac.mlp_size_bits(state)
    for key in ("nets/field/scales/1", "nets/field/arms/yz/layers/4/lin/w",
                "nets/field/pca_std", "nets/mlp_chcm/0/fc1/b"):
        with pytest.raises(KeyError):
            convert.state_from_numpy({k: v for k, v in flat.items() if k != key},
                                     tcfg, device="cpu")
    with pytest.raises(KeyError):
        convert.state_from_numpy(dict(flat, **{"nets/mlp_grid/fc0/w": np.zeros(
            (1, 1), np.float32)}), tcfg, device="cpu")
    full = cat.CATNets(cat.CATConfig())
    assert thac.mlp_size_bits({"nets": full}) == 1_124_320
    assert sum(len(arm.pack_arm(arm.quantize_arm(a)))
               for a in full.field.arms.values()) == 13_680
    assert [tuple(p.shape) for p in full.field.scales] == [
        (3, 1, 64, 64), (3, 1, 128, 128), (3, 1, 256, 256)]
