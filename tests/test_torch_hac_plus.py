"""HAC++ in the port (gauspcc_tpu_torch/models/hac_plus, the mixture's
entropy, CDF and coding functions) against the JAX package's, on the CPU,
at the size of tests/test_hac_plus.py: feat_dim 10 (5 chunks of 2), 3
offsets, resolutions (6, 10, 16) / (16, 32), 2^13 rows, NetConfig(8, 3).

Tolerances, each with its reason:
- the channel context, mlp_grid's heads and the mixture: atol 1e-5
  (float32 GEMMs of two libraries);
- the mixture's bits: atol 1e-5 plus rtol 1e-5, the rtol of
  tests/test_torch_entropy.py (bits reach 20, and erfc and log2 of two
  libraries round each by a float32 ulp or so of the value); their
  gradients atol 1e-5 plus, per element, rtol 1e-5 + 2^-23 / L, where L =
  2^-bits is the likelihood: L is a difference of two CDFs near 1/2, each
  rounded to a float32 ulp (2^-24) on each side, and the gradient is
  proportional to 1 / L;
- training_loss and every gradient: those of tests/test_torch_train.py
  (loss rtol 1e-5; a gradient leaf atol 2e-4 of its largest |gradient|
  plus rtol 1e-3), and one train step as tests/test_torch_train_step.py
  holds HAC's;
- mixture_center exact, the mixture CDF tables within 1 count of 2^16;
- the mixture coder's `.b` files byte for byte (the same coder fed the same
  float32 model), and their decode exact;
- the scene codec: the port's round trip exact; decoded features within
  1e-4 of the JAX package's quantisation (tests/test_hac_plus.py:63-92);
  hash, masks and mlps sizes exact, feat / scaling / offsets within 1%
  (the context's float32 sums in another order move a rounding now and
  then).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.codecs.gauspcgc import model as jpcc
from gauspcc_tpu.core import cdf as jcdf
from gauspcc_tpu.core import entropy as jentropy
from gauspcc_tpu.core.quant import ste_multistep as jste_multistep
from gauspcc_tpu.models.hac import codec as jhac_codec
from gauspcc_tpu.models.hac import model as jhac
from gauspcc_tpu.models.hac import train as jtrain
from gauspcc_tpu.models.hac_plus import codec as jcodec
from gauspcc_tpu.models.hac_plus import model as jhacp
from gauspcc_tpu.models.hac_plus import render as jrender
from gauspcc_tpu.ops import entropy_coding as jec
from gauspcc_tpu.utils.checkpoint import _path_str

from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc
from gauspcc_tpu_torch.core import cdf, entropy
from gauspcc_tpu_torch.models.hac import codec as hac_codec
from gauspcc_tpu_torch.models.hac import model as thac
from gauspcc_tpu_torch.models.hac import train as ttrain
from gauspcc_tpu_torch.models.hac_plus import codec
from gauspcc_tpu_torch.models.hac_plus import model as hacp
from gauspcc_tpu_torch.models.hac_plus import render
from gauspcc_tpu_torch.ops import entropy_coding as ec

from test_torch_native_libs import ensure_jax_native_libs

from test_torch_train import (GRAD_ATOL, GRAD_RTOL, LMBDA, LOSS_RTOL, camera,
                              jax_noise, raster_cfgs)

ensure_jax_native_libs()  # before any test here loads one


SMALL = dict(feat_dim=10, n_offsets=3, voxel_size=0.05,
             resolutions_3d=(6, 10, 16), resolutions_2d=(16, 32),
             log2_hashmap_size=13, log2_hashmap_size_2d=13)
J_PCC, PCC = jpcc.NetConfig(8, 3), pcc.NetConfig(8, 3, "f32")
ATOL = 1e-5
BITS_RTOL = 1e-5
SIZE_RTOL = 0.01


def configs(tiny: bool):
    return (jhacp.HACPlusConfig(**SMALL, tiny_ctx=tiny),
            hacp.HACPlusConfig(**SMALL, tiny_ctx=tiny))


def flat_of(state) -> dict:
    return {_path_str(kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(state)[0]}


def jax_state(seed=0, tiny=False, n_pts=300, spread=0.6, every_row=True):
    """A JAX HAC++ state: seeded, its features, offsets and masks drawn from
    the seed (every capacity row, or the live rows as tests/test_hac_plus.py
    draws them), the tiny context's chunk-0 rows too; and its flat arrays."""
    jcfg, _ = configs(tiny)
    rng = np.random.default_rng(seed)
    pts = jhac.voxelize_points(
        (rng.random((n_pts, 3)) * 2 * spread - spread).astype(np.float32),
        jcfg.voxel_size)
    state = jhacp.init_state(jax.random.PRNGKey(seed), jcfg, pts)
    rows = state["valid"].shape[0] if every_row else pts.shape[0]
    a = dict(state["anchors"])
    for name, mu, sd, shape in (("anchor_feat", 0, 0.5, (rows, jcfg.feat_dim)),
                                ("offset", 0, 0.3, (rows, jcfg.n_offsets, 3)),
                                ("mask", 1.0, 2.0, (rows, jcfg.n_offsets, 1))):
        a[name] = a[name].at[:rows].set(
            jnp.asarray(rng.normal(mu, sd, shape).astype(np.float32)))
    nets = dict(state["nets"])
    if tiny:
        ctx = dict(nets["channel_ctx"])
        for name in ("mean_d0", "scale_d0", "prob_d0"):
            ctx[name] = jnp.asarray(rng.normal(0, 0.5, (1, jcfg.chunk))
                                    .astype(np.float32))
        nets["channel_ctx"] = ctx
    state = jhac.update_anchor_bound(dict(state, anchors=a, nets=nets))
    return state, flat_of(state)


def jax_leaf(tree, name):
    """The JAX leaf of a port leaf name, in the port's layout ([out, in]
    weights)."""
    *keys, last = name.split("/")
    node = tree
    for k in keys:
        node = node[k]
    if last == "weight":
        return np.asarray(node["w"]).T
    return np.asarray(node["b"] if last == "bias" else node[last])


def assert_grads_close(got: dict, want_tree):
    for name, g in got.items():
        want = jax_leaf(want_tree, name)
        g = g.detach().numpy()
        assert g.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)


@pytest.mark.parametrize("tiny", [False, True])
def test_channel_ctx_and_mixture_match_jax(tiny):
    """channel_ctx_apply at full width and for each chunk, causal;
    grid_mlp_split's ten heads and mixture_components."""
    jcfg, tcfg = configs(tiny)
    state, flat = jax_state(1, tiny)
    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(16, jcfg.feat_dim)).astype(np.float32)
    ms = rng.normal(size=(16, jcfg.feat_dim * 3)).astype(np.float32)
    jp = state["nets"]["channel_ctx"]
    tp = tstate["nets"].channel_ctx
    t_feat, t_ms = torch.from_numpy(feat), torch.from_numpy(ms)
    with torch.no_grad():
        for to_dec in (-1, 0, 1, 2, 3, 4):
            want = jhacp.channel_ctx_apply(jp, jcfg, jnp.asarray(feat),
                                           jnp.asarray(ms), to_dec)
            got = hacp.channel_ctx_apply(tp, tcfg, t_feat, t_ms, to_dec)
            for g, w in zip(got, want):
                assert g.shape == w.shape
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                           err_msg=f"to_dec {to_dec}")
        # chunk 2 reads chunks 0 and 1 only (tests/test_hac_plus.py:51)
        t_bad = t_feat.clone()
        t_bad[:, 2 * tcfg.chunk:] = 99.0
        for a, b in zip(hacp.channel_ctx_apply(tp, tcfg, t_feat, t_ms, 2),
                        hacp.channel_ctx_apply(tp, tcfg, t_bad, t_ms, 2)):
            assert torch.equal(a, b)

        anchor = np.array(jhac.get_anchor(state, jcfg.as_hac()))[:40]
        jctx = jhacp.grid_mlp_split(state, jcfg, jhac.calc_interp_feat(
            state, jcfg.as_hac(), jnp.asarray(anchor)))
        tctx = hacp.grid_mlp_split(tstate, tcfg, thac.calc_interp_feat(
            tstate, tcfg.as_hac(), torch.from_numpy(anchor)))
        assert set(tctx) == set(jctx) and len(tctx) == 10
        for k, v in jctx.items():
            np.testing.assert_allclose(tctx[k].numpy(), np.asarray(v),
                                       atol=ATOL, err_msg=k)
        fq = rng.normal(size=(40, jcfg.feat_dim)).astype(np.float32)
        for to_dec in (-1, 0, 3):
            want = jhacp.mixture_components(jctx, jp, jcfg, jnp.asarray(fq), to_dec)
            got = hacp.mixture_components(tctx, tp, tcfg, torch.from_numpy(fq),
                                          to_dec)
            for gl, wl in zip(got, want):
                for g, w in zip(gl, wl):
                    np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                               atol=ATOL, err_msg=f"{to_dec}")


def test_gaussian_mixture_bits_and_gradients_match_jax():
    """Value and gradient with respect to x, means, scales and probs, with
    some x exactly on a component's mean and some clamped."""
    rng = np.random.default_rng(3)
    n = 4096
    means = [rng.normal(0, 2, n).astype(np.float32) for _ in range(2)]
    scales = [np.exp(rng.normal(-0.5, 1, n)).astype(np.float32) for _ in range(2)]
    logits = rng.normal(size=(n, 2)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    probs = [probs[:, 0].astype(np.float32), probs[:, 1].astype(np.float32)]
    q = rng.uniform(0.2, 1.5, n).astype(np.float32)
    x = (means[0] + 3 * scales[0] * rng.normal(size=n)).astype(np.float32)
    x[:64] = means[0][:64]
    x[64:96] = means[1][64:96]
    x[96:100] = 1e6  # clamped to x_mean + 15000 q
    w = rng.normal(size=n).astype(np.float32)

    def jf(x, m0, m1, s0, s1, p0, p1):
        bits = jentropy.gaussian_mixture_bits(x, [m0, m1], [s0, s1], [p0, p1],
                                              jnp.asarray(q))
        return jnp.sum(bits * w), bits

    args = (x, *means, *scales, *probs)
    (_, jbits), jgrads = jax.value_and_grad(jf, argnums=tuple(range(7)),
                                            has_aux=True)(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    bits = entropy.gaussian_mixture_bits(leaves[0], leaves[1:3], leaves[3:5],
                                         leaves[5:7], torch.from_numpy(q))
    grads = torch.autograd.grad((bits * torch.from_numpy(w)).sum(), leaves)
    np.testing.assert_allclose(bits.detach().numpy(), np.asarray(jbits),
                               rtol=BITS_RTOL, atol=ATOL)
    rtol = BITS_RTOL + 2.0 ** (np.asarray(jbits, np.float64) - 23)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        jg = np.asarray(jg)
        bad = np.abs(g.numpy() - jg) > ATOL + rtol * np.abs(jg)
        assert not bad.any(), (i, np.nonzero(bad)[0], g.numpy()[bad], jg[bad])
    assert (grads[0].numpy()[96:100] == 0).all()  # clamped: no gradient


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_training_loss_and_every_gradient_match_jax(phase):
    jcfg, tcfg = configs(False)
    state, flat = jax_state(phase)
    jcam, tcam, cam = camera(phase)
    jr, tr = raster_cfgs(cam)
    key = jax.random.PRNGKey(20 + phase)
    bg = np.ones(3, np.float32)
    params, rest = jhac.split_state(state)
    m2d = jnp.zeros((rest["valid"].shape[0] * jcfg.n_offsets, 2))
    # one XLA program: op-by-op dispatch of this graph compiles for minutes
    loss_and_grad = jax.jit(jax.value_and_grad(
        jrender.training_loss, argnums=(0, 8), has_aux=True),
        static_argnums=(2, 4, 6, 9))
    (want_loss, want_aux), (want_g, want_m2d) = loss_and_grad(
        params, rest, jcfg, jcam, jr, jnp.asarray(bg), phase, key, m2d, LMBDA)

    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    tparams, trest = thac.split_state(tstate)
    leaves = ttrain.param_leaves(tparams)
    assert any(n.startswith("nets/channel_ctx/") for n in leaves)
    for t in leaves.values():
        t.requires_grad_(True)
    tm2d = torch.zeros(tuple(m2d.shape), requires_grad=True)
    loss, aux = render.training_loss(
        tparams, trest, tcfg, tcam, tr, torch.from_numpy(bg), phase,
        jax_noise(key, state, jcfg), tm2d, LMBDA)
    got = torch.autograd.grad(loss, [*leaves.values(), tm2d], allow_unused=True)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    for name in ("l1", "ssim", "psnr", "bit_per_param"):
        np.testing.assert_allclose(float(aux[name]), float(want_aux[name]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=name)
    grads = {n: g if g is not None else torch.zeros_like(t)
             for (n, t), g in zip(leaves.items(), got[:-1])}
    if phase == 2:
        assert float(aux["bit_per_param"]) > 0
        assert any(float(g.abs().max()) > 0 for n, g in grads.items()
                   if n.startswith("nets/channel_ctx/"))
    assert_grads_close(grads, want_g)
    scale = float(np.abs(np.asarray(want_m2d)).max())
    assert scale > 0
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want_m2d),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL * scale)
    for name in ("visible_anchor", "g_valid", "radii"):
        np.testing.assert_array_equal(aux[name].numpy(), np.asarray(want_aux[name]))


def test_train_step_with_the_hac_plus_objective_matches_jax():
    """One step of make_train_step(loss_fn=HAC++'s) at phase 2 from fresh
    moments on each side: metrics, first moments (0.1 g, held as the
    gradients) and the leaves (one Adam step of lr sign-like size, held to
    lr times the difference of the two sides' directions)."""
    jcfg, tcfg = configs(False)
    state, flat = jax_state(7)
    jcam, tcam, cam = camera(7)
    jr, tr = raster_cfgs(cam)
    opt = jtrain.OptConfig(iterations=100)
    jopt = jtrain.make_optimizer(opt, 4.0)
    params, rest = jhac.split_state(state)
    jstats = jtrain.zero_stats(rest["valid"].shape[0], jcfg.n_offsets)
    step = jtrain.make_train_step(jcfg, jr, jopt, opt,
                                  loss_fn=jrender.training_loss,
                                  white_background=True)
    key = jax.random.PRNGKey(3)
    jparams, jst, _, metrics = step(params, rest, jopt.init(params), jstats,
                                    jcam, key, phase=2)

    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    tparams, trest = thac.split_state(tstate)
    leaves = ttrain.param_leaves(tparams)
    topt = ttrain.make_optimizer(ttrain.OptConfig(iterations=100), 4.0)
    tst = topt.init(leaves)
    tstats = ttrain.zero_stats(trest["valid"].shape[0], tcfg.n_offsets)
    tstep = ttrain.make_train_step(tcfg, tr, topt, ttrain.OptConfig(iterations=100),
                                   loss_fn=render.training_loss,
                                   white_background=True)
    _, tst, _, tmetrics = tstep(tparams, trest, tst, tstats, tcam, phase=2,
                                noise=jax_noise(key, state, jcfg))
    for name in ("loss", "l1", "psnr", "bit_per_param"):
        np.testing.assert_allclose(float(tmetrics[name]), float(metrics[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    assert int(tmetrics["nonfinite_grads"]) == int(metrics["nonfinite_grads"]) == 0
    assert_grads_close(tst["mu"], jst[0].mu)
    lrs = {g: f(1) for g, f in topt.group_lr.items()}
    assert topt.group_of("nets/channel_ctx/mlp_d0/fc0/weight") == "mlp_grid"
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


def test_grad_mask_freezes_the_groups_it_zeroes():
    """make_train_step(grad_mask=): a phase-2 step with channel_ctx's
    gradients zeroed leaves channel_ctx as it was and moves mlp_grid."""
    _, tcfg = configs(False)
    _, flat = jax_state(8)
    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    _, tcam, cam = camera(8)
    _, tr = raster_cfgs(cam)
    params, rest = thac.split_state(tstate)
    leaves = ttrain.param_leaves(params)
    before = {n: t.detach().clone() for n, t in leaves.items()}
    opt = ttrain.OptConfig(iterations=100)
    topt = ttrain.make_optimizer(opt, 4.0)

    def freeze_ctx(grads, phase):
        assert phase == 2
        return {n: torch.zeros_like(g) if n.startswith("nets/channel_ctx/")
                else g for n, g in grads.items()}

    step = ttrain.make_train_step(tcfg, tr, topt, opt,
                                  loss_fn=render.training_loss,
                                  grad_mask=freeze_ctx)
    step(params, rest, topt.init(leaves),
         ttrain.zero_stats(rest["valid"].shape[0], tcfg.n_offsets), tcam,
         phase=2, generator=torch.Generator().manual_seed(0))
    for n, t in leaves.items():
        if n.startswith("nets/channel_ctx/"):
            assert torch.equal(t.detach(), before[n]), n
    assert not torch.equal(leaves["nets/mlp_grid/fc1/weight"].detach(),
                           before["nets/mlp_grid/fc1/weight"])


def _mixture_case(seed, n):
    rng = np.random.default_rng(seed)
    means = [rng.normal(0, 2, n).astype(np.float32),
             rng.normal(0.3, 2, n).astype(np.float32)]
    scales = [np.exp(rng.normal(-0.5, 0.7, n)).astype(np.float32)
              for _ in range(2)]
    p0 = rng.uniform(0.05, 0.95, n).astype(np.float32)
    probs = [p0, (1 - p0).astype(np.float32)]
    q = rng.uniform(0.1, 1.0, n).astype(np.float32)
    x = (means[0] + scales[0] * rng.normal(size=n) * 1.5).astype(np.float32)
    if n >= 3:
        x[:3] = [40.0, -55.0, 0.0]  # outliers far in the tails
    return x, means, scales, probs, q


def test_mixture_center_and_tables_match_jax():
    x, means, scales, probs, q = _mixture_case(5, 3000)
    tm, ts, tp = ([torch.from_numpy(a) for a in v] for v in (means, scales, probs))
    tq = torch.from_numpy(q)
    jm, js, jp = ([jnp.asarray(a) for a in v] for v in (means, scales, probs))
    np.testing.assert_array_equal(
        cdf.mixture_center(tm, tp, tq).numpy(),
        np.asarray(jcdf.mixture_center(jm, jp, jnp.asarray(q))))
    for got, want in (
            (cdf.gaussian_mixture_cdf_table(tm, ts, tp, tq, -7, 9),
             jcdf.gaussian_mixture_cdf_table(jm, js, jp, jnp.asarray(q), -7, 9)),
            (cdf.gaussian_mixture_cdf_table_residual(tm, ts, tp, tq, -5, 6),
             jcdf.gaussian_mixture_cdf_table_residual(jm, js, jp, jnp.asarray(q),
                                                      -5, 6))):
        want = np.asarray(want).astype(np.int32)
        assert got.shape == want.shape
        diff = np.abs(got.numpy() - want)
        assert ((diff <= 1) | (diff == 0xFFFF)).all()  # the wrapped last column


@pytest.mark.parametrize("n", [0, 5000, 150_000])  # empty, one and 3 chunks
def test_encode_gaussian_mixed_file_equals_jax_and_decodes(tmp_path, n):
    x, means, scales, probs, q = _mixture_case(6, n)
    tm, ts, tp = ([torch.from_numpy(a) for a in v] for v in (means, scales, probs))
    tx, tq = torch.from_numpy(x), torch.from_numpy(q)
    bits = ec.encode_gaussian_mixed(tx, tm, ts, tp, tq, str(tmp_path / "t.b"))
    jbits = jec.encode_gaussian_mixed(x, means, scales, probs, jnp.asarray(q),
                                      str(tmp_path / "j.b"))
    assert bits == jbits
    assert (tmp_path / "t.b").read_bytes() == (tmp_path / "j.b").read_bytes()
    got = ec.decode_gaussian_mixed(tm, ts, tp, tq, str(tmp_path / "j.b"))
    want = np.asarray(jec.decode_gaussian_mixed(means, scales, probs,
                                                jnp.asarray(q),
                                                str(tmp_path / "j.b")))
    assert got.shape == want.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), ec.mixture_values(tx, tm, ts, tp, tq).numpy())


# ---------------------------------------------------------------------------
# the scene codec
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene_states():
    """tests/test_hac_plus.py:28's state (400 points in [-1, 1], live rows
    perturbed), in both packages, and the small codec in both."""
    jcfg, tcfg = configs(False)
    state, flat = jax_state(0, n_pts=400, spread=1.0, every_row=False)
    jparams = jpcc.init_params(jax.random.PRNGKey(7), J_PCC)
    net = convert.codec_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), PCC, "cpu")
    return state, convert.state_from_numpy(flat, tcfg, device="cpu"), jparams, net


@pytest.fixture(scope="module")
def coded(tmp_path_factory, scene_states):
    _, tstate, _, net = scene_states
    _, tcfg = configs(False)
    out = str(tmp_path_factory.mktemp("hacp") / "bitstreams")
    values, profile = {}, {}
    sizes, log = codec.conduct_encoding(tstate, tcfg, out, net, PCC,
                                        values=values, profile=profile)
    dec, _ = codec.conduct_decoding(tstate, tcfg, out, net, PCC)
    return out, sizes, log, values, profile, dec


def test_scene_round_trip_is_exact(scene_states, coded):
    _, tstate, _, _ = scene_states
    _, tcfg = configs(False)
    out, sizes, log, values, profile, dec = coded
    data = hac_codec._gather_sorted_attributes(tstate, tcfg.as_hac())
    n = data["anchor_int"].shape[0]
    assert n == values["feat"].shape[0] > 0 and "EncTime" in log
    assert sizes["total"] == sum(v for k, v in sizes.items() if k != "total")
    assert set(profile) == {"total_s", "anchors_s", "context_ms", "mixture_ms",
                            "coder_s"}
    assert int(dec["valid"].sum()) == n
    a = dec["anchors"]
    np.testing.assert_array_equal(
        a["anchor"][:n].numpy(),
        data["anchor_int"].astype(np.float32) * tcfg.voxel_size)
    assert torch.equal(a["mask"][:n], data["mask"])
    assert torch.equal(dec["nets"].tables.flat(), thac.encoding_params_flat(tstate))
    for name, key in (("feat", "anchor_feat"), ("scaling", "scaling"),
                      ("offset", "offset")):
        assert torch.equal(a[key][:n], values[name]), name
    assert dec["nets"] is not tstate["nets"]
    assert torch.equal(dec["nets"].channel_ctx.mlp_d3.fc0.weight,
                       tstate["nets"].channel_ctx.mlp_d3.fc0.weight)


def test_decoded_features_match_jax_quantization(scene_states, coded):
    """The JAX oracle of tests/test_hac_plus.py:63-92: the decoded features
    against ste_multistep through JAX's context."""
    state, _, _, _ = scene_states
    jcfg, _ = configs(False)
    dec = coded[-1]
    data = jhac_codec._gather_sorted_attributes(state, jcfg.as_hac())
    n = data["anchor_int"].shape[0]
    pos = data["anchor_int"].astype(np.float32) * jcfg.voxel_size
    ctx = jcodec._batch_context(state, jcfg, jnp.asarray(
        np.pad(pos, ((0, jcodec.BATCH - n), (0, 0)))))
    want = np.asarray(jste_multistep(jnp.asarray(data["feat"]),
                                     ctx["q_feat"][:n],
                                     jnp.float32(data["feat"].mean())))
    np.testing.assert_allclose(dec["anchors"]["anchor_feat"][:n].numpy(), want,
                               atol=1e-4)


def test_scene_sizes_match_jax(tmp_path, scene_states, coded):
    state, tstate, jparams, _ = scene_states
    jcfg, _ = configs(False)
    out, sizes = coded[0], coded[1]
    jout = str(tmp_path / "jax")
    jsizes, _ = jcodec.conduct_encoding(state, jcfg, jout, jparams, J_PCC)
    assert set(sizes) == set(jsizes)
    for k in ("hash", "masks", "mlps"):
        assert sizes[k] == jsizes[k], k
    assert sizes["mlps"] == thac.mlp_size_bits(tstate) == jhac.mlp_size_bits(state)
    for k in ("anchor", "feat", "scaling", "offsets", "total"):
        assert sizes[k] == pytest.approx(jsizes[k], rel=SIZE_RTOL), k
    import os
    files = sorted(os.listdir(out))
    assert files == sorted(os.listdir(jout))
    assert "feat_0_4.b" in files and "feat_0.b" not in files


@pytest.mark.parametrize("tiny", [False, True])
def test_state_from_numpy_takes_hac_plus_keys(tiny):
    jcfg, tcfg = configs(tiny)
    state, flat = jax_state(4, tiny)
    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    nets = tstate["nets"]
    assert not hasattr(nets, "mlp_deform")
    assert nets.mlp_grid.fc1.out_features == tcfg.grid_out_dim == 63
    for name, p in ttrain.param_leaves({"anchors": {}, "nets": nets}).items():
        np.testing.assert_array_equal(p.detach().numpy(), jax_leaf(state, name),
                                      err_msg=name)
    assert thac.mlp_size_bits(tstate) == jhac.mlp_size_bits(state)
    key = ("nets/channel_ctx/mean_d0" if tiny
           else "nets/channel_ctx/mlp_d0/fc0/w")
    with pytest.raises(KeyError):
        convert.state_from_numpy({k: v for k, v in flat.items() if k != key},
                                 tcfg, device="cpu")
    with pytest.raises(KeyError):
        convert.state_from_numpy(dict(flat, **{"nets/mlp_deform/fc0/w": np.zeros(
            (1, 1), np.float32)}), tcfg, device="cpu")
