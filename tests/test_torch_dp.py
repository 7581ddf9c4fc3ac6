"""Port parity: the data-parallel codec step (gauspcc_tpu_torch.parallel.dp)
against the JAX package's gauspcc_tpu/parallel/dp.py, on gloo ranks on
the CPU.

The JAX side is written out without a mesh, as tests/test_parallel.py:70-83
writes its single-device reference: `jax.value_and_grad` of dp.py:99-106's
loss (the patch's level bits over max(n_points, 1)) per patch, the mean of
the gradients, then optax.adam(1e-3); it is jitted once for the file (every
patch has the caps' shapes). The ranks are spawned processes that import
the port only (`dist.launch`).

Tolerances: `default_capacity_schedule` and `pack_patch` exactly (the same
numpy arithmetic), and the capacity guard's message JAX's; after one
2-rank step the reduced gradients within rtol 1e-4 plus 1e-5 of each
leaf's largest |value| of JAX's mean gradient (float32 sums over the
levels' children in another order; this holds the scale, which the first
Adam step, lr * sign(g), does not show), the parameters within
tests/test_parallel.py:87's rtol 2e-4 / atol 2e-6, and the mean bpp rtol
1e-5; four ranks on one patch within the same tolerance of
one process (the mean of four equal float32 gradients is within an ulp of
each); the ranks' parameters bitwise equal (every rank applies the same
update to the same reduced gradients)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from gauspcc_tpu.codecs.gauspcgc import model as jmodel
from gauspcc_tpu.parallel import dp as jdp
from gauspcc_tpu.utils.checkpoint import _path_str

from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.codecs.gauspcgc import model as tmodel
from gauspcc_tpu_torch.parallel import dist as pdist
from gauspcc_tpu_torch.parallel import dp

JCFG = jmodel.NetConfig(channels=8, kernel_size=3, dtype="f32")
TCFG = tmodel.NetConfig(channels=8, kernel_size=3, dtype="f32")
CAPS = dp.default_capacity_schedule(finest_cap=512, n_levels=3)
RTOL, ATOL = 2e-4, 2e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # the atol a fraction of the leaf's max


def _patch(rng, n=400, extent=32):
    """tests/test_parallel.py:20's patch."""
    pts = rng.integers(0, extent, size=(n * 2, 3))
    return np.unique(pts, axis=0)[:n].astype(np.int64)


@pytest.fixture(scope="module")
def jax_net():
    """JAX's initial weights, their flat keys, and the jitted per-patch
    value_and_grad of dp.py:99-106's loss (compiled once for the file)."""
    params = jmodel.init_params(jax.random.PRNGKey(0), JCFG)
    flat = {_path_str(kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}

    def loss_fn(p, pc, po, pm, gt, n_points):
        total = 0.0
        for i in range(len(pc)):
            bits, _ = jmodel.level_bits(p, JCFG, pc[i], po[i], pm[i], gt[i])
            total = total + bits
        return total / jnp.maximum(n_points.astype(jnp.float32), 1.0)

    return params, flat, jax.jit(jax.value_and_grad(loss_fn))


def _jax_patch_args(patch):
    return tuple([jnp.asarray(a) for a in patch[k]]
                 for k in ("pc", "po", "pm", "gt")) + (jnp.asarray(patch["n_points"]),)


def _jax_key(name: str) -> str:
    return convert._codec_key(name)


def _jax_param(flat_or_tree, name):
    arr = np.asarray(flat_or_tree[_jax_key(name)])
    return arr.T if name.endswith(".weight") else arr


def _run_ranks(tmp_path, net, patches, world):
    in_path = str(tmp_path / "inputs.npz")
    pdist.write_inputs(in_path, codec=dp.codec_inputs(net, TCFG, patches))
    pdist.launch((dp.rank_main,), world, "gloo", "cpu", in_path, str(tmp_path))
    outs = []
    for r in range(world):
        with np.load(pdist.output_path(str(tmp_path), "codec", r)) as f:
            outs.append({k: f[k] for k in f.files})
    return outs


def _assert_ranks_bitwise_equal(outs):
    for o in outs[1:]:
        for k, v in outs[0].items():
            if k.startswith("param/"):
                np.testing.assert_array_equal(o[k], v, err_msg=k)


@pytest.mark.parametrize("finest,n_levels", [(4096, 4), (512, 3), (100, 5)])
def test_default_capacity_schedule_matches_jax(finest, n_levels):
    assert dp.default_capacity_schedule(finest, n_levels) == \
        jdp.default_capacity_schedule(finest, n_levels)


@pytest.mark.parametrize("seed,n,extent,caps", [
    (0, 400, 32, CAPS),
    (1, 2000, 64, dp.default_capacity_schedule(4096, 4)),
    # a pyramid shorter than the caps: masked empty coarse levels
    (2, 300, 16, [64, 64, 64, 64, 512]),
])
def test_pack_patch_matches_jax(seed, n, extent, caps):
    pts = _patch(np.random.default_rng(seed), n, extent)
    want = jdp.pack_patch(pts, caps)
    got = dp.pack_patch(pts, caps)
    if extent == 16:
        assert not want["pm"][0].any()  # the coarsest level is empty
    for key in ("pc", "po", "pm", "gt"):
        assert len(got[key]) == len(want[key]) == len(caps)
        for g, w in zip(got[key], want[key]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=key)
    assert got["n_points"] == want["n_points"]
    assert got["n_points"].dtype == want["n_points"].dtype


def test_pack_patch_capacity_guard():
    """tests/test_parallel.py:90 on the port: the same ValueError message."""
    pts = _patch(np.random.default_rng(2), n=3000, extent=64)
    with pytest.raises(ValueError) as want:
        jdp.pack_patch(pts, caps=[8, 8, 8])
    with pytest.raises(ValueError, match="parents > cap") as got:
        dp.pack_patch(pts, caps=[8, 8, 8])
    assert str(got.value) == str(want.value)


def test_dp_codec_step_on_two_ranks_matches_jax(tmp_path, jax_net):
    """Two different patches on two gloo ranks, one step: the reduced
    gradients against JAX's mean of the two patches' gradients, and the
    parameters against that mean through optax.adam."""
    params, flat, vg = jax_net
    rng = np.random.default_rng(0)
    patches = [dp.pack_patch(_patch(rng), CAPS) for _ in range(2)]
    net = convert.codec_params_from_numpy(flat, TCFG, device="cpu")
    outs = _run_ranks(tmp_path, net, patches, 2)
    _assert_ranks_bitwise_equal(outs)

    losses, grads = zip(*(vg(params, *_jax_patch_args(p)) for p in patches))
    mean_g = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *grads)
    opt = optax.adam(1e-3)
    updates, _ = opt.update(mean_g, opt.init(params), params)
    new = optax.apply_updates(params, updates)
    new_flat, grad_flat = ({_path_str(kp): np.asarray(v) for kp, v in
                            jax.tree_util.tree_flatten_with_path(tree)[0]}
                           for tree in (new, mean_g))
    np.testing.assert_allclose(outs[0]["bpp"], np.mean(losses), rtol=1e-5)
    names = [k[len("param/"):] for k in outs[0] if k.startswith("param/")]
    assert len(names) == len(new_flat)
    for name in names:
        want = _jax_param(grad_flat, name)
        np.testing.assert_allclose(
            outs[0][f"grad/{name}"], want, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * float(np.abs(want).max()), err_msg=name)
        np.testing.assert_allclose(outs[0][f"param/{name}"],
                                   _jax_param(new_flat, name),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_dp_identical_patches_on_four_ranks_equal_one_process(tmp_path, jax_net):
    """tests/test_parallel.py:52's oracle: with the same patch on every
    rank the DP update is one process's update (patch_gradients, then the
    same Adam)."""
    _, flat, _ = jax_net
    patch = dp.pack_patch(_patch(np.random.default_rng(1)), CAPS)
    net = convert.codec_params_from_numpy(flat, TCFG, device="cpu")
    outs = _run_ranks(tmp_path, net, [patch] * 4, 4)
    _assert_ranks_bitwise_equal(outs)

    opt = dp.adam(1e-3)
    leaves = dict(net.named_parameters())
    state = opt.init(leaves)
    levels = [tuple(torch.as_tensor(patch[k][i]) for k in ("pc", "po", "pm", "gt"))
              for i in range(len(CAPS))]
    grads, bpp = dp.patch_gradients(net, TCFG, levels, patch["n_points"])
    opt.update(grads, state, leaves)
    np.testing.assert_allclose(outs[0]["bpp"], float(bpp), rtol=1e-6)
    for name, p in leaves.items():
        np.testing.assert_allclose(outs[3][f"grad/{name}"], grads[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(outs[3][f"param/{name}"],
                                   p.detach().numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
