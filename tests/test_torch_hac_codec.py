"""HAC's scene bitstream in the port (gauspcc_tpu_torch/models/hac/codec.py)
against the JAX package's (gauspcc_tpu/models/hac/codec.py), on the CPU:
the small state of tests/test_hac_codec.py and the tracked r5 soak state.

Tolerances, each with its reason:
- the port's own round trip: exact (the decoder recomputes the encoder's
  models bit for bit and must give back what the encoder coded);
- component sizes against JAX's on the same state: within 1% (the
  context's float32 sums run in another order, which moves a rounding of
  the quantized attributes now and then); the binary streams (hash,
  masks) and the networks' size: exact;
- estimate_final_bits: within a relative 1e-4 (float32 sums of 10^4-10^5
  terms in another order);
- the r5 state against the sizes the JAX package recorded on the TPU
  (runs/soak_hac_r5/soak_summary.json): hash, masks and mlps exact, feat,
  scaling and offsets within 1% (the recorded context ran on the TPU);
  the JAX-written hash.b and masks.b decode exactly;
- morton order, unflatten_tables, checkpoints: exact.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.codecs.gauspcgc import model as jpcc
from gauspcc_tpu.fields import hashgrid as jhashgrid
from gauspcc_tpu.models.hac import codec as jcodec, model as jhac
from gauspcc_tpu.ops import sparse as jsparse
from gauspcc_tpu.utils import checkpoint as jcheckpoint
from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc
from gauspcc_tpu_torch.fields import hashgrid
from gauspcc_tpu_torch.models.hac import codec, model as hac
from gauspcc_tpu_torch.ops import entropy_coding as ec, sparse
from gauspcc_tpu_torch.utils import checkpoint

from test_torch_native_libs import ensure_jax_native_libs


ensure_jax_native_libs()  # before any test here loads one


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5 = os.path.join(REPO, "runs", "soak_hac_r5")
SMALL = dict(feat_dim=8, n_offsets=3, voxel_size=0.05, resolutions_3d=(6, 10, 16),
             resolutions_2d=(16, 32), log2_hashmap_size=13,
             log2_hashmap_size_2d=13)  # tests/test_hac_codec.py:13
JCFG, CFG = jhac.HACConfig(**SMALL), hac.HACConfig(**SMALL)
J_PCC, PCC = jpcc.NetConfig(8, 3), pcc.NetConfig(8, 3, "f32")
SIZE_RTOL = 0.01
ESTIMATE_RTOL = 1e-4


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jstate():
    """tests/test_hac_codec.py:26's state: seeded, attributes perturbed."""
    rng = np.random.default_rng(0)
    pts = jhac.voxelize_points((rng.random((500, 3)) * 2 - 1).astype(np.float32),
                               JCFG.voxel_size)
    state = jhac.update_anchor_bound(jhac.init_state(jax.random.PRNGKey(0), JCFG, pts))
    a = dict(state["anchors"])
    n = pts.shape[0]
    for name, mu, sd, shape in (("anchor_feat", 0, 0.5, (n, 8)),
                                ("offset", 0, 0.3, (n, 3, 3)),
                                ("mask", 1.0, 2.0, (n, 3, 1))):
        a[name] = a[name].at[:n].set(
            jnp.asarray(rng.normal(mu, sd, shape).astype(np.float32)))
    return dict(state, anchors=a)


@pytest.fixture(scope="module")
def state(jstate):
    return convert.state_from_numpy(_host(jstate), CFG, device="cpu")


@pytest.fixture(scope="module")
def jparams():
    return jpcc.init_params(jax.random.PRNGKey(7), J_PCC)


@pytest.fixture(scope="module")
def net(jparams):
    return convert.codec_params_from_numpy(_host(jparams), PCC, "cpu")


@pytest.fixture(scope="module")
def coded(tmp_path_factory, state, net):
    """The port's stream of the small state, what the encoder says the
    decoder must give, and the decoded state."""
    out = str(tmp_path_factory.mktemp("scene") / "bitstreams")
    values, profile = {}, {}
    sizes, log = codec.conduct_encoding(state, CFG, out, net, PCC,
                                        values=values, profile=profile)
    dec, dlog = codec.conduct_decoding(state, CFG, out, net, PCC)
    return out, sizes, log, values, profile, dec


def test_scene_round_trip_is_exact(state, coded):
    out, sizes, log, values, profile, dec = coded
    data = codec._gather_sorted_attributes(state, CFG)
    n = data["anchor_int"].shape[0]
    assert sizes["total"] == sum(v for k, v in sizes.items() if k != "total")
    assert "EncTime" in log and n == values["feat"].shape[0] > 0
    assert set(profile) == {"total_s", "anchors_s", "context_ms", "coder_s"}
    assert int(dec["valid"].sum()) == n
    assert dec["valid"].shape[0] == hac.bucket_capacity(n)
    a = dec["anchors"]
    np.testing.assert_array_equal(
        a["anchor"][:n].numpy(),
        data["anchor_int"].astype(np.float32) * CFG.voxel_size)
    assert torch.equal(a["mask"][:n], data["mask"])
    assert torch.equal(dec["nets"].tables.flat(), hac.encoding_params_flat(state))
    for name, key in (("feat", "anchor_feat"), ("scaling", "scaling"),
                      ("offset", "offset")):
        assert torch.equal(a[key][:n], values[name]), name
    # masked-off offsets decode to 0
    assert not bool(a["offset"][:n][(data["mask"] == 0).expand(-1, -1, 3)].any())
    # the networks are the float state's, copied
    assert torch.equal(dec["nets"].mlp_grid.fc1.weight,
                       state["nets"].mlp_grid.fc1.weight)
    assert dec["nets"] is not state["nets"]


def test_decoded_attributes_match_jax_quantization(state, coded, jstate):
    """The decoded values against the JAX package's STE quantization of
    the same attributes through JAX's context (tests/test_hac_codec.py:94):
    feat and offsets within 1e-4, scaling within 1e-5."""
    _, _, _, _, _, dec = coded
    data = jcodec._gather_sorted_attributes(jstate, JCFG)
    n = data["anchor_int"].shape[0]
    pos = data["anchor_int"].astype(np.float32) * JCFG.voxel_size
    ctx = _host(jcodec._batch_context(jstate, JCFG, jnp.asarray(
        np.pad(pos, ((0, jcodec.BATCH - n), (0, 0))))))
    from gauspcc_tpu.core.quant import ste_multistep

    def q(x, step, mean):
        return np.asarray(ste_multistep(jnp.asarray(x), jnp.asarray(step[:n]),
                                        jnp.float32(mean)))

    a = dec["anchors"]
    np.testing.assert_allclose(a["anchor_feat"][:n].numpy(),
                               q(data["feat"], ctx["q_feat"], data["feat"].mean()),
                               atol=1e-4)
    np.testing.assert_allclose(a["scaling"][:n].numpy(),
                               q(data["scaling"], ctx["q_scaling"],
                                 data["scaling"].mean()), atol=1e-5)
    want = q(data["offset"], ctx["q_offsets"][:, None, :], data["offset"].mean())
    want = want * data["mask"].repeat(3, -1)
    np.testing.assert_allclose(a["offset"][:n].numpy(), want, atol=1e-4)


def test_sizes_and_files_match_jax(tmp_path, jstate, jparams, coded):
    out, sizes, _, _, _, _ = coded
    jout = str(tmp_path / "jax")
    jsizes, _ = jcodec.conduct_encoding(jstate, JCFG, jout, jparams, J_PCC)
    assert set(sizes) == set(jsizes)
    for k in ("hash", "masks", "mlps"):
        assert sizes[k] == jsizes[k], k
    for k in ("anchor", "feat", "scaling", "offsets", "total"):
        assert sizes[k] == pytest.approx(jsizes[k], rel=SIZE_RTOL), k
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    for f in ("hash.b", "masks.b"):
        assert open(os.path.join(out, f), "rb").read() == \
            open(os.path.join(jout, f), "rb").read()
    meta, jmeta = (json.load(open(os.path.join(d, "meta.json"))) for d in (out, jout))
    assert meta["n_anchors"] == jmeta["n_anchors"] and meta["batch"] == jmeta["batch"]
    for k in ("feat_mean", "scaling_mean", "offsets_mean"):
        assert meta[k] == pytest.approx(jmeta[k], rel=1e-5, abs=1e-7)


def test_estimate_final_bits_matches_jax(state, jstate):
    got, log = codec.estimate_final_bits(state, CFG)
    want, _ = jcodec.estimate_final_bits(jstate, JCFG)
    assert set(got) == set(want) and log.startswith("Estimated sizes in MB")
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=ESTIMATE_RTOL), k


def test_model_helpers_match_jax(state, jstate):
    assert hac.mlp_size_bits(state) == jhac.mlp_size_bits(jstate)
    np.testing.assert_array_equal(hac.get_mask_anchor(state).numpy(),
                                  np.asarray(jhac.get_mask_anchor(jstate)))
    np.testing.assert_array_equal(
        hac.encoding_params_flat(state, binarize=False).detach().numpy(),
        np.asarray(jhac.encoding_params_flat(jstate, binarize=False)))
    decoded = dict(state, anchors=dict(state["anchors"], mask=(
        state["anchors"]["mask"] > 0.5).to(torch.float32)))
    jdecoded = dict(jstate, anchors=dict(jstate["anchors"], mask=(
        jstate["anchors"]["mask"] > 0.5).astype(jnp.float32)))
    np.testing.assert_array_equal(
        hac.get_mask_anchor(decoded, decoded=True).numpy(),
        np.asarray(jhac.get_mask_anchor(jdecoded, decoded=True)))


def test_morton_order_matches_jax():
    rng = np.random.default_rng(5)
    xyz = rng.integers(-40, 40, (3000, 3))  # negative coords and duplicates
    np.testing.assert_array_equal(sparse.morton_order_np(xyz),
                                  jsparse.morton_order_np(xyz))


def test_unflatten_tables_inverts_flat_and_matches_jax(state):
    spec = CFG.grid_spec
    flat = state["nets"].tables.flat().detach()
    tables = hashgrid.unflatten_tables(spec, flat)
    assert torch.equal(tables.flat(), flat)
    jt = jhashgrid.unflatten_tables(JCFG.grid_spec, jnp.asarray(flat.numpy()))
    for name in hashgrid.TABLE_NAMES:
        np.testing.assert_array_equal(getattr(tables, name).detach().numpy(),
                                      np.asarray(jt[name]))
    with pytest.raises(ValueError):
        hashgrid.unflatten_tables(spec, flat[1:])


def test_checkpoints_read_across_both_packages(tmp_path, state, jstate):
    path = str(tmp_path / "port.npz")
    checkpoint.save_pytree(path, state)
    back = jcheckpoint.load_pytree(path, jstate)  # JAX reads the port's
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_host(jstate))):
        np.testing.assert_array_equal(np.asarray(a), b)
    jpath = str(tmp_path / "jax.npz")
    jcheckpoint.save_pytree(jpath, jstate)  # the port reads JAX's
    with np.load(path) as p, np.load(jpath) as j:
        assert sorted(p.files) == sorted(j.files)
    loaded = checkpoint.load_pytree(jpath, state)
    assert loaded["nets"] is not state["nets"]
    for a, b in zip(state["nets"].parameters(), loaded["nets"].parameters()):
        assert torch.equal(a, b)
    for name, v in state["anchors"].items():
        assert torch.equal(loaded["anchors"][name], v)
    again = convert.state_from_numpy(checkpoint.load_pytree(jpath), CFG, "cpu")
    assert torch.equal(again["nets"].tables.xyz, state["nets"].tables.xyz)
    with pytest.raises(KeyError):
        checkpoint.load_pytree(jpath, {"missing": torch.zeros(1)})


# ---------------------------------------------------------------------------
# the r5 soak state at full width
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def r5_state():
    cfg = hac.HACConfig(voxel_size=0.01)  # gauspcc_tpu/cli/soak.py:144
    state = convert.state_from_numpy(
        checkpoint.load_pytree(os.path.join(R5, "model.npz")), cfg, "cpu")
    return state, cfg


def test_r5_sizes_against_the_recorded_ones(tmp_path, r5_state, net):
    """hash, masks and mlps exactly as recorded; feat, scaling and offsets
    within 1%. The anchors are coded by the small seeded codec (the
    recorded run used model/gauspcgc, which is slower on the CPU), so
    their size is not compared."""
    state, cfg = r5_state
    with open(os.path.join(R5, "soak_summary.json")) as f:
        rec = json.load(f)["size_bits"]
    sizes, _ = codec.conduct_encoding(state, cfg, str(tmp_path), net, PCC)
    assert (sizes["hash"], sizes["masks"], sizes["mlps"]) == (192_584, 103_016,
                                                              1_165_920)
    with open(os.path.join(tmp_path, "meta.json")) as f:
        assert json.load(f)["n_anchors"] == 10_953
    for k in ("feat", "scaling", "offsets"):
        assert sizes[k] == pytest.approx(rec[k], rel=SIZE_RTOL), k
    for f in ("hash.b", "masks.b"):
        assert open(os.path.join(tmp_path, f), "rb").read() == \
            open(os.path.join(R5, "bitstreams", f), "rb").read()


def test_r5_decodes_the_jax_written_hash_and_masks(r5_state):
    state, cfg = r5_state
    spec = cfg.grid_spec
    n_hash = spec.xyz.n_rows * 2 + 3 * spec.plane.n_rows * 2
    assert n_hash == 10_081_488
    flat01 = ec.decode_binary(n_hash, os.path.join(R5, "bitstreams", "hash.b"))
    want = (hac.encoding_params_flat(state).detach().reshape(-1) + 1.0) / 2.0
    assert torch.equal(flat01, want)
    data = codec._gather_sorted_attributes(state, cfg)
    masks = ec.decode_binary(10_953 * cfg.n_offsets,
                             os.path.join(R5, "bitstreams", "masks.b"))
    assert torch.equal(masks, data["mask"].reshape(-1))
