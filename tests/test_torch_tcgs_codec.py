"""TC-GS's scene bitstream in the port (gauspcc_tpu_torch/models/tcgs/
codec.py) against the JAX package's, on the CPU: the tracked record
runs/soak_tcgs_r5/bitstreams, and a seeded state of tests/test_tcgs.py's
size (feat_dim 8, 3 offsets, 4 plane channels at 16x16, 2 samples, a
4-channel latent; 300 points in [-1, 1]) coded by both packages with a
seeded NetConfig(8, 3) anchor codec.

Tolerances, each with its reason:
- masks.b byte for byte, and the record's masks decoded to JAX's symbols
  exactly (the same binary coder fed the same symbols);
- the f16 latent within 1 ulp of JAX's (the autoencoder's convolutions in
  two libraries round a value near a half-ulp of float16 either way);
- decode_latent of the record's latent: atol 1e-5 (convolutions of two
  libraries);
- feat, scaling and offsets bits within 0.5% of JAX's (the context's
  float32 sums in another order move a rounding now and then); the
  attributes each package decodes from its own stream within 1e-4 of
  each other (tests/test_hac_plus.py's bound on decoded features);
- the port's round trip exact, in repeat and in knn mode (the decoder
  recomputes every model bit for bit).
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gauspcc_tpu.codecs.gauspcgc import model as jpcc
from gauspcc_tpu.fields import triplane as jtri
from gauspcc_tpu.models.tcgs import codec as jcodec
from gauspcc_tpu.ops import entropy_coding as jec

from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc
from gauspcc_tpu_torch.fields import triplane as tri
from gauspcc_tpu_torch.models.hac import codec as hac_codec
from gauspcc_tpu_torch.models.tcgs import codec
from gauspcc_tpu_torch.ops import entropy_coding as ec

from test_torch_native_libs import ensure_jax_native_libs
from test_torch_tcgs import configs, jax_state, one_torch_thread, port_ae  # noqa: F401


ensure_jax_native_libs()  # before any test here loads one

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO, "runs", "soak_tcgs_r5", "bitstreams")
J_PCC, PCC = jpcc.NetConfig(8, 3), pcc.NetConfig(8, 3, "f32")
SIZE_RTOL = 0.005
DECODED_ATOL = 1e-4


def test_record_masks_and_latent_decode_as_in_jax():
    """The r5 record's masks.b (29,603 anchors x 10 offsets, from its
    meta.json) decodes to JAX's symbols; its f16 latent reconstructs, under
    seeded full-width autoencoder weights, as JAX's does."""
    with open(os.path.join(RECORD, "meta.json")) as f:
        meta = json.load(f)
    n = meta["n_anchors"] * 10
    assert n == 296_030
    path = os.path.join(RECORD, "masks.b")
    got = ec.decode_binary(n, path)
    want = np.asarray(jec.decode_binary(n, path))
    assert got.shape == want.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    latent16 = np.load(os.path.join(RECORD, codec.LATENT_FILE))["latent"]
    assert latent16.dtype == np.float16 and latent16.shape == (3, 8, 4, 4)
    cfg = jtri.AEConfig(16, 8)  # TCGSConfig's full width
    params = jtri.init_autoencoder(jax.random.PRNGKey(12), cfg)
    want = jtri.decode_latent(params, jnp.asarray(latent16.astype(np.float32)))
    with torch.no_grad():
        planes = tri.decode_latent(port_ae(params, tri.AEConfig(16, 8)),
                                   torch.from_numpy(latent16.astype(np.float32)))
    assert tuple(planes.shape) == (3, 16, 32, 32)
    np.testing.assert_allclose(planes.numpy(), np.asarray(want), atol=1e-5)


@pytest.fixture(scope="module")
def states():
    """tests/test_tcgs.py:58's state in both packages (live rows
    perturbed), and the small codec in both."""
    jcfg, tcfg = configs()
    state, flat = jax_state(0, spread=1.0, every_row=False)
    jparams = jpcc.init_params(jax.random.PRNGKey(5), J_PCC)
    net = convert.codec_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), PCC, "cpu")
    return state, convert.state_from_numpy(flat, tcfg, device="cpu"), jparams, net


def test_codec_files_and_sizes_match_jax(tmp_path, states):
    state, tstate, jparams, net = states
    jcfg, tcfg = configs()
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    sizes, log = codec.conduct_encoding(tstate, tcfg, out, net, PCC)
    jsizes, _ = jcodec.conduct_encoding(state, jcfg, jout, jparams, J_PCC)
    assert list(sizes) == list(jsizes) == [
        "anchor", "feat", "scaling", "offsets", "triplane", "masks", "mlps",
        "total"]
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    assert "hash.b" not in os.listdir(out) and "EncTime" in log
    assert ((tmp_path / "port" / "masks.b").read_bytes()
            == (tmp_path / "jax" / "masks.b").read_bytes())
    for k in ("triplane", "masks", "mlps"):
        assert sizes[k] == jsizes[k], k
    for k in ("feat", "scaling", "offsets"):
        assert sizes[k] == pytest.approx(jsizes[k], rel=SIZE_RTOL), k
    lat = np.load(os.path.join(out, codec.LATENT_FILE))["latent"]
    jlat = np.load(os.path.join(jout, codec.LATENT_FILE))["latent"]
    assert lat.dtype == jlat.dtype == np.float16 and lat.shape == jlat.shape
    ulps = np.abs(lat.view(np.int16).astype(np.int32)
                  - jlat.view(np.int16).astype(np.int32))
    assert ulps.max() <= 1
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(jout, "meta.json")) as f:
        jmeta = json.load(f)
    assert set(meta) == set(jmeta)
    assert meta["n_anchors"] == jmeta["n_anchors"]
    # each package decodes its own stream to the same attributes
    dec, _ = codec.conduct_decoding(tstate, tcfg, out, net, PCC)
    jdec, _ = jcodec.conduct_decoding(state, jcfg, jout, jparams, J_PCC)
    n = meta["n_anchors"]
    for key in ("anchor", "mask", "anchor_feat", "scaling", "offset"):
        np.testing.assert_allclose(dec["anchors"][key][:n].numpy(),
                                   np.asarray(jdec["anchors"][key])[:n],
                                   atol=DECODED_ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("knn", [False, True])
def test_round_trip_is_exact(tmp_path, states, knn):
    """The port's decode gives back exactly what its encoder coded: the
    anchors, masks, the latent, the reconstructed planes, feat, scaling
    and offsets (knn mode as tests/test_tcgs.py:142 runs it)."""
    _, tcfg = configs(knn)
    _, flat = jax_state(6 if knn else 0, n_pts=250, spread=1.0,
                        every_row=False, knn=knn)
    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    net = states[3]
    out = str(tmp_path / "bs")
    values, profile = {}, {}
    sizes, _ = codec.conduct_encoding(tstate, tcfg, out, net, PCC,
                                      values=values, profile=profile)
    assert set(profile) == {"total_s", "anchors_s", "context_ms", "coder_s"}
    again, _ = codec.conduct_encoding(tstate, tcfg, str(tmp_path / "again"),
                                      net, PCC)
    assert again == sizes
    dec, _ = codec.conduct_decoding(tstate, tcfg, out, net, PCC)
    data = hac_codec._gather_sorted_attributes(tstate, tcfg.as_hac())
    n = data["anchor_int"].shape[0]
    assert n == values["feat"].shape[0] > 0 and int(dec["valid"].sum()) == n
    a = dec["anchors"]
    np.testing.assert_array_equal(
        a["anchor"][:n].numpy(),
        data["anchor_int"].astype(np.float32) * tcfg.voxel_size)
    assert torch.equal(a["mask"][:n], data["mask"])
    for name, key in (("feat", "anchor_feat"), ("scaling", "scaling"),
                      ("offset", "offset")):
        assert torch.equal(a[key][:n], values[name]), name
    latent16 = np.load(os.path.join(out, codec.LATENT_FILE))["latent"]
    np.testing.assert_array_equal(latent16, values["latent"].numpy())
    assert torch.equal(dec["nets"].planes, values["planes"])
    assert dec["nets"] is not tstate["nets"]
    assert not torch.equal(dec["nets"].planes, tstate["nets"].planes)
    assert torch.equal(dec["nets"].mlp_triplane.fc1.weight,
                       tstate["nets"].mlp_triplane.fc1.weight)
