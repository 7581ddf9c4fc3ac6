"""CAT-3DGS's scene bitstream in the port (gauspcc_tpu_torch/models/cat3dgs/
codec.py and the fixed-point coder of arm.py) against the JAX package's,
on the CPU: the tracked record runs/soak_cat3dgs_r5/bitstreams, and a
seeded state of tests/test_cat3dgs.py's size (feat_dim 8 in slices (4, 4),
3 offsets, one-channel planes at 16 and 32; 300 points in [-1, 1]) coded
by both packages with a seeded NetConfig(8, 3) anchor codec.

Tolerances, each with its reason:
- the record: arm_q.bin repacked byte for byte, the nine planes decoded
  to JAX's integers exactly and re-encoded byte for byte, masks.b decoded
  to JAX's symbols exactly (integer arithmetic, the same coder);
- the seeded state's arm_q.bin, tri_*.b and masks.b byte for byte (the
  planes' round at integer gains and the integer ARM are exact); feat,
  scaling and offsets bits within 0.5% of JAX's (the hyperprior's float32
  sums in another order move a rounding now and then), and the attributes
  each package decodes from its own stream within 1e-4 of each other
  (tests/test_hac_plus.py's bound on decoded features);
- the port's round trip exact, with the chcm heads off and on (the
  decoder recomputes every model bit for bit).
"""

import json
import os

import numpy as np
import jax
import pytest
import torch

from gauspcc_tpu.codecs.gauspcgc import model as jpcc
from gauspcc_tpu.models.cat3dgs import arm as jarm
from gauspcc_tpu.models.cat3dgs import codec as jcodec
from gauspcc_tpu.ops import entropy_coding as jec

from gauspcc_tpu_torch import convert
from gauspcc_tpu_torch.codecs.gauspcgc import model as pcc
from gauspcc_tpu_torch.models.cat3dgs import arm
from gauspcc_tpu_torch.models.cat3dgs import codec
from gauspcc_tpu_torch.models.cat3dgs import field as cfield
from gauspcc_tpu_torch.models.hac import codec as hac_codec
from gauspcc_tpu_torch.ops import entropy_coding as ec

from test_torch_cat3dgs import configs, jax_state
from test_torch_native_libs import ensure_jax_native_libs
from test_torch_tcgs import one_torch_thread  # noqa: F401

ensure_jax_native_libs()  # before any test here loads one

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(REPO, "runs", "soak_cat3dgs_r5", "bitstreams")
J_PCC, PCC = jpcc.NetConfig(8, 3), pcc.NetConfig(8, 3, "f32")
SIZE_RTOL = 0.005
DECODED_ATOL = 1e-4


def _record_arms():
    with open(os.path.join(RECORD, "arm_q.bin"), "rb") as f:
        blob = f.read()
    qarms, off = {}, 0
    for g in cfield.GROUPS:
        qarms[g], used = arm.unpack_arm(blob, off)
        off += used
    return blob, qarms, off


@pytest.mark.parametrize("scale", [0, 1, 2])
def test_record_planes_decode_to_jax_integers_and_reencode(scale):
    """The r5 record's arm_q.bin (the three integer ARMs, 13,680 bytes)
    repacks byte for byte; its planes of one scale (64^2, 128^2, 256^2)
    decode under them to the JAX package's integers and encode back to the
    tracked files byte for byte."""
    blob, qarms, used = _record_arms()
    assert used == len(blob) == 13_680
    assert b"".join(arm.pack_arm(qarms[g]) for g in cfield.GROUPS) == blob
    res = 64 << scale
    for g in cfield.GROUPS:
        with open(os.path.join(RECORD, f"tri_{scale}_{g}_0.b"), "rb") as f:
            stream = f.read()
        got = arm.decode_plane_fixed(qarms[g], stream)
        want = jarm.decode_plane_fixed(qarms[g], stream)
        assert got.shape == (res, res) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert np.abs(got).max() <= 3
        assert arm.encode_plane_fixed(qarms[g], got) == stream


def test_record_masks_decode_as_in_jax():
    """The record's masks.b (29,603 anchors x 10 offsets, from its
    meta.json) decodes to JAX's symbols."""
    with open(os.path.join(RECORD, "meta.json")) as f:
        meta = json.load(f)
    assert meta["batch"] == codec.BATCH == 500
    n = meta["n_anchors"] * 10
    assert n == 296_030
    path = os.path.join(RECORD, "masks.b")
    got = ec.decode_binary(n, path)
    want = np.asarray(jec.decode_binary(n, path))
    assert got.shape == want.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def states():
    """tests/test_cat3dgs.py:61's state in both packages (live rows
    perturbed), and the small codec in both."""
    _, tcfg = configs()
    state, flat = jax_state(0, spread=1.0, every_row=False)
    jparams = jpcc.init_params(jax.random.PRNGKey(5), J_PCC)
    net = convert.codec_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), PCC, "cpu")
    return state, convert.state_from_numpy(flat, tcfg, device="cpu"), jparams, net


def test_codec_files_and_sizes_match_jax(tmp_path, states):
    state, tstate, jparams, net = states
    jcfg, tcfg = configs()
    out, jout = tmp_path / "port", tmp_path / "jax"
    sizes, log = codec.conduct_encoding(tstate, tcfg, str(out), net, PCC)
    jsizes, _ = jcodec.conduct_encoding(state, jcfg, str(jout), jparams, J_PCC)
    assert list(sizes) == list(jsizes) == [
        "anchor", "feat", "scaling", "offsets", "triplane", "masks", "mlps",
        "total"]
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(jout)) and "EncTime" in log
    planes = [n for n in names if n.startswith("tri_")]
    assert planes == [f"tri_{s}_{g}_0.b" for s in (0, 1) for g in cfield.GROUPS]
    assert "feat_0_0.b" in names and "feat_0_1.b" in names
    for name in ("arm_q.bin", "masks.b", *planes):
        assert (out / name).read_bytes() == (jout / name).read_bytes(), name
    for k in ("triplane", "masks", "mlps"):
        assert sizes[k] == jsizes[k], k
    for k in ("feat", "scaling", "offsets"):
        assert sizes[k] == pytest.approx(jsizes[k], rel=SIZE_RTOL), k
    meta = json.loads((out / "meta.json").read_text())
    jmeta = json.loads((jout / "meta.json").read_text())
    assert list(meta) == list(jmeta) and meta["n_anchors"] == jmeta["n_anchors"]
    assert meta["batch"] == 500
    # each package decodes its own stream to the same attributes
    dec, _ = codec.conduct_decoding(tstate, tcfg, str(out), net, PCC)
    jdec, _ = jcodec.conduct_decoding(state, jcfg, str(jout), jparams, J_PCC)
    n = meta["n_anchors"]
    for key in ("anchor", "mask", "anchor_feat", "scaling", "offset"):
        np.testing.assert_allclose(dec["anchors"][key][:n].numpy(),
                                   np.asarray(jdec["anchors"][key])[:n],
                                   atol=DECODED_ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("heads", [False, True])
def test_round_trip_is_exact(tmp_path, states, heads):
    """The port's decode gives back exactly what its encoder coded: the
    anchors, masks, the integer planes, both feature slices, scaling and
    offsets, with the chcm heads of the offsets and the scaling off and on
    (tests/test_cat3dgs.py:199), over more than one batch."""
    kw = dict(chcm_for_offsets=heads, chcm_for_scaling=heads)
    _, tcfg = configs(**kw)
    _, flat = jax_state(9 if heads else 0, n_pts=1200, spread=1.0,
                        every_row=False, **kw)
    tstate = convert.state_from_numpy(flat, tcfg, device="cpu")
    net = states[3]
    out = str(tmp_path / "bs")
    values, profile = {}, {}
    sizes, _ = codec.conduct_encoding(tstate, tcfg, out, net, PCC,
                                      values=values, profile=profile)
    assert set(profile) == {"total_s", "anchors_s", "triplane_s", "context_ms",
                            "coder_s"}
    again, _ = codec.conduct_encoding(tstate, tcfg, str(tmp_path / "again"),
                                      net, PCC)
    assert again == sizes
    dprof = {}
    dec, _ = codec.conduct_decoding(tstate, tcfg, out, net, PCC, profile=dprof)
    assert set(dprof) == set(profile)
    data = hac_codec._gather_sorted_attributes(tstate, tcfg.as_hac())
    n = data["anchor_int"].shape[0]
    assert n == values["feat"].shape[0] > codec.BATCH
    assert int(dec["valid"].sum()) == n
    a = dec["anchors"]
    np.testing.assert_array_equal(
        a["anchor"][:n].numpy(),
        data["anchor_int"].astype(np.float32) * tcfg.voxel_size)
    assert torch.equal(a["mask"][:n], data["mask"])
    for name, key in (("feat", "anchor_feat"), ("scaling", "scaling"),
                      ("offset", "offset")):
        assert torch.equal(a[key][:n], values[name]), name
    for i, cols in enumerate(codec._slices(tcfg)):  # each slice on its own
        assert torch.equal(a["anchor_feat"][:n, cols], values["feat"][:, cols]), i
    # the decoded field holds the stream's planes
    decoded = codec.decode_triplanes(tcfg, out, "cpu")
    for got, want, mine in zip(decoded, values["planes"],
                               cfield.quantized_planes(dec["nets"].field)):
        assert torch.equal(got, want) and torch.equal(mine, want)
    assert dec["nets"] is not tstate["nets"]
    assert torch.equal(dec["nets"].field.rotation, tstate["nets"].field.rotation)
