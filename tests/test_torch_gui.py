"""The SIBR remote viewer in the port (gauspcc_tpu_torch/utils/network_gui.py,
`pipeline._poll_gui`, the CLI's --gui) against the JAX package's
(gauspcc_tpu/utils/network_gui.py, pipeline.py:505-541, cli.py:72-86), on
the CPU over localhost sockets.

Tolerances: none. The wire format is bytes, the camera a parsed message,
and the frame the port's own render of the state the poll saw, turned
into bytes by the same function.
"""

import copy
import json
import socket
import struct
import threading

import numpy as np
import jax
import pytest
import torch

from gauspcc_tpu.codecs.gauspcgc import model as jpcc
from gauspcc_tpu.utils import checkpoint as jcheckpoint
from gauspcc_tpu.utils import network_gui as jgui
from gauspcc_tpu_torch.cli import soak
from gauspcc_tpu_torch.models.hac import cli, pipeline
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.models.hac import render as hac_render
from gauspcc_tpu_torch.models.hac import train as hac_train
from gauspcc_tpu_torch.render import raster
from gauspcc_tpu_torch.utils import network_gui

from tests.test_colmap import write_colmap_fixture

SMALL = dict(feat_dim=16, n_offsets=4, voxel_size=0.05, resolutions_3d=(6, 10, 16),
             resolutions_2d=(16, 32), log2_hashmap_size=13,
             log2_hashmap_size_2d=13)  # tests/test_hac_train.py:17
W, H = 16, 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _message(train=True, keep_alive=False) -> bytes:
    """A viewer's camera message (tests/test_resume_gui.py:104-120): the
    view matrix with the axis flips receive() undoes."""
    wvt = np.eye(4, dtype=np.float32)
    wvt[3, 2] = 3.0
    msg_m = wvt.copy()
    msg_m[:, 1] = -msg_m[:, 1]
    msg_m[:, 2] = -msg_m[:, 2]
    payload = json.dumps({
        "resolution_x": W, "resolution_y": H, "train": train,
        "keep_alive": keep_alive, "scaling_modifier": 1.0, "fov_x": 1.0,
        "fov_y": 0.8, "z_near": 0.01, "z_far": 100.0,
        "view_matrix": msg_m.reshape(-1).tolist()}).encode()
    return struct.pack("<I", len(payload)) + payload


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("closed early")
        buf += chunk
    return buf


def _received(gui_cls, msg: bytes):
    gui = gui_cls("127.0.0.1", 0)
    try:
        cli_sock = socket.create_connection(
            ("127.0.0.1", gui.listener.getsockname()[1]), timeout=30)
        cli_sock.sendall(msg)
        for _ in range(1000):
            if gui.try_connect():
                break
        out = gui.receive()
        gui.send(b"\x01\x02", "dir")
        reply = _recv_exact(cli_sock, 2 + 4 + 3)
        cli_sock.close()
        return out, reply
    finally:
        gui.close()


@pytest.mark.parametrize("size", [(W, H), (0, 0)])
def test_receive_and_send_equal_jax(size):
    msg = _message()
    if size == (0, 0):  # a viewer with no window: no camera
        payload = json.dumps({"resolution_x": 0, "resolution_y": 0,
                              "train": True}).encode()
        msg = struct.pack("<I", len(payload)) + payload
    (got, got_reply), (want, want_reply) = (_received(network_gui.NetworkGUI, msg),
                                            _received(jgui.NetworkGUI, msg))
    assert got_reply == want_reply == b"\x01\x02" + struct.pack("<I", 3) + b"dir"
    assert got[1:] == want[1:]
    if want[0] is None:
        assert got[0] is None
        return
    assert set(got[0]) == set(want[0])
    for k, v in want[0].items():
        if isinstance(v, np.ndarray):
            assert got[0][k].dtype == v.dtype
            np.testing.assert_array_equal(got[0][k], v)
        else:
            assert got[0][k] == v


def test_image_to_bytes_equals_jax():
    img = np.random.default_rng(0).normal(0.5, 0.4, (3, H, W)).astype(np.float32)
    got = network_gui.image_to_bytes(img)
    assert got == jgui.image_to_bytes(img)
    assert len(got) == W * H * 3


def test_train_scene_serves_the_viewer_a_frame(tmp_path, monkeypatch):
    """As tests/test_resume_gui.py:91 drives the JAX package: a viewer asks
    for a 16x12 frame and lets training go on; the frame is the render of
    the state the poll saw, through render_view, and the verify string is
    the model directory."""
    scene = soak.build_scene(np.random.default_rng(0), 32, 150, 9, 400,
                             device="cpu")
    opt = hac_train.OptConfig(iterations=3, update_from=100, update_until=0,
                              lmbda=1e-3)
    gui = network_gui.NetworkGUI("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    viewer = socket.create_connection(("127.0.0.1", port), timeout=30)
    viewer.sendall(_message())  # waits in the socket until the first poll
    got = {}

    def read_frame():
        got["img"] = _recv_exact(viewer, W * H * 3)
        n = struct.unpack("<I", _recv_exact(viewer, 4))[0]
        got["verify"] = _recv_exact(viewer, n).decode()
        viewer.close()

    polled = []
    real_poll = pipeline._poll_gui

    def poll(gui, state, cfg, verify, log=print):
        if not polled:
            polled.append(copy.deepcopy(state))
        real_poll(gui, state, cfg, verify, log=log)

    t = threading.Thread(target=read_frame, daemon=True)
    t.start()
    model_dir = str(tmp_path / "gui")
    logs = []
    monkeypatch.setattr(pipeline, "_poll_gui", poll)
    try:
        pipeline.train_scene(scene, hac.HACConfig(**SMALL), opt, device="cpu",
                             model_dir=model_dir, eval_at_end=False,
                             log_every=0, gui=gui, log=logs.append)
    finally:
        gui.close()
    t.join(timeout=30)
    assert not t.is_alive(), "the viewer never got a frame"
    assert got["verify"] == model_dir
    # after the viewer closed, the next poll logged the disconnect and
    # training went on to its end
    assert any("viewer disconnected" in m for m in logs)
    wvt = np.eye(4, dtype=np.float32)
    wvt[3, 2] = 3.0
    cam = hac_render.CameraArrays(
        viewmatrix=torch.from_numpy(wvt),
        camera_center=torch.from_numpy(np.linalg.inv(wvt)[3, :3].astype(np.float32)))
    rcfg = raster.RasterConfig(H, W, float(np.tan(0.5)), float(np.tan(0.4)),
                               max_gaussians_per_tile=256)
    with torch.no_grad():
        out = hac_render.render_view(polled[0], hac.HACConfig(**SMALL), cam,
                                     rcfg, torch.zeros(3))
    assert got["img"] == network_gui.image_to_bytes(out["render"].numpy())


def test_cli_gui_reaches_train_scene(tmp_path, monkeypatch):
    """--gui builds a NetworkGUI on --ip:--port, hands it to train_scene and
    closes it afterwards (JAX cli.py:72-86)."""
    codec = str(tmp_path / "pcc.npz")
    jcheckpoint.save_pytree(codec, jpcc.init_params(jax.random.PRNGKey(3),
                                                    jpcc.NetConfig(8, 3)))
    root = str(tmp_path / "scene")
    write_colmap_fixture(root, n_images=4, wh=32, n_points=100)
    seen = {}

    def fake_train_scene(scene, cfg, opt, **kw):
        seen["gui"] = kw["gui"]
        if kw["gui"] is not None:
            seen["addr"] = kw["gui"].listener.getsockname()
        return None, {}

    monkeypatch.setattr(pipeline, "train_scene", fake_train_scene)
    cli.main(["train", "-s", root, "-m", str(tmp_path / "out"), "--gui",
              "--ip", "127.0.0.1", "--port", "0", "--pcc_ckpt", codec,
              "--pcc_channels", "8", "--pcc_kernel_size", "3",
              "--device", "cpu"])
    assert isinstance(seen["gui"], network_gui.NetworkGUI)
    assert seen["addr"][0] == "127.0.0.1" and seen["addr"][1] > 0
    assert seen["gui"].listener.fileno() == -1  # closed after training
    seen.clear()
    cli.main(["train", "-s", root, "-m", str(tmp_path / "out2"),
              "--pcc_ckpt", codec, "--pcc_channels", "8",
              "--pcc_kernel_size", "3", "--device", "cpu"])
    assert seen == {"gui": None}
