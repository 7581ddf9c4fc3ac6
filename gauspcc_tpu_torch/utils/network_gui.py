"""The SIBR remote viewer's socket protocol, for a preview while training
(own copy of gauspcc_tpu/utils/network_gui.py, the wire format unchanged):
a non-blocking TCP listener that the training loop polls; the viewer sends
a JSON camera after a little-endian u32 length and gets back the frame's
raw HWC uint8 bytes, then a length-prefixed ASCII verify string. Cameras
come back as numpy matrices with the reference's y and z axis flips
applied.
"""

from __future__ import annotations

import json
import socket

import numpy as np

from gauspcc_tpu_torch.utils import profiling


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.host = host
        self.port = port
        self.conn = None
        self.addr = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)

    def try_connect(self) -> bool:
        if self.conn is not None:
            return True
        try:
            self.conn, self.addr = self.listener.accept()
            self.conn.settimeout(None)
            return True
        except (BlockingIOError, socket.timeout, OSError):
            return False

    def _read_json(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def receive(self):
        """Returns (camera dict or None, do_training, keep_alive,
        scaling_modifier). Camera dict: width/height/fovx/fovy +
        world_view_transform [4,4] with the reference's axis flips."""
        msg = self._read_json()
        width = msg["resolution_x"]
        height = msg["resolution_y"]
        if width == 0 or height == 0:
            return None, bool(msg.get("train", False)), bool(
                msg.get("keep_alive", False)), msg.get("scaling_modifier", 1.0)
        wvt = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        wvt[:, 1] = -wvt[:, 1]
        wvt[:, 2] = -wvt[:, 2]
        cam = {
            "width": width, "height": height,
            "fovx": msg["fov_x"], "fovy": msg["fov_y"],
            "znear": msg["z_near"], "zfar": msg["z_far"],
            "world_view_transform": wvt,
        }
        return (cam, bool(msg["train"]), bool(msg["keep_alive"]),
                msg["scaling_modifier"])

    def send(self, image_bytes: bytes | None, verify: str) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def disconnect(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self) -> None:
        self.disconnect()
        self.listener.close()


@profiling.span("gui.frame_bytes")
def image_to_bytes(img_chw: np.ndarray) -> bytes:
    """[3, H, W] float in [0,1] -> HWC uint8 bytes (viewer wire format)."""
    arr = np.clip(img_chw * 255.0, 0, 255).astype(np.uint8)
    return memoryview(np.ascontiguousarray(arr.transpose(1, 2, 0))).tobytes()
