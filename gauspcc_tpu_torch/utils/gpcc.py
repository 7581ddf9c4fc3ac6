"""The optional MPEG G-PCC (tmc3) shell shim, a baseline for the anchors'
geometry (own copy of gauspcc_tpu/utils/gpcc.py): an alternative to
GausPcgc position coding that the shipped path does not use, gated on the
tmc3 binary being on PATH.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from gauspcc_tpu_torch.codecs.gauspcgc.data import read_points, save_ply_ascii_geo


def tmc3_available(binary: str = "tmc3") -> bool:
    return shutil.which(binary) is not None


def gpcc_encode(xyz_int: np.ndarray, bin_path: str, binary: str = "tmc3",
                posq_scale: int = 1) -> int:
    """Encode integer coords with tmc3; returns bit size. Raises if the
    binary is unavailable (callers should gate on tmc3_available())."""
    if not tmc3_available(binary):
        raise RuntimeError("tmc3 binary not found; G-PCC path is optional — "
                           "use the GausPcgc codec instead")
    ply = bin_path + ".tmp.ply"
    save_ply_ascii_geo(xyz_int.astype(np.float32), ply)
    res = subprocess.run(
        [binary, "--mode=0", f"--positionQuantizationScale={posq_scale}",
         "--trisoupNodeSizeLog2=0", "--mergeDuplicatedPoints=1",
         f"--uncompressedDataPath={ply}", f"--compressedStreamPath={bin_path}"],
        capture_output=True, text=True,
    )
    os.remove(ply)
    if res.returncode != 0:
        raise RuntimeError(f"tmc3 encode failed: {res.stderr[-500:]}")
    return os.stat(bin_path).st_size * 8


def gpcc_decode(bin_path: str, binary: str = "tmc3") -> np.ndarray:
    if not tmc3_available(binary):
        raise RuntimeError("tmc3 binary not found")
    ply = bin_path + ".dec.ply"
    res = subprocess.run(
        [binary, "--mode=1", f"--compressedStreamPath={bin_path}",
         f"--reconstructedDataPath={ply}", "--outputBinaryPly=0"],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(f"tmc3 decode failed: {res.stderr[-500:]}")
    pts = read_points(ply)
    os.remove(ply)
    return pts
