"""GausPcgc batch coding, closed loop (cell gauspcgc.code_batch8).

Set-up makes the cell's clouds from the seed (traffic/clouds.py
`batch_clouds`), loads the tracked r5 weights through the program
(`convert.load_codec_npz`) and makes one round trip (building K5). The
window makes round trips until `seconds` have passed: each encodes the
clouds as one GPCB stream with the program's `compress_point_cloud_batch`
(the sib engine, version 5) into one file in TMPDIR, then decodes that
file with `decompress_point_cloud_batch`. The window's first round trip
keeps the stage probabilities its encoder computed (by holding the
tensors it hands to `cdf.probs_to_cdf_int16`) and every round trip's
decoded clouds are kept. After the window the plain reference works out
the pyramid and the probabilities again from the same clouds and the same
.npz.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import harness
from portbench.counts import codec_ops, rans_bytes
from portbench.reference import gauspcgc as ref
from portbench.traffic import clouds as traffic

ROOT = Path(__file__).resolve().parents[2]
# the limits of `correct`; a workload file's "limits" take their place for
# its cell (the coder's overhead over the ideal bits depends on the batch's
# size: PERF.md gives the readings each was set from)
LIMITS = {"clouds_differ": 0.0, "probs_gap": 0.035, "bits_gap": 0.04}


@contextlib.contextmanager
def record_codec(records: dict):
    """Keep, by reference, the lex-ordered stage probabilities the
    program's encoder turns into tables, with each table's shape, and each
    level's rANS word counts, while `records["on"]` is true."""
    from gauspcc_tpu_torch.core import cdf
    from gauspcc_tpu_torch.ops import rans

    cdf0, pack0 = cdf.probs_to_cdf_int16, rans.pack_stream
    records.update(on=False, probs=[], tables=[], words=[])

    def to_cdf(probs, *a, **kw):
        out = cdf0(probs, *a, **kw)
        if records["on"]:
            records["probs"].append(probs)
            records["tables"].append(tuple(out.shape))
        return out

    def pack(words, n_words, *a, **kw):
        if records["on"]:
            n = np.asarray(n_words)
            records["words"].append((int(n.sum()), int(n.shape[0])))
        return pack0(words, n_words, *a, **kw)

    cdf.probs_to_cdf_int16, rans.pack_stream = to_cdf, pack
    try:
        yield records
    finally:
        cdf.probs_to_cdf_int16, rans.pack_stream = cdf0, pack0


class Session:
    def __init__(self, cell, seed: int, device):
        from gauspcc_tpu_torch import convert
        from gauspcc_tpu_torch.codecs.gauspcgc import codec
        from gauspcc_tpu_torch.codecs.gauspcgc import model as net

        self.codec = codec
        self.limits = {**LIMITS, **cell.limits}
        tr = cell.traffic
        self.device = torch.device(device)
        conf = cell.config
        self.kernel_size = conf["model"]["kernel_size"]
        self.weights_path = ROOT / conf["weights"]
        self.net_cfg = net.NetConfig(conf["model"]["channels"],
                                     conf["model"]["kernel_size"],
                                     conf["model"]["dtype"])
        self.clouds = traffic.batch_clouds(
            seed, tr["clouds"], tr["centers"], tr["span"], tr["draws"],
            tr["sigma"], tr["structure_seed"])
        self.n_points = sum(c.shape[0] for c in self.clouds)
        harness.mark("clouds")
        self.net = convert.load_codec_npz(self.weights_path, self.net_cfg,
                                          device=self.device)
        self.tmp = tempfile.mkdtemp(prefix="portbench_")
        self.path = os.path.join(self.tmp, "batch.binb")
        self.records: dict = {}
        harness.mark("weights")
        self._round_trip()  # builds K5 and fills the allocator

    def _round_trip(self, profile=None):
        enc = self.codec.compress_point_cloud_batch(
            self.clouds, self.net, self.path, config=self.net_cfg,
            device=self.device, profile=None if profile is None else profile[0])
        dec = self.codec.decompress_point_cloud_batch(
            self.path, self.net, config=self.net_cfg, device=self.device,
            profile=None if profile is None else profile[1])
        return enc, dec

    def window(self, seconds: float, trace: bool) -> harness.Window:
        self.decoded, self.file_bits, profiles = [], [], []
        with record_codec(self.records) as rec:
            harness.sync(self.device)
            t0 = time.perf_counter()
            trips = 0
            while True:
                rec["on"] = trips == 0
                prof = ([], []) if trace else None
                enc, dec = self._round_trip(prof)
                self.decoded.append(dec["point_clouds"])
                self.file_bits.append(enc["file_size_bits"])
                if trace:
                    profiles.append(prof)
                trips += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            t1 = time.perf_counter()
            rec["on"] = False
        self.profiles = profiles
        window_s = t1 - t0
        return harness.Window(
            attempted=trips, failed=0,
            values={"code_points_per_s": self.n_points * trips / window_s},
            seconds=window_s)

    def trace_info(self) -> dict:
        def phase_ms(name):
            per_trip = []
            for enc, dec in self.profiles:
                per_trip.append(sum(lv.get(name, 0.0) for lv in enc + dec))
            return float(np.mean(per_trip)) if per_trip else None

        levels = ref.build_pyramid(ref.merge_clouds(self.clouds)[0])
        tables = self.records["tables"]
        words = self.records["words"]
        enc_b = dec_b = 0
        for d in range(len(levels) - 1):
            n_valid = levels[d + 1][0].shape[0]
            shapes = tables[4 * d:4 * d + 4]
            total, lanes = words[d]
            # the encoder's flush writes 2 words a lane that no step moves
            enc_b += rans_bytes.rans_bytes(shapes, n_valid, True, total - 2 * lanes)
            dec_b += rans_bytes.rans_bytes(shapes, n_valid, False, total)
        ops = codec_ops.round_trip_ops(levels, self.kernel_size,
                                       self.net_cfg.channels, self.device)
        return {"geometry_ms": phase_ms("geometry"),
                "context_ms": phase_ms("context"),
                "rans_enc_bound_ms": enc_b / rans_bytes.PEAK_BYTES_PER_S * 1e3,
                "rans_dec_bound_ms": dec_b / rans_bytes.PEAK_BYTES_PER_S * 1e3,
                "ops_per_unit": ops, "peak_flops": codec_ops.PEAK_BF16_FLOPS}

    def release(self) -> None:
        self.probs = [p.float() for p in self.records.get("probs", [])]
        self.records = {}
        del self.net
        shutil.rmtree(self.tmp, ignore_errors=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self, operand=torch.bfloat16):
        """(the pyramid, per level (probs, syms)) by the plain reference."""
        W = ref.load_weights(self.weights_path, self.device)
        levels = ref.build_pyramid(ref.merge_clouds(self.clouds)[0])
        with torch.no_grad():
            out = ref.pyramid_probs(W, levels, self.device,
                                    kernel_size=self.kernel_size,
                                    operand=operand)
        return levels, out

    def _header_bits(self, levels) -> int:
        """The stream's bits outside the per-level rANS payload: magic,
        version, posQ, M and L, shifts, counts, the base level (coords and
        occupancy) and the frames of the levels' streams (a u16 count, a
        u32 length each), in bits (codec.py compress_point_cloud_batch,
        bitstream.pack_byte_streams)."""
        m = len(self.clouds)
        n_base = levels[0][0].shape[0]
        return 8 * (4 + 1 + 2 + 8 + 12 * m + 8 * m + 4 + 13 * n_base
                    + 2 + 4 * (len(levels) - 1))

    def compare(self, got_probs, got_bits, got_clouds, want) -> list:
        levels, per_level = want
        # the encoder's tables, then (in a program run) the decoder's
        flat = [p for probs, _ in per_level for p in probs]
        gap = 0.0 if len(got_probs) in (len(flat), 2 * len(flat)) else float("inf")
        for i, g in enumerate(got_probs):
            w = flat[i % len(flat)]
            gap = max(gap, float((g[:w.shape[0]] - w).abs().max()))
        # the stream's size against the reference's ideal bits, worst round
        # trip: the coder's own overhead (about 1.1%) is what a sound run
        # reads; the control moves it by about 1e-4, an inflated stream
        # (faults.coarse_cdf) by far more (PERF.md)
        ideal = sum(float(ref.level_bits(p, s)) for p, s in per_level)
        ideal += self._header_bits(levels)
        bits_gap = max(abs(b - ideal) / ideal for b in got_bits)
        want_clouds = [ref.dedupe_lex(c) for c in self.clouds]
        bad = 0
        for trip in got_clouds:
            for got, want_c in zip(trip, want_clouds):
                got_c = ref.dedupe_lex(np.asarray(got).astype(np.int64))
                bad += int(got_c.shape != want_c.shape
                           or not np.array_equal(got_c, want_c))
        lim = self.limits
        return [harness.Check("clouds_differ", float(bad), lim["clouds_differ"]),
                harness.Check("probs_gap", gap, lim["probs_gap"]),
                harness.Check("bits_gap", bits_gap, lim["bits_gap"])]

    def check(self) -> list:
        return self.compare(self.probs, self.file_bits, self.decoded,
                            self.reference())

    def control(self) -> list:
        """The reference with float8 (e4m3) conv operands in the program's
        place: its probabilities and ideal bits against the bf16
        reference's (its decode is not run: the stream of a coder fed by
        the control's tables decodes exactly whatever the tables)."""
        want = self.reference()
        levels, per_level = self.reference(torch.float8_e4m3fn)
        probs = [p for ps, _ in per_level for p in ps]
        bits = sum(float(ref.level_bits(p, s)) for p, s in per_level)
        bits += self._header_bits(levels)
        return self.compare(probs, [bits], [], want)


def setup(cell, seed: int, device):
    return Session(cell, seed, device)
