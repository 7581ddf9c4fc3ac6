"""Floating-point operations and least bytes of the ARMs' rate of the
planes over one CAT-3DGS training step, and its least time on an H100 (the
`arm_rate_roofline.cat` bound).

Counted from the shapes alone, whatever computes it: every latent pixel of
every plane, channel and scale passes its 12 causal neighbours through its
group's ARM, 2 x in x out a dense layer (12 -> 16, three 16 -> 16, 16 -> 2:
1,984 a pixel at the published widths); the backward takes the two products
of every layer (the input's gradient, which reaches the planes, and the
weights'), twice the forward. The rate's elementwise work (the scale's
exp, the Laplace masses, the logs) is not counted. Bytes: the forward reads
each latent once (4 B) and the weights; the backward reads each latent
again and writes its gradient (8 B), and reads and writes the weights. A
pass's least time is the larger of its operations at the float32 peak and
its bytes at HBM's bandwidth.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def layer_widths(shape) -> list:
    """(in, out) of each ARM layer, the head last."""
    widths, d_in = [], 12
    for d in shape.arm_layers:
        widths.append((d_in, d))
        d_in = d
    return widths + [(d_in, 2)]


def latent_pixels(shape) -> int:
    return sum(3 * shape.tri_feat * r * r for r in shape.resolutions)


def arm_rate_bound(shape) -> dict:
    """The forward's and the backward's operations and bytes, and the least
    time of both in ms."""
    widths = layer_widths(shape)
    per_pixel = sum(2 * a * b for a, b in widths)
    arm_params = sum(a * b + b for a, b in widths) * 3  # three groups
    px = latent_pixels(shape)
    fwd_ops, bwd_ops = px * per_pixel, 2 * px * per_pixel
    fwd_bytes = 4 * px + 4 * arm_params
    bwd_bytes = 8 * px + 8 * arm_params

    def least_ms(ops, nbytes):
        return max(ops / PEAK_FP32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3

    return {"pixels": px, "ops_per_pixel": per_pixel, "fwd_ops": fwd_ops,
            "bwd_ops": bwd_ops, "fwd_bytes": fwd_bytes, "bwd_bytes": bwd_bytes,
            "bound_ms": least_ms(fwd_ops, fwd_bytes) + least_ms(bwd_ops, bwd_bytes)}
