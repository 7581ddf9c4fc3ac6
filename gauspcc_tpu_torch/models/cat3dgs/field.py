"""CAT-3DGS's PCA-oriented multi-scale triplane field (counterpart of
gauspcc_tpu/models/cat3dgs/field.py: `FieldConfig` :26, `adapt_resolution`
:39, `fit_pca` :44, `init_field` :67, `normalize` :84, `quantized_planes`
:93, `sample` :110, `field_rate_bits` :121).

Anchors are moved into the frame of their principal axes (`fit_pca`, after
dropping the local outliers), scaled by three times the axes' deviations,
contracted into the unit ball and read from a triplane [3, C, R, R] at each
of three scales. Each scale's latents are quantised at a gain of 2^g (its
entry of `gains`): rounded with a straight-through gradient, or with
additive uniform noise in training; the sample reads them divided by the
gain again. The per-plane-group ARMs (`arm.py`) give the latents' rate.

The outlier filter is the port's own Local Outlier Factor (Breunig et al.,
as scikit-learn's LocalOutlierFactor computes it: 50 neighbours, the 5%
lowest factors dropped) on scipy's cKDTree: the JAX package uses
scikit-learn's, which the card's machine lacks, and a frame fitted to
other points changes every context.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from gauspcc_tpu_torch.core.quant import ste_round
from gauspcc_tpu_torch.fields import triplane as tri
from gauspcc_tpu_torch.models.cat3dgs import arm
from gauspcc_tpu_torch.utils import profiling

GROUPS = ("xy", "xz", "yz")  # one ARM for each plane of every scale


class FieldConfig(NamedTuple):
    """The JAX package's FieldConfig, same fields and defaults."""

    n_feat: int = 1  # channels of a plane
    base_resolution: int = 64
    multiscale: tuple = (1, 2, 4)
    contract: bool = True
    layers_arm: tuple = (16, 16, 16, 16)

    def resolutions(self):
        return [self.base_resolution * m for m in self.multiscale]


def adapt_resolution(n_anchors: int) -> int:
    """A base plane resolution for an anchor count: round(sqrt(N / 36)),
    at least 16."""
    return max(16, int(round((n_anchors / 36.0) ** 0.5)))


def lof_inliers(points: np.ndarray, n_neighbors: int = 50,
                contamination: float = 0.05) -> np.ndarray:
    """bool [N]: the points whose Local Outlier Factor is not among the
    `contamination` share of the largest. Each point's n_neighbors nearest
    others (itself excluded; a duplicate when it has more duplicates than
    that), their reachability distances max(d, k-distance of the
    neighbour), the local reachability density 1 / (mean + 1e-10), and the
    negated factor -mean(lrd[neighbours]) / lrd; a point is an outlier
    below the contamination percentile of that."""
    from scipy.spatial import cKDTree

    x = np.asarray(points, np.float64)
    n = x.shape[0]
    k = min(n_neighbors, n - 1)
    dist, idx = cKDTree(x).query(x, k=k + 1)
    others = idx != np.arange(n)[:, None]
    others[np.all(others, axis=1), 0] = False
    dist = dist[others].reshape(n, k)
    idx = idx[others].reshape(n, k)
    reach = np.maximum(dist, dist[idx, k - 1])
    lrd = 1.0 / (np.mean(reach, axis=1) + 1e-10)
    nof = -np.mean(lrd[idx] / lrd[:, None], axis=1)
    return ~(nof < np.percentile(nof, 100.0 * contamination))


def fit_pca(points: np.ndarray, n_neighbors: int = 50,
            contamination: float = 0.05):
    """(rotation [3, 3], its columns the principal axes by decreasing
    variance; mean [3]; std [3]) of the points, float32, after dropping
    the local outliers (`lof_inliers`) when there are more than twice
    n_neighbors points."""
    pts = points
    if pts.shape[0] > n_neighbors * 2:
        pts = pts[lof_inliers(pts, n_neighbors, contamination)]
    mean = pts.mean(axis=0)
    eigval, eigvec = np.linalg.eigh(np.cov((pts - mean).T))
    order = np.argsort(eigval)[::-1]
    std = np.sqrt(np.maximum(eigval[order], 1e-12))
    return (eigvec[:, order].astype(np.float32), mean.astype(np.float32),
            std.astype(np.float32))


class Field(nn.Module):
    """The planes of each scale (`scales`, [3, n_feat, R, R] each), the
    ARMs of the three plane groups (`arms`), the per-scale log2 gains, and
    the PCA frame (`rotation`, `pca_mean`, `pca_std`), which trains like
    every other leaf, as in the JAX package."""

    def __init__(self, cfg: FieldConfig):
        super().__init__()
        self.scales = nn.ParameterList([
            nn.Parameter(torch.zeros(3, cfg.n_feat, r, r))
            for r in cfg.resolutions()])
        self.arms = nn.ModuleDict({g: arm.ARM(cfg.layers_arm) for g in GROUPS})
        n_scales = max(len(cfg.multiscale), 1)
        self.gains = nn.Parameter(
            torch.arange(0.0, float(len(cfg.multiscale)) + 2.0)[:n_scales])
        self.rotation = nn.Parameter(torch.eye(3))
        self.pca_mean = nn.Parameter(torch.zeros(3))
        self.pca_std = nn.Parameter(torch.ones(3))

    @torch.no_grad()
    def init_seeded(self, rng: np.random.Generator) -> "Field":
        """Planes of N(0, 0.2^2) and uniform ARMs, from a numpy Generator;
        gains 0, 1, 2, ... and the identity frame."""
        for p in self.scales:
            _, c, r, _ = p.shape
            p.copy_(tri.init_triplane(c, r, rng, std=0.2))
        for g in GROUPS:
            self.arms[g].init_uniform(rng)
        return self


def gain(field: Field, i: int) -> torch.Tensor:
    """2^gains[i], the one expression the encoder, the decoder and
    training all use."""
    return torch.pow(2.0, field.gains[i])


def normalize(field: Field, cfg: FieldConfig, x: torch.Tensor) -> torch.Tensor:
    """x [N, 3] in the PCA frame over 3 std, contracted into [-1, 1] when
    cfg.contract."""
    z = (x - field.pca_mean) @ field.rotation
    z = z / (3.0 * field.pca_std + 1e-9)
    if cfg.contract:
        z = tri.contract(z) * 0.5  # the radius-2 ball into [-1, 1]
    return z


def quantized_planes(field: Field, noise: list | None = None) -> list:
    """Each scale's planes times 2^g: rounded with a straight-through
    gradient, or, with `noise` (one U[-0.5, 0.5) draw a scale, shaped like
    its planes), plus the noise (training's proxy)."""
    out = []
    for i, planes in enumerate(field.scales):
        scaled = planes * gain(field, i)
        out.append(scaled + noise[i] if noise is not None else ste_round(scaled))
    return out


def plane_noise(field: Field, generator: torch.Generator | None = None) -> list:
    """quantized_planes' noise drawn from `generator`."""
    return [torch.rand(p.shape, generator=generator, dtype=p.dtype,
                       device=p.device) - 0.5 for p in field.scales]


def sample(field: Field, cfg: FieldConfig, x: torch.Tensor,
           planes_q: list | None = None) -> torch.Tensor:
    """The features of x [N, 3] read from the (de)quantised planes, [N, 3
    n_feat n_scales]: the scales side by side (`tri.sample_triplanes`:
    under grad, at one of K3's widths, one lookup over every scale's
    planes, whose gradient is one `hashgrid.table_grad`). While the
    recorder is on, its backward is the span `cat.field.bwd`: from the
    features' gradient to the last scale's dequantised planes'."""
    z = normalize(field, cfg, x)
    if planes_q is None:
        planes_q = quantized_planes(field)
    planes = [p / gain(field, i) for i, p in enumerate(planes_q)]
    out = tri.sample_triplanes(planes, z)
    profiling.backward_span("cat.field.bwd", out, planes)
    return out


@profiling.span("cat.arm_rate")
def field_rate_bits(field: Field, planes_q: list | None = None) -> torch.Tensor:
    """The ARMs' bits of every quantised latent (training's rate), plane by
    plane and channel by channel. Its forward is the span `cat.arm_rate`,
    which counts `arm_planes` (one a `plane_rate` call); while the recorder
    is on, its backward is the span `cat.arm_rate.bwd`: from the total's
    gradient to the last latent plane's."""
    if planes_q is None:
        planes_q = quantized_planes(field)
    total = 0.0
    latents = []
    for planes in planes_q:
        for p, g in enumerate(GROUPS):
            for c in range(planes.shape[1]):
                latents.append(planes[p, c])
                bits, _, _ = arm.plane_rate(field.arms[g], latents[-1])
                profiling.count("arm_planes")
                total = total + bits
    profiling.backward_span("cat.arm_rate.bwd", total, latents)
    return total
