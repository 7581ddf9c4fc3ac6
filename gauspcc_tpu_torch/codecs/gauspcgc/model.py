"""GausPcgc occupancy-context network over the sibling-packed layout: the
port's counterpart of gauspcc_tpu/codecs/gauspcgc/model.py (`NetConfig`
:36, `init_params` :108, `_head` :173, `split_occupancy` :180,
`merge_occupancy` :191, `_conv_stack_sib` :328, `_spatial_sib` :346,
`sib_context` :361, `sib_stage_probs` :393, `level_bits_sib` :410).

The reference's 4-stage occupancy predictor
(GausPcgc/network_ue_4stage_conv.py:11-181): prior embedding and conv
stack on the parents; the parents' features copied to their 8 octant
slots plus an octant embedding, and a conv stack on the children; then
four stage heads, each after its own 2-conv spatial net and conditioned
on an embedding of the bits coded before it:
  stage 0: bit 8 (2-way), stage 1: bit 7 (2-way, given bit 8),
  stage 2: bits 6-5 (4-way, given bits 8-7), stage 3: bits 4-1 (16-way).

The conv stacks run in `NetConfig.compute_dtype` (bf16 by default) with
the bias, relu and residual adds in that dtype; the heads run in float32,
as in JAX. Every gather clamps its indices where the JAX package's does
(JAX clamps out-of-range gathers, torch raises), and is an `index_select`,
whose backward is an `index_add_`: a table row read by a million voxels
(the embeddings') is summed by atomics on CUDA, fast but in no fixed
order, where indexing's sort-based backward serialises the duplicates
(1.9 s of a 2.4 s step on an H100); on the CPU the sum is sequential.

A group map argument is a `sibconv.GroupMap` (its gather rows and their
flip, built once per level, as the trainer's and the codec's geometry keep
them) or a group neighbor map [G, 27], converted on each call. The network trains
through autograd: the sib convs' gradients are `sibconv`'s scatter-free
backward; JAX rematerialises each conv stack (`jax.checkpoint`), which
the port needs not, since each conv keeps only its input for the
backward.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from gauspcc_tpu_torch.ops import sibconv

STAGE_SIZES = (2, 2, 4, 16)  # symbols per stage head
STAGE_COND = (1, 2, 4, 16)  # condition embedding rows (stage 0 has none)


class NetConfig(NamedTuple):
    """channels, kernel size and the conv stacks' dtype ("bf16" or "f32")."""

    channels: int = 32
    kernel_size: int = 5
    dtype: str = "bf16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bf16" else torch.float32


class _ResNet(nn.Module):
    def __init__(self, c, k):
        super().__init__()
        self.conv0 = sibconv.SibConv(c, c, k)
        self.conv1 = sibconv.SibConv(c, c, k)


class ConvStack(nn.Module):
    """conv + ReLU + 2 ResNets (prior_resnet / target_resnet)."""

    def __init__(self, c, k):
        super().__init__()
        self.conv = sibconv.SibConv(c, c, k)
        self.res0 = _ResNet(c, k)
        self.res1 = _ResNet(c, k)

    def forward(self, x, gm, slotmask):
        h = torch.relu(self.conv(x, gm, slotmask))
        for r in (self.res0, self.res1):
            h = torch.relu(h + r.conv1(torch.relu(r.conv0(h, gm, slotmask)),
                                       gm, slotmask))
        return h


class Spatial(nn.Module):
    """conv + ReLU + conv (spatial_s*)."""

    def __init__(self, c, k):
        super().__init__()
        self.conv0 = sibconv.SibConv(c, c, k)
        self.conv1 = sibconv.SibConv(c, c, k)

    def forward(self, x, gm, slotmask):
        return self.conv1(torch.relu(self.conv0(x, gm, slotmask)), gm,
                          slotmask)


class Head(nn.Module):
    """softmax(relu(x W0 + b0) W1 + b1) in float32."""

    def __init__(self, c, n_out):
        super().__init__()
        self.fc0 = nn.Linear(c, c)
        self.fc1 = nn.Linear(c, n_out)

    def forward(self, x):
        h = torch.relu(self.fc0(x.to(torch.float32)))
        return torch.softmax(self.fc1(h), dim=-1)


class GausPcgcNet(nn.Module):
    """The parameter tree of `init_params`, as modules: prior_embedding
    [256, C], prior_resnet, target_embedding [8, C], target_resnet, and
    per stage spatial_s*, head_s* and (stages 1-3) cond_emb_s*. Weights
    come from the JAX package through `convert.codec_params_from_numpy`."""

    def __init__(self, config: NetConfig = NetConfig()):
        super().__init__()
        c, k = config.channels, config.kernel_size
        self.prior_embedding = nn.Parameter(torch.zeros(256, c))
        self.prior_resnet = ConvStack(c, k)
        self.target_embedding = nn.Parameter(torch.zeros(8, c))
        self.target_resnet = ConvStack(c, k)
        for s in range(4):
            setattr(self, f"spatial_s{s}", Spatial(c, k))
            setattr(self, f"head_s{s}", Head(c, STAGE_SIZES[s]))
            if s > 0:
                setattr(self, f"cond_emb_s{s}",
                        nn.Parameter(torch.zeros(STAGE_COND[s], c)))


def init_net(config: NetConfig = NetConfig(), seed: int = 0) -> GausPcgcNet:
    """A freshly initialised network, with the distributions of JAX's
    `init_params` (model.py:108): embeddings N(0, 1); conv w and b
    U(+-1/sqrt(Cin k^3)); dense w and b U(+-1/sqrt(fan_in)). Drawn on the
    CPU from a torch generator seeded with `seed` (JAX's draws differ), so
    every device starts from the same weights."""
    net = GausPcgcNet(config)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "embedding" in name or name.startswith("cond_emb"):
                p.copy_(torch.randn(p.shape, generator=gen))
                continue
            owner = net.get_submodule(name.rpartition(".")[0])
            if isinstance(owner, sibconv.SibConv):
                fan_in = owner.w.shape[0] * owner.w.shape[1]
            else:  # nn.Linear: weight [out, in]
                fan_in = owner.weight.shape[1]
            bound = 1.0 / np.sqrt(fan_in)
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
    return net


def split_occupancy(occ: torch.Tensor):
    """Occupancy byte -> the 4 stage symbols (network_ue_4stage_conv.py:138-141)."""
    occ = occ.to(torch.int32)
    return (occ // 128) % 2, (occ // 64) % 2, (occ // 16) % 4, occ % 16


def merge_occupancy(s0, s1, s2, s3):
    """Inverse of split_occupancy."""
    return s0 * 128 + s1 * 64 + s2 * 16 + s3


def _clamp_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    return idx.to(torch.int64).clamp(0, n - 1)


def sib_context(net: GausPcgcNet, config: NetConfig, pocc_packed, pslotmask,
                p_gmapT, parent_pos, c_gmapT, c_slotmask) -> torch.Tensor:
    """Child context features over sibling-packed geometry -> [Pcap*8, C].

    pocc_packed int [Gp*8]: the parents' occupancy bytes in their own
    sibling packing (grouped by grandparent cell); pslotmask bool [Gp*8];
    p_gmapT int [Gp, 27]: the grandparent cells' neighbor map; parent_pos
    int [Pcap]: the packed row of parent i; c_gmapT int [Pcap, 27]: the
    parent cells' neighbor map; c_slotmask bool [Pcap*8]: the parents'
    occupancy bits. The maps are `sibconv.GroupMap`s or [G, 27] maps."""
    dt = config.compute_dtype
    pf = net.prior_embedding.index_select(0, _clamp_rows(pocc_packed, 256))
    pf = torch.where(pslotmask[:, None], pf, 0.0).to(dt)
    pf = net.prior_resnet(pf, sibconv.group_map(p_gmapT), pslotmask)
    pcap = parent_pos.shape[0]
    pf_vox = pf.index_select(0, _clamp_rows(parent_pos, pf.shape[0]))  # [Pcap, C]
    cf = (pf_vox[:, None, :] + net.target_embedding[None].to(dt)).reshape(
        pcap * 8, -1)
    cf = torch.where(c_slotmask[:, None], cf, 0).to(dt)
    return net.target_resnet(cf, sibconv.group_map(c_gmapT), c_slotmask)


def sib_stage_probs(net: GausPcgcNet, stage: int, cf, c_gmapT, c_slotmask,
                    prev_packed) -> torch.Tensor:
    """Stage probabilities over the packed children [Pcap*8, S]; prev_packed
    int [Pcap*8] = the earlier stages' symbols in packed order."""
    f = cf
    if stage > 0:
        table = getattr(net, f"cond_emb_s{stage}")
        cond = table.index_select(
            0, _clamp_rows(prev_packed, table.shape[0])).to(f.dtype)
        f = f + torch.where(c_slotmask[:, None], cond, 0)
    h = getattr(net, f"spatial_s{stage}")(f, sibconv.group_map(c_gmapT),
                                         c_slotmask)
    return getattr(net, f"head_s{stage}")(h)


def level_bits_sib(net: GausPcgcNet, config: NetConfig, pocc_packed,
                   pslotmask, p_gmapT, parent_pos, c_gmapT, c_slotmask,
                   gt_packed):
    """Teacher-forced bits to code one level's children, the rate estimate
    the coded size is held against. gt_packed int [Pcap*8] = the child
    occupancy bytes at (parent, octant). -> (total bits, valid children).
    Differentiable in every weight of `net` (the training objective)."""
    p_gmapT, c_gmapT = sibconv.group_map(p_gmapT), sibconv.group_map(c_gmapT)
    cf = sib_context(net, config, pocc_packed, pslotmask, p_gmapT, parent_pos,
                     c_gmapT, c_slotmask)
    total = torch.zeros((), dtype=torch.float32, device=cf.device)
    prev = torch.zeros_like(gt_packed, dtype=torch.int32)
    for stage, gt in enumerate(split_occupancy(gt_packed)):
        probs = sib_stage_probs(net, stage, cf, c_gmapT, c_slotmask, prev)
        p = probs.gather(1, gt.to(torch.int64)[:, None])[:, 0]
        bits = torch.clamp(-torch.log2(p + 1e-10), 0.0, 50.0)
        total = total + torch.where(c_slotmask, bits, 0.0).sum()
        if stage < 3:
            prev = gt if stage == 0 else prev * (2, 2, 4)[stage] + gt
    return total, c_slotmask.sum()
