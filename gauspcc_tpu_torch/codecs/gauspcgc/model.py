"""GausPcgc occupancy-context network: the port's counterpart of
gauspcc_tpu/codecs/gauspcgc/model.py (`NetConfig` :36, `init_params` :108,
`_conv` .. `_spatial` :131-170, `_head` :173, `split_occupancy` :180,
`merge_occupancy` :191, `level_context` :200, `level_context_packed`
:253, `stage_probs` :283, `level_bits` :299, `level_bits_packed` :314,
`_conv_stack_sib` :328, `_spatial_sib` :346, `sib_context` :361,
`sib_stage_probs` :393, `level_bits_sib` :410, `_staged_bits` :437).

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

One `GausPcgcNet` serves both convs: the sibling-packed one (its modules'
forward, over group maps) and the general submanifold conv
(`level_context*`, `stage_probs`, `level_bits*`: plain functions reading
each `SibConv`'s w [k^3, Cin, Cout] and b, over the neighbor maps of
ops/sparse.py), so one set of weights serves every engine of the codec.
The general conv stacks, as JAX's, mask no slot: a padded row's output is
its bias, which no valid row reads. Their convs keep only their input for
the backward (`sparse._SparseConv`).

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

from gauspcc_tpu_torch.ops import sibconv, sparse

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


# ---------------------------------------------------------------------------
# the general submanifold conv over neighbor maps (engines 6 and 7, and the
# legacy training levels)
# ---------------------------------------------------------------------------

def _conv(conv: sibconv.SibConv, feats, nmap: sparse.NeighborMap):
    return sparse.sparse_conv_apply(feats, nmap, conv.w, conv.b)


def _as_dense_map(nmap, kernel_size: int) -> sparse.NeighborMap:
    """A dense NeighborMap as it is; a packed WindowMap expanded."""
    if isinstance(nmap, sparse.WindowMap):
        return sparse.nmap_from_packed(nmap, kernel_size)
    return nmap


def _resnet(r: _ResNet, feats, nmap):
    h = torch.relu(_conv(r.conv0, feats, nmap))
    return torch.relu(_conv(r.conv1, h, nmap) + feats)


def _conv_stack(stack: ConvStack, feats, nmap):
    """conv + ReLU + 2 ResNets."""
    h = torch.relu(_conv(stack.conv, feats, nmap))
    return _resnet(stack.res1, _resnet(stack.res0, h, nmap), nmap)


def _spatial(sp: Spatial, feats, nmap):
    """conv + ReLU + conv."""
    return _conv(sp.conv1, torch.relu(_conv(sp.conv0, feats, nmap)), nmap)


def level_context(net: GausPcgcNet, config: NetConfig, parent_coords,
                  parent_occ, parent_mask, child_cap: int) -> dict:
    """Parent-to-child context of one level, the geometry built on the
    parents' device: the children expanded, lex-sorted (valid first) and
    cut to `child_cap` rows (`sparse.sorted_children`, engine 7's), their
    features after target_resnet, and their neighbor map (which the four
    stages reuse, and which is the next level's parent map).
    -> {child_coords, child_mask, octant, feats, nmap}."""
    k = config.kernel_size
    p_nmap = sparse.build_neighbor_map(parent_coords, parent_mask,
                                       parent_coords, parent_mask, k)
    child, child_mask, octant, parent_idx = sparse.sorted_children(
        parent_coords, parent_occ, parent_mask, child_cap)
    c_nmap = sparse.build_neighbor_map(child, child_mask, child, child_mask, k)
    feats = level_context_packed(net, config, parent_occ, parent_mask, p_nmap,
                                 octant, parent_idx, child_mask, c_nmap)
    return {"child_coords": child, "child_mask": child_mask, "octant": octant,
            "feats": feats, "nmap": c_nmap}


def level_context_packed(net: GausPcgcNet, config: NetConfig, parent_occ,
                         parent_mask, p_nmap, octant, parent_idx, child_mask,
                         c_nmap) -> torch.Tensor:
    """Child context features [Cc, C] from prebuilt geometry: the parents'
    occupancy and mask [Np], their map, and per child (lex order, padded to
    Cc) its octant, parent row (< 0 on padding) and mask. The maps are
    NeighborMaps or WindowMaps. Equal to `level_context`'s features."""
    dt = config.compute_dtype
    k = config.kernel_size
    p_nmap = _as_dense_map(p_nmap, k)
    c_nmap = _as_dense_map(c_nmap, k)
    pf = net.prior_embedding.index_select(0, _clamp_rows(parent_occ, 256))
    pf = torch.where(parent_mask[:, None], pf, 0.0).to(dt)
    pf = _conv_stack(net.prior_resnet, pf, p_nmap)
    cf = (pf.index_select(0, _clamp_rows(parent_idx, pf.shape[0]))
          + net.target_embedding.index_select(0, _clamp_rows(octant, 8)).to(dt))
    cf = torch.where(child_mask[:, None], cf, 0).to(dt)
    return _conv_stack(net.target_resnet, cf, c_nmap)


def stage_probs(net: GausPcgcNet, stage: int, ctx_feats, nmap,
                prev_sym) -> torch.Tensor:
    """One stage's probabilities [Cc, S] given the earlier symbols prev_sym
    int [Cc] (0 at stage 0; then bit 8, bits 8-7, bits 8-5)."""
    sp = getattr(net, f"spatial_s{stage}")
    nmap = _as_dense_map(nmap, sp.conv0.kernel_size)
    f = ctx_feats
    if stage > 0:
        table = getattr(net, f"cond_emb_s{stage}")
        f = f + table.index_select(
            0, _clamp_rows(prev_sym, table.shape[0])).to(f.dtype)
    return getattr(net, f"head_s{stage}")(_spatial(sp, f, nmap))


def level_bits(net: GausPcgcNet, config: NetConfig, parent_coords,
               parent_occ, parent_mask, gt_child_occ):
    """Teacher-forced bits of one level, the geometry built on the device:
    gt_child_occ int [C] aligned with the sorted valid children, C the
    child capacity. -> (total bits, valid children)."""
    ctx = level_context(net, config, parent_coords, parent_occ, parent_mask,
                        child_cap=gt_child_occ.shape[0])
    return _staged_bits(net, ctx["feats"], ctx["nmap"], ctx["child_mask"],
                        gt_child_occ)


def level_bits_packed(net: GausPcgcNet, config: NetConfig, parent_occ,
                      parent_mask, p_nmap, octant, parent_idx, child_mask,
                      c_nmap, gt_child_occ):
    """`level_bits` over prebuilt geometry (see `level_context_packed`); the
    child map is expanded once for the context and the four stages."""
    c_nmap = _as_dense_map(c_nmap, config.kernel_size)
    feats = level_context_packed(net, config, parent_occ, parent_mask, p_nmap,
                                 octant, parent_idx, child_mask, c_nmap)
    return _staged_bits(net, feats, c_nmap, child_mask, gt_child_occ)


def _staged_bits(net, feats, nmap, mask, gt_child_occ):
    total = torch.zeros((), dtype=torch.float32, device=feats.device)
    prev = torch.zeros_like(gt_child_occ, dtype=torch.int32)
    for stage, gt in enumerate(split_occupancy(gt_child_occ)):
        probs = stage_probs(net, stage, feats, nmap, prev)
        p = probs.gather(1, gt.to(torch.int64)[:, None])[:, 0]
        bits = torch.clamp(-torch.log2(p + 1e-10), 0.0, 50.0)
        total = total + torch.where(mask, bits, 0.0).sum()
        if stage < 3:
            prev = gt if stage == 0 else prev * (2, 2, 4)[stage] + gt
    return total, mask.sum()
