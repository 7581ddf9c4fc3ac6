"""Plain reference of the GausPcgc occupancy-context network: its dyadic
pyramid, the per-level stage probabilities of every child's occupancy
byte, the ideal bits they give, and (for training) the bits' gradient.

The network follows GausPcgc/network_ue_4stage_conv.py:11-181 as the port
describes it (gauspcc_tpu_torch/codecs/gauspcgc/model.py:1-40, `sib_context`
:180-214, `sib_stage_probs` :215-230): a prior embedding of each parent's
occupancy byte and a conv stack over the parents; each child gets its
parent's features plus an embedding of its octant, then a conv stack over
the children; stage s adds an embedding of the bits coded before it, runs
its own two convs and a float32 head. Each conv is written here as the
plain submanifold sparse convolution it is: for each of the k^3 taps, the
neighbour at that offset (if it is in the voxel set) times that tap's
weight, summed; not the port's sibling packing. The conv stacks keep
their activations in the configuration's dtype (bf16): a conv's products
are summed in float32 and rounded once to bf16, then its bias is added in
bf16, as the port's conv does (ops/sibconv.py:1-30).

Frozen copies: `build_pyramid` is gauspcc_tpu_torch/ops/sparse.py:48-114
(`lex_key`, `dedupe_lex`, `build_occupancy_pyramid`); `merge_clouds` is
codecs/gauspcgc/codec.py:785-804 (`_merge_clouds`) without the posQ
division (the cells' posQ is 1).

The weights are read from the .npz the JAX package saved (its keys, dense
weights [in, out]), or given as a dict of tensors by those keys. `operand`
is the dtype the convs' operands are rounded to before their products:
bf16, the configuration's, or float8_e4m3fn for the control.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

STAGE_SIZES = (2, 2, 4, 16)
MIN_BASE_POINTS = 64


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def lex_key(coords: np.ndarray, dims) -> np.ndarray:
    c = coords.astype(np.int64)
    return (c[:, 2] * int(dims[1]) + c[:, 1]) * int(dims[0]) + c[:, 0]


def dedupe_lex(coords: np.ndarray) -> np.ndarray:
    cur = np.asarray(coords).astype(np.int64)
    if cur.shape[0] <= 1:
        return cur
    key = lex_key(cur, cur.max(axis=0) + 1)
    order = np.argsort(key)
    cur, key = cur[order], key[order]
    keep = np.empty(cur.shape[0], bool)
    keep[0] = True
    np.not_equal(key[1:], key[:-1], out=keep[1:])
    return cur[keep]


def build_pyramid(coords: np.ndarray, min_points: int = MIN_BASE_POINTS):
    """Levels coarse to fine: (parent coords int32 [Ni, 3], occupancy
    uint8 [Ni]), lex-sorted; the finest level's children are the input."""
    cur = dedupe_lex(coords)
    levels = []
    while True:
        parent = cur >> 1
        octant = (cur[:, 0] & 1) + 2 * (cur[:, 1] & 1) + 4 * (cur[:, 2] & 1)
        dims = parent.max(axis=0) + 1
        pkey = lex_key(parent, (dims[0], dims[1]))
        order = np.argsort(pkey, kind="stable")
        pkey = pkey[order]
        flags = np.empty(pkey.shape[0], bool)
        flags[0] = True
        np.not_equal(pkey[1:], pkey[:-1], out=flags[1:])
        starts = np.flatnonzero(flags)
        bits = (1 << octant).astype(np.uint8)[order]
        occ = np.bitwise_or.reduceat(bits, starts)
        pcoords = parent[order[starts]].astype(np.int32)
        levels.append((pcoords, occ))
        cur = pcoords.astype(np.int64)
        if cur.shape[0] < min_points or cur.shape[0] <= 1:
            break
    return levels[::-1]


def merge_clouds(clouds):
    """-> (merged int64 [N, 3], shifts [M, 3], unique counts [M], L): cloud
    i shifted to its minimum, then by i << L along z."""
    shifted, shifts, counts = [], [], []
    for xyz in clouds:
        xyz = np.asarray(xyz).astype(np.int64)
        s = xyz.min(axis=0)
        shifts.append(s)
        uniq = dedupe_lex(xyz - s)
        counts.append(uniq.shape[0])
        shifted.append(uniq)
    span = max(int(c.max()) + 1 for c in shifted)
    lbits = max(1, int(np.ceil(np.log2(span))))
    merged = np.concatenate([c + np.array([0, 0, i << lbits], np.int64)
                             for i, c in enumerate(shifted)])
    return merged, np.stack(shifts), np.asarray(counts, np.int64), lbits


def _keys(c: torch.Tensor) -> torch.Tensor:
    c = c.to(torch.int64) + 4
    return (c[:, 2] << 42) | (c[:, 1] << 21) | c[:, 0]


def neighbours(coords: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """[N, k^3] row of each voxel's neighbour at tap t (N where absent);
    tap t = ((dz + r) k + (dy + r)) k + (dx + r)."""
    k, r = kernel_size, kernel_size // 2
    dev = coords.device
    keys = _keys(coords)
    order = torch.argsort(keys)
    skeys = keys[order]
    t = torch.arange(k**3, device=dev)
    d = torch.stack([t % k - r, (t // k) % k - r, t // (k * k) - r], 1)
    out = torch.empty((coords.shape[0], k**3), dtype=torch.int64, device=dev)
    n = coords.shape[0]
    for j in range(k**3):
        q = _keys(coords.to(torch.int64) + d[j])
        pos = torch.searchsorted(skeys, q).clamp_max(n - 1)
        hit = skeys[pos] == q
        out[:, j] = torch.where(hit, order[pos], n)
    return out


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

def load_weights(path, device) -> dict:
    with np.load(path) as z:
        return {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device)
                for k in z.files}


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x with a zero row appended (the row an absent neighbour reads)."""
    return torch.cat([x, torch.zeros((1, x.shape[1]), dtype=x.dtype,
                                     device=x.device)])


class _PlainConv(torch.autograd.Function):
    """sum_t x[nbr[:, t]] @ w[t], operands rounded to `operand`, summed in
    float32 and rounded to x's dtype. Its gradient is the same sum over the
    mirrored taps (the neighbour relation is symmetric: j is i's neighbour
    at tap t exactly when i is j's at the mirrored tap), in float32, dx
    rounded to x's dtype, dw kept in float32."""

    @staticmethod
    def forward(ctx, x, nbr, w, operand):
        xo = _rows(x.to(operand).to(torch.float32))
        wo = w.to(operand).to(torch.float32)
        acc = torch.zeros((x.shape[0], w.shape[2]), device=x.device)
        for t in range(w.shape[0]):
            acc += xo[nbr[:, t]] @ wo[t]
        ctx.save_for_backward(x, nbr, w)
        ctx.operand = operand
        return acc.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, nbr, w = ctx.saved_tensors
        xo = _rows(x.to(ctx.operand).to(torch.float32))
        wo = w.to(ctx.operand).to(torch.float32)
        dyz = _rows(dy.to(torch.float32))
        k3 = w.shape[0]
        dx = torch.zeros((x.shape[0], w.shape[1]), device=x.device)
        dw = torch.zeros_like(w, dtype=torch.float32)
        for t in range(k3):
            dx += dyz[nbr[:, k3 - 1 - t]] @ wo[t].T
            dw[t] = xo[nbr[:, t]].T @ dyz[:-1]
        return dx.to(x.dtype), None, dw.to(w.dtype), None


def conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
         mask=None, operand=torch.bfloat16) -> torch.Tensor:
    """Submanifold conv of x [N, Cin] (bf16) over the neighbour rows nbr
    [N, k^3] with w [k^3, Cin, Cout]: products of `operand`-rounded values
    summed in float32, rounded to x's dtype, plus the bias in that dtype."""
    y = _PlainConv.apply(x, nbr, w, operand) + b.to(x.dtype)
    return y if mask is None else torch.where(mask[:, None], y, 0)


def conv_stack(W, prefix, x, nbr, operand):
    def c(name, v):
        return conv(v, nbr, W[f"{prefix}/{name}/w"], W[f"{prefix}/{name}/b"],
                    operand=operand)

    h = torch.relu(c("conv", x))
    for r in ("res0", "res1"):
        h = torch.relu(h + c(f"{r}/conv1", torch.relu(c(f"{r}/conv0", h))))
    return h


def head(W, stage, x):
    h = torch.relu(x.to(torch.float32) @ W[f"head_s{stage}/fc0/w"]
                   + W[f"head_s{stage}/fc0/b"])
    return torch.softmax(h @ W[f"head_s{stage}/fc1/w"] + W[f"head_s{stage}/fc1/b"],
                         dim=-1)


def split_occupancy(occ: torch.Tensor):
    occ = occ.to(torch.int64)
    return (occ // 128) % 2, (occ // 64) % 2, (occ // 16) % 4, occ % 16


def level_probs(W: dict, p_coords, p_occ, c_coords, c_occ, *, kernel_size: int,
                dtype=torch.bfloat16, operand=torch.bfloat16):
    """The four stages' probabilities [n_child, S] of the children's
    occupancy bytes c_occ, teacher-forced, and the symbols they code.
    p_* are the parents (lex-sorted), c_* the children (lex-sorted)."""
    dev = p_coords.device
    p_nbr = neighbours(p_coords, kernel_size)
    c_nbr = neighbours(c_coords, kernel_size)
    pf = W["prior_embedding"][p_occ.to(torch.int64)].to(dtype)
    pf = conv_stack(W, "prior_resnet", pf, p_nbr, operand)
    pkeys = _keys(p_coords)
    porder = torch.argsort(pkeys)
    ckey_parent = _keys(c_coords.to(torch.int64) >> 1)
    parent = porder[torch.searchsorted(pkeys[porder], ckey_parent)]
    cc = c_coords.to(torch.int64)
    octant = (cc[:, 0] & 1) + 2 * (cc[:, 1] & 1) + 4 * (cc[:, 2] & 1)
    cf = pf[parent] + W["target_embedding"].to(dtype)[octant]
    cf = conv_stack(W, "target_resnet", cf, c_nbr, operand)
    s = split_occupancy(c_occ)
    prevs = [None, s[0], s[0] * 2 + s[1], (s[0] * 2 + s[1]) * 4 + s[2]]
    probs = []
    for stage in range(4):
        f = cf
        if stage > 0:
            f = f + W[f"cond_emb_s{stage}"][prevs[stage]].to(dtype)
        h = conv(f, c_nbr, W[f"spatial_s{stage}/conv0/w"],
                 W[f"spatial_s{stage}/conv0/b"], operand=operand)
        h = conv(torch.relu(h), c_nbr, W[f"spatial_s{stage}/conv1/w"],
                 W[f"spatial_s{stage}/conv1/b"], operand=operand)
        probs.append(head(W, stage, h))
    del dev
    return probs, list(s)


def level_bits(probs, syms) -> torch.Tensor:
    """Ideal bits of the symbols under their stage probabilities."""
    total = torch.zeros((), dtype=torch.float64, device=probs[0].device)
    for p, s in zip(probs, syms):
        pk = p.gather(1, s[:, None])[:, 0].to(torch.float64)
        total = total + (-torch.log2(pk.clamp_min(1e-30))).sum()
    return total


def train_bits(probs, syms) -> torch.Tensor:
    """The training objective's bits of one level: clamp(-log2(p + 1e-10),
    0, 50) of each coded symbol, summed (model.py level_bits_sib)."""
    total = torch.zeros((), device=probs[0].device)
    for p, s in zip(probs, syms):
        pk = p.gather(1, s[:, None])[:, 0]
        total = total + torch.clamp(-torch.log2(pk + 1e-10), 0.0, 50.0).sum()
    return total


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def lr_at(count_before: int, lr: float, decay: float, steps) -> float:
    """optax's piecewise-constant schedule in float32 at the count before
    the update (train.py:63-77)."""
    f32 = np.float32
    v = f32(lr)
    for b in sorted(int(s) for s in steps):
        if count_before >= b:
            v = f32(f32(decay) * v)
    return float(v)


def train_steps(W0: dict, patches, *, kernel_size: int, lr: float,
                decay: float, decay_steps, dtype=torch.bfloat16,
                operand=torch.bfloat16, jitter: float = 0.0, jitter_seed: int = 0):
    """Adam steps from the weights W0 (copied), one patch a step: per level
    the bits' gradient, all levels summed, times float32(1 / n_points),
    then one update (optax's adam, eps 1e-8, from zero moments). `patches`:
    (levels, n_points) each. `jitter` adds jitter * N(0, 1) times the
    leaf's root mean square to every gradient component before its update:
    noise the size of round-off in sums that cancel, a witness of how far
    Adam carries it. Returns (bits per point of each
    step, the first step's gradients, the weights after the first step,
    the weights after the last step)."""
    W = {k: v.detach().clone().requires_grad_(True) for k, v in W0.items()}
    mu = {k: torch.zeros_like(v) for k, v in W.items()}
    nu = {k: torch.zeros_like(v) for k, v in W.items()}
    dev0 = W0["prior_embedding"].device
    gen = torch.Generator(device=dev0).manual_seed(int(jitter_seed))
    losses, first, after1 = [], None, None
    for i, (levels, n_points) in enumerate(patches):
        total = 0.0
        for d in range(len(levels) - 1):
            pc, po = levels[d]
            cc, co = levels[d + 1]
            dev = W0["prior_embedding"].device
            with torch.enable_grad():
                probs, syms = level_probs(
                    W, torch.as_tensor(pc, device=dev),
                    torch.as_tensor(po.astype(np.int64), device=dev),
                    torch.as_tensor(cc, device=dev),
                    torch.as_tensor(co.astype(np.int64), device=dev),
                    kernel_size=kernel_size, dtype=dtype, operand=operand)
                bits = train_bits(probs, syms)
                bits.backward()
            total += float(bits.detach())
        inv_n = float(np.float32(1.0 / n_points))
        grads = {k: v.grad * inv_n for k, v in W.items()}
        for v in W.values():
            v.grad = None
        if jitter:
            grads = {k: g + jitter * torch.sqrt((g * g).mean()) * torch.randn(
                g.shape, generator=gen, device=dev0) for k, g in grads.items()}
        if i == 0:
            first = {k: g.clone() for k, g in grads.items()}
        count = i + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(ADAM_B1) ** f32(count))
        bc2 = float(f32(1) - f32(ADAM_B2) ** f32(count))
        step = lr_at(count - 1, lr, decay, decay_steps)
        with torch.no_grad():
            for k, p in W.items():
                g = grads[k]
                mu[k].mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
                nu[k].mul_(ADAM_B2).add_((1 - ADAM_B2) * (g * g))
                p.add_(-step * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)))
        if i == 0:
            after1 = {k: v.detach().clone() for k, v in W.items()}
        losses.append(total / n_points)
    return losses, first, after1, {k: v.detach() for k, v in W.items()}


def pyramid_probs(W, levels, device, *, kernel_size: int, dtype=torch.bfloat16,
                  operand=torch.bfloat16):
    """Per coded level (coarse to fine): (probs, syms) of level d's
    children's bytes given level d's parents."""
    out = []
    for d in range(len(levels) - 1):
        pc, po = levels[d]
        cc, co = levels[d + 1]
        out.append(level_probs(
            W, torch.as_tensor(pc, device=device),
            torch.as_tensor(po.astype(np.int64), device=device),
            torch.as_tensor(cc, device=device),
            torch.as_tensor(co.astype(np.int64), device=device),
            kernel_size=kernel_size, dtype=dtype, operand=operand))
    return out
