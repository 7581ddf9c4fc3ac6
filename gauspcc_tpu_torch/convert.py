"""Carry a HAC, HAC++, TC-GS or CAT-3DGS state and GausPcgc codec weights
from the JAX package into the port.

The JAX package saves a pytree as flat "a/b/c" keys
(gauspcc_tpu/utils/checkpoint.py:17-33, `save_pytree`), e.g.
"nets/mlp_color/fc0/w". `state_from_numpy` takes those keys, or the same
tree as nested dicts of numpy arrays, and returns the port's state. Dense
weights are stored [in, out] there and [out, in] in `nn.Linear`, so they
are transposed; the tables keep their (xyz, xy, xz, yz) layout, TC-GS's
planes their [3, C, R, R] and its autoencoder's convs their HWIO `w`;
CAT-3DGS's field keeps JAX's keys (field/scales/<i>, field/arms/<group>/
layers/<i>/<lin|res_lin>, field/gains, the PCA frame) and its mlp_chcm
list its indices.
`codec_params_from_numpy` and `load_codec_npz` do the same for the codec's
network (`codecs/gauspcgc/model.GausPcgcNet`), whose conv weights keep
their [k^3, Cin, Cout] layout. `factorized_params_from_numpy` carries the
fully factorized entropy model's parameters (`core/entropy.py`), which
keep their layout.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from gauspcc_tpu_torch.device import resolve
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.utils.checkpoint import flatten

ANCHOR_FIELDS = ("anchor", "offset", "mask", "anchor_feat", "scaling",
                 "rotation", "opacity")
# HAC's networks besides its tables
MLP_NAMES = ("mlp_opacity", "mlp_cov", "mlp_color", "mlp_grid", "mlp_deform")


def state_from_numpy(tree: Mapping, cfg, device="cuda") -> hac.State:
    """The port's state from a JAX state given as numpy arrays: HAC's for a
    HACConfig, HAC++'s for a HACPlusConfig (its nets have channel_ctx in
    place of mlp_deform, and a wider mlp_grid), TC-GS's for a TCGSConfig
    (planes, autoencoder and mlp_triplane in place of the tables, mlp_grid
    and mlp_deform), CAT-3DGS's for a CATConfig (field, mlp_attr, mlp_chcm
    and the optional chcm heads in their place). The networks take every
    "nets/" key and no other, or it raises."""
    from gauspcc_tpu_torch.models.cat3dgs import model as cat
    from gauspcc_tpu_torch.models.hac_plus import model as hacp
    from gauspcc_tpu_torch.models.tcgs import model as tcgs

    dev = resolve(device)
    nets_of = {hacp.HACPlusConfig: hacp.HACPlusNets,
               tcgs.TCGSConfig: tcgs.TCGSNets, cat.CATConfig: cat.CATNets}
    flat = flatten(tree)

    def get(key: str, shape=None) -> torch.Tensor:
        if key not in flat:
            raise KeyError(f"state is missing {key}")
        arr = flat[key]
        if shape is not None and tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(shape)}")
        return torch.tensor(arr, device=dev)

    nets = _fill(nets_of.get(type(cfg), hac.HACNets)(cfg), flat, "nets/")
    return {
        "anchors": {f: get(f"anchors/{f}").to(torch.float32)
                    for f in ANCHOR_FIELDS},
        "valid": get("valid").to(torch.bool),
        "nets": nets.to(dev),
        "x_bound_min": get("x_bound_min", (1, 3)).to(torch.float32),
        "x_bound_max": get("x_bound_max", (1, 3)).to(torch.float32),
    }


def codec_params_from_numpy(tree: Mapping, cfg=None, device="cuda"):
    """The port's GausPcgc network from the JAX package's weights.

    `tree`: the flat "a/b/c" keys `save_pytree` writes (57 keys for the
    default NetConfig, e.g. "head_s0/fc0/w"), or the same tree as nested
    dicts of numpy arrays. Dense weights [in, out] are transposed into
    `nn.Linear`; conv weights keep their [k^3, Cin, Cout] layout."""
    from gauspcc_tpu_torch.codecs.gauspcgc import model as pcgc

    cfg = cfg if cfg is not None else pcgc.NetConfig()
    dev = resolve(device)
    flat = flatten(tree)
    return _fill(pcgc.GausPcgcNet(cfg), flat).to(dev)


def _fill(module: torch.nn.Module, flat: Mapping, prefix: str = ""):
    """`module` with every parameter copied from flat[prefix + its key];
    a key under `prefix` that the module lacks, or a missing key, raises."""
    names = dict(module.named_parameters())
    unused = ({k for k in flat if k.startswith(prefix)}
              - {prefix + _codec_key(n) for n in names})
    if unused:
        raise KeyError(f"weights the network does not have: {sorted(unused)}")
    with torch.no_grad():
        for name, p in names.items():
            key = prefix + _codec_key(name)
            if key not in flat:
                raise KeyError(f"weights are missing {key}")
            arr = torch.tensor(np.asarray(flat[key], np.float32))
            if name.endswith(".weight"):  # nn.Linear: [out, in]
                arr = arr.T
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(arr.shape)} vs {tuple(p.shape)}")
            p.copy_(arr)
    return module


def _codec_key(param_name: str) -> str:
    """nn parameter name -> the JAX tree's flat key."""
    key = param_name.replace(".", "/")
    if key.endswith("/weight"):
        key = key[: -len("weight")] + "w"
    elif key.endswith("/bias"):
        key = key[: -len("bias")] + "b"
    return key


def load_codec_npz(path, cfg=None, device="cuda"):
    """The port's GausPcgc network from a `.npz` the JAX package saved
    (e.g. model/gauspcgc_r5/best_model.npz)."""
    with np.load(path) as data:
        return codec_params_from_numpy({k: data[k] for k in data.files}, cfg,
                                       device)


def factorized_params_from_numpy(tree: Mapping, device="cuda") -> dict:
    """The factorized model's {"matrices", "biases", "factors"} lists from
    JAX's (`gauspcc_tpu/core/entropy.py` `init_factorized_params`: lists of
    arrays, or the flat "matrices/0" keys `save_pytree` writes) as float32
    tensors on `device`."""
    dev = resolve(device)
    out = {}
    for name in ("matrices", "biases", "factors"):
        if name in tree:
            leaves = list(tree[name])
        else:
            n = sum(1 for k in tree if k.startswith(name + "/"))
            leaves = [tree[f"{name}/{i}"] for i in range(n)]
        out[name] = [torch.from_numpy(np.array(v, np.float32)).to(dev)
                     for v in leaves]
    return out
