"""Flat `.npz` checkpoints of the port's trees (counterpart of
gauspcc_tpu/utils/checkpoint.py:17-76, `save_pytree` / `load_pytree`).

A tree is nested dicts of tensors, numpy arrays and modules. It is saved
as one array per leaf under its "a/b/c" key path, the keys the JAX package
writes: a module's parameters go under their names with "." as "/", and
an `nn.Linear` keeps the JAX layout, "w" [in, out] (the transposed weight)
and "b". So a HAC state saved here loads in the JAX package's
`load_pytree`, and a JAX `model.npz` loads here (and through
`convert.state_from_numpy` into a state). The pickled mid-training
checkpoint (`save_training_checkpoint`) is not ported yet (ROADMAP.md
Queue 1 item 7).
"""

from __future__ import annotations

import copy
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def _module_leaves(module: nn.Module):
    """(relative key, parameter, transposed) of a module's parameters: an
    nn.Linear's weight is stored transposed as "w", its bias as "b"."""
    for name, p in module.named_parameters():
        key = name.replace(".", "/")
        linear = isinstance(module.get_submodule(name.rpartition(".")[0]),
                            nn.Linear)
        if linear:
            key = key[: key.rfind("/") + 1] + ("w" if name.endswith("weight") else "b")
        yield key, p, linear and name.endswith("weight")


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """{"a/b/c": numpy array} for every leaf of `tree`."""
    if isinstance(tree, Mapping):
        flat = {}
        for k, v in tree.items():
            flat.update(flatten(v, f"{prefix}{k}/"))
        return flat
    if isinstance(tree, nn.Module):
        return {prefix + k: (p.T if t else p).detach().cpu().numpy()
                for k, p, t in _module_leaves(tree)}
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.detach().cpu().numpy()}
    return {prefix[:-1]: np.asarray(tree)}


def save_pytree(path, tree) -> None:
    np.savez(path, **flatten(tree))


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _fill(template, flat: Mapping[str, np.ndarray], prefix: str = ""):
    def get(key, shape):
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{tuple(shape)}")
        return arr

    if isinstance(template, Mapping):
        return {k: _fill(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, nn.Module):
        module = copy.deepcopy(template)
        with torch.no_grad():
            for key, p, t in list(_module_leaves(module)):
                shape = p.shape[::-1] if t else p.shape
                arr = torch.from_numpy(np.array(get(prefix + key, shape)))
                p.copy_(arr.T if t else arr)
        return module
    if isinstance(template, torch.Tensor):
        arr = get(prefix[:-1], template.shape)
        return torch.from_numpy(np.array(arr)).to(template.device, template.dtype)
    return get(prefix[:-1], np.shape(template))


def load_pytree(path, template=None):
    """Load what save_pytree (of either package) wrote. With a `template`
    tree the result has its structure, devices and dtypes; without, it is
    nested dicts of numpy arrays, as `convert.state_from_numpy` takes."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if template is None:
        return _unflatten(flat)
    return _fill(template, flat)
