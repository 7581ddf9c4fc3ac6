"""The model families behind one switch (counterpart of
gauspcc_tpu/models/registry.py).

A family is a small descriptor: its config type, state init, training
objective, phase schedule and scene codec, and optional hooks for phase 2
(`extra_init`) and per-phase parameter freezes (`grad_mask`): HAC, HAC++,
TC-GS and CAT-3DGS, whose hooks fit its PCA frame on entering phase 2 and
freeze its phases' groups.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class Family:
    """`init_state(cfg, points, rng, device)`; `training_loss` with HAC's
    signature and aux; `conduct_encoding(state, cfg, out_dir, pcc_params,
    pcc_cfg, ...)` / `conduct_decoding(...)` as HAC's codec;
    `extra_init(state, cfg)` on entering phase 2; `grad_mask(grads,
    phase)` on the gradients by leaf name."""

    name: str
    make_config: Callable[..., Any]
    init_state: Callable
    training_loss: Callable
    phase_of_step: Callable[[int], int]
    conduct_encoding: Callable
    conduct_decoding: Callable
    extra_init: Callable | None = None
    grad_mask: Callable | None = None


def get_family(name: str) -> Family:
    if name == "hac":
        from gauspcc_tpu_torch.models.hac import codec, model, render
        from gauspcc_tpu_torch.models.hac import train as t

        return Family("hac", model.HACConfig, model.init_state,
                      render.training_loss, t.phase_of_step,
                      codec.conduct_encoding, codec.conduct_decoding)
    if name == "hac_plus":
        from gauspcc_tpu_torch.models.hac import train as t
        from gauspcc_tpu_torch.models.hac_plus import codec, model, render

        return Family("hac_plus", model.HACPlusConfig, model.init_state,
                      render.training_loss, t.phase_of_step,
                      codec.conduct_encoding, codec.conduct_decoding)
    if name == "tcgs":
        from gauspcc_tpu_torch.models.tcgs import codec, model, render

        return Family("tcgs", model.TCGSConfig, model.init_state,
                      render.training_loss, render.phase_of_step,
                      codec.conduct_encoding, codec.conduct_decoding)
    if name == "cat3dgs":
        from gauspcc_tpu_torch.models.cat3dgs import codec, model, render

        return Family("cat3dgs", model.CATConfig, model.init_state,
                      render.training_loss, render.phase_of_step,
                      codec.conduct_encoding, codec.conduct_decoding,
                      extra_init=model.set_pca_frame,
                      grad_mask=render.grad_mask)
    raise ValueError(f"unknown model family: {name!r} "
                     f"(choose {', '.join(FAMILIES)})")


FAMILIES = ("hac", "hac_plus", "tcgs", "cat3dgs")
