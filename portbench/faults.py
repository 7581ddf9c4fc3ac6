"""Faults planted in the program under test, each a way its timed path
could break: used by the tests (`correct` must come out false) and by
`calibrate.py --fault` (the readings a fault gives, which bound the
limits of the training cells). The benchmark's own runs plant none.

Each fault takes `setattr_(obj, name, value)`, pytest's
`monkeypatch.setattr` or the plain `setattr`.
"""

from __future__ import annotations


def unchanged_state(setattr_) -> None:
    """A step that returns its state unchanged: the optimizer moves no
    leaf and no moment, only its counter."""
    from gauspcc_tpu_torch.utils import optim

    def update(self, grads, state, leaves):
        return dict(state, count=state["count"] + 1)

    setattr_(optim.GroupAdam, "update", update)


def one_group_rate(setattr_) -> None:
    """One group of leaves takes twice its step, the rest as they should:
    HAC's mlp_color group; in the codec, whose optimizer has one group, the
    leaves of its target_resnet."""
    import torch

    from gauspcc_tpu_torch.utils import optim

    orig = optim.GroupAdam.update

    def update(self, grads, state, leaves):
        chosen = [k for k in leaves if self.group_of(k) == "mlp_color"
                  or k.startswith("target_resnet")]
        before = {k: leaves[k].detach().clone() for k in chosen}
        out = orig(self, grads, state, leaves)
        with torch.no_grad():
            for k in chosen:
                leaves[k].add_(leaves[k] - before[k])
        return out

    setattr_(optim.GroupAdam, "update", update)


def half_image(setattr_) -> None:
    """Half of a HAC step's batch (the image's pixels) left out, the mean
    taken over the rest: the L1 term over the top half of the rows."""
    from gauspcc_tpu_torch.utils import image

    setattr_(image, "l1_loss",
             lambda a, b: (a - b)[:, : a.shape[1] // 2].abs().mean())


def half_levels(setattr_) -> None:
    """Half of a codec step's batch (its pyramid levels) left out, the
    rest counted double."""
    from gauspcc_tpu_torch.codecs.gauspcgc import train

    orig = train._batch_bits
    calls = []

    def every_other(net, cfg, b):
        calls.append(1)
        bits, n = orig(net, cfg, b)
        return (bits * 2 if len(calls) % 2 else bits * 0), n

    setattr_(train, "_batch_bits", every_other)


def altered_frame(setattr_) -> None:
    """A view's frame altered where it is produced."""
    from gauspcc_tpu_torch.models.hac import render

    orig = render.render_image
    setattr_(render, "render_image", lambda *a, **k: orig(*a, **k) + 0.01)


def altered_cloud(setattr_) -> None:
    """A decoded point moved where the decoder produces it."""
    from gauspcc_tpu_torch.codecs.gauspcgc import codec

    orig = codec.decompress_point_cloud_batch

    def altered(*a, **k):
        out = orig(*a, **k)
        out["point_clouds"][0][0, 0] += 1.0
        return out

    setattr_(codec, "decompress_point_cloud_batch", altered)


def coarse_cdf(setattr_) -> None:
    """A stream inflated where it is produced: the coder's tables built
    from probabilities rounded to sixteenths (each at least one), as a
    coarser quantisation of the tables would; both sides use them, so the
    clouds still decode."""
    import torch

    from gauspcc_tpu_torch.core import cdf

    orig = cdf.probs_to_cdf_int16

    def coarse(probs, *a, **k):
        q = torch.clamp_min(torch.round(probs * 16), 1)
        return orig(q / q.sum(dim=-1, keepdim=True), *a, **k)

    setattr_(cdf, "probs_to_cdf_int16", coarse)


FAULTS = {f.__name__: f for f in (unchanged_state, one_group_rate, half_image,
                                  half_levels, altered_frame, altered_cloud,
                                  coarse_cdf)}
# the faults each cell can have (a step that keeps its state, a group
# updated at the wrong rate, half its batch, an answer altered or
# inflated); no cell exchanges anything between chips
CELL_FAULTS = {"hac.train_rd": ["unchanged_state", "one_group_rate",
                                "half_image"],
               "hac.view": ["altered_frame"],
               "gauspcgc.code_batch8": ["altered_cloud", "coarse_cdf"],
               "gauspcgc.train": ["unchanged_state", "one_group_rate",
                                  "half_levels"]}
