"""The numbers that decide `correct`: each the widest gap, over one kind of
leaf, between what the timed path produced and what the reference makes of
the same inputs.

- `worst_token`: tokens (..., C, S) compared token by token: the norm of a
  token's difference over the larger of its reference norm and the median
  reference token's norm (some tokens are all but zero);
- `worst_leaf`: a dict of tensors (or of floats), leaf by leaf, the same
  way against the larger of the leaf's norm and the median leaf's;
- `worst_signal`: a dict of tensors, leaf by leaf, against the norm of
  the leaf's deviation from its mean (or the median leaf's, where that is
  larger): what the network computes on top of a head's constant bias,
  which would otherwise hide the error in the leaf's norm;
- `worst_frame`: frames (..., H, W, 3) in [0, 1], the RMS difference of
  the worst frame.
"""

from __future__ import annotations

import torch

WRONG_SHAPE = 1e30   # the gap of an answer whose keys or shapes are not the reference's


def _gap(diff: torch.Tensor, ref: torch.Tensor) -> float:
    return float((diff / torch.maximum(ref, ref.median())).max())


def worst_token(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return _gap((got - want).norm(dim=-2).flatten(), want.norm(dim=-2).flatten())


def worst_leaf(got: dict, want: dict) -> float:
    keys = sorted(want)
    diff = torch.tensor([float((torch.as_tensor(got[k]).double() - torch.as_tensor(want[k]).double()).norm())
                         for k in keys])
    ref = torch.tensor([float(torch.as_tensor(want[k]).double().norm()) for k in keys])
    return _gap(diff, ref)


def worst_signal(got: dict, want: dict) -> float:
    keys = sorted(want)
    diff = torch.tensor([float((got[k].double() - want[k].double()).norm()) for k in keys])
    dev = torch.tensor([float((want[k].double() - want[k].double().mean(dim=(0, 1), keepdim=True)).norm())
                        for k in keys])
    return _gap(diff, dev)


def worst_frame(got: torch.Tensor, want: torch.Tensor) -> float:
    d = (got.double() - want.double()).flatten(0, -4)
    return float(d.pow(2).mean(dim=(1, 2, 3)).sqrt().max())


def same_shape(got, want) -> bool:
    """Whether an answer has the reference's keys and shapes."""
    if isinstance(want, dict):
        return isinstance(got, dict) and set(got) == set(want) and \
            all(same_shape(got[k], want[k]) for k in want)
    return torch.as_tensor(got).shape == torch.as_tensor(want).shape


def gaps(kinds: dict, got: dict, want: dict) -> dict:
    """{name: gap} of each output named in `kinds` ({name: 'token' |
    'leaf' | 'signal' | 'frame'}); an answer of another shape reads WRONG_SHAPE."""
    fn = {"token": worst_token, "leaf": worst_leaf, "signal": worst_signal,
          "frame": worst_frame}
    return {name: fn[kind](got[name], want[name]) if same_shape(got[name], want[name])
            else WRONG_SHAPE for name, kind in kinds.items()}


def worst(kinds: dict, got: list, want: list) -> dict:
    """The largest gap of each output over the sampled requests (a request
    the reference could not follow, want None, reads WRONG_SHAPE)."""
    per = [gaps(kinds, g, w) if w is not None else dict.fromkeys(kinds, WRONG_SHAPE)
           for g, w in zip(got, want)]
    return {k: max(p[k] for p in per) for k in kinds}
