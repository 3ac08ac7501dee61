"""Map the reference's parameters onto the port's.

``params_from_jax`` takes the JAX package's ``Model.init`` pytree (nested
dicts) with its leaves already converted to numpy arrays — so this module
needs no JAX — and returns the port's parameter tree.  The two layouts
are the same leaf for leaf; bf16 leaves become ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.stacked import tree_map


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own (ml_dtypes adds it): the bit
        # pattern is reinterpreted, no rounding happens
        t = torch.tensor(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def params_from_jax(np_tree, device=None):
    """The reference's parameter pytree (numpy leaves) -> port params on
    ``device`` (``cuda`` unless given)."""
    device = resolve_device(device)
    return tree_map(lambda a: _leaf(a, device), np_tree)
