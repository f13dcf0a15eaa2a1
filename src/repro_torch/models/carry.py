"""Carry LM parameters and caches between the JAX package and the port.

The JAX package's parameters and caches are trees of dicts and lists
(``lm.init``'s params, the MoE and mamba params as ``_asdict()`` dicts, a
cache as ``{"slots": [...]}``); ``jax.tree.map(np.asarray, tree)`` turns one
into numpy arrays.  ``from_numpy`` takes such a tree and returns the same
tree of tensors on a device, so both packages compute on the same weights;
``to_numpy`` gives a port tree back as numpy, bf16 as f32 (exact).  A
train state carries the same way, both ways: ``params``, ``opt`` (the int32
``step`` scalar and ``m``/``v`` or ``vr``/``vc``) and ``err``; the JAX side
casts each numpy leaf back to its own leaf's dtype.

A bf16 numpy array (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses) is read through its bits: ``uint16`` -> ``int16`` ->
``torch.bfloat16``, without importing ``ml_dtypes``.  Store state is carried
by ``core/carry.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a C-contiguous copy; a 0-d array stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_numpy(tree, device):
    """A dict / list / tuple tree of numpy arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device) for v in tree)
    return _tensor(tree, device)


def to_numpy(tree):
    """A tree of tensors -> numpy arrays on the host (bf16 as f32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_device(tree, device):
    """A tree of tensors moved to ``device`` (weights built on the CPU and
    copied to the card)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)
