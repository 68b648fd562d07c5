"""Carry flax variables of ``edrl_tpu`` into the port's modules.

The port names its modules and parameters as flax does, so a flax leaf
``params/a/b/kernel`` lands on the torch tensor ``a.b.weight``:

- Dense ``kernel [in, out]`` -> ``weight [out, in]`` (transposed);
- Conv ``kernel [kh, kw, in, out]`` -> ``weight [out, in, kh, kw]``, and
  ``[kd, kh, kw, in, out]`` -> ``[out, in, kd, kh, kw]``;
- LayerNorm and BatchNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
- BatchNorm ``mean`` / ``var`` (``batch_stats``) -> ``running_mean`` /
  ``running_var``;
- every other leaf (``rel_bias_table``, ``pos_embed``, ``proxies``,
  ``alpha``, ``phi``, Dense and Conv ``bias``) keeps its name and layout;
- flax's automatic module names (``Conv_0``, ``Dropout_0``, ``BatchNorm_1``)
  are the port's attribute names too;
- a block that flax wraps in ``nn.remat`` is named ``Checkpoint<Class>_<i>``
  (a model built with ``remat``); it lands on the port's ``<Class>_<i>``.

The mapping is strict: every flax leaf is used once, every parameter and
persistent buffer of the module is filled, and shapes must agree.  Anything
else raises with the path.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_PARAM_RENAMES = {"kernel": "weight", "scale": "weight"}
_STAT_RENAMES = {"mean": "running_mean", "var": "running_var"}
_REMAT_PREFIX = "Checkpoint"
# A flax kernel's axes in the torch weight's order, by rank: Dense, 2-D and 3-D Conv.
_KERNEL_AXES = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _module_name(part: str) -> str:
    """The port's name of a flax module: ``nn.remat``'s prefix dropped."""
    rest = part[len(_REMAT_PREFIX):]
    return rest if part.startswith(_REMAT_PREFIX) and rest[:1].isupper() else part


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def _mapped(model: nn.Module, params: Mapping, batch_stats: Optional[Mapping]):
    """``(torch_name, flax_name, leaf, axes)`` for every flax leaf, strictly;
    ``axes`` permutes a kernel into the torch layout (``None``: as it is)."""
    targets = model.state_dict(keep_vars=True)
    filled: Dict[str, str] = {}
    out = []
    for collection, tree, renames in (
        ("params", params, _PARAM_RENAMES),
        ("batch_stats", batch_stats or {}, _STAT_RENAMES),
    ):
        for path, leaf in _leaves(tree):
            flax_name = "/".join((collection,) + path)
            is_kernel = collection == "params" and path[-1] == "kernel"
            name = ".".join(tuple(map(_module_name, path[:-1])) + (renames.get(path[-1], path[-1]),))
            if name not in targets:
                raise KeyError(f"{flax_name}: no torch tensor {name!r} in {type(model).__name__}")
            if name in filled:
                raise KeyError(f"{flax_name}: torch tensor {name!r} already filled by {filled[name]}")
            shape = tuple(np.shape(leaf))
            axes = None
            if is_kernel:
                if len(shape) not in _KERNEL_AXES:
                    raise ValueError(f"{flax_name}: a kernel must be 2-D (Dense), 4-D or 5-D (Conv), got {shape}")
                axes = _KERNEL_AXES[len(shape)]
                shape = tuple(shape[a] for a in axes)
            if shape != tuple(targets[name].shape):
                raise ValueError(
                    f"{flax_name}: shape {shape} (after layout change) != torch "
                    f"{name} {tuple(targets[name].shape)}"
                )
            filled[name] = flax_name
            out.append((name, flax_name, leaf, axes))
    missing = sorted(set(targets) - set(filled))
    if missing:
        raise KeyError(f"torch tensors with no flax leaf: {missing}")
    return out


def flax_key_map(model: nn.Module, params: Mapping, batch_stats: Optional[Mapping] = None) -> Dict[str, str]:
    """Torch tensor name -> flax leaf path, checked as strictly as a load.

    Works on trees of shapes (``jax.eval_shape`` output) as well as arrays.
    """
    return {name: flax_name for name, flax_name, _, _ in _mapped(model, params, batch_stats)}


@torch.no_grad()
def load_flax_variables(model: nn.Module, params: Mapping,
                        batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Fill ``model`` from flax trees of numpy arrays (``params``, ``batch_stats``)."""
    targets = model.state_dict(keep_vars=True)
    for name, _, leaf, axes in _mapped(model, params, batch_stats):
        value = torch.from_numpy(np.array(leaf, dtype=np.float32))
        targets[name].copy_(value if axes is None else value.permute(axes))
    return model
