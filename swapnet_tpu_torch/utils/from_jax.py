"""Weight bridge between the JAX package's variables and the port's modules.

The JAX variables are nested dicts of arrays, ``params`` and, for batch
norm, ``batch_stats``.  The port's submodules carry the Flax names, so a
Flax path ``A/B/kernel`` is the port's submodule ``A.B``; what a leaf
becomes depends on that submodule's type:

* ``Conv``: kernel HWIO -> weight OIHW; bias as is.
* ``ConvTranspose``: the JAX kernel is stored spatially pre-flipped as HWOI
  (4, 4, O, I); flip it back and lay it out as torch's (I, O, kh, kw).
  This inverts ``swapnet_tpu/utils/porter.py::convT_kernel``.  A wrong
  mapping here still fits every shape, so the tests hold each ConvTranspose
  alone against JAX.
* ``BatchNorm2d``: scale/bias -> weight/bias, batch_stats mean/var ->
  running_mean/running_var.  torch's ``num_batches_tracked`` has no JAX
  counterpart and is set to 0.

``state_dict_from_jax`` checks that every JAX leaf is consumed, that every
entry of the module's state_dict is produced, with equal shapes, and that
the element counts match exactly.  ``jax_variables_from_module`` is the
inverse, used to write checkpoints in the JAX package's layout.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from swapnet_tpu_torch.models.layers import Conv, ConvTranspose

_NOT_IN_JAX = "num_batches_tracked"


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.array(x, copy=True))


def _to_torch(sub: nn.Module, leaf: str, kind: str) -> str:
    """The state_dict suffix of a JAX leaf, for a submodule of ``sub``'s type."""
    if kind == "params" and isinstance(sub, (Conv, ConvTranspose)) and leaf in ("kernel", "bias"):
        return "weight" if leaf == "kernel" else "bias"
    if isinstance(sub, nn.BatchNorm2d):
        names = ({"scale": "weight", "bias": "bias"} if kind == "params"
                 else {"mean": "running_mean", "var": "running_var"})
        if leaf in names:
            return names[leaf]
    raise KeyError(f"no port counterpart for {kind} leaf '{leaf}' of {type(sub).__name__}")


def _convert(sub: nn.Module, suffix: str, value: torch.Tensor) -> torch.Tensor:
    if suffix == "weight" and isinstance(sub, Conv):
        return value.permute(3, 2, 0, 1).contiguous()
    if suffix == "weight" and isinstance(sub, ConvTranspose):
        return value.permute(3, 2, 0, 1).flip(2, 3).contiguous()
    return value.contiguous()


def state_dict_from_jax(module: nn.Module, variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for ``module`` from JAX ``variables``."""
    expected = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    n_jax = 0
    for kind in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(kind, {})):
            mod_path = ".".join(path[:-1])
            try:
                sub = module.get_submodule(mod_path)
            except AttributeError as e:
                raise KeyError(f"JAX {kind} path {'/'.join(path)} has no port submodule") from e
            suffix = _to_torch(sub, path[-1], kind)
            key = f"{mod_path}.{suffix}" if mod_path else suffix
            if key in out:
                raise KeyError(f"two JAX leaves map onto {key}")
            out[key] = _convert(sub, suffix, _tensor(value))
            n_jax += out[key].numel()
            if isinstance(sub, nn.BatchNorm2d):
                out[key[:-len(suffix)] + _NOT_IN_JAX] = torch.zeros((), dtype=torch.long)
    missing = sorted(set(expected) - set(out))
    extra = sorted(set(out) - set(expected))
    if missing or extra:
        raise KeyError(f"JAX variables do not match the module: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    for key, value in out.items():
        if value.shape != expected[key].shape:
            raise ValueError(f"{key}: JAX gives {tuple(value.shape)}, "
                             f"module has {tuple(expected[key].shape)}")
    n_port = sum(v.numel() for k, v in expected.items() if not k.endswith(_NOT_IN_JAX))
    if n_jax != n_port:
        raise ValueError(f"element counts differ: JAX {n_jax}, port {n_port}")
    return out


def load_from_jax(module: nn.Module, variables: Mapping) -> nn.Module:
    """Load JAX ``variables`` into ``module`` (strict) and return it.  The
    converted tensors are assigned, so a module built on the meta device
    (without drawing its random init) gets real CPU tensors."""
    module.load_state_dict(state_dict_from_jax(module, variables), strict=True, assign=True)
    return module


def jax_variables_from_module(module: nn.Module) -> Dict[str, dict]:
    """The inverse bridge: {"params": ..., "batch_stats": ...} as nested
    dicts of float32 numpy arrays in the JAX package's layouts."""
    params: dict = {}
    stats: dict = {}

    def put(tree, path, leaf, value):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value.detach().float().cpu().contiguous().numpy()

    for name, sub in module.named_modules():
        path = name.split(".") if name else []
        if isinstance(sub, (Conv, ConvTranspose)):
            w = sub.weight
            kernel = w.flip(2, 3).permute(2, 3, 1, 0) if isinstance(sub, ConvTranspose) \
                else w.permute(2, 3, 1, 0)
            put(params, path, "kernel", kernel)
            if sub.bias is not None:
                put(params, path, "bias", sub.bias)
        elif isinstance(sub, nn.BatchNorm2d):
            put(params, path, "scale", sub.weight)
            put(params, path, "bias", sub.bias)
            put(stats, path, "mean", sub.running_mean)
            put(stats, path, "var", sub.running_var)
    return {"params": params, "batch_stats": stats} if stats else {"params": params}
