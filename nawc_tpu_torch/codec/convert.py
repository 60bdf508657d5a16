"""Flax parameters <-> the port's ``state_dict``.

A mechanical walk over the flax tree: each leaf path names the port's
submodule (the names match), and the leaf is re-laid out for its kind:

* ``Conv`` kernel (k, in, out) -> ``Conv1d`` weight (out, in, k);
* 2-D ``Conv`` kernel (kh, kw, in, out) -> ``Conv2d`` weight (out, in, kh, kw);
* ``ConvTranspose`` kernel (k, in, out) -> ``ConvTranspose1d`` weight
  (in, out, k), flipped along k (flax's transposed conv does not flip the
  kernel, PyTorch's does);
* ``Dense`` kernel (in, out) -> ``Linear`` weight (out, in);
* biases, Snake ``log_alpha``, codebooks and embeddings as they are.

:func:`state_dict_to_flax` is the inverse, for writing checkpoints that the
JAX package reads; :func:`flax_init_tree` draws the tree that flax's
``Module.init`` draws for the same model.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..utils import flaxinit
from ..utils.checkpoint import tree_leaves
from .layers import SameConvTranspose1d, Snake


def _kernel_to_weight(module: nn.Module, arr: np.ndarray, path: str) -> np.ndarray:
    if isinstance(module, SameConvTranspose1d):
        return np.flip(arr, 0).transpose(1, 2, 0)
    if isinstance(module, nn.Conv1d):
        return arr.transpose(2, 1, 0)
    if isinstance(module, nn.Conv2d):
        return arr.transpose(3, 2, 0, 1)
    if isinstance(module, nn.Linear):
        return arr.T
    raise ValueError(f"no conversion for kernel of {type(module).__name__} at {path}")


def _weight_to_kernel(module: nn.Module, arr: np.ndarray) -> np.ndarray:
    if isinstance(module, SameConvTranspose1d):
        return np.flip(arr.transpose(2, 0, 1), 0)
    if isinstance(module, nn.Conv1d):
        return arr.transpose(2, 1, 0)
    if isinstance(module, nn.Conv2d):
        return arr.transpose(2, 3, 1, 0)
    return arr.T  # nn.Linear


def flax_to_state_dict(tree: dict, model: nn.Module) -> dict[str, torch.Tensor]:
    """`tree` is the flax variables dict ({"params": ...}) of numpy arrays."""
    params = tree["params"] if "params" in tree else tree
    out: dict[str, torch.Tensor] = {}
    for path, leaf in tree_leaves(params).items():
        mod_path, _, name = path.rpartition("/")
        mod_name = mod_path.replace("/", ".")
        module = model.get_submodule(mod_name)
        arr = np.array(leaf, np.float32)  # a writable copy of the file view
        if name == "kernel":
            arr = _kernel_to_weight(module, arr, path)
            name = "weight"
        out[f"{mod_name}.{name}" if mod_name else name] = torch.from_numpy(np.ascontiguousarray(arr))
    want = model.state_dict()
    missing = sorted(set(want) - set(out))
    extra = sorted(set(out) - set(want))
    if missing or extra:
        raise ValueError(f"checkpoint does not fit the model: missing {missing}, unexpected {extra}")
    for k, v in out.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: checkpoint {tuple(v.shape)} vs model {tuple(want[k].shape)}")
    return out


def state_dict_to_flax(model: nn.Module) -> dict:
    """The module's parameters as a flax variables tree ({"params": ...}) of
    float32 numpy arrays, keys sorted as a jax pytree keeps them."""
    return to_flax_layout(model, model.state_dict())


def to_flax_layout(model: nn.Module, tensors: dict[str, torch.Tensor]) -> dict:
    """Tensors keyed by the model's parameter names (its weights, or their
    gradients) -> a flax tree ({"params": ...}) of float32 numpy arrays."""
    params: dict = {}
    for key, value in tensors.items():
        mod_name, _, name = key.rpartition(".")
        arr = value.detach().float().cpu().numpy()
        if name == "weight":
            arr, name = _weight_to_kernel(model.get_submodule(mod_name), arr), "kernel"
        node = params
        for part in mod_name.split(".") if mod_name else ():
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return {"params": _sorted(params)}


def _sorted(tree: dict) -> dict:
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def flax_init_tree(model: nn.Module, root: np.ndarray, zero_kernels=(), own=None) -> dict:
    """The flax variables tree (numpy, flax layout) that ``Module.init``
    with key `root` gives the flax module this model ports: LeCun
    truncated-normal kernels (zero at the module paths in `zero_kernels`),
    zero biases and Snake ``log_alpha``.  Each parameter draws from its own
    flax key (:mod:`..utils.flaxinit`).  `own(path, module)` returns the
    leaves a module declares itself (codebooks, embeddings), or None."""
    params: dict = {}
    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        leaves = {}
        if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.Linear)):
            shape = _weight_to_kernel(mod, np.empty(tuple(mod.weight.shape), np.float32)).shape
            leaves["kernel"] = (np.zeros(shape, np.float32) if path in zero_kernels
                                else flaxinit.lecun_normal(flaxinit.param_key(root, path), shape))
            if mod.bias is not None:
                leaves["bias"] = np.zeros(tuple(mod.bias.shape), np.float32)
        elif isinstance(mod, Snake):
            leaves["log_alpha"] = np.zeros(tuple(mod.log_alpha.shape), np.float32)
        if own is not None:
            leaves.update(own(path, mod) or {})
        if leaves:
            node = params
            for part in path:
                node = node.setdefault(part, {})
            node.update(leaves)
    return {"params": params}
