"""Weights by key name: the port's state dict and the JAX parameter tree.

`torch_key_to_path` is re-homed from facodec_tpu/utils/checkpoint.py (the
port must import without JAX): numeric key components merge into the name
before them (`block.1` -> `block_1`), the reference's `conv`/`convtr`
wrapper levels drop out, fixed DSP buffers map to None, and parametrized
weight-norm keys become `weight_g`/`weight_v`.

`load_jax_params` copies a JAX numpy parameter tree into a port module
(`load_jax_jdc_params` the JDC teacher's, whose JAX names follow their own
rule); `load_torch_checkpoint` copies a torch-saved checkpoint file (one
state dict per module, as the reference's `pytorch_model.bin`) into port
modules, both by the same path rule and with the same checks. Orbax training checkpoints
are the JAX trainer's format and are not read here. `init_random_` gives a
module seeded random weights from a torch.Generator, drawn as the JAX
package's initialisers draw them.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from facodec_tpu_torch.nn.activations import SnakeBeta

_DROP_TOKENS = ("conv", "convtr")


def torch_key_to_path(key: str) -> Optional[Tuple[str, ...]]:
    """Map a flat torch state_dict key to a flax param path, or None to skip."""
    if key.startswith("module."):
        key = key[len("module.") :]
    if key.endswith(".filter"):
        return None
    if key.startswith("to_mel.") or ".to_mel." in key:
        return None
    key = key.replace("parametrizations.weight.original0", "weight_g")
    key = key.replace("parametrizations.weight.original1", "weight_v")
    out = []
    for tok in key.split("."):
        if tok in _DROP_TOKENS:
            continue
        if tok.isdigit() and out:
            out[-1] = f"{out[-1]}_{tok}"
        else:
            out.append(tok)
    return tuple(out)


def flatten_tree(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> dict:
    """Nested mapping -> {path tuple: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def match_by_path(shapes: Mapping[str, Tuple[int, ...]], flat: Mapping[Tuple[str, ...], Any],
                  caller: str, source: str, path_of=torch_key_to_path) -> dict:
    """{port key: source array} for the port keys of `shapes`, each found in
    {param path: array} through `path_of`. Raises on a port key with no
    source parameter, on a source parameter no port key reaches, and on a
    shape mismatch."""
    missing, mismatched, found = [], [], {}
    for key, shape in shapes.items():
        path = path_of(key)
        if path not in flat:
            missing.append(key)
            continue
        src = np.asarray(flat[path])
        if tuple(src.shape) != tuple(shape):
            mismatched.append(f"{key}: {source} {tuple(src.shape)} vs port {tuple(shape)}")
            continue
        found[key] = (path, src)
    left = sorted("/".join(p) for p in set(flat) - {path for path, _ in found.values()})
    msgs = []
    if missing:
        msgs.append(f"{len(missing)} port keys without a {source} parameter: {missing[:8]}")
    if mismatched:
        msgs.append(f"{len(mismatched)} shape mismatches: {mismatched[:8]}")
    if left:
        msgs.append(f"{len(left)} {source} parameters left over: {left[:8]}")
    if msgs:
        raise ValueError(f"{caller}: " + "; ".join(msgs))
    return {key: src for key, (_, src) in found.items()}


def _copy_by_path(module: nn.Module, flat: Mapping[Tuple[str, ...], Any], caller: str,
                  source: str, path_of=torch_key_to_path) -> None:
    """Copy {param path: array} into `module` by `match_by_path`."""
    state = module.state_dict()
    found = match_by_path({k: v.shape for k, v in state.items()}, flat, caller, source, path_of)
    with torch.no_grad():
        for key, src in found.items():
            state[key].copy_(torch.from_numpy(np.array(src, dtype=np.float32)))


def load_jax_params(module: nn.Module, params: Mapping[str, Any]) -> None:
    """Copy a JAX parameter tree (numpy leaves) into `module` by key name."""
    _copy_by_path(module, flatten_tree(params), "load_jax_params", "JAX")


def jdc_key_to_path(key: str) -> Tuple[str, ...]:
    """A `models.jdc.JDCNet` key -> the JAX JDCNet's param path: the inverse
    of facodec_tpu/models/jdc.py `convert_jdc_state_dict`. The LSTM's
    tensors sit under one composite name (`bilstm_classifier/weight_ih_l0`),
    and `res_blockN.conv.M` keeps its Sequential index in the name
    (`conv_M`), which `torch_key_to_path`'s `conv` rule would drop."""
    if key.startswith("bilstm_classifier."):
        return (key.replace(".", "/", 1),)
    return torch_key_to_path(key.replace(".conv.", ".conv_"))


def load_jax_jdc_params(module: nn.Module, params: Mapping[str, Any]) -> None:
    """Copy the JAX JDCNet's parameter tree (numpy leaves) into a
    `models.jdc.JDCNet`, with `load_jax_params`'s checks."""
    _copy_by_path(module, flatten_tree(params), "load_jax_jdc_params", "JAX", jdc_key_to_path)


def load_torch_checkpoint(modules: Mapping[str, nn.Module], path: str) -> None:
    """Copy a torch-saved checkpoint, {module name: state dict} (under a
    `net` key for a training checkpoint), into `modules` by key name.

    Checkpoint keys go through `torch_key_to_path` as the port's keys do,
    so `module.` prefixes, `conv`/`convtr` wrapper levels and parametrized
    weight-norm keys are read, and fixed DSP buffers are skipped. Raises on
    a module the file does not hold and on any key that does not line up."""
    flats = read_torch_checkpoint(path, modules)
    for name, module in modules.items():
        _copy_by_path(module, flats[name], f"load_torch_checkpoint ({name})", "checkpoint")


def read_torch_checkpoint(path: str, names) -> dict:
    """{module name: {param path: numpy array}} of a torch-saved checkpoint
    (under a `net` key for a training checkpoint), for the modules `names`,
    by `torch_key_to_path`; raises on a module the file does not hold and
    on two keys that reach one path."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt.get("net"), Mapping):
        ckpt = ckpt["net"]
    out = {}
    for name in names:
        if not isinstance(ckpt.get(name), Mapping):
            raise ValueError(f"load_torch_checkpoint: {path} holds no state dict for "
                             f"{name!r} (has {sorted(ckpt)})")
        flat = {}
        for key, value in ckpt[name].items():
            p = torch_key_to_path(key)
            if p is None:
                continue
            if p in flat:
                raise ValueError(f"load_torch_checkpoint: {name}: two keys map to "
                                 f"{'/'.join(p)}")
            flat[p] = value.detach().cpu().numpy()
        out[name] = flat
    return out


def _uniform(shape, bound: float, gen: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * bound


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, in `named_parameters` order.

    Conv (1-D and 2-D) / linear weights (and weight-norm `weight_v`) and
    their biases: U(-1/sqrt(fan_in), +), fan_in = prod(shape[1:]) of the
    weight; weight-norm `weight_g` = ||v|| (so the effective weight is v);
    LSTM tensors: U(-1/sqrt(H), +); embedding tables (codebooks, code
    embeddings): N(0, 1); snake alphas: 1; SnakeBeta alpha and beta: 0 when
    stored as logs, else 1; the timbre linear bias: gamma half 1, beta half
    0."""
    params = dict(module.named_parameters())
    for name, p in params.items():
        leaf = name.rsplit(".", 1)[-1]
        owner = name[: -len(leaf) - 1]
        sub = module.get_submodule(owner)
        if isinstance(sub, SnakeBeta):
            p.fill_(0.0 if sub.alpha_logscale else 1.0)
        elif leaf == "alpha":
            p.fill_(1.0)
        elif isinstance(sub, nn.Embedding):
            p.copy_(torch.randn(p.shape, generator=generator))
        elif leaf.startswith(("weight_ih_l", "weight_hh_l", "bias_ih_l", "bias_hh_l")):
            hidden = params[f"{owner}.weight_hh_l0"].shape[1]
            p.copy_(_uniform(p.shape, 1.0 / math.sqrt(hidden), generator))
        elif leaf in ("weight", "weight_v"):
            p.copy_(_uniform(p.shape, 1.0 / math.sqrt(math.prod(p.shape[1:])), generator))
        elif leaf == "weight_g":
            v = params[f"{owner}.weight_v"]
            p.copy_(torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True)))
        elif leaf == "bias":
            w = params.get(f"{owner}.weight", params.get(f"{owner}.weight_v"))
            if owner.endswith("timbre_linear"):
                d = p.shape[0] // 2
                p.copy_(torch.cat([torch.ones(d), torch.zeros(d)]))
            else:
                p.copy_(_uniform(p.shape, 1.0 / math.sqrt(math.prod(w.shape[1:])), generator))
        else:
            raise ValueError(f"init_random_: no initialiser for parameter {name}")
    return module
