"""AOT artifacts on `torch.export` (port of facodec_tpu/utils/export.py).

An artifact pins the traced program of each inference function of one
codec at one (batch, seconds) signature: serving it needs neither the model
source's forward code nor a config, only this artifact and the weights.

Artifact = a directory:
    meta.json      format "facodec-torch-export", versions, device,
                   precision, shapes, and per function its file, its input
                   shapes and dtypes and the parameter keys and shapes it takes
    <name>.pt2     one `torch.export.save` program per function

Parameters stay an INPUT of every function, as in the JAX package: each
takes `params`, the codec's weights as one flat dict keyed as the port's
checkpoints key each module's state dict (`encoder.*`, `quantizer.*`,
`decoder.*`), so one artifact serves any checkpoint of the same
architecture. No parameter tensor is stored in the artifact; the fixed DSP
constants the functions read (the mel filterbank and window) are. The codec's
modules sit in a closure of the export root, and the parameters reach them
through `torch.func.functional_call`, so `torch.export` lifts none of them.

Exported functions (the JAX package's signatures):
    encode        (params, wave (B, T) f32)      -> (codes_p, codes_c, codes_r, timbre)
    decode        (params, cp, cc, cr (B, n, F) i32, timbre) -> wave (B, T) f32
    reconstruct   (params, wave)                 -> wave
    encode_masked / reconstruct_masked add lens (B,) i32, the rows' true
    lengths in samples: the bucketed-serving variants (a zero-padded
    request whose timbre pools its true length) that `serve --artifact` runs.

Each function is `FACodec`'s own tensor method, traced under its policy, so
an artifact computes what the live codec computes: the residual units and
the VQ search are the `facodec::` custom ops (ops/kernels/ops.py), one node
each; the LSTMs stay single `aten.lstm` nodes (no decomposition is run, which
would unroll them), but for one that runs the opt-in W8A8 recurrence
(FACODEC_LSTM_INT8=1 while exporting, nn/lstm.py), which is one
`facodec::lstm_int8` node a layer: the program keeps the route it was
exported with, whatever the flag says when it runs. Under `hybrid` the decoder's bf16 operands are packed by
graph ops on every call (models/dac.py `ResidualUnit.kept_pack`), where the
live codec keeps a pack per weight version.

Departures from the JAX package: there is no `--platforms` cross-export. A
program is exported on the device it will run on (`FACodec.device`), and
`meta.json` records it; the parameters must lie there. `ExportedCodec` runs
every call with TF32 off (`api.float32_exact`), since backend flags are
process state that a program does not capture.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, Mapping, Sequence

import torch
import torch.nn as nn

import facodec_tpu_torch.ops.kernels  # noqa: F401 -- registers the facodec:: ops a program holds
from facodec_tpu_torch.api import HOP, SR, float32_exact
from facodec_tpu_torch.ops.precision import POLICY_NAMES
from facodec_tpu_torch.utils.weights import match_by_path, read_torch_checkpoint

FORMAT = "facodec-torch-export"
VERSION = 1
META_NAME = "meta.json"
MODULES = ("encoder", "quantizer", "decoder")


def _codes_and_timbre(encoded):
    _, codes, timbre = encoded
    return (*codes, timbre)


# name -> fn(codec, *inputs), each a composition of FACodec's tensor methods
FUNCTIONS: Dict[str, Callable] = {
    "encode": lambda c, wave: _codes_and_timbre(c.encode_tensor(wave)),
    "decode": lambda c, cp, cc, cr, timbre: c.decode_tensor(cp, cc, cr, timbre),
    "reconstruct": lambda c, wave: c.decode_latent(c.encode_tensor(wave)[0]),
    "encode_masked": lambda c, wave, lens: _codes_and_timbre(c.encode_tensor(wave, lens)),
    "reconstruct_masked": lambda c, wave, lens: c.decode_latent(c.encode_tensor(wave, lens)[0]),
}


def codec_params(codec) -> Dict[str, torch.Tensor]:
    """The weights of a `FACodec` as its artifact's functions take them."""
    return {f"{name}.{key}": p.detach() for name in MODULES
            for key, p in getattr(codec, name).state_dict().items()}


class _Modules(nn.Module):
    """The codec's modules under their checkpoint names, for
    `functional_call`; `forward` runs one of FUNCTIONS on the codec."""

    def __init__(self, codec):
        super().__init__()
        self.encoder, self.quantizer, self.decoder = codec.encoder, codec.quantizer, codec.decoder
        self.codec = codec

    def forward(self, fn, *inputs):
        return fn(self.codec, *inputs)


class _Root(nn.Module):
    """The export root of one function. It owns no submodule and no
    parameter (the modules sit in a closure), so that `torch.export` lifts
    no weight into the program: they come in as its first input."""

    def __init__(self, modules: _Modules, fn: Callable):
        super().__init__()
        self._run = lambda params, *inputs: torch.func.functional_call(
            modules, params, (fn, *inputs))

    def forward(self, params, *inputs):
        return self._run(params, *inputs)


def _spec(t: torch.Tensor) -> list:
    return [list(t.shape), str(t.dtype).removeprefix("torch.")]


def export_codec(codec, out_dir: str, batch: int = 1, seconds: float = 10.0,
                 n_quantizer_groups: Sequence[int] = (1, 2, 3),
                 functions: Sequence[str] = tuple(FUNCTIONS)) -> Dict[str, Dict[str, float]]:
    """Export the codec's inference functions (all five, or those named)
    for one (batch, seconds) signature, on the codec's device; returns
    {name: {"bytes": file size, "seconds": export time}}. A codec sharded
    over replicas (`shard_inference`) is refused: a program runs on the one
    device it was exported on."""
    if codec.replicas is not None:
        raise ValueError("export_codec: the codec is sharded over replicas (shard_inference); "
                         "export an unsharded codec")
    if codec.precision == "hybrid_int8":
        # the JAX package's export hands the name to `policy()`, which knows
        # only the in-model policies and "hybrid" split by export itself
        raise ValueError(f"unknown precision policy {codec.precision!r}; expected one of "
                         f"{[n for n in POLICY_NAMES if n != 'hybrid_int8']}")
    dev = codec.device
    frames = int(seconds * SR) // HOP
    T = frames * HOP
    wave = torch.zeros(batch, T, device=dev)
    lens = torch.full((batch,), T, dtype=torch.int32, device=dev)
    cp, cc, cr = (torch.zeros(batch, n, frames, dtype=torch.int32, device=dev)
                  for n in n_quantizer_groups)
    timbre = torch.zeros(batch, codec.quantizer.timbre_linear.in_features, device=dev)
    inputs = {"encode": (wave,), "decode": (cp, cc, cr, timbre), "reconstruct": (wave,),
              "encode_masked": (wave, lens), "reconstruct_masked": (wave, lens)}
    params = codec_params(codec)
    modules = _Modules(codec)

    os.makedirs(out_dir, exist_ok=True)
    meta: Dict[str, Any] = {
        "format": FORMAT, "version": VERSION, "torch_version": torch.__version__,
        "device": str(dev), "precision": codec.precision, "n_c": codec.n_c, "batch": batch,
        "seconds": seconds, "frames": frames, "sample_rate": SR, "hop_length": HOP,
        "functions": {},
    }
    report = {}
    for name in functions:
        fn = FUNCTIONS[name]
        t0 = time.perf_counter()
        with torch.no_grad():
            program = torch.export.export(_Root(modules, fn), (params, *inputs[name]),
                                          strict=False)
        program.example_inputs = None  # else `save` stores them, and the parameters with them
        fname = f"{name}.pt2"
        path = os.path.join(out_dir, fname)
        torch.export.save(program, path)
        report[name] = {"bytes": os.path.getsize(path), "seconds": time.perf_counter() - t0}
        meta["functions"][name] = {
            "file": fname,
            "inputs": [_spec(t) for t in inputs[name]],
            "params": {k: _spec(v) for k, v in params.items()},
        }
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    return report


def read_meta(artifact_dir: str) -> Dict[str, Any]:
    """An artifact's meta.json; raises on a directory that is not one of
    this package's artifacts, a JAX artifact included."""
    with open(os.path.join(artifact_dir, META_NAME)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{artifact_dir} is not a facodec-torch export (meta.json format "
                         f"{meta.get('format')!r}; a JAX artifact, 'facodec-tpu-export', "
                         f"loads in facodec_tpu.utils.export)")
    return meta


class ExportedCodec:
    """An `export_codec` artifact, loaded: `.encode(params, wave)`,
    `.decode(params, cp, cc, cr, timbre)`, `.reconstruct(params, wave)`,
    `.encode_masked(params, wave, lens)`, `.reconstruct_masked(params,
    wave, lens)`, with `params` keyed as `meta.json` lists them (a missing
    or left-over key, or a wrong shape, raises). Calls run without
    gradients and with TF32 off; each program loads on its first call."""

    def __init__(self, artifact_dir: str):
        self.meta = read_meta(artifact_dir)
        self.dir = artifact_dir
        self.device = torch.device(self.meta["device"])
        self._programs: Dict[str, Callable] = {}
        self._load_lock = threading.Lock()

    def program(self, name: str) -> Callable:
        """The loaded program of function `name`, read from its file on
        first use (a server runs three of the five)."""
        with self._load_lock:
            if name not in self._programs:
                info = self.meta["functions"][name]
                self._programs[name] = torch.export.load(
                    os.path.join(self.dir, info["file"])).module()
            return self._programs[name]

    def load_params(self, ckpt_path: str) -> Dict[str, torch.Tensor]:
        """The artifact's `params` from a torch checkpoint that
        `load_torch_checkpoint` reads (one state dict per module, or a
        training checkpoint's `net`), on the artifact's device."""
        keys = next(iter(self.meta["functions"].values()))["params"]
        flats = read_torch_checkpoint(ckpt_path, MODULES)
        params = {}
        for name in MODULES:
            shapes = {k[len(name) + 1:]: tuple(v[0]) for k, v in keys.items()
                      if k.startswith(f"{name}.")}
            found = match_by_path(shapes, flats[name], f"ExportedCodec.load_params ({name})",
                                  "checkpoint")
            params.update({f"{name}.{k}": torch.from_numpy(v).to(self.device)
                           for k, v in found.items()})
        return {k: params[k] for k in keys}

    def _checked(self, name: str, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        want = self.meta["functions"][name]["params"]
        missing = sorted(set(want) - set(params))
        left = sorted(set(params) - set(want))
        shapes = [f"{k}: {tuple(params[k].shape)} vs {tuple(want[k][0])}" for k in want
                  if k in params and list(params[k].shape) != want[k][0]]
        msgs = []
        if missing:
            msgs.append(f"{len(missing)} parameters missing: {missing[:8]}")
        if left:
            msgs.append(f"{len(left)} parameters left over: {left[:8]}")
        if shapes:
            msgs.append(f"{len(shapes)} shape mismatches: {shapes[:8]}")
        if msgs:
            raise ValueError(f"ExportedCodec.{name}: " + "; ".join(msgs))
        return {k: params[k] for k in want}  # in the program's input order

    def __getattr__(self, name: str):
        if name not in self.__dict__.get("meta", {}).get("functions", {}):
            raise AttributeError(name)

        def call(params, *inputs):
            params = self._checked(name, params)
            program = self.program(name)
            with torch.no_grad(), float32_exact():
                return program(params, *inputs)

        return call
