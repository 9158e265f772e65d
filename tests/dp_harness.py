"""Data-parallel train steps in spawned ranks, to hold them against the
one-process step (tests/test_torch_parallel.py, tests/test_torch_cuda.py).

    python tests/dp_harness.py SPEC OUT [--device D] [--backend B]

run as a rank (`facodec_tpu_torch.parallel.ranks.spawn_ranks` sets the
environment) joins the process group, runs `run_steps` on its rows of the
SPEC's global batch and writes what it returns to OUT/rank<r>.pt. SPEC is a
`torch.save`d list of dicts, run in turn:

  kind      "codec" (train/step.py) or "redecoder" (train/redecoder_step.py)
  fields    the modules' fields (the redecoder's with the frozen codec's
            under "codec"), seeded as the loops seed them (seed 0)
  batch     the global batch, numpy arrays of the step's keys
  split     the split step instead of the fused one
  draws     False to set every dropout rate and draw probability to 0
  steps     steps on the same batch (default 1); the generator is seeded
            with 1, as the loops seed it
  deterministic
            run the steps under `deterministic()` (for bit-for-bit
            comparisons on the card)
  tensor_parallel
            the model axis of the ranks' (data, model) layout (default 1):
            the wide heads are sharded (parallel/sharding.py) at
  min_elems the sharding rule's threshold (default 1 << 20); the gradients
            and parameters come back whole, gathered over the model group

Called in a plain process, `run_steps` is the one-process reference: the
same steps on the whole batch.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import warnings
from typing import Any, Dict, Iterator, Mapping

import torch
import torch.nn as nn

from facodec_tpu_torch.parallel.mesh import (GATHERED, MODEL_SUMS, REDUCED, data_world,
                                             form_layout, gather_model, init_distributed,
                                             is_distributed, is_sharded, rank_device, rank_rows,
                                             world_rank)
from facodec_tpu_torch.parallel.sharding import MIN_ELEMS, shard_training

SEED = 0  # the loops' default seed


def no_draws(module: nn.Module) -> nn.Module:
    """Every dropout rate and draw probability of the module set to 0."""
    for m in module.modules():
        for attr in ("p_dropout", "dropout", "quantizer_dropout", "prob_random_mask_residual"):
            if isinstance(getattr(m, attr, None), float):
                setattr(m, attr, 0.0)
    return module


def build(spec: Mapping[str, Any], device: str):
    """(trained modules, frozen modules) of the spec, seeded as the loops
    seed them, on `device`."""
    from facodec_tpu_torch.train import loop, redecoder_loop

    if spec["kind"] == "codec":
        models, frozen = loop.build_models(spec["fields"], SEED, device), {}
    else:
        frozen = redecoder_loop.build_frozen_codec(spec["fields"]["codec"], device)
        models = redecoder_loop.build_redecoder_models(spec["fields"], SEED, device)
    if not spec.get("draws", True):
        for m in models.values():
            no_draws(m)
    return models, frozen


@contextlib.contextmanager
def deterministic(on: bool = True) -> Iterator[None]:
    """Inside the block (where `on`), PyTorch's deterministic algorithms
    and cuDNN's: on the card a training step's backward otherwise sums some
    gradients by atomic adds in a varying order, so two runs of one step
    differ in the last bits. Ops without a deterministic form run as they
    are (`warn_only`; their warnings are silenced)."""
    if not on:
        yield
        return
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*deterministic.*")
            yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]


def run_steps(spec: Mapping[str, Any], device: str) -> Dict[str, Any]:
    """The spec's steps on this process's rows of its batch (all of them in
    one plain process): {"metrics": [{name: float} per step], "grads":
    {module: [tensor]} of the last step (as the update took them, reduced
    over the ranks), "params": {module.name: tensor} after, "launches":
    [kernel launches per step], "rows": [first, stop), "reduced":
    [all-reduce calls and bytes per step], "model": [model-group sums'
    and gathers' calls and bytes per step], "sharded": [module.name of
    each sharded parameter]}, tensors on the CPU, whole."""
    from facodec_tpu_torch.ops.kernels import resunit, vq
    from facodec_tpu_torch.train import redecoder_step
    from facodec_tpu_torch.train import step as codec_step
    from facodec_tpu_torch.train.data import to_device
    from facodec_tpu_torch.train.optimizers import build_optimizers

    lay = form_layout(int(spec.get("tensor_parallel", 1)) if is_distributed() else 1)
    models, frozen = build(spec, device)
    optimizers = build_optimizers(models, base_lr=1e-4)
    shard_training(models, optimizers, lay, int(spec.get("min_elems", MIN_ELEMS)))
    split = bool(spec.get("split", False))
    if spec["kind"] == "codec":
        make = (codec_step.make_codec_train_step_split if split
                else codec_step.make_codec_train_step)
        step_fn = make(models, optimizers)
    else:
        make = (redecoder_step.make_redecoder_train_step_split if split
                else redecoder_step.make_redecoder_train_step)
        step_fn = make(frozen, models, optimizers)
    rank, world = data_world()
    batch = spec["batch"]
    rows = rank_rows(len(batch["wave_seg"]), rank, world)
    local = to_device({k: v[rows] for k, v in batch.items()}, device)
    generator = torch.Generator(device=device).manual_seed(SEED + 1)
    out: Dict[str, Any] = {"metrics": [], "launches": [], "rows": [rows.start, rows.stop],
                           "reduced": [], "model": []}
    for _ in range(int(spec.get("steps", 1))):
        before = (resunit.fused_residual_unit.launches, vq.nearest_code.launches,
                  REDUCED.calls, REDUCED.bytes, MODEL_SUMS.calls + GATHERED.calls,
                  MODEL_SUMS.bytes + GATHERED.bytes)
        with deterministic(bool(spec.get("deterministic", False))):
            metrics, grads = step_fn(local, generator)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["launches"].append([resunit.fused_residual_unit.launches - before[0],
                                vq.nearest_code.launches - before[1]])
        out["reduced"].append([REDUCED.calls - before[2], REDUCED.bytes - before[3]])
        out["model"].append([MODEL_SUMS.calls + GATHERED.calls - before[4],
                             MODEL_SUMS.bytes + GATHERED.bytes - before[5]])

    def whole(t, p):
        return (gather_model(t.detach(), dim=0) if is_sharded(p) else t.detach()).cpu()

    out["grads"] = {k: [None if g is None else whole(g, p)
                        for g, p in zip(gs, optimizers[k].params)] for k, gs in grads.items()}
    out["params"] = {f"{k}.{n}": whole(p, p) for k, m in models.items()
                     for n, p in m.named_parameters()}
    out["sharded"] = [f"{k}.{n}" for k, m in models.items() for n, p in m.named_parameters()
                      if is_sharded(p)]
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python tests/dp_harness.py")
    p.add_argument("spec")
    p.add_argument("out")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None)
    args = p.parse_args(argv)
    if not init_distributed(args.device, args.backend):
        raise SystemExit("dp_harness: run as a rank (WORLD_SIZE set); see spawn_ranks")
    device = str(rank_device(args.device))
    results = [run_steps(s, device) for s in torch.load(args.spec, weights_only=False)]
    torch.save(results, os.path.join(args.out, f"rank{world_rank()[0]}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
