"""The port's tensor parallelism (facodec_tpu_torch/parallel/sharding.py) on the CPU.

- The rule: the port's sharded parameter names equal the JAX package's
  `describe_shardings(tp_param_shardings(...))` keys, mapped through
  `torch_key_to_path`, on the tiny model at `min_elems=1024` and model
  axes of 2 and 4 (JAX's mesh over the conftest's 8 host devices, as
  tests/test_parallel.py builds it); at `FLAGSHIP_TRAIN` (shapes only, on
  the meta device) it picks the speaker heads, the phone heads and
  `timbre_linear`.
- Spawned gloo ranks (`parallel.ranks.spawn_ranks`): a column-parallel
  linear and the clip against numpy; the codec step at data 1 x model 2,
  fused and split, every draw on, against the one-process step, with a head
  whose rows do not split over 2 (33 phone classes: refused), heads whose
  biases are sharded too (4096 speakers) and one whose bias stays
  replicated (`timbre_linear`, 128 rows); `run_training(tensor_parallel=2)`
  with checkpoints, which load into one process and save again to the same
  tensors, and resume there; the step at data 2 x model 2 (four ranks,
  draws off) against the JAX step on a `make_mesh(2, 2)` mesh with
  `tp_param_shardings` (slow).

Tolerances: the steps' as chip_smoke.py 14b holds them (`DP_GRAD_TOL`,
`DP_STEP_TOL`): each module's gradients within 1e-4 of its max|g|, metrics
and updated parameters within rtol 2e-3, atol 2e-4. The toy's: 1e-12
(float64), the clip's update 1e-6 relative (float32). Against JAX:
tests/test_torch_parallel.py `test_two_rank_draws_off_step_matches_jax_mesh`'s.
"""

import copy
import json
import os
import shutil
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from facodec_tpu_torch.config import FLAGSHIP_TRAIN
from facodec_tpu_torch.models.builder import build_train_from_fields
from facodec_tpu_torch.parallel import mesh, ranks
from facodec_tpu_torch.parallel.sharding import tp_param_names
from facodec_tpu_torch.train import loop
from facodec_tpu_torch.train.data import PseudoDataset, collate, segment_batch
from facodec_tpu_torch.utils.weights import torch_key_to_path

import dp_harness
import test_torch_train_step as step_golden
from test_torch_train_loop import FIELDS as CODEC_FIELDS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 1e-4
STEP_TOL = dict(rtol=2e-3, atol=2e-4)
SPAWN_TIMEOUT = 240
MIN_ELEMS = 1024
# 4096 speakers: the speaker heads and their biases split; 33 phones: the
# phone heads do not split over 2; timbre_linear's 128-wide bias stays whole
TP_FIELDS = copy.deepcopy(CODEC_FIELDS)
TP_FIELDS["fa_predictors"] = dict(TP_FIELDS["fa_predictors"], n_speakers=4096,
                                  n_phone_classes=33)
# what `run_training` splits at the rule's default min_elems (1 << 20): the
# 16384 x 64 speaker heads and their biases
RUN_FIELDS = copy.deepcopy(TP_FIELDS)
RUN_FIELDS["fa_predictors"]["n_speakers"] = 16384
SHARDED_AT_2 = ["quantizer.timbre_linear.weight", "fa_predictors.timbre_predictor.weight",
                "fa_predictors.timbre_predictor.bias",
                "fa_predictors.rev_timbre_predictor.1.heads.0.weight",
                "fa_predictors.rev_timbre_predictor.1.heads.0.bias"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each spawned rank runs (OMP_NUM_THREADS=1)
    yield
    torch.set_num_threads(threads)


def _spawn(args, world=2):
    env = {"OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    return ranks.spawn_ranks(world, args, timeout=SPAWN_TIMEOUT, env=env)


# ------------------------------------------------------------------ the rule
@pytest.mark.parametrize("n_model", [2, 4])
def test_sharded_set_equals_jax_rule(n_model):
    from test_train_step import FRAMES, tiny_models

    from facodec_tpu.models.builder import init_params
    from facodec_tpu.parallel.mesh import make_mesh
    from facodec_tpu.parallel.sharding import describe_shardings, tp_param_shardings

    shapes = jax.eval_shape(
        lambda k: init_params(tiny_models(), k, seg_frames=FRAMES, batch=1),
        jax.random.PRNGKey(0))
    jmesh = make_mesh(n_data=8 // n_model, n_model=n_model)
    want = set(describe_shardings(tp_param_shardings(shapes, jmesh, min_elems=MIN_ELEMS)))
    models = build_train_from_fields(step_golden.FIELDS)
    got = {f"{k}/" + "/".join(torch_key_to_path(n))
           for k, m in models.items()
           for n in tp_param_names(m.named_parameters(), n_model, MIN_ELEMS)}
    assert want and got == want
    assert not tp_param_names(models["fa_predictors"].named_parameters(), 1, MIN_ELEMS)


def test_flagship_sharded_set():
    with torch.device("meta"):
        models = build_train_from_fields(FLAGSHIP_TRAIN)
    got = {k: sorted(tp_param_names(m.named_parameters(), 2)) for k, m in models.items()}
    heads = ["phone_predictor.heads.0.weight", "rev_content_predictor.1.heads.0.weight",
             "rev_timbre_predictor.1.heads.0.bias", "rev_timbre_predictor.1.heads.0.weight",
             "timbre_predictor.bias", "timbre_predictor.weight"]
    assert got == dict(encoder=[], quantizer=["timbre_linear.weight"], decoder=[],
                       fa_predictors=heads, discriminator=[])
    n = sum(p.numel() for k, m in models.items() for name, p in m.named_parameters()
            if name in got[k])
    assert 40e6 < n < 50e6  # about 45M of the 330M


# ------------------------------------------------------------------- the toy
TOY = textwrap.dedent("""
    import json
    import numpy as np, torch
    from facodec_tpu_torch.parallel import mesh
    from facodec_tpu_torch.parallel.sharding import ColumnParallelLinear, shard_training
    from facodec_tpu_torch.train.optimizers import AdamW
    assert mesh.init_distributed("cpu")
    lay = mesh.form_layout(2)
    rng = np.random.default_rng(0)
    out = {}
    for split in ((True, True), (True, False), (False, True)):
        lin = torch.nn.Linear(5, 6).double()
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(rng.standard_normal((6, 5))))
            lin.bias.copy_(torch.from_numpy(rng.standard_normal(6)))
        x = torch.from_numpy(rng.standard_normal((3, 5))).requires_grad_()
        cpl = ColumnParallelLinear(lin, lay, *split)
        y = cpl(x)
        (y * torch.arange(18.0, dtype=torch.float64).view(3, 6)).sum().backward()
        out[str(split)] = dict(y=y.tolist(), gx=x.grad.tolist(),
                               gw=cpl.weight.grad.tolist(), gb=cpl.bias.grad.tolist())
    # the clip: one sharded (8 x 3, 4 rows a rank) and one replicated tensor
    w = torch.nn.Parameter(torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32)))
    b = torch.nn.Parameter(torch.from_numpy(rng.standard_normal(4).astype(np.float32)))
    gw = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32)) * 3
    gb = torch.from_numpy(rng.standard_normal(4).astype(np.float32)) * 3
    opt = AdamW([("w.weight", w), ("b", b)], base_lr=1e-2, clip_norm=5.0)
    lin = torch.nn.Linear(3, 8, bias=False)
    lin.weight = w
    model = torch.nn.ModuleDict(dict(w=lin))
    opt.names = ["w.weight", "b"]
    shard_training(dict(m=model), dict(m=opt), lay, min_elems=1)
    n = 4 * lay.model_rank
    norm = opt.step([gw[n:n + 4], gb])
    out["clip"] = dict(norm=float(norm), w=opt.params[0].tolist(), b=opt.params[1].tolist(),
                       rank=lay.model_rank, sums=mesh.MODEL_SUMS.calls)
    print(json.dumps(out))
""")


def _adamw_numpy(p, g, clip, lr=1e-2, b1=0.9, b2=0.98, eps=1e-9, wd=0.1):
    norm = np.sqrt(sum(np.sum(x.astype(np.float64) ** 2) for x in g))
    scale = 1.0 if norm < clip else clip / norm
    out = []
    for x, gx in zip(p, g):
        gx = gx * scale
        m, v = (1 - b1) * gx, (1 - b2) * gx * gx
        upd = (m / (1 - b1)) / (np.sqrt(v / (1 - b2)) + eps) + wd * x
        out.append(x - lr * upd)
    return norm, out


def test_column_parallel_linear_and_clip_match_numpy():
    outs = [json.loads(o.strip().splitlines()[-1]) for o in _spawn(["-c", TOY])]
    rng = np.random.default_rng(0)
    for shard_weight, shard_bias in ((True, True), (True, False), (False, True)):
        W, bias = rng.standard_normal((6, 5)), rng.standard_normal(6)
        X = rng.standard_normal((3, 5))
        G = np.arange(18.0).reshape(3, 6)
        for r, o in enumerate(outs):
            got = o[str((shard_weight, shard_bias))]
            rows = slice(3 * r, 3 * r + 3) if shard_weight else slice(None)
            np.testing.assert_allclose(got["y"], X @ W.T + bias, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(got["gx"], G @ W, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(got["gw"], G.T[rows] @ X, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(got["gb"], G.sum(0)[slice(3 * r, 3 * r + 3)]
                                       if shard_bias else G.sum(0), rtol=1e-12, atol=1e-12)
    w = rng.standard_normal((8, 3)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    gw = rng.standard_normal((8, 3)).astype(np.float32) * 3
    gb = rng.standard_normal(4).astype(np.float32) * 3
    norm, (w1, b1) = _adamw_numpy([w, b], [gw, gb], clip=5.0)
    assert norm > 5.0  # the clip scales
    for o in outs:
        c = o["clip"]
        r = c["rank"]
        np.testing.assert_allclose(c["norm"], norm, rtol=1e-6)
        np.testing.assert_allclose(c["w"], w1[4 * r:4 * r + 4], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(c["b"], b1, rtol=1e-6, atol=1e-7)
        assert c["sums"] >= 1


# ------------------------------------------------------------------ the steps
def _pseudo_batch():
    ds = PseudoDataset(length=4, seed=0, min_s=1.0, max_s=1.5, n_phones=32, n_speakers=16)
    return segment_batch(collate([ds[i] for i in range(4)]), max_frames=8,
                         generator=torch.Generator().manual_seed(0))


def _grad_gap(got, want):
    pairs = [(a, b) for a, b in zip(got, want) if b is not None]
    scale = max(float(b.abs().max()) for _, b in pairs)
    return max(float((a - b).abs().max()) for a, b in pairs) / scale


def check_tp_step(tmp_path, split: bool) -> None:
    """Data 1 x model 2, every draw on: both ranks hold the whole batch,
    draw alike, and give the one-process step's gradients, metrics and
    (gathered) parameters (tests/test_torch_parallel.py holds the fused
    step with it)."""
    spec = dict(kind="codec", fields=TP_FIELDS, split=split, batch=_pseudo_batch(),
                tensor_parallel=2, min_elems=MIN_ELEMS)
    torch.save([spec], tmp_path / "spec.pt")
    _spawn([os.path.join(ROOT, "tests", "dp_harness.py"), str(tmp_path / "spec.pt"),
            str(tmp_path), "--device", "cpu"])
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False)[0] for r in range(2))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank runs: the sums then go in the ranks' order
    try:
        one = dp_harness.run_steps(spec, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert r0["sharded"] == r1["sharded"] == SHARDED_AT_2
    assert r0["rows"] == r1["rows"] == [0, 4]
    assert r0["model"][0][0] > 0 and r0["reduced"][0][0] > 0
    for mod in one["grads"]:
        for a, b in zip(r0["grads"][mod], r1["grads"][mod]):
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), mod
        gap = _grad_gap(r0["grads"][mod], one["grads"][mod])
        assert gap <= GRAD_TOL, f"{mod}: gradient gap {gap:.2e} of max|g| > {GRAD_TOL}"
    for k, v in one["metrics"][0].items():
        np.testing.assert_allclose(r0["metrics"][0][k], v, err_msg=k, **STEP_TOL)
        assert r0["metrics"][0][k] == r1["metrics"][0][k], k
    for k, v in one["params"].items():
        torch.testing.assert_close(r0["params"][k], v, msg=k, **STEP_TOL)
        assert torch.equal(r0["params"][k], r1["params"][k]), k


def test_tp_split_step_matches_one_process(tmp_path):
    check_tp_step(tmp_path, split=True)


@pytest.mark.parametrize("gpus", [0, 1, 2, 3, 4, 8])
@pytest.mark.parametrize("tp", [1, 2, 3, 4])
def test_train_command_ranks_with_tensor_parallel(monkeypatch, tmp_path, gpus, tp):
    """`train` alone on the card starts gcd(batch_size, GPUs // tp) x tp
    ranks (a config of batch 4 and `tensor_parallel: tp`), and refuses a
    model axis wider than the visible GPUs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: gpus > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    from facodec_tpu_torch.cli import train as train_cli

    config = tmp_path / "tp.yml"
    config.write_text(f"batch_size: 4\ntensor_parallel: {tp}\n")
    if tp > max(gpus, 1):
        with pytest.raises(ValueError, match=f"tensor_parallel {tp} asked for"):
            train_cli.n_ranks(str(config), "cuda")
    else:
        want = 1 if gpus == 0 else np.gcd(4, gpus // tp) * tp
        assert train_cli.n_ranks(str(config), "cuda") == want
    assert train_cli.n_ranks(str(config), "cpu") == 1


RUN_TP = textwrap.dedent("""
    import sys
    import torch
    from facodec_tpu_torch.parallel import mesh
    from facodec_tpu_torch.parallel.sharding import whole_state_dict
    from facodec_tpu_torch.train import loop
    from facodec_tpu_torch.train.data import PseudoDataset
    sys.path.insert(0, sys.argv[1])
    from test_torch_tp import RUN_FIELDS
    torch.set_num_threads(1)
    ds = PseudoDataset(length=4, seed=0, min_s=1.0, max_s=1.5, n_phones=32, n_speakers=16)
    items = [ds[i] for i in range(4)]

    def train(log_dir, steps):
        return loop.run_training(fields=RUN_FIELDS, dataset=items, max_steps=steps, device="cpu",
                                 log_dir=log_dir, log_writer=None, batch_size=4, max_len=8,
                                 save_interval=1, tensor_parallel=2)

    out = sys.argv[2]
    a = train(out + "/tp", 2)
    b = train(out + "/from_one", 2)  # resumes the one-process run's step-1 checkpoint
    whole = {k: whole_state_dict(m) for k, m in b.models.items()}
    sharded = sorted(n for m in a.models.values() for n, p in m.named_parameters()
                     if mesh.is_sharded(p))
    if torch.distributed.get_rank() == 0:
        torch.save(dict(steps=(a.step, b.step), from_one=whole, metrics=a.metrics,
                        sharded=sharded), out + "/run.pt")
""")


def _one_process(log_dir, steps, items):
    return loop.run_training(fields=RUN_FIELDS, dataset=items, max_steps=steps, device="cpu",
                             log_dir=str(log_dir), log_writer=False, batch_size=4, max_len=8,
                             save_interval=1)


def _tensors(ckpt):
    out = {}
    for part in ("net", "optimizer"):
        for k, sd in ckpt[part].items():
            for name, v in sd.items():
                if isinstance(v, dict):
                    out.update({f"{part}.{k}.{name}.{n}": t for n, t in v.items()})
                else:
                    out[f"{part}.{k}.{name}"] = v
    return out


def test_tp_run_training_checkpoints_round_trip(tmp_path):
    """`run_training(tensor_parallel=2)` over two gloo ranks writes whole
    tensors: its checkpoint loads into one process and saves again to the
    same tensors, a one-process run resumed from it gives the two-step run,
    and a tensor-parallel run resumes a one-process checkpoint."""
    ds = PseudoDataset(length=4, seed=0, min_s=1.0, max_s=1.5, n_phones=32, n_speakers=16)
    items = [ds[i] for i in range(4)]
    _one_process(tmp_path / "from_one", 1, items)
    _spawn(["-c", RUN_TP, os.path.join(ROOT, "tests"), str(tmp_path)])
    run = torch.load(tmp_path / "run.pt", weights_only=False)
    assert run["steps"] == (2, 2)
    assert run["sharded"] == sorted(["timbre_predictor.weight", "timbre_predictor.bias",
                                     "rev_timbre_predictor.1.heads.0.weight",
                                     "rev_timbre_predictor.1.heads.0.bias"])

    ckpt_path = loop.latest_checkpoint(str(tmp_path / "tp"))
    assert ckpt_path.endswith("_step_00002.pth")
    ckpt = torch.load(ckpt_path, weights_only=True)
    assert ckpt["net"]["fa_predictors"]["timbre_predictor.weight"].shape == (16384, 64)
    assert ckpt["optimizer"]["fa_predictors"]["mu"]["timbre_predictor.weight"].shape == (16384, 64)
    # load in one process, save again: the same tensors, generators, step and epoch
    state = loop.TrainState(loop.build_models(RUN_FIELDS, 0, "cpu"), {}, 0, 0)
    state.optimizers = loop.build_optimizers(state.models)
    gens = dict(step=torch.Generator(), data=torch.Generator())
    loop.load_checkpoint(ckpt_path, state, gens)
    (tmp_path / "again").mkdir()
    again = torch.load(loop.save_checkpoint(str(tmp_path / "again"), state, gens),
                       weights_only=True)
    want, got = _tensors(ckpt), _tensors(again)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v) if torch.is_tensor(v) else got[k] == v, k
    for k in ("step", "epoch"):
        assert again[k] == ckpt[k]
    for k, v in ckpt["generators"].items():
        assert torch.equal(again["generators"][k], v), k

    # one process resumes the tensor-parallel run's step-1 checkpoint
    resumed_dir = tmp_path / "resumed"
    resumed_dir.mkdir()
    first = [p for p in os.listdir(tmp_path / "tp") if p.endswith("_step_00001.pth")]
    assert first
    for p in first:
        shutil.copy(tmp_path / "tp" / p, resumed_dir)
    resumed = _one_process(resumed_dir, 2, items)
    plain = _one_process(tmp_path / "plain", 2, items)
    for k, m in plain.models.items():
        for n, p in m.named_parameters():
            torch.testing.assert_close(dict(resumed.models[k].named_parameters())[n], p,
                                       msg=f"{k}.{n}", **STEP_TOL)
            torch.testing.assert_close(ckpt["net"][k][n], p, msg=f"{k}.{n}", **STEP_TOL)
            torch.testing.assert_close(run["from_one"][k][n], p, msg=f"{k}.{n}", **STEP_TOL)
    for k, v in plain.metrics.items():
        np.testing.assert_allclose(run["metrics"][k], v, err_msg=k, **STEP_TOL)


@pytest.mark.slow
def test_tp_step_at_data2_model2_matches_jax_mesh(tmp_path):
    """Four ranks, data 2 x model 2, draws off: the gradients and metrics
    against the JAX step on a `make_mesh(n_data=2, n_model=2)` mesh with
    `tp_param_shardings` (min_elems 1024), under
    test_two_rank_draws_off_step_matches_jax_mesh's tolerances."""
    from facodec_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from facodec_tpu.parallel.sharding import apply_shardings, tp_param_shardings

    spec = dict(kind="codec", fields=step_golden.FIELDS, split=False, draws=False,
                batch=step_golden.make_batch(np.random.default_rng(0), batch=4),
                tensor_parallel=2, min_elems=MIN_ELEMS)
    torch.save([spec], tmp_path / "spec.pt")
    _spawn([os.path.join(ROOT, "tests", "dp_harness.py"), str(tmp_path / "spec.pt"),
            str(tmp_path), "--device", "cpu"], world=4)
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)[0] for r in range(4)]
    assert [r["rows"] for r in res] == [[0, 2], [0, 2], [2, 4], [2, 4]]
    assert res[0]["sharded"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        models = {k: step_golden.J_CLASSES[k](**step_golden.FIELDS[k])
                  for k in step_golden.MODULES}
        seeded = dp_harness.build(dict(spec, kind="codec"), "cpu")[0]
        params = {k: step_golden.jax_tree(seeded[k]) for k in step_golden.MODULES}
        optimizers = step_golden.j_build_optimizers(models.keys(), base_lr=1e-4)
        opt_states = step_golden.init_opt_states(optimizers, params)
        jmesh = make_mesh(n_data=2, n_model=2)
        with jmesh:
            metrics, grads = step_golden._jax_step(models, optimizers)(
                apply_shardings(params, tp_param_shardings(params, jmesh,
                                                           min_elems=MIN_ELEMS)),
                replicate(jmesh, opt_states),
                shard_batch(jmesh, {k: jnp.asarray(v) for k, v in spec["batch"].items()}),
                jax.random.PRNGKey(1))
    for k, v in metrics.items():
        np.testing.assert_allclose(res[0]["metrics"][0][k], float(v), err_msg=k,
                                   **step_golden.TOL)
    grads = jax.tree.map(np.asarray, grads)
    for mod in step_golden.MODULES:
        want = step_golden.by_path(seeded[mod], grads[mod])
        scale = max(np.abs(w).max() for w in want.values())
        for (name, _), g in zip(seeded[mod].named_parameters(), res[0]["grads"][mod]):
            got = np.zeros_like(want[name]) if g is None else g.numpy()
            err = np.abs(got - want[name]).max()
            assert err <= 1e-3 * scale + 1e-7, f"{mod}.{name}: {err:.3e} (max|g| {scale:.3e})"
