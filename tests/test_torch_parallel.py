"""The port's data parallelism (facodec_tpu_torch/parallel/) on the CPU.

- Batch-parallel inference: `FACodec.shard_inference(["cpu", "cpu"])` and
  `FARedecoder.shard_inference` at batch 3 (the pad path) on the JAX
  package's weights: codes bit-equal to JAX's `shard_inference` over the
  conftest's 8 virtual devices (tests/test_parallel.py), waves and timbre
  within 2e-4 of JAX's, and the sharded port within 1e-5 of the unsharded
  port. A sharded `CodecService` (tests/test_serve.py
  `test_serve_sharded_inference`), `serve --shard-inference`'s refusals,
  and `float32_exact` and the precision policy in the replica threads.
- Spawned gloo ranks (`parallel.ranks.spawn_ranks`, each rank one process,
  every spawn with its own timeout): the rank-rows rule, the bucketed
  all-reduce and broadcast, and a toy gradient against numpy; two ranks of
  the tiny codec step, fused and split, with every draw on, on a 4-row
  `PseudoDataset` batch of unequal lengths, against the one-process step on
  the whole batch; the same for the redecoder step; with the draws off, the
  two ranks against JAX's step on a 2-device data mesh; and two-rank
  `run_training`: rank 0 alone writes, a resume equals the run that goes
  on, and the generators agree across ranks; and the fused codec step of
  two tensor-parallel ranks (data 1 x model 2) against one process.

Tolerances of the steps: metrics and updated parameters within rtol 2e-3
and atol 2e-4 (tests/test_parallel.py's data-parallel step against one
device). Gradients: the discriminator's (phase D, one mean over the batch)
within 1e-5 of max|g|; the generator modules' within 5e-5 of max|g| per
module. The one-process reference runs on one intra-op thread, as each
rank does; the ranks then differ from it by up to 3.5e-5 of max|g| (the
codec encoder; 1.5e-5 in the redecoder), the sums of two rows per rank
against four. That is within the float32 floor of this step, not a gap of
the reduction: the one-process step against itself with one and two
intra-op threads differs by up to 1.2e-4 of max|g| in the encoder with the
draws on, as its spectral and L1 losses pass rounding through near-zero
magnitudes and signs.
"""

import contextlib
import copy
import json
import os
import textwrap
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from facodec_tpu_torch.api import FACodec, FARedecoder, float32_exact
from facodec_tpu_torch.cli import serve, train as train_cli
from facodec_tpu_torch.models.builder import build_codec, build_redecoder
from facodec_tpu_torch.models.quantize import ResidualVectorQuantize
from facodec_tpu_torch.nn.basic import dropout
from facodec_tpu_torch.ops.precision import get_policy
from facodec_tpu_torch.parallel import mesh, ranks
from facodec_tpu_torch.train import loop
from facodec_tpu_torch.train.data import PseudoDataset, collate, segment_batch
from facodec_tpu_torch.utils.config import load_config
from facodec_tpu_torch.utils.weights import init_random_, load_jax_params

import dp_harness
import test_torch_train_step as step_golden
from test_torch_tp import check_tp_step
from test_torch_redecoder_train import FIELDS as RED_FIELDS
from test_torch_train_loop import FIELDS as CODEC_FIELDS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "tiny_config.yml")
SR, HOP = 24000, 300
STEP_TOL = dict(rtol=2e-3, atol=2e-4)
DISC_GRAD = 1e-5
GEN_GRAD = 5e-5
SPAWN_TIMEOUT = 240


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def waves3(seconds_frames=24):
    rng = np.random.default_rng(3)
    t = np.arange(seconds_frames * HOP) / SR
    return (0.3 * np.sin(2 * np.pi * np.array([[180.0], [220.0], [300.0]]) * t)
            + 0.01 * rng.standard_normal((3, len(t)))).astype(np.float32)


# ------------------------------------------------------------- inference
@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's codec and redecoder (tiny config, seed 0) sharded over the 8
    virtual devices, their outputs, and the port on the same weights."""
    from facodec_tpu.api import FACodec as JFACodec
    from facodec_tpu.api import FARedecoder as JFARedecoder

    wave = waves3()
    jc = JFACodec.from_config(TINY, n_c=1).shard_inference()
    jf = jc.encode(wave)
    jr = JFARedecoder.from_config(TINY).shard_inference()
    out = dict(f=jf, decode=jc.decode(jf), reconstruct=jc.reconstruct(wave),
               timbre=jc.timbre_of(wave), vc=jr.resynthesize(jf, jf.timbre))
    mp = load_config(TINY).model_params
    port = build_codec(mp)
    for k in ("encoder", "quantizer", "decoder"):
        load_jax_params(port[k], jc.params[k])
    red = build_redecoder(mp)
    for k in ("encoder", "decoder"):
        load_jax_params(red[k], jr.params[k])
    out["port"] = FACodec(port["encoder"], port["quantizer"], port["decoder"], n_c=1)
    out["red"] = FARedecoder(red["encoder"], red["decoder"])
    return out


def _port_outputs(codec, red, wave):
    f = codec.encode(wave)
    return dict(f=f, decode=codec.decode(f), reconstruct=codec.reconstruct(wave),
                timbre=codec.timbre_of(wave), vc=red.resynthesize(f, f.timbre),
                subset=codec.decode_subset(f, use_residual=False))


def test_shard_inference_matches_jax_and_unsharded(jax_sharded):
    wave = waves3()
    codec, red = jax_sharded["port"], jax_sharded["red"]
    one = _port_outputs(codec, red, wave)
    codec.shard_inference(["cpu", "cpu"])
    red.shard_inference(["cpu", "cpu"])
    try:
        assert len(codec.replicas) == 2 and len(red.replicas) == 2
        two = _port_outputs(codec, red, wave)
    finally:
        codec.replicas.close()
        red.replicas.close()
        codec.replicas = red.replicas = None
    jf = jax_sharded["f"]
    for name in ("codes_p", "codes_c", "codes_r"):
        np.testing.assert_array_equal(getattr(two["f"], name), getattr(jf, name))
        np.testing.assert_array_equal(getattr(two["f"], name), getattr(one["f"], name))
    np.testing.assert_allclose(two["f"].timbre, jf.timbre, rtol=2e-4, atol=2e-4)
    for key in ("decode", "reconstruct", "timbre", "vc"):
        np.testing.assert_allclose(two[key], jax_sharded[key], rtol=2e-4, atol=2e-4,
                                   err_msg=key)
    for key in ("decode", "reconstruct", "timbre", "vc", "subset"):
        np.testing.assert_allclose(two[key], one[key], rtol=1e-5, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(two["f"].timbre, one["f"].timbre, rtol=1e-5, atol=1e-5)


def test_sharded_tensor_forms_pad_and_trim():
    """The `*_tensor` forms split a batch of 3 over 3 replicas and of 5
    over 2 (zero rows with full-length wave_lens, whether `wave_lens` is
    passed by name or by position), in row order."""
    codec = FACodec.from_config(TINY, device="cpu")
    wave = torch.from_numpy(np.concatenate([waves3(), waves3()[:2] * 0.5]))
    lens = torch.tensor([24 * HOP, 20 * HOP, 13 * HOP, 24 * HOP, 9 * HOP])
    want = codec.encode_tensor(wave, wave_lens=lens)
    want_rt = codec.reconstruct_tensor(wave, wave_lens=lens)
    for devices in (["cpu"] * 3, ["cpu"] * 2):
        codec.shard_inference(devices)
        got = codec.encode_tensor(wave, wave_lens=lens)
        got_rt = codec.reconstruct_tensor(wave, wave_lens=lens)
        named = []
        run = codec.replicas.run
        codec.replicas.run = lambda name, kwargs: (named.append(sorted(kwargs)),
                                                   run(name, kwargs))[1]
        positional = codec.encode_tensor(wave, lens)
        assert named == [["wave", "wave_lens"]]  # padded with full-length rows by name
        for got in (got, positional):
            assert got[0].shape == want[0].shape
            for a, b in zip(got[1], want[1]):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)
        for got_rt in (got_rt, codec.reconstruct_tensor(wave, lens)):
            torch.testing.assert_close(got_rt, want_rt, rtol=1e-5, atol=1e-5)
    codec.replicas.close()


def test_export_refuses_a_sharded_codec(tmp_path):
    """An exported program runs on one device: a codec sharded over
    replicas is refused rather than exported from its first replica."""
    from facodec_tpu_torch.utils import export

    codec = FACodec.from_config(TINY, device="cpu").shard_inference(["cpu", "cpu"])
    try:
        with pytest.raises(ValueError, match="sharded over replicas"):
            export.export_codec(codec, str(tmp_path), functions=("encode",))
    finally:
        codec.replicas.close()


def test_shard_inference_needs_gpus_unless_named(monkeypatch):
    """No fallback: without named devices it takes every visible GPU, and
    raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codec = FACodec.from_config(TINY, device="cpu")
    with pytest.raises(RuntimeError, match="replica GPU"):
        codec.shard_inference()
    with pytest.raises(RuntimeError, match="replica GPU"):
        mesh.make_devices()


def test_serve_sharded_inference():
    """--shard-inference semantics: a CodecService over a sharded codec
    returns the unsharded service's codes and audio, and each stacked batch
    is a multiple of the replica count."""
    def tone(seconds, hz, seed):
        t = np.arange(int(seconds * SR)) / SR
        rng = np.random.default_rng(seed)
        return (0.4 * np.sin(2 * np.pi * hz * t) + 0.02 * rng.standard_normal(len(t))
                ).astype(np.float32)

    wave = tone(0.6, 260.0, 21)
    ref = serve.CodecService(FACodec.from_config(TINY, device="cpu"), bucket_seconds=0.5,
                             stream_threshold_seconds=4.0)
    codec = FACodec.from_config(TINY, device="cpu").shard_inference(["cpu"] * 3)
    svc = serve.CodecService(codec, bucket_seconds=0.5, stream_threshold_seconds=4.0)
    seen = []
    run = codec.replicas.run
    codec.replicas.run = lambda name, kwargs: (seen.append(kwargs["wave"].shape[0]),
                                               run(name, kwargs))[1]
    try:
        f_ref, f_dp = ref.encode(wave), svc.encode(wave)
        for name in ("codes_p", "codes_c", "codes_r"):
            np.testing.assert_array_equal(getattr(f_dp, name), getattr(f_ref, name))
        np.testing.assert_allclose(f_dp.timbre, f_ref.timbre, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(svc.reconstruct(wave), ref.reconstruct(wave),
                                   rtol=1e-5, atol=1e-5)
        assert seen and all(b % 3 == 0 for b in seen), seen
    finally:
        ref.close()
        svc.close()
        codec.replicas.close()


def test_serve_shard_inference_refusals(monkeypatch):
    """--shard-inference serves instead of exiting; it refuses an artifact
    (bound to its export device) and a host with no GPU, rather than
    serving from one device."""
    args = serve.add_args(__import__("argparse").ArgumentParser()).parse_args(
        ["--artifact", "x", "--ckpt-path", "y", "--shard-inference", "--device", "cpu"])
    with pytest.raises(SystemExit, match="exported on"):
        serve.main(args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.add_args(__import__("argparse").ArgumentParser()).parse_args(
        ["--config-path", TINY, "--shard-inference", "--device", "cpu", "--no-warmup"])
    with pytest.raises(RuntimeError, match="replica GPU"):
        serve.main(args)


def test_float32_exact_and_policy_hold_in_replica_threads():
    """While a sharded hybrid call runs in two replica threads, every
    residual unit sees TF32 off, the decoder's run the bf16 policy on bf16
    activations in the workers, and the flags come back afterwards."""
    codec = FACodec.from_config(TINY, device="cpu", precision="hybrid")
    wave = waves3()
    want = codec.reconstruct(wave)
    codec.shard_inference(["cpu", "cpu"])
    seen = []

    def hook(part):
        def record(mod, args):
            seen.append((threading.current_thread().name, torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32, get_policy(), args[0].dtype,
                         part))
        return record

    hooks = [m.register_forward_pre_hook(hook(name))
             for r in codec.replicas.replicas
             for name, part in (("encoder", r.encoder), ("decoder", r.decoder))
             for m in part.modules() if m.__class__.__name__ == "ResidualUnit"]
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = codec.reconstruct(wave)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        for h in hooks:
            h.remove()
        codec.replicas.close()
    threads = {s[0] for s in seen}
    assert len(threads) == 2 and all(t.startswith("facodec-replica") for t in threads)
    assert not any(s[1] or s[2] for s in seen)
    dec = [s for s in seen if s[5] == "decoder"]
    enc = [s for s in seen if s[5] == "encoder"]
    assert dec and enc and {s[0] for s in dec} == threads
    assert all(s[3] == "bfloat16_act" and s[4] == torch.bfloat16 for s in dec)
    assert all(s[3] == "float32" and s[4] == torch.float32 for s in enc)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_float32_exact_counts_its_holders():
    """Two threads entering and leaving interleaved: TF32 stays off until
    the last one leaves, then comes back."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    entered, left = threading.Barrier(2), threading.Event()
    seen = []

    def first():
        with float32_exact():
            entered.wait()
        left.set()

    def second():
        with float32_exact():
            entered.wait()
            left.wait()
            seen.append(torch.backends.cudnn.allow_tf32)

    try:
        ts = [threading.Thread(target=f) for f in (first, second)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert seen == [False]
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------------------ draws
def test_row_shard_draws_cut_the_global_draw():
    """Inside a row shard a rank's dropout mask, quantizer-dropout rows and
    residual mask are its rows of the one-process draw of the whole batch."""
    x = torch.ones(4, 5, 3)
    full = dropout(x, 0.3, True, torch.Generator().manual_seed(5))
    for offset in (0, 2):
        with mesh.row_shard(4, offset, 2):
            part = dropout(x[:2], 0.3, True, torch.Generator().manual_seed(5))
        torch.testing.assert_close(part, full[offset: offset + 2], rtol=0, atol=0)
    with mesh.row_shard(4, 0, 2), pytest.raises(ValueError, match="row shard"):
        dropout(x, 0.3, True, torch.Generator().manual_seed(5))

    rvq = init_random_(ResidualVectorQuantize(input_dim=8, n_codebooks=3, codebook_size=16,
                                              codebook_dim=4, quantizer_dropout=0.5),
                       torch.Generator().manual_seed(0))
    z = torch.randn(4, 6, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = rvq.forward_train(z, torch.Generator().manual_seed(2))
        for offset in (0, 2):
            with mesh.row_shard(4, offset, 2):
                got = rvq.forward_train(z[offset: offset + 2], torch.Generator().manual_seed(2))
            torch.testing.assert_close(got[0], want[0][offset: offset + 2], rtol=1e-6, atol=1e-6)


def test_rank_rows_and_world_helpers(monkeypatch):
    assert mesh.rank_rows(8, 1, 4) == slice(2, 4)
    with pytest.raises(ValueError, match="does not split"):
        mesh.rank_rows(6, 0, 4)
    assert mesh.data_world() == (0, 1) and mesh.local_world() == (0, 1)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.init_distributed("cpu") is False  # one plain process: a no-op
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        mesh.init_distributed("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda:3"):
        mesh.rank_device("cuda")
    assert mesh.rank_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("gpus,launched,want", [(8, False, 4), (3, False, 1), (2, False, 2),
                                                (8, True, 1), (0, False, 1)])
def test_train_command_starts_one_rank_per_gpu(monkeypatch, gpus, launched, want):
    """`train` starts gcd(batch_size, visible GPUs) ranks; none of its own
    under torchrun or without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: gpus > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    if launched:
        monkeypatch.setenv("WORLD_SIZE", "8")
    else:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert train_cli.n_ranks(None, "cuda") == want
    assert train_cli.n_ranks(None, "cpu") == 1


def test_tensor_parallel_still_raises(tmp_path):
    """Named for the refusal it held before tensor parallelism was ported:
    what still raises is a layout that the ranks cannot form (one plain
    process and a model axis of 2). Two spawned gloo ranks at data 1 x
    model 2 train the fused codec step as one process does
    (tests/test_torch_tp.py `check_tp_step`)."""
    with pytest.raises(ValueError, match="not divisible by a model axis of 2"):
        loop.run_training(fields=CODEC_FIELDS, device="cpu", log_dir=str(tmp_path / "one"),
                          max_steps=1, tensor_parallel=2)
    check_tp_step(tmp_path, split=False)


# ------------------------------------------------------------ spawned ranks
def _spawn(args, world=2):
    env = {"OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    return ranks.spawn_ranks(world, args, timeout=SPAWN_TIMEOUT, env=env)


TOY = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    from facodec_tpu_torch.parallel import mesh
    assert mesh.init_distributed("cpu")
    rank, world = mesh.data_world()
    rows = mesh.rank_rows(8, rank, world)
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((8, 3)))
    y = torch.from_numpy(rng.standard_normal(8))
    w = torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64, requires_grad=True)
    b = torch.tensor(0.25, dtype=torch.float64, requires_grad=True)
    loss = torch.mean((X[rows] @ w + b - y[rows]) ** 2)
    grads = mesh.reduce_gradients([w, b], torch.autograd.grad(loss, [w, b]))
    # many small buckets, and a None gradient as zeros
    many = [torch.full((5,), float(rank + i)) for i in range(7)]
    mesh.BUCKET_BYTES = 24
    mesh.all_reduce_mean_(many)
    none = mesh.reduce_gradients([w], [None])
    sent = torch.arange(4.0) + 10 * rank
    mesh.broadcast_([sent])
    gm = mesh.global_mean(torch.tensor(float(rank), requires_grad=True))
    print(json.dumps(dict(rank=rank, rows=[rows.start, rows.stop],
                          g=[grads[0].tolist(), float(grads[1])],
                          many=[t.tolist() for t in many], none=none[0].tolist(),
                          sent=sent.tolist(), gm=float(gm),
                          calls=mesh.REDUCED.calls)))
""")


def test_two_ranks_toy_gradient_matches_numpy():
    outs = _spawn(["-c", TOY])
    res = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [r["rows"] for r in res] == [[0, 4], [4, 8]]
    rng = np.random.default_rng(0)
    X, y = rng.standard_normal((8, 3)), rng.standard_normal(8)
    resid = X @ np.array([0.5, -1.0, 2.0]) + 0.25 - y
    want_w, want_b = 2 * X.T @ resid / 8, 2 * resid.mean()
    for r in res:
        np.testing.assert_allclose(r["g"][0], want_w, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(r["g"][1], want_b, rtol=1e-12, atol=1e-12)
        assert r["many"] == [[i + 0.5] * 5 for i in range(7)]
        assert r["none"] == [0.0, 0.0, 0.0]
        assert r["sent"] == [0.0, 1.0, 2.0, 3.0]
        assert r["gm"] == 0.5
        # 24-byte buckets: 7 tensors of 20 bytes, one collective each
        assert r["calls"] >= 7 + 2


def test_a_failing_rank_ends_every_rank():
    """A rank that dies before a collective takes the other down with it:
    the spawn raises at once instead of waiting out the group's timeout."""
    code = textwrap.dedent("""
        import sys, torch
        from facodec_tpu_torch.parallel import mesh
        assert mesh.init_distributed("cpu")
        if mesh.data_world()[0] == 1:
            sys.exit(3)
        mesh.all_reduce_mean_([torch.ones(4)])
    """)
    with pytest.raises(RuntimeError, match=r"exit codes \[-?\d+, 3\]"):
        ranks.spawn_ranks(2, ["-c", code], timeout=120, env={"OMP_NUM_THREADS": "1"})


def _pseudo_batch(keys=None):
    """4 PseudoDataset utterances of unequal lengths (1-1.5 s), collated and
    cropped to 8 frames, as the codec loop prepares a batch."""
    ds = PseudoDataset(length=4, seed=0, min_s=1.0, max_s=1.5, n_phones=32, n_speakers=16)
    seg = segment_batch(collate([ds[i] for i in range(4)]), max_frames=8,
                        generator=torch.Generator().manual_seed(0))
    assert len(set(seg["wave_lens"].tolist())) == 4
    return seg if keys is None else {k: seg[k] for k in keys}


def _draws_off_batch():
    return step_golden.make_batch(np.random.default_rng(0), batch=4)


SPECS = [
    dict(kind="codec", fields=CODEC_FIELDS, split=False),
    dict(kind="codec", fields=CODEC_FIELDS, split=True),
    dict(kind="redecoder", fields=dict(RED_FIELDS, encoder=dict(RED_FIELDS["encoder"],
                                                               p_dropout=0.2)), split=False),
    dict(kind="redecoder", fields=dict(RED_FIELDS, encoder=dict(RED_FIELDS["encoder"],
                                                               p_dropout=0.2)), split=True),
    dict(kind="codec", fields=step_golden.FIELDS, split=False, draws=False),
]


@pytest.fixture(scope="module")
def two_rank_steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_steps")
    specs = copy.deepcopy(SPECS)
    for s in specs:
        s["batch"] = (_draws_off_batch() if not s.get("draws", True) else
                      _pseudo_batch(None if s["kind"] == "codec"
                                    else ("wave_seg", "full_waves", "wave_lens")))
    torch.save(specs, out / "spec.pt")
    _spawn([os.path.join(ROOT, "tests", "dp_harness.py"), str(out / "spec.pt"), str(out),
            "--device", "cpu"])
    got = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return specs, got


def _grad_gap(got, want):
    g = [(a, b) for a, b in zip(got, want) if b is not None]
    scale = max(float(b.abs().max()) for _, b in g)
    return max(float((a - b).abs().max()) for a, b in g) / scale


@contextlib.contextmanager
def _one_thread():
    """One intra-op thread, as each spawned rank runs (OMP_NUM_THREADS=1):
    the reference then sums in the ranks' order wherever a rank's rows allow."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _check_against_one_process(spec, rank_results):
    with _one_thread():
        one = dp_harness.run_steps(spec, "cpu")
    r0, r1 = rank_results
    assert (r0["rows"], r1["rows"]) == ([0, 2], [2, 4])
    for mod in one["grads"]:  # the reduced gradients are the same on both ranks
        for a, b in zip(r0["grads"][mod], r1["grads"][mod]):
            assert torch.equal(a, b), mod
        tol = DISC_GRAD if mod == "discriminator" else GEN_GRAD
        gap = _grad_gap(r0["grads"][mod], one["grads"][mod])
        assert gap <= tol, f"{mod}: gradient gap {gap:.2e} of max|g| > {tol}"
    want = one["metrics"][0]
    assert set(r0["metrics"][0]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(r0["metrics"][0][k], v, err_msg=k, **STEP_TOL)
        assert r0["metrics"][0][k] == r1["metrics"][0][k], k
    for k, v in one["params"].items():
        torch.testing.assert_close(r0["params"][k], v, msg=k, **STEP_TOL)
        assert torch.equal(r0["params"][k], r1["params"][k]), k


@pytest.mark.parametrize("index", [0, 1], ids=["fused", "split"])
def test_two_rank_codec_step_matches_one_process(two_rank_steps, index):
    specs, got = two_rank_steps
    _check_against_one_process(specs[index], [got[0][index], got[1][index]])


@pytest.mark.parametrize("index", [2, 3], ids=["fused", "split"])
def test_two_rank_redecoder_step_matches_one_process(two_rank_steps, index):
    specs, got = two_rank_steps
    _check_against_one_process(specs[index], [got[0][index], got[1][index]])


def test_two_rank_draws_off_step_matches_jax_mesh(two_rank_steps):
    """Draws off: the two ranks' reduced gradients and metrics against the
    JAX step (tests/test_torch_train_step.py's closures) on a 2-device data
    mesh, under that file's tolerances, with the gradient's scale taken per
    module rather than per tensor: JAX's mesh step itself differs from its
    one-device step by up to 2.5 times the per-tensor bound in four
    discriminator tensors whose gradients are 1e-4 to 1e-3 of the module's
    largest (9.2e-6 against 3.7e-6 in `convs.2.0.weight_v`)."""
    from facodec_tpu.parallel.mesh import make_mesh, replicate, shard_batch

    specs, got = two_rank_steps
    spec, res = specs[4], got[0][4]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        models = {k: step_golden.J_CLASSES[k](**step_golden.FIELDS[k])
                  for k in step_golden.MODULES}
        seeded = dp_harness.build(dict(spec, kind="codec"), "cpu")[0]
        params = {k: step_golden.jax_tree(seeded[k]) for k in step_golden.MODULES}
        optimizers = step_golden.j_build_optimizers(models.keys(), base_lr=1e-4)
        opt_states = step_golden.init_opt_states(optimizers, params)
        dmesh = make_mesh(n_data=2)
        with dmesh:
            metrics, grads = step_golden._jax_step(models, optimizers)(
                replicate(dmesh, params), replicate(dmesh, opt_states),
                shard_batch(dmesh, {k: jnp.asarray(v) for k, v in spec["batch"].items()}),
                jax.random.PRNGKey(1))
    assert res["rows"] == [0, 2]
    for k, v in metrics.items():
        np.testing.assert_allclose(res["metrics"][0][k], float(v), err_msg=k,
                                   **step_golden.TOL)
    grads = jax.tree.map(np.asarray, grads)
    for mod in step_golden.MODULES:
        want = step_golden.by_path(seeded[mod], grads[mod])
        scale = max(np.abs(w).max() for w in want.values())
        for (name, _), g in zip(seeded[mod].named_parameters(), res["grads"][mod]):
            got = np.zeros_like(want[name]) if g is None else g.numpy()
            err = np.abs(got - want[name]).max()
            assert err <= 1e-3 * scale + 1e-7, f"{mod}.{name}: {err:.3e} (max|g| {scale:.3e})"


def test_train_command_as_two_gloo_ranks(tmp_path):
    """`train --device cpu` with WORLD_SIZE set (as torchrun sets it) runs
    as a gloo rank: two ranks of the tiny config, rank 0 reports and
    writes."""
    outs = _spawn(["-m", "facodec_tpu_torch", "train", "--config-path", TINY, "--device", "cpu",
                   "--max-steps", "1", "--log-dir", str(tmp_path)])
    assert "trained to step 1" in outs[0] and "trained to step" not in outs[1]
    assert loop.latest_checkpoint(str(tmp_path)) is None  # no save before step 1000


RUN = textwrap.dedent("""
    import json, sys
    import torch
    from facodec_tpu_torch.train import loop
    from facodec_tpu_torch.train.data import PseudoDataset
    sys.path.insert(0, sys.argv[1])
    from test_torch_train_loop import FIELDS
    torch.set_num_threads(1)
    ds = PseudoDataset(length=4, seed=0, min_s=1.0, max_s=1.5, n_phones=32, n_speakers=16)
    items = [ds[i] for i in range(4)]  # indexed alike in every run
    saves = []
    real_save = loop.save_checkpoint
    loop.save_checkpoint = lambda *a, **k: saves.append(a[1].step) or real_save(*a, **k)

    def train(log_dir, steps):
        return loop.run_training(fields=FIELDS, dataset=items, max_steps=steps, device="cpu",
                                 log_dir=log_dir, log_writer=None, batch_size=4, max_len=8,
                                 save_interval=1)

    out = sys.argv[2]
    a = train(out + "/a", 2)
    train(out + "/b", 1)
    b = train(out + "/b", 2)
    rank = torch.distributed.get_rank()
    torch.save(dict(a={k + "." + n: p.detach() for k, m in a.models.items()
                       for n, p in m.named_parameters()},
                    b={k + "." + n: p.detach() for k, m in b.models.items()
                       for n, p in m.named_parameters()},
                    gen={k: g.get_state() for k, g in a.generators.items()},
                    steps=(a.step, b.step), saves=saves, metrics=a.metrics),
               out + f"/run{rank}.pt")
""")


def test_two_rank_run_training(tmp_path):
    """Two gloo ranks of `run_training` at batch 4: only rank 0 writes
    checkpoints and TensorBoard, a run resumed from an epoch's checkpoint
    equals the run that goes on, the ranks hold the same parameters and
    generators, and the checkpoint's generators are theirs."""
    _spawn(["-c", RUN, os.path.join(ROOT, "tests"), str(tmp_path)])
    r0, r1 = (torch.load(tmp_path / f"run{r}.pt", weights_only=False) for r in range(2))
    assert r0["steps"] == r1["steps"] == (2, 2)
    assert r0["saves"] and not r1["saves"]
    for k in r0["a"]:
        assert torch.equal(r0["a"][k], r1["a"][k]), k
        assert torch.equal(r0["a"][k], r0["b"][k]), k
    for k, state in r0["gen"].items():
        assert torch.equal(state, r1["gen"][k]), k
    ckpt = torch.load(loop.latest_checkpoint(str(tmp_path / "a")), weights_only=True)
    for k, state in r0["gen"].items():
        assert torch.equal(ckpt["generators"][k], state), k
    assert r0["metrics"] == r1["metrics"]
