"""The port's demo UI handlers (facodec_tpu_torch/webui.py) against the JAX
package's (facodec_tpu/webui.py), on the CPU.

- `_prep_audio` on int16 stereo, uint8, int32 and 16 kHz float input equals
  JAX's within 1e-6 (the resampler's float32 sums in two libraries).
- `do_reconstruct` and `do_convert` on the JAX package's tiny weights
  (tests/tiny_config.yml, seed 0, loaded into the port by key name) equal
  JAX's handlers within 1 LSB of int16: the float32 round trips agree
  within 2e-4 (tests/test_torch_parallel.py), which moves a sample across a
  rounding boundary at most once.
- `build_interface` raises RuntimeError naming gradio where gradio does not
  import, and its wiring holds against the structural stub of
  tests/test_api_cli.py `test_webui_build_interface_wiring`.
"""

import os
import sys
import types

import numpy as np
import pytest

import jax

from facodec_tpu_torch import webui
from facodec_tpu_torch.api import FACodec, FARedecoder
from facodec_tpu_torch.models.builder import build_codec, build_redecoder
from facodec_tpu_torch.utils.config import load_config
from facodec_tpu_torch.utils.weights import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "tiny_config.yml")
SR = 24000


def tone(seconds=0.5, hz=220.0, seed=0):
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(seed)
    return (0.4 * np.sin(2 * np.pi * hz * t) + 0.02 * rng.standard_normal(len(t))
            ).astype(np.float32)


def _inputs():
    w = tone()
    i16 = (w * 32767).astype(np.int16)
    rng = np.random.default_rng(1)
    return {
        "int16 stereo": (SR, np.stack([i16, (i16 // 2).astype(np.int16)], axis=-1)),
        "uint8": (SR, ((w * 0.5 + 0.5) * 255).astype(np.uint8)),
        "int32": (SR, (w * (2**31 - 1)).astype(np.int32)),
        "float 16 kHz": (16000, (0.3 * rng.standard_normal(8000)).astype(np.float32)),
        "float 24 kHz": (SR, w),
    }


@pytest.mark.parametrize("name", list(_inputs()))
def test_prep_audio_equals_jax(name):
    from facodec_tpu.webui import _prep_audio as j_prep

    audio = _inputs()[name]
    got, want = webui._prep_audio(audio), j_prep(audio)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def both():
    """JAX's codec (n_c=2) and redecoder, the port's on the same weights."""
    from facodec_tpu.api import FACodec as JFACodec
    from facodec_tpu.api import FARedecoder as JFARedecoder

    jc = JFACodec.from_config(TINY, n_c=2)
    jr = JFARedecoder.from_config(TINY)
    mp = load_config(TINY).model_params
    port = build_codec(mp)
    for k in ("encoder", "quantizer", "decoder"):
        load_jax_params(port[k], jax.tree.map(np.asarray, jc.params[k]))
    red = build_redecoder(mp)
    for k in ("encoder", "decoder"):
        load_jax_params(red[k], jax.tree.map(np.asarray, jr.params[k]))
    return (jc, jr), (FACodec(port["encoder"], port["quantizer"], port["decoder"], n_c=2),
                      FARedecoder(red["encoder"], red["decoder"]))


def test_handlers_equal_jax(both):
    from facodec_tpu.webui import make_handlers as j_make_handlers

    (jc, jr), (pc, pr) = both
    j_rec, j_conv = j_make_handlers(jc, jr, sr=SR)
    p_rec, p_conv = webui.make_handlers(pc, pr, sr=SR)
    src = (SR, (tone(0.5, 220.0, 1) * 32767).astype(np.int16))
    stereo = (SR, np.stack([src[1], src[1]], axis=-1))
    tgt = (16000, tone(0.4, 330.0, 2)[:6400])
    for got, want in ((p_rec(src), j_rec(src)), (p_rec(stereo), j_rec(stereo)),
                      (p_conv(src, tgt), j_conv(src, tgt))):
        assert got[0] == want[0] == SR
        assert got[1].dtype == np.int16 and got[1].shape == want[1].shape
        gap = np.abs(got[1].astype(np.int32) - np.asarray(want[1]).astype(np.int32)).max()
        assert gap <= 1, gap


def test_build_interface_needs_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)  # import gradio -> ImportError
    with pytest.raises(RuntimeError, match="gradio"):
        webui.build_interface(codec=None)


def test_build_interface_wiring(monkeypatch, both):
    """Against the structural stub (gradio is installed on no host): both
    tabs built, each button wired to its handler with the right arity, and
    the handlers callable through the wiring."""
    clicks = []

    class _Ctx:
        def __init__(self, label=None, **kw):
            self.label = label

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def click(self, fn, inputs=None, outputs=None):
            clicks.append((fn, inputs, outputs))

    stub = types.ModuleType("gradio")
    stub.Blocks = stub.Tab = stub.Audio = stub.Button = _Ctx
    monkeypatch.setitem(sys.modules, "gradio", stub)
    _, (pc, pr) = both
    assert webui.build_interface(pc, pr, sr=SR) is not None
    assert len(clicks) == 2
    (rec_fn, rec_in, rec_out), (cv_fn, cv_in, cv_out) = clicks
    assert not isinstance(rec_in, list) and not isinstance(rec_out, list)
    assert isinstance(cv_in, list) and len(cv_in) == 2 and not isinstance(cv_out, list)
    sr_out, out = rec_fn((SR, (tone() * 32767).astype(np.int16)))
    assert sr_out == SR and out.dtype == np.int16
    clicks.clear()
    assert webui.build_interface(pc, None, sr=SR) is not None and len(clicks) == 1
