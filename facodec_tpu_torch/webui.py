"""The demo UI's handlers (port of facodec_tpu/webui.py): two tabs, codec
reconstruction and zero-shot voice conversion.

`make_handlers` gives the two tab callbacks without gradio, so they run and
are tested where gradio is not installed; `build_interface` wires them into
a gradio `Blocks` and raises `RuntimeError` naming gradio where it cannot
import it. The same work runs headless through `python -m facodec_tpu_torch
reconstruct|convert`.

    python -m facodec_tpu_torch.webui [--codec-ckpt ...] [--codec-config ...]
        [--redecoder-ckpt ...] [--redecoder-config ...] [--port 7860]
        [--device cuda|cpu]

The models build as the CLIs build them (`facodec_tpu_torch.config`'s
published fields with seeded or checkpoint weights, or a config file) on
`--device`, the card unless the CPU is asked for; the codec decodes both
content codebooks (the JAX UI's default), and voice conversion reads the
first, as `convert_voice` does.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

SR = 24000


def _prep_audio(audio, sr: int = SR) -> np.ndarray:
    """Gradio's (sample_rate, array) -> mono float32 in [-1, 1] at `sr`.

    Integer PCM is detected before any float cast (gradio delivers int16,
    24- and 32-bit files arrive as int32, a microphone may give uint8) and
    scaled by its own dtype's range, unsigned types re-centred; a stereo
    input is averaged to mono; another rate is resampled with the
    julius-exact fractional resampler (ops/resample.py)."""
    in_sr, w = audio
    w = np.asarray(w)
    if w.dtype.kind == "u":
        info = np.iinfo(w.dtype)
        w = (w.astype(np.float32) - (info.max + 1) / 2.0) / ((info.max + 1) / 2.0)
    elif w.dtype.kind == "i":
        w = w.astype(np.float32) / (np.iinfo(w.dtype).max + 1.0)
    w = np.asarray(w, np.float32)
    if w.ndim > 1:
        w = w.mean(axis=-1)
    if in_sr and int(in_sr) != sr:
        from facodec_tpu_torch.ops.resample import resample_frac

        with torch.no_grad():
            w = resample_frac(torch.from_numpy(w)[None], int(in_sr), sr)[0].numpy()
        w = np.asarray(w, np.float32)
    return w


def _to_pcm16(wave: np.ndarray) -> np.ndarray:
    return (np.clip(wave, -1, 1) * 32767).astype(np.int16)


def make_handlers(codec, redecoder=None, sr: int = SR):
    """(do_reconstruct, do_convert): gradio audio in, (sr, int16 mono) out."""

    def do_reconstruct(audio):
        return sr, _to_pcm16(codec.reconstruct(_prep_audio(audio, sr))[0])

    def do_convert(source, target):
        from facodec_tpu_torch.api import convert_voice

        out = convert_voice(codec, redecoder, _prep_audio(source, sr), _prep_audio(target, sr))
        return sr, _to_pcm16(out[0])

    return do_reconstruct, do_convert


def build_interface(codec, redecoder=None, sr: int = SR):
    """The gradio `Blocks` of the two tabs (the conversion tab where a
    redecoder is given). Raises RuntimeError where gradio is not installed."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError("gradio is not installed; use the CLI instead: "
                           "python -m facodec_tpu_torch reconstruct|convert") from e

    do_reconstruct, do_convert = make_handlers(codec, redecoder, sr)
    with gr.Blocks(title="FAcodec") as demo:
        with gr.Tab("Reconstruction"):
            inp = gr.Audio(label="Input")
            btn = gr.Button("Reconstruct")
            out = gr.Audio(label="Reconstructed")
            btn.click(do_reconstruct, inputs=inp, outputs=out)
        if redecoder is not None:
            with gr.Tab("Voice Conversion"):
                src = gr.Audio(label="Source (content)")
                tgt = gr.Audio(label="Target (timbre)")
                vbtn = gr.Button("Convert")
                vout = gr.Audio(label="Converted")
                vbtn.click(do_convert, inputs=[src, tgt], outputs=vout)
    return demo


def main(argv=None):
    from facodec_tpu_torch.cli import add_device_arg, load_codec, load_redecoder

    p = argparse.ArgumentParser(prog="python -m facodec_tpu_torch.webui")
    p.add_argument("--codec-ckpt", type=str, default=None)
    p.add_argument("--codec-config", type=str, default=None)
    p.add_argument("--redecoder-ckpt", type=str, default=None)
    p.add_argument("--redecoder-config", type=str, default=None)
    p.add_argument("--port", type=int, default=7860)
    add_device_arg(p)
    args = p.parse_args(argv)
    codec = load_codec(args.codec_config, args.codec_ckpt, 2, args.device)
    red = None
    if args.redecoder_ckpt or args.redecoder_config:
        red = load_redecoder(args.redecoder_config, args.redecoder_ckpt, args.device)
    build_interface(codec, red).launch(server_port=args.port)


if __name__ == "__main__":
    main()
