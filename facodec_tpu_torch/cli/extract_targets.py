"""Offline teacher targets (port of facodec_tpu/cli/extract_targets.py).

For every wav of a manifest, writes `<wav>.targets.npz`, which
`train/data.FileListDataset` reads:
  f0        (frames,) float32, F0 in Hz from the JDC teacher
            (`models.jdc.JDCNet` on the port's log-mel, weights from the
            reference's `modules/JDC/bst.t7` layout, `--jdc-ckpt`)
  phone_ids (frames,) int32, frame phoneme ids: the argmax of a wav2vec2
            CTC model (`transformers`; the reference's
            `facebook/wav2vec2-xlsr-53-espeak-cv-ft`, or a local
            `save_pretrained` directory)
  spk_label () int32, the argmax of a speaker model's logits (TitaNet
            through NeMo, a `.nemo` file, or a TorchScript file mapping a
            16 kHz wave (1, T) to (1, n_speakers) logits), or the manifest's
            sid column where that teacher is allowed to be missing

The teachers run on `--device` (the card unless `--device cpu`).
`transformers` and `nemo` are imported only when their teacher is asked
for. A requested teacher that is unavailable (no JDC file, a model that
does not load) stops the run with exit 2 before any file is written, unless
`--allow-missing` names it: then F0 and phones are zeros and the speaker is
the manifest's sid. A JDC file that exists but does not load raises.

    python -m facodec_tpu_torch.cli.extract_targets --manifest data/train.txt
        [--root ./data] [--jdc-ckpt modules/JDC/bst.t7]
        [--teachers jdc,w2v,titanet] [--allow-missing titanet] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

TEACHERS = ("jdc", "w2v", "titanet")


def _to_16k(wave24k: np.ndarray) -> np.ndarray:
    """24 kHz -> 16 kHz by linear interpolation (the JAX CLI's rule)."""
    t16 = np.linspace(0, len(wave24k) / 24000, int(len(wave24k) * 2 / 3), endpoint=False)
    t24 = np.arange(len(wave24k)) / 24000
    return np.interp(t16, t24, wave24k).astype(np.float32)


def _jdc_fn(jdc_ckpt: str, device: str):
    """mel (frames, 80) -> F0 (frames,) through the JDC teacher on
    `device`; None where the file does not exist."""
    if not jdc_ckpt or not os.path.exists(jdc_ckpt):
        return None
    from facodec_tpu_torch.models.jdc import load_jdc_checkpoint

    teacher = load_jdc_checkpoint(jdc_ckpt, device)

    def run(mel: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            f0, _ = teacher(torch.from_numpy(np.ascontiguousarray(mel))[None].to(device))
        return f0[0].cpu().numpy()

    return run


def _w2v_fn(name: str, device: str):
    """Frame-phoneme teacher: wav2vec2 CTC argmax on the 16 kHz wave,
    nearest-interpolated to the mel frames; None where it does not load."""
    try:
        from transformers import Wav2Vec2ForCTC, Wav2Vec2Processor

        name = name or "facebook/wav2vec2-xlsr-53-espeak-cv-ft"
        processor = Wav2Vec2Processor.from_pretrained(name)
        model = Wav2Vec2ForCTC.from_pretrained(name).eval()
    except Exception as e:  # the teacher is unavailable: the gate in main decides
        print(f"[extract_targets] w2v teacher unavailable ({type(e).__name__}); "
              "phone_ids will be zeros")
        return None
    model = model.to(device)

    def run(wave24k: np.ndarray, frames: int) -> np.ndarray:
        inputs = processor(_to_16k(wave24k), sampling_rate=16000, return_tensors="pt")
        with torch.no_grad():
            logits = model(inputs.input_values.to(device)).logits
        ids = logits.argmax(-1)[0].cpu().numpy()  # (w2v frames,)
        idx = np.clip((np.arange(frames) * len(ids) / frames).astype(int), 0, len(ids) - 1)
        return ids[idx].astype(np.int32)

    return run


def _titanet_fn(model_path: str, device: str):
    """Speaker teacher: the argmax of 20000-way speaker logits on the 16 kHz
    wave. `model_path` "" is NeMo's pretrained TitaNet, a `.nemo` file is
    restored by NeMo, any other file is a TorchScript module (wave (1, T) ->
    logits (1, n_speakers)); None where it does not load."""
    try:
        if model_path and os.path.isfile(model_path) and not model_path.endswith(".nemo"):
            scripted = torch.jit.load(model_path, map_location=device).eval()

            def infer(w16: torch.Tensor) -> torch.Tensor:
                with torch.no_grad():
                    return scripted(w16[None])
        else:
            import nemo.collections.asr as nemo_asr  # type: ignore

            cls, where = nemo_asr.models.EncDecSpeakerLabelModel, torch.device(device)
            model = (cls.restore_from(model_path, map_location=where) if model_path else
                     cls.from_pretrained("nvidia/speakerverification_en_titanet_large",
                                         map_location=where)).eval()

            def infer(w16: torch.Tensor) -> torch.Tensor:
                _, logits = model.infer_segment(w16)
                return logits
    except Exception as e:  # the teacher is unavailable: the gate in main decides
        print(f"[extract_targets] TitaNet teacher unavailable ({type(e).__name__}); "
              "spk_label falls back to the manifest sid")
        return None

    def run(wave24k: np.ndarray) -> int:
        w16 = torch.from_numpy(_to_16k(wave24k)).to(device)
        return int(torch.as_tensor(infer(w16)).reshape(-1).argmax())

    return run


def main(argv=None) -> int:
    from facodec_tpu_torch.cli import add_device_arg
    from facodec_tpu_torch.train.data import compute_mel
    from facodec_tpu_torch.train.loop import check_device
    from facodec_tpu_torch.utils.audio import load_wav

    p = argparse.ArgumentParser(prog="facodec_tpu_torch.cli.extract_targets")
    p.add_argument("--manifest", type=str, required=True)
    p.add_argument("--root", type=str, default="")
    p.add_argument("--jdc-ckpt", type=str, default=os.environ.get("FACODEC_JDC_CKPT", ""))
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--teachers", type=str, default="jdc,w2v,titanet",
                   help="comma list of teachers to run (subset of jdc,w2v,titanet)")
    p.add_argument("--w2v-model", type=str, default=os.environ.get("FACODEC_W2V_MODEL", ""),
                   help="wav2vec2 CTC model: HF hub id or local save_pretrained directory "
                        "(default: facebook/wav2vec2-xlsr-53-espeak-cv-ft)")
    p.add_argument("--titanet-model", type=str,
                   default=os.environ.get("FACODEC_TITANET_MODEL", ""),
                   help="speaker teacher: empty = NeMo pretrained TitaNet, a .nemo "
                        "checkpoint, or a TorchScript file (wave16k (1,T) -> (1, n_spk) logits)")
    p.add_argument("--allow-missing", type=str, default="",
                   help="teachers allowed to be unavailable: jdc/w2v fill zeros, titanet "
                        "falls back to the manifest sid; without it an unavailable teacher "
                        "exits 2")
    add_device_arg(p)
    args = p.parse_args(argv)

    requested = [t.strip() for t in args.teachers.split(",") if t.strip()]
    allow_missing = {t.strip() for t in args.allow_missing.split(",") if t.strip()}
    for t in list(requested) + sorted(allow_missing):
        if t not in TEACHERS:
            p.error(f"unknown teacher {t!r}; valid: {', '.join(TEACHERS)}")
    check_device("extract_targets", args.device)

    jdc = _jdc_fn(args.jdc_ckpt, args.device) if "jdc" in requested else None
    w2v = _w2v_fn(args.w2v_model, args.device) if "w2v" in requested else None
    titanet = _titanet_fn(args.titanet_model, args.device) if "titanet" in requested else None

    missing = [name for name, fn in (("jdc", jdc), ("w2v", w2v), ("titanet", titanet))
               if name in requested and fn is None]
    fatal = [t for t in missing if t not in allow_missing]
    if fatal:
        print(f"[extract_targets] ERROR: requested teacher(s) unavailable: "
              f"{', '.join(fatal)}. Install the dependency/weights, drop them from --teachers, "
              f"or pass --allow-missing {','.join(fatal)} to accept degraded targets.")
        return 2
    for t in missing:
        fallback = "manifest sid" if t == "titanet" else "zeros"
        print(f"[extract_targets] WARNING: {t} unavailable (allowed); falling back to {fallback}")

    n = 0
    with open(args.manifest) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if not parts or not parts[0]:
                continue
            path = os.path.join(args.root, parts[0]) if args.root else parts[0]
            out = path + ".targets.npz"
            if os.path.exists(out) and not args.overwrite:
                continue
            wave = load_wav(path)
            frames = len(wave) // 300
            wave = wave[: frames * 300]
            f0 = jdc(compute_mel(wave)) if jdc else np.zeros(frames, np.float32)
            phones = w2v(wave, frames) if w2v else np.zeros(frames, np.int32)
            sid = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else 0
            spk = titanet(wave) if titanet else sid % 20000
            np.savez(out, f0=f0.astype(np.float32), phone_ids=phones.astype(np.int32),
                     spk_label=np.int32(spk))
            n += 1
    print(f"[extract_targets] wrote {n} target files")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
