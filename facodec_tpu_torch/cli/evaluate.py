"""Objective evaluation over a manifest of wavs (port of
facodec_tpu/cli/evaluate.py).

Per utterance, and averaged over the manifest (NaN-skipping means):
  mel_l1        7-scale mel-spectrogram L1 (the training objective)
  stft_l1       multi-scale log-STFT L1
  snr_db        waveform SNR of the reconstruction
  si_sdr_db     scale-invariant SDR (ops/metrics.py)
  stoi          short-time objective intelligibility [0..1]
  mcd_db        mel-cepstral distortion (frame-aligned, 13 cepstra)
  code_usage    fraction of each stream's codebook used (collapse detector)

The disentanglement scorecard (unless --no-probe-disentangle): prosody-only
and content-only decodes are F0-tracked and correlated against the source:
  f0_corr_prosody   should be high (the prosody stream carries the contour)
  f0_corr_content   should be low (the content stream should not)

The codec is `cli.load_codec`'s: `--config-path` (needs pyyaml) or the
flagship fields, the weights of `--ckpt-path` or seeded random ones, on
`--device` (the card unless `--device cpu`). The spectral losses run on the
codec's device with TF32 off; the metrics run in numpy on the host.

    python -m facodec_tpu_torch.cli.evaluate --manifest data/val.txt
        [--root ./data] [--ckpt-path ...] [--config-path ...] [--json out.json]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

AGG_KEYS = ("mel_l1", "stft_l1", "snr_db", "si_sdr_db", "stoi", "mcd_db",
            "f0_corr_prosody", "f0_corr_content")


def evaluate_utterance(codec, wave: np.ndarray, probe_disentangle: bool = True) -> dict:
    """The scorecard of one (T,) 24 kHz wave through `codec` (an
    `api.FACodec`): the round trip's losses and metrics against the wave,
    its code usage and, with `probe_disentangle`, the F0 probes."""
    from facodec_tpu_torch.api import float32_exact
    from facodec_tpu_torch.losses import mel_spectrogram_loss, multi_scale_stft_loss
    from facodec_tpu_torch.ops.metrics import f0_autocorr, f0_correlation, mcd, si_sdr, stoi

    f = codec.encode(wave)
    recon = codec.decode(f)[0]
    ref = wave[: len(recon)]
    recon = recon[: len(ref)]

    x, y = (torch.from_numpy(np.ascontiguousarray(a, np.float32))[None].to(codec.device)
            for a in (recon, ref))
    with torch.no_grad(), float32_exact():
        mel_l1 = float(mel_spectrogram_loss(x, y))
        stft_l1 = float(multi_scale_stft_loss(x, y))
    noise = np.mean((recon - ref) ** 2) + 1e-12
    snr = 10.0 * np.log10(np.mean(ref**2) / noise + 1e-12)
    cbs = float(codec.quantizer.codebook_size)
    usage = {
        "prosody": len(np.unique(f.codes_p)) / cbs,
        "content": len(np.unique(f.codes_c)) / cbs,
        "residual": len(np.unique(f.codes_r)) / cbs if f.codes_r is not None else 0.0,
    }
    out = dict(
        mel_l1=mel_l1, stft_l1=stft_l1, snr_db=float(snr),
        si_sdr_db=si_sdr(recon, ref), stoi=stoi(recon, ref, 24000),
        mcd_db=mcd(recon, ref), code_usage=usage,
    )
    if probe_disentangle:
        f0_src = f0_autocorr(ref)
        p_only = codec.decode_subset(f, True, False, False)[0]
        c_only = codec.decode_subset(f, False, True, False)[0]
        r_p, v_p = f0_correlation(f0_autocorr(p_only), f0_src)
        r_c, v_c = f0_correlation(f0_autocorr(c_only), f0_src)
        out.update(
            f0_corr_prosody=r_p, f0_corr_content=r_c,
            voicing_agree_prosody=v_p, voicing_agree_content=v_c,
        )
    return out


def jsonsafe(o):
    """Non-finite floats as None, so the JSON written is strict (F0
    correlations are NaN where an utterance has no co-voiced frames)."""
    if isinstance(o, float) and not np.isfinite(o):
        return None
    if isinstance(o, dict):
        return {k: jsonsafe(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [jsonsafe(v) for v in o]
    return o


def main(argv=None) -> int:
    from facodec_tpu_torch.cli import add_device_arg, load_codec
    from facodec_tpu_torch.utils.audio import load_wav

    p = argparse.ArgumentParser(prog="facodec_tpu_torch.cli.evaluate")
    p.add_argument("--manifest", type=str, required=True)
    p.add_argument("--root", type=str, default="")
    p.add_argument("--ckpt-path", type=str, default=None)
    p.add_argument("--config-path", type=str, default=None)
    p.add_argument("--n-c", type=int, default=2)
    p.add_argument("--max-utts", type=int, default=None)
    p.add_argument("--no-probe-disentangle", action="store_true")
    p.add_argument("--json", type=str, default=None)
    add_device_arg(p)
    args = p.parse_args(argv)

    codec = load_codec(args.config_path, args.ckpt_path, args.n_c, args.device)

    rows = []
    with open(args.manifest) as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if not parts or not parts[0]:
                continue
            rows.append(os.path.join(args.root, parts[0]) if args.root else parts[0])
    if args.max_utts:
        rows = rows[: args.max_utts]

    results = []
    for path in rows:
        m = evaluate_utterance(codec, load_wav(path),
                               probe_disentangle=not args.no_probe_disentangle)
        m["path"] = path
        results.append(m)
        print(f"{path}: mel_l1={m['mel_l1']:.4f} stft_l1={m['stft_l1']:.4f} "
              f"snr={m['snr_db']:.2f}dB si_sdr={m['si_sdr_db']:.2f}dB "
              f"stoi={m['stoi']:.3f}")

    agg = {k: float(np.nanmean([r[k] for r in results])) for k in AGG_KEYS if k in results[0]}
    print("aggregate:", json.dumps(jsonsafe(agg)))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(jsonsafe(dict(aggregate=agg, utterances=results)), fh, indent=1,
                      allow_nan=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
