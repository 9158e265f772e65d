"""GAN discriminator ensemble: multi-period (MPD), multi-scale waveform
(MSD) and multi-resolution complex-spectrogram (MRD) discriminators.

Port of facodec_tpu/models/discriminator.py. Input waves (B, T, 1), as in
the JAX package; the 2-D activations, and so the MPD and MRD feature maps
returned, are NCHW (the JAX package's are NHWC): MPD folds the wave to
(B, 1, T / p, p), MRD stacks the real and imaginary STFT as (B, 2, frames,
bins). The MSD's maps are NTC, as the JAX package's are. Keys follow the
JAX names (`discriminators.0.convs.0.0.weight_v` is ('discriminators_0',
'convs_0_0', 'weight_v')); the ensemble indexes the MPDs, then the MSDs,
then the MRDs, so an MSD shifts every MRD's key, as in the JAX package.

The MRD front end reproduces audiotools' `match_stride` STFT: reflect-pad
by ((w - hop) / 2, (w - hop) / 2 + right_pad), a centred STFT, and two
frames dropped at each end.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from facodec_tpu_torch.nn.conv import Conv1d, Conv2d
from facodec_tpu_torch.ops.resample import resample_frac
from facodec_tpu_torch.ops.spectral import hann_window

BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))


def _leaky(x: torch.Tensor) -> torch.Tensor:
    """leaky_relu(x, 0.1); on a bf16 x (`bfloat16_act`) the slope is the bf16
    0.1 and the product rounds to bf16, as JAX's `where(x >= 0, x, 0.1 * x)`
    with a weakly typed 0.1 computes it (torch's leaky_relu multiplies by the
    float32 0.1)."""
    if x.dtype == torch.bfloat16:
        return torch.where(x >= 0, x, x * torch.tensor(0.1, dtype=x.dtype))
    return F.leaky_relu(x, 0.1)


def _wn_conv(*args, **kwargs) -> nn.ModuleList:
    """One weight-norm Conv2d at index 0 of a list (the reference's
    `Sequential(conv, act)` level)."""
    return nn.ModuleList([Conv2d(*args, weight_norm=True, **kwargs)])


class MPD(nn.Module):
    """Period discriminator: the wave folded into (T / p, p), 2-D convs."""

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        chans = [(1, 32), (32, 128), (128, 512), (512, 1024)]
        convs = [_wn_conv(ci, co, (5, 1), stride=(3, 1), padding=(2, 0)) for ci, co in chans]
        convs.append(_wn_conv(1024, 1024, (5, 1), stride=(1, 1), padding=(2, 0)))
        self.convs = nn.ModuleList(convs)
        self.conv_post = Conv2d(1024, 1, (3, 1), padding=(1, 0), weight_norm=True)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        B, T, _ = x.shape
        pad = self.period - T % self.period
        x = F.pad(x.transpose(1, 2), (0, pad), mode="reflect")
        x = x.reshape(B, 1, -1, self.period)
        fmap = []
        for conv in self.convs:
            x = _leaky(conv[0](x))
            fmap.append(x)
        fmap.append(self.conv_post(x))
        return fmap


class MRD(nn.Module):
    """Complex multi-band spectrogram discriminator."""

    def __init__(self, window_length: int, hop_factor: float = 0.25,
                 sample_rate: int = 44100, bands: Sequence[Tuple[float, float]] = BANDS):
        super().__init__()
        self.window_length, self.hop_factor, self.bands = window_length, hop_factor, tuple(bands)
        ch = 32
        shapes = [(2, ch, (1, 1)), (ch, ch, (1, 2)), (ch, ch, (1, 2)), (ch, ch, (1, 2))]
        self.band_convs = nn.ModuleList([
            nn.ModuleList([_wn_conv(ci, co, (3, 9), stride=s, padding=(1, 4))
                           for ci, co, s in shapes] + [_wn_conv(ch, ch, (3, 3), padding=(1, 1))])
            for _ in self.bands
        ])
        self.conv_post = Conv2d(ch, 1, (3, 3), padding=(1, 1), weight_norm=True)

    def spectrogram(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, T, 1) -> one (B, 2, frames, band bins) real/imag stack per band."""
        w = self.window_length
        hop = int(w * self.hop_factor)
        T = x.shape[1]
        right_pad = math.ceil(T / hop) * hop - T
        pad = (w - hop) // 2
        wave = F.pad(x.transpose(1, 2), (pad, pad + right_pad), mode="reflect")[:, 0]
        z = torch.stft(wave, w, hop_length=hop, win_length=w,
                       window=hann_window(w, x.device, x.dtype), center=True, pad_mode="reflect",
                       normalized=False, onesided=True, return_complex=True)
        z = z[:, :, 2:-2]  # match_stride drops 2 frames at each end
        spec = torch.view_as_real(z).permute(0, 3, 2, 1)  # (B, 2, frames, bins)
        n_bins = w // 2 + 1
        return [spec[..., int(lo * n_bins): int(hi * n_bins)] for lo, hi in self.bands]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        fmap, outs = [], []
        for band, convs in zip(self.spectrogram(x), self.band_convs):
            h = band
            for conv in convs:
                h = _leaky(conv[0](h))
                fmap.append(h)
            outs.append(h)
        h = self.conv_post(torch.cat(outs, dim=-1))  # along frequency
        fmap.append(h)
        return fmap


class MSD(nn.Module):
    """Multi-scale waveform discriminator: six grouped, strided weight-norm
    convs and `conv_post` on the wave, downsampled by `rate` first through
    the julius resampler (ops/resample.py) where rate > 1."""

    SPECS = ((1, 16, 15, 1, 1, 7), (16, 64, 41, 4, 4, 20), (64, 256, 41, 4, 16, 20),
             (256, 1024, 41, 4, 64, 20), (1024, 1024, 41, 4, 256, 20), (1024, 1024, 5, 1, 1, 2))

    def __init__(self, rate: int = 1, sample_rate: int = 44100):
        super().__init__()
        self.rate, self.sample_rate = rate, sample_rate
        self.convs = nn.ModuleList([
            nn.ModuleList([Conv1d(ci, co, k, stride=s, groups=g, padding=p, weight_norm=True)])
            for ci, co, k, s, g, p in self.SPECS])
        self.conv_post = Conv1d(1024, 1, 3, padding=1, weight_norm=True)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self.rate > 1:
            x = resample_frac(x[:, :, 0], self.sample_rate,
                              self.sample_rate // self.rate)[:, :, None]
        fmap = []
        for conv in self.convs:
            x = _leaky(conv[0](x))
            fmap.append(x)
        fmap.append(self.conv_post(x))
        return fmap


class Discriminator(nn.Module):
    """The ensemble: MPDs, then MSDs, then MRDs on the preprocessed wave
    (B, T, 1); returns one list of feature maps per discriminator, the score
    last."""

    def __init__(self, rates: Sequence[int] = (), periods: Sequence[int] = (2, 3, 5, 7, 11),
                 fft_sizes: Sequence[int] = (2048, 1024, 512), sample_rate: int = 44100,
                 bands: Sequence[Tuple[float, float]] = BANDS):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [MPD(p) for p in periods]
            + [MSD(r, sample_rate=sample_rate) for r in rates]
            + [MRD(f, sample_rate=sample_rate, bands=bands) for f in fft_sizes])

    @staticmethod
    def preprocess(y: torch.Tensor) -> torch.Tensor:
        """Remove the DC offset and peak-normalise each wave to 0.8."""
        y = y - torch.mean(y, dim=1, keepdim=True)
        peak = torch.amax(torch.abs(y), dim=1, keepdim=True)
        return 0.8 * y / (peak + 1e-9)

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        x = self.preprocess(x)
        return [d(x) for d in self.discriminators]
