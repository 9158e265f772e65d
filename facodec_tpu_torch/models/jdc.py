"""JDCNet pitch estimator, the F0 teacher of codec training (port of
facodec_tpu/models/jdc.py).

The reference's `JDCNet(num_class=1)` (Kum et al. 2019 CRNN) maps
normalised log-mels (B, T, 80) to per-frame F0 in Hz. It is a teacher only:
every BatchNorm runs with the checkpoint's running statistics whatever
`.train()` says (`BatchNorm2dInference`), and the pool block's dropout,
which the reference applies only in training, is left out, so the output
does not depend on the mode. The reference's detector branch
(`detector_conv`, `bilstm_detector`, `detector`), which its F0 output does
not use, is not built; `load_jdc_checkpoint` drops its keys.

Layout: NCHW with H = T and W = the 80 mel bins, as the reference's
(B, 1, T, 80) input after its transpose. After the pool block the
(B, 256, T, 2) map becomes (B, T, 512) features in torch's order
[c0w0, c0w1, c1w0, ...]; a bidirectional `nn.LSTM` (cuDNN on the card,
unpacked, so its reverse direction reads the whole sequence reversed, as
the JAX scan does) and a linear layer give F0 = |out|. Modules carry the
reference state dict's names, so its file loads by key. The forward runs
with TF32 off (`api.float32_exact`). Under a bf16 policy (the inline
teacher of a `bfloat16` or `bfloat16_act` training step) the LSTM and the
classifier take bf16-rounded operands, as the JAX package's policy
`matmul`s do (the LSTM every rounding but h's at each step, as `nn.lstm`
`SLSTM`); its convolutions are plain `lax.conv`s there, float32 here too.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from facodec_tpu_torch.api import float32_exact
from facodec_tpu_torch.nn.basic import linear
from facodec_tpu_torch.ops.precision import bf16_values, compute_dtype

LEAK = 0.01
UNUSED_PREFIXES = ("detector_conv", "bilstm_detector", "detector", "maxpool")


class BatchNorm2dInference(nn.Module):
    """Frozen BatchNorm over NCHW channels: (x - running_mean) /
    sqrt(running_var + eps) * weight + bias, in every mode."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        c = (-1, 1, 1)
        return (x - self.running_mean.view(c)) * inv.view(c) * self.weight.view(c) \
            + self.bias.view(c)


def conv2d_no_bias(in_channels: int, out_channels: int, kernel_size: int = 3) -> nn.Conv2d:
    """3x3 (padding 1) or 1x1 convolution without a bias."""
    return nn.Conv2d(in_channels, out_channels, kernel_size, padding=kernel_size // 2,
                     bias=False)


class ResBlockJDC(nn.Module):
    """BN -> LReLU -> MaxPool (1, 2) -> [conv-BN-LReLU-conv] + skip, the
    skip a 1x1 convolution where the widths differ."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.pre_conv = nn.Sequential(BatchNorm2dInference(in_channels), nn.LeakyReLU(LEAK),
                                      nn.MaxPool2d((1, 2)))
        self.conv = nn.Sequential(conv2d_no_bias(in_channels, out_channels),
                                  BatchNorm2dInference(out_channels), nn.LeakyReLU(LEAK),
                                  conv2d_no_bias(out_channels, out_channels))
        self.conv1by1 = (conv2d_no_bias(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pre_conv(x)
        skip = x if self.conv1by1 is None else self.conv1by1(x)
        return self.conv(x) + skip


class JDCNet(nn.Module):
    """mel (B, T, 80) -> (F0 (B, T) in Hz, features (B, T, 512))."""

    def __init__(self, num_class: int = 1):
        super().__init__()
        self.num_class = num_class
        self.conv_block = nn.Sequential(conv2d_no_bias(1, 64), BatchNorm2dInference(64),
                                        nn.LeakyReLU(LEAK), conv2d_no_bias(64, 64))
        self.res_block1 = ResBlockJDC(64, 128)
        self.res_block2 = ResBlockJDC(128, 192)
        self.res_block3 = ResBlockJDC(192, 256)
        self.pool_block = nn.Sequential(BatchNorm2dInference(256), nn.LeakyReLU(LEAK),
                                        nn.MaxPool2d((1, 4)))
        self.bilstm_classifier = nn.LSTM(512, 256, batch_first=True, bidirectional=True)
        self.classifier = nn.Linear(512, num_class)

    def forward(self, mel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, T, _ = mel.shape
        with float32_exact():
            x = self.conv_block(mel[:, None])
            x = self.res_block3(self.res_block2(self.res_block1(x)))
            x = self.pool_block(x)  # (B, 256, T, 2)
            feat = x.permute(0, 2, 1, 3).reshape(B, T, 512)
            if compute_dtype() == torch.bfloat16:
                rounded = {name: bf16_values(p) if name.startswith("weight") else p
                           for name, p in self.bilstm_classifier.named_parameters()}
                y, _ = torch.func.functional_call(self.bilstm_classifier, rounded,
                                                  (bf16_values(feat),))
            else:
                y, _ = self.bilstm_classifier(feat)
            out = linear(y, self.classifier.weight, self.classifier.bias)
        return torch.abs(out[..., 0] if self.num_class == 1 else out), feat


def reference_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The keys of a reference JDCNet state dict that `JDCNet` holds: the
    detector branch, the pools and BatchNorm's `num_batches_tracked`
    counters dropped, a DDP `module.` prefix removed."""
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k.startswith(UNUSED_PREFIXES) or k.endswith("num_batches_tracked"):
            continue
        out[k] = v
    return out


def load_jdc_checkpoint(path: str, device: str = "cuda") -> JDCNet:
    """The teacher from the reference's `modules/JDC/bst.t7` layout
    ({'net': state_dict} or a bare state dict), in eval mode, frozen, on
    `device`. Raises on a key missing from the file or left over in it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["net"] if isinstance(ckpt.get("net"), dict) else ckpt
    model = JDCNet(num_class=1)
    model.load_state_dict(reference_keys(sd), strict=True)
    return model.requires_grad_(False).eval().to(device)


@torch.no_grad()
def random_reference_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A seeded random JDCNet state dict in the reference's full layout:
    the F0 branch's keys, the detector branch's and every BatchNorm's
    `num_batches_tracked`. Convolutions, the LSTMs and the linear layers
    are U(-1/sqrt(fan_in), +); the BatchNorms' weights U(0.5, 1.5), biases
    and running means N(0, 0.1), running variances U(0.5, 1.5); the
    classifier's bias is 150 Hz and its weight U(-32, 32), so F0 moves by
    tens of Hz from frame to frame and stays well inside the voiced range
    (> 5 Hz), as the teacher's F0 does on voiced speech. For tests and
    smoke runs: no real checkpoint is at hand."""
    gen = torch.Generator().manual_seed(seed)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo

    model = JDCNet(num_class=1)
    sd = {}
    for k, v in model.state_dict().items():
        leaf = k.rsplit(".", 1)[-1]
        bn = isinstance(model.get_submodule(k.rsplit(".", 1)[0]), BatchNorm2dInference)
        if k == "classifier.bias":
            sd[k] = torch.full(v.shape, 150.0)
        elif k == "classifier.weight":
            sd[k] = uniform(v.shape, -32.0, 32.0)
        elif bn and leaf in ("weight", "running_var"):
            sd[k] = uniform(v.shape, 0.5, 1.5)
        elif bn:
            sd[k] = torch.randn(v.shape, generator=gen) * 0.1
        else:
            fan_in = 256 if k.startswith("bilstm") else v[0].numel() if v.dim() > 1 else 512
            sd[k] = uniform(v.shape, -fan_in ** -0.5, fan_in ** -0.5)
        if bn and leaf == "running_var":
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(1000)
    # the detector branch the reference also saves (dropped at load)
    sd["detector_conv.0.weight"] = uniform((256, 640, 1, 1), -640 ** -0.5, 640 ** -0.5)
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        sd[f"detector_conv.1.{leaf}"] = uniform((256,), 0.5, 1.5)
    sd["detector_conv.1.num_batches_tracked"] = torch.tensor(1000)
    for d in ("", "_reverse"):
        for leaf, shape in (("weight_ih_l0", (1024, 512)), ("weight_hh_l0", (1024, 256)),
                            ("bias_ih_l0", (1024,)), ("bias_hh_l0", (1024,))):
            sd[f"bilstm_detector.{leaf}{d}"] = uniform(shape, -1 / 16, 1 / 16)
    sd["detector.weight"] = uniform((2, 512), -512 ** -0.5, 512 ** -0.5)
    sd["detector.bias"] = uniform((2,), -512 ** -0.5, 512 ** -0.5)
    return sd
