"""The codec's training losses (port of facodec_tpu/losses)."""

from facodec_tpu_torch.losses.gan import discriminator_loss, generator_adv_losses  # noqa: F401
from facodec_tpu_torch.losses.spectral import (  # noqa: F401
    l1_loss, mel_spectrogram_loss, multi_scale_stft_loss, sisdr_loss,
)
from facodec_tpu_torch.losses.supervision import (  # noqa: F401
    cross_entropy, focal_loss, log_norm, smooth_l1_loss,
)
