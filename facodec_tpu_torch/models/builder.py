"""Model factory for the codec and redecoder stages (port of
facodec_tpu/models/builder.py).

`codec_fields(model_params)` and `redecoder_fields(model_params)` read the
`model_params` mapping of the reference config.yml schema, including the
optional scale-down keys the JAX builder reads (latent_dim, codebook_size,
style_hidden_dim, prosody_hidden_dim), into the fields of each module.
`build_from_fields` and `build_redecoder_from_fields` take those fields
directly, as `config.FLAGSHIP` and `config.FLAGSHIP_REDECODER` hold them.
`train_fields` adds the codec stage's training modules, `fa_predictors` and
`discriminator` (the JAX builder's), and `build_train_from_fields` builds
all five, as `config.FLAGSHIP_TRAIN` holds them.
The redecoder stage's modules are named as in the JAX builder and in its
checkpoints: `encoder` (the Redecoder) and `decoder`.
Redecoder training reads two more: `encoder_stage_fields` (the JAX
`stage="encoder"`, the frozen codec encoder and quantizer, which read
`encoder_causal` and `encoder_lstm`) and `redecoder_train_fields` (the
redecoder stage with its discriminator), built by
`build_encoder_stage_from_fields` and `build_redecoder_train_from_fields`
(`config.FLAGSHIP_REDECODER_TRAIN` holds both, the codec's under `codec`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch.nn as nn

from facodec_tpu_torch.models.dac import Decoder, Encoder
from facodec_tpu_torch.models.discriminator import BANDS, Discriminator
from facodec_tpu_torch.models.fa_quantizer import FApredictors, FAquantizer
from facodec_tpu_torch.models.redecoder import Redecoder


def codec_fields(model_params: Mapping[str, Any], causal_key: str = "causal",
                 lstm_key: str = "lstm") -> Dict[str, Dict[str, Any]]:
    """Reference-schema `model_params` -> the fields of each codec module."""
    mp = model_params
    dac = mp["DAC"]
    D = mp.get("latent_dim", 1024)
    return dict(
        encoder=dict(d_model=dac["encoder_dim"], strides=tuple(dac["encoder_rates"]),
                     d_latent=D, causal=mp[causal_key], lstm=mp[lstm_key]),
        quantizer=dict(
            in_dim=D, n_p_codebooks=1, n_c_codebooks=mp["n_c_codebooks"], n_t_codebooks=2,
            n_r_codebooks=3, codebook_size=mp.get("codebook_size", 1024), codebook_dim=8,
            quantizer_dropout=0.5, causal=mp[causal_key],
            separate_prosody_encoder=mp["separate_prosody_encoder"],
            timbre_norm=mp["timbre_norm"], sample_rate=dac["sr"],
            style_hidden_dim=mp.get("style_hidden_dim", 512),
            prosody_hidden_dim=mp.get("prosody_hidden_dim", 256),
        ),
        decoder=dict(input_channel=D, channels=dac["decoder_dim"],
                     rates=tuple(dac["decoder_rates"]), causal=mp["causal"], lstm=mp["lstm"]),
    )


def build_from_fields(fields: Mapping[str, Mapping[str, Any]]) -> Dict[str, nn.Module]:
    """{encoder, quantizer, decoder} modules, parameters uninitialised."""
    return dict(
        encoder=Encoder(**fields["encoder"]),
        quantizer=FAquantizer(**fields["quantizer"]),
        decoder=Decoder(**fields["decoder"]),
    )


def build_codec(model_params: Mapping[str, Any]) -> Dict[str, nn.Module]:
    return build_from_fields(codec_fields(model_params))


def train_fields(model_params: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """`codec_fields` plus the fields of the codec stage's predictor heads
    and discriminator, as the JAX builder sets them (the residual and
    x-timbre adversaries on; no multi-scale discriminator)."""
    mp = model_params
    fields = codec_fields(mp)
    fields["fa_predictors"] = dict(
        in_dim=mp.get("latent_dim", 1024), use_gr_content_f0=mp["use_gr_content_f0"],
        use_gr_prosody_phone=mp["use_gr_prosody_phone"], use_gr_residual_f0=True,
        use_gr_residual_phone=True, use_gr_timbre_content=True,
        use_gr_timbre_prosody=mp["use_gr_timbre_prosody"], use_gr_x_timbre=True,
        norm_f0=mp["norm_f0"], timbre_norm=mp["timbre_norm"],
        use_gr_content_global_f0=mp["use_gr_content_global_f0"],
        n_phone_classes=mp.get("n_phone_classes", 1024), n_speakers=mp.get("n_speakers", 20000))
    fields["discriminator"] = _discriminator_fields(mp)
    return fields


def _discriminator_fields(mp: Mapping[str, Any]) -> Dict[str, Any]:
    """Both stages' ensemble in the JAX builder: no multi-scale discriminator."""
    return dict(rates=(), periods=(2, 3, 5, 7, 11), fft_sizes=(2048, 1024, 512),
                sample_rate=mp["DAC"]["sr"], bands=BANDS)


def build_train_from_fields(fields: Mapping[str, Mapping[str, Any]]) -> Dict[str, nn.Module]:
    """The codec modules plus `fa_predictors` and `discriminator`."""
    models = build_from_fields(fields)
    models["fa_predictors"] = FApredictors(**fields["fa_predictors"])
    models["discriminator"] = Discriminator(**fields["discriminator"])
    return models


def redecoder_fields(model_params: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Reference-schema `model_params` -> the fields of the redecoder stage."""
    mp = model_params
    dac = mp["DAC"]
    D = mp.get("latent_dim", 1024)
    return dict(
        encoder=dict(n_p_codebooks=mp["n_p_codebooks"], n_c_codebooks=mp["n_c_codebooks"],
                     codebook_size=mp.get("codebook_size", 1024),
                     embed_dim=mp["wavenet_embed_dim"], n_layers=16,
                     causal=mp["decoder_causal"], gin_channels=D, out_dim=D, p_dropout=0.2),
        decoder=dict(input_channel=D, channels=dac["decoder_dim"],
                     rates=tuple(dac["decoder_rates"]), causal=mp["decoder_causal"],
                     lstm=mp["decoder_lstm"]),
    )


def build_redecoder_from_fields(fields: Mapping[str, Mapping[str, Any]]
                                ) -> Dict[str, nn.Module]:
    """{encoder (the Redecoder), decoder} modules, parameters uninitialised."""
    return dict(encoder=Redecoder(**fields["encoder"]), decoder=Decoder(**fields["decoder"]))


def build_redecoder(model_params: Mapping[str, Any]) -> Dict[str, nn.Module]:
    return build_redecoder_from_fields(redecoder_fields(model_params))


def encoder_stage_fields(model_params: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The JAX builder's `stage="encoder"`: the frozen codec encoder and
    quantizer of redecoder training, causal and LSTM from `encoder_causal`
    and `encoder_lstm`."""
    fields = codec_fields(model_params, "encoder_causal", "encoder_lstm")
    return dict(encoder=fields["encoder"], quantizer=fields["quantizer"])


def build_encoder_stage_from_fields(fields: Mapping[str, Mapping[str, Any]]
                                    ) -> Dict[str, nn.Module]:
    """{encoder, quantizer} modules, parameters uninitialised."""
    return dict(encoder=Encoder(**fields["encoder"]),
                quantizer=FAquantizer(**fields["quantizer"]))


def redecoder_train_fields(model_params: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """`redecoder_fields` plus the redecoder stage's discriminator."""
    return dict(redecoder_fields(model_params),
                discriminator=_discriminator_fields(model_params))


def build_redecoder_train_from_fields(fields: Mapping[str, Mapping[str, Any]]
                                      ) -> Dict[str, nn.Module]:
    """{encoder (the Redecoder), decoder, discriminator}, uninitialised."""
    return dict(build_redecoder_from_fields(fields),
                discriminator=Discriminator(**fields["discriminator"]))
