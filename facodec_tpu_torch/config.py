"""Model configurations of the port.

`FLAGSHIP` is the released FAcodec configuration, copied from the JAX
package's driver entry (`__graft_entry__.py` FLAGSHIP): the module fields of
the encoder, the factorized quantizer and the decoder at published widths.

`FLAGSHIP_REDECODER` is the released voice-conversion redecoder at published
widths, under the module names of the redecoder stage (`encoder` is the
Redecoder). The reference's `configs/config_redecoder.yml` is not in this
repository, so each field names its source:
- Redecoder: 1 prosody and 2 content code embeddings of 1024 x 512, a
  16-layer WN of width 512 conditioned on the 1024-d timbre, a 1x1 conv out
  to the 1024-d latent (SURVEY.md, Redecoder row; the defaults of
  facodec_tpu/models/redecoder.py `Redecoder` and the JAX builder's
  redecoder stage, which sets gin_channels = out_dim = latent_dim).
- Decoder: the codec decoder's widths and rates (the builder reads the same
  `DAC` block for both stages), non-causal, as the released redecoder is
  trained with `decoder_causal: False` (README.md, streaming section), and
  two LSTM layers, as the repository's own analogue of that config has
  (`scripts/train_redecoder_demo.py` REDECODER_KEYS, `decoder_lstm: 2`).

`FLAGSHIP_TRAIN` is `FLAGSHIP` plus the codec stage's training modules:
- fa_predictors: the flags of the flagship config
  (`scripts/emit_golden_flagship.py` FLAGSHIP_CFG_TEXT: use_gr_content_f0,
  use_gr_prosody_phone and use_gr_timbre_prosody off; norm_f0, timbre_norm
  and use_gr_content_global_f0 on) and those the JAX builder fixes
  (`facodec_tpu/models/builder.py`, codec stage: use_gr_residual_f0,
  use_gr_residual_phone, use_gr_timbre_content and use_gr_x_timbre on), at
  the latent width 1024 with the reference's 1024 phone classes and 20000
  speakers (the builder's defaults).
- discriminator: the builder's codec-stage ensemble, no multi-scale
  discriminator (rates ()), periods (2, 3, 5, 7, 11), FFT sizes (2048,
  1024, 512), its five bands, at the codec's 24 kHz.

`FLAGSHIP_REDECODER_TRAIN` is what redecoder training builds
(`train/redecoder_loop.py`); the reference's `config_redecoder.yml` is not
in this repository:
- codec: the frozen encoder and quantizer, `FLAGSHIP`'s (the JAX builder's
  `stage="encoder"` reads the same `DAC` block and quantizer keys; the
  released codec they come from is `FLAGSHIP`).
- encoder, decoder: `FLAGSHIP_REDECODER`, with the WN's train-mode dropout
  0.2 (`facodec_tpu/models/builder.py`, redecoder stage, `p_dropout=0.2`).
- discriminator: the redecoder stage's ensemble in the JAX builder, the
  same as the codec stage's (`FLAGSHIP_TRAIN`).
"""

FLAGSHIP = dict(
    encoder=dict(d_model=64, strides=(2, 5, 5, 6), d_latent=1024, causal=True, lstm=2),
    quantizer=dict(
        in_dim=1024, n_p_codebooks=1, n_c_codebooks=2, n_t_codebooks=2,
        n_r_codebooks=3, codebook_size=1024, codebook_dim=8,
        quantizer_dropout=0.5, causal=True, separate_prosody_encoder=True,
        timbre_norm=True,
    ),
    decoder=dict(input_channel=1024, channels=1536, rates=(6, 5, 5, 2), causal=True, lstm=2),
)

FLAGSHIP_REDECODER = dict(
    encoder=dict(n_p_codebooks=1, n_c_codebooks=2, codebook_size=1024, embed_dim=512,
                 n_layers=16, causal=False, gin_channels=1024, out_dim=1024),
    decoder=dict(input_channel=1024, channels=1536, rates=(6, 5, 5, 2), causal=False, lstm=2),
)

FLAGSHIP_TRAIN = dict(
    FLAGSHIP,
    fa_predictors=dict(
        in_dim=1024, use_gr_content_f0=False, use_gr_prosody_phone=False,
        use_gr_residual_f0=True, use_gr_residual_phone=True, use_gr_timbre_content=True,
        use_gr_timbre_prosody=False, use_gr_x_timbre=True, norm_f0=True, timbre_norm=True,
        use_gr_content_global_f0=True, n_phone_classes=1024, n_speakers=20000,
    ),
    discriminator=dict(
        rates=(), periods=(2, 3, 5, 7, 11), fft_sizes=(2048, 1024, 512), sample_rate=24000,
        bands=((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0)),
    ),
)

FLAGSHIP_REDECODER_TRAIN = dict(
    codec=dict(encoder=FLAGSHIP["encoder"], quantizer=FLAGSHIP["quantizer"]),
    encoder=dict(FLAGSHIP_REDECODER["encoder"], p_dropout=0.2),
    decoder=FLAGSHIP_REDECODER["decoder"],
    discriminator=FLAGSHIP_TRAIN["discriminator"],
)
