"""Model configurations of the port.

`FLAGSHIP` is the released FAcodec configuration, copied from the JAX
package's driver entry (`__graft_entry__.py` FLAGSHIP): the module fields of
the encoder, the factorized quantizer and the decoder at published widths.
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
