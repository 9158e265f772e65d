"""Codec GAN training (port of facodec_tpu/train)."""
