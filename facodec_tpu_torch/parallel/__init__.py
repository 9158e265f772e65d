"""Data parallelism over GPUs (port of facodec_tpu/parallel)."""
