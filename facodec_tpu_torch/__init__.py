"""FAcodec in PyTorch for one NVIDIA Hopper GPU (H100), beside the JAX package.

`facodec_tpu/` is the reference; this package mirrors its layout
(`nn/`, `ops/`, `models/`, `utils/`, `cli/`, `api.py`, `codec_file.py`) so
each module has a counterpart there. It imports torch and numpy (and scipy
inside the host-side wav and loudness helpers), never jax, flax or
`facodec_tpu`.

Public functions take and return NTC `(batch, time, channels)` tensors, as
the JAX package does. State-dict keys map onto the JAX parameter tree through
`utils.weights.torch_key_to_path`, so `utils.weights.load_jax_params` moves
JAX weights into a port module by name.

The two TPU kernels of the codec and voice-conversion paths are CUDA C++
kernels for `sm_90a` (`csrc/`, wrapped in `ops/kernels/`): the fused DAC
residual unit and the VQ nearest-code search. On a CPU tensor each wrapper runs its plain PyTorch
version; on a CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
