"""PyTorch/CUDA port of omni-avsr-tpu for NVIDIA Hopper.

The JAX package `omni_avsr_tpu` is the reference this port is held
against; the port imports nothing of it. Entry point for serving:
`omni_avsr_tpu_torch.serve.Transcriber`.
"""
