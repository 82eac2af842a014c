"""Parallelism of the port (port of `omni_avsr_tpu/parallel/`): the mesh,
multi-process start-up, partition specs, the explicit collectives and
their context, the GPipe pipeline and a local launcher. One rank per
device; NCCL on the card, gloo on the CPU."""
