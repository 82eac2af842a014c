"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs and parameters are made with numpy from a seed and handed to both
the JAX reference and the port. Parameters come from the JAX package's own
initialiser in f32 (`init_params(key, frozen_dtype=jnp.float32)`), carried
across leaf for leaf by `omni_avsr_tpu_torch.bridge.params_from_numpy`.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def randomize_lora_down(tree, seed: int = 7, std: float = 0.05):
    """The initialisers zero every LoRA down projection, which would leave
    the adapter math untested: give them small random values, in place."""
    rng = np.random.RandomState(seed)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                if k in ("down_q", "down_v"):
                    v["w"] = (rng.randn(*v["w"].shape) * std).astype(np.float32)
                else:
                    walk(v)

    walk(tree)
    return tree


def jax_tiny_flagship(bucket: bool = True):
    """`__graft_entry__._flagship(tiny=True)`, with the serving bench's
    bucketed Whisper window."""
    from __graft_entry__ import _flagship
    from omni_avsr_tpu.models.omni import OmniAVSR

    model = _flagship(tiny=True)
    if bucket:
        model = OmniAVSR(dataclasses.replace(model.cfg, whisper_input_mode="bucket"), model.tok)
    return model


def jax_tiny_params(model, seed: int = 0):
    """numpy f32 parameter tree of the JAX model, LoRA downs randomised."""
    init = jax.jit(lambda k: model.init_params(k, frozen_dtype=jnp.float32))
    params = jax.device_get(init(jax.random.PRNGKey(seed)))
    return randomize_lora_down(params)


def clips(lengths=(40, 33, 48), seed: int = 0):
    """Synthetic requests: 16 kHz audio (640 samples per frame) plus raw
    96x96 RGB mouth frames, one per length."""
    rng = np.random.RandomState(seed)
    return [{"audio": (rng.randn(n * 640) * 0.1).astype(np.float32),
             "video": rng.randint(0, 255, (n, 96, 96, 3), dtype=np.uint8)} for n in lengths]


def jax_in_f32(monkeypatch):
    """Run the JAX package's serving path in f32 end to end: its modules
    name `jnp.bfloat16` for the activations, the trainable-leaf cast and
    (as a keyword default of beam search and greedy decoding) the decode
    KV cache. The package is unchanged;
    only this test process's names are redirected, and restored after."""
    import omni_avsr_tpu.decode.decoding as jdec

    monkeypatch.setattr(jnp, "bfloat16", jnp.float32)
    for fn in (jdec.beam_search, jdec.greedy_decode):
        monkeypatch.setitem(fn.__kwdefaults__, "cache_dtype", jnp.float32)



def jax_conv_kernel(monkeypatch):
    """Route the JAX package's `fused_conv` (which takes its XLA reference
    off the TPU) through its Pallas kernel B7, `conv2d_fused_pallas`, in
    interpret mode, as `OMNI_CONV_KERNEL=1` routes it on the TPU. The
    operands are rounded to bf16 first with the true bf16 type, which is
    what the kernel does itself: under `jax_in_f32` its own cast names the
    redirected `jnp.bfloat16` and would keep them in f32. Only this test
    process's name is redirected, and restored after."""
    import omni_avsr_tpu.ops.conv_block as jcb

    kernel = jcb.conv2d_fused_pallas
    bf16 = jnp.dtype("bfloat16")

    def fused_conv(x, w, stride=1, pad=1, scale=None, bias=None, prelu_a=None, residual=None):
        x = x.astype(bf16).astype(x.dtype)
        w = w.astype(bf16).astype(w.dtype)
        return kernel(x, w, stride, pad, scale, bias, prelu_a, residual, interpret=True)

    monkeypatch.setattr(jcb, "fused_conv", fused_conv)
