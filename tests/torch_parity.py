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
    (as a keyword default) the decode KV cache. The package is unchanged;
    only this test process's names are redirected, and restored after."""
    import omni_avsr_tpu.decode.decoding as jdec

    monkeypatch.setattr(jnp, "bfloat16", jnp.float32)
    monkeypatch.setitem(jdec.beam_search.__kwdefaults__, "cache_dtype", jnp.float32)

