"""A tiny configuration and traffic for the CPU tests: every width of
`configs/omni-qwen2.5-7b.json` cut small (the ResNet trunk is fixed by
the model), two decoder layers, four new tokens."""

from __future__ import annotations

import copy
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent


def config() -> dict:
    cfg = json.loads((PKG / "configs" / "omni-qwen2.5-7b.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, vocab_size=300)
    cfg["lora"].update(rank_divisor=8, v_out_divisor=2)
    cfg["whisper"].update(hidden_size=64, num_layers=2, num_heads=4, ffn_dim=128)
    cfg["avhubert"].update(encoder_embed_dim=64, encoder_layers=2, encoder_heads=4,
                           encoder_ffn_dim=128)
    cfg["projector"].update(intermediate_size=32)
    cfg["serving"].update(max_new_tokens=4, num_beams=3)
    return cfg


def closed_traffic() -> dict:
    return {"kind": "closed_batches", "batch_size": 2, "modality": "audiovisual",
            "lengths": {"dist": "lognormal", "mean_s": 0.6, "sigma": 0.5, "lo": 10, "hi": 20},
            "beams": 3, "pool_batches": 2, "population_seed": 5}


def loaded(traffic: dict, limits=None, name="tiny"):
    """`run.load_cell`'s tuple for a tiny cell."""
    cfg = config()
    bench = {"workloads": [{"name": name, "config": "tiny", "traffic": "tiny", "chips": 1}],
             "end_to_end": [{"name": "setup_s", "unit": "s"},
                            {"name": "serve_audio_s_per_s", "unit": "audio-s/s"},
                            {"name": "peak_device_gib", "unit": "GiB"}],
             "per_layer": []}
    check = {"sample": 4,
             "limits": dict(limits or {"beam_gap": 1e-3, "selection_gap": 1e-3}, unanswered=0.0)}
    return bench, bench["workloads"][0], cfg, traffic, check
