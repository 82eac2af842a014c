"""Numerics profiles: the JAX package's `OMNI_*` switches, read once by the
port's CLIs (port of `omni_avsr_tpu/utils/profiles.py`).

The library takes every switch as an argument; the CLIs are the JAX
package's user surface, so they read its variables here and pass the
result down (`Numerics`). `OMNI_PROFILE=reference` pins the combination a
weights-day parity run needs:

    OMNI_PRNG=threefry        JAX's threefry streams (OmniEngine prng="threefry")
    OMNI_BN_STATS=twopass     two-pass train-mode BN variance (bn_stats="twopass")
    OMNI_BEAM_SELECT=grid     the full (B, K*V) candidate grid (select_mode="grid")
    OMNI_BEAM_ATTN=xla        the reorder beam attention (attn_route="xla")
    OMNI_SELECT_KERNEL=0      selection statistics as torch ops (select_kernel=False)
    OMNI_CONV_KERNEL=0        the ResNet trunk's convs as torch ops (conv_kernel=False)
    OMNI_REMAT=off            no rematerialisation (remat="off")
    OMNI_SP=0                 no sequence parallelism

As in the JAX package, the profile sets a baseline and a variable already
set in the environment wins; `resolve` prints both, so an override cannot
pass unnoticed. The port adds no variable of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

REFERENCE_PROFILE: Dict[str, str] = {
    "OMNI_PRNG": "threefry",
    "OMNI_BN_STATS": "twopass",
    "OMNI_BEAM_SELECT": "grid",
    "OMNI_BEAM_ATTN": "xla",
    "OMNI_SELECT_KERNEL": "0",
    "OMNI_CONV_KERNEL": "0",
    "OMNI_REMAT": "off",
    "OMNI_SP": "0",
}

PROFILES: Dict[str, Dict[str, str]] = {
    "reference": REFERENCE_PROFILE,
    # the tuned defaults: every reader's own default
    "tpu": {},
}


@dataclasses.dataclass(frozen=True)
class Numerics:
    """The switches as the port's arguments."""

    prng: str = "torch"  # OmniEngine(prng=): "torch" or "threefry"
    bn_stats: str = "onepass"  # train-mode BN variance: "onepass" or "twopass"
    beam_select: str = "fused"  # beam_search(select_mode=): "fused" or "grid"
    beam_attn: Optional[str] = None  # beam_search(attn_route=): None, "kernel" or "xla"
    select_kernel: bool = False  # B5 selection statistics (where the vocabulary allows)
    conv_kernel: bool = False  # B7 in the ResNet trunk
    remat: str = "dots"  # remat policy: "dots", "off" or "full"
    sp: bool = False  # OmniEngine(sequence_parallel=) under a tp mesh (`--sequence-parallel`)

    def engine_kwargs(self) -> Dict[str, object]:
        """The `OmniEngine` arguments these switches set."""
        return dict(prng=self.prng, bn_stats=self.bn_stats, remat=self.remat,
                    decode_attn_route=self.beam_attn, decode_select_mode=self.beam_select,
                    conv_kernel=self.conv_kernel, select_kernel=self.select_kernel)


def apply_profile(name: Optional[str], environ: Mapping[str, str]
                  ) -> Tuple[Dict[str, str], Dict[str, str], Dict[str, str]]:
    """(the environment with the profile's baseline under it, the variables
    the profile set, the explicit ones it left) (`apply_profile`, `:55-82`);
    `environ` is not changed."""
    env = dict(environ)
    if not name:
        return env, {}, {}
    if name not in PROFILES:
        raise ValueError(f"unknown OMNI_PROFILE {name!r} (have: {sorted(PROFILES)})")
    applied, overridden = {}, {}
    for var, val in PROFILES[name].items():
        if var in env and env[var] != val:
            overridden[var] = env[var]
            continue
        env[var] = val
        applied[var] = val
    return env, applied, overridden


def _flag(env: Mapping[str, str], var: str) -> bool:
    v = env.get(var)
    return v is not None and v not in ("0", "")


def _choice(env: Mapping[str, str], var: str, default: str, allowed) -> str:
    v = env.get(var, default)
    if v not in allowed:
        raise ValueError(f"{var}={v!r}: one of {sorted(allowed)}")
    return v


def resolve(environ: Mapping[str, str], verbose: bool = True) -> Numerics:
    """The switches of `environ`: `OMNI_PROFILE`'s baseline, then each
    explicit `OMNI_*` variable, with the JAX package's defaults. Prints the
    profile's variables and the overrides it kept. `OMNI_PRNG` values other
    than "threefry" (the JAX default "rbg", "unsafe_rbg") take the port's
    torch generators: the same distributions, as those are."""
    name = environ.get("OMNI_PROFILE", "")
    env, applied, overridden = apply_profile(name, environ)
    if verbose and (applied or overridden):
        msg = f"[omni-avsr] profile {name!r}: " + ", ".join(f"{k}={v}" for k, v in applied.items())
        if overridden:
            msg += " | explicit overrides kept: " + ", ".join(
                f"{k}={v}" for k, v in overridden.items())
        print(msg)
    attn = env.get("OMNI_BEAM_ATTN") or None
    if attn not in (None, "kernel", "xla"):
        raise ValueError(f"OMNI_BEAM_ATTN={attn!r}: 'kernel' or 'xla'")
    return Numerics(
        prng="threefry" if env.get("OMNI_PRNG") == "threefry" else "torch",
        bn_stats=_choice(env, "OMNI_BN_STATS", "onepass", ("onepass", "twopass")),
        beam_select=_choice(env, "OMNI_BEAM_SELECT", "fused", ("fused", "grid")),
        beam_attn=attn,
        select_kernel=_flag(env, "OMNI_SELECT_KERNEL"),
        conv_kernel=_flag(env, "OMNI_CONV_KERNEL"),
        remat=_choice(env, "OMNI_REMAT", "dots", ("dots", "off", "full")),
        sp=_flag(env, "OMNI_SP"),
    )


# each pin of the reference profile, the port argument that holds it
PIN_ARGUMENTS: Dict[str, str] = {
    "OMNI_PRNG": "OmniEngine(prng='threefry'): utils/prng.py's threefry streams",
    "OMNI_BN_STATS": "OmniEngine(bn_stats='twopass'): resnet3d.batch_norm_train(stats='twopass')",
    "OMNI_BEAM_SELECT": "select_mode='grid' (OmniEngine.decode_batch, Transcriber, beam_search)",
    "OMNI_BEAM_ATTN": "attn_route='xla': the reorder route (llm_decode_step_beam)",
    "OMNI_SELECT_KERNEL": "select_kernel=False: selection statistics as torch ops",
    "OMNI_CONV_KERNEL": "conv_kernel=False: the ResNet trunk's convs as torch ops",
    "OMNI_REMAT": "OmniEngine(remat='off'): no checkpointing",
    "OMNI_SP": "no sequence parallelism",
}


def pins_held(numerics: Numerics) -> Tuple[Dict[str, str], Dict[str, str]]:
    """({"VAR=value": port argument} of the reference pins `numerics`
    holds, the same of those it does not)."""
    now = {
        "OMNI_PRNG": numerics.prng == "threefry",
        "OMNI_BN_STATS": numerics.bn_stats == "twopass",
        "OMNI_BEAM_SELECT": numerics.beam_select == "grid",
        "OMNI_BEAM_ATTN": numerics.beam_attn == "xla",
        "OMNI_SELECT_KERNEL": not numerics.select_kernel,
        "OMNI_CONV_KERNEL": not numerics.conv_kernel,
        "OMNI_REMAT": numerics.remat == "off",
        "OMNI_SP": not numerics.sp,
    }
    held, not_held = {}, {}
    for var, val in REFERENCE_PROFILE.items():
        (held if now[var] else not_held)[f"{var}={val}"] = PIN_ARGUMENTS[var]
    return held, not_held
