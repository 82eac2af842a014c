"""One-command checkpoint parity against BASELINE.md (port of
`omni_avsr_tpu/cli/verify_parity.py`).

Given a trained reference checkpoint (`model_avg_4.pth`, the averaged
state dict of `utils/avg_checkpoints.py:14-44`) and an LRS2/LRS3 test
manifest, this converts the checkpoint, runs the task x rate WER grid with
the reference decode settings (beam 15, 32 tokens) through
`cli/eval_omni.py`, and diffs every setting against the published table
transcribed in BASELINE.md. Exit code 0 iff every setting is within
`--tolerance` (0.1 absolute WER by default).

    python -m omni_avsr_tpu_torch.cli.verify_parity \\
        --pretrained-model-path /ckpts/model_avg_4.pth \\
        --llm-model meta-llama/Llama-3.2-1B \\
        --root-dir /data/lrs3 --test-file /data/lrs3/test.csv \\
        --dataset lrs3 --output-json PARITY_RESULTS.json

Every argument this parser does not know goes to `eval_omni` (`--device
cpu`, `--synthetic N`, ...). `--modes bf16,int8,int4,bucket` runs the grid
once per decode mode, a column each: `bf16` is the reference's; `int8` and
`int4` decode on the quantised trees (B2, B6), `bucket` with the bucketed
Whisper window. Parity is judged on the bf16 column; the others are
diffed against it. `--convert-only` stops after the conversion and prints
a census of the converted tree against `bridge.init_params` of the same
configuration.

`--profile` names the JAX package's numerics profile (default
"reference"): its variables go under the environment the `eval_omni` runs
read (`utils/profiles.py`; an `OMNI_*` variable already set wins and is
printed), as the JAX package applies it to its own. The report lists each
pin of the reference profile with the port argument that holds it, and any
pin an explicit variable overrode as not held.
`--golden-clip clip.npy` (or an mp4 where OpenCV is installed) also
preprocesses the reference's bundled clip (the port's RetinaFace + FAN on
the card with `--retinaface-weights` and `--fan-weights`, the centered
fallback without them) and records its beam transcript per mode, the
golden-clip check of `omni_avsr_tpu/cli/verify_parity.py:109-148`. Audio is
taken from a sibling .wav (or `--golden-audio`); without one, the
transcript is VSR-only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

# LRS3 / LRS2 Omni-AVSR-ST WER (%) from BASELINE.md (the paper's main table)
BASELINE_WER = {
    "lrs3": {
        ("audio", 4, None): 1.2, ("audio", 16, None): 2.0,
        ("video", None, 2): 26.8, ("video", None, 5): 27.1,
        ("audiovisual", 4, 2): 1.0, ("audiovisual", 4, 5): 1.1,
        ("audiovisual", 16, 2): 1.8, ("audiovisual", 16, 5): 1.9,
    },
    "lrs2": {
        ("audio", 4, None): 2.7, ("audio", 16, None): 4.8,
        ("video", None, 2): 27.8, ("video", None, 5): 29.5,
        ("audiovisual", 4, 2): 2.5, ("audiovisual", 4, 5): 2.7,
        ("audiovisual", 16, 2): 3.9, ("audiovisual", 16, 5): 4.2,
    },
}

MODE_ARGV = {
    "bf16": [],
    "int8": ["--quantize-decode", "int8"],
    "int4": ["--quantize-decode", "int4"],
    "bucket": ["--whisper-input-mode", "bucket"],
}



def profile_environ(profile: str, environ=None) -> dict:
    """The environment of the `eval_omni` runs: the process's, with
    `OMNI_PROFILE` set to `profile` unless it is "none"."""
    import os

    env = dict(os.environ if environ is None else environ)
    if profile != "none":
        env["OMNI_PROFILE"] = profile
    return env


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        "verify_parity", description="convert a reference checkpoint and diff WER vs BASELINE.md")
    p.add_argument("--dataset", default="lrs3", choices=["lrs3", "lrs2"])
    p.add_argument("--tolerance", type=float, default=0.1,
                   help="max |ours - reference| in absolute WER %% per setting")
    p.add_argument("--convert-only", action="store_true",
                   help="stop after checkpoint conversion; print a tree summary")
    p.add_argument("--output-json", default="PARITY_RESULTS.json")
    p.add_argument("--modes", default="bf16",
                   help="comma list of decode modes to grid: bf16,int8,int4,bucket")
    p.add_argument("--golden-clip", default=None,
                   help="raw clip (.npy, or mp4 with OpenCV) to preprocess and transcribe per mode")
    p.add_argument("--retinaface-weights", default=None,
                   help="Resnet50_Final.pth: golden-clip landmarks from the port's RetinaFace+FAN "
                        "instead of the centered fallback")
    p.add_argument("--fan-weights", default=None)
    p.add_argument("--golden-audio", default=None,
                   help="16 kHz wav for the golden clip (default: sibling .wav of --golden-clip "
                        "if present)")
    p.add_argument("--profile", default="reference", choices=["reference", "tpu", "none"],
                   help="the JAX package's numerics profile (utils/profiles.py): 'reference' "
                        "pins every switch to the reference-exact combination (threefry, "
                        "two-pass BN, grid selection, the reorder beam attention, remat off); "
                        "'tpu' keeps the defaults")
    return p.parse_known_args(argv)


def golden_transcripts(clip, audio_path, eval_argv, modes, detector_weights=(None, None),
                       numerics=None):
    """Preprocess --golden-clip on the device and beam-decode it under each
    mode -> {"modality", "transcripts": {mode: text}}."""
    import os

    import numpy as np

    from ..data.dataset import load_audio, load_video
    from ..preprocess.detector import build_detector
    from ..preprocess.mean_face import load_mean_face
    from ..preprocess.video_process import extract_mouth_rois
    from ..serve import Transcriber
    from . import common, eval_omni
    from .common import apply_numerics

    device = common.check_args(eval_omni.parse_args(eval_argv + ["--print-hyp", "false"]))
    frames = load_video(clip)
    det = build_detector("auto", device=device, retinaface_weights=detector_weights[0],
                         fan_weights=detector_weights[1])
    rois = extract_mouth_rois(frames, det(frames), load_mean_face(), device=device)
    if rois is None:
        raise ValueError(f"{clip}: no usable landmarks or clip shorter than the 12-frame "
                         f"smoothing window")
    video = np.repeat(rois[..., None], 3, axis=-1)

    if audio_path is None:
        sib = os.path.splitext(clip)[0] + ".wav"
        audio_path = sib if os.path.exists(sib) else None
    audio = load_audio(audio_path) if audio_path else None
    modality = "audiovisual" if audio is not None else "video"

    out = {}
    for mode in modes:
        ep = eval_omni.parse_args(eval_argv + MODE_ARGV[mode] + ["--print-hyp", "false"])
        model = common.build_model(ep)
        params = common.build_params(ep, model, device)
        t = Transcriber(model, params, num_beams=model.cfg.num_beams,
                        max_new_tokens=model.cfg.max_dec_tokens,
                        quantize=mode if mode in ("int8", "int4") else None, device=device)
        if numerics is not None:
            apply_numerics(t, numerics)
        out[mode] = t.transcribe(video=video, audio=audio, modality=modality)
        print(f"golden-clip [{mode}, {modality}]: {out[mode]!r}")
    return {"modality": modality, "transcripts": out}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def _tree_summary(params, init_params) -> dict:
    """Census of the converted tree against the model's own init layout."""
    flat, ref = dict(_leaves(params)), dict(_leaves(init_params))
    mismatched = [(k, tuple(v.shape), tuple(ref[k].shape)) for k, v in flat.items()
                  if k in ref and tuple(v.shape) != tuple(ref[k].shape)]
    return dict(leaves=len(flat), parameters=sum(int(v.numel()) for v in flat.values()),
                missing_vs_init=sorted(set(ref) - set(flat)),
                extra_vs_init=sorted(set(flat) - set(ref)), shape_mismatches=mismatched)


def main(argv=None):
    args, eval_argv = parse_args(argv)
    from . import eval_omni

    if args.convert_only:
        import torch

        from ..bridge import init_params
        from .common import build_model, build_params, check_args

        ep = eval_omni.parse_args(eval_argv + ["--print-hyp", "false"])
        device = check_args(ep)
        model = build_model(ep)
        params = build_params(ep, model, device)
        summary = _tree_summary(params, init_params(model.cfg, torch.Generator().manual_seed(0),
                                                    "meta"))
        ok = not (summary["missing_vs_init"] or summary["shape_mismatches"])
        print(json.dumps(summary, indent=2, default=str))
        print(f"conversion {'OK' if ok else 'MISMATCH'}: "
              f"{summary['parameters']:,} params in {summary['leaves']} leaves")
        return 0 if ok else 1

    from ..utils.profiles import pins_held, resolve

    env = profile_environ(args.profile)
    numerics = resolve(env)
    held, not_held = pins_held(numerics)
    profile = {"requested": args.profile, "numerics": dataclasses.asdict(numerics),
               "reference_pins_held": held, "reference_pins_not_held": not_held}
    print(f"profile {args.profile!r}: {len(held)} of {len(held) + len(not_held)} reference pins "
          f"held: {', '.join(held)}" + (f"; not held: {', '.join(not_held)}" if not_held else ""))
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    unknown = [m for m in modes if m not in MODE_ARGV]
    if unknown:
        raise ValueError(f"unknown modes {unknown}; pick from {list(MODE_ARGV)}")
    if "bf16" not in modes:
        modes.insert(0, "bf16")  # parity is judged on bf16

    mode_results = {}
    for mode in modes:
        print(f"\n--- running decode grid: mode={mode} ---")
        mode_results[mode] = eval_omni.main(eval_argv + MODE_ARGV[mode], environ=env)
    results = mode_results["bf16"]

    rows, worst = [], 0.0
    for (task, ra, rv), ref_wer in BASELINE_WER[args.dataset].items():
        key = f"{task} (a={ra}, v={rv})"
        ours = results.get(key)
        if ours is None:
            rows.append(dict(setting=key, reference=ref_wer, ours=None, delta=None,
                             status="MISSING"))
            worst = float("inf")
            continue
        ours_pct = 100.0 * ours
        delta = ours_pct - ref_wer
        worst = max(worst, abs(delta))
        row = dict(setting=key, reference=ref_wer, ours=round(ours_pct, 2), delta=round(delta, 2),
                   status="PASS" if abs(delta) <= args.tolerance else "FAIL")
        # the other modes' columns: against our bf16 (is the mode WER-neutral?)
        for mode in (m for m in modes if m != "bf16"):
            m = mode_results[mode].get(key)
            row[mode] = None if m is None else round(100.0 * m, 2)
            row[f"{mode}_vs_bf16"] = None if m is None else round(100.0 * m - ours_pct, 2)
        rows.append(row)

    measured = [r for r in rows if r["ours"] is not None]
    avg_ours = sum(r["ours"] for r in measured) / max(1, len(measured))
    avg_ref = sum(r["reference"] for r in measured) / max(1, len(measured))

    extra_cols = [m for m in modes if m != "bf16"]
    hdr = "".join(f" {m:>7}" for m in extra_cols)
    print(f"\n=== parity vs BASELINE.md ({args.dataset}, tol {args.tolerance}) ===")
    print(f"{'setting':<34} {'ref':>6} {'bf16':>6} {'delta':>6}{hdr}  status")
    for r in rows:
        ours = f"{r['ours']:.2f}" if r["ours"] is not None else "--"
        delta = f"{r['delta']:+.2f}" if r["delta"] is not None else "--"
        extras = "".join(f" {r.get(m):>7.2f}" if r.get(m) is not None else f" {'--':>7}"
                         for m in extra_cols)
        print(f"{r['setting']:<34} {r['reference']:>6.2f} {ours:>6} {delta:>6}{extras}  "
              f"{r['status']}")
    print(f"{'AVG over measured settings':<34} {avg_ref:>6.2f} {avg_ours:>6.2f} "
          f"{avg_ours - avg_ref:+6.2f}")

    report = dict(dataset=args.dataset, tolerance=args.tolerance, modes=modes, rows=rows,
                  avg_reference=round(avg_ref, 3), avg_ours=round(avg_ours, 3),
                  worst_abs_delta=None if worst == float("inf") else round(worst, 3),
                  passed=all(r["status"] == "PASS" for r in rows), profile=profile)
    if args.golden_clip:
        report["golden_clip"] = golden_transcripts(
            args.golden_clip, args.golden_audio, eval_argv, modes,
            detector_weights=(args.retinaface_weights, args.fan_weights),
            numerics=resolve(env, verbose=False))
    with open(args.output_json, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.output_json}")
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
