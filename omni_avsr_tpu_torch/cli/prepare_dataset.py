"""Batch dataset preparation: a directory tree of raw clips -> mouth-ROI clips
+ wavs + bucketable manifests (port of `omni_avsr_tpu/cli/prepare_dataset.py`;
the reference's LRS3/VoxCeleb preparation, `av_hubert/avhubert/preparation/
*.py`: landmark detection, mouth alignment, manifest generation).

    python -m omni_avsr_tpu_torch.cli.prepare_dataset \\
        --input-dir raw_clips/ --output-dir data/ --dataset-name lrs3 \\
        --splits train:0.9 val:0.05 test:0.05 [--device cpu]

The same clip discovery, LRS3 word-interval segmentation, splits and
manifests as the JAX CLI. One detector serves every clip: the worker
threads share it, and with `--detector torch` (`--retinaface-weights`,
`--fan-weights`) it runs on `--device`, as does each clip's ROI warp.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

FPS = 25
AUDIO_SR = 16000


def find_clips(input_dir: str) -> List[str]:
    out = []
    for root, _, files in os.walk(input_dir):
        for f in sorted(files):
            if f.endswith((".mp4", ".npy")) and "preprocessed" not in f:
                out.append(os.path.join(root, f))
    return out


def parse_word_intervals(txt_path: str) -> List[Tuple[str, float, float]]:
    """LRS3 pretrain txt: `Text:`/`Conf:` header then a `WORD START END SCORE`
    table. Returns [] when no word timings exist (trainval/test clips)."""
    if not os.path.exists(txt_path):
        return []
    lines = open(txt_path).read().splitlines()
    start_index = None
    for i, ln in enumerate(lines):
        if ln[:4] == "WORD":
            start_index = i
            break
    if start_index is None:
        return []
    out = []
    for ln in lines[start_index + 1:]:
        parts = ln.strip().split()
        if len(parts) < 3:
            continue
        out.append((parts[0], float(parts[1]), float(parts[2])))
    return out


def segment_intervals(
    words: List[Tuple[str, float, float]],
    max_duration: float = 15.0,
    min_gap: float = 0.4,
) -> List[Tuple[float, float, str]]:
    """Reference long-clip segmentation (`av_hubert/avhubert/preparation/
    lrs3_prepare.py:24-77` make_short_manifest): clips whose last word ends
    before `max_duration` stay whole (start 0, end -1 = full clip); longer
    ones split into sentences at word gaps > `min_gap`, with each boundary
    placed midway between the adjacent sentences. Returns
    [(start_s, end_s, text)] where end_s == -1 means "to the end"."""
    if not words:
        return []
    if words[-1][2] < max_duration:
        return [(0.0, -1.0, " ".join(w for w, _, _ in words))]
    sents: List[List[Tuple[str, float, float]]] = []
    cur: List[Tuple[str, float, float]] = []
    for i, (word, start, end) in enumerate(words):
        if i == 0:
            cur.append((word, start, end))
        elif start - cur[-1][2] > min_gap:
            sents.append(cur)
            cur = [(word, start, end)]
        else:
            cur.append((word, start, end))
    if cur:
        sents.append(cur)
    out = []
    for i, sent in enumerate(sents):
        text = " ".join(w for w, _, _ in sent)
        start = 0.0 if i == 0 else (sent[0][1] + sents[i - 1][-1][2]) / 2
        end = -1.0 if i == len(sents) - 1 else (sent[-1][2] + sents[i + 1][0][1]) / 2
        out.append((start, end, text))
    return out


def read_transcript(clip_path: str) -> str:
    """LRS2/LRS3 convention: <clip>.txt with 'Text:  ...' line, or plain text."""
    txt = os.path.splitext(clip_path)[0] + ".txt"
    if not os.path.exists(txt):
        return ""
    with open(txt) as f:
        content = f.read()
    for line in content.splitlines():
        if line.lower().startswith("text:"):
            return line.split(":", 1)[1].strip()
    return content.strip().splitlines()[0] if content.strip() else ""


def _write_segment(clip_out_dir, dataset_name, base, rois, audio, text):
    from ..preprocess.noise_prep import write_wav_int16
    from .preprocess_video import write_video

    video_out = write_video(os.path.join(clip_out_dir, base + ".mp4"), rois)
    if audio is not None:
        write_wav_int16(os.path.join(clip_out_dir, base + ".wav"),
                        (np.clip(audio, -1, 1) * 32767).astype(np.int16))
    rel = os.path.basename(video_out)
    return f"{dataset_name},{rel},{len(rois)},0,{text}"


def process_clip(clip: str, out_dir: str, dataset_name: str, mean_face: np.ndarray, detector,
                 max_secs: float, device) -> Optional[List[str]]:
    """One raw clip -> its manifest rows (one per segment), or None (printed
    as SKIP) when it cannot be preprocessed."""
    try:
        from ..data.dataset import load_audio, load_video
        from ..preprocess.video_process import extract_mouth_rois
        from .preprocess_video import extract_audio

        frames = load_video(clip)
        rois = extract_mouth_rois(frames, detector(frames), mean_face, device=device)
        if rois is None:
            raise ValueError("no usable landmarks / clip shorter than smooth window")
        base = os.path.splitext(os.path.basename(clip))[0]
        clip_out_dir = os.path.join(out_dir, dataset_name)
        os.makedirs(clip_out_dir, exist_ok=True)

        wav_src = os.path.splitext(clip)[0] + ".wav"
        if not os.path.exists(wav_src):
            tmp_wav = os.path.join(clip_out_dir, base + ".src.wav")
            if extract_audio(clip, tmp_wav):
                wav_src = tmp_wav
        audio = load_audio(wav_src) if os.path.exists(wav_src) else None

        # long-clip segmentation (reference lrs3_prepare.py make_short_manifest)
        segments = None
        if max_secs > 0:
            words = parse_word_intervals(os.path.splitext(clip)[0] + ".txt")
            if words:
                segments = segment_intervals(words, max_duration=max_secs)
        if segments and len(segments) > 1:
            rows = []
            for i, (start, end, text) in enumerate(segments):
                f0 = int(round(start * FPS))
                f1 = len(rois) if end < 0 else int(round(end * FPS))
                seg_rois = rois[f0:f1]
                if len(seg_rois) == 0:
                    continue
                seg_audio = None
                if audio is not None:
                    a0 = int(round(start * AUDIO_SR))
                    a1 = len(audio) if end < 0 else int(round(end * AUDIO_SR))
                    seg_audio = audio[a0:a1]
                rows.append(_write_segment(clip_out_dir, dataset_name, f"{base}_{i}", seg_rois,
                                           seg_audio, text))
            if rows:
                return rows
            raise ValueError("segmentation produced no usable segments")

        text = segments[0][2] if segments else read_transcript(clip)
        return [_write_segment(clip_out_dir, dataset_name, base, rois, audio, text)]
    except Exception as e:
        print(f"SKIP {clip}: {type(e).__name__}: {e}")
        return None


def main(argv=None):
    from ..preprocess.detector import build_detector
    from ..preprocess.mean_face import load_mean_face
    from .preprocess_video import DETECTORS, device_or_exit

    p = argparse.ArgumentParser("prepare_dataset")
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--dataset-name", default="lrs3")
    p.add_argument("--detector", default="auto", choices=DETECTORS)
    p.add_argument("--retinaface-weights", default=None,
                   help="Resnet50_Final.pth (biubug6 layout) for --detector torch")
    p.add_argument("--fan-weights", default=None,
                   help="FAN .pth (1adrianb layout) for --detector torch")
    p.add_argument("--mean-face-path", default=None)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--splits", nargs="+", default=["train:0.9", "val:0.05", "test:0.05"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-clip-seconds", type=float, default=0,
                   help="split clips longer than this at word-gap boundaries using the LRS3 "
                        "pretrain txt word timings (reference lrs3_prepare.py uses 15); 0 "
                        "disables")
    p.add_argument("--device", default="cuda",
                   help="torch device of the detector and the ROI warp; without a CUDA device "
                        "the CLI stops unless given cpu")
    args = p.parse_args(argv)
    device = device_or_exit(args.device)

    clips = find_clips(args.input_dir)
    print(f"found {len(clips)} clips")
    os.makedirs(args.output_dir, exist_ok=True)
    detector = build_detector(args.detector, device=device,
                              retinaface_weights=args.retinaface_weights,
                              fan_weights=args.fan_weights)
    mean_face = load_mean_face(args.mean_face_path)
    with ThreadPoolExecutor(max_workers=args.num_workers) as pool:
        results = pool.map(lambda c: process_clip(c, args.output_dir, args.dataset_name,
                                                  mean_face, detector, args.max_clip_seconds,
                                                  device), clips)
        rows = [r for rs in results if rs is not None for r in rs]

    rng = np.random.RandomState(args.seed)
    order = rng.permutation(len(rows))
    splits = [(s.split(":")[0], float(s.split(":")[1])) for s in args.splits]
    start = 0
    for name, frac in splits:
        n = max(1, int(round(frac * len(rows)))) if start < len(rows) else 0
        part = [rows[i] for i in order[start:start + n]]
        start += n
        path = os.path.join(args.output_dir, f"{name}.csv")
        with open(path, "w") as f:
            f.write("\n".join(part) + ("\n" if part else ""))
        print(f"{path}: {len(part)} rows")


if __name__ == "__main__":
    main()
