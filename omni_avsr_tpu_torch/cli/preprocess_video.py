"""Single-clip preprocessing CLI: raw clip -> mouth-ROI clip + wav + manifest
(port of `omni_avsr_tpu/cli/preprocess_video.py`; reference
`preprocessing_inference_example/preprocess_video.py:30-58`): detect faces,
extract 96x96 mouth ROIs on the device, write `<name>_preprocessed.mp4`
(`.npy` where no mp4 writer exists), `<name>.wav` and a one-row
`test_file.csv` usable by eval drivers.

    python -m omni_avsr_tpu_torch.cli.preprocess_video \\
        --path-to-input-video clip.npy --transcription "HELLO WORLD"   # on the card
    python -m omni_avsr_tpu_torch.cli.preprocess_video ... --device cpu

Clips are `.npy` frames (T, H, W, 3) uint8 RGB, or mp4 where OpenCV is
installed (`data/dataset.py::load_video`). `--detector torch` (or `jax`, the
JAX CLI's name for it) with `--retinaface-weights` and `--fan-weights` runs
the port's RetinaFace + FAN on the device; without weights, `auto` falls
back to the centered mean face, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import os
import subprocess

from ..data.dataset import load_video
from ..data.synthetic import _write_video as write_video  # mp4 through OpenCV, else .npy
from ..preprocess.detector import build_detector
from ..preprocess.mean_face import load_mean_face
from ..preprocess.video_process import extract_mouth_rois, resolve_device

DETECTORS = ["auto", "torch", "jax", "ibug", "center"]


def extract_audio(video_path: str, wav_path: str) -> bool:
    """Extract 16 kHz mono wav (ffmpeg when present, else skip)."""
    try:
        subprocess.run(["ffmpeg", "-y", "-i", video_path, "-ac", "1", "-ar", "16000",
                        "-f", "wav", wav_path], check=True, capture_output=True)
        return True
    except Exception:
        return False


def device_or_exit(device: str):
    """The torch device, or exit 1 when it names a card that is not here."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(f"--device {device}: {e}")


def main(argv=None):
    p = argparse.ArgumentParser("preprocess_video")
    p.add_argument("--path-to-input-video", required=True)
    p.add_argument("--transcription", default="")
    p.add_argument("--detector", default="auto", choices=DETECTORS)
    p.add_argument("--retinaface-weights", default=None,
                   help="Resnet50_Final.pth (biubug6 layout) for --detector torch")
    p.add_argument("--fan-weights", default=None,
                   help="FAN .pth (1adrianb layout) for --detector torch")
    p.add_argument("--mean-face-path", default=None,
                   help="reference 20words_mean_face.npy for exact parity")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the detector and the ROI warp; without a CUDA device "
                        "the CLI stops unless given cpu")
    args = p.parse_args(argv)
    device = device_or_exit(args.device)

    src = args.path_to_input_video
    out_dir = args.out_dir or os.path.dirname(os.path.abspath(src))
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(src))[0]

    frames = load_video(src)
    detector = build_detector(args.detector, device=device,
                              retinaface_weights=args.retinaface_weights,
                              fan_weights=args.fan_weights)
    rois = extract_mouth_rois(frames, detector(frames), load_mean_face(args.mean_face_path),
                              device=device)
    if rois is None:
        raise SystemExit("no usable landmarks (no detections, or clip shorter than the "
                         "12-frame smoothing window): cannot preprocess this clip")

    video_out = write_video(os.path.join(out_dir, base + "_preprocessed.mp4"), rois)
    wav_out = os.path.join(out_dir, base + ".wav")
    has_audio = extract_audio(src, wav_out)

    csv_path = os.path.join(out_dir, "test_file.csv")
    rel = os.path.basename(video_out)
    with open(csv_path, "w") as f:
        f.write(f"{os.path.basename(out_dir)},{rel},{len(rois)},0,{args.transcription}\n")
    print(f"wrote {video_out}" + (f" + {wav_out}" if has_audio
                                   else " (no audio track extracted)"))
    print(f"manifest: {csv_path}")


if __name__ == "__main__":
    main()
