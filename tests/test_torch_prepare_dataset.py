"""The port's preparation CLIs against the JAX package's, run on raw trees in
`tmp_path` (`--device cpu`, `--detector center`):

  - `preprocess_video`: the ROI array within the warp's bound (one gray
    level, >= 99.9% of pixels equal) and the same one-row manifest;
  - `prepare_dataset` on 4 raw clips, one of them long enough to be cut at
    its word gaps (`--max-clip-seconds`): the same manifests and splits
    line for line, bit-equal wavs, each ROI array within the warp's bound;
  - `make_noise` babble, musan-babble and split: bit-equal files.

Both packages write `.npy` here: OpenCV's mp4 writer is stubbed out, so
the ROIs are compared before any lossy encoding.
"""

import os
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")


class _NoWriter:
    def __init__(self, *a, **k):
        pass

    def isOpened(self):
        return False


@pytest.fixture(autouse=True)
def npy_writers(monkeypatch):
    monkeypatch.setattr(cv2, "VideoWriter", _NoWriter)


def _write_clip(root: Path, name: str, frames: int, seed: int, words=None):
    from omni_avsr_tpu_torch.data.synthetic import _write_wav

    rng = np.random.RandomState(seed)
    np.save(root / f"{name}.npy", rng.randint(0, 256, (frames, 120, 120, 3), dtype=np.uint8))
    _write_wav(str(root / f"{name}.wav"), (rng.randn(frames * 640) * 0.1).astype(np.float32))
    with open(root / f"{name}.txt", "w") as f:
        f.write(f"Text:  hello world {seed}\nConf:  4\n")
        if words:
            f.write("\nWORD START END ASDSCORE\n")
            f.writelines(f"{w} {s:.2f} {e:.2f} 1.0\n" for w, s, e in words)


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _assert_rois_close(a: np.ndarray, b: np.ndarray):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def _assert_trees_match(ours: Path, theirs: Path):
    assert _files(ours) == _files(theirs)
    for rel in _files(theirs):
        a, b = ours / rel, theirs / rel
        if rel.endswith(".npy"):
            _assert_rois_close(np.load(a), np.load(b))
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def test_preprocess_video_matches_jax(tmp_path, capsys):
    from omni_avsr_tpu.cli.preprocess_video import main as jax_main
    from omni_avsr_tpu_torch.cli.preprocess_video import main

    _write_clip(tmp_path, "clip", 20, seed=1)
    argv = ["--path-to-input-video", str(tmp_path / "clip.npy"), "--transcription", "HELLO",
            "--detector", "center"]
    # the manifest names the output directory: the same name for both
    jax_main(argv + ["--out-dir", str(tmp_path / "jax" / "out")])
    main(argv + ["--out-dir", str(tmp_path / "port" / "out"), "--device", "cpu"])
    _assert_trees_match(tmp_path / "port", tmp_path / "jax")
    rois = np.load(tmp_path / "port" / "out" / "clip_preprocessed.npy")
    assert rois.shape == (20, 96, 96)
    assert ((tmp_path / "port" / "out" / "test_file.csv").read_text()
            == "out,clip_preprocessed.npy,20,0,HELLO\n")
    out = capsys.readouterr().out
    assert out.count("manifest:") == 2


def test_preprocess_video_short_clip_and_no_card(tmp_path):
    import torch

    from omni_avsr_tpu_torch.cli.preprocess_video import main

    _write_clip(tmp_path, "short", 8, seed=2)
    argv = ["--path-to-input-video", str(tmp_path / "short.npy"), "--detector", "center"]
    with pytest.raises(SystemExit, match="no usable landmarks"):
        main(argv + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(argv)


def test_prepare_dataset_matches_jax(tmp_path):
    from omni_avsr_tpu.cli.prepare_dataset import main as jax_main
    from omni_avsr_tpu_torch.cli.prepare_dataset import main
    from omni_avsr_tpu_torch.data.dataset import AVDataset

    raw = tmp_path / "raw"
    raw.mkdir()
    for i in range(3):
        _write_clip(raw, f"clip{i}", 14 + i, seed=i)
    # 1.2 s of words with a 0.5 s gap: two segments at --max-clip-seconds 1
    _write_clip(raw, "long", 40, seed=9, words=[("AB", 0.0, 0.3), ("CD", 0.3, 0.5),
                                               ("EF", 1.0, 1.2)])
    common = ["--input-dir", str(raw), "--dataset-name", "synthp", "--num-workers", "2",
              "--splits", "train:0.6", "val:0.2", "test:0.2", "--detector", "center",
              "--max-clip-seconds", "1"]
    jax_main(common + ["--output-dir", str(tmp_path / "jax")])
    main(common + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    _assert_trees_match(tmp_path / "port", tmp_path / "jax")
    rows = [line for s in ("train", "val", "test")
            for line in (tmp_path / "port" / f"{s}.csv").read_text().splitlines()]
    assert len(rows) == 5  # 3 whole clips + the long one's 2 segments
    assert any(r.endswith(",AB CD") for r in rows) and any(r.endswith(",EF") for r in rows)
    sample = AVDataset(str(tmp_path / "port"), str(tmp_path / "port" / "train.csv"),
                       "audiovisual")[0]
    assert sample["video"].shape[1:3] == (96, 96)
    assert len(sample["audio"]) == len(sample["video"]) * 640


def _tone(path: Path, seconds: float, freq: float):
    from omni_avsr_tpu_torch.preprocess.noise_prep import SR, write_wav_int16

    t = np.arange(int(seconds * SR)) / SR
    return write_wav_int16(str(path), (8000 * np.sin(2 * np.pi * freq * t)).astype(np.int16))


@pytest.mark.parametrize("mode", ["babble", "musan-babble", "split"])
def test_make_noise_matches_jax(tmp_path, mode):
    from omni_avsr_tpu.cli.make_noise import main as jax_main
    from omni_avsr_tpu_torch.cli.make_noise import main

    src = tmp_path / "src"
    src.mkdir()
    if mode == "babble":
        for i in range(4):
            _tone(src / f"clip{i}.wav", 1.5 + 0.25 * i, 100 + 37 * i)
        _tone(src / "short.wav", 0.5, 999)

        def argv(out):
            return ["babble", "--input-dir", str(src), "--output", str(out / "noise.wav"),
                    "--num-per-mixture", "3", "--min-seconds", "1.0", "--seed", "3"]
    elif mode == "musan-babble":
        for spk in range(10):
            for j in range(2):
                _tone(src / f"speech-en-{spk:03d}-{j:04d}.wav", 0.5 + 0.1 * j, 100 + 13 * spk)

        def argv(out):
            return ["musan-babble", "--input-dir", str(src), "--output-dir", str(out),
                    "--num-per-mixture", "3", "--num-train", "3", "--num-valid", "2",
                    "--num-test", "2", "--seed", "1"]
    else:
        for i in range(3):
            _tone(src / f"noise{i}.wav", 0.7 + 0.9 * i, 200 + 50 * i)

        def argv(out):
            return ["split", "--input-dir", str(src), "--output-dir", str(out), "--seconds", "0.5"]

    jax_main(argv(tmp_path / "jax"))
    main(argv(tmp_path / "port"))
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    assert _files(ours) == _files(theirs) and _files(ours)
    for rel in _files(theirs):
        a, b = (ours / rel).read_bytes(), (theirs / rel).read_bytes()
        if rel.endswith(".tsv"):  # absolute paths of the output, one per line
            a, b = a.replace(bytes(ours), b""), b.replace(bytes(theirs), b"")
        assert a == b, rel
    assert os.path.getsize(next(ours.rglob("*.wav"))) > 44
