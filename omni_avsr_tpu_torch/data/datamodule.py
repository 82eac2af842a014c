"""DataModule: train, validation and test batch iterators with background
prefetch (port of `omni_avsr_tpu/data/datamodule.py`; reference
`datamodule/data_module.py:147-243`).

A thread pool loads clips while the card computes, and one producer
thread collates them, keeping a few batches in flight. The threads hand
over numpy batches only and touch no CUDA state: the engine moves each
batch to the device (`train/engine.py`). Training batches are re-bucketed
every epoch with the epoch as the shuffle seed (the reference reloads its
dataloaders every epoch, `train_OmniAVSR.py:51`).

Frame budgets per modality follow the reference (`data_module.py:168-173`);
validation packs up to 1000 frames in one bucket (`:214-216`).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

from ..config import DataConfig
from .batching import CollateConfig, bucket_batches, collate
from .dataset import AVDataset
from .tokenizer import TokenizerBundle


class DataModule:
    def __init__(self, cfg: DataConfig, tok: TokenizerBundle, modality: str = "audiovisual",
                 downsample_video: Optional[int] = None):
        self.cfg = cfg
        self.tok = tok
        self.modality = modality
        self.downsample_video = downsample_video

    def _max_frames(self) -> int:
        return {"audio": self.cfg.max_frames_audio, "video": self.cfg.max_frames_video,
                "audiovisual": self.cfg.max_frames_audiovisual}[self.modality]

    def _dataset(self, label_file: str) -> AVDataset:
        return AVDataset(self.cfg.root_dir, label_file, self.modality,
                         downsample_video=self.downsample_video)

    def _lengths(self, ds: AVDataset) -> List[int]:
        # manifests give 25 fps frame counts for every modality; a manifest
        # of sample counts (values above any plausible frame count) is read
        # as audio samples at 640 per frame
        if self.modality == "audio" and ds.input_lengths and max(ds.input_lengths) > 16000:
            return [max(1, n // 640) for n in ds.input_lengths]
        return ds.input_lengths

    def _train_plan(self, epoch: int):
        ds = self._dataset(self.cfg.train_file)
        return ds, bucket_batches(self._lengths(ds), self._max_frames(),
                                  self.cfg.train_num_buckets, shuffle=True, seed=epoch)

    def train_batches(self, epoch: int) -> Iterator[Dict]:
        ds, batches = self._train_plan(epoch)
        return _prefetch_iter(ds, batches, self.tok, CollateConfig(modality=self.modality),
                              self.cfg.num_workers)

    def val_batches(self) -> Iterator[Dict]:
        ds = self._dataset(self.cfg.val_file)
        batches = bucket_batches(self._lengths(ds), 1000, 1, shuffle=False)
        return _prefetch_iter(ds, batches, self.tok, CollateConfig(modality=self.modality),
                              self.cfg.num_workers)

    def test_batches(self, batch_size: int = 1) -> Iterator[Dict]:
        """One clip per batch (the reference's evaluation), or `batch_size`
        clips grouped by length, which the masked decode prefix decodes
        with the same per-clip semantics."""
        ds = self._dataset(self.cfg.test_file)
        if batch_size <= 1:
            batches = [[i] for i in range(len(ds))]
        else:
            order = sorted(range(len(ds)), key=lambda i: ds.input_lengths[i])
            batches = [order[i:i + batch_size] for i in range(0, len(order), batch_size)]
        return _prefetch_iter(ds, batches, self.tok,
                              CollateConfig(modality=self.modality, is_trainval=False),
                              self.cfg.num_workers)

    def steps_per_epoch(self) -> int:
        return len(self._train_plan(0)[1])


def _prefetch_iter(ds: AVDataset, batches: List[List[int]], tok: TokenizerBundle,
                   ccfg: CollateConfig, num_workers: int, depth: int = 4) -> Iterator[Dict]:
    """Yield the collated batches in order, loading clips on a pool of
    `num_workers` threads and keeping up to `depth` batches ready. A loader
    error is raised to the consumer; a consumer that stops early stops the
    producer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()
    closed = threading.Event()

    def put(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer(pool: ThreadPoolExecutor):
        try:
            for b in batches:
                if not put(collate(list(pool.map(ds.__getitem__, b)), tok, ccfg)):
                    return
            put(stop)
        except Exception as e:  # handed to the consumer, which raises it
            put(e)

    pool = ThreadPoolExecutor(max_workers=max(1, num_workers))
    thread = threading.Thread(target=producer, args=(pool,), daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        closed.set()
        thread.join(timeout=10.0)
        pool.shutdown(wait=False)
