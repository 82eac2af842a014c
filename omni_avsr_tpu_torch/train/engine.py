"""OmniEngine: the training and evaluation steps around OmniAVSR (port of
the train/eval half of `omni_avsr_tpu/train/engine.py`).

The engine owns the trainable/frozen split (f32 masters, compute in the
model's dtype), the AdamW state and the random streams. Per step it
samples one matryoshka rate per modality on the host, as the reference
does with `random.choice` (`modeling_OmniAVSR.py:474, 549`), preprocesses
the batch on the device (train-mode augmentation when `augment`), runs the
three task forwards (`OmniAVSR.train_losses`), backpropagates their mean
into the masters and applies AdamW with the global-norm clip.

The single-task steps of the Llama-AVSR baselines (`single_train_step`,
`single_eval_step`) take one task's loss at every matryoshka rate combo
and average it (Llama-MTSK). `inference_only=True` builds no optimizer:
the trainable leaves stay in f32 without grads or AdamW moments, for
evaluation and serving.

`augment=False` trains on the decode-time computation end to end: eval
preprocessing, eval-mode BN and no dropout (the JAX package's setting for
its WER probe, `benchmarks/wer_probe.py`). `decode_batch` decodes a test
batch through `serve.py`'s decode body, with babble mixed at a fixed SNR
when `decode_snr_target` is set (the reference's noise-robustness
evaluation).
`conv_kernel=True` runs the ResNet trunk's convs through the fused conv
B7, as the JAX package's `OMNI_CONV_KERNEL=1` does in its train step too
(the raw convs of train-mode BN; the frozen trunk takes no grad).
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..models.omni import OmniAVSR
from ..ops.augment import audio_pipeline, video_pipeline
from .optim import make_optimizer
from .state import (
    TrainState,
    cast_trainable,
    master_weights,
    merge_params,
    split_params,
    tree_leaves,
    tree_map,
)


class OmniEngine:
    def __init__(
        self,
        model: OmniAVSR,
        params: Dict[str, Any],
        train_cfg: TrainConfig,
        steps_per_epoch: float = 1000.0,
        unfrozen_modules: Tuple[str, ...] = ("peft_llm", "lora_avhubert"),
        noise_bank: Optional[np.ndarray] = None,
        decode_snr_target: Optional[float] = None,
        seed: int = 42,
        inference_only: bool = False,
        augment: bool = True,
        device="cuda",
        conv_kernel: bool = False,
    ):
        self.model = model
        self.conv_kernel = conv_kernel
        self.cfg = model.cfg
        self.train_cfg = train_cfg
        self.device = torch.device(device)
        self.augment = augment
        self.noise_bank = (torch.as_tensor(noise_bank, device=self.device)
                           if noise_bank is not None else None)
        # babble mixed at this fixed SNR into decode_batch's audio (None: clean)
        self.decode_snr_target = decode_snr_target
        self.last_decode_steps = 0  # decode steps of the last decode_batch
        self._py_rng = random.Random(seed)
        # augmentation, dropout and layerdrop draws (on the device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        trainable, frozen = split_params(params, model.trainable_predicate(unfrozen_modules))
        self.frozen = tree_map(lambda x: x.detach().to(self.device), frozen)
        if inference_only:
            # no optimizer: f32 trainable leaves without grads or AdamW moments
            # (`omni_avsr_tpu/train/engine.py:86-98`)
            self.tx = self.schedule = None
            self.state = TrainState(0, tree_map(lambda x: x.detach().to(
                device=self.device, dtype=torch.float32), trainable), None)
        else:
            self.tx, self.schedule = make_optimizer(train_cfg, steps_per_epoch)
            masters = master_weights(trainable, self.device)
            self.state = TrainState(0, masters, self.tx.init(list(tree_leaves(masters))))

    def _params(self) -> Dict[str, Any]:
        """The merged tree: masters cast to the compute dtype (in the graph)."""
        return merge_params(cast_trainable(self.state.trainable, self.model.dtype), self.frozen)

    def _preprocess(self, batch: Dict[str, torch.Tensor], train: bool) -> Dict[str, torch.Tensor]:
        out = dict(batch)
        train = train and self.augment
        g = self.generator if train else None
        if "video" in batch:
            out["video"] = video_pipeline(batch["video"], batch["video_len"], train=train,
                                          generator=g)
        if "audio" in batch:
            out["audio"] = audio_pipeline(batch["audio"], batch["audio_len"], train=train,
                                          generator=g, noise_bank=self.noise_bank)
        return out

    def _loss(self, batch: Dict[str, torch.Tensor], rate_a: int, rate_v: int, trim_len: int,
             is_train: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(mean of the three task losses, each task's loss) on a batch
        already on the device (`omni_avsr_tpu/train/engine.py:151-163`)."""
        proc = self._preprocess(batch, train=is_train)
        mode = is_train and self.augment
        losses = self.model.train_losses(self._params(), proc, rate_a, rate_v, trim_len,
                                         train_mode=mode,
                                         generator=self.generator if mode else None,
                                         conv_kernel=self.conv_kernel)
        total = (losses["audio"] + losses["video"] + losses["audiovisual"]) / 3.0
        return total, losses

    def _arrays(self, batch: Dict[str, Any]) -> Tuple[Dict[str, torch.Tensor], int]:
        batch = dict(batch)
        trim = int(batch.pop("audio_trim_len", 1500))
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()
                if not isinstance(v, (int, list))}, trim

    def sample_rates(self) -> Tuple[int, int]:
        """Uniform random rate per step per modality (`:474, 549`)."""
        return (self._py_rng.choice(self.cfg.audio_rates),
                self._py_rng.choice(self.cfg.video_rates))

    def _update(self, total: torch.Tensor) -> torch.Tensor:
        """Backpropagate `total` into the masters, then the clip + AdamW step."""
        if self.tx is None:
            raise RuntimeError("an inference_only engine holds no optimizer")
        leaves = list(tree_leaves(self.state.trainable))
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        # a leaf this step did not use (the other rates' projectors) has a
        # zero grad, as under jax.grad: AdamW still decays it and its moments
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        opt_state = self.tx.update_(leaves, grads, self.state.opt_state)
        self.state = TrainState(self.state.step + 1, self.state.trainable, opt_state)
        return total.detach()

    def train_step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One optimizer step; returns the loss (a device scalar)."""
        rate_a, rate_v = self.sample_rates()
        arrays, trim = self._arrays(batch)
        total, _ = self._loss(arrays, rate_a, rate_v, trim, is_train=True)
        return self._update(total)

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        rate_a, rate_v = self.sample_rates()
        arrays, trim = self._arrays(batch)
        return self._loss(arrays, rate_a, rate_v, trim, is_train=False)

    def _rate_combos(self, modality: str) -> List[Tuple[Optional[int], Optional[int]]]:
        """The rate pairs of the baseline's loss: every rate of the task's
        modality, or the video x audio cross product for AVSR; the first
        pair only without matryoshka (`modeling_LlamaAVSR.py:244-251,
        317-332`; `omni_avsr_tpu/train/engine.py:184-195`)."""
        cfg = self.cfg
        if not cfg.is_matryoshka:
            return [(cfg.audio_rates[0], cfg.video_rates[0])]
        if modality == "audio":
            return [(ra, None) for ra in cfg.audio_rates]
        if modality == "video":
            return [(None, rv) for rv in cfg.video_rates]
        return [(ra, rv) for rv in cfg.video_rates for ra in cfg.audio_rates]

    def _single_loss(self, batch: Dict[str, torch.Tensor], modality: str, trim_len: int,
                     is_train: bool) -> torch.Tensor:
        """The Llama-AVSR / Llama-MTSK loss of one batch: the mean of
        `single_task_loss` over every rate combo (`omni_avsr_tpu/train/
        engine.py:197-214`). The encoders run once for all the combos (each
        combo compresses the same features at its rates), and their BN runs
        on batch statistics when `is_train`, as there; dropout, layerdrop
        and augmentation draw from the engine's generator when `is_train`
        and `augment` (the JAX step runs AV-HuBERT without dropout here)."""
        draw = is_train and self.augment
        proc = self._preprocess(batch, train=is_train)
        params = self._params()
        feats = self.model.task_features(params, proc, modality, trim_len, train_mode=is_train,
                                         generator=self.generator if draw else None,
                                         conv_kernel=self.conv_kernel)
        combos = self._rate_combos(modality)
        total = sum(self.model.single_task_loss(params, proc, modality, feats, ra, rv)
                    for ra, rv in combos)
        return total / len(combos)

    def single_train_step(self, batch: Dict[str, Any], modality: str) -> torch.Tensor:
        """One optimizer step of the single-task baseline on `modality`;
        returns the loss (a device scalar)."""
        arrays, trim = self._arrays(batch)
        return self._update(self._single_loss(arrays, modality, trim, is_train=True))

    @torch.no_grad()
    def single_eval_step(self, batch: Dict[str, Any], modality: str) -> torch.Tensor:
        arrays, trim = self._arrays(batch)
        return self._single_loss(arrays, modality, trim, is_train=False)

    def decode_batch(self, params: Dict[str, Any], batch: Dict[str, Any], modality: str,
                     rate_a: Optional[int] = None, rate_v: Optional[int] = None,
                     num_beams: Optional[int] = None, max_new: Optional[int] = None) -> List[str]:
        """Decoded transcripts of a padded (test) batch
        (`omni_avsr_tpu/train/engine.py:330-356`): eval preprocessing with
        the engine's noise bank mixed at `decode_snr_target` (its offsets
        from the engine's generator), then `Transcriber`'s decode body on
        `params` (e.g. `merged_params()`, or a quantised serving tree).
        `batch` holds numpy arrays and may carry "audio_trim_len" (else
        1500) and "gold_text"; rates default to each modality's first."""
        from ..serve import decode_padded, ids_to_texts

        trim = int(batch.get("audio_trim_len", 1500))
        arrays = {k: v for k, v in batch.items() if k not in ("gold_text", "audio_trim_len")}
        out = decode_padded(
            self.model, params, arrays, modality, rate_a or self.cfg.audio_rates[0],
            rate_v or self.cfg.video_rates[0], trim,
            self.cfg.num_beams if num_beams is None else num_beams,
            self.cfg.max_dec_tokens if max_new is None else max_new, self.device,
            conv_kernel=self.conv_kernel, noise_bank=self.noise_bank,
            snr_target=self.decode_snr_target, generator=self.generator)
        self.last_decode_steps = out.steps
        return ids_to_texts(self.model.tok, out.tokens)

    def merged_params(self) -> Dict[str, Any]:
        """The full tree for serving: masters in the compute dtype, detached."""
        return merge_params(tree_map(lambda x: x.detach().to(self.model.dtype),
                                     self.state.trainable), self.frozen)
