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

The JAX package's numerics switches are arguments here (the CLIs read its
`OMNI_*` variables through `utils/profiles.py`):
  - `prng`: "threefry" keeps a threefry key, `PRNGKey(seed)`, split per
    train, eval and decode call as the JAX engine splits it (`_next_rng`,
    then `k_aug, k_drop = split(rng)` in a train step and `kv, ka =
    split(k_aug)` in the preprocessing), so the step draws the JAX
    package's masks, crops and noise under its `OMNI_PRNG=threefry`;
    "torch" (the default) draws from a `torch.Generator`, the counterpart
    of the JAX package's default "rbg" streams: the same distributions,
    not the same bits;
  - `bn_stats`: the ResNet's train-mode BN variance, "onepass" (default)
    or "twopass" (`OMNI_BN_STATS`);
  - `remat`: the remat policy of the LLM's and AV-HuBERT's layers, "dots"
    (default), "off" or "full" (`OMNI_REMAT`);
  - `decode_attn_route` and `decode_select_mode`: `decode_batch`'s
    attention route and candidate selection (`OMNI_BEAM_ATTN`,
    `OMNI_BEAM_SELECT`); `select_kernel` its selection statistics through
    B5 where the vocabulary allows (`OMNI_SELECT_KERNEL=1`).
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..decode.decoding import select_kernel_supported
from ..models.llm import check_remat
from ..models.omni import OmniAVSR
from ..models.resnet3d import BN_STATS
from ..ops.augment import audio_pipeline, video_pipeline
from ..utils import prng as threefry
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
        prng: str = "torch",
        bn_stats: str = "onepass",
        remat: str = "dots",
        decode_attn_route: Optional[str] = None,
        decode_select_mode: str = "fused",
        select_kernel: bool = False,
    ):
        if prng not in ("torch", "threefry"):
            raise ValueError(f"prng {prng!r}: 'torch' or 'threefry'")
        if bn_stats not in BN_STATS:
            raise ValueError(f"bn_stats {bn_stats!r}: one of {BN_STATS}")
        self.model = model
        self.conv_kernel = conv_kernel
        self.bn_stats = bn_stats
        self.remat = check_remat(remat)
        self.decode_attn_route = decode_attn_route
        self.decode_select_mode = decode_select_mode
        # decode_batch's selection statistics through B5 where the vocabulary
        # allows it, as the JAX package gates its OMNI_SELECT_KERNEL=1
        self.select_kernel = select_kernel and select_kernel_supported(model.cfg.llm.vocab_size)
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
        # augmentation, dropout and layerdrop draws: a generator on the
        # device, or the JAX engine's threefry key (`train/engine.py:72-81`)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._rng_key = threefry.PRNGKey(seed) if prng == "threefry" else None
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

    def _next_rng(self) -> Optional[torch.Tensor]:
        """The call's key, `self._rng_key, k = split(self._rng_key)` (the JAX
        engine's `_next_rng`); None with torch generators."""
        if self._rng_key is None:
            return None
        self._rng_key, key = threefry.split(self._rng_key)
        return key

    def _preprocess(self, batch: Dict[str, torch.Tensor], train: bool,
                    key: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The pipelines of `ops/augment.py` (`omni_avsr_tpu/train/engine.py:
        131-145`): train mode when `train` and `augment`, else eval mode
        with babble at `decode_snr_target` when the engine has a noise bank;
        the draws from `key` (`kv, ka = split(key)`) or the generator."""
        out = dict(batch)
        train = train and self.augment
        if key is not None:
            kv, ka = threefry.split(key)
        else:
            kv = ka = self.generator
        if "video" in batch:
            out["video"] = video_pipeline(batch["video"], batch["video_len"], train=train,
                                          generator=kv if train else None)
        if "audio" in batch:
            out["audio"] = audio_pipeline(batch["audio"], batch["audio_len"], train=train,
                                          generator=ka, noise_bank=self.noise_bank,
                                          snr_target=None if train else self.decode_snr_target)
        return out

    def _loss(self, batch: Dict[str, torch.Tensor], rate_a: int, rate_v: int, trim_len: int,
              is_train: bool, key: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(mean of the three task losses, each task's loss) on a batch
        already on the device (`omni_avsr_tpu/train/engine.py:151-163`);
        with a threefry `key`, `k_aug, k_drop = split(key)` draw the
        augmentation and AV-HuBERT's dropout."""
        k_aug = k_drop = None
        if key is not None:
            k_aug, k_drop = threefry.split(key)
        proc = self._preprocess(batch, train=is_train, key=k_aug)
        mode = is_train and self.augment
        losses = self.model.train_losses(
            self._params(), proc, rate_a, rate_v, trim_len, train_mode=mode, remat=self.remat,
            generator=self.generator if mode and key is None else None,
            conv_kernel=self.conv_kernel, dropout_rng=k_drop if mode else None,
            bn_stats=self.bn_stats)
        total = (losses["audio"] + losses["video"] + losses["audiovisual"]) / 3.0
        return total, losses

    def _arrays(self, batch: Dict[str, Any]) -> Tuple[Dict[str, torch.Tensor], int]:
        """The batch's arrays on the device (numpy arrays, or tensors on the
        host or already on the device, e.g. from `utils/prefetch.py`) and
        its Whisper trim."""
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
        total, _ = self._loss(arrays, rate_a, rate_v, trim, is_train=True, key=self._next_rng())
        return self._update(total)

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        rate_a, rate_v = self.sample_rates()
        arrays, trim = self._arrays(batch)
        return self._loss(arrays, rate_a, rate_v, trim, is_train=False, key=self._next_rng())

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
                     is_train: bool, key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The Llama-AVSR / Llama-MTSK loss of one batch: the mean of
        `single_task_loss` over every rate combo (`omni_avsr_tpu/train/
        engine.py:197-214`). The encoders run once for all the combos (each
        combo compresses the same features at its rates), and their BN runs
        on batch statistics when `is_train`, as there. With a threefry
        `key` the preprocessing draws from it whole and AV-HuBERT runs
        without dropout, as the JAX step does; with the generator, dropout,
        layerdrop and augmentation draw from it when `is_train` and
        `augment`."""
        draw = is_train and self.augment and key is None
        proc = self._preprocess(batch, train=is_train, key=key)
        params = self._params()
        feats = self.model.task_features(params, proc, modality, trim_len, train_mode=is_train,
                                         generator=self.generator if draw else None,
                                         conv_kernel=self.conv_kernel, bn_stats=self.bn_stats,
                                         remat=self.remat)
        combos = self._rate_combos(modality)
        total = sum(self.model.single_task_loss(params, proc, modality, feats, ra, rv,
                                                remat=self.remat)
                    for ra, rv in combos)
        return total / len(combos)

    def single_train_step(self, batch: Dict[str, Any], modality: str) -> torch.Tensor:
        """One optimizer step of the single-task baseline on `modality`;
        returns the loss (a device scalar)."""
        arrays, trim = self._arrays(batch)
        return self._update(self._single_loss(arrays, modality, trim, is_train=True,
                                              key=self._next_rng()))

    @torch.no_grad()
    def single_eval_step(self, batch: Dict[str, Any], modality: str) -> torch.Tensor:
        arrays, trim = self._arrays(batch)
        return self._single_loss(arrays, modality, trim, is_train=False, key=self._next_rng())

    def decode_batch(self, params: Dict[str, Any], batch: Dict[str, Any], modality: str,
                     rate_a: Optional[int] = None, rate_v: Optional[int] = None,
                     num_beams: Optional[int] = None, max_new: Optional[int] = None,
                     attn_route: Optional[str] = None, select_mode: Optional[str] = None,
                     no_repeat_ngram_size: int = 0) -> List[str]:
        """Decoded transcripts of a padded (test) batch
        (`omni_avsr_tpu/train/engine.py:330-356`): eval preprocessing with
        the engine's noise bank mixed at `decode_snr_target` (its offsets
        from the engine's generator, or with threefry from the call's key
        `ka` of `kv, ka = split(key)`, the JAX engine's segment), then
        `Transcriber`'s decode body on `params` (e.g. `merged_params()`, or
        a quantised serving tree), on the attention route and selection of
        the arguments, else the engine's `decode_attn_route` and
        `decode_select_mode`. `batch` holds numpy arrays and may carry
        "audio_trim_len" (else 1500) and "gold_text"; rates default to each
        modality's first."""
        from ..serve import decode_padded, ids_to_texts

        trim = int(batch.get("audio_trim_len", 1500))
        arrays = {k: v for k, v in batch.items() if k not in ("gold_text", "audio_trim_len")}
        key = self._next_rng()
        rng = threefry.split(key)[1] if key is not None else self.generator
        out = decode_padded(
            self.model, params, arrays, modality, rate_a or self.cfg.audio_rates[0],
            rate_v or self.cfg.video_rates[0], trim,
            self.cfg.num_beams if num_beams is None else num_beams,
            self.cfg.max_dec_tokens if max_new is None else max_new, self.device,
            select_kernel=self.select_kernel, conv_kernel=self.conv_kernel,
            noise_bank=self.noise_bank, snr_target=self.decode_snr_target, generator=rng,
            attn_route=attn_route if attn_route is not None else self.decode_attn_route,
            select_mode=select_mode if select_mode is not None else self.decode_select_mode,
            no_repeat_ngram_size=no_repeat_ngram_size)
        self.last_decode_steps = out.steps
        return ids_to_texts(self.model.tok, out.tokens)

    def merged_params(self) -> Dict[str, Any]:
        """The full tree for serving: masters in the compute dtype, detached."""
        return merge_params(tree_map(lambda x: x.detach().to(self.model.dtype),
                                     self.state.trainable), self.frozen)
