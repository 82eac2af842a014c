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

Parallelism (`parallel/`): with `mesh` (a `DeviceMesh`, one rank per
device) the engine keeps this rank's slice of every leaf
(`llm_partition_specs`: the LLM over tp, over dp too with `fsdp`, the
expert weights over ep; `pipeline`'s layer slice over pp) and computes
the JAX package's global step. Each rank takes its rows of the global
batch (`cli/common.py::setup_parallelism`'s feed); the CE means are over
the global token count, the ResNet's BN over the global batch, every
random draw the global batch's draw sliced to the rank's rows; the
gradients of the replicated leaves are broadcast from pipeline stage 0
and summed over dp (FSDP leaves' are reduce-scattered by their per-layer
all-gather), then the clip takes the norm of the whole tree and AdamW
updates each rank's shards. `full_state` / `load_state` move between the
shards and the tree one process holds (checkpoints).
"""

from __future__ import annotations

import functools
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
from ..parallel import collectives as par
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
        mesh=None,
        fsdp: bool = False,
        sequence_parallel: bool = False,
        pipeline=None,
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
        # a tp mesh whose heads B1 shards: decode_batch's fused selection then
        # runs per vocabulary shard (`serve.py::Transcriber(mesh=...)` keeps
        # its own; the JAX engine's `decode_attn_mesh`)
        self.decode_attn_mesh = None
        self._py_rng = random.Random(seed)
        # augmentation, dropout and layerdrop draws: a generator on the
        # device, or the JAX engine's threefry key (`train/engine.py:72-81`)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._rng_key = threefry.PRNGKey(seed) if prng == "threefry" else None
        self.mesh, self.pipeline, self.par, self._fsdp_rest = mesh, pipeline, None, None
        pred = model.trainable_predicate(unfrozen_modules)
        if mesh is not None:
            params = self._shard(params, fsdp, sequence_parallel, pred)
        trainable, frozen = split_params(params, pred)
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

    def _shard(self, params, fsdp: bool, sequence_parallel: bool, pred):
        """This rank's slices of `params` under the mesh, with the spec trees
        of the trainable and frozen leaves and the step's `Parallel`
        (`omni_avsr_tpu/cli/common.py:281-320`: only the LLM shards in
        training)."""
        from ..parallel.mesh import axis
        from ..parallel.partitioning import (clamp_specs_to_shapes, coherent_specs,
                                             llm_partition_specs, shard_params)
        from ..parallel.pipeline import pipeline_layer_specs

        mesh, llm = self.mesh, params["llm"]
        if sequence_parallel:
            assert axis(mesh, "tp").size > 1, "--sequence-parallel needs --mesh-tp > 1"
        specs = llm_partition_specs(llm, fsdp=fsdp, ep=axis(mesh, "ep").size > 1)
        if self.pipeline is not None:
            specs["layers"] = pipeline_layer_specs(llm["layers"])
        tp = axis(mesh, "tp").size
        heads_divide = self.cfg.llm.num_heads % tp == 0 and self.cfg.llm.num_kv_heads % tp == 0
        specs, blocks = coherent_specs(clamp_specs_to_shapes(mesh, llm, specs), "llm",
                                       replicate=() if heads_divide else ("llm.attn",))
        tree_specs = {k: (specs if k == "llm" else tree_map(lambda x: (), v)
                          if isinstance(v, dict) else ()) for k, v in params.items()}
        self.specs, self.frozen_specs = split_params(tree_specs, pred)
        self.specs = self.specs or {}
        self.par = par.Parallel.of(mesh, blocks, sequence_parallel,
                                   specs["layers"] if fsdp else None)
        self._fsdp_rest = ({k: v for k, v in specs.items() if k != "layers"} if fsdp else None)
        return shard_params(mesh, params, tree_specs)

    def _params(self) -> Dict[str, Any]:
        """The merged tree: masters cast to the compute dtype (in the graph);
        under FSDP the LLM's leaves outside the layer stack all-gathered
        (the layers' are gathered per layer, `models/llm.py`)."""
        merged = merge_params(cast_trainable(self.state.trainable, self.model.dtype), self.frozen)
        if self._fsdp_rest is not None:
            llm = dict(merged["llm"])
            for k, spec in self._fsdp_rest.items():
                llm[k] = par.fsdp_gather(llm[k], spec)
            merged = {**merged, "llm": llm}
        return merged

    def _rows(self, batch: Dict[str, torch.Tensor]):
        """This rank's (first row, global batch) for the step's draws."""
        if self.par is None:
            return
        B = next(v.shape[0] for v in batch.values() if isinstance(v, torch.Tensor) and v.dim())
        dp = self.par.dp
        self.par.rows = (dp.rank * B, dp.size * B) if dp.active else None

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
            bn_stats=self.bn_stats, pipeline=self.pipeline)
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
        """Backpropagate `total` into the masters, then the clip + AdamW step.
        Returns the loss (summed over dp: each rank's is its share)."""
        if self.tx is None:
            raise RuntimeError("an inference_only engine holds no optimizer")
        leaves = list(tree_leaves(self.state.trainable))
        extra = []
        if self.pipeline is not None:
            from ..parallel.pipeline import anchors

            extra = anchors()
        grads = torch.autograd.grad(total, leaves + extra, allow_unused=True)[:len(leaves)]
        # a leaf this step did not use (the other rates' projectors) has a
        # zero grad, as under jax.grad: AdamW still decays it and its moments
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        sq_norm = None
        if self.par is not None:
            from ..parallel.pipeline import drain

            drain()
            specs = list(tree_leaves(self.specs))
            grads = par.reduce_grads(grads, specs, self.par)
            sq_norm = functools.partial(self._sq_norm, specs=specs)
        opt_state = self.tx.update_(leaves, grads, self.state.opt_state, sq_norm=sq_norm)
        self.state = TrainState(self.state.step + 1, self.state.trainable, opt_state)
        return par.all_reduce(total.detach(), self.par.dp if self.par else None)

    def _sq_norm(self, grads: List[torch.Tensor], specs) -> torch.Tensor:
        """The squared global norm of a sharded tree: each rank's squares,
        each leaf's divided by the ranks that hold the same slice, summed
        over the world."""
        import torch.distributed as dist

        from ..parallel.mesh import mesh_sizes

        sizes = mesh_sizes(self.mesh)
        world = dist.get_world_size()
        total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for g, s in zip(grads, specs):
            shards = 1
            for ax in s:
                if ax is not None:
                    shards *= sizes.get(ax, 1)
            total = total + (g.float() * g.float()).sum() * (shards / world)
        dist.all_reduce(total)
        return total

    def train_step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One optimizer step; returns the loss (a device scalar)."""
        rate_a, rate_v = self.sample_rates()
        arrays, trim = self._arrays(batch)
        self._rows(arrays)
        with par.scope(self.par):
            total, _ = self._loss(arrays, rate_a, rate_v, trim, is_train=True,
                                  key=self._next_rng())
            return self._update(total)

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        rate_a, rate_v = self.sample_rates()
        arrays, trim = self._arrays(batch)
        self._rows(arrays)
        with par.scope(self.par):
            total, losses = self._loss(arrays, rate_a, rate_v, trim, is_train=False,
                                       key=self._next_rng())
            if self.par is None:
                return total, losses
            dp = self.par.dp
            return par.all_reduce(total, dp), {k: par.all_reduce(v, dp) for k, v in losses.items()}

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
                                                remat=self.remat, pipeline=self.pipeline)
                    for ra, rv in combos)
        return total / len(combos)

    def single_train_step(self, batch: Dict[str, Any], modality: str) -> torch.Tensor:
        """One optimizer step of the single-task baseline on `modality`;
        returns the loss (a device scalar)."""
        arrays, trim = self._arrays(batch)
        self._rows(arrays)
        with par.scope(self.par):
            return self._update(self._single_loss(arrays, modality, trim, is_train=True,
                                                  key=self._next_rng()))

    @torch.no_grad()
    def single_eval_step(self, batch: Dict[str, Any], modality: str) -> torch.Tensor:
        arrays, trim = self._arrays(batch)
        self._rows(arrays)
        with par.scope(self.par):
            loss = self._single_loss(arrays, modality, trim, is_train=False,
                                     key=self._next_rng())
            return par.all_reduce(loss, self.par.dp) if self.par is not None else loss

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
            no_repeat_ngram_size=no_repeat_ngram_size, attn_mesh=self.decode_attn_mesh)
        self.last_decode_steps = out.steps
        return ids_to_texts(self.model.tok, out.tokens)

    def merged_params(self) -> Dict[str, Any]:
        """The full tree for serving: masters in the compute dtype, detached
        (under a mesh gathered from every rank's slices: every rank then
        decodes the whole model)."""
        trainable = tree_map(lambda x: x.detach().to(self.model.dtype), self.state.trainable)
        frozen = self.frozen
        if self.par is not None:
            from ..parallel.partitioning import gather_params

            trainable = gather_params(self.mesh, trainable, self.specs)
            frozen = gather_params(self.mesh, frozen, self.frozen_specs)
        return merge_params(trainable, frozen)

    def full_state(self) -> TrainState:
        """The state one process holds: under a mesh the masters and AdamW
        moments gathered from every rank's slices (for checkpoints, which
        only the primary writes)."""
        if self.par is None:
            return self.state
        from ..parallel.partitioning import gather_params

        def whole(leaves):
            tree = _unflatten(self.state.trainable, leaves)
            return list(tree_leaves(gather_params(self.mesh, tree, self.specs)))

        st = self.state
        trainable = gather_params(self.mesh, tree_map(lambda x: x.detach(), st.trainable),
                                  self.specs)
        opt = st.opt_state
        if opt is not None:
            opt = type(opt)(opt.count, whole(opt.mu), whole(opt.nu))
        return TrainState(st.step, trainable, opt)

    def load_state(self, state: TrainState) -> None:
        """Install a state one process holds (`restore_checkpoint`): under a
        mesh each rank keeps its slices."""
        if self.par is not None:
            from ..parallel.partitioning import shard_params

            def mine(leaves):
                tree = _unflatten(state.trainable, leaves)
                return [x.to(self.device).contiguous() for x in
                        tree_leaves(shard_params(self.mesh, tree, self.specs))]

            opt = state.opt_state
            if opt is not None:
                opt = type(opt)(opt.count, mine(opt.mu), mine(opt.nu))
            trainable = shard_params(self.mesh, state.trainable, self.specs)
            trainable = master_weights(trainable, self.device)
            state = TrainState(state.step, trainable, opt)
        self.state = state


def _unflatten(template: Dict[str, Any], leaves: List[torch.Tensor]) -> Dict[str, Any]:
    """`leaves` (in `tree_leaves` order) in the structure of `template`."""
    it = iter(leaves)

    def build(node):
        return {k: build(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}

    return build(template)
