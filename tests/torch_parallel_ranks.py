"""What the ranks of the port's multi-rank tests run (tests/test_torch_parallel*.py).

The functions here run inside `omni_avsr_tpu_torch.parallel.launch.RankPool`
ranks (gloo, one torch thread each); this module imports no JAX, so a rank
starts with torch and the port only. Each returns plain numpy data, rank 0's
whole result and None elsewhere unless it says otherwise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def flat(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, path))
        else:
            out[path] = (v.detach().float().numpy() if isinstance(v, torch.Tensor)
                         else np.asarray(v))
    return out


def numpy_tree(tree):
    """A tree of tensors as the nested numpy f32 tree the rank functions take."""
    return {k: numpy_tree(v) if isinstance(v, dict) else v.detach().float().numpy()
            for k, v in tree.items()}


def tiny_model(moe_experts: int = 0, routing: str = "balanced", kv_heads: Optional[int] = None,
               ffn: Optional[int] = None, vocab: Optional[int] = None):
    """The tiny flagship in f32; with `moe_experts` an MoE decoder routed by
    `routing`, with `kv_heads` kv heads, with an FFN width `ffn`, with a
    synthetic vocabulary of `vocab` tokens (a tree of a twin's shapes comes
    from `bridge.init_params`)."""
    import dataclasses

    from omni_avsr_tpu_torch.data.tokenizer import synthetic_tokenizer
    from omni_avsr_tpu_torch.models.omni import OmniAVSR, flagship

    pm = flagship(tiny=True, dtype=torch.float32, whisper_input_mode="bucket")
    if vocab is not None:
        tok = synthetic_tokenizer("llama", base_vocab=vocab - 7)  # and its 7 specials
        cfg = dataclasses.replace(pm.cfg, llm=dataclasses.replace(pm.cfg.llm, vocab_size=vocab))
        pm = OmniAVSR(cfg, tok, dtype=torch.float32)
    llm = pm.cfg.llm
    kw: Dict[str, Any] = {}
    if moe_experts:
        kw.update(moe_experts=moe_experts, moe_routing=routing)
    if kv_heads is not None:
        # the LoRA v up-projection's width is the kv width: hidden / v_out_divisor
        kw.update(num_kv_heads=kv_heads, lora=dataclasses.replace(
            llm.lora, v_out_divisor=llm.hidden_size // (kv_heads * llm.head_dim)))
    if ffn is not None:
        kw.update(intermediate_size=ffn)
    if kw:
        cfg = dataclasses.replace(pm.cfg, llm=dataclasses.replace(llm, **kw))
        pm = OmniAVSR(cfg, pm.tok, dtype=torch.float32)
    return pm


def make_mesh(**sizes):
    from omni_avsr_tpu_torch.config import MeshConfig
    from omni_avsr_tpu_torch.parallel.mesh import make_mesh as mk

    return mk(MeshConfig(**sizes))


def rank_rows(mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's dp rows of a global numpy batch (the CLIs' feed)."""
    from omni_avsr_tpu_torch.parallel.distributed import host_shard_slice
    from omni_avsr_tpu_torch.parallel.mesh import axis

    dp = axis(mesh, "dp")
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            out[k] = v[host_shard_slice(v.shape[0], dp.rank, dp.size)]
        else:
            out[k] = v
    return out


def train_steps(params_np, batch, mesh_sizes: Dict[str, int], steps: int = 1,
                moe_experts: int = 0, pp_microbatches: Optional[int] = None,
                single: Optional[str] = None, model: Optional[Dict[str, Any]] = None,
                **engine_kw):
    """`steps` optimizer steps of the tiny flagship (`tiny_model(moe_experts,
    **model)`) on `mesh_sizes`; returns (losses, the whole trainable tree
    after the steps) on rank 0."""
    import torch.distributed as dist

    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.config import TrainConfig
    from omni_avsr_tpu_torch.train.engine import OmniEngine

    mesh = make_mesh(**mesh_sizes)
    plan = None
    if pp_microbatches:
        from omni_avsr_tpu_torch.parallel.pipeline import PipelinePlan

        plan = PipelinePlan(mesh, num_microbatches=pp_microbatches, dp_axis="dp")
    pm = tiny_model(moe_experts, **(model or {}))
    engine = OmniEngine(pm, params_from_numpy(params_np, "cpu"), TrainConfig(lr=1e-3),
                        device="cpu", seed=3, mesh=mesh, pipeline=plan, **engine_kw)
    mine = rank_rows(mesh, batch)
    losses = []
    for _ in range(steps):
        if single:
            losses.append(float(engine.single_train_step(dict(mine), single)))
        else:
            losses.append(float(engine.train_step(dict(mine))))
    state = engine.full_state()
    if dist.get_rank():
        return None
    return losses, flat(state.trainable)


def flash_path_steps(*args, **kw):
    """`train_steps` with AV-HuBERT's attention on its flash route whatever
    the device and the length, as on the card (on the CPU the kernels'
    plain versions, with their hash dropout mask)."""
    import omni_avsr_tpu_torch.models.avhubert as avh

    path = avh._flash_path
    avh._flash_path = lambda q: True
    try:
        return train_steps(*args, **kw)
    finally:
        avh._flash_path = path


def one_process_steps(params_np, batch, steps: int = 1, moe_experts: int = 0,
                      single: Optional[str] = None, model: Optional[Dict[str, Any]] = None,
                      **engine_kw):
    """The same steps in one process on the global batch (no mesh)."""
    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.config import TrainConfig
    from omni_avsr_tpu_torch.train.engine import OmniEngine

    pm = tiny_model(moe_experts, **(model or {}))
    engine = OmniEngine(pm, params_from_numpy(params_np, "cpu"), TrainConfig(lr=1e-3),
                        device="cpu", seed=3, **engine_kw)
    losses = []
    for _ in range(steps):
        if single:
            losses.append(float(engine.single_train_step(dict(batch), single)))
        else:
            losses.append(float(engine.train_step(dict(batch))))
    return losses, flat(engine.state.trainable)


def serve_case(params_np, items, tp: int, quantize=None, num_beams: int = 2,
               attn_route=None, kv_heads: Optional[int] = None, modality=None,
               vocab: Optional[int] = None, select_kernel: bool = False):
    """Every rank's transcripts of `items` from a `Transcriber(mesh=...)` on
    a (1, tp) mesh (a twin model with `kv_heads` kv heads or a `vocab`-token
    vocabulary when given), with its decode route and the blocks that run
    tensor-parallel."""
    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.serve import Transcriber

    mesh = make_mesh(dp=1, tp=tp)
    pm = tiny_model(kv_heads=kv_heads, vocab=vocab)
    t = Transcriber(pm, params_from_numpy(params_np, "cpu"), num_beams=num_beams,
                    quantize=quantize, device="cpu", attn_route=attn_route, mesh=mesh,
                    select_kernel=select_kernel)
    texts = t.transcribe_many(items, modality=modality)
    return texts, t.attn_route, sorted(t.par.tp_blocks)


def llm_case(cfg, llm_np, embeds_np, mask_np, tp: int, sequence_parallel: bool,
             modality: str, cot_np, remat: str = "off"):
    """`models/llm.py::llm_logits` of an LLM tree on a (1, tp) mesh, each
    block tensor-parallel where its leaves and heads divide by tp (as the
    engine shards it), with or without sequence parallelism, under the
    remat policy `remat`; returns the logits and the gradient of
    sum(logits * cot) by the embeddings. The backward runs outside the
    parallel scope, as the autograd engine runs a card's backward on its
    own thread."""
    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.models.llm import llm_logits
    from omni_avsr_tpu_torch.parallel import collectives as par
    from omni_avsr_tpu_torch.parallel.partitioning import (clamp_specs_to_shapes,
                                                           coherent_specs, llm_partition_specs,
                                                           shard_params)

    mesh = make_mesh(dp=1, tp=tp)
    llm = params_from_numpy(llm_np, "cpu")
    heads_divide = cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
    specs, blocks = coherent_specs(clamp_specs_to_shapes(mesh, llm, llm_partition_specs(llm)),
                                   "llm", replicate=() if heads_divide else ("llm.attn",))
    mine = shard_params(mesh, llm, specs)
    x = torch.from_numpy(embeds_np).requires_grad_(True)
    mask = None if mask_np is None else torch.from_numpy(mask_np)
    with par.scope(par.Parallel.of(mesh, blocks, sequence_parallel)):
        logits = llm_logits(mine, cfg, x, mask=mask, modality=modality, remat=remat)
    (grad,) = torch.autograd.grad((logits * torch.from_numpy(cot_np)).sum(), x)
    return logits.detach().numpy(), grad.numpy(), sorted(blocks)


def select_case(x_np, k2: int, use_kernel: bool = False):
    """`_fused_select_sharded` of this rank's vocabulary slice of x."""
    from omni_avsr_tpu_torch.decode.decoding import _fused_select_sharded
    from omni_avsr_tpu_torch.parallel.mesh import axis

    mesh = make_mesh(dp=1, tp=2)
    tp = axis(mesh, "tp")
    x = torch.from_numpy(x_np)
    Vs = x.shape[-1] // tp.size
    out = _fused_select_sharded(x[..., tp.rank * Vs:(tp.rank + 1) * Vs].contiguous(), k2, tp,
                                use_kernel)
    return [o.numpy() for o in out]


def pipe_case(cfg, llm_np, embeds_np, tgt_np, dp: int, pp: int, microbatches: int,
              remat: str = "off"):
    """The GPipe backbone on a (dp, pp) mesh: this rank's rows of the output,
    and the grads of loss = mean((y @ w_post - tgt)^2) over the global batch
    with y = backbone(x @ w_pre): the stage's layer grads, gathered over pp,
    and the replicated w_pre / w_post grads after `reduce_grads`."""
    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.parallel import collectives as par
    from omni_avsr_tpu_torch.parallel.mesh import axis
    from omni_avsr_tpu_torch.parallel.partitioning import gather_params
    from omni_avsr_tpu_torch.parallel.pipeline import (anchors, drain, pipeline_backbone,
                                                       pipeline_layer_specs, shard_layers)

    mesh = make_mesh(dp=dp, pp=pp, tp=1)
    d = axis(mesh, "dp")
    layers_full = params_from_numpy(llm_np, "cpu")["layers"]
    layers = {k: v for k, v in shard_layers(mesh, layers_full).items()}
    layers = _requires_grad(layers)
    H = embeds_np.shape[-1]
    B = embeds_np.shape[0] // dp
    rows = slice(d.rank * B, (d.rank + 1) * B)
    w_pre = torch.eye(H, requires_grad=True)
    w_post = (torch.eye(H) * 0.5).requires_grad_(True)
    x = torch.from_numpy(embeds_np[rows]) @ w_pre
    p = par.Parallel.of(mesh)
    with par.scope(p):
        y = pipeline_backbone(mesh, layers, cfg, x, modality="audio",
                              num_microbatches=microbatches, remat=remat)
        loss = ((y @ w_post - torch.from_numpy(tgt_np[rows])) ** 2).sum() / tgt_np.size
        leaves = _leaf_list(layers) + [w_pre, w_post]
        grads = torch.autograd.grad(loss, leaves + anchors(), allow_unused=True)[:len(leaves)]
        drain()
        grads = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves, grads)]
        specs = [pipeline_layer_specs(v) for v in _leaf_list(layers)] + [(), ()]
        grads = par.reduce_grads(grads, specs, p)
    n = len(_leaf_list(layers))
    layer_grads = _unflatten_like(layers, grads[:n])
    whole = gather_params(mesh, layer_grads, pipeline_layer_specs(layer_grads))
    return (y.detach().numpy(), flat(whole), grads[n].numpy(), grads[n + 1].numpy(),
            float(par.all_reduce(loss.detach(), d)))


def _requires_grad(tree):
    return {k: _requires_grad(v) if isinstance(v, dict) else v.detach().clone().requires_grad_(True)
            for k, v in tree.items()}


def _leaf_list(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _leaf_list(v) if isinstance(v, dict) else [v]
    return out


def _unflatten_like(tree, leaves):
    it = iter(leaves)

    def build(node):
        return {k: build(node[k]) if isinstance(node[k], dict) else next(it) for k in sorted(node)}

    return build(tree)


def pipe_errors(cfg, llm_np, embeds_np):
    """The divisibility messages: the batch by the microbatches, the layers
    by pp."""
    import dataclasses

    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.parallel.pipeline import pipeline_backbone, shard_layers

    mesh = make_mesh(dp=1, pp=4, tp=1)
    layers_full = params_from_numpy(llm_np, "cpu")["layers"]
    msgs = []
    try:
        pipeline_backbone(mesh, shard_layers(mesh, layers_full), cfg,
                          torch.from_numpy(embeds_np), num_microbatches=3)
    except ValueError as e:
        msgs.append(str(e))
    six = {k: _cat_layers(v) for k, v in layers_full.items()}
    try:
        shard_layers(mesh, six)
    except ValueError as e:
        msgs.append(str(e))
    try:
        pipeline_backbone(mesh, shard_layers(mesh, layers_full),
                          dataclasses.replace(cfg, num_layers=6), torch.from_numpy(embeds_np),
                          num_microbatches=2)
    except ValueError as e:
        msgs.append(str(e))
    return msgs


def _cat_layers(node):
    """A 6-layer stack from a 4-layer one (layers 0-3 then 0-1)."""
    if isinstance(node, dict):
        return {k: _cat_layers(v) for k, v in node.items()}
    return torch.cat([node, node[:2]])


def raise_or_wait(seconds: float):
    """Rank 1 raises; the other ranks wait `seconds`, as a rank waits in a
    collective on card tensors for a peer that raised (gloo's timeout does
    not reach it)."""
    import time

    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 stops here")
    time.sleep(seconds)
    return dist.get_rank()


def cli_case(cli: str, argv):
    """`omni_avsr_tpu_torch.cli.<cli>.main(argv)` on this rank; returns the
    checkpoint paths this rank wrote."""
    import importlib

    mod = importlib.import_module(f"omni_avsr_tpu_torch.cli.{cli}")
    written = []
    save = mod.save_checkpoint

    def spy(ckpt_dir, step, state, keep=4):
        written.append(save(ckpt_dir, step, state, keep))
        return written[-1]

    mod.save_checkpoint = spy
    try:
        mod.main(list(argv))
    finally:
        mod.save_checkpoint = save
    return written
