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


def tiny_model(moe_experts: int = 0, routing: str = "balanced"):
    import dataclasses

    from omni_avsr_tpu_torch.models.omni import OmniAVSR, flagship

    pm = flagship(tiny=True, dtype=torch.float32, whisper_input_mode="bucket")
    if moe_experts:
        cfg = dataclasses.replace(pm.cfg, llm=dataclasses.replace(
            pm.cfg.llm, moe_experts=moe_experts, moe_routing=routing))
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
                single: Optional[str] = None, **engine_kw):
    """`steps` optimizer steps of the tiny flagship on `mesh_sizes`; returns
    (losses, the whole trainable tree after the steps) on rank 0."""
    import torch.distributed as dist

    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.config import TrainConfig
    from omni_avsr_tpu_torch.train.engine import OmniEngine

    mesh = make_mesh(**mesh_sizes)
    plan = None
    if pp_microbatches:
        from omni_avsr_tpu_torch.parallel.pipeline import PipelinePlan

        plan = PipelinePlan(mesh, num_microbatches=pp_microbatches, dp_axis="dp")
    pm = tiny_model(moe_experts)
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


def one_process_steps(params_np, batch, steps: int = 1, moe_experts: int = 0,
                      single: Optional[str] = None, **engine_kw):
    """The same steps in one process on the global batch (no mesh)."""
    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.config import TrainConfig
    from omni_avsr_tpu_torch.train.engine import OmniEngine

    pm = tiny_model(moe_experts)
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
               attn_route=None, kv_heads: Optional[int] = None, modality=None):
    """Every rank's transcripts of `items` from a `Transcriber(mesh=...)` on
    a (1, tp) mesh (a twin model with `kv_heads` kv heads when given), with
    its decode route and the blocks that run tensor-parallel."""
    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.serve import Transcriber

    mesh = make_mesh(dp=1, tp=tp)
    pm = tiny_model() if kv_heads is None else kv_twin(kv_heads)
    t = Transcriber(pm, params_from_numpy(params_np, "cpu"), num_beams=num_beams,
                    quantize=quantize, device="cpu", attn_route=attn_route, mesh=mesh)
    texts = t.transcribe_many(items, modality=modality)
    return texts, t.attn_route, sorted(t.par.tp_blocks)


def kv_twin(kv_heads: int):
    """The tiny flagship with `kv_heads` kv heads (a tree of its shapes comes
    from `bridge.init_params`)."""
    import dataclasses

    from omni_avsr_tpu_torch.models.omni import OmniAVSR

    pm = tiny_model()
    llm = pm.cfg.llm
    # the LoRA v up-projection's width is the kv width: hidden / v_out_divisor
    lora = dataclasses.replace(llm.lora, v_out_divisor=llm.hidden_size // (kv_heads * llm.head_dim))
    cfg = dataclasses.replace(pm.cfg, llm=dataclasses.replace(llm, num_kv_heads=kv_heads,
                                                              lora=lora))
    return OmniAVSR(cfg, pm.tok, dtype=torch.float32)


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
