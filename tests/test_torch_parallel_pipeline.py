"""The port's GPipe pipeline (`omni_avsr_tpu_torch/parallel/pipeline.py`)
against the JAX package's (`omni_avsr_tpu/parallel/pipeline.py`) and the
unpipelined backbone, on tests/test_pipeline.py's setup (a 4-layer tiny
LLM, batch 4, T 12, f32). The port's stages run in one group of four gloo
ranks for the whole file (a file-store rendezvous in tmp_path, a 60 s
collective timeout, one torch thread per rank); the JAX references run in
the pytest process on its 8-device CPU mesh.

  - the forward at pp 4 (M 1 and 4) and at dp x pp = 2 x 2 (M 1 and 2)
    equals JAX `pipeline_backbone` and the port's unpipelined backbone
    (1e-5), with remat too;
  - the layer grads, and the grads of a replicated parameter before the
    stack (on stage 0 only) and after it (on every stage), equal the
    unpipelined ones after `reduce_grads` (no sum of S copies, no
    cotangent multiplied by S);
  - the divisibility messages are the JAX package's, word for word.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parallel_ranks as R


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    from omni_avsr_tpu_torch.parallel.launch import RankPool

    p = RankPool(4, str(tmp_path_factory.mktemp("rdzv")), timeout_s=60)
    yield p
    p.close()


@pytest.fixture(scope="module")
def setup():
    import dataclasses

    import omni_avsr_tpu_torch.config as port_cfg
    from omni_avsr_tpu.models import llm as L
    from tests.test_llm import tiny_cfg
    from tests.torch_parity import twin_config

    cfg = dataclasses.replace(tiny_cfg(task_specific=False), num_layers=4)
    params = L.init_llm(jax.random.PRNGKey(0), cfg)
    B, T = 4, 12
    embeds = jax.random.normal(jax.random.PRNGKey(1), (B, T, cfg.hidden_size), jnp.float32)
    tgt = np.asarray(jax.random.normal(jax.random.PRNGKey(2), embeds.shape, jnp.float32))
    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))
    ref = L.llm_backbone(params, cfg, embeds, positions=positions, mask=None, modality="audio",
                         remat=False)
    return (cfg, twin_config(cfg, port_cfg), jax.tree_util.tree_map(np.asarray, params),
            np.asarray(embeds), tgt, np.asarray(ref))


def _unpipelined(pcfg, params, embeds, tgt):
    """The port's backbone and grads of the same loss, one process."""
    from omni_avsr_tpu_torch.bridge import params_from_numpy
    from omni_avsr_tpu_torch.models.llm import llm_backbone

    llm = params_from_numpy(params, "cpu")
    layers = R._requires_grad(llm["layers"])
    H = embeds.shape[-1]
    w_pre = torch.eye(H, requires_grad=True)
    w_post = (torch.eye(H) * 0.5).requires_grad_(True)
    B, T = embeds.shape[:2]
    pos = torch.arange(T)[None].expand(B, T)
    y = llm_backbone({"layers": layers}, pcfg, torch.from_numpy(embeds) @ w_pre, pos, "audio",
                     remat="off")
    loss = ((y @ w_post - torch.from_numpy(tgt)) ** 2).sum() / tgt.size
    leaves = R._leaf_list(layers) + [w_pre, w_post]
    grads = torch.autograd.grad(loss, leaves)
    n = len(leaves) - 2
    return (y.detach().numpy(), R.flat(R._unflatten_like(layers, grads[:n])), grads[n].numpy(),
            grads[n + 1].numpy(), float(loss))


@pytest.mark.parametrize("dp,pp,microbatches,remat", [
    (1, 4, 4, "off"), (1, 4, 1, "off"), (2, 2, 2, "off"), (2, 2, 1, "full"), (1, 4, 4, "dots"),
])
def test_pipeline_matches_jax_and_backbone(pool, setup, dp, pp, microbatches, remat):
    from omni_avsr_tpu.parallel import pipeline as PL
    from jax.sharding import Mesh

    cfg, pcfg, params, embeds, tgt, ref = setup
    devs = np.asarray(jax.devices()[: dp * pp]).reshape(dp, pp)
    jmesh = Mesh(devs, ("dp", PL.AXIS_PP))
    jout = np.asarray(PL.pipeline_backbone(
        jmesh, PL.shard_layers(jmesh, jax.tree_util.tree_map(jnp.asarray, params["layers"])),
        cfg, jnp.asarray(embeds), modality="audio", num_microbatches=microbatches,
        remat=remat != "off", dp_axis="dp" if dp > 1 else None))
    np.testing.assert_allclose(jout, ref, rtol=2e-5, atol=2e-5)
    want = _unpipelined(pcfg, params, embeds, tgt)
    np.testing.assert_allclose(want[0], ref, rtol=1e-5, atol=1e-5)
    B = embeds.shape[0] // dp
    for rank, got in enumerate(pool.run(R.pipe_case, pcfg, params, embeds, tgt, dp, pp,
                                        microbatches, remat)):
        d = rank // pp  # the mesh is (dp, pp): rank = d * pp + stage
        rows = slice(d * B, (d + 1) * B)
        np.testing.assert_allclose(got[0], want[0][rows], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[0], jout[rows], rtol=1e-5, atol=1e-5)
        assert got[1].keys() == want[1].keys()
        for path in want[1]:
            np.testing.assert_allclose(got[1][path], want[1][path], rtol=1e-5, atol=1e-6,
                                       err_msg=path)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)  # before the stack
        np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-6)  # after it
        np.testing.assert_allclose(got[4], want[4], rtol=1e-6)


def test_pipeline_layer_grads_match_jax(pool, setup):
    """tests/test_pipeline.py's gradient check: the JAX pipeline's layer
    grads of mean((y - tgt)^2) are the port's (w_pre = I, w_post = I / 2
    scale the port's loss: its grads are taken on the same y)."""
    from jax.sharding import Mesh

    from omni_avsr_tpu.parallel import pipeline as PL

    cfg, pcfg, params, embeds, tgt, _ = setup
    jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("dp", PL.AXIS_PP))

    def pp_loss(layers):
        y = PL.pipeline_backbone(jmesh, layers, cfg, jnp.asarray(embeds), modality="audio",
                                 num_microbatches=2, remat=False)
        return jnp.sum((y @ (jnp.eye(y.shape[-1]) * 0.5) - tgt) ** 2) / tgt.size

    g = jax.grad(pp_loss)(PL.shard_layers(
        jmesh, jax.tree_util.tree_map(jnp.asarray, params["layers"])))
    want = R.flat(jax.tree_util.tree_map(lambda x: torch.from_numpy(np.asarray(x)),
                                         jax.device_get(g)))
    got = pool.run(R.pipe_case, pcfg, params, embeds, tgt, 1, 4, 2)[0][1]
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=5e-5, atol=5e-6, err_msg=path)


def test_pipeline_divisibility_messages(pool, setup):
    from jax.sharding import Mesh

    from omni_avsr_tpu.parallel import pipeline as PL

    cfg, pcfg, params, embeds, _, _ = setup
    jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("dp", PL.AXIS_PP))
    want = []
    layers = jax.tree_util.tree_map(jnp.asarray, params["layers"])
    try:
        PL.pipeline_backbone(jmesh, PL.shard_layers(jmesh, layers), cfg, jnp.asarray(embeds),
                             num_microbatches=3)
    except ValueError as e:
        want.append(str(e))
    six = jax.tree_util.tree_map(lambda x: jnp.concatenate([x, x[:2]]), layers)
    try:
        PL.pipeline_backbone(jmesh, six, cfg, jnp.asarray(embeds), num_microbatches=2)
    except ValueError as e:
        want.append(str(e))
    assert want == ["batch 4 not divisible by 3 microbatches",
                    "6 layers not divisible by pp=4"]
    for msgs in pool.run(R.pipe_errors, pcfg, params, embeds):
        assert msgs == [want[0], want[1], want[1]]


def test_backward_messages_keep_one_order(monkeypatch):
    """The backward's messages carry no tag (NCCL ignores tags), so a
    stage sends and receives them in one fixed order, by call and then
    from the last microbatch to the first, whatever order the autograd
    engine reaches them in: a gradient computed early is held until its
    turn, and a receive takes the messages before its own and keeps them."""
    from omni_avsr_tpu_torch.parallel import pipeline as PL

    wire = []

    class Done:
        def wait(self):
            pass

    def isend(buf, peer, group=None):
        wire.append(buf.clone())
        return Done()

    def recv(buf, peer, group=None):
        buf.copy_(wire.pop(0))

    monkeypatch.setattr(PL.dist, "isend", isend)
    monkeypatch.setattr(PL.dist, "recv", recv)
    meta = ((2,), torch.float32, 1, None)
    out, inn = PL._Link(), PL._Link()
    for link in (out, inn):
        link.add_call(0, 3, meta)
        link.add_call(1, 2, meta)
    order = [(0, 2), (0, 1), (0, 0), (1, 1), (1, 0)]

    def grad(key):
        return torch.full((2,), 10.0 * key[0] + key[1])

    for i, key in enumerate([(1, 0), (0, 0), (0, 2), (1, 1), (0, 1)]):
        out.send(key, grad(key))
        assert len(wire) == [0, 0, 1, 1, 5][i]
    assert out.finished() and [float(b[0]) for b in wire] == [float(grad(k)[0]) for k in order]
    for key in [(0, 0), (1, 1), (0, 2), (1, 0), (0, 1)]:
        torch.testing.assert_close(inn.recv(key, "cpu"), grad(key), rtol=0, atol=0)
    assert inn.finished() and not wire
