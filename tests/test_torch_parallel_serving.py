"""The port's partition specs and tensor-parallel serving
(`omni_avsr_tpu_torch/parallel/`, `Transcriber(mesh=...)`) against the JAX
package on its 8-device CPU mesh (tests/conftest.py), at the tiny flagship
widths in f32. The port's ranks run in one group of two gloo ranks for the
whole file (`parallel/launch.py::RankPool`: a file-store rendezvous in
tmp_path, a 60 s collective timeout, one torch thread per rank).

  - the spec tables: every leaf of the tiny Omni LLM, the MoE LLM and the
    int8 serving tree gets the JAX package's spec (as tuples), clamped
    alike on several meshes;
  - tensor-parallel serving at tp=2 (beam 2 and greedy, int8 and float)
    gives the JAX Transcriber's tokens, and so does the JAX Transcriber
    on its tp mesh on the kernel and the non-kernel route; indivisible heads take the non-kernel
    route;
  - `_fused_select_sharded` is exact: values and indices equal, lse within
    1e-6, also on B5's route with shards that are no multiple of 128.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parallel_ranks as R
from tests.torch_parity import (clips, jax_in_f32, jax_moe_flagship, jax_tiny_flagship,
                                jax_tiny_params)



@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    from omni_avsr_tpu_torch.parallel.launch import RankPool

    p = RankPool(2, str(tmp_path_factory.mktemp("rdzv")), timeout_s=60)
    yield p
    p.close()


@pytest.fixture(scope="module")
def tiny():
    jm = jax_tiny_flagship()
    return jm, jax.tree_util.tree_map(np.asarray, jax_tiny_params(jm))


@pytest.fixture(scope="module")
def moe_params():
    return jax.tree_util.tree_map(np.asarray, jax_tiny_params(jax_moe_flagship()))


# ---------------------------------------------------------------------------
# spec tables
# ---------------------------------------------------------------------------

def _tuples(tree):
    from jax.sharding import PartitionSpec as P

    return jax.tree_util.tree_map(lambda s: tuple(s), tree, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("fsdp,ep", [(False, False), (True, False), (False, True)])
def test_llm_specs_match_jax(tiny, moe_params, fsdp, ep):
    from omni_avsr_tpu.parallel import partitioning as jp

    from omni_avsr_tpu_torch.parallel import partitioning as pp_

    jm, params = tiny
    trees = [params["llm"]]
    if ep:
        trees = [moe_params["llm"]]
    for llm in trees:
        want = _tuples(jp.llm_partition_specs(llm, fsdp=fsdp, ep=ep))
        assert pp_.llm_partition_specs(llm, fsdp=fsdp, ep=ep) == want
        meshes = ({"dp": 2, "tp": 2}, {"dp": 1, "tp": 4}, {"dp": 4, "tp": 2})
        if ep:
            meshes = ({"dp": 1, "ep": 2, "tp": 2}, {"dp": 1, "ep": 4, "tp": 1},
                      {"dp": 2, "ep": 4, "tp": 1})
        for sizes in meshes:
            jmesh = _jax_mesh(**sizes)
            with _no_check():
                jc = _tuples(jp.clamp_specs_to_shapes(jmesh, llm, jp.llm_partition_specs(
                    llm, fsdp=fsdp, ep=ep)))
                pc = pp_.clamp_specs_to_shapes(sizes, llm, pp_.llm_partition_specs(
                    llm, fsdp=fsdp, ep=ep))
            assert pc == jc, sizes


def test_decode_and_moe_specs_match_jax(tiny, moe_params):
    from omni_avsr_tpu.models.moe import moe_partition_specs as jax_moe_specs
    from omni_avsr_tpu.ops.quant import quantize_for_decode
    from omni_avsr_tpu.parallel import partitioning as jp

    from omni_avsr_tpu_torch.models.moe import moe_partition_specs
    from omni_avsr_tpu_torch.parallel import partitioning as pp_

    jm, params = tiny
    merged = jax.tree_util.tree_map(jnp.asarray, params)
    for tree in (merged, quantize_for_decode(merged, "int8", fuse_projections=False)):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        want = _tuples(jp.decode_partition_specs(tree))
        assert pp_.decode_partition_specs(tree) == want
        jmesh = _jax_mesh(dp=1, tp=4)
        with _no_check():
            assert pp_.clamp_specs_to_shapes({"dp": 1, "tp": 4}, tree, want) == _tuples(
                jp.clamp_specs_to_shapes(jmesh, tree, jp.decode_partition_specs(tree)))
    layer = moe_params["llm"]["layers"]["moe"]
    tlayer = jax.tree_util.tree_map(torch.from_numpy, layer)
    assert moe_partition_specs(tlayer) == _tuples(jax_moe_specs(layer))


class _no_check:
    """Collect the replication warnings (both packages warn alike)."""

    def __enter__(self):
        import warnings

        self._w = warnings.catch_warnings()
        self._w.__enter__()
        warnings.simplefilter("ignore")

    def __exit__(self, *a):
        self._w.__exit__(*a)


def _jax_mesh(dp: int = 1, tp: int = 1, pp: int = 1, ep: int = 1):
    from omni_avsr_tpu.config import MeshConfig
    from omni_avsr_tpu.parallel.mesh import make_mesh

    n = dp * tp * pp * ep
    return make_mesh(MeshConfig(dp=dp, tp=tp, pp=pp, ep=ep), devices=jax.devices()[:n])




# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize,num_beams,route,jax_meshed", [
    ("int8", 2, "kernel", True), ("int8", 1, "kernel", False), (None, 2, "kernel", False),
    ("int8", 2, "xla", True),
])
def test_tp_serving_matches_jax(monkeypatch, pool, tiny, quantize, num_beams, route,
                                jax_meshed):
    """The port's tp=2 ranks give the JAX Transcriber's tokens; in the int8
    beam cases, on both routes, the JAX Transcriber on its own tp=2 mesh
    gives them too."""
    from omni_avsr_tpu.serve import Transcriber as JaxTranscriber

    jm, params = tiny
    monkeypatch.setenv("OMNI_BEAM_ATTN", route)
    jax_in_f32(monkeypatch)
    items = clips((40, 33), seed=0)
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    want = JaxTranscriber(jm, tree, num_beams=num_beams, quantize=quantize).transcribe_many(items)
    if jax_meshed:
        with _no_check():
            meshed = JaxTranscriber(jm, tree, num_beams=num_beams, quantize=quantize,
                                    mesh=_jax_mesh(dp=1, tp=2)).transcribe_many(items)
        assert meshed == want
    ranks = pool.run(R.serve_case, params, items, 2, quantize=quantize, num_beams=num_beams,
                     attn_route=route)
    for texts, used_route, blocks in ranks:
        assert texts == want
        assert used_route == route
        assert "llm.attn" in blocks and "llm.mlp" in blocks
        assert ("llm.lm_head" in blocks) == (quantize == "int8")


def test_indivisible_heads_take_the_reorder_route(pool):
    """One kv head does not divide tp=2: the attention runs replicated on the
    reorder route (the JAX package's "xla"), the MLP still tensor-parallel;
    the tokens are the meshless Transcriber's."""
    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.serve import Transcriber

    pm = R.tiny_model(kv_heads=1)
    params = init_params(pm.cfg, torch.Generator().manual_seed(0), "cpu")
    tree = _unflat(R.flat(params))
    items = clips((40,), seed=1)
    want = Transcriber(pm, params, num_beams=2, quantize="int8",
                       device="cpu").transcribe_many(items)
    for texts, route, blocks in pool.run(R.serve_case, tree, items, 2, quantize="int8",
                                         kv_heads=1):
        assert texts == want and route == "xla"
        assert "llm.attn" not in blocks and "llm.mlp" in blocks


def test_chip_smoke_serving_ranks_rehearse(monkeypatch, pool):
    """chip_smoke.py's (u) at the tiny widths on this file's ranks: the
    meshless reference (`u_reference`) and the rank function
    (`u_rank_run`, the ranks building in turns) at tp 2, held by `u_case`
    to the reference: the logits, and in f32 the same ids. With
    `select_kernel` at a vocabulary of 257 x 128 tokens, whose halves are no
    multiple of 128: each rank pads its shard to whole chunks for B5's
    statistics (here its plain version), and the rank function holds the
    merged selection of a decode step to the unsharded one."""
    from tests.test_torch_parallel import chip_smoke_on_cpu

    cs = chip_smoke_on_cpu(monkeypatch)
    items = cs.make_items((40,), 0)
    model = (R.tiny_model, (), 257 * 128)
    ref = cs.u_reference(cs.vocab_model, model, items, True)
    rows = cs.u_case("(u) tiny", pool, ref, cs.vocab_model, model, 2, items, True, True, "cpu")
    row = rows["(u) tiny"]
    assert row["logits_rel_l2"] < 1e-5 and row["ids_equal_share"] == 1.0, row
    assert "llm.lm_head" in row["tp_blocks"]


def test_serving_shards_start_aligned():
    """Every leaf of rank 1's shard of an int8 serving tree at tp=2 starts
    16-byte aligned, as the card's kernels load it (B2 refuses a scale
    vector that does not): with a vocabulary of 2 x 257 tokens rank 1's
    half of the lm_head scales starts 1028 bytes into the whole vector."""
    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.ops.quant import quantize_llm_params
    from omni_avsr_tpu_torch.serve import shard_serving_tree

    pm = R.tiny_model(vocab=2 * 257)
    tree = dict(init_params(pm.cfg, torch.Generator().manual_seed(0), "cpu"))
    tree["llm"] = quantize_llm_params(tree["llm"], 8)
    local, blocks = shard_serving_tree(tree, {"dp": 1, "tp": 2}, True, coords={"dp": 0, "tp": 1})
    assert "llm.lm_head" in blocks
    for path, leaf in _leaves(local):
        assert leaf.data_ptr() % 16 == 0, path


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def test_sharded_select_is_exact(pool):
    """Per-shard stats and top-2K, merged over tp: the values and indices of
    the one-device fused selection, the lse within 1e-6."""
    from omni_avsr_tpu_torch.decode.decoding import topk_chunked

    x = np.random.RandomState(0).randn(2, 3, 4096).astype(np.float32) * 3
    k2 = 6
    xt = torch.from_numpy(x)
    mx = xt.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(xt - mx).sum(dim=-1, keepdim=True))
    vals, idx = topk_chunked(xt, k2)
    for out in pool.run(R.select_case, x, k2):
        np.testing.assert_array_equal(out[0], mx.numpy())
        np.testing.assert_allclose(out[1], lse.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(out[2], vals.numpy())
        np.testing.assert_array_equal(out[3], idx.numpy())


def test_sharded_select_pads_shards_for_the_kernel(pool):
    """B5's route (`use_kernel`, its plain version on the CPU) on vocabulary
    shards of 448 tokens, no multiple of its 128-wide chunks (as Llama-3's
    128256 at tp 4): each shard padded with -inf columns, merged over tp,
    gives the values and indices of the one-device selection, the lse
    within 1e-6."""
    from omni_avsr_tpu_torch.decode.decoding import topk_chunked

    x = np.random.RandomState(1).randn(2, 3, 2 * 448).astype(np.float32) * 3
    k2 = 6
    xt = torch.from_numpy(x)
    mx = xt.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(xt - mx).sum(dim=-1, keepdim=True))
    vals, idx = topk_chunked(xt, k2)
    for out in pool.run(R.select_case, x, k2, True):
        np.testing.assert_array_equal(out[0], mx.numpy())
        np.testing.assert_allclose(out[1], lse.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(out[2], vals.numpy())
        np.testing.assert_array_equal(out[3], idx.numpy())
