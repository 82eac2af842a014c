"""The port's parallel training (`omni_avsr_tpu_torch/parallel/`, the engine
under a mesh) against the JAX package on its 8-device CPU mesh
(tests/conftest.py), at the tiny flagship widths in f32. The port's ranks
run in one group of two gloo ranks for the whole file
(`parallel/launch.py::RankPool`: a file-store rendezvous in tmp_path, a
60 s collective timeout, one torch thread per rank); the JAX references
run here, in the pytest process.

  - train steps: dp=2, FSDP (dp=2), tp=2 and pp=2 (the GPipe engine
    step, `parallel/pipeline.py`) equal the JAX step on a (dp=2, tp=2)
    mesh and the port's one-process step on the global batch (losses rtol
    1e-5, the trainable tree after the step atol 1e-5 / rtol 1e-4, as
    tests/test_torch_train.py's two-step test); the batch gives the two
    dp ranks different token counts and different frame statistics, so a
    mean of rank means or per-rank BatchNorm would fail; with
    augmentation, train-mode BN (one pass and two) and dropout on the
    threefry route, dp=2 equals the one-process step, and the JAX mesh step
    at tests/test_torch_reference_profile.py's augmented tolerances;
  - sequence parallelism at tp=2 equals no SP at a T that does not divide;
    expert parallelism at ep=2 equals ep=1, and an MoE step at dp=2 routes
    the global batch's tokens.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parallel_ranks as R
from tests.torch_parity import jax_in_f32, jax_moe_flagship, jax_tiny_flagship, jax_tiny_params

TOKENS, FRAMES = 6, 8
BANK = (np.random.RandomState(5).randn(40000) * 0.1).astype(np.float32)


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


def global_batch(tok, B: int = 4):
    """Rows 0-1 (dp rank 0) hold 9 target tokens, rows 2-3 (rank 1) 5, and
    rank 1's frames are darker and flatter: the ranks' token counts and
    frame statistics differ."""
    rng = np.random.RandomState(0)
    S = FRAMES * 640
    ids = []
    for n in (6, 3, 3, 2):
        row = tok.encode("hello world test again")[:n]
        ids.append(row + [tok.pad_id] * (TOKENS - len(row)))
    ids = np.asarray(ids, np.int32)
    video = rng.randint(0, 255, (B, FRAMES, 96, 96, 3)).astype(np.uint8)
    video[2:] = video[2:] // 4 + 20
    return {"tokens": ids, "labels": np.where(ids == tok.pad_id, -100, ids).astype(np.int32),
            "audio": (rng.randn(B, S) * np.asarray([0.05, 0.05, 0.5, 0.3])[:, None]
                      ).astype(np.float32),
            "audio_len": np.asarray([S, S - 700, S, S - 1400], np.int32),
            "video": video, "video_len": np.asarray([FRAMES, FRAMES - 2, FRAMES, FRAMES - 1],
                                                     np.int32),
            "audio_trim_len": 25}


def test_global_batch_splits_unevenly(tiny):
    b = global_batch(tiny[0].tok)
    counts = (b["labels"] != -100).sum(axis=1)
    assert counts[:2].sum() != counts[2:].sum()
    assert abs(b["video"][:2].mean() - b["video"][2:].mean()) > 10


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_mesh_steps(tiny):
    """The JAX engine's step on a (dp=2, tp=2) mesh, f32: augment off, and
    augment on (threefry draws, babble), as `setup_parallelism` shards it."""
    import omni_avsr_tpu.train.state as jstate
    from omni_avsr_tpu.config import TrainConfig as JaxTrainConfig
    from omni_avsr_tpu.parallel.distributed import global_batch_from_local
    from omni_avsr_tpu.parallel.partitioning import (clamp_specs_to_shapes,
                                                     llm_partition_specs, shard_params)
    from omni_avsr_tpu.train.engine import OmniEngine as JaxEngine

    jm, params = tiny
    batch = global_batch(jm.tok)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_in_f32(mp)
        mp.setattr(jstate.make_train_step, "__defaults__", (jnp.float32,))
        for augment in (False, True):
            if augment:
                mp.setenv("OMNI_PRNG", "threefry")
            mesh = _jax_mesh(dp=2, tp=2)
            tree = jax.tree_util.tree_map(jnp.asarray, params)
            with _no_check():
                specs = clamp_specs_to_shapes(mesh, tree["llm"], llm_partition_specs(tree["llm"]))
            tree["llm"] = shard_params(mesh, tree["llm"], specs)
            je = JaxEngine(jm, tree, JaxTrainConfig(lr=1e-3), augment=augment, seed=3,
                           noise_bank=BANK if augment else None)
            arrays = {k: v for k, v in batch.items() if k != "audio_trim_len"}
            gb = global_batch_from_local(mesh, arrays)
            loss = float(je.train_step({**gb, "audio_trim_len": 25}))
            out[augment] = ([loss], R.flat(jax.tree_util.tree_map(
                lambda x: torch.from_numpy(np.asarray(x)), jax.device_get(je.state.trainable))))
    return out


@pytest.fixture(scope="module")
def one_process(tiny):
    """The port's one-process steps on the global batch."""
    _, params = tiny
    batch = global_batch(tiny[0].tok)
    return {False: R.one_process_steps(params, batch, augment=False),
            True: R.one_process_steps(params, batch, augment=True, prng="threefry",
                                      noise_bank=BANK)}


def _close(got, want, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1].keys() == want[1].keys()
    for path in want[1]:
        np.testing.assert_allclose(got[1][path], want[1][path], atol=atol, rtol=rtol,
                                   err_msg=path)


def _augmented_close(got, want):
    """tests/test_torch_reference_profile.py's criteria for augmented steps:
    losses rtol 1e-5; every element within one Adam step (lr 1e-3) and all
    but 0.1% within atol 1e-5 / rtol 1e-4 (the train-mode ResNet amplifies
    f32 rounding)."""
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    outside = total = 0
    for path in want[1]:
        np.testing.assert_allclose(got[1][path], want[1][path], atol=1e-3, rtol=0, err_msg=path)
        outside += int((np.abs(got[1][path] - want[1][path])
                        > 1e-5 + 1e-4 * np.abs(want[1][path])).sum())
        total += want[1][path].size
    assert outside <= total // 1000, (outside, total)


@pytest.mark.parametrize("name,sizes,kw", [
    ("dp", dict(dp=2, tp=1), {}),
    ("fsdp", dict(dp=2, tp=1), dict(fsdp=True)),
    ("tp", dict(dp=1, tp=2), {}),
    ("pp", dict(dp=1, tp=1, pp=2), dict(pp_microbatches=2)),
])
def test_train_step_matches_jax_mesh_and_one_process(pool, tiny, jax_mesh_steps, one_process,
                                                     name, sizes, kw):
    _, params = tiny
    got = pool.run(R.train_steps, params, global_batch(tiny[0].tok), sizes, augment=False,
                   **kw)[0]
    _close(got, one_process[False])
    _close(got, jax_mesh_steps[False])


@pytest.mark.parametrize("bn_stats", ["onepass", "twopass"])
def test_dp_step_with_augment_and_train_mode_bn(pool, tiny, jax_mesh_steps, one_process,
                                                bn_stats):
    _, params = tiny
    batch = global_batch(tiny[0].tok)
    kw = dict(augment=True, prng="threefry", noise_bank=BANK, bn_stats=bn_stats)
    got = pool.run(R.train_steps, params, batch, dict(dp=2, tp=1), **kw)[0]
    want = one_process[True] if bn_stats == "onepass" else R.one_process_steps(params, batch,
                                                                               **kw)
    _augmented_close(got, want)
    if bn_stats == "onepass":
        _augmented_close(got, jax_mesh_steps[True])


def test_dp_step_generator_draws_are_the_global_batchs(pool, tiny):
    """The torch-generator route: each rank's draws are the global draw,
    sliced, so dp=2 is the one-process step."""
    _, params = tiny
    batch = global_batch(tiny[0].tok)
    kw = dict(augment=True, noise_bank=BANK)
    _augmented_close(pool.run(R.train_steps, params, batch, dict(dp=2, tp=1), **kw)[0],
                     R.one_process_steps(params, batch, **kw))


def test_dp_step_flash_dropout_hashes_global_rows(monkeypatch, pool, tiny):
    """AV-HuBERT's attention on its flash route, as on the card, where B3 and
    B4 drop by a hash of each row's index: a dp=2 rank hashes its rows by
    their index in the global batch (`collectives.first_row`), so the step
    is the one-process step on the global batch."""
    import omni_avsr_tpu_torch.models.avhubert as avh

    _, params = tiny
    batch = global_batch(tiny[0].tok)
    kw = dict(augment=True, noise_bank=BANK)  # train mode: AV-HuBERT's dropout
    monkeypatch.setattr(avh, "_flash_path", lambda q: True)
    _augmented_close(pool.run(R.flash_path_steps, params, batch, dict(dp=2, tp=1), **kw)[0],
                     R.one_process_steps(params, batch, **kw))


def chip_smoke_on_cpu(monkeypatch):
    """chip_smoke.py with its card replaced by this CPU, for a rehearsal of
    its multi-rank cases at the tiny widths (the rank functions stub the
    card's counters in their own processes): its device and card name, the
    card's synchronise and memory counters as no-ops, (t)'s batch at 2
    clips of 40 frames, and no kernel launches expected."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "DEV", "cpu")
    monkeypatch.setattr(cs, "card", lambda: "cpu")
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated", "memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "B_TRAIN", 2)
    monkeypatch.setattr(cs, "FRAMES_TRAIN", 40)
    for name in ("train_launches", "u_launches"):
        monkeypatch.setattr(cs, name, lambda *a, **k: cs.counts())
    return cs


def test_chip_smoke_training_ranks_rehearse(monkeypatch, pool):
    """chip_smoke.py's (v1) at the tiny widths on this file's ranks: the
    meshless reference (`r_reference`) and the rank function
    (`r_rank_run`) at dp 2 with and without FSDP, held by `r_case` to the
    reference and to each other, the state after the step included; and
    its pp 2 case (2 microbatches, gloo's point-to-point on CPU tensors),
    which the card does not run while gloo cannot send a card tensor."""
    cs = chip_smoke_on_cpu(monkeypatch)
    ref = cs.r_reference("(v) tiny", R.tiny_model, (), cs.counters())
    rows = cs.r_case("(v) tiny", pool, ref, R.tiny_model, (), dict(dp=2, tp=1),
                     (("dp", {}), ("fsdp", dict(fsdp=True))), "cpu", pairs=(("fsdp", "dp"),))
    rows.update(cs.r_case("(v) tiny", pool, ref, R.tiny_model, (), dict(dp=1, tp=1, pp=2),
                          (("pp", dict(microbatches=2)),), "cpu"))
    for run in ("dp", "fsdp", "pp"):
        for agree in rows[f"(v) tiny {run}"]["agreement"]:
            assert agree["grad_rel_l2"] < 1e-5, agree
            assert max(agree["state_rel_l2"].values()) < 1e-5, agree


def test_sequence_parallel_matches_no_sp(pool, tiny):
    """tp=2 with SP: the decoder's T (the three tasks' 23, 17 and 25 with the
    tiny window) does not divide 2, so the stream is padded and cut."""
    _, params = tiny
    batch = global_batch(tiny[0].tok)
    want = pool.run(R.train_steps, params, batch, dict(dp=1, tp=2), augment=False)[0]
    got = pool.run(R.train_steps, params, batch, dict(dp=1, tp=2), augment=False,
                   sequence_parallel=True)[0]
    _close(got, want)
    _close(got, R.one_process_steps(params, batch, augment=False))


def test_expert_parallel_matches_ep1(pool):
    jmoe = jax_moe_flagship()
    moe = jax.tree_util.tree_map(np.asarray, jax_tiny_params(jmoe))
    batch = global_batch(jmoe.tok)
    got = pool.run(R.train_steps, moe, batch, dict(dp=1, tp=1, ep=2), moe_experts=4,
                   augment=False)[0]
    _close(got, R.one_process_steps(moe, batch, moe_experts=4, augment=False))
    # dp=2 routes the global batch's tokens, as one device does
    got = pool.run(R.train_steps, moe, batch, dict(dp=2, tp=1), moe_experts=4,
                   augment=False)[0]
    _close(got, R.one_process_steps(moe, batch, moe_experts=4, augment=False))



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


