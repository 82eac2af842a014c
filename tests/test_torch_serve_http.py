"""The port's HTTP batching server (`omni_avsr_tpu_torch/cli/serve_http.py`)
on the cases of the JAX package's tests/test_serve_http.py, over a port
`Transcriber` of the JAX tests' tiny model (tests/test_omni.py::tiny_omni)
on the JAX tree, f32 on both sides: concurrent requests batch, batched
transcripts equal single ones and the JAX `Transcriber`'s, incompatible
requests and bucket classes decode apart, the 400 / 404 / 500 / 504 paths,
a poison request errors alone; and the `--synthetic` command serves on the
CPU.
"""

import base64
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from omni_avsr_tpu_torch.bridge import params_from_numpy
from omni_avsr_tpu_torch.cli.serve_http import BatchingServer, serve
from omni_avsr_tpu_torch.serve import Transcriber, bucket_ladder
from tests.torch_parity import jax_in_f32, port_model, randomize_lora_down

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    """(JAX Transcriber, port Transcriber) of the tiny model on one f32
    numpy tree, beam 2, 4 new tokens."""
    from omni_avsr_tpu.serve import Transcriber as JaxTranscriber
    from tests.test_omni import tiny_omni

    jm = tiny_omni()
    init = jax.jit(lambda k: jm.init_params(k, frozen_dtype=jnp.float32))
    params = randomize_lora_down(jax.device_get(init(jax.random.PRNGKey(0))))
    with pytest.MonkeyPatch.context() as mp:
        jax_in_f32(mp)
        jt = JaxTranscriber(jm, jax.tree_util.tree_map(jnp.asarray, params), num_beams=2,
                            max_new_tokens=4)
    pt = Transcriber(port_model(jm), params_from_numpy(params, "cpu"), num_beams=2,
                     max_new_tokens=4, device="cpu")
    return jt, pt


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def f32(monkeypatch):
    jax_in_f32(monkeypatch)
    monkeypatch.setenv("OMNI_BEAM_ATTN", "kernel")


def _audio(seed, n=16000):
    return (np.random.RandomState(seed).randn(n) * 0.1).astype(np.float32)


@pytest.fixture()
def http(pair):
    """A served port Transcriber: (url, batcher); shut down after."""
    httpd, batcher = serve(pair[1], port=0, max_batch=4, max_wait_ms=200)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", batcher
    httpd.shutdown()
    batcher.shutdown()


def _post(url, body: dict, timeout=300):
    req = urllib.request.Request(f"{url}/transcribe", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_transcribe_many_matches_single_and_jax(f32, pair):
    """Items of one bucket class decode the same batched or alone, and as
    the JAX `Transcriber` decodes them."""
    jt, pt = pair
    items = [{"audio": _audio(0, 16000 + 1500 * i)} for i in range(3)]
    assert len({bucket_ladder(len(it["audio"]), 640 * pt.video_pad_multiple)
                for it in items}) == 1
    batched = pt.transcribe_many(items, modality="audio")
    assert batched == [pt.transcribe(audio=it["audio"]) for it in items]
    assert batched == jt.transcribe_many(items, modality="audio") and all(batched)


def test_transcribe_many_audiovisual_matches_jax(f32, pair):
    jt, pt = pair
    rng = np.random.RandomState(3)
    items = [{"audio": _audio(1, 16000), "video": rng.randint(0, 255, (25, 96, 96, 3),
                                                             dtype=np.uint8)},
             {"audio": _audio(2, 20000), "video": rng.randint(0, 255, (32, 96, 96, 3),
                                                             dtype=np.uint8)}]
    out = pt.transcribe_many(items)
    assert out == jt.transcribe_many(items) and len(out) == 2
    # the ids under the texts (these random weights may end a text at once)
    from omni_avsr_tpu_torch.serve import pad_batch

    batch, trim = pad_batch(items, "audiovisual")
    jax_ids = np.asarray(jt.engine._decode_fn("audiovisual", 4, 2, trim, 2, 4)(
        jt.params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0)))
    ids = pt.decode_ids(batch, "audiovisual", 4, 2, trim, 2).numpy()
    np.testing.assert_array_equal(ids, jax_ids)
    assert (ids != pt.model.tok.pad_id).any()


def test_http_server_batches_concurrent_requests(f32, pair, http):
    jt, _ = pair
    url, batcher = http
    audio = _audio(1)
    results = [None] * 3

    def post(i):
        results[i] = _post(url, {"audio_b64": base64.b64encode(audio.tobytes()).decode()})

    threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert all(r is not None and r[0] == 200 for r in results), results
    # all three arrived within the batching window: one decode call
    assert max(r[1]["batch_size"] for r in results) >= 2
    assert {r[1]["text"] for r in results} == {jt.transcribe(audio=audio)}
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["ok"] and health["requests"] == 3 and health["batches"] <= 2
    assert _post(url, {})[0] == 400  # no media
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"{url}/nowhere", timeout=30)
    assert ei.value.code == 404


def test_batcher_separates_incompatible_groups(pair):
    b = BatchingServer(pair[1], max_batch=4, max_wait_ms=100)
    try:
        audio = _audio(2)
        p1 = b.submit({"audio": audio}, "audio", 1)
        p2 = b.submit({"audio": audio}, "audio", 2)  # other beams
        assert p1.event.wait(300) and p2.event.wait(300)
        assert p1.error is None and p2.error is None
        assert p1.batch_size == 1 and p2.batch_size == 1
        assert b.n_batches == 2
    finally:
        b.shutdown()


def test_batcher_groups_by_bucket_class(f32, pair):
    """Requests of different padded-window classes decode in separate
    batches, each as it decodes alone, and as the JAX `Transcriber` does."""
    jt, pt = pair
    b = BatchingServer(pt, max_batch=4, max_wait_ms=150)
    try:
        short, long = _audio(4, 12000), _audio(5, 60000)
        p1 = b.submit({"audio": short}, "audio", 2)
        p2 = b.submit({"audio": long}, "audio", 2)
        p3 = b.submit({"audio": short.copy()}, "audio", 2)
        assert all(p.event.wait(300) for p in (p1, p2, p3))
        assert all(p.error is None for p in (p1, p2, p3))
        assert p2.batch_size == 1  # its own class
        assert p1.batch_size <= 2 and p3.batch_size <= 2
        assert p1.result == p3.result == pt.transcribe(audio=short) == jt.transcribe(audio=short)
        assert p2.result == pt.transcribe(audio=long) == jt.transcribe(audio=long)
    finally:
        b.shutdown()


def test_http_rejects_modality_payload_mismatch(http):
    """modality "audiovisual" without video, and an unknown modality: 400
    at the handler, before the batcher."""
    url, batcher = http
    audio_b64 = base64.b64encode(_audio(5).tobytes()).decode()
    code, body = _post(url, {"audio_b64": audio_b64, "modality": "audiovisual"})
    assert code == 400 and "requires" in body["error"]
    assert _post(url, {"audio_b64": audio_b64, "modality": "telepathy"})[0] == 400
    assert batcher.n_requests == 0


def test_poison_request_does_not_fail_cobatch(pair):
    """A request that fails inside the decode errors alone; its co-batch is
    retried member by member and succeeds."""
    _, pt = pair
    b = BatchingServer(pt, max_batch=4, max_wait_ms=200)
    try:
        good = _audio(6)
        p_good = b.submit({"audio": good}, "audio", 2)
        p_bad = b.submit({"audio": np.zeros((7, 2), np.float32)}, "audio", 2)  # 2-D audio
        assert p_good.event.wait(300) and p_bad.event.wait(300)
        assert p_bad.error is not None and p_good.error is None
        assert p_good.result == pt.transcribe(audio=good)
        assert b.n_batches == 1  # the good request's retry alone
    finally:
        b.shutdown()


def test_http_decode_error_and_timeout(pair):
    """A decode error reaches the client as a 500 and the batcher thread
    lives on; a request that outlasts the server's timeout is a 504."""
    _, pt = pair
    httpd, batcher = serve(pt, port=0, max_batch=4, max_wait_ms=10)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, body = _post(url, {"audio": [[0.1, 0.2], [0.3, 0.4]]})  # 2-D audio
        assert code == 500 and body["error"]
        code, body = _post(url, {"audio": _audio(7).tolist()})
        assert code == 200 and body["batch_size"] == 1 and body["text"]
    finally:
        httpd.shutdown()
        batcher.shutdown()
    httpd, batcher = serve(pt, port=0, max_batch=4, max_wait_ms=10, timeout_s=1e-3)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        code, body = _post(f"http://127.0.0.1:{httpd.server_address[1]}",
                           {"audio": _audio(8).tolist()})
        assert code == 504 and body["error"] == "decode timeout"
    finally:
        httpd.shutdown()
        batcher.shutdown()


def test_synthetic_server_command(tmp_path):
    """`python -m omni_avsr_tpu_torch.cli.serve_http --synthetic --device
    cpu --port 0`: it prints its address, answers /healthz and one audio
    request with a 200 and a transcript, and stops on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "omni_avsr_tpu_torch.cli.serve_http", "--synthetic",
         "--device", "cpu", "--port", "0"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:"), (line, proc.stderr.read())
        url = line.split()[2]
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            assert json.loads(r.read()) == {"ok": True, "requests": 0, "batches": 0}
        code, body = _post(url, {"audio": _audio(9).tolist()})
        assert code == 200 and isinstance(body["text"], str) and body["batch_size"] == 1
    finally:
        proc.terminate()
        proc.wait(timeout=60)


def test_from_pretrained_allow_random_base(tmp_path, pair):
    """A directory of the port's checkpoints without `base_params`: a
    `ValueError` naming both ways out, or with `allow_random_base=True` the
    trained leaves over `bridge.init_params`' seed-0 tree, as the JAX
    `from_pretrained` merges them over its own init (`omni_avsr_tpu/
    serve.py:136-147`); the server then serves it."""
    from omni_avsr_tpu_torch.bridge import init_params
    from omni_avsr_tpu_torch.train.checkpoint import save_checkpoint
    from omni_avsr_tpu_torch.train.state import TrainState, split_params, tree_leaves

    pm = pair[1].model
    trained = {k: v.float() for k, v in split_params(
        pair[1].params, pm.trainable_predicate())[0]["audio_proj"]["per_rate"]["r4"]["fc1"]
        .items()}
    save_checkpoint(str(tmp_path), 2, TrainState(
        2, {"audio_proj": {"per_rate": {"r4": {"fc1": trained}}}}, None))
    with pytest.raises(ValueError, match="allow_random_base"):
        Transcriber.from_pretrained(str(tmp_path), tokenizer=pm.tok, cfg=pm.cfg, device="cpu")
    t = Transcriber.from_pretrained(str(tmp_path), tokenizer=pm.tok, cfg=pm.cfg,
                                    allow_random_base=True, device="cpu", num_beams=2,
                                    max_new_tokens=4)
    base = init_params(pm.cfg, torch.Generator().manual_seed(0), "cpu")
    torch.testing.assert_close(t.params["audio_proj"]["per_rate"]["r4"]["fc1"]["w"],
                               trained["w"].to(t.model.dtype))
    torch.testing.assert_close(t.params["llm"]["layers"]["attn"]["q"]["w"],
                               base["llm"]["layers"]["attn"]["q"]["w"].to(
                                   t.params["llm"]["layers"]["attn"]["q"]["w"].dtype))
    assert len(list(tree_leaves(t.params))) == len(list(tree_leaves(base)))
    assert isinstance(t.transcribe(audio=_audio(10)), str)


def test_batcher_holds_incompatible_requests_aside(pair):
    """Interleaved traffic of two kinds (audio, audiovisual, audio,
    audiovisual): each kind decodes as one group, in arrival order, where
    the JAX batcher would end a group at every change of kind."""
    _, pt = pair
    rng = np.random.RandomState(11)
    av = [{"audio": _audio(12 + i), "video": rng.randint(0, 255, (20, 96, 96, 3),
                                                          dtype=np.uint8)} for i in range(2)]
    au = [{"audio": _audio(14 + i)} for i in range(2)]
    b = BatchingServer(pt, max_batch=4, max_wait_ms=300)
    try:
        ps = [b.submit(au[0], "audio", 2), b.submit(av[0], "audiovisual", 2),
              b.submit(au[1], "audio", 2), b.submit(av[1], "audiovisual", 2)]
        assert all(p.event.wait(300) for p in ps) and all(p.error is None for p in ps)
        assert [p.batch_size for p in ps] == [2, 2, 2, 2] and b.n_batches == 2
        assert [ps[0].result, ps[2].result] == pt.transcribe_many(au, modality="audio")
        assert [ps[1].result, ps[3].result] == pt.transcribe_many(av, modality="audiovisual")
    finally:
        b.shutdown()
