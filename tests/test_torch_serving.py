"""The port's HTTP serving on the CPU: /health, /encode, the error codes, the
micro-batcher, /predict over an exported model (a demo Dcn exported on the
CPU), the remote client, and the `cli.encode` / `cli.serve` entry points
with --device cpu."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import _torch_parity as tp  # noqa: F401  (pins torch threads)

from recommendflow_tpu_torch.encoder import (TextEncoderService, Tokenizer,
                                             build_demo_vocab)
from recommendflow_tpu_torch.serving import (EncodeServer, RemoteEncoderClient,
                                             make_server)
from recommendflow_tpu_torch.serving.server import _MicroBatcher

SIZES = dict(max_len=8, batch_size=4, model_dim=16, num_layers=1)


class FakeEncoder:
    """Deterministic stand-in: row = len(text) + 1 everywhere."""
    dim = 8

    def __init__(self, delay=0.0):
        self.calls, self.delay = 0, delay

    def encode(self, texts, normalize=True):
        import time
        self.calls += 1
        time.sleep(self.delay)
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        out = np.stack([np.full(self.dim, float(len(t)) + 1.0) for t in texts])
        if normalize:
            out = out / np.linalg.norm(out, axis=1, keepdims=True)
        return out.astype(np.float32)


def _serve(encoder, **kw):
    backend = EncodeServer(encoder, **kw)
    httpd = make_server(backend, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return backend, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    backend, httpd, url = _serve(FakeEncoder(), max_batch=16)
    yield url
    httpd.shutdown()
    httpd.server_close()
    backend.close()


def _post(url, path, payload):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _code(fn):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    return e.value.code


def test_health(server):
    with urllib.request.urlopen(server + "/health?probe=1", timeout=10) as r:
        h = json.loads(r.read())
    assert h["status"] == "ok" and h["device"] == "cpu" and h["card"] is None
    assert h["endpoints"] == ["/health", "/encode"]


def test_encode_and_errors(server):
    out = _post(server, "/encode", {"texts": ["ab", "xyz"], "normalize": False})
    assert out["dim"] == 8
    np.testing.assert_allclose(out["embeddings"], [[3.0] * 8, [4.0] * 8])
    assert _post(server, "/encode", {"texts": []}) == {"embeddings": [], "dim": 8}
    assert _code(lambda: _post(server, "/encode", {"texts": ["a"] * 17})) == 400
    assert _code(lambda: _post(server, "/encode", {"texts": "a"})) == 400
    assert _code(lambda: urllib.request.urlopen(server + "/encode",
                                                timeout=10)) == 400
    assert _code(lambda: _post(server, "/nope", {})) == 404
    for bad in (b"[]", b'"hello"', b"42"):
        req = urllib.request.Request(server + "/encode", data=bad,
                                     method="POST")
        assert _code(lambda: urllib.request.urlopen(req, timeout=10)) == 400
    req = urllib.request.Request(
        server + "/encode", data=b"{}", method="POST",
        headers={"Content-Length": str(1 << 34)})
    assert _code(lambda: urllib.request.urlopen(req, timeout=10)) == 413


@pytest.fixture(scope="module")
def dcn_export(tmp_path_factory):
    """(path, batch): conf/demo_ranking.yaml's Dcn exported on the CPU at a
    serving batch of 4 rows, labels baked in as zeroed constants, and a
    serving batch of that shape."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.export import export_model
    from recommendflow_tpu_torch.models.ranking.dcn import Dcn
    model = Dcn(Configuration(f"{tp.ROOT}/conf/demo_ranking.yaml"),
                hidden_units=[32], device="cpu")
    batch = synthetic_batch(model.schema, 4, seed=2)
    labels = model.schema.label_names
    serve = {k: v for k, v in batch.items() if k not in labels}
    path = export_model(model, serve, str(tmp_path_factory.mktemp("dcn") / "m"),
                        constants={k: np.zeros_like(batch[k]) for k in labels})
    return path, serve


def _post_json(url, path, body: bytes):
    req = urllib.request.Request(url + path, data=body, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    return e.value.code, json.loads(e.value.read())["error"]


def test_predict_waits_for_the_export(server, dcn_export):
    """/predict answers from an exported model: the encoder-only server has
    none (404), a server given a ServingModel answers with its outputs
    bitwise (the JSON round trip of f32 is exact) and, with no encoder,
    answers /encode with 404; a server with neither backend is refused."""
    from recommendflow_tpu_torch.serving import ServingModel
    code, err = _post_json(server, "/predict", b'{"batch": {}}')
    assert code == 404 and "no serving model" in err
    with pytest.raises(ValueError, match="need an encoder and/or a serving"):
        EncodeServer(None)
    path, batch = dcn_export
    sm = ServingModel.load(path, device="cpu")
    backend, httpd, url = _serve(None, serving_model=sm, max_batch=16)
    try:
        with urllib.request.urlopen(url + "/health", timeout=10) as r:
            h = json.loads(r.read())
        assert h["endpoints"] == ["/health", "/predict"] and h["device"] == "cpu"
        out = _post(url, "/predict",
                    {"batch": {k: v.tolist() for k, v in batch.items()}})
        want = sm.predict(batch)
        assert sorted(out) == sorted(want) == ["label", "logit", "score"]
        for k, v in want.items():
            got = np.asarray(out[k], dtype=v.dtype)
            assert np.array_equal(got.view(np.uint32), v.view(np.uint32)), k
        code, err = _post_json(url, "/encode", b'{"texts": ["a"]}')
        assert code == 404 and "no encoder" in err
    finally:
        httpd.shutdown()
        httpd.server_close()
        backend.close()


def test_predict_bad_bodies_are_400(dcn_export):
    """The client's mistakes answer 400, as in the JAX package's
    tests/test_serving.py: 'batch' not a dict, too many rows, a wrong shape,
    a missing input, an id outside its table (checked on the host); the
    next request is answered. The missing input is posted where max_batch
    admits the batch, so it reaches ServingModel.predict's KeyError (the
    JAX server answers that KeyError 404, a LookupError's answer)."""
    from recommendflow_tpu_torch.serving import ServingModel
    path, batch = dcn_export
    sm = ServingModel.load(path, device="cpu")
    backend, httpd, url = _serve(None, serving_model=sm, max_batch=3)
    body = {k: v.tolist() for k, v in batch.items()}
    try:
        bad_id = dict(body, user_id=(batch["user_id"] + 10 ** 6).tolist())
        cases = {"not a dict": {"batch": [1, 2]},
                 "too many rows": {"batch": body}}
        for what, payload in cases.items():
            code, _ = _post_json(url, "/predict", json.dumps(payload).encode())
            assert code == 400, what
        backend.max_batch = 16
        short = dict(body, user_id=body["user_id"][:2])
        missing = {"user_id": body["user_id"]}
        for what, payload in (("missing", missing), ("shape", short),
                              ("'user_id'", bad_id)):
            code, err = _post_json(url, "/predict",
                                   json.dumps({"batch": payload}).encode())
            assert code == 400 and what in err
        out = _post(url, "/predict", {"batch": body})
        np.testing.assert_array_equal(np.asarray(out["score"], np.float32),
                                      sm.predict(batch)["score"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        backend.close()


def test_unknown_endpoint_is_404_and_missing_input_400(dcn_export):
    """A path the server does not serve answers 404, by GET and by POST,
    beside a model; a body that lacks an exported input answers 400."""
    from recommendflow_tpu_torch.serving import ServingModel
    path, batch = dcn_export
    sm = ServingModel.load(path, device="cpu")
    backend, httpd, url = _serve(None, serving_model=sm, max_batch=16)
    try:
        code, err = _post_json(url, "/nope", b"{}")
        assert code == 404 and "unknown endpoint" in err
        assert _code(lambda: urllib.request.urlopen(url + "/nope",
                                                    timeout=30)) == 404
        code, err = _post_json(url, "/predict", json.dumps(
            {"batch": {"user_id": batch["user_id"].tolist()}}).encode())
        assert code == 400 and "missing" in err
    finally:
        httpd.shutdown()
        httpd.server_close()
        backend.close()


def test_nonfinite_output_is_500():
    class NanEncoder(FakeEncoder):
        def encode(self, texts, normalize=True):
            return np.full((len(texts), 2), np.nan, np.float32)

    backend, httpd, url = _serve(NanEncoder())
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, "/encode", {"texts": ["x"]})
        assert e.value.code == 500
        assert "non-finite" in json.loads(e.value.read())["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        backend.close()


def test_microbatcher_coalesces_and_preserves_results():
    enc = FakeEncoder(delay=0.05)
    b = _MicroBatcher(enc.encode, window_ms=30.0, max_batch=64)
    results = {}

    def client(i):
        texts = ["x" * (i + 1), "y" * (i + 2)]
        results[i] = (texts, b.encode(texts, normalize=i % 2 == 0))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    b.close()
    assert b.batches_run < 12 and b.requests_batched == 12
    for i, (texts, got) in results.items():
        np.testing.assert_allclose(
            got, FakeEncoder().encode(texts, normalize=i % 2 == 0))


def test_microbatcher_delivers_errors_and_survives():
    def encode(texts, normalize=True):
        if any("BOOM" in t for t in texts):
            raise ValueError("poisoned batch")
        return FakeEncoder().encode(texts, normalize)

    b = _MicroBatcher(encode, window_ms=1.0, max_batch=64)
    with pytest.raises(ValueError, match="poisoned"):
        b.encode(["BOOM"])
    assert b.encode(["fine"]).shape == (1, 8)
    b.close()


def test_concurrent_requests_through_http():
    enc = FakeEncoder(delay=0.002)
    backend, httpd, url = _serve(enc, max_batch=512, batch_window_ms=4.0)
    errors = []

    def client(ci):
        for r in range(10):
            texts = ["a" * (ci + 1), "b" * (r % 5 + 1)]
            try:
                got = _post(url, "/encode", {"texts": texts, "normalize": False})
                np.testing.assert_allclose(
                    got["embeddings"], FakeEncoder().encode(texts, False))
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    httpd.shutdown()
    httpd.server_close()
    backend.close()
    assert not errors, errors[:3]
    assert backend.requests_served == 60 and enc.calls < 60


def test_remote_client_roundtrip_and_fallback(server):
    client = RemoteEncoderClient(server, local=None)
    assert client.ping()
    np.testing.assert_allclose(client.encode(["hello"], normalize=False), 6.0)
    dead = RemoteEncoderClient("http://127.0.0.1:1", local=FakeEncoder(),
                               connect_timeout=0.2, request_timeout=0.2)
    np.testing.assert_allclose(dead.encode(["ab"], normalize=False), 3.0)
    assert dead._alive is False
    with pytest.raises(RuntimeError, match="no local fallback"):
        RemoteEncoderClient("http://127.0.0.1:1", connect_timeout=0.2).encode(["x"])


def test_real_service_behind_the_server():
    svc = TextEncoderService(Tokenizer(build_demo_vocab(["hello", "world"])),
                             device="cpu", **SIZES)
    backend, httpd, url = _serve(svc)
    try:
        texts = ["hello world", "world", "hello there"]
        served = RemoteEncoderClient(url).encode(texts)
        direct = svc.encode(texts)
        assert served.dtype == np.float32
        np.testing.assert_array_equal(served, direct)
    finally:
        httpd.shutdown()
        httpd.server_close()
        backend.close()


def _vocab_file(tmp_path):
    path = tmp_path / "vocab.txt"
    vocab = build_demo_vocab(["hello", "world", "deep", "rank"])
    path.write_text("\n".join(sorted(vocab, key=vocab.get)) + "\n")
    return str(path)


def test_encode_cli_on_the_cpu(tmp_path):
    from recommendflow_tpu_torch.cli import encode as encode_cli
    vocab = _vocab_file(tmp_path)
    svc = TextEncoderService(Tokenizer(vocab), device="cpu", seed=5,
                             use_whitening=True, **SIZES)
    texts = ["hello world", "deep rank", "rank hello", "world deep rank",
             "hello", "deep"]
    ref = svc.encode(texts)
    weights = str(tmp_path / "w")
    svc.save(weights)
    (tmp_path / "in.txt").write_text("\n".join(texts[:3] + [" "] + texts[3:]))
    emb = encode_cli.main([
        "--vocab", vocab, "--input", str(tmp_path / "in.txt"), "--out",
        str(tmp_path / "out"), "--weights", weights, "--max_len", "8",
        "--model_dim", "16", "--num_layers", "1", "--device", "cpu"])
    saved = np.load(str(tmp_path / "out.npz"))
    assert list(saved["texts"]) == texts
    np.testing.assert_array_equal(saved["embeddings"], emb)
    # the batch size differs from the service's (256 vs 4): same rows
    np.testing.assert_allclose(emb, ref, rtol=0, atol=1e-6)


def test_serve_cli_on_the_cpu(tmp_path, dcn_export):
    from recommendflow_tpu_torch.cli import serve as serve_cli
    vocab = _vocab_file(tmp_path)
    args = ["--vocab", vocab, "--host", "127.0.0.1", "--port", "0",
            "--max_len", "8", "--model_dim", "16", "--num_layers", "1",
            "--device", "cpu"]
    backend, httpd = serve_cli.build(args)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/health", timeout=10) as r:
            assert json.loads(r.read())["device"] == "cpu"
        out = _post(url, "/encode", {"texts": ["hello world"]})
        assert out["dim"] == 16
        np.testing.assert_allclose(np.linalg.norm(out["embeddings"]), 1.0,
                                   atol=1e-5)
    finally:
        httpd.shutdown()
        httpd.server_close()
        backend.close()
    # --model beside --vocab serves both endpoints
    backend, httpd = serve_cli.build(args + ["--model", dcn_export[0]])
    try:
        assert backend.handle_health({})["endpoints"] == [
            "/health", "/encode", "/predict"]
    finally:
        httpd.server_close()
        backend.close()
    with pytest.raises(SystemExit):
        serve_cli.build(["--device", "cpu"])


def test_serve_cli_with_a_model_on_the_cpu(dcn_export):
    """--model alone: /predict from the export (warmed before the bind),
    /encode 404."""
    from recommendflow_tpu_torch.cli import serve as serve_cli
    from recommendflow_tpu_torch.serving import ServingModel
    path, batch = dcn_export
    backend, httpd = serve_cli.build(["--model", path, "--host", "127.0.0.1",
                                      "--port", "0", "--device", "cpu"])
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/health", timeout=10) as r:
            assert json.loads(r.read())["endpoints"] == ["/health", "/predict"]
        out = _post(url, "/predict",
                    {"batch": {k: v.tolist() for k, v in batch.items()}})
        np.testing.assert_array_equal(
            np.asarray(out["score"], np.float32),
            ServingModel.load(path, device="cpu").predict(batch)["score"])
        code, _ = _post_json(url, "/encode", b'{"texts": ["a"]}')
        assert code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        backend.close()
