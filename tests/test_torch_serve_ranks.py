"""Serving over ranks on the CPU: `ClipService(mesh=)` in gloo groups of 2
and 4 processes against JAX's `ClipService(mesh=)` over as many CPU
devices and against the port's one-process service, on the same weights;
and `serve --mesh_data 2` as two processes: the selftest, a bad request, a
preloaded index, STOP, and a follower that dies."""
import json
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from dclip_tpu.core.config import CLIPConfig
from dclip_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from dclip_tpu.serve import ClipService as JaxClipService
from dclip_tpu_torch.data.tokenizer import HashTokenizer
from dclip_tpu_torch.serve import ClipService

import torch_dp
import torch_parity

# L2-normalized embeddings after a 2-layer tower at f32 (different sum
# orders in the two frameworks): tests/test_torch_serve.py's bound.
EMB_TOL = dict(rtol=1e-4, atol=1e-5)
# The port over ranks against the port in one process: only the rows a
# GEMM sees at once differ (tests/test_torch_serve.py's padding bound).
SAME_TOL = dict(rtol=1e-5, atol=1e-6)
TEXTS = ["a dog", "two cats on a mat", "red car", "a house", "blue bird", "tree",
         "boat on water"]
BUCKETS = (4, 8)
K = 3
RANK_TIMEOUT = 240


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_ranks")
    cfg = CLIPConfig.tiny_test()
    jax_model, params = torch_parity.jax_clip(cfg, seed=0)
    port = torch_parity.port_clip(cfg, params)
    torch.save(port.state_dict(), tmp / "clip.pt")
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, (40 + 3 * i, 37 + 5 * i, 3), np.uint8) for i in range(5)]
    index = rng.randn(7, cfg.projection_dim).astype(np.float32)
    queries = rng.randn(3, cfg.projection_dim).astype(np.float32)
    np.savez(tmp / "inputs.npz", n_images=np.int64(len(images)), index=index, queries=queries,
             **{f"image{i}": im for i, im in enumerate(images)})
    ids = [f"img{i}" for i in range(len(index))]
    tok = HashTokenizer(vocab_size=cfg.text.vocab_size, max_length=cfg.text.max_length)

    def one_process(quantize=None):
        svc = ClipService(torch_parity.port_clip(cfg, params), cfg, tokenizer=tok,
                          buckets=BUCKETS, index_dim=cfg.projection_dim, quantize=quantize,
                          device="cpu")
        out = {"texts": svc.encode_texts(TEXTS), "images": svc.encode_images(images)}
        svc.add_to_index(ids, index)
        out["search"] = svc.search(queries, k=K)
        out["search_texts"] = svc.search_texts(TEXTS[:3], k=K)
        return out

    spec = {"scenario": "serve", "clip": str(tmp / "clip.pt"), "inputs": str(tmp / "inputs.npz"),
            "texts": TEXTS, "ids": ids, "buckets": list(BUCKETS), "k": K}
    return dict(tmp=tmp, cfg=cfg, jax_model=jax_model, params=params, images=images,
                index=index, queries=queries, ids=ids, spec=spec,
                one={None: one_process(), "int8": one_process("int8")})


def _jax_mesh_service(s, n, cpu_devices):
    cfg = s["cfg"]
    tok = JaxHashTokenizer(vocab_size=cfg.text.vocab_size, max_length=cfg.text.max_length)
    svc = JaxClipService(s["jax_model"], {"params": s["params"]}, cfg, tokenizer=tok,
                         buckets=BUCKETS, index_dim=cfg.projection_dim,
                         mesh=JaxMesh(np.array(cpu_devices[:n]), ("data",)))
    out = {"texts": svc.encode_texts(TEXTS), "images": svc.encode_images(s["images"])}
    svc.add_to_index(s["ids"], s["index"])
    out["search"] = svc.search(s["queries"], k=K)
    return out


def _hold_hits(got, want, **tol):
    assert [[i for i, _ in row] for row in got] == [[i for i, _ in row] for row in want]
    np.testing.assert_allclose([[x for _, x in row] for row in got],
                               [[x for _, x in row] for row in want], **tol)


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_service_matches_jax_and_one_process(setup, cpu_devices, n):
    """Every rank returns the same rows and hits, which hold to JAX's mesh
    service at EMB_TOL (search ids equal, scores 1e-5) and to the port's
    one-process service at the padding bound (ids equal), though each
    follower's model was perturbed: the weights are global rank 0's. At 2
    ranks also the int8 route and the refusals."""
    s = setup
    spec = dict(s["spec"], int8=n == 2, refusals=n == 2)
    ranks = torch_dp.run_ranks(s["tmp"], f"serve{n}", spec, n, timeout=RANK_TIMEOUT)
    for r, res in enumerate(ranks[1:], 1):
        for key, value in res.items():
            if key.endswith(("texts", "images")):
                np.testing.assert_array_equal(value, ranks[0][key], err_msg=f"rank {r} {key}")
            elif key != "refusals":
                assert value == ranks[0][key], (r, key)
    got = ranks[0]
    want = _jax_mesh_service(s, n, cpu_devices)
    np.testing.assert_allclose(got["f32/texts"], want["texts"], **EMB_TOL)
    np.testing.assert_allclose(got["f32/images"], want["images"], **EMB_TOL)
    _hold_hits(got["f32/search"], want["search"], rtol=1e-5)
    for tag, quantize in (("f32", None), ("int8", "int8")) if n == 2 else (("f32", None),):
        one = s["one"][quantize]
        np.testing.assert_allclose(got[f"{tag}/texts"], one["texts"], **SAME_TOL)
        np.testing.assert_allclose(got[f"{tag}/images"], one["images"], **SAME_TOL)
        _hold_hits(got[f"{tag}/search"], one["search"], **SAME_TOL)
        _hold_hits(got[f"{tag}/search_texts"], one["search_texts"], **SAME_TOL)
        assert got[f"{tag}/stats"]["mesh"] == {"data": n, "model": 1}
    if n == 2:
        refusals = got["refusals"]
        assert refusals["buckets"] == ("ValueError", "buckets [1] do not divide the mesh data "
                                       "size 2; pick multiples so every padded batch shards "
                                       "evenly")
        assert refusals["model_axis"][0] == "ValueError"
        assert "model axis" in refusals["model_axis"][1]
        assert refusals["int"][0] == "TypeError"


# -- the serve CLI over two processes -----------------------------------------------

CLI = ["--device", "cpu", "--model_preset", "tiny", "--clip_weights", "random",
       "--tokenizer_dir", "hash", "--buckets", "2,4", "--index_dim", "16"]


def _start(argv, n, port):
    """n ranks of `serve ... --mesh_data n` (n > 1), or one process."""
    mesh = ["--mesh_data", str(n)] if n > 1 else []
    cmd = [sys.executable, "-m", "dclip_tpu_torch.cli.serve", *CLI, *mesh, *argv]
    return [subprocess.Popen(cmd, env=torch_dp.rank_env(port, n, r), cwd=torch_dp.REPO,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for r in range(n)]


def _selftest_lines(out: str) -> dict:
    lines = {}
    for line in out.splitlines():
        head, _, rest = line.partition(":")
        lines[head] = rest.strip()
    return lines


def test_cli_mesh_selftest_matches_one_process():
    """`serve --mesh_data 2 --selftest` as two processes: rank 0's selftest
    says what the one-process selftest says (the probe's score to 1e-5,
    the stats but for the mesh and the batchers' latencies); rank 1 follows
    until STOP; both exit 0. In one process without a group the flag
    raises JAX's message."""
    for attempt in range(3):  # a new port if another process took the group's
        port = torch_dp.free_port()
        procs = _start(["--selftest"], 2, port) + _start(["--selftest"], 1, port)
        try:
            outs = torch_dp.wait_all(procs, timeout=RANK_TIMEOUT)
            break
        except AssertionError as e:
            if "EADDRINUSE" not in str(e) or attempt == 2:
                raise
    mesh, follower, one = (_selftest_lines(o) for o in outs)
    assert "rank 1: following rank 0 on cpu" in outs[1]
    assert mesh.pop("SELFTEST OK") == one.pop("SELFTEST OK") == ""
    hits, want = json.loads(mesh.pop("search")), json.loads(one.pop("search"))
    assert hits["results"][0][0]["id"] == want["results"][0][0]["id"] == "probe"
    assert hits["results"][0][0]["score"] == pytest.approx(want["results"][0][0]["score"],
                                                           abs=1e-5)
    stats, want = json.loads(mesh.pop("stats")), json.loads(one.pop("stats"))
    assert stats["service"].pop("mesh") == {"data": 2, "model": 1}
    assert want["service"].pop("mesh") == {"data": 1, "model": 1}
    for b in ("text_batcher", "image_batcher"):
        for d in (stats[b], want[b]):
            del d["mean_latency_s"], d["max_latency_s"]
    assert stats == want
    assert mesh == one  # healthz, the embeddings' shapes

    from dclip_tpu_torch.cli import serve as cli_serve

    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        cli_serve.main(CLI + ["--mesh_data", "2", "--selftest"])


def _serving(argv):
    """Two ranks of a live `serve --mesh_data 2 ... --port 0`: (processes,
    rank 0's HTTP port), on a new group port if another process took the
    first (EADDRINUSE)."""
    for attempt in range(3):
        procs = _start(argv + ["--port", "0", "--no_warmup"], 2, torch_dp.free_port())
        lines = queue.Queue()
        threading.Thread(target=lambda out=procs[0].stdout: [lines.put(x) for x in out]
                         + [lines.put("")], daemon=True).start()
        seen, deadline = [], time.monotonic() + RANK_TIMEOUT
        while time.monotonic() < deadline:
            try:
                line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                break
            if not line:
                break
            seen.append(line)
            if "serving on" in line:
                return procs, int(line.rsplit(":", 1)[1])
        for p in procs:
            if p.poll() is None:
                p.kill()
        err = procs[0].communicate(timeout=60)[1]
        procs[1].communicate(timeout=60)
        if "EADDRINUSE" not in err or attempt == 2:
            raise AssertionError(f"rank 0 did not serve: {seen}\n{err[-4000:]}")


def _post(port: int, route: str, payload: dict):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_cli_mesh_serves_a_preloaded_index_and_survives_a_bad_request(tmp_path):
    """A live `serve --mesh_data 2` with `--index_path`, read by rank 0
    only: an image that does not decode and an add of the wrong width
    answer 400, the next requests answer what the one-process service
    answers (texts at the padding bound, search ids equal and scores to
    1e-5), also to 12 concurrent callers, and after SIGINT rank 0
    broadcasts STOP and both ranks exit 0."""
    from dclip_tpu_torch.cli import serve as cli_serve
    from dclip_tpu_torch.data.embedding_store import EmbeddingStore

    rng = np.random.RandomState(3)
    keys = rng.randn(9, 16).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=-1, keepdims=True)
    store = str(tmp_path / "index.npz")
    EmbeddingStore.from_arrays(keys, ids=[f"row{i}" for i in range(9)]).save(store)
    argv = ["--index_path", store]
    one = cli_serve.build_service(cli_serve.parse_args(CLI + argv))
    texts = ["a dog", "a red car", "three birds"]

    procs, port = _serving(argv)
    try:
        code, body = _post(port, "/v1/embeddings/image", {"images_b64": ["bm90IGFuIGltYWdl"]})
        assert code == 400 and "error" in body
        # Refused on rank 0 before any other rank hears of it.
        code, body = _post(port, "/v1/index/add", {"ids": ["x"], "embeddings": [[0.5] * 15]})
        assert code == 400 and "index of dim 16" in body["error"]
        code, body = _post(port, "/v1/embeddings/text", {"texts": texts})
        assert code == 200
        np.testing.assert_allclose(np.asarray(body["embeddings"], np.float32),
                                   one.encode_texts(texts), **SAME_TOL)
        code, body = _post(port, "/v1/search", {"texts": texts, "k": 4})
        assert code == 200
        want = one.search_texts(texts, k=4)
        _hold_hits([[(h["id"], h["score"]) for h in row] for row in body["results"]], want,
                   rtol=0, atol=1e-5)
        # Concurrent callers (both batchers, several HTTP threads): every
        # answer is still its own, so the ranks took the commands in one order.
        answers = {}

        def client(i):
            text = texts[i % len(texts)]
            route, payload = (("/v1/search", {"texts": [text], "k": 2}) if i % 2 else
                              ("/v1/embeddings/text", {"texts": [text]}))
            answers[i] = (text, _post(port, route, payload))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and len(answers) == 12
        for i, (text, (code, body)) in answers.items():
            assert code == 200, body
            if i % 2:
                _hold_hits([[(h["id"], h["score"]) for h in body["results"][0]]],
                           one.search_texts([text], k=2), rtol=0, atol=1e-5)
            else:
                np.testing.assert_allclose(np.asarray(body["embeddings"], np.float32),
                                           one.encode_texts([text]), **SAME_TOL)
        procs[0].send_signal(signal.SIGINT)
        outs = torch_dp.wait_all(procs, timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert "rank 1: following rank 0 on cpu" in outs[1]
    assert "loaded index: 9 entries, dim 16" not in outs[1]  # rank 0 read the file


def test_cli_mesh_rank0_exits_when_a_follower_dies():
    """SIGKILL to rank 1 of a live `serve --mesh_data 2`: a request is not
    answered 200 by rank 0 alone, and rank 0 exits non-zero within 30 s
    (its heartbeat finds the dead peer even without a request)."""
    procs, port = _serving([])
    try:
        assert _post(port, "/v1/embeddings/text", {"texts": ["a dog"]})[0] == 200
        procs[1].kill()
        procs[1].communicate()
        t0 = time.monotonic()
        try:
            code = _post(port, "/v1/embeddings/text", {"texts": ["a dog"]})[0]
        except (urllib.error.URLError, ConnectionError):
            code = None
        assert code != 200
        _, err = procs[0].communicate(timeout=30)
        elapsed = time.monotonic() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert procs[0].returncode not in (0, None), err[-2000:]
    assert elapsed <= 30
    assert "the group of ranks failed" in err
