"""Local HTTP serving endpoint for CLIP embeddings + retrieval, on PyTorch.

    python -m dclip_tpu_torch.cli.serve --model_preset vit-b-16 \
        --clip_weights /path/to/hf_snapshot --tokenizer_dir /path/to/tok \
        --port 8900 --index_dim 512

Counterpart of `dclip_tpu/cli/serve.py`, with the same routes and JSON
(stdlib http.server, threaded; concurrent requests are merged into device
batches by serve.DynamicBatcher):

  POST /v1/embeddings/text   {"texts": ["a dog", ...]}
  POST /v1/embeddings/image  {"images_b64": ["<base64 PNG/JPEG>", ...]}
                          or {"paths": ["/abs/img.jpg", ...]}
  POST /v1/index/add         {"ids": [...], "images_b64"/"paths"/"embeddings"}
  POST /v1/search            {"texts": [...], "k": 5}
  GET  /healthz              -> {"ok": true}
  GET  /v1/stats             -> batcher + service counters

`--selftest` answers one request per route on an ephemeral port and exits
0/1; `--bench` prints one JSON line per (modality, concurrency);
`--quantize int8` serves int8 weights; `--student_checkpoint` serves a
distilled student; `--export_dir` (with `--export_platforms`) writes the
serving artifact of `serve.export` and exits.

`--mesh_data N` (N != 1; -1 takes every rank) serves over the data axis of
a `torch.distributed` group, one process per card, started by torchrun or
with the DCLIP_COORDINATOR / DCLIP_NUM_PROCESSES / DCLIP_PROCESS_ID triple
(`cli.common.serve_mesh`):

    torchrun --nproc_per_node 4 -m dclip_tpu_torch.cli.serve --mesh_data 4 ...

Global rank 0 runs the HTTP server, the batchers, `--selftest` and
`--bench` through `serve.fanout.lead`, which carries every request to the
other ranks; they run `serve.fanout.follow` until rank 0 stops. A failed
group ends rank 0 with a non-zero exit; nothing is served from rank 0
alone. `--export_dir` is written by global rank 0 only.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import sys
import threading
import time
from typing import Sequence

import numpy as np


def load_model(args, compute_dtype: str = "auto"):
    """(cfg, model) from the model flags, with `--student_checkpoint`'s
    weights (a checkpoint of the port's `CheckpointManager`) loaded in."""
    from dclip_tpu_torch.cli.common import load_clip, restore_student_params

    cfg, model = load_clip(
        args.model_preset, args.clip_weights, seed=args.seed,
        compute_dtype=compute_dtype, device=args.device,
    )
    if args.student_checkpoint:
        model.load_state_dict(restore_student_params(args.student_checkpoint,
                                                     model.state_dict()))
    return cfg, model


def build_service(args, mesh=None):
    """The service of the flags; with a `parallel.mesh.Mesh`, collective
    (every rank builds it; a preloaded `--index_path` is read on global
    rank 0 and broadcast)."""
    from dclip_tpu_torch.cli.common import load_tokenizer
    from dclip_tpu_torch.serve import ClipService

    cfg, model = load_model(args)
    tokenizer = load_tokenizer(args.tokenizer_dir, max_length=cfg.text.max_length)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    index = None
    if args.index_path:
        from dclip_tpu_torch.data.embedding_store import EmbeddingStore
        from dclip_tpu_torch.serve.fanout import share_index

        if mesh is None or mesh.is_primary:
            index = EmbeddingStore.load(args.index_path)
            print(f"loaded index: {len(index)} entries, dim {index.dim}", flush=True)
        if mesh is not None:
            index = share_index(index, mesh)
    return ClipService(
        model, cfg, tokenizer=tokenizer, buckets=buckets,
        index_dim=args.index_dim if args.index_dim > 0 else None,
        quantize=args.quantize or None, mesh=mesh,
        index=index, device=model.logit_scale.device,
    )


def export(args) -> int:
    """--export_dir: trace the encode functions for each bucket and platform
    and write the artifact (`serve.export`: manifest, one program per
    (modality, bucket, platform), params.npz). The model computes in f32:
    the bf16 serving route on the card is the hand-written kernels', which
    cannot be traced (`--quantize int8` traces the int8 forward instead)."""
    from dclip_tpu_torch.serve.export import check_platforms, export_encoders

    platforms = tuple(s for s in args.export_platforms.split(",") if s)
    platforms = check_platforms(platforms) if platforms else None
    cfg, model = load_model(args, compute_dtype="float32")
    written = export_encoders(
        model, cfg, args.export_dir,
        batch_sizes=tuple(int(b) for b in args.buckets.split(",")),
        platforms=platforms, quantize=args.quantize or None,
    )
    print(json.dumps({"export_dir": args.export_dir, "written": written}), flush=True)
    return 0


def _decode_images(payload):
    from PIL import Image

    images = []
    if "images_b64" in payload:
        for s in payload["images_b64"]:
            im = Image.open(io.BytesIO(base64.b64decode(s))).convert("RGB")
            images.append(np.asarray(im, np.uint8))
    elif "paths" in payload:
        for p in payload["paths"]:
            with Image.open(p) as im:
                images.append(np.asarray(im.convert("RGB"), np.uint8))
    else:
        raise ValueError("expected 'images_b64' or 'paths'")
    return images


def make_handler(service, text_batcher, image_batcher):
    """HTTP handler class closed over the service + request batchers."""
    from http.server import BaseHTTPRequestHandler

    from dclip_tpu_torch.serve.fanout import GroupFailed

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet by default
            pass

        def _send(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/v1/stats":
                self._send(200, {
                    "service": service.stats(),
                    "text_batcher": text_batcher.stats(),
                    "image_batcher": image_batcher.stats(),
                })
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/v1/embeddings/text":
                    embs = text_batcher.submit_many(payload["texts"])
                    self._send(200, {"embeddings": [e.tolist() for e in embs]})
                elif self.path == "/v1/embeddings/image":
                    embs = image_batcher.submit_many(_decode_images(payload))
                    self._send(200, {"embeddings": [e.tolist() for e in embs]})
                elif self.path == "/v1/index/add":
                    ids = payload["ids"]
                    if "embeddings" in payload:
                        service.add_to_index(
                            ids, np.asarray(payload["embeddings"], np.float32)
                        )
                    else:
                        service.index_images(ids, _decode_images(payload))
                    self._send(200, {"ok": True, "index_size": service.index_size})
                elif self.path == "/v1/search":
                    hits = service.search_texts(
                        payload["texts"], k=int(payload.get("k", 5))
                    )
                    self._send(200, {
                        "results": [
                            [{"id": i, "score": s} for i, s in row]
                            for row in hits
                        ]
                    })
                else:
                    self._send(404, {"error": f"no route {self.path}"})
            except GroupFailed as e:  # the ranks are gone: the server stops
                self._send(503, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # noqa: BLE001 — HTTP boundary
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def _batchers(service, args):
    from dclip_tpu_torch.serve import DynamicBatcher

    wait = args.max_wait_ms / 1e3
    return (
        DynamicBatcher(service.encode_texts, max_batch=args.max_batch,
                       max_wait_s=wait, name="text"),
        DynamicBatcher(service.encode_images, max_batch=args.max_batch,
                       max_wait_s=wait, name="image"),
    )


def _embeddings_ok(embs, dim: int) -> bool:
    a = np.asarray(embs, np.float32)
    return (a.ndim == 2 and a.shape[1] == dim and bool(np.isfinite(a).all())
            and bool(np.allclose(np.linalg.norm(a, axis=-1), 1.0, atol=1e-3)))


def selftest(service, args) -> int:
    """One request per route against a live ephemeral-port server. Checks
    that embeddings have the projection width, are finite and unit-norm,
    and that a search finds the probe it just indexed."""
    import urllib.request
    from http.server import ThreadingHTTPServer

    text_batcher, image_batcher = _batchers(service, args)
    srv = ThreadingHTTPServer(
        (args.host, 0), make_handler(service, text_batcher, image_batcher))
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def get(route):
        with urllib.request.urlopen(f"http://{args.host}:{port}{route}", timeout=300) as r:
            return r.read().decode()

    def post(route, payload):
        req = urllib.request.Request(
            f"http://{args.host}:{port}{route}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    dim = service.cfg.projection_dim
    ok = True
    try:
        print("healthz:", get("/healthz"))
        out = post("/v1/embeddings/text", {"texts": ["a dog", "a red car"]})
        print(f"text embeddings: {len(out['embeddings'])} x {len(out['embeddings'][0])}")
        ok &= _embeddings_ok(out["embeddings"], dim)
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(np.zeros((48, 64, 3), np.uint8)).save(buf, format="PNG")
        out = post("/v1/embeddings/image",
                   {"images_b64": [base64.b64encode(buf.getvalue()).decode()]})
        print(f"image embeddings: 1 x {len(out['embeddings'][0])}")
        ok &= _embeddings_ok(out["embeddings"], dim)
        if service.index_size == 0 and args.index_dim > 0:
            post("/v1/index/add", {"ids": ["probe"], "embeddings": out["embeddings"]})
            hits = post("/v1/search", {"texts": ["anything"], "k": 1})
            print("search:", json.dumps(hits))
            ok &= hits["results"][0][0]["id"] == "probe"
        print("stats:", get("/v1/stats"))
    except Exception as e:  # noqa: BLE001 — smoke-check boundary
        print(f"SELFTEST FAILED: {type(e).__name__}: {e}")
        ok = False
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        text_batcher.close()
        image_batcher.close()
    print("SELFTEST", "OK" if ok else "FAILED")
    return 0 if ok else 1


def bench(service, args, concurrencies: Sequence[int] = (1, 8, 32)) -> list:
    """Concurrent-load measurement of the serving path.

    K client threads each fire single-item requests back-to-back through
    the DynamicBatcher (the HTTP layer is excluded). One JSON line per
    (modality, concurrency): requests/s, p50/p99 latency, mean batch size
    the batcher achieved, the quantization and the device the service runs
    on. Returns the lines' dicts."""
    import torch

    from dclip_tpu_torch.serve import DynamicBatcher

    print("warming up:", json.dumps(service.warmup()), flush=True)
    device = (torch.cuda.get_device_name(service.device)
              if service.device.type == "cuda" else "cpu")
    size = service.cfg.vision.image_size
    rng = np.random.RandomState(0)
    image = rng.randint(0, 255, (size, size, 3), np.uint8)
    text = "a photo of a dog catching a red frisbee in the park"
    rows = []
    workloads = {
        "text": (text, service.encode_texts),
        "image": (image, service.encode_images),
    }
    for modality, (item, encode) in workloads.items():
        for conc in concurrencies:
            per_thread = max(4, 64 // conc)
            with DynamicBatcher(encode, max_batch=args.max_batch,
                                max_wait_s=args.max_wait_ms / 1e3, name=modality) as b:
                b.submit(item)  # one warm pass through this batcher
                lat: list = []
                lock = threading.Lock()

                def client():
                    mine = []
                    for _ in range(per_thread):
                        t0 = time.perf_counter()
                        b.submit(item)
                        mine.append(time.perf_counter() - t0)
                    with lock:
                        lat.extend(mine)

                threads = [threading.Thread(target=client) for _ in range(conc)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                wall = time.perf_counter() - t0
                s = b.stats()
            lat_ms = sorted(x * 1e3 for x in lat)
            n = len(lat_ms)
            rows.append({
                "modality": modality,
                "concurrency": conc,
                "requests": n,
                "requests_per_sec": n / wall,
                "p50_ms": lat_ms[n // 2],
                "p99_ms": lat_ms[min(n - 1, int(n * 0.99))],
                "mean_batch": s["mean_batch_size"],
                "quantize": service.quantize,
                "device": device,
            })
            print(json.dumps(rows[-1]), flush=True)
    return rows


def parse_args(argv=None):
    from dclip_tpu_torch.cli.common import add_device_arg, add_model_args

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_model_args(p)
    add_device_arg(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8900)
    p.add_argument("--buckets", default="1,4,16,64",
                   help="comma-separated serving batch buckets")
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="linger for batching once a request is queued")
    p.add_argument("--index_dim", type=int, default=0,
                   help=">0 enables the retrieval index endpoints")
    p.add_argument("--index_path", default="",
                   help="preload a saved EmbeddingStore (.npz or .dcs)")
    p.add_argument("--student_checkpoint", default="",
                   help="optional distilled-student checkpoint (the port's "
                        "CheckpointManager file or directory)")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="serve over a data-parallel mesh of this size (-1: every rank); "
                        "encode batches shard over it, index search runs the sharded "
                        "top-k; one process per card, started by torchrun or the DCLIP env "
                        "triple")
    p.add_argument("--quantize", default="", choices=["", "int8"],
                   help="int8: weight-only quantized serving (serve.quant)")
    p.add_argument("--export_dir", default="",
                   help="write a serving artifact (torch.export programs per bucket + "
                        "params.npz, serve.export) to this directory and exit; honors "
                        "--buckets, --student_checkpoint and --quantize")
    p.add_argument("--export_platforms", default="",
                   help="comma-separated export targets, cpu and / or cuda (default: "
                        "--device)")
    p.add_argument("--no_warmup", action="store_true")
    p.add_argument("--selftest", action="store_true",
                   help="start on an ephemeral port, run one request per "
                        "endpoint in-process, print the results, and exit 0/1")
    p.add_argument("--bench", action="store_true",
                   help="measure the serving path (batcher -> bucketed "
                        "encoder) under concurrent load and exit")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    mesh, made = None, False
    if args.mesh_data != 1:
        from dclip_tpu_torch.cli.common import serve_mesh

        mesh, made = serve_mesh(args)
    try:
        return _serve(args, mesh)
    finally:
        if made:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serve(args, mesh) -> int:
    from dclip_tpu_torch.serve.fanout import follow, lead

    follower = mesh is not None and not mesh.is_primary
    if args.export_dir:
        if follower:
            print(f"rank {mesh.global_rank}: global rank 0 writes {args.export_dir}", flush=True)
            return 0
        return export(args)
    service = build_service(args, mesh)
    if follower:
        print(f"rank {mesh.global_rank}: following rank 0 on {service.device}", flush=True)
        follow(service)
        return 0
    servers = []

    def stop_serving(error):
        print(f"serve: the group of ranks failed ({error!r}); stopping", file=sys.stderr,
              flush=True)
        for srv in servers:
            threading.Thread(target=srv.shutdown, daemon=True).start()

    front = service
    if mesh is not None and mesh.distributed:
        front = lead(service, on_failure=stop_serving)
    try:
        if args.selftest:
            return selftest(front, args)
        if args.bench:
            bench(front, args)
            return 0
        if not args.no_warmup:
            print("warming up:", json.dumps(front.warmup()), flush=True)
        from http.server import ThreadingHTTPServer

        text_batcher, image_batcher = _batchers(front, args)
        srv = ThreadingHTTPServer(
            (args.host, args.port), make_handler(front, text_batcher, image_batcher))
        servers.append(srv)  # from here a failure of the group shuts it down
        print(f"serving on http://{args.host}:{srv.server_address[1]}", flush=True)
        try:
            if getattr(front, "failed", None) is None:
                srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
            text_batcher.close()
            image_batcher.close()
        return 1 if getattr(front, "failed", None) is not None else 0
    finally:
        if front is not service:
            front.close()


if __name__ == "__main__":
    sys.exit(main())
