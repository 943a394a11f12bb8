"""The port's host data path against the JAX package's, on a corpus of PNGs
written to tmp_path: `data.pipeline.MultiModalPipeline` (every field of
every batch over two epochs; thread and spawn-process decode; with and
without the tail batch; a two-way shard split; an unreadable image; the
native JPEG route on a mixed corpus of the committed fixtures, and without
PIL),
`data.detection_cache` (an npz written by the JAX `build_cache` with
`GridProposalDetector`, read by the port, and the other way round) and
`core.metrics.MetricsLogger` (its CSV and printed lines)."""
import json
import os

import numpy as np
import pytest

from dclip_tpu.data import detection_cache as jdc
from dclip_tpu.data import pipeline as jpl
from dclip_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from dclip_tpu_torch.data import detection_cache as dc
from dclip_tpu_torch.data import pipeline as pl
from dclip_tpu_torch.data.tokenizer import HashTokenizer

FIELDS = ("pixel_values", "input_ids", "attention_mask", "teacher_pixels", "boxes", "conf",
          "box_mask", "index", "content_key")
KW = dict(batch_size=4, max_patches=5, image_size=24, teacher_image_size=20,
          max_text_tokens=16, seed=3)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    items = []
    for i in range(10):
        p = str(root / f"img{i}.png")
        Image.fromarray((rng.rand(30 + 3 * i, 40 - 2 * i, 3) * 255).astype("uint8")).save(p)
        items.append({"image_path": p, "captions": [f"a photo of thing {i}", f"thing {i} here",
                                                    "a third caption"][:1 + i % 3]})
    broken = str(root / "broken.png")
    with open(broken, "wb") as f:
        f.write(b"not an image")
    items.append({"image_path": broken, "captions": ["an unreadable file"]})
    cache_path = str(root / "precache.npz")
    jdc.build_cache([it["image_path"] for it in items[:8]], jdc.GridProposalDetector(),
                    cache_path)
    return items, cache_path


def _pipes(corpus, **kw):
    items, cache_path = corpus
    args = dict(KW, **kw)
    mine = pl.MultiModalPipeline(items, HashTokenizer(1000, 16), dc.DetectionCache.load(cache_path),
                                 **args)
    args.pop("num_workers", None)
    theirs = jpl.MultiModalPipeline(items, JaxHashTokenizer(1000, 16),
                                    jdc.DetectionCache.load(cache_path), **args)
    return mine, theirs


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("drop_remainder", [True, False], ids=["drop_tail", "keep_tail"])
@pytest.mark.parametrize("num_workers", [0, 2], ids=["threads", "spawn_2"])
def test_batches_equal_the_jax_pipeline(corpus, num_workers, drop_remainder):
    """Two epochs, field for field. The JAX stream is its thread decode:
    the worker count never changes the stream, so the port's process pool
    is held against it too."""
    mine, theirs = _pipes(corpus, num_workers=num_workers, drop_remainder=drop_remainder)
    try:
        assert len(mine) == len(theirs) == (2 if drop_remainder else 3)
        for epoch in (0, 1):
            _assert_batches_equal(list(mine.epoch(epoch)), list(theirs.epoch(epoch)))
    finally:
        mine.close()
        theirs.close()


def test_shard_split_equals_the_halves(corpus):
    items, cache_path = corpus
    whole = list(_pipes(corpus)[0].epoch(1))
    for shard in (0, 1):
        part = pl.MultiModalPipeline(items, HashTokenizer(1000, 16),
                                     dc.DetectionCache.load(cache_path), shard_index=shard,
                                     shard_count=2, **KW)
        got = list(part.epoch(1))
        assert len(got) == len(whole)
        for g, w in zip(got, whole):
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f)[2 * shard:2 * shard + 2])
    with pytest.raises(ValueError, match="drop_remainder"):
        pl.MultiModalPipeline(items, HashTokenizer(1000, 16), shard_count=2, drop_remainder=False)


def test_unreadable_image_gives_zeros_and_native_waits(corpus):
    """An unreadable image gives zeros on both routes: the native one hands
    it to PIL, as the JAX pipeline does (its PNGs too)."""
    items, _ = corpus
    for backend in ("pil", "native"):
        mine, _ = _pipes(corpus, decode_backend=backend)
        item = mine._load_item(len(items) - 1, 0)
        assert not item["pixel_values"].any() and not item["teacher_pixels"].any()
        assert item["pixel_values"].shape == (24, 24, 3) and not item["box_mask"].any()
        readable = mine._load_item(0, 0)
        assert readable["teacher_pixels"].max() > 0 and readable["box_mask"].sum() == 5
    assert pl.content_key_for(items[0]["image_path"]) == jpl.content_key_for(
        items[0]["image_path"])


DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURE_JPEGS = ("rgb_640x480.jpg", "rgb_375x500.jpg", "rgb_53x37.jpg", "rgb_224x224.jpg",
                 "gray_121x90.jpg", "progressive_300x200.jpg")


@pytest.fixture(scope="module")
def mixed_corpus(corpus, tmp_path_factory):
    """The fixtures' JPEGs, their PNG and CMYK JPEG, a PNG of `corpus`, a
    JPEG cut inside its headers and the unreadable file, with a detection
    cache over those PIL can read (boxes in each image's own frame)."""
    items, _ = corpus
    root = tmp_path_factory.mktemp("mixed")
    cut = root / "cut.jpg"
    with open(os.path.join(DATA, "rgb_224x224.jpg"), "rb") as f:
        cut.write_bytes(f.read()[:300])
    paths = [os.path.join(DATA, n) for n in FIXTURE_JPEGS + ("rgb_40x30.png", "cmyk_50x40.jpg")]
    paths += [items[0]["image_path"], str(cut), items[-1]["image_path"]]
    mixed = [{"image_path": p, "captions": [f"caption {i}", f"other {i}"]}
             for i, p in enumerate(paths)]
    cache_path = str(root / "precache.npz")
    jdc.build_cache(paths[:-2], jdc.GridProposalDetector(), cache_path)  # PIL reads these
    return mixed, cache_path


@pytest.mark.parametrize("fast_decode", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("num_workers", [0, 2], ids=["threads", "spawn_2"])
def test_native_batches_equal_the_jax_pipeline(mixed_corpus, num_workers, fast_decode):
    """decode_backend="native" on both sides, two epochs field for field:
    the JPEGs through the two decoders, the PNGs, the CMYK JPEG, the cut
    JPEG and the unreadable file through PIL, per item."""
    kw = dict(KW, batch_size=3, image_size=32, teacher_image_size=28, decode_backend="native",
              fast_decode=fast_decode, num_workers=num_workers)
    mine, theirs = _pipes(mixed_corpus, **kw)
    try:
        assert len(mine) == len(theirs) == 3
        for epoch in (0, 1):
            got = list(mine.epoch(epoch))
            _assert_batches_equal(got, list(theirs.epoch(epoch)))
        assert all(b.pixel_values.shape == (3, 32, 32, 3) for b in got)
    finally:
        mine.close()
        theirs.close()


def _without_pil(monkeypatch):
    import builtins
    import sys

    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    monkeypatch.setitem(sys.modules, "PIL", None)


def test_a_jpeg_corpus_loads_without_pil(mixed_corpus, monkeypatch):
    """Only an item the native route did not serve reaches PIL: a corpus of
    JPEGs and a missing file loads with PIL's import failing, equal to the
    batches made with PIL present (and the missing file's item to the JAX
    pipeline's: zero tensors); a PNG, a CMYK JPEG or a cut JPEG then
    raises, naming its path."""
    mixed, cache_path = mixed_corpus
    missing = {"image_path": os.path.join(os.path.dirname(cache_path), "missing.jpg"),
               "captions": ["a file that is not there"]}
    jpegs = mixed[:len(FIXTURE_JPEGS)] + [missing]
    kw = dict(KW, batch_size=3, image_size=32, teacher_image_size=28, decode_backend="native")

    def pipe(cls=pl.MultiModalPipeline, tok=HashTokenizer, cache=dc.DetectionCache):
        return cls(jpegs, tok(1000, 16), cache.load(cache_path), **kw)

    want = list(pipe().epoch(0))
    theirs = pipe(jpl.MultiModalPipeline, JaxHashTokenizer, jdc.DetectionCache)._load_item(
        len(jpegs) - 1, 0)
    _without_pil(monkeypatch)
    _assert_batches_equal(list(pipe().epoch(0)), want)
    got = pipe()._load_item(len(jpegs) - 1, 0)
    assert not got["pixel_values"].any() and not got["teacher_pixels"].any()
    for key, value in theirs.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    items = {os.path.basename(it["image_path"]): it for it in mixed}
    for name in ("rgb_40x30.png", "cmyk_50x40.jpg", "cut.jpg"):
        pipe = pl.MultiModalPipeline([items[name]], HashTokenizer(1000, 16), **kw)
        with pytest.raises(ImportError, match=f"{name}.*needs PIL"):
            pipe._load_item(0, 0)
    with pytest.raises(ImportError, match="needs PIL"):
        pl.MultiModalPipeline(jpegs, HashTokenizer(1000, 16), **dict(kw, decode_backend="pil")
                              )._load_item(0, 0)


def test_starvation_warning_matches_jax():
    """The JAX line, the native backend's hint included; the port states no
    speed-up for --fast_decode (the JAX one's was measured on another host)."""
    for backend in ("pil", "native"):
        lines = []
        for cls in (pl.StarvationMonitor, jpl.StarvationMonitor):
            m = cls(num_workers=2, decode_backend=backend)
            for _ in range(20):
                m.record(0.5, 1.0, 8)
            lines.append(m.check(80, 4.0))
        assert lines[0] == lines[1].replace(", ~2-4x per core", "") and lines[0] is not None
        assert ("--decode_backend native" in lines[0]) == (backend == "pil")


def test_detection_cache_reads_the_jax_npz_and_back(corpus, tmp_path):
    items, cache_path = corpus
    paths = [it["image_path"] for it in items]
    mine, theirs = dc.DetectionCache.load(cache_path), jdc.DetectionCache.load(cache_path)
    assert len(mine) == len(theirs) == 8
    for max_patches in (3, 8):
        for a, b in zip(mine.get_fixed(paths, max_patches), theirs.get_fixed(paths, max_patches)):
            np.testing.assert_array_equal(a, b)
    img = np.zeros((30, 44, 3), np.uint8)
    for a, b in zip(dc.GridProposalDetector()(img), jdc.GridProposalDetector()(img)):
        np.testing.assert_array_equal(a, b)
    mine.put("extra.png", [[1, 2, 3, 4], [0, 0, 5, 5]], [0.2, 0.7])
    out = str(tmp_path / "back.npz")
    mine.save(out)
    back = jdc.DetectionCache.load(out)
    for a, b in zip(back.get_fixed(paths + ["extra.png"], 4),
                    mine.get_fixed(paths + ["extra.png"], 4)):
        np.testing.assert_array_equal(a, b)
    item = {"boxes": [{"x": 1, "y": 2, "width": 3, "height": 4}]}
    for a, b in zip(dc.boxes_from_corpus_item(item), jdc.boxes_from_corpus_item(item)):
        np.testing.assert_array_equal(a, b)
    assert dc.cache_path_for("d/x_train.json") == jdc.cache_path_for("d/x_train.json")


def test_build_cache_matches_jax(corpus, tmp_path):
    items, cache_path = corpus
    paths = [it["image_path"] for it in items[:8]]
    out = str(tmp_path / "port.npz")
    dc.build_cache(paths + ["missing.png"], dc.GridProposalDetector(), out)
    a, b = np.load(out), np.load(cache_path)
    assert json.loads(str(a["keys"])) == json.loads(str(b["keys"]))
    for k in ("counts", "boxes", "conf"):
        np.testing.assert_array_equal(a[k], b[k])


def test_metrics_logger_matches_jax(tmp_path, monkeypatch, capsys):
    from dclip_tpu.core.metrics import MetricsLogger as JaxMetricsLogger
    from dclip_tpu_torch.core import metrics

    clock = iter(np.arange(100.0, 200.0, 0.5))
    monkeypatch.setattr(metrics.time, "time", lambda: float(next(clock)))
    calls = [(2, {"contrastive_loss": 1.25, "train_loss": 1.25}),
             (4, {"contrastive_loss": 0.5, "train_loss": 0.5, "extra": 3.0}),
             (6, {"train_loss": 0.125})]
    outputs = []
    for cls, name in ((metrics.MetricsLogger, "port.csv"), (JaxMetricsLogger, "jax.csv")):
        clock = iter(np.arange(100.0, 200.0, 0.5))
        logger = cls(str(tmp_path / name), print_every=3)
        for step, m in calls:
            logger.log(step, m, prefix="train ")
        logger.close()
        outputs.append((open(tmp_path / name).read(), capsys.readouterr().out))
    assert outputs[0] == outputs[1]
    assert outputs[0][0].splitlines()[0] == "step,time,contrastive_loss,train_loss"
    with metrics.trace_span("dclip.test"):
        pass
    log_dir = str(tmp_path / "trace")
    metrics.start_trace(log_dir)
    metrics.stop_trace()
    assert any(f.endswith(".json") for f in os.listdir(log_dir))
