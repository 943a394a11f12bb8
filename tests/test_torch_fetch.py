"""The port's gated fetchers (`data.fetch`) beside the JAX package's, offline:
every request goes to a fake transport, and the same fake bodies go to
both packages, which must write the same files and return the same
records (paths compared relative to each package's own directory).

Covered, as `tests/test_fetch.py` covers JAX's: the gate's
`NetworkDisabled` messages; the Karpathy zip's download, cache and
extraction; the Conceptual Captions fetch's header skip, URL-derived
names, PIL validation, failure skips, on-disk reuse, re-download of a
corrupt file and the 5x row-oversampling cap; `karpathy --download
--allow_network` end to end through the module-level `default_transport`
override; `combine_datasets` with `allow_network`, then offline.
"""
import io
import json
import os
import zipfile

import pytest

from dclip_tpu.cli import karpathy as jax_karpathy_cli
from dclip_tpu.data import corpus as jax_corpus
from dclip_tpu.data import fetch as jax_fetch
from dclip_tpu_torch.cli import karpathy as karpathy_cli
from dclip_tpu_torch.data import corpus, fetch

KARPATHY_URL = "https://cs.stanford.edu/people/karpathy/deepimagesent/flickr30k.zip"
PACKAGES = {"port": (fetch, corpus, karpathy_cli), "jax": (jax_fetch, jax_corpus,
                                                           jax_karpathy_cli)}


def _png_bytes(color=(10, 200, 30)):
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (4, 4), color).save(buf, "PNG")
    return buf.getvalue()


class FakeTransport:
    """url -> bytes | Exception; records every request."""

    def __init__(self, responses):
        self.responses = responses
        self.calls = []

    def __call__(self, url, timeout):
        self.calls.append((url, timeout))
        r = self.responses[url]
        if isinstance(r, Exception):
            raise r
        return r


def _karpathy_zip_bytes(dataset="flickr30k", n=3, split="test"):
    images = [{"filename": f"img_{i}.jpg", "imgid": i, "split": split,
               "sentences": [{"raw": f"caption {i}a"}, {"raw": f"caption {i}b"}]}
              for i in range(n)]
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr(f"{dataset}/dataset_{dataset}.json", json.dumps({"images": images}))
    return buf.getvalue()


def _tree(root):
    """{relative path: bytes} of every file under root, the root's own path
    inside a file written as DIR."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read().replace(str(root).encode(), b"DIR")
    return out


def _relative(records, root):
    return [dict(r, image_path=os.path.relpath(r["image_path"], root)) for r in records]


def test_constants_and_names_equal_jax():
    assert fetch.KARPATHY_URLS == jax_fetch.KARPATHY_URLS
    assert fetch.BROWSER_USER_AGENT == jax_fetch.BROWSER_USER_AGENT
    for i, url in enumerate(["http://x.example/", "http://x.example/a b#.png",
                             "http://a.example/photo.jpg?sz=big", "http://d/second one!.png",
                             "no-slash", "http://e/ü.jpg"]):
        assert fetch.cc_image_filename(i, url) == jax_fetch.cc_image_filename(i, url)
    assert fetch.cc_image_filename(3, "http://x.example/") == "cc_0000003.jpg"
    assert corpus.cc_image_filename is fetch.cc_image_filename


def test_karpathy_download_gated_cached_and_extracted(tmp_path, capsys):
    results = {}
    for tag, (mod, _, _) in PACKAGES.items():
        data_dir = str(tmp_path / tag)
        t = FakeTransport({KARPATHY_URL: _karpathy_zip_bytes()})
        with pytest.raises(mod.NetworkDisabled) as e:
            mod.download_karpathy_split("flickr30k", data_dir, allow_network=False)
        gate = str(e.value).replace(data_dir, "DIR")
        assert KARPATHY_URL in gate and "--allow_network" in gate
        jp = mod.download_karpathy_split("flickr30k", data_dir, allow_network=True, transport=t)
        assert t.calls == [(KARPATHY_URL, 600.0)]
        # The extracted JSON is reused: no request, no extraction.
        assert mod.download_karpathy_split("flickr30k", data_dir, allow_network=True,
                                           transport=t) == jp
        # The zip is cached: with the JSON gone it re-extracts offline.
        os.remove(jp)
        assert mod.download_karpathy_split("flickr30k", data_dir) == jp
        assert len(t.calls) == 1
        with pytest.raises(ValueError):
            mod.download_karpathy_split("imagenet", data_dir)
        printed = capsys.readouterr().out.replace(data_dir, "DIR")
        results[tag] = (gate, os.path.relpath(jp, data_dir), _tree(data_dir), printed)
    assert results["port"] == results["jax"]
    assert "already extracted" in results["port"][3]


def test_a_failed_transfer_leaves_no_zip(tmp_path):
    """The zip is written under a temporary name and renamed when whole: a
    transport that fails leaves no `<dataset>.zip`, so a rerun downloads
    again."""
    for tag, (mod, _, _) in PACKAGES.items():
        data_dir = str(tmp_path / tag)
        with pytest.raises(OSError):
            mod.download_karpathy_split("flickr30k", data_dir, allow_network=True,
                                        transport=FakeTransport({KARPATHY_URL: OSError("reset")}))
        assert not os.path.exists(os.path.join(data_dir, "flickr30k.zip"))
        t = FakeTransport({KARPATHY_URL: _karpathy_zip_bytes()})
        assert os.path.exists(mod.download_karpathy_split("flickr30k", data_dir,
                                                          allow_network=True, transport=t))
        assert len(t.calls) == 1


def test_karpathy_cli_download_end_to_end(tmp_path, monkeypatch):
    """`karpathy --download --allow_network` through the module-level
    `default_transport` override: fetch, extract, split JSON; the same
    command without `--allow_network` fails with NetworkDisabled."""
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(2):
        (img_dir / f"img_{i}.jpg").write_bytes(_png_bytes())
    outs = {}
    for tag, (mod, _, cli) in PACKAGES.items():
        t = FakeTransport({KARPATHY_URL: _karpathy_zip_bytes(n=2)})
        monkeypatch.setattr(mod, "default_transport", t)
        out_dir = tmp_path / tag / "out"
        assert cli.main(["--datasets", "flickr30k", "--download", "--allow_network",
                         "--data_dir", str(tmp_path / tag / "kcache"), "--flickr_dir",
                         str(img_dir), "--output_dir", str(out_dir), "--split", "test"]) == 0
        assert [u for u, _ in t.calls] == [KARPATHY_URL]
        items = json.loads((out_dir / "flickr30k_test.json").read_text())
        assert len(items) == 2 and set(items[0]) == {"image_path", "image_id", "captions"}
        outs[tag] = _tree(str(out_dir))
        with pytest.raises(mod.NetworkDisabled):
            cli.main(["--datasets", "flickr30k", "--download", "--data_dir",
                      str(tmp_path / tag / "kcache2"), "--flickr_dir", str(img_dir),
                      "--output_dir", str(out_dir)])
    assert outs["port"] == outs["jax"]
    port_flags = {a.dest: (a.default, a.help) for a in karpathy_cli.build_parser()._actions}
    assert port_flags == {a.dest: (a.default, a.help)
                          for a in jax_karpathy_cli.build_parser()._actions}


def _cc_tsv(tmp_path, rows):
    p = tmp_path / "cc.tsv"
    p.write_text("\n".join(rows) + "\n", encoding="utf-8")
    return str(p)


GOOD = "http://a.example/photo.jpg?sz=big"
BAD_BODY = "http://b.example/not_an_image.jpg"
UNREACHABLE = "http://c.example/timeout.jpg"
GOOD2 = "http://d.example/second one!.png"  # characters the name drops


def _cc_responses():
    return {GOOD: _png_bytes(), BAD_BODY: b"<html>404</html>", UNREACHABLE: OSError("timeout"),
            GOOD2: _png_bytes((200, 10, 10))}


def test_cc_fetch_matches_jax(tmp_path, capsys):
    tsv = _cc_tsv(tmp_path, ["caption\turl", f"a dog\t{GOOD}", f"a cat\t{BAD_BODY}",
                             f"a bird\t{UNREACHABLE}", "short-row-no-tab", f"\t{GOOD}",
                             f"a fish\t{GOOD2}"])
    runs = {}
    for tag, (mod, _, _) in PACKAGES.items():
        img_dir = str(tmp_path / tag)
        t = FakeTransport(_cc_responses())
        with pytest.raises(mod.NetworkDisabled) as e:
            mod.fetch_conceptual_captions(img_dir, tsv, 5, allow_network=False)
        gate = str(e.value)
        recs = mod.fetch_conceptual_captions(img_dir, tsv, target_count=5, allow_network=True,
                                             transport=t)
        assert [r["captions"] for r in recs] == [["a dog"], ["a fish"]]
        assert [os.path.basename(r["image_path"]) for r in recs] == [
            "cc_0000001_photo.jpg", "cc_0000006_secondone.png"]
        first_calls = list(t.calls)
        # Valid files on disk are reused without a request; failed rows retry.
        recs2 = mod.fetch_conceptual_captions(img_dir, tsv, target_count=2, allow_network=True,
                                              transport=t)
        assert [r["image_path"] for r in recs2] == [r["image_path"] for r in recs]
        assert [u for u, _ in t.calls].count(GOOD) == 1
        # A corrupt file on disk is fetched again.
        with open(recs[0]["image_path"], "wb") as f:
            f.write(b"corrupt")
        mod.fetch_conceptual_captions(img_dir, tsv, target_count=1, allow_network=True,
                                      transport=t)
        assert t.calls[-1] == (GOOD, 5.0) and mod._valid_image(recs[0]["image_path"])
        runs[tag] = (gate, _relative(recs, img_dir), _relative(recs2, img_dir), first_calls,
                     t.calls, _tree(img_dir), capsys.readouterr().out.replace(img_dir, "DIR"))
    assert runs["port"] == runs["jax"]


def test_cc_fetch_oversampling_cap_matches_jax(tmp_path):
    """At most target * 5 rows are scanned (here 10 of 30, every one failing
    but the last): the fetch undershoots, as the reference does;
    `max_scan_rows` reaches the good row."""
    n = 30
    urls = [f"http://x.example/{i}.jpg" for i in range(n)]
    tsv = _cc_tsv(tmp_path, [f"cap {i}\t{urls[i]}" for i in range(n)])
    runs = {}
    for tag, (mod, _, _) in PACKAGES.items():
        t = FakeTransport({u: OSError("down") for u in urls[:-1]} | {urls[-1]: _png_bytes()})
        capped = mod.fetch_conceptual_captions(str(tmp_path / tag / "a"), tsv, target_count=2,
                                               allow_network=True, transport=t)
        assert capped == [] and len(t.calls) == 10
        full = mod.fetch_conceptual_captions(str(tmp_path / tag / "b"), tsv, target_count=2,
                                             allow_network=True, transport=t, max_scan_rows=n)
        assert len(full) == 1
        runs[tag] = (_relative(full, str(tmp_path / tag)), t.calls)
    assert runs["port"] == runs["jax"]


def test_combine_datasets_allow_network_then_offline(tmp_path, capsys):
    """`combine_datasets` with `allow_network` fetches the CC images through
    `cc_transport`; an offline rebuild then finds them under the
    URL-derived names."""
    good = ["http://h.example/a.jpg", "http://h.example/b.jpg"]
    tsv = _cc_tsv(tmp_path, [f"cap {i}\t{u}" for i, u in enumerate(good)])
    runs = {}
    for tag, (_, mod, _) in PACKAGES.items():
        root = tmp_path / tag
        t = FakeTransport({u: _png_bytes() for u in good})
        paths = mod.CorpusPaths(cc_images_dir=str(root / "cc"), cc_annotations_file=tsv,
                                allow_network=True, cc_transport=t,
                                targets={"conceptual_captions": 2})
        train, val = mod.combine_datasets(paths, str(root / "train.json"),
                                          str(root / "val.json"), val_fraction=0.5)
        items = json.loads(open(train).read()) + json.loads(open(val).read())
        assert len(items) == 2 and len(t.calls) == 2
        offline = mod.process_conceptual_captions(str(root / "cc"), tsv, 2)
        assert sorted(r["image_path"] for r in offline) == sorted(i["image_path"] for i in items)
        runs[tag] = (_relative(items, str(root)), _relative(offline, str(root)), _tree(str(root)),
                     capsys.readouterr().out.replace(str(root), "DIR"))
    assert runs["port"] == runs["jax"]


def test_default_transport_sends_the_browser_user_agent(monkeypatch):
    """The urllib transport's request, seen by a stand-in `urlopen`: the
    browser User-Agent and the timeout; no socket is opened."""
    import urllib.request

    seen = {}

    class Response(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def urlopen(req, timeout):
        seen.update(url=req.full_url, agent=req.get_header("User-agent"), timeout=timeout)
        return Response(b"body")

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    assert fetch.default_transport("http://h.example/x.jpg", 7.0) == b"body"
    assert seen == {"url": "http://h.example/x.jpg", "agent": fetch.BROWSER_USER_AGENT,
                    "timeout": 7.0}
