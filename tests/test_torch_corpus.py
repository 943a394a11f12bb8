"""The port's corpus builders (`data/corpus.py`), `cli/build_corpus.py` and
`cli/doctor.py` against the JAX package's, on synthetic COCO / Visual
Genome / Flickr30k / Conceptual Captions annotation files and empty image
files written to tmp_path (the builders only check that an image exists).
Equal JSON files and equal printed lines, byte for byte."""
import json
import os

import pytest

from dclip_tpu.cli import build_corpus as jax_cli
from dclip_tpu.data import corpus as jcorpus
from dclip_tpu.data.fetch import cc_image_filename as jax_cc_image_filename
from dclip_tpu_torch.cli import build_corpus as cli
from dclip_tpu_torch.data import corpus


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Annotation files of the four sources; some records name images that
    are missing, some have no caption, VG regions with and without boxes,
    CC rows under each of the three on-disk names and a short row."""
    root = tmp_path_factory.mktemp("sources")

    def touch(d, names):
        d.mkdir(exist_ok=True)
        for n in names:
            (d / n).write_bytes(b"")

    coco = root / "coco"
    touch(coco, [f"c{i}.jpg" for i in range(14)])
    (root / "coco.json").write_text(json.dumps({
        "images": [{"id": i, "file_name": f"c{i}.jpg"} for i in range(16)],
        "annotations": [{"image_id": i % 15, "caption": f"a caption number {i} of coco"}
                        for i in range(40)]}))
    vg = root / "vg"
    touch(vg, ["1.jpg", "2.png", "3.jpeg", "5.jpg"])
    (root / "vg.json").write_text(json.dumps([
        {"id": 1, "regions": [{"phrase": "a red ball", "x": 1, "y": 2, "width": 10,
                               "height": 20}, {"phrase": "a tree"}]},
        {"id": 2, "regions": [{"phrase": "sky", "x": 0, "y": 0, "width": 5, "height": 5}]},
        {"id": 3, "regions": [{"phrase": "grass and sun"}]},
        {"id": 4, "regions": [{"phrase": "missing image"}]},
        {"id": 5, "regions": [{"x": 1, "y": 1, "width": 2, "height": 2}]}]))
    fl = root / "flickr"
    touch(fl, ["a.jpg", "b.jpg", "d.jpg"])
    (root / "results.csv").write_text(
        "image_name| comment_number| comment\n"
        "a.jpg| 0| A man walks.\n" "a.jpg| 1| Someone strolling.\n"
        "b.jpg| 0| Two dogs play in the park .\n" "gone.jpg| 0| Not on disk.\n"
        "d.jpg| 0| A child.\n" "malformed line\n")
    cc = root / "cc"
    urls = ["http://x.org/img/one.jpg?size=3", "http://x.org/two.jpg", "http://x.org/",
            "http://x.org/four.png", "http://x.org/gone.jpg"]
    touch(cc, ["cc_0.jpg", "two.jpg", jax_cc_image_filename(2, urls[2]),
               jax_cc_image_filename(3, urls[3])])
    (root / "cc.tsv").write_text("".join(f"caption {i} of cc\t{u}\n" for i, u in enumerate(urls))
                                 + "a row without url\n")
    return root


def _paths(module, root, **changes):
    kw = dict(coco_images_dir=str(root / "coco"), coco_annotations_file=str(root / "coco.json"),
              vg_images_dir=str(root / "vg"), vg_annotations_file=str(root / "vg.json"),
              flickr_images_dir=str(root / "flickr"),
              flickr_annotations_file=str(root / "results.csv"),
              cc_images_dir=str(root / "cc"), cc_annotations_file=str(root / "cc.tsv"),
              targets={"coco": 9, "visual_genome": 25, "flickr30k": 15,
                       "conceptual_captions": 3})
    kw.update(changes)
    return module.CorpusPaths(**kw)


def test_builders_equal_the_jax_ones(sources):
    root = sources
    cases = [
        ("process_coco", (str(root / "coco"), str(root / "coco.json"), 9)),
        ("process_visual_genome", (str(root / "vg"), str(root / "vg.json"), 25)),
        ("process_flickr30k", (str(root / "flickr"), str(root / "results.csv"), 2)),
        ("process_conceptual_captions", (str(root / "cc"), str(root / "cc.tsv"), 10)),
        ("process_coco", (str(root / "nowhere"), str(root / "coco.json"), 9)),
        ("process_coco", (None, None, 9)),
    ]
    for name, args in cases:
        got, want = getattr(corpus, name)(*args), getattr(jcorpus, name)(*args)
        assert got == want, name
    for rows in (None, 2):
        assert corpus.process_conceptual_captions(str(root / "cc"), str(root / "cc.tsv"), 10,
                                                  max_scan_rows=rows) == \
            jcorpus.process_conceptual_captions(str(root / "cc"), str(root / "cc.tsv"), 10,
                                                max_scan_rows=rows)
    assert len(corpus.process_conceptual_captions(str(root / "cc"), str(root / "cc.tsv"),
                                                  10)) == 4
    for i, url in enumerate(["http://x.org/a b?.jpg", "", "http://x/é.png?q=1"]):
        assert corpus.cc_image_filename(i, url) == jax_cc_image_filename(i, url)
    assert corpus.DEFAULT_TARGETS == jcorpus.DEFAULT_TARGETS


@pytest.mark.parametrize("seed,val_fraction", [(42, 0.1), (0, 0.25)])
def test_combine_datasets_writes_the_jax_files(sources, tmp_path, capsys, seed, val_fraction):
    outs = []
    for module, tag in ((corpus, "port"), (jcorpus, "jax")):
        train, val = str(tmp_path / f"{tag}_train.json"), str(tmp_path / f"{tag}_val.json")
        t, v = module.combine_datasets(_paths(module, sources), train, val, seed=seed,
                                       val_fraction=val_fraction)
        assert (t, v) == (train, val)
        printed = capsys.readouterr().out.replace(f"{tag}_", "X_")
        outs.append((open(train, "rb").read(), open(val, "rb").read(), printed))
    assert outs[0] == outs[1]
    train = json.loads(outs[0][0])
    assert {d["dataset"] for d in train} >= {"coco", "visual_genome", "flickr30k"}
    assert "=== Dataset Statistics ===" in outs[0][2]


def test_print_dataset_stats_and_empty_corpus_match_jax(sources, tmp_path, capsys):
    data = corpus.process_visual_genome(str(sources / "vg"), str(sources / "vg.json"), 25)
    printed = []
    for module in (corpus, jcorpus):
        module.print_dataset_stats(data)
        module.print_dataset_stats([])
        assert module.combine_datasets(module.CorpusPaths(), str(tmp_path / "t.json"),
                                       str(tmp_path / "v.json")) == (None, None)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert not os.path.exists(tmp_path / "t.json")


def test_build_corpus_cli_equals_the_jax_cli(sources, tmp_path, capsys):
    root = sources
    argv = ["--coco_images", str(root / "coco"), "--coco_annotations", str(root / "coco.json"),
            "--vg_images", str(root / "vg"), "--vg_annotations", str(root / "vg.json"),
            "--flickr_images", str(root / "flickr"), "--flickr_annotations",
            str(root / "results.csv"), "--cc_images", str(root / "cc"), "--cc_annotations",
            str(root / "cc.tsv"), "--coco_target", "7", "--cc_target", "2",
            "--cc_max_scan_rows", "4", "--seed", "3", "--val_fraction", "0.2"]
    outs = []
    for main, tag in ((cli.main, "port"), (jax_cli.main, "jax")):
        out_dir = tmp_path / tag
        assert main(argv + ["--output_dir", str(out_dir)]) == 0
        printed = capsys.readouterr().out.replace(str(out_dir), "OUT")
        outs.append(((out_dir / "teacher_train.json").read_bytes(),
                     (out_dir / "teacher_val.json").read_bytes(), printed))
    assert outs[0] == outs[1]
    port_flags = {a.dest for a in cli.build_parser()._actions}
    assert port_flags == {a.dest for a in jax_cli.build_parser()._actions}
    # Nothing found: exit 1, as the JAX CLI.
    empty = ["--output_dir", str(tmp_path / "none")]
    assert cli.main(empty) == jax_cli.main(empty) == 1


def test_the_cc_fetch_waits(sources, tmp_path, monkeypatch, capsys):
    """The Conceptual Captions fetch behind `allow_network`, the same two
    calls on both packages through a fake transport (no network): the
    corpus builder with `cc_transport`, and the CLI's `--allow_network`
    through the fetch module's `default_transport`. Each fetches into its
    own copy of the CC directory, whose empty files are no images, so
    every row with a URL is requested. The requests, every file written
    and the printed lines equal the JAX package's."""
    import io
    import shutil

    from PIL import Image

    from dclip_tpu.data import fetch as jfetch
    from dclip_tpu_torch.data import fetch

    buf = io.BytesIO()
    Image.new("RGB", (4, 4), (9, 99, 199)).save(buf, "PNG")
    urls = [line.split("\t")[1] for line in (sources / "cc.tsv").read_text().splitlines()
            if "\t" in line]
    bodies = dict.fromkeys(urls, buf.getvalue())
    bodies[urls[1]] = b"<html>not an image</html>"  # fails PIL's check: skipped
    outs = []
    for module, main, fetch_mod, tag in ((corpus, cli.main, fetch, "port"),
                                         (jcorpus, jax_cli.main, jfetch, "jax")):
        root, calls = tmp_path / tag, []

        def transport(url, timeout, calls=calls):
            calls.append((url, timeout))
            return bodies[url]

        shutil.copytree(sources / "cc", root / "cc")
        train, _ = module.combine_datasets(
            _paths(module, sources, allow_network=True, cc_images_dir=str(root / "cc"),
                   cc_transport=transport), str(root / "t.json"), str(root / "v.json"))
        assert train is not None
        monkeypatch.setattr(fetch_mod, "default_transport", transport)
        shutil.copytree(sources / "cc", root / "cli" / "cc")
        assert main(["--output_dir", str(root / "cli"), "--cc_images", str(root / "cli" / "cc"),
                     "--cc_annotations", str(sources / "cc.tsv"), "--allow_network"]) == 0
        files = {p.relative_to(root).as_posix(): p.read_bytes().replace(str(root).encode(), b"R")
                 for p in sorted(root.rglob("*")) if p.is_file()}
        outs.append((calls, files, capsys.readouterr().out.replace(str(root), "R")))
    assert outs[0] == outs[1]
    calls, files, _ = outs[0]
    # Row 0 is taken for the TSV's header (its caption starts with
    # "caption"), row 1's body is skipped: 3 images from rows 2-4, each call.
    assert [u for u, _ in calls] == urls[1:] + urls[1:]
    cc = [d for name in ("cli/teacher_train.json", "cli/teacher_val.json")
          for d in json.loads(files[name]) if d["dataset"] == "conceptual_captions"]
    assert len(cc) == 3


def test_doctor_collect_fast_keys(capsys):
    """The JAX doctor's keys where a counterpart exists (`versions`,
    `backend`, `devices`, `process`, `matmul_smoke`, `native_runtime`), and
    the port's own: the kernel library and the JPEG decoder's build."""
    from dclip_tpu_torch.cli import doctor

    info = doctor.collect(fast=True)
    assert info["ok"] is True
    for key in ("versions", "backend", "devices", "process", "matmul_smoke", "native_runtime",
                "kernels"):
        assert key in info, key
    assert "is_tpu" not in info and "compile_cache" not in info
    assert set(info["versions"]) >= {"python", "torch", "cuda", "nvcc"}
    assert info["devices"]["count"] >= 1 and info["matmul_smoke"] == 128.0 ** 3
    from dclip_tpu_torch import native

    jpeg = info["native_runtime"]["jpeg_decoder"]
    assert jpeg["available"] == native.jpeg_available() and (jpeg["error"] is None) == \
        jpeg["available"]
    assert doctor.main(["--fast"]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True
