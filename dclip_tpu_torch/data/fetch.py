"""Dataset fetchers behind a network gate (counterpart of
`dclip_tpu/data/fetch.py`), host code only.

- `download_karpathy_split`: the Karpathy split zip from cs.stanford.edu,
  downloaded once (atomically) into `data_dir` and extracted; a cached
  zip or an extracted JSON is reused without touching the network.
- `fetch_conceptual_captions`: Conceptual Captions images fetched row by
  row from the TSV with a browser User-Agent and a 5 s timeout, each body
  checked with PIL before it is saved under `cc_image_filename`, images
  already valid on disk reused, at most target_count * 5 rows scanned.

Two gates: nothing touches the network without `allow_network=True` (the
CLIs' `--allow_network`; without it a missing file raises
`NetworkDisabled` naming what to fetch), and every request goes through a
`transport(url, timeout) -> bytes`: passed in, or this module's
`default_transport` (urllib), whose replacement at module level counts as
passed in. Tests run both fetchers offline through a fake transport.
"""
from __future__ import annotations

import os
import zipfile
from typing import Callable, List, Optional

KARPATHY_URLS = {
    "flickr30k": "https://cs.stanford.edu/people/karpathy/deepimagesent/flickr30k.zip",
    "coco": "https://cs.stanford.edu/people/karpathy/deepimagesent/coco.zip",
}

# The reference's browser UA (big_teacher_data.py:255-257): several CC
# image hosts refuse the default python UA outright.
BROWSER_USER_AGENT = (
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64) AppleWebKit/537.36 "
    "(KHTML, like Gecko) Chrome/91.0.4472.124 Safari/537.36"
)

Transport = Callable[[str, float], bytes]


class NetworkDisabled(RuntimeError):
    """A fetcher needed the network but --allow_network was not given."""


def default_transport(url: str, timeout: float = 30.0) -> bytes:
    """urllib GET with the browser UA. Raises on any HTTP/socket error."""
    import urllib.request

    req = urllib.request.Request(
        url, headers={"User-Agent": BROWSER_USER_AGENT}
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


_PRISTINE_DEFAULT_TRANSPORT = default_transport


def _download_to_file(
    url: str, dest: str, timeout: float, transport: Optional[Transport]
) -> None:
    """Atomic download to `dest`. With the default transport the body
    streams straight to disk (the Karpathy coco zip is hundreds of MB —
    buffering it as one bytes object is an avoidable RAM spike); an
    injected transport still returns bytes, keeping tests offline. A
    module-level `default_transport` replacement counts as injected —
    it is the documented override point (module docstring)."""
    if transport is None and default_transport is not _PRISTINE_DEFAULT_TRANSPORT:
        transport = default_transport
    tmp = dest + f".tmp.{os.getpid()}"
    if transport is not None:
        with open(tmp, "wb") as f:
            f.write(transport(url, timeout))
    else:
        import shutil
        import urllib.request

        req = urllib.request.Request(
            url, headers={"User-Agent": BROWSER_USER_AGENT}
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            with open(tmp, "wb") as f:
                shutil.copyfileobj(resp, f)
    os.replace(tmp, dest)  # atomic: no half-written file survives


def download_karpathy_split(
    dataset: str,
    data_dir: str,
    allow_network: bool = False,
    transport: Optional[Transport] = None,
    timeout: float = 600.0,
) -> str:
    """Materialize `data_dir/<dataset>/dataset_<dataset>.json`, downloading
    and extracting the cs.stanford.edu zip when missing.

    Same skip logic as the reference: an existing zip is not re-downloaded
    (karpathy_download.py:30-46), an existing extracted json is not
    re-extracted (:49-55). Returns the json path.
    """
    if dataset not in KARPATHY_URLS:
        raise ValueError(
            f"Unsupported dataset: {dataset}. Must be 'flickr30k' or 'coco'"
        )
    os.makedirs(data_dir, exist_ok=True)
    zip_path = os.path.join(data_dir, f"{dataset}.zip")
    json_path = os.path.join(data_dir, dataset, f"dataset_{dataset}.json")
    if os.path.exists(json_path):
        print(f"Karpathy split already extracted at {json_path}")
        return json_path
    if not os.path.exists(zip_path):
        if not allow_network:
            raise NetworkDisabled(
                f"{json_path} is missing and network access is disabled. "
                f"Re-run with --allow_network, or fetch "
                f"{KARPATHY_URLS[dataset]} elsewhere and place it at "
                f"{zip_path}."
            )
        print(f"Downloading {dataset} Karpathy split...")
        _download_to_file(KARPATHY_URLS[dataset], zip_path, timeout, transport)
    else:
        print(f"{dataset} Karpathy split zip already exists at {zip_path}")
    print(f"Extracting {zip_path}...")
    with zipfile.ZipFile(zip_path) as zf:
        zf.extractall(data_dir)
    if not os.path.exists(json_path):
        raise FileNotFoundError(
            f"{zip_path} extracted but {json_path} is missing — "
            "unexpected archive layout"
        )
    return json_path


def cc_image_filename(row_idx: int, url: str) -> str:
    """The reference's URL-derived CC filename (big_teacher_data.py:280-289):
    `cc_<row:07d>_<url basename sans query>`, cleaned to [alnum._-], with a
    `.jpg` fallback when the URL has no usable basename."""
    base = url.split("/")[-1].split("?")[0]
    name = f"cc_{row_idx:07d}_{base}"
    if not base:
        name = f"cc_{row_idx:07d}.jpg"
    return "".join(c for c in name if c.isalnum() or c in "._-")


def _valid_image(path_or_bytes) -> bool:
    from io import BytesIO

    from PIL import Image

    try:
        src = (
            BytesIO(path_or_bytes)
            if isinstance(path_or_bytes, (bytes, bytearray))
            else path_or_bytes
        )
        with Image.open(src) as img:
            img.load()
        return True
    except Exception:
        return False


def fetch_conceptual_captions(
    images_dir: str,
    annotations_file: str,
    target_count: int = 10_000,
    allow_network: bool = False,
    transport: Optional[Transport] = None,
    timeout: float = 5.0,
    max_scan_rows: Optional[int] = None,
) -> List[dict]:
    """Live CC fetch with the reference's semantics (big_teacher_data.py
    :228-350): scan at most `target_count * 5` TSV rows (override with
    `max_scan_rows`), skip a `caption...` header row, reuse already-valid
    on-disk images without touching the network, re-download invalid ones,
    validate every body with PIL before saving, stop at `target_count`.

    Returns corpus records (`{"image_path", "captions", "dataset",
    "boxes"}`) ready for `corpus.combine_datasets`.
    """
    if not allow_network:
        raise NetworkDisabled(
            "Conceptual Captions live fetch requires --allow_network "
            "(zero-egress default); use data.corpus."
            "process_conceptual_captions for images already on disk."
        )
    if not os.path.exists(annotations_file):
        print("Conceptual Captions annotations file not found. Skipping.")
        return []
    os.makedirs(images_dir, exist_ok=True)
    get = transport or default_transport
    # Reference row cap: 5x oversampling to absorb download failures
    # (:263) — it can undershoot the target on bad days, faithfully.
    cap = max_scan_rows if max_scan_rows is not None else target_count * 5
    results: List[dict] = []
    downloaded = skipped = 0
    with open(annotations_file, encoding="utf-8") as f:
        for row_idx, line in enumerate(f):
            if row_idx >= cap:
                break
            if row_idx == 0 and line.startswith("caption"):
                continue  # TSV header (reference :268-269)
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            caption, url = parts[0].strip(), parts[1].strip()
            if not caption or not url:
                skipped += 1
                continue
            path = os.path.join(images_dir, cc_image_filename(row_idx, url))
            if os.path.exists(path) and _valid_image(path):
                results.append(_cc_record(path, caption))
                if len(results) >= target_count:
                    break
                continue
            try:
                body = get(url, timeout)
            except Exception:
                skipped += 1  # unreachable host (reference :344-346)
                continue
            if not _valid_image(body):
                skipped += 1  # non-image body (reference :338-340)
                continue
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "wb") as fo:
                fo.write(body)
            os.replace(tmp, path)
            downloaded += 1
            results.append(_cc_record(path, caption))
            if len(results) >= target_count:
                break
    print(f"Processed {len(results)} Conceptual Captions images")
    print(f"Downloaded {downloaded} new images")
    print(f"Skipped {skipped} invalid or unreachable images")
    return results


def _cc_record(path: str, caption: str) -> dict:
    return {
        "image_path": path,
        "captions": [caption],
        "dataset": "conceptual_captions",
        "boxes": [],
    }
