"""Environment diagnosis (counterpart of `dclip_tpu/cli/doctor.py`): one JSON
object about everything the port needs — versions (torch, CUDA, nvcc), the
device with its name and power limit, a matmul on it, the kernel
library's build and self-check (K13, in place of the JAX package's Pallas
probe), and the host libraries built with g++: the native KV store and
the JPEG decoder.

    python -m dclip_tpu_torch.cli.doctor            # full check (builds the kernels)
    python -m dclip_tpu_torch.cli.doctor --fast     # skip the kernel build

The keys are the JAX doctor's wherever a counterpart exists; its `is_tpu`
and `compile_cache` have none. `native_runtime.jpeg_decoder.error` carries
g++'s or the loader's message when the decoder cannot be had (a missing
`jpeglib.h` or `libjpeg`): the training CLIs' `--decode_backend native`
then raises.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys


def _nvcc_version():
    from dclip_tpu_torch.kernels import _build

    try:
        out = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                             timeout=60)
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        return f"unavailable: {e}"
    lines = [line for line in out.stdout.splitlines() if "release" in line]
    return lines[0].strip() if lines else out.stdout.strip()


def _card_line():
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def collect(fast: bool = False) -> dict:
    info: dict = {"ok": True}

    import torch

    import dclip_tpu_torch

    info["versions"] = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": _nvcc_version(),
        "dclip_tpu_torch": getattr(dclip_tpu_torch, "__version__", "dev"),
    }
    on_card = torch.cuda.is_available()
    device = torch.device("cuda", 0) if on_card else torch.device("cpu")
    info["backend"] = device.type
    info["devices"] = {
        "count": torch.cuda.device_count() if on_card else 1,
        "platform": "gpu" if on_card else "cpu",
        "kinds": sorted({torch.cuda.get_device_name(i)
                         for i in range(torch.cuda.device_count())}) if on_card else ["cpu"],
        "name_power_limit": _card_line() if on_card else None,
    }
    info["process"] = {"index": 0, "count": 1}

    # One small product on the device: a card that registers but fails on
    # first use shows here.
    try:
        x = torch.ones((128, 128), device=device)
        info["matmul_smoke"] = float((x @ x).sum())
    except RuntimeError as e:
        info["ok"] = False
        info["matmul_error"] = f"{type(e).__name__}: {e}"
        return info

    if not on_card:
        info["kernels"] = "plain twins only (no CUDA card)"
    elif not fast:
        from dclip_tpu_torch.kernels import _build

        try:
            seconds = _build.build()
            _build.load_library()
            info["kernels"] = {"build_s": seconds, "self_check": dict(_build.SELF_CHECK)}
        except RuntimeError as e:
            info["ok"] = False
            info["kernels"] = {"error": str(e)}

    from dclip_tpu_torch import native

    try:
        native.load_jpeg()
        jpeg = {"available": True, "error": None}
    except RuntimeError as e:
        jpeg = {"available": False, "error": str(e)}
    info["native_runtime"] = {"available": native.available(), "jpeg_decoder": jpeg}
    return info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fast", action="store_true",
                   help="skip the kernel library's build and self-check (nvcc over every "
                        "source takes minutes on a cold build directory)")
    args = p.parse_args(argv)
    info = collect(fast=args.fast)
    print(json.dumps(info, indent=2))
    return 0 if info.get("ok") else 1


if __name__ == "__main__":
    raise SystemExit(main())
