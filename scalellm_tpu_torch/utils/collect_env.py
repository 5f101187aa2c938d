"""Environment report for bug reports (counterpart of
scalellm_tpu/utils/collect_env.py): Python, the platform, torch and its
CUDA, the devices, nvcc and the versions of numpy and triton. It imports
no jax. Run: python -m scalellm_tpu_torch.utils.collect_env
"""

from __future__ import annotations

import platform
import shutil
import subprocess
import sys


def _nvcc_version() -> str:
    """The last line of `nvcc --version` (the build), or "not found"; nvcc
    is looked for where ops/_build.py looks."""
    nvcc = shutil.which("nvcc") or shutil.which("/usr/local/cuda/bin/nvcc")
    if nvcc is None:
        return "not found"
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"error: {e}"
    lines = [ln for ln in out.strip().splitlines() if ln.strip()]
    return lines[-1] if lines else "unknown"


def collect_env() -> dict:
    info = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "processor": platform.processor(),
    }
    try:
        from scalellm_tpu_torch.version import __version__

        info["scalellm_tpu_torch"] = __version__
    except Exception:
        pass
    try:
        import torch

        info["torch"] = torch.__version__
        info["torch_cuda"] = torch.version.cuda
        info["cuda_available"] = torch.cuda.is_available()
        info["devices"] = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    except Exception as e:
        info["torch"] = f"error: {e}"
    info["nvcc"] = _nvcc_version()
    for mod in ("numpy", "triton"):
        try:
            m = __import__(mod)
            info[mod] = getattr(m, "__version__", "unknown")
        except Exception:
            info[mod] = "not installed"
    return info


def main():
    for k, v in collect_env().items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
