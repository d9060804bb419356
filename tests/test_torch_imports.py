"""The port imports torch and never jax: checked in a fresh interpreter, where
nothing else has imported jax first."""

import os
import subprocess
import sys

import pytest

MODULES = [
    "image_denoising_filter_tpu_torch",
    "image_denoising_filter_tpu_torch.cli",
    "image_denoising_filter_tpu_torch.runtime",
    "image_denoising_filter_tpu_torch.models",
    "image_denoising_filter_tpu_torch.ops",
    "image_denoising_filter_tpu_torch.ops._build",
    "image_denoising_filter_tpu_torch.ops.fast",
    "image_denoising_filter_tpu_torch.utils",
]

# Modules that need no torch: the package root and the shared host utilities.
NO_TORCH = ("image_denoising_filter_tpu_torch", "image_denoising_filter_tpu_torch.utils")


@pytest.mark.parametrize("module", MODULES)
def test_port_imports_no_jax(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        f"assert 'torch' in sys.modules or {module!r} in {NO_TORCH!r}\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
