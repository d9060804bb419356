"""The port imports torch, never jax, and nothing of the JAX package
image_denoising_filter_tpu: checked in a fresh interpreter, where nothing
else has imported either first."""

import os
import subprocess
import sys

import pytest

MODULES = [
    "image_denoising_filter_tpu_torch",
    "image_denoising_filter_tpu_torch.cli",
    "image_denoising_filter_tpu_torch.config",
    "image_denoising_filter_tpu_torch.runtime",
    "image_denoising_filter_tpu_torch.runtime.prefetch",
    "image_denoising_filter_tpu_torch.runtime.session",
    "image_denoising_filter_tpu_torch.models",
    "image_denoising_filter_tpu_torch.ops",
    "image_denoising_filter_tpu_torch.ops._build",
    "image_denoising_filter_tpu_torch.ops.eager",
    "image_denoising_filter_tpu_torch.ops.fast",
    "image_denoising_filter_tpu_torch.ops.reference",
    "image_denoising_filter_tpu_torch.ops.stencils",
    "image_denoising_filter_tpu_torch.parallel",
    "image_denoising_filter_tpu_torch.parallel.dryrun",
    "image_denoising_filter_tpu_torch.parallel.launch",
    "image_denoising_filter_tpu_torch.parallel.mesh",
    "image_denoising_filter_tpu_torch.parallel.spatial",
    "image_denoising_filter_tpu_torch.utils",
    "image_denoising_filter_tpu_torch.utils.content",
    "image_denoising_filter_tpu_torch.utils.dataset",
    "image_denoising_filter_tpu_torch.utils.imageio",
    "image_denoising_filter_tpu_torch.utils.native",
    "image_denoising_filter_tpu_torch.utils.progress",
    "image_denoising_filter_tpu_torch.utils.timing",
]

# Modules that need no torch: the package root, its config and the host
# utilities.
NO_TORCH = (
    "image_denoising_filter_tpu_torch",
    "image_denoising_filter_tpu_torch.config",
    "image_denoising_filter_tpu_torch.utils",
    "image_denoising_filter_tpu_torch.utils.content",
    "image_denoising_filter_tpu_torch.utils.dataset",
    "image_denoising_filter_tpu_torch.utils.imageio",
    "image_denoising_filter_tpu_torch.utils.native",
    "image_denoising_filter_tpu_torch.utils.progress",
    "image_denoising_filter_tpu_torch.utils.timing",
)


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True,
        text=True,
        timeout=120,
    )


@pytest.mark.parametrize("module", MODULES)
def test_port_imports_no_jax(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        f"assert 'torch' in sys.modules or {module!r} in {NO_TORCH!r}\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "ref = 'image_denoising_filter_tpu'\n"
        "bad = sorted(m for m in sys.modules if m == ref or m.startswith(ref + '.'))\n"
        "assert not bad, bad\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """chip_smoke.py names only the port: importing it as a module (its
    main() does not run) and the port modules it imports load neither jax
    nor image_denoising_filter_tpu."""
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "for m in mod.PORT_MODULES:\n"
        "    importlib.import_module(m)\n"
        "ref = 'image_denoising_filter_tpu'\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', ref) or m.startswith(('jax.', ref + '.')))\n"
        "assert not bad, bad\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
