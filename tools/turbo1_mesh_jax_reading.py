#!/usr/bin/env python3
"""The JAX package's own reading of the sharded turbo bilateral grid at D = 1
(`--turbo 1 --mesh 1x4`) on chip_smoke.py's two 1080p targets: the output of
the bilateral config against the exact tiled bilateral's, each written by
`tpu-denoise` with the smoke's flags, read as chip_smoke.py reads the port's.

    JAX_PLATFORMS=cpu python tools/turbo1_mesh_jax_reading.py

On one device `--turbo 1` runs the JAX package's XLA lattice; on a mesh its
sharded grid runs the Pallas pool, build and slice kernels at D = 1 (17 blur
taps at sigma_s 2), which the port's CUDA kernels port. Here the mesh is four
virtual CPU devices (the tool sets XLA_FLAGS for them unless it is set) and
the Pallas kernels run in interpret mode.

The readings, one a target:
  * "1080p": phase 4's animation (PNG, written with --clamp), dB over RGB of
    the 8-bit files (chip_smoke.psnr);
  * "1080p HDR": phase 10's EXR animation, dB over RGB with the exact
    output's largest RGB value as the peak (chip_smoke.psnr_peak).
Then the port's readings through its plain versions on the CPU (`gpu-denoise
--device cpu`, the mesh on four gloo ranks), which the card's kernels meet
at the kernel contracts, and the one-device lattice's for contrast. Prints
one line a reading and, last, the dict chip_smoke.py carries as
JAX_TURBO1_MESH_READINGS_DB. A few minutes.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()

import chip_smoke as smoke  # noqa: E402  (the smoke's animations and readings)

MESH = ("--turbo", "1", "--mesh", "1x4")


def _read(imageio, out_dir: str, name: str):
    return imageio.load(os.path.join(out_dir, name))[0]


def _reading(out, exact, hdr: bool) -> float:
    if hdr:
        return smoke.psnr_peak(out, exact, float(exact[..., :3].max()))
    return smoke.psnr(out[..., :3], exact[..., :3])


def _package(label: str, run, imageio, target: str, flags: list, root: str, name: str,
             hdr: bool) -> dict:
    """One package's exact bilateral, its --turbo 1 on one device and on the
    1x4 mesh, each through run(argv); returns {run: dB vs the exact}."""
    outs = {}
    for what, extra in (("exact", []), ("one device", ["--turbo", "1"]), ("mesh 1x4", MESH)):
        t0 = time.perf_counter()
        out_dir = os.path.join(root, f"{label}_{what.replace(' ', '_')}")
        assert run([target, *flags, *extra, "--configs", "bilateral", "--output-dir",
                    out_dir]) == 0
        outs[what] = _read(imageio, out_dir, name)
        print(f"  {label} {what}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return {what: _reading(outs[what], outs["exact"], hdr) for what in ("one device", "mesh 1x4")}


def main() -> int:
    import torch

    from image_denoising_filter_tpu import cli as jcli
    from image_denoising_filter_tpu.config import GPU_BATTERY
    from image_denoising_filter_tpu.utils import imageio as jimageio
    from image_denoising_filter_tpu_torch import cli as pcli
    from image_denoising_filter_tpu_torch.utils import imageio as pimageio

    torch.set_num_threads(2)

    def port(argv):
        rc, _ = pcli.run([*argv, "--device", "cpu", "--dist-backend", "gloo"]
                         if "--mesh" in argv else [*argv, "--device", "cpu"])
        return rc

    render_frame = smoke.load_render_frame()
    jax_db, port_db = {}, {}
    for label, writer, flags, hdr in (("1080p", smoke.write_animation, ["--clamp"], False),
                                      ("1080p HDR", smoke.write_hdr_animation, [], True)):
        root = smoke.scratch_dir()
        try:
            anim = writer(jimageio, render_frame, root)
            name = GPU_BATTERY[0].output_name(hdr)
            jax_db[label] = _package("jax", jcli.main, jimageio, anim["target"], flags, root,
                                     name, hdr)
            port_db[label] = _package("port", port, pimageio, anim["target"], flags, root,
                                      name, hdr)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    for label in jax_db:
        for what in ("one device", "mesh 1x4"):
            print(f"{label} --turbo 1 {what} bilateral: JAX {jax_db[label][what]:.4f} dB; port, "
                  f"plain versions on the CPU {port_db[label][what]:.4f} dB")
    print(json.dumps({label: round(db["mesh 1x4"], 4) for label, db in jax_db.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
