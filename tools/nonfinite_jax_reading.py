#!/usr/bin/env python3
"""The JAX package's own readings of chip_smoke.py's non-finite animation
(phase 12): phase 10's 1080p EXR animation with NaN in bands 0 and 2 of a
1x4 mesh in the target, NaN in a neighbour frame and +inf in the target's
albedo layer (chip_smoke.NONFINITE_ANIMATION), through `tpu-denoise` with the
flags of each of the smoke's runs (chip_smoke.NONFINITE_RUNS), each output
read as the smoke reads the port's (chip_smoke.nonfinite_reading): per
channel the counts of NaN, +inf and -inf, a digest of their positions, and
the dB against its config's exact output over the values finite in both.

    JAX_PLATFORMS=cpu python tools/nonfinite_jax_reading.py

The JAX side runs on the CPU as its tests run it, its Pallas kernels in
interpret mode, the mesh on four virtual CPU devices (the tool sets
XLA_FLAGS for them unless it is set). On the CPU tpu-denoise's single-device
turbo bilateral and linear configs take its XLA lattice; its chip runs the
Pallas pipeline, which the port's kernels port, so that is what the tool
reads for them (as tools/hdr_jax_reading.py does).

The JAX package's banded matmuls (the pool, the grid builds' blur, the
slices' upsample) multiply every value of a tile by the band's zeros, so one
NaN or inf turns its whole tile, and on a mesh the bands its halo reaches,
NaN (ROADMAP.md queue C). For the runs listed in SPREAD the reading carries
the bounding boxes of those regions, channel by channel ("boxes"), and the
smoke holds the port's non-finite values inside them and reads its dB
outside them. A channel whose grid range takes a +-inf of the animation is
boxed whole (inf_range_boxes): the port's range keeps the inf, so the
channel is NaN, as on one device; the JAX package's sharded range leaves it
out, because its pool's matmul turned it into NaN first. Then the port's readings through its plain versions on the CPU
(`gpu-denoise --device cpu`, the mesh on four gloo ranks), which the card's
kernels meet at the kernel contracts: the same counts and digest as the JAX
package's, or for SPREAD runs every non-finite value inside the boxes; each
dB beside the JAX package's.

Prints one line a reading and, last, the dict chip_smoke.py carries as
JAX_NONFINITE_READINGS (a Python literal). About 15 minutes, ~3 GB.
"""

from __future__ import annotations

import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()

import numpy as np  # noqa: E402

import chip_smoke as smoke  # noqa: E402  (the smoke's animation, runs and readings)

# The runs whose outputs the JAX package's tiles spread non-finite values
# over: the guided grid (turbo layers; its build and slice are banded
# matmuls), the half-row NLM (its row pooling and upsample are), and every
# sharded grid (its pool and build are, and the grid range leaves a NaN band
# out, so the finite bands show the spread).
# The non-finite values of each grid's range source: the target for the
# bilateral grid, the albedo layer for the guided grid.
NONFINITE_SOURCES = {"target": smoke.NONFINITE_ANIMATION["frames"][smoke.TARGET_FRAME],
                     "layers": smoke.NONFINITE_ANIMATION["albedo"]}
SIX = ("bilateral", "layers", "linear", "nlm", "multiframe", "overlap")
SPREAD = ("turbo 1 layers", "turbo 2 layers",
          *(f"turbo 2 half-row {k}" for k in smoke.NLM_CONFIGS),
          *(f"mesh turbo {d} {k}" for d in (1, 2) for k in smoke.GRID_CONFIGS))


def boxes_of(out: np.ndarray) -> tuple[list, bool]:
    """The bounding boxes [channel, y0, y1, x0, x1] of out's connected
    regions of non-finite values, channel by channel, and whether each
    region fills its box."""
    from scipy import ndimage

    bad = smoke.nonfinite_masks(out).any(0)
    boxes, filled = [], True
    for c in range(out.shape[-1]):
        labels, _ = ndimage.label(bad[..., c])
        for i, sl in enumerate(ndimage.find_objects(labels), 1):
            boxes.append([c, sl[0].start, sl[0].stop, sl[1].start, sl[1].stop])
            filled &= bool((labels[sl] == i).all())
    return boxes, filled


def inf_range_boxes(name: str, shape) -> list:
    """Whole-frame boxes of the channels whose grid range takes a +-inf of
    the animation (the layer's for the layers config, the target's for the
    others; alpha with green): the port's range keeps it, and every value of
    the channel is NaN, as on one device in both packages; the JAX package's
    sharded range leaves it out, its pool's matmul having turned it into NaN
    (ROADMAP.md queue C)."""
    source = (NONFINITE_SOURCES["layers"] if name.endswith(" layers")
              else NONFINITE_SOURCES["target"])
    channels = {c for _, _, c, v in source if np.isinf(v)}
    channels |= {3} if 1 in channels else set()
    return [[c, 0, shape[0], 0, shape[1]] for c in sorted(channels)]


def inside(out: np.ndarray, boxes) -> bool:
    bad = smoke.nonfinite_masks(out).any(0)
    for c, y0, y1, x0, x1 in boxes:
        bad[y0:y1, x0:x1, c] = False
    return not bad.any()


def run_package(label: str, cli_main, imageio, target: str, root: str, names: dict) -> dict:
    """Every run of NONFINITE_RUNS through one package's CLI; returns
    {"<run> <config>": output}."""
    outs = {}
    for run, flags, keys in smoke.NONFINITE_RUNS:
        t0 = time.perf_counter()
        out_dir = os.path.join(root, f"{label}_{run.replace(' ', '_')}")
        assert cli_main([target, *flags, "--configs", ",".join(keys), "--output-dir",
                         out_dir]) == 0, (label, run)
        for key in keys:
            outs[f"{run} {key}"] = imageio.load(os.path.join(out_dir, names[key]))[0]
        print(f"  {label}: {run} {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return outs


def readings(outs: dict, boxes: dict) -> dict:
    out = {}
    for run, _, keys in smoke.NONFINITE_RUNS:
        for key in keys:
            ref = smoke.nonfinite_exact_key(run, key)
            name = f"{run} {key}"
            out[name] = smoke.nonfinite_reading(
                outs[name], None if ref is None else outs[f"exact {ref}"], boxes.get(name, ()))
    return out


def main() -> int:
    import jax.numpy as jnp
    import torch

    from image_denoising_filter_tpu import cli as jcli
    from image_denoising_filter_tpu.config import GPU_BATTERY, BilateralParams
    from image_denoising_filter_tpu.ops import fast as jfast
    from image_denoising_filter_tpu.utils import imageio as jimageio
    from image_denoising_filter_tpu_torch import cli as pcli
    from image_denoising_filter_tpu_torch.utils import imageio as pimageio

    torch.set_num_threads(4)
    names = {k: c.output_name(True) for k, c in zip(SIX, GPU_BATTERY)}

    def jax_cli(argv):
        drop = argv.index("--dist-backend") if "--dist-backend" in argv else None
        return jcli.main(argv if drop is None else argv[:drop] + argv[drop + 2:])

    def port_cli(argv):
        return pcli.run([*argv, "--device", "cpu"])[0]

    root = smoke.scratch_dir()
    try:
        target = smoke.write_nonfinite_animation(jimageio, smoke.load_render_frame(),
                                                 root)["target"]
        jax_outs = run_package("jax", jax_cli, jimageio, target, root, names)
        # The Pallas pipeline of the bilateral grid at D = 2, which
        # tpu-denoise runs on its chip (on the CPU it takes the XLA lattice).
        planar = jnp.transpose(jnp.asarray(jimageio.load(target)[0]), (2, 0, 1))
        grid = np.transpose(np.asarray(jfast._grid_pipeline_planar(
            planar, BilateralParams(), smoke.turbo_levels(2), 2)), (1, 2, 0))
        for key in ("bilateral", "linear"):
            jax_outs[f"turbo 2 {key}"] = grid
        boxes = {}
        for name in SPREAD:
            boxes[name], filled = boxes_of(jax_outs[name])
            whole = inf_range_boxes(name, jax_outs[name].shape)
            boxes[name] += whole
            print(f"{name}: the JAX package's non-finite values in {len(boxes[name])} boxes"
                  f"{'' if filled else ' (not every region fills its box)'}"
                  f"{f', and whole channels {[b[0] for b in whole]}' if whole else ''}")
        jax_r = readings(jax_outs, boxes)
        for name in SPREAD:
            jax_r[name]["boxes"] = boxes[name]
        port_outs = run_package("port", port_cli, pimageio, target, root, names)
        port_r = readings(port_outs, boxes)
        for name, want in jax_r.items():
            got = port_r[name]
            if name in boxes:
                agree = ("inside the JAX package's boxes" if inside(port_outs[name], boxes[name])
                         else "NOT inside the JAX package's boxes")
            else:
                agree = ("counts and digest equal" if (got["counts"], got["digest"])
                         == (want["counts"], want["digest"]) else
                         f"DIFFERENT counts {got['counts']} digest {got['digest']}")
            per_kind = np.asarray(want["counts"]).sum(0).tolist()
            print(f"{name}: JAX NaN/+inf/-inf {per_kind} (by channel {want['counts']}), "
                  f"{want['db']} dB; port, plain versions on the CPU: {agree}, {got['db']} dB")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(repr(jax_r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
