"""Command-line entry point: the reference's fixed battery of device
configurations.

`gpu-denoise [image-path]` is the counterpart of `tpu-denoise`
(image_denoising_filter_tpu/cli.py) and of the reference's `main()`
(src/main.cpp:1935-1994): the six device configurations in fixed order, each
printing its transfer/exec timing, with outputs under the reference's
flag-encoded names (src/main.cpp:1677-1682). `--device` picks the device;
`cuda` without a card is an error. `--turbo D` runs the bilateral and linear
configs through the approximate bilateral grid (Session.run_turbo).
"""

from __future__ import annotations

import argparse
import os
import sys

from image_denoising_filter_tpu.config import (
    GPU_BATTERY,
    BilateralParams,
    LayersParams,
    NlmParams,
    RunConfig,
)
from image_denoising_filter_tpu.utils import dataset as dataset_mod

from .runtime.session import Session

DEFAULT_IMAGE = "Animations/CornellBox/Animation01_LDR_0000.png"

CONFIG_KEYS = ("bilateral", "layers", "linear", "nlm", "multiframe", "overlap")
# The CPU bilateral configs of tpu-denoise wait for Session.run_cpu.
NOT_PORTED = ("cpu1", "cpu8")
# Under --turbo, the configs whose turbo forms wait for a later slice, with
# the ROADMAP.md item that ports them.
TURBO_NOT_PORTED = {
    "layers": "queue A item 9, turbo layers",
    "nlm": "queue A item 8, turbo NLM",
    "multiframe": "queue A item 8, turbo NLM",
    "overlap": "queue A item 8, turbo NLM",
}

_CONFIG_BANNERS = {
    # main.cpp:1952-1972 banners, modernized
    (False, False, False, False, False): "bilateral filter (tiled layout)",
    (False, False, False, False, True): "bilateral filter using layers",
    (False, True, False, False, False): "bilateral filter (linear layout)",
    (True, False, False, False, False): "non-local means filter",
    (True, False, True, False, False): "multiframe non-local means filter",
    (True, False, True, True, False): "multiframe NLM with copy/compute overlap",
}


def _banner(cfg: RunConfig) -> str:
    key = (cfg.nlm, cfg.linear, cfg.multiframe, cfg.overlap, cfg.use_layers)
    return _CONFIG_BANNERS.get(key, str(cfg))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="gpu-denoise",
        description="CUDA image denoising battery "
        "(bilateral / layer-guided / temporal NLM)",
    )
    ap.add_argument("image", nargs="?", default=DEFAULT_IMAGE, help="target image path")
    ap.add_argument("--output-dir", default=".", help="where output-*.png/.exr go")
    ap.add_argument(
        "--configs",
        default="all",
        help="comma list from: " + ",".join(CONFIG_KEYS) + " (default: all)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default: cuda; cpu runs the kernels' "
        "plain PyTorch versions)",
    )
    ap.add_argument(
        "--clamp", action="store_true",
        help="saturating LDR quantization instead of the reference's wrapping cast",
    )
    ap.add_argument(
        "--debug-weights", action="store_true",
        help="dump sampled NLM weight-accumulator values "
        "(the reference's disabled debug block, src/main.cpp:1628-1647)",
    )
    ap.add_argument(
        "--all-frames", action="store_true",
        help="serving mode: run the selected configs for EVERY same-extension "
        "frame in the target's directory (outputs under output-dir/<frame-stem>/)",
    )
    ap.add_argument(
        "--batch-frames", action="store_true",
        help="run non-overlap multiframe NLM as frame-batched kernel launches "
        "(stacked upload; accumulators stay in registers across frames) "
        "instead of one launch per frame; long sequences are chunked at "
        "~1.5 GB of stacked frames",
    )
    ap.add_argument(
        "--turbo", type=int, default=0, metavar="D", choices=[0, 1, 2, 4, 8],
        help="approximate speed mode for the bilateral configs: the per-channel "
        "bilateral grid with spatial reduction D (0 = exact kernels; D = 1 is "
        "the whole-image lattice, D = 2, 4, 8 the grid kernels). Under --turbo "
        "the 'linear' config runs the same grid pipeline as 'bilateral' under "
        "its own file name; the layers and NLM configs are not ported in turbo "
        "form yet and are refused",
    )
    ap.add_argument(
        "--turbo-levels", type=int, default=None, metavar="K",
        help="bilateral-grid intensity levels for --turbo (default: K=5 at "
        "D=2 and 4, K=6 otherwise)",
    )
    # Filter parameters (the reference requires editing main.cpp to change
    # these, README.md:3; defaults are the reference's push-constant values).
    ap.add_argument("--radius", type=int, default=20, help="bilateral window radius")
    ap.add_argument("--sigma-spatial", type=float, default=2.0)
    ap.add_argument("--sigma-color", type=float, default=0.2)
    ap.add_argument("--nlm-h", type=float, default=0.5, help="NLM filtering parameter")
    ap.add_argument("--search-radius", type=int, default=7, help="NLM search radius (half-open)")
    ap.add_argument("--patch-radius", type=int, default=3, help="NLM patch radius (half-open)")
    args = ap.parse_args(argv)

    sel = CONFIG_KEYS if args.configs == "all" else tuple(args.configs.split(","))
    for key in sel:
        if key in NOT_PORTED:
            print(f"error: config {key} is not ported yet (Session.run_cpu, "
                  "ROADMAP.md queue A item 6)", file=sys.stderr)
            return 1
        if key not in CONFIG_KEYS:
            print(f"error: unknown config {key!r} (choose from {','.join(CONFIG_KEYS)})",
                  file=sys.stderr)
            return 1
        if args.turbo and key in TURBO_NOT_PORTED:
            print(f"error: config {key} under --turbo is not ported yet "
                  f"(ROADMAP.md {TURBO_NOT_PORTED[key]})", file=sys.stderr)
            return 1

    try:
        targets = [args.image]
        if args.all_frames:
            if not os.path.exists(args.image):
                raise FileNotFoundError(args.image)
            targets = list(
                dataset_mod.discover(args.image, multiframe=True, max_frames=None).frames[1:]
            )
        bp = BilateralParams(
            radius=args.radius,
            sigma_spatial=args.sigma_spatial,
            sigma_color=args.sigma_color,
        )
        lp = LayersParams(
            radius=args.radius,
            sigma_spatial=args.sigma_spatial,
            sigma_color=args.sigma_color,
        )
        nlp = NlmParams(
            search_radius=args.search_radius,
            patch_radius=args.patch_radius,
            h=args.nlm_h,
        )
        frame_cache: dict = {}
        os.makedirs(args.output_dir, exist_ok=True)
        for target in targets:
            out_dir = args.output_dir
            if args.all_frames:
                stem = os.path.splitext(os.path.basename(target))[0]
                out_dir = os.path.join(args.output_dir, stem)
                os.makedirs(out_dir, exist_ok=True)
                print(f"=== frame {stem} ===")
            session = Session(
                target,
                device=args.device,
                bilateral_params=bp,
                layers_params=lp,
                nlm_params=nlp,
                output_dir=out_dir,
                clamp_output=args.clamp,
                debug_weights=args.debug_weights,
                frame_cache=frame_cache,
                batch_frames=args.batch_frames,
            )
            for cfg, key in zip(GPU_BATTERY, CONFIG_KEYS):
                if key not in sel:
                    continue
                print(f"<<<--- {_banner(cfg)} --->>>")
                if args.turbo:  # bilateral or linear: the same grid pipeline
                    result = session.run_turbo(
                        cfg, levels=args.turbo_levels, downsample=args.turbo
                    )
                else:
                    result = session.run(cfg)
                print(f"\toutput: {result.output_path}")
                result.report.print()
    except Exception as e:  # main.cpp:1948-1991 catches and reports
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
