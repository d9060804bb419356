"""Command-line entry point: the reference's fixed battery of configurations.

`gpu-denoise [image-path]` is the counterpart of `tpu-denoise`
(image_denoising_filter_tpu/cli.py) and of the reference's `main()`
(src/main.cpp:1935-1994): the six device configurations in fixed order, each
printing its transfer/exec timing, with outputs under the reference's
flag-encoded names (src/main.cpp:1677-1682), then the CPU bilateral with 1
and 8 threads (cpu1, cpu8), each printing its wall-clock seconds. `--device`
picks the device of the six; `cuda` without a card is an error, whatever the
selection. `--turbo D` runs every device config in its approximate form, as
tpu-denoise does: the bilateral, linear and layers configs through the grids
with spatial reduction D (Session.run_turbo), the NLM configs with a
stride-2 search and bf16 taps (Session.run); `--weights-halfres` adds the
NLM weights at half row resolution to them. `--profile DIR` writes one
torch.profiler trace of the whole battery into DIR, each config in a span
named after its key.

`--mesh FxY` runs the device configs on F * Y ranks of torch.distributed
(frame data parallelism x spatial row sharding, parallel/): under torchrun
each process is one rank; otherwise gpu-denoise spawns the ranks itself
(parallel.launch.run_ranks). `--dist-backend` picks NCCL (one rank a card,
the default on CUDA) or gloo (the CPU's, and several ranks on one card).
Rank 0 alone prints and writes the files; the CPU configs run on rank 0.

With `--device cuda` the Session builds (or loads) the native host library
(utils/native.py) before the first config, outside every timed region: cpu1
and cpu8 run the OpenMP CPU bilateral on 1 and 8 threads, the overlap config
decodes its frames on the library's threads, and load and save use its C++
codecs. A failed build exits 1 with the compiler's message, as a missing
nvcc does.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys

import torch

import torch.distributed as dist

from .config import (
    GPU_BATTERY,
    BilateralParams,
    LayersParams,
    NlmParams,
    RunConfig,
    TilingConfig,
)
from .ops import stencils
from .parallel import launch
from .runtime.session import Session
from .utils import dataset as dataset_mod
from .utils.timing import Timer, print_cpu_time

DEFAULT_IMAGE = "Animations/CornellBox/Animation01_LDR_0000.png"

CONFIG_KEYS = ("bilateral", "layers", "linear", "nlm", "multiframe", "overlap")
# The CPU bilateral configs and their thread counts, run after the six.
CPU_CONFIGS = {"cpu1": 1, "cpu8": 8}
# The file --profile writes into its directory.
TRACE_NAME = "gpu-denoise.pt.trace.json"
# The configs --turbo runs through the grids; the NLM configs take a
# stride-2 search with bf16 taps instead.
GRID_CONFIGS = ("bilateral", "linear", "layers")

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


def _profiler(device: str) -> torch.profiler.profile:
    """A profiler of the host's ops, and of the card's kernels and copies
    when the battery runs on one."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _write_trace(prof: torch.profiler.profile, out_dir: str) -> None:
    """Export the Chrome trace, and raise unless a trace was written: the
    exporter may only log a failure."""
    path = os.path.join(out_dir, TRACE_NAME)
    if os.path.exists(path):
        os.remove(path)
    prof.export_chrome_trace(path)
    if not os.path.isfile(path) or os.path.getsize(path) == 0:
        raise RuntimeError(f"the profiler wrote no trace to {path}")


def parse_mesh(text: str) -> tuple[int, int]:
    """'FxY' -> (F, Y), as tpu-denoise reads --mesh (JAX cli.py:163-166);
    ValueError unless both are positive integers."""
    f, y = text.lower().split("x")
    shape = (int(f), int(y))
    if min(shape) < 1:
        raise ValueError(f"mesh axes must be at least 1, got {text!r}")
    return shape


def _parser() -> argparse.ArgumentParser:
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
        help="comma list from: " + ",".join((*CONFIG_KEYS, *CPU_CONFIGS)) + " (default: all)",
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
        "--profile", metavar="DIR", default=None,
        help="write a torch.profiler trace of the whole battery (host ops, and "
        "the card's kernels and copies with --device cuda) to DIR/" + TRACE_NAME
        + ", each config in a span named after its key; a profiler that cannot "
        "start or write the trace is an error (exit code 1)",
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
        help="approximate speed mode for every config (0 = exact kernels): the "
        "bilateral and linear configs run the per-channel bilateral grid with "
        "spatial reduction D (D = 1 is the whole-image lattice, D = 2, 4, 8 the "
        "grid kernels), the layers config the layer-guided grid (the fused "
        "kernel at D = 2 and 4, the guided build and slice at D = 1 and 8), "
        "the NLM configs a stride-2 search (49 of 196 candidates) with bf16 "
        "taps. Under --turbo the 'linear' config runs the same grid pipeline "
        "as 'bilateral' under its own file name",
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
    ap.add_argument(
        "--search-disk", action="store_true",
        help="trim the NLM search candidates to the disk dy^2+dx^2 <= s^2 "
        "(with --turbo: 37 of 196 candidates)",
    )
    ap.add_argument(
        "--weights-halfres", action="store_true",
        help="compute the NLM weight field at half row resolution (bilinear "
        "row upsample; value taps stay full resolution): the NLM configs run "
        "the half-row NLM kernel; requires --turbo (stride-2 search) and "
        "patch radius 3",
    )
    ap.add_argument(
        "--mesh", default=None, metavar="FxY",
        help="multi-device mesh, e.g. 2x4 = 2-way frame data parallelism x 4-way "
        "spatial row sharding, one torch.distributed rank each (default: one device)",
    )
    ap.add_argument(
        "--dist-backend", default=None, choices=launch.BACKENDS,
        help="torch.distributed backend of --mesh (default: nccl with --device cuda, "
        "which takes one rank a card; gloo with --device cpu, or to run several ranks "
        "on one card)",
    )
    return ap


def run(argv: list[str] | None = None) -> tuple[int, list[dict]]:
    """gpu-denoise: returns its exit code and each rank's kernel launch
    counts (stencils.launches after the battery; one dict, this process's,
    without --mesh)."""
    args = _parser().parse_args(argv)
    keys = (*CONFIG_KEYS, *CPU_CONFIGS)
    sel = keys if args.configs == "all" else tuple(args.configs.split(","))
    for key in sel:
        if key not in keys:
            print(f"error: unknown config {key!r} (choose from {','.join(keys)})",
                  file=sys.stderr)
            return 1, []
    if args.weights_halfres and not args.turbo:
        print("--weights-halfres requires --turbo (stride-2 search)", file=sys.stderr)
        return 1, []
    if not args.mesh:
        return _battery(args, sel, None), [dict(stencils.launches)]
    try:
        mesh_shape = parse_mesh(args.mesh)
        device_type = torch.device(args.device).type
        backend = args.dist_backend or launch.default_backend(device_type)
        world = mesh_shape[0] * mesh_shape[1]
        if launch.under_torchrun():
            launch.init_from_env(backend, device_type)
            try:
                if int(os.environ["WORLD_SIZE"]) != world:
                    raise ValueError(f"--mesh {args.mesh} needs {world} ranks, torchrun "
                                     f"started {os.environ['WORLD_SIZE']}")
                quiet = dist.get_rank() != 0
                with open(os.devnull, "w") as null, contextlib.redirect_stdout(
                        null) if quiet else contextlib.nullcontext():
                    return _battery(args, sel, mesh_shape), [dict(stencils.launches)]
            finally:
                dist.destroy_process_group()
        results = launch.run_ranks(world, _battery_rank, args, sel, mesh_shape,
                                   backend=backend, device_type=device_type)
    except Exception as e:  # a refused mesh, backend or device, or a failed rank
        print(f"error: {e}", file=sys.stderr)
        return 1, []
    rc, text, _ = results[0]
    print(text, end="")
    return rc, [counts for _, _, counts in results]


def _battery_rank(args: argparse.Namespace, sel: tuple, mesh_shape: tuple) -> tuple:
    """One spawned rank of a --mesh run: the battery, with its output kept
    for rank 0 to hand back. Returns (exit code, rank 0's stdout, this
    rank's launch counts)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = _battery(args, sel, mesh_shape)
    return rc, out.getvalue() if dist.get_rank() == 0 else "", dict(stencils.launches)


def main(argv: list[str] | None = None) -> int:
    return run(argv)[0]


def _battery(args: argparse.Namespace, sel: tuple, mesh_shape: tuple | None) -> int:
    """The selected configs for each target, on this process's device, or as
    one rank of mesh_shape's mesh (the CPU configs then on rank 0 alone)."""
    lead = mesh_shape is None or dist.get_rank() == 0
    device = args.device if mesh_shape is None else torch.device(args.device).type
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
            # The turbo NLM: every second search candidate along each axis.
            search_stride=2 if args.turbo else 1,
            search_disk=args.search_disk,
            weights_halfres=args.weights_halfres,
        )
        frame_cache: dict = {}
        os.makedirs(args.output_dir, exist_ok=True)
        profile = args.profile if lead else None
        if profile:
            os.makedirs(profile, exist_ok=True)
        with _profiler(device) if profile else contextlib.nullcontext() as prof:
            for target in targets:
                out_dir = args.output_dir
                if args.all_frames:
                    stem = os.path.splitext(os.path.basename(target))[0]
                    out_dir = os.path.join(args.output_dir, stem)
                    os.makedirs(out_dir, exist_ok=True)
                    print(f"=== frame {stem} ===")
                session = Session(
                    target,
                    device=device,
                    bilateral_params=bp,
                    layers_params=lp,
                    nlm_params=nlp,
                    output_dir=out_dir,
                    clamp_output=args.clamp,
                    debug_weights=args.debug_weights,
                    frame_cache=frame_cache,
                    batch_frames=args.batch_frames,
                    # The turbo NLM pairs the stride-2 search with bf16 taps.
                    nlm_tiling=TilingConfig(compute_dtype="bfloat16") if args.turbo else None,
                    mesh_shape=mesh_shape,
                )
                for cfg, key in zip(GPU_BATTERY, CONFIG_KEYS):
                    if key not in sel:
                        continue
                    print(f"<<<--- {_banner(cfg)} --->>>")
                    with torch.profiler.record_function(key):
                        if args.turbo and key in GRID_CONFIGS:
                            result = session.run_turbo(
                                cfg, levels=args.turbo_levels, downsample=args.turbo
                            )
                        else:
                            result = session.run(cfg)
                    print(f"\toutput: {result.output_path}")
                    result.report.print()
                for key, threads in CPU_CONFIGS.items():
                    if key not in sel or not lead:
                        continue
                    print(f"<<<--- bilateral filter on cpu ({threads} thread"
                          f"{'s' if threads > 1 else ''}) --->>>")
                    timer = Timer()
                    with torch.profiler.record_function(key):
                        path, _ = session.run_cpu(threads)
                    print(f"\toutput: {path}")
                    print_cpu_time(timer)
        if prof is not None:
            _write_trace(prof, profile)
            print(f"\tprofile trace written to {profile}")
    except Exception as e:  # main.cpp:1948-1991 catches and reports
        if mesh_shape is not None:
            raise  # a rank that returned would leave its peers in a collective
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
