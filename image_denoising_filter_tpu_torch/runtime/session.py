"""Session: runs one denoising configuration end to end, on one device or
on a mesh of ranks.

Counterpart of image_denoising_filter_tpu/runtime/session.py, the exact
paths (with float32 or bf16 taps, the `tiling`) and the turbo modes
(`run_turbo` for the bilateral, linear and layers configs; `run` with a
strided search and bf16 taps, the `nlm_tiling`, for the NLM configs): dataset
discovery -> image loading -> host-to-device upload -> kernels -> readback
-> flag-encoded save, with the per-run transfer/exec report (the PRINT_TIME
analog of `ComputeApplication::RunOnGPU`, src/main.cpp:1307-1730); and the
CPU bilateral of the cpu1/cpu8 configs (`run_cpu`, RunOnCPU). The device is
an explicit argument; a CUDA device without a card is an error, never a
quiet run on the CPU. On a CUDA device the Session also loads the native
host library (utils/native.py: the OpenMP CPU bilateral, the C++ codecs and
the threaded frame loader), building it at first use, and a failed build is
an error: the cpu8 config, the overlap config's frame loader and the codecs
never fall back to their single-threaded Python forms there. On a CPU device
they do where no library is built, as in the JAX package.

With `mesh_shape=(F, Y)` every rank of an initialised torch.distributed
process group of F * Y ranks runs the same Session (parallel/): each decodes
the input and keeps its band of rows, the kernels run on the bands with halo
exchange over 'y' and the temporal NLM's frames split over 'frame', the
output is gathered over 'y' into every rank's RunResult.image, and global
rank 0 alone writes the file. Its exec time ends with a synchronize and a
barrier, so rank 0's report covers the slowest rank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import (
    BilateralParams,
    BorderPolicy,
    CpuBilateralParams,
    LayersParams,
    NlmParams,
    RunConfig,
    TilingConfig,
)
from ..utils import dataset as dataset_mod
from ..utils import imageio, native
from ..utils.progress import ProgressBar
from ..utils.timing import Timer, TimingReport

from ..models.denoiser import (
    LINEAR,
    TILED,
    BilateralDenoiser,
    LayerGuidedDenoiser,
    NlmDenoiser,
    TemporalNlmDenoiser,
)
from ..ops import _build, eager, fast, reference, stencils
from ..parallel import (
    gather_rows,
    make_mesh,
    shard_rows,
    spatial_bilateral,
    spatial_bilateral_fast,
    spatial_cross_bilateral_layers,
    spatial_cross_bilateral_layers_fast,
    spatial_nlm_accumulate,
)
from ..parallel.mesh import FRAME_AXIS
from ..parallel.spatial import _all_reduce, temporal_nlm_local_partials
from .prefetch import FramePrefetcher


def _open_device(device: torch.device | str) -> torch.device:
    """Resolve and initialise the device, so that runtime start-up (the
    analog of vk_utils::CreateInstance/CreateLogicalDevice, outside the
    reference's timed range) and the first-use builds of the kernels and
    of the native host library are not counted in the first run's transfer
    or exec time. On a CUDA device a native library without OpenMP, or a
    failed build of one, raises native.NativeBuildError."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but no CUDA device is available "
                "(torch.cuda.is_available() is false)"
            )
        torch.cuda.init()
        torch.zeros(1, device=device).add_(1.0)
        _build.library()
        native.ensure()
        torch.cuda.synchronize(device)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: use cuda or cpu")
    return device


@dataclasses.dataclass
class RunResult:
    config: RunConfig
    output_path: str
    image: np.ndarray
    report: TimingReport
    # The overlap config's frame loader (FramePrefetcher.loader): "native"
    # (the native library's decode threads) or "python" (each frame decoded
    # on the loop's thread); None for the other configs.
    frame_loader: Optional[str] = None


class Session:
    """Runs RunConfigs against one target image on one device, or on a mesh
    of ranks (re-usable across configs, like the reference app object
    re-running RunOnGPU)."""

    _FRAME_CACHE_MAX = 32  # decoded frames kept when a cache dict is shared

    def __init__(
        self,
        target: str,
        *,
        device: torch.device | str,
        bilateral_params: BilateralParams = BilateralParams(),
        layers_params: LayersParams = LayersParams(),
        nlm_params: NlmParams = NlmParams(),
        tiling: Optional[TilingConfig] = None,
        output_dir: str = ".",
        clamp_output: bool = False,
        warmup: bool = True,
        debug_weights: bool = False,
        frame_cache: Optional[dict] = None,
        batch_frames: bool = False,
        nlm_tiling: Optional[TilingConfig] = None,
        mesh_shape: Optional[tuple[int, int]] = None,
    ) -> None:
        self.target = target
        self.device = _open_device(device)
        # (frame, y) mesh of the process group's ranks: rows shard over 'y'
        # with halo exchange, multiframe NLM partials sum over 'frame'. None
        # is one device (the reference's deviceId 0, src/main.cpp:1321).
        self.mesh = make_mesh(mesh_shape, self.device.type) if mesh_shape else None
        self.bilateral_params = bilateral_params
        self.layers_params = layers_params
        self.nlm_params = nlm_params
        # The tap dtype of the tiled bilateral and layers kernels:
        # TilingConfig(compute_dtype="bfloat16") takes bf16 taps; the linear
        # layout ignores it, as in the JAX package.
        self.tiling = tiling
        # The NLM kernels' tap dtype, `tiling` unless given: --turbo pairs the
        # stride-2 search with bf16 taps, as the JAX CLI does.
        self.nlm_tiling = nlm_tiling if nlm_tiling is not None else tiling
        self.output_dir = output_dir
        self.clamp_output = clamp_output
        # Run each model once before its timed region, so the exec report
        # measures steady-state device time (the reference creates its
        # pipelines outside the query range, main.cpp:690-727).
        self.warmup = warmup
        # Print sampled (weightColor, normWeight) values after the NLM
        # accumulation (the reference's disabled debug block,
        # src/main.cpp:1628-1647).
        self.debug_weights = debug_weights
        # Non-overlap multiframe NLM as frame-batched kernel launches (one
        # stacked upload, accumulators in registers across frames) instead
        # of one launch per frame; opt-in for the per-frame dispatch parity
        # with the reference's loop (src/main.cpp:1574-1607).
        self.batch_frames = batch_frames
        # Optional decoded-frame LRU shared across Sessions (serving mode
        # re-targets over the same neighbour frames).
        self._frame_cache = frame_cache
        self.is_hdr = imageio.is_hdr_path(target)

    def _fence(self) -> None:
        """Wait for the device: kernels launch asynchronously on CUDA. On a
        mesh, then wait for every rank."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.mesh is not None:
            dist.barrier()

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(host, np.float32)).to(self.device)

    def _load(self, path: str) -> np.ndarray:
        if self._frame_cache is None:
            return imageio.load(path)[0]
        if path in self._frame_cache:
            self._frame_cache[path] = self._frame_cache.pop(path)  # LRU touch
            return self._frame_cache[path]
        img = imageio.load(path)[0]
        self._frame_cache[path] = img
        while len(self._frame_cache) > self._FRAME_CACHE_MAX:
            self._frame_cache.pop(next(iter(self._frame_cache)))
        return img

    def run(self, cfg: RunConfig) -> RunResult:
        report = TimingReport()
        # The 10-frame cap is an overlap-path behaviour in the reference
        # (src/main.cpp:1341,1554); the plain multiframe loop uses all frames.
        ds = dataset_mod.discover(
            self.target,
            multiframe=cfg.multiframe,
            use_layers=cfg.use_layers,
            max_frames=cfg.max_frames if cfg.overlap else None,
        )
        target_host = self._load(ds.target)

        # Exact uniform-alpha fast path: when the target's alpha is one
        # constant AND the border is CLAMP (ZERO padding injects alpha-0 taps
        # with nonzero weight), the kernels rebuild alpha from the norm.
        # Applied where the alpha taps provably come from the target;
        # multiframe keeps the user's setting (frames arrive later).
        a = target_host[..., 3]
        ua = bool(a.min() == a.max())

        def _with_ua(params):
            if ua and params.border == BorderPolicy.CLAMP and not params.uniform_alpha:
                return dataclasses.replace(params, uniform_alpha=True)
            return params

        bilateral_params = _with_ua(self.bilateral_params)
        layers_params = _with_ua(self.layers_params)
        nlm_single_params = self.nlm_params if cfg.multiframe else _with_ua(self.nlm_params)

        if self.mesh is not None:
            out_band = self._run_sharded(target_host, ds, report, cfg, bilateral_params,
                                         layers_params, nlm_single_params)
            return self._save(cfg, out_band, report, target_host.shape[0])

        with report.transfer():
            target_dev = self._upload(target_host)

        layout = LINEAR if cfg.linear else TILED

        if cfg.use_layers:
            out_dev = self._run_layers(target_dev, ds, report, layout, layers_params)
        elif cfg.nlm and cfg.multiframe:
            out_dev, frame_loader = self._run_multiframe(target_dev, ds, report, layout, cfg)
            return self._save(cfg, out_dev, report, frame_loader=frame_loader)
        else:
            if cfg.nlm:
                model = NlmDenoiser(nlm_single_params, layout=layout, tiling=self.nlm_tiling)
            else:
                model = BilateralDenoiser(bilateral_params, layout=layout, tiling=self.tiling)
            out_dev = self._execute(lambda: model(target_dev), report)
        return self._save(cfg, out_dev, report)

    def _execute(self, fn, report: TimingReport) -> torch.Tensor:
        """fn() in the timed exec region, fenced, after one warm-up call
        outside it when warmup is set."""
        if self.warmup:
            fn()
            self._fence()
        with report.execute():
            out = fn()
            self._fence()
        return out

    def _save(self, cfg: RunConfig, out_dev: torch.Tensor, report: TimingReport,
              rows: Optional[int] = None, frame_loader: Optional[str] = None) -> RunResult:
        """Read the output back (timed as transfer) and save it under the
        config's flag-encoded name. On a mesh out_dev is this rank's band:
        the bands are gathered over 'y' first and cropped to the image's
        `rows`, and only global rank 0 writes."""
        with report.transfer():
            if self.mesh is not None:
                out_dev = gather_rows(out_dev, self.mesh)[:rows]
            out_host = out_dev.cpu().numpy()
        path = os.path.join(self.output_dir, cfg.output_name(self.is_hdr))
        if self.mesh is None or dist.get_rank() == 0:
            imageio.save(path, out_host, hdr=self.is_hdr, clamp=self.clamp_output)
        return RunResult(config=cfg, output_path=path, image=out_host, report=report,
                         frame_loader=frame_loader)

    # -- the mesh paths -----------------------------------------------------

    def _row_padding(self, h: int, halo: int, border: str) -> tuple[int, str]:
        """(rows to add, numpy pad mode) so that H divides by the 'y' size and
        every band holds at least `halo` rows (a band cannot source a halo
        larger than itself). Edge rows under CLAMP, zeros under ZERO: the
        border's own taps. JAX session.py:236-244."""
        n_y = self.mesh.size(1)
        rows = max(-(-h // n_y), halo)
        return rows * n_y - h, "edge" if border == BorderPolicy.CLAMP else "constant"

    def _pad_rows(self, img: np.ndarray, halo: int, border: str) -> np.ndarray:
        """img row-padded per _row_padding; the output is cropped back."""
        ph, mode = self._row_padding(img.shape[0], halo, border)
        return np.pad(img, ((0, ph), (0, 0), (0, 0)), mode=mode) if ph else img

    def _turbo_pad_rows(self, img: np.ndarray, radius: int, d: int, border: str) -> np.ndarray:
        """The sharded turbo's row padding (JAX session.py:606-620): bands of
        ceil_d(max(ceil(H/Y), d (rg + 1))) rows, rg = ceil(radius/d), so that
        they divide by d and hold the pooled halo."""
        n_y = self.mesh.size(1)
        rg = max(1, -(-radius // d))
        rows = max(-(-img.shape[0] // n_y), d * (rg + 1))
        rows = -(-rows // d) * d
        ph = rows * n_y - img.shape[0]
        mode = "edge" if border == BorderPolicy.CLAMP else "constant"
        return np.pad(img, ((0, ph), (0, 0), (0, 0)), mode=mode) if ph else img

    def _upload_band(self, padded: np.ndarray) -> torch.Tensor:
        """This rank's band of a row-padded host image, on the device."""
        return self._upload(shard_rows(padded, self.mesh))

    @staticmethod
    def _normalize(wc: torch.Tensor, nw: torch.Tensor, linear: bool) -> torch.Tensor:
        """The two-pass families' normalize: the kernel, or tensor ops on the
        linear layout (models/denoiser.py:_Normalizing)."""
        return eager.normalize_eager(wc, nw) if linear else stencils.normalize(wc, nw)

    def _run_sharded(self, target_host, ds, report, cfg, bp, lp, nlm_single) -> torch.Tensor:
        """The exact configs on the mesh (JAX session.py:254-310): rows over
        'y' with halo exchange, the multiframe NLM's frames over 'frame'.
        The linear configs shard the linear layout over the same mesh.
        Returns this rank's output band, row padding included."""
        linear = cfg.linear
        if cfg.use_layers:
            halo, border = lp.effective_radius, lp.border
        elif cfg.nlm:
            # nlm_single is self.nlm_params for the multiframe configs
            halo, border = nlm_single.halo, nlm_single.border
        else:
            halo, border = bp.effective_radius, bp.border
        with report.transfer():
            tgt = self._upload_band(self._pad_rows(target_host, halo, border))
        if cfg.nlm and cfg.multiframe:
            # The overlap loop never filters the last uploaded frame
            # (src/main.cpp:1554-1572), as in _run_multiframe.
            paths = list(ds.frames)
            if cfg.overlap and len(paths) > 1:
                paths = paths[:-1]
            return self._run_sharded_temporal(tgt, paths, report, halo, border, cfg)
        mesh = self.mesh
        if cfg.use_layers:
            layers_host = [self._pad_rows(self._load(p), halo, border) for p in ds.layers]
            with report.transfer():
                layers = [self._upload_band(x) for x in layers_host]

            def run():
                wc = torch.zeros(tgt.shape, dtype=torch.float32, device=self.device)
                nw = torch.zeros(tgt.shape[:2], dtype=torch.float32, device=self.device)
                for layer in layers:
                    pwc, pnw = spatial_cross_bilateral_layers(tgt, layer, lp, mesh, self.tiling,
                                                              linear)
                    wc = wc + pwc
                    nw = nw + pnw
                return self._normalize(wc, nw, linear)
        elif cfg.nlm:
            def run():
                wc, nw = spatial_nlm_accumulate(tgt, tgt, nlm_single, mesh, self.nlm_tiling,
                                                linear)
                return self._normalize(wc, nw, linear)
        else:
            def run():
                return spatial_bilateral(tgt, bp, mesh, self.tiling, linear)
        return self._execute(run, report)

    def _run_sharded_temporal(self, tgt, paths, report, halo, border, cfg) -> torch.Tensor:
        """Streamed multi-device temporal NLM (JAX session.py:312-377): the
        frames go in chunks of the 'frame' size, rank (f, y) taking frame f
        of each chunk (a masked zero frame where the chunk is short), and
        decoding only that frame. The next chunk's frame is decoded and
        uploaded while the current chunk's kernel runs. Each rank sums its
        frames' partials; one SUM over 'frame' at the end, then normalize.
        The uniform-alpha rule of the per-frame loop holds per frame
        (_run_multiframe; the overlap loop keeps the user's setting)."""
        params = self.nlm_params
        fast_ok = (border == BorderPolicy.CLAMP and not params.uniform_alpha
                   and not cfg.overlap)
        fast_params = dataclasses.replace(params, uniform_alpha=True)
        n_f = self.mesh.size(0)
        f_idx = self.mesh.get_local_rank(FRAME_AXIS)
        linear = cfg.linear
        mesh = self.mesh

        def upload_chunk(chunk):
            if f_idx >= len(chunk):
                return torch.zeros_like(tgt)[None], 0.0, params
            host = self._load(chunk[f_idx])
            a = host[..., 3]
            fparams = fast_params if fast_ok and a.min() == a.max() else params
            padded = self._pad_rows(host, halo, border)
            with report.transfer():
                frame = self._upload_band(padded)[None]
            return frame, 1.0, fparams

        def partials(frames, valid, fparams):
            v = torch.full((1,), valid, dtype=torch.float32, device=self.device)
            return temporal_nlm_local_partials(tgt, frames, fparams, mesh, self.nlm_tiling, v,
                                               linear)

        if self.warmup:
            partials(tgt[None], 1.0, params)
            self._fence()
        chunks = [paths[i : i + n_f] for i in range(0, len(paths), n_f)]
        pending = upload_chunk(chunks[0]) if chunks else None
        wc = torch.zeros(tgt.shape, dtype=torch.float32, device=self.device)
        nw = torch.zeros(tgt.shape[:2], dtype=torch.float32, device=self.device)
        bar = ProgressBar(label="frames")
        with report.execute():
            for ci in range(len(chunks)):
                pwc, pnw = partials(*pending)
                if ci + 1 < len(chunks):
                    pending = upload_chunk(chunks[ci + 1])
                wc, nw = (pwc, pnw) if ci == 0 else (wc + pwc, nw + pnw)
                bar.progress(min((ci + 1) * n_f, len(paths)), len(paths))
            bar.finish()
            wc = _all_reduce(wc, dist.ReduceOp.SUM, mesh, FRAME_AXIS)
            nw = _all_reduce(nw, dist.ReduceOp.SUM, mesh, FRAME_AXIS)
            out = self._normalize(wc, nw, linear)
            self._fence()
        return out

    def run_turbo(
        self, cfg: RunConfig, levels: Optional[int] = None, downsample: int = 2
    ) -> RunResult:
        """Approximate grid mode for the bilateral and linear configs (the
        per-channel bilateral grid, ops/fast.py:bilateral_fast) and the
        layers config (the guided grid, `_run_turbo_layers`), saved under the
        config's flag-encoded name. Like the JAX Session it passes the
        parameters as given (no uniform-alpha switch). levels=None resolves
        to K=5 at downsample 2 and 4, K=6 otherwise, for both families. The
        NLM configs have no grid: their turbo form is `run` with a stride-2
        search and bf16 taps (nlm_tiling). On a mesh the rows are padded to
        bands that divide by the downsample and hold the pooled halo, and the
        grids are built and sliced band by band (parallel/spatial.py); the
        bilateral grid takes downsample 2, 4 or 8 there (its kernels)."""
        if cfg.nlm:
            raise ValueError(
                "the NLM configs have no grid mode: turbo NLM runs through run() "
                "with search_stride=2 and nlm_tiling=TilingConfig(compute_dtype='bfloat16')"
            )
        if levels is None:
            levels = 5 if downsample in (2, 4) else 6
        if downsample >= 8 and self.bilateral_params.sigma_spatial < 5.0:
            # The crossover is the JAX package's measurement on the TPU at 4K
            # (docs/PERFORMANCE.md); this port has not measured it itself.
            print(
                "note: --turbo 8 with sigma_spatial="
                f"{self.bilateral_params.sigma_spatial:g} measured below the 40 dB"
                " quality gate vs the exact kernel in the JAX package's runs"
                " (crossover at sigma_s ~5-6; docs/PERFORMANCE.md). Use --turbo 4"
                " or a larger --sigma-spatial."
            )
        if cfg.use_layers:
            return self._run_turbo_layers(cfg, levels, downsample)

        report = TimingReport()
        target_host = self._load(self.target)
        bp = self.bilateral_params
        if self.mesh is not None:
            d = max(1, downsample)
            padded = self._turbo_pad_rows(target_host, bp.effective_radius, d, bp.border)
            with report.transfer():
                band = self._upload_band(padded)
            out_band = self._execute(
                lambda: spatial_bilateral_fast(band, bp, self.mesh, levels, downsample), report
            )
            return self._save(cfg, out_band, report, target_host.shape[0])
        with report.transfer():
            target_dev = self._upload(target_host)
        out_dev = self._execute(
            lambda: fast.bilateral_fast(target_dev, bp, levels, downsample), report
        )
        return self._save(cfg, out_dev, report)

    def _run_turbo_layers(self, cfg: RunConfig, levels: int, downsample: int) -> RunResult:
        """The turbo layers config (JAX session.py:_run_turbo_layers): per
        layer the guided grid's unnormalized partials, accumulated like the
        exact two-pass pipeline (src/main.cpp:1608-1624), then one
        per-channel divide with the magenta sentinel; with no layers the
        sentinel everywhere."""
        report = TimingReport()
        ds = dataset_mod.discover(self.target, multiframe=False, use_layers=True)
        target_host = self._load(ds.target)
        layers_host = [self._load(p) for p in ds.layers]
        lp = self.layers_params
        rows = target_host.shape[0]
        if self.mesh is not None:
            # The bilateral turbo's row rule (JAX session.py:665-697).
            d = max(1, downsample)
            target_host, *layers_host = [
                self._turbo_pad_rows(x, lp.effective_radius, d, lp.border)
                for x in [target_host, *layers_host]
            ]
            with report.transfer():
                target_dev = self._upload_band(target_host)
                layers_dev = [self._upload_band(x) for x in layers_host]

            def partials(layer_dev):
                return spatial_cross_bilateral_layers_fast(
                    target_dev, layer_dev, lp, self.mesh, levels, downsample
                )
        else:
            with report.transfer():
                target_dev = self._upload(target_host)
            layers_dev = []
            if layers_host:
                with report.transfer():
                    layers_dev = self._upload(np.stack(layers_host))
                    self._fence()

            def partials(layer_dev):
                return fast.cross_bilateral_layers_fast(
                    target_dev, layer_dev, lp, levels, downsample
                )

        def run():
            h, w, _ = target_dev.shape
            wc = torch.zeros((h, w, 4), dtype=torch.float32, device=self.device)
            nw = torch.zeros((h, w, 3), dtype=torch.float32, device=self.device)
            for layer_dev in layers_dev:
                pwc, pnw = partials(layer_dev)
                wc += pwc
                nw += pnw
            return fast.normalize_layers_fast(wc, nw)

        return self._save(cfg, self._execute(run, report), report, rows)

    def _dump_weights(self, wc: torch.Tensor, nw: torch.Tensor) -> None:
        wc = wc.cpu().numpy()
        nw = nw.cpu().numpy()
        h, w = nw.shape
        for y in range(h // 4, h * 3 // 4, 50):
            for x in range(0, w, 50):
                c = wc[y, x]
                print(
                    f"({x}; {y}) => | {c[0]:.6g} {c[1]:.6g} {c[2]:.6g} | "
                    f"{nw[y, x]:.6g}"
                )

    def _run_layers(self, target_dev, ds, report, layout, layers_params):
        """Per-layer accumulate then normalize (src/main.cpp:1608-1624,
        1649-1652). Layers are always LDR (src/main.cpp:1396)."""
        model = LayerGuidedDenoiser(layers_params, layout=layout, tiling=self.tiling)
        layers_host = [self._load(p) for p in ds.layers]
        if not layers_host:
            # No layers: the accumulators stay zero and normalize paints the
            # magenta sentinel everywhere, like the reference would.
            h, w, _ = target_dev.shape
            with report.execute():
                out = stencils.normalize(
                    torch.zeros((h, w, 4), dtype=torch.float32, device=self.device),
                    torch.zeros((h, w), dtype=torch.float32, device=self.device),
                )
                self._fence()
            return out
        with report.transfer():
            layers_dev = self._upload(np.stack(layers_host))
        return self._execute(lambda: model(target_dev, layers_dev), report)

    def _run_multiframe(self, target_dev, ds, report, layout, cfg):
        """Temporal NLM over neighbour frames (src/main.cpp:1554-1624).

        overlap=True streams frames through the double-buffered prefetcher
        (the copy/compute overlap); otherwise frames upload then compute one
        by one like the reference's non-overlapped loop, or as frame-batched
        launches with batch_frames. Returns the output and the overlap
        loop's frame loader (None for the other loops)."""
        model = TemporalNlmDenoiser(self.nlm_params, layout=layout, tiling=self.nlm_tiling)
        # Per-frame uniform-alpha fast path (non-overlap loops, where the
        # host frame is at hand): each frame's partial is exact on its own,
        # so mixing the two kernels' partials stays exact. CLAMP required.
        fast_ok = (
            self.nlm_params.border == BorderPolicy.CLAMP
            and not self.nlm_params.uniform_alpha
        )
        model_fast = (
            TemporalNlmDenoiser(
                dataclasses.replace(self.nlm_params, uniform_alpha=True),
                layout=layout,
                tiling=self.nlm_tiling,
            )
            if fast_ok
            else model
        )

        def pick_model(frame_host):
            a = frame_host[..., 3]
            return model_fast if fast_ok and a.min() == a.max() else model

        if self.warmup and not (self.batch_frames and not cfg.overlap):
            wmodel = model if cfg.overlap else pick_model(target_dev.cpu().numpy())
            warm = wmodel.accumulate_one(target_dev, target_dev, None)
            warm = wmodel.accumulate_one(target_dev, target_dev, warm)  # +carry path
            wmodel.finalize(warm)
            self._fence()
        carry = None
        bar = ProgressBar(label="frames")
        if cfg.overlap:
            # Reference parity: the overlap loop dispatches NLM on the
            # previous texture while copying frame ii (src/main.cpp:1554-
            # 1572), so the last uploaded frame is never filtered.
            consumed = ds.frames[:-1] if len(ds.frames) > 1 else ds.frames
            frames = FramePrefetcher(
                consumed,
                lambda p: imageio.load(p)[0],
                self.device,
                depth=2,
                report=report,
                native_paths=True,
            )
            with report.execute():
                for i, frame_dev in enumerate(frames):
                    carry = model.accumulate_one(target_dev, frame_dev, carry)
                    bar.progress(i + 1, len(frames))
                bar.finish()
                if self.debug_weights:
                    self._dump_weights(carry[0], carry[1])
                out = model.finalize(carry)
                self._fence()
            return out, frames.loader
        elif self.batch_frames:
            # Stacked upload + frame-batched launch, chunked at ~1.5 GB of
            # stacked frames to bound peak host and device memory; chunk
            # partials add exactly.
            n = len(ds.frames)
            h_t, w_t, _ = target_dev.shape
            frame_bytes = h_t * w_t * 4 * 4
            chunk = max(1, min(n, int(1.5e9 // max(1, frame_bytes))))
            total_wc = total_nw = None
            warmed: set = set()
            for start_i in range(0, n, chunk):
                frames_host = [self._load(p) for p in ds.frames[start_i : start_i + chunk]]
                bar.progress(min(start_i + chunk, n), n)
                all_uniform = fast_ok and all(
                    f[..., 3].min() == f[..., 3].max() for f in frames_host
                )
                bmodel = model_fast if all_uniform else model
                with report.transfer():
                    frames_dev = self._upload(np.stack(frames_host))
                    self._fence()
                # Warm every distinct (shape, kernel variant) this loop runs,
                # so no first use lands inside the timed block below.
                warm_key = (tuple(frames_dev.shape), bmodel is model_fast)
                if self.warmup and warm_key not in warmed:
                    bmodel.finalize(bmodel.accumulate(target_dev, frames_dev))
                    self._fence()
                    warmed.add(warm_key)
                with report.execute():
                    wc, nw = bmodel.accumulate(target_dev, frames_dev)
                    if total_wc is None:
                        total_wc, total_nw = wc, nw
                    else:
                        total_wc = total_wc + wc
                        total_nw = total_nw + nw
                    self._fence()
            bar.finish()
            with report.execute():
                if self.debug_weights:
                    self._dump_weights(total_wc, total_nw)
                out = model.finalize((total_wc, total_nw))
                self._fence()
        else:
            for i, p in enumerate(ds.frames):
                host = self._load(p)
                fmodel = pick_model(host)
                with report.transfer():
                    frame_dev = self._upload(host)
                    self._fence()
                with report.execute():
                    carry = fmodel.accumulate_one(target_dev, frame_dev, carry)
                    self._fence()
                bar.progress(i + 1, len(ds.frames))
            bar.finish()
            if self.debug_weights:
                self._dump_weights(carry[0], carry[1])
            with report.execute():
                out = model.finalize(carry)
                self._fence()
        return out, None

    # -- CPU-path equivalent ------------------------------------------------

    def run_cpu(self, num_threads: int = 1) -> tuple[str, float]:
        """The CPU bilateral reference (RunOnCPU, src/main.cpp:1732-1921):
        window 10, sigma_s 10, sigma_c 0.2, blue-channel bug, zeroed border,
        output-cpu.{png,exr}. Runs the native OpenMP oracle on num_threads
        threads; on a CPU device without a native library, the NumPy oracle
        (one thread, whatever num_threads says), and on a CUDA device never:
        there the library was built with the Session. A host run by
        definition: it touches no device, whatever `device` is. Returns the
        output path and the seconds of load, filter and save."""
        timer = Timer()
        img, is_hdr = imageio.load(self.target)
        params = CpuBilateralParams()
        try:
            out = native.cpu_bilateral(img, params, num_threads)
        except (ImportError, OSError):
            if self.device.type == "cuda":
                raise
            out = reference.cpu_bilateral_reference(img, params)
        name = "output-cpu" + (".exr" if is_hdr else ".png")
        path = os.path.join(self.output_dir, name)
        imageio.save(path, out, hdr=is_hdr, clamp=self.clamp_output)
        return path, timer.elapsed()
