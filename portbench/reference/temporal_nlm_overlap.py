"""Plain temporal non-local means over the window of the upstream
reference's overlap loop, its sixth GPU configuration
(`RunOnGPU(true, true, true, true, false)`, src/main.cpp:1973, README.md:43-51
of Reefufui/image_denoising_filter).

The window, as the upstream source builds it: the frame list is the target,
then every frame of its shot in sorted order (src/main.cpp:1381-1390),
capped at framesToUse = 10 entries (:1341). The overlap loop (:1539-1573,
RecordCommandsOfOverlappingNLM :889-989) filters frame i while it copies
frame i + 1, so the list's last entry is uploaded but never filtered. A
target among the first framesToUse - 2 frames of its shot is therefore
filtered twice, once as the list's head and once in its place.

The output is reference/temporal_nlm.py's over that window, in float32.
Plain torch, on whatever device its inputs are, and nothing of the program
under test: the rule is written here, not taken from the program's
dataset discovery.
"""

from __future__ import annotations

import torch

from . import temporal_nlm

FRAMES_TO_USE = 10  # framesToUse, src/main.cpp:1341


def window(k: int, shot_frames: int, max_frames: int = FRAMES_TO_USE) -> list[int]:
    """The shot's indices of the frames the overlap loop filters for the
    target at index k of a shot of shot_frames frames, in order."""
    listed = ([k] + list(range(shot_frames)))[:max_frames]
    return listed[:-1] if len(listed) > 1 else listed


def temporal_nlm_overlap(shot: torch.Tensor, k: int, params: dict,
                         max_frames: int = FRAMES_TO_USE) -> torch.Tensor:
    """The denoised (H, W, 4) target k of shot (N, H, W, 4) over its overlap
    window. params as reference/temporal_nlm.py takes them. The filter has
    no matrix product; TF32 is turned off all the same, as for every
    reference of the benchmark."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return temporal_nlm.temporal_nlm(shot[k], shot[window(k, shot.shape[0], max_frames)],
                                     params)
