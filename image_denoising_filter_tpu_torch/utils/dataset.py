"""Dataset discovery: neighbor animation frames and G-buffer layers.

Reproduces the reference's directory scan (src/main.cpp:1341-1397):

  * frame ID = the 4 characters before the first '.' in the target path string
    (src/main.cpp:1347 -- note: the *first* dot of the full path, a quirk we
    keep, guarded for short paths);
  * files in the target's parent directory with the same extension are neighbor
    frames (used when multiframe);
  * files inside immediate subdirectories whose path contains the frame ID are
    G-buffer layers (the "RenderElements" convention);
  * the target image is always loaded first (src/main.cpp:1381-1390);
  * the 10-frame cap (framesToUse, src/main.cpp:1341) applies only to the
    copy/compute-overlap loop (src/main.cpp:1554); the non-overlapped
    multiframe loop iterates every loaded frame (src/main.cpp:1574-1607), so
    `max_frames=None` means uncapped.

Deviation (documented): std::filesystem::directory_iterator order is
unspecified; we sort lexicographically for determinism.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Dataset:
    target: str
    frames: tuple[str, ...]  # neighbor frames, target first
    layers: tuple[str, ...]
    is_hdr: bool


def frame_id(path: str) -> str:
    """The 4-char frame ID before the first '.' of the path (src/main.cpp:1347)."""
    dot = path.find(".")
    if dot < 4:
        return os.path.splitext(os.path.basename(path))[0][-4:]
    return path[dot - 4 : dot]


def discover(
    target: str,
    multiframe: bool = False,
    use_layers: bool = False,
    max_frames: int | None = 10,
) -> Dataset:
    parent = os.path.dirname(target) or "."
    ext = os.path.splitext(target)[1]
    fid = frame_id(target)
    is_hdr = ext == ".exr"

    frames: list[str] = [target]  # target always first (src/main.cpp:1381-1390)
    layers: list[str] = []
    for entry in sorted(os.listdir(parent)):
        p = os.path.join(parent, entry)
        if os.path.isdir(p):
            if use_layers:
                for sub in sorted(os.listdir(p)):
                    sp = os.path.join(p, sub)
                    if fid in sp and os.path.isfile(sp):
                        layers.append(sp)
        elif multiframe and os.path.splitext(entry)[1] == ext:
            frames.append(p)

    if multiframe and max_frames is not None:
        frames = frames[:max_frames]
    return Dataset(target=target, frames=tuple(frames), layers=tuple(layers), is_hdr=is_hdr)
