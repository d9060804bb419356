"""Host ms a frame spends in the files feed's Session(...) + Session.run
outside every idf.session.* span: the harness's clock around each frame
(reading.session["host_ns"]) less the sum of the Session's phases, which are
disjoint (image_denoising_filter_tpu_torch/utils/timing.py). What no span
explains: dataset discovery, the alpha checks, Python between the phases.
None where no Session span ran, as in a program without spans."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    phases = [ns for name, (ns, n) in getattr(timing, "totals", {}).items()
              if name.startswith("idf.session.") and n]
    if not phases or not r.session or not r.frames:
        return None
    return (r.session["host_ns"] - sum(phases)) / r.frames / 1e6
