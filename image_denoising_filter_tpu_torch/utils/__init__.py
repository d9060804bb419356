"""Host-side image and dataset utilities, shared with image_denoising_filter_tpu.

Those modules import no JAX; they are re-exported here so that users of the
port import from the port alone.
"""

from image_denoising_filter_tpu.utils import dataset, imageio  # noqa: F401
