"""Host-side utilities of the port: image load and save (`imageio`, with the
`png` and `exr` codecs and the optional `native` library), dataset discovery
(`dataset`), the timing report (`timing`), the progress bar (`progress`) and
the synthetic render content (`content`: `synthetic_render` on the host,
`synthetic_render_device` with torch ops on a device).

Copies of the JAX package's modules of the same names, which import no JAX:
the port keeps its own, so that it imports nothing of that package.
`content.synthetic_render_device` is the port's own twin of the host
generator; the JAX package's `synthetic_render_expr` is not ported.
"""
