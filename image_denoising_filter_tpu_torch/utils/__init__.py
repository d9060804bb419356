"""Host-side utilities of the port: image load and save (`imageio`, with the
`png` and `exr` codecs and the optional `native` library), dataset discovery
(`dataset`), the timing report (`timing`) and the progress bar (`progress`).

Copies of the JAX package's modules of the same names, which import no JAX:
the port keeps its own, so that it imports nothing of that package.
"""
