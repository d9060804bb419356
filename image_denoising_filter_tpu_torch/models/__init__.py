from .denoiser import (  # noqa: F401
    LINEAR,
    TILED,
    BilateralDenoiser,
    LayerGuidedDenoiser,
    NlmDenoiser,
    TemporalNlmDenoiser,
    carry_from_numpy,
)
