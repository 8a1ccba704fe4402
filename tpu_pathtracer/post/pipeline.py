"""The full post pipeline: denoise -> upscale -> tonemap (the reference's
fullscreen pass, src/passes/fullscreen.ts + fullscreen.wgsl:110-132)."""

from __future__ import annotations

from ..config import PostConfig, Tonemap
from .denoise import smart_denoise
from .resize import bilinear_resize
from .tonemap import tonemap


def postprocess(img, config: PostConfig, display_height: int | None = None, display_width: int | None = None):
    """img: (h, w, 3) linear radiance -> display-ready (H, W, 3) in [0,1]-ish.

    Order matches the reference fragment shader: upscale first (uv *
    scalingFactor, fullscreen.wgsl:47), then denoise at DISPLAY resolution
    with 1-display-pixel tap spacing (fullscreen.wgsl:117-119), then
    tonemap.  At scaling factor 1 the order is irrelevant; below 1 the
    denoiser must see the bilinear-upscaled signal (the reference's taps
    step one full-res texel, i.e. sub-render-texel).  Edge semantics differ
    deliberately: our taps wrap the display image, the reference's repeat
    sampler wraps its full-canvas texture and so bleeds the ZERO texels
    outside the rendered subregion into the border at scaling < 1."""
    out = img
    if display_height is not None and display_width is not None:
        out = bilinear_resize(out, display_height, display_width)
    if config.denoise:
        out = smart_denoise(
            out, sigma=config.denoise_sigma, k_sigma=config.denoise_k_sigma,
            threshold=config.denoise_threshold,
        )
    out = tonemap(out, config.tonemap)
    return out
