from . import (  # noqa: F401
    color,
    ecc,
    fast,
    filters,
    matcher,
    orb,
    ransac,
    resize,
    sharpness,
    warp,
    warp_batch,
)
