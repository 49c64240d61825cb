"""libstacker_tpu — an image alignment and stacking framework in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
eadf/libstacker.rs (see SURVEY.md): burst frames live as one batched
HBM-resident tensor; alignment (ORB keypoint / ECC) runs as batched
device programs; frame-level parallelism maps onto a ``jax.sharding``
mesh instead of a thread pool.
"""

from . import constants  # noqa: F401
from .errors import (  # noqa: F401
    InvalidParamsError,
    NotEnoughFilesError,
    ProcessingError,
    StackerError,
    StackerIoError,
)
from .params import (  # noqa: F401
    EccMatchParameters,
    KeyPointMatchParameters,
    MotionType,
)
from .models.ecc import ecc_match, ecc_match_arrays, ecc_match_stream  # noqa: F401
from .models.keypoint import (  # noqa: F401
    keypoint_match,
    keypoint_match_arrays,
    keypoint_match_stream,
)
from .utils.io import (  # noqa: F401
    imread,
    imread_gray,
    imread_unchanged,
    load_frames,
    save_image,
)
from .ops.sharpness import (  # noqa: F401
    sharpness_all,
    sharpness_modified_laplacian,
    sharpness_normalized_gray_level_variance,
    sharpness_tenengrad,
    sharpness_variance_of_laplacian,
)

__version__ = "0.1.0"
