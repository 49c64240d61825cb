"""Parameter dataclasses mirroring the reference's config structs.

Reference:
- ``KeyPointMatchParameters`` at ``src/lib.rs:49-73`` with its ``Default``
  impl at ``src/utils.rs:250-261`` (RANSAC, 3.0, 0.75, 0.8,
  BORDER_CONSTANT, zero scalar).
- ``EccMatchParameters`` / ``MotionType`` at ``src/lib.rs:604-623``; the
  ``From<EccMatchParameters> for TermCriteria`` conversion at
  ``src/utils.rs:146-171`` sets the COUNT / EPS bits only for fields the
  user provided.  OpenCV's ``findTransformECC`` then resolves missing
  bits to its internal defaults (200 iterations, eps disabled), which
  :func:`EccMatchParameters.resolve_criteria` reproduces.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

from . import constants
from .errors import InvalidParamsError


def _validate_stacking(
    stacking: str, kappa: float, iters: int, output_scale: int = 1
) -> None:
    """Shared validation of the beyond-reference stacking fields."""
    if stacking not in ("mean", "sigma_clip"):
        raise InvalidParamsError(
            f"stacking must be 'mean' or 'sigma_clip', got {stacking!r}"
        )
    if stacking == "sigma_clip":
        if not kappa > 0.0:
            raise InvalidParamsError(
                f"sigma_kappa must be > 0, got {kappa}"
            )
        if iters < 1:
            raise InvalidParamsError(
                f"sigma_iters must be >= 1, got {iters}"
            )
    if output_scale not in (1, 2, 3, 4):
        raise InvalidParamsError(
            f"output_scale must be 1, 2, 3 or 4, got {output_scale}"
        )
    if output_scale > 1 and stacking != "mean":
        raise InvalidParamsError(
            "output_scale > 1 (super-resolution) cannot be combined "
            "with stacking='sigma_clip' yet"
        )


class MotionType(enum.IntEnum):
    """Geometric motion models for the ECC path (ref src/lib.rs:604-609).

    Values equal OpenCV's ``MOTION_*`` constants.
    """

    Translation = constants.MOTION_TRANSLATION
    Euclidean = constants.MOTION_EUCLIDEAN
    Affine = constants.MOTION_AFFINE
    Homography = constants.MOTION_HOMOGRAPHY

    @property
    def num_params(self) -> int:
        """Degrees of freedom of the warp parameterisation."""
        return {
            MotionType.Translation: 2,
            MotionType.Euclidean: 3,
            MotionType.Affine: 6,
            MotionType.Homography: 8,
        }[self]


@dataclasses.dataclass(frozen=True)
class KeyPointMatchParameters:
    """Config for the ORB keypoint-match path (ref src/lib.rs:49-73).

    Defaults match the reference's ``Default`` impl (src/utils.rs:250-261).
    """

    #: Homography method: constants.RANSAC, constants.LMEDS, or 0
    #: (plain least squares over all matches — the reference's field is
    #: a raw i32 handed to findHomography, src/lib.rs:267-276).
    method: int = constants.RANSAC
    #: RANSAC reprojection threshold for find_homography.
    ransac_reproj_threshold: float = 3.0
    #: Fraction of best (sorted-by-distance) matches kept after the ratio test.
    match_keep_ratio: float = 0.75
    #: Lowe's ratio-test threshold applied to the 2-NN matches.
    match_ratio: float = 0.8
    #: Border mode used when warping (constants.BORDER_*).
    border_mode: int = constants.BORDER_CONSTANT
    #: Border value used when warping with BORDER_CONSTANT.
    border_value: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    #: Max RANSAC hypotheses — OpenCV findHomography's ``maxIters``
    #: (the reference's call at src/lib.rs:267-276 uses the default 2000).
    max_iters: int = 2000
    #: RANSAC confidence for adaptive early exit — OpenCV's 0.995 default.
    confidence: float = 0.995
    #: Stacking estimator: "mean" (reference semantics, src/lib.rs:
    #: 306-343) or "sigma_clip" — per-pixel kappa-sigma outlier
    #: rejection (ops/stack.py; beyond-reference capability, requires
    #: BORDER_CONSTANT/TRANSPARENT and re-warps the burst 1+sigma_iters
    #: times).
    stacking: str = "mean"
    #: Clip threshold in standard deviations for stacking="sigma_clip".
    sigma_kappa: float = 2.5
    #: Number of clipping passes for stacking="sigma_clip".
    sigma_iters: int = 1
    #: Super-resolution factor: stack onto an output grid this many
    #: times finer than the input (shift-and-add nearest-sample
    #: deposit, ops/stack.super_res_stack; beyond-reference).  1 =
    #: reference semantics.
    output_scale: int = 1

    def validate(self) -> None:
        if self.method not in (0, constants.RANSAC, constants.LMEDS):
            raise InvalidParamsError(
                f"method must be RANSAC ({constants.RANSAC}), "
                f"LMEDS ({constants.LMEDS}) or 0 (least squares), "
                f"got {self.method}"
            )
        if not (0.0 < self.match_ratio):
            raise InvalidParamsError(f"match_ratio must be > 0, got {self.match_ratio}")
        if not (0.0 < self.match_keep_ratio <= 1.0):
            raise InvalidParamsError(
                f"match_keep_ratio must be in (0, 1], got {self.match_keep_ratio}"
            )
        if self.max_iters < 1:
            raise InvalidParamsError(
                f"max_iters must be >= 1, got {self.max_iters}"
            )
        if not (0.0 < self.confidence < 1.0):
            raise InvalidParamsError(
                f"confidence must be in (0, 1), got {self.confidence}"
            )
        _validate_stacking(self.stacking, self.sigma_kappa, self.sigma_iters,
                           getattr(self, "output_scale", 1))


@dataclasses.dataclass(frozen=True)
class EccMatchParameters:
    """Config for the ECC path (ref src/lib.rs:611-623).

    The reference deliberately provides no ``Default`` impl
    (src/lib.rs:621-622 todo note); we mirror that by requiring
    ``motion_type`` explicitly.
    """

    motion_type: MotionType
    #: Maximum ECC iterations; ``None`` leaves the COUNT bit unset, which
    #: OpenCV's findTransformECC resolves to 200 iterations.
    max_count: Optional[int] = None
    #: Convergence epsilon on the correlation coefficient; ``None`` leaves
    #: the EPS bit unset (no early termination; eps resolves to -1).
    epsilon: Optional[float] = None
    #: Gaussian pre-filter kernel size (odd, >= 1).
    gauss_filt_size: int = 5
    #: Warm-start the solve from a batched phase-correlation translation
    #: estimate (ops/phasecorr.py) instead of the identity.  Converges
    #: to the same warp in fewer Gauss-Newton iterations for bursts with
    #: real pixel-scale shifts.  A capability beyond the reference
    #: (which always starts from the identity, src/lib.rs:769-777);
    #: set False for strict OpenCV iteration-count parity.
    phase_init: bool = True
    #: Also recover each frame's rotation (and, for Affine/Homography,
    #: uniform scale) in the warm start via log-polar magnitude
    #: correlation (Reddy-Chatterji) before the translation pass.
    #: Starts the solve inside the convergence basin for bursts with
    #: real rotation; low-confidence estimates are gated back to the
    #: translation-only init.  Beyond-reference capability; off by
    #: default (adds one FFT + log-polar pass per burst).
    phase_init_rotation: bool = False
    #: Coarse-to-fine octaves: > 0 first solves each warp on
    #: 2^levels..2x INTER_AREA-downscaled greys and refines at full
    #: resolution from that warm start — the same converged warp (the
    #: full-resolution Gauss-Newton iterations run to the same
    #: TermCriteria), a fraction of the full-resolution iterations.
    #: Composes with ``phase_init`` (the phase estimate seeds the
    #: coarsest octave).  Beyond the reference, whose findTransformECC
    #: calls always iterate at the solve resolution
    #: (src/lib.rs:769-777); set 0 for strict OpenCV iteration parity.
    coarse_levels: int = 0
    #: Solver formulation: 'forward' = OpenCV's forward-additive ECC
    #: (bit-faithful quantities); 'lazy' = forward linearisation with
    #: the Jacobian Gram computed once per frame and carried (30 vs 66
    #: per-iteration kernel reductions for homography, same fixed
    #: point; beyond-reference, fused GPU kernel only — the XLA path
    #: always runs the exact forward formulation).
    solver: str = "forward"
    #: Stacking estimator: "mean" (reference semantics, src/lib.rs:
    #: 807-843) or "sigma_clip" — per-pixel kappa-sigma outlier
    #: rejection (ops/stack.py; beyond-reference capability, re-warps
    #: the burst 1+sigma_iters times).
    stacking: str = "mean"
    #: Clip threshold in standard deviations for stacking="sigma_clip".
    sigma_kappa: float = 2.5
    #: Number of clipping passes for stacking="sigma_clip".
    sigma_iters: int = 1
    #: Super-resolution factor: stack onto an output grid this many
    #: times finer than the input (shift-and-add nearest-sample
    #: deposit, ops/stack.super_res_stack; beyond-reference).  1 =
    #: reference semantics.
    output_scale: int = 1

    def resolve_criteria(self) -> Tuple[int, float]:
        """Resolve (num_iterations, termination_eps) the way OpenCV's
        findTransformECC interprets the TermCriteria built at
        src/utils.rs:159-170: COUNT bit set -> max_count else 200;
        EPS bit set -> epsilon else -1 (never converge early)."""
        num_iters = self.max_count if self.max_count is not None else 200
        eps = self.epsilon if self.epsilon is not None else -1.0
        return int(num_iters), float(eps)

    def validate(self) -> None:
        if not isinstance(self.motion_type, MotionType):
            raise InvalidParamsError(
                f"motion_type must be a MotionType, got {self.motion_type!r}"
            )
        if self.gauss_filt_size < 1 or self.gauss_filt_size % 2 == 0:
            raise InvalidParamsError(
                f"gauss_filt_size must be odd and >= 1, got {self.gauss_filt_size}"
            )
        if self.max_count is not None and self.max_count < 1:
            raise InvalidParamsError(f"max_count must be >= 1, got {self.max_count}")
        if not isinstance(self.coarse_levels, int) or not (
            0 <= self.coarse_levels <= 5
        ):
            raise InvalidParamsError(
                f"coarse_levels must be an int in 0..5, got "
                f"{self.coarse_levels!r}"
            )
        if self.solver not in ("forward", "lazy"):
            raise InvalidParamsError(
                f"solver must be 'forward' or 'lazy', got {self.solver!r}"
                + (" (the inverse-compositional solver was removed)"
                   if self.solver == "ic" else "")
            )
        _validate_stacking(self.stacking, self.sigma_kappa, self.sigma_iters,
                           getattr(self, "output_scale", 1))
