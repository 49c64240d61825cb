"""Matrix products in f32 keep full precision: every dot_general the
numerical paths trace asks for HIGHEST, so a GPU does not round its
operands to TF32 (about three decimal digits)."""

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

from libstacker_tpu import constants
from libstacker_tpu.ops import ecc as ecc_ops, phasecorr, ransac
from libstacker_tpu.params import MotionType

HIGHEST = jax.lax.Precision.HIGHEST


def _dot_precisions(closed):
    """Precision of every dot_general in a (closed) jaxpr, sub-jaxprs
    of loops, conds and calls included."""
    out = []

    def visit(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if isinstance(sub, jax.extend.core.ClosedJaxpr):
                        visit(sub.jaxpr)
                    elif isinstance(sub, jax.extend.core.Jaxpr):
                        visit(sub)

    visit(closed.jaxpr)
    return out


def _assert_all_highest(closed):
    precs = _dot_precisions(closed)
    assert precs, "no matrix product traced"
    for p in precs:
        assert p is not None and all(q == HIGHEST for q in p), precs


@pytest.mark.parametrize("motion", [MotionType.Affine,
                                    MotionType.Homography])
@pytest.mark.parametrize("kernel", [False, True])
def test_ecc_iteration_products_are_highest(motion, kernel):
    """The Gauss-Newton update's projections and solves (and, on the XLA
    path, the Hessian and Jacobian projections) run in full f32."""
    h, w = 32, 48
    t = jnp.zeros((2, h, w), jnp.float32)
    carry = ecc_ops._ecc_prepare_templates_jit(t, 5, motion)[1]

    def f(tf, img):
        return ecc_ops._ecc_loop_batched(
            tf, img, img, img, carry, motion, 10, 1e-4, None, kernel,
        )

    _assert_all_highest(jax.make_jaxpr(f)(t, t[0]))


@pytest.mark.parametrize("method", [constants.RANSAC, 0])
def test_ransac_products_are_highest(method):
    """Denormalisation of the hypotheses and of the least-squares
    homography, and the DLT normal equations, run in full f32."""
    pts = jnp.zeros((16, 2), jnp.float32)
    valid = jnp.ones((16,), bool)

    def f(src, dst):
        return ransac.find_homography(
            src, dst, valid, jax.random.PRNGKey(0), method=method,
            max_iters=8,
        ).h

    _assert_all_highest(jax.make_jaxpr(f)(pts, pts))


def test_phase_init_has_no_reduced_precision_product():
    """The phase-correlation warm start is FFT-based: whatever products
    it traces are full f32."""
    t = jnp.zeros((2, 32, 48), jnp.float32)
    closed = jax.make_jaxpr(
        lambda a, b: phasecorr.phase_init_warps(a, b, MotionType.Affine)
    )(t, t[0])
    for p in _dot_precisions(closed):
        assert p is not None and all(q == HIGHEST for q in p)


def test_spatial_warp_composition_is_highest():
    from libstacker_tpu.parallel import mesh as pmesh

    m = jnp.asarray(np.eye(3, dtype=np.float32))
    _assert_all_highest(jax.make_jaxpr(pmesh._matmul3)(m, m, m))
