"""Multi-device sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §2c: DP-over-frames with psum; §5: spatial halo exchange)."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libstacker_tpu.ops import color, sharpness
from libstacker_tpu.params import MotionType
from libstacker_tpu.parallel import mesh as pmesh


@pytest.fixture(scope="module")
def burst(rng):
    h, w = 64, 80
    base = cv2.GaussianBlur(
        (rng.random((h * 2, w * 2)) * 255).astype(np.uint8), (0, 0), 3.0
    )
    frames = []
    for i in range(8):
        dx, dy = rng.uniform(-2, 2, 2)
        m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(
            base, m, (w * 2, h * 2), flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP
        )[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        frames.append(np.stack([cur] * 3, -1))
    return np.stack(frames)


def test_mesh_requires_8_devices():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"


def test_sharded_ecc_stack_matches_unsharded(burst):
    m = pmesh.make_mesh(data=4, spatial=2)
    ref_grey = color.rgb_to_gray_u8(jnp.asarray(burst[0])).astype(jnp.float32)
    frames_j = pmesh.shard_frames(jnp.asarray(burst), m)
    stacked, ok = pmesh.ecc_stack_step(
        frames_j, ref_grey, m,
        motion_type=MotionType.Translation, num_iters=10, eps=1e-4,
    )
    assert np.asarray(ok).all()

    # unsharded oracle: same program on one device
    m1 = pmesh.make_mesh(jax.devices()[:1], data=1, spatial=1)
    stacked1, ok1 = pmesh.ecc_stack_step(
        jnp.asarray(burst), ref_grey, m1,
        motion_type=MotionType.Translation, num_iters=10, eps=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(stacked), np.asarray(stacked1), atol=1e-5
    )


def test_spatial_sharpness_matches_dense(burst):
    m = pmesh.make_mesh(data=4, spatial=2)
    greys = color.rgb_to_gray_u8(jnp.asarray(burst)).astype(jnp.float32)
    got = np.asarray(pmesh.sharpness_teng_spatial(greys, m))
    expected = np.asarray(sharpness.sharpness_tenengrad(greys, 3))
    np.testing.assert_allclose(got, expected, rtol=1e-5)


def test_warp_rows_sharded_matches_dense(rng):
    """Row-sharded warp with ppermute halo exchange equals the dense
    single-device warp for in-halo-domain motions (small rotation +
    shift), including the global top/bottom border behavior."""
    from libstacker_tpu.ops import warp

    h, w = 256, 320
    img = cv2.GaussianBlur(
        (rng.random((h, w)) * 255).astype(np.float32), (0, 0), 2.0
    )
    rot = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), 1.0, 1.002)
    rot[0, 2] += 3.5
    rot[1, 2] -= 12.0  # pushes rows across shard boundaries
    m3 = np.vstack([rot, [0, 0, 1]]).astype(np.float32)

    dense = np.asarray(
        warp.warp_perspective(jnp.asarray(img), jnp.asarray(m3), (h, w))
    )
    m = pmesh.make_mesh(jax.devices(), data=2, spatial=4)
    img_sharded = jax.device_put(
        jnp.asarray(img),
        jax.sharding.NamedSharding(m, jax.sharding.PartitionSpec("spatial")),
    )
    with m:
        got = np.asarray(
            pmesh.warp_rows_sharded(img_sharded, jnp.asarray(m3), m, halo=32)
        )
    diff = np.abs(got - dense)
    # f32 matrix-composition rounding can flip rare 1/32-bin taps
    assert (diff > 1e-4).mean() < 1e-3, (diff > 1e-4).mean()
    assert diff.max() < 3.0


def test_spatial_end_to_end_matches_dense():
    """ecc_stack_step_spatial (rows sharded on 'spatial' for the WHOLE
    pipeline: grey, down-scale, solve, halo-exchange warp, stack)
    matches the dense single-device scale-down pipeline AND the
    known-shift ground truth (r2 VERDICT item 8).  Translation motion:
    the small solve grid leaves homography's 8 dof under-constrained on
    synthetic noise (BOTH paths drift identically on such data — not a
    sharding property)."""
    from libstacker_tpu.models.ecc import ecc_match_arrays
    from libstacker_tpu.params import EccMatchParameters

    rng = np.random.default_rng(48)  # local: keep shared stream stable
    h, w = 128, 96
    base = cv2.GaussianBlur(
        (rng.random((h * 2, w * 2)) * 255).astype(np.uint8), (0, 0), 1.2
    )
    frames, shifts = [], []
    for i in range(5):
        if i == 0:
            cur = base[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
            shifts.append((0.0, 0.0))
        else:
            dx, dy = rng.uniform(-2, 2, 2)
            shifts.append((dx, dy))
            mm = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
            cur = cv2.warpAffine(
                base, mm, (w * 2, h * 2),
                flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
            )[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        frames.append(np.stack([cur] * 3, -1))
    frames = np.stack(frames)
    acc = frames[0].astype(np.float32) / 255.0
    for i in range(1, 5):
        mm = np.array(
            [[1, 0, shifts[i][0]], [0, 1, shifts[i][1]]], np.float32
        )
        acc += cv2.warpAffine(
            frames[i].astype(np.float32) / 255.0, mm, (w, h)
        )
    truth = acc / 5.0

    params = EccMatchParameters(
        MotionType.Translation, max_count=50, epsilon=1e-5,
        gauss_filt_size=5,
    )
    scale_w = 64.0
    dense = ecc_match_arrays(frames, params, scale_down_width=scale_w)

    from libstacker_tpu.ops import resize as resize_ops

    scale_hw = resize_ops.scale_image_size(h, w, scale_w)
    m = pmesh.make_mesh(data=4, spatial=2)
    cur_j = jax.device_put(
        jnp.asarray(frames[1:]),
        jax.sharding.NamedSharding(
            m, jax.sharding.PartitionSpec("data", "spatial")
        ),
    )
    ref_j = jax.device_put(
        jnp.asarray(frames[0]),
        jax.sharding.NamedSharding(m, jax.sharding.PartitionSpec("spatial")),
    )
    with m:
        stacked_sum, ok = pmesh.ecc_stack_step_spatial(
            cur_j, ref_j, m, scale_hw,
            motion_type=MotionType.Translation, num_iters=50, eps=1e-5,
            gauss_filt_size=5, halo=32,
        )
    ok = np.asarray(ok)
    assert ok.all()
    got = np.asarray(stacked_sum) / (1 + ok.sum())
    mgn = 4
    d = np.abs(got - dense)[mgn:-mgn, mgn:-mgn]
    assert d.max() < 1e-5, d.max()
    dt = np.abs(got - truth)[mgn:-mgn, mgn:-mgn]
    assert np.quantile(dt, 0.99) < 0.005, np.quantile(dt, 0.99)


def test_sharded_flops_scale_with_data_axis(burst):
    """Compile-level scaling proof on the virtual mesh (wall-clock can't
    scale on one physical core): per-device FLOPs of the slab-driven
    solve (pmesh._ecc_slab_program) and per-device argument bytes of
    the stacking warp (pmesh._ecc_mean_stack_program, a scan over its
    local frames, whose loop body cost_analysis counts once) must be
    <= ~1/3 of their 1-device counterparts' (perfect would be 1/4 on
    data=4; the psum and the replicated operands add overhead)."""
    from libstacker_tpu.ops import ecc as ecc_ops

    n = burst.shape[0]
    ref_grey = color.rgb_to_gray_u8(jnp.asarray(burst[0])).astype(jnp.float32)
    image_f, gx, gy = ecc_ops._ecc_prepare_input_jit(ref_grey, 5)
    tmpl_f = jnp.broadcast_to(image_f[None], (n,) + image_f.shape)
    carry = pmesh._sharded_carry_init(
        n, MotionType.Translation, False, 1e-3, None, None
    )
    mats = np.tile(np.eye(3, dtype=np.float32)[None], (n, 1, 1))
    oks = np.ones(n, bool)

    def flops(compiled):
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        return float(ca["flops"])

    def cost(mesh):
        slab = pmesh._ecc_slab_program(
            mesh, MotionType.Translation, 4, 1e-3, 4, False, "forward",
            False, n,
        )
        solve = flops(
            slab.lower(tmpl_f, image_f, gx, gy, *carry).compile()
        )
        stackp = pmesh._ecc_mean_stack_program(mesh, False)
        stack = stackp.lower(
            jnp.asarray(burst), mats, oks
        ).compile().memory_analysis().argument_size_in_bytes
        return solve, stack

    m1 = pmesh.make_mesh(jax.devices()[:1], data=1, spatial=1)
    m4 = pmesh.make_mesh(jax.devices()[:4], data=4, spatial=1)
    s1, k1 = cost(m1)
    s4, k4 = cost(m4)
    # cost_analysis reports per-device flops for SPMD programs
    assert s4 <= s1 / 3.0, (s1, s4)
    assert k4 <= k1 / 3.0, (k1, k4)


def test_sharded_slab_program_is_bounded(burst):
    """r4 VERDICT item 8 pinned at the program level: ONE invocation of
    the sharded solve-slab program advances every lane by at most
    ``slab_iters`` Gauss-Newton iterations — the full ``num_iters``
    budget (e.g. max_count=2500) is spread over bounded device programs
    by the host drive loop, which reads convergence between them."""
    from libstacker_tpu.ops import ecc as ecc_ops

    n = burst.shape[0]
    mesh = pmesh.make_mesh(jax.devices()[:4], data=4, spatial=1)
    ref_grey = color.rgb_to_gray_u8(jnp.asarray(burst[0])).astype(
        jnp.float32
    )
    image_f, gx, gy = ecc_ops._ecc_prepare_input_jit(ref_grey, 5)
    prep = pmesh._ecc_prep_program(
        mesh, None, (), 5, False, MotionType.Translation
    )
    (tmpl_f,) = prep(jnp.asarray(burst), ref_grey)
    carry = pmesh._sharded_carry_init(
        n, MotionType.Translation, False, 1e-12, None, None
    )
    slab = pmesh._ecc_slab_program(
        mesh, MotionType.Translation, 2500, 1e-12, 3, False, "forward",
        False, n,
    )
    out = slab(tmpl_f, image_f, gx, gy, *carry)
    it = np.asarray(out[3])
    # the program is BOUNDED at slab_iters=3, never the 2500 budget;
    # eps=1e-12 keeps most lanes unconverged (frame 0's self-aligned
    # lane can hit exact convergence earlier)
    assert it.max() == 3 and (it == 3).sum() >= n - 1, it
    # a second invocation resumes where the first stopped
    out2 = slab(tmpl_f, image_f, gx, gy, *out[:-1])
    assert np.asarray(out2[3]).max() == 6


def test_sharded_keypoint_stack_matches_unsharded():
    """keypoint_stack_step (DP over frames, in-graph band gate) equals
    the same program on a 1-device mesh, and both keep every frame."""
    local = np.random.default_rng(51)
    h, w, pad = 160, 320, 16
    small = local.integers(
        0, 256, ((h + 2 * pad) // 8, (w + 2 * pad) // 8), np.uint8
    )
    base = cv2.resize(small, (w + 2 * pad, h + 2 * pad),
                      interpolation=cv2.INTER_NEAREST)
    base = cv2.GaussianBlur(base, (3, 3), 0.8)
    frames = []
    for i in range(8):
        if i == 0:
            cur = base
        else:
            dx, dy = local.uniform(-3, 3, 2)
            m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
            cur = cv2.warpAffine(
                base, m, (w + 2 * pad, h + 2 * pad),
                flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
            )
        frames.append(np.stack([cur[pad:pad + h, pad:pad + w]] * 3, -1))
    frames = np.stack(frames)

    from libstacker_tpu.models import keypoint as kp

    feats0 = kp.detect_features_chunked(jnp.asarray(frames[:1]))
    ref_feats = jax.tree.map(lambda x: x[0], feats0)

    m4 = pmesh.make_mesh(data=4, spatial=2)
    frames_j = pmesh.shard_frames(jnp.asarray(frames), m4)
    stacked, ok = pmesh.keypoint_stack_step(frames_j, ref_feats, m4, seed=3)
    assert np.asarray(ok).all()

    m1 = pmesh.make_mesh(jax.devices()[:1], data=1, spatial=1)
    stacked1, ok1 = pmesh.keypoint_stack_step(
        jnp.asarray(frames), ref_feats, m1, seed=3
    )
    assert np.asarray(ok1).all()
    # NOT bitwise: rBRIEF descriptors are not batch-size invariant (the
    # patch-blur matmul reassociates per batch shape, flipping ~1e-3 of
    # bits), so matches/H differ microscopically across shard layouts.
    # Bound the stacked-image effect instead (<~0.5 u8 LSB anywhere,
    # negligible on average).
    a, b = np.asarray(stacked), np.asarray(stacked1)
    d = np.abs(a - b)
    assert d.max() < 0.05, d.max()
    assert d.mean() < 1e-4, d.mean()


def test_warp_accum_under_shard_map():
    """warp_accumulate_rgb runs INSIDE shard_map: frames sharded over
    'data', per-shard frame-by-frame accumulation, psum; parity vs the
    dense unsharded masked sum (a dropped lane included)."""
    import cv2
    from functools import partial
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from libstacker_tpu.ops import warp_batch

    rng = np.random.default_rng(53)  # local rng (conftest stream note)
    frames = np.stack([
        cv2.GaussianBlur(
            rng.random((96, 136, 3)).astype(np.float32), (0, 0), 1.5
        )
        for _ in range(8)
    ])
    mats = np.stack([np.eye(3, dtype=np.float32)] * 8)
    for i in range(8):
        mats[i, 0, 2] = 1.25 * i - 4.0
        mats[i, 1, 2] = -0.5 * i + 2.0
    oks = np.ones(8, bool)
    oks[5] = False

    m = pmesh.make_mesh(data=4, spatial=2)

    @partial(
        shard_map, mesh=m,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=P(),
        check_vma=False,
    )
    def sharded_accum(f, mt, ok):
        part = warp_batch.warp_accumulate_rgb(f, mt, ok, perspective=False)
        return jax.lax.psum(part, "data")

    got = np.asarray(sharded_accum(
        jnp.asarray(frames), jnp.asarray(mats), jnp.asarray(oks)
    ))
    warped = warp_batch.warp_frames_batch(
        jnp.asarray(frames), jnp.asarray(mats), perspective=False,
    )
    want = np.asarray(jnp.sum(
        warped * jnp.asarray(oks, jnp.float32)[:, None, None, None], axis=0
    ))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sharded_sigma_clip_stack():
    """stacking='sigma_clip' in ecc_stack_step: per-pixel moments psum
    over 'data' — sharded == unsharded, and a single-frame streak is
    suppressed where the mean stack ghosts it."""
    import cv2

    # LOCAL rng: the shared module fixture draws from the session rng,
    # which makes its content depend on test ORDER (conftest note) —
    # and this test's ghost thresholds are content-sensitive
    lrng = np.random.default_rng(23)
    h, w = 64, 80
    base = cv2.GaussianBlur(
        (lrng.random((h * 2, w * 2)) * 255).astype(np.uint8), (0, 0), 3.0
    )
    frames = []
    for i in range(8):
        dx, dy = lrng.uniform(-2, 2, 2)
        mm = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(
            base, mm, (w * 2, h * 2),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        frames.append(np.stack([cur] * 3, -1))
    burst = np.stack(frames)

    dirty = np.asarray(burst).copy()
    streaked = dirty[5].copy()
    cv2.line(streaked, (8, 10), (70, 50), (255, 255, 255), 2)
    dirty[5] = streaked
    streak = np.zeros(dirty.shape[1:3], np.uint8)
    cv2.line(streak, (8, 10), (70, 50), 1, 2)
    streak = streak.astype(bool)

    m = pmesh.make_mesh(data=4, spatial=2)
    ref_grey = color.rgb_to_gray_u8(jnp.asarray(dirty[0])).astype(jnp.float32)
    kw = dict(motion_type=MotionType.Translation, num_iters=10, eps=1e-4,
              stacking="sigma_clip", sigma_kappa=2.5, sigma_iters=2)
    img, ok = pmesh.ecc_stack_step(
        pmesh.shard_frames(jnp.asarray(dirty), m), ref_grey, m, **kw
    )
    assert np.asarray(ok).all()

    m1 = pmesh.make_mesh(jax.devices()[:1], data=1, spatial=1)
    img1, _ = pmesh.ecc_stack_step(jnp.asarray(dirty), ref_grey, m1, **kw)
    # psum reordering perturbs mu/sigma by ~1e-7, which can FLIP clip
    # decisions for samples sitting exactly at the kappa boundary; each
    # flip moves that pixel by at most one sample's influence.  Parity
    # is therefore near-exact, not bit-exact (unlike the mean path).
    d = np.abs(np.asarray(img) - np.asarray(img1))
    assert (d > 1e-5).mean() < 2e-3, (d > 1e-5).mean()
    assert d.max() < 0.06, d.max()

    mean_sum, mok = pmesh.ecc_stack_step(
        pmesh.shard_frames(jnp.asarray(dirty), m), ref_grey, m,
        motion_type=MotionType.Translation, num_iters=10, eps=1e-4,
    )
    mean_img = np.asarray(mean_sum) / np.asarray(mok).sum()
    clean_sum, cok = pmesh.ecc_stack_step(
        pmesh.shard_frames(jnp.asarray(burst), m), ref_grey, m,
        motion_type=MotionType.Translation, num_iters=10, eps=1e-4,
    )
    clean_img = np.asarray(clean_sum) / np.asarray(cok).sum()
    # the solved warp composes frame 0's own shift, displacing the
    # streak a few px from its drawn position: assert on the max ghost
    # inside a dilated band (interior only — border rows differ too)
    band = cv2.dilate(streak.astype(np.uint8), np.ones((11, 11)))
    band = band.astype(bool)
    band[:6] = band[-6:] = False
    band[:, :6] = band[:, -6:] = False
    ghost_mean = np.abs(mean_img - clean_img)[band].max()
    ghost_sig = np.abs(np.asarray(img) - clean_img)[band].max()
    assert ghost_mean > 0.04, ghost_mean
    assert ghost_sig < 0.25 * ghost_mean, (ghost_sig, ghost_mean)


def test_sharded_keypoint_sigma_clip():
    """stacking='sigma_clip' on keypoint_stack_step suppresses a
    single-frame streak that the sharded mean ghosts (the keypoint
    counterpart of test_sharded_sigma_clip_stack)."""
    local = np.random.default_rng(57)
    h, w = 160, 320
    small = local.integers(0, 256, (h // 8, w // 8), np.uint8)
    base = cv2.GaussianBlur(
        cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST),
        (3, 3), 0.8,
    )
    frames = []
    for i in range(8):
        dx, dy = int(local.integers(-3, 4)), int(local.integers(-3, 4))
        cur = np.roll(base, (dy, dx), (0, 1))
        frames.append(np.stack([cur] * 3, -1))
    frames = np.stack(frames)
    dirty = frames.copy()
    st = dirty[5].copy()
    cv2.line(st, (20, 30), (290, 130), (255, 255, 255), 3)
    dirty[5] = st
    streak = np.zeros((h, w), np.uint8)
    cv2.line(streak, (20, 30), (290, 130), 1, 3)

    from libstacker_tpu.models import keypoint as kp

    feats0 = kp.detect_features_chunked(jnp.asarray(dirty[:1]))
    ref_feats = jax.tree.map(lambda x: x[0], feats0)
    m4 = pmesh.make_mesh(data=4, spatial=2)
    frames_j = pmesh.shard_frames(jnp.asarray(dirty), m4)
    mean_sum, ok = pmesh.keypoint_stack_step(frames_j, ref_feats, m4, seed=3)
    assert np.asarray(ok).all()
    mean_img = np.asarray(mean_sum) / np.asarray(ok).sum()
    sig_img, ok2 = pmesh.keypoint_stack_step(
        frames_j, ref_feats, m4, seed=3,
        stacking="sigma_clip", sigma_kappa=2.5, sigma_iters=2,
    )
    assert np.asarray(ok2).all()
    sig_img = np.asarray(sig_img)

    # baseline = the CLEAN sharded mean (same program, compile-cached):
    # comparing against raw frame 0 would count bilinear-resampling
    # error at the texture edges as "ghost" for both estimators
    clean_sum, cok = pmesh.keypoint_stack_step(
        pmesh.shard_frames(jnp.asarray(frames), m4), ref_feats, m4, seed=3
    )
    clean_img = np.asarray(clean_sum) / np.asarray(cok).sum()

    band = cv2.dilate(streak, np.ones((11, 11))).astype(bool)
    band[:10] = band[-10:] = False
    band[:, :10] = band[:, -10:] = False
    ghost_mean = np.abs(mean_img - clean_img)[band].max()
    ghost_sig = np.abs(sig_img - clean_img)[band].max()
    assert ghost_mean > 0.04, ghost_mean
    assert ghost_sig < 0.3 * ghost_mean, (ghost_sig, ghost_mean)

    with pytest.raises(ValueError):
        pmesh.keypoint_stack_step(
            frames_j, ref_feats, m4, stacking="median"
        )
