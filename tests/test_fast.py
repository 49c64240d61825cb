"""FAST-9/16 detector parity vs cv2.FastFeatureDetector (SURVEY.md N4)."""

import cv2
import jax.numpy as jnp
import numpy as np

from libstacker_tpu.ops import fast


def _textured(rng, h=120, w=160):
    small = rng.integers(0, 256, size=(h // 8, w // 8), dtype=np.uint8)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST)


def test_fast_matches_cv2(rng):
    img = _textured(rng)
    det = cv2.FastFeatureDetector_create(
        threshold=20, nonmaxSuppression=True,
        type=cv2.FAST_FEATURE_DETECTOR_TYPE_9_16,
    )
    kps = det.detect(img)
    cv_set = {(int(k.pt[0]), int(k.pt[1])): k.response for k in kps}

    mask, score = fast.fast_detect(jnp.asarray(img), 20)
    mask = np.asarray(mask)
    score = np.asarray(score)
    ys, xs = np.nonzero(mask)
    our_set = {(int(x), int(y)): score[y, x] for y, x in zip(ys, xs)}

    # cv2 FAST only scans y in [3, h-3); our implementation the same.
    missing = set(cv_set) - set(our_set)
    extra = set(our_set) - set(cv_set)
    assert not missing, f"missing {len(missing)} of {len(cv_set)}: {sorted(missing)[:5]}"
    assert not extra, f"extra {len(extra)}: {sorted(extra)[:5]}"
    for p, r in cv_set.items():
        assert our_set[p] == r, (p, our_set[p], r)


def test_fast_no_nms_superset(rng):
    img = _textured(rng)
    det = cv2.FastFeatureDetector_create(threshold=20, nonmaxSuppression=False)
    kps = det.detect(img)
    cv_set = {(int(k.pt[0]), int(k.pt[1])) for k in kps}
    mask, _ = fast.fast_detect(jnp.asarray(img), 20, nonmax=False)
    ys, xs = np.nonzero(np.asarray(mask))
    our_set = {(int(x), int(y)) for y, x in zip(ys, xs)}
    assert cv_set == our_set


def test_arc_tree_2stage_bit_identical(monkeypatch):
    """LIBSTACKER_FAST_TREE=2stage (hardware A/B knob for the arc-min
    association) is bit-identical to the default log-doubling tree —
    min is exact, only the HBM-materialisation shape differs."""
    import numpy as np

    rng = np.random.default_rng(41)  # local rng (conftest stream note)
    img = rng.integers(0, 256, (192, 256), dtype=np.uint8)
    m0, s0 = (np.asarray(x) for x in fast.fast_detect(jnp.asarray(img), 20))
    for tree in ("2stage", "noshare"):
        monkeypatch.setenv("LIBSTACKER_FAST_TREE", tree)
        m1, s1 = (
            np.asarray(x) for x in fast.fast_detect(jnp.asarray(img), 20)
        )
        np.testing.assert_array_equal(m0, m1)
        np.testing.assert_array_equal(s0, s1)


def test_top_k_pooled_exact_on_nms_maps(monkeypatch):
    """top_k_keypoints_nms (LIBSTACKER_TOPK=pooled): on a 3x3-NMS'd
    score map the 2x2 max-pool reduction is lossless — the selected
    score multiset equals the exact flat top-k's, every returned
    position carries its own score, and the env knob routes
    top_k_keypoints through it (vals/positions consistent).  CPU's
    approx_max_k is exact, so the comparison is deterministic."""
    import numpy as np

    rng = np.random.default_rng(47)
    for h, w in ((96, 128), (97, 131)):  # even + odd (pad path)
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        mask, score = fast.fast_detect(jnp.asarray(img), 12)
        n_surv = int(np.asarray(mask).sum())
        assert n_surv > 20  # the map actually exercises the reduction
        for k in (8, n_surv, n_surv + 17):
            exact = fast.top_k_keypoints(mask, score, k, approx=False)
            pooled = fast.top_k_keypoints_nms(mask, score, k)
            ev = np.sort(np.asarray(exact.score)[np.asarray(exact.valid)])
            pv = np.sort(np.asarray(pooled.score)[np.asarray(pooled.valid)])
            np.testing.assert_array_equal(ev, pv)
            sc = np.asarray(score)
            ms = np.asarray(mask)
            for y, x, v, ok in zip(
                np.asarray(pooled.ys), np.asarray(pooled.xs),
                np.asarray(pooled.score), np.asarray(pooled.valid),
            ):
                if ok:
                    assert ms[y, x] and sc[y, x] == v
            assert pooled.score.shape == (k,)  # static slot shape kept

    monkeypatch.setenv("LIBSTACKER_TOPK", "pooled")
    routed = fast.top_k_keypoints(mask, score, 16)
    direct = fast.top_k_keypoints_nms(mask, score, 16)
    np.testing.assert_array_equal(np.asarray(routed.score), np.asarray(direct.score))
    np.testing.assert_array_equal(np.asarray(routed.ys), np.asarray(direct.ys))
