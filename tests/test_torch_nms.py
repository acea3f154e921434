"""The decode's hard NMS in the port (``oks_nms_sorted``: a sort, one ordered
scan, a top-k) against the round-per-detection ``oks_nms_fixed`` of the port
and of the JAX package, and ``max_keep`` of the scan's plain version.

The same candidates, made from a seed with numpy, go through each function
on the CPU; the Pallas kernel runs in interpret mode, as the JAX package's
own tests run it. On the CPU the port's scan runs its plain version.
Tolerance: exact (indices and validity are integers and booleans; the
candidates are random, so no pair's similarity lies within rounding of the
threshold, where the two expression orders could part).
"""

import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from das_tpu.ops import oks_nms as jnms  # noqa: E402
from das_tpu.ops.pallas_nms import oks_nms_pallas  # noqa: E402
from das_tpu_torch.core import decode  # noqa: E402
from das_tpu_torch.ops import oks_nms  # noqa: E402


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _candidates(B, M, J, seed):
    """Clustered poses (every third a jittered copy of the one before it, so
    that suppression happens), ~85% valid, scores in no order with a few
    equal ones, areas of the poses' boxes."""
    rng = np.random.RandomState(seed)
    kpts = rng.rand(B, M, J, 2).astype(np.float32) * 60
    n = kpts[:, 1::3].shape[1]
    kpts[:, 1::3] = kpts[:, 0::3][:, :n] + \
        rng.randn(B, n, J, 2).astype(np.float32)
    scores = rng.rand(B, M).astype(np.float32)
    scores[:, 5::7] = scores[:, 4::7][:, :scores[:, 5::7].shape[1]]
    areas = ((kpts[..., 0].max(-1) - kpts[..., 0].min(-1)) *
             (kpts[..., 1].max(-1) - kpts[..., 1].min(-1))).astype(np.float32)
    valid = rng.rand(B, M) < 0.85
    return kpts, scores, areas, valid


@pytest.mark.parametrize('M', [37, 64, 200])
@pytest.mark.parametrize('J', [15, 17])
def test_oks_nms_sorted_matches_fixed_and_jax(M, J):
    """Indices and validity of oks_nms_sorted equal those of the port's
    oks_nms_fixed and of das_tpu's oks_nms_fixed, exactly, with max_dets
    below, at and above the number kept."""
    kpts, scores, areas, valid = _candidates(2, M, J, seed=M + J)
    sig = oks_nms.default_sigmas(J)
    args = (_t(kpts), _t(scores), _t(areas), _t(valid), 0.9, sig)
    suppressed = False
    for max_dets in (5, 20, M):
        idx, ok = oks_nms.oks_nms_sorted(*args, max_dets=max_dets)
        fidx, fok = oks_nms.oks_nms_fixed(*args, max_dets=max_dets)
        assert idx.shape == (2, max_dets) and ok.dtype == torch.bool
        np.testing.assert_array_equal(ok.numpy(), fok.numpy())
        np.testing.assert_array_equal(idx.numpy(), fidx.numpy())
        for b in range(2):
            jidx, jok = jnms.oks_nms_fixed(
                jnp.asarray(kpts[b]), jnp.asarray(scores[b]),
                jnp.asarray(areas[b]), jnp.asarray(valid[b]), 0.9, sig,
                max_dets=max_dets)
            np.testing.assert_array_equal(ok[b].numpy(), np.asarray(jok))
            np.testing.assert_array_equal(idx[b].numpy(), np.asarray(jidx))
        if max_dets == M:
            kept = ok.sum(1).numpy()
            suppressed = bool((kept < valid.sum(1)).all()) and kept.min() > 5
    assert suppressed
    # one image without the batch dimension
    one = oks_nms.oks_nms_sorted(*[a[0] if torch.is_tensor(a) else a
                                   for a in args], max_dets=20)
    both = oks_nms.oks_nms_sorted(*args, max_dets=20)
    np.testing.assert_array_equal(one[0].numpy(), both[0][0].numpy())
    np.testing.assert_array_equal(one[1].numpy(), both[1][0].numpy())


def test_oks_nms_sorted_takes_more_detections_than_candidates():
    kpts, scores, areas, valid = _candidates(2, 12, 15, seed=1)
    sig = oks_nms.default_sigmas(15)
    args = (_t(kpts), _t(scores), _t(areas), _t(valid), 0.9, sig)
    idx, ok = oks_nms.oks_nms_sorted(*args, max_dets=30)
    fidx, fok = oks_nms.oks_nms_fixed(*args, max_dets=30)
    np.testing.assert_array_equal(ok.numpy(), fok.numpy())
    np.testing.assert_array_equal(idx.numpy(), fidx.numpy())
    none = oks_nms.oks_nms_sorted(_t(kpts), _t(scores), _t(areas),
                                  _t(np.zeros_like(valid)), 0.9, sig,
                                  max_dets=4)
    assert not none[1].any() and not none[0].any()


@pytest.mark.parametrize('M,J', [(48, 15), (130, 17)])
def test_oks_nms_keep_plain_max_keep(M, J):
    """With max_keep=k the plain scan keeps the first k of what the full
    scan keeps, and nothing else; the full mask equals oks_nms_pallas
    (interpret=True) exactly."""
    kpts, scores, areas, valid = _candidates(2, M, J, seed=M)
    order = np.argsort(-scores, axis=1, kind='stable')
    take = np.arange(2)[:, None]
    kpts, areas, valid = kpts[take, order], areas[take, order], \
        valid[take, order]
    sig = oks_nms.default_sigmas(J)
    full = oks_nms.oks_nms_keep(_t(kpts), _t(areas), _t(valid), 0.9, sig)
    for b in range(2):
        want = np.asarray(oks_nms_pallas(
            jnp.asarray(kpts[b]), jnp.asarray(areas[b]),
            jnp.asarray(valid[b]), 0.9, sig, interpret=True))
        np.testing.assert_array_equal(full[b].numpy(), want)
    n_kept = int(full.sum(1).min())
    assert n_kept > 6
    for k in (0, 1, 6, n_kept, M):
        got = oks_nms.oks_nms_keep(_t(kpts), _t(areas), _t(valid), 0.9, sig,
                                   max_keep=k).numpy()
        want = full.numpy() & (np.cumsum(full.numpy(), axis=1) <= k)
        np.testing.assert_array_equal(got, want)
    one = oks_nms.oks_nms_keep(_t(kpts[1]), _t(areas[1]), _t(valid[1]), 0.9,
                               sig, max_keep=6)
    np.testing.assert_array_equal(
        one.numpy(), full[1].numpy() & (np.cumsum(full[1].numpy()) <= 6))
    with pytest.raises(ValueError):
        oks_nms.oks_nms_keep(_t(kpts), _t(areas), _t(valid), 0.9, sig,
                             max_keep=-1)


def test_decode_routes_hard_nms_through_the_sorted_scan(monkeypatch):
    """decode_batch with nms_type='hard' calls oks_nms_sorted (and through
    it the scan with max_keep=nms_post) once; 'soft' does not; the decoded
    batch equals the one built from oks_nms_fixed's indices."""
    rng = np.random.RandomState(4)
    N, J, strides = 2, 15, (8, 16)
    sizes = [(8, 10), (4, 5)]
    cls = [_t(rng.randn(N, h, w, 1).astype(np.float32)) for h, w in sizes]
    ctr = [_t(rng.randn(N, h, w, 1).astype(np.float32) + 1) for h, w in sizes]
    # poses of ~16 px around each point, so that neighbours overlap
    ang = np.arange(J) * (2 * np.pi / J)
    uvd = np.stack([16 * np.cos(ang), 16 * np.sin(ang), np.zeros(J)], -1)
    pose = [_t((np.concatenate([np.zeros(3), uvd.reshape(-1)])
                + rng.randn(N, h, w, 3 + 3 * J) * 0.5).astype(np.float32))
            for h, w in sizes]
    sf = np.ones((N, 2), np.float32)
    cfg = dict(nms_pre=50, nms_post=10, nms_thr=0.9, score_thr=0.07)
    calls = []
    real_sorted, real_keep = decode.oks_nms_sorted, oks_nms.oks_nms_keep
    monkeypatch.setattr(decode, 'oks_nms_sorted', lambda *a, **k:
                        calls.append('sorted') or real_sorted(*a, **k))
    monkeypatch.setattr(oks_nms, 'oks_nms_keep', lambda *a, **k:
                        calls.append(k.get('max_keep')) or real_keep(*a, **k))
    got = decode.decode_batch(cls, pose, ctr, strides, sf, J, cfg)
    assert calls == ['sorted', 10]
    monkeypatch.setattr(decode, 'oks_nms_sorted', oks_nms.oks_nms_fixed)
    want = decode.decode_batch(cls, pose, ctr, strides, sf, J, cfg)
    n_valid = int(want['valid'].sum())
    cand = decode.decode_candidates(cls, pose, ctr, strides, sf, J, cfg)
    assert 0 < n_valid < int(cand['valid'].sum())     # some were suppressed
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    calls.clear()
    decode.decode_batch(cls, pose, ctr, strides, sf, J,
                        dict(cfg, nms_type='soft'))
    assert calls == []
