"""retto_tpu_torch.train.data against retto_tpu.train.data on the CPU: the
device datasets, the three gathers and the on-device DB ground truth.

Tolerance: exact, but for the threshold map of the DB ground truth, whose
values may differ by one float32 step (5.96e-8) on at most 0.1% of the
pixels (measured: 1 of 10,240 at the 64 x 80 grid, a band pixel where
XLA's fused ``0.3 + 0.4 * (1 - |s| / d)`` rounds otherwise).  JAX's random
draws cannot be made in torch, so the test draws them with JAX's own key
splits (data.py:86-93, :165-167, :257-268) and hands the same values to
the port's gathers (``draws=``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retto_tpu.train import data as jd
from retto_tpu.train.synth import db_ground_truth
from retto_tpu_torch.train import data as td


def _assert_gt_equal(got, ref):
    """(shrink, thresh, thresh_mask): exact, the thresh map within one
    float32 step on at most 0.1% of its pixels."""
    shrink, thresh, tmask = (np.asarray(r) for r in ref)
    np.testing.assert_array_equal(got[0].numpy(), shrink)
    np.testing.assert_array_equal(got[2].numpy(), tmask)
    np.testing.assert_allclose(got[1].numpy(), thresh, rtol=0, atol=2.0 ** -24)
    assert (got[1].numpy() != thresh).mean() <= 1e-3


def _rec_data(rng):
    imgs = [rng.integers(0, 256, (48, int(w), 3), dtype=np.uint8)
            for w in rng.integers(20, 70, 6)]
    labels = rng.integers(1, 30, (6, 5)).astype(np.int32)
    lengths = rng.integers(1, 6, 6).astype(np.int32)
    return imgs, labels, lengths


def test_rec_gather_plain_and_augmented_exact():
    rng = np.random.default_rng(0)
    imgs, labels, lengths = _rec_data(rng)
    jdata = jd.RecDeviceData.build(imgs, labels, lengths, 64)
    tdata = td.RecDeviceData.build(imgs, labels, lengths, 64, "cpu")
    idx = np.array([3, 0, 5, 5], np.int32)
    ref = jd.gather_rec_batch(jdata, jnp.asarray(idx))
    got = td.gather_rec_batch(tdata, torch.from_numpy(idx).long())
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    key = jax.random.PRNGKey(7)
    rx, _, _ = jd.gather_rec_batch(jdata, jnp.asarray(idx), key=key)
    kg, kb, kn, ka = jax.random.split(key, 4)
    b = len(idx)
    draws = {"gain": jax.random.uniform(kg, (b, 1, 1, 1), minval=0.4, maxval=1.15),
             "bias": jax.random.uniform(kb, (b, 1, 1, 1), minval=-1.1, maxval=0.2),
             "noise": 0.05 * jax.random.normal(kn, (b, 48, 64, 3)),
             "aug": jax.random.bernoulli(ka, 0.75, (b, 1, 1, 1))}
    draws = {k: torch.from_numpy(np.array(v)).reshape(b, *v.shape[1:] if k == "noise" else ())
             for k, v in draws.items()}
    gx, _, _ = td.gather_rec_batch(tdata, torch.from_numpy(idx).long(), draws=draws)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(rx))
    # and the port's own draws on a generator give a batch of the same form
    g = torch.Generator().manual_seed(0)
    ox, _, _ = td.gather_rec_batch(tdata, torch.from_numpy(idx).long(), generator=g)
    assert ox.shape == gx.shape and float(ox.abs().max()) <= 1.0


def test_cls_gather_exact():
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (int(h), int(w), 3), dtype=np.uint8)
            for h, w in zip(rng.integers(20, 90, 5), rng.integers(30, 300, 5))]
    jdata = jd.ClsDeviceData.build(imgs, 96)
    tdata = td.ClsDeviceData.build(imgs, 96, "cpu")
    np.testing.assert_array_equal(tdata.lines.numpy(), np.asarray(jdata.lines))
    idx = np.array([4, 1, 1, 0], np.int32)
    rot = np.array([1, 0, 1, 0], np.int32)
    gain = rng.uniform(0.5, 1.25, 4).astype(np.float32)
    bias = rng.uniform(-0.55, 0.2, 4).astype(np.float32)
    key = jax.random.PRNGKey(3)
    for kw in ({}, {"gain": gain, "bias": bias}, {"gain": gain, "bias": bias, "key": key}):
        jkw = {k: jnp.asarray(v) if k != "key" else v for k, v in kw.items()}
        rx, rr = jd.gather_cls_batch(jdata, jnp.asarray(idx), jnp.asarray(rot), **jkw)
        tkw = {k: torch.from_numpy(v) for k, v in kw.items() if k != "key"}
        if "key" in kw:
            tkw["noise"] = torch.from_numpy(np.array(
                0.05 * jax.random.normal(key, (4, 48, 96, 3))))
        gx, gr = td.gather_cls_batch(tdata, torch.from_numpy(idx).long(),
                                     torch.from_numpy(rot), **tkw)
        np.testing.assert_array_equal(gx.numpy(), np.asarray(rx))
        np.testing.assert_array_equal(gr.numpy(), np.asarray(rr))


@pytest.mark.parametrize("size", [(64, 80), (37, 53)])
def test_db_gt_device_exact(size):
    rng = np.random.default_rng(2)
    boxes = np.full((2, 5, 4), -1.0, np.float32)
    for b in range(2):
        for i in range(4 - b):
            x0, y0 = rng.uniform(0, size[1] - 20), rng.uniform(0, size[0] - 12)
            boxes[b, i] = [x0, y0, x0 + rng.uniform(6, 20), y0 + rng.uniform(5, 12)]
    ref = jax.vmap(lambda bx: jd.db_gt_device(bx, *size))(jnp.asarray(boxes))
    _assert_gt_equal(td.db_gt_device(torch.from_numpy(boxes), *size), ref)
    # the host ground truth agrees on the shrink region of whole-pixel boxes
    s_host = db_ground_truth(np.round(boxes[0, :4]), *size)[0]
    s_dev = td.db_gt_device(torch.from_numpy(np.round(boxes[:1, :4])), *size)[0][0]
    assert s_dev.sum() > 0 and s_host.sum() > 0


@pytest.mark.parametrize("out_stride", [1, 2])
def test_det_gather_exact(out_stride):
    rng = np.random.default_rng(3)
    pages = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(3)]
    boxes = [np.array([[4, 6, 40, 20], [10, 30, 60, 50]], np.float32),
             np.zeros((0, 4), np.float32), np.array([[1, 1, 30, 12]], np.float32)]
    jdata = jd.DetDeviceData.build(pages, boxes)
    tdata = td.DetDeviceData.build(pages, boxes, "cpu")
    idx = np.array([2, 0], np.int32)
    key = jax.random.PRNGKey(11)
    ref = jd.gather_det_batch(jdata, jnp.asarray(idx), out_stride=out_stride, key=key)
    kg, kb, kn, ka, kt = jax.random.split(key, 5)
    draws = {"gain": jax.random.uniform(kg, (2,), minval=0.35, maxval=1.15),
             "bias": jax.random.uniform(kb, (2,), minval=-1.2, maxval=0.25),
             "tint": jax.random.uniform(kt, (2, 3), minval=-0.06, maxval=0.06),
             "noise": 0.06 * jax.random.normal(kn, (2, 64, 64, 3)),
             "aug": jax.random.bernoulli(ka, 0.75, (2,))}
    got = td.gather_det_batch(tdata, torch.from_numpy(idx).long(), out_stride=out_stride,
                              draws={k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    for r, g in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    _assert_gt_equal((got[1], got[3], got[4]), (ref[1], ref[3], ref[4]))
