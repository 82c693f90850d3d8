"""The port's crop-warp API (``retto_tpu_torch.image.warp``) against the JAX
package's on the same seeded inputs: the cases of tests/test_warp.py
(output size and rotate flag, identity and rotated homographies, a batch
of boxes in one bucket), ``warp_crops_separable`` at the rec's and the
cls's shapes, and ``utils.metrics.profile_trace`` writing a trace."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retto_tpu.geometry import PointBox as JBox
from retto_tpu.image import warp as jw
from retto_tpu_torch.geometry import PointBox
from retto_tpu_torch.image import warp as tw

# the separable warp: both packages' sampling matrices are equal bit for
# bit, and each output sums two taps per pass in float32, where XLA may
# fuse a multiply-add that torch rounds twice: one ulp of 255 per pass
SEPARABLE_ATOL = 2 * 255 * 2.0 ** -23


def test_crop_output_size_and_rotate_flag():
    for pts in ([[0, 0], [100, 0], [100, 30], [0, 30]], [[0, 0], [20, 0], [20, 100], [0, 100]],
                [[3.5, 7.25], [88.0, 1.0], [90.5, 40.0], [1.0, 44.0]]):
        assert tw.crop_output_size(PointBox(pts)) == jw.crop_output_size(JBox(pts))
    assert tw.crop_output_size(PointBox([[0, 0], [100, 0], [100, 30], [0, 30]])) == (30, 100,
                                                                                     False)
    assert tw.crop_output_size(PointBox([[0, 0], [20, 0], [20, 100], [0, 100]])) == (100, 20,
                                                                                     True)


def _both(img: np.ndarray, boxes: np.ndarray, out_hw, sizes, **kw):
    hj = jw.crop_homographies(boxes, out_hw, sizes)
    ht = tw.crop_homographies(boxes, out_hw, sizes)
    np.testing.assert_array_equal(ht, hj)
    ref = np.asarray(jw.warp_crops(jnp.asarray(img), jnp.asarray(hj), *out_hw, **kw))
    kw_t = {k: torch.as_tensor(np.asarray(v)) if k == "valid_hw" else v for k, v in kw.items()}
    got = tw.warp_crops(torch.from_numpy(img), torch.from_numpy(ht), *out_hw, **kw_t).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    return got


def test_axis_aligned_warp_matches_slice_and_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (80, 120, 3), dtype=np.uint8)
    box = np.array([[10, 20], [70, 20], [70, 50], [10, 50]], dtype=np.float32)
    out = _both(img, box[None], (30, 60), np.array([[30, 60]]))
    direct = img[20:50, 10:70].astype(np.float32)
    np.testing.assert_allclose(out[0][2:-2, 2:-2], direct[2:-2, 2:-2], atol=1.0)


def test_out_of_bounds_fills_white_like_jax():
    img = np.zeros((40, 40, 3), dtype=np.uint8)
    box = np.array([[-20, -20], [20, -20], [20, 20], [-20, 20]], dtype=np.float32)
    out = _both(img, box[None], (40, 40), np.array([[40, 40]]))
    assert out[0, 0, 0, 0] == 255.0 and out[0, 30, 30, 0] == 0.0
    # a padded image: samples beyond the valid extent fill, as in JAX
    _both(np.pad(img, ((0, 8), (0, 8), (0, 0))), box[None], (40, 40), np.array([[40, 40]]),
          fill=128.0, valid_hw=np.array([40, 40], np.int32))


def test_rotated_and_batched_boxes_like_jax():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (100, 200, 3), dtype=np.uint8)
    boxes = np.array([[[10, 10], [58, 10], [58, 34], [10, 34]],
                      [[100, 40], [196, 40], [196, 88], [100, 88]],
                      [[30, 60], [80, 50], [84, 70], [34, 80]]], dtype=np.float32)
    sizes = np.array([[24, 48], [48, 96], [20, 50]])
    out = _both(img, boxes, (48, 96), sizes)
    direct = img[40:88, 100:196].astype(np.float32)
    np.testing.assert_allclose(out[1][4:-4, 4:-4], direct[4:-4, 4:-4], atol=1.0)
    assert abs(out[0].mean() - img[10:34, 10:58].mean()) < 10


def test_gather_warp_follows_xla_arithmetic():
    """16 rotated crops at 48x320, many reaching past the image, against
    JAX's gather warp bit for bit: the port reproduces XLA's fused
    arithmetic (the homography as round(x*h0) then two fused
    multiply-adds; each bilinear blend with the product XLA's loop fuses,
    which follows the taps' bounds)."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (300, 400, 3)).astype(np.float32)
    quads = []
    for _ in range(16):
        cx, cy, a = rng.uniform(50, 350), rng.uniform(50, 250), rng.uniform(-0.5, 0.5)
        w, h = rng.uniform(40, 120), rng.uniform(15, 40)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        quads.append(np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2],
                               [-w / 2, h / 2]]) @ rot.T + [cx, cy])
    hom = jw.crop_homographies(np.array(quads, np.float32), (48, 320),
                               np.tile([[48, 320]], (16, 1)))
    ref = np.asarray(jw.warp_crops(jnp.asarray(img), jnp.asarray(hom), 48, 320))
    got = tw.warp_crops(torch.from_numpy(img), torch.from_numpy(hom), 48, 320).numpy()
    assert (got == 255.0).any() and (got != 255.0).any()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("out_w,scal", [
    (320, [[8.0, 600.0 / 320.0, 100.0, 32.0 / 48.0], [608.0, -600.0 / 320.0, 132.0, -32.0 / 48.0],
           [-20.0, 1.5, 900.0, 1.25]]),
    (192, [[8.0, 600.0 / 192.0, 100.0, 32.0 / 48.0], [608.0, -600.0 / 192.0, 132.0, -32.0 / 48.0],
           [650.0, 0.75, -10.0, 0.5]]),
])
def test_separable_warp_like_jax(out_w, scal):
    """The rec's 48x320 and the cls's 48x192 crops, upright, flipped and
    reaching past the valid extent of a padded batch of two images."""
    rng = np.random.default_rng(out_w)
    imgs = rng.integers(0, 255, (2, 960, 704, 3), dtype=np.uint8)
    idx = np.array([0, 1, 1], np.int32)
    scal = np.asarray(scal, np.float32)
    valid = np.array([[960, 704], [900, 640]], np.int32)
    ref = np.asarray(jw.warp_crops_separable(jnp.asarray(imgs), jnp.asarray(idx),
                                             jnp.asarray(scal), jnp.asarray(valid), 48, out_w))
    got = tw.warp_crops_separable(torch.from_numpy(imgs), torch.from_numpy(idx),
                                  torch.from_numpy(scal), torch.from_numpy(valid), 48,
                                  out_w).numpy()
    assert got.shape == ref.shape == (3, 48, out_w, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=SEPARABLE_ATOL)


def test_axis_matrix_bit_for_bit_like_jax():
    """The 1-D sampling matrices and their tap mass equal JAX's bits (XLA's
    fused ``o + d*s``), at the rec's 49 rows over a 1024-row bucket and the
    cls's 193 columns over 768, flips and valid extents included."""
    rng = np.random.default_rng(3)
    for src, dst in ((1024, 49), (768, 193)):
        o = rng.uniform(-20, src, 64).astype(np.float32)
        s = rng.uniform(-3, 3, 64).astype(np.float32)
        valid = rng.uniform(src / 3, src, 64).astype(np.float32)
        wj, mj = jax.jit(jw._axis_matrix, static_argnums=(2, 3))(
            jnp.asarray(o), jnp.asarray(s), src, dst, jnp.asarray(valid))
        wt, mt = tw._axis_matrix(torch.from_numpy(o), torch.from_numpy(s), src, dst,
                                 torch.from_numpy(valid))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    from retto_tpu_torch.utils.metrics import profile_trace

    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    path = tmp_path / "trace" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert prof.key_averages()
