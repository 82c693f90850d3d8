"""The cases of tests/test_train.py and tests/test_checkpoint.py on the
port's training modules (``retto_tpu_torch.train``), against the JAX
package where both compute the same thing, plus a port-trained checkpoint
that the JAX package loads.  The mesh and sharding cases wait for the
port's ``torch.distributed`` work.

Tolerances: the host copies (synth, bigvocab, the ragged cache, the crop
warp) are held to the JAX package exactly; the checkpoint's outputs in the
JAX model within 1e-5 of the largest probability (float32 models, the sums
in different orders; measured <= 1e-7)."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retto_tpu_torch.models import MODEL_PRESETS, build_cls, build_det, build_rec
from retto_tpu_torch.ops.charset import CharacterDict, ascii_charset
from retto_tpu_torch.train import cls_loss, ctc_loss, db_loss, init_train_state, make_train_step
from retto_tpu_torch.train.checkpoint import CheckpointManager
from retto_tpu_torch.train.synth import (
    db_ground_truth,
    make_cls_batch,
    make_det_batch,
    make_rec_batch,
    render_line,
)
from retto_tpu_torch.weights import export_flax_params, load_params_meta, save_params

CHARS = CharacterDict(list("0123456789"))


class TestLosses:
    def test_ctc_loss_decreases_for_correct_logits(self):
        n, t, c = 2, 12, 12
        labels = torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0]], dtype=torch.int32)
        lengths = torch.tensor([3, 2], dtype=torch.int32)
        good = np.full((n, t, c), -5.0, np.float32)
        for i, row in enumerate([[1, 2, 3], [4, 5]]):
            good[i, :, 0] = 5.0
            for j, lab in enumerate(row):
                good[i, j * 3, 0] = -5.0
                good[i, j * 3, lab] = 5.0
        l_good = float(ctc_loss(torch.from_numpy(good), labels, lengths))
        l_bad = float(ctc_loss(torch.zeros(n, t, c), labels, lengths))
        assert l_good < l_bad

    def test_db_loss_zero_ish_for_perfect_pred(self):
        h = w = 64
        gt = [torch.from_numpy(a)[None] for a in db_ground_truth(np.array([[10, 10, 50, 30]]), h, w)]
        eps = 1e-4
        perfect = {"maps": gt[0][None].clamp(eps, 1 - eps), "thresh": gt[2][None],
                   "binary": gt[0][None]}
        wrong = {"maps": torch.full((1, 1, h, w), 0.5), "thresh": torch.zeros(1, 1, h, w),
                 "binary": torch.full((1, 1, h, w), 0.5)}
        lp, lw = float(db_loss(perfect, *gt)), float(db_loss(wrong, *gt))
        assert lp < lw and lp < 0.5

    def test_cls_loss(self):
        probs = torch.tensor([[0.9, 0.1], [0.2, 0.8]])
        labels = torch.tensor([0, 1])
        assert float(cls_loss(probs, labels)) < float(cls_loss(probs, 1 - labels))


class TestSynthCopy:
    """The port's copy of train/synth.py renders what the JAX package's does."""

    def test_render_line_matches_jax(self):
        from retto_tpu.train.synth import render_line as j_render_line

        img = render_line("hello 123", 48)
        assert img.shape[0] == 48 and img.shape[2] == 3
        np.testing.assert_array_equal(img, j_render_line("hello 123", 48))

    def test_rec_and_cls_batches_match_jax(self):
        from retto_tpu.ops.charset import CharacterDict as JChars
        from retto_tpu.train.synth import make_cls_batch as j_cls, make_rec_batch as j_rec

        x, labels, lengths, texts = make_rec_batch(np.random.default_rng(0), CHARS, 4, max_len=8)
        rx, rl, rn, rt = j_rec(np.random.default_rng(0), JChars(list("0123456789")), 4, max_len=8)
        assert x.shape == (4, 3, 48, 320) and texts == rt
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(labels, rl)
        x, y = make_cls_batch(np.random.default_rng(0), CHARS, 6)
        rx, ry = j_cls(np.random.default_rng(0), JChars(list("0123456789")), 6)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)

    def test_det_batch_and_gt_match_jax(self):
        from retto_tpu.ops.charset import CharacterDict as JChars
        from retto_tpu.train.synth import make_det_batch as j_det

        got = make_det_batch(np.random.default_rng(0), CHARS, 2, h=128, w=160)
        ref = j_det(np.random.default_rng(0), JChars(list("0123456789")), 2, h=128, w=160)
        assert got[0].shape == (2, 3, 128, 160) and got[1].shape == (2, 128, 160)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


class TestTrainStep:
    def test_rec_train_step_single_device(self):
        model = build_rec("tiny", num_classes=CHARS.num_classes, compute_dtype=None,
                          dims=(16, 32, 48, 64), depths=(1, 1, 1, 1), mixer_depth=1)
        x, labels, lengths, _ = make_rec_batch(np.random.default_rng(0), CHARS, 2, w=96,
                                               max_len=4)
        state = init_train_state(model, 1e-3, device="cpu")
        step = make_train_step(model, ctc_loss, forward=lambda m, v: m(v, return_logits=True))
        losses = []
        for _ in range(3):
            state, loss = step(state, torch.from_numpy(x), torch.from_numpy(labels),
                               torch.from_numpy(lengths))
            losses.append(float(loss))
        assert np.isfinite(losses).all() and state.step == 3

    def test_cast_model_refuses_training(self):
        from retto_tpu_torch.models.common import cast_compute

        model = cast_compute(build_cls("tiny"), torch.bfloat16)
        with pytest.raises(RuntimeError, match="cannot train"):
            model.train()
        model.eval()  # inference stays allowed

    def test_bf16_training_keeps_float32_master_weights(self):
        model = build_cls("tiny")  # bf16 compute
        x, y = make_cls_batch(np.random.default_rng(0), CHARS, 4, shape=(3, 32, 64))
        state = init_train_state(model, 1e-3, device="cpu")
        state, loss = make_train_step(model, cls_loss)(state, torch.from_numpy(x),
                                                       torch.from_numpy(y))
        assert np.isfinite(float(loss))
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(p.grad is not None and p.grad.dtype == torch.float32
                   for p in model.parameters())


class TestBigVocabCopy:
    def test_charset_and_glyphs_match_jax(self):
        from retto_tpu.train import bigvocab as jb
        from retto_tpu_torch.train import bigvocab as tb

        cs = tb.big_charset()
        assert len(cs) == tb.BIG_NUM_KEYS == 6623 and cs == jb.big_charset()
        assert CharacterDict(cs).num_classes == 6625
        assert tb.glyph_bitmap(7) is tb.glyph_bitmap(7)
        np.testing.assert_array_equal(tb.glyph_bitmap(11), jb.glyph_bitmap(11))
        ids, text = tb.random_big_text(np.random.default_rng(3), tb.BIG_NUM_KEYS)
        assert CharacterDict(cs).encode(text) == ids
        img = tb.render_big_line(ids, 48, np.random.default_rng(4))
        np.testing.assert_array_equal(img, jb.render_big_line(ids, 48, np.random.default_rng(4)))


class TestDatasetCache:
    def test_ragged_roundtrip_reads_the_jax_tools_files(self, tmp_path):
        from tools.train_synthetic import _load_ragged as j_load, _save_ragged as j_save

        from retto_tpu_torch.train.synthetic import _load_ragged, _save_ragged

        rng = np.random.default_rng(0)
        imgs = [rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
                for h, w in [(48, 37), (12, 220), (300, 8)]]
        lab = np.arange(6).reshape(3, 2).astype(np.int32)
        _save_ragged(tmp_path / "x.npz", imgs, labels=lab)
        j_save(tmp_path / "j.npz", imgs, labels=lab)
        for path, load in ((tmp_path / "x.npz", j_load), (tmp_path / "j.npz", _load_ragged)):
            out, extras = load(path)
            assert len(out) == 3 and all(np.array_equal(a, b) for a, b in zip(imgs, out))
            assert np.array_equal(extras["labels"], lab)

    def test_cached_hit_miss_and_key(self, tmp_path):
        from retto_tpu_torch.train.synthetic import _cached

        calls = []

        def render():
            calls.append(1)
            return [np.zeros((4, 4, 3), np.uint8)], {"v": np.asarray([7])}

        _, e1 = _cached(tmp_path, "d", 10, render)
        _, e2 = _cached(tmp_path, "d", 10, render)  # hit
        assert len(calls) == 1 and np.array_equal(e2["v"], e1["v"])
        _cached(tmp_path, "d", 11, render)  # key mismatch -> re-render
        assert len(calls) == 2
        i4, _ = _cached(None, "d", 10, render)  # no cache dir -> render
        assert len(calls) == 3 and len(i4) == 1
        (tmp_path / "d.npz").write_bytes(b"not an npz")  # a torn file is a miss
        i5, _ = _cached(tmp_path, "d", 11, render)
        assert len(calls) == 4 and len(i5) == 1


class TestInferenceKernelCrops:
    def test_warp_crops_like_inference_matches_jax_tool(self):
        from tools.train_synthetic import warp_crops_like_inference as j_warp

        from retto_tpu.image.io import ImageHelper as JHelper
        from retto_tpu_torch.image.io import ImageHelper
        from retto_tpu_torch.train.synthetic import warp_crops_like_inference

        img = np.random.default_rng(0).integers(0, 255, (300, 500, 3), np.uint8)
        quads = [
            np.array([[40.0, 50.0], [260.0, 50.0], [260.0, 95.0], [40.0, 95.0]]),
            np.array([[0.0, 0.0], [100.0, 0.0], [100.0, 28.0], [0.0, 28.0]]),
            np.array([[350.0, 260.0], [499.0, 260.0], [499.0, 299.0], [350.0, 299.0]]),
            np.array([[10.0, 10.0], [40.0, 10.0], [40.0, 150.0], [10.0, 150.0]]),  # tall
        ]
        got = warp_crops_like_inference(ImageHelper(img), quads)
        ref = j_warp(JHelper(img), quads)
        assert got[3] is None and ref[3] is None
        for g, r in zip(got[:3], ref[:3]):
            np.testing.assert_array_equal(g, r)

    def test_downsample_2tap_matches_jax(self):
        from retto_tpu.train.synth import downsample_2tap as j_down
        from retto_tpu_torch.train.synth import downsample_2tap

        rng = np.random.default_rng(1)
        for h, w, oh, ow in [(96, 240, 48, 100), (30, 77, 48, 123), (211, 1500, 48, 341),
                             (48, 64, 48, 64), (72, 90, 48, 60)]:
            img = rng.integers(0, 255, (h, w, 3), np.uint8)
            np.testing.assert_array_equal(downsample_2tap(img, oh, ow), j_down(img, oh, ow))


@pytest.fixture(scope="module")
def cls_setup():
    model = build_cls("tiny", compute_dtype=None)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, 32, 64)).astype(np.float32))
    return model, x


def test_save_restore_roundtrip(tmp_path, cls_setup):
    model, x = cls_setup
    y = torch.tensor([0, 1])
    mgr = CheckpointManager(tmp_path)
    state = init_train_state(model, 1e-3, device="cpu")
    step = make_train_step(model, cls_loss)
    state, _ = step(state, x, y)
    mgr.save(1, state)
    assert mgr.latest_step() == 1
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    state, _ = step(state, x, y)  # move on, then restore step 1
    restored = mgr.restore(state)
    assert restored.step == 1
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)
    state2, loss = step(restored, x, y)
    assert np.isfinite(float(loss)) and state2.step == 2
    for s in (2, 3, 4):
        mgr.save(s, state2)
    assert mgr.steps() == [2, 3, 4]  # keep=3 drops the oldest
    assert not list(tmp_path.glob(".ckpt_*"))  # no temporary file left behind
    mgr.close()


def test_restore_empty_raises(tmp_path, cls_setup):
    model, _ = cls_setup
    mgr = CheckpointManager(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        mgr.restore(init_train_state(model, 1e-3, device="cpu"))
    mgr.close()


class TestCheckpointMeta:
    def test_meta_roundtrip(self, tmp_path):
        flat = {"params::Dense_0::kernel": np.ones((2, 2), np.float32)}
        save_params(tmp_path / "m.npz", flat,
                    meta={"preset": "mobile", "overrides": {"scale": 1.0}})
        out, meta = load_params_meta(tmp_path / "m.npz")
        assert meta == {"preset": "mobile", "overrides": {"scale": 1.0}}
        assert out["params::Dense_0::kernel"].shape == (2, 2)

    def test_no_meta_returns_none(self, tmp_path):
        save_params(tmp_path / "m.npz", {"params::w": np.zeros(3)})
        out, meta = load_params_meta(tmp_path / "m.npz")
        assert meta is None and out["params::w"].shape == (3,)

    def test_session_honors_checkpoint_overrides(self, tmp_path):
        """Tiny checkpoints (JAX-initialised, saved with their overrides)
        opened with preset="mobile": the checkpoint's meta builds the tiny
        architectures, mbv3 cls and tpu det included."""
        from retto_tpu.models import build_cls as jc, build_det as jd, build_rec as jr
        from retto_tpu.weights import init_random_params, save_params as j_save
        from retto_tpu_torch import RettoSession, SessionConfig

        chars = CharacterDict(ascii_charset())
        tiny = MODEL_PRESETS["tiny"]
        models = {"det": jd("tiny"), "cls": jc("tiny"),
                  "rec": jr("tiny", num_classes=chars.num_classes)}
        paths = {}
        for k, m in models.items():
            v = init_random_params(m, jnp.zeros((1, 3, 64, 64)))
            paths[k] = str(tmp_path / f"{k}.npz")
            j_save(paths[k], v, meta={"preset": "tiny", "overrides": dict(tiny[k])})
        s = RettoSession(SessionConfig(), preset="mobile", charset=chars, weights=paths,
                         device="cpu")
        mods = s.engine.modules()
        assert mods["cls"].arch == "mbv3" and mods["det"].backbone == "tpu"
        assert mods["rec"].LCNetBackbone_0.ConvBNAct_0.Conv_0.out_channels == tiny["rec"]["dims"][0] // 2
        p = s.engine.cls(np.zeros((1, 3, 48, 192), np.float32))
        assert tuple(p.shape) == (1, 2)
        s.close()


@pytest.mark.parametrize("kind", ["det", "cls", "rec"])
def test_port_trained_checkpoint_loads_in_jax(tmp_path, kind):
    """Two port train steps of a tiny float32 model, saved with
    ``save_params``; the JAX package's ``load_params_meta`` reads it and the
    JAX model gives the port's outputs."""
    from retto_tpu.models import build_cls as jc, build_det as jd, build_rec as jr
    from retto_tpu.weights import load_params_meta as j_load

    rng = np.random.default_rng(5)
    if kind == "det":
        model, jm = build_det("tiny", compute_dtype=None), jd("tiny", compute_dtype=None)
        x = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
        gt = [torch.from_numpy(np.stack([a] * 2)) for a in
              db_ground_truth(np.array([[4, 4, 26, 14]], np.float32), 32, 32)]
        loss_fn, rest, forward = db_loss, gt, None
    elif kind == "cls":
        model, jm = build_cls("tiny", compute_dtype=None), jc("tiny", compute_dtype=None)
        x = rng.uniform(-1, 1, (2, 3, 48, 96)).astype(np.float32)
        loss_fn, rest, forward = cls_loss, [torch.tensor([0, 1])], None
    else:
        model = build_rec("tiny", num_classes=12, compute_dtype=None)
        jm = jr("tiny", num_classes=12, compute_dtype=None)
        x = rng.uniform(-1, 1, (2, 3, 48, 64)).astype(np.float32)
        loss_fn = ctc_loss
        rest = [torch.tensor([[1, 2, 0], [3, 0, 0]], dtype=torch.int32),
                torch.tensor([2, 1], dtype=torch.int32)]
        forward = lambda m, v: m(v, return_logits=True)  # noqa: E731
    state = init_train_state(model, 1e-3, device="cpu")
    step = make_train_step(model, loss_fn, forward=forward)
    for _ in range(2):
        state, _ = step(state, torch.from_numpy(x), *rest)
    meta = {"preset": "tiny", "overrides": dict(MODEL_PRESETS["tiny"][kind])}
    save_params(tmp_path / f"{kind}.npz", export_flax_params(model), meta=meta)
    tree, jmeta = j_load(tmp_path / f"{kind}.npz")
    assert jmeta == json.loads(json.dumps(meta))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jm.apply)(tree, jnp.asarray(x)))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
