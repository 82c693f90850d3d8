"""Write retto_tpu_torch/testdata/smoke_pages.npz: the pages and the JAX
reference outputs that ``chip_smoke.py`` and tests/test_torch_pipeline.py
hold the port to.

Pages: 8 gray 960x704 pages from ``retto_tpu.train.synth.render_page`` with
``np.random.default_rng(0)`` (the bench.py config-3 recipe, bench.py:127-132).
Reference: the JAX ``DevicePipeline`` on the CPU with the mobile checkpoints
``trained_weights/{det,cls,rec}.npz`` and ``transfer_format="yuv420"``:

* ``jax_*``        the 8 gray pages (they take the ``gray`` plane format);
* ``jax_tinted_*`` page 0 tinted by ``tint`` (numpy, per channel), which
                   takes the ``yuv420`` format;
* ``jax_rotated_*`` page 2 tinted and rotated by ``rotate_deg``
                   (``scipy.ndimage.rotate``, order 1, white fill): rotated
                   quads take the gather warp, upside-down lines the cls flip;
* ``jax_rgb_*``    page 1 through a session with ``transfer_format="rgb"``.

Each reference is flat: ``*_page`` (page index per line), ``*_boxes``
([n, 4, 2] quads in page coordinates) and ``*_texts``.  Ground truth is
``gt_page``/``gt_boxes`` (xyxy)/``gt_texts``.

``retto_tpu_torch/testdata/smoke_staged.npz`` holds the staged references:
the JAX ``RettoSession.run`` (mobile checkpoints, CPU) in each mode, as
``{compat,performance}_{page,boxes,texts,det_scores,rec_scores}``, over
the 8 gray pages (ids 0-7), the tinted page 0 (id 8) and the tinted and
rotated page 2 (id 9).

``retto_tpu_torch/testdata/smoke_train.npz`` holds the training batches and
the JAX trainer's losses on them (``--train``): from the shipped mobile
``rec.npz``, ``cls.npz`` and ``det.npz`` with bf16 compute, a fixed batch
per target from tools/train_synthetic.py's renderers (16 rec lines at
48x512 as ``rec_lines``/``rec_widths``/``rec_labels``/``rec_lengths``; 16
cls crops at 48x192 in both orientations with their rotations as
``cls_lines``/``cls_widths``/``cls_rot``; 2 det pages at 512x512 with their
boxes as ``det_pages``/``det_boxes``), and ``{rec,cls,det}_losses``: the
losses of 4 steps with no augmentation under the tool's AdamW schedule for
3 steps (``warmup_cosine_decay(0, lr, 1, 3)``, weight decay 1e-4, the
tool's rates in ``{kind}_lr``).  The first and the fourth update run at
rate 0, so loss 1 (= loss 2) is the shipped weights' and losses 3 and 4
read the two real updates; ``{kind}_delta_norm`` is the L2 norm of the
change of all parameters over the 4 steps.  The rec lines are turned 180
degrees within their widths (the crops that the cls stage flips before
the rec sees them): on its own upright lines the shipped rec's loss is
8e-4, where bf16 roundoff moves it by several percent and decides the
sign of many gradients; on the turned lines it is O(100) and the update
is the gradient's, not the roundoff's.

``retto_tpu_torch/testdata/smoke_presets.npz`` holds the presets the port
already has and checks nowhere else (``--presets``): ``server_*``, the JAX
``DevicePipeline`` over the 8 gray pages with ``det_server.npz``,
``rec_server.npz`` and ``cls.npz`` (flat as the ``jax_*`` entries); and
``big_*``, the big-vocab rec alone (``rec_big.npz``, ``charset_big.txt``,
6,625 classes) on 16 rendered big-vocab lines at 48x320 (``big_crops``,
``big_widths``; ``big_gt`` the rendered texts, ``big_texts`` JAX's reading).

``retto_tpu_torch/testdata/smoke_onnx.npz`` holds the ONNX path's
references (``--onnx``): the JAX ``OnnxEngine`` over the three full-size
Paddle-export replicas (``weights/replica.py``: det seed 11, cls 12, rec
13 with 6,625 classes; random weights at matched scales, the det with its
ink scaffold) and ``charset_big.txt``, on the CPU with
``transfer_format="yuv420"`` and :func:`onnx_det_config`'s det thresholds:
``fused_*``, its ``DevicePipeline`` over the 8 gray pages (ids 0-7) and
the tinted and rotated page 2 (id 8); and ``compat_*``, the staged COMPAT
``RettoSession.run`` over the 10 staged inputs (flat as the ``jax_*``
entries).

Run from the repository root (JAX on the CPU, a few minutes; ``--staged``,
``--train``, ``--presets`` and ``--onnx`` write only that file):

    JAX_PLATFORMS=cpu python tools/make_torch_smoke_fixture.py [--staged|--train|--presets|--onnx]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OUT = ROOT / "retto_tpu_torch" / "testdata" / "smoke_pages.npz"
STAGED_OUT = OUT.with_name("smoke_staged.npz")
TRAIN_OUT = OUT.with_name("smoke_train.npz")
PRESETS_OUT = OUT.with_name("smoke_presets.npz")
ONNX_OUT = OUT.with_name("smoke_onnx.npz")
TRAIN_LR = {"rec": 1.2e-3, "cls": 1e-3, "det": 8e-4}  # tools/train_synthetic.py
TINT = np.asarray([1.0, 0.94, 0.86], np.float32)
ROTATE_DEG = 176.0


def tint_page(gray: np.ndarray, tint: np.ndarray = TINT) -> np.ndarray:
    """Gray [H, W] u8 -> RGB [H, W, 3] u8 scaled per channel (chroma != 0)."""
    return np.rint(gray[..., None].astype(np.float32) * tint).astype(np.uint8)


def rotate_page(rgb: np.ndarray, deg: float = ROTATE_DEG) -> np.ndarray:
    from scipy import ndimage

    return ndimage.rotate(rgb, deg, reshape=False, order=1, cval=255)


def _flat(results, pages_idx):
    page, boxes, texts = [], [], []
    for p, r in zip(pages_idx, results):
        for b, t in zip(r.det_result, r.rec_result):
            page.append(p)
            boxes.append(np.asarray(b.box.pts, np.float32))
            texts.append(t.text)
    return (np.asarray(page, np.int32), np.asarray(boxes, np.float32).reshape(-1, 4, 2),
            np.asarray(texts, dtype=str))


def staged_pages(pages: np.ndarray) -> list[np.ndarray]:
    """The 10 staged inputs: gray pages 0-7, tinted page 0, rotated page 2."""
    rgb = [np.repeat(p[..., None], 3, axis=2) for p in pages]
    return rgb + [tint_page(pages[0]), rotate_page(tint_page(pages[2]))]


def write_staged(pages: np.ndarray) -> None:
    from retto_tpu.config import PipelineMode, SessionConfig
    from retto_tpu.ops.charset import CharacterDict
    from retto_tpu.pipeline.session import RettoSession

    wd = ROOT / "trained_weights"
    chars = CharacterDict((wd / "charset.txt").read_text().splitlines())
    weights = {k: str(wd / f"{k}.npz") for k in ("det", "cls", "rec")}
    inputs = staged_pages(pages)
    out = {}
    for mode in ("compat", "performance"):
        session = RettoSession(SessionConfig(mode=PipelineMode(mode)), preset="mobile",
                               charset=chars, weights=weights)
        res = [session.run(x) for x in inputs]
        page, boxes, texts = _flat(res, range(len(inputs)))
        out[f"{mode}_page"], out[f"{mode}_boxes"], out[f"{mode}_texts"] = page, boxes, texts
        out[f"{mode}_det_scores"] = np.asarray(
            [b.score for r in res for b in r.det_result], np.float32)
        out[f"{mode}_rec_scores"] = np.asarray(
            [t.score for r in res for t in r.rec_result], np.float32)
        print(f"staged {mode}: {len(texts)} lines over {len(inputs)} pages")
    np.savez_compressed(STAGED_OUT, **out)
    print(f"wrote {STAGED_OUT.relative_to(ROOT)} ({STAGED_OUT.stat().st_size} bytes)")


def _jax_model(kind: str, name: str, **extra):
    """A JAX model built from checkpoint ``name``'s self-description (bf16)
    and its variables."""
    from retto_tpu.models import build_cls, build_det, build_rec
    from retto_tpu.weights import load_params_meta

    tree, meta = load_params_meta(ROOT / "trained_weights" / name)
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["overrides"].items()}
    build = {"det": build_det, "cls": build_cls, "rec": build_rec}[kind]
    return build(meta["preset"], compute_dtype="bfloat16", **extra, **kw), tree


def _jax_losses(model, tree, lr: float, batch_fn, loss_fn, apply=None):
    """(losses, delta_norm): the losses of 4 steps on one batch under the
    tool's AdamW schedule for 3 steps, and the L2 norm of the parameters'
    change over them."""
    import jax
    import jax.numpy as jnp
    import optax

    from retto_tpu.train.trainer import TrainState, make_train_step

    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, 1, 3), weight_decay=1e-4)
    state = TrainState(tree["params"], tx.init(tree["params"]), tree["batch_stats"], 0)
    step = make_train_step(apply or model, loss_fn, tx)
    losses = []
    for _ in range(4):
        state, loss = step(state, *batch_fn())
        losses.append(float(loss))
    sq = jax.tree_util.tree_map(lambda a, b: jnp.sum(jnp.square(a - b)), state.params,
                                tree["params"])
    return (np.asarray(losses, np.float32),
            np.float32(np.sqrt(sum(float(v) for v in jax.tree_util.tree_leaves(sq)))))


def write_train() -> None:
    import jax.numpy as jnp

    from retto_tpu.train.data import (
        ClsDeviceData, DetDeviceData, RecDeviceData, gather_cls_batch, gather_det_batch,
        gather_rec_batch,
    )
    from retto_tpu.train.losses import ctc_loss, db_loss
    from tools.train_synthetic import (
        CHARS, _render_cls_lines, render_det_dataset, render_rec_dataset,
    )

    out = {}
    rng = np.random.default_rng(100)
    imgs, labels, lengths, _ = render_rec_dataset(rng, 16)
    imgs = [np.ascontiguousarray(im[::-1, ::-1]) for im in imgs]
    rd = RecDeviceData.build(imgs, labels, lengths, 512)
    model, tree = _jax_model("rec", "rec.npz", num_classes=CHARS.num_classes)

    def apply(variables, x, train=False, mutable=None):
        return model.apply(variables, x, train=train, mutable=mutable, return_logits=True)

    out.update(rec_lines=np.asarray(rd.lines), rec_widths=np.asarray(rd.widths),
               rec_labels=np.asarray(rd.labels), rec_lengths=np.asarray(rd.lengths),
               rec_losses=_jax_losses(model, tree, TRAIN_LR["rec"],
                                      lambda: gather_rec_batch(rd, jnp.arange(16)),
                                      ctc_loss, apply))
    out["rec_losses"], out["rec_delta_norm"] = out["rec_losses"]

    cd = ClsDeviceData.build(_render_cls_lines(rng, 16), 192)
    rot = jnp.asarray(rng.integers(0, 2, 16))
    model, tree = _jax_model("cls", "cls.npz")

    def cls_batch():
        x, lab = gather_cls_batch(cd, jnp.arange(16), rot)
        x_opp, _ = gather_cls_batch(cd, jnp.arange(16), 1 - rot)
        return jnp.concatenate([x, x_opp]), lab

    def cls_sym_loss(probs, lab):  # tools/train_synthetic.py::_cls_fit
        nb = lab.shape[0]
        p1, p2 = probs[:nb], probs[nb:]
        p_sym = 0.5 * (p1 + p2[:, ::-1])
        eps, sm = 1e-8, 0.02
        onehot = jnp.eye(2)[lab] * (1 - sm) + sm / 2
        loss_sym = -(onehot * jnp.log(p_sym + eps)).sum(-1).mean()
        loss_view = (-(onehot * jnp.log(p1 + eps)).sum(-1).mean()
                     - (onehot[:, ::-1] * jnp.log(p2 + eps)).sum(-1).mean())
        return loss_sym + 0.25 * loss_view

    out.update(cls_lines=np.asarray(cd.lines), cls_widths=np.asarray(cd.widths),
               cls_rot=np.asarray(rot, np.int32),
               cls_losses=_jax_losses(model, tree, TRAIN_LR["cls"], cls_batch, cls_sym_loss))
    out["cls_losses"], out["cls_delta_norm"] = out["cls_losses"]

    pages, boxes = render_det_dataset(rng, 2)
    dd = DetDeviceData.build(pages, boxes)
    model, tree = _jax_model("det", "det.npz")
    out.update(det_pages=np.asarray(dd.pages), det_boxes=np.asarray(dd.boxes),
               det_losses=_jax_losses(
                   model, tree, TRAIN_LR["det"],
                   lambda: gather_det_batch(dd, jnp.arange(2), out_stride=model.out_stride),
                   db_loss))
    out["det_losses"], out["det_delta_norm"] = out["det_losses"]
    for kind, lr in TRAIN_LR.items():
        out[f"{kind}_lr"] = np.float32(lr)
        print(f"train {kind}: losses {out[f'{kind}_losses'].tolist()}, "
              f"delta norm {float(out[f'{kind}_delta_norm'])}")
    np.savez_compressed(TRAIN_OUT, **out)
    print(f"wrote {TRAIN_OUT.relative_to(ROOT)} ({TRAIN_OUT.stat().st_size} bytes)")


def write_presets(pages: np.ndarray) -> None:
    import jax.numpy as jnp
    from PIL import Image

    from retto_tpu.config import SessionConfig
    from retto_tpu.ops.charset import CharacterDict
    from retto_tpu.ops.ctc import ctc_greedy_decode
    from retto_tpu.pipeline.session import RettoSession
    from retto_tpu.train.bigvocab import BIG_NUM_KEYS, random_big_text, render_big_line

    wd = ROOT / "trained_weights"
    out = {}
    chars = CharacterDict((wd / "charset.txt").read_text().splitlines())
    weights = {"det": str(wd / "det_server.npz"), "cls": str(wd / "cls.npz"),
               "rec": str(wd / "rec_server.npz")}
    cfg = SessionConfig()
    cfg.engine.transfer_format = "yuv420"
    dp = RettoSession(cfg, preset="server", charset=chars, weights=weights).device_pipeline()
    res = dp.run_many([np.repeat(p[..., None], 3, axis=2) for p in pages])
    out["server_page"], out["server_boxes"], out["server_texts"] = _flat(res, range(len(pages)))
    dp.close()
    print(f"presets server: {len(out['server_texts'])} lines")

    big = CharacterDict((wd / "charset_big.txt").read_text(encoding="utf-8").splitlines())
    rng = np.random.default_rng(7)
    crops = np.zeros((16, 48, 320, 3), np.uint8)
    widths, gt = np.zeros(16, np.int32), []
    for i in range(16):
        ids, text = random_big_text(rng, BIG_NUM_KEYS, max_len=7)
        line = render_big_line(ids, 48, rng)
        w = min(line.shape[1], 320)
        if line.shape[1] != w:
            line = np.asarray(Image.fromarray(line).resize((w, 48), Image.BILINEAR))
        crops[i, :, :w], widths[i] = line, w
        gt.append(text)
    x = (crops.astype(np.float32) / 255.0 - 0.5) / 0.5
    x = np.where(np.arange(320)[None, None, :, None] < widths[:, None, None, None], x, 0.0)
    model, tree = _jax_model("rec", "rec_big.npz", num_classes=big.num_classes)
    probs = model.apply(tree, jnp.asarray(np.transpose(x, (0, 3, 1, 2))))
    idx, keep, _ = ctc_greedy_decode(probs)
    texts = big.decode_indices(np.asarray(idx), np.asarray(keep))
    out.update(big_crops=crops, big_widths=widths, big_gt=np.asarray(gt, dtype=str),
               big_texts=np.asarray(texts, dtype=str))
    print(f"presets big-vocab rec: {sum(a == b for a, b in zip(texts, gt))}/16 lines read right")
    np.savez_compressed(PRESETS_OUT, **out)
    print(f"wrote {PRESETS_OUT.relative_to(ROOT)} ({PRESETS_OUT.stat().st_size} bytes)")


def onnx_det_config(cfg):
    """The det settings of the ONNX references: the replica det's random
    layers plus its ink scaffold score a glyph body at 0.3-0.5 and a text
    line's box well below the default ``box_thresh`` of 0.6, so the boxes
    are kept from 0.2 and the mask is dilated (chip_smoke.py phase onnx
    sets the same)."""
    cfg.det.box_thresh = 0.2
    cfg.det.use_dilation = True
    return cfg


def write_onnx(pages: np.ndarray) -> None:
    from retto_tpu.config import PipelineMode, SessionConfig
    from retto_tpu.ops.charset import CharacterDict
    from retto_tpu.pipeline.onnx_engine import OnnxEngine
    from retto_tpu.pipeline.session import RettoSession
    from retto_tpu.weights.replica import (
        build_cls_replica,
        build_det_replica,
        build_rec_replica,
    )

    wd = ROOT / "trained_weights"
    chars = CharacterDict((wd / "charset_big.txt").read_text(encoding="utf-8").splitlines())
    engine = OnnxEngine(det=build_det_replica(), cls=build_cls_replica(),
                        rec=build_rec_replica())
    out = {}
    cfg = onnx_det_config(SessionConfig())
    cfg.engine.transfer_format = "yuv420"
    session = RettoSession(cfg, engine=engine, charset=chars)
    inputs = [np.repeat(p[..., None], 3, axis=2) for p in pages]
    inputs.append(rotate_page(tint_page(pages[2])))
    res = session.device_pipeline().run_many(inputs)
    out["fused_page"], out["fused_boxes"], out["fused_texts"] = _flat(res, range(len(inputs)))
    session.close()
    print(f"onnx fused: {len(out['fused_texts'])} lines over {len(inputs)} pages")
    session = RettoSession(onnx_det_config(SessionConfig(mode=PipelineMode.COMPAT)),
                           engine=engine, charset=chars)
    staged = staged_pages(pages)
    res = [session.run(x) for x in staged]
    out["compat_page"], out["compat_boxes"], out["compat_texts"] = _flat(res, range(len(staged)))
    print(f"onnx staged compat: {len(out['compat_texts'])} lines over {len(staged)} pages")
    np.savez_compressed(ONNX_OUT, **out)
    print(f"wrote {ONNX_OUT.relative_to(ROOT)} ({ONNX_OUT.stat().st_size} bytes)")


def main() -> None:
    if "--onnx" in sys.argv[1:]:
        write_onnx(np.load(OUT)["pages"])
        return
    if "--staged" in sys.argv[1:]:
        write_staged(np.load(OUT)["pages"])
        return
    if "--train" in sys.argv[1:]:
        write_train()
        return
    if "--presets" in sys.argv[1:]:
        write_presets(np.load(OUT)["pages"])
        return
    from retto_tpu.config import SessionConfig
    from retto_tpu.ops.charset import CharacterDict
    from retto_tpu.pipeline.session import RettoSession
    from retto_tpu.train.synth import render_page

    wd = ROOT / "trained_weights"
    chars = CharacterDict((wd / "charset.txt").read_text().splitlines())
    weights = {k: str(wd / f"{k}.npz") for k in ("det", "cls", "rec")}
    rng = np.random.default_rng(0)
    rendered = [render_page(rng, chars, h=960, w=704, max_lines=6, lh_range=(24, 48))
                for _ in range(8)]
    pages = np.stack([img[..., 0] for img, _, _ in rendered])
    assert all((img == img[..., :1]).all() for img, _, _ in rendered)
    gt_page = np.asarray([p for p, (_, b, _) in enumerate(rendered) for _ in b], np.int32)
    gt_boxes = np.concatenate([b for _, b, _ in rendered]).astype(np.float32)
    gt_texts = np.asarray([t for _, _, ts in rendered for t in ts], dtype=str)

    out = dict(pages=pages, gt_page=gt_page, gt_boxes=gt_boxes, gt_texts=gt_texts,
               tint=TINT, rotate_deg=np.float32(ROTATE_DEG))
    for transfer in ("yuv420", "rgb"):
        cfg = SessionConfig()
        cfg.engine.transfer_format = transfer
        dp = RettoSession(cfg, preset="mobile", charset=chars,
                          weights=weights).device_pipeline()
        if transfer == "yuv420":
            rgb = [np.repeat(p[..., None], 3, axis=2) for p in pages]
            res = dp.run_many(rgb)
            out["jax_page"], out["jax_boxes"], out["jax_texts"] = _flat(res, range(8))
            res = dp.run_many([tint_page(pages[0]), rotate_page(tint_page(pages[2]))])
            (out["jax_tinted_page"], out["jax_tinted_boxes"],
             out["jax_tinted_texts"]) = _flat(res[:1], [0])
            (out["jax_rotated_page"], out["jax_rotated_boxes"],
             out["jax_rotated_texts"]) = _flat(res[1:], [2])
        else:
            res = dp.run_many([np.repeat(pages[1][..., None], 3, axis=2)])
            out["jax_rgb_page"], out["jax_rgb_boxes"], out["jax_rgb_texts"] = _flat(res, [1])
        dp.close()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **out)
    hits = sum(t in set(gt_texts) for t in out["jax_texts"])
    print(f"wrote {OUT.relative_to(ROOT)} ({OUT.stat().st_size} bytes): "
          f"{len(gt_texts)} gt lines, {len(out['jax_texts'])} JAX lines, "
          f"{hits} JAX lines equal to a ground-truth line")
    write_staged(pages)
    write_train()
    write_presets(pages)
    write_onnx(pages)


if __name__ == "__main__":
    main()
