"""Train and evaluate the 6,625-class recognition head on the synthetic
large-vocabulary charset (``train.bigvocab``), on PyTorch.

Counterpart of ``tools/train_bigvocab.py``, with its flags and meanings:
the reference-scale vocabulary (rec_processor.rs:29-46: 6,623 keys ->
6,625 CTC classes) learned from pseudo-glyph lines, plus crops of
pseudo-glyph pages cut by the shipped det through the port's staged det
stage and inference warp.  The glyphs are procedural (no fonts), so the
tool runs wherever the port does.  Writes ``rec_big.npz`` (Flax layout,
loadable by both packages) and ``charset_big.txt``, and prints the
exact-sequence match on fresh lines and the steps per second.

    python -m retto_tpu_torch.train.train_bigvocab [--steps 9000]
        [--data-n 24576] [--batch 96] [--lr 1e-3] [--pipe-pages 1600]
        [--warm-start] [--device cuda|cpu] [--out DIR]

Differences from the JAX tool:

* ``--device`` (default ``cuda``, which raises without a card) and
  ``--out`` (default ``.torch_build/trained_weights``) are added.  It never
  writes into ``trained_weights/``: it reads ``rec_big.npz`` there for
  ``--warm-start`` and ``det.npz`` for the pipeline pages.
* The rendered sets are cached in ``synth_cache/`` beside ``--out`` (the
  JAX tool uses a fixed temporary directory).
* Besides the loss every 200 steps, it prints how many losses were not
  finite, the steps per second after the first step, and a digest of the
  trained model's outputs on 8 fixed lines (:func:`probe_digest`), which
  a checkpoint reloaded from ``rec_big.npz`` reproduces.
"""

from __future__ import annotations

import argparse
import hashlib
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..image.io import ImageHelper, _pil_resize
from ..models import build_rec
from ..ops.charset import CharacterDict
from ..ops.ctc import ctc_greedy_decode
from ..weights import export_flax_params, load_flax_params, load_params_meta, save_params
from .bigvocab import BIG_NUM_KEYS, big_charset, random_big_text, render_big_line, render_big_page
from .data import RecDeviceData, gather_rec_batch
from .losses import ctc_loss
from .synthetic import OUT, WEIGHTS, _cached, _pipeline_det, warp_crops_like_inference
from .trainer import init_train_state, make_train_step, warmup_cosine_decay

REC_W = 512
REC_H = 48
MAX_LEN = 12
# page sizes of the pipeline set (tools/train_bigvocab.py): the eval's
# 480x640 and small pages whose min-side-736 upscale blur is the hard case
_PAGE_SIZES = [(480, 640), (384, 512), (256, 320), (288, 704)]


def render_dataset(rng: np.random.Generator, n: int):
    """``n`` pseudo-glyph lines at height 48 (a quarter inverted), resized
    to at most 512 wide: (images, labels [n, 12], lengths, texts)."""
    imgs, labels, lengths, texts = [], [], [], []
    for _ in range(n):
        ids, text = random_big_text(rng, BIG_NUM_KEYS, MAX_LEN)
        img = render_big_line(ids, REC_H, rng, invert=rng.random() < 0.25)
        if img.shape[1] > REC_W:
            img = _pil_resize(img, REC_W, REC_H)
        imgs.append(img)
        labels.append(ids + [0] * (MAX_LEN - len(ids)))
        lengths.append(len(ids))
        texts.append(text)
    return imgs, np.asarray(labels), np.asarray(lengths), texts


def render_big_pipeline_dataset(rng: np.random.Generator, n_pages: int, chars: CharacterDict,
                                device: torch.device):
    """Big-vocab crops from the real det pipeline: pseudo-glyph pages cut by
    the shipped det (the port's staged det stage), each box matched to a
    ground-truth line by its centre and warped through the inference
    kernel, so the head trains on what the pipeline feeds it."""
    cfg, stage, eng = _pipeline_det(device)
    imgs, labels, lengths, texts = [], [], [], []
    for i in range(n_pages):
        h, w = _PAGE_SIZES[int(rng.integers(0, len(_PAGE_SIZES)))]
        lh_lo = int(rng.integers(28, 46))
        img, gt_boxes, gt_texts = render_big_page(
            rng, h, w, max_lines=4, lh_range=(lh_lo, min(lh_lo + 22, 64)), max_len=8)
        if not len(gt_boxes):
            continue
        ih = ImageHelper(img)
        ih.resize_both(cfg.max_side_len, cfg.min_side_len)
        ah, aw = ih.size()
        sy, sx = ah / img.shape[0], aw / img.shape[1]
        boxes, _ = stage(ih, eng)
        centers_gt = np.stack([(gt_boxes[:, 0] + gt_boxes[:, 2]) / 2 * sx,
                               (gt_boxes[:, 1] + gt_boxes[:, 3]) / 2 * sy], axis=1)
        matched_boxes, matched_texts = [], []
        for b in boxes:
            c = (b[0] + b[2]) / 2.0
            d = np.linalg.norm(centers_gt - c[None], axis=1)
            j = int(d.argmin())
            if d[j] > (gt_boxes[j, 3] - gt_boxes[j, 1]) * sy:
                continue
            matched_boxes.append(b)
            matched_texts.append(gt_texts[j])
        crops = warp_crops_like_inference(ih, matched_boxes) if matched_boxes else []
        for crop, text in zip(crops, matched_texts):
            if crop is None or crop.shape[0] < 8 or crop.shape[1] < 8:
                continue
            ids = chars.encode(text)[:MAX_LEN]
            imgs.append(crop)
            labels.append(ids + [0] * (MAX_LEN - len(ids)))
            lengths.append(len(ids))
            texts.append(text)
        if (i + 1) % 200 == 0:
            print(f"[big-pipe-render] {i + 1} pages -> {len(imgs)} crops", flush=True)
    return imgs, np.asarray(labels).reshape(-1, MAX_LEN), np.asarray(lengths), texts


def _decode(model: torch.nn.Module, chars: CharacterDict, x: torch.Tensor) -> list[str]:
    with torch.no_grad():
        idx, keep, _ = ctc_greedy_decode(model(x))
    return chars.decode_indices(idx.cpu().numpy(), keep.cpu().numpy())


def probe_digest(model: torch.nn.Module, device: torch.device) -> str:
    """A digest of ``model``'s output probabilities (eval mode) on 8 lines
    rendered from seed 0: equal digests, equal outputs."""
    imgs, labels, lengths, _ = render_dataset(np.random.default_rng(0), 8)
    data = RecDeviceData.build(imgs, labels, lengths, REC_W, device)
    x, _, _ = gather_rec_batch(data, torch.arange(8, device=device))
    with torch.no_grad():
        probs = model(x).float().cpu().numpy()
    return hashlib.sha256(probs.tobytes()).hexdigest()[:16]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m retto_tpu_torch.train.train_bigvocab")
    ap.add_argument("--steps", type=int, default=9000)
    ap.add_argument("--data-n", type=int, default=24576)
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--pipe-pages", type=int, default=1600,
                    help="pages rendered through the REAL det pipeline for "
                         "in-distribution crops (0 disables)")
    ap.add_argument("--warm-start", action="store_true",
                    help="fine-tune from trained_weights/rec_big.npz")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", type=Path, default=OUT,
                    help="directory for rec_big.npz and charset_big.txt "
                         "(default .torch_build/trained_weights)")
    args = ap.parse_args(argv)
    if args.out.resolve() == WEIGHTS.resolve():
        raise SystemExit("--out must not be trained_weights/: the shipped checkpoints stay")
    device = resolve_device(args.device)
    args.out.mkdir(parents=True, exist_ok=True)
    cache = args.out.parent / "synth_cache"

    chars = CharacterDict(big_charset())
    print(f"[big] {chars.num_classes} classes (reference dict scale, rec_processor.rs:37-45)",
          flush=True)
    rng = np.random.default_rng(7)
    print(f"[big] rendering {args.data_n} lines ...", flush=True)

    def _render_lines():
        im, la, ln, _ = render_dataset(rng, args.data_n)
        return im, {"labels": la, "lengths": ln}

    imgs, ex = _cached(cache, "big_lines", args.data_n, _render_lines)
    labels, lengths = ex["labels"], ex["lengths"]
    if args.pipe_pages and (WEIGHTS / "det.npz").exists():
        rng_pipe = np.random.default_rng(7 + 501)

        def _render_pipe():
            print(f"[big] extracting pipeline crops from {args.pipe_pages} pages ...",
                  flush=True)
            im, la, ln, _ = render_big_pipeline_dataset(rng_pipe, args.pipe_pages, chars,
                                                        device)
            return im, {"labels": la, "lengths": ln}

        pi, pex = _cached(cache, "big_pipe", args.pipe_pages, _render_pipe)
        if len(pi):
            imgs = imgs + pi
            labels = np.concatenate([labels, pex["labels"]])
            lengths = np.concatenate([lengths, pex["lengths"]])
        print(f"[big] +{len(pi)} pipeline crops = {len(imgs)}", flush=True)
    data = RecDeviceData.build(imgs, labels, lengths, REC_W, device)

    model = build_rec("mobile", num_classes=chars.num_classes, compute_dtype="bfloat16")
    if args.warm_start and (WEIGHTS / "rec_big.npz").exists():
        load_flax_params(model, load_params_meta(WEIGHTS / "rec_big.npz")[0])
        print("[big] warm start from trained_weights/rec_big.npz", flush=True)
    warm = min(300, max(args.steps // 10, 1))
    state = init_train_state(model, warmup_cosine_decay(args.lr, warm, max(args.steps, warm + 1)),
                             device=device)
    step = make_train_step(model, ctc_loss, forward=lambda m, x: m(x, return_logits=True))

    # multi-width training (tools/train_bigvocab.py): each step at a sampled
    # inference width bucket, from the pool whose content fits and whose CTC
    # alignment is feasible at T = w / 8 frames
    width_buckets = (320, 384, 448, 512)
    width_probs = (0.25, 0.15, 0.15, 0.45)
    widths_np = data.widths.cpu().numpy()
    lengths_np = data.lengths.cpu().numpy()
    pools = {w: np.where((widths_np <= w) & (1.5 * lengths_np + 2 <= w // 8))[0]
             for w in width_buckets}
    keep = [i for i, w in enumerate(width_buckets) if len(pools[w]) >= args.batch]
    width_buckets = tuple(width_buckets[i] for i in keep)
    p = np.asarray([width_probs[i] for i in keep])
    width_probs = tuple(p / p.sum())
    print(f"[big] width buckets {width_buckets} pool sizes "
          f"{[len(pools[w]) for w in width_buckets]}", flush=True)

    t0 = time.time()
    t1 = t0
    nonfinite = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(args.steps):
        w = int(rng.choice(width_buckets, p=width_probs))
        pool = pools[w]
        idx = torch.from_numpy(pool[rng.integers(0, len(pool), args.batch)]).to(device)
        x, lab, ln = gather_rec_batch(data, idx)
        state, loss = step(state, x[:, :, :, :w], lab, ln)
        nonfinite += ~torch.isfinite(loss)
        if i % 200 == 0 or i == args.steps - 1:
            print(f"[big] step {i}: loss {float(loss):.4f} ({time.time() - t0:.0f}s)",
                  flush=True)
        if i == 0:
            t1 = time.time()  # after the first step's sync: warm from here
    t_end = time.time()
    rate = (args.steps - 1) / (t_end - t1) if args.steps > 1 else float("nan")
    print(f"[big] non-finite losses: {int(nonfinite)} of {args.steps}; "
          f"steps_per_s {rate:.4f} over steps 1-{args.steps - 1} at batch {args.batch}",
          flush=True)

    # fresh-sample eval: exact sequence match + per-char accuracy
    model.eval()
    n_eval, bs = 256, 64
    ei, el, eln, etexts = render_dataset(rng, n_eval)
    ed = RecDeviceData.build(ei, el, eln, REC_W, device)
    n_exact = n_chars = n_chars_ok = 0
    for s0 in range(0, n_eval, bs):
        x, _, _ = gather_rec_batch(ed, torch.arange(s0, s0 + bs, device=device))
        for pr, t in zip(_decode(model, chars, x), etexts[s0:s0 + bs]):
            n_exact += int(pr == t)
            n_chars += len(t)
            n_chars_ok += sum(a == b for a, b in zip(pr, t))
    print(f"[big] exact-sequence match on {n_eval} fresh lines: {n_exact / n_eval:.4f}")
    print(f"[big] per-char accuracy: {n_chars_ok / max(n_chars, 1):.4f}")
    # narrow-bucket spot check (pad-robustness across sequence lengths)
    nar = np.where(ed.widths.cpu().numpy() <= 320)[0][:64]
    if len(nar):
        x, _, _ = gather_rec_batch(ed, torch.from_numpy(nar).to(device))
        preds = _decode(model, chars, x[:, :, :, :320])
        accn = np.mean([preds[j] == etexts[q] for j, q in enumerate(nar)])
        print(f"[big] exact match at w=320 on {len(nar)} narrow lines: {accn:.4f}")
    print(f"[big] probe_digest {probe_digest(model, device)}", flush=True)
    save_params(args.out / "rec_big.npz", export_flax_params(model),
                meta={"preset": "mobile", "overrides": {}})
    (args.out / "charset_big.txt").write_text("\n".join(chars.chars[1:-1]), encoding="utf-8")
    print(f"[big] saved rec_big.npz + charset_big.txt ({chars.num_classes} classes) "
          f"in {args.out}", flush=True)


if __name__ == "__main__":
    main()
