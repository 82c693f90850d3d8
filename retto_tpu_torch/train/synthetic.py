"""Train the three pipeline models from scratch on synthetic rendered text.

Counterpart of ``tools/train_synthetic.py`` on PyTorch, with its names:
``train_rec``, ``train_cls``, ``train_det`` and ``main`` with its flags.
Datasets are rendered on the host once, put on the device once
(``train.data``), and every train step gathers, augments and trains on the
device.

    python -m retto_tpu_torch.train.synthetic [rec|cls|det|all|render]
        [--device cuda|cpu] [--out DIR] [--preset mobile|server|tiny]
        [--steps N] [--steps-scale S] [--batch B] [--lr LR]
        [--pipe-pages N] [--data-cache DIR] [--warm-start]

Differences from the JAX tool:

* ``--device`` (default ``cuda``, which raises without a card) and
  ``--out`` (default ``.torch_build/trained_weights``).  The checkpoints it
  writes are Flax-layout ``.npz`` files that both packages load.  It never
  writes into ``trained_weights/``: it reads that directory for
  ``--warm-start`` and for the det that the pipeline-rendered crop sets
  run (the port's det stage and inference warp).
* ``--pipe-pages N`` renders N pages for each pipeline crop set in place
  of the JAX tool's sizes (4,800 rec and 2,400 cls pages when training,
  those times ``--steps-scale`` for ``render``).  It is the one flag the
  JAX tool lacks besides ``--device`` and ``--out``; every other flag
  means what it means there.
* The JAX tool's ``--cpu`` (pin JAX to the CPU) is ``--device cpu`` here.
"""

from __future__ import annotations

import argparse
import io as _io
import math
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..image.io import _pil_resize
from ..models import MODEL_PRESETS, build_cls, build_det, build_rec
from ..models.common import cast_compute
from ..ops.charset import CharacterDict, ascii_charset
from ..ops.ctc import ctc_greedy_decode
from ..weights import export_flax_params, load_flax_params, load_params_meta, save_params
from .data import (
    ClsDeviceData,
    DetDeviceData,
    RecDeviceData,
    gather_cls_batch,
    gather_det_batch,
    gather_rec_batch,
)
from .losses import ctc_loss, db_loss
from .synth import (
    cls_text,
    confusion_text,
    default_font,
    downsample_2tap,
    natural_text,
    random_text,
    render_line,
    render_page,
    render_page_natural,
)
from .trainer import init_train_state, make_train_step, warmup_cosine_decay

REPO = Path(__file__).resolve().parents[2]
WEIGHTS = REPO / "trained_weights"  # read only: warm starts, the pipeline det
OUT = REPO / ".torch_build" / "trained_weights"
CHARS = CharacterDict(ascii_charset())
REC_W = 512
REC_H = 48
DET_S = 512
REC_PIPE_PAGES = 4800
CLS_PIPE_PAGES = 2400


def _fonts_cycle(rng):
    return int(rng.integers(0, 4))


def _jpeg_degrade(rng, img, p=0.15):
    """With probability ``p``, round-trip the image through JPEG at quality
    40-85 (block/ringing artifacts, the held-out noise_jpeg condition)."""
    if rng.random() >= p:
        return img
    from PIL import Image

    q = int(rng.integers(40, 86))
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=q)
    return np.asarray(Image.open(buf).convert("RGB"), np.uint8)


def render_rec_dataset(rng, n):
    """``n`` rendered lines: 35% natural text, 25% confusable glyphs, 40%
    uniform random; 40% rendered taller and 2-tap downscaled (the inference
    warp's kernel); lines wider than 512 squashed as inference does."""
    imgs, labels, lengths, texts = [], [], [], []
    max_len = 16
    usable = CHARS.chars[1:-1]
    for _ in range(n):
        r = rng.random()
        if r < 0.35:
            text = natural_text(rng)
        elif r < 0.60:
            text = confusion_text(rng)
        else:
            text = random_text(rng, usable, max_len)
        text = text[:max_len]
        fg, bg = ((255, 255, 255), (0, 0, 0)) if rng.random() < 0.3 else ((0, 0, 0), (255, 255, 255))
        sz = int(rng.integers(26, 44))
        stroke = 1 if rng.random() < 0.2 else 0
        if rng.random() < 0.4:
            f = float(rng.uniform(1.3, 2.8))
            img = render_line(text, int(REC_H * f),
                              font=default_font(int(sz * f), _fonts_cycle(rng)),
                              fg=fg, bg=bg, stroke_width=stroke)
            img = downsample_2tap(img, REC_H, max(int(round(img.shape[1] / f)), 8))
        else:
            img = render_line(text, REC_H, font=default_font(sz, _fonts_cycle(rng)),
                              fg=fg, bg=bg, stroke_width=stroke)
        if img.shape[1] > REC_W:
            img = _pil_resize(img, REC_W, REC_H)
        ids = CHARS.encode(text)[:max_len]
        imgs.append(_jpeg_degrade(rng, img))
        labels.append(ids + [0] * (max_len - len(ids)))
        lengths.append(len(ids))
        texts.append(text)
    return imgs, np.asarray(labels), np.asarray(lengths), texts


def _save_ragged(path: Path, imgs: list, **arrays) -> None:
    """Cache a list of HxWx3 uint8 images (ragged shapes) and extra arrays
    as one flat byte buffer with per-image shapes."""
    hs = np.asarray([im.shape[0] for im in imgs], np.int32)
    ws = np.asarray([im.shape[1] for im in imgs], np.int32)
    flat = np.concatenate([np.asarray(im, np.uint8).reshape(-1) for im in imgs])
    np.savez_compressed(path, flat=flat, hs=hs, ws=ws, **arrays)


def _load_ragged(path: Path):
    z = np.load(path)
    hs, ws = z["hs"], z["ws"]
    if "flat" in z.files:
        flat = z["flat"]
        offs = np.concatenate([[0], np.cumsum(hs.astype(np.int64) * ws * 3)])
        imgs = [flat[offs[i]:offs[i + 1]].reshape(hs[i], ws[i], 3) for i in range(len(hs))]
    else:  # the JAX tool's older dense layout
        buf = z["buf"]
        imgs = [buf[i, :hs[i], :ws[i]] for i in range(len(hs))]
    extras = {k: z[k] for k in z.files if k not in ("buf", "flat", "hs", "ws")}
    return imgs, extras


def _cached(cache_dir: Path | None, name: str, key: int, render_fn):
    """Load ``{cache_dir}/{name}.npz`` if present and its ``key`` matches,
    else call ``render_fn()`` (-> (imgs, extras dict)) and cache the result
    (written to a temporary file, then renamed).  A torn or corrupt cache
    is a miss."""
    path = None if cache_dir is None else cache_dir / f"{name}.npz"
    if path is not None and path.exists():
        try:
            imgs, extras = _load_ragged(path)
            if int(extras.pop("cache_key")) == key:
                print(f"[cache] loaded {len(imgs)} images from {path}", flush=True)
                return imgs, extras
            print(f"[cache] {path} key mismatch; re-rendering", flush=True)
        except Exception as e:  # noqa: BLE001 - a corrupt/partial cache is a miss
            print(f"[cache] {path} unreadable ({e}); re-rendering", flush=True)
    imgs, extras = render_fn()
    if path is not None and len(imgs):
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.npz")
        _save_ragged(tmp, imgs, cache_key=np.int64(key), **extras)
        os.replace(tmp, path)
        print(f"[cache] saved {len(imgs)} images -> {path}", flush=True)
    return imgs, extras


def _pipeline_det(device: torch.device):
    """The shipped det (``trained_weights/det.npz``) in the port's staged
    det stage, for the pipeline-rendered crop sets."""
    from ..config import SessionConfig
    from ..models.registry import torch_dtype
    from ..pipeline.engine import TorchEngine
    from ..pipeline.stages import DetStage

    flat, meta = load_params_meta(WEIGHTS / "det.npz")
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["overrides"].items()}
    model = load_flax_params(build_det("bare", compute_dtype="bfloat16", **kw), flat)
    model = cast_compute(model, torch_dtype("bfloat16")).to(device).eval()
    cfg = SessionConfig()
    return cfg, DetStage(cfg.det, cfg.buckets), TorchEngine(det_model=model, device=device)


def prepare_rec_data(data_n, seed, data_cache: Path | None, device: torch.device,
                     pipe_pages: int = REC_PIPE_PAGES):
    """Rec training set = rendered lines + pipeline crops, each cached on
    its own rng stream."""
    rng_render = np.random.default_rng(seed)
    rng_pipe = np.random.default_rng(seed + 501)

    def _render_lines():
        print(f"[rec] rendering {data_n} lines ...", flush=True)
        im, la, ln, _ = render_rec_dataset(rng_render, data_n)
        return im, {"labels": la, "lengths": ln}

    imgs, ex = _cached(data_cache, "rec_lines", data_n, _render_lines)
    labels, lengths = ex["labels"], ex["lengths"]
    if pipe_pages > 0 and (WEIGHTS / "det.npz").exists():

        def _render_pipe():
            print("[rec] extracting pipeline crops ...", flush=True)
            im, la, ln, _ = render_rec_pipeline_dataset(rng_pipe, pipe_pages, device)
            return im, {"labels": la, "lengths": ln}

        pi, pex = _cached(data_cache, "rec_pipe", pipe_pages, _render_pipe)
        if len(pi):
            imgs = imgs + pi
            labels = np.concatenate([labels, pex["labels"]])
            lengths = np.concatenate([lengths, pex["lengths"]])
        print(f"[rec] +{len(pi)} pipeline crops = {len(imgs)}", flush=True)
    return imgs, labels, lengths


def _ckpt_name(kind: str, preset: str) -> str:
    """mobile keeps the bare names (det.npz, ...); other tiers a suffix."""
    return f"{kind}.npz" if preset == "mobile" else f"{kind}_{preset}.npz"


def _warm_start(model: torch.nn.Module, name: str, tag: str) -> None:
    flat, _ = load_params_meta(WEIGHTS / name)
    load_flax_params(model, flat)
    print(f"[{tag}] warm start from trained_weights/{name}", flush=True)


def _schedule(steps: int, lr: float):
    warm = min(200, max(steps // 10, 1))
    return warmup_cosine_decay(lr, warm, max(steps, warm + 1))


def _generator(device: torch.device, rng) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(rng.integers(0, 2 ** 31)))


def train_rec(steps=16000, batch=128, lr=1.2e-3, data_n=32768, seed=0,
              data_cache: Path | None = None, warm_start: bool = False,
              preset: str = "mobile", device: str | torch.device = "cuda",
              out: Path = OUT, pipe_pages: int = REC_PIPE_PAGES):
    device = resolve_device(device)
    rng = np.random.default_rng(seed + 1009)
    imgs, labels, lengths = prepare_rec_data(data_n, seed, data_cache, device, pipe_pages)
    data = RecDeviceData.build(imgs, labels, lengths, REC_W, device)

    ckpt = _ckpt_name("rec", preset)
    model = build_rec(preset, num_classes=CHARS.num_classes, compute_dtype="bfloat16")
    if warm_start and (WEIGHTS / ckpt).exists():
        _warm_start(model, ckpt, "rec")
    state = init_train_state(model, _schedule(steps, lr), device=device)
    step = make_train_step(model, ctc_loss, forward=lambda m, x: m(x, return_logits=True))

    # multi-width training: each step at a sampled bucket width, indices from
    # the pool whose content fits and whose CTC alignment is feasible there
    width_buckets = (192, 320, 384, 448, 512)
    width_probs = (0.08, 0.22, 0.15, 0.15, 0.40)
    widths_np = data.widths.cpu().numpy()
    lengths_np = data.lengths.cpu().numpy()
    pools = {w: np.where((widths_np <= w) & (1.5 * lengths_np + 2 <= w // 8))[0]
             for w in width_buckets}
    keep = [i for i, w in enumerate(width_buckets) if len(pools[w]) >= batch]
    width_buckets = tuple(width_buckets[i] for i in keep)
    p = np.asarray([width_probs[i] for i in keep])
    width_probs = tuple(p / p.sum())
    print(f"[rec] width buckets {width_buckets} pool sizes "
          f"{[len(pools[w]) for w in width_buckets]}", flush=True)

    params = [p for p in model.parameters()]
    ema = [p.detach().clone() for p in params]
    gen = _generator(device, rng)
    t0 = time.time()
    for i in range(steps):
        w = int(rng.choice(width_buckets, p=width_probs))
        pool = pools[w]
        idx = torch.from_numpy(pool[rng.integers(0, len(pool), batch)]).to(device)
        x, lab, ln = gather_rec_batch(data, idx, generator=gen)
        state, loss = step(state, x[:, :, :, :w], lab, ln)
        with torch.no_grad():  # EMA of the weights, decay 0.999
            torch._foreach_mul_(ema, 0.999)
            torch._foreach_add_(ema, [p.detach() for p in params], alpha=0.001)
        if i % 200 == 0 or i == steps - 1:
            print(f"[rec] step {i}: loss {float(loss):.4f} ({time.time() - t0:.0f}s)", flush=True)

    # accuracy on fresh lines: raw vs EMA, save the better
    n_eval = 256
    eval_imgs, eval_labels, eval_lengths, eval_texts = render_rec_dataset(rng, n_eval)
    ed = RecDeviceData.build(eval_imgs, eval_labels, eval_lengths, REC_W, device)
    x, _, _ = gather_rec_batch(ed, torch.arange(n_eval, device=device))
    model.eval()
    raw = [p.detach().clone() for p in params]

    def _decode(xb):
        with torch.no_grad():
            idx_, keep_, _ = ctc_greedy_decode(model(xb))
        return CHARS.decode_indices(idx_.cpu().numpy(), keep_.cpu().numpy())

    def _acc(weights):
        with torch.no_grad():
            torch._foreach_copy_(params, weights)
        preds = _decode(x)
        return float(np.mean([a == b for a, b in zip(preds, eval_texts)])), preds

    acc_raw, _ = _acc(raw)
    acc_ema, preds = _acc(ema)
    use_ema = acc_ema >= acc_raw
    if not use_ema:
        _, preds = _acc(raw)
    acc = max(acc_ema, acc_raw)
    print(f"[rec] exact-match on {n_eval} fresh lines: raw {acc_raw:.3f}  ema {acc_ema:.3f}"
          f" -> saving {'ema' if use_ema else 'raw'}")
    print("[rec] samples:", list(zip(preds[:5], eval_texts[:5])))
    save_params(out / ckpt, export_flax_params(model),
                meta={"preset": preset, "overrides": dict(MODEL_PRESETS[preset]["rec"])})
    (out / "charset.txt").write_text("\n".join(CHARS.chars[1:-1]), encoding="utf-8")

    # narrow-width spot check: the <= 320 px lines at the 320 bucket
    nar = np.where(ed.widths.cpu().numpy() <= 320)[0]
    if len(nar):
        xn, _, _ = gather_rec_batch(ed, torch.from_numpy(nar).to(device))
        pr = _decode(xn[:, :, :, :320])
        accn = np.mean([pr[j] == eval_texts[q] for j, q in enumerate(nar)])
        print(f"[rec] saved-ckpt exact-match at w=320 on {len(nar)} narrow lines: {accn:.3f}")
    return float(acc)


def prepare_cls_data(data_n, seed, data_cache: Path | None, device: torch.device,
                     pipe_pages: int = CLS_PIPE_PAGES):
    """Cls training set = pipeline crops + rendered lines, each cached on
    its own rng stream."""
    rng_pipe = np.random.default_rng(seed + 501)
    rng_render = np.random.default_rng(seed)
    imgs = []
    if pipe_pages > 0 and (WEIGHTS / "det.npz").exists():

        def _render_pipe():
            print("[cls] extracting crops via the real det pipeline ...", flush=True)
            return render_cls_pipeline_dataset(rng_pipe, pipe_pages, device), {}

        imgs, _ = _cached(data_cache, "cls_pipe", pipe_pages, _render_pipe)
        print(f"[cls] {len(imgs)} pipeline crops", flush=True)

    def _render_lines():
        print(f"[cls] rendering {data_n} lines ...", flush=True)
        return _render_cls_lines(rng_render, data_n), {}

    rendered, _ = _cached(data_cache, "cls_lines", data_n, _render_lines)
    return imgs + rendered


def train_cls(steps=9000, batch=128, lr=1e-3, data_n=24576, seed=1,
              data_cache: Path | None = None, warm_start: bool = False,
              device: str | torch.device = "cuda", out: Path = OUT,
              pipe_pages: int = CLS_PIPE_PAGES):
    device = resolve_device(device)
    rng = np.random.default_rng(seed + 1009)
    imgs = prepare_cls_data(data_n, seed, data_cache, device, pipe_pages)
    imgs = [imgs[i] for i in rng.permutation(len(imgs))]
    data = ClsDeviceData.build(imgs, 192, device)
    model = build_cls("mobile", compute_dtype="bfloat16")
    if warm_start and (WEIGHTS / "cls.npz").exists():
        _warm_start(model, "cls.npz", "cls")
    state = init_train_state(model, _schedule(steps, lr), device=device)
    return _cls_fit(model, state, data, len(imgs), rng, steps, batch, out)


def _render_cls_lines(rng, data_n):
    imgs = []
    for _ in range(data_n):
        fg, bg = ((255, 255, 255), (0, 0, 0)) if rng.random() < 0.3 else ((0, 0, 0), (255, 255, 255))
        text = cls_text(rng)
        img = render_line(text, int(rng.integers(32, 49)),
                          font=default_font(int(rng.integers(24, 44)), _fonts_cycle(rng)),
                          fg=fg, bg=bg, stroke_width=1 if rng.random() < 0.2 else 0)
        # det-box margins: pad 0-45% of the height above and below, 0-60% sideways
        h0, w0 = img.shape[:2]
        mt = int(h0 * rng.uniform(0.0, 0.45)); mb = int(h0 * rng.uniform(0.0, 0.45))  # noqa: E702
        ml = int(h0 * rng.uniform(0.0, 0.6)); mr = int(h0 * rng.uniform(0.0, 0.6))  # noqa: E702
        padded = np.full((h0 + mt + mb, w0 + ml + mr, 3), bg, np.uint8)
        padded[mt:mt + h0, ml:ml + w0] = img
        img = padded
        # the det resize's upscale blur, then the final squash
        if rng.random() < 0.7:
            up = rng.uniform(1.5, 4.0)
            img = _pil_resize(img, max(int(img.shape[1] * up), 8),
                              max(int(img.shape[0] * up), 8))
        imgs.append(img)  # raw; ClsDeviceData resizes both orientations
    return imgs


def _cls_loss_sym(out: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """Cross entropy of the symmetrized score ``0.5 (p(x) + perm p(rot180
    x))`` plus 0.25 of each view's own, label smoothing 0.02 (the batch is
    both views stacked)."""
    nb = lab.shape[0]
    p1, p2 = out[:nb], out[nb:]
    p_sym = 0.5 * (p1 + p2.flip(1))
    eps, sm = 1e-8, 0.02
    onehot = F.one_hot(lab.long(), 2).float() * (1 - sm) + sm / 2
    loss_sym = -(onehot * torch.log(p_sym + eps)).sum(-1).mean()
    loss_view = (-(onehot * torch.log(p1 + eps)).sum(-1).mean()
                 - (onehot.flip(1) * torch.log(p2 + eps)).sum(-1).mean())
    return loss_sym + 0.25 * loss_view


def _cls_views(data: ClsDeviceData, idx: torch.Tensor, rng, gen: torch.Generator):
    """One training batch of the crops ``idx``: a random orientation per
    crop and the opposite view, both under one photometric jitter drawn
    on the host, with per-view noise from ``gen``: (x [2B, ...], labels)."""
    b, device = len(idx), idx.device
    rot = torch.from_numpy(rng.integers(0, 2, b)).to(device)
    gain = torch.from_numpy(rng.uniform(0.5, 1.25, b).astype(np.float32)).to(device)
    bias = torch.from_numpy(rng.uniform(-0.55, 0.2, b).astype(np.float32)).to(device)
    x, lab = gather_cls_batch(data, idx, rot, gain, bias, generator=gen)
    x_opp, _ = gather_cls_batch(data, idx, 1 - rot, gain, bias, generator=gen)
    return torch.cat([x, x_opp]), lab


def _cls_fit(model, state, data, data_n, rng, steps, batch, out: Path = OUT):
    device = data.lines.device
    step = make_train_step(model, _cls_loss_sym)
    gen = _generator(device, rng)
    t0 = time.time()
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, data_n, batch)).to(device)
        state, loss = step(state, *_cls_views(data, idx, rng, gen))
        if i % 200 == 0 or i == steps - 1:
            print(f"[cls] step {i}: loss {float(loss):.4f} ({time.time() - t0:.0f}s)", flush=True)

    model.eval()

    def probs(xb):
        with torch.no_grad():
            return model(xb).cpu().numpy()

    # the symmetrized gate metric (q >= 0.9) beside plain argmax accuracy
    idx = torch.from_numpy(rng.integers(0, data_n, 512)).to(device)
    rot = torch.from_numpy(rng.integers(0, 2, 512)).to(device)
    x, lab = gather_cls_batch(data, idx, rot)
    x_opp, _ = gather_cls_batch(data, idx, 1 - rot)
    p1, p2 = probs(x), probs(x_opp)
    q = 0.5 * (p1 + p2[:, ::-1])
    lab = lab.cpu().numpy()
    acc = float((q.argmax(1) == lab).mean())
    gate = float((q[np.arange(len(lab)), lab] >= 0.9).mean())
    print(f"[cls] sym accuracy: {acc:.3f}  gate@0.9: {gate:.3f}")

    # temperature calibration on fresh held-out renders: the T maximising
    # (rotated crops passing the 0.9 gate) + (upright crops not rotated),
    # folded into the final Dense
    held = _render_cls_lines(np.random.default_rng(rng.integers(1 << 31)), 1024)
    hdata = ClsDeviceData.build(held, 192, device)
    hidx = torch.arange(len(held), device=device)
    hx_up, _ = gather_cls_batch(hdata, hidx, torch.zeros(len(held), dtype=torch.long, device=device))
    hx_rot, _ = gather_cls_batch(hdata, hidx, torch.ones(len(held), dtype=torch.long, device=device))
    outs = {"up": (probs(hx_up), probs(hx_rot)), "rot": (probs(hx_rot), probs(hx_up))}
    eps = 1e-12

    def gate_counts(t):
        score = {}
        for name, (a, b) in outs.items():
            la, lb = np.log(a + eps) / t, np.log(b + eps) / t
            pa = np.exp(la - la.max(1, keepdims=True))
            pa /= pa.sum(1, keepdims=True)
            pb = np.exp(lb - lb.max(1, keepdims=True))
            pb /= pb.sum(1, keepdims=True)
            score[name] = 0.5 * (pa + pb[:, ::-1])
        rot_pass = int(((score["rot"].argmax(1) == 1) & (score["rot"][:, 1] >= 0.9)).sum())
        up_ok = int((~((score["up"].argmax(1) == 1) & (score["up"][:, 1] >= 0.9))).sum())
        return rot_pass, up_ok

    best_t, best_obj = 1.0, sum(gate_counts(1.0))
    for t in (0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.25):
        obj = sum(gate_counts(t))
        if obj > best_obj:  # strict: the least-distorting T on ties
            best_t, best_obj = t, obj
    r0, u0 = gate_counts(1.0)
    r1, u1 = gate_counts(best_t)
    n_h = len(held)
    print(f"[cls] calibration: T=1.0 rot-gate {r0}/{n_h} up-ok {u0}/{n_h}"
          f" -> T={best_t} rot-gate {r1}/{n_h} up-ok {u1}/{n_h}")
    flat = export_flax_params(model)
    for leaf in ("kernel", "bias"):
        flat[f"params::Dense_0::{leaf}"] = flat[f"params::Dense_0::{leaf}"] / best_t
    save_params(out / "cls.npz", flat,
                meta={"preset": "mobile", "overrides": dict(MODEL_PRESETS["mobile"]["cls"])})
    return acc


_PIPE_SIZES = [(256, 320), (384, 512), (512, 448), (640, 704), (288, 704),
               (192, 640), (208, 512)]


def render_cls_pipeline_dataset(rng, n_pages=1600, device: str | torch.device = "cuda"):
    """Cls training crops from the real det pipeline: rendered pages at
    varied sizes, the shipped det's boxes, crops warped as the session
    warps them."""
    from ..geometry import PointBox
    from ..image.io import ImageHelper

    cfg, stage, eng = _pipeline_det(resolve_device(device))
    crops = []
    for i in range(n_pages):
        size_h, size_w = _PIPE_SIZES[int(rng.integers(0, len(_PIPE_SIZES)))]
        lh_lo = int(rng.integers(18, 40))
        img, _, _ = render_page(rng, CHARS, size_h, size_w, max_lines=5,
                                lh_range=(lh_lo, min(lh_lo + 60, 110)), text_fn=cls_text)
        ih = ImageHelper(img)
        ih.resize_both(cfg.max_side_len, cfg.min_side_len)
        boxes, _ = stage(ih, eng)
        for b in boxes:
            crop = ih.get_crop_img(PointBox(b))
            if crop.shape[0] < 8 or crop.shape[1] < 8:
                continue
            crops.append(crop)
        if len(crops) % 500 < 5:
            print(f"[cls-pipe] {i + 1} pages -> {len(crops)} crops", flush=True)
    return crops


def warp_crops_like_inference(ih, boxes, rec_h=REC_H, rec_w=REC_W):
    """Warp det boxes to rec crops through the separable bilinear kernel
    the fused pipeline's warp applies at inference (``_aligned_scal``
    geometry), in numpy.  Returns one [48, tw, 3] u8 crop per box, None
    for a tall box (a rotate crop) or one outside the image.  The numpy
    arithmetic is the JAX tool's own (float64 tap weights, rounded to
    float32), not ``image.warp.warp_crops_separable``'s float32 torch
    passes, which put some codes one apart from the tool's."""
    from ..geometry import PointBox
    from ..image.warp import crop_output_size
    from ..pipeline.device_pipeline import _aligned_scal

    def _axis_np(o, s, src, dst):
        d = np.arange(dst, dtype=np.float64)[:, None]
        j = np.arange(src, dtype=np.float64)[None, :]
        w = np.maximum(0.0, 1.0 - np.abs(o + d * s - j))
        return w.astype(np.float32), w.sum(axis=1).astype(np.float32)

    img = ih.img
    ah, aw = ih.size()
    out = []
    for b in boxes:
        q = np.asarray(b, np.float64)
        h_c, w_c, rot = crop_output_size(PointBox(q))
        if rot:
            out.append(None)
            continue
        tw = max(min(int(math.ceil(rec_h * w_c / h_c)), rec_w), 8)
        ox, sx, oy, sy = _aligned_scal(q, tw, rec_h, False)
        y0 = max(int(math.floor(oy)), 0)
        y1 = min(int(math.ceil(oy + (rec_h - 1) * sy)) + 2, ah)
        x0 = max(int(math.floor(ox)), 0)
        x1 = min(int(math.ceil(ox + (tw - 1) * sx)) + 2, aw)
        if y1 <= y0 or x1 <= x0:
            out.append(None)
            continue
        wv, mv = _axis_np(oy - y0, sy, y1 - y0, rec_h)
        wu, mu = _axis_np(ox - x0, sx, x1 - x0, tw)
        sub = img[y0:y1, x0:x1].astype(np.float32)
        t = np.einsum("dh,hwc->dwc", wv, sub)
        o = np.einsum("ew,dwc->dec", wu, t)
        mass = mv[:, None] * mu[None, :]
        o = o + (1.0 - mass)[..., None] * 255.0
        out.append(np.clip(np.rint(o), 0, 255).astype(np.uint8))
    return out


def render_rec_pipeline_dataset(rng, n_pages=2400, device: str | torch.device = "cuda",
                                max_len=16):
    """Rec training crops from the real det pipeline: det boxes matched to
    the ground-truth lines by their centres, so each crop carries its text,
    warped through the inference kernel."""
    from ..image.io import ImageHelper

    cfg, stage, eng = _pipeline_det(resolve_device(device))
    imgs, labels, lengths, texts = [], [], [], []
    for i in range(n_pages):
        size_h, size_w = _PIPE_SIZES[int(rng.integers(0, len(_PIPE_SIZES)))]
        lh_lo = int(rng.integers(18, 40))
        r = rng.random()
        img, gt_boxes, gt_texts = render_page(
            rng, CHARS, size_h, size_w, max_lines=5, lh_range=(lh_lo, min(lh_lo + 60, 110)),
            text_fn=(natural_text if r < 0.4 else confusion_text if r < 0.7 else None))
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
            # a centre further than the GT line height is a merge or a split
            if d[j] > (gt_boxes[j, 3] - gt_boxes[j, 1]) * sy:
                continue
            matched_boxes.append(b)
            matched_texts.append(gt_texts[j])
        crops = warp_crops_like_inference(ih, matched_boxes) if matched_boxes else []
        for crop, text in zip(crops, matched_texts):
            if crop is None or crop.shape[0] < 8 or crop.shape[1] < 8:
                continue
            imgs.append(crop)
            ids = CHARS.encode(text)[:max_len]
            labels.append(ids + [0] * (max_len - len(ids)))
            lengths.append(len(ids))
            texts.append(text)
        if (i + 1) % 200 == 0:
            print(f"[rec-pipe] {i + 1} pages -> {len(imgs)} crops", flush=True)
    return imgs, np.asarray(labels).reshape(-1, max_len), np.asarray(lengths), texts


def render_det_dataset(rng, n):
    """``n`` 512 x 512 pages with their line boxes: big-vocab pseudo-glyph
    pages, large-type and body-size natural pages, tile pages, 30% rotated
    by 180 degrees, 15% JPEG-degraded."""
    from .bigvocab import render_big_page

    pages, boxes = [], []
    for _ in range(n):
        lh_lo = int(rng.integers(16, 40))
        lh_hi = lh_lo + int(rng.integers(8, 90))
        r = rng.random()
        if r < 0.12:
            img, bx, _ = render_big_page(rng, DET_S, DET_S, max_lines=5,
                                         lh_range=(max(lh_lo, 24), max(min(lh_hi, 96), 32)))
        elif r < 0.32:
            img, bx, _ = render_page_natural(rng, CHARS, DET_S, DET_S, max_lines=3,
                                             size_range=(80, 170))
        elif r < 0.40:
            img, bx, _ = render_page(rng, CHARS, DET_S, DET_S, max_lines=3,
                                     lh_range=(int(rng.integers(90, 130)), 200))
        elif r < 0.72:
            img, bx, _ = render_page_natural(rng, CHARS, DET_S, DET_S, max_lines=6,
                                             size_range=(max(lh_lo - 4, 12), min(lh_hi, 72)))
        else:
            img, bx, _ = render_page(rng, CHARS, DET_S, DET_S, max_lines=6,
                                     lh_range=(lh_lo, min(lh_hi, 120)))
        if rng.random() < 0.3 and len(bx):
            img = img[::-1, ::-1].copy()
            bx = np.stack([DET_S - bx[:, 2], DET_S - bx[:, 3],
                           DET_S - bx[:, 0], DET_S - bx[:, 1]], axis=1)
        pages.append(_jpeg_degrade(rng, img))
        boxes.append(bx)
    return pages, boxes


def train_det(steps=6000, batch=8, lr=8e-4, data_n=640, seed=2, preset: str = "mobile",
              device: str | torch.device = "cuda", out: Path = OUT):
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    print(f"[det] rendering {data_n} pages ...", flush=True)
    pages, boxes = render_det_dataset(rng, data_n)
    data = DetDeviceData.build(pages, boxes, device)
    model = build_det(preset, compute_dtype="bfloat16")
    state = init_train_state(model, _schedule(steps, lr), device=device)
    out_stride = int(getattr(model, "out_stride", 1) or 1)

    step = make_train_step(model, db_loss)
    gen = _generator(device, rng)
    t0 = time.time()
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, data_n, batch)).to(device)
        x, gs, gm, gt, gtm = gather_det_batch(data, idx, out_stride=out_stride, generator=gen)
        state, loss = step(state, x, gs, gm, gt, gtm)
        if i % 100 == 0 or i == steps - 1:
            print(f"[det] step {i}: loss {float(loss):.4f} ({time.time() - t0:.0f}s)", flush=True)

    save_params(out / _ckpt_name("det", preset), export_flax_params(model),
                meta={"preset": preset, "overrides": dict(MODEL_PRESETS[preset]["det"])})
    # mean prob inside/outside the text of a fresh page
    img, bx, _ = render_page(rng, CHARS, DET_S, DET_S, lh_range=(24, 60))
    x = ((img[..., ::-1].astype(np.float32) / 255.0) - 0.5) / 0.5
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (2, 0, 1))[None])).to(device)
    model.eval()
    with torch.no_grad():
        p = model(x)[0, 0].float().cpu().numpy()
    inside = np.zeros(p.shape, bool)
    for (x0, y0, x1, y1) in bx.astype(int):
        inside[y0 + 4:y1 - 4, x0 + 4:x1 - 4] = True
    print(f"[det] prob inside text: {p[inside].mean() if inside.any() else 0.0:.3f}"
          f"  outside: {p[~inside].mean():.3f}")
    return float(p[inside].mean()) if inside.any() else 0.0


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m retto_tpu_torch.train.synthetic")
    ap.add_argument("target", choices=["rec", "cls", "det", "all", "render"],
                    nargs="?", default="all")
    ap.add_argument("--steps-scale", type=float, default=1.0)
    ap.add_argument("--data-cache", type=Path, default=None,
                    help="cache DIR for the rendered datasets; 'render' fills it")
    ap.add_argument("--warm-start", action="store_true",
                    help="initialise rec/cls from trained_weights/ (fine-tune)")
    ap.add_argument("--lr", type=float, default=None, help="override the learning rate")
    ap.add_argument("--batch", type=int, default=None, help="override the batch size")
    ap.add_argument("--steps", type=int, default=None,
                    help="override the step count without scaling the dataset")
    ap.add_argument("--preset", default="mobile",
                    help="model tier (mobile|server|tiny); cls always trains mobile")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", type=Path, default=OUT,
                    help="directory for the checkpoints (default .torch_build/trained_weights)")
    ap.add_argument("--pipe-pages", type=int, default=None,
                    help="pages rendered for each pipeline crop set (default "
                         f"{REC_PIPE_PAGES} rec / {CLS_PIPE_PAGES} cls; for 'render' "
                         "those times --steps-scale)")
    args = ap.parse_args(argv)
    if args.out.resolve() == WEIGHTS.resolve():
        raise SystemExit("--out must not be trained_weights/: the shipped checkpoints stay")
    device = resolve_device(args.device)
    args.out.mkdir(parents=True, exist_ok=True)
    s = args.steps_scale

    def pipe(n: int) -> int:
        return n if args.pipe_pages is None else args.pipe_pages

    if args.target == "render":
        assert args.data_cache is not None, "render needs --data-cache"
        prepare_rec_data(int(49152 * s), 0, args.data_cache, device,
                         pipe(int(REC_PIPE_PAGES * s)))
        prepare_cls_data(int(24576 * s), 1, args.data_cache, device,
                         pipe(int(CLS_PIPE_PAGES * s)))
        return
    extra = {"warm_start": args.warm_start, "device": device, "out": args.out}
    if args.lr is not None:
        extra["lr"] = args.lr
    if args.batch is not None:
        extra["batch"] = args.batch
    if args.target in ("rec", "all"):
        train_rec(steps=args.steps or int(24000 * s), data_n=int(49152 * s),
                  data_cache=args.data_cache, preset=args.preset,
                  pipe_pages=pipe(REC_PIPE_PAGES), **extra)
    if args.target in ("cls", "all"):
        train_cls(steps=args.steps or int(18000 * s), data_cache=args.data_cache,
                  pipe_pages=pipe(CLS_PIPE_PAGES), **extra)
    if args.target in ("det", "all"):
        train_det(steps=args.steps or int(6000 * s), preset=args.preset, device=device,
                  out=args.out)

if __name__ == "__main__":
    main()
