"""The plain OCR reference: page pixels in, det / cls / rec answers out,
in float32 (or the fp8 control), from the checkpoints and the session
settings of a configuration file.

It follows the pipeline's documented semantics step by step, in plain
PyTorch and NumPy:

det   resize the page into its det canvas (the min side brought to
      ``limit_side_len``, each side snapped to 32, padded to the bucket
      with the last row and column repeated; PIL-style bilinear weights
      whose triangle widens on a downscale), normalize, the det forward,
      threshold ``logit > ln(t / (1 - t))``, the up-left 2 x 2 dilation;
      each 8-connected component of the mask is a candidate with its
      least-area rectangle (corners rounded to pixels), scored as the mean of the 2 x 2-pooled u8
      probability map on a 16 x 64 bilinear grid over the rectangle, kept
      at ``box_thresh``, grown by ``area * unclip_ratio / perimeter`` on
      each side and scaled back to the page;
cls   each box cropped at height 48 and its natural width (at most 192),
      the bilinear samples of taps outside the page filled with white,
      normalized to [-1, 1], columns past the width zeroed; the classifier
      on the crop and on its 180-degree turn, averaged;
rec   the crop at height 48 in the smallest width bucket of at least 320
      columns (the up or the turned view, as the cls decision says), the
      logits; the CTC steps past the content width + 1 are dropped.

``judge`` holds the program's answers to these: the median gap of the
served det scores, the share of the reference's line area no served box
covers, the widest gap of a served cls probability, and the widest logit
gap of the cheapest CTC alignment of a served text.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
from scipy import ndimage
from scipy.spatial import ConvexHull, QhullError

from .models import ClsRef, DetRef, Precision, RecRef, load_flat

__all__ = ["Answer", "PageAnswer", "Reference", "det_canvas", "judge", "ctc_gap",
           "greedy_text"]


@dataclass
class Answer:
    """One text line: a quad (4 x 2, clockwise from the top left, page
    pixels), its det score, the cls label and score, the text."""

    box: np.ndarray
    score: float
    cls_label: int = 0
    cls_score: float = 0.0
    text: str = ""


@dataclass
class PageAnswer:
    lines: list[Answer] = field(default_factory=list)


def _round_half_away(v: float) -> int:
    return int(math.floor(v + 0.5)) if v >= 0 else -int(math.floor(-v + 0.5))


def det_canvas(h: int, w: int, s: dict) -> tuple[int, int, int, int]:
    """(rh, rw, dh, dw): the det input size of an h x w page and its
    bucket, from the session settings ``s``."""
    det, bk = s["det"], s["buckets"]
    lim = det["limit_side_len"]
    if det["limit_type"] == "max":
        ratio = lim / max(h, w) if max(h, w) > lim else 1.0
    else:
        ratio = lim / min(h, w) if min(h, w) < lim else 1.0
    rh = max(_round_half_away(math.floor(h * ratio) / 32.0) * 32, 32)
    rw = max(_round_half_away(math.floor(w * ratio) / 32.0) * 32, 32)
    cap = bk["det_max_side"]
    if max(rh, rw) > cap:
        scale = cap / max(rh, rw)
        rh = max(int(rh * scale) // 32, 1) * 32
        rw = max(int(rw * scale) // 32, 1) * 32
    step = bk["det_pad_to"]
    dh = min(-(-rh // step) * step, cap)
    dw = min(-(-rw // step) * step, cap)
    return rh, rw, dh, dw


def _resize_matrix(src: int, dst: int, dst_size: int) -> np.ndarray:
    """[dst_size, src] weights: [0, src) onto [0, dst) with pixel centres,
    the triangle widened by the scale on a downscale, rows past ``dst``
    repeating the last source pixel."""
    i = np.arange(dst_size, dtype=np.float64)[:, None]
    j = np.arange(src, dtype=np.float64)[None, :]
    scale = src / dst
    support = max(scale, 1.0)
    sy = np.minimum(np.maximum((i + 0.5) * scale - 0.5, 0.0), src - 1.0)
    wgt = np.maximum(1.0 - np.abs(sy - j) / support, 0.0)
    return wgt / np.maximum(wgt.sum(axis=1, keepdims=True), 1e-6)


def _score(prob_small: np.ndarray, quads: np.ndarray) -> np.ndarray:
    """Mean of the pooled u8 map (det/4 grid) over each quad (det pixels)
    on a 16 x 64 bilinear grid."""
    if not len(quads):
        return np.zeros((0,), np.float64)
    q = np.asarray(quads, np.float64) / 4.0 - 0.375
    u = (np.arange(64) + 0.5) / 64.0
    v = (np.arange(16) + 0.5) / 16.0
    uu, vv = np.meshgrid(u, v)
    grid = (((1 - uu) * (1 - vv))[None, ..., None] * q[:, None, None, 0]
            + (uu * (1 - vv))[None, ..., None] * q[:, None, None, 1]
            + (uu * vv)[None, ..., None] * q[:, None, None, 2]
            + ((1 - uu) * vv)[None, ..., None] * q[:, None, None, 3])
    h, w = prob_small.shape
    x = np.clip(grid[..., 0], 0.0, w - 1.001)
    y = np.clip(grid[..., 1], 0.0, h - 1.001)
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    fx, fy = x - x0, y - y0
    p = prob_small.astype(np.float64)
    val = (p[y0, x0] * (1 - fx) * (1 - fy) + p[y0, x0 + 1] * fx * (1 - fy)
           + p[y0 + 1, x0] * (1 - fx) * fy + p[y0 + 1, x0 + 1] * fx * fy)
    return val.mean(axis=(1, 2)) / 255.0


def _hull(pts: np.ndarray) -> np.ndarray:
    """Convex hull of integer points, vertices in order (fewer than three
    when they are collinear)."""
    pts = np.unique(pts, axis=0).astype(np.float64)
    if len(pts) <= 2:
        return pts
    try:
        return pts[ConvexHull(pts).vertices]
    except QhullError:  # collinear: the two extreme points
        order = np.lexsort((pts[:, 1], pts[:, 0]))
        return pts[[order[0], order[-1]]]


def _min_rect(pts: np.ndarray) -> np.ndarray:
    """The least-area rectangle around the points (the first of the hull
    edges' orientations that reaches it), corners clockwise from the top
    left."""
    hull = _hull(pts)
    if len(hull) < 3:
        x0, y0 = hull.min(axis=0)
        x1, y1 = hull.max(axis=0)
        best = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float64)
    else:
        edges = np.roll(hull, -1, axis=0) - hull
        best, best_area = None, np.inf
        for a in np.unique(np.mod(np.arctan2(edges[:, 1], edges[:, 0]), np.pi / 2.0)):
            c, s = np.cos(a), np.sin(a)
            rot = np.array([[c, s], [-s, c]])
            proj = hull @ rot.T
            mn, mx = proj.min(axis=0), proj.max(axis=0)
            area = (mx[0] - mn[0]) * (mx[1] - mn[1])
            if area < best_area:
                best_area = area
                best = np.array([[mn[0], mn[1]], [mx[0], mn[1]], [mx[0], mx[1]],
                                 [mn[0], mx[1]]]) @ rot
    best = best.astype(np.float32)
    xs = np.argsort(best[:, 0], kind="stable")
    left, right = best[xs[:2]], best[xs[2:]]
    tl, bl = (left[0], left[1]) if left[0, 1] <= left[1, 1] else (left[1], left[0])
    tr, br = (right[0], right[1]) if right[0, 1] <= right[1, 1] else (right[1], right[0])
    return np.stack([tl, tr, br, bl]).astype(np.float64)


def _side(a, b) -> float:
    return float(np.hypot(*(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _homography(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """3 x 3 map of dest pixel coords onto source coords (4 point pairs)."""
    a, b = [], []
    for (x, y), (u, v) in zip(dst, src):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.extend([u, v])
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    try:
        c = np.linalg.solve(a, b)
    except np.linalg.LinAlgError:  # a degenerate quad
        c = np.linalg.lstsq(a, b, rcond=None)[0]
    return np.array([[c[0], c[1], c[2]], [c[3], c[4], c[5]], [c[6], c[7], 1.0]])


def _crops(page: torch.Tensor, quads: list[np.ndarray], widths: list[int], ch: int,
           out_w: int, turned: bool) -> torch.Tensor:
    """Bilinear crops [N, ch, out_w] of the page (float32 [H, W]), crop n
    mapping dest [0, widths[n]) x [0, ch) onto quads[n] (turned 180
    degrees with ``turned``); taps outside the page read 255."""
    hh, ww = page.shape
    hms = []
    for quad, cw in zip(quads, widths):
        rect = np.array([[0, 0], [cw, 0], [cw, ch], [0, ch]], np.float64)
        if turned:
            rect = rect[[2, 3, 0, 1]]
        hms.append(_homography(rect, np.asarray(quad, np.float64)))
    hm = torch.from_numpy(np.stack(hms)).to(page.device)[:, :, :, None, None]
    ys, xs = torch.meshgrid(torch.arange(ch, dtype=torch.float64, device=page.device),
                            torch.arange(out_w, dtype=torch.float64, device=page.device),
                            indexing="ij")
    den = hm[:, 2, 0] * xs + hm[:, 2, 1] * ys + hm[:, 2, 2]
    sx = (hm[:, 0, 0] * xs + hm[:, 0, 1] * ys + hm[:, 0, 2]) / den
    sy = (hm[:, 1, 0] * xs + hm[:, 1, 1] * ys + hm[:, 1, 2]) / den
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0).float(), (sy - y0).float()
    out = torch.zeros(sx.shape, dtype=torch.float32, device=page.device)
    for dy, dx, wgt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                        (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = (x0 + dx).long(), (y0 + dy).long()
        inb = (xi >= 0) & (xi < ww) & (yi >= 0) & (yi < hh)
        v = page[yi.clamp(0, hh - 1), xi.clamp(0, ww - 1)]
        out += wgt * torch.where(inb, v, torch.full_like(v, 255.0))
    return out


def _next_bucket(v: int, buckets) -> int:
    pos = bisect.bisect_left(buckets, v)
    return buckets[pos] if pos < len(buckets) else buckets[-1] * -(-v // buckets[-1])


def greedy_text(logits: torch.Tensor, valid_t: int, chars: list[str]) -> str:
    """CTC greedy decode of [T, C] logits over the first ``valid_t`` steps."""
    idx = logits[:valid_t].argmax(dim=-1).tolist()
    out, prev = [], -1
    for i in idx:
        if i != 0 and i != prev:
            out.append(chars[i])
        prev = i
    return "".join(out)


def ctc_gap(logits: np.ndarray, valid_t: int, target: list[int]) -> float:
    """The least, over the CTC alignments of ``target`` onto the first
    ``valid_t`` steps, of the widest gap by which an aligned step's logit
    lies below that step's best logit (0 when the greedy path reads
    ``target``; inf when no alignment exists)."""
    return float(ctc_gaps(logits[None], [valid_t], [target])[0])


def ctc_gaps(logits: np.ndarray, valid: list[int], targets: list[list[int]]) -> np.ndarray:
    """:func:`ctc_gap` of each row of ``logits`` [N, T, C] at once."""
    n, steps, _ = logits.shape
    s_n = 2 * max((len(t) for t in targets), default=0) + 1
    ext = np.zeros((n, s_n), np.int64)
    live = np.zeros((n, s_n), bool)
    for r, t in enumerate(targets):
        ext[r, 1:2 * len(t):2] = t
        live[r, :2 * len(t) + 1] = True
    g = logits.max(axis=2, keepdims=True) - logits  # [N, T, C]
    gs = np.take_along_axis(g, np.broadcast_to(ext[:, None, :], (n, steps, s_n)), axis=2)
    gs = np.where(live[:, None, :], gs, np.inf)  # [N, T, S]
    skip = np.zeros((n, s_n), bool)
    skip[:, 2:] = (ext[:, 2:] != 0) & (ext[:, 2:] != ext[:, :-2])
    a = np.full((n, s_n), np.inf)
    a[:, 0] = gs[:, 0, 0]
    if s_n > 1:
        a[:, 1] = gs[:, 0, 1]
    valid = np.asarray(valid)
    for t in range(1, steps):
        best = a.copy()
        best[:, 1:] = np.minimum(best[:, 1:], a[:, :-1])
        best[:, 2:] = np.where(skip[:, 2:], np.minimum(best[:, 2:], a[:, :-2]), best[:, 2:])
        a = np.where((t < valid)[:, None], np.maximum(best, gs[:, t]), a)
    ends = np.array([2 * len(t) for t in targets])
    last = a[np.arange(n), ends]
    prev = np.where(ends > 0, a[np.arange(n), np.maximum(ends - 1, 0)], np.inf)
    return np.minimum(last, prev)


class Reference:
    """The plain pipeline of one configuration on ``device``, in
    ``precision`` ("float32", or "fp8" for the control).  ``cfg`` is the
    configuration file's dict; ``root`` the checkout the weight paths are
    relative to."""

    def __init__(self, cfg: dict, root: Path, device: torch.device,
                 precision: str = "float32", block: int = 8):
        self.s = cfg["session"]
        det = self.s["det"]
        if len(set(det["mean"])) != 1 or len(set(det["std"])) != 1 or not self.s["use_cls"]:
            raise ValueError("the reference takes one mean and std for all channels, "
                             "and the cls stage on")
        self.device = device
        self.block = block
        prec = Precision(precision)
        w = cfg["weights"]
        m = cfg["models"]
        self.det = DetRef(load_flat(root / w["det"], device), prec,
                          m["det"]["widths"], m["det"]["depths"])
        self.cls = ClsRef(load_flat(root / w["cls"], device), prec)
        self.rec = RecRef(load_flat(root / w["rec"], device), prec, m["rec"]["dims"],
                          m["rec"]["depths"], m["rec"]["mixer_depth"], m["rec"]["num_heads"])
        charset = (root / cfg["charset"]).read_text(encoding="utf-8").splitlines()
        self.chars = ["blank", *charset, " "]
        self.index = {}
        for i, c in enumerate(self.chars):
            if i and c not in self.index:
                self.index[c] = i

    # ---------------------------------------------------------------- det
    @torch.no_grad()
    def det_maps(self, pages: list[np.ndarray]) -> list[tuple[np.ndarray, np.ndarray]]:
        """(mask [rh/2, rw/2] bool, pooled u8 prob map [dh/4, dw/4]) per
        page, the det forward in blocks of pages of one canvas."""
        det = self.s["det"]
        out: list = [None] * len(pages)
        order: dict[tuple, list[int]] = {}
        for i, p in enumerate(pages):
            order.setdefault(p.shape[:2], []).append(i)
        thr = math.log(det["thresh"] / (1.0 - det["thresh"]))
        for (h, w), idxs in order.items():
            rh, rw, dh, dw = det_canvas(h, w, self.s)
            wh = torch.from_numpy(_resize_matrix(h, rh, dh)).float().to(self.device)
            ww = torch.from_numpy(_resize_matrix(w, rw, dw)).float().to(self.device)
            for k in range(0, len(idxs), self.block):
                part = idxs[k:k + self.block]
                gray = torch.stack([torch.from_numpy(_gray(pages[i])) for i in part]).to(
                    self.device).float()
                canvas = wh @ gray @ ww.T
                x = (canvas * det["scale"] - det["mean"][0]) / det["std"][0]
                logits = self.det(x[:, None].expand(-1, 3, -1, -1).contiguous())
                mask = logits > thr
                if det["use_dilation"]:
                    m = torch.nn.functional.pad(mask.float()[:, None], (1, 0, 1, 0))
                    mask = torch.nn.functional.max_pool2d(m, 2, stride=1)[:, 0] > 0
                prob = torch.sigmoid(logits)
                b, mh, mw = prob.shape
                pooled = prob.reshape(b, mh // 2, 2, mw // 2, 2).mean(dim=(2, 4))
                pooled = torch.clamp(torch.round(pooled * 255.0), 0, 255).to(torch.uint8)
                mask, pooled = mask.cpu().numpy(), pooled.cpu().numpy()
                for j, i in enumerate(part):
                    out[i] = (mask[j, :rh // 2, :rw // 2], pooled[j])
        return out

    def det_boxes(self, page_hw: tuple[int, int], mask: np.ndarray, pooled: np.ndarray
                  ) -> list[tuple[np.ndarray, float]]:
        """The reference's boxes (page pixels) and det scores of one page."""
        det = self.s["det"]
        h, w = page_hw
        rh, rw, _, _ = det_canvas(h, w, self.s)
        labels, n = ndimage.label(mask, structure=np.ones((3, 3), bool))
        boxes = []
        min_side = max(1, det["min_mini_box_size"] // 2)
        for k, sl in enumerate(ndimage.find_objects(labels)):
            ys, xs = np.nonzero(labels[sl] == k + 1)
            pts = np.stack([xs + sl[1].start, ys + sl[0].start], axis=1)
            rect = np.round(_min_rect(pts))
            if min(_side(rect[0], rect[1]), _side(rect[3], rect[2])) < min_side:
                continue
            quad = rect * 2.0
            score = float(_score(pooled, quad[None])[0])
            if score < det["box_thresh"]:
                continue
            bw, bh = _side(quad[0], quad[1]), _side(quad[0], quad[3])
            d = bw * bh * det["unclip_ratio"] / (2.0 * (bw + bh))
            ux = (quad[1] - quad[0]) / max(bw, 1e-9) * d
            uy = (quad[3] - quad[0]) / max(bh, 1e-9) * d
            grown = quad + np.stack([-ux - uy, ux - uy, ux + uy, -ux + uy])
            if min(bw, bh) + 2 * d < det["min_mini_box_size"] + 2:
                continue
            scale = np.array([w / rw, h / rh])
            page_quad = np.clip(np.round(grown * scale), 0, [w - 1, h - 1])
            if min(_side(page_quad[0], page_quad[1]), _side(page_quad[0], page_quad[3])) <= 3:
                continue
            boxes.append((page_quad, score))
        return boxes

    # ------------------------------------------------------------- cls/rec
    def crop_plan(self, quad: np.ndarray) -> dict:
        """The crop geometry of one box: the quad (turned a quarter when
        the box is tall), the cls width, the rec bucket and width."""
        q = np.asarray(quad, np.float64)
        w_c = max(int(max(_side(q[0], q[1]), _side(q[3], q[2]))), 1)
        h_c = max(int(max(_side(q[1], q[2]), _side(q[0], q[3]))), 1)
        if h_c / w_c >= 1.5:
            q = q[[1, 2, 3, 0]]
            h_c, w_c = w_c, h_c
        _, ch, cwmax = self.s["cls"]["image_shape"]
        _, rh, rw_default = self.s["rec"]["image_shape"]
        buckets = self.s["buckets"]["rec_width_buckets"]
        natural = int(math.ceil(rh * w_c / h_c))
        if natural > buckets[-1]:
            raise NotImplementedError(
                f"a line {natural} px wide at height {rh} is split into segments by the "
                "pipeline; the reference judges single-segment lines only")
        bw = _next_bucket(max(natural, rw_default), buckets)
        return {"quad": q, "cls_w": min(cwmax, int(math.ceil(ch * w_c / h_c))),
                "bw": bw, "w": min(natural, bw)}

    def _views(self, page: torch.Tensor, plans: list[dict], key: str, height: int,
               out_w: int, turned: bool) -> torch.Tensor:
        widths = [pl[key] for pl in plans]
        crops = _crops(page, [pl["quad"] for pl in plans], widths, height, out_w, turned)
        x = (crops * (1.0 / 255.0) - 0.5) * 2.0
        col = torch.arange(out_w, device=page.device)
        x = torch.where(col < torch.tensor(widths, device=page.device)[:, None, None], x, 0.0)
        return x[:, None].expand(-1, 3, -1, -1)

    @torch.no_grad()
    def cls_probs(self, page: torch.Tensor, plans: list[dict]) -> torch.Tensor:
        """[N, classes] symmetrized cls probabilities of the page's crops."""
        _, ch, cw = self.s["cls"]["image_shape"]
        labels = list(self.s["cls"]["label"])
        up = self.cls(self._views(page, plans, "cls_w", ch, cw, False))
        if not self.s["cls"]["symmetrize"]:
            return up
        perm = [labels.index((v + 180) % 360) for v in labels]
        turned = self.cls(self._views(page, plans, "cls_w", ch, cw, True))
        return 0.5 * (up + turned[:, perm])

    @torch.no_grad()
    def rec_logits(self, page: torch.Tensor, plans: list[dict], turned: list[bool]
                   ) -> list[tuple[np.ndarray, int]]:
        """(logits [T, C], valid steps) per crop, the rec view chosen by
        ``turned``."""
        _, rh, _ = self.s["rec"]["image_shape"]
        out: list = [None] * len(plans)
        for bw in sorted({p["bw"] for p in plans}):
            for t in (False, True):
                idx = [i for i, p in enumerate(plans) if p["bw"] == bw and turned[i] == t]
                if not idx:
                    continue
                x = self._views(page, [plans[i] for i in idx], "w", rh, bw, t)
                logits = self.rec(x).cpu().numpy()
                steps = logits.shape[1]
                for j, i in enumerate(idx):
                    valid = steps
                    if self.s["rec"]["mask_pad_timesteps"]:
                        valid = min(int(math.ceil(steps * plans[i]["w"] / bw)) + 1, steps)
                    out[i] = (logits[j], valid)
        return out

    # ------------------------------------------------------------ control
    def answer(self, pages: list[np.ndarray]) -> list[PageAnswer]:
        """The reference's own answers (in the control's precision, this
        is the control put in the program's place)."""
        maps = self.det_maps(pages)
        labels = list(self.s["cls"]["label"])
        out = []
        for page, (mask, pooled) in zip(pages, maps):
            boxes = self.det_boxes(page.shape[:2], mask, pooled)
            pa = PageAnswer([Answer(b, s) for b, s in boxes])
            if boxes:
                t = torch.from_numpy(_gray(page)).to(self.device).float()
                plans = [self.crop_plan(b) for b, _ in boxes]
                probs = self.cls_probs(t, plans).cpu().numpy()
                turned = []
                for ans, pr in zip(pa.lines, probs):
                    k = int(pr.argmax())
                    ans.cls_label, ans.cls_score = labels[k], float(pr[k])
                    turned.append(ans.cls_label == 180
                                  and ans.cls_score >= self.s["cls"]["thresh"])
                for ans, (lg, valid) in zip(pa.lines, self.rec_logits(t, plans, turned)):
                    ans.text = greedy_text(torch.from_numpy(lg), valid, self.chars)
            out.append(pa)
        return out


def _gray(page: np.ndarray) -> np.ndarray:
    """The single plane of a gray page ([H, W] or [H, W, 3] with equal
    channels)."""
    if page.ndim == 2:
        return np.ascontiguousarray(page)
    if not ((page[..., 0] == page[..., 1]).all() and (page[..., 1] == page[..., 2]).all()):
        raise ValueError("the reference judges gray pages only")
    return np.ascontiguousarray(page[..., 0])


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    ax0, ay0 = a.min(axis=0)
    ax1, ay1 = a.max(axis=0)
    bx0, by0 = b.min(axis=0)
    bx1, by1 = b.max(axis=0)
    iw = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    ih = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = iw * ih
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / union if union > 0 else 0.0


def _candidate(box: np.ndarray, page_hw: tuple[int, int], s: dict) -> np.ndarray:
    """The det-pixel rectangle a served box was grown from: the box
    brought to det pixels and shrunk on each side by the distance that
    ``area * ratio / perimeter`` growth of a w x h rectangle adds
    (W = w + 2d, H = h + 2d, d = w h ratio / (2 (w + h)), solved for d)."""
    h, w = page_hw
    rh, rw, _, _ = det_canvas(h, w, s)
    q = np.asarray(box, np.float64) * np.array([rw / w, rh / h])
    big_w, big_h = _side(q[0], q[1]), _side(q[0], q[3])
    r = s["det"]["unclip_ratio"]
    diff = big_w - big_h
    u = (2 * (big_w + big_h) + math.sqrt(4 * (big_w + big_h) ** 2 + 4 * (2 + r) * r * diff ** 2)
         ) / (2 * (2 + r))
    d = max((big_w + big_h - u) / 4.0, 0.0)
    ux = (q[1] - q[0]) / max(big_w, 1e-9) * d
    uy = (q[3] - q[0]) / max(big_h, 1e-9) * d
    return q + np.stack([ux + uy, -ux + uy, -ux - uy, ux - uy])


def _inside(pt: np.ndarray, quad: np.ndarray) -> bool:
    x0, y0 = quad.min(axis=0)
    x1, y1 = quad.max(axis=0)
    return bool(x0 <= pt[0] <= x1 and y0 <= pt[1] <= y1)


def _covered(box: np.ndarray, served: list[np.ndarray]) -> float:
    """Share of ``box``'s bounding rectangle that served boxes' bounding
    rectangles cover (on a 16 x 16 grid of the rectangle)."""
    x0, y0 = box.min(axis=0)
    x1, y1 = box.max(axis=0)
    xs = x0 + (np.arange(16) + 0.5) / 16 * (x1 - x0)
    ys = y0 + (np.arange(16) + 0.5) / 16 * (y1 - y0)
    gx, gy = np.meshgrid(xs, ys)
    hit = np.zeros(gx.shape, bool)
    for b in served:
        bx0, by0 = b.min(axis=0)
        bx1, by1 = b.max(axis=0)
        hit |= (gx >= bx0) & (gx <= bx1) & (gy >= by0) & (gy <= by1)
    return float(hit.mean())


def judge(ref: Reference, pages: list[np.ndarray], answers: list[PageAnswer],
          explain: dict | None = None) -> dict[str, float]:
    """The numbers that hold the answers served for ``pages`` to the
    reference (a cell's limits file names those compared):

    * ``det_med``: the median, over the served boxes, of the gap between a
      box's served det score and the reference's score of the same line:
      of the region the served box was grown from, scored on the
      reference's map, or, where a reference box matches the served one at
      IoU >= 0.5, of that box if it agrees better (a mask one pixel wider
      moves a box's edge and its mean);
    * ``det_miss``: the share of the reference boxes' area that no served
      box covers;
    * ``cls_gap``: the widest gap between a served cls score and the
      reference's probability of the served label;
    * ``rec_gap``: the widest :func:`ctc_gap` of a served text on the
      reference's logits of the crop the served cls decision selects.

    ``explain``, if given, receives the worst case of the widest gaps."""
    labels = list(ref.s["cls"]["label"])
    maps = ref.det_maps(pages)
    cls_gap = rec_gap = 0.0
    diffs: list[float] = []
    ref_area = missed = 0.0
    worst: dict[str, tuple] = {}

    def note(name: str, value: float, what) -> float:
        if name not in worst or value > worst[name][0]:
            worst[name] = (value, what)
        return value

    for pi, (page, ans, (mask, pooled)) in enumerate(zip(pages, answers, maps)):
        hw = page.shape[:2]
        mine = ref.det_boxes(hw, mask, pooled)
        gaps = [abs(a.score - float(_score(pooled, _candidate(a.box, hw, ref.s)[None])[0]))
                for a in ans.lines]
        pairs = sorted(((_iou(a.box, b), i, j) for i, a in enumerate(ans.lines)
                        for j, (b, _) in enumerate(mine)), reverse=True)
        used_a, used_b = set(), set()
        for iou, i, j in pairs:
            if iou < 0.5 or i in used_a or j in used_b:
                continue
            used_a.add(i)
            used_b.add(j)
            gaps[i] = min(gaps[i], abs(ans.lines[i].score - mine[j][1]))
        diffs.extend(gaps)
        served = [a.box for a in ans.lines]
        for b, _ in mine:
            area = float(np.ptp(b[:, 0]) * np.ptp(b[:, 1]))
            ref_area += area
            missed += area * (1.0 - _covered(b, served))
        if not ans.lines:
            continue
        t = torch.from_numpy(_gray(page)).to(ref.device).float()
        plans = [ref.crop_plan(a.box) for a in ans.lines]
        probs = ref.cls_probs(t, plans).cpu().numpy()
        turned = []
        for a, pr in zip(ans.lines, probs):
            if a.cls_label not in labels:
                cls_gap = math.inf
                turned.append(False)
                continue
            p_own = float(pr[labels.index(a.cls_label)])
            cls_gap = max(cls_gap, note("cls_gap", abs(a.cls_score - p_own),
                                        (pi, a.box.tolist(), a.cls_label, a.cls_score, p_own)))
            turned.append(a.cls_label == 180 and a.cls_score >= ref.s["cls"]["thresh"])
        for a, (lg, valid) in zip(ans.lines, ref.rec_logits(t, plans, turned)):
            target = [ref.index.get(c, -1) for c in a.text]
            if -1 in target:
                rec_gap = math.inf
                continue
            g = float(ctc_gaps(lg[None], [valid], [target])[0])
            if g > worst.get("rec_gap", (-1.0,))[0]:
                note("rec_gap", g, (pi, a.box.tolist(), a.text,
                                    greedy_text(torch.from_numpy(lg), valid, ref.chars)))
            rec_gap = max(rec_gap, g)
    if explain is not None:
        explain.update({k: v[1] for k, v in worst.items()})
    return {"det_med": float(np.median(diffs)) if diffs else 0.0,
            "det_miss": missed / ref_area if ref_area else 0.0,
            "cls_gap": cls_gap, "rec_gap": rec_gap}
